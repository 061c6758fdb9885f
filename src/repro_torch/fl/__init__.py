from .device_data import DeviceDataset
from .partition import (client_histograms, dense_index_pools,
                        dirichlet_partition, partition_labels)
from .round import flatten_stacked, make_fl_rounds_scan
from .simulation import (DeviceFLSim, SimConfig, pool_from_partition,
                         resolve_device, run_fl_experiment)
