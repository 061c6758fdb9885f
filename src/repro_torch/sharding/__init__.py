"""Sharding rules (copies of the JAX package's ``sharding``): partition
specs for parameters, optimizer state, batches and caches, and their
DTensor placements."""
from .specs import (P, PartitionSpec, batch_shardings, cache_shardings,
                    data_axes, mesh_axis_size, opt_state_shardings,
                    param_spec, params_shardings, placements, replicated,
                    tree_map_with_path)
