from .checkpoint import (CheckpointManager, reset_narrowing_warnings,
                         restore, restore_dict, save, tree_from_arrays,
                         tree_to_arrays)
