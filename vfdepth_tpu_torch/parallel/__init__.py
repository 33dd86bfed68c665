"""Data-parallel training across processes, one rank per card (port of
``vfdepth_tpu/parallel/``'s 1-D data mesh; the camera-axis mesh is not
ported yet)."""
from .distributed import (COUNTS, is_active, is_main_process, loader_shard,
                          maybe_initialize_distributed, per_process_seed,
                          rank_world)
from .data_parallel import (average_gradients, broadcast_model, global_batch,
                            reduce_logs)

__all__ = ["COUNTS", "is_active", "is_main_process", "loader_shard",
           "maybe_initialize_distributed", "per_process_seed", "rank_world",
           "average_gradients", "broadcast_model", "global_batch",
           "reduce_logs"]
