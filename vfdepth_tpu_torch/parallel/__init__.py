"""Training across processes, one rank per card (port of
``vfdepth_tpu/parallel/``): data parallelism (JAX's 1-D data mesh) and the
camera-axis grid on top of it (JAX's 2-D ``(data, cam)`` mesh)."""
from .distributed import (COUNTS, is_active, is_main_process, loader_shard,
                          maybe_initialize_distributed, per_process_seed,
                          rank_world)
from .data_parallel import (average_gradients, broadcast_model, global_batch,
                            reduce_logs)
from .mesh import Grid, cam_grid_for, grid_coords, make_grid_2d

__all__ = ["COUNTS", "is_active", "is_main_process", "loader_shard",
           "maybe_initialize_distributed", "per_process_seed", "rank_world",
           "average_gradients", "broadcast_model", "global_batch",
           "reduce_logs", "Grid", "cam_grid_for", "grid_coords",
           "make_grid_2d"]
