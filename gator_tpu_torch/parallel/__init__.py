"""Data parallelism, one process per card (counterpart of
gator_tpu/parallel): the world a process belongs to, each rank's rows of a
global batch, the collectives the train, eval and serving paths use, and
a launcher of ranks on one host (`spawn`)."""
from .world import (World, all_gather_rows, all_reduce_grads,
                    all_reduce_mean, all_reduce_sum_, any_rank, barrier,
                    broadcast_module, broadcast_object, close_world,
                    init_world, join_world, launched, local_rows,
                    main_print,
                    pad_to_multiple, single, spawn, sum_over_ranks)

__all__ = [
    "World", "all_gather_rows", "all_reduce_grads", "all_reduce_mean",
    "all_reduce_sum_", "any_rank", "barrier", "broadcast_module",
    "broadcast_object", "close_world", "init_world", "join_world",
    "launched",
    "local_rows", "main_print", "pad_to_multiple", "single", "spawn",
    "sum_over_ranks",
]
