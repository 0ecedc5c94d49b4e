"""Data parallelism over ranks (``dist``)."""
from .dist import (LAUNCHERS, gather_to_rank0, global_moments, global_sum,
                   init_distributed, is_distributed, mean_share,
                   rank_and_world, replicate, resolve_launcher_env,
                   rows_of_rank, shard_batch, sum_gradients)

__all__ = ['LAUNCHERS', 'gather_to_rank0', 'global_moments', 'global_sum',
           'init_distributed', 'is_distributed', 'mean_share',
           'rank_and_world', 'replicate', 'resolve_launcher_env',
           'rows_of_rank', 'shard_batch', 'sum_gradients']
