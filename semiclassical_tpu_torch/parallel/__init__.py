# coding: utf-8
"""One trajectory batch across devices: a torch.distributed process group
(the port's counterpart of the JAX package's `traj` mesh)."""

from semiclassical_tpu_torch.parallel.group import (Group, barrier,
                                                    destroy_group,
                                                    group_sum, init_group,
                                                    is_leader,
                                                    pad_to_multiple,
                                                    rank_path, ring_shift,
                                                    shard_rows, world_of)

__all__ = ["Group", "init_group", "destroy_group", "pad_to_multiple",
           "shard_rows", "group_sum", "ring_shift", "barrier", "is_leader",
           "world_of", "rank_path"]
