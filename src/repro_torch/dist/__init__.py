"""Distributed execution of the port (`repro.dist`) on `torch.distributed`.

- `sharding` — the control plane's lane sharding: `LaneMesh` and
               `lane_mesh` over the default process group, `lane_counts`,
               `lane_block`, the counted collectives (`all_reduce_sum`,
               `merge_plans`, `gather_objects`) and `collectives`
- `group`    — `spawn`: start a group of ranks on this host and return
               rank 0's result; `one_rank_group`: this process alone as
               a group of one rank
- `runs`     — what a rank of a spawned group runs to drive the sharded
               control plane: `run_cases`, and the records it compares

`repro.dist`'s parameter, batch and cache heuristics, `act_sharding` and
the GPipe `pipeline` come with ``train(mesh=)`` in later slices.
"""
from repro_torch.dist.group import one_rank_group, spawn
from repro_torch.dist.sharding import (
    LANE_AXIS,
    LaneMesh,
    all_reduce_sum,
    collectives,
    gather_objects,
    lane_block,
    lane_counts,
    lane_mesh,
    merge_plans,
)

__all__ = [
    "LANE_AXIS", "LaneMesh", "all_reduce_sum", "collectives",
    "gather_objects", "lane_block", "lane_counts",
    "lane_mesh", "merge_plans", "one_rank_group", "spawn",
]
