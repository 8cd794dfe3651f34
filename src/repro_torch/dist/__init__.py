"""Distributed execution of the port (`repro.dist`) on `torch.distributed`.

- `sharding` — `repro.dist.sharding`: the spec heuristics (`spec_tree`,
               `batch_specs`, `cache_specs`, `check_specs`), the training
               mesh (`TrainMesh`, `train_mesh`) and `Sharding` /
               `sharding_tree`; the control plane's lane sharding
               (`LaneMesh`, `lane_mesh`, `lane_counts`, `lane_block`,
               `merge_plans`); and every collective of the port, counted
               (`collectives`, `collective_bytes`)
- `fsdp`     — the training state as this rank's shards: `train_specs`,
               `shard_tree`, `gather_tree`, the model's masters gathered
               and released around a step, `split_batch`
- `group`    — `spawn`: start a group of ranks on this host and return
               rank 0's result; `one_rank_group`: this process alone as
               a group of one rank
- `runs`     — what a rank of a spawned group runs: `run_cases` (the
               sharded control plane) and `run_train_cases` (sharded
               training and the elastic restore), and the records they
               compare

`repro.dist`'s `act_sharding` and the GPipe `pipeline` come in later
slices.
"""
from repro_torch.dist.group import one_rank_group, spawn
from repro_torch.dist.sharding import (
    LANE_AXIS,
    LaneMesh,
    Sharding,
    TrainMesh,
    all_reduce_sum,
    batch_specs,
    cache_specs,
    check_specs,
    collective_bytes,
    collectives,
    gather_objects,
    lane_block,
    lane_counts,
    lane_mesh,
    merge_plans,
    sharding_tree,
    spec_tree,
    train_mesh,
)

__all__ = [
    "LANE_AXIS", "LaneMesh", "Sharding", "TrainMesh", "all_reduce_sum",
    "batch_specs", "cache_specs", "check_specs", "collective_bytes",
    "collectives", "gather_objects", "lane_block", "lane_counts",
    "lane_mesh", "merge_plans", "one_rank_group", "sharding_tree",
    "spawn", "spec_tree", "train_mesh",
]
