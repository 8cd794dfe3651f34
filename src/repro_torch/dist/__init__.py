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
- `pipeline` — `repro.dist.pipeline`: `split_stages`, `stage_block` and
               `pipeline_forward`, the GPipe schedule over a ``("pipe",)``
               mesh with gradients back through the hops
               (`sharding.permute`)
- `runs`     — what a rank of a spawned group runs: `run_cases` (the
               sharded control plane), and the records they compare;
               `train_runs.run_train_cases` (sharded training and the
               elastic restore) and `pipeline_runs.run_pipe_cases` (the
               pipeline on a toy layer or a model's stages)
- `act_sharding` — `repro.dist.act_sharding`: `constrain` and
               `use_mesh_axes`, the models' logical activation sites
               (``"dp"``, ``"tp"``), recorded by a dry run
               (`repro_torch.launch.dryrun`) and otherwise ``x`` itself
"""
from repro_torch.dist.act_sharding import constrain, use_mesh_axes
from repro_torch.dist.group import one_rank_group, spawn
from repro_torch.dist.pipeline import (pipeline_forward, split_stages,
                                       stage_block)
from repro_torch.dist.sharding import (
    LANE_AXIS,
    PIPE_AXES,
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
    permute,
    sharding_tree,
    spec_tree,
    train_mesh,
)

__all__ = [
    "LANE_AXIS", "LaneMesh", "PIPE_AXES", "Sharding", "TrainMesh",
    "all_reduce_sum", "batch_specs", "cache_specs", "check_specs",
    "collective_bytes", "collectives", "constrain", "gather_objects",
    "lane_block",
    "lane_counts", "lane_mesh", "merge_plans", "one_rank_group", "permute",
    "pipeline_forward", "sharding_tree", "spawn", "spec_tree",
    "split_stages", "stage_block", "train_mesh", "use_mesh_axes",
]
