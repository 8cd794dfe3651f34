"""What a rank of a spawned group runs to drive sharded training.

`run_train_cases` is the function `repro_torch.dist.spawn` hands the
ranks (or a caller in a `one_rank_group`): it builds each case's
`TrainMesh` on the group, runs the case on every rank and returns this
rank's records with every rank's digest of them.  A case is a dict of
picklable inputs, each with ``"mesh": (shape, axes)``, the model's
``"cfg"`` and its start, ``"params"`` (a master dict of numpy arrays) or
``"key"`` (an int seed):

- ``{"kind": "steps", "tcfg", "batches", "return_params"}`` runs the
  sharded step (`make_train_step(mesh=)`) on each batch in turn;
- ``{"kind": "loop", "tcfg", "lcfg", "data"}`` runs ``train(mesh=)`` on
  `MarkovLMData(data)`, checkpointing into ``lcfg.ckpt_dir`` (the
  masters drawn from ``"key"`` are passed as ``key=``);
- ``{"kind": "restore", "tcfg", "data", "dir", "step"}`` restores a
  checkpoint onto the mesh (``restore(shardings=sharding_tree(...))``)
  and gathers every leaf back.

Each record holds what every rank must agree on (losses, the metrics
all-reduced, the parameter movement, the digests of gathered leaves)
and, under ``"measure"``, what this rank counted and timed: collectives
and bytes a step, kernel launches, step and phase seconds, peak device
memory.
"""
from __future__ import annotations

import time

import torch

from repro_torch.data import MarkovLMData
from repro_torch.dist import fsdp
from repro_torch.dist.runs import digest
from repro_torch.dist.sharding import (
    TrainMesh,
    all_reduce_sum,
    gather_objects,
    sharding_tree,
    spec_axes,
    spec_tree,
    train_mesh,
)
from repro_torch.kernels import _build
from repro_torch.models import build_model, param_shapes
from repro_torch.train.checkpoint import (CheckpointManager, _checksum,
                                          _flatten, _pool)
from repro_torch.train.loop import train
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.step import make_train_step


def leaf_digests(tree) -> dict:
    """``{key: "sha256 prefix:dtype:shape"}`` of every leaf of a nested
    dict of tensors, arrays or numbers (a bfloat16 tensor by its 16-bit
    pattern), keys joined by ``@``, hashed on the checkpoint's threads."""
    flat = _flatten(tree)
    with _pool() as pool:
        shas = pool.map(_checksum, [a for a, _ in flat.values()])
        return {k: f"{sha}:{dtype}:{a.shape}"
                for (k, (a, dtype)), sha in zip(flat.items(), shas)}


def _sync(mesh: TrainMesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _model(case: dict, mesh: TrainMesh):
    """The case's training form on the mesh's device, holding its start."""
    model = build_model(case["cfg"], device=mesh.device, train=True)
    if "params" in case:
        with torch.no_grad():
            for k, p in model.masters.items():
                p.copy_(torch.as_tensor(case["params"][k]))
    else:
        model.init(torch.Generator(device=mesh.device).manual_seed(
            int(case["key"])))
    return model


def _movement(shards: dict, before: dict, specs: dict, mesh) -> float:
    """The squared distance between two sets of master shards, summed over
    every leaf once across the mesh (one collective)."""
    sq = torch.zeros((), dtype=torch.float64, device=mesh.device)
    for k, s in shards.items():
        axes = tuple(a for _, ax in spec_axes(specs[k]) for a in ax)
        if mesh.owner(axes):
            sq += torch.sum((s.double() - before[k].double()) ** 2)
    return float(all_reduce_sum(sq, mesh))


def _steps_case(mesh: TrainMesh, case: dict) -> dict:
    model, tcfg = _model(case, mesh), case["tcfg"]
    pspecs, sspecs = fsdp.train_specs(model.cfg, tcfg.opt, mesh)
    init_state, step = make_train_step(model, tcfg, mesh=mesh)
    state = fsdp.shard_tree(init_state(model.params()), sspecs, mesh)
    params = fsdp.shard_masters(model, pspecs, mesh)
    before = {k: v.clone() for k, v in params.items()}
    metrics, per_step = [], []
    for batch in case["batches"]:
        launches = dict(_build.LAUNCHES)
        _sync(mesh)
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        _sync(mesh)
        dt = time.perf_counter() - t0
        metrics.append({k: float(v) for k, v in m.items()})
        per_step.append(dict(
            s=dt, launches={k: _build.LAUNCHES[k] - launches[k]
                            for k in launches},
            **{k: metrics[-1].pop(k) for k in
               ("collectives", "gathered_bytes", "reduced_bytes")}))
    rec = {"metrics": metrics,
           "movement": _movement(params, before, pspecs, mesh),
           "measure": {"steps": per_step}}
    if case.get("return_params"):
        full = fsdp.gather_tree(params, pspecs, mesh, "cpu")
        rec["params"] = {k: v.numpy() for k, v in full.items()}
    return rec


def _loop_case(mesh: TrainMesh, case: dict) -> dict:
    model, tcfg = _model(case, mesh), case["tcfg"]
    pspecs, _ = fsdp.train_specs(model.cfg, tcfg.opt, mesh)
    before = fsdp.shard_tree({k: p.detach() for k, p in
                              model.masters.items()}, pspecs, mesh)
    _sync(mesh)
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    launches = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    out = train(model, MarkovLMData(case["data"]), tcfg, case["lcfg"],
                device=mesh.device.type, key=case.get("key"), mesh=mesh,
                params=case.get("params"), log=lambda s: None)
    _sync(mesh)
    wall = time.perf_counter() - t0
    metrics = out["metrics"]
    per_step = [{k: m.pop(k) for k in
                 ("collectives", "gathered_bytes", "reduced_bytes")}
                for m in metrics]
    measure = {"steps": per_step, "times": out["times"], "s": wall,
               "launches": {k: _build.LAUNCHES[k] - launches[k]
                            for k in launches}}
    if mesh.device.type == "cuda":
        measure["peak_gb"] = torch.cuda.max_memory_allocated(
            mesh.device) / 1e9
    return {"metrics": metrics, "losses": out["losses"],
            "movement": _movement(out["params"], before, pspecs, mesh),
            "measure": measure}


def _restore_case(mesh: TrainMesh, case: dict) -> dict:
    meta = {k: torch.empty(s, device="meta")
            for k, s in param_shapes(case["cfg"]).items()}
    target = {"params": meta,
              "state": {"opt": make_optimizer(case["tcfg"].opt)[0](meta)},
              "data": MarkovLMData(case["data"]).checkpoint_state()}
    shardings = sharding_tree(target, mesh)
    _sync(mesh)
    t0 = time.perf_counter()
    shards = CheckpointManager(case["dir"]).restore(
        case["step"], target, shardings=shardings)
    _sync(mesh)
    t1 = time.perf_counter()
    full = fsdp.gather_tree(shards, spec_tree(target, mesh), mesh, "cpu")
    return {"digests": leaf_digests(full),
            "shard_shapes": {k: tuple(v.shape) for k, v in
                             shards["params"].items()},
            "measure": {"restore_s": t1 - t0,
                        "gather_s": time.perf_counter() - t1}}


_RUNNERS = {"steps": _steps_case, "loop": _loop_case,
            "restore": _restore_case}


def run_train_cases(lane, cases: list, t_spawn: float | None = None) -> dict:
    """Run ``cases`` in order on this rank, each on the `TrainMesh` its
    ``"mesh"`` names over the group ``lane`` (the `LaneMesh` `spawn`
    hands a rank) spans; returns ``{"rank", "records", "digests",
    "measures", "times"}`` as `repro_torch.dist.runs.run_cases` does."""
    t0 = time.time()
    records, meshes = [], {}
    for c in cases:
        shape, axes = c["mesh"]
        if (shape, axes) not in meshes:
            meshes[shape, axes] = train_mesh(shape, axes,
                                             device=lane.device.type)
        records.append(_RUNNERS[c["kind"]](meshes[shape, axes], c))
    times = {"start_s": None if t_spawn is None else t0 - t_spawn,
             "cases_s": time.time() - t0}
    ranks = gather_objects((digest(records),
                            [r["measure"] for r in records], times), lane)
    return {"rank": lane.rank, "records": records,
            "digests": [d for d, _, _ in ranks],
            "measures": [m for _, m, _ in ranks],
            "times": [t for _, _, t in ranks]}
