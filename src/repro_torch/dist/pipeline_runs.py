"""What a rank of a spawned group runs to drive the GPipe pipeline.

`run_pipe_cases` is the function `repro_torch.dist.spawn` hands the ranks
(or a caller in a `one_rank_group`): it builds each case's pipeline mesh
``((n,), ("pipe",))`` on the group, runs the case on every rank and
returns this rank's records with every rank's digest of them.  Every
case runs ``passes`` passes of forward and backward and writes, after
the last, its gradients into the directory ``"dump"`` as ``.npy`` files
(`load_dump` reads them back whole): each rank its stage block of every
stage leaf, ``<key>.s<stage>.npy``, and rank 0 the replicated ones,
``<key>.npy``.

- ``{"kind": "toy", "mesh", "w", "b", "x", "passes", "dump"}``: `repro`'s
  pipeline test, the layer ``tanh(x @ w + b)`` (`tanh_stage`) over the
  stacked ``(L, d, d)`` / ``(L, d)`` leaves, loss ``sum(out ** 2)``;
  dumps ``w``, ``b``, ``x`` (its gradient) and ``out``.
- ``{"kind": "model", "mesh", "cfg", "key", "batch", "n_micro", "passes",
  "dump"}``: the training form of ``cfg`` (an attention or SSM decoder of
  uniform layers) drawn from the seed ``key``, this rank holding only its
  stage's layers (`staged_model`); the batch's ``(B, S)`` tokens cut
  into ``n_micro`` microbatches, embedded, piped through the stages
  (`layer_stage`: the `Block` template over the stage's layer slices,
  with remat), then the final norm and the loss on the replicated result
  (`pipe_loss`); dumps every master's gradient and ``hidden``, the
  pipeline's output.

Each record holds what every rank must agree on (the losses, the digest
of the output) and, under ``"measure"``, what this rank counted and
timed a pass (kernel launches, collectives and their bytes, seconds),
and of the model case the seconds to load the kernels and build the
stage, the peak device memory, one hop's milliseconds timed alone
(`hop_ms`) and the seconds the dump took.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import time

import numpy as np
import torch

from repro_torch.dist.pipeline import (pipeline_forward, split_stages,
                                       stage_block)
from repro_torch.dist.runs import digest
from repro_torch.dist.sharding import (TrainMesh, collective_bytes,
                                       collectives, gather_objects, permute,
                                       to_device, train_mesh)
from repro_torch.kernels import _build
from repro_torch.models import layers as L
from repro_torch.models.transformer import (TrainModel, _init_leaf,
                                            _xent_chunked, _xent_full,
                                            param_shapes)


def tanh_stage(p_stage, x):
    """`repro`'s pipeline test's stage: ``tanh(x @ w + b)`` for each of the
    stage's layers, ``p_stage = (w (L_s, d, d), b (L_s, d))``."""
    w, b = p_stage
    for i in range(w.shape[0]):
        x = torch.tanh(x @ w[i] + b[i])
    return x


def sequential(params, x, stage_body):
    """Every microbatch of ``x`` through ``stage_body`` over all the layers
    of ``params``, one after the other: what the pipeline must equal."""
    return torch.stack([stage_body(params, x[j]) for j in range(x.shape[0])])


def staged_model(cfg, n_stages: int, stage: int, key: int, device
                 ) -> TrainModel:
    """The training form of ``cfg`` cut to stage ``stage`` of ``n_stages``:
    its ``layers@`` masters are that stage's ``L / n_stages`` layers, the
    embedding, final norm and output projection whole, every leaf equal to
    the same slice of ``TrainModel(cfg).init(Generator(device).
    manual_seed(key))`` (each full leaf drawn in turn and cut, so the rank
    never holds the other stages' layers at once)."""
    if cfg.family not in ("dense", "ssm") or not cfg.n_layers % n_stages == 0:
        raise ValueError(f"{cfg.name}: the pipeline stages a dense or SSM "
                         f"decoder of uniform layers, L divisible by the "
                         f"{n_stages} stages; got family {cfg.family}, L "
                         f"{cfg.n_layers}")
    per = cfg.n_layers // n_stages
    model = TrainModel(dataclasses.replace(cfg, n_layers=per), device=device)
    gen = torch.Generator(device=model.device).manual_seed(int(key))
    shapes = param_shapes(cfg)
    with torch.no_grad():
        for k in sorted(shapes):  # TrainModel.init's order
            full = _init_leaf(k, shapes[k], gen, model.device)
            model.masters[k].copy_(full[stage * per:(stage + 1) * per]
                                   if k.startswith("layers@") else full)
            del full
    return model


def stage_leaves(model: TrainModel) -> dict:
    """The model's stacked layer masters, ``{key: (L, ...)}``."""
    return {k: model.masters[k] for _, k in model._layer_names}


def layer_stage(model: TrainModel):
    """The stage body of ``model``'s layers: ``body(p_stage, x)`` runs the
    layer template over the slices of ``p_stage`` (``{key: (L_s, ...)}``)
    on one microbatch ``x`` (mb, S, d), each layer checkpointed under
    ``remat="full"``, as `TrainModel` runs its layers."""
    names = model._layer_names

    def body(p, x):
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for ws in zip(*(p[k].unbind(0) for _, k in names)):
            x = model._remat(model._layer, x, positions, *ws)[0]
        return x

    return body


def pipe_loss(model: TrainModel, batch: dict, n_micro: int, forward):
    """``(loss, hidden)``: the batch's (B, S) tokens embedded and cut into
    ``n_micro`` microbatches (mb, S, d), ``hidden = forward(x)`` their
    (n_micro, mb, S, d) outputs, then the final norm and `TrainModel.
    loss`'s cross-entropy over the (B, S) rows."""
    cfg = model.cfg
    tokens = torch.as_tensor(batch["tokens"], device=model.device).long()
    labels = torch.as_tensor(batch["labels"], device=model.device).long()
    B, S = tokens.shape
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} "
                         "microbatches")
    x = model._use("embed")[tokens].view(n_micro, B // n_micro, S, -1)
    hidden = forward(x)
    h = L.rms_norm(hidden.flatten(0, 1), model.masters["final_norm"])
    mask = (labels >= 0).float()
    w_out = model.unembed_matrix()
    if cfg.logit_chunk_vocab > 0:
        nll = _xent_chunked(h, w_out, labels, mask, cfg.logit_chunk_vocab,
                            cfg.vocab)
    else:
        nll = _xent_full(h, w_out, labels, mask, cfg.vocab)
    return nll, hidden


def tensor_digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's bytes (a bfloat16 one by its 16-bit pattern)."""
    a = t.detach()
    if a.dtype == torch.bfloat16:
        a = a.view(torch.int16)
    return hashlib.sha256(to_device(a.contiguous(), "cpu").numpy()
                          .tobytes()).hexdigest()[:16]


def hop_ms(mesh: TrainMesh, like: torch.Tensor, reps: int = 5,
           axis: str = "pipe") -> float:
    """Milliseconds of one hop of a tensor like ``like``, every rank
    hopping at once (`permute`, synchronised), the median of ``reps``
    after one unread."""
    y = torch.ones_like(like)
    times = []
    for _ in range(reps + 1):
        _sync(mesh.device)
        t0 = time.perf_counter()
        permute(y, 1, axis, mesh)
        _sync(mesh.device)
        times.append(time.perf_counter() - t0)
    return float(np.median(times[1:])) * 1e3


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _dump(d: str, name: str, t: torch.Tensor) -> None:
    np.save(os.path.join(d, name + ".npy"),
            to_device(t.detach().float().contiguous(), "cpu").numpy())


def load_dump(d: str, n_stages: int) -> dict:
    """``{key: numpy array}`` of a case's dump: each stage leaf's blocks
    concatenated in stage order, the replicated leaves as written."""
    out, blocks = {}, {}
    for f in sorted(os.listdir(d)):
        stem = f[:-len(".npy")]
        key, _, stage = stem.rpartition(".s")
        if key and stage.isdigit():
            blocks.setdefault(key, {})[int(stage)] = f
        else:
            out[stem] = np.load(os.path.join(d, f))
    for key, parts in blocks.items():
        if sorted(parts) != list(range(n_stages)):
            raise ValueError(f"dump {d}: leaf {key} has stages "
                             f"{sorted(parts)} of {n_stages}")
        out[key] = np.concatenate([np.load(os.path.join(d, parts[s]))
                                   for s in range(n_stages)])
    return out


def timed_passes(device, passes: int, leaves: list, run) -> tuple:
    """``passes`` passes of ``loss, hidden = run()`` and its backward on
    ``device``, every gradient of ``leaves`` cleared first; each pass's
    kernel launches, collectives, their bytes, and seconds (the device
    synchronised before and after).  Returns (losses, the last pass's
    hidden, measures a pass)."""
    losses, per = [], []
    for _ in range(passes):
        for p in leaves:
            p.grad = None
        launches, c0, b0 = dict(_build.LAUNCHES), collectives(), \
            collective_bytes()
        _sync(device)
        t0 = time.perf_counter()
        loss, hidden = run()
        loss.backward()
        _sync(device)
        dt = time.perf_counter() - t0
        b1 = collective_bytes()
        per.append(dict(s=dt, collectives=collectives() - c0,
                        bytes={k: b1[k] - b0[k] for k in b1},
                        launches={k: _build.LAUNCHES[k] - launches[k]
                                  for k in launches}))
        losses.append(float(loss.detach()))
    return losses, hidden, per


def _toy_case(mesh: TrainMesh, case: dict) -> dict:
    n, s = mesh.shape["pipe"], mesh.coords["pipe"]
    dev = mesh.device
    w, b = (torch.from_numpy(case[k]).to(dev) for k in ("w", "b"))
    w_s, b_s = (a.detach().clone().requires_grad_()
                for a in stage_block(split_stages((w, b), n), mesh))
    x = torch.from_numpy(case["x"]).to(dev).requires_grad_()

    def run():
        out = pipeline_forward((w_s, b_s), x, tanh_stage, mesh=mesh)
        return (out ** 2).sum(), out

    losses, out, per = timed_passes(mesh.device, case["passes"],
                                    [w_s, b_s, x], run)
    d = case["dump"]
    _dump(d, f"w.s{s}", w_s.grad[0])
    _dump(d, f"b.s{s}", b_s.grad[0])
    if s == 0:
        _dump(d, "x", x.grad)
        _dump(d, "out", out)
    return {"losses": losses, "out": tensor_digest(out),
            "measure": {"passes": per}}


def _model_case(mesh: TrainMesh, case: dict) -> dict:
    n, s = mesh.shape["pipe"], mesh.coords["pipe"]
    t0 = time.perf_counter()
    if mesh.device.type == "cuda":
        _build.extension()  # loaded here, not in the first pass
        torch.cuda.reset_peak_memory_stats(mesh.device)
    model = staged_model(case["cfg"], n, s, case["key"], mesh.device)
    body = layer_stage(model)
    block = {k: p[None] for k, p in stage_leaves(model).items()}
    build_s = time.perf_counter() - t0

    def run():
        return pipe_loss(model, case["batch"], case["n_micro"],
                         lambda x: pipeline_forward(block, x, body,
                                                    mesh=mesh))

    losses, hidden, per = timed_passes(mesh.device, case["passes"],
                                       list(model.masters.values()), run)
    measure = {"passes": per, "build_s": build_s,
               "hop_ms": hop_ms(mesh, hidden[0]) if n > 1 else 0.0}
    if mesh.device.type == "cuda":
        measure["peak_gb"] = torch.cuda.max_memory_allocated(
            mesh.device) / 1e9
    t1 = time.perf_counter()
    d = case["dump"]
    for k, p in model.masters.items():
        if k.startswith("layers@"):
            _dump(d, f"{k}.s{s}", p.grad)
        elif s == 0:
            _dump(d, k, p.grad)
    if s == 0:
        _dump(d, "hidden", hidden)
    measure["dump_s"] = time.perf_counter() - t1
    return {"losses": losses, "hidden": tensor_digest(hidden),
            "measure": measure}


_RUNNERS = {"toy": _toy_case, "model": _model_case}


def run_pipe_cases(lane, cases: list, t_spawn: float | None = None) -> dict:
    """Run ``cases`` in order on this rank, each on the pipeline mesh its
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
