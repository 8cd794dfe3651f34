"""Multi-pod dry run (`repro.launch.dryrun`): trace every (architecture x
input shape) cell on the production meshes and record what the port's
own step would hold and do on one rank.

`repro` lowers and compiles each cell for 256 or 512 XLA host devices
and reads XLA's memory and cost analyses and the HLO's collectives.
PyTorch has none of these, so the port traces instead: this process joins
a fake process group of 256 or 512 ranks as rank 0 (``"fake"``,
`torch.testing._internal.distributed.fake_pg`: every collective returns at
once with its output's shape), builds the port's model under a
`FakeTensorMode` on ``"cuda"`` (`device.resolve_device` allows that with
or without a card, since nothing is allocated) and runs one step eagerly:

- train_4k     one step of ``make_train_step(model, tcfg, mesh=)`` from
               the state `dist.fsdp` shards under ``train_specs``;
- prefill_32k  ``prefill`` on this rank's rows;
- decode_32k / long_500k  ``decode_step`` against a full ``seq_len``
               cache (``len = seq_len - 1``, as `repro`'s ``init_cache``
               fills it), updated in place (what `repro`'s ``--opt``
               donation buys).

The step is the port's FSDP step: each rank holds its shards under the
spec rules (`dist.sharding`: params and optimizer state by `spec_tree`,
batch by `batch_specs`, cache by `cache_specs`), gathers the float32
masters before computing (`fsdp.bind_masters`; a serving cell casts them
into the serving `Model`, as `repro`'s forward casts ``p.astype``), and a
decode cell gathers its cache over the ``"model"`` axis, decodes its rows
and writes its block back.  The optimizer state's specs are `spec_tree`
of the state (`fsdp.train_specs`); `repro`'s dry run (its
``spec_tree_state``) gives the same specs except for Adafactor's factored
statistics, which it replicates.

Fake CUDA tensors take the kernels' shape routes (`kernels.ops`), which
count the launches and add each kernel's work (`kernels.cost`) to the
record (`repro_torch.record`).  Per cell the record holds, for this rank:

- ``memory``: ``argument_bytes``, this rank's shards of params, state,
  batch and cache (the batch as the host hands it in; the step's device
  copy of it counts as temp); ``output_bytes``, the device tensors the
  step returns; ``temp_bytes``, the peak of live device bytes over the
  step less those live when it starts (`LiveBytes`, which tracks the
  storages every operation makes);
- ``cost``: ``flops``, `FlopCounterMode`'s count of the aten operations
  plus the kernels' counts; ``bytes_accessed``, each aten operation's
  operand and result bytes (views and allocations move none) plus the
  kernels'; FLOPs, bytes and launches by kernel;
- ``collectives``: every collective the step issues through
  `dist.sharding`, by kind, with count and bytes.

The eager trace runs every layer, so there is no ``probe_costs``
extrapolation: `repro` needs one only because XLA's cost analysis
counts a scanned layer body once.  Records go to
``reports/dryrun_torch/<arch>__<shape>__<mesh>[_opt].json``; a failing
cell is recorded with its error and traceback, never skipped.

The fake group is process-wide: a process traces one mesh kind and
leaves no group behind (`fake_group`); ``--mesh both`` traces each kind in
a process of its own.  `isolated` runs one named case of this module in a
fresh process and returns its record; `start` and `finish` run the
command line or a case (`case_argv`) in one, beside other work.  A
trace's live bytes depend a little on what its process traced before
(the garbage collector's timing and the fake tensors' dispatch cache:
Yi-9B's 2-layer step reads 16.8-33.6 MB more temp after other traces),
so a record to compare is traced in a fresh process.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--mesh single|multi|both] [--force] [--opt]
        [--device cuda|cpu] [--report-dir DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time
import traceback
import weakref

import numpy as np
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import record
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_cells_for
from repro_torch.dist import act_sharding, fsdp
from repro_torch.dist.sharding import (
    Sharding,
    batch_specs,
    cache_specs,
    check_specs,
    gather_dim,
    spec_axes,
    spec_tree,
    train_mesh,
)
from repro_torch.launch.mesh import data_axes, make_production_mesh
from repro_torch.models import build_model, param_shapes
from repro_torch.models import transformer as T
from repro_torch.models.convert import _stacks
from repro_torch.train import OptConfig, TrainConfig, make_train_step

REPORT_DIR = pathlib.Path(__file__).resolve().parents[3] / "reports" / \
    "dryrun_torch"
MESH_WORLD = {"single": 256, "multi": 512}


# ----------------------------------------------------------------------
# input specs (shape and dtype stand-ins; no allocation)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InputSpec:
    """A model input's shape and dtype (`repro`'s ``ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def sds(shape, dtype) -> InputSpec:
    return InputSpec(tuple(int(x) for x in shape), dtype)


def input_specs(cfg, cell) -> dict:
    """Model-input specs for one shape cell, `repro`'s: int32 tokens (and
    labels for training) of the text's length, a VLM's bf16
    ``patch_embeds`` ahead of it, an encoder-decoder's bf16 ``frames``; a
    decode cell's (B,) tokens."""
    B, S = cell.global_batch, cell.seq_len
    batch: dict = {}
    if cell.kind in ("train", "prefill"):
        text = S
        if cfg.vlm is not None:
            text = S - cfg.vlm.n_patches
            batch["patch_embeds"] = sds((B, cfg.vlm.n_patches,
                                         cfg.vlm.patch_dim), torch.bfloat16)
        if cfg.encdec is not None:
            batch["frames"] = sds((B, cfg.encdec.encoder_len, cfg.d_model),
                                  torch.bfloat16)
        batch["tokens"] = sds((B, text), torch.int32)
        if cell.kind == "train":
            batch["labels"] = sds((B, text), torch.int32)
    else:
        batch["tokens"] = sds((B,), torch.int32)
    return batch


def _train_opt_for(arch: str) -> OptConfig:
    # 480B-scale: factored second moments keep optimizer state in reach
    if arch in ("arctic-480b",):
        return OptConfig(kind="adafactor")
    return OptConfig(kind="adamw")


OPT_LOGIT_CHUNK = 8192  # streaming xent for >=32k vocabularies (opt mode)


def opt_overrides_for(arch: str, shape_name: str) -> dict:
    """The perf configuration (`repro`'s ``--opt``), recorded apart: the
    vocabulary-chunked cross-entropy for train cells of a vocabulary of
    32,000 or more."""
    cfg = get_config(arch)
    out = {}
    if SHAPES[shape_name].kind == "train" and cfg.vocab >= 32000:
        out["logit_chunk_vocab"] = OPT_LOGIT_CHUNK
    return out


# ----------------------------------------------------------------------
# the fake group and the measurement
# ----------------------------------------------------------------------
@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """This process as rank ``rank`` of a fake process group of ``world``
    ranks for the enclosed block, destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a dry run needs a process without a group")
    dist.init_process_group("fake", store=FakeStore(), rank=int(rank),
                            world_size=int(world))
    try:
        yield
    finally:
        dist.destroy_process_group()


_ALLOCATIONS = {"empty.memory_format", "empty_strided.default",
                "empty_like.default", "new_empty.default",
                "new_empty_strided.default"}


def _tensors(tree):
    """Every tensor in ``tree`` (tensors, dicts, lists, tuples, cache
    dataclasses)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


class LiveBytes(TorchDispatchMode):
    """The live bytes of the storages on ``device_type`` (fake ones
    included) and their peak, and each operation's operand and result
    bytes.  A storage counts from the operation that makes it (or from
    `track`) until it dies; views share their base's.  With
    ``keep_buffers``, ``buffers`` lists each operation's results as
    (bytes, ``dtype[shape]``, operation)."""

    def __init__(self, device_type: str = "cuda", keep_buffers: bool = False):
        super().__init__()
        self.device_type = device_type
        self.live = self.peak = 0
        self.bytes_accessed = 0
        self.buffers = [] if keep_buffers else None
        self._ids: set = set()

    def _free(self, key, nbytes):
        self._ids.discard(key)
        self.live -= nbytes

    def track(self, tree) -> None:
        """Count the storages of every tensor of ``tree`` as live."""
        for t in _tensors(tree):
            if t.device.type != self.device_type:
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._ids:
                continue
            n = st.nbytes()
            self._ids.add(key)
            self.live += n
            weakref.finalize(st, self._free, key, n)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.__name__
        if not func.is_view and name not in _ALLOCATIONS:
            self.bytes_accessed += sum(
                t.numel() * t.element_size()
                for t in _tensors((args, kwargs or {}, out)))
        if self.buffers is not None and not func.is_view:
            op = name.split(".")[0]
            self.buffers.extend((t.numel() * t.element_size(),
                                 record.shape_str(t), op)
                                for t in _tensors(out))
        self.track(out)
        return out


def _bytes(tree, device_type: str) -> int:
    """Bytes of the distinct storages on ``device_type`` in ``tree``."""
    seen, n = set(), 0
    for t in _tensors(tree):
        if t.device.type != device_type:
            continue
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            n += st.nbytes()
    return n


def measure(step, args, *, device_type: str = "cuda", mesh_shape=None,
            host_bytes: int = 0, detail: bool = False, batch_last=False):
    """Run ``step(*args)`` under the tracker, the FLOP counter and a fresh
    record -> (the cell's ``memory``, ``cost``, ``collectives`` and
    ``kernels`` (launches, FLOPs and bytes by kernel), plus the step's
    ``constraint_sites``; the step's outputs).  ``batch_last``: the last
    argument is the host batch, counted by ``host_bytes`` (this rank's
    rows of it) rather than tracked.  With ``detail``, also ``buffers``
    (`LiveBytes`) and ``calls`` (every collective), for `perf_probe`."""
    live = LiveBytes(device_type, keep_buffers=detail)
    live.track(args[:-1] if batch_last else args)
    start = live.live
    rec = record.TraceRecord(mesh_shape=dict(mesh_shape or {}))
    flops = FlopCounterMode(display=False)
    with record.recording(rec), flops, live:
        out = step(*args)
    tot = rec.totals()
    aten_flops = float(flops.get_total_flops())
    kflops = sum(tot["kernel_flops"].values())
    coll = dict(tot["collectives"])
    coll["total_bytes"] = sum(v["bytes"] for v in tot["collectives"].values())
    coll["count"] = sum(v["count"] for v in tot["collectives"].values())
    got = {
        "memory": {"argument_bytes": int(start + host_bytes),
                   "output_bytes": _bytes(out, device_type),
                   "temp_bytes": int(live.peak - start),
                   "peak_bytes": int(live.peak)},
        "cost": {"flops": aten_flops + kflops, "aten_flops": aten_flops,
                 "kernel_flops": kflops,
                 "bytes_accessed": float(live.bytes_accessed + sum(
                     tot["kernel_bytes"].values())),
                 "collective_bytes": float(coll["total_bytes"])},
        "kernels": {"launches": tot["launches"],
                    "flops": tot["kernel_flops"],
                    "bytes": tot["kernel_bytes"]},
        "collectives": coll,
        "constraint_sites": {k: tot[k] for k in (
            "sites", "site_bytes", "tp_unrealised_bytes")},
    }
    if detail:
        got.update(buffers=live.buffers, calls=list(rec.calls))
    return got, out


# ----------------------------------------------------------------------
# the steps
# ----------------------------------------------------------------------
def _rows(x, spec, mesh):
    """This rank's block of ``x``'s leading dimension where ``spec`` shards
    it, else ``x``."""
    if not spec or spec[0] is None:
        return x
    idx, n = mesh.block(mesh.data_axes)
    rows = x.shape[0] // n
    return x[idx * rows:(idx + 1) * rows]


def _host_batch(specs: dict) -> dict:
    """The global batch as the loader hands it in, on the host: int
    inputs as numpy arrays (zeros, every label counted), float inputs as
    (fake) CPU tensors, numpy having no bfloat16."""
    out = {}
    for k, s in specs.items():
        if s.dtype == torch.int32:
            out[k] = np.zeros(s.shape, np.int32)
        else:
            out[k] = torch.zeros(s.shape, dtype=s.dtype)
    return out


def _host_rows_bytes(batch: dict, mesh) -> int:
    """Bytes of this rank's rows of a host batch (`batch_specs`)."""
    specs = batch_specs(batch, mesh)
    return sum(record.tensor_bytes(_rows(v, specs[k], mesh))
               for k, v in batch.items())


def train_case(cfg, tcfg: TrainConfig, mesh, batch: dict, device):
    """(step, args, host bytes) of one sharded train step: the model built
    under the active fake mode, its masters and optimizer state cut to
    this rank's shards."""
    model = build_model(cfg, device=device, train=True)
    pspecs, sspecs = fsdp.train_specs(cfg, tcfg.opt, mesh)
    init_state, step = make_train_step(model, tcfg, mesh=mesh)
    state = fsdp.shard_tree(init_state(model.params()), sspecs, mesh)
    shards = fsdp.shard_masters(model, pspecs, mesh)
    return step, (shards, state, batch), _host_rows_bytes(batch, mesh)


def _serving_targets(model) -> dict:
    """Master key -> [(serving parameter, layer index or None)]: where each
    leaf of `repro`'s tree lives in a serving `Model` / `EncDecModel`
    (`models.convert.params_from_jax`'s mapping)."""
    out: dict = {}
    for name, p in model.named_parameters(recurse=False):
        out.setdefault(name, []).append((p, None))
    for stack, blocks in _stacks(model):
        for i, blk in enumerate(blocks):
            for name, p in blk.named_parameters():
                out.setdefault(stack + "@" + name.replace(".", "@"),
                               []).append((p, i))
    if getattr(model, "shared_attn", None) is not None:
        for name, p in model.shared_attn.named_parameters():
            out.setdefault("shared_attn@" + name.replace(".", "@"),
                           []).append((p, None))
    return out


def _serving_model(cfg, mesh, device):
    """(serving model with no weights, shards of `repro`'s float32
    parameter tree, their specs)."""
    shapes = param_shapes(cfg)
    pspecs = spec_tree(shapes, mesh)
    check_specs(pspecs, mesh)
    shards = {k: torch.zeros(Sharding(mesh, pspecs[k]).shard_shape(s),
                             dtype=torch.float32, device=device)
              for k, s in shapes.items()}
    model = build_model(cfg, device=device)
    for p in model.parameters():
        p.data = torch.empty(0, dtype=p.dtype, device=p.device)
    return model, shards, pspecs


def _bind_serving(model, shards, pspecs, mesh) -> None:
    """Gather every float32 master from the ranks' shards (one all-gather
    a sharded dimension) and cast its layers into the serving model."""
    targets = _serving_targets(model)
    for k in sorted(shards):
        full = shards[k] if not spec_axes(pspecs[k]) else \
            fsdp.gather_leaf(shards[k], pspecs[k], mesh)
        for p, i in targets[k]:
            p.data = (full if i is None else full[i]).to(p.dtype)
        del full


def prefill_case(cfg, mesh, batch: dict, device):
    """(step, args, host bytes) of a prefill on this rank's rows."""
    model, shards, pspecs = _serving_model(cfg, mesh, device)
    bspecs = batch_specs(batch, mesh)

    def step(shards, batch):
        _bind_serving(model, shards, pspecs, mesh)
        local = {k: _rows(v, bspecs[k], mesh) for k, v in batch.items()}
        tokens = torch.as_tensor(local["tokens"], device=device)
        if cfg.encdec is not None:
            return model.prefill(local["frames"], tokens)
        return model.prefill(tokens, local.get("patch_embeds"))

    return step, (shards, batch), _host_rows_bytes(batch, mesh)


def _model_dims(spec, mesh) -> list:
    return [(d, axes) for d, axes in spec_axes(spec)
            if axes != mesh.data_axes]


def decode_case(cfg, cell, mesh, batch: dict, device):
    """(step, args, host bytes) of one decode step against a full
    ``seq_len`` cache of this rank's rows: the cache's shards (per
    `cache_specs`) are the argument; the step gathers them over the
    ``"model"`` axis, decodes and writes this rank's block back."""
    model, shards, pspecs = _serving_model(cfg, mesh, device)
    B, S = cell.global_batch, cell.seq_len
    if cfg.encdec is not None:
        full = model.init_cache(B, S, cfg.encdec.encoder_len)
    elif cfg.family == "hybrid":
        full = model.init_cache(B, min(S, cfg.hybrid.window))
    else:
        full = model.init_cache(B, S)
    cspecs = cache_specs(full, mesh)
    check_specs(cspecs, mesh)
    fields = {f.name: getattr(full, f.name) for f in dataclasses.fields(full)}
    cache_shards = {k: torch.zeros(Sharding(mesh, cspecs[k]).shard_shape(
        v.shape), dtype=v.dtype, device=device)
        for k, v in fields.items() if isinstance(v, torch.Tensor)}
    del full, fields
    fill = S - 1
    bspecs = batch_specs(batch, mesh)

    def step(shards, cache_shards, batch):
        _bind_serving(model, shards, pspecs, mesh)
        whole = {}
        for k, sh in cache_shards.items():
            x = sh
            for d, axes in _model_dims(cspecs[k], mesh):
                x = gather_dim(x, d, axes, mesh)
            whole[k] = x
        cache = _cache_of(model, whole, fill)
        tokens = torch.as_tensor(_rows(batch["tokens"], bspecs["tokens"],
                                       mesh), device=device)
        logits, cache = model.decode_step(cache, tokens)
        for k, sh in cache_shards.items():
            x = getattr(cache, k)
            for d, axes in _model_dims(cspecs[k], mesh):
                idx, n = mesh.block(axes)
                rows = x.shape[d] // n
                x = x.narrow(d, idx * rows, rows)
            if x.untyped_storage() is not sh.untyped_storage():
                sh.copy_(x)
        return logits, cache_shards

    return step, (shards, cache_shards, batch), \
        _host_rows_bytes(batch, mesh)


def _cache_of(model, fields: dict, fill: int):
    """The model's cache dataclass over ``fields``, ``fill`` slots filled."""
    if "xk" in fields:
        return T.EncDecCache(**fields, len=fill, pos=fill)
    if "c" in fields:
        return T.MLACache(**fields, len=fill, pos=fill)
    if "conv" in fields:
        return T.SSMCache(conv=fields["conv"], ssm=fields["ssm"],
                          attn_k=fields.get("attn_k"),
                          attn_v=fields.get("attn_v"),
                          len=(fields["attn_k"].shape[3] - 1
                               if "attn_k" in fields else fill), pos=fill)
    return T.KVCache(**fields, len=fill, pos=fill)


def _cell_case(arch: str, shape_name: str, mesh, overrides: dict):
    """(step, args, host bytes, device) of one cell under the active fake
    mode."""
    cfg = get_config(arch, **overrides)
    cell = SHAPES[shape_name]
    dev = mesh.device
    batch = _host_batch(input_specs(cfg, cell))
    if cell.kind == "train":
        tcfg = TrainConfig(opt=_train_opt_for(arch))
        return (*train_case(cfg, tcfg, mesh, batch, dev), dev)
    if cell.kind == "prefill":
        return (*prefill_case(cfg, mesh, batch, dev), dev)
    return (*decode_case(cfg, cell, mesh, batch, dev), dev)


def trace_cell(arch: str, shape_name: str, mesh, *, opt: bool = False,
               cfg_overrides: dict | None = None, detail: bool = False):
    """The record of one cell on ``mesh`` (a dry run's fake group; its
    device is the route traced) -> (record, the step's outputs);
    ``detail`` as `measure`."""
    overrides = dict(cfg_overrides or {})
    ctx = contextlib.nullcontext()
    if opt:
        overrides = {**opt_overrides_for(arch, shape_name), **overrides}
        dp = data_axes(mesh)
        ctx = act_sharding.use_mesh_axes(dp if len(dp) > 1 else dp[0],
                                         "model")
    with FakeTensorMode(), ctx:
        step, args, host, dev = _cell_case(arch, shape_name, mesh, overrides)
        return measure(step, args, device_type=dev.type,
                       mesh_shape=mesh.shape, host_bytes=host, detail=detail,
                       batch_last=True)


def run_cell(arch: str, shape_name: str, mesh_kind: str, force=False,
             opt=False, device: str = "cuda", mesh=None,
             report_dir=REPORT_DIR) -> dict:
    """Trace one cell and write its record (or read it back unless
    ``force``); the fake group of ``mesh_kind``'s ranks must be this
    process's (`fake_group`), and ``mesh``, when given, its production
    mesh on ``device``; the record goes to ``report_dir``."""
    report_dir = pathlib.Path(report_dir)
    report_dir.mkdir(parents=True, exist_ok=True)
    suffix = "_opt" if opt else ""
    out_path = report_dir / f"{arch}__{shape_name}__{mesh_kind}{suffix}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind + suffix,
           "opt": opt, "device": device}
    try:
        if mesh is None:
            with FakeTensorMode():
                mesh = make_production_mesh(
                    multi_pod=(mesh_kind == "multi"), device=device)
        rec["mesh_shape"] = dict(mesh.shape)
        got, _ = trace_cell(arch, shape_name, mesh, opt=opt)
        rec.update({"ok": True, "trace_s": round(time.time() - t0, 2),
                    **got})
    except Exception as e:  # a failing cell is a bug; record it loudly
        rec.update({"ok": False, "trace_s": round(time.time() - t0, 2),
                    "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def summary_line(rec: dict, arch: str, cell: str, mk: str) -> str:
    status = "OK " if rec.get("ok") else "FAIL"
    mem = rec.get("memory", {})
    per_dev = (mem.get("argument_bytes", 0) + mem.get("temp_bytes", 0)) \
        / 2 ** 30
    cost = rec.get("cost", {})
    return (f"[{status}] {arch:22s} {cell:12s} {mk:6s} "
            f"trace={rec.get('trace_s', '-'):>7}s "
            f"mem/dev={per_dev:7.2f}GiB "
            f"flops={cost.get('flops', 0):.3e} "
            f"coll={cost.get('collective_bytes', 0):.3e}B"
            + ("" if rec.get("ok") else f"  err={rec.get('error')}"))


# ----------------------------------------------------------------------
# named cases, each run in a fresh process (`isolated`)
# ----------------------------------------------------------------------
def sharded_step(arch: str, *, smoke: bool = False, layers: int = 0,
                 batch: tuple = (2, 2048), world: int = 2, rank: int = 0,
                 mesh_shape: tuple | None = None,
                 axes: tuple = ("data",)) -> dict:
    """One sharded AdamW train step of ``arch`` under full remat
    (``layers`` > 0 cuts its depth) on (B, S) ``batch`` tokens, traced on
    the card's route as ``rank`` of a fake group of ``world`` ranks over
    ``axes`` (extents ``mesh_shape``, default ``(world,)``)."""
    overrides = {"remat": "full"}
    if layers:
        overrides["n_layers"] = layers
    cfg = get_config(arch, smoke=smoke, **overrides)
    tcfg = TrainConfig(opt=OptConfig())

    t0 = time.time()
    with fake_group(world, rank), FakeTensorMode():
        mesh = train_mesh(tuple(mesh_shape or (world,)), tuple(axes),
                          device="cuda")
        B, S = batch
        host = {"tokens": np.zeros((B, S), np.int32),
                "labels": np.zeros((B, S), np.int32)}
        dev = mesh.device
        step, args, hb = train_case(cfg, tcfg, mesh, host, dev)
        got, res = measure(step, args, device_type=dev.type,
                           mesh_shape=mesh.shape, host_bytes=hb,
                           batch_last=True)
    got["metrics"] = {k: res[2][k] for k in (
        "collectives", "gathered_bytes", "reduced_bytes")}
    return {"arch": arch, "world": world, "rank": rank,
            "trace_s": round(time.time() - t0, 2), **got}


def serve_case(arch: str, *, layers: int = 0, prompt: int = 448) -> dict:
    """A serving engine's work on the card's route, no group: a
    ``prompt``-token prefill of one sequence and one decode step of the
    serving `Model` of ``arch`` (``layers`` > 0 cuts its depth), each
    traced under its own record; the weights are the model's own."""
    cfg = get_config(arch, **({"n_layers": layers} if layers else {}))
    t0 = time.time()
    with FakeTensorMode():
        model = build_model(cfg, device="cuda")
        dev = model.device
        weights = list(model.parameters())
        tokens = torch.zeros(1, prompt, dtype=torch.int32, device=dev)
        pre, (_, cache) = measure(lambda w, t: model.prefill(t),
                                  (weights, tokens), device_type=dev.type)
        tok = torch.zeros(1, dtype=torch.int32, device=dev)
        dec, _ = measure(lambda w, c, t: model.decode_step(c, t),
                         (weights, cache, tok), device_type=dev.type)
    return {"arch": arch, "layers": cfg.n_layers,
            "trace_s": round(time.time() - t0, 2), "prefill": pre,
            "decode": dec}


def cell_arguments(mesh_kind: str) -> dict:
    """``{"<arch> <shape>": argument bytes a rank}`` of every cell on
    ``mesh_kind``'s production mesh on the card's route, from each cell's
    set-up alone (no step traced)."""
    out = {}
    with fake_group(MESH_WORLD[mesh_kind]), FakeTensorMode():
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
        for arch in ARCH_IDS:
            for cell in shape_cells_for(arch):
                _, args, host, dev = _cell_case(arch, cell, mesh, {})
                live = LiveBytes(dev.type)
                live.track(args[:-1])
                out[f"{arch} {cell}"] = live.live + host
    return out


CASES = {"sharded_step": sharded_step, "serve_case": serve_case,
         "cell_arguments": cell_arguments}


def start(argv, *, card: bool = True) -> subprocess.Popen:
    """Start ``python -m repro_torch.launch.dryrun *argv`` in a fresh
    process with this package on its path, its output piped.  With
    ``card=False`` the process sees no card (``CUDA_VISIBLE_DEVICES``
    empty): its trace takes the meta device for the card's route, as on a
    machine without one, and opens no CUDA context."""
    env = dict(os.environ)
    src = str(pathlib.Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    if not card:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def case_argv(case: str, **kwargs) -> list:
    """The arguments that run ``CASES[case](**kwargs)`` (`start`); the
    process's last line is its record."""
    return ["--case", json.dumps({"case": case, "kwargs": kwargs})]


def finish(p: subprocess.Popen, timeout_s: float) -> str:
    """Wait for a process of `start` and return its output; raise, having
    killed it, if it runs past ``timeout_s`` or exits non-zero."""
    try:
        out, err = p.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        raise
    if p.returncode != 0:
        raise RuntimeError(f"dry run {p.args[3:]} failed (rc {p.returncode})"
                           f":\n{out[-2000:]}{err[-4000:]}")
    return out


def isolated(case: str, timeout_s: float = 600.0, **kwargs) -> dict:
    """Run ``CASES[case](**kwargs)`` in a fresh Python process (so no fake
    group or mode outlives it here) and return its record."""
    out = finish(start(case_argv(case, **kwargs)), timeout_s)
    return json.loads(out.strip().splitlines()[-1])


# ----------------------------------------------------------------------
# the command line
# ----------------------------------------------------------------------
def _mesh_cells(args, mk: str) -> list:
    archs = [args.arch] if args.arch else ARCH_IDS
    done = []
    with fake_group(MESH_WORLD[mk]):
        with FakeTensorMode():
            mesh = make_production_mesh(multi_pod=(mk == "multi"),
                                        device=args.device)
        for arch in archs:
            cells = shape_cells_for(arch)
            if args.shape:
                cells = [c for c in cells if c == args.shape]
            for cell in cells:
                rec = run_cell(arch, cell, mk, force=args.force,
                               opt=args.opt, device=args.device, mesh=mesh,
                               report_dir=args.report_dir)
                print(summary_line(rec, arch, cell, mk), flush=True)
                done.append(rec)
    return done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS)
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="perf-optimized configuration (recorded as *_opt)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the route traced: cuda (the kernels' shape "
                         "routes; no card needed) or cpu (the plain "
                         "versions)")
    ap.add_argument("--report-dir", default=str(REPORT_DIR),
                    help="where the records go (default %(default)s)")
    ap.add_argument("--case", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.case is not None:
        spec = json.loads(args.case)
        print(json.dumps(CASES[spec["case"]](**spec["kwargs"])))
        return 0
    if args.mesh != "both":
        recs = _mesh_cells(args, args.mesh)
        return 0 if all(r.get("ok") for r in recs) else 1
    flags = ["--device", args.device, "--report-dir", args.report_dir]
    flags += [f for f, on in (("--force", args.force), ("--opt", args.opt))
              if on]
    for name in ("arch", "shape"):
        if getattr(args, name):
            flags += [f"--{name}", getattr(args, name)]
    rc = 0
    for mk in ("single", "multi"):  # a process a group
        p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                            "--mesh", mk, *flags])
        rc = rc or p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
