#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                       # every phase
    python3 chip_smoke.py --phases device,kernels --verbose-build
    python3 chip_smoke.py --phases device,serve,serve-events

Phases (any failure exits non-zero and prints no result):

1. device    — require CUDA, print the card's name and power limit, build
               the five CUDA kernels from `src/repro_torch/kernels/csrc/`;
2. kernels   — hold each kernel against its plain PyTorch version on the
               card at the shapes of both serving paths, and time kernel,
               plain version and the nearest single PyTorch call (CUDA
               graphs of back-to-back calls, timed with CUDA events; inputs
               stay warm in L2, and the attention, SSD and replan kernels
               are also timed cold, rotating over 64 MB of input copies;
               decode attention, the SSD scan and the replan time every
               launch plan their wrappers weigh).  The replan runs at six
               shapes (`PLAN_SHAPES`, from the served cohort to 256 lanes
               on a 5461-node trie), exact against its plain versions and
               the host search, and in the event runtime's lane forms
               (`CLASS_SHAPES`: class-shifted lanes, some at -inf, with and
               without a blocked column);
3. serve     — an NL2SQL-2 cohort through the fleet runtime: first with the
               workload's stage tables on "cuda" and on "cpu" (identical
               results), then served by two full-width Yi-9B engines
               (random weights from a seed; depth is the only cut): prefill
               and greedy decode for every stage the planner picks, every
               kernel's launches counted over that run;
4. serve-events — the same cohort as an open-arrival stream through the
               event runtime on phase serve's engines (admission, priority
               classes, preemption, an annotation swap, exploration, an
               outage), replayed on the CPU with identical results and its
               launches counted the same way;
5. serve-ssm — the same cohort served by a full-width, full-depth
               Mamba2-1.3B engine (engine-a) and Zamba2-2.7B engine
               (engine-b), with their launches counted the same way; then
               the replan's wall time per round over the serve phases, and
               one fleet round and one resident replan of the event runtime
               under `torch.profiler`, each of which must be one kernel and
               two copies (after the last serve phase that runs: a
               profiler session slows later launches).

On request: `profile` traces one generate per engine after each serve
phase; `parts` (`--phases device,parts`) times copies of the bf16 SSD
kernel with one part taken out or a design alternative put in.

The last three lines of output are the `{"kernels": [...]}` JSON line, the
card's `nvidia-smi` line and `{"ok": true, ...}`.
Needs one card, no network, and no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core and
# float32 CUDA-core operations/s.  A card set below 700 W runs below them.
HBM_BPS = 3.35e12
BF16_OPS = 989e12
F32_OPS = 67e12

SEED = 0
PROMPT = 448
MAX_NEW = 32
N_REQUESTS = 16
ENGINE_LAYERS = {"engine-a": 12, "engine-b": 48}  # yi-9b has 48
# the SSM path: every engine at full depth, and the depth of the reduced
# copy held against float32 on the CPU (zamba2: its shared block twice)
SSM_ENGINES = {"engine-a": "mamba2-1.3b", "engine-b": "zamba2-2.7b"}
SSM_CHECK_LAYERS = {"mamba2-1.3b": 6, "zamba2-2.7b": 12}
BF16_TOL, F32_TOL = 2e-2, 2e-5
# the SSD scan against its plain version: f32 outputs and the f32 state
# (the two sum L = cumsum(A dt), which reaches the thousands, in other
# orders), bf16 outputs within BF16_TOL
SSD_F32_TOL, SSD_STATE_TOL = 1e-3, 2e-3
MODEL_REL_TOL = 5e-2  # bf16 engine vs its float32 CPU copy, relative L2

KERNELS = {
    "trie_plan": ("src/repro_torch/kernels/csrc/trie_plan.cu",
                  "src/repro/kernels/trie_plan.py:285"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:106"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:99"),
    "rms_norm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                 "src/repro/kernels/rmsnorm.py:40"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:91"),
}
# (heads, kv heads, head dim, decode window) of the attention in each
# serving path: zamba2's shared block decodes with its window of 4096
ATTN_SHAPES = {"yi-9b": (32, 4, 128, 0), "zamba2-2.7b": (32, 32, 80, 4096)}


def log(*a):
    print(*a, flush=True)


# ----------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------
def graph_ms(fn, calls: int = 20, reps: int = 7, inputs=None) -> float:
    """Median device milliseconds of one call: ``calls`` back-to-back
    calls captured in a CUDA graph, replayed ``reps`` times between CUDA
    events (no host launch cost in the reading).  Without ``inputs`` each
    call is ``fn()`` and its operands stay warm in L2; with ``inputs`` (a
    list of argument tuples, see `cold_inputs`) call i is
    ``fn(*inputs[i])``, one call per copy."""
    import torch

    if inputs is not None:
        calls = len(inputs)
    call = (lambda i: fn()) if inputs is None else (lambda i: fn(*inputs[i]))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            call(i % calls)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(calls):
            call(i)
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del g
    return statistics.median(times)


def cold_inputs(*tensors, min_bytes: int = 64 << 20):
    """Copies of ``tensors`` whose bytes together exceed ``min_bytes`` (64
    MB against the H100's 50 MB L2): a graph that calls once per copy in
    turn finds each call's operands evicted from L2 by the calls between,
    as the serving loop finds a layer's cache."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    n = max(2, -(-min_bytes // size))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def bound(nbytes: float, ops: float, peak_ops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max()) if out.numel() else 0.0


def check_close(name, out, ref, tol):
    """Max abs error of ``out``; raises unless every element lies within
    tol + tol * |ref| (the bound) and is finite."""
    err = max_err(out, ref)
    ratio = bound_ratio(out, ref, tol)
    if not ratio <= 1.0 or not bool(out.float().isfinite().all()):
        raise AssertionError(f"{name}: max abs err {err:.3g}, worst err / "
                             f"(tol (1 + |ref|)) {ratio:.3g} > 1 (tol {tol})")
    return err


def err_str(out, ref, tol) -> str:
    """The max abs error beside the share of the mixed bound it reaches."""
    return (f"max abs err {max_err(out, ref):.3g}, worst "
            f"{bound_ratio(out, ref, tol):.3g} of tol (1 + |ref|), tol {tol}")


def bound_ratio(out, ref, tol) -> float:
    """The worst ratio of |out - ref| to the bound tol (1 + |ref|): at most
    1 where `check_close` passes."""
    if not out.numel():
        return 0.0
    ref = ref.float()
    return float(((out.float() - ref).abs() / (tol * (1 + ref.abs()))).max())


# ----------------------------------------------------------------------
# phase 1: device
# ----------------------------------------------------------------------
def phase_device(args, rec):
    import torch
    from torch.utils.cpp_extension import is_ninja_available

    from repro_torch.kernels import _build

    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} ninja {is_ninja_available()}")
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    rec["smi"] = smi.stdout.strip().splitlines()[0].strip()
    log(f"nvidia-smi: {rec['smi']}")
    t0 = time.perf_counter()
    _build.extension(verbose=args.verbose_build)
    log(f"build: {len(_build.SOURCES)} sources for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s -> {_build.BUILD_DIR}")


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------
def _blocked_column(td, down_engine: int):
    """1 + the deepest stage position on each node's root path whose engine
    is down, 0 on a clean path (`repro.core.faults.blocked_depth_table`)."""
    pm = td.path_models.cpu().numpy()
    eom = td.engine_of_model.cpu().numpy()
    dead = (pm >= 0) & (eom[np.maximum(pm, 0)] == down_engine)
    pos = np.arange(pm.shape[1])[None, :] + 1
    return np.max(np.where(dead, pos, 0), axis=1).astype(np.float32)


def _host_plan(trie, ann, obj, roots, el, delays, engines, bd):
    """(targets, next models) from the host float64 `select_path`, with the
    blocked column applied as a per-lane terminal mask; a lane at elapsed
    -inf (a deadline-free class) is planned with no latency cap."""
    from repro_torch.core.controller import select_path
    from repro_torch.core.controller_torch import next_model_for

    tgt, nxt = [], []
    for i, u in enumerate(roots):
        t = trie if bd is None else dataclasses.replace(
            trie, terminal=trie.terminal & (bd <= trie.depth[u]))
        free = not np.isfinite(el[i])
        v = select_path(t, ann,
                        dataclasses.replace(obj, lat_cap=None) if free
                        else obj, root=int(u),
                        elapsed_lat=0.0 if free else float(el[i]),
                        engine_delays={e: float(delays[i, j])
                                       for j, e in enumerate(engines)})
        tgt.append(v)
        nxt.append(next_model_for(trie, int(u), v))
    return np.array(tgt), np.array(nxt)


# the replan's shapes: (label, preset, lanes, prefixes).  The served
# cohort's lanes at random nodes and all at the root (its first round),
# the deep trie's lanes at random nodes and 16 at the root, and the two
# fleet scales: `repro`'s fleet benchmark's largest batch on nl2sql_8, all
# at the root, and a mathqa_4 fleet mid-cohort, half at the root
PLAN_SHAPES = (("served", "nl2sql_2", N_REQUESTS, "random"),
               ("served, round 1", "nl2sql_2", N_REQUESTS, "root"),
               ("deep", "mathqa_4", 64, "random"),
               ("deep, round 1", "mathqa_4", N_REQUESTS, "root"),
               ("fleet", "nl2sql_8", 256, "root"),
               ("fleet, deep", "mathqa_4", 256, "half"))


def _plan_case(name, lanes, seed, prefixes="random"):
    """A trie of preset ``name`` on the card, its two objectives, and
    ``lanes`` lanes at random nodes (``prefixes`` "random"), at the root
    ("root") or half at the root ("half"), with random elapsed latency and
    live delays from ``seed``."""
    import torch

    from repro_torch.core import presets
    from repro_torch.core.controller import Objective
    from repro_torch.core.controller_torch import TrieDevice, trie_engines
    from repro_torch.core.trie import Trie
    from repro_torch.core.workload import generate_workload

    tpl = presets.PRESETS[name]()
    trie = Trie.build(tpl)
    ann = generate_workload(tpl, {"mathqa_4": 120}.get(name, 300),
                            seed=0).exact_annotations(trie)
    td = TrieDevice.build(trie, ann, device="cuda")
    engines = trie_engines(tpl)
    rng = np.random.default_rng(seed)
    roots = rng.integers(0, trie.n_nodes, lanes).astype(np.int32)
    el = rng.uniform(0, 1.5, lanes).astype(np.float32)
    delays = rng.uniform(0, 0.5, (lanes, len(engines))).astype(np.float32)
    roots[: {"random": 0, "root": lanes, "half": lanes // 2}[prefixes]] = 0
    term = trie.terminal
    objs = [Objective("max_acc",
                      cost_cap=float(np.quantile(ann.cost[term], 0.5)),
                      lat_cap=float(np.quantile(ann.lat[term], 0.8))),
            Objective("min_cost",
                      acc_floor=float(np.quantile(ann.acc[term], 0.4)),
                      lat_cap=float(np.quantile(ann.lat[term], 0.9)))]

    def cuda(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).cuda()

    return dict(tpl=tpl, trie=trie, ann=ann, td=td, engines=engines,
                roots=roots, el=el, delays=delays, objs=objs,
                t_roots=cuda(roots, np.int32), t_el=cuda(el, np.float32),
                t_ec=cuda(np.zeros(lanes), np.float32),
                t_delays=cuda(delays, np.float32))


# the event runtime's lane forms: (label, preset, lanes).  Lanes of three
# classes in turn: a tight deadline, none (elapsed shifted to -inf) and the
# objective's cap, against the largest class cap, with engine 1 down
CLASS_SHAPES = (("served, classes", "nl2sql_2", N_REQUESTS),
                ("deep, classes", "mathqa_4", 64))


def _class_lanes(c, obj):
    """Case ``c``'s lanes as `run_events` feeds them to the replan under
    priority classes: lane i of class i % 3 (deadlines: the 0.4 latency
    quantile, none, ``obj``'s cap), its elapsed latency shifted by the
    largest cap minus its own (-inf without one), and the objective's cap
    replaced by that largest one.  Returns (objective, shifted elapsed)."""
    import torch

    ann, term = c["ann"], c["trie"].terminal
    caps = (float(np.quantile(ann.lat[term], 0.4)), None, obj.lat_cap)
    eff = max(x for x in caps if x is not None)
    shift = np.array([-np.inf if caps[i % 3] is None else eff - caps[i % 3]
                      for i in range(len(c["roots"]))])
    el = (c["el"].astype(np.float64) + shift).astype(np.float32)
    assert np.isneginf(el).any() and (el > c["el"]).any()
    c["t_el"] = torch.from_numpy(el).cuda()
    return dataclasses.replace(obj, lat_cap=eff), el


def _plan_tensors(c):
    """The replan's tensor operands in `trie_plan_cuda`'s order: the trie's
    columns, then the lanes'."""
    td = c["td"]
    return (td.terminal, td.depth, td.acc, td.cost, td.lat, td.subtree_size,
            td.path_models, td.path_counts, td.engine_of_model, c["t_roots"],
            c["t_el"], c["t_ec"], c["t_delays"])


def _plan_args(c, obj, bd_t):
    from repro_torch.core.controller_torch import _objective_scalars

    return ((*_plan_tensors(c), *_objective_scalars(obj)),
            dict(kind=obj.kind, blocked_depth=bd_t))


def _plan_work(c, obj):
    """(bytes, operations) the replan of these lanes needs: the node
    columns of the union of the lanes' intervals (6 float columns and the
    path-counts row), the lane operands and outputs, and per (lane, node
    in its interval) 2M operations of delay plus about 12 of masks and
    compares."""
    trie, M = c["trie"], c["trie"].n_models
    lo = c["roots"].astype(np.int64)
    hi = lo + trie.subtree_size[lo]
    seen = np.zeros(trie.n_nodes, bool)
    for a, b in zip(lo, hi):
        seen[a:b] = True
    B, E = c["delays"].shape
    nbytes = seen.sum() * (6 * 4 + M * 4) + B * (4 + 4 + 4 * E + 4 + 4 * 2) \
        + M * 4
    ops = float((hi - lo).sum()) * (2 * M + 12)
    return float(nbytes), ops


def _trie_plans(tmod, B, N, sms):
    """The plan `split_plan` picks, then the plans its rule passes over:
    no slices, half and twice its slices, each at 1, 4 and 8 lanes a
    block."""
    chosen = tmod.split_plan(B, N, sms)
    plans = [chosen]
    for s in sorted({1, max(1, chosen.splits // 2),
                     min(tmod.MAX_SPLITS, 2 * chosen.splits)}):
        for lanes in (1, 4, 8):
            if tmod.Plan(s, lanes) not in plans:
                plans.append(tmod.Plan(s, lanes))
    return plans


def _plan_launch(c, obj, plan):
    """A call that launches the kernel with ``plan`` on case ``c``'s lanes
    (no blocked column) and returns (targets, next models)."""
    import torch

    from repro_torch.core.controller_torch import _objective_scalars
    from repro_torch.kernels import trie_plan as tmod

    t = _plan_tensors(c)
    launch = tmod.bind(*t[:11], t[12], *_objective_scalars(obj),
                       kind=obj.kind, plan=plan)

    def run():
        out = torch.empty(2, len(c["roots"]), dtype=torch.int32,
                          device="cuda")
        launch(out)
        return out[0], out[1]

    return run


def check_trie_plan(rec):
    """The replan kernel at every shape of `PLAN_SHAPES`: exact against the
    plain blocked and dense versions and the host `select_path`, for both
    objectives, with and without a blocked column; timed warm and cold in
    L2 (the cold graph calls once per copy of over 64 MB of the trie's
    columns and the lanes' operands), beside the plain blocked version."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import trie_plan as tmod
    from repro_torch.kernels.trie_plan import fleet_plan_blocked, trie_plan_cuda

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    err = 0.0
    for label, name, lanes, prefixes in PLAN_SHAPES:
        c = _plan_case(name, lanes, seed=lanes, prefixes=prefixes)
        N = c["trie"].n_nodes
        where = f"trie_plan {label} ({name} N={N} B={lanes})"
        bd = _blocked_column(c["td"], int(c["td"].engine_of_model[-1]))
        assert bd.max() > 0
        for obj in c["objs"]:
            for blocked in (None, bd):
                bd_t = None if blocked is None else \
                    torch.from_numpy(blocked).cuda()
                a, kw = _plan_args(c, obj, bd_t)
                plain = fleet_plan_blocked(*a, **kw)
                dense = ref.fleet_plan(*a[:7], *a[8:], **kw)
                host = _host_plan(c["trie"], c["ann"], obj, c["roots"],
                                  c["el"], c["delays"], c["engines"], blocked)
                got = trie_plan_cuda(*a, **kw)
                for want, what in ((plain, "plain blocked"),
                                   (dense, "plain dense")):
                    for x, y in zip(got, want):
                        if not torch.equal(x, y):
                            raise AssertionError(f"{where} {obj.kind} != "
                                                 f"{what}")
                if not (np.array_equal(got[0].cpu().numpy(), host[0]) and
                        np.array_equal(got[1].cpu().numpy(), host[1])):
                    raise AssertionError(f"{where} {obj.kind} != host "
                                         f"select_path")
                err = max(err, max_err(got[0], plain[0]))
                log(f"  {where} {obj.kind} blocked={blocked is not None}: "
                    f"exact (feasible lanes {int((plain[0] >= 0).sum())})")
        obj = c["objs"][0]
        a, kw = _plan_args(c, obj, None)
        # counts rows off their 16-byte alignment (an offset view) take the
        # kernel's generic path, the one for pool widths other than 2, 4, 8
        counts = c["td"].path_counts
        odd = torch.empty(counts.numel() + 1, device="cuda")[1:]
        odd = odd.view_as(counts).copy_(counts)
        b = (*a[:7], odd, *a[8:])
        if not all(torch.equal(x, y) for x, y in zip(
                trie_plan_cuda(*b, **kw), fleet_plan_blocked(*b, **kw))):
            raise AssertionError(f"{where}: the generic path != plain")
        log(f"  {where} max_acc, counts rows unaligned (generic path): exact")
        scalars = a[len(_plan_tensors(c)):]
        cold = cold_inputs(*_plan_tensors(c))
        ms = graph_ms(lambda: trie_plan_cuda(*a, **kw))
        cold_ms = graph_ms(lambda *t: trie_plan_cuda(*t, *scalars, **kw),
                           inputs=cold)
        del cold
        plain_ms = graph_ms(lambda: fleet_plan_blocked(*a, **kw))
        b_ms, b_by = bound(*_plan_work(c, obj), F32_OPS)
        split = tmod.split_plan(lanes, N, sms)
        # every plan the rule weighs, each exact and timed warm
        want = fleet_plan_blocked(*a, **kw)
        plans = []
        for p in _trie_plans(tmod, lanes, N, sms):
            run = _plan_launch(c, obj, p)
            got = run()
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"{where} plan {p} != plain blocked")
            p_ms = graph_ms(run)
            plans.append(dict(plan=p._asdict(), ms=p_ms))
            log(f"    plan {p.splits} split(s), {p.lanes_per_block} lanes a "
                f"block: {p_ms:.4f} ms, exact"
                f"{' (chosen)' if p == split else ''}")
        rec.setdefault("timing_cases", {})[f"trie_plan {label}"] = dict(
            ms=ms, cold_ms=cold_ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None, preset=name,
            nodes=N, lanes=lanes, prefixes=prefixes, plan=split._asdict(),
            plans=plans)
        log(f"  {where}, {prefixes} prefixes ({split.splits} split(s), "
            f"{split.lanes_per_block} lanes a block): kernel {ms:.4f} ms "
            f"(cold L2 {cold_ms:.4f}), plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}; a launch in "
            f"a graph alone takes ~0.0017)")
        if label == "served":  # the main path's shape
            rec["kernels"]["trie_plan"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, tol=0.0)
    for label, name, lanes in CLASS_SHAPES:
        c = _plan_case(name, lanes, seed=lanes + 1)
        where = f"trie_plan {label} ({name} N={c['trie'].n_nodes} B={lanes})"
        bd = _blocked_column(c["td"], 1)
        assert bd.max() > 0
        bd_t = torch.from_numpy(bd).cuda()
        for base in c["objs"]:
            obj, el = _class_lanes(c, base)
            for blocked, t in ((None, None), (bd, bd_t)):
                a, kw = _plan_args(c, obj, t)
                got = trie_plan_cuda(*a, **kw)
                for want, what in ((fleet_plan_blocked(*a, **kw),
                                    "plain blocked"),
                                   (ref.fleet_plan(*a[:7], *a[8:], **kw),
                                    "plain dense")):
                    if not all(torch.equal(x, y) for x, y in zip(got, want)):
                        raise AssertionError(f"{where} {obj.kind} != {what}")
                host = _host_plan(c["trie"], c["ann"], obj, c["roots"], el,
                                  c["delays"], c["engines"], blocked)
                if not (np.array_equal(got[0].cpu().numpy(), host[0]) and
                        np.array_equal(got[1].cpu().numpy(), host[1])):
                    raise AssertionError(f"{where} {obj.kind} != host "
                                         f"select_path")
                free = np.isneginf(el)
                log(f"  {where} {obj.kind} blocked={blocked is not None}: "
                    f"exact ({int(free.sum())} lanes at -inf, feasible "
                    f"lanes {int((got[0] >= 0).sum())}, of them "
                    f"{int((got[0].cpu().numpy()[free] >= 0).sum())} at "
                    f"-inf)")
    rec["kernels"]["trie_plan"]["max_abs_err"] = err
    log("trie_plan: exact against the plain versions and the host at every "
        "shape and lane form, tol 0")


def _attn_pairs(Sq, Sk, causal, window):
    q = np.arange(Sq)[:, None]
    k = np.arange(Sk)[None, :]
    m = np.ones((Sq, Sk), bool)
    if causal:
        m = k <= q
        if window > 0:
            m &= k > q - window
    return int(m.sum())


def check_flash(rec):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    g = torch.Generator(device="cuda").manual_seed(SEED)
    err = 0.0
    cases = [(torch.bfloat16, BF16_TOL, 448, True, 0),
             (torch.bfloat16, BF16_TOL, 448, True, 64),
             (torch.bfloat16, BF16_TOL, 100, True, 0),
             (torch.bfloat16, BF16_TOL, 100, True, 64),
             (torch.float32, F32_TOL, 100, True, 0)]
    for arch, (H, KV, D, _) in ATTN_SHAPES.items():
        for dt, tol, S, causal, window in cases:
            q = torch.randn(1, H, S, D, generator=g, device="cuda").to(dt)
            k = torch.randn(1, KV, S, D, generator=g, device="cuda").to(dt)
            v = torch.randn(1, KV, S, D, generator=g, device="cuda").to(dt)
            out = flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            want = ref.attention(q, k, v, causal=causal, window=window)
            e = check_close("flash_attention", out, want, tol)
            err = max(err, e)
            log(f"  flash_attention {arch} {str(dt)[6:]} (1,{H},{S},{D}) kv "
                f"{KV} window={window}: {err_str(out, want, tol)}")
            if dt != torch.bfloat16 or S != PROMPT or window:
                continue
            ms = graph_ms(lambda: flash_attention(q, k, v, causal=True))
            plain_ms = graph_ms(lambda: ref.attention(q, k, v, causal=True))
            lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
            cold = cold_inputs(q, k, v)
            cold_ms = graph_ms(lambda *a: flash_attention(*a, causal=True),
                               inputs=cold)
            lib_cold_ms = graph_ms(
                lambda a, b, c: F.scaled_dot_product_attention(
                    a, b, c, is_causal=True, enable_gqa=True), inputs=cold)
            del cold
            nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
            ops = 4.0 * D * H * _attn_pairs(S, S, True, 0)
            b_ms, b_by = bound(nbytes, ops, BF16_OPS)
            case = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=lib_ms, cold_ms=cold_ms,
                        library_cold_ms=lib_cold_ms, tol=BF16_TOL)
            rec.setdefault("timing_cases", {})[
                f"flash_attention {arch} (1,{H},{S},{D}) kv {KV}"] = case
            if arch == "yi-9b":  # the first path's shape heads the table
                rec["kernels"]["flash_attention"] = case
            log(f"  flash_attention {arch} (1,{H},{S},{D}) kv {KV} causal: "
                f"kernel {ms:.4f} ms (cold L2 {cold_ms:.4f}), plain "
                f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms (cold L2 "
                f"{lib_cold_ms:.4f}), bound {b_ms:.6f} ms ({b_by})")
    rec["kernels"]["flash_attention"]["max_abs_err"] = err
    log(f"flash_attention: ok, max abs err {err:.3g}")


def _plan_str(p) -> str:
    return (f"span {p.span} x {p.splits} splits, {p.slices} column slices, "
            f"{p.hc} heads a block")


def _decode_plans(dmod, B, KV, G, S, D, sms, itemsize=2):
    """The plan `split_plan` picks, then the plans its rule passes over:
    with each column slice count, spans of one staged tile and spans just
    short enough that the grid fills a wave of the SMs."""
    chosen = dmod.split_plan(B, KV, G, S, D, sms, itemsize=itemsize)
    tiles = -(-S // (128 // itemsize))
    slabs = B * KV * -(-G // chosen.hc)
    plans = [chosen]
    for c in dmod.column_slices(D, itemsize):
        for n in (tiles, max(tiles, -(-sms // (slabs * c)))):
            span = max(-(-S // dmod.MAX_SPLITS), -(-S // n))
            p = dmod.Plan(span, -(-S // span), chosen.hc, c)
            if p not in plans:
                plans.append(p)
    return plans


def check_decode(rec):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    S, L = PROMPT + 64, PROMPT + 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    err = 0.0

    def rn(*shape, dt):
        return torch.randn(*shape, generator=g, device="cuda").to(dt)

    def check(label, q, kc, vc, lens, w, tol):
        out = decode_attention(q, kc, vc, lens, window=w)
        torch.cuda.synchronize()
        want = ref.decode_attention(q, kc, vc, lens, window=w)
        e = check_close("decode_attention", out, want, tol)
        p = dmod.split_plan(q.shape[0], kc.shape[1],
                            q.shape[1] // kc.shape[1], kc.shape[2],
                            q.shape[2], sms, itemsize=q.element_size())
        log(f"  decode_attention {label} {str(q.dtype)[6:]} q "
            f"{tuple(q.shape)} kv {kc.shape[1]} S={kc.shape[2]} window={w}"
            f" ({_plan_str(p)}): {err_str(out, want, tol)}")
        return e, p

    for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        # both serving shapes, at every window they decode with: batch 1
        # (the served plan) and batch 2
        for arch, (H, KV, D, window) in ATTN_SHAPES.items():
            for lens in ([L], [L, 300]):
                B = len(lens)
                q, kc, vc = rn(B, H, D, dt=dt), rn(B, KV, S, D, dt=dt), \
                    rn(B, KV, S, D, dt=dt)
                lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
                for w in sorted({0, 128, window}):
                    err = max(err, check(f"{arch} lens={tuple(lens.tolist())}",
                                         q, kc, vc, lens, w, tol)[0])
        # the split-K merge: G = 16 and 32 (and 64, two head chunks of
        # 32) at lengths 1, 33 and S, where most splits are empty
        for H, KV in ((32, 2), (32, 1), (64, 1)):
            q, kc, vc = rn(3, H, 128, dt=dt), rn(3, KV, S, 128, dt=dt), \
                rn(3, KV, S, 128, dt=dt)
            lens = torch.tensor([1, 33, S], dtype=torch.int32, device="cuda")
            for w in (0, 48):
                err = max(err, check(f"G={H // KV} lens=(1,33,{S})", q, kc,
                                     vc, lens, w, tol)[0])
        # a cache of one tile: one split, no merge
        H, KV, D, _ = ATTN_SHAPES["zamba2-2.7b"]
        q, kc, vc = rn(2, H, D, dt=dt), rn(2, KV, 32, D, dt=dt), \
            rn(2, KV, 32, D, dt=dt)
        lens = torch.tensor([20, 32], dtype=torch.int32, device="cuda")
        for w in (0, 8):
            e, p = check("one split", q, kc, vc, lens, w, tol)
            assert p.splits == 1, p
            err = max(err, e)

    for arch, (H, KV, D, window) in ATTN_SHAPES.items():
        q1 = rn(1, H, D, dt=torch.bfloat16)
        k1 = rn(1, KV, S, D, dt=torch.bfloat16)
        v1 = rn(1, KV, S, D, dt=torch.bfloat16)
        l1 = torch.tensor([L], dtype=torch.int32, device="cuda")
        mask = (torch.arange(S, device="cuda") < L)[None, None, None, :]
        want = ref.decode_attention(q1, k1, v1, l1, window=window)

        def kernel(q, k, v):
            return decode_attention(q, k, v, l1, window=window)

        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)

        # every plan the rule weighs, each held against the plain version
        # and timed, for the record of the choice
        plans, chosen = [], None
        for p in _decode_plans(dmod, 1, KV, H // KV, S, D, sms):
            chosen = chosen or p
            out = dmod._launch(q1, k1, v1, l1, window, p)
            e = check_close("decode_attention", out, want, BF16_TOL)
            p_ms = graph_ms(lambda p=p: dmod._launch(q1, k1, v1, l1, window,
                                                     p))
            plans.append(dict(plan=p._asdict(), ms=p_ms, max_abs_err=e))
            log(f"    plan {_plan_str(p)}: {p_ms:.4f} ms, max abs err "
                f"{e:.3g}{' (chosen)' if p is chosen else ''}")
        err = max(err, check_close("decode_attention", kernel(q1, k1, v1),
                                   want, BF16_TOL))
        ms = graph_ms(lambda: kernel(q1, k1, v1))
        plain_ms = graph_ms(lambda: ref.decode_attention(q1, k1, v1, l1,
                                                         window=window))
        lib_ms = graph_ms(lambda: sdpa(q1, k1, v1))
        cold = cold_inputs(q1, k1, v1)
        cold_ms = graph_ms(kernel, inputs=cold)
        lib_cold_ms = graph_ms(sdpa, inputs=cold)
        err = max(err, check_close("decode_attention", kernel(*cold[-1]),
                                   want, BF16_TOL))
        del cold
        nbytes = 2 * (2 * q1.numel() + 2 * KV * L * D) + 4
        ops = 4.0 * H * D * L
        b_ms, b_by = bound(nbytes, ops, BF16_OPS)
        case = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms, cold_ms=cold_ms,
                    library_cold_ms=lib_cold_ms, plans=plans, tol=BF16_TOL)
        rec.setdefault("timing_cases", {})[
            f"decode_attention {arch} (1,{H},{D}) kv {KV} cache {S} len {L} "
            f"window {window}"] = case
        if arch == "yi-9b":
            rec["kernels"]["decode_attention"] = case
        log(f"  decode_attention {arch} (1,{H},{D}) kv {KV} cache {S} len {L}"
            f" window {window} ({_plan_str(chosen)}): kernel "
            f"{ms:.4f} ms (cold L2 {cold_ms:.4f}), plain {plain_ms:.4f} ms, "
            f"SDPA {lib_ms:.4f} ms (cold L2 {lib_cold_ms:.4f}), bound "
            f"{b_ms:.6f} ms ({b_by})")
    rec["kernels"]["decode_attention"]["max_abs_err"] = err
    log(f"decode_attention: ok, max abs err {err:.3g}")


def check_rms_norm(rec):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rms_norm

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    err = 0.0
    # yi-9b rows (4096), the mamba2 / zamba2 block norms (2048, 2560) and
    # their gated norms (4096, 5120), and a width that is no multiple of a
    # 16-byte vector (100: element by element); bf16 is timed at one row
    # (decode) at every serving width and at 448 rows (prefill) at yi-9b's
    cases = [(dt, tol, rows, D)
             for dt, tol in ((torch.bfloat16, BF16_TOL),
                             (torch.float32, F32_TOL))
             for D in (4096, 2048, 2560, 5120, 100) for rows in (PROMPT, 1)]
    for dt, tol, rows, D in cases:
        x = (3 * torch.randn(rows, D, generator=g, device="cuda")).to(dt)
        s = torch.rand(D, generator=g, device="cuda") + 0.5
        out = rms_norm(x, s)
        torch.cuda.synchronize()
        want = ref.rms_norm(x, s)
        err = max(err, check_close("rms_norm", out, want, tol))
        log(f"  rms_norm {str(dt)[6:]} ({rows},{D}): "
            f"{err_str(out, want, tol)}")
        if dt != torch.bfloat16 or D == 100 or (rows == PROMPT and D != 4096):
            continue
        sb = s.to(dt)
        ms = graph_ms(lambda: rms_norm(x, s))
        plain_ms = graph_ms(lambda: ref.rms_norm(x, s))
        lib_ms = graph_ms(lambda: F.rms_norm(x, (D,), sb, 1e-6))
        b_ms, b_by = bound(2 * 2 * x.numel() + 4 * D, 4.0 * x.numel(),
                           F32_OPS)
        case = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib_ms, tol=BF16_TOL)
        rec.setdefault("timing_cases", {})[f"rms_norm ({rows},{D})"] = case
        if rows == PROMPT:
            rec["kernels"]["rms_norm"] = case
        log(f"  rms_norm ({rows},{D}) bf16: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, F.rms_norm {lib_ms:.4f} ms, bound "
            f"{b_ms:.6f} ms ({b_by})")
    rec["kernels"]["rms_norm"]["max_abs_err"] = err
    log(f"rms_norm: ok, max abs err {err:.3g}")


def _ssd_inputs(g, S, Hn, P, N, dt_, state):
    """SSD operands as the Mamba block makes them: x, B, C of unit-scale
    activations, dt = softplus of a unit normal, A = -linspace(1, 16) (the
    ``-exp(A_log)`` of ``init_mamba``), and an optional initial state."""
    import torch
    import torch.nn.functional as F

    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    x = (0.5 * rn(1, S, Hn, P)).to(dt_)
    dt = F.softplus(rn(1, S, Hn))
    A = -torch.linspace(1.0, 16.0, Hn, device="cuda")
    Bm, Cm = (0.5 * rn(1, S, N)).to(dt_), (0.5 * rn(1, S, N)).to(dt_)
    h0 = 0.2 * rn(1, Hn, P, N) if state else None
    return x, dt, A, Bm, Cm, h0


def _ssd_work(S, Hn, P, N, Q):
    """(bytes, operations) of one scan: x, dt, A, B, C read and y and the
    final state written once; per chunk of n steps, C.B once for all heads
    (ngroups = 1) over the n(n+1)/2 causal pairs, and per head the decay
    weights (~4 operations a pair), M.x (2P a pair) and the two state
    terms (C.h and the update, 2PN a step each)."""
    nbytes = 2 * (2 * S * Hn * P + 2 * S * N) + 4 * (S * Hn + Hn + Hn * P * N)
    ops = 0.0
    for c0 in range(0, S, Q):
        n = min(Q, S - c0)
        pairs = n * (n + 1) / 2
        ops += pairs * 2 * N + Hn * (pairs * (2 * P + 4) + 4 * n * P * N)
    return float(nbytes), ops


def _ssd_odd_shapes(g, ssd_scan, ref) -> float:
    """Shapes no model serves: N and P not multiples of 8 (the bf16
    kernel stages element by element and pads N and P to 64) and four
    chunks of 32 over 3 heads (the bf16 launch runs each chunk in a block
    of its own, the last one walking the first three chunks)."""
    import torch

    err = 0.0
    for dt_, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, SSD_F32_TOL)):
        x, dt, A, Bm, Cm, h0 = _ssd_inputs(g, 100, 3, 20, 12, dt_, True)
        y, s = ssd_scan(x, dt, A, Bm, Cm, chunk=32, init_state=h0,
                        return_state=True)
        torch.cuda.synchronize()
        yw, sw = ref.ssd_scan_chunked(x, dt, A, Bm, Cm, chunk=32,
                                      init_state=h0, return_state=True)
        e = max(check_close("ssd_scan y", y, yw, tol),
                check_close("ssd_scan state", s, sw, SSD_STATE_TOL))
        log(f"  ssd_scan {str(dt_)[6:]} x (1,100,3,20) N 12 chunk 32 init=True"
            f" final=True: max abs err {e:.3g}")
        err = max(err, e)
    return err


def check_ssd_scan(rec):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as smod
    from repro_torch.kernels.ssd_scan import ssd_scan

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in f32
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    err = 0.0
    for arch in SSM_ENGINES.values():
        c = get_config(arch).ssm
        Hn = c.expand * get_config(arch).d_model // c.head_dim
        P, N = c.head_dim, c.state_dim
        # S = 448 is one whole chunk and a ragged one; 100 and 300 are
        # ragged, 7 and 1 below one 16-row tile; every form: no state, an
        # initial state, the final state
        cases = [(torch.bfloat16, PROMPT, False, True),
                 (torch.bfloat16, PROMPT, False, False),
                 (torch.bfloat16, PROMPT, True, True),
                 (torch.bfloat16, 100, True, True),
                 (torch.bfloat16, 7, True, True),
                 (torch.bfloat16, 1, True, True),
                 (torch.float32, PROMPT, True, True),
                 (torch.float32, 300, False, True),
                 (torch.float32, 100, True, False)]
        for dt_, S, init, final in cases:
            x, dt, A, Bm, Cm, h0 = _ssd_inputs(g, S, Hn, P, N, dt_, init)
            got = ssd_scan(x, dt, A, Bm, Cm, chunk=c.chunk, init_state=h0,
                           return_state=final)
            torch.cuda.synchronize()
            want = ref.ssd_scan_chunked(x, dt, A, Bm, Cm, chunk=c.chunk,
                                        init_state=h0, return_state=final)
            tol = BF16_TOL if dt_ == torch.bfloat16 else SSD_F32_TOL
            y, yw = (got[0], want[0]) if final else (got, want)
            e = check_close("ssd_scan y", y, yw, tol)
            msg = f"y {err_str(y, yw, tol)}"
            if final:
                es = check_close("ssd_scan state", got[1], want[1],
                                 SSD_STATE_TOL)
                msg += f"; state {err_str(got[1], want[1], SSD_STATE_TOL)}"
                e = max(e, es)
            err = max(err, e)
            log(f"  ssd_scan {arch} {str(dt_)[6:]} x (1,{S},{Hn},{P}) N {N} "
                f"chunk {c.chunk} init={init} final={final}: {msg}")
        if arch == SSM_ENGINES["engine-a"]:
            err = max(err, _ssd_odd_shapes(g, ssd_scan, ref))
        # time the form the prefill calls: bf16, S = 448, final state; every
        # run count the wrapper weighs first (1 to one a chunk), each held
        # against the plain version
        x, dt, A, Bm, Cm, _ = _ssd_inputs(g, PROMPT, Hn, P, N,
                                          torch.bfloat16, False)
        want = ref.ssd_scan_chunked(x, dt, A, Bm, Cm, chunk=c.chunk,
                                    return_state=True)
        Q = min(c.chunk, PROMPT)
        nchunks = -(-PROMPT // Q)
        chosen = smod.scan_runs(1, Hn, P, nchunks, sms)
        plans = []
        for runs in range(1, nchunks + 1):
            out = smod._launch(x, dt, A, Bm, Cm, Q, None, True, runs)
            e = max(check_close("ssd_scan y", out[0], want[0], BF16_TOL),
                    check_close("ssd_scan state", out[1], want[1],
                                SSD_STATE_TOL))
            p_ms = graph_ms(lambda r=runs: smod._launch(x, dt, A, Bm, Cm, Q,
                                                        None, True, r))
            nb = smod.blocks(1, Hn, P, runs)
            plans.append(dict(runs=runs, ms=p_ms, max_abs_err=e, blocks=nb))
            err = max(err, e)
            log(f"    plan {runs} chunk run(s) ({nb} blocks): {p_ms:.4f} ms,"
                f" max abs err {e:.3g}{' (chosen)' if runs == chosen else ''}")

        def kernel(*a):
            return ssd_scan(*a, chunk=c.chunk, return_state=True)

        ms = graph_ms(lambda: kernel(x, dt, A, Bm, Cm))
        plain_ms = graph_ms(lambda: ref.ssd_scan_chunked(
            x, dt, A, Bm, Cm, chunk=c.chunk, return_state=True))
        cold = cold_inputs(x, dt, A, Bm, Cm)
        cold_ms = graph_ms(kernel, inputs=cold)
        got = kernel(*cold[-1])
        err = max(err, check_close("ssd_scan y", got[0], want[0], BF16_TOL),
                  check_close("ssd_scan state", got[1], want[1],
                              SSD_STATE_TOL))
        del cold
        work = _ssd_work(PROMPT, Hn, P, N, c.chunk)
        b_ms, b_by = bound(*work, BF16_OPS)      # bf16 on the tensor cores
        f32_ms, f32_by = bound(*work, F32_OPS)   # the float32 kernel's
        case = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    bound_f32_ms=f32_ms, bound_f32_by=f32_by,
                    library_ms=None, cold_ms=cold_ms, plans=plans,
                    tol=BF16_TOL)
        rec.setdefault("timing_cases", {})[
            f"ssd_scan {arch} x (1,{PROMPT},{Hn},{P}) N {N}"] = case
        if arch == SSM_ENGINES["engine-a"]:
            rec["kernels"]["ssd_scan"] = case
        log(f"  ssd_scan {arch} x (1,{PROMPT},{Hn},{P}) N {N} bf16 with final"
            f" state ({chosen} chunk run(s)): kernel {ms:.4f} ms (cold L2 "
            f"{cold_ms:.4f}), plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms "
            f"({b_by}; at the float32 peak {f32_ms:.6f}, {f32_by}), no "
            f"single PyTorch call")
    rec["kernels"]["ssd_scan"]["max_abs_err"] = err
    log(f"ssd_scan: ok, max abs err {err:.3g}")


def phase_kernels(args, rec):
    rec["kernels"] = {}
    for check in (check_trie_plan, check_flash, check_decode, check_rms_norm,
                  check_ssd_scan):
        check(rec)
    log("kernels: " + ", ".join(f"{k} ok (max abs err "
                                f"{v['max_abs_err']:.3g}, tol {v['tol']})"
                                for k, v in rec["kernels"].items()))


# ----------------------------------------------------------------------
# phase parts (on request): where the bf16 SSD kernel's time goes
# ----------------------------------------------------------------------
# copies of `csrc/ssd_scan.cu`, by the macros they are built with: bits of
# its `SsdVariant` in SSD_VARIANT take one part out of the bf16 kernel or
# put in the alternative a design choice was weighed against; SSD_KEYS
# sets the keys of a C.B tile
SSD_PARTS = {
    "whole kernel": (),
    "launch only": ("SSD_VARIANT=1",),
    "no outputs (y)": ("SSD_VARIANT=2",),
    "no state update": ("SSD_VARIANT=4",),
    "staging and L scan only": ("SSD_VARIANT=6",),
    "no carried term C.h": ("SSD_VARIANT=8",),
    "no key tiles (C.B, M, M.x)": ("SSD_VARIANT=16",),
    "no C.B products": ("SSD_VARIANT=32",),
    "M without its exps": ("SSD_VARIANT=64",),
    "no M.x products": ("SSD_VARIANT=128",),
    "y not stored": ("SSD_VARIANT=256",),
    "C and B staged a quarter": ("SSD_VARIANT=512",),
}
SSD_ALTERNATIVES = {
    "C staged with B and x (not during the update)": ("SSD_VARIANT=1024",),
    "y stored from the fragments (not through shared rows)":
        ("SSD_VARIANT=2048",),
    "16-key C.B tiles (not 32)": ("SSD_KEYS=16",),
    "64-key C.B tiles (not 32)": ("SSD_KEYS=64",),
}


def phase_parts(args, rec):
    """Time copies of the bf16 SSD kernel at both serving shapes (S 448,
    chunk 256, final state, the run count the wrapper picks), as
    `check_ssd_scan` times the kernel.  A copy with a part taken out
    computes wrong outputs and only its time is read; the difference to the
    whole kernel is what that part costs on the critical path.  A copy
    with an alternative is held against the plain version as well."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ssd_scan as smod
    from repro_torch.kernels.flash_attention import DTYPES

    t0 = time.perf_counter()
    copies = {name: _build.extension(defines=d)
              for name, d in {**SSD_PARTS, **SSD_ALTERNATIVES}.items()}
    log(f"parts: {len(copies)} copies built in "
        f"{time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rec["parts"] = {}
    for arch in SSM_ENGINES.values():
        c = get_config(arch).ssm
        Hn = c.expand * get_config(arch).d_model // c.head_dim
        P, N, Q = c.head_dim, c.state_dim, min(c.chunk, PROMPT)
        runs = smod.scan_runs(1, Hn, P, -(-PROMPT // Q), sms)
        x, dt, A, Bm, Cm, _ = _ssd_inputs(g, PROMPT, Hn, P, N,
                                          torch.bfloat16, False)
        want = ref.ssd_scan_chunked(x, dt, A, Bm, Cm, chunk=Q,
                                    return_state=True)
        y = torch.empty_like(x)
        st = torch.empty(1, Hn, P, N, device="cuda")
        for name, ext in copies.items():
            def call(ext=ext):
                ext.ssd_scan(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                             Bm.data_ptr(), Cm.data_ptr(), 0, y.data_ptr(),
                             st.data_ptr(), 1, PROMPT, Hn, P, N, Q,
                             DTYPES[torch.bfloat16], runs,
                             torch.cuda.current_stream().cuda_stream)

            call()
            msg = ""
            if name in SSD_ALTERNATIVES or name == "whole kernel":
                e = max(check_close("ssd_scan y", y, want[0], BF16_TOL),
                        check_close("ssd_scan state", st, want[1],
                                    SSD_STATE_TOL))
                msg = f", max abs err {e:.3g}"
            us = 1e3 * graph_ms(call)
            rec["parts"][f"{arch} {name}"] = us
            log(f"  ssd_scan parts {arch} ({runs} chunk run(s)) {name}: "
                f"{us:.2f} us{msg}")


# ----------------------------------------------------------------------
# phase 3: serve an NL2SQL-2 cohort
# ----------------------------------------------------------------------
def _cohort():
    from repro_torch.core import presets
    from repro_torch.core.controller import Objective
    from repro_torch.core.trie import Trie
    from repro_torch.core.workload import generate_workload

    tpl = presets.nl2sql_2()
    trie = Trie.build(tpl)
    wl = generate_workload(tpl, 300, seed=0)
    ann = wl.exact_annotations(trie)
    term = trie.terminal
    obj = Objective("max_acc",
                    cost_cap=float(np.quantile(ann.cost[term], 0.5)),
                    lat_cap=float(np.quantile(ann.lat[term], 0.8)))
    reqs = np.random.default_rng(7).choice(300, N_REQUESTS, replace=False)
    return tpl, trie, wl, ann, obj, reqs


def _same_results(a, b):
    keys = ("success", "total_cost", "total_lat", "models", "n_stages",
            "slo_violated", "outcome")
    return all(getattr(x, k) == getattr(y, k) for x, y in zip(a, b)
               for k in keys) and len(a) == len(b)


def _model_check(model, rec, label, prompt_len):
    """The bf16 engine ``model`` with its kernels against a float32 copy of
    it on the CPU (plain versions): prefill logits of a ragged prompt and
    two decode steps, relative L2 error within MODEL_REL_TOL."""
    import torch

    from repro_torch.models.transformer import Model

    cfg32 = dataclasses.replace(model.cfg, dtype="float32")
    cpu = Model(cfg32, device="cpu")
    with torch.no_grad():
        for (n, p), (_, q) in zip(cpu.named_parameters(),
                                  model.named_parameters()):
            p.copy_(q.float().cpu())
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, model.cfg.vocab, (1, prompt_len)))
    lg, cache = model.prefill(toks.cuda())
    lc, ccache = cpu.prefill(toks)
    errs = []
    for step in range(3):
        a, b = lg.float().cpu(), lc
        errs.append(float((a - b).norm() / b.norm()))
        if not bool(a.isfinite().all()) or errs[-1] > MODEL_REL_TOL:
            raise AssertionError(f"{label} logits off their float32 CPU copy:"
                                 f" rel err {errs}")
        if step == 2:
            break
        nxt = lg.argmax(-1)
        lg, cache = model.decode_step(cache, nxt)
        lc, ccache = cpu.decode_step(ccache, nxt.cpu())
    rec.setdefault("model_rel_err", {})[label] = errs
    log(f"  {label} vs float32 CPU copy (prefill {prompt_len} tokens, 2 "
        f"decode steps): relative L2 err {', '.join(f'{e:.3g}' for e in errs)}"
        f" (tol {MODEL_REL_TOL})")


def _reduced_copy(model, n_layers):
    """A model of ``model``'s config at ``n_layers`` holding its first
    ``n_layers`` layers' weights (and every shared weight), on the card."""
    import torch

    from repro_torch.models.transformer import Model

    small = Model(dataclasses.replace(model.cfg, n_layers=n_layers),
                  device="cuda")
    weights = model.state_dict()
    with torch.no_grad():
        for n, p in small.named_parameters():
            p.copy_(weights[n])
    return small


def _kernel_family(name: str) -> str:
    """Our five kernels by name, cuBLAS's matmuls (``nvjet``/``gemv``/
    ``gemm``/``xmma`` kernels), and everything else."""
    low = name.lower()
    for key, fam in (("trie_plan", "trie_plan"),
                     ("flash_kernel", "flash_attention"),
                     ("decode_kernel", "decode_attention"),
                     ("rmsnorm", "rms_norm"),
                     ("ssd_kernel", "ssd_scan")):
        if key in low:
            return fam
    if any(k in low for k in ("nvjet", "gemv", "gemm", "xmma", "cutlass")):
        return "matmul (cuBLAS)"
    return "other (elementwise, rope, copies, argmax)"


def _profile_generate(name, eng, rec):
    """Where one stage invocation's time goes: one `generate` of engine
    ``name`` under `torch.profiler`, its device kernels summed by family
    against the profiled wall time (the profiler's own host cost included,
    so the busy share is a lower bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prompt = np.random.default_rng(SEED).integers(
        0, eng.model.cfg.vocab, (1, PROMPT))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(prompt, max_new=MAX_NEW)
        wall_ms = (time.perf_counter() - t0) * 1e3
    fam, by_name = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            f = _kernel_family(e.name)
            fam[f] = fam.get(f, 0.0) + ms
            by_name[e.name] = by_name.get(e.name, 0.0) + ms
    busy = sum(fam.values())
    rec.setdefault("profile", {})[name] = dict(
        wall_ms=wall_ms, device_ms=busy, by_family_ms=fam)
    log(f"  profile {name}: one generate ({PROMPT} + {MAX_NEW} tokens) "
        f"wall {wall_ms:.1f} ms, device kernels {busy:.1f} ms, busy share "
        f"{busy / wall_ms:.3f}")
    for f, ms in sorted(fam.items(), key=lambda kv: -kv[1]):
        log(f"    {f}: {ms:.2f} ms ({ms / busy:.3f} of device time)")
    for n, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"      {ms:8.2f} ms  {n[:90]}")


def _expected_launches(cfg, invocations: int) -> dict:
    """Kernel launches of ``invocations`` stage invocations (a prefill and
    MAX_NEW decode steps each) on an engine of ``cfg``: per prefill, L
    flash launches (dense) or L SSD scans and L / attn_every flash launches
    (hybrid: its shared block); per decode step as many decode-attention
    launches; 2L + 1 RMSNorms per prefill and per step (block norms, or
    block and gated norms, and the final norm) plus 2 per shared-block
    application."""
    L = cfg.n_layers
    attn = L if cfg.family == "dense" else \
        L // cfg.hybrid.attn_every if cfg.family == "hybrid" else 0
    norms = 2 * L + 1 + (2 * attn if cfg.family == "hybrid" else 0)
    per_run = {"flash_attention": attn, "decode_attention": attn * MAX_NEW,
               "rms_norm": norms * (1 + MAX_NEW),
               "ssd_scan": 0 if cfg.family == "dense" else L}
    return {k: v * invocations for k, v in per_run.items()}


def _engine_executor(engines, tpl, wl, tel):
    """The stage executor of the serve phases: a real prefill of PROMPT
    tokens (drawn from the request and the stage) and MAX_NEW greedy
    tokens on the engine of the planned model; success from the
    workload's stage table, the engine's cost, and ttft + decode seconds
    as the stage latency.  Each call's timings go to ``tel``."""

    def executor(q, depth, model_idx, t_now=0.0):
        spec = tpl.models[model_idx]
        eng = engines[spec.engine]
        vocab = eng.model.cfg.vocab
        prompt = np.random.default_rng((SEED, int(q), int(depth))).integers(
            0, vocab, (1, PROMPT))
        out, ttft, dec = eng.generate(prompt, max_new=MAX_NEW)
        if out.shape != (1, MAX_NEW) or out.min() < 0 or out.max() >= vocab:
            raise AssertionError(f"bad generation {out.shape}")
        tel[spec.engine]["prefill_s"].append(ttft)
        tel[spec.engine]["decode_s"].append(dec)
        success = bool(wl.S[q, depth, model_idx])
        return success, eng.cost_of(PROMPT, out.shape[1]), ttft + dec

    return executor


def _check_engine_launches(path, launches, expect, engines, tel):
    """Add the engines' kernel launches for the stage invocations in
    ``tel`` to ``expect`` and raise unless ``launches`` equals it, with
    every kernel the path should launch launched at least once."""
    for e, t in tel.items():
        for k, v in _expected_launches(engines[e].model.cfg,
                                       len(t["prefill_s"])).items():
            expect[k] += v
    log(f"launches on the {path} path: {launches} (expected {expect})")
    used = {k for k, v in expect.items() if v}
    if launches != expect or any(launches[k] <= 0 for k in used):
        raise AssertionError(f"kernel launches on the {path} path do not "
                             f"match the stage invocations")


def _serve_cohort(path, engines, cohort, rec, args):
    """Serve the NL2SQL-2 cohort through the fleet runtime on ``engines``
    (name -> `ServingEngine`), every kernel's launches counted from zero
    over that run alone and checked exactly against the stage
    invocations; the readings go to ``rec["paths"][path]``."""
    import torch

    from repro_torch.core.fleet import run_fleet
    from repro_torch.core.runtime import summarize
    from repro_torch.kernels import _build

    tpl, trie, wl, ann, obj, reqs = cohort
    for eng in engines.values():  # warm-up: cuBLAS handles, allocator
        eng.generate(np.zeros((1, PROMPT), np.int64), max_new=2)
    tel = {e: {"prefill_s": [], "decode_s": []} for e in engines}
    executor = _engine_executor(engines, tpl, wl, tel)

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    results, stats = run_fleet(trie, ann, obj, reqs, executor,
                               device="cuda")
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)

    expect = {k: 0 for k in launches}
    expect["trie_plan"] = stats.rounds
    _check_engine_launches(path, launches, expect, engines, tel)
    s = summarize(results)
    log(f"served {len(results)} NL2SQL-2 requests in {wall:.2f} s: "
        + " ".join(f"{k} {v:.6g}" for k, v in s.items()))
    log(f"plans: {[[tpl.models[m].name for m in r.models] for r in results]}")
    log(f"fleet rounds {stats.rounds}, replan ms per round "
        f"{[round(x * 1e3, 3) for x in stats.replan_s_per_round]}, "
        f"active per round {stats.active_per_round}")
    out = {"launches": launches, "wall_s": wall, "engines": {},
           "replan_s_per_round": list(stats.replan_s_per_round)}
    for e, t in tel.items():
        L = engines[e].model.cfg.n_layers
        if not t["prefill_s"]:
            log(f"  {e}: no stage invocations")
            continue
        pre = np.median(t["prefill_s"]) * 1e3
        dec = np.median(t["decode_s"]) * 1e3 / MAX_NEW
        log(f"  {e} ({engines[e].model.cfg.name}, {L} layers): "
            f"{len(t['prefill_s'])} invocations, prefill {PROMPT} tokens "
            f"median {pre:.2f} ms, decode median {dec:.3f} ms/token "
            f"({MAX_NEW} tokens)")
        stage_s = float(np.median(np.add(t["prefill_s"], t["decode_s"])))
        out["engines"][e] = dict(invocations=len(t["prefill_s"]),
                                 prefill_ms=pre, decode_ms_per_token=dec,
                                 stage_s=stage_s)
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"torch.cuda.max_memory_allocated: "
        f"{out['max_memory_allocated_gb']:.2f} GB")
    if not all(r.n_stages >= 1 for r in results):
        raise AssertionError("a request was served no stage")
    rec.setdefault("paths", {})[path] = out
    if "profile" in args.phases.split(","):
        for ename, eng in sorted(engines.items()):
            _profile_generate(f"{path} {ename}", eng, rec)


def _trace_one(label, fn):
    """``fn()`` once under `torch.profiler`: its device work must be one
    trie_plan kernel, one host-to-device copy and one device-to-host copy,
    and nothing else (no fill).  The window idles 10 ms on either side of
    the call, so the profiler's start and stop cannot cut it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.01)
        fn()
        time.sleep(0.01)
    ops = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    kinds = {"trie_plan kernel": [n for n in ops if "trie_plan" in n],
             "host-to-device copy": [n for n in ops if "HtoD" in n],
             "device-to-host copy": [n for n in ops if "DtoH" in n]}
    other = [n for n in ops if not any(n in v for v in kinds.values())]
    log(f"  {label} under torch.profiler: "
        + ", ".join(f"{len(v)} {k}" for k, v in kinds.items())
        + f", {len(other)} other device operations {other}")
    if any(len(v) != 1 for v in kinds.values()) or other:
        raise AssertionError(f"{label}'s device work is not one kernel and "
                             f"two copies: {ops}")


def _profile_round(cohort, rec):
    """After the last serve phase, since a profiler session leaves later
    launches slower: one round of the cohort's fleet replan, as `run_fleet`
    makes it (the planner's step on 16 lanes at the root, then one copy of
    the plan back), and, when phase serve-events ran, one replan of its
    resident planner (capacity lanes, class-shifted), each under
    `torch.profiler` (`_trace_one`)."""
    from repro_torch.core.controller_torch import (TrieDevice,
                                                   make_fleet_planner,
                                                   make_resident_planner,
                                                   trie_engines)

    tpl, trie, wl, ann, obj, reqs = cohort
    td = TrieDevice.build(trie, ann, device="cuda")
    step = make_fleet_planner(td, obj)
    B, E = len(reqs), len(trie_engines(tpl))
    lanes = (np.zeros(B, np.int32), np.zeros(B, np.float32),
             np.zeros(B, np.float32), np.zeros((B, E), np.float32))
    step(*lanes).cpu()  # the planner's buffers are made outside the window
    _trace_one("one fleet round", lambda: step(*lanes).cpu().numpy())
    ev = rec.get("events_planner")
    if ev is None:
        return
    C = ev["capacity"]
    planner = make_resident_planner(td, dataclasses.replace(obj, lat_cap=None),
                                    C, lat_cap=ev["lat_cap"])
    planner.update(np.arange(C), np.zeros(C, np.int32),
                   np.where(np.arange(C) % 2, -np.inf, 0.0),
                   np.zeros(C, np.float32))
    row = np.zeros(E, np.float32)
    planner.replan(row)  # the first replan runs outside the window
    _trace_one("one resident replan (events)", lambda: planner.replan(row))


def _replan_summary(rec):
    """The serve phases' replan wall time per fleet round, in µs."""
    rounds = [x for p in rec["paths"].values()
              for x in p.get("replan_s_per_round", ())]
    us = np.array(rounds) * 1e6
    rec["replan_us_per_round"] = dict(
        rounds=len(us), median=float(np.median(us)), min=float(us.min()),
        max=float(us.max()))
    log(f"replan per fleet round over the serve phases: median "
        f"{np.median(us):.1f} us (min {us.min():.1f}, max {us.max():.1f}) "
        f"over {len(us)} rounds")


def _engine(tpl, ename, cfg, seed):
    """A `ServingEngine` named ``ename`` with random weights of ``cfg``
    from ``seed``, priced as the preset's model on that engine."""
    import torch

    from repro_torch.models.transformer import Model
    from repro_torch.serving.engine import ServingEngine

    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = Model(cfg, device="cuda").init(gen)
    spec = next(m for m in tpl.models if m.engine == ename)
    n_par = sum(p.numel() for p in model.parameters())
    log(f"engine {ename} hosts {spec.name}: {cfg.name} at full width (d "
        f"{cfg.d_model}, vocab {cfg.vocab}, bf16), {cfg.n_layers} layers, "
        f"{n_par / 1e9:.2f}B parameters")
    return ServingEngine(ename, model, price_per_1k=spec.price, device="cuda")


def phase_serve(args, rec):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import (make_workload_executor, run_cohort,
                                          summarize)

    cohort = _cohort()
    tpl, trie, wl, ann, obj, reqs = cohort
    execu = make_workload_executor(wl)
    res_cuda = run_cohort(trie, ann, obj, reqs, execu, engine="fleet",
                          device="cuda")
    res_cpu = run_cohort(trie, ann, obj, reqs, execu, engine="fleet",
                         device="cpu")
    if not _same_results(res_cuda, res_cpu):
        raise AssertionError("fleet cohort differs between cuda and cpu")
    s = summarize(res_cuda)
    log(f"fleet cohort (stage tables), cuda == cpu on {len(reqs)} requests: "
        f"accuracy {s['accuracy']:.4f} mean_cost {s['mean_cost']:.6g} "
        f"mean_lat {s['mean_lat']:.6g} plans "
        f"{[[tpl.models[m].name for m in r.models] for r in res_cuda]}")

    base = get_config("yi-9b")
    t0 = time.perf_counter()
    engines = {e: _engine(tpl, e, dataclasses.replace(base, n_layers=n),
                          SEED + i)
               for i, (e, n) in enumerate(sorted(ENGINE_LAYERS.items()))}
    torch.cuda.synchronize()
    log(f"reduced: depth only (engine-a 12 layers, engine-b 48 of yi-9b's "
        f"48); weights random from seed {SEED}; init "
        f"{time.perf_counter() - t0:.1f} s")
    _model_check(engines["engine-a"].model, rec, "yi-9b engine-a", 100)
    _serve_cohort("yi-9b", engines, cohort, rec, args)
    if "serve-events" in args.phases.split(","):
        rec["yi_engines"] = engines  # phase serve-events serves on them
    _after_serving(args, rec, "serve", cohort)


def _events_setup(cohort, engines, rec):
    """The knobs of phase serve-events (see `phase_serve_events`)."""
    from repro_torch.core.faults import FaultSchedule
    from repro_torch.core.workload import SLOClass, poisson_arrivals
    from repro_torch.serving.loadsim import EngineLoadModel, FleetLoadModel

    tpl, trie, wl, ann, obj, reqs = cohort
    served = rec["paths"]["yi-9b"]["engines"]
    missing = [e for e in engines if e not in served]
    if missing:
        raise AssertionError(f"phase serve made no stage invocation on "
                             f"{missing}: no service time to model")
    load = FleetLoadModel(
        engines={e: EngineLoadModel(e, concurrency=1, jitter=0.0)
                 for e in engines},
        mean_service_s={e: served[e]["stage_s"] for e in engines})
    arrivals = poisson_arrivals(N_REQUESTS, rate=2.0, seed=11)
    # class deadlines replace the objective's cap, which is dropped so the
    # weight-1 class has none at all: its lanes reach the kernel at -inf
    specs = (SLOClass("interactive", deadline_s=obj.lat_cap, weight=2.0),
             SLOClass("batch", deadline_s=None, weight=1.0))
    faults = FaultSchedule(
        outages=(("engine-b", float(arrivals[3]), float(arrivals[10])),),
        timeout_k=4.0)
    return dict(
        arrivals=arrivals, capacity=4, policy="dynamic_load_aware",
        fleet_load=load, admission="feasibility",
        classes=np.arange(N_REQUESTS) % 2, class_specs=specs, preempt=True,
        annotation_schedule=[(float(arrivals[7]), ann.scaled(lat=1.3))],
        explore=dict(epsilon=0.25, seed=5), faults=faults)


def _counting_planners(counts):
    """Wrap the event runtime's planner factory so each replan is counted
    by whether it carried the blocked column, and `planner_builds()` is
    read just after the planner is made; returns the function that
    restores it."""
    import repro_torch.core.events as ev
    from repro_torch.core.controller_torch import planner_builds

    real = ev.make_resident_planner

    def make(*a, **kw):
        planner = real(*a, **kw)
        counts["builds_at_make"] = planner_builds()
        replan = planner.replan

        def counted(row, blocked=None):
            out = replan(row, blocked=blocked)
            counts["blocked" if blocked is not None else "open"] += 1
            return out

        planner.replan = counted
        return planner

    ev.make_resident_planner = make
    return lambda: setattr(ev, "make_resident_planner", real)


def _events_record(res, stats):
    """What the CPU replay must reproduce exactly."""
    return dict(
        outcome=[r.outcome for r in res], models=[r.models for r in res],
        cost=[r.total_cost for r in res], lat=[r.total_lat for r in res],
        stage_versions=[list(map(int, v)) for v in stats.stage_versions],
        done_t=stats.done_t.tolist(), admit_t=stats.admit_t.tolist(),
        counts={k: getattr(stats, k) for k in (
            "admitted", "rejected", "shed", "failed", "preemptions",
            "resumed", "explored", "annotation_swaps", "engine_outages",
            "engine_recoveries", "checkpointed", "timeouts", "replans",
            "events")})


def _us_str(xs):
    return (f"median {np.median(xs):.1f} us (first {xs[0]:.1f}, min "
            f"{min(xs):.1f}, max {max(xs):.1f}, n {len(xs)})")


def _time_planner_build(cohort, obj, capacity, lat_cap, reps=20):
    """Host wall time, in µs and synchronized, of making a resident
    planner at the served shape (its own acc/cost/lat copies and both
    bound layouts), of its first and of a warm replan, and of one
    `LanePlanner` made, bound and run once against its warm round; over
    ``reps`` fresh planners on a trie device built for the purpose."""
    import torch

    from repro_torch.core.controller_torch import (LanePlanner, TrieDevice,
                                                   make_resident_planner)

    _, trie, _, ann, _, _ = cohort
    td = TrieDevice.build(trie, ann, device="cuda")
    C, E = capacity, td.n_engines
    row = np.zeros(E, np.float32)
    u = np.zeros(C, np.int32)
    el = np.where(np.arange(C) % 2, -np.inf, 0.0).astype(np.float32)
    lanes = (u, el, None, np.zeros((C, E), np.float32))
    lane_obj = dataclasses.replace(obj, lat_cap=lat_cap)
    t = {k: [] for k in ("make", "first_replan", "warm_replan", "lane_bind",
                         "lane_round")}

    def clock(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t[key].append((time.perf_counter() - t0) * 1e6)
        return out

    def bind():
        lp = LanePlanner(td, lane_obj)
        lp(*lanes).cpu()
        return lp

    for _ in range(reps):
        p = clock("make", lambda: make_resident_planner(td, obj, C,
                                                        lat_cap=lat_cap))
        p.update(np.arange(C), u, el, np.zeros(C, np.float32))
        clock("first_replan", lambda: p.replan(row))
        clock("warm_replan", lambda: p.replan(row))
        lp = clock("lane_bind", bind)
        clock("lane_round", lambda: lp(*lanes).cpu())
    return t


def phase_serve_events(args, rec):
    """The cohort as an open-arrival stream through the port's
    `run_events` on the card, on phase serve's two Yi-9B engines: Poisson
    arrivals (2 rps, seed 11) into 4 slots, the load-aware policy with
    concurrency-1 engines whose service times are phase serve's median
    stage times, the feasibility gate, two priority classes (weight 2
    with the objective's cap as its deadline, weight 1 with none) with
    preemption, one annotation swap (latency x 1.3) at the 8th arrival,
    the exploration lane, and an outage of engine-b inside the run with
    timeouts on.  The executor records every stage call; a replay of the
    same event sequence through `run_events(device="cpu")` must give the
    identical run.  trie_plan launches must equal the replans and the
    engines' launches the stage invocations."""
    import torch

    from repro_torch.core.controller_torch import planner_builds
    from repro_torch.core.events import run_events
    from repro_torch.kernels import _build

    engines = rec.get("yi_engines")
    if engines is None:
        raise AssertionError("phase serve-events serves on phase serve's "
                             "engines: run it with phase serve")
    cohort = _cohort()
    tpl, trie, wl, ann, obj, reqs = cohort
    kw = _events_setup(cohort, engines, rec)
    obj_ev = dataclasses.replace(obj, lat_cap=None)
    tel = {e: {"prefill_s": [], "decode_s": []} for e in engines}
    execute = _engine_executor(engines, tpl, wl, tel)
    calls = []

    def recording(q, depth, model_idx, t_now=0.0):
        out = execute(q, depth, model_idx, t_now)
        calls.append(((int(q), int(depth), int(model_idx)), out))
        return out

    counts = {"blocked": 0, "open": 0}
    restore = _counting_planners(counts)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    try:
        res, stats = run_events(trie, ann, obj_ev, reqs, recording,
                                device="cuda", **kw)
    finally:
        restore()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    builds_end = planner_builds()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    expect = {k: 0 for k in launches}
    expect["trie_plan"] = stats.replans
    _check_engine_launches("events", launches, expect, engines, tel)
    if stats.annotation_swaps != 1 or stats.engine_outages != 1 or \
            counts["blocked"] < 1:
        raise AssertionError(
            f"serve-events missed a path: {stats.annotation_swaps} swaps, "
            f"{stats.engine_outages} outages, {counts['blocked']} replans "
            f"with the blocked column")
    if builds_end != counts["builds_at_make"]:
        raise AssertionError(f"planner_builds grew during the run: "
                             f"{counts['builds_at_make']} -> {builds_end}")
    if counts["blocked"] + counts["open"] != stats.replans:
        raise AssertionError("replans counted twice or missed")

    # the same event sequence on the CPU, through the plain planner
    replay = iter(calls)

    def replaying(q, depth, model_idx, t_now=0.0):
        key, out = next(replay)
        if key != (int(q), int(depth), int(model_idx)):
            raise AssertionError(f"the CPU replay asked for stage {key} "
                                 f"as {(q, depth, model_idx)}")
        return out

    cres, cstats = run_events(trie, ann, obj_ev, reqs, replaying,
                              device="cpu", **kw)
    if next(replay, None) is not None:
        raise AssertionError("the CPU replay made fewer stage calls")
    got, want = _events_record(res, stats), _events_record(cres, cstats)
    diff = [k for k in got if got[k] != want[k]]
    if diff:
        raise AssertionError(f"serve-events on the card differs from its "
                             f"CPU replay in {diff}")

    smi = rec["smi"]
    us = np.array(stats.replan_s) * 1e6
    fleet = np.array(rec["paths"]["yi-9b"]["replan_s_per_round"]) * 1e6
    outcomes = {o: got["outcome"].count(o) for o in sorted(set(got["outcome"]))}
    log(f"[{smi}] served {len(res)} NL2SQL-2 requests as an open-arrival "
        f"stream in {wall:.2f} s wall, {stats.events} events, "
        f"{stats.replans} replans ({counts['blocked']} with engine-b down); "
        f"CPU replay identical")
    log(f"[{smi}] replan per event: median {np.median(us):.1f} us (min "
        f"{us.min():.1f}, max {us.max():.1f}) over {len(us)} replans at "
        f"capacity {stats.capacity}; fleet round (phase serve): median "
        f"{np.median(fleet):.1f} us (min {fleet.min():.1f}, max "
        f"{fleet.max():.1f}) over {len(fleet)} rounds")
    log(f"[{smi}] queue wait: mean {stats.mean_queue_wait_s:.4f} s, max "
        f"{float(stats.queue_wait_s.max()):.4f} s (virtual)")
    log(f"[{smi}] outcomes {outcomes}; " + ", ".join(
        f"{k} {v}" for k, v in got["counts"].items()))
    log(f"[{smi}] torch.cuda.max_memory_allocated: {peak_gb:.2f} GB")
    log(f"plans: {[[tpl.models[m].name for m in r.models] for r in res]}")
    log(f"stage versions: {got['stage_versions']}")
    lat_cap = float(kw["class_specs"][0].deadline_s)
    build_us = _time_planner_build(cohort, obj_ev, stats.capacity, lat_cap)
    log(f"[{smi}] a resident planner made (own acc/cost/lat copies, both "
        f"layouts bound): {_us_str(build_us['make'])}; its first replan "
        f"{_us_str(build_us['first_replan'])}, a warm one "
        f"{_us_str(build_us['warm_replan'])}; one LanePlanner made, bound "
        f"and run once {_us_str(build_us['lane_bind'])}, a warm round "
        f"{_us_str(build_us['lane_round'])} (host wall, synchronized)")
    rec.setdefault("paths", {})["events"] = dict(
        launches=launches, wall_s=wall, replan_s=list(stats.replan_s),
        blocked_replans=counts["blocked"], counts=got["counts"],
        outcomes=outcomes, mean_queue_wait_s=stats.mean_queue_wait_s,
        max_memory_allocated_gb=peak_gb, planner_build_us=build_us)
    rec["events_planner"] = dict(capacity=stats.capacity, lat_cap=lat_cap)
    _after_serving(args, rec, "serve-events", cohort)


def phase_serve_ssm(args, rec):
    import torch

    from repro_torch.configs import get_config

    rec.pop("yi_engines", None)
    torch.cuda.empty_cache()  # the dense path's engines are gone
    cohort = _cohort()
    t0 = time.perf_counter()
    engines = {e: _engine(cohort[0], e, get_config(arch), SEED + 10 + i)
               for i, (e, arch) in enumerate(sorted(SSM_ENGINES.items()))}
    torch.cuda.synchronize()
    log(f"reduced: nothing (every layer, full width); weights random from "
        f"seed {SEED + 10}; init {time.perf_counter() - t0:.1f} s")
    for eng in engines.values():
        # a ragged prompt of 300 tokens spans two SSD chunks of 256
        n = SSM_CHECK_LAYERS[eng.model.cfg.name]
        small = _reduced_copy(eng.model, n)
        _model_check(small, rec, f"{eng.model.cfg.name} {eng.name} first {n}"
                     f" layers", 300)
        del small
    _serve_cohort("ssm", engines, cohort, rec, args)
    _after_serving(args, rec, "serve-ssm", cohort)


PHASES = {"device": phase_device, "kernels": phase_kernels,
          "serve": phase_serve, "serve-events": phase_serve_events,
          "serve-ssm": phase_serve_ssm}
SERVE_PHASES = ("serve", "serve-events", "serve-ssm")


def _after_serving(args, rec, name, cohort):
    """After the last serve phase that runs: the replan summary over the
    fleet rounds and the profiled replans (a profiler session leaves
    later launches slower, so it comes last)."""
    phases = args.phases.split(",")
    if any(p in phases for p in SERVE_PHASES[SERVE_PHASES.index(name) + 1:]):
        return
    _replan_summary(rec)
    _profile_round(cohort, rec)
ON_REQUEST = {"parts": phase_parts}  # run only when named


# ----------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}; "
                         "add profile to trace one generate per engine "
                         "after each serve phase, parts to time copies of "
                         "the bf16 SSD kernel with parts taken out")
    ap.add_argument("--verbose-build", action="store_true",
                    help="show the compiler's output (ptxas -v included)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    rec = {"kernels": {}}
    failed = []
    for name, fn in {**PHASES, **ON_REQUEST}.items():
        if name not in phases:
            continue
        if failed:
            log(f"phase {name}: skipped after a failure")
            continue
        log(f"== phase {name}")
        t0 = time.perf_counter()
        try:
            fn(args, rec)
        except Exception:  # a phase boundary: report and fail the run
            traceback.print_exc()
            failed.append(name)
        log(f"== phase {name}: {'FAILED' if name in failed else 'ok'} "
            f"({time.perf_counter() - t0:.1f} s)")
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    if not set(PHASES) <= set(phases):
        log("partial run: no result line")
        return 0
    # each serving path counts its own launches; the line adds them up
    launches = {k: sum(p["launches"][k] for p in rec["paths"].values())
                for k in KERNELS}
    kernels = [dict(name=k, route="cuda", source=KERNELS[k][0],
                    replaces=KERNELS[k][1], launches=launches[k],
                    max_abs_err=v["max_abs_err"], ms=v["ms"],
                    plain_ms=v["plain_ms"], bound_ms=v["bound_ms"],
                    bound_by=v["bound_by"], library_ms=v["library_ms"])
               for k, v in rec["kernels"].items()]
    print(json.dumps({"kernels": kernels}))
    print(rec["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
