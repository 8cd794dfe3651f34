#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                       # every phase
    python3 chip_smoke.py --phases device,kernels --verbose-build
    python3 chip_smoke.py --phases device,train,train-ssm,zoo
    python3 chip_smoke.py --phases device,serve,serve-events
    python3 chip_smoke.py --phases device,kernels,serve-dense,train-hybrid
    python3 chip_smoke.py --phases device,kernels,serve-moe,train-hybrid
    python3 chip_smoke.py --phases device,kernels,serve-media,train-hybrid
    python3 chip_smoke.py --phases device,serve-compiled,train-100m
    python3 chip_smoke.py --phases device,serve-sharded
    python3 chip_smoke.py --phases device,train-sharded
    python3 chip_smoke.py --phases device,train-pipe
    python3 chip_smoke.py --phases device,serve,train-sharded,dryrun

Phases (any failure exits non-zero and prints no result):

1. device    — require CUDA, print the card's name and power limit, build
               the six CUDA kernels from `src/repro_torch/kernels/csrc/`;
2. kernels   — hold each kernel against its plain PyTorch version on the
               card at the shapes of the serving and training paths, and
               time kernel, plain version and the nearest single PyTorch
               call (CUDA graphs of back-to-back calls, timed with CUDA
               events; inputs stay warm in L2, and the attention and SSD
               kernels are also timed cold, rotating over 64 MB of
               input copies; decode attention, the SSD scan and the replan
               time every launch plan their wrappers weigh).  The replan
               runs at six shapes (`PLAN_SHAPES`, from the served cohort to
               256 lanes on a 5461-node trie), exact against its plain
               versions and the host search, and in the event runtime's
               lane forms (`CLASS_SHAPES`).  The flash backward runs at the
               training shapes (`BWD_SHAPES`) and at small ragged,
               windowed and GQA cases (`BWD_SMALL`: G = 7 and 8 run
               clusters of 7 and 8; `BWD_SMALL_BF16`: dq blocks with no
               key tile) from the forward's own output and
               log-sum-exp (held against `ref.attention_fwd`, and at
               every served and training shape, each launch plan
               `fwd_plans` weighs, against `ref.attention_fwd_tiled`
               within FLASH_TILED_TOL (float32: F32_TOL, the kernel's
               split TF32 products) and timed), against
               `ref.attention_bwd`, every case called twice and equal bit
               for bit, beside SDPA's backward (each bf16 small case also
               under every dq variant `bwd_plans` weighs), every launch
               plan its rule weighs checked and timed, and its parts
               (prep, dq, dkdv) and each dq variant's dq timed alone at
               `BWD_PARTS` (the dq blocks an SM holds logged), and the
               forward's training form timed at each bf16 one, at
               train-100m's and at MLA's float32 one (Whisper's encoder
               and cross attention non-causal, Sq != Sk); the attention
               kernels also at the zoo's head dims 16 and 32 in float32
               (the forward timed at the zoo's training and serving
               shapes, `ZOO_FLASH`, decode at the zoo's cache) and at
               MLA's 96 (v padded from 64); every float32 forward also
               against `ref.attention_fwd_tiled`; the SSD scan also timed
               at its training form (2048 steps, no final state); a gradient
               through each autograd `Function` of
               `kernels.ops` is held against autograd through the plain
               version (`check_autograd`);
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
5. serve-compiled — the compiled event engine on the card (no LLM
               engine: the workload executor's stage tables): the cohort
               with serve-events' knobs less the timeout model, equal to
               the host loop on the CPU and at every epoch width, trie_plan
               launches equal to its replan rounds, after the replan's
               width-1, gathered and capacity-wide calls are held equal;
               then a MathQA-4 replay of 250 requests with
               ``stream=True`` (its summary against the materialised
               run's, a 200-request prefix against the host loop on the
               CPU, events/s beside the host loop's on the card, host reads
               an event), and the `quickstart` and `mathqa_loadaware`
               drivers with ``--device cuda``, their CPU lines;
6. serve-sharded — the lane-sharded control plane (`repro_torch.dist`):
               2 ranks on the one card over gloo run the resident planner
               with ``mesh=`` at 64 lanes on NL2SQL-2 and MathQA-4,
               `run_events(devices=2)` on serve-events' cohort and the
               compiled engine on serve-compiled's cohort and its replay's
               200-request prefix with ``stream=True``, each equal bit for
               bit to the single-device run on the card, every rank
               agreeing, one collective a replan, each rank's trie_plan
               launches equal to its plans; then the planner at world size
               1 over NCCL in this process;
7. serve-ssm — the same cohort served by a full-width Mamba2-1.3B
               engine (engine-a, 24 of 48 layers) and a full-width,
               full-depth Zamba2-2.7B engine (engine-b), with their launches counted the same way; then
               the replan's wall time per round over the serve phases, and
               one fleet round and one resident replan of the event runtime
               under `torch.profiler`, each of which must be one kernel and
               two copies (after the last serve phase that runs: a
               profiler session slows later launches).
8. serve-dense — the same cohort served by full-width MiniCPM3-4B
               (engine-a, MLA, 16 of 62 layers) and Mistral-NeMo-12B
               (engine-b, full depth) engines, then one stage invocation of Qwen2-72B (QKV bias)
               at 36 of its 80 layers, each engine's 2-layer copy held
               against its float32 CPU copy, launches exact;
9. serve-moe — the same cohort served by Granite-MoE-1B-A400M (engine-a,
               full width, 12 of 24 layers) and Arctic-480B (engine-b, full width,
               all 128 experts and the dense residual, 2 of 35 layers): the
               routing of each engine's first 2 layers held at full E
               against a float32 reference that routes by its own scores
               (flips only at near-ties, at most 2%), a 2-layer Granite
               copy and a 1-layer, 16-expert Arctic copy held against
               float32 on the CPU over a prefill and 8 decode steps,
               launches exact;
10. serve-media — LLaVA-NeXT-34B (VLM backbone) at full width and depth:
               a 2-layer copy held against float32 on the CPU over a
               prefill with 64 patch embeddings and 8 decode steps, then
               one text-only stage invocation through the engine and one
               image request (2880 patch embeddings and a 448-token
               prompt, 32 greedy tokens); then Whisper-base whole, held
               against float32 on the CPU at B = 2 over encode, prefill
               and 8 decode steps, and a batch of 4 requests (1500 frames
               each, a 64-token prompt, 32 greedy tokens); launches exact;
11. train    — Yi-9B at full width, 12 layers (2.60B parameters), float32
               masters, AdamW, remat, a (2, 2048) batch from a 256-symbol
               Markov source, 4 steps: every gradient present and nonzero,
               the loss falling, a 2-layer copy's loss and gradients
               against its float32 CPU copy, launches per step exact; step
               time, tokens/s, model-FLOP share, peak memory, and one step
               under `torch.profiler`;
12. train-sharded — FSDP-style sharded training (`repro_torch.dist.fsdp`,
               ``train(mesh=)``): Yi-9B at full width, 2 layers, (2, 2048),
               2 steps, AdamW: (a) the single-device step on the card, (b)
               2 ranks on the card over gloo (collectives staged through
               the host) running ``train(mesh=)`` with a checkpoint at
               step 2, (c) the same at world size 1 over NCCL, each held
               to (a) (loss, grad norm, parameter movement), every rank
               agreeing, launches and collectives a step exact; (d) (b)'s
               checkpoint restored onto the NCCL mesh
               (``restore(shardings=)``) equal bit for bit to the restore
               onto no mesh;
13. dryrun   — the dry run (`repro_torch.launch.dryrun`: fake process
               groups, fake tensors, nothing allocated) against the card,
               every trace in a fresh process, all started before the
               first phase, during the build (only world 1's sees the
               card; the others trace its route on the meta device, as
               on a machine without one): train-sharded's step
               traced at world 1 and 2 (collectives, bytes gathered and
               reduced, launches a kernel a rank a step exact against
               train-sharded's runs and one real step at world size 1 over
               NCCL, whose peak the traced arguments + temp meet within
               5%); serve's Yi-9B engines traced over a prefill and one
               decode step (launches exact); three production cells
               through the command line (Yi-9B train_4k on 256 ranks,
               Qwen2-72B decode_32k on 512, Mamba2-1.3B long_500k on
               256), each ok, GB a rank against the card's memory;
14. train-pipe — the GPipe pipeline (`repro_torch.dist.pipeline`):
               Yi-9B at full width, 4 layers in 2 stages, 4 microbatches
               of (1, 2048), 3 passes of forward and backward: (a) the
               microbatches one after the other on the card, (b) 2 ranks
               on the card over gloo, one a stage, the hops staged
               through the host, (c) one stage at world size 1 over NCCL;
               (b) and (c) held to (a) (hidden states, loss, every
               gradient), launches and collectives per rank exact; beside
               them ``python -m repro_torch.launch.train --steps 4``
               (its last line and checkpoint) and ``python -m
               repro_torch.launch.serve --help``;
15. train-ssm — the same for Mamba2-1.3B at full width and depth, (1, 2048),
               3 steps (the SSD kernel forward, the plain recompute back);
16. train-hybrid — the same for Zamba2-2.7B at full width and depth, (1,
               2048), 3 steps (checkpointed layers inside checkpointed
               groups), then one step of a full-width, 1-layer copy of
               Mistral-NeMo-12B, MiniCPM3-4B, Granite-MoE (the loss with
               its aux) and LLaVA (64 patches under ignore-labels) on
               (1, 128) tokens against its float32 CPU copy, launches
               exact; then Whisper-base whole, (2, 448)
               tokens over 1500 frames, 3 steps, one held against its
               float32 CPU copy;
17. train-100m — `repro_torch.examples.train_100m` as `repro`'s example
               sets it (12 layers, d 512, vocab 32768, float32) for 50
               steps at (8, 128) of a 256-symbol Markov source, 2
               microbatches, async checkpoints every third of the run:
               launches of every step exact, the loss falling,
               the last checkpoint restored bit for bit; step time, tokens/s,
               float32 model-FLOP share, and the data source's host memory
               and build time;
18. zoo      — `build_zoo` with `repro`'s ladder on the card (its launches
               exact), held-out accuracy rising from zoo-s to zoo-m to
               zoo-l, then the end-to-end example's loop
               (`repro_torch.examples.serve_workflow`, ``--requests 24
               --profile-runs 80``) with its launches counted;

On request: `profile` traces one generate per engine after each serve
phase; `parts` (`--phases device,parts`) times copies of the decode
kernel (at LLaVA's image cache: copies only, no cluster merge), the bf16
flash forward and the SSD kernel with one part taken out or a design
alternative put in.

The last three lines of output are the `{"kernels": [...]}` JSON line (its
launches summed over the train, zoo and serve paths), the card's
`nvidia-smi` line and `{"ok": true, ...}`.
Needs one card, no network, and no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# engine-a's depth cut (its decode, most of the phase, is host-bound)
SSM_ENGINE_LAYERS = {"mamba2-1.3b": 24}
SSM_CHECK_LAYERS = {"mamba2-1.3b": 6, "zamba2-2.7b": 12}
BF16_TOL, F32_TOL = 2e-2, 2e-5
# the bf16 flash forward against `ref.attention_fwd_tiled`, which rounds P
# to bf16 at the kernel's points and walks its key tiles: only float32
# summation order differs, which can move one bf16 rounding of P or of
# the output by an ulp (2^-8 relative)
FLASH_TILED_TOL = 8e-3
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
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/xla_flash.py:88"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:99"),
    "rms_norm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                 "src/repro/kernels/rmsnorm.py:40"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:91"),
}
# (heads, kv heads, head dim, decode window) of the attention in each
# serving path: zamba2's shared block decodes with its window of 4096;
# mistral-nemo-12b decodes at G = 4, qwen2-72b at G = 8, granite-moe at
# G = 2 and head dim 64, arctic at G = 7 (one odd head chunk of 7)
ATTN_SHAPES = {"yi-9b": (32, 4, 128, 0), "zamba2-2.7b": (32, 32, 80, 4096),
               "mistral-nemo-12b": (32, 8, 128, 0),
               "qwen2-72b": (64, 8, 128, 0),
               "granite-moe-1b-a400m": (16, 8, 64, 0),
               "arctic-480b": (56, 8, 128, 0)}
# minicpm3-4b's MLA prefill: (heads, qk head dim, v head dim); v is padded
# to the qk dim, kv heads = heads
MLA_ATTN = ("minicpm3-4b", 40, 96, 64)
# the zoo's attention (repro's ladder: head dims 16, 16, 32; float32)
ZOO_ATTN = {"zoo-s": (2, 2, 16), "zoo-m": (4, 4, 16), "zoo-l": (4, 4, 32)}
# the zoo's float32 flash forwards, each checked and timed: its training
# form (a batch of 16 sequences of 32 tokens, with the log-sum-exp) and a
# served prefill (one 16-token prompt): (label, B, H, S, D, lse)
ZOO_FLASH = tuple((f"{a} train", 16, H, 32, D, True)
                  for a, (H, _, D) in ZOO_ATTN.items()) + tuple(
    (f"{a} serve", 1, H, 16, D, False) for a, (H, _, D) in ZOO_ATTN.items())
# the zoo's decode as the end-to-end example's loop makes it: one
# request, a 16-token prompt in a cache of 16 + 64 slots, timed at the
# 4th of its 8 steps
ZOO_DECODE = (80, 20)  # (cache slots, length)
# the flash forward at the serve-media phase's shapes, bf16, each checked
# and timed: (label, B, H, KV, Sq, Sk, D, causal); llava's image prefill
# is 2880 patches and a 448-token prompt, whisper's encoder 1500 frames,
# its decoder a 64-token prompt (B = 4 requests)
MEDIA_FLASH = (("llava-next-34b image prefill", 1, 56, 8, 3328, 3328, 128,
                True),
               ("whisper-base encoder", 4, 8, 8, 1500, 1500, 64, False),
               ("whisper-base cross prefill", 4, 8, 8, 64, 1500, 64, False),
               ("whisper-base decoder prefill", 4, 8, 8, 64, 64, 64, True))
# the flash backward at the training shapes: (label, dtype, B, H, KV, Sq,
# Sk, D, causal); llava's 1-layer copy trains on 64 patches + 128 tokens,
# whisper on (2, 448) tokens over 1500 frames
BWD_SHAPES = (("yi-9b train", "bfloat16", 2, 32, 4, 2048, 2048, 128, True),
              ("zamba2-2.7b train", "bfloat16", 1, 32, 32, 2048, 2048, 80,
               True),
              ("minicpm3-4b train", "bfloat16", 1, 40, 40, 2048, 2048, 96,
               True),
              ("granite-moe-1b-a400m train", "bfloat16", 1, 16, 8, 2048,
               2048, 64, True),
              ("llava-next-34b train", "bfloat16", 1, 56, 8, 192, 192, 128,
               True),
              ("whisper-base encoder train", "bfloat16", 2, 8, 8, 1500, 1500,
               64, False),
              ("whisper-base cross train", "bfloat16", 2, 8, 8, 448, 1500,
               64, False),
              ("whisper-base decoder train", "bfloat16", 2, 8, 8, 448, 448,
               64, True),
              ("zoo-s", "float32", 16, 2, 2, 32, 32, 16, True),
              ("zoo-l", "float32", 16, 4, 4, 32, 32, 32, True),
              ("mla float32", "float32", 2, 4, 4, 100, 100, 96, True),
              # train-100m's microbatch (4 of 8 sequences), float32 D = 64
              ("train-100m", "float32", 4, 8, 8, 128, 128, 64, True))
# decode attention at the serve-media phase's shapes, each plan its rule
# weighs checked and timed: (label, B, H, KV, D, cache slots, length);
# whisper's cross cache is full: every length is its capacity
MEDIA_DECODE = (("llava-next-34b image", 1, 56, 8, 128, 3392, 3329),
                ("whisper-base self", 4, 8, 8, 64, 128, 65),
                ("whisper-base cross", 4, 8, 8, 64, 1500, 1500))


def log(*a):
    print(*a, flush=True)


# ----------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------
# a warm graph holds ``calls`` calls, or fewer where they would pass this
# many milliseconds of device work (the plain versions at training shapes)
GRAPH_MIN_MS = 10.0


def graph_ms(fn, calls: int = 20, reps: int = 7, inputs=None) -> float:
    """Median device milliseconds of one call: ``calls`` back-to-back
    calls (fewer past GRAPH_MIN_MS of device work, at least one) captured
    in a CUDA graph, replayed ``reps`` times between CUDA events (no host
    launch cost in the reading).  Without ``inputs`` each call is ``fn()``
    and its operands stay warm in L2; with ``inputs`` (a list of argument
    tuples, see `cold_inputs`) call i is ``fn(*inputs[i])``, one call per
    copy."""
    import math

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
    if inputs is None:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        call(0)
        b.record()
        b.synchronize()
        calls = max(1, min(calls, math.ceil(GRAPH_MIN_MS / max(
            a.elapsed_time(b), 1e-3))))
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
    objectives, with and without a blocked column; timed warm in L2 (a
    cold graph, once a copy of 64 MB of operands, took 13 s of the script
    for a kernel of a few microseconds, and is no longer timed), beside
    the plain blocked version."""
    import torch

    from repro_torch.kernels import cost, ref
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
        ms = graph_ms(lambda: trie_plan_cuda(*a, **kw))
        plain_ms = graph_ms(lambda: fleet_plan_blocked(*a, **kw))
        b_ms, b_by = bound(*cost.plan_work(
            c["trie"].subtree_size, c["roots"], c["trie"].n_models,
            c["delays"].shape[1]), F32_OPS)
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
            ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None, preset=name,
            nodes=N, lanes=lanes, prefixes=prefixes, plan=split._asdict(),
            plans=plans)
        log(f"  {where}, {prefixes} prefixes ({split.splits} split(s), "
            f"{split.lanes_per_block} lanes a block): kernel {ms:.4f} ms "
            f"(warm L2), plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms "
            f"({b_by}; a launch in a graph alone takes ~0.0017)")
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


def _fwd_plan_str(p) -> str:
    return (f"{p.kernel}: {p.consumers} consumer warpgroup(s), {p.rows} "
            f"rows x {p.keys} keys, {p.stages} stages, {p.swizzle} B "
            f"swizzle, grid {p.grid}, {p.smem} shared bytes")


def _fwd_plan_of(q, k, causal: bool = True) -> str:
    """`fwd_plan`'s plan for a launch on these operands, as a string."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import fwd_plan

    B, H, Sq, D = q.shape
    return _fwd_plan_str(fwd_plan(B, H, k.shape[1], Sq, k.shape[2], D,
                                  causal, q.element_size(),
                                  _build.sm_count(q.device.index)))


def _check_f32_tiled(label, q, k, v, out, lse=None, causal: bool = True,
                     window: int = 0) -> float:
    """A float32 forward's output (and log-sum-exp, where given) against
    `ref.attention_fwd_tiled` at the key tile `fwd_plan` picks: the
    kernel's split TF32 products, within F32_TOL; -> the max abs error."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import fwd_plan

    B, H, Sq, D = q.shape
    plan = fwd_plan(B, H, k.shape[1], Sq, k.shape[2], D, causal, 4,
                    _build.sm_count(q.device.index))
    want_o, want_lse = ref.attention_fwd_tiled(
        q, k, v, causal=causal, window=window, keys=plan.keys)
    err = check_close(f"flash_attention {label} against "
                      f"attention_fwd_tiled", out, want_o, F32_TOL)
    msg = f"o {err_str(out, want_o, F32_TOL)}"
    if lse is not None:
        check_close(f"flash_attention lse {label} against "
                    f"attention_fwd_tiled", lse, want_lse, F32_TOL)
        msg += f"; lse {err_str(lse, want_lse, F32_TOL)}"
    log(f"    against attention_fwd_tiled ({plan.keys} keys a tile): {msg}")
    return err


def _time_flash(rec, label, q, k, v, lse: bool = False,
                causal: bool = True):
    """At a served or training shape: every launch plan `fwd_plans` lists
    held against `ref.attention_fwd_tiled` at the plan's key tile
    (`FLASH_TILED_TOL` in bf16; the log-sum-exp too with ``lse``) and
    timed; then the chosen plan timed warm and cold in L2 (with ``lse``,
    in the training form that also writes the log-sum-exp), beside the
    plain version, SDPA on the same mask and the bound, with the host's
    tensor-map encoding time of a bf16 launch; record and return it."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build, cost, ref
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels.flash_attention import flash_attention

    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    bf16 = q.element_size() == 2
    plans = fmod.fwd_plans(B, H, KV, Sq, Sk, D, causal, q.element_size(),
                           _build.sm_count(q.device.index))
    tol = FLASH_TILED_TOL if bf16 else F32_TOL
    plan_ms, tiled_err = {}, 0.0
    for plan in plans:
        want_o, want_lse = ref.attention_fwd_tiled(q, k, v, causal=causal,
                                                   keys=plan.keys)
        o = torch.empty_like(q)
        lv = torch.empty(B, H, Sq, device=q.device) if lse else None
        fmod._launch_fwd(q, k, v, o, lv, causal, 0, plan)
        torch.cuda.synchronize()
        tiled_err = max(tiled_err, check_close(
            "flash_attention against attention_fwd_tiled", o, want_o, tol))
        msg = f"o {err_str(o, want_o, tol)}"
        if lse:
            check_close("flash_attention lse against attention_fwd_tiled",
                        lv, want_lse, F32_TOL)
            msg += f"; lse {err_str(lv, want_lse, F32_TOL)}"
        del want_o, want_lse
        plan_ms[_fwd_plan_str(plan)] = pms = graph_ms(
            lambda: fmod._launch_fwd(q, k, v, o, lv, causal, 0, plan))
        log(f"  flash_attention {label} plan {_fwd_plan_str(plan)}"
            f"{' (chosen)' if plan is plans[0] else ''}: {pms:.4f} ms; "
            f"against attention_fwd_tiled {msg}")
        del o, lv
    ms = graph_ms(lambda: flash_attention(q, k, v, causal=causal,
                                          return_lse=lse))
    plain_ms = graph_ms(lambda: ref.attention(q, k, v, causal=causal),
                        calls=20 if Sq * Sk <= PROMPT * PROMPT else 3)
    lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True))
    cold = cold_inputs(q, k, v)
    cold_ms = graph_ms(lambda *a: flash_attention(*a, causal=causal,
                                                  return_lse=lse),
                       inputs=cold)
    lib_cold_ms = graph_ms(
        lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, is_causal=causal, enable_gqa=True), inputs=cold)
    del cold
    encode_us = None
    if bf16:
        encode_us = _build.extension().flash_encode_ns(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), B, H, KV, Sq, Sk, D,
            plans[0].rows, 1000) / 1e3
    nbytes, ops = cost.flash_work(B, H, KV, Sq, Sk, D, q.element_size(),
                                  causal)
    b_ms, b_by = bound(nbytes, ops, BF16_OPS if bf16 else F32_OPS)
    case = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, cold_ms=cold_ms,
                library_cold_ms=lib_cold_ms,
                tol=BF16_TOL if bf16 else F32_TOL,
                plan=_fwd_plan_str(plans[0]), plan_ms=plan_ms,
                tiled_err=tiled_err, encode_us=encode_us)
    rec.setdefault("timing_cases", {})[f"flash_attention {label}"] = case
    log(f"  flash_attention {label} {'causal' if causal else 'non-causal'}:"
        f" kernel {ms:.4f} ms (cold L2 "
        f"{cold_ms:.4f}), plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms "
        f"(cold L2 {lib_cold_ms:.4f}), bound {b_ms:.6f} ms ({b_by})"
        + (f", tensor maps encoded in {encode_us:.2f} us a launch"
           if bf16 else ""))
    return case


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
                f"{KV} window={window} ({_fwd_plan_of(q, k)}): "
                f"{err_str(out, want, tol)}")
            if dt == torch.float32:
                err = max(err, _check_f32_tiled(arch, q, k, v, out,
                                                window=window))
            if dt != torch.bfloat16 or S != PROMPT or window:
                continue
            case = _time_flash(rec, f"{arch} (1,{H},{S},{D}) kv {KV}", q, k, v)
            if arch == "yi-9b":  # the first path's shape heads the table
                rec["kernels"]["flash_attention"] = case
    # minicpm3-4b's MLA prefill: qk head dim 96, v padded from 64 to 96
    # (the output's first 64 columns are kept), as many kv heads as heads
    arch, H, D, dv = MLA_ATTN
    for dt, tol, S in ((torch.bfloat16, BF16_TOL, PROMPT),
                       (torch.bfloat16, BF16_TOL, 100),
                       (torch.float32, F32_TOL, 100)):
        q = torch.randn(1, H, S, D, generator=g, device="cuda").to(dt)
        k = torch.randn(1, H, S, D, generator=g, device="cuda").to(dt)
        v = F.pad(torch.randn(1, H, S, dv, generator=g, device="cuda"),
                  (0, D - dv)).to(dt)
        out = flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        want = ref.attention(q, k, v, causal=True)
        err = max(err, check_close("flash_attention", out, want, tol))
        if not bool((out[..., dv:] == 0).all()):
            raise AssertionError("flash_attention: the padded v columns "
                                 "gave nonzero output")
        log(f"  flash_attention {arch} MLA {str(dt)[6:]} (1,{H},{S},{D}) kv "
            f"{H}, v padded {dv} -> {D} ({_fwd_plan_of(q, k)}): "
            f"{err_str(out, want, tol)}")
        if dt == torch.float32:
            err = max(err, _check_f32_tiled(f"{arch} MLA", q, k, v, out))
        if dt == torch.bfloat16 and S == PROMPT:
            _time_flash(rec, f"{arch} MLA (1,{H},{S},{D}) kv {H}", q, k, v)
    # the serve-media phase's shapes: llava's image prefill, whisper's
    # encoder and cross attention (non-causal, Sq != Sk, 1500 keys ragged
    # against the tiles) and decoder, at B = 4; then non-causal ragged
    # cases in both dtypes at small sizes
    for label, B, H, KV, Sq, Sk, D, causal in MEDIA_FLASH:
        q = torch.randn(B, H, Sq, D, generator=g, device="cuda").bfloat16()
        k = torch.randn(B, KV, Sk, D, generator=g, device="cuda").bfloat16()
        v = torch.randn(B, KV, Sk, D, generator=g, device="cuda").bfloat16()
        out = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = ref.attention(q, k, v, causal=causal)
        err = max(err, check_close("flash_attention", out, want, BF16_TOL))
        log(f"  flash_attention {label} bf16 ({B},{H},{Sq},{D}) kv {KV} "
            f"Sk={Sk} causal={causal} ({_fwd_plan_of(q, k, causal)}): "
            f"{err_str(out, want, BF16_TOL)}")
        del want
        _time_flash(rec, f"{label} ({B},{H},{Sq},{D}) kv {KV} Sk {Sk}", q, k,
                    v, causal=causal)
    for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for B, H, KV, Sq, Sk, D in ((2, 8, 8, 37, 150, 64),
                                    (2, 8, 2, 150, 37, 64),
                                    (1, 4, 4, 100, 100, 128),
                                    (2, 4, 1, 1, 77, 16)):
            q = torch.randn(B, H, Sq, D, generator=g, device="cuda").to(dt)
            k = torch.randn(B, KV, Sk, D, generator=g, device="cuda").to(dt)
            v = torch.randn(B, KV, Sk, D, generator=g, device="cuda").to(dt)
            out = flash_attention(q, k, v, causal=False)
            torch.cuda.synchronize()
            want = ref.attention(q, k, v, causal=False)
            err = max(err, check_close("flash_attention", out, want, tol))
            log(f"  flash_attention non-causal {str(dt)[6:]} ({B},{H},{Sq},"
                f"{D}) kv {KV} Sk={Sk}: {err_str(out, want, tol)}")
            if dt == torch.float32:
                err = max(err, _check_f32_tiled("non-causal", q, k, v, out,
                                                causal=False))
    # the zoo's head dims, float32 (the zoo's dtype) and bf16, ragged too
    for arch, (H, KV, D) in ZOO_ATTN.items():
        for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            for S in (32, 100):
                q = torch.randn(2, H, S, D, generator=g, device="cuda").to(dt)
                k = torch.randn(2, KV, S, D, generator=g, device="cuda").to(dt)
                v = torch.randn(2, KV, S, D, generator=g, device="cuda").to(dt)
                out = flash_attention(q, k, v, causal=True)
                torch.cuda.synchronize()
                want = ref.attention(q, k, v, causal=True)
                err = max(err, check_close("flash_attention", out, want, tol))
                log(f"  flash_attention {arch} {str(dt)[6:]} (2,{H},{S},{D})"
                    f" kv {KV}: {err_str(out, want, tol)}")
                if dt == torch.float32:
                    err = max(err, _check_f32_tiled(arch, q, k, v, out))
    # the zoo's float32 forwards as its training and serving paths make
    # them, checked and timed (every key tile the rule weighs)
    for label, B, H, S, D, lse in ZOO_FLASH:
        q, k, v = (torch.randn(B, H, S, D, generator=g, device="cuda")
                   for _ in range(3))
        out, lv = flash_attention(q, k, v, causal=True, return_lse=True)
        torch.cuda.synchronize()
        want, want_lse = ref.attention_fwd(q, k, v, causal=True)
        err = max(err, check_close("flash_attention", out, want, F32_TOL))
        check_close("flash_attention lse", lv, want_lse, F32_TOL)
        log(f"  flash_attention {label} float32 ({B},{H},{S},{D}) "
            f"({_fwd_plan_of(q, k)}): {err_str(out, want, F32_TOL)}; lse "
            f"{err_str(lv, want_lse, F32_TOL)}")
        _time_flash(rec, f"{label} ({B},{H},{S},{D})", q, k, v, lse=lse)
    rec["kernels"]["flash_attention"]["max_abs_err"] = err
    log(f"flash_attention: ok, max abs err {err:.3g}")


def _sdpa_bwd_ms(q, k, v, do, causal: bool) -> tuple[float, float]:
    """(ms, ms of its forward) of SDPA's backward alone on the card, timed
    as the kernels are (`graph_ms`: medians over replays of a CUDA graph of
    back-to-back calls, warm, no host cost): one SDPA call with grouped K
    and V (``enable_gqa``) and `autograd.grad` of its output, less the
    same SDPA forward alone (it records what its backward needs)."""
    import torch
    import torch.nn.functional as F

    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def fwd():
        return F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                              enable_gqa=True)

    fwd_ms = graph_ms(fwd)
    both_ms = graph_ms(lambda: torch.autograd.grad(fwd(), leaves, do))
    return both_ms - fwd_ms, fwd_ms


# the flash backward's small cases, each in both dtypes at B = 2: (H, KV,
# Sq, Sk, D, causal, window); G = 7 and 8 run bf16 clusters of 7 and 8
BWD_SMALL = ((8, 2, 100, 100, 64, True, 0), (8, 2, 100, 100, 64, True, 48),
             (4, 1, 130, 130, 128, True, 0), (4, 4, 77, 77, 80, True, 16),
             (4, 4, 77, 77, 96, True, 0), (2, 2, 40, 40, 16, True, 0),
             (4, 2, 33, 33, 32, True, 8), (8, 8, 37, 150, 64, False, 0),
             (8, 2, 150, 37, 64, False, 0), (4, 4, 100, 100, 128, False, 0),
             (7, 1, 70, 70, 64, True, 0), (14, 2, 90, 90, 128, True, 24),
             (7, 1, 130, 50, 96, False, 0), (8, 1, 100, 100, 80, True, 0),
             (16, 2, 75, 75, 64, True, 32), (8, 1, 50, 130, 32, False, 0))
# and in bf16 alone: a causal window with Sq > Sk, whose dq blocks from
# row 128 on see no key tile (a block with no step still waits for its q
# and dO copies).  Rows from Sk + window - 1 on see no key: there the
# plain `ref.attention` averages every value while the flash forward
# writes 0, as `repro`'s `xla_flash` does, so float32's check of the
# forward's output would hold the kernel to the plain version's average.
BWD_SMALL_BF16 = ((4, 2, 300, 50, 64, True, 10),)
# BWD_SHAPES rows whose parts (prep, dq, dkdv) and launch plans are timed
BWD_PARTS = ("yi-9b train", "zamba2-2.7b train", "train-100m")


def _bwd_plan_str(p) -> str:
    return (f"dq {p.dq_rows} rows x {p.dq_keys} keys, grid {p.dq_grid}; "
            f"dkdv {p.kv_keys} keys x {p.kv_rows} rows"
            + (f", {p.stages} stages" if p.stages else "")
            + f", {p.heads} heads a block, cluster {p.cluster}, grid "
            f"{p.kv_grid}")


def check_flash_bwd(rec):
    """The flash backward against `ref.attention_bwd` at the training
    shapes (and windowed, ragged and GQA cases at small sizes, G = 7 and 8
    among them), from the forward's own output and log-sum-exp, which is
    held against `ref.attention_fwd` first; every case called twice and
    equal bit for bit; timed warm and cold beside its bound, the plain
    version and SDPA's backward, and at `BWD_PARTS` each part (prep, dq,
    dkdv) alone and every launch plan the rule weighs; each bf16 small
    case also under every dq variant (`_check_dq_variants`)."""
    import torch

    from repro_torch.kernels import cost, ref
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)

    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    err = 0.0
    held = {f"D {D}, {fmod.DQ_ROWS[nc]} rows, {fmod.bwd_dq_tiles(D, nc)[1]} "
            f"stages": fmod.bwd_dq_blocks(0, D, fmod.DQ_ROWS[nc])
            for D in fmod.HEAD_DIMS for nc in sorted(fmod.DQ_ROWS)}
    rec["bwd_dq_blocks"] = held
    log("  flash_attention_bwd dq blocks an SM "
        "(cudaOccupancyMaxActiveBlocksPerMultiprocessor): "
        + "; ".join(f"{k}: {n}" for k, n in held.items()))
    small = [(f"small G={H // KV} Sq={Sq} Sk={Sk} window={w}", dt, 2, H, KV,
              Sq, Sk, D, c, w)
             for dt in ("bfloat16", "float32")
             for H, KV, Sq, Sk, D, c, w in BWD_SMALL] + [
        (f"small G={H // KV} Sq={Sq} Sk={Sk} window={w}", "bfloat16", 2, H,
         KV, Sq, Sk, D, c, w) for H, KV, Sq, Sk, D, c, w in BWD_SMALL_BF16]
    cases = [c + (0,) for c in BWD_SHAPES] + small
    for label, dts, B, H, KV, Sq, Sk, D, causal, window in cases:
        dt = getattr(torch, dts)
        tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        mask = dict(causal=causal, window=window)

        def rn(*shape):
            return torch.randn(*shape, generator=g, device="cuda").to(dt)

        q, k, v, do = rn(B, H, Sq, D), rn(B, KV, Sk, D), rn(B, KV, Sk, D), \
            rn(B, H, Sq, D)
        o, lse = flash_attention(q, k, v, return_lse=True, **mask)
        torch.cuda.synchronize()
        want_o, want_lse = ref.attention_fwd(q, k, v, **mask)
        check_close("flash_attention lse", lse, want_lse, F32_TOL)
        if dt == torch.float32:  # float32 forwards: the output as well
            err = max(err, check_close("flash_attention", o, want_o, tol))
            err = max(err, _check_f32_tiled(label, q, k, v, o, lse, **mask))
        del want_o
        got = flash_attention_bwd(q, k, v, o, lse, do, **mask)
        again = flash_attention_bwd(q, k, v, o, lse, do, **mask)
        torch.cuda.synchronize()
        for name, a, b in zip(("dq", "dk", "dv"), got, again):
            if not torch.equal(a, b):
                raise AssertionError(f"flash_attention_bwd {label}: two "
                                     f"calls gave different {name}")
        del again
        want = ref.attention_bwd(q, k, v, o, lse, do, **mask)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            err = max(err, check_close(f"flash_attention_bwd {name}", a, b,
                                       tol))
        if label.startswith("small") and dt == torch.bfloat16:
            err = max(err, _check_dq_variants(fmod, label, q, k, v, o, lse,
                                              do, want, mask, sms))
        shape = f"({B},{H},{Sq},{D}) kv {KV}" + (f" Sk {Sk}" if Sk != Sq
                                                  else "")
        plan = fmod.bwd_plan(B, H, KV, Sq, Sk, D, causal, q.element_size(),
                             sms)
        if plan.cluster > 1:  # bf16: what the card holds of its clusters
            held = fmod.bwd_max_clusters(0, D, plan)
            rec.setdefault("bwd_max_clusters", {})[
                f"D {D}, {_bwd_plan_str(plan)}"] = held
            log(f"  flash_attention_bwd dkdv clusters of {plan.cluster} "
                f"at D {D}, {plan.kv_keys} keys, {plan.stages} stages: "
                f"{held} at once (cudaOccupancyMaxActiveClusters)")
        log(f"  flash_attention_bwd {label} {dts} {shape} causal={causal} "
            f"({_bwd_plan_str(plan)}): lse "
            f"{err_str(lse, want_lse, F32_TOL)}; "
            + "; ".join(f"{n} {err_str(a, b, tol)}"
                        for n, a, b in zip(("dq", "dk", "dv"), got, want)))
        if not label.startswith("small"):
            _time_bwd_plans(rec, fmod, label, shape, q, k, v, o, lse, do,
                            want, tol, sms, causal, label in BWD_PARTS)
        del want
        if label.startswith("small"):
            continue
        if not label.startswith("zoo"):  # check_flash times the zoo's
            # the training form of the forward, too
            _time_flash(rec, f"{label} {shape}", q, k, v, lse=True,
                        causal=causal)
        ms = graph_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                  causal=causal))
        plain_ms = graph_ms(lambda: ref.attention_bwd(q, k, v, o, lse, do,
                                                      causal=causal),
                            calls=3)
        lib_ms, lib_fwd_ms = _sdpa_bwd_ms(q, k, v, do, causal)
        cold = cold_inputs(q, k, v, o, lse, do)
        cold_ms = graph_ms(lambda *a: flash_attention_bwd(*a, causal=causal),
                           inputs=cold)
        del cold
        nbytes, ops = cost.flash_bwd_work(B, H, k.shape[1], Sq, Sk, D,
                                          q.element_size(), causal)
        b_ms, b_by = bound(nbytes, ops,
                           BF16_OPS if dt == torch.bfloat16 else F32_OPS)
        case = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms, library_fwd_ms=lib_fwd_ms,
                    cold_ms=cold_ms, tol=tol)
        rec.setdefault("timing_cases", {})[
            f"flash_attention_bwd {label} {shape}"] = case
        if "flash_attention_bwd" not in rec["kernels"]:
            rec["kernels"]["flash_attention_bwd"] = case  # yi-9b heads
        log(f"  flash_attention_bwd {label} {shape} "
            f"{'causal' if causal else 'non-causal'}: kernel {ms:.4f} ms "
            f"(cold L2 {cold_ms:.4f}), plain {plain_ms:.4f} ms, SDPA "
            f"backward {lib_ms:.4f} ms (its forward + backward less its "
            f"forward {lib_fwd_ms:.4f}), bound {b_ms:.6f} ms ({b_by})")
    rec["kernels"]["flash_attention_bwd"]["max_abs_err"] = err
    log(f"flash_attention_bwd: ok, max abs err {err:.3g}")


def _check_dq_variants(fmod, label, q, k, v, o, lse, do, want, mask, sms):
    """A small bf16 case under every plan `bwd_plans` weighs whose dq part
    differs from the chosen one's (the other dq variants: one or two
    consumer warpgroups), held against ``want`` within `BF16_TOL` and
    called twice, equal bit for bit; -> the largest error."""
    import torch

    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    plans = fmod.bwd_plans(B, H, KV, Sq, Sk, D, mask["causal"],
                           q.element_size(), sms)
    err = 0.0
    for plan in plans[1:]:
        if plan.dq_rows == plans[0].dq_rows:
            continue
        got = fmod._launch_bwd(q, k, v, o, lse, do, plan=plan, **mask)[:3]
        again = fmod._launch_bwd(q, k, v, o, lse, do, plan=plan, **mask)[:3]
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd {label} "
                                 f"({_bwd_plan_str(plan)}): two calls "
                                 f"differ")
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            err = max(err, check_close(f"flash_attention_bwd {name}", a, b,
                                       BF16_TOL))
        log(f"  flash_attention_bwd {label} dq {plan.dq_rows} rows: dq "
            f"{err_str(got[0], want[0], BF16_TOL)}")
    return err


def _time_bwd_plans(rec, fmod, label, shape, q, k, v, o, lse, do, want,
                    tol, sms, causal, parts):
    """At a training shape: every launch plan `bwd_plans` lists, held
    against ``want`` and timed whole, then with ``parts`` the chosen
    plan's parts alone (prep; dq and dkdv from the prep's D) and, in
    bf16, each dq variant's dq part alone, each by `graph_ms`."""
    import torch

    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    plans = fmod.bwd_plans(B, H, KV, Sq, Sk, D, causal, q.element_size(),
                           sms)
    times = {}
    for i, plan in enumerate(plans):
        out = fmod._launch_bwd(q, k, v, o, lse, do, causal, 0, plan)
        torch.cuda.synchronize()
        for name, a, b in zip(("dq", "dk", "dv"), out, want):
            check_close(f"flash_attention_bwd {name}", a, b, tol)
        del out
        times[_bwd_plan_str(plan)] = ms = graph_ms(
            lambda: fmod._launch_bwd(q, k, v, o, lse, do, causal, 0, plan))
        log(f"  flash_attention_bwd {label} {shape} plan "
            f"{'(chosen) ' if i == 0 else ''}{_bwd_plan_str(plan)}: "
            f"{ms:.4f} ms")
    case = rec.setdefault("timing_cases", {})[
        f"flash_attention_bwd plans {label} {shape}"] = dict(plans=times)
    if not parts:
        return
    plan = plans[0]
    delta = fmod._launch_bwd(q, k, v, o, lse, do, causal, 0, plan,
                             parts=fmod.PARTS["prep"])[3]
    case["parts"] = {name: graph_ms(lambda: fmod._launch_bwd(
        q, k, v, o, lse, do, causal, 0, plan, parts=bits, delta=delta))
        for name, bits in fmod.PARTS.items()}
    log(f"  flash_attention_bwd {label} {shape} parts: "
        + ", ".join(f"{n} {t:.4f} ms" for n, t in case["parts"].items()))
    if q.element_size() != 2:  # float32: one dq kernel a tile, no variants
        return
    case["dq"] = {}
    for p in plans:
        name = f"{p.dq_rows} rows"
        if name in case["dq"]:
            continue
        case["dq"][name] = graph_ms(lambda: fmod._launch_bwd(
            q, k, v, o, lse, do, causal, 0, p, parts=fmod.PARTS["dq"],
            delta=delta))
        log(f"  flash_attention_bwd {label} {shape} dq {name}: "
            f"{case['dq'][name]:.4f} ms")


def _plan_str(p) -> str:
    return (f"clusters of {p.cluster}, {p.slices} column slices, {p.hc} "
            f"heads a block, {p.stages} stages")


def _decode_plans(dmod, B, KV, G, S, D, sms, dtype):
    """Every plan `decode_plans` weighs at these shapes on this card, the
    chosen one first, with the clusters of each the card holds at once
    (`cudaOccupancyMaxActiveClusters`, 0 for a cluster of one)."""
    import torch

    isz = torch.empty((), dtype=dtype).element_size()
    plans = dmod.decode_plans(
        B, KV, G, S, D, sms, isz,
        max_clusters=lambda p: dmod.max_clusters(0, D, G, dtype, p))
    return [(p, dmod.max_clusters(0, D, G, dtype, p) if p.cluster > 1 else 0)
            for p in plans]


def _replays_equal(kernel, q, k, v):
    """Two replays of one captured graph of ``kernel`` give outputs equal
    bit for bit: the cluster merge sums in rank order, with no atomic."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernel(q, k, v)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = kernel(q, k, v)
    g.replay()
    first = out.clone()
    g.replay()
    torch.cuda.synchronize()
    if not torch.equal(first, out):
        raise AssertionError("decode_attention: two replays of one graph "
                             "differ")
    log("  decode_attention: two graph replays equal bit for bit")


def check_decode(rec):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cost, ref
    from repro_torch.kernels import decode_attention as dmod
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
        p, fit = _decode_plans(dmod, q.shape[0], kc.shape[1],
                               q.shape[1] // kc.shape[1], kc.shape[2],
                               q.shape[2], sms, q.dtype)[0]
        log(f"  decode_attention {label} {str(q.dtype)[6:]} q "
            f"{tuple(q.shape)} kv {kc.shape[1]} S={kc.shape[2]} window={w}"
            f" ({_plan_str(p)}, {fit} such clusters fit): "
            f"{err_str(out, want, tol)}")
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
        # the cluster merge: G = 16 and 32 (and 64, two head chunks of
        # 32) at lengths 1, 33 and S, where most ranks are empty
        for H, KV in ((32, 2), (32, 1), (64, 1)):
            q, kc, vc = rn(3, H, 128, dt=dt), rn(3, KV, S, 128, dt=dt), \
                rn(3, KV, S, 128, dt=dt)
            lens = torch.tensor([1, 33, S], dtype=torch.int32, device="cuda")
            for w in (0, 48):
                err = max(err, check(f"G={H // KV} lens=(1,33,{S})", q, kc,
                                     vc, lens, w, tol)[0])
        # the zoo's head dims (its engines decode in float32)
        for arch, (H, KV, D) in ZOO_ATTN.items():
            q, kc, vc = rn(2, H, D, dt=dt), rn(2, KV, 48, D, dt=dt), \
                rn(2, KV, 48, D, dt=dt)
            lens = torch.tensor([17, 24], dtype=torch.int32, device="cuda")
            err = max(err, check(arch, q, kc, vc, lens, 0, tol)[0])
        # a cache of one tile: a cluster of one, no merge
        H, KV, D, _ = ATTN_SHAPES["zamba2-2.7b"]
        q, kc, vc = rn(2, H, D, dt=dt), rn(2, KV, 32, D, dt=dt), \
            rn(2, KV, 32, D, dt=dt)
        lens = torch.tensor([20, 32], dtype=torch.int32, device="cuda")
        for w in (0, 8):
            e, p = check("one tile", q, kc, vc, lens, w, tol)
            assert p.cluster == 1, p
            err = max(err, e)

    # timed at every serving shape: batch 1 at a 448-token prompt's
    # cache, then llava's image cache, whisper's self attention at B = 4
    # and its cross attention over a full cache (every length = capacity),
    # then the zoo's float32 decode (ZOO_DECODE)
    bf16 = torch.bfloat16
    timed = [(arch, 1, H, KV, D, S, L, window, bf16)
             for arch, (H, KV, D, window) in ATTN_SHAPES.items()]
    timed += [c + (0, bf16) for c in MEDIA_DECODE]
    timed += [(arch, 1, H, KV, D, ZOO_DECODE[0], ZOO_DECODE[1], 0,
               torch.float32) for arch, (H, KV, D) in ZOO_ATTN.items()]
    for arch, B, H, KV, D, Sc, Lc, window, dt in timed:
        tol = BF16_TOL if dt == bf16 else F32_TOL
        q1 = rn(B, H, D, dt=dt)
        k1 = rn(B, KV, Sc, D, dt=dt)
        v1 = rn(B, KV, Sc, D, dt=dt)
        isz = q1.element_size()
        l1 = torch.full((B,), Lc, dtype=torch.int32, device="cuda")
        mask = (torch.arange(Sc, device="cuda") < Lc)[None, None, None, :]
        want = ref.decode_attention(q1, k1, v1, l1, window=window)

        def kernel(q, k, v):
            return decode_attention(q, k, v, l1, window=window)

        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)

        # every plan the rule weighs, each held against the plain version
        # and timed, for the record of the choice
        plans, chosen = [], None
        for p, fit in _decode_plans(dmod, B, KV, H // KV, Sc, D, sms, dt):
            chosen = chosen or p
            out = dmod._launch(q1, k1, v1, l1, window, p)
            e = check_close("decode_attention", out, want, tol)
            p_ms = graph_ms(lambda p=p: dmod._launch(q1, k1, v1, l1, window,
                                                     p))
            plans.append(dict(plan=p._asdict(), ms=p_ms, max_abs_err=e,
                              clusters_fit=fit))
            log(f"    plan {_plan_str(p)} ({fit} such clusters fit): "
                f"{p_ms:.4f} ms, max abs err {e:.3g}"
                f"{' (chosen)' if p is chosen else ''}")
        err = max(err, check_close("decode_attention", kernel(q1, k1, v1),
                                   want, tol))
        ms = graph_ms(lambda: kernel(q1, k1, v1))
        plain_ms = graph_ms(lambda: ref.decode_attention(q1, k1, v1, l1,
                                                         window=window))
        lib_ms = graph_ms(lambda: sdpa(q1, k1, v1))
        cold = cold_inputs(q1, k1, v1)
        cold_ms = graph_ms(kernel, inputs=cold)
        lib_cold_ms = graph_ms(sdpa, inputs=cold)
        err = max(err, check_close("decode_attention", kernel(*cold[-1]),
                                   want, tol))
        del cold
        nbytes, ops = cost.decode_work(B, H, KV, D, Lc, isz)
        b_ms, b_by = bound(nbytes, ops, BF16_OPS if dt == bf16 else F32_OPS)
        case = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms, cold_ms=cold_ms,
                    library_cold_ms=lib_cold_ms, plans=plans, tol=tol)
        label = (f"decode_attention {arch} {str(dt)[6:]} ({B},{H},{D}) kv "
                 f"{KV} cache {Sc} len {Lc} window {window}")
        rec.setdefault("timing_cases", {})[label] = case
        if arch == "yi-9b":
            rec["kernels"]["decode_attention"] = case
        if arch == MEDIA_DECODE[0][0]:
            _replays_equal(kernel, q1, k1, v1)
        log(f"  {label} ({_plan_str(chosen)}): kernel "
            f"{ms:.4f} ms (cold L2 {cold_ms:.4f}), plain {plain_ms:.4f} ms, "
            f"SDPA {lib_ms:.4f} ms (cold L2 {lib_cold_ms:.4f}), bound "
            f"{b_ms:.6f} ms ({b_by})")
    rec["kernels"]["decode_attention"]["max_abs_err"] = err
    log(f"decode_attention: ok, max abs err {err:.3g}")


def check_rms_norm(rec):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cost, ref
    from repro_torch.kernels.rmsnorm import rms_norm

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    err = 0.0
    # yi-9b rows (4096), the mamba2 / zamba2 block norms (2048, 2560) and
    # their gated norms (4096, 5120), mistral-nemo-12b's (5120), qwen2-72b's
    # (8192), minicpm3-4b's (2560) and its MLA norms (q 768, kv 256),
    # granite-moe's (1024) and arctic's and llava's (7168), whisper's (512)
    # and a width that is no multiple of a 16-byte vector (100: element by
    # element); bf16 is timed at one row (decode) at every serving width,
    # at 448 rows (prefill) at yi-9b's and the MoE engines', and at
    # whisper's encoder (4 x 1500 rows) and decode (4 rows) at B = 4
    timed_rows = {(PROMPT, 4096), (PROMPT, 1024), (PROMPT, 7168),
                  (6000, 512), (4, 512)}
    cases = [(dt, tol, rows, D)
             for dt, tol in ((torch.bfloat16, BF16_TOL),
                             (torch.float32, F32_TOL))
             for D, rows_list in [(D, (PROMPT, 1)) for D in (
                 4096, 2048, 2560, 5120, 8192, 768, 256, 1024, 7168, 100)]
             + [(512, (6000, PROMPT + 64, 4, 1))]
             for rows in rows_list]
    for dt, tol, rows, D in cases:
        x = (3 * torch.randn(rows, D, generator=g, device="cuda")).to(dt)
        s = torch.rand(D, generator=g, device="cuda") + 0.5
        out = rms_norm(x, s)
        torch.cuda.synchronize()
        want = ref.rms_norm(x, s)
        err = max(err, check_close("rms_norm", out, want, tol))
        log(f"  rms_norm {str(dt)[6:]} ({rows},{D}): "
            f"{err_str(out, want, tol)}")
        f32_timed = dt == torch.float32 and (rows, D) == (512, 512)
        if not f32_timed and (dt != torch.bfloat16 or D == 100 or (
                rows != 1 and (rows, D) not in timed_rows)):
            continue
        sb = s.to(dt)
        ms = graph_ms(lambda: rms_norm(x, s))
        plain_ms = graph_ms(lambda: ref.rms_norm(x, s))
        lib_ms = graph_ms(lambda: F.rms_norm(x, (D,), sb, 1e-6))
        b_ms, b_by = bound(*cost.rms_norm_work(rows, D, x.element_size()),
                           F32_OPS)
        case = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib_ms, tol=tol)
        key = f"rms_norm ({rows},{D})" + (" float32" if f32_timed else "")
        rec.setdefault("timing_cases", {})[key] = case
        if rows == PROMPT and D == 4096:
            rec["kernels"]["rms_norm"] = case
        log(f"  rms_norm ({rows},{D}) {str(dt)[6:]}: kernel {ms:.4f} ms, "
            f"plain "
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


def _time_ssd_train(rec, g, arch, c, Hn, P, N) -> float:
    """The training form of the SSD scan (train-ssm / train-hybrid's
    forward): bf16 x (1, S, Hn, P) at the training sequence, no final
    state, held against the plain version and timed warm and cold beside
    it and its bound; returns the max abs error."""
    import torch

    from repro_torch.kernels import cost, ref
    from repro_torch.kernels.ssd_scan import ssd_scan

    path = "train-ssm" if arch == SSM_ENGINES["engine-a"] else "train-hybrid"
    S = TRAIN_PATHS[path][2][1]
    x, dt, A, Bm, Cm, _ = _ssd_inputs(g, S, Hn, P, N, torch.bfloat16, False)
    want = ref.ssd_scan_chunked(x, dt, A, Bm, Cm, chunk=c.chunk)

    def kernel(*a):
        return ssd_scan(*a, chunk=c.chunk)

    err = check_close("ssd_scan y", kernel(x, dt, A, Bm, Cm), want, BF16_TOL)
    ms = graph_ms(lambda: kernel(x, dt, A, Bm, Cm))
    plain_ms = graph_ms(lambda: ref.ssd_scan_chunked(x, dt, A, Bm, Cm,
                                                     chunk=c.chunk))
    cold = cold_inputs(x, dt, A, Bm, Cm)
    cold_ms = graph_ms(kernel, inputs=cold)
    err = max(err, check_close("ssd_scan y", kernel(*cold[-1]), want,
                               BF16_TOL))
    del cold
    work = cost.ssd_work(S, Hn, P, N, c.chunk, final=False)
    b_ms, b_by = bound(*work, BF16_OPS)
    f32_ms, f32_by = bound(*work, F32_OPS)
    rec.setdefault("timing_cases", {})[
        f"ssd_scan {arch} train x (1,{S},{Hn},{P}) N {N}"] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        bound_f32_ms=f32_ms, bound_f32_by=f32_by, library_ms=None,
        cold_ms=cold_ms, tol=BF16_TOL, max_abs_err=err)
    log(f"  ssd_scan {arch} training form x (1,{S},{Hn},{P}) N {N} bf16, no "
        f"final state ({path}): kernel {ms:.4f} ms (cold L2 {cold_ms:.4f}), "
        f"plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}; at the "
        f"float32 peak {f32_ms:.6f}, {f32_by}), max abs err {err:.3g}, no "
        f"single PyTorch call")
    return err


def check_ssd_scan(rec):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import cost, ref
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
        work = cost.ssd_work(PROMPT, Hn, P, N, c.chunk)
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
        err = max(err, _time_ssd_train(rec, g, arch, c, Hn, P, N))
    rec["kernels"]["ssd_scan"]["max_abs_err"] = err
    log(f"ssd_scan: ok, max abs err {err:.3g}")


def check_autograd(rec):
    """A gradient through each autograd `Function` of `kernels.ops` (the
    kernel forward, and for attention the backward kernel) against
    autograd through the plain version, at the training shapes: Yi-9B's
    attention, its RMSNorm rows, Mamba2's SSD scan.  The RMSNorm and SSD
    backwards recompute the plain version, so their gradients must agree
    to float32 rounding; attention's plain path rounds its probabilities
    to bf16, so its gradients agree within BF16_TOL."""
    import torch

    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(SEED + 6)

    def rn(*shape, dt=torch.bfloat16, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device="cuda")).to(
            dt).requires_grad_(True)

    def grads(fn, leaves, w):
        out = fn(*leaves)
        out = out if isinstance(out, tuple) else (out,)
        loss = sum((o.float() * wi).sum() for o, wi in zip(out, w))
        return out, torch.autograd.grad(loss, leaves)

    def compare(name, fn, plain, leaves, tols):
        out = fn(*leaves)
        out = out if isinstance(out, tuple) else (out,)
        w = [torch.randn(o.shape, generator=g, device="cuda") for o in out]
        got_o, got = grads(fn, leaves, w)
        want_o, want = grads(plain, leaves, w)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(got, want)):
            check_close(f"{name} grad {i}", a, b, tols[i])
        log(f"  autograd {name}: "
            + "; ".join(f"d{i} {err_str(a, b, tols[i])}"
                        for i, (a, b) in enumerate(zip(got, want))))

    q, k, v = rn(2, 32, 2048, 128), rn(2, 4, 2048, 128), rn(2, 4, 2048, 128)
    compare("attention yi-9b (2,32,2048,128) kv 4",
            lambda q, k, v: ops.attention(q, k, v, causal=True),
            lambda q, k, v: ref.attention(q, k, v, causal=True), (q, k, v),
            (BF16_TOL,) * 3)
    del q, k, v
    x, s = rn(2 * 2048, 4096, scale=3.0), rn(4096, dt=torch.float32)
    compare("rms_norm (4096,4096)", ops.rms_norm, ref.rms_norm, (x, s),
            (BF16_TOL, F32_TOL))
    del x, s
    S, Hn, P, N = 2048, 64, 64, 128
    x, Bm, Cm = rn(1, S, Hn, P), rn(1, S, N), rn(1, S, N)
    dt = torch.nn.functional.softplus(torch.randn(
        1, S, Hn, generator=g, device="cuda")).requires_grad_(True)
    A = (-torch.linspace(1.0, 16.0, Hn, device="cuda")).requires_grad_(True)
    compare("ssd_scan mamba2 (1,2048,64,64) N 128",
            lambda *a: ops.ssd_scan(*a, chunk=256, return_state=True),
            lambda *a: ref.ssd_scan_chunked(*a, chunk=256, return_state=True),
            (x, dt, A, Bm, Cm), (F32_TOL,) * 5)


def phase_kernels(args, rec):
    rec["kernels"] = {}
    for check in (check_trie_plan, check_flash, check_flash_bwd, check_decode,
                  check_rms_norm, check_ssd_scan, check_autograd):
        t0 = time.perf_counter()
        check(rec)
        log(f"{check.__name__}: {time.perf_counter() - t0:.1f} s")
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


# copies of `csrc/flash_attention.cu` with FLASH_VARIANT bits of its
# `FlashVariant`, each taking a part out of the bf16 forward (or, bit 8,
# the turns two consumer warpgroups take)
FLASH_PARTS = {
    "whole kernel": (),
    "no softmax (P = S)": ("FLASH_VARIANT=1",),
    "no P.V products": ("FLASH_VARIANT=2",),
    "no Q.K^T products": ("FLASH_VARIANT=4",),
    "copies and barriers only": ("FLASH_VARIANT=7",),
    "no ping-pong (two consumers issue in any order)": ("FLASH_VARIANT=8",),
}
# the forward's shapes its parts are timed at: (label, B, H, KV, S, D)
FLASH_PART_SHAPES = (("llava-next-34b image prefill", 1, 56, 8, 3328, 128),
                     ("yi-9b train", 2, 32, 4, 2048, 128),
                     ("yi-9b serve", 1, 32, 4, PROMPT, 128))


def _flash_parts(rec):
    """Time copies of the bf16 flash forward with parts taken out
    (`FLASH_PARTS`) at `FLASH_PART_SHAPES`, causal, every plan
    `fwd_plans` weighs, as `_time_flash` times the kernel."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fmod

    t0 = time.perf_counter()
    copies = {name: _build.extension(defines=d)
              for name, d in FLASH_PARTS.items()}
    log(f"parts: {len(copies)} flash copies built in "
        f"{time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, B, H, KV, S, D in FLASH_PART_SHAPES:
        q = torch.randn(B, H, S, D, generator=g, device="cuda").bfloat16()
        k = torch.randn(B, KV, S, D, generator=g, device="cuda").bfloat16()
        v = torch.randn(B, KV, S, D, generator=g, device="cuda").bfloat16()
        o = torch.empty_like(q)
        for plan in fmod.fwd_plans(B, H, KV, S, S, D, True, 2, sms):
            for name, ext in copies.items():
                def call(ext=ext, plan=plan):
                    ext.flash_attention(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), 0, B, H, KV, S, S, D, D ** -0.5, 1, 0,
                        fmod.DTYPES[torch.bfloat16], plan.rows, plan.keys,
                        torch.cuda.current_stream().cuda_stream)

                us = 1e3 * graph_ms(call)
                rec.setdefault("parts", {})[
                    f"flash {label} {plan.rows} rows {name}"] = us
                log(f"  flash_attention parts {label} ({B},{H},{S},{D}) kv "
                    f"{KV}, {plan.rows} rows a block, {name}: {us:.2f} us")


# copies of `csrc/decode_attention.cu` with DECODE_VARIANT bits: 1 keeps
# the TMA ring and its barriers and takes the scores, softmax and P.V
# out, 2 takes the cluster merge out
DECODE_PARTS = {
    "whole kernel": (),
    "copies only": ("DECODE_VARIANT=1",),
    "no cluster merge": ("DECODE_VARIANT=2",),
}


def _decode_parts(rec):
    """Time copies of the decode kernel with parts taken out
    (`DECODE_PARTS`) at LLaVA's image cache (`MEDIA_DECODE`'s first row),
    every clustered plan `decode_plans` weighs, as `check_decode` times
    the kernel."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels.flash_attention import DTYPES

    t0 = time.perf_counter()
    copies = {name: _build.extension(defines=d)
              for name, d in DECODE_PARTS.items()}
    log(f"parts: {len(copies)} decode copies built in "
        f"{time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    label, B, H, KV, D, Sc, Lc = MEDIA_DECODE[0]
    bf16 = torch.bfloat16
    q = torch.randn(B, H, D, generator=g, device="cuda").to(bf16)
    k = torch.randn(B, KV, Sc, D, generator=g, device="cuda").to(bf16)
    v = torch.randn(B, KV, Sc, D, generator=g, device="cuda").to(bf16)
    lens = torch.full((B,), Lc, dtype=torch.int32, device="cuda")
    o = torch.empty_like(q)
    for plan, fit in _decode_plans(dmod, B, KV, H // KV, Sc, D, sms, bf16):
        if plan.cluster == 1:
            continue
        for name, ext in copies.items():
            def call(ext=ext, plan=plan):
                ext.decode_attention(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    lens.data_ptr(), o.data_ptr(), B, H, KV, Sc, D,
                    plan.cluster, plan.slices, plan.hc, plan.stages,
                    D ** -0.5, 0, DTYPES[bf16],
                    torch.cuda.current_stream().cuda_stream)

            us = 1e3 * graph_ms(call)
            rec.setdefault("parts", {})[
                f"decode {label} {_plan_str(plan)} {name}"] = us
            log(f"  decode_attention parts {label} ({_plan_str(plan)}, "
                f"{fit} such clusters fit) {name}: {us:.2f} us")


def phase_parts(args, rec):
    """Time copies of the decode kernel (`_decode_parts`) and of the bf16
    flash forward (`_flash_parts`), then of
    the bf16 SSD kernel at both serving shapes (S 448,
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

    _decode_parts(rec)
    _flash_parts(rec)
    t0 = time.perf_counter()
    copies = {name: _build.extension(defines=d)
              for name, d in {**SSD_PARTS, **SSD_ALTERNATIVES}.items()}
    log(f"parts: {len(copies)} copies built in "
        f"{time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rec.setdefault("parts", {})
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


def _float32_copy(model):
    """A float32 copy of the serving model ``model`` on the CPU."""
    import torch

    from repro_torch.models import build_model

    cpu = build_model(dataclasses.replace(model.cfg, dtype="float32"),
                      device="cpu")
    with torch.no_grad():  # bf16 crosses over and widens on the host
        for (n, p), (_, q) in zip(cpu.named_parameters(),
                                  model.named_parameters()):
            p.copy_(q.cpu())
    return cpu


def _rel(a, b) -> float:
    """Relative L2 error of ``a`` (any device) against ``b`` (CPU)."""
    a = a.float().cpu()
    if not bool(a.isfinite().all()):
        return float("inf")
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _model_check(model, rec, label, prompt_len, patches: int = 0,
                 steps: int = 2):
    """The bf16 engine ``model`` with its kernels against a float32 copy of
    it on the CPU (plain versions): prefill logits of a ragged prompt (a
    VLM's after ``patches`` random patch embeddings) and ``steps`` decode
    steps, each fed the card's greedy token, relative L2 error within
    MODEL_REL_TOL."""
    import torch

    cpu = _float32_copy(model)
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab,
                                         (1, prompt_len)))
    pe = None
    if patches:
        pe = torch.from_numpy(rng.standard_normal(
            (1, patches, model.cfg.vlm.patch_dim)).astype(np.float32))
    lg, cache = model.prefill(toks.cuda(), *(() if pe is None else
                                             (pe.cuda(),)))
    lc, ccache = cpu.prefill(toks, *(() if pe is None else (pe,)))
    errs = []
    for step in range(steps + 1):
        errs.append(_rel(lg, lc))
        if errs[-1] > MODEL_REL_TOL:
            raise AssertionError(f"{label} logits off their float32 CPU copy:"
                                 f" rel err {errs}")
        if step == steps:
            break
        nxt = lg.argmax(-1)
        lg, cache = model.decode_step(cache, nxt)
        lc, ccache = cpu.decode_step(ccache, nxt.cpu())
    rec.setdefault("model_rel_err", {})[label] = errs
    what = f"{patches} patches + " if patches else ""
    log(f"  {label} vs float32 CPU copy (prefill {what}{prompt_len} tokens, "
        f"{steps} decode steps): relative L2 err "
        f"{', '.join(f'{e:.3g}' for e in errs)} (tol {MODEL_REL_TOL})")


def _encdec_check(model, rec, label, B: int, prompt_len: int, steps: int):
    """The bf16 encoder-decoder ``model`` against its float32 copy on the
    CPU: the encoder's output over B x T random frames, the prefill
    logits of a B x prompt_len prompt, ``steps`` decode steps fed the
    card's greedy tokens, and then the caches ``k``, ``v``, ``xk``,
    ``xv``, each within MODEL_REL_TOL, relative L2."""
    import torch

    cpu = _float32_copy(model)
    cfg = model.cfg
    rng = np.random.default_rng(SEED + 3)
    frames = torch.from_numpy(rng.standard_normal(
        (B, cfg.encdec.encoder_len, cfg.d_model)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, prompt_len)))
    errs = {"encode": _rel(model.encode(frames.cuda()), cpu.encode(frames))}
    lg, cache = model.prefill(frames.cuda(), toks.cuda())
    lc, ccache = cpu.prefill(frames, toks)
    errs["logits"] = [_rel(lg, lc)]
    for _ in range(steps):
        nxt = lg.argmax(-1)
        lg, cache = model.decode_step(cache, nxt)
        lc, ccache = cpu.decode_step(ccache, nxt.cpu())
        errs["logits"].append(_rel(lg, lc))
    for n in ("k", "v", "xk", "xv"):
        errs[n] = _rel(getattr(cache, n), getattr(ccache, n))
    worst = max(errs["encode"], *errs["logits"],
                *(errs[n] for n in ("k", "v", "xk", "xv")))
    rec.setdefault("model_rel_err", {})[label] = errs
    log(f"  {label} vs float32 CPU copy (B {B}, {cfg.encdec.encoder_len} "
        f"frames, prompt {prompt_len}, {steps} decode steps): relative L2 "
        f"err encode {errs['encode']:.3g}, logits "
        f"{', '.join(f'{e:.3g}' for e in errs['logits'])}, caches "
        + ", ".join(f"{n} {errs[n]:.3g}" for n in ("k", "v", "xk", "xv"))
        + f" (tol {MODEL_REL_TOL})")
    if not worst <= MODEL_REL_TOL:
        raise AssertionError(f"{label} off its float32 CPU copy: {errs}")


def _reduced_copy(model, n_layers, n_experts=None):
    """A model of ``model``'s config at ``n_layers`` holding its first
    ``n_layers`` layers' weights (and every shared weight) and, with
    ``n_experts``, only the first experts of each MoE layer and their
    router columns, on the model's device."""
    import torch

    from repro_torch.models.transformer import Model

    cfg = dataclasses.replace(model.cfg, n_layers=n_layers)
    if n_experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=n_experts))
    small = Model(cfg, device=model.device)
    weights = model.state_dict()
    with torch.no_grad():
        for n, p in small.named_parameters():
            w = weights[n]
            if n_experts and n.endswith("mlp.router"):
                w = w[:, :n_experts]
            elif n_experts and n.endswith(("mlp.w1", "mlp.w3", "mlp.w2")):
                w = w[:n_experts]
            p.copy_(w)
    return small


def _kernel_family(name: str) -> str:
    """Our six kernels by name, cuBLAS's matmuls (``nvjet``/``gemv``/
    ``gemm``/``xmma`` kernels), and everything else."""
    low = name.lower()
    for key, fam in (("trie_plan", "trie_plan"),
                     ("flash_bwd", "flash_attention_bwd"),
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
    ``name`` under `torch.profiler` (see `_profile_call`)."""
    prompt = np.random.default_rng(SEED).integers(
        0, eng.model.cfg.vocab, (1, PROMPT))
    _profile_call(name, lambda: eng.generate(prompt, max_new=MAX_NEW), rec,
                  f"one generate ({PROMPT} + {MAX_NEW} tokens)")


def _profile_call(name, fn, rec, what):
    """``fn()`` once under `torch.profiler`: its device kernels summed by
    family against the profiled wall time (the profiler's own host cost
    included, so the busy share is a lower bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fam, by_name, n_ops = {}, {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n_ops += 1
            ms = e.time_range.elapsed_us() / 1e3
            f = _kernel_family(e.name)
            fam[f] = fam.get(f, 0.0) + ms
            by_name[e.name] = by_name.get(e.name, 0.0) + ms
    busy = sum(fam.values())
    rec.setdefault("profile", {})[name] = dict(
        wall_ms=wall_ms, device_ms=busy, by_family_ms=fam, device_ops=n_ops)
    log(f"  profile {name}: {what} wall {wall_ms:.1f} ms, device kernels "
        f"{busy:.1f} ms in {n_ops} device operations, busy share "
        f"{busy / wall_ms:.3f}")
    for f, ms in sorted(fam.items(), key=lambda kv: -kv[1]):
        log(f"    {f}: {ms:.2f} ms ({ms / busy:.3f} of device time)")
    for n, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"      {ms:8.2f} ms  {n[:90]}")


def _n_attn(cfg) -> int:
    """Attention applications of one pass of a decoder-only model: every
    layer of the dense, MoE and VLM families (GQA decoders; the MoE adds
    no kernel), each shared-block application of the hybrid, none for the
    SSM."""
    from repro_torch.models.transformer import attention_decoder

    if attention_decoder(cfg):
        return cfg.n_layers
    return cfg.n_layers // cfg.hybrid.attn_every \
        if cfg.family == "hybrid" else 0


def _expected_launches(cfg, invocations: int, max_new: int = MAX_NEW) -> dict:
    """Kernel launches of ``invocations`` stage invocations (a prefill and
    ``max_new`` decode steps each) on an engine of ``cfg``: per prefill, L
    flash launches (dense, MoE) or L SSD scans and L / attn_every flash
    launches (hybrid: its shared block); per decode step as many
    decode-attention launches, none for MLA (its absorbed decode has no
    kernel); 2L + 1 RMSNorms per prefill and per step (block norms, or
    block and gated norms, and the final norm) plus 2 per shared-block
    application and 2 a layer for MLA (its q and kv latent norms).  A VLM's
    patches add rows, not launches.  The encoder-decoder's invocation is
    an encode and a decoder prefill, then the steps: per prefill L_e + 2L
    flash launches (the encoder non-causal; each decoder layer's self
    attention causal and its cross attention non-causal) and 2L_e + 1 +
    3L + 1 RMSNorms (encoder layers and ``enc_norm``, decoder layers and
    the final norm); per step 2L decode-attention launches (self, and
    cross over the full encoder cache) and 3L + 1 RMSNorms."""
    L = cfg.n_layers
    if cfg.encdec is not None:
        Le = cfg.encdec.n_encoder_layers
        per_run = {"flash_attention": Le + 2 * L,
                   "decode_attention": 2 * L * max_new,
                   "rms_norm": 2 * Le + 1 + (3 * L + 1) * (1 + max_new),
                   "ssd_scan": 0}
        return {k: v * invocations for k, v in per_run.items()}
    attn = _n_attn(cfg)
    mla = cfg.attn_kind == "mla"
    norms = 2 * L + 1 + (2 * attn if cfg.family == "hybrid" else 0) + \
        (2 * L if mla else 0)
    per_run = {"flash_attention": attn,
               "decode_attention": 0 if mla else attn * max_new,
               "rms_norm": norms * (1 + max_new),
               "ssd_scan": L if cfg.family in ("ssm", "hybrid") else 0}
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
    `torch.profiler` (`_trace_one`), and, when phase serve-compiled ran,
    its cohort through the compiled engine (`_profile_call`)."""
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
    if ev is not None:
        C = ev["capacity"]
        planner = make_resident_planner(
            td, dataclasses.replace(obj, lat_cap=None), C,
            lat_cap=ev["lat_cap"])
        planner.update(np.arange(C), np.zeros(C, np.int32),
                       np.where(np.arange(C) % 2, -np.inf, 0.0),
                       np.zeros(C, np.float32))
        row = np.zeros(E, np.float32)
        planner.replan(row)  # the first replan runs outside the window
        _trace_one("one resident replan (events)",
                   lambda: planner.replan(row))
    if "compiled_cohort" in rec:
        # phase serve-compiled's cohort run: a long trace, so it comes
        # after the short ones (a short trace taken after it came back
        # without its kernel and copy)
        run, events = rec.pop("compiled_cohort")
        _profile_call("serve-compiled cohort", run, rec,
                      f"the compiled engine's {events} events on the card:")


def _replan_summary(rec):
    """The serve phases' replan wall time per fleet round, in µs."""
    rounds = [x for p in rec["paths"].values()
              for x in p.get("replan_s_per_round", ())]
    if not rounds:  # serve-media alone serves no cohort
        log("replan per fleet round: no serve phase of this run replans")
        return
    us = np.array(rounds) * 1e6
    rec["replan_us_per_round"] = dict(
        rounds=len(us), median=float(np.median(us)), min=float(us.min()),
        max=float(us.max()))
    log(f"replan per fleet round over the serve phases: median "
        f"{np.median(us):.1f} us (min {us.min():.1f}, max {us.max():.1f}) "
        f"over {len(us)} rounds")


def _cut(arch, layers: dict):
    """``arch``'s config, its depth cut to ``layers[arch]`` where given."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=layers[arch]) \
        if arch in layers else cfg


def _cut_str(layers: dict) -> str:
    """"arch n of N layers" for each depth cut of ``layers``."""
    from repro_torch.configs import get_config

    return ", ".join(f"{a} {n} of {get_config(a).n_layers} layers"
                     for a, n in layers.items())


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


def _events_setup(cohort, mean_service_s, timeout_k=None):
    """The knobs of phases serve-events and serve-compiled: Poisson
    arrivals (2 rps, seed 11) into 4 slots, the load-aware policy with
    concurrency-1 engines of the given mean service times, the
    feasibility gate, two priority classes (weight 2 with the objective's
    cap as its deadline, weight 1 with none) with preemption, one
    annotation swap (latency x 1.3) at the 8th arrival, the exploration
    lane, and an outage of engine-b inside the run, with the timeout model
    at ``timeout_k`` (the compiled engine refuses one)."""
    from repro_torch.core.faults import FaultSchedule
    from repro_torch.core.workload import SLOClass, poisson_arrivals
    from repro_torch.serving.loadsim import EngineLoadModel, FleetLoadModel

    tpl, trie, wl, ann, obj, reqs = cohort
    load = FleetLoadModel(
        engines={e: EngineLoadModel(e, concurrency=1, jitter=0.0)
                 for e in mean_service_s},
        mean_service_s=dict(mean_service_s))
    arrivals = poisson_arrivals(N_REQUESTS, rate=2.0, seed=11)
    # class deadlines replace the objective's cap, which is dropped so the
    # weight-1 class has none at all: its lanes reach the kernel at -inf
    specs = (SLOClass("interactive", deadline_s=obj.lat_cap, weight=2.0),
             SLOClass("batch", deadline_s=None, weight=1.0))
    faults = FaultSchedule(
        outages=(("engine-b", float(arrivals[3]), float(arrivals[10])),),
        timeout_k=timeout_k)
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
    served = rec["paths"]["yi-9b"]["engines"]
    missing = [e for e in engines if e not in served]
    if missing:
        raise AssertionError(f"phase serve made no stage invocation on "
                             f"{missing}: no service time to model")
    kw = _events_setup(cohort, {e: served[e]["stage_s"] for e in engines},
                       timeout_k=4.0)
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


# the compiled event engine's phase: epoch widths held identical, the
# replay's request count (on an H100 the replay runs ~90 events/s at ~2.5
# events a request: 1,000 requests took ~28 s a pass, the phase ~90 s;
# 250 requests take a quarter),
# the prefix held against the host loop, and the replay's load
COMPILED_EPOCHS = (1, 7)  # and n
REPLAY_REQUESTS = 250
REPLAY_PREFIX = 200
REPLAY_RATE = 6.0         # requests / virtual second into 64 slots
REPLAY_CAPACITY = 64
# the replan's lane forms in the compiled engine: (preset, lanes); width 1
# and a gathered subset held equal to the capacity-wide call
WIDTH_CASES = (("nl2sql_2", 4), ("mathqa_4", REPLAY_CAPACITY))


def _compiled_record(res, stats):
    """What two runs of the compiled engine or the host loop must share:
    every result field but the replan wall time, the timelines and the
    counts."""
    rec = _events_record(res, stats)
    rec.pop("stage_versions")  # the host loop's alone
    rec.update(success=[r.success for r in res],
               slo=[r.slo_violated for r in res],
               preempt_count=stats.preempt_count.tolist(),
               peak=dict(stats.peak_occupancy))
    return rec


def _check_plan_widths(rec):
    """The replan as the compiled engine makes it (all capacity lanes in
    one call) against width 1 lane by lane, as `repro`'s engine plans,
    and against a gathered subset of lanes, on the card at N 31 and N
    5461: identical targets and next models, and the plain blocked
    version's; then at N 5461 each form timed beside its plain version
    and bound."""
    import torch

    from repro_torch.kernels import cost
    from repro_torch.kernels.trie_plan import fleet_plan_blocked, trie_plan_cuda

    for name, lanes in WIDTH_CASES:
        c = _plan_case(name, lanes, seed=lanes + 7)
        obj = c["objs"][0]
        a, kw = _plan_args(c, obj, None)
        n_t = len(_plan_tensors(c))
        full = trie_plan_cuda(*a, **kw)
        want = fleet_plan_blocked(*a, **kw)
        if not all(torch.equal(x, y) for x, y in zip(full, want)):
            raise AssertionError(f"trie_plan {name} B={lanes}: capacity-wide "
                                 "!= plain blocked")

        def sub(idx):
            i = torch.as_tensor(idx, device="cuda")
            return (*a[:9], *(t[i].contiguous() for t in a[9:n_t]),
                    *a[n_t:])

        for i in range(lanes):
            one = trie_plan_cuda(*sub([i]), **kw)
            if int(one[0][0]) != int(full[0][i]) or \
                    int(one[1][0]) != int(full[1][i]):
                raise AssertionError(f"trie_plan {name}: lane {i} at width "
                                     "1 != the capacity-wide call")
        gath = list(range(0, lanes, 3))
        got = trie_plan_cuda(*sub(gath), **kw)
        if not all(torch.equal(x, y[gath]) for x, y in zip(got, full)):
            raise AssertionError(f"trie_plan {name}: gathered lanes != the "
                                 "capacity-wide call")
        log(f"  trie_plan {name} N={c['trie'].n_nodes} B={lanes}: width 1 "
            f"(each lane), gathered ({len(gath)} lanes) and capacity-wide "
            f"identical, and equal to the plain blocked version")
        if name != "mathqa_4":
            continue
        for label, idx in (("width 1", [0]), (f"gathered {len(gath)}", gath),
                           (f"capacity {lanes}", list(range(lanes)))):
            s = sub(idx)
            ms = graph_ms(lambda: trie_plan_cuda(*s, **kw))
            plain_ms = graph_ms(lambda: fleet_plan_blocked(*s, **kw))
            b_ms, b_by = bound(*cost.plan_work(
                c["trie"].subtree_size, c["roots"][idx], c["trie"].n_models,
                c["delays"].shape[1]), F32_OPS)
            rec.setdefault("timing_cases", {})[
                f"trie_plan compiled {label} (mathqa_4)"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)
            log(f"  trie_plan compiled engine, {label} on mathqa_4 N="
                f"{c['trie'].n_nodes}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {b_ms:.3g} ms ({b_by})")


def _replay_setup(n):
    """The replay: MathQA-4 (5461 nodes), ``n`` requests drawn from a
    300-request workload, Poisson arrivals at REPLAY_RATE into
    REPLAY_CAPACITY slots, load-aware with concurrency-4 engines, the
    feasibility gate under the preset's 0.5 cost and 0.8 latency
    quantiles."""
    from repro_torch.core import presets
    from repro_torch.core.controller import Objective
    from repro_torch.core.runtime import make_workload_executor
    from repro_torch.core.trie import Trie
    from repro_torch.core.workload import generate_workload, poisson_arrivals
    from repro_torch.serving.loadsim import EngineLoadModel, FleetLoadModel

    tpl = presets.mathqa_4()
    trie = Trie.build(tpl)
    wl = generate_workload(tpl, 300, seed=0)
    ann = wl.exact_annotations(trie)
    term = trie.terminal
    obj = Objective("max_acc",
                    cost_cap=float(np.quantile(ann.cost[term], 0.5)),
                    lat_cap=float(np.quantile(ann.lat[term], 0.8)))
    engines = sorted({m.engine for m in tpl.models})
    reqs = np.random.default_rng(SEED + 3).integers(0, 300, n)
    kw = dict(arrivals=poisson_arrivals(n, rate=REPLAY_RATE, seed=SEED + 3),
              capacity=REPLAY_CAPACITY, policy="dynamic_load_aware",
              fleet_load=FleetLoadModel(
                  engines={e: EngineLoadModel(e, concurrency=4, jitter=0.0)
                           for e in engines},
                  mean_service_s={e: 1.0 for e in engines}),
              admission="feasibility")
    return trie, ann, obj, reqs, make_workload_executor(wl), kw


def _mask_replan(lines):
    """A driver's printed lines with the wall-clock replan figure masked."""
    return [re.sub(r"replan=[0-9.]+ms", "replan=<wall>ms", x) for x in lines]


def _counted(fn):
    """(result, launches, host reads, wall s) of ``fn()`` on the card,
    launches counted from zero."""
    import torch

    from repro_torch.device import host_reads
    from repro_torch.kernels import _build

    _build.reset_launches()
    torch.cuda.synchronize()
    r0, t0 = host_reads(), time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, dict(_build.LAUNCHES), host_reads() - r0,
            time.perf_counter() - t0)


def phase_serve_compiled(args, rec):
    """The port's compiled event engine on the card.  (a) The cohort
    through `run_events(compiled=True, device="cuda")` with phase
    serve-events' knobs less the timeout model and on unit mean service
    (`_events_setup`), equal to the port's host loop
    on the CPU on every field but the replan wall time, identical at epoch
    widths 1, 7 and n, with trie_plan launches equal to its replan rounds;
    the replan's width-1, gathered and capacity-wide calls held equal
    first.  (b) A MathQA-4 replay of REPLAY_REQUESTS requests with
    ``stream=True``: its summary against the materialised run's at
    `repro`'s tolerances, a REPLAY_PREFIX-request prefix equal to the
    host loop on the CPU, events/s against the host loop on the card.
    (c) `quickstart` and `mathqa_loadaware` with ``--device cuda`` print
    their CPU lines, the replan milliseconds aside."""
    import torch

    from repro_torch.core.events import run_events
    from repro_torch.core.runtime import make_workload_executor
    from repro_torch.examples import mathqa_loadaware, quickstart

    smi = rec["smi"]
    _check_plan_widths(rec)
    cohort = _cohort()
    tpl, trie, wl, ann, obj, reqs = cohort
    obj_ev = dataclasses.replace(obj, lat_cap=None)
    kw = _events_setup(cohort, {m.engine: 1.0 for m in tpl.models})
    execu = make_workload_executor(wl)
    paths = {}

    # (a) the served cohort
    (res, stats), launches, reads, wall = _counted(lambda: run_events(
        trie, ann, obj_ev, reqs, execu, compiled=True, device="cuda",
        epoch=len(reqs), **kw))
    paths["cohort"] = launches
    if launches["trie_plan"] != stats.replans or stats.replans <= 0 or \
            any(v for k, v in launches.items() if k != "trie_plan"):
        raise AssertionError(f"serve-compiled: launches {launches} for "
                             f"{stats.replans} replan rounds")
    if stats.annotation_swaps != 1 or stats.engine_outages != 1 or \
            stats.explored < 1 or stats.preemptions < 1:
        raise AssertionError(
            f"serve-compiled missed a path: {stats.annotation_swaps} swaps, "
            f"{stats.engine_outages} outages, {stats.explored} explored, "
            f"{stats.preemptions} preemptions")
    got = _compiled_record(res, stats)
    host = _compiled_record(*run_events(trie, ann, obj_ev, reqs, execu,
                                        device="cpu", **kw))
    diff = [k for k in got if got[k] != host[k]]
    if diff:
        raise AssertionError(f"serve-compiled on the card differs from the "
                             f"host loop on the CPU in {diff}")
    for ep in COMPILED_EPOCHS:
        other = _compiled_record(*run_events(
            trie, ann, obj_ev, reqs, execu, compiled=True, device="cuda",
            epoch=ep, **kw))
        diff = [k for k in got if got[k] != other[k]]
        if diff:
            raise AssertionError(f"serve-compiled at epoch {ep} differs "
                                 f"from epoch {len(reqs)} in {diff}")
    log(f"[{smi}] compiled engine, {len(reqs)} NL2SQL-2 requests: "
        f"{stats.events} events, {stats.replans} replan rounds = trie_plan "
        f"launches, {reads} host reads ({reads / stats.events:.1f} an "
        f"event), {wall:.2f} s wall; equal to the host loop on the CPU, and "
        f"at epochs {COMPILED_EPOCHS + (len(reqs),)}; counts "
        f"{got['counts']}")

    # (b) the replay at scale
    n = REPLAY_REQUESTS
    trie4, ann4, obj4, reqs4, ex4, kw4 = _replay_setup(n)
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    (summary, sstats), launches, reads, wall = _counted(
        lambda: run_events(trie4, ann4, obj4, reqs4, ex4, compiled=True,
                           device="cuda", stream=True, **kw4))
    paths["replay"] = launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - base_gb
    if launches["trie_plan"] != sstats.replans:
        raise AssertionError(f"replay: {launches['trie_plan']} trie_plan "
                             f"launches for {sstats.replans} replan rounds")
    (mres, mstats), _, _, mwall = _counted(lambda: run_events(
        trie4, ann4, obj4, reqs4, ex4, compiled=True, device="cuda", **kw4))
    served = [r for r in mres if r.outcome == "served"]
    lats = np.array([r.total_lat for r in served])
    costs = np.array([r.total_cost for r in served])
    checks = [
        summary["n_requests"] == n, summary["served"] == len(served),
        summary["succeeded"] == sum(r.success for r in mres),
        (summary["rejected"], summary["shed"], summary["events"],
         summary["replans"]) == (mstats.rejected, mstats.shed,
                                 mstats.events, mstats.replans),
        summary["slo_violations"] == sum(r.slo_violated for r in mres),
        summary["latency"]["count"] == len(served),
        abs(summary["latency"]["mean"] - lats.mean())
        <= 1e-12 * abs(lats.mean()),
        abs(summary["latency"]["std"] - lats.std()) <= 1e-9 * lats.std(),
        abs(summary["cost"]["mean"] - costs.mean())
        <= 1e-12 * abs(costs.mean())]
    if not all(checks):
        raise AssertionError(f"replay: stream summary != the materialised "
                             f"run ({checks})")
    pre = slice(0, REPLAY_PREFIX)
    kwp = dict(kw4, arrivals=kw4["arrivals"][pre])
    (pres, pstats), plaunch, preads, pwall = _counted(lambda: run_events(
        trie4, ann4, obj4, reqs4[pre], ex4, compiled=True, device="cuda",
        **kwp))
    paths["prefix"] = plaunch
    cpu = run_events(trie4, ann4, obj4, reqs4[pre], ex4, device="cpu", **kwp)
    a, b = _compiled_record(pres, pstats), _compiled_record(*cpu)
    diff = [k for k in a if a[k] != b[k]]
    if diff:
        raise AssertionError(f"replay prefix on the card != the host loop "
                             f"on the CPU in {diff}")
    (hres, hstats), hlaunch, _, hwall = _counted(lambda: run_events(
        trie4, ann4, obj4, reqs4[pre], ex4, device="cuda", **kwp))
    paths["prefix host loop"] = hlaunch
    ev_s, hev_s = sstats.events / wall, hstats.events / hwall
    pev_s = pstats.events / pwall
    log(f"[{smi}] replay: MathQA-4 N={trie4.n_nodes}, {n} requests at "
        f"{REPLAY_RATE} rps into {REPLAY_CAPACITY} slots, stream=True: "
        f"{sstats.events} events, {sstats.replans} replans, {wall:.2f} s "
        f"wall = {ev_s:.1f} events/s; {reads} host reads "
        f"({reads / sstats.events:.1f} an event); peak device memory "
        f"{peak_gb:.3f} GB above the {base_gb:.3f} GB held before; "
        f"materialised run {mwall:.2f} s, summary equal "
        f"at rel 1e-12 / 1e-9; served {summary['served']}, rejected "
        f"{summary['rejected']}, shed {summary['shed']}, latency p50 "
        f"{summary['latency_p50']:.3f} s p99 {summary['latency_p99']:.3f} s")
    log(f"[{smi}] replay prefix ({REPLAY_PREFIX} requests): compiled on the "
        f"card {pstats.events} events in {pwall:.2f} s = {pev_s:.1f} "
        f"events/s ({preads / pstats.events:.1f} host reads an event), "
        f"equal to the host loop on the CPU; the host loop on the card "
        f"{hstats.events} events in {hwall:.2f} s = {hev_s:.1f} events/s")

    # (c) the two host drivers: quickstart's dynamic cohort replans
    # through the fleet planner's kernel; mathqa_loadaware serves one
    # request a cohort, which `run_cohort` plans on the host
    # (`select_path`), as `repro`'s does, so it launches no kernel
    drivers = {}
    for mod in (quickstart, mathqa_loadaware):
        name = mod.__name__.rsplit(".", 1)[1]
        lines, launch, _, dwall = _counted(lambda: mod.main(
            ["--device", "cuda"]))
        paths[name] = launch
        cpu_lines = mod.main(["--device", "cpu"])

        fleet = mod is quickstart
        if _mask_replan(lines) != _mask_replan(cpu_lines) or \
                (launch["trie_plan"] > 0) != fleet or \
                sum(launch.values()) != launch["trie_plan"]:
            raise AssertionError(f"{name} on the card printed {lines}, on the "
                                 f"CPU {cpu_lines}; launches {launch}")
        drivers[name] = dict(wall_s=dwall, lines=lines, launches=launch)
        log(f"[{smi}] {name} --device cuda in {dwall:.1f} s, "
            f"{launch['trie_plan']} trie_plan launches: its CPU lines")

    rec["compiled_cohort"] = (lambda: run_events(
        trie, ann, obj_ev, reqs, execu, compiled=True, device="cuda",
        epoch=len(reqs), **kw), stats.events)
    total = {k: sum(p[k] for p in paths.values()) for k in KERNELS}
    rec.setdefault("paths", {})["serve-compiled"] = dict(
        launches=total, by_run=paths, cohort_events=stats.events,
        cohort_replans=stats.replans, replay_requests=n,
        replay_events=sstats.events, replay_replans=sstats.replans,
        replay_wall_s=wall, replay_events_per_s=ev_s,
        replay_host_reads_per_event=reads / sstats.events,
        replay_peak_gb=peak_gb, prefix_events_per_s=pev_s,
        prefix_host_loop_events_per_s=hev_s, drivers=drivers)
    _after_serving(args, rec, "serve-compiled", cohort)


# the sharded control plane's phase: 2 ranks on the one card over gloo
# (NCCL refuses two ranks on one device), then the planner at world size
# 1 over NCCL; the planner's capacity and random rounds, and the budget
SHARDED_WORLD = 2
SHARDED_CAPACITY = 64
SHARDED_ROUNDS = 3
SHARDED_PRESETS = (("nl2sql_2", 21), ("mathqa_4", 22))  # (preset, seed)
SHARDED_BUDGET_S = 60.0


def _sharded_planner_case(name, seed):
    """The resident planner's steps on one preset at SHARDED_CAPACITY
    lanes: SHARDED_ROUNDS rounds of random lane updates, each replanned
    against a random delay row, then every lane's occupancy (integer
    weights, so the float row is exact in any order) and one coupled
    replan; the case for `repro_torch.dist.runs.run_cases`."""
    from repro_torch.core import presets
    from repro_torch.core.controller import Objective
    from repro_torch.core.trie import Trie
    from repro_torch.core.workload import generate_workload

    tpl = presets.PRESETS[name]()
    trie = Trie.build(tpl)
    ann = generate_workload(tpl, 300, seed=0).exact_annotations(trie)
    term = trie.terminal
    obj = Objective("max_acc",
                    cost_cap=float(np.quantile(ann.cost[term], 0.5)),
                    lat_cap=float(np.quantile(ann.lat[term], 0.8)))
    E = len({m.engine for m in tpl.models})
    C = SHARDED_CAPACITY
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(SHARDED_ROUNDS):
        k = int(rng.integers(1, C + 1))
        slots = rng.choice(C, size=k, replace=False)
        steps.append(("update", slots,
                      rng.integers(0, trie.n_nodes, k).astype(np.int32),
                      (rng.random(k) * obj.lat_cap).astype(np.float32),
                      (rng.random(k) * obj.cost_cap).astype(np.float32)))
        steps.append(("replan", (rng.random(E) * 0.1).astype(np.float32),
                      None))
    slots = np.arange(C)
    steps.append(("loads", slots,
                  rng.integers(-1, E, C).astype(np.int32),
                  rng.integers(0, 4, C).astype(np.float32)))
    steps.append(("coupled", np.full(E, 4.0), np.full(E, 0.05),
                  np.ones(E, bool), None))
    return dict(kind="planner", trie=trie, ann=ann, obj=obj, capacity=C,
                steps=steps)


def _single_planner(case):
    """The case's steps through the unsharded planner on the card: its
    plans (the coupled replan as a plain replan against the row summed on
    the host) and the wall microseconds of each replan."""
    from repro_torch.core.controller_torch import (TrieDevice,
                                                   make_resident_planner)
    from repro_torch.dist.runs import planner_record

    td = TrieDevice.build(case["trie"], case["ann"], device="cuda")
    p = make_resident_planner(td, case["obj"], case["capacity"])
    plans, us, loads = [], [], None
    for kind, *a in case["steps"]:
        if kind == "update":
            p.update(*a)
        elif kind == "loads":
            loads = a
        else:
            if kind == "coupled":
                # the delay row in float32 from float32 operands, as the
                # sharded planner and `repro` take it
                conc, ms, hasm, blocked = a
                conc, ms = (np.asarray(v, np.float32) for v in (conc, ms))
                _, park, w = loads
                occ = np.zeros(len(conc), np.float32)
                for e, wv in zip(park, w):
                    if e >= 0:
                        occ[e] += wv
                one = np.float32(1.0)
                row = np.where(hasm, (np.maximum(one, (occ + one) / conc)
                                      - one) * ms,
                               np.float32(0.0)).astype(np.float32)
                a = (row, blocked)
            t0 = time.perf_counter()
            out = p.replan(*a)
            us.append((time.perf_counter() - t0) * 1e6)
            plans.append(out if kind == "replan" else (*out, row))
    return planner_record(plans), us


SHARDED_MERGES = 20  # merges timed alone, before the cases


def _sharded_group(cases, world, backend, smi):
    """Run the plan merge alone, then the cases, on ``world`` ranks of the
    card over ``backend`` (a world of one in this process, started
    processes else); every rank's digest must equal rank 0's.  Returns
    the group's output (its records and measures without the merge's)
    and its wall seconds."""
    import torch

    from repro_torch.dist import lane_mesh, one_rank_group, spawn
    from repro_torch.dist.runs import run_cases

    merge = {"kind": "merge", "lanes": SHARDED_CAPACITY,
             "calls": SHARDED_MERGES}
    t0 = time.perf_counter()
    if world == 1:
        torch.cuda.set_device(0)
        with one_rank_group(backend):
            out = run_cases(lane_mesh(1, device="cuda"), [merge] + cases,
                            time.time())
    else:
        out = spawn(run_cases, world, device="cuda", backend=backend,
                    args=([merge] + cases, time.time()), timeout_s=60.0,
                    deadline_s=180.0)
    wall = time.perf_counter() - t0
    if len(out["digests"]) != world or len(set(out["digests"])) != 1:
        raise AssertionError(f"serve-sharded: the {world} ranks over "
                             f"{backend} disagree: {out['digests']}")
    want = np.arange(2 * SHARDED_CAPACITY).reshape(2, -1).tolist()
    if out["records"][0]["merged"] != want:
        raise AssertionError(f"serve-sharded: the merge over {backend} "
                             f"gave {out['records'][0]['merged']}")
    us = [m[0]["us"] for m in out["measures"]]
    times = out["times"]
    log(f"[{smi}] serve-sharded {backend}, {world} rank(s): group {wall:.1f}"
        f" s; ranks started {[round(t['start_s'], 1) for t in times]} s "
        f"after the spawn call, ran their cases in "
        f"{[round(t['cases_s'], 1) for t in times]} s; the merge alone "
        f"(2 x {SHARDED_CAPACITY} int32 from the card, copies included): "
        f"median {[round(float(np.median(u[1:])), 1) for u in us]} us a "
        f"call per rank (first {[round(u[0], 1) for u in us]})")
    out = dict(out, records=out["records"][1:],
               measures=[m[1:] for m in out["measures"]],
               merge_us=us)
    return out, wall


def _check_planner_part(label, out, i, case, single, single_us, smi):
    """Part (a): one planner case of a group against the single-device
    planner; per call one collective a replan and two a coupled replan,
    one trie_plan launch on every rank."""
    got = out["records"][i]
    if got["plans"] != single:
        raise AssertionError(f"serve-sharded {label}: the sharded planner's "
                             f"plans differ from the single-device planner")
    calls = [m[i]["calls"] for m in out["measures"]]
    kinds = [c["kind"] for c in calls[0]]
    for r, rc in enumerate(calls):
        col = [c["collectives"] for c in rc]
        lau = [c["launches"] for c in rc]
        if col != [1 if k == "replan" else 2 for k in kinds] or \
                lau != [1] * len(kinds):
            raise AssertionError(f"serve-sharded {label}: rank {r} made "
                                 f"{col} collectives and {lau} trie_plan "
                                 f"launches for the calls {kinds}")
    sh_us = [c["s"] * 1e6 for c in calls[0] if c["kind"] == "replan"]
    co_us = [c["s"] * 1e6 for c in calls[0] if c["kind"] == "coupled"]
    log(f"[{smi}] serve-sharded {label}: {case['trie'].n_nodes} nodes, "
        f"capacity {case['capacity']}: replan {np.median(sh_us):.1f} us a "
        f"call sharded (coupled {co_us[0]:.1f} us) vs "
        f"{np.median(single_us):.1f} us single; collectives a replan "
        f"{np.mean([c['collectives'] for c in calls[0] if c['kind'] == 'replan']):.3f}"
        f", a coupled replan 2.000; trie_plan launches per rank "
        f"{[sum(c['launches'] for c in rc) for rc in calls]} = its plans "
        f"{[len(rc) for rc in calls]}; plans equal bit for bit, ranks agree")
    return dict(sharded_us=sh_us, coupled_us=co_us, single_us=single_us,
                launches=[sum(c["launches"] for c in rc) for rc in calls])


def _check_events_part(label, out, i, single, single_m, smi):
    """Parts (b) and (c): one event run of a group against the
    single-device run on the card; one collective and one trie_plan
    launch on every rank a replan (round), the single run's host reads."""
    from repro_torch.dist.runs import events_record

    got = {k: v for k, v in out["records"][i].items() if k != "measure"}
    want = events_record(single)
    diff = [k for k in want if got.get(k) != want[k]]
    if diff:
        raise AssertionError(f"serve-sharded {label}: differs from the "
                             f"single-device run in {diff}")
    replans = want["counts"]["replans"]
    ms = [m[i] for m in out["measures"]]
    for r, m in enumerate(ms):
        if m["collectives"] != replans or m["launches"] != replans or \
                m["host_reads"] != single_m["host_reads"]:
            raise AssertionError(
                f"serve-sharded {label}: rank {r} made {m['collectives']} "
                f"collectives, {m['launches']} trie_plan launches and "
                f"{m['host_reads']} host reads for {replans} replans (the "
                f"single run: {single_m['host_reads']} host reads)")
    events = want["counts"]["events"]
    rep = ms[0]["replan_s"]
    rep_str = (f"replan {np.median(rep) * 1e6:.1f} us a call sharded vs "
               f"{np.median(single[1].replan_s) * 1e6:.1f} us single; "
               if rep else "")
    log(f"[{smi}] serve-sharded {label}: {events} events, {replans} replans; "
        f"{rep_str}{events / ms[0]['s']:.1f} events/s sharded (rank 0) vs "
        f"{events / single_m['s']:.1f} single; collectives a replan "
        f"{ms[0]['collectives'] / replans:.3f}; host reads an event "
        f"{ms[0]['host_reads'] / events:.2f} (single "
        f"{single_m['host_reads'] / events:.2f}); trie_plan launches per "
        f"rank {[m['launches'] for m in ms]} = its plans "
        f"{[replans] * len(ms)}; equal bit for bit, ranks agree")
    return dict(events=events, replans=replans,
                events_per_s=events / ms[0]["s"],
                single_events_per_s=events / single_m["s"],
                host_reads_per_event=ms[0]["host_reads"] / events,
                launches=[m["launches"] for m in ms],
                replan_us=[x * 1e6 for x in rep])


def phase_serve_sharded(args, rec):
    """The lane-sharded control plane on the card
    (`repro_torch.dist`): the kernels are built here first, then
    SHARDED_WORLD ranks on cuda:0 over gloo (NCCL refuses two ranks on
    one device; gloo's collectives go through host copies) run (a) the
    resident planner with ``mesh=`` at SHARDED_CAPACITY lanes on NL2SQL-2
    and MathQA-4 (`_sharded_planner_case`), (b) `run_events(devices=2)`
    on serve-events' cohort and knobs (timeouts included) over the
    workload's stage tables and (c) `run_events(compiled=True,
    devices=2)` on serve-compiled's cohort and on its replay's
    REPLAY_PREFIX-request prefix with ``stream=True``; each equal bit for
    bit to the single-device run on the card, every rank's digest equal
    to rank 0's, one collective a replan (round), the trie_plan launches
    of each rank equal to its plans.  Then (a) once more at world size 1
    over NCCL, in this process (`one_rank_group`: a started process
    takes ~9 s to reach the card).  No profiler session opens here."""
    from repro_torch.core.events import run_events
    from repro_torch.core.runtime import make_workload_executor
    from repro_torch.device import host_reads
    from repro_torch.kernels import _build

    smi = rec["smi"]
    t_phase = time.perf_counter()
    _build.extension()  # the ranks load this build, never compile
    planners = [_sharded_planner_case(n, s) for n, s in SHARDED_PRESETS]
    cohort = _cohort()
    tpl, trie, wl, ann, obj, reqs = cohort
    obj_ev = dataclasses.replace(obj, lat_cap=None)
    execu = make_workload_executor(wl)
    unit = {m.engine: 1.0 for m in tpl.models}
    host_kw = _events_setup(cohort, unit, timeout_k=4.0)
    comp_kw = dict(_events_setup(cohort, unit), compiled=True,
                   epoch=len(reqs))
    trie4, ann4, obj4, reqs4, ex4, kw4 = _replay_setup(REPLAY_REQUESTS)
    pre = slice(0, REPLAY_PREFIX)
    pre_kw = dict(kw4, arrivals=kw4["arrivals"][pre], compiled=True,
                  stream=True)
    events = [("(b) host loop, serve-events' cohort",
               (trie, ann, obj_ev, reqs, execu), host_kw),
              ("(c) compiled engine, serve-compiled's cohort",
               (trie, ann, obj_ev, reqs, execu), comp_kw),
              (f"(c) compiled engine, the replay's {REPLAY_PREFIX}-request "
               f"prefix, stream=True", (trie4, ann4, obj4, reqs4[pre], ex4),
               pre_kw)]

    # the single-device runs on the card, each timed and its host reads
    # counted
    singles = [_single_planner(c) for c in planners]
    single_ev = []
    for _, a, kw in events:
        (out, _, reads, wall) = _counted(lambda: run_events(
            *a, device="cuda", **kw))
        single_ev.append((out, dict(s=wall, host_reads=reads)))
    t_single = time.perf_counter() - t_phase

    cases = planners + [{"kind": "events", "args": a, "kw": kw}
                        for _, a, kw in events]
    out, wall = _sharded_group(cases, SHARDED_WORLD, "gloo", smi)
    parts = {}
    for i, ((name, _), c) in enumerate(zip(SHARDED_PRESETS, planners)):
        parts[f"(a) planner {name}, gloo"] = _check_planner_part(
            f"(a) planner {name}, gloo, {SHARDED_WORLD} ranks on cuda:0",
            out, i, c, singles[i][0], singles[i][1], smi)
    for j, (label, _, _) in enumerate(events):
        parts[f"{label}, gloo"] = _check_events_part(
            f"{label}, gloo, {SHARDED_WORLD} ranks on cuda:0", out,
            len(planners) + j, *single_ev[j], smi)
    nccl, nwall = _sharded_group(planners, 1, "nccl", smi)
    for i, ((name, _), c) in enumerate(zip(SHARDED_PRESETS, planners)):
        parts[f"(a) planner {name}, nccl"] = _check_planner_part(
            f"(a) planner {name}, nccl, world size 1", nccl, i, c,
            singles[i][0], singles[i][1], smi)
    total = time.perf_counter() - t_phase
    log(f"[{smi}] serve-sharded: {total:.1f} s (budget "
        f"{SHARDED_BUDGET_S:.0f} s): single-device runs {t_single:.1f} s, "
        f"the gloo group {wall:.1f} s, the NCCL group {nwall:.1f} s"
        + ("" if total <= SHARDED_BUDGET_S else "; OVER ITS BUDGET"))
    launches = {k: 0 for k in KERNELS}
    launches["trie_plan"] = sum(sum(p["launches"]) for p in parts.values())
    rec.setdefault("paths", {})["serve-sharded"] = dict(
        launches=launches, parts=parts, wall_s=total, gloo_group_s=wall,
        nccl_group_s=nwall, single_s=t_single,
        merge_us={"gloo": out["merge_us"], "nccl": nccl["merge_us"]},
        rank_times={"gloo": out["times"], "nccl": nccl["times"]})


def phase_serve_ssm(args, rec):
    import torch

    rec.pop("yi_engines", None)
    torch.cuda.empty_cache()  # the dense path's engines are gone
    cohort = _cohort()
    t0 = time.perf_counter()
    engines = {e: _engine(cohort[0], e, _cut(arch, SSM_ENGINE_LAYERS),
                          SEED + 10 + i)
               for i, (e, arch) in enumerate(sorted(SSM_ENGINES.items()))}
    torch.cuda.synchronize()
    log(f"reduced: depth only, {_cut_str(SSM_ENGINE_LAYERS)} (full width); "
        f"weights random from seed {SEED + 10}; init "
        f"{time.perf_counter() - t0:.1f} s")
    for eng in engines.values():
        # a ragged prompt of 300 tokens spans two SSD chunks of 256
        n = SSM_CHECK_LAYERS[eng.model.cfg.name]
        small = _reduced_copy(eng.model, n)
        _model_check(small, rec, f"{eng.model.cfg.name} {eng.name} first {n}"
                     f" layers", 300)
        del small
    _serve_cohort("ssm", engines, cohort, rec, args)
    _after_serving(args, rec, "serve-ssm", cohort)


# the dense families' path: two engines at full width, minicpm3-4b's
# depth cut (DENSE_ENGINE_LAYERS: its host-bound MLA decode at 62 layers
# was most of the phase), then qwen2-72b alone, depth cut to fit the card
# (80 layers of 0.89B would not)
DENSE_ENGINES = {"engine-a": "minicpm3-4b", "engine-b": "mistral-nemo-12b"}
DENSE_ENGINE_LAYERS = {"minicpm3-4b": 16}
QWEN_LAYERS = 36
DENSE_CHECK_LAYERS = 2


def _draw_biases(model, seed: int) -> None:
    """Nonzero QKV biases (0.5 N(0, 1), layer i from seed + i), so that the
    card's bias add is seen by the checks (`repro` inits them to zero)."""
    import torch

    with torch.no_grad():
        for i, blk in enumerate(model.layers):
            g = torch.Generator(device="cuda").manual_seed(seed + i)
            for b in (blk.attn.bq, blk.attn.bk, blk.attn.bv):
                b.copy_(0.5 * torch.randn(b.shape, generator=g,
                                          device="cuda"))


def _weight_bound(model):
    """(ms, GB): the weights one decode step reads (all but the embedding,
    of which it reads one row, a VLM's ``patch_proj`` and an encoder's
    layers and norm; of a MoE layer's experts only the top K of E a token
    routes to, with its router and dense residual whole) over the card's
    memory rate."""
    moe = model.cfg.moe
    nbytes = 0
    for n, p in model.named_parameters():
        if n in ("embed", "patch_proj") or n.startswith("enc_"):
            continue
        b = p.numel() * p.element_size()
        if moe is not None and n.endswith(("mlp.w1", "mlp.w3", "mlp.w2")):
            b = b * moe.top_k // moe.n_experts
        nbytes += b
    return nbytes / HBM_BPS * 1e3, nbytes / 1e9


def _dense_engine(tpl, ename, cfg, seed):
    """`_engine` with QKV biases drawn where the config has them."""
    eng = _engine(tpl, ename, cfg, seed)
    if cfg.qkv_bias:
        _draw_biases(eng.model, seed + 1000)
    return eng


def _engine_reading(name, model, path, rec, what=f"{PROMPT} tokens"):
    """Log and record the prefill (of ``what``), decode per token,
    weight-read bound and the path's peak memory of ``model``, served as
    ``name`` (from `_serve_cohort`'s record, or a path's own)."""
    out = rec["paths"][path]
    e = out["engines"].get(name)
    if e is None:
        return
    b_ms, gb = _weight_bound(model)
    e.update(weight_bound_ms=b_ms, weight_gb=gb,
             params=sum(p.numel() for p in model.parameters()))
    log(f"[{rec['smi']}] {model.cfg.name} ({model.cfg.n_layers} "
        f"layers, {e['params'] / 1e9:.2f}B parameters): prefill {what} "
        f"{e['prefill_ms']:.2f} ms, decode "
        f"{e['decode_ms_per_token']:.3f} ms/token, weight-read bound "
        f"{b_ms:.3f} ms/token ({gb:.2f} GB), peak memory "
        f"{out['max_memory_allocated_gb']:.2f} GB")


def phase_serve_dense(args, rec):
    """The cohort on minicpm3-4b (engine-a, MLA, DENSE_ENGINE_LAYERS' 16
    of 62 layers) and mistral-nemo-12b (engine-b, full depth), both at
    full width, with a 2-layer copy of each
    held against its float32 CPU copy and the launches exact; then, with
    both freed, qwen2-72b (QKV bias) at full width, depth cut to
    QWEN_LAYERS, for one stage invocation: its 2-layer model (drawn from
    the same seed before the engine, so the two never share the card)
    against float32 on the CPU, and the invocation's launches exact."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    rec.pop("yi_engines", None)
    gc.collect()
    torch.cuda.empty_cache()
    cohort = _cohort()
    tpl = cohort[0]
    t0 = time.perf_counter()
    engines = {e: _dense_engine(tpl, e, _cut(arch, DENSE_ENGINE_LAYERS),
                                SEED + 30 + i)
               for i, (e, arch) in enumerate(sorted(DENSE_ENGINES.items()))}
    torch.cuda.synchronize()
    log(f"reduced: depth only, {_cut_str(DENSE_ENGINE_LAYERS)} (full "
        f"width); weights random from seed {SEED + 30}; init "
        f"{time.perf_counter() - t0:.1f} s")
    for eng in engines.values():
        small = _reduced_copy(eng.model, DENSE_CHECK_LAYERS)
        _model_check(small, rec, f"{eng.model.cfg.name} {eng.name} first "
                     f"{DENSE_CHECK_LAYERS} layers", 100)
        del small
    _serve_cohort("dense", engines, cohort, rec, args)
    for eng in engines.values():
        _engine_reading(eng.name, eng.model, "dense", rec)
    del engines, eng  # the loop's name holds an engine too
    gc.collect()
    torch.cuda.empty_cache()

    full = get_config("qwen2-72b")
    cfg = dataclasses.replace(full, n_layers=QWEN_LAYERS)
    seed = SEED + 40
    small = _dense_engine(tpl, "engine-a", dataclasses.replace(
        cfg, n_layers=DENSE_CHECK_LAYERS), seed).model
    _model_check(small, rec, f"qwen2-72b first {DENSE_CHECK_LAYERS} layers",
                 100)
    del small
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  before qwen2-72b: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"still allocated")
    eng = _dense_engine(tpl, "engine-a", cfg, seed)
    log(f"reduced: depth only, {QWEN_LAYERS} of {full.n_layers} layers (80 "
        f"layers of bf16 weights, ~145 GB, do not fit the card's 80 GB); "
        f"weights random from seed {seed}")
    prompt = np.random.default_rng(SEED).integers(0, cfg.vocab, (1, PROMPT))
    eng.generate(np.zeros((1, PROMPT), np.int64), max_new=2)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    out, ttft, dec = eng.generate(prompt, max_new=MAX_NEW)
    launches = dict(_build.LAUNCHES)
    expect = {k: 0 for k in KERNELS}
    expect.update(_expected_launches(cfg, 1))
    log(f"  launches of one stage invocation on qwen2-72b: {launches} "
        f"(expected {expect})")
    if launches != expect or out.shape != (1, MAX_NEW) or \
            out.min() < 0 or out.max() >= cfg.vocab:
        raise AssertionError("qwen2-72b: the stage invocation's launches or "
                             "tokens are off")
    rec["paths"]["qwen2-72b"] = dict(
        launches=launches, max_memory_allocated_gb=torch.cuda.
        max_memory_allocated() / 1e9, engines={"engine-a": dict(
            invocations=1, prefill_ms=ttft * 1e3,
            decode_ms_per_token=dec * 1e3 / MAX_NEW, stage_s=ttft + dec)})
    _engine_reading(eng.name, eng.model, "qwen2-72b", rec)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    _after_serving(args, rec, "serve-dense", cohort)


# ----------------------------------------------------------------------
# phase serve-moe: the MoE families, their routing held against float32
# ----------------------------------------------------------------------
# engine-a: granite-moe-1b-a400m at full width, depth cut to 12 of 24
# layers (its host-bound decode was most of the phase); engine-b:
# arctic-480b at full width with all 128 experts and its dense residual,
# depth cut to 2 of 35 layers (a layer is 13.6B parameters, 27.2 GB of
# bf16: 2 layers and the embeddings are 55.4 GB, 3 would not fit 80 GB)
MOE_ENGINES = {"engine-a": ("granite-moe-1b-a400m", 12),
               "engine-b": ("arctic-480b", 2)}
MOE_ROUTE_LAYERS = 2  # each engine's first layers routed at full E
# the copies held against float32 on the CPU: (layers, experts); arctic's
# keeps its first 16 experts and router columns (an expert cut: one full
# layer in float32 is 54 GB)
MOE_CHECK = {"granite-moe-1b-a400m": (2, None), "arctic-480b": (1, 16)}
MOE_CHECK_PROMPT = 100
MOE_DECODE_STEPS = 8
FLIP_SHARE = 0.02      # flips at most, of the rows x layers routed at full E
# tau, the reference logit gap below which bf16 can swap two experts (see
# `_tau`): twice the half-ulp of bf16 at the larger logit (each logit is
# rounded once), plus a slack: float32 summation order where the card and
# the reference route the same input (the full-E layer check), the bf16
# rounding of everything upstream of the first router where each routes
# its own (the model and train checks; 0.027 logits at most on CPU bf16
# runs of granite's first layer, PERF.md section 6)
TAU_LAYER_SLACK = 2.0 ** -10
TAU_MODEL_SLACK = 2.0 ** -4
FLIP_GRAD_TOL = 0.5    # a train copy's gradient leaves once a flip reaches
                       # them (relative L2; PERF.md section 6)


def _tau(l_a: float, l_b: float, slack: float) -> float:
    """The largest reference logit gap at which the card's bf16 logits can
    order experts a and b the other way: each logit rounds by at most half
    a bf16 ulp (2^(floor(log2 |l|) - 8)), so the gap moves by at most twice
    that at the larger |logit|, plus ``slack``."""
    m = max(abs(l_a), abs(l_b), 2.0 ** -126)
    return 2.0 * 2.0 ** (np.floor(np.log2(m)) - 8) + slack


def _ref_slots(topi: np.ndarray, E: int, G: int) -> np.ndarray:
    """Capacity slots of `repro`'s rule, one choice at a time: rank-major
    (every row's first choice in row order, then every second, ...), per
    group of G rows, each expert's count growing by every row that chose
    it."""
    R, K = topi.shape
    pos = np.zeros((R, K), np.int64)
    count = np.zeros((R // G, E), np.int64)
    for j in range(K):
        for r in range(R):
            e, g = topi[r, j], r // G
            pos[r, j] = count[g, e]
            count[g, e] += 1
    return pos


def _ref_route(gates: np.ndarray, K: int, C: int, G: int):
    """The reference's routing of its own gates (R, E): the K largest,
    ties to the lowest index (a lexicographic sort on (-gate, index)),
    renormalised, slots by `_ref_slots` -> (topi, topv, keep), numpy."""
    idx = np.broadcast_to(np.arange(gates.shape[-1]), gates.shape)
    topi = np.lexsort((idx, -gates), axis=-1)[:, :K]
    topv = np.take_along_axis(gates, topi, -1)
    topv = topv / np.maximum(topv.sum(-1, keepdims=True), 1e-9)
    return topi, topv, _ref_slots(topi, gates.shape[-1], G) < C


def _routing_np(r):
    """A `layers.Routing` of R rows as numpy (topi, topv, keep, pos)."""
    K = r.topi.shape[-1]
    return tuple(t.reshape(-1, K).detach().float().cpu().numpy()
                 if t.dtype.is_floating_point else
                 t.reshape(-1, K).cpu().numpy()
                 for t in (r.topi, r.topv, r.keep, r.pos))


def _swap(t, pairs, logits, gates, slack, **kw):
    """The pair (o, i) of ``pairs`` whose reference logit gap l_o - l_i is
    largest, with that gap, the gate gap and tau."""
    o, i = max(pairs, key=lambda p: logits[t, p[0]] - logits[t, p[1]])
    return dict(row=int(t), logit_gap=float(logits[t, o] - logits[t, i]),
                gate_gap=float(gates[t, o] - gates[t, i]),
                tau=float(_tau(logits[t, o], logits[t, i], slack)), **kw)


def _route_diff(card, ref, logits, gates, rows, slack):
    """Row by row over ``rows``: a **flip** where the card's chosen set
    differs from the reference's (with the reference's largest logit and
    gate gap between an expert it chose and one the card chose instead,
    and tau); **moved** where the sets agree but the kept experts differ;
    else **held**.  ``card`` and ``ref`` are (topi, topv, keep); ``logits``
    and ``gates`` the reference's (R, E).  The gate mass a row moves is
    half the L1 distance of the two combine weights by expert.  A row
    whose set agrees in another order (which moves capacity slots, rank
    by rank) is also returned among ``reorders``, with its largest swap."""
    flips, moved, held, reorders = [], [], [], []
    for t in rows:
        lc, lr = card[0][t].tolist(), ref[0][t].tolist()
        sc, sr = set(lc), set(lr)
        if sc == sr and lc != lr:
            reorders.append(_swap(t, [(b, a) for x, a in enumerate(lc)
                                      for b in lc[x + 1:]
                                      if lr.index(b) < lr.index(a)],
                                  logits, gates, slack))
        wc = {int(e): float(w) for e, w, k in zip(*(a[t] for a in card)) if k}
        wr = {int(e): float(w) for e, w, k in zip(*(a[t] for a in ref)) if k}
        mass = 0.5 * sum(abs(wc.get(e, 0.0) - wr.get(e, 0.0))
                         for e in sc | sr)
        if sc != sr:
            flips.append(_swap(t, [(o, i) for o in sr - sc for i in sc - sr],
                               logits, gates, slack, card=sorted(sc - sr),
                               ref=sorted(sr - sc), mass=mass))
        elif set(wc) != set(wr):
            moved.append(dict(row=int(t), experts=sorted(set(wc) ^ set(wr)),
                              mass=mass))
        else:
            held.append(int(t))
    return flips, moved, held, reorders


def _flip_str(f) -> str:
    return (f"row {f['row']}: card {f['card']} for reference {f['ref']}, "
            f"reference logit gap {f['logit_gap']:.4g} (tau "
            f"{f['tau']:.4g}), gate gap {f['gate_gap']:.3g}, mass "
            f"{f['mass']:.3g}")


def _moe_ref_forward(mod, xt, topi, topv, keep):
    """The MoE layer in float32 on the card under the reference's own
    routing (numpy (R, K) topi, topv, keep), expert by expert: each
    expert's weights are cast to float32 one at a time, so no float32 copy
    of every expert is made.  xt (R, d) -> (R, d) float32."""
    import torch
    import torch.nn.functional as F

    x = xt.float()
    y = torch.zeros_like(x)
    dev = x.device
    topi_t = torch.from_numpy(topi).to(dev)
    keep_t = torch.from_numpy(keep).to(dev)
    w = torch.from_numpy(np.where(keep, topv, 0.0)).float().to(dev)
    for e in range(mod.w1.shape[0]):
        rows, ks = torch.nonzero((topi_t == e) & keep_t, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        h = F.silu(xe @ mod.w1[e].float()) * (xe @ mod.w3[e].float())
        y.index_add_(0, rows, w[rows, ks, None] * (h @ mod.w2[e].float()))
    if mod.dense is not None:
        dm = mod.dense
        y += (F.silu(x @ dm.w1.float()) * (x @ dm.w3.float())) @ \
            dm.w2.float()
    return y


def _moe_layer_check(model, rec, label):
    """Each of the engine's first MOE_ROUTE_LAYERS MoE layers at full E on
    the MoE input of a PROMPT-token prefill (caught by a forward pre-hook):
    the card's `route` and forward (bf16) against a float32 reference on
    the same input, upcast, which routes by its own scores (lowest-index
    ties, the layer's C) and runs expert by expert on the card.  The card's
    slots must be `repro`'s rule applied to its own choices; every flip a
    near-tie under tau (TAU_LAYER_SLACK); flips at most FLIP_SHARE of the
    rows over the layers; held rows within BF16_TOL of the reference; aux
    within 1e-2 relative plus what the top-1 flips move."""
    import torch
    import torch.nn.functional as F

    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the float32 reference needs TF32 off")
    cfg = model.cfg
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    t0 = time.perf_counter()
    prompt = np.random.default_rng(SEED + 3).integers(0, cfg.vocab,
                                                      (1, PROMPT))
    caught = {}
    hooks = [model.layers[i].mlp.register_forward_pre_hook(
        lambda mod, args, i=i: caught.setdefault(i, args[0].clone()))
        for i in range(MOE_ROUTE_LAYERS)]
    try:
        model.prefill(torch.from_numpy(prompt).to(model.device))
    finally:
        for h in hooks:
            h.remove()
    n_flips, n_rows, out = 0, 0, {}
    for i in range(MOE_ROUTE_LAYERS):
        mod, h = model.layers[i].mlp, caught[i]
        T = h.shape[0] * h.shape[1]
        with torch.inference_mode():
            y, aux = mod(h)
            xt, (G, nG, C) = mod._rows(h, False)
            card = _routing_np(mod._route_rows(xt, G, nG, C))
            logits = xt.float() @ mod.router.float()
            gates = torch.softmax(logits, -1)
            lg_np, g_np = logits.cpu().numpy(), gates.cpu().numpy()
            ref = _ref_route(g_np, K, C, G)
            y_ref = _moe_ref_forward(mod, xt, *ref)
            load = np.bincount(ref[0][:, 0], minlength=E) / len(g_np)
            aux_ref = float(E * (g_np.mean(0) * load).sum())
        if not np.array_equal(_ref_slots(card[0], E, G), card[3]):
            raise AssertionError(f"{label} layer {i}: the card's capacity "
                                 f"slots are not the rule's for its choices")
        flips, moved, held, reorders = _route_diff(
            card[:3], ref, lg_np, g_np, range(T), TAU_LAYER_SLACK)
        far = [f for f in flips + reorders if f["logit_gap"] > f["tau"]]
        rows = torch.tensor(held, device=h.device)
        e = check_close(f"{label} layer {i} MoE output (held rows)",
                        y.reshape(-1, cfg.d_model)[rows], y_ref[rows],
                        BF16_TOL)
        top1 = int((card[0][:T, 0] != ref[0][:T, 0]).sum())
        aux_tol = 1e-2 * aux_ref + 2 * E * float(g_np.mean(0).max()) * \
            top1 / len(g_np)
        mass = max([f["mass"] for f in flips + moved], default=0.0)
        log(f"  {label} layer {i}: {T} rows, E {E}, K {K}, C {C}: {len(flips)}"
            f" flips, {len(reorders)} reordered (worst logit gap / tau "
            f"{max([f['logit_gap'] / f['tau'] for f in reorders], default=0):.3g}),"
            f" {len(moved)} moved, {len(held)} held "
            f"({err_str(y.reshape(-1, cfg.d_model)[rows], y_ref[rows], BF16_TOL)}"
            f"); largest gate mass moved {mass:.3g}; aux {float(aux):.6f} vs "
            f"{aux_ref:.6f} (top-1 changed on {top1} rows, tol "
            f"{aux_tol:.3g})")
        for f in flips:
            log(f"    flip {_flip_str(f)}")
        for m in moved:
            log(f"    moved row {m['row']}: experts {m['experts']}, mass "
                f"{m['mass']:.3g}")
        if far:
            raise AssertionError(f"{label} layer {i}: flips that are no "
                                 f"near-tie: {far}")
        if abs(float(aux) - aux_ref) > aux_tol:
            raise AssertionError(f"{label} layer {i}: aux {float(aux)} vs "
                                 f"{aux_ref}")
        n_flips += len(flips)
        n_rows += T
        out[f"layer {i}"] = dict(flips=flips, moved=moved, held=len(held),
                                 reorders=len(reorders),
                                 C=C, max_abs_err=e, mass=mass,
                                 aux=float(aux), aux_ref=aux_ref)
    log(f"  {label}: {n_flips} flips over {n_rows} rows x layers "
        f"({n_flips / n_rows:.4f}, at most {FLIP_SHARE}); "
        f"{time.perf_counter() - t0:.1f} s")
    rec.setdefault("moe_route", {})[label] = out
    if n_flips > FLIP_SHARE * n_rows:
        raise AssertionError(f"{label}: {n_flips} flips over {n_rows} rows")


class _RouteTap:
    """Forward hooks on every MoE layer of ``blocks`` (or on one template
    block called once a layer, ``per_call``): each call's routing by the
    layer's own `route` (the card's, or the float32 copy's own scores) as
    numpy, with its float32 logits and gates."""

    def __init__(self, blocks, per_call=False):
        self.calls = []
        self.hooks = []
        for i, blk in enumerate(blocks):
            self.hooks.append(blk.mlp.register_forward_pre_hook(
                lambda mod, args, kw, i=i: self._tap(mod, i, args[0], kw),
                with_kwargs=True))
        self.per_call = per_call

    def _tap(self, mod, i, h, kw):
        import torch

        with torch.no_grad():
            no_drop = kw.get("no_drop", False)
            xt, (G, nG, C) = mod._rows(h.detach(), no_drop)
            logits = (xt @ mod.router).float()
            self.calls.append(dict(
                layer=len(self.calls) if self.per_call else i, G=G, C=C,
                logits=logits.cpu().numpy(),
                gates=torch.softmax(logits, -1).cpu().numpy(),
                card=_routing_np(mod._route_rows(xt, G, nG, C))))

    def take(self):
        calls, self.calls = self.calls, []
        return calls

    def close(self):
        for h in self.hooks:
            h.remove()


def _compare_passes(card_calls, ref_calls, K, rows, slack):
    """Per layer of one pass over ``rows``, the card's routing against the
    float32 copy's own (`_ref_route` of its gates): flips, reordered and
    moved rows (the card's slots must be the rule's for its own choices),
    and the flips and reorders that must be near-ties: those at a row t
    that no routing difference of an earlier layer reached (at a row <= t:
    a changed output enters the later layers' causal attention)."""
    layers, first = [], np.inf  # the earliest row differing so far
    for n, (c, r) in enumerate(zip(card_calls, ref_calls)):
        E = r["gates"].shape[-1]
        if not np.array_equal(_ref_slots(c["card"][0], E, c["G"]),
                              c["card"][3]):
            raise AssertionError(f"layer {n}: the card's capacity slots are "
                                 f"not the rule's for its own choices")
        ref = _ref_route(r["gates"], K, r["C"], r["G"])
        flips, moved, _, reorders = _route_diff(
            c["card"][:3], ref, r["logits"], r["gates"], rows, slack)
        diff_rows = sorted({f["row"] for f in flips + reorders} |
                           {m["row"] for m in moved})
        layers.append(dict(flips=flips, moved=moved, reorders=reorders,
                           rows=diff_rows,
                           need_tie=[f for f in flips + reorders
                                     if f["row"] < first]))
        first = min([first] + diff_rows)
    return layers


def _moe_model_check(model, rec, label):
    """The MoE copy ``model`` (bf16, its kernels) against its float32 copy
    on the CPU, each routing by its own scores: a ragged prefill of
    MOE_CHECK_PROMPT tokens, then MOE_DECODE_STEPS decode steps, each of
    which the float32 copy takes from the card's cache (upcast), so a
    step's error is its own.  A step's scored token (the prompt's last
    row, the decoded token) is **reached** where its routing differs in
    some layer, or, at the prefill, where an earlier row's did in a layer
    before the last (its changed output enters the later attention).
    Unreached steps are held at MODEL_REL_TOL; a reached step is held
    too, or excused, at most one, where every flip at its origin is a
    near-tie under tau (TAU_MODEL_SLACK).  The caches the card writes are
    held at MODEL_REL_TOL on the rows no earlier layer's routing
    difference reached."""
    import torch

    from repro_torch.models.transformer import Model

    cfg = model.cfg
    K, nL = cfg.moe.top_k, cfg.n_layers
    t0 = time.perf_counter()
    cpu = Model(dataclasses.replace(cfg, dtype="float32"), device="cpu")
    with torch.no_grad():
        for (_, p), (_, q) in zip(cpu.named_parameters(),
                                  model.named_parameters()):
            p.copy_(q.float().cpu())
    card_tap, cpu_tap = _RouteTap(model.layers), _RouteTap(cpu.layers)
    S = MOE_CHECK_PROMPT
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (1, S)))
    steps, cache_errs, excused = [], [], []
    try:
        lg, cache = model.prefill(toks.to(model.device))
        lc, ccache = cpu.prefill(toks)
        for step in range(MOE_DECODE_STEPS + 1):
            card, ref = card_tap.take(), cpu_tap.take()
            scored = S - 1 if step == 0 else 0
            layers = _compare_passes(card, ref, K,
                                     range(S if step == 0 else 1),
                                     TAU_MODEL_SLACK)
            own = [i for i, lay in enumerate(layers) if scored in lay["rows"]]
            earlier = step == 0 and any(
                any(t < scored for t in lay["rows"]) for lay in layers[:-1])
            reached = bool(own) or earlier
            err = float((lg.float().cpu() - lc).norm() / lc.norm())
            far = [f for lay in layers for f in lay["need_tie"]
                   if f["logit_gap"] > f["tau"]]
            steps.append(dict(step=step, err=err, reached=reached,
                              layers=own, earlier=earlier,
                              flips=[f for lay in layers for f in lay["flips"]]))
            # the cache rows (prefill) or slot (decode) the card wrote,
            # where no earlier layer's difference reached them
            slot = cache.len - 1
            for i in range(nL):
                bad = set().union(*(lay["rows"] for lay in layers[:i])) \
                    if i else set()
                keep = [t for t in (range(S) if step == 0 else [0])
                        if t not in bad]
                if not keep:
                    continue
                pos = keep if step == 0 else [slot]
                for a, b in ((cache.k, ccache.k), (cache.v, ccache.v)):
                    got = a[i, :, :, pos].float().cpu()
                    want = b[i, :, :, pos]
                    cache_errs.append(float((got - want).norm() /
                                            want.norm()))
            if not bool(lg.float().isfinite().all()):
                raise AssertionError(f"{label}: logits not finite")
            if err > MODEL_REL_TOL:
                if not reached or excused or far:
                    raise AssertionError(
                        f"{label}: step {step} off its float32 copy by "
                        f"{err:.3g} (reached {reached}, excused before "
                        f"{excused}, flips that are no near-tie {far})")
                excused.append(step)
            log(f"  {label} step {step} ({'prefill ' + str(S) + ' tokens' if step == 0 else 'decode'}): "
                f"rel L2 err {err:.3g}"
                + (f"; reached (own routing differs in layers {own}"
                   f"{', earlier rows differ' if earlier else ''})"
                   if reached else "")
                + (" EXCUSED" if step in excused else ""))
            for lay_i, lay in enumerate(layers):
                for f in lay["flips"]:
                    log(f"    layer {lay_i} flip {_flip_str(f)}")
                if lay["reorders"] or lay["moved"]:
                    log(f"    layer {lay_i}: {len(lay['reorders'])} "
                        f"reordered, {len(lay['moved'])} moved rows")
            if step == MOE_DECODE_STEPS:
                break
            nxt = lg.argmax(-1)
            with torch.inference_mode():  # the card's past, upcast
                ccache.k.copy_(cache.k.float().cpu())
                ccache.v.copy_(cache.v.float().cpu())
            lg, cache = model.decode_step(cache, nxt)
            lc, ccache = cpu.decode_step(ccache, nxt.cpu())
    finally:
        card_tap.close()
        cpu_tap.close()
    worst_cache = max(cache_errs)
    log(f"  {label}: cache rows and slots written by the card vs its "
        f"float32 copy's: worst rel L2 err {worst_cache:.3g} over "
        f"{len(cache_errs)} (tol {MODEL_REL_TOL}); steps excused {excused}; "
        f"{time.perf_counter() - t0:.1f} s")
    if worst_cache > MODEL_REL_TOL:
        raise AssertionError(f"{label}: cache off by {worst_cache:.3g}")
    rec.setdefault("model_rel_err", {})[label] = [s["err"] for s in steps]
    rec.setdefault("moe_model_check", {})[label] = dict(
        steps=steps, excused=excused, cache_err=worst_cache)


def phase_serve_moe(args, rec):
    """The cohort on granite-moe-1b-a400m (engine-a, full width, 12 of 24
    layers) and arctic-480b (engine-b, full width, all 128 experts, 2 of 35
    layers): first the routing of each engine's first layers at full E
    (`_moe_layer_check`), then a 2-layer granite copy and a 1-layer,
    16-expert arctic copy against float32 on the CPU
    (`_moe_model_check`), then the cohort with its launches exact."""
    import gc

    import torch

    from repro_torch.configs import get_config

    rec.pop("yi_engines", None)
    gc.collect()
    torch.cuda.empty_cache()
    cohort = _cohort()
    tpl = cohort[0]
    t0 = time.perf_counter()
    engines = {}
    for i, (e, (arch, layers)) in enumerate(sorted(MOE_ENGINES.items())):
        full = get_config(arch)
        cfg = full if layers is None else dataclasses.replace(
            full, n_layers=layers)
        engines[e] = _engine(tpl, e, cfg, SEED + 60 + i)
    torch.cuda.synchronize()
    arctic = get_config("arctic-480b")
    per_layer = (arctic.param_count() - 2 * arctic.vocab * arctic.d_model) \
        / arctic.n_layers
    log(f"reduced: arctic-480b depth only, {MOE_ENGINES['engine-b'][1]} of "
        f"{arctic.n_layers} layers (all {arctic.moe.n_experts} experts, top "
        f"{arctic.moe.top_k}: a layer is {per_layer / 1e9:.2f}B parameters, "
        f"{2 * per_layer / 1e9:.1f} GB of bf16; 2 layers and the embeddings "
        f"{(2 * 2 * per_layer + 2 * 2 * arctic.vocab * arctic.d_model) / 1e9:.1f}"
        f" GB, 3 would not fit the card's 80 GB); granite-moe-1b-a400m "
        f"depth only, {MOE_ENGINES['engine-a'][1]} of "
        f"{get_config('granite-moe-1b-a400m').n_layers} layers; weights random from seed {SEED + 60}; init "
        f"{time.perf_counter() - t0:.1f} s")
    for eng in engines.values():
        _moe_layer_check(eng.model, rec, f"{eng.model.cfg.name} {eng.name}")
    for eng in engines.values():
        n, n_exp = MOE_CHECK[eng.model.cfg.name]
        small = _reduced_copy(eng.model, n, n_exp)
        cut = f", first {n_exp} experts" if n_exp else ""
        _moe_model_check(small, rec, f"{eng.model.cfg.name} {eng.name} first "
                         f"{n} layers{cut}")
        del small
        gc.collect()
        torch.cuda.empty_cache()
    _serve_cohort("moe", engines, cohort, rec, args)
    for eng in engines.values():
        _engine_reading(eng.name, eng.model, "moe", rec)
    del engines, eng
    gc.collect()
    torch.cuda.empty_cache()
    _after_serving(args, rec, "serve-moe", cohort)


# ----------------------------------------------------------------------
# phase serve-media: the VLM backbone and the encoder-decoder
# ----------------------------------------------------------------------
# llava-next-34b's copy held against float32 on the CPU (here and in
# train-hybrid): layers, and patch embeddings (64 of its 2880: the float32
# CPU copy's prefill over 2880 + 100 rows would take minutes)
LLAVA_CHECK = (2, 64)
MEDIA_DECODE_STEPS = 8   # decode steps held against float32
WHISPER_BATCH = 4        # requests served at once
WHISPER_CHECK_BATCH = 2
WHISPER_PROMPT = 64      # + MAX_NEW tokens, within its 448-token context


def _timed_greedy(model, prefill, steps: int):
    """``prefill()`` -> (logits, cache), then ``steps`` greedy decode steps
    of ``model``, synchronised -> (tokens (B, steps), prefill s, decode
    s, cache)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill()
    cur = logits.argmax(-1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    outs = []
    for _ in range(steps):
        outs.append(cur)
        logits, cache = model.decode_step(cache, cur)
        cur = logits.argmax(-1)
    out = torch.stack(outs, dim=1).cpu().numpy()
    torch.cuda.synchronize()
    return out, t1 - t0, time.perf_counter() - t1, cache


def _media_path(rec, path, name, model, run, what, vocab):
    """One timed request of ``model`` (``run(steps)`` -> (tokens, prefill
    s, decode s, cache): a prefill, then ``steps`` greedy steps) after an
    untimed one, its launches counted from zero and exact
    (`_expected_launches`), recorded as ``rec["paths"][path]``; returns
    the cache."""
    import torch

    from repro_torch.kernels import _build

    run(2)  # warm-up: cuBLAS handles, allocator
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    out, ttft, dec, cache = run(MAX_NEW)
    launches = dict(_build.LAUNCHES)
    expect = {k: 0 for k in KERNELS}
    expect.update(_expected_launches(model.cfg, 1))
    log(f"  launches of {path}: {launches} (expected {expect})")
    if launches != expect or out.shape[1] != MAX_NEW or out.min() < 0 or \
            out.max() >= vocab:
        raise AssertionError(f"{path}: the request's launches or tokens are "
                             f"off")
    rec.setdefault("paths", {})[path] = dict(
        launches=launches, max_memory_allocated_gb=torch.cuda.
        max_memory_allocated() / 1e9, engines={name: dict(
            invocations=1, batch=out.shape[0], prefill_ms=ttft * 1e3,
            decode_ms_per_token=dec * 1e3 / MAX_NEW, stage_s=ttft + dec)})
    _engine_reading(name, model, path, rec, what)
    return cache


def phase_serve_media(args, rec):
    """llava-next-34b (the VLM backbone) at full width and depth: its
    first LLAVA_CHECK[0] layers (drawn from the same seed before the
    engine) against float32 on the CPU over a prefill with patches and
    MEDIA_DECODE_STEPS decode steps, then one text-only stage invocation
    through the engine and one image request (2880 patch embeddings and a
    PROMPT-token prompt) through `Model.prefill` and MAX_NEW greedy steps;
    then whisper-base whole: against float32 on the CPU at
    WHISPER_CHECK_BATCH, and a batch of WHISPER_BATCH requests (1500
    frames, a WHISPER_PROMPT-token prompt, MAX_NEW greedy steps).
    Launches exact throughout."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import EncDecModel

    rec.pop("yi_engines", None)
    gc.collect()
    torch.cuda.empty_cache()
    cohort = _cohort()
    tpl = cohort[0]
    full = get_config("llava-next-34b")
    seed = SEED + 70
    n, P = LLAVA_CHECK
    small = _engine(tpl, "engine-a", dataclasses.replace(full, n_layers=n),
                    seed).model
    log(f"reduced: the {n}-layer copy held on the CPU takes {P} of "
        f"{full.vlm.n_patches} patch embeddings")
    _model_check(small, rec, f"llava-next-34b first {n} layers", 100,
                 patches=P, steps=MEDIA_DECODE_STEPS)
    del small
    gc.collect()
    torch.cuda.empty_cache()
    eng = _engine(tpl, "engine-a", full, seed)
    log(f"reduced: nothing (all {full.n_layers} layers, full width); "
        f"weights random from seed {seed}; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    prompt = np.random.default_rng(SEED).integers(0, full.vocab, (1, PROMPT))
    toks = torch.from_numpy(prompt).cuda()
    # the text-only stage invocation, as the engine serves it
    _media_path(rec, "llava-next-34b", eng.name, eng.model,
                lambda n: (*eng.generate(prompt, max_new=n), None),
                f"{PROMPT} tokens", full.vocab)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    patches = torch.randn(1, full.vlm.n_patches, full.vlm.patch_dim,
                          generator=g, device="cuda")
    cache = _media_path(
        rec, "llava-next-34b image", eng.name, eng.model,
        lambda n: _timed_greedy(eng.model, lambda: eng.model.prefill(
            toks, patches), n),
        f"{full.vlm.n_patches} patches + {PROMPT} tokens", full.vocab)
    slots = full.vlm.n_patches + PROMPT
    if (cache.len, cache.k.shape[3]) != (slots + MAX_NEW, slots + 64):
        raise AssertionError(f"llava image cache: len {cache.len} of "
                             f"{cache.k.shape[3]} slots")
    del eng, cache
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_config("whisper-base")
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    model = EncDecModel(cfg, device="cuda").init(gen)
    T = cfg.encdec.encoder_len
    log(f"whisper-base whole (d {cfg.d_model}, {cfg.encdec.n_encoder_layers}"
        f" + {cfg.n_layers} layers, vocab {cfg.vocab}, bf16): "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f}B "
        f"parameters; frames random (its conv frontend is a stub)")
    _encdec_check(model, rec, "whisper-base", WHISPER_CHECK_BATCH,
                  WHISPER_PROMPT, MEDIA_DECODE_STEPS)
    frames = torch.randn(WHISPER_BATCH, T, cfg.d_model, generator=gen,
                         device="cuda")
    wtoks = torch.from_numpy(np.random.default_rng(SEED + 4).integers(
        0, cfg.vocab, (WHISPER_BATCH, WHISPER_PROMPT))).cuda()
    cache = _media_path(
        rec, "whisper-base", "whisper", model,
        lambda n: _timed_greedy(model, lambda: model.prefill(frames, wtoks),
                                n),
        f"B {WHISPER_BATCH}: {T} frames encoded + {WHISPER_PROMPT} tokens",
        cfg.vocab)
    if cache.xk.shape[3] != T or cache.len != WHISPER_PROMPT + MAX_NEW:
        raise AssertionError("whisper cache: cross slots or length off")
    del model, cache
    gc.collect()
    torch.cuda.empty_cache()
    _after_serving(args, rec, "serve-media", cohort)


# ----------------------------------------------------------------------
# phases train, train-ssm, train-hybrid: a few steps of a full-width model
# on the card
# ----------------------------------------------------------------------
# phase -> (arch, layers (None: all), (batch, sequence), steps)
TRAIN_PATHS = {"train": ("yi-9b", 12, (2, 2048), 4),
               "train-ssm": ("mamba2-1.3b", None, (1, 2048), 3),
               "train-hybrid": ("zamba2-2.7b", None, (1, 2048), 3),
               # run by phase train-hybrid: tokens over 1500 frames each
               "train-audio": ("whisper-base", None, (2, 448), 3)}
# the token source: MarkovLMData's V**kgram x V table cannot be built at a
# real vocabulary (2.6e14 entries at Yi-9B's 64000), so the tokens come
# from 256 symbols, kgram 2, and enter the full embedding; the loss still
# runs over the whole padded vocabulary (a cut, PERF.md section 4)
TRAIN_DATA = (256, 2)
# the reduced copy held against float32 on the CPU: layers, (batch, seq)
TRAIN_CHECK = (2, (1, 256))


def _token_batch(cfg, B: int, S: int, seed: int, patches: int = 0) -> dict:
    """A (B, S) batch of the Markov source; with an encoder, B x T random
    frames beside it, and with ``patches``, a VLM's B x patches random
    patch embeddings (numpy float32, unit normals from ``seed``)."""
    from repro_torch.data import DataConfig, MarkovLMData

    vocab, kgram = TRAIN_DATA
    batch = MarkovLMData(DataConfig(vocab=vocab, seq_len=S, batch=B,
                                    seed=seed, kgram=kgram)).next_batch()
    rng = np.random.default_rng(seed)
    if cfg.encdec is not None:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encdec.encoder_len, cfg.d_model)).astype(np.float32)
    if patches:
        batch["patch_embeds"] = rng.standard_normal(
            (B, patches, cfg.vlm.patch_dim)).astype(np.float32)
    return batch


def _train_launches(cfg) -> dict:
    """Kernel launches of one loss-and-gradient of ``cfg``.  The forward
    launches, a layer: dense and MoE, one flash and 2 RMSNorms (4 with
    MLA's latent norms); SSM and hybrid, one SSD scan and 2 RMSNorms; and a
    hybrid group's shared block one flash and 2 RMSNorms; then the final
    norm, once.  ``remat="full"`` checkpoints each layer, so its forward
    runs again in the backward; the hybrid checkpoints each group too, so
    a group's forward runs once more (its layers' checkpointed bodies
    included) and each Mamba layer runs three times, its shared block
    twice (the final norm sits outside every checkpoint).  The
    encoder-decoder's forward launches L_e + 2L flash (encoder, decoder
    self and cross) and 2L_e + 3L RMSNorms in its layers, each checkpointed
    under remat, and ``enc_norm`` and the final norm outside them.  One
    flash backward an attention; the RMSNorm and SSD backwards recompute
    their plain versions and launch nothing."""
    L = cfg.n_layers
    full = cfg.remat == "full"
    out = {k: 0 for k in KERNELS}
    if cfg.encdec is not None:
        Le = cfg.encdec.n_encoder_layers
        r = 2 if full else 1
        out.update(flash_attention=r * (Le + 2 * L),
                   flash_attention_bwd=Le + 2 * L,
                   rms_norm=r * (2 * Le + 3 * L) + 2)
    elif _n_attn(cfg) == L:
        r = 2 if full else 1
        norms = 4 if cfg.attn_kind == "mla" else 2
        out.update(flash_attention=r * L, flash_attention_bwd=L,
                   rms_norm=r * norms * L + 1)
    elif cfg.family == "ssm":
        r = 2 if full else 1
        out.update(ssd_scan=r * L, rms_norm=r * 2 * L + 1)
    else:
        G = L // cfg.hybrid.attn_every
        r_layer, r_group = (3, 2) if full else (1, 1)
        out.update(ssd_scan=r_layer * L, flash_attention=r_group * G,
                   flash_attention_bwd=G,
                   rms_norm=r_layer * 2 * L + r_group * 2 * G + 1)
    return out


def _pipe_launches(cfg, n_stages: int, n_micro: int, stage: int) -> dict:
    """Kernel launches of one pipelined loss-and-gradient on stage
    ``stage`` of ``n_stages`` (`repro_torch.dist.pipeline_runs`): each of
    the stage's L / n_stages layers runs forward at every one of the
    n_micro + n_stages - 1 ticks, and backward (under ``remat="full"`` its
    forward again first) at every tick but the last, the last stage's at
    every tick; the final norm runs once, on the replicated result.  A
    layer's forward is what remat adds to `_train_launches`."""
    ticks = n_micro + n_stages - 1
    back = ticks - 1 + (stage == n_stages - 1)
    one = dataclasses.replace(cfg, n_layers=1)
    train = _train_launches(one)
    full, plain = (_train_launches(dataclasses.replace(one, remat=r))
                   for r in ("full", "none"))
    fwd = {k: full[k] - plain[k] for k in full}
    per = cfg.n_layers // n_stages
    norm = {k: int(k == "rms_norm") for k in train}
    return {k: per * (back * (train[k] - norm[k]) + (ticks - back) * fwd[k])
            + norm[k] for k in train}


def _train_check(model, label, rec):
    """A copy of ``model`` cut to its first TRAIN_CHECK layers (the
    hybrid: one group of attn_every layers; shared weights whole), held by
    `_hold_train_copy`; the encoder-decoder whole, at its train path's
    batch."""
    import torch

    from repro_torch.models.transformer import TrainModel

    cfg = model.cfg
    if cfg.encdec is not None:
        _hold_train_copy(model, label, rec, TRAIN_PATHS["train-audio"][2])
        return
    n = cfg.hybrid.attn_every if cfg.family == "hybrid" else TRAIN_CHECK[0]
    small = TrainModel(dataclasses.replace(cfg, n_layers=n), device="cuda")
    with torch.no_grad():
        for k, p in small.masters.items():
            p.copy_(model.masters[k][:n] if k.startswith("layers@") else
                    model.masters[k])
    _hold_train_copy(small, label, rec, TRAIN_CHECK[1])
    del small


def _hold_train_copy(small, label, rec, shape, patches: int = 0):
    """One loss-and-gradient of ``small`` on a ``shape`` batch on the card
    (a VLM's with ``patches`` patch embeddings, an encoder-decoder's with
    its frames), its launches exact (`_train_launches`), and on its
    float32 CPU copy: the loss and every gradient leaf within
    MODEL_REL_TOL, relative L2.
    A MoE copy's loss carries 0.01 aux (held with it); each routes by its
    own scores, and where some row's routing differs (`_compare_passes`:
    every flip or reorder no earlier difference reached must be a
    near-tie under tau, TAU_MODEL_SLACK), the differing rows' gradients
    reach every leaf through the backward, so each leaf is held at
    FLIP_GRAD_TOL instead and printed with the flips, with the worst
    expert slices of the experts those rows chose."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.train.step import value_and_grad

    B, S = shape
    cfg = small.cfg
    t0 = time.perf_counter()
    cpu = build_model(dataclasses.replace(cfg, dtype="float32"),
                      device="cpu", train=True)
    with torch.no_grad():
        for k, p in small.masters.items():
            cpu.masters[k].copy_(p.cpu())
    batch = _token_batch(cfg, B, S, SEED + 1, patches)
    taps = [_RouteTap([m._block], per_call=True) for m in (small, cpu)] \
        if cfg.moe is not None else []
    try:
        _build.reset_launches()
        t1 = time.perf_counter()
        loss, met, grads = value_and_grad(small, batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches, expect = dict(_build.LAUNCHES), _train_launches(cfg)
        if launches != expect:
            raise AssertionError(f"{label}: launches of the copy's "
                                 f"loss-and-gradient {launches} != {expect}")
        want, wmet, wgrads = value_and_grad(cpu, batch)
    finally:
        for t in taps:
            t.close()
    errs = {"loss": abs(float(loss) - float(want)) / abs(float(want))}
    for k, g in wgrads.items():
        got = grads[k].float().cpu()
        if not bool(got.isfinite().all()):
            raise AssertionError(f"{label}: gradient {k} is not finite")
        errs[k] = float((got - g).norm() / g.norm().clamp(min=1e-30))
    tol, diff = MODEL_REL_TOL, []
    if taps:  # the forward's calls, one a layer (remat recomputes follow)
        layers = _compare_passes(*(t.calls[:cfg.n_layers] for t in taps),
                                 cfg.moe.top_k, range(B * S),
                                 TAU_MODEL_SLACK)
        diff = [r for lay in layers for r in lay["rows"]]
        far = [f for lay in layers for f in lay["need_tie"]
               if f["logit_gap"] > f["tau"]]
        log(f"  {label}: aux {float(met['aux']):.6f} vs {float(wmet['aux']):.6f}"
            f"; routing per layer (flips / reordered / moved rows of "
            f"{B * S}): " + ", ".join(
                f"{len(lay['flips'])} / {len(lay['reorders'])} / "
                f"{len(lay['moved'])}" for lay in layers))
        for n, lay in enumerate(layers):
            for f in lay["need_tie"]:
                if "card" in f:  # reorders only counted
                    log(f"    layer {n} flip {_flip_str(f)}")
        if far:
            raise AssertionError(f"{label}: flips no earlier difference "
                                 f"reached that are no near-tie: {far}")
        if diff:
            tol = FLIP_GRAD_TOL
            touched = sorted({int(e) for t in taps[0].calls[:cfg.n_layers]
                              for r in set(diff) if r < B * S
                              for e in t["card"][0][r]})
            for k in ("layers@mlp@w1", "layers@mlp@w2", "layers@mlp@w3"):
                g, w = grads[k].float().cpu(), wgrads[k]
                per = {e: float((g[:, e] - w[:, e]).norm() /
                                w[:, e].norm().clamp(min=1e-30))
                       for e in touched}
                e = max(per, key=per.get)
                log(f"    {k}: {len(touched)} experts chosen by differing "
                    f"rows, worst slice expert {e} {per[e]:.3g}, whole "
                    f"leaf {errs[k]:.3g}")
    worst = max(errs, key=errs.get)
    rec.setdefault("train_rel_err", {})[label] = errs
    extra = (f" + {patches} patches" if patches else "") + (
        f" over {cfg.encdec.encoder_len} frames" if cfg.encdec else "")
    depth = (f"{cfg.encdec.n_encoder_layers} + {cfg.n_layers}-layer model"
             if cfg.encdec else f"{cfg.n_layers}-layer copy")
    log(f"  {label}: {depth}, one step on ({B},{S}) "
        f"tokens{extra} vs its float32 CPU copy: loss {float(loss):.6f} vs "
        f"{float(want):.6f} (tol {MODEL_REL_TOL}), relative L2 err: worst "
        f"{worst} {errs[worst]:.3g} over {len(errs)} leaves (tol {tol}"
        f"{', routing differs' if diff else ''}); launches {launches} "
        f"(exact); copies {t1 - t0:.1f} s, card step {t2 - t1:.1f} s, "
        f"float32 CPU step and comparison {time.perf_counter() - t2:.1f} s")
    if errs["loss"] > MODEL_REL_TOL or errs[worst] > tol:
        raise AssertionError(f"{label}: {worst} off its float32 CPU copy by "
                             f"{errs[worst]:.3g}")
    del cpu, grads, wgrads


# the dense, MoE and VLM families' one-step checks (phase train-hybrid): a
# full-width copy of FAMILY_TRAIN_LAYERS drawn from a seed, on a
# FAMILY_TRAIN_SHAPE batch, against float32 on the CPU.  That CPU step is
# most of the phase's time, so qwen2-72b's copy (3.4B parameters at one
# layer) and arctic-480b's (2.3B at 16 experts) are left out: mistral's
# and llava's copies train their attention's G and head dim, granite's a
# MoE, and serve-dense and serve-moe hold both models' forward
FAMILY_TRAIN = ("mistral-nemo-12b", "minicpm3-4b", "granite-moe-1b-a400m",
                "llava-next-34b")
FAMILY_TRAIN_LAYERS = 1
FAMILY_TRAIN_SHAPE = (1, 128)


def _step_flops(cfg, n_mat: int, B: int, S: int) -> float:
    """Model FLOPs of one train step on (B, S) tokens: 6 an active matrix
    parameter a token (of ``n_mat``, a MoE layer's experts count K of E),
    and 12 a causal pair a query head dim for each attention (dense, MoE
    and VLM: every layer; hybrid: each shared-block application; SSM:
    none).  The encoder-decoder's encoder matrices and its decoder's cross
    keys and values run over the B T frames, its other matrices over the
    B S tokens; its encoder attends T^2 pairs, each cross attention S T
    and each decoder self attention the causal pairs of S."""
    from repro_torch.kernels import cost

    if cfg.encdec is not None:
        T, Le, L = cfg.encdec.encoder_len, cfg.encdec.n_encoder_layers, \
            cfg.n_layers
        d, hd, H, KV = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        enc_mat = Le * (d * hd * (2 * H + 2 * KV) + 3 * d * cfg.d_ff)
        cross_kv = L * 2 * d * KV * hd
        mats = 6.0 * ((enc_mat + cross_kv) * B * T +
                      (n_mat - enc_mat - cross_kv) * B * S)
        pairs = Le * T * T + L * (cost.attn_pairs(S, S, True, 0) + S * T)
        return mats + 12.0 * pairs * hd * H * B
    if cfg.moe is not None:
        mo = cfg.moe
        n_mat -= cfg.n_layers * (mo.n_experts - mo.top_k) * 3 * \
            cfg.d_model * cfg.d_ff
    return 6.0 * n_mat * B * S + 12.0 * cost.attn_pairs(S, S, True, 0) * \
        cfg.head_dim * cfg.n_heads * _n_attn(cfg) * B


def _train_path(phase, rec, args):
    """Train a full-width model on the card for a few steps on one repeated
    batch: every gradient present, finite and nonzero, the loss falling,
    launches per step exact; step time, tokens/s, model-FLOP share, peak
    memory and one profiled step logged."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.train import OptConfig, TrainConfig, make_train_step
    from repro_torch.train.step import value_and_grad

    arch, layers, (B, S), steps = TRAIN_PATHS[phase]
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    model = build_model(cfg, device="cuda", train=True).init(gen)
    n_par = sum(p.numel() for p in model.masters.values())
    n_mat = n_par - model.masters["embed"].numel()
    torch.cuda.synchronize()
    log(f"{phase}: {arch} at full width (d {cfg.d_model}, vocab {cfg.vocab}, "
        f"bf16 compute, float32 masters), {cfg.n_layers} layers, "
        f"{n_par / 1e9:.2f}B parameters, remat {cfg.remat}; init "
        f"{time.perf_counter() - t0:.1f} s")
    frames = (f" over {cfg.encdec.encoder_len} random frames each"
              if cfg.encdec else "")
    log(f"reduced: {'depth only, ' if layers else ''}tokens from "
        f"MarkovLMData(vocab={TRAIN_DATA[0]}, kgram={TRAIN_DATA[1]}) into "
        f"the full {model.masters['embed'].shape[0]}-row embedding; batch "
        f"({B},{S}){frames}; {steps} steps on one repeated batch")
    _train_check(model, f"{phase} {arch}", rec)
    batch = _token_batch(cfg, B, S, SEED)
    init_state, step = make_train_step(model, TrainConfig(
        opt=OptConfig(warmup_steps=1)))
    params = model.params()
    state = init_state(params)
    expect = _train_launches(cfg)

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    _, _, grads = value_and_grad(model, batch)
    torch.cuda.synchronize()
    bad = [k for k, p in params.items() if p.grad is None or not bool(
        p.grad.isfinite().all()) or not bool((p.grad != 0).any())]
    if bad:
        raise AssertionError(f"{phase}: gradients missing, zero or not "
                             f"finite: {bad}")
    if dict(_build.LAUNCHES) != expect:
        raise AssertionError(f"{phase}: launches of a loss-and-gradient "
                             f"{dict(_build.LAUNCHES)} != {expect}")
    log(f"  every one of {len(params)} gradient leaves present, finite and "
        f"nonzero; launches of one step {expect}")
    del grads
    for p in params.values():
        p.grad = None

    _build.reset_launches()
    losses, times = [], []
    for i in range(steps):
        before = dict(_build.LAUNCHES)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        losses.append(float(m["loss"]))
        got = {k: _build.LAUNCHES[k] - before[k] for k in before}
        if got != expect:
            raise AssertionError(f"{phase}: step {i + 1} launched {got}, "
                                 f"expected {expect}")
        log(f"  step {i + 1}: loss {losses[-1]:.6f} grad_norm "
            f"{float(m['grad_norm']):.6g} lr {float(m['lr']):.3g} "
            f"{times[-1] * 1e3:.1f} ms")
    launches = dict(_build.LAUNCHES)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: the loss did not fall: {losses}")
    step_s = float(np.median(times[1:]))
    flops = _step_flops(cfg, n_mat, B, S)
    peak = torch.cuda.max_memory_allocated() / 1e9
    out = dict(launches=launches, per_step=expect, losses=losses,
               step_ms=step_s * 1e3, step_ms_all=[t * 1e3 for t in times],
               tokens_per_s=B * S / step_s, model_flops=flops,
               mfu=flops / step_s / BF16_OPS, max_memory_allocated_gb=peak,
               params=n_par)
    rec.setdefault("paths", {})[phase] = out
    log(f"  {phase}: step {out['step_ms']:.1f} ms (median of steps 2-"
        f"{steps}), {out['tokens_per_s']:.0f} tokens/s, model FLOPs "
        f"{flops / 1e12:.2f} T a step = {out['mfu']:.3f} of 989 TFLOP/s, "
        f"peak memory {peak:.2f} GB, losses {[round(x, 4) for x in losses]}")
    _profile_call(f"{phase} step", lambda: step(params, state, batch), rec,
                  "one train step")
    del model, params, state, m
    torch.cuda.empty_cache()


def phase_train(args, rec):
    _train_path("train", rec, args)


def phase_train_ssm(args, rec):
    _train_path("train-ssm", rec, args)


def phase_train_hybrid(args, rec):
    """Zamba2-2.7B's train path, then one step of a full-width copy of
    each dense, MoE and VLM family (the flash backward at MLA's head dim
    96, at granite's 64, at llava's G = 7 over patches and text) against
    float32 on the CPU, launches exact; then whisper-base's train path
    (its encoder's and cross attention's non-causal backward)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TrainModel

    _train_path("train-hybrid", rec, args)
    for i, arch in enumerate(FAMILY_TRAIN):
        cfg = dataclasses.replace(get_config(arch),
                                  n_layers=FAMILY_TRAIN_LAYERS)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 50 + i)
        small = TrainModel(cfg, device="cuda").init(gen)
        patches = LLAVA_CHECK[1] if cfg.vlm is not None else 0
        _hold_train_copy(small, f"train {arch}", rec, FAMILY_TRAIN_SHAPE,
                         patches)
        del small
        torch.cuda.empty_cache()
    _train_path("train-audio", rec, args)


# ----------------------------------------------------------------------
# train-sharded: FSDP-style sharded training (repro_torch.dist.fsdp)
# (arch, layers, (batch, sequence), steps): full width, depth cut; 2
# steps, so each run writes one 10.4 GB checkpoint (was 3 steps and two,
# a cut made for phase train-pipe)
SHARDED_TRAIN = ("yi-9b", 2, (2, 2048), 2)
SHARDED_TRAIN_CKPT = 2         # the gloo run checkpoints at this step
SHARDED_TRAIN_WORLD = 2        # gloo ranks on cuda:0
# relative: loss, grad norm, parameter movement (tests/test_dist.py's)
SHARDED_TRAIN_TOL = (2e-4, 1e-3, 0.05)
SHARDED_TRAIN_BUDGET_S = 120.0


def _sharded_single(cfg, tcfg, dcfg, key, steps, expect):
    """Part (a): the single-device step on cuda:0 in this process, on the
    masters drawn from ``key`` and the Markov source's first ``steps``
    batches; launches per step exact.  Returns ((loss, grad norm) a
    step, the parameter movement, step seconds, the peak GB of the steps
    above what the process held before the model)."""
    import torch

    from repro_torch.data import MarkovLMData
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.train import make_train_step

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = build_model(cfg, device="cuda", train=True).init(
        torch.Generator(device="cuda").manual_seed(key))
    init, step = make_train_step(model, tcfg)
    params = model.params()
    state = init(params)
    before = {k: p.detach().clone() for k, p in params.items()}
    data = MarkovLMData(dcfg)
    out, times = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        batch = data.next_batch()
        launches = dict(_build.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = {k: _build.LAUNCHES[k] - launches[k] for k in launches}
        if got != expect:
            raise AssertionError(f"train-sharded (a): step {i + 1} launched "
                                 f"{got}, expected {expect}")
        out.append((float(m["loss"]), float(m["grad_norm"])))
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    moved = sum(float(torch.sum((p.detach().double() - before[k].double())
                                ** 2)) for k, p in params.items())
    del model, params, state, before, m
    torch.cuda.empty_cache()
    return out, moved, times, peak_gb


def _check_sharded_run(label, rec_out, measures, single, moved, steps,
                       expect, collectives):
    """A sharded run against part (a): every step's loss and grad norm and
    the movement within SHARDED_TRAIN_TOL, launches per rank exact
    (``steps`` x ``expect``), collectives per step and rank exact."""
    tl, tg, tm = SHARDED_TRAIN_TOL
    got = [(m["loss"], m["grad_norm"]) for m in rec_out["metrics"]]
    for i, ((loss, gn), (wl, wg)) in enumerate(zip(got, single)):
        if abs(loss - wl) > tl * abs(wl) or abs(gn - wg) > tg * abs(wg):
            raise AssertionError(f"{label}: step {i + 1} loss {loss} grad "
                                 f"norm {gn}, single device {wl} / {wg}")
    if len(got) != steps or abs(rec_out["movement"] - moved) > tm * moved:
        raise AssertionError(f"{label}: {len(got)} steps, movement "
                             f"{rec_out['movement']} vs {moved}")
    want = {k: steps * v for k, v in expect.items()}
    for r, m in enumerate(measures):
        if m["launches"] != want:
            raise AssertionError(f"{label}: rank {r} launched "
                                 f"{m['launches']}, expected {want}")
        per = [s["collectives"] for s in m["steps"]]
        if per != [collectives] * steps:
            raise AssertionError(f"{label}: rank {r} collectives a step "
                                 f"{per}, predicted {collectives}")
    return got


def phase_train_sharded(args, rec):
    """FSDP-style sharded training on the card (`repro_torch.dist.fsdp`,
    ``train(mesh=)``): Yi-9B at full width, SHARDED_TRAIN's 2 layers,
    float32 masters, AdamW, remat, a (2, 2048) batch a step from the
    Markov source, 2 steps.  (a) the single-device step on cuda:0 in this
    process; (b) SHARDED_TRAIN_WORLD ranks on cuda:0 over gloo (NCCL
    refuses two ranks on one card; every collective goes through host
    copies), ``("data",)`` mesh, ``train(mesh=)`` checkpointing at step
    SHARDED_TRAIN_CKPT (its last); (c) the same at world size 1 over
    NCCL in this process (`one_rank_group`), and there (d) a restore of
    (b)'s step-2 checkpoint onto that mesh (``restore(shardings=)``), whose
    every gathered leaf must equal the restore onto no mesh bit for bit.
    (b) and (c) are held to (a) within SHARDED_TRAIN_TOL, every rank's
    losses equal (one digest), launches per rank and step exact
    (`_train_launches`), collectives per step exact
    (`sharded_step_collectives`)."""
    import shutil
    import tempfile
    import types

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, MarkovLMData
    from repro_torch.dist import lane_mesh, one_rank_group, spawn
    from repro_torch.dist.train_runs import leaf_digests, run_train_cases
    from repro_torch.kernels import _build
    from repro_torch.models import param_shapes
    from repro_torch.train import (CheckpointManager, LoopConfig, OptConfig,
                                   TrainConfig)
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import sharded_step_collectives

    smi = rec["smi"]
    t_phase = time.perf_counter()
    _build.extension()  # the ranks load this build, never compile
    arch, layers, (B, S), steps = SHARDED_TRAIN
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    vocab, kgram = TRAIN_DATA
    dcfg = DataConfig(vocab=vocab, seq_len=S, batch=B, seed=SEED,
                      kgram=kgram)
    tcfg = TrainConfig(opt=OptConfig(warmup_steps=1))
    key = SEED + 70
    expect = _train_launches(cfg)
    n_par = sum(int(np.prod(s)) for s in param_shapes(cfg).values())
    log(f"train-sharded: {arch} at full width (d {cfg.d_model}, vocab "
        f"{cfg.vocab}), {layers} of {get_config(arch).n_layers} layers, "
        f"{n_par / 1e9:.3f}B parameters ({4 * n_par / 1e9:.2f} GB of "
        f"float32 masters), AdamW, remat {cfg.remat}, ({B},{S}) a step "
        f"from MarkovLMData(vocab={vocab}, kgram={kgram}), {steps} steps")
    log("reduced: depth only (2 of 48 layers); one card, so the gloo ranks "
        "share it and NCCL runs at world size 1")

    single, moved, t_single, peak_a = _sharded_single(cfg, tcfg, dcfg, key,
                                                      steps, expect)
    log(f"  [{smi}] (a) single device: step ms "
        f"{[round(t * 1e3, 1) for t in t_single]}, peak {peak_a:.2f} GB "
        f"above the process's own, losses "
        f"{[round(x, 6) for x, _ in single]}, grad norms "
        f"{[round(g, 6) for _, g in single]}, movement {moved:.6g}")

    tmp = tempfile.mkdtemp(prefix="repro_torch_train_sharded_")
    try:
        def loop_case(mesh, d, every):
            return dict(kind="loop", mesh=mesh, cfg=cfg, key=key, tcfg=tcfg,
                        data=dcfg, lcfg=LoopConfig(
                            total_steps=steps, ckpt_every=every, keep=2,
                            ckpt_dir=os.path.join(tmp, d), log_every=100))

        world = SHARDED_TRAIN_WORLD
        mesh_b = ((world,), ("data",))
        pred_b = sharded_step_collectives(cfg, tcfg, types.SimpleNamespace(
            axis_names=("data",), shape={"data": world}))
        t0 = time.perf_counter()
        gl = spawn(run_train_cases, world, device="cuda", backend="gloo",
                   args=([loop_case(mesh_b, "gloo", SHARDED_TRAIN_CKPT)],
                         time.time()), timeout_s=120.0, deadline_s=600.0)
        wall_b = time.perf_counter() - t0
        if len(set(gl["digests"])) != 1:
            raise AssertionError(f"train-sharded (b): the ranks disagree: "
                                 f"{gl['digests']}")
        rb, mb = gl["records"][0], [m[0] for m in gl["measures"]]
        got_b = _check_sharded_run("train-sharded (b) gloo", rb, mb, single,
                                   moved, steps, expect, pred_b)
        _log_sharded(f"(b) gloo, {world} ranks on cuda:0", got_b, rb, mb,
                     gl["times"], wall_b, smi)

        pred_c = sharded_step_collectives(cfg, tcfg, types.SimpleNamespace(
            axis_names=("data",), shape={"data": 1}))
        restore = dict(kind="restore", mesh=((1,), ("data",)), cfg=cfg,
                       tcfg=tcfg, data=dcfg, dir=os.path.join(tmp, "gloo"),
                       step=SHARDED_TRAIN_CKPT)
        torch.cuda.set_device(0)
        t0 = time.perf_counter()
        with one_rank_group("nccl", timeout_s=120.0):
            nc = run_train_cases(lane_mesh(1, device="cuda"),
                                 [loop_case(((1,), ("data",)), "nccl", steps),
                                  restore])
        wall_c = time.perf_counter() - t0
        rc, mc = nc["records"][0], [m[0] for m in nc["measures"]]
        got_c = _check_sharded_run("train-sharded (c) nccl", rc, mc, single,
                                   moved, steps, expect, pred_c)
        _log_sharded("(c) nccl, world size 1", got_c, rc, mc, nc["times"],
                     wall_c, smi)

        # (d): the gloo run's checkpoint onto world size 1 against the
        # restore onto no mesh
        t0 = time.perf_counter()
        meta = {k: torch.empty(s, device="meta")
                for k, s in param_shapes(cfg).items()}

        def host(tree):
            return {k: host(v) for k, v in tree.items()} \
                if isinstance(tree, dict) else np.empty(0)

        target = {"params": host(meta),
                  "state": {"opt": host(make_optimizer(tcfg.opt)[0](meta))},
                  "data": MarkovLMData(dcfg).checkpoint_state()}
        want = leaf_digests(CheckpointManager(os.path.join(tmp, "gloo"))
                            .restore(SHARDED_TRAIN_CKPT, target))
        got = nc["records"][1]["digests"]
        if got != want:
            bad = sorted(k for k in want if got.get(k) != want[k])
            raise AssertionError(f"train-sharded (d): the restore onto the "
                                 f"NCCL mesh differs from the unsharded one "
                                 f"at {bad}")
        rd = nc["measures"][0][1]
        log(f"  [{smi}] (d) the gloo run's step-{SHARDED_TRAIN_CKPT} "
            f"checkpoint restored onto world size 1 over NCCL "
            f"(restore(shardings=)) in {rd['restore_s']:.1f} s, gathered "
            f"in {rd['gather_s']:.1f} s: {len(want)} leaves equal bit for "
            f"bit to the restore onto no mesh "
            f"({time.perf_counter() - t0:.1f} s)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    total = time.perf_counter() - t_phase
    log(f"[{smi}] train-sharded: {total:.1f} s (budget "
        f"{SHARDED_TRAIN_BUDGET_S:.0f} s): gloo group {wall_b:.1f} s, NCCL "
        f"group {wall_c:.1f} s"
        + ("" if total <= SHARDED_TRAIN_BUDGET_S else "; OVER ITS BUDGET"))
    launches = {k: steps * v for k, v in expect.items()}
    for m in mb + mc:
        launches = {k: launches[k] + m["launches"][k] for k in launches}
    rec.setdefault("paths", {})["train-sharded"] = dict(
        launches=launches, per_step=expect, single=single, single_s=t_single,
        single_peak_gb=peak_a, steps=steps,
        gloo=dict(record=rb, measures=mb, times=gl["times"], wall_s=wall_b),
        nccl=dict(record=rc, measures=mc, wall_s=wall_c), wall_s=total)


def _log_sharded(label, got, r, measures, times, wall, smi):
    """One sharded run's readings: step ms a rank (and the median of steps
    2-n), bytes gathered and reduced a step, collectives a step, peak GB a
    rank, rank start-up seconds, the loop's and the group's wall
    seconds."""
    step = measures[0]["steps"][0]
    ms = [[round(t * 1e3, 1) for t in m["times"]] for m in measures]
    med = [round(float(np.median(m["times"][1:])) * 1e3, 1)
           for m in measures]
    start = [None if t["start_s"] is None else round(t["start_s"], 1)
             for t in times]
    log(f"  [{smi}] {label}: losses {[round(x, 6) for x, _ in got]}, grad "
        f"norms {[round(g, 6) for _, g in got]}, movement "
        f"{r['movement']:.6g}; step ms a rank {ms} (median of steps 2-n "
        f"{med}); a step: {step['collectives']} collectives, "
        f"{step['gathered_bytes'] / 1e9:.3f} GB gathered, "
        f"{step['reduced_bytes'] / 1e9:.3f} GB reduced; peak "
        f"{[round(m.get('peak_gb', 0.0), 2) for m in measures]} GB a rank; "
        f"ranks started {start} s after the call; the loop "
        f"{[round(m['s'], 1) for m in measures]} s (checkpoints included); "
        f"group {wall:.1f} s")


# ----------------------------------------------------------------------
# dryrun: the dry run (repro_torch.launch.dryrun) held against the card
# three production cells through the command line: (arch, shape, mesh)
DRYRUN_CELLS = (("yi-9b", "train_4k", "single"),
                ("qwen2-72b", "decode_32k", "multi"),
                ("mamba2-1.3b", "long_500k", "single"))
# the traced peak of one sharded step (arguments + temp) over the card's
# torch.cuda.max_memory_allocated for that step, at most this far from 1
DRYRUN_PEAK_TOL = 0.05
DRYRUN_BUDGET_S = 60.0
DRYRUN_TIMEOUT_S = 600.0   # the traces' processes are killed past it


def _dryrun_start(traces: dict) -> None:
    """Start every trace of phase dryrun at once into ``traces``:
    ``procs`` ({name: process}), ``tmp`` (the command line's report
    directory) and ``t0``.  Each trace runs in a fresh process (a fake
    group is process-wide, and a trace's live bytes depend on what its
    process traced before; `dryrun.start`): SHARDED_TRAIN's sharded step
    at world 1 and 2 over ``("data",)``, serve's two Yi-9B engines (a
    PROMPT-token prefill and one decode step each), and DRYRUN_CELLS
    through the command line.  Only world 1's process sees the card (its
    fakes on cuda:0); the others trace the card's route on the meta
    device, as on a machine without one, and open no CUDA context.  The
    traces need nothing of this process, so `_run` starts them before the
    first phase, while the kernels build (phase device takes no reading),
    and `_dryrun_stop` ends them."""
    from repro_torch.launch import dryrun

    traces.update(tmp=tempfile.mkdtemp(prefix="repro_torch_dryrun_"),
                  procs={}, t0=time.perf_counter())
    procs = traces["procs"]
    arch, layers, (B, S), _ = SHARDED_TRAIN
    for w in (1, SHARDED_TRAIN_WORLD):
        procs[f"world {w}"] = dryrun.start(dryrun.case_argv(
            "sharded_step", arch=arch, layers=layers, batch=[B, S], world=w,
            rank=w - 1), card=w == 1)
    for e, n in sorted(ENGINE_LAYERS.items()):
        procs[e] = dryrun.start(dryrun.case_argv(
            "serve_case", arch="yi-9b", layers=n, prompt=PROMPT), card=False)
    for c in DRYRUN_CELLS:
        a, shape, mesh = c
        procs[" ".join(c)] = dryrun.start(
            ["--arch", a, "--shape", shape, "--mesh", mesh, "--force",
             "--report-dir", traces["tmp"]], card=False)


def _dryrun_stop(traces: dict) -> None:
    """Kill what is left of `_dryrun_start`'s processes, reap them all
    and remove their report directory."""
    for p in traces.get("procs", {}).values():
        if p.poll() is None:
            p.kill()
        p.wait()
    if "tmp" in traces:
        shutil.rmtree(traces["tmp"], ignore_errors=True)


def _dryrun_real_step(cfg, tcfg, B, S):
    """One sharded step of ``cfg`` at world size 1 over NCCL in this
    process, from zero masters and a zero (B, S) batch, as the trace runs
    it: (device bytes held before the step, the step's peak above them,
    launches, the step's metrics)."""
    import torch

    from repro_torch.dist import fsdp, one_rank_group, train_mesh
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.train import make_train_step

    batch = {"tokens": np.zeros((B, S), np.int32),
             "labels": np.zeros((B, S), np.int32)}
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    with one_rank_group("nccl", timeout_s=120.0):
        mesh = train_mesh((1,), ("data",), device="cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        model = build_model(cfg, device="cuda", train=True)
        pspecs, sspecs = fsdp.train_specs(cfg, tcfg.opt, mesh)
        init_state, step = make_train_step(model, tcfg, mesh=mesh)
        state = fsdp.shard_tree(init_state(model.params()), sspecs, mesh)
        shards = fsdp.shard_masters(model, pspecs, mesh)
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = dict(_build.LAUNCHES)
        t1 = time.perf_counter()
        shards, state, m = step(shards, state, batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated()
        launches = {k: _build.LAUNCHES[k] - before[k] for k in before}
        metrics = {k: float(v) for k, v in m.items()}
        del model, shards, state, m
    torch.cuda.empty_cache()
    log(f"  (a') the real step: group, model and shards {t1 - t0:.1f} s, "
        f"the step {t2 - t1:.1f} s, the group's end "
        f"{time.perf_counter() - t2:.1f} s")
    return start - base, peak - start, launches, metrics


def _same(label, got, want):
    if got != want:
        raise AssertionError(f"dryrun {label}: traced {got}, on the card "
                             f"{want}")


def phase_dryrun(args, rec):
    """The dry run (`repro_torch.launch.dryrun`) against the card.  Every
    trace runs in a fresh process (`_dryrun_start`, all started at once
    before the first phase) while this process runs (a'): (a)
    SHARDED_TRAIN's
    sharded step traced at world 1 and 2: collectives a step, bytes
    gathered and reduced, launches a kernel a rank a step, each exact
    against train-sharded's runs on the card (when that phase ran) and
    against (a'), one real step at world size 1 over NCCL here, whose
    peak the traced arguments + temp must meet within DRYRUN_PEAK_TOL;
    the traced peaks read against train-sharded's (a), (b) and (c); (b)
    serve's Yi-9B engines traced over a PROMPT-token prefill and one
    decode step, launches exact (`_expected_launches`), their peaks read
    against serve's; (c) DRYRUN_CELLS through the command line, each
    recorded ok, its GB a rank read against the card's memory."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.train import OptConfig, TrainConfig
    from repro_torch.train.step import sharded_step_collectives

    smi = rec["smi"]
    t_phase = time.perf_counter()
    started = rec["dryrun_traces"]
    procs, tmp, read = started["procs"], started["tmp"], {}
    running = [n for n, p in procs.items() if p.poll() is None]

    def result(name):  # the last line a trace's process printed
        left = DRYRUN_TIMEOUT_S - (time.perf_counter() - started["t0"])
        out = dryrun.finish(procs[name], max(left, 1.0))
        read[name] = round(time.perf_counter() - t_phase, 1)
        return out.strip().splitlines()[-1]

    arch, layers, (B, S), _ = SHARDED_TRAIN
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    tcfg = TrainConfig(opt=OptConfig())
    per_step = _train_launches(cfg)
    args_b, temp_b, launches, metrics = _dryrun_real_step(cfg, tcfg, B, S)
    t_real = time.perf_counter() - t_phase
    _same("(a') launches", launches, per_step)
    rec.setdefault("paths", {})["dryrun"] = dict(launches=launches)
    card = rec.get("paths", {}).get("train-sharded")
    traces = {}
    for w in (1, SHARDED_TRAIN_WORLD):
        t = traces[w] = json.loads(result(f"world {w}"))
        want = sharded_step_collectives(cfg, tcfg, _data_mesh(w))
        got = dict(collectives=t["metrics"]["collectives"],
                   gathered_bytes=t["metrics"]["gathered_bytes"],
                   reduced_bytes=t["metrics"]["reduced_bytes"])
        _same(f"(a) world {w} collectives", got["collectives"], want)
        _same(f"(a) world {w} launches", {
            k: t["kernels"]["launches"].get(k, 0) for k in per_step},
            per_step)
        if w == 1:
            _same("(a') collectives and bytes", got, {
                k: int(metrics[k]) for k in got})
        if card is not None:
            run = card["gloo"] if w > 1 else card["nccl"]
            for r, m in enumerate(run["measures"]):
                for i, st in enumerate(m["steps"]):
                    _same(f"(a) world {w} rank {r} step {i + 1}", got,
                          {k: st[k] for k in got})
                _same(f"(a) world {w} rank {r} launches a step",
                      {k: t["kernels"]["launches"].get(k, 0) * card[
                          "steps"] for k in per_step},
                      {k: m["launches"][k] for k in per_step})
        mem = t["memory"]
        traced = mem["peak_bytes"] / 1e9
        line = (f"  [{smi}] (a) traced world {w}: {got['collectives']} "
                f"collectives, {got['gathered_bytes'] / 1e9:.3f} GB "
                f"gathered, {got['reduced_bytes'] / 1e9:.3f} GB reduced, "
                f"launches {t['kernels']['launches']} a rank a step; "
                f"peak {traced:.3f} GB (arguments "
                f"{(mem['peak_bytes'] - mem['temp_bytes']) / 1e9:.3f} + "
                f"temp {mem['temp_bytes'] / 1e9:.3f})")
        if w == 1:
            ratio = mem["peak_bytes"] / (args_b + temp_b)
            line += (f"; (a') the card's step at world size 1 over "
                     f"NCCL: {args_b / 1e9:.3f} + "
                     f"{temp_b / 1e9:.3f} GB, traced / card {ratio:.4f}")
            if abs(ratio - 1.0) > DRYRUN_PEAK_TOL:
                raise AssertionError(f"dryrun (a'): traced peak / the "
                                     f"card's {ratio:.4f}, outside 1 +- "
                                     f"{DRYRUN_PEAK_TOL}")
        if card is not None:
            reads = ([("(a) single", card["single_peak_gb"])]
                     if w == 1 else []) + [
                (f"({'c' if w == 1 else 'b'}) rank {r}", m["peak_gb"])
                for r, m in enumerate(run["measures"])]
            line += "; traced / train-sharded's peak: " + ", ".join(
                f"{n} {traced / gb:.3f} ({gb:.2f} GB)" for n, gb in reads)
        log(line)
    if card is None:
        log("  (a) train-sharded did not run: held against (a') alone")

    serve = rec.get("paths", {}).get("yi-9b")
    held = 0.0
    for e, n in sorted(ENGINE_LAYERS.items()):
        t = traces[e] = json.loads(result(e))
        ecfg = dataclasses.replace(get_config("yi-9b"), n_layers=n)
        pre = {k: v for k, v in _expected_launches(ecfg, 1, 0).items()
               if v}
        one = _expected_launches(ecfg, 1, 1)
        dec = {k: one[k] - pre.get(k, 0) for k in one
               if one[k] - pre.get(k, 0)}
        _same(f"(b) {e} prefill launches", t["prefill"]["kernels"][
            "launches"], pre)
        _same(f"(b) {e} decode launches", t["decode"]["kernels"][
            "launches"], dec)
        p, d = t["prefill"]["memory"], t["decode"]["memory"]
        held += max(p["peak_bytes"], d["peak_bytes"])
        log(f"  [{smi}] (b) traced {e} (Yi-9B, {n} layers): prefill "
            f"{PROMPT} tokens {pre}, peak {p['peak_bytes'] / 1e9:.3f} "
            f"GB; one decode step {dec}, peak "
            f"{d['peak_bytes'] / 1e9:.3f} GB: launches as "
            f"_expected_launches")
    if serve is not None:
        gb = serve["max_memory_allocated_gb"]
        log(f"  [{smi}] (b) the engines' traced peaks together "
            f"{held / 1e9:.3f} GB against serve's "
            f"max_memory_allocated {gb:.2f} GB: {held / 1e9 / gb:.3f}")

    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    for c in DRYRUN_CELLS:
        result(" ".join(c))
        with open(os.path.join(tmp, "__".join(c) + ".json")) as f:
            r = json.load(f)
        if not r.get("ok"):
            raise AssertionError(f"dryrun {c}: {r.get('error')}")
        mem = r["memory"]
        gb = (mem["argument_bytes"] + mem["temp_bytes"]) / 1e9
        log(f"  [{smi}] (c) {' '.join(c)}: ok, traced in "
            f"{r['trace_s']:.2f} s, "
            f"{gb:.2f} GB a rank (arguments "
            f"{mem['argument_bytes'] / 1e9:.2f} + temp "
            f"{mem['temp_bytes'] / 1e9:.2f}) against the card's "
            f"{total_gb:.2f} GB "
            f"({'fits' if gb <= total_gb else 'does not fit'}), "
            f"{r['cost']['flops']:.4g} FLOPs, "
            f"{r['cost']['collective_bytes'] / 1e9:.3f} GB of "
            f"collectives, launches {r['kernels']['launches']}")
    total = time.perf_counter() - t_phase
    log(f"[{smi}] dryrun: {total:.1f} s (budget {DRYRUN_BUDGET_S:.0f} s)"
        + ("" if total <= DRYRUN_BUDGET_S else "; OVER ITS BUDGET")
        + f": the traces started {t_phase - started['t0']:.1f} s before the "
        f"phase, still running at its start {running}; (a') done at "
        f"{t_real:.1f} s; each process read at (s) {read}, the step's and the "
        f"engines' traces took (s) {[t['trace_s'] for t in traces.values()]}")


def _data_mesh(world: int):
    """A shape-only ``("data",)`` mesh of ``world`` ranks for
    `sharded_step_collectives`."""
    import types

    return types.SimpleNamespace(axis_names=("data",),
                                 shape={"data": world})


# ----------------------------------------------------------------------
# train-pipe: the GPipe pipeline (repro_torch.dist.pipeline) and the
# launchers
# (arch, layers, stages, microbatches, (batch, sequence) a microbatch):
# full width, depth cut
PIPE_TRAIN = ("yi-9b", 4, 2, 4, (1, 2048))
PIPE_PASSES = 3                 # one cold, two timed
PIPE_WORLD = 2                  # gloo ranks on cuda:0, one a stage
# where the pipelined runs are not equal to the sequential one bit for
# bit (the same kernels at the same shapes on the same card): relative,
# the loss, and each gradient leaf and the hidden states (L2)
PIPE_TOL = (2e-4, 1e-2)
PIPE_BUDGET_S = 45.0
LAUNCH_TRAIN_STEPS = 4          # python -m repro_torch.launch.train
LAUNCH_LINE = re.compile(r"^final loss (\d+\.\d{4}); checkpoints: "
                         r"\[(.*)\]$")


def _launchers(tmp):
    """Start the two module entry points as subprocesses: the train
    launcher on the card (the SMOKE Yi-9B, LAUNCH_TRAIN_STEPS steps,
    checkpoints into ``tmp``) and the serve launcher's ``--help`` (it runs
    the example phase zoo drives in process)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, (
        str(ROOT / "src"), os.environ.get("PYTHONPATH")))))
    cmds = {"train": [sys.executable, "-m", "repro_torch.launch.train",
                      "--steps", str(LAUNCH_TRAIN_STEPS), "--device", "cuda",
                      "--ckpt-dir", os.path.join(tmp, "launch")],
            "serve": [sys.executable, "-m", "repro_torch.launch.serve",
                      "--help"]}
    return {k: (subprocess.Popen(c, cwd=ROOT, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE), time.perf_counter())
            for k, c in cmds.items()}


def _check_launchers(procs, smi):
    """The launchers' exit codes and lines: the train launcher's last line
    is `repro`'s with the checkpoint `repro`'s arithmetic keeps (every
    max(steps // 2, 10) steps and the last: LAUNCH_TRAIN_STEPS alone);
    the serve launcher's help names the example's flags."""
    out = {}
    for k, (p, t0) in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=300)
        finally:
            if p.poll() is None:
                p.kill()
        if p.returncode != 0:
            raise AssertionError(f"train-pipe: launch.{k} exited "
                                 f"{p.returncode}: {stderr[-2000:]}")
        out[k] = (stdout.strip().splitlines(), time.perf_counter() - t0)
    lines, train_s = out["train"]
    m = LAUNCH_LINE.match(lines[-1]) if lines else None
    if not m or m.group(2) != str(LAUNCH_TRAIN_STEPS):
        raise AssertionError(f"train-pipe: launch.train's last line "
                             f"{lines[-1:]} is not repro's with checkpoints "
                             f"[{LAUNCH_TRAIN_STEPS}]")
    help_text = "\n".join(out["serve"][0])
    if not all(f in help_text for f in ("--device", "--requests",
                                        "--profile-runs")):
        raise AssertionError("train-pipe: launch.serve --help does not "
                             "name the example's flags")
    log(f"  [{smi}] python -m repro_torch.launch.train --steps "
        f"{LAUNCH_TRAIN_STEPS} --device cuda: {lines[-1]!r}; python -m "
        f"repro_torch.launch.serve --help: the example's flags (both done "
        f"within {max(train_s, out['serve'][1]):.1f} s of their start, "
        f"beside (a), (b) and (c))")


def _same_or_close(label, got, want, tol) -> str:
    """'equal' when ``got`` equals ``want`` (as values, on ``want``'s
    device), else their relative L2 difference, which must be within
    ``tol``."""
    import torch

    got = got.to(want.device)
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} against "
                             f"{tuple(want.shape)}")
    if torch.equal(got, want):
        return "equal"
    err = float((got.float() - want.float()).norm() /
                want.float().norm().clamp(min=1e-30))
    if err > tol:
        raise AssertionError(f"{label}: relative L2 difference {err:.3g} "
                             f"> {tol}")
    return f"{err:.2e}"


def _hold_pipe(label, losses, hidden, grads, ref, smi) -> None:
    """A pipelined run against (a): every pass's loss, the hidden states and
    every master's gradient equal to (a)'s, or within PIPE_TOL."""
    tl, tg = PIPE_TOL
    wl = ref["losses"][0]
    for x in losses:
        if x != wl and abs(x - wl) > tl * abs(wl):
            raise AssertionError(f"{label}: loss {x} against (a)'s {wl}")
    res = {"hidden": _same_or_close(f"{label} hidden", hidden,
                                    ref["hidden"], tg)}
    for k, g in ref["grads"].items():
        res[k] = _same_or_close(f"{label} gradient {k}", grads[k], g, tg)
    diff = {k: v for k, v in res.items() if v != "equal"}
    log(f"  [{smi}] {label}: losses {losses} "
        f"({'equal to' if set(losses) == {wl} else 'within tol of'} (a)'s); "
        f"hidden and {len(ref['grads'])} gradient leaves "
        + ("all equal to (a)'s" if not diff else
           f"equal but {diff} (relative L2, tol {tg})"))


def _pipe_setup() -> dict:
    """PIPE_TRAIN's case: ``cfg`` (Yi-9B at full width cut to its layers),
    ``batch`` (its microbatches' tokens from TRAIN_DATA's Markov source),
    ``key`` (the masters' seed), ``n_micro`` and ``micro_bytes`` (a bf16
    microbatch's)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, MarkovLMData

    arch, layers, _, n_micro, (mb, S) = PIPE_TRAIN
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    vocab, kgram = TRAIN_DATA
    batch = MarkovLMData(DataConfig(vocab=vocab, seq_len=S,
                                    batch=n_micro * mb, seed=SEED,
                                    kgram=kgram)).next_batch()
    return dict(cfg=cfg, batch=batch, key=SEED + 80, n_micro=n_micro,
                micro_bytes=mb * S * cfg.d_model * 2)


def _check_pipe_passes(label, passes, n, s, pipe) -> None:
    """Every pass of stage ``s`` of ``n``: its launches `_pipe_launches`,
    its collectives and bytes `pass_collectives` / `pass_bytes`."""
    from repro_torch.dist.pipeline import pass_bytes, pass_collectives

    n_micro = pipe["n_micro"]
    launches = _pipe_launches(pipe["cfg"], n, n_micro, s)
    want = (pass_collectives(n, n_micro),
            pass_bytes(n, n_micro, pipe["micro_bytes"]))
    for i, p in enumerate(passes):
        if p["launches"] != launches:
            raise AssertionError(f"{label}: pass {i + 1} launched "
                                 f"{p['launches']}, expected {launches}")
        if (p["collectives"], p["bytes"]) != want:
            raise AssertionError(f"{label}: pass {i + 1} issued "
                                 f"{p['collectives']} collectives, "
                                 f"{p['bytes']} bytes, expected {want}")


def _pipe_sequential(pipe, smi):
    """(a): the microbatches of ``pipe`` (`_pipe_setup`) one after the
    other through all its layers on cuda:0 in this process.  Returns (the
    model, its stage body and layer leaves, the reference {losses,
    hidden, grads}, the passes' measures)."""
    from repro_torch.dist.pipeline_runs import (layer_stage, pipe_loss,
                                                sequential, staged_model,
                                                stage_leaves, timed_passes)

    cfg, batch, n_micro = pipe["cfg"], pipe["batch"], pipe["n_micro"]
    model = staged_model(cfg, 1, 0, pipe["key"], "cuda")
    body, leaves = layer_stage(model), stage_leaves(model)
    losses, hidden, per = timed_passes(
        "cuda", PIPE_PASSES, list(model.masters.values()), lambda: pipe_loss(
            model, batch, n_micro, lambda x: sequential(leaves, x, body)))
    expect = _pipe_launches(cfg, 1, n_micro, 0)
    for i, p in enumerate(per):
        if p["launches"] != expect:
            raise AssertionError(f"train-pipe (a): pass {i + 1} launched "
                                 f"{p['launches']}, expected {expect}")
    if len(set(losses)) != 1:
        raise AssertionError(f"train-pipe (a): the passes differ {losses}")
    ref = {"losses": losses, "hidden": hidden.detach().clone(),
           "grads": {k: p.grad.clone() for k, p in model.masters.items()}}
    log(f"  [{smi}] (a) sequential, cuda:0: pass ms "
        f"{[round(p['s'] * 1e3, 1) for p in per]}, loss {losses[0]}, "
        f"launches a pass {expect} (exact)")
    return model, body, leaves, ref, per


def _pipe_group(label, world, backend, pipe, ref, tmp, smi) -> dict:
    """``world`` ranks, one a stage, over ``backend`` run the passes of
    ``pipe`` (`run_pipe_cases`) and write their gradients into ``tmp``;
    every rank's launches, collectives and bytes a pass exact, the ranks
    agreeing, and the hidden states, losses and every gradient held to
    (a)'s ``ref`` (`_hold_pipe`).  Returns the group's record, measures,
    times and wall seconds."""
    import torch

    from repro_torch.dist import spawn
    from repro_torch.dist.pipeline_runs import load_dump, run_pipe_cases

    n_micro, micro_bytes = pipe["n_micro"], pipe["micro_bytes"]
    dump = os.path.join(tmp, f"dump_{backend}_{world}")
    os.makedirs(dump)
    case = dict(kind="model", mesh=((world,), ("pipe",)), cfg=pipe["cfg"],
                key=pipe["key"], batch=pipe["batch"], n_micro=n_micro,
                passes=PIPE_PASSES, dump=dump)
    t0 = time.perf_counter()
    out = spawn(run_pipe_cases, world, device="cuda", backend=backend,
                args=([case], time.time()), timeout_s=120.0,
                deadline_s=300.0)
    wall = time.perf_counter() - t0
    if len(set(out["digests"])) != 1:
        raise AssertionError(f"train-pipe {label}: the ranks disagree: "
                             f"{out['digests']}")
    record, ranks = out["records"][0], [m[0] for m in out["measures"]]
    for s, m in enumerate(ranks):
        _check_pipe_passes(f"train-pipe {label} rank {s}", m["passes"],
                           world, s, pipe)
    t1 = time.perf_counter()
    got = {k: torch.from_numpy(v) for k, v in load_dump(dump, world).items()}
    hidden = got.pop("hidden").to("cuda", torch.bfloat16)
    _hold_pipe(label, record["losses"], hidden, got, ref, smi)
    compare_s = time.perf_counter() - t1
    del got, hidden
    hops = 2 * (n_micro + world - 2)
    last = ranks[0]["passes"][-1]
    start = [None if t["start_s"] is None else round(t["start_s"], 1)
             for t in out["times"]]
    log(f"  [{smi}] {label}: pass ms a rank "
        f"{[[round(p['s'] * 1e3, 1) for p in m['passes']] for m in ranks]}"
        f"; a pass: {hops} hops of {micro_bytes / 1e6:.1f} MB "
        f"({last['bytes']['permuted'] / 1e6:.1f} MB sent a rank), one hop "
        f"alone {[round(m['hop_ms'], 2) for m in ranks]} ms a rank, so "
        f"~{hops * ranks[0]['hop_ms']:.0f} ms of hops; "
        f"{last['collectives']} collectives, "
        f"{last['bytes']['reduced'] / 1e6:.1f} MB summed; launches a pass "
        f"{[m['passes'][-1]['launches'] for m in ranks]} (exact); peak "
        f"{[round(m.get('peak_gb', 0.0), 2) for m in ranks]} GB a rank; "
        f"ranks started {start} s after the call, loaded the kernels and "
        f"built their stages in {[round(m['build_s'], 1) for m in ranks]} "
        f"s, wrote their gradients in "
        f"{[round(m['dump_s'], 1) for m in ranks]} s; compared in "
        f"{compare_s:.1f} s; group {wall:.1f} s")
    return dict(record=record, measures=ranks, times=out["times"],
                wall_s=wall)


def phase_train_pipe(args, rec):
    """The GPipe pipeline on the card (`repro_torch.dist.pipeline`): Yi-9B
    at full width, PIPE_TRAIN's 4 layers in 2 stages of 2, 4 microbatches
    of (1, 2048) tokens from the Markov source (8,192 tokens), float32
    masters, bf16 compute, remat; PIPE_PASSES passes of forward and
    backward (no optimizer step), the first cold.  (a) the microbatches
    one after the other through all 4 layers on cuda:0 in this process;
    (b) PIPE_WORLD ranks on cuda:0 over gloo (hops staged through the
    host), mesh (2,) over ("pipe",), each rank holding only its stage's
    layers; (c) one stage at world size 1 over NCCL in this process (no
    hop).  (b) and (c) are held to (a): the hidden states, the loss and
    every master's gradient (the stages' layers, the embedding through
    the replicated input, the head) equal bit for bit or within PIPE_TOL,
    every rank's losses and hidden states equal, launches per rank and
    pass exact (`_pipe_launches`), collectives and bytes per pass exact
    (`pass_collectives`, `pass_bytes`).  Beside them the two launchers
    run as subprocesses (`_launchers`)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.dist import one_rank_group, train_mesh
    from repro_torch.dist.pipeline import pipeline_forward
    from repro_torch.dist.pipeline_runs import pipe_loss, timed_passes
    from repro_torch.kernels import _build
    from repro_torch.models import param_shapes

    smi = rec["smi"]
    t_phase = time.perf_counter()
    _build.extension()  # the ranks and the launcher load this build
    tmp = tempfile.mkdtemp(prefix="repro_torch_train_pipe_")
    procs = _launchers(tmp)  # their start-up overlaps (a) and (c)
    try:
        pipe = _pipe_setup()
        cfg, batch = pipe["cfg"], pipe["batch"]
        arch, layers, n, n_micro, (mb, S) = PIPE_TRAIN
        layer_gb = sum(int(np.prod(s[1:])) for k, s in
                       param_shapes(cfg).items()
                       if k.startswith("layers@")) * 4 / 1e9
        log(f"train-pipe: {arch} at full width (d {cfg.d_model}, vocab "
            f"{cfg.vocab}), {layers} layers in {n} stages ({layer_gb:.2f} "
            f"GB of float32 masters a layer), {n_micro} microbatches of "
            f"({mb},{S}) from MarkovLMData(vocab={TRAIN_DATA[0]}, kgram="
            f"{TRAIN_DATA[1]}), remat {cfg.remat}, {PIPE_PASSES} passes of "
            f"forward and backward (the first cold); bubble "
            f"{(n - 1) / (n_micro + n - 1):.2f} of the ticks")
        log("reduced: depth only (4 of 48 layers); one card, so the gloo "
            "ranks share it and NCCL runs at world size 1")

        # (a), then (c) on the same masters
        model, body, leaves, ref, per_a = _pipe_sequential(pipe, smi)
        masters = list(model.masters.values())
        torch.cuda.set_device(0)
        t0 = time.perf_counter()
        with one_rank_group("nccl", timeout_s=120.0):
            mesh = train_mesh((1,), ("pipe",), device="cuda")
            block = {k: p[None] for k, p in leaves.items()}
            losses_c, hidden_c, per_c = timed_passes(
                "cuda", PIPE_PASSES, masters, lambda: pipe_loss(
                    model, batch, n_micro, lambda x: pipeline_forward(
                        block, x, body, mesh=mesh)))
        wall_c = time.perf_counter() - t0
        _check_pipe_passes("train-pipe (c)", per_c, 1, 0, pipe)
        _hold_pipe("(c) nccl, world size 1", losses_c, hidden_c,
                   {k: p.grad for k, p in model.masters.items()}, ref, smi)
        log(f"  [{smi}] (c): pass ms "
            f"{[round(p['s'] * 1e3, 1) for p in per_c]}; "
            f"{per_c[-1]['collectives']} collectives a pass "
            f"({per_c[-1]['bytes']['reduced'] / 1e6:.1f} MB summed); group "
            f"{wall_c:.1f} s")
        del model, body, leaves, masters, block, hidden_c
        torch.cuda.empty_cache()

        gl = _pipe_group(f"(b) gloo, {PIPE_WORLD} ranks on cuda:0",
                         PIPE_WORLD, "gloo", pipe, ref, tmp, smi)
        _check_launchers(procs, smi)
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    total = time.perf_counter() - t_phase
    log(f"[{smi}] train-pipe: {total:.1f} s (budget {PIPE_BUDGET_S:.0f} s): "
        f"gloo group {gl['wall_s']:.1f} s, NCCL group {wall_c:.1f} s"
        + ("" if total <= PIPE_BUDGET_S else "; OVER ITS BUDGET"))
    launches = {k: 0 for k in KERNELS}
    for p in per_a + per_c + [p for m in gl["measures"]
                              for p in m["passes"]]:
        launches = {k: launches[k] + p["launches"][k] for k in launches}
    rec.setdefault("paths", {})["train-pipe"] = dict(
        launches=launches, sequential=dict(losses=ref["losses"],
                                           passes=per_a),
        nccl=dict(losses=losses_c, passes=per_c, wall_s=wall_c), gloo=gl,
        wall_s=total)


def phase_pipe_cards(args, rec):
    """On request, on a machine of 2 or 4 cards: PIPE_TRAIN's pipeline
    with one stage a card over NCCL (the hops device to device,
    ``batch_isend_irecv``), its 4 layers split evenly, held to (a) on
    cuda:0 as train-pipe holds (b).  No launch of it enters the kernels
    line."""
    import shutil
    import tempfile

    import torch

    from repro_torch.kernels import _build

    world = torch.cuda.device_count()
    if world not in (2, 4):
        raise RuntimeError(f"pipe-cards needs 2 or 4 cards, found {world}")
    smi = rec["smi"]
    _build.extension()
    tmp = tempfile.mkdtemp(prefix="repro_torch_pipe_cards_")
    try:
        log(f"pipe-cards: {PIPE_TRAIN[0]}, {PIPE_TRAIN[1]} layers in "
            f"{world} stages, one a card over NCCL; bubble "
            f"{(world - 1) / (PIPE_TRAIN[3] + world - 1):.2f} of the ticks")
        pipe = _pipe_setup()
        model, _, _, ref, _ = _pipe_sequential(pipe, smi)
        del model
        torch.cuda.empty_cache()
        _pipe_group(f"nccl, {world} ranks, one a card", world, "nccl", pipe,
                    ref, tmp, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# train-100m: repro's example driver's run on the card
TRAIN_100M = (50, 8, 128)  # steps, batch, sequence


def phase_train_100m(args, rec):
    """`repro_torch.examples.train_100m` on the card as `repro`'s driver
    configures it (12 layers, d 512, vocab 32768, float32, remat none;
    AdamW on the cosine schedule, 2 accumulated microbatches, async
    checkpoints every third of the run into a temporary directory):
    TRAIN_100M's 50 steps at (8, 128), the tokens from TRAIN_DATA's
    256-symbol Markov source (a cut: `repro`'s example draws them from
    `MarkovLMData(vocab=32768, kgram=1)`, whose 8.6 GB table took 35.8 s
    to build on the card's host), its host memory and build time taken
    first.  Launches of every step exact (twice `_train_launches`), the mean loss of the last 10 steps below the
    first 10's, and a restore of the last checkpoint equal to the final
    parameters bit for bit; step time (steps 2-n), tokens/s, model-FLOP
    share against the float32 peak, peak memory."""
    import shutil
    import signal
    import tempfile
    import tracemalloc

    import torch

    import repro_torch.train.loop as loop
    from repro_torch.data import DataConfig, MarkovLMData
    from repro_torch.examples import train_100m as t100
    from repro_torch.kernels import _build
    from repro_torch.train import CheckpointManager

    smi = rec["smi"]
    steps, B, S = TRAIN_100M
    cfg = t100.config_100m()

    # the host memory the source allocates at its peak (numpy's buffers
    # are traced), and what it keeps
    vocab, kgram = TRAIN_DATA
    tracemalloc.start()
    t0 = time.perf_counter()
    data = MarkovLMData(DataConfig(vocab=vocab, seq_len=S, batch=B,
                                   kgram=kgram))
    data_s = time.perf_counter() - t0
    held, peak_host = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    data_gb = peak_host / 1e9
    log(f"train-100m: MarkovLMData(vocab={vocab}, kgram={kgram}) built in "
        f"{data_s:.1f} s, host memory {data_gb:.2f} GB at its peak, "
        f"{held / 1e9:.2f} GB kept; reduced: the tokens come from "
        f"{vocab} symbols into the full {cfg.vocab}-word embedding, not "
        f"from repro's MarkovLMData(vocab={cfg.vocab}, kgram=1) (its "
        f"8.6 GB table: 35.8 s on the card's host)")
    batch_s = []
    real_next = data.next_batch

    def next_batch():
        t = time.perf_counter()
        out = real_next()
        batch_s.append(time.perf_counter() - t)
        return out

    data.next_batch = next_batch
    times, per_step = [], []
    real_make = loop.make_train_step

    def timed_make(model, tcfg, **kw):
        init, step = real_make(model, tcfg, **kw)

        def run(params, state, batch):
            before = dict(_build.LAUNCHES)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(params, state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            per_step.append({k: _build.LAUNCHES[k] - before[k]
                             for k in before})
            return out

        return init, run

    def quiet(s):
        if not s.startswith("step ") or s.startswith(
                tuple(f"step {i}:" for i in range(50, steps + 1, 50))):
            log(f"  {s}")

    ckpt = tempfile.mkdtemp(prefix="train100m_")
    handlers = {g: signal.getsignal(g) for g in (signal.SIGTERM,
                                                 signal.SIGINT)}
    loop.make_train_step = timed_make
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    try:
        out = t100.train_100m(cfg, data, steps, device="cuda", ckpt_dir=ckpt,
                              log=quiet)
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 1e9
        expect = {k: 2 * v for k, v in _train_launches(cfg).items()}
        bad = [i for i, d in enumerate(per_step) if d != expect]
        if len(per_step) != steps or bad:
            raise AssertionError(f"train-100m: steps {bad[:5]} launched "
                                 f"{[per_step[i] for i in bad[:5]]}, "
                                 f"expected {expect} a step")
        losses = out["losses"]
        first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
        if not (np.all(np.isfinite(losses)) and last < first):
            raise AssertionError(f"train-100m: the loss did not fall: mean "
                                 f"of the first 10 {first}, last 10 {last}")
        mgr = CheckpointManager(ckpt)
        kept = mgr.list_steps()
        target = {"params": {k: torch.zeros_like(v)
                             for k, v in out["params"].items()},
                  "state": out["state"], "data": {"step": 0}}
        back = mgr.restore(kept[-1], target)
        same = [k for k, v in out["params"].items()
                if not torch.equal(back["params"][k], v.detach())]
        if kept[-1] != steps or same:
            raise AssertionError(f"train-100m: checkpoints {kept}; the "
                                 f"restore differs in {same}")
        data_batch_s = float(np.mean(batch_s))
        _, step = real_make(out["model"], out["tcfg"])
        batch = data.next_batch()
        _profile_call("train-100m step", lambda: step(
            out["params"], out["state"], batch), rec, "one train step")
    finally:  # the driver's preemption handler and checkpoints go
        loop.make_train_step = real_make
        for g, h in handlers.items():
            signal.signal(g, h)
        shutil.rmtree(ckpt, ignore_errors=True)
    n_par = out["n_params"]
    n_mat = n_par - out["model"].masters["embed"].numel()
    step_s = float(np.median(times[1:]))
    flops = _step_flops(cfg, n_mat, B, S)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    res = dict(launches=launches, per_step=expect, steps=steps,
               losses_first10=first, losses_last10=last,
               step_ms=step_s * 1e3, tokens_per_s=B * S / step_s,
               model_flops=flops, mfu_f32=flops / step_s / F32_OPS,
               tf32=tf32, max_memory_allocated_gb=peak, params=n_par,
               data_build_s=data_s, data_host_peak_gb=data_gb,
               data_batch_s=data_batch_s, checkpoints=kept,
               stragglers=out["straggler_events"])
    rec.setdefault("paths", {})["train-100m"] = res
    log(f"[{smi}] train-100m: {n_par / 1e6:.1f}M parameters, {steps} steps "
        f"at ({B},{S}), 2 microbatches; step {step_s * 1e3:.2f} ms (median "
        f"of steps 2-{steps}), {B * S / step_s:.0f} tokens/s, model FLOPs "
        f"{flops / 1e9:.1f} G a step = {res['mfu_f32']:.3f} of the float32 "
        f"peak 67 TFLOP/s (TF32 {'on' if tf32 else 'off'}: float32 matmuls "
        f"on CUDA cores), peak memory {peak:.2f} GB; loss mean {first:.4f} "
        f"(first 10) -> {last:.4f} (last 10); launches a step {expect}; "
        f"checkpoints {kept}, the last restored bit for bit; data "
        f"{data_batch_s * 1e3:.1f} ms a batch on the host; "
        f"stragglers {out['straggler_events']}")
    del out, back, target
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# phase zoo: the trained ladder and the end-to-end example on the card
# ----------------------------------------------------------------------
ZOO_ARGS = ["--device", "cuda", "--requests", "24", "--profile-runs", "80"]


def phase_zoo(args, rec):
    """`build_zoo` with `repro`'s ladder on the card (its launches exact),
    held-out accuracy rising from zoo-s to zoo-m to zoo-l, then the
    example's main loop (cascade profiling with real invocations, the fleet
    runtime against the Murakkab static plan) with its launches counted
    as the serve paths count them."""
    import torch

    from repro_torch.data import DataConfig, MarkovLMData
    from repro_torch.examples import serve_workflow as sw
    from repro_torch.kernels import _build
    from repro_torch.serving.zoo import _LADDER, build_zoo, sequence_accuracy

    _build.reset_launches()
    t0 = time.perf_counter()
    zoo = build_zoo(vocab=sw.VOCAB, seq_len=sw.SEQ, seed=0, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    train_launches = dict(_build.LAUNCHES)
    expect = {k: 0 for k in KERNELS}
    for (name, *_, steps, _), eng in zip(_LADDER, zoo.values()):
        for k, v in _train_launches(eng.model.cfg).items():
            expect[k] += v * steps
    log(f"zoo: {len(zoo)} rungs trained on the card in {build_s:.1f} s; "
        f"launches {train_launches} (expected {expect})")
    if train_launches != expect:
        raise AssertionError("zoo training launches do not match its steps")
    accs = {}
    for name, eng in zoo.items():
        data = MarkovLMData(DataConfig(vocab=sw.VOCAB, seq_len=sw.SEQ,
                                       batch=32, seed=0, kgram=2))
        data.state["step"] = 10_000  # a held-out region of the stream
        accs[name] = sequence_accuracy(eng, data)
    log(f"  held-out next-token accuracy: {accs}")
    acc = list(accs.values())
    if not all(a < b for a, b in zip(acc, acc[1:])):
        raise AssertionError(f"zoo accuracy does not rise with size: {accs}")

    _build.reset_launches()
    t0 = time.perf_counter()
    out = sw.main(ZOO_ARGS, zoo=zoo)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    expect_run = {k: 0 for k in KERNELS}
    expect_run["trie_plan"] = out["replans"]
    for name, n in out["invocations"].items():
        for k, v in _expected_launches(zoo[name].model.cfg, n,
                                       max_new=sw.HORIZON).items():
            expect_run[k] += v
    log(f"launches on the zoo example path: {launches} (expected "
        f"{expect_run}); invocations {out['invocations']}")
    if launches != expect_run or launches["trie_plan"] <= 0:
        raise AssertionError("zoo example launches do not match its stage "
                             "invocations and replans")
    v, mk = out["vine"], out["murakkab"]
    log(f"  example ({' '.join(ZOO_ARGS)}) in {wall:.1f} s: VineLM acc "
        f"{v['accuracy']:.4f} cost {v['mean_cost']:.6f} mean_lat "
        f"{v['mean_lat']:.4f} s; static plan acc {mk['accuracy']:.4f} cost "
        f"{mk['mean_cost']:.6f} mean_lat {mk['mean_lat']:.4f} s; "
        f"{out['rounds']} fleet rounds")
    rec.setdefault("paths", {})["zoo"] = dict(
        launches={k: train_launches[k] + launches[k] for k in KERNELS},
        accuracy=accs, build_s=build_s, example_wall_s=wall,
        vine=v, murakkab=mk)
    del zoo
    torch.cuda.empty_cache()


PHASES = {"device": phase_device, "kernels": phase_kernels,
          "serve": phase_serve, "serve-events": phase_serve_events,
          "serve-compiled": phase_serve_compiled,
          "serve-sharded": phase_serve_sharded,
          "serve-ssm": phase_serve_ssm, "serve-dense": phase_serve_dense,
          "serve-moe": phase_serve_moe, "serve-media": phase_serve_media,
          # after the serve phases: a short trace taken after a train step's
          # long one came back empty on the card (PERF.md section 7)
          "train": phase_train, "train-sharded": phase_train_sharded,
          "dryrun": phase_dryrun, "train-pipe": phase_train_pipe,
          "train-ssm": phase_train_ssm,
          "train-hybrid": phase_train_hybrid,
          "train-100m": phase_train_100m, "zoo": phase_zoo}
SERVE_PHASES = ("serve", "serve-events", "serve-compiled", "serve-sharded",
                "serve-ssm", "serve-dense", "serve-moe", "serve-media")


def _after_serving(args, rec, name, cohort):
    """After the last serve phase that runs: the replan summary over the
    fleet rounds and the profiled replans (a profiler session leaves
    later launches slower, so it comes last)."""
    phases = args.phases.split(",")
    if any(p in phases for p in SERVE_PHASES[SERVE_PHASES.index(name) + 1:]):
        return
    _replan_summary(rec)
    _profile_round(cohort, rec)
# run only when named
ON_REQUEST = {"parts": phase_parts, "pipe-cards": phase_pipe_cards}


# ----------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}; "
                         "add profile to trace one generate per engine "
                         "after each serve phase, parts to time copies of "
                         "the decode, bf16 flash forward and SSD kernels "
                         "with parts taken out")
    ap.add_argument("--verbose-build", action="store_true",
                    help="show the compiler's output (ptxas -v included)")
    args = ap.parse_args(argv)
    # the card's host writes no bytecode (PYTHONDONTWRITEBYTECODE), so
    # each process compiled torch's sources anew, ~8 s a process there:
    # this run's processes share one bytecode cache, removed at the end
    pyc = tempfile.mkdtemp(prefix="chip_smoke_pyc_")
    os.environ["PYTHONPYCACHEPREFIX"] = pyc
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix, sys.dont_write_bytecode = pyc, False
    try:
        return _run(args)
    finally:
        shutil.rmtree(pyc, ignore_errors=True)


def _run(args) -> int:
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    rec = {"kernels": {}, "dryrun_traces": {}}
    failed = []
    try:
        if "dryrun" in phases:
            _dryrun_start(rec["dryrun_traces"])
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
    finally:
        _dryrun_stop(rec["dryrun_traces"])
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
