#!/usr/bin/env python3
"""What moving the sharded training state through the host costs on one
machine: the rates behind `chip_smoke.py`'s ``train-sharded`` phase.

    python3 tools/host_staging_probe.py [--gb 2] [--device cuda]

Each line is one operation on ``--gb`` GB, timed on the host clock (a
device copy synchronised): a fresh host tensor filled (its pages
faulted in) and the same tensor filled again; device-to-host and
host-to-device copies into fresh pageable memory, reused pageable memory
and reused pinned memory; ``np.save`` to a temporary directory,
``np.load`` back and a sha256 of the bytes; then, on 2 gloo ranks of
this host (`repro_torch.dist.spawn`), an all-gather of ``--gb / 2`` GB a
rank and a reduce-scatter of ``--gb`` GB (the second of two runs
kept), then each split into 2 and 4 parts issued at once on as many
process groups.  With ``--device cpu`` the device copies are skipped.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def _gloo_rates(lane, n: int) -> dict:
    """All-gather and reduce-scatter of float32 host tensors on this rank
    (a function of the package's spawn protocol: ``fn(mesh, *args)``),
    each twice, then split into k parts issued at once (``async_op``) on
    k process groups of their own, for k = 2, 4."""
    import torch.distributed as dist

    out = {}
    shard = torch.ones(n // 2)
    groups = [dist.new_group([0, 1]) for _ in range(4)]
    for k in (1, 1, 2, 4):
        for name in ("all_gather", "reduce_scatter"):
            parts = []
            for j in range(k):
                m = n // 2 // k
                parts.append((shard[j * m:(j + 1) * m],
                              torch.empty(2 * m) if name == "all_gather"
                              else torch.ones(2 * m),
                              torch.empty(m)))
            dist.barrier()
            t0 = time.perf_counter()
            works = []
            for j, (s, f, r) in enumerate(parts):
                g = groups[j] if k > 1 else None
                works.append(
                    dist.all_gather_into_tensor(f, s, group=g, async_op=True)
                    if name == "all_gather" else
                    dist.reduce_scatter_tensor(r, f, group=g, async_op=True))
            for w in works:
                w.wait()
            out[f"{name} in {k} part(s) at once"] = (
                time.perf_counter() - t0)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gb", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    n = int(args.gb * 1e9) // 4
    gb = n * 4 / 1e9
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("host_staging_probe: no CUDA device", file=sys.stderr)
        return 2

    def timed(label, fn):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"{label}: {dt:.3f} s, {gb / dt:.2f} GB/s", flush=True)

    host = {}
    timed("fresh host tensor filled", lambda: host.update(
        a=torch.empty(n).fill_(1.0)))
    timed("the same tensor filled again", lambda: host["a"].fill_(2.0))
    if cuda:
        dev = torch.ones(n, device="cuda")
        timed("device to fresh pageable", lambda: host.update(b=dev.cpu()))
        timed("device to reused pageable", lambda: host["b"].copy_(dev))
        pinned = {}
        timed("pinned allocation", lambda: pinned.update(
            p=torch.empty(n, pin_memory=True)))
        timed("device to reused pinned", lambda: pinned["p"].copy_(dev))
        timed("pinned to device", lambda: dev.copy_(pinned["p"]))
        timed("pageable to device", lambda: dev.copy_(host["b"]))
        del dev, pinned
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "a.npy")
        arr = host["a"].numpy()
        timed("np.save", lambda: np.save(path, arr))
        timed("np.load", lambda: host.update(c=np.load(path)))
        timed("sha256", lambda: hashlib.sha256(arr.tobytes()).hexdigest())
    host.clear()

    from repro_torch.dist import spawn

    rates = spawn(_gloo_rates, 2, device="cpu", args=(n,),
                  timeout_s=120.0, deadline_s=600.0)
    for k, dt in rates.items():
        print(f"gloo {k} ({gb:.2f} GB full, 2 ranks): {dt:.3f} s, "
              f"{gb / dt:.2f} GB/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
