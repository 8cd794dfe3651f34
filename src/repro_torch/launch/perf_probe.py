"""Perf probe (`repro.launch.perf_probe`): trace one dry-run cell on the
single-pod mesh, on the card's route, and report where the dominant
roofline term comes from: the memory line, the cost vector, the largest
buffers of the trace and the largest collectives, with their shapes.
The perf iteration loop reads this instead of a wall-clock profile.

    PYTHONPATH=src python -m repro_torch.launch.perf_probe --arch X
        --shape Y [--layers N] [--unroll] [--donate-cache]
        [--override k=v ...]

`repro` reads buffers and collectives from the optimized HLO; here they
come from the trace (`dryrun.LiveBytes`: every operation's results, the
kernels' shape routes' outputs among them; `repro_torch.record`: every
collective of `dist.sharding`).  The port runs no scan and its decode
updates the cache in place, so ``--unroll`` and ``--donate-cache`` change
nothing; they are kept so that `repro`'s command lines run.
"""
from __future__ import annotations

import argparse
from collections import defaultdict

from repro_torch.launch.dryrun import (MESH_WORLD, fake_group, trace_cell)
from repro_torch.launch.mesh import make_production_mesh


def top_buffers(buffers, k: int = 12):
    """The largest results of a trace, ``buffers`` as (bytes, shape, op)
    rows, aggregated by (shape, op): (total bytes, count, shape, op),
    largest first, the top ``k``."""
    agg = defaultdict(lambda: [0, 0])
    for b, shape, op in buffers:
        agg[(shape, op)][0] += b
        agg[(shape, op)][1] += 1
    rows = sorted(((v[0], v[1], s, o) for (s, o), v in agg.items()),
                  reverse=True)
    return rows[:k]


def top_collectives(calls, k: int = 12):
    """The largest collectives, ``calls`` as (bytes, kind, operand) rows:
    (bytes, kind, [operand]), largest first, the top ``k``."""
    rows = sorted(((b, c, [op] if op else []) for b, c, op in calls),
                  reverse=True)
    return rows[:k]


def _value(v: str):
    try:
        return int(v)
    except ValueError:
        try:
            return float(v)
        except ValueError:
            return {"true": True, "false": False}.get(v.lower(), v)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--unroll", action="store_true",
                    help="kept for repro's command lines: the port runs "
                         "every layer in Python, with no scan to unroll")
    ap.add_argument("--donate-cache", action="store_true",
                    help="kept for repro's command lines: the port's "
                         "decode updates the cache in place already")
    ap.add_argument("--override", nargs="*", default=[])
    args = ap.parse_args(argv)

    overrides = {}
    if args.layers:
        overrides["n_layers"] = args.layers
    for kv in args.override:
        key, v = kv.split("=")
        overrides[key] = _value(v)

    from torch._subclasses.fake_tensor import FakeTensorMode

    with fake_group(MESH_WORLD["single"]):
        with FakeTensorMode():
            mesh = make_production_mesh()
        got, _ = trace_cell(args.arch, args.shape, mesh,
                            cfg_overrides=overrides, detail=True)
    mem = got["memory"]
    print(f"== {args.arch} {args.shape} overrides={overrides} "
          f"donate={args.donate_cache} ==")
    print(f"args {mem['argument_bytes'] / 2**30:.2f} GiB  "
          f"temp {mem['temp_bytes'] / 2**30:.2f} GiB  "
          f"out {mem['output_bytes'] / 2**30:.2f} GiB")
    vec = dict(got["cost"])
    for kind, c in got["collectives"].items():
        if isinstance(c, dict):
            vec[f"coll_{kind}"] = float(c["bytes"])
    print("cost:", {k: f"{v:.3e}" for k, v in vec.items() if v})
    print("-- top buffers (aggregated by shape x op) --")
    for b, n, shape, op in top_buffers(got["buffers"]):
        print(f"  {b / 2**30:8.2f} GiB x{n:<4d} {shape:42s} {op}")
    print("-- top collectives --")
    for b, c, shapes in top_collectives(got["calls"]):
        print(f"  {b / 2**30:8.3f} GiB {c:20s} {shapes}")
    return got


if __name__ == "__main__":
    main()
