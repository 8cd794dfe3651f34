#!/usr/bin/env python3
"""Time the bf16 flash backward at the bf16 training shapes of
`chip_smoke.BWD_SHAPES`, whole and by parts (prep, dq, dkdv), in this
checkout or in another one (an older commit unpacked by `git archive`),
so that two versions can be read in one run on one card.

    python3 tools/flash_bwd_times.py [--tree DIR] [--tag NAME] [--plans]
                                     [--define NAME=VALUE ...]

``--tree`` (default: this checkout) is the root of the checkout whose
`src/repro_torch` and `chip_smoke.py` are imported; its kernels are built
into its own `build/torch_ext`.  One JSON line a shape: the card's name,
the plan `bwd_plan` picks, launched as the wrapper `flash_attention_bwd`
launches it (`flash_attention._launch_bwd`) and timed warm and cold in
L2, each part alone from the prep pass's D (`_launch_bwd(...,
parts=)`), SDPA's backward and the
bound, each as `chip_smoke.py` times and computes them, and the largest
error against `ref.attention_bwd` (within `chip_smoke.BF16_TOL`, or the
script fails).  With ``--plans`` (a checkout that has
`flash_attention.bwd_plans`) also every plan the rule weighs, each
checked and timed whole and its dq and dkdv parts alone (each dq
variant of a checkout that has them: one or two consumer warpgroups).  With ``--define``
(repeatable) everything runs on a timing copy of the kernels built with
those macros (`_build.extension(defines=)`, e.g. ``DKDV_TOGETHER=1``).
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--define", action="append", default=[])
    args = ap.parse_args()
    root = os.path.abspath(args.tree)
    sys.path[:0] = [os.path.join(root, "src"), root]

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, cost, ref
    from repro_torch.kernels import flash_attention as fmod

    if not torch.cuda.is_available():
        print("flash_bwd_times: no CUDA device", file=sys.stderr)
        return 1
    ext = _build.extension(defines=tuple(args.define)) if args.define \
        else _build.extension()
    kw = {"ext": ext} if args.define else {}
    g = torch.Generator(device="cuda").manual_seed(13)
    card = torch.cuda.get_device_name(0)
    sms = _build.sm_count(0)
    for label, dts, B, H, KV, Sq, Sk, D, causal in cs.BWD_SHAPES:
        if dts != "bfloat16":
            continue

        def rn(*shape):
            return torch.randn(*shape, generator=g,
                               device="cuda").to(torch.bfloat16)

        q, k, v, do = rn(B, H, Sq, D), rn(B, KV, Sk, D), rn(B, KV, Sk, D), \
            rn(B, H, Sq, D)
        o, lse = fmod.flash_attention(q, k, v, causal=causal,
                                      return_lse=True)
        want = ref.attention_bwd(q, k, v, o, lse, do, causal=causal)

        def run(plan, parts=7, delta=None, *ops):
            return fmod._launch_bwd(*(ops or (q, k, v, o, lse, do)), causal,
                                    0, plan, parts=parts, delta=delta, **kw)

        def checked(plan):
            out = run(plan)
            torch.cuda.synchronize()
            return max(cs.check_close(f"flash_attention_bwd {n}", a, b,
                                      cs.BF16_TOL)
                       for n, a, b in zip(("dq", "dk", "dv"), out, want))

        def parts_ms(plan, names):
            delta = run(plan, parts=fmod.PARTS["prep"])[3]
            return {n: cs.graph_ms(lambda: run(plan, fmod.PARTS[n], delta))
                    for n in names}

        plan = fmod.bwd_plan(B, H, KV, Sq, Sk, D, causal, 2, sms)
        err = checked(plan)
        ms = cs.graph_ms(lambda: run(plan))
        cold = cs.cold_inputs(q, k, v, o, lse, do)
        cold_ms = cs.graph_ms(lambda *a: run(plan, 7, None, *a), inputs=cold)
        del cold
        lib_ms, _ = cs._sdpa_bwd_ms(q, k, v, do, causal)
        nbytes, ops = cost.flash_bwd_work(B, H, KV, Sq, Sk, D, 2, causal)
        b_ms, b_by = cs.bound(nbytes, ops, cs.BF16_OPS)
        line = dict(tree=args.tag, defines=args.define, card=card,
                    shape=label,
                    dims=[B, H, KV, Sq, Sk, D], causal=causal,
                    plan=plan._asdict(), max_abs_err=err, ms=ms,
                    cold_ms=cold_ms,
                    parts=parts_ms(plan, ("prep", "dq", "dkdv")),
                    library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        if args.plans:
            line["plans"] = [dict(
                plan=p._asdict(), max_abs_err=checked(p),
                ms=cs.graph_ms(lambda: run(p)),
                **{f"{n}_ms": t for n, t in parts_ms(p, ("dq", "dkdv")).items()})
                for p in fmod.bwd_plans(B, H, KV, Sq, Sk, D, causal, 2, sms)]
        print(json.dumps(line), flush=True)
        del q, k, v, do, o, lse, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
