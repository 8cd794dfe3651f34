#!/usr/bin/env python3
"""Time the float32 flash forward at the float32 shapes of the port's
paths, in this checkout or in another one (an older commit unpacked by
`git archive`), so that two versions can be read in one run on one card.

    python3 tools/flash_f32_times.py [--tree DIR] [--tag NAME]

``--tree`` (default: this checkout) is the root of the checkout whose
`src/repro_torch` and `chip_smoke.py` are imported; its kernels are built
into its own `build/torch_ext`.  One JSON line a shape: the card's
name, the wrapper `flash_attention` timed warm and cold in L2 (the
training form, with the log-sum-exp, where the path takes it), the plain
version `ref.attention`, SDPA warm and cold, and the bound, each as
`chip_smoke.py` times and computes them.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

# (label, B, H, S, D, with the log-sum-exp): train-100m's microbatch, the
# zoo's training batch and served prefill, MLA's float32 head dim
SHAPES = (("train-100m", 4, 8, 128, 64, True),
          ("zoo-s train", 16, 2, 32, 16, True),
          ("zoo-m train", 16, 4, 32, 16, True),
          ("zoo-l train", 16, 4, 32, 32, True),
          ("zoo-s serve", 1, 2, 16, 16, False),
          ("zoo-m serve", 1, 4, 16, 16, False),
          ("zoo-l serve", 1, 4, 16, 32, False),
          ("mla float32", 2, 4, 100, 96, True))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--tag", default="this checkout")
    args = ap.parse_args()
    root = os.path.abspath(args.tree)
    sys.path[:0] = [os.path.join(root, "src"), root]

    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import _build, cost, ref
    from repro_torch.kernels.flash_attention import flash_attention

    if not torch.cuda.is_available():
        print("flash_f32_times: no CUDA device", file=sys.stderr)
        return 1
    _build.extension()
    g = torch.Generator(device="cuda").manual_seed(11)
    card = torch.cuda.get_device_name(0)
    for label, B, H, S, D, lse in SHAPES:
        q, k, v = (torch.randn(B, H, S, D, generator=g, device="cuda")
                   for _ in range(3))

        def sdpa(a, b, c):
            return F.scaled_dot_product_attention(a, b, c, is_causal=True)

        ms = cs.graph_ms(lambda: flash_attention(q, k, v, causal=True,
                                                 return_lse=lse))
        lib_ms = cs.graph_ms(lambda: sdpa(q, k, v))
        plain_ms = cs.graph_ms(lambda: ref.attention(q, k, v, causal=True))
        cold = cs.cold_inputs(q, k, v)
        cold_ms = cs.graph_ms(lambda *a: flash_attention(
            *a, causal=True, return_lse=lse), inputs=cold)
        lib_cold_ms = cs.graph_ms(sdpa, inputs=cold)
        del cold
        nbytes, ops = cost.flash_work(B, H, H, S, S, D, 4, True)
        b_ms, b_by = cs.bound(nbytes, ops, cs.F32_OPS)
        print(json.dumps(dict(
            tree=args.tag, card=card, shape=label, dims=[B, H, S, D],
            lse=lse, ms=ms, cold_ms=cold_ms, library_ms=lib_ms,
            library_cold_ms=lib_cold_ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
