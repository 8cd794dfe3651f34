#!/usr/bin/env python3
"""How far bf16 routing drifts from float32 in the port's MoE, on the CPU.

    PYTHONPATH=src python tools/moe_bf16_drift.py [--seeds 4] [--layers 2]

For granite-moe-1b-a400m at full width (its first ``--layers`` layers,
weights random from each seed), a bf16 `Model` and its float32 copy
prefill the same 448 random tokens.  Per MoE layer it prints:

- ``same input``: flips (rows whose chosen set differs) between the bf16
  router and a float32 router on the bf16 model's own layer input, which
  is what `chip_smoke.py`'s full-E layer check compares;
- ``own input``: flips between the two models, each on its own input, and
  the largest router-logit difference on the rows that no routing
  difference of an earlier layer reached (rows before the first row that
  differed: a changed row enters the later layers' causal attention; at
  the first router, all rows, where only the bf16 rounding of the
  attention and norms upstream moves the logits), which bounds the tau
  slack of the model and train checks.

Then one loss-and-gradient of a (1, 256) batch on the bf16 and float32
training forms, with the worst relative L2 error over the gradient leaves.
CPU bf16 is not the card: these numbers size the chip checks' tolerances
before a chip run, nothing more.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

sys.path.insert(0, "src")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, MarkovLMData  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.transformer import Model, TrainModel  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402


def _f32_copy(model, cls):
    cfg = dataclasses.replace(model.cfg, dtype="float32")
    cpu = cls(cfg, device="cpu")
    with torch.no_grad():
        for p, q in zip(cpu.parameters(), model.parameters()):
            p.copy_(q.float())
    return cpu


def _sets(r, K):
    return [set(x) for x in r.topi.reshape(-1, K).tolist()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--layers", type=int, default=2)
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                              n_layers=args.layers)
    K, d = cfg.moe.top_k, cfg.d_model
    for seed in range(args.seeds):
        model = Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(seed))
        cpu = _f32_copy(model, Model)
        seen = {id(model): [], id(cpu): []}
        for m in (model, cpu):
            for blk in m.layers:
                blk.mlp.register_forward_pre_hook(
                    lambda mod, a, key=id(m): seen[key].append(a[0].clone()))
        toks = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab, (1, 448)))
        model.prefill(toks)
        cpu.prefill(toks)
        reached = set()
        for i, (hb, hf) in enumerate(zip(seen[id(model)], seen[id(cpu)])):
            mb, mf = model.layers[i].mlp, cpu.layers[i].mlp
            with torch.no_grad():
                rb, rf = mb.route(hb), mf.route(hf)
                same = L.route(torch.softmax(
                    hb.reshape(-1, d).float() @ mf.router, -1)[None], K, rb.C)
                lb = (hb.reshape(-1, d) @ mb.router).float()
                lf = hf.reshape(-1, d) @ mf.router
            sb, sf, ss = _sets(rb, K), _sets(rf, K), _sets(same, K)
            first = min(reached, default=len(sb))  # causal: rows < first
            clean = list(range(first))
            drift = float((lb - lf).abs()[clean].max()) if clean else 0.0
            kb, kf = rb.keep.reshape(-1, K), rf.keep.reshape(-1, K)
            reached |= {t for t in range(len(sb)) if sb[t] != sf[t] or {
                e for e, k in zip(rb.topi.reshape(-1, K)[t].tolist(),
                                  kb[t].tolist()) if k} != {
                e for e, k in zip(rf.topi.reshape(-1, K)[t].tolist(),
                                  kf[t].tolist()) if k}}
            print(f"seed {seed} layer {i}: same input {sum(a != b for a, b in zip(sb, ss))}"
                  f" flips of {len(sb)} rows; own input "
                  f"{sum(a != b for a, b in zip(sb, sf))} flips, logit drift "
                  f"on unreached rows at most {drift:.4f}")
        tm = TrainModel(cfg, device="cpu").init(
            torch.Generator().manual_seed(seed))
        tc = _f32_copy(tm, TrainModel)
        batch = MarkovLMData(DataConfig(vocab=256, seq_len=256, batch=1,
                                        seed=1, kgram=2)).next_batch()
        _, _, gb = value_and_grad(tm, batch)
        _, _, gf = value_and_grad(tc, batch)
        errs = {k: float((gb[k] - gf[k]).norm() / gf[k].norm()) for k in gf}
        worst = max(errs, key=errs.get)
        print(f"seed {seed} train (1, 256): worst gradient leaf {worst} "
              f"{errs[worst]:.4f} (relative L2), median "
              f"{float(np.median(list(errs.values()))):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
