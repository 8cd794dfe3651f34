"""Train a ~100M-parameter dense LM with the full training substrate
(AdamW, cosine schedule, grad accumulation, async fault-tolerant
checkpoints, watchdog) — `examples/train_100m.py` of `repro`, ported;
plus ``--device``.  Default step count is CPU-sized; pass ``--steps 300``
for the few-hundred-step run on the card.

    python -m repro_torch.examples.train_100m [--steps 30] [--device cpu]

`train_100m` is the run itself (a config, a data source and a step
count); `main` builds `repro`'s config and data source and prints what
`repro`'s driver prints.
"""
import argparse
import tempfile

import torch

from repro_torch.data import DataConfig, MarkovLMData
from repro_torch.models import build_model
from repro_torch.models.config import ArchConfig
from repro_torch.train import LoopConfig, OptConfig, TrainConfig, train


def config_100m() -> ArchConfig:
    # ~105M params: 12 x (d=512, ff=2048) + 32k vocab embeddings
    return ArchConfig(
        name="dense-100m", family="dense", n_layers=12, d_model=512,
        n_heads=8, n_kv_heads=8, d_ff=2048, vocab=32768, head_dim=64,
        remat="none", dtype="float32")


def train_100m(cfg: ArchConfig, data, steps: int, *, device="cuda",
               ckpt_dir: str | None = None, model=None,
               log=print) -> dict:
    """Train ``cfg`` (a `TrainModel` drawn from seed 0, or ``model``) on
    ``data`` for ``steps`` steps with `repro`'s driver settings: AdamW at
    peak 3e-4 on the cosine schedule (warm-up a tenth of the run, at
    least 5 steps), 2 accumulated microbatches, async checkpoints every
    third of the run (at least every 10 steps) into ``ckpt_dir`` (a new
    temporary directory by default), the preemption handler on.  Returns
    `train.loop.train`'s dict with "model", "ckpt_dir", "tcfg" and
    "n_params" added."""
    if model is None:
        gen = torch.Generator(device=device).manual_seed(0)
        model = build_model(cfg, device=device, train=True).init(gen)
    tcfg = TrainConfig(
        accum_steps=2,
        opt=OptConfig(peak_lr=3e-4, warmup_steps=max(steps // 10, 5),
                      total_steps=steps))
    ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="train100m_")
    lcfg = LoopConfig(total_steps=steps, ckpt_every=max(steps // 3, 10),
                      ckpt_dir=ckpt_dir, log_every=5, async_ckpt=True)
    out = train(model, data, tcfg, lcfg, device=device,
                handle_preemption=True, log=log)
    out.update(model=model, ckpt_dir=ckpt_dir, tcfg=tcfg,
               n_params=sum(p.numel() for p in model.masters.values()))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="device that trains (cuda, or cpu to run the "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)

    cfg = config_100m()
    data = MarkovLMData(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                   batch=args.batch, kgram=1))
    model = build_model(cfg, device=args.device, train=True).init(
        torch.Generator(device=args.device).manual_seed(0))
    n_params = sum(p.numel() for p in model.masters.values())
    print(f"model: {cfg.name} ({n_params / 1e6:.1f}M params)")
    out = train_100m(cfg, data, args.steps, device=args.device,
                     ckpt_dir=args.ckpt_dir, model=model)
    print(f"loss: {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f} "
          f"over {len(out['losses'])} steps; "
          f"stragglers={out['straggler_events']}; "
          f"checkpoints at {out['ckpt_dir']}: "
          f"{out['manager'].list_steps()}")
    return out


if __name__ == "__main__":
    main()
