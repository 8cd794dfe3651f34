"""Training launcher (`repro.launch.train`, ported; same flags, plus
``--device``)::

    python -m repro_torch.launch.train --arch yi-9b --steps 50
    python -m repro_torch.launch.train --device cpu --steps 2 --batch 2 \\
        --seq 16 --ckpt-dir /tmp/ckpt

`repro`'s quirk is kept: ``--smoke`` is a flag whose default is already
on, so every run trains the architecture's reduced SMOKE config.  The
masters are drawn from seed 0, as `repro`'s ``train`` draws them from
``PRNGKey(0)`` (the port's generator, so other values); the data is the
vocabulary's Markov source (`MarkovLMData`, `repro`'s stream bit for
bit); `train` runs with ``handle_preemption=True`` on ``--device`` ("cuda"
unless the caller asks for "cpu"), checkpointing every ``max(steps // 2,
10)`` steps and at the last into ``--ckpt-dir`` (by default
``repro_torch_train`` in the system's temporary directory), from whose
latest checkpoint a run resumes.  The last line printed is `repro`'s:
``final loss <x>; checkpoints: [<steps kept>]``.
"""
import argparse
import os
import tempfile

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import DataConfig, MarkovLMData
from repro_torch.models import build_model
from repro_torch.train import LoopConfig, OptConfig, TrainConfig, train


def main(argv=None) -> dict:
    """Run the launcher with ``argv`` (the command line when None); returns
    `train`'s result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="yi-9b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--opt", choices=["adamw", "adafactor"], default="adamw")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="device that trains (cuda, or cpu to run the "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device=args.device, train=True)
    data = MarkovLMData(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                   batch=args.batch))
    tcfg = TrainConfig(
        accum_steps=args.accum,
        opt=OptConfig(kind=args.opt, peak_lr=3e-3,
                      warmup_steps=max(args.steps // 10, 5),
                      total_steps=args.steps))
    lcfg = LoopConfig(total_steps=args.steps,
                      ckpt_every=max(args.steps // 2, 10),
                      ckpt_dir=args.ckpt_dir, log_every=10)
    out = train(model, data, tcfg, lcfg, device=args.device, key=0,
                handle_preemption=True)
    print(f"final loss {out['losses'][-1]:.4f}; "
          f"checkpoints: {out['manager'].list_steps()}")
    return out


if __name__ == "__main__":
    main()
