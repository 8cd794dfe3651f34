"""Fault-tolerant training loop of the port (`repro.train.loop`
counterpart): data pipeline -> train step -> metrics -> checkpoint
manager, with

- restore-on-start from the latest checkpoint (parameters, optimizer
  state and the data iterator's position);
- periodic and asynchronous checkpoints;
- a preemption handler (SIGTERM -> emergency save);
- a step-time watchdog: a step slower than ``watchdog_factor`` x the
  running median is logged as a straggler event.

A step's time is taken after the loss's device has finished it (a
synchronise where `repro` waits with ``block_until_ready``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.train.checkpoint import (CheckpointManager,
                                          install_preemption_handler)
from repro_torch.train.step import TrainConfig, make_train_step


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "/tmp/repro_ckpt"
    keep: int = 2
    async_ckpt: bool = True
    watchdog_factor: float = 3.0
    log_every: int = 10


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@torch.no_grad()
def _copy_into(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v)
        else:
            dst[k].copy_(v)


def train(
    model,
    data,
    tcfg: TrainConfig,
    lcfg: LoopConfig,
    *,
    device: str | torch.device = "cuda",
    handle_preemption: bool = False,
    log: Callable[[str], None] = print,
) -> dict:
    """Train ``model`` (a `TrainModel` on ``device``, "cuda" unless the
    caller asks for "cpu") on ``data`` for ``lcfg.total_steps`` steps,
    resuming from the latest checkpoint in ``lcfg.ckpt_dir`` if there is
    one.  Returns {"params", "state", "losses", "straggler_events",
    "manager"}."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"train on {dev} got a model on {model.device}")
    init_state, train_step = make_train_step(model, tcfg)
    params = model.params()
    state = init_state(params)
    mgr = CheckpointManager(lcfg.ckpt_dir, keep=lcfg.keep)

    start_step = 0
    latest = mgr.latest_step()
    if latest is not None:
        tree = {"params": params, "state": state,
                "data": data.checkpoint_state()}
        restored = mgr.restore(latest, tree)
        _copy_into(params, restored["params"])
        state = restored["state"]
        data.restore_state({k: v.item() if hasattr(v, "item") else v
                            for k, v in restored["data"].items()})
        start_step = latest
        log(f"[restore] resumed from step {latest}")

    def emergency_save():
        mgr.wait()
        mgr.save(lcfg.total_steps + 10**6,
                 {"params": params, "state": state,
                  "data": data.checkpoint_state()}, blocking=True)

    if handle_preemption:
        install_preemption_handler(emergency_save)

    times: list[float] = []
    straggler_events = 0
    losses = []
    for step in range(start_step, lcfg.total_steps):
        batch = data.next_batch()
        t0 = time.perf_counter()
        params, state, metrics = train_step(params, state, batch)
        _sync(metrics["loss"])
        dt = time.perf_counter() - t0
        if len(times) >= 5 and dt > lcfg.watchdog_factor * float(
                np.median(times)):
            straggler_events += 1
            log(f"[watchdog] step {step} took {dt:.3f}s "
                f"(median {np.median(times):.3f}s) — straggler event")
        times.append(dt)
        losses.append(float(metrics["loss"]))
        if (step + 1) % lcfg.log_every == 0:
            log(f"step {step+1}: loss={losses[-1]:.4f} "
                f"lr={float(metrics['lr']):.2e} {dt*1e3:.0f}ms")
        if (step + 1) % lcfg.ckpt_every == 0 or step + 1 == lcfg.total_steps:
            mgr.save(step + 1,
                     {"params": params, "state": state,
                      "data": data.checkpoint_state()},
                     blocking=not lcfg.async_ckpt)
    mgr.wait()
    return {
        "params": params,
        "state": state,
        "losses": losses,
        "straggler_events": straggler_events,
        "manager": mgr,
    }
