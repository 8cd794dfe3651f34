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

With ``mesh=`` the loop shards after restore-on-start, as `repro` does:
each rank keeps its shards of the masters and the optimizer state
(`repro_torch.dist.fsdp`) and steps with the sharded step.  A checkpoint
of a sharded run is the same files and manifest as an unsharded one: the
leaves are gathered to rank 0 and written by it alone, so either
restores into the other, onto any number of ranks
(`CheckpointManager.restore(shardings=)`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist import fsdp
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
    key=None,
    mesh=None,
    params=None,
    handle_preemption: bool = False,
    log: Callable[[str], None] = print,
) -> dict:
    """Train ``model`` (a `TrainModel` or `TrainEncDecModel` on ``device``,
    "cuda" unless the caller asks for "cpu") on ``data`` for
    ``lcfg.total_steps`` steps, resuming from the latest checkpoint in
    ``lcfg.ckpt_dir`` if there is one.

    - ``key``: an int seed (or a ``torch.Generator``) that draws the
      masters (`TrainModel.init`) first; None keeps the model's own;
    - ``params``: a master dict (tensors or numpy arrays by the model's
      keys, e.g. ``params_to_numpy``'s leaves or a carried `repro` tree
      flattened) the run starts from, copied in after ``key``;
    - ``mesh``: a `repro_torch.dist.TrainMesh` on the model's device;
      every rank of it calls ``train`` with the same arguments, and the
      returned params and state are this rank's shards.

    Returns {"params", "state", "losses", "metrics" (each step's metrics
    as host numbers), "times" (each step's seconds), "straggler_events",
    "manager"}."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"train on {dev} got a model on {model.device}")
    if mesh is not None and mesh.device != model.device:
        raise ValueError(f"the mesh computes on {mesh.device}, the model "
                         f"lies on {model.device}")
    if key is not None:
        gen = key if isinstance(key, torch.Generator) else \
            torch.Generator(device=model.device).manual_seed(int(key))
        model.init(gen)
    if params is not None:
        masters = model.params()
        if set(params) != set(masters):
            raise ValueError("params must hold exactly the model's master "
                             f"keys; differ: {set(params) ^ set(masters)}")
        _copy_into(masters, {k: v if isinstance(v, torch.Tensor) else
                             torch.from_numpy(np.array(v, np.float32))
                             for k, v in params.items()})
    init_state, train_step = make_train_step(model, tcfg, mesh=mesh)
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

    if mesh is not None:
        pspecs, sspecs = fsdp.train_specs(model.cfg, tcfg.opt, mesh)
        params = fsdp.shard_masters(model, pspecs, mesh)
        state = fsdp.shard_tree(state, sspecs, mesh)

    def save(step: int, blocking: bool) -> None:
        if mesh is None:
            mgr.save(step, {"params": params, "state": state,
                            "data": data.checkpoint_state()},
                     blocking=blocking)
            return
        tree = {"params": fsdp.gather_tree(params, pspecs, mesh, "cpu",
                                           root=True),
                "state": fsdp.gather_tree(state, sspecs, mesh, "cpu",
                                          root=True),
                "data": data.checkpoint_state()}
        if mesh.rank == 0:
            mgr.save(step, tree, blocking=blocking)

    def emergency_save():
        mgr.wait()
        save(lcfg.total_steps + 10**6, blocking=True)

    if handle_preemption:
        install_preemption_handler(emergency_save)

    times: list[float] = []
    straggler_events = 0
    losses, history = [], []
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
        history.append({k: float(v) if isinstance(v, torch.Tensor) else v
                        for k, v in metrics.items()})
        losses.append(history[-1]["loss"])
        if (step + 1) % lcfg.log_every == 0:
            log(f"step {step+1}: loss={losses[-1]:.4f} "
                f"lr={history[-1]['lr']:.2e} {dt*1e3:.0f}ms")
        if (step + 1) % lcfg.ckpt_every == 0 or step + 1 == lcfg.total_steps:
            save(step + 1, blocking=not lcfg.async_ckpt)
    mgr.wait()
    return {
        "params": params,
        "state": state,
        "losses": losses,
        "metrics": history,
        "times": times,
        "straggler_events": straggler_events,
        "manager": mgr,
    }
