"""Start a group of ranks on this host: `spawn`.

`repro` develops its multi-device control plane on virtual CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=N``); the port's
counterpart is a process group, one process a rank.  `spawn` starts
``world`` ranks with `torch.multiprocessing` under the spawn start method
(safe after CUDA has initialised in the parent), joins them through a
``file://`` store in a fresh temporary directory, and returns rank 0's
result.  A rank that raises fails the whole call: the others are stopped
and the parent raises.  A collective that waits longer than
``timeout_s`` raises in its rank, so a rank that hangs fails the call
too, and ``deadline_s`` bounds the whole group.  `one_rank_group` makes
this process alone a group of one rank, starting nothing.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

MAX_TIMEOUT_S = 120.0


def _rank_main(rank, fn, world, device, backend, args, tmp, timeout_s):
    """What each spawned rank runs: join the group, build the lane mesh,
    run ``fn(mesh, *args)``, and on rank 0 write its result for the
    parent."""
    from repro_torch.dist.sharding import lane_mesh

    # the ranks share the host's cores
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(lane_mesh(world, device=device), *args)
        if rank == 0:
            part = os.path.join(tmp, "result.part")
            with open(part, "wb") as f:
                pickle.dump(out, f)
            os.replace(part, os.path.join(tmp, "result.pkl"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def one_rank_group(backend: str = "gloo", timeout_s: float = 60.0):
    """A process group of this process alone (world size 1) for the
    duration of the ``with`` block: the lane mesh of size 1 over
    ``backend`` without starting a process.  Under ``"nccl"`` the caller
    sets its CUDA device first."""
    timeout_s = float(timeout_s)
    if not 0.0 < timeout_s <= MAX_TIMEOUT_S:
        raise ValueError(f"timeout_s must lie in (0, {MAX_TIMEOUT_S}]")
    with tempfile.TemporaryDirectory(prefix="repro_torch_group_") as tmp:
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(tmp, 'store')}",
            rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            yield
        finally:
            dist.destroy_process_group()


def _default_backend(world: int, device: str | torch.device) -> str:
    """``"nccl"`` when the ranks run on CUDA and each has a card of its
    own, else ``"gloo"`` (NCCL refuses two ranks on one device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and int(world) <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def spawn(fn, world: int, *, device: str | torch.device,
          backend: str | None = None, args: tuple = (),
          timeout_s: float = 60.0, deadline_s: float | None = None):
    """Run ``fn(mesh, *args)`` on ``world`` ranks and return rank 0's
    result.

    ``fn`` and ``args`` are pickled to the children, so ``fn`` must be a
    module-level function of an importable module (a package function,
    never one defined in a script or a test body).  Each rank gets the
    `repro_torch.dist.sharding.LaneMesh` of the group on ``device``
    (``"cuda"``: rank r on ``cuda:{r % device_count}``).  ``backend``
    defaults to `_default_backend`.  ``timeout_s`` (at most
    ``MAX_TIMEOUT_S``) bounds joining the group and every collective;
    ``deadline_s``, when given, bounds the whole run.  Raises when a rank
    fails, times out or the deadline passes, after stopping every rank."""
    import torch.multiprocessing as mp

    world = int(world)
    if world < 1:
        raise ValueError(f"spawn needs world >= 1, got {world}")
    dev = resolve_device(device)
    backend = _default_backend(world, dev) if backend is None else backend
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs device='cuda'")
    timeout_s = float(timeout_s)
    if not 0.0 < timeout_s <= MAX_TIMEOUT_S:
        raise ValueError(f"timeout_s must lie in (0, {MAX_TIMEOUT_S}]")
    with tempfile.TemporaryDirectory(prefix="repro_torch_group_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, dev.type, backend, tuple(args), tmp,
                              timeout_s),
            nprocs=world, join=False, start_method="spawn")
        end = None if deadline_s is None \
            else time.monotonic() + float(deadline_s)
        try:
            while not ctx.join(timeout=0.1):
                if end is not None and time.monotonic() > end:
                    raise TimeoutError(
                        f"spawn: the {world} ranks did not finish within "
                        f"{deadline_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)
