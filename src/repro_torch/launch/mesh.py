"""Production meshes (`repro.launch.mesh`).

`make_production_mesh` is a function, not a module-level constant, so
that importing this module touches no process group: a dry run makes its
fake group of 256 or 512 ranks first (`repro_torch.launch.dryrun`) and
only then builds the mesh.
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.dist.sharding import TrainMesh, train_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> TrainMesh:
    """Single pod: (16, 16) over ("data", "model"), 256 ranks.
    Multi-pod: (2, 16, 16) over ("pod", "data", "model"), 512 ranks.
    On the default process group, which must hold that many ranks (a dry
    run's fake group); every rank calls it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return train_mesh(shape, axes, device=device)


def make_host_mesh(model_axis: int = 2, device: str = "cpu") -> TrainMesh:
    """A (ranks / model_axis, model_axis) mesh over ("data", "model") on
    whatever ranks the default group holds; raises ``ValueError`` where
    `repro` asserts, when ``model_axis`` does not divide them."""
    n = dist.get_world_size() \
        if dist.is_available() and dist.is_initialized() else 0
    if n < 1 or model_axis < 1 or n % model_axis:
        raise ValueError(f"a host mesh with a model axis of {model_axis} "
                         f"needs a group whose ranks it divides, got {n}")
    return train_mesh((n // model_axis, model_axis), ("data", "model"),
                      device=device)


def data_axes(mesh) -> tuple[str, ...]:
    """Axes used for data parallelism / FSDP: ("pod", "data") when the pod
    axis exists, else ("data",)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"
