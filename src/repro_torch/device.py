"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def fake_mode_active() -> bool:
    """Whether a `FakeTensorMode` is active: tensors made now are fakes,
    shapes and dtypes with nothing allocated (a dry run's trace)."""
    return torch._guards.detect_fake_mode() is not None


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on.

    The port runs on the GPU unless the caller asks for the CPU: a CUDA
    device requested on a machine without one raises instead of quietly
    running the plain PyTorch versions on the host.  The one exception is
    a trace under an active `FakeTensorMode` (`fake_mode_active`), which
    allocates nothing, and where fake tensors on the card take the
    kernels' shape routes (`kernels.ops`): there "cuda" names ``cuda:0``
    on a machine with a card, and ``meta`` on one without (PyTorch's
    bindings set a CUDA device guard for indexing and copies even of fake
    CUDA tensors, which a build without CUDA cannot; the meta device
    stands in for the card, and the routes take its fakes as the
    card's)."""
    dev = torch.device(device)
    if dev.type == "cuda" and fake_mode_active():
        if not torch.cuda.is_available():
            return torch.device("meta")
        return torch.device("cuda", 0 if dev.index is None else dev.index)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type == "meta" and fake_mode_active():
        return dev
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev


_READS = 0  # host reads of device values made by `host_read`


def host_read(x) -> bool | int | float:
    """One host read of a one-element tensor (a device synchronisation on
    a CUDA tensor), counted: the compiled event engine decides each of its
    loops and branches on one such read (`host_reads`)."""
    global _READS
    _READS += 1
    return x.item()


def host_reads() -> int:
    """Host reads `host_read` has made in this process."""
    return _READS
