"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on.

    The port runs on the GPU unless the caller asks for the CPU: a CUDA
    device requested on a machine without one raises instead of quietly
    running the plain PyTorch versions on the host."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
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
