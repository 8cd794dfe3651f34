"""Build and load the CUDA kernels of `csrc/`, and count their launches.

The sources are compiled with nvcc for Hopper (``sm_90a``) by
`torch.utils.cpp_extension.load` on first use, into ``build/torch_ext/``
under the repository root; nothing is built at import.  The kernels keep
a plain C interface (`csrc/*.cu`), and `csrc/bindings.cpp` exposes them
through pybind11 alone, taking raw device pointers and the stream as
integers: no source includes PyTorch's headers, which keeps the build to
seconds instead of minutes.  ninja compiles the seven sources in parallel.

``LAUNCHES`` counts the launches of each kernel: every wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels (`reset_launches` zeroes the counts).
"""
from __future__ import annotations

import functools
import pathlib

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("bindings.cpp", "trie_plan.cu", "flash_attention.cu",
           "flash_attention_bwd.cu", "decode_attention.cu", "rmsnorm.cu",
           "ssd_scan.cu")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "torch_ext"
CUDA_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a")

LAUNCHES = {"trie_plan": 0, "flash_attention": 0, "flash_attention_bwd": 0,
            "decode_attention": 0, "rms_norm": 0, "ssd_scan": 0}

_EXT = None        # the build the wrappers launch
_COPIES: dict = {}  # timing copies, by their macros
# (kernel, device index) -> every arrival-counter buffer made for it, the
# newest last: a buffer that a launch may have used is never freed, since
# a CUDA graph captured with it replays it
_COUNTERS: dict[tuple[str, int], list[torch.Tensor]] = {}


def reset_launches() -> None:
    """Zero every kernel's launch count."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    """Record one launch of kernel ``name`` (called by its wrapper only)."""
    LAUNCHES[name] += 1


def counters(name: str, device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` arrival counters of kernel ``name`` on ``device``,
    zeroed once when made: every launch of that kernel leaves them at 0
    (the last block or warp to arrive resets its counter).  Launches that
    share them run in stream order (one stream a device)."""
    bufs = _COUNTERS.setdefault((name, device.index), [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.zeros(max(n, 1024), dtype=torch.int32,
                                device=device))
    return bufs[-1]


def extension(verbose: bool = False, defines: tuple = ()):
    """The loaded kernel extension, built on the first call.

    ``verbose`` shows the compiler's output, ptxas' register and
    shared-memory report included.  ``defines`` (``("NAME=value", ...)``)
    builds and loads instead a copy compiled with those macros, in a
    directory of its own: the timing copies of `csrc/ssd_scan.cu`
    (``SSD_VARIANT``, ``SSD_KEYS``), which no wrapper launches.  A build
    that fails raises."""
    global _EXT
    defines = tuple(defines)
    if defines:
        if defines not in _COPIES:
            _COPIES[defines] = _load(verbose, defines)
        return _COPIES[defines]
    if _EXT is None:
        _EXT = _load(verbose, ())
    return _EXT


def _load(verbose: bool, defines: tuple):
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device")
    from torch.utils.cpp_extension import load

    tag = "_".join(d.replace("=", "") for d in defines)
    out = BUILD_DIR / tag if tag else BUILD_DIR
    out.mkdir(parents=True, exist_ok=True)
    flags = list(CUDA_FLAGS) + [f"-D{d}" for d in defines] + (
        ["-Xptxas=-v"] if verbose else [])
    return load(name="repro_torch_kernels" + (f"_{tag}" if tag else ""),
                sources=[str(CSRC / s) for s in SOURCES],
                build_directory=str(out), extra_cflags=["-O2", "-std=c++17"],
                extra_cuda_cflags=flags, verbose=verbose)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_of(t: torch.Tensor) -> int:
    """Handle of the current CUDA stream on ``t``'s device, as an int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is contiguous and on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: every operand must lie on one CUDA "
                             f"device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor starts on a 16-byte boundary: the
    attention kernels copy 16 bytes at a time, and a TMA tensor map takes
    no other base address."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: operands must start on 16-byte "
                         f"boundaries (the kernels copy 16 bytes)")
