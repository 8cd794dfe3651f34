"""Binding of `csrc/ssd_scan.cu`: the Mamba2 SSD chunked scan
(`repro.kernels.ssd_scan` counterpart; the plain versions are
`ref.ssd_scan_chunked` and, rounded the way the bf16 kernel rounds,
`ref.ssd_scan_tiled`)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES

MAX_SMEM = 232448  # shared-memory bytes a Hopper block can use
MAX_STATE = 128    # N: the float32 update gives each thread 4 x 4 states,
                   # the bf16 kernel pads N to 64 or 128
SLICE = 64         # head channels a bf16 block takes


def blocks(B: int, Hn: int, P: int, runs: int) -> int:
    """Blocks of a bf16 launch: grid (B x Hn, P / 64, runs)."""
    return B * Hn * -(-P // SLICE) * runs


def scan_runs(B: int, Hn: int, P: int, nchunks: int, sms: int) -> int:
    """Runs the bf16 launch cuts the chunks into, a block each: as many as
    fit in one wave of ``sms`` SMs, at most one a chunk, at least one.  A
    block walks the chunks before its run for their state updates alone,
    so more runs shorten the longest block while the wave has room."""
    return max(1, min(nchunks, sms // blocks(B, Hn, P, 1)))


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 256, init_state=None,
             return_state: bool = False):
    """x (B,S,Hn,P) and Bm/Cm (B,S,N), float32 or bfloat16 of one dtype,
    dt (B,S,Hn) and A (Hn,) float32, optional ``init_state`` (B,Hn,P,N)
    float32 -> y (B,S,Hn,P) in x's dtype [, final state (B,Hn,P,N) float32],
    on the card, in chunks of ``min(chunk, S)`` steps.  N is a multiple of
    4 up to ``MAX_STATE``.  Any S works: the kernel masks the ragged last
    chunk itself.  One call is one counted launch of one kernel."""
    operands = (x, dt, A, Bm, Cm) + (
        (init_state,) if init_state is not None else ())
    _build.check_cuda("ssd_scan", *operands)
    check_operands(x, dt, A, Bm, Cm, chunk, init_state)
    B, S, Hn, P = x.shape
    Q = min(chunk, S) if S else 1
    runs = scan_runs(B, Hn, P, -(-S // Q), _build.sm_count(x.device.index))
    return _launch(x, dt, A, Bm, Cm, Q, init_state, return_state, runs)


def check_operands(x, dt, A, Bm, Cm, chunk: int, init_state=None) -> None:
    """Raise unless the kernel takes these dtypes and shapes (see
    `ssd_scan`)."""
    B, S, Hn, P = x.shape
    N = Bm.shape[-1]
    if x.dtype not in DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype \
            or dt.dtype != torch.float32 or A.dtype != torch.float32 or (
                init_state is not None and init_state.dtype != torch.float32):
        raise TypeError(f"ssd_scan takes float32 or bfloat16 x/B/C of one "
                        f"dtype and float32 dt, A and state, got {x.dtype}/"
                        f"{Bm.dtype}/{Cm.dtype}/{dt.dtype}/{A.dtype}")
    if dt.shape != (B, S, Hn) or A.shape != (Hn,) or Bm.shape != (B, S, N) \
            or Cm.shape != Bm.shape or N % 4 or N > MAX_STATE or chunk < 1 or (
                init_state is not None and init_state.shape != (B, Hn, P, N)):
        raise ValueError(f"ssd_scan: unsupported shapes x {x.shape}, dt "
                         f"{dt.shape}, A {A.shape}, B {Bm.shape}, C "
                         f"{Cm.shape}, chunk {chunk}")


def _launch(x, dt, A, Bm, Cm, Q: int, init_state, return_state: bool,
            runs: int):
    """Launch the kernel on checked operands, the bf16 kernel with the
    chunks in ``runs`` runs (the float32 kernel ignores it)."""
    B, S, Hn, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    state = (torch.empty(B, Hn, P, N, dtype=torch.float32, device=x.device)
             if return_state else None)
    if x.numel() == 0:
        if state is not None:
            state.copy_(init_state if init_state is not None else 0.0)
        return (y, state) if return_state else y
    ext = _build.extension()
    smem = ext.ssd_smem_bytes(Q, N, DTYPES[x.dtype])
    if smem > MAX_SMEM:
        raise ValueError(f"ssd_scan: chunk {Q} with state {N} needs {smem} "
                         f"bytes of shared memory a block, over {MAX_SMEM}")
    ext.ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), 0 if init_state is None else init_state.data_ptr(),
        y.data_ptr(), 0 if state is None else state.data_ptr(), B, S, Hn, P,
        N, Q, DTYPES[x.dtype], runs, _build.stream_of(x))
    _build.count_launch("ssd_scan")
    return (y, state) if return_state else y
