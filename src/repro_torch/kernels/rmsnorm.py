"""Binding of `csrc/rmsnorm.cu`: row RMSNorm in float32, cast back to the
input dtype (`repro.kernels.rmsnorm` counterpart; the plain version is
`ref.rms_norm`)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES


def rms_norm(x, scale, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last axis of ``x``
    (float32 or bfloat16) with a float32 ``scale``, on the card."""
    _build.check_cuda("rms_norm", x, scale)
    D = x.shape[-1]
    if x.dtype not in DTYPES or scale.dtype != torch.float32:
        raise TypeError(f"rms_norm takes float32 or bfloat16 x and a "
                        f"float32 scale, got {x.dtype}/{scale.dtype}")
    if scale.shape != (D,):
        raise ValueError(f"rms_norm: scale {scale.shape} != ({D},)")
    out = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return out
    _build.extension().rms_norm(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D, float(eps),
        DTYPES[x.dtype], _build.stream_of(x))
    _build.count_launch("rms_norm")
    return out
