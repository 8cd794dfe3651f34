"""Logical activation-sharding constraints (`repro.dist.act_sharding`).

Model code names the sharding of its intermediates with *logical* axes,
``"dp"`` (data parallel) and ``"tp"`` (tensor parallel), via `constrain`.
The mapping from logical names to mesh axes is ambient, per thread,
installed by `use_mesh_axes` (a dry run's ``--opt`` mode does this around
its trace).  With no mapping active `constrain` returns ``x`` itself, so
the same model code runs unchanged on one device and in the tests.

`repro` hands the resolved spec to ``with_sharding_constraint``.  The
port shards activations only by rows (each rank runs its rows of the
batch, `dist.fsdp.split_batch`) and has no tensor parallelism, so a
mapped `constrain` changes nothing either: it returns ``x`` and, in a
dry run, records the site (`repro_torch.record.TraceRecord.site`: the
spec, this rank's shape, dtype and bytes, each ``"tp"`` dimension
recorded as not realised).
"""
from __future__ import annotations

import contextlib
import threading

from repro_torch import record

_STATE = threading.local()


def _mapping() -> dict | None:
    return getattr(_STATE, "axes", None)


@contextlib.contextmanager
def use_mesh_axes(dp, tp):
    """Map logical axes to mesh axes for the enclosed code: ``"dp" -> dp``
    and ``"tp" -> tp``.  ``dp`` may be one axis name or a tuple of axes
    (FSDP over ``("pod", "data")`` on the multi-pod mesh).  The mapping
    that was active before comes back on exit."""
    prev = _mapping()
    _STATE.axes = {"dp": dp, "tp": tp}
    try:
        yield
    finally:
        _STATE.axes = prev


def resolve(*logical) -> tuple:
    """The mesh axes of ``logical`` under the active mapping, one entry a
    dimension, as `repro` builds its ``PartitionSpec``: a mapped name's
    axes, None for None or an unmapped name."""
    m = _mapping() or {}
    return tuple(m.get(a) if isinstance(a, str) else None for a in logical)


def constrain(x, *logical):
    """``x`` under the active logical mapping: ``logical`` has one entry a
    dimension of ``x``, ``"dp"``, ``"tp"`` or None.  Returns ``x`` itself;
    with a mapping active and a dry run recording, the site is
    recorded."""
    if _mapping() is None:
        return x
    rec = record.active()
    if rec is not None:
        rec.site(logical, resolve(*logical), tuple(x.shape), x.dtype,
                 x.numel() * x.element_size())
    return x
