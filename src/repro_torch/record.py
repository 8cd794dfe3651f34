"""The record a dry run (`repro_torch.launch.dryrun`) fills while it
traces a step: what the kernels' shape routes (`kernels.ops`), the
activation constraints (`dist.act_sharding.constrain`) and the
collectives (`dist.sharding`) add to it.

Nothing is recorded unless a dry run has installed a record with
`recording`; every writer first reads `active()`, one ``None`` check.
The record is process-wide, not per thread: autograd may run a backward
on a thread of its own.
"""
from __future__ import annotations

import contextlib
import dataclasses


@dataclasses.dataclass
class TraceRecord:
    """What one traced step did on this rank.

    ``mesh_shape`` (axis -> extent) prices the constraint sites; the rest
    is filled by the trace: ``launches``, ``kernel_flops`` and
    ``kernel_bytes`` by kernel (`kernels.cost`'s counts), ``collectives``
    by kind (``{"count", "bytes"}``) and one by one in ``calls`` (bytes,
    kind, operand), and ``sites``, every constraint in call order."""

    mesh_shape: dict = dataclasses.field(default_factory=dict)
    launches: dict = dataclasses.field(default_factory=dict)
    kernel_flops: dict = dataclasses.field(default_factory=dict)
    kernel_bytes: dict = dataclasses.field(default_factory=dict)
    collectives: dict = dataclasses.field(default_factory=dict)
    calls: list = dataclasses.field(default_factory=list)
    sites: list = dataclasses.field(default_factory=list)

    def kernel(self, name: str, work) -> None:
        """One launch of kernel ``name`` doing ``work`` = (bytes,
        operations)."""
        self.launches[name] = self.launches.get(name, 0) + 1
        self.kernel_bytes[name] = self.kernel_bytes.get(name, 0.0) + work[0]
        self.kernel_flops[name] = self.kernel_flops.get(name, 0.0) + work[1]

    def collective(self, kind: str, nbytes: int, operand: str = "") -> None:
        """One collective of ``kind`` over ``nbytes`` operand bytes
        (``operand``: its dtype and shape, as ``bfloat16[16,4096]``)."""
        c = self.collectives.setdefault(kind, {"count": 0, "bytes": 0})
        c["count"] += 1
        c["bytes"] += int(nbytes)
        self.calls.append((int(nbytes), kind, operand))

    def site(self, logical: tuple, spec: tuple, shape: tuple, dtype,
             nbytes: int) -> None:
        """One constraint: its logical names, the mesh axes they resolve
        to, this rank's shape and dtype and its bytes.  The port shards no
        activation over ``"model"``, so each dimension the spec names for
        tensor parallelism (logical ``"tp"``) is recorded as not realised,
        with the bytes a realised one would shard away."""
        n = 1
        for name, axes in zip(logical, spec):
            if name == "tp" and axes is not None:
                for a in (axes,) if isinstance(axes, str) else axes:
                    n *= int(self.mesh_shape.get(a, 1))
        self.sites.append({
            "logical": list(logical), "spec": [_jsonable(a) for a in spec],
            "shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
            "bytes": int(nbytes), "tp_realised": False,
            "tp_unrealised_bytes": int(nbytes - nbytes // n) if n > 1 else 0,
        })

    def totals(self) -> dict:
        """The record as plain numbers (for a JSON report)."""
        return {
            "launches": dict(sorted(self.launches.items())),
            "kernel_flops": dict(sorted(self.kernel_flops.items())),
            "kernel_bytes": dict(sorted(self.kernel_bytes.items())),
            "collectives": {k: dict(v) for k, v in
                            sorted(self.collectives.items())},
            "sites": len(self.sites),
            "site_bytes": sum(s["bytes"] for s in self.sites),
            "tp_unrealised_bytes": sum(s["tp_unrealised_bytes"]
                                       for s in self.sites),
        }


def _jsonable(a):
    return list(a) if isinstance(a, tuple) else a


_ACTIVE: TraceRecord | None = None


def active() -> TraceRecord | None:
    """The record being filled, or None outside a dry run."""
    return _ACTIVE


@contextlib.contextmanager
def recording(rec: TraceRecord):
    """Fill ``rec`` for the enclosed trace, then restore the record that
    was active before."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, rec
    try:
        yield rec
    finally:
        _ACTIVE = prev


def shape_str(t) -> str:
    """``dtype[d0,d1,...]`` of a tensor, as HLO writes a buffer's type."""
    return (str(t.dtype).replace("torch.", "")
            + "[" + ",".join(str(d) for d in t.shape) + "]")


def tensor_bytes(t) -> int:
    """Bytes of a tensor's (or numpy array's) elements."""
    if hasattr(t, "element_size"):
        return t.numel() * t.element_size()
    return int(t.nbytes)


