"""`repro.dist.sharding` on `torch.distributed`: the parameter, batch and
cache spec heuristics, the training mesh, and the control plane's lane
sharding, with every collective of the port counted here.

**The spec rules** (`spec_tree`, `batch_specs`, `cache_specs`) are
`repro`'s, rule for rule and in the same order; they read only
``mesh.axis_names`` and a ``mesh.shape`` mapping, so shape-only stand-ins
work.  A spec is a plain tuple with one entry a dimension: ``None``, an
axis name, or a tuple of axis names such as ``("pod", "data")``; a scalar
gets ``()``.

- params:  FSDP-style, ONE sharded axis a leaf: the largest dimension
           divisible by the data axes (``"data"`` or ``("pod", "data")``),
           else ``"model"`` on the last dimension that divides the model
           extent.  `repro`'s quirk is kept: on a mesh without a
           ``"model"`` axis the model extent reads 1, so a leaf with no
           dimension divisible by the data extent gets ``"model"``, an
           axis that mesh lacks (`check_specs` refuses it by name, as
           `repro`'s ``NamedSharding`` does).
- batches: the leading (batch) dimension over the data axes when it
           divides.
- caches:  dimension 1 (the request batch) over the data axes, the model
           axis on the first later dimension that divides (kv heads, else
           the sequence).

**The training mesh**: `TrainMesh` / `train_mesh`, ranks laid out
row-major over ``axis_names`` with process groups for each axis (and for
``("pod", "data")`` together); `Sharding` pairs it with a spec, as
``NamedSharding`` does, and `sharding_tree` gives one a leaf.

**The lane sharding** (the serving control plane): `repro` shards the
slot lanes over a 1-D ``jax.sharding.Mesh`` with axis ``"lanes"``; here
the mesh is a process group, one rank per device:

- `LaneMesh` / `lane_mesh` — the group, this rank, the group's size and
  the device this rank plans on;
- `lane_counts` — lanes padded to a multiple of the mesh size (pad lanes
  are dead), `repro`'s rule; `lane_block` — the contiguous block of lanes
  a rank owns, the counterpart of `repro`'s ``lane_spec``;
- `merge_plans` merges plans in one small integer all-reduce of plans
  encoded ``+1``: a rank that does not own a lane contributes 0, so the
  sum is the owner's value in any order.

**The collectives** (`all_reduce_sum`, `gather_dim`, `reduce_scatter_dim`,
`gather_objects`, and `merge_plans` through `all_reduce_sum`) are each
counted by `collectives`, their operand bytes by `collective_bytes`.
Under NCCL the operands live on the device.  Under gloo they go through
explicit host copies: gloo's CUDA support covers broadcast and
all-reduce only, and NCCL refuses two ranks on one card, so ranks that
share a card stage every collective through the host, in staging
buffers reused from step to step, a training collective split over
GLOO_PARTS process groups at once.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import warnings

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

LANE_AXIS = "lanes"
TRAIN_AXES = (("data",), ("data", "model"), ("pod", "data", "model"))
# gloo collectives split into this many parts over as many process groups
# at once: 1.5-2.1x the bytes a second of one collective between two
# ranks on the card's host (tools/host_staging_probe.py)
GLOO_PARTS = 4

_COLLECTIVES = 0  # collectives issued through this module in this process
# operand bytes: full tensors out of `gather_dim`, into `reduce_scatter_dim`
# and `all_reduce_sum`
_BYTES = {"gathered": 0, "reduced": 0}


def collectives() -> int:
    """Collectives the port has issued in this process (`all_reduce_sum`,
    `merge_plans`, `gather_dim`, `reduce_scatter_dim`, `gather_objects`),
    as `repro_torch.device.host_reads` counts host reads: a sharded replan
    round makes exactly one."""
    return _COLLECTIVES


def collective_bytes() -> dict:
    """``{"gathered": the bytes of every tensor `gather_dim` assembled,
    "reduced": the bytes of every operand `reduce_scatter_dim` and
    `all_reduce_sum` summed}`` in this process."""
    return dict(_BYTES)


def _count(kind: str | None, t: torch.Tensor | None) -> None:
    global _COLLECTIVES
    _COLLECTIVES += 1
    if kind is not None:
        _BYTES[kind] += t.numel() * t.element_size()


# ----------------------------------------------------------------------
# the spec heuristics (`repro.dist.sharding`, rule for rule)
# ----------------------------------------------------------------------
def _mesh_sizes(mesh):
    shape = dict(mesh.shape)
    data_axes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    data = data_axes if len(data_axes) > 1 else data_axes[0]
    dsize = math.prod(int(shape[a]) for a in data_axes)
    msize = int(shape.get("model", 1))
    return data, dsize, msize


def _divides(dim: int, size: int) -> bool:
    return dim >= size and dim % size == 0


def _param_spec(shape, data, dsize, msize) -> tuple:
    nd = len(shape)
    if nd == 0:
        return ()
    spec: list = [None] * nd
    for i in sorted(range(nd), key=lambda i: shape[i], reverse=True):
        if _divides(shape[i], dsize):
            spec[i] = data
            return tuple(spec)
    for i in reversed(range(nd)):
        if _divides(shape[i], msize):
            spec[i] = "model"
            return tuple(spec)
    return tuple(spec)


def _shape(leaf) -> tuple[int, ...]:
    """A leaf's shape: a tensor's or array's, a tuple of ints taken as a
    shape, and ``()`` for a Python or numpy scalar."""
    if hasattr(leaf, "shape"):
        return tuple(int(d) for d in leaf.shape)
    if isinstance(leaf, (tuple, list)) and all(
            isinstance(d, int) for d in leaf):
        return tuple(leaf)
    if isinstance(leaf, (int, float)):
        return ()
    raise TypeError(f"no shape for a leaf of type {type(leaf).__name__}")


def _map(fn, tree):
    """``fn`` on every leaf's shape of ``tree``: nested dicts whose leaves
    are tensors, arrays, shapes or scalars."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(_shape(tree))


def spec_tree(params, mesh):
    """The spec of every parameter leaf: ``params`` is the port's master
    dict (`TrainModel.params`, keys joined by ``@``), a dict of shapes
    (`models.param_shapes`) or any nested dict of such leaves (an
    optimizer state)."""
    data, dsize, msize = _mesh_sizes(mesh)
    return _map(lambda s: _param_spec(s, data, dsize, msize), params)


def batch_specs(batch, mesh):
    """Model inputs: the leading (batch) dimension over the data axes."""
    data, dsize, _ = _mesh_sizes(mesh)

    def spec(shape):
        nd = len(shape)
        if nd == 0:
            return ()
        if _divides(shape[0], dsize):
            return (data,) + (None,) * (nd - 1)
        return (None,) * nd

    return _map(spec, batch)


def cache_specs(cache, mesh) -> dict:
    """Decode-cache specs, field by field of the port's cache dataclasses
    (`KVCache`, `MLACache`, `SSMCache`, `EncDecCache`; layouts ``(layers,
    batch, ...)``), or of a dict: the host ints ``len`` / ``pos`` get
    ``()``, as `repro`'s scalars, and a field that is None (a Mamba2
    cache's attention keys) is left out, as `repro`'s dict has none."""
    data, dsize, msize = _mesh_sizes(mesh)
    fields = cache if isinstance(cache, dict) else {
        f.name: getattr(cache, f.name) for f in dataclasses.fields(cache)}

    def spec(shape):
        nd = len(shape)
        if nd < 2:
            return ()
        s: list = [None] * nd
        if _divides(shape[1], dsize):
            s[1] = data
        for i in range(2, nd):
            if _divides(shape[i], msize):
                s[i] = "model"
                break
        return tuple(s)

    return {k: spec(_shape(v)) for k, v in fields.items() if v is not None}


def spec_axes(spec: tuple) -> list[tuple[int, tuple[str, ...]]]:
    """``(dimension, axes)`` of each sharded dimension of ``spec``, its
    axes as a tuple in the spec's order."""
    return [(d, (a,) if isinstance(a, str) else tuple(a))
            for d, a in enumerate(spec) if a is not None]


def check_specs(specs, mesh, prefix: str = "") -> None:
    """Raise ``ValueError`` naming the leaf and the axis when a spec of
    ``specs`` (a nested dict of specs) names an axis ``mesh`` lacks."""
    if isinstance(specs, dict):
        for k, v in specs.items():
            check_specs(v, mesh, f"{prefix}@{k}" if prefix else str(k))
        return
    for _, axes in spec_axes(specs):
        for a in axes:
            if a not in mesh.axis_names:
                raise ValueError(
                    f"leaf {prefix!r}: spec {specs} names axis {a!r}, which "
                    f"the mesh {tuple(mesh.axis_names)} lacks")


# ----------------------------------------------------------------------
# the training mesh
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TrainMesh:
    """A mesh of ranks for sharded training: ``axis_names`` (one of
    `TRAIN_AXES`), ``shape`` (axis -> extent), this rank and its
    coordinates (ranks laid out row-major, the last axis fastest), the
    device it computes on, the backend, and the process groups: ``groups``
    maps a tuple of axes (each axis alone, and the data axes together) to
    the groups of the ranks that differ only on them, ordered as the
    axes' row-major index (GLOO_PARTS groups of the same ranks under
    gloo, one under NCCL); ``group`` is the whole mesh."""

    axis_names: tuple
    shape: dict
    rank: int
    coords: dict
    device: torch.device
    backend: str
    groups: dict
    group: object

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def data_axes(self) -> tuple[str, ...]:
        return tuple(a for a in self.axis_names if a in ("pod", "data"))

    def block(self, axes: tuple[str, ...]) -> tuple[int, int]:
        """``(index, count)``: this rank's block of a dimension sharded over
        ``axes``, in the axes' order."""
        idx, n = 0, 1
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} is not an axis of the mesh "
                                 f"{self.axis_names}")
            idx, n = idx * self.shape[a] + self.coords[a], n * self.shape[a]
        return idx, n

    def owner(self, axes: tuple[str, ...]) -> bool:
        """Whether this rank is the one copy, among the ranks holding the
        same block of a leaf sharded over ``axes``, that counts it: its
        coordinate is 0 on every other axis."""
        return all(self.coords[a] == 0 for a in self.axis_names
                   if a not in axes)


def train_mesh(shape, axes, device: str | torch.device = "cuda") -> TrainMesh:
    """The training mesh of extents ``shape`` over ``axes`` (``("data",)``,
    ``("data", "model")`` or ``("pod", "data", "model")``) on the default
    process group, which must hold exactly ``prod(shape)`` ranks; every
    rank calls it (the axis groups are made here, in one order).  On
    ``"cuda"`` rank r computes on ``cuda:{r % torch.cuda.device_count()}``.
    Raises ``ValueError`` on other axes, a bad extent, or a missing or
    wrong-size group, naming the recipe that starts one
    (`repro_torch.dist.spawn`, or ``torchrun --nproc-per-node n``)."""
    axes, shape = tuple(axes), tuple(int(s) for s in shape)
    if axes not in TRAIN_AXES:
        raise ValueError(f"training mesh axes {axes}: expected one of "
                         f"{TRAIN_AXES}")
    if len(shape) != len(axes) or min(shape) < 1:
        raise ValueError(f"training mesh shape {shape} does not give an "
                         f"extent >= 1 to each of {axes}")
    n = math.prod(shape)
    have = dist.get_world_size() \
        if dist.is_available() and dist.is_initialized() else 0
    if have != n:
        raise ValueError(
            f"training mesh {dict(zip(axes, shape))} needs {n} ranks but "
            + (f"the process group holds {have}" if have
               else "no process group is initialised")
            + f": start {n} ranks with repro_torch.dist.spawn(fn, {n}, "
            f"device=...) or torchrun --nproc-per-node {n}, and call this "
            "on every rank")
    dev = resolve_device(device)
    rank = dist.get_rank()
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    extent = dict(zip(axes, shape))
    coords, r = {}, rank
    for a in reversed(axes):
        coords[a], r = r % extent[a], r // extent[a]
    data_axes = tuple(a for a in axes if a in ("pod", "data"))
    keys = [(a,) for a in axes] + ([data_axes] if len(data_axes) > 1 else [])
    backend = str(dist.get_backend())
    parts = GLOO_PARTS if backend == "gloo" else 1
    groups = {}
    for key in keys:
        rest = [a for a in axes if a not in key]
        for fixed in itertools.product(*(range(extent[a]) for a in rest)):
            at = dict(zip(rest, fixed))
            ranks = []
            for inner in itertools.product(*(range(extent[a]) for a in key)):
                at.update(zip(key, inner))
                ranks.append(_ravel(at, axes, extent))
            gs = tuple(dist.new_group(sorted(ranks)) for _ in range(parts))
            if rank in ranks:
                groups[key] = gs
    return TrainMesh(axis_names=axes, shape=extent, rank=rank, coords=coords,
                     device=dev, backend=backend, groups=groups,
                     group=dist.group.WORLD)


def _ravel(at: dict, axes, extent) -> int:
    r = 0
    for a in axes:
        r = r * extent[a] + at[a]
    return r


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh and a spec (`repro`'s ``NamedSharding``): `shard` cuts a full
    leaf to this rank's block, the even block of each sharded dimension
    over its axes."""

    mesh: TrainMesh
    spec: tuple

    def shard_shape(self, shape) -> tuple[int, ...]:
        shape = list(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} is longer than the shape "
                             f"{tuple(shape)}")
        for d, axes in spec_axes(self.spec):
            _, n = self.mesh.block(axes)
            if shape[d] % n:
                raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                                 f"split evenly over {axes} ({n})")
            shape[d] //= n
        return tuple(shape)

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full``, a new contiguous tensor on the
        mesh's device."""
        out = torch.empty(self.shard_shape(full.shape), dtype=full.dtype,
                          device=self.mesh.device)
        x = full
        for d, axes in spec_axes(self.spec):
            idx, _ = self.mesh.block(axes)
            x = x.narrow(d, idx * out.shape[d], out.shape[d])
        return out.copy_(x)


def sharding_tree(params, mesh: TrainMesh):
    """A `Sharding` for every leaf of ``params`` (as `spec_tree` takes it),
    for a checkpoint's elastic restore; refuses a spec that names an axis
    the mesh lacks (`check_specs`)."""
    specs = spec_tree(params, mesh)
    check_specs(specs, mesh)

    def pair(tree):
        if isinstance(tree, dict):
            return {k: pair(v) for k, v in tree.items()}
        return Sharding(mesh, tree)

    return pair(specs)


@dataclasses.dataclass(frozen=True)
class LaneMesh:
    """A 1-D mesh of ranks over the slot lanes: the process group, this
    process's rank in it, its size, the device this rank plans on and the
    group's backend."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str

    @property
    def shape(self) -> dict:
        """``{LANE_AXIS: size}``, as `repro`'s mesh reads."""
        return {LANE_AXIS: self.size}


def lane_mesh(n_devices: int, device: str | torch.device = "cuda") -> LaneMesh:
    """The lane mesh over the default process group, which must hold
    exactly ``n_devices`` ranks.  On ``"cuda"`` rank r plans on
    ``cuda:{r % torch.cuda.device_count()}``; on ``"cpu"`` every rank plans
    on the host.  Raises ``ValueError`` when ``n_devices < 1`` or when no
    group of that size is initialised, naming the recipe that starts one
    (`repro_torch.dist.spawn`, or ``torchrun --nproc-per-node n``), as
    `repro`'s names ``XLA_FLAGS``."""
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"lane mesh needs >= 1 device, got {n}")
    have = dist.get_world_size() \
        if dist.is_available() and dist.is_initialized() else 0
    if have != n:
        raise ValueError(
            f"lane mesh over {n} ranks requested but "
            + (f"the process group holds {have}" if have
               else "no process group is initialised")
            + f": start {n} ranks with repro_torch.dist.spawn(fn, {n}, "
            f"device=...) or torchrun --nproc-per-node {n}, and call this "
            "on every rank")
    dev = resolve_device(device)
    rank = dist.get_rank()
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return LaneMesh(group=dist.group.WORLD, rank=rank, size=n, device=dev,
                    backend=str(dist.get_backend()))


def lane_counts(n_lanes: int, mesh) -> tuple[int, int]:
    """``(padded_lanes, lanes_per_rank)`` for ``n_lanes`` slot lanes on
    ``mesh``: lanes are padded up to a multiple of the mesh size so every
    rank holds an equal block (pad lanes are dead — never read)."""
    n_sh = int(mesh.shape[LANE_AXIS])
    per = -(-int(n_lanes) // n_sh)
    return per * n_sh, per


def lane_block(n_lanes: int, mesh: LaneMesh) -> tuple[int, int]:
    """``(base, per)``: this rank owns lanes ``[base, base + per)`` of the
    padded lanes, the block `repro`'s ``lane_spec`` gives its device."""
    _, per = lane_counts(n_lanes, mesh)
    return mesh.rank * per, per


def all_reduce_sum(t: torch.Tensor, mesh, axes: tuple | None = None
                   ) -> torch.Tensor:
    """One counted sum over the mesh (a `TrainMesh`'s ``axes`` group when
    given).  Under NCCL the sum runs in place on a device copy of ``t``
    (on ``mesh.device``) and comes back there; under gloo it runs on an
    explicit host copy and comes back on the host.  ``t`` itself is never
    written."""
    if mesh.backend == "nccl":
        buf = t.to(mesh.device, copy=True)
    else:
        buf = t.to("cpu", copy=True)
    _count("reduced", buf)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM,
                    group=mesh.group if axes is None else mesh.groups[axes][0])
    return buf


# gloo's host copies: (shape, dtype) -> a host buffer every collective
# reuses (pinned when the ranks compute on CUDA), so a training step
# faults in no new host pages; a collective's input (parts, m) and output
# (parts, ranks, m) never share a shape
_STAGING: dict = {}


def _host_buffer(shape, dtype, mesh: TrainMesh) -> torch.Tensor:
    key = (tuple(shape), dtype)
    if key not in _STAGING:
        _STAGING[key] = torch.empty(
            shape, dtype=dtype, pin_memory=mesh.device.type == "cuda")
    return _STAGING[key]


def _parts(mesh: TrainMesh, axes: tuple, numel: int) -> tuple:
    """The process groups a gloo collective of ``numel`` elements a rank
    runs over at once, in equal parts: the most of the ``axes`` groups
    that split it evenly."""
    gs = mesh.groups[axes]
    return gs[:next(k for k in range(len(gs), 0, -1) if numel % k == 0)]


def _wait(works) -> None:
    for w in works:
        w.wait()


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``: a CUDA tensor bound for the host lands in new
    pinned memory (twice the rate of new pageable pages on the card's
    host, `tools/host_staging_probe.py`)."""
    if torch.device(device).type == "cpu" and t.is_cuda:
        return torch.empty(t.shape, dtype=t.dtype,
                           pin_memory=True).copy_(t)
    return t.to(device)


def gather_dim(shard: torch.Tensor, dim: int, axes: tuple, mesh: TrainMesh,
               device: str | torch.device | None = None,
               root: bool = False) -> torch.Tensor | None:
    """The full tensor whose blocks along ``dim`` the ranks of the ``axes``
    group hold, in the group's order: one counted all-gather, on
    ``device`` (default ``mesh.device``).  With ``root``, only rank 0
    receives it, by one counted gather over rank 0's group; every other
    rank gets None (ranks of the other groups, whose blocks rank 0's
    group replicates, issue nothing).  Under gloo the host operands are
    staging buffers, the collective split over the axes' process groups
    at once (`_parts`).  The layout moves happen on the mesh's device,
    never in host copies."""
    if root and not mesh.owner(axes):
        return None
    _, n = mesh.block(axes)
    x = shard.movedim(dim, 0).contiguous()
    shape = (n * x.shape[0],) + tuple(x.shape[1:])
    with warnings.catch_warnings():  # renamed *_single in torch 2.13
        warnings.simplefilter("ignore", FutureWarning)
        if mesh.backend == "nccl":
            g = mesh.groups[axes][0]
            out = torch.empty(shape, dtype=x.dtype, device=x.device)
            _count("gathered", out)
            if root:
                dist.gather(x, list(out.chunk(n)) if mesh.rank == 0
                            else None, dst=0, group=g)
            else:
                dist.all_gather_into_tensor(out, x, group=g)
        else:
            gs = _parts(mesh, axes, x.numel())
            k = len(gs)
            m = x.numel() // k
            src = _host_buffer((k, m), x.dtype, mesh)
            src.copy_(x.view(k, m))
            parts = _host_buffer((k, n, m), x.dtype, mesh)
            _count("gathered", parts)
            _wait([dist.gather(src[j], list(parts[j]) if mesh.rank == 0
                               else None, dst=0, group=g, async_op=True)
                   if root else dist.all_gather_into_tensor(
                       parts[j].view(-1), src[j], group=g, async_op=True)
                   for j, g in enumerate(gs)])
    if root and mesh.rank != 0:
        return None
    if mesh.backend != "nccl":  # (part, rank, m) -> the ranks' blocks
        out = parts.to(mesh.device, copy=True).transpose(0, 1).reshape(shape)
    return to_device(out.movedim(0, dim).contiguous(),
                     mesh.device if device is None else device)


def reduce_scatter_dim(full: torch.Tensor, dim: int, axes: tuple,
                       mesh: TrainMesh) -> torch.Tensor:
    """The sum over the ``axes`` group of every rank's ``full``, of which
    this rank keeps its block along ``dim``: one counted reduce-scatter,
    on ``mesh.device`` (under gloo through staging buffers, split over
    the axes' process groups at once, as `gather_dim`).  ``full`` is never
    written."""
    _, n = mesh.block(axes)
    x = full.movedim(dim, 0).contiguous()  # an input NCCL only reads
    shape = (x.shape[0] // n,) + tuple(x.shape[1:])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        if mesh.backend == "nccl":
            out = torch.empty(shape, dtype=x.dtype, device=x.device)
            _count("reduced", x)
            dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM,
                                       group=mesh.groups[axes][0])
        else:
            gs = _parts(mesh, axes, x.numel() // n)
            k = len(gs)
            m = x.numel() // n // k
            src = _host_buffer((k, n, m), x.dtype, mesh)
            src.copy_(x.view(n, k, m).transpose(0, 1))
            parts = _host_buffer((k, m), x.dtype, mesh)
            _count("reduced", src)
            _wait([dist.reduce_scatter_tensor(
                parts[j], src[j].view(-1), op=dist.ReduceOp.SUM, group=g,
                async_op=True) for j, g in enumerate(gs)])
            out = parts.to(mesh.device, copy=True).reshape(shape)
    return out.movedim(0, dim).contiguous()


def merge_plans(plans: torch.Tensor, owned: torch.Tensor,
                mesh: LaneMesh) -> torch.Tensor:
    """Every rank's plans of the lanes it owns, on every rank: ``plans``
    is an integer tensor whose last axis is the lanes, ``owned`` a bool
    lane mask true exactly on this rank's lanes (each lane has at most one
    owner).  The plans go out encoded ``+1`` and non-owners send 0, so the
    one int32 all-reduce (`all_reduce_sum`) is exact in any order; lanes
    no rank owns come back -1.  The result lies where the backend summed
    it (`all_reduce_sum`)."""
    enc = torch.where(owned, plans + 1, 0).to(torch.int32)
    return all_reduce_sum(enc, mesh) - 1


def gather_objects(obj, mesh: LaneMesh) -> list:
    """Every rank's ``obj`` (picklable), in rank order, on every rank: one
    counted collective."""
    out = [None] * mesh.size
    _count(None, None)
    dist.all_gather_object(out, obj, group=mesh.group)
    return out
