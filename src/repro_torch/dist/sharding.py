"""The control plane's lane sharding over `torch.distributed`
(`repro.dist.sharding`'s lane half).

`repro` shards the serving runtime's slot lanes over a 1-D
``jax.sharding.Mesh`` with axis ``"lanes"``; here the mesh is a process
group, one rank per device, each rank planning on its own device:

- `LaneMesh` / `lane_mesh` — the group, this rank, the group's size and
  the device this rank plans on;
- `lane_counts` — lanes padded to a multiple of the mesh size (pad lanes
  are dead), `repro`'s rule; `lane_block` — the contiguous block of lanes
  a rank owns, the counterpart of `repro`'s ``lane_spec``;
- `all_reduce_sum` and `merge_plans` — the collectives of the sharded
  control plane, each counted by `collectives`.  Plans merge in one small
  integer all-reduce of plans encoded ``+1``: a rank that does not own a
  lane contributes 0, so the sum is the owner's value in any order.
  Under NCCL the operand lives on the device; under gloo it is an
  explicit host copy.

`repro.dist.sharding`'s parameter, batch and cache heuristics
(``spec_tree``, ``batch_specs``, ``cache_specs``, ``sharding_tree``) come
with ``train(mesh=)`` in a later slice.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

LANE_AXIS = "lanes"

_COLLECTIVES = 0  # collectives issued through this module in this process


def collectives() -> int:
    """Collectives the port has issued in this process (`all_reduce_sum`,
    `merge_plans`, `gather_objects`), as `repro_torch.device.host_reads`
    counts host reads: a sharded replan round makes exactly one."""
    return _COLLECTIVES


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


def all_reduce_sum(t: torch.Tensor, mesh: LaneMesh) -> torch.Tensor:
    """One counted sum over the mesh.  Under NCCL the sum runs in place on
    a device copy of ``t`` (on ``mesh.device``) and comes back there;
    under gloo it runs on an explicit host copy and comes back on the
    host.  ``t`` itself is never written."""
    global _COLLECTIVES
    if mesh.backend == "nccl":
        buf = t.to(mesh.device, copy=True)
    else:
        buf = t.to("cpu", copy=True)
    _COLLECTIVES += 1
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf


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
    global _COLLECTIVES
    out = [None] * mesh.size
    _COLLECTIVES += 1
    dist.all_gather_object(out, obj, group=mesh.group)
    return out
