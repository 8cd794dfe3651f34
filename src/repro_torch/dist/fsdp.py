"""FSDP-style sharding of the training state over a `TrainMesh`: the
port's counterpart of `repro`'s ``jax.device_put(params,
sharding_tree(params, mesh))`` in ``train(mesh=)``.

Every master and every optimizer-state leaf lives on a rank only as its
shard under `spec_tree`: the even block of the spec's dimension over the
named axes (a leaf whose spec is ``None`` everywhere is replicated).  The
shards are plain tensors and every collective an explicit, counted call
of `repro_torch.dist.sharding` (FSDP2's ``fully_shard`` is not used: its
hooks fire on ``forward()`` where the step calls ``model.loss``, the
optimizers' in-place updates and quantisers would meet ``DTensor``s, and
its collectives on CUDA tensors over gloo are ones gloo lacks).

- `train_specs` — the spec of every master (`spec_tree` of
  `models.param_shapes`) and of every optimizer-state leaf (`spec_tree`
  of the state the optimizer would make for the full masters, drawn on
  the meta device), refused by `check_specs` when one names an axis the
  mesh lacks;
- `shard_tree` / `gather_tree` — a tree's shards under its specs, and
  the full tree back (one all-gather a sharded dimension of a leaf);
- `shard_masters` / `bind_masters` / `release_masters` — the model's
  float32 masters cut to this rank's shards (their full buffers
  released), gathered back into the model before a forward pass, and
  released after the update;
- `split_batch` — this rank's rows of a batch under `batch_specs`, and
  their weight in the global mean loss.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist.sharding import (
    Sharding,
    TrainMesh,
    batch_specs,
    check_specs,
    gather_dim,
    spec_axes,
    spec_tree,
    to_device,
)


def train_specs(cfg, opt_cfg, mesh) -> tuple[dict, dict]:
    """``(param specs, state specs)`` on ``mesh`` of the masters of the
    training form of ``cfg`` (an `ArchConfig`) and of its train state
    ``{"opt": ...}``, the state ``train.optimizer.make_optimizer(opt_cfg)``
    keeps for them; raises ``ValueError`` naming the leaf and the axis
    when a spec names an axis the mesh lacks."""
    from repro_torch.models.transformer import param_shapes
    from repro_torch.train.optimizer import make_optimizer

    shapes = param_shapes(cfg)
    pspecs = spec_tree(shapes, mesh)
    check_specs(pspecs, mesh)
    meta = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    sspecs = spec_tree({"opt": make_optimizer(opt_cfg)[0](meta)}, mesh)
    check_specs(sspecs, mesh)
    return pspecs, sspecs


def shard_tree(tree, specs, mesh: TrainMesh):
    """Each tensor leaf of ``tree`` cut to this rank's shard under its spec
    in ``specs`` (a new tensor on the mesh's device); other leaves as
    they are."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return Sharding(mesh, specs).shard(tree)
    return tree


def gather_leaf(shard: torch.Tensor, spec: tuple, mesh: TrainMesh,
                device=None, root: bool = False) -> torch.Tensor | None:
    """The full leaf of which ``shard`` is this rank's block under
    ``spec``: one counted all-gather a sharded dimension, on ``device``
    (default the mesh's); a leaf with no sharded dimension comes back as a
    copy, with no collective.  With ``root``, rank 0 alone gets the leaf
    and every other rank None (`gather_dim`'s ``root``: the last
    dimension's gather goes to rank 0 alone)."""
    dims = spec_axes(spec)
    if not dims:
        if root and mesh.rank != 0:
            return None
        return to_device(shard.clone(),
                         mesh.device if device is None else device)
    x = shard
    for i, (d, axes) in enumerate(dims):
        last = i == len(dims) - 1
        x = gather_dim(x, d, axes, mesh, device=device if last else None,
                       root=root and last)
    return x


def gather_tree(shards, specs, mesh: TrainMesh, device=None,
                root: bool = False):
    """The full tree of which ``shards`` holds this rank's blocks
    (`gather_leaf` on every tensor leaf, in key order); other leaves as
    they are.  Every rank of the mesh calls it; with ``root`` only rank
    0's tree holds the tensors, the others' None."""
    if isinstance(shards, dict):
        return {k: gather_tree(shards[k], specs[k], mesh, device, root)
                for k in sorted(shards)}
    if isinstance(shards, torch.Tensor):
        return gather_leaf(shards, specs, mesh, device, root)
    return shards


def release_masters(model) -> None:
    """Drop the model's full master buffers (each becomes an empty tensor
    on its device) and their gradients."""
    for p in model.masters.values():
        p.grad = None
        p.data = torch.empty(0, dtype=p.dtype, device=p.device)


def shard_masters(model, specs: dict, mesh: TrainMesh) -> dict:
    """This rank's shards of the model's masters (``specs`` from
    `train_specs`); the full buffers are released."""
    shards = shard_tree({k: p.detach() for k, p in model.masters.items()},
                        specs, mesh)
    release_masters(model)
    return shards


def bind_masters(model, shards: dict, specs: dict, mesh: TrainMesh) -> None:
    """Gather every master into the model from the ranks' shards, so its
    forward and backward run on the full leaves; a replicated leaf's
    master is its shard itself."""
    for k, p in model.masters.items():
        p.data = shards[k] if not spec_axes(specs[k]) else \
            gather_leaf(shards[k], specs[k], mesh)


def _count_labels(labels) -> int:
    if isinstance(labels, torch.Tensor):
        return int((labels >= 0).sum())
    return int((np.asarray(labels) >= 0).sum())


def split_batch(batch: dict, mesh: TrainMesh) -> tuple[dict, float]:
    """``(this rank's batch, its weight)``: each input's rows block over
    the data axes where `batch_specs` shards its leading dimension, else
    the whole input; the weight is this rank's count of labelled tokens
    (labels >= 0) over the count summed across the data axes, so the
    weighted sum of the ranks' mean losses is the global batch's mean."""
    specs = batch_specs(batch, mesh)
    di, dn = mesh.block(mesh.data_axes)
    local = {}
    for k, v in batch.items():
        if specs[k] and specs[k][0] is not None:
            rows = len(v) // dn
            local[k] = v[di * rows:(di + 1) * rows]
        else:
            local[k] = v
    n_all = _count_labels(batch["labels"])
    total = n_all if specs["labels"][0] is not None else dn * n_all
    return local, _count_labels(local["labels"]) / max(total, 1)
