"""`repro.dist.pipeline` on `torch.distributed`: GPipe over one mesh axis.

`split_stages` regroups stacked-layer parameters (leading layer axis L)
into ``(n_stages, L / n_stages, ...)`` views; `stage_block` cuts this
rank's ``(1, L / n_stages, ...)`` block out of them, as ``shard_map``
hands each device its slice; `pipeline_forward` runs `repro`'s GPipe
schedule on the rank: microbatch j enters stage s at tick s + j, the
activations hop one stage a tick (`dist.sharding.permute`), and the last
stage's outputs are summed over the axis into the replicated
``(n_micro, ...)`` result, equal to sequential execution.

`repro` differentiates the whole SPMD program, in which ``ppermute``
transposes to the reverse permutation.  In eager PyTorch each rank's
autograd graph is its own, so the schedule's edges between ranks are
`torch.autograd.Function`s whose backwards issue the transposed
collectives:

- `_Hop`: forward sends to s + 1 and receives from s - 1; backward sends
  the gradient to s - 1 and receives from s + 1;
- `_SumOut`: forward sums the outputs over the axis; backward is the
  identity (every rank computes the same loss on the replicated result,
  so a sum there would make the stages' gradients n_stages times too
  large);
- `_Replicated`: forward is the identity on the replicated microbatches;
  backward sums their gradient over the axis (only stage 0 reads them).

A rank whose hop's backward never runs leaves its neighbour's send
waiting for ever, so every rank keeps every received tensor in its graph
(stage 0 selects its input with ``torch.where``, as `repro`'s
``jnp.where`` does), and `_SumOut` takes the last received tensor as an
input whose gradient is zero: on every rank the backward then reaches
every hop, in reverse tick order, one chain.  The last tick's hop, which
no stage reads, is not made.  A pass issues, on every rank, ``n_micro +
n_stages - 2`` hops each way (none at one stage), one sum of the outputs
and, when ``x`` requires a gradient, one sum of its gradient; the body
runs forward at every tick and backward at every tick but the last (the
last stage: every tick).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist.sharding import TrainMesh, all_reduce_sum, permute


def _map(fn, tree, path: str = ""):
    """``fn(leaf, path)`` on every array leaf of a tree of dicts, lists and
    tuples (the containers ``jax.tree.map`` walks); other leaves as they
    are."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{path}@{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree, path or "<root>")
    return tree


def split_stages(params, n_stages: int):
    """Every array leaf's leading (layer) axis L -> ``(n_stages, L //
    n_stages, ...)``, a view of the leaf; raises ``ValueError`` naming a
    leaf whose L is not a multiple of ``n_stages``."""
    n = int(n_stages)

    def split(a, path):
        if a.ndim == 0 or a.shape[0] % n:
            raise ValueError(f"leaf {path!r} of shape {tuple(a.shape)}: its "
                             f"leading axis does not split into {n} stages")
        shape = (n, a.shape[0] // n) + tuple(a.shape[1:])
        return a.view(shape) if isinstance(a, torch.Tensor) \
            else a.reshape(shape)

    return _map(split, params)


def stage_block(stages, mesh: TrainMesh, axis: str = "pipe"):
    """This rank's ``(1, L / n, ...)`` block of every leaf of ``stages``
    (from `split_stages`, leading extent the axis' ``n``), a view."""
    n, s = mesh.shape[axis], mesh.coords[axis]

    def block(a, path):
        if a.shape[0] != n:
            raise ValueError(f"leaf {path!r} of shape {tuple(a.shape)}: "
                             f"expected {n} stages on its leading axis")
        return a[s:s + 1]

    return _map(block, stages)


class _Hop(torch.autograd.Function):
    """``y`` to stage s + 1, stage s - 1's back; the gradient the other
    way."""

    @staticmethod
    def forward(ctx, y, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return permute(y, 1, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return permute(g, -1, ctx.axis, ctx.mesh), None, None


class _SumOut(torch.autograd.Function):
    """The outputs summed over the axis (the identity backward); ``links``
    are inputs kept in the graph with a zero gradient."""

    @staticmethod
    def forward(ctx, out, mesh, axis, *links):
        ctx.links = [(t.shape, t.dtype, t.device) for t in links]
        return all_reduce_sum(out, mesh, (axis,)).to(mesh.device)

    @staticmethod
    def backward(ctx, g):
        return (g, None, None) + tuple(
            torch.zeros(s, dtype=d, device=v) for s, d, v in ctx.links)


class _Replicated(torch.autograd.Function):
    """The replicated microbatches as they are; their gradient summed over
    the axis."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (all_reduce_sum(g, ctx.mesh, (ctx.axis,)).to(g.device),
                None, None)


def pipeline_forward(stages, x, stage_body, *, mesh: TrainMesh,
                     axis: str = "pipe"):
    """Run ``stage_body`` over every stage for every microbatch; every rank
    of ``mesh`` calls it with its own block.

    ``stages``: a tree (dicts, lists, tuples) whose every array leaf is
    this rank's ``(1, L / n_stages, ...)`` block (`stage_block`), as
    ``shard_map`` hands a device its slice; ``x``: the replicated
    ``(n_micro, ...)`` microbatches, equal on every rank;
    ``stage_body(p_stage, x) -> y`` applies one stage's layers to one
    microbatch (``p_stage`` the leaves with the leading 1 dropped), y of
    x's shape.  Returns the ``(n_micro, ...)`` outputs on every rank,
    equal to sequential execution, with gradients to the stages and ``x``
    (see the module's docstring).  Raises ``ValueError`` when ``axis`` is
    not an axis of ``mesh`` or a leaf's leading extent is not 1."""
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} is not an axis of the mesh "
                         f"{mesh.axis_names}")
    n, s = mesh.shape[axis], mesh.coords[axis]

    def local(a, path):
        if a.shape[:1] != (1,):
            raise ValueError(f"leaf {path!r} of shape {tuple(a.shape)}: "
                             "expected this rank's block, leading extent 1 "
                             "(stage_block)")
        return a[0]

    p_stage = _map(local, stages)
    n_micro = x.shape[0]
    if x.requires_grad and torch.is_grad_enabled():
        x = _Replicated.apply(x, mesh, axis)
    first = torch.tensor(s == 0, device=x.device)
    carry = torch.zeros_like(x[0])
    outs = []
    ticks = n_micro + n - 1
    for t in range(ticks):
        x_in = torch.where(first, x[min(t, n_micro - 1)], carry)
        y = stage_body(p_stage, x_in)
        if s == n - 1 and t >= n - 1:  # microbatch t - (n - 1) is done
            outs.append(y)
        if t < ticks - 1:
            carry = _Hop.apply(y, mesh, axis) if n > 1 else y
    out = torch.stack(outs) if outs else torch.zeros(
        (n_micro,) + tuple(y.shape), dtype=y.dtype, device=y.device)
    links = (carry,) if n > 1 and carry.requires_grad else ()
    return _SumOut.apply(out, mesh, axis, *links)


def pass_collectives(n_stages: int, n_micro: int, x_grad: bool = True
                     ) -> int:
    """The collectives one forward and backward of `pipeline_forward`
    issues on each rank: ``n_micro + n_stages - 2`` hops each way (none at
    one stage), the outputs' sum, and the sum of ``x``'s gradient when it
    has one."""
    hops = n_micro + n_stages - 2 if n_stages > 1 else 0
    return 2 * hops + 1 + int(x_grad)


def pass_bytes(n_stages: int, n_micro: int, micro_bytes: int,
               x_grad: bool = True) -> dict:
    """`collective_bytes`' growth on each rank over one such pass, for
    microbatches of ``micro_bytes`` (the outputs and ``x``'s gradient of
    the same dtype): every hop sends one microbatch, each sum the whole
    ``(n_micro, ...)``."""
    hops = n_micro + n_stages - 2 if n_stages > 1 else 0
    return {"gathered": 0, "permuted": 2 * hops * micro_bytes,
            "reduced": (1 + int(x_grad)) * n_micro * micro_bytes}
