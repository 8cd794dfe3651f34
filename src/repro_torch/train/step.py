"""Training step of the port (`repro.train.step` counterpart): loss and
gradients of a `TrainModel`, the optimizer update, gradient accumulation
over microbatches and int8 error-feedback gradient compression (optional);
with ``mesh=``, the FSDP-style sharded step (`repro`'s step jitted over
sharded parameters), on the shards of `repro_torch.dist.fsdp`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist import fsdp
from repro_torch.dist.sharding import (
    all_reduce_sum,
    collective_bytes,
    collectives,
    reduce_scatter_dim,
    spec_axes,
)
from repro_torch.models.transformer import param_shapes
from repro_torch.train.optimizer import (OptConfig, _dequant, _quant,
                                         make_optimizer, whole_leaves)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    accum_steps: int = 1          # grad accumulation microbatches
    compress_grads: bool = False  # int8 error-feedback compression
    compress_block: int = 256


def _compress_ef(grads: dict, err: dict, block: int):
    """int8 error-feedback compression (a numerical model of on-wire
    gradient compression: quantize g + e, carry the residual e forward)
    -> (compressed grads, new residuals)."""
    out, new_err = {}, {}
    for k, g in grads.items():
        tot = g.float() + err[k]
        if g.numel() < block:
            out[k], new_err[k] = tot, torch.zeros_like(err[k])
            continue
        q, s = _quant(tot, block)
        deq = _dequant(q, s, g.shape, block)
        out[k], new_err[k] = deq, tot - deq
    return out, new_err


def value_and_grad(model, batch: dict):
    """(loss, metrics, grads) of ``model.loss(batch)``: the gradients of
    the float32 masters by `repro`'s keys (the masters' ``.grad`` are
    cleared first and left holding them)."""
    params = model.params()
    for p in params.values():
        p.grad = None
    loss, metrics = model.loss(batch)
    loss.backward()
    grads = {k: p.grad for k, p in params.items()}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model, tcfg: TrainConfig, *, mesh=None):
    """(init_state, train_step) for ``model`` (a `TrainModel` or
    `TrainEncDecModel`).

    ``train_step(params, state, batch) -> (params, state, metrics)`` takes
    ``params = model.params()`` (the masters the model computes with),
    updates them in place and returns them; ``metrics`` holds ``loss``,
    ``lr`` and ``grad_norm`` as tensors (and ``nll``/``aux`` without
    accumulation).

    With ``mesh`` (a `repro_torch.dist.TrainMesh`), ``init_state`` is the
    same and ``train_step`` is `_sharded_step`'s: it takes this rank's
    shards of the masters and of the state (`fsdp.shard_masters`,
    `fsdp.shard_tree` under `fsdp.train_specs`) and returns them
    updated."""
    opt_init, opt_update = make_optimizer(tcfg.opt)

    def init_state(params: dict) -> dict:
        st = {"opt": opt_init(params)}
        if tcfg.compress_grads:
            st["ef_err"] = {k: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device)
                            for k, p in params.items()}
        return st

    if mesh is not None:
        return init_state, _sharded_step(model, tcfg, mesh)

    def train_step(params: dict, state: dict, batch: dict):
        if tcfg.accum_steps > 1:
            n = tcfg.accum_steps
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=next(iter(params.values())).device)
            m = len(batch["tokens"]) // n
            for i in range(n):
                mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                mloss, _, g = value_and_grad(model, mb)
                for k in grads:
                    grads[k] = grads[k] + g[k]
                loss = loss + mloss
            grads = {k: g / n for k, g in grads.items()}
            loss = loss / n
            metrics = {}
        else:
            loss, metrics, grads = value_and_grad(model, batch)

        new_state = dict(state)
        if tcfg.compress_grads:
            grads, new_state["ef_err"] = _compress_ef(
                grads, state["ef_err"], tcfg.compress_block)
        params, new_state["opt"], opt_metrics = opt_update(
            grads, state["opt"], params)
        for p in params.values():
            p.grad = None
        return params, new_state, {"loss": loss, **opt_metrics, **metrics}

    return init_state, train_step


def sharded_step_collectives(cfg, tcfg: TrainConfig, mesh) -> int:
    """The collectives one `_sharded_step` issues on each rank: an
    all-gather a master with a sharded dimension, one reduction a leaf,
    one all-reduce of the metrics, and for each leaf updated whole
    (`whole_leaves`) an all-gather of each of its sharded state leaves."""
    pspecs, sspecs = fsdp.train_specs(cfg, tcfg.opt, mesh)
    whole = whole_leaves(tcfg.opt, param_shapes(cfg))
    ospecs = sspecs["opt"]
    n = sum(1 for sp in pspecs.values() if spec_axes(sp)) + len(pspecs) + 1
    for k in whole:
        n += sum(1 for g in _state_groups(ospecs)
                 for sp in _leaves(ospecs[g][k]) if spec_axes(sp))
    return n


def _state_groups(state: dict) -> list[str]:
    """The optimizer state's per-leaf groups (AdamW ``m``, ``v``;
    Adafactor ``v``): every entry but the step."""
    return [g for g in sorted(state) if g != "step"]


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _reduce_grad(g: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the gradient summed over the data axes: one
    reduce-scatter when the leaf is sharded over the data axes, else this
    rank's block (model axis) or the whole leaf, all-reduced over them."""
    data = mesh.data_axes
    dims = spec_axes(spec)
    if dims and dims[0][1] == data:
        return reduce_scatter_dim(g, dims[0][0], data, mesh)
    for d, axes in dims:
        idx, n = mesh.block(axes)
        rows = g.shape[d] // n
        g = g.narrow(d, idx * rows, rows)
    return all_reduce_sum(g, mesh, data).to(mesh.device)


def _sharded_step(model, tcfg: TrainConfig, mesh):
    """``train_step(shards, state shards, batch)`` over ``mesh``, each rank
    running `repro`'s step on its part of the work:

    1. gather every master into the model (`fsdp.bind_masters`);
    2. loss and gradients of this rank's rows of the batch
       (`fsdp.split_batch`), the loss scaled by the rows' weight, so the
       gradients summed across the data axes are the global batch's;
    3. each leaf's gradient summed across the data axes into this rank's
       shard (`_reduce_grad`: one collective a leaf), or whole for the
       leaves `whole_leaves` names;
    4. one all-reduce of (loss, nll, aux, squared gradient norm), each
       term counted once: the loss by the ranks at model coordinate 0,
       a shard's squares by one rank of those holding it (`TrainMesh.
       owner`), a whole leaf's by rank 0;
    5. the optimizer's update with that global norm: elementwise leaves on
       the shards in place; a whole leaf's state gathered, the leaf
       updated in the model's full buffer, master and state cut back to
       this rank's shards;
    6. the full buffers released (`fsdp.release_masters`).

    Every rank gets the same metrics, with ``collectives`` and
    ``gathered_bytes`` / ``reduced_bytes`` of the step
    (`sharded_step_collectives` predicts the first)."""
    if tcfg.accum_steps != 1 or tcfg.compress_grads:
        raise ValueError("the sharded step takes neither accum_steps > 1 "
                         "nor compress_grads")
    _, opt_update = make_optimizer(tcfg.opt)
    pspecs, sspecs = fsdp.train_specs(model.cfg, tcfg.opt, mesh)
    # sorted: every rank must issue the whole leaves' gathers in one order
    whole = sorted(whole_leaves(tcfg.opt, param_shapes(model.cfg)))
    ospecs = sspecs["opt"]
    groups = _state_groups(ospecs)
    loss_owner = mesh.owner(mesh.data_axes)

    def train_step(params: dict, state: dict, batch: dict):
        c0, b0 = collectives(), collective_bytes()
        fsdp.bind_masters(model, params, pspecs, mesh)
        local, weight = fsdp.split_batch(batch, mesh)
        masters = model.params()
        for p in masters.values():
            p.grad = None
        loss, metrics = model.loss(local)
        (loss * weight).backward()
        grads, sq = {}, torch.zeros((), device=mesh.device)
        with torch.no_grad():
            for k, p in masters.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                p.grad = None
                if k in whole:
                    grads[k] = all_reduce_sum(g, mesh, mesh.data_axes).to(
                        mesh.device)
                    own = mesh.rank == 0
                else:
                    grads[k] = _reduce_grad(g, pspecs[k], mesh)
                    own = mesh.owner(tuple(a for _, ax in spec_axes(
                        pspecs[k]) for a in ax))
                del g
                if own:
                    sq = sq + torch.sum(torch.square(grads[k].float()))
            terms = torch.stack([loss.detach(), metrics["nll"].detach(),
                                 metrics["aux"].detach()]).float() * weight
            if not loss_owner:
                terms = torch.zeros_like(terms)
            tot = all_reduce_sum(torch.cat([terms, sq[None]]), mesh).to(
                mesh.device)

            ost = state["opt"]
            upd_params = dict(params)
            upd_state = {g: dict(ost[g]) for g in groups}
            upd_state["step"] = ost["step"]
            for k in whole:
                upd_params[k] = masters[k].data
                for g in groups:
                    upd_state[g][k] = fsdp.gather_tree(
                        ost[g][k], ospecs[g][k], mesh)
            _, new_ost, opt_metrics = opt_update(
                grads, upd_state, upd_params, gnorm=torch.sqrt(tot[3]))
            del grads
            for k in whole:
                params[k].copy_(fsdp.shard_tree(masters[k].data, pspecs[k],
                                                mesh))
                for g in groups:
                    new_ost[g][k] = fsdp.shard_tree(
                        new_ost[g][k], ospecs[g][k], mesh)
        fsdp.release_masters(model)
        new_state = dict(state, opt=new_ost)
        b1 = collective_bytes()
        out = {"loss": tot[0], "nll": tot[1], "aux": tot[2], **opt_metrics,
               "collectives": collectives() - c0,
               "gathered_bytes": b1["gathered"] - b0["gathered"],
               "reduced_bytes": b1["reduced"] - b0["reduced"]}
        return params, new_state, out

    return train_step
