"""Training step of the port (`repro.train.step` counterpart): loss and
gradients of a `TrainModel`, the optimizer update, gradient accumulation
over microbatches and int8 error-feedback gradient compression (optional).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.train.optimizer import (OptConfig, _dequant, _quant,
                                         make_optimizer)


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


def make_train_step(model, tcfg: TrainConfig):
    """(init_state, train_step) for ``model`` (a `TrainModel`).

    ``train_step(params, state, batch) -> (params, state, metrics)`` takes
    ``params = model.params()`` (the masters the model computes with),
    updates them in place and returns them; ``metrics`` holds ``loss``,
    ``lr`` and ``grad_norm`` as tensors (and ``nll``/``aux`` without
    accumulation)."""
    opt_init, opt_update = make_optimizer(tcfg.opt)

    def init_state(params: dict) -> dict:
        st = {"opt": opt_init(params)}
        if tcfg.compress_grads:
            st["ef_err"] = {k: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device)
                            for k, p in params.items()}
        return st

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
