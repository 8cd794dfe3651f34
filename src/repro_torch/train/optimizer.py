"""Optimizers of the port (`repro.train.optimizer` counterpart): AdamW
(optionally with int8-quantized moments) and Adafactor, as (init, update)
pairs of functions on tensors.

Parameters, gradients and states are flat dicts keyed by `repro`'s leaf
paths joined by ``@`` (`TrainModel.params`), each per-layer weight one
stacked (L, ...) tensor as in `repro`, so every leaf rule sees `repro`'s
leaf: decoupled weight decay where ``p.ndim >= 2`` (a stacked per-layer
norm scale is decayed, ``final_norm`` is not), Adafactor's factoring of
the last two axes and its one update-RMS clip per leaf, and the int8
moment blocks of 256 over the flattened leaf.  The arithmetic is
`repro`'s, op for op, in float32.  ``update(grads, state, params,
gnorm=None)`` takes the global gradient norm from the caller when a
sharded step has summed it across ranks (`whole_leaves` names the leaves
whose rule it must run on the whole leaf).  ``update`` writes the new
parameters into the given tensors in place (the port keeps one float32
master set, where `repro` returns a new tree) and returns them with the
new state; AdamW also updates its float32 moments and scales the given
gradients in place, so that a step holds no second copy of a leaf's
state.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"          # adamw | adafactor
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    quantize_moments: bool = False
    quant_block: int = 256


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def cosine_lr(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine to ``min_lr_ratio`` of
    it at ``total_steps``; float32 like `repro`'s."""
    step = _f32(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi) * t))
    return cfg.peak_lr * warm * (cfg.min_lr_ratio
                                 + (1 - cfg.min_lr_ratio) * cos)


# ----------------------------------------------------------------------
# int8 block quantization for optimizer moments
# ----------------------------------------------------------------------
def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)


def _quant(x: torch.Tensor, block: int):
    """Absmax int8 per block of ``block`` values of the flattened ``x``
    -> (q (n, block) int8, scale (n, 1) float32)."""
    flat = _blocks(x, block)
    scale = flat.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dequant(q: torch.Tensor, scale: torch.Tensor, shape, block: int):
    flat = (q.float() * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


_LOG_FLOOR = 1e-24


def _quant_log(x: torch.Tensor, block: int):
    """Log-domain int8 for non-negative second moments: ~0.2 log-units of
    resolution per block -> (q int8, (lo, scale) (n, 2) float32)."""
    flat = _blocks(torch.log(torch.clamp(x, min=_LOG_FLOOR)), block)
    lo = flat.amin(dim=1, keepdim=True)
    hi = flat.amax(dim=1, keepdim=True)
    scale = torch.clamp(hi - lo, min=1e-6) / 254.0
    q = torch.clamp(torch.round((flat - lo) / scale) - 127, -127,
                    127).to(torch.int8)
    return q, torch.cat([lo, scale], dim=1).float()


def _dequant_log(q: torch.Tensor, meta: torch.Tensor, shape, block: int):
    lo, scale = meta[:, :1], meta[:, 1:2]
    flat = torch.exp((q.float() + 127.0) * scale + lo).reshape(-1)
    v = flat[:math.prod(shape)].reshape(shape)
    return torch.where(v <= 2 * _LOG_FLOOR, 0.0, v)


def _global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def _is_quant(st) -> bool:
    return isinstance(st, dict)


# ----------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------
def adamw(cfg: OptConfig):
    """(init, update) of AdamW with decoupled weight decay on matrices,
    global-norm clipping and the cosine schedule; with
    ``quantize_moments`` m is stored as absmax int8 and v as log-domain
    int8 in blocks of ``quant_block`` (leaves of fewer values stay
    float32)."""

    def init(params: dict) -> dict:
        def zeros(p, quant):
            z = torch.zeros_like(p, dtype=torch.float32)
            if cfg.quantize_moments and p.numel() >= cfg.quant_block:
                q, s = quant(z, cfg.quant_block)
                return {"q": q, "s": s}
            return z

        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=_device(params)),
                "m": {k: zeros(p, _quant) for k, p in params.items()},
                "v": {k: zeros(p, _quant_log) for k, p in params.items()}}

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict, gnorm=None):
        step = state["step"] + 1
        stepf = step.float()
        lr = cosine_lr(cfg, stepf)
        gnorm = _global_norm(grads) if gnorm is None else gnorm
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        bc1 = 1 - _f32(cfg.b1) ** stepf
        bc2 = 1 - _f32(cfg.b2) ** stepf
        new_m, new_v = {}, {}
        for k, p in params.items():
            # in place where `repro` makes new arrays (the gradient, float32
            # moments, the parameter): the same operations in the same
            # order, without a second copy of each leaf's state
            g = grads[k].float().mul_(scale)
            m_st, v_st = state["m"][k], state["v"][k]
            quant = _is_quant(m_st)
            m = _dequant(m_st["q"], m_st["s"], g.shape, cfg.quant_block) \
                if quant else m_st
            v = _dequant_log(v_st["q"], v_st["s"], g.shape, cfg.quant_block) \
                if quant else v_st
            m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
            v.mul_(cfg.b2).add_(g.mul(1 - cfg.b2).mul_(g))
            upd = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
            if p.ndim >= 2:  # decoupled weight decay on matrices only
                upd.add_(p * cfg.weight_decay)
            p.sub_(upd.mul_(lr))
            del upd, g
            if quant:
                mq, ms = _quant(m, cfg.quant_block)
                vq, vs = _quant_log(v, cfg.quant_block)
                new_m[k], new_v[k] = {"q": mq, "s": ms}, {"q": vq, "s": vs}
            else:
                new_m[k], new_v[k] = m, v
        return params, {"step": step, "m": new_m, "v": new_v}, \
            {"lr": lr, "grad_norm": gnorm}

    return init, update


# ----------------------------------------------------------------------
# Adafactor (factored second moment)
# ----------------------------------------------------------------------
def adafactor(cfg: OptConfig):
    """(init, update) of Adafactor: rank-1 row / column statistics of the
    last two axes for leaves of two or more axes, a full second moment
    otherwise, the d = 1 update-RMS clip per leaf, decoupled weight decay
    on matrices."""

    def init(params: dict) -> dict:
        def st(p):
            z = {"dtype": torch.float32, "device": p.device}
            if p.ndim >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}

        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=_device(params)),
                "v": {k: st(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict, gnorm=None):
        step = state["step"] + 1
        stepf = step.float()
        lr = cosine_lr(cfg, stepf)
        gnorm = _global_norm(grads) if gnorm is None else gnorm
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        decay = 1.0 - stepf ** -0.8
        new_v = {}
        for k, p in params.items():
            g = grads[k].float() * scale
            g2 = g * g + 1e-30
            v_st = state["v"][k]
            if p.ndim >= 2:
                vr = decay * v_st["vr"] + (1 - decay) * g2.mean(-1)
                vc = decay * v_st["vc"] + (1 - decay) * g2.mean(-2)
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(-1, keepdim=True)[..., None],
                                       min=1e-30))
                upd = g / (torch.sqrt(denom) + 1e-30)
                new_v[k] = {"vr": vr, "vc": vc}
            else:
                v = decay * v_st["v"] + (1 - decay) * g2
                upd = g / (torch.sqrt(v) + 1e-30)
                new_v[k] = {"v": v}
            # update clipping (Adafactor's d = 1.0 RMS rule)
            rms = torch.sqrt(torch.mean(upd * upd) + 1e-30)
            upd = upd / torch.clamp(rms, min=1.0)
            if p.ndim >= 2:
                upd = upd + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * upd)
        return params, {"step": step, "v": new_v}, \
            {"lr": lr, "grad_norm": gnorm}

    return init, update


def whole_leaves(cfg: OptConfig, shapes: dict) -> set:
    """The keys of ``shapes`` (a master dict or a dict of shapes) whose
    update rule reads the whole leaf, which a sharded step therefore
    gathers, updates whole and cuts back to its shard: every Adafactor
    leaf (the factored second moment's row and column means, and the
    update-RMS clip of each leaf) and, with quantized moments, every AdamW
    leaf of at least ``quant_block`` values (its int8 blocks run over the
    flattened leaf).  Every other leaf's rule is elementwise, with the
    global gradient norm passed in, and runs on the shards."""
    size = {k: math.prod(getattr(v, "shape", v)) for k, v in shapes.items()}
    if cfg.kind == "adafactor":
        return set(size)
    if cfg.quantize_moments:
        return {k for k, n in size.items() if n >= cfg.quant_block}
    return set()


def _device(params: dict) -> torch.device:
    return next(iter(params.values())).device


def make_optimizer(cfg: OptConfig):
    """The (init, update) pair of ``cfg.kind``."""
    return adafactor(cfg) if cfg.kind == "adafactor" else adamw(cfg)
