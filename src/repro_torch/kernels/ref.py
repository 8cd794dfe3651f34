"""Plain PyTorch versions of the kernels (`repro.kernels.ref` counterpart).

These are the correctness ground truth the CUDA kernels are held against
on the card, and the path `ops` takes for tensors the caller put on the
CPU.  Layouts and arithmetic follow `repro.kernels.ref`: bf16 operands are
widened to float32 before each product (bf16 -> f32 is exact, so this is
JAX's ``preferred_element_type=float32``), and the softmax probabilities
are rounded to the value dtype before the PV product.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------
def attention(q, k, v, *, causal: bool = True, window: int = 0,
              q_offset: int = 0, scale: float | None = None):
    """Grouped-query attention: (B,H,Sq,D) x (B,KV,Sk,D)^2 -> (B,H,Sq,D).

    Query head ``h`` reads kv head ``h // (H // KV)``; ``window > 0`` keeps
    keys ``qpos - window < kpos <= qpos`` (causal only)."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} kv heads")
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, KV, G, Sq, D).float()
    logits = torch.einsum("bkgqd,bkTd->bkgqT", qg, k.float()) * scale
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(Sk, device=q.device)[None, :]
        mask = kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqT,bkTd->bkgqd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, H, Sq, D).to(q.dtype)


def _attn_mask(Sq, Sk, causal, window, device):
    """(Sq, Sk) keys each query row sees, or None when it sees them all."""
    if not causal:
        return None
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def attention_fwd(q, k, v, *, causal: bool = True, window: int = 0):
    """`attention` and its per-row log-sum-exp: -> (o (B,H,Sq,D) in q's
    dtype, lse (B,H,Sq) float32), the residual of `repro`'s
    ``xla_flash._flash_fwd_impl``: the natural log of the row sum of
    ``exp(q.k * D**-0.5)`` over the visible keys."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, Sq, D).float()
    logits = torch.einsum("bkgqd,bkTd->bkgqT", qg, k.float()) * D ** -0.5
    mask = _attn_mask(Sq, Sk, causal, window, q.device)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1).reshape(B, H, Sq)
    return attention(q, k, v, causal=causal, window=window), lse


def tf32(x):
    """Float32 ``x`` with its low 13 mantissa bits rounded away, to nearest
    with ties away from zero (the bits plus 2^12, then the low 13 cleared):
    the TF32 value `csrc/flash_attention.cu`'s float32 kernel feeds the
    tensor cores (its ``tf32_round``), bit for bit."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
        torch.float32)


def tf32_split(x):
    """(hi, lo) = (tf32(x), tf32(x - hi)): hi + lo is x within 2^-21 of
    |x| (x - hi is exact; lo keeps 11 of its bits)."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def _split_einsum(eq: str, a, b, products: int):
    """``einsum(eq, a, b)`` of float32 operands as the float32 kernel
    multiplies: both split (`tf32_split`), lo.hi + hi.lo + hi.hi with 3
    ``products``, hi.hi alone with 1."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    if products == 1:
        return torch.einsum(eq, ah, bh)
    if products != 3:
        raise ValueError(f"products is 1 or 3, got {products}")
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) + \
        torch.einsum(eq, ah, bh)


def attention_fwd_tiled(q, k, v, *, causal: bool = True, window: int = 0,
                        keys: int, products: int = 3):
    """`attention_fwd` computed the way `csrc/flash_attention.cu`'s kernels
    compute it, walking the keys ``keys`` at a time
    (`flash_attention.fwd_plan`'s ``keys``): scores in float32 times the
    scale in log2 units (``D**-0.5`` times log2 e, a float32 product as the
    launcher forms it); per tile the running max ``m`` (from ``NEG_INF``),
    ``alpha = exp2(m_old - m)``, ``p = exp2(s - m)``; the row sum adds p in
    float32.  bf16 operands: exact products, and P rounded to bf16 where it
    meets V (the kernel's P fragment).  float32 operands: every product of
    Q.K^T and of P.V split into TF32 parts as the float32 kernel's
    tensor-core products are (`_split_einsum`, ``products`` 3; 1 gives one
    TF32 product, which misses the float32 tolerance).  Masked scores are
    -inf (exp2 gives exactly 0); a tile's ragged tail holds no keys, as
    the kernel's zero-filled rows are masked.  -> (o in q's dtype, lse
    float32 natural log: ``(m + log2 l) ln 2``, ``NEG_INF`` for a row that
    sees no key)."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    bf16 = v.dtype == torch.bfloat16
    scale_log2 = (torch.tensor(D ** -0.5, dtype=torch.float32) *
                  torch.tensor(1.4426950408889634, dtype=torch.float32))
    qg = q.reshape(B, KV, G, Sq, D).float()
    kf, vf = k.float(), v.float()

    def product(eq, a, b):
        if bf16:
            return torch.einsum(eq, a, b)
        return _split_einsum(eq, a, b, products)

    mask = _attn_mask(Sq, Sk, causal, window, q.device)
    m = torch.full((B, KV, G, Sq), NEG_INF, device=q.device)
    l = torch.zeros(B, KV, G, Sq, device=q.device)
    acc = torch.zeros(B, KV, G, Sq, D, device=q.device)
    for k0 in range(0, Sk, keys):
        t = slice(k0, k0 + keys)
        s = product("bkgqd,bkTd->bkgqT", qg, kf[:, :, t]) * scale_log2
        if mask is not None:
            s = torch.where(mask[:, t], s, float("-inf"))
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(s - mx[..., None])
        l = l * alpha + p.sum(-1)
        pv = p.to(torch.bfloat16).float() if bf16 else p
        acc = acc * alpha[..., None] + product("bkgqT,bkTd->bkgqd", pv,
                                               vf[:, :, t])
        m = mx
    empty = l == 0
    o = acc / torch.where(empty, 1.0, l)[..., None]
    lse = torch.where(empty, NEG_INF,
                      (m + torch.log2(torch.where(empty, 1.0, l))) *
                      0.6931471805599453)
    return o.reshape(B, H, Sq, D).to(q.dtype), lse.reshape(B, H, Sq)


def attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                  window: int = 0):
    """Plain flash backward (`repro.kernels.xla_flash._flash_bwd_impl`):
    from the forward's output ``o`` and ``lse`` and the output's gradient
    ``do`` -> (dq, dk, dv) in the operands' dtypes, float32 math:
    ``D = rowsum(dO o)``, ``P = exp(S - lse)`` over the visible keys,
    ``dV = P^T dO``, ``dS = P (dO V^T - D)``, ``dQ = dS K scale``,
    ``dK = dS^T Q scale``; dK and dV sum over each kv head's query heads."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    scale = D ** -0.5
    qg = q.reshape(B, KV, G, Sq, D).float()
    dog = do.reshape(B, KV, G, Sq, D).float()
    kf, vf = k.float(), v.float()
    Dsum = (dog * o.reshape(B, KV, G, Sq, D).float()).sum(-1)
    s = torch.einsum("bkgqd,bkTd->bkgqT", qg, kf) * scale
    p = torch.exp(s - lse.reshape(B, KV, G, Sq, 1).float())
    mask = _attn_mask(Sq, Sk, causal, window, q.device)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dv = torch.einsum("bkgqT,bkgqd->bkTd", p, dog)
    dp = torch.einsum("bkgqd,bkTd->bkgqT", dog, vf)
    ds = p * (dp - Dsum[..., None])
    dq = torch.einsum("bkgqT,bkTd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqT,bkgqd->bkTd", ds, qg) * scale
    return (dq.reshape(B, H, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def attention_bwd_tiled(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, plan):
    """`attention_bwd` summed the way `csrc/flash_attention_bwd.cu` sums
    under ``plan`` (`flash_attention.bwd_plan`): D = rowsum(dO o) in
    float32; where the operands are bf16, P and dS are rounded to bf16
    where they enter a product (dV = P^T dO, dQ = dS K, dK = dS^T Q), as
    the kernels' mma operands; dQ sums its key tiles of ``plan.dq_keys``
    in order; dK and dV are float32 partials per (key tile, query head),
    summed in head order inside each dkdv block of ``plan.heads`` heads and
    then over the ``plan.cluster`` blocks of a cluster in rank order.  A
    key tile holds every term of its keys, so the tiling itself changes no
    key's arithmetic."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    scale = D ** -0.5
    low = q.dtype if q.dtype == torch.bfloat16 else torch.float32

    def rnd(x):
        return x.to(low).float()

    qg = q.reshape(B, KV, G, Sq, D).float()
    dog = do.reshape(B, KV, G, Sq, D).float()
    kf, vf = k.float(), v.float()
    Dsum = (dog * o.reshape(B, KV, G, Sq, D).float()).sum(-1)
    s = torch.einsum("bkgqd,bkTd->bkgqT", qg, kf) * scale
    p = torch.exp(s - lse.reshape(B, KV, G, Sq, 1).float())
    mask = _attn_mask(Sq, Sk, causal, window, q.device)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dp = torch.einsum("bkgqd,bkTd->bkgqT", dog, vf)
    ds = rnd(p * (dp - Dsum[..., None]))
    dq = torch.zeros(B, KV, G, Sq, D, device=q.device)
    for k0 in range(0, Sk, plan.dq_keys):
        t = slice(k0, k0 + plan.dq_keys)
        dq = dq + torch.einsum("bkgqT,bkTd->bkgqd", ds[..., t], kf[:, :, t])
    # per query head partials, (B, KV, cluster, heads, Sk, D)
    parts = [torch.einsum("bkgqT,bkgqd->bkgTd", a, b).reshape(
        B, KV, plan.cluster, plan.heads, Sk, D)
        for a, b in ((ds, qg), (rnd(p), dog))]
    sums = []
    for part in parts:
        blocks = part[:, :, :, 0]
        for j in range(1, plan.heads):
            blocks = blocks + part[:, :, :, j]
        total = blocks[:, :, 0]
        for r in range(1, plan.cluster):
            total = total + blocks[:, :, r]
        sums.append(total)
    return ((dq * scale).reshape(B, H, Sq, D).to(q.dtype),
            (sums[0] * scale).to(k.dtype), sums[1].to(v.dtype))


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0,
                     scale: float | None = None):
    """Single-token decode attention over a KV cache: (B,H,D) x
    (B,KV,S,D)^2 with ``cache_len`` () or (B,) valid lengths -> (B,H,D)."""
    B, H, D = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, KV, G, D).float()
    logits = torch.einsum("bkgd,bkTd->bkgT", qg, k_cache.float()) * scale
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1)
    lens = lens.expand(B)
    pos = torch.arange(S, device=q.device)[None, :]
    mask = pos < lens[:, None]
    if window > 0:
        mask &= pos >= (lens[:, None] - window)
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgT,bkTd->bkgd", probs.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, H, D).to(q.dtype)


def decode_attention_cluster(q, k_cache, v_cache, cache_len, *,
                             window: int = 0, cluster: int,
                             tile: int | None = None,
                             scale: float | None = None):
    """`decode_attention` computed the way `csrc/decode_attention.cu`
    does.  Sequence b's valid slots ``[start, L)`` (``start = max(0, L -
    window)`` with a window, else 0) are covered by T tiles of ``tile``
    slots counted from ``start`` (default: the kernel's, 128 bytes a
    column: 64 bf16 or 32 float32 keys); rank r of the ``cluster`` owns
    tiles ``[r T // C, (r + 1) T // C)``.  Each rank keeps a partial (m, l,
    acc) over its slots in float32 (an empty rank m = NEG_INF, l = 0), and
    the partials merge by their log-sum-exp weights, summed over ranks 0..
    in rank order, an empty rank with weight exactly 0 and its accumulators
    never multiplied.  A sequence with no valid slot gives 0.  In bf16
    the probabilities enter P.V as the kernel's tensor cores take them,
    a bf16 rounding plus the bf16 rounding of its remainder (about 16
    bits); float32 stays float32.  (The kernel also splits
    a rank's keys over its warps, each with its own running max, merged
    the same way, and cuts the output columns into slices and the merge's
    items into a share a rank: the arithmetic of a column is unchanged
    up to float32 rounding.)"""
    B, H, D = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    tile = tile or 128 // q.element_size()
    qg = q.reshape(B, KV, G, D).float()
    kf, vf = k_cache.float(), v_cache.float()
    logits = torch.einsum("bkgd,bkTd->bkgT", qg, kf) * scale     # (B,KV,G,S)
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1).expand(B)
    L = lens.clamp(0, S).long()
    start = (L - window).clamp(min=0) if window > 0 else torch.zeros_like(L)
    T = (L - start + tile - 1) // tile
    r = torch.arange(cluster, device=q.device)
    lo = start[:, None] + (T[:, None] * r // cluster) * tile       # (B,C)
    hi = torch.minimum(start[:, None] + (T[:, None] * (r + 1) // cluster)
                       * tile, L[:, None])
    pos = torch.arange(S, device=q.device)
    valid = (pos >= lo[..., None]) & (pos < hi[..., None])         # (B,C,S)
    valid = valid[:, None, None]                                  # (B,1,1,C,S)
    s = logits[:, :, :, None, :]
    m = torch.where(valid, s, NEG_INF).amax(dim=-1)               # (B,KV,G,C)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    if v_cache.dtype == torch.bfloat16:
        p_hi = p.to(torch.bfloat16).float()
        p = p_hi + (p - p_hi).to(torch.bfloat16).float()
    acc = torch.einsum("bkgcs,bksd->bkgcd", p, vf)
    full = l > 0
    big = torch.where(full, m, NEG_INF).amax(dim=-1, keepdim=True)
    w = torch.where(full, torch.exp(m - big), 0.0)
    total = (w * l).sum(dim=-1)
    out = torch.zeros(B, KV, G, D, device=q.device)
    for rank in range(cluster):
        wr = w[..., rank, None]
        out = out + torch.where(wr != 0, wr * acc[..., rank, :], 0.0)
    out = out / torch.where(total == 0, 1.0, total)[..., None]
    return out.reshape(B, H, D).to(q.dtype)


# ----------------------------------------------------------------------
# Mamba2 / SSD (state-space duality) scan
# ----------------------------------------------------------------------
def ssd_scan(x, dt, A, Bm, Cm, *, init_state=None, return_state=False):
    """Sequential oracle of the SSD recurrence (`repro.kernels.ref.ssd_scan`):

        h_t = exp(A dt_t) h_{t-1} + dt_t x_t (outer) B_t,   y_t = h_t . C_t

    x (B,S,Hn,P), dt (B,S,Hn), A (Hn,), Bm/Cm (B,S,N), ``init_state``
    (B,Hn,P,N) -> y (B,S,Hn,P) in x's dtype [, final state in float32]."""
    Bq, S, Hn, P = x.shape
    N = Bm.shape[-1]
    h = (init_state.float() if init_state is not None else
         torch.zeros(Bq, Hn, P, N, dtype=torch.float32, device=x.device))
    xf, dtf, bf, cf = x.float(), dt.float(), Bm.float(), Cm.float()
    A = A.float()
    ys = []
    for t in range(S):
        decay = torch.exp(A[None, :] * dtf[:, t])                   # (B,Hn)
        upd = torch.einsum("bhp,bn->bhpn", xf[:, t] * dtf[:, t, :, None],
                           bf[:, t])
        h = h * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, cf[:, t]))
    y = (torch.stack(ys, dim=1) if ys else xf.new_zeros(x.shape)).to(x.dtype)
    return (y, h) if return_state else y


def ssd_scan_chunked(x, dt, A, Bm, Cm, *, chunk: int = 256, init_state=None,
                     return_state=False):
    """Chunked SSD scan, the plain version of `csrc/ssd_scan.cu` (the
    chunk-parallel form of `repro.kernels.xla_ssd.ssd_scan_chunked`).

    Per chunk of ``Q = min(chunk, S)`` steps, with ``L_t = cumsum(A dt)``
    inside the chunk:

        y   = tril(exp(L_t - L_s) dt_s (C_t . B_s)) x + exp(L_t) C_t . h_in
        h   = exp(L_Q) h_in + sum_s exp(L_Q - L_s) dt_s x_s (outer) B_s

    The intra-chunk terms are computed for all chunks at once; the state is
    carried over the chunks in order (`repro` takes an associative scan;
    the sum is the same).  Any S works: the ragged last chunk is padded
    with ``dt = 0`` and ``x = B = C = 0``, steps that neither decay nor
    update the state, so the final state is the state after step S-1."""
    Bq, S, Hn, P = x.shape
    N = Bm.shape[-1]
    Q = max(1, min(chunk, S))
    nc = -(-S // Q)
    pad = nc * Q - S

    def padded(a):
        a = a.float()
        if pad:
            a = torch.cat([a, a.new_zeros((Bq, pad) + a.shape[2:])], dim=1)
        return a.reshape((Bq, nc, Q) + a.shape[2:])

    xf, dtf, bf, cf = padded(x), padded(dt), padded(Bm), padded(Cm)
    logdec = torch.cumsum(A.float() * dtf, dim=2)                  # (B,c,Q,Hn)
    cb = torch.einsum("bcqn,bcsn->bcqs", cf, bf)                    # (B,c,Q,Q)
    diff = logdec[:, :, :, None, :] - logdec[:, :, None, :, :]      # L_t - L_s
    tril = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    # mask before exp: L_t - L_s > 0 above the diagonal may overflow
    ratio = torch.exp(torch.where(tril[None, None, :, :, None], diff, -torch.inf))
    M = ratio * cb[..., None] * dtf[:, :, None, :, :]
    y = torch.einsum("bcqsh,bcshp->bcqhp", M, xf)                   # (B,c,Q,Hn,P)

    last = logdec[:, :, -1, :]                                      # (B,c,Hn)
    wts = torch.exp(last[:, :, None, :] - logdec) * dtf             # (B,c,Q,Hn)
    U = torch.einsum("bcqh,bcqhp,bcqn->bchpn", wts, xf, bf)         # (B,c,Hn,P,N)
    h = (init_state.float() if init_state is not None else
         torch.zeros(Bq, Hn, P, N, dtype=torch.float32, device=x.device))
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = torch.exp(last[:, c])[..., None, None] * h + U[:, c]
    h_in = torch.stack(h_in, dim=1)                                 # (B,c,Hn,P,N)
    y = y + torch.exp(logdec)[..., None] * torch.einsum(
        "bcqn,bchpn->bcqhp", cf, h_in)
    y = y.reshape(Bq, nc * Q, Hn, P)[:, :S].to(x.dtype)
    return (y, h) if return_state else y


def _bf16(a):
    return a.to(torch.bfloat16).float()


def ssd_scan_tiled(x, dt, A, Bm, Cm, *, chunk: int = 256, init_state=None,
                   return_state=False, rounded: bool = False):
    """`ssd_scan_chunked` computed the way `csrc/ssd_scan.cu`'s bf16 kernel
    computes it: chunk by chunk in order, each chunk's outputs from the
    state entering it, every product accumulated in float32.

    With ``rounded`` the operands are rounded where the kernel rounds them
    for its bf16 tensor-core products (C, B and x are bf16 already):

    - M = exp(L_t - L_s) dt_s (C_t . B_s), formed in float32, to bf16
      before M . x;
    - the entering state h to bf16 for C_t . h;
    - in the update, v = w_s x_s (w_s = exp(L_Q - L_s) dt_s) split into
      bf16 parts hi = bf16(v) and lo = bf16(v - hi), the update being
      hi^T B + lo^T B.

    The state itself stays float32.  (The kernel's blocks that start
    after the first chunk form their entering state from the chunks
    before them by the same updates in the same order.)"""
    Bq, S, Hn, P = x.shape
    N = Bm.shape[-1]
    Q = max(1, min(chunk, S))
    r = _bf16 if rounded else (lambda a: a)
    h = (init_state.float() if init_state is not None else
         torch.zeros(Bq, Hn, P, N, dtype=torch.float32, device=x.device))
    ys = []
    for c0 in range(0, S, Q):
        n = min(Q, S - c0)
        xc, dtc = x[:, c0:c0 + n].float(), dt[:, c0:c0 + n].float()
        bc, cc = Bm[:, c0:c0 + n].float(), Cm[:, c0:c0 + n].float()
        L = torch.cumsum(A.float() * dtc, dim=1)                    # (B,n,Hn)
        cb = torch.einsum("btn,bsn->bts", cc, bc)
        tril = torch.tril(torch.ones(n, n, dtype=torch.bool, device=x.device))
        diff = L[:, :, None, :] - L[:, None, :, :]                  # L_t - L_s
        M = torch.exp(torch.where(tril[None, :, :, None], diff, -torch.inf)) \
            * cb[..., None] * dtc[:, None]                          # (B,t,s,Hn)
        y = torch.einsum("btsh,bshp->bthp", r(M), xc)
        y = y + torch.exp(L)[..., None] * torch.einsum("btn,bhpn->bthp",
                                                       cc, r(h))
        ys.append(y)
        v = (torch.exp(L[:, -1:] - L) * dtc)[..., None] * xc         # (B,n,Hn,P)
        hi = r(v)
        parts = (hi, _bf16(v - hi)) if rounded else (v,)
        U = sum(torch.einsum("bshp,bsn->bhpn", part, bc) for part in parts)
        h = torch.exp(L[:, -1])[..., None, None] * h + U
    y = (torch.cat(ys, dim=1) if ys else x.float()).to(x.dtype)
    return (y, h) if return_state else y


def ssd_decode_step(x, dt, A, Bm, Cm, state):
    """One-token SSD update (`repro.kernels.ref.ssd_decode_step`): x (B,Hn,P),
    dt (B,Hn), A (Hn,), Bm/Cm (B,N), state (B,Hn,P,N) float32 -> (y in x's
    dtype, new state)."""
    decay = torch.exp(A[None, :] * dt.float())
    upd = torch.einsum("bhp,bn->bhpn", x.float() * dt[..., None], Bm.float())
    new = state * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new, Cm.float())
    return y.to(x.dtype), new


# ----------------------------------------------------------------------
# RMSNorm
# ----------------------------------------------------------------------
def rms_norm(x, scale, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * scale`` in float32, cast back."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ----------------------------------------------------------------------
# trie fleet-replan (VineLM controller)
# ----------------------------------------------------------------------
_PLAN_BIG = 1e30


def effective_scalars(acc_floor, cost_cap):
    """(floor_eff, cap_eff): the slack-adjusted accuracy floor and cost cap
    in float32 arithmetic (``acc_floor - 1e-6``, ``cost_cap + 1e-6 *
    |cost_cap|``), as host floats."""
    f = np.float32
    floor_eff = f(acc_floor) - f(1e-6)
    cap_eff = f(cost_cap) + f(1e-6) * abs(f(cost_cap))
    return float(floor_eff), float(cap_eff)


def _plan_lex_argmin(feas, keys):
    """Exact lexicographic argmin per row of the (B, N) feasible set
    (multi-pass narrowing; the final tie-break is the lowest node index,
    matching np.lexsort's stable order in the host ``select_path``)."""
    B, n = feas.shape
    cand = feas
    for k in keys:
        kk = torch.where(cand, k, _PLAN_BIG)
        cand = cand & (kk <= kk.min(dim=1, keepdim=True).values)
    idx = torch.arange(n, dtype=torch.int32, device=feas.device)
    best = torch.where(cand, idx, n).min(dim=1).values.to(torch.int32)
    return torch.where(cand.any(dim=1), best, -1).to(torch.int32)


def fleet_plan(terminal, depth, acc, cost, lat, subtree_size, path_models,
               engine_of_model, prefixes, elapsed_lat, elapsed_cost,
               engine_delays, acc_floor, cost_cap, lat_cap, *, kind: str,
               blocked_depth=None):
    """Dense masked-reduction oracle of the fused trie replan.

    One full min-pass per lexicographic key for every request, with the
    (B, N, Dmax) per-position delay intermediate materialized — the
    pre-fusion form of the fleet step (`repro.kernels.ref.fleet_plan`).
    ``acc_floor``/``cost_cap``/``lat_cap`` are host scalars, taken in
    float32 as `repro` takes them.  Returns (targets,
    next_models), both (B,) int32 with -1 = infeasible / stop here.

    ``blocked_depth[v]`` is the engine-availability mask as a node column:
    a candidate is admissible from prefix ``u`` only when
    ``blocked_depth[v] <= depth[u]``.
    """
    del elapsed_cost  # cost budgets are expectation-based (select_path)
    dev = acc.device
    floor_eff, cap_eff = effective_scalars(acc_floor, cost_cap)
    n = acc.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    bd = (torch.zeros_like(depth) if blocked_depth is None
          else blocked_depth.to(depth.dtype))
    u = prefixes.long()

    per_model = engine_delays[:, engine_of_model.long()]           # (B, M)
    pm = path_models.long()                                       # (N, D)
    vals = torch.where(pm[None] >= 0,
                       per_model[:, pm.clamp(min=0)], 0.0)        # (B, N, D)
    delay = vals.sum(dim=2)                                       # (B, N)
    lo = u[:, None]
    hi = (u + subtree_size[u].long())[:, None]
    d_lat = ((lat[None, :] - lat[u][:, None])
             + (delay - delay.gather(1, u[:, None])))
    d_cost = cost[None, :] - cost[u][:, None]
    feas = (terminal[None, :] > 0.5) & (idx[None, :] >= lo) & (idx[None, :] < hi)
    feas &= bd[None, :] <= depth[u][:, None]
    feas &= d_lat <= ((float(np.float32(lat_cap)) - elapsed_lat) + 1e-6)[:, None]
    # relative slack: costs sit at ~1e-3 $ where an absolute 1e-6 would
    # admit plans the float64 host search rejects
    feas &= (cost <= cap_eff)[None, :]
    if kind == "min_cost":
        feas &= (acc >= floor_eff)[None, :]
        keys = (d_cost, d_lat, depth[None, :].expand_as(d_lat))
    else:
        keys = (-acc[None, :].expand_as(d_lat), d_cost, d_lat)
    tgt = _plan_lex_argmin(feas, keys)
    du = depth[u].long()
    dmax = path_models.shape[1]
    nxt = path_models[tgt.long().clamp(min=0), du.clamp(max=dmax - 1)]
    nxt = torch.where((tgt < 0) | (tgt == prefixes), -1, nxt)
    return tgt, nxt.to(torch.int32)
