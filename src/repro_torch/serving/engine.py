"""Serving engine of the port (`repro.serving.engine` counterpart).

One `ServingEngine` hosts one `Model` and serves a prompt by prefill and
then greedy (or sampled) decode, reporting time to first token and decode
time.  Every time it reads waits for the device first
(`torch.cuda.synchronize`), as `repro` waits with ``block_until_ready``.
`ServingScheduler` puts a bounded queue (backpressure) and hedged retries
of slow requests in front of an engine.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import Model


@dataclasses.dataclass
class RequestRecord:
    """Telemetry of one served request."""

    request_id: int
    tokens_in: int
    tokens_out: int
    ttft_s: float          # time to first token (prefill)
    decode_s: float        # total decode wall time
    queue_s: float         # time spent queued
    output: np.ndarray     # generated token ids
    hedged: bool = False

    @property
    def total_s(self) -> float:
        """Queue, prefill and decode time together."""
        return self.queue_s + self.ttft_s + self.decode_s


class ServingEngine:
    """One model endpoint on ``device`` ("cuda" unless the caller asks for
    "cpu"; the model's weights must lie there)."""

    def __init__(self, name: str, model: Model, *,
                 price_per_1k: float = 1.0,
                 prefill_price_per_1k: float | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"engine {name!r} on {self.device} got a model "
                             f"on {model.device}")
        self.name = name
        self.model = model
        self.price_per_1k = price_per_1k
        self.prefill_price_per_1k = (0.25 * price_per_1k
                                     if prefill_price_per_1k is None
                                     else float(prefill_price_per_1k))
        self.inflight = 0  # live queue depth, read by a load model

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, tokens, max_new: int = 32, eos: int | None = None,
                 greedy: bool = True,
                 generator: torch.Generator | None = None
                 ) -> tuple[np.ndarray, float, float]:
        """tokens (B, S) prompt -> (outputs (B, <=max_new), ttft, decode_s).
        As in `repro`, a decode step follows every emitted token, so
        ``max_new`` tokens cost ``max_new`` decode steps.

        The first token is the prefill's argmax.  Each later token is the
        argmax of its decode step's logits (``greedy``) or, with
        ``greedy=False``, a draw from ``softmax(logits)`` by
        `torch.multinomial` on ``generator``, a `torch.Generator` on the
        engine's device (``None``: one seeded with 0, as `repro` falls back
        to ``PRNGKey(0)``).  `repro` draws with `jax.random.categorical`;
        its PRNG stream cannot be matched, so sampled tokens agree with it
        in distribution only."""
        if not greedy:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            elif generator.device.type != self.device.type:
                raise ValueError(f"engine {self.name!r} on {self.device} got "
                                 f"a generator on {generator.device}")
        self.inflight += 1
        try:
            toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long)
            self._sync()
            t0 = time.perf_counter()
            toks = toks.to(self.device)
            logits, cache = self.model.prefill(toks)
            cur = logits.argmax(-1)
            self._sync()
            ttft = time.perf_counter() - t0

            outs = []
            t1 = time.perf_counter()
            for _ in range(max_new):
                outs.append(cur)
                if eos is not None and bool((cur == eos).all()):
                    break
                logits, cache = self.model.decode_step(cache, cur)
                if greedy:
                    cur = logits.argmax(-1)
                else:
                    probs = torch.softmax(logits.float(), dim=-1)
                    cur = torch.multinomial(probs, 1,
                                            generator=generator)[:, 0]
            out = torch.stack(outs, dim=1).cpu().numpy()
            self._sync()
            decode_s = time.perf_counter() - t1
            return out.astype(np.int32), ttft, decode_s
        finally:
            self.inflight -= 1

    def cost_of(self, tokens_in: int, tokens_out: int) -> float:
        """Dollar cost of one request, prefill and decode tokens each
        priced at their own per-model rate (per 1k tokens)."""
        return (self.prefill_price_per_1k * tokens_in
                + self.price_per_1k * tokens_out) / 1000.0


class ServingScheduler:
    """FIFO scheduler with deadlines and hedged retries (straggler
    mitigation): a request that takes longer than ``hedge_after_s`` is run
    once more and the faster of the two results kept; a full queue of
    ``max_queue`` refuses new work (backpressure)."""

    def __init__(self, engine: ServingEngine, *, hedge_after_s: float = 5.0,
                 max_queue: int = 256):
        self.engine = engine
        self.hedge_after_s = hedge_after_s
        self.max_queue = max_queue
        self._queue: deque = deque()
        self._next_id = 0

    def submit(self, tokens, max_new: int = 32) -> RequestRecord:
        """Serve ``tokens`` (B, S) now; raises when the queue is full."""
        if len(self._queue) >= self.max_queue:
            raise RuntimeError("backpressure: queue full")
        rid = self._next_id
        self._next_id += 1
        tq = time.perf_counter()
        # one engine, served inline: the queue models arrival
        queue_s = time.perf_counter() - tq
        t0 = time.perf_counter()
        out, ttft, dec = self.engine.generate(tokens, max_new=max_new)
        hedged = False
        if time.perf_counter() - t0 > self.hedge_after_s:
            # hedge: one retry, and the faster result wins
            out2, ttft2, dec2 = self.engine.generate(tokens, max_new=max_new)
            if ttft2 + dec2 < ttft + dec:
                out, ttft, dec = out2, ttft2, dec2
            hedged = True
        return RequestRecord(
            request_id=rid, tokens_in=int(np.prod(np.shape(tokens))),
            tokens_out=int(out.shape[1]), ttft_s=ttft, decode_s=dec,
            queue_s=queue_s, output=out, hedged=hedged)
