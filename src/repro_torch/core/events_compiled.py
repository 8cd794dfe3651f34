"""Epoch-batched event engine on tensors: the compiled virtual clock.

`repro_torch.core.events.run_events` drives its virtual clock from Python
with numpy state; this module keeps the whole engine state on the device
and runs the events of each time epoch in one ``step(state, consts,
t_hi)`` call, as `repro.core.events_compiled` does in one jitted step:

- **epoch segmentation**: arrivals are sorted once; the host advances a
  cursor ``epoch`` arrivals at a time and calls ``step`` with ``t_hi`` =
  the last arrival time of the chunk (the final epoch uses +inf), and it
  splits an epoch at each annotation swap.  Any epoch width gives the
  same result;
- **state**: every mutable quantity of the host loop is a tensor in one
  dict on an explicit device — float64 clock and work, int64 slots,
  rings and plans, bool masks: slot columns, the `FleetEngineSim`
  calendar columns (drained by `repro_torch.serving.loadsim
  .traced_advance`), per-class FIFO rings over a precomputed
  arrival-order table, a fixed-capacity paused buffer for preempted work,
  per-request outputs and the streaming accumulators.  Within a class,
  priority order is arrival order, so a (head, tail) ring per class plus
  a K-way merge by (class weight, arrival seq) gives the host heap's pop
  order exactly.  Every update is out of place: a dict entry is never
  written through another's storage;
- **control flow**: the phases are plain functions on tensors, named as
  in `repro`.  Each of `repro`'s ``lax.while_loop`` and ``lax.cond``
  becomes a Python ``while`` or ``if`` on one host read of its condition
  (`repro_torch.device.host_read`; `host_reads` counts them);
- **the replan** goes through the port's planner path
  (`kernels.ops.trie_plan`: the CUDA kernel on the card, its plain
  version on the CPU) once per replan round over all capacity lanes, plus
  once more for downgraded lanes when a round has any.  `repro` plans
  each needy lane at width 1; the planner is lane-independent, so lane i
  of the capacity-wide call is that width-1 result;
- **sharding** (``devices=N``, every rank of a process group of size N
  calling with the same arguments): every rank keeps the whole engine
  state, replicated, and a replan round plans only the rank's residue
  class of lanes ``lane % N == rank`` (one launch over that fixed lane
  set, the downgrade plan applied to it too), then merges the plans in
  exactly one collective (`repro_torch.dist.sharding.merge_plans`), as
  `repro`'s engine does in one ``psum``; the exploration override
  follows on replicated values.  Every host read decides on replicated
  values, so every rank takes the same trips between collectives;
- **bit-compatibility**: float64 clock and work in `repro`'s op order,
  one eager op per rounding (no fused multiply-add form); the planner
  stays float32.  Bucketed adds (occupancy, backlog) run in index order
  on the CPU and in a fixed order on the card (`loadsim.bucket_add`);
  integer-valued sums are exact in any order.

Restrictions, as in `repro` (all raise `NotImplementedError`): stage
executors must be pure functions of (request value, depth, model) — the
engine tabulates them once up front — and only the stock admission
policies, `FleetLoadModel` / `TokenWorkModel` load coupling and
``load_probe=None`` are supported.  ``refresh``, ``timeout_k``,
``recovery="restart"`` and faults combined with forecast- or
occupancy-gated admission stay on the host loop.  ``replan_overhead_s``
and `EventStats.replan_s` are host-loop wall-clock concepts and are
reported as zero / empty here.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable

import numpy as np
import torch

from repro_torch.core.admission import (
    FAILED,
    REJECTED,
    SERVED,
    SHED,
    TracedAdmission,
    _subtree_reductions,
    get_policy,
    traced_admission,
)
from repro_torch.core.controller import Objective
from repro_torch.core.controller_torch import (
    TrieDevice,
    _objective_scalars,
    _resolve_variant,
    trie_engines,
)
from repro_torch.core.events import (_DEFAULT_CAPACITY, EventStats,
                                     _explore_tables)
from repro_torch.core.runtime import ExecutionResult, StageExecutor
from repro_torch.core.streaming import (QuantileSketch, welford_finalize,
                                        welford_init, welford_merge)
from repro_torch.core.trie import Trie, TrieAnnotations
from repro_torch.device import host_read, host_reads, resolve_device
from repro_torch.dist.sharding import lane_mesh, merge_plans
from repro_torch.kernels import ops as kernel_ops

__all__ = ["run_events_compiled", "merge_stream_summaries",
           "compiled_engine_cache_size", "host_reads", "DEFAULT_EPOCH"]

# outcome codes inside the state (host strings on the way out)
_OC_SERVED, _OC_REJECTED, _OC_SHED, _OC_FAILED = 0, 1, 2, 3
_OUTCOMES = {_OC_SERVED: SERVED, _OC_REJECTED: REJECTED, _OC_SHED: SHED,
             _OC_FAILED: FAILED}
_CERT_SLACK = 1e-9   # deadline-shed certainty slack (events.py step 1b/2b)
_DONE_TOL = 1e-9     # FleetEngineSim._DONE_TOL
_SLO_TOL = 1e-9      # run_events' final SLO check tolerance
_BIG_SEQ = torch.iinfo(torch.int64).max

DEFAULT_EPOCH = 1024  # arrivals per step (a host-read knob, not math)

I64, F64, F32 = torch.int64, torch.float64, torch.float32


@dataclasses.dataclass(frozen=True)
class _EngineConfig:
    """Static configuration of one engine step: everything here changes
    the step's structure; everything that merely changes *values*
    (arrival times, work tables, deadlines, objective scalars) is an
    operand, so a new trace through the same configuration reuses the
    step."""

    capacity: int
    n_classes: int
    n_engines: int
    n_models: int
    max_depth: int
    priorities: bool
    preempt: bool
    ps: bool               # processor-sharing calendar (vs unit-rate)
    load_aware: bool
    deadline_sheds: bool
    pol: TracedAdmission
    kind: str
    kind_dg: str           # downgrade-lane objective kind (cost_aware)
    variant: str
    n_bins: int            # streaming histogram bins (incl. under/overflow)
    explore: bool = False  # epsilon-greedy exploration lane
    # token-level calendar: job rates come from the continuous-batching
    # decode-step curve + KV cap; implies ps (remaining work in jrm)
    tokens: bool = False
    # fault injection: outage transitions and/or stage-failure draws
    fault_outages: bool = False
    fault_failures: bool = False
    max_retries: int = 0
    paused_cap: int = 0    # paused-buffer rows per class (C normally; B
    #                        under outages, whose victims can stack past C)
    n_shards: int = 1      # lane-mesh size (1 = single device)


_ENGINE_CACHE: dict[_EngineConfig, Callable] = {}


def compiled_engine_cache_size() -> int:
    """Engine steps built in this process, one per static configuration:
    epoch width, trace content, deadlines, objective scalars, annotation
    swaps and fault flips are all operands, so replaying new traces
    through a known configuration must not grow this."""
    return len(_ENGINE_CACHE)


def _read(x):
    """A condition's value: python bools pass through, a tensor costs one
    counted host read."""
    return x if isinstance(x, bool) else host_read(x)


def _set(a, idx, v):
    """``a.at[idx].set(v)`` out of place."""
    a = a.clone()
    a[idx] = v
    return a


def _add(a, idx, v):
    """``a.at[idx].add(v)`` out of place (one index, or unique ones)."""
    a = a.clone()
    a[idx] = a[idx] + v
    return a


def _build_step(cfg: _EngineConfig):
    """Build and cache the epoch step for one static configuration."""
    if cfg in _ENGINE_CACHE:
        return _ENGINE_CACHE[cfg]

    from repro_torch.serving.loadsim import (bucket_add, traced_advance,
                                             traced_engine_rates,
                                             traced_job_rates,
                                             traced_token_rates)

    C, K, E, M = cfg.capacity, cfg.n_classes, cfg.n_engines, cfg.n_models
    P = cfg.paused_cap
    # the paused buffer exists for priority preemption AND for outage
    # checkpoints (stage model -1 = replan on admit)
    paused_on = cfg.priorities or cfg.fault_outages
    fault_any = cfg.fault_outages or cfg.fault_failures
    pol = cfg.pol

    def scat(dst, idx, val, mask, accumulate=False):
        """Masked scatter into a (B,)-indexed column: lanes off ``mask``
        write a pad row that is cut off (``mode="drop"``)."""
        n = dst.shape[0]
        ext = torch.cat([dst, dst[:1]])
        tgt = torch.where(mask, idx.long(), n)
        v = torch.as_tensor(val, dtype=dst.dtype,
                            device=dst.device).expand(tgt.shape)
        ext.index_put_((tgt,), v, accumulate=accumulate)
        return ext[:n]

    def count(mask):
        return mask.long().sum()

    def wmerge(wt, cnt, mean, m2):
        """Fold a batch (count, mean, M2) into running Welford state —
        Chan's parallel merge, with no data-dependent branch."""
        c0, m0, s0 = wt
        tot = c0 + cnt
        tot_s = torch.where(tot > 0, tot, 1.0)
        d = mean - m0
        m = m0 + d * cnt / tot_s
        s = s0 + m2 + d * d * c0 * cnt / tot_s
        keep = cnt > 0
        return (torch.where(keep, tot, c0), torch.where(keep, m, m0),
                torch.where(keep, s, s0))

    def batch_stats(x, mask):
        cnt = mask.to(F64).sum()
        mean = torch.where(mask, x, 0.0).sum() / torch.where(cnt > 0, cnt,
                                                             1.0)
        m2 = torch.where(mask, (x - mean) ** 2, 0.0).sum()
        return cnt, mean, m2

    def record_terminal(st, cn, req, valid, t, outcome, cost):
        """Every terminal disposition funnels through here: outputs,
        done-counter, and the streaming accumulators (latency/cost moments
        and the quantile histogram over SERVED requests, SLO-violation
        count over all terminal requests)."""
        B = st["roc"].shape[0]
        reqc = torch.clamp(req, 0, B - 1)
        st = dict(st)
        st["roc"] = scat(st["roc"], req, outcome, valid)
        st["rdn"] = scat(st["rdn"], req, t, valid)
        st["rct"] = scat(st["rct"], req, cost, valid)
        st["don"] = st["don"] + count(valid)
        lat = t - cn["arr"][reqc]
        served = valid & (outcome == _OC_SERVED)
        st["lw"] = wmerge(st["lw"], *batch_stats(lat, served))
        st["cw"] = wmerge(st["cw"], *batch_stats(cost, served))
        bins = torch.searchsorted(cn["edges"], lat, right=True)
        st["hist"] = scat(st["hist"], bins, 1, served, accumulate=True)
        cap = cn["cap"][reqc]
        st["slo"] = st["slo"] + count(
            valid & torch.isfinite(cap) & (lat > cap + _SLO_TOL))
        return st

    def release(st, mask):
        """Host `release_slot` over a (C,) mask: every per-slot column."""
        out = {**st,
               "so": torch.where(mask, -1, st["so"]),
               "su": torch.where(mask, 0, st["su"]),
               "sec": torch.where(mask, 0.0, st["sec"]),
               "sm": torch.where(mask, -1, st["sm"]),
               "sdg": st["sdg"] & ~mask,
               "sddl": torch.where(mask, torch.inf, st["sddl"]),
               "sfree": st["sfree"] | mask}
        if cfg.fault_failures:
            out["srt"] = torch.where(mask, torch.inf, st["srt"])
        return out

    def sim_clear(st, mask):
        """`FleetEngineSim._clear` over a (C,) mask."""
        return {**st,
                "je": torch.where(mask, -1, st["je"]),
                "jtc": torch.where(mask, torch.inf, st["jtc"]),
                "jwk": torch.where(mask, 0.0, st["jwk"]),
                "jrm": torch.where(mask, torch.inf, st["jrm"]),
                "jw": torch.where(mask, 1.0, st["jw"])}

    def remaining_col(st, t):
        """`FleetEngineSim.remaining(t)`: (C,) unloaded seconds, inf idle.
        The calendar was already advanced to t at the event's start."""
        act = st["je"] >= 0
        rem = torch.clamp(st["jrm"], min=0.0) if cfg.ps \
            else torch.clamp(st["jtc"] - t, min=0.0)
        return torch.where(act, rem, torch.inf)

    def park_of(st):
        act = st["je"] >= 0
        return act, torch.where(act, torch.clamp(st["je"], 0, E - 1), E)

    def job_rates(st, cn):
        act, park = park_of(st)
        occ = bucket_add(E + 1, park, act.to(F64))[:E]
        if cfg.tokens:
            rates = traced_token_rates(occ, cn["tkw"], cn["tkv"],
                                       cn["tkf"], cn["tkc"], cn["tk1"])
        else:
            rates = traced_engine_rates(occ, cn["conc"])
        return traced_job_rates(st["je"], st["jw"], act, rates, st["wtd"])

    def next_completion(st, cn):
        """`FleetEngineSim.next_completion` — the per-job quotient form,
        value-equal to the host's per-engine min."""
        act = st["je"] >= 0
        if not cfg.ps:
            return torch.where(act, st["jtc"], torch.inf).min()
        jr = job_rates(st, cn)
        q = torch.where(act, torch.clamp(st["jrm"], min=0.0)
                        / torch.where(act, jr, 1.0), torch.inf)
        return torch.where(act.any(), st["tl"] + q.min(), torch.inf)

    def peak_update(st, cn):
        act, park = park_of(st)
        occ = scat(torch.zeros(E + 1, dtype=I64, device=park.device), park,
                   1, act, accumulate=True)[:E]
        return {**st, "po": torch.maximum(st["po"], occ)}

    # ------------------------------------------------------------------
    # admission queue: per-class FIFO rings + paused buffer
    # ------------------------------------------------------------------
    def class_head(st, cn, k):
        """(valid, request, is_paused) head of class ``k`` (python int):
        the paused buffer's front when non-empty, else the fresh ring's
        front (every paused seq of a class precedes every fresh one)."""
        B = cn["arr"].shape[0]
        fh = st["qh"][k]
        fresh_valid = fh < st["qt"][k]
        fresh_req = cn["members"][k, torch.clamp(fh, 0, B - 1)]
        if paused_on:
            has_p = st["pn"][k] > 0
            return (has_p | fresh_valid,
                    torch.where(has_p, st["pb"][k, 0], fresh_req), has_p)
        return fresh_valid, fresh_req, torch.zeros_like(fresh_valid)

    def merged_head(st, cn):
        """Queue head across classes: max class weight, then min arrival
        seq — the host heap's (-weight, seq) pop order.  Returns (valid,
        class index, request, head weight)."""
        dev = st["qh"].device
        best_k = torch.tensor(-1, dtype=I64, device=dev)
        best_w = torch.tensor(-torch.inf, dtype=F64, device=dev)
        best_s = torch.tensor(_BIG_SEQ, dtype=I64, device=dev)
        best_r = torch.tensor(0, dtype=I64, device=dev)
        for k in range(K):
            valid, req, _ = class_head(st, cn, k)
            s = torch.where(valid, cn["seq"][req], _BIG_SEQ)
            w = torch.where(valid, cn["wcls"][k], -torch.inf)
            better = valid & ((w > best_w) | ((w == best_w) & (s < best_s)))
            best_k = torch.where(better, k, best_k)
            best_w = torch.where(better, w, best_w)
            best_s = torch.where(better, s, best_s)
            best_r = torch.where(better, req, best_r)
        return best_k >= 0, best_k, best_r, best_w

    def skip_dead(st, cn):
        """Advance each class's fresh head past predictive-rejected
        entries so `class_head` always exposes a live request."""
        if not pol.wants_forecast:
            return st
        B = cn["arr"].shape[0]
        for k in range(K):
            while True:
                h = st["qh"][k]
                hr = cn["members"][k, torch.clamp(h, 0, B - 1)]
                if not _read((h < st["qt"][k]) & st["dead"][hr]):
                    break
                st = {**st, "qh": _add(st["qh"], k, 1)}
        return st

    def pop_head(st, cn, k_idx):
        """Remove the merged head (class ``k_idx``, a tensor): paused
        front when present, else the fresh ring front."""
        onehot = torch.arange(K, device=k_idx.device) == k_idx
        if paused_on:
            from_p = onehot & (st["pn"] > 0)
            shifted = torch.cat([st["pb"][:, 1:],
                                 torch.full_like(st["pb"][:, :1], -1)], 1)
            st = {**st,
                  "pb": torch.where(from_p[:, None], shifted, st["pb"]),
                  "pn": st["pn"] - from_p.long(),
                  "qh": st["qh"] + (onehot & ~from_p).long()}
        else:
            st = {**st, "qh": st["qh"] + onehot.long()}
        return skip_dead(st, cn)

    def paused_insert(st, cn, i, k_idx):
        """Insert request ``i`` into class ``k_idx``'s paused buffer in
        arrival-seq order (the host re-pushes it onto the heap; within a
        class the heap orders by seq)."""
        B = cn["arr"].shape[0]
        row = st["pb"][k_idx]
        iota = torch.arange(P, device=row.device)
        seqs = torch.where(iota < st["pn"][k_idx],
                           cn["seq"][torch.clamp(row, 0, B - 1)], _BIG_SEQ)
        pos = count(seqs < cn["seq"][i])
        new_row = torch.where(iota < pos, row,
                              torch.where(iota == pos, i,
                                          torch.roll(row, 1)))
        return {**st,
                "pb": _set(st["pb"], k_idx, new_row),
                "pn": _add(st["pn"], k_idx, 1),
                "rpp": _set(st["rpp"], i, True)}

    def shed_paused_rows(st, cn, t, doom_fn):
        """Shed doomed entries out of every paused row (stable compaction),
        mirroring the host's queue-side paused-deadline sheds."""
        B = cn["arr"].shape[0]
        for k in range(K):
            row = st["pb"][k]
            iota = torch.arange(P, device=row.device)
            activep = iota < st["pn"][k]
            req = torch.clamp(row, 0, B - 1)
            doomed = activep & doom_fn(req)
            ocp = torch.full((P,), _OC_SHED, dtype=I64, device=row.device)
            if fault_any:
                # a fault-touched request dies "failed", not "shed"
                flt = st["rfl"][req]
                ocp = torch.where(flt, _OC_FAILED, ocp)
                st = record_terminal(st, cn, req, doomed, t, ocp,
                                     st["rpec"][req])
                st["ffc"] = st["ffc"] + count(doomed & flt)
                st["shd"] = st["shd"] + count(doomed & ~flt)
            else:
                st = record_terminal(st, cn, req, doomed, t, ocp,
                                     st["rpec"][req])
                st["shd"] = st["shd"] + count(doomed)
            st["rpp"] = scat(st["rpp"], req, False, doomed)
            keep = activep & ~doomed
            tgt = torch.where(keep, torch.cumsum(keep.long(), 0) - 1, P)
            new_row = scat(torch.full_like(row, -1), tgt, row, keep)
            st["pb"] = _set(st["pb"], k, new_row)
            st["pn"] = _set(st["pn"], k, count(keep))
        return st

    def paused_doom(st, cn, t):
        def doom(req):
            ddl = cn["arr"][req] + cn["cap"][req]
            return torch.isfinite(ddl) & (
                (t >= ddl) | (t + st["rprm"][req] > ddl + _CERT_SLACK))
        return doom

    def shed_oc(st, ownc):
        """(C,) outcome codes for a shed site: "failed" when any fault
        already touched the slot's owner (host `shed`), "shed" otherwise."""
        oc = torch.full((C,), _OC_SHED, dtype=I64, device=ownc.device)
        if fault_any:
            oc = torch.where(st["rfl"][ownc], _OC_FAILED, oc)
        return oc

    def count_sheds(st, mask, ownc):
        """Mirror `shed_oc`'s split into the shd/ffc counters."""
        st = dict(st)
        if fault_any:
            flt = st["rfl"][ownc]
            st["ffc"] = st["ffc"] + count(mask & flt)
            st["shd"] = st["shd"] + count(mask & ~flt)
        else:
            st["shd"] = st["shd"] + count(mask)
        return st

    # ------------------------------------------------------------------
    # event phases (the numbers mirror events.py's comments)
    # ------------------------------------------------------------------
    def phase_completions(st, cn, t):
        act = st["je"] >= 0
        done = act & ((st["jrm"] <= _DONE_TOL) if cfg.ps
                      else (st["jtc"] <= t))
        own = st["so"]
        newu = cn["child"][st["su"], torch.clamp(st["sm"], 0, M - 1)]
        st = dict(st)
        st["su"] = torch.where(done, newu, st["su"])
        st["ru"] = scat(st["ru"], own, newu, done)
        st["sm"] = torch.where(done, -1, st["sm"])
        fin = done & st["sok"]
        deep = done & ~st["sok"] & (cn["depth"][newu] >= cfg.max_depth)
        term = fin | deep
        st["rsc"] = scat(st["rsc"], own, True, fin)
        st = record_terminal(st, cn, own, term, t,
                             torch.full_like(own, _OC_SERVED), st["sec"])
        st["snd"] = st["snd"] | (done & ~term)
        st = release(st, term)
        return sim_clear(st, done)

    def phase_deadline_sheds(st, cn, t):
        if not cfg.deadline_sheds:
            return st
        B = cn["arr"].shape[0]
        # (i) certainty bound on in-service work: PS rate <= 1, so
        # t + remaining lower-bounds completion
        insvc = (st["so"] >= 0) & (st["sm"] >= 0)
        rem = remaining_col(st, t)
        ownc = torch.clamp(st["so"], 0, B - 1)
        ddl = cn["arr"][ownc] + cn["cap"][ownc]
        doomed = insvc & ((t >= ddl) | (t + rem > ddl + _CERT_SLACK))
        st = record_terminal(st, cn, st["so"], doomed, t,
                             shed_oc(st, ownc), st["sec"])
        st = count_sheds(st, doomed, ownc)
        st = sim_clear(st, doomed)
        st = release(st, doomed)
        # (ii) backstop: the deadline column is a scheduled event (it also
        # catches slots held in a fault-retry backoff)
        mask2 = st["sddl"] <= t
        ownc2 = torch.clamp(st["so"], 0, B - 1)
        st["snd"] = st["snd"] & ~mask2
        st = record_terminal(st, cn, st["so"], mask2, t,
                             shed_oc(st, ownc2), st["sec"])
        st = count_sheds(st, mask2, ownc2)
        st = sim_clear(st, mask2 & (st["sm"] >= 0))
        return release(st, mask2)

    def phase_faults(st, cn, t):
        """Host step 1f: engine fault transitions at exactly t (downs
        before ups at one instant).  A down transition checkpoints every
        in-service stage on the dead engine into the paused buffer with
        stage model -1 ("replan on admit"), charging one retry attempt;
        an exhausted budget fails the request terminally.  Preempted
        stages whose paused calendar entry sat on the dead engine convert
        to replan-on-admit with the attempt charged (the host's lenient
        rule).  The availability mask ``av`` feeds the blocked-depth
        column of the next replan."""
        if not cfg.fault_outages:
            return st
        B = cn["arr"].shape[0]
        F = cn["ftt"].shape[0] - 1  # trailing +inf pad
        dev = st["so"].device
        iota_c = torch.arange(C, device=dev)

        def hit_mask(s2, ei):
            insvc = (s2["so"] >= 0) & (s2["sm"] >= 0)
            return insvc & (cn["eom"][torch.clamp(s2["sm"], 0, M - 1)]
                            == ei)

        while _read(cn["ftt"][torch.clamp(st["fi"], 0, F)] <= t):
            cur = torch.clamp(st["fi"], 0, F)
            ei = cn["fte"][cur]
            up = cn["ftu"][cur]
            s = dict(st)
            s["fi"] = s["fi"] + 1
            s["av"] = _set(s["av"], ei, up)
            s["frc"] = s["frc"] + up.long()
            s["foc"] = s["foc"] + (~up).long()
            if not _read(up):
                # victims checkpoint one at a time in ascending slot
                # order (the host's nonzero() sweep)
                while _read(hit_mask(s, ei).any()):
                    hit = hit_mask(s, ei)
                    slot = torch.argmax(hit.to(torch.int32))
                    onehot_c = iota_c == slot
                    i = s["so"][slot]
                    d = cn["depth"][s["su"][slot]]
                    ec = s["sec"][slot]
                    dg = s["sdg"][slot]
                    uu = s["su"][slot]
                    s = dict(s)
                    s["fck"] = s["fck"] + 1
                    s["rfl"] = _set(s["rfl"], i, True)
                    s["rpat"] = _add(s["rpat"], (i, d), 1)
                    exhausted = s["rpat"][i, d] > cfg.max_retries
                    s = sim_clear(s, onehot_c)
                    if _read(exhausted):
                        s = record_terminal(
                            s, cn, i.reshape(1),
                            torch.ones(1, dtype=torch.bool, device=dev), t,
                            torch.full((1,), _OC_FAILED, dtype=I64,
                                       device=dev), ec.reshape(1))
                        s["ffc"] = s["ffc"] + 1
                    else:
                        s["rpu"] = _set(s["rpu"], i, uu)
                        s["rpm"] = _set(s["rpm"], i, -1)
                        s["rpok"] = _set(s["rpok"], i, False)
                        s["rprm"] = _set(s["rprm"], i, 0.0)
                        s["rpec"] = _set(s["rpec"], i, ec)
                        s["rpdg"] = _set(s["rpdg"], i, dg)
                        s = paused_insert(s, cn, i, cn["cls"][i])
                    s = release(s, onehot_c)
                if cfg.priorities:
                    conv = s["rpp"] & (s["rpm"] >= 0) & (
                        cn["eom"][torch.clamp(s["rpm"], 0, M - 1)] == ei)
                    dconv = torch.clamp(cn["depth"][s["rpu"]], 0,
                                        cfg.max_depth - 1)
                    s = dict(s)
                    s["rfl"] = s["rfl"] | conv
                    ext = torch.cat([s["rpat"], s["rpat"][:1]])
                    rows = torch.where(conv, torch.arange(B, device=dev), B)
                    ext.index_put_((rows, dconv),
                                   torch.ones_like(rows), accumulate=True)
                    s["rpat"] = ext[:B]
                    s["rpm"] = torch.where(conv, -1, s["rpm"])
                    s["rprm"] = torch.where(conv, 0.0, s["rprm"])
            st = s
        return st

    def phase_retry_release(st, cn, t):
        """Host step 1r: slots whose retry backoff expired rejoin the
        replan set."""
        if not cfg.fault_failures:
            return st
        rel = st["srt"] <= t
        return {**st, "srt": torch.where(rel, torch.inf, st["srt"]),
                "snd": st["snd"] | rel}

    def phase_arrivals(st, cn, t):
        B = cn["arr"].shape[0]
        while _read((st["ap"] < B)
                    & (cn["arrs"][torch.clamp(st["ap"], 0, B - 1)] <= t)):
            k = cn["clsord"][torch.clamp(st["ap"], 0, B - 1)]
            st = {**st, "ap": st["ap"] + 1, "qt": _add(st["qt"], k, 1)}
        return st

    def phase_queue_rejections(st, cn, t):
        if not (pol.gates or cfg.deadline_sheds):
            return st
        if not pol.wants_forecast:
            # paused entries die only by deadline (shed, not reject)
            if paused_on and cfg.deadline_sheds:
                st = shed_paused_rows(st, cn, t, paused_doom(st, cn, t))
            if not pol.gates:
                return st
            # rejection is a prefix of each class ring: elapsed decreases
            # along the ring while the class cap is constant
            B = cn["arr"].shape[0]
            dev = st["qh"].device
            for k in range(K):
                while True:
                    i = cn["members"][k, torch.clamp(st["qh"][k], 0, B - 1)]
                    cap = cn["cap"][i]
                    if not _read((st["qh"][k] < st["qt"][k])
                                 & torch.isfinite(cap)
                                 & (t - cn["arr"][i]
                                    > cap - pol.min_path_lat + pol.margin)):
                        break
                    st = record_terminal(
                        st, cn, i.reshape(1),
                        torch.ones(1, dtype=torch.bool, device=dev), t,
                        torch.full((1,), _OC_REJECTED, dtype=I64,
                                   device=dev),
                        torch.zeros(1, dtype=F64, device=dev))
                    st["rad"] = _set(st["rad"], i, t)
                    st["rej"] = st["rej"] + 1
                    st["qh"] = _add(st["qh"], k, 1)
            return st
        return predictive_scan(st, cn, t)

    def predictive_scan(st, cn, t):
        """Host 2b under predictive admission: one pass over the merged
        (class weight, arrival seq) queue order, handing the k-th *kept*
        entry behind the free slots the k-th projected completion;
        rejected entries are tombstoned in the ``dead`` mask."""
        B = cn["arr"].shape[0]
        dev = st["qh"].device
        n_free = count(st["sfree"])
        act = st["je"] >= 0
        if cfg.ps:
            jr = job_rates(st, cn)
            tc = st["tl"] + torch.clamp(st["jrm"], min=0.0) \
                / torch.where(act, jr, 1.0)
        else:
            tc = st["jtc"]
        proj = torch.sort(torch.where(act, tc, torch.inf)).values
        nproj = count(act)
        proj_last = proj[torch.clamp(nproj - 1, 0, C - 1)]
        iota_k = torch.arange(K, device=dev)

        def heads(s):
            """Scan-local heads: paused cursor first (lower seqs), then
            the fresh cursor (skipping prior tombstones)."""
            out = []
            for k in range(K):
                if cfg.priorities:
                    on_p = s["ppi"][k] < s["pn"][k]
                    p_req = s["pb"][k, torch.clamp(s["ppi"][k], 0, P - 1)]
                else:
                    on_p = torch.tensor(False, device=dev)
                    p_req = torch.tensor(0, dtype=I64, device=dev)
                fh = s["pfh"][k]
                f_ok = fh < s["qt"][k]
                f_req = cn["members"][k, torch.clamp(fh, 0, B - 1)]
                out.append((on_p | f_ok, torch.where(on_p, p_req, f_req),
                            on_p))
            return out

        def any_valid(s):
            any_v = torch.tensor(False, device=dev)
            for valid, _, _ in heads(s):
                any_v = any_v | valid
            return any_v

        def body(s):
            best_k = torch.tensor(-1, dtype=I64, device=dev)
            best_w = torch.tensor(-torch.inf, dtype=F64, device=dev)
            best_s = torch.tensor(_BIG_SEQ, dtype=I64, device=dev)
            best_r = torch.tensor(0, dtype=I64, device=dev)
            best_p = torch.tensor(False, device=dev)
            for k, (valid, req, on_p) in enumerate(heads(s)):
                sq = torch.where(valid, cn["seq"][req], _BIG_SEQ)
                w = torch.where(valid, cn["wcls"][k], -torch.inf)
                better = valid & ((w > best_w)
                                  | ((w == best_w) & (sq < best_s)))
                best_k = torch.where(better, k, best_k)
                best_w = torch.where(better, w, best_w)
                best_s = torch.where(better, sq, best_s)
                best_r = torch.where(better, req, best_r)
                best_p = torch.where(better, on_p, best_p)
            i = best_r
            onehot = iota_k == best_k
            # paused head: deadline-certainty shed or keep
            if cfg.priorities and cfg.deadline_sheds:
                doom_p = best_p & paused_doom(s, cn, t)(i)
            else:
                doom_p = torch.tensor(False, device=dev)
            # fresh head: forecast-gated rejection
            j = s["pos"] - n_free
            use_wf = (j >= 0) & (nproj > 0)
            nproj_s = torch.where(nproj > 0, nproj, 1)
            g = (j // nproj_s).to(F64)
            rix = torch.clamp(j % nproj_s, 0, C - 1)
            wf = torch.where(use_wf, torch.clamp(
                proj[rix] - t + g * (proj_last - t), min=0.0), 0.0)
            cap = cn["cap"][i]
            rej = ~best_p & torch.isfinite(cap) & (
                t - cn["arr"][i] + pol.discount * wf
                > cap - pol.min_path_lat + pol.margin)
            kept = ~doom_p & ~rej
            one = i.reshape(1)
            ec_term = torch.where(doom_p, s["rpec"][i], 0.0) \
                if cfg.priorities else torch.tensor(0.0, dtype=F64,
                                                    device=dev)
            s = record_terminal(
                s, cn, one, (doom_p | rej).reshape(1), t,
                torch.where(doom_p, _OC_SHED, _OC_REJECTED).reshape(1),
                ec_term.reshape(1))
            s["shd"] = s["shd"] + doom_p.long()
            s["rej"] = s["rej"] + rej.long()
            s["rad"] = scat(s["rad"], one, t, rej.reshape(1))
            if cfg.priorities:
                s["rpp"] = scat(s["rpp"], one, False, doom_p.reshape(1))
            s["dead"] = scat(s["dead"], one, True, rej.reshape(1))
            s["pos"] = s["pos"] + kept.long()
            # shed paused entries compact out of the buffer; the cursor
            # stays (the next entry slid into its position)
            if cfg.priorities:
                row = s["pb"][best_k]
                iota = torch.arange(P, device=dev)
                drop = best_p & doom_p
                comp = torch.where((iota >= s["ppi"][best_k]) & drop,
                                   torch.roll(row, -1), row)
                comp = _set(comp, P - 1, torch.where(drop, -1, comp[P - 1]))
                s["pb"] = _set(s["pb"], best_k, comp)
                s["pn"] = s["pn"] - (onehot & drop).long()
                s["ppi"] = s["ppi"] + (onehot & best_p & ~doom_p).long()
            s["pfh"] = s["pfh"] + (onehot & ~best_p).long()
            # fresh cursor skips tombstones from earlier events
            for k in range(K):
                while True:
                    h = s["pfh"][k]
                    hr = cn["members"][k, torch.clamp(h, 0, B - 1)]
                    if not _read((h < s["qt"][k]) & s["dead"][hr]):
                        break
                    s = {**s, "pfh": _add(s["pfh"], k, 1)}
            return s

        st = dict(st)
        st["pos"] = torch.tensor(0, dtype=I64, device=dev)
        st["pfh"] = st["qh"]
        if cfg.priorities:
            st["ppi"] = torch.zeros(K, dtype=I64, device=dev)
        while _read(any_valid(st)):
            st = body(st)
        st.pop("pos")
        st.pop("pfh")
        st.pop("ppi", None)
        return skip_dead(st, cn)

    def any_preemptable(st, cn):
        if not (cfg.priorities and cfg.preempt):
            return False
        B = cn["arr"].shape[0]
        valid, _, _, head_w = merged_head(st, cn)
        insvc = (st["so"] >= 0) & (st["sm"] >= 0)
        lower = insvc & (cn["wreq"][torch.clamp(st["so"], 0, B - 1)]
                         < head_w)
        return valid & lower.any()

    def phase_preempt(st, cn, t):
        if not (cfg.priorities and cfg.preempt):
            return st
        B = cn["arr"].shape[0]
        iota_c = torch.arange(C, device=st["so"].device)
        while _read(~st["sfree"].any() & any_preemptable(st, cn)):
            s = st
            _, _, _, head_w = merged_head(s, cn)
            insvc = (s["so"] >= 0) & (s["sm"] >= 0)
            ownc = torch.clamp(s["so"], 0, B - 1)
            cand = insvc & (cn["wreq"][ownc] < head_w)
            rem = remaining_col(s, t)
            # victim: lexicographic min of (weight, -remaining, slot)
            k1 = torch.where(cand, cn["wreq"][ownc], torch.inf)
            c2 = cand & (k1 == k1.min())
            k2 = torch.where(c2, -rem, torch.inf)
            c3 = c2 & (k2 == k2.min())
            victim = torch.argmax(c3.to(torch.int32))
            i = s["so"][victim]
            onehot_c = iota_c == victim
            remw = rem[victim]
            s = dict(s)
            s["rpu"] = _set(s["rpu"], i, s["su"][victim])
            s["rpm"] = _set(s["rpm"], i, s["sm"][victim])
            s["rpok"] = _set(s["rpok"], i, s["sok"][victim])
            s["rprm"] = _set(s["rprm"], i, remw)
            s["rpec"] = _set(s["rpec"], i, s["sec"][victim])
            s["rpdg"] = _set(s["rpdg"], i, s["sdg"][victim])
            s["pre"] = s["pre"] + 1
            s["rpc"] = _add(s["rpc"], i, 1)
            s = sim_clear(s, onehot_c)
            s = release(s, onehot_c)
            st = paused_insert(s, cn, i, cn["cls"][i])
        return st

    def phase_admit(st, cn, t):
        dev = st["so"].device
        iota_c = torch.arange(C, device=dev)
        while True:
            valid, k_idx, i, _ = merged_head(st, cn)
            if not _read(st["sfree"].any() & valid):
                return st
            s = st
            slot = torch.argmax(s["sfree"].to(torch.int32))
            onehot_c = iota_c == slot
            s = pop_head(s, cn, k_idx)
            s = dict(s)
            s["so"] = torch.where(onehot_c, i, s["so"])
            s["sfree"] = s["sfree"] & ~onehot_c
            # fresh admission and paused resume, composed with masks
            # (each writes the union of the host branches' columns; the
            # non-taken branch writes the value the host left in place)
            if paused_on:
                isp = s["rpp"][i]
                # outage checkpoints carry stage model -1: restore the
                # realized prefix and budgets, then REPLAN instead of
                # resuming a calendar entry (host `resume`, pm < 0)
                isrp = (isp & (s["rpm"][i] < 0)) if cfg.fault_outages \
                    else torch.tensor(False, device=dev)
                isrs = isp & ~isrp
                s["su"] = torch.where(onehot_c,
                                      torch.where(isp, s["rpu"][i], 0),
                                      s["su"])
                s["sec"] = torch.where(onehot_c,
                                       torch.where(isp, s["rpec"][i], 0.0),
                                       s["sec"])
                s["sm"] = torch.where(onehot_c & isrs, s["rpm"][i], s["sm"])
                s["sok"] = torch.where(onehot_c & isp, s["rpok"][i],
                                       s["sok"])
                s["sdg"] = torch.where(onehot_c, isp & s["rpdg"][i],
                                       s["sdg"])
            else:
                isp = isrp = isrs = torch.tensor(False, device=dev)
                s["su"] = torch.where(onehot_c, 0, s["su"])
                s["sec"] = torch.where(onehot_c, 0.0, s["sec"])
                s["sdg"] = s["sdg"] & ~onehot_c
            if cfg.deadline_sheds:
                t_d = cn["arr"][i] + cn["cap"][i]
                s["sddl"] = torch.where(
                    onehot_c & torch.isfinite(t_d) & (t_d > t),
                    t_d, s["sddl"])
            if paused_on:
                s["rpp"] = _set(s["rpp"], i, False)
                # resume: restart the paused stage on the calendar with
                # the checkpointed remaining work (no replan); replan-on-
                # admit checkpoints skip the calendar entirely
                w = cn["wreq"][i]
                eng = cn["eom"][torch.clamp(s["rpm"][i], 0, M - 1)]
                s["je"] = torch.where(onehot_c & isrs, eng, s["je"])
                if cfg.ps:
                    s["jrm"] = torch.where(onehot_c & isrs,
                                           s["rprm"][i], s["jrm"])
                else:
                    s["jtc"] = torch.where(onehot_c & isrs,
                                           t + s["rprm"][i], s["jtc"])
                    s["jwk"] = torch.where(onehot_c & isrs,
                                           s["rprm"][i], s["jwk"])
                s["jw"] = torch.where(onehot_c & isrs, w, s["jw"])
                s["wtd"] = s["wtd"] | (isrs & (w != 1.0))
                s["jsq"] = torch.where(onehot_c & isrs, s["ns"], s["jsq"])
                s["ns"] = s["ns"] + isrs.long()
                s["res"] = s["res"] + isrs.long()
                if _read(isrs):
                    s = peak_update(s, cn)
            s["rad"] = torch.where(isp, s["rad"], _set(s["rad"], i, t))
            s["adm"] = s["adm"] + (~isp).long()
            s["snd"] = s["snd"] | (onehot_c & (~isp | isrp))
            st = s

    def plan(td, su, el32, ec32, delay_row, sc, kind, blocked):
        """One replan over the given lanes (`kernels.ops.trie_plan`: the
        kernel on a CUDA device, its plain version on the CPU)."""
        delays = delay_row[None, :].expand(su.shape[0], E).contiguous()
        return kernel_ops.trie_plan(
            td.terminal, td.depth, td.acc, td.cost, td.lat,
            td.subtree_size, td.path_models, td.path_counts,
            td.engine_of_model, su.to(torch.int32), el32, ec32,
            delays, *sc, kind=kind, variant=cfg.variant,
            blocked_depth=blocked)

    def phase_replan_dispatch(st, cn, t):
        """Host steps 4-5b: the planner over all capacity lanes,
        downgrade-lane override, vectorized dispatch, overload trim."""
        B = cn["arr"].shape[0]
        dev = st["so"].device
        st = dict(st)
        st["rp"] = st["rp"] + 1
        ownc = torch.clamp(st["so"], 0, B - 1)
        el = t - cn["arr"][ownc]
        if cfg.priorities:
            el = el + cn["shift"][ownc]
        el32 = el.to(F32)
        ec32 = st["sec"].to(F32)
        delay_row = torch.zeros(E, dtype=F32, device=dev)
        if cfg.load_aware:
            act, park = park_of(st)
            if cfg.tokens:
                # TokenWorkModel.delays over the live sequence COUNT; the
                # slowdown of EngineTokenModel.slowdown, one op a rounding
                occw = bucket_add(E + 1, park, act.to(F64))[:E]
                n = occw + 1.0
                b = torch.minimum(n, cn["tkc"])
                prod = cn["tkv"] * b
                sb = torch.maximum(cn["tkw"] + prod, cn["tkf"] * b)
                q1 = n / b
                q2 = sb / cn["tk1"]
                sd = q1 * q2
                dr64 = (sd - 1.0) * cn["ms"]
                # the host casts the dict values into a float32 row
                delay_row = torch.where(cn["hasm"], dr64, 0.0).to(F32)
            elif cfg.ps:
                # FleetLoadModel.delays over the live (weighted) occupancy
                wts = torch.where(act, st["jw"], 0.0) if cfg.priorities \
                    else act.to(F64)
                occw = bucket_add(E + 1, park, wts)[:E]
                dr64 = (torch.clamp((occw + 1.0) / cn["conc"], min=1.0)
                        - 1.0) * cn["ms"]
                delay_row = torch.where(cn["hasm"], dr64, 0.0).to(F32)
            if pol.wants_forecast and pol.backlog_delay > 0.0:
                # backlog-drain anchor (PredictiveGate.forecast_delay_row):
                # max against the float32 row in float64, like the host
                if cfg.ps:
                    rem = torch.where(act, torch.clamp(st["jrm"], min=0.0),
                                      0.0)
                    jr = torch.where(act, job_rates(st, cn), 0.0)
                else:
                    rem = torch.where(act, torch.clamp(st["jtc"] - t,
                                                       min=0.0), 0.0)
                    jr = act.to(F64)
                backlog = bucket_add(E + 1, park, rem)[:E]
                rate = bucket_add(E + 1, park, jr)[:E]
                drain = torch.where(rate > 0, backlog / rate, 0.0)
                delay_row = torch.maximum(
                    delay_row.to(F64), pol.backlog_delay * drain).to(F32)
        if cfg.fault_outages:
            # blocked-depth column from the live availability mask: the
            # planner admits target v iff bd[v] <= depth[u], i.e. every
            # stage strictly past the realized node runs on an up engine
            pmn = cn["td"].path_models.long()
            deadp = (pmn >= 0) & ~st["av"][
                cn["eom"][torch.clamp(pmn, 0, M - 1)]]
            posn = torch.arange(pmn.shape[1], device=dev)[None, :]
            bd = torch.clamp(torch.where(deadp, posn + 1, 0).amax(dim=1),
                             min=0).to(F32)
        else:
            bd = None
        need = st["snd"]
        su = st["su"]
        if cfg.n_shards > 1:
            # Sharded control plane: every rank keeps the whole replicated
            # engine state, and plans only the lanes of its residue class
            # ``lane % n_shards == rank`` (cn["own"], a fixed gather index:
            # no host read), as `repro` partitions its per-lane sweeps.
            # The planner is lane-independent, so each lane's plan is the
            # capacity-wide call's.
            own = cn["own"]
            su, el32o, ec32o = su[own], el32[own], ec32[own]
        else:
            own, el32o, ec32o = None, el32, ec32
        if su.shape[0]:
            tgt, nxt = plan(cn["td"], su, el32o, ec32o, delay_row, cn["sc"],
                            cfg.kind, bd)
            tgt, nxt = tgt.long(), nxt.long()
        else:  # more ranks than lanes: this rank owns none
            tgt = nxt = su
        if pol.max_occupancy is not None and pol.downgrade:
            # downgraded lanes plan min-cost, with no blocked column; the
            # read is of the replicated mask, so every rank takes it alike
            dgl = need & st["sdg"]
            if _read(dgl.any()):
                dglo = dgl if own is None else dgl[own]
                if su.shape[0]:
                    tdg, ndg = plan(cn["td"], su, el32o, ec32o, delay_row,
                                    cn["scdg"], cfg.kind_dg, None)
                    tgt = torch.where(dglo, tdg.long(), tgt)
                    nxt = torch.where(dglo, ndg.long(), nxt)
        if own is None:
            tgt = torch.where(need, tgt, -1)
            nxt = torch.where(need, nxt, -1)
        else:
            # the one collective of a replan round, after the downgrade
            # override: each needy lane has exactly one owner, which sends
            # its plan + 1 while every other rank sends 0
            full = torch.zeros((2, C), dtype=I64, device=dev)
            full[:, own] = torch.stack([tgt, nxt])
            merged = merge_plans(full, cn["ownm"] & need,
                                 cn["mesh"]).to(dev)
            tgt = torch.where(need, merged[0].long(), -1)
            nxt = torch.where(need, merged[1].long(), -1)
        if cfg.explore:
            # exploration lane (host 4c): a pre-drawn request's FIRST
            # dispatch (root prefix) overrides the planner's pick with
            # its explore model, iff the float32 budget guard passes
            # against the live annotation version (subtract, add,
            # compare — all exact IEEE float32, as on the host)
            td = cn["td"]
            xm = cn["xpm"][ownc]
            xv = cn["child"][0, torch.clamp(xm, 0, M - 1)]
            xvc = torch.clamp(xv, 0, td.lat.shape[0] - 1)
            ok = (need & (nxt >= 0) & (st["su"] == 0) & (xm >= 0)
                  & (el32 + (td.lat[xvc] - td.lat[0]) <= cn["sc"][2])
                  & (ec32 + (td.cost[xvc] - td.cost[0]) <= cn["sc"][1]))
            if cfg.fault_outages:
                # host 4c skips the override when its engine is down
                ok = ok & st["av"][cn["eom"][torch.clamp(xm, 0, M - 1)]]
            nxt = torch.where(ok, xm, nxt)
            st["xpc"] = st["xpc"] + count(ok)
        stop = need & (nxt < 0)
        infeas = stop & (tgt < 0)
        oc = torch.full((C,), _OC_SERVED, dtype=I64, device=dev)
        if pol.gates:
            started = cn["depth"][st["su"]] > 0
            shed_m = infeas & started
            rej_m = infeas & ~started
            if fault_any:
                # a fault-touched request that becomes infeasible is a
                # FAILURE, not a shed/reject (host classify conversion)
                flt = st["rfl"][ownc]
                fail_m = infeas & flt
                shed_m = shed_m & ~flt
                rej_m = rej_m & ~flt
                oc = torch.where(fail_m, _OC_FAILED, oc)
                st["ffc"] = st["ffc"] + count(fail_m)
            oc = torch.where(shed_m, _OC_SHED, oc)
            oc = torch.where(rej_m, _OC_REJECTED, oc)
            st["shd"] = st["shd"] + count(shed_m)
            n_rej = count(rej_m)
            st["rej"] = st["rej"] + n_rej
            st["adm"] = st["adm"] - n_rej
        st = record_terminal(st, cn, st["so"], stop, t, oc, st["sec"])
        start_m = need & (nxt >= 0)
        if cfg.fault_failures:
            # seeded stage-failure draws, indexed per (request, depth,
            # attempt) and consulted BEFORE the executor charges cost
            mr = cfg.max_retries
            d0 = cn["depth"][st["su"]]
            d0c = torch.clamp(d0, 0, cfg.max_depth - 1)
            a0 = st["rpat"][ownc, d0c]
            draw = start_m & cn["fdr"][ownc, d0c, torch.clamp(a0, 0, mr)]
            scat_rows = torch.where(draw, ownc, B)
            ext = torch.cat([st["rpat"], st["rpat"][:1]])
            ext.index_put_((scat_rows, d0c), torch.ones_like(scat_rows),
                           accumulate=True)
            st["rpat"] = ext[:B]
            st["rfl"] = scat(st["rfl"], ownc, True, draw)
            a1 = a0 + 1
            exh = draw & (a1 > mr)
            retry = draw & ~exh
            st["fsc"] = st["fsc"] + count(draw)
            st["frt"] = st["frt"] + count(retry)
            st["ffc"] = st["ffc"] + count(exh)
            nb = cn["fbo"].shape[0]
            st["srt"] = torch.where(
                retry, t + cn["fbo"][torch.clamp(a0, 0, nb - 1)], st["srt"])
            st = record_terminal(st, cn, st["so"], exh, t,
                                 torch.full_like(oc, _OC_FAILED), st["sec"])
            st = release(st, exh)
            start_m = start_m & ~draw
        d = cn["depth"][st["su"]]
        row = cn["row"][ownc]
        nxtc = torch.clamp(nxt, 0, M - 1)
        sres = cn["tabs"][row, d, nxtc]
        c = cn["tabc"][row, d, nxtc]
        lat = cn["tabl"][row, d, nxtc]
        st["sec"] = torch.where(start_m, st["sec"] + c, st["sec"])
        st["sm"] = torch.where(start_m, nxt, st["sm"])
        st["sok"] = torch.where(start_m, sres, st["sok"])
        # calendar starts, seq assigned in ascending slot order
        rank = torch.cumsum(start_m.long(), 0) - 1
        st["jsq"] = torch.where(start_m, st["ns"] + rank, st["jsq"])
        st["ns"] = st["ns"] + count(start_m)
        st["je"] = torch.where(start_m, cn["eom"][nxtc], st["je"])
        if cfg.ps:
            st["jrm"] = torch.where(start_m, lat, st["jrm"])
        else:
            st["jtc"] = torch.where(start_m, t + lat, st["jtc"])
            st["jwk"] = torch.where(start_m, lat, st["jwk"])
        if cfg.priorities:
            w = cn["wreq"][ownc]
            st["jw"] = torch.where(start_m, w, st["jw"])
            st["wtd"] = st["wtd"] | (start_m & (w != 1.0)).any()
        st = release(st, stop)
        st = peak_update(st, cn)
        st["snd"] = torch.zeros_like(st["snd"])
        if pol.max_occupancy is not None:
            st = phase_overload(st, cn, t)
        return st

    def phase_overload(st, cn, t):
        """Host 5b: per engine over its occupancy target, iteratively trim
        the lowest goodput-per-token jobs (downgrade first, shed when
        already downgraded) — CostAwareShed.overload_actions.  The trim
        count is fixed on entry, so one read decides each engine."""
        maxo = pol.max_occupancy
        iota_c = torch.arange(C, device=st["so"].device)
        for e in range(E):
            def on_engine(s):
                insvc = (s["so"] >= 0) & (s["sm"] >= 0)
                return insvc & (cn["eom"][torch.clamp(s["sm"], 0, M - 1)]
                                == e)

            excess = int(_read(count(on_engine(st)) - maxo))
            taken = torch.zeros(C, dtype=torch.bool, device=iota_c.device)
            for _ in range(max(excess, 0)):
                s = st
                cand = on_engine(s) & ~taken
                acc = cn["bacc"][s["su"]]
                remc = torch.clamp(cn["mcost"][s["su"]] - s["sec"], min=0.0)
                score = torch.where(
                    torch.isfinite(acc),
                    torch.clamp(acc, min=0.0) / (s["sec"] + remc + 1e-9),
                    -torch.inf)
                key = torch.where(cand, score, torch.inf)
                pick = cand & (key == key.min())
                victim = torch.argmax(pick.to(torch.int32))
                onehot_c = iota_c == victim
                dg = pol.downgrade & ~s["sdg"][victim]
                s = dict(s)
                s["sdg"] = s["sdg"] | (onehot_c & dg)
                s["dgc"] = s["dgc"] + dg.long()
                shed_m = onehot_c & ~dg
                s = record_terminal(s, cn, s["so"], shed_m, t,
                                    torch.full_like(s["so"], _OC_SHED),
                                    s["sec"])
                s["shd"] = s["shd"] + (~dg).long()
                s = sim_clear(s, shed_m)
                st = release(s, shed_m)
                taken = taken | onehot_c
        return st

    def next_event_time(st, cn):
        B = cn["arr"].shape[0]
        t_arr = torch.where(st["ap"] < B,
                            cn["arrs"][torch.clamp(st["ap"], 0, B - 1)],
                            torch.inf)
        tn = torch.minimum(t_arr, next_completion(st, cn))
        tn = torch.minimum(tn, st["sddl"].min())
        if cfg.fault_outages:
            F = cn["ftt"].shape[0] - 1
            tn = torch.minimum(tn, cn["ftt"][torch.clamp(st["fi"], 0, F)])
        if cfg.fault_failures:
            tn = torch.minimum(tn, st["srt"].min())
        if paused_on and cfg.deadline_sheds:
            req = torch.clamp(st["pb"], 0, B - 1)
            activep = torch.arange(P, device=req.device)[None, :] \
                < st["pn"][:, None]
            pddl = torch.where(activep, cn["arr"][req] + cn["cap"][req],
                               torch.inf)
            tn = torch.minimum(tn, pddl.min())
        return tn

    def event_body(st, cn):
        t = st["tn"]
        st = {**st, "ev": st["ev"] + 1,
              "snd": torch.zeros_like(st["snd"])}
        if cfg.ps:
            act = st["je"] >= 0
            tok = (cn["tkw"], cn["tkv"], cn["tkf"], cn["tkc"],
                   cn["tk1"]) if cfg.tokens else None
            jrm, tl = traced_advance(st["jrm"], st["tl"], t, st["je"],
                                     st["jw"], act, cn["conc"], st["wtd"],
                                     tok=tok)
            st = {**st, "jrm": jrm, "tl": tl}
        st = phase_completions(st, cn, t)
        if cfg.fault_outages:
            st = phase_faults(st, cn, t)
        st = phase_deadline_sheds(st, cn, t)
        st = phase_arrivals(st, cn, t)
        st = phase_queue_rejections(st, cn, t)
        if cfg.fault_failures:
            st = phase_retry_release(st, cn, t)
        # 3-5 cycle: preempt -> admit/resume -> replan -> dispatch,
        # repeated while freed slots can absorb queued arrivals
        while True:
            st = phase_preempt(st, cn, t)
            st = phase_admit(st, cn, t)
            need_any = _read(st["snd"].any())
            if need_any:
                st = phase_replan_dispatch(st, cn, t)
                valid = merged_head(st, cn)[0]
                again = (st["sfree"].any() & valid) \
                    | any_preemptable(st, cn)
            else:
                again = any_preemptable(st, cn)
            if not _read(again):
                break
        return {**st, "tn": next_event_time(st, cn)}

    def step(st, cn, t_hi):
        while _read(torch.isfinite(st["tn"]) & (st["tn"] <= t_hi)):
            st = event_body(st, cn)
        return st

    _ENGINE_CACHE[cfg] = step
    return step


def _tabulate_executor(executor: StageExecutor, requests: np.ndarray,
                       probe: np.ndarray, t_start: float,
                       work_model=None, engines=None,
                       engine_of_model=None):
    """Evaluate the executor over (unique request value, depth, model)
    once, producing the dense (U, D, M) tables the dispatch gathers from
    — why the compiled engine requires executors to be pure functions of
    that triple (every cell is probed at ``t_start``).  ``probe`` is a
    (D, M) bool mask of the (depth, model) pairs the trie can dispatch:
    only those cells are evaluated; the others stay zero and are masked
    out of every use.  Under a ``work_model`` (token calendar) the
    latency cell is the stage's token footprint in batch-1 seconds, the
    same `TokenWorkModel.work_of` the host loop calls at dispatch."""
    uniq, row = np.unique(requests, return_inverse=True)
    U = uniq.shape[0]
    D, M = probe.shape
    tab_s = np.zeros((U, D, M), dtype=bool)
    tab_c = np.zeros((U, D, M), dtype=np.float64)
    tab_l = np.zeros((U, D, M), dtype=np.float64)
    for ui, rv in enumerate(uniq):
        for d, m in zip(*np.nonzero(probe)):
            s, c, lat = executor(int(rv), int(d), int(m), t_start)
            if work_model is not None:
                ptok, dtok = work_model.stage_tokens(int(rv), int(d),
                                                     int(m))
                lat = work_model.work_of(
                    engines[int(engine_of_model[int(m)])], ptok, dtok)
            tab_s[ui, d, m] = bool(s)
            tab_c[ui, d, m] = float(c)
            tab_l[ui, d, m] = float(lat)
    return tab_s, tab_c, tab_l, row.astype(np.int32)


def run_events_compiled(
    trie: Trie,
    ann: TrieAnnotations,
    obj: Objective,
    requests: np.ndarray,
    executor: StageExecutor,
    *,
    arrivals: np.ndarray | None = None,
    capacity: int | None = None,
    policy: str = "dynamic",
    admission=None,
    classes: np.ndarray | None = None,
    class_specs=None,
    preempt: bool = True,
    restrict_nodes: np.ndarray | None = None,
    load_probe=None,
    fleet_load=None,
    work_model=None,
    t_start: float = 0.0,
    plan_variant: str | None = None,
    annotation_schedule=None,
    refresh=None,
    explore=None,
    faults=None,
    epoch: int = DEFAULT_EPOCH,
    stream: bool = False,
    devices: int | None = None,
    device: str | torch.device = "cuda",
) -> tuple[list[ExecutionResult], EventStats]:
    """Compiled twin of `repro_torch.core.events.run_events` (its
    signature plus ``epoch``/``stream``/``devices``), with the engine
    state on ``device`` ("cuda" unless the caller asks for "cpu"); see
    that function for the serving semantics — the two give identical
    results.

    ``epoch`` sets how many arrivals each step ingests before the host
    takes the next epoch bound (any value gives identical results and
    reuses the same step).  With ``stream=True`` the per-request result
    list is not materialized: the call returns ``(summary_dict,
    EventStats)`` where the summary carries the streaming Welford
    moments, quantile histogram and counters.

    ``annotation_schedule`` swaps in re-annotated `TrieDevice` versions
    mid-run: the epoch loop splits at each swap time, so every event at
    ``t <= t_swap`` runs under the old annotations.  ``explore`` enables
    the exploration lane (float32 budget guard, as on the host).
    ``faults`` takes a `repro_torch.core.faults.FaultSchedule`: outage
    transitions become (time, engine, up) operand columns whose
    availability mask feeds the planner's blocked-depth column, victims
    checkpoint into the paused buffer as replan-on-admit entries, and
    seeded stage-failure draws gate dispatch with capped exponential
    backoff.  ``work_model`` switches the calendar to the token model
    (stage work tabulated through `TokenWorkModel.work_of`).

    Raises `NotImplementedError` for what stays on the host loop:
    ``load_probe``, ``refresh``, ``timeout_k``, ``recovery="restart"``,
    custom admission policies or duck-typed load / work models, and faults
    with forecast- or occupancy-gated admission.

    ``devices`` shards the replan rounds over a lane mesh
    (`repro_torch.dist.sharding.lane_mesh`; see the module docstring):
    every rank of a process group of that size calls with the same
    arguments and returns the single-device results, the engine state on
    ``cuda:{rank % device_count}`` (or the CPU).  Without a group of that
    size it raises ``ValueError`` naming the recipe."""
    dev = resolve_device(device)
    if policy not in ("dynamic", "dynamic_load_aware"):
        raise ValueError(f"unsupported events policy {policy!r}: the static "
                         "baseline plans once per request — use run_cohort's "
                         "scalar path")
    if load_probe is not None:
        raise NotImplementedError(
            "compiled event engine cannot run a host load_probe callback; "
            "use fleet_load=FleetLoadModel(...) or the host loop")
    if work_model is not None:
        if fleet_load is not None:
            raise ValueError("work_model and fleet_load are mutually "
                             "exclusive: the token calendar replaces the "
                             "scalar slowdown model")
        if getattr(work_model, "stage_tokens", None) is None:
            raise ValueError("work_model.stage_tokens must be set: the "
                             "token calendar needs per-stage "
                             "(prefill, decode) token counts")
        from repro_torch.serving.loadsim import (EngineTokenModel,
                                                 TokenWorkModel)
        if not isinstance(work_model, TokenWorkModel) or not all(
                isinstance(m, EngineTokenModel)
                for m in work_model.engines.values()):
            raise NotImplementedError(
                "compiled event engine supports TokenWorkModel with "
                "EngineTokenModel entries; use the host loop for duck-typed "
                "work models")
    if refresh is not None:
        raise NotImplementedError(
            "compiled event engine cannot run the online estimator refresh "
            "(posterior updates are host-side observations); use the host "
            "loop (compiled=False) or a precomputed annotation_schedule")
    n_shards = 1 if devices is None else int(devices)
    if n_shards < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    mesh = None
    if n_shards > 1:
        mesh = lane_mesh(n_shards, device=dev)  # the group's refusal first
        dev = mesh.device
    pol = get_policy(admission)
    traced_admission(pol)  # raises for custom policy subclasses
    fault_outages = faults is not None and bool(faults.outages)
    fault_failures = faults is not None and (
        faults.stage_failure_rate > 0.0 or faults.failure_table is not None)
    if faults is not None:
        if faults.timeout_k is not None:
            raise NotImplementedError(
                "compiled event engine cannot run the stage-timeout model "
                "(timeout_k needs the host loop's live latency forecasts); "
                "use compiled=False")
        if faults.recovery != "checkpoint":
            raise NotImplementedError(
                f"compiled event engine only supports recovery='checkpoint' "
                f"(got {faults.recovery!r}); restart-from-root is a host-loop "
                "baseline")
        if (fault_outages or fault_failures) and (
                pol.wants_forecast or pol.max_occupancy is not None):
            raise NotImplementedError(
                "compiled event engine does not combine fault injection with "
                "forecast- or occupancy-gated admission policies; use the "
                "host loop (compiled=False)")
    requests = np.asarray(requests)
    B = int(requests.shape[0])
    if arrivals is None:
        arrivals = np.zeros(B, dtype=np.float64)
    else:
        arrivals = np.asarray(arrivals, dtype=np.float64)
        if arrivals.shape != (B,):
            raise ValueError(f"arrivals shape {arrivals.shape} != ({B},)")
        if B and (not np.all(np.isfinite(arrivals)) or arrivals.min() < 0):
            raise ValueError("arrivals must be finite and non-negative")
    if capacity is None:
        capacity = B if arrivals.size == 0 or arrivals.max() == 0.0 \
            else min(B, _DEFAULT_CAPACITY)
    C = int(capacity)
    if B and C < 1:
        raise ValueError("capacity must be >= 1")

    priorities = class_specs is not None
    if not priorities and classes is not None:
        raise ValueError("classes requires class_specs (the SLOClass table "
                         "the indices point into)")
    base_cap = obj.lat_cap if obj.lat_cap is not None else np.inf
    if priorities:
        specs = tuple(class_specs)
        if not specs:
            raise ValueError("class_specs must be a non-empty sequence of "
                             "SLO classes")
        cls_idx = (np.zeros(B, dtype=np.int64) if classes is None
                   else np.asarray(classes, dtype=np.int64))
        if cls_idx.shape != (B,):
            raise ValueError(f"classes shape {cls_idx.shape} != ({B},)")
        if B and (cls_idx.min() < 0 or cls_idx.max() >= len(specs)):
            raise ValueError(
                f"classes must index the {len(specs)} class_specs entries")
        cap_cls = np.array([c.deadline_s if c.deadline_s is not None
                            else base_cap for c in specs], dtype=np.float64)
        w_cls = np.array([c.weight for c in specs], dtype=np.float64)
        cap_req = cap_cls[cls_idx]
        weight_req = w_cls[cls_idx]
        K = len(specs)
    else:
        cls_idx = np.zeros(B, dtype=np.int64)
        cap_req = np.full(B, base_cap)
        weight_req = np.ones(B)
        w_cls = np.ones(1)
        K = 1

    stats = EventStats(capacity=C, policy=pol.name,
                       outcome=[SERVED] * B,
                       arrival_t=arrivals.copy(),
                       admit_t=np.zeros(B, dtype=np.float64),
                       done_t=np.zeros(B, dtype=np.float64),
                       class_of=cls_idx.copy() if priorities else None,
                       preempt_count=np.zeros(B, dtype=np.int64))
    if B == 0:
        return ([], stats) if not stream else (
            _empty_summary(stats), stats)

    td = TrieDevice.build(trie, ann, restrict_nodes, device=dev)
    swaps: list[tuple[float, TrieDevice]] = []
    if annotation_schedule:
        sched = sorted(annotation_schedule, key=lambda sa: float(sa[0]))
        for i, (ts, swap_ann) in enumerate(sched):
            ts = float(ts)
            if not np.isfinite(ts) or ts < 0:
                raise ValueError(
                    f"annotation_schedule swap time {ts!r} must be finite "
                    "and non-negative")
            swap_td = TrieDevice.build(trie, swap_ann, restrict_nodes,
                                       device=dev)
            swap_td.version = i + 1
            swaps.append((ts, swap_td))
    lat_shift = np.zeros(B)
    eff_cap = None
    if priorities:
        finite = cap_req[np.isfinite(cap_req)]
        eff_cap = float(finite.max()) if finite.size else None
        if eff_cap is not None:
            lat_shift = np.where(np.isfinite(cap_req),
                                 eff_cap - cap_req, -np.inf)
            # the host loop's float32 elapsed-shift resolution caveat
            step = float(np.spacing(np.float32(eff_cap)))
            if step > 1e-3 * float(finite.min()):
                warnings.warn(
                    f"class deadline spread ({finite.min():.3g}s .. "
                    f"{eff_cap:.3g}s) exceeds float32 elapsed-shift "
                    f"resolution ({step:.3g}s at the largest cap): the "
                    "planner's feasibility may lag the deadline "
                    "bookkeeping by up to that much for tight classes",
                    stacklevel=2)
    plan_obj = obj if eff_cap is None \
        else dataclasses.replace(obj, lat_cap=eff_cap)
    engines = trie_engines(trie.template)
    E = len(engines)
    M = trie.template.n_models
    max_depth = trie.template.max_depth
    load_aware = policy == "dynamic_load_aware"

    term_mask = trie.terminal.copy()
    if restrict_nodes is not None:
        keep = np.zeros(trie.n_nodes, dtype=bool)
        keep[restrict_nodes] = True
        term_mask &= keep
    pol.bind(trie, ann, obj, term_mask)
    tpol = traced_admission(pol)  # re-distill with bound min_path_lat
    explore_model = _explore_tables(trie, term_mask, B, explore)
    deadline_sheds = pol.shed_on_deadline and bool(
        np.isfinite(cap_req).any())

    # load coupling: the calendar needs the concrete EngineLoadModel
    # parameters, not a duck-typed slowdown callable
    conc = np.full(E, np.inf)
    ms = np.ones(E)
    hasm = np.zeros(E, dtype=bool)
    tokens = work_model is not None
    ps = tokens or (load_aware and fleet_load is not None)
    if tokens:
        # token calendar: the decode-step curve coefficients become (E,)
        # operands; tk1 = decode_step_s(1) is computed here so the engine
        # and the host share one rounding
        tkw, tkv, tkf = np.zeros(E), np.zeros(E), np.zeros(E)
        tkc, tk1 = np.ones(E), np.ones(E)
        for j, e in enumerate(engines):
            m = work_model.engines.get(e)
            if m is None:
                raise ValueError(
                    f"work_model has no token model for engine {e!r}: the "
                    "token calendar needs every trie engine's decode curve")
            tkw[j] = float(m.t_weights_s)
            tkv[j] = float(m.t_kv_s)
            tkf[j] = float(m.t_flop_s)
            tkc[j] = float(m.kv_capacity)
            tk1[j] = max(float(m.t_weights_s) + float(m.t_kv_s),
                         float(m.t_flop_s))
            ms[j] = float(work_model.mean_service_s.get(e, 1.0))
            hasm[j] = True
    elif ps:
        from repro_torch.serving.loadsim import (EngineLoadModel,
                                                 FleetLoadModel)
        if not isinstance(fleet_load, FleetLoadModel) or not all(
                isinstance(m, EngineLoadModel)
                for m in fleet_load.engines.values()):
            raise NotImplementedError(
                "compiled event engine supports FleetLoadModel with "
                "EngineLoadModel entries; use the host loop for duck-typed "
                "load models")
        for j, e in enumerate(engines):
            m = fleet_load.engines.get(e)
            if m is not None:
                conc[j] = float(m.concurrency)
                ms[j] = float(fleet_load.mean_service_s.get(e, 1.0))
                hasm[j] = True

    order = np.argsort(arrivals, kind="stable")
    seq_of = np.empty(B, dtype=np.int64)
    seq_of[order] = np.arange(B)
    members = np.full((K, B), -1, dtype=np.int64)
    cls_ord = cls_idx[order]
    for k in range(K):
        mem_k = order[cls_ord == k]
        members[k, :mem_k.size] = mem_k

    # only (depth, model) pairs some trie node can dispatch get probed
    probe = np.zeros((max_depth + 1, M), dtype=bool)
    node_depth = trie.depth.astype(np.int64)
    has_child = trie.child >= 0  # (n_nodes, M)
    np.logical_or.at(probe, node_depth, has_child)
    eom = np.asarray(td.engine_of_model.cpu().numpy(), dtype=np.int64)
    tab_s, tab_c, tab_l, row = _tabulate_executor(
        executor, requests, probe, t_start, work_model=work_model,
        engines=engines, engine_of_model=eom)
    best_acc, min_cost = _subtree_reductions(trie, ann, term_mask)

    sketch = QuantileSketch.log_spaced()
    cfg = _EngineConfig(
        capacity=C, n_classes=K, n_engines=E, n_models=M,
        max_depth=max_depth, priorities=priorities, preempt=bool(preempt),
        ps=ps, load_aware=load_aware, tokens=tokens,
        deadline_sheds=deadline_sheds,
        pol=tpol, kind=obj.kind, kind_dg="min_cost",
        variant=_resolve_variant(plan_variant, dev), n_bins=sketch.n_bins,
        explore=explore_model is not None,
        fault_outages=fault_outages, fault_failures=fault_failures,
        max_retries=int(faults.max_retries) if faults is not None else 0,
        # outage victims can stack past C across repeated outages, so the
        # paused buffer is sized B under fault injection
        paused_cap=B if fault_outages else (C if priorities else 0),
        n_shards=n_shards)
    step = _build_step(cfg)

    def col(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    dg_obj = Objective("min_cost", acc_floor=-1.0,
                       cost_cap=obj.cost_cap, lat_cap=plan_obj.lat_cap)
    cn = {
        "td": td,
        "sc": _objective_scalars(plan_obj),
        "scdg": _objective_scalars(dg_obj),
        "arr": col(arrivals),
        "arrs": col(arrivals[order]),
        "cap": col(cap_req, np.float64),
        "wreq": col(weight_req, np.float64),
        "shift": col(lat_shift, np.float64),
        "seq": col(seq_of),
        "cls": col(cls_idx, np.int64),
        "clsord": col(cls_ord, np.int64),
        "members": col(members),
        "wcls": col(w_cls, np.float64),
        "child": col(trie.child, np.int64),
        "depth": col(trie.depth, np.int64),
        "eom": col(eom),
        "row": col(row, np.int64),
        "tabs": col(tab_s),
        "tabc": col(tab_c),
        "tabl": col(tab_l),
        "conc": col(conc),
        "ms": col(ms),
        "hasm": col(hasm),
        "bacc": col(best_acc, np.float64),
        "mcost": col(min_cost, np.float64),
        "edges": col(sketch.edges),
    }
    if mesh is not None:
        cn["mesh"] = mesh
        cn["own"] = torch.arange(mesh.rank, C, n_shards, device=dev)
        cn["ownm"] = torch.arange(C, device=dev) % n_shards == mesh.rank
    if tokens:
        cn.update(tkw=col(tkw), tkv=col(tkv), tkf=col(tkf), tkc=col(tkc),
                  tk1=col(tk1))
    if explore_model is not None:
        cn["xpm"] = col(explore_model, np.int64)
    if fault_outages:
        # transition columns, padded with one sentinel row so the cursor
        # clip reads (inf, engine 0, up) past the end
        fev = faults.events(engines)
        cn["ftt"] = col(np.array([t for t, _, _ in fev] + [np.inf]))
        cn["fte"] = col(np.array([ei for _, ei, _ in fev] + [0],
                                 dtype=np.int64))
        cn["ftu"] = col(np.array([up for _, _, up in fev] + [True],
                                 dtype=bool))
    if fault_failures:
        cn["fdr"] = col(faults.failure_draws(B, max_depth), bool)
        cn["fbo"] = col(np.array([faults.backoff(a) for a in
                                  range(int(faults.max_retries) + 1)],
                                 dtype=np.float64))
    st = _init_state(cfg, B, arrivals[order], dev)

    arrs = arrivals[order]
    chunk = max(int(epoch), 1)
    pos = 0
    si = 0
    while True:
        pos2 = min(pos + chunk, B)
        t_arr_hi = np.inf if pos2 >= B else float(arrs[pos2 - 1])
        if si < len(swaps) and swaps[si][0] < t_arr_hi:
            # annotation-version swap: run up to the swap time (events at
            # t <= t_swap stay under the old annotations, as on the host),
            # then substitute the new TrieDevice operand
            st = step(st, cn, float(swaps[si][0]))
            cn = {**cn, "td": swaps[si][1]}
            si += 1
            continue
        st = step(st, cn, t_arr_hi)
        pos = pos2
        if pos >= B:
            # arrivals exhausted: the final unbounded epoch drained every
            # remaining completion/deadline event
            break
    stats.annotation_swaps = si
    keys = [k for k in _COUNTERS if k in st]
    scal = dict(zip(keys, torch.stack([st[k] for k in keys]).cpu().tolist()))
    if scal["don"] != B:
        raise RuntimeError(
            f"compiled event loop stalled with work outstanding "
            f"({scal['don']}/{B} requests terminal)")

    stats.events = scal["ev"]
    stats.replans = scal["rp"]
    stats.admitted = scal["adm"]
    stats.rejected = scal["rej"]
    stats.shed = scal["shd"]
    stats.downgraded = scal["dgc"]
    stats.preemptions = scal["pre"]
    stats.resumed = scal["res"]
    stats.explored = scal["xpc"]
    if fault_outages:
        stats.engine_outages = scal["foc"]
        stats.engine_recoveries = scal["frc"]
        stats.checkpointed = scal["fck"]
    if fault_failures:
        stats.stage_failures = scal["fsc"]
        stats.fault_retries = scal["frt"]
    if fault_outages or fault_failures:
        stats.failed = scal["ffc"]
    stats.peak_occupancy = {
        e: int(v) for e, v in zip(engines, st["po"].cpu().tolist())}
    sketch.merge_counts(st["hist"].cpu().numpy(), edges=sketch.edges)
    if stream:
        # constant-memory path: per-request columns stay on the device;
        # the summary is O(1) scalars + the fixed-size quantile histogram
        # (carried under "sketch" so shard drains merge exactly)
        summary = {
            "n_requests": B,
            "events": stats.events,
            "replans": stats.replans,
            "served": B - stats.rejected - stats.shed - stats.failed,
            "succeeded": int(st["rsc"].sum()),
            "rejected": stats.rejected,
            "shed": stats.shed,
            "failed": stats.failed,
            "slo_violations": scal["slo"],
            "latency": _wf(st["lw"]),
            "cost": _wf(st["cw"]),
            "latency_p50": sketch.quantile(0.5),
            "latency_p95": sketch.quantile(0.95),
            "latency_p99": sketch.quantile(0.99),
            "sketch": sketch.state(),
        }
        stats.preempt_count = np.zeros(0, dtype=np.int64)
        stats.outcome = []
        return summary, stats

    roc = st["roc"].cpu().numpy()
    rsc = st["rsc"].cpu().numpy()
    rct = st["rct"].cpu().numpy()
    ru = st["ru"].cpu().numpy()
    stats.done_t = st["rdn"].cpu().numpy().copy()
    stats.admit_t = st["rad"].cpu().numpy().copy()
    stats.preempt_count = st["rpc"].cpu().numpy().astype(np.int64)
    stats.outcome = [_OUTCOMES[int(o)] for o in roc]
    results = []
    for i in range(B):
        lat = float(stats.done_t[i] - stats.arrival_t[i])
        slo = bool(np.isfinite(cap_req[i])) and lat > cap_req[i] + _SLO_TOL
        mods = trie.path(int(ru[i]))
        results.append(ExecutionResult(
            success=bool(rsc[i]),
            total_cost=float(rct[i]),
            total_lat=lat,
            models=mods,
            n_stages=len(mods),
            replan_overhead_s=0.0,
            slo_violated=slo,
            outcome=stats.outcome[i],
        ))
    return results, stats


# scalar counters drained in one copy at the end of a run
_COUNTERS = ("don", "ev", "rp", "adm", "rej", "shd", "dgc", "pre", "res",
             "xpc", "slo", "foc", "frc", "fck", "fsc", "frt", "ffc")


def _wf(wt) -> dict:
    """Finalize a Welford triple of tensors into host floats."""
    return welford_finalize(tuple(float(x) for x in wt))


def _empty_summary(stats: EventStats) -> dict:
    z = welford_finalize(welford_init())
    return {"n_requests": 0, "events": 0, "replans": 0, "served": 0,
            "succeeded": 0, "rejected": 0, "shed": 0, "failed": 0,
            "slo_violations": 0,
            "latency": z, "cost": z, "latency_p50": float("nan"),
            "latency_p95": float("nan"), "latency_p99": float("nan"),
            "sketch": QuantileSketch.log_spaced().state()}


def _init_state(cfg: _EngineConfig, B: int, arrs_sorted: np.ndarray,
                device) -> dict:
    """Engine state at t=0 (first event = first arrival), on ``device``."""
    C, K, E = cfg.capacity, cfg.n_classes, cfg.n_engines
    P = cfg.paused_cap

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)

    def zero(dtype):
        return full((), 0, dtype)

    st = {
        "tn": full((), float(arrs_sorted[0]), F64),
        "tl": zero(F64),
        "ap": zero(I64), "ns": zero(I64),
        "wtd": full((), False, torch.bool),
        "ev": zero(I64), "rp": zero(I64), "adm": zero(I64),
        "rej": zero(I64), "shd": zero(I64), "dgc": zero(I64),
        "pre": zero(I64), "res": zero(I64), "don": zero(I64),
        "slo": zero(I64),
        "po": full((E,), 0, I64),
        "so": full((C,), -1, I64),
        "su": full((C,), 0, I64),
        "sec": full((C,), 0.0, F64),
        "sm": full((C,), -1, I64),
        "sok": full((C,), False, torch.bool),
        "sdg": full((C,), False, torch.bool),
        "sfree": full((C,), True, torch.bool),
        "snd": full((C,), False, torch.bool),
        "sddl": full((C,), torch.inf, F64),
        "je": full((C,), -1, I64),
        "jsq": full((C,), 0, I64),
        "jtc": full((C,), torch.inf, F64),
        "jwk": full((C,), 0.0, F64),
        "jrm": full((C,), torch.inf, F64),
        "jw": full((C,), 1.0, F64),
        "qh": full((K,), 0, I64),
        "qt": full((K,), 0, I64),
        "roc": full((B,), _OC_SERVED, I64),
        "rsc": full((B,), False, torch.bool),
        "rct": full((B,), 0.0, F64),
        "rdn": full((B,), 0.0, F64),
        "rad": full((B,), 0.0, F64),
        "ru": full((B,), 0, I64),
        "rpc": full((B,), 0, I64),
        "lw": (zero(F64), zero(F64), zero(F64)),
        "cw": (zero(F64), zero(F64), zero(F64)),
        "hist": full((cfg.n_bins,), 0, I64),
        "xpc": zero(I64),
    }
    if cfg.priorities or cfg.fault_outages:
        st.update({
            "pb": full((K, P), -1, I64),
            "pn": full((K,), 0, I64),
            "rpu": full((B,), 0, I64),
            "rpm": full((B,), 0, I64),
            "rpok": full((B,), False, torch.bool),
            "rprm": full((B,), 0.0, F64),
            "rpec": full((B,), 0.0, F64),
            "rpdg": full((B,), False, torch.bool),
            "rpp": full((B,), False, torch.bool),
        })
    if cfg.fault_outages or cfg.fault_failures:
        st.update({
            "rfl": full((B,), False, torch.bool),
            "rpat": full((B, cfg.max_depth), 0, I64),
            "ffc": zero(I64),
        })
    if cfg.fault_outages:
        st.update({
            "av": full((E,), True, torch.bool),
            "fi": zero(I64),
            "foc": zero(I64), "frc": zero(I64), "fck": zero(I64),
        })
    if cfg.fault_failures:
        st.update({
            "srt": full((C,), torch.inf, F64),
            "fsc": zero(I64), "frt": zero(I64),
        })
    if cfg.pol.wants_forecast:
        st["dead"] = full((B,), False, torch.bool)
    return st


def merge_stream_summaries(a: dict, b: dict) -> dict:
    """Fold two streaming summaries (e.g. per-shard drains of a sharded
    replay) into one — exactly: counters add, Welford moments combine via
    Chan's parallel update, and the quantile sketches (each summary
    carries its histogram under ``"sketch"``) merge bin by bin before the
    p50/p95/p99 fields are recomputed from the merged counts.  Sketch
    merging validates the bin edges bitwise and raises ``ValueError``
    when the two summaries were accumulated over different binnings (or
    when only one side carries a sketch)."""
    out = dict(a)
    for key in ("n_requests", "events", "replans", "served", "succeeded",
                "rejected", "shed", "failed", "slo_violations"):
        out[key] = a[key] + b[key]
    for key in ("latency", "cost"):
        wa = (a[key]["count"], a[key]["mean"], a[key]["var"] * a[key]["count"])
        wb = (b[key]["count"], b[key]["mean"], b[key]["var"] * b[key]["count"])
        c, m, m2 = welford_merge(wa, wb)
        var = m2 / c if c > 0 else 0.0
        out[key] = {"count": c, "mean": m, "var": var,
                    "std": float(np.sqrt(max(var, 0.0)))}
    has_a, has_b = "sketch" in a, "sketch" in b
    if has_a != has_b:
        raise ValueError(
            "cannot merge stream summaries: only one side carries a "
            "quantile sketch — quantiles are not mergeable from the "
            "finalized p50/p95/p99 fields alone")
    if has_a:
        sk = QuantileSketch.from_state(a["sketch"])
        sk.merge(QuantileSketch.from_state(b["sketch"]))  # validates edges
        out["sketch"] = sk.state()
        out["latency_p50"] = sk.quantile(0.5)
        out["latency_p95"] = sk.quantile(0.95)
        out["latency_p99"] = sk.quantile(0.99)
    return out
