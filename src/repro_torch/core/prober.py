"""Neighboring-based adaptive bucket probing, exact path (paper §4.3/4.4,
Alg. 1–3; port of ``repro/core/prober.py``).

Lanes are rows: a batch of Q queries over L tables is Q·L lanes, lane
``i = q·L + t``, and every per-lane quantity is a row of a batch tensor.
Rings N_k are ``hamming == k`` masks over one table's bucket codes, read
over the index's live extent (``LSHIndex.live_extent``, a host int) and
not its capacity: rows past ``n_buckets`` lie in no ring. Ring
candidates are addressed through per-ring size cumsums of the sorted-CSR
layout; progressive sampling walks a keyed PRP over each ring's power-of-two
domain one ``chunk``-sized slab at a time, checking the Chernoff bounds of
§4.5 at the doubling points ``s_{i+1} = 2 s_i``.

Schedule: on the card under local stopping (no process group), one
``ops.slab_loop`` launch runs every lane's slab steps and stopping rule
until it is done, with no host sync (the kernel's rule is
:func:`_slab_step`'s, bit for bit). Elsewhere (CPU tensors, or pooled
stopping, which needs a collective a step) a host loop runs
``max(cfg.lane_block, 1)`` slab steps on the active lanes, syncs once on
``done``, and compacts the still-active lanes with an index select.
Finished lanes keep their state (the reference's ``where(done, old,
new)``), so per-lane results do not depend on ``lane_block`` or on the
loop that ran them — the reference is bit-identical across its schedules
too.

The PRP round keys are inputs: ``rks`` (Q, L, 6), int64 holding uint32
values, one row per lane (the reference draws them with
``jax.random.bits`` under its key tree; the parity tests pass those in).

On the host loop each slab step's candidate half — PRP draws, the search
of the ring's size cumsum, the CSR lookups and the qualification — is one
call of ``ops.slab_qualify`` (one fused kernel on the card), which returns
each lane's weight sum and sample count; the stopping rule stays here.

PQ qualification ("Dynamic Prober-PQ", Alg. 4/5): with PQ codes and the
batch's LUT stack, candidates qualify on their ADC distance (float, banded
or uint8 LUTs; packed 4-bit codes are read directly, where the reference's
``_gather_codes`` unpacks them first). Near rings ``k <= pq_exact_rings``
use exact distances: the reference's ``lax.cond`` on ``k`` becomes a
per-lane choice of route inside the slab kernel.

The queries' hash and their Hamming distances to every bucket are one
``ops.query_lanes`` call, and the central count (Alg. 3) of every lane one
``ops.central_qualify`` call: ring 0 is at most one bucket, the one whose
code equals the lane's, so the count reads that bucket's CSR slice and no
ring-0 cumsum row.

Pooled ("sync") stopping for a sharded index (``core/distributed.py``):
with a ``torch.distributed`` process group, one ``all_reduce`` at setup
and one per slab step pool the lanes' Chernoff statistics over the ranks'
shards, so every rank stops on the global selectivity, in lockstep.

Tracing: while a ``torch.profiler`` runs, each phase is a span
(:func:`repro_torch.utils.spans.span`): ``prober.query_lanes``,
``prober.table_setup`` (holding ``prober.ring_cumsums`` and
``prober.central_count``), ``prober.slab_loop`` (on the host loop holding
a ``prober.slab_block`` span a block, each holding a ``prober.slab_step``
span a step) and ``prober.tally``. :data:`TALLY` counts the slab's
candidates by route and its lane-steps, and the ring rows built, only
while a profiler runs (:func:`read_tally`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core import collectives, lsh, pq as pqmod, sampling
from repro_torch.core.config import ProberConfig
from repro_torch.kernels import ops
from repro_torch.utils.spans import span, enabled as _tracing
# the PRP of Alg. 2 lives beside the slab kernel's plain version
from repro_torch.kernels.ref import prp_eval as _prp_eval  # noqa: F401


# what the slab steps of the calls made under a profiler did, summed on the
# device: candidates the kernel qualified exactly and by ADC for lanes still
# active; candidates of lanes already done earlier in their block, which the
# merge discards; those discarded lane-steps; and the kept lane-steps. None
# until a profiled call, then an int64 tensor on that call's device. The
# last field, ring_rows, the bucket rows the calls built rings over (the
# live extent times the lanes), is host ints, so it is summed on the host
# (_RING_ROWS). _TALLIED counts the calls summed
TALLY_FIELDS = ("exact", "adc", "discarded", "discarded_lane_steps",
                "kept_lane_steps", "ring_rows")
_ON_DEVICE = len(TALLY_FIELDS) - 1
TALLY: torch.Tensor | None = None
_TALLIED = 0
_RING_ROWS = 0


def reset_tally() -> None:
    global TALLY, _TALLIED, _RING_ROWS
    TALLY, _TALLIED, _RING_ROWS = None, 0, 0


def read_tally() -> dict[str, int]:
    """:data:`TALLY` and the ring rows as ints by :data:`TALLY_FIELDS`, and
    under ``calls`` the number of calls they sum (a copy to the host: the
    caller waits for the device)."""
    vals = [0] * _ON_DEVICE if TALLY is None else TALLY.tolist()
    return {**dict(zip(TALLY_FIELDS, vals + [_RING_ROWS])),
            "calls": _TALLIED}


def _tally_rings(cums: torch.Tensor) -> None:
    """Add one call's ring rows, its (QL, K+1, E) cumsums' lanes times E,
    to the tally: host ints, no launch."""
    global _RING_ROWS
    _RING_ROWS += cums.shape[0] * cums.shape[-1]


def _tally_on(device) -> torch.Tensor:
    global TALLY
    if TALLY is None:
        TALLY = torch.zeros(_ON_DEVICE, dtype=torch.int64,
                            device=device)
    elif TALLY.device != device:
        TALLY = TALLY.to(device)
    return TALLY


def _tally(kept: list, qual: ops.Qual, n_rings: int) -> None:
    """Add the slab steps of one call to :data:`TALLY`: ``kept`` holds each
    step's ``(w_add, k, done)``, the candidates it drew per lane, the lanes'
    rings and whether they were done before the step. A lane qualifies
    exactly without codes or in ring ``min(k, K) <= exact_rings``. 10-14
    launches a call on the card, no sync."""
    global _TALLIED
    _TALLIED += 1
    if not kept:
        return
    w_add, k, done = (torch.cat(t) for t in zip(*kept))
    tally = _tally_on(w_add.device)
    discarded = done.long()
    if qual.codes is None:
        route = discarded * 2
    else:
        adc = (k.clamp_max(n_rings) > qual.exact_rings).long()
        route = torch.where(done, 2, adc)
    tally.scatter_add_(0, route, w_add.long())
    tally.scatter_add_(0, 4 - discarded, torch.ones_like(discarded))


def _tally_loop(counts: torch.Tensor) -> None:
    """Add the slab loop's per-lane ``counts`` of one call to
    :data:`TALLY`: a lane stops at the step that makes it done, so no
    candidate or lane-step is discarded. 3 launches, no sync."""
    global _TALLIED
    _TALLIED += 1
    tally = _tally_on(counts.device)
    sums = counts.sum(0, dtype=torch.int64)
    tally[:2] += sums[:2]
    tally[4:] += sums[2:]


class TableView(NamedTuple):
    """The index's per-table CSR arrays, stacked over the L tables, with
    the bucket axis cut to the index's live extent E."""
    order: torch.Tensor          # (L, C) int32
    bucket_codes: torch.Tensor   # (L, E, K) int32
    bucket_starts: torch.Tensor  # (L, E) int32
    bucket_sizes: torch.Tensor   # (L, E) int32
    n_buckets: torch.Tensor      # (L,) int32


def table_views(index: lsh.LSHIndex) -> TableView:
    """The index's tables over its first ``E = index.live_extent`` bucket
    rows, contiguous (three copies where E < B, none where E = B). Every
    row past E is padding, at Hamming distance K+1 from every query, so
    every ring prefix and total, and every slab search, is the same over
    the cut rows as over all B."""
    e = index.live_extent

    def cut(t):
        return t if t.shape[1] == e else t[:, :e].contiguous()
    return TableView(index.order, cut(index.bucket_codes),
                     cut(index.bucket_starts), cut(index.bucket_sizes),
                     index.n_buckets)


def ring_cumsums(view: TableView, ham: torch.Tensor,
                 n_rings: int) -> torch.Tensor:
    """Masked size cumsums of rings k = 0..n_rings for every lane.

    ``ham`` (Q, L, E) → (Q·L, n_rings+1, E) int32, row k of a lane being
    ``cumsum(where(ham == k, sizes, 0))``, over the view's E bucket rows.
    Built one ring at a time so the only temporary is one (Q, L, E) slice.
    Memory: Q·L·(K+1)·E·4 bytes.
    """
    nq, nl, nb = ham.shape
    cums = torch.empty((nq, nl, n_rings + 1, nb), dtype=torch.int32,
                       device=ham.device)
    for k in range(n_rings + 1):
        masked = torch.where(ham == k, view.bucket_sizes[None], 0)
        cums[:, :, k] = torch.cumsum(masked, dim=-1, dtype=torch.int32)
    return cums.reshape(nq * nl, n_rings + 1, nb)


def _count_central(view: TableView, tid: torch.Tensor, qcodes: torch.Tensor,
                   qual: ops.Qual, exact: bool, cfg: ProberConfig):
    """Alg. 3: exact count inside B_central for every lane, scaled by
    ``total/seen`` when the bucket exceeds ``central_budget``; candidates
    qualify exactly, or by ADC when ``exact`` is False. ``qcodes`` holds
    each lane's code, (Q, L, K) or (Q·L, K)."""
    qualified, seen, total = ops.central_qualify(
        qcodes, tid, view.bucket_codes, view.n_buckets, view.bucket_starts,
        view.bucket_sizes, view.order, qual, exact, cfg.central_budget)
    scale = torch.where(seen > 0, total / seen.clamp_min(1), 0.0)
    return qualified * scale, seen


class LaneCtx(NamedTuple):
    """Per-lane loop constants of the progressive sampler, (Q·L, ...)."""
    cums: torch.Tensor           # (QL, K+1, E) ring size cumsums
    rks: torch.Tensor            # (QL, 6) PRP round keys (Alg. 2)
    prings: torch.Tensor         # (QL, K) PRP domain P_k = next_pow2(cap)
    caps: torch.Tensor           # (QL, K) sample caps min(|N_k|, budget)
    nbits: torch.Tensor          # (QL, K) log2(P_k)
    totals_f: torch.Tensor       # (QL, K) |N_k|
    w_caps: torch.Tensor         # (QL, K) schedule cap ceil(s_max |N_k|)
    first_targets: torch.Tensor  # (QL, K) first anchor ceil(s1 |N_k|)
    visit_budget: int


def _bit_length(v: torch.Tensor) -> torch.Tensor:
    """Exact bit length of non-negative int32 values (``32 - clz``)."""
    pows = torch.ones(31, dtype=torch.int64, device=v.device) << torch.arange(
        31, device=v.device)
    return (v.long()[..., None] >= pows).sum(-1).to(torch.int32)


def _table_setup(view: TableView, ham: torch.Tensor, qcodes: torch.Tensor,
                 rks: torch.Tensor, tid: torch.Tensor, qual: ops.Qual,
                 central_exact: bool, cfg: ProberConfig, group=None):
    """Loop-free ring construction for every lane: ring cumsums, the exact
    central count (Alg. 3) of the lanes' codes ``qcodes``, PRP domains and
    Chernoff schedule anchors. Returns ``(ctx, est0, visited0)``.

    With a process ``group`` (pooled stopping) one ``all_reduce`` makes the
    central count, its sample count, the schedule anchors and caps global,
    and the visit budget is ``max_visit`` times the group's size (the same
    total budget as local stopping). The PRP domains and caps stay local:
    each rank samples only its own candidates. ``totals_f`` stays local
    too: each rank's ring estimate |N_k,s|·p̂_s is unbiased under its own
    uniform sampling, and their sum is the global ring count."""
    with span("prober.table_setup"):
        n_rings = view.bucket_codes.shape[-1]
        with span("prober.ring_cumsums"):
            cums = ring_cumsums(view, ham, n_rings)
        with span("prober.central_count"):
            est0, visited0 = _count_central(view, tid, qcodes, qual,
                                            central_exact, cfg)
        totals = cums[:, 1:, -1]
        totals_f = totals.float()
        caps = totals.clamp_max(cfg.ring_budget)
        nbits = torch.where(caps <= 1, 0, _bit_length((caps - 1).clamp_min(1)))
        prings = torch.ones_like(nbits) << nbits
        w_caps = torch.minimum(torch.ceil(cfg.s_max * totals_f), caps.float())
        totals_sched, visit_budget = totals_f, cfg.max_visit
        if group is not None:
            # float32 sums of counts: exact below 2^24
            pooled = torch.cat([est0[:, None], visited0[:, None].float(),
                                totals_f, w_caps], 1)
            collectives.all_reduce(pooled, group=group)
            est0, visited0 = pooled[:, 0], pooled[:, 1].int()
            totals_sched = pooled[:, 2:2 + n_rings]
            w_caps = pooled[:, 2 + n_rings:]
            visit_budget = cfg.max_visit * dist.get_world_size(group)
        first_targets = torch.ceil(cfg.s1 * totals_sched).clamp_min(1.0)
        ctx = LaneCtx(cums=cums, rks=rks, prings=prings, caps=caps,
                      nbits=nbits, totals_f=totals_f, w_caps=w_caps,
                      first_targets=first_targets,
                      visit_budget=visit_budget)
        return ctx, est0, visited0


def _init_state(ctx: LaneCtx, est0, visited0, n_rings: int) -> dict:
    nl = est0.shape[0]
    dev = est0.device
    zi = torch.zeros(nl, dtype=torch.int32, device=dev)
    return {"k": zi + 1, "ci": zi.clone(), "w": zi.clone(),
            "wq": torch.zeros(nl, dtype=torch.float32, device=dev),
            "target": ctx.first_targets[:, 0].clone(),
            "est": est0, "nvisited": visited0,
            "ptf": torch.zeros(nl, dtype=torch.bool, device=dev),
            "done": (visited0 >= ctx.visit_budget) | (n_rings < 1)}


def _row(t: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    return t.gather(1, row[:, None]).squeeze(1)


def _slab_step(s: dict, ctx: LaneCtx, small: LaneCtx, lanes: torch.Tensor,
               tid: torch.Tensor, view: TableView, qual: ops.Qual,
               cfg: ProberConfig, group=None, kept: list | None = None
               ) -> dict:
    """One progressive-sampling slab (Alg. 2 body) for the active lanes.

    ``s`` and ``small`` hold the active lanes' rows of the loop state and
    of the per-lane constants; ``lanes`` (A,) are their lane ids, ``tid``
    their tables. The visit budget counts the in-progress ring's samples
    every slab, and a budget hit folds the partial ring's estimate.

    With a process ``group`` (pooled stopping) ONE ``all_reduce`` of the
    (A, 5) stack ``[w, w', exhausted, 1, ring_est]`` pools the lanes'
    Chernoff statistics, exhaustion votes and ring estimates; every
    stopping quantity below reads the pooled values.

    ``kept`` (a list, while a profiler runs) gets the step's ``(w_add, k,
    done)``, tensors the step has anyway, for :func:`_tally`.
    """
    chunk = cfg.chunk
    n_rings = view.bucket_codes.shape[-1]
    k, ci = s["k"], s["ci"]
    wq_add, w_add = ops.slab_qualify(
        k, ci, lanes, tid, small.rks, small.prings, small.caps, small.nbits,
        ctx.cums, view.bucket_starts, view.order, qual, chunk)
    if kept is not None:
        kept.append((w_add, k, s["done"]))
    # lanes that finished earlier in the block (k = K+1) still run the step
    # and are discarded by the caller; clamp their ring to a valid row, as
    # the reference's clamped gathers do
    row = k.clamp_max(n_rings).long() - 1
    p_ring = _row(small.prings, row)
    wq = s["wq"] + wq_add
    w = s["w"] + w_add
    exhausted = (ci + 1) * chunk >= p_ring      # this rank's domain walked
    wf = w.float()
    ring_est = _row(small.totals_f, row) * wq / wf.clamp_min(1.0)
    wq_pool = wq
    if group is not None:
        pooled = torch.stack([wf, wq, exhausted.float(), torch.ones_like(wf),
                              ring_est], 1)
        collectives.all_reduce(pooled, group=group)
        wf, wq_pool, ring_est = pooled[:, 0], pooled[:, 1], pooled[:, 4]
        exhausted = pooled[:, 2] >= pooled[:, 3]
    p_hat = wq_pool / wf.clamp_min(1.0)
    w_cap = _row(small.w_caps, row)
    at_schedule = (wf >= s["target"]) | (wf >= w_cap)
    if not cfg.schedule_checks:
        at_schedule = torch.ones_like(at_schedule)
    cond1 = sampling.stop_sampling(p_hat, wf, cfg.a_const, cfg.eps)
    cond2 = sampling.stop_probing(p_hat, wf, cfg.a_const, cfg.eps)
    budget_hit = (s["nvisited"] + wf.int()) >= small.visit_budget
    ring_done = (at_schedule & (cond1 | cond2)) | (wf >= w_cap) | \
        exhausted | budget_hit
    ptf = s["ptf"] | (at_schedule & cond2)
    target = torch.where(at_schedule, s["target"] * 2.0, s["target"])
    nk = torch.where(ring_done, k + 1, k)
    nrow = (nk - 1).clamp_max(n_rings - 1).long()
    return {
        "k": nk, "ci": torch.where(ring_done, 0, ci + 1),
        "w": torch.where(ring_done, 0, w),
        "wq": torch.where(ring_done, 0.0, wq),
        "target": torch.where(ring_done, _row(small.first_targets, nrow),
                              target),
        "est": torch.where(ring_done, s["est"] + ring_est, s["est"]),
        "nvisited": torch.where(ring_done, s["nvisited"] + wf.int(),
                                s["nvisited"]),
        "ptf": ptf,
        "done": (nk > n_rings) | ptf | budget_hit,
    }


def _run_lanes(state: dict, ctx: LaneCtx, view: TableView,
               lane_t: torch.Tensor, qual: ops.Qual,
               cfg: ProberConfig, group=None,
               kept: list | None = None) -> dict:
    """The host loop: drive every lane to ``done`` in blocks of
    ``max(lane_block, 1)`` slab steps over the active lanes, one host sync
    per block, then compaction.
    Updates ``state`` in place and returns it; ``kept`` collects the steps'
    tally tensors (:func:`_slab_step`).

    Pooled stopping (``group``) keeps this schedule: ``done`` derives only
    from pooled values (the setup's and each step's ``all_reduce``, whose
    result is the same on every rank), so every rank selects the same
    active lanes, runs the same number of steps and passes collectives of
    the same shape, in lockstep."""
    block = max(cfg.lane_block, 1)
    with span("prober.slab_loop"):
        active = torch.nonzero(~state["done"]).squeeze(1)
        while active.numel():
            with span("prober.slab_block"):
                s = {kk: v[active] for kk, v in state.items()}
                small = ctx._replace(
                    cums=None, rks=ctx.rks[active],
                    prings=ctx.prings[active], caps=ctx.caps[active],
                    nbits=ctx.nbits[active], totals_f=ctx.totals_f[active],
                    w_caps=ctx.w_caps[active],
                    first_targets=ctx.first_targets[active])
                tid = lane_t[active]
                for _ in range(block):
                    with span("prober.slab_step"):
                        new = _slab_step(s, ctx, small, active, tid, view,
                                         qual, cfg, group, kept)
                        s = {kk: torch.where(s["done"], s[kk], new[kk])
                             for kk in s}
                for kk, v in s.items():
                    state[kk][active] = v
                active = torch.nonzero(~state["done"]).squeeze(1)
    return state


def _device_loop(device: torch.device, group) -> bool:
    """Whether one ``ops.slab_loop`` launch runs the slab loop: on the
    card, under local stopping (pooled stopping needs a collective a
    step)."""
    return group is None and device.type == "cuda"


def _loop_lanes(state: dict, ctx: LaneCtx, view: TableView,
                lane: torch.Tensor, lane_t: torch.Tensor, qual: ops.Qual,
                cfg: ProberConfig) -> torch.Tensor:
    """Drive every lane to ``done`` on the card in one ``ops.slab_loop``
    launch: :func:`_run_lanes` without a group, its steps and stopping rule
    in the kernel. Updates ``state`` in place; returns the per-lane counts
    (QL, 3): candidates qualified exactly, by ADC, and slab steps."""
    with span("prober.slab_loop"):
        return ops.slab_loop(
            state, lane, lane_t, ctx.rks, ctx.prings, ctx.caps, ctx.nbits,
            ctx.totals_f, ctx.w_caps, ctx.first_targets, ctx.cums,
            view.bucket_starts, view.order, qual, cfg.chunk, cfg.a_const,
            cfg.eps, ctx.visit_budget, cfg.schedule_checks)


def _make_qual(x, qs, tau_sq, lane_q, cfg: ProberConfig, pq_codes=None,
               pq_luts=None, pq_resid=None, pq_packed=None) -> ops.Qual:
    """Qualification inputs of the batch's Q·L lanes (lane i holds query
    ``lane_q[i]``): exact only, or the PQ routing of ``cfg`` — ADC beyond
    ring ``pq_exact_rings`` through the float (Q, M, Kc) LUT stack (banded
    with ``pq_banded``) or a batched :class:`~repro_torch.core.pq.QuantLUT`
    against its integer thresholds; ``pq_packed`` codes, when given, are
    read instead of the byte codes."""
    qual = ops.Qual(x, qs[lane_q].contiguous(), tau_sq[lane_q].contiguous())
    if pq_codes is None or pq_luts is None:
        return qual
    codes = pq_codes if pq_packed is None else pq_packed
    lane_q32 = lane_q.to(torch.int32)
    if isinstance(pq_luts, pqmod.QuantLUT):
        thresh = pqmod.quantized_threshold(pq_luts, pq_luts.q8.shape[1],
                                           tau_sq)[lane_q]
        return qual._replace(codes=codes, luts=pq_luts.q8.contiguous(),
                             lane_q=lane_q32, thresh=thresh.contiguous(),
                             exact_rings=cfg.pq_exact_rings)
    return qual._replace(codes=codes, luts=pq_luts.contiguous(),
                         lane_q=lane_q32,
                         resid=pq_resid if cfg.pq_banded else None,
                         exact_rings=cfg.pq_exact_rings)


class Lanes(NamedTuple):
    """A batch's Q·L lanes ready for the slab loop (:func:`setup_lanes`)."""
    state: dict                  # (QL,) loop state, by ops.LOOP_STATE's names
    ctx: LaneCtx
    view: TableView
    lane: torch.Tensor           # (QL,) int64 lane ids
    lane_t: torch.Tensor         # (QL,) int64 their tables
    qual: ops.Qual


def setup_lanes(index: lsh.LSHIndex, x: torch.Tensor, qs: torch.Tensor,
                taus: torch.Tensor, cfg: ProberConfig, rks: torch.Tensor,
                pq_codes=None, pq_luts=None, pq_resid=None, pq_packed=None,
                group=None) -> Lanes:
    """Everything :func:`estimate_batch` does before the slab loop: the
    queries' lanes, ring construction, the central count and the loop's
    initial state (the arguments are :func:`estimate_batch`'s)."""
    dev = x.device
    nq = qs.shape[0]
    nl = index.n_tables
    if tuple(rks.shape) != (nq, nl, 6):
        raise ValueError(f"rks must be ({nq}, {nl}, 6), got {tuple(rks.shape)}")
    qs = qs.to(dev, torch.float32).contiguous()
    taus = taus.to(dev, torch.float32)
    view = table_views(index)
    with span("prober.query_lanes"):
        qcodes, ham = lsh.query_lanes(index.params, qs, view.bucket_codes,
                                      view.n_buckets)  # (Q, L, K), (Q, L, E)
    lane = torch.arange(nq * nl, device=dev)
    lane_q, lane_t = lane // nl, lane % nl
    qual = _make_qual(x, qs, taus * taus, lane_q, cfg, pq_codes, pq_luts,
                      pq_resid, pq_packed)
    ctx, est0, visited0 = _table_setup(
        view, ham, qcodes, rks.to(dev, torch.int64).reshape(nq * nl, 6),
        lane_t, qual, qual.codes is None or cfg.pq_exact_central, cfg, group)
    del ham
    state = _init_state(ctx, est0, visited0, index.n_funcs)
    return Lanes(state, ctx, view, lane, lane_t, qual)


def estimate_batch(index: lsh.LSHIndex, x: torch.Tensor, qs: torch.Tensor,
                   taus: torch.Tensor, cfg: ProberConfig, rks: torch.Tensor,
                   with_stats: bool = False, pq_codes=None, pq_luts=None,
                   pq_resid=None, pq_packed=None, group=None,
                   steps: list | None = None):
    """Batched Alg. 1–3 over Q queries: ``qs`` (Q, d), ``taus`` (Q,), ``rks``
    (Q, L, 6) round keys. Returns the (Q,) estimates, each the mean of its
    L per-table estimates; with ``with_stats`` also the deepest folded ring
    ``probed_k`` (Q, L) and the pooled sample count ``nvisited`` (Q,).

    With ``pq_codes`` (C, M) uint8 and ``pq_luts`` (the batch's (Q, M, Kc)
    float LUT stack, or a batched ``QuantLUT``) candidates qualify by ADC
    as the config routes them; ``pq_resid`` (C,) serves banded
    qualification and ``pq_packed`` (C, M/2) the 4-bit codes.

    ``group`` (a ``torch.distributed`` process group; the index is this
    rank's shard) switches on pooled ("sync") stopping: one ``all_reduce``
    at setup and one per slab step (:func:`_table_setup`,
    :func:`_slab_step`), and the estimates are global, the same on every
    rank. Without it no collective runs, and on the card one launch runs
    every lane's slab loop (:func:`_loop_lanes`); the host loop
    (:func:`_run_lanes`) runs the steps elsewhere.

    ``steps`` (a list) gets the call's slab steps, tensors the loop has
    anyway, with no sync; :func:`slab_steps` reads them."""
    nq, nl, n_rings = qs.shape[0], index.n_tables, index.n_funcs
    b = setup_lanes(index, x, qs, taus, cfg, rks, pq_codes, pq_luts,
                    pq_resid, pq_packed, group)
    state = b.state
    tracing = _tracing()
    if _device_loop(x.device, group):
        counts = _loop_lanes(state, b.ctx, b.view, b.lane, b.lane_t, b.qual,
                             cfg)
        if steps is not None:
            steps.append(counts[:, 2])
        if tracing:
            with span("prober.tally"):
                _tally_loop(counts)
                _tally_rings(b.ctx.cums)
    else:
        kept = [] if tracing or steps is not None else None
        state = _run_lanes(state, b.ctx, b.view, b.lane_t, b.qual, cfg,
                           group, kept)
        if steps is not None:
            steps.append([done for *_, done in kept])
        if tracing:
            with span("prober.tally"):
                _tally(kept, b.qual, n_rings)
                _tally_rings(b.ctx.cums)
    ests = state["est"].reshape(nq, nl).mean(1)
    if not with_stats:
        return ests
    probed_k = (state["k"] - 1).clamp(0, n_rings).reshape(nq, nl)
    nvis = state["nvisited"].reshape(nq, nl).sum(1, dtype=torch.int32)
    return ests, probed_k, nvis


def slab_steps(record: list) -> dict[str, int]:
    """The slab steps of the estimates that filled ``record`` (their
    ``steps`` list): ``lane_steps``, the steps of all their lanes, and
    ``longest_lane``, the most steps one lane took. The slab loop gives
    each lane's steps; the host loop each step's ``done`` of the lanes it
    stepped, where a lane steps from the first step until it is done, so
    the longest lane takes every step that steps a lane. Syncs."""
    lane_steps = longest = 0
    for rec in record:
        if isinstance(rec, torch.Tensor):           # the slab loop's
            n = rec.long()
            lane_steps += int(n.sum())
            longest = max(longest, int(n.max()) if n.numel() else 0)
        elif rec:                                   # the host loop's
            live = torch.stack([(~d).sum() for d in rec])
            lane_steps += int(live.sum())
            longest = max(longest, int((live > 0).sum()))
    return {"lane_steps": lane_steps, "longest_lane": longest}


def estimate(index: lsh.LSHIndex, x: torch.Tensor, q: torch.Tensor,
             tau, cfg: ProberConfig, rks: torch.Tensor, **pq) -> torch.Tensor:
    """One query ``q`` (d,), radius ``tau``, round keys ``rks`` (L, 6): the
    Q = 1 row of :func:`estimate_batch`, whose PQ arguments ``pq`` (with
    the query's LUT stack of one) it passes on."""
    taus = torch.as_tensor(tau, dtype=torch.float32).reshape(1)
    return estimate_batch(index, x, q[None], taus, cfg, rks[None], **pq)[0]
