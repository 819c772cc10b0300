"""DynamicProber — the public API of the port.

    state = build(x, cfg, generator=g, capacity=C)       # offline index build
    ests  = estimate_batch(state, qs, taus, cfg, generator=g)
    state = update(state, x_new, cfg)                    # §5 data update

Port of ``repro/core/estimator.py``. ``cfg.use_pq`` switches the candidate
distance from exact L2 to PQ-ADC ("Dynamic Prober-PQ"): ``build`` then
fits a :class:`~repro_torch.core.pq.PQIndex`, each estimate builds its
batch's LUTs (float32, or uint8 with ``pq_int8_lut``), and ``update``
carries the PQ index through Alg. 8. ``build`` places the state on
``device`` (default ``"cuda"``; it raises when CUDA is absent and the CPU
was not asked for); every later call runs where the state lives. Random
draws take an explicit ``torch.Generator``; the PRP round keys of a batch
(``rks`` (Q, L, 6)) may instead be passed in, which is how the parity tests
replay the reference's key tree. Nothing here needs gradients.
:func:`estimate_batch_pooled` is the pooled ("sync") stopping mode of a
sharded index (``distributed.estimate_sharded``), and :func:`_ingest_core`
the update body that ``distributed.update_sharded`` shares. While a
``torch.profiler`` runs, each estimate is an ``estimator.estimate_batch``
span, its LUT build a ``pq.build_query_lut`` span inside it, and the
prober's phases spans inside those (``core/prober.py``); each update is an
``estimator.update`` span, a capacity growth an ``estimator.grow`` span
inside it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.cache import epochs as cache_epochs
from repro_torch.core import lsh, pq as pqmod, prober, updates
from repro_torch.core.config import ProberConfig
from repro_torch.kernels import ops
from repro_torch.utils.spans import span


class ProberState(NamedTuple):
    index: lsh.LSHIndex
    x: torch.Tensor                  # (C, d) float32; rows >= n_valid pad
    pq: Optional[pqmod.PQIndex] = None   # None unless cfg.use_pq
    epochs: Optional[cache_epochs.EpochState] = None
                                     # the estimate cache's ingest epochs;
                                     # None unless attached (track_epochs /
                                     # attach_epochs); update bumps them

    @property
    def n_valid(self) -> torch.Tensor:
        return self.index.n_valid

    @property
    def capacity(self) -> int:
        return self.x.shape[0]


def build(x: torch.Tensor, cfg: ProberConfig,
          generator: torch.Generator | None = None,
          params: lsh.LSHParams | None = None, capacity: int | None = None,
          device="cuda", track_epochs: bool = False) -> ProberState:
    """Offline build. With ``capacity`` the state is capacity-padded: arrays
    of ``capacity`` rows with ``x.shape[0]`` live, so an :func:`update` that
    fits keeps every shape. ``params`` reuses given hash functions;
    otherwise they are drawn from ``generator``, before the k-means initial
    rows. ``track_epochs`` attaches the estimate cache's ingest epochs."""
    dev = ops.resolve_device(device)
    x = torch.as_tensor(x).to(dev, torch.float32).contiguous()
    if params is not None:
        params = lsh.LSHParams(*(p.to(dev, torch.float32) for p in params))
    n = x.shape[0]
    if capacity is None:
        index = lsh.build_index(x, cfg, generator, params=params)
        x_all = x
    else:
        if capacity < n:
            raise ValueError(f"capacity {capacity} < {n} points")
        x_all = torch.nn.functional.pad(x, (0, 0, 0, capacity - n))
        index = lsh.build_index(x_all, cfg, generator, params=params,
                                n_valid=n)
    pq = None
    if cfg.use_pq:
        pq = pqmod.fit(x, cfg, generator)
        if capacity is not None:
            pq = pqmod.grow(pq, capacity)
    state = ProberState(index=index, x=x_all, pq=pq)
    return attach_epochs(state) if track_epochs else state


def attach_epochs(state: ProberState) -> ProberState:
    """Attach fresh ingest epochs (both counters 0), so that every later
    :func:`update` maintains them."""
    return state._replace(epochs=cache_epochs.init_epochs(state.x.device))


def draw_round_keys(generator: torch.Generator, nq: int, nl: int,
                    device) -> torch.Tensor:
    """PRP round keys (Q, L, 6): uint32 values held in int64."""
    rks = torch.randint(0, 2 ** 32, (nq, nl, 6), generator=generator,
                        dtype=torch.int64, device=generator.device)
    return rks.to(device)


def _round_keys(state: ProberState, nq: int, rks, generator):
    if rks is not None:
        return rks
    if generator is None:
        raise ValueError("pass rks= or generator=")
    return draw_round_keys(generator, nq, state.index.n_tables, state.x.device)


def estimate_batch(state: ProberState, qs: torch.Tensor, taus: torch.Tensor,
                   cfg: ProberConfig, rks: torch.Tensor | None = None,
                   generator: torch.Generator | None = None,
                   steps: list | None = None) -> torch.Tensor:
    """Estimate Q cardinalities |{p : ||p - q|| <= tau}|: ``qs`` (Q, d),
    ``taus`` (Q,) → (Q,) float32. ``steps`` is
    :func:`prober.estimate_batch`'s."""
    with span("estimator.estimate_batch"):
        rks = _round_keys(state, qs.shape[0], rks, generator)
        return prober.estimate_batch(state.index, state.x, qs, taus, cfg,
                                     rks, steps=steps,
                                     **_pq_args(state, qs, cfg))


def _pq_args(state: ProberState, qs: torch.Tensor,
             cfg: ProberConfig) -> dict:
    """The prober's PQ arguments: codes, the queries' LUT stack in the
    config's datapath, residuals and packed codes; empty off the PQ
    path."""
    pq = state.pq
    if not cfg.use_pq or pq is None:
        return {}
    with span("pq.build_query_lut"):
        lut = pqmod.build_query_lut(
            pq, qs.to(state.x.device, torch.float32), cfg)
    return {"pq_codes": pq.codes, "pq_luts": lut, "pq_resid": pq.resid,
            "pq_packed": pq.packed}


def estimate_batch_pooled(state: ProberState, qs: torch.Tensor,
                          taus: torch.Tensor, cfg: ProberConfig,
                          rks: torch.Tensor, group,
                          with_stats: bool = False,
                          steps: list | None = None):
    """The distributed "sync" stopping mode: :func:`estimate_batch` on this
    rank's shard with the Chernoff statistics of every slab step pooled
    over the process ``group`` (one ``all_reduce`` a step, see
    :func:`prober.estimate_batch`), so the ε-test sees the GLOBAL
    selectivity. Every rank of ``group`` must make the same call, with its
    own shard and its own round keys ``rks`` (Q, L, 6). Returns the global
    (Q,) estimates, the same on every rank; ``with_stats`` adds the pooled
    ``probed_k`` (Q, L) and ``nvisited`` (Q,). ``steps`` is
    :func:`prober.estimate_batch`'s."""
    with span("estimator.estimate_batch"):
        return prober.estimate_batch(state.index, state.x, qs, taus, cfg,
                                     rks, with_stats=with_stats, group=group,
                                     steps=steps, **_pq_args(state, qs, cfg))


def estimate_batch_stats(state: ProberState, qs: torch.Tensor,
                         taus: torch.Tensor, cfg: ProberConfig,
                         rks: torch.Tensor | None = None,
                         generator: torch.Generator | None = None):
    """:func:`estimate_batch` plus probe provenance: ``(ests (Q,), probed_k
    (Q, L), nvisited (Q,))``; the estimates equal :func:`estimate_batch`'s
    for the same round keys."""
    with span("estimator.estimate_batch"):
        rks = _round_keys(state, qs.shape[0], rks, generator)
        return prober.estimate_batch(state.index, state.x, qs, taus, cfg,
                                     rks, with_stats=True,
                                     **_pq_args(state, qs, cfg))


def estimate(state: ProberState, q: torch.Tensor, tau, cfg: ProberConfig,
             rks: torch.Tensor | None = None,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """One query ``q`` (d,) and radius ``tau``; ``rks`` is (L, 6)."""
    with span("estimator.estimate_batch"):
        if rks is None:
            rks = _round_keys(state, 1, None, generator)[0]
        q = q.to(state.x.device)
        return prober.estimate(state.index, state.x, q, tau, cfg, rks,
                               **_pq_args(state, q[None], cfg))


def _grow(state: ProberState, new_capacity: int) -> ProberState:
    """Capacity growth: re-pad every per-point array and rebuild the
    untrimmed bucket layout at the new capacity."""
    with span("estimator.grow"):
        cap = state.x.shape[0]
        x = torch.nn.functional.pad(state.x, (0, 0, 0, new_capacity - cap))
        index = lsh.grow_capacity(state.index, new_capacity)
        pq = None if state.pq is None else pqmod.grow(state.pq, new_capacity)
        return ProberState(index=index, x=x, pq=pq, epochs=state.epochs)


def update(state: ProberState, x_new: torch.Tensor, cfg: ProberConfig,
           n_valid: int | None = None) -> ProberState:
    """§5 data update: Alg. 7 for the LSH index and, on the PQ path, Alg. 8
    for the PQ index. In capacity, every shape is kept; otherwise capacity
    doubles first. ``n_valid`` is an optional host-side hint of the live
    count, which saves reading it from the device. Attached epochs count
    the points and, when Alg. 7 moved W, a new params generation."""
    with span("estimator.update"):
        nn = x_new.shape[0]
        nv = int(state.index.n_valid.item()) if n_valid is None \
            else int(n_valid)
        cap = state.x.shape[0]
        if nv + nn > cap:
            state = _grow(state, updates.next_capacity(cap, nv + nn))
        x_pad, n_new = updates._pad_batch(x_new.to(state.x.device))
        return _ingest_core(state, x_pad, n_new, cfg, nv)


def _ingest_core(state: ProberState, x_pad: torch.Tensor, n_new: int,
                 cfg: ProberConfig, nv: int, group=None) -> ProberState:
    """One fixed-shape §5 update, the body of :func:`update` and of
    ``distributed.update_sharded``: write the first ``n_new`` rows of the
    padded batch ``x_pad`` after the ``nv`` live ones, run Alg. 7 (with
    W pooled over the process ``group`` of a sharded index) and, on the PQ
    path, Alg. 8; bump attached epochs. The state must have room."""
    x = updates._write_rows(state.x, x_pad, nv, n_new)
    index = updates._lsh_ingest(state.index, x_pad, n_new, cfg, nv,
                                group=group)
    pq = None if state.pq is None else \
        updates._pq_ingest(state.pq, x, x_pad, n_new, nv)
    ep = None if state.epochs is None else updates._epoch_ingest(
        state.epochs, index, state.index.params.w, n_new)
    return ProberState(index=index, x=x, pq=pq, epochs=ep)


def true_cardinality(x: torch.Tensor, q: torch.Tensor, tau,
                     n_valid: int | None = None) -> torch.Tensor:
    """Exact ground truth |{p : ||p - q|| <= tau}| through the ``l2dist``
    kernel. ``q`` (d,) with a scalar ``tau`` gives a scalar; ``q`` (Q, d)
    with ``tau`` (Q,) gives (Q,). Rows ``>= n_valid`` are padding."""
    if n_valid is not None:
        x = x[:n_valid]
    qq = q.reshape(-1, q.shape[-1]).to(x.device, torch.float32).contiguous()
    tau = torch.as_tensor(tau, dtype=torch.float32,
                          device=x.device).reshape(-1)
    d2 = ops.l2dist(x.contiguous(), qq)                       # (N, Q)
    counts = (d2 <= (tau * tau)[None, :]).sum(0, dtype=torch.int32)
    return counts.reshape(q.shape[:-1])
