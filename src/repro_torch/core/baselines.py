"""Baselines the paper compares against (§3/§6); port of
``repro/core/baselines.py``.

* :func:`sampling_estimate` — uniform sampling (the paper's "Sampling 1%").
* :func:`adc_scan_estimate_batch` — the full-ADC scan, the exact count
  under quantisation.
* :class:`MLPEstimator` — a reference-object learned estimator in the
  spirit of MRCE/SimCard: features are distances from the query to R
  reference objects (k-means centroids) plus τ; a small MLP regresses
  log-cardinality. It needs labelled training data and an offline phase,
  and degrades under large data updates (the paper's Table 5).

Draws come from a ``torch.Generator`` and are not bit-equal to the
reference's ``jax.random``; :func:`sampling_from_draws` takes drawn ids (or
uniforms) directly, which is how the parity tests replay the reference's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import pq as pqmod
from repro_torch.core.config import ProberConfig
from repro_torch.kernels import ops

# rows of the (rows, N) uniform draw behind one top-k in draw_sample_ids
_DRAW_ROWS = 64


def draw_sample_ids(generator: torch.Generator, n: int, nq: int,
                    n_samples: int) -> torch.Tensor:
    """(nq, n_samples) int32: for each row, ``n_samples`` distinct ids drawn
    uniformly from [0, n) (the law of ``jax.random.choice(replace=False)``).
    Rows are drawn in chunks as the top-k of a (chunk, n) uniform draw, so
    no per-row permutation is built. On the card the top-k returns each
    row's ids nearly in ascending order, the order in which
    ``ops.l2dist_rows`` reads a row that several rows of draws share from
    L2 (``chip_smoke.py`` B1 measures both); so no sort follows, which
    would cost more than it saves. An estimate does not depend on the
    order of a row's draws."""
    if not 0 < n_samples <= n:
        raise ValueError(f"cannot draw {n_samples} distinct ids from {n}")
    g = generator
    out = torch.empty((nq, n_samples), dtype=torch.int32, device=g.device)
    for r in range(0, nq, _DRAW_ROWS):
        rows = min(_DRAW_ROWS, nq - r)
        u = torch.rand((rows, n), generator=g, device=g.device)
        out[r:r + rows] = u.topk(n_samples, dim=1, sorted=False).indices
    return out


def sampling_from_draws(x: torch.Tensor, qs: torch.Tensor,
                        taus: torch.Tensor, ids: torch.Tensor | None = None,
                        u: torch.Tensor | None = None,
                        n_valid=None) -> torch.Tensor:
    """The sampling estimate from given draws: ``qs`` (Q, d), ``taus`` (Q,)
    → (Q,) float32. Without ``n_valid``, ``ids`` (Q, S) are the drawn rows
    and the scale is N; with it, ``u`` (Q, S) are float32 uniforms, the rows
    ``min(int32(u · n_valid), n_valid − 1)`` and the scale ``n_valid``. The
    distances go through the ``l2dist_rows`` kernel."""
    dev = x.device
    if n_valid is not None:
        nv = torch.as_tensor(n_valid, device=dev).to(torch.int32)
        ids = torch.minimum((u.to(dev) * nv.float()).to(torch.int32), nv - 1)
    ids = ids.to(dev, torch.int32).contiguous()
    d2 = ops.l2dist_rows(x.contiguous(), ids,
                         qs.to(dev, torch.float32).contiguous())
    taus = taus.to(dev, torch.float32)
    hits = (d2 <= (taus * taus)[:, None]).sum(-1, dtype=torch.int32).float()
    # the mean times the scale in float32 as the reference's compiled form
    # takes it: the count times float32(1/S), and with the constant scale N
    # the two constants folded into one
    inv_s = np.float32(1.0) / np.float32(ids.shape[1])
    if n_valid is None:
        return hits * float(inv_s * np.float32(x.shape[0]))
    return hits * float(inv_s) * nv.float()


def sampling_estimate(x: torch.Tensor, q: torch.Tensor, tau,
                      generator: torch.Generator, n_samples: int,
                      n_valid=None) -> torch.Tensor:
    """Uniform-sampling baseline. ``q`` (d,) with a scalar ``tau`` gives a
    scalar; ``q`` (Q, d) with ``tau`` (Q,) draws once per row, as ``vmap``
    of the reference would, and gives (Q,). Draws are without replacement
    over the N rows; ``n_valid`` restricts them to the live prefix of a
    capacity-padded corpus, with replacement (the reference's rule)."""
    qs = q.reshape(-1, q.shape[-1])
    taus = torch.as_tensor(tau, dtype=torch.float32).reshape(-1)
    g = generator
    if n_valid is None:
        ids = draw_sample_ids(g, x.shape[0], qs.shape[0], n_samples)
        est = sampling_from_draws(x, qs, taus, ids=ids)
    else:
        u = torch.rand((qs.shape[0], n_samples), generator=g, device=g.device)
        est = sampling_from_draws(x, qs, taus, u=u, n_valid=n_valid)
    return est.reshape(q.shape[:-1])


def adc_scan_estimate_batch(pq: pqmod.PQIndex, qs: torch.Tensor,
                            taus: torch.Tensor) -> torch.Tensor:
    """Batched full-ADC-scan baseline, the exact count under quantisation:
    one pass over the byte codes serves all Q queries (``adc_batch``), and
    capacity-padding rows are masked by ``n_valid``. ``qs`` (Q, d), ``taus``
    (Q,) → (Q,) float32 counts."""
    dev = pq.codes.device
    luts = pqmod.adc_table(pq, qs.to(dev, torch.float32)).contiguous()
    d2 = ops.adc_batch(pq.codes, luts)                       # (Q, C)
    live = torch.arange(pq.codes.shape[0], device=dev) < pq.n_valid
    taus = taus.to(dev, torch.float32)
    hit = (d2 <= (taus * taus)[:, None]) & live[None]
    return hit.sum(-1, dtype=torch.int32).float()


# ------------------------------------------------------ learned baseline ---

MLP_FIELDS = ("refs", "w1", "b1", "w2", "b2", "w3", "b3")


class MLPEstimator(torch.nn.Module):
    """``refs`` (R, d) is a buffer (data, not trained); ``w1`` (R+2, H),
    ``b1`` (H,), ``w2`` (H, H), ``b2`` (H,), ``w3`` (H, 1), ``b3`` (1,) are
    parameters in the reference's (in, out) layout."""

    def __init__(self, refs, w1, b1, w2, b2, w3, b3):
        super().__init__()
        self.register_buffer("refs", refs)
        for name, t in zip(MLP_FIELDS[1:], (w1, b1, w2, b2, w3, b3)):
            setattr(self, name, torch.nn.Parameter(t))

    def head(self, f: torch.Tensor) -> torch.Tensor:
        """Features (Q, R+2) → (Q,) predicted log1p(cardinality)."""
        h = torch.relu(f @ self.w1 + self.b1)
        h = torch.relu(h @ self.w2 + self.b2)
        return (h @ self.w3 + self.b3)[:, 0]

    def forward(self, qs: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
        return self.head(features(self.refs, qs, taus))


def _scale_of(refs: torch.Tensor) -> torch.Tensor:
    # the typical inter-reference distance (all R² pairs, the diagonal
    # included) normalises the features, so the MLP is invariant to the
    # data's scale
    d = torch.sqrt(((refs[:, None] - refs[None]) ** 2).sum(-1))
    return d.mean() + 1e-6


def features(refs: torch.Tensor, qs: torch.Tensor,
             taus: torch.Tensor) -> torch.Tensor:
    """qs (Q, d), taus (Q,) → (Q, R+2): the distances to the references
    over τ, then τ and log1p(τ), all in units of the reference scale."""
    scale = _scale_of(refs)
    d = torch.sqrt(((refs[None] - qs[:, None]) ** 2).sum(-1)) / scale
    t = (taus / scale)[:, None]
    return torch.cat([d / (t + 1e-3), t, torch.log1p(t)], dim=1)


def mlp_estimate(m: MLPEstimator, q: torch.Tensor, tau) -> torch.Tensor:
    """``expm1(clip(fwd, 0, 20))``: ``q`` (d,) with a scalar ``tau`` gives
    a scalar, ``q`` (Q, d) with ``tau`` (Q,) gives (Q,)."""
    dev = m.refs.device
    qs = q.to(dev, torch.float32).reshape(-1, q.shape[-1])
    taus = torch.as_tensor(tau, dtype=torch.float32, device=dev).reshape(-1)
    with torch.no_grad():
        out = torch.expm1(torch.clamp(m(qs, taus), 0.0, 20.0))
    return out.reshape(q.shape[:-1])


def init_mlp(refs: torch.Tensor, generator: torch.Generator,
             hidden: int = 64) -> MLPEstimator:
    """The reference's initialisation: normal weights scaled by
    1/sqrt(fan-in), zero biases."""
    g, dev = generator, refs.device
    fdim = refs.shape[0] + 2

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=g, device=g.device)
        return (w * (1.0 / math.sqrt(fan_in))).to(dev)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    return MLPEstimator(refs, normal((fdim, hidden), fdim), zeros(hidden),
                        normal((hidden, hidden), hidden), zeros(hidden),
                        normal((hidden, 1), hidden), zeros(1))


def train_mlp(m: MLPEstimator, queries: torch.Tensor, taus: torch.Tensor,
              cards: torch.Tensor, epochs: int = 400,
              lr: float = 3e-3) -> MLPEstimator:
    """Full-batch gradient descent on the squared error in log1p space, in
    place: each epoch one autograd gradient, a global-norm clip
    ``min(1, 10 / (‖g‖ + 1e-9))`` and ``p -= lr · sc · g``. ``queries``
    (Q, d), ``taus`` and ``cards`` (Q, T). Nothing reads the device
    between epochs."""
    dev = m.refs.device
    qf = queries.to(dev, torch.float32).reshape(-1, queries.shape[-1])
    nt = taus.shape[1]
    flat_q = qf.repeat_interleave(nt, dim=0)
    flat_t = taus.to(dev, torch.float32).reshape(-1)
    flat_y = torch.log1p(cards.to(dev).reshape(-1).float())
    f = features(m.refs, flat_q, flat_t)      # the refs are not trained
    params = [getattr(m, k) for k in MLP_FIELDS[1:]]
    for _ in range(epochs):
        loss = ((m.head(f) - flat_y) ** 2).mean()
        grads = torch.autograd.grad(loss, params)
        gn = torch.zeros((), dtype=torch.float32, device=dev)
        for gr in grads:
            gn = gn + (gr * gr).sum()
        sc = torch.clamp(10.0 / (torch.sqrt(gn) + 1e-9), max=1.0)
        with torch.no_grad():
            for p, gr in zip(params, grads):
                p.sub_(lr * sc * gr)
    return m


def refs_config(n_refs: int) -> ProberConfig:
    """The k-means behind the MLP's reference objects: ``pq.fit`` at M = 1,
    Kc = ``n_refs``, 8 Lloyd iterations."""
    return ProberConfig(pq_m=1, pq_kc=n_refs, pq_iters=8)


def fit_mlp(x: torch.Tensor, queries: torch.Tensor, taus: torch.Tensor,
            cards: torch.Tensor, generator: torch.Generator,
            n_refs: int = 16, hidden: int = 64, epochs: int = 400,
            lr: float = 3e-3) -> MLPEstimator:
    """queries (Q, d), taus (Q, T), cards (Q, T) exact labels. The
    references are the k-means centroids of ``x`` from ``pq.fit`` at
    :func:`refs_config` (its ``init_rows=`` replays given initial rows),
    then :func:`init_mlp` and :func:`train_mlp`."""
    refs = pqmod.fit(x, refs_config(n_refs), generator).centroids[0]
    m = init_mlp(refs.contiguous(), generator, hidden)
    return train_mlp(m, queries, taus, cards, epochs, lr)
