"""Product quantization with asymmetric distance computation (paper
§2.2/§4.6, Alg. 4/5; port of ``repro/core/pq.py``).

A vector is split into ``M`` subvectors of dimension ``ds = d/M``; each
subspace is k-means-clustered into ``Kc`` centroids; a point is stored as
its (M,) uint8 codeword. ADC: per query a lookup table ``T[m, c] = ||q_m -
centroid[m, c]||²`` is built once, and every point's squared distance is
``Σ_m T[m, code[p, m]]`` (compared with τ², never square-rooted).

Differences from the reference, none of which changes a result:

* :func:`assign` works through the points in chunks, so the (N, M, Kc)
  distance temporary stays small (the reference materialises it whole:
  8 GiB at N = 1M, M = 32, Kc = 64). Per-row argmin is unchanged, and
  ``torch.argmin`` returns the first minimum as ``jnp.argmin`` does.
* :func:`segment_sum` is a sorted segment reduction, deterministic on the
  card (``index_add_`` on float CUDA tensors is atomic and varies from run
  to run).
* :func:`fit` draws its initial rows from a ``torch.Generator`` or takes
  them injected (``init_rows=``), which is how the parity tests replay the
  reference's ``jax.random.choice``.
* :func:`adc_table` and :func:`quantize_lut` take a batch of queries, so a
  batch's LUT stack is built in one pass.

Codes are uint8, and a uint8 index tensor is taken by torch as a boolean
mask: every gather by code casts to int64 first.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.config import ProberConfig

_ASSIGN_CHUNK = 1 << 25     # elements of the (rows, M, Kc) distance block


class PQIndex(NamedTuple):
    centroids: torch.Tensor     # (M, Kc, ds) float32
    codes: torch.Tensor         # (C, M) uint8; rows >= n_valid pad
    counts: torch.Tensor        # (M, Kc) float32, for Alg. 8 running means
    resid: torch.Tensor         # (C,) float32 ||x - q(x)||
    n_valid: torch.Tensor       # () int32 live points
    packed: Optional[torch.Tensor] = None
                                # (C, M/2) uint8, two 4-bit codes per byte
                                # (cfg.pq_pack4, Kc <= 16); None otherwise

    @property
    def m(self) -> int:
        return self.centroids.shape[0]

    @property
    def kc(self) -> int:
        return self.centroids.shape[1]

    @property
    def capacity(self) -> int:
        return self.codes.shape[0]


def split_subspaces(x: torch.Tensor, m: int) -> torch.Tensor:
    """(N, d) → (N, M, ds)."""
    n, d = x.shape
    if d % m:
        raise ValueError(f"M={m} must divide d={d}")
    return x.reshape(n, m, d // m)


def assign(centroids: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Nearest centroid per subspace: xs (N, M, ds) → (N, M) int64, by
    ``|x|² − 2x·c + |c|²`` as the reference computes it."""
    n, m, _ = xs.shape
    kc = centroids.shape[1]
    c2 = (centroids ** 2).sum(-1)                            # (M, Kc)
    out = torch.empty((n, m), dtype=torch.int64, device=xs.device)
    step = max(1, _ASSIGN_CHUNK // (m * kc))
    for s in range(0, n, step):
        blk = xs[s:s + step]
        x2 = (blk ** 2).sum(-1, keepdim=True)                # (n, M, 1)
        xc = torch.einsum("nms,mks->nmk", blk, centroids)    # (n, M, Kc)
        out[s:s + step] = torch.argmin(x2 - 2.0 * xc + c2[None], dim=-1)
    return out


def segment_sum(data: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` as a sorted segment reduction: a stable sort
    of ``seg``, then ``torch.segment_reduce`` over the runs. Deterministic
    on every device; empty segments sum to 0."""
    order = torch.argsort(seg, stable=True)
    lengths = torch.bincount(seg, minlength=num_segments)
    return torch.segment_reduce(data[order], "sum", lengths=lengths, axis=0)


def _segments(codes: torch.Tensor, kc: int) -> torch.Tensor:
    """Flat segment ids ``code + m·Kc`` of (N, M) codes."""
    m = codes.shape[1]
    return (codes + (torch.arange(m, device=codes.device) * kc)[None]
            ).reshape(-1)


def draw_init_rows(generator: torch.Generator, n: int, kc: int,
                   device) -> torch.Tensor:
    """Initial k-means rows: ``kc`` distinct rows, or with replacement when
    ``n < kc`` (the reference's ``jax.random.choice`` rule)."""
    g = generator
    if n < kc:
        rows = torch.randint(0, n, (kc,), generator=g, device=g.device)
    else:
        rows = torch.randperm(n, generator=g, device=g.device)[:kc]
    return rows.to(device)


def fit(x: torch.Tensor, cfg: ProberConfig,
        generator: torch.Generator | None = None,
        init_rows: torch.Tensor | None = None) -> PQIndex:
    """Lloyd's k-means per subspace, all M subspaces at once. The initial
    centroids are the rows ``init_rows`` (Kc,) of ``x``, drawn from
    ``generator`` when not given."""
    m, kc = cfg.pq_m, cfg.pq_kc
    if kc > 256:
        raise ValueError(f"Kc={kc} must fit a uint8 code")
    xs = split_subspaces(x.float(), m)                       # (N, M, ds)
    n, _, ds = xs.shape
    if init_rows is None:
        if generator is None:
            raise ValueError("pass init_rows= or generator=")
        init_rows = draw_init_rows(generator, n, kc, x.device)
    centroids = xs[init_rows.to(x.device).long()].transpose(0, 1) \
        .contiguous()                                        # (M, Kc, ds)
    flat = xs.reshape(n * m, ds)
    ones = torch.ones(n * m, dtype=torch.float32, device=x.device)
    for _ in range(cfg.pq_iters):
        seg = _segments(assign(centroids, xs), kc)
        sums = segment_sum(flat, seg, m * kc).reshape(m, kc, ds)
        cnts = segment_sum(ones, seg, m * kc).reshape(m, kc, 1)
        centroids = torch.where(cnts > 0, sums / cnts.clamp_min(1.0),
                                centroids)
    codes = assign(centroids, xs)
    counts = segment_sum(ones, _segments(codes, kc), m * kc).reshape(m, kc)
    resid = reconstruction_residual(centroids, codes, xs)
    codes8 = codes.to(torch.uint8)
    packed = None
    if cfg.pq_pack4:
        if kc > 16 or m % 2:
            raise ValueError(f"pq_pack4 needs Kc<=16 and even M, got "
                             f"Kc={kc}, M={m}")
        packed = pack_codes(codes8)
    return PQIndex(centroids=centroids, codes=codes8, counts=counts,
                   resid=resid,
                   n_valid=torch.tensor(n, dtype=torch.int32,
                                        device=x.device),
                   packed=packed)


def grow(pq: PQIndex, new_capacity: int) -> PQIndex:
    """Re-pad codes, residuals and the packed mirror with zero rows (never
    read: candidate ids come from live buckets, and the scan baseline masks
    by ``n_valid``)."""
    pad = new_capacity - pq.codes.shape[0]
    if pad < 0:
        raise ValueError(f"capacity {new_capacity} < {pq.codes.shape[0]}")

    def rows(t):
        return None if t is None else torch.nn.functional.pad(
            t, (0, 0) * (t.dim() - 1) + (0, pad))
    return pq._replace(codes=rows(pq.codes), resid=rows(pq.resid),
                       packed=rows(pq.packed))


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """(..., M) codes < 16 → (..., M/2) uint8: byte j holds code 2j in its
    low nibble and code 2j+1 in its high nibble."""
    c = codes.to(torch.uint8)
    return c[..., 0::2] | (c[..., 1::2] << 4)


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_codes`: (..., M/2) uint8 → (..., M) int32."""
    lo = (packed & 0xF).to(torch.int32)
    hi = (packed >> 4).to(torch.int32)
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1],
                                                 2 * packed.shape[-1])


def reconstruction_residual(centroids: torch.Tensor, codes: torch.Tensor,
                            xs: torch.Tensor) -> torch.Tensor:
    """||x − q(x)|| per point: codes (N, M) (any integer type), xs (N, M,
    ds) → (N,) float32."""
    m = centroids.shape[0]
    recon = centroids[torch.arange(m, device=xs.device)[None],
                      codes.long()]                          # (N, M, ds)
    return torch.sqrt(((xs - recon) ** 2).sum((-1, -2)))


def adc_table(pq: PQIndex, q: torch.Tensor) -> torch.Tensor:
    """Alg. 4: LUT ``T[m, c] = ||q_m − centroid[m, c]||²``. ``q`` (d,) gives
    (M, Kc); a batch (Q, d) gives the stack (Q, M, Kc)."""
    qs = q.reshape(*q.shape[:-1], pq.m, -1)                  # (..., M, ds)
    diff = qs[..., :, None, :] - pq.centroids                # (..., M, Kc, ds)
    return (diff ** 2).sum(-1)


class QuantLUT(NamedTuple):
    """Affine uint8 ADC LUT: entry (m, c) stands for ``offset + scale ·
    q8[m, c]``, one (scale, offset) per query. Batched, ``q8`` is (Q, M,
    Kc) and ``scale``/``offset`` (Q,)."""
    q8: torch.Tensor
    scale: torch.Tensor
    offset: torch.Tensor


def quantize_lut(lut: torch.Tensor) -> QuantLUT:
    """Affine uint8 quantization of (M, Kc) LUTs, each over its own range:
    ``scale = (max − min)/255``, round half to even (``torch.round``, as
    ``jnp.round``). A leading batch axis quantizes each query on its own."""
    flat = lut.reshape(*lut.shape[:-2], -1)
    lo = flat.amin(-1)
    scale = ((flat.amax(-1) - lo) / 255.0).clamp_min(1e-20)
    q = torch.round((lut - lo[..., None, None]) / scale[..., None, None])
    return QuantLUT(q8=q.clamp(0.0, 255.0).to(torch.uint8), scale=scale,
                    offset=lo)


def quantized_threshold(qlut: QuantLUT, m: int,
                        tau_sq: torch.Tensor) -> torch.Tensor:
    """Integer threshold of the quantized test: ``S <= floor((τ² −
    M·offset)/scale)`` is exact with respect to the dequantized distances
    (see the reference for the band within which it may differ from float
    ADC). Shapes broadcast: (Q,) LUTs with (Q,) radii give (Q,) int32."""
    u = (tau_sq - m * qlut.offset) / qlut.scale
    return torch.floor(u).clamp(-1.0, 255.0 * m + 1.0).to(torch.int32)


def build_query_lut(pq: PQIndex, q: torch.Tensor, cfg: ProberConfig):
    """LUT(s) in the datapath the config asks for: float32 (Alg. 4), or a
    :class:`QuantLUT` when ``cfg.pq_int8_lut`` (banded qualification needs
    float distances, so it keeps the float LUT)."""
    lut = adc_table(pq, q)
    if cfg.pq_int8_lut and not cfg.pq_banded:
        return quantize_lut(lut)
    return lut


def adc_distance(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Alg. 5: Σ_m lut[m, codes[..., m]] for codes (..., M) → (...)."""
    m = lut.shape[0]
    return lut[torch.arange(m, device=lut.device), codes.long()].sum(-1)


# ---- where two devices or frameworks may legitimately decide differently --
#
# Float sums in two summation orders may differ in the last bit. The parity
# tests and ``chip_smoke.py`` compare decisions only outside these ties,
# computed here in float64 so that both read one rule.


def assign_ties(centroids: torch.Tensor, xs: torch.Tensor,
                margin: float) -> torch.Tensor:
    """(N, M) bool: points whose two nearest centroids of subspace m lie
    within ``margin`` (relative) of each other. centroids (M, Kc, ds), xs
    (N, M, ds)."""
    c, x = centroids.double(), xs.double()
    out = []
    for j in range(c.shape[0]):
        d2 = ((x[:, j, None, :] - c[j][None]) ** 2).sum(-1)  # (N, Kc)
        top2 = d2.topk(2, dim=-1, largest=False).values
        out.append(top2[:, 1] - top2[:, 0]
                   <= margin * top2[:, 1].clamp_min(1e-6))
    return torch.stack(out, dim=1)


def adc_ties(luts: torch.Tensor, codes: torch.Tensor, taus: torch.Tensor,
             margin: float) -> torch.Tensor:
    """(Q,) bool: queries for which some row's ADC distance lies within
    ``margin``·τ² of τ². luts (Q, M, Kc), codes (N, M) byte codes of the
    live rows, taus (Q,)."""
    sub = torch.arange(luts.shape[1], device=codes.device)[None]
    c = codes.long()
    t2 = taus.double() ** 2
    return torch.stack([((lut[sub, c].sum(-1) - t).abs() <= margin * t).any()
                        for lut, t in zip(luts.double(), t2)])


def q8_ties(luts: torch.Tensor, taus: torch.Tensor, m: int) -> torch.Tensor:
    """(Q,) bool: queries whose uint8 LUT or threshold may change with the
    last bit of the float LUT: an entry's ``(lut − lo)/scale`` within 1e-4
    of a half-integer, or ``(τ² − M·lo)/scale`` within 1e-4 of an
    integer."""
    lut = luts.double()
    lo = lut.amin((1, 2))
    scale = (lut.amax((1, 2)) - lo) / 255.0
    v = (lut - lo[:, None, None]) / scale[:, None, None]
    half = ((v - v.floor() - 0.5).abs() < 1e-4).flatten(1).any(1)
    u = (taus.double() ** 2 - m * lo) / scale
    return half | ((u - u.round()).abs() < 1e-4)
