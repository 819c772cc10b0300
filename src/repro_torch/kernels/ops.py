"""Device-dispatching wrappers over the CUDA kernels in ``csrc/``.

A tensor on the CPU goes to the plain version in :mod:`ref`; a tensor on a
CUDA device goes to the hand-written kernel, or the call raises. There is no
fallback. Each wrapper checks device, dtype, shape and contiguity, allocates
its output with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch reported an error, and adds one to its
count in :data:`LAUNCHES` — there and nowhere else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

LAUNCHES: dict[str, int] = {"lsh_hash": 0, "hamming_to_buckets": 0,
                            "l2dist": 0, "l2dist_rows": 0, "adc_rows": 0,
                            "adc_rows_q8": 0, "adc_batch": 0,
                            "adc_batch_q8": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(*ts: torch.Tensor) -> bool:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(name: str, fn, *args) -> None:
    from repro_torch.kernels import build
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(build.load().lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def lsh_hash(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """x (N, d), a (d, F), b (F,), w (F,) float32 → codes (N, F) int32,
    ``floor((x @ a + b*w) / w)``."""
    if _on_cpu(x, a, b, w):
        return ref.lsh_hash(x, a, b, w)
    for t, nm, nd in ((x, "x", 2), (a, "a", 2), (b, "b", 1), (w, "w", 1)):
        _check(t, nm, torch.float32, nd)
    n, d = x.shape
    f = a.shape[1]
    if a.shape[0] != d or b.shape[0] != f or w.shape[0] != f:
        raise ValueError(f"shapes x{tuple(x.shape)} a{tuple(a.shape)} "
                         f"b{tuple(b.shape)} w{tuple(w.shape)}")
    if not 0 < f <= 1024:
        raise ValueError(f"lsh_hash takes 1..1024 functions, got {f}")
    if (d * f + 64 * 64) * 4 > 227 * 1024:
        raise ValueError(f"a ({d}, {f}) does not fit shared memory")
    out = torch.empty((n, f), dtype=torch.int32, device=x.device)
    if n:
        _launch("lsh_hash", "lsh_hash_f32", x.data_ptr(), a.data_ptr(),
                b.data_ptr(), w.data_ptr(), out.data_ptr(), n, d, f)
    return out


def hamming_to_buckets(bucket_codes: torch.Tensor, qcodes: torch.Tensor,
                       n_buckets: torch.Tensor) -> torch.Tensor:
    """bucket_codes (L, B, K), qcodes (Q, L, K), n_buckets (L,) int32 →
    (Q, L, B) int32 Hamming distances; rows ``b >= n_buckets[l]`` get K+1."""
    if _on_cpu(bucket_codes, qcodes, n_buckets):
        return ref.hamming_to_buckets(bucket_codes, qcodes, n_buckets)
    _check(bucket_codes, "bucket_codes", torch.int32, 3)
    _check(qcodes, "qcodes", torch.int32, 3)
    _check(n_buckets, "n_buckets", torch.int32, 1)
    nl, nb, k = bucket_codes.shape
    nq = qcodes.shape[0]
    if qcodes.shape[1:] != (nl, k) or n_buckets.shape[0] != nl:
        raise ValueError(f"shapes bucket_codes{tuple(bucket_codes.shape)} "
                         f"qcodes{tuple(qcodes.shape)} "
                         f"n_buckets{tuple(n_buckets.shape)}")
    if not 0 < k <= 32:
        raise ValueError(f"hamming_to_buckets takes 1..32 functions, got {k}")
    if nq * k * 4 > 200 * 1024:
        raise ValueError(f"{nq} query codes of {k} do not fit shared memory")
    out = torch.empty((nq, nl, nb), dtype=torch.int32,
                      device=bucket_codes.device)
    if nq and nl and nb:
        _launch("hamming_to_buckets", "hamming_to_buckets_i32",
                bucket_codes.data_ptr(), qcodes.data_ptr(),
                n_buckets.data_ptr(), out.data_ptr(), nq, nl, nb, k)
    return out


def hamming(bucket_codes: torch.Tensor, qcode: torch.Tensor) -> torch.Tensor:
    """The reference kernel's own form: (B, K), (K,) → (B,) mismatch
    counts. It is the Q = L = 1 case of :func:`hamming_to_buckets` with
    every row valid."""
    nb = torch.tensor([bucket_codes.shape[0]], dtype=torch.int32,
                      device=bucket_codes.device)
    return hamming_to_buckets(bucket_codes[None].contiguous(),
                              qcode[None, None].contiguous(), nb)[0, 0]


def l2dist(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """x (N, d), q (Q, d) float32 → (N, Q) squared distances Σ(x−q)²."""
    if _on_cpu(x, q):
        return ref.l2dist(x, q)
    _check(x, "x", torch.float32, 2)
    _check(q, "q", torch.float32, 2)
    n, d = x.shape
    nq = q.shape[0]
    if q.shape[1] != d:
        raise ValueError(f"shapes x{tuple(x.shape)} q{tuple(q.shape)}")
    out = torch.empty((n, nq), dtype=torch.float32, device=x.device)
    if n and nq:
        _launch("l2dist", "l2dist_f32", x.data_ptr(), q.data_ptr(),
                out.data_ptr(), n, nq, d)
    return out


def l2dist_rows(x: torch.Tensor, ids: torch.Tensor,
                qs: torch.Tensor) -> torch.Tensor:
    """x (C, d) float32, ids (R, c) int32, qs (R, d) float32 → (R, c)
    squared distances of the gathered rows ``x[ids[r]]`` to ``qs[r]``; the
    gather is fused, so the rows never pass through device memory. Every id
    must lie in [0, C)."""
    if _on_cpu(x, ids, qs):
        return ref.l2dist_rows(x, ids, qs)
    _check(x, "x", torch.float32, 2)
    _check(ids, "ids", torch.int32, 2)
    _check(qs, "qs", torch.float32, 2)
    nr, c = ids.shape
    d = x.shape[1]
    if qs.shape != (nr, d):
        raise ValueError(f"shapes x{tuple(x.shape)} ids{tuple(ids.shape)} "
                         f"qs{tuple(qs.shape)}")
    out = torch.empty((nr, c), dtype=torch.float32, device=x.device)
    vec = int(d % 4 == 0 and x.data_ptr() % 16 == 0
              and qs.data_ptr() % 16 == 0)
    if nr and c:
        _launch("l2dist_rows", "l2dist_rows_f32", x.data_ptr(),
                ids.data_ptr(), qs.data_ptr(), out.data_ptr(), nr, c, d, vec)
    return out


# ---- ADC (Alg. 5) --------------------------------------------------------

# code row bytes the kernels hold in registers; with Kc <= 256 this bounds
# one LUT by 64 x 256 x 4 bytes = 64 KB, which fits a block's shared memory
_MAX_CODE_BYTES = 64


def _adc_layout(codes: torch.Tensor, luts: torch.Tensor,
                lut_dtype: torch.dtype) -> tuple[int, int, int, int, int]:
    """Checks of the ADC kernels' inputs; returns (m, kc, code bytes,
    packed, alignment of the code rows)."""
    _check(codes, "codes", torch.uint8, 2)
    _check(luts, "luts", lut_dtype, 3)
    _, m, kc = luts.shape
    cb = codes.shape[1]
    packed = cb != m
    if packed and (2 * cb != m or kc > 16):
        raise ValueError(f"codes of width {cb} fit neither M={m} byte codes "
                         f"nor M/2 packed 4-bit codes (Kc={kc} <= 16)")
    if not 0 < kc <= 256 or not 0 < cb <= _MAX_CODE_BYTES:
        raise ValueError(f"ADC kernels take Kc in 1..256 and code rows of "
                         f"1..{_MAX_CODE_BYTES} bytes, got Kc={kc}, {cb}")
    ptr = codes.data_ptr()
    align = 16 if cb % 16 == 0 and ptr % 16 == 0 else \
        4 if cb % 4 == 0 and ptr % 4 == 0 else 1
    return m, kc, cb, int(packed), align


def _adc_rows(name: str, fn: str, lut_dtype, out_dtype, codes, ids, luts,
              lane_q):
    m, kc, cb, packed, align = _adc_layout(codes, luts, lut_dtype)
    _check(ids, "ids", torch.int32, 2)
    _check(lane_q, "lane_q", torch.int32, 1)
    nr, c = ids.shape
    if lane_q.shape[0] != nr:
        raise ValueError(f"lane_q{tuple(lane_q.shape)} for ids"
                         f"{tuple(ids.shape)}")
    out = torch.empty((nr, c), dtype=out_dtype, device=codes.device)
    if nr and c:
        _launch(name, fn, codes.data_ptr(), ids.data_ptr(), luts.data_ptr(),
                lane_q.data_ptr(), out.data_ptr(), nr, c, cb, m, kc, packed,
                align)
    return out


def adc_rows(codes: torch.Tensor, ids: torch.Tensor, luts: torch.Tensor,
             lane_q: torch.Tensor) -> torch.Tensor:
    """codes (C, M) uint8, or (C, M/2) packed 4-bit codes; ids (R, c)
    int32; luts (Q, M, Kc) float32; lane_q (R,) int32 → (R, c) float32:
    row r, candidate i is Σ_m luts[lane_q[r], m, codes[ids[r, i], m]]. The
    gather is fused. Every id must lie in [0, C), every lane_q in [0, Q)
    and every code below Kc."""
    if _on_cpu(codes, ids, luts, lane_q):
        return ref.adc_rows(codes, ids, luts, lane_q)
    return _adc_rows("adc_rows", "adc_rows_f32", torch.float32,
                     torch.float32, codes, ids, luts, lane_q)


def adc_rows_q8(codes: torch.Tensor, ids: torch.Tensor, qluts: torch.Tensor,
                lane_q: torch.Tensor) -> torch.Tensor:
    """:func:`adc_rows` of uint8 LUTs (Q, M, Kc) → (R, c) int32 sums."""
    if _on_cpu(codes, ids, qluts, lane_q):
        return ref.adc_rows_q8(codes, ids, qluts, lane_q)
    return _adc_rows("adc_rows_q8", "adc_rows_u8", torch.uint8, torch.int32,
                     codes, ids, qluts, lane_q)


def _adc_batch(name: str, fn: str, lut_dtype, out_dtype, codes, luts):
    m, kc, cb, packed, align = _adc_layout(codes, luts, lut_dtype)
    n, nq = codes.shape[0], luts.shape[0]
    out = torch.empty((nq, n), dtype=out_dtype, device=codes.device)
    if n and nq:
        _launch(name, fn, codes.data_ptr(), luts.data_ptr(), out.data_ptr(),
                n, nq, cb, m, kc, packed, align)
    return out


def adc_batch(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """codes (N, M) uint8, or (N, M/2) packed 4-bit codes; luts (Q, M, Kc)
    float32 → (Q, N) float32 ADC distances, one pass over the codes for
    all Q queries. Every code must lie below Kc."""
    if _on_cpu(codes, luts):
        return ref.adc_batch(codes, luts)
    return _adc_batch("adc_batch", "adc_batch_f32", torch.float32,
                      torch.float32, codes, luts)


def adc_batch_q8(codes: torch.Tensor, qluts: torch.Tensor) -> torch.Tensor:
    """:func:`adc_batch` of uint8 LUTs (Q, M, Kc) → (Q, N) int32 sums."""
    if _on_cpu(codes, qluts):
        return ref.adc_batch_q8(codes, qluts)
    return _adc_batch("adc_batch_q8", "adc_batch_u8", torch.uint8,
                      torch.int32, codes, qluts)


def _byte_codes(codes: torch.Tensor) -> torch.Tensor:
    """The reference forms take codes of any integer type below 256."""
    if codes.dtype != torch.uint8:
        if codes.numel() and (int(codes.min()) < 0 or int(codes.max()) > 255):
            raise ValueError("codes must lie in [0, 256)")
        codes = codes.to(torch.uint8)
    return codes.contiguous()


def adc(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """The reference kernel's own form: codes (N, M) integers below 256,
    lut (M, Kc) float32 → (N,). The Q = 1 call of :func:`adc_batch`."""
    return adc_batch(_byte_codes(codes), lut[None].contiguous())[0]


def adc_q8(codes: torch.Tensor, qlut: torch.Tensor) -> torch.Tensor:
    """codes (N, M), qlut (M, Kc) uint8 → (N,) int32: the Q = 1 call of
    :func:`adc_batch_q8`."""
    return adc_batch_q8(_byte_codes(codes), qlut[None].contiguous())[0]
