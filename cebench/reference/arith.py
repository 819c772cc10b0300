"""float32 arithmetic in the orders that the port's kernels use, in plain torch.

The comparison that decides ``correct`` is exact: the reference has to reach
the same float32 values as the program, so that a decision such as
``d^2 <= tau^2`` or ``floor(v / w)`` can never fall on the other side of its
boundary by rounding alone. Where the program sums in a fixed order, the
reference sums in that order here:

* a dot product or squared distance accumulated by ``fmaf`` is emulated in
  float64: the product of two float32 values is exact there, and the sum is
  rounded once more to float32 (a second rounding can differ from one fused
  rounding only where the float64 sum lies exactly halfway between two
  float32 values, about one operation in 2^29);
* a warp's ``__shfl_xor`` butterfly over 32 partial sums is the same
  sequence of float32 additions;
* an ADC sum adds the LUT entries of subspaces 0..M-1 in order.

Nothing here imports the program.
"""
from __future__ import annotations

import torch

WARP = 32


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``fmaf(a, b, c)``, emulated in float64."""
    return (a.double() * b.double() + c.double()).float()


def dot_sequential(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``x`` (Q, d) against the columns of ``a`` (d, F): each entry is
    ``s = fmaf(x[j], a[j], s)`` over j = 0..d-1 from 0 (the query hash of
    the ``query_lanes`` kernel)."""
    s = torch.zeros((x.shape[0], a.shape[1]), dtype=torch.float32,
                    device=x.device)
    for j in range(x.shape[1]):
        s = fma(x[:, j, None], a[j][None, :], s)
    return s


def sq_dist_warp(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Squared distances of ``rows`` (..., d) to ``q`` (..., d), d a multiple
    of 4, as a warp of the exact route computes them: lane l takes float4
    j = l, l + 32, ... in turn, adds ``fmaf(e, e, acc)`` for its four
    components e = row - q in order, and the 32 partial sums meet in the
    butterfly ``acc += shfl_xor(acc, o)`` for o = 16, 8, 4, 2, 1."""
    d = rows.shape[-1]
    if d % 4:
        raise ValueError(f"the float4 route needs d % 4 == 0, got d={d}")
    n4 = d // 4
    its = -(-n4 // WARP)
    e = rows - q                                       # float32, as the kernel
    pad = its * WARP * 4 - d
    if pad:
        e = torch.nn.functional.pad(e, (0, pad))       # fmaf(0, 0, acc) = acc
    e = e.reshape(*e.shape[:-1], its, WARP, 4)
    acc = torch.zeros(e.shape[:-3] + (WARP,), dtype=torch.float32,
                      device=rows.device)
    for it in range(its):
        for c in range(4):
            v = e[..., it, :, c]
            acc = fma(v, v, acc)
    lane = torch.arange(WARP, device=rows.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lane ^ o]
    return acc[..., 0]


def adc_in_order(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``sum_m lut[..., m, codes[..., m]]`` added for m = 0..M-1 in order.
    ``lut`` (..., M, Kc) float32 and ``codes`` (..., c, M) integer, with the
    leading dims of ``lut`` broadcast against those of ``codes`` without its
    candidate axis: → (..., c)."""
    m = lut.shape[-2]
    acc = torch.zeros(codes.shape[:-1], dtype=torch.float32,
                      device=codes.device)
    for j in range(m):
        acc = acc + lut[..., j, :].gather(-1, codes[..., j].long())
    return acc
