"""Baselines the paper compares against (§3/§6); port of
``repro/core/baselines.py``, its full-ADC-scan baseline so far."""
from __future__ import annotations

import torch

from repro_torch.core import pq as pqmod
from repro_torch.kernels import ops


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
