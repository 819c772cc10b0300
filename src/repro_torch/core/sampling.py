"""Progressive-sampling confidence bounds (paper §4.5 + Appendix 8.2).

With ``w`` samples, ``w'`` of which qualify, ``p_hat = w'/w`` and, with
``a = ln(1/delta)``,

    mu_upper = (sqrt(p_hat + a/2w) + sqrt(a/2w))^2
    mu_lower = max{0, (sqrt(p_hat + 2a/9w) - sqrt(a/2w))^2 - a/18w}

Stopping conditions (paper eqns (1)/(2)):
  (1) stop sampling this ring : mu_upper - p_hat <= eps  AND  p_hat - mu_lower <= eps
  (2) stop probing entirely   : mu_upper < eps

float32 throughout, in the reference's order of operations. A Python-float
numerator is turned into a float32 tensor first: ``float / tensor`` in torch
multiplies by the reciprocal, which rounds differently from a division.
"""
from __future__ import annotations

import torch


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def mu_upper(p_hat, w, a: float):
    w = torch.clamp_min(w, 1e-9)
    t = _f32(a, w) / (2.0 * w)
    s = torch.sqrt(p_hat + t) + torch.sqrt(t)
    return s * s


def mu_lower(p_hat, w, a: float):
    w = torch.clamp_min(w, 1e-9)
    t = _f32(a, w) / (2.0 * w)
    inner = torch.sqrt(p_hat + _f32(2.0 * a, w) / (9.0 * w)) - torch.sqrt(t)
    return torch.clamp_min(inner * inner - _f32(a, w) / (18.0 * w), 0.0)


def stop_sampling(p_hat, w, a: float, eps: float):
    """Condition (1): the CI around p_hat is within eps on both sides."""
    return ((mu_upper(p_hat, w, a) - p_hat) <= eps) & \
           ((p_hat - mu_lower(p_hat, w, a)) <= eps)


def stop_probing(p_hat, w, a: float, eps: float):
    """Condition (2): even the upper bound of the selectivity is below eps."""
    return mu_upper(p_hat, w, a) < eps
