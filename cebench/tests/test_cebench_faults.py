"""The comparison that decides ``correct`` fails a run whose timed path is
broken underneath, and the control (the program's matrix products in TF32)
comes out not correct; a cell on the card is marked ``cuda``."""
from __future__ import annotations

import pytest
import torch

from cebench.tests._util import TINY, one_thread, tiny_root  # noqa: F401
from cebench import control
from cebench.harness import core


@pytest.fixture(scope="module")
def root(tmp_path_factory, one_thread):
    return tiny_root(tmp_path_factory.mktemp("checkout"))


def _quiet(*a, **k):
    pass


def _unchanged():
    """Every call answers what the first call answered."""
    from repro_torch.core import estimator as E
    first = []

    def est(state, qs, taus, cfg, rks=None):
        if not first:
            first.append(E.estimate_batch_stats(state, qs, taus, cfg,
                                                rks=rks))
        return first[0]
    return est


def _half():
    """Half the batch estimated, the other half given the mean of it."""
    from repro_torch.core import estimator as E

    def est(state, qs, taus, cfg, rks=None):
        h = qs.shape[0] // 2
        e, pk, nv = E.estimate_batch_stats(state, qs[:h], taus[:h], cfg,
                                           rks=rks[:h])
        rest = qs.shape[0] - h
        return (torch.cat([e, e.mean().expand(rest)]),
                torch.cat([pk, pk.float().mean(0).round().int()
                           .expand(rest, -1)]),
                torch.cat([nv, nv.float().mean().round().int()
                           .expand(rest)]))
    return est


def _altered():
    """One estimate a call off by one point where it is produced."""
    from repro_torch.core import estimator as E

    def est(state, qs, taus, cfg, rks=None):
        e, pk, nv = E.estimate_batch_stats(state, qs, taus, cfg, rks=rks)
        e = e.clone()
        e[0] += 1.0
        return e, pk, nv
    return est


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["state_unchanged", "half_batch",
                              "answer_altered"])
def test_a_broken_timed_path_is_not_correct(root, fault):
    r = core.run_cell(root, TINY[0], 21, 0.3, False, device="cpu",
                      log=_quiet, estimate=fault())
    assert r["correct"] is False
    assert r["compared"]["stats_diff"]["value"] > 0 or \
        r["compared"]["est_gap"]["value"] > r["compared"]["est_gap"]["limit"]


@pytest.mark.parametrize("cell", TINY)
def test_the_tf32_control_is_not_correct(root, cell):
    res = control.readings(root, cell, [31], 0.1, ["sound", "tf32"],
                           device="cpu")
    (_, sound_ok, _), = res["sound"]
    (_, ctrl_ok, compared), = res["tf32"]
    assert sound_ok is True and ctrl_ok is False
    assert compared["build_diff"]["value"] > 0


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10, 1.0 + 3 * 2 ** -12])
    got = control.round_tf32(x)
    assert got.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0 + 2 ** -10]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", TINY)
def test_a_tiny_cell_on_the_card_is_correct_and_its_control_is_not(root,
                                                                    cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = control.readings(root, cell, [41], 0.5, ["sound", "tf32"])
    assert res["sound"][0][1] is True and res["tf32"][0][1] is False
