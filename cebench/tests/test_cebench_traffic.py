"""The traffic generator: the same seed gives the same calls, and each
pass over the pool sends every pair once."""
from __future__ import annotations

import torch

from cebench.tests import _util  # noqa: F401  (paths)
from cebench.generators import plan_batches
from cebench.harness import data


def _mk(seed, tag="window", batch=16, n_pairs=40):
    return plan_batches.make({"batch": batch}, n_pairs, 2, seed, "cpu", tag)


def test_same_seed_same_calls_other_seed_other_calls():
    big = 2 ** 31 + 12345
    a, b, c = _mk(big), _mk(big), _mk(big + 1)
    for i in (0, 1, 7, 70):
        assert torch.equal(a.pairs(i), b.pairs(i))
        assert torch.equal(a.round_keys(i), b.round_keys(i))
    assert not torch.equal(a.pairs(0), c.pairs(0))
    assert not torch.equal(a.round_keys(0), c.round_keys(0))
    assert not torch.equal(a.round_keys(0), _mk(big, "warm").round_keys(0))


def test_every_pass_sends_each_pair_once():
    t = _mk(9, batch=8, n_pairs=24)             # 3 calls a pass
    first = torch.cat([t.pairs(i) for i in range(3)])
    second = torch.cat([t.pairs(i) for i in range(3, 6)])
    assert sorted(first.tolist()) == list(range(24))
    assert sorted(second.tolist()) == list(range(24))
    assert not torch.equal(first, second)
    odd = _mk(9, batch=16, n_pairs=24)          # calls across passes
    got = torch.cat([odd.pairs(i) for i in range(3)])
    assert sorted(got.tolist()) == sorted(list(range(24)) * 2)


def test_round_keys_are_uint32_values_of_the_call_shape():
    k = _mk(3).round_keys(65)
    assert k.shape == (16, 2, 6) and k.dtype == torch.int64
    assert int(k.min()) >= 0 and int(k.max()) < 2 ** 32


def test_inputs_repeat_from_the_seed():
    def make(seed):
        x, cl = data.make_corpus(data.generator(seed, "corpus", "cpu"), 2000,
                                 8, 4, 3, 0.05, 0.8)
        return x, data.query_pool(data.generator(seed, "pool", "cpu"), x, cl,
                                  6, 5, 20)
    (x1, p1), (x2, p2) = make(77), make(77)
    assert torch.equal(x1, x2)
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    x3, _ = make(78)
    assert not torch.equal(x1, x3)


def test_pool_taus_hold_their_target_counts():
    x, cl = data.make_corpus(data.generator(5, "corpus", "cpu"), 3000, 8, 4,
                             3, 0.05, 0.8)
    q, taus, cards = data.query_pool(data.generator(5, "pool", "cpu"), x, cl,
                                     5, 6, 30)
    targets = data.tau_targets(3000, 6, 30)
    d2 = ((x[None].double() - q[:, None].double()) ** 2).sum(-1)
    for t in range(taus.shape[1]):
        within = (d2 <= taus[:, t, None].double() ** 2).sum(1)
        assert torch.equal(within, cards[:, t])
        assert torch.equal(within, targets[t].expand(5))


def test_every_seed_draws_the_same_cluster_sizes_and_pool_shares():
    for seed in (1, 2):
        x, cl = data.make_corpus(data.generator(seed, "corpus", "cpu"), 4000,
                                 8, 8, 3, 0.05, 0.8)
        assert torch.bincount(cl).tolist() == [500] * 8
        rows = data.stratified_rows(data.generator(seed, "pool", "cpu"), cl,
                                    20)
        assert len(set(rows.tolist())) == 20
        per = torch.bincount(cl[rows], minlength=8)
        assert sorted(per.tolist()) == [2, 2, 2, 2, 3, 3, 3, 3]
