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


def _corpus_as_drawn_before(g, n, dim, n_clusters, intrinsic_dim, noise,
                            scale_sigma):
    """The corpus generator as it was before the held-out stream shared
    its surrogate: the draws, in their order, that the cells' corpora were
    made by."""
    import math
    dev = g.device
    basis = torch.randn((intrinsic_dim, dim), generator=g, device=dev) \
        / math.sqrt(intrinsic_dim)
    centers = torch.randn((n_clusters, intrinsic_dim), generator=g,
                          device=dev)
    centers *= 2.0 * math.sqrt(intrinsic_dim) / centers.norm(dim=1,
                                                            keepdim=True)
    quant = (torch.arange(n_clusters, device=dev, dtype=torch.float64)
             + 0.5) / n_clusters
    scales = torch.exp(torch.special.ndtri(quant) * scale_sigma).float()
    scales = scales[torch.randperm(n_clusters, generator=g, device=dev)]
    assign = torch.randperm(n, generator=g, device=dev) % n_clusters
    z = centers[assign] + torch.randn((n, intrinsic_dim), generator=g,
                                      device=dev) * scales[assign, None]
    x = z @ basis + torch.randn((n, dim), generator=g, device=dev) * noise
    return x.float().contiguous(), assign


def test_the_corpus_is_drawn_as_before():
    for seed in (4, 2 ** 31 + 99):
        args = (1500, 16, 8, 12, 0.05, 0.8)
        got = data.make_corpus(data.generator(seed, "corpus", "cpu"), *args)
        want = _corpus_as_drawn_before(
            data.generator(seed, "corpus", "cpu"), *args)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


CFG = {"d": 8, "corpus": {"n_clusters": 4, "intrinsic_dim": 3,
                          "noise": 0.05, "scale_sigma": 0.8}}


def test_the_heldout_stream_is_the_same_however_it_is_cut():
    big = 2 ** 31 + 5
    whole = data.heldout(CFG, big, 0, 2500, "cpu")
    cut = torch.cat([data.heldout(CFG, big, 0, 700, "cpu"),
                     data.heldout(CFG, big, 700, 1324, "cpu"),
                     data.heldout(CFG, big, 2024, 476, "cpu")])
    assert whole.shape == (2500, 8) and torch.equal(whole, cut)
    assert torch.equal(data.heldout(CFG, big, 1000, 30, "cpu"),
                       whole[1000:1030])
    assert not torch.equal(data.heldout(CFG, big + 1, 0, 30, "cpu"),
                           whole[:30])


def test_the_heldout_stream_is_new_points_of_the_corpus_clusters():
    """Every held-out point lies as near a corpus cluster's centre as the
    corpus's own points do, and none is a corpus point."""
    x, cl = data.make_corpus(data.generator(6, "corpus", "cpu"), 2000, 8, 4,
                             3, 0.05, 0.8)
    h = data.heldout(CFG, 6, 0, 1000, "cpu")
    means = torch.stack([x[cl == c].mean(0) for c in range(4)])
    near_h = torch.cdist(h, means).min(1).values
    near_x = torch.cdist(x, means).min(1).values
    assert float(near_h.quantile(0.9)) < 1.5 * float(near_x.quantile(0.9))
    assert float(torch.cdist(h, x).min()) > 0
