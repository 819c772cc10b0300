"""The port's corpus loader (``repro_torch.data.vectors``: ``CORPORA``,
``VectorDataset``, ``load``) on the CPU, at a small ``scale``.

``CORPORA`` equals the reference's table. ``load`` gives the reference's
shapes and dtypes at each corpus's own width, cardinalities equal to an
exact recount (float32 difference-form distances, the form of the workload
itself), a τ grid that reaches each target, the same dataset for the same
seed, and a seed from ``zlib.crc32(name)`` when no generator is given. It
raises without CUDA unless the caller asks for the CPU. On the card
(``cuda``-marked), each corpus's workload ``l2dist`` (the general kernel at
d = 960 and 1770) and ``l2dist_rows`` at its width agree with their plain
versions."""
import dataclasses
import zlib

import numpy as np
import pytest
import torch

from repro_torch.data import vectors
from repro_torch.kernels import ops, ref


def test_corpora_match_reference():
    pytest.importorskip("jax")
    from repro.data import vectors as jv
    assert vectors.CORPORA == jv.CORPORA
    assert list(vectors.CORPORA) == list(jv.CORPORA)
    assert [f.name for f in dataclasses.fields(vectors.VectorDataset)] == \
        [f.name for f in dataclasses.fields(jv.VectorDataset)]


@pytest.mark.parametrize("name", list(vectors.CORPORA))
def test_load_shapes_and_exact_cards(name):
    n, d = vectors.CORPORA[name]
    scale = 600 / n
    ds = vectors.load(name, torch.Generator().manual_seed(1), n_queries=5,
                      scale=scale, device="cpu")
    assert ds.name == name
    assert ds.x.shape == (int(n * scale), d) and ds.x.dtype == torch.float32
    assert ds.queries.shape == (5, d) and ds.queries.dtype == torch.float32
    nt = ds.taus.shape[1]
    # targets: the geometric grid in [1, max(N // 100, 2)]
    targets = np.unique(np.geomspace(1, max(ds.x.shape[0] // 100, 2), 12)
                        .astype(np.int64))
    assert nt == len(targets)
    assert ds.taus.shape == ds.cards.shape == (5, nt)
    assert ds.taus.dtype == torch.float32 and not ds.cards.is_floating_point()
    for q, ts, cs in zip(ds.queries, ds.taus, ds.cards):
        d2 = ((ds.x - q) ** 2).sum(-1)
        recount = torch.stack([(d2 <= t * t).sum() for t in ts])
        assert torch.equal(cs, recount.to(cs.dtype))
        assert (cs >= torch.as_tensor(targets)).all()
        assert (torch.diff(ts) > 0).all()
    # queries are corpus rows
    assert all(((ds.x - q).abs().sum(-1) == 0).any() for q in ds.queries)


def test_load_is_deterministic_and_crc32_seeded():
    a = vectors.load("glove", torch.Generator().manual_seed(5), n_queries=4,
                     scale=0.02, device="cpu")
    b = vectors.load("glove", torch.Generator().manual_seed(5), n_queries=4,
                     scale=0.02, device="cpu")
    c = vectors.load("glove", torch.Generator().manual_seed(6), n_queries=4,
                     scale=0.02, device="cpu")
    for f in ("x", "queries", "taus", "cards"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    assert not torch.equal(a.x, c.x)
    default = vectors.load("gist", n_queries=3, scale=0.03, device="cpu")
    seeded = vectors.load("gist", torch.Generator().manual_seed(
        zlib.crc32(b"gist") % 2 ** 31), n_queries=3, scale=0.03, device="cpu")
    assert torch.equal(default.x, seeded.x)
    assert torch.equal(default.taus, seeded.taus)


def test_load_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        vectors.load("sift", scale=0.01)
    with pytest.raises(RuntimeError, match="CUDA"):
        vectors.load("sift", torch.Generator(), scale=0.01, device="cuda")
    ds = vectors.load("sift", scale=0.01, n_queries=2, device="cpu")
    assert ds.x.device.type == "cpu"
    with pytest.raises(KeyError):
        vectors.load("deep1b", scale=0.01, device="cpu")


def test_load_rejects_a_generator_elsewhere():
    class Meta:
        device = torch.device("meta")
    with pytest.raises(ValueError):
        vectors.load("sift", Meta(), scale=0.01, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(vectors.CORPORA))
def test_cuda_load_kernels_match_plain_at_each_width(name):
    """The paper widths' kernel routes on the card: the workload's
    ``l2dist`` (tiled at every width: in two panels of k at 960, four at
    1770, whose 7,080-byte rows take 8-byte copies; never the general
    kernel) and ``l2dist_rows`` (its scalar row path at 1770) against their
    plain versions; the cardinalities equal a recount from the kernel's
    distances."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n, d = vectors.CORPORA[name]
    g = torch.Generator(device="cuda").manual_seed(3)
    ops.reset_launches()
    ds = vectors.load(name, g, n_queries=33, scale=6_007 / n)
    assert ops.LAUNCHES["l2dist"] == 1
    assert ops.LAUNCHES["l2dist_general"] == 0
    plan = ops.l2dist_plan(ds.x.shape[0], 33, d, ds.x.data_ptr(),
                           ds.queries.data_ptr())
    assert (plan.panels, plan.width) == ({960: 2, 1770: 4}.get(d, 1),
                                         8 if d == 1770 else 16)
    assert torch.equal(ops.l2dist(ds.x, ds.queries),
                       ops.l2dist_general(ds.x, ds.queries))
    got = ops.l2dist(ds.x, ds.queries)
    torch.testing.assert_close(got, ref.l2dist(ds.x, ds.queries),
                               rtol=1e-5, atol=1e-5)
    recount = torch.stack([(got <= ds.taus[:, t] ** 2).sum(0)
                           for t in range(ds.taus.shape[1])], dim=1)
    assert torch.equal(ds.cards, recount.to(ds.cards.dtype))
    ids = torch.randint(0, ds.x.shape[0], (33, 700), generator=g,
                        device="cuda", dtype=torch.int32)
    torch.testing.assert_close(ops.l2dist_rows(ds.x, ids, ds.queries),
                               ref.l2dist_rows(ds.x, ids, ds.queries),
                               rtol=1e-5, atol=1e-5)
