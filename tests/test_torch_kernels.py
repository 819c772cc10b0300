"""The port's kernels (``repro_torch.kernels``) against the reference.

On the CPU the wrappers run their plain versions, which are held against
the JAX package's Pallas kernels (interpret mode, as tests/test_kernels.py
runs them) and its plain forms. The ``cuda``-marked tests hold each CUDA
kernel against its plain version on the card and skip elsewhere.
"""
import numpy as np
import pytest
import torch

from _torch_parity import MARGIN, near_integer
from repro_torch.kernels import ops, ref


def _np(seed):
    return np.random.default_rng(seed)


def _jax():
    pytest.importorskip("jax")
    from repro.kernels import ops as jops, ref as jref
    return jops, jref


@pytest.mark.parametrize("n,d,f", [(64, 16, 8), (300, 32, 20), (257, 13, 13),
                                   (1, 8, 4)])
def test_lsh_hash_matches_pallas(n, d, f):
    jops, _ = _jax()
    r = _np(n + d)
    x = r.standard_normal((n, d), dtype=np.float32)
    a = r.standard_normal((d, f), dtype=np.float32)
    b = r.uniform(0, 1, f).astype(np.float32)
    w = r.uniform(0.5, 2.0, f).astype(np.float32)
    want = np.asarray(jops.lsh_hash(x, a, b, w))
    got = ops.lsh_hash(*map(torch.from_numpy, (x, a, b, w))).numpy()
    near = near_integer(x, a, b, w)
    flips = int((got != want).sum())
    print(f"lsh_hash: {flips} codes differ; {int(near.sum())} values lie "
          f"within {MARGIN} of an integer")
    np.testing.assert_array_equal(got[~near], want[~near])


@pytest.mark.parametrize("b,k", [(64, 6), (1000, 14), (3, 1), (2048, 10)])
def test_hamming_matches_pallas(b, k):
    jops, _ = _jax()
    r = _np(b + k)
    bc = r.integers(-3, 4, (b, k)).astype(np.int32)
    qc = r.integers(-3, 4, k).astype(np.int32)
    got = ops.hamming(torch.from_numpy(bc), torch.from_numpy(qc)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.hamming(bc, qc)))


def test_hamming_to_buckets_matches_reference():
    pytest.importorskip("jax")
    from repro.core import lsh as jlsh
    r = _np(3)
    nq, nl, nb, k = 5, 2, 700, 10
    bc = r.integers(-2, 3, (nl, nb, k)).astype(np.int32)
    qc = r.integers(-2, 3, (nq, nl, k)).astype(np.int32)
    n_buckets = np.array([650, 700], np.int32)
    got = ops.hamming_to_buckets(*map(torch.from_numpy,
                                      (bc, qc, n_buckets))).numpy()
    assert got.shape == (nq, nl, nb) and got.dtype == np.int32
    for q in range(nq):
        for t in range(nl):
            want = jlsh.hamming_to_buckets(bc[t], n_buckets[t], qc[q, t])
            np.testing.assert_array_equal(got[q, t], np.asarray(want))


@pytest.mark.parametrize("n,q,d", [(128, 16, 32), (251, 7, 24), (64, 1, 32),
                                   (1, 1, 8)])
def test_l2dist_matches_pallas_and_difference_form(n, q, d):
    jops, jref = _jax()
    r = _np(n * d)
    x = r.standard_normal((n, d), dtype=np.float32)
    qq = r.standard_normal((q, d), dtype=np.float32)
    got = ops.l2dist(torch.from_numpy(x), torch.from_numpy(qq)).numpy()
    # the Pallas kernel's expansion form rounds differently (its own tol)
    np.testing.assert_allclose(got, np.asarray(jops.l2dist(x, qq)),
                               rtol=1e-3, atol=1e-3 * d)
    np.testing.assert_allclose(got, np.asarray(jref.l2dist(x, qq)),
                               rtol=1e-6, atol=1e-6)


def test_l2dist_rows_matches_difference_form():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    r = _np(11)
    x = r.standard_normal((500, 32), dtype=np.float32)
    ids = r.integers(0, 500, (6, 40)).astype(np.int32)
    qs = r.standard_normal((6, 32), dtype=np.float32)
    got = ops.l2dist_rows(*map(torch.from_numpy, (x, ids, qs))).numpy()
    # the reference's qualification: diff = x[ids] - q; sum(diff * diff)
    diff = jnp.asarray(x)[ids] - jnp.asarray(qs)[:, None, :]
    want = np.asarray(jnp.sum(diff * diff, axis=-1))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,nq,d,x_off,q_off,panels,chunks,width", [
    (1000, 64, 128, 0, 0, 1, 2, 16),
    (70_001, 130, 96, 0, 0, 1, 2, 16),  # ragged N, two and a bit query tiles
    (5, 1, 576, 0, 0, 1, 9, 16),        # the widest d of one panel
    (5, 1, 580, 0, 0, 2, 5, 16),        # ... and the next multiple of 4
    (10, 64, 1024, 0, 0, 2, 8, 16),     # a d far too wide for one panel
    (1000, 3, 30, 0, 0, 1, 1, 8),       # d % 4 != 0: rows of 120 bytes
    (1000, 64, 128, 1, 0, 1, 2, 4),     # x 4 bytes off a 16-byte boundary
    (1000, 64, 128, 0, 1, 1, 2, 4),     # q likewise
    (1000, 64, 960, 0, 0, 2, 8, 16),    # GIST's width
    (1000, 64, 960, 2, 0, 2, 8, 8),     # ... x 8 bytes off
    (1000, 64, 960, 0, 1, 2, 8, 4),     # ... q 4 bytes off
    (1000, 64, 1770, 0, 0, 4, 7, 8),    # YouTube's: rows of 7,080 bytes
    (1000, 64, 1770, 0, 2, 4, 7, 8),    # ... q 8 bytes off
    (1000, 64, 1770, 1, 0, 4, 7, 4),    # ... x 4 bytes off
    (777, 130, 17, 0, 0, 1, 1, 4),      # odd d: rows of 68 bytes
])
def test_l2dist_plan_routes_by_shape_and_alignment(n, nq, d, x_off, q_off,
                                                   panels, chunks, width):
    """Every shape takes the tiled kernel: d in the fewest panels of at
    most 9 chunks of 64 floats, of equal chunks, and copies of the widest
    piece that the row width and both addresses allow."""
    x = torch.empty(n * d + x_off)[x_off:].view(n, d)
    q = torch.empty(nq * d + q_off)[q_off:].view(nq, d)
    plan = ops.l2dist_plan(n, nq, d, x.data_ptr(), q.data_ptr())
    assert plan == ops.L2Plan(-(-n // 128), -(-nq // 64), panels, chunks,
                              width, ops.l2dist_smem(chunks))
    assert (panels - 1) * chunks < -(-d // 64) <= panels * chunks
    assert plan.smem <= 232448


def test_l2dist_plan_refuses_more_query_tiles_than_the_grid_holds():
    assert ops.l2dist_plan(10, 64 * 65535, 8, 0, 0) is not None
    assert ops.l2dist_plan(10, 64 * 65535 + 1, 8, 0, 0) is None


def test_cpu_tensors_take_plain_versions_and_count_nothing():
    ops.reset_launches()
    x = torch.randn(10, 8)
    ops.l2dist(x, x[:2])
    assert torch.equal(ops.l2dist_general(x, x[:2]), ref.l2dist(x, x[:2]))
    ops.l2dist_rows(x, torch.zeros((2, 3), dtype=torch.int32), x[:2])
    ops.lsh_hash(x, torch.randn(8, 4), torch.rand(4), torch.ones(4))
    ops.hamming(torch.zeros((5, 3), dtype=torch.int32),
                torch.zeros(3, dtype=torch.int32))
    assert all(v == 0 for v in ops.LAUNCHES.values())


def test_other_devices_raise_instead_of_falling_back():
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.l2dist(x, x)
    with pytest.raises(ValueError, match="different devices"):
        ops.l2dist(torch.zeros(4, 8), x)


# ---- on the card: each CUDA kernel against its plain version -------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,f", [(64, 128, 20), (10_001, 128, 20),
                                   (777, 33, 7), (5, 1000, 40)])
def test_cuda_lsh_hash_matches_plain(n, d, f):
    g = _card()
    x = torch.randn(n, d, device="cuda", generator=g)
    a = torch.randn(d, f, device="cuda", generator=g)
    b = torch.rand(f, device="cuda", generator=g)
    w = torch.rand(f, device="cuda", generator=g) + 0.5
    got = ops.lsh_hash(x, a, b, w)
    want = ref.lsh_hash(x, a, b, w)
    near = torch.from_numpy(near_integer(*(t.cpu().numpy()
                                           for t in (x, a, b, w)))).cuda()
    print(f"lsh_hash flips {int((got != want).sum())}")
    assert torch.equal(got[~near], want[~near])


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nl,nb,k", [(64, 2, 5000, 10), (3, 1, 257, 1),
                                        (7, 3, 1000, 32)])
def test_cuda_hamming_to_buckets_matches_plain(nq, nl, nb, k):
    g = _card()
    bc = torch.randint(-2, 3, (nl, nb, k), device="cuda", generator=g,
                       dtype=torch.int32)
    qc = torch.randint(-2, 3, (nq, nl, k), device="cuda", generator=g,
                       dtype=torch.int32)
    n_buckets = torch.randint(0, nb + 1, (nl,), device="cuda", generator=g,
                              dtype=torch.int32)
    assert torch.equal(ops.hamming_to_buckets(bc, qc, n_buckets),
                       ref.hamming_to_buckets(bc, qc, n_buckets))


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,d", [(65_536, 64, 128), (1000, 3, 30),
                                   (70, 130, 17)])
def test_cuda_l2dist_matches_plain(n, q, d):
    g = _card()
    x = torch.randn(n, d, device="cuda", generator=g)
    qq = torch.randn(q, d, device="cuda", generator=g)
    torch.testing.assert_close(ops.l2dist(x, qq), ref.l2dist(x, qq),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,d,x_off,q_off", [
    (70_001, 64, 128, 0, 0), (4_096, 130, 128, 0, 0), (10_000, 1, 128, 0, 0),
    (20_000, 64, 96, 0, 0), (5_000, 64, 128, 1, 0),
    (5_000, 64, 580, 1, 0), (5_000, 64, 960, 0, 0), (5_000, 64, 960, 2, 1),
    (3_000, 64, 1024, 0, 1), (3_000, 64, 1770, 0, 0), (3_000, 64, 1770, 1, 2),
    (3_000, 3, 30, 1, 1), (777, 130, 17, 0, 1)])
def test_cuda_l2dist_tiled_and_general_agree(n, q, d, x_off, q_off):
    """Every shape takes the tiled kernel (ragged N, ragged Q, Q = 1,
    several panels of k, 8- and 4-byte copies for odd widths and
    misaligned x or q) and is bit-equal to the general kernel."""
    g = _card()
    x = torch.randn(n * d + x_off, device="cuda",
                    generator=g)[x_off:].view(n, d)
    qq = torch.randn(q * d + q_off, device="cuda",
                     generator=g)[q_off:].view(q, d)
    assert ops.l2dist_plan(n, q, d, x.data_ptr(), qq.data_ptr()) is not None
    ops.reset_launches()
    got = ops.l2dist(x, qq)
    assert ops.LAUNCHES["l2dist"] == 1
    assert ops.LAUNCHES["l2dist_general"] == 0
    torch.testing.assert_close(got, ref.l2dist(x, qq), rtol=1e-5, atol=1e-5)
    assert torch.equal(got, ops.l2dist_general(x, qq))


@pytest.mark.cuda
@pytest.mark.parametrize("r,c,d,n,ordered", [
    (128, 128, 128, 50_000, False), (128, 2048, 128, 50_000, False),
    (5, 9, 30, 50_000, False), (128, 2048, 128, 50_000, True),
    (64, 700, 1770, 50_000, False), (64, 700, 1770, 50_000, True),
    (33, 301, 30, 50_000, True), (768, 10_000, 128, 1_000_000, True)])
def test_cuda_l2dist_rows_matches_plain(r, c, d, n, ordered):
    """Ids as drawn and in ascending order within each row (the Sampling
    path's order), at the slab shapes, at odd and wide d, and at the
    Sampling baseline's 768 pairs x 10,000 draws from 1M rows."""
    g = _card()
    x = torch.randn(n, d, device="cuda", generator=g)
    ids = torch.randint(0, n, (r, c), device="cuda", generator=g,
                        dtype=torch.int32)
    if ordered:
        ids = ids.sort(dim=1).values.contiguous()
    qs = torch.randn(r, d, device="cuda", generator=g)
    got = ops.l2dist_rows(x, ids, qs)
    want = ref.l2dist_rows(x, ids, qs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    perm = torch.argsort(torch.rand(ids.shape, device="cuda", generator=g),
                         dim=1)
    shuffled = torch.gather(ids, 1, perm).contiguous()
    assert torch.equal(ops.l2dist_rows(x, shuffled, qs),
                       torch.gather(got, 1, perm))
