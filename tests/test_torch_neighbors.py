"""The bucket-neighbor table (paper §4.7: Alg. 6 build, Alg. 9 update) of
the port against the reference's ``repro.core.neighbors``, and its rings
against the online Hamming masks.

On the CPU ``ops.neighbor_dists`` runs its plain version
(``ref.neighbor_dists``); every table is held bit for bit against the
reference's: ``build`` with and without padding rows, ``grow``, ``update``
(new codes past the table's capacity, and the capacity-padded update of
``tests/test_updates.py::test_neighbor_update_jitted_fixed_shape``, values
only). Rings ``ring(i, k)`` equal ``hamming_to_buckets(...) == k`` of both
packages over the live rows. Inputs are numpy draws from the seeds named.

The kernel's block schedule (``ops.neighbor_dists_plan``, decoded as the
kernel decodes it) is checked on the CPU to write every entry of a table
or of Alg. 9's strips once. The ``cuda``-marked tests hold the
``neighbor_dists`` kernel against its plain version on the card (ragged
B, K in {1, 10, 32}, n_valid = 0 and = B, Alg. 9 strips at the table's
edges) and skip elsewhere. The machine with the card has no jax, so this
module imports it only inside the tests that use it."""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.core import lsh, neighbors
from repro_torch.kernels import ops, ref

SENTINEL = 2 ** 31 - 1


def _jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import lsh as jlsh, neighbors as jneighbors
    return SimpleNamespace(jnp=jnp, lsh=jlsh, nb=jneighbors)


def _codes(rng, b, k, vals=4, unique=True):
    c = rng.integers(0, vals, (b, k)).astype(np.int32)
    return np.unique(c, axis=0) if unique else c


def _equal(got: neighbors.NeighborTable, want):
    np.testing.assert_array_equal(got.dists.numpy(), np.asarray(want.dists))
    assert got.dists.dtype == torch.int8
    assert int(got.n) == int(want.n) and got.max_dist == want.max_dist


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("k,vals,max_dist,pad", [
    (6, 4, 6, 0), (8, 3, 3, 0), (5, 4, 4, 7), (1, 5, 1, 3), (12, 2, 6, 5)])
def test_build_matches_reference(seed, k, vals, max_dist, pad):
    J = _jax()
    rng = np.random.default_rng(seed)
    codes = _codes(rng, 40, k, vals)
    n = len(codes) - pad
    want = J.nb.build(J.jnp.asarray(codes), J.jnp.int32(n), max_dist)
    got = neighbors.build(torch.from_numpy(codes), n, max_dist)
    _equal(got, want)
    d = got.dists.numpy()
    assert d.max() <= max_dist and (np.diag(d) == 0).all()
    assert (d[n:] == 0).all() and (d[:, n:] == 0).all()
    np.testing.assert_array_equal(d, d.T)


@pytest.mark.parametrize("seed", range(3))
def test_grow_matches_reference(seed):
    J = _jax()
    codes = _codes(np.random.default_rng(seed), 30, 5)
    b = len(codes)
    want = J.nb.grow(J.nb.build(J.jnp.asarray(codes), J.jnp.int32(b), 4), 64)
    got = neighbors.grow(neighbors.build(torch.from_numpy(codes), b, 4), 64)
    _equal(got, want)
    with pytest.raises(ValueError):
        neighbors.grow(got, 32)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n_new", [1, 4, 10])
def test_update_matches_reference_and_fresh_build(seed, n_new):
    """Alg. 9 on codes past the table's capacity: equal to the reference's
    update and to a fresh Alg. 6 build of the concatenated codes (the
    reference's property test, over seeds)."""
    J = _jax()
    rng = np.random.default_rng(100 + seed)
    old = _codes(rng, 25, 5)
    new = _codes(rng, n_new, 5, unique=False)
    both = np.concatenate([old, new])
    n_old, n_all = len(old), len(both)
    jt = J.nb.build(J.jnp.asarray(old), J.jnp.int32(n_old), 4)
    want = J.nb.update(jt, J.jnp.asarray(both), J.jnp.int32(n_old),
                       J.jnp.int32(n_all))
    table = neighbors.build(torch.from_numpy(old), n_old, 4)
    got = neighbors.update(table, torch.from_numpy(both), n_old, n_all)
    _equal(got, want)
    fresh = neighbors.build(torch.from_numpy(both), n_all, 4)
    assert torch.equal(got.dists, fresh.dists)


@pytest.mark.parametrize("seed", range(4))
def test_capacity_padded_update_matches_reference(seed):
    """The capacity-padded Alg. 9 step (sentinel codes past the live rows,
    the table grown to the capacity first): bit-equal to the reference's
    whole (cap, cap) table, and its live block to a fresh build."""
    J = _jax()
    rng = np.random.default_rng(3 + seed)
    old = _codes(rng, 30, 5)
    new = _codes(rng, 6, 5, unique=False)
    n_old, n_all, cap = len(old), len(old) + len(new), 64
    codes_pad = np.full((cap, 5), SENTINEL, np.int32)
    codes_pad[:n_old] = old
    codes_pad[n_old:n_all] = new
    jt = J.nb.grow(J.nb.build(J.jnp.asarray(codes_pad[:n_old]),
                              J.jnp.int32(n_old), 4), cap)
    want = J.nb.update(jt, J.jnp.asarray(codes_pad), J.jnp.int32(n_old),
                       J.jnp.int32(n_all))
    table = neighbors.grow(neighbors.build(
        torch.from_numpy(codes_pad[:n_old]), n_old, 4), cap)
    got = neighbors.update(table, torch.from_numpy(codes_pad), n_old, n_all)
    _equal(got, want)
    fresh = neighbors.build(torch.from_numpy(codes_pad[:n_all]), n_all, 4)
    assert torch.equal(got.dists[:n_all, :n_all], fresh.dists)
    # a second in-capacity step with no new code leaves the table as it is
    again = neighbors.update(got, torch.from_numpy(codes_pad), n_all, n_all)
    np.testing.assert_array_equal(again.dists.numpy(), np.asarray(want.dists))


@pytest.mark.parametrize("seed", range(4))
def test_rings_match_online_hamming(seed):
    """``ring(i, k)`` against the port's and the reference's
    ``hamming_to_buckets(...) == k`` over the live rows, k = 1..6; padding
    rows are in no ring."""
    J = _jax()
    rng = np.random.default_rng(seed)
    codes = _codes(rng, 40, 6)
    b = len(codes)
    n = b - 2
    table = neighbors.build(torch.from_numpy(codes), n, 6)
    bc = torch.from_numpy(codes)[None]
    nb = torch.tensor([n], dtype=torch.int32)
    for i in (0, 1, n // 2, n - 1):
        port = lsh.hamming_to_buckets(bc, nb, bc[:, i][None])[0, 0]
        jref = np.asarray(J.lsh.hamming_to_buckets(
            J.jnp.asarray(codes), J.jnp.int32(n), J.jnp.asarray(codes[i])))
        for k in range(1, 7):
            mask = neighbors.ring(table, i, k)
            assert torch.equal(mask, port == k), (i, k)
            np.testing.assert_array_equal(mask.numpy(), jref == k)
            mk = neighbors.ring(table, torch.tensor(i, dtype=torch.int32),
                                torch.tensor(k, dtype=torch.int32))
            assert torch.equal(mk, mask)
        assert not neighbors.ring(table, i, 1)[n:].any()


def test_neighbor_dists_strips_are_the_table():
    """``ref.neighbor_dists`` on a row range writes exactly the rows and
    columns of that range, equal to the full table there."""
    rng = np.random.default_rng(7)
    codes = torch.from_numpy(_codes(rng, 50, 7, unique=False))
    full = ops.neighbor_dists(codes, 45, 5)
    for r0, r1 in ((0, 50), (10, 20), (44, 50), (0, 1), (49, 50), (20, 20)):
        out = torch.full((50, 50), -1, dtype=torch.int8)
        ops.neighbor_dists(codes, 45, 5, r0, r1, out=out)
        touched = torch.zeros((50, 50), dtype=torch.bool)
        touched[r0:r1] = True
        touched[:, r0:r1] = True
        assert torch.equal(out[touched], full[touched])
        assert (out[~touched] == -1).all()
        # without ``out``: a new table, zero outside the strips
        assert torch.equal(ops.neighbor_dists(codes, 45, 5, r0, r1),
                           torch.where(touched, full, 0))


def test_neighbor_dists_checks():
    codes = torch.zeros((8, 3), dtype=torch.int32)
    for kw in (dict(r0=3, r1=2), dict(r1=9), dict(r0=-1)):
        with pytest.raises(ValueError):
            ops.neighbor_dists(codes, 8, 2, **kw)
    with pytest.raises(ValueError):
        ops.neighbor_dists(codes, 9, 2)
    with pytest.raises(ValueError):
        ops.neighbor_dists(codes, 8, 128)
    with pytest.raises(ValueError):
        ops.neighbor_dists(codes, 8, 2, out=torch.zeros((8, 8)))
    with pytest.raises(ValueError):
        neighbors.update(neighbors.build(codes, 8, 2), codes[:4], 0, 4)


def test_bridge_round_trip():
    codes = torch.from_numpy(_codes(np.random.default_rng(1), 20, 4))
    t = neighbors.build(codes, 15, 3)
    back = bridge.neighbor_table_from_numpy(bridge.neighbor_table_to_numpy(t),
                                            "cpu")
    assert torch.equal(back.dists, t.dists) and int(back.n) == 15
    assert back.max_dist == 3


# ---- the kernel's block schedule (ops.neighbor_dists_plan) ----------------

def _triangle(t):
    """Tile t of the upper triangle, by columns (``triangle`` in
    ``csrc/neighbors.cu``)."""
    j = int((math.sqrt(8.0 * t + 1.0) - 1.0) * 0.5)
    while (j + 1) * (j + 2) // 2 <= t:
        j += 1
    while j * (j + 1) // 2 > t:
        j -= 1
    return t - j * (j + 1) // 2, j


def _writes(plan, b, r0, r1):
    """How many times the kernel's blocks, decoded as
    ``neighbor_dists_kernel`` decodes them, write each entry of a (b, b)
    table, and the live tiles counted."""
    ts, units = ops.NEIGHBOR_TILE, ops.NEIGHBOR_FILL_UNITS
    n = np.zeros((b, b), np.int64)
    flat = n.reshape(-1)
    total = plan.tiles + plan.fill_blocks
    wide = 1 if plan.fill_a + plan.fill_b == 0 else \
        (b * b - plan.live * plan.live) // (plan.fill_a + plan.fill_b)
    counted = 0
    for x in range(total):
        f0 = x * plan.fill_blocks // total
        f1 = (x + 1) * plan.fill_blocks // total
        if f1 > f0:
            wa = (b - plan.live) // wide
            for u in range(f0 * units,
                           min(plan.fill_a + plan.fill_b, (f0 + 1) * units)):
                if u < plan.fill_a:
                    row = u // wa
                    off = row * b + plan.live + (u - row * wa) * wide
                else:
                    off = plan.live * b + (u - plan.fill_a) * wide
                flat[off:off + wide] += 1
            continue
        t = x - f1
        if plan.square:
            ti, tj = _triangle(t)
            row0, col0, rhi = ti * ts, tj * ts, min(ti * ts + ts, b)
            mirror = ti != tj
        else:
            row0 = r0 + (t // plan.side) * ts
            col0 = (t % plan.side) * ts
            rhi, mirror = min(row0 + ts, r1), True
        chi = min(col0 + ts, b)
        counted += 1
        n[row0:rhi, col0:chi] += 1
        if mirror:
            n[col0:chi, row0:rhi] += 1
    return n, counted


@pytest.mark.parametrize("b,n_valid,aligned", [
    (8192 // 16, 4281 // 16, True), (512, 363, True), (512, 0, True),
    (512, 512, True), (512, 1, True), (1000, 999, False), (17, 5, False),
    (4099, 4099, False), (320, 64, True), (320, 65, True), (64, 64, True)])
def test_neighbor_dists_plan_writes_each_entry_once(b, n_valid, aligned):
    """Alg. 6: the live square's upper triangle, mirrored, and the zero
    fill of the rest write every entry of the table exactly once, and
    only the n(n+1)/2 tile pairs of the live square are counted."""
    plan = ops.neighbor_dists_plan(b, 10, n_valid, 0, b, aligned)
    n, counted = _writes(plan, b, 0, b)
    assert (n == 1).all(), np.argwhere(n != 1)[:5]
    side = -(-n_valid // ops.NEIGHBOR_TILE)
    assert counted == plan.tiles == side * (side + 1) // 2
    assert plan.smem == 2 * 10 * 68 * 4 + 2 * 64 * 80


@pytest.mark.parametrize("b,r0,r1", [
    (1000, 0, 1), (1000, 999, 1000), (1000, 0, 999), (1000, 13, 29),
    (1024, 16, 32), (1024, 255, 513), (300, 150, 151), (8192 // 8, 997, 1023)])
def test_neighbor_dists_plan_writes_each_strip_entry_once(b, r0, r1):
    """Alg. 9: the new rows' strip and its mirror write every entry with
    i or j in [r0, r1) once (the new-by-new block twice, with the same
    values) and nothing else; the strip is counted once, not twice."""
    plan = ops.neighbor_dists_plan(b, 10, r1, r0, r1, b % 16 == 0)
    n, counted = _writes(plan, b, r0, r1)
    strip = np.zeros(b, bool)
    strip[r0:r1] = True
    want = strip[:, None].astype(int) + strip[None, :].astype(int)
    assert (n == want).all(), np.argwhere(n != want)[:5]
    assert counted == plan.tiles == -(-(r1 - r0) // 64) * -(-b // 64)


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


def _plain(codes, n_valid, max_dist, r0, r1, out):
    return ref.neighbor_dists(codes, n_valid, max_dist, r0, r1, out.clone())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 17, 255, 256, 1000, 4099])
@pytest.mark.parametrize("k", [1, 10, 32])
def test_cuda_neighbor_dists_matches_plain(cuda_gen, b, k):
    codes = torch.randint(-1, 2, (b, k), generator=cuda_gen, device="cuda",
                          dtype=torch.int32)
    for n_valid, max_dist in ((b, 6), (b // 2, k), (b - 1 if b > 1 else 0,
                                                     127)):
        got = ops.neighbor_dists(codes, n_valid, max_dist)
        want = _plain(codes, n_valid, max_dist, 0, b,
                      torch.zeros((b, b), dtype=torch.int8, device="cuda"))
        assert torch.equal(got, want), (b, k, n_valid, max_dist)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 64, 1000, 4096])
@pytest.mark.parametrize("k", [1, 10, 32])
def test_cuda_neighbor_dists_dead_and_full(cuda_gen, b, k):
    """The build at n_valid = 0 (the pure zero fill, over a table that
    held other values) and at n_valid = b (no fill, every tile live)."""
    codes = torch.randint(-1, 2, (b, k), generator=cuda_gen, device="cuda",
                          dtype=torch.int32)
    for n_valid in (0, b):
        out = torch.full((b, b), 9, dtype=torch.int8, device="cuda")
        got = ops.neighbor_dists(codes, n_valid, k, out=out)
        want = _plain(codes, n_valid, k, 0, b, out)
        assert torch.equal(got, want), (b, k, n_valid)
    assert not bool(ops.neighbor_dists(codes, 0, k).any())


@pytest.mark.cuda
@pytest.mark.parametrize("b,r0,r1", [
    (1000, 0, 1), (1000, 999, 1000), (1000, 0, 999), (1000, 13, 29),
    (1024, 16, 32), (1024, 255, 513), (4099, 4000, 4099), (300, 150, 150)])
def test_cuda_neighbor_dists_strips(cuda_gen, b, r0, r1):
    """Alg. 9 strips at the table's edges and off the 16-column pieces:
    entries outside the strips keep their old values."""
    codes = torch.randint(0, 3, (b, 10), generator=cuda_gen, device="cuda",
                          dtype=torch.int32)
    old = torch.randint(-5, 6, (b, b), generator=cuda_gen, device="cuda",
                        dtype=torch.int32).to(torch.int8)
    want = _plain(codes, r1, 6, r0, r1, old)
    got = ops.neighbor_dists(codes, r1, 6, r0, r1, out=old.clone())
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_update_equals_fresh_build(cuda_gen):
    codes = torch.unique(torch.randint(0, 4, (6000, 8), generator=cuda_gen,
                                       device="cuda", dtype=torch.int32),
                         dim=0)
    n_all = codes.shape[0]
    n_old = n_all - 300
    cap = 8192
    pad = torch.full((cap, 8), SENTINEL, dtype=torch.int32, device="cuda")
    pad[:n_all] = codes
    table = neighbors.build(pad[:n_old].contiguous(), n_old, 6)
    table = neighbors.grow(table, cap)
    got = neighbors.update(table, pad, n_old, n_all)
    assert torch.equal(got.dists, neighbors.build(pad, n_all, 6).dists)
