"""The port's ADC kernels (``ops.adc*``) against the reference.

On the CPU the wrappers run their plain versions, held here against the
JAX package's Pallas ADC kernels in interpret mode (as tests/test_kernels.py
and tests/test_quantized.py run them) and against the reference's own
qualification sums: float32 to rtol 1e-5, uint8 LUTs exactly. The
``cuda``-marked tests hold each CUDA kernel against its plain version on
the card and skip elsewhere."""
import numpy as np
import pytest
import torch

from repro_torch.core import pq
from repro_torch.kernels import ops, ref


def _jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import adc as jadc
    return jnp, jadc


def _inputs(seed, n, m, kc, q):
    r = np.random.default_rng(seed)
    codes = r.integers(0, kc, (n, m)).astype(np.uint8)
    luts = r.standard_normal((q, m, kc)).astype(np.float32) ** 2
    qluts = r.integers(0, 256, (q, m, kc)).astype(np.uint8)
    return codes, luts, qluts


# n not a multiple of the Pallas block (512) exercises its padding
@pytest.mark.parametrize("n,m,kc,q", [(777, 8, 32, 5), (1030, 32, 64, 3),
                                      (300, 30, 16, 2), (1, 4, 16, 1)])
def test_adc_forms_match_pallas(n, m, kc, q):
    jnp, jadc = _jax()
    codes, luts, qluts = _inputs(n + m, n, m, kc, q)
    tc = torch.from_numpy(codes)
    got = ops.adc_batch(tc, torch.from_numpy(luts)).numpy()
    want = np.asarray(jadc.adc_batch(jnp.asarray(codes, jnp.int32), luts,
                                     interpret=True))
    assert got.shape == (q, n) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    gotq = ops.adc_batch_q8(tc, torch.from_numpy(qluts)).numpy()
    wantq = np.asarray(jadc.adc_batch_q8(jnp.asarray(codes, jnp.int32),
                                         qluts, interpret=True))
    assert gotq.dtype == np.int32
    np.testing.assert_array_equal(gotq, wantq)
    # the single-LUT forms, which also take int32 codes
    ci = torch.from_numpy(codes.astype(np.int32))
    np.testing.assert_allclose(
        ops.adc(ci, torch.from_numpy(luts[0])).numpy(),
        np.asarray(jadc.adc(codes, luts[0], interpret=True)), rtol=1e-5,
        atol=1e-6)
    np.testing.assert_array_equal(
        ops.adc_q8(ci, torch.from_numpy(qluts[0])).numpy(),
        np.asarray(jadc.adc_q8(codes, qluts[0], interpret=True)))


def test_adc_rows_match_reference_qualification_sums():
    """The fused-gather forms against the reference's prober qualfn sums
    ``sum(lut[arange(M), codes[ids]])`` per lane, byte and packed codes."""
    jnp, _ = _jax()
    codes, luts, qluts = _inputs(5, 3000, 8, 16, 4)
    r = np.random.default_rng(6)
    ids = r.integers(0, 3000, (10, 77)).astype(np.int32)
    lane_q = r.integers(0, 4, 10).astype(np.int32)
    packed = pq.pack_codes(torch.from_numpy(codes))
    marange = jnp.arange(8)
    for lut_np, fn in ((luts, ops.adc_rows), (qluts, ops.adc_rows_q8)):
        want = np.stack([np.asarray(jnp.sum(
            jnp.asarray(lut_np[lane_q[i]])[marange,
                                           jnp.asarray(codes)[ids[i]]]
            .astype(jnp.int32 if lut_np.dtype == np.uint8 else jnp.float32),
            axis=-1)) for i in range(10)])
        for src in (torch.from_numpy(codes), packed):
            got = fn(src, torch.from_numpy(ids), torch.from_numpy(lut_np),
                     torch.from_numpy(lane_q)).numpy()
            assert got.shape == (10, 77)
            if lut_np.dtype == np.uint8:
                assert got.dtype == np.int32
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_packed_and_byte_codes_give_identical_sums():
    codes, luts, qluts = _inputs(9, 513, 16, 16, 3)
    tc = torch.from_numpy(codes)
    packed = pq.pack_codes(tc)
    assert packed.shape == (513, 8)
    assert torch.equal(ops.adc_batch(packed, torch.from_numpy(luts)),
                       ops.adc_batch(tc, torch.from_numpy(luts)))
    assert torch.equal(ops.adc_batch_q8(packed, torch.from_numpy(qluts)),
                       ops.adc_batch_q8(tc, torch.from_numpy(qluts)))


@pytest.mark.parametrize("q8", [False, True])
def test_adc_batch_tiles_fit_and_cover_every_query_once(q8):
    """Over a grid of shapes the kernel takes, the tile plan fits a block's
    227 KB, its row tile holds every lane's rows, and the query tiles
    (one grid row each) cover each query exactly once."""
    for nq in (1, 2, 3, 4, 5, 15, 16, 17, 63, 64, 65, 100, 1000):
        for m, kc, cb in ((32, 64, 32), (30, 16, 30), (8, 16, 4),
                          (64, 256, 64), (128, 16, 64), (1, 1, 1),
                          (4, 256, 4), (16, 16, 8)):
            lg, lrb = ops.adc_batch_plan(nq, m, kc, cb, q8)
            assert ops.adc_batch_smem(q8, m, kc, cb, lg, lrb) <= 232448
            assert 0 <= lg <= 4 and 16 * (32 >> lg) <= 1 << lrb <= 512
            qt = (4 if q8 else 1) << lg
            covered = np.zeros(nq, dtype=int)
            for t in range(-(-nq // qt)):
                covered[t * qt:min(nq, (t + 1) * qt)] += 1
            assert (covered == 1).all()
            # no wider than the queries need, up to 16 words
            assert lg == 4 or qt < 2 * nq or qt == (4 if q8 else 1)
    # the scan's shape takes the widest tiles: 16 float or 64 uint8 queries
    assert ops.adc_batch_plan(64, 32, 64, 32, False) == (4, 9)
    assert ops.adc_batch_plan(64, 32, 64, 32, True) == (4, 8)


def test_cpu_adc_wrappers_take_plain_versions_and_count_nothing():
    ops.reset_launches()
    codes = torch.zeros((6, 4), dtype=torch.uint8)
    luts = torch.rand(2, 4, 16)
    ids = torch.zeros((2, 3), dtype=torch.int32)
    lane_q = torch.zeros(2, dtype=torch.int32)
    ops.adc_rows(codes, ids, luts, lane_q)
    ops.adc_rows_q8(codes, ids, luts.to(torch.uint8), lane_q)
    ops.adc_batch(codes, luts)
    ops.adc_batch_q8(codes, luts.to(torch.uint8))
    ops.adc(codes, luts[0])
    assert all(v == 0 for v in ops.LAUNCHES.values())
    with pytest.raises(ValueError, match="no kernel"):
        ops.adc_batch(codes.to("meta"), luts.to("meta"))


# ---- on the card: each CUDA kernel against its plain version -------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


def _card_inputs(g, n, m, kc, q, packed):
    codes = torch.randint(0, kc, (n, m), device="cuda", generator=g,
                          dtype=torch.uint8)
    if packed:
        codes = pq.pack_codes(codes).contiguous()
    luts = torch.rand((q, m, kc), device="cuda", generator=g) * 10
    qluts = torch.randint(0, 256, (q, m, kc), device="cuda", generator=g,
                          dtype=torch.uint8)
    return codes, luts, qluts


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,kc,q,packed", [
    (1 << 20, 32, 64, 64, False),    # the scan baseline's shape
    (10_001, 30, 16, 5, False),      # 30-byte rows: byte loads
    (4099, 8, 16, 17, True),         # packed 4-bit codes
    (777, 64, 256, 3, False),        # 64 KB f32 LUT: above 48 KB
    (5000, 32, 64, 1, False),        # Q = 1: one query per tile
    (5000, 32, 64, 16, False),       # one full float tile
    (5000, 32, 64, 17, False),       # a second tile of one query
    (1, 32, 64, 64, False),          # N = 1
    (100_003, 32, 64, 64, False),    # N not a multiple of a row tile
    (1 << 16, 64, 16, 64, True)])    # packed 4-bit codes at Q = 64
def test_cuda_adc_batch_matches_plain(n, m, kc, q, packed):
    """Float sums run over m in the plain version's order: bit-equal."""
    g = _card()
    codes, luts, qluts = _card_inputs(g, n, m, kc, q, packed)
    assert torch.equal(ops.adc_batch(codes, luts),
                       ref.adc_batch(codes, luts))
    assert torch.equal(ops.adc_batch_q8(codes, qluts),
                       ref.adc_batch_q8(codes, qluts))


@pytest.mark.cuda
@pytest.mark.parametrize("r,c,m,kc,q,packed", [
    (128, 128, 32, 64, 64, False),   # prober_cfg slab
    (64, 512, 32, 64, 64, False),    # serve_cfg slab and central
    (128, 2048, 32, 64, 64, False),  # central bucket
    (48, 100, 8, 16, 24, True),      # packed 4-bit codes
    (5, 9, 30, 16, 2, False),        # unaligned rows
    (3, 700, 64, 256, 2, False)])    # 64 KB f32 LUT: above 48 KB
def test_cuda_adc_rows_matches_plain(r, c, m, kc, q, packed):
    g = _card()
    codes, luts, qluts = _card_inputs(g, 50_000, m, kc, q, packed)
    ids = torch.randint(0, 50_000, (r, c), device="cuda", generator=g,
                        dtype=torch.int32)
    lane_q = torch.randint(0, q, (r,), device="cuda", generator=g,
                           dtype=torch.int32)
    torch.testing.assert_close(ops.adc_rows(codes, ids, luts, lane_q),
                               ref.adc_rows(codes, ids, luts, lane_q),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(ops.adc_rows_q8(codes, ids, qluts, lane_q),
                       ref.adc_rows_q8(codes, ids, qluts, lane_q))


@pytest.mark.cuda
def test_cuda_adc_wrappers_raise_on_what_the_kernels_do_not_take():
    _card()
    codes = torch.zeros((10, 8), dtype=torch.uint8, device="cuda")
    luts = torch.rand((2, 8, 16), device="cuda")
    with pytest.raises(TypeError):
        ops.adc_batch(codes.int(), luts)
    with pytest.raises(ValueError, match="fit neither"):
        ops.adc_batch(codes[:, :3].contiguous(), luts)
    with pytest.raises(ValueError, match="contiguous"):
        ops.adc_batch(codes[:, ::2], luts[:, :4])
    with pytest.raises(ValueError, match="Kc in 1..256"):
        ops.adc_batch(codes, torch.rand((2, 8, 300), device="cuda"))
