"""Port of the LSH index, PRP and Chernoff bounds against the reference:
``ProberConfig`` fields, ``_prp_eval`` bit-equality, ``sampling`` values,
and the sorted-CSR layout (packed sort, K-pass fallback, capacity padding,
growth) fed the reference's own codes."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import near_integer
from repro.core import config as jconfig, lsh as jlsh, prober as jprober, \
    sampling as jsampling
from repro_torch.core import config, lsh, prober, sampling

CFG = config.ProberConfig(n_tables=2, n_funcs=8)
JCFG = jconfig.ProberConfig(n_tables=2, n_funcs=8)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_config_fields_and_defaults_equal_reference():
    mine = [(f.name, f.default) for f in dataclasses.fields(config.ProberConfig)]
    theirs = [(f.name, f.default)
              for f in dataclasses.fields(jconfig.ProberConfig)]
    assert mine == theirs
    assert config.ProberConfig().a_const == jconfig.ProberConfig().a_const


@pytest.mark.parametrize("nbits", range(13))
def test_prp_eval_bit_equal(nbits):
    r = np.random.default_rng(nbits)
    rks = r.integers(0, 2 ** 32, 6, dtype=np.uint64).astype(np.uint32)
    idx = np.arange((1 << nbits) + 300, dtype=np.int32)
    mask = (1 << nbits) - 1
    want = np.asarray(jprober._prp_eval(jnp.asarray(idx), jnp.asarray(rks),
                                        jnp.int32(mask), jnp.int32(nbits)))
    got = prober._prp_eval(_t(idx)[None], _t(rks.astype(np.int64))[None],
                           torch.tensor([mask]), torch.tensor([nbits]))[0]
    np.testing.assert_array_equal(got.numpy(), want)
    assert sorted(got[:1 << nbits].tolist()) == list(range(1 << nbits))


def test_sampling_bounds_match_reference():
    p = np.linspace(0.0, 1.0, 41, dtype=np.float32)
    w = np.array([0.0, 1.0, 3.0, 17.0, 128.0, 1000.0, 4096.0], np.float32)
    pp, ww = [a.ravel() for a in np.meshgrid(p, w)]
    a, eps = JCFG.a_const, JCFG.eps
    for fn in ("mu_upper", "mu_lower"):
        got = getattr(sampling, fn)(_t(pp), _t(ww), a).numpy()
        want = np.asarray(getattr(jsampling, fn)(pp, ww, a))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    for fn in ("stop_sampling", "stop_probing"):
        got = getattr(sampling, fn)(_t(pp), _t(ww), a, eps).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(getattr(jsampling, fn)(pp, ww, a, eps)))


def _assert_tables_equal(got, want):
    names = ("order", "bucket_codes", "bucket_starts", "bucket_sizes",
             "n_buckets")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(0).standard_normal((1500, 24),
                                                    dtype=np.float32)


@pytest.fixture(scope="module")
def jindex(data):
    return jlsh.build_index(jnp.asarray(data), JCFG, jax.random.PRNGKey(0))


@pytest.mark.parametrize("n_valid", [None, 1100, 0])
def test_build_table_packed_path_bit_equal(jindex, n_valid):
    codes = np.asarray(jindex.codes)
    assert bool(jlsh._pack_fits(jnp.asarray(codes)))     # packed path
    for t in range(codes.shape[0]):
        want = jlsh._build_table(jnp.asarray(codes[t]), n_valid)
        _assert_tables_equal(lsh._build_table(_t(codes[t]), n_valid), want)


@pytest.mark.parametrize("n_valid", [None, 700])
def test_build_table_kpass_fallback_bit_equal(n_valid):
    r = np.random.default_rng(1)
    codes = r.integers(-5, 3, (1000, 7)).astype(np.int32)
    codes[:, 2] = r.integers(0, 100, 1000)      # a column range > 63
    assert not bool(jlsh._pack_fits(jnp.asarray(codes)))
    want = jlsh._build_table(jnp.asarray(codes), n_valid)
    _assert_tables_equal(lsh._build_table(_t(codes), n_valid), want)


def test_lexsort_puts_dead_rows_last():
    r = np.random.default_rng(2)
    codes = r.integers(-3, 4, (300, 10)).astype(np.int32)
    valid = np.arange(300) < 200
    codes[~valid] = lsh.CODE_SENTINEL
    want = np.asarray(jlsh.lexsort_rows(jnp.asarray(codes),
                                        valid=jnp.asarray(valid)))
    got = lsh.lexsort_rows(_t(codes), valid=_t(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[200:] >= 200).all()


def test_normalize_w_bit_equal_with_masking(jindex):
    raw = np.asarray(jindex.raw)
    for nv in (None, 900):
        want = np.asarray(jlsh.normalize_w(jnp.asarray(raw), 4, nv))
        got = lsh.normalize_w(_t(raw), 4, nv).numpy()
        np.testing.assert_array_equal(got, want)


def test_build_index_with_injected_params(data, jindex):
    """The same hash functions over the same points: codes equal outside
    the float margin (two matmul orders), and then the CSR bit-equal."""
    p = jindex.params
    params = lsh.LSHParams(*map(_t, (p.a, p.b, p.w)))
    for n_valid in (None, 1200):
        want = jlsh.build_index(jnp.asarray(data), JCFG,
                                jax.random.PRNGKey(1), params=p,
                                n_valid=n_valid)
        got = lsh.build_index(_t(data), CFG, params=params, n_valid=n_valid)
        near = near_integer(data, p.a, p.b, p.w)
        near = near.reshape(len(data), 2, 8).transpose(1, 0, 2)
        if n_valid is not None:
            near[:, n_valid:] = False
        flips = int((got.codes.numpy() != np.asarray(want.codes)).sum())
        print(f"build_index: {flips} codes differ; {int(near.sum())} "
              f"values lie within the margin")
        np.testing.assert_array_equal(got.codes.numpy()[~near],
                                      np.asarray(want.codes)[~near])
        assert not near.any(), "precondition: no hash value at the margin"
        _assert_tables_equal(
            (got.order, got.bucket_codes, got.bucket_starts,
             got.bucket_sizes, got.n_buckets),
            (want.order, want.bucket_codes, want.bucket_starts,
             want.bucket_sizes, want.n_buckets))
        assert int(got.n_valid) == int(want.n_valid)


def test_grow_capacity_bit_equal(data):
    want0 = jlsh.build_index(jnp.asarray(np.pad(data, ((0, 548), (0, 0)))),
                             JCFG, jax.random.PRNGKey(0), n_valid=1500)
    ix = jlsh.LSHIndex(*(jax.tree_util.tree_map(np.asarray, f)
                         for f in want0))
    mine = lsh.LSHIndex(lsh.LSHParams(*map(_t, ix.params)),
                        *map(_t, ix[1:]))
    want = jlsh.grow_capacity(want0, 4096)
    got = lsh.grow_capacity(mine, 4096)
    assert got.raw.shape == (4096, 16) and got.bucket_codes.shape[1] == 4096
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.raw.numpy(), np.asarray(want.raw))
    _assert_tables_equal(
        (got.order, got.bucket_codes, got.bucket_starts, got.bucket_sizes,
         got.n_buckets),
        (want.order, want.bucket_codes, want.bucket_starts,
         want.bucket_sizes, want.n_buckets))


def test_projections_match_reference(data, jindex):
    p = jindex.params
    params = lsh.LSHParams(*map(_t, (p.a, p.b, p.w)))
    for fn in ("project_raw", "project"):
        want = np.asarray(getattr(jlsh, fn)(p, jnp.asarray(data)))
        got = getattr(lsh, fn)(params, _t(data)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_hash_point_matches_reference(data, jindex):
    p = jindex.params
    params = lsh.LSHParams(*map(_t, (p.a, p.b, p.w)))
    qs = data[:50] + 0.01
    want = np.asarray(jlsh.hash_point(p, jnp.asarray(qs), 2))
    got = lsh.hash_point(params, _t(qs), 2).numpy()
    near = near_integer(qs, p.a, p.b, p.w).reshape(50, 2, 8)
    assert got.shape == (50, 2, 8)
    np.testing.assert_array_equal(got[~near], want[~near])
