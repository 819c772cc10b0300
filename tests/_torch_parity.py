"""Shared helpers of the port's parity tests: carry a reference (JAX)
state into the port as numpy, replay the reference's PRP key tree, and
check the preconditions under which bit-equality is expected."""
import numpy as np
import torch

from repro_torch.core import pq

MARGIN = 1e-5      # relative / absolute margins of the stated preconditions


def jax_state_numpy(state) -> dict:
    """The reference ``ProberState`` as the port bridge's numpy dict."""
    ix = state.index
    d = {"params.a": ix.params.a, "params.b": ix.params.b,
         "params.w": ix.params.w, "x": state.x}
    for k in ("raw", "codes", "order", "bucket_codes", "bucket_starts",
              "bucket_sizes", "n_buckets", "n_valid"):
        d[k] = getattr(ix, k)
    if state.pq is not None:
        for k in ("centroids", "codes", "counts", "resid", "n_valid"):
            d[f"pq.{k}"] = getattr(state.pq, k)
        if state.pq.packed is not None:
            d["pq.packed"] = state.pq.packed
    if state.epochs is not None:
        d["epochs.params_epoch"] = state.epochs.params_epoch
        d["epochs.n_ingested"] = state.epochs.n_ingested
    return {k: np.asarray(v) for k, v in d.items()}


def _t64(a):
    return torch.from_numpy(np.array(a, np.float64))


def assert_no_assign_ties(centroids, xs):
    """Precondition of bit-equal PQ codes: no point's two nearest centroids
    (in any subspace) lie within MARGIN (relative) of each other, so two
    frameworks' distance sums pick the same argmin. ``centroids`` (M, Kc,
    ds), ``xs`` (N, M, ds)."""
    tied = pq.assign_ties(_t64(centroids), _t64(xs), MARGIN)
    assert not tied.any(), f"{int(tied.sum())} assignments within the margin"


def adc_f64(luts, codes):
    """ADC distances in float64: luts (Q, M, Kc), codes (N, M) → (Q, N)."""
    luts = np.asarray(luts, np.float64)
    codes = np.asarray(codes).astype(np.int64)
    m = luts.shape[1]
    return luts[:, np.arange(m)[None, :], codes].sum(-1)


def assert_no_adc_ties(luts, codes, taus, n_valid):
    """Precondition of ADC qualification parity: no live point's ADC
    distance within MARGIN·τ² of τ² for its query's LUT."""
    codes = torch.from_numpy(np.array(codes)[:n_valid].astype(np.int64))
    tied = pq.adc_ties(_t64(luts), codes, _t64(taus), MARGIN)
    assert not tied.any(), f"{int(tied.sum())} queries with ADC distances " \
        "at tau^2"


def assert_no_q8_ties(luts, taus, m):
    """Precondition of bit-equal uint8 LUTs and thresholds (float32 LUTs
    built by two frameworks may differ in the last bit): no entry at a
    rounding tie, no threshold at an integer (``pq.q8_ties``)."""
    tied = pq.q8_ties(_t64(luts), _t64(taus), m)
    assert not tied.any(), f"{int(tied.sum())} queries with a uint8 LUT " \
        "entry or threshold at a rounding tie"


def reference_round_keys(key, nq: int, nl: int) -> np.ndarray:
    """(Q, L, 6) int64: the uint32 words ``jax.random.bits(k, (6,))`` that
    the reference's ``estimate_batch`` draws per (query, table) lane."""
    import jax
    import jax.numpy as jnp
    out = np.zeros((nq, nl, 6), np.int64)
    for qi, kq in enumerate(jax.random.split(key, nq)):
        for t, kt in enumerate(jax.random.split(kq, nl)):
            out[qi, t] = np.asarray(jax.random.bits(kt, (6,), jnp.uint32))
    return out


def near_integer(x, a, b, w) -> np.ndarray:
    """Mask of hash values ``(x·a + b·w)/w`` within MARGIN of an integer,
    computed in float64 — where float32 codes may flip between two
    frameworks' matmul orders."""
    v = (np.asarray(x, np.float64) @ np.asarray(a, np.float64)
         + np.asarray(b, np.float64) * np.asarray(w, np.float64)) \
        / np.asarray(w, np.float64)
    return np.abs(v - np.round(v)) < MARGIN


def assert_no_tau_ties(x, qs, taus, n_valid=None):
    """Precondition of exact qualification parity: no live point's d²
    within MARGIN·τ² of any query's τ²."""
    x = np.asarray(x, np.float64)[:n_valid]
    for q, t in zip(np.asarray(qs, np.float64), np.asarray(taus, np.float64)):
        d2 = ((x - q) ** 2).sum(-1)
        tied = np.abs(d2 - t * t) <= MARGIN * t * t
        assert not tied.any(), f"{tied.sum()} d² ties at tau={t}"


def assert_no_hash_ties(x, a, b, w):
    near = near_integer(x, a, b, w)
    assert not near.any(), f"{near.sum()} hash values within {MARGIN} of an integer"


def jax_params_numpy(params, prefix: str = "") -> dict:
    """A reference param tree (nested dicts) as the port bridge's numpy
    dict: paths dot-joined (``layers.attn.wq``, ``embed.embedding``)."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(jax_params_numpy(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def randomise(d: dict, seed: int) -> dict:
    """Random biases, norm scales, and the families' constant inits (the
    rwkv mixing and decay vectors, the LRU and conv biases)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in d.items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf in ("bq", "bk", "bv", "bias", "conv_b", "b_a", "b_x"):
            v = rng.normal(0.0, 0.5, v.shape).astype(np.float32)
        elif leaf in ("scale", "q_norm", "k_norm", "ln_scale"):
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif leaf in ("mu", "mu_x", "mu_k", "mu_r"):
            v = rng.uniform(0.0, 1.0, v.shape).astype(np.float32)
        elif leaf == "w0":
            v = rng.uniform(-4.0, -1.0, v.shape).astype(np.float32)
        out[k] = v
    return out


def replace_params(tree: dict, flat: dict, jnp, prefix: str = "") -> dict:
    """``tree`` (a reference param tree) with its leaves taken from the
    dot-joined ``flat`` dict."""
    return {k: replace_params(v, flat, jnp, f"{prefix}{k}.")
            if isinstance(v, dict) else jnp.asarray(flat[f"{prefix}{k}"])
            for k, v in tree.items()}
