"""The port's other model families (``repro_torch.models.moe``, ``rwkv6``,
``rglru``, ``whisper``) and ``layers.windowed_attention`` against the
reference's, on the CPU, at smoke size.

Parity runs in float32 (``cfg.replace(dtype="float32")`` and float32
caches on both sides) on the reference's own params carried over by
``bridge.lm_params_from_numpy``, with biases, norm scales and the
families' mixing, decay and gate constants set to random values so they
count: logits within ``ATOL`` = 1e-4 absolute (they are O(1); the two
frameworks sum in other orders). Each family's reference model is built
once per module (``pairs``). Then the reference's own properties
(``tests/test_models.py``) on the port, with their tolerances. The machine
with the card has no jax, so this module imports it only inside the tests
that use it.
"""
import numpy as np
import pytest
import torch

from _torch_parity import jax_params_numpy, randomise as _randomise, \
    replace_params as _replace
from repro_torch import bridge, configs
from repro_torch.models import (get_family, layers as L, moe as M,
                                rglru as G, rwkv6 as R, whisper as W)
from repro_torch.serve import step

ATOL = 1e-4
ARCH = {"moe": "qwen3-moe-30b-a3b", "rwkv6": "rwkv6-1.6b",
        "rglru": "recurrentgemma-9b", "whisper": "whisper-medium"}
MODULE = {"moe": M, "rwkv6": R, "rglru": G, "whisper": W}
# a stacked weight of each family, and the prefix it is stacked under
STACKED = {"moe": "layers.moe.wi", "rwkv6": "layers.tm.lora_b",
           "rglru": "groups.rec1.mix.w_a", "whisper": "dec_layers.mlp.wi"}


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import get_family as rfamily, layers as rlayers
    from repro.serve import step as rstep
    return dict(jax=jax, jnp=jnp, family=rfamily, layers=rlayers,
                step=rstep)


def _f32(fam):
    return configs.get_smoke_config(ARCH[fam]).replace(dtype="float32")


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def pairs(jx):
    """fam -> (cfg, reference module, reference params, port model), built
    once per family."""
    made = {}

    def get(fam):
        if fam not in made:
            cfg = _f32(fam)
            rfam = jx["family"](cfg)
            params = rfam.init(jx["jax"].random.PRNGKey(3), cfg)
            d = _randomise(jax_params_numpy(params), 3)
            made[fam] = (cfg, rfam, _replace(params, d, jx["jnp"]),
                         bridge.lm_params_from_numpy(d, cfg, "cpu"))
        return made[fam]
    return get


def _batches(jx, cfg, b, s, seed, s_enc=10):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    np_b = {"tokens": tok, "labels": tok}
    if cfg.input_mode == "encdec":
        np_b["frames"] = _rand(rng, b, s_enc, cfg.d_model)
    rb = {k: jx["jnp"].asarray(v) for k, v in np_b.items()}
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
          else torch.from_numpy(v) for k, v in np_b.items()}
    return rb, tb, tok


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


# ------------------------------------------------------------ attention ----

def _attn_pair(jx, cfg, seed):
    p = jx["layers"].attn_init(jx["jax"].random.PRNGKey(seed), cfg)
    d = _randomise({f"a.{k}": np.asarray(v) for k, v in p.items()}, seed)
    p = {k[2:]: jx["jnp"].asarray(v) for k, v in d.items()}
    mod = L.attn_init(cfg, torch.Generator(), "meta")
    mod.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in p.items()}, assign=True)
    return p, mod


@pytest.mark.parametrize("s", [12, 32, 40])
def test_windowed_attention_matches_reference(jx, s):
    """Window 16 (GQA 4 heads over 1): S <= W is plain causal attention,
    32 two whole chunks, 40 a padded third."""
    cfg = _f32("rglru")
    p, mod = _attn_pair(jx, cfg, 4)
    x = _rand(np.random.default_rng(s), 2, s, cfg.d_model)
    want = jx["layers"].windowed_attention(p, jx["jnp"].asarray(x), cfg)
    with torch.no_grad():
        got = L.windowed_attention(mod, torch.from_numpy(x), cfg)
    _close(got, want, 1e-5)


def test_windowed_attention_matches_causal_within_window():
    """The reference's property on the port: windowed attention equals
    full attention under a band mask (window 8, S = 24), rtol = atol =
    2e-2."""
    cfg = configs.get_smoke_config("recurrentgemma-9b").replace(window=8)
    g = torch.Generator().manual_seed(4)
    p = L.attn_init(cfg, g, "cpu")
    x = torch.randn((2, 24, cfg.d_model), generator=g)
    with torch.no_grad():
        got = L.windowed_attention(p, x, cfg)
        pos = torch.arange(24)
        q, k, v = L.qkv_project(p, x, cfg, pos[None])
        rel = pos[:, None] - pos[None, :]
        mask = ((rel >= 0) & (rel < cfg.window))[None, None]
        want = L._sdpa(q, k, v, mask, cfg) @ p.wo.to(x.dtype)
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


# ------------------------------------------------------------- families ----

@pytest.mark.parametrize("fam,s,replace", [
    ("moe", 12, {}), ("rwkv6", 12, {}),
    ("rwkv6", 40, dict(rwkv_chunk=16)),     # chunked WKV, padded chunk
    ("rglru", 12, {}), ("rglru", 40, {}),   # windowed past the window 16
    ("whisper", 12, {})])
def test_forward_prefill_and_loss_match_reference(jx, pairs, fam, s, replace):
    """``forward``, ``make_prefill_step`` and ``loss_fn`` on bridged params,
    float32."""
    cfg, rfam, params, model = pairs(fam)
    cfg = cfg.replace(**replace)
    mod = MODULE[fam]
    rb, tb, tok = _batches(jx, cfg, 2, s, 5)
    jit = jx["jax"].jit
    want = np.asarray(jit(lambda p, b: rfam.forward(p, b, cfg))(params, rb))
    with torch.no_grad():
        got = mod.forward(model, tb, cfg)
        loss = float(mod.loss_fn(model, tb, cfg))
    assert got.shape == (2, s, cfg.vocab)
    _close(got, want)
    # the reference's prefill step is forward's last position but for
    # whisper; its loss_fn is cross_entropy on forward's logits
    want_pre = (jit(jx["step"].make_prefill_step(cfg))(params, rb)
                if fam == "whisper" else want[:, -1])
    _close(step.make_prefill_step(cfg)(model, tb), want_pre)
    want_loss = jx["layers"].cross_entropy(want[:, :-1], tok[:, 1:])
    assert loss == pytest.approx(float(want_loss), abs=ATOL)


def _state_leaves(cache, prefix=""):
    """Every tensor of a (nested) cache dict but ``pos``, by path."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update(_state_leaves(v, f"{prefix}{k}."))
        elif k != "pos":
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("fam,steps,pos0", [
    ("moe", 7, [3, 0]),        # per-slot positions
    ("rwkv6", 7, None),
    ("rglru", 20, None),       # past the window 16: the K/V ring wraps
    ("whisper", 7, None)])
def test_decode_step_matches_reference(jx, pairs, fam, steps, pos0):
    """``make_decode_step`` over several steps against the reference's
    ``decode_step`` (float32 caches), then every cache field; whisper
    after ``prefill_cross`` of its encoder output."""
    jax, jnp = jx["jax"], jx["jnp"]
    cfg, rfam, params, model = pairs(fam)
    mod = MODULE[fam]
    b, max_len = 2, 32
    rb, tb, tok = _batches(jx, cfg, b, steps, 6)
    kw = {}
    if fam == "whisper":
        kw = dict(enc_len=rb["frames"].shape[1])
    rc = rfam.init_cache(cfg, b, max_len, dtype=jnp.float32, **kw)
    tc = mod.init_cache(cfg, b, max_len, dtype=torch.float32, device="cpu",
                        **kw)
    assert set(_state_leaves(tc)) == set(_state_leaves(rc))
    if fam == "whisper":
        rc = rfam.prefill_cross(params, rfam.encode(params, rb["frames"],
                                                    cfg), rc, cfg)
        with torch.no_grad():
            tc = W.prefill_cross(model, W.encode(model, tb["frames"], cfg),
                                 tc, cfg)
    if pos0 is not None:
        pos0 = np.asarray(pos0, np.int32)
        rc["pos"], tc["pos"] = jnp.asarray(pos0), torch.from_numpy(pos0)
    rdec = jax.jit(lambda p, c, t: rfam.decode_step(p, c, t, cfg))
    tdec = step.make_decode_step(cfg)
    for t in range(steps):
        rl, rc = rdec(params, rc, jnp.asarray(tok[:, t]))
        tl, tc = tdec(model, tc, torch.from_numpy(tok[:, t]).long())
        _close(tl, rl)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(rc["pos"]))
    want = _state_leaves(rc)
    for k, v in _state_leaves(tc).items():
        _close(v, want[k])


def test_whisper_encode_and_prefill_cross_match_reference(jx, pairs):
    """The encoder output, then ``prefill_cross``'s caches field by field
    (the self-attention K/V untouched)."""
    cfg, rfam, params, model = pairs("whisper")
    rb, tb, _ = _batches(jx, cfg, 2, 4, 7, s_enc=13)
    renc = rfam.encode(params, rb["frames"], cfg)
    with torch.no_grad():
        tenc = W.encode(model, tb["frames"], cfg)
    _close(tenc, renc)
    rc = rfam.prefill_cross(params, renc, rfam.init_cache(
        cfg, 2, 8, dtype=jx["jnp"].float32, enc_len=13), cfg)
    tc = W.prefill_cross(model, tenc, W.init_cache(
        cfg, 2, 8, dtype=torch.float32, enc_len=13, device="cpu"), cfg)
    for k in ("k", "v", "xk", "xv"):
        assert tc[k].shape == rc[k].shape
        _close(tc[k], rc[k])
    assert not tc["k"].any() and not tc["v"].any()


# ------------------------------------------------------------------ moe ----

def _reference_keep(jx, p, x, cfg):
    """The reference's routing and dispatch (``repro/models/moe.py``
    ``apply_moe``, its lines up to ``keep``)."""
    jax, jnp = jx["jax"], jx["jnp"]
    from repro.models import moe as rmoe
    e, k = cfg.n_experts, cfg.top_k
    b, s, _ = x.shape
    logits = (x @ p["router"].astype(x.dtype)).astype(jnp.float32)
    _, topi = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    onehot = jax.nn.one_hot(topi, e, dtype=jnp.int32)
    pos = jnp.cumsum(onehot.reshape(b, s * k, e), axis=1) - 1
    pos = jnp.sum(pos.reshape(b, s, k, e) * onehot, axis=-1)
    return np.asarray(topi), np.asarray(pos < rmoe.capacity(cfg, s))


def test_moe_capacity_drops_match_reference(jx):
    """At ``capacity_factor=0.5`` (the reference's
    ``test_moe_capacity_drops_gracefully``) ``apply_moe`` drops tokens;
    the port's output, expert choices and dropped set equal the
    reference's."""
    from repro.models import moe as rmoe
    jnp = jx["jnp"]
    cfg = _f32("moe").replace(capacity_factor=0.5)
    p = rmoe.moe_init(jx["jax"].random.PRNGKey(5), cfg)
    mod = M.MoE(cfg, torch.Generator(), "meta")
    mod.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in p.items()}, assign=True)
    x = _rand(np.random.default_rng(5), 2, 16, cfg.d_model)
    want = rmoe.apply_moe(p, jnp.asarray(x), cfg)
    rtopi, rkeep = _reference_keep(jx, p, jnp.asarray(x), cfg)
    with torch.no_grad():
        got = M.apply_moe(mod, torch.from_numpy(x), cfg)
        _, topi = M.route(mod, torch.from_numpy(x), cfg)
        _, keep = M.dispatch(topi, cfg.n_experts, M.capacity(cfg, 16))
    assert got.shape == x.shape and torch.isfinite(got).all()
    _close(got, want, 1e-5)
    np.testing.assert_array_equal(topi.numpy(), rtopi)
    np.testing.assert_array_equal(keep.numpy(), rkeep)
    assert 0 < int((~keep).sum()) < keep.numel()


def test_moe_top_k_ties_pick_lower_indices(jx):
    """Exact ties in the gates: the lower expert index first, as
    ``jax.lax.top_k`` orders them, at and inside the k boundary."""
    gates = np.asarray([[0.1, 0.3, 0.3, 0.1, 0.3, 0.2],
                        [0.2, 0.2, 0.2, 0.2, 0.2, 0.2],
                        [0.0, 0.5, 0.1, 0.5, 0.1, 0.1],
                        [0.4, 0.1, 0.1, 0.1, 0.2, 0.1]], np.float32)
    v, i = M.top_k(torch.from_numpy(gates), 3)
    np.testing.assert_array_equal(
        i.numpy(), [[1, 2, 4], [0, 1, 2], [1, 3, 2], [0, 4, 1]])
    rv, ri = jx["jax"].lax.top_k(jx["jnp"].asarray(gates), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))


# ---------------------------------------------------------- recurrences ----

def test_linear_scan_matches_sequential_and_reference(jx):
    """The doubling scan against a sequential loop and the reference's
    ``lax.associative_scan``, float32, at a length that is no power of
    two."""
    rng = np.random.default_rng(8)
    a = rng.uniform(0.0, 1.0, (2, 37, 5)).astype(np.float32)
    b = _rand(rng, 2, 37, 5)
    got = G.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    h, seq = np.zeros((2, 5), np.float32), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        seq.append(h)
    _close(got, np.stack(seq, 1), 1e-5)
    _, want = jx["jax"].lax.associative_scan(
        lambda l, r: (l[0] * r[0], l[1] * r[0] + r[1]),
        (jx["jnp"].asarray(a), jx["jnp"].asarray(b)), axis=1)
    _close(got, want, 1e-5)


def test_rwkv_chunked_equals_sequential():
    """The reference's property on the port (its shapes, chunks 16 and 64,
    rtol = atol = 2e-3)."""
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn((2, 70, 3, 8), generator=g) for _ in range(3))
    w = torch.sigmoid(torch.randn((2, 70, 3, 8), generator=g)) * 0.5 + 0.45
    u = torch.randn((3, 8), generator=g) * 0.1
    seq = R._wkv_sequential(r, k, v, w, u)
    for chunk in (16, 64):
        torch.testing.assert_close(R._wkv_chunked(r, k, v, w, u, chunk), seq,
                                   rtol=2e-3, atol=2e-3)


def _decode_all(fam, model, cfg, toks, max_len):
    cache = fam.init_cache(cfg, toks.shape[0], max_len, device="cpu")
    outs = []
    for t in range(toks.shape[1]):
        logits, cache = fam.decode_step(model, cache, toks[:, t], cfg)
        outs.append(logits)
    return torch.stack(outs, 1), cache


@pytest.mark.parametrize("arch,max_len", [("rwkv6-1.6b", 6),
                                          ("recurrentgemma-9b", 32)])
def test_recurrent_decode_matches_forward(arch, max_len):
    """The reference's ``test_rwkv_decode_matches_forward`` and
    ``test_rglru_decode_matches_forward`` on the port: teacher-forced
    decode == forward logits, bfloat16, rtol = atol = 3e-2."""
    cfg = configs.get_smoke_config(arch)
    fam = get_family(cfg)
    g = torch.Generator().manual_seed(2)
    model = fam.init(cfg, g, "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 6), generator=g)
    with torch.no_grad():
        full = fam.forward(model, {"tokens": toks}, cfg)
    dec, cache = _decode_all(fam, model, cfg, toks, max_len)
    torch.testing.assert_close(dec, full, rtol=3e-2, atol=3e-2)
    assert int(cache["pos"]) == 6


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_smoke_decode(arch):
    """The reference's ``test_smoke_decode`` on the port, for every arch:
    three greedy decode steps (whisper after ``prefill_cross``), finite
    (B, V) logits, ``pos`` == 3."""
    cfg = configs.get_smoke_config(arch)
    fam = get_family(cfg)
    g = torch.Generator().manual_seed(0)
    model = fam.init(cfg, g, "cpu")
    cache = fam.init_cache(cfg, 2, 32, device="cpu")
    if cfg.input_mode == "encdec":
        frames = torch.randn((2, 16, cfg.d_model), generator=g)
        with torch.no_grad():
            cache = fam.prefill_cross(model, fam.encode(model, frames, cfg),
                                      cache, cfg)
    tok = torch.zeros((2,), dtype=torch.long)
    dec = step.make_decode_step(cfg)
    for _ in range(3):
        logits, cache = dec(model, cache, tok)
        tok = torch.argmax(logits, -1)
    assert logits.shape == (2, cfg.vocab)
    assert torch.isfinite(logits).all()
    assert int(cache["pos"]) == 3


# --------------------------------------------------------------- bridge ----

@pytest.mark.parametrize("fam", list(ARCH))
def test_bridge_round_trip_and_checks(jx, pairs, fam):
    """to_numpy ∘ from_numpy is the identity on each family's stacked
    prefixes; a missing key and a wrong layer count raise."""
    cfg, _, params, model = pairs(fam)
    d = bridge.lm_params_to_numpy(model)
    assert set(d) == set(jax_params_numpy(params))
    again = bridge.lm_params_to_numpy(bridge.lm_params_from_numpy(d, cfg,
                                                                  "cpu"))
    assert all(np.array_equal(again[k], d[k]) for k in d)
    with pytest.raises(KeyError, match="missing"):
        bridge.lm_params_from_numpy({k: v for k, v in d.items()
                                     if k != STACKED[fam]}, cfg, "cpu")
    with pytest.raises(ValueError, match="layers"):
        bridge.lm_params_from_numpy({**d, STACKED[fam]: d[STACKED[fam]][:1]},
                                    cfg, "cpu")


@pytest.mark.parametrize("fam", list(ARCH))
def test_entry_points_default_to_the_card(fam):
    """``init`` and ``init_cache`` default to ``"cuda"`` and raise without
    a card unless the CPU is asked for: no fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    cfg = configs.get_smoke_config(ARCH[fam])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MODULE[fam].init(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MODULE[fam].init_cache(cfg, 1, 8)


# ----------------------------------------------------------------- card ----

@pytest.mark.cuda
@pytest.mark.parametrize("fam", list(ARCH))
def test_library_route_and_bf16_decode_on_the_card(monkeypatch, fam):
    """On the card, at smoke size in bfloat16: the SDPA route (what
    ``attend`` takes there) against plain ``_sdpa`` patched in as the
    route, and teacher-forced decode against forward (whisper: against
    ``decode`` on the same ``prefill_cross``; moe with the capacity of
    every token, since decode and forward group tokens differently),
    rtol = atol = 2e-2 and 3e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = configs.get_smoke_config(ARCH[fam])
    if fam == "moe":       # room for every token: forward drops none
        cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    mod = MODULE[fam]
    g = torch.Generator(device="cuda").manual_seed(1)
    model = mod.init(cfg, g, "cuda")
    toks = torch.randint(0, cfg.vocab, (2, 24), generator=g, device="cuda")
    batch = {"tokens": toks}
    if fam == "whisper":
        batch["frames"] = torch.randn((2, 20, cfg.d_model), generator=g,
                                      device="cuda")
    with torch.no_grad():
        lib = mod.forward(model, batch, cfg)
        with monkeypatch.context() as m:
            m.setattr(L, "attend", L._sdpa)
            plain = mod.forward(model, batch, cfg)
    torch.testing.assert_close(lib, plain, rtol=2e-2, atol=2e-2)
    cache = mod.init_cache(cfg, 2, 32, device="cuda",
                           **({"enc_len": 20} if fam == "whisper" else {}))
    if fam == "whisper":
        with torch.no_grad():
            cache = W.prefill_cross(model, W.encode(model, batch["frames"],
                                                    cfg), cache, cfg)
    outs = []
    for t in range(toks.shape[1]):
        logits, cache = mod.decode_step(model, cache, toks[:, t], cfg)
        outs.append(logits)
    torch.testing.assert_close(torch.stack(outs, 1), lib, rtol=3e-2,
                               atol=3e-2)
