"""The port's dense LM (``repro_torch.models``, ``repro_torch.configs``)
against the reference's, on the CPU.

Configs field by field; each layer on the same numpy inputs; then the
whole dense family (``forward``, ``prefill``, ``decode_step`` with scalar
and per-slot positions, plain and int8 caches) on the reference's own
params carried over by ``bridge.lm_params_from_numpy``, with the biases and
norm scales set to random values so they count. Parity runs in float32
(``cfg.replace(dtype="float32")`` and float32 caches on both sides):
logits within ``ATOL`` = 1e-4 absolute (they are O(1); the two frameworks
sum in other orders, ~3e-7 seen). Then the reference's own property
``test_dense_decode_matches_forward`` (``tests/test_models.py``) on the
port, in bfloat16 with its tolerance. The machine with the card has no
jax, so this module imports it only inside the tests that use it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import jax_params_numpy
from repro_torch import bridge, configs
from repro_torch.models import get_family, layers as L, transformer as T
from repro_torch.serve import step

ATOL = 1e-4
DENSE = ("qwen2-7b", "qwen1.5-32b", "olmo-1b", "qwen2.5-3b", "pixtral-12b")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs as rconfigs
    from repro.models import get_family as rfamily, layers as rlayers
    return dict(jax=jax, jnp=jnp, configs=rconfigs, family=rfamily,
                layers=rlayers)


def _f32(arch):
    return configs.get_smoke_config(arch).replace(dtype="float32")


def _randomise(d: dict, seed: int) -> dict:
    """Random biases and norm scales / biases (the inits are 0 and 1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in d.items():
        leaf = k.rsplit(".", 1)[1]
        if leaf in ("bq", "bk", "bv", "bias"):
            v = rng.normal(0.0, 0.5, v.shape).astype(np.float32)
        elif leaf in ("scale", "q_norm", "k_norm"):
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        out[k] = v
    return out


# -------------------------------------------------------------- configs ----

@pytest.mark.parametrize("arch", configs.ARCHS)
def test_configs_equal_reference(jx, arch):
    for full in (True, False):
        get = "get_config" if full else "get_smoke_config"
        mine = getattr(configs, get)(arch)
        theirs = getattr(jx["configs"], get)(arch)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.param_count() == theirs.param_count()
        assert mine.active_param_count() == theirs.active_param_count()
        assert (mine.hd, mine.rwkv_heads) == (theirs.hd, theirs.rwkv_heads)
        assert mine.torch_dtype == getattr(torch, theirs.dtype)
    assert configs.ARCHS == jx["configs"].ARCHS


def test_qwen2_7b_full_width_parameter_count():
    cfg = configs.get_config("qwen2-7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_ff,
            cfg.vocab, cfg.qkv_bias) == (28, 3584, 28, 4, 18944, 152064,
                                         True)
    # param_count counts no biases (28 x 4,608) and no norm scales
    # (57 x 3,584); the model holds both
    assert cfg.param_count() + 28 * (3584 + 2 * 512) + 57 * 3584 == \
        7_615_616_512
    model = T.Transformer(cfg, torch.Generator(), "meta")
    assert sum(p.numel() for p in model.parameters()) == 7_615_616_512
    assert model.layers[0].attn.wq.dtype == torch.bfloat16
    assert model.layers[0].ln1.scale.dtype == torch.float32


def test_get_family_registers_dense_only():
    """Every arch's family resolves to its module (the name is older than
    the other families' port); an unknown family raises ``KeyError``."""
    from repro_torch.models import moe, rglru, rwkv6, whisper
    want = {"dense": T, "moe": moe, "rglru": rglru, "rwkv6": rwkv6,
            "whisper": whisper}
    for arch in configs.ARCHS:
        cfg = configs.get_smoke_config(arch)
        assert get_family(cfg) is want[cfg.family]
        step.make_decode_step(cfg)
    assert {configs.get_smoke_config(a).family for a in configs.ARCHS} == \
        set(want)
    with pytest.raises(KeyError, match="unknown model family"):
        get_family(configs.get_smoke_config("qwen2-7b").replace(
            family="mamba"))


# --------------------------------------------------------------- layers ----

def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm",
                                  "layernorm_nonparam"])
def test_norms_match_reference(jx, norm):
    jnp = jx["jnp"]
    cfg = configs.get_smoke_config("qwen2-7b").replace(norm=norm)
    rng = np.random.default_rng(1)
    x = _rand(rng, 3, 5, 64) * 3 + 1
    p = {}
    if norm != "layernorm_nonparam":
        p["scale"] = _rand(rng, 64)
    if norm == "layernorm":
        p["bias"] = _rand(rng, 64)
    mod = L.norm_init(cfg, 64, "cpu")
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    want = np.asarray(jx["layers"].apply_norm(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), cfg))
    with torch.no_grad():
        got = L.apply_norm(mod, torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_rope_matches_reference(jx):
    jnp = jx["jnp"]
    cfg = configs.get_smoke_config("qwen2-7b")
    rng = np.random.default_rng(2)
    pos = np.asarray([[0, 3, 17, 255]])
    x = _rand(rng, 2, 4, 4, 16)
    cos, sin = jx["layers"].rope_freqs(cfg, jnp.asarray(pos))
    want = np.asarray(jx["layers"].apply_rope(jnp.asarray(x), cos, sin))
    tc, ts = L.rope_freqs(cfg, torch.from_numpy(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(cos), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(sin), atol=1e-6)
    got = L.apply_rope(torch.from_numpy(x), tc, ts).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def _attn_pair(jx, cfg, seed):
    """The reference's attention params (random biases and qk-norm scales)
    and the port's Attention holding them."""
    p = jx["layers"].attn_init(jx["jax"].random.PRNGKey(seed), cfg)
    d = _randomise({f"a.{k}": np.asarray(v) for k, v in p.items()}, seed)
    p = {k[2:]: jx["jnp"].asarray(v) for k, v in d.items()}
    mod = L.attn_init(cfg, torch.Generator(), "meta")
    mod.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in p.items()}, assign=True)
    return p, mod


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen3-moe-30b-a3b"])
def test_qkv_project_matches_reference(jx, arch):
    """qwen2-7b: QKV bias, GQA; qwen3-moe: qk-norm (its attention is the
    dense layer's)."""
    cfg = _f32(arch)
    p, mod = _attn_pair(jx, cfg, 3)
    x = _rand(np.random.default_rng(3), 2, 6, cfg.d_model)
    pos = np.arange(6)[None, :]
    want = jx["layers"].qkv_project(p, jx["jnp"].asarray(x), cfg,
                                    jx["jnp"].asarray(pos))
    with torch.no_grad():
        got = L.qkv_project(mod, torch.from_numpy(x), cfg,
                            torch.from_numpy(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_sdpa_matches_reference_and_the_library_route(jx):
    jnp = jx["jnp"]
    cfg = _f32("qwen2-7b")                 # 4 heads over 2 KV heads
    rng = np.random.default_rng(4)
    q, k, v = (_rand(rng, 2, 5, 4, 16), _rand(rng, 2, 7, 2, 16),
               _rand(rng, 2, 7, 2, 16))
    mask = rng.random((2, 1, 5, 7)) < 0.7
    mask[..., 0] = True                    # every row attends somewhere
    want = np.asarray(jx["layers"]._sdpa(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), jnp.asarray(mask),
                                         cfg))
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
    np.testing.assert_allclose(L._sdpa(tq, tk, tv, tm, cfg).numpy(), want,
                               atol=1e-5)
    np.testing.assert_allclose(
        L.sdpa_library(tq, tk, tv, tm, cfg).numpy(), want, atol=1e-5)
    # on the CPU the route is the plain grouped form
    assert torch.equal(L.attend(tq, tk, tv, tm, cfg),
                       L._sdpa(tq, tk, tv, tm, cfg))


def test_chunked_causal_attention_matches_reference(jx):
    cfg = _f32("qwen2.5-3b")
    p, mod = _attn_pair(jx, cfg, 5)
    x = _rand(np.random.default_rng(5), 2, 21, cfg.d_model)   # S > block
    want = np.asarray(jx["layers"].chunked_causal_attention(
        p, jx["jnp"].asarray(x), cfg, block=8))
    with torch.no_grad():
        got = L.chunked_causal_attention(mod, torch.from_numpy(x), cfg,
                                         block=8)
        full = L.causal_attention(mod, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-5)


def test_kv_quantize_bit_equal(jx):
    rng = np.random.default_rng(6)
    x = _rand(rng, 3, 9, 2, 16) * rng.uniform(0.01, 30, (3, 9, 2, 1)
                                              ).astype(np.float32)
    x[0, 0, 0] = 0.0                       # an all-zero token
    x[1, 1, 1, :4] = [127.0, -127.0, 63.5, 0.5]   # rounding ties
    wq, ws = jx["layers"].kv_quantize(jx["jnp"].asarray(x))
    q, s = L.kv_quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    deq = L.kv_dequantize(q, s, torch.float32).numpy()
    np.testing.assert_array_equal(deq, np.asarray(jx["layers"].kv_dequantize(
        wq, ws, jx["jnp"].float32)))


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("per_slot", [False, True])
def test_cached_decode_matches_reference(jx, q8, per_slot):
    """One decode layer against a cache already holding 5 random rows,
    then a second step; scalar ``pos`` or per-slot (3,) positions."""
    jnp = jx["jnp"]
    cfg = _f32("qwen2-7b").replace(kv_quant=q8)
    p, mod = _attn_pair(jx, cfg, 7)
    rng = np.random.default_rng(7)
    b, s_max = 3, 12
    x = _rand(rng, 2, b, 1, cfg.d_model)
    ck, cv = (_rand(rng, b, s_max, cfg.n_kv, cfg.hd) for _ in range(2))
    if q8:
        (k8, ks), (v8, vs) = (jx["layers"].kv_quantize(jnp.asarray(c))
                              for c in (ck, cv))
        jcache = [k8, v8, ks, vs]
    else:
        jcache = [jnp.asarray(ck), jnp.asarray(cv)]
    tcache = [torch.from_numpy(np.array(c)) for c in jcache]
    pos = np.asarray([5, 2, 9], np.int32) if per_slot else np.int32(5)
    fn = "cached_decode_attention_q8" if q8 else "cached_decode_attention"
    for t in range(2):
        out = getattr(jx["layers"], fn)(p, jnp.asarray(x[t]), *jcache,
                                        jnp.asarray(pos + t), cfg)
        want, jcache = out[0], list(out[1:])
        with torch.no_grad():
            got = getattr(L, fn)(mod, torch.from_numpy(x[t]), *tcache,
                                 torch.from_numpy(np.asarray(pos + t)), cfg)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                                   atol=1e-5)
        for g, w in zip(got[1:], jcache):
            if g.dtype == torch.int8:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=1e-6)


# ---------------------------------------------------------- transformer ----

def _bridged(jx, arch, seed=1):
    cfg = _f32(arch)
    rfam = jx["family"](cfg)
    params = rfam.init(jx["jax"].random.PRNGKey(seed), cfg)
    d = _randomise(jax_params_numpy(params), seed)
    params = _replace(params, d, jx["jnp"])
    return cfg, rfam, params, bridge.lm_params_from_numpy(d, cfg, "cpu")


def _replace(tree: dict, flat: dict, jnp, prefix: str = "") -> dict:
    """``tree`` with its leaves taken from ``flat`` by path (empty dicts,
    e.g. OLMo's parameter-free norms, kept)."""
    return {k: _replace(v, flat, jnp, f"{prefix}{k}.") if isinstance(v, dict)
            else jnp.asarray(flat[f"{prefix}{k}"]) for k, v in tree.items()}


def _batches(jx, cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeds":
        e = _rand(rng, b, s, cfg.d_model)
        return {"embeds": jx["jnp"].asarray(e)}, \
            {"embeds": torch.from_numpy(e)}, None
    tok = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return {"tokens": jx["jnp"].asarray(tok)}, \
        {"tokens": torch.from_numpy(tok).long()}, tok


@pytest.mark.parametrize("arch", DENSE)
def test_transformer_matches_reference(jx, arch):
    """forward, prefill and decode_step on bridged params, float32.
    qwen1.5-32b decodes through the int8 cache (``kv_quant``), olmo-1b has
    tied embeddings and non-parametric LayerNorm, pixtral-12b takes
    embeddings (no decode: it has no token input)."""
    jax, jnp = jx["jax"], jx["jnp"]
    cfg, rfam, params, model = _bridged(jx, arch)
    b, s, max_len = 2, 7, 12
    rb, tb, tok = _batches(jx, cfg, b, s, 8)
    want = np.asarray(rfam.forward(params, rb, cfg))
    with torch.no_grad():
        got = T.forward(model, tb, cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        step.make_prefill_step(cfg)(model, tb).detach().numpy(),
        want[:, -1], rtol=0, atol=ATOL)
    rcache, rlog = rfam.prefill(params, rb, cfg, max_len=max_len,
                                dtype=jnp.float32)
    tcache, tlog = T.prefill(model, tb, cfg, max_len=max_len,
                             dtype=torch.float32)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog), atol=ATOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(rcache[k]),
                                   atol=ATOL)
    assert int(tcache["pos"]) == int(rcache["pos"]) == s
    if tok is None:
        return
    rdec = jax.jit(lambda p, c, t: rfam.decode_step(p, c, t, cfg))
    tdec = step.make_decode_step(cfg)
    for pos0 in (None, np.asarray([3, 0], np.int32)):
        rc = rfam.init_cache(cfg, b, max_len, dtype=jnp.float32)
        tc = T.init_cache(cfg, b, max_len, dtype=torch.float32, device="cpu")
        assert set(tc) == set(rc)
        if pos0 is not None:
            rc["pos"], tc["pos"] = jnp.asarray(pos0), torch.from_numpy(pos0)
        for t in range(s):
            rl, rc = rdec(params, rc, jnp.asarray(tok[:, t]))
            tl, tc = tdec(model, tc, torch.from_numpy(tok[:, t]).long())
            np.testing.assert_allclose(tl.numpy(), np.asarray(rl), rtol=0,
                                       atol=ATOL)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(rc["pos"]))
        if cfg.kv_quant:
            np.testing.assert_array_equal(tc["k"].numpy(),
                                          np.asarray(rc["k"]))


def test_loss_fn_matches_reference(jx):
    cfg, rfam, params, model = _bridged(jx, "qwen2-7b")
    tok = np.random.default_rng(9).integers(0, cfg.vocab, (2, 6))
    rb = {"tokens": jx["jnp"].asarray(tok), "labels": jx["jnp"].asarray(tok)}
    tb = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(tok)}
    with torch.no_grad():
        got = float(T.loss_fn(model, tb, cfg))
    assert got == pytest.approx(float(rfam.loss_fn(params, rb, cfg)),
                                abs=ATOL)


def test_lm_bridge_round_trip_and_shape_checks(jx):
    cfg, _, _, model = _bridged(jx, "olmo-1b")
    d = bridge.lm_params_to_numpy(model)
    assert "embed.lm_head" not in d and d["layers.attn.wq"].shape == (
        cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.hd)
    again = bridge.lm_params_to_numpy(bridge.lm_params_from_numpy(d, cfg,
                                                                  "cpu"))
    assert all(np.array_equal(again[k], d[k]) for k in d)
    with pytest.raises(KeyError, match="missing"):
        bridge.lm_params_from_numpy({k: v for k, v in d.items()
                                     if k != "embed.embedding"}, cfg, "cpu")
    with pytest.raises(ValueError, match="layers"):
        bridge.lm_params_from_numpy({**d, "layers.attn.wq":
                                     d["layers.attn.wq"][:1]}, cfg, "cpu")


def test_dense_decode_matches_forward():
    """The reference's property (``tests/test_models.py``) on the port:
    teacher-forced decode == forward logits, bfloat16, rtol = atol = 2e-2
    as there."""
    cfg = configs.get_smoke_config("qwen2-7b")
    g = torch.Generator().manual_seed(1)
    model = T.init(cfg, g, "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=g)
    with torch.no_grad():
        full = T.forward(model, {"tokens": toks}, cfg)
    cache = T.init_cache(cfg, 2, 8, device="cpu")
    outs = []
    for t in range(8):
        logits, cache = T.decode_step(model, cache, toks[:, t], cfg)
        outs.append(logits)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-2, atol=2e-2)
    assert int(cache["pos"]) == 8


@pytest.mark.cuda
def test_sdpa_route_and_bf16_decode_on_the_card(monkeypatch):
    """On the card: the SDPA route (what ``attend`` takes there) against
    plain ``_sdpa`` patched in as the route, and decode against forward,
    bfloat16 at smoke size (rtol = atol = 2e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = configs.get_smoke_config("qwen2-7b")
    g = torch.Generator(device="cuda").manual_seed(1)
    model = T.init(cfg, g, "cuda")
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=g, device="cuda")
    with torch.no_grad():
        lib = T.forward(model, {"tokens": toks}, cfg)
        with monkeypatch.context() as m:
            m.setattr(L, "attend", L._sdpa)
            plain = T.forward(model, {"tokens": toks}, cfg)
    torch.testing.assert_close(lib, plain, rtol=2e-2, atol=2e-2)
    cache = T.init_cache(cfg, 2, 8, device="cuda")
    outs = []
    for t in range(8):
        logits, cache = T.decode_step(model, cache, toks[:, t], cfg)
        outs.append(logits)
    torch.testing.assert_close(torch.stack(outs, 1), plain, rtol=2e-2,
                               atol=2e-2)
