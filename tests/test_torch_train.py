"""The port's training path (``repro_torch.train.step``, the families'
per-layer recompute, ``repro_torch.launch.train``) against the
reference's, on the CPU, at smoke size.

Gradients and train steps run in float32 (``cfg.replace(dtype=
"float32")``) on the reference's own params, biases and norm scales
randomised, carried over by ``bridge.lm_params_from_numpy``. Tolerances:
each gradient leaf within ``GRAD_RTOL`` of its largest element (the two
frameworks sum in other orders), floored at ``GRAD_FLOOR`` of the largest
gradient of the model (a leaf whose gradient is zero in exact arithmetic,
whisper's self-attention key bias, which softmax ignores, holds float32
noise only); a train step's loss, lr and grad norm within ``RTOL``, its
``m`` and ``v`` within ``RTOL`` / ``ATOL``, its params within ``RTOL``
and ``STEP_ATOL``·lr (on the first step m̂/(√v̂+ε) = g/(|g|+ε), which a
last-bit difference of a gradient near ε moves by a share of lr); with
compression, the elements whose gradient lies within ``TIE`` of an
int8 rounding boundary in the reference are left out (a last-bit
difference there moves the code by one), and so are the leaves whose
gradient is noise. Recompute leaves the gradients
bit-equal. The machine with the card has no jax, so this module imports
it only inside the tests that use it.
"""
import numpy as np
import pytest
import torch

from _torch_parity import jax_params_numpy, randomise, replace_params
from repro_torch import bridge, configs
from repro_torch.launch import train
from repro_torch.models import get_family, layers as L
from repro_torch.optim import adamw, compression
from repro_torch.train.step import make_loss_fn, make_train_step

B, S = 2, 16
GRAD_RTOL, GRAD_FLOOR = 2e-4, 1e-4
RTOL, ATOL = 1e-4, 1e-7
STEP_ATOL = 0.05
TIE = 127 * GRAD_RTOL     # the gradient tolerance in units of a code
STEP_ARCH = "qwen2.5-3b"


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import get_family as rfamily
    from repro.optim import adamw as radamw, compression as rcomp
    from repro.train import step as rstep
    return dict(jax=jax, jnp=jnp, family=rfamily, adamw=radamw,
                comp=rcomp, step=rstep)


def _np_batch(cfg, seed, b=B, s=S):
    """The reference's smoke batch shapes (``tests/test_models.py``),
    drawn with numpy."""
    rng = np.random.default_rng(seed)
    n = cfg.dec_len if cfg.input_mode == "encdec" else s
    out = {"labels": rng.integers(0, cfg.vocab, (b, n)).astype(np.int32)}
    if cfg.input_mode == "embeds":
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, n)).astype(np.int32)
    if cfg.input_mode == "encdec":
        out["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
    return out


def _torch_batch(nb):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in nb.items()}


def _pair(jx, arch, seed=3):
    """(float32 cfg, reference params, port model with float32 params)."""
    cfg = configs.get_smoke_config(arch).replace(dtype="float32")
    rfam = jx["family"](cfg)
    params = rfam.init(jx["jax"].random.PRNGKey(seed), cfg)
    d = randomise(jax_params_numpy(params), seed)
    return (cfg, replace_params(params, d, jx["jnp"]),
            bridge.lm_params_from_numpy(d, cfg, "cpu",
                                        param_dtype=torch.float32))


def _grads_np(model):
    """The port's gradients under the reference's paths; a parameter the
    loss does not reach (pixtral's embedding table) has zeros, as
    ``jax.grad`` gives it."""
    return bridge.stack_named(
        ((k, torch.zeros_like(p) if p.grad is None else p.grad)
         for k, p in model.named_parameters()), model)


def _close_leaves(got: dict, want: dict, rtol=RTOL, atol=ATOL, mask=None):
    assert set(got) == set(want)
    for k in sorted(want):
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if mask is not None and k in mask:
            g, w = g[~mask[k]], w[~mask[k]]
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_gradients_match_reference(jx, arch):
    """``loss.backward()`` (recompute on) against ``jax.grad`` of the
    reference's ``loss_fn`` on the same params and batch."""
    cfg, rparams, model = _pair(jx, arch)
    nb = _np_batch(cfg, 1)
    rfam = jx["family"](cfg)
    rloss, rgrads = jx["jax"].jit(jx["jax"].value_and_grad(
        lambda p, b: rfam.loss_fn(p, b, cfg)))(
            rparams, {k: jx["jnp"].asarray(v) for k, v in nb.items()})
    loss = make_loss_fn(cfg)(model, _torch_batch(nb))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(rloss), rtol=RTOL)
    got, want = _grads_np(model), jax_params_numpy(rgrads)
    assert set(got) == set(want)
    floor = GRAD_FLOOR * max(np.abs(w).max() for w in want.values())
    for k in sorted(want):
        w = np.asarray(want[k])
        np.testing.assert_allclose(
            got[k], w, rtol=0, atol=GRAD_RTOL * max(np.abs(w).max(), floor),
            err_msg=k)


def _grads(model, cfg, batch):
    for p in model.parameters():
        p.grad = None
    make_loss_fn(cfg)(model, batch).backward()
    return {k: p.grad.clone() for k, p in model.named_parameters()
            if p.grad is not None}


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_recompute_leaves_gradients_bit_equal(monkeypatch, arch):
    """Per-layer recompute (``layers.remat``) on and off: the same
    gradients bit for bit, in the compute dtype of the smoke config
    (bfloat16) on float32 parameters."""
    cfg = configs.get_smoke_config(arch)
    model = get_family(cfg).init(cfg, torch.Generator().manual_seed(0),
                                 "cpu", param_dtype=torch.float32)
    batch = _torch_batch(_np_batch(cfg, 2))
    calls = []
    real = L.remat

    def counting(fn, *a):
        calls.append(fn.__name__)
        return real(fn, *a)

    monkeypatch.setattr(L, "remat", counting)
    with_remat = _grads(model, cfg, batch)
    assert calls, "no layer ran under remat"
    monkeypatch.setattr(L, "remat", lambda fn, *a: fn(*a))
    without = _grads(model, cfg, batch)
    assert with_remat.keys() == without.keys()
    for k in with_remat:
        assert torch.equal(with_remat[k], without[k]), k


def test_remat_sites_are_the_reference_checkpoint_sites(monkeypatch):
    """One remat a layer (dense, moe, rwkv6), a group and a tail block
    (rglru), an encoder and a decoder layer (whisper); none without
    grad."""
    want = {"qwen2.5-3b": ["_layer_fwd"] * 2,
            "qwen3-moe-30b-a3b": ["_layer_fwd"] * 2,
            "rwkv6-1.6b": ["_layer_fwd"] * 2,
            "recurrentgemma-9b": ["_group_fwd", "_block_fwd"],
            "whisper-medium": ["_enc_layer"] * 2 + ["_dec_layer"] * 2}
    real = L.remat
    for arch, sites in want.items():
        cfg = configs.get_smoke_config(arch)
        if arch == "recurrentgemma-9b":
            cfg = cfg.replace(n_layers=4)          # one group, one tail
        calls = []

        def counting(fn, *a):
            calls.append((fn.__name__, torch.is_grad_enabled()))
            return real(fn, *a)

        monkeypatch.setattr(L, "remat", counting)
        model = get_family(cfg).init(cfg, torch.Generator().manual_seed(0),
                                     "cpu", param_dtype=torch.float32)
        batch = _torch_batch(_np_batch(cfg, 2))
        make_loss_fn(cfg)(model, batch)
        assert [c for c, _ in calls] == sites, arch
        with torch.no_grad():
            n = len(calls)
            make_loss_fn(cfg)(model, batch)
            assert not any(g for _, g in calls[n:]), arch


def test_param_dtype_storage():
    """``param_dtype=torch.float32`` stores every matrix in float32; the
    default keeps ``cfg.dtype``; bfloat16 compute gives the same loss on
    either storage of the same values."""
    cfg = configs.get_smoke_config("qwen2.5-3b")
    f32 = get_family(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu",
                               param_dtype=torch.float32)
    assert {p.dtype for p in f32.parameters()} == {torch.float32}
    bf = get_family(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert bf.layers[0].attn.wq.dtype == torch.bfloat16
    assert bf.layers[0].ln1.scale.dtype == torch.float32
    with torch.no_grad():
        for p, q in zip(f32.parameters(), bf.parameters()):
            p.copy_(q.float())
        batch = _torch_batch(_np_batch(cfg, 4))
        assert float(make_loss_fn(cfg)(f32, batch)) == float(
            make_loss_fn(cfg)(bf, batch))


def _ref_transform(jx):
    c = jx["comp"]
    return lambda g: c.decompress_tree(
        *c.compress_tree(g, c.init_state(g))[:2])


def _port_transform(model):
    """Compression of the reference's leaves: a layer stack's gradients
    stacked into one tensor (one scale, as the reference's stacked leaf
    has), compressed, dequantised and split back into the layers."""
    stacks = {name for name, m in model.named_children()
              if isinstance(m, torch.nn.ModuleList)}

    def leaf(k):                   # port name -> (reference path, layer)
        prefix, _, rest = k.partition(".")
        if prefix not in stacks:
            return k, None
        i, sub = rest.split(".", 1)
        return f"{prefix}.{sub}", int(i)

    def fn(grads):
        tree: dict = {}
        for k, g in grads.items():
            path, i = leaf(k)
            if i is None:
                tree[path] = g
            else:
                tree.setdefault(path, []).append((i, g))
        tree = {k: torch.stack([g for _, g in sorted(v)])
                if isinstance(v, list) else v for k, v in tree.items()}
        out = compression.decompress_tree(*compression.compress_tree(
            tree, compression.init_state(tree))[:2])
        return {k: out[leaf(k)[0]] if leaf(k)[1] is None
                else out[leaf(k)[0]][leaf(k)[1]] for k in grads}
    return fn


def _tie_mask(jx, rparams, cfg, batch, n):
    """Reference elements whose gradient g lies within TIE of a rounding
    boundary of g / scale (per leaf, its own scale), and every element of
    a leaf whose gradient is float32 noise (below GRAD_FLOOR of the
    largest: the key bias)."""
    rfam = jx["family"](cfg)
    grad = jx["jax"].jit(jx["jax"].grad(lambda p, b: rfam.loss_fn(p, b, cfg)))
    if n == 1:
        grads = grad(rparams, batch)
    else:
        split = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])
                 for k, v in batch.items()}
        grads = None
        for i in range(n):
            g = grad(rparams, {k: v[i] for k, v in split.items()})
            grads = g if grads is None else jx["jax"].tree_util.tree_map(
                lambda a, b: a + b, grads, g)
        grads = jx["jax"].tree_util.tree_map(lambda a: a / n, grads)
    flat = jax_params_numpy(grads)
    floor = GRAD_FLOOR * max(np.abs(g).max() for g in flat.values())
    out = {}
    for k, g in flat.items():
        r = g / (np.abs(g).max() / 127.0 + 1e-12)
        out[k] = np.abs(np.abs(r - np.floor(r)) - 0.5) < TIE
        if np.abs(g).max() < floor:      # float32 noise: codes unrelated
            out[k][...] = True
    return out


@pytest.mark.parametrize("n_micro,compress", [(1, False), (2, False),
                                              (2, True)])
def test_train_step_matches_reference(jx, n_micro, compress):
    """One ``make_train_step`` step against the reference's: loss, lr,
    grad norm, new params, m, v and step."""
    cfg, rparams, model = _pair(jx, STEP_ARCH)
    nb = _np_batch(cfg, 5, b=4)
    rb = {k: jx["jnp"].asarray(v) for k, v in nb.items()}
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    rstep = jx["step"].make_train_step(
        cfg, opt_cfg, n_microbatches=n_micro,
        grad_transform=_ref_transform(jx) if compress else None)
    rp, ro, rm = jx["jax"].jit(rstep)(rparams, jx["adamw"].init(rparams), rb)
    step = make_train_step(cfg, opt_cfg, n_microbatches=n_micro,
                           grad_transform=_port_transform(model)
                           if compress else None)
    opt = adamw.init(dict(model.named_parameters()))
    _, opt, m = step(model, opt, _torch_batch(nb))
    for k in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=RTOL,
                                   err_msg=k)
    assert int(opt["step"]) == int(ro["step"]) == 1
    assert all(p.grad is None for p in model.parameters())
    mask = _tie_mask(jx, rparams, cfg, rb, n_micro) if compress else None
    _close_leaves(bridge.lm_params_to_numpy(model), jax_params_numpy(rp),
                  atol=STEP_ATOL * opt_cfg.lr, mask=mask)
    got = bridge.adamw_state_to_numpy(opt, model)
    for part in ("m", "v"):
        want = {k: v for k, v in jax_params_numpy(ro[part]).items()}
        sub = {k[len(part) + 1:]: v for k, v in got.items()
               if k.startswith(part + ".")}
        _close_leaves(sub, want, atol=ATOL * (1 if part == "m" else 1e-3),
                      mask=mask)


def test_adamw_state_bridge_round_trip(jx):
    cfg, rparams, model = _pair(jx, "recurrentgemma-9b")
    rs = {"m": jx["jax"].tree_util.tree_map(lambda p: p * 2, rparams),
          "v": jx["jax"].tree_util.tree_map(lambda p: p * p, rparams),
          "step": jx["jnp"].asarray(7, "int32")}
    d = {f"m.{k}": v for k, v in jax_params_numpy(rs["m"]).items()}
    d.update({f"v.{k}": v for k, v in jax_params_numpy(rs["v"]).items()})
    d["step"] = np.asarray(rs["step"])
    st = bridge.adamw_state_from_numpy(d, cfg, "cpu")
    assert set(st["m"]) == {k for k, _ in model.named_parameters()}
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 7
    back = bridge.adamw_state_to_numpy(st, model)
    assert set(back) == set(d)
    for k in d:
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_smoke_train_step_lowers_the_loss(arch):
    """The reference's ``test_smoke_forward_and_train_step`` on the port:
    float32 master weights, bfloat16 compute, one step moves the loss on
    the same batch down."""
    cfg = configs.get_smoke_config(arch)
    model = get_family(cfg).init(cfg, torch.Generator().manual_seed(0),
                                 "cpu", param_dtype=torch.float32)
    batch = _torch_batch(_np_batch(cfg, 6))
    step = make_train_step(cfg, adamw.AdamWConfig(lr=1e-2, warmup_steps=1,
                                                  total_steps=10))
    _, _, m = step(model, adamw.init(dict(model.named_parameters())), batch)
    assert bool(torch.isfinite(m["loss"]))
    with torch.no_grad():
        l2 = make_loss_fn(cfg)(model, batch)
    assert float(l2) < float(m["loss"])


def test_train_step_rejects_bf16_parameters():
    cfg = configs.get_smoke_config("olmo-1b")
    model = get_family(cfg).init(cfg, torch.Generator(), "cpu")
    step = make_train_step(cfg, adamw.AdamWConfig())
    with pytest.raises(ValueError, match="float32"):
        step(model, adamw.init(dict(model.named_parameters())),
             _torch_batch(_np_batch(cfg, 0)))


def test_driver_improves_and_refuses_meshes(tmp_path, capsys):
    log = train.main(["--arch", "olmo-1b", "--scale", "smoke", "--steps",
                      "12", "--batch", "4", "--seq", "32", "--save-every",
                      "4", "--log-every", "4", "--ckpt-dir",
                      str(tmp_path / "c"), "--device", "cpu"])
    assert len(log) == 12 and log[-1]["loss"] < log[0]["loss"]
    assert "(improved)" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()   # one process: no mesh
    for flags, err, match in (
            (["--mesh", "prod"], ValueError, "needs 256 ranks"),
            (["--mesh", "prod-multi"], ValueError, "needs 512 ranks"),
            (["--model-parallel", "2"], AssertionError, None),
            (["--mesh", "host", "--model-parallel", "2"], AssertionError,
             None)):
        with pytest.raises(err, match=match):
            train.main(flags + ["--ckpt-dir", str(tmp_path / "d"),
                                "--device", "cpu"])
        assert not torch.distributed.is_initialized()
