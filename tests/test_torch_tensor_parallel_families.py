"""Tensor parallelism over "model" for rwkv6, recurrentgemma and whisper
(``models.rwkv6`` / ``rglru`` / ``whisper`` on a mesh, ``sharding.act``,
``serve.step``) on gloo CPU ranks, against the unsharded steps.

One spawn of 8 ranks runs three meshes: (4, 2), (2, 4) and (1, 4) (each
half of the ranks a (1, 4) mesh of its own, carved from a (2, 1, 4) one).
The smoke configs run with float32 compute, so that the order of the sums
over "model" is the only difference from the unsharded step (the
tolerances of ``tests/test_torch_tensor_parallel.py``). Every 1-D
parameter (biases, norm scales, the rwkv mixing and decay vectors, the
LRU gates' biases) is moved off its constant init. For each family:

  * one train step against the unsharded one: loss, grad norm, every
    gradient and every parameter after one AdamW step. rwkv6 runs its
    chunked WKV (``rwkv_chunk`` 8 of 16 tokens) on both head routes: its
    2 heads divide 2 "model" ranks (4, 2) and not 4 ((2, 4), (1, 4));
    recurrentgemma runs 32 tokens past its window of 16 (the windowed
    route); whisper has a vocab of 258, split over 2 "model" ranks and
    whole on 4, as whisper-medium's 51,865 is on every mesh;
  * prefill and three decode steps against the unsharded ones: the logits
    and the whole cache after the steps, from a random cache. rglru's K/V
    ring (window 16, KV = 1: split over the sequence, 4 rows a rank on 4
    ranks) decodes from position 14, so that its writes cross the wrap
    from the last rank's rows to rank 0's; rwkv6's state is split by head
    on (4, 2) and over its key dim on 4 ranks;
  * ``utils.comms.CollectiveCounter`` around each sharded train step: no
    all-gather over the "model" group but the activations' (``act``'s
    in-place gather), so no "model"-sharded parameter is gathered over
    "model";
  * rwkv6's channel mix with ``act.gather_replicated`` gives ``cm.wr`` its
    gradient, where ``act.gather_model`` would give 4 (the "model" ranks)
    times too much;
  * the sharded step's loss against the reference's ``loss_fn`` on the
    same weights, bridged (``bridge.lm_params_to_numpy``), here.

The ranks write what they saw; the unsharded steps run here on the same
seeds and the asserts are here. ~30 s.
"""
import json
import os

import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from repro_torch import bridge, configs
from repro_torch.core import distributed as D
from repro_torch.launch import train
from repro_torch.models import get_family, rwkv6
from repro_torch.optim import adamw
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.sharding import act, rules
from repro_torch.train.step import make_train_step
from repro_torch.utils.comms import CollectiveCounter

MESHES = {"4x2": (4, 2), "2x4": (2, 4), "1x4": (1, 4)}
ARCHS = ("rwkv6-1.6b", "recurrentgemma-9b", "whisper-medium")
B, PROMPT, CACHE, S_ENC, STEPS = 8, 8, 16, 16, 3
# train tokens a sequence: rglru past its window of 16
SEQ = {"rwkv6": 16, "rglru": 32}
CHUNK = 8                      # rwkv6's chunked WKV on 16 tokens
WHISPER_VOCAB = 258            # divides 2 "model" ranks, not 4
# the first decode position: rglru's ring of 16 wraps after 2 steps
START = {"rwkv6": 0, "rglru": 14, "whisper": 5}
OPT = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
# float32 compute: only the order of the sums over "model" differs (as in
# tests/test_torch_tensor_parallel.py); the parameters after one AdamW
# step within 2·lr·|Δg| / (|g| + eps), as there
RTOL, ATOL = 1e-5, 2e-6
# ... and, for a gradient or a cache leaf, LEAF_RTOL of the leaf's largest
# element on top of ATOL: differences of ~1e-7 of the activations reach
# the embedding's gradient through the first norm's 1/σ (~50: the
# embedding's scale is 0.02), and the recurrent states carry the random
# cache's O(1-10) entries. Readings: at most 2e-5 (rwkv6's gradients) and
# 3e-6 (the caches) of a leaf's largest element; a gradient summed over
# too few or too many ranks is off by tens of percent
LEAF_RTOL = 1e-4
# whisper's prefill step writes its cross-attention K/V in bfloat16 (the
# serve step's cache, as the reference's): a float32 difference at a
# bfloat16 rounding boundary moves an element by 2^-8 of itself. Its
# logits within PREFILL_BF16 of their largest (reading: 7.4e-5)
PREFILL_BF16 = 5e-4
# the sharded loss against the reference's (another framework: other
# orders of every sum, as tests/test_torch_train.py's RTOL)
REF_RTOL = 1e-4
TIMEOUT = 300
ACTIVATION_GATHER = "_all_gather(y, x.contiguous(), group=group)"


def _cfg(arch):
    cfg = configs.get_smoke_config(arch).replace(dtype="float32")
    if cfg.family == "rwkv6":
        return cfg.replace(rwkv_chunk=CHUNK)
    if cfg.family == "whisper":
        return cfg.replace(vocab=WHISPER_VOCAB)
    return cfg


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    n = cfg.dec_len if cfg.input_mode == "encdec" else SEQ[cfg.family]
    t = torch.from_numpy(rng.integers(0, cfg.vocab, (B, n)))
    out = {"tokens": t, "labels": t}
    if cfg.input_mode == "encdec":
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (B, S_ENC, cfg.d_model)).astype(np.float32))
    return out


def _mesh(name):
    if name == "1x4":
        full = init_device_mesh("cpu", (2, 1, 4),
                                mesh_dim_names=("replica", "data", "model"))
        return full["data", "model"]
    return init_device_mesh("cpu", MESHES[name],
                            mesh_dim_names=("data", "model"))


def _full(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


@torch.no_grad()
def _perturb(model, seed=5):
    """Every 1-D parameter moved by N(0, 0.1²) noise from ``seed`` (the
    same on every rank: a DTensor takes its block of it)."""
    g = torch.Generator().manual_seed(seed)
    for _, p in model.named_parameters():
        if p.dim() != 1:
            continue
        noise = 0.1 * torch.randn(p.shape, generator=g)
        if isinstance(p, DTensor):
            p._local_tensor.add_(rules.local_chunk(noise, p.device_mesh,
                                                   p.placements))
        else:
            p.add_(noise)


def _trainer(cfg, mesh=None):
    model, opt, _ = train.build_trainer(cfg, OPT, device="cpu", mesh=mesh)
    _perturb(model)
    return model, opt


def _train_step(cfg, mesh, batch):
    """One step of the (sharded with ``mesh``) trainer: -> (loss, grad
    norm, full gradients before the clip, full parameters after the step,
    collective records)."""
    model, opt = _trainer(cfg, mesh)
    grads = {}

    def capture(g):
        grads.update({k: _full(v).clone() for k, v in g.items()})
        return g
    step = make_train_step(cfg, OPT, grad_transform=capture, mesh=mesh)
    with CollectiveCounter() as cc:
        _, _, m = step(model, opt, batch)
    params = {k: _full(p).clone() for k, p in model.named_parameters()}
    # the step's own collectives (not the capture's gathers)
    records = [r for r in cc.records if not r["line"].startswith(__file__)]
    return m["loss"], m["grad_norm"], grads, params, records


def _place_model(model, mesh):
    for name, spec in rules.param_specs(model, mesh).items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        mod.register_parameter(leaf, torch.nn.Parameter(rules.place(
            mod._parameters[leaf].detach(), mesh, spec.placements)))


def _place(tree, specs, mesh):
    return {k: rules.place(v, mesh, specs[k].placements)
            for k, v in tree.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _nest(flat):
    out = {}
    for k, v in flat.items():
        *head, leaf = k.split(".")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[leaf] = v
    return out


def _serve(arch, mesh):
    """Prefill, then STEPS decode steps from a random cache at START; with
    ``mesh`` on placed weights, batch and cache. -> (prefill logits, each
    step's logits, the whole cache after the steps, each cache leaf's
    split dim over each mesh axis)."""
    cfg = _cfg(arch)
    fam = get_family(cfg)
    g = torch.Generator().manual_seed(0)
    model = fam.init(cfg, g, "cpu", param_dtype=torch.float32)
    _perturb(model)
    if cfg.family == "whisper":
        batch = {"frames": torch.randn(B, S_ENC, cfg.d_model, generator=g)}
        cache = fam.init_cache(cfg, B, CACHE, dtype=torch.float32,
                               enc_len=S_ENC, device="cpu")
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab, (B, PROMPT),
                                         generator=g)}
        cache = fam.init_cache(cfg, B, CACHE, dtype=torch.float32,
                               device="cpu")
    flat = _flat(cache)
    for k, v in flat.items():
        if v.is_floating_point():
            v.copy_(torch.randn(v.shape, generator=g))
    flat["pos"].fill_(START[cfg.family])
    toks = torch.randint(0, cfg.vocab, (STEPS, B), generator=g)
    placement = None
    if mesh is not None:
        _place_model(model, mesh)
        flat = _place(flat, rules.cache_specs(flat, mesh), mesh)
        placement = {k: [getattr(p, "dim", None) for p in v.placements]
                     for k, v in flat.items()}
        batch = _place(batch, rules.batch_specs(batch, mesh), mesh)
    cache = _nest(flat)
    prefill = make_prefill_step(cfg, mesh=mesh)(model, batch)
    decode = make_decode_step(cfg, mesh=mesh)
    logits = []
    for t in toks:
        if mesh is not None:
            t = rules.place(t, mesh, rules.batch_specs(
                {"t": t}, mesh)["t"].placements)
        lg, cache = decode(model, cache, t)
        logits.append(lg)
    return (prefill, torch.stack(logits),
            {k: _full(v) for k, v in _flat(cache).items()}, placement)


def _cm_wr_grads(mesh):
    """rwkv6's channel mix on (1, 4) (its ``wr`` split over "model"):
    ``cm.wr``'s gradient with the gather it takes
    (``act.gather_replicated``) and with ``act.gather_model`` in its place
    (the reduce-scatter backward)."""
    cfg = _cfg("rwkv6-1.6b")
    g = torch.Generator().manual_seed(11)
    x = torch.randn(2, 4, cfg.d_model, generator=g)
    xx = torch.randn(2, 4, cfg.d_model, generator=g)
    wt = torch.randn(2, 4, cfg.d_model, generator=g)
    blk = rwkv6.init(cfg, g, "cpu", param_dtype=torch.float32).layers[0]
    _place_model(blk, mesh)

    def loss(b, x, xx):
        return (rwkv6.cm_fwd(b.cm, x, xx, cfg) * wt).sum()
    out = []
    for gather in (act.gather_replicated, act.gather_model):
        blk.cm.wr.grad = None
        original, act.gather_replicated = act.gather_replicated, gather
        try:
            with act.activation_sharding(mesh, ("data",)):
                act.gathering(loss)(blk, x, xx).backward()
        finally:
            act.gather_replicated = original
        out.append(_full(blk.cm.wr.grad).clone())
    return out


def _rank8(rank, out):
    torch.set_num_threads(1)
    rec, meta = {}, {}
    for name in MESHES:
        mesh = _mesh(name)
        model_group = mesh.get_group("model").group_name
        for i, arch in enumerate(ARCHS):
            cfg = _cfg(arch)
            loss, gn, grads, params, records = _train_step(
                cfg, mesh, _batch(cfg, 1 + i))
            key = f"{name}.{arch}"
            rec[f"{key}.loss"] = loss.numpy()
            rec[f"{key}.gn"] = gn.numpy()
            rec.update({f"{key}.grad.{k}": v.numpy()
                        for k, v in grads.items()})
            rec.update({f"{key}.param.{k}": v.numpy()
                        for k, v in params.items()})
            meta[key] = [dict(r, model=r["group"] == model_group)
                         for r in records]
            prefill, logits, cache, placement = _serve(arch, mesh)
            key = f"{name}.serve.{arch}"
            rec[f"{key}.prefill"] = prefill.numpy()
            rec[f"{key}.logits"] = logits.numpy()
            rec.update({f"{key}.cache.{k}": v.numpy()
                        for k, v in cache.items()})
            meta[f"{key}.placement"] = placement
        rec[f"{name}.rows"] = np.array(
            mesh.get_local_rank("data") * (B // mesh.size(0)))
        if name == "1x4":
            rec["cm_wr"] = np.stack([t.numpy() for t in _cm_wr_grads(mesh)])
    if rank == 0:
        np.savez(os.path.join(out, "tp.npz"), **rec)
        with open(os.path.join(out, "meta.json"), "w") as fh:
            json.dump(meta, fh)


@pytest.fixture(scope="module")
def run8(tmp_path_factory):
    out = tmp_path_factory.mktemp("tpfam8")
    D.run_ranks(_rank8, 8, args=(str(out),), timeout=TIMEOUT)
    return (dict(np.load(out / "tp.npz")),
            json.loads((out / "meta.json").read_text()))


@pytest.fixture(scope="module")
def plain():
    """The unsharded steps, here, on the ranks' seeds."""
    train_out = {arch: _train_step(_cfg(arch), None,
                                   _batch(_cfg(arch), 1 + i))
                 for i, arch in enumerate(ARCHS)}
    serve_out = {arch: _serve(arch, None) for arch in ARCHS}
    return train_out, serve_out


def _close(got, want, what, leaf=False):
    """``got`` within RTOL / ATOL of ``want`` (``leaf``: a gradient or a
    cache leaf, LEAF_RTOL of its largest element more)."""
    want = want.float().numpy()
    atol = ATOL + (LEAF_RTOL * float(np.abs(want).max()) if leaf else 0.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_train_step_matches_unsharded(run8, plain, mesh, arch):
    rec, _ = run8
    loss, gn, grads, params, _ = plain[0][arch]
    key = f"{mesh}.{arch}"
    _close(rec[f"{key}.loss"], loss, f"{key} loss")
    _close(rec[f"{key}.gn"], gn, f"{key} grad norm")
    assert set(grads) == {k[len(key) + 6:] for k in rec
                          if k.startswith(f"{key}.grad.")}
    worst = 0.0
    for k, g in grads.items():
        got = rec[f"{key}.grad.{k}"]
        _close(got, g, f"{key} gradient {k}", leaf=True)
        worst = max(worst, float(np.abs(got - g.numpy()).max()))
        dg = np.abs(got - g.numpy()) + RTOL * np.abs(g.numpy())
        bound = 2 * OPT.lr * dg / (np.maximum(np.abs(got), np.abs(
            g.numpy())) + OPT.eps) + ATOL
        dp = np.abs(rec[f"{key}.param.{k}"] - params[k].numpy())
        assert (dp <= bound).all(), (key, k, float((dp - bound).max()))
    print(f"{key}: |loss diff| "
          f"{abs(float(rec[f'{key}.loss']) - float(loss)):.2e}, worst "
          f"gradient |diff| {worst:.2e}")


def _split_dim(arch, leaf, mesh):
    """The dim of ``leaf`` that ``cache_specs`` splits over "model" on
    ``mesh`` (the route each family's decode takes)."""
    cfg, m = _cfg(arch), MESHES[mesh][1]
    if cfg.family == "rwkv6":
        if leaf == "S":
            return 2 if cfg.rwkv_heads % m == 0 else 3
        return 2                           # the shifts' channels
    if cfg.family == "rglru":
        return {"k": 2, "v": 2}.get(leaf, -1)
    return 3                               # whisper's KV heads


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_serve_steps_match_unsharded(run8, plain, mesh, arch):
    rec, meta = run8
    prefill, logits, cache, _ = plain[1][arch]
    key = f"{mesh}.serve.{arch}"
    r0, rows = int(rec[f"{mesh}.rows"]), B // MESHES[mesh][0]
    if arch == "whisper-medium":
        np.testing.assert_allclose(
            rec[f"{key}.prefill"], prefill[r0:r0 + rows].numpy(), rtol=0,
            atol=PREFILL_BF16 * float(prefill.abs().max()),
            err_msg=f"{key} prefill")
    else:
        _close(rec[f"{key}.prefill"], prefill[r0:r0 + rows],
               f"{key} prefill")
    _close(rec[f"{key}.logits"], logits[:, r0:r0 + rows], f"{key} decode")
    assert set(cache) == {k[len(key) + 7:] for k in rec
                          if k.startswith(f"{key}.cache.")}
    for k, v in cache.items():
        _close(rec[f"{key}.cache.{k}"], v, f"{key} cache {k}", leaf=True)
    for k, dims in meta[f"{key}.placement"].items():
        if k == "pos":
            continue
        want = _split_dim(arch, k.rsplit(".", 1)[-1], mesh)
        n = len(cache[k].shape)
        assert dims == [1, want % n], (key, k, dims)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_no_model_sharded_parameter_gathered_over_model(run8, mesh, arch):
    """Every all-gather over the "model" group is an activation's
    (``act``'s in-place gather); the parameters are gathered over the data
    axes alone, and "model" carries the f / g pair's all-reduces."""
    _, meta = run8
    records = meta[f"{mesh}.{arch}"]
    over_model = [r for r in records if r["model"]]
    gathers = [r for r in over_model if r["op"] == "all-gather"]
    assert all(ACTIVATION_GATHER in r["line"] for r in gathers), \
        [r for r in gathers if ACTIVATION_GATHER not in r["line"]][:3]
    assert any(r["op"] == "all-reduce" for r in over_model)
    # rwkv6 gathers its channel mix's receptance, rglru its LRU input u
    # (and K / V: KV = 1); whisper's heads and K/V heads divide "model"
    assert bool(gathers) == (arch != "whisper-medium")
    data_gathers = [r for r in records if not r["model"]
                    and r["op"] == "all-gather"]
    assert bool(data_gathers) == (MESHES[mesh][0] > 1)


def test_channel_mix_receptance_gather_sums_once(run8):
    """``cm.wr``'s gradient through ``act.gather_replicated`` equals the
    unsharded one; through ``act.gather_model`` (its backward a
    reduce-scatter of a gradient that is already whole on every rank) it
    is the 4 "model" ranks' sum, 4 times too much."""
    rec, _ = run8
    good, summed = rec["cm_wr"]
    cfg = _cfg("rwkv6-1.6b")
    g = torch.Generator().manual_seed(11)
    x = torch.randn(2, 4, cfg.d_model, generator=g)
    xx = torch.randn(2, 4, cfg.d_model, generator=g)
    wt = torch.randn(2, 4, cfg.d_model, generator=g)
    blk = rwkv6.init(cfg, g, "cpu", param_dtype=torch.float32).layers[0]
    (rwkv6.cm_fwd(blk.cm, x, xx, cfg) * wt).sum().backward()
    want = blk.cm.wr.grad
    _close(good, want, "cm.wr gradient")
    _close(summed, 4 * want, "cm.wr gradient through gather_model")
    assert np.abs(want.numpy()).max() > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_matches_the_reference(run8, arch):
    """The sharded steps' loss on every mesh against the reference's
    ``loss_fn`` on the same weights (the trainer's, perturbed), bridged
    into the reference's param tree."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from _torch_parity import replace_params
    from repro.models import get_family as rfamily
    rec, _ = run8
    cfg = _cfg(arch)
    rfam = rfamily(cfg)
    model, _ = _trainer(cfg)
    params = replace_params(rfam.init(jax.random.PRNGKey(0), cfg),
                            bridge.lm_params_to_numpy(model), jnp)
    batch = _batch(cfg, 1 + ARCHS.index(arch))
    rb = {k: jnp.asarray(v.numpy(), jnp.float32 if v.is_floating_point()
                         else jnp.int32) for k, v in batch.items()}
    want = float(jax.jit(lambda p, b: rfam.loss_fn(p, b, cfg))(params, rb))
    for mesh in MESHES:
        got = float(rec[f"{mesh}.{arch}.loss"])
        assert abs(got - want) <= REF_RTOL * abs(want), (mesh, got, want)
