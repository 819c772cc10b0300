"""Tensor and expert parallelism over "model" (``sharding.act``, the
rank's shares in ``models.layers`` / ``models.moe``, ``serve.step`` on a
mesh) on gloo CPU ranks, against the unsharded steps.

One spawn of 8 ranks runs three meshes: (4, 2), (2, 4) and (1, 4) (each
half of the ranks a (1, 4) mesh of its own, carved from a (2, 1, 4) one).
The smoke configs run with float32 compute, so that the order of the sums
over "model" is the only difference from the unsharded step:

  * the train steps of qwen2-7b (4 heads, KV = 2: on 4 "model" ranks a head
    a rank, the projected K/V gathered over "model") and qwen3-moe-30b-a3b
    (8 experts over "model", top-2, with drops): loss, grad norm, every
    gradient and every parameter after one AdamW step; the MoE's
    assignments and drops (``moe.dispatch``'s slots and ``keep``, forward
    and recompute) bit-equal;
  * prefill logits and three decode steps of qwen2-7b on the KV-head route
    ((4, 2): KV = 2 divides "model") and the sequence-split route ((2, 4),
    (1, 4)), of qwen1.5-32b's int8 cache and of the MoE (the whole batch
    one group) on (2, 4): the rank's logits and the whole cache after the
    steps;
  * ``utils.comms.CollectiveCounter`` around each sharded train step: no
    all-gather over the "model" group but the activations'
    (``act.gather_model``), so no "model"-sharded parameter is gathered
    over "model";
  * ``adamw.global_norm`` of a tree of DTensors placed by the rules
    counts each element once.

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

from repro_torch import configs
from repro_torch.core import distributed as D
from repro_torch.launch import train
from repro_torch.models import get_family, moe
from repro_torch.optim import adamw
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.sharding import rules
from repro_torch.train.step import make_train_step
from repro_torch.utils.comms import CollectiveCounter

MESHES = {"4x2": (4, 2), "2x4": (2, 4), "1x4": (1, 4)}
TRAIN_ARCHS = ("qwen2-7b", "qwen3-moe-30b-a3b")
# (arch, int8 KV cache, meshes): qwen2-7b's KV = 2 splits the cache over
# its KV heads on 2 "model" ranks and over the sequence on 4
SERVE = {"qwen2-7b": (False, ("4x2", "2x4", "1x4")),
         "qwen1.5-32b": (True, ("2x4",)),
         "qwen3-moe-30b-a3b": (False, ("2x4",))}
B, S, PROMPT, CACHE, STEPS = 8, 16, 12, 16, 3
OPT = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
# float32 compute: only the order of the sums over "model" differs. The
# largest entries are O(1) (logits, losses) and O(0.1) (gradients); the
# sharded steps part from the plain ones by ~1e-7 (~2e-7 of the logits,
# ~1e-7 of the embedding's gradient), so these keep ~10x over that
RTOL, ATOL = 1e-5, 2e-6
# a parameter after one AdamW step: the first step moves each weight by
# lr·g / (|g| + eps) (m and v bias-corrected), whose change for a change
# dg of the gradient is at most 2·lr·|dg| / (|g| + eps); the clip scales
# both gradients by factors equal within RTOL
TIMEOUT = 300
ACTIVATION_GATHER = "_all_gather(y, x.contiguous(), group=group)"


def _cfg(arch, quant=False):
    cfg = configs.get_smoke_config(arch).replace(dtype="float32")
    return cfg.replace(kv_quant=True) if quant else cfg


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    return {"tokens": t, "labels": t}


def _mesh(name):
    if name == "1x4":
        full = init_device_mesh("cpu", (2, 1, 4),
                                mesh_dim_names=("replica", "data", "model"))
        return full["data", "model"]
    return init_device_mesh("cpu", MESHES[name],
                            mesh_dim_names=("data", "model"))


def _full(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


def _recording_dispatch(calls):
    """``moe.dispatch`` that keeps every call's (slots, keep)."""
    dispatch = moe.dispatch

    def run(topi, n_experts, c):
        flat, keep = dispatch(topi, n_experts, c)
        calls.append((flat.clone(), keep.clone()))
        return flat, keep
    return run


def _train_step(cfg, mesh, batch):
    """One step of the (sharded with ``mesh``) trainer: -> (loss, grad
    norm, full gradients before the clip, full parameters after the step,
    dispatch calls, collective records)."""
    model, opt, _ = train.build_trainer(cfg, OPT, device="cpu", mesh=mesh)
    grads, calls = {}, []

    def capture(g):
        grads.update({k: _full(v).clone() for k, v in g.items()})
        return g
    step = make_train_step(cfg, OPT, grad_transform=capture, mesh=mesh)
    original, moe.dispatch = moe.dispatch, _recording_dispatch(calls)
    try:
        with CollectiveCounter() as cc:
            _, _, m = step(model, opt, batch)
    finally:
        moe.dispatch = original
    params = {k: _full(p).clone() for k, p in model.named_parameters()}
    # the step's own collectives (not the capture's gathers)
    records = [r for r in cc.records if not r["line"].startswith(__file__)]
    return m["loss"], m["grad_norm"], grads, params, calls, records


def _serve_model(cfg):
    """The serve checks' model: float32 weights from seed 0, the norms and
    biases moved off 1 and 0."""
    g = torch.Generator().manual_seed(0)
    model = get_family(cfg).init(cfg, g, "cpu", param_dtype=torch.float32)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return model, g


def _serve_inputs(cfg, g):
    return (torch.randint(0, cfg.vocab, (B, PROMPT), generator=g),
            torch.randint(0, cfg.vocab, (STEPS, B), generator=g))


def _place_model(model, mesh):
    for name, spec in rules.param_specs(model, mesh).items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        mod.register_parameter(leaf, torch.nn.Parameter(rules.place(
            mod._parameters[leaf].detach(), mesh, spec.placements)))


def _place(tree, specs, mesh):
    return {k: rules.place(v, mesh, specs[k].placements)
            for k, v in tree.items()}


def _serve(arch, quant, mesh):
    """Prefill and STEPS decode steps; with ``mesh`` on placed weights,
    batch and cache. -> (prefill logits, each step's logits, the whole
    cache after the steps, the K cache's split dim over each mesh axis)."""
    cfg = _cfg(arch, quant)
    fam = get_family(cfg)
    model, g = _serve_model(cfg)
    prompt, toks = _serve_inputs(cfg, g)
    cache = fam.init_cache(cfg, B, CACHE, dtype=torch.float32, device="cpu")
    batch = {"tokens": prompt}
    placement = None
    if mesh is not None:
        _place_model(model, mesh)
        cache = _place(cache, rules.cache_specs(cache, mesh), mesh)
        placement = [getattr(p, "dim", None) for p in cache["k"].placements]
        batch = _place(batch, rules.batch_specs(batch, mesh), mesh)
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
            {k: _full(v) for k, v in cache.items()}, placement)


def _global_norm_check(mesh) -> list:
    """(sharded, plain) ``global_norm`` of the smoke qwen2-7b's parameter
    shapes filled from a seed, placed by the rules."""
    cfg = _cfg("qwen2-7b")
    model = get_family(cfg).init(cfg, torch.Generator().manual_seed(3),
                                 "cpu", param_dtype=torch.float32)
    tree = {k: p.detach() for k, p in model.named_parameters()}
    specs = rules.param_specs(tree, mesh)
    placed = {k: rules.place(v, mesh, specs[k].placements)
              for k, v in tree.items()}
    return [float(adamw.global_norm(placed)), float(adamw.global_norm(tree))]


def _rank8(rank, out):
    torch.set_num_threads(1)
    rec, colls = {}, {}
    for name in MESHES:
        mesh = _mesh(name)
        model_group = mesh.get_group("model").group_name
        for i, arch in enumerate(TRAIN_ARCHS):
            loss, gn, grads, params, calls, records = _train_step(
                _cfg(arch), mesh, _batch(_cfg(arch), 1 + i))
            key = f"{name}.{arch}"
            rec[f"{key}.loss"] = loss.numpy()
            rec[f"{key}.gn"] = gn.numpy()
            rec.update({f"{key}.grad.{k}": v.numpy()
                        for k, v in grads.items()})
            rec.update({f"{key}.param.{k}": v.numpy()
                        for k, v in params.items()})
            for j, (flat, keep) in enumerate(calls):
                rec[f"{key}.slots.{j}"] = flat.numpy()
                rec[f"{key}.keep.{j}"] = keep.numpy()
            colls[key] = [dict(r, model=r["group"] == model_group)
                          for r in records]
        for arch, (quant, meshes) in SERVE.items():
            if name not in meshes:
                continue
            prefill, logits, cache, placement = _serve(arch, quant, mesh)
            key = f"{name}.serve.{arch}"
            rec[f"{key}.prefill"] = prefill.numpy()
            rec[f"{key}.logits"] = logits.numpy()
            rec.update({f"{key}.cache.{k}": v.numpy()
                        for k, v in cache.items()})
            colls[f"{key}.placement"] = placement
        rec[f"{name}.global_norm"] = np.array(_global_norm_check(mesh))
        rec[f"{name}.rows"] = np.array(
            mesh.get_local_rank("data") * (B // mesh.size(0)))
    if rank == 0:
        np.savez(os.path.join(out, "tp.npz"), **rec)
        with open(os.path.join(out, "collectives.json"), "w") as fh:
            json.dump(colls, fh)


@pytest.fixture(scope="module")
def run8(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp8")
    D.run_ranks(_rank8, 8, args=(str(out),), timeout=TIMEOUT)
    return (dict(np.load(out / "tp.npz")),
            json.loads((out / "collectives.json").read_text()))


@pytest.fixture(scope="module")
def plain():
    """The unsharded steps, here, on the ranks' seeds."""
    train_out = {arch: _train_step(_cfg(arch), None, _batch(_cfg(arch),
                                                            1 + i))
                 for i, arch in enumerate(TRAIN_ARCHS)}
    serve_out = {arch: _serve(arch, quant, None)
                 for arch, (quant, _) in SERVE.items()}
    return train_out, serve_out


def _close(got, want, what):
    np.testing.assert_allclose(got, want.numpy(), rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_train_step_matches_unsharded(run8, plain, mesh, arch):
    rec, _ = run8
    loss, gn, grads, params, _, _ = plain[0][arch]
    key = f"{mesh}.{arch}"
    _close(rec[f"{key}.loss"], loss, f"{key} loss")
    _close(rec[f"{key}.gn"], gn, f"{key} grad norm")
    assert set(grads) == {k[len(key) + 6:] for k in rec
                          if k.startswith(f"{key}.grad.")}
    worst = 0.0
    for k, g in grads.items():
        got = rec[f"{key}.grad.{k}"]
        _close(got, g, f"{key} gradient {k}")
        worst = max(worst, float(np.abs(got - g.numpy()).max()))
        # the parameter after the step, within what the gradient's
        # difference can move it (see OPT's comment)
        dg = np.abs(got - g.numpy()) + RTOL * np.abs(g.numpy())
        bound = 2 * OPT.lr * dg / (np.maximum(np.abs(got), np.abs(
            g.numpy())) + OPT.eps) + ATOL
        dp = np.abs(rec[f"{key}.param.{k}"] - params[k].numpy())
        assert (dp <= bound).all(), (key, k, float((dp - bound).max()))
    print(f"{key}: |loss diff| {abs(float(rec[f'{key}.loss']) - float(loss)):.2e}, "
          f"worst gradient |diff| {worst:.2e}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_moe_assignments_and_drops_bit_equal(run8, plain, mesh):
    rec, _ = run8
    calls = plain[0]["qwen3-moe-30b-a3b"][4]
    key = f"{mesh}.qwen3-moe-30b-a3b"
    r0, rows = int(rec[f"{mesh}.rows"]), B // MESHES[mesh][0]
    # 2 layers, forward and recompute
    assert len(calls) == 4 and f"{key}.slots.3" in rec
    dropped = 0
    for j, (flat, keep) in enumerate(calls):
        np.testing.assert_array_equal(rec[f"{key}.slots.{j}"],
                                      flat[r0:r0 + rows].numpy())
        np.testing.assert_array_equal(rec[f"{key}.keep.{j}"],
                                      keep[r0:r0 + rows].numpy())
        dropped += int((~keep).sum())
    assert dropped > 0          # the capacity bound is exercised


SERVE_CASES = [(m, a) for a, (_, meshes) in SERVE.items() for m in meshes]


@pytest.mark.parametrize("mesh,arch", SERVE_CASES)
def test_serve_steps_match_unsharded(run8, plain, mesh, arch):
    rec, colls = run8
    prefill, logits, cache, _ = plain[1][arch]
    key = f"{mesh}.serve.{arch}"
    r0, rows = int(rec[f"{mesh}.rows"]), B // MESHES[mesh][0]
    _close(rec[f"{key}.prefill"], prefill[r0:r0 + rows], f"{key} prefill")
    _close(rec[f"{key}.logits"], logits[:, r0:r0 + rows], f"{key} decode")
    for k, v in cache.items():
        _close(rec[f"{key}.cache.{k}"].astype(np.float32), v.float(),
               f"{key} cache {k}")
    # the route the cache's placement over "model" gives
    kv_heads = configs.get_smoke_config(arch).n_kv
    want = 3 if kv_heads % MESHES[mesh][1] == 0 else 2
    assert colls[f"{key}.placement"] == [1, want]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_no_model_sharded_parameter_gathered_over_model(run8, mesh, arch):
    """Every all-gather over the "model" group is an activation's
    (``act.gather_model``); the parameters are gathered over the data axes
    alone, and "model" carries the f / g pair's all-reduces."""
    _, colls = run8
    records = colls[f"{mesh}.{arch}"]
    over_model = [r for r in records if r["model"]]
    gathers = [r for r in over_model if r["op"] == "all-gather"]
    assert all(ACTIVATION_GATHER in r["line"] for r in gathers), \
        [r for r in gathers if ACTIVATION_GATHER not in r["line"]][:3]
    assert any(r["op"] == "all-reduce" for r in over_model)
    # KV = 2 (both smoke configs) does not divide 4 "model" ranks: the
    # projected K / V are gathered there, and nowhere else
    kv_gathered = _cfg(arch).n_kv % MESHES[mesh][1] != 0
    assert bool(gathers) == kv_gathered
    data_gathers = [r for r in records if not r["model"]
                    and r["op"] == "all-gather"]
    assert bool(data_gathers) == (MESHES[mesh][0] > 1)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_global_norm_counts_each_element_once(run8, mesh):
    rec, _ = run8
    sharded, whole = rec[f"{mesh}.global_norm"]
    np.testing.assert_allclose(sharded, whole, rtol=RTOL)
