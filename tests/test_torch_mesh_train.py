"""The mesh trainer (``launch.train.build_trainer(mesh=...)``, the train
step on a (data, model) mesh, checkpoints of a sharded state,
``ft.elastic.reshard``) on gloo CPU ranks.

One spawn of 8 ranks (2 data × 4 model), twin of the reference's
``test_8dev_train_step_parity``: the smoke olmo-1b's sharded step against
the reference's single-device loss and gradients, computed here from the
same weights bridged into the reference (the reference's bounds: loss
within ``LOSS_ATOL``, grad norm within ``GN_RTOL`` relative, the ``mlp/wi``
gradients within ``WI_RTOL`` / ``WI_ATOL``); each rank's local shapes of
the parameters and of ``m`` / ``v``, before and after a step; a smoke moe
step (experts over "model") and one step each of the recurrent and
encoder-decoder families (rwkv6, recurrentgemma, whisper: tensor-parallel
over the 4 "model" ranks, their non-layer parameters gathered by other
names; float32 compute) against the port's unsharded step, within the
same bounds; a checkpoint after the first step and a second step. Then one
spawn of 4 ranks restores that checkpoint onto the (2, 2) mesh that
``plan_remesh(4, 2)`` gives: the resharded parameters are bit-equal to the
checkpoint, and the second step matches the 8-rank one within the bounds;
a sharded save whose write fails on rank 0 raises there and lets the
other ranks go on, which copy nothing to the host.
The ranks write what they saw to ``.npz`` / ``.json`` files; the asserts
are here. The machine with the card has no jax: the reference's part
skips there.
"""
import json
import os

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch import bridge, configs
from repro_torch.ckpt import checkpoint
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.core import distributed as D
from repro_torch.ft import elastic
from repro_torch.ft.failures import copy_into
from repro_torch.launch import train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import adamw
from repro_torch.sharding import rules
from repro_torch.train.step import make_train_step

ARCH, MOE_ARCH = "olmo-1b", "qwen3-moe-30b-a3b"
FAMILY_ARCHS = ("rwkv6-1.6b", "recurrentgemma-9b", "whisper-medium")
B, S = 8, 16
OPT = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
LOSS_ATOL, GN_RTOL, WI_RTOL, WI_ATOL = 1e-3, 2e-2, 0.1, 1e-2
TIMEOUT = 240
WI = "mlp.wi"


def _batch(cfg, seed):
    """The smoke batch of ``cfg``'s input mode (an encoder-decoder's
    tokens are ``dec_len`` long, its frames ``S``)."""
    rng = np.random.default_rng(seed)
    n = cfg.dec_len if cfg.input_mode == "encdec" else S
    t = torch.from_numpy(rng.integers(0, cfg.vocab, (B, n)))
    out = {"tokens": t, "labels": t}
    if cfg.input_mode == "encdec":
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32))
    return out


def _capturing_step(cfg, mesh):
    """A train step that also keeps a copy of the full gradients it
    applied, taken before the clip scales them in place (every rank
    gathers; a replicated DTensor's ``full_tensor`` is its own storage,
    hence the clone)."""
    grads = {}

    def capture(g):
        grads.clear()
        grads.update({k: (v.full_tensor() if isinstance(v, DTensor)
                          else v).clone() for k, v in g.items()})
        return g
    return make_train_step(cfg, OPT, grad_transform=capture,
                           mesh=mesh), grads


def _local_shapes(model, opt) -> dict:
    out = {}
    for k, p in model.named_parameters():
        out[k] = [list(x.to_local().shape) for x in
                  (p, opt["m"][k], opt["v"][k])] + [
            [str(x) for x in p.placements],
            [[str(x) for x in t.placements] for t in (opt["m"][k],
                                                      opt["v"][k])]]
    return out


def _stacked_wi(grads: dict, cfg) -> np.ndarray:
    return np.stack([grads[f"layers.{i}.{WI}"].numpy()
                     for i in range(cfg.n_layers)])


def _unsharded_and_sharded_step(cfg, mesh, batch):
    """One step of ``cfg``'s unsharded and sharded trainers (the same
    seed) on ``batch``: -> (metrics, metrics, full gradients, full
    gradients, the sharded model)."""
    plain, popt, _ = train.build_trainer(cfg, OPT, device="cpu")
    sharded, sopt, _ = train.build_trainer(cfg, OPT, device="cpu",
                                           mesh=mesh)
    pstep, pgrads = _capturing_step(cfg, None)
    sstep, sgrads = _capturing_step(cfg, mesh)
    _, _, mp = pstep(plain, popt, batch)
    _, _, ms = sstep(sharded, sopt, batch)
    return mp, ms, pgrads, sgrads, sharded


def _family_cfg(arch):
    """A family's smoke config in float32 compute: in bfloat16 each rank
    rounds its partial sums over "model" before they are summed, which
    parts the tensor-parallel step from the plain one by as much as
    bfloat16 parts from float32 (recurrentgemma's embedding gradient:
    0.032 and 0.046 of its largest 0.375), past the bounds' absolute
    floor; in float32 the order of those sums is all that differs."""
    return configs.get_smoke_config(arch).replace(dtype="float32")


def _rank8(rank, out, batches, family_batches):
    torch.set_num_threads(1)
    mesh = make_host_mesh(model=4, device="cpu")
    cfg = configs.get_smoke_config(ARCH)
    model, opt, _ = train.build_trainer(cfg, OPT, device="cpu", mesh=mesh)
    step, grads = _capturing_step(cfg, mesh)
    shapes = {"before": _local_shapes(model, opt)}
    rec = {}
    for i, batch in enumerate(batches, 1):
        _, _, m = step(model, opt, batch)
        rec[f"loss{i}"] = m["loss"].numpy()
        rec[f"gn{i}"] = m["grad_norm"].numpy()
        rec[f"wi{i}"] = _stacked_wi(grads, cfg)
        if i == 1:
            shapes["after"] = _local_shapes(model, opt)
            params = dict(model.named_parameters())
            rec.update({f"p1.{k}": p.full_tensor().detach().numpy()
                        for k, p in params.items()})
            CheckpointManager(os.path.join(out, "ckpt")).save(
                1, {"params": params, "opt": opt})
    with open(os.path.join(out, f"shapes_{rank}.json"), "w") as fh:
        json.dump(shapes, fh)
    # moe: experts over "model", against the port's unsharded step
    mp, ms, pgrads, sgrads, sharded = _unsharded_and_sharded_step(
        configs.get_smoke_config(MOE_ARCH), mesh, family_batches[MOE_ARCH])
    wi = "layers.0.moe.wi"
    rec.update(moe_loss=np.array([float(mp["loss"]), float(ms["loss"])]),
               moe_gn=np.array([float(mp["grad_norm"]),
                                float(ms["grad_norm"])]),
               moe_wi_plain=pgrads[wi].numpy(), moe_wi=sgrads[wi].numpy(),
               moe_wi_local=np.array(sharded.get_parameter(wi)
                                     .to_local().shape))
    for arch in FAMILY_ARCHS:
        mp, ms, pgrads, sgrads, sharded = _unsharded_and_sharded_step(
            _family_cfg(arch), mesh, family_batches[arch])
        rec[f"{arch}.loss"] = np.array([float(mp["loss"]),
                                        float(ms["loss"])])
        rec[f"{arch}.gn"] = np.array([float(mp["grad_norm"]),
                                      float(ms["grad_norm"])])
        rec[f"{arch}.grads"] = np.stack([np.concatenate(
            [g[k].numpy().ravel() for k in sorted(g)])
            for g in (pgrads, sgrads)])
        rec[f"{arch}.n_sharded"] = np.array(sum(
            p.to_local().shape != p.shape for p in sharded.parameters()))
    if rank == 0:
        np.savez(os.path.join(out, "rank8.npz"), **rec)


def _rank4(rank, out, batch):
    torch.set_num_threads(1)
    plan = elastic.plan_remesh(4, 2)
    mesh = plan.make("cpu")
    cfg = configs.get_smoke_config(ARCH)
    # other weights than the 8-rank run's: the restore must replace them
    model, opt, _ = train.build_trainer(cfg, OPT, seed=1, device="cpu",
                                        mesh=mesh)
    state = {"params": dict(model.named_parameters()), "opt": opt}
    host, _, step_no = CheckpointManager(os.path.join(out, "ckpt")).restore(
        state)
    assert step_no == 1
    specs = rules.param_specs(model, mesh)
    placed = elastic.reshard(host, mesh, {"params": specs,
                                          "opt": {"m": specs, "v": specs}})
    equal = []
    for part, tree in (("params", placed["params"]),
                       ("m", placed["opt"]["m"]), ("v", placed["opt"]["v"])):
        src = host["params"] if part == "params" else host["opt"][part]
        for k, t in tree.items():
            equal.append(
                t.placements == specs[k].placements
                and torch.equal(t.to_local(), rules.local_chunk(
                    src[k], mesh, t.placements))
                and torch.equal(t.full_tensor(), src[k]))
    copy_into(state, placed)
    equal.append(all(torch.equal(p.full_tensor(), host["params"][k])
                     for k, p in model.named_parameters()))
    step, grads = _capturing_step(cfg, mesh)
    _, _, m = step(model, opt, batch)
    # a sharded save whose write fails on rank 0: every rank leaves it
    # (rank 0 reaches the barrier before it raises), and only rank 0
    # copies the gathered state to the host
    mgr = CheckpointManager(os.path.join(out, "ckpt_fail"))
    if rank == 0:
        def fail(*_):
            raise OSError("no space left")
        mgr._write = fail
    try:
        mgr.save(2, state)
        saved = "saved"
    except OSError:
        saved = "raised"
    seen = [None] * 4
    torch.distributed.all_gather_object(
        seen, [saved, checkpoint._flatten(state) is not None])
    if rank == 0:
        np.savez(os.path.join(out, "rank4.npz"), equal=np.array(equal),
                 loss2=m["loss"].numpy(), gn2=m["grad_norm"].numpy(),
                 wi2=_stacked_wi(grads, cfg),
                 step=opt["step"].numpy(), failed_save=np.array(seen))


@pytest.fixture(scope="module")
def run8(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh8")
    cfg = configs.get_smoke_config(ARCH)
    batches = [_batch(cfg, 1), _batch(cfg, 2)]
    family_batches = {a: _batch(configs.get_smoke_config(a), 3 + i)
                      for i, a in enumerate((MOE_ARCH,) + FAMILY_ARCHS)}
    D.run_ranks(_rank8, 8, args=(str(out), batches, family_batches),
                timeout=TIMEOUT)
    return out, batches, dict(np.load(out / "rank8.npz"))


def _reference_step(jax, cfg, params_np, batch):
    """The reference's single-device loss and gradients on ``params_np``
    (reference paths, dot-joined)."""
    import jax.numpy as jnp
    from _torch_parity import jax_params_numpy, replace_params
    from repro.models import get_family as rfamily
    rfam = rfamily(cfg)
    params = replace_params(rfam.init(jax.random.PRNGKey(0), cfg), params_np,
                            jnp)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: rfam.loss_fn(p, b, cfg)))(
            params, {k: jnp.asarray(v.numpy(), jnp.int32)
                     for k, v in batch.items()})
    return float(loss), jax_params_numpy(grads)


def _within_bounds(loss, want_loss, gn, want_gn, wi, want_wi, what):
    dl = abs(float(loss) - want_loss)
    dg = abs(float(gn) - want_gn) / want_gn
    dw = np.abs(wi - want_wi) - WI_RTOL * np.abs(want_wi)
    print(f"{what}: |Δloss| {dl:.3e} (≤ {LOSS_ATOL}), grad norm "
          f"{dg:.3e} relative (≤ {GN_RTOL}), gradients: worst |Δ| "
          f"beyond {WI_RTOL}·|ref| {dw.max():.3e} (≤ {WI_ATOL})")
    assert dl < LOSS_ATOL, (what, float(loss), want_loss)
    assert dg < GN_RTOL, (what, float(gn), want_gn)
    np.testing.assert_allclose(wi, want_wi, rtol=WI_RTOL, atol=WI_ATOL,
                               err_msg=what)


def test_8_rank_step_matches_reference(run8):
    jax = pytest.importorskip("jax")
    _, batches, rec = run8
    cfg = configs.get_smoke_config(ARCH)
    model = train.build_trainer(cfg, OPT, device="cpu")[0]
    loss, grads = _reference_step(jax, cfg,
                                  bridge.lm_params_to_numpy(model),
                                  batches[0])
    gn = float(np.sqrt(sum(np.sum(np.square(g.astype(np.float32)),
                                  dtype=np.float32)
                           for _, g in sorted(grads.items()))))
    _within_bounds(rec["loss1"], loss, rec["gn1"], gn, rec["wi1"],
                   grads["layers.mlp.wi"], "8 ranks vs the reference")


def test_8_ranks_hold_only_their_shards(run8):
    out, _, _ = run8
    cfg = configs.get_smoke_config(ARCH)
    model = train.build_trainer(cfg, OPT, device="cpu")[0]
    sizes = {"data": 2, "model": 4}
    specs = rules.param_specs(model, sizes)
    n_sharded = 0
    for rank in range(8):
        shapes = json.loads((out / f"shapes_{rank}.json").read_text())
        for when in ("before", "after"):
            assert set(shapes[when]) == set(specs)
            for k, (p, m, v, pl, opl) in shapes[when].items():
                want = list(model.get_parameter(k).shape)
                for axis, place in zip(sizes, specs[k].placements):
                    if isinstance(place, Shard):
                        want[place.dim] //= sizes[axis]
                assert p == m == v == want, (rank, when, k)
                assert pl == opl[0] == opl[1] == [
                    str(x) for x in specs[k].placements]
                n_sharded += want != list(model.get_parameter(k).shape)
    assert n_sharded > 0
    assert specs["layers.0.attn.wq"].placements == (Shard(0), Shard(1))


def test_8_rank_moe_step_matches_unsharded(run8):
    _, _, rec = run8
    mcfg = configs.get_smoke_config(MOE_ARCH)
    # experts over "model", d_model over "data"
    e, d, f = mcfg.n_experts, mcfg.d_model, mcfg.d_ff
    assert rec["moe_wi_local"].tolist() == [e // 4, d // 2, f]
    (lp, ls), (gp, gs) = rec["moe_loss"], rec["moe_gn"]
    _within_bounds(ls, lp, gs, gp, rec["moe_wi"], rec["moe_wi_plain"],
                   "moe, 8 ranks vs unsharded")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_8_rank_family_step_matches_unsharded(run8, arch):
    """The families whose non-layer parameters ``act.gathered`` names
    otherwise (rwkv6's and recurrentgemma's blocks, whisper's ``dec_pos``
    and encoder / decoder norms), on the tensor-parallel route: each rank
    computes its share over the 4 "model" ranks (rwkv6's 2 heads do not
    divide them: every rank runs both from the gathered projections and
    its rows of ``wo``; recurrentgemma's LRU channels, 1 of its 4 heads;
    whisper's heads and d_ff columns). Loss, grad norm and every gradient
    of the sharded step against the unsharded one."""
    _, _, rec = run8
    assert int(rec[f"{arch}.n_sharded"]) > 0
    (lp, ls), (gp, gs) = rec[f"{arch}.loss"], rec[f"{arch}.gn"]
    plain, sharded = rec[f"{arch}.grads"]
    _within_bounds(ls, lp, gs, gp, sharded, plain,
                   f"{arch}, 8 ranks vs unsharded (every gradient)")


def test_restore_onto_remeshed_4_ranks(run8):
    out, batches, rec = run8
    assert elastic.plan_remesh(4, 2) == elastic.MeshPlan(4, 2, 2)
    ckpt = CheckpointManager(out / "ckpt")
    assert ckpt.latest_step() == 1
    got = ckpt.restore({"params": {k[3:]: torch.from_numpy(v)
                                   for k, v in rec.items()
                                   if k.startswith("p1.")}})
    for k, v in got[0]["params"].items():      # rank 0 wrote the full step
        np.testing.assert_array_equal(v.numpy(), rec[f"p1.{k}"])
    D.run_ranks(_rank4, 4, args=(str(out), batches[1]), timeout=TIMEOUT)
    r4 = np.load(out / "rank4.npz")
    assert r4["equal"].all() and int(r4["step"]) == 2
    assert r4["failed_save"].tolist() == [["raised", "True"]] + [
        ["saved", "False"]] * 3
    _within_bounds(r4["loss2"], float(rec["loss2"]), r4["gn2"],
                   float(rec["gn2"]), r4["wi2"], rec["wi2"],
                   "4 ranks restored vs 8 ranks")


def test_mesh_step_on_one_rank_equals_plain_step():
    """A (1, 1) mesh on a one-rank gloo group: the DTensor trainer is
    bit-equal to the plain one (the card's M1 check, on the CPU)."""
    cfg = configs.get_smoke_config(ARCH)
    had = torch.distributed.is_initialized()
    train.join_process_group("cpu")
    try:
        mesh = make_host_mesh(device="cpu")
        a, oa, sa = train.build_trainer(cfg, OPT, microbatches=2,
                                        device="cpu")
        b, ob, sb = train.build_trainer(cfg, OPT, microbatches=2,
                                        device="cpu", mesh=mesh)
        for seed in (1, 2, 3):
            batch = _batch(cfg, seed)
            _, _, ma = sa(a, oa, batch)
            _, _, mb = sb(b, ob, batch)
            assert torch.equal(ma["loss"], mb["loss"])
            assert torch.equal(ma["grad_norm"], mb["grad_norm"])
        for k, p in a.named_parameters():
            q = b.get_parameter(k)
            assert isinstance(q, DTensor)
            assert torch.equal(p, q.to_local()), k
            assert torch.equal(oa["m"][k], ob["m"][k].to_local())
            assert torch.equal(oa["v"][k], ob["v"][k].to_local())
    finally:
        if not had:
            torch.distributed.destroy_process_group()
