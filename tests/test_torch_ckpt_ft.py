"""The port's checkpoints (``repro_torch.ckpt``), fault tolerance
(``repro_torch.ft``) and token pipeline (``repro_torch.data.tokens``), on
the CPU: the reference's ``tests/test_ckpt_ft.py`` (all but its elastic
plan, which needs a device mesh) and its token-pipeline test on the port,
checkpoints carried across the two packages bit for bit, and the training
driver's loop restarted after injected failures. The machine with the
card has no jax, so this module imports it only inside the tests that use
it.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager, config_hash
from repro_torch.data.tokens import TokenPipeline
from repro_torch.ft.failures import (FaultTolerantLoop, HeartbeatMonitor,
                                     WorkerFailure)
from repro_torch.ft.straggler import StragglerDetector
from repro_torch.launch import train
from repro_torch.optim import adamw


def _tiny_state(seed):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((4, 4), generator=g),
                       "b": torch.zeros((4,))},
            "count": torch.zeros((), dtype=torch.int32)}


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    st = _tiny_state(0)
    mgr.save(5, st, extra={"pipeline": {"seed": 1, "step": 5}})
    got = mgr.restore(st)
    assert got is not None
    restored, extra, step = got
    assert step == 5 and extra["pipeline"]["step"] == 5
    assert torch.equal(restored["params"]["w"], st["params"]["w"])
    assert restored["count"].dtype == torch.int32
    assert restored["params"]["w"] is not st["params"]["w"]


def test_retention_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    st = _tiny_state(0)
    for s in (1, 2, 3, 4):
        mgr.save(s, st)
    assert mgr.latest_step() == 4
    kept = sorted(p.name for p in Path(tmp_path).glob("step_*"))
    assert kept == ["step_00000003", "step_00000004"]


def test_torn_save_falls_back(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    st = _tiny_state(0)
    mgr.save(1, st)
    mgr.save(2, st)
    # corrupt the newest: delete its manifest (simulates a torn write)
    (Path(tmp_path) / "step_00000002" / "manifest.json").unlink()
    assert mgr.latest_step() == 1
    got = mgr.restore(st)
    assert got[2] == 1


def test_async_save(tmp_path):
    mgr = CheckpointManager(tmp_path)
    st = _tiny_state(1)
    mgr.save_async(7, st)
    mgr.wait()
    assert mgr.latest_step() == 7


def test_async_save_snapshots_before_returning(tmp_path):
    """An in-place update right after ``save_async`` (the next AdamW step)
    does not reach the checkpoint."""
    mgr = CheckpointManager(tmp_path)
    st = _tiny_state(2)
    want = st["params"]["w"].clone()
    mgr.save_async(3, st)
    st["params"]["w"].add_(1.0)
    mgr.wait()
    assert torch.equal(mgr.restore(st)[0]["params"]["w"], want)


def test_restore_checks_shapes_and_bf16_round_trips(tmp_path):
    mgr = CheckpointManager(tmp_path)
    st = {"w": torch.randn(3, 5).to(torch.bfloat16)}
    mgr.save(1, st)
    assert torch.equal(mgr.restore(st)[0]["w"], st["w"])
    with pytest.raises(ValueError, match="w"):
        mgr.restore({"w": torch.zeros(5, 3)})
    assert config_hash({"a": 1}) == config_hash({"a": 1}) != config_hash(2)


# --------------------------------------------------- across the packages ----

def _ref_state(jax, jnp, radamw):
    """A reference state with an AdamW state three steps in."""
    params = {"w": jax.random.normal(jax.random.PRNGKey(0), (4, 4)),
              "b": jnp.arange(4.0)}
    opt = radamw.init(params)
    cfg = radamw.AdamWConfig(lr=1e-2, warmup_steps=1)
    for i in range(3):
        grads = {"w": jax.random.normal(jax.random.PRNGKey(i + 1), (4, 4)),
                 "b": jnp.ones(4) * i}
        params, opt, _ = radamw.update(grads, opt, params, cfg)
    return {"params": params, "opt": opt, "count": jnp.asarray(3, "int32")}


def _template(params_like):
    p = {k: torch.zeros(v.shape) for k, v in params_like.items()}
    return {"params": p, "opt": adamw.init(p),
            "count": torch.zeros((), dtype=torch.int32)}


def _equal(port, ref):
    ref_leaves = dict(_ref_leaves(ref))
    port_leaves = dict(adamw.leaves(port))
    assert port_leaves.keys() == ref_leaves.keys()
    for k, v in port_leaves.items():
        r = np.asarray(ref_leaves[k])
        assert v.numpy().dtype == r.dtype, k
        assert v.numpy().tobytes() == r.tobytes(), k


def _ref_leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _ref_leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.ckpt.checkpoint import CheckpointManager as RefManager
    from repro.optim import adamw as radamw
    ref = _ref_state(jax, jnp, radamw)
    RefManager(tmp_path).save(3, ref, extra={"pipeline": {"seed": 0,
                                                          "step": 3}})
    got = CheckpointManager(tmp_path).restore(_template(ref["params"]))
    assert got[2] == 3 and got[1]["pipeline"]["step"] == 3
    _equal(got[0], ref)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.ckpt.checkpoint import CheckpointManager as RefManager
    from repro.optim import adamw as radamw
    ref = _ref_state(jax, jnp, radamw)
    port = CheckpointManager(tmp_path / "a").restore(_template(ref["params"]))
    assert port is None
    RefManager(tmp_path / "a").save(3, ref)
    port = CheckpointManager(tmp_path / "a").restore(
        _template(ref["params"]))[0]
    mgr = CheckpointManager(tmp_path / "b")
    mgr.save_async(9, port)
    mgr.wait()
    back = RefManager(tmp_path / "b").restore(ref)
    assert back[2] == 9
    _equal(port, back[0])
    manifest = json.loads((tmp_path / "b" / "step_00000009" /
                           "manifest.json").read_text())
    assert manifest["leaves"] == sorted(k for k, _ in _ref_leaves(ref))


# ------------------------------------------------------ fault tolerance ----

class XYPipeline(TokenPipeline):
    def _batch_at(self, step):
        g = torch.Generator().manual_seed(self.seed * 1000 + step)
        x = torch.randn((8, 4), generator=g)
        return {"x": x, "y": x @ torch.eye(4)}


def _make_loop(tmp_path, save_every=5):
    opt_cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=100)

    def step_fn(state, batch):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in state["params"].items()}
        loss = torch.mean((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2)
        loss.backward()
        grads = {k: v.grad for k, v in p.items()}
        p = {k: v.detach() for k, v in p.items()}
        opt = {"m": {k: v.clone() for k, v in state["opt"]["m"].items()},
               "v": {k: v.clone() for k, v in state["opt"]["v"].items()},
               "step": state["opt"]["step"].clone()}
        adamw.update(grads, opt, p, opt_cfg)
        return {"params": p, "opt": opt}, {"loss": loss.detach()}

    params = {"w": torch.randn((4, 4), generator=torch.Generator()
                               .manual_seed(0)), "b": torch.zeros((4,))}
    state = {"params": params, "opt": adamw.init(params)}
    pipeline = XYPipeline(vocab=1, batch=8, seq=1, seed=0, device="cpu")
    mgr = CheckpointManager(tmp_path, keep=3)
    return FaultTolerantLoop(step_fn, mgr, pipeline,
                             save_every=save_every), state


def _fail_at(steps):
    fired = set()

    def inject(step):
        if step in steps and step not in fired:
            fired.add(step)
            return True
        return False
    return inject


def test_ft_loop_identical_with_and_without_failures(tmp_path):
    """Injected failures + restore reproduce the exact no-failure run
    (functional steps: each returns new tensors)."""
    loop_a, state_a = _make_loop(tmp_path / "a")
    final_a, log_a = loop_a.run(state_a, 20)
    loop_b, state_b = _make_loop(tmp_path / "b")
    final_b, log_b = loop_b.run(state_b, 20, inject=_fail_at({7, 13}))
    assert loop_b.restarts == 2
    assert torch.equal(final_a["params"]["w"], final_b["params"]["w"])
    assert log_a[-1]["loss"] == log_b[-1]["loss"]


def _driver_args(ckpt_dir):
    return train.parse_args(["--arch", "qwen2.5-3b", "--steps", "12",
                             "--batch", "4", "--seq", "16", "--microbatches",
                             "2", "--save-every", "4", "--ckpt-dir",
                             str(ckpt_dir), "--device", "cpu"])


def test_driver_loop_restarts_in_place(tmp_path):
    """The driver's loop (its step updates the model in place) with
    failures at steps 5 and 9 ends bit-equal to the uninterrupted run:
    each restore copies the checkpoint into the model's tensors."""
    loop_a, state_a, _ = train.build_loop(_driver_args(tmp_path / "a"))
    _, log_a = loop_a.run(state_a, 12)
    loop_b, state_b, _ = train.build_loop(_driver_args(tmp_path / "b"))
    params_b = state_b["params"]["layers.0.attn.wq"]
    _, log_b = loop_b.run(state_b, 12, inject=_fail_at({5, 9}))
    assert loop_b.restarts == 2
    assert state_b["params"]["layers.0.attn.wq"] is params_b
    assert len(log_b) == 14                  # steps 5 and 9 run twice
    assert {r["step"]: r["loss"] for r in log_a} == \
        {r["step"]: r["loss"] for r in log_b}
    for (k, a), (_, b) in zip(adamw.leaves(state_a), adamw.leaves(state_b)):
        assert torch.equal(a, b), k


def test_heartbeat_monitor():
    hb = HeartbeatMonitor(4, timeout=10.0)
    for r in range(4):
        hb.beat(r, now=100.0)
    hb.beat(2, now=200.0)
    assert sorted(hb.dead_ranks(now=205.0)) == [0, 1, 3]


def test_straggler_detector():
    det = StragglerDetector(threshold=1.5)
    for step in range(6):
        for rank in range(8):
            det.record(rank, 1.0 if rank != 3 else 2.5)
    assert det.stragglers() == [3]
    assert det.mitigation(3) in ("rebalance", "evict")


def test_worker_failure_past_max_restarts_raises(tmp_path):
    loop, state = _make_loop(tmp_path)
    loop.max_restarts = 1
    with pytest.raises(WorkerFailure):
        loop.run(state, 10, inject=lambda step: step == 2)


# ------------------------------------------------------- token pipeline ----

def test_token_pipeline_deterministic_and_restartable():
    p1 = TokenPipeline(vocab=100, batch=4, seq=8, seed=7, device="cpu")
    seq = [p1.next()["tokens"] for _ in range(5)]
    # restart from a checkpointed cursor reproduces the stream
    p2 = TokenPipeline(vocab=100, batch=4, seq=8, seed=7, device="cpu")
    p2.load_state_dict({"seed": 7, "step": 3})
    assert torch.equal(p2.next()["tokens"], seq[3])
    assert torch.equal(p2.next()["tokens"], seq[4])
    # bigram structure: odd positions depend on even ones
    t = seq[0].numpy()
    assert ((t[:, 1::2] - t[:, 0::2]) % 100 <= 16).all()
    assert ((t[:, 1::2] - t[:, 0::2]) % 100 >= 1).all()
    b = p1._batch_at(0)
    assert b["labels"] is b["tokens"] and b["tokens"].dtype == torch.int64
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 100
    assert not torch.equal(seq[0], seq[1])


def test_token_pipeline_marginal_is_the_reference_construction():
    """The even positions follow floor(-log(1-u)·V/8) clipped to [0, V):
    a geometric law of mean 1/(e^(8/V) - 1), 7.51 at V = 64 (8,192
    draws: the mean's standard error is 0.09)."""
    p = TokenPipeline(vocab=64, batch=256, seq=64, seed=1, device="cpu")
    even = p.next()["tokens"][:, 0::2].double()
    assert abs(float(even.mean()) - 1 / np.expm1(8 / 64)) < 0.3


def test_token_pipeline_defaults_to_the_card():
    p = TokenPipeline(vocab=10, batch=1, seq=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            p.next()
