"""The port's AdamW (``repro_torch.optim.adamw``) and int8 gradient
compression (``repro_torch.optim.compression``) against the reference's,
on the CPU.

The same numpy draws go through both. Tolerances (float32): the schedule
within ``SCHED_RTOL`` (XLA's and torch's float32 ``cos`` and ``pow`` may
differ in the last bit); norms, params, ``m`` and ``v`` after several
steps within ``RTOL`` / ``ATOL`` (the two frameworks sum in other orders);
``step`` and the int8 codes and scales equal. The machine with the card
has no jax, so this module imports it only inside the tests that use it.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import distributed as D
from repro_torch.optim import adamw, compression

SCHED_RTOL = 1e-6
RTOL, ATOL = 1e-5, 1e-8
SHAPES = {"w": (8, 16), "b": (16,), "blk": {"u": (4, 4), "a": (3,)}}
CFG = adamw.AdamWConfig(lr=3e-3, warmup_steps=3, total_steps=12,
                        weight_decay=0.1, clip_norm=1.0)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.optim import adamw as radamw, compression as rcomp
    return dict(jax=jax, jnp=jnp, adamw=radamw, comp=rcomp)


def _draw(rng, shapes, scale=1.0):
    return {k: _draw(rng, v, scale) if isinstance(v, dict)
            else (rng.standard_normal(v) * scale).astype(np.float32)
            for k, v in shapes.items()}


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _torch(tree):
    return _map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, rtol=RTOL, atol=ATOL):
    for (k, g), (_, w) in zip(adamw.leaves(got), adamw.leaves(want),
                              strict=True):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=k)


def test_schedule_matches_reference(jx):
    for step in range(CFG.total_steps + 2):
        want = jx["adamw"].schedule(CFG, jx["jnp"].asarray(step, "int32"))
        got = adamw.schedule(CFG, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=SCHED_RTOL)


def test_leaves_follow_the_reference_tree_order(jx):
    tree = _draw(np.random.default_rng(0), SHAPES)
    want = jx["jax"].tree_util.tree_leaves(tree)
    got = [v for _, v in adamw.leaves(tree)]
    assert len(got) == len(want)
    assert all(g is w for g, w in zip(got, want))


@pytest.mark.parametrize("scale", [0.01, 3.0])   # under and over the clip
def test_global_norm_and_clip_match_reference(jx, scale):
    g = _draw(np.random.default_rng(1), SHAPES, scale)
    want_n = jx["adamw"].global_norm(g)
    np.testing.assert_allclose(float(adamw.global_norm(_torch(g))),
                               float(want_n), rtol=RTOL)
    want_g, want_norm = jx["adamw"].clip_by_global_norm(g, CFG.clip_norm)
    got_g, got_norm = adamw.clip_by_global_norm(_torch(g), CFG.clip_norm)
    np.testing.assert_allclose(float(got_norm), float(want_norm), rtol=RTOL)
    _close(got_g, want_g)


def test_update_matches_reference_over_steps(jx):
    """Several steps on the same params, grads and state (warmup, the
    clip's both sides, the cosine decay): params, m, v and step."""
    jnp = jx["jnp"]
    rng = np.random.default_rng(2)
    p_np = _draw(rng, SHAPES)
    rp = _map(jnp.asarray, p_np)
    rs = jx["adamw"].init(rp)
    tp = _torch(p_np)
    ts = adamw.init(tp)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 0
    for i in range(6):
        g = _draw(rng, SHAPES, 0.05 if i % 2 else 2.0)
        rp, rs, rm = jx["adamw"].update(_map(jnp.asarray, g), rs, rp, CFG)
        tp2, ts2, tm = adamw.update(_torch(g), ts, tp, CFG)
        assert tp2 is tp and ts2 is ts                # in place
        assert int(ts["step"]) == int(rs["step"]) == i + 1
        np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]),
                                   rtol=SCHED_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=RTOL)
        _close(tp, rp)
        _close(ts["m"], rs["m"])
        _close(ts["v"], rs["v"])


def test_update_keeps_the_parameters_dtype():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st = adamw.init(p)
    assert st["m"]["w"].dtype == torch.float32
    adamw.update({"w": torch.full((4,), 0.5)}, st, p,
                 adamw.AdamWConfig(lr=0.1, warmup_steps=1))
    assert p["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(p["w"].float().numpy(), 0.890625)


# ---------------------------------------------------------- compression ----

def test_quantize_codes_and_scales_bit_equal(jx):
    """Random tensors and exact half-way points (scale 1: half to even)."""
    rng = np.random.default_rng(3)
    cases = [rng.standard_normal((64, 33)).astype(np.float32) * s
             for s in (1e-3, 1.0, 50.0)]
    cases.append(np.array([127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 126.5],
                          np.float32))
    for g in cases:
        rq, rs = jx["comp"].quantize(jx["jnp"].asarray(g))
        tq, ts = compression.quantize(torch.from_numpy(g))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
        assert ts.numpy().tobytes() == np.asarray(rs).tobytes()
        np.testing.assert_array_equal(
            compression.dequantize(tq, ts).numpy(),
            np.asarray(jx["comp"].dequantize(rq, rs)))
    tq, _ = compression.quantize(torch.from_numpy(cases[-1]))
    assert tq.tolist() == [127, 0, 2, 2, -2, -0, 126]


def test_error_feedback_matches_reference(jx):
    """The EF state over 10 steps: codes, scales, residuals and the
    dequantised values all bit-equal to the reference's."""
    jnp = jx["jnp"]
    rng = np.random.default_rng(4)
    shapes = {"w": (32, 32), "n": {"b": (7,)}}
    rst = jx["comp"].init_state(_draw(rng, shapes))
    tst = compression.init_state(_torch(_draw(rng, shapes)))
    for _ in range(10):
        g = _draw(rng, shapes)
        rq, rsc, rst = jx["comp"].compress_tree(_map(jnp.asarray, g), rst)
        tq, tsc, tst = compression.compress_tree(_torch(g), tst)
        for (_, a), (_, b) in zip(adamw.leaves(tq), adamw.leaves(rq)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        _close(tsc, rsc, rtol=0, atol=0)
        _close(tst.residual, rst.residual, rtol=0, atol=0)
        _close(compression.decompress_tree(tq, tsc),
               jx["comp"].decompress_tree(rq, rsc), rtol=0, atol=0)


def test_compression_error_feedback_unbiased():
    """The reference's test on the port: the cumulative applied update
    approaches the cumulative true gradient; the gap is the residual."""
    g0 = torch.Generator().manual_seed(0)
    state = compression.init_state({"w": torch.zeros(64, 64)})
    applied = torch.zeros(64, 64)
    total = torch.zeros(64, 64)
    for _ in range(30):
        g = {"w": torch.randn((64, 64), generator=g0)}
        qs, ss, state = compression.compress_tree(g, state)
        applied = applied + compression.decompress_tree(qs, ss)["w"]
        total = total + g["w"]
    gap = torch.abs(applied - total)
    np.testing.assert_allclose(gap.numpy(),
                               torch.abs(state.residual["w"]).numpy(),
                               rtol=1e-3, atol=1e-3)
    assert float(gap.max()) < 0.1      # one int8 quantum


def _psum_grads(rank: int) -> dict:
    rng = np.random.default_rng(10 + rank)
    return {"w": (rng.standard_normal((16, 8)) * (rank + 1)).astype(
        np.float32), "n": {"b": rng.standard_normal(5).astype(np.float32)}}


def _psum_rank(rank, out):
    torch.set_num_threads(1)
    fn = compression.make_compressed_psum()
    g = _torch(_psum_grads(rank))
    summed, st = fn(g, compression.init_state(g))
    np.savez(f"{out}/rank{rank}.npz", w=summed["w"].numpy(),
             b=summed["n"]["b"].numpy(), rw=st.residual["w"].numpy())


def test_compressed_psum_on_two_gloo_ranks(tmp_path):
    """Two ranks: the int32 sum of the codes times the larger scale, on
    every rank, with each rank's own residual."""
    D.run_ranks(_psum_rank, 2, args=(str(tmp_path),), timeout=120)
    codes, scales, resid = {}, {}, []
    for r in range(2):
        g = _psum_grads(r)
        for k, a in (("w", g["w"]), ("b", g["n"]["b"])):
            q, s = compression.quantize(torch.from_numpy(a))
            codes.setdefault(k, []).append(q.numpy().astype(np.int64))
            scales.setdefault(k, []).append(float(s))
        q, s = compression.quantize(torch.from_numpy(g["w"]))
        resid.append(g["w"] - (q.float() * s).numpy())
    for r in range(2):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            for k in ("w", "b"):
                want = (sum(codes[k]).astype(np.float32)
                        * np.float32(max(scales[k])))
                np.testing.assert_array_equal(z[k], want)
            np.testing.assert_array_equal(z["rw"], resid[r])
