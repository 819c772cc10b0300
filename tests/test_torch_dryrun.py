"""The port's dry runs (``repro_torch.launch.dryrun`` / ``dryrun_ce``)
against the reference's (``repro.launch.dryrun`` / ``dryrun_ce``).

The reference lowers its cells in one subprocess with 8 forced host
devices (as ``tests/test_sharding.py`` does), on a (4, 2) ("data",
"model") mesh, with smoke ``qwen2-7b`` cells of each kind at a reduced
shape set into both ``SHAPES`` dicts, and the CE estimator at small sizes
over both axes. The port traces the same cells as rank 0 of a fake
8-rank group on fake tensors.

Held exactly (integer bytes and FLOPs): argument bytes a rank, model
FLOPs, the depth law of the traced FLOPs, the CE's collective bytes; the
traced train FLOPs within [1, 2] × 6·N·D (recompute makes it ~4/3). The
(1, 1)-mesh decode and prefill steps against the plain ones within float32
rounding (rtol 1e-5). ~35 s, ~20 s of it the reference's subprocess.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import configs
from repro_torch.core.config import ProberConfig
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, dryrun_ce, specs as S
from repro_torch.launch.mesh import fake_world
from repro_torch.models import get_family
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.sharding import rules
from repro_torch.utils import comms, cost, roofline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = {"t": dict(seq=64, batch=8, kind="train"),
         "p": dict(seq=64, batch=8, kind="prefill"),
         "d": dict(seq=64, batch=8, kind="decode")}
CE = dict(n=4096, dim=32, nq=16)
CE_CFG = ProberConfig(n_tables=2, n_funcs=12, ring_budget=256,
                      central_budget=256, chunk=64, max_visit=1024)

_REFERENCE = """
    import json, os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    jax.devices()        # the device count is fixed before dryrun's import
    from repro import compat, configs
    from repro.core import distributed as D, estimator as E, lsh
    from repro.core.config import ProberConfig
    from repro.launch import specs as S
    from repro.launch import dryrun as DR
    from repro.utils import hlo, roofline

    CELLS = json.loads(%r)
    CE = json.loads(%r)
    S.SHAPES.update(CELLS)
    mesh = compat.make_mesh((4, 2), ("data", "model"))
    cfg = configs.get_smoke_config("qwen2-7b")
    out = {"cells": {}, "ce": {}}
    for name, info in CELLS.items():
        compiled = DR.lower_cell(cfg, name, mesh)[0]
        ca = compiled.cost_analysis()
        ca = ca[0] if isinstance(ca, (list, tuple)) else ca
        text = compiled.as_text()
        out["cells"][name] = {
            "args": int(compiled.memory_analysis().argument_size_in_bytes),
            "model_flops": roofline.model_flops_for(cfg, info),
            "flops": float(ca.get("flops", 0.0)),
            "coll": hlo.collective_bytes(text),
            "top": hlo.top_collectives(text, 12)}
    pc = ProberConfig(n_tables=2, n_funcs=12, ring_budget=256,
                      central_budget=256, chunk=64, max_visit=1024)
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    x = jax.ShapeDtypeStruct((CE["n"], CE["dim"]), jnp.float32)
    params = jax.eval_shape(lambda k: lsh.init_params(k, CE["dim"], pc), key)
    local = jax.eval_shape(lambda x, k, p: E.build(x, pc, k, params=p),
                           x, key, params)
    state = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct((8,) + s.shape, s.dtype), local)
    qs = jax.ShapeDtypeStruct((CE["nq"], CE["dim"]), jnp.float32)
    taus = jax.ShapeDtypeStruct((CE["nq"],), jnp.float32)
    for mode in ("local", "sync"):
        fn = lambda st, q, t, k: D.estimate_sharded(
            st, q, t, pc, k, mesh, data_axes=("data", "model"), mode=mode)
        text = jax.jit(fn).lower(state, qs, taus, key).compile().as_text()
        out["ce"][mode] = {"coll": hlo.collective_bytes(text),
                           "top": hlo.top_collectives(text, 12)}
    print("REF" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    code = textwrap.dedent(_REFERENCE) % (json.dumps(CELLS), json.dumps(CE))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=300,
                       env={**os.environ, "PYTHONPATH": "src",
                            "JAX_PLATFORMS": "cpu"})
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("REF")]
    assert line, r.stdout[-2000:] + r.stderr[-3000:]
    return json.loads(line[0][3:])


@pytest.fixture
def cells(monkeypatch):
    monkeypatch.setattr(S, "SHAPES", {**S.SHAPES, **CELLS})


def _trace(cfg, shape):
    with fake_world(8):
        mesh = init_device_mesh("cpu", (4, 2),
                                mesh_dim_names=("data", "model"))
        rec = dryrun.trace_cell(cfg, shape, mesh, device="cpu")
        return rec, dryrun.analyze(cfg, shape, rec, 8)


@pytest.mark.parametrize("shape", list(CELLS))
def test_argument_bytes_and_model_flops_match_the_reference(ref, cells,
                                                            shape):
    cfg = configs.get_smoke_config("qwen2-7b")
    rec, out = _trace(cfg, shape)
    assert not dist.is_initialized()
    want = ref["cells"][shape]
    assert out["memory"]["argument_size_in_bytes"] == want["args"]
    assert out["roofline"]["model_flops"] == want["model_flops"]
    assert out["cost_corrected"] is None and out["roofline"]["hlo_flops"] > 0
    assert set(out["memory"]) == REFERENCE_MEMORY
    assert out["attention_route"] == {"plain": {"t": 4, "p": 2, "d": 2}[
        shape]}
    assert rec["profile"] == ("tp" if shape == "d" else "fsdp_tp")


# the reference's record (repro/launch/dryrun.py analyze + run_cell), with
# compile_s renamed trace_s and while_trip_counts dropped
REFERENCE_KEYS = {"arch", "shape", "chips", "memory", "cost_raw",
                  "cost_corrected", "collectives", "roofline", "mesh",
                  "profile", "unrolled"}
REFERENCE_MEMORY = {"argument_size_in_bytes", "output_size_in_bytes",
                    "temp_size_in_bytes", "peak_memory_in_bytes",
                    "alias_size_in_bytes"}


def test_full_size_cell_writes_the_reference_record(tmp_path):
    """The CLI at a published size on the CPU (rwkv6-1.6b long_500k, the
    256-rank mesh): the reference's keys, and the named deviations."""
    dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "long_500k", "--mesh",
                 "single", "--device", "cpu", "--out-dir", str(tmp_path)])
    assert not dist.is_initialized()
    rec = json.loads((tmp_path / "rwkv6-1.6b__long_500k__single.json")
                     .read_text())
    assert REFERENCE_KEYS | {"trace_s", "attention_route"} <= set(rec)
    assert "compile_s" not in rec and "while_trip_counts" not in rec
    assert set(rec["memory"]) == REFERENCE_MEMORY
    assert rec["cost_corrected"] is None and rec["unrolled"] is True
    assert rec["chips"] == 256 and rec["profile"] == "tp"
    r = rec["roofline"]
    assert min(r["t_compute_s"], r["t_memory_s"], r["t_collective_s"]) > 0
    # the rank's shard of the state: rwkv6's (L, B, H, hd, hd) matrix
    # state has its heads over "model", and the decode step writes it
    assert 0 < rec["memory"]["alias_size_in_bytes"] < \
        rec["memory"]["argument_size_in_bytes"]


def test_flops_follow_depth_exactly(cells):
    cfg = configs.get_smoke_config("qwen2-7b")
    f = {n: _trace(cfg.replace(n_layers=n), "t")[0]["flops"]
         for n in (1, 2, 4)}
    assert f[4] - f[2] == 2 * (f[2] - f[1]) > 0


def test_train_flops_within_one_to_two_of_6nd(cells):
    cfg = configs.get_smoke_config("qwen2-7b")
    rec, _ = _trace(cfg, "t")
    # the rank's share: the batch over the 4 data ranks, the model (heads,
    # d_ff, vocab) over the 2 "model" ranks
    tokens = CELLS["t"]["batch"] // 4 * CELLS["t"]["seq"]
    ratio = rec["flops"] / (6 * cfg.active_param_count() * tokens / 2)
    assert 1.0 <= ratio <= 2.0, ratio


def _trace_on(cfg, shape, mesh_shape):
    with fake_world(8):
        mesh = init_device_mesh("cpu", mesh_shape,
                                mesh_dim_names=("data", "model"))
        return dryrun.trace_cell(cfg, shape, mesh, device="cpu")


def test_train_flops_a_rank_split_over_model(cells):
    """The (4, 2) mesh's rank computes its share of the (8, 1) mesh's rank
    (twice the rows, half of each block): within 1.15x of its FLOPs. A
    mesh step that gathered whole blocks repeated its data rank's work on
    both "model" ranks: 2x."""
    cfg = configs.get_smoke_config("qwen2-7b")
    tp = _trace_on(cfg, "t", (4, 2))["flops"]
    dp = _trace_on(cfg, "t", (8, 1))["flops"]
    print(f"FLOPs a rank: (4, 2) {tp:.6g}, (8, 1) {dp:.6g}")
    assert dp / 1.15 <= tp <= 1.15 * dp, (tp, dp)


# the port's traced FLOPs a rank against the reference's compiled ones on
# the (4, 2) train cell: XLA's count adds the elementwise ops' FLOPs (one
# an element) and its own rematerialisation, which FlopCounterMode leaves
# out (it counts matmuls and attention), so the port's is the smaller
REF_FLOPS_RANGE = (0.5, 1.05)


def test_train_flops_a_rank_against_the_reference_plan(ref, cells):
    """The reference's compiled per-device FLOPs and collectives of the
    (4, 2) train cell, beside the port's traced ones (logged side by
    side)."""
    cfg = configs.get_smoke_config("qwen2-7b")
    rec = _trace_on(cfg, "t", (4, 2))
    want = ref["cells"]["t"]
    ratio = rec["flops"] / want["flops"]
    print(f"FLOPs a rank: port {rec['flops']:.6g}, reference "
          f"{want['flops']:.6g} (ratio {ratio:.3f}); collectives "
          f"port {json.dumps(rec['collectives'])}, reference "
          f"{json.dumps(want['coll'])}")
    for side, rows in (("reference", want["top"]),
                       ("port", rec["top_collectives"])):
        for r in rows:
            print(f"  {side}: {r['op']} {r['shape']} {r['bytes']} B"
                  + (f" over {r['axis']}" if "axis" in r else ""))
    assert REF_FLOPS_RANGE[0] <= ratio <= REF_FLOPS_RANGE[1], ratio


def _ce(mode):
    with fake_world(8):
        rec = dryrun_ce.estimate_cell(CE["n"], CE["dim"], CE["nq"], CE_CFG,
                                      mode, "cpu")
    assert not dist.is_initialized()
    assert rec["estimates_finite"] and rec["n_estimates"] == CE["nq"]
    return rec


def test_ce_local_is_one_all_reduce_as_the_reference(ref):
    rec = _ce("local")
    want = ref["ce"]["local"]["coll"]
    assert rec["collectives"] == want == {
        "total": 112, "per_op": {"all-reduce": 112},
        "counts": {"all-reduce": 1}}
    steps = rec["slab_steps"]
    assert steps["lane_steps"] >= steps["longest_lane"] > 0


def test_ce_sync_per_call_bytes_match_the_reference(ref):
    rec = _ce("sync")
    lanes = CE["nq"] * CE_CFG.n_tables
    rows = ref["ce"]["sync"]["top"]
    body = [r for r in rows if r["shape"] == f"f32[{CE['nq']},2,5]"]
    setup = [r for r in rows if r["shape"] == f"f32[{CE['nq']},2]"]
    assert len(body) == len(setup) == 1
    step = body[0]["bytes"] // body[0]["mult"]
    got = [r for r in rec["top_collectives"]]
    calls = rec["collectives"]["counts"]["all-reduce"]
    assert calls == 1 + rec["work"]["slab_qualify"]["calls"]
    # the setup: the reference's float32 tuple and its int32 visit counts
    # in one all-reduce (the port reads the group's size on the host, where
    # the reference adds an s32[] psum of 1)
    first = max(got, key=lambda r: r["bytes"])
    assert first["shape"] == f"f32[{lanes},{2 + 2 * CE_CFG.n_funcs}]"
    assert first["bytes"] == setup[0]["bytes"] + comms.wire_bytes(
        "all-reduce", 4 * lanes, 8)
    # each slab step pools (A, 5) for its A active lanes: the reference's
    # step while every lane runs, less once lanes finish
    steps = [r for r in got if r is not first]
    assert any(r["bytes"] == step for r in steps)
    assert all(r["bytes"] <= step for r in steps)


def test_work_is_counted_on_the_cpu_route():
    ops.reset_work()
    x, q = torch.randn(100, 16), torch.randn(5, 16)
    ops.l2dist(x, q)
    ops.l2dist(x, q)
    b, f = ops.l2dist_work(100, 5, 16)
    assert ops.WORK["l2dist"] == {"calls": 2, "bytes": 2 * b, "flops": 2 * f}
    assert b == 4 * (100 * 16 + 5 * 16 + 100 * 5) and f == 2 * 100 * 5 * 16
    ops.reset_work()
    assert ops.WORK["l2dist"] == {"calls": 0, "bytes": 0, "flops": 0}


@pytest.mark.parametrize("arch", ["qwen2-7b", "rwkv6-1.6b",
                                  "recurrentgemma-9b", "whisper-medium",
                                  "qwen3-moe-30b-a3b"])
def test_mesh_serve_steps_equal_the_plain_ones(arch):
    """On a (1, 1) mesh of a one-rank group every placement is a replica:
    the mesh steps (each family's explicit per-block gathers, the cache
    gathered and re-placed) must compute what the plain steps do; a block
    left ungathered would mix DTensors with plain tensors and raise."""
    cfg = configs.get_smoke_config(arch)
    fam = get_family(cfg)
    g = torch.Generator().manual_seed(0)
    model = fam.init(cfg, g, "cpu", param_dtype=torch.float32)
    kw = {"enc_len": 16} if cfg.family == "whisper" else {}
    cache = fam.init_cache(cfg, 2, 16, device="cpu", **kw)
    tokens = torch.randint(0, cfg.vocab, (2,), generator=g)
    want, want_cache = make_decode_step(cfg)(model, {
        k: _clone(v) for k, v in cache.items()}, tokens)
    batch = ({"frames": torch.randn(2, 16, cfg.d_model, generator=g)}
             if cfg.family == "whisper" else
             {"tokens": torch.randint(0, cfg.vocab, (2, 8), generator=g)})
    want_p = make_prefill_step(cfg)(model, batch)
    with fake_world(1):
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        specs = rules.param_specs(model, mesh)
        for name, spec in specs.items():
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name)
            mod.register_parameter(leaf, torch.nn.Parameter(rules.place(
                mod._parameters[leaf].detach(), mesh, spec.placements)))
        cspecs = rules.cache_specs(cache, mesh)
        placed = _place(cache, cspecs, mesh)
        got, got_cache = make_decode_step(cfg, mesh=mesh)(model, placed,
                                                          tokens)
        got_p = make_prefill_step(cfg, mesh=mesh)(model, batch)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got_p, want_p, rtol=1e-5, atol=1e-5)
        for k in want_cache:
            _close(got_cache[k], want_cache[k])


def _clone(v):
    return {k: _clone(x) for k, x in v.items()} if isinstance(v, dict) \
        else v.clone()


def _place(tree, specs, mesh):
    return {k: _place(v, specs[k], mesh) if isinstance(v, dict)
            else rules.place(v, mesh, specs[k].placements)
            for k, v in tree.items()}


def _close(got, want):
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k])
        return
    torch.testing.assert_close(got.full_tensor().float(), want.float(),
                               rtol=1e-5, atol=1e-5)


def test_sdpa_flops_widen_grouped_kv():
    """The card's attention runs SDPA with grouped K/V (``enable_gqa``),
    whose shapes torch's own SDPA formulas refuse: the dry run counts each
    SDPA kernel as the same products over K/V repeated to the query's
    heads."""
    from torch.utils import flop_counter
    q, kv = (2, 8, 16, 32), (2, 2, 16, 32)
    names = {str(op) for op in cost._SDPA_FLOPS}
    assert {"aten._scaled_dot_product_cudnn_attention",
            "aten._scaled_dot_product_flash_attention_backward"} <= names
    for op, fn in cost._SDPA_FLOPS.items():
        if str(op).endswith("_backward"):
            assert fn(q, q, kv, kv) == flop_counter.sdpa_backward_flop_count(
                q, q, q, q)
        else:
            assert fn(q, kv, kv) == flop_counter.sdpa_flop_count(q, q, q) \
                == 4 * 2 * 8 * 16 * 16 * 32


def test_model_flops_kinds_match_the_roofline_reference():
    """``analyze``'s model FLOPs are ``roofline.model_flops_for`` of the
    cell, the reference's formula (tests/test_infra.py's values)."""
    cfg = configs.get_config("qwen3-moe-235b-a22b")
    n_act = cfg.active_param_count()
    ft = roofline.model_flops_for(cfg, S.SHAPES["train_4k"])
    fd = roofline.model_flops_for(cfg, S.SHAPES["decode_32k"])
    assert abs(ft - 6.0 * n_act * 256 * 4096) < 1e-3 * ft
    assert abs(fd - 2.0 * n_act * 128) < 1e-3 * fd
