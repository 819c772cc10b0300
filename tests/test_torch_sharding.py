"""The port's sharding rules (``repro_torch.sharding.rules``), cell specs
(``repro_torch.launch.specs``), elastic plan (``repro_torch.ft.elastic``)
and roofline constants (``repro_torch.utils.roofline``) against the
reference's.

The reference's specs need a mesh of 8 devices, so they are computed once,
in a subprocess with 8 forced host devices (as ``tests/test_sharding.py``
does), for every arch in ``configs.ARCHS``: parameter specs on a (2, 4)
("data", "model") mesh in both profiles, and batch and cache specs of
every supported cell on that mesh and on a (2, 2, 2) ("pod", "data",
"model") one. The port's specs need only the axes' sizes. A port
parameter is one layer of the reference's stacked leaf: its spec must be
the reference's trailing entries, and the stacked entries ``None``. The
machine with the card has no jax: the reference's part skips there.
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch import configs
from repro_torch.ft.elastic import MeshPlan, plan_remesh
from repro_torch.launch import specs as S
from repro_torch.sharding import rules
from repro_torch.utils import roofline

MESH = {"data": 2, "model": 4}
MESH3 = {"pod": 2, "data": 2, "model": 2}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REFERENCE = """
    import json, os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from repro import configs, compat
    from repro.launch import specs as S
    from repro.sharding import rules

    def entries(spec):
        return [list(e) if isinstance(e, tuple) else e for e in spec]

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            else:
                out[f"{prefix}{k}"] = entries(v)
        return out

    meshes = {"2x4": compat.make_mesh((2, 4), ("data", "model")),
              "2x2x2": compat.make_mesh((2, 2, 2), ("pod", "data", "model"))}
    out = {"params": {}, "batch": {}, "cache": {}}
    for arch in configs.ARCHS:
        cfg = configs.get_config(arch)
        shapes = S.param_specs_for(cfg)
        for profile in ("fsdp_tp", "tp"):
            out["params"][f"{arch}|{profile}"] = flat(
                rules.param_specs(shapes, meshes["2x4"], profile))
        for shape, info in S.SHAPES.items():
            if not S.cell_supported(cfg, shape)[0]:
                continue
            for name, mesh in meshes.items():
                key = f"{arch}|{shape}|{name}"
                out["batch"][key] = flat(
                    rules.batch_specs(S.batch_specs_for(cfg, shape), mesh))
                if info["kind"] == "decode":
                    out["cache"][key] = flat(rules.cache_specs(
                        S.cache_specs_for(cfg, shape), mesh))
    print("SPECS" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE)],
                       capture_output=True, text=True, cwd=ROOT, timeout=240,
                       env={**os.environ, "PYTHONPATH": "src"})
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("SPECS")]
    assert line, r.stdout[-2000:] + r.stderr[-2000:]
    return json.loads(line[0][len("SPECS"):])


def _entries(axes) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in axes]


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _check_placements(spec: rules.Spec, sizes: dict):
    """One placement a mesh dim: Shard(d) where dim d's entry names the
    axis, Replicate() elsewhere."""
    assert len(spec.placements) == len(sizes)
    for axis, pl in zip(sizes, spec.placements):
        dims = [d for d, e in enumerate(spec.axes)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        assert pl == (Shard(dims[0]) if dims else Replicate()), (spec, axis)


@pytest.mark.parametrize("profile", ["fsdp_tp", "tp"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_specs_match_reference(ref, arch, profile):
    want = ref["params"][f"{arch}|{profile}"]
    shapes = S.param_specs_for(configs.get_config(arch))
    got = rules.param_specs(shapes, MESH, profile)
    assert set(got) == set(shapes)
    assert {rules.reference_path(k) for k in got} == set(want)
    for name, spec in got.items():
        w = want[rules.reference_path(name)]
        n = len(shapes[name].shape)
        assert len(spec.axes) == n
        assert _entries(spec.axes) == w[len(w) - n:], (name, spec, w)
        assert all(e is None for e in w[:len(w) - n]), (name, w)
        _check_placements(spec, MESH)


def test_param_specs_divisibility_fallback():
    """whisper vocab 51865 % 4 != 0 -> embedding rows replicated; olmo's
    embedding ("model", "data"); wq ("data", "model") per layer."""
    specs = rules.param_specs(
        S.param_specs_for(configs.get_config("whisper-medium")), MESH)
    assert specs["embed.embedding"].axes[0] is None
    olmo = rules.param_specs(
        S.param_specs_for(configs.get_config("olmo-1b")), MESH)
    assert olmo["embed.embedding"].axes == ("model", "data")
    assert olmo["embed.embedding"].placements == (Shard(1), Shard(0))
    for i in range(configs.get_config("olmo-1b").n_layers):
        assert olmo[f"layers.{i}.attn.wq"].axes == ("data", "model")
        assert olmo[f"layers.{i}.attn.wq"].placements == (Shard(0), Shard(1))


@pytest.mark.parametrize("mesh", ["2x4", "2x2x2"])
def test_batch_and_cache_specs_match_reference(ref, mesh):
    sizes = MESH if mesh == "2x4" else MESH3
    n_cache = 0
    for arch in configs.ARCHS:
        cfg = configs.get_config(arch)
        for shape, info in S.SHAPES.items():
            key = f"{arch}|{shape}|{mesh}"
            if not S.cell_supported(cfg, shape)[0]:
                assert key not in ref["batch"]
                continue
            got = rules.batch_specs(S.batch_specs_for(cfg, shape), sizes)
            assert {k: _entries(v.axes) for k, v in got.items()} \
                == ref["batch"][key], key
            for spec in got.values():
                _check_placements(spec, sizes)
            if info["kind"] != "decode":
                continue
            got = _flat(rules.cache_specs(S.cache_specs_for(cfg, shape),
                                          sizes))
            assert {k: _entries(v.axes) for k, v in got.items()} \
                == ref["cache"][key], key
            for spec in got.values():
                _check_placements(spec, sizes)
            n_cache += 1
    assert n_cache == 12        # 10 archs at decode_32k, 2 at long_500k


# ----------------------------------------------- twins of the reference ----

def test_cell_support_matrix():
    cfg_dense = configs.get_config("qwen2-7b")
    ok, why = S.cell_supported(cfg_dense, "long_500k")
    assert not ok and "sub-quadratic" in why
    for arch in ("rwkv6-1.6b", "recurrentgemma-9b"):
        ok, _ = S.cell_supported(configs.get_config(arch), "long_500k")
        assert ok
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        for arch in configs.ARCHS:
            ok, _ = S.cell_supported(configs.get_config(arch), shape)
            assert ok


@pytest.mark.parametrize("arch", configs.ARCHS)
@pytest.mark.parametrize("shape", list(S.SHAPES))
def test_input_specs_constructible(arch, shape):
    """Every supported (arch x shape) cell yields well-formed meta inputs:
    batch dims match the grid, dtypes are ints/floats as expected."""
    cfg = configs.get_config(arch)
    ok, why = S.cell_supported(cfg, shape)
    if not ok:
        assert "sub-quadratic" in why
        return
    batch = S.batch_specs_for(cfg, shape)
    info = S.SHAPES[shape]
    for name, leaf in batch.items():
        assert leaf.device.type == "meta"
        assert leaf.shape[0] == info["batch"], (name, leaf.shape)
        if name in ("tokens", "labels"):
            assert leaf.dtype == torch.int32
    if info["kind"] == "decode":
        leaves = list(_flat(S.cache_specs_for(cfg, shape)).values())
        assert leaves, "decode cell must have a cache"
        assert all(leaf.device.type == "meta" for leaf in leaves)
        # cache batch dim must match the grid
        big = [leaf for leaf in leaves if leaf.ndim >= 2]
        assert all(leaf.shape[1] == info["batch"] for leaf in big)


def test_param_specs_abstract_no_alloc():
    """param_specs_for must never allocate — even for the 235B config."""
    cfg = configs.get_config("qwen3-moe-235b-a22b")
    tree = S.param_specs_for(cfg)
    assert all(leaf.device.type == "meta" for leaf in tree.values())
    n = sum(math.prod(leaf.shape) for leaf in tree.values())
    assert n > 2e11        # ~235B params represented, zero bytes allocated


def test_elastic_plan():
    plan = plan_remesh(n_alive=250, model_parallel=16)
    assert plan.model == 16 and plan.data == 15 and plan.n_devices == 240
    assert plan == MeshPlan(n_devices=240, data=15, model=16)
    with pytest.raises(AssertionError):
        plan_remesh(n_alive=8, model_parallel=16)


def test_roofline_terms_at_h100_constants():
    """989e12 bf16 FLOP/s, 3.35e12 B/s HBM3, 450e9 B/s NVLink a direction;
    the reference's formulas."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    r = roofline.make(989e12, 6.7e12, 90e9, chips=4, model_flops=2e15)
    assert (r.t_compute, r.t_memory, r.t_collective) == (1.0, 2.0, 0.2)
    assert r.dominant == "memory" and r.step_time == 2.0
    assert r.useful_ratio == 2e15 / (4 * 989e12)
    assert r.mfu_bound == 2e15 / (4 * 989e12 * 2.0)
    assert r.to_dict()["collective_bytes_per_device"] == 90e9
    cfg = configs.get_config("qwen2.5-3b")
    n = cfg.active_param_count()
    assert roofline.model_flops_for(cfg, S.SHAPES["train_4k"]) \
        == 6.0 * n * 256 * 4096
    assert roofline.model_flops_for(cfg, S.SHAPES["prefill_32k"]) \
        == 2.0 * n * 32 * 32768
    assert roofline.model_flops_for(cfg, S.SHAPES["decode_32k"]) \
        == 2.0 * n * 128
    w = configs.get_config("whisper-medium")
    assert roofline.model_flops_for(w, S.SHAPES["train_4k"]) \
        == 6.0 * w.active_param_count() * 256 * (4096 + w.dec_len)
