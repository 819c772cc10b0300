"""Multi-pod dry run (port of ``repro/launch/dryrun.py``): one train,
prefill or decode step of every (arch × shape) cell on the production
meshes, traced, with its FLOPs, bytes, collectives and memory a rank.

The reference lowers and compiles each cell under XLA over 512 forced host
devices and reads the compiled program. PyTorch has no lowered program to
read, so the port runs the cell's step once, as rank 0 of a "fake" process
group of 256 or 512 ranks (``launch/mesh.fake_world``: every collective
completes without sending a byte), on ``FakeTensorMode`` tensors (no byte
of a full-size tensor is allocated), under the counting modes of
``utils/cost.py``. Parameters, batches and caches are DTensors built from
fake local shards, placed by ``sharding/rules.py`` as the reference places
them; the step is the port's own (``train/step.py``, ``serve/step.py`` with
``mesh=``): a rank computes on its batch shard, gathers each block's
weights over the data axes when it runs and computes its share of the
block over "model" (every family is tensor-parallel).

The record has the reference's keys, with these differences:
  * ``trace_s`` (the traced step's host seconds) in place of ``compile_s``;
  * no ``while_trip_counts`` and ``cost_corrected: null``, ``unrolled:
    true``: the trace runs every layer of the Python loop, so the
    reference's delta method (it exists because XLA counts a ``lax.scan``
    body once) has nothing to correct;
  * ``memory``: ``argument_size_in_bytes`` from the inputs' local shards,
    ``peak_memory_in_bytes`` from ``MemTracker`` (a traced figure, not an
    allocator's), ``temp_size_in_bytes`` the peak above the arguments,
    ``alias_size_in_bytes`` the inputs the step writes in place (what the
    reference donates: a train step's parameters and optimizer state, a
    decode step's cache);
  * ``cost_raw``: FLOPs from ``FlopCounterMode`` (the SDPA routes by
    torch's formulas with K and V widened to the query's heads: its own
    assert on grouped-query shapes), bytes each aten op's inputs plus
    outputs (unfused eager traffic, not XLA's fused "bytes accessed");
  * ``attention_route``: how many attention calls took each SDPA backend
    (``cudnn``, ``flash``, ``efficient``, ``math``), the plain einsum
    form (``plain``, the CPU's route) or a sequence-split decode step's
    combined partials (``split``);
  * ``collectives_by_axis``: each mesh axis's collective bytes and calls
    (``all``: a group of every rank), and each ``top_collectives`` row's
    ``axis``.

  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k \\
      --mesh single [--device cpu]
  python -m repro_torch.launch.dryrun --all [--mesh both] \\
      [--archs rwkv6-1.6b,whisper-medium] [--out-dir results/dryrun_torch]

``--all`` runs one subprocess per cell, as the reference does: each cell
gets a fresh process group, and a failed cell fails alone; one cell a
core at once (a trace is host work).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Shard

from repro_torch import configs
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import get_family, layers as L
from repro_torch.models.base import ModelConfig
from repro_torch.optim import adamw
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.sharding import rules
from repro_torch.train.step import make_train_step
from repro_torch.utils import cost, roofline


def _fake_shard(t: torch.Tensor, mesh, placements, mode: FakeTensorMode,
                device, dtype=None) -> DTensor:
    """A DTensor of ``t``'s shape (a meta tensor) whose local shard, rank
    0's block under ``placements``, is a fake tensor on ``device``: no
    scatter, no allocation."""
    shape = list(t.shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            shape[p.dim] = -(-shape[p.dim] // mesh.size(i))
    with mode:
        local = torch.empty(shape, dtype=dtype or t.dtype, device=device)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def _place_tree(tree: dict, specs: dict, mesh, mode, device) -> dict:
    return {k: _place_tree(v, specs[k], mesh, mode, device)
            if isinstance(v, dict)
            else _fake_shard(v, mesh, specs[k].placements, mode, device)
            for k, v in tree.items()}


def _fake_model(cfg: ModelConfig, mesh, profile: str, mode, device,
                dtype=None) -> nn.Module:
    """The family's model on ``meta`` (float32, as ``specs.param_specs_for``)
    with every parameter replaced by a fake DTensor placed by
    ``rules.param_specs``; float32 ones stored as ``dtype`` when given."""
    model = get_family(cfg).init(cfg, torch.Generator(), "meta",
                                 param_dtype=torch.float32)
    for name, spec in rules.param_specs(model, mesh, profile).items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        p = mod._parameters[leaf]
        dt = dtype if dtype is not None and p.dtype == torch.float32 else None
        mod.register_parameter(leaf, nn.Parameter(_fake_shard(
            p, mesh, spec.placements, mode, device, dt)))
    return model


def decode_profile(cfg: ModelConfig, mesh, profile: str) -> str:
    """The reference's serving policy: ``tp`` (weights replicated over the
    data axes) when the bf16 weights split over "model" are at most 4 GiB
    a device."""
    model = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    return "tp" if cfg.param_count() * 2 / model / 2 ** 30 <= 4.0 else profile


def trace_cell(cfg: ModelConfig, shape: str, mesh, profile: str = "fsdp_tp",
               device="cuda") -> dict:
    """One step of the cell, traced on fake tensors as rank 0 of ``mesh``
    (a mesh of the current, usually fake, process group). Returns
    ``cost.measure``'s record, with ``profile`` (the one used: decode
    follows :func:`decode_profile`), ``attention_route``, ``output_bytes``
    and ``alias_bytes``."""
    info = S.SHAPES[shape]
    kind = info["kind"]
    mode = FakeTensorMode()
    dev = torch.device(device)
    if kind == "decode":
        profile = decode_profile(cfg, mesh, profile)
        model = _fake_model(cfg, mesh, profile, mode, dev, torch.bfloat16)
    else:
        model = _fake_model(cfg, mesh, profile, mode, dev)
    batch_abs = S.batch_specs_for(cfg, shape)
    batch = _place_tree(batch_abs, rules.batch_specs(batch_abs, mesh), mesh,
                        mode, dev)
    if kind == "train":
        with mode:
            opt = adamw.init(dict(model.named_parameters()))
        step = make_train_step(cfg, adamw.AdamWConfig(), mesh=mesh)
        inputs, in_place = (model, opt, batch), (model, opt)

        def run():
            return step(model, opt, batch)[2]
    elif kind == "prefill":
        step = make_prefill_step(cfg, mesh=mesh)
        inputs, in_place = (model, batch), ()

        def run():
            return step(model, batch)
    else:
        cache_abs = S.cache_specs_for(cfg, shape)
        cache = _place_tree(cache_abs, rules.cache_specs(cache_abs, mesh),
                            mesh, mode, dev)
        step = make_decode_step(cfg, mesh=mesh)
        inputs, in_place = (model, cache, batch["tokens"]), (cache,)

        def run():
            return step(model, cache, batch["tokens"])

    calls = {"plain": 0, "split": 0}

    def counted(name, fn):
        def run_counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run_counted

    with mock.patch.object(L, "_sdpa", counted("plain", L._sdpa)), \
            mock.patch.object(L, "_split_attend",
                              counted("split", L._split_attend)):
        out, rec = cost.measure(run, *inputs, fake_mode=mode)
    routes = dict(rec.pop("sdpa_routes"))
    routes.update({k: n for k, n in calls.items() if n})
    rec["attention_route"] = routes
    axis = {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
    for row in rec["top_collectives"]:
        row["axis"] = axis.get(row.pop("group"), "all")
    rec["collectives_by_axis"] = {
        axis.get(g, "all"): v
        for g, v in rec.pop("collectives_by_group").items()}
    rec["profile"] = profile
    rec["output_bytes"] = cost.argument_bytes(out)
    rec["alias_bytes"] = cost.argument_bytes(*in_place)
    return rec


def analyze(cfg: ModelConfig, shape: str, rec: dict, chips: int) -> dict:
    """The reference's record (see the module docstring for the keys that
    differ) from :func:`trace_cell`'s."""
    mf = roofline.model_flops_for(cfg, S.SHAPES[shape])
    coll = rec["collectives"]
    rf = roofline.make(rec["flops"], rec["bytes"], float(coll["total"]),
                       chips, mf)
    return {
        "arch": cfg.name, "shape": shape, "chips": chips,
        "trace_s": round(rec["trace_s"], 1),
        "memory": {"argument_size_in_bytes": rec["argument_bytes"],
                   "output_size_in_bytes": rec["output_bytes"],
                   "temp_size_in_bytes": max(
                       rec["peak_bytes"] - rec["argument_bytes"], 0),
                   "peak_memory_in_bytes": rec["peak_bytes"],
                   "alias_size_in_bytes": rec["alias_bytes"]},
        "cost_raw": {"flops": rec["flops"], "bytes_accessed": rec["bytes"]},
        "cost_corrected": None,
        "collectives": coll,
        "top_collectives": rec["top_collectives"],
        "collectives_by_axis": rec["collectives_by_axis"],
        "roofline": rf.to_dict(),
        "attention_route": rec["attention_route"],
    }


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: Path,
             profile: str, device="cuda") -> dict:
    cfg = configs.get_config(arch)
    ok, why = S.cell_supported(cfg, shape)
    rec_path = out_dir / f"{arch}__{shape}__{mesh_kind}.json"
    if not ok:
        rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
               "skipped": why}
        rec_path.write_text(json.dumps(rec, indent=1))
        print(f"SKIP {arch} {shape}: {why}")
        return rec
    multi = mesh_kind == "multi"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "trace on the CPU")
    with fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device=dev.type)
        traced = trace_cell(cfg, shape, mesh, profile, dev)
        rec = analyze(cfg, shape, traced, mesh.size())
    rec["mesh"] = mesh_kind
    rec["profile"] = traced["profile"]
    rec["unrolled"] = True
    rec["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    rec_path.write_text(json.dumps(rec, indent=1))
    r = rec["roofline"]
    print(f"OK {arch} {shape} {mesh_kind}: trace={rec['trace_s']:.1f}s "
          f"dominant={r['dominant']} t=({r['t_compute_s']:.2e},"
          f"{r['t_memory_s']:.2e},{r['t_collective_s']:.2e})s "
          f"useful={r['useful_ratio']:.2f} "
          f"peak_mem(traced)={rec['memory']['peak_memory_in_bytes'] / 2 ** 30:.2f}GiB "
          f"coll={rec['collectives']['total'] / 2 ** 30:.3f}GiB "
          f"attention={rec['attention_route']}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=configs.ARCHS)
    ap.add_argument("--shape", choices=list(S.SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--profile", default="fsdp_tp", choices=["tp", "fsdp_tp"])
    ap.add_argument("--out-dir", default="results/dryrun_torch")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--archs", default=None,
                    help="with --all: a comma-separated subset of the "
                         "archs (default: every arch)")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose JSON already exists")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (default cuda)")
    args = ap.parse_args(argv)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.all:
        archs = args.archs.split(",") if args.archs else configs.ARCHS
        unknown = sorted(set(archs) - set(configs.ARCHS))
        if unknown:
            ap.error(f"unknown archs {unknown}")
        cells = [(arch, shape, mk) for arch in archs
                 for shape in S.SHAPES for mk in meshes
                 if not (args.resume and (
                     out_dir / f"{arch}__{shape}__{mk}.json").exists())]

        def run(cell):
            arch, shape, mk = cell
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mk,
                   "--profile", args.profile, "--device", args.device,
                   "--out-dir", str(out_dir)]
            r = subprocess.run(cmd, capture_output=True, text=True)
            # one print a cell: the threads' outputs do not interleave
            print(r.stdout + (r.stderr[-4000:] if r.returncode else ""),
                  end="", flush=True)
            return r.returncode

        # a trace is host work on one core: one cell a core at once
        with ThreadPoolExecutor(max_workers=os.cpu_count()) as pool:
            codes = list(pool.map(run, cells))
        failures = [c for c, rc in zip(cells, codes) if rc != 0]
        if failures:
            print("FAILED cells:", failures)
            sys.exit(1)
        print("all cells OK")
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all, are required")
    for mk in meshes:
        run_cell(args.arch, args.shape, mk, out_dir, args.profile,
                 args.device)


if __name__ == "__main__":
    main()
