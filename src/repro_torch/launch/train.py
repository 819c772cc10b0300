"""Training driver (port of ``repro/launch/train.py``): mesh + sharding
rules + AdamW + the fault-tolerant loop + checkpointing + straggler
telemetry, end to end.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --scale smoke --steps 60 --batch 8 --seq 64 --ckpt-dir ckpt \\
      --device cpu

Seeded random float32 master weights (no checkpoint is loaded unless
``--ckpt-dir`` holds one: the loop resumes from it), compute in
``cfg.dtype``, batches from ``TokenPipeline``. A step syncs once, on its
loss, where the reference blocks; the straggler clock reads the step times
there.

``--mesh host`` (the default) trains on a (world // N, N) ("data",
"model") mesh, N = ``--model-parallel``, over the process group it finds:
the one already initialised, torchrun's environment (``RANK``,
``WORLD_SIZE``, ...), or else, when N > 1, a one-rank group over a
``FileStore`` in a temporary directory (no network); NCCL on the card,
gloo on the CPU. A single process with N = 1 (no group of more than one
rank) has nothing to shard: it trains on its one device with plain
tensors and joins no group. Each rank of a mesh holds its shard of the
parameters and of the AdamW state (``sharding.rules``), computes on its
shard of the batch and gathers each block's weights when it runs
(``sharding.act``). ``--mesh prod`` / ``prod-multi`` need 256 / 512 ranks
and raise otherwise.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch
import torch.distributed as dist
from torch import nn

from repro_torch import configs
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.data.tokens import TokenPipeline
from repro_torch.ft.failures import FaultTolerantLoop
from repro_torch.ft.straggler import StragglerDetector
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import get_family
from repro_torch.models.base import ModelConfig
from repro_torch.optim import adamw
from repro_torch.sharding import rules
from repro_torch.train.step import make_train_step


def build_trainer(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                  microbatches: int = 1, seed: int = 0, device="cuda",
                  mesh=None, profile: str = "fsdp_tp"):
    """-> (model, opt_state, train_step): ``cfg``'s family with random
    float32 master weights from ``seed`` on ``device``, its AdamW state,
    and ``make_train_step(cfg, opt_cfg, microbatches, mesh=mesh)``. With a
    mesh every rank draws the same weights and keeps only its shard of
    each (a DTensor placed by ``rules.param_specs(model, mesh, profile)``),
    and the AdamW state takes the same placements."""
    dev = ops.resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    model = get_family(cfg).init(cfg, g, dev, param_dtype=torch.float32)
    if mesh is not None:
        _place_params(model, mesh, rules.param_specs(model, mesh, profile))
    opt_state = adamw.init(dict(model.named_parameters()))
    return model, opt_state, make_train_step(
        cfg, opt_cfg, n_microbatches=microbatches, mesh=mesh)


def _place_params(model: nn.Module, mesh, specs: dict) -> None:
    """Replace each parameter of ``model`` by a DTensor parameter holding
    this rank's shard of it (``specs``: name -> ``rules.Spec``), one
    parameter at a time."""
    for name, spec in specs.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        full = mod._parameters[leaf].detach()
        mod.register_parameter(leaf, nn.Parameter(
            rules.place(full, mesh, spec.placements)))
        del full


def join_process_group(device) -> torch.device:
    """Initialise the default process group unless one is: from torchrun's
    environment if set, else one rank over a ``FileStore`` in a temporary
    directory; NCCL for CUDA, gloo otherwise. -> the rank's device."""
    dev = ops.resolve_device(device)
    if dev.type == "cuda":
        index = (int(os.environ["LOCAL_RANK"]) if "LOCAL_RANK" in os.environ
                 else dev.index if dev.index is not None
                 else torch.cuda.current_device())
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            store = os.path.join(tempfile.mkdtemp(), "store")
            dist.init_process_group(backend, rank=0, world_size=1,
                                    store=dist.FileStore(store, 1))
    return dev


def _world_size() -> int:
    """Ranks of the process group this process is in or will join."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=configs.ARCHS, default="olmo-1b")
    ap.add_argument("--scale", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", choices=["host", "prod", "prod-multi"],
                    default="host")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default cuda)")
    return ap.parse_args(argv)


def build_loop(args: argparse.Namespace):
    """-> (loop, state, detector): the fault-tolerant loop ``main`` runs,
    over ``state`` = {"params": the model's parameters, "opt": its AdamW
    state}, which its step updates in place. A mesh (``--mesh prod*``,
    ``--model-parallel`` above 1, or more than one rank) joins a process
    group (``join_process_group``) and builds the mesh on it; else the
    model trains on one device with plain tensors."""
    device, mesh, rank = args.device, None, 0
    if (args.mesh != "host" or args.model_parallel > 1
            or _world_size() > 1):
        device = join_process_group(args.device)
        rank = dist.get_rank()
        if args.mesh == "host":
            mesh = make_host_mesh(model=args.model_parallel,
                                  device=device.type)
        else:
            mesh = make_production_mesh(multi_pod=args.mesh == "prod-multi",
                                        device=device.type)
    cfg = (configs.get_smoke_config(args.arch) if args.scale == "smoke"
           else configs.get_config(args.arch))
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=10,
                                total_steps=args.steps)
    model, opt_state, train_step = build_trainer(
        cfg, opt_cfg, microbatches=args.microbatches, device=device,
        mesh=mesh)
    pipeline = TokenPipeline(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                             device=device)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    detector = StragglerDetector()
    state = {"params": dict(model.named_parameters()), "opt": opt_state}
    t_last = [time.perf_counter()]

    def step_fn(state, batch):
        _, _, metrics = train_step(model, state["opt"], batch)
        float(metrics["loss"])          # the step's sync
        now = time.perf_counter()
        detector.record(rank, now - t_last[0])
        t_last[0] = now
        return state, metrics

    loop = FaultTolerantLoop(step_fn, ckpt, pipeline,
                             save_every=args.save_every)
    return loop, state, detector


def main(argv=None, inject=None):
    """Train as ``argv`` says; ``inject(step)`` true simulates a worker
    failure at that step (``FaultTolerantLoop.run``). Returns the log."""
    args = parse_args(argv)
    had_group = dist.is_initialized()
    try:
        loop, state, detector = build_loop(args)
        state, log = loop.run(state, args.steps, inject=inject)
        rank = dist.get_rank() if dist.is_initialized() else 0
    finally:
        if dist.is_initialized() and not had_group:
            dist.destroy_process_group()
    if rank:                 # every rank holds the same log; rank 0 prints
        return log
    for rec in log[:: max(args.log_every, 1)] + log[-1:]:
        print(f"step {rec['step']:5d} loss {rec['loss']:.4f} "
              f"lr {rec['lr']:.2e} gnorm {rec['grad_norm']:.3f}")
    if detector.stragglers():
        print("stragglers detected:", detector.stragglers())
    first, last = log[0]["loss"], log[-1]["loss"]
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return log


if __name__ == "__main__":
    main()
