"""Training driver (port of ``repro/launch/train.py``): AdamW + the
fault-tolerant loop + checkpointing + straggler telemetry, end to end, on
one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --scale smoke --steps 60 --batch 8 --seq 64 --ckpt-dir ckpt \\
      --device cpu

Seeded random float32 master weights (no checkpoint is loaded unless
``--ckpt-dir`` holds one: the loop resumes from it), compute in
``cfg.dtype``, batches from ``TokenPipeline``. A step syncs once, on its
loss, where the reference blocks; the straggler clock reads the step times
there. The reference's meshes and sharding rules are not ported yet: a
``--mesh`` other than ``host`` or a ``--model-parallel`` other than 1
raises (ROADMAP queue 1, item 5).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import configs
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.data.tokens import TokenPipeline
from repro_torch.ft.failures import FaultTolerantLoop
from repro_torch.ft.straggler import StragglerDetector
from repro_torch.kernels import ops
from repro_torch.models import get_family
from repro_torch.models.base import ModelConfig
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step


def build_trainer(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                  microbatches: int = 1, seed: int = 0, device="cuda"):
    """-> (model, opt_state, train_step): ``cfg``'s family with random
    float32 master weights from ``seed`` on ``device``, its AdamW state,
    and ``make_train_step(cfg, opt_cfg, microbatches)``."""
    dev = ops.resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    model = get_family(cfg).init(cfg, g, dev, param_dtype=torch.float32)
    opt_state = adamw.init(dict(model.named_parameters()))
    return model, opt_state, make_train_step(cfg, opt_cfg,
                                             n_microbatches=microbatches)


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
    state}, which its step updates in place."""
    if args.mesh != "host" or args.model_parallel != 1:
        raise NotImplementedError(
            f"--mesh {args.mesh} --model-parallel {args.model_parallel}: "
            "meshes and sharded training are not ported yet (ROADMAP "
            "queue 1, item 5); use --mesh host --model-parallel 1")
    cfg = (configs.get_smoke_config(args.arch) if args.scale == "smoke"
           else configs.get_config(args.arch))
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=10,
                                total_steps=args.steps)
    model, opt_state, train_step = build_trainer(
        cfg, opt_cfg, microbatches=args.microbatches, device=args.device)
    pipeline = TokenPipeline(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                             device=args.device)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    detector = StragglerDetector()
    state = {"params": dict(model.named_parameters()), "opt": opt_state}
    t_last = [time.perf_counter()]

    def step_fn(state, batch):
        _, _, metrics = train_step(model, state["opt"], batch)
        float(metrics["loss"])          # the step's sync
        now = time.perf_counter()
        detector.record(0, now - t_last[0])
        t_last[0] = now
        return state, metrics

    loop = FaultTolerantLoop(step_fn, ckpt, pipeline,
                             save_every=args.save_every)
    return loop, state, detector


def main(argv=None):
    args = parse_args(argv)
    loop, state, detector = build_loop(args)
    state, log = loop.run(state, args.steps)
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
