"""The port's one collective, counted.

Every ``all_reduce`` of the distributed path (the pooled W, the prober's
pooled setup and slab steps, the shard counts, the local mode's sum, the
coalescer's SPMD checks) goes through :func:`all_reduce`, which adds one to
``COUNT["calls"]`` and its host seconds to ``COUNT["seconds"]``, as
``ops.LAUNCHES`` counts kernel launches. The seconds include waiting for the
device work queued before the call and for the peers: gloo stages a CUDA
tensor through the host and returns when the reduction is done, while NCCL
returns once the reduction is queued, so under NCCL they are the enqueue
time only.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

COUNT: dict[str, float] = {"calls": 0, "seconds": 0.0}


def reset() -> None:
    COUNT["calls"], COUNT["seconds"] = 0, 0.0


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> None:
    """``torch.distributed.all_reduce(t, op, group=group)`` in place,
    counted in :data:`COUNT`."""
    t0 = time.perf_counter()
    dist.all_reduce(t, op, group=group)
    COUNT["seconds"] += time.perf_counter() - t0
    COUNT["calls"] += 1
