"""Failure handling for the training driver (the port's copy of
``repro/ft/failures.py``).

``FaultTolerantLoop`` wraps the step function: any step raising
``WorkerFailure`` (injected in tests; on a real cluster the surfaced
runtime error or a missed heartbeat) triggers restore-from-latest-valid
checkpoint and resumption. A ``HeartbeatMonitor`` tracks per-rank liveness
the way a cluster-level driver would; ranks missing ``timeout`` seconds
are declared dead (tests drive this clock manually).

The port's step functions may update the state's tensors in place (the
trainer's do), so a restore copies the checkpoint's values INTO the
state's tensors and the loop goes on with the same objects: a restart
never goes on from what the failed step left. As in the reference, a
failure before the first checkpoint restarts the cursor at 0 from the
state as the loop holds it.
"""
from __future__ import annotations

import time
from typing import Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.sharding import rules


class WorkerFailure(RuntimeError):
    """A (simulated or real) device/host failure during a step."""


class HeartbeatMonitor:
    def __init__(self, n_ranks: int, timeout: float = 60.0):
        self.timeout = timeout
        self.last = {r: time.monotonic() for r in range(n_ranks)}

    def beat(self, rank: int, now: float | None = None):
        self.last[rank] = now if now is not None else time.monotonic()

    def dead_ranks(self, now: float | None = None) -> list[int]:
        now = now if now is not None else time.monotonic()
        return [r for r, t in self.last.items() if now - t > self.timeout]


@torch.no_grad()
def copy_into(dst: dict, src: dict) -> None:
    """Copy every tensor of ``src`` into the same leaf of ``dst`` (nested
    dicts of the same structure), in place. A DTensor leaf of ``dst`` takes
    its own shard of a full tensor of ``src`` (a restored checkpoint)."""
    for k, v in dst.items():
        if isinstance(v, dict):
            copy_into(v, src[k])
        elif isinstance(v, DTensor) and not isinstance(src[k], DTensor):
            v.to_local().copy_(rules.local_chunk(src[k], v.device_mesh,
                                                 v.placements))
        else:
            v.copy_(src[k])


class FaultTolerantLoop:
    """Run steps with checkpoint/restart semantics.

    step_fn(state, batch) -> (state, metrics); state is nested dicts of
    tensors, updated in place or returned anew.
    """

    def __init__(self, step_fn: Callable, ckpt_manager, pipeline,
                 save_every: int = 50, max_restarts: int = 8):
        self.step_fn = step_fn
        self.ckpt = ckpt_manager
        self.pipeline = pipeline
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.restarts = 0

    def _restore(self, state):
        got = self.ckpt.restore(state)
        if got is None:
            # no checkpoint yet: restart the cursor at 0
            self.pipeline.load_state_dict({"seed": self.pipeline.seed,
                                           "step": 0})
            return state, 0
        st, extra, step = got
        if "pipeline" in extra:
            self.pipeline.load_state_dict(extra["pipeline"])
        copy_into(state, st)
        return state, step

    def run(self, state, n_steps: int,
            inject: Callable[[int], bool] | None = None):
        """Returns (final_state, metrics_log). ``inject(step)`` true ->
        simulate a worker failure at that step (before it commits)."""
        log = []
        step = 0
        # resume if a checkpoint exists
        state, step = self._restore(state)
        while step < n_steps:
            try:
                if inject is not None and inject(step):
                    raise WorkerFailure(f"injected failure at step {step}")
                batch = self.pipeline.next()
                state, metrics = self.step_fn(state, batch)
                step += 1
                log.append({"step": step,
                            **{k: float(v) for k, v in metrics.items()}})
                if step % self.save_every == 0 or step == n_steps:
                    self.ckpt.save(step, state, extra={
                        "pipeline": self.pipeline.state_dict()})
            except WorkerFailure:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                state, step = self._restore(state)
        return state, log
