"""Deterministic synthetic LM token pipeline (port of
``repro/data/tokens.py``).

Batch t is a pure function of (seed, step), so a restart from a
checkpointed cursor reproduces the same stream. The reference draws from
``jax.random``, whose generator is not ported; here batch t is drawn on
the CPU by a ``torch.Generator`` seeded with ``seed·2³² + step`` and then
moved to ``device``, so it is the same on the CPU and on the card. The
construction is the reference's: an exponentially quantised Zipf-like
marginal ``floor(−log(1−u)·V/8)`` clipped to [0, V), each odd position
replaced by its preceding token plus a per-sequence shift in [1, 17)
(mod V), so the cross-entropy has structure to learn; ``labels`` is
``tokens``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops

_STEP_BITS = 32


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    batch: int              # global batch
    seq: int
    seed: int = 0
    step: int = 0           # cursor — saved/restored by the checkpointer
    device: str = "cuda"

    def state_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, st: dict) -> None:
        self.seed = int(st["seed"])
        self.step = int(st["step"])

    def _batch_at(self, step: int) -> dict:
        g = torch.Generator().manual_seed((self.seed << _STEP_BITS) + step)
        u = torch.rand((self.batch, self.seq), generator=g)
        z = torch.floor(-torch.log(1 - u) * (self.vocab / 8.0))
        base = torch.clamp(z, 0, self.vocab - 1).long()
        shift = torch.randint(1, 17, (self.batch, 1), generator=g)
        dep = (torch.roll(base, 1, dims=1) + shift) % self.vocab
        odd = (torch.arange(self.seq) % 2 == 1)[None, :]
        tokens = torch.where(odd, dep, base).to(
            ops.resolve_device(self.device))
        return {"tokens": tokens, "labels": tokens}

    def next(self) -> dict:
        b = self._batch_at(self.step)
        self.step += 1
        return b
