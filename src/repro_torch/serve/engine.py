"""Batched LM serving engine (port of ``Request`` / ``ServeEngine`` in
``repro/serve/engine.py``): static-slot continuous batching over the dense
family's prefill / decode path.

A request queue, fixed decode slots, per-slot positions, EOS / length
retirement, and step-level batching: every decode step advances all live
slots in one ``decode_step`` call. A request is prefilled alone and its
cache row copied into its slot in place; the slots' cache is allocated
once. The request coalescer for the estimator is in
:mod:`repro_torch.serve.coalescer`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.models import get_family
from repro_torch.models.base import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """``submit`` queues a :class:`Request`; ``step`` admits queued
    requests into free slots (one prefill each) and decodes one token for
    every live slot; ``run`` steps until idle. ``stats`` counts prefills,
    decode steps, tokens and their host seconds (each ends in a read of
    the chosen tokens, so the device work is inside them).

    Raises ``ValueError`` for a family other than dense and for a
    ``kv_quant`` config: the reference's engine cannot serve one either
    (its admission rebuilds the cache without the int8 scales)."""

    def __init__(self, cfg: ModelConfig, params, batch_slots: int = 4,
                 max_len: int = 256, eos: int = 1):
        if cfg.family != "dense":
            raise ValueError(f"the engine drives the dense family, not "
                             f"{cfg.family!r}")
        if cfg.kv_quant:
            raise ValueError(f"{cfg.name}: the engine serves no int8 KV "
                             "cache (kv_quant)")
        self.cfg = cfg
        self.fam = get_family(cfg)
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.eos = eos
        self.device = next(params.parameters()).device
        self.cache = self.fam.init_cache(cfg, batch_slots, max_len,
                                         device=self.device)
        # per-slot decode positions: slots prefill at different times with
        # different prompt lengths, so a shared scalar position would make a
        # slot admitted after a longer request write its KV at the wrong row
        # and retire early (RoPE phase and the causal mask also depend on it)
        self.cache["pos"] = torch.zeros((batch_slots,), dtype=torch.int32,
                                        device=self.device)
        self.live: list[Optional[Request]] = [None] * batch_slots
        self.queue: list[Request] = []
        self.finished: list[Request] = []     # retired but not yet returned
        self.stats = {"prefills": 0, "prefill_s": 0.0, "steps": 0,
                      "decode_s": 0.0, "tokens": 0}

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for i in range(self.slots):
            if self.live[i] is None and self.queue:
                req = self.queue.pop(0)
                t0 = time.perf_counter()
                tokens = torch.as_tensor(np.asarray(req.prompt),
                                         device=self.device)[None, :]
                cache_i, logits = self.fam.prefill(
                    self.params, {"tokens": tokens}, self.cfg,
                    max_len=self.max_len)
                # copy the single-sequence cache into slot i in place;
                # position is per-slot: only slot i takes the new length
                self.cache["k"][:, i].copy_(cache_i["k"][:, 0])
                self.cache["v"][:, i].copy_(cache_i["v"][:, 0])
                self.cache["pos"][i] = cache_i["pos"]
                req.out.append(int(torch.argmax(logits[0])))
                self.stats["prefills"] += 1
                self.stats["prefill_s"] += time.perf_counter() - t0
                self.live[i] = req

    def step(self) -> bool:
        """One decode step for every live slot."""
        self._admit()
        if not any(self.live):
            return False
        t0 = time.perf_counter()
        tokens = torch.tensor([r.out[-1] if r else 0 for r in self.live],
                              dtype=torch.int64, device=self.device)
        logits, self.cache = self.fam.decode_step(self.params, self.cache,
                                                  tokens, self.cfg)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        pos = self.cache["pos"].cpu().numpy()     # advanced by decode
        self.stats["steps"] += 1
        self.stats["decode_s"] += time.perf_counter() - t0
        for i, req in enumerate(self.live):
            if req is None:
                continue
            tok = int(nxt[i])
            req.out.append(tok)
            self.stats["tokens"] += 1
            if tok == self.eos or len(req.out) >= req.max_new or \
                    int(pos[i]) >= self.max_len - 1:
                req.done = True
                self.live[i] = None
                self.finished.append(req)
        return True

    def run(self, max_steps: int = 512) -> list[Request]:
        """Drive decode steps until idle; returns every request finished
        during the run, tracked as slots retire, so requests admitted to a
        slot before run() or submitted while it steps are returned too."""
        for _ in range(max_steps):
            if not self.step() and not self.queue:
                break
        finished, self.finished = self.finished, []
        return finished
