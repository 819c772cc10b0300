"""Train-step factory (port of ``repro/train/step.py``): loss -> gradients
-> AdamW, with optional microbatch gradient accumulation and an optional
gradient transform (the compression hook, ``optim/compression.py``).

The model is an ``nn.Module`` of a family (``models.get_family``) whose
parameters are updated in place; the trainer holds them in float32
(``init(..., param_dtype=torch.float32)``), as the reference holds every
parameter. The reference's ``unroll_layers`` patches ``lax.scan`` for the
dry run's cost analysis and has no counterpart: the port runs its layers in
a Python loop, which the dry run (``launch/dryrun.py``) traces layer by
layer.

On a mesh (``mesh=``; the parameters and AdamW state are DTensors placed
by ``sharding.rules``, ``launch/train.build_trainer``) every rank runs the
same step on its own shard of each microbatch (``rules.batch_specs``), its
blocks gathering their weights one at a time over the data axes
(``sharding.act``). Every family keeps the "model" shards and computes
the rank's heads, channels, d_ff columns, experts and vocab slice
(tensor and expert parallelism). The gradients reach ``.grad`` in the parameters'
placements, averaged over the data ranks (a "model"-sharded parameter's
gradient is its shard's, a replicated one's the same on every "model"
rank), and the loss, the same on every "model" rank, is averaged over the
data axes alone.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.models import get_family
from repro_torch.models.base import ModelConfig
from repro_torch.optim import adamw
from repro_torch.sharding import act, rules


def make_loss_fn(cfg: ModelConfig):
    fam = get_family(cfg)
    return lambda model, batch: fam.loss_fn(model, batch, cfg)


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    n_microbatches: int = 1,
                    grad_transform: Callable[[dict], dict] | None = None,
                    mesh=None):
    """Returns train_step(model, opt_state, batch) -> (model, opt_state,
    metrics): ``metrics`` holds ``loss``, ``lr`` and ``grad_norm`` as
    device scalars; the model's parameters and ``opt_state`` are updated
    in place (``adamw.update``).

    ``n_microbatches`` > 1 splits the batch on dim 0 into that many
    contiguous slices (the reference's reshape) and runs a backward pass
    for each: the float32 ``.grad`` of the parameters accumulates them
    (the first backward writes g1 = 0 + g1 exactly, so the sum is the
    reference's scan sum without a second buffer of gradients), then is
    divided by ``n_microbatches``, and so is the loss. A parameter the
    loss does not reach gets a zero gradient, as ``jax.grad`` gives it.
    ``grad_transform(grads) -> grads`` maps the gradient dict (parameter
    name -> tensor) before AdamW. The gradients are released after the
    update.

    With ``mesh``, each microbatch is the rank's shard of the reference's
    microbatch (the rows the reference's sharding gives the rank), and
    ``metrics["loss"]`` is averaged over the data ranks.
    """
    loss_fn = make_loss_fn(cfg)
    if mesh is None:
        local, sharding = _whole, contextlib.nullcontext
    else:
        dp = tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
        local = _local_batch(mesh)
        sharding = lambda: act.activation_sharding(mesh, dp)   # noqa: E731

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        for k, p in params.items():
            if p.dtype != torch.float32:
                raise ValueError(f"{k} is {p.dtype}: the trainer keeps "
                                 "float32 parameters (init(..., "
                                 "param_dtype=torch.float32))")
            p.grad = None
        with sharding():
            if n_microbatches > 1:
                micro = [_split(x, n_microbatches) for x in batch.values()]
                loss = 0.0
                for i in range(n_microbatches):
                    mb = local({k: parts[i]
                                for k, parts in zip(batch, micro)})
                    mloss = loss_fn(model, mb)
                    mloss.backward()
                    loss = loss + mloss.detach()
                loss = loss / n_microbatches
            else:
                loss = loss_fn(model, local(batch))
                loss.backward()
                loss = loss.detach()
        if mesh is not None:
            loss = _data_mean(loss, mesh, dp)
        grads = {}
        for k, p in params.items():
            if p.grad is None:
                p.grad = torch.zeros_like(p, dtype=torch.float32)
            elif n_microbatches > 1:
                p.grad.div_(n_microbatches)
            grads[k] = p.grad
        if grad_transform is not None:
            grads = grad_transform(grads)
        _, opt_state, metrics = adamw.update(grads, opt_state, params,
                                             opt_cfg)
        for p in params.values():
            p.grad = None
        metrics["loss"] = loss
        return model, opt_state, metrics

    return train_step


def _whole(batch: dict) -> dict:
    return batch


def _local_batch(mesh):
    """batch -> this rank's rows of each input (``rules.batch_specs``); an
    input already placed on the mesh (a DTensor, as the dry run passes the
    production batch) is its own local shard."""
    def local(batch: dict) -> dict:
        specs = rules.batch_specs(batch, mesh)
        return {k: x.to_local() if isinstance(x, DTensor)
                else rules.local_chunk(x, mesh, specs[k].placements)
                for k, x in batch.items()}
    return local


def _data_mean(loss: torch.Tensor, mesh, dp: tuple) -> torch.Tensor:
    """The ranks' losses averaged over the data axes (the same on every
    rank)."""
    placements = [Partial("avg") if a in dp else Replicate()
                  for a in mesh.mesh_dim_names]
    return DTensor.from_local(loss, mesh, placements,
                              run_check=False).full_tensor()


def _split(x: torch.Tensor, n: int):
    """dim 0 of ``x`` in ``n`` contiguous slices of equal size."""
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} does not split into {n} "
                         "microbatches")
    return torch.split(x, x.shape[0] // n)
