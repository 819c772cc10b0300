"""Carries a reference state across frameworks as numpy arrays.

Keys are the reference's field names: ``params.a``, ``params.b``,
``params.w``, ``raw``, ``codes``, ``order``, ``bucket_codes``,
``bucket_starts``, ``bucket_sizes``, ``n_buckets``, ``n_valid`` and ``x``;
a PQ state adds ``pq.centroids``, ``pq.codes`` (uint8), ``pq.counts``,
``pq.resid``, ``pq.n_valid`` and, with 4-bit codes, ``pq.packed``; a state
with ingest epochs adds ``epochs.params_epoch`` and ``epochs.n_ingested``
(numpy uint32 both ways; int64 in the port). Dtypes are kept exactly
(int32 stays int32, uint8 stays uint8). This is how the reference's
"weights" — its LSH functions, built index and codebooks — reach the port.

A sharded reference state carries the shard axis first on every array;
:func:`sharded_state_from_numpy` takes one shard of it (a rank's state),
and :func:`sharded_state_to_numpy` stacks the shards' states back into
that layout.

:func:`cache_to_numpy` / :func:`cache_from_numpy` carry an estimate cache
the same way, field by field under the reference's names and dtypes
(``qhash`` and ``snap_params`` uint32, ``valid`` and ``ref`` bool).
:func:`neighbor_table_to_numpy` / ``_from_numpy`` carry a bucket-neighbor
table (``dists`` int8, ``n`` int32, ``max_dist`` an int), and
:func:`mlp_to_numpy` / ``mlp_from_numpy`` the learned baseline (``refs``,
``w1`` … ``b3`` float32, in the reference's (in, out) layout).

:func:`lm_params_from_numpy` / :func:`lm_params_to_numpy` carry an LM's
weights, of any family, under the reference param tree's paths,
dot-joined: ``embed.embedding``, ``embed.lm_head`` (untied),
``final_norm.scale``, and the stacked blocks with their leading axis:
``layers.attn.wq`` … ``layers.ln1.scale`` (dense, moe, rwkv6),
``groups.rec1.mix.w_in`` (rglru, G groups) and ``tail.mix.w_in`` (its
``n_layers % 3`` recurrent blocks), ``enc_layers.*`` / ``dec_layers.*``
(whisper). A stacked prefix is a ``ModuleList`` of the port's model; its
entries are split along the leading axis and joined again (float32 numpy
both ways; the port stores each weight in its own dtype, or the matrices
in ``param_dtype``). :func:`adamw_state_from_numpy` /
:func:`adamw_state_to_numpy` carry an AdamW state the same way: ``m.`` and
``v.`` before each param path, and ``step``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.cache.epochs import EpochState
from repro_torch.cache.estimate_cache import EstimateCache
from repro_torch.core import baselines, lsh, neighbors, pq as pqmod
from repro_torch.core.estimator import ProberState
from torch import nn

from repro_torch.models import get_family
from repro_torch.models.base import ModelConfig

_INDEX_FIELDS = ("raw", "codes", "order", "bucket_codes", "bucket_starts",
                 "bucket_sizes", "n_buckets", "n_valid")
KEYS = ("params.a", "params.b", "params.w", *_INDEX_FIELDS, "x")
_PQ_FIELDS = ("centroids", "codes", "counts", "resid", "n_valid")
PQ_KEYS = tuple(f"pq.{k}" for k in _PQ_FIELDS)    # plus optional pq.packed
EPOCH_KEYS = tuple(f"epochs.{k}" for k in EpochState._fields)
_UINT32 = ("qhash", "snap_params")       # cache fields held in int64


def _to_torch(a, device) -> torch.Tensor:
    """numpy → torch, uint32 widened to int64 (torch keeps uint32 values
    in int64 here)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.tensor(a, device=device)


def state_from_numpy(d: dict[str, np.ndarray], device) -> ProberState:
    missing = [k for k in KEYS if k not in d]
    if missing:
        raise KeyError(f"missing state fields: {missing}")

    def t(k):
        return _to_torch(d[k], device)

    params = lsh.LSHParams(t("params.a"), t("params.b"), t("params.w"))
    index = lsh.LSHIndex(params, *(t(k) for k in _INDEX_FIELDS))
    pq = None
    if any(k.startswith("pq.") for k in d):
        missing = [k for k in PQ_KEYS if k not in d]
        if missing:
            raise KeyError(f"missing PQ fields: {missing}")
        pq = pqmod.PQIndex(*(t(k) for k in PQ_KEYS),
                           packed=t("pq.packed") if "pq.packed" in d else None)
    epochs = None
    if any(k.startswith("epochs.") for k in d):
        epochs = EpochState(*(t(k) for k in EPOCH_KEYS))
    return ProberState(index=index, x=t("x"), pq=pq, epochs=epochs)


def state_to_numpy(state: ProberState) -> dict[str, np.ndarray]:
    ix = state.index
    out = {"params.a": ix.params.a, "params.b": ix.params.b,
           "params.w": ix.params.w, "x": state.x}
    out.update({k: getattr(ix, k) for k in _INDEX_FIELDS})
    if state.pq is not None:
        out.update({f"pq.{k}": getattr(state.pq, k) for k in _PQ_FIELDS})
        if state.pq.packed is not None:
            out["pq.packed"] = state.pq.packed
    out = {k: v.detach().cpu().numpy() for k, v in out.items()}
    if state.epochs is not None:
        out.update({k: v.cpu().numpy().astype(np.uint32)
                    for k, v in zip(EPOCH_KEYS, state.epochs)})
    return out


def sharded_state_from_numpy(d: dict[str, np.ndarray], shard: int,
                             device) -> ProberState:
    """Shard ``shard`` of a sharded state (the shard axis first)."""
    return state_from_numpy({k: np.asarray(v)[shard] for k, v in d.items()},
                            device)


def sharded_state_to_numpy(
        states: Sequence[ProberState]) -> dict[str, np.ndarray]:
    """The shards' states, in shard order, stacked on a leading shard axis;
    the shards must have the same shapes."""
    ds = [state_to_numpy(s) for s in states]
    return {k: np.stack([d[k] for d in ds]) for k in ds[0]}


def cache_from_numpy(d: dict[str, np.ndarray], device) -> EstimateCache:
    missing = [k for k in EstimateCache._fields if k not in d]
    if missing:
        raise KeyError(f"missing cache fields: {missing}")
    return EstimateCache(*(_to_torch(d[k], device)
                           for k in EstimateCache._fields))


def cache_to_numpy(cache: EstimateCache) -> dict[str, np.ndarray]:
    out = {}
    for k, v in zip(EstimateCache._fields, cache):
        a = v.detach().cpu().numpy()
        out[k] = a.astype(np.uint32) if k in _UINT32 else a
    return out


def neighbor_table_from_numpy(d: dict, device) -> neighbors.NeighborTable:
    return neighbors.NeighborTable(
        dists=_to_torch(np.asarray(d["dists"], np.int8), device),
        n=_to_torch(np.asarray(d["n"], np.int32), device),
        max_dist=int(d["max_dist"]))


def neighbor_table_to_numpy(table: neighbors.NeighborTable) -> dict:
    return {"dists": table.dists.cpu().numpy(),
            "n": table.n.cpu().numpy().astype(np.int32),
            "max_dist": int(table.max_dist)}


def mlp_from_numpy(d: dict, device) -> baselines.MLPEstimator:
    missing = [k for k in baselines.MLP_FIELDS if k not in d]
    if missing:
        raise KeyError(f"missing MLP fields: {missing}")
    return baselines.MLPEstimator(*(
        _to_torch(np.asarray(d[k], np.float32), device)
        for k in baselines.MLP_FIELDS))


def mlp_to_numpy(m: baselines.MLPEstimator) -> dict[str, np.ndarray]:
    return {k: getattr(m, k).detach().cpu().numpy()
            for k in baselines.MLP_FIELDS}


def _stacks(model: nn.Module) -> dict[str, int]:
    """The model's stacked prefixes (its ``ModuleList`` children) and
    their lengths."""
    return {name: len(m) for name, m in model.named_children()
            if isinstance(m, nn.ModuleList)}


def _unstack(d: dict[str, np.ndarray], model: nn.Module
             ) -> dict[str, np.ndarray]:
    """Reference paths -> the model's parameter names (a stacked prefix
    split along its leading axis), checked against the model's names and
    shapes."""
    want = dict(model.named_parameters())
    stacks = _stacks(model)
    sd = {}
    for k, v in d.items():
        v = np.asarray(v)
        prefix, _, sub = k.partition(".")
        if prefix in stacks:
            if v.shape[0] != stacks[prefix]:
                raise ValueError(f"{k}: {v.shape[0]} layers, the model has "
                                 f"{stacks[prefix]} in {prefix!r}")
            sd.update({f"{prefix}.{i}.{sub}": v[i]
                       for i in range(stacks[prefix])})
        else:
            sd[k] = v
    if set(sd) != set(want):
        raise KeyError(f"params do not fit the model: missing "
                       f"{sorted(set(want) - set(sd))}, unexpected "
                       f"{sorted(set(sd) - set(want))}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: shape {v.shape}, expected "
                             f"{tuple(want[k].shape)}")
    return sd


def stack_named(named, model: nn.Module) -> dict[str, np.ndarray]:
    """(parameter name, tensor) pairs in the model's order -> reference
    paths, float32, each stacked prefix's entries stacked on a leading
    axis."""
    stacks = _stacks(model)
    out: dict[str, list] = {}
    for k, v in named:
        a = v.detach().float().cpu().numpy()
        prefix, _, rest = k.partition(".")
        if prefix in stacks:
            out.setdefault(f"{prefix}.{rest.split('.', 1)[1]}", []).append(a)
        else:
            out[k] = a
    return {k: np.stack(v) if isinstance(v, list) else v
            for k, v in out.items()}


def _meta_model(cfg: ModelConfig, param_dtype=None) -> nn.Module:
    return get_family(cfg).init(cfg, torch.Generator(), "meta", param_dtype)


def lm_params_from_numpy(d: dict[str, np.ndarray], cfg: ModelConfig,
                         device, param_dtype: torch.dtype | None = None
                         ) -> nn.Module:
    """The model of ``cfg``'s family holding the reference's params ``d``
    (path -> array; a stacked prefix with its leading axis), each
    converted to the port's storage dtype (``param_dtype`` for the
    matrices when given: ``torch.float32`` holds them as the reference
    and the trainer do)."""
    model = _meta_model(cfg, param_dtype)
    want = model.state_dict()
    sd = {k: torch.tensor(v, dtype=want[k].dtype, device=device)
          for k, v in _unstack(d, model).items()}
    model.load_state_dict(sd, assign=True)
    return model


def lm_params_to_numpy(model: nn.Module) -> dict[str, np.ndarray]:
    """The model's weights under the reference's paths, float32, each
    stacked prefix's entries stacked on a leading axis."""
    return stack_named(model.named_parameters(), model)


def adamw_state_from_numpy(d: dict[str, np.ndarray], cfg: ModelConfig,
                           device) -> dict:
    """A reference AdamW state (``m.<path>`` and ``v.<path>`` under the
    param paths, ``step``) as the port's ``optim.adamw`` state of a model
    of ``cfg``: float32 ``m`` / ``v`` keyed by the model's parameter names,
    an int32 ``step``."""
    model = _meta_model(cfg)
    state = {}
    for part in ("m", "v"):
        sub = {k[len(part) + 1:]: v for k, v in d.items()
               if k.startswith(part + ".")}
        state[part] = {k: torch.tensor(v, dtype=torch.float32, device=device)
                       for k, v in _unstack(sub, model).items()}
    state["step"] = torch.tensor(np.asarray(d["step"]), dtype=torch.int32,
                                 device=device)
    return state


def adamw_state_to_numpy(state: dict, model: nn.Module
                         ) -> dict[str, np.ndarray]:
    """The port's AdamW state of ``model`` under the reference's paths:
    ``m.<path>``, ``v.<path>`` (stacked as the params) and ``step``
    (int32)."""
    out = {}
    for part in ("m", "v"):
        named = ((k, state[part][k]) for k, _ in model.named_parameters())
        out.update({f"{part}.{k}": v
                    for k, v in stack_named(named, model).items()})
    out["step"] = state["step"].cpu().numpy().astype(np.int32)
    return out
