"""Parameter-sharding rules (port of ``repro/sharding/rules.py``): a
parameter's name -> its spec on a mesh (DESIGN.md §4).

Placeholders in the rule table resolve per profile:
  * "model" — tensor/expert parallel axis.
  * "fsdp"  — parameter sharding over the within-pod data axis (ZeRO-style);
              resolves to "data" in the ``fsdp_tp`` profile and to ``None``
              in plain ``tp``.

Every resolved axis is checked for divisibility against the actual dim size;
non-divisible axes drop to ``None`` (replicated) rather than erroring (e.g.
whisper's 51865 vocab or 28-head attention vs model=16).

The table is the reference's, by value, matched against the reference's
``/``-joined stacked paths: a port parameter name (``layers.3.attn.wq``,
``groups.0.rec1.mix.w_in``, ``dec_layers.5.cross_attn.wo``) drops its layer
indices (``layers/attn/wq``), as ``bridge.py`` maps its stacked prefixes.
A per-layer leaf has no leading layer axis, and the template's trailing
alignment drops the entries that axis would take.

A spec is a :class:`Spec`: ``axes``, one entry per tensor dim (the
reference's ``PartitionSpec`` entries: an axis name, a tuple of names, or
``None``), and ``placements``, one ``Shard(dim)`` / ``Replicate()`` per
mesh dimension, for ``DTensor``. A mesh is a ``DeviceMesh`` or a dict of
axis name -> size (the specs need only the axes' sizes).
"""
from __future__ import annotations

import re
from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

# (path regex, spec template) — first match wins; template entries align with
# trailing dims when the leaf has a leading layer-stack axis.
RULES: list[tuple[str, tuple]] = [
    (r"embed/embedding$",                      ("model", "fsdp")),
    (r"embed/lm_head$",                        ("fsdp", "model")),
    (r"dec_pos$",                              (None, None)),
    # attention projections (incl. rglru's attn blocks under mix/)
    (r"(attn|mix)/w[qkv]$",                    (None, "fsdp", "model")),
    (r"(attn|mix)/wo$",                        (None, "model", "fsdp")),
    (r"(attn|mix)/b[qkv]$",                    (None, "model")),
    (r"(q_norm|k_norm)$",                      (None, None)),
    # dense mlp
    (r"mlp/w[ig]$",                            (None, "fsdp", "model")),
    (r"mlp/wo$",                               (None, "model", "fsdp")),
    # moe (L,E,D,F): experts over "model" (EP), d_model over fsdp
    (r"moe/router$",                           (None, "fsdp", None)),
    (r"moe/w[ig]$",                            (None, "model", "fsdp", None)),
    (r"moe/wo$",                               (None, "model", None, "fsdp")),
    # rglru recurrent mix
    (r"mix/w_(in|gate)$",                      (None, "fsdp", "model")),
    (r"mix/w_out$",                            (None, "model", "fsdp")),
    (r"mix/conv_w$",                           (None, None, "model")),
    (r"mix/(conv_b|lru_lambda|b_a|b_x)$",      (None, "model")),
    (r"mix/w_[ax]$",                           (None, "fsdp", "model")),
    # rwkv time mix
    (r"tm/w[rkvg]$",                           (None, "fsdp", "model")),
    (r"tm/wo$",                                (None, "model", "fsdp")),
    (r"tm/lora_a$",                            (None, "fsdp", None)),
    (r"tm/lora_b$",                            (None, None, None, "fsdp")),
    (r"tm/decay_a$",                           (None, "fsdp", None)),
    (r"tm/decay_b$",                           (None, None, "fsdp")),
    (r"tm/(mu_x|w0|u|ln_scale)$",              (None, "fsdp")),
    (r"tm/mu$",                                (None, None, "fsdp")),
    # rwkv channel mix
    (r"cm/w[kr]$",                             (None, "fsdp", "model")),
    (r"cm/wv$",                                (None, "model", "fsdp")),
    (r"cm/mu_[kr]$",                           (None, "fsdp")),
]


class Spec(NamedTuple):
    axes: tuple          # per tensor dim: axis name, tuple of names, None
    placements: tuple    # per mesh dim: Shard(dim) or Replicate()


def mesh_axes(mesh) -> dict[str, int]:
    """Axis name -> size, in the mesh's order."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def reference_path(name: str) -> str:
    """A port parameter name as the reference's stacked path:
    ``layers.3.attn.wq`` -> ``layers/attn/wq``."""
    return "/".join(p for p in name.split(".") if not p.isdigit())


def _spec(axes: tuple, sizes: dict[str, int]) -> Spec:
    placements = [Replicate()] * len(sizes)
    names = list(sizes)
    for dim, entry in enumerate(axes):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                placements[names.index(a)] = Shard(dim)
    return Spec(tuple(axes), tuple(placements))


def _resolve(template: tuple, shape: tuple, sizes: dict[str, int],
             profile: str) -> tuple:
    """Align the template to the TRAILING dims of ``shape`` — leading dims
    (layer stacks of any depth) stay unsharded; a too-long template loses its
    leading entries (stacked and per-layer leaves alike)."""
    tpl = tuple(template)
    if len(tpl) > len(shape):
        tpl = tpl[len(tpl) - len(shape):]
    if len(tpl) < len(shape):
        tpl = (None,) * (len(shape) - len(tpl)) + tpl
    out = []
    for dim, want in zip(shape, tpl):
        axis = None
        if want == "model":
            axis = "model"
        elif want == "fsdp" and profile == "fsdp_tp":
            axis = "data"
        if axis is not None and dim % sizes[axis] != 0:
            axis = None                      # divisibility fallback
        out.append(axis)
    return tuple(out)


def _shapes(model_or_shapes) -> dict[str, tuple]:
    if isinstance(model_or_shapes, torch.nn.Module):
        model_or_shapes = dict(model_or_shapes.named_parameters())
    return {k: tuple(getattr(v, "shape", v))
            for k, v in model_or_shapes.items()}


def param_specs(model_or_shapes: Any, mesh, profile: str = "fsdp_tp"
                ) -> dict[str, Spec]:
    """Parameter name -> :class:`Spec`, for a model (its
    ``named_parameters``) or a dict of name -> tensor or shape."""
    sizes = mesh_axes(mesh)
    out = {}
    for name, shape in _shapes(model_or_shapes).items():
        path = reference_path(name)
        axes = (None,) * len(shape)
        for rx, tpl in RULES:
            if re.search(rx, path):
                axes = _resolve(tpl, shape, sizes, profile)
                break
        out[name] = _spec(axes, sizes)
    return out


def _data_axes(sizes: dict[str, int]) -> tuple:
    return tuple(a for a in sizes if a in ("pod", "data"))


def _batch_entry(b: int, sizes: dict[str, int]):
    """The data axes (dropped from the front until their product divides
    ``b``) as one spec entry."""
    axes = _data_axes(sizes)
    while axes and (b == 0 or b % _prod(sizes, axes) != 0):
        axes = axes[1:]
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def batch_specs(batch_shape: dict, mesh) -> dict[str, Spec]:
    """Shard the leading (batch) dim of every input over all data-like
    axes."""
    sizes = mesh_axes(mesh)

    def spec_for(leaf):
        shape = tuple(getattr(leaf, "shape", leaf))
        if not shape:
            return _spec((), sizes)
        first = _batch_entry(shape[0], sizes)
        return _spec((first,) + (None,) * (len(shape) - 1), sizes)

    return _tree_map(spec_for, batch_shape)


def cache_specs(cache_shape: dict, mesh) -> dict:
    """KV caches / recurrent state: (L, B, ...) -> batch dim sharded over
    data axes, head-like dims over model when divisible."""
    sizes = mesh_axes(mesh)
    model = sizes["model"]

    def spec_for(leaf):
        shape = tuple(getattr(leaf, "shape", leaf))
        nd = len(shape)
        if nd <= 1:
            return _spec((None,) * nd, sizes)
        spec = [None, _batch_entry(shape[1], sizes)] + [None] * (nd - 2)
        if nd == 5 and shape[3] == shape[4] and shape[2] % model == 0:
            # rwkv matrix state (L,B,H,hd,hd): heads over model
            spec[2] = "model"
        elif nd == 5:
            # KV cache (L,B,S,KV,hd): prefer kv-head sharding; fall back to
            # SEQUENCE sharding (flash-decode style), then head-dim
            if shape[3] % model == 0:
                spec[3] = "model"
            elif shape[2] % model == 0:
                spec[2] = "model"
            elif shape[4] % model == 0:
                spec[4] = "model"
        elif nd == 4 and shape[2] >= 1024 and shape[2] % model == 0:
            # KV-quantization scale cache (L,B,S,KV): follow the seq shard
            spec[2] = "model"
        elif nd in (3, 4) and shape[-1] % model == 0:
            # recurrent channel states (G,B,W) / conv states (G,B,cw-1,W):
            # channels over model (RG-LRU is elementwise -> no comm)
            spec[-1] = "model"
        return _spec(tuple(spec), sizes)

    return _tree_map(spec_for, cache_shape)


def _prod(sizes: dict[str, int], axes: tuple) -> int:
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _tree_map(fn, tree: dict) -> dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def local_chunk(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``placements``
    (each ``Shard(d)`` over mesh dim i: the mesh coordinate's chunk of dim
    d, in mesh-dim order, as DTensor splits it). A view of ``t``."""
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            t = t.chunk(mesh.size(i), dim=pl.dim)[coord[i]]
    return t


def place(t: torch.Tensor, mesh, placements, device=None) -> DTensor:
    """The full tensor ``t`` (the same on every rank) as a DTensor holding
    only this rank's block, copied to ``device`` (``t``'s by default): no
    collective."""
    local = local_chunk(t, mesh, placements).to(
        device=device or t.device, memory_format=torch.contiguous_format,
        copy=True)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())
