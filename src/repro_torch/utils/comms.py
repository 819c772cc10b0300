"""Collective-byte accounting of one traced call (port of
``repro/utils/hlo.py``).

The reference reads the collectives of a compiled XLA program from its HLO
text. PyTorch has no lowered program to read, so :class:`CollectiveCounter`
is a ``TorchDispatchMode`` that sees each collective as it is issued, with
its tensors and its group: the in-place ``c10d.*`` ops (what
``torch.distributed.all_reduce`` and friends reach, e.g.
``core/collectives.py``) and the ``_c10d_functional.*`` ops (what DTensor's
redistributions reach). With the "fake" backend (``launch/mesh.fake_world``)
each one completes without sending a byte, and the counter still sees it.

Per-collective traffic is the reference's ring-algorithm wire bytes per
device, from the result bytes ``r`` and the group size ``g``, unchanged:

    all-reduce          2·r·(g-1)/g          (reduce-scatter + all-gather)
    all-gather          r·(g-1)/g
    reduce-scatter      r·(g-1)               (input = r·g, sends (g-1)/g of it)
    all-to-all          r·(g-1)/g
    collective-permute  r

A point-to-point ``send`` is counted as a collective-permute of its tensor
(the matching ``recv`` adds nothing), and a ``broadcast`` under its own
name, ``r`` a device (a pipelined ring forwards the tensor once).

The reference's ``while_trip_counts`` and its loop multipliers have no
counterpart: a trace runs every iteration of every Python loop, so each
collective is seen as often as it runs and ``mult`` is always 1.
"""
from __future__ import annotations

import traceback
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# in-place c10d ops (their result tensors are their first argument) and
# functional ones (their return value), by the reference's names
_C10D = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "broadcast_": "broadcast",
}
_FUNCTIONAL = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}

_SHORT = {torch.float32: "f32", torch.float16: "f16", torch.bfloat16: "bf16",
          torch.float64: "f64", torch.int8: "s8", torch.uint8: "u8",
          torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
          torch.bool: "pred"}


def wire_bytes(op: str, r: int, g: int) -> int:
    """Ring wire bytes a device for one collective of result bytes ``r``
    over a group of ``g`` (the reference's formulas)."""
    if op == "all-reduce":
        wire = 2.0 * r * (g - 1) / g
    elif op in ("all-gather", "all-to-all"):
        wire = r * (g - 1) / g
    elif op == "reduce-scatter":
        wire = float(r) * (g - 1)
    else:                       # collective-permute, broadcast
        wire = float(r)
    return int(wire)


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return []


def _group(args) -> dist.ProcessGroup:
    """The group among an op's arguments: a ``ProcessGroup`` script object
    (c10d) or a group name (functional)."""
    for a in args:
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(
                a._type()):
            return dist.ProcessGroup.unbox(a)
    name = args[-1]
    if isinstance(name, str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(name)
    raise ValueError(f"no group among the arguments {args!r}")


# frames that only pass a collective on: installed packages' (torch's, its
# decorators') and the port's counted all_reduce
_PASS_ON = ("site-packages", "dist-packages", "/torch/",
            "/repro_torch/core/collectives.py", "/repro_torch/utils/comms.py")


def _caller() -> str:
    """The innermost stack line outside the installed packages and the
    port's collective wrapper: where the collective was asked for (the HLO
    line's counterpart)."""
    for fr in reversed(traceback.extract_stack()):
        if not any(p in fr.filename for p in _PASS_ON):
            return f"{fr.filename}:{fr.lineno} {fr.line or ''}".strip()
    return "?"


class CollectiveCounter(TorchDispatchMode):
    """``with CollectiveCounter() as cc: fn()`` records every collective
    ``fn`` issues: its reference op name, wire bytes a device, result shape,
    the stack line that asked for it and its group's name (``group``: a
    mesh axis's is ``mesh.get_group(axis).group_name``)."""

    def __init__(self):
        super().__init__()
        self.records: list[dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ns, name = func.namespace, func._opname
        if ns == "c10d" and name in _C10D:
            op = _C10D[name]
            res = _tensors(args[0])
        elif ns == "_c10d_functional" and name in _FUNCTIONAL:
            op = _FUNCTIONAL[name]
            res = _tensors(out)
        else:
            return out
        group = _group(args)
        g = group.size()
        r = sum(t.numel() * t.element_size() for t in res)
        shape = ",".join(f"{_SHORT.get(t.dtype, str(t.dtype))}"
                         f"[{','.join(map(str, t.shape))}]" for t in res)
        self.records.append({"op": op, "bytes": wire_bytes(op, r, g),
                             "mult": 1, "shape": shape,
                             "line": _caller()[:160],
                             "group": group.group_name})
        return out

    def collective_bytes(self) -> dict:
        """-> {"total": int, "per_op": {op: bytes}, "counts": {op: n}}, per
        device, as the reference's ``collective_bytes``."""
        per_op: dict[str, int] = defaultdict(int)
        counts: dict[str, int] = defaultdict(int)
        for r in self.records:
            per_op[r["op"]] += r["bytes"]
            counts[r["op"]] += 1
        return {"total": int(sum(per_op.values())), "per_op": dict(per_op),
                "counts": dict(counts)}

    def top_collectives(self, k: int = 12) -> list[dict]:
        """The k largest collectives (wire bytes), with the reference's row
        keys ``op``, ``bytes``, ``mult`` (1) and ``shape``, and the stack
        line and group name under ``line`` and ``group``."""
        rows = sorted(self.records, key=lambda r: -r["bytes"])
        return [{k_: r[k_] for k_ in ("op", "bytes", "mult", "shape", "line",
                                      "group")}
                for r in rows[:k]]

    def by_group(self) -> dict:
        """-> {group name: {"bytes": int, "counts": {op: n}}}: the wire
        bytes a device and the calls over each group."""
        out: dict[str, dict] = {}
        for r in self.records:
            g = out.setdefault(r["group"], {"bytes": 0, "counts": {}})
            g["bytes"] += r["bytes"]
            g["counts"][r["op"]] = g["counts"].get(r["op"], 0) + 1
        return out
