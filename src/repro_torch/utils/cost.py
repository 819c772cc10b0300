"""What one call costs, read from its trace (the port's counterpart of the
reference's ``compiled.cost_analysis()`` and ``memory_analysis()``).

:func:`measure` runs ``fn`` once under four dispatch modes:

* ``torch.utils.flop_counter.FlopCounterMode``: FLOPs of the matrix
  products, convolutions and attention kernels (its registry; the SDPA
  kernels' formulas with grouped K and V widened to the query's heads);
* :class:`OpBytes`: bytes, each aten op's input plus output bytes, views
  excluded. That is what eager PyTorch reads and writes, op by op, with no
  fusion: unlike XLA's "bytes accessed" of a fused program, an elementwise
  chain counts each intermediate twice;
* :class:`~repro_torch.utils.comms.CollectiveCounter`: collectives, in the
  reference's layout;
* ``torch.distributed._tools.mem_tracker.MemTracker``: the peak of the
  tensors alive, a TRACED figure (what the tensors' storages add up to at
  their highest), not a measured allocator peak.

Under ``FakeTensorMode`` (the dry run) no byte of a full-size tensor is
allocated and the figures are per rank: a DTensor counts its local shard.
The hand-written kernels launch through pointers (``kernels/ops._launch``),
which no dispatch mode sees; their work is ``ops.WORK``, which the caller
adds.
"""
from __future__ import annotations

import contextlib
import time

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils import flop_counter

from repro_torch.utils import comms

# SDPA's kernels by aten op, and _fused_sdp_choice's backend numbers
_SDPA_OPS = {"_scaled_dot_product_flash_attention": "flash",
             "_scaled_dot_product_efficient_attention": "efficient",
             "_scaled_dot_product_cudnn_attention": "cudnn",
             "_scaled_dot_product_flash_attention_for_cpu": "flash_cpu"}
_SDP_CHOICE = {0: "math", 1: "flash", 2: "efficient", 3: "cudnn"}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s elements; a DTensor's local shard."""
    if isinstance(t, DTensor):
        t = t._local_tensor
    return t.numel() * t.element_size()


def _tensor_leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensor_leaves(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensor_leaves(y)


def _heads(q, kv):
    """A grouped K or V shape (B, H_kv, S, D) with the query's H heads: the
    products SDPA computes with ``enable_gqa``."""
    return (kv[0], q[1], *kv[2:])


def _sdpa_fwd(q, k, v, *args, out_shape=None, **kwargs):
    return flop_counter.sdpa_flop_count(q, _heads(q, k), _heads(q, v))


def _sdpa_bwd(grad_out, q, k, v, *args, out_shape=None, **kwargs):
    return flop_counter.sdpa_backward_flop_count(grad_out, q, _heads(q, k),
                                                 _heads(q, v))


# torch's SDPA formulas assert that K and V have the query's heads, which
# grouped-query attention (layers.sdpa_library) breaks; these count from
# the shapes with K and V widened to the query's heads
_SDPA_FLOPS = {
    getattr(torch.ops.aten, f"_scaled_dot_product_{b}_attention{d}"): f
    for b in ("flash", "efficient", "cudnn")
    for d, f in (("", _sdpa_fwd), ("_backward", _sdpa_bwd))
    if hasattr(torch.ops.aten, f"_scaled_dot_product_{b}_attention{d}")}


class OpBytes(TorchDispatchMode):
    """Sums the input and output bytes of every aten op that is not a view,
    and tallies attention routes: each SDPA kernel op by backend, and
    ``math`` where ``_fused_sdp_choice`` picked the composite path."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.routes: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten":
            return out
        name = func._opname
        if name == "_fused_sdp_choice":
            route = _SDP_CHOICE.get(int(out), f"backend {int(out)}")
            if route == "math":
                self.routes["math"] = self.routes.get("math", 0) + 1
        elif name in _SDPA_OPS:
            route = _SDPA_OPS[name]
            self.routes[route] = self.routes.get(route, 0) + 1
        if not func.is_view:
            self.bytes += sum(tensor_bytes(t) for t in _tensor_leaves(
                (args, kwargs, out)))
        return out


def argument_bytes(*trees) -> int:
    """Bytes a rank holds of the inputs: every tensor leaf of ``trees``
    (tensors, lists, dicts, modules' parameters and buffers), DTensors by
    their local shards."""
    total = 0
    for tree in trees:
        if isinstance(tree, torch.nn.Module):
            tree = list(tree.parameters()) + list(tree.buffers())
        total += sum(tensor_bytes(t) for t in _tensor_leaves(tree))
    return total


def measure(fn, *inputs, fake_mode=None) -> tuple[object, dict]:
    """Run ``fn()`` once under the counting modes (inside ``fake_mode``
    when given). ``inputs`` are what the call reads (modules, tensors,
    dicts of them): the tracker counts them as alive from the start.
    Returns ``(fn's result, record)``; the record holds ``flops``,
    ``bytes``, ``collectives`` (``collective_bytes()``), ``top_collectives``,
    ``collectives_by_group`` (``by_group()``), ``peak_bytes`` (traced), ``argument_bytes``, ``sdpa_routes`` and the
    call's host seconds ``trace_s``."""
    from torch.distributed._tools.mem_tracker import MemTracker
    mt = MemTracker()
    ext = [t for x in inputs
           for t in ([x] if isinstance(x, torch.nn.Module)
                     else _tensor_leaves(x))]
    mt.track_external(*ext)
    fc = flop_counter.FlopCounterMode(display=False,
                                      custom_mapping=_SDPA_FLOPS)
    ob = OpBytes()
    cc = comms.CollectiveCounter()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for m in ([fake_mode] if fake_mode is not None else []) + [
                mt, fc, ob, cc]:
            stack.enter_context(m)
        out = fn()
    secs = time.perf_counter() - t0
    peak = mt.get_tracker_snapshot("peak")
    return out, {
        "flops": float(fc.get_total_flops()),
        "bytes": float(ob.bytes),
        "collectives": cc.collective_bytes(),
        "top_collectives": cc.top_collectives(),
        "collectives_by_group": cc.by_group(),
        "peak_bytes": int(max((v["Total"] for v in peak.values()),
                              default=0)),
        "argument_bytes": argument_bytes(*inputs),
        "sdpa_routes": dict(ob.routes),
        "trace_s": secs,
    }
