"""Per-device op accounting from dispatched ops.

Port of ``repro/utils/hlo.py``. The reference reads a cell's costs from
XLA's compiled, post-SPMD module: collective traffic by parsing its HLO
text (``collective_stats``), FLOPs and bytes from a loop-aware walk of that
text (``module_costs``), op counts by regex (``count_ops``). A torch program
has no such module. Here one ``TorchDispatchMode``, ``OpCounter`` (the
counting mode), watches the ops as they dispatch and keeps the same three
results:

- ``collective_stats()``: ``{kind: {"count", "bytes"}}`` under HLO's kind
  names (``COLLECTIVES``), for every functional collective
  (``_c10d_functional.*``: what DTensor's redistributions issue) and every
  in-place ``c10d.*_`` op (what ``distributed/collectives.py`` issues
  through ``torch.distributed``). Bytes are the result's, as ``hlo.py``
  ``result_bytes`` counts them: the operand for an all-reduce, the gathered
  size for an all-gather, the scattered result for a reduce-scatter.
- ``module_costs()``: ``{"flops", "bytes", "collective_bytes",
  "collective_count"}``. FLOPs come from ``torch.utils.flop_counter``'s
  formulas; the kernel entries (``repro_torch::*`` custom ops) register
  theirs, the work their bound counts. Bytes are the inputs and outputs of
  each op that does work. Views, metadata ops, allocations and ``arange``
  (HLO's ``iota``) are free, as ``hlo.py``'s ``_FREE_OPS`` leaves them out;
  a gather counts the rows it reads, not its whole table, and an indexed
  write the rows it writes, not its whole destination; a kernel entry
  counts the bytes of its bound (``register_bytes_formula``). This is an
  UNFUSED count: what eager PyTorch reads and writes, op by op. It is not
  XLA's "bytes accessed" of a fused module, which leaves out what a fusion
  keeps on chip, and the two are not comparable.
- ``count_ops()``: ``{"dot": matmuls, <entry>: calls}``, one key a kernel
  entry that ran.

Per device means on this rank's local shards. An op on DTensors is left to
DTensor (the mode returns ``NotImplemented``) and counted when DTensor runs
it on the local tensors; the run of an op at global shapes that DTensor's
sharding propagation makes to learn its output's metadata is not counted.

The reference's ``split_computations``, ``_trip_count`` and HLO regexes
have nothing to parse here: eager ops are counted as they run, every loop
trip included. They are not ported.
"""
from __future__ import annotations

import sys
from collections import defaultdict
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "collective-broadcast")

# op name (in ``_c10d_functional`` or ``c10d``) -> HLO kind
_KINDS = {
    **dict.fromkeys(("all_reduce", "all_reduce_", "all_reduce_coalesced",
                     "all_reduce_coalesced_", "allreduce_",
                     "allreduce_coalesced_"), "all-reduce"),
    **dict.fromkeys(("all_gather_into_tensor", "all_gather_into_tensor_out",
                     "all_gather_into_tensor_coalesced", "allgather_",
                     "_allgather_base_", "allgather_coalesced_",
                     "allgather_into_tensor_coalesced_"), "all-gather"),
    **dict.fromkeys(("reduce_scatter_tensor", "reduce_scatter_tensor_coalesced",
                     "reduce_scatter_", "_reduce_scatter_base_",
                     "reduce_scatter_tensor_coalesced_"), "reduce-scatter"),
    **dict.fromkeys(("all_to_all_single", "alltoall_", "alltoall_base_"),
                    "all-to-all"),
    **dict.fromkeys(("send", "recv_", "recv_any_source_"),
                    "collective-permute"),
    **dict.fromkeys(("broadcast", "broadcast_"), "collective-broadcast"),
}
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "arange", "detach", "alias", "lift_fresh",
         "_unsafe_view", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "is_same_size", "wait_tensor", "set_",
         "resize_", "_local_scalar_dense", "scalar_tensor", "barrier",
         "monitored_barrier_"}
_MATMULS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "_scaled_mm"}
# gathers: the rows read (the output's size) and the indices, written once
_GATHERS = {"embedding", "index", "index_select", "gather"}
# in-place writes of part of ``self``: the values read and written
_INDEXED_WRITES = {"index_put_", "_index_put_impl_", "index_copy_",
                   "scatter_", "scatter_add_", "scatter_reduce_",
                   "index_add_", "masked_scatter_"}

BYTES_FORMULAS: Dict[object, Callable] = {}


def register_bytes_formula(packet):
    """Register ``fn(*args, out_val=out, **kwargs) -> bytes`` for an op
    packet (``torch.ops.ns.name``), in place of the inputs-and-outputs
    count."""
    def register(fn):
        BYTES_FORMULAS[packet] = fn
        return fn
    return register


def tensor_bytes(x) -> int:
    """Bytes of every tensor in ``x`` (a tensor or nested lists of them)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _propagation_codes():
    """The code of DTensor's global-shape metadata runs (their name moved
    between torch releases)."""
    try:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
    except ImportError:          # pragma: no cover - no torch.distributed
        return frozenset()
    names = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
    fns = [getattr(ShardingPropagator, n, None) for n in names]
    return frozenset(getattr(f, "__wrapped__", f).__code__ for f in fns
                     if f is not None and hasattr(getattr(f, "__wrapped__",
                                                          f), "__code__"))


class OpCounter(TorchDispatchMode):
    """The counting mode: ``with OpCounter() as c: step(*args)``, then
    ``c.collective_stats()``, ``c.module_costs()``, ``c.count_ops()``."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self._dtensor = DTensor
        self._flops_of = flop_registry
        self._skip = _propagation_codes()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"count": 0.0, "bytes": 0.0})
        self.ops: Dict[str, int] = defaultdict(int)

    def _in_propagation(self) -> bool:
        f = sys._getframe(2)
        while f is not None:
            if f.f_code in self._skip:
                return True
            f = f.f_back
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if not (ns == "prim" or name in _FREE or func.is_view
                or self._in_propagation()):
            self._count(func, ns, name, args, kwargs, out)
        return out

    def _count(self, func, ns, name, args, kwargs, out) -> None:
        packet = func._overloadpacket
        if ns in ("c10d", "_c10d_functional") and name in _KINDS:
            res = out if ns == "_c10d_functional" else args[0]
            n = tensor_bytes(res)
            rec = self.collectives[_KINDS[name]]
            rec["count"] += 1
            rec["bytes"] += n
            self.bytes += n + tensor_bytes(args)
            return
        if ns == "repro_torch":
            self.ops[name] += 1
        elif name in _MATMULS:
            self.ops["dot"] += 1
        if packet in self._flops_of:
            self.flops += float(self._flops_of[packet](*args, **kwargs,
                                                       out_val=out))
        self.bytes += self._bytes(packet, name, args, kwargs, out)

    @staticmethod
    def _bytes(packet, name, args, kwargs, out) -> float:
        if packet in BYTES_FORMULAS:
            return float(BYTES_FORMULAS[packet](*args, **kwargs,
                                                out_val=out))
        if name in _GATHERS:
            idx = [a for a in tree_leaves((args[1:], kwargs))
                   if isinstance(a, torch.Tensor)]
            return float(tensor_bytes(idx) + 2 * tensor_bytes(out))
        if name in _INDEXED_WRITES:
            rest = [a for a in tree_leaves((args[1:], kwargs))
                    if isinstance(a, torch.Tensor)]
            return float(tensor_bytes(rest) + tensor_bytes(rest[-1:]))
        if name in ("fill_", "zero_"):
            return float(tensor_bytes(args[0]))
        if name == "copy_":
            return float(2 * tensor_bytes(args[1]))
        return float(tensor_bytes((args, kwargs)) + tensor_bytes(out))

    # -- the reference's three results ---------------------------------------
    def collective_stats(self) -> Dict[str, Dict[str, float]]:
        return {k: dict(v) for k, v in self.collectives.items()}

    def module_costs(self) -> Dict[str, float]:
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": sum(v["bytes"]
                                        for v in self.collectives.values()),
                "collective_count": sum(v["count"]
                                        for v in self.collectives.values())}

    def count_ops(self) -> Dict[str, int]:
        return dict(self.ops)
