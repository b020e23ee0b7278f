"""Sharding planner: DP/TP/FSDP/EP/SP assignment with divisibility fallbacks.

Port of ``repro/distributed/planner.py``. The planner maps every parameter
/ activation / cache leaf to a spec over the production mesh axes ("pod",
"data", "model"). A dim is sharded on an axis group only when evenly
divisible; otherwise the next candidate spec is tried, ending at full
replication — this is what lets one rule set cover all ten assigned
architectures (gemma2's 8 heads, granite's 49155 vocab, granite-moe's 40
experts, rwkv's 40 heads, ... all fall back gracefully).

The rules are the reference's, line for line; only the types differ:

- a mesh is anything that gives axis sizes: a ``DeviceMesh``
  (``mesh_dim_names``, ``mesh.shape``), a ``{name: size}`` dict, or an
  object whose ``shape`` is such a dict. With a dict the planner needs no
  process group;
- a spec is a tuple with one entry a tensor dim: ``None``, an axis name, or
  a tuple of axis names (what ``PartitionSpec`` holds, and normalised as it
  normalises: a 1-tuple becomes its name, an empty tuple ``None``);
- ``to_placements(mesh, spec)`` turns a spec into DTensor placements, one a
  mesh dim (``Shard(d)`` or ``Replicate()``), and ``distribute`` places a
  tree as DTensors. An entry that shards one dim over several axes keeps
  JAX's major-to-minor order only when its axes are in mesh order, so
  ``to_placements`` refuses one that is not.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Sequence, Tuple

from repro_torch.configs.base import ArchConfig, ExecutionPlan

Spec = Tuple


def P(*entries) -> Spec:
    """A spec, normalised as ``PartitionSpec`` normalises its entries."""
    out = []
    for e in entries:
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = None if not e else (e[0] if len(e) == 1 else e)
        out.append(e)
    return tuple(out)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh or of a ``{name: size}``
    mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _axis_size(sizes: Dict[str, int], entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        n = 1
        for a in entry:
            n *= sizes[a]
        return n
    return sizes[entry]


def fits(mesh, shape: Sequence[int], spec: Spec) -> bool:
    sizes = axis_sizes(mesh)
    for dim, entry in zip(shape, tuple(spec)):
        n = _axis_size(sizes, entry)
        if n > 1 and (dim % n):
            return False
    return True


def pick(mesh, shape: Sequence[int], candidates: List[Spec]) -> Spec:
    """First candidate whose sharded dims divide evenly; else replicate."""
    for c in candidates:
        c_full = P(*(tuple(c) + (None,) * (len(shape) - len(tuple(c)))))
        if fits(mesh, shape, c_full):
            return c_full
    return P(*([None] * len(shape)))


def batch_axes(mesh) -> Tuple[str, ...]:
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def _key_path(path) -> str:
    return "/".join(str(k) for k in path)


def _walk(tree, fn, path=()):
    """``fn(path, leaf)`` over nested dicts, lists and tuples (``None`` an
    empty node), keeping the structure."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _is_spec(x) -> bool:
    """A spec: a tuple of ``None``, names and tuples of names (the trees
    the planner walks nest dicts and lists)."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) or (
            isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def _map_specs(fn, specs, *rest):
    """``fn(spec, *leaves)`` at each spec of ``specs`` (tuples of axis
    entries are leaves here), with ``rest`` trees walked alongside."""
    if _is_spec(specs):
        return fn(specs, *rest)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, *(r[k] for r in rest))
                for k, v in specs.items()}
    return type(specs)(_map_specs(fn, v, *(r[i] for r in rest))
                       for i, v in enumerate(specs))


class Planner:
    def __init__(self, mesh, cfg: ArchConfig, plan: ExecutionPlan):
        self.mesh = mesh
        self.sizes = axis_sizes(mesh)
        self.cfg = cfg
        self.plan = plan
        self.batch = batch_axes(mesh)           # ("pod","data") | ("data",)
        self.fsdp = "data" if (plan.fsdp and "data" in self.sizes) else None

    # -- generic leaf rules ---------------------------------------------------
    def param_spec(self, path: str, shape: Sequence[int]) -> Spec:
        """Spec for a parameter leaf. ``path`` is the flattened key path;
        stacked segment leaves have a leading layer dim (never sharded)."""
        m, f = "model", self.fsdp
        sizes = self.sizes
        lead: Tuple = ()
        if re.search(r"segments|mtp/block", path):
            if re.search(r"segments", path):
                lead, shape = (None,), shape[1:]      # (count, ...) stack

        def cands(cands_tail: List[Tuple]) -> Spec:
            full = [P(*(lead + t)) for t in cands_tail]
            return pick(sizes, (1,) * len(lead) + tuple(shape), full)

        # ---- embeddings / head ---------------------------------------------
        if "embed/tokens" in path or "embed/lm_head" in path:
            if len(shape) == 3:   # codebooks (K, V, D) / (K, D, V)
                return cands([(None, m, f), (None, f, m), (None, None, m)])
            return cands([(m, f), (f, m), (None, m)])
        # ---- norms / scalars / small vectors --------------------------------
        # (shape has already been stripped of the stacked-layer lead dim)
        if len(shape) <= 1 or re.search(
                r"ln|norm|bias|mu|u$|d_skip|dt_bias|a_log|first", path):
            return cands([tuple([None] * len(shape))])
        # ---- MoE experts -----------------------------------------------------
        if re.search(r"mlp/(wi|wg|wo)", path) and len(shape) == 3 and \
                self.cfg.moe is not None:
            # (E, D, F) / (E, F, D): expert-parallel if E divides, else TP on F
            if "wo" in path:
                return cands([(m, f, None), (None, m, f), (None, m, None)])
            return cands([(m, f, None), (None, f, m), (None, None, m)])
        if "router" in path:
            return cands([(f, None)])
        # ---- attention projections ------------------------------------------
        if re.search(r"/(q|k|v|q_b|kv_b|w_r|w_k|w_v|w_g|c_r|c_k|in_proj|w_bc|w_dt1)$", path):
            return cands([(f, m), (None, m)])             # column parallel
        if re.search(r"/(o|out_proj|w_o|c_v|w_dt2)$", path):
            return cands([(m, f), (m, None)])             # row parallel
        if re.search(r"/(q_a|kv_a)$", path):
            return cands([(f, m), (None, m)])
        if re.search(r"/(wi|wg)$", path):
            return cands([(f, m), (None, m)])
        if re.search(r"/wo$", path):
            return cands([(m, f), (m, None)])
        if re.search(r"conv|lora|proj$", path):
            return cands([tuple([None] * (len(shape) - len(lead)))])
        # default: replicate
        return cands([tuple([None] * (len(shape) - len(lead)))])

    # -- trees ----------------------------------------------------------------
    def tree_specs(self, tree) -> Any:
        """A spec at each leaf (anything with a ``shape``), keyed by the
        ``/``-joined path ``jax.tree_util.tree_map_with_path`` gives."""
        return _walk(tree, lambda path, x: self.param_spec(_key_path(path),
                                                           tuple(x.shape)))

    def shardings(self, tree) -> Any:
        """DTensor placements of each leaf on this planner's mesh."""
        return self.placements(self.tree_specs(tree))

    def placements(self, specs) -> Any:
        """A spec tree (``tree_specs``, ``opt_specs``, ``cache_specs``) as
        DTensor placements on this planner's mesh."""
        return _map_specs(lambda s: to_placements(self.mesh, s), specs)

    def opt_specs(self, param_specs, param_shapes, optimizer: str):
        """The optimizer state's specs: AdamW's ``{"m", "v", "count"}``,
        or Adafactor's slots (``vr`` drops the last dim, ``vc`` the
        second-to-last) and ``count``."""
        if optimizer == "adamw":
            return {"m": param_specs, "v": param_specs, "count": P()}

        def slot(spec, shp):
            spec_t = tuple(spec)
            if len(shp.shape) >= 2 and shp.shape[-1] > 1 and shp.shape[-2] > 1:
                return {"vr": P(*spec_t[:-1]),
                        "vc": P(*(spec_t[:-2] + spec_t[-1:]))}
            return {"v": P(*spec_t)}
        slots = _map_specs(slot, param_specs, param_shapes)
        return {"slots": slots, "count": P()}

    # -- activations / batch ---------------------------------------------------
    def data_spec(self, shape: Sequence[int]) -> Spec:
        """Batch tensors: shard dim0 over ("pod","data") when divisible."""
        return pick(self.sizes, shape,
                    [P(self.batch), P(self.batch[-1:]), P()])

    def cache_spec(self, key: str, shape: Sequence[int]) -> Spec:
        b = self.batch
        sizes = self.sizes
        if "pool" in key:
            # DBS pool: extents striped over (batch-axes x model) — the
            # distributed extent map (SP for the KV state).
            return pick(sizes, shape, [P(b + ("model",)), P("model"), P()])
        if "block_table" in key:
            return pick(sizes, shape, [P(b), P()])
        if key in ("k", "v"):      # dense cache: (B, S, KV, hd) — split-KV SP
            return pick(sizes, shape,
                        [P(b, "model"), P(b), P()])
        if "ring" in key:
            return pick(sizes, shape, [P(b), P()])
        if "wkv" in key or "mamba" in key or "shift" in key or "ssm" in key:
            return pick(sizes, shape, [P(b), P()])
        return pick(sizes, shape, [P(b), P()])

    def cache_specs(self, cache_tree) -> Any:
        """A spec at each cache leaf; every leaf under a ``mamba`` key
        takes the ``mamba`` rule."""
        def leaf(path, x):
            keys = [str(k) for k in path]
            key = keys[-1] if keys else ""
            if "mamba" in keys:
                key = "mamba"
            return self.cache_spec(key, tuple(x.shape))
        return _walk(cache_tree, leaf)


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------
def to_placements(mesh, spec: Spec) -> List:
    """DTensor placements of ``spec`` on ``mesh``, one a mesh dim in mesh
    order: ``Shard(d)`` for the mesh dims that tensor dim ``d`` names,
    ``Replicate()`` for the rest. Raises on an axis the mesh lacks, on an
    axis named twice, and on a multi-axis entry whose axes are not in mesh
    order (DTensor nests the shards of one dim in mesh order)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out: List = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = []
        for a in axes:
            if a not in names:
                raise KeyError(f"spec {spec} names axis {a!r}; the mesh has "
                               f"{names}")
            if not isinstance(out[names.index(a)], Replicate):
                raise ValueError(f"spec {spec} names axis {a!r} twice")
            idx.append(names.index(a))
            out[names.index(a)] = Shard(d)
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order "
                             f"{names}: DTensor cannot nest its shards so")
    return out


def distribute(tree, mesh, placements, src_data_rank=0) -> Any:
    """``tree``'s tensors as DTensors on ``mesh`` (``placements``: a tree
    like ``tree`` with a placement list at each leaf, as ``shardings``
    gives). ``src_data_rank=None`` takes each rank's own copy, which must
    then be equal on every rank; 0 scatters rank 0's."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.model import leaves_up_to, tree_map
    places = iter(leaves_up_to(tree, placements))
    return tree_map(lambda t: distribute_tensor(
        t, mesh, list(next(places)), src_data_rank=src_data_rank), tree)


# ---------------------------------------------------------------------------
# page ownership helpers (distributed DBS stripes)
# ---------------------------------------------------------------------------
def pool_stride(mesh, batch_shardable: bool) -> int:
    """Number of shards the extent dim of pools is striped over."""
    sizes = axis_sizes(mesh)
    n = sizes["model"]
    if not batch_shardable:
        for a in ("pod", "data"):
            if a in sizes:
                n *= sizes[a]
    return n
