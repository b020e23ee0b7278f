"""Checkpoint volumes on the on-disk DBS.

Port of ``repro/checkpoint/store.py``. A checkpoint series = one DBS
volume. Each ``save`` overwrites the volume's blocks (copy-on-write against
the previous version) and then freezes a snapshot — so the snapshot chain
is the retained version history, crash consistency falls out of DBS
semantics (a torn save only dirties the live head; every frozen snapshot
stays readable), and storage is incremental: unchanged blocks are shared
between versions through the chain.

Leaves are torch tensors on any device (numpy arrays are taken as they
are); ``save`` copies each to the host once. The on-disk layout is the
reference's: leaves in JAX's flattening order (dict keys sorted, lists and
tuples in order, ``None`` an empty node), the manifest's ``treedef`` string
written as ``jax.tree_util`` prints it, and bf16 leaves stored as their raw
bytes under the dtype string ``"bfloat16"``. So a checkpoint either package
writes restores in the other bit for bit, and the same tree saved by both
gives the same device file. ``restore(name, like, device=None)`` places
the leaves on ``device`` (the host by default) with the dtypes of the
manifest.

The elastic path (the reference's ``shardings=``): ``restore(name, like,
mesh=mesh, placements=tree)`` returns DTensors placed on a
``DeviceMesh`` (``placements``: a tree like ``like`` with a sequence of
placements at each leaf; ``None`` replicates). Only one process may open a
store file (``close`` rewrites the superblock), so a store built with
``mesh=`` opens the file on global rank 0 alone, and every rank of the
mesh (which spans the world) calls ``save`` and ``restore`` together:
rank 0 reads and sends the manifest's shapes and dtypes by
``broadcast_object_list``, each leaf is scattered with
``distribute_tensor(..., src_data_rank=0)``; a save gathers each DTensor
leaf with ``full_tensor()`` on every rank, rank 0 writes and sends its
result. Rank 0's failure (a full store, an I/O error) raises on every
rank of either call instead of leaving the others in their next
collective.

Two reference faults are corrected, the file format kept:

- a live head that owns any extent is a save in flight (a complete save
  freezes its head and starts an empty one), so ``_read_valid`` skips it
  and takes the newest intact snapshot; the reference validates the old
  header and manifest over the new data blocks and restores a mix. The
  GC keeps that rule true: it never merges the newest snapshot into the
  head, so ``keep_last=0`` keeps one frozen version as 1 does;
- a fallback to a snapshot reads through the snapshot's chain
  (``DBSHost.read_snapshot``) where the reference clones it into
  ``__restore_<sid>`` and keeps the clone, whose fork point stops the
  snapshot GC until the store is full.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dbs_host import DBSHost

BS = 4096          # block size
EB = 32            # blocks per extent (paper layout)

_BF16 = "bfloat16"


def _flatten(tree) -> Tuple[List[Any], str]:
    """(leaves, treedef string) in JAX's order for nested dicts, lists,
    tuples and ``None``; anything else is a leaf."""
    leaves: List[Any] = []

    def walk(x) -> str:
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k!r}: {walk(x[k])}"
                                   for k in sorted(x)) + "}"
        if isinstance(x, list):
            return "[" + ", ".join(walk(v) for v in x) + "]"
        if isinstance(x, tuple):
            inner = ", ".join(walk(v) for v in x)
            return f"({inner},)" if len(x) == 1 else f"({inner})"
        if x is None:
            return "None"
        leaves.append(x)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def _unflatten(like, leaves):
    """``like``'s structure with ``leaves`` in flattening order."""
    it = iter(leaves)

    def build(x):
        if isinstance(x, dict):
            out = {k: build(x[k]) for k in sorted(x)}
            return {k: out[k] for k in x}           # like's key order
        if isinstance(x, (list, tuple)):
            return type(x)(build(v) for v in x)
        if x is None:
            return None
        return next(it)

    return build(like)


def _flatten_up_to(like, tree) -> List[Any]:
    """``tree``'s subtrees at ``like``'s leaves, in ``_flatten``'s order
    (a placement sequence at a leaf stays whole)."""
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in _flatten_up_to(like[k],
                                                                 tree[k])]
    if isinstance(like, (list, tuple)):
        return [x for a, b in zip(like, tree) for x in _flatten_up_to(a, b)]
    if like is None:
        return []
    return [tree]


def _is_reader() -> bool:
    """True in the process that opens store files: the only one, or global
    rank 0 of an initialised process group."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _agree(fn: Optional[Callable[[], Any]]) -> Any:
    """``fn()``'s result on every rank: the reader (the only rank that
    passes ``fn``) runs it and broadcasts its result or its exception, and
    every rank returns or raises it. Without a process group, ``fn()``."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return fn()
    msg: List[Any] = [None]
    if fn is not None:
        try:
            msg = [fn()]
        except Exception as e:           # raised on every rank below
            msg = [e]
    dist.broadcast_object_list(msg, src=0)
    if isinstance(msg[0], Exception):
        raise msg[0]
    return msg[0]


def _gather(tree, keep: bool) -> Tuple[List[Tuple[np.ndarray, str]], str]:
    """(host arrays, treedef) of a tree whose leaves may be DTensors. Every
    rank of a DTensor's mesh calls it together: each DTensor leaf is
    gathered with ``full_tensor()``; without ``keep`` (a rank that holds no
    store file) no arrays are returned."""
    leaves, treedef = _flatten(tree)
    arrays = []
    for leaf in leaves:
        if hasattr(leaf, "full_tensor"):
            leaf = leaf.full_tensor()
        if keep:
            arrays.append(_host(leaf))
    return arrays, treedef


def _torch_dtype(name: str) -> torch.dtype:
    if name == _BF16:
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(name))).dtype


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(contiguous host array of the leaf's bytes, its dtype string)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), _BF16
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(np.asarray(leaf))
    return arr, str(arr.dtype)


def _manifest(arrays, treedef: str, step) -> bytes:
    entries = []
    off = 0
    for arr, dtype in arrays:
        nbytes = arr.nbytes
        entries.append({"dtype": dtype, "shape": list(arr.shape),
                        "offset": off, "nbytes": nbytes})
        off += math.ceil(nbytes / BS) * BS
    m = {"step": int(step), "treedef": treedef, "entries": entries,
         "total": off}
    return json.dumps(m).encode()


def _tensor(raw: bytes, ent, device) -> torch.Tensor:
    if ent["dtype"] == _BF16:
        arr = np.frombuffer(raw, dtype=np.int16)
        t = torch.from_numpy(arr.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(ent["dtype"]))
                             .copy())
    return t.reshape(ent["shape"]).to(device)


class CheckpointStore:
    """One DBS device file holding checkpoint volumes. With ``mesh=`` the
    file is opened on global rank 0 alone (module note)."""

    def __init__(self, path: str, *, capacity_bytes: int = 1 << 30,
                 mesh=None):
        self.path = path
        self.dev = None
        self.mesh = mesh
        if mesh is not None and not _is_reader():
            return
        n_extents = max(64, math.ceil(capacity_bytes / (BS * EB)))
        if os.path.exists(path):
            self.dev = DBSHost.open(path)
        else:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self.dev = DBSHost.create(
                path, n_extents=n_extents, extent_blocks=EB, block_size=BS,
                max_pages=n_extents)

    # ------------------------------------------------------------------ save
    def save(self, name: str, step: int, tree: Any,
             keep_last: int = 2) -> Optional[int]:
        """Commit ``tree`` as a new version; returns the frozen snapshot id
        (with ``mesh``, on every rank: module note)."""
        arrays, treedef = _gather(tree, self.dev is not None)
        if self.mesh is None:
            return self._write(name, step, arrays, treedef, keep_last)
        return _agree(None if self.dev is None else (
            lambda: self._write(name, step, arrays, treedef, keep_last)))

    def _write(self, name: str, step: int, arrays, treedef: str,
               keep_last: int) -> int:
        man = _manifest(arrays, treedef, step)
        man_blocks = math.ceil((len(man) + 16) / BS)
        header = json.dumps({"manifest_blocks": man_blocks,
                             "digest": hashlib.sha256(man).hexdigest()[:16]}
                            ).encode().ljust(BS, b"\x00")
        if name not in self.dev.volumes:
            self.dev.create_volume(name)
        # data blocks first, manifest+header last (commit record ordering)
        data_base = (1 + man_blocks) * BS
        off = 0
        for arr, _dtype in arrays:
            raw = arr.tobytes()
            pad = (-len(raw)) % BS
            self.dev.write(name, data_base + off, raw + b"\x00" * pad)
            off += len(raw) + pad
        self.dev.write(name, BS, man + b"\x00" * ((-len(man)) % BS))
        self.dev.write(name, 0, header)
        frozen = self.dev.snapshot(name)       # version committed
        self._gc(name, keep_last)
        return frozen

    def _gc(self, name: str, keep_last: int) -> None:
        """Merge-delete old snapshots beyond the retention window. The
        newest stays whatever ``keep_last`` says: merged into the head, its
        extents would make the head look like a save in flight."""
        chain = self.dev._chain(self.dev.volumes[name])
        # chain[0] = live head; keep `keep_last` frozen snapshots after it
        for sid in reversed(chain[1 + max(keep_last, 1):]):
            try:
                self.dev.delete_snapshot(sid)
            except ValueError:
                break                           # fork point: stop GC here

    # --------------------------------------------------------------- restore
    def restore(self, name: str, like: Any = None, device=None, *,
                mesh=None, placements=None) -> Tuple[int, Any]:
        """Returns (step, tree). ``like`` provides the structure
        (required); the leaves land on ``device`` (default: the host), or
        with ``mesh`` as DTensors placed by ``placements`` (module note;
        every rank of the mesh calls it)."""
        if mesh is not None:
            if device is not None:
                raise ValueError("restore takes a device or a mesh, not both")
            return restore_on_mesh(
                None if self.dev is None else (lambda: self._read_valid(name)),
                like, mesh, placements)
        blob = self._read_valid(name)
        man = blob["manifest"]
        leaves_like, _ = _flatten(like)
        if len(man["entries"]) != len(leaves_like):
            raise ValueError("checkpoint/tree structure mismatch")
        device = torch.device("cpu") if device is None else device
        out = [_tensor(raw, ent, device)
               for raw, ent in zip(_entries(blob), man["entries"])]
        return man["step"], _unflatten(like, out)

    def _read_valid(self, name: str) -> Dict:
        """The newest committed version of ``name``: the live head when it
        owns no extent (a complete save left it empty), then each frozen
        snapshot, newest first, read through its chain; the first whose
        header's digest matches its manifest. Returns ``{"read": fn(offset,
        length), "manifest", "manifest_blocks", "snapshot": sid or None}``.
        Writes nothing. Raises ``IOError`` when no version is intact."""
        head = self.dev.volumes[name]
        chain = self.dev._chain(head)
        candidates: List[Optional[int]] = []
        if not (self.dev.extent_owner == head).any():
            candidates.append(None)             # head: no save in flight
        candidates.extend(chain[1:])
        for sid in candidates:
            if sid is None:
                def read(off, n):
                    return self.dev.read(name, off, n)
            else:
                table = self.dev.snapshot_table(sid)

                def read(off, n, sid=sid, table=table):
                    return self.dev.read_snapshot(sid, off, n, table)
            try:
                hdr = json.loads(read(0, BS).split(b"\x00")[0])
                man_raw = read(BS, hdr["manifest_blocks"] * BS)
                man_raw = man_raw[:man_raw.rfind(b"}") + 1]
                if hashlib.sha256(man_raw).hexdigest()[:16] != hdr["digest"]:
                    raise IOError("digest mismatch")
                return {"read": read, "manifest": json.loads(man_raw),
                        "manifest_blocks": hdr["manifest_blocks"],
                        "snapshot": sid}
            except Exception:
                continue
        raise IOError(f"no valid checkpoint for {name!r}")

    def steps(self, name: str) -> List[int]:
        try:
            return [self._read_valid(name)["manifest"]["step"]]
        except Exception:
            return []

    def close(self):
        if self.dev is not None:
            self.dev.close()


def _entries(blob):
    """Each manifest entry's raw bytes, in order."""
    data_base = (1 + blob["manifest_blocks"]) * BS
    for ent in blob["manifest"]["entries"]:
        raw = blob["read"](data_base + ent["offset"],
                           math.ceil(ent["nbytes"] / BS) * BS)
        yield raw[:ent["nbytes"]]


def restore_on_mesh(read_valid: Optional[Callable[[], Dict]], like: Any,
                    mesh, placements=None) -> Tuple[int, Any]:
    """(step, tree of DTensors on ``mesh``). Every rank calls it together;
    the reader passes ``read_valid`` (a ``_read_valid`` of the chosen
    store), the others ``None``. The reader's failure (no valid version, a
    tree that does not fit) raises on every rank."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor
    if dist.is_initialized() and mesh.size() != dist.get_world_size():
        raise ValueError("a mesh restore needs a mesh over the whole world")
    leaves_like, _ = _flatten(like)
    blob = None

    def read():
        nonlocal blob
        blob = read_valid()
        man = blob["manifest"]
        if len(man["entries"]) != len(leaves_like):
            raise ValueError("checkpoint/tree structure mismatch")
        return {"step": man["step"], "entries": man["entries"]}

    head = _agree(None if read_valid is None else read)
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    places = (_flatten_up_to(like, placements) if placements is not None
              else [None] * len(leaves_like))
    raws = _entries(blob) if blob is not None else None
    out = []
    for ent, place in zip(head["entries"], places):
        if raws is not None:
            t = _tensor(next(raws), ent, dev)
        else:
            t = torch.empty(ent["shape"], dtype=_torch_dtype(ent["dtype"]),
                            device=dev)
        place = place or [Replicate()] * mesh.ndim
        out.append(distribute_tensor(t, mesh, list(place), src_data_rank=0))
    return head["step"], _unflatten(like, out)
