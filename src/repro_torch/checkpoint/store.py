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
manifest; the reference's ``shardings`` (re-placing onto a mesh) waits for
the port's distributed slice.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
from typing import Any, Dict, List, Tuple

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
    """One DBS device file holding checkpoint volumes."""

    def __init__(self, path: str, *, capacity_bytes: int = 1 << 30):
        n_extents = max(64, math.ceil(capacity_bytes / (BS * EB)))
        if os.path.exists(path):
            self.dev = DBSHost.open(path)
        else:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self.dev = DBSHost.create(
                path, n_extents=n_extents, extent_blocks=EB, block_size=BS,
                max_pages=n_extents)
        self.path = path

    # ------------------------------------------------------------------ save
    def save(self, name: str, step: int, tree: Any,
             keep_last: int = 2) -> int:
        leaves, treedef = _flatten(tree)
        arrays = [_host(leaf) for leaf in leaves]
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
        """Merge-delete old snapshots beyond the retention window."""
        chain = self.dev._chain(self.dev.volumes[name])
        # chain[0] = live head; keep `keep_last` frozen snapshots after it
        for sid in reversed(chain[1 + keep_last:]):
            try:
                self.dev.delete_snapshot(sid)
            except ValueError:
                break                           # fork point: stop GC here

    # --------------------------------------------------------------- restore
    def restore(self, name: str, like: Any = None,
                device=None) -> Tuple[int, Any]:
        """Returns (step, tree). ``like`` provides the structure
        (required); the leaves land on ``device`` (default: the host)."""
        blob = self._read_valid(name)
        man = blob["manifest"]
        leaves_like, _ = _flatten(like)
        if len(man["entries"]) != len(leaves_like):
            raise ValueError("checkpoint/tree structure mismatch")
        data_base = (1 + blob["manifest_blocks"]) * BS
        device = torch.device("cpu") if device is None else device
        out = []
        for ent in man["entries"]:
            raw = self.dev.read(blob["volume"], data_base + ent["offset"],
                                math.ceil(ent["nbytes"] / BS) * BS)
            out.append(_tensor(raw[:ent["nbytes"]], ent, device))
        return man["step"], _unflatten(like, out)

    def _read_valid(self, name: str) -> Dict:
        """Validate the live head; fall back to the newest intact snapshot.
        Raises ``IOError`` when no version is intact."""
        candidates = [name]
        chain = self.dev._chain(self.dev.volumes[name])
        for sid in chain[1:]:
            candidates.append(("@snap", sid))
        for cand in candidates:
            vol = name
            tmp = None
            try:
                if isinstance(cand, tuple):
                    tmp = f"__restore_{cand[1]}"
                    if tmp in self.dev.volumes:
                        self.dev.delete_volume(tmp)
                    self.dev.clone(name, tmp, snapshot_id=cand[1])
                    vol = tmp
                hdr = json.loads(self.dev.read(vol, 0, BS).split(b"\x00")[0])
                man_raw = self.dev.read(vol, BS, hdr["manifest_blocks"] * BS)
                man_raw = man_raw[:man_raw.rfind(b"}") + 1]
                if hashlib.sha256(man_raw).hexdigest()[:16] != hdr["digest"]:
                    raise IOError("digest mismatch")
                return {"volume": vol, "manifest": json.loads(man_raw),
                        "manifest_blocks": hdr["manifest_blocks"]}
            except Exception:
                if tmp and tmp in self.dev.volumes:
                    self.dev.delete_volume(tmp)
                continue
        raise IOError(f"no valid checkpoint for {name!r}")

    def steps(self, name: str) -> List[int]:
        try:
            return [self._read_valid(name)["manifest"]["step"]]
        except Exception:
            return []

    def close(self):
        self.dev.close()
