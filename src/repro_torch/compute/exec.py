"""Per-call storage-function executors for the backends other than the ring.

Port of ``repro/compute/exec.py``. The ring runs storage functions in-band
(``phase.apply_compute_ops`` inside its step). The other backends get the
same results through two per-call paths:

- **host oracle** (``backend="host"``): ``host_compute`` runs the entry's
  sequential ``host_ref`` against the backend's one state and pool, from
  its FIFO queue (core/backends.py), so ordering matches the ring's.
- **device backends** (fused / sharded / slots / loop): ``device_compute``
  runs on a flushed engine: the entry's device ``apply`` over the first
  healthy replica's volume view, then, for a writing function
  (compare_and_write), the mirrored CoW commit through ``write_pages`` and
  the configured kernel on every healthy replica. Its results come to the
  host in one fetch.

Both return host values; the blockdev layer wraps them in ComputeResult.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Tuple

import numpy as np
import torch

from repro_torch.compute.phase import VolumeView, as_device
from repro_torch.compute.registry import make_storage_fn
from repro_torch.core import dbs
from repro_torch.core.fused import write_meta
from repro_torch.kernels.dbs.registry import make_kernel


def _payload(payload, payload_shape, device) -> torch.Tensor:
    if payload is None:
        return torch.zeros(tuple(payload_shape), dtype=torch.float32,
                           device=device)
    return torch.as_tensor(np.asarray(payload, np.float32).reshape(
        tuple(payload_shape))).to(device)


def host_compute(state, pool, req, payload_shape):
    """Run ``req`` (a compute Request) sequentially against the host
    backend's single state and pool. Returns ``(value, status, out, state',
    pool')``."""
    entry = make_storage_fn(req.fn)
    pay = _payload(req.payload, payload_shape, pool.device)
    view = VolumeView([state.table], [pool], req.volume, make_kernel("torch"))
    val, stt, out, do_w = entry.host_ref(view, req.page, req.block, req.arg,
                                         pay)
    if bool(do_w):
        dev = pool.device
        state, wops = dbs.write_pages(
            state, req.volume,
            torch.tensor([req.page], dtype=torch.int64, device=dev),
            torch.tensor([1 << req.block], dtype=torch.int64, device=dev),
            torch.ones((1,), dtype=torch.bool, device=dev))
        pool = dbs.apply_write_ops(
            pool, wops, pay[None],
            torch.tensor([req.block], dtype=torch.int32, device=dev))
    return int(val), int(stt), out.cpu().numpy(), state, pool


def _commit(states, pools, page_revs, vol, page, block, payload, do_w,
            kern):
    """The mirrored CoW write of one block under the device mask ``do_w``
    on every given replica (the pools in place): the fused step's write
    metadata (``fused.write_meta``) on a one-lane batch, then the
    kernel. Returns the new states and watermarks."""
    dev = payload.device
    lane = lambda v: torch.full((1,), v, dtype=torch.int32, device=dev)
    one = SimpleNamespace(volume=lane(vol), page=lane(page),
                          block=lane(min(max(block, 0), 31)))
    mask = as_device(do_w, torch.zeros((), dtype=torch.bool,
                                       device=dev)).reshape(1)
    states, page_revs, ops = write_meta(states, page_revs, one, mask)
    for pool, wops in zip(pools, ops):
        kern.write(pool, wops, payload[None], one.block)
    return states, page_revs


def _put(full: torch.Tensor, s: int, part: torch.Tensor) -> torch.Tensor:
    out = full.clone()
    out[s] = part
    return out


def device_compute(engine, vid: int, fn_name: str, page: int, block: int,
                   arg: int, payload) -> Tuple[int, int, np.ndarray]:
    """Execute one storage-function call against a flushed device backend
    (fused / sharded / slots / loop). ``vid`` is the global volume id."""
    from repro_torch.core.backends import fetch_to_host
    from repro_torch.core.replication import ShardedReplicaGroup
    import torch.utils._pytree as pytree
    cfg = engine.cfg
    if cfg.null_backend or cfg.null_storage:
        raise ValueError("storage functions need a real DBS data plane "
                         "(null_backend/null_storage hold no bytes)")
    storage = getattr(engine, "backend", None)
    if storage is None or not hasattr(storage, "device_state"):
        raise ValueError(
            f"backend comm={cfg.comm!r} storage={cfg.storage!r} cannot "
            "execute storage functions (no DBS replica plane)")
    entry = make_storage_fn(fn_name)
    kern = make_kernel(getattr(engine, "_kernel", None) or "torch")
    dev = torch.device(cfg.device)
    pay = _payload(payload, cfg.payload_shape, dev)

    if isinstance(storage, ShardedReplicaGroup):
        n_sh = storage.n_shards
        shard, local = vid % n_sh, vid // n_sh
        states, pools, _h = storage.device_state()
        prs = storage.device_page_revs()
        hidx = [r for r in range(storage.n_replicas)
                if storage.healthy[shard, r]]
        if not hidx:
            raise RuntimeError(f"shard {shard} has no healthy replica")
        take = lambda t: pytree.tree_map(lambda x: x[shard], t)
        view = VolumeView([states[hidx[0]].table[shard]],
                          [pools[hidx[0]][shard]], local, kern)
        val, stt, out, do_w = entry.apply(view, page, block, arg, pay)
        if entry.writes:
            st2, pr2 = _commit([take(states[r]) for r in hidx],
                               [pools[r][shard] for r in hidx],
                               [prs[r][shard] for r in hidx], local, page,
                               block, pay, do_w, kern)
            states, prs = list(states), list(prs)
            for j, r in enumerate(hidx):
                states[r] = pytree.tree_map(
                    lambda full, new: _put(full, shard, new), states[r],
                    st2[j])
                prs[r] = _put(prs[r], shard, pr2[j])
            storage.set_device_state(tuple(states), pools)
            storage.set_device_page_revs(tuple(prs))
    else:                                        # ReplicaGroup
        states, pools = storage.device_state()   # healthy replicas only
        if not states:
            raise RuntimeError("no healthy replica to compute against")
        prs = storage.device_page_revs()
        view = VolumeView([states[0].table], [pools[0]], vid, kern)
        val, stt, out, do_w = entry.apply(view, page, block, arg, pay)
        if entry.writes:
            st2, pr2 = _commit(states, pools, prs, vid, page, block, pay,
                               do_w, kern)
            storage.set_device_state(st2, pools)
            storage.set_device_page_revs(pr2)
    i32 = torch.zeros((), dtype=torch.int32, device=dev)
    v, s, o = fetch_to_host(as_device(val, i32).reshape(1),
                            as_device(stt, i32).reshape(1), out)
    return int(v[0]), int(s[0]), np.asarray(o)
