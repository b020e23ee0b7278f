"""ServeEngine: continuous batching with the KV cache in the DBS pools.

Port of ``GenRequest`` and ``ServeEngine(kv_backend="fused"|"sharded"|
"ring")`` from ``repro/serving/engine.py``. One running engine = one Longhorn node:

- admission goes through the **multi-queue frontend** (ublk analogue),
- live requests own **slots** in a fixed SlotTable (Messages Array); the
  decode batch is always the full slot array, inactive lanes masked,
- each request's KV state is a **DBS volume** of a
  ``blockdev.VolumeManager``. The engine's payload pool *is* the KV cache:
  one block holds one token's K/V for every paged layer
  (``payload_shape=(n_planes, KV, hd)``, plane ``2j`` = paged layer j's
  keys, ``2j+1`` its values); page allocation and CoW ride ordinary write
  requests batched into ONE pump per step, and the hand-written
  paged-attention kernel reads K/V straight out of the extent pool through
  the volume's extent map — no staging copy of the KV cache exists,
- **forking** a session is ``VolumeManager.clone``: prefix extents shared,
  diverging writes CoW'd by the DBS write kernel, O(1) in context length,
- completion retires the slot and ``VolumeManager.delete`` frees the
  extents.

The reference jit-compiles the decode program and donates the pools; here
it runs eagerly and scatters the new token's K/V into the live replica
pools in place. Lanes that must not write (inactive slots, holes) scatter
into the pool's last row, the DBS dump row: that is where the reference's
``mode="drop"`` scatter at index -1 lands too (a negative index wraps),
and no reader takes data from it (the write kernel parks inert lanes
there, reads resolve only allocated extents, and ``consistent()`` compares
revisions).

``kv_backend="host"`` keeps the pre-zero-copy data path as the measured
copy-based baseline: model-owned KV pools (one per global layer, K and V)
driven by the host backend's ``alloc_pages``, one ``dbs_copy`` per pool on
every CoW, prefill written through the block table and decode through the
plain paged gather (``blocks._local_paged_decode``). Where the reference's
baseline differs from it (ROADMAP queue 3): idle decode lanes read and
write no volume (the reference gives them volume 0's block table, and they
overwrite that session's position-0 K/V), and the prompt is prefilled
unpadded with only its last page's K/V zero-padded (the reference prefills
the padded prompt, whose pad tokens push real positions out of a window
ring shorter than the padded prompt).

Hybrid nets (hymba) carry a Mamba state ``{"conv", "ssm"}`` in every
layer's cache beside its paged pool or window ring. The reference cannot
serve them (ROADMAP queue 3): its prefill slices each per-slot cache entry
as ``v[slot:slot + 1]``, which shortens the Mamba tuple instead of taking
the slot's rows, and its zero-copy prefill neither hands a paged layer
the slot's Mamba state nor writes the prompt's back. Here every layer's
single-sequence cache holds the slot's rows of its per-slot entries, as
views that prefill updates in place; admission zeroes the slot's Mamba
state and a fork copies it (both as for RWKV below). MoE nets need nothing
of the engine: ``apply_moe`` reads nothing back to the host.

Pure-recurrent nets (RWKV-6) serve on ``kv_backend="host"`` only, as in
the reference (``"fused"`` raises: it needs a paged layer). Their state
lives in per-slot model caches (``{"rwkv": {wkv, shift_t, shift_c}}``),
which prefill and decode update in place; the volume still carries the
session's metadata pages, and no ``dbs_copy`` runs (there is no pool).
The reference cannot serve them (ROADMAP queue 3), and the port differs
where: a slot's cache rows are taken through a tree map (the reference
slices the nested cache dict itself and raises ``KeyError`` at the first
step); admission zeroes the slot's recurrent rows (the reference starts
prefill from the last occupant's state, moved on by the idle decode
lanes); ``fork`` copies every per-slot row of the parent's non-paged
caches, recurrent state and window rings alike (the reference copies
none); and the prompt is prefilled unpadded (the reference's page padding
feeds pad tokens into the recurrence).

``kv_backend="sharded"`` (and ``"ring"``, whose storage is the same
stacked group, and whose forks' clones and sessions' deletes ride the
ring's requests in-band) keeps the KV store on the shard-stacked pool
(``kv_shards`` shards, core/sharded.py): session volumes spread over the
shards, the extent map and the pools are the flattened global views
(``VolumeManager.device_extent_map``/``device_pools``), and one pump and
one decode program serve every shard. Health there is per shard, and the
decode attends through the first replica healthy on every shard (the
reference attends replica 0's pool whatever its health, so after a
shard's replica 0 fails it reads pages the pumps no longer write; ROADMAP
queue 3). ``control("fail"|"rebuild", shard=, replica=)`` addresses one
shard's slice.

Multi-codebook nets (musicgen) take prompts of shape ``(S, K)``: the
prompt's K codebook embeddings are summed as in ``forward``. Each decode
step emits codebook 0's argmax and feeds that one token back to all K
codebooks, and a prompt's last step feeds its last row's codebook 0: the
reference's behaviours, kept (the EnCodec delay pattern is upstream of
the model and a stub here; ROADMAP queue 3). Recorded logits are (K, V)
a step.

MLA nets (deepseek-v3) need nothing of their own: a layer's one latent KV
head takes two planes of (1, 576), the values zero-padded from 512 to the
pool's width, and the decode slices the attention's output back to 512;
the copy-based baseline's model-owned pools are (E, page, 1, 576) keys
and (E, page, 1, 512) values.

``ServePool`` steps several engines as shards. The engine runs on
``device`` (default ``cuda``, with no CPU fallback).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import (ArchConfig, ATTN_MLA, ATTN_RWKV,
                                      ExecutionPlan)
from repro_torch.core import slots
from repro_torch.core.blockdev import VolumeManager
from repro_torch.core.engine import resolve_device
from repro_torch.core.frontend import MultiQueueFrontend, Request
from repro_torch.core.ring import OP_CLONE, ST_OK
from repro_torch.kernels.dbs.ops import dbs_copy_pool
from repro_torch.kernels.paged_attention.kernel import paged_attention_pool_fwd
from repro_torch.kernels.paged_attention.ref import paged_attention_pool_ref
from repro_torch.models import blocks as B
from repro_torch.models import model as M

SHARED_CACHE_KEYS = ("pool_k", "pool_v", "block_table")


@dataclass
class GenRequest:
    req_id: int
    prompt: np.ndarray            # (S,) int token ids, (S, K) codebooks
    max_new: int = 16
    out_tokens: List[int] = field(default_factory=list)
    slot: int = -1
    volume: int = -1
    done: bool = False
    # per-decode-step logits, recorded only when the engine was built with
    # record_logits=True (the fork bit-identity tests)
    logit_trace: List[np.ndarray] = field(default_factory=list)


def _paged_layer_info(cfg: ArchConfig, sig) -> Optional[Tuple[int, int, int]]:
    """(kd, vd, n_kv) for layers whose decode cache is paged (pool-backed),
    mirroring ``blocks.init_layer_cache``; None for ring/recurrent layers."""
    if sig.attn == ATTN_RWKV or sig.window:
        return None
    if sig.attn == ATTN_MLA:
        m = cfg.mla
        return m.kv_lora_rank + m.rope_head_dim, m.kv_lora_rank, 1
    hd = cfg.resolved_head_dim
    return hd, hd, cfg.n_kv_heads


def _slot_rows(cache, slot: int):
    """A layer cache for one sequence: the slot's rows of every per-slot
    entry (ring, recurrent state; nested dicts kept), as views, so writes
    to them land in the batch cache; the shared paged pools and block
    table as they are."""
    return {k: (v if k in SHARED_CACHE_KEYS
                else _slot_rows(v, slot) if isinstance(v, dict)
                else v[slot:slot + 1]) for k, v in cache.items()}


def _per_slot_tensors(cache):
    """Every tensor of a layer cache whose leading dimension is the slot
    (all but the shared paged pools and block table), nested dicts walked."""
    for k, v in cache.items():
        if k in SHARED_CACHE_KEYS:
            continue
        if isinstance(v, dict):
            yield from _per_slot_tensors(v)
        else:
            yield v


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, *, n_slots: int = 4,
                 max_len: int = 256, n_queues: int = 2,
                 plan: Optional[ExecutionPlan] = None,
                 kv_backend: str = "fused", kv_shards: int = 1,
                 kv_replicas: int = 2, kernel: str = "auto",
                 record_logits: bool = False, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.plan = plan or ExecutionPlan(remat="none", attn_impl="chunked",
                                          compute_dtype="float32")
        self.n_slots = n_slots
        self.max_len = max_len
        self.kv_backend = kv_backend
        self.record_logits = record_logits
        page = cfg.page_blocks
        self.n_pages = math.ceil(max_len / page)
        dtype = getattr(torch, self.plan.compute_dtype)
        dev = self.device

        self.frontend = MultiQueueFrontend(n_queues, n_slots, batch=n_slots,
                                           device=dev)
        # DBS metadata: volumes = sessions; extents shared across layers
        # (one extent row holds every layer's K/V for its page of tokens).
        n_extents = n_slots * self.n_pages * 2 + 8   # headroom for forks/CoW
        self._zero_copy = kv_backend != "host"
        if self._zero_copy:
            infos = [_paged_layer_info(cfg, s) for s in B.layer_sigs(cfg)]
            self._paged = [(li,) + info for li, info in enumerate(infos)
                           if info is not None]
            if not self._paged:
                raise ValueError("zero-copy serving needs at least one "
                                 "paged-attention layer; use "
                                 "kv_backend='host' for pure-recurrent nets")
            kvs = {info[3] for info in self._paged}
            if len(kvs) > 1:
                raise ValueError(f"mixed KV head counts {sorted(kvs)} not "
                                 "supported by the pooled KV layout")
            self._n_kv = kvs.pop()
            self._dmax = max(max(kd, vd) for _, kd, vd, _ in self._paged)
            n_planes = 2 * len(self._paged)
            self._payload_shape = (n_planes, self._n_kv, self._dmax)
            # the engine extent pool IS the KV cache: the volume manager's
            # write requests allocate/CoW its rows, the paged-attention
            # kernel reads them through the extent map
            self.volumes = VolumeManager(
                backend=kv_backend, n_shards=kv_shards,
                n_replicas=kv_replicas, kernel=kernel,
                n_extents=n_extents, max_volumes=2 * n_slots,
                max_pages=self.n_pages, page_blocks=page,
                batch=max(2 * n_slots, 16),
                payload_shape=self._payload_shape, device=dev)
            # ring caches for the local layers; the model-owned paged pools
            # are never read (the paged fn reads the engine pool), so they
            # hold one dummy extent
            self.caches = M.init_cache(cfg, n_slots, max_len, paged=True,
                                       dtype=dtype, device=dev)
            self.caches = [self._pool_rows(c, 1) for c in self.caches]
            # live views of the engine's KV store; refreshed after every
            # pump that may move extents (_pump_writes)
            self._pools = self.volumes.device_pools()
            self._table = self.volumes.device_extent_map()
            self._attn = 0            # the pool the decode attends through
            self._attn_cuda = kernel in ("auto", "cuda")
            self._cow_pending: set = set()
            self._step_fn = self._decode_program
        else:
            # copy-based baseline: the host backend's control plane (no
            # pool of its own) and model-owned pools spanning its extents
            self.volumes = VolumeManager(
                backend="host", null_storage=True, n_extents=n_extents,
                max_volumes=2 * n_slots, max_pages=self.n_pages,
                page_blocks=page, payload_elems=1, device=dev)
            self.caches = M.init_cache(cfg, n_slots, max_len, paged=True,
                                       dtype=dtype, device=dev)
            self.caches = [self._pool_rows(c, n_extents)
                           for c in self.caches]
        self.pos = np.zeros((n_slots,), np.int32)
        self.slot_vol = np.full((n_slots,), -1, np.int64)
        self.live: Dict[int, GenRequest] = {}
        self._steps = 0

    @property
    def state(self):
        """The DBS metadata behind the session volumes (``state.table`` is
        the paged-attention block table): the host backend's own state on
        the copy-based baseline, else replica 0's (on the sharded pool its
        stacked (S, ...) state)."""
        if not self._zero_copy:
            return self.volumes.state
        return self.volumes.engine.backend.device_state()[0][0]

    @property
    def _sharded(self) -> bool:
        return self.volumes.engine.pool is not None

    @staticmethod
    def _pool_rows(cache, n_rows: int):
        """The cache with fresh zero ``pool_k``/``pool_v`` of ``n_rows``
        extent rows (paged layers only)."""
        if cache is None or "pool_k" not in cache:
            return cache
        c = dict(cache)
        for key in ("pool_k", "pool_v"):
            p = cache[key]
            c[key] = p.new_zeros((n_rows,) + tuple(p.shape[1:]))
        return c

    # ------------------------------------------------------------------ API
    def submit(self, req: GenRequest) -> None:
        """Queue a request. Its prompt is (S,) token ids, or (S, K) on a
        K-codebook net; another shape raises here (the reference fails
        later, inside the step's embedding)."""
        k = self.cfg.n_codebooks
        shape = np.shape(req.prompt)
        if (len(shape) != 2 or shape[1] != k) if k > 1 else len(shape) != 1:
            want = f"(S, {k})" if k > 1 else "(S,)"
            raise ValueError(f"request {req.req_id}: prompt of shape {shape}, "
                             f"not {want} for {self.cfg.name}")
        self.frontend.submit(Request(req_id=req.req_id, kind="write",
                                     volume=-1, page=0, payload=req))

    def fork(self, req_id: int, new_req_id: int, max_new: int = 16
             ) -> Optional[GenRequest]:
        """Fork a live session: clone its DBS volume. O(1) in context
        length — prefix extents are shared, not copied; the parent's and
        child's next writes to the shared frontier page CoW in-kernel."""
        src = self.live.get(req_id)
        if src is None or src.slot < 0:
            return None
        child_vol = self.volumes.clone(src.volume)
        if child_vol is None:
            return None
        vid = child_vol.vid
        child = GenRequest(req_id=new_req_id,
                           prompt=np.zeros((0,), np.int64), max_new=max_new)
        child.out_tokens = list(src.out_tokens)
        # claim a slot directly (fork bypasses the admission queue); the
        # Messages Array records the op that owns the slot (ring opcode lane)
        dev = self.device
        i32 = lambda xs: torch.tensor(xs, dtype=torch.int32, device=dev)
        self.frontend.table, ids, ok = slots.admit(
            self.frontend.table, torch.ones((1,), dtype=torch.bool,
                                            device=dev),
            i32([vid]), i32([0]), i32(self._steps), opcodes=i32([OP_CLONE]))
        if not bool(ok[0]):
            self.volumes.delete(vid)
            return None
        child.slot = int(ids[0])
        child.volume = vid
        # window rings and recurrent state live in per-slot cache rows, not
        # in the volume: the child's slot takes a copy of the parent's
        # (bounded by the window or the state, not the context). The
        # reference skips this, so its forks read the slot's stale rows
        # (ROADMAP queue 3).
        for c in self.caches:
            if c is not None:
                for t in _per_slot_tensors(c):
                    t[child.slot] = t[src.slot]
        self.slot_vol[child.slot] = vid
        self.pos[child.slot] = self.pos[src.slot]
        self.live[new_req_id] = child
        if self._zero_copy:
            # both sides' next write to the shared frontier page must ride a
            # write request so the in-kernel CoW un-shares it before the
            # decode scatter touches it (the baseline's every step allocates
            # through alloc_pages, which CoWs it)
            self._cow_pending.add(req_id)
            self._cow_pending.add(new_req_id)
            self._table = self.volumes.device_extent_map()
        return child

    def control(self, kind: str, **kw):
        """Replica-plane control (fail/rebuild; ``shard=`` on the sharded
        pool) on the KV store. The pools are committed to the replicas
        first, so a control op sees every decode scatter, not just the last
        pumped state."""
        if not self._zero_copy:
            return self.volumes.engine.control(kind, **kw)
        if self._sharded and kind == "fail":
            self._check_attend_after_fail(kw.get("shard"), kw.get("replica"))
        self.volumes.set_device_pools(self._pools)
        out = self.volumes.engine.control(kind, **kw)
        self._table = self.volumes.device_extent_map()
        if kind == "rebuild":
            self._resync_live_rows(kw["replica"], kw.get("shard"))
        self._pools = self.volumes.device_pools()
        if self._sharded:
            # every shard's lanes read one pool: a replica healthy on all
            healthy = self.volumes.engine.backend.healthy.all(axis=0)
            self._attn = int(np.argmax(healthy))
        return out

    def _check_attend_after_fail(self, shard, replica) -> None:
        """The decode attends every shard's lanes through one pool, so a
        fail that would leave no replica healthy on every shard is refused
        before anything changes. Ids out of range are left to the pool's
        own check."""
        healthy = self.volumes.engine.backend.healthy
        s_n, r_n = healthy.shape
        if shard is None or replica is None or not (
                0 <= shard < s_n and 0 <= replica < r_n):
            return
        after = healthy.copy()
        after[shard, replica] = False
        if not after.all(axis=0).any():
            raise RuntimeError(
                f"failing shard {shard} replica {replica} would leave no KV "
                "replica healthy on every shard, and the decode attends "
                "through one")

    def _resync_live_rows(self, replica: int,
                          shard: Optional[int] = None) -> None:
        """The decode program scatters K/V into the pools with no watermark
        stamp, so the delta rebuild misses what it wrote into pages mapped
        before the failure (the reference leaves those rows stale; ROADMAP
        queue 3). Every row a live session maps, a superset of them, is
        streamed to the rebuilt replica (one host fetch for the row ids);
        on the sharded pool, the rows of the rebuilt shard's sessions, as
        that shard's own row ids."""
        vols = self.slot_vol[self.slot_vol >= 0]
        if shard is not None:
            vols = vols[vols % self.volumes.engine.pool.n_shards == shard]
        if not len(vols):
            return
        ext = self._table[torch.as_tensor(vols, dtype=torch.int64,
                                          device=self._table.device)]
        ext = torch.unique(ext[ext >= 0]).long()
        storage = self.volumes.engine.backend
        if shard is None:
            storage.resync_rows(replica, ext)
        else:
            rows = storage.pools[0].shape[1]            # E+1 a shard
            storage.resync_rows(shard, replica, ext - shard * rows)

    # ------------------------------------------------------- engine stepping
    def _admit(self) -> List[GenRequest]:
        slot_ids, reqs = self.frontend.poll_batch()
        admitted = []
        for sid, r in zip(slot_ids.tolist(), reqs):
            g: GenRequest = r.payload
            g.slot = int(sid)
            g.volume = self.volumes.create().vid
            self._reset_recurrent(g.slot)
            self.slot_vol[g.slot] = g.volume
            self.live[g.req_id] = g
            admitted.append(g)
        return admitted

    def _reset_recurrent(self, slot: int) -> None:
        """Zero the slot's recurrent-state rows (RWKV and Mamba), so a
        prompt starts from the initial state and not from the last
        occupant's (module note)."""
        for c in self.caches:
            for key in ("rwkv", "mamba"):
                if c is not None and key in c:
                    for t in _per_slot_tensors(c[key]):
                        t[slot].zero_()

    # ---------------------------------------------- zero-copy KV data plane
    def _pump_writes(self) -> None:
        """Complete every queued write request in ONE batched pump: page
        allocation and CoW for all lanes resolve inside the engine's fused
        step. The pools are committed around the pump and the extent-map
        view is refreshed after."""
        self.volumes.set_device_pools(self._pools)
        self.volumes.flush()
        self._pools = self.volumes.device_pools()
        self._table = self.volumes.device_extent_map()

    def _submit_kv_write(self, vid: int, pos: int, payload=None) -> None:
        page = self.cfg.page_blocks
        if payload is None:
            payload = np.zeros(self._payload_shape, np.float32)
        self.volumes.submit(Request(
            req_id=self.volumes._rid(vid), kind="write", volume=vid,
            page=pos // page, block=pos % page, payload=payload))

    def _decode_program(self, params, last, pos, active, bt, pools, caches):
        """One decode step over the engine's KV pools: per paged layer,
        scatter the new token's K/V into every replica pool at its extent
        row (in place) and attend straight off the pool through the extent
        map. All inputs live on the device and nothing is read back.
        Returns (logits, next tokens, caches, pools)."""
        caches = M.with_block_tables(caches, bt)
        page = self.cfg.page_blocks
        n_pages = self.n_pages
        j = [0]
        lanes = torch.arange(bt.shape[0], device=bt.device)
        dmax = self._dmax

        def paged_fn(q, k_new, v_new, pk, pv, bt_, q_pos, *, window=0,
                     logit_cap=0.0, scale=None):
            jj = j[0]
            j[0] += 1
            _, kd, vd, _ = self._paged[jj]
            kp, vp = 2 * jj, 2 * jj + 1
            p = q_pos[:, 0]
            # an idle slot keeps its last occupant's position, which may be
            # max_len: clamp its page (its lane writes nowhere and its
            # output is discarded)
            ext = bt_[lanes, (p // page).clamp(max=n_pages - 1).long()]
            off = (p % page).long()
            dump = pools[0].shape[0] - 1
            extw = torch.where(active & (ext >= 0), ext, dump).long()
            kn, vn = k_new[:, 0], v_new[:, 0]
            if kn.shape[-1] < dmax:
                kn = F.pad(kn, (0, dmax - kn.shape[-1]))
            if vn.shape[-1] < dmax:
                vn = F.pad(vn, (0, dmax - vn.shape[-1]))
            for pool in pools:
                pool[extw, off, kp] = kn.to(pool.dtype)
                pool[extw, off, vp] = vn.to(pool.dtype)
            qk = q[:, 0]                         # (B, H, hd): one token
            if qk.shape[-1] < dmax:
                qk = F.pad(qk, (0, dmax - qk.shape[-1]))
            # the pool's trailing dim is padded to dmax — the kernel's
            # default 1/sqrt(d) would use the padded dim, so pass the true
            # head-dim scale explicitly
            eff_scale = (float(scale) if scale is not None
                         else 1.0 / math.sqrt(kd))
            lengths = (p + 1).to(torch.int32)
            attend = (paged_attention_pool_fwd if self._attn_cuda
                      else paged_attention_pool_ref)
            # q in the compute dtype against the fp32 pool, as the
            # reference hands it to its kernel; out in q's dtype
            out = attend(qk.contiguous(), pools[self._attn],
                         bt_.contiguous(), lengths, k_plane=kp, v_plane=vp,
                         window=window, logit_cap=logit_cap, scale=eff_scale)
            out = out[..., :vd].to(q.dtype)[:, None]
            return out, pk, pv

        logits, caches = M.decode_step(params, last, pos, self.cfg,
                                       self.plan, caches,
                                       paged_decode_fn=paged_fn)
        nxt = torch.argmax(logits, dim=-1)
        return logits, nxt, caches, pools

    def _prefill_one_zero(self, g: GenRequest) -> None:
        """Prefill a prompt, then push its K/V into the engine pools as
        ordinary write requests (one per prompt token/block): allocation
        and payload ride the same batched pump as every other write; the
        caller flushes once for all admitted prompts."""
        prompt = np.asarray(g.prompt)
        s = prompt.shape[0]
        if s == 0:
            return
        dtype = getattr(torch, self.plan.compute_dtype)
        dev = self.device
        # single-sequence prefill with dense K/V caches for the paged layers
        # (their content goes to the ENGINE pool, not the model's); the
        # ring caches and recurrent states (a hybrid paged layer's Mamba
        # state too) are the slot's rows of the batch caches, as views, so
        # the prefill writes them in place
        caches_one = []
        for c in self.caches:
            if c is None:
                caches_one.append(None)
                continue
            one = _slot_rows(c, g.slot)
            if "pool_k" in c:
                kd, vd = c["pool_k"].shape[-1], c["pool_v"].shape[-1]
                n_kv = c["pool_k"].shape[2]
                for key in SHARED_CACHE_KEYS:
                    del one[key]
                one["k"] = torch.zeros((1, s, n_kv, kd), dtype=dtype,
                                       device=dev)
                one["v"] = torch.zeros((1, s, n_kv, vd), dtype=dtype,
                                       device=dev)
            caches_one.append(one)
        tok = torch.as_tensor(prompt, dtype=torch.int64, device=dev)[None]
        _logits, caches_one = M.prefill(self.params, tok, self.cfg,
                                        self.plan, caches_one)
        # one payload block per prompt token: every paged layer's K/V planes,
        # assembled on the device and fetched to the host in one copy
        pay = torch.zeros((s,) + self._payload_shape, dtype=torch.float32,
                          device=dev)
        for j, (li, kd, vd, _) in enumerate(self._paged):
            pay[:, 2 * j, :, :kd] = caches_one[li]["k"][0].float()
            pay[:, 2 * j + 1, :, :vd] = caches_one[li]["v"][0].float()
        pay = pay.cpu().numpy()
        for t in range(s):
            self._submit_kv_write(g.volume, t, payload=pay[t])
        self.pos[g.slot] = s

    # --------------------------------------------- copy-based KV data plane
    def _alloc_pages(self, vols, pages, mask):
        """Copy-based control plane: allocate/CoW through the host backend;
        the returned WriteOps drive the model-owned KV pools, one
        ``dbs_copy`` per pool (K and V of each paged layer) whenever a lane
        CoWs — the copies the zero-copy path retires. Testing for a CoW is
        the baseline's one host sync per call."""
        ops = self.volumes.alloc_pages(vols, pages, mask=mask)
        if bool((ops.cow_src >= 0).any()):
            cow = ops.cow_src >= 0
            for c in self.caches:
                if c is not None and "pool_k" in c:
                    for key in ("pool_k", "pool_v"):
                        dbs_copy_pool(c[key], ops.cow_src, ops.dst, cow)
        return ops

    def _prefill_one_host(self, g: GenRequest) -> None:
        """Allocate the prompt's pages, then prefill straight into the
        model-owned pools through the volume's block table (the slot's ring
        and recurrent rows, a paged layer's Mamba state included, are
        views, written in place). The prompt runs unpadded; its last page's
        K/V is zero-padded (module note)."""
        prompt = np.asarray(g.prompt)
        s = prompt.shape[0]
        if s == 0:
            return
        dev = self.device
        n_pages = -(-s // self.cfg.page_blocks)
        self._alloc_pages(
            torch.full((n_pages,), g.volume, dtype=torch.int64, device=dev),
            torch.arange(n_pages, device=dev),
            torch.ones((n_pages,), dtype=torch.bool, device=dev))
        bt_row = self.state.table[g.volume][None, :]
        caches_one = []
        for c in self.caches:
            if c is None:
                caches_one.append(None)
                continue
            one = _slot_rows(c, g.slot)
            if "block_table" in one:
                one["block_table"] = bt_row
            caches_one.append(one)
        tok = torch.as_tensor(prompt, dtype=torch.int64, device=dev)[None]
        M.prefill(self.params, tok, self.cfg, self.plan, caches_one)
        self.pos[g.slot] = s

    def _prefill_one(self, g: GenRequest) -> None:
        if self._zero_copy:
            self._prefill_one_zero(g)
        else:
            self._prefill_one_host(g)

    # ----------------------------------------------------------------- step
    def step(self) -> List[Tuple[int, int]]:
        """One continuous-batching iteration. Returns [(req_id, token)]."""
        admitted = self._admit()
        pending = False
        for g in admitted:
            self._prefill_one(g)
            pending = pending or (self._zero_copy
                                  and np.asarray(g.prompt).shape[0] > 0)
        active = np.array([self.slot_vol[i] >= 0 and any(
            r.slot == i and not r.done for r in self.live.values())
            for i in range(self.n_slots)])
        if not active.any():
            if pending:
                self._pump_writes()
            return []
        page = self.cfg.page_blocks
        if self._zero_copy:
            # control plane: lanes crossing a page boundary allocate their
            # new page, freshly-forked lanes CoW their shared frontier page
            # — all as write requests completed by ONE batched pump
            for i in range(self.n_slots):
                if not active[i]:
                    continue
                g = self.live_by_slot(i)
                if (self.pos[i] % page == 0
                        or g.req_id in self._cow_pending):
                    self._submit_kv_write(int(self.slot_vol[i]),
                                          int(self.pos[i]))
                    self._cow_pending.discard(g.req_id)
                    pending = True
            if pending:
                self._pump_writes()
        dev = self.device
        vols = torch.as_tensor(np.where(active, self.slot_vol, 0),
                               dtype=torch.int64, device=dev)
        last = torch.as_tensor(
            [(self.live_by_slot(i).out_tokens[-1]
              if self.live_by_slot(i) and self.live_by_slot(i).out_tokens
              else self._last_prompt_token(i)) for i in range(self.n_slots)],
            dtype=torch.int64, device=dev)
        if self.cfg.n_codebooks > 1:
            # the reference feeds the one emitted token to every codebook
            # (module note)
            last = last[:, None].expand(self.n_slots, self.cfg.n_codebooks)
        pos_dev = torch.as_tensor(self.pos, device=dev)
        active_dev = torch.as_tensor(active, device=dev)
        if self._zero_copy:
            # data plane: one decode program — KV scatter into the engine
            # pools + paged attention through the extent map
            bt = self._table[vols]
            logits, nxt, self.caches, self._pools = self._step_fn(
                self.params, last, pos_dev, active_dev, bt, self._pools,
                self.caches)
        else:
            # every active lane allocates (or CoWs) the page it writes;
            # an idle slot's position may be max_len, so its page is clamped
            pages = torch.as_tensor(
                np.minimum(self.pos // page, self.n_pages - 1),
                dtype=torch.int64, device=dev)
            self._alloc_pages(vols, pages, active_dev)
            # idle lanes get an all-hole block table: they read and write
            # no volume (module note)
            bt = torch.where(active_dev[:, None], self.state.table[vols], -1)
            self.caches = M.with_block_tables(self.caches, bt)
            logits, self.caches = M.decode_step(
                self.params, last, pos_dev, self.cfg, self.plan, self.caches)
            nxt = torch.argmax(logits, dim=-1)
        if self.cfg.n_codebooks > 1:
            nxt = nxt[:, 0]                       # codebook 0's argmax
        nxt_host = nxt.cpu().numpy()
        # bf16 logits are recorded as their exact fp32 values (numpy has
        # no bfloat16)
        logits_host = (logits.float().cpu().numpy() if self.record_logits
                       else None)
        self.pos = self.pos + active.astype(np.int32)
        out = []
        self._steps += 1
        for i in range(self.n_slots):
            if not active[i]:
                continue
            g = self.live_by_slot(i)
            g.out_tokens.append(int(nxt_host[i]))
            if logits_host is not None:
                g.logit_trace.append(logits_host[i].copy())
            out.append((g.req_id, int(nxt_host[i])))
            if len(g.out_tokens) >= g.max_new or \
                    int(self.pos[i]) >= self.max_len:
                self._finish(g)
        return out

    def live_by_slot(self, slot: int) -> Optional[GenRequest]:
        for g in self.live.values():
            if g.slot == slot and not g.done:
                return g
        return None

    def _last_prompt_token(self, slot: int) -> int:
        g = self.live_by_slot(slot)
        if g is None or g.prompt.shape[0] == 0:
            return 0
        t = g.prompt[-1]
        return int(t if np.ndim(t) == 0 else t.flat[0])   # codebook 0

    def _finish(self, g: GenRequest) -> None:
        g.done = True
        dev = self.device
        self.frontend.table = slots.retire(
            self.frontend.table,
            torch.tensor([g.slot], dtype=torch.int32, device=dev),
            statuses=torch.tensor(ST_OK, dtype=torch.int32, device=dev))
        self.volumes.delete(g.volume)
        if self._zero_copy:
            self._cow_pending.discard(g.req_id)
        self.slot_vol[g.slot] = -1
        g.slot = -1

    def run(self, max_steps: int = 64) -> Dict[int, List[int]]:
        for _ in range(max_steps):
            self.step()
            if all(g.done for g in self.live.values()) and \
                    self.frontend.depth() == 0:
                break
        return {rid: g.out_tokens for rid, g in self.live.items()}


class ServePool:
    """The serve path over a pool of engine shards: S independent
    ``ServeEngine`` nodes, requests hash-sharded by ``req_id % S``, stepped
    together.

    Each shard keeps its own slot table, DBS metadata and KV pools, so a
    heavy tenant saturates one shard's slots without starving the others.
    Forking stays shard-local (``dbs.clone`` shares extents only within one
    DBS state), so a forked child lives on its parent's shard whatever its
    req_id; ``_home`` records that routing. ``**kw`` goes to every
    ``ServeEngine``."""

    def __init__(self, cfg: ArchConfig, params, *, n_shards: int = 2, **kw):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.shards = [ServeEngine(cfg, params, **kw)
                       for _ in range(n_shards)]
        self._home: Dict[int, int] = {}

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def shard_of(self, req_id: int) -> int:
        return self._home.get(req_id, req_id % self.n_shards)

    def submit(self, req: GenRequest) -> None:
        # hash routing only: recording it in _home would let a later submit
        # clobber a live forked child's off-hash home
        self.shards[req.req_id % self.n_shards].submit(req)

    def fork(self, req_id: int, new_req_id: int, max_new: int = 16
             ) -> Optional[GenRequest]:
        shard = self.shard_of(req_id)
        child = self.shards[shard].fork(req_id, new_req_id, max_new)
        if child is not None and shard != new_req_id % self.n_shards:
            self._home[new_req_id] = shard       # off-hash: remember it
        return child

    def step(self) -> List[Tuple[int, int]]:
        """One pool iteration: every shard's continuous-batching step."""
        out: List[Tuple[int, int]] = []
        for sh in self.shards:
            out.extend(sh.step())
        for rid in [r for r, s in self._home.items()
                    if self.shards[s].live.get(r) is not None
                    and self.shards[s].live[r].done]:
            del self._home[rid]                  # finished forks: unpin
        return out

    def run(self, max_steps: int = 64) -> Dict[int, List[int]]:
        for _ in range(max_steps):
            self.step()
            if all(all(g.done for g in sh.live.values())
                   and sh.frontend.depth() == 0 for sh in self.shards):
                break
        out: Dict[int, List[int]] = {}
        for sh in self.shards:
            out.update({rid: g.out_tokens for rid, g in sh.live.items()})
        return out
