"""Mesh collectives: distributed paged-DBS decode, hierarchical reductions,
gradient compression.

Port of ``repro/distributed/collectives.py``. ``make_sharded_paged_decode``
is the distributed form of the DBS read path: a volume's pages are striped
round-robin across the "model" axis (and across all axes when the batch
itself cannot shard), every shard gathers only its local extents,
computes a split-KV partial and the stripes merge with the FlashDecoding
log-sum-exp rule. The reference runs the step under ``shard_map``; here
each rank calls the returned function on its own shards, and the merge is
``all_reduce(MAX)`` of m, then ``all_reduce(SUM)`` of ``l*corr`` and
``o*corr`` over a process group that spans the stripe axes, built once
when the function is made. The reference computes this read with ``jnp``
outside any Pallas kernel, so torch ops are its counterpart here.

With ``kernel=True`` each stripe's read is the paged kernel's entry
(``paged_attention_lse_fwd``, q and the caches in the plan's compute
dtype, fp32 or bf16, and the output in it): a stripe-sliced table and the
stripe's own lengths where the pages divide by the stripe (no window),
else the whole table with the other stripes' pages as holes; the entry's
log-sum-exp stands in for the partial's (m, l). Called with DTensors (the
dry run's cells, ``launch/specs.py``), the function runs on their local
shards: q, the new K/V, positions and table redistributed to the batch
placement, the pools to the extent stripes, and returns the output as a
DTensor on the batch placement.

The reductions take the mesh explicitly (``shard_map`` gives the reference
its axes implicitly): ``hierarchical_psum(x, mesh)`` and
``compressed_cross_pod_mean(grads, mesh)``. They return new tensors and
leave their inputs as they were.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.planner import axis_sizes
from repro_torch.models import attention as attn
from repro_torch.models.model import tree_map


def _group(mesh, axes: Tuple[str, ...]):
    """The process group of this rank over mesh ``axes`` (ranks ordered
    major to minor in ``axes``' order); every rank builds every such group
    together, so call it on all ranks at once."""
    names = list(mesh.mesh_dim_names)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    ranks = mesh.mesh
    rest = [n for n in names if n not in axes]
    perm = [names.index(a) for a in rest] + [names.index(a) for a in axes]
    n_axes = 1
    for a in axes:
        n_axes *= ranks.shape[names.index(a)]
    groups = ranks.permute(perm).reshape(-1, n_axes).tolist()
    mine, _ = dist.new_subgroups_by_enumeration(groups)
    return mine


def make_sharded_paged_decode(mesh, batch_shardable: bool,
                              stripe_slice: bool = True,
                              kernel: bool = False):
    """Returns fn(q, k_new, v_new, pool_k, pool_v, block_table, q_pos,
    **kw) -> (out (B,1,H,dv), pool_k, pool_v), called by every rank on its
    own shards.

    Layouts (this rank's): q, k_new, v_new, block_table (local extent ids)
    and q_pos are the rank's batch shard over the batch axes, or the whole
    batch when it cannot be split; pools (E, page, KV, hd) are the rank's
    extent stripe over ``batch axes + ("model",)``. The stripe index is the
    rank's coordinate over the stripe axes, major to minor."""
    sizes = axis_sizes(mesh)
    baxes = tuple(a for a in ("pod", "data") if a in sizes)
    stripe = ("model",) if batch_shardable else baxes + ("model",)
    stride = 1
    for a in stripe:
        stride *= sizes[a]
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    rank = 0
    for a in stripe:
        rank = rank * sizes[a] + coord[a]
    group = _group(mesh, stripe)

    def fn(q, k_new, v_new, pool_k, pool_v, block_table, q_pos, **kw):
        if _is_dtensor(q, pool_k):
            return _on_shards(mesh, baxes if batch_shardable else (),
                              local, q, k_new, v_new, pool_k, pool_v,
                              block_table, q_pos, **kw)
        return local(q, k_new, v_new, pool_k, pool_v, block_table, q_pos,
                     **kw)

    def local(q, k_new, v_new, pool_k, pool_v, block_table, q_pos, *,
              window=0, logit_cap=0.0, scale=None):
        from repro_torch.models.blocks import paged_write_local
        pool_k, pool_v = paged_write_local(pool_k, pool_v, block_table,
                                           q_pos[:, 0], k_new, v_new, stride,
                                           rank)
        if kernel:
            o, m, l = _kernel_partial(q, pool_k, pool_v, block_table, q_pos,
                                      stride, rank, stripe_slice,
                                      window=window, logit_cap=logit_cap,
                                      scale=scale)
        else:
            o, m, l = attn.paged_decode_attention(
                q, pool_k, pool_v, block_table, q_pos, window=window,
                logit_cap=logit_cap, scale=scale, page_owner_stride=stride,
                owner_rank=rank, stripe_slice=stripe_slice)
        # FlashDecoding merge across the stripe axes
        m_star = m.clone()
        dist.all_reduce(m_star, dist.ReduceOp.MAX, group=group)
        corr = torch.exp(m - m_star)
        l_star = l * corr
        dist.all_reduce(l_star, group=group)
        o_star = o * corr[..., None]
        dist.all_reduce(o_star, group=group)
        out = o_star / torch.clamp(l_star[..., None], min=1e-30)
        b, kv, g, sq, dv = out.shape
        out = out.reshape(b, kv * g, sq, dv).transpose(1, 2).to(q.dtype)
        return out, pool_k, pool_v

    fn.stride, fn.owner_rank = stride, rank
    return fn


def _kernel_partial(q, pool_k, pool_v, block_table, q_pos, stride: int,
                    rank: int, stripe_slice: bool, *, window, logit_cap,
                    scale):
    """This stripe's partial (o, m, l) of one decode token through the
    paged kernel: o normalised over the stripe's live positions, m its
    log-sum-exp and l 1 (0 where the stripe saw no live position), which
    the FlashDecoding merge takes as it takes the plain partials."""
    from repro_torch.kernels.paged_attention.kernel import (
        NEG_INF, paged_attention_lse_fwd)
    b, p_max = block_table.shape
    page = pool_k.shape[1]
    length = q_pos[:, 0].to(torch.int32) + 1
    if stride == 1:
        table = block_table
    elif stripe_slice and p_max % stride == 0 and not window:
        # owned pages p = l * stride + rank, local page l: every owned page
        # before the sequence's last is full, so a local length says it
        table = block_table.reshape(b, p_max // stride, stride)[:, :, rank]
        full, rem = length // page, length % page
        owned = torch.clamp((full - rank + stride - 1) // stride, min=0)
        length = owned * page + torch.where(
            (rem > 0) & (full % stride == rank), rem, 0)
    else:
        pages = torch.arange(p_max, device=block_table.device)
        table = torch.where((pages % stride == rank)[None, :], block_table,
                            -1)
    out, lse = paged_attention_lse_fwd(
        q[:, 0].contiguous(), pool_k, pool_v,
        table.to(torch.int32).contiguous(),
        length.to(torch.int32).contiguous(), window=window,
        logit_cap=logit_cap, scale=scale)
    kv = pool_k.shape[2]
    g = q.shape[2] // kv
    o = out.reshape(b, kv, g, 1, out.shape[-1])
    m = lse.reshape(b, kv, g, 1)
    return o, m, (m > NEG_INF / 2).to(torch.float32)


def _is_dtensor(*tensors) -> bool:
    return any(type(t).__name__ == "DTensor" for t in tensors)


def _on_shards(mesh, baxes, local, q, k_new, v_new, pool_k, pool_v,
               block_table, q_pos, **kw):
    """``local`` on this rank's shards of DTensor inputs (the module note);
    plain tensors are taken as replicated values."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    names = mesh.mesh_dim_names
    batch = [Shard(0) if a in baxes else Replicate() for a in names]
    stripes = [Shard(0)] * len(names)

    def shard(t, places):
        if isinstance(t, DTensor):
            if list(t.placements) != places:
                t = t.redistribute(mesh, places)
            return t.to_local()
        return distribute_tensor(t, mesh, places,
                                 src_data_rank=None).to_local()
    out, _pk, _pv = local(
        shard(q, batch), shard(k_new, batch), shard(v_new, batch),
        shard(pool_k, stripes), shard(pool_v, stripes),
        shard(block_table, batch), shard(q_pos, batch), **kw)
    out = DTensor.from_local(out, mesh, batch, run_check=False)
    return out, pool_k, pool_v


# ---------------------------------------------------------------------------
# hierarchical gradient reduction (pod-aware) + int8 compression
# ---------------------------------------------------------------------------
def hierarchical_psum(x: torch.Tensor, mesh, inner: str = "data",
                      outer: str = "pod") -> torch.Tensor:
    """Reduce inside the pod first (the fast links), then across pods; a
    mesh without ``outer`` stops after the inner sum."""
    x = x.clone()
    dist.all_reduce(x, group=mesh.get_group(inner))
    if outer not in mesh.mesh_dim_names:
        return x
    dist.all_reduce(x, group=mesh.get_group(outer))
    return x


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization for cross-pod all-reduce."""
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_cross_pod_mean(grads, mesh, axis: str = "pod",
                              error_feedback: Optional[object] = None):
    """int8 all-reduce across pods with error feedback (EF-SGD style).

    grads: a tree already reduced inside the pod; ``error_feedback`` a tree
    like it (or ``None``). Returns (mean_grads, new_ef)."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)

    def one(g, ef):
        g32 = g.to(torch.float32) + (0.0 if ef is None else ef)
        q, s = compress_int8(g32)
        approx = decompress_int8(q, s)
        new_ef = g32 - approx
        total = approx.clone()
        dist.all_reduce(total, group=group)
        return (total / n).to(g.dtype), new_ef

    leaves = []
    tree_map(leaves.append, grads)
    efs = []
    if error_feedback is not None:
        tree_map(efs.append, error_feedback)
    outs = [one(g, efs[i] if efs else None) for i, g in enumerate(leaves)]
    it_mean = iter([o[0] for o in outs])
    it_ef = iter([o[1] for o in outs])
    return (tree_map(lambda _: next(it_mean), grads),
            tree_map(lambda _: next(it_ef), grads))
