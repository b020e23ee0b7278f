"""Cell builders: (arch x shape x mesh) -> step fn + sharded input tensors.

Port of ``repro/launch/specs.py``, shared by the dry run
(``launch/dryrun.py``), the tests and ``chip_smoke.py``. Where the
reference attaches the planner's shardings to ``ShapeDtypeStruct``s, here
the inputs are tensors placed as DTensors with the planner's placements
(``place_leaf``, each rank keeping its own slice): built under
``FakeTensorMode`` on a fake world (the dry run) they hold no memory, built
outside it on a real mesh they are the card's. ``build_cell`` follows the
reference branch for branch; the parameters take the reference's stacked
layout (``stack_params``), so a tree has its leaves.

A serve cell runs the kernel entries, as the card's run does, in its
plan's compute dtype (the kernels take fp32 and bf16, as the TPU kernels
do): prefill's attention through the flash kernel (``attn_impl="cuda"``,
the RWKV-6 scan too, which takes fp32 from the model in either plan) and
decode's striped read through the paged kernel
(``make_sharded_paged_decode(..., kernel=True)``); on a CPU mesh the
entries run their plain versions. A train cell runs the plain paths (the
kernels have no backward).
``Cell.step`` runs the model on DTensors inside ``runtime.spmd``.

``per_device_bytes`` is the reference's analytic formula: a leaf's global
bytes over the product of the mesh axes that shard it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs.base import (ArchConfig, ExecutionPlan, ShapeSpec,
                                      default_plan)
from repro_torch.distributed import runtime
from repro_torch.distributed.collectives import make_sharded_paged_decode
from repro_torch.distributed.planner import (P, Planner, axis_sizes,
                                             batch_axes, pool_stride)
from repro_torch.models.model import (decode_step, default_block_tables,
                                      init_cache, init_params, leaves_up_to,
                                      prefill, stack_params, tree_leaves,
                                      tree_map, unstack_params,
                                      with_block_tables)


@dataclasses.dataclass
class Cell:
    name: str
    step: Callable
    args: Tuple[Any, ...]          # DTensors (sharded)
    donate: Tuple[int, ...]
    tokens_per_step: int           # for MODEL_FLOPS accounting
    kind: str                      # train | prefill | decode
    plan: ExecutionPlan


def token_shape(cfg: ArchConfig, batch: int, seq: int) -> Tuple[int, ...]:
    return (batch, seq, cfg.n_codebooks) if cfg.n_codebooks > 1 else (batch, seq)


def _cast_float(tree, dtype: torch.dtype):
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    tree)


def place_leaf(t: torch.Tensor, mesh, placements):
    """``t`` as a DTensor whose local tensor is this rank's slice: a view
    of ``t`` where every mesh dim that shards it has size 1 (the slice is
    all of it: no copy, as a (1, 1) mesh's memory check needs), else a
    contiguous copy of the slice (``distribute_tensor`` copies every
    shard). Shards nest in mesh order; the planner shards only dims they
    divide."""
    from torch.distributed.tensor import DTensor
    local = t
    coord = mesh.get_coordinate()
    copy = False
    for m, pl in enumerate(placements):
        n = mesh.size(m)
        if pl.is_shard() and n > 1:
            size = local.shape[pl.dim] // n
            local = local.narrow(pl.dim, coord[m] * size, size)
            copy = True
    if copy:
        local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def _spmd_step(fn, kind: str):
    """``fn`` on DTensors inside ``runtime.spmd``; a serve step records no
    autograd graph (the train step turns grad on where it takes one)."""
    def step(*args):
        with runtime.spmd(), torch.set_grad_enabled(kind == "train"):
            return fn(*args)
    return step


_SHARDINGS_REGISTERED = []


def register_kernel_shardings() -> None:
    """DTensor sharding rules for the kernel entries that meet DTensors in
    a cell's step (once a process): flash attention and the RWKV-6 scan
    run on the local shards replicated, split by batch, or split by heads
    (q's and the KV heads alike, so each shard keeps whole GQA groups).
    The paged entry runs inside the striped decode's own shard map."""
    if _SHARDINGS_REGISTERED:
        return
    import repro_torch.kernels.flash_attention.kernel  # noqa: F401 (the ops)
    import repro_torch.kernels.rwkv6_scan.kernel  # noqa: F401
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _flash(q, k, v, causal, window, logit_cap, scale):
        rest = [None] * 4
        return [([p], [p] * 3 + rest)
                for p in (Replicate(), Shard(0), Shard(1))]

    @register_sharding(torch.ops.repro_torch.rwkv6_scan.default)
    def _scan(r, k, v, logw, u, s0, chunk):
        def one(x, u_p, s_p):
            return ([x, s_p], [x] * 4 + [u_p, s_p if s0 is not None else None,
                                         None])
        return [one(Replicate(), Replicate(), Replicate()),
                one(Shard(0), Replicate(), Shard(0)),
                one(Shard(2), Shard(0), Shard(1))]
    _SHARDINGS_REGISTERED.append(True)


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh,
               plan: Optional[ExecutionPlan] = None, *,
               seed: int = 0) -> Cell:
    """One cell on ``mesh`` (a DeviceMesh with the planner's axis names);
    its tensors are made on the mesh's device type from a generator seeded
    with ``seed``."""
    sizes = axis_sizes(mesh)
    n_chips = math.prod(sizes.values())
    n_batch_shards = math.prod(sizes[a] for a in batch_axes(sizes))
    plan = plan or default_plan(cfg, shape, n_chips,
                                data_shards=n_batch_shards)
    if plan.moe_pad_to and cfg.moe is not None:
        pad = math.ceil(cfg.moe.n_experts / plan.moe_pad_to) * plan.moe_pad_to
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, n_experts_padded=pad))
    # the kernel entries where the card runs them (module note)
    kernels = shape.kind != "train"
    if kernels:
        plan = dataclasses.replace(plan, attn_impl="cuda")
        register_kernel_shardings()
    planner = Planner(sizes, cfg, plan)
    dev = mesh.device_type
    gen = torch.Generator(device=dev).manual_seed(seed)
    name = f"{cfg.name}:{shape.name}"

    def place(tree, specs):
        places = iter(leaves_up_to(tree, planner.placements(specs)))
        return tree_map(lambda t: place_leaf(t, mesh, list(next(places))),
                        tree)

    params = stack_params(init_params(gen, cfg), cfg)
    if plan.unstack_params and shape.kind != "train":
        params = unstack_params(params, cfg)
    params = _cast_float(params, getattr(torch, plan.param_dtype))
    param_specs = planner.tree_specs(params)
    gb, seq = shape.global_batch, shape.seq_len
    compute = getattr(torch, plan.compute_dtype)

    def tokens(tshape):
        return torch.randint(0, cfg.vocab_size, tshape, generator=gen,
                             dtype=torch.int32, device=dev)

    if shape.kind == "train":
        from repro_torch.training.optimizer import make_optimizer
        from repro_torch.training.train_step import make_train_step
        opt_init, _ = make_optimizer(plan.optimizer)
        opt = opt_init(params)
        opt_specs = planner.opt_specs(param_specs, params, plan.optimizer)
        tshape = token_shape(cfg, gb, seq)
        bspec = planner.data_spec(tshape)
        tok = place(tokens(tshape), bspec)
        batch = {"tokens": tok, "labels": tok}
        _, step = make_train_step(cfg, plan)
        return Cell(name=name, step=_spmd_step(step, "train"),
                    args=(place(params, param_specs), place(opt, opt_specs),
                          batch), donate=(0, 1), tokens_per_step=gb * seq,
                    kind="train", plan=plan)

    if shape.kind == "prefill":
        caches = init_cache(cfg, gb, seq, paged=False, dtype=compute,
                            device=dev)
        cache_specs = planner.cache_specs(caches)
        tshape = token_shape(cfg, gb, seq)
        tspec = planner.data_spec(tshape)

        def prefill_step(params, tokens, caches):
            return prefill(params, tokens, cfg, plan, caches)
        return Cell(name=name, step=_spmd_step(prefill_step, "prefill"),
                    args=(place(params, param_specs),
                          place(tokens(tshape), tspec),
                          place(caches, cache_specs)),
                    donate=(2,), tokens_per_step=gb * seq, kind="prefill",
                    plan=plan)

    # ---- decode ------------------------------------------------------------
    baxes = batch_axes(sizes)
    bsize = math.prod(sizes[a] for a in baxes)
    batch_shardable = gb % bsize == 0 and gb >= bsize
    stride = pool_stride(sizes, batch_shardable)
    caches = init_cache(cfg, gb, seq, paged=True, dtype=compute,
                        page_owner_stride=stride, device=dev)
    caches = with_block_tables(caches, default_block_tables(
        cfg, gb, seq, stride, bsize if batch_shardable else 1, device=dev))
    cache_specs = planner.cache_specs(caches)
    bspec = P(baxes) if batch_shardable else P()
    tshape = (gb, cfg.n_codebooks) if cfg.n_codebooks > 1 else (gb,)
    tspec = bspec + (None,) * (len(tshape) - 1)
    # the step at the end of a full context: every page live
    pos = torch.full((gb,), seq - 1, dtype=torch.int32, device=dev)
    paged_fn = make_sharded_paged_decode(
        mesh, batch_shardable, stripe_slice=plan.paged_stripe_slice,
        kernel=kernels)

    def decode(params, tokens, positions, caches):
        return decode_step(params, tokens, positions, cfg, plan, caches,
                           paged_decode_fn=paged_fn)
    return Cell(name=name, step=_spmd_step(decode, "decode"),
                args=(place(params, param_specs), place(tokens(tshape), tspec),
                      place(pos, bspec), place(caches, cache_specs)),
                donate=(3,), tokens_per_step=gb, kind="decode", plan=plan)


# ---------------------------------------------------------------------------
# memory accounting (analytic, backend-independent)
# ---------------------------------------------------------------------------
def per_device_bytes(mesh, tree) -> float:
    """A leaf's bytes over the product of the mesh axes that shard it,
    summed: DTensor leaves by their placements, plain ones whole."""
    sizes = axis_sizes(mesh)
    names = list(sizes)

    def one(t) -> float:
        n = t.numel() * t.element_size()
        shards = 1
        for i, pl in enumerate(getattr(t, "placements", ())):
            if pl.is_shard():
                shards *= sizes[names[i]]
        return n / shards
    return sum(one(t) for t in tree_leaves(tree) if t is not None)


def local_bytes(tree) -> int:
    """Bytes of this rank's local shards of ``tree``'s leaves."""
    def one(t) -> int:
        t = t.to_local() if hasattr(t, "to_local") else t
        return t.numel() * t.element_size()
    return sum(one(t) for t in tree_leaves(tree) if t is not None)
