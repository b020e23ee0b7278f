"""Loss + train step: chunked cross-entropy, microbatch accumulation, remat.

Port of ``repro/training/train_step.py`` on autograd. The reference's
training path runs no Pallas kernel (its plan takes ``attn_impl=
"chunked"``, which is XLA code), so neither does this one: a plan whose
``attn_impl`` is ``"cuda"`` raises in the kernels' grad guard.

The chunked CE never materializes the full (B, S, V) logits tensor: it
walks sequence chunks, each under ``torch.utils.checkpoint``, so (B,
chunk, V) logits are the most it holds — for 256k-vocab archs (gemma2/3)
the difference between a 17 GB and a ~70 MB logits footprint per
microbatch.

``make_train_step`` returns ``(init, step)``; ``step(params, opt_state,
batch)`` updates params and optimizer state in place under
``torch.no_grad()`` (one copy of the state, as the reference's donated
buffers) and returns them with the reference's metrics, as 0-d tensors on
the device: ``ce``, ``aux`` (MoE with an aux loss), ``mtp`` (deepseek-v3),
``loss`` and ``grad_norm``. Microbatches accumulate their gradients in
fp32 buffers.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, ExecutionPlan
from repro_torch.models import forward, mtp_hidden
from repro_torch.models.layers import lm_logits
from repro_torch.models.model import tree_leaves, tree_map
from repro_torch.training.optimizer import make_optimizer

Params = Any
MTP_WEIGHT = 0.1
AUX_WEIGHT = 0.01


# ---------------------------------------------------------------------------
# chunked cross-entropy
# ---------------------------------------------------------------------------
def chunked_cross_entropy(params_embed: Params, h: torch.Tensor,
                          labels: torch.Tensor, cfg: ArchConfig,
                          chunk: int = 0) -> torch.Tensor:
    """h: (B,S,D); labels: (B,S) or (B,S,K). Returns mean NLL over tokens."""
    s = h.shape[1]
    if chunk <= 0 or s % chunk or s <= chunk:
        return _ce_block(params_embed, h, labels, cfg)
    n = s // chunk
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        hh, ll = h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            ce = checkpoint(_ce_block, params_embed, hh, ll, cfg,
                            use_reentrant=False, preserve_rng_state=False)
        else:
            ce = _ce_block(params_embed, hh, ll, cfg)
        total = total + ce * (1.0 / n)
    return total


def _ce_block(params_embed, h, labels, cfg) -> torch.Tensor:
    logits = lm_logits(params_embed, h, cfg).float()
    if any(p.is_shard(logits.ndim - 1)
           for p in getattr(logits, "placements", ())):
        # DTensor logits sharded on the vocab (a dry-run cell,
        # launch/specs.py): the log-partition and the gold logit as
        # reductions over the vocab, which each shard takes on its own
        # columns (a gather of the gold logit would gather every logit)
        m = torch.amax(logits, dim=-1, keepdim=True).detach()
        logz = m[..., 0] + torch.log(torch.sum(torch.exp(logits - m),
                                               dim=-1))
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.sum(torch.where(vocab == labels.long()[..., None],
                                     logits, 0.0), dim=-1)
        return torch.mean(logz - gold)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            plan: ExecutionPlan
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    tokens, labels = batch["tokens"], batch["labels"]
    h, aux = forward(params, tokens, cfg, plan)
    chunk = plan.logits_chunk
    loss = chunked_cross_entropy(params["embed"], h, labels, cfg, chunk)
    metrics = {"ce": loss}
    if cfg.moe is not None and not cfg.moe.router_aux_free:
        loss = loss + AUX_WEIGHT * aux
        metrics["aux"] = aux
    if cfg.mtp_depth and "mtp" in params:
        h_mtp = mtp_hidden(params, h, tokens, cfg, plan)
        # predict token t+2 from position t (labels already = t+1 shift)
        mtp_loss = chunked_cross_entropy(
            params["embed"], h_mtp[:, :-1], labels[:, 2:], cfg, chunk)
        loss = loss + MTP_WEIGHT * mtp_loss
        metrics["mtp"] = mtp_loss
    metrics["loss"] = loss
    return loss, metrics


def grads_of(params: Params, batch: Dict[str, torch.Tensor],
             cfg: ArchConfig, plan: ExecutionPlan):
    """(gradients as a tree like ``params``, metrics detached). The
    parameters need not require grad: the loss runs on detached aliases
    that do, so ``params`` stay plain tensors. A leaf the loss does not
    reach gets zeros, as ``jax.grad`` gives it."""
    with torch.enable_grad():
        alias = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(alias)
        loss, metrics = loss_fn(alias, batch, cfg, plan)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    it = iter(grads)
    return (tree_map(lambda _: next(it), params),
            {k: v.detach() for k, v in metrics.items()})


# ---------------------------------------------------------------------------
# train step (with microbatch gradient accumulation)
# ---------------------------------------------------------------------------
def make_train_step(cfg: ArchConfig, plan: ExecutionPlan,
                    optimizer: Optional[str] = None, **opt_overrides
                    ) -> Tuple[Callable, Callable]:
    """Returns (init_opt_state_fn, train_step_fn).

    train_step(params, opt_state, batch) -> (params, opt_state, metrics),
    params and state updated in place. Batch tensors have leading dim =
    global_batch; with ``plan.microbatches`` > 1 the step runs the
    microbatch slices one after another, adding their gradients into fp32
    buffers (constant memory in the number of microbatches)."""
    opt_name = optimizer or plan.optimizer
    opt_init, opt_update = make_optimizer(opt_name, **opt_overrides)

    def train_step(params, opt_state, batch):
        mb = plan.microbatches
        if mb <= 1:
            grads, metrics = grads_of(params, batch, cfg, plan)
        else:
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
            acc_leaves = tree_leaves(acc)
            ms = []
            for i in range(mb):
                micro = {k: v[i * (v.shape[0] // mb):
                              (i + 1) * (v.shape[0] // mb)]
                         for k, v in batch.items()}
                g, m = grads_of(params, micro, cfg, plan)
                torch._foreach_add_(acc_leaves, tree_leaves(g))
                del g
                ms.append(m)
            torch._foreach_div_(acc_leaves, float(mb))
            grads = acc
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        with torch.no_grad():
            params, opt_state, gnorm = opt_update(grads, opt_state, params)
        return params, opt_state, dict(metrics, grad_norm=gnorm)

    return opt_init, train_step
