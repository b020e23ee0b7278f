"""Ambient distribution context for model code.

Port of ``repro/distributed/runtime.py``. Model functions are
mesh-agnostic; a launcher that wants to pin the residual stream's
placement installs ``(mesh, placements)`` here, and ``constrain``
(called by ``models.blocks.apply_block`` after each layer, where the
reference calls it) redistributes a DTensor to them. A plain tensor, and
any tensor while nothing is installed, is returned as it is.

``spmd()`` runs the model's plain code on DTensors where the reference's
runs under XLA's SPMD partitioner. DTensor propagates shardings and issues
the collectives op by op, but refuses an op its rules cannot shard (a
reshape of a dim sharded unevenly, an op with no rule); where XLA would
reshard, ``spmd`` then redistributes the op's DTensor inputs to
``Replicate`` one mesh dim at a time, the last first, and retries; past
the last it runs the op on the replicated local tensors and returns
replicated DTensors. Partial sums an op leaves are reduced at once. Plain
tensors meet DTensors as replicated values (``implicit_replication``).
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import NamedTuple, Optional, Sequence

import torch

_ACT_SHARDING: ContextVar = ContextVar("activation_sharding", default=None)


class ActivationSharding(NamedTuple):
    mesh: object                 # a DeviceMesh
    placements: Sequence         # one DTensor placement a mesh dim


def get_activation_sharding() -> Optional[ActivationSharding]:
    return _ACT_SHARDING.get()


@contextlib.contextmanager
def activation_sharding(mesh, placements):
    tok = _ACT_SHARDING.set(ActivationSharding(mesh, tuple(placements)))
    try:
        yield
    finally:
        _ACT_SHARDING.reset(tok)


def constrain(x):
    ns = _ACT_SHARDING.get()
    if ns is None or not hasattr(x, "redistribute"):
        return x
    return x.redistribute(ns.mesh, ns.placements)


def _refused(exc: BaseException) -> bool:
    """An error raised inside DTensor's dispatch: its rules refused the op."""
    tb = exc.__traceback__
    while tb is not None:
        if "distributed/tensor/" in tb.tb_frame.f_code.co_filename.replace(
                "\\", "/"):
            return True
        tb = tb.tb_next
    return False


def _spmd_mode():
    from torch.distributed.tensor import DTensor, Replicate
    from torch.overrides import TorchFunctionMode
    from torch.utils._pytree import tree_leaves, tree_map

    class _Spmd(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if not any(isinstance(a, DTensor)
                       for a in tree_leaves((args, kwargs))):
                return func(*args, **kwargs)
            return tree_map(_settle, self._run(func, args, kwargs))

        def _run(self, func, args, kwargs):
            try:
                return func(*args, **kwargs)
            except Exception as exc:  # noqa: BLE001 - re-raised unless refused
                if not _refused(exc):
                    raise
                err = exc
            mesh = next(a.device_mesh for a in tree_leaves((args, kwargs))
                        if isinstance(a, DTensor))
            n = mesh.ndim
            for cut in range(n - 1, -1, -1):
                def rep(a, cut=cut):
                    if not isinstance(a, DTensor):
                        return a
                    pl = [Replicate() if i >= cut else p
                          for i, p in enumerate(a.placements)]
                    return _redistribute(a, pl)
                try:
                    return func(*tree_map(rep, args), **tree_map(rep, kwargs))
                except Exception as exc:  # noqa: BLE001
                    if not _refused(exc):
                        raise
                    err = exc

            def local(a):
                if not isinstance(a, DTensor):
                    return a
                return _redistribute(a, [Replicate()] * n).to_local()
            try:
                out = func(*tree_map(local, args), **tree_map(local, kwargs))
            except Exception as exc:  # noqa: BLE001
                raise err from exc
            return tree_map(lambda t: DTensor.from_local(
                t, mesh, [Replicate()] * n, run_check=False)
                if isinstance(t, torch.Tensor) and not isinstance(t, DTensor)
                else t, out)

    return _Spmd()


def _settle(t):
    """A DTensor with pending partial sums, reduced now (an all-reduce a
    partial mesh dim, as a row-parallel layer reduces after its matmul);
    anything else as it is."""
    if not hasattr(t, "placements") or not any(p.is_partial()
                                                for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    return _redistribute(t, [Replicate() if p.is_partial() else p
                             for p in t.placements])


def _redistribute(t, placements):
    """``t.redistribute`` with FakeTensorMode off the stack: DTensor plans a
    strided shard's move from index tensors it reads back, which a fake
    mode would make fake. The local tensors stay what they are (fake ones
    dispatch to their own mode)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        return t.redistribute(t.device_mesh, placements)


@contextlib.contextmanager
def spmd():
    """Model code on DTensors (module note): inside, an op DTensor refuses
    is retried on replicated inputs."""
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication(), _spmd_mode():
        yield
