"""Ambient distribution context for model code.

Port of ``repro/distributed/runtime.py``. Model functions are
mesh-agnostic; a launcher that wants to pin the residual stream's
placement installs ``(mesh, placements)`` here, and ``constrain``
(called by ``models.blocks.apply_block`` after each layer, where the
reference calls it) redistributes a DTensor to them. A plain tensor, and
any tensor while nothing is installed, is returned as it is.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import NamedTuple, Optional, Sequence

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
