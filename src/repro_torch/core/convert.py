"""Engine state and model weights carried between the JAX package and the
port, as numpy.

Engine state: each function takes dicts of numpy arrays named like the
reference dataclass fields (``repro.core.dbs.DBSState``,
``repro.core.slots.SlotTable``, nested ``free``/``ring`` dicts for their
``SlotRing``), so a caller can hand over
``jax.device_get(dataclasses.asdict(state))`` and the port never sees a
JAX array. The block bitmap is uint32 on the JAX side and int64 here.

Weights: the serving engine runs a model, whose parameters the reference
initialises from a JAX key; ``params_from_numpy`` takes that tree as numpy
(``jax.device_get(repro.models.init_params(key, cfg))``, stacked segments
and all) and makes the port's parameters of it; ``opt_state_from_numpy``
does the same for an optimizer state, so both packages can start a train
step from one state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import numpy as np
import torch

from repro_torch.core.dbs import DBSState
from repro_torch.core.slots import SlotRing, SlotTable


def _t(x, device) -> torch.Tensor:
    a = np.array(x, copy=True)          # writable, contiguous, 0-d kept
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(device)


def ring_from_numpy(leaves: Dict[str, Any], device) -> SlotRing:
    return SlotRing(**{k: _t(leaves[k], device)
                       for k in ("ids", "head", "tail")})


def state_from_numpy(leaves: Dict[str, Any], device) -> DBSState:
    """A ``DBSState`` on ``device`` from the reference state's leaves."""
    kw = {f.name: _t(leaves[f.name], device)
          for f in dataclasses.fields(DBSState) if f.name != "free"}
    return DBSState(free=ring_from_numpy(leaves["free"], device), **kw)


def table_from_numpy(leaves: Dict[str, Any], device) -> SlotTable:
    """A ``SlotTable`` on ``device`` from the reference table's leaves."""
    kw = {f.name: _t(leaves[f.name], device)
          for f in dataclasses.fields(SlotTable) if f.name != "ring"}
    return SlotTable(ring=ring_from_numpy(leaves["ring"], device), **kw)


def replicas_from_numpy(states: Sequence[Dict[str, Any]],
                        pools: Sequence[Any], page_revs: Sequence[Any],
                        device):
    """Per-replica (states, pools, page_revs) tuples on ``device``."""
    return (tuple(state_from_numpy(s, device) for s in states),
            tuple(_t(p, device) for p in pools),
            tuple(_t(p, device) for p in page_revs))


def to_numpy(obj) -> Any:
    """The inverse: a port dataclass (``DBSState``, ``SlotTable``,
    ``SlotRing``) or tensor as numpy, named like the reference fields; the
    bitmap comes back as uint32."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = to_numpy(v)
    if isinstance(obj, DBSState):
        out["bitmap"] = out["bitmap"].astype(np.uint32)
    return out


def params_from_numpy(cfg, tree: Any, device) -> Any:
    """The port's model parameters from the reference's parameter tree as
    numpy: the same nested dicts and lists, each leaf a tensor on
    ``device``. Stacked segments stay stacked; ``models.model`` slices them
    per layer as views. ``cfg`` is checked against the tree's layer count."""
    if "segments" in tree:
        from repro_torch.models.blocks import layer_schedule
        schedule = layer_schedule(cfg)
        if len(schedule) != len(tree["segments"]):
            raise ValueError(f"{len(tree['segments'])} segments in the tree, "
                             f"{len(schedule)} in {cfg.name}'s schedule")

    return _tree_from_numpy(tree, device)


def opt_state_from_numpy(tree: Any, device) -> Any:
    """The port's optimizer state from the reference's as numpy
    (``jax.device_get(opt_init(params))`` or a later state): AdamW's
    ``m``/``v``/``count`` or Adafactor's ``slots``/``count``, the same
    nested dicts with a tensor on ``device`` at each leaf (``count`` a 0-d
    int32)."""
    return _tree_from_numpy(tree, device)


def _tree_from_numpy(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_from_numpy(v, device) for v in tree)
    return _t(tree, device)
