"""The control-plane verb set shared by the backends.

Port of ``repro/core/control.py``: ``ControlDispatch`` maps the uniform
``control(kind, ...)`` surface of the backend protocol onto the concrete
class's named methods (``snapshot``/``clone``/``unmap``/``delete_volume``,
and ``_control_repl`` for ``fail``/``rebuild``). Dependency-free, so any
backend module can mix it in without an import cycle.
"""
from __future__ import annotations

from typing import Optional

CONTROL_KINDS = ("snapshot", "clone", "unmap", "delete", "fail", "rebuild")


class ControlDispatch:
    """Mixin: the backend protocol's ``control()`` verb dispatch."""

    def control(self, kind: str, *, volume: int = -1, pages=None,
                shard: Optional[int] = None, replica: int = -1):
        """Uniform control-plane dispatch onto the named methods."""
        if kind == "snapshot":
            return self.snapshot(volume)
        if kind == "clone":
            return self.clone(volume)
        if kind == "unmap":
            return self.unmap(volume, pages if pages is not None else [])
        if kind == "delete":
            return self.delete_volume(volume)
        if kind in ("fail", "rebuild"):
            return self._control_repl(kind, shard, replica)
        raise ValueError(f"unknown control op {kind!r} "
                         f"(expected one of {CONTROL_KINDS})")

    def _control_repl(self, kind: str, shard: Optional[int], replica: int):
        raise ValueError(
            f"{type(self).__name__} has no {kind!r} control op")
