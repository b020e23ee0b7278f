"""The storage-function registry: named in-band compute offloads.

Port of ``repro/compute/registry.py``. A name resolves to a
:class:`StorageFn` record, ``available_storage_fns()`` lists what is known,
and unknown lookups and duplicate registrations raise the same
``ValueError`` shape as the backend, transport and kernel registries.

A storage function runs against the device-resident extent pool inside the
ring step (one COMPUTE request carries the function id and an immediate
argument down; the completion's value and payload lanes carry the scalar
and block-sized result back), or per call on the other backends
(``exec.py``). Each entry has three implementations over one byte spec:

``apply``     the device program, over a ``phase.VolumeView``: tensor code
              on the view's device that reads nothing back to the host.
``host_ref``  a strictly sequential reference; the host-oracle backend
              runs it, and bit-identity with ``apply`` is the gate.
``mirror``    a pure-Python function over a ``bytearray`` shadow of the
              volume, what the property tests check results against.

``apply`` and ``host_ref`` share one signature::

    fn(view, page, block, arg, payload)
        -> (value i32, status i32, out (*S,) f32, do_write bool)

``view`` gives the hole-masked lanes of one volume in page chunks
(``view.chunks(lo, hi)``) or one block (``view.block(page, block)``); the
port never builds a whole-volume lane tensor, where the reference passes a
``(P, page_blocks, *S)`` one. ``page``/``block``/``arg`` are host ints
(for ``scope="range"`` functions ``page`` is the first page and ``block``
the page count; for ``scope="block"`` they address one block) and
``payload`` the request's payload lanes. The results are tensors on the
view's device. A function with ``writes=True`` may return
``do_write=True`` to commit ``payload`` to the addressed block through the
CoW write path (compare-and-write).

``mirror(shadow, page_bytes, block_bytes, page, block, arg, data) ->
(value, status, aux)`` mutates ``shadow`` in place when the device function
would commit a write.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

# Positive completion status: the function ran but its predicate did not
# hold (CAS expectation miss, verify_on_read checksum mismatch). Not an I/O
# error: IOFuture.result() raises only on status < 0. Canonical here;
# core/ring.py imports it (the compute package never imports ring).
ST_MISMATCH = 1

_SCOPES = ("range", "block")


@dataclass(frozen=True)
class StorageFn:
    """One registered storage function (module docstring)."""
    name: str
    apply: Callable        # device program over a VolumeView
    host_ref: Callable     # strictly sequential reference (host oracle)
    mirror: Callable       # pure-Python bytearray-shadow reference
    writes: bool = False   # may commit a CoW write (closes the compute window)
    scope: str = "range"   # "range": (page, count) span; "block": one block


_REGISTRY: Dict[str, StorageFn] = {}
_VERSION: int = 0  # bumped on every (re)registration


def available_storage_fns() -> Tuple[str, ...]:
    """Registered storage-function names, in registration (= fn id) order."""
    return tuple(_REGISTRY)


def _known() -> str:
    return ", ".join(available_storage_fns()) or "<none>"


def register_storage_fn(name: str, *, apply: Callable,
                        host_ref: Optional[Callable] = None,
                        mirror: Optional[Callable] = None,
                        writes: bool = False, scope: str = "range",
                        override: bool = False) -> StorageFn:
    """Register ``name``. ``host_ref`` defaults to ``apply``; ``mirror``
    defaults to None. Duplicate names raise unless ``override=True``."""
    global _VERSION
    if scope not in _SCOPES:
        raise ValueError(f"storage fn scope must be one of {_SCOPES}, "
                         f"got {scope!r}")
    if name in _REGISTRY and not override:
        raise ValueError(f"duplicate storage function {name!r} (registered: "
                         f"{_known()}); pass override=True to replace")
    entry = StorageFn(name=name, apply=apply,
                      host_ref=host_ref if host_ref is not None else apply,
                      mirror=mirror, writes=writes, scope=scope)
    _REGISTRY[name] = entry
    _VERSION += 1
    return entry


def make_storage_fn(name: str) -> StorageFn:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown storage function {name!r} "
                         f"(registered: {_known()})") from None


def storage_fn_id(name: str) -> int:
    """Stable small-int id staged into the request's ``fn`` lane."""
    make_storage_fn(name)  # uniform unknown-name error
    return list(_REGISTRY).index(name)


def fn_writes(fnid: int) -> bool:
    """Whether the function behind ``fnid`` may commit a write (the drain
    closes a batch's compute window on such a function)."""
    fns = list(_REGISTRY.values())
    return fns[fnid].writes if 0 <= fnid < len(fns) else False


def device_table() -> Tuple[StorageFn, ...]:
    """Registration-ordered entries: ``fn`` lane id -> entry."""
    return tuple(_REGISTRY.values())


def registry_version() -> int:
    """Monotonic registration counter (the reference keys its compiled ring
    programs on it; the port's ring counts pumps by it)."""
    return _VERSION
