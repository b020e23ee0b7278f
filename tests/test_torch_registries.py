"""Port parity: the four extension registries of the port (engine
backends, replica transports, DBS kernels, storage functions) share the
reference's one contract (tests/test_registries.py):

* unknown lookups raise ``ValueError`` naming the registered entries,
* duplicate registration raises ``ValueError`` pointing at
  ``override=True``,
* ``override=True`` replaces the entry in place,

covered by ONE parametrized test per behaviour, plus the built-ins: the
backends, transports and first five storage functions of the JAX
package's registries, and the port's four kernel entries.
"""
import pytest

torch = pytest.importorskip("torch")

import repro_torch.compute.registry as _sfreg  # noqa: E402
import repro_torch.core.backends as _bereg  # noqa: E402
import repro_torch.core.transport as _trreg  # noqa: E402
import repro_torch.kernels.dbs.registry as _krreg  # noqa: E402
from repro_torch.compute import (available_storage_fns,  # noqa: E402
                                 make_storage_fn, register_storage_fn)
from repro_torch.core.backends import (available_backends,  # noqa: E402
                                       make_backend, register_backend)
from repro_torch.core.transport import (available_transports,  # noqa: E402
                                        make_transport, register_transport)
from repro_torch.kernels.dbs import (available_kernels,  # noqa: E402
                                     make_kernel, register_kernel)


def _noop_apply(content, page, block, arg, payload):  # pragma: no cover
    raise AssertionError("parity-test storage fn must never execute")


class _Reg:
    """One registry's uniform surface, plus enough to register (and then
    scrub) a throwaway entry without perturbing the real table."""

    def __init__(self, label, module, register, lookup, available, known):
        self.label = label
        self._dict = module._REGISTRY
        self.register = register
        self.lookup = lookup
        self.available = available
        self.known = known          # a built-in that must be named in errors

    def add(self, name, **kw):
        if self.label == "backend":
            return register_backend(name, lambda cfg: None, **kw)
        if self.label == "transport":
            return register_transport(name, lambda ep, **o: None, **kw)
        if self.label == "kernel":
            return register_kernel(name, write=lambda *a: None,
                                   read=lambda *a: None, **kw)
        return register_storage_fn(name, apply=_noop_apply, **kw)

    def scrub(self, name):
        self._dict.pop(name, None)


REGISTRIES = [
    _Reg("backend", _bereg, register_backend,
         lambda n: make_backend(n, None), available_backends, "ring"),
    _Reg("transport", _trreg, register_transport,
         lambda n: make_transport(n, None), available_transports, "local"),
    _Reg("kernel", _krreg, register_kernel,
         make_kernel, available_kernels, "cuda"),
    _Reg("storage-fn", _sfreg, register_storage_fn,
         make_storage_fn, available_storage_fns, "checksum"),
]
_IDS = [r.label for r in REGISTRIES]


@pytest.mark.parametrize("reg", REGISTRIES, ids=_IDS)
def test_unknown_lookup_raises_naming_registered(reg):
    with pytest.raises(ValueError, match="unknown") as ei:
        reg.lookup("definitely_not_registered")
    msg = str(ei.value)
    assert "definitely_not_registered" in msg
    assert "registered" in msg and reg.known in msg


@pytest.mark.parametrize("reg", REGISTRIES, ids=_IDS)
def test_duplicate_registration_raises_pointing_at_override(reg):
    name = f"_parity_{reg.label.replace('-', '_')}"
    try:
        reg.add(name)
        with pytest.raises(ValueError, match="duplicate") as ei:
            reg.add(name)
        assert "override=True" in str(ei.value)
        # a BUILT-IN duplicate is rejected the same way
        with pytest.raises(ValueError, match="duplicate"):
            reg.add(reg.known)
    finally:
        reg.scrub(name)


@pytest.mark.parametrize("reg", REGISTRIES, ids=_IDS)
def test_override_replaces_in_place(reg):
    name = f"_parity_{reg.label.replace('-', '_')}"
    try:
        reg.add(name)
        before = len(reg.available())
        reg.add(name, override=True)
        assert len(reg.available()) == before
        assert name in reg.available()
    finally:
        reg.scrub(name)


def test_all_four_registries_nonempty_and_disjoint_namespaces():
    """The built-ins every other test relies on are present: the JAX
    package's backends, transports and first five storage functions (in
    its fn-id order), and the port's kernel entries. Other tests in the
    process may register entries of their own, so only the built-ins are
    compared."""
    import repro.compute as jcompute
    import repro.core.backends as jbackends
    import repro.core.transport as jtransport
    backends = {"fused", "host", "loop", "ring", "sharded", "slots",
                "upstream"}
    assert backends <= set(available_backends())
    assert backends <= set(jbackends.available_backends())
    transports = {"local", "device", "simnet"}
    assert transports <= set(available_transports())
    assert transports <= set(jtransport.available_transports())
    assert {"cuda", "torch", "ref", "copy"} <= set(available_kernels())
    assert available_storage_fns()[:5] == (
        "checksum", "scan_count", "filter_pages", "compare_and_write",
        "verify_on_read")
    assert available_storage_fns()[:5] == jcompute.available_storage_fns()[:5]
