"""Computational storage: in-band storage functions.

Port of ``repro/compute``. A COMPUTE request names a registered storage
function by id; the ring backend runs it against the device-resident
extent pool inside the same step as data and control, so one request
replaces reading every page across the host boundary. registry.py holds
the registry contract, functions.py the five built-ins, phase.py the
ring step's compute phase and the chunked volume view, exec.py the
host-oracle and per-call device executors, and ``Volume.compute``
(core/blockdev.py) the public byte-level surface.
"""
from repro_torch.compute.registry import (ST_MISMATCH,  # noqa: F401
                                          StorageFn, available_storage_fns,
                                          make_storage_fn,
                                          register_storage_fn,
                                          registry_version, storage_fn_id)
from repro_torch.compute import functions  # noqa: F401  (the built-ins)
