# The engine layers of the port, one module per reference module:
#   slots.py        Messages Array + ID-token channel (paper §IV-C)
#   dbs.py          device-side Direct Block Store (paper §IV-D)
#   transport.py    controller<->replica wire: messages, endpoint, and the
#                   local/device/simnet transports + registry
#   replication.py  write/read policies and the streamed delta rebuild
#   fused.py        the fused engine step (admit -> CoW -> complete)
#   sharded.py      EnginePool: S stacked engine shards, one step a pump
#   ring.py         the SQ/CQ ring protocol, host half (the drain)
#   frontend.py     multi-queue ublk-style admission vs TGT-style baseline
#   control.py      the control-verb dispatch mixin
#   backends.py     the backend registry (loop/slots/fused/sharded/
#                   upstream/host)
#   engine.py       EngineConfig + the Engine façade + upstream baseline
#   blockdev.py     ublk-style public API: VolumeManager/Volume, byte I/O
#   convert.py      engine state to and from the reference, as numpy
from repro_torch.core.blockdev import IOFuture, Volume, VolumeManager  # noqa: F401
from repro_torch.core.engine import (Engine, EngineConfig,  # noqa: F401
                                     UpstreamEngine)
from repro_torch.core.frontend import Request  # noqa: F401
