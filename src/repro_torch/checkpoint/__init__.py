"""Checkpoints on the on-disk DBS: ``CheckpointStore`` (one device file,
a volume a series, a snapshot a version) and ``ReplicatedCheckpoint``
(write-to-all mirrors with the streamed rebuild). Port of
``repro/checkpoint``."""
from repro_torch.checkpoint.replicated import (  # noqa: F401
    ReplicatedCheckpoint)
from repro_torch.checkpoint.store import CheckpointStore  # noqa: F401
