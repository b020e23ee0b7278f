"""Trainer: the fault-tolerant training loop.

Port of ``repro/training/trainer.py``:

- periodic checkpoints to a ReplicatedCheckpoint (CoW snapshot per save),
- automatic resume from the newest valid replica version on restart
  (crash/preemption recovery),
- step-deadline accounting: steps slower than ``deadline_factor`` x the
  running median are logged as straggler events (on a real fleet this is
  the signal to evict/replace a slow host; here it drives the metric
  surfaced in tests).

The device is explicit (``device=``, the card by default): the parameters
are drawn there from a ``torch.Generator`` seeded with ``seed``, each batch
is moved there as it is taken from the source, and a step reads back its
metrics once, with the step's time. ``params`` and ``opt_state`` are
public and the step updates them in place.

``params=`` starts from given parameters (a tree like ``init_params``'s,
on the trainer's device) in place of the seeded draw, so a run can start
from another package's weights (``core/convert.py params_from_numpy``).

Two reference faults are corrected:

- the reference's ``_try_resume`` takes any exception for "no checkpoint"
  and starts from step 0, so a checkpoint that does not fit the model
  silently restarts training. Here only "no valid checkpoint"
  (``IOError``) starts fresh; anything else, a structure mismatch for
  one, raises;
- the reference opens a 256 MB store whatever the model, so a model whose
  params and optimizer state pass it (the reference's own
  ``examples/train_lm.py``: 67.7M params, 812 MB with AdamW's moments)
  fails at its first save. Here the store is sized to what it saves
  (``ckpt_capacity``), with the reference's 256 MB as its floor.
"""
from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ReplicatedCheckpoint
from repro_torch.checkpoint.store import BS, EB
from repro_torch.configs.base import ArchConfig, ExecutionPlan
from repro_torch.models import init_params
from repro_torch.models.model import tree_leaves
from repro_torch.training.train_step import make_train_step

CKPT_CAPACITY = 1 << 28          # the reference's store: the floor
CKPT_KEEP = 2                    # versions a save keeps (``keep_last``)


def ckpt_capacity(state) -> int:
    """Bytes of the checkpoint store for ``state`` (a tree of tensors or
    numpy arrays): the ``CKPT_KEEP`` versions a save keeps plus the one it
    writes, since a save writes its version whole beside the kept ones
    (copy-on-write) before it drops the oldest; a version is its leaves,
    each rounded up to whole blocks, its header and manifest, and one
    extent more for the last one it fills in part. At least
    ``CKPT_CAPACITY``, so a small model gets the reference's store."""
    leaves = tree_leaves(state)
    data = sum(-(-t.nbytes // BS) * BS for t in leaves)
    manifest = 256 * len(leaves) + 2 * BS
    version = data + manifest + BS * EB
    return max(CKPT_CAPACITY, (CKPT_KEEP + 1) * version)


class Trainer:
    def __init__(self, cfg: ArchConfig, plan: ExecutionPlan, data: Iterator,
                 *, ckpt_dirs: Optional[List[str]] = None,
                 ckpt_every: int = 50, seed: int = 0,
                 deadline_factor: float = 3.0, device="cuda",
                 params=None, **opt_overrides):
        self.cfg, self.plan = cfg, plan
        self.data = data
        self.ckpt_every = ckpt_every
        self.deadline_factor = deadline_factor
        self.device = torch.device(device)
        opt_init, self.step_fn = make_train_step(cfg, plan, **opt_overrides)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(gen, cfg)
        self.params = params
        self.opt_state = opt_init(self.params)
        self.step = 0
        self.ckpt = (ReplicatedCheckpoint(
            ckpt_dirs, capacity_bytes=ckpt_capacity(self._state()))
            if ckpt_dirs else None)
        self.history: List[Dict[str, float]] = []
        self.straggler_events = 0
        self._durations: List[float] = []
        if self.ckpt is not None:
            self._try_resume()

    # ----------------------------------------------------------- checkpoints
    def _state(self):
        return {"params": self.params, "opt": self.opt_state}

    def _try_resume(self):
        try:
            step, blob = self.ckpt.restore("train", self._state(),
                                           device=self.device)
        except IOError:
            return                                 # fresh start
        self.params, self.opt_state = blob["params"], blob["opt"]
        self.step = step
        print(f"[trainer] resumed from step {step}")

    def _save(self):
        if self.ckpt is not None:
            self.ckpt.save("train", self.step, self._state(),
                           keep_last=CKPT_KEEP)

    # ------------------------------------------------------------------ loop
    def run(self, num_steps: int) -> List[Dict[str, float]]:
        it = iter(self.data)
        target = self.step + num_steps
        while self.step < target:
            batch = {k: torch.from_numpy(np.asarray(v, np.int64)).to(
                self.device) for k, v in next(it).items()}
            t0 = time.time()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            names = list(metrics)
            values = torch.stack([metrics[k].float() for k in names]).tolist()
            metrics = dict(zip(names, values))
            dt = time.time() - t0
            self._durations.append(dt)
            med = float(np.median(self._durations[-20:]))
            if len(self._durations) > 5 and dt > self.deadline_factor * med:
                self.straggler_events += 1
                metrics["straggler"] = 1.0
            metrics["step_time_s"] = dt
            metrics["step"] = self.step
            self.history.append(metrics)
            self.step += 1
            if self.ckpt_every and self.step % self.ckpt_every == 0:
                self._save()
        self._save()
        return self.history
