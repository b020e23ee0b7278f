"""What the examples share: the device, the weights, the printed lines."""
from __future__ import annotations

import time
from typing import List

import torch

from repro_torch.configs import ExecutionPlan
from repro_torch.core.convert import params_from_numpy
from repro_torch.models import init_params


# the serving examples' plan: the engine's default (fp32, no remat) with
# prefill attention through the flash kernel, where the engine's default
# (as the reference's) runs the chunked plain form; decode attends through
# the paged kernel either way. On the CPU both wrappers run their plain
# versions.
SERVE_PLAN = ExecutionPlan(remat="none", attn_impl="cuda",
                           compute_dtype="float32")


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def clock(dev: torch.device) -> float:
    """Seconds on the host's clock once the device's queued work is done."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def weights(cfg, params, dev: torch.device, seed: int = 0):
    """``params`` (the reference's, as numpy) on ``dev``, or the port's
    own draw from a generator seeded with ``seed``."""
    if params is not None:
        return params_from_numpy(cfg, params, dev)
    return init_params(torch.Generator(device=dev).manual_seed(seed), cfg)


class Lines:
    """Prints each line and keeps it."""

    def __init__(self):
        self.lines: List[str] = []

    def __call__(self, *parts) -> None:
        line = " ".join(str(p) for p in parts)
        print(line, flush=True)
        self.lines.extend(line.split("\n"))
