"""Elastic-restart demonstration: train on one mesh, lose ranks, resume on
a smaller mesh from the same replicated DBS checkpoint.

Port of ``repro/launch/elastic.py``. Run:

    python -m repro_torch.launch.elastic [--device cpu]
        [--mesh1 4,2] [--mesh2 2,2] [--dir DIR]

Two jobs, one process a rank: phase 1 trains ``smoke_config("granite-3-8b")``
(fp32, remat none) for 4 steps on a (data, model) mesh of ``--mesh1``,
checkpoints parameters and AdamW state to two replicas and exits; phase 2
is a new, smaller world (``--mesh2``) that restores the checkpoint onto
its own mesh with the planner's placements and trains 4 more steps. The
run passes when phase 2's last loss is under phase 1's + 0.2, the
reference's condition. Defaults are the reference's meshes, (4, 2) then
(2, 2); one card runs ``--mesh1 1,1 --mesh2 1,1``.

On the card (the default) each rank takes one card over NCCL, and a mesh
larger than the cards present raises; ``--device cpu`` runs the ranks on
gloo. The parameters and optimizer state live as DTensors placed by the
planner; a step computes on their ``full_tensor()``: each rank takes its
data shard of the global batch (8 x 16 tokens), the gradients and the loss
are averaged over the data axis with ``all_reduce``, every rank applies
the same AdamW update to the full tensors, and the updated leaves are
placed again. The loss is the global batch's mean, as GSPMD computes it
in the reference. Checkpoints go under ``--dir`` (a new temporary
directory by default, removed at the end).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
from typing import Dict, List, Tuple

import numpy as np
import torch

ARCH = "granite-3-8b"
GLOBAL_BATCH, SEQ, STEPS = 8, 16, 4
AXES = ("data", "model")
CAPACITY = 1 << 26


def _mesh_shape(text: str) -> Tuple[int, ...]:
    return tuple(int(n) for n in text.split(","))


def _placements(planner, params):
    """(parameter placements, AdamW state placements) from the planner's
    specs."""
    specs = planner.tree_specs(params)
    return (planner.placements(specs),
            planner.placements(planner.opt_specs(specs, params, "adamw")))


def _full(tree):
    from repro_torch.models.model import tree_map
    return tree_map(lambda t: t.full_tensor(), tree)


def run_steps(mesh, cfg, plan, state, placements, data, n: int
              ) -> Tuple[dict, float]:
    """``n`` AdamW steps on ``state`` ({"params", "opt"} of DTensors),
    each rank on its data shard; returns (the new state, the last global
    loss)."""
    import torch.distributed as dist
    from repro_torch.distributed.planner import distribute
    from repro_torch.models.model import tree_leaves
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.training.train_step import grads_of
    _init, opt_update = make_optimizer("adamw", total_steps=100, warmup=2)
    group = mesh.get_group("data")
    n_data = dist.get_world_size(group)
    d_idx = mesh.get_coordinate()[AXES.index("data")]
    rows = slice(d_idx * GLOBAL_BATCH // n_data,
                 (d_idx + 1) * GLOBAL_BATCH // n_data)
    dev = tree_leaves(state["params"])[0].to_local().device
    loss = None
    for _ in range(n):
        batch = {k: torch.from_numpy(np.asarray(v[rows], np.int64)).to(dev)
                 for k, v in next(data).items()}
        params, opt = _full(state["params"]), _full(state["opt"])
        grads, metrics = grads_of(params, batch, cfg, plan)
        flat = tree_leaves(grads)
        for g in flat:
            dist.all_reduce(g, group=group)
        torch._foreach_div_(flat, float(n_data))
        ce = metrics["loss"].clone()
        dist.all_reduce(ce, group=group)
        with torch.no_grad():
            params, opt, _gnorm = opt_update(grads, opt, params)
        state = {"params": distribute(params, mesh, placements["params"],
                                      src_data_rank=None),
                 "opt": distribute(opt, mesh, placements["opt"],
                                   src_data_rank=None)}
        loss = float(ce) / n_data
    return state, loss


def _stream(skip: int):
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.configs import smoke_config
    it = iter(SyntheticLM(smoke_config(ARCH).vocab_size, GLOBAL_BATCH, SEQ))
    for _ in range(skip):
        next(it)
    return it


def _rank(rank: int, phase: int, shape: Tuple[int, ...], device: str,
          work: str, init: str) -> None:
    """One rank of one phase's world."""
    import torch.distributed as dist
    from repro_torch.checkpoint import ReplicatedCheckpoint
    from repro_torch.configs import ExecutionPlan, smoke_config
    from repro_torch.distributed.planner import Planner, distribute
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.training.optimizer import adamw_init
    world = int(np.prod(shape))
    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=init, world_size=world, rank=rank)
    try:
        mesh = make_mesh(shape, AXES, device)
        dev = (torch.device("cuda", torch.cuda.current_device())
               if device == "cuda" else torch.device(device))
        cfg = smoke_config(ARCH)
        plan = ExecutionPlan(remat="none", compute_dtype="float32")
        planner = Planner(mesh, cfg, plan)
        params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
        opt = adamw_init(params)
        pl, opl = _placements(planner, params)
        placements = {"params": pl, "opt": opl}
        dirs = [os.path.join(work, d) for d in "ab"]
        ck = ReplicatedCheckpoint(dirs, capacity_bytes=CAPACITY, mesh=mesh)
        if phase == 1:
            state = {"params": distribute(params, mesh, pl,
                                          src_data_rank=None),
                     "opt": distribute(opt, mesh, opl, src_data_rank=None)}
            state, loss = run_steps(mesh, cfg, plan, state, placements,
                                    _stream(0), STEPS)
            ck.save("train", STEPS, state)
            out = {"loss": loss, "step": STEPS}
        else:
            step, state = ck.restore("train", like={"params": params,
                                                    "opt": opt},
                                     mesh=mesh, placements=placements)
            state, loss = run_steps(mesh, cfg, plan, state, placements,
                                    _stream(step), STEPS)
            out = {"loss": loss, "step": step + STEPS, "restored": step}
        ck.close()
        if rank == 0:
            with open(os.path.join(work, f"phase{phase}.json"), "w") as f:
                json.dump(dict(out, mesh=list(shape)), f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_phase(phase: int, shape: Tuple[int, ...], device: str,
              work: str) -> Dict:
    """Spawn ``phase``'s world (one process a rank) and wait for it; its
    rank 0's summary."""
    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import local_init_method
    world = int(np.prod(shape))
    if device == "cuda" and world > torch.cuda.device_count():
        raise RuntimeError(f"a {shape} mesh needs {world} CUDA devices; "
                           f"this host has {torch.cuda.device_count()}")
    mp.spawn(_rank, args=(phase, shape, device, work, local_init_method()),
             nprocs=world, join=True)
    with open(os.path.join(work, f"phase{phase}.json")) as f:
        return json.load(f)


def main(argv: List[str] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: NCCL, a card a rank (default); cpu: gloo")
    ap.add_argument("--mesh1", default="4,2", help="phase 1's (data, model)")
    ap.add_argument("--mesh2", default="2,2", help="phase 2's (data, model)")
    ap.add_argument("--dir", default="",
                    help="checkpoint directory (default: a new temporary "
                         "one, removed at the end)")
    args = ap.parse_args(argv)
    mesh1, mesh2 = _mesh_shape(args.mesh1), _mesh_shape(args.mesh2)
    work = args.dir or tempfile.mkdtemp(prefix="elastic-")
    os.makedirs(work, exist_ok=True)
    try:
        print(f"phase 1: mesh {dict(zip(AXES, mesh1))}", flush=True)
        r1 = run_phase(1, mesh1, args.device, work)
        print(f"  loss after {STEPS} steps: {r1['loss']:.4f}; checkpointed "
              f"to 2 replicas", flush=True)
        print(f"phase 2: mesh {dict(zip(AXES, mesh2))} (elastic restart)",
              flush=True)
        r2 = run_phase(2, mesh2, args.device, work)
        print(f"  resumed at step {r2['restored']}, loss after {STEPS} "
              f"more: {r2['loss']:.4f}", flush=True)
    finally:
        if not args.dir:
            shutil.rmtree(work, ignore_errors=True)
    if not r2["loss"] < r1["loss"] + 0.2:
        raise AssertionError(f"loss2 {r2['loss']} >= loss1 {r1['loss']} "
                             f"+ 0.2")
    print("elastic restart OK", flush=True)
    return {"phase1": r1, "phase2": r2}


if __name__ == "__main__":
    main()
