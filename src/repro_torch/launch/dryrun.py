"""Multi-pod dry run: count every (arch x shape x mesh) cell per device.

Port of ``repro/launch/dryrun.py``. The reference proves the distribution
plan coherent without hardware by lowering and compiling each cell on 512
placeholder CPU devices and mining XLA's compiled module. A torch program
has no compiled module, so here:

- a fake world (the ``"fake"`` process-group backend over a ``FakeStore``,
  256 or 512 ranks in this one process, this process rank 0) stands in
  for the placeholder devices, and ``launch/mesh.py``
  ``make_production_mesh(..., device="cpu")`` builds the production mesh
  on it; the world is closed when the cell ends, and a run refuses to start
  while any process group is initialised (a dry run must never send its
  collectives to a real group);
- ``launch/specs.py build_cell`` makes the cell's inputs under
  ``FakeTensorMode``: DTensors with the planner's placements and no memory;
- the cell's step runs once under ``utils/op_stats.py``'s counting mode
  (forward, and for ``train`` backward and the in-place optimizer update),
  which counts rank 0's FLOPs, bytes, collectives and kernel entries from
  the ops as they dispatch: ``flops_per_device``, ``bytes_per_device``
  (unfused: what eager PyTorch moves; not XLA's fused "bytes accessed"),
  ``collective_bytes_per_device`` and ``collectives``;
- ``hlo_useful_ratio`` keeps the reference's name for the model FLOPs over
  the counted FLOPs of all chips (counted, not read from HLO);
- the roofline terms divide by ``utils/machine.py``'s peaks: ``t_compute``
  by the peak of the plan's compute dtype (bf16 on the tensor cores, fp32
  off them), ``t_memory`` by HBM, ``t_collective`` by one NVLink; the
  record names the peaks it used and whether they were assumed (no card
  detected).

Not carried over: ``ACCOUNTING_OVERRIDES`` and ``accounting_variants``,
which extrapolate from shallow unrolled compiles because XLA:CPU counts a
scan body once (here every layer runs at full depth, every loop trip is
counted, and nothing needs extrapolating), with them the ``--accounting``
flag; the ``mem_*`` fields (XLA's ``memory_analysis`` has no torch
counterpart here); ``lower_s``/``compile_s``, which become one ``count_s``.

Usage (CPU only, no card needed):
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod --out results/dryrun.json
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape decode_32k \
      --mesh 1,1 --global-batch 8 --plan compute_dtype=float32 [--smoke]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional, Sequence

from repro_torch.configs import (ALL_ARCHS, SHAPES, get_config,
                                 shape_applicable, smoke_config)
from repro_torch.configs.base import (ArchConfig, ShapeSpec, default_plan,
                                      model_flops)
from repro_torch.distributed.planner import batch_axes
from repro_torch.launch.specs import build_cell, local_bytes, per_device_bytes
from repro_torch.utils import machine
from repro_torch.utils.op_stats import OpCounter

PLAN_KEYS = ("microbatches", "remat", "optimizer", "fsdp", "param_dtype",
             "compute_dtype", "logits_chunk", "attn_impl")


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A fake process group of ``n_ranks`` ranks, this process rank 0, for
    the ``with`` block; refuses to open over an initialised group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is initialised: a dry run must "
                           "not send its collectives to a real group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def cell_plan(cfg: ArchConfig, shape: ShapeSpec, mesh_sizes: dict,
              overrides=None):
    """The reference's default plan for a cell on a mesh of
    ``mesh_sizes``, with ``overrides`` (plan field -> value) applied."""
    plan = default_plan(cfg, shape, math.prod(mesh_sizes.values()),
                        data_shards=math.prod(
                            mesh_sizes[a] for a in batch_axes(mesh_sizes)))
    return dataclasses.replace(plan, **overrides) if overrides else plan


def count_step(cell) -> dict:
    """Run ``cell.step`` once under the counting mode; its counts."""
    with OpCounter() as counter:
        cell.step(*cell.args)
    costs = counter.module_costs()
    return {"flops": costs["flops"], "bytes": costs["bytes"],
            "coll": counter.collective_stats(),
            "coll_bytes": costs["collective_bytes"],
            "ops": counter.count_ops()}


def peaks(compute_dtype: str) -> dict:
    """The roofline's peaks for a plan computing in ``compute_dtype``."""
    prof = machine.machine_profile()
    flops = prof.peak_flops if compute_dtype == "bfloat16" else \
        machine.FP32_FLOPS_PER_S * prof.peak_flops / machine.BF16_FLOPS_PER_S
    return {"profile": prof.name, "compute_dtype": compute_dtype,
            "flops_per_s": flops, "hbm_bytes_per_s": prof.hbm_bw,
            "link_bytes_per_s": prof.link_bw, "assumed": prof.assumed}


def roofline(cfg: ArchConfig, cell, counts: dict, n_chips: int) -> dict:
    """The record's counted and roofline fields from one step's counts."""
    toks = cell.tokens_per_step
    useful = model_flops(cfg, toks) if cell.kind == "train" else \
        2.0 * cfg.active_param_count() * toks
    pk = peaks(cell.plan.compute_dtype)
    out = {
        # per-device program costs (rank 0's share)
        "flops_per_device": counts["flops"],
        "bytes_per_device": counts["bytes"],
        "collective_bytes_per_device": counts["coll_bytes"],
        "collectives": counts["coll"],
        "ops": counts["ops"],
        "model_flops_total": useful,
        "hlo_useful_ratio": useful / max(counts["flops"] * n_chips, 1.0),
        # roofline terms (seconds)
        "t_compute": counts["flops"] / pk["flops_per_s"],
        "t_memory": counts["bytes"] / pk["hbm_bytes_per_s"],
        "t_collective": counts["coll_bytes"] / pk["link_bytes_per_s"],
        "peak": pk,
    }
    terms = {"compute": out["t_compute"], "memory": out["t_memory"],
             "collective": out["t_collective"]}
    out["bottleneck"] = max(terms, key=terms.get)
    out["roofline_fraction"] = out["t_compute"] / max(sum(terms.values()),
                                                      1e-30)
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             plan_overrides=None, *, mesh_shape: Optional[Sequence[int]] = None,
             config: Optional[ArchConfig] = None,
             shape: Optional[ShapeSpec] = None) -> dict:
    """One cell's record. ``mesh_shape`` replaces the production mesh
    (axes ``("data", "model")``, or ``("pod", "data", "model")`` for three
    dims); ``config`` and ``shape`` replace the registry's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    cfg = config or get_config(arch)
    shape = shape or SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}
    dims = tuple(mesh_shape) if mesh_shape else \
        ((2, 16, 16) if multi_pod else (16, 16))
    n_chips = math.prod(dims)
    t0 = time.perf_counter()
    with fake_world(n_chips):
        if mesh_shape:
            axes = ("data", "model") if len(dims) == 2 else \
                ("pod", "data", "model")
            mesh = make_mesh(dims, axes, "cpu")
        else:
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        mesh_sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
        plan = cell_plan(cfg, shape, mesh_sizes, plan_overrides)
        with FakeTensorMode(allow_non_fake_inputs=True):
            cell = build_cell(cfg, shape, mesh, plan)
            state = per_device_bytes(mesh, cell.args)
            local = local_bytes(cell.args)
            counts = count_step(cell)
    out = {
        "arch": arch, "shape": shape_name, "mesh": mesh_sizes,
        "chips": n_chips, "kind": cell.kind,
        "global_batch": shape.global_batch, "seq_len": shape.seq_len,
        "tokens_per_step": cell.tokens_per_step,
        "plan": {k: getattr(cell.plan, k) for k in PLAN_KEYS},
        "count_s": time.perf_counter() - t0,
        **roofline(cfg, cell, counts, n_chips),
        "analytic_state_bytes_per_device": state,
        "local_state_bytes": local,
    }
    return out


def _plan_value(text: str):
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return {"true": True, "false": False}.get(text.lower(), text)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="a mesh shape such as 1,1 in place of the "
                         "production mesh")
    ap.add_argument("--global-batch", type=int, default=None,
                    help="cut the shape's global batch")
    ap.add_argument("--plan", action="append", default=[],
                    metavar="KEY=VALUE", help="override a plan field")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config of each arch (a quick check)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = ALL_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    mesh_shape = tuple(int(x) for x in args.mesh.split(",")) \
        if args.mesh else None
    overrides = dict((k, _plan_value(v)) for k, v in
                     (p.split("=", 1) for p in args.plan)) or None
    results = []
    for arch in archs:
        for shape_name in shapes:
            shape = SHAPES[shape_name]
            if args.global_batch:
                shape = dataclasses.replace(shape,
                                            global_batch=args.global_batch)
            for mp in meshes:
                tag = f"{arch}:{shape_name}:{'multi' if mp else 'single'}"
                try:
                    r = run_cell(arch, shape_name, mp, overrides,
                                 mesh_shape=mesh_shape, shape=shape,
                                 config=smoke_config(arch) if args.smoke
                                 else None)
                    r["status"] = "skipped" if "skipped" in r else "ok"
                except Exception as e:  # noqa: BLE001 — record and continue
                    r = {"arch": arch, "shape": shape_name, "multi_pod": mp,
                         "status": "error", "error": f"{type(e).__name__}: {e}",
                         "trace": traceback.format_exc(limit=6)}
                r["multi_pod"] = mp
                results.append(r)
                if r["status"] == "ok":
                    print(f"OK    {tag:54s} count={r['count_s']:7.1f}s "
                          f"bottleneck={r['bottleneck']:10s} "
                          f"roofline={r['roofline_fraction']:.3f}", flush=True)
                elif r["status"] == "skipped":
                    print(f"SKIP  {tag:54s} {r['skipped'][:60]}", flush=True)
                else:
                    print(f"ERROR {tag:54s} {r['error'][:90]}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    n_err = sum(r["status"] == "error" for r in results)
    print(f"cells: {len(results)}  errors: {n_err}")
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
