#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py [--max-pages P]

Run from the root of a checkout on a machine with an NVIDIA GPU (Hopper:
the kernels build for sm_90a with nvcc, at first use, into
build/torch_kernels/). ``--max-pages`` cuts the block device's volume (1 GiB
by default), the one cut a short time limit may force. Float32 matrix
products and convolutions run in full fp32 (TF32 off). Phases, one JSON
line each; any failure raises and the script exits non-zero:

1. env — torch/CUDA versions, the card's name and power limit.
2. build — compile every CUDA source of the port (csrc/*.cu: dbs_rw,
   paged_attention, flash_attention) with one nvcc each, all started
   together; seconds per library.
3. kernel_parity (dbs_rw_write) — at full width (pool (E+1, 32, 4096) f32,
   64 lanes), on write batches from the port's own ``write_pages`` over a
   seeded trace (in-place writes, CoW after a snapshot and a clone,
   duplicate-page groups with colliding blocks, holes, masked lanes): the
   CUDA kernel equals its plain version bit for bit. Times per batch come
   from CUDA graphs of one pass over the batches, median of 20 passes
   (kernel, plain version, and one PyTorch library call as a yardstick the
   port never calls), beside the bound (bytes over 3.35 TB/s, the H100 SXM
   HBM rate).
4. main_path — ``VolumeManager(backend="fused", kernel="cuda")`` with 3
   replicas, 4 KiB blocks, 32-block extent rows and a 1 GiB volume (8192
   pages): a seeded trace of 4 KiB random writes and reads, 128 KiB
   sequential spans, ~10% unaligned writes (read-modify-write), then a
   snapshot, CoW overwrites, a diverging clone, discards (full-page TRIM and
   partial edges) and a delete. Every read is checked against a host shadow;
   the replicas must agree; both kernels must have launched and the plain
   versions never. The read kernel's inputs of every 128th step are kept.
5. kernel_parity (dbs_rw_read) — on the kept main-path inputs and the main
   path's own replica pool: bit for bit against the plain version, timed as
   in phase 3; hole lanes (zeros, no load) count one block in the bound.
6. no_sync — one write pump's fused step under
   ``torch.cuda.set_sync_debug_mode("error")``.
7. serve_path — zero-copy serving at gemma2-2b's full width (26 layers,
   d_model 2304, 8 heads, 4 KV heads, head_dim 256, vocab 256000; fp32
   weights drawn from a seeded ``torch.Generator`` on the card):
   ``ServeEngine(kv_backend="fused", kv_replicas=2, n_slots=8,
   max_len=2048, n_queues=2, kernel="cuda")`` with
   ``ExecutionPlan(attn_impl="cuda", compute_dtype="float32")``, so prefill
   runs the flash-attention kernel and decode the paged-attention kernel
   over the block device's own extent pool (one 104 KiB block per token).
   16 requests with seeded prompt lengths in 100-1000 and 32 new tokens
   each (more requests than slots), then a fork check: a session forked
   after its 4th decode step, and a second engine decoding the same two
   streams independently, must give the same tokens (the largest logit
   difference is printed). Checked: every request ends with 32 tokens, the
   replicas are consistent after a flush (the same metadata revisions and
   the same pool contents bar the dump row), no volume or extent is left
   after the drain, both attention kernels launched and their plain
   versions never. The inputs of a few decode steps and of one prompt's
   local and global prefill layers are kept.
8. kernel_parity (paged_attention, flash_attention) — each kernel against
   its plain version on those kept full-width inputs, over the serve
   path's own pool, within atol 1e-4 and rtol 1e-4; timed with CUDA graphs
   as in phase 3, beside the bound (paged: live K/V pages plus q and the
   output over 3.35 TB/s; flash: the larger of its causal flops over the
   67 TFLOP/s fp32 rate and its bytes over 3.35 TB/s) and one PyTorch
   yardstick labelled with what it differs in.
9. no_sync (serving) — one call of the decode program under
   ``torch.cuda.set_sync_debug_mode("error")``.
10. profile (serving) — where a serving step's time goes, on the same
   engine: eight requests fill the slots; four decode steps are timed,
   four more run under ``torch.profiler``, then a ninth prompt's prefill
   into the slot a finished request freed, and the write pumps that land
   its K/V. One line per part: wall time, the device's busy time and idle
   share, device events, and the operators that took the most time.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power line, and
last ``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
KERNEL_SRC = "src/repro_torch/kernels/dbs/csrc/dbs_rw.cu"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
PAGED_SRC = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
FLASH_SRC = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
SERVE_MODEL, SERVE_REQUESTS, SERVE_NEW = "gemma2-2b", 16, 32
SERVE_PROMPT = (100, 1000)       # prompt lengths drawn in [lo, hi]
SERVE_KEEP_STEPS = (8, 24, 40)   # decode steps whose paged calls are kept
PROFILE_STEPS = 4                # decode steps timed, then profiled
ATTN_TOL = dict(atol=1e-4, rtol=1e-4)
BLOCK, PAGE_BLOCKS, REPLICAS, BATCH = 4096, 32, 3, 64
SEED, N_OPS = 0, 12000           # the trace; N_OPS sets the random-I/O phases
READ_SAMPLE_EVERY, READ_SAMPLES = 128, 32


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def graph_ms(torch, fn, n_items: int, passes: int = 20) -> float:
    """Median device time per item of ``fn()`` (one pass over n_items
    launches), captured once in a CUDA graph so host launch gaps do not
    count; 20 timed replays after a warm-up."""
    fn()                                         # warm-up outside capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(passes):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n_items)
    del g
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 3: the write kernel's parity and timing at full width
# ---------------------------------------------------------------------------
def parity_batches(torch, dbs, route, dev, n_extents, max_pages, rng,
                   n_batches=16):
    """Routed write batches from a seeded write_pages trace on the card:
    holes first, then (after a snapshot and a clone) a mix of CoW pages,
    in-place pages, holes, duplicate (page, block) lanes and masked lanes.
    Returns a list of (src, dst, lane_of, payload, n_live, n_cow)."""
    import numpy as np
    st = dbs.make_state(n_extents, 16, max_pages, device=dev)
    st, _ = dbs.create_volume(st)
    pre, post = set(), set()           # pages of vol 0 before/after snapshot
    out = []
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    for i in range(n_batches):
        if i == 2:
            st, _ = dbs.snapshot(st, 0)
            st, _ = dbs.clone(st, 0)   # volume 1 shares every page of 0
        vols = np.zeros(BATCH, np.int32)
        pages = rng.integers(0, max_pages, BATCH).astype(np.int32)
        if i >= 2:
            kind = rng.integers(0, 3, BATCH)          # 0 CoW, 1 in place, 2 hole
            old, new = sorted(pre), sorted(post)
            for j in range(BATCH):
                if kind[j] == 0 and old:
                    vols[j] = rng.integers(0, 2)
                    pages[j] = old[rng.integers(len(old))]
                elif kind[j] == 1 and new:
                    pages[j] = new[rng.integers(len(new))]
        blocks = rng.integers(0, PAGE_BLOCKS, BATCH).astype(np.int64)
        dup = rng.choice(BATCH, 8, replace=False)     # colliding lanes
        vols[dup[4:]], pages[dup[4:]] = vols[dup[:4]], pages[dup[:4]]
        blocks[dup[6:]] = blocks[dup[4:6]] = blocks[dup[:2]]
        mask = rng.random(BATCH) < 0.9
        tb = torch.from_numpy(blocks).to(dev)
        st, ops = dbs.write_pages(
            st, torch.from_numpy(vols).to(dev), torch.from_numpy(pages).to(dev),
            torch.ones((), dtype=torch.int64, device=dev) << tb,
            torch.from_numpy(mask).to(dev))
        src, dst, lane_of = route(ops, PAGE_BLOCKS, tb, n_extents)
        ok = ops.ok.cpu().numpy()
        for j in np.nonzero(ok & (vols == 0))[0]:
            (pre if i < 2 else post).add(int(pages[j]))
        n_live = int(ok.sum())
        n_cow = int((ops.cow_src >= 0).sum())
        payload = torch.rand((BATCH, BLOCK), generator=gen, device=dev)
        out.append((src, dst, lane_of, payload, n_live, n_cow))
    return out


def phase_write_kernel(torch, args, dev):
    import numpy as np
    from repro_torch.core import dbs
    from repro_torch.kernels.dbs import (dbs_rw_write, dbs_rw_write_ref,
                                         dbs_write_bytes)
    from repro_torch.kernels.dbs.ops import _route_writes
    rng = np.random.default_rng(SEED)
    n_e = args.n_extents
    batches = parity_batches(torch, dbs, _route_writes, dev, n_e,
                             args.max_pages, rng)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pool = torch.rand((n_e + 1, PAGE_BLOCKS, BLOCK), generator=gen,
                      device=dev)
    plain = pool.clone()
    for src, dst, lane_of, pay, _, _ in batches:
        dbs_rw_write(pool, src, dst, lane_of, pay, check_routing=True)
        dbs_rw_write_ref(plain, src, dst, lane_of, pay)
    torch.cuda.synchronize()
    w_err = float((pool - plain).abs().max())
    if not torch.equal(pool, plain):
        raise AssertionError(f"dbs_rw_write differs from its plain version "
                             f"(max abs err {w_err})")
    w_bytes = [dbs_write_bytes(nl, nc, PAGE_BLOCKS, BLOCK, 4)
               for *_, nl, nc in batches]
    # the library yardstick: index_copy_ of the composed live rows, whole
    # 512 KiB rows for every live lane (more bytes than the kernel moves)
    composed = []
    for src, dst, lane_of, pay, _, _ in batches:
        live = (dst != n_e).nonzero().flatten()
        composed.append((dst[live].long(), plain[dst[live].long()].clone()))
    n = len(batches)
    w_ms = graph_ms(torch, lambda: [dbs_rw_write(pool, s, d, lo, p)
                                    for s, d, lo, p, _, _ in batches], n)
    w_plain = graph_ms(torch, lambda: [dbs_rw_write_ref(plain, s, d, lo, p)
                                       for s, d, lo, p, _, _ in batches], n)
    w_lib = graph_ms(torch, lambda: [plain.index_copy_(0, i, v)
                                     for i, v in composed], n)
    del composed
    emit(phase="kernel_parity", kernel="dbs_rw_write",
         pool_shape=list(pool.shape), lanes=BATCH, batches=n,
         live_lanes=[b[4] for b in batches],
         cow_lanes=[b[5] for b in batches], equal=True)
    del pool, plain
    torch.cuda.empty_cache()
    mean_wb = sum(w_bytes) / len(w_bytes)
    return {"name": "dbs_rw_write", "route": "cuda", "source": KERNEL_SRC,
            "replaces": "src/repro/kernels/dbs/rw_kernel.py:42",
            "max_abs_err": w_err, "ms": w_ms, "plain_ms": w_plain,
            "bound_ms": mean_wb / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": w_lib, "bytes_per_batch": mean_wb}


# ---------------------------------------------------------------------------
# phase 5: the read kernel on the main path's own inputs
# ---------------------------------------------------------------------------
def phase_read_kernel(torch, mgr, reads):
    """Parity and timing of dbs_rw_read on the (ext, block) batches kept
    from the main path, over replica 0's pool (all replicas agree). A hole
    lane stores one zero block and loads nothing, so the bound counts it at
    one block; a mapped lane reads and writes one."""
    from repro_torch.kernels.dbs import (dbs_read_bytes, dbs_rw_read,
                                         dbs_rw_read_ref)
    if not reads:
        raise AssertionError("no read-kernel inputs were kept")
    pool0 = mgr.engine.backend.replicas[0].pool
    pool = pool0.view(pool0.shape[0], PAGE_BLOCKS, -1)
    r_err = 0.0
    holes = []
    for ext, blk in reads:
        got, want = dbs_rw_read(pool, ext, blk), dbs_rw_read_ref(pool, ext, blk)
        r_err = max(r_err, float((got - want).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError("dbs_rw_read differs from its plain version")
        holes.append(int((ext < 0).sum()))
    n = len(reads)
    flat = pool.view(-1, BLOCK)
    idx = [(ext.clamp(min=0).long() * PAGE_BLOCKS + blk.long())
           for ext, blk in reads]
    r_ms = graph_ms(torch, lambda: [dbs_rw_read(pool, e, b)
                                    for e, b in reads], n)
    r_plain = graph_ms(torch, lambda: [dbs_rw_read_ref(pool, e, b)
                                       for e, b in reads], n)
    r_lib = graph_ms(torch, lambda: [flat.index_select(0, i) for i in idx], n)
    r_bytes = [dbs_read_bytes(BATCH - h, BLOCK, 4) + h * BLOCK * 4
               for h in holes]
    emit(phase="kernel_parity", kernel="dbs_rw_read",
         pool_shape=list(pool.shape), lanes=BATCH, batches=n,
         hole_lanes=holes, hole_share=sum(holes) / (n * BATCH), equal=True)
    mean_rb = sum(r_bytes) / n
    return {"name": "dbs_rw_read", "route": "cuda", "source": KERNEL_SRC,
            "replaces": "src/repro/kernels/dbs/rw_kernel.py:78",
            "max_abs_err": r_err, "ms": r_ms, "plain_ms": r_plain,
            "bound_ms": mean_rb / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": r_lib, "bytes_per_batch": mean_rb}


# ---------------------------------------------------------------------------
# phase 4: the main path at full size
# ---------------------------------------------------------------------------
class Shadow:
    """Host shadow of every written 4 KiB block (holes read as zeros)."""

    def __init__(self):
        self.blocks = {}            # (vid, abs block) -> bytes

    def write(self, vid, off, data):
        first, last = off // BLOCK, (off + len(data) - 1) // BLOCK
        for ab in range(first, last + 1):
            cur = bytearray(self.blocks.get((vid, ab), bytes(BLOCK)))
            lo, hi = max(off, ab * BLOCK), min(off + len(data), (ab + 1) * BLOCK)
            cur[lo - ab * BLOCK:hi - ab * BLOCK] = data[lo - off:hi - off]
            self.blocks[(vid, ab)] = bytes(cur)

    def read(self, vid, off, n):
        first, last = off // BLOCK, (off + n - 1) // BLOCK
        buf = b"".join(self.blocks.get((vid, ab), bytes(BLOCK))
                       for ab in range(first, last + 1))
        return buf[off - first * BLOCK:off - first * BLOCK + n]

    def clone(self, src, dst):
        for (vid, ab), v in list(self.blocks.items()):
            if vid == src:
                self.blocks[(dst, ab)] = v

    def drop(self, vid):
        for key in [k for k in self.blocks if k[0] == vid]:
            del self.blocks[key]


def phase_main(torch, args, dev, smi):
    import numpy as np
    from repro_torch.core import slots
    from repro_torch.core.blockdev import VolumeManager
    from repro_torch.kernels.dbs import rw_kernel
    from repro_torch.core import backends
    from repro_torch.kernels.dbs import ops
    rng = np.random.default_rng(SEED + 1)
    torch.cuda.reset_peak_memory_stats()
    mgr = VolumeManager(
        backend="fused", device=dev, kernel="cuda", n_replicas=REPLICAS,
        payload_elems=BLOCK, page_blocks=PAGE_BLOCKS,
        max_pages=args.max_pages, n_extents=args.n_extents, max_volumes=16,
        batch=BATCH, n_slots=256, n_queues=4)
    # count the fused steps by kind, and keep the read kernel's inputs of
    # every READ_SAMPLE_EVERY-th step for phase 5
    steps = {"write": 0, "read_only": 0}
    reads = []
    inner = {"fused_step": backends.fused_step,
             "fused_step_read": backends.fused_step_read,
             "dbs_rw_read": ops.dbs_rw_read}

    def write_step(*a, **k):
        steps["write"] += 1
        return inner["fused_step"](*a, **k)

    def read_step(*a, **k):
        steps["read_only"] += 1
        return inner["fused_step_read"](*a, **k)

    def read_kernel(pool, ext, block):
        if (sum(steps.values()) % READ_SAMPLE_EVERY == 1
                and len(reads) < READ_SAMPLES):
            reads.append((ext.clone(), block.clone()))
        return inner["dbs_rw_read"](pool, ext, block)
    backends.fused_step, backends.fused_step_read = write_step, read_step
    ops.dbs_rw_read = read_kernel
    shadow = Shadow()
    cap = mgr.capacity
    n_blocks = cap // BLOCK
    stats = {"ops": 0, "bytes": 0, "reads_checked": 0, "rmw_writes": 0}
    checks = []                       # (future, expected bytes)
    harness = [0.0]                   # seconds spent making and checking data

    def off_clock(fn, *a):
        """Run ``fn(*a)`` and book its time as the harness's own."""
        t = time.perf_counter()
        out = fn(*a)
        harness[0] += time.perf_counter() - t
        return out

    def rand_bytes(n):
        return off_clock(
            lambda: rng.integers(0, 256, n, dtype=np.uint8).tobytes())

    def write(vol, off, data):
        vol.pwrite(off, data)
        off_clock(shadow.write, vol.vid, off, data)
        stats["ops"] += 1
        stats["bytes"] += len(data)
        if off % BLOCK or len(data) % BLOCK:
            stats["rmw_writes"] += 1

    def read(vol, off, n):
        fut = vol.pread(off, n)
        checks.append((fut, off_clock(shadow.read, vol.vid, off, n)))
        stats["ops"] += 1
        stats["bytes"] += n

    def settle():
        for fut, want in checks:
            if off_clock(lambda got: got != want, fut.result()):
                raise AssertionError("a read returned the wrong bytes")
        stats["reads_checked"] += len(checks)
        checks.clear()

    def random_io(vols, n_ops, hot=None):
        for _ in range(n_ops):
            vol = vols[rng.integers(len(vols))]
            r = rng.random()
            if hot and rng.random() < 0.7:
                ab = hot[rng.integers(len(hot))]
            else:
                ab = int(rng.integers(n_blocks))
            if r < 0.10:                             # unaligned: RMW path
                off = ab * BLOCK + int(rng.integers(1, BLOCK))
                n = int(rng.integers(1, 2 * BLOCK))
                write(vol, off, rand_bytes(min(n, cap - off)))
            elif r < 0.55:
                write(vol, ab * BLOCK, rand_bytes(BLOCK))
                if hot is not None and len(hot) < 4096:
                    hot.append(ab)
            else:
                read(vol, ab * BLOCK, BLOCK)

    n = N_OPS
    rw_kernel.reset_counts()
    t0 = time.perf_counter()
    v0 = mgr.create()
    hot = []
    random_io([v0], n // 2, hot)                     # 4 KiB random I/O
    page_bytes = mgr.page_bytes
    for _ in range(128):                             # 128 KiB sequential
        p = int(rng.integers(args.max_pages - 4))
        for k in range(4):
            write(v0, (p + k) * page_bytes, rand_bytes(page_bytes))
        read(v0, p * page_bytes, 4 * page_bytes)
    settle()
    v0.snapshot()
    random_io([v0], n // 6, hot)                     # CoW overwrites
    clone = v0.clone()
    off_clock(shadow.clone, v0.vid, clone.vid)
    random_io([v0, clone], n // 6, hot)              # the clone diverges
    settle()
    for vol in (v0, clone):                          # discard: TRIM + edges
        for _ in range(4):
            p = int(rng.integers(args.max_pages - 4))
            off = p * page_bytes + int(rng.integers(1, page_bytes))
            nb = 2 * page_bytes + int(rng.integers(1, page_bytes))
            vol.discard(off, nb)
            off_clock(shadow.write, vol.vid, off, bytes(nb))
            stats["ops"] += 1
            read(vol, off - 100, nb + 200)
    settle()
    for vol in (v0, clone):                          # every written block
        for ab in off_clock(lambda: [ab for (vid, ab) in shadow.blocks
                                     if vid == vol.vid]):
            read(vol, ab * BLOCK, BLOCK)
    for _ in range(256):                             # and some holes
        read(v0, int(rng.integers(n_blocks)) * BLOCK, BLOCK)
    settle()
    clone.delete()
    off_clock(shadow.drop, clone.vid)
    random_io([v0], n // 6, hot)
    settle()
    mgr.flush()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(rw_kernel.LAUNCHES)
    plain = dict(rw_kernel.PLAIN_CALLS)
    backends.fused_step = inner["fused_step"]
    backends.fused_step_read = inner["fused_step_read"]
    ops.dbs_rw_read = inner["dbs_rw_read"]
    n_steps = steps["write"] + steps["read_only"]
    if launches["dbs_rw_read"] != n_steps:
        raise AssertionError(f"{launches['dbs_rw_read']} read launches "
                             f"over {n_steps} fused steps")
    group = mgr.engine.backend
    if not group.consistent():
        raise AssertionError("replicas disagree on the metadata revision")
    st0 = group.replicas[0].state
    rows = torch.unique(st0.table[st0.table >= 0]).long()
    for r in group.replicas[1:]:
        if not torch.equal(r.state.table, st0.table):
            raise AssertionError("replica extent maps differ")
        for i in range(0, rows.numel(), 1024):
            part = rows[i:i + 1024]
            if not torch.equal(r.pool[part], group.replicas[0].pool[part]):
                raise AssertionError("replica pools differ on mapped rows")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the card: {plain}")
    if int(slots.n_active(mgr.engine.frontend.table)) != 0:
        raise AssertionError("slots leaked")
    emit(phase="main_path", config=dict(
        backend="fused", kernel="cuda", n_replicas=REPLICAS,
        payload_elems=BLOCK, page_blocks=PAGE_BLOCKS,
        max_pages=args.max_pages, n_extents=args.n_extents, max_volumes=16,
        batch=BATCH, n_slots=256, n_queues=4),
        volume_bytes=cap, ops=stats["ops"], rmw_writes=stats["rmw_writes"],
        reads_checked=stats["reads_checked"], bytes=stats["bytes"],
        seconds=seconds, harness_seconds=harness[0],
        ops_per_s=stats["ops"] / seconds,
        mib_per_s=stats["bytes"] / seconds / 2 ** 20,
        engine_ops_per_s=stats["ops"] / (seconds - harness[0]),
        write_steps=steps["write"], read_only_steps=steps["read_only"],
        ops_per_step=stats["ops"] / n_steps, launches=launches,
        plain_calls=plain, mapped_rows=int(rows.numel()),
        max_memory_allocated=torch.cuda.max_memory_allocated(dev),
        card=smi)
    return mgr, launches, n_steps, reads


# ---------------------------------------------------------------------------
# phase 6: the fused step never waits on the host
# ---------------------------------------------------------------------------
def phase_no_sync(torch, mgr):
    from repro_torch.core import backends
    inner = backends.fused_step
    calls = []

    def guarded(*a, **k):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = inner(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        calls.append(1)
        return out

    backends.fused_step = guarded
    try:
        vol = mgr.open(0)
        futs = [vol.pwrite(i * 7 * BLOCK, bytes([i]) * BLOCK)
                for i in range(BATCH)]
        mgr.pump()
    finally:
        backends.fused_step = inner
    if not calls or not all(f.done() for f in futs):
        raise AssertionError("the guarded write pump did not run")
    emit(phase="no_sync", guarded_steps=len(calls), lanes=BATCH)


# ---------------------------------------------------------------------------
# phase 7: zero-copy serving at gemma2-2b's full width
# ---------------------------------------------------------------------------
def _serve_engine(torch, cfg, params, dev, record_logits=False):
    from repro_torch.configs.base import ExecutionPlan
    from repro_torch.serving.engine import ServeEngine
    return ServeEngine(cfg, params, n_slots=8, max_len=2048, n_queues=2,
                       kv_backend="fused", kv_replicas=2, kernel="cuda",
                       plan=ExecutionPlan(attn_impl="cuda",
                                          compute_dtype="float32"),
                       record_logits=record_logits, device=dev)


def phase_serve(torch, dev, smi):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import backends, dbs
    from repro_torch.kernels.dbs import rw_kernel
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.models import init_params
    from repro_torch.serving import engine as serving
    from repro_torch.serving.engine import GenRequest
    cfg = get_config(SERVE_MODEL)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = _serve_engine(torch, cfg, params, dev)
    rng = np.random.default_rng(SEED + 2)
    lens = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]

    # instrumentation: time the prefill, the write pumps and the decode
    # program; count fused steps; keep kernel inputs for phase 8
    clock = {"prefill": 0.0, "pumps": 0.0, "decode": 0.0}
    counts = {"fused_steps": 0, "decode_steps": 0}
    kept = {"paged": [], "flash": []}
    inner = {"prefill": eng._prefill_one_zero, "pump": eng._pump_writes,
             "step": eng._step_fn, "fused": backends.fused_step,
             "paged": serving.paged_attention_pool_fwd,
             "flash": f_ops.flash_attention_fwd}

    def timed(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            clock[name] += time.perf_counter() - t
            return out
        return run

    def step_fn(*a, **k):
        counts["decode_steps"] += 1
        return inner["step"](*a, **k)

    def fused(*a, **k):
        counts["fused_steps"] += 1
        return inner["fused"](*a, **k)

    def paged(q, pool, table, lengths, **k):
        if counts["decode_steps"] in SERVE_KEEP_STEPS:
            kept["paged"].append((q.clone(), table.clone(), lengths.clone(),
                                  dict(k)))
        return inner["paged"](q, pool, table, lengths, **k)

    def flash(q, k, v, **kw):
        if len(kept["flash"]) < 2 and (
                not kept["flash"] or kw["window"] != kept["flash"][0][3][
                    "window"]):
            kept["flash"].append((q.clone(), k.clone(), v.clone(), dict(kw)))
        return inner["flash"](q, k, v, **kw)

    eng._prefill_one_zero = timed("prefill", inner["prefill"])
    eng._pump_writes = timed("pumps", inner["pump"])
    eng._step_fn = timed("decode", step_fn)
    backends.fused_step = fused
    serving.paged_attention_pool_fwd = paged
    f_ops.flash_attention_fwd = flash
    for mod in (rw_kernel, pk, fk):
        mod.reset_counts()
    try:
        t0 = time.perf_counter()
        for rid, pr in enumerate(prompts):
            eng.submit(GenRequest(req_id=rid, prompt=pr, max_new=SERVE_NEW))
        outs = eng.run(max_steps=10 * SERVE_NEW * SERVE_REQUESTS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        traffic_counts = dict(counts)
        traffic_clock = dict(clock)
        traffic_launches = {**rw_kernel.LAUNCHES, **pk.LAUNCHES,
                            **fk.LAUNCHES}
        # fork check: a session forked after its 4th decode step against a
        # second engine decoding the same two streams independently
        fork = phase_fork_check(torch, cfg, params, dev, eng, prompts[0])
    finally:
        backends.fused_step = inner["fused"]
        serving.paged_attention_pool_fwd = inner["paged"]
        f_ops.flash_attention_fwd = inner["flash"]
        eng._prefill_one_zero = inner["prefill"]
        eng._pump_writes = inner["pump"]
        eng._step_fn = inner["step"]
    launches = {**rw_kernel.LAUNCHES, **pk.LAUNCHES, **fk.LAUNCHES}
    plain = {**rw_kernel.PLAIN_CALLS, **pk.PLAIN_CALLS, **fk.PLAIN_CALLS}
    peak = torch.cuda.max_memory_allocated(dev)
    bad = [rid for rid in range(SERVE_REQUESTS)
           if len(outs.get(rid, [])) != SERVE_NEW]
    if bad:
        raise AssertionError(f"requests {bad} did not end with "
                             f"{SERVE_NEW} tokens")
    eng.volumes.flush()
    if not eng.volumes.engine.backend.consistent():
        raise AssertionError("the KV replicas disagree after a flush")
    # the decode program scatters into every replica's pool in place: their
    # contents must agree too, bar the dump row (inactive lanes scatter
    # there in no fixed order, and nothing reads it)
    pools = eng.volumes.device_pools()
    if not all(torch.equal(pools[0][:-1], p[:-1]) for p in pools[1:]):
        raise AssertionError("the KV replica pools' contents differ")
    del pools
    st = dbs.stats(eng.state)
    if st["volumes"] or st["extents_used"]:
        raise AssertionError(f"volumes or extents leaked: {st}")
    if min(traffic_launches.values()) <= 0:
        raise AssertionError(f"a kernel of the serve path never launched: "
                             f"{traffic_launches}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the card: {plain}")
    gen_tokens = SERVE_REQUESTS * SERVE_NEW
    emit(phase="serve_path", model=SERVE_MODEL, config=dict(
        kv_backend="fused", kv_replicas=2, n_slots=8, max_len=2048,
        n_queues=2, kernel="cuda", attn_impl="cuda", dtype="float32",
        page_blocks=cfg.page_blocks,
        payload_shape=list(eng._payload_shape)),
        requests=SERVE_REQUESTS, prompt_tokens=int(lens.sum()),
        prompt_lengths=[int(x) for x in lens],
        generated_tokens=gen_tokens, init_seconds=init_s,
        run_seconds=run_s, prefill_seconds=traffic_clock["prefill"],
        pump_seconds=traffic_clock["pumps"],
        decode_seconds=traffic_clock["decode"],
        decode_steps=traffic_counts["decode_steps"],
        decode_tokens_per_s=gen_tokens / traffic_clock["decode"],
        tokens_per_s=gen_tokens / run_s,
        pumps=traffic_counts["fused_steps"], launches=traffic_launches,
        launches_with_fork_check=launches, plain_calls=plain, dbs_stats=st,
        fork=fork, max_memory_allocated=peak,
        memory_allocated_before=held_before, card=smi)
    return eng, kept, traffic_launches, traffic_counts


def phase_fork_check(torch, cfg, params, dev, eng, prompt):
    """Fork a session after its 4th decode step (both sides diverge by CoW
    of the shared frontier page); a second engine decodes the same two
    streams independently. Tokens must be equal; returns the largest logit
    difference (parent, child) for the record."""
    import numpy as np
    from repro_torch.serving.engine import GenRequest
    eng.record_logits = True
    base = 1000
    eng.submit(GenRequest(req_id=base, prompt=prompt.copy(),
                          max_new=SERVE_NEW))
    for _ in range(4):
        eng.step()
    child = eng.fork(base, base + 1, max_new=SERVE_NEW - 4)
    if child is None:
        raise AssertionError("fork found no free slot or volume")
    eng.run(max_steps=4 * SERVE_NEW)
    eng.record_logits = False
    ref = _serve_engine(torch, cfg, params, dev, record_logits=True)
    for rid in (0, 1):
        ref.submit(GenRequest(req_id=rid, prompt=prompt.copy(),
                              max_new=SERVE_NEW))
    ref.run(max_steps=4 * SERVE_NEW)
    par, chi = eng.live[base], eng.live[base + 1]
    if par.out_tokens != ref.live[0].out_tokens:
        raise AssertionError("the forked parent's tokens differ from an "
                             "independent decode")
    if chi.out_tokens != ref.live[1].out_tokens[:len(chi.out_tokens)]:
        raise AssertionError("the fork's tokens differ from an independent "
                             "decode")
    n_c = len(chi.logit_trace)
    d_par = float(np.abs(np.stack(par.logit_trace[4:])
                         - np.stack(ref.live[0].logit_trace[4:])).max())
    d_chi = float(np.abs(np.stack(chi.logit_trace)
                         - np.stack(ref.live[1].logit_trace[4:4 + n_c])).max())
    ref.volumes.close()
    del ref
    torch.cuda.empty_cache()
    return {"tokens_equal": True, "parent_tokens": len(par.out_tokens),
            "child_tokens": len(chi.out_tokens),
            "max_logit_diff_parent": d_par, "max_logit_diff_child": d_chi}


# ---------------------------------------------------------------------------
# phase 8: the attention kernels on the serve path's kept inputs
# ---------------------------------------------------------------------------
def _paged_live_pages(torch, table, lengths, page, window) -> int:
    """Pages the kernel reads: started below the length, not a hole, and
    (with a window) reaching into it — the data-dependent work."""
    base = torch.arange(table.shape[1], device=table.device)[None, :] * page
    run = (base < lengths[:, None]) & (table >= 0)
    if window:
        run &= (base + page - 1) > (lengths[:, None] - 1 - window)
    return int(run.sum())


def phase_paged_kernel(torch, eng, kept):
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import (paged_attention_pool_fwd,
                                                     paged_attention_pool_ref)
    calls = kept["paged"]
    if not calls:
        raise AssertionError("no paged-attention inputs were kept")
    pool = eng._pools[0]
    _e, page, _np_, kv, d = pool.shape
    err, n_bytes = 0.0, []
    for q, table, lengths, kw in calls:
        got = paged_attention_pool_fwd(q, pool, table, lengths, **kw)
        want = paged_attention_pool_ref(q, pool, table, lengths, **kw)
        torch.testing.assert_close(got, want, **ATTN_TOL)
        err = max(err, float((got - want).abs().max()))
        live = _paged_live_pages(torch, table, lengths, page,
                                 kw["window"])
        n_bytes.append(2 * live * page * kv * d * 4 + 2 * q.numel() * 4
                       + (table.numel() + lengths.numel()) * 4)
    n = len(calls)
    ms = graph_ms(torch, lambda: [paged_attention_pool_fwd(q, pool, t, ln, **k)
                                  for q, t, ln, k in calls], n)
    plain = graph_ms(torch, lambda: [
        paged_attention_pool_ref(q, pool, t, ln, **k)
        for q, t, ln, k in calls], n)
    # yardstick: index_select gathers of the K and V planes, then SDPA with
    # a boolean mask (holes, lengths; no logit cap, which SDPA cannot apply)
    lib_in = []
    for q, table, lengths, kw in calls:
        b, h, _ = q.shape
        p_max = table.shape[1]
        pos = torch.arange(p_max * page, device=q.device)
        valid = (pos[None, :] < lengths[:, None]) & (
            table >= 0).repeat_interleave(page, dim=1)
        idx = table.clamp(min=0).reshape(-1).long()
        lib_in.append((q[:, :, None, :], idx, valid[:, None, None, :], b,
                       p_max, kw["k_plane"], kw["v_plane"]))

    def library():
        for q4, idx, mask, b, p_max, kp, vp in lib_in:
            kk = pool[:, :, kp].index_select(0, idx).reshape(
                b, p_max * page, kv, d).transpose(1, 2)
            vv = pool[:, :, vp].index_select(0, idx).reshape(
                b, p_max * page, kv, d).transpose(1, 2)
            F.scaled_dot_product_attention(q4, kk, vv, attn_mask=mask,
                                           enable_gqa=True)
    lib = graph_ms(torch, library, n)
    mean_b = sum(n_bytes) / n
    emit(phase="kernel_parity", kernel="paged_attention", calls=n,
         pool_shape=list(pool.shape), q_shape=list(calls[0][0].shape),
         table_shape=list(calls[0][1].shape), max_abs_err=err,
         bytes_per_call=mean_b, tolerance=ATTN_TOL)
    return {"name": "paged_attention", "route": "cuda", "source": PAGED_SRC,
            "replaces": "src/repro/kernels/paged_attention/kernel.py:96",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": mean_b / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": lib,
            "library_call": "two index_select gathers (K and V planes) + "
                            "scaled_dot_product_attention with a boolean "
                            "mask, no logit cap",
            "bytes_per_call": mean_b}


def phase_flash_kernel(torch, kept):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_fwd)
    calls = kept["flash"]
    if len(calls) < 2:
        raise AssertionError("the local and global prefill inputs were not "
                             "both kept")
    err, flops, n_bytes, bounds = 0.0, [], [], []
    for q, k, v, kw in calls:
        got = flash_attention_fwd(q, k, v, **kw)
        want = attention_ref(q, k, v, **kw)
        torch.testing.assert_close(got, want, **ATTN_TOL)
        err = max(err, float((got - want).abs().max()))
        b, h, sq, d = q.shape
        sk = k.shape[2]
        qp = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kp = torch.arange(sk, device=q.device)[None, :]
        vis = kp <= qp
        if kw["window"]:
            vis &= kp > qp - kw["window"]
        f = 4.0 * d * h * b * int(vis.sum())       # QK^T and PV, 2 flops/MAC
        nb = (2 * q.numel() + k.numel() + v.numel()) * 4
        flops.append(f)
        n_bytes.append(nb)
        bounds.append(max(f / FP32_FLOPS_PER_S, nb / HBM_BYTES_PER_S))
    n = len(calls)
    ms = graph_ms(torch, lambda: [flash_attention_fwd(q, k, v, **kw)
                                  for q, k, v, kw in calls], n)
    plain = graph_ms(torch, lambda: [attention_ref(q, k, v, **kw)
                                     for q, k, v, kw in calls], n)
    cont = [(q.contiguous(), k.contiguous(), v.contiguous())
            for q, k, v, _ in calls]
    lib = graph_ms(torch, lambda: [F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True) for q, k, v in cont], n)
    f_mean, b_mean = sum(flops) / n, sum(n_bytes) / n
    bound = sum(bounds) / n
    emit(phase="kernel_parity", kernel="flash_attention", calls=n,
         q_shapes=[list(c[0].shape) for c in calls],
         windows=[c[3]["window"] for c in calls], max_abs_err=err,
         flops_per_call=f_mean, bytes_per_call=b_mean, tolerance=ATTN_TOL)
    return {"name": "flash_attention", "route": "cuda", "source": FLASH_SRC,
            "replaces": "src/repro/kernels/flash_attention/kernel.py:77",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound * 1e3,
            "bound_by": ("operations" if f_mean / FP32_FLOPS_PER_S
                         >= b_mean / HBM_BYTES_PER_S else "bytes"),
            "library_ms": lib,
            "library_call": "scaled_dot_product_attention(is_causal=True, "
                            "enable_gqa=True), fp32, without the logit cap",
            "flops_per_call": f_mean}


# ---------------------------------------------------------------------------
# phase 9: the decode program never waits on the host
# ---------------------------------------------------------------------------
def phase_no_sync_serve(torch, eng):
    import numpy as np
    from repro_torch.serving.engine import GenRequest
    inner = eng._step_fn
    calls = []

    def guarded(*a, **k):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = inner(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        calls.append(1)
        return out

    eng._step_fn = guarded
    try:
        rng = np.random.default_rng(SEED + 3)
        eng.submit(GenRequest(req_id=2000, prompt=rng.integers(
            0, eng.cfg.vocab_size, 40), max_new=2))
        eng.run(max_steps=8)
    finally:
        eng._step_fn = inner
    if not calls or not eng.live[2000].done:
        raise AssertionError("the guarded decode program did not run")
    emit(phase="no_sync", path="serve_path", guarded_decode_steps=len(calls))


# ---------------------------------------------------------------------------
# phase 10: where a serving step's time goes
# ---------------------------------------------------------------------------
def _profiled(torch, name: str, fn, smi) -> None:
    """Run ``fn`` once under ``torch.profiler`` and emit its wall time, the
    device's busy time (the union of the kernels' intervals), its idle
    share, the device events counted, and the operators that took the most
    device and host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    busy /= 1e6                                  # us -> s

    def top(key, n):
        return [{"op": e.key[:80], "calls": e.count,
                 "self_device_ms": e.self_device_time_total / 1e3,
                 "self_host_ms": e.self_cpu_time_total / 1e3}
                for e in sorted(prof.key_averages(),
                                key=lambda e: -getattr(e, key))[:n]]
    emit(phase="profile", part=name, wall_s=wall, device_busy_s=busy,
         device_idle_share=1.0 - busy / wall, device_events=len(spans),
         top_device=top("self_device_time_total", 10),
         top_host=top("self_cpu_time_total", 6), card=smi)


def phase_profile_serve(torch, eng, smi):
    """Eight requests fill the slots. After two warm-up steps (admission and
    prefill ride the first), time PROFILE_STEPS decode steps, then profile
    PROFILE_STEPS more; the shortest request ends on the last of them. Then
    profile a ninth prompt's prefill into the slot it freed, and the write
    pumps that land that prompt's K/V; the engine then drains."""
    import numpy as np
    from repro_torch.core import dbs
    from repro_torch.serving.engine import GenRequest
    rng = np.random.default_rng(SEED + 4)
    lens = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, eng.n_slots + 1)
    prompts = [rng.integers(0, eng.cfg.vocab_size, n) for n in lens]
    done_at = 2 + 2 * PROFILE_STEPS
    for i in range(eng.n_slots):
        eng.submit(GenRequest(req_id=3000 + i, prompt=prompts[i],
                              max_new=done_at + (i > 0)))
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        eng.step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t) / PROFILE_STEPS
    emit(phase="profile", part="decode, unprofiled", slots=eng.n_slots,
         steps=PROFILE_STEPS, decode_step_s=step_s, card=smi)
    _profiled(torch, f"decode x{PROFILE_STEPS}",
              lambda: [eng.step() for _ in range(PROFILE_STEPS)], smi)
    g = GenRequest(req_id=3100, prompt=prompts[-1], max_new=1)
    eng.submit(g)
    admitted = eng._admit()
    if len(admitted) != 1 or admitted[0] is not g:
        raise AssertionError("the profiled prompt found no free slot")
    _profiled(torch, f"prefill ({len(g.prompt)} tokens, model + payload)",
              lambda: eng._prefill_one_zero(g), smi)
    kib = 4 * math.prod(eng._payload_shape) / 1024
    _profiled(torch, f"write pumps ({len(g.prompt)} lanes of {kib:g} KiB)",
              eng._pump_writes, smi)
    eng.run(max_steps=4)
    st = dbs.stats(eng.state)
    if not all(r.done for r in eng.live.values()) or st["volumes"]:
        raise AssertionError(f"the profiled requests did not drain: {st}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--max-pages", type=int, default=8192,
                    help="volume size in 128 KiB pages (1 GiB by default)")
    args = ap.parse_args()
    args.n_extents = args.max_pages * 3 // 2    # room for CoW and clones
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "_build.py").is_file():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda", 0)
    smi = smi_line()
    emit(phase="env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         card=smi, count=torch.cuda.device_count())

    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all(force=True)
    emit(phase="build", wall_seconds=time.perf_counter() - t0,
         seconds=_build.build_seconds, libraries=[
             str(_build.library_path(n).relative_to(ROOT))
             for n in _build.SOURCES],
         ptxas={n: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
                for n, log in _build.build_log.items()})

    write_k = phase_write_kernel(torch, args, dev)
    mgr, launches, n_steps, reads = phase_main(torch, args, dev, smi)
    read_k = phase_read_kernel(torch, mgr, reads)
    del reads
    phase_no_sync(torch, mgr)
    mgr.close()
    del mgr
    gc.collect()             # the manager's reference cycles hold its pools
    torch.cuda.empty_cache()
    for k in (write_k, read_k):
        k["launches"] = launches[k["name"]]
        k["launches_per_step"] = launches[k["name"]] / n_steps

    eng, kept, serve_launches, serve_counts = phase_serve(torch, dev, smi)
    paged_k = phase_paged_kernel(torch, eng, kept)
    flash_k = phase_flash_kernel(torch, kept)
    del kept
    phase_no_sync_serve(torch, eng)
    phase_profile_serve(torch, eng, smi)
    for k in (paged_k, flash_k):
        k["launches"] = serve_launches[k["name"]]
    paged_k["launches_per_decode_step"] = (serve_launches["paged_attention"]
                                           / serve_counts["decode_steps"])
    write_k["launches_serve_path"] = serve_launches["dbs_rw_write"]
    read_k["launches_serve_path"] = serve_launches["dbs_rw_read"]
    print(json.dumps({"kernels": [write_k, read_k, paged_k, flash_k]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
