#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--max-pages P]

Run from the root of a checkout on a machine with an NVIDIA GPU (Hopper:
the kernels build for sm_90a with nvcc, at first use, into
build/torch_kernels/). ``--max-pages`` cuts the volume's size (1 GiB by
default), the one cut a short time limit may force. Phases, one JSON line
each; any failure raises and the script exits non-zero:

1. env — torch/CUDA versions, the card's name and power limit.
2. build — compile csrc/dbs_rw.cu with nvcc; build seconds.
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

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power line, and
last ``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
KERNEL_SRC = "src/repro_torch/kernels/dbs/csrc/dbs_rw.cu"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
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
    if not (SRC / "repro_torch" / "kernels" / "dbs" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda", 0)
    smi = smi_line()
    emit(phase="env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         card=smi, count=torch.cuda.device_count())

    from repro_torch.kernels.dbs import _build
    _build.build(force=True)
    emit(phase="build", seconds=_build.build_seconds, library=str(
        _build.LIBRARY.relative_to(ROOT)),
        ptxas=[ln.strip() for ln in _build.build_log.splitlines()
               if "registers" in ln or "spill" in ln])

    write_k = phase_write_kernel(torch, args, dev)
    mgr, launches, n_steps, reads = phase_main(torch, args, dev, smi)
    read_k = phase_read_kernel(torch, mgr, reads)
    del reads
    phase_no_sync(torch, mgr)
    mgr.close()
    kernels = [write_k, read_k]
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_per_step"] = launches[k["name"]] / n_steps
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
