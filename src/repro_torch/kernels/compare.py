"""Time this checkout's DBS, paged-attention, flash-attention and RWKV-6
kernels against other checkouts' builds of them, on one card, in turns
(needs the card).

    PYTHONPATH=src python -m repro_torch.kernels.compare \\
        [--against NAME=DIR ...]

``DIR`` is the root of another checkout (the parent commit unpacked with
``git archive``, say). Each checkout runs in a Python of its own on its
own ``src``: that checkout's ``compare.build`` builds its sources (one
nvcc each, together, under its ``build/torch_kernels/compare/NAME/``),
its ``inputs`` makes the call lists on the card from seed 0, and its
``runners`` call its builds through its own C entries, so no checkout
needs to know another's interface. This checkout's cases, at the main
paths' shapes:

- ``read_block_device``: 32 batches of 64 lanes over an (2049, 32, 4096)
  fp32 pool, 8% hole lanes (the block device's reads);
- ``read_serving``: 70 batches of 16 lanes over a (1033, 32, 26624) pool
  (zero-copy serving's write pumps: one 104 KiB block a token);
- ``copy_block_device``: 126 calls of 64 lanes over the (2049, 32, 4096)
  pool, 85% of them with no live lane and the rest with two (the
  ``copy`` column's calls: 0.29 rows a call); ``copy_empty`` the same
  number of calls with no live lane, ``copy_live`` 18 calls with two live
  rows each (what a call of each kind costs);
- ``copy_serving``: 26 calls of 8 lanes over a (1032, 32, 1024) pool, two
  live rows each (the serving baseline's fork);
- ``paged_serving``: one zero-copy gemma2-2b decode step's 13 global
  layers: 8 x 8 x 256 queries over planes (2l, 2l + 1) of a
  (1033, 32, 26, 4, 256) pool, 64-page block tables, lengths drawn in
  100-1032 (prompts of 100-1000 tokens and up to 32 new ones), logit cap
  50, no window;
- ``flash_serving``: gemma2-2b's prefill of an 854-token prompt, a local
  (window 4096) and a global layer: 8 heads over 4 KV heads of 256, logit
  cap 50, the model layout's strides;
- ``flash_serving_bf16``: the same two calls in bf16 (gemma2-2b's bf16
  serve plan);
- ``paged_mla``: deepseek-v3's zero-copy decode step at its 4 layers: 8
  sequences of prompts drawn in [100, 1000] plus 24 decoded tokens, 128
  query heads on one latent KV head of 576 (scale 1/sqrt(192)), page 32,
  64-page tables; its three wide forms, each a case of its own:
  ``paged_mla_f32`` (q fp32 over the fp32 engine pool's planes, 576 / 576),
  ``paged_mla_bf16`` (q bf16 over bf16 split pools, 576 / 512) and
  ``paged_mla_bf16q`` (q bf16 over the fp32 engine pool);
- ``flash_hybrid``: hymba-1.5b's 1369-token prompt, a global layer and a
  1024-token window layer: 25 heads over 5 KV heads of 64;
- ``flash_moe``: granite-moe's prompts of 951 and 663 tokens: 24 heads
  over 8 KV heads of 64;
- ``flash_audio``: musicgen-large's prompts of 768 and 923 tokens: 32
  heads over 32 KV heads of 64, no cap;
- ``rwkv6_decode``: one rwkv6-3b decode step's 32 layers: B 8, S 1,
  H 40, hd 64, a carried state each;
- ``rwkv6_prefill``: 4 prompts of 497 tokens (B 1, H 40, hd 64, the
  serving traffic's mean length), from a zero state;
- ``launch_floor``: a one-element ``zero_()`` per call.

This checkout's runner sends each flash case to the form ``flash_form``
picks for its shapes (fp32 at these shapes: the wgmma form of
``flash_attention_wgmma_f32.cu``; bf16: ``flash_attention_wgmma.cu``).
Each is one CUDA graph of a pass over the calls, the median of 20
replays, per call (``timing.graph_ms``, this checkout's for every side);
``<case>_queued`` is the same pass launched eagerly while a spin kernel
holds the card, so the launches queue up and run back to back
(``timing.queued_ms``). The checkouts take turns (A B ... B A, twice):
one side times all its cases while the others wait, and each build's
time is the median of its turns. Prints one JSON line per build and the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import (
    WGMMA_TAG, data_ptr, flash_form, flash_parts, flash_scratch,
    wgmma_library)
from repro_torch.kernels.paged_attention.kernel import (
    paged_block_rows, paged_partial_floats, paged_row_groups, paged_splits,
    sm_count)

ROOT = _build.KERNELS.parents[2]
NAMES = ("dbs_rw", "dbs_copy", "paged_attention", "paged_attention_bf16",
         "flash_attention", "flash_attention_wgmma",
         "flash_attention_wgmma_f32", "rwkv6_scan")
TURNS = 2                 # rounds of A B ... B A

# runs on one checkout, through its own build, inputs and runners (what
# every checkout's compare module has); reads "turn" lines and answers
# each with one JSON line of its times, on the stdout it was given
CHILD = r"""
import importlib.util, json, os, sys
from pathlib import Path
tag, timing_path = sys.argv[1], sys.argv[2]
out = os.fdopen(os.dup(1), "w")
os.dup2(2, 1)                      # nvcc and prints go to stderr
spec = importlib.util.spec_from_file_location("compare_timing", timing_path)
timing = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timing)
import torch
from repro_torch.kernels import compare as C
dev = torch.device("cuda", 0)
libs = C.build(tag, C.ROOT)
cases = C.inputs(dev)
runs = C.runners(libs, cases)
x = torch.ones(1, device=dev)
print(json.dumps({"ready": sorted(runs)}), file=out, flush=True)
for line in sys.stdin:
    if line.strip() != "turn":
        break
    got = {"launch_floor": timing.graph_ms(
        lambda: [x.zero_() for _ in range(64)], 64)}
    for case, fn in runs.items():
        n = len(cases[case][1])
        got[case] = timing.graph_ms(fn, n)
        got[f"{case}_queued"] = timing.queued_ms(fn, n)
    print(json.dumps(got), file=out, flush=True)
"""


def build(tag: str, root: Path) -> Dict[str, ctypes.CDLL]:
    """Build ``root``'s sources of ``NAMES`` (one nvcc each, run together)
    and load them."""
    with ThreadPoolExecutor(len(NAMES)) as ex:
        libs = ex.map(lambda n: _build.build_variant(
            n, f"compare/{tag}", root / _build.SOURCES[n].relative_to(ROOT)),
            NAMES)
    return dict(zip(NAMES, libs))


def inputs(dev, seed: int = 0):
    """The call lists (see the module note), made on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    pool_b = torch.rand((2049, 32, 4096), generator=gen, device=dev)
    pool_s = torch.rand((1033, 32, 26624), generator=gen, device=dev)
    pool_c = torch.rand((1032, 32, 1024), generator=gen, device=dev)
    reads_b = []
    for _ in range(32):
        ext = ints(0, 2048, 64)
        holes = torch.rand(64, generator=gen, device=dev) < 0.08
        reads_b.append((torch.where(holes, -1, ext).to(torch.int32),
                        ints(0, 32, 64), torch.empty((64, 4096), device=dev)))
    reads_s = [(ints(0, 1032, 16), ints(0, 32, 16),
                torch.empty((16, 26624), device=dev)) for _ in range(70)]

    def copies(n_calls, lanes, n_rows, live_every):
        out = []
        for i in range(n_calls):
            rows = torch.randperm(n_rows, generator=gen, device=dev)
            src = rows[:lanes].to(torch.int32)
            dst = rows[lanes:2 * lanes].to(torch.int32)
            mask = torch.zeros(lanes, dtype=torch.bool, device=dev)
            if live_every and i % live_every == 0:
                mask[torch.randperm(lanes, generator=gen, device=dev)[:2]] = 1
            out.append((src, dst, mask))
        return out

    # zero-copy decode: the pool as (E, page, 26 planes, 4 KV heads, 256)
    paged = []
    for layer in range(13):
        lengths = ints(100, 1033, 8)
        n_pages = (lengths + 31) // 32
        perm = torch.randperm(1032, generator=gen, device=dev)[:8 * 64]
        table = perm.view(8, 64).to(torch.int32)
        cols = torch.arange(64, device=dev)[None, :]
        table = torch.where(cols < n_pages[:, None], table, -1).to(
            torch.int32)
        q = torch.randn((8, 8, 256), generator=gen, device=dev)
        paged.append((q, table, lengths, 2 * layer, 2 * layer + 1))

    def flash(s, h, kv, d, windows, cap=0.0, dtype=torch.float32):
        """Model-layout (B, S, heads, hd) q, k, v and output views, one
        call per window."""
        out = []
        for w in windows:
            x = torch.randn((1, s, h + 2 * kv, d), generator=gen,
                            device=dev).to(dtype)
            q, k, v = (t.transpose(1, 2) for t in x.split([h, kv, kv], 2))
            o = torch.empty((1, s, h, d), device=dev,
                            dtype=dtype).transpose(1, 2)
            out.append((q, k, v, o, w, cap))
        return out

    # deepseek-v3's decode: the engine pool's planes (E, 32, 8, 1, 576),
    # the bf16 split pools, 4 layers' queries and tables
    mla_len = ints(100, 1001, 8) + 24
    mla_pages = (mla_len + 31) // 32
    mla_pool = torch.randn((8 * 64 + 5, 32, 8, 1, 576), generator=gen,
                           device=dev)
    mla_k = torch.randn((8 * 64 + 5, 32, 1, 576), generator=gen,
                        device=dev).to(torch.bfloat16)
    mla_v = torch.randn((8 * 64 + 5, 32, 1, 512), generator=gen,
                        device=dev).to(torch.bfloat16)
    mla = []
    for layer in range(4):
        perm = torch.randperm(8 * 64 + 4, generator=gen, device=dev)[:8 * 64]
        table = (perm + 1).view(8, 64)
        cols = torch.arange(64, device=dev)[None, :]
        table = torch.where(cols < mla_pages[:, None], table, -1).to(
            torch.int32)
        q = torch.randn((8, 128, 576), generator=gen, device=dev)
        mla.append((q, table, mla_len, 2 * layer, 2 * layer + 1))

    def mla_case(form):
        calls = [((q if form == "f32" else q.to(torch.bfloat16)), t, n, kp,
                  vp) for q, t, n, kp, vp in mla]
        return ((mla_pool, form) if form != "bf16"
                else ((mla_k, mla_v), form), calls)

    def rwkv(b, s, n_calls, with_state):
        out = []
        for _ in range(n_calls):
            r, k, v = (torch.randn((b, s, 40, 64), generator=gen, device=dev)
                       for _ in range(3))
            logw = -torch.exp(torch.randn((b, s, 40, 64), generator=gen,
                                          device=dev) * 0.5 - 1.0)
            u = torch.randn((40, 64), generator=gen, device=dev) * 0.1
            s0 = (torch.randn((b, 40, 64, 64), generator=gen, device=dev)
                  if with_state else None)
            out.append((r, k, v, logw, u, s0,
                        torch.empty_like(r),
                        torch.empty((b, 40, 64, 64), device=dev)))
        return out

    return {"read_block_device": (pool_b, reads_b),
            "read_serving": (pool_s, reads_s),
            "copy_block_device": (pool_b, copies(126, 64, 2049, 7)),
            "copy_empty": (pool_b, copies(126, 64, 2049, 0)),
            "copy_live": (pool_b, copies(18, 64, 2049, 1)),
            "copy_serving": (pool_c, copies(26, 8, 1032, 1)),
            "paged_serving": (pool_s.view(1033, 32, 26, 4, 256), paged),
            "flash_serving": (None, flash(854, 8, 4, 256, (4096, 0), 50.0)),
            "flash_serving_bf16": (None, flash(854, 8, 4, 256, (4096, 0),
                                               50.0, torch.bfloat16)),
            "paged_mla_f32": mla_case("f32"),
            "paged_mla_bf16": mla_case("bf16"),
            "paged_mla_bf16q": mla_case("bf16q"),
            "flash_hybrid": (None, flash(1369, 25, 5, 64, (0, 1024))),
            "flash_moe": (None, flash(951, 24, 8, 64, (0,))
                          + flash(663, 24, 8, 64, (0,))),
            "flash_audio": (None, flash(768, 32, 32, 64, (0,))
                            + flash(923, 32, 32, 64, (0,))),
            "rwkv6_decode": (None, rwkv(8, 1, 32, True)),
            "rwkv6_prefill": (None, rwkv(1, 497, 4, False))}


def runners(libs, cases) -> Dict[str, Callable[[], None]]:
    """One pass over each case's calls through ``libs``."""
    rw, cp = libs["dbs_rw"].dbs_rw_read, libs["dbs_copy"].dbs_copy
    pa = libs["paged_attention"].paged_attention
    scan = libs["rwkv6_scan"].rwkv6_scan
    fa = libs["flash_attention"].flash_attention
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def read(name):
        pool, calls = cases[name]
        e, page, d = pool.shape

        def run():
            st = stream()
            for ext, blk, out in calls:
                _build.raise_on(rw(pool.data_ptr(), ext.data_ptr(),
                                   blk.data_ptr(), out.data_ptr(),
                                   ext.numel(), e, page, 4 * d, 16, st),
                                name)
        return run

    def copy(name):
        pool, calls = cases[name]
        e, page, d = pool.shape

        def run():
            st = stream()
            for src, dst, mask in calls:
                _build.raise_on(cp(pool.data_ptr(), src.data_ptr(),
                                   dst.data_ptr(), mask.data_ptr(), 0,
                                   src.numel(), e, 4 * page * d, 16, st),
                                name)
        return run

    def paged(name):
        pool, calls = cases[name]
        e, page, n_planes, kv, d = pool.shape
        b, h, _ = calls[0][0].shape
        p_max = calls[0][1].shape[1]
        tok = n_planes * kv * d
        n_split = paged_splits(p_max, b * kv * paged_row_groups(h, kv),
                               sm_count(pool.device), h // kv)
        part = torch.empty((b, kv, n_split, h // kv, d + 2),
                           device=pool.device)
        out = torch.empty((b, h, d), device=pool.device)

        def run():
            st = stream()
            for q, table, lengths, kp, vp in calls:
                kv_ptr = [pool.data_ptr() + p * kv * d * 4 for p in (kp, vp)]
                head = [q.data_ptr(), *kv_ptr, table.data_ptr(),
                        lengths.data_ptr(), out.data_ptr()]
                dims = [b, h, kv, d, d, p_max, page, e, page * tok, tok,
                        page * tok, tok, 0, 1.0 / 16, 50.0]
                _build.raise_on(pa(*head, part.data_ptr(), *dims, n_split,
                                   st), name)
        return run

    def rwkv(name):
        _, calls = cases[name]

        def run():
            st = stream()
            for r, k, v, w, u, s0, y, s_out in calls:
                b, s, h, d = r.shape
                strides = [x for t in (r, k, v, w, y) for x in t.stride()[:3]]
                _build.raise_on(scan(
                    r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                    u.data_ptr(), None if s0 is None else s0.data_ptr(),
                    y.data_ptr(), s_out.data_ptr(), b, s, h, d, 64,
                    *strides, 0, 0, st), name)
        return run

    def flash(name):
        _, calls = cases[name]
        q0, k0, v0 = calls[0][:3]
        form = flash_form(q0.shape[-1], v0.shape[-1], q0.dtype,
                          [x for t in (q0, k0, v0) for x in t.stride()[:3]],
                          [t.data_ptr() for t in (q0, k0, v0)])
        wg = form.endswith("_wgmma")
        entry = fa
        if wg:
            entry = getattr(libs[wgmma_library(q0.dtype)],
                            f"flash_attention_{WGMMA_TAG[q0.dtype]}_wgmma")
        # the fp32 wgmma form's parts and scratch, a call's each (its
        # counters go back to zero after every launch)
        scratch = []
        for q, *_ in calls:
            b, h, sq, d = q.shape
            parts = flash_parts(b, h, sq, sm_count(q.device))
            scratch.append((*flash_scratch(b, h, sq, d, parts, q.device),
                            parts))

        def run():
            st = stream()
            for (q, k, v, o, window, cap), (part, count, parts) in zip(
                    calls, scratch):
                b, h, sq, d = q.shape
                kv, sk = k.shape[1], k.shape[2]
                dims = [b, h, kv, sq, sk, d] + ([] if wg else [d])
                strides = [x for t in (q, k, v, o) for x in t.stride()[:3]]
                tail = [1, window, d ** -0.5, cap]
                if form == "f32_wgmma":
                    tail += [data_ptr(part), data_ptr(count), parts]
                _build.raise_on(entry(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    *dims, *strides, *tail, st), name)
        return run

    def paged_mla(name):
        (pools, form), calls = cases[name]
        q0, table0 = calls[0][0], calls[0][1]
        b, h, d = q0.shape
        p_max = table0.shape[1]
        if form == "bf16":
            pk, pv = pools
            e, page, kv, _ = pk.shape
            dv = pv.shape[-1]
            strides = [page * kv * d, kv * d, page * kv * dv, kv * dv]
        else:
            e, page, n_planes, kv, _ = pools.shape
            dv = d
            tok = n_planes * kv * d
            strides = [page * tok, tok, page * tok, tok]
        n_split = paged_splits(p_max, b * paged_block_rows(h, kv, d, dv),
                               sm_count(q0.device), h // kv, max(d, dv))
        part = torch.empty(max(1, paged_partial_floats(
            b, h, kv, dv, n_split, "packed")), device=q0.device)
        out = torch.empty((b, h, dv), device=q0.device, dtype=q0.dtype)
        lib = (libs["paged_attention"].paged_attention if form == "f32"
               else libs["paged_attention_bf16"].paged_attention_bf16)

        def run():
            st = stream()
            for q, table, lengths, kp, vp in calls:
                if form == "bf16":
                    ptrs = [pk.data_ptr(), pv.data_ptr()]
                else:
                    ptrs = [pools.data_ptr() + p * kv * d * 4
                            for p in (kp, vp)]
                args = [q.data_ptr(), *ptrs, table.data_ptr(),
                        lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
                        b, h, kv, d, dv, p_max, page, e, *strides, 0,
                        192 ** -0.5, 0.0, n_split]
                if form != "f32":
                    args.append(int(form == "bf16"))
                _build.raise_on(lib(*args, st), name)
        return run

    make = {"read": read, "copy": copy, "paged": paged, "flash": flash,
            "rwkv6": rwkv}
    return {n: (paged_mla(n) if n.startswith("paged_mla")
                else make[n.split("_")[0]](n)) for n in cases}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", action="append", default=[],
                    metavar="NAME=DIR", help="another checkout's root")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare: no CUDA device")
    roots = {"this": ROOT}
    for item in args.against:
        name, _, path = item.partition("=")
        roots[name] = Path(path).resolve()
    timing = str(Path(__file__).with_name("timing.py"))
    procs = {tag: subprocess.Popen(
        [sys.executable, "-c", CHILD, tag, timing], cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root / "src")),
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for tag, root in roots.items()}
    got: Dict[str, Dict[str, List[float]]] = {t: {} for t in roots}
    try:
        for tag, proc in procs.items():          # every side built
            _read(tag, proc)
        for tag in (list(roots) + list(roots)[::-1]) * TURNS:
            procs[tag].stdin.write("turn\n")
            procs[tag].stdin.flush()
            for key, ms in _read(tag, procs[tag]).items():
                got[tag].setdefault(key, []).append(ms)
    finally:
        for proc in procs.values():
            proc.stdin.close()
            proc.wait()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    for tag in roots:
        print(json.dumps({"build": tag, "root": str(roots[tag]), **{
            key: statistics.median(ts) for key, ts in got[tag].items()},
            "turns": got[tag], "card": card}))
    print(card)
    return 0


def _read(tag: str, proc: subprocess.Popen) -> Dict:
    """The next JSON line from a checkout's Python; raises if it ended."""
    line = proc.stdout.readline()
    if not line:
        raise RuntimeError(f"compare: {tag}'s Python ended "
                           f"(exit {proc.wait()})")
    return json.loads(line)


if __name__ == "__main__":
    raise SystemExit(main())
