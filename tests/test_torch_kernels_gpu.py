"""The hand-written ``dbs_rw`` CUDA kernels against their plain versions.

Needs a CUDA device and ``nvcc`` (the kernels have no CPU mode), so every
test here is marked ``gpu`` and skips without a card. On a machine with one:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

The write batches come from the port's own ``write_pages`` (so they keep
the routing contract the GPU relies on): CoW after a snapshot and a clone,
in-place pages, holes, duplicate-page groups with colliding blocks, masked
lanes. Results must equal the plain versions bit for bit. Imports no JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dbs  # noqa: E402
from repro_torch.kernels.dbs import (dbs_rw_read, dbs_rw_read_ref,  # noqa: E402
                                     dbs_rw_write, dbs_rw_write_ref)
from repro_torch.kernels.dbs.ops import _route_writes  # noqa: E402


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the dbs_rw kernels have no CPU mode")
    return torch.device("cuda")


def _legal_batches(n_e, page, b, n_batches, seed):
    """Routed write batches from a seeded write_pages trace (CPU)."""
    rng = np.random.default_rng(seed)
    n_p = 4 * b
    st = dbs.make_state(n_e, 2, n_p, device=torch.device("cpu"))
    st, _ = dbs.create_volume(st)
    out = []

    def write(vols, pages, blocks, mask):
        nonlocal st
        st, ops = dbs.write_pages(
            st, torch.from_numpy(vols), torch.from_numpy(pages),
            torch.ones((), dtype=torch.int64) << torch.from_numpy(blocks),
            torch.from_numpy(mask))
        out.append(_route_writes(ops, page, torch.from_numpy(blocks), n_e))

    for i in range(n_batches):
        if i == 1:
            st, _ = dbs.snapshot(st, 0)
            st, _ = dbs.clone(st, 0)
        vols = rng.integers(0, 2 if i else 1, b).astype(np.int32)
        pages = rng.integers(0, n_p // 2, b).astype(np.int32)
        pages[b // 2:] = pages[:b - b // 2]          # duplicate-page groups
        blocks = rng.integers(0, page, b).astype(np.int64)
        write(vols, pages, blocks, rng.random(b) < 0.9)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("n_e,page,d,b", [(16, 4, 6, 8), (33, 8, 16, 12),
                                          (2048, 32, 4096, 64)])
def test_cuda_kernels_match_plain_versions(n_e, page, d, b):
    """D=6 takes the scalar loop, D%4==0 the float4 one; the last geometry
    is the main path's width."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(0)
    pool = torch.rand((n_e + 1, page, d), generator=gen, device=dev)
    ref = pool.clone()
    for src, dst, lane_of in _legal_batches(n_e, page, b, 4, n_e):
        src, dst, lane_of = src.to(dev), dst.to(dev), lane_of.to(dev)
        pay = torch.rand((b, d), generator=gen, device=dev)
        dbs_rw_write(pool, src, dst, lane_of, pay, check_routing=True)
        dbs_rw_write_ref(ref, src, dst, lane_of, pay)
    torch.cuda.synchronize()
    assert torch.equal(pool, ref)
    lane = torch.arange(b, device=dev, dtype=torch.int32)
    ext = torch.where(lane % 3 == 0, -1, lane * 7 % (n_e + 1)).to(torch.int32)
    blk = (lane * 5 % page).to(torch.int32)
    got = dbs_rw_read(pool, ext, blk)
    assert torch.equal(got, dbs_rw_read_ref(pool, ext, blk))
    assert not got[0].any()
