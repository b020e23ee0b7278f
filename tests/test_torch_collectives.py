"""Port parity: the mesh collectives on 4 gloo ranks against the
reference's ``shard_map`` on 4 host devices.

One child Python runs the reference (``XLA_FLAGS`` sets 4 host devices
before ``import jax``, as ``tests/test_distributed.py`` does) while 4
spawned processes form one gloo group and run the port, each on its own
shards of the same seeded inputs:

- ``make_sharded_paged_decode`` on (data, model) meshes (2, 2) and (1, 4),
  with ``batch_shardable`` and ``stripe_slice`` each true and false, over
  block tables with holes, a window and a logit cap: each rank's output
  and pool stripes against the matching slices of the reference's,
  within atol 1e-5 and rtol 1e-5 (fp32; the merge's sums run in another
  order);
- ``compressed_cross_pod_mean`` with error feedback over two steps on a
  (2, 2, 1) (pod, data, model) mesh, and ``hierarchical_psum`` on it and
  on the (2, 2) mesh without a pod axis: within atol 1e-6 (fp32 sums in
  another order).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 4
B, H, KV, HD, PAGE, P_MAX, E_LOC = 4, 4, 2, 16, 8, 8, 12
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-6, rtol=0)
# (mesh, batch_shardable, stripe_slice, window, logit_cap)
CASES = [((d, m), bs, ss, 0 if ss else 40, 30.0 if bs else 0.0)
         for d, m in ((2, 2), (1, 4)) for bs in (True, False)
         for ss in (True, False)]


def _inputs(seed=0):
    """Global inputs of every case: pools of WORLD stripes of E_LOC rows,
    tables of local ids (distinct a stripe's owner, the stripe's last row
    left free, ~15% holes), positions past two pages."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, ((d, m), bs, _ss, _w, _c) in enumerate(CASES):
        stride = m if bs else d * m
        b_loc = B // d if bs else B
        table = np.full((B, P_MAX), -1, np.int32)
        for shard in range(d if bs else 1):
            for owner in range(stride):
                slots = [(b, p) for b in range(shard * b_loc,
                                               (shard + 1) * b_loc)
                         for p in range(P_MAX) if p % stride == owner]
                ids = rng.permutation(E_LOC - 1)[:len(slots)]
                for (b, p), e in zip(slots, ids):
                    table[b, p] = e
        table[rng.random(table.shape) < 0.15] = -1
        f = rng.standard_normal
        out[f"q{i}"] = f((B, 1, H, HD)).astype(np.float32)
        out[f"kn{i}"] = f((B, 1, KV, HD)).astype(np.float32)
        out[f"vn{i}"] = f((B, 1, KV, HD)).astype(np.float32)
        out[f"pk{i}"] = f((WORLD * E_LOC, PAGE, KV, HD)).astype(np.float32)
        out[f"pv{i}"] = f((WORLD * E_LOC, PAGE, KV, HD)).astype(np.float32)
        out[f"bt{i}"] = table
        out[f"pos{i}"] = rng.integers(2 * PAGE, P_MAX * PAGE,
                                      (B, 1)).astype(np.int32)
    for s in range(2):
        out[f"ga{s}"] = (rng.standard_normal((WORLD, 64)) * 3
                         ).astype(np.float32)
        out[f"gb{s}"] = (rng.standard_normal((WORLD, 5, 7)) * 0.1
                         ).astype(np.float32)
    out["x"] = rng.standard_normal((WORLD, 3, 5)).astype(np.float32)
    return out


REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from functools import partial
    from jax.sharding import PartitionSpec as P
    from repro.distributed.collectives import (
        make_sharded_paged_decode, compressed_cross_pod_mean,
        hierarchical_psum)
    inp = dict(np.load(sys.argv[1]))
    cases = eval(sys.argv[2])
    auto = lambda n: (jax.sharding.AxisType.Auto,) * n
    out = {}
    for i, (shape, bs, ss, window, cap) in enumerate(cases):
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=auto(2))
        fn = jax.jit(partial(make_sharded_paged_decode(
            mesh, bs, stripe_slice=ss), window=window, logit_cap=cap))
        o, pk, pv = fn(*(jnp.asarray(inp[k + str(i)]) for k in
                         ("q", "kn", "vn", "pk", "pv", "bt", "pos")))
        out[f"o{i}"], out[f"pk{i}"], out[f"pv{i}"] = map(np.asarray,
                                                         (o, pk, pv))
    mesh3 = jax.make_mesh((2, 2, 1), ("pod", "data", "model"),
                          axis_types=auto(3))
    every = P(("pod", "data", "model"))

    def two_steps(ga0, gb0, ga1, gb1):
        m0, ef = compressed_cross_pod_mean({"a": ga0, "b": gb0})
        m1, ef = compressed_cross_pod_mean({"a": ga1, "b": gb1},
                                           error_feedback=ef)
        return m0["a"], m0["b"], m1["a"], m1["b"], ef["a"], ef["b"]
    res = jax.jit(jax.shard_map(
        two_steps, mesh=mesh3, in_specs=(every,) * 4,
        out_specs=(every,) * 6, check_vma=False))(
        *(jnp.asarray(inp[k]) for k in ("ga0", "gb0", "ga1", "gb1")))
    for k, v in zip(("m0a", "m0b", "m1a", "m1b", "efa", "efb"), res):
        out[k] = np.asarray(v)
    out["psum3"] = np.asarray(jax.shard_map(
        hierarchical_psum, mesh=mesh3, in_specs=every, out_specs=every,
        check_vma=False)(jnp.asarray(inp["x"])))
    mesh2 = jax.make_mesh((2, 2), ("data", "model"), axis_types=auto(2))
    out["psum2"] = np.asarray(jax.shard_map(
        hierarchical_psum, mesh=mesh2, in_specs=P(("data", "model")),
        out_specs=P(("data", "model")), check_vma=False)(
        jnp.asarray(inp["x"])))
    np.savez(sys.argv[3], **out)
""")


def _worker(rank, init, inputs, outdir):
    """One gloo rank: every case on this rank's shards; saves
    ``rank<r>.npz``."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=WORLD, rank=rank)
    from repro_torch.distributed.collectives import (
        compressed_cross_pod_mean, hierarchical_psum,
        make_sharded_paged_decode)
    from repro_torch.launch.mesh import make_mesh
    inp = dict(np.load(inputs))
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    out = {}
    meshes = {}
    for i, (shape, bs, ss, window, cap) in enumerate(CASES):
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, ("data", "model"), "cpu")
        mesh = meshes[shape]
        d_idx, m_idx = mesh.get_coordinate()
        b_loc = B // shape[0] if bs else B
        rows = slice(d_idx * b_loc, (d_idx + 1) * b_loc) if bs \
            else slice(0, B)
        stripe = d_idx * shape[1] + m_idx
        ext = slice(stripe * E_LOC, (stripe + 1) * E_LOC)
        fn = make_sharded_paged_decode(mesh, bs, stripe_slice=ss)
        o, pk, pv = fn(t[f"q{i}"][rows], t[f"kn{i}"][rows],
                       t[f"vn{i}"][rows], t[f"pk{i}"][ext].clone(),
                       t[f"pv{i}"][ext].clone(), t[f"bt{i}"][rows],
                       t[f"pos{i}"][rows], window=window, logit_cap=cap)
        out[f"o{i}"], out[f"pk{i}"], out[f"pv{i}"] = (
            o.numpy(), pk.numpy(), pv.numpy())
    mesh3 = make_mesh((2, 2, 1), ("pod", "data", "model"), "cpu")
    r = slice(rank, rank + 1)
    m0, ef = compressed_cross_pod_mean({"a": t["ga0"][r], "b": t["gb0"][r]},
                                       mesh3)
    m1, ef = compressed_cross_pod_mean({"a": t["ga1"][r], "b": t["gb1"][r]},
                                       mesh3, error_feedback=ef)
    for k, v in (("m0a", m0["a"]), ("m0b", m0["b"]), ("m1a", m1["a"]),
                 ("m1b", m1["b"]), ("efa", ef["a"]), ("efb", ef["b"])):
        out[k] = v.numpy()
    out["psum3"] = hierarchical_psum(t["x"][r], mesh3).numpy()
    out["psum2"] = hierarchical_psum(t["x"][r], meshes[(2, 2)]).numpy()
    out["coord22"] = np.asarray(meshes[(2, 2)].get_coordinate())
    out["constrain"] = np.asarray(_constrain_case(meshes[(2, 2)], t["x"]))
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


def _constrain_case(mesh, x):
    """``runtime.constrain`` redistributes a DTensor to the installed
    placements (and only while they are installed)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.distributed.runtime import activation_sharding, constrain
    d = distribute_tensor(x, mesh, [Shard(0), Replicate()],
                          src_data_rank=None)
    same = constrain(d) is d
    with activation_sharding(mesh, [Replicate(), Shard(1)]):
        r = constrain(d)
    return [same, tuple(r.placements) == (Replicate(), Shard(1)),
            torch.equal(r.full_tensor(), x)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, each rank's outputs): the reference's child and
    the 4 gloo ranks run at once."""
    import torch.multiprocessing as mp
    tmp = str(tmp_path_factory.mktemp("collectives"))
    inputs = os.path.join(tmp, "inputs.npz")
    np.savez(inputs, **_inputs())
    ref_out = os.path.join(tmp, "reference.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    child = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, inputs, repr(CASES), ref_out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        mp.spawn(_worker, args=(os.path.join(tmp, "pg"), inputs, tmp),
                 nprocs=WORLD, join=True)
    finally:
        _, err = child.communicate(timeout=600)
    assert child.returncode == 0, err[-3000:]
    ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
             for r in range(WORLD)]
    return dict(np.load(ref_out)), ranks


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{s[0]}x{s[1]}-bs{int(bs)}-slice{int(ss)}"
                              for s, bs, ss, _w, _c in CASES])
def test_sharded_paged_decode_matches_shard_map(runs, i):
    ref, ranks = runs
    (d, m), bs, _ss, _w, _c = CASES[i]
    b_loc = B // d if bs else B
    for r, got in enumerate(ranks):
        d_idx, m_idx = divmod(r, m)
        rows = slice(d_idx * b_loc, (d_idx + 1) * b_loc) if bs \
            else slice(0, B)
        stripe = d_idx * m + m_idx
        ext = slice(stripe * E_LOC, (stripe + 1) * E_LOC)
        np.testing.assert_allclose(got[f"o{i}"], ref[f"o{i}"][rows], **TOL)
        np.testing.assert_array_equal(got[f"pk{i}"], ref[f"pk{i}"][ext])
        np.testing.assert_array_equal(got[f"pv{i}"], ref[f"pv{i}"][ext])
    assert np.isfinite(ref[f"o{i}"]).all()


def test_compressed_cross_pod_mean_matches_shard_map(runs):
    ref, ranks = runs
    for r, got in enumerate(ranks):
        for k in ("m0a", "m0b", "m1a", "m1b", "efa", "efb"):
            np.testing.assert_allclose(got[k], ref[k][r:r + 1], **GRAD_TOL,
                                       err_msg=k)
    # error feedback carried a residual into step 2
    assert np.abs(ref["efa"]).max() > 0


def test_hierarchical_psum_matches_shard_map(runs):
    ref, ranks = runs
    for r, got in enumerate(ranks):
        for k in ("psum3", "psum2"):
            np.testing.assert_allclose(got[k], ref[k][r:r + 1], **GRAD_TOL,
                                       err_msg=k)
        assert tuple(got["coord22"]) == divmod(r, 2)


def test_constrain_redistributes_a_dtensor(runs):
    _ref, ranks = runs
    for got in ranks:
        assert got["constrain"].tolist() == [True, True, True]
