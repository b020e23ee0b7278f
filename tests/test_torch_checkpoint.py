"""Port parity: the on-disk DBS and the checkpoint stores, the twin of
tests/test_checkpoint.py (its six cases; the elastic case becomes a
restore onto ``device="cpu"``, since placing leaves on a mesh waits for the
distributed slice).

Beyond the reference's cases: the same ``DBSHost`` operations in both
packages leave device files equal byte for byte; the same tree saved by
both gives equal checkpoint files (JAX's leaf order and treedef string,
bf16 as raw bytes); and a checkpoint either package writes restores in the
other bit for bit, bf16 leaves included. Comparisons are exact.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointStore as JStore  # noqa: E402
from repro.checkpoint import ReplicatedCheckpoint as JReplicated  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.core.dbs_host import DBSHost as JHost  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro_torch.checkpoint import (CheckpointStore,  # noqa: E402
                                    ReplicatedCheckpoint)
from repro_torch.checkpoint.store import _flatten  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.core.dbs_host import DBSHost  # noqa: E402


def _tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((64, 32), generator=gen),
            "b": torch.arange(7, dtype=torch.float32),
            "nested": {"e": torch.randn((16, 8), generator=gen)
                       .to(torch.bfloat16)}}


def _j_tree(seed=0):
    k = jax.random.PRNGKey(seed)
    return {"w": jax.random.normal(k, (64, 32)),
            "b": jnp.arange(7, dtype=jnp.float32),
            "nested": {"e": jax.random.normal(k, (16, 8)).astype(jnp.bfloat16),
                       "l": [jnp.zeros((), jnp.int32), (jnp.ones(3),)]}}


def _to_torch(tree):
    """The reference tree as tensors, bf16 through its raw bytes."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes as numpy (bf16 through int16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.detach().cpu().numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_tree_eq(a, b):
    la, lb = _flatten(a)[0], _flatten(b)[0]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert str(x.dtype).split(".")[-1] == str(y.dtype).split(".")[-1]
        np.testing.assert_array_equal(_bits(x), _bits(y))


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_save_restore_roundtrip(tmp_path):
    st = CheckpointStore(str(tmp_path / "ck.dbs"), capacity_bytes=1 << 24)
    t0 = _tree(0)
    st.save("train", 10, t0)
    step, back = st.restore("train", like=t0)
    assert step == 10
    _assert_tree_eq(t0, back)
    # version history via snapshots
    t1 = _tree(1)
    st.save("train", 20, t1)
    step, back = st.restore("train", like=t0)
    assert step == 20
    _assert_tree_eq(t1, back)
    st.close()


def test_crash_torn_write_recovers_previous_version(tmp_path):
    path = str(tmp_path / "ck.dbs")
    st = CheckpointStore(path, capacity_bytes=1 << 24)
    t0 = _tree(0)
    st.save("train", 10, t0)
    # simulate a torn save: corrupt the live head's header block only
    st.dev.write("train", 0, b"\xff" * 4096)
    st.close()
    st2 = CheckpointStore(path, capacity_bytes=1 << 24)
    step, back = st2.restore("train", like=t0)
    assert step == 10                      # fell back to the frozen snapshot
    _assert_tree_eq(t0, back)
    st2.close()


def test_reopen_rebuilds_tables(tmp_path):
    path = str(tmp_path / "ck.dbs")
    st = CheckpointStore(path, capacity_bytes=1 << 24)
    t0 = _tree(3)
    st.save("train", 5, t0)
    st.close()
    st2 = CheckpointStore(path, capacity_bytes=1 << 24)   # open() path
    step, back = st2.restore("train", like=t0)
    assert step == 5
    _assert_tree_eq(t0, back)
    st2.close()


def test_replicated_write_all_fail_rebuild(tmp_path):
    dirs = [str(tmp_path / d) for d in "abc"]
    for d in dirs:
        os.makedirs(d)
    rc = ReplicatedCheckpoint(dirs, capacity_bytes=1 << 24)
    t0 = _tree(0)
    rc.save("train", 7, t0)
    assert rc.consistent()
    rc.fail(0)
    step, back = rc.restore("train", like=t0)     # survives replica loss
    assert step == 7
    _assert_tree_eq(t0, back)
    rc.rebuild(0)
    assert rc.consistent()
    step, back = rc.stores[0].restore("train", like=t0)
    assert step == 7
    _assert_tree_eq(t0, back)
    rc.close()


def test_restore_onto_a_device(tmp_path):
    """The elastic case's port: leaves land on the device asked for, with
    the manifest's dtypes, bit for bit."""
    st = CheckpointStore(str(tmp_path / "ck.dbs"), capacity_bytes=1 << 24)
    t0 = _tree(0)
    st.save("train", 3, t0)
    step, back = st.restore("train", like=t0, device="cpu")
    assert step == 3
    _assert_tree_eq(t0, back)
    for leaf in _flatten(back)[0]:
        assert isinstance(leaf, torch.Tensor)
        assert leaf.device == torch.device("cpu")
    assert back["nested"]["e"].dtype == torch.bfloat16
    st.close()


def test_dbs_host_cow_and_merge(tmp_path):
    path = str(tmp_path / "dev.img")
    d = DBSHost.create(path, n_extents=64, extent_blocks=8, block_size=512,
                       max_pages=64)
    d.create_volume("v")
    data1 = bytes(np.random.default_rng(0).integers(0, 255, 8 * 512,
                                                    dtype=np.uint8))
    d.write("v", 0, data1)
    d.snapshot("v")
    data2 = bytes(np.random.default_rng(1).integers(0, 255, 512,
                                                    dtype=np.uint8))
    d.write("v", 512, data2)               # CoW within the first extent
    assert d.read("v", 0, 512) == data1[:512]
    assert d.read("v", 512, 512) == data2
    # clone isolation
    d.clone("v", "f")
    d.write("f", 0, data2)
    assert d.read("v", 0, 512) == data1[:512]
    assert d.read("f", 512, 512) == data2
    d.delete_volume("f")
    # merge-delete the frozen middle snapshot
    head = d.volumes["v"]
    mid = d.snapshots[head].parent
    d.delete_snapshot(mid)
    assert d.read("v", 0, 512) == data1[:512]
    assert d.read("v", 512, 512) == data2
    d.close()


def _dbs_ops(host_cls, path, seed):
    """A seeded op sequence over one package's ``DBSHost``: writes (fresh
    extents, in place, CoW), snapshots, a clone with its own writes, an
    unmap, a merge-delete, a volume delete, a close, a reopen and more of
    the same; returns what every read gave."""
    rng = np.random.default_rng(seed)
    bs, eb, pages = 256, 4, 16
    d = host_cls.create(path, n_extents=96, extent_blocks=eb, block_size=bs,
                        max_pages=pages)
    reads = []

    def wr(vol):
        blk = int(rng.integers(0, pages * eb - 3))
        n = int(rng.integers(1, 4))
        d.write(vol, blk * bs, bytes(rng.integers(0, 256, n * bs,
                                                  dtype=np.uint8)))

    d.create_volume("a")
    for _ in range(12):
        wr("a")
    d.snapshot("a")
    for _ in range(6):
        wr("a")
    d.clone("a", "b")
    for _ in range(6):
        wr("b")
        wr("a")
    d.unmap("a", int(rng.integers(0, pages)))
    d.snapshot("a")
    wr("a")
    chain = d._chain(d.volumes["a"])
    d.delete_snapshot(chain[1])
    for vol in ("a", "b"):
        reads.append(d.read(vol, 0, pages * eb * bs))
    d.delete_volume("b")
    d.close()
    d = host_cls.open(path)
    reads.append(d.read("a", 0, pages * eb * bs))
    for _ in range(4):                     # commits after a reopen
        wr("a")
    d.snapshot("a")
    wr("a")
    d.unmap("a", int(rng.integers(0, pages)))
    reads.append(d.read("a", 0, pages * eb * bs))
    reads.append(repr(d.stats()))
    d.close()
    return reads


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dbs_host_device_files_equal_reference(tmp_path, seed):
    """The same operations write the same device file, byte for byte
    (superblock, JSON metadata, status region, data), and read the same
    bytes, before and after a reopen."""
    want = _dbs_ops(JHost, str(tmp_path / "j.img"), seed)
    got = _dbs_ops(DBSHost, str(tmp_path / "t.img"), seed)
    assert got == want
    assert _read(tmp_path / "t.img") == _read(tmp_path / "j.img")


def test_flatten_order_is_jax_order():
    """Over a model's parameter tree (stacked segments, nested dicts) and
    the reference test's tree (lists, tuples, a 0-d leaf), the leaves come
    in JAX's order and the treedef string is the one JAX prints."""
    for tree in (jax.device_get(j_init(jax.random.PRNGKey(0),
                                       j_smoke("hymba-1.5b"))),
                 _j_tree(0)):
        leaves, treedef = jax.tree_util.tree_flatten(tree)
        t_tree = (params_from_numpy(t_smoke("hymba-1.5b"), tree, "cpu")
                  if "segments" in tree else _to_torch(tree))
        t_leaves, t_def = _flatten(t_tree)
        assert t_def == str(treedef)
        assert len(t_leaves) == len(leaves)
        for a, b in zip(t_leaves, leaves):
            np.testing.assert_array_equal(_bits(a), _bits(b))


def test_checkpoint_files_equal_reference(tmp_path):
    """Two saves of two versions (the second copy-on-write against the
    first) by each package: equal device files."""
    for pkg, store, conv in (("j", JStore, lambda t: t),
                             ("t", CheckpointStore, _to_torch)):
        st = store(str(tmp_path / f"{pkg}.dbs"), capacity_bytes=1 << 22)
        st.save("train", 1, conv(_j_tree(0)))
        st.save("train", 2, conv(_j_tree(1)))
        st.close()
    assert _read(tmp_path / "t.dbs") == _read(tmp_path / "j.dbs")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_packages(tmp_path, writer):
    """A checkpoint written by one package restores in the other bit for
    bit, bf16 and the 0-d int32 leaf included."""
    path = str(tmp_path / "ck.dbs")
    jt = _j_tree(2)
    if writer == "reference":
        st = JStore(path, capacity_bytes=1 << 22)
        st.save("train", 9, jt)
        st.close()
        step, back = CheckpointStore(path).restore("train",
                                                   like=_to_torch(jt))
        assert back["nested"]["e"].dtype == torch.bfloat16
    else:
        st = CheckpointStore(path, capacity_bytes=1 << 22)
        st.save("train", 9, _to_torch(jt))
        st.close()
        step, back = JStore(path).restore("train", like=jt)
        assert str(back["nested"]["e"].dtype) == "bfloat16"
    assert step == 9
    _assert_tree_eq(jt, back)


def test_replicated_rebuild_matches_reference(tmp_path):
    """The same save, fail and rebuild through both packages'
    ``ReplicatedCheckpoint``: the same stream summary, equal rebuilt
    device files, and the rebuilt replica restores alone."""
    out = {}
    for pkg, rep, conv in (("j", JReplicated, lambda t: t),
                           ("t", ReplicatedCheckpoint, _to_torch)):
        dirs = [str(tmp_path / pkg / d) for d in "ab"]
        rc = rep(dirs, capacity_bytes=1 << 22)
        rc.save("train", 4, conv(_j_tree(0)))
        rc.save("train", 5, conv(_j_tree(1)))
        rc.fail(1)
        out[pkg] = rc.rebuild(1)
        rc.close()
    assert out["t"] == out["j"]
    assert _read(tmp_path / "t" / "b" / "ckpt.dbs") == \
        _read(tmp_path / "j" / "b" / "ckpt.dbs")
    step, back = CheckpointStore(str(tmp_path / "t" / "b" / "ckpt.dbs")
                                 ).restore("train", like=_to_torch(
                                     _j_tree(1)))
    assert step == 5
    _assert_tree_eq(_j_tree(1), back)


def test_restore_with_no_healthy_replica_is_no_checkpoint(tmp_path):
    """With every replica failed, restore raises ``IOError`` ("no valid
    checkpoint"), where the reference divides by zero."""
    rc = ReplicatedCheckpoint([str(tmp_path / "t")], capacity_bytes=1 << 22)
    rc.save("train", 1, _tree(0))
    rc.fail(0)
    with pytest.raises(IOError):
        rc.restore("train", like=_tree(0))
    rj = JReplicated([str(tmp_path / "j")], capacity_bytes=1 << 22)
    rj.fail(0)
    with pytest.raises(ZeroDivisionError):
        rj.restore("train", like=_j_tree(0))


# ---------------------------------------------------------------------------
# the store repairs: a save torn in its data, the fallback's clone, a full
# store (the reference's behaviour pinned beside the port's)
# ---------------------------------------------------------------------------
def _torn_save(store, step, tree, tear_block):
    """``store.save`` cut after its first ``tear_block`` blocks (data,
    then the manifest, then the header), as a crash leaves the file: what
    was written stays, nothing is closed."""
    dev = store.dev
    write = dev.write
    left = [tear_block]

    def cut(name, off, data):
        n = min(left[0], len(data) // 4096)
        if n:
            write(name, off, data[:n * 4096])
            left[0] -= n
        if n * 4096 < len(data):
            raise KeyboardInterrupt("torn")
    dev.write = cut
    with pytest.raises(KeyboardInterrupt):
        store.save("train", step, tree)
    dev.f.flush()
    dev.f.close()
    dev.f = None


def _wb(pkg):
    if pkg == "j":
        return {"w": jnp.zeros(4096), "b": jnp.zeros(1024)}, \
            {"w": jnp.ones(4096), "b": jnp.ones(1024)}
    return {"w": torch.zeros(4096), "b": torch.zeros(1024)}, \
        {"w": torch.ones(4096), "b": torch.ones(1024)}


# leaves in JAX's order: b (1 block), then w (4 blocks); then the manifest
# (1 block) and the header: a tear at 0..6 blocks written
@pytest.mark.parametrize("tear_block", [0, 1, 3, 5, 6])
def test_torn_save_restores_last_complete_step(tmp_path, tear_block):
    path = str(tmp_path / "ck.dbs")
    st = CheckpointStore(path, capacity_bytes=1 << 24)
    zeros, ones = _wb("t")
    st.save("train", 10, zeros)
    _torn_save(st, 11, ones, tear_block)
    st2 = CheckpointStore(path, capacity_bytes=1 << 24)
    owns = (st2.dev.extent_owner == st2.dev.volumes["train"]).any()
    assert owns == (tear_block > 0)             # a save in flight
    step, back = st2.restore("train", like=zeros)
    assert step == 10
    _assert_tree_eq(zeros, back)
    assert st2.steps("train") == [10]
    st2.close()


def test_reference_torn_save_restores_a_mix(tmp_path):
    """The reference validates the old header over the new data: only the
    first leaf (b) of a step-11 save of ones written, it restores step 10
    with b all ones."""
    path = str(tmp_path / "ck.dbs")
    st = JStore(path, capacity_bytes=1 << 24)
    zeros, ones = _wb("j")
    st.save("train", 10, zeros)
    _torn_save(st, 11, ones, 1)
    step, back = JStore(path, capacity_bytes=1 << 24).restore("train",
                                                               like=zeros)
    assert step == 10
    np.testing.assert_array_equal(np.asarray(back["b"]), np.ones(1024))
    np.testing.assert_array_equal(np.asarray(back["w"]), np.zeros(4096))


def _fallback_then_saves(store_cls, path, conv, keep_last=2):
    """A 1 MiB tree in a 16 MiB store: save step 1, tear the head's
    header, restore (the snapshot fallback) and ``steps``, then saves
    2..20. Returns (the store, volumes after the restore, chain lengths)."""
    st = store_cls(path, capacity_bytes=1 << 24)
    tree = conv({"w": np.arange(1 << 18, dtype=np.float32)})
    st.save("train", 1, tree)
    st.dev.write("train", 0, b"\xff" * 4096)
    step, back = st.restore("train", like=tree)
    assert step == 1
    _assert_tree_eq(tree, back)
    assert st.steps("train") == [1]
    after = sorted(st.dev.volumes)
    chains = []
    for step in range(2, 21):
        st.save("train", step, tree, keep_last=keep_last)
        chains.append(len(st.dev._chain(st.dev.volumes["train"])))
    return st, after, chains


def test_fallback_restore_leaves_no_clone(tmp_path):
    st, after, chains = _fallback_then_saves(
        CheckpointStore, str(tmp_path / "ck.dbs"),
        lambda t: {k: torch.from_numpy(v) for k, v in t.items()})
    assert after == ["train"]
    assert max(chains) <= 2 + 1                 # keep_last + the head
    assert st.steps("train") == [20]
    assert not [v for v in st.dev.volumes if v.startswith("__restore_")]
    st.close()


def test_reference_fallback_clone_fills_the_store(tmp_path):
    """The reference keeps ``__restore_<sid>``; its fork point stops the
    GC and a later save finds no free extent (``IndexError``)."""
    with pytest.raises(IndexError):
        _fallback_then_saves(JStore, str(tmp_path / "ck.dbs"),
                             lambda t: {k: jnp.asarray(v)
                                        for k, v in t.items()})
    st = JStore(str(tmp_path / "ck.dbs"), capacity_bytes=1 << 24)
    assert [v for v in st.dev.volumes if v.startswith("__restore_")]


@pytest.mark.parametrize("kind", ["store", "replicated"])
def test_save_keeping_no_old_version_restores(tmp_path, kind):
    """``keep_last=0``: the GC keeps the newest snapshot (merged into the
    head it would read as a save in flight), so every save restores, as
    the reference's (which reads its head) does."""
    if kind == "store":
        st = CheckpointStore(str(tmp_path / "ck.dbs"), capacity_bytes=1 << 24)
        js = JStore(str(tmp_path / "j.dbs"), capacity_bytes=1 << 24)
    else:
        st = ReplicatedCheckpoint([str(tmp_path / d) for d in "ab"],
                                  capacity_bytes=1 << 24)
        js = JReplicated([str(tmp_path / d) for d in "jk"],
                         capacity_bytes=1 << 24)
    stores = [st] if kind == "store" else st.stores
    for step in range(1, 4):
        st.save("train", step, _to_torch(_j_tree(step)), keep_last=0)
        js.save("train", step, _j_tree(step), keep_last=0)
        back_step, back = st.restore("train", like=_to_torch(_j_tree(0)))
        assert back_step == step
        _assert_tree_eq(_to_torch(_j_tree(step)), back)
        assert js.restore("train", like=_j_tree(0))[0] == step
        for s in stores:
            head = s.dev.volumes["train"]
            assert len(s.dev._chain(head)) == 2     # the head + one version
            assert not (s.dev.extent_owner == head).any()
    st.close()
    js.close()


def test_full_store_raises_store_full(tmp_path):
    from repro_torch.core.dbs_host import StoreFull
    st = CheckpointStore(str(tmp_path / "ck.dbs"), capacity_bytes=1 << 20)
    tree = {"w": torch.zeros(1 << 18)}          # 1 MiB; 64 extents: 8 MiB
    with pytest.raises(StoreFull):
        for step in range(10):                  # every version kept
            st.save("train", step, tree, keep_last=100)
    assert step > 1 and not st.dev.free
    assert isinstance(StoreFull("x"), IOError)


def test_tree_past_the_volume_raises_store_full(tmp_path):
    """A tree larger than the volume raises ``StoreFull`` before it writes
    (the reference's page table raises ``IndexError``); the last version
    still restores."""
    from repro_torch.core.dbs_host import StoreFull
    st = CheckpointStore(str(tmp_path / "ck.dbs"), capacity_bytes=1 << 20)
    small = {"w": torch.arange(1024, dtype=torch.float32)}
    st.save("train", 1, small)
    with pytest.raises(StoreFull):
        st.save("train", 2, {"w": torch.zeros(3 << 20)})   # 12 of 8 MiB
    step, back = st.restore("train", like=small)
    assert step == 1
    _assert_tree_eq(small, back)
    st.close()


def test_rebuild_after_fallback_matches_reference(tmp_path):
    """A donor whose head is torn streams its newest snapshot: the same
    summary and rebuilt file as the reference's, and the port's donor
    keeps no clone (the reference's ``stream_store`` deletes its own)."""
    out = {}
    for pkg, rep, conv in (("j", JReplicated, lambda t: t),
                           ("t", ReplicatedCheckpoint, _to_torch)):
        dirs = [str(tmp_path / pkg / d) for d in "ab"]
        rc = rep(dirs, capacity_bytes=1 << 22)
        rc.save("train", 4, conv(_j_tree(0)))
        rc.save("train", 5, conv(_j_tree(1)))
        rc.stores[0].dev.write("train", 0, b"\xff" * 4096)
        rc.fail(1)
        out[pkg] = rc.rebuild(1)
        assert sorted(rc.stores[0].dev.volumes) == ["train"]
        rc.close()
    assert out["t"] == out["j"]
    assert _read(tmp_path / "t" / "b" / "ckpt.dbs") == \
        _read(tmp_path / "j" / "b" / "ckpt.dbs")
