"""Port parity: the elastic restore on gloo meshes, and the elastic demo.

The twin of ``tests/test_checkpoint.py::test_elastic_restore_resharding``
and of ``python -m repro.launch.elastic``. One spawn of 4 processes runs
worlds of 4, 2 and 1 ranks in turn (each a new gloo group over the same
processes) and restores one checkpoint of a smoke model's parameters
(written without a mesh) onto meshes (2, 2), (2, 1) and (1, 1) with the
planner's placements: every rank's ``to_local()`` must equal, bit for bit,
the slice of the saved leaf it should hold, and the 1-rank mesh's
DTensors must equal the saved tree. On (2, 2) the ranks also restore a
checkpoint the reference wrote, and save the restored DTensors from the
mesh: that file must equal, byte for byte, the same tree saved without a
mesh, and a save into stores too small for it raises on every rank. The demo runs as its two jobs, (2, 2) then (2, 1), on gloo, and must
meet the reference's loss condition.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ARCH = "granite-3-8b"
WORLDS = (((2, 2), 4), ((2, 1), 2), ((1, 1), 1))


def _tree_np(tree):
    """A torch tree as numpy (pickled into the workers)."""
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_np(v) for v in tree)
    return tree.numpy()


def _tree_torch(tree):
    if isinstance(tree, dict):
        return {k: _tree_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _expected_local(full, mesh, placements):
    """The block of ``full`` a rank holds under ``placements``: each mesh
    dim in order cuts its dim into even chunks and keeps the rank's."""
    coord = mesh.get_coordinate()
    t = full
    for i, p in enumerate(placements):
        if p.is_shard():
            t = torch.chunk(t, mesh.size(i), dim=p.dim)[coord[i]]
    return t


def _check(tree, like, mesh, placements):
    """(leaves, leaves whose local block is bit-equal, sharded leaves)."""
    from repro_torch.checkpoint.store import _flatten, _flatten_up_to
    got, want = _flatten(tree)[0], _flatten(like)[0]
    places = _flatten_up_to(like, placements)
    same = sharded = 0
    for g, w, p in zip(got, want, places):
        assert type(g).__name__ == "DTensor"
        assert list(g.placements) == list(p)
        exp = _expected_local(w, mesh, p)
        loc = g.to_local()
        same += int(loc.dtype == exp.dtype and loc.shape == exp.shape
                    and torch.equal(loc, exp))
        sharded += int(any(x.is_shard() for x in p))
    return len(got), same, sharded


def _save_into_full_stores(work, mesh):
    """A 16 MiB DTensor saved from the mesh into stores of 8 MiB: the
    error rank 0 meets, as each rank sees it (a name, or None)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.checkpoint import CheckpointStore, ReplicatedCheckpoint
    tree = {"w": distribute_tensor(torch.zeros(4, 1 << 20), mesh,
                                   [Shard(0), Shard(1)])}
    seen = []
    for make in (lambda: CheckpointStore(f"{work}/full.dbs",
                                         capacity_bytes=1 << 20, mesh=mesh),
                 lambda: ReplicatedCheckpoint([f"{work}/f0", f"{work}/f1"],
                                              capacity_bytes=1 << 20,
                                              mesh=mesh)):
        st = make()
        try:
            st.save("full", 1, tree)
            seen.append(None)
        except IOError as e:
            seen.append(type(e).__name__)
        st.close()
        dist.barrier()
    return seen


def _worker(rank, work, saved_np, ref_np):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointStore, ReplicatedCheckpoint
    from repro_torch.configs import ExecutionPlan, smoke_config
    from repro_torch.distributed.planner import Planner
    from repro_torch.launch.mesh import make_mesh
    saved, ref = _tree_torch(saved_np), _tree_torch(ref_np)
    cfg, plan = smoke_config(ARCH), ExecutionPlan()
    res = {}
    for n, (shape, world) in enumerate(WORLDS):
        if rank >= world:
            break
        dist.init_process_group("gloo", init_method=f"file://{work}/pg{n}",
                                world_size=world, rank=rank)
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        key = f"{shape[0]}x{shape[1]}"
        pl = Planner(mesh, cfg, plan).shardings(saved)
        rc = ReplicatedCheckpoint([f"{work}/a", f"{work}/b"],
                                  capacity_bytes=1 << 24, mesh=mesh)
        step, back = rc.restore("params", like=saved, mesh=mesh,
                                placements=pl)
        rc.close()
        res[key] = dict(zip(("leaves", "equal", "sharded"),
                            _check(back, saved, mesh, pl)), step=step)
        if world == 4:
            st = CheckpointStore(f"{work}/ref.dbs", mesh=mesh)
            rpl = Planner(mesh, cfg, plan).shardings(ref)
            step, rback = st.restore("ref", like=ref, mesh=mesh,
                                     placements=rpl)
            st.close()
            res["ref"] = dict(zip(("leaves", "equal", "sharded"),
                                  _check(rback, ref, mesh, rpl)), step=step)
            out = ReplicatedCheckpoint([f"{work}/m0", f"{work}/m1"],
                                       capacity_bytes=1 << 24, mesh=mesh)
            out.save("params", 7, back)
            out.close()
            res["full_save_raises"] = _save_into_full_stores(work, mesh)
            try:
                make_mesh((2, 1), ("data", "model"), "cpu")
            except ValueError:
                res["world_mismatch_raises"] = True
            try:
                make_mesh((2, 2), ("data", "model"), "cuda")
            except RuntimeError:
                res["no_card_raises"] = True
        if world == 1:
            from repro_torch.checkpoint.store import _flatten
            res["one_rank_full_equal"] = all(
                torch.equal(b.full_tensor(), s) for b, s in zip(
                    _flatten(back)[0], _flatten(saved)[0]))
        dist.barrier()
        dist.destroy_process_group()
    with open(f"{work}/rank{rank}.json", "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    import jax
    import torch.multiprocessing as mp
    from repro.checkpoint import CheckpointStore as JStore
    from repro.configs import smoke_config as j_smoke
    from repro.models import init_params as j_init
    from repro_torch.checkpoint import ReplicatedCheckpoint
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params
    work = str(tmp_path_factory.mktemp("elastic-restore"))
    saved = init_params(torch.Generator().manual_seed(0),
                        smoke_config(ARCH))
    rc = ReplicatedCheckpoint([f"{work}/a", f"{work}/b"],
                              capacity_bytes=1 << 24)
    rc.save("params", 3, saved)
    rc.close()
    plain = ReplicatedCheckpoint([f"{work}/p0", f"{work}/p1"],
                                 capacity_bytes=1 << 24)
    plain.save("params", 7, saved)
    plain.close()
    ref = jax.device_get(j_init(jax.random.PRNGKey(1), j_smoke(ARCH)))
    js = JStore(f"{work}/ref.dbs", capacity_bytes=1 << 24)
    js.save("ref", 5, ref)
    js.close()
    ref_np = jax.tree.map(np.asarray, ref)
    mp.spawn(_worker, args=(work, _tree_np(saved), ref_np), nprocs=4,
             join=True)
    ranks = []
    for r in range(4):
        with open(f"{work}/rank{r}.json") as f:
            ranks.append(json.load(f))
    return work, ranks


@pytest.mark.parametrize("mesh", ["2x2", "2x1"])
def test_restore_resharded_on_a_mesh(restored, mesh):
    _work, ranks = restored
    world = 4 if mesh == "2x2" else 2
    for r in range(world):
        got = ranks[r][mesh]
        assert got["step"] == 3
        assert got["equal"] == got["leaves"] > 0
        assert got["sharded"] > 0                # the planner split some
    for r in range(world, 4):
        assert mesh not in ranks[r]


def test_restore_onto_a_one_rank_mesh(restored):
    """``test_elastic_restore_resharding`` on the port: a restore onto a
    1-rank mesh gives DTensors equal to the saved tree."""
    _work, ranks = restored
    got = ranks[0]["1x1"]
    assert got["step"] == 3 and got["equal"] == got["leaves"]
    assert ranks[0]["one_rank_full_equal"]


def test_reference_checkpoint_restores_on_a_mesh(restored):
    _work, ranks = restored
    for r in range(4):
        got = ranks[r]["ref"]
        assert got["step"] == 5
        assert got["equal"] == got["leaves"] > 0 and got["sharded"] > 0


def test_save_from_a_mesh_equals_a_plain_save(restored):
    work, ranks = restored
    for a, b in (("m0", "p0"), ("m1", "p1")):
        with open(f"{work}/{a}/ckpt.dbs", "rb") as f:
            mesh_file = f.read()
        with open(f"{work}/{b}/ckpt.dbs", "rb") as f:
            assert mesh_file == f.read()


def test_a_failed_save_on_a_mesh_raises_on_every_rank(restored):
    """Rank 0 alone writes; its full store raises ``StoreFull`` on all
    four ranks, from a ``CheckpointStore`` and a ``ReplicatedCheckpoint``,
    and the ranks go on to their next collective together."""
    _work, ranks = restored
    for r in ranks:
        assert r["full_save_raises"] == ["StoreFull", "StoreFull"]


def test_make_mesh_refuses_what_the_world_cannot_give(restored):
    _work, ranks = restored
    assert all(r["world_mismatch_raises"] for r in ranks)
    if not torch.cuda.is_available():
        assert all(r["no_card_raises"] for r in ranks)


def test_elastic_demo_across_a_resharding_restart(tmp_path):
    """``python -m repro_torch.launch.elastic --device cpu`` as two jobs,
    (2, 2) then (2, 1): phase 2 restores step 4 and meets the reference's
    condition ``loss2 < loss1 + 0.2``."""
    from repro_torch.launch import elastic
    out = elastic.main(["--device", "cpu", "--mesh1", "2,2", "--mesh2",
                        "2,1", "--dir", str(tmp_path)])
    assert out["phase2"]["restored"] == 4
    assert out["phase2"]["mesh"] == [2, 1]
    assert out["phase2"]["loss"] < out["phase1"]["loss"] + 0.2
    assert np.isfinite([out["phase1"]["loss"], out["phase2"]["loss"]]).all()
    assert os.path.exists(tmp_path / "a" / "ckpt.dbs")
