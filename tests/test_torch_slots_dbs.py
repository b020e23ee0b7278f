"""Port parity: ``repro_torch.core.slots``/``dbs`` against ``repro.core``.

Random op sequences in the style of tests/test_dbs_properties.py (create,
snapshot, clone, ``write_pages`` with duplicate-page groups, masked lanes
and allocation starvation, unmap, delete), made with numpy from a seed and
fed to both packages. After every op each ``DBSState`` leaf of the port
equals the JAX leaf bit for bit (the int64 bitmap compared as uint32), and
so does every returned id and ``WriteOps`` lane. The slot ring and table
get the same treatment through ``transact``/``admit``/``retire``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import dbs as jdbs  # noqa: E402
from repro.core import slots as jslots  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import dbs as tdbs  # noqa: E402
from repro_torch.core import slots as tslots  # noqa: E402

CPU = torch.device("cpu")


def _assert_leaves_equal(jx, pt, where=""):
    want = jax.device_get(dataclasses.asdict(jx))
    got = convert.to_numpy(pt)

    def cmp(a, b, path):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                cmp(a[k], b[k], f"{path}.{k}")
            return
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        assert np.array_equal(a, b), (where, path, a, b)
    cmp(want, got, "")


def _eq(jx_arr, pt_arr, where=""):
    a = np.asarray(jax.device_get(jx_arr))
    b = pt_arr.numpy()
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), (where, a, b)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("geom", [(24, 4, 8, 8), (10, 3, 6, 12)])
def test_random_dbs_ops_match(seed, geom):
    """(extents, volumes, pages, lanes): the second geometry has more lanes
    than free extents, so batches starve."""
    n_e, n_v, n_p, b = geom
    rng = np.random.default_rng(seed)
    js = jdbs.make_state(n_e, n_v, n_p)
    ts = tdbs.make_state(n_e, n_v, n_p, device=CPU)
    vols = []
    for step in range(28):
        op = rng.choice(["create", "write", "write", "write", "snapshot",
                         "clone", "unmap", "delete"])
        if op == "create" or not vols:
            js, jv = jdbs.create_volume(js)
            ts, tv = tdbs.create_volume(ts)
            _eq(jv, tv, "create")
            if int(jv) >= 0:
                vols.append(int(jv))
        elif op == "write":
            per_lane = bool(rng.integers(2))
            vol = np.asarray(rng.choice(vols, b) if per_lane
                             else rng.choice(vols), np.int32)
            pages = rng.integers(0, n_p, b).astype(np.int32)
            blocks = rng.integers(0, 32, b).astype(np.int32)
            mask = rng.random(b) < 0.8
            js, jops = jdbs.write_pages(
                js, jnp.asarray(vol), jnp.asarray(pages),
                jnp.asarray(np.uint32(1) << blocks.astype(np.uint32)),
                jnp.asarray(mask))
            ts, tops = tdbs.write_pages(
                ts, torch.from_numpy(vol), torch.from_numpy(pages),
                torch.ones((), dtype=torch.int64)
                << torch.from_numpy(blocks).long(), torch.from_numpy(mask))
            for f in ("dst", "cow_src", "ok"):
                _eq(getattr(jops, f), getattr(tops, f), f"write {f}")
        elif op == "snapshot":
            v = int(rng.choice(vols))
            js, jsid = jdbs.snapshot(js, jnp.int32(v))
            ts, tsid = tdbs.snapshot(ts, v)
            _eq(jsid, tsid, "snapshot")
        elif op == "clone":
            v = int(rng.choice(vols))
            js, jv = jdbs.clone(js, jnp.int32(v))
            ts, tv = tdbs.clone(ts, v)
            _eq(jv, tv, "clone")
            if int(jv) >= 0:
                vols.append(int(jv))
        elif op == "unmap":
            v = int(rng.choice(vols))
            pages = rng.integers(0, n_p, 3).astype(np.int32)
            js = jdbs.unmap(js, jnp.int32(v), jnp.asarray(pages))
            ts = tdbs.unmap(ts, v, torch.from_numpy(pages))
        else:
            v = int(rng.choice(vols))
            js = jdbs.delete_volume(js, jnp.int32(v))
            ts = tdbs.delete_volume(ts, v)
            vols.remove(v)
        _assert_leaves_equal(js, ts, f"seed {seed} step {step} {op}")
        assert tdbs.stats(ts) == jdbs.stats(js)
        pages = jnp.arange(n_p, dtype=jnp.int32)
        for v in vols:
            _eq(jdbs.read_resolve(js, jnp.int32(v), pages),
                tdbs.read_resolve(ts, v, torch.arange(n_p)), "resolve")


@pytest.mark.parametrize("seed", range(4))
def test_random_slot_ops_match(seed):
    """admit/retire/transact with partial masks and starvation (more
    wanting lanes than free slots) leave every SlotTable leaf equal."""
    rng = np.random.default_rng(100 + seed)
    n, k = 12, 8
    jt = jslots.make_table(n)
    tt = tslots.make_table(n, CPU)
    held = []
    for step in range(20):
        want = rng.random(k) < 0.7
        vols = rng.integers(0, 4, k).astype(np.int32)
        queues = rng.integers(0, 4, k).astype(np.int32)
        op = rng.choice(["admit", "retire", "transact"])
        if op == "retire" and held:
            ids = held.pop(0)
            statuses = rng.integers(-1, 2, k).astype(np.int32)
            jt = jslots.retire(jt, jnp.asarray(ids),
                               statuses=jnp.asarray(statuses))
            tt = tslots.retire(tt, torch.from_numpy(ids),
                               statuses=torch.from_numpy(statuses))
        else:
            fn = jslots.transact if op == "transact" else jslots.admit
            tfn = tslots.transact if op == "transact" else tslots.admit
            jt, jids, jok = fn(jt, jnp.asarray(want), jnp.asarray(vols),
                               jnp.asarray(queues), jnp.int32(step))
            tt, tids, tok = tfn(tt, torch.from_numpy(want),
                                torch.from_numpy(vols),
                                torch.from_numpy(queues),
                                torch.tensor(step, dtype=torch.int32))
            _eq(jids, tids, "ids")
            _eq(jok, tok, "ok")
            if op == "admit":
                held.append(tids.numpy().copy())
        _assert_leaves_equal(jt, tt, f"seed {seed} step {step} {op}")
        assert int(tslots.n_active(tt)) == int(jslots.n_active(jt))


def test_bitmap_carried_as_uint32():
    """A full 32-bit bitmap (block 31 written) survives the int64 hold and
    the uint32 round trip through convert."""
    js = jdbs.make_state(4, 1, 2)
    ts = tdbs.make_state(4, 1, 2, device=CPU)
    js, _ = jdbs.create_volume(js)
    ts, _ = tdbs.create_volume(ts)
    bits = np.array([1 << 31, 1 | (1 << 30)], np.uint32)
    js, _ = jdbs.write_pages(js, jnp.int32(0), jnp.asarray([0, 0], jnp.int32),
                             jnp.asarray(bits))
    ts, _ = tdbs.write_pages(ts, 0, torch.tensor([0, 0]),
                             torch.from_numpy(bits.astype(np.int64)))
    _assert_leaves_equal(js, ts)
    back = convert.state_from_numpy(convert.to_numpy(ts), CPU)
    assert torch.equal(back.bitmap, ts.bitmap)
    assert convert.to_numpy(ts)["bitmap"][0] == np.uint32(0xC0000001)
