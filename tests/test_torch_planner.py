"""Port parity: the sharding planner, the machine profile and the int8
gradient compression, against the JAX package; no process group.

The planner's rules are pure shape logic, so both planners run on a mesh
given as axis sizes (the reference through a ``FakeMesh``, as
``tests/test_distributed.py`` does; the port through a dict), for every
arch at its published shapes (the reference's ``jax.eval_shape`` of
``init_params``, handed to the port as ``meta`` tensors), on the (16, 16)
and (2, 16, 16) production meshes and a (2, 4) mesh, with FSDP on and off.
Specs must be equal leaf for leaf, and ``to_placements`` must map each one.
Comparisons are exact.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro.configs import ALL_ARCHS  # noqa: E402
from repro.configs import ExecutionPlan as JPlan  # noqa: E402
from repro.configs import get_config as j_get  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.distributed import planner as JP  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models.model import unstack_params as j_unstack  # noqa: E402
from repro.utils import machine as JM  # noqa: E402
from repro_torch.configs import ExecutionPlan  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.distributed import planner as TP  # noqa: E402
from repro_torch.distributed.collectives import (  # noqa: E402
    compress_int8, decompress_int8)
from repro_torch.models import init_params as t_init  # noqa: E402
from repro_torch.models.model import init_cache as t_init_cache  # noqa: E402
from repro_torch.utils import machine as TM  # noqa: E402

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4}}


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _meta(tree):
    """The reference's shape tree as ``meta`` tensors (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_meta(v) for v in tree]
    return torch.empty(tuple(tree.shape), device="meta")


def _ref_specs(tree) -> dict:
    """path -> spec tuple of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(s) for path, s in flat}


def _port_specs(tree, path=()) -> dict:
    if TP._is_spec(tree):
        return {"/".join(str(k) for k in path): tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_port_specs(v, path + (k,)))
    return out


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    cfg = j_get(arch)
    return jax.eval_shape(lambda k: j_init(k, cfg), jax.random.PRNGKey(0))


def _check_placements(sizes, specs: dict):
    from torch.distributed.tensor import Replicate, Shard
    names = list(sizes)
    for spec in specs.values():
        pl = TP.to_placements(sizes, spec)
        assert len(pl) == len(names)
        for i, a in enumerate(names):
            dims = [d for d, e in enumerate(spec)
                    if e == a or (isinstance(e, tuple) and a in e)]
            assert pl[i] == (Shard(dims[0]) if dims else Replicate())


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_and_opt_specs_equal_reference(arch, mesh, fsdp):
    sizes = MESHES[mesh]
    shapes = _shapes(arch)
    jp = JP.Planner(FakeMesh(sizes), j_get(arch), JPlan(fsdp=fsdp))
    tp = TP.Planner(sizes, t_get(arch), ExecutionPlan(fsdp=fsdp))
    meta = _meta(shapes)
    j_specs, t_specs = jp.tree_specs(shapes), tp.tree_specs(meta)
    want, got = _ref_specs(j_specs), _port_specs(t_specs)
    assert got == want
    assert len(got) == len(jax.tree.leaves(shapes))
    _check_placements(sizes, got)
    for opt in ("adamw", "adafactor"):
        want = _ref_specs(jp.opt_specs(j_specs, shapes, opt))
        got = _port_specs(tp.opt_specs(t_specs, meta, opt))
        assert got == want, opt
        _check_placements(sizes, got)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_data_and_pool_specs_equal_reference(mesh):
    """``cache_specs`` on each arch's ``init_cache`` tree (paged and dense;
    the port's Mamba state is a dict where the reference's is a tuple, so
    a layer's leaves are compared as (shape, spec) pairs), ``data_spec``
    and ``pool_stride``."""
    sizes = MESHES[mesh]
    for arch in ALL_ARCHS:
        jcfg, tcfg = j_get(arch), t_get(arch)
        jp = JP.Planner(FakeMesh(sizes), jcfg, JPlan())
        tp = TP.Planner(sizes, tcfg, ExecutionPlan())
        for paged, batch, max_len in ((True, 32, 4096), (False, 8, 2048)):
            jc = jax.eval_shape(lambda: j_init_cache(jcfg, batch, max_len,
                                                     paged=paged))
            tc = t_init_cache(tcfg, batch, max_len, paged=paged,
                              device="meta")
            js, ts = jp.cache_specs(jc), tp.cache_specs(tc)
            assert len(js) == len(ts)
            for jl, tl, jcl, tcl in zip(js, ts, jc, tc):
                want = sorted(
                    (tuple(x.shape), tuple(s)) for x, s in zip(
                        jax.tree.leaves(jcl), jax.tree.leaves(
                            jl, is_leaf=lambda x: isinstance(
                                x, PartitionSpec))))
                got = sorted((tuple(x.shape), s) for x, s in zip(
                    _port_leaves(tcl), _port_specs(tl).values()))
                assert got == want, (arch, paged)
            _check_placements(sizes, {i: s for i, s in enumerate(
                v for layer in ts for v in _port_specs(layer).values())})
    jp = JP.Planner(FakeMesh(sizes), j_get("gemma2-2b"), JPlan())
    tp = TP.Planner(sizes, t_get("gemma2-2b"), ExecutionPlan())
    for shape in ((256, 4096), (64, 4096), (32, 1024), (8, 16), (1, 16),
                  (3,), (96, 7, 2)):
        assert tp.data_spec(shape) == tuple(jp.data_spec(shape)), shape
    for bs in (True, False):
        assert TP.pool_stride(sizes, bs) == JP.pool_stride(FakeMesh(sizes),
                                                           bs)


def _port_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _port_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _port_leaves(v)]
    return [tree]


def test_planner_divisibility_fallbacks():
    """The reference's cases (``tests/test_distributed.py``), on the port."""
    P = TP.P
    assert TP.pick({"data": 1, "model": 1}, (64, 32),
                   [P("data", "model")]) == ("data", "model")
    fm = {"data": 16, "model": 16}
    assert TP.pick(fm, (49155, 4096),
                   [P("model", None), P(None, "model")]) == (None, "model")
    assert TP.pick(fm, (2304, 1024), [P(None, "model")]) == (None, "model")
    assert TP.pick(fm, (40, 1536, 512),
                   [P("model", None, None), P(None, None, "model")]) == \
        (None, None, "model")
    assert TP.pick(fm, (256, 7168, 2048),
                   [P("model", None, None), P(None, None, "model")]) == \
        ("model", None, None)
    # a PartitionSpec's normalisation: a 1-tuple is its name, () is None
    assert P(("data",), ()) == tuple(PartitionSpec(("data",), ()))


def test_all_param_leaves_get_specs():
    """Every leaf of every arch's smoke tree gets a spec on a (1, 1) mesh:
    the port's own tree (layers unstacked) and the reference's unstacked
    tree give the same specs path for path."""
    sizes = {"data": 1, "model": 1}
    for arch in ALL_ARCHS:
        tcfg = t_smoke(arch)
        params = t_init(torch.Generator().manual_seed(0), tcfg)
        tp = TP.Planner(sizes, tcfg, ExecutionPlan())
        got = _port_specs(tp.tree_specs(params))
        assert len(got) == len(_port_leaves(params)), arch
        jcfg = j_smoke(arch)
        shapes = jax.eval_shape(lambda k: j_unstack(j_init(k, jcfg), jcfg),
                                jax.random.PRNGKey(0))
        jp = JP.Planner(FakeMesh(sizes), jcfg, JPlan())
        assert got == _ref_specs(jp.tree_specs(shapes)), arch


def test_to_placements_refuses_out_of_order_axes():
    from torch.distributed.tensor import Replicate, Shard
    sizes = {"pod": 2, "data": 16, "model": 16}
    assert TP.to_placements(sizes, (("pod", "data", "model"), None)) == \
        [Shard(0)] * 3
    assert TP.to_placements(sizes, (None, ("data", "model"))) == \
        [Replicate(), Shard(1), Shard(1)]
    with pytest.raises(ValueError):
        TP.to_placements(sizes, (("model", "data"),))
    with pytest.raises(ValueError):
        TP.to_placements(sizes, ("data", "data"))
    with pytest.raises(KeyError):
        TP.to_placements({"data": 2, "model": 4}, (("pod", "data"),))


@pytest.mark.parametrize("given", [
    {}, {"peak_flops": 1e15}, {"hbm_bw": 2e12, "link_bw": 1e11},
    {"peak_flops": 1e15, "hbm_bw": 2e12, "link_bw": 1e11}])
@pytest.mark.parametrize("env", [{}, {"REPRO_HBM_BW": "4e12"},
                                 {"REPRO_PEAK_FLOPS": "5e14",
                                  "REPRO_HBM_BW": "4e12",
                                  "REPRO_LINK_BW": "2e11"}])
def test_machine_profile_resolution_matches_reference(monkeypatch, given,
                                                      env):
    """Arguments, then ``REPRO_*``, then detection, then the assumed
    default: nothing detected on either side here, so the two differ only
    in the default's figures (the reference's v5e, the port's H100)."""
    for k in ("REPRO_PEAK_FLOPS", "REPRO_HBM_BW", "REPRO_LINK_BW"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(JM, "_detect", lambda: None)
    monkeypatch.setattr(TM, "_detect", lambda: None)
    j, t = JM.machine_profile(**given), TM.machine_profile(**given)

    def resolve(default):
        return {f: given.get(f, float(env[var]) if var in env
                             else getattr(default, f))
                for f, var in FIELDS}
    assert {f: getattr(j, f) for f, _ in FIELDS} == resolve(JM.V5E)
    assert {f: getattr(t, f) for f, _ in FIELDS} == resolve(TM.H100_SXM)
    assert t.assumed == j.assumed
    assert t.name.endswith("+overrides") == j.name.endswith("+overrides")


FIELDS = (("peak_flops", "REPRO_PEAK_FLOPS"), ("hbm_bw", "REPRO_HBM_BW"),
          ("link_bw", "REPRO_LINK_BW"))


def test_machine_profile_detects_the_h100(monkeypatch):
    for k in ("REPRO_PEAK_FLOPS", "REPRO_HBM_BW", "REPRO_LINK_BW"):
        monkeypatch.delenv(k, raising=False)
    prof = TM.profile_of("NVIDIA H100 80GB HBM3")
    assert prof == TM.H100_SXM
    assert (prof.peak_flops, prof.hbm_bw, prof.link_bw) == (989e12, 3.35e12,
                                                           50e9)
    assert TM.profile_of("NVIDIA GeForce RTX 4090") is None
    monkeypatch.setattr(TM, "_detect", lambda: prof)
    got = TM.machine_profile()
    assert (got.name, got.assumed) == ("h100-sxm", False)
    got = TM.machine_profile(hbm_bw=1e12)
    assert (got.name, got.hbm_bw, got.peak_flops) == (
        "h100-sxm+overrides", 1e12, 989e12)
    assert TM.HBM_BYTES_PER_S == 3.35e12 and TM.FP32_FLOPS_PER_S == 67e12
    assert TM.TF32X3_FLOPS_PER_S == 495e12 / 3


@pytest.mark.parametrize("shape,scale", [((128,), 3.0), ((64, 33), 0.01),
                                         ((7,), 1e5), ((16,), 0.0)])
def test_compress_int8_bit_equal_reference(shape, scale):
    from repro.distributed.collectives import compress_int8 as j_compress
    from repro.distributed.collectives import decompress_int8 as j_decomp
    x = (np.random.default_rng(0).standard_normal(shape) * scale
         ).astype(np.float32)
    jq, js = j_compress(jnp.asarray(x))
    tq, ts = compress_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    np.testing.assert_array_equal(decompress_int8(tq, ts).numpy(),
                                  np.asarray(j_decomp(jq, js)))


def test_gradient_compression_roundtrip():
    """``tests/test_training_math.py::test_gradient_compression_roundtrip``
    on the port."""
    x = torch.randn(128, generator=torch.Generator().manual_seed(0)) * 3.0
    q, s = compress_int8(x)
    back = decompress_int8(q, s)
    assert q.dtype == torch.int8
    np.testing.assert_allclose(back.numpy(), x.numpy(),
                               atol=float(s) * 0.51 + 1e-6)


def test_constrain_is_a_no_op_unless_installed():
    """``runtime.constrain`` returns a plain tensor as it is, installed
    placements or not; ``apply_block`` calls it after each layer."""
    from repro_torch.distributed import runtime
    x = torch.ones(3)
    assert runtime.get_activation_sharding() is None
    assert runtime.constrain(x) is x
    with runtime.activation_sharding("mesh", ["placement"]):
        assert runtime.get_activation_sharding() == ("mesh", ("placement",))
        assert runtime.constrain(x) is x
    assert runtime.get_activation_sharding() is None
