"""Port parity: the dry run — ``utils/op_stats.py``'s counting mode,
``launch/specs.py``'s cells on fake meshes, ``launch/dryrun.py``'s records
and ``launch/serve.py``.

Each group of cases opens its own fake world (the ``"fake"`` process-group
backend, this process rank 0) in a fixture and closes it after, so no
group outlives its cases for later files on the same worker.

- The collective count is the twin of ``tests/test_distributed.py``
  ``test_collective_parser_on_synthetic_hlo``, with its expectations: ten
  all-reduces of an fp32 (8,) tensor count 10 and 320 bytes, one
  all-gather to (16, 128) fp32 counts 1 and 8192 bytes; through
  ``torch.distributed`` (the in-place ``c10d`` ops) and through the
  functional collectives DTensor issues.
- Per-device FLOPs: ``[Shard(0), Replicate()] @ [Replicate(), Shard(1)]``,
  (4096, 2304) @ (2304, 9216) on a (16, 16) fake mesh counts exactly
  2 * 256 * 2304 * 576 FLOPs on rank 0; DTensor's run of the op at global
  shapes is not counted.
- Per-device bytes, the twin of ``test_dryrun_cell_compiles_on_8_devices``:
  ``per_device_bytes`` of ``gemma2-2b:train_4k`` and
  ``granite-moe-3b-a800m:decode_32k`` on a (2, 4) mesh equal the
  reference's exactly (7849397252 and 36020623104 bytes on this mesh,
  computed here in one JAX child with 8 host devices), with its leaf
  counts (75, 110) and ``tokens_per_step``; rank 0's local shards hold as
  many bytes.
- ``run_cell``: a smoke-config cell of each kind on a (2, 4) fake mesh has
  every output key, each number finite; a decode cell counts the paged
  kernel's entry and the fp32 prefill cell the flash kernel's, once a
  layer that has one, in fp32 and in the bf16 default plan alike (the
  kernels take both dtypes), and the train cell neither; the CLI writes
  its records. ``run_cell`` refuses to run over an initialised (real) process
  group.
- The striped decode's kernel route: each stripe's partial through the
  paged entry (plain version on the CPU) merges to the plain route's
  output, within atol 1e-5 (fp32, other summation orders).
- ``launch/serve.py``: ``serve`` on the CPU with the reference's
  ``init_params(PRNGKey(0))`` converted gives each request the reference's
  tokens: the reference's own engine's for gemma2-2b, an independent JAX
  greedy decode's for rwkv6-3b (the reference's engine cannot serve it).
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.launch.dryrun import fake_world, run_cell  # noqa: E402
from repro_torch.launch.mesh import local_init_method, make_mesh  # noqa: E402
from repro_torch.utils.op_stats import COLLECTIVES, OpCounter  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TWIN_CELLS = [("gemma2-2b", "train_4k"), ("granite-moe-3b-a800m", "decode_32k")]
RECORD_KEYS = ("arch", "shape", "mesh", "chips", "kind", "plan", "count_s",
               "flops_per_device", "bytes_per_device",
               "collective_bytes_per_device", "collectives",
               "model_flops_total", "hlo_useful_ratio", "t_compute",
               "t_memory", "t_collective", "bottleneck", "roofline_fraction",
               "analytic_state_bytes_per_device", "peak", "ops")


@pytest.fixture
def world16():
    with fake_world(16):
        yield


@pytest.fixture
def world256():
    with fake_world(256):
        yield make_mesh((16, 16), ("data", "model"), "cpu")


@pytest.fixture
def world8():
    with fake_world(8):
        yield make_mesh((2, 4), ("data", "model"), "cpu")


# ---------------------------------------------------------------------------
# the collective count
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("route", ["c10d", "functional"])
def test_collective_count(world16, route):
    import torch.distributed._functional_collectives as funcol
    x = torch.zeros(8)
    with OpCounter() as c:
        for _ in range(10):
            if route == "c10d":
                dist.all_reduce(x)
            else:
                x = funcol.all_reduce(x, "sum", dist.group.WORLD)
        if route == "c10d":
            dist.all_gather_into_tensor(torch.empty(16, 128),
                                        torch.zeros(1, 128))
        else:
            funcol.all_gather_tensor(torch.zeros(1, 128), 0,
                                     dist.group.WORLD)
    stats = c.collective_stats()
    assert stats["all-reduce"] == {"count": 10, "bytes": 10 * 32}
    assert stats["all-gather"] == {"count": 1, "bytes": 16 * 128 * 4}
    assert set(stats) <= set(COLLECTIVES)
    costs = c.module_costs()
    assert costs["collective_count"] == 11
    assert costs["collective_bytes"] == 320 + 8192


# ---------------------------------------------------------------------------
# per-device FLOPs
# ---------------------------------------------------------------------------
def test_per_device_flops_known_answer(world256):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = world256
    with FakeTensorMode():
        a = distribute_tensor(torch.empty(4096, 2304), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        b = distribute_tensor(torch.empty(2304, 9216), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)
        with OpCounter() as c:
            out = a @ b
    assert tuple(out.to_local().shape) == (256, 576)
    assert c.module_costs()["flops"] == 2 * 256 * 2304 * 576
    assert c.count_ops() == {"dot": 1}
    assert c.collective_stats() == {}


# ---------------------------------------------------------------------------
# per-device bytes against the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_bytes():
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        os.environ["JAX_PLATFORMS"] = "cpu"
        import json
        import jax
        import numpy as np
        from jax.sharding import Mesh
        from repro.configs import SHAPES, get_config
        from repro.launch.specs import build_cell, per_device_bytes
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                    ("data", "model"))
        out = {{}}
        for arch, shape in {TWIN_CELLS!r}:
            cell = build_cell(get_config(arch), SHAPES[shape], mesh)
            out[arch + ":" + shape] = dict(
                bytes=per_device_bytes(mesh, cell.args),
                leaves=len(jax.tree.leaves(cell.args)),
                tokens=cell.tokens_per_step)
        print(json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape", TWIN_CELLS)
def test_per_device_bytes_match_reference(world8, reference_bytes, arch,
                                          shape):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.specs import (build_cell, local_bytes,
                                          per_device_bytes)
    from repro_torch.models.model import tree_leaves
    want = reference_bytes[f"{arch}:{shape}"]
    with FakeTensorMode(allow_non_fake_inputs=True):
        cell = build_cell(get_config(arch), SHAPES[shape], world8)
        got = per_device_bytes(world8, cell.args)
        assert got == want["bytes"]
        assert local_bytes(cell.args) == got
        assert len(tree_leaves(cell.args)) == want["leaves"]
        assert cell.tokens_per_step == want["tokens"]


# ---------------------------------------------------------------------------
# run_cell
# ---------------------------------------------------------------------------
SMOKE_SHAPES = {"train_4k": (32, 4), "prefill_32k": (64, 8),
                "decode_32k": (64, 8)}
FP32 = {"compute_dtype": "float32", "param_dtype": "float32"}


def _smoke_record(shape_name, overrides=None):
    seq, batch = SMOKE_SHAPES[shape_name]
    shape = dataclasses.replace(SHAPES[shape_name], seq_len=seq,
                                global_batch=batch)
    return run_cell("gemma2-2b", shape_name, False, overrides,
                    mesh_shape=(2, 4), config=t_smoke("gemma2-2b"),
                    shape=shape)


def _finite(x) -> bool:
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, bool) or not isinstance(x, (int, float)):
        return True
    return math.isfinite(x)


@pytest.mark.parametrize("shape_name,overrides", [
    ("train_4k", None), ("prefill_32k", FP32), ("decode_32k", FP32),
    ("decode_32k", None)])
def test_run_cell_records(shape_name, overrides):
    r = _smoke_record(shape_name, overrides)
    for k in RECORD_KEYS:
        assert k in r, k
    assert _finite(r)
    assert r["mesh"] == {"data": 2, "model": 4} and r["chips"] == 8
    assert r["kind"] == SHAPES[shape_name].kind
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert r["analytic_state_bytes_per_device"] == r["local_state_bytes"]
    assert r["peak"]["compute_dtype"] == r["plan"]["compute_dtype"]
    cfg = t_smoke("gemma2-2b")
    n_global = sum(cfg.layer_kind(i) == "global"
                   for i in range(cfg.n_layers))
    ops = r["ops"]
    if shape_name == "decode_32k":
        assert ops.get("paged_attention_lse") == n_global
    elif shape_name == "prefill_32k":
        assert ops.get("flash_attention") == cfg.n_layers
    else:
        assert not any(k.startswith(("paged", "flash")) for k in ops)
    assert not dist.is_initialized()


def test_cli_writes_its_records(tmp_path):
    from repro_torch.launch.dryrun import main
    out = tmp_path / "cells.json"
    with pytest.raises(SystemExit) as done:
        main(["--arch", "gemma2-2b", "--shape", "decode_32k", "--smoke",
              "--mesh", "2,4", "--global-batch", "8", "--plan",
              "compute_dtype=float32", "--plan", "param_dtype=float32",
              "--out", str(out)])
    assert done.value.code == 0
    (r,) = json.loads(out.read_text())
    assert r["status"] == "ok" and r["global_batch"] == 8
    assert r["plan"]["compute_dtype"] == "float32"
    assert r["ops"].get("paged_attention_lse", 0) > 0


def test_run_cell_refuses_a_real_group():
    dist.init_process_group("gloo", init_method=local_init_method(),
                            world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="real group"):
            _smoke_record("decode_32k")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the striped decode's kernel route
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stride,stripe_slice,window", [
    (1, True, 0), (4, True, 0), (4, False, 0), (4, True, 9)])
def test_kernel_stripes_merge_to_the_plain_read(stride, stripe_slice,
                                                window):
    from repro_torch.distributed.collectives import _kernel_partial
    from repro_torch.models import attention as attn
    b, h, kv, d, page, p_max = 3, 4, 2, 8, 4, 8
    g = torch.Generator().manual_seed(7)
    pools = [torch.randn(b * p_max, page, kv, d, generator=g)
             for _ in range(2)]
    table = torch.arange(b * p_max, dtype=torch.int32).reshape(b, p_max)
    q = torch.randn(b, 1, h, d, generator=g)
    q_pos = torch.tensor([[5], [17], [31]], dtype=torch.int32)
    parts = {"kernel": [], "plain": []}
    for rank in range(stride):
        parts["kernel"].append(_kernel_partial(
            q, *pools, table, q_pos, stride, rank, stripe_slice,
            window=window, logit_cap=0.0, scale=None))
        parts["plain"].append(attn.paged_decode_attention(
            q, *pools, table, q_pos, window=window, page_owner_stride=stride,
            owner_rank=rank, stripe_slice=stripe_slice))
    got = {k: attn.merge_partials(*(torch.stack([p[i] for p in v])
                                    for i in range(3)))
           for k, v in parts.items()}
    torch.testing.assert_close(got["kernel"], got["plain"], atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# a cell's DTensors reaching a kernel entry with no dispatch mode on the stack
# ---------------------------------------------------------------------------
def test_prefill_cell_hands_the_flash_entry_local_shards(monkeypatch):
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.specs import build_cell
    from repro_torch.models.model import prefill, tree_map
    seen = []
    launch = fk._flash

    def spy(q, *args):
        seen.append(type(q))
        return launch(q, *args)
    monkeypatch.setattr(fk, "_flash", spy)
    cfg = t_smoke("gemma2-2b")
    seq, batch = SMOKE_SHAPES["prefill_32k"]
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=seq,
                                global_batch=batch)
    dist.init_process_group("gloo", init_method=local_init_method(),
                            world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        cell = build_cell(cfg, shape, mesh, dataclasses.replace(
            _plan(cfg, shape), compute_dtype="float32",
            param_dtype="float32"))
        assert cell.plan.attn_impl == "cuda"
        params, tokens, caches = tree_map(
            lambda t: t.to_local().clone(), list(cell.args))
        want, _ = prefill(params, tokens, cfg, cell.plan, caches)
        seen.clear()
        got, _ = cell.step(*cell.args)
    finally:
        dist.destroy_process_group()
    assert seen == [torch.Tensor] * cfg.n_layers
    assert type(got).__name__ == "DTensor"
    torch.testing.assert_close(got.to_local(), want, atol=1e-5, rtol=1e-5)


def _plan(cfg, shape):
    from repro_torch.configs.base import default_plan
    return default_plan(cfg, shape, 1, data_shards=1)


# ---------------------------------------------------------------------------
# launch/serve.py
# ---------------------------------------------------------------------------
def _launcher_prompts(cfg, n=6):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, size=(8,)) for _ in range(n)]


@pytest.mark.parametrize("arch", ["gemma2-2b", "rwkv6-3b"])
def test_serve_launcher_gives_the_reference_tokens(arch):
    import jax
    import jax.numpy as jnp
    from repro.configs import smoke_config as j_smoke
    from repro.configs.base import ExecutionPlan as JPlan
    from repro.models import init_params as j_init
    from repro.models import model as JM
    from repro_torch.core.convert import params_from_numpy
    from repro_torch.launch.serve import serve
    jc, tc = j_smoke(arch), t_smoke(arch)
    jp = j_init(jax.random.PRNGKey(0), jc)
    got = serve(tc, params_from_numpy(tc, jax.device_get(jp), "cpu"),
                device="cpu")
    prompts = _launcher_prompts(jc)
    if arch == "rwkv6-3b":
        # the reference's engine cannot serve a pure-recurrent net: greedy
        # decode by its model functions, one request at a time: prefill of
        # the prompt, then decode steps from its last token, as the
        # engine's own first step does (tests/test_torch_serving_rwkv.py)
        plan = JPlan(remat="none", attn_impl="chunked",
                     compute_dtype="float32")
        step = jax.jit(JM.decode_step, static_argnums=(3, 4))
        want = {}
        for rid, prompt in enumerate(prompts):
            cache = JM.init_cache(jc, 1, 8, dtype=jnp.float32)
            _, cache = JM.prefill(jp, jnp.asarray(prompt)[None], jc, plan,
                                  cache)
            toks = [int(prompt[-1])]
            for t in range(8):
                lg, cache = step(jp, jnp.asarray(toks[-1:]),
                                 jnp.asarray([8 + t], jnp.int32), jc, plan,
                                 cache)
                toks.append(int(jnp.argmax(lg[0])))
            want[rid] = toks[1:]
    else:
        from repro.serving import GenRequest as JGen
        from repro.serving import ServeEngine as JServe
        eng = JServe(jc, jp, n_slots=4, max_len=128, n_queues=2)
        for rid, prompt in enumerate(prompts):
            eng.submit(JGen(req_id=rid, prompt=prompt, max_new=8))
        want = eng.run(max_steps=6 * 8 + 20)
    assert {k: list(v) for k, v in got.items()} == \
        {k: list(v) for k, v in want.items()}
