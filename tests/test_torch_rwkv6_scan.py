"""Port parity: the RWKV-6 chunked-scan op and its plain versions.

The same numpy inputs go through the JAX package's ``rwkv6_scan`` (the
Pallas kernel in interpret mode on the CPU, as tests/test_kernels.py runs
it) and ``rwkv6_scan_reference`` (the step-by-step oracle), and through the
port's ``rwkv6_scan`` (on the CPU its wrapper runs the plain chunked
version), ``rwkv6_chunked_ref`` and ``rwkv6_scan_ref``. fp32 tolerance
atol 1e-4 and rtol 1e-4 (the chunked and step forms, and the two
packages, sum in other orders; outputs are of order 1 to 10).

The bf16 form (inputs rounded to bf16, as the Pallas kernel takes them):
both packages compute in fp32 and round y to bf16 (the kernel and the
chunked version; the step oracles return fp32), the state fp32. The state
within the fp32 tolerance; y within it plus one bf16 step of |y| (rtol
2^-7 more): two fp32 values that close may round to neighbouring bf16
values. The wrapper refuses r, k, v and logw of mixed dtypes and dtypes
other than fp32 and bf16.

The CUDA kernel itself is held against these plain versions on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rwkv6_scan import rwkv6_scan as j_scan  # noqa: E402
from repro.kernels.rwkv6_scan import (  # noqa: E402
    rwkv6_scan_reference as j_ref)
from repro_torch.kernels.rwkv6_scan import (  # noqa: E402
    PLAIN_CALLS, LAUNCHES, rwkv6_chunked_ref, rwkv6_scan, rwkv6_scan_fwd,
    rwkv6_scan_reference, rwkv6_scan_ref)
from repro_torch.kernels.rwkv6_scan import kernel as scan_kernel  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
Y_TOL = {"float32": TOL, "bfloat16": dict(atol=1e-4, rtol=1e-4 + 2 ** -7)}


def _round_bf16(*arrays):
    """fp32 arrays rounded to bf16 values (still fp32, exactly)."""
    return [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
            for a in arrays]


def _inputs(b, s, h, hd, seed, with_state=False):
    """The distribution of tests/test_kernels.py's sweep, from numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((b, s, h, hd)) * 0.5).astype(
        np.float32)
    u = (rng.standard_normal((h, hd)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((b, h, hd, hd)).astype(np.float32)
          if with_state else np.zeros((b, h, hd, hd), np.float32))
    return r, k, v, logw, u, s0


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,hd,chunk", [
    (2, 128, 3, 64, 32), (1, 64, 2, 32, 64), (2, 96, 4, 16, 16),
])
def test_scan_matches_reference(b, s, h, hd, chunk, dtype):
    """The geometries of the reference's kernel sweep: the port's op and
    both plain versions against JAX's kernel and oracle, in fp32 and on
    bf16 inputs (``u`` too; the module note's tolerances). y comes back in
    r's dtype from the kernel and the chunked version of both packages."""
    r, k, v, logw, u, s0 = _inputs(b, s, h, hd, seed=s + hd)
    if dtype == "bfloat16":
        r, k, v, logw, u = _round_bf16(r, k, v, logw, u)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jy, js = j_scan(*(jnp.asarray(a, jd) for a in (r, k, v, logw, u)),
                    chunk=chunk)
    assert jy.dtype == jd and js.dtype == jnp.float32
    ry, rs = j_ref(*map(jnp.asarray, (r, k, v, logw, u, s0)))
    jy, js, ry, rs = (np.asarray(jax.device_get(a), np.float32)
                      for a in (jy, js, ry, rs))
    tr = [t.to(td) for t in _t(r, k, v, logw, u)]
    scan_kernel.reset_counts()
    got = {
        "op": rwkv6_scan(*tr, chunk=chunk),
        "chunked": rwkv6_chunked_ref(*tr, chunk=chunk),
        "step": rwkv6_scan_ref(*tr, torch.from_numpy(s0)),
        "reference alias": rwkv6_scan_reference(*tr, torch.from_numpy(s0)),
    }
    # on the CPU the wrapper runs its plain version, never the kernel
    assert PLAIN_CALLS["rwkv6_scan"] == 1 and LAUNCHES["rwkv6_scan"] == 0
    assert not any(scan_kernel.LAUNCHES_BY_DTYPE.values())
    for name in ("op", "chunked"):
        assert got[name][0].dtype == td, name
    for name, (y, st) in got.items():
        assert st.dtype == torch.float32, name
        for want_y, want_s in ((jy, js), (ry, rs)):
            np.testing.assert_allclose(y.float().numpy(), want_y,
                                       **Y_TOL[dtype], err_msg=name)
            np.testing.assert_allclose(st.numpy(), want_s, **TOL,
                                       err_msg=name)


@pytest.mark.parametrize("s,chunk", [(64, 16), (100, 32), (1, 64)])
def test_scan_carries_a_starting_state(s, chunk):
    """A non-zero ``s0`` (the serving path's carried state) against the
    step oracle of both packages; S = 1 is the decode shape."""
    r, k, v, logw, u, s0 = _inputs(3, s, 2, 32, seed=7 + s,
                                   with_state=True)
    ry, rs = (np.asarray(a) for a in jax.device_get(
        j_ref(*map(jnp.asarray, (r, k, v, logw, u, s0)))))
    tr = _t(r, k, v, logw, u)
    for y, st in (rwkv6_scan(*tr, chunk=chunk, s0=torch.from_numpy(s0)),
                  rwkv6_chunked_ref(*tr, torch.from_numpy(s0), chunk=chunk),
                  rwkv6_scan_ref(*tr, torch.from_numpy(s0))):
        np.testing.assert_allclose(y.numpy(), ry, **TOL)
        np.testing.assert_allclose(st.numpy(), rs, **TOL)


@pytest.mark.parametrize("s,chunk", [(100, 64), (97, 64), (61, 16)])
def test_scan_ragged_and_prime_lengths(s, chunk):
    """A ragged last chunk (100 = 64 + 36) and prime lengths, where the TPU
    wrapper halves its chunk down to one token: the port keeps the chunk
    and takes a short last one; all agree with JAX's kernel and oracle."""
    r, k, v, logw, u, s0 = _inputs(1, s, 2, 16, seed=s)
    jy, js = (np.asarray(a) for a in jax.device_get(
        j_scan(*map(jnp.asarray, (r, k, v, logw, u)), chunk=chunk)))
    ry, rs = (np.asarray(a) for a in jax.device_get(
        j_ref(*map(jnp.asarray, (r, k, v, logw, u, s0)))))
    y, st = rwkv6_scan(*_t(r, k, v, logw, u), chunk=chunk)
    for want_y, want_s in ((jy, js), (ry, rs)):
        np.testing.assert_allclose(y.numpy(), want_y, **TOL)
        np.testing.assert_allclose(st.numpy(), want_s, **TOL)


@pytest.mark.parametrize("mix", ["k", "v", "logw", "r"])
def test_wrapper_refuses_mixed_dtypes(mix):
    """r, k, v and logw share one dtype, fp32, bf16 or fp16, and u is fp32
    or of r's 16-bit dtype: a mix (fp16 among bf16 inputs, or an fp16 u
    over them) or fp64 raises before any dispatch (no input is cast to
    reach a form); bf16 inputs with an fp32 or a bf16 u pass."""
    bf = [t.bfloat16() for t in _t(*_inputs(1, 8, 2, 16, seed=0)[:5])]
    args = dict(zip(("r", "k", "v", "logw", "u"), bf))
    odd = dict(args, **{mix: args[mix].float()})
    with pytest.raises(TypeError, match="one dtype"):
        rwkv6_scan_fwd(*odd.values())
    for bad in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            rwkv6_scan_fwd(*dict(args, **{mix: args[mix].to(bad)}).values())
        with pytest.raises(TypeError, match="u"):
            rwkv6_scan_fwd(*dict(args, u=args["u"].to(bad)).values())
    for u in (args["u"], args["u"].float()):
        y, st = rwkv6_scan_fwd(*dict(args, u=u).values())
        assert y.dtype == torch.bfloat16 and st.dtype == torch.float32


def test_wrapper_checks_its_inputs():
    """dtype, shape and layout are checked before any dispatch; the model
    layout's strided views are taken as they are."""
    r, k, v, logw, u, _ = _t(*_inputs(1, 8, 2, 16, seed=0))
    with pytest.raises(TypeError):
        rwkv6_scan_fwd(r.double(), k, v, logw, u)
    with pytest.raises(ValueError, match="shape"):
        rwkv6_scan_fwd(r, k, v, logw, u[:1])
    with pytest.raises(ValueError, match="contiguous"):
        rwkv6_scan_fwd(r, k, v, logw.transpose(-1, -2).contiguous()
                       .transpose(-1, -2), u)
    with pytest.raises(ValueError, match="chunk"):
        rwkv6_scan_fwd(r, k, v, logw, u, chunk=0)
    # a (B,S,H,hd) view of a (B,H,S,hd) buffer: strides, no copy needed
    rt = r.transpose(1, 2).contiguous().transpose(1, 2)
    y, st = rwkv6_scan_fwd(rt, k, v, logw, u, chunk=4)
    want_y, want_s = rwkv6_scan_ref(r, k, v, logw, u,
                                    torch.zeros((1, 2, 16, 16)))
    torch.testing.assert_close(y, want_y, **TOL)
    torch.testing.assert_close(st, want_s, **TOL)


@pytest.mark.parametrize("dtype,size", [("float32", 4), ("bfloat16", 2)])
def test_bytes_formula_counts_the_input_dtype(dtype, size):
    """The dry run's bytes formula of the scan's entry (counted through its
    custom op under ``utils/op_stats.py``'s mode): r, k, v, logw, y and u
    at the inputs' element size, the state fp32 (4 bytes) whatever the
    inputs."""
    from repro_torch.utils.op_stats import OpCounter
    b, s, h, d = 1, 8, 2, 16
    r, k, v, logw, u, _ = (t.to(getattr(torch, dtype)) for t in _t(
        *_inputs(b, s, h, d, seed=0)))
    with OpCounter() as c:
        rwkv6_scan_fwd(r, k, v, logw, u)
    assert c.bytes == size * (5 * b * s * h * d + h * d) + 4 * b * h * d * d
