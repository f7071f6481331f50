"""The port's training ops against the JAX package on the CPU: the fused
encoder attention (forward and backward) against the Pallas kernels run
in interpret mode, the backward kernel's plain version against
``_bwd_direct(interpret=True)``, and the LayerNorm and GELU backward
against ``jax.grad``. The CUDA kernels are held against their plain
versions on the card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arsvt_tpu.ops.layernorm import layer_norm as jax_layer_norm
from arsvt_tpu.ops.mlp import gelu_tanh as jax_gelu_tanh
from arsvt_tpu.ops.pallas.flash_attention import _bwd_direct, _fwd_direct
from arsvt_tpu.ops.pallas.flash_attention import (
    fused_encoder_attention as jax_fused_encoder_attention,
)
from arsvt_tpu_torch.ops import build, encoder_attention
from arsvt_tpu_torch.ops.encoder_attention import (
    encoder_attention_bwd,
    encoder_attention_bwd_plain,
    fused_encoder_attention,
)
from arsvt_tpu_torch.ops.layernorm import layer_norm
from arsvt_tpu_torch.ops.mlp import gelu_tanh

torch.set_num_threads(1)  # tier-1 runs several xdist workers

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("s", [17, 64])
def test_fused_encoder_attention_matches_pallas_interpret(s):
    """fp32, b=2, D=128, H=2: the port's autograd Function (plain versions
    on the CPU) against JAX's custom VJP over the Pallas kernels in
    interpret mode, forward and the gradients of sum(out^2) with respect
    to all five inputs. Same fp32 arithmetic in another summation order:
    atol 5e-5, as tests/test_kernel_interpret.py holds the JAX kernel to
    its reference."""
    b, d, h = 2, 128, 2
    args = [_rand((b, s, d), 0), _rand((d, 3 * d), 1, 0.05),
            _rand((3 * d,), 2, 0.05), _rand((d, d), 3, 0.05),
            _rand((d,), 4, 0.05)]
    jargs = [jnp.asarray(a) for a in args]

    def jloss(*a):
        return jnp.sum(jax_fused_encoder_attention(*a, h, True) ** 2)

    jout = jax_fused_encoder_attention(*jargs, h, True)
    jgrads = jax.grad(jloss, argnums=tuple(range(5)))(*jargs)

    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fused_encoder_attention(*targs, h)
    tgrads = torch.autograd.grad((out ** 2).sum(), targs)
    np.testing.assert_allclose(_to_np(out), _to_np(jout), atol=3e-5)
    for name, got, ref in zip(("dy", "dwqkv", "dbqkv", "dwproj", "dbproj"),
                              tgrads, jgrads):
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(_to_np(got), _to_np(ref), atol=5e-5,
                                   err_msg=name)


@pytest.mark.parametrize("s", [1, 17, 63, 64, 65])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_plain_matches_pallas_bwd_direct_interpret(dtype, s):
    """The backward kernel's plain version against the Pallas backward
    kernel itself on the same (qkv, O, dO, lse), B=2 D=128 H=2, at S = 17
    and at the edges of the kernel's tiles of 64 queries and 64 keys (one
    row; one short of, at and one past a tile), which the card holds the
    kernel to this plain version at. fp32: summation order only, atol
    1e-5. bf16: both round dS and p to bf16 before their products; an
    order difference can flip single roundings and the final bf16 one, a
    bf16 ulp or two of each output: atol = rtol = 2^-6."""
    b, d, h = 2, 128, 2
    qkv, dout = _rand((b, s, 3 * d), 5), _rand((b, s, d), 6)
    jqkv = jnp.asarray(qkv).astype(_JAX[dtype])
    jout, jlse = _fwd_direct(jqkv, h, interpret=True)
    jdout = jnp.asarray(dout).astype(_JAX[dtype])
    ref = _bwd_direct(jqkv, jout, jdout, jlse, h, interpret=True)
    got = encoder_attention_bwd_plain(
        torch.from_numpy(_to_np(jqkv)).to(_TORCH[dtype]),
        torch.from_numpy(_to_np(jout)).to(_TORCH[dtype]),
        torch.from_numpy(_to_np(jdout)).to(_TORCH[dtype]),
        torch.from_numpy(_to_np(jlse)), h)
    tol = dict(atol=1e-5, rtol=0) if dtype == "float32" else dict(
        atol=2.0 ** -6, rtol=2.0 ** -6)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == _TORCH[dtype] and g.shape == (b, s, d)
        np.testing.assert_allclose(_to_np(g), _to_np(r), err_msg=name, **tol)


def test_fused_attention_under_inference_mode_runs_forward_only():
    """Serving and training share the Function; under inference_mode it
    builds no graph and gives the same output."""
    d, h = 128, 2
    args = [torch.from_numpy(a) for a in (
        _rand((1, 9, d), 7), _rand((d, 3 * d), 8, 0.05),
        _rand((3 * d,), 9, 0.05), _rand((d, d), 10, 0.05),
        _rand((d,), 11, 0.05))]
    with torch.inference_mode():
        served = fused_encoder_attention(*args, h)
    assert served.grad_fn is None
    trained = fused_encoder_attention(
        *[a.clone().requires_grad_(True) for a in args], h)
    assert trained.grad_fn is not None
    assert torch.equal(served, trained.detach())


def test_backward_wrapper_checks_and_counts_no_cpu_launch():
    b, s, d, h = 1, 5, 128, 2
    qkv = torch.zeros(b, s, 3 * d)
    out, lse = encoder_attention.encoder_attention_fwd(qkv, h)
    before = encoder_attention.BWD_LAUNCHES
    dq, dk, dv = encoder_attention_bwd(qkv, out, torch.zeros(b, s, d), lse, h)
    assert dq.shape == dk.shape == dv.shape == (b, s, d)
    assert encoder_attention.BWD_LAUNCHES == before
    with pytest.raises(ValueError, match="dout"):
        encoder_attention_bwd(qkv, out, torch.zeros(b, s, d,
                                                    dtype=torch.bfloat16),
                              lse, h)
    with pytest.raises(ValueError, match="lse"):
        encoder_attention_bwd(qkv, out, out, lse[:, :1], h)
    with pytest.raises(ValueError, match="head_dim"):
        encoder_attention_bwd(torch.zeros(b, s, 96), out[..., :32],
                              out[..., :32], lse, 2)


def test_backward_source_names_the_tpu_kernel_and_builds_for_sm90a():
    text = build.source_path("encoder_attention_bwd").read_text()
    assert "flash_attention.py::_bwd_kernel_direct" in text
    assert 'extern "C" int arsvt_encoder_attention_bwd' in text
    assert "cudaGetLastError" in text and "atomic" not in text.replace(
        "no atomics", "")
    cmd = build.nvcc_command(build.source_path("encoder_attention_bwd"),
                             build.library_path("encoder_attention_bwd"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert set(build.kernel_names()) >= {
        "encoder_attention_fwd", "encoder_attention_bwd", "fused_adamw"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_grads_match_jax(dtype):
    """Gradients of sum(LN(x) * w) with respect to x, scale and bias. Both
    use the closed form in fp32 and cast to the input dtypes. fp32: sum
    order only (the scale and bias gradients sum over 21 rows), atol 2e-5.
    bf16: a bf16 ulp of each output, atol = rtol = 2^-7."""
    x, scale, bias = _rand((3, 7, 128), 12, 3.0), _rand((128,), 13), _rand(
        (128,), 14)
    w = _rand((3, 7, 128), 15)
    dt = dtype

    def jloss(x, s, b):
        y = jax_layer_norm(x, s, b, eps=1e-6)
        return jnp.sum(y.astype(jnp.float32) * w)

    jx, js, jb = (jnp.asarray(a).astype(_JAX[dt]) for a in (x, scale, bias))
    ref = jax.grad(jloss, argnums=(0, 1, 2))(jx, js, jb)
    tx, ts, tb = (torch.from_numpy(a).to(_TORCH[dt]).requires_grad_(True)
                  for a in (x, scale, bias))
    y = layer_norm(tx, ts, tb, eps=1e-6)
    got = torch.autograd.grad((y.float() * torch.from_numpy(w)).sum(),
                              (tx, ts, tb))
    tol = dict(atol=2e-5, rtol=1e-5) if dt == "float32" else dict(
        atol=2.0 ** -7, rtol=2.0 ** -7)
    for name, g, r in zip(("dx", "dscale", "dbias"), got, ref):
        assert g.dtype == _TORCH[dt]
        np.testing.assert_allclose(_to_np(g), _to_np(r), err_msg=name, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_grad_matches_jax(dtype):
    """The compact VJP: fp32 derivative of the tanh GELU from the saved u,
    cast to u's dtype; the cotangent is exact in both dtypes, so the only
    difference is the fp32 tanh. XLA's tanh and PyTorch's differ in the
    last bits, and the derivative's 0.5 u (1 - t^2) C (1 + 3 A u^2) term
    multiplies that by up to ~30 at |u| ~ 12 (3 sigma of these inputs;
    measured 3.7e-6): atol = rtol = 1e-5 (fp32), one bf16 ulp (bf16)."""
    u, w = _rand((1000,), 16, 4.0), _rand((1000,), 17)
    ju = jnp.asarray(u).astype(_JAX[dtype])
    jw = jnp.asarray(w).astype(_JAX[dtype])
    ref = jax.grad(lambda v: jnp.sum(
        (jax_gelu_tanh(v) * jw).astype(jnp.float32)))(ju)
    tu = torch.from_numpy(u).to(_TORCH[dtype]).requires_grad_(True)
    tw = torch.from_numpy(w).to(_TORCH[dtype])
    (got,) = torch.autograd.grad((gelu_tanh(tu) * tw).float().sum(), (tu,))
    assert got.dtype == _TORCH[dtype]
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(
        atol=2.0 ** -8, rtol=2.0 ** -8)
    np.testing.assert_allclose(_to_np(got), _to_np(ref), **tol)
