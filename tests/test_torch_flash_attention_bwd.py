"""The port's head-major attention backward (``ops/flash_attention.py``:
`flash_attention_bwd` and the autograd Functions around the two kernels)
against the JAX package.

On the CPU the wrapper runs the backward kernel's plain version, held here
against the Pallas kernel itself (``_bwd_call(interpret=True)``) and, as
gradients, against ``jax.grad`` of JAX's ``flash_attention`` and
``flash_self_attention_packed`` (their custom VJPs, ``interpret=True``).
The CUDA kernel is held against the plain version on the card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arsvt_tpu.ops.pallas.flash_attention import _bwd_call, _fwd
from arsvt_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention,
)
from arsvt_tpu.ops.pallas.flash_attention import (
    flash_self_attention_packed as jax_packed,
)
from arsvt_tpu_torch.ops import build, flash_attention
from arsvt_tpu_torch.ops.flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_self_attention_packed,
)

torch.set_num_threads(1)  # tier-1 runs several xdist workers

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# fp32: the same fp32 arithmetic summed in another order; dq, dk and dv
# reach a few units here, so a few ulps of that: atol 1e-5. bf16: dS and
# p_v are rounded to bf16 before three of the products on both sides, and
# a last-bit difference of an fp32 value can flip one such rounding, then
# the outputs' own bf16 rounding: a few bf16 ulps, atol = rtol = 2^-6.
TOL = {"float32": dict(atol=1e-5, rtol=0.0),
       "bfloat16": dict(atol=2.0 ** -6, rtol=2.0 ** -6)}

# (B, H, Sq, Sk, d, kv_len): the DeiT-400 encoder's head_dim 16 at a short
# sequence, the DETR cross-attention (d=50, Sq=5 < Sk), a masked odd case
# (kv_len < Sk) and 100-byte bf16 rows with Sq > Sk; at the edges of the
# kernel's tiles of 64 queries and 64 keys and of its padded head dims: d
# = 1, the widest d = 128 (masked), and Sq = 65 against Sk = 64; head
# dims past 128, which the kernels split into 64-column output slices,
# with masked keys on three of them
SHAPES = {
    "encoder_d16": (2, 3, 37, 37, 16, 37),
    "cross_d50": (2, 2, 5, 70, 50, 70),
    "masked_d16": (1, 2, 9, 33, 16, 20),
    "masked_d50": (2, 1, 40, 21, 50, 13),
    "edge_d1": (1, 2, 20, 33, 1, 33),
    "edge_d128": (1, 1, 17, 66, 128, 40),
    "edge_sq65_sk64": (1, 2, 65, 64, 16, 64),
    "wide_d129_kvlen": (1, 2, 17, 33, 129, 20),
    "wide_d192": (1, 1, 9, 70, 192, 70),
    "wide_d256_kvlen": (1, 1, 65, 40, 256, 31),
    "wide_d320_kvlen": (1, 1, 5, 66, 320, 50),
}


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _arrays(b, h, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d),
                               (b, h, sq, d)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_matches_pallas_bwd_interpret(shape, dtype):
    """The plain backward against `_bwd_call(interpret=True)` on the same
    q, k, v, dO and the JAX forward's O and lse."""
    b, h, sq, sk, d, kv_len = SHAPES[shape]
    q, k, v, do = (jnp.asarray(a).astype(_JAX[dtype])
                   for a in _arrays(b, h, sq, sk, d, seed=sq + d))
    scale = 1.0 / d ** 0.5
    o, lse = _fwd(q, k, v, scale=scale, kv_len=kv_len, block_b=1,
                  interpret=True)
    ref = _bwd_call(q, k, v, o, do, lse, scale=scale, kv_len=kv_len,
                    block_b=1, interpret=True)
    before = flash_attention.LAUNCHES_BWD
    got = flash_attention_bwd(
        *(torch.from_numpy(np.array(t.astype(jnp.float32))).to(
            _TORCH[dtype]) for t in (q, k, v, o, do)),
        torch.from_numpy(np.array(lse)), kv_len=kv_len)
    assert flash_attention.LAUNCHES_BWD == before  # plain version on CPU
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == _TORCH[dtype] and g.shape == r.shape, name
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r.astype(jnp.float32)),
                                   err_msg=name, **TOL[dtype])


def test_masked_keys_get_zero_gradient():
    """Keys at or past kv_len take no part: dk and dv are exactly 0 there,
    and dq equals the backward over the first kv_len keys alone."""
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(1, 2, 7, 30, 16, 4))
    o, lse = flash_attention.flash_attention_fwd(q, k, v, kv_len=11)
    dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, kv_len=11)
    assert not dk[:, :, 11:].any() and not dv[:, :, 11:].any()
    dq2, dk2, dv2 = flash_attention_bwd(
        q, k[:, :, :11].contiguous(), v[:, :, :11].contiguous(), o, do, lse)
    np.testing.assert_allclose(dq.numpy(), dq2.numpy(), atol=1e-6)
    np.testing.assert_allclose(dk[:, :, :11].numpy(), dk2.numpy(), atol=1e-6)
    np.testing.assert_allclose(dv[:, :, :11].numpy(), dv2.numpy(), atol=1e-6)


@pytest.mark.parametrize("shape", ["encoder_d16", "cross_d50"])
def test_flash_attention_grads_match_jax_grad(shape):
    """Gradients of sum(w * flash_attention(q, k, v)) through the port's
    autograd Function against jax.grad through JAX's custom VJP."""
    b, h, sq, sk, d, _ = SHAPES[shape]
    q, k, v, w = _arrays(b, h, sq, sk, d, seed=11)

    def jloss(q, k, v):
        return jnp.sum(jnp.asarray(w) * jax_flash_attention(
            q, k, v, interpret=True))

    ref = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = flash_attention.flash_attention(tq, tk, tv)
    got = torch.autograd.grad((torch.from_numpy(w) * out).sum(),
                              (tq, tk, tv))
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_grads_match_jax_grad(dtype):
    """(B=2, S=29, D=48, H=3), head_dim 16: d(qkv_flat) through the
    port's packed Function against jax.grad of JAX's packed VJP."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 29, 144)).astype(np.float32)
    w = rng.standard_normal((2, 29, 48)).astype(np.float32)

    def jloss(x):
        out = jax_packed(x, 3, interpret=True).astype(jnp.float32)
        return jnp.sum(jnp.asarray(w) * out)

    ref = jax.grad(jloss)(jnp.asarray(x).astype(_JAX[dtype]))
    tx = torch.from_numpy(x).to(_TORCH[dtype]).requires_grad_(True)
    out = flash_self_attention_packed(tx, 3)
    (got,) = torch.autograd.grad((torch.from_numpy(w) * out.float()).sum(),
                                 (tx,))
    assert got.dtype == _TORCH[dtype] and got.shape == tx.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               **TOL[dtype])


def test_packed_saves_only_qkv_out_and_lse():
    """The packed Function keeps (qkv_flat, O, lse) for its backward, as
    JAX's residual-lean VJP, and no split copy of q, k or v."""
    x = torch.randn(2, 9, 48, requires_grad=True)
    out = flash_self_attention_packed(x, 2)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 3
    assert saved[0] is x
    assert saved[1].shape == (2, 2, 9, 8) and saved[2].shape == (2, 2, 1, 9)


_Q = torch.zeros(1, 2, 5, 16)
_K = torch.zeros(1, 2, 9, 16)
_LSE = torch.zeros(1, 2, 1, 5)


@pytest.mark.parametrize("args,match", [
    ((_Q, _K, _K, _Q[..., :8], _Q, _LSE), "o must be"),
    ((_Q, _K, _K, _Q, _Q.bfloat16(), _LSE), "do must be"),
    ((_Q, _K, _K, _Q, _Q, _LSE[..., :4]), "lse must be"),
    ((_Q, _K, _K, _Q, _Q, _LSE.double()), "lse must be"),
    ((_Q, _K, _K, _Q, _Q.to("meta"), _LSE), "cpu or cuda"),
])
def test_bwd_wrapper_rejects_bad_operands(args, match):
    with pytest.raises(ValueError, match=match):
        flash_attention_bwd(*args)


def test_bwd_plain_is_what_the_cpu_wrapper_runs():
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(1, 2, 5, 9, 50, 7))
    o, lse = flash_attention.flash_attention_fwd(q, k, v, kv_len=6)
    got = flash_attention_bwd(q, k, v, o, do, lse, kv_len=6,
                              dropout_rate=0.2, seed=9)
    ref = flash_attention_bwd_plain(q, k, v, o, do, lse, 6, 0.2, 9)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_nvcc_command_builds_the_bwd_source_under_build():
    src = build.source_path("flash_attention_bwd")
    lib = build.library_path("flash_attention_bwd")
    cmd = build.nvcc_command(src, lib)
    assert "arch=compute_90a,code=sm_90a" in cmd and cmd[-1] == str(src)
    assert "flash_attention_bwd" in build.kernel_names()
    text = src.read_text()
    assert "flash_attention.py::_bwd_kernel" in text
    assert 'extern "C" int arsvt_flash_attention_bwd' in text
    assert "Bound on an H100" in text and "cudaGetLastError" in text
    # the mask reaches the body through attention_bwd.cuh -> attention_fwd
    # .cuh -> encoder_tile.cuh -> philox.cuh
    assert '#include "attention_bwd.cuh"' in text
    chain = [("attention_bwd.cuh", "attention_fwd.cuh"),
             ("attention_fwd.cuh", "encoder_tile.cuh"),
             ("encoder_tile.cuh", "philox.cuh")]
    for header, included in chain:
        assert f'#include "{included}"' in (
            build.CSRC_DIR / header).read_text()


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """An edit of philox.cuh renames every library, so a stale build is
    never loaded."""
    for p in build.CSRC_DIR.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = build.library_path("flash_attention_bwd")
    (tmp_path / "philox.cuh").write_text("// edited\n")
    assert build.library_path("flash_attention_bwd") != before
