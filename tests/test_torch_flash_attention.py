"""The port's head-major attention forward (``ops/flash_attention.py``)
against the JAX package.

On the CPU the wrapper runs the kernel's plain version, which is held here
against the Pallas kernel itself (``_fwd(interpret=True)``), O and lse,
and against the JAX references. The CUDA kernel is held against the plain
version on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arsvt_tpu.ops.attention import multi_head_attention as jax_mha
from arsvt_tpu.ops.attention import sdpa_reference as jax_sdpa_reference
from arsvt_tpu.ops.pallas.flash_attention import _fwd
from arsvt_tpu.ops.pallas.flash_attention import (
    flash_self_attention_packed as jax_packed,
)
from arsvt_tpu_torch.ops import build, flash_attention
from arsvt_tpu_torch.ops.attention import (
    multi_head_attention,
    sdpa_reference,
    self_attention_from_qkv,
)
from arsvt_tpu_torch.ops.flash_attention import (
    flash_attention_fwd,
    flash_attention_fwd_plain,
    flash_self_attention_packed,
)

torch.set_num_threads(1)  # tier-1 runs several xdist workers

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# fp32: the same fp32 arithmetic summed in another order, a few ulps of O
# (magnitude <= 3), so atol 1e-5. bf16: both round the unnormalised p to
# bf16 before the product; a last-bit difference of a score can flip that
# rounding or O's own, one or two bf16 ulps, so atol = rtol = 2^-7. lse is
# fp32 on both sides and depends on the scores alone.
TOL = {"float32": dict(atol=1e-5, rtol=0.0),
       "bfloat16": dict(atol=2.0 ** -7, rtol=2.0 ** -7)}
TOL_LSE = 2e-5

# (B, H, Sq, Sk, d, kv_len): the DeiT-400 encoder (d=16), the DETR
# cross-attention of deit_detector_ref (d=50) and of vit_base_detector
# (d=96) over 196 patch tokens, a masked odd case, and one query row; then
# the edges of the kernel's tiles: one head dim (padded to 16) with masked
# keys, the widest head over one key, and masked keys past three of four
# key chunks; then head dims past 128, which the kernels split into
# 64-column output slices (d = 129: one column in the last slice), with
# masked keys on three of them
SHAPES = {
    "encoder_d16": (1, 3, 198, 198, 16, 198),
    "cross_d50": (2, 8, 5, 196, 50, 196),
    "cross_d96_kvlen": (2, 2, 17, 33, 96, 20),
    "one_query": (2, 3, 1, 40, 64, 31),
    "edge_d1_kvlen": (2, 2, 33, 33, 1, 20),
    "edge_d128_one_key": (2, 2, 17, 1, 128, 1),
    "edge_d16_kvlen": (2, 3, 5, 198, 16, 150),
    "wide_d129_kvlen": (1, 2, 17, 33, 129, 20),
    "wide_d192": (1, 2, 9, 70, 192, 70),
    "wide_d256_kvlen": (1, 1, 65, 40, 256, 31),
    "wide_d320_kvlen": (2, 1, 5, 66, 320, 50),
}


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    # true fp32 contractions on the JAX side (XLA CPU's default truncates)
    with jax.default_matmul_precision("highest"):
        yield


def _qkv(b, h, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, h, sk, d)).astype(np.float32),
            rng.standard_normal((b, h, sk, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_matches_pallas_kernel_interpret(shape, dtype):
    b, h, sq, sk, d, kv_len = SHAPES[shape]
    arrays = _qkv(b, h, sq, sk, d, seed=sq + d)
    jo, jl = _fwd(*(jnp.asarray(a).astype(_JAX[dtype]) for a in arrays),
                  scale=1.0 / d ** 0.5, kv_len=kv_len, block_b=1,
                  interpret=True)
    to, tl = flash_attention_fwd(
        *(torch.from_numpy(a).to(_TORCH[dtype]) for a in arrays),
        kv_len=kv_len)
    assert to.dtype == _TORCH[dtype] and to.shape == (b, h, sq, d)
    assert tl.dtype == torch.float32 and tl.shape == (b, h, 1, sq)
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)),
                               **TOL[dtype])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL_LSE)


def test_kv_len_masks_the_keys_past_it():
    """The masked keys change nothing: the forward over the first kv_len
    keys alone gives the same O and lse (fp32 sum order only)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 2, 9, 33, 50, seed=1))
    o, lse = flash_attention_fwd(q, k, v, kv_len=20)
    o2, lse2 = flash_attention_fwd(q, k[:, :, :20].contiguous(),
                                   v[:, :, :20].contiguous())
    np.testing.assert_allclose(o.numpy(), o2.numpy(), atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), lse2.numpy(), atol=1e-6)
    ref = sdpa_reference(q, k, v, mask=torch.arange(33) < 20)
    np.testing.assert_allclose(o.numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_self_attention_matches_jax_interpret(dtype):
    """(B=2, S=29, D=48, H=3): head_dim 16, as the DeiT-400 encoder."""
    x = np.random.default_rng(3).standard_normal((2, 29, 144)).astype(
        np.float32)
    ref = jax_packed(jnp.asarray(x).astype(_JAX[dtype]), 3, interpret=True)
    got = flash_self_attention_packed(torch.from_numpy(x).to(_TORCH[dtype]),
                                      3)
    assert got.dtype == _TORCH[dtype] and got.shape == (2, 29, 48)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               **TOL[dtype])
    routed = self_attention_from_qkv(torch.from_numpy(x).to(_TORCH[dtype]),
                                     3)
    assert torch.equal(routed, got)


def test_multi_head_attention_matches_jax_reference():
    """fp32: the kernel order (divide after the product) against JAX's
    normalise-first reference differs by fp32 rounding alone."""
    q, k, v = _qkv(2, 8, 5, 196, 50, seed=4)
    ref = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  force_reference=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for got in (multi_head_attention(tq, tk, tv),
                multi_head_attention(tq, tk, tv, force_reference=True),
                flash_attention.flash_attention(tq, tk, tv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_mask_routes_to_the_reference_and_matches_jax():
    q, k, v = _qkv(1, 2, 7, 11, 16, seed=5)
    mask = np.random.default_rng(6).uniform(size=(1, 1, 7, 11)) < 0.7
    mask[..., 0] = True  # every row attends somewhere
    ref = jax_sdpa_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             mask=jnp.asarray(mask))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    before = flash_attention.LAUNCHES
    got = multi_head_attention(tq, tk, tv, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    assert torch.equal(
        flash_attention.flash_attention(tq, tk, tv,
                                        mask=torch.from_numpy(mask)), got)
    assert flash_attention.LAUNCHES == before


def test_cpu_call_runs_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 5, 9, 50, seed=7))
    before = flash_attention.LAUNCHES
    out, lse = flash_attention_fwd(q, k, v, kv_len=6)
    ref_out, ref_lse = flash_attention_fwd_plain(q, k, v, 6)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert flash_attention.LAUNCHES == before


_Q = torch.zeros(1, 2, 5, 16)
_K = torch.zeros(1, 2, 9, 16)


@pytest.mark.parametrize("q,k,v,kw,err,match", [
    (_Q[0], _K, _K, {}, ValueError, "B, H, S, d"),
    (_Q, _K[:, :1], _K[:, :1], {}, ValueError, "k and v must be"),
    (_Q, _K, _K[..., :8], {}, ValueError, "k and v must be"),
    (_Q, _K[..., :8], _K[..., :8], {}, ValueError, "k and v must be"),
    (_Q[:, :, :0], _K, _K, {}, ValueError, "empty"),
    (_Q, _K, _K, {"dropout_rate": 1.0}, ValueError, "dropout rate"),
    (_Q, _K, _K, {"kv_len": 0}, ValueError, "kv_len"),
    (_Q, _K, _K, {"kv_len": 10}, ValueError, "kv_len"),
    (_Q.half(), _K.half(), _K.half(), {}, TypeError, "float32 or bfloat16"),
    (_Q, _K.bfloat16(), _K, {}, TypeError, "one dtype"),
    (_Q.to("meta"), _K.to("meta"), _K.to("meta"), {}, ValueError,
     "cpu or cuda"),
])
def test_wrapper_rejects_bad_operands(q, k, v, kw, err, match):
    with pytest.raises(err, match=match):
        flash_attention_fwd(q, k, v, **kw)


def test_forward_that_would_build_a_graph_raises():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 3, 4, 16, seed=8))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="backward runs "
                                           "flash_attention_bwd"):
        flash_attention_fwd(q, k, v)
    with torch.inference_mode():
        flash_attention_fwd(q, k, v)
    with torch.no_grad():
        flash_attention_fwd(q, k, v)


def test_nvcc_command_builds_the_flash_source_under_build():
    src = build.source_path("flash_attention_fwd")
    lib = build.library_path("flash_attention_fwd")
    cmd = build.nvcc_command(src, lib)
    assert "arch=compute_90a,code=sm_90a" in cmd and cmd[-1] == str(src)
    assert lib.parent == build.CSRC_DIR.parents[1] / "build" / \
        "arsvt_tpu_torch"
    assert "flash_attention_fwd" in build.kernel_names()


def test_kernel_source_names_the_tpu_kernel_it_replaces():
    text = build.source_path("flash_attention_fwd").read_text()
    assert "flash_attention.py::_fwd_kernel" in text
    assert 'extern "C" int arsvt_flash_attention_fwd' in text
    assert "cudaGetLastError" in text
    assert "Bound on an H100" in text
    assert '#include "attention_fwd.cuh"' in text  # the tensor-core body


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_64_routes_differ_but_agree(dtype):
    """A head_dim-64 backbone whose D is not a multiple of 128
    (vit_tiny_16_224's D=192, H=3) takes JAX's packed head-major kernel
    but the port's encoder-attention kernel: the same arithmetic, so they
    agree to the kernels' tolerance."""
    from arsvt_tpu_torch.ops.encoder_attention import encoder_attention_fwd

    x = np.random.default_rng(9).standard_normal((2, 37, 576)).astype(
        np.float32)
    ref = jax_packed(jnp.asarray(x).astype(_JAX[dtype]), 3, interpret=True)
    got, _ = encoder_attention_fwd(torch.from_numpy(x).to(_TORCH[dtype]), 3)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               **TOL[dtype])
