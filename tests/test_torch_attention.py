"""The port's encoder-attention core and attention references against the
JAX package.

On the CPU the wrapper runs the kernel's plain version, which is held here
against the Pallas kernel itself (``_fwd_direct(interpret=True)``) and
against the JAX references. The CUDA kernel is held against the plain
version on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arsvt_tpu.ops.attention import sdpa_reference as jax_sdpa_reference
from arsvt_tpu.ops.attention import (
    self_attention_from_qkv as jax_self_attention_from_qkv,
)
from arsvt_tpu.ops.pallas.flash_attention import _fwd_direct
from arsvt_tpu_torch.ops import build, encoder_attention
from arsvt_tpu_torch.ops.attention import (
    sdpa_reference,
    self_attention_from_qkv,
)
from arsvt_tpu_torch.ops.encoder_attention import (
    encoder_attention_fwd,
    encoder_attention_fwd_plain,
)

torch.set_num_threads(1)  # tier-1 runs several xdist workers

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    # true fp32 contractions on the JAX side (XLA CPU's default truncates)
    with jax.default_matmul_precision("highest"):
        yield


def _qkv(b=2, s=197, d=128, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, 3 * d)).astype(np.float32)


@pytest.mark.parametrize("s", [1, 17, 197])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_attention_matches_pallas_kernel_interpret(dtype, s):
    """B=2, D=128, H=2 (head_dim 64), S at the edges of the kernel's tiles:
    one row and key, one partial tile, and 197 (the ragged ViT edge: four
    64-row tiles, the last holding 5 rows).

    fp32: both compute the same fp32 arithmetic in another summation
    order, so atol 2e-5 as tests/test_kernel_interpret.py uses. bf16: both
    round the unnormalised p to bf16 before the product; a different sum
    order of a score can flip that rounding or the final bf16 rounding of
    O, one or two bf16 ulps, so atol = rtol = 2^-7. lse is fp32 in both
    and depends only on the scores: 2e-5.
    """
    x = _qkv(s=s)
    jo, jl = _fwd_direct(jnp.asarray(x).astype(_JAX[dtype]), 2,
                         interpret=True)
    to, tl = encoder_attention_fwd(torch.from_numpy(x).to(_TORCH[dtype]), 2)
    assert to.dtype == _TORCH[dtype] and to.shape == (2, s, 128)
    assert tl.dtype == torch.float32 and tl.shape == (2, 2, 1, s)
    jo = np.asarray(jo.astype(jnp.float32))
    tol = 2e-5 if dtype == "float32" else 2.0 ** -7
    rtol = 0.0 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(to.float().numpy(), jo, atol=tol, rtol=rtol)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5)


def test_encoder_attention_bf16_vs_normalise_first_reference():
    """The JAX whole-model CPU path runs `sdpa_reference`, which
    normalises p before the bf16 cast; the kernel order rounds the
    unnormalised p. They agree only loosely: a few bf16 ulps of O."""
    x = torch.from_numpy(_qkv(seed=1)).to(torch.bfloat16)
    out, _ = encoder_attention_fwd(x, 2)
    ref = self_attention_from_qkv(x, 2, force_reference=True)
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               atol=2.0 ** -6, rtol=2.0 ** -6)


def test_sdpa_reference_matches_jax():
    """Same fp32 softmax island on both sides; fp32 sum order only."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 3, 37, 16)).astype(np.float32)
               for _ in range(3))
    ref = jax_sdpa_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = sdpa_reference(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_self_attention_from_qkv_matches_jax():
    x = _qkv(b=2, s=29, d=96, seed=3)
    ref = jax_self_attention_from_qkv(jnp.asarray(x), 3,
                                      force_reference=True)
    for force in (True, False):  # the reference, and the kernel's order
        got = self_attention_from_qkv(torch.from_numpy(x), 3,
                                      force_reference=force)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("d,heads", [(32, 2), (128, 4), (400, 25)])
def test_wrapper_rejects_unsupported_head_dim(d, heads):
    with pytest.raises(ValueError, match="head_dim"):
        encoder_attention_fwd(torch.zeros(1, 5, 3 * d), heads)


def test_wrapper_rejects_bad_dtype_and_device():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        encoder_attention_fwd(torch.zeros(1, 5, 384, dtype=torch.float16), 2)
    with pytest.raises(ValueError, match="cpu or cuda"):
        encoder_attention_fwd(torch.zeros(1, 5, 384, device="meta"), 2)
    with pytest.raises(ValueError, match="divide"):
        encoder_attention_fwd(torch.zeros(1, 5, 384), 3)


def test_cpu_call_runs_plain_version_and_counts_no_launch():
    before = encoder_attention.LAUNCHES
    x = torch.from_numpy(_qkv(b=1, s=17, seed=4))
    out, lse = encoder_attention_fwd(x, 2)
    ref_out, ref_lse = encoder_attention_fwd_plain(x, 2)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert encoder_attention.LAUNCHES == before


def test_nvcc_command_targets_sm90a_and_writes_under_build():
    src = build.source_path("encoder_attention_fwd")
    lib = build.library_path("encoder_attention_fwd")
    cmd = build.nvcc_command(src, lib)
    assert cmd[0] == "nvcc" and cmd[-1] == str(src)
    assert "arch=compute_90a,code=sm_90a" in cmd
    for flag in ("-std=c++17", "-O3", "-shared", "-fPIC"):
        assert flag in cmd
    assert cmd[cmd.index("-o") + 1] == str(lib)
    repo = build.CSRC_DIR.parents[1]
    assert lib.parent == repo / "build" / "arsvt_tpu_torch"
    assert lib.name.startswith("libencoder_attention_fwd-")
    assert "encoder_attention_fwd" in build.kernel_names()


def test_kernel_source_names_the_tpu_kernel_it_replaces():
    text = build.source_path("encoder_attention_fwd").read_text()
    assert "flash_attention.py::_fwd_kernel_direct" in text
    assert 'extern "C" int arsvt_encoder_attention_fwd' in text
    assert "cudaGetLastError" in text and "Bound on an H100" in text
    # the body is the tensor-core forward shared with the head-major kernel
    assert '#include "attention_fwd.cuh"' in text
    body = (build.CSRC_DIR / "attention_fwd.cuh").read_text()
    assert '#include "warp_tile.cuh"' in body and "warp_mma" in body
    assert "mma.sync" in (build.CSRC_DIR / "warp_tile.cuh").read_text()
