"""The port's save-probs encoder attention (``ARSVT_ATTN_SAVE_PROBS``)
against the JAX package on the CPU: the plain versions of kernels #5 and #6
against ``_fwd_direct_savep`` / ``_bwd_direct_savep`` run in interpret
mode, the autograd Function against ``jax.grad`` of JAX's
``fused_encoder_attention_savep`` and against the port's default route,
and the ViT block's routing. The CUDA kernels are held against their plain
versions on the card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arsvt_tpu.ops.pallas.flash_attention import (
    _bwd_direct_savep,
    _fwd_direct_savep,
)
from arsvt_tpu.ops.pallas.flash_attention import (
    fused_encoder_attention_savep as jax_fused_savep,
)
from arsvt_tpu_torch.models import vit
from arsvt_tpu_torch.models.vit import BackboneConfig, init_backbone
from arsvt_tpu_torch.ops import build, encoder_attention
from arsvt_tpu_torch.ops.encoder_attention import (
    encoder_attention_bwd_savep,
    encoder_attention_fwd_savep,
    fused_encoder_attention,
    fused_encoder_attention_savep,
)

torch.set_num_threads(1)  # tier-1 runs several xdist workers

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
B, D, H = 2, 128, 2


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


def _torch(x, dtype):
    return torch.from_numpy(_to_np(x)).to(_TORCH[dtype])


# S = 65 and 128: one key past the kernels' 64-row tile and two whole tiles
@pytest.mark.parametrize("s", [17, 33, 65, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_plain_matches_pallas_fwd_direct_savep(dtype, s):
    """#5's plain version against the Pallas kernel on the same qkv. O:
    fp32 summation order only, a few ulps of |O| <= 2 (measured 1.2e-6),
    atol 5e-6; bf16: both round P to bf16 before the product, so a
    last-bit difference of p / l can flip one rounding, then O's own: two
    bf16 ulps, atol = rtol = 2^-7. P is bf16 on both sides: one bf16 ulp
    (2^-8 to 2^-7 relative) where p / l lands on a rounding boundary."""
    qkv = jnp.asarray(_rand((B, s, 3 * D), 1)).astype(_JAX[dtype])
    ref_out, ref_p = _fwd_direct_savep(qkv, H, interpret=True)
    out, probs = encoder_attention_fwd_savep(_torch(qkv, dtype), H)
    assert out.dtype == _TORCH[dtype] and out.shape == (B, s, D)
    assert probs.dtype == torch.bfloat16 and probs.shape == (B, H, s, s)
    tol = dict(atol=5e-6, rtol=0) if dtype == "float32" else dict(
        atol=2.0 ** -7, rtol=2.0 ** -7)
    np.testing.assert_allclose(_to_np(out), _to_np(ref_out), **tol)
    np.testing.assert_allclose(_to_np(probs), _to_np(ref_p), rtol=2.0 ** -7,
                               atol=1e-7)
    np.testing.assert_allclose(_to_np(probs).sum(-1), 1.0, atol=s * 2 ** -8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_plain_matches_pallas_bwd_direct_savep(dtype):
    """#6's plain version against the Pallas kernel on the same (qkv, P,
    dO), P from the Pallas forward, B=2 S=17 D=128 H=2. fp32: summation
    order only (P is bf16 on both sides), atol 1e-5. bf16: both round dS
    and P to bf16 before their products; an order difference can flip
    single roundings and the final bf16 one: atol = rtol = 2^-6."""
    _check_backward(dtype, 17)


@pytest.mark.parametrize("s", [65, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_plain_matches_pallas_at_the_tile_edges(dtype, s):
    """#6's plain version against the Pallas kernel where the kernel's
    64-row tiles of queries and keys end: one row past a tile (S = 65) and
    two whole tiles (S = 128); the limits of the S = 17 test."""
    _check_backward(dtype, s)


def _check_backward(dtype, s):
    qkv = jnp.asarray(_rand((B, s, 3 * D), 2)).astype(_JAX[dtype])
    dout = jnp.asarray(_rand((B, s, D), 3)).astype(_JAX[dtype])
    _, probs = _fwd_direct_savep(qkv, H, interpret=True)
    ref = _bwd_direct_savep(qkv, probs, dout, H, interpret=True)
    got = encoder_attention_bwd_savep(_torch(qkv, dtype),
                                      _torch(probs, "bfloat16"),
                                      _torch(dout, dtype), H)
    tol = dict(atol=1e-5, rtol=0) if dtype == "float32" else dict(
        atol=2.0 ** -6, rtol=2.0 ** -6)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == _TORCH[dtype] and g.shape == (B, s, D)
        np.testing.assert_allclose(_to_np(g), _to_np(r), err_msg=name, **tol)


def _proj_args(s, seed=0):
    return [_rand((B, s, D), seed), _rand((D, 3 * D), seed + 1, 0.05),
            _rand((3 * D,), seed + 2, 0.05), _rand((D, D), seed + 3, 0.05),
            _rand((D,), seed + 4, 0.05)]


_GRADS = ("dy", "dwqkv", "dbqkv", "dwproj", "dbproj")


@pytest.mark.parametrize("s", [17, 64])
def test_savep_function_matches_jax_grad(s):
    """fp32, B=2, D=128, H=2: the port's save-probs Function (plain
    versions on the CPU) against JAX's custom VJP over the Pallas kernels in
    interpret mode, forward and the gradients of sum(out^2) with respect to
    all five inputs. The same rounding points, P bf16 in both backward
    passes: atol 3e-5 on out, 5e-5 on the gradients, as the default
    route's test holds it."""
    args = _proj_args(s)
    jargs = [jnp.asarray(a) for a in args]

    def jloss(*a):
        return jnp.sum(jax_fused_savep(*a, H, True) ** 2)

    jout = jax_fused_savep(*jargs, H, True)
    jgrads = jax.grad(jloss, argnums=tuple(range(5)))(*jargs)
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fused_encoder_attention_savep(*targs, H)
    tgrads = torch.autograd.grad((out ** 2).sum(), targs)
    np.testing.assert_allclose(_to_np(out), _to_np(jout), atol=3e-5)
    for name, got, ref in zip(_GRADS, tgrads, jgrads):
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(_to_np(got), _to_np(ref), atol=5e-5,
                                   err_msg=name)


def test_savep_function_matches_the_default_route():
    """The same math as `fused_encoder_attention` (fp32, S=33): the outputs
    agree to fp32 rounding (atol 1e-6; normalising before or after the
    product), while the save-probs backward reads P rounded to bf16, 2^-9
    relative per probability: each gradient within 2^-8 of its largest
    magnitude."""
    args = [torch.from_numpy(a) for a in _proj_args(33, seed=10)]
    outs, grads = [], []
    for fn in (fused_encoder_attention_savep, fused_encoder_attention):
        targs = [a.clone().requires_grad_(True) for a in args]
        out = fn(*targs, H)
        outs.append(out.detach())
        grads.append(torch.autograd.grad((out ** 2).sum(), targs))
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=1e-6)
    for name, a, b in zip(_GRADS, *grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=2.0 ** -8 * float(b.abs().max()),
                                   err_msg=name)


def test_savep_wrappers_check_and_count_no_cpu_launch():
    s = 5
    qkv = torch.zeros(1, s, 3 * D)
    before = (encoder_attention.SAVEP_LAUNCHES,
              encoder_attention.SAVEP_BWD_LAUNCHES)
    out, probs = encoder_attention_fwd_savep(qkv, H)
    assert torch.equal(probs, torch.full_like(probs, 1.0 / s))
    dq, dk, dv = encoder_attention_bwd_savep(qkv, probs, torch.zeros(1, s, D),
                                             H)
    assert dq.shape == dk.shape == dv.shape == (1, s, D)
    assert (encoder_attention.SAVEP_LAUNCHES,
            encoder_attention.SAVEP_BWD_LAUNCHES) == before
    with pytest.raises(ValueError, match="probs"):
        encoder_attention_bwd_savep(qkv, probs.float(), out, H)
    with pytest.raises(ValueError, match="dout"):
        encoder_attention_bwd_savep(qkv, probs, out.bfloat16(), H)
    with pytest.raises(ValueError, match="head_dim"):
        encoder_attention_fwd_savep(torch.zeros(1, s, 96), 2)


@pytest.mark.parametrize("name,tpu_kernel", [
    ("encoder_attention_savep_fwd", "_fwd_kernel_direct_savep"),
    ("encoder_attention_savep_bwd", "_bwd_kernel_direct_savep"),
])
def test_savep_sources_name_the_tpu_kernels_and_build_for_sm90a(name,
                                                                tpu_kernel):
    text = build.source_path(name).read_text()
    assert f"flash_attention.py::{tpu_kernel}" in text
    assert f'extern "C" int arsvt_{name}' in text
    assert "cudaGetLastError" in text and "atomic" not in text.replace(
        "no atomics", "")
    cmd = build.nvcc_command(build.source_path(name), build.library_path(name))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert name in build.kernel_names()


@pytest.mark.parametrize("name", ["encoder_attention_savep_fwd",
                                  "encoder_attention_savep_bwd"])
def test_savep_sources_run_on_the_tensor_core_tiles(name):
    """#5 is the save-probs branch of the forward body of #1 and #3
    (attention_fwd.cuh); #6 builds its two kernels from that body's
    staging and score tiles and the product and store helpers of the
    backward body of #2 and #4 (attention_bwd.cuh). Both reach
    warp_tile.cuh's mma.sync tiles and do not include encoder_tile.cuh
    directly."""
    text = build.source_path(name).read_text()
    assert '#include "attention_fwd.cuh"' in text
    assert '#include "encoder_tile.cuh"' not in text
    body = (build.CSRC_DIR / "attention_fwd.cuh").read_text()
    assert '#include "warp_tile.cuh"' in body and "warp_mma" in body
    assert "mma.sync" in (build.CSRC_DIR / "warp_tile.cuh").read_text()
    if name.endswith("fwd"):
        assert "launch_fwd<T, kHeadDim, true>" in text  # kSaveP
        assert "kSaveP" in body and "store_rows" in body
    else:
        helpers = (build.CSRC_DIR / "attention_bwd.cuh").read_text()
        assert '#include "attention_bwd.cuh"' in text
        assert "mma_tile<T, kHeadDim>(" in text and "chunk_scores" in text
        assert "warp_mma_afrag" in helpers
        assert "load_a_frag<" in text and "asm" not in text  # no own PTX


@pytest.mark.parametrize("name,tpu_kernel", [
    ("encoder_attention_bwd", "_bwd_kernel_direct"),
    ("flash_attention_bwd", "_bwd_kernel"),
])
def test_attention_bwd_sources_run_on_the_tensor_core_tiles(name,
                                                             tpu_kernel):
    """#2 and #4 are thin launchers of one backward body
    (attention_bwd.cuh) on warp_tile.cuh's mma.sync tiles: neither source
    includes the dropout rule (encoder_tile.cuh) or the generator
    (philox.cuh) directly, nor carries PTX or an atomic of its own; the
    body reaches the tiles and the shared mask and sums with no atomics."""
    text = build.source_path(name).read_text()
    assert f"flash_attention.py::{tpu_kernel}" in text
    assert '#include "attention_bwd.cuh"' in text
    assert '#include "encoder_tile.cuh"' not in text
    assert '#include "philox.cuh"' not in text
    assert "attn::launch_bwd<T, " in text
    body = (build.CSRC_DIR / "attention_bwd.cuh").read_text()
    assert '#include "attention_fwd.cuh"' in body
    fwd = (build.CSRC_DIR / "attention_fwd.cuh").read_text()
    assert '#include "warp_tile.cuh"' in fwd
    assert "warp_mma_afrag" in body and "chunk_scores" in body
    assert "enc::keeps(drop, mbh," in body and "kDrop" in body
    for source in (text, body):
        assert "asm" not in source  # no PTX of its own
        assert "atomic" not in source.replace("no atomics", "")


@pytest.mark.parametrize("train,env,savep_calls", [
    (True, "1", 1), (False, "1", 0), (True, None, 0)])
def test_encoder_block_routes_save_probs(train, env, savep_calls,
                                         monkeypatch):
    """The save-probs Function only for a training forward with the switch
    on (JAX's ``vit.py:182``); the default Function otherwise.
    ``ARSVT_DISABLE_PALLAS``, which tests/conftest.py sets, would turn the
    switch off."""
    monkeypatch.delenv("ARSVT_DISABLE_PALLAS", raising=False)
    if env is None:
        monkeypatch.delenv("ARSVT_ATTN_SAVE_PROBS", raising=False)
    else:
        monkeypatch.setenv("ARSVT_ATTN_SAVE_PROBS", env)
    calls = {"savep": 0, "default": 0}
    real = {"savep": vit.fused_encoder_attention_savep,
            "default": vit.fused_encoder_attention}

    def spy(key):
        def fn(*a, **kw):
            calls[key] += 1
            return real[key](*a, **kw)
        return fn

    monkeypatch.setattr(vit, "fused_encoder_attention_savep", spy("savep"))
    monkeypatch.setattr(vit, "fused_encoder_attention", spy("default"))
    cfg = BackboneConfig(image_size=16, patch_size=8, embed_dim=D, depth=1,
                         num_heads=H, mlp_dim=2 * D)
    params = init_backbone(cfg, seed=0)
    x = torch.from_numpy(_rand((2, cfg.seq_len, D), 4))
    vit._encoder_block(x, params["blocks"][0], cfg, train=train)
    assert calls == {"savep": savep_calls, "default": 1 - savep_calls}
