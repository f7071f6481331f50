"""Attention dropout in the port's encoder-attention kernels (the dropout
branches of #1, #2, #5 and #6) on the CPU, through their plain versions:
against JAX's masked-softmax formula (``flash_attention.py:59-67``) fed
the port's Philox mask, the mask shared with the head-major kernels, the
kept share, and a ViT block on both routes. The TPU kernels draw their
mask from the TPU's generator, which no other device reproduces, so the
comparison feeds JAX the port's mask. The CUDA kernels are held against
these plain versions on the card by ``chip_smoke.py`` (phase 3, with a
probe of each launch's mask)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arsvt_tpu_torch.core.prng import Rng
from arsvt_tpu_torch.models import vit
from arsvt_tpu_torch.models.vit import BackboneConfig, init_backbone
from arsvt_tpu_torch.ops import build, encoder_attention, flash_attention
from arsvt_tpu_torch.ops.attention import merge_heads, split_heads
from arsvt_tpu_torch.ops.dropout import keep_mask
from arsvt_tpu_torch.ops.encoder_attention import (
    encoder_attention_bwd,
    encoder_attention_bwd_savep,
    encoder_attention_fwd,
    encoder_attention_fwd_savep,
)

torch.set_num_threads(1)  # tier-1 runs several xdist workers

RATE = 0.1
SEED = 0xDEADBEEF  # high bit set: the seed travels as a uint32
B, H, D = 2, 2, 128  # head_dim 64
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _jax_masked(mask):
    """JAX's formula with dropout: softmax(q kᵀ/√d), zeroed where the mask
    drops and scaled by 1/(1 - rate) where it keeps, times v."""
    def f(q, k, v):
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / jnp.sqrt(
            jnp.float32(q.shape[-1]))
        p = jax.nn.softmax(s, axis=-1)
        p = jnp.where(mask, p / (1.0 - RATE), 0.0)
        return jnp.einsum("bhqk,bhkd->bhqd", p, v)
    return f


def _port_fwd_bwd(route, qkv, dout):
    """The route's plain forward and backward with dropout: (out, (dq, dk,
    dv)), each (B, S, D)."""
    kw = dict(dropout_rate=RATE, seed=SEED)
    if route == "default":
        out, lse = encoder_attention_fwd(qkv, H, **kw)
        return out, encoder_attention_bwd(qkv, out, dout, lse, H, **kw)
    out, probs = encoder_attention_fwd_savep(qkv, H, **kw)
    return out, encoder_attention_bwd_savep(qkv, probs, dout, H, **kw)


# fp32: #1/#2 repeat the formula's arithmetic in another order (atol
# 1e-5; measured 4.2e-7 relative); #5/#6 read P back rounded to bf16
# (2^-9 relative a probability), so their gradients are held within 2^-8
# of their largest magnitude, as tests/test_torch_savep.py holds the
# save-probs route without dropout (measured 1.8e-3). bf16: the kernels
# round p (unnormalised in #1) and dS to bf16 before their products and
# the outputs to bf16, where the formula normalises and sums in fp32:
# 2^-6 of the largest magnitude (measured 4.5e-3).
@pytest.mark.parametrize("route", ["default", "savep"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [17, 33, 65])
def test_plain_versions_match_jax_masked_formula(s, dtype, route):
    qkv_np = _rand((B, s, 3 * D), s)
    w_np = _rand((B, s, D), s + 1)
    mask = keep_mask(SEED, B, H, s, s, RATE)
    tdt = _TORCH[dtype]
    qkv = torch.from_numpy(qkv_np).to(tdt)
    dout = torch.from_numpy(w_np).to(tdt)
    # JAX sees the same (possibly bf16-rounded) operands in fp32
    q, k, v = (jnp.asarray(t.float().numpy())
               for t in split_heads(qkv, H))
    f = _jax_masked(jnp.asarray(mask.numpy()))
    ref_out = merge_heads(torch.from_numpy(np.array(f(q, k, v))))
    w_heads = jnp.asarray(split_heads(
        torch.cat([dout.float()] * 3, dim=-1), H)[0].numpy())
    ref_grads = jax.grad(lambda *a: jnp.sum(w_heads * f(*a)),
                         argnums=(0, 1, 2))(q, k, v)
    out, grads = _port_fwd_bwd(route, qkv, dout)
    assert out.dtype == tdt and out.shape == (B, s, D)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref_out.numpy(), atol=1e-5)
    else:
        np.testing.assert_allclose(
            out.float().numpy(), ref_out.numpy(), rtol=0,
            atol=2.0 ** -6 * float(ref_out.abs().max()))
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        r = merge_heads(torch.from_numpy(np.array(r)))
        assert g.dtype == tdt and g.shape == (B, s, D), name
        if dtype == "float32" and route == "default":
            tol = 1e-5
        elif dtype == "float32":
            tol = 2.0 ** -8 * float(r.abs().max())
        else:
            tol = 2.0 ** -6 * float(r.abs().max())
        np.testing.assert_allclose(g.float().numpy(), r.numpy(), rtol=0,
                                   atol=tol, err_msg=name)


def _probe_qkv(b, s, h):
    """q = 0 (uniform p) and k = v = I in each head's 64 columns: O reads
    the probabilities back."""
    head = torch.zeros(s, 64)
    head[:, :s] = torch.eye(s)
    head = head.repeat(1, h)
    qkv = torch.cat([torch.zeros(s, 64 * h), head, head], dim=1)
    return qkv.expand(b, s, 3 * 64 * h).contiguous()


def test_same_seed_same_mask_in_1_5_and_the_head_major_kernel():
    """One seed, one mask: #1's and #5's forwards and #3's (the head-major
    kernel, on the split heads) drop the same probabilities, the ones
    `keep_mask` names; #1 and #3 also agree to the bit on random input."""
    b, s, h = 2, 40, 3
    qkv = _probe_qkv(b, s, h)
    kw = dict(dropout_rate=RATE, seed=SEED)
    want = keep_mask(SEED, b, h, s, s, RATE)

    def read(out):
        return split_heads(torch.cat([out] * 3, dim=-1), h)[0][..., :s] > 0

    o1, _ = encoder_attention_fwd(qkv, h, **kw)
    o5, _ = encoder_attention_fwd_savep(qkv, h, **kw)
    q, k, v = (t.contiguous() for t in split_heads(qkv, h))
    o3, _ = flash_attention.flash_attention_fwd(q, k, v, **kw)
    for name, o in (("#1", o1), ("#5", o5), ("#3", merge_heads(o3))):
        assert torch.equal(read(o), want), name
    assert 0 < int((~want).sum()) < want.numel()

    qkv = torch.from_numpy(_rand((b, s, 3 * 64 * h), 3))
    o1, lse1 = encoder_attention_fwd(qkv, h, **kw)
    q, k, v = (t.contiguous() for t in split_heads(qkv, h))
    o3, lse3 = flash_attention.flash_attention_fwd(q, k, v, **kw)
    assert torch.equal(o1, merge_heads(o3))
    assert torch.equal(lse1, lse3)


@pytest.mark.parametrize("savep", [False, True])
def test_kept_share_over_many_draws(savep):
    """The share of probabilities #1 (or #5) keeps, read back through the
    probe, over 8 x 4 x 64 x 64 = 131,072 draws: 0.9 within 0.005 (four
    standard deviations), and the survivors scaled by 1/0.9."""
    b, s, h = 8, 64, 4
    fwd = encoder_attention_fwd_savep if savep else encoder_attention_fwd
    out, _ = fwd(_probe_qkv(b, s, h), h, dropout_rate=RATE, seed=12345)
    p = split_heads(torch.cat([out] * 3, dim=-1), h)[0][..., :s]
    kept = p > 0
    assert abs(float(kept.float().mean()) - 0.9) <= 0.005
    np.testing.assert_allclose(p[kept].numpy(), 1.0 / (s * 0.9), rtol=1e-6)


def test_rate_out_of_range_raises_and_cpu_counts_no_launch():
    qkv = torch.zeros(1, 5, 3 * D)
    counters = ("LAUNCHES", "BWD_LAUNCHES", "SAVEP_LAUNCHES",
                "SAVEP_BWD_LAUNCHES", "DROPOUT_LAUNCHES",
                "DROPOUT_BWD_LAUNCHES", "DROPOUT_SAVEP_LAUNCHES",
                "DROPOUT_SAVEP_BWD_LAUNCHES")
    before = [getattr(encoder_attention, c) for c in counters]
    _port_fwd_bwd("default", qkv, torch.zeros(1, 5, D))
    _port_fwd_bwd("savep", qkv, torch.zeros(1, 5, D))
    assert [getattr(encoder_attention, c) for c in counters] == before
    for rate in (-0.1, 1.0):
        with pytest.raises(ValueError, match="rate"):
            encoder_attention_fwd(qkv, H, dropout_rate=rate, seed=1)
        with pytest.raises(ValueError, match="rate"):
            encoder_attention_fwd_savep(qkv, H, dropout_rate=rate, seed=1)


@pytest.mark.parametrize("name", [
    "encoder_attention_fwd", "encoder_attention_bwd",
    "encoder_attention_savep_fwd", "encoder_attention_savep_bwd"])
def test_sources_carry_the_dropout_branch(name):
    """Each source (with the shared body it includes: the forward's is
    attention_fwd.cuh) draws encoder_tile.cuh's shared mask under a
    template flag, keyed on the global (b0 + b)·H + h0 + h, and takes the
    (seed, threshold, inv_keep, dropout) arguments and the mask offsets
    (b0, mask_heads, h0) the wrapper passes."""
    text = build.source_path(name).read_text()
    body = text + "".join(
        (build.CSRC_DIR / header).read_text()
        for header in re.findall(r'#include "(\w+\.cuh)"', text))
    assert "keeps(drop, mbh," in body and "kDrop" in body
    assert "const uint32_t mbh = drop.bh(" in body
    head = text[text.index(f'extern "C" int arsvt_{name}'):]
    head = head[:head.index("{")]
    assert all(w in head for w in ("uint32_t seed", "uint32_t threshold",
                                   "float inv_keep", "int dropout", "int b0",
                                   "int mask_heads", "int h0"))
    tile = (build.CSRC_DIR / "encoder_tile.cuh").read_text()
    assert '#include "philox.cuh"' in tile and "philox_bits(" in tile
    assert "(uint32_t)((b0 + b) * heads + h0 + h)" in tile


_BLOCK_CFG = BackboneConfig(image_size=16, patch_size=8, embed_dim=D,
                            depth=1, num_heads=H, mlp_dim=2 * D,
                            attn_dropout=RATE)


def _block_loss_and_grads(x_np, w_np, rng, monkeypatch, savep):
    monkeypatch.delenv("ARSVT_DISABLE_PALLAS", raising=False)
    if savep:
        monkeypatch.setenv("ARSVT_ATTN_SAVE_PROBS", "1")
    else:
        monkeypatch.delenv("ARSVT_ATTN_SAVE_PROBS", raising=False)
    params = init_backbone(_BLOCK_CFG, seed=0)["blocks"][0]
    leaves = [params["attn"]["qkv"]["kernel"], params["attn"]["proj"][
        "kernel"], params["mlp"]["fc1"]["kernel"]]
    for t in leaves:
        t.requires_grad_(True)
    x = torch.from_numpy(x_np).requires_grad_(True)
    out = vit._encoder_block(x, params, _BLOCK_CFG, train=True, rng=rng)
    loss = (torch.from_numpy(w_np) * out).sum()
    return loss.detach(), torch.autograd.grad(loss, [x, *leaves])


def test_vit_block_dropout_on_both_routes(monkeypatch):
    """A training ViT block with attn_dropout 0.1, fp32: the default route
    (#1/#2) and the save-probs route (#5/#6) draw one mask from the
    probability site's seed, so their losses agree to 1e-6 relative and
    their gradients within 2^-8 of each one's largest magnitude (the
    save-probs backward reads P in bf16, tests/test_torch_savep.py's
    limits); the same rng repeats a step to the bit, another rng drops
    other probabilities."""
    x_np = _rand((2, _BLOCK_CFG.seq_len, D), 4)
    w_np = _rand((2, _BLOCK_CFG.seq_len, D), 5)
    rng = Rng(3, 0, 0).fold_in(1, 0)
    runs = {savep: _block_loss_and_grads(x_np, w_np, rng, monkeypatch, savep)
            for savep in (False, True)}
    (l0, g0), (l1, g1) = runs[False], runs[True]
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=2.0 ** -8 * float(b.abs().max()))
    again = _block_loss_and_grads(x_np, w_np, rng, monkeypatch, False)
    assert torch.equal(again[0], l0)
    assert all(torch.equal(a, b) for a, b in zip(again[1], g0))
    other = _block_loss_and_grads(x_np, w_np, Rng(4, 0, 0).fold_in(1, 0),
                                  monkeypatch, False)
    assert not torch.equal(other[0], l0)
    # without dropout the block differs from both
    nodrop = _block_loss_and_grads(x_np, w_np, None, monkeypatch, False)
    assert not torch.equal(nodrop[0], l0)
