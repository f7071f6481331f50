"""Every dropout mask of the port is a function of the site's seed and of
global indices (``ops/dropout.py``): the residual and positional sites
over the (B, 1, S, D) view, the reference attention over the (B, H, Sq,
Sk) probabilities of the head-major kernels, and the kernels themselves,
with the offsets (b0, H, h0) of a data- or tensor-parallel rank. So a
rank's mask is the rows and heads of the one-process mask, on every
device (the card's apply kernel draws ``keep_mask``'s bits: ``chip_smoke.py``
phase 3(a)), and a forward on a slice of the batch, told its first row,
equals those rows of the forward on the whole batch. The masks are read
through ``keep_mask`` and through the sites themselves: `dropout_apply`
and `dropout` on ones keep exactly the mask's elements (``y != 0``).

JAX draws these masks with ``jax.random.bernoulli``, whose bits the port
cannot reproduce (ROADMAP: random draws are held by statistics); the kept
share is held at ``tests/test_torch_dropout.py``'s limits."""

import numpy as np
import pytest
import torch

from arsvt_tpu_torch.core.prng import Rng
from arsvt_tpu_torch.models.vit import BackboneConfig, apply_backbone, init_backbone
from arsvt_tpu_torch.ops import build, dropout as dropout_ops
from arsvt_tpu_torch.ops.attention import sdpa_reference
from arsvt_tpu_torch.ops.dropout import (
    dropout,
    dropout_apply,
    keep_mask,
)
from arsvt_tpu_torch.ops.encoder_attention import encoder_attention_fwd
from arsvt_tpu_torch.ops.flash_attention import flash_attention_fwd

torch.set_num_threads(1)  # tier-1 runs several xdist workers

RATE = 0.1
SEED = 0xDEADBEEF


@pytest.mark.parametrize("b0", [0, 3, 6])
def test_a_data_rank_draws_the_rows_of_the_whole_mask(b0):
    """Rows [b0, b0 + 3) of a 9-row microbatch, at the offset b0, are the
    one-process mask's rows b0.. (residual view and attention view)."""
    whole = keep_mask(SEED, 9, 1, 17, 40, RATE)
    part = keep_mask(SEED, 3, 1, 17, 40, RATE, offsets=(b0, 1, 0))
    assert torch.equal(part, whole[b0:b0 + 3])
    view = (3, 1, 17, 40)
    applied = dropout_apply(torch.ones(view), SEED, RATE, (b0, 1, 0), view,
                            "mul") != 0
    assert torch.equal(applied, whole[b0:b0 + 3])
    heads = keep_mask(SEED, 9, 4, 11, 11, RATE)
    assert torch.equal(keep_mask(SEED, 3, 4, 11, 11, RATE,
                                 offsets=(b0, 4, 0)), heads[b0:b0 + 3])


@pytest.mark.parametrize("h0,count", [(0, 13), (13, 12), (5, 3)])
def test_a_model_rank_draws_the_heads_of_the_whole_mask(h0, count):
    """Heads [h0, h0 + count) of 25, at a batch offset too."""
    whole = keep_mask(SEED, 4, 25, 6, 9, RATE)
    part = keep_mask(SEED, 2, count, 6, 9, RATE, offsets=(2, 25, h0))
    assert torch.equal(part, whole[2:4, h0:h0 + count])


def test_site_mask_is_keyed_on_the_global_row():
    """`dropout` at a residual site: an Rng told its slice's first row
    draws the rows of the whole batch's mask; the seed does not change
    with the row (every rank holds the same Rng)."""
    x = torch.ones(8, 5, 12)
    rng = Rng(7, 2, 1).fold_in(1, 3)
    whole = dropout(x, RATE, rng, train=True) != 0
    for b0 in (0, 4):
        part = dropout(x[b0:b0 + 4], RATE, rng.at_row(b0), train=True) != 0
        assert torch.equal(part, whole[b0:b0 + 4])
    y = dropout(x, RATE, rng.at_row(4), train=True)
    np.testing.assert_array_equal((y[:4] != 0).numpy(), whole[4:].numpy())
    assert torch.equal(whole.reshape(8, 1, 5, 12),
                       keep_mask(rng.seed32(), 8, 1, 5, 12, RATE))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_kept_share_of_a_site(rate):
    """Over a million elements the kept share is 1 - rate within 0.005
    (``test_torch_dropout.py``'s limit), and every row keeps about its
    share: no structure along the batch, token or feature axis."""
    x = torch.ones(16, 256, 256)
    kept = dropout(x, rate, Rng(11), train=True) != 0
    assert kept.numel() >= 10**6
    assert abs(float(kept.float().mean()) - (1 - rate)) <= 0.005
    for axis in (0, 1, 2):
        share = kept.float().mean(dim=tuple(a for a in range(3) if a != axis))
        assert float((share - (1 - rate)).abs().max()) < 0.05


def test_reference_attention_on_a_rank_draws_its_heads():
    """sdpa_reference with head_range (h0, H) over a rank's heads equals
    those heads of the one-process reference, and both equal the
    head-major kernel's plain version, which draws the same mask."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(3, 5, 7, 16, generator=g) for _ in range(3))
    rng = Rng(4, 0)
    whole = sdpa_reference(q, k, v, dropout_rate=RATE, dropout_rng=rng)
    part = sdpa_reference(q[:, 2:4], k[:, 2:4], v[:, 2:4], dropout_rate=RATE,
                          dropout_rng=rng.at_row(0), head_range=(2, 5))
    np.testing.assert_allclose(part.numpy(), whole[:, 2:4].numpy(),
                               atol=1e-6)
    rows = sdpa_reference(q[1:], k[1:], v[1:], dropout_rate=RATE,
                          dropout_rng=rng.at_row(1))
    np.testing.assert_allclose(rows.numpy(), whole[1:].numpy(), atol=1e-6)
    kernel, _ = flash_attention_fwd(q, k, v, dropout_rate=RATE,
                                    seed=rng.seed32())
    np.testing.assert_allclose(whole.numpy(), kernel.numpy(), atol=1e-5)


def test_kernel_plain_versions_take_the_offsets():
    """#1's and #3's plain versions at a rank's offsets equal the rows and
    heads of the one-process call."""
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn(4, 9, 3 * 128, generator=g)
    whole, _ = encoder_attention_fwd(qkv, 2, dropout_rate=RATE, seed=SEED)
    part, _ = encoder_attention_fwd(qkv[2:], 2, dropout_rate=RATE, seed=SEED,
                                    offsets=(2, 2, 0))
    np.testing.assert_allclose(part.numpy(), whole[2:].numpy(), atol=1e-6)
    q, k, v = (torch.randn(2, 6, 5, 16, generator=g) for _ in range(3))
    whole, _ = flash_attention_fwd(q, k, v, dropout_rate=RATE, seed=SEED)
    part, _ = flash_attention_fwd(q[:, 3:], k[:, 3:], v[:, 3:],
                                  dropout_rate=RATE, seed=SEED,
                                  offsets=(0, 6, 3))
    np.testing.assert_allclose(part.numpy(), whole[:, 3:].numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="do not hold"):
        flash_attention_fwd(q, k, v, dropout_rate=RATE, seed=SEED,
                            offsets=(0, 6, 1))


@pytest.mark.parametrize("heads", [2, 8], ids=["head_dim64", "head_dim16"])
def test_a_slice_of_the_batch_is_rows_of_the_whole_forward(heads):
    """A training forward (positional, residual and attention dropout 0.1)
    of rows [3, 6) with an Rng told row 3 equals rows 3.. of the forward
    of all 6 rows: on the fused #1/#2 route (head_dim 64) and the #3/#4
    route (head_dim 16)."""
    cfg = BackboneConfig(image_size=16, patch_size=8, embed_dim=128, depth=2,
                         num_heads=heads, mlp_dim=256, dropout=RATE,
                         attn_dropout=RATE)
    params = init_backbone(cfg, seed=3)
    images = torch.rand(6, 16, 16, 3, generator=torch.Generator()
                        .manual_seed(2))
    rng = Rng(5, 0, 1)
    whole = apply_backbone(params, images, cfg, train=True, rng=rng)
    part = apply_backbone(params, images[3:], cfg, train=True,
                          rng=rng.at_row(3))
    np.testing.assert_allclose(part.detach().numpy(),
                               whole[3:].detach().numpy(), atol=1e-5)
    other = apply_backbone(params, images[3:], cfg, train=True, rng=rng)
    assert not torch.allclose(other, whole[3:], atol=1e-3)


def test_mask_wrapper_takes_cpu_or_cuda_only():
    """The site's wrapper: on a CPU tensor the plain version, its mask
    `keep_mask`'s; another device raises (on a CUDA tensor the kernel
    launches or raises: no fallback)."""
    n = dropout_ops.APPLY_LAUNCHES
    view = (1, 1, 2, 3)
    kept = dropout_apply(torch.ones(view), SEED, RATE, None, view, "mul")
    assert dropout_ops.APPLY_LAUNCHES == n  # the plain version counts nothing
    assert torch.equal(kept != 0, keep_mask(SEED, *view, RATE))
    with pytest.raises(ValueError, match="cpu or cuda"):
        dropout_apply(torch.ones(view, device="meta"), SEED, RATE, None,
                      view, "mul")


def test_mask_kernel_source_draws_the_kernels_rule():
    """csrc/dropout_mask.cu's one entry, the apply kernel, draws the
    kernels' rule (encoder_tile.cuh's Dropout) at the global key word
    `drop.bh(b, h)` and takes the offsets; the mask-only entry is gone."""
    text = build.source_path("dropout_mask").read_text()
    assert '#include "encoder_tile.cuh"' in text
    assert "s.drop.bh(" in text and "enc::Dropout drop" in text
    head = text[text.index('extern "C" int arsvt_dropout_apply'):]
    head = head[:head.index("{")]
    for word in ("uint32_t seed", "uint32_t threshold", "int b0",
                 "int mask_heads", "int h0"):
        assert word in head
    assert text.count('extern "C"') == 1
    assert "arsvt_dropout_mask" not in text
    assert "dropout_mask" in build.kernel_names()
