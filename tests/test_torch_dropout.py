"""The port's dropout (``ops/dropout.py``, the attention kernels' dropout
branch in their plain versions, ``core/prng.py::Rng``).

JAX's attention kernels draw their mask from the TPU's own generator, so
no bit of it can be reproduced: the port's Philox mask is checked by its
statistics and its determinism, and the attention with dropout is held to
a JAX masked-softmax formula fed the port's own mask, forward and
gradients.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arsvt_tpu_torch.core.prng import Rng
from arsvt_tpu_torch.ops import flash_attention
from arsvt_tpu_torch.ops.attention import merge_heads, sdpa_reference
from arsvt_tpu_torch.ops.dropout import (
    apply_mask,
    dropout,
    keep_bits,
    keep_mask,
    keep_threshold,
)
from arsvt_tpu_torch.ops.flash_attention import (
    flash_attention_fwd,
    flash_self_attention_packed,
)

torch.set_num_threads(1)  # tier-1 runs several xdist workers

RATE = 0.1


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10 whose counter
    words 2 and 3 are 0 (the port's counter is (row, col, 0, 0)): first
    output words, from a plain-integer evaluation of the same rounds."""
    assert int(keep_bits(0, torch.tensor(0), torch.tensor(0),
                         torch.tensor(0))) == 0x6627E8D5
    full = 0xFFFFFFFF
    assert int(keep_bits(full, torch.tensor(full), torch.tensor(full),
                         torch.tensor(full))) == 0x4D18D7D2


def test_keep_threshold_is_jax_rule():
    assert keep_threshold(0.1) == int(0.9 * 2**32)
    assert keep_threshold(0.0) == 2**32 - 1
    for bad in (-0.1, 1.0):
        with pytest.raises(ValueError, match="rate"):
            keep_threshold(bad)


def test_kept_share_over_a_million_draws():
    m = keep_mask(1234, 4, 8, 128, 256, RATE)  # 1,048,576 elements
    assert m.numel() >= 10**6
    assert abs(float(m.float().mean()) - 0.9) <= 0.005
    # no row or column structure: each query row keeps ~90% of its keys
    rows = m.float().mean(dim=-1)
    assert float(rows.min()) > 0.8 and float(rows.max()) < 0.98


def test_mask_is_deterministic_seeded_and_tiling_free():
    a = keep_mask(7, 3, 2, 17, 40, RATE)
    assert torch.equal(a, keep_mask(7, 3, 2, 17, 40, RATE))
    b = keep_mask(8, 3, 2, 17, 40, RATE)
    same = float((a == b).float().mean())
    assert 0.7 < same < 0.95  # independent masks agree on ~0.82
    # element (b, h, i, j) depends on (seed, b*H + h, i, j) alone: a
    # shorter or narrower call sees the same bits at the same place
    assert torch.equal(keep_mask(7, 2, 2, 9, 21, RATE),
                       a[:2, :, :9, :21])
    bits = keep_bits(7, torch.tensor(2 * 2 + 1), torch.arange(17)[:, None],
                     torch.arange(40)[None, :])
    assert torch.equal(bits < keep_threshold(RATE), a[2, 1])


def test_rng_streams():
    r = Rng(3, 5, 0)
    assert r.fold_in(1).keys == (3, 5, 0, 1)
    seeds = {Rng(3, 5, a).fold_in(i).seed32() for a in range(4)
             for i in range(8)}
    assert len(seeds) == 32 and all(0 <= s < 2**32 for s in seeds)
    assert r.seed32() == Rng(3, 5, 0).seed32()
    # a slice's first global row rides beside the keys: same seed, kept
    # through fold_in
    at = r.at_row(6)
    assert at.row0 == 6 and at.seed32() == r.seed32()
    assert at.fold_in(1).row0 == 6 and at.fold_in(1).keys == (3, 5, 0, 1)
    with pytest.raises(ValueError, match="non-negative"):
        Rng(-1)


def _qkv(b, h, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d), (b, h, sq, d)))


def _jax_masked(mask, rate):
    """JAX attention with dropout on the softmax probabilities under a
    given keep mask (``sdpa_reference``'s formula)."""
    def f(q, k, v):
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / jnp.sqrt(
            jnp.float32(q.shape[-1]))
        p = jax.nn.softmax(s, axis=-1)
        p = jnp.where(mask, p / (1.0 - rate), 0.0)
        return jnp.einsum("bhqk,bhkd->bhqd", p, v)
    return f


@pytest.mark.parametrize("shape", [(2, 3, 21, 21, 16), (2, 2, 5, 40, 50),
                                   (1, 2, 17, 17, 192), (1, 2, 5, 33, 320)],
                         ids=["self_d16", "cross_d50", "self_d192",
                              "cross_d320"])
def test_attention_dropout_matches_jax_masked_formula(shape):
    """Forward and gradients of the port's flash_attention with dropout
    against JAX's masked softmax fed the port's mask; fp32, 1e-5."""
    b, h, sq, sk, d = shape
    q, k, v, w = _qkv(b, h, sq, sk, d, seed=sq)
    rng = Rng(11, 0)
    mask = keep_mask(rng.seed32(), b, h, sq, sk, RATE).numpy()
    f = _jax_masked(jnp.asarray(mask), RATE)
    ref_out = f(*(jnp.asarray(a) for a in (q, k, v)))
    ref_grads = jax.grad(lambda *a: jnp.sum(jnp.asarray(w) * f(*a)),
                         argnums=(0, 1, 2))(*(jnp.asarray(a)
                                              for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = flash_attention.flash_attention(tq, tk, tv, dropout_rate=RATE,
                                          dropout_rng=rng)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               atol=1e-5)
    grads = torch.autograd.grad((torch.from_numpy(w) * out).sum(),
                                (tq, tk, tv))
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                   err_msg=name)


def test_forward_mask_recovered_from_a_probe():
    """q = k = 0 makes p uniform and v = I reads p back: O[i, j] is
    keep(i, j) / (Sk·(1 - rate)). The same probe recovers the kernel's
    mask on the card."""
    b, h, s = 2, 3, 24
    q = torch.zeros(b, h, s, s)
    v = torch.eye(s).expand(b, h, s, s).contiguous()
    o, lse = flash_attention_fwd(q, q, v, dropout_rate=RATE, seed=99)
    assert torch.equal(o > 0, keep_mask(99, b, h, s, s, RATE))
    # lse is taken before dropout
    np.testing.assert_allclose(lse.numpy(), np.log(s), rtol=1e-6)


def test_packed_and_unpacked_draw_the_same_mask():
    """The packed self-attention and flash_attention on the split heads,
    with the same rng, give the same output and gradient."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 13, 96)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 13, 32)).astype(np.float32))
    key = Rng(4, 1)
    xa = x.clone().requires_grad_(True)
    out_a = flash_self_attention_packed(xa, 2, dropout_rate=RATE,
                                        dropout_rng=key)
    (ga,) = torch.autograd.grad((w * out_a).sum(), (xa,))
    xb = x.clone().requires_grad_(True)
    q, k, v = xb.reshape(2, 13, 3, 2, 16).permute(2, 0, 3, 1, 4).unbind(0)
    out_b = merge_heads(flash_attention.flash_attention(
        q, k, v, dropout_rate=RATE, dropout_rng=key))
    (gb,) = torch.autograd.grad((w * out_b).sum(), (xb,))
    assert torch.equal(out_a, out_b)
    np.testing.assert_allclose(ga.numpy(), gb.numpy(), atol=1e-6)
    # and without an rng nothing is dropped
    out_c = flash_self_attention_packed(x, 2, dropout_rate=RATE)
    assert not torch.equal(out_c, out_a.detach())


def test_residual_dropout():
    """A residual site's mask is the kernels' rule over the (B, 1, S, D)
    view: kept share, scale, identity cases, dtype."""
    x = torch.ones(4, 50, 500)
    rng = Rng(0, 1)
    y = dropout(x, RATE, rng, train=True)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.005
    np.testing.assert_allclose(y[kept].numpy(), 1 / 0.9, rtol=1e-6)
    want = keep_mask(rng.seed32(), 4, 1, 50, 500, RATE).reshape(x.shape)
    assert torch.equal(kept, want)
    assert dropout(x, RATE, rng, train=False) is x
    assert dropout(x, RATE, None, train=True) is x
    assert dropout(x, 0.0, rng, train=True) is x
    xb = x.bfloat16()
    assert dropout(xb, RATE, rng, train=True).dtype == torch.bfloat16


def test_reference_attention_dropout():
    """The reference draws the kernels' mask of its (B, H, Sq, Sk)
    probabilities: it equals flash_attention with the same rng."""
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(1, 2, 5, 5, 8, seed=3))
    base = sdpa_reference(q, k, v)
    assert torch.equal(sdpa_reference(q, k, v, dropout_rate=RATE), base)

    def run(seed):
        return sdpa_reference(q, k, v, dropout_rate=RATE,
                              dropout_rng=Rng(seed))

    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    # the mask and scaling of the kernels' plain versions, to the bit
    probs = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k)
                          * (1.0 / math.sqrt(q.shape[-1])), dim=-1)
    keep = keep_mask(Rng(1).seed32(), *probs.shape, RATE)
    assert torch.equal(run(1), torch.einsum(
        "bhqk,bhkd->bhqd", apply_mask(probs, keep, RATE), v))
    # the softmax differs from the kernels' by rounding only
    np.testing.assert_allclose(
        run(1).numpy(), flash_attention.flash_attention(
            q, k, v, dropout_rate=RATE, dropout_rng=Rng(1)).numpy(),
        atol=1e-6)
    # the mean over many masks is the undropped attention
    mean = torch.stack([run(s) for s in range(400)]).mean(dim=0)
    np.testing.assert_allclose(mean.numpy(), base.numpy(), atol=0.08)
