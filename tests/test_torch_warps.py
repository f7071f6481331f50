"""The port's resamplers (``data/augment.py``) against the JAX package's on
the CPU: the gather warps ``taps``, ``flat`` and ``patch`` (one body in
the port, held against each JAX function), Lanczos-4, the shear warp's
chunking over images, and ``ARSVT_AUGMENT_BF16`` through the detection
pipeline.

Both sides get the same out->src matrix (JAX's own inverse), so the
source positions differ only by the summation order of a 3-term product:
fp32 pixels within 1e-5 (the detection warp tests' limit). In bf16 each
side rounds every product of the blend to bf16 in its own order: within
2^-7 (two bf16 steps near 1)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arsvt_tpu.data import augment as jax_augment
from arsvt_tpu_torch.data import augment
from test_torch_detect_augment import (
    JCFG,
    PCFG,
    _batch,
    _jax_draws,
    _keys,
    _pixels,
    _stack_draws,
)

torch.set_num_threads(1)  # tier-1 runs several xdist workers

ATOL = 1e-5
ATOL_BF16 = 2.0 ** -7
# the whole detection pipeline in bf16: the warp, jitter, dropout and the
# resize each round to bf16 (a step is 2^-8 near 1), two sides in their
# own orders: within four steps
ATOL_BF16_PIPELINE = 2.0 ** -6
GATHERS = ("taps", "flat", "patch")


@pytest.fixture(autouse=True)
def _fp32_and_no_switches(monkeypatch):
    for env in ("ARSVT_AUGMENT_BF16", "ARSVT_WARP_VARIANT",
                "ARSVT_SHEAR_MAXSKEW"):
        monkeypatch.delenv(env, raising=False)
    with jax.default_matmul_precision("highest"):
        yield


def _inverses(n, size, seed):
    """n of JAX's own affine maps (the detection ranges) and inverses."""
    out = []
    for k in _keys(n, seed):
        km = jax.random.split(jax.random.split(k, 5)[2])[1]
        fwd = jax_augment._affine_matrix(km, size, size, degrees=45.0,
                                         scale=(0.95, 1.05), translate=0.05,
                                         shear=15.0)
        out.append(np.asarray(jnp.linalg.inv(fwd)))
    return np.stack(out)


@pytest.mark.parametrize("variant", GATHERS)
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_gather_warp_matches_jax(variant, bf16, monkeypatch):
    """`bilinear_warp(variant)` against ``_bilinear_warp_<variant>``, also
    under ``ARSVT_AUGMENT_BF16`` (both sides warp in bf16)."""
    if bf16:
        monkeypatch.setenv("ARSVT_AUGMENT_BF16", "1")
    images, _, _ = _batch(3, 24, 1, seed=30)
    inv = _inverses(3, 24, 31)
    ref = np.stack([np.asarray(jax_augment._bilinear_warp(
        jnp.asarray(im), jnp.asarray(m), variant=variant).astype(
            jnp.float32)) for im, m in zip(images, inv)])
    got = augment.bilinear_warp(torch.from_numpy(images),
                                torch.from_numpy(inv), variant)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_allclose(got.float().numpy(), ref,
                               atol=ATOL_BF16 if bf16 else ATOL, rtol=0)
    assert np.abs(ref).max() > 0.5  # the warp kept content


def test_lanczos4_warp_matches_jax():
    """8 x 8 taps, border 0, no renormalisation, clamped: against
    ``_lanczos4_warp``."""
    images, _, _ = _batch(3, 24, 1, seed=32)
    inv = _inverses(3, 24, 33)
    ref = np.stack([np.asarray(jax_augment._lanczos4_warp(
        jnp.asarray(im), jnp.asarray(m))) for im, m in zip(images, inv)])
    got = augment.lanczos4_warp(torch.from_numpy(images),
                                torch.from_numpy(inv))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    weights = augment._lanczos4_weights(torch.rand(50))
    np.testing.assert_allclose(sum(weights).numpy(), 1.0, atol=1e-6)


def test_shear_warp_chunks_over_images_to_the_bit(monkeypatch):
    """A band budget of one image's bytes splits 5 images into 5 chunks:
    the same result to the bit as one chunk."""
    images, _, _ = _batch(5, 24, 1, seed=34)
    inv = torch.from_numpy(_inverses(5, 24, 35))
    whole = augment.shear_matmul_warp(torch.from_numpy(images), inv)
    calls = []
    chunk = augment._shear_chunk
    monkeypatch.setattr(augment, "_shear_chunk",
                        lambda im, m: calls.append(len(im)) or chunk(im, m))
    monkeypatch.setattr(augment, "_BAND_BYTES", 1)
    parts = augment.shear_matmul_warp(torch.from_numpy(images), inv)
    assert calls == [1] * 5
    assert torch.equal(parts, whole)


@pytest.mark.parametrize("variant", ["shear_matmul", "taps"])
def test_detection_augment_in_bf16_matches_jax(variant, monkeypatch):
    """``ARSVT_AUGMENT_BF16`` on both sides, as the detector steps run it:
    the input cast to bf16, shadow promoting back to fp32 (its fp32
    factor), the warp and everything after it in bf16. Eight images on a
    40 canvas to 32, every op applied."""
    monkeypatch.setenv("ARSVT_AUGMENT_BF16", "1")
    images, boxes, mask = _batch(8, 40, 5, seed=36)
    keys = _keys(8, 37)
    jcfg = dataclasses.replace(JCFG, warp_variant=variant)
    pcfg = dataclasses.replace(PCFG, warp_variant=variant)
    refs = [jax_augment.detection_train_augment(
        k, jax_augment.augment_input_cast(jnp.asarray(im)), jnp.asarray(bx),
        jnp.asarray(ms), jcfg) for k, im, bx, ms in zip(keys, images, boxes,
                                                         mask)]
    draws = _stack_draws([_jax_draws(k) for k in keys])
    assert int(draws.affine_apply.sum()) > 0
    assert refs[0][0].dtype == jnp.bfloat16
    got = augment.detection_train_augment(
        augment.augment_input_cast(torch.from_numpy(images)),
        torch.from_numpy(boxes), torch.from_numpy(mask), draws, pcfg)
    assert got[0].dtype == torch.bfloat16
    ref_px = _pixels(np.stack([np.asarray(r[0].astype(jnp.float32))
                               for r in refs]))
    np.testing.assert_allclose(_pixels(got[0].float().numpy()), ref_px,
                               atol=ATOL_BF16_PIPELINE, rtol=0)
    np.testing.assert_allclose(
        got[1].numpy(), np.stack([np.asarray(r[1]) for r in refs]),
        atol=ATOL)
    np.testing.assert_array_equal(got[2].numpy(),
                                  np.stack([np.asarray(r[2]) for r in refs]))
