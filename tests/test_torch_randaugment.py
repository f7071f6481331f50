"""The port's RandAugment (``data/augment.py``) against the JAX package's
``rand_augment`` and ``_ra_*`` ops on the CPU, fed JAX's own draws.

Each round of JAX's fused two-round form draws an op index from one key
and exactly one scalar from its parameter key: ``uniform(0, 1)`` or
``uniform(-1, 1)`` of the same bits. The port's draws are the index and
that uniform in [0, 1); the tests replay JAX's key chain and hand both to
the port's apply function.

Tolerances: the pointwise ops are the same fp32 arithmetic (atol 1e-6);
a rotate also inverts a 3 x 3 matrix in another library, which moves a
source position by ~1e-7 pixel (atol 1e-5, the detection warp tests'
limit); W(0) is the identity to the bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arsvt_tpu.data import augment as jax_augment
from arsvt_tpu_torch.core.prng import generator
from arsvt_tpu_torch.data import augment

torch.set_num_threads(1)  # tier-1 runs several xdist workers

VARIANTS = ("taps", "flat", "patch", "shear_matmul")
POINTWISE = ("posterize", "solarize", "brightness", "contrast", "color",
             "identity")
ATOL_POINTWISE = 1e-6
ATOL_WARP = 1e-5
M = 0.5  # the configs' rand_augment_magnitude


@pytest.fixture(autouse=True)
def _fp32_and_no_switches(monkeypatch):
    for env in ("ARSVT_AUGMENT_BF16", "ARSVT_WARP_VARIANT",
                "ARSVT_SHEAR_MAXSKEW"):
        monkeypatch.delenv(env, raising=False)
    with jax.default_matmul_precision("highest"):
        yield


def _images(n=4, size=20, seed=0):
    return np.random.default_rng(seed).random(
        (n, size, size, 3)).astype(np.float32)


def _ra_draws(key):
    """JAX's draws for one image's ``rand_augment(key)``: the two op
    indices and the uniform in [0, 1) of each round's parameter key."""
    key, kop1, kp1 = jax.random.split(key, 3)
    idx1 = jax.random.randint(kop1, (), 0, len(augment.RA_OPS))
    _, kop2, kp2 = jax.random.split(key, 3)
    idx2 = jax.random.randint(kop2, (), 0, len(augment.RA_OPS))
    return ((int(idx1), int(idx2)),
            (float(jax.random.uniform(kp1, ())),
             float(jax.random.uniform(kp2, ()))), (kp1, kp2))


def _draws_of(keys):
    rows = [_ra_draws(k) for k in keys]
    return augment.RandAugmentDraws(
        op=torch.tensor([r[0] for r in rows], dtype=torch.int64),
        u=torch.tensor([r[1] for r in rows], dtype=torch.float32))


def _keys_with(want, count=1, start=0):
    """`count` keys whose two drawn ops satisfy want(idx1, idx2)."""
    out = []
    i = start
    while len(out) < count:
        key = jax.random.PRNGKey(i)
        (a, b), _, _ = _ra_draws(key)
        if want(a, b):
            out.append(key)
        i += 1
    return out


def test_each_param_draw_is_one_uniform_of_the_key():
    """uniform(-1, 1) of a key is 2 u - 1 for u = uniform(0, 1) of the
    same key, to the bit: one stored u serves every op."""
    for i in range(64):
        k = jax.random.PRNGKey(i)
        u = torch.tensor(float(jax.random.uniform(k, ())))
        signed = float(jax.random.uniform(k, (), minval=-1.0, maxval=1.0))
        assert float(augment._signed(u)) == signed


@pytest.mark.parametrize("op", POINTWISE)
def test_pointwise_op_matches_jax(op):
    """One round's op on 4 images, each with its own key, against
    JAX's ``_ra_<op>(key, image, 0.5)``."""
    imgs = _images()
    keys = [jax.random.PRNGKey(10 + i) for i in range(4)]
    fn = getattr(jax_augment, f"_ra_{op}")
    ref = np.stack([np.asarray(fn(k, jnp.asarray(im), M))
                    for k, im in zip(keys, imgs)])
    u = torch.tensor([float(jax.random.uniform(k, ())) for k in keys])
    k = augment.RA_OPS.index(op)
    got = augment.ra_pointwise(torch.from_numpy(imgs),
                               torch.full((4,), k), u, M)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL_POINTWISE, rtol=0)


@pytest.mark.parametrize("variant", VARIANTS)
def test_rotate_matches_jax(variant):
    """``_ra_rotate`` (the angle drawn from the key) on each warp."""
    imgs = _images()
    keys = [jax.random.PRNGKey(20 + i) for i in range(4)]
    ref = np.stack([np.asarray(jax_augment._ra_rotate(
        k, jnp.asarray(im), M, variant=variant)) for k, im in zip(keys, imgs)])
    u = torch.tensor([float(jax.random.uniform(k, ())) for k in keys])
    deg = augment._signed(u) * 30.0 * M
    got = augment.ra_rotate_by_deg(torch.from_numpy(imgs), deg, variant)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL_WARP, rtol=0)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rotate_by_zero_is_the_identity(variant, dtype, monkeypatch):
    """W(0) returns its input to the bit on every variant (JAX's
    ``tests/test_data.py`` pins the same for its warps), also in bf16:
    what lets `rand_augment` warp only the images that rotate."""
    if dtype == torch.bfloat16:
        monkeypatch.setenv("ARSVT_AUGMENT_BF16", "1")
    imgs = torch.from_numpy(_images()).to(dtype)
    got = augment.ra_rotate_by_deg(imgs, torch.zeros(4), variant)
    assert got.dtype == dtype
    assert torch.equal(got, imgs)
    ref = jax_augment._ra_rotate_by_deg(jnp.asarray(_images(1)[0]), 0.0,
                                        variant=variant)
    np.testing.assert_array_equal(np.asarray(ref.astype(jnp.float32)),
                                  imgs[0].float().numpy())


@pytest.mark.parametrize("lane", ["mixed", "both_rotate", "one_rotate",
                                  "no_rotate"])
def test_rand_augment_matches_jax(lane):
    """The fused form on 6 images against ``vmap(rand_augment)`` with the
    same keys: random op pairs, pairs where both rounds rotate (the 1/49
    lane, one resample at the summed angle), where exactly one rotates,
    and where none does (no warp at all in the port)."""
    want = {"mixed": lambda a, b: True,
            "both_rotate": lambda a, b: a == b == 0,
            "one_rotate": lambda a, b: (a == 0) != (b == 0),
            "no_rotate": lambda a, b: a != 0 and b != 0}[lane]
    keys = _keys_with(want, count=6)
    imgs = _images(6, seed=1)
    ref = jax.vmap(lambda k, im: jax_augment.rand_augment(k, im))(
        jnp.stack(keys), jnp.asarray(imgs))
    got = augment.rand_augment(torch.from_numpy(imgs), _draws_of(keys))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL_WARP,
                               rtol=0)


def test_both_rotate_lane_is_one_warp_not_two():
    """Where both rounds draw rotate, JAX's code resamples once at θ1 + θ2
    and so keeps border pixels that two warps in a row would zero (its
    docstring says sequential): the port follows the code."""
    key = _keys_with(lambda a, b: a == b == 0)[0]
    (_, _), (u1, u2), _ = _ra_draws(key)
    img = np.ones((1, 20, 20, 3), np.float32)
    draws = _draws_of([key])
    fused = augment.rand_augment(torch.from_numpy(img), draws)
    d1, d2 = (augment._signed(torch.tensor([u])) * 30.0 * M for u in (u1, u2))
    twice = augment.ra_rotate_by_deg(
        augment.ra_rotate_by_deg(torch.from_numpy(img), d1), d2)
    once = augment.ra_rotate_by_deg(torch.from_numpy(img), d1 + d2)
    assert torch.equal(fused, once)
    assert float(fused.sum()) > float(twice.sum())


def test_randaugment_raises_in_bf16_where_jax_fails(monkeypatch):
    """Under ARSVT_AUGMENT_BF16 JAX's trace fails (lax.switch refuses
    posterize's fp32 branch beside bf16 ones); the port raises
    TypeError, in the apply, on bf16 input as well."""
    monkeypatch.setenv("ARSVT_AUGMENT_BF16", "1")
    img = jnp.asarray(_images(1)[0], jnp.bfloat16)
    with pytest.raises(TypeError):
        jax_augment.rand_augment(jax.random.PRNGKey(0), img)
    draws = augment.draw_rand_augment(generator(0), 2)
    with pytest.raises(TypeError, match="bf16"):
        augment.rand_augment(torch.from_numpy(_images(2)), draws)
    monkeypatch.delenv("ARSVT_AUGMENT_BF16")
    with pytest.raises(TypeError, match="bf16"):
        augment.rand_augment(torch.from_numpy(_images(2)).bfloat16(), draws)


def test_draw_rand_augment_statistics():
    """Uniform op indices over the seven ops and u uniform in [0, 1):
    4,000 images, shares within 0.025 of 1/7 and the mean within 0.01 of
    1/2; the same generator seed gives the same draws."""
    d = augment.draw_rand_augment(generator(0, 0, 0), 4000)
    assert d.op.shape == (4000, 2) and d.u.shape == (4000, 2)
    shares = torch.bincount(d.op.flatten(), minlength=7).float() / 8000
    assert float((shares - 1 / 7).abs().max()) < 0.025
    assert 0.0 <= float(d.u.min()) and float(d.u.max()) < 1.0
    assert abs(float(d.u.mean()) - 0.5) < 0.01
    again = augment.draw_rand_augment(generator(0, 0, 0), 4000)
    assert torch.equal(d.op, again.op) and torch.equal(d.u, again.u)
    moved = d.to("meta")
    assert moved.op.device.type == "cpu" and moved.u.device.type == "meta"
