"""The reference recipe's training step with its dropout on, against JAX's
own masks: the full-width ``deit_detector_ref`` steps of
``test_torch_reference_recipe.py::recipe_steps`` (fp32, batch 8, triplet
on, JAX's augmentation draws fed in) with the preset's residual and
positional dropout 0.1 at every site and the row's attention dropout 0.1,
on both sides, held at the dropout-0 test's limits.

On the CPU the JAX package runs no Pallas kernel, so each mask its model
draws is a ``jax.random.bernoulli`` on a known key (``arsvt_tpu/models/
vit.py:140-145``, ``arsvt_tpu/ops/attention.py:44-47``). JAX's step is
traced with ``jax.random.bernoulli`` wrapped: each draw traced inside
``apply_detector`` (the augmentation's draws are fed to the port as draws,
not masks) gets an ordered ``jax.debug.callback`` that records the mask,
keyed by the key's data, in the order the compiled step draws them.
The port draws every mask through ``ops/dropout.py::keep_mask`` (the
residual, positional and reference-attention sites through
``dropout_apply_plain``, #3/#4's plain versions through
``ops/flash_attention.py``); the replay returns, for each site seed, the
JAX mask whose key first appeared at the same place in the forward. The
lookup is by seed, so a backward that draws its mask again from the seed
(`SiteDropout.backward`, #4's plain version, a rematerialised block) gets
the forward's mask. Every site's shape, under the port's view of it, and
the number of sites on each side are held equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from arsvt_tpu.models import registry as jax_registry
from arsvt_tpu.train import detect_step as jax_detect_step
from arsvt_tpu_torch.models import registry
from arsvt_tpu_torch.ops import dropout as port_dropout
from arsvt_tpu_torch.ops import encoder_attention, flash_attention
from test_torch_reference_recipe import (
    STEPS,
    _jax_config,
    check_recipe_steps,
    recipe_steps,
)

torch.set_num_threads(1)  # tier-1 runs several xdist workers

# the recipe's rates: the preset's residual and positional dropout, the
# ablation row's attention dropout
RATE = 0.1


def _site_count(det) -> int:
    """Masks a forward of `det` draws: the positional site, then per
    encoder block its attention and two residual sites, per decoder block
    its self- and cross-attention and three residual sites."""
    return 1 + 3 * det.backbone.depth + 5 * det.head.depth


class MaskReplay:
    """Records the masks JAX's model draws and serves them to the port's
    `keep_mask`, site by site in order of first appearance."""

    def __init__(self):
        self.masks = {}  # JAX key data -> mask (numpy bool)
        self.order = []  # JAX key data, in order of first appearance
        self.seeds = {}  # port site seed -> its place in `order`
        self.in_model = False
        self.port_shapes = []  # (JAX shape, port view) of each port site

    def record(self, data, mask):
        name = np.asarray(data).tobytes()
        if name not in self.masks:
            self.order.append(name)
            self.masks[name] = np.array(mask, dtype=bool)

    def bernoulli(self, real):
        def draw(key, *args, **kwargs):
            mask = real(key, *args, **kwargs)
            if self.in_model:  # a draw traced inside apply_detector
                data = key
                if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
                    data = jax.random.key_data(key)
                jax.debug.callback(self.record, data, mask, ordered=True)
            return mask
        return draw

    def model(self, real):
        def apply(*args, **kwargs):
            self.in_model = True
            try:
                return real(*args, **kwargs)
            finally:
                self.in_model = False
        return apply

    def keep_mask(self, seed, batch, heads, sq, sk, rate, device="cpu", *,
                  offsets=None):
        assert rate == pytest.approx(RATE)
        assert port_dropout.mask_offsets(offsets, heads) == (0, heads, 0)
        place = self.seeds.setdefault(int(seed), len(self.seeds))
        assert place < len(self.order), (
            f"the port draws a site JAX does not: {place + 1} > "
            f"{len(self.order)}")
        mask = self.masks[self.order[place]]
        view = (batch, heads, sq, sk)
        if place == len(self.port_shapes):
            self.port_shapes.append((mask.shape, view))
        # a residual or positional site (B, S, D) is (B, 1, S, D) in the
        # port's view (`site_view`); an attention site is (B, H, Sq, Sk)
        got = mask[:, None] if mask.ndim == 3 else mask
        assert got.shape == view, (place, mask.shape, view)
        return torch.from_numpy(got.copy()).to(device)


def replay_recipe_steps(root: str) -> tuple:
    """`recipe_steps` (data under `root`) with the recipe's dropout on
    both sides and JAX's masks replayed into the port; returns (steps,
    replay)."""
    replay = MaskReplay()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli",
                   replay.bernoulli(jax.random.bernoulli))
        mp.setattr(jax_detect_step, "apply_detector",
                   replay.model(jax_detect_step.apply_detector))
        for module in (port_dropout, flash_attention, encoder_attention):
            mp.setattr(module, "keep_mask", replay.keep_mask)
        steps = recipe_steps(root)
    return steps, replay


@pytest.fixture(scope="module")
def replayed_steps(tmp_path_factory):
    return replay_recipe_steps(str(tmp_path_factory.mktemp("ref_coco")))


def test_the_recipe_drops_at_every_site():
    """The configuration `replayed_steps` trains: the preset's residual and
    positional dropout and the row's attention dropout, all at RATE, in
    both registries."""
    cfg = _jax_config()
    assert cfg.attn_dropout == RATE
    for reg in (jax_registry, registry):
        det = reg.DETECTOR_PRESETS[cs.REF_GEN_TRAIN_PRESET]
        assert det.backbone.dropout == det.head.dropout == RATE


def test_every_site_is_replayed(replayed_steps):
    """Each side draws the same number of masks, STEPS times a forward's
    sites, and each JAX mask has the shape of the port site it feeds; no
    two sites of a step share a seed."""
    _, replay = replayed_steps
    det = registry.DETECTOR_PRESETS[cs.REF_GEN_TRAIN_PRESET]
    assert len(replay.order) == len(replay.seeds) == len(
        replay.port_shapes) == STEPS * _site_count(det)
    kinds = {}
    for jax_shape, view in replay.port_shapes:
        kind = "residual" if len(jax_shape) == 3 else "attention"
        kinds[kind] = kinds.get(kind, 0) + 1
    assert kinds == {
        "residual": STEPS * (1 + 2 * det.backbone.depth + 3 * det.head.depth),
        "attention": STEPS * (det.backbone.depth + 2 * det.head.depth)}
    # the masks really drop at the rate: the kept share of all sites
    kept = np.mean([replay.masks[k].mean() for k in replay.order])
    assert abs(kept - (1.0 - RATE)) < 0.01


@pytest.mark.parametrize("quantity", ["loss", "grad_norm", "first_moment",
                                      "update", "params"])
def test_recipe_steps_with_dropout_match_jax(quantity, replayed_steps):
    """`check_recipe_steps` (the dropout-0 test's limits) on the steps with
    the recipe's dropout, JAX's masks replayed."""
    steps, _ = replayed_steps
    check_recipe_steps(quantity, steps)


def observed_errors(steps: list) -> list:
    """Per step, the errors `check_recipe_steps` holds: the loss's and
    the gradient norm's relative error, and the relative L2 errors of the
    first moment, the update (0 at the warm-up's first step, where both
    are 0) and the parameters."""
    def rl2(pair):
        port, ref = pair
        norm = np.linalg.norm(ref)
        return float(np.linalg.norm(port - ref) / norm) if norm else 0.0

    out = []
    for rec in steps:
        port, ref = rec["metrics"]
        out.append({
            **{k: abs(port[k] - ref[k]) / abs(ref[k])
               for k in ("loss", "grad_norm")},
            "first_moment": rl2(rec["mu"]), "update": rl2(rec["update"]),
            "params": rl2(rec["params"])})
    return out


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_recipe_dropout.py
    # prints each step's observed errors beside the limits they are held to
    import json
    import tempfile

    from test_torch_reference_recipe import (RL2_MOMENT, RL2_PARAMS,
                                             RL2_UPDATE, RTOL_LOSS,
                                             RTOL_NORM)

    with tempfile.TemporaryDirectory() as root:
        steps, replay = replay_recipe_steps(root)
    print(json.dumps({
        "sites": len(replay.order), "errors": observed_errors(steps),
        "limits": {"loss": RTOL_LOSS, "grad_norm": RTOL_NORM,
                   "first_moment": RL2_MOMENT, "update": RL2_UPDATE,
                   "params": RL2_PARAMS}}, indent=1))
