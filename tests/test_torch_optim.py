"""The port's optimizer against the JAX package on the CPU: the AdamW
kernel's plain version against the Pallas kernel in interpret mode, the
one-pass update against JAX's `fused_adamw_update` and the optax chain,
the weight-decay mask, the schedules, the plateau controller, the config
and the optimizer-state bridge."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import optax._src.transform as optax_transform
import pytest
import torch

from arsvt_tpu.models.classifier import init_image_classifier as jax_init
from arsvt_tpu.models.vit import BackboneConfig as JaxBackboneConfig
from arsvt_tpu.ops.pallas.fused_adamw import _adamw_leaf_pallas
from arsvt_tpu.train import optim as jax_optim
from arsvt_tpu.train.config import TrainConfig as JaxTrainConfig
from arsvt_tpu_torch.core.dtypes import named_leaves, tree_leaves
from arsvt_tpu_torch.models.bridge import (
    from_jax_params,
    opt_state_from_jax,
    opt_state_to_jax,
)
from arsvt_tpu_torch.models.vit import BackboneConfig
from arsvt_tpu_torch.ops import build
from arsvt_tpu_torch.ops import fused_adamw as port_adamw
from arsvt_tpu_torch.train import optim
from arsvt_tpu_torch.train.config import (
    TRAIN_PRESETS,
    TrainConfig,
    input_canvas,
    resolve_backbone,
)

torch.set_num_threads(1)  # tier-1 runs several xdist workers

SMALL = dict(image_size=32, patch_size=8, embed_dim=128, depth=2,
             num_heads=2, mlp_dim=256)


def _jax_opt_dict(opt_state):
    """The plain dict the bridge takes, read out of the optax chain."""
    adam = jax_optim._find_state(opt_state, optax_transform.ScaleByAdamState)
    sched = jax_optim._find_state(opt_state,
                                  optax_transform.ScaleByScheduleState)
    return jax.tree_util.tree_map(np.asarray, {
        "count": opt_state.count,
        "lr_scale": opt_state.hyperparams["lr_scale"],
        "adam_count": adam.count, "mu": adam.mu, "nu": adam.nu,
        "schedule_count": sched.count,
    })


@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_adamw_plain_matches_pallas_kernel_interpret(wd):
    """One leaf through the Pallas kernel (interpret mode) and the port's
    plain version: the same fp32 operations in the same order, each
    rounded once, so they agree to an ulp: rtol 1e-6, atol 1e-9."""
    rng = np.random.default_rng(0)
    shape = (16, 256)
    g, m, p = (rng.standard_normal(shape).astype(np.float32) * s
               for s in (1e-2, 1e-3, 0.05))
    v = rng.random(shape).astype(np.float32) * 1e-4
    scalars = np.array([0.7, 0.19, 0.001999, 3e-4], np.float32)
    ref = _adamw_leaf_pallas(jnp.asarray(scalars), *(jnp.asarray(a) for a in (
        g, m, v, p)), b1=0.9, b2=0.999, eps=1e-8, wd=wd, interpret=True)
    got = port_adamw.adamw_plain(
        torch.from_numpy(scalars),
        *(torch.from_numpy(a) for a in (g, m, v, p)),
        b1=0.9, b2=0.999, eps=1e-8, wd=wd)
    for name, a, b in zip(("p", "m", "v"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-9, err_msg=name)


def test_fused_adamw_cpu_updates_in_place_without_launch():
    rng = np.random.default_rng(1)
    leaves = [tuple(torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for _ in range(4)) for s in ((3, 5), (7,))]
    for leaf in leaves:
        leaf[2].abs_()  # v >= 0
    want = [port_adamw.adamw_plain(torch.tensor([1.0, 0.1, 0.01, 1e-3]),
                                   *leaf, b1=0.9, b2=0.999, eps=1e-8,
                                   wd=wd)
            for leaf, wd in zip(leaves, (0.1, 0.0))]
    before = port_adamw.LAUNCHES
    port_adamw.fused_adamw(torch.tensor([1.0, 0.1, 0.01, 1e-3]),
                           *zip(*leaves), [True, False], b1=0.9, b2=0.999,
                           eps=1e-8, wd=0.1)
    assert port_adamw.LAUNCHES == before
    for (g, m, v, p), (wp, wm, wv) in zip(leaves, want):
        assert torch.equal(p, wp) and torch.equal(m, wm) and \
            torch.equal(v, wv)
    with pytest.raises(ValueError, match="fp32"):
        port_adamw.fused_adamw(torch.zeros(4), [torch.zeros(2)],
                               [torch.zeros(2)], [torch.zeros(2)],
                               [torch.zeros(2, dtype=torch.float64)],
                               [False], b1=0.9, b2=0.999, eps=1e-8, wd=0.0)
    text = build.source_path("fused_adamw").read_text()
    assert "fused_adamw.py::_adamw_kernel" in text
    assert "__fmul_rn" in text and "__fsqrt_rn" in text


def _leaf_addresses(tensors):
    """Per leaf the byte addresses of its (g, m, v, p)."""
    return [[t.data_ptr() for t in leaf] for leaf in tensors]


# ViT-B-like sizes (a LayerNorm scale, a bias, an MLP weight past many
# chunks), a single element, and sizes around the chunk and float4 edges
_CHUNK = 4096
_NUMELS = [768, 2304, 768 * 3072, 1, 3, 4, 5, _CHUNK - 1, _CHUNK,
           _CHUNK + 1, 2 * _CHUNK + 7]


def _offset_leaves(numels, offset):
    """(g, m, v, p) per leaf, each a view `offset` floats into its
    storage, so the four share a 16-byte phase."""
    return [tuple(torch.zeros(n + offset)[offset:] for _ in range(4))
            for n in numels]


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_chunk_plan_covers_every_element_once_within_its_leaf(offset):
    """Every element of every leaf lies in exactly one chunk; no chunk
    crosses its leaf; a leaf's first chunk takes head + CHUNK elements at
    most, the others CHUNK, so the count of chunks is the least that
    covers it."""
    rows = port_adamw.plan_chunks(
        _NUMELS, _leaf_addresses(_offset_leaves(_NUMELS, offset)), _CHUNK)
    spans = [[] for _ in _NUMELS]
    heads = {}
    for leaf, start, n, head, _ in rows:
        spans[leaf].append((start, start + n))
        if start == 0:
            heads[leaf] = head
    for leaf, (leaf_spans, n) in enumerate(zip(spans, _NUMELS)):
        assert leaf_spans[0][0] == 0 and leaf_spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(leaf_spans, leaf_spans[1:]))
        assert all(0 < stop - start <= _CHUNK + 3
                   for start, stop in leaf_spans)
        rest = max(0, n - heads[leaf] - _CHUNK)
        assert len(leaf_spans) == 1 + -(-rest // _CHUNK)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_chunk_plan_puts_the_float4_interior_on_16_bytes(offset):
    """For aligned leaves and offset views (``torch.zeros(1001)[1:]``),
    every chunk's float4 interior starts on a 16-byte boundary of all four
    operands: the first chunk after `head` scalars, every later chunk at
    its start; a leaf whose operands lie at different phases is scalar."""
    mixed = (torch.zeros(1000), torch.zeros(1001)[1:], torch.zeros(1000),
             torch.zeros(1000))
    numels = _NUMELS + [1000]
    addresses = _leaf_addresses(_offset_leaves(_NUMELS, offset) + [mixed])
    rows = port_adamw.plan_chunks(numels, addresses, _CHUNK)
    for leaf, start, n, head, vec in rows:
        if leaf == len(numels) - 1:
            assert vec == 0 and head == 0
            continue
        assert vec == 1 and 0 <= head <= min(3, n)
        assert head == 0 or start == 0
        for addr in addresses[leaf]:
            assert (addr + 4 * (start + head)) % 16 == 0 or head == n


def test_chunk_table_packs_the_kernel_rows():
    """The table as ``csrc/fused_adamw.cu``'s Chunk reads it: word 0 the
    chunk's first element, then (leaf, n) and (head, flags) as int32
    little-endian, flags 1 for a float4 interior and 2 for weight decay;
    a leaf with mixed phases has no float4 interior."""
    numels = [5, _CHUNK + 9, 7]
    mixed = (torch.zeros(7), torch.zeros(8)[1:], torch.zeros(7),
             torch.zeros(7))
    leaves = _offset_leaves(numels[:2], 1) + [mixed]
    rows = port_adamw.plan_chunks(numels, _leaf_addresses(leaves), _CHUNK)
    table = port_adamw.pack_rows(rows, [False, True, True])
    assert table.shape == (len(rows), port_adamw.ROW_WORDS)
    assert table.dtype == np.int64
    assert table[:, 0].tolist() == [start for _, start, _, _, _ in rows]
    assert table[:, 1:3].view(np.int32).tolist() == [
        [leaf, n, head, vec + 2 * int(leaf > 0)]
        for leaf, _, n, head, vec in rows]
    # a 4-byte view: 3 scalars first; the mixed leaf is scalar throughout
    assert [r[3] for r in rows] == [3, 3, 0, 0]
    assert [r[4] for r in rows] == [1, 1, 1, 0]


@pytest.mark.parametrize("n_elems,sms,per_sm,grid,chunk", [
    (85_803_270, 132, 2, 264, 8192), (85_803_270, 132, 4, 528, 4096),
    (85_803_270, 132, 1, 132, 20480), (10_000, 132, 2, 3, 4096),
    (1, 132, 2, 1, 4096), (4096 * 300, 114, 2, 228, 4096)])
def test_grid_and_chunk_follow_the_occupancy_rule(n_elems, sms, per_sm,
                                                  grid, chunk):
    """A persistent grid of the blocks the SMs hold at once (SMs times
    `arsvt_fused_adamw_blocks_per_sm`), never so many that a block gets
    fewer than MIN_BLOCK_ELEMS elements; chunks of whole rounds of the
    kernel's 256 threads x 4 float4 (4,096 elements), the number nearest
    to CHUNKS_PER_BLOCK a block, at least one."""
    assert port_adamw.MIN_BLOCK_ELEMS == 4096
    assert port_adamw.CHUNKS_PER_BLOCK == 32
    assert port_adamw.grid_size(n_elems, sms, per_sm) == grid
    assert port_adamw.chunk_size(n_elems, grid, 4096) == chunk
    assert chunk % 4096 == 0


def test_fused_adamw_update_matches_jax_and_the_optax_chain():
    """The setup of tests/test_config_optim.py::
    test_fused_adamw_matches_optax: 6 steps with a plateau lr_scale change
    before step 3; params, moments and counts within rtol 2e-6, atol 1e-7
    of both JAX paths."""
    kw = dict(schedule="cosine", warmup_steps=3, total_steps=20,
              learning_rate=3e-3, weight_decay=0.05, grad_clip_norm=0.1)
    jcfg, cfg = JaxTrainConfig(**kw), TrainConfig(**kw)
    opt = jax_optim.make_optimizer(jcfg)
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(8, 16)).astype(np.float32),
              "b": rng.normal(size=(16,)).astype(np.float32)}
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    p_ref, s_ref = jparams, opt.init(jparams)
    p_fus, s_fus = jparams, opt.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = optim.init_opt_state(tparams)
    for step in range(6):
        grads = {"w": (rng.normal(size=(8, 16)) * (1 + step)).astype(
                     np.float32),
                 "b": rng.normal(size=(16,)).astype(np.float32)}
        jgrads = jax.tree_util.tree_map(jnp.asarray, grads)
        if step == 3:
            s_ref = jax_optim.set_lr_scale(s_ref, 0.7)
            s_fus = jax_optim.set_lr_scale(s_fus, 0.7)
            state = optim.set_lr_scale(state, 0.7)
        updates, s_ref = opt.update(jgrads, s_ref, p_ref)
        p_ref = optax.apply_updates(p_ref, updates)
        p_fus, s_fus, jnorm = jax_optim.fused_adamw_update(
            jcfg, jgrads, s_fus, p_fus)
        tparams, state, norm = optim.fused_adamw_update(
            cfg, {k: torch.from_numpy(v) for k, v in grads.items()},
            state, tparams)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    for ref in (p_ref, p_fus):
        for k in params:
            np.testing.assert_allclose(tparams[k].numpy(),
                                       np.asarray(ref[k]), rtol=2e-6,
                                       atol=1e-7, err_msg=k)
    for ref_state in (s_ref, s_fus):
        ref = _jax_opt_dict(ref_state)
        for key in ("count", "adam_count", "schedule_count"):
            assert state[key] == int(ref[key]) == 6
        assert state["lr_scale"] == float(ref["lr_scale"])
        for key in ("mu", "nu"):
            for k in params:
                np.testing.assert_allclose(
                    state[key][k].numpy(), ref[key][k], rtol=2e-6,
                    atol=1e-7, err_msg=f"{key}/{k}")


def test_wd_mask_picks_the_same_leaves_as_jax():
    """JAX's rule needs ndim <= 2 for its stacked block biases; the port's
    per-layer blocks need ndim <= 1. Both must decay the same leaves."""
    cfg = BackboneConfig(**SMALL)
    jtree = jax_init(jax.random.PRNGKey(0), JaxBackboneConfig(**SMALL), 6)
    jmask = dict(
        ("/".join(str(getattr(k, "key", k)) for k in path), flag)
        for path, flag in jax.tree_util.tree_flatten_with_path(
            jax_optim._wd_mask(jtree))[0])
    port = from_jax_params(jax.tree_util.tree_map(np.asarray, jtree), cfg)
    pmask = named_leaves(optim._wd_mask(port))
    assert len(pmask) == cfg.depth * 12 + 8
    seen = set()
    for name, flag in pmask:
        parts = name.split("/")
        if parts[:2] == ["backbone", "blocks"]:
            del parts[2]  # the layer index
        key = "/".join(parts)
        assert flag == bool(jmask[key]), name
        seen.add(key)
    assert seen == set(jmask)
    assert sum(flag for _, flag in pmask) == cfg.depth * 4 + 2


@pytest.mark.parametrize("kw", [
    dict(schedule="cosine", warmup_steps=3, total_steps=20),
    dict(schedule="cosine", warmup_steps=1, total_steps=1000),
    dict(schedule="cosine", warmup_steps=0, total_steps=7),
    dict(schedule="constant", warmup_steps=4),
    dict(schedule="plateau", warmup_steps=0),
])
def test_schedule_matches_optax(kw):
    """Every count 0..N, both in fp32 in optax's order of operations. cos
    may differ in the last bit between XLA and numpy, and near the end of
    the cosine 1 + cos(pi t / T) cancels and magnifies that (measured
    7e-6 relative, 9e-12 absolute at lr 3e-4): rtol 1e-6 plus atol
    1e-7 * lr."""
    kw = dict(kw, learning_rate=3e-4, min_lr_ratio=1e-3)
    jsched = jax_optim.make_schedule(JaxTrainConfig(**kw))
    sched = optim.make_schedule(TrainConfig(**kw))
    counts = range(kw.get("total_steps", 10) + 3)
    got = np.array([sched(c) for c in counts], np.float32)
    ref = np.array([jsched(jnp.asarray(c, jnp.int32)) for c in counts])
    np.testing.assert_allclose(got, ref, rtol=1e-6,
                               atol=1e-7 * kw["learning_rate"])
    if kw["warmup_steps"]:
        assert got[0] == 0.0  # lr 0 at the first step


def test_plateau_state_matches_jax():
    cfg, jcfg = TrainConfig(), JaxTrainConfig()
    a, b = optim.PlateauState(), jax_optim.PlateauState()
    for metric in (1.0, 0.9995, 0.99, 0.995, 0.996, 0.997, 0.5):
        a, b = a.update(metric, cfg), b.update(metric, jcfg)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.scale < 1.0


def test_train_config_json_reads_in_both_packages():
    jfields = {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)}
    pfields = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    assert jfields == pfields
    cfg = TrainConfig(preset="vit_base_16_224", grad_accum=16,
                      fused_adamw=True, attn_dropout=0.0)
    assert JaxTrainConfig.from_json(cfg.to_json()) == JaxTrainConfig(
        **dataclasses.asdict(cfg))
    assert TrainConfig.from_json(JaxTrainConfig(**dataclasses.asdict(
        cfg)).to_json()) == cfg
    from arsvt_tpu.train.config import TRAIN_PRESETS as JAX_TRAIN_PRESETS

    for name, preset in TRAIN_PRESETS.items():
        assert dataclasses.asdict(preset) == dataclasses.asdict(
            JAX_TRAIN_PRESETS[name]), name
    assert input_canvas(TRAIN_PRESETS["vit_base_finetune"]) == 256
    assert input_canvas(TRAIN_PRESETS["deit_detector_ref"]) == 224
    assert input_canvas(TrainConfig(preset="vit_base_16_224")) == 224
    assert resolve_backbone(TrainConfig(preset="vit_base_16_224",
                                        ln_eps=1e-6)).ln_eps == 1e-6


def test_opt_state_bridge_round_trip():
    cfg = BackboneConfig(**SMALL)
    jcfg = JaxTrainConfig(preset="vit_base_16_224")
    jparams = jax_init(jax.random.PRNGKey(0), JaxBackboneConfig(**SMALL), 6)
    opt = jax_optim.make_optimizer(jcfg)
    jstate = jax_optim.set_lr_scale(opt.init(jparams), 0.49)
    ref = _jax_opt_dict(jstate)
    ref["mu"] = jax.tree_util.tree_map(lambda x: x + 0.25, ref["mu"])
    state = opt_state_from_jax(ref, cfg)
    assert len(state["mu"]["backbone"]["blocks"]) == cfg.depth
    assert state["lr_scale"] == float(np.float32(0.49))
    back = opt_state_to_jax(state)
    assert set(back) == set(ref)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)
    assert tree_leaves(state["nu"])[0].dtype == torch.float32
    with pytest.raises(ValueError, match="keys"):
        opt_state_from_jax({k: v for k, v in ref.items() if k != "nu"}, cfg)
