"""The fused dropout site (``ops/dropout.py``: `SiteDropout` over
`dropout_apply`) on the CPU, where `dropout_apply` runs its plain version.

On the card each residual, positional and reference-attention site is one
launch of ``csrc/dropout_mask.cu``'s apply kernel forward and one backward
(``chip_smoke.py`` phase 3(a) holds the kernel to the plain version there,
bit for bit). Here:

- the Function's forward and gradient equal the eager path the port ran
  before (the mask drawn, then ``torch.where`` under autograd, which keeps
  the mask) to the bit: fp32 and bf16, both scale rules, a data rank's and
  a tensor rank's offsets, C = 5, Inf and NaN in x and in the gradient;
- it saves no tensor: the backward draws the mask again from the seed;
- JAX's ``dropout`` (``arsvt_tpu/models/vit.py:140-145``) and its
  ``sdpa_reference`` dropout, fed the port's mask in place of
  ``jax.random.bernoulli``'s, give the same forward and VJP within
  ``test_torch_dropout.py``'s fp32 limit;
- a tiny detector step with residual and attention dropout under every
  remat policy equals the step without remat to the bit, and the sites
  replay as ``chip_smoke.py``'s launch tables count them;
- the launch counter moves only on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arsvt_tpu.models import vit as jax_vit
from arsvt_tpu.ops import attention as jax_attention
from arsvt_tpu_torch.core.dtypes import tree_leaves
from arsvt_tpu_torch.core.prng import Rng
from arsvt_tpu_torch.models import registry
from arsvt_tpu_torch.models.detector import DetectorConfig
from arsvt_tpu_torch.models.vit import (
    BackboneConfig,
    apply_backbone,
    init_backbone,
)
from arsvt_tpu_torch.ops import build
from arsvt_tpu_torch.ops import dropout as dropout_ops
from arsvt_tpu_torch.ops.attention import sdpa_reference
from arsvt_tpu_torch.ops.dropout import (
    SiteDropout,
    apply_mask,
    dropout,
    dropout_apply,
    inv_keep,
    keep_mask,
    kernel_scale,
    site_view,
)
from arsvt_tpu_torch.ops.remat import BLOCK_POLICIES, REMAT_POLICIES
from arsvt_tpu_torch.train.config import TrainConfig
from arsvt_tpu_torch.train.detect_step import make_detector_step_fns

torch.set_num_threads(1)  # tier-1 runs several xdist workers

RATE = 0.1
SEED = 0xC0FFEE
# JAX against the port in fp32: the same where and scale, XLA's division
# against PyTorch's; test_torch_dropout.py's limit
ATOL = 1e-5

# (name, x shape, view (B, H, R, C), offsets (b0, H', h0))
CASES = [
    ("residual", (4, 9, 24), (4, 1, 9, 24), (0, 1, 0)),
    ("residual_dp_rank", (3, 9, 24), (3, 1, 9, 24), (3, 1, 0)),
    ("probs_tp_rank_25_heads", (2, 12, 7, 16), (2, 12, 7, 16), (0, 25, 13)),
    ("detr_self_attention_c5", (4, 8, 5, 5), (4, 8, 5, 5), (0, 8, 0)),
]


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits, so NaN payloads and the sign of zero count."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _eager(x, view, offsets, scale_mode):
    """The site as the port ran it before the fused kernel: the mask, then
    the where under autograd (which saves the mask)."""
    keep = keep_mask(SEED, *view, RATE, offsets=offsets).view(x.shape)
    if scale_mode == "mul":
        return apply_mask(x, keep, RATE)
    return torch.where(keep, x / (1.0 - RATE),
                       torch.zeros_like(x)).to(x.dtype)


def _planted(shape, dtype, seed):
    """Normal values with +-Inf and NaN planted on every 7th element, so
    they fall on kept and on dropped places alike."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32).reshape(-1)
    x[::7] = np.array([np.inf, -np.inf, np.nan])[np.arange(x[::7].size) % 3]
    return torch.from_numpy(x.reshape(shape)).to(dtype)


@pytest.mark.parametrize("scale_mode", ["div", "mul"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name,shape,view,offsets", CASES,
                         ids=[c[0] for c in CASES])
def test_site_equals_the_eager_path_to_the_bit(name, shape, view, offsets,
                                               dtype, scale_mode):
    x = _planted(shape, dtype, seed=len(name))
    g = _planted(shape, dtype, seed=len(name) + 1)
    xa = x.clone().requires_grad_(True)
    ya = SiteDropout.apply(xa, SEED, RATE, offsets, view, scale_mode)
    (ga,) = torch.autograd.grad(ya, xa, g)
    xb = x.clone().requires_grad_(True)
    yb = _eager(xb, view, offsets, scale_mode)
    (gb,) = torch.autograd.grad(yb, xb, g)
    assert ya.dtype == dtype and ga.dtype == dtype
    assert torch.equal(_bits(ya), _bits(yb))
    assert torch.equal(_bits(ga), _bits(gb))
    # a dropped Inf or NaN gives +0, forward and backward
    keep = keep_mask(SEED, *view, RATE, offsets=offsets).view(shape)
    for out in (ya, ga):
        assert bool((_bits(out)[~keep] == 0).all())


def test_the_function_saves_no_tensor():
    """The eager path keeps a mask of x's size for its backward; the
    Function keeps nothing, through `dropout` and through the reference
    attention."""
    x = torch.randn(4, 9, 24, requires_grad=True)

    def saved_by(fn):
        sizes = []

        def pack(t):
            sizes.append(t.numel())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            fn()
        return sizes

    view, offsets = site_view(x), (0, 1, 0)
    assert x.numel() in saved_by(lambda: _eager(x, view, offsets, "div"))
    assert saved_by(lambda: dropout(x, RATE, Rng(3), train=True)) == []
    assert saved_by(lambda: SiteDropout.apply(
        x, SEED, RATE, (0, 1, 0), view, "mul")) == []
    probs = torch.softmax(torch.randn(2, 3, 5, 5), -1).requires_grad_(True)
    assert saved_by(lambda: SiteDropout.apply(
        probs, SEED, RATE, (0, 3, 0), tuple(probs.shape), "mul")) == []


def test_sites_route_through_the_function():
    """`dropout` and `sdpa_reference` with dropout build a SiteDropout node,
    whose backward is the same site applied to the gradient."""
    x = torch.randn(2, 5, 8, requires_grad=True)
    y = dropout(x, RATE, Rng(1), train=True)
    assert "SiteDropout" in type(y.grad_fn).__name__
    q, k, v = (torch.randn(2, 3, 5, 8, requires_grad=True) for _ in range(3))
    out = sdpa_reference(q, k, v, dropout_rate=RATE, dropout_rng=Rng(2))
    seen, todo = {}, [out.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and id(fn) not in seen:
            seen[id(fn)] = type(fn).__name__
            todo += [f for f, _ in fn.next_functions]
    assert any("SiteDropout" in n for n in seen.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_residual_site_matches_jax_dropout_fed_the_port_mask(dtype,
                                                             monkeypatch):
    """JAX's `dropout` with ``jax.random.bernoulli`` returning the port's
    mask: forward and VJP against the Function (fp32 within ATOL; bf16
    within one bf16 ulp, 2^-7 relative: JAX divides by the constant 1 -
    rate rounded to bf16, 0.8984375, the port by 0.9)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 17, 40)).astype(np.float32)
    g = rng.standard_normal((3, 17, 40)).astype(np.float32)
    site = Rng(7, 1).at_row(2)
    keep = keep_mask(site.seed32(), *site_view(torch.from_numpy(x)), RATE,
                     offsets=(2, 1, 0)).reshape(x.shape).numpy()
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(keep))
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref, vjp = jax.vjp(lambda a: jax_vit.dropout(
        a, RATE, jax.random.PRNGKey(0), train=True), jnp.asarray(x, jdtype))
    (ref_dx,) = vjp(jnp.asarray(g, jdtype))
    tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
    out = dropout(tx, RATE, site, train=True)
    (dx,) = torch.autograd.grad(out, tx, torch.from_numpy(g).to(dtype))
    tol = dict(atol=ATOL) if dtype == torch.float32 else dict(
        atol=0, rtol=2.0 ** -7)
    for got, want in ((out, ref), (dx, ref_dx)):
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want, np.float32), **tol)


def test_reference_attention_matches_jax_fed_the_port_mask(monkeypatch):
    """JAX's `sdpa_reference` with dropout, its bernoulli returning the
    port's probability mask (a tensor rank's heads 4.. of 8): forward and
    the VJP in q, k, v against the port's reference, fp32."""
    rng = np.random.default_rng(1)
    q, k, v, w = (rng.standard_normal((2, 4, 5, 16)).astype(np.float32)
                  for _ in range(4))
    site = Rng(9)
    keep = keep_mask(site.seed32(), 2, 4, 5, 5, RATE,
                     offsets=(0, 8, 4)).numpy()
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(keep))
    with jax.default_matmul_precision("highest"):
        ref, vjp = jax.vjp(lambda *a: jax_attention.sdpa_reference(
            *a, dropout_rate=RATE, dropout_rng=jax.random.PRNGKey(0)),
            *(jnp.asarray(a) for a in (q, k, v)))
        ref_grads = vjp(jnp.asarray(w))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = sdpa_reference(tq, tk, tv, dropout_rate=RATE, dropout_rng=site,
                         head_range=(4, 8))
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(w))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   err_msg=name)


def test_kernel_scale_is_the_eager_product():
    """On the card both rules are one fp32 product: x / (1 - rate) by the
    fp32 reciprocal of fp32(1 - rate), x * inv_keep(rate) by inv_keep."""
    for rate in (0.1, 0.25, 0.3):
        scale = kernel_scale(rate, "div")
        assert scale == float(np.float32(1) / np.float32(1 - rate))
        assert kernel_scale(rate, "mul") == inv_keep(rate)
    with pytest.raises(ValueError, match="scale_mode"):
        kernel_scale(RATE, "sub")


def test_launches_count_only_on_the_card():
    """A CPU tensor runs the plain version and counts nothing, forward or
    backward; a device other than cpu or cuda raises."""
    n = dropout_ops.APPLY_LAUNCHES
    x = torch.randn(2, 5, 8, requires_grad=True)
    torch.autograd.grad(dropout(x, RATE, Rng(1), train=True).sum(), x)
    assert dropout_ops.APPLY_LAUNCHES == n
    with pytest.raises(ValueError, match="cpu or cuda"):
        dropout_apply(torch.empty(2, 8, device="meta"), SEED, RATE,
                      (0, 1, 0), (2, 1, 1, 8), "div")
    with pytest.raises(ValueError, match="scale_mode"):
        dropout_apply(x.detach(), SEED, RATE, (0, 1, 0), site_view(x), "x")


def test_apply_entry_in_the_source():
    """The apply kernel draws the shared rule's key word and threshold,
    takes the offsets, the dtype and the scale, and only multiplies."""
    text = build.source_path("dropout_mask").read_text()
    head = text[text.index('extern "C" int arsvt_dropout_apply'):]
    head = head[:head.index("{")]
    for word in ("void* out", "const void* in", "int dtype",
                 "uint32_t seed", "uint32_t threshold", "int b0",
                 "int mask_heads", "int h0", "float scale", "void* stream"):
        assert word in head
    assert "scale_mode" not in head and "__fdiv_rn" not in text
    assert "s.drop.bh(" in text and "s.drop.threshold" in text


def _counted_forwards(monkeypatch):
    calls = [0]
    real = SiteDropout.forward

    def forward(ctx, *args):
        calls[0] += 1
        return real(ctx, *args)

    monkeypatch.setattr(SiteDropout, "forward", staticmethod(forward))
    return calls


@pytest.mark.parametrize("policy", ("none",) + REMAT_POLICIES)
def test_remat_replays_the_attention_residual_site_only(policy, monkeypatch):
    """Forward launches a microbatch: the positional site and two residual
    sites a layer, plus, under a policy that replays whole blocks, one
    replay a layer: the non-reentrant checkpoint stops its replay at the
    last tensor the backward saved, and the MLP's residual site, which
    ends the block, saves none. ``chip_smoke.py::mask_sites`` counts
    so."""
    cfg = BackboneConfig(image_size=16, patch_size=8, embed_dim=32, depth=2,
                         num_heads=2, mlp_dim=64, dropout=RATE)
    params = init_backbone(cfg, seed=3)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    calls = _counted_forwards(monkeypatch)
    out = apply_backbone(params, torch.rand(2, 16, 16, 3), cfg, train=True,
                         rng=Rng(5), remat=policy != "none",
                         remat_policy=policy.replace("none", "full"))
    assert calls[0] == 1 + 2 * cfg.depth
    torch.autograd.grad(out.sum(), tree_leaves(params))
    replays = cfg.depth if policy in BLOCK_POLICIES else 0
    assert calls[0] == 1 + 2 * cfg.depth + replays


def _detector_with_dropout(monkeypatch) -> str:
    """`detector_test` with residual, positional and attention dropout 0.1
    in the backbone and the head, registered under its own name."""
    base = registry.DETECTOR_PRESETS["detector_test"]
    det = DetectorConfig(
        backbone=dataclasses.replace(base.backbone, dropout=RATE,
                                     attn_dropout=RATE),
        head=dataclasses.replace(base.head, dropout=RATE, attn_dropout=RATE))
    monkeypatch.setitem(registry.DETECTOR_PRESETS, "detector_test_dropout",
                        det)
    return "detector_test_dropout"


def _det_batch(rng, n=4, m=4, size=32):
    lo = rng.uniform(0.05, 0.6, (n, m, 2))
    wh = rng.uniform(0.1, 0.35, (n, m, 2))
    return {"image": rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            "boxes": np.concatenate([lo, lo + wh], -1).astype(np.float32),
            "labels": rng.integers(0, 3, (n, m)).astype(np.int32),
            "mask": np.arange(m)[None, :] < rng.integers(1, m + 1, (n, 1))}


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_detector_step_under_remat_equals_no_remat_to_the_bit(policy,
                                                             monkeypatch):
    """Two detector steps (the deit_test_8_32 backbone, dropout 0.1 at
    every site) under `policy` against the same steps without remat, from
    one init: losses, gradient norms and parameters to the bit."""
    kw = dict(preset=_detector_with_dropout(monkeypatch), task="detect",
              batch_size=4, augment="none", bf16=False, warmup_steps=1,
              learning_rate=1e-3)
    runs = []
    for remat in (False, True):
        init, step, _ = make_detector_step_fns(
            TrainConfig(**kw, remat=remat, remat_policy=policy),
            device="cpu")
        state, metrics = init(), []
        rng = np.random.default_rng(4)
        for _ in range(2):
            state, m = step(state, _det_batch(rng))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((metrics, tree_leaves(state["params"])))
    (m_plain, p_plain), (m_remat, p_remat) = runs
    assert m_remat == m_plain and np.isfinite(m_plain).all()
    for a, b in zip(p_remat, p_plain):
        assert torch.equal(a, b)


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: drives the wrapper's CUDA
    branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_a_cuda_tensor_never_reaches_the_plain_version(monkeypatch):
    """On a CUDA tensor `dropout_apply` builds and launches the kernel or
    raises, uncounted: without nvcc it raises; a dtype the kernel does not
    take and a view that does not hold x raise before any build."""
    def refuse(*args, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    def no_nvcc(name):
        raise RuntimeError(f"nvcc not found (building {name})")

    monkeypatch.setattr(dropout_ops, "dropout_apply_plain", refuse)
    monkeypatch.setattr(dropout_ops, "_apply_fn", None)
    monkeypatch.setattr(dropout_ops.build, "load", no_nvcc)
    x = torch.randn(2, 5, 8).as_subclass(_OnCuda)
    before = dropout_ops.APPLY_LAUNCHES
    with pytest.raises(RuntimeError, match="building dropout_mask"):
        dropout_apply(x, SEED, RATE, (0, 1, 0), site_view(x), "div")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dropout_apply(x.half(), SEED, RATE, (0, 1, 0), site_view(x), "div")
    with pytest.raises(ValueError, match="does not hold"):
        dropout_apply(x, SEED, RATE, (0, 1, 0), (2, 1, 5, 9), "div")
    assert dropout_ops.APPLY_LAUNCHES == before
