"""The matcher's fused device route (``objectives/matcher.py``:
`assign_layers`, `match_layers_plain`, ``csrc/lap.cu``'s
``arsvt_match_layers``) against the JAX package's `match` and
`build_cost_matrix`, on the same numpy inputs.

On CPU tensors `match_layers` runs `match_layers_plain`, the fused kernel's
plain version (each layer's eager costs, `lap_rect_plain` and the
gather); it gives JAX's slots and matches layer by layer, for Q < M, Q > M
(the transpose solved and inverted) and square problems, with an image
whose slots are all pads and one with a single real target, from fp32 and
bf16 logits. On CUDA tensors `match_layers` makes one launch of the fused
entry or raises: it never builds the costs eagerly or takes the plain
solver (held here with a tensor subclass that reports a CUDA device and
the loader or the launch monkeypatched, since the CPU has no card). The
kernel's arithmetic is held to the plain version's bits on the card
(``chip_smoke.py`` phase 3); here its source is held to the rule that
keeps those bits: no product or sum left for nvcc to contract.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arsvt_tpu.objectives import matcher as jax_matcher
from arsvt_tpu_torch.objectives import matcher
from arsvt_tpu_torch.ops import build

torch.set_num_threads(1)  # tier-1 runs several xdist workers

C = 6  # foreground classes
SHAPES = [(3, 4, 5, 25), (2, 3, 25, 10), (2, 2, 7, 7)]  # (L, B, Q, M)
SHAPE_IDS = ["q<m", "q>m", "square"]
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(n_layers, b, q, m, seed):
    """Per layer logits (B, Q, C + 1) and sigmoid boxes; xyxy targets,
    int32 labels and a mask with image 0 all pads, image 1 one real target
    and 1 to M real slots elsewhere."""
    rng = np.random.default_rng(seed)
    logits = [(rng.standard_normal((b, q, C + 1)) * 2).astype(np.float32)
              for _ in range(n_layers)]
    boxes = [(1 / (1 + np.exp(-rng.standard_normal((b, q, 4)))))
             .astype(np.float32) for _ in range(n_layers)]
    lo = rng.uniform(0.0, 0.6, (b, m, 2))
    wh = rng.uniform(0.05, 0.4, (b, m, 2))
    tboxes = np.concatenate([lo, lo + wh], -1).astype(np.float32)
    labels = rng.integers(0, C, (b, m)).astype(np.int32)
    real = rng.integers(1, m + 1, (b, 1))
    real[0] = 0
    real[1:2] = 1
    return logits, boxes, labels, tboxes, np.arange(m)[None, :] < real


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_route_gives_jax_matches_layer_by_layer(shape, dtype):
    n_layers, b, q, m = shape
    logits, boxes, labels, tboxes, mask = _inputs(*shape, seed=sum(shape))
    tdt, jdt = DTYPES[dtype]
    layers = [(torch.from_numpy(cl).to(tdt), torch.from_numpy(bx))
              for cl, bx in zip(logits, boxes)]
    targets = tuple(torch.from_numpy(a) for a in (labels, tboxes, mask))
    got = matcher.match_layers(layers, *targets)
    idx, matched, costs = matcher.match_layers_plain(layers, *targets)
    assert len(got) == n_layers and costs.shape == (n_layers, b, q, m)
    cfg = jax_matcher.MatcherConfig()
    build_jax = jax.jit(jax.vmap(lambda *a: jax_matcher.build_cost_matrix(
        *a, cfg)))
    with jax.default_matmul_precision("highest"):
        for layer, ((tt, tm), cl, bx) in enumerate(zip(got, logits, boxes)):
            args = (jnp.asarray(cl).astype(jdt), jnp.asarray(bx),
                    jnp.asarray(labels), jnp.asarray(tboxes),
                    jnp.asarray(mask))
            jt, jm = jax.jit(jax_matcher.match)(*args)
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
            assert torch.equal(tt, idx[layer]) and torch.equal(tm,
                                                              matched[layer])
            np.testing.assert_allclose(costs[layer].numpy(),
                                       np.asarray(build_jax(*args)),
                                       rtol=0, atol=1e-6)
    assert not matched[:, 0].any()  # image 0: every slot a pad
    assert int(matched[:, 1].sum(-1).max()) == 1  # image 1: one target
    if q > m:  # queries without a slot get the out-of-range m
        assert ((idx == m).sum(-1) == q - m).all()


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: drives the wrappers' CUDA
    branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _on_cuda(shape=(6, 4, 5, 25), seed=3, labels=np.int32):
    logits, boxes, lab, tboxes, mask = _inputs(*shape, seed=seed)
    cuda = [torch.from_numpy(a).as_subclass(_OnCuda) for a in
            (lab.astype(labels), tboxes, mask)]
    layers = [(torch.from_numpy(cl).as_subclass(_OnCuda),
               torch.from_numpy(bx).as_subclass(_OnCuda))
              for cl, bx in zip(logits, boxes)]
    return layers, *cuda


def _refuse_plain(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    for name in ("build_cost_matrix", "lap_rect_plain", "assign_plain",
                 "match_layers_plain", "linear_sum_assignment"):
        monkeypatch.setattr(matcher, name, refuse)


def test_cuda_tensors_take_one_fused_launch(monkeypatch):
    """The fused loader is reached; a failed build or launch raises,
    uncounted; a launch that succeeds is one, counted, with every layer's
    own pointers and the outputs it fills; no eager cost or plain solver
    runs."""
    _refuse_plain(monkeypatch)
    inputs = _on_cuda()

    def no_nvcc(name):
        raise RuntimeError(f"nvcc not found (building {name})")

    monkeypatch.setattr(matcher, "_match_fn", None)
    monkeypatch.setattr(matcher.build, "load", no_nvcc)
    before = matcher.LAUNCHES
    with pytest.raises(RuntimeError, match="building lap"):
        matcher.match_layers(*inputs)
    monkeypatch.setattr(matcher, "_match_launch", lambda *a: 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        matcher.match_layers(*inputs)
    assert matcher.LAUNCHES == before
    seen = []

    def launch(logits, boxes, labels, tgt_boxes, mask, cfg, idx, matched,
               costs):
        seen.append((len(logits), [t.data_ptr() for t in logits],
                     [t.data_ptr() for t in boxes], labels.dtype,
                     tuple(idx.shape), matched.dtype, costs))
        idx.fill_(0)
        matched.fill_(True)
        return 0

    monkeypatch.setattr(matcher, "_match_launch", launch)
    got = matcher.match_layers(*inputs)
    layers = inputs[0]
    assert matcher.LAUNCHES == before + 1 and len(seen) == 1
    n, lg, bx, dtype, shape, mdtype, costs = seen[0]
    assert n == 6 and shape == (6, 4, 5) and mdtype == torch.bool
    assert costs is None and dtype == torch.int32
    assert lg == [cl.data_ptr() for cl, _ in layers]  # no stacking copy
    assert bx == [b.data_ptr() for _, b in layers]
    assert len(got) == 6 and all(t.shape == (4, 5) and bool(m.all())
                                 for t, m in got)
    _, _, costs = matcher.assign_layers(*inputs, return_costs=True)
    assert seen[-1][-1].shape == (6, 4, 5, 25)
    matcher.assign_layers(*_on_cuda(labels=np.int64))
    assert seen[-1][3] == torch.int64  # int64 labels go as they are
    assert matcher.LAUNCHES == before + 3


@pytest.mark.parametrize("shape", [(1, 2, 256, 256), (33, 2, 5, 25),
                                   (1, 2, 5, 257)],
                         ids=["smem", "layers", "columns"])
def test_cuda_route_refuses_what_the_kernel_cannot_hold(monkeypatch, shape):
    """A Q·M past the shared-memory bound, more layers or columns than the
    kernel takes: a ValueError before any build or launch."""
    _refuse_plain(monkeypatch)
    monkeypatch.setattr(matcher, "_match_launch", lambda *a: 0 / 0)
    q, m = shape[2:]
    if shape[0] == 1 and q == m:
        assert matcher.match_smem_bytes(q, m, C + 1) > matcher.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory|at most"):
        matcher.assign_layers(*_on_cuda(shape))
    # the presets' shapes fit, several layers a block
    assert 6 * matcher.match_smem_bytes(100, 25, C + 1) < matcher.SMEM_LIMIT


def _section(text, start, end):
    return text[text.index(start):text.index(end)]


def test_cost_build_leaves_nothing_to_contract():
    """Every float product, sum, difference and quotient of the cost build
    in csrc/lap.cu is a _rn intrinsic (no bare operator for nvcc to fuse
    into an FMA, which the eager ops round twice); indices (inside [...])
    and literals aside. The build flags ask for no fast math."""
    text = build.source_path("lap").read_text()
    body = _section(text, "template <int K>\n__global__ void __launch_bounds"
                          "__(kMaxWarps * 32)", "  solve<K>(tile, rows, cols")
    statements = [s for s in body.split(";") if re.search(
        r"\b(const )?float \w+ =|\b(tt|qt|tile|logits|boxes)\[[^\]]*\]\s*=|"
        r"\b(mx|sum) =", s)]
    assert len(statements) > 30
    for s in statements:
        rhs = s.split("=", 1)[1]
        while re.search(r"\[[^\[\]]*\]", rhs):
            rhs = re.sub(r"\[[^\[\]]*\]", "", rhs)
        rhs = re.sub(r"\b\d+(\.\d*)?(e[-+]?\d+)?f?\b", "0", rhs)
        assert not re.search(r"[\w)\]]\s*[-+*/]\s*[\w(]", rhs), s
    for name in ("__fmul_rn", "__fadd_rn", "__fsub_rn", "__fdiv_rn"):
        assert name in body
    assert "fmaf" not in text and "__fma" not in text
    assert not any("fast_math" in f or "fmad" in f for f in build.NVCC_FLAGS)


def test_both_entries_share_one_solver():
    """The solve-only and the fused entry both call `solve<K>`, whose
    passes read no global memory: the cost rows come from the shared
    tile."""
    text = build.source_path("lap").read_text()
    assert text.count('extern "C" int arsvt_') == 2
    assert text.count("solve<K>(") == 2
    solver = _section(text, "__device__ void solve(", "template <int K>\n"
                                                     "__global__")
    assert "__reduce_min_sync" in text and "__ldg" not in solver
    assert "const float* __restrict__ c" in solver
