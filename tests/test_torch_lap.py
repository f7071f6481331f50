"""The port's assignment solver (``objectives/matcher.py``: `lap_rect`,
`lap_rect_plain`, the ``device`` and ``scipy`` backends) against the JAX
package's on-device Jonker-Volgenant (`lap_rect`, jitted on the CPU) and
its `match`, on the same numpy inputs.

`lap_rect_plain` does JAX's arithmetic in JAX's order, so integer-valued
costs, ties included, give JAX's assignment exactly; random fp32 costs
give it too, and the optimum scipy finds. On a CUDA tensor `lap_rect`
launches ``csrc/lap.cu``'s solve-only entry or raises: it never takes the
plain version or scipy (held here with the loader monkeypatched, since
the CPU has no card). The fused entry's tests are in
``test_torch_match_fused.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from arsvt_tpu.objectives import matcher as jax_matcher
from arsvt_tpu_torch.objectives import matcher

torch.set_num_threads(1)  # tier-1 runs several xdist workers

SHAPES = [(1, 1), (1, 25), (5, 25), (7, 7), (25, 100), (64, 64)]
SHAPE_IDS = [f"{q}x{m}" for q, m in SHAPES]
C = 6  # foreground classes
_jax_lap = jax.jit(jax.vmap(jax_matcher.lap_rect))


def _problems(n, q, m, seed, integer):
    rng = np.random.default_rng(seed)
    if integer:  # few distinct values: many ties
        return rng.integers(0, 4, (n, q, m)).astype(np.float32)
    return rng.standard_normal((n, q, m)).astype(np.float32)


def _totals(cost, col_for_row):
    """Each problem's total cost in float64."""
    picked = np.take_along_axis(cost.astype(np.float64),
                                col_for_row[..., None].astype(np.int64), -1)
    return picked[..., 0].sum(-1)


def _scipy_totals(cost):
    return np.array([c.astype(np.float64)[linear_sum_assignment(c)].sum()
                     for c in cost])


def _check_assignment(col_for_row, m):
    assert col_for_row.dtype == np.int64
    assert ((col_for_row >= 0) & (col_for_row < m)).all()
    for row in col_for_row.reshape(-1, col_for_row.shape[-1]):
        assert len(set(row.tolist())) == len(row)  # distinct columns


@pytest.mark.parametrize("q,m", SHAPES, ids=SHAPE_IDS)
def test_plain_matches_jax_on_integer_costs_with_ties(q, m):
    cost = _problems(6, q, m, seed=q * 1000 + m, integer=True)
    got = matcher.lap_rect_plain(torch.from_numpy(cost)).numpy()
    want = np.asarray(_jax_lap(jnp.asarray(cost)))
    _check_assignment(got, m)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_totals(cost, got), _scipy_totals(cost))


@pytest.mark.parametrize("q,m", SHAPES, ids=SHAPE_IDS)
def test_plain_matches_jax_and_scipy_on_random_costs(q, m):
    cost = _problems(6, q, m, seed=q * 1000 + m + 1, integer=False)
    got = matcher.lap_rect_plain(torch.from_numpy(cost)).numpy()
    want = np.asarray(_jax_lap(jnp.asarray(cost)))
    _check_assignment(got, m)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(_totals(cost, got), _scipy_totals(cost),
                               rtol=1e-6)


def test_batched_over_leading_dims_equals_single_solves():
    cost = torch.from_numpy(_problems(12, 5, 25, seed=3, integer=True)
                            ).reshape(3, 4, 5, 25)
    batched = matcher.lap_rect(cost)
    assert batched.shape == (3, 4, 5)
    for layer in range(3):
        for b in range(4):
            assert torch.equal(batched[layer, b],
                               matcher.lap_rect(cost[layer, b]))


def test_lap_single_and_batch_match_jax():
    cost = _problems(4, 9, 9, seed=5, integer=True)
    got = matcher.lap_batch(torch.from_numpy(cost)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax.jit(jax_matcher.lap_batch)(jnp.asarray(cost))))
    np.testing.assert_array_equal(
        matcher.lap_single(torch.from_numpy(cost[0])).numpy(),
        np.asarray(jax.jit(jax_matcher.lap_single)(jnp.asarray(cost[0]))))
    with pytest.raises(ValueError, match="B, n, n"):
        matcher.lap_batch(torch.from_numpy(cost[0]))


def test_more_rows_than_columns_raises():
    with pytest.raises(ValueError, match="q <= m"):
        matcher.lap_rect(torch.zeros(4, 3))


def _problem(b, q, m, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, q, C + 1)).astype(np.float32) * 2
    boxes = (1 / (1 + np.exp(-rng.standard_normal((b, q, 4))))).astype(
        np.float32)
    lo = rng.uniform(0.0, 0.6, (b, m, 2))
    wh = rng.uniform(0.05, 0.4, (b, m, 2))
    tboxes = np.concatenate([lo, lo + wh], -1).astype(np.float32)
    labels = rng.integers(0, C, (b, m)).astype(np.int32)
    n_real = rng.integers(1, m + 1, (b, 1))
    mask = np.arange(m)[None, :] < n_real
    return logits, boxes, labels, tboxes, mask


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("q,m", [(5, 25), (10, 4), (7, 7)],
                         ids=["q<m", "q>m", "square"])
def test_device_match_gives_jax_pairs(q, m):
    inputs = _problem(6, q, m, seed=100 + q * m)
    with jax.default_matmul_precision("highest"):
        jt, jm = jax.jit(jax_matcher.match)(*(jnp.asarray(a) for a in inputs))
    tt, tm = matcher.match(*_t(*inputs), matcher.MatcherConfig())
    assert tt.dtype == torch.int64 and tm.dtype == torch.bool
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    if q > m:  # queries without a slot get the out-of-range m
        assert ((tt.numpy() == m).sum(1) == q - m).all()


def test_match_layers_device_route_solves_all_layers_at_once(monkeypatch):
    logits, boxes, labels, tboxes, mask = _problem(3, 5, 8, seed=7)
    rng = np.random.default_rng(2)
    layers = [(torch.from_numpy(logits + rng.standard_normal(
        logits.shape).astype(np.float32)), torch.from_numpy(boxes))
        for _ in range(4)]
    calls, copies = [], []
    real_lap, real_cpu = matcher.lap_rect_plain, torch.Tensor.cpu
    monkeypatch.setattr(matcher, "lap_rect_plain", lambda cost: calls.append(
        tuple(cost.shape)) or real_lap(cost))
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda t: copies.append(t.shape) or real_cpu(t))
    got = matcher.match_layers(layers, *_t(labels, tboxes, mask))
    assert calls == [(4, 3, 5, 8)]  # one call for every layer and image
    assert copies == []  # nothing goes to the host
    monkeypatch.undo()
    for (cl, bx), (tt, tm) in zip(layers, got):
        rt, rm = matcher.match(cl, bx, *_t(labels, tboxes, mask))
        assert torch.equal(tt, rt) and torch.equal(tm, rm)


@pytest.mark.parametrize("q,m", [(5, 25), (10, 4)], ids=["q<m", "q>m"])
def test_scipy_backend_equals_a_host_solve_per_image(q, m):
    inputs = _t(*_problem(4, q, m, seed=40 + q))
    tt, tm = matcher.match(*inputs, matcher.MatcherConfig(backend="scipy"))
    cost = matcher.build_cost_matrix(*inputs).numpy()
    want = np.full((4, q), m, np.int64)
    for b in range(4):
        rows, cols = linear_sum_assignment(cost[b])
        want[b, rows] = cols
    np.testing.assert_array_equal(tt.numpy(), want)
    real = inputs[4].numpy()[np.arange(4)[:, None], np.minimum(want, m - 1)]
    np.testing.assert_array_equal(tm.numpy(), (want < m) & real)


@pytest.mark.parametrize("backend", ["gpu", "Device", "pure_callback", ""])
def test_unknown_backend_raises(backend):
    with pytest.raises(ValueError, match="backend"):
        matcher.MatcherConfig(backend=backend)
    assert matcher.MatcherConfig().backend == "device"


def test_device_route_on_cpu_calls_no_scipy(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("the device route called scipy")

    monkeypatch.setattr(matcher, "linear_sum_assignment", refuse)
    inputs = _t(*_problem(2, 10, 4, seed=11))
    tt, tm = matcher.match(*inputs)
    assert tt.shape == (2, 10) and bool(tm.any())
    with pytest.raises(AssertionError, match="scipy"):
        matcher.match(*inputs, matcher.MatcherConfig(backend="scipy"))


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: drives the wrapper's CUDA
    branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _on_cuda(array):
    return torch.from_numpy(array).as_subclass(_OnCuda)


def _refuse_plain(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(matcher, "lap_rect_plain", refuse)
    monkeypatch.setattr(matcher, "linear_sum_assignment", refuse)


def test_cuda_tensor_never_reaches_the_plain_version(monkeypatch):
    _refuse_plain(monkeypatch)
    cost = _on_cuda(_problems(3, 5, 25, seed=1, integer=False))

    def no_nvcc(name):
        raise RuntimeError(f"nvcc not found (building {name})")

    monkeypatch.setattr(matcher, "_fn", None)
    monkeypatch.setattr(matcher.build, "load", no_nvcc)
    before = matcher.SOLVE_LAUNCHES
    with pytest.raises(RuntimeError, match="building lap"):
        matcher.lap_rect(cost)
    # a launch that fails raises too, uncounted
    monkeypatch.setattr(matcher, "_launch", lambda *a: 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        matcher.lap_rect(cost)
    assert matcher.SOLVE_LAUNCHES == before
    # a launch that succeeds is counted, one for all the problems
    seen = []
    monkeypatch.setattr(matcher, "_launch",
                        lambda c, out, n, q, m: seen.append((n, q, m)) or 0)
    matcher.lap_rect(cost.reshape(1, 3, 5, 25))
    assert seen == [(3, 5, 25)] and matcher.SOLVE_LAUNCHES == before + 1


def test_cuda_route_raises_past_the_shared_memory_bound(monkeypatch):
    _refuse_plain(monkeypatch)
    n = matcher.MAX_COLUMNS  # the costs (4 q m bytes) pass the bound first
    assert matcher.smem_bytes(n, n) > matcher.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        matcher.lap_rect(_on_cuda(np.zeros((n, n), np.float32)))
    with pytest.raises(ValueError, match="columns"):
        matcher.lap_rect(_on_cuda(np.zeros((1, n + 1), np.float32)))
    assert matcher.smem_bytes(25, 100) <= matcher.SMEM_LIMIT // 4
