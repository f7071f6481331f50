"""Hungarian (bipartite) matching (counterpart of
``arsvt_tpu/objectives/matcher.py``).

The cost matrices are JAX's `build_cost_matrix`: class + L1 (cxcywh) +
GIoU terms, target slots that hold no real box at `_PAD_COST`.
`MatcherConfig.backend` picks the solver, as in JAX:

- ``"device"`` (the default): JAX's exact Jonker-Volgenant shortest
  augmenting path (`lap_rect`, ``matcher.py:41-125``) on the device, so a
  train step never waits for the host. On CUDA tensors `match_layers`
  makes one launch of ``csrc/lap.cu``'s fused entry (`assign_layers`,
  counted in `LAUNCHES`), which builds every decoder layer's costs into
  shared memory, solves them there and writes the assignments; on CPU
  tensors it runs that entry's plain version, `match_layers_plain` (the
  eager `build_cost_matrix`, `lap_rect_plain` and the gather). `lap_rect`
  solves given costs: on a CUDA tensor the kernel's solve-only entry
  (counted in `SOLVE_LAUNCHES`), on a CPU tensor `lap_rect_plain`, JAX's
  scan and while loops on torch tensors, batched the way vmap runs a while
  loop. The solvers do JAX's arithmetic in JAX's order (subtractions and
  compares only), so integer-valued costs give JAX's assignment, ties
  included. A failed build or launch raises.
- ``"scipy"``: the oracle, scipy's ``linear_sum_assignment`` on the host
  (`lap_scipy`) after one copy of the stacked eager costs.

JAX sends every backend other than ``"scipy"`` down its device route; the
port accepts the two names and raises on any other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from arsvt_tpu_torch.objectives.boxes import (
    cxcywh_to_xyxy,
    pairwise_giou,
    xyxy_to_cxcywh,
)
from arsvt_tpu_torch.ops import build

# Pad cost: dominates any real cost while fp32 addition keeps the real
# costs' differences (JAX's value).
_PAD_COST = 1e4
_INF = 1e30  # JAX's `_INF`, float32(1e30): the used columns in the argmin

BACKENDS = ("device", "scipy")

# Launches of ``csrc/lap.cu``'s fused entry in this process (one an
# `assign_layers` call on CUDA tensors: a `match_layers` call) and of its
# solve-only entry (one a `lap_rect` call on a CUDA tensor).
LAUNCHES = 0
SOLVE_LAUNCHES = 0

# Shared memory a block may hold (`smem_bytes`, `match_smem_bytes`), at most
# the H100's opt-in dynamic shared memory of one block.
SMEM_LIMIT = 227 * 1024
# Decoder layers and classes (C + 1) a fused launch takes, and columns of a
# problem (the kernel keeps each lane's columns in registers), at most.
MAX_LAYERS = 32
MAX_CLASSES = 1024
MAX_COLUMNS = 256

_fn = None
_match_fn = None


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    cost_class: float = 1.0   # reference defaults (train.py:891-896)
    cost_bbox: float = 1.0
    cost_giou: float = 1.0
    backend: str = "device"   # "device" | "scipy"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"MatcherConfig.backend must be one of "
                             f"{BACKENDS}, got {self.backend!r}")


def build_cost_matrix(class_logits, boxes_cxcywh, tgt_labels, tgt_boxes_xyxy,
                      tgt_mask, cfg: MatcherConfig = MatcherConfig()):
    """Costs (..., Q, M): class_logits (..., Q, C+1), boxes_cxcywh (..., Q,
    4), tgt_labels (..., M) int, tgt_boxes_xyxy (..., M, 4), tgt_mask
    (..., M) bool; leading dims are shared (the batch)."""
    probs = torch.softmax(class_logits.float(), dim=-1)
    idx = tgt_labels.long()[..., None, :].expand(*probs.shape[:-1],
                                                  tgt_labels.shape[-1])
    cost_class = -torch.gather(probs, -1, idx)  # (..., Q, M)
    pred_xyxy = cxcywh_to_xyxy(boxes_cxcywh)
    tgt_cxcywh = xyxy_to_cxcywh(tgt_boxes_xyxy)
    cost_bbox = (boxes_cxcywh[..., :, None, :]
                 - tgt_cxcywh[..., None, :, :]).abs().sum(dim=-1)
    cost_giou = -pairwise_giou(pred_xyxy, tgt_boxes_xyxy)
    cost = (cfg.cost_class * cost_class + cfg.cost_bbox * cost_bbox
            + cfg.cost_giou * cost_giou)
    return torch.where(tgt_mask[..., None, :], cost,
                       torch.full_like(cost, _PAD_COST))


def _check_rect(cost) -> tuple[list[int], int, int]:
    *lead, q, m = cost.shape
    if q > m:
        raise ValueError(f"lap_rect needs q <= m rows, got a ({q}, {m}) "
                         f"cost; solve the transpose")
    return lead, q, m


def lap_rect_plain(cost: torch.Tensor) -> torch.Tensor:
    """JAX's `lap_rect` on torch tensors: costs (..., q, m) with q <= m ->
    col_for_row (..., q) int64, every row a distinct column, minimising
    the total.

    One pass over the rows (JAX's `lax.scan`); for row i a tree grown
    column by column until it reaches a free one (the `while_loop`), the
    final dual update, the augmenting walk back along `way`, and the
    inversion of p (column -> row). The problems of the leading dims run
    together, as under vmap: a problem whose loop has ended keeps its
    state until every loop has. The arithmetic is JAX's, in its order."""
    lead, q, m = _check_rect(cost)
    cost = cost.float().reshape(-1, q, m)
    n, dev = cost.shape[0], cost.device
    if n == 0 or q == 0:
        return torch.zeros((*lead, q), dtype=torch.int64, device=dev)
    at = torch.arange(n, device=dev)
    u = torch.zeros(n, q, device=dev)
    v = torch.zeros(n, m, device=dev)
    p = torch.full((n, m), -1, dtype=torch.int64, device=dev)
    for i in range(q):
        minv = cost[:, i] - u[:, i:i + 1] - v
        way = torch.full((n, m), -1, dtype=torch.int64, device=dev)
        used = torch.zeros(n, m, dtype=torch.bool, device=dev)
        tree = torch.zeros(n, q, dtype=torch.bool, device=dev)
        tree[:, i] = True
        j1 = minv.argmin(1)
        live = p[at, j1] != -1
        while bool(live.any()):
            keep = live[:, None]
            delta = minv[at, j1][:, None]
            u_new = u + torch.where(tree, delta, 0.0)
            v_new = v - torch.where(used, delta, 0.0)
            minv_new = torch.where(used, minv, minv - delta)
            used_new = used.clone()
            used_new[at, j1] = True
            row = p[at, j1].clamp(min=0)
            tree_new = tree.clone()
            tree_new[at, row] = True
            cur = cost[at, row] - u_new[at, row][:, None] - v_new
            improved = (cur < minv_new) & ~used_new
            minv_new = torch.where(improved, cur, minv_new)
            way_new = torch.where(improved, j1[:, None], way)
            j1_new = torch.where(used_new, _INF, minv_new).argmin(1)
            u = torch.where(keep, u_new, u)
            v = torch.where(keep, v_new, v)
            minv = torch.where(keep, minv_new, minv)
            used = torch.where(keep, used_new, used)
            tree = torch.where(keep, tree_new, tree)
            way = torch.where(keep, way_new, way)
            j1 = torch.where(live, j1_new, j1)
            live = p[at, j1] != -1
        # final dual update so the new matched edge becomes tight
        delta = minv[at, j1][:, None]
        u = u + torch.where(tree, delta, 0.0)
        v = v - torch.where(used, delta, 0.0)
        # augment: walk predecessors from the free column, shifting rows
        j = j1
        walking = way[at, j] != -1
        while bool(walking.any()):
            jprev = way[at, j]
            moved = p[at, jprev.clamp(min=0)]
            p[at[walking], j[walking]] = moved[walking]
            j = torch.where(walking, jprev, j)
            walking = way[at, j] != -1
        p[at, j] = i
    # invert p (col -> row); free columns (p = -1) land on the dropped q
    col_for_row = torch.zeros(n, q + 1, dtype=torch.int64, device=dev)
    cols = torch.arange(m, device=dev).expand(n, m)
    col_for_row.scatter_(1, torch.where(p >= 0, p, q), cols)
    return col_for_row[:, :q].reshape(*lead, q)


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def _state_bytes(m: int) -> int:
    # the solver's p and way, m words each (the rest is in registers)
    return _round16(8 * m)


def smem_bytes(q: int, m: int) -> int:
    """Shared memory of one (q, m) problem in ``csrc/lap.cu``'s solve-only
    entry (a block): its costs and the solver's p and way, each rounded up
    to 16 bytes."""
    return _round16(4 * q * m) + _state_bytes(m)


def match_smem_bytes(q: int, m: int, classes: int) -> int:
    """Shared memory of the fused entry's smallest block, one image and
    one layer of Q = q queries, M = m slots and C + 1 = `classes`: the
    image's 11 target words a slot, then the layer's (Q, M) cost tile, its
    11 query words a query, its staged logits (Q, C + 1) and boxes (Q, 4)
    and the solver's p and way (max(Q, M) words each), each rounded up to
    16 bytes. A block takes as many layers as fit, up to 8."""
    return (_round16(44 * m) + _round16(4 * q * m) + _round16(44 * q)
            + _round16(4 * q * classes) + _round16(16 * q)
            + _state_bytes(max(q, m)))


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("lap").arsvt_lap_rect
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(cost: torch.Tensor, out: torch.Tensor, n: int, q: int,
            m: int) -> int:
    fn = _kernel()
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream(cost.device).cuda_stream
        return fn(cost.data_ptr(), out.data_ptr(), n, q, m, SMEM_LIMIT,
                  stream)


def lap_rect(cost: torch.Tensor) -> torch.Tensor:
    """Exact rectangular LAP, batched over the leading dims (JAX's
    ``jax.vmap(lap_rect)``): costs (..., q, m) fp32 with q <= m ->
    col_for_row (..., q) int64, every row a distinct column, minimising
    the total. A CUDA tensor goes through ``csrc/lap.cu``'s solve-only
    entry in one launch (or raises), a CPU tensor through
    `lap_rect_plain`."""
    lead, q, m = _check_rect(cost)
    if cost.device.type == "cpu":
        return lap_rect_plain(cost)
    if cost.device.type != "cuda":
        raise ValueError(f"lap_rect runs on cpu or cuda, got {cost.device}")
    global SOLVE_LAUNCHES
    n = math.prod(lead)
    out = cost.new_empty((*lead, q), dtype=torch.int64)
    if n == 0 or q == 0:
        return out
    if smem_bytes(q, m) > SMEM_LIMIT:
        raise ValueError(f"lap_rect's kernel holds one ({q}, {m}) problem "
                         f"in {smem_bytes(q, m)} bytes of shared memory, "
                         f"past the {SMEM_LIMIT} a block has")
    if m > MAX_COLUMNS:
        raise ValueError(f"lap_rect's kernel takes at most {MAX_COLUMNS} "
                         f"columns, got {m}")
    cost = cost.float().contiguous()
    err = _launch(cost, out, n, q, m)
    if err != 0:
        raise RuntimeError(f"lap_rect kernel launch failed: CUDA error {err}")
    SOLVE_LAUNCHES += 1
    return out


def lap_single(cost: torch.Tensor) -> torch.Tensor:
    """Exact square LAP (n, n); returns col_for_row (n,)."""
    return lap_rect(cost)


def lap_batch(cost: torch.Tensor) -> torch.Tensor:
    """`lap_single` over a batch (B, n, n) -> (B, n), in one call."""
    if cost.dim() != 3:
        raise ValueError(f"lap_batch takes (B, n, n) costs, got "
                         f"{tuple(cost.shape)}")
    return lap_rect(cost)


def lap_scipy(cost: np.ndarray) -> np.ndarray:
    """The host oracle: costs (..., Q, M) -> target slot per query (...,
    Q) int64 by scipy's ``linear_sum_assignment``, any Q and M; with Q > M
    the queries left without a slot get M (JAX's out-of-range index)."""
    cost = np.asarray(cost)
    *lead, q, m = cost.shape
    flat = cost.reshape(-1, q, m)
    out = np.full((flat.shape[0], q), m, np.int64)
    for b, c in enumerate(flat):
        rows, cols = linear_sum_assignment(c)
        out[b, rows] = cols
    return out.reshape(*lead, q)


def assign_plain(costs: torch.Tensor) -> torch.Tensor:
    """`lap_rect_plain` for every problem of `costs` (..., Q, M) -> the
    slot of each query (..., Q); for Q > M the transpose (each slot picks
    its query: the padded square's optimum), inverted, with the queries
    left without a slot at M (JAX ``matcher.py:216-223``)."""
    q, m = costs.shape[-2:]
    if q <= m:
        return lap_rect_plain(costs)
    row_for_col = lap_rect_plain(costs.transpose(-1, -2))
    slots = torch.arange(m, device=costs.device).expand_as(row_for_col)
    idx = torch.full(costs.shape[:-1], m, dtype=torch.int64,
                     device=costs.device)
    return idx.scatter_(-1, row_for_col, slots)


def _stacked_costs(layers, tgt_labels, tgt_boxes_xyxy, tgt_mask, cfg):
    return torch.stack([
        build_cost_matrix(cl, bx, tgt_labels, tgt_boxes_xyxy.float(),
                          tgt_mask, cfg) for cl, bx in layers])


def _matched(idx, tgt_mask):
    """in_range & the slot is real: (L, B, Q) bool."""
    m = tgt_mask.shape[1]
    real = torch.gather(tgt_mask[None].expand(idx.shape[0], -1, -1), 2,
                        idx.clamp(max=m - 1))
    return (idx < m) & real


def match_layers_plain(layers, tgt_labels, tgt_boxes_xyxy, tgt_mask,
                       cfg: MatcherConfig = MatcherConfig()):
    """The fused kernel's plain version: each layer's `build_cost_matrix`,
    stacked (L, B, Q, M), `assign_plain` and the gather. Returns
    (target_for_query (L, B, Q) int64, query_matched (L, B, Q) bool, the
    costs (L, B, Q, M) fp32)."""
    with torch.no_grad():
        costs = _stacked_costs(layers, tgt_labels, tgt_boxes_xyxy, tgt_mask,
                               cfg)
        idx = assign_plain(costs)
        return idx, _matched(idx, tgt_mask), costs


def _match_kernel():
    global _match_fn
    if _match_fn is None:
        fn = build.load("lap").arsvt_match_layers
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p,
                                                ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _match_fn = fn
    return _match_fn


def _match_launch(logits, boxes, labels, tgt_boxes, tgt_mask, cfg, idx,
                  matched, costs) -> int:
    """One launch of ``arsvt_match_layers``: per-layer pointers travel in
    two host arrays, so the layers need no stacking copy."""
    fn = _match_kernel()
    layers = len(logits)
    batch, q, classes = logits[0].shape
    ptrs = ctypes.c_void_p * layers
    dev = tgt_mask.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        return fn(ptrs(*(t.data_ptr() for t in logits)),
                  ptrs(*(t.data_ptr() for t in boxes)), layers,
                  labels.data_ptr(), int(labels.dtype == torch.int64),
                  tgt_boxes.data_ptr(), tgt_mask.data_ptr(), batch, q,
                  tgt_mask.shape[1], classes, cfg.cost_class, cfg.cost_bbox,
                  cfg.cost_giou, idx.data_ptr(), matched.data_ptr(),
                  None if costs is None else costs.data_ptr(), SMEM_LIMIT,
                  stream)


def assign_layers(layers, tgt_labels, tgt_boxes_xyxy, tgt_mask,
                  cfg: MatcherConfig = MatcherConfig(), *,
                  return_costs: bool = False):
    """The device route of `match_layers`: `layers` is a list of
    (class_logits (B, Q, C+1), boxes_cxcywh (B, Q, 4)). Returns
    (target_for_query (L, B, Q) int64, query_matched (L, B, Q) bool, the
    costs (L, B, Q, M) fp32 or None unless `return_costs`). On CUDA
    tensors one launch of ``csrc/lap.cu``'s fused entry (counted in
    `LAUNCHES`), which builds, solves and gathers every layer and image
    (or raises); on CPU tensors `match_layers_plain`. The head's fp32
    logits and boxes, fp32 target boxes, int32 or int64 labels and a bool
    mask go to the kernel as they are; other dtypes are cast first."""
    dev = layers[0][0].device
    if dev.type == "cpu":
        idx, matched, costs = match_layers_plain(
            layers, tgt_labels, tgt_boxes_xyxy, tgt_mask, cfg)
        return idx, matched, costs if return_costs else None
    if dev.type != "cuda":
        raise ValueError(f"assign_layers runs on cpu or cuda, got {dev}")
    global LAUNCHES
    batch, q, classes = layers[0][0].shape
    m = tgt_labels.shape[-1]
    if q < 1 or m < 1:
        raise ValueError(f"assign_layers needs queries and slots, got Q = "
                         f"{q}, M = {m}")
    if (not 1 <= len(layers) <= MAX_LAYERS or classes > MAX_CLASSES
            or max(q, m) > MAX_COLUMNS):
        raise ValueError(f"the fused matcher takes 1 to {MAX_LAYERS} layers "
                         f"of at most {MAX_CLASSES} classes and "
                         f"{MAX_COLUMNS} queries or slots, got {len(layers)} "
                         f"of {classes} and ({q}, {m})")
    need = match_smem_bytes(q, m, classes)
    if need > SMEM_LIMIT:
        raise ValueError(f"the fused matcher holds a ({q}, {m}) problem of "
                         f"{classes} classes in {need} bytes of shared "
                         f"memory, past the {SMEM_LIMIT} a block has")
    for cl, bx in layers:
        if (tuple(cl.shape) != (batch, q, classes)
                or tuple(bx.shape) != (batch, q, 4)):
            raise ValueError(f"every layer needs ({batch}, {q}, {classes}) "
                             f"logits and ({batch}, {q}, 4) boxes, got "
                             f"{tuple(cl.shape)} and {tuple(bx.shape)}")
    logits = [cl.float().contiguous() for cl, _ in layers]
    boxes = [bx.float().contiguous() for _, bx in layers]
    labels = (tgt_labels if tgt_labels.dtype in (torch.int32, torch.int64)
              else tgt_labels.long()).contiguous()
    tgt_boxes = tgt_boxes_xyxy.float().contiguous()
    mask = tgt_mask.bool().contiguous()
    lead = (len(layers), batch, q)
    idx = logits[0].new_empty(lead, dtype=torch.int64)
    matched = logits[0].new_empty(lead, dtype=torch.bool)
    costs = logits[0].new_empty((*lead, m)) if return_costs else None
    err = _match_launch(logits, boxes, labels, tgt_boxes, mask, cfg, idx,
                        matched, costs)
    if err != 0:
        raise RuntimeError(f"the fused matcher's launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return idx, matched, costs


def match_layers(layers, tgt_labels, tgt_boxes_xyxy, tgt_mask,
                 cfg: MatcherConfig = MatcherConfig()):
    """Matching of several decoder layers' outputs against one set of
    targets: `layers` is a list of (class_logits (B, Q, C+1), boxes (B, Q,
    4)). Returns a list of (target_for_query (B, Q) int64,
    query_matched (B, Q) bool), one per layer, on the targets' device:
    `target_for_query[b, q]` is the slot assigned to query q, and
    `query_matched` is True only where that slot holds a real target. The
    costs are computed without a graph (the assignment is discrete). The
    device route is `assign_layers` (one launch on the card, no copy to
    the host); the scipy route stacks the eager costs (L, B, Q, M),
    copies them to the host once and the indices back once."""
    with torch.no_grad():
        if cfg.backend == "scipy":
            costs = _stacked_costs(layers, tgt_labels, tgt_boxes_xyxy,
                                   tgt_mask, cfg)
            host = costs.cpu().numpy()  # (L, B, Q, M): one copy to the host
            idx = torch.from_numpy(lap_scipy(host)).to(tgt_labels.device)
            matched = _matched(idx, tgt_mask)
        else:
            idx, matched, _ = assign_layers(layers, tgt_labels,
                                            tgt_boxes_xyxy, tgt_mask, cfg)
        return list(zip(idx, matched))


def match(class_logits, boxes_cxcywh, tgt_labels, tgt_boxes_xyxy, tgt_mask,
          cfg: MatcherConfig = MatcherConfig()):
    """Batched matching of one layer, JAX's `match` contract: returns
    (target_for_query (B, Q), query_matched (B, Q) bool)."""
    return match_layers([(class_logits, boxes_cxcywh)], tgt_labels,
                        tgt_boxes_xyxy, tgt_mask, cfg)[0]
