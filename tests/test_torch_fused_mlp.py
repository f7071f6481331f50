"""The port's fused tanh-GELU MLP (``ARSVT_ENABLE_FUSED_MLP``) against the
JAX package on the CPU: the plain versions of kernels #8 and #9 against
JAX's ``_fwd`` and ``_bwd`` and the autograd Function against ``jax.grad``
of JAX's ``fused_gelu_mlp``, all with the Pallas kernels run in interpret
mode; the cost of the bf16 u against the unfused MLP; the routing of
``gelu_mlp`` in a ViT block and in the DETR head's FFN. The CUDA kernels
are held against their plain versions on the card by ``chip_smoke.py``.

JAX's ``fused_mlp.py`` has no ``interpret`` argument, so each test swaps
the module's ``pl`` for one whose ``pallas_call`` always interprets;
nothing in the JAX package changes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from arsvt_tpu.ops.pallas import fused_mlp as jax_fused_mlp
from arsvt_tpu_torch.models import heads, vit
from arsvt_tpu_torch.models.detector import DetectorConfig, apply_detector
from arsvt_tpu_torch.models.detector import init_detector
from arsvt_tpu_torch.models.heads import DetrHeadConfig
from arsvt_tpu_torch.models.vit import BackboneConfig, init_backbone
from arsvt_tpu_torch.ops import build, fused_mlp, mlp
from arsvt_tpu_torch.ops.fused_mlp import (
    fused_gelu_mlp,
    fused_mlp_bwd,
    fused_mlp_fwd,
)

torch.set_num_threads(1)  # tier-1 runs several xdist workers

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# (n, D, M): n a multiple of no tile; M = 256 and M = 1600 / 4; then
# widths that are not multiples of 8, which the kernels take on their
# ragged route: (12, 20), (37, 75) and (100, 300)
SHAPES = [(37, 128, 256), (21, 64, 400), (19, 12, 20), (23, 37, 75),
          (13, 100, 300)]


class _InterpretPallas:
    """``pl`` with every ``pallas_call`` run in interpret mode."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, **kw):
        return pl.pallas_call(*args, **{**kw, "interpret": True})


@pytest.fixture(autouse=True)
def _interpret_and_fp32(monkeypatch):
    monkeypatch.setattr(jax_fused_mlp, "pl", _InterpretPallas())
    with jax.default_matmul_precision("highest"):
        yield


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _inputs(n, d, m, dtype, seed=0):
    """x, w1, b1, w2, b2 as numpy fp32 values exact in `dtype`."""
    arrs = [_rand((n, d), seed), _rand((d, m), seed + 1, d ** -0.5),
            _rand((m,), seed + 2, 0.1), _rand((m, d), seed + 3, m ** -0.5),
            _rand((d,), seed + 4, 0.1)]
    return [_to_np(jnp.asarray(a).astype(_JAX[dtype])) for a in arrs]


def _close(got, ref, what, rel, abs_=0.0):
    """Elementwise within rel of the reference's largest magnitude."""
    ref = _to_np(ref)
    np.testing.assert_allclose(_to_np(got), ref, rtol=0,
                               atol=abs_ + rel * float(np.abs(ref).max()),
                               err_msg=what)


# Plain versions against the Pallas kernels, same rounding points, each
# output within a share of the reference's largest magnitude. fp32: the
# sums run in another order (measured <= 6.4e-7 on out, 1.7e-7 on dw2:
# held at 1e-5). du is rounded to bf16 on both sides, and XLA's tanh and
# PyTorch's differ in the last bits (XLA's gives gelu'(4.875) = 1 exactly,
# PyTorch's 1 + 3.8e-6), which flips single roundings of du by one bf16
# ulp: measured <= 2.2e-5 on dx, 5.0e-5 on dw1, 2.5e-5 on db1, held at
# 2e-4; u itself to one bf16 ulp (2^-7 relative). bf16: out, dx and h are
# rounded to bf16 too (measured <= 2.2e-3): 2^-7.
DU_GRADS = ("dx", "dw1", "db1")


def _rel(dtype, name):
    if dtype == "bfloat16":
        return 2.0 ** -7
    return 2e-4 if name in DU_GRADS else 1e-5


@pytest.mark.parametrize("n,d,m", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_plain_matches_pallas_fwd(dtype, n, d, m):
    x, w1, b1, w2, b2 = _inputs(n, d, m, dtype)
    ref_out, ref_u = jax_fused_mlp._fwd(
        *(jnp.asarray(a).astype(_JAX[dtype]) for a in (x, w1, b1, w2, b2)))
    out, u = fused_mlp_fwd(*(torch.from_numpy(a).to(_TORCH[dtype])
                             for a in (x, w1, b1, w2, b2)))
    assert out.dtype == _TORCH[dtype] and out.shape == (n, d)
    assert u.dtype == torch.bfloat16 and u.shape == (n, m)
    _close(out, ref_out, "out", _rel(dtype, "out"))
    np.testing.assert_allclose(_to_np(u), _to_np(ref_u), rtol=2.0 ** -7,
                               atol=1e-6)


@pytest.mark.parametrize("n,d,m", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_plain_matches_pallas_bwd(dtype, n, d, m):
    x, w1, b1, w2, b2 = _inputs(n, d, m, dtype, seed=5)
    dout = _to_np(jnp.asarray(_rand((n, d), 11)).astype(_JAX[dtype]))
    jx, jw1, jb1, jw2, jb2, jdo = (jnp.asarray(a).astype(_JAX[dtype])
                                   for a in (x, w1, b1, w2, b2, dout))
    _, ju = jax_fused_mlp._fwd(jx, jw1, jb1, jw2, jb2)
    ref = jax_fused_mlp._bwd(jx, ju, jw1, jw2, jdo)
    t = {k: torch.from_numpy(a).to(_TORCH[dtype])
         for k, a in (("x", x), ("w1", w1), ("w2", w2), ("do", dout))}
    got = fused_mlp_bwd(t["x"], torch.from_numpy(_to_np(ju)).bfloat16(),
                        t["w1"], t["w2"], t["do"])
    assert got[0].dtype == _TORCH[dtype]
    assert all(g.dtype == torch.float32 for g in got[1:])
    for name, g, r in zip(("dx", "dw1", "db1", "dw2"), got, ref):
        r = np.asarray(r, np.float32).reshape(tuple(g.shape))
        _close(g, r, name, _rel(dtype, name))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_gelu_mlp_matches_jax_grad(dtype):
    """The autograd Function against JAX's custom VJP, forward and the
    gradients of sum(out * w) with respect to all five inputs, x (2, 19,
    128), M = 256, the tolerances above (db2 is summed in fp32 on both
    sides)."""
    x, w1, b1, w2, b2 = _inputs(38, 128, 256, dtype, seed=20)
    x = x.reshape(2, 19, 128)
    w = _rand((2, 19, 128), 26)
    args = [x, w1, b1, w2, b2]
    jargs = [jnp.asarray(a).astype(_JAX[dtype]) for a in args]

    def jloss(*a):
        return jnp.sum(jax_fused_mlp.fused_gelu_mlp(*a).astype(jnp.float32)
                       * w)

    jout = jax_fused_mlp.fused_gelu_mlp(*jargs)
    jgrads = jax.grad(jloss, argnums=tuple(range(5)))(*jargs)
    targs = [torch.from_numpy(a).to(_TORCH[dtype]).requires_grad_(True)
             for a in args]
    out = fused_gelu_mlp(*targs)
    tgrads = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(),
                                 targs)
    assert out.shape == (2, 19, 128) and out.dtype == _TORCH[dtype]
    _close(out, jout, "out", _rel(dtype, "out"))
    for name, g, r in zip(("dx", "dw1", "db1", "dw2", "db2"), tgrads,
                          jgrads):
        assert g.dtype == _TORCH[dtype] and g.shape == r.shape, name
        _close(g, r, name, _rel(dtype, name))


def test_fused_matches_the_unfused_mlp():
    """fp32: the fused route against `gelu_mlp`'s cuBLAS-style route. The
    forward differs by fp32 rounding only (u stays fp32 inside the fused
    forward): 1e-5 of the largest |out|. The gradients read the bf16 u and
    du (2^-9 relative each; measured <= 2.2e-3 of each one's largest
    magnitude): within 2^-7."""
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _inputs(45, 128, 256,
                                                              "float32", 30))
    w = torch.from_numpy(_rand((45, 128), 31))
    outs, grads = [], []
    for fn in (fused_gelu_mlp, mlp.gelu_mlp):
        targs = [a.clone().requires_grad_(True) for a in (x, w1, b1, w2, b2)]
        out = fn(*targs)
        outs.append(out.detach())
        grads.append(torch.autograd.grad((out * w).sum(), targs))
    _close(outs[0], outs[1], "out", 1e-5)
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), *grads):
        _close(a, b, name, 2.0 ** -7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_match_pallas_at_vit_l_width(dtype):
    """ViT-L's MLP (D = 1,024, M = 4,096) at n = 24: the width the
    kernels split into two 512-column slices. Forward and backward plain
    versions against JAX's `_fwd` and `_bwd`, the tolerances above, except
    the gradients that read du in fp32: with 4,096 du values a row, more of
    them sit where XLA's and PyTorch's tanh flip a bf16 rounding, and with
    24 rows one flipped term is a larger share of a dw1 or db1 element
    (measured 1.2e-3 of the largest |dw1|): 2^-8."""
    n, d, m = 24, 1024, 4096
    x, w1, b1, w2, b2 = _inputs(n, d, m, dtype, seed=40)
    dout = _to_np(jnp.asarray(_rand((n, d), 41)).astype(_JAX[dtype]))
    jx, jw1, jb1, jw2, jb2, jdo = (jnp.asarray(a).astype(_JAX[dtype])
                                   for a in (x, w1, b1, w2, b2, dout))
    ref_out, ju = jax_fused_mlp._fwd(jx, jw1, jb1, jw2, jb2)
    ref = jax_fused_mlp._bwd(jx, ju, jw1, jw2, jdo)
    t = [torch.from_numpy(a).to(_TORCH[dtype]) for a in (x, w1, b1, w2, b2)]
    out, u = fused_mlp_fwd(*t)
    _close(out, ref_out, "out", _rel(dtype, "out"))
    np.testing.assert_allclose(_to_np(u), _to_np(ju), rtol=2.0 ** -7,
                               atol=1e-6)
    got = fused_mlp_bwd(t[0], torch.from_numpy(_to_np(ju)).bfloat16(), t[1],
                        t[3], torch.from_numpy(dout).to(_TORCH[dtype]))
    for name, g, r in zip(("dx", "dw1", "db1", "dw2"), got, ref):
        rel = max(2.0 ** -8 if name in DU_GRADS else 0.0, _rel(dtype, name))
        _close(g, np.asarray(r, np.float32).reshape(tuple(g.shape)), name,
               rel)


class _FakeCFunction:
    """A C entry point as ctypes gives it: settable signature, recorded
    calls, a fixed answer per first argument."""

    def __init__(self, answers=None):
        self.answers, self.calls = answers or {}, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.answers.get(args[0], 0)


def test_kernel_width_check_takes_vit_l(monkeypatch):
    """The wrappers' own shape check takes D = 1,024 (ViT-L, M = 4,096)
    and D = 1,280 (ViT-H, M = 5,120) in both dtypes; the bound on D lives
    in the C entry alone (``arsvt_fused_mlp_max_d``, read through
    `fused_mlp.max_d`): fp32's row-tile kernel stages its rows over the
    full D (1,728), bf16's wgmma kernels have no bound, which the entry
    answers with 0 and `max_d` with None. A launch refused past fp32's
    bound reads as a shared-memory bound; a refused bf16 launch at any D
    reads as a launch failure. Here a fake library answers for the built
    one, which ``chip_smoke.py`` queries on the card."""
    for dtype in (torch.float32, torch.bfloat16):
        for d, m in ((1024, 4096), (1280, 5120)):
            x = torch.zeros(3, d, dtype=dtype)
            w1 = torch.zeros(d, m, dtype=dtype)
            assert fused_mlp._check(x, w1, w1.T) == (3, d, m)
    lib = type("Lib", (), {})()
    lib.arsvt_fused_mlp_max_d = _FakeCFunction({0: 1728, 1: 0})
    monkeypatch.setattr(build, "load", lambda name: lib)
    assert fused_mlp.max_d(torch.float32) == 1728
    assert fused_mlp.max_d(torch.bfloat16) is None
    invalid = fused_mlp._CUDA_ERROR_INVALID_VALUE
    err = fused_mlp._launch_error(invalid, "fused MLP forward", 1736,
                                  torch.float32)
    assert isinstance(err, ValueError)
    assert "shared memory" in str(err) and "D <= 1728" in str(err)
    for code, width, dtype in ((invalid, 1728, torch.float32),
                               (700, 1736, torch.float32),
                               (invalid, 1280, torch.bfloat16),
                               (invalid, 4096, torch.bfloat16)):
        err = fused_mlp._launch_error(code, "fused MLP backward", width,
                                      dtype)
        assert isinstance(err, RuntimeError)
        assert f"CUDA error {code}" in str(err)


def test_wrappers_check_and_count_no_cpu_launch():
    """CPU tensors take the plain versions and count no launch, in either
    dtype; the counts a CUDA call adds are the kernels it launches: two
    for a bf16 forward (u and h, then out), one for an fp32 forward (the
    row-tile kernel), two for a backward (dx/du, then the weight
    gradients)."""
    assert fused_mlp.FWD_LAUNCHES_PER_CALL == {torch.bfloat16: 2,
                                               torch.float32: 1}
    assert fused_mlp.BWD_LAUNCHES_PER_CALL == 2
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _inputs(5, 16, 24,
                                                              "float32"))
    before = (fused_mlp.LAUNCHES, fused_mlp.BWD_LAUNCHES)
    for dt in (torch.float32, torch.bfloat16):
        out, u = fused_mlp_fwd(x.to(dt), w1.to(dt), b1, w2.to(dt), b2)
        fused_mlp_bwd(x.to(dt), u, w1.to(dt), w2.to(dt), out)
    assert (fused_mlp.LAUNCHES, fused_mlp.BWD_LAUNCHES) == before
    out, u = fused_mlp_fwd(x, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="n, D and M >= 1"):
        fused_mlp_fwd(x[:0], w1, b1, w2, b2)
    with pytest.raises(TypeError, match="float32 or all"):
        fused_mlp_fwd(x, w1.bfloat16(), b1, w2, b2)
    with pytest.raises(ValueError, match="biases"):
        fused_mlp_fwd(x, w1, b2, w2, b2)
    with pytest.raises(ValueError, match="u must be"):
        fused_mlp_bwd(x, u.float(), w1, w2, out)
    with pytest.raises(ValueError, match="dout"):
        fused_mlp_bwd(x, u, w1, w2, out.bfloat16())


@pytest.mark.parametrize("name,tpu_kernels", [
    ("fused_mlp_fwd", ("fused_mlp.py::_fwd_kernel",)),
    ("fused_mlp_bwd", ("fused_mlp.py::_bwd_dx_kernel", "::_bwd_dw_kernel")),
])
def test_sources_name_the_tpu_kernels_and_build_for_sm90a(name, tpu_kernels):
    text = build.source_path(name).read_text()
    assert all(k in text for k in tpu_kernels)
    assert f'extern "C" int arsvt_{name}' in text
    assert '#include "mlp_tile.cuh"' in text
    assert '#include "mlp_gemm.cuh"' in text
    assert "cudaGetLastError" in text
    for source in (text, *((build.CSRC_DIR / h).read_text()
                           for h in ("mlp_gemm.cuh", "hopper.cuh",
                                     "mlp_tile.cuh"))):
        assert "atomic" not in source.replace("No atomics", "").replace(
            "no atomics", "")
    tile = (build.CSRC_DIR / "mlp_tile.cuh").read_text()
    assert '#include "warp_tile.cuh"' in tile
    assert "mma.sync" in (build.CSRC_DIR / "warp_tile.cuh").read_text()
    cmd = build.nvcc_command(build.source_path(name), build.library_path(name))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert name in build.kernel_names()


@pytest.mark.parametrize("name,entry,launches", [
    ("fused_mlp_fwd", "forward_bf16(", ("launch<kFwdU>", "launch<kFwdOut>")),
    ("fused_mlp_bwd", "backward_bf16(",
     ("launch<kBwdDu>", "launch<kBwdGrads>")),
])
def test_bf16_runs_on_wgmma_fed_by_tma_and_fp32_on_the_row_tile(
        name, entry, launches):
    """The C entry sends dtype 1 (bf16) to mlp_gemm.cuh's warp-specialised
    kernel, whose products are wgmma.mma_async on tiles that TMA
    (cp.async.bulk.tensor) lands in an mbarrier ring, with setmaxnreg
    handing registers from the producer warp to the consumers; dtype 0
    (fp32) stays on mlp_tile.cuh's row-tile kernel."""
    text = build.source_path(name).read_text()
    bf16 = text[text.index("case 1:"):text.index("default:", text.index(
        "case 1:"))]
    fp32 = text[text.index("case 0:"):text.index("case 1:")]
    assert entry in bf16 and "row_tile" not in bf16
    assert all(launch in text for launch in launches)
    assert entry not in fp32
    assert ("launch_row_tile<float" in fp32 or "launch_fp32(" in fp32)
    gemm = (build.CSRC_DIR / "mlp_gemm.cuh").read_text()
    hopper = (build.CSRC_DIR / "hopper.cuh").read_text()
    assert '#include "hopper.cuh"' in gemm
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.init",
                "mbarrier.try_wait", "setmaxnreg.inc", "setmaxnreg.dec",
                "CU_TENSOR_MAP_SWIZZLE_128B"):
        assert ptx in hopper, ptx
    for call in ("wgmma_m64n128k16<", "tma_load(", "mbar_wait(",
                 "setmaxnreg_inc<", "setmaxnreg_dec<"):
        assert call in gemm, call
    assert "mma.sync" not in gemm and "ldmatrix" not in gemm


def test_kernel_ab_calls_each_tree_through_its_own_interface():
    """``kernel_ab.py`` calls #8 of a tree from before the h scratch
    (no ``arsvt_fused_mlp_version``) through an adapter that drops h from
    the current wrapper's argument list, and ``chip_smoke.py``'s bf16
    selection takes the wgmma kernels, which have no type argument, and
    the bf16 template instantiations, but no fp32 one."""
    import chip_smoke
    import kernel_ab

    lib = type("Lib", (), {})()
    lib.arsvt_fused_mlp_fwd = _FakeCFunction()
    call = kernel_ab.fwd_without_scratch(lib)
    assert len(lib.arsvt_fused_mlp_fwd.argtypes) == 12
    call(1, 2, 3, 4, 5, 6, 7, 8, 37, 128, 256, 1, 9)
    assert lib.arsvt_fused_mlp_fwd.calls == [
        (1, 2, 3, 4, 5, 6, 7, 37, 128, 256, 1, 9)]
    assert chip_smoke.is_bf16_kernel(
        "_ZN4mlpg16gemm_bf16_kernelILi3EEEvNS_6ParamsE")
    assert chip_smoke.is_bf16_kernel(
        "_ZN4attn20attention_fwd_kernelI13__nv_bfloat16Li64ELb0EEEvNS_7Fwd"
        "ArgsE")
    assert not chip_smoke.is_bf16_kernel(
        "_ZN3mlp15row_tile_kernelIfLb0EEEvPKT_S3_S3_PKfS5_PK13__nv_bfloat16"
        "PS6_PS1_S9_iii")
    assert chip_smoke.MLP_LIBRARIES == ("fused_mlp_fwd", "fused_mlp_bwd")


def test_kernel_ab_times_every_hand_written_attention_and_mlp_kernel():
    """``kernel_ab.py`` builds and times #1-#9 from each tree, the
    backwards #2 and #4 and the AdamW #7 through their wrappers' own
    loaders, held at phase 3's limits, beside SDPA's backward (forward and
    backward less forward), at the training paths' shapes."""
    import kernel_ab

    assert set(kernel_ab.KERNELS) == {
        "encoder_attention_fwd", "encoder_attention_bwd",
        "flash_attention_fwd", "flash_attention_bwd",
        "encoder_attention_savep_fwd", "encoder_attention_savep_bwd",
        "fused_mlp_fwd", "fused_mlp_bwd", "fused_adamw"}
    module, fn, loader = kernel_ab.KERNELS["fused_adamw"]
    assert (fn, loader) == ("_fn", "_kernel") and hasattr(module, fn)
    for name in kernel_ab.KERNELS:
        assert name in build.kernel_names()
    module, fn, loader = kernel_ab.KERNELS["encoder_attention_bwd"]
    assert (fn, loader) == ("_bwd_fn", "_bwd_kernel") and hasattr(module, fn)
    module, fn, loader = kernel_ab.KERNELS["flash_attention_bwd"]
    assert (fn, loader) == ("_bwd_fn", "_bwd_kernel") and hasattr(module, fn)
    assert kernel_ab.LIMITS["encoder_attention_bwd"] == (
        (kernel_ab.TOL_BWD_BF16, kernel_ab.TOL_BWD_BF16),) * 3


def _count_fused(monkeypatch):
    calls = [0]
    real = mlp.fused_gelu_mlp

    def spy(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(mlp, "fused_gelu_mlp", spy)
    return calls


@pytest.mark.parametrize("env,expected", [("1", 1), (None, 0)])
def test_vit_block_routes_the_fused_mlp(env, expected, monkeypatch):
    """With the switch on, a ViT block's MLP runs the fused Function, in a
    training forward and under inference_mode alike (JAX's ``mlp.py:66``
    has no train gate); without it, the unfused MLP. ``ARSVT_DISABLE_PALLAS``,
    which tests/conftest.py sets, would turn the switch off."""
    monkeypatch.delenv("ARSVT_DISABLE_PALLAS", raising=False)
    if env is None:
        monkeypatch.delenv("ARSVT_ENABLE_FUSED_MLP", raising=False)
    else:
        monkeypatch.setenv("ARSVT_ENABLE_FUSED_MLP", env)
    calls = _count_fused(monkeypatch)
    cfg = BackboneConfig(image_size=16, patch_size=8, embed_dim=64, depth=1,
                         num_heads=1, mlp_dim=128)
    params = init_backbone(cfg, seed=0)
    x = torch.from_numpy(_rand((2, cfg.seq_len, 64), 40))
    vit._encoder_block(x, params["blocks"][0], cfg, train=True)
    with torch.inference_mode():
        vit._encoder_block(x, params["blocks"][0], cfg)
    assert calls[0] == 2 * expected


@pytest.mark.parametrize("env,expected", [("1", 4), (None, 0)])
def test_detr_head_ffn_routes_the_fused_mlp(env, expected, monkeypatch):
    """A detector forward (2 backbone blocks, 2 decoder blocks): every MLP,
    the DETR head's FFN included (JAX's ``heads.py:223``), takes the fused
    Function with the switch on, and none without it."""
    monkeypatch.delenv("ARSVT_DISABLE_PALLAS", raising=False)
    if env is None:
        monkeypatch.delenv("ARSVT_ENABLE_FUSED_MLP", raising=False)
    else:
        monkeypatch.setenv("ARSVT_ENABLE_FUSED_MLP", env)
    calls = _count_fused(monkeypatch)
    cfg = DetectorConfig(
        BackboneConfig(image_size=32, patch_size=8, embed_dim=128, depth=2,
                       num_heads=2, mlp_dim=256),
        DetrHeadConfig(num_classes=6, num_queries=10, depth=2, num_heads=4,
                       ffn_dim=128), 32)
    assert heads.gelu_mlp is mlp.gelu_mlp
    with torch.inference_mode():
        out = apply_detector(init_detector(cfg), torch.from_numpy(
            np.random.default_rng(41).uniform(size=(2, 32, 32, 3)).astype(
                np.float32)), cfg)
    assert out["class_logits"].shape == (2, 10, 7)
    assert calls[0] == expected
