#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a Hopper card and the
CUDA toolkit. It imports nothing of JAX or ``arsvt_tpu``. Phases:

1. device check: the card's name and power limit; TF32 off for fp32
   matmuls and convolutions;
2. build every kernel under ``arsvt_tpu_torch/csrc`` (one nvcc each, all
   started together) and print the compiler's resource report;
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes in bf16 and fp32 plus an odd shape, then timed with
   CUDA events beside its bound and the library's call on the same work;
4. ViT-B/16@224 from a seeded init (with a seeded random head) through
   ``StreamingClassifier``: fp32 on the card against the plain path on the
   CPU, then bf16 on the card against the fp32 run;
5. the HTTP server: /classify single and micro-batched, /healthz, /stats;
6. a torch.profiler window over bf16 forwards at B=1 and B=8: the device's
   busy share and the kernels by device time.

Kernel launch counts are zeroed just before phase 4 and read after phase
5; every kernel of the path must have launched exactly once per layer and
forward. Any failure exits non-zero. The last lines are the kernels'
record, the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from arsvt_tpu_torch.data.pipeline import letterbox
from arsvt_tpu_torch.evaluation.classify import StreamingClassifier
from arsvt_tpu_torch.models.classifier import init_image_classifier
from arsvt_tpu_torch.models.registry import PRESETS
from arsvt_tpu_torch.ops import build, encoder_attention
from arsvt_tpu_torch.serving.server import InferenceServer

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12    # dense tensor-core bf16, H100 SXM data sheet

# Kernel against plain version on the card. fp32: the same fp32 arithmetic
# summed in another order (sequential FMA over 64 dims against cuBLAS), so
# a few fp32 ulps of O and lse. bf16: that order can flip the bf16 rounding
# of single p entries and of O itself: one or two bf16 ulps (2^-8
# relative each), so atol = rtol = 2^-7; lse stays fp32.
TOL_FP32 = 2e-5
TOL_BF16 = 2.0 ** -7
TOL_LSE = 1e-4
# Model probabilities. fp32 card against fp32 CPU: the same arithmetic in
# another summation order through 12 layers. bf16 against fp32: bf16
# rounds every activation to 8 mantissa bits, compounding over 12 layers;
# the CPU test of a 2-layer model sees 0.04 on logits of magnitude 5.
TOL_PROBS_FP32 = 1e-4
TOL_PROBS_BF16 = 5e-2


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def seeded_qkv(b, s, d, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(b, s, 3 * d, generator=gen).to(dtype).cuda()


def library_attention(qkv, num_heads):
    """One library call on the same work, with its head transposes: a
    yardstick for the timing only; the port never calls it."""
    b, s, three_d = qkv.shape
    d = three_d // 3
    q, k, v = qkv.view(b, s, 3, num_heads, d // num_heads).permute(
        2, 0, 3, 1, 4).unbind(0)
    out = F.scaled_dot_product_attention(q, k, v)
    return out.transpose(1, 2).reshape(b, s, d)


def attention_bound(b, s, d, num_heads, elem=2):
    head_dim = d // num_heads
    nbytes = b * s * 3 * d * elem + b * s * d * elem + b * num_heads * s * 4
    flops = 4 * b * num_heads * s * s * head_dim
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes, flops


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def phase_kernel_checks(cfg) -> dict:
    d, h = cfg.embed_dim, cfg.num_heads
    s = cfg.seq_len
    cases = [(8, s, d, h, torch.bfloat16), (8, s, d, h, torch.float32),
             (1, s, d, h, torch.bfloat16), (3, 17, 128, 2, torch.bfloat16),
             (3, 17, 128, 2, torch.float32)]
    errs = {}
    for i, (b, s_, d_, h_, dtype) in enumerate(cases):
        qkv = seeded_qkv(b, s_, d_, dtype, seed=100 + i)
        out, lse = encoder_attention.encoder_attention_fwd(qkv, h_)
        torch.cuda.synchronize()
        ref_out, ref_lse = encoder_attention.encoder_attention_fwd_plain(
            qkv, h_)
        check(out.shape == ref_out.shape and lse.shape == (b, h_, 1, s_),
              f"shapes {tuple(out.shape)} {tuple(lse.shape)}")
        check(bool(torch.isfinite(out.float()).all()), "non-finite O")
        e_out, e_lse = max_err(out, ref_out), max_err(lse, ref_lse)
        if dtype == torch.float32:
            ok = e_out <= TOL_FP32
        else:
            ok = bool(((out.float() - ref_out.float()).abs()
                       <= TOL_BF16 + TOL_BF16 * ref_out.float().abs()).all())
        key = f"B{b}_S{s_}_D{d_}_H{h_}_{str(dtype).split('.')[-1]}"
        log(json.dumps({"check": "encoder_attention_fwd", "case": key,
                        "max_abs_err_out": e_out,
                        "max_abs_err_lse": e_lse}))
        check(ok, f"encoder_attention_fwd O disagrees at {key}: {e_out}")
        check(e_lse <= TOL_LSE, f"lse disagrees at {key}: {e_lse}")
        errs[key] = e_out

    timings = {}
    for b in (1, 8):
        qkv = seeded_qkv(b, s, d, torch.bfloat16, seed=7)
        ms = cuda_ms(lambda: encoder_attention.encoder_attention_fwd(qkv, h),
                     iters=200)
        plain_ms = cuda_ms(
            lambda: encoder_attention.encoder_attention_fwd_plain(qkv, h),
            iters=50)
        library_ms = cuda_ms(lambda: library_attention(qkv, h), iters=200)
        bound_ms, bound_by, nbytes, flops = attention_bound(b, s, d, h)
        timings[b] = {"ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by}
        log(json.dumps({
            "timing": "encoder_attention_fwd", "B": b, "S": s, "D": d,
            "H": h, "dtype": "bfloat16", "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "flops": flops,
            "bound_share": bound_ms / ms,
        }))
    key8 = f"B8_S{s}_D{d}_H{h}_bfloat16"
    return {"max_abs_err": errs[key8], **timings[8]}


def seeded_head(params, d, num_classes, seed):
    """A zero head makes every answer uniform and hides faults: fill it
    with seeded values giving logits of a few units."""
    gen = torch.Generator().manual_seed(seed)
    params["classifier"]["head"] = {
        "kernel": torch.randn(d, num_classes, generator=gen) * 3 * d ** -0.5,
        "bias": torch.randn(num_classes, generator=gen) * 0.1,
    }
    return params


def top2_margin(probs: np.ndarray) -> np.ndarray:
    top = np.sort(probs, axis=-1)
    return top[..., -1] - top[..., -2]


def phase_model(cfg, params, images, batch):
    """fp32 on the card against the CPU plain path; bf16 against fp32.
    Returns (bf16 classifier, number of CUDA forwards run)."""
    n = 6
    cpu = StreamingClassifier(params, cfg, n, compute_dtype=torch.float32,
                              device="cpu")
    gpu32 = StreamingClassifier(params, cfg, n, compute_dtype=torch.float32,
                                device="cuda")
    gpu16 = StreamingClassifier(params, cfg, n, device="cuda")  # bf16
    forwards = 2  # the two warm-ups
    ref = [cpu(img) for img in images]
    p32 = [gpu32(img) for img in images]
    p16 = [gpu16(img) for img in images]
    forwards += 2 * len(images)
    idx_cpu_b, probs_cpu_b = cpu.infer_batch(batch)
    idx32_b, probs32_b = gpu32.infer_batch(batch)
    idx16_b, probs16_b = gpu16.infer_batch(batch)
    forwards += 2
    probs_cpu = np.stack([r[2] for r in ref] + list(probs_cpu_b))
    probs32 = np.stack([r[2] for r in p32] + list(probs32_b))
    probs16 = np.stack([r[2] for r in p16] + list(probs16_b))
    for name, p in (("fp32", probs32), ("bf16", probs16)):
        check(p.shape == (len(images) + len(batch), n), f"{name} shape")
        check(bool(np.isfinite(p).all()), f"{name} non-finite probs")
        check(bool(np.allclose(p.sum(-1), 1.0, atol=1e-4)),
              f"{name} probs do not sum to 1")
    e32 = float(np.abs(probs32 - probs_cpu).max())
    e16 = float(np.abs(probs16 - probs32).max())
    # argmax must agree wherever the reference's top two are further
    # apart than the comparison's tolerance (closer is a tie at that
    # precision)
    clear32 = top2_margin(probs_cpu) > 2 * TOL_PROBS_FP32
    clear16 = top2_margin(probs32) > 2 * TOL_PROBS_BF16
    agree32 = probs32.argmax(-1) == probs_cpu.argmax(-1)
    agree16 = probs16.argmax(-1) == probs32.argmax(-1)
    log(json.dumps({
        "check": "vit_base_16_224 classify", "images": len(probs32),
        "max_abs_err_probs_fp32_cuda_vs_cpu": e32,
        "max_abs_err_probs_bf16_vs_fp32": e16,
        "argmax_fp32_vs_cpu": f"{int(agree32.sum())}/{len(agree32)}",
        "argmax_bf16_vs_fp32": f"{int(agree16.sum())}/{len(agree16)}",
        "classes_fp32": probs32.argmax(-1).tolist(),
        "clear_margin_bf16": int(clear16.sum()),
    }))
    check(e32 <= TOL_PROBS_FP32, f"fp32 cuda vs cpu probs {e32}")
    check(bool(agree32[clear32].all()), "fp32 argmax cuda vs cpu")
    check(e16 <= TOL_PROBS_BF16, f"bf16 vs fp32 probs {e16}")
    check(bool(agree16[clear16].all()), "bf16 argmax vs fp32")
    check(list(idx32_b) == list(probs32_b.argmax(-1)), "infer_batch idx")

    # forward latency on the card (host clock around synchronized work)
    for b in (1, 8):
        x = batch[:b]
        gpu16.infer_batch(x)
        t = []
        for _ in range(10):
            t0 = time.perf_counter()
            gpu16.infer_batch(x)
            t.append(time.perf_counter() - t0)
        forwards += 11
        log(json.dumps({"timing": "StreamingClassifier.infer_batch bf16",
                        "B": b, "p50_ms": float(np.median(t) * 1e3),
                        "min_ms": float(np.min(t) * 1e3)}))
    return gpu16, forwards


def png_bytes(image_u8: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image_u8).save(buf, format="PNG")
    return buf.getvalue()


def decoded(body: bytes, size: int) -> np.ndarray:
    """What the server feeds the classifier for `body`."""
    img = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"),
                     np.float32) / 255.0
    return letterbox(img, size)[0]


def post(url: str, body: bytes) -> tuple[int, dict]:
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def phase_server(cfg, params, direct, bodies) -> int:
    """Returns the number of CUDA forwards run."""
    forwards = 0
    expected = []
    for body in bodies:
        idx, _, probs = direct(decoded(body, cfg.image_size))
        expected.append((idx, probs))
    forwards += len(bodies)

    served = StreamingClassifier(params, cfg, 6, device="cuda")
    forwards += 1
    srv = InferenceServer(classifier=served)
    host, port = srv.start_background(port=0)
    url = f"http://{host}:{port}"
    try:
        client_ms = []
        for i, body in enumerate(bodies):
            t0 = time.perf_counter()
            status, data = post(url + "/classify", body)
            client_ms.append((time.perf_counter() - t0) * 1e3)
            check(status == 200, f"/classify status {status}")
            check(data["class"] == expected[i][0],
                  f"/classify class {data['class']} != {expected[i][0]}")
        for _ in range(16):  # more samples for the latency percentiles
            t0 = time.perf_counter()
            post(url + "/classify", bodies[0])
            client_ms.append((time.perf_counter() - t0) * 1e3)
        forwards += len(bodies) + 16
        health = get(url + "/healthz")
        check(health["backend"] == "cuda", f"/healthz {health}")
        stats = get(url + "/stats")
        check(stats["classify"]["n"] == len(bodies) + 16, f"/stats {stats}")
        log(json.dumps({"server": "unbatched", "healthz": health,
                        "stats": stats,
                        "client_p50_ms": float(np.median(client_ms))}))
    finally:
        srv.shutdown()

    srv = InferenceServer(classifier=served, max_batch=4,
                          batch_window_ms=100.0)
    forwards += 1  # warm-up of the padded batch shape
    host, port = srv.start_background(port=0)
    url = f"http://{host}:{port}"
    try:
        barrier = threading.Barrier(len(bodies))
        results: list = [None] * len(bodies)

        def client(i):
            barrier.wait(timeout=30)
            results[i] = post(url + "/classify", bodies[i])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            check(not t.is_alive(), "batched client did not finish")
        for i, res in enumerate(results):
            check(res is not None and res[0] == 200,
                  f"batched /classify {res}")
            idx, probs = expected[i]
            got = np.asarray(res[1]["probs"])
            # padded batch of 4 against batch 1: other GEMM shapes, so
            # bf16 rounding differs (the bf16 tolerance; probs are rounded
            # to 4 decimals in the response)
            check(float(np.abs(got - probs).max()) <= TOL_PROBS_BF16,
                  f"batched probs {got} vs {probs}")
            if top2_margin(probs) > 2 * TOL_PROBS_BF16:
                check(res[1]["class"] == idx,
                      f"batched class {res[1]['class']} != {idx}")
        stats = get(url + "/stats")
        batching = stats["batching"]
        check(batching["requests"] == len(bodies), f"/stats {stats}")
        check(batching["max_batch_seen"] > 1, f"no coalescing: {stats}")
        forwards += batching["batches"]
        log(json.dumps({"server": "micro-batched", "stats": stats}))
    finally:
        srv.shutdown()
    return forwards


def phase_profile(clf, batch) -> None:
    """Where a bf16 forward's time goes: the device's busy share of the
    host's wall time, and the kernels by device time (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reps = 5
    for b in (1, 8):
        x = batch[:b]
        clf.infer_batch(x)
        # wall time without the profiler (each call ends in its D2H copy)
        t0 = time.perf_counter()
        for _ in range(reps):
            clf.infer_batch(x)
        wall_us = (time.perf_counter() - t0) / reps * 1e6
        # device time per kernel; the profiler's own start-up slows the
        # host, which is why the wall time above is taken without it
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                clf.infer_batch(x)
        per_name: dict[str, list] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                rec = per_name.setdefault(e.name, [0.0, 0])
                rec[0] += e.time_range.elapsed_us() / reps
                rec[1] += 1
        busy_us = sum(v[0] for v in per_name.values())
        top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:8]
        log(json.dumps({
            "profile": "StreamingClassifier.infer_batch bf16", "B": b,
            "wall_us_per_forward": wall_us,
            "device_busy_us_per_forward": busy_us,
            # None: the profiler saw no device time (not measured)
            "device_busy_share": busy_us / wall_us if busy_us else None,
            "kernels_per_forward": sum(v[1] for v in per_name.values())
            / reps,
            "top": [{"name": k[:80], "us": v[0], "calls": v[1] / reps}
                    for k, v in top],
        }))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"# phase 1: {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    built = build.build_all()
    log(f"# phase 2: built {sorted(built)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, info in built.items():
        log(f"## {name}: {info['seconds']:.2f} s\n{info['log'].strip()}")
    for name in build.kernel_names():
        build.load(name)

    cfg = PRESETS["vit_base_16_224"]
    log("# phase 3: kernels against their plain versions")
    attn = phase_kernel_checks(cfg)

    params = seeded_head(init_image_classifier(cfg, 6, seed=0),
                         cfg.embed_dim, 6, seed=1)
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)
              for _ in range(4)]
    batch = rng.integers(0, 256, (8, 224, 224, 3), dtype=np.uint8)
    bodies = [png_bytes(rng.integers(0, 256, shape, dtype=np.uint8))
              for shape in ((224, 224, 3), (180, 240, 3), (300, 200, 3),
                            (224, 224, 3))]

    encoder_attention.LAUNCHES = 0  # the main path starts here
    log("# phase 4: ViT-B/16@224 StreamingClassifier")
    direct, forwards = phase_model(cfg, params, images, batch)
    log("# phase 5: InferenceServer")
    forwards += phase_server(cfg, params, direct, bodies)
    launches = encoder_attention.LAUNCHES
    log(json.dumps({"launches": launches, "forwards": forwards,
                    "depth": cfg.depth}))
    check(launches > 0, "encoder_attention_fwd never launched")
    check(launches == cfg.depth * forwards,
          f"LAUNCHES {launches} != depth {cfg.depth} x {forwards} forwards")
    log("# phase 6: profile of the bf16 forward")
    phase_profile(direct, batch)

    print(json.dumps({"kernels": [{
        "name": "encoder_attention_fwd",
        "route": "cuda",
        "source": "arsvt_tpu_torch/csrc/encoder_attention_fwd.cu",
        "replaces": "arsvt_tpu/ops/pallas/flash_attention.py:533",
        "launches": launches,
        "max_abs_err": attn["max_abs_err"],
        "ms": attn["ms"],
        "plain_ms": attn["plain_ms"],
        "bound_ms": attn["bound_ms"],
        "bound_by": attn["bound_by"],
        "library_ms": attn["library_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
