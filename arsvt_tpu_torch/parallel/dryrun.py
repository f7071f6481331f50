"""A multi-process dry run of data- and tensor-parallel training
(the port's ``dryrun_multichip``; JAX's lives in ``__graft_entry__.py``).

    python -m arsvt_tpu_torch.parallel.dryrun [N]

spawns N gloo processes (N = 4 by default: a 2 x 2 grid of data and
model ranks), each on its rank's card (``cuda:rank % cards``; gloo sums
CUDA tensors through the host) or, with ``ARSVT_PLATFORM=cpu``, on the
CPU, and runs, on each grid, the classifier with
grad_accum 2 and the detector, dropout on, through
``make_classifier_step_fns`` / ``make_detector_step_fns`` with the
rank's mesh. Every step's metrics and the gathered parameters are held
against the one-process step on the global batch. It prints one JSON
line per case and exits non-zero if any case is off its limit.

`run_grid` is the harness the CPU tests and ``chip_smoke.py`` share: a
job (a dict: task, config overrides, grid, batch, steps, seed, device)
goes to `world` spawned ranks, each writing its results to a directory,
and `run_steps` runs the same job in this process, with or without a
mesh.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from arsvt_tpu_torch.core.dtypes import named_leaves

# fp32 reduction-order noise of a step on the global batch, relative: the
# loss and the gradient norm of every step and the first Adam moment (the
# gradient) of a one-step run, measured <= 9.6e-7 on the CPU. Adam's first
# update is lr * g / (|g| + 1e-8), so an element whose gradient lies within
# that noise of zero (the key columns of a qkv or kv bias are exactly 0 in
# exact arithmetic) moves by up to 2 lr the other way: the update's
# relative L2 is held looser, measured <= 7.7e-4 (<= 1.5e-4 without the
# q/k/v biases).
LOSS_RTOL = 1e-6
UPDATE_RTOL = 2e-3


# the kernels' launch counters: (name, module under arsvt_tpu_torch, attribute)
KERNEL_COUNTERS = (
    ("encoder_attention_fwd", "ops.encoder_attention", "LAUNCHES"),
    ("encoder_attention_bwd", "ops.encoder_attention", "BWD_LAUNCHES"),
    ("flash_attention_fwd", "ops.flash_attention", "LAUNCHES"),
    ("flash_attention_bwd", "ops.flash_attention", "LAUNCHES_BWD"),
    ("fused_adamw", "ops.fused_adamw", "LAUNCHES"),
    ("fused_mlp_fwd", "ops.fused_mlp", "LAUNCHES"),
    ("fused_mlp_bwd", "ops.fused_mlp", "BWD_LAUNCHES"),
    ("dropout_apply", "ops.dropout", "APPLY_LAUNCHES"),
    ("lap", "objectives.matcher", "LAUNCHES"),
    ("lap_solve", "objectives.matcher", "SOLVE_LAUNCHES"),
    ("layer_norm_fwd", "ops.layernorm", "LAUNCHES"),
    ("layer_norm_bwd", "ops.layernorm", "BWD_LAUNCHES"),
    ("gelu_tanh_fwd", "ops.mlp", "LAUNCHES"),
    ("gelu_tanh_bwd", "ops.mlp", "BWD_LAUNCHES"),
)


def kernel_counts(zero: bool = False) -> dict:
    """{kernel: launches} of this process (set to 0 with `zero`)."""
    import importlib

    out = {}
    for name, module, attr in KERNEL_COUNTERS:
        mod = importlib.import_module(f"arsvt_tpu_torch.{module}")
        out[name] = getattr(mod, attr)
        if zero:
            setattr(mod, attr, 0)
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def train_config(job: dict):
    """The job's TrainConfig; a job's own model preset ("backbone", and
    "detr" for a detector: config kwargs) is registered under its
    ``cfg["preset"]`` first (a spawned rank starts from the registry as
    imported)."""
    from arsvt_tpu_torch.models import registry
    from arsvt_tpu_torch.models.detector import DetectorConfig
    from arsvt_tpu_torch.models.heads import DetrHeadConfig
    from arsvt_tpu_torch.models.vit import BackboneConfig
    from arsvt_tpu_torch.train.config import TRAIN_PRESETS

    if "backbone" in job:
        name, bb = job["cfg"]["preset"], BackboneConfig(**job["backbone"])
        if "detr" in job:
            registry.DETECTOR_PRESETS[name] = DetectorConfig(
                backbone=bb, head=DetrHeadConfig(**job["detr"]))
        else:
            registry.PRESETS[name] = bb
    base = TRAIN_PRESETS[job.get("train_preset", "smoke")]
    return base.with_overrides(**job["cfg"])


def global_batch(job: dict, step: int) -> dict:
    """The job's global batch of `step`, from its seed (numpy): uint8
    images; for the detector boxes whose counts differ per image, so the
    ranks' box counts differ."""
    cfg = train_config(job)
    rng = np.random.default_rng([job["seed"], step])
    b, size = job["batch"], job["image_size"]
    images = rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)
    if cfg.task != "detect":
        return {"image": images,
                "label": rng.integers(0, cfg.num_classes, b).astype(np.int32)}
    m = cfg.max_objects
    xy = rng.uniform(0.05, 0.5, (b, m, 2))
    wh = rng.uniform(0.1, 0.45, (b, m, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    counts = 1 + (np.arange(b) * 5 + step) % m
    mask = np.arange(m)[None, :] < counts[:, None]
    return {"image": images, "boxes": boxes,
            "labels": rng.integers(0, cfg.num_classes, (b, m)).astype(
                np.int32),
            "mask": mask}


def job_device(job: dict, rank: int = 0) -> torch.device:
    """The job's ``device``, else the rank's (``mesh.rank_device``: the
    card unless ``ARSVT_PLATFORM=cpu``; it raises without one)."""
    from arsvt_tpu_torch.parallel.mesh import rank_device

    if job.get("device"):
        return torch.device(job["device"])
    return rank_device(rank=rank)


def _step_fns(job: dict, mesh):
    cfg = train_config(job)
    device = mesh.device if mesh is not None else job_device(job)
    if cfg.task == "detect":
        from arsvt_tpu_torch.train.detect_step import make_detector_step_fns

        return make_detector_step_fns(cfg, device, mesh=mesh)
    from arsvt_tpu_torch.train.train_step import make_classifier_step_fns

    return make_classifier_step_fns(cfg, device, mesh=mesh)


def _full_params(job: dict, init_fn):
    """The job's starting parameters: its file (a full tree), else the
    seeded init with, for a classifier, a seeded random head (the zero
    head of the init sends no gradient into the backbone)."""
    if job.get("params"):
        return torch.load(job["params"], weights_only=True)
    params = init_fn()["params"]
    _seed_head(params, job["seed"])
    return params


def run_steps(job: dict, mesh=None) -> dict:
    """Run the job's steps with `mesh` (None: one process on the global
    batch). Returns {"metrics": [per-step dict of floats], "before" and
    "after": the full parameter trees (gathered under a mesh), "mu": the
    full first Adam moment (after one step, the clipped gradient times
    1 - b1), "counts":
    the kernels' launches in the steps, "timed": host ms and, on the
    card, CUDA-event ms of each of ``job["timed"]`` more steps}."""
    from arsvt_tpu_torch.parallel.sharding import (
        gather_params,
        shard_batch,
        shard_params,
    )
    from arsvt_tpu_torch.train.optim import init_opt_state
    from arsvt_tpu_torch.train.train_step import num_heads_for

    cfg = train_config(job)
    init_fn, train_step, _ = _step_fns(job, mesh)
    full = _full_params(job, lambda: _step_fns(job, None)[0]())
    heads = num_heads_for(cfg)
    device = mesh.device if mesh is not None else job_device(job)
    params = shard_params(full, mesh or _one(device), heads)
    state = {"params": params, "opt_state": init_opt_state(params),
             "step": 0}
    before = _host(full)

    def batch_of(step):
        batch = global_batch(job, step)
        return batch if mesh is None else shard_batch(batch, mesh)

    metrics = []
    kernel_counts(zero=True)
    for step in range(job["steps"]):
        state, m = train_step(state, batch_of(step))
        metrics.append({k: float(v) for k, v in m.items()})
    counts = kernel_counts()
    after, mu = state["params"], state["opt_state"]["mu"]
    if mesh is not None:
        after = gather_params(after, mesh, heads)
        mu = gather_params(mu, mesh, heads)
    after, mu = _host(after), _host(mu)
    timed = []
    for step in range(job.get("timed", 0)):
        timed.append(_timed_step(train_step, state, batch_of(step), device))
    return {"metrics": metrics, "before": before, "after": after, "mu": mu,
            "counts": counts, "timed": timed}


def _timed_step(train_step, state, batch, device) -> dict:
    """One step's host ms (to its end on the card) and CUDA-event ms."""
    import time

    if device.type != "cuda":
        t0 = time.perf_counter()
        train_step(state, batch)
        return {"host_ms": (time.perf_counter() - t0) * 1e3}
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    _, m = train_step(state, batch)
    end.record()
    float(m["loss"])
    torch.cuda.synchronize(device)
    return {"host_ms": (time.perf_counter() - t0) * 1e3,
            "event_ms": start.elapsed_time(end)}


def _seed_head(params: dict, seed: int) -> None:
    """A classifier's heads (zero at init, replicated on every rank) set
    to seeded random values in place."""
    if "classifier" not in params:
        return
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for head in params["classifier"].values():
            for k, scale in (("kernel", 0.3), ("bias", 0.1)):
                head[k].copy_(scale * torch.randn(head[k].shape,
                                                  generator=gen))


def run_fit(job: dict, mesh=None) -> dict:
    """The job through `Trainer.fit` (the "fit" kind): from step 0, or
    resumed from ``job["checkpoint_dir"]`` with ``job["resume"]``, to
    ``job["total"]`` steps of a run of ``job["total_steps"]`` (the
    schedule's length), checkpoints every ``job["checkpoint_every"]``;
    each rank is fed its slice of the job's global batches, and with
    ``job["eval_batches"]`` an evaluation of that many batches (their
    ``valid`` rows 1) after every ``job["eval_every"]`` steps. Returns
    {"metrics": [per-step train rows], "evals": [eval rows], "after": the
    full parameters}."""
    from arsvt_tpu_torch.parallel.sharding import gather_params, shard_batch
    from arsvt_tpu_torch.train.trainer import Trainer
    from arsvt_tpu_torch.train.train_step import num_heads_for
    from arsvt_tpu_torch.utils.logging import MetricLogger

    cfg = train_config(job).with_overrides(
        checkpoint_dir=job["checkpoint_dir"],
        checkpoint_every=job["checkpoint_every"],
        total_steps=job.get("total_steps", job["total"]),
        log_every=1, eval_every=job.get("eval_every", 10**9))
    rows, evals = [], []

    class Rows(MetricLogger):
        def log(self, step, metrics, *, prefix=""):
            if prefix == "val/":
                evals.append({k: v for k, v in metrics.items()
                              if isinstance(v, float)})
            else:
                rows.append({"step": step, "loss": float(metrics["loss"]),
                             "grad_norm": float(metrics["grad_norm"])})

    trainer = Trainer(cfg, mesh=mesh, logger=Rows(quiet=True),
                      device=mesh.device if mesh is not None
                      else job_device(job))
    if job.get("resume"):
        start = trainer.maybe_resume()
    else:
        trainer.init_state()
        _seed_head(trainer.state["params"], job["seed"])
        start = 0

    def batches():
        for step in range(start, job["total"]):
            batch = global_batch(job, step)
            yield batch if mesh is None else shard_batch(batch, mesh)

    def eval_batches():
        for i in range(job.get("eval_batches", 0)):
            batch = global_batch(job, 1000 + i)
            batch["valid"] = np.ones(job["batch"], np.int32)
            yield batch if mesh is None else shard_batch(batch, mesh)

    trainer.fit(batches(), steps=job["total"],
                eval_batches_fn=eval_batches if job.get("eval_batches")
                else None)
    after = trainer.state["params"]
    if mesh is not None:
        after = gather_params(after, mesh, num_heads_for(cfg))
    return {"metrics": rows, "evals": evals, "after": _host(after),
            "start": start}


def _one(device):
    from arsvt_tpu_torch.parallel.mesh import Mesh

    return Mesh(1, 1, 0, device)


def _host(tree):
    from arsvt_tpu_torch.core.dtypes import tree_map

    return tree_map(lambda t: t.detach().float().cpu().clone(), tree)


def worker(rank: int, world: int, port: int, jobs: list,
           out_dir: str) -> None:
    """One rank of `run_grid`: a gloo group over localhost (on CUDA
    tensors too: gloo sums them through the host), each job's mesh and
    steps in turn; rank 0 saves the results."""
    torch.set_num_threads(1)
    from arsvt_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    device = job_device(jobs[0], rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        outs = []
        for job in jobs:
            mesh = make_mesh(MeshConfig(data=job["data"],
                                        model=job["model"]), device=device)
            run = run_fit if job.get("kind") == "fit" else run_steps
            outs.append(run(job, mesh))
        if rank == 0:
            torch.save(outs, os.path.join(out_dir, "rank0.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_grid(job, timeout: float = 600.0):
    """The job (or a list of jobs of one world size, run in turn) on data x
    model ranks, each a process of this module (``--worker``) on a gloo
    group; rank 0's results (a list for a list). Every process is waited
    for, or killed at `timeout` seconds."""
    jobs = job if isinstance(job, list) else [job]
    world = jobs[0]["data"] * jobs[0]["model"]
    if any(j["data"] * j["model"] != world for j in jobs):
        raise ValueError("the jobs of one run_grid need one world size")
    root = str(Path(__file__).resolve().parents[2])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    port = free_port()
    with tempfile.TemporaryDirectory() as out_dir:
        spec = os.path.join(out_dir, "job.json")
        with open(spec, "w") as f:
            json.dump(jobs, f)
        procs = [subprocess.Popen(
            [sys.executable, "-m", "arsvt_tpu_torch.parallel.dryrun",
             "--worker", str(r), str(world), str(port), spec, out_dir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
        logs = []
        try:
            for proc in procs:
                logs.append(proc.communicate(timeout=timeout)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        failed = [(r, p.returncode) for r, p in enumerate(procs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError(f"ranks {failed} failed:\n" + "\n".join(
                log[-3000:] for log in logs))
        outs = torch.load(os.path.join(out_dir, "rank0.pt"),
                          weights_only=False)
        return outs if isinstance(job, list) else outs[0]


def rel_l2(a, b) -> float:
    a, b = (np.concatenate([np.asarray(x, np.float64).ravel() for x in t])
            for t in (a, b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def leaves(tree) -> list:
    return [t.numpy() for _, t in named_leaves(tree)]


def updates(result) -> list:
    return [a - b for a, b in zip(leaves(result["after"]),
                                  leaves(result["before"]))]


def _key_bias(name: str) -> bool:
    """A packed qkv or kv bias's key columns have a gradient of exactly 0
    in exact arithmetic (softmax ignores a shift of every key's score), so
    what a run computes there is summation noise."""
    return name.endswith(("/qkv/bias", "/kv/bias"))


def compare(got: dict, want: dict) -> dict:
    """Relative errors of a grid's run against the one-process run: the
    loss and gradient norm of every step (the largest); the first Adam
    moment (relative L2: after one step, the gradient); the update of the
    parameters (relative L2), all of it and without the q/k/v biases."""
    def worst(key):
        return max(abs(g[key] - w[key]) / max(abs(w[key]), 1e-30)
                   for g, w in zip(got["metrics"], want["metrics"]))

    def kept(result, tree):
        return [t.numpy() for name, t in named_leaves(result[tree])
                if not _key_bias(name)]

    def upd(result):
        return [a - b for a, b in zip(kept(result, "after"),
                                      kept(result, "before"))]

    return {"loss": worst("loss"), "grad_norm": worst("grad_norm"),
            "moment": rel_l2(leaves(got["mu"]), leaves(want["mu"])),
            "update": rel_l2(updates(got), updates(want)),
            "update_no_qkv_bias": rel_l2(upd(got), upd(want))}


# tiny models of the two attention routes: head_dim 64 (the fused
# qkv-proj -> #1/#2 -> out-proj Function) with an even split, and head_dim
# 16 (#3/#4) with 3 heads and an odd MLP width, uneven on 2 model ranks
CLASSIFY_BACKBONE = dict(image_size=32, patch_size=8, embed_dim=128, depth=2,
                         num_heads=2, mlp_dim=256, dropout=0.1,
                         attn_dropout=0.1)
DETECT_BACKBONE = dict(image_size=32, patch_size=8, embed_dim=48, depth=2,
                       num_heads=3, mlp_dim=99, dropout=0.1,
                       attn_dropout=0.1, distilled=True)
DETECT_HEAD = dict(num_classes=6, num_queries=5, depth=2, num_heads=3,
                   ffn_dim=75, dropout=0.1, attn_dropout=0.1)


def classify_job(data: int, model: int, **over) -> dict:
    """The classifier case: grad_accum 2, crop/flip, mixup 0.2 (it mixes
    rows of other ranks), dropout 0.1; no warm-up, so the first step's
    update is the full learning rate's (a warm-up from 0 would make it
    0)."""
    return dict(dict(
        name="classify", data=data, model=model, seed=3, steps=1,
        device=None, image_size=40, batch=4 * data,
        backbone=CLASSIFY_BACKBONE,
        cfg=dict(preset="vit_parallel_test_64", batch_size=4 * data,
                 grad_accum=2, bf16=False, augment="crop_flip", canvas=40,
                 mixup_alpha=0.2, warmup_steps=0)), **over)


def detect_job(data: int, model: int, **over) -> dict:
    """The detector case: unequal box counts per image, dropout 0.1."""
    return dict(dict(
        name="detect", data=data, model=model, seed=4, steps=1,
        device=None, image_size=32, batch=2 * data,
        backbone=DETECT_BACKBONE, detr=DETECT_HEAD,
        cfg=dict(preset="detector_parallel_test_3h", task="detect",
                 batch_size=2 * data, bf16=False, augment="none",
                 max_objects=4, warmup_steps=0)), **over)


def default_jobs(n: int) -> list[dict]:
    """The dry run's cases on n processes: (data, model) = (n/2, 2) when
    n is even, else (n, 1)."""
    data, model = (n // 2, 2) if n % 2 == 0 and n > 1 else (n, 1)
    return [classify_job(data, model), detect_job(data, model)]


def dryrun_multichip(n: int = 4) -> list[dict]:
    """Each default job on n gloo processes against one process; a list
    of {"name", "grid", "loss", "update", "ok"}."""
    out = []
    for job in default_jobs(n):
        want = run_steps(job)
        got = run_grid(job)
        errs = compare(got, want)
        out.append({"name": job["name"],
                    "grid": [job["data"], job["model"]], **errs,
                    "ok": max(errs["loss"], errs["grad_norm"],
                              errs["moment"]) <= LOSS_RTOL
                    and errs["update"] <= UPDATE_RTOL})
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--worker":
        rank, world, port, spec, out_dir = argv[1:6]
        with open(spec) as f:
            jobs = json.load(f)
        worker(int(rank), int(world), int(port), jobs, out_dir)
        return 0
    n = int(argv[0]) if argv else 4
    torch.set_num_threads(1)
    results = dryrun_multichip(n)
    for r in results:
        print(json.dumps(r))
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
