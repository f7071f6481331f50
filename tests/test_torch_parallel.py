"""Data- and tensor-parallel training of the port (``arsvt_tpu_torch/
parallel/``) on spawned gloo processes on the CPU, against the port's
one-process step on the global batch and against the JAX package's step
on the conftest's virtual CPU mesh (``arsvt_tpu/parallel/mesh.py::
make_mesh(..., platform="cpu")``, as ``tests/test_distributed.py`` does).

The spawned ranks run the tiny models of ``parallel/dryrun.py``: a head_dim
64 classifier (the fused #1/#2 route; 2 heads, even on 2 model ranks) with
grad_accum 2, crop/flip and residual and attention dropout 0.1, and a
detector whose backbone and DETR head have 3 heads of 16 and odd MLP
widths (uneven on 2 model ranks), dropout 0.1, and box counts that differ
from image to image (so from rank to rank). Each world size is one spawn
of all its jobs (module fixtures), so the file starts 2 + 4 + 2 processes.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from optax import ScaleByAdamState

from arsvt_tpu.models import registry as jax_registry
from arsvt_tpu.models.vit import BackboneConfig as JaxBackboneConfig
from arsvt_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from arsvt_tpu.parallel.mesh import make_mesh as jax_make_mesh
from arsvt_tpu.parallel.sharding import shard_batch as jax_shard_batch
from arsvt_tpu.parallel.sharding import shard_params as jax_shard_params
from arsvt_tpu.train.config import TrainConfig as JaxTrainConfig
from arsvt_tpu.train.train_step import (
    make_classifier_step_fns as jax_make_step_fns,
)
from arsvt_tpu_torch.core.dtypes import named_leaves
from arsvt_tpu_torch.models.bridge import from_jax_params
from arsvt_tpu_torch.models.vit import BackboneConfig
from arsvt_tpu_torch.parallel import dryrun, multihost
from arsvt_tpu_torch.parallel.mesh import Mesh, MeshConfig, make_mesh
from arsvt_tpu_torch.parallel.sharding import (
    Replicated,
    gather_params,
    param_sharding_rules,
    shard_batch,
    shard_params,
)
from arsvt_tpu_torch.parallel.tensor_parallel import split_sizes
from arsvt_tpu_torch.train.train_step import num_heads_for

torch.set_num_threads(1)  # tier-1 runs several xdist workers

# the port's grid against its own one-process step: fp32 reduction order
# on the loss, the gradient norm and the first moment (the gradient),
# measured <= 9.6e-7; the update at dryrun.UPDATE_RTOL (sign flips of
# gradients within noise of zero, measured <= 7.7e-4)
RTOL = dryrun.LOSS_RTOL
# against JAX's mesh step: test_torch_train.py's limits of the one-device
# parity (loss and grad_norm 1e-5 relative; parameters 0.5 lr after the
# sign-like first Adam step)
RTOL_JAX = 1e-5
LR = 1e-4
JAX_PRESET = "vit_parallel_test_64_nodrop"
JAX_BACKBONE = {**dryrun.CLASSIFY_BACKBONE, "dropout": 0.0,
                "attn_dropout": 0.0}
JAX_CFG = dict(preset=JAX_PRESET, batch_size=8, grad_accum=2, bf16=False,
               augment="none", warmup_steps=0, fused_adamw=True)


@pytest.fixture(scope="module", autouse=True)
def _cpu_ranks():
    """The jobs' device is each rank's (``mesh.rank_device``: the card by
    default), so the spawned ranks and the in-process steps ask for the
    CPU."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ARSVT_PLATFORM", "cpu")
        yield


@pytest.fixture(autouse=True)
def _tiny_preset(monkeypatch):
    monkeypatch.setitem(jax_registry.PRESETS, JAX_PRESET,
                        JaxBackboneConfig(**JAX_BACKBONE))
    with jax.default_matmul_precision("highest"):
        yield


def _jax_start(tmp_path):
    """JAX's init with a seeded random head, and its port tree saved for
    the spawned ranks."""
    jinit, _, _ = jax_make_step_fns(JaxTrainConfig(**JAX_CFG))
    jstate = jinit(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    jstate["params"]["classifier"]["head"] = {
        "kernel": jnp.asarray(rng.standard_normal((128, 6)) * 0.3,
                              jnp.float32),
        "bias": jnp.asarray(rng.standard_normal(6) * 0.1, jnp.float32)}
    tree = jax.tree_util.tree_map(np.asarray, jstate["params"])
    port = from_jax_params(tree, BackboneConfig(**JAX_BACKBONE))
    path = str(tmp_path / "jax_init.pt")
    torch.save(port, path)
    return tree, path


def _jax_job(data, model, params):
    """The classifier without dropout or augmentation (JAX's draws cannot
    be replayed through a grid), from JAX's init: batch 8 as 2 x 4."""
    return dryrun.classify_job(
        data, model, name="jax", seed=5, image_size=32, batch=8,
        backbone=JAX_BACKBONE, params=params, cfg=dict(JAX_CFG))


def _jax_step(tree, data, model):
    """JAX's step of `_jax_job` on a data x model virtual CPU mesh."""
    devices = jax.devices("cpu")[:data * model]
    mesh = jax_make_mesh(JaxMeshConfig(data=data, model=model),
                         devices=devices, platform="cpu")
    jinit, jstep, _ = jax_make_step_fns(JaxTrainConfig(**JAX_CFG), mesh)
    jstate = jinit(jax.random.PRNGKey(0))
    jstate["params"] = jax_shard_params(
        jax.tree_util.tree_map(jnp.asarray, tree), mesh)
    batch = dryrun.global_batch(_jax_job(data, model, None), 0)
    jstate, m = jstep(jstate, jax_shard_batch(batch, mesh),
                      jax.random.PRNGKey(1))
    adam, = [s for s in jax.tree_util.tree_leaves(
        jstate["opt_state"], is_leaf=lambda s: isinstance(s, ScaleByAdamState))
        if isinstance(s, ScaleByAdamState)]
    return ({k: float(v) for k, v in m.items()},
            jax.tree_util.tree_map(np.asarray, jstate["params"]),
            jax.tree_util.tree_map(np.asarray, adam.mu))


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_registry.PRESETS, JAX_PRESET,
                   JaxBackboneConfig(**JAX_BACKBONE))
        with jax.default_matmul_precision("highest"):
            return _jax_start(tmp_path_factory.mktemp("jax"))


GRID2 = [(2, 1), (1, 2)]


@pytest.fixture(scope="module")
def two_ranks(jax_init):
    """Every world-size-2 job in one spawn: {(name, data, model): result}."""
    jobs = []
    for data, model in GRID2:
        jobs += [dryrun.classify_job(data, model),
                 dryrun.detect_job(data, model),
                 _jax_job(data, model, jax_init[1])]
    return {(j["name"], j["data"], j["model"]): (j, r)
            for j, r in zip(jobs, dryrun.run_grid(jobs))}


@pytest.fixture(scope="module")
def four_ranks(jax_init):
    jobs = [dryrun.classify_job(2, 2), dryrun.detect_job(2, 2),
            _jax_job(2, 2, jax_init[1])]
    return {(j["name"], j["data"], j["model"]): (j, r)
            for j, r in zip(jobs, dryrun.run_grid(jobs))}


def _grid_result(two_ranks, four_ranks, key):
    return (four_ranks if key[1] * key[2] == 4 else two_ranks)[key]


@pytest.mark.parametrize("task", ["classify", "detect"])
@pytest.mark.parametrize("grid", [(2, 1), (1, 2), (2, 2)],
                         ids=["dp2", "tp2", "dp2xtp2"])
def test_grid_step_equals_the_one_process_step(task, grid, two_ranks,
                                               four_ranks):
    """A step on the grid, dropout 0.1 (residual, positional, attention)
    on, equals the one-process step on the global batch: loss, gradient
    norm and the update (the classifier with grad_accum 2)."""
    job, got = _grid_result(two_ranks, four_ranks, (task, *grid))
    want = dryrun.run_steps(job)
    errs = dryrun.compare(got, want)
    assert max(errs["loss"], errs["grad_norm"], errs["moment"]) <= RTOL, errs
    assert errs["update"] <= dryrun.UPDATE_RTOL, errs
    # the launches would be each rank's; the CPU runs the plain versions
    assert got["counts"] == want["counts"]


@pytest.mark.parametrize("grid", [(2, 1), (1, 2), (2, 2)],
                         ids=["dp2", "tp2", "dp2xtp2"])
def test_grid_step_equals_jax_mesh_step(grid, jax_init, two_ranks,
                                        four_ranks):
    """The classifier (grad_accum 2) on the port's grid against JAX's step
    on a virtual CPU mesh of the same shape, from the same weights and
    batch: loss and gradient norm 1e-5 relative, the first Adam moment
    (after one step, 0.1 x the clipped gradient) leaf by leaf at 1e-5 of
    the leaf's largest element, parameters 0.5 lr (a first Adam step moves
    each element by about lr x the sign of its gradient)."""
    tree, _ = jax_init
    _, got = _grid_result(two_ranks, four_ranks, ("jax", *grid))
    jm, jparams, jmu = _jax_step(tree, *grid)
    for key in ("loss", "grad_norm"):
        assert abs(got["metrics"][0][key] - jm[key]) <= RTOL_JAX * abs(
            jm[key]), (key, got["metrics"][0][key], jm[key])
    cfg = BackboneConfig(**JAX_BACKBONE)
    for (name, a), (_, b) in zip(named_leaves(got["mu"]),
                                 named_leaves(from_jax_params(jmu, cfg))):
        scale = float(np.abs(b.numpy()).max())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL_JAX,
                                   atol=RTOL_JAX * scale, err_msg=name)
    want = from_jax_params(jparams, cfg)
    for (name, a), (_, b) in zip(named_leaves(got["after"]),
                                 named_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=0.5 * LR,
                                   err_msg=name)


def test_detector_normalisers_are_global(two_ranks):
    """Unequal box counts on the two DP ranks: the box-count and CE-weight
    normalisers and the triplet batch are the global microbatch's, so
    every loss part equals the one-process step's (with local normalisers
    the parts differ by the ranks' box shares)."""
    job, got = two_ranks[("detect", 2, 1)]
    batch = dryrun.global_batch(job, 0)
    per_rank = batch["mask"].reshape(2, -1, batch["mask"].shape[-1]).sum(
        axis=(1, 2))
    assert per_rank[0] != per_rank[1]
    want = dryrun.run_steps(job)
    for key, value in want["metrics"][0].items():
        assert got["metrics"][0][key] == pytest.approx(value, rel=RTOL,
                                                       abs=1e-7), key


def test_resume_on_another_world_size(tmp_path):
    """Two steps on a TP = 2 grid (the checkpoint holds the gathered JAX
    layout), then one process resumes to step 4: the same run as four
    steps in one process."""
    ckpt = str(tmp_path / "ck")
    fit = dict(kind="fit", checkpoint_dir=ckpt, checkpoint_every=2,
               total_steps=4)
    first = dryrun.run_grid(dryrun.classify_job(1, 2, total=2, **fit))
    assert [r["step"] for r in first["metrics"]] == [1, 2]
    blob = torch.load(os.path.join(ckpt, "step_000000002.pt"),
                      weights_only=True)
    for (name, a), (_, b) in zip(named_leaves(blob["params"]),
                                 named_leaves(first["after"])):
        assert torch.equal(a, b), name
    resumed = dryrun.run_fit(dryrun.classify_job(1, 1, total=4, resume=True,
                                                 **fit))
    assert resumed["start"] == 2
    whole = dryrun.run_fit(dryrun.classify_job(
        1, 1, total=4, **{**fit, "checkpoint_dir": str(tmp_path / "w")}))
    rows = first["metrics"] + resumed["metrics"]
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    for got, want in zip(rows, whole["metrics"]):
        for key in ("loss", "grad_norm"):
            assert got[key] == pytest.approx(want[key], rel=1e-5), key
    for (name, a), (_, b) in zip(named_leaves(resumed["after"]),
                                 named_leaves(whole["after"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2 * LR,
                                   err_msg=name)


def _eval_job(task, directory):
    make = dryrun.classify_job if task == "classify" else dryrun.detect_job
    return make(2, 1, kind="fit", total=1, checkpoint_every=10**9,
                eval_every=1, eval_batches=2, checkpoint_dir=directory)


@pytest.fixture(scope="module")
def evaluations(tmp_path_factory):
    """Both tasks' step-then-evaluate runs on two DP ranks, one spawn."""
    tmp = tmp_path_factory.mktemp("evals")
    jobs = [_eval_job(task, str(tmp / task)) for task in ("classify",
                                                          "detect")]
    return dict(zip(("classify", "detect"), dryrun.run_grid(jobs)))


@pytest.mark.parametrize("task", ["classify", "detect"])
def test_multi_process_evaluation_equals_one_process(task, evaluations,
                                                     tmp_path):
    """`Trainer.evaluate` on two DP ranks (each fed its rows; the ranks
    agree per batch that everyone still has one; the detector's outputs
    gathered for AP) gives the one-process evaluation of the same
    batches, after one step."""
    got = evaluations[task]
    want = dryrun.run_fit(_eval_job(task, str(tmp_path / "one")))
    assert len(got["evals"]) == len(want["evals"]) == 1
    g, w = got["evals"][0], want["evals"][0]
    assert set(g) == set(w) and "loss" in w
    if task == "detect":
        assert "mAP" in w
    for key, value in w.items():
        assert g[key] == pytest.approx(value, rel=1e-5, abs=1e-6), key


def test_shards_are_whole_heads_and_gather_to_the_jax_layout():
    """qkv is cut by heads ([q|k|v] of a rank's heads), the cross
    attention's kv likewise, proj by head rows, the MLP by contiguous
    units; counts split as numpy.array_split (3 heads: 2 and 1); the
    rules are JAX's; gathering gives the full tree back."""
    cfg = dryrun.train_config(dryrun.detect_job(1, 2))
    from arsvt_tpu_torch.models.detector import init_detector
    from arsvt_tpu_torch.train.config import resolve_detector

    full = init_detector(resolve_detector(cfg))
    heads = num_heads_for(cfg)
    assert split_sizes(25, 2) == [13, 12]
    assert split_sizes(99, 2) == [50, 49]
    shards = [shard_params(full, Mesh(1, 2, r, torch.device("cpu")), heads)
              for r in range(2)]
    qkv = full["backbone"]["blocks"][0]["attn"]["qkv"]["kernel"]  # (48, 144)
    got = shards[1]["backbone"]["blocks"][0]["attn"]["qkv"]["kernel"]
    cols = [c for part in range(3) for c in range(part * 48 + 32,
                                                  part * 48 + 48)]
    assert torch.equal(got, qkv[:, cols])
    kv = shards[0]["detr"]["blocks"][0]["cross_attn"]["kv"]["kernel"]
    assert kv.shape == (48, 64)  # 2 heads of 16, k and v
    proj = shards[1]["detr"]["blocks"][1]["self_attn"]["proj"]["kernel"]
    assert torch.equal(proj, full["detr"]["blocks"][1]["self_attn"]["proj"]
                       ["kernel"][32:])
    fc1 = [s["backbone"]["blocks"][0]["mlp"]["fc1"]["kernel"].shape[1]
           for s in shards]
    assert fc1 == [50, 49]
    rules = param_sharding_rules(full, Mesh(1, 2, 0, torch.device("cpu")))
    assert rules["detr"]["blocks"][0]["cross_attn"]["proj"]["kernel"] == "row"
    assert rules["backbone"]["blocks"][0]["attn"]["proj"]["bias"] is None
    assert rules["detr"]["class_head"]["kernel"] is None
    # one process: a 1x1 mesh holds everything, and gathering is identity
    one = Mesh(1, 1, 0, torch.device("cpu"))
    assert gather_params(full, one, heads) is full


def test_batch_slices_and_a_remainder_is_replicated():
    batch = {"image": np.arange(12).reshape(6, 2), "label": np.arange(6)}
    rank1 = shard_batch(batch, Mesh(2, 1, 1, torch.device("cpu")))
    assert rank1["label"].tolist() == [3, 4, 5]
    # model ranks of one data rank take the same rows
    assert shard_batch(batch, Mesh(2, 2, 3, torch.device("cpu")))[
        "label"].tolist() == [3, 4, 5]
    odd = shard_batch({"label": np.arange(5)},
                      Mesh(2, 1, 1, torch.device("cpu")))
    assert isinstance(odd, Replicated) and odd["label"].tolist() == list(
        range(5))
    # one process: global_batch_from_local is shard_batch
    assert multihost.global_batch_from_local(
        batch, Mesh(1, 1, 0, torch.device("cpu"))) is batch


def test_mesh_config_and_local_batch_messages():
    assert MeshConfig().resolve(8) == (8, 1)
    assert MeshConfig(model=2).resolve(8) == (4, 2)
    with pytest.raises(ValueError, match="mesh 3x2 does not cover 8"):
        MeshConfig(data=3, model=2).resolve(8)
    mesh = Mesh(2, 2, 0, torch.device("cpu"))
    assert multihost.local_batch(16, mesh) == 8
    with pytest.raises(ValueError, match="must divide over 2 processes"):
        multihost.local_batch(15, mesh)
    assert multihost.data_shard(Mesh(2, 2, 3, torch.device("cpu"))) == (1, 2)


def test_initialize_multihost_with_a_group_already_initialised(monkeypatch):
    """A group the caller initialised is success, not failure; without one
    and without the coordinator variables the process is single."""
    for name in ("ARSVT_COORDINATOR_ADDRESS", "ARSVT_NUM_PROCESSES",
                 "ARSVT_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(multihost, "_INITIALIZED", False)
    assert not dist.is_initialized()
    assert multihost.initialize_multihost() is False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{dryrun.free_port()}", world_size=1, rank=0)
    try:
        assert multihost.initialize_multihost() is False  # a world of one
        assert multihost._INITIALIZED
        assert multihost.process_index() == 0
        assert multihost.process_count() == 1
        mesh = make_mesh(MeshConfig(data=1, model=1), device="cpu")
        assert mesh.data_group is not None and mesh.model_shard() is None
        multihost.host_barrier("one")  # a no-op for one process
    finally:
        dist.destroy_process_group()


def test_dryrun_runs_both_tasks_on_a_2x2_grid():
    """`dryrun_multichip(4)` runs the classifier with grad_accum 2 and the
    detector on a 2 x 2 grid."""
    jobs = dryrun.default_jobs(4)
    assert [(j["name"], j["data"], j["model"]) for j in jobs] == [
        ("classify", 2, 2), ("detect", 2, 2)]
    assert jobs[0]["cfg"]["grad_accum"] == 2
    assert dataclasses.replace(
        dryrun.train_config(jobs[1]), total_steps=1).task == "detect"


def test_a_job_runs_on_the_card_unless_the_cpu_is_asked_for(monkeypatch):
    """A job without a ``device`` takes its rank's: the CPU here only
    because ``ARSVT_PLATFORM=cpu`` asks for it; without it, the card, or
    an error where there is none."""
    job = dryrun.classify_job(2, 1)
    assert job["device"] is None
    assert dryrun.job_device(job, rank=1) == torch.device("cpu")
    assert dryrun.job_device({**job, "device": "cpu"}) == torch.device("cpu")
    monkeypatch.delenv("ARSVT_PLATFORM")
    if torch.cuda.is_available():
        assert dryrun.job_device(job).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.job_device(job)


def test_the_training_cli_on_two_processes(tmp_path):
    """``python -m arsvt_tpu_torch.train.cli`` with ARSVT_MULTIHOST=1 and
    the three coordinator variables on two gloo processes (a 2 x 1 grid):
    each feeds half the batch, rank 0 alone writes metrics.jsonl and the
    checkpoint, which holds the whole tree."""
    import subprocess
    import sys

    repo = str(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    port = dryrun.free_port()
    procs = []
    for rank in range(2):
        workdir = tmp_path / f"rank{rank}"
        workdir.mkdir()
        env = {**os.environ, "ARSVT_MULTIHOST": "1",
               "ARSVT_PLATFORM": "cpu",
               "ARSVT_COORDINATOR_ADDRESS": f"localhost:{port}",
               "ARSVT_NUM_PROCESSES": "2", "ARSVT_PROCESS_ID": str(rank),
               "PYTHONPATH": repo, "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "arsvt_tpu_torch.train.cli",
             "--train-preset", "smoke", "--mesh-data", "2", "--steps", "2",
             "--batch-size", "8", "--checkpoint-every", "2",
             "--checkpoint-dir", str(tmp_path / "ck"), "--log-every", "1"],
            cwd=workdir, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    assert "multihost: process 0/2" in logs[0]
    assert (tmp_path / "rank0" / "metrics.jsonl").is_file()
    assert not (tmp_path / "rank1" / "metrics.jsonl").exists()
    blob = torch.load(tmp_path / "ck" / "step_000000002.pt",
                      weights_only=True)
    assert blob["step"] == 2
    qkv = blob["params"]["backbone"]["blocks"][0]["attn"]["qkv"]["kernel"]
    assert tuple(qkv.shape) == (32, 96)  # vit_test_8_32, whole
