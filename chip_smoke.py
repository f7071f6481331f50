#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training, detector-serving,
detector-training and opt-in training paths, its training entry point,
the ViT-L/16@384 recipe, DeiT distillation from an imported teacher,
data- and tensor-parallel training and every other preset of the
registry, on one NVIDIA card.

    python3 chip_smoke.py             # every phase
    python3 chip_smoke.py --kernels   # phases 1-3 only (build and check)
    python3 chip_smoke.py --disk      # phases 1, 2 and 12 (no kernel line)
    python3 chip_smoke.py --int8      # phases 1, 2, 12 and 13 (no kernel line)
    python3 chip_smoke.py --vit-large # phases 1, 2 and 14 (no kernel line)
    python3 chip_smoke.py --distill   # phases 1, 2 and 15 (no kernel line)
    python3 chip_smoke.py --parallel  # phases 1, 2 and 16 (no kernel line)
    python3 chip_smoke.py --presets   # phases 1, 2, 3(d)'s timing and 17
        # (no kernel line)
    python3 chip_smoke.py --generalization  # phases 1, 2, then both
        # parts below (neither is in the default run)
    python3 chip_smoke.py --generalization classification  # phases 1, 2,
        # then benchmarks/classification_generalization_demo.py's
        # configuration (see the comment above `GEN_PRESET`)
    python3 chip_smoke.py --generalization detection  # phases 1, 2, then
        # benchmarks/detection_generalization_demo.py's configuration (see
        # the comment above `DET_GEN_PRESET`)
    python3 chip_smoke.py --generalization reference  # phases 1, 2, then
        # benchmarks/recipe_ablation.py's row bs64_lr3e4 (see the comment
        # above `REF_GEN_ABLATION`; not in a bare --generalization run)
    python3 chip_smoke.py --serving-load  # phases 1, 2, then
        # benchmarks/serving_load.py's configuration, 30 s a run: bf16
        # and int8 at max_batch 8, bf16 at max_batch 1 (see the comment
        # above `LOAD_CLIENTS`; not in the default run)
    python3 chip_smoke.py --detector-ab PARENT  # phases 1, 2, then 9(c)
        # of the checkout PARENT and of this tree in turns, the host's ms
        # in match_layers a step below the parent's in each pair (no
        # kernel line)
    python3 chip_smoke.py --ab PARENT  # phases 1, 2, then the LayerNorm
        # and GELU kernels held at 3(c)'s timed shapes, a B = 1 /classify
        # p50, 7(b) and 9(c) with their profiles and the vit_large_384
        # step of PARENT and of this tree in turns

Run from the root of a checkout on a machine with a Hopper card and the
CUDA toolkit. It imports nothing of JAX or ``arsvt_tpu``. Phases:

1. device check: the card's name and power limit; TF32 off for fp32
   matmuls and convolutions;
2. build every kernel under ``arsvt_tpu_torch/csrc`` (one nvcc each, all
   started together) and print the compiler's resource report; no spill
   or stack frame in the bf16 kernels on the tensor cores (#1, #3, #5,
   #6, #8, #9), HMMA (mma.sync) in the SASS of every bf16 kernel of #1,
   #3, #5 and #6 and HGMMA (wgmma) in every bf16 kernel of #8 and #9;
3. each kernel against its plain PyTorch version on the card, at the
   main paths' shapes in bf16 and fp32 plus odd shapes (#1 also at S = 1
   and ViT-L's S = 577; #3 over d in {1, 16, 50, 96, 128}, Sq in {1, 5,
   198}, Sk in {1, 33, 198}, kv_len below Sk on every other shape, and
   #3/#4 past d = 128 at d = 129, 192, 256 and 320 with kv_len < Sk, #4
   also with dropout at d = 192, and both timed at d = 256 beside d =
   128), then
   timed with CUDA events beside its bound and a library call on the same
   work (the factor is ms over library ms; #1 and #3 also give the device
   time with launches queued behind a spin kernel, free of the host's
   pace at B=1); the
   head-major kernels (#3 with dropout, #4) also at one detector train
   step's shapes, and probes that read back the dropout mask each of
   their three launches used (d = 33, 96 and 192); #7 on ViT-B's leaf
   set, odd sizes and two leaves that are views one float into their
   storage, timed host-paced and held (device ms, host us a call) beside
   the fused torch.optim.AdamW step; the save-probs attention kernels (#5, #6)
   (also at the edges of their 64-row tiles, S in {1, 63, 64, 65, 128},
   at B = 1 and at ViT-L's S = 577) and the fused-MLP kernels (#8, #9) at
   the ``bench_train`` microbatch (B = 32, n = 6,304 rows) and odd sizes
   (n = 591 and 594, D = 400, M = 1,600), at the opt-in steps of phase
   17 (n = 1,576, (D, M) = (192, 768) and (384, 1,536)), at ViT-L's
   width (D = 1,024, M = 4,096, n = 9,232 and 1,731), in bf16 at ViT-H's
   (D = 1,280, M = 5,120, n = 257), and on their ragged route at (D, M)
   = (12, 20), (37, 75) and (100, 300) in both dtypes (timed at D =
   770, M = 3,070 beside D = 776, M = 3,072); the dropout branches of #1,
   #2, #5 and #6 at dropout 0.1 (B = 32, S = 65 and an odd shape, bf16
   and fp32), a probe that reads back the mask of each of their six
   launches, and their times beside dropout 0; (d) the shapes of phase
   17's presets: #1/#2 at (B, S, D, H) = (8, 197, 192, 3), (8, 197, 384,
   6) and (8, 145, 192, 3) with dropout 0 and 0.1 (#5/#6 with them, the
   mask probe at 6 heads), #5/#6 at the first, #3/#4 at detector_demo_96's
   cross-attention (B = 4 and 1, 4 heads of 48, 10 queries over 145 keys),
   #7 on vit_tiny_16_224's leaf set, the fused matcher at (3, 4, 10, 25)
   and (3, 4, 10, 8), LayerNorm and GELU at their rows and widths; and the
   shapes of the detection demo's batch of 64 (--generalization
   detection): #1/#2 at (64, 145, 192, 3), #3/#4 at (64, 4, 10, 145, 48),
   the fused matcher at (3, 64, 10, 8) and (1, 64, 10, 8), #7 on
   detector_demo_96's leaf set, LayerNorm and GELU at 9,280 rows of 192
   (768) and 640 of 192 (512); the shapes of the reference recipe's batch
   of 64 (--generalization reference): #3/#4 with dropout 0.1 at
   (64, 25, 198, 198, 16) and (64, 8, 5, 196, 50), the fused matcher at
   (6, 64, 5, 25) and (1, 64, 5, 25), LayerNorm and GELU at 12,672 rows of
   400 (1,600) and 320 of 400 (2,048), the apply kernel at (64, 1, 198,
   400); #1 and #2 held at vit_tiny_16_224's B = 1 and 8 beside SDPA and
   the bound;
4. ViT-B/16@224 from a seeded init (with a seeded random head) through
   ``StreamingClassifier``: fp32 on the card against the plain path on the
   CPU, then bf16 on the card against the fp32 run;
5. the HTTP server: /classify single and micro-batched, /healthz, /stats;
   (c) the micro-batched server (bf16, max_batch 8, a 3 ms window) under
   16 closed-loop clients posting serving_load.py's JPEG for 5 s: no
   error, the batcher's count of requests equal to the answers, every
   answer within the bf16 tolerance of the unbatched server's, the
   launches exact, images/s and the batch cycle beside the forward alone;
6. a torch.profiler window over bf16 forwards at B=1 and B=8: the device's
   busy share and the kernels by device time;
7. ViT-B/16@224 training through ``make_classifier_step_fns``: (a) two
   fp32 steps on the card against the same steps on the CPU; (a2) 7 bf16
   steps against 7 fp32 steps on the card, the configuration of (b) with a
   seeded random head; (b) the ``bench.py::bench_train`` configuration (batch 512 as 16 x 32, bf16,
   crop/flip on the 256 canvas, fused AdamW), 2 warm-up and 5 timed
   steps: images/s and ms/step; (c) one ``eval_step`` and
   ``evaluate_classifier`` over two batches; (d) a torch.profiler window
   over one bf16 train step (no eager LayerNorm or GELU op in it: every
   profile of a step fails on a ``rsqrt`` or ``tanh`` kernel of
   PyTorch's);
8. detector serving, ``deit_detector_ref`` (DeiT-400 backbone, 6-layer
   DETR head) from a seeded init through ``StreamingDetector``: (a) fp32
   on the card against the plain path on the CPU, raw logits and boxes;
   (b) bf16 against fp32 on the card; (c) ``post_process`` on the card
   and on the CPU from the same raw outputs; (d) /detect, /healthz and
   /stats through ``InferenceServer``; (e) detect_path latency over 60
   calls; (f) a torch.profiler window over one bf16 forward; (g)
   ``vit_base_detector`` through (a) and (d);
9. detector training through ``make_detector_step_fns``: (a) two fp32
   ``deit_detector_ref`` steps of batch 4 with the preset's residual and
   positional dropout 0.1 (attention dropout 0) on the card against the
   same steps on the CPU (matched pairs, loss, update; every mask a
   function of the site's seed and global indices, drawn in the apply
   kernel on the card, by its plain version on the CPU);
   (b) 3 bf16 steps against 3 fp32 steps on the card, the configuration of
   (c); (c) the ``bench.py::bench_detect`` configuration (batch 32, bf16,
   detection augmentation on the 256 canvas, dropout 0.1 with attention
   dropout in the kernels), 2 warm-up steps, then 5 timed steps a window
   on each matcher route in turns (device, scipy, scipy, device, twice):
   images/s, ms/step, the host's ms in ``match_layers``, peak memory, the
   kernels one ``match_layers`` call launches (at most 3) and its host ms; the
   device route's ``match_layers`` under sync debug mode "error" (no
   synchronising call), and the synchronising calls of one whole step on
   each route, by place; one step run twice from the same state; (d)
   ``eval_step`` and ``evaluate_detector``; (e) a torch.profiler window
   over one step on each route (the busy share);
10. ViT-B/16@224 training with ``ARSVT_ATTN_SAVE_PROBS`` and
   ``ARSVT_ENABLE_FUSED_MLP`` set in the process (and unset after; every
   other phase runs with both unset): (a) two fp32 steps on the card
   against the CPU; (b) 7 bf16 steps against 7(a2)'s 7 bf16 steps of the
   default route; (c) the ``bench_train`` configuration, 2 warm-up and 5
   timed steps, eval; (d) a torch.profiler window over one step;
11. the training entry point, ``arsvt_tpu_torch.train.cli.main``, in
   temporary working directories, with attention dropout 0.1: (a) the
   ``vit_base_bf16_flash`` preset (batch 128 as 4 x 32, bf16, crop/flip,
   fused AdamW) for 4 steps with checkpoints every 2 and an eval, a resume
   to step 6 against an uninterrupted 6-step run, and a run without
   dropout; (b) the same on the opt-in route; (c) fp32 steps with dropout
   card vs CPU on each route, and route against route; (d) ``Trainer``
   with task="detect" on ``vit_base_detector`` for 2 steps;
12. from images on disk to a served checkpoint (see the comment above
   `phase_disk`): (a) an unsplit TrashNet tree of JPEGs and a COCO root
   written by the port's writers, the host decoder's route and ms per
   image; (b) ``train.cli.main`` with ``--data-dir`` on the tree
   (``vit_base_finetune``, batch 32, 3 steps, eval and checkpoint); (c)
   ``evaluation.cli.main`` on its checkpoint against
   ``evaluate_classifier`` in fp32 on the CPU, and on a params-only copy
   with phase 4's seeded head; (d) ``InferenceServer.from_checkpoint``
   answering /classify as ``classify_path`` does (the server's main() as
   a subprocess: 13(d)); (e)
   ``deit_detector_ref`` trained from the COCO root, the eval CLI against
   ``evaluate_detector``, /detect from its checkpoint against
   ``detect_path``;
13. int8 serving and export artifacts (see the comment above
   `phase_int8_export`): (a) ViT-B/16@224 int8 against bf16 on the card
   within JAX's limits, the int8 products of ``torch._int_mm`` against
   exact sums, weight bytes, /classify p50/p99 with ``--int8`` and
   without; (b) ``deit_detector_ref`` int8 against bf16; (c) both models
   exported with ``torch.export`` in bf16 and int8, loaded by
   ``load_artifact_engine`` and held against the in-process engines at B =
   1 and 8, and the bf16 classify artifact moved to the CPU; (d) the
   export CLI's main() in process on phase 12's seeded checkpoint and
   ``python -m arsvt_tpu_torch.serving.server --artifact`` as a
   subprocess;
14. the ViT-L/16@384 recipe, ``TRAIN_PRESETS["vit_large_384"]`` (see the
   comment above `VITL`): (a) RandAugment (both-rotate lane forced), the
   classify pipeline with jitter, the taps, flat, patch, shear and
   Lanczos-4 warps and the bilinear ones under ``ARSVT_AUGMENT_BF16``, card
   against CPU on 8 images at 384 px, each timed at B = 256; (b) the five
   remat policies against no remat at ViT-L width and depth 2 (fp32, B =
   4, dropout 0.1) on both routes, and a remat step card vs CPU (mixup,
   label smoothing, no dropout); (c) their
   launches held to the policy table; (d) peak memory and ms/step per
   policy at 12 of the 24 layers, 16 images; (e) the preset as it stands (batch
   256, full remat, RandAugment, mixup, bf16): ms/step, img/s, peak
   memory, busy share, model TFLOP/s; #7 on one more step's own update
   (the 304 M-parameter tree and its gradients) and #1/#2 at the
   preset's shapes (B = 256, S = 577, D = 1,024, 16 heads, bf16) against
   their plain versions; and bench.py's ViT-L configuration;
   (f) ``train.cli.main --train-preset vit_large_384`` with a checkpoint
   and an eval at 384; (g) a ``deit_detector_ref`` step with remat and the
   taps warp;
15. DeiT distillation from an imported teacher (see the comment above
   `DISTILL_STUDENT`): (a) seeded timm- and HF-layout ViT-B/16 state dicts
   through ``python -m arsvt_tpu_torch.models.convert`` (subprocesses),
   each checkpoint held to its state dict under the layout rules to the
   bit, and a reference-layout ``deit_detector_ref`` ``.pth`` imported and
   served once on /detect; (b) the timm import with a seeded head as the
   teacher; (c) the ``deit_ref_400_16_224`` student, hard and soft, fp32
   steps card vs CPU with the preset's residual dropout and attention
   dropout, as phase 9(a); (d) bf16 steps (batch 64 as 2 x 32): ms/step, img/s,
   peak memory beside the same steps without a teacher, busy share,
   TFLOP/s; (e) ``train.cli.main --distillation soft`` with a checkpoint
   and an eval; (f) ``utils.profiling``'s trace, StepTimer and
   assert_all_finite on (d)'s steps;
16. data- and tensor-parallel training (see the comment above
   `PAR_TOL_LOSS`): (a) `Trainer` on an NCCL group of one rank against
   no group, to the bit; (b) two spawned gloo ranks on the card, DP = 2
   and TP = 2 at full width (ViT-B/16 fp32 and bf16, deit_detector_ref
   fp32, dropout 0.1) against one process, launches per rank; (c) the
   three route switches' launch tables; (d) a DP = 2 step's time beside
   one process's;
17. the presets no other phase runs, at full width and depth through
   their entry points (see the comment above `PRESET_REQUESTS`): (a)
   vit_tiny_16_224, BASELINE config #1: the train CLI's vit_tiny_eval
   from a TrashNet tree, the eval CLI on its checkpoint against the CPU,
   StreamingClassifier card vs CPU and bf16 vs fp32, /classify p50/p99 at
   B = 1 beside ViT-B/16's, an fp32 step card vs CPU on each route; (b)
   vit_small_16_224 and (c) vit_demo_8_96 (96 px, patch 8, on the demo's
   112 canvas): the forwards and the steps; (d) detector_demo_96:
   StreamingDetector card vs CPU, bf16 vs fp32, post_process, two fp32
   steps card vs CPU with the matched pairs equal.

Phase 3 also holds the detector matcher's kernel (``csrc/lap.cu``, JAX's
on-device Jonker-Volgenant). Its solve-only entry is held against
``lap_rect_plain`` on the card: equal assignments at the detector step's
(6, 32, 5, 25), the ``vit_base_detector`` step's transposed (6, 32, 25,
100), q = m = 64 over 256 problems, q = 1 and integer costs with ties,
the optimum scipy's within 1e-5, timed beside scipy on the host. Its
fused entry, which builds every layer's costs and solves them in one
launch, is held against ``match_layers_plain`` (see the comment above
`MATCH_CASES`: costs within 4 ulps, pads exactly 1e4, assignments equal
to ``lap_rect_plain``'s on its own costs) at the ``deit_detector_ref`` and
``vit_base_detector`` steps' shapes and one eval layer, and timed beside
the parent's route (the eager build, the solve-only entry and the
gather), the byte bound and an empty kernel's held time; its row in the
kernels record counts the fused entry's launches over phases 4-17, the
solve-only entry's 0 there. Phase 3 also
holds ``csrc/dropout_mask.cu``'s apply kernel, the residual,
positional and reference-attention sites, at residual and attention
views with and without a parallel rank's offsets (`MASK_CASES`),
and probes of
#1-#6's masks at such offsets against ``keep_mask``; (a) the apply kernel (one launch a site
each way: keep ? x·s : +0, the mask drawn in the kernel) against its
plain version on the same CUDA tensors, bf16 and fp32, both scale rules
(x / (1 - rate) and x * inv_keep), forward and backward through
``SiteDropout``, Inf and NaN planted, 0 differing elements as bits, its
mask equal to ``keep_mask``'s on the card, and the "div" rule also as a true
division in plain PyTorch to record which PyTorch's x / k is; (b) the
site at the detector's residual view (32, 1, 198, 400), bf16 and fp32,
held on the device and host-paced: the fused forward, its backward
launch and forward + backward under autograd, beside
``torch.nn.functional.dropout`` and the byte and integer
bounds (the rule's multiplies on the FMA pipe, its logic on the ALU
pipe, all of it over the issue rate), with each kernel's registers and
integer opcodes (cuobjdump), and the bf16 forward at C = 512 and at 4x
the rows, to show what holds it back.
The apply kernel's row in the kernels record counts its launches over
phases 4-17. (c) holds the
port-only LayerNorm and GELU kernels (``csrc/layernorm.cu``,
``csrc/gelu_tanh.cu``) against their plain versions on the same CUDA
tensors (see the comment above `NORM_WIDTHS`: LayerNorm at every preset
width and 770, 1,536 and 4,096 on 1 to 9,232 rows, both dtypes of x and
of the parameters, the backward's bits repeated; GELU to the bit with
Inf and NaN planted, the bf16 forward on both its routes, at every shape
and at all 65,536 bf16 inputs, the table the card filled equal to the
chain) and times them at ViT-B's, the detector's, ViT-L's and B = 1
serving's shapes beside their bounds, the plain versions and
F.layer_norm / F.gelu(approximate="tanh"), with the bf16 GELU forward's
two routes by size and each kernel's registers and spills (cuobjdump);
their two rows in the kernels record count the forward and backward
launches over phases 4-17, the GELU's also its table-route launches and
the table's fill there (the main path fills its own: exactly once).

Kernel launch counts are zeroed just before each path and read just after
it, every table exact, the LayerNorm and GELU kernels in each as
`norm_launches` counts them (2 depth + 1 LayerNorms and depth GELUs a
ViT forward, 4 LayerNorms and a GELU a DETR layer and its final
LayerNorm, once more over the intermediate layers in training; two
launches a LayerNorm backward, one a GELU backward; the block remat
policies replay both LayerNorms of a block, every policy the unfused
GELU; no GELU kernel on the fused-MLP route; none of LayerNorm under
``ARSVT_DISABLE_LN_VJP``): phases 4-5 (classify serving: one encoder-attention forward launch per
layer and forward, no training kernel; in 5(c) and ``--serving-load`` a
forward a batch, the server's warm-up and the forward alone's, the bf16
GELU on its table route at a batch of 8); 7(b)-(c) (training: forward
launches = layers x (microbatches x steps + eval forwards), backward
launches = layers x microbatches x steps x 2 kernels per call, one AdamW
launch per step); 8(a)-(f) (``deit_detector_ref``: 12 encoder + 6
cross-attention launches of the head-major kernel per forward, no other
kernel); 8(g) (``vit_base_detector``: 12 encoder-attention and 6
head-major launches per forward); 9(c)-(e) (detector training: 18
head-major forward and 18 backward calls and one AdamW launch per step,
18 forward calls per eval forward, one lap launch per step on the device
route and per eval forward, none on the scipy route); 10(c) (opt-in
training: per layer and microbatch one #5 launch, one #6 call, one #8
call and one #9 call (two launches each in bf16), no #1 or #2; one
AdamW launch per step; per eval
forward one #1 launch and one #8 call per layer); each CLI run of
11(a)-(b), with the same rule per route and step and 8 eval forwards of
128 images per eval;
11(d) (per step 12 #1 and #2 calls, 6 #3 and #4 calls, one AdamW
launch, one lap launch of the transposed problems); each entry point
of 12 ((b): #1 and #2 per layer and step, #1
per layer and eval batch, one AdamW launch a step; (c) and (d): #1 per
layer and forward alone; (e): 18 #3 and #4 calls, one AdamW launch and
one lap launch a step, 18 #3 calls per eval or served forward, one lap
launch per eval forward); each path of 13 ((a): #1
per layer and forward, int8 or bf16, in process and served; (b): 18 #3 a
forward; (c): #1 per layer or 18 #3 per forward of each loaded artifact,
its warm-up included; (d): #1 per layer and forward of the artifact served
in process; the subprocesses' launches are not counted); each path of 14
((b)-(c): per layer and microbatch the forwards of `REMAT_TABLE` and one
backward call; (e)-(f): under full remat #1 twice and #2 once a layer and
microbatch, #1 once a layer and eval forward, one AdamW launch a step,
and without remat #1 once; (g): 24 #3 encoder launches (forward and
replay) and 6 cross-attention launches, 18 #4 calls, one AdamW launch,
one lap launch);
each path of 15 ((a): 18 #3 a forward of the served import, its warm-up
included; (b): #1 per layer and forward of the teacher; (c)-(f): per
microbatch the student's 12 #3 forward and 12 #4 calls and the teacher's
12 #1 launches (none in (d)'s steps without a teacher), no #2, one AdamW
launch a step, 12 #3 calls per eval forward); each path of 17 (the
rules above at each preset's depth: #1 once a layer and forward, #1 and
#2 or #5, #6, #8 and #9 a layer and microbatch, #3 and #4 once a DETR
layer, one AdamW launch a step, one lap launch a detector step). The
apply kernel's
launches are held in the same tables, `site_launches` a training
microbatch (one a site's forward or replay, `mask_sites`, and one its
backward): 98 in ``deit_detector_ref`` (49 sites: 9(c)-(e), 12(e); 110
under 14(g)'s remat, whose replays draw each encoder layer's attention
residual site again), 12 in ``vit_base_detector`` (11(d): the decoder's
reference self-attention), 50 in the distillation student (15), 10 a
policy's microbatch in 14(b)-(c) and 12 where it replays whole blocks,
none on the ViT-B and ViT-L paths (no residual dropout; attention
dropout runs inside #1-#6).
Beside each total, #1,
#2, #3, #4, #5 and #6 count the launches that ran their dropout branch:
every training launch of phase 11's dropout runs, of the detector's
training (9(c), 11(d), 12(e)), of 14(b)-(c) and of the distillation
student's (15(c)-(f)), none elsewhere. Any
failure exits non-zero. The last
lines are the kernels' record, the card's ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import http.client
import inspect
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from arsvt_tpu_torch.core.dtypes import (
    named_leaves,
    to_unit_float,
    tree_leaves,
    tree_map,
)
from arsvt_tpu_torch.core.prng import Rng
from arsvt_tpu_torch.data import augment
from arsvt_tpu_torch.data.augment import normalize
from arsvt_tpu_torch.data.pipeline import letterbox
from arsvt_tpu_torch.evaluation.classify import (
    StreamingClassifier,
    StreamingDetector,
    classifier_logits,
    classifier_params,
    detector_outputs,
    detector_params,
    evaluate_classifier,
)
from arsvt_tpu_torch.evaluation.detect import evaluate_detector, post_process
from arsvt_tpu_torch.models.classifier import init_image_classifier
from arsvt_tpu_torch.models.detector import init_detector
from arsvt_tpu_torch.models.registry import DETECTOR_PRESETS, PRESETS
from arsvt_tpu_torch.models.vit import apply_backbone, init_backbone
from arsvt_tpu_torch.objectives import matcher
from arsvt_tpu_torch.ops import (
    build,
    encoder_attention,
    flash_attention,
    fused_adamw,
    fused_mlp,
)
from arsvt_tpu_torch.ops import dropout as dropout_ops
from arsvt_tpu_torch.ops import layernorm as ln_ops
from arsvt_tpu_torch.ops import mlp as mlp_ops
from arsvt_tpu_torch.ops.quant import int8_matmul
from arsvt_tpu_torch.ops.remat import REMAT_POLICIES
from arsvt_tpu_torch.serving.artifact import load_artifact_engine
from arsvt_tpu_torch.serving.export import (
    export_classifier,
    export_detector,
    save_exported,
)
from arsvt_tpu_torch.serving.server import InferenceServer
from arsvt_tpu_torch.train import detect_step, optim
from arsvt_tpu_torch.train.config import (
    TRAIN_PRESETS,
    TrainConfig,
    resolve_detector,
)
from arsvt_tpu_torch.train.detect_step import make_detector_step_fns
from arsvt_tpu_torch.train.optim import _wd_mask
from arsvt_tpu_torch.train.train_step import make_classifier_step_fns
from arsvt_tpu_torch.utils.flops import (
    backbone_fwd_gflops,
    train_gflops_per_image,
)

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


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print a record; a phase header carries the script's elapsed seconds
    (the budget's breakdown)."""
    if msg.startswith("# phase"):
        msg = f"{msg} [t = {time.perf_counter() - _T0:.1f} s]"
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


# Cycles of the spin kernel that holds the card per queued call in
# `device_ms`: 0.25 ms at 2 GHz, above any wrapper's host time.
HOLD_CYCLES_PER_CALL = 500_000


# Times `device_ms` takes a measurement again behind a spin four times as
# long when the host fell behind the spin
HOLD_RETRIES = 2


def device_ms(fn, iters: int, warmup: int = 5,
              hold_cycles: int = HOLD_CYCLES_PER_CALL) -> float:
    """Per-call device time: the calls are queued behind a spin kernel
    that holds the card for `hold_cycles` a call while the host enqueues
    them, so no launch waits on the host (`cuda_ms` at B=1 reads the
    host's pace instead). Where the host did not finish enqueuing before
    the spin ended (a slow host), the measurement is taken again behind a
    spin four times as long, up to `HOLD_RETRIES` times; then it
    raises."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(HOLD_RETRIES + 1):
        held, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        held.record()
        torch.cuda._sleep(hold_cycles * 4 ** attempt * iters)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if enqueue_ms < held.elapsed_time(start):
            return start.elapsed_time(end) / iters
    check(False, f"the host took {enqueue_ms:.2f} ms to enqueue, longer "
          f"than the {held.elapsed_time(start):.2f} ms hold")


def host_us(fn, iters: int, warmup: int = 5) -> float:
    """The host's us a call returns in (the wrapper's own work: checks,
    tables, launch), each call made on an idle card, as a training step
    makes it, and timed without the synchronize that follows."""
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / iters * 1e6


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


def shares(ms, bound_ms, library_ms) -> dict:
    """A timing line's share of the bound and its factor against the
    library call (None where no one call computes the same function)."""
    return {"bound_share": bound_ms / ms,
            "factor": None if library_ms is None else ms / library_ms}


# (B, S, D, H) of the microbatch of phase 17's presets at head_dim 64
# (B = 8): vit_tiny_16_224 (3 heads), vit_small_16_224 (6 heads) and
# vit_demo_8_96 (S = 145, the backbone of detector_demo_96 too), with
# D % 128 != 0 where JAX's router takes its packed kernel instead.
PRESET_ENC_SHAPES = {"vit_tiny_16_224": (8, 197, 192, 3),
                     "vit_small_16_224": (8, 197, 384, 6),
                     "vit_demo_8_96": (8, 145, 192, 3)}
# and detector_demo_96's backbone at the detection demo's batch of 64
# (--generalization detection)
DEMO_ENC_SHAPE = (64, 145, 192, 3)


# (B, S, D, H) at the edges of #1's tiles beside the ViT-B shapes: one
# query row and key, and ViT-L/16@384's S = 577 (ten row tiles, ten key
# chunks) at its width, D = 1,024 in 16 heads; then the presets' shapes.
ENC_EDGE_CASES = [(2, 1, 128, 2), (2, 577, 1024, 16),
                  *PRESET_ENC_SHAPES.values(), DEMO_ENC_SHAPE]


def phase_kernel_checks(cfg) -> dict:
    d, h = cfg.embed_dim, cfg.num_heads
    s = cfg.seq_len
    cases = [(8, s, d, h, torch.bfloat16), (8, s, d, h, torch.float32),
             (1, s, d, h, torch.bfloat16), (3, 17, 128, 2, torch.bfloat16),
             (3, 17, 128, 2, torch.float32), (32, s, d, h, torch.bfloat16)]
    cases += [(*shape, dtype) for shape in ENC_EDGE_CASES
              for dtype in (torch.bfloat16, torch.float32)]
    errs = {}
    for i, (b, s_, d_, h_, dtype) in enumerate(cases):
        # the B=32 case on the input its timing below uses
        qkv = seeded_qkv(b, s_, d_, dtype, seed=7 if b == 32 else 100 + i)
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
    for b in (1, 8, 32):
        qkv = seeded_qkv(b, s, d, torch.bfloat16, seed=7)
        ms = cuda_ms(lambda: encoder_attention.encoder_attention_fwd(qkv, h),
                     iters=200 if b < 32 else 50)
        plain_ms = cuda_ms(
            lambda: encoder_attention.encoder_attention_fwd_plain(qkv, h),
            iters=50)
        library_ms = cuda_ms(lambda: library_attention(qkv, h), iters=200)
        held = {"device_ms": device_ms(
                    lambda: encoder_attention.encoder_attention_fwd(qkv, h),
                    iters=100),
                "library_device_ms": device_ms(
                    lambda: library_attention(qkv, h), iters=100)}
        bound_ms, bound_by, nbytes, flops = attention_bound(b, s, d, h)
        timings[b] = {"ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by}
        log(json.dumps({
            "timing": "encoder_attention_fwd", "B": b, "S": s, "D": d,
            "H": h, "dtype": "bfloat16", "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "flops": flops,
            **shares(ms, bound_ms, library_ms), **held,
            "device_factor": held["device_ms"] / held["library_device_ms"],
        }))
    return {"max_abs_err": errs[f"B32_S{s}_D{d}_H{h}_bfloat16"],
            **timings[32]}


# (H, Sq, Sk, d) of the head-major kernel's calls on the detector paths:
# the DeiT-400 encoder's self-attention, deit_detector_ref's and
# vit_base_detector's DETR cross-attention over the 196 patch tokens.
FLASH_PATH_SHAPES = {
    "deit_encoder": (25, 198, 198, 16),
    "deit_cross": (8, 5, 196, 50),
    "vit_base_cross": (8, 100, 196, 96),
}


# (name, B, H, Sq, Sk, d, kv_len) of detector_demo_96's DETR
# cross-attention (10 queries over the 145 tokens, 4 heads of 48) in
# phase 17's train step (B = 4), at serving's B = 1 and in the detection
# demo's steps (B = 64, --generalization detection)
PRESET_FLASH_CASES = [("detector_demo_96_cross_B4", 4, 4, 10, 145, 48, 145),
                      ("detector_demo_96_cross_B1", 1, 4, 10, 145, 48, 145),
                      ("detector_demo_96_cross_B64", 64, 4, 10, 145, 48,
                       145)]


def seeded_heads(b, h, sq, sk, d, dtype, seed):
    """q (B, H, Sq, d), k and v (B, H, Sk, d) on the card."""
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen).to(dtype).cuda()
                 for shape in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d)))


def flash_bound(b, h, sq, sk, d, elem=2):
    """Each of q, k, v read once, O and lse written once; 4*B*H*Sq*Sk*d
    FLOPs (both products)."""
    nbytes = b * h * (2 * sq * d + 2 * sk * d) * elem + b * h * sq * 4
    flops = 4 * b * h * sq * sk * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes, flops


# Edges of #3's tiles: each padded head dim (d = 1 and 16 pad to 16, 50 to
# 64, then 96 and 128; 1 and 50 staged element by element in bf16), one
# query row to four row tiles, one key to four key chunks; kv_len < Sk on
# every other shape where Sk > 1.
FLASH_EDGE_D = (1, 16, 50, 96, 128)
FLASH_EDGE_SQ = (1, 5, 198)
FLASH_EDGE_SK = (1, 33, 198)


# Head dims past 128 (attention_wide.cuh: 64-column output slices; d = 129
# leaves one column in its last slice; 129 is staged element by element in
# bf16), each with kv_len < Sk, over one to three row tiles and key chunks:
# (name, B, H, Sq, Sk, d, kv_len)
FLASH_WIDE_CASES = [("wide_d129", 2, 3, 70, 150, 129, 100),
                    ("wide_d192", 2, 2, 65, 198, 192, 150),
                    ("wide_d256", 1, 4, 130, 66, 256, 40),
                    ("wide_d320", 2, 2, 5, 196, 320, 120)]


def flash_edge_cases() -> list[tuple]:
    """(name, B, H, Sq, Sk, d, kv_len) over FLASH_EDGE_D x _SQ x _SK."""
    cases = []
    for d in FLASH_EDGE_D:
        for sq in FLASH_EDGE_SQ:
            for sk in FLASH_EDGE_SK:
                kv_len = sk - sk // 3 if len(cases) % 2 else sk
                cases.append((f"edge_d{d}_sq{sq}_sk{sk}_kv{kv_len}", 2, 3,
                              sq, sk, d, kv_len))
    return cases


def phase_flash_checks() -> dict:
    """The head-major kernel against its plain version at the detector
    paths' shapes (B=1 and B=8), a masked odd shape, one query row and the
    tiles' edges, in bf16 and fp32 (tolerances of the encoder-attention
    forward: the same arithmetic in another summation order); then timed
    at the path shapes at B = 1, 8 and 32 beside SDPA. Returns the record
    of the DeiT-400 encoder shape at B=1, the most launched."""
    cases = [(f"{name}_B{b}", b, h, sq, sk, d, sk)
             for name, (h, sq, sk, d) in FLASH_PATH_SHAPES.items()
             for b in (1, 8)]
    cases += [("odd_kv_len", 3, 2, 17, 33, 50, 20),
              ("one_query", 2, 4, 1, 77, 128, 77)]
    cases += flash_edge_cases() + FLASH_WIDE_CASES + PRESET_FLASH_CASES
    errs = {}
    for i, (name, b, h, sq, sk, d, kv_len) in enumerate(cases):
        for j, dtype in enumerate((torch.bfloat16, torch.float32)):
            q, k, v = seeded_heads(b, h, sq, sk, d, dtype, 400 + 2 * i + j)
            out, lse = flash_attention.flash_attention_fwd(q, k, v,
                                                           kv_len=kv_len)
            torch.cuda.synchronize()
            ref_out, ref_lse = flash_attention.flash_attention_fwd_plain(
                q, k, v, kv_len)
            key = f"{name}_{str(dtype).split('.')[-1]}"
            check(out.shape == ref_out.shape and out.dtype == dtype and
                  lse.shape == (b, h, 1, sq), f"shapes at {key}")
            check(bool(torch.isfinite(out.float()).all()),
                  f"non-finite O at {key}")
            e_out, e_lse = max_err(out, ref_out), max_err(lse, ref_lse)
            if dtype == torch.float32:
                ok = e_out <= TOL_FP32
            else:
                ok = bool(((out.float() - ref_out.float()).abs()
                           <= TOL_BF16 + TOL_BF16 * ref_out.float().abs()
                           ).all())
            log(json.dumps({"check": "flash_attention_fwd", "case": key,
                            "shape": [b, h, sq, sk, d], "kv_len": kv_len,
                            "max_abs_err_out": e_out,
                            "max_abs_err_lse": e_lse}))
            check(ok, f"flash_attention_fwd O disagrees at {key}: {e_out}")
            check(e_lse <= TOL_LSE, f"lse disagrees at {key}: {e_lse}")
            errs[key] = e_out

    timings = {}
    for name, (h, sq, sk, d) in FLASH_PATH_SHAPES.items():
        for b in (1, 8, 32):
            q, k, v = seeded_heads(b, h, sq, sk, d, torch.bfloat16, seed=8)
            ms = cuda_ms(lambda: flash_attention.flash_attention_fwd(q, k, v),
                         iters=200 if b < 32 else 50)
            plain_ms = cuda_ms(
                lambda: flash_attention.flash_attention_fwd_plain(q, k, v,
                                                                  sk),
                iters=50 if b < 32 else 5)
            # the library yardstick on the same q, k, v: timed, never
            # called by the port
            library_ms = cuda_ms(
                lambda: F.scaled_dot_product_attention(q, k, v), iters=200)
            held = {"device_ms": device_ms(
                        lambda: flash_attention.flash_attention_fwd(q, k, v),
                        iters=100),
                    "library_device_ms": device_ms(
                        lambda: F.scaled_dot_product_attention(q, k, v),
                        iters=100)}
            bound_ms, bound_by, nbytes, flops = flash_bound(b, h, sq, sk, d)
            timings[(name, b)] = {"ms": ms, "plain_ms": plain_ms,
                                  "library_ms": library_ms,
                                  "bound_ms": bound_ms, "bound_by": bound_by}
            log(json.dumps({
                "timing": "flash_attention_fwd", "shape_of": name, "B": b,
                "H": h, "Sq": sq, "Sk": sk, "d": d, "dtype": "bfloat16",
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
                "flops": flops, **shares(ms, bound_ms, library_ms), **held,
                "device_factor": held["device_ms"]
                / held["library_device_ms"],
            }))
    return {"max_abs_err": errs["deit_encoder_B1_bfloat16"],
            **timings[("deit_encoder", 1)]}


# The head-major kernels (#3 with dropout, #4) against their plain versions:
# the largest error over the tensor, against the largest magnitude of the
# plain result. fp32: the same fp32 arithmetic with the sums in another
# order (sequential FMAs against cuBLAS), a few ulps of the largest term.
# bf16: p and dS are rounded to bf16 before three products, and a last-bit
# difference in fp32 can flip single roundings, then the output's own
# rounding: a few bf16 ulps of the largest term, plus 2^-7 absolute.
TOL_FLASH_REL_FP32 = 2e-5
TOL_FLASH_REL_BF16 = 2.0 ** -6
TOL_FLASH_ABS_BF16 = 2.0 ** -7
DROPOUT_RATE = 0.1
DROPOUT_SEED = 0xDEADBEEF  # high bit set: the seed travels as a uint32

# (B, H, Sq, Sk, d) of one detector train step's attention calls
# (deit_detector_ref at batch 32): 12 encoder, 6 cross-attention.
FLASH_TRAIN_SHAPES = {
    "deit_encoder_B32": (32, 25, 198, 198, 16),
    "deit_cross_B32": (32, 8, 5, 196, 50),
}
# (name, B, H, Sq, Sk, d, kv_len, rate) of the same calls in the steps of
# benchmarks/recipe_ablation.py's row bs64_lr3e4 (batch 64, dropout 0.1;
# --generalization reference)
REF_GEN_FLASH_CASES = [
    ("deit_encoder_B64_dropout", 64, 25, 198, 198, 16, 198, DROPOUT_RATE),
    ("deit_cross_B64_dropout", 64, 8, 5, 196, 50, 196, DROPOUT_RATE)]


def flash_limit(ref, dtype) -> float:
    top = float(ref.float().abs().max())
    if dtype == torch.float32:
        return TOL_FLASH_REL_FP32 * top
    return TOL_FLASH_REL_BF16 * top + TOL_FLASH_ABS_BF16


def flash_bwd_bound(b, h, sq, sk, d, elem=2):
    """q, k, v, O and dO read once, lse read once, dq, dk and dv written
    once; 10*B*H*Sq*Sk*d FLOPs (s, dP, dq, dk, dv)."""
    nbytes = b * h * (3 * sq * d + 2 * sk * d) * elem + b * h * sq * 4 \
        + b * h * (sq * d + 2 * sk * d) * elem
    flops = 10 * b * h * sq * sk * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes, flops


def mask_probe(b, h, sq, sk, seed, device="cuda", offsets=None):
    """Recover the keep mask each head-major kernel used, on the card.

    q = 0 makes p uniform (1/Sk) whatever k is; k = v = I (d = Sk) read
    the probabilities back. Forward: O[i, j] = keep(i, j) / (Sk·keep_prob).
    Backward with dO = e_i (row i one-hot, Sq <= d): dv[j, i] = p_v[i, j],
    the dk/dv launch's mask. Backward with dO = 1: dq[i, j] = scale·p·
    (keep(i, j)/keep_prob - delta_i), the dq launch's, decoded against
    delta_i = sum_j O[i, j]. `offsets` = (b0, H, h0) place the launch in a
    global batch and head set, as a data- or tensor-parallel rank's.
    Returns mismatches against `keep_mask` per launch."""
    from arsvt_tpu_torch.ops.dropout import keep_mask

    d = sk
    kp = 1.0 - DROPOUT_RATE
    q = torch.zeros(b, h, sq, d, device=device)
    eye = torch.eye(sk, device=device).expand(b, h, sk, sk).contiguous()
    kw = dict(dropout_rate=DROPOUT_RATE, seed=seed, offsets=offsets)
    o, lse = flash_attention.flash_attention_fwd(q, eye, eye, **kw)
    one_hot = torch.eye(sq, d, device=device).expand(b, h, sq, d)
    _, _, dv = flash_attention.flash_attention_bwd(
        q, eye, eye, o, one_hot.contiguous(), lse, **kw)
    ones = torch.ones(b, h, sq, d, device=device)
    dq, _, _ = flash_attention.flash_attention_bwd(q, eye, eye, o, ones, lse,
                                                   **kw)
    torch.cuda.synchronize()
    want = keep_mask(seed, b, h, sq, sk, DROPOUT_RATE, device,
                     offsets=offsets)
    delta = o.sum(dim=-1, keepdim=True)
    got = {"fwd": o > 0,
           "bwd_dkdv": dv[..., :sq].transpose(-1, -2) > 0,
           "bwd_dq": (dq * math.sqrt(d) * sk + delta) * kp > 0.5}
    return {k: int((v != want).sum()) for k, v in got.items()}


def library_flash_fwd_bwd_ms(q, k, v, do, rate) -> float:
    """`F.scaled_dot_product_attention` forward and backward through
    autograd on the same operands: a yardstick, never called by the
    port."""
    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

    def fwd_bwd():
        out = F.scaled_dot_product_attention(q, k, v, dropout_p=rate)
        torch.autograd.grad(out, (q, k, v), do)

    return cuda_ms(fwd_bwd, iters=20)


# (name, B, H, Sq, Sk, d, kv_len, rate) at the edges of #4's tiles of 64
# queries and 64 keys: d = 1, 32, 64 and 128 (one instantiation each),
# Sq and Sk one short of, at and one past a tile, kv_len < Sk on two
FLASH_BWD_EDGE_CASES = [("edge_d1", 2, 3, 65, 64, 1, 64, 0.0),
                        ("edge_d32", 2, 4, 64, 129, 32, 100, 0.0),
                        ("edge_d64", 3, 2, 128, 65, 64, 65, 0.0),
                        ("edge_d128", 2, 2, 63, 128, 128, 127, 0.0)]


def phase_flash_train_checks() -> dict:
    """#4 against its plain version at one detector train step's shapes,
    at d = 96, at kv_len < Sk and at its tiles' edges, bf16 and fp32; #3
    and #4 with dropout 0.1 against their plain versions at the train
    shapes; the probe of each launch's mask; then #4 (and #3 with dropout)
    timed at the train shapes. Returns #4's record at the encoder shape."""
    cases = [(name, *shape, shape[3], 0.0)
             for name, shape in FLASH_TRAIN_SHAPES.items()]
    cases += [("d96", 4, 8, 100, 196, 96, 196, 0.0),
              ("odd_kv_len", 3, 2, 17, 33, 50, 20, 0.0)]
    cases += FLASH_BWD_EDGE_CASES
    cases += [(f"{name}_dropout", *shape, shape[3], DROPOUT_RATE)
              for name, shape in FLASH_TRAIN_SHAPES.items()]
    cases += [(*case, 0.0) for case in FLASH_WIDE_CASES]
    cases += [("wide_d192_dropout", 2, 2, 65, 198, 192, 150, DROPOUT_RATE)]
    cases += [(*case, 0.0) for case in PRESET_FLASH_CASES]
    cases += REF_GEN_FLASH_CASES
    errs = {}
    for i, (name, b, h, sq, sk, d, kv_len, rate) in enumerate(cases):
        for j, dtype in enumerate((torch.bfloat16, torch.float32)):
            q, k, v = seeded_heads(b, h, sq, sk, d, dtype, 600 + 2 * i + j)
            gen = torch.Generator().manual_seed(700 + 2 * i + j)
            do = torch.randn(b, h, sq, d, generator=gen).to(dtype).cuda()
            kw = dict(kv_len=kv_len, dropout_rate=rate, seed=DROPOUT_SEED)
            key = f"{name}_{str(dtype).split('.')[-1]}"
            rec = {"check": "flash_attention_bwd", "case": key,
                   "shape": [b, h, sq, sk, d], "kv_len": kv_len,
                   "dropout_rate": rate}
            if rate > 0.0:  # #3's dropout branch first
                out, lse = flash_attention.flash_attention_fwd(q, k, v, **kw)
                torch.cuda.synchronize()
                ref_out, ref_lse = flash_attention.flash_attention_fwd_plain(
                    q, k, v, kv_len, rate, DROPOUT_SEED)
                rec["max_abs_err_fwd_out"] = max_err(out, ref_out)
                rec["max_abs_err_fwd_lse"] = max_err(lse, ref_lse)
                check(rec["max_abs_err_fwd_out"] <= flash_limit(ref_out, dtype)
                      and rec["max_abs_err_fwd_lse"] <= TOL_LSE,
                      f"flash_attention_fwd with dropout at {key}: {rec}")
            # the plain forward's O and lse feed both backward versions
            out, lse = flash_attention.flash_attention_fwd_plain(
                q, k, v, kv_len, rate, DROPOUT_SEED)
            got = flash_attention.flash_attention_bwd(q, k, v, out, do, lse,
                                                      **kw)
            torch.cuda.synchronize()
            ref = flash_attention.flash_attention_bwd_plain(
                q, k, v, out, do, lse, kv_len, rate, DROPOUT_SEED)
            for gname, x, r in zip(("dq", "dk", "dv"), got, ref):
                check(x.shape == r.shape and x.dtype == r.dtype,
                      f"{gname} shape/dtype at {key}")
                check(bool(torch.isfinite(x.float()).all()),
                      f"non-finite {gname} at {key}")
                rec[f"max_abs_err_{gname}"] = max_err(x, r)
                rec[f"max_abs_{gname}"] = float(r.float().abs().max())
                check(rec[f"max_abs_err_{gname}"] <= flash_limit(r, dtype),
                      f"flash_attention_bwd {gname} disagrees at {key}: "
                      f"{rec}")
            if kv_len < sk:
                check(float(got[1][:, :, kv_len:].float().abs().max()) == 0.0
                      and float(got[2][:, :, kv_len:].float().abs().max())
                      == 0.0, f"masked keys got a gradient at {key}")
            log(json.dumps(rec))
            errs[key] = max(rec[f"max_abs_err_{n}"]
                            for n in ("dq", "dk", "dv"))

    # d = Sk = 96: #3 stages by cp.async; 33: element by element; 192: the
    # wide kernels, three output slices drawing one mask; then the global
    # offsets of a parallel rank (b0, H, h0), on both kernel families: a
    # DP rank's rows 6.. and a TP rank's heads 12.. of deit_detector_ref's
    # 25 (13 and 12 on two ranks)
    for shape, offsets in (((4, 5, 70, 96), None), ((2, 3, 17, 33), None),
                           ((2, 3, 70, 192), None),
                           ((2, 12, 40, 40), (6, 25, 13)),
                           ((2, 3, 17, 192), (1, 7, 4))):
        mismatches = mask_probe(*shape, DROPOUT_SEED, offsets=offsets)
        log(json.dumps({"check": "dropout mask probe", "shape": shape,
                        "offsets": offsets, "rate": DROPOUT_RATE,
                        "mismatches": mismatches}))
        check(all(v == 0 for v in mismatches.values()),
              f"a kernel's dropout mask differs from keep_mask at {shape}: "
              f"{mismatches}")

    timings = {}
    for name, (b, h, sq, sk, d) in FLASH_TRAIN_SHAPES.items():
        q, k, v = seeded_heads(b, h, sq, sk, d, torch.bfloat16, seed=12)
        gen = torch.Generator().manual_seed(13)
        do = torch.randn(b, h, sq, d, generator=gen).to(torch.bfloat16).cuda()
        for rate in (0.0, DROPOUT_RATE):
            kw = dict(dropout_rate=rate, seed=DROPOUT_SEED)
            out, lse = flash_attention.flash_attention_fwd(q, k, v, **kw)
            fwd_ms = cuda_ms(lambda: flash_attention.flash_attention_fwd(
                q, k, v, **kw), iters=50)
            fwd_plain_ms = cuda_ms(
                lambda: flash_attention.flash_attention_fwd_plain(
                    q, k, v, sk, rate, DROPOUT_SEED), iters=5, warmup=1)
            ms = cuda_ms(lambda: flash_attention.flash_attention_bwd(
                q, k, v, out, do, lse, **kw), iters=50)
            dev_ms = device_ms(lambda: flash_attention.flash_attention_bwd(
                q, k, v, out, do, lse, **kw), iters=50)
            plain_ms = cuda_ms(
                lambda: flash_attention.flash_attention_bwd_plain(
                    q, k, v, out, do, lse, sk, rate, DROPOUT_SEED),
                iters=5, warmup=1)
            lib_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, dropout_p=rate), iters=50)
            library_ms = library_flash_fwd_bwd_ms(q, k, v, do, rate) \
                - lib_fwd_ms
            bound_ms, bound_by, nbytes, flops = flash_bwd_bound(b, h, sq, sk,
                                                                d)
            fwd_bound_ms, fwd_bound_by, _, _ = flash_bound(b, h, sq, sk, d)
            timings[(name, rate)] = {
                "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by}
            log(json.dumps({
                "timing": "flash_attention_bwd", "shape_of": name,
                "B": b, "H": h, "Sq": sq, "Sk": sk, "d": d,
                "dtype": "bfloat16", "dropout_rate": rate, "ms": ms,
                "device_ms": dev_ms, "plain_ms": plain_ms,
                "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
                "flops": flops, **shares(ms, bound_ms, library_ms),
                "fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain_ms,
                "fwd_library_ms": lib_fwd_ms, "fwd_bound_ms": fwd_bound_ms,
                "fwd_bound_by": fwd_bound_by,
                "fwd_factor": fwd_ms / lib_fwd_ms}))
    for shape in FLASH_WIDE_TIMED:
        time_flash_wide(*shape)
    return {"max_abs_err": errs["deit_encoder_B32_bfloat16"],
            **timings[("deit_encoder_B32", 0.0)]}


# (B, H, Sq, Sk, d) timed in bf16 past d = 128 beside the widest d of the
# kernels that hold a row's whole d in registers: a block of the wide
# kernels redoes the scores for each of its row tile's 64-column output
# slices
FLASH_WIDE_TIMED = [(8, 8, 198, 198, 128), (8, 8, 198, 198, 256)]


def time_flash_wide(b, h, sq, sk, d) -> None:
    """#3 and #4 at (B, H, Sq, Sk, d) in bf16: host-paced and held device
    ms beside their bounds and SDPA's forward and backward (forward and
    backward less forward) on the same inputs."""
    q, k, v = seeded_heads(b, h, sq, sk, d, torch.bfloat16, seed=22)
    gen = torch.Generator().manual_seed(23)
    do = torch.randn(b, h, sq, d, generator=gen).to(torch.bfloat16).cuda()
    out, lse = flash_attention.flash_attention_fwd(q, k, v)

    def fwd():
        flash_attention.flash_attention_fwd(q, k, v)

    def bwd():
        flash_attention.flash_attention_bwd(q, k, v, out, do, lse)

    lib_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                         iters=50)
    log(json.dumps({
        "timing": "flash_attention wide", "B": b, "H": h, "Sq": sq,
        "Sk": sk, "d": d, "dtype": "bfloat16",
        "fwd_ms": cuda_ms(fwd, iters=50),
        "fwd_device_ms": device_ms(fwd, iters=50),
        "fwd_bound_ms": flash_bound(b, h, sq, sk, d)[0],
        "fwd_library_ms": lib_fwd_ms,
        "bwd_ms": cuda_ms(bwd, iters=50),
        "bwd_device_ms": device_ms(bwd, iters=50),
        "bwd_bound_ms": flash_bwd_bound(b, h, sq, sk, d)[0],
        "bwd_library_ms": library_flash_fwd_bwd_ms(q, k, v, do, 0.0)
        - lib_fwd_ms}))


# Backward kernel against its plain version. fp32: the same fp32 arithmetic
# with exp and the three sums in another order; dq/dk/dv reach ~10 at
# these inputs, so a few fp32 ulps of that scale: atol = rtol = 1e-4.
# bf16: on top of that, dS and p are rounded to bf16 before three of the
# products, and a last-bit difference in fp32 can flip single roundings,
# then the output's own bf16 rounding: a few bf16 ulps, atol = rtol = 2^-6.
TOL_BWD_FP32 = 1e-4
TOL_BWD_BF16 = 2.0 ** -6
# AdamW kernel against its plain version: both round each operation once
# in the same order with IEEE sqrt and division, so they should agree to
# the bit; 1e-7 absolute on parameters of magnitude <= 1 allows one ulp.
TOL_ADAMW = 1e-7


def bwd_bound(b, s, d, num_heads, elem=2):
    head_dim = d // num_heads
    nbytes = (b * s * 3 * d * elem + 2 * b * s * d * elem
              + b * num_heads * s * 4 + 3 * b * s * d * elem)
    flops = 10 * b * num_heads * s * s * head_dim
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes, flops


def library_attention_bwd_ms(qkv, dout, num_heads, timer=None) -> float:
    """The backward of `F.scaled_dot_product_attention` through autograd,
    timed as (forward + backward) less forward by `timer` (host-paced
    `cuda_ms` by default, or `device_ms`): a yardstick only."""
    timer = timer or cuda_ms
    b, s, three_d = qkv.shape
    d = three_d // 3
    q, k, v = (t.contiguous().requires_grad_(True) for t in qkv.view(
        b, s, 3, num_heads, d // num_heads).permute(2, 0, 3, 1, 4).unbind(0))
    g = dout.view(b, s, num_heads, d // num_heads).transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(q, k, v)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (q, k, v), g)

    return timer(fwd_bwd, iters=20) - timer(fwd, iters=20)


def phase_preset_attention_timing(smi: str) -> None:
    """#1 at vit_tiny_16_224's B = 1 (the sorter loop) and B = 8 (its eval
    batch) and #2 at its B = 8, bf16: held device ms and host-paced ms
    beside the byte bound, the plain versions and SDPA on the same
    operands (for #2 SDPA's forward + backward less its forward)."""
    cfg = PRESETS["vit_tiny_16_224"]
    d, h, s = cfg.embed_dim, cfg.num_heads, cfg.seq_len
    ea = encoder_attention
    for b in (1, 8):
        qkv = seeded_qkv(b, s, d, torch.bfloat16, seed=40 + b)
        calls = {"kernel": lambda: ea.encoder_attention_fwd(qkv, h),
                 "library": lambda: library_attention(qkv, h)}
        held = {k: device_ms(fn, iters=100) for k, fn in calls.items()}
        paced = {k: cuda_ms(fn, iters=200) for k, fn in calls.items()}
        bound_ms, bound_by, nbytes, flops = attention_bound(b, s, d, h)
        log(json.dumps({
            "timing": "encoder_attention_fwd", "preset": "vit_tiny_16_224",
            "B": b, "S": s, "D": d, "H": h, "dtype": "bfloat16",
            "device_ms": held["kernel"], "ms": paced["kernel"],
            "plain_ms": cuda_ms(lambda: ea.encoder_attention_fwd_plain(
                qkv, h), iters=50),
            "library_device_ms": held["library"],
            "library_ms": paced["library"], "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "flops": flops,
            "device_bound_share": bound_ms / held["kernel"],
            "device_factor": held["kernel"] / held["library"],
            "card": smi}))
        if b != 8:
            continue
        out, lse = ea.encoder_attention_fwd(qkv, h)
        gen = torch.Generator().manual_seed(41)
        dout = torch.randn(b, s, d, generator=gen).to(torch.bfloat16).cuda()

        def bwd():
            return ea.encoder_attention_bwd(qkv, out, dout, lse, h)

        dev = device_ms(bwd, iters=50)
        lib_dev = library_attention_bwd_ms(qkv, dout, h, timer=device_ms)
        bound_ms, bound_by, nbytes, flops = bwd_bound(b, s, d, h)
        log(json.dumps({
            "timing": "encoder_attention_bwd", "preset": "vit_tiny_16_224",
            "B": b, "S": s, "D": d, "H": h, "dtype": "bfloat16",
            "device_ms": dev, "ms": cuda_ms(bwd, iters=50),
            "plain_ms": cuda_ms(lambda: ea.encoder_attention_bwd_plain(
                qkv, out, dout, lse, h), iters=5),
            "library_device_ms": lib_dev,
            "library_ms": library_attention_bwd_ms(qkv, dout, h),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "flops": flops, "device_bound_share": bound_ms / dev,
            "device_factor": dev / lib_dev, "card": smi}))


# (B, S, D, H) at the edges of #2's tiles of 64 queries and 64 keys (one
# row; one short of, at and one past a tile; two tiles), ViT-L/16@384's
# S = 577 at its width, the presets' shapes and the detection demo's
BWD_EDGE_CASES = [(2, 1, 128, 2), (2, 63, 128, 2), (2, 64, 128, 2),
                  (2, 65, 128, 2), (2, 128, 128, 2), (2, 577, 1024, 16),
                  *PRESET_ENC_SHAPES.values(), DEMO_ENC_SHAPE]


def phase_bwd_checks(cfg) -> dict:
    d, h, s = cfg.embed_dim, cfg.num_heads, cfg.seq_len
    cases = [(32, s, d, h, torch.bfloat16), (32, s, d, h, torch.float32),
             (1, s, d, h, torch.bfloat16), (1, s, d, h, torch.float32),
             (3, 17, 128, 2, torch.bfloat16), (3, 17, 128, 2, torch.float32)]
    cases += [(*shape, dtype) for shape in BWD_EDGE_CASES
              for dtype in (torch.bfloat16, torch.float32)]
    errs = {}
    for i, (b, s_, d_, h_, dtype) in enumerate(cases):
        qkv = seeded_qkv(b, s_, d_, dtype, seed=200 + i)
        out, lse = encoder_attention.encoder_attention_fwd_plain(qkv, h_)
        gen = torch.Generator().manual_seed(300 + i)
        dout = torch.randn(b, s_, d_, generator=gen).to(dtype).cuda()
        got = encoder_attention.encoder_attention_bwd(qkv, out, dout, lse, h_)
        torch.cuda.synchronize()
        ref = encoder_attention.encoder_attention_bwd_plain(qkv, out, dout,
                                                            lse, h_)
        tol = TOL_BWD_FP32 if dtype == torch.float32 else TOL_BWD_BF16
        key = f"B{b}_S{s_}_D{d_}_H{h_}_{str(dtype).split('.')[-1]}"
        rec = {"check": "encoder_attention_bwd", "case": key}
        for name, x, r in zip(("dq", "dk", "dv"), got, ref):
            check(x.shape == r.shape and x.dtype == r.dtype,
                  f"{name} shape/dtype at {key}")
            check(bool(torch.isfinite(x.float()).all()),
                  f"non-finite {name} at {key}")
            rec[f"max_abs_err_{name}"] = max_err(x, r)
            rec[f"max_abs_{name}"] = float(r.float().abs().max())
            ok = bool(((x.float() - r.float()).abs()
                       <= tol + tol * r.float().abs()).all())
            check(ok, f"encoder_attention_bwd {name} disagrees at {key}: "
                      f"{rec[f'max_abs_err_{name}']}")
        log(json.dumps(rec))
        errs[key] = max(rec[f"max_abs_err_{n}"] for n in ("dq", "dk", "dv"))

    timings = {}
    for b in (1, 32):
        qkv = seeded_qkv(b, s, d, torch.bfloat16, seed=9)
        out, lse = encoder_attention.encoder_attention_fwd(qkv, h)
        gen = torch.Generator().manual_seed(10)
        dout = torch.randn(b, s, d, generator=gen).to(torch.bfloat16).cuda()
        ms = cuda_ms(lambda: encoder_attention.encoder_attention_bwd(
            qkv, out, dout, lse, h), iters=50 if b == 1 else 20)
        dev_ms = device_ms(lambda: encoder_attention.encoder_attention_bwd(
            qkv, out, dout, lse, h), iters=50 if b == 1 else 20)
        plain_ms = cuda_ms(lambda: encoder_attention.encoder_attention_bwd_plain(
            qkv, out, dout, lse, h), iters=5)
        library_ms = library_attention_bwd_ms(qkv, dout, h)
        bound_ms, bound_by, nbytes, flops = bwd_bound(b, s, d, h)
        timings[b] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by}
        log(json.dumps({
            "timing": "encoder_attention_bwd", "B": b, "S": s, "D": d,
            "H": h, "dtype": "bfloat16", "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "flops": flops,
            **shares(ms, bound_ms, library_ms),
        }))
    return {"max_abs_err": errs[f"B32_S{s}_D{d}_H{h}_bfloat16"],
            **timings[32]}


# Save-probs kernels (#5, #6) against their plain versions. O and the
# gradients: the limits of #1 and #2 (the same arithmetic in another
# summation order; bf16 roundings of P and dS that can flip). P is bf16 on
# both sides, and the kernel sums l with a running rescale while the plain
# version sums exp(s - m) after the max: a few fp32 ulps of p / l, which
# can flip P's bf16 rounding: one bf16 ulp, 2^-8 to 2^-7 relative.
TOL_BF16_ULP = 2.0 ** -7


def savep_bound(b, s, d, num_heads, backward: bool):
    """#5: qkv read, O and P written, 4*B*H*S^2*d FLOPs. #6: qkv, P and dO
    read, dq, dk and dv written, 8*B*H*S^2*d FLOPs (dP, dq, dk, dv)."""
    head_dim = d // num_heads
    p_bytes = b * num_heads * s * s * 2
    if backward:
        nbytes = b * s * 3 * d * 2 + p_bytes + b * s * d * 2 + 3 * b * s * d * 2
        flops = 8 * b * num_heads * s * s * head_dim
    else:
        nbytes = b * s * 3 * d * 2 + b * s * d * 2 + p_bytes
        flops = 4 * b * num_heads * s * s * head_dim
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes, flops


# (B, S, D, H) at the edges of #5's and #6's tiles of 64 rows and 64
# keys (one row; one short of, at and one past a tile; two tiles), ViT-B
# at B = 1, ViT-L/16@384's S = 577 at its width and the opt-in step of
# phase 17(a) (vit_tiny_16_224, 3 heads)
SAVEP_EDGE_CASES = [(2, 1, 128, 2), (2, 63, 128, 2), (2, 64, 128, 2),
                    (2, 65, 128, 2), (2, 128, 128, 2), (1, 197, 768, 12),
                    (2, 577, 1024, 16), PRESET_ENC_SHAPES["vit_tiny_16_224"]]


def phase_savep_checks(cfg) -> tuple[dict, dict]:
    """#5 and #6 against their plain versions at the bench_train microbatch
    (B=32), at B=3, at an odd shape and at the tiles' edges, bf16 and fp32;
    then both timed at B=32 beside their bounds and the library yardsticks
    of rows 1 and 2 (SDPA's forward and backward, which compute O without
    P). Returns the records of #5 and #6 at B=32 bf16."""
    d, h, s = cfg.embed_dim, cfg.num_heads, cfg.seq_len
    cases = [(32, s, d, h, torch.bfloat16), (32, s, d, h, torch.float32),
             (3, s, d, h, torch.bfloat16), (3, 17, 128, 2, torch.bfloat16),
             (3, 17, 128, 2, torch.float32), (2, 33, 128, 2, torch.float32)]
    cases += [(*shape, dtype) for shape in SAVEP_EDGE_CASES
              for dtype in (torch.bfloat16, torch.float32)]
    errs = {}
    for i, (b, s_, d_, h_, dtype) in enumerate(cases):
        key = f"B{b}_S{s_}_D{d_}_H{h_}_{str(dtype).split('.')[-1]}"
        qkv = seeded_qkv(b, s_, d_, dtype, seed=800 + i)
        out, probs = encoder_attention.encoder_attention_fwd_savep(qkv, h_)
        torch.cuda.synchronize()
        ref_out, ref_p = encoder_attention.encoder_attention_fwd_savep_plain(
            qkv, h_)
        check(out.shape == ref_out.shape and out.dtype == dtype and
              probs.shape == (b, h_, s_, s_) and probs.dtype == torch.bfloat16,
              f"save-probs forward shapes at {key}")
        check(bool(torch.isfinite(out.float()).all()), f"non-finite O {key}")
        e_out, e_p = max_err(out, ref_out), max_err(probs, ref_p)
        if dtype == torch.float32:
            ok = e_out <= TOL_FP32
        else:
            ok = bool(((out.float() - ref_out.float()).abs()
                       <= TOL_BF16 + TOL_BF16 * ref_out.float().abs()).all())
        ok_p = bool(((probs.float() - ref_p.float()).abs()
                     <= 1e-6 + TOL_BF16_ULP * ref_p.float().abs()).all())
        rec = {"check": "encoder_attention_fwd_savep", "case": key,
               "max_abs_err_out": e_out, "max_abs_err_probs": e_p,
               "probs_bits_differing": int((probs != ref_p).sum()),
               "max_abs_err_row_sum": float((probs.float().sum(-1) - 1.0)
                                            .abs().max())}
        log(json.dumps(rec))
        check(ok, f"encoder_attention_fwd_savep O disagrees at {key}: {rec}")
        check(ok_p, f"encoder_attention_fwd_savep P disagrees at {key}: {rec}")

        gen = torch.Generator().manual_seed(900 + i)
        dout = torch.randn(b, s_, d_, generator=gen).to(dtype).cuda()
        got = encoder_attention.encoder_attention_bwd_savep(qkv, ref_p, dout,
                                                            h_)
        torch.cuda.synchronize()
        ref = encoder_attention.encoder_attention_bwd_savep_plain(
            qkv, ref_p, dout, h_)
        tol = TOL_BWD_FP32 if dtype == torch.float32 else TOL_BWD_BF16
        rec = {"check": "encoder_attention_bwd_savep", "case": key}
        for name, x, r in zip(("dq", "dk", "dv"), got, ref):
            check(x.shape == r.shape and x.dtype == r.dtype,
                  f"{name} shape/dtype at {key}")
            check(bool(torch.isfinite(x.float()).all()),
                  f"non-finite {name} at {key}")
            rec[f"max_abs_err_{name}"] = max_err(x, r)
            rec[f"max_abs_{name}"] = float(r.float().abs().max())
            check(bool(((x.float() - r.float()).abs()
                        <= tol + tol * r.float().abs()).all()),
                  f"encoder_attention_bwd_savep {name} disagrees at {key}: "
                  f"{rec}")
        log(json.dumps(rec))
        errs[key] = (e_out, max(rec[f"max_abs_err_{n}"]
                                for n in ("dq", "dk", "dv")))

    b = 32
    qkv = seeded_qkv(b, s, d, torch.bfloat16, seed=14)
    gen = torch.Generator().manual_seed(15)
    dout = torch.randn(b, s, d, generator=gen).to(torch.bfloat16).cuda()
    _, probs = encoder_attention.encoder_attention_fwd_savep(qkv, h)
    recs = []
    for backward in (False, True):
        if backward:
            ms = cuda_ms(lambda: encoder_attention.encoder_attention_bwd_savep(
                qkv, probs, dout, h), iters=20)
            plain_ms = cuda_ms(
                lambda: encoder_attention.encoder_attention_bwd_savep_plain(
                    qkv, probs, dout, h), iters=5)
            library_ms = library_attention_bwd_ms(qkv, dout, h)
        else:
            ms = cuda_ms(lambda: encoder_attention.encoder_attention_fwd_savep(
                qkv, h), iters=20)
            plain_ms = cuda_ms(
                lambda: encoder_attention.encoder_attention_fwd_savep_plain(
                    qkv, h), iters=5)
            library_ms = cuda_ms(lambda: library_attention(qkv, h), iters=50)
        bound_ms, bound_by, nbytes, flops = savep_bound(b, s, d, h, backward)
        name = ("encoder_attention_bwd_savep" if backward
                else "encoder_attention_fwd_savep")
        rec = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "max_abs_err": errs[f"B32_S{s}_D{d}_H{h}_bfloat16"][
                   int(backward)]}
        log(json.dumps({"timing": name, "B": b, "S": s, "D": d, "H": h,
                        "dtype": "bfloat16", **rec, "bytes": nbytes,
                        "flops": flops, **shares(ms, bound_ms, library_ms),
                        "library": "SDPA, O without P"}))
        recs.append(rec)
    return recs[0], recs[1]


# The dropout branches of #1, #2, #5 and #6 against their plain versions,
# which draw the same Philox mask: the limits of the kernels without
# dropout (the kept probabilities are scaled by 1/0.9, the same arithmetic
# in another summation order, the same bf16 roundings that can flip).
ENC_DROPOUT_NAMES = ("encoder_attention_fwd", "encoder_attention_bwd",
                     "encoder_attention_fwd_savep",
                     "encoder_attention_bwd_savep")


def encoder_mask_probe(b, s, h, seed, device="cuda", offsets=None):
    """Recover the keep mask each launch of #1, #2, #5 and #6 used.

    q = 0 makes p uniform (1/S); k = v = I in each head's 64 columns (S <=
    64) read the probabilities back. #1 and #5: O[i, j] = keep(i, j) /
    (S·keep_prob). The backwards with dO = e_i (row i one-hot): dv[j, i] =
    p_v[i, j], the dk/dv launch's mask; with dO = 1: dq[i, j] = p (keep(i,
    j)/keep_prob - delta_i) / 8, the dq launch's, decoded against delta_i =
    sum_j O[i, j]. `offsets` = (b0, H, h0) as `mask_probe`'s. Returns
    mismatches against `keep_mask` per launch."""
    from arsvt_tpu_torch.ops.dropout import keep_mask

    d = h * 64
    kp = 1.0 - DROPOUT_RATE
    eye = torch.zeros(s, 64, device=device)
    eye[:, :s] = torch.eye(s, device=device)
    head = eye.repeat(1, h)  # (S, D): I in every head's columns
    qkv = torch.cat([torch.zeros(s, d, device=device), head, head], dim=1)
    qkv = qkv.expand(b, s, 3 * d).contiguous()
    one_hot = head.expand(b, s, d).contiguous()
    ones = torch.ones(b, s, d, device=device)
    kw = dict(dropout_rate=DROPOUT_RATE, seed=seed, offsets=offsets)
    ea = encoder_attention
    o, lse = ea.encoder_attention_fwd(qkv, h, **kw)
    _, _, dv = ea.encoder_attention_bwd(qkv, o, one_hot, lse, h, **kw)
    dq, _, _ = ea.encoder_attention_bwd(qkv, o, ones, lse, h, **kw)
    o_p, probs = ea.encoder_attention_fwd_savep(qkv, h, **kw)
    _, _, dv_p = ea.encoder_attention_bwd_savep(qkv, probs, one_hot, h, **kw)
    dq_p, _, _ = ea.encoder_attention_bwd_savep(qkv, probs, ones, h, **kw)
    if device == "cuda":
        torch.cuda.synchronize()
    want = keep_mask(seed, b, h, s, s, DROPOUT_RATE, device, offsets=offsets)

    def heads(x):  # (B, S, D) -> (B, H, S, S): each head's first S columns
        return x.view(b, s, h, 64).permute(0, 2, 1, 3)[..., :s]

    def dq_mask(dq_, o_):
        delta = heads(o_).sum(dim=-1, keepdim=True)
        return (heads(dq_) * 8.0 * s + delta) * kp > 0.5

    got = {"fwd": heads(o) > 0,
           "bwd_dq": dq_mask(dq, o),
           "bwd_dkdv": heads(dv).transpose(-1, -2) > 0,
           "savep_fwd": heads(o_p) > 0,
           "savep_bwd_dq": dq_mask(dq_p, o_p),
           "savep_bwd_dkdv": heads(dv_p).transpose(-1, -2) > 0}
    out = {k: int((v != want).sum()) for k, v in got.items()}
    out["savep_probs_not_uniform"] = int(
        (probs.float() != torch.tensor(1.0 / s).bfloat16().float()).sum())
    return out


def _dropout_case(cfg_case, i, dtype, rate):
    """One kernel-vs-plain comparison of #1/#2 and #5/#6 at (B, S, D, H) in
    `dtype` with dropout `rate`; returns the record."""
    b, s, d, h = cfg_case
    ea = encoder_attention
    kw = dict(dropout_rate=rate, seed=DROPOUT_SEED)
    key = f"B{b}_S{s}_D{d}_H{h}_{str(dtype).split('.')[-1]}_rate{rate}"
    qkv = seeded_qkv(b, s, d, dtype, seed=1200 + i)
    gen = torch.Generator().manual_seed(1300 + i)
    dout = torch.randn(b, s, d, generator=gen).to(dtype).cuda()
    rec = {"check": "encoder attention with dropout", "case": key}
    tol_o = TOL_FP32 if dtype == torch.float32 else TOL_BF16
    tol_g = TOL_BWD_FP32 if dtype == torch.float32 else TOL_BWD_BF16

    def hold(name, x, r, tol):
        check(x.shape == r.shape and x.dtype == r.dtype,
              f"{name} shape/dtype at {key}")
        check(bool(torch.isfinite(x.float()).all()),
              f"non-finite {name} at {key}")
        rec[f"max_abs_err_{name}"] = max_err(x, r)
        ok = bool(((x.float() - r.float()).abs()
                   <= tol + tol * r.float().abs()).all())
        check(ok, f"{name} disagrees with its plain version at {key}: "
                  f"{rec[f'max_abs_err_{name}']}")

    out, lse = ea.encoder_attention_fwd(qkv, h, **kw)
    torch.cuda.synchronize()
    ref_out, ref_lse = ea.encoder_attention_fwd_plain(qkv, h, rate,
                                                       DROPOUT_SEED)
    hold("fwd_out", out, ref_out, tol_o)
    rec["max_abs_err_fwd_lse"] = max_err(lse, ref_lse)
    check(rec["max_abs_err_fwd_lse"] <= TOL_LSE, f"lse at {key}: {rec}")
    got = ea.encoder_attention_bwd(qkv, ref_out, dout, ref_lse, h, **kw)
    torch.cuda.synchronize()
    ref = ea.encoder_attention_bwd_plain(qkv, ref_out, dout, ref_lse, h,
                                         rate, DROPOUT_SEED)
    for name, x, r in zip(("dq", "dk", "dv"), got, ref):
        hold(f"bwd_{name}", x, r, tol_g)

    out_p, probs = ea.encoder_attention_fwd_savep(qkv, h, **kw)
    torch.cuda.synchronize()
    ref_out_p, ref_p = ea.encoder_attention_fwd_savep_plain(qkv, h, rate,
                                                             DROPOUT_SEED)
    hold("savep_fwd_out", out_p, ref_out_p, tol_o)
    rec["max_abs_err_savep_probs"] = max_err(probs, ref_p)
    check(bool(((probs.float() - ref_p.float()).abs()
                <= 1e-6 + TOL_BF16_ULP * ref_p.float().abs()).all()),
          f"save-probs P at {key}: {rec}")
    got = ea.encoder_attention_bwd_savep(qkv, ref_p, dout, h, **kw)
    torch.cuda.synchronize()
    ref = ea.encoder_attention_bwd_savep_plain(qkv, ref_p, dout, h, rate,
                                               DROPOUT_SEED)
    for name, x, r in zip(("dq", "dk", "dv"), got, ref):
        hold(f"savep_bwd_{name}", x, r, tol_g)
    log(json.dumps(rec))
    return rec


def phase_encoder_dropout_checks(cfg) -> dict:
    """#1, #2, #5 and #6 with dropout 0.1 against their plain versions at
    the bench_train microbatch (B=32), one row past a 64-row tile (S = 65),
    an odd shape and the presets' microbatches, bf16 and fp32; the probe
    of each launch's mask; then each timed at B=32 in bf16 with dropout
    0.1 beside dropout 0. Returns {kernel name: record} at B=32 bf16 with
    dropout."""
    d, h, s = cfg.embed_dim, cfg.num_heads, cfg.seq_len
    cases = [((32, s, d, h), torch.bfloat16), ((32, s, d, h), torch.float32),
             ((3, 17, 128, 2), torch.bfloat16),
             ((3, 17, 128, 2), torch.float32),
             ((2, 65, 128, 2), torch.bfloat16),
             ((2, 65, 128, 2), torch.float32)]
    cases += [(c, dt) for c in PRESET_ENC_SHAPES.values()
              for dt in (torch.bfloat16, torch.float32)]
    recs = [_dropout_case(c, i, dt, DROPOUT_RATE)
            for i, (c, dt) in enumerate(cases)]
    b32 = recs[0]

    # one process, then a ViT-B TP rank's heads 6.. of 12 at rows 2..; then
    # vit_small_16_224's 6 heads at its microbatch (the probe reads S <= 64)
    for b_, h_, offsets in ((4, 3, None), (4, 3, (2, 12, 6)), (8, 6, None)):
        mismatches = encoder_mask_probe(b_, 64, h_, DROPOUT_SEED,
                                        offsets=offsets)
        log(json.dumps({"check": "encoder attention dropout mask probe",
                        "shape": [b_, h_, 64, 64], "offsets": offsets,
                        "rate": DROPOUT_RATE, "mismatches": mismatches}))
        check(all(v == 0 for v in mismatches.values()),
              f"an encoder-attention kernel's dropout mask differs from "
              f"keep_mask at offsets {offsets}: {mismatches}")

    b = 32
    ea = encoder_attention
    qkv = seeded_qkv(b, s, d, torch.bfloat16, seed=18)
    gen = torch.Generator().manual_seed(19)
    dout = torch.randn(b, s, d, generator=gen).to(torch.bfloat16).cuda()
    out, lse = ea.encoder_attention_fwd(qkv, h)
    _, probs = ea.encoder_attention_fwd_savep(qkv, h)
    calls = {
        "encoder_attention_fwd": (
            lambda kw: ea.encoder_attention_fwd(qkv, h, **kw),
            lambda r: ea.encoder_attention_fwd_plain(qkv, h, r, DROPOUT_SEED),
            lambda r: F.scaled_dot_product_attention(
                *qkv.view(b, s, 3, h, d // h).permute(2, 0, 3, 1, 4)
                .unbind(0), dropout_p=r),
            attention_bound(b, s, d, h)),
        "encoder_attention_bwd": (
            lambda kw: ea.encoder_attention_bwd(qkv, out, dout, lse, h, **kw),
            lambda r: ea.encoder_attention_bwd_plain(qkv, out, dout, lse, h,
                                                     r, DROPOUT_SEED),
            None, bwd_bound(b, s, d, h)),
        "encoder_attention_fwd_savep": (
            lambda kw: ea.encoder_attention_fwd_savep(qkv, h, **kw),
            lambda r: ea.encoder_attention_fwd_savep_plain(qkv, h, r,
                                                           DROPOUT_SEED),
            None, savep_bound(b, s, d, h, False)),
        "encoder_attention_bwd_savep": (
            lambda kw: ea.encoder_attention_bwd_savep(qkv, probs, dout, h,
                                                      **kw),
            lambda r: ea.encoder_attention_bwd_savep_plain(
                qkv, probs, dout, h, r, DROPOUT_SEED),
            None, savep_bound(b, s, d, h, True)),
    }
    library_bwd_ms = library_attention_bwd_ms(qkv, dout, h)
    result = {}
    for name, (kernel, plain, library, bound) in calls.items():
        times = {}
        for rate in (0.0, DROPOUT_RATE):
            kw = dict(dropout_rate=rate, seed=DROPOUT_SEED)
            times[rate] = cuda_ms(lambda: kernel(kw), iters=20)
        plain_ms = cuda_ms(lambda: plain(DROPOUT_RATE), iters=3, warmup=1)
        if library is not None:
            library_ms = cuda_ms(lambda: library(DROPOUT_RATE), iters=20)
        elif name == "encoder_attention_bwd":
            library_ms = library_bwd_ms
        else:
            library_ms = None  # SDPA computes no P: no like-for-like call
        bound_ms, bound_by, nbytes, flops = bound
        err = max(v for k, v in b32.items() if k.startswith(
            {"encoder_attention_fwd": "max_abs_err_fwd_out",
             "encoder_attention_bwd": "max_abs_err_bwd_",
             "encoder_attention_fwd_savep": "max_abs_err_savep_fwd_out",
             "encoder_attention_bwd_savep": "max_abs_err_savep_bwd_"}[name]))
        rec = {"ms": times[DROPOUT_RATE], "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "max_abs_err": err}
        log(json.dumps({"timing": f"{name} dropout", "B": b, "S": s,
                        "D": d, "H": h, "dtype": "bfloat16",
                        "dropout_rate": DROPOUT_RATE, **rec,
                        "ms_dropout_0": times[0.0],
                        "slowdown": times[DROPOUT_RATE] / times[0.0],
                        "bytes": nbytes, "flops": flops,
                        **shares(times[DROPOUT_RATE], bound_ms,
                                 library_ms)}))
        result[name] = rec
    return result


# Fused-MLP kernels (#8, #9) against their plain versions (cuBLAS fp32
# products of the same operands, TF32 off), each output within a share of
# the plain result's largest magnitude. fp32: the same fp32 sums in
# another order over up to 6,304 rows: 1e-5. u and du are rounded to bf16
# on both sides; another summation order flips single roundings by one
# bf16 ulp (2^-7 relative at most), and the two fp32 sums themselves differ
# by a few fp32 ulps of the sum of |x w1| terms (the tensor cores'
# accumulation against cuBLAS's), which near u = 0 is several bf16 ulps:
# u is held per element to one bf16 ulp plus 2^-10 absolute (u is O(1)).
# Each flip of du moves dx, dw1 and db1 by 2^-8 of one |x du| term, a
# share of their largest value that grows as n shrinks (measured 3.1e-4
# on dw1 at n = 594): 1e-3. bf16: out, dx and h are rounded to bf16 too:
# 2^-7.
TOL_MLP_FP32 = 1e-5
TOL_MLP_FP32_DU = 1e-3
TOL_MLP_BF16 = 2.0 ** -7
TOL_U_ABS = 2.0 ** -10
# (n, D, M) of phase 17's opt-in steps: a microbatch of 8 x 197 rows of
# vit_tiny_16_224 and of vit_small_16_224 (D = 192 is not a multiple of
# the bf16 kernels' 128-wide tile)
PRESET_MLP_SHAPES = [(1576, 192, 768), (1576, 384, 1536)]
# (n, D, M): the bench_train microbatch (32 x 197 rows of ViT-B), three
# images of it, and three of the DeiT-400 backbone's MLP; ViT-L's
# microbatch (16 x 577 rows, D = 1,024; fp32 in two slices of 512
# columns) and an odd n at that width; one image of ViT-H/14's MLP (D =
# 1,280, M = 5,120), past the fp32 row-tile kernel's bound on D, which
# bf16 does not have; widths that are not multiples of 8 (the kernels'
# ragged route), in both dtypes; then the opt-in steps of phase 17
MLP_CASES = [(6304, 768, 3072, torch.bfloat16),
             (6304, 768, 3072, torch.float32),
             (591, 768, 3072, torch.bfloat16),
             (594, 400, 1600, torch.bfloat16),
             (594, 400, 1600, torch.float32),
             (37, 128, 256, torch.float32),
             (9232, 1024, 4096, torch.bfloat16),
             (9232, 1024, 4096, torch.float32),
             (1731, 1024, 4096, torch.bfloat16),
             (257, 1280, 5120, torch.bfloat16),
             (197, 12, 20, torch.bfloat16),
             (197, 12, 20, torch.float32),
             (591, 37, 75, torch.bfloat16),
             (591, 37, 75, torch.float32),
             (1234, 100, 300, torch.bfloat16),
             (1234, 100, 300, torch.float32),
             *((n, d, m, dt) for n, d, m in PRESET_MLP_SHAPES
               for dt in (torch.bfloat16, torch.float32))]
# (n, D, M) timed on the ragged route in bf16, beside the aligned
# neighbour it rounds up to
MLP_RAGGED_TIMED = [(6304, 770, 3070), (6304, 776, 3072)]
# (n, D, M) timed: the bench_train microbatch (its record is the kernels
# line's) and ViT-L's
MLP_TIMED = [(6304, 768, 3072), (9232, 1024, 4096)]


def mlp_limit(ref, dtype, du: bool = False) -> float:
    if dtype == torch.bfloat16:
        rel = TOL_MLP_BF16
    else:
        rel = TOL_MLP_FP32_DU if du else TOL_MLP_FP32
    return rel * float(ref.float().abs().max())


def seeded_mlp(n, d, m, dtype, seed):
    """x, w1, b1, w2, b2 on the card (LeCun weights, small biases)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=gen)
    w1 = torch.randn(d, m, generator=gen) * d ** -0.5
    b1 = torch.randn(m, generator=gen) * 0.1
    w2 = torch.randn(m, d, generator=gen) * m ** -0.5
    b2 = torch.randn(d, generator=gen) * 0.1
    return tuple(t.to(dtype).cuda() for t in (x, w1, b1, w2, b2))


def mlp_bound(n, d, m, backward: bool, elem=2):
    """#8: x, w1, w2 read and out written in T, u written in bf16, the
    fp32 biases read; 4*n*D*M FLOPs. #9: x, u, w1, w2 and dO read, dx
    written, dw1, db1, dw2 written in fp32; 8*n*D*M FLOPs."""
    if backward:
        nbytes = ((2 * n * d + 2 * d * m) * elem + n * m * 2 + n * d * elem
                  + (2 * d * m + m) * 4)
        flops = 8 * n * d * m
    else:
        nbytes = (2 * n * d + 2 * d * m) * elem + n * m * 2 + (m + d) * 4
        flops = 4 * n * d * m
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes, flops


def library_mlp(x, w1, b1, w2, b2):
    """The port's unfused cuBLAS MLP on the same operands: a yardstick."""
    u = torch.matmul(x, w1) + b1
    return torch.matmul(F.gelu(u, approximate="tanh"), w2) + b2


def library_mlp_bwd_ms(x, w1, b1, w2, b2, dout) -> float:
    """That MLP's autograd backward, timed as (forward + backward) less
    forward: a yardstick only."""
    args = [t.detach().clone().requires_grad_(True)
            for t in (x, w1, b1, w2, b2)]

    def fwd():
        return library_mlp(*args)

    def fwd_bwd():
        torch.autograd.grad(fwd(), args, dout)

    return cuda_ms(fwd_bwd, iters=10) - cuda_ms(fwd, iters=10)


def phase_mlp_checks() -> tuple[dict, dict]:
    """#8 and #9 against their plain versions at MLP_CASES; then both timed
    at MLP_TIMED in bf16 beside their bounds and the cuBLAS MLP's forward
    and backward. Returns the records of #8 and #9 at the bench_train
    shape."""
    errs = {}
    for i, (n, d, m, dtype) in enumerate(MLP_CASES):
        key = f"n{n}_D{d}_M{m}_{str(dtype).split('.')[-1]}"
        x, w1, b1, w2, b2 = seeded_mlp(n, d, m, dtype, seed=1000 + i)
        out, u = fused_mlp.fused_mlp_fwd(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        ref_out, ref_u = fused_mlp.fused_mlp_fwd_plain(x, w1, b1, w2, b2)
        check(out.shape == (n, d) and out.dtype == dtype and
              u.shape == (n, m) and u.dtype == torch.bfloat16,
              f"fused MLP forward shapes at {key}")
        beyond = ((u.float() - ref_u.float()).abs()
                  - TOL_BF16_ULP * ref_u.float().abs())
        at = int(beyond.argmax())
        rec = {"check": "fused_mlp_fwd", "case": key,
               "max_abs_err_out": max_err(out, ref_out),
               "max_abs_out": float(ref_out.float().abs().max()),
               "max_abs_err_u": max_err(u, ref_u),
               "u_bits_differing": int((u != ref_u).sum()),
               "max_u_err_beyond_one_ulp": float(beyond.max()),
               "there_u_kernel_plain": [float(u.flatten()[at]),
                                        float(ref_u.flatten()[at])]}
        log(json.dumps(rec))
        check(bool(torch.isfinite(out.float()).all()), f"non-finite {key}")
        check(rec["max_abs_err_out"] <= mlp_limit(ref_out, dtype),
              f"fused_mlp_fwd out disagrees at {key}: {rec}")
        check(rec["max_u_err_beyond_one_ulp"] <= TOL_U_ABS,
              f"fused_mlp_fwd u disagrees at {key}: {rec}")

        gen = torch.Generator().manual_seed(1100 + i)
        dout = torch.randn(n, d, generator=gen).to(dtype).cuda()
        got = fused_mlp.fused_mlp_bwd(x, ref_u, w1, w2, dout)
        torch.cuda.synchronize()
        ref = fused_mlp.fused_mlp_bwd_plain(x, ref_u, w1, w2, dout)
        rec = {"check": "fused_mlp_bwd", "case": key}
        for name, g, r in zip(("dx", "dw1", "db1", "dw2"), got, ref):
            check(g.shape == r.shape and g.dtype == r.dtype,
                  f"{name} shape/dtype at {key}")
            check(bool(torch.isfinite(g.float()).all()),
                  f"non-finite {name} at {key}")
            rec[f"max_abs_err_{name}"] = max_err(g, r)
            rec[f"max_abs_{name}"] = float(r.float().abs().max())
            check(rec[f"max_abs_err_{name}"]
                  <= mlp_limit(r, dtype, du=name != "dw2"),
                  f"fused_mlp_bwd {name} disagrees at {key}: {rec}")
        log(json.dumps(rec))
        errs[key] = (max_err(out, ref_out),
                     max(rec[f"max_abs_err_{n_}"]
                         for n_ in ("dx", "dw1", "db1", "dw2")))

    # fp32: the row-tile kernel's bound on D (mlp_tile.cuh::max_d), and the
    # error of a launch past it; bf16 has no bound on D (ViT-H's width
    # above ran and held)
    widest = max(d for _, d, _, dt in MLP_CASES if dt == torch.bfloat16)
    bound = fused_mlp.max_d(torch.float32)
    x, w1, b1, w2, b2 = seeded_mlp(48, bound + 8, 64, torch.float32,
                                   seed=1099)
    u = torch.zeros(48, 64, dtype=torch.bfloat16, device="cuda")
    refused = []
    for call in (lambda: fused_mlp.fused_mlp_fwd(x, w1, b1, w2, b2),
                 lambda: fused_mlp.fused_mlp_bwd(x, u, w1, w2, x)):
        try:
            call()
            refused.append(False)
        except ValueError as e:
            refused.append("shared memory" in str(e))
    rec = {"check": "fused MLP width bound", "max_d_float32": bound,
           "refused_past_it": refused,
           "max_d_bfloat16": fused_mlp.max_d(torch.bfloat16),
           "widest_bfloat16_held": widest}
    log(json.dumps(rec))
    check(bound >= 1024 and all(refused) and rec["max_d_bfloat16"] is None
          and widest > 1088, f"fused MLP width bounds: {rec}")

    recs = {}
    for n, d, m in MLP_TIMED:
        recs[(n, d, m)] = _time_mlp(n, d, m, errs)
    for n, d, m in MLP_RAGGED_TIMED:
        x, w1, b1, w2, b2 = seeded_mlp(n, d, m, torch.bfloat16, seed=18)
        _, u = fused_mlp.fused_mlp_fwd(x, w1, b1, w2, b2)
        log(json.dumps({
            "timing": "fused_mlp ragged route" if d % 8 or m % 8 else
                      "fused_mlp aligned neighbour",
            "n": n, "D": d, "M": m, "dtype": "bfloat16",
            "fwd_ms": cuda_ms(lambda: fused_mlp.fused_mlp_fwd(
                x, w1, b1, w2, b2), iters=10, warmup=2),
            "bwd_ms": cuda_ms(lambda: fused_mlp.fused_mlp_bwd(
                x, u, w1, w2, x), iters=10, warmup=2)}))
    return recs[MLP_TIMED[0]]


def _time_mlp(n, d, m, errs) -> tuple[dict, dict]:
    """#8 and #9 timed at (n, D, M) in bf16; their records."""
    x, w1, b1, w2, b2 = seeded_mlp(n, d, m, torch.bfloat16, seed=16)
    gen = torch.Generator().manual_seed(17)
    dout = torch.randn(n, d, generator=gen).to(torch.bfloat16).cuda()
    _, u = fused_mlp.fused_mlp_fwd(x, w1, b1, w2, b2)
    recs = []
    for backward in (False, True):
        if backward:
            ms = cuda_ms(lambda: fused_mlp.fused_mlp_bwd(x, u, w1, w2, dout),
                         iters=10, warmup=2)
            plain_ms = cuda_ms(lambda: fused_mlp.fused_mlp_bwd_plain(
                x, u, w1, w2, dout), iters=3, warmup=1)
            library_ms = library_mlp_bwd_ms(x, w1, b1, w2, b2, dout)
        else:
            ms = cuda_ms(lambda: fused_mlp.fused_mlp_fwd(x, w1, b1, w2, b2),
                         iters=10, warmup=2)
            plain_ms = cuda_ms(lambda: fused_mlp.fused_mlp_fwd_plain(
                x, w1, b1, w2, b2), iters=3, warmup=1)
            library_ms = cuda_ms(lambda: library_mlp(x, w1, b1, w2, b2),
                                 iters=20)
        bound_ms, bound_by, nbytes, flops = mlp_bound(n, d, m, backward)
        name = "fused_mlp_bwd" if backward else "fused_mlp_fwd"
        rec = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "max_abs_err": errs[f"n{n}_D{d}_M{m}_bfloat16"][
                   int(backward)]}
        log(json.dumps({"timing": name, "n": n, "D": d, "M": m,
                        "dtype": "bfloat16", **rec, "bytes": nbytes,
                        "flops": flops, "tflop_per_s": flops / ms / 1e9,
                        **shares(ms, bound_ms, library_ms),
                        "library": "cuBLAS MLP (matmul, tanh GELU, matmul)"}))
        recs.append(rec)
    return recs[0], recs[1]


# The dropout sites' views, each (name, (B, H, R, C), (b0, H', h0)):
# residual views (B, 1, S, D) of ViT-B's training microbatch and the
# DeiT-400 detector's (one process, and the second DP rank of two), the
# DETR self-attention's probabilities (B, H, Q, Q) over 8 heads (one
# process, and the second TP rank's 4 heads), and a view of 25 heads of 16
# at a TP rank's offset 13.
MASK_CASES = [("vit_b_residual", (32, 1, 197, 768), None),
              ("vit_b_residual_dp_rank1", (16, 1, 197, 768), (16, 1, 0)),
              ("detector_residual", (32, 1, 198, 400), None),
              ("detector_residual_dp_rank1", (16, 1, 198, 400), (16, 1, 0)),
              ("detr_self_attention", (32, 8, 5, 5), None),
              ("detr_self_attention_tp_rank1", (32, 4, 5, 5), (0, 8, 4)),
              ("heads_tp_offset", (4, 12, 40, 40), (3, 25, 13)),
              # the detector's residual view at the reference recipe's
              # batch of 64 (--generalization reference)
              ("detector_residual_B64", (64, 1, 198, 400), None)]


# The mask rule's integer work an element (csrc/dropout_mask.cu::RowBits,
# the row's share hoisted): 27 32-bit multiplies (IMAD, IMAD.HI; a hi/lo
# pair fused into one IMAD.WIDE takes two issue slots, so the count
# stands) and 17 logic operations (16 three-input xors as LOP3, the
# compare). On sm_90 the multiplies run on the FMA pipe and the logic on
# the integer ALU pipe, each 64 a clock an SM (CUDA C Programming Guide,
# compute capability 9.0), and the two overlap; an SM issues 128 a clock
# (4 schedulers of 32 lanes). So the multiplies set the bound. The H100
# SXM has 132 SMs at a 1,980 MHz boost clock. The scale, the select and
# the dtype conversions are left out: the bound stays a least time.
PHILOX_MULS, PHILOX_LOGIC = 27, 17
SM_CLOCK_HZ = 1.98e9
PIPE_OPS_PER_S = 64 * 132 * SM_CLOCK_HZ
ISSUE_PER_S = 128 * 132 * SM_CLOCK_HZ


def philox_bound(elements: int, nbytes: int) -> dict:
    """The least time of drawing `elements` mask bits and moving `nbytes`:
    the larger of the bytes over 3.35 TB/s and the rule's integer work,
    itself the largest of its multiplies over the FMA pipe, its logic over
    the ALU pipe and all of it over the issue rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    pipes = {"fma_pipe_ms": PHILOX_MULS * elements / PIPE_OPS_PER_S * 1e3,
             "alu_pipe_ms": PHILOX_LOGIC * elements / PIPE_OPS_PER_S * 1e3,
             "issue_ms": (PHILOX_MULS + PHILOX_LOGIC) * elements
             / ISSUE_PER_S * 1e3}
    t_ops = max(pipes.values())
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_bound_ms": t_bytes, "int_bound_ms": t_ops,
            "int_bound_by": max(pipes, key=pipes.get), **pipes}


# The apply kernel (csrc/dropout_mask.cu::arsvt_dropout_apply) against its
# plain version (`dropout_apply_plain`, eager on the same CUDA tensors) at
# every `MASK_CASES` view, in bf16 and fp32, under both scale rules,
# forward and backward through `SiteDropout` (the plain version's through
# autograd), with +-Inf and NaN planted on every 7th element (kept and
# dropped places alike): compared as bits, so the limit is 0 differing
# elements; the mask it applies (to ones) equals `keep_mask`'s on the card
# (0 mismatches: one bool an element). The
# "div" rule is also run as a true division (`true_division`) to record
# which of the two PyTorch's x / (1 - rate) on the card is.
APPLY_DTYPES = (torch.bfloat16, torch.float32)
APPLY_TIMED = (32, 1, 198, 400)  # the detector's residual view
# Two views beside it that isolate what holds the bf16 forward back: C =
# 512 fills each 64-thread block's lanes (C / 8 = 50 of 64 at C = 400),
# and 4x the rows gives 4x the blocks in one launch, so the launch's fixed
# ramp and drain weigh a quarter as much.
APPLY_PROBES = {"full_lanes": (32, 1, 198, 512),
                "rows_x4": (128, 1, 198, 400)}


def apply_geometry(view, registers: int) -> dict:
    """The vector route's launch at `view` (csrc/dropout_mask.cu::
    launch_apply) for a kernel of `registers` a thread: threads a block,
    the share of its lanes with 8 columns, blocks, blocks resident an SM
    (sm_90: at most 32 blocks, 2,048 threads and 65,536 registers, taken
    8 a thread at a time) and waves over 132 SMs."""
    b, h, r, c = view
    units = c // 8
    threads = 256 if units >= 256 else (units + 31) // 32 * 32
    blocks = -(-units // threads) * b * h * r
    resident = min(32, 2048 // threads,
                   65536 // (-(-registers // 8) * 8 * threads))
    return {"threads": threads, "lane_share": units / (
        threads * -(-units // threads)), "blocks": blocks,
        "resident_blocks_per_sm": resident,
        "waves": blocks / (132 * resident)}


def vec_kernel_sass(sass: dict, dtype) -> dict:
    """`sass_int_ops`'s record of the apply kernel's vector route in
    `dtype`, with its FMA-pipe issue slots an element (IMAD.WIDE two, the
    other IMADs one; 8 elements a thread, its row set-up included)."""
    tag = "I13__nv_bfloat16Lb1E" if dtype == torch.bfloat16 else "IfLb1E"
    rec = next(v for k, v in sass.items() if "apply_kernel" + tag in k)
    return {**rec, "fma_slots_per_element": (
        rec["imad_hi"] + 2 * rec["imad_wide"] + rec["imad"]) / 8}


def planted(shape, dtype, seed) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(math.prod(shape), generator=gen)
    n = x[::7].numel()
    x[::7] = torch.tensor([math.inf, -math.inf, math.nan]).repeat(
        n // 3 + 1)[:n]
    return x.view(shape).to(dtype).cuda()


def differing(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements whose bits differ (NaN payloads and the sign of zero
    count)."""
    kind = torch.int16 if a.element_size() == 2 else torch.int32
    return int((a.view(kind) != b.view(kind)).sum())


def true_division(x, keep, k: float) -> torch.Tensor:
    """The site with x / k a true fp32 division: a divisor on the device
    is not the host scalar that PyTorch turns into a reciprocal product."""
    q = x.float() / torch.tensor(k, dtype=torch.float32, device=x.device)
    return torch.where(keep, q.to(x.dtype), torch.zeros_like(x))


def phase_apply_kernel_checks() -> float:
    """(a) the apply kernel against its plain version, bits, at every case,
    dtype and scale rule, forward and backward. Returns the largest
    absolute difference over them (Inf - Inf and NaN read as 0: the bits
    decide those)."""
    from arsvt_tpu_torch.ops.dropout import (
        SiteDropout,
        dropout_apply,
        dropout_apply_plain,
        keep_mask,
    )

    worst = 0.0
    for i, (name, view, offsets) in enumerate(MASK_CASES):
        applied = dropout_apply(torch.ones(view, device="cuda"),
                                DROPOUT_SEED, DROPOUT_RATE, offsets, view,
                                "mul") != 0
        mask = keep_mask(DROPOUT_SEED, *view, DROPOUT_RATE, "cuda",
                         offsets=offsets)
        rec = {"check": "dropout_apply kernel vs plain, bits", "case": name,
               "shape": view, "offsets": offsets,
               "mask_mismatches": int((applied != mask).sum()),
               "differing_fwd_bwd": {}, "true_division_differing": {}}
        for dtype in APPLY_DTYPES:
            x, g = planted(view, dtype, 2 * i), planted(view, dtype, 2 * i + 1)
            for mode in ("div", "mul"):
                args = (DROPOUT_SEED, DROPOUT_RATE, offsets, view, mode)
                want = dropout_apply_plain(x, *args)
                got = dropout_apply(x, *args)
                fwd = differing(got, want)
                xa = x.clone().requires_grad_(True)
                (ga,) = torch.autograd.grad(SiteDropout.apply(xa, *args), xa,
                                            g)
                xb = x.clone().requires_grad_(True)
                (gb,) = torch.autograd.grad(dropout_apply_plain(xb, *args),
                                            xb, g)
                key = f"{str(dtype).split('.')[-1]} {mode}"
                rec["differing_fwd_bwd"][key] = [fwd, differing(ga, gb)]
                for a, b in ((got, want), (ga, gb)):
                    worst = max(worst, float((a.float() - b.float()).abs()
                                             .nan_to_num(0.0).max()))
                if mode == "div":
                    rec["true_division_differing"][key] = differing(
                        true_division(x, mask, 1.0 - DROPOUT_RATE), want)
        torch.cuda.synchronize()
        log(json.dumps(rec))
        check(rec["mask_mismatches"] == 0 and all(
            v == [0, 0] for v in rec["differing_fwd_bwd"].values()),
            f"dropout_apply differs from its plain version at {name}: {rec}")
    return worst


def sass_int_ops(name: str) -> dict:
    """{kernel: registers, stack, local bytes and the count of each integer
    opcode and of all instructions} of library `name` (cuobjdump)."""
    import re

    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    lib = str(build.library_path(name))
    run = functools.partial(subprocess.run, capture_output=True, text=True,
                            check=True, timeout=300)
    out, kernel = {}, None
    for line in run([tool, "-res-usage", lib]).stdout.splitlines():
        name = re.search(r"Function (\S+?):", line)
        kernel = name.group(1) if name else kernel
        use = re.search(r"REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)",
                        line)
        if use and kernel:
            out[kernel] = {"registers": int(use.group(1)),
                           "stack": int(use.group(2)),
                           "local": int(use.group(3))}
    for part in run([tool, "-sass", lib]).stdout.split("Function : ")[1:]:
        ops = re.findall(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", part)
        out.setdefault(part.split()[0], {}).update(
            instructions=len(ops),
            imad_hi=sum(o.startswith("IMAD.HI") for o in ops),
            imad_wide=sum(o.startswith("IMAD.WIDE") for o in ops),
            imad=sum(o.startswith("IMAD") and not o.startswith(
                ("IMAD.HI", "IMAD.WIDE")) for o in ops),
            lop3=sum(o.startswith("LOP3") for o in ops),
            other_int=sum(o.startswith(("IADD3", "ISETP", "SEL", "SHF"))
                          for o in ops))
    return out


def phase_apply_kernel_timing(smi: str, max_abs_err: float) -> dict:
    """(b) the site at the detector's residual view, bf16 and fp32, in one
    call with CUDA events, each held on the device (`device_ms`: the
    launches queued behind a spin kernel) and host-paced: the fused
    forward (one apply launch), the backward's launch, forward + backward
    through `SiteDropout` under autograd; torch.nn.functional.dropout
    on the same tensor (other bits, the same work) forward and forward +
    backward; the plain version; both bounds; the kernels' registers,
    spills and integer opcodes. Returns the bf16 record, with (a)'s
    `max_abs_err`."""
    from arsvt_tpu_torch.ops.dropout import (
        SiteDropout,
        dropout_apply,
        dropout_apply_plain,
    )

    view, n = APPLY_TIMED, math.prod(APPLY_TIMED)
    sass = sass_int_ops("dropout_mask")
    args = (DROPOUT_SEED, DROPOUT_RATE, (0, 1, 0), view, "div")
    out = None
    for dtype in APPLY_DTYPES:
        gen = torch.Generator().manual_seed(31)
        x, g = (torch.randn(view, generator=gen).to(dtype).cuda()
                for _ in range(2))
        xr = x.clone().requires_grad_(True)
        paths = {
            "fused_fwd": lambda: dropout_apply(x, *args),
            "fused_bwd_launch": lambda: dropout_apply(g, *args),
            "fused_fwd_bwd": lambda: torch.autograd.grad(
                SiteDropout.apply(xr, *args), xr, g),
            "library_fwd": lambda: F.dropout(x, DROPOUT_RATE, training=True),
            "library_fwd_bwd": lambda: torch.autograd.grad(
                F.dropout(xr, DROPOUT_RATE, training=True), xr, g),
        }
        times = {}
        for key, fn in paths.items():  # a 1 ms hold a call: autograd's
            times[key] = {             # host time stays inside it
                "device_ms": device_ms(fn, iters=100, hold_cycles=2_000_000),
                "host_paced_ms": cuda_ms(fn, iters=100)}
        bound = philox_bound(n, 2 * n * x.element_size())
        rec = {"timing": "dropout site at the detector's residual view",
               "dtype": str(dtype), "shape": view, "elements": n,
               "times": times,
               "plain_ms": cuda_ms(lambda: dropout_apply_plain(x, *args),
                                   iters=3, warmup=1),
               **bound, "muls_logic_per_element": [PHILOX_MULS,
                                                   PHILOX_LOGIC],
               "pipe_ops_per_s": PIPE_OPS_PER_S,
               "issue_per_s": ISSUE_PER_S,
               "sm_clock_ghz": SM_CLOCK_HZ / 1e9,
               "int_bound_share": bound["int_bound_ms"]
               / times["fused_fwd"]["device_ms"],
               "card": smi}
        vec = vec_kernel_sass(sass, dtype)
        rec["sass_fma_slots_per_element"] = vec["fma_slots_per_element"]
        rec["geometry"] = apply_geometry(view, vec["registers"])
        if dtype == torch.bfloat16:
            rec["probes"] = {}
            for key, shape in APPLY_PROBES.items():
                xp = torch.randn(shape, generator=gen).to(dtype).cuda()
                pargs = (*args[:3], shape, "div")
                ms = device_ms(lambda: dropout_apply(xp, *pargs), iters=100,
                               hold_cycles=2_000_000)
                size = math.prod(shape)
                rec["probes"][key] = {
                    "shape": shape, "device_ms": ms,
                    "ns_per_k_elements": ms * 1e9 / size,
                    "int_bound_share": philox_bound(size, 4 * size)[
                        "int_bound_ms"] / ms,
                    **apply_geometry(shape, vec["registers"])}
            t1 = times["fused_fwd"]["device_ms"]
            fixed = (4 * t1 - rec["probes"]["rows_x4"]["device_ms"]) / 3
            rec.update(ns_per_k_elements=t1 * 1e9 / n,
                       launch_fixed_ms=fixed,  # t = fixed + rows x rate
                       steady_int_bound_share=bound["int_bound_ms"]
                       / (t1 - fixed))
        log(json.dumps(rec))
        if dtype == torch.bfloat16:
            out = {**rec, "ms": times["fused_fwd"]["device_ms"],
                   "host_paced_ms": times["fused_fwd"]["host_paced_ms"],
                   "library_ms": times["library_fwd"]["device_ms"],
                   "max_abs_err": max_abs_err}
    log(json.dumps({"sass": "dropout_mask", "kernels": sass}))
    return out


# Phase 3(c): the LayerNorm and GELU kernels (csrc/layernorm.cu,
# csrc/gelu_tanh.cu; port-only: JAX's are jit code that XLA fuses) against
# their plain versions (the eager chains the port ran before) on the same
# CUDA tensors.
#
# LayerNorm at every preset width (32 ... 1,024: 192, 384, 400, 768 and
# 1,024 each a count of 16-byte vectors a lane the forward and backward are
# instantiated for) and 770 (the element-wise route), 1,280, 1,536 and
# 4,096 (the block-a-row route), on 1, 197, 6,304 and 9,232 rows, x in
# bf16 and fp32, scale and bias in both, plus a row pointer off 16 bytes
# (the element-wise loads): y, mean, rstd, dx, dscale and dbias. The
# backward of both sides runs from the kernel's statistics, so it is held
# alone. Limits: the statistics and the sums are the same fp32 arithmetic
# summed in another order, so an fp32 output is held at TOL_NORM_FP32 of
# the tensor's largest magnitude; a bf16 output may flip its last rounding
# (2^-7 of the value: one bf16 ulp) on top of that. Two forward runs and
# two backward runs must each give the same bits (no atomics).
#
# GELU at the same rows x 768, 1,600, 3,072 and 4,096, and a length of
# 1,001 (the tail) and a pointer off 16 bytes (element-wise route), u and
# g in bf16 and fp32, with +Inf, -Inf and NaN planted: the kernel repeats
# the eager chain op by op, so forward and backward are held to the bit
# (NaN where the plain version gives NaN) on every route; a forward
# difference, if tanhf differs from the one PyTorch's tanh was built with,
# is counted and held to one ulp, a backward one fails. The bf16 backward
# also at all 65,536 u crossed with `GELU_GRAD_G_SPECIAL` (±0, subnormals,
# ±Inf, NaN) and seeded normals.
#
# Then each timed in bf16 (the training dtype; the weights cast) at the
# main paths' shapes: ViT-B's (6,304, 768) and (6,304, 3,072), the
# detector's (6,336, 400) and (6,336, 1,600), ViT-L's (9,232, 1,024) and
# (9,232, 4,096) rows x width: held on the device (`device_ms`) and
# host-paced, forward and backward, beside the plain version (the parent's
# eager path), the bound and the library calls F.layer_norm and
# F.gelu(approximate="tanh") with their autograd backward (timed only).
NORM_WIDTHS = (32, 192, 256, 384, 400, 768, 1024, 770, 1280, 1536, 4096)
NORM_ROWS = (1, 197, 6304, 9232)
GELU_WIDTHS = (768, 1600, 3072, 4096)
NORM_DTYPES = (torch.bfloat16, torch.float32)
GELU_ROUTES = ("table", "arithmetic")  # the bf16 forward's (ops/mlp.py)
NORM_EPS = 1e-6
TOL_NORM_FP32 = 1e-5
TOL_NORM_BF16 = 2.0 ** -7
# (rows, D, M) of phase 17's presets: a microbatch of 8 images of
# vit_tiny_16_224, vit_small_16_224 and vit_demo_8_96, and
# detector_demo_96's DETR head at B = 4 (10 queries, ffn 512); then
# detector_demo_96's backbone and head at the detection demo's B = 64, and
# deit_detector_ref's backbone and head at the reference recipe's B = 64
# (--generalization reference: 64 x 198 tokens of 400, MLP 1,600; 64 x 5
# queries, ffn 2,048)
PRESET_NORM_SHAPES = ((1576, 192, 768), (1576, 384, 1536), (1160, 192, 768),
                      (40, 192, 512), (9280, 192, 768), (640, 192, 512),
                      (12672, 400, 1600), (320, 400, 2048))
NORM_TIMED = {"vit_b": (6304, 768, 3072), "detector": (6336, 400, 1600),
              "vit_l": (9232, 1024, 4096), "serve_b1": (197, 768, 3072)}
# The bf16 GELU forward's two routes timed at rows x 3,072 from B = 1
# serving's 197 up, where `mlp_ops.TABLE_MIN_ELEMENTS` switches them
GELU_ROUTE_ROWS = (197, 394, 591, 788, 1182, 1576, 3152)
# The g each bf16 u meets in the backward's check over all inputs: ±0, the
# smallest and largest subnormals, ±Inf, NaN, then seeded normals (4 sigma)
GELU_GRAD_G_SPECIAL = (0.0, -0.0, 2.0 ** -133, -(2.0 ** -126 - 2.0 ** -133),
                       math.inf, -math.inf, math.nan)
GELU_GRAD_G_SEEDED = 57
# fp32 operations an element outside the tensor cores (tanhf counted as
# one, so a lower bound): LayerNorm forward 8, backward 17; GELU forward
# 9, backward 19
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet
LN_OPS = (8, 17)
GELU_OPS = (9, 19)


def norm_bound(nbytes: int, ops: int) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Units in the last place between two tensors of one float dtype, by
    their bit patterns in sign-magnitude order (+0 and -0 one apart); 0
    where both are NaN, 2^40 where one is."""
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[a.dtype]
    sign = 1 << (8 * a.element_size() - 1)

    def key(t):
        i = t.contiguous().view(bits).to(torch.int64)
        return torch.where(i < 0, -(i & (sign - 1)) - 1, i)

    d = (key(a) - key(b)).abs()
    nan_a, nan_b = a.isnan(), b.isnan()
    d = torch.where(nan_a & nan_b, 0, d)
    return torch.where(nan_a ^ nan_b, 2 ** 40, d)


def held(got, ref) -> dict:
    """got against ref at the limit of their dtype (see above)."""
    diff = (got.float() - ref.float()).abs()
    top = float(ref.float().abs().max())
    allowed = TOL_NORM_FP32 * top + (TOL_NORM_BF16 * ref.float().abs()
                                     if ref.dtype == torch.bfloat16 else 0)
    u = ulps(got, ref)
    return {"ok": bool((diff <= allowed).all()), "dtype": str(ref.dtype),
            "elements": ref.numel(), "max_abs_err": float(diff.max()),
            "max_rel_to_top": float(diff.max()) / max(top, 1e-30),
            "max_ulps": int(u.max()), "over_1_ulp": int((u > 1).sum())}


def ln_inputs(rows, d, xdt, sdt, gen, offset=0):
    """x (rows, d) in xdt, `offset` elements into its storage; scale, bias
    (d,) in sdt; g like x."""
    x = torch.randn(rows * d + offset, generator=gen, device="cuda") * 3
    x = (x + 0.5).to(xdt)[offset:].view(rows, d)
    scale, bias = (torch.randn(d, generator=gen, device="cuda").to(sdt)
                   for _ in range(2))
    g = torch.randn(rows, d, generator=gen, device="cuda").to(xdt)
    return x, scale, bias, g


def ln_case(rows, d, xdt, sdt, gen, offset=0) -> dict:
    """One LayerNorm case, forward and backward, each twice."""
    x, scale, bias, g = ln_inputs(rows, d, xdt, sdt, gen, offset)
    y, mean, rstd = ln_ops.layer_norm_fwd(x, scale, bias, NORM_EPS)
    fwd_again = ln_ops.layer_norm_fwd(x, scale, bias, NORM_EPS)
    yp, mp, rp = ln_ops.layer_norm_fwd_plain(x, scale, bias, NORM_EPS)
    got = ln_ops.layer_norm_bwd(x, g, scale, mean, rstd)
    again = ln_ops.layer_norm_bwd(x, g, scale, mean, rstd)
    ref = ln_ops.layer_norm_bwd_plain(x, g, scale, mean, rstd)
    out = {"y": held(y, yp), "mean": held(mean, mp), "rstd": held(rstd, rp)}
    out.update({k: held(a, b) for k, a, b in zip(("dx", "dscale", "dbias"),
                                                got, ref)})
    out["backward_bits_repeat"] = all(torch.equal(a, b)
                                      for a, b in zip(got, again))
    out["forward_bits_repeat"] = all(
        differing(a, b) == 0 for a, b in zip((y, mean, rstd), fwd_again))
    return out


def gelu_routes(dtype) -> tuple:
    """The forward's routes of the kernel in `dtype` (ops/mlp.py)."""
    return GELU_ROUTES if dtype == torch.bfloat16 else ("arithmetic",)


def gelu_case(u, g) -> dict:
    """One GELU case: the forward on each of its routes and the backward
    against the plain chains, bit for bit ("fwd" the worst route)."""
    out = {}
    fwd_ref = mlp_ops.gelu_tanh_fwd_plain(u)
    ways = [(f"fwd_{r}", mlp_ops.gelu_tanh_fwd(u, route=r), fwd_ref)
            for r in gelu_routes(u.dtype)]
    ways.append(("bwd", mlp_ops.gelu_tanh_bwd(u, g),
                 mlp_ops.gelu_tanh_bwd_plain(u, g)))
    for way, got, ref in ways:
        u_ = ulps(got, ref)
        same = (got == ref) | (got.isnan() & ref.isnan())
        diff = torch.where(same, 0.0, (got.float() - ref.float()).abs())
        out.update({f"{way}_differing": int((u_ > 0).sum()),
                    f"{way}_max_ulps": int(u_.max()),
                    f"{way}_max_abs_err": float(diff.max())})
    for k in ("differing", "max_ulps", "max_abs_err"):
        out[f"fwd_{k}"] = max(out[f"fwd_{r}_{k}"]
                              for r in gelu_routes(u.dtype))
    return out


def all_bf16() -> torch.Tensor:
    """The 65,536 bf16 values in the order of their bits read as unsigned
    16-bit integers."""
    bits = torch.arange(mlp_ops.TABLE_SIZE, dtype=torch.int32)
    signed = torch.where(bits >= mlp_ops.TABLE_SIZE // 2,
                         bits - mlp_ops.TABLE_SIZE, bits)
    return signed.to(torch.int16).view(torch.bfloat16)


def gelu_table_checks(gen) -> dict:
    """Every bf16 input through both forward routes against the plain
    chain on the card, 0 differing elements (NaN where it gives NaN); the
    table the card filled equal to that chain in index order; the two
    routes equal to the bit (NaN payloads too); a random tensor's lookup
    by `gelu_tanh_gather_plain` equal to the table route."""
    u = all_bf16().cuda()
    ref = mlp_ops.gelu_tanh_fwd_plain(u)
    builds = mlp_ops.TABLE_LAUNCHES
    got = {r: mlp_ops.gelu_tanh_fwd(u, route=r) for r in GELU_ROUTES}
    table = mlp_ops._tables[torch.cuda.current_device()]
    rec = {f"{r}_vs_plain": int((ulps(h, ref) > 0).sum())
           for r, h in got.items()}
    rec["filled_table_vs_plain"] = int((ulps(table, ref) > 0).sum())
    rec["table_vs_arithmetic_bits"] = differing(got["table"],
                                                got["arithmetic"])
    rec["nan_elements"] = int(ref.isnan().sum())
    rec["inf_elements"] = int(ref.isinf().sum())
    x = planted_u(1 << 20, torch.bfloat16, gen)[0]
    rec["gather_vs_table_route_bits"] = differing(
        mlp_ops.gelu_tanh_gather_plain(table, x),
        mlp_ops.gelu_tanh_fwd(x, route="table"))
    rec["table_launches"] = mlp_ops.TABLE_LAUNCHES
    check(all(v == 0 for k, v in rec.items()
              if k.endswith(("_plain", "_bits"))),
          f"GELU over every bf16 input: {rec}")
    check(mlp_ops.TABLE_LAUNCHES - builds <= 1,
          f"the GELU table filled more than once: {rec}")
    return rec


def gelu_grad_checks(gen) -> dict:
    """The bf16 backward over all 65,536 u, each crossed with every g of
    `GELU_GRAD_G_SPECIAL` and `GELU_GRAD_G_SEEDED` seeded normals, against
    the plain chain on the card: 0 differing elements (NaN where it gives
    NaN)."""
    u0 = all_bf16().cuda()
    g0 = torch.cat([torch.tensor(GELU_GRAD_G_SPECIAL, device="cuda"),
                    torch.randn(GELU_GRAD_G_SEEDED, generator=gen,
                                device="cuda") * 4]).to(torch.bfloat16)
    u = u0.repeat(g0.numel())
    g = g0.repeat_interleave(u0.numel())
    ref = mlp_ops.gelu_tanh_bwd_plain(u, g)
    rec = {"elements": u.numel(), "g_values": g0.numel(),
           "kernel_vs_plain": int((ulps(mlp_ops.gelu_tanh_bwd(u, g), ref)
                                   > 0).sum()),
           "nan_elements": int(ref.isnan().sum())}
    check(rec["kernel_vs_plain"] == 0,
          f"GELU backward over every bf16 input: {rec}")
    return rec


def planted_u(n, dtype, gen, offset=0):
    """n values of u (4 sigma, as a GELU input) and g, `offset` elements
    into their storage, with +Inf, -Inf and NaN planted at the start and
    the end."""
    u = torch.randn(n + offset, generator=gen, device="cuda") * 4
    specials = torch.tensor([math.inf, -math.inf, math.nan], device="cuda")
    u[offset:offset + 3] = specials
    u[-3:] = specials
    g = torch.randn(n + offset, generator=gen, device="cuda")
    return u.to(dtype)[offset:], g.to(dtype)[offset:]


def phase_norm_kernel_checks() -> dict:
    """3(c), the checks. Returns the largest forward and backward errors of
    each kernel for the kernels record."""
    gen = torch.Generator(device="cuda").manual_seed(33)
    t0 = time.perf_counter()
    worst = {"ln_fwd": 0.0, "ln_bwd": 0.0}
    cases = [(r, d, xdt, sdt, 0) for d in NORM_WIDTHS for r in NORM_ROWS
             for xdt in NORM_DTYPES for sdt in NORM_DTYPES]
    cases += [(197, 768, xdt, xdt, 1) for xdt in NORM_DTYPES]  # unaligned
    cases += [(r, d, xdt, sdt, 0) for r, d, _ in PRESET_NORM_SHAPES
              for xdt in NORM_DTYPES for sdt in NORM_DTYPES]
    by_output = {}  # (output, its dtype): ulps and errors over all cases
    for rows, d, xdt, sdt, offset in cases:
        rec = ln_case(rows, d, xdt, sdt, gen, offset)
        what = (f"LayerNorm rows={rows} D={d} x {xdt} scale {sdt} offset "
                f"{offset}")
        bad = [k for k, v in rec.items()
               if not k.endswith("_bits_repeat") and not v["ok"]]
        check(not bad, f"{what}: {bad} outside the limit: {rec}")
        check(rec["backward_bits_repeat"],
              f"{what}: two backward runs differ")
        check(rec["forward_bits_repeat"],
              f"{what}: two forward runs differ")
        worst["ln_fwd"] = max(worst["ln_fwd"], rec["y"]["max_abs_err"])
        worst["ln_bwd"] = max(worst["ln_bwd"], *(
            rec[k]["max_abs_err"] for k in ("dx", "dscale", "dbias")))
        for k, v in rec.items():
            if k.endswith("_bits_repeat"):
                continue
            a = by_output.setdefault(f"{k} {v['dtype']}", dict.fromkeys((
                "elements", "max_ulps", "over_1_ulp", "max_rel_to_top"), 0))
            a["elements"] += v["elements"]
            a["over_1_ulp"] += v["over_1_ulp"]
            for m in ("max_ulps", "max_rel_to_top"):
                a[m] = max(a[m], v[m])
    log(json.dumps({"check": "LayerNorm kernels against their plain "
                    "versions", "cases": len(cases), "rows": NORM_ROWS,
                    "widths": NORM_WIDTHS,
                    "preset_shapes": PRESET_NORM_SHAPES,
                    "by_output": by_output,
                    "tol_fp32_of_top": TOL_NORM_FP32,
                    "tol_bf16_of_value": TOL_NORM_BF16,
                    "forward_bits_repeat": True,
                    "backward_bits_repeat": True,
                    "seconds": time.perf_counter() - t0}))

    t0 = time.perf_counter()
    rec = gelu_table_checks(gen)
    log(json.dumps({"check": "GELU forward over all 65,536 bf16 inputs, "
                    "both routes, and the table", **rec,
                    "seconds": time.perf_counter() - t0}))
    t0 = time.perf_counter()
    rec = gelu_grad_checks(gen)
    log(json.dumps({"check": "GELU backward over all 65,536 bf16 inputs "
                    "crossed with special and seeded g", **rec,
                    "seconds": time.perf_counter() - t0}))
    t0 = time.perf_counter()
    worst.update(gelu_fwd=0.0, gelu_bwd=0.0)
    inputs = [(f"{r}x{w}", r * w, 0) for w in GELU_WIDTHS for r in NORM_ROWS]
    inputs += [("tail_1001", 1001, 0), ("unaligned", 197 * 768, 1)]
    inputs += [(f"{r}x{m}", r * m, 0) for r, _, m in PRESET_NORM_SHAPES]
    totals = {}
    for dtype in NORM_DTYPES:
        ways = [f"fwd_{r}" for r in gelu_routes(dtype)] + ["bwd"]
        tot = totals.setdefault(str(dtype), {"elements": 0} | {
            f"{w}_{k}": 0 for w in ways for k in ("differing", "max_ulps")})
        for name, n, offset in inputs:
            u, g = planted_u(n, dtype, gen, offset)
            rec = gelu_case(u, g)
            check(rec["fwd_max_ulps"] <= 1 and rec["bwd_differing"] == 0,
                  f"GELU {name} {dtype}: the forward more than one ulp from "
                  f"the plain chain, or the backward off it: {rec}")
            tot["elements"] += n
            for w in ways:
                tot[f"{w}_differing"] += rec[f"{w}_differing"]
                tot[f"{w}_max_ulps"] = max(tot[f"{w}_max_ulps"],
                                           rec[f"{w}_max_ulps"])
            for k in ("fwd", "bwd"):
                worst[f"gelu_{k}"] = max(worst[f"gelu_{k}"],
                                         rec[f"{k}_max_abs_err"])
    log(json.dumps({"check": "GELU kernels against the eager chains, +Inf, "
                    "-Inf and NaN planted", "inputs": [i[0] for i in inputs],
                    "by_dtype": totals,
                    "bit_equal": all(v == 0 for t in totals.values()
                                     for k, v in t.items()
                                     if k.endswith("_differing")),
                    "seconds": time.perf_counter() - t0}))
    return worst


def norm_times(fns: dict) -> dict:
    """{path: {device_ms, host_paced_ms}}: each held on the device behind
    a 1 ms spin a call (autograd's host time stays inside it) and
    host-paced."""
    return {k: {"device_ms": device_ms(fn, iters=30,
                                       hold_cycles=2_000_000),
                "host_paced_ms": cuda_ms(fn, iters=30)}
            for k, fn in fns.items()}


def phase_norm_kernel_timing(smi: str, worst: dict) -> tuple[dict, dict]:
    """3(c), the times. Returns the LayerNorm and GELU records of the
    kernels line (ViT-B's shapes, the default training path's), each
    shape's in `shapes`."""
    gen = torch.Generator(device="cuda").manual_seed(34)
    dt = torch.bfloat16
    ln_rows, gelu_rows = {}, {}
    for cell, (rows, d, m) in NORM_TIMED.items():
        x, scale, bias, g = ln_inputs(rows, d, dt, dt, gen)
        xr, sr, br = (t.clone().requires_grad_(True) for t in (x, scale,
                                                              bias))
        y_lib = F.layer_norm(xr, (d,), sr, br, NORM_EPS)
        _, mean, rstd = ln_ops.layer_norm_fwd(x, scale, bias, NORM_EPS)
        t = norm_times({
            "fwd": lambda: ln_ops.layer_norm_fwd(x, scale, bias, NORM_EPS),
            "bwd": lambda: ln_ops.layer_norm_bwd(x, g, scale, mean, rstd),
            "plain_fwd": lambda: ln_ops.layer_norm_fwd_plain(
                x, scale, bias, NORM_EPS),
            "plain_bwd": lambda: ln_ops.layer_norm_bwd_plain(
                x, g, scale, mean, rstd),
            "library_fwd": lambda: F.layer_norm(x, (d,), scale, bias,
                                                NORM_EPS),
            "library_bwd": lambda: torch.autograd.grad(
                y_lib, (xr, sr, br), g, retain_graph=True)})
        n, e = rows * d, x.element_size()
        ln_rows[cell] = {
            "rows": rows, "width": d, "times": t,
            "fwd": norm_bound(2 * n * e + 2 * d * e + 8 * rows,
                              LN_OPS[0] * n),
            "bwd": norm_bound(3 * n * e + 3 * d * e + 8 * rows,
                              LN_OPS[1] * n)}
        u = torch.randn(rows, m, generator=gen, device="cuda").mul(4).to(dt)
        gu = torch.randn(rows, m, generator=gen, device="cuda").to(dt)
        ur = u.clone().requires_grad_(True)
        h_lib = F.gelu(ur, approximate="tanh")
        t = norm_times({
            "fwd": lambda: mlp_ops.gelu_tanh_fwd(u),
            **{f"fwd_{r}": functools.partial(mlp_ops.gelu_tanh_fwd, u,
                                             route=r) for r in GELU_ROUTES},
            "bwd": lambda: mlp_ops.gelu_tanh_bwd(u, gu),
            "plain_fwd": lambda: mlp_ops.gelu_tanh_fwd_plain(u),
            "plain_bwd": lambda: mlp_ops.gelu_tanh_bwd_plain(u, gu),
            "library_fwd": lambda: F.gelu(u, approximate="tanh"),
            "library_bwd": lambda: torch.autograd.grad(
                h_lib, ur, gu, retain_graph=True)})
        n = rows * m
        gelu_rows[cell] = {
            "rows": rows, "width": m, "times": t,
            "route": mlp_ops.forward_route(u),
            "fwd": norm_bound(2 * n * e, GELU_OPS[0] * n),
            "bwd": norm_bound(3 * n * e, GELU_OPS[1] * n)}
        del x, g, xr, y_lib, u, gu, ur, h_lib
    out = []
    for name, table, errs in (("layer_norm", ln_rows, ("ln_fwd", "ln_bwd")),
                              ("gelu_tanh", gelu_rows,
                               ("gelu_fwd", "gelu_bwd"))):
        for rec in table.values():
            for way in ("fwd", "bwd"):
                t = rec["times"]
                rec[way].update(
                    device_ms=t[way]["device_ms"],
                    host_paced_ms=t[way]["host_paced_ms"],
                    plain_ms=t[f"plain_{way}"]["device_ms"],
                    library_ms=t[f"library_{way}"]["device_ms"],
                    bound_share=rec[way]["bound_ms"] / t[way]["device_ms"],
                    vs_plain=t[f"plain_{way}"]["device_ms"]
                    / t[way]["device_ms"],
                    vs_library=t[f"library_{way}"]["device_ms"]
                    / t[way]["device_ms"])
        log(json.dumps({"timing": f"{name} kernels, bf16, forward and "
                        "backward", "shapes": table, "card": smi}))
        for cell, rec in table.items():
            rec["fwd"]["registers"] = norm_registers(
                NORM_KERNEL_NAMES[name]["fwd"], rec)
            rec["bwd"]["registers"] = norm_registers(
                NORM_KERNEL_NAMES[name]["bwd"], rec)
        head = table["vit_b"]
        out.append({
            "ms": head["fwd"]["device_ms"],
            "host_paced_ms": head["fwd"]["host_paced_ms"],
            "plain_ms": head["fwd"]["plain_ms"],
            "bound_ms": head["fwd"]["bound_ms"],
            "bound_by": head["fwd"]["bound_by"],
            "library_ms": head["fwd"]["library_ms"],
            "max_abs_err": worst[errs[0]],
            "backward": {k: head["bwd"][k] for k in (
                "device_ms", "host_paced_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")} | {"max_abs_err": worst[errs[1]]},
            "shapes": {c: {w: {k: v[w][k] for k in (
                "device_ms", "host_paced_ms", "plain_ms", "bound_ms",
                "library_ms", "registers")} for w in ("fwd", "bwd")}
                for c, v in table.items()}})
    out[1]["routes"] = {c: {"route": v["route"]} | {
        r: v["times"][f"fwd_{r}"]["device_ms"] for r in GELU_ROUTES}
        for c, v in gelu_rows.items()}
    out[1]["route_crossover"] = gelu_route_times(gen)
    return out[0], out[1]


# The kernels each record's registers are read from (cuobjdump's names
# hold these): the GELU forward's arithmetic and table kernels, its
# backward; the LayerNorm forward's and backward's vector-route kernels.
NORM_KERNEL_NAMES = {
    "gelu_tanh": {"fwd": ("gelu_kernelI13__nv_bfloat16Lb0E",
                          "table_fwd_kernel"),
                  "bwd": ("gelu_kernelI13__nv_bfloat16Lb1E",)},
    "layer_norm": {"fwd": ("ln_fwd_rowsI13__nv_bfloat16Li8E",),
                   "bwd": ("ln_bwd_vecI13__nv_bfloat16",)},
}
_norm_sass: dict = {}


def norm_registers(marks, rec) -> dict:
    """{kernel: registers, stack, local bytes} of the bf16 kernels whose
    names hold `marks` (for the LayerNorm's vector routes, the
    instantiation of the record's width: kLoads 16-byte vectors a lane),
    from cuobjdump."""
    for lib in ("gelu_tanh", "layernorm"):
        if lib not in _norm_sass:
            _norm_sass[lib] = sass_int_ops(lib)
    found = {}
    for lib in _norm_sass.values():
        for k, v in lib.items():
            if any(m in k for m in marks) and "registers" in v:
                short = k.split("_cu_")[-1][8:]
                if ("ln_bwd_vec" in k or "ln_fwd_rows" in k) and \
                        f"Li8ELi{-(-rec['width'] // 256)}E" not in k:
                    continue
                found[short] = {m: v[m] for m in ("registers", "stack",
                                                  "local")}
    check(found and all(v["stack"] == 0 and v["local"] == 0
                        for v in found.values()),
          f"bf16 LayerNorm/GELU kernels {marks}: a spill or stack frame, or "
          f"none found: {found}")
    return found


def gelu_route_times(gen) -> dict:
    """The bf16 GELU forward's held device ms on each route at rows x
    3,072 (`GELU_ROUTE_ROWS`), beside the route the wrapper picks."""
    out = {}
    for rows in GELU_ROUTE_ROWS:
        u = torch.randn(rows, 3072, generator=gen, device="cuda").mul(4).to(
            torch.bfloat16)
        out[rows] = {"elements": u.numel(),
                     "picked": mlp_ops.forward_route(u)} | {
            r: device_ms(functools.partial(mlp_ops.gelu_tanh_fwd, u, route=r),
                         iters=50, hold_cycles=2_000_000)
            for r in GELU_ROUTES}
    log(json.dumps({"timing": "bf16 GELU forward by route, rows x 3,072",
                    "table_min_elements": mlp_ops.TABLE_MIN_ELEMENTS,
                    "rows": out}))
    return out


# The assignment kernel (csrc/lap.cu) against its plain version
# (`lap_rect_plain`, on the card, on the same tensors): both do JAX's
# subtractions and compares in JAX's order, so the assignments must be
# equal, ties included; the optimum is held to scipy's on the host within
# TOL_LAP_OPTIMUM relative (float64 totals of the fp32 costs). (name,
# shape (..., q, m), costs): the deit_detector_ref train step's (L, B, Q,
# M) with 1-5 real slots an image and the rest at the pad cost (ties), the
# vit_base_detector step's transposed problem (Q = 100 > M = 25: each slot
# picks its query), q = m = 64 over 256 problems, one row, and integer
# costs in {0, 1, 2, 3} with many ties.
LAP_CASES = [("deit_detector_ref", (6, 32, 5, 25), "padded"),
             ("vit_base_detector_transposed", (6, 32, 25, 100), "padded"),
             ("square_64", (256, 64, 64), "uniform"),
             ("one_row", (64, 1, 25), "uniform"),
             ("integer_ties", (6, 32, 5, 25), "integer"),
             ("integer_ties_square", (64, 16, 16), "integer")]
LAP_TIMED = "deit_detector_ref"
TOL_LAP_OPTIMUM = 1e-5


def lap_costs(shape, kind, seed) -> torch.Tensor:
    """fp32 costs on the card. "padded": uniform class + box costs in [-3,
    5) and, as the matcher pads them, every slot past an image's 1-5 real
    ones at 1e4 (on the last axis, or on the rows of a transposed
    problem); "uniform": [0, 1); "integer": {0, 1, 2, 3}."""
    rng = np.random.default_rng(seed)
    if kind == "integer":
        return torch.from_numpy(rng.integers(0, 4, shape).astype(
            np.float32)).cuda()
    cost = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    if kind == "padded":
        q, m = shape[-2:]
        real = rng.integers(1, 6, shape[:-2] + (1, 1))  # real slots an image
        pad = (np.arange(m) >= real if q <= m  # the slots on the columns
               else np.arange(q)[:, None] >= real)  # transposed: on the rows
        cost = np.where(pad, np.float32(1e4), cost * 8 - 3)
    return torch.from_numpy(np.ascontiguousarray(cost)).cuda()


def scipy_totals(cost: np.ndarray, col_for_row=None) -> np.ndarray:
    """float64 totals per problem of `col_for_row`, or of scipy's optimum."""
    flat = cost.reshape(-1, *cost.shape[-2:]).astype(np.float64)
    if col_for_row is None:
        col_for_row = matcher.lap_scipy(flat)
    picked = np.take_along_axis(
        flat, col_for_row.reshape(flat.shape[0], -1, 1), -1)
    return picked[..., 0].sum(-1)


def phase_lap_checks() -> dict:
    """The solve-only entry (``arsvt_lap_rect``) against its plain version
    on the card at `LAP_CASES`: equal assignments, the optimum scipy's;
    timed at the detector step's shape (CUDA events, host-paced and held)
    beside its bound (each cost read once, each index written once, over
    3.35 TB/s), the plain version and scipy on the host on the same costs
    (no PyTorch call solves an assignment). Returns the timed record."""
    before = matcher.SOLVE_LAUNCHES
    out = None
    for i, (name, shape, kind) in enumerate(LAP_CASES):
        cost = lap_costs(shape, kind, seed=40 + i)
        got = matcher.lap_rect(cost)
        want = matcher.lap_rect_plain(cost)
        torch.cuda.synchronize()
        host = cost.cpu().numpy()
        got_np = got.cpu().numpy()
        mismatches = int((got != want).sum())
        distinct = all(len(set(r)) == len(r) for r in
                       got_np.reshape(-1, shape[-2]).tolist())
        mine, best = scipy_totals(host, got_np), scipy_totals(host)
        rel = float(np.max(np.abs(mine - best) / np.maximum(np.abs(best),
                                                               1e-30)))
        rec = {"check": "lap solve-only entry vs lap_rect_plain",
               "case": name, "shape": shape, "costs": kind,
               "mismatches": mismatches,
               "max_rel_err_optimum_vs_scipy": rel,
               "smem_bytes_per_problem": matcher.smem_bytes(*shape[-2:])}
        if name == LAP_TIMED:
            n, q, m = math.prod(shape[:-2]), shape[-2], shape[-1]
            nbytes = n * q * m * 4 + n * q * 8
            t0 = time.perf_counter()
            for _ in range(5):
                matcher.lap_scipy(host)
            scipy_ms = (time.perf_counter() - t0) / 5 * 1e3

            def scipy_round_trip():
                idx = matcher.lap_scipy(cost.cpu().numpy())
                torch.from_numpy(idx).cuda()
                torch.cuda.synchronize()

            t0 = time.perf_counter()
            for _ in range(5):
                scipy_round_trip()
            round_trip_ms = (time.perf_counter() - t0) / 5 * 1e3
            rec.update(
                ms=cuda_ms(lambda: matcher.lap_rect(cost), iters=200),
                device_ms=device_ms(lambda: matcher.lap_rect(cost),
                                    iters=200),
                host_us=host_us(lambda: matcher.lap_rect(cost), iters=50),
                plain_ms=cuda_ms(lambda: matcher.lap_rect_plain(cost),
                                 iters=3, warmup=1),
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                bound_bytes=nbytes, library_ms=None,
                scipy_host_ms=scipy_ms,
                scipy_with_copies_ms=round_trip_ms,
                max_abs_err=float(mismatches))
            out = rec
        log(json.dumps(rec))
        check(mismatches == 0 and distinct,
              f"lap_rect differs from lap_rect_plain at {name}: {rec}")
        check(rel <= TOL_LAP_OPTIMUM,
              f"lap_rect's optimum differs from scipy's at {name}: {rec}")
    log(json.dumps({"check": "lap solve-only launches in phase 3",
                    "launches": matcher.SOLVE_LAUNCHES - before}))
    return out


# The fused entry (csrc/lap.cu::arsvt_match_layers, the main path's) against
# its plain version (`match_layers_plain`: the eager build_cost_matrix of
# each layer, lap_rect_plain and the gather) on the card. (name, (L, B, Q,
# M)): the deit_detector_ref step's shape, the vit_base_detector step's (Q
# > M: the transpose built, solved and inverted in the kernel) and one
# eval forward's single layer, on seeded detector-like inputs
# (`match_inputs`). The costs: the kernel repeats each eager op's
# arithmetic and rounding, with the softmax's and the L1's sums in the order
# PyTorch's kernels take them, so they are held at TOL_MATCH_ULPS of the
# plain costs and the pads at exactly 1e4. The assignments: equal to
# lap_rect_plain's on the kernel's own costs (ties included); where they
# differ from the plain route's, optimal under the plain costs within
# TOL_LAP_OPTIMUM of scipy's optimum.
MATCH_CASES = [("deit_detector_ref", (6, 32, 5, 25)),
               ("vit_base_detector", (6, 32, 100, 25)),
               ("eval_one_layer", (1, 32, 5, 25)),
               # phase 17(d)'s detector_demo_96 step (3 decoder layers, 10
               # queries, 25 slots), its eval forward, and the slots of
               # benchmarks/detection_generalization_demo.py (8), then
               # that demo's step and eval forward at its batch of 64
               ("detector_demo_96", (3, 4, 10, 25)),
               ("detector_demo_96_eval", (1, 4, 10, 25)),
               ("detector_demo_96_8_slots", (3, 4, 10, 8)),
               ("detection_demo_B64", (3, 64, 10, 8)),
               ("detection_demo_B64_eval", (1, 64, 10, 8)),
               # benchmarks/recipe_ablation.py's bs64_lr3e4 step and eval
               # forward (deit_detector_ref at its batch of 64)
               ("reference_recipe_B64", (6, 64, 5, 25)),
               ("reference_recipe_B64_eval", (1, 64, 5, 25))]
MATCH_TIMED = "deit_detector_ref"
MATCH_CLASSES = 7  # the presets' C + 1
TOL_MATCH_ULPS = 4


def match_inputs(shape, seed) -> tuple:
    """(layers, labels, target boxes, mask) on the card: per layer logits
    N(0, 4) (B, Q, C + 1) and sigmoid boxes (B, Q, 4); int32 labels, xyxy
    target boxes and 0-5 real slots an image (image 0 all pads, image 1
    one real target)."""
    n_layers, b, q, m = shape
    rng = np.random.default_rng(seed)

    def card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    layers = [(card((rng.standard_normal((b, q, MATCH_CLASSES)) * 2)
                    .astype(np.float32)),
               card((1 / (1 + np.exp(-rng.standard_normal((b, q, 4)))))
                    .astype(np.float32))) for _ in range(n_layers)]
    lo = rng.uniform(0.0, 0.6, (b, m, 2))
    wh = rng.uniform(0.05, 0.4, (b, m, 2))
    real = rng.integers(0, 6, (b, 1))
    real[0, 0] = 0
    real[1:2, 0] = 1
    return (layers,
            card(rng.integers(0, MATCH_CLASSES - 1, (b, m)).astype(np.int32)),
            card(np.concatenate([lo, lo + wh], -1).astype(np.float32)),
            card(np.arange(m)[None, :] < real))


def parent_match_route(layers, labels, tboxes, mask):
    """The parent's device route of `match_layers` for Q <= M: the eager
    costs of each layer, stacked, the solve-only entry and the gather."""
    with torch.no_grad():
        costs = torch.stack([matcher.build_cost_matrix(cl, bx, labels,
                                                       tboxes, mask)
                             for cl, bx in layers])
        idx = matcher.lap_rect(costs)
        m = mask.shape[1]
        real = torch.gather(mask[None].expand(len(layers), -1, -1), 2,
                            idx.clamp(max=m - 1))
        return idx, (idx < m) & real


def match_bytes(shape) -> int:
    """The fused entry's least bytes: logits and boxes read once (fp32),
    int32 labels, xyxy boxes and the mask once, the int64 slots and bool
    matches written once."""
    n_layers, b, q, m = shape
    return (n_layers * b * q * (MATCH_CLASSES + 4) * 4 + b * m * (4 + 16 + 1)
            + n_layers * b * q * (8 + 1))


def slot_totals(cost: np.ndarray, slots: np.ndarray) -> np.ndarray:
    """Each problem's total of cost (n, Q, M) over its queries' slots (n,
    Q), the queries without a slot (M) left out."""
    m = cost.shape[-1]
    picked = np.take_along_axis(cost, np.minimum(slots, m - 1)[..., None],
                                -1)[..., 0]
    return np.where(slots < m, picked, 0.0).sum(-1)


def phase_match_checks(smi: str) -> dict:
    """The fused entry at `MATCH_CASES` against its plain version; timed at
    the bench shape in one call, host-paced, held (`device_ms`) and the
    host's us a call, beside the parent's route (the eager build, the
    solve-only entry and the gather, as `parent_match_route` rebuilds it),
    the byte bound, an empty kernel's held time (the floor a launch sets)
    and the plain version; the kernels' registers and local memory
    (cuobjdump). Returns the timed record, with the solve-only entry's
    (`phase_lap_checks`) under "solve_only"."""
    solve_only = phase_lap_checks()
    before = matcher.LAUNCHES
    out = None
    for i, (name, shape) in enumerate(MATCH_CASES):
        layers, labels, tboxes, mask = match_inputs(shape, seed=60 + i)
        idx, matched, costs = matcher.assign_layers(
            layers, labels, tboxes, mask, return_costs=True)
        p_idx, _, p_costs = matcher.match_layers_plain(layers, labels,
                                                       tboxes, mask)
        own = matcher.assign_plain(costs)
        torch.cuda.synchronize()
        pad = ~mask[None, :, None, :].expand_as(costs)
        u = ulps(costs, p_costs)
        differ = (idx != p_idx).any(-1)  # problems whose assignment moved
        rec = {"check": "fused matcher vs match_layers_plain", "case": name,
               "shape": shape, "classes": MATCH_CLASSES,
               "real_slots_per_image": mask.sum(1).tolist()[:8],
               "cost_max_ulps": int(u.max()),
               "cost_entries_over_0_ulps": int((u > 0).sum()),
               "cost_max_abs_err": float((costs - p_costs).abs().max()),
               "pads_exact": bool((costs[pad] == 1e4).all()),
               "mismatches_vs_own_costs": int((idx != own).sum()),
               "matched_mismatches": int(
                   (matched != matcher._matched(idx, mask)).sum()),
               "problems_differing_from_plain_route": int(differ.sum()),
               "smem_bytes": matcher.match_smem_bytes(*shape[2:],
                                                      MATCH_CLASSES)}
        rel = 0.0
        if rec["problems_differing_from_plain_route"]:
            plain = p_costs[differ].cpu().numpy().astype(np.float64)
            mine = slot_totals(plain, idx[differ].cpu().numpy())
            best = slot_totals(plain, matcher.lap_scipy(plain))
            rel = float(np.max(np.abs(mine - best)
                               / np.maximum(np.abs(best), 1e-30)))
        rec["max_rel_err_optimum_vs_scipy_on_plain_costs"] = rel
        rec["device_ms"] = device_ms(lambda: matcher.assign_layers(
            layers, labels, tboxes, mask), iters=20, hold_cycles=2_000_000)
        if name == MATCH_TIMED:
            args = (layers, labels, tboxes, mask)

            def fused():
                return matcher.assign_layers(*args)

            def parent():
                return parent_match_route(*args)

            def empty():
                torch.cuda._sleep(0)

            nbytes = match_bytes(shape)
            times = {}
            # the parent's route is ~340 launches a call: two calls fill
            # the launch queue the hold can take, behind a 4 ms hold each
            for key, fn, iters, hold in (
                    ("fused", fused, 50, HOLD_CYCLES_PER_CALL),
                    ("parent_route", parent, 2, 8_000_000),
                    ("empty_kernel", empty, 50, HOLD_CYCLES_PER_CALL)):
                times[key] = {"device_ms": device_ms(fn, iters=iters,
                                                     hold_cycles=hold),
                              "host_paced_ms": cuda_ms(fn, iters=20),
                              "host_us": host_us(fn, iters=20)}
            sass = {k.split("_cu_")[-1]: {f: v[f] for f in
                                          ("registers", "stack", "local")}
                    for k, v in sass_int_ops("lap").items()
                    if "registers" in v}
            rec.update(times=times,
                       plain_ms=cuda_ms(lambda: matcher.match_layers_plain(
                           *args), iters=3, warmup=1),
                       bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                       bound_by="bytes", bound_bytes=nbytes,
                       library_ms=None, registers=sass, card=smi)
            out = {**rec, "ms": times["fused"]["device_ms"],
                   "host_paced_ms": times["fused"]["host_paced_ms"],
                   "host_us": times["fused"]["host_us"],
                   "parent_route_ms": times["parent_route"]["device_ms"],
                   "floor_ms": times["empty_kernel"]["device_ms"],
                   "max_abs_err": rec["cost_max_abs_err"],
                   "solve_only": solve_only}
        log(json.dumps(rec))
        check(rec["cost_max_ulps"] <= TOL_MATCH_ULPS and rec["pads_exact"],
              f"the fused matcher's costs at {name}: {rec}")
        check(rec["mismatches_vs_own_costs"] == 0
              and rec["matched_mismatches"] == 0,
              f"the fused matcher's assignments at {name}: {rec}")
        check(rel <= TOL_LAP_OPTIMUM,
              f"the fused matcher's optimum at {name}: {rec}")
    check(out["times"]["fused"]["device_ms"]
          < out["times"]["parent_route"]["device_ms"],
          f"the fused matcher is slower than the parent's route: "
          f"{out['times']}")
    log(json.dumps({"check": "fused matcher launches in phase 3",
                    "launches": matcher.LAUNCHES - before}))
    return out


def adamw_leaves(tree, gen):
    """Random (g, m, v, p) for every leaf of `tree`, on the card."""
    out = []
    for shape in (t.shape for t in tree_leaves(tree)):
        p = torch.randn(shape, generator=gen) * 0.02
        g = torch.randn(shape, generator=gen) * 1e-3
        m = torch.randn(shape, generator=gen) * 1e-4
        v = torch.rand(shape, generator=gen) * 1e-6
        out.append(tuple(t.cuda() for t in (g, m, v, p)))
    return out


def offset_leaf(n, gen, which: str):
    """Random (g, m, v, p) of n floats on the card; the operands named in
    `which` are views one float into their storage, 4 bytes past a 16-byte
    boundary."""
    vals = {"g": torch.randn(n, generator=gen) * 1e-3,
            "m": torch.randn(n, generator=gen) * 1e-4,
            "v": torch.rand(n, generator=gen) * 1e-6,
            "p": torch.randn(n, generator=gen) * 0.02}
    out = []
    for name, x in vals.items():
        if name in which:
            storage = torch.zeros(n + 1, device="cuda")
            storage[1:] = x.cuda()
            out.append(storage[1:])
        else:
            out.append(x.cuda())
    return tuple(out)


# Cycles the card is held a call while the host enqueues #7 or the fused
# torch.optim.AdamW step: 4 ms at 2 GHz, above either one's host time
# (the argument checks and pointers over 152 leaves; the optimizer's
# Python and its per-leaf lists).
ADAMW_HOLD_CYCLES = 8_000_000


def adamw_case(name, leaves, decayed, scalars, hyper) -> float:
    """#7 over `leaves` against its plain version, leaf by leaf; logs the
    case and returns its largest error."""
    work = [tuple(t.clone() for t in leaf) for leaf in leaves]
    fused_adamw.fused_adamw(scalars, *zip(*work), decayed, **hyper)
    torch.cuda.synchronize()
    err = 0.0
    for (g, m, v, p), (_, m2, v2, p2), dflag in zip(leaves, work, decayed):
        rp, rm, rv = fused_adamw.adamw_plain(
            scalars, g, m, v, p, **{**hyper, "wd": hyper["wd"] if dflag
                                    else 0.0})
        err = max(err, max_err(p2, rp), max_err(m2, rm), max_err(v2, rv))
    log(json.dumps({"check": "fused_adamw", "case": name,
                    "leaves": len(leaves),
                    "params": sum(p.numel() for *_, p in leaves),
                    "max_abs_err": err}))
    check(err <= TOL_ADAMW, f"fused_adamw disagrees with its plain version "
                            f"on {name}: {err}")
    return err


def phase_adamw_checks(cfg) -> dict:
    """#7 against its plain version on the ViT-B leaf set, odd sizes and
    two leaves that are views one float into their storage (all four
    operands: a scalar head, then float4s; p alone: mixed 16-byte phases,
    scalar throughout), and on the ViT-Tiny leaf set; then timed on the
    ViT-B leaf set, host-paced, held (device ms) and on the host alone (us
    a call), beside the fused torch.optim.AdamW step on the same
    leaves."""
    tree = init_image_classifier(cfg, 6, seed=0)
    odd = {"a": torch.zeros(7), "b": torch.zeros(1000, 3),
           "c": torch.zeros(13, 129), "d": torch.zeros(2049)}
    gen = torch.Generator().manual_seed(11)
    vit = adamw_leaves(tree, gen)
    vflags = tree_leaves(_wd_mask(tree))
    leaves = vit + adamw_leaves(odd, gen) + [
        offset_leaf(100_003, gen, "gmvp"), offset_leaf(70_001, gen, "p")]
    decayed = vflags + tree_leaves(_wd_mask(odd)) + [True, False]
    scalars = torch.tensor([0.5, 0.1, 0.001, 1e-3], device="cuda")
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.05)
    err = adamw_case("vit_base_16_224, odd sizes, offset views", leaves,
                     decayed, scalars, hyper)
    # vit_tiny_16_224's and detector_demo_96's leaf sets alone, as phase
    # 17's steps and --generalization's update them
    tiny = init_image_classifier(PRESETS["vit_tiny_16_224"], 6, seed=0)
    adamw_case("vit_tiny_16_224", adamw_leaves(tiny, gen),
               tree_leaves(_wd_mask(tiny)), scalars, hyper)
    demo = init_detector(DETECTOR_PRESETS["detector_demo_96"], seed=0)
    adamw_case("detector_demo_96", adamw_leaves(demo, gen),
               tree_leaves(_wd_mask(demo)), scalars, hyper)

    # timing on the ViT-B leaf set alone
    n_vit = sum(p.numel() for *_, p in vit)
    grads, ms_, vs, ps = (list(t) for t in zip(*vit))

    def call():
        fused_adamw.fused_adamw(scalars, grads, ms_, vs, ps, vflags, **hyper)

    ms = cuda_ms(call, iters=20)
    dev_ms = device_ms(call, iters=20, hold_cycles=ADAMW_HOLD_CYCLES)

    plain_ms = cuda_ms(lambda: fused_adamw.adamw_plain_update(
        scalars, grads, ms_, vs, ps, vflags, **hyper), iters=3, warmup=1)
    params = [p.clone().requires_grad_(True) for p in ps]
    for p, g in zip(params, grads):
        p.grad = g.clone()
    opt = torch.optim.AdamW(params, lr=1e-3, weight_decay=0.05, fused=True)
    library_ms = cuda_ms(opt.step, iters=20)
    lib_dev_ms = device_ms(opt.step, iters=20, hold_cycles=ADAMW_HOLD_CYCLES)
    nbytes = 28 * n_vit
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    rec = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": "bytes"}
    log(json.dumps({"timing": "fused_adamw", "params": n_vit,
                    "leaves": len(vit), "bytes": nbytes, **rec,
                    **shares(ms, bound_ms, library_ms),
                    "device_ms": dev_ms, "host_us": host_us(call, 20),
                    "library_device_ms": lib_dev_ms,
                    "library_host_us": host_us(opt.step, 20),
                    "device_bound_share": bound_ms / dev_ms,
                    "device_factor": dev_ms / lib_dev_ms,
                    "library": "torch.optim.AdamW(fused=True).step"}))
    return {"max_abs_err": err, **rec}


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


def phase_model(cfg, params, images, batch, name="vit_base_16_224"):
    """fp32 on the card against the CPU plain path; bf16 against fp32, for
    the preset `name`. Returns (bf16 classifier, number of CUDA forwards
    run)."""
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
    for dtype, p in (("fp32", probs32), ("bf16", probs16)):
        check(p.shape == (len(images) + len(batch), n), f"{dtype} shape")
        check(bool(np.isfinite(p).all()), f"{dtype} non-finite probs")
        check(bool(np.allclose(p.sum(-1), 1.0, atol=1e-4)),
              f"{dtype} probs do not sum to 1")
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
        "check": f"{name} classify", "images": len(probs32),
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
                        "preset": name, "B": b,
                        "p50_ms": float(np.median(t) * 1e3),
                        "min_ms": float(np.min(t) * 1e3)}))
    return gpu16, forwards


# fp32 train step on the card against the same step on the CPU (ViT-B,
# 12 layers, 2 steps): the same fp32 arithmetic in other summation orders.
# Loss: 1e-4 relative. grad_norm: 1e-3 relative. Parameters: step 0 has
# lr 0; step 1's Adam update is close to lr * sign-like, so an element
# whose gradient is within fp32 noise of zero moves differently, by at
# most ~2 lr; held as the relative L2 norm of the difference of the two
# updates, <= 1e-2, and the largest parameter difference, <= 2.5 lr.
TOL_TRAIN_LOSS = 1e-4
TOL_TRAIN_NORM = 1e-3
TOL_TRAIN_UPDATE = 1e-2


def train_cfg(**kw) -> TrainConfig:
    """`bench.py::bench_train`'s configuration: ViT-B/16@224, crop/flip on
    the 256 canvas, fused AdamW, no remat; warmup 1; `kw` overrides any
    field (phase 14: the ViT-L recipe)."""
    return TrainConfig(**{**dict(preset="vit_base_16_224", augment="crop_flip",
                                 canvas=256, fused_adamw=True, warmup_steps=1,
                                 total_steps=10**6), **kw})


def set_head(params, d, num_classes, seed):
    """Write seeded random heads into the state's (zero) heads in place: the
    CLS head from `seed`, a DeiT's DIST head from `seed + 1`."""
    with torch.no_grad():
        for i, name in enumerate(sorted(params["classifier"])):
            head = seeded_head({"classifier": {}}, d, num_classes, seed + i)[
                "classifier"]["head"]
            for k, t in head.items():
                params["classifier"][name][k].copy_(t)


def parity_batches(batch: int) -> list[dict]:
    """The two uint8 batches on the 256 canvas of `phase_train_parity`."""
    rng = np.random.default_rng(5)
    return [{"image": rng.integers(0, 256, (batch, 256, 256, 3),
                                   dtype=np.uint8),
             "label": rng.integers(0, 6, batch).astype(np.int32)}
            for _ in range(2)]


def phase_train_parity(cfg, route: str = "default", batch: int = 8,
                       batches=None, **overrides) -> dict:
    """(a) 2 fp32 steps of `batch` as 2 microbatches, crop/flip, on the
    card and on the CPU from the same init, batches (`parity_batches`
    unless given) and draws, on the route the caller's switches select;
    `overrides` change the config (phase 11(c): attention dropout; phase
    15(c): a distilled student, whose loss_distill is held as the loss;
    phase 17: the preset and its canvas)."""
    tcfg = train_cfg(batch_size=batch, grad_accum=2, bf16=False, **overrides)
    batches = batches or parity_batches(batch)
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        init_fn, step, _ = make_classifier_step_fns(tcfg, device=dev)
        state = init_fn()
        set_head(state["params"], cfg.embed_dim, 6, seed=1)
        start = [p.detach().cpu().clone()
                 for p in tree_leaves(state["params"])]
        losses, norms, distill = [], [], []
        for b in batches:
            state, m = step(state, b, step_seed=3)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if "loss_distill" in m:
                distill.append(float(m["loss_distill"]))
        final = [p.detach().cpu() for p in tree_leaves(state["params"])]
        runs[dev] = (losses, norms, start, final,
                     time.perf_counter() - t0, distill)
    (l_gpu, n_gpu, s_gpu, f_gpu, t_gpu, d_gpu), (
        l_cpu, n_cpu, s_cpu, f_cpu, t_cpu, d_cpu) = runs["cuda"], runs["cpu"]
    lr = tcfg.learning_rate
    for a, b in zip(s_gpu, s_cpu):
        check(torch.equal(a, b), "card and CPU start from different weights")
    upd_gpu = torch.cat([(f - s).flatten() for f, s in zip(f_gpu, s_gpu)])
    upd_cpu = torch.cat([(f - s).flatten() for f, s in zip(f_cpu, s_cpu)])
    rel_update = float((upd_gpu - upd_cpu).norm() / upd_cpu.norm())
    max_param = max(max_err(a, b) for a, b in zip(f_gpu, f_cpu))
    rel_loss = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    rel_norm = max(abs(a - b) / abs(b) for a, b in zip(n_gpu, n_cpu))
    rel_distill = max((abs(a - b) / abs(b) for a, b in zip(d_gpu, d_cpu)),
                      default=0.0)
    rec = {"check": "train step fp32 cuda vs cpu", "route": route,
           "overrides": overrides, "batch": batch,
           "grad_accum": 2, "steps": 2, "loss_cuda": l_gpu,
           "loss_cpu": l_cpu, "grad_norm_cuda": n_gpu,
           "grad_norm_cpu": n_cpu, "max_rel_err_loss": rel_loss,
           "max_rel_err_grad_norm": rel_norm,
           "loss_distill_cuda": d_gpu, "loss_distill_cpu": d_cpu,
           "max_rel_err_loss_distill": rel_distill,
           "rel_l2_err_update": rel_update,
           "max_abs_err_params": max_param, "lr": lr,
           "seconds_cuda": t_gpu, "seconds_cpu": t_cpu}
    log(json.dumps(rec))
    check(all(np.isfinite(l_gpu + n_gpu)), "non-finite card train metrics")
    check(rel_loss <= TOL_TRAIN_LOSS, f"train loss cuda vs cpu {rel_loss}")
    check(rel_distill <= TOL_TRAIN_LOSS,
          f"loss_distill cuda vs cpu {rel_distill}")
    check(rel_norm <= TOL_TRAIN_NORM, f"grad_norm cuda vs cpu {rel_norm}")
    check(rel_update <= TOL_TRAIN_UPDATE,
          f"parameter update cuda vs cpu {rel_update}")
    check(max_param <= 2.5 * lr, f"parameters cuda vs cpu {max_param}")
    return rec


# bf16 card steps against fp32 card steps, the bench configuration with a
# seeded random head. Steps 0 and 1 take their gradients at the init
# weights (step 0 has lr 0; step 1's gradient comes before its update), so
# there the two runs differ by bf16's rounding alone: 2^-8 relative per
# rounding, compounding through 12 layers, averaged over 512 images. Loss
# and grad_norm of steps 0 and 1: 2e-2 and 5e-2 relative. The first moment
# after step 1 (a mix of the two clipped gradients), leaf by leaf: relative
# L2 <= 1e-1; over all leaves: <= 5e-2. The later steps follow updates at
# the full lr and are recorded for both precisions, held only finite.
TOL_BF16_LOSS = 2e-2
TOL_BF16_NORM = 5e-2
TOL_BF16_MOMENT_LEAF = 1e-1
TOL_BF16_MOMENT = 5e-2
# Phase 10(b) holds the bf16 opt-in route (save-probs attention, fused MLP)
# to the bf16 default route with the same limits: the two differ only in
# where bf16 rounds (P, u and h kept at other precisions), which is less
# than the whole of bf16 against fp32.
OPT_IN_ENV = ("ARSVT_ATTN_SAVE_PROBS", "ARSVT_ENABLE_FUSED_MLP")


def bench_batch():
    """The bench phase's fixed batch of 512 float images on the card."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    return {"image": torch.rand((512, 256, 256, 3), generator=gen,
                                device="cuda"),
            "label": torch.randint(0, 6, (512,), generator=gen,
                                   device="cuda")}


@contextlib.contextmanager
def switches(opt_in: bool):
    """Both opt-in switches set in this process for the block (and unset
    after it) when opt_in; unset otherwise."""
    saved = {k: os.environ.pop(k, None) for k in OPT_IN_ENV}
    if opt_in:
        os.environ.update(dict.fromkeys(OPT_IN_ENV, "1"))
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def seven_steps(cfg, *, bf16: bool, opt_in: bool = False):
    """7 steps of the bench configuration with a seeded random head on the
    bench batch. Returns (losses, grad norms, the first moment after step
    1, seconds)."""
    steps, batch = 7, bench_batch()
    t0 = time.perf_counter()
    with switches(opt_in):
        init_fn, step, _ = make_classifier_step_fns(
            train_cfg(batch_size=512, grad_accum=16, bf16=bf16))
        state = init_fn()
        set_head(state["params"], cfg.embed_dim, 6, seed=1)
        losses, norms = [], []
        for t in range(steps):
            state, m = step(state, batch)
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
            if t == 1:
                mu = [(name, x.clone()) for name, x in
                      named_leaves(state["opt_state"]["mu"])]
    return ([float(v) for v in losses], [float(v) for v in norms], mu,
            time.perf_counter() - t0)


def compare_runs(title, ref_name, ref, got_name, got) -> dict:
    """Hold `got` to `ref` (two `seven_steps` runs) on the loss and grad
    norm of steps 0-1 and the first moment after step 1 (the bf16 limits
    above); the later steps are recorded and held finite."""
    (l_ref, n_ref, mu_ref, t_ref), (l_got, n_got, mu_got, t_got) = ref, got
    diff2 = ref2 = 0.0
    worst = ("", 0.0)
    for (name, a), (_, b) in zip(mu_got, mu_ref):
        d2, r2 = float((a - b).square().sum()), float(b.square().sum())
        diff2, ref2 = diff2 + d2, ref2 + r2
        if (d2 / r2) ** 0.5 > worst[1]:
            worst = (name, (d2 / r2) ** 0.5)
    rel_mu = (diff2 / ref2) ** 0.5
    rel_loss = max(abs(a - b) / abs(b) for a, b in zip(l_got[:2], l_ref[:2]))
    rel_norm = max(abs(a - b) / abs(b) for a, b in zip(n_got[:2], n_ref[:2]))
    rec = {"check": title, "batch": 512, "grad_accum": 16,
           "steps": len(l_ref), f"loss_{ref_name}": l_ref,
           f"loss_{got_name}": l_got, f"grad_norm_{ref_name}": n_ref,
           f"grad_norm_{got_name}": n_got,
           "max_rel_err_loss_steps01": rel_loss,
           "max_rel_err_grad_norm_steps01": rel_norm,
           "rel_l2_err_mu_step1": rel_mu,
           "worst_leaf_mu_step1": {"leaf": worst[0], "rel_l2_err": worst[1]},
           f"seconds_{ref_name}": t_ref, f"seconds_{got_name}": t_got}
    log(json.dumps(rec))
    check(all(np.isfinite(l_ref + l_got + n_ref + n_got)),
          f"non-finite train metrics: {title}")
    check(rel_loss <= TOL_BF16_LOSS, f"{title}: loss {rel_loss}")
    check(rel_norm <= TOL_BF16_NORM, f"{title}: grad_norm {rel_norm}")
    check(rel_mu <= TOL_BF16_MOMENT, f"{title}: first moment {rel_mu}")
    check(worst[1] <= TOL_BF16_MOMENT_LEAF,
          f"{title}: first moment of {worst[0]}: {worst[1]}")
    return rec


def phase_train_bf16(cfg):
    """(a2) 7 steps of the bench configuration with a seeded random head,
    in fp32 and in bf16 on the card, from the same init, batch and draws.
    Returns the bf16 run, which phase 10(b) compares with the opt-in
    route."""
    ref = seven_steps(cfg, bf16=False)
    got = seven_steps(cfg, bf16=True)
    compare_runs("train step bf16 vs fp32 on the card, random head", "fp32",
                 ref, "bf16", got)
    return got


def phase_opt_in_training(cfg, smi, default_bf16) -> dict:
    """Phase 10: ViT-B/16@224 training with both opt-in switches set in
    the process: (a) two fp32 steps on the card against the CPU; (b) seven
    bf16 steps against phase 7(a2)'s seven bf16 steps of the default
    route; (c) the bench configuration with its exact launches, eval; (d)
    a profile of one step. Returns the launch counts of (c)."""
    log("# phase 10(a): opt-in route, fp32 train steps, card vs CPU")
    with switches(True):
        phase_train_parity(cfg, route="opt-in")
    log("# phase 10(b): opt-in route vs the default route, bf16")
    compare_runs("train step bf16 opt-in route vs default route, random "
                 "head", "default", default_bf16, "opt_in",
                 seven_steps(cfg, bf16=True, opt_in=True))
    log("# phase 10(c): the bench_train configuration on the opt-in route")
    with switches(True):
        bench, counts, state, step, batch = phase_train_bench(cfg, smi,
                                                              opt_in=True)
        log("# phase 10(d): profile of one opt-in train step")
        phase_train_profile(state, step, batch, bench["ms_per_step"],
                            title="train step vit_base_16_224 bench config, "
                                  "opt-in route")
    return counts


# The kernels' launch counters: (name, module, attribute).
COUNTERS = (
    ("encoder_attention_fwd", encoder_attention, "LAUNCHES"),
    ("encoder_attention_bwd", encoder_attention, "BWD_LAUNCHES"),
    ("encoder_attention_fwd_savep", encoder_attention, "SAVEP_LAUNCHES"),
    ("encoder_attention_bwd_savep", encoder_attention, "SAVEP_BWD_LAUNCHES"),
    ("fused_adamw", fused_adamw, "LAUNCHES"),
    ("flash_attention_fwd", flash_attention, "LAUNCHES"),
    ("flash_attention_bwd", flash_attention, "LAUNCHES_BWD"),
    ("fused_mlp_fwd", fused_mlp, "LAUNCHES"),
    ("fused_mlp_bwd", fused_mlp, "BWD_LAUNCHES"),
    # the launches of #1, #2, #5 and #6 that ran their dropout branch,
    # counted beside the totals above
    ("encoder_attention_fwd_dropout", encoder_attention, "DROPOUT_LAUNCHES"),
    ("encoder_attention_bwd_dropout", encoder_attention,
     "DROPOUT_BWD_LAUNCHES"),
    ("encoder_attention_fwd_savep_dropout", encoder_attention,
     "DROPOUT_SAVEP_LAUNCHES"),
    ("encoder_attention_bwd_savep_dropout", encoder_attention,
     "DROPOUT_SAVEP_BWD_LAUNCHES"),
    # and those of #3 and #4
    ("flash_attention_fwd_dropout", flash_attention, "DROPOUT_LAUNCHES"),
    ("flash_attention_bwd_dropout", flash_attention, "DROPOUT_LAUNCHES_BWD"),
    # the port-only kernel of the residual, positional and reference-
    # attention sites: the apply kernel, one launch a site each way
    # (`site_launches` a microbatch)
    ("dropout_apply", dropout_ops, "APPLY_LAUNCHES"),
    # the port-only matcher kernel (csrc/lap.cu): its fused entry, one
    # launch a `match_layers` or eval `match` call on the device route, and
    # its solve-only entry, off every path (phase 3's checks alone)
    ("lap", matcher, "LAUNCHES"),
    ("lap_solve", matcher, "SOLVE_LAUNCHES"),
    # the port-only LayerNorm and GELU kernels (`norm_launches`)
    ("layer_norm_fwd", ln_ops, "LAUNCHES"),
    ("layer_norm_bwd", ln_ops, "BWD_LAUNCHES"),
    ("gelu_tanh_fwd", mlp_ops, "LAUNCHES"),
    ("gelu_tanh_bwd", mlp_ops, "BWD_LAUNCHES"),
)
NORM_NAMES = ("layer_norm_fwd", "layer_norm_bwd", "gelu_tanh_fwd",
              "gelu_tanh_bwd")


def norm_launches(model, *, forwards: int = 0, micro: int = 0,
                  policy: str = "none", fused_mlp: bool = False,
                  aux: bool = False, ln_vjp: bool = True) -> dict:
    """The LayerNorm and GELU kernels' launches in `forwards` forwards
    without a gradient and `micro` training microbatches of `model` (a
    BackboneConfig or a DetectorConfig; a microbatch is a forward, the
    replays of remat `policy` and a backward). A backbone runs 2 depth + 1
    LayerNorms and depth GELUs a forward, a DETR head 4 LayerNorms and a
    GELU a layer and its final LayerNorm, once more over the stacked
    intermediate layers with `aux` (training, two layers or more). A
    LayerNorm backward is two launches, a GELU backward one. The policies
    that replay whole blocks (full, dots, names: JAX saves neither op's
    output) replay both LayerNorms of a block, every policy but none
    replays the GELU; on the fused-MLP route (`fused_mlp`) a GELU runs
    inside #8 and #9 instead, except in the backbone's training forwards
    under mlp_tail, which keeps the unfused tail. Without the custom
    backward (``ARSVT_DISABLE_LN_VJP``, `ln_vjp` False) no LayerNorm
    kernel runs."""
    bb = getattr(model, "backbone", model)
    head = getattr(model, "head", None)
    ln = 2 * bb.depth + 1
    gelu = 0 if fused_mlp else bb.depth
    train_gelu = bb.depth if policy == "mlp_tail" else gelu
    gelu_replay = (bb.depth if policy == "mlp_tail"
                   or (policy != "none" and not fused_mlp) else 0)
    ln_replay = 2 * bb.depth if policy in ("full", "dots", "names") else 0
    train_ln = ln
    if head is not None:
        ln += 4 * head.depth + 1
        train_ln = ln + (aux and head.depth >= 2)
        gelu += 0 if fused_mlp else head.depth
        train_gelu += 0 if fused_mlp else head.depth
    if not ln_vjp:
        ln = train_ln = ln_replay = 0
    return {
        "layer_norm_fwd": ln * forwards + (train_ln + ln_replay) * micro,
        "layer_norm_bwd":
            ln_ops.BWD_LAUNCHES_PER_CALL * train_ln * micro,
        "gelu_tanh_fwd": gelu * forwards + (train_gelu + gelu_replay) * micro,
        "gelu_tanh_bwd": train_gelu * micro,
    }


def zero_counts() -> None:
    for _, module, attr in COUNTERS:
        setattr(module, attr, 0)


def read_counts() -> dict:
    return {name: getattr(module, attr) for name, module, attr in COUNTERS}


def mask_sites(model, replays: int = 0) -> int:
    """The dropout sites' forwards in one training microbatch of `model` (a
    BackboneConfig or a DetectorConfig): where the backbone's dropout is
    on, its positional site and each layer's two residual sites, and
    `replays` sites a layer more under remat (a policy that replays whole
    blocks replays the attention's residual site; the MLP's, which ends
    the block and saves nothing, the replay stops short of); where a DETR
    head's dropout is on, its three residual sites a layer; where its
    attention dropout is on, the probabilities of its reference
    self-attention a layer. Attention dropout elsewhere runs inside #1-#6;
    eval draws nothing."""
    bb = getattr(model, "backbone", model)
    head = getattr(model, "head", None)
    n = 1 + bb.depth * (2 + replays) if bb.dropout > 0 else 0
    if head is not None:
        n += head.depth * (3 * (head.dropout > 0) + (head.attn_dropout > 0))
    return n


def site_launches(model, replays: int = 0) -> int:
    """The apply kernel's launches in one training microbatch: one a site's
    forward and replay (`mask_sites`), one a site's backward."""
    return mask_sites(model, replays) + mask_sites(model)


def classifier_launches(depth: int, micro: int, steps: int,
                        eval_forwards: int, opt_in: bool,
                        dropout: bool = False,
                        dtype=torch.bfloat16) -> dict:
    """Launches of the classifier's training path: `steps` steps of `micro`
    microbatches, then `eval_forwards` eval forwards. Default route: #1
    and #2 per layer and microbatch. Opt-in route (both switches): #5, #6,
    #8 and #9 per layer and microbatch, and each eval forward #1 and #8 per
    layer. One AdamW launch a step; each backward call launches two
    kernels, and so does each call of #8 in bf16 (`dtype`; one in fp32). With
    attention `dropout`, every training launch of #1/#2 or #5/#6 runs the
    dropout branch; eval forwards never do. The LayerNorm and GELU kernels as
    `norm_launches` counts them (no GELU kernel on the opt-in route)."""
    counts = dict.fromkeys((name for name, _, _ in COUNTERS), 0)
    counts.update(norm_launches(types.SimpleNamespace(depth=depth),
                                forwards=eval_forwards, micro=micro * steps,
                                fused_mlp=opt_in))
    layers = depth * micro * steps
    counts["fused_adamw"] = steps
    counts["encoder_attention_fwd"] = depth * eval_forwards
    if opt_in:
        counts["encoder_attention_fwd_savep"] = layers
        counts["encoder_attention_bwd_savep"] = (
            layers * encoder_attention.SAVEP_BWD_LAUNCHES_PER_CALL)
        counts["fused_mlp_fwd"] = (layers + depth * eval_forwards) * (
            fused_mlp.FWD_LAUNCHES_PER_CALL[dtype])
        counts["fused_mlp_bwd"] = layers * fused_mlp.BWD_LAUNCHES_PER_CALL
    else:
        counts["encoder_attention_fwd"] += layers
        counts["encoder_attention_bwd"] = (
            layers * encoder_attention.BWD_LAUNCHES_PER_CALL)
    if dropout:
        for name in ENC_DROPOUT_NAMES:
            train = counts[name] - (depth * eval_forwards
                                    if name == "encoder_attention_fwd" else 0)
            counts[f"{name}_dropout"] = train
    return counts


def phase_train_bench(cfg, smi: str, opt_in: bool = False):
    """(b) the bench configuration: batch 512 as 16 x 32, bf16, crop/flip on
    the 256 canvas, fused AdamW; 2 warm-up and 5 timed steps on one fixed
    batch made on the card, on the default route or (opt_in, with both
    switches set by the caller) the save-probs / fused-MLP one; (c) one
    eval_step and evaluate_classifier over two batches. The launches are
    held exact after the train steps and again after the eval forwards.
    Returns (record, counts, state, step fn, batch)."""
    steps_warm, steps_timed, micro = 2, 5, 16
    route = "opt-in (save-probs, fused MLP)" if opt_in else "default"
    tcfg = train_cfg(batch_size=512, grad_accum=micro, bf16=True)
    init_fn, step, eval_step = make_classifier_step_fns(tcfg)
    # bench_train's own init, zero head; (a2) holds the same steps with a
    # random head, in bf16 against fp32
    state = init_fn()
    batch = bench_batch()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()  # the training path starts here
    losses = []
    for _ in range(steps_warm):
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps_timed):
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses = [float(v) for v in losses]
    steps = steps_warm + steps_timed
    rec = {"timing": "train step vit_base_16_224 bench config",
           "route": route, "batch": 512, "grad_accum": micro,
           "dtype": "bfloat16", "augment": "crop_flip", "canvas": 256,
           "steps_timed": steps_timed,
           "ms_per_step": dt / steps_timed * 1e3,
           "train_images_per_s": 512 * steps_timed / dt,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses, "card": smi}
    log(json.dumps(rec))
    check(all(np.isfinite(losses)), f"non-finite train loss {losses}")
    check(losses[-1] < losses[1],
          f"loss did not fall over the timed steps: {losses}")
    train_counts = read_counts()
    expected = classifier_launches(cfg.depth, micro, steps, 0, opt_in)
    log(json.dumps({"launches": train_counts, "expected": expected,
                    "path": f"{route} train steps", "steps": steps}))
    check(train_counts == expected,
          f"{route} train-step launches {train_counts} != {expected}")

    ev = {"image": batch["image"][:64], "label": batch["label"][:64]}
    e = eval_step(state["params"], ev)
    check(int(e["count"]) == 64 and int(e["confusion"].sum()) == 64 and
          0 <= int(e["correct"]) <= 64 and bool(torch.isfinite(e["loss"])),
          f"eval_step {e}")
    rng = np.random.default_rng(6)
    eval_batches = [{"image": rng.integers(0, 256, (32, 256, 256, 3),
                                           dtype=np.uint8),
                     "label": rng.integers(0, 6, 32).astype(np.int32)}
                    for _ in range(2)]
    res = evaluate_classifier(state["params"], iter(eval_batches), cfg, 6,
                              normalize_inputs=True)
    check(res["n"] == 64 and sum(map(sum, res["confusion_matrix"])) == 64
          and 0.0 <= res["top1"] <= 1.0, f"evaluate_classifier {res}")
    counts = read_counts()
    expected = classifier_launches(cfg.depth, micro, steps, 1 + 2, opt_in)
    log(json.dumps({"check": "eval", "route": route,
                    "eval_step_loss": float(e["loss"]),
                    "eval_step_correct": int(e["correct"]),
                    "evaluate_classifier_top1": res["top1"],
                    "evaluate_classifier_n": res["n"]}))
    log(json.dumps({"launches": counts, "expected": expected,
                    "path": f"{route} training and 3 eval forwards"}))
    check(counts == expected, f"{route} launches {counts} != {expected}")
    return rec, counts, state, step, batch


# Device kernels by the layer they belong to (first match wins).
PROFILE_CATEGORIES = (
    # #1, #3 and #5 share one kernel template (attention_fwd.cuh); its last
    # template argument, kSaveP, is true for #5
    ("save-probs attention forward kernel", ("true>(attn::FwdArgs",)),
    ("attention forward kernels (#1, #3)", ("attn::attention_fwd_kernel",)),
    ("save-probs attention backward kernels", ("savep_bwd_",)),
    ("fused MLP kernels", ("mlpg::gemm_bf16_kernel", "row_tile_kernel",
                           "dw_kernel")),
    # #2 and #4 share one pair of kernel templates (attention_bwd.cuh):
    # the ViT steps run #2 alone, the detector steps #4 alone
    ("attention backward kernels (#2, #4)", ("attn::attention_bwd_",)),
    ("AdamW kernel", ("fused_adamw_kernel",)),
    # the port-only matcher kernel (csrc/lap.cu)
    ("matcher kernel", ("match_kernel<", "solve_kernel<")),
    # the port-only kernels of csrc/layernorm.cu and csrc/gelu_tanh.cu
    ("LayerNorm kernels", ("ln_fwd_", "ln_bwd_")),
    ("GELU kernels", ("gelu_kernel<", "table_fwd_kernel", "table_kernel")),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
    ("copies and casts", ("copy",)),
    ("reductions", ("reduce_kernel",)),
)


EAGER_NORM_MARKS = ("rsqrt_kernel_cuda", "tanh_kernel_cuda")


def phase_train_profile(state, step, batch, wall_ms: float,
                        title="train step vit_base_16_224 bench config"):
    """(d) torch.profiler over one bf16 train step: the device's busy share
    of the unprofiled step time from (b), and the kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, m = step(state, batch)
        torch.cuda.synchronize()
    per_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            rec = per_name.setdefault(e.name, [0.0, 0])
            rec[0] += e.time_range.elapsed_us()
            rec[1] += 1
    busy_us = sum(v[0] for v in per_name.values())
    # the eager LayerNorm and GELU chains' own ops (rsqrt, tanh): no other
    # op of a step launches these, so none should run
    eager = {k: v[1] for k, v in per_name.items()
             if any(m in k for m in EAGER_NORM_MARKS)}
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]
    by_category: dict[str, float] = {}
    for name, (us, _) in per_name.items():
        cat = next((c for c, keys in PROFILE_CATEGORIES
                    if any(k in name for k in keys)), "elementwise and other")
        by_category[cat] = by_category.get(cat, 0.0) + us / 1e3
    rec = {"profile": title, "wall_ms_per_step": wall_ms,
           "device_busy_ms_per_step": busy_us / 1e3,
           # None: the profiler saw no device time (not measured)
           "device_busy_share": busy_us / 1e3 / wall_ms if busy_us else None,
           "kernels_per_step": sum(v[1] for v in per_name.values()),
           "eager_norm_kernels_per_step": sum(eager.values()),
           "ms_by_category": by_category,
           "top": [{"name": k[:80], "ms": v[0] / 1e3, "calls": v[1]}
                   for k, v in top]}
    log(json.dumps(rec))
    check(not eager, f"{title}: the eager LayerNorm or GELU chain ran: "
                     f"{eager}")
    return rec


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


# The micro-batched /classify server under sustained load, at
# benchmarks/serving_load.py's configuration: its argparse defaults
# (:81-86) but the 30 s of benchmarks/tpu_revalidate.sh:38; closed-loop
# clients on one HTTPConnection each, reconnecting after an error
# (`_client_loop`, :57-77, its timeout and the main thread's join
# timeout); the JPEG body of `_jpeg_frame` (:46-54: uniform pixels from
# default_rng(7), 640 x 480 at quality 90); vit_base_16_224 with 6 classes
# from seed 0 (:103-104); three sequential warm-up requests (:116-120);
# /stats read once, after the clients stop (:141-145). The one departure:
# the head is seeded (`seeded_head`, seed `LOAD_HEAD_SEED`), since the zero
# head of `init_image_classifier` makes every answer uniform and would
# hide faults. `python3 chip_smoke.py --serving-load` makes `LOAD_RUNS`
# for `LOAD_DURATION_S` each (serving_load.py's --quantize int8 and
# --max-batch 1 as the second and third); phase 5(c) makes the first for
# `LOAD_SMOKE_S`.
LOAD_CLIENTS = 16
LOAD_DURATION_S = 30.0
LOAD_SMOKE_S = 5.0
LOAD_MAX_BATCH = 8
LOAD_WINDOW_MS = 3.0
LOAD_PRESET = "vit_base_16_224"
LOAD_CLASSES = 6
LOAD_INIT_SEED = 0
LOAD_HEAD_SEED = 1
LOAD_FRAME = {"side_w": 640, "side_h": 480, "quality": 90}
LOAD_FRAME_SEED = 7
LOAD_WARMUPS = 3
LOAD_CLIENT_TIMEOUT_S = 60
LOAD_JOIN_S = 30
LOAD_RUNS = ((None, LOAD_MAX_BATCH), ("int8", LOAD_MAX_BATCH), (None, 1))
# host-paced forwards of the engine alone at a run's batch, and decodes of
# the body alone, timed before the load
LOAD_ALONE_REPS = 10
# the lock probe's sleep, and how long it reads the idle process
LOAD_PROBE_S = 0.001
LOAD_PROBE_IDLE_S = 0.3


def load_params() -> dict:
    """The served model: `LOAD_PRESET` from `LOAD_INIT_SEED` with a seeded
    head (phases 4-17 serve and train it too)."""
    cfg = PRESETS[LOAD_PRESET]
    return seeded_head(init_image_classifier(cfg, LOAD_CLASSES,
                                             seed=LOAD_INIT_SEED),
                       cfg.embed_dim, LOAD_CLASSES, seed=LOAD_HEAD_SEED)


def load_frame() -> bytes:
    """serving_load.py's `_jpeg_frame()`: uniform pixels saved as JPEG."""
    rng = np.random.default_rng(LOAD_FRAME_SEED)
    buf = io.BytesIO()
    Image.fromarray(
        (rng.uniform(size=(LOAD_FRAME["side_h"], LOAD_FRAME["side_w"], 3))
         * 255).astype(np.uint8)
    ).save(buf, format="JPEG", quality=LOAD_FRAME["quality"])
    return buf.getvalue()


def load_client(port, body, keep_going, latencies, errors, payloads):
    """serving_load.py's `_client_loop`, keeping each parsed answer: POST
    `body` to /classify while `keep_going(requests made)` holds; a status
    other than 200 or an exception is an error (and a new connection
    after an exception), never retried into a success."""
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=LOAD_CLIENT_TIMEOUT_S)
    made = 0
    while keep_going(made):
        made += 1
        t0 = time.perf_counter()
        try:
            conn.request("POST", "/classify", body,
                         {"Content-Type": "image/jpeg"})
            resp = conn.getresponse()
            payload = resp.read()
            if resp.status != 200:
                errors.append(payload[:200])
                continue
        except Exception as e:  # noqa: BLE001 - record and reconnect
            errors.append(repr(e)[:200])
            conn.close()
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=LOAD_CLIENT_TIMEOUT_S)
            continue
        latencies.append(time.perf_counter() - t0)
        payloads.append(json.loads(payload))
    conn.close()


def drive_clients(port, body, clients, *, duration_s=None, requests=None):
    """`clients` closed-loop `load_client`s against 127.0.0.1:`port`, for
    `duration_s` seconds or `requests` requests each. Returns (wall s from
    the first start to the last join, latencies s, errors, payloads)."""
    stop = threading.Event()
    if requests is None:
        def keep_going(made):
            return not stop.is_set()
    else:
        def keep_going(made):
            return made < requests
    latencies, errors, payloads = [], [], []
    threads = [threading.Thread(target=load_client, daemon=True, args=(
        port, body, keep_going, latencies, errors, payloads))
        for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    if duration_s is not None:
        time.sleep(duration_s)
        stop.set()
    for t in threads:
        t.join(timeout=LOAD_JOIN_S)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads),
          "a load client did not finish")
    return wall, latencies, errors, payloads


def load_result(latencies, errors, wall, stats, *, max_batch, quantize,
                backend) -> dict:
    """serving_load.py's result line (:147-163): its keys, formulas and
    rounding; `backend` the engine's device type."""
    lat = np.asarray(sorted(latencies)) * 1e3

    def pct(q):
        return round(float(np.percentile(lat, q)), 2) if lat.size else None

    return {
        "clients": LOAD_CLIENTS,
        "duration_s": round(wall, 1),
        "requests_ok": int(lat.size),
        "errors": len(errors),
        "qps": round(lat.size / wall, 1),
        "p50_ms": pct(50),
        "p90_ms": pct(90),
        "p99_ms": pct(99),
        "max_batch": max_batch,
        "batch_window_ms": LOAD_WINDOW_MS,
        "batcher": stats.get("batching"),
        "preset": LOAD_PRESET,
        "quantize": quantize,
        "backend": backend,
    }


class HostTimes:
    """The wall and the calling thread's CPU seconds of each call of the
    functions it wraps: a thread whose wall time runs past its CPU time
    waited (for the interpreter lock, a core, the card or a lock)."""

    def __init__(self):
        self.wall: list[float] = []
        self.cpu: list[float] = []

    def wrap(self, fn):
        def timed(*args):
            t0, c0 = time.perf_counter(), time.thread_time()
            try:
                return fn(*args)
            finally:
                self.wall.append(time.perf_counter() - t0)
                self.cpu.append(time.thread_time() - c0)
        return timed

    def clear(self) -> None:
        self.wall.clear()
        self.cpu.clear()

    def summary(self) -> dict | None:
        """The wall ms's median, 90th percentile and maximum, the mean of
        both (a thread's CPU clock may tick in 10 ms steps, so only a mean
        over many calls reads it)."""
        if not self.wall:
            return None
        wall = np.asarray(self.wall) * 1e3
        return {"p50_ms": float(np.median(wall)),
                "p90_ms": float(np.percentile(wall, 90)),
                "max_ms": float(wall.max()),
                "mean_ms": float(wall.mean()),
                "cpu_mean_ms": float(np.mean(self.cpu) * 1e3),
                "calls": len(self.wall)}


class LockProbe:
    """A thread that sleeps `LOAD_PROBE_S` at a time and records by how
    much each wake-up overran: beyond the host timer's own slack (read
    with the process idle), the time it waited for the interpreter lock,
    as every thread of the process does after each release."""

    def __init__(self):
        self.late_s: list[float] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            t0 = time.perf_counter()
            time.sleep(LOAD_PROBE_S)
            self.late_s.append(time.perf_counter() - t0 - LOAD_PROBE_S)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        check(not self._thread.is_alive(), "the lock probe did not stop")

    def summary(self) -> dict:
        late = np.asarray(self.late_s) * 1e3
        return {"p50_ms": float(np.median(late)),
                "p90_ms": float(np.percentile(late, 90)),
                "p99_ms": float(np.percentile(late, 99)),
                "mean_ms": float(late.mean()), "wakes": int(late.size)}


class TimedEngine:
    """The engine, with each forward the server asks of it (the batcher's
    `infer_batch`, the unbatched `__call__`) timed into `times`."""

    def __init__(self, engine):
        self._engine = engine
        self.times = HostTimes()
        self.infer_batch = self.times.wrap(engine.infer_batch)
        self._call = self.times.wrap(engine)

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def __call__(self, image):
        return self._call(image)


def alone_times(fn, reps: int) -> dict:
    """`HostTimes.summary` of `reps` calls of `fn` after one untimed."""
    fn()
    times = HostTimes()
    timed = times.wrap(fn)
    for _ in range(reps):
        timed()
    return times.summary()


def unbatched_answer(engine, body) -> dict:
    """The body's answer from an unbatched server of `engine`."""
    srv = InferenceServer(classifier=engine)
    host, port = srv.start_background(port=0)
    try:
        status, data = post(f"http://{host}:{port}/classify", body)
    finally:
        srv.shutdown()
    check(status == 200, f"unbatched /classify status {status}")
    return data


def serving_load_run(engine, body, ref, *, quantize, max_batch: int,
                     duration_s: float, smi: str, total: dict) -> dict:
    """One run: the engine's forward alone at the run's batch and the
    body's decode alone, then a fresh `InferenceServer` of it under
    `LOAD_CLIENTS` closed-loop clients for `duration_s`, its launches
    held exactly (a forward for the server's warm-up of the padded batch,
    then one a batch; one a request unbatched). Every answer is 200 and
    within `TOL_PROBS_BF16` of `ref`, the body's unbatched answer in the
    same precision. Returns the run's record."""
    cfg = PRESETS[LOAD_PRESET]
    image = decoded(body, cfg.image_size)
    batch = np.stack([image] * max_batch)

    forward_alone = held_path(
        total, f"serving load {quantize or 'bf16'} x {max_batch}: the "
        f"forward alone",
        lambda: alone_times(lambda: engine.infer_batch(batch),
                            LOAD_ALONE_REPS),
        serving_launches(cfg, 1 + LOAD_ALONE_REPS))
    prep_alone = alone_times(lambda: decoded(body, cfg.image_size),
                             LOAD_ALONE_REPS)
    route = mlp_ops.forward_route(torch.empty(
        (max_batch * (cfg.image_size // cfg.patch_size) ** 2 + max_batch,
         cfg.mlp_dim), dtype=torch.bfloat16, device="cuda"))
    timed = TimedEngine(engine)
    table_before = (mlp_ops.TABLE_ROUTE_LAUNCHES, mlp_ops.TABLE_LAUNCHES)
    torch.cuda.synchronize()
    zero_counts()
    srv = InferenceServer(classifier=timed, max_batch=max_batch,
                          batch_window_ms=LOAD_WINDOW_MS)
    # the server's own decode (PIL, the float conversion), alone and then
    # in each handler thread under load
    decode_alone = alone_times(lambda: srv._decode(body), LOAD_ALONE_REPS)
    decode = HostTimes()
    srv._decode = decode.wrap(srv._decode)
    host, port = srv.start_background(port=0)
    try:
        conn = http.client.HTTPConnection(host, port, timeout=120)
        for _ in range(LOAD_WARMUPS):
            conn.request("POST", "/classify", body,
                         {"Content-Type": "image/jpeg"})
            resp = conn.getresponse()
            resp.read()
            check(resp.status == 200, f"warm-up status {resp.status}")
        conn.close()
        with LockProbe() as idle:
            time.sleep(LOAD_PROBE_IDLE_S)
        timed.times.clear()
        decode.clear()
        cpu0 = time.process_time()
        with LockProbe() as busy:
            wall, latencies, errors, payloads = drive_clients(
                port, body, LOAD_CLIENTS, duration_s=duration_s)
        process_cpu_s = time.process_time() - cpu0
        stats = get(f"http://{host}:{port}/stats")
    finally:
        srv.shutdown()
    torch.cuda.synchronize()
    counts = read_counts()
    add_counts(total, counts)
    table = (mlp_ops.TABLE_ROUTE_LAUNCHES - table_before[0],
             mlp_ops.TABLE_LAUNCHES - table_before[1])

    result = load_result(latencies, errors, wall, stats, max_batch=max_batch,
                         quantize=quantize, backend=engine.device.type)
    served = len(latencies)
    batching = stats.get("batching")
    if batching is None:
        batches = served
        forwards = LOAD_WARMUPS + served
    else:
        batches = batching["batches"] - LOAD_WARMUPS
        forwards = 1 + batching["batches"]
    under_load = timed.times.summary()
    cycle_ms = wall * 1e3 / batches if batches else None
    probs = np.asarray([p["probs"] for p in payloads])
    err = float(np.abs(probs - np.asarray(ref["probs"])).max()) \
        if served else None
    clear = top2_margin(np.asarray(ref["probs"])) > 2 * TOL_PROBS_BF16
    classes = sorted({p["class"] for p in payloads})
    rec = {
        "serving_load": f"{'int8' if quantize else 'bf16'} x {max_batch}",
        **result,
        "card": smi,
        "server_classify": stats["classify"],
        "images_per_s": served / wall,
        # a connection the listen backlog dropped is retried after ~1 s
        "requests_over_1s": int(sum(t >= 1.0 for t in latencies)),
        "batches": batches,
        "batch_cycle_ms": cycle_ms,
        "forward_alone_ms": forward_alone["p50_ms"],
        "cycle_over_forward": cycle_ms / forward_alone["p50_ms"]
        if cycle_ms else None,
        # wall and thread CPU ms: the forward alone and under load (the
        # batcher's thread), the server's decode alone and under load (the
        # handler threads), decode and letterbox alone
        "forward": {"alone": forward_alone, "under_load": under_load},
        "forward_busy_share": sum(timed.times.wall) / wall,
        "decode": {"alone": decode_alone, "under_load": decode.summary()},
        "decode_letterbox_alone": prep_alone,
        # the process's CPU seconds a second of load, all threads
        "process_cores_busy": process_cpu_s / wall,
        # ms a 1 ms sleep overran, the process idle and under load
        "lock_probe": {"idle": idle.summary(), "under_load": busy.summary()},
        "host_cores": os.cpu_count(),
        "switch_interval_s": sys.getswitchinterval(),
        "max_abs_err_probs_vs_unbatched": err,
        "classes": classes, "class_unbatched": ref["class"],
        "gelu_forward_route": route,
        "launches": {k: v for k, v in counts.items() if v},
        "forwards": forwards,
    }
    log(json.dumps(rec))
    check(not errors, f"{len(errors)} errors under load, first "
          f"{errors[:1]}")
    check(served > 0 and len(payloads) == served,
          f"{served} answers, {len(payloads)} payloads")
    if batching is not None:
        check(batching["requests"] == LOAD_WARMUPS + served,
              f"the batcher counted {batching['requests']} requests, "
              f"{LOAD_WARMUPS} warm-ups and {served} answers were served")
        check(batching["avg_batch"] > 1, f"no coalescing: {batching}")
    check(len(timed.times.wall) == batches,
          f"{len(timed.times.wall)} forwards under load, {batches} batches")
    check(err <= TOL_PROBS_BF16,
          f"probs under load {err} from the unbatched answer")
    check(not clear or classes == [ref["class"]],
          f"classes under load {classes} != {ref['class']}")
    want = {**dict.fromkeys(counts, 0),
            **serving_launches(cfg, forwards)}
    check(counts == want, f"serving load launches {counts} != {want}")
    want_table = (cfg.depth * forwards if route == "table" else 0, 0)
    check(table == want_table, f"GELU table-route launches and fills "
          f"{table} != {want_table}")
    return rec


def phase_serving_load(params, smi: str, runs, duration_s: float) -> dict:
    """`runs` of (quantize, max_batch), `duration_s` each, each on a fresh
    engine on the card (a fresh latency window for /stats). Returns the
    launches."""
    total = dict.fromkeys((name for name, _, _ in COUNTERS), 0)
    cfg = PRESETS[LOAD_PRESET]
    body = load_frame()
    for quantize, max_batch in runs:
        t0 = time.perf_counter()
        engine = held_path(
            total, f"serving load {quantize or 'bf16'}: the engine's "
            f"warm-up",
            lambda: StreamingClassifier(params, cfg, LOAD_CLASSES,
                                        quantize=quantize, device="cuda"),
            serving_launches(cfg, 1))
        ref = held_path(total, f"serving load {quantize or 'bf16'}: the "
                        f"body's unbatched answer",
                        lambda: unbatched_answer(engine, body),
                        serving_launches(cfg, 1))
        serving_load_run(engine, body, ref, quantize=quantize,
                         max_batch=max_batch, duration_s=duration_s,
                         smi=smi, total=total)
        log(json.dumps({"serving_load_run_s": time.perf_counter() - t0,
                        "body_bytes": len(body), "unbatched": ref}))
    return total


# Detector raw outputs. fp32 card against fp32 CPU: the same arithmetic in
# another summation order through 12 encoder and 6 decoder layers;
# logits and boxes are O(1), so 1e-4 absolute (the classifier's
# probabilities agree to ~3e-6). bf16 against fp32 on the card: bf16
# rounds every activation to 8 mantissa bits through 18 layers; the CPU
# test of a 2-layer detector sees 0.02 on logits and 0.005 on boxes
# against JAX, so 0.25 on logits and 0.05 on boxes (sigmoids, slope <=
# 1/4) at full depth.
TOL_DET_FP32 = 1e-4
TOL_DET_BF16_LOGITS = 0.25
TOL_DET_BF16_BOXES = 0.05
# post_process on the card against the CPU from the same raw outputs: the
# same fp32 operations, but the card's and the host's exp may differ in
# the last bits, so the scores are held to 1e-6 (a few ulps of a
# probability) and everything else (kept set, labels, boxes, order) to
# equality.
TOL_POST_SCORES = 1e-6
DETECT_LATENCY_CALLS = 60


def phase_detector_parity(name, cfg, params, images, *, bf16=True):
    """(a) fp32 on the card against the plain path on the CPU, raw head
    outputs; (b) bf16 against fp32 on the card. Returns (bf16 engine or
    None, CUDA forwards run, CPU raw outputs stacked)."""
    cpu = StreamingDetector(params, cfg, compute_dtype=torch.float32,
                            device="cpu")
    gpu32 = StreamingDetector(params, cfg, compute_dtype=torch.float32,
                              device="cuda")
    forwards = 1
    ref = [cpu.forward(img) for img in images]
    r32 = [gpu32.forward(img) for img in images]
    forwards += len(images)
    stack = {k: torch.stack([r[k] for r in ref]) for k in ref[0]}
    rec = {"check": f"{name} detector raw outputs", "images": len(images)}
    for k in ("class_logits", "boxes_cxcywh"):
        got = torch.stack([r[k] for r in r32])
        check(got.shape == stack[k].shape, f"{k} shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"non-finite fp32 {k}")
        rec[f"max_abs_err_{k}_fp32_cuda_vs_cpu"] = max_err(got, stack[k])
        rec[f"max_abs_{k}"] = float(stack[k].abs().max())
    boxes = stack["boxes_cxcywh"]
    check(bool(((boxes >= 0) & (boxes <= 1)).all()), "boxes outside [0,1]")
    gpu16 = None
    if bf16:
        gpu16 = StreamingDetector(params, cfg, device="cuda")
        r16 = [gpu16.forward(img) for img in images]
        forwards += 1 + len(images)
        l16 = torch.stack([r["class_logits"] for r in r16])
        l32 = torch.stack([r["class_logits"] for r in r32])
        b16 = torch.stack([r["boxes_cxcywh"] for r in r16])
        b32 = torch.stack([r["boxes_cxcywh"] for r in r32])
        check(bool(torch.isfinite(l16).all() & torch.isfinite(b16).all()),
              "non-finite bf16 outputs")
        rec["max_abs_err_class_logits_bf16_vs_fp32"] = max_err(l16, l32)
        rec["max_abs_err_boxes_cxcywh_bf16_vs_fp32"] = max_err(b16, b32)
        # the best foreground class must agree wherever fp32's top two are
        # further apart than the comparison's tolerance
        fg32, fg16 = l32[..., :-1], l16[..., :-1]
        top = fg32.topk(2, dim=-1).values
        clear = (top[..., 0] - top[..., 1]) > 2 * TOL_DET_BF16_LOGITS
        agree = fg16.argmax(-1) == fg32.argmax(-1)
        rec["label_agreement_bf16_clear_margin"] = (
            f"{int(agree[clear].sum())}/{int(clear.sum())}")
        check(rec["max_abs_err_class_logits_bf16_vs_fp32"]
              <= TOL_DET_BF16_LOGITS, f"bf16 logits {rec}")
        check(rec["max_abs_err_boxes_cxcywh_bf16_vs_fp32"]
              <= TOL_DET_BF16_BOXES, f"bf16 boxes {rec}")
        check(bool(agree[clear].all()), "bf16 labels vs fp32")
    log(json.dumps(rec))
    for k in ("class_logits", "boxes_cxcywh"):
        check(rec[f"max_abs_err_{k}_fp32_cuda_vs_cpu"] <= TOL_DET_FP32,
              f"fp32 {k} cuda vs cpu {rec}")
    return gpu16, forwards, stack


def phase_post_process(raw) -> None:
    """(c) post_process on the card and on the CPU from the CPU's raw
    outputs, at the defaults and at conf 0.05."""
    for conf in (0.5, 0.05):
        args = (raw["class_logits"], raw["boxes_cxcywh"])
        cpu = post_process(*args, conf_threshold=conf, nms_threshold=0.5)
        gpu = post_process(*(t.cuda() for t in args), conf_threshold=conf,
                           nms_threshold=0.5)
        gpu = {k: v.cpu() for k, v in gpu.items()}
        for k in ("valid", "labels", "boxes"):
            check(torch.equal(gpu[k], cpu[k]),
                  f"post_process {k} differs at conf {conf}")
        e = max_err(gpu["scores"], cpu["scores"])
        valid = cpu["valid"]
        above = int((torch.softmax(raw["class_logits"], -1)[..., :-1]
                     .amax(-1) >= conf).sum())
        log(json.dumps({"check": "post_process cuda vs cpu", "conf": conf,
                        "kept": int(valid.sum()),
                        "above_threshold": above,
                        "suppressed_by_nms": above - int(valid.sum()),
                        "scores_identical": bool(torch.equal(
                            gpu["scores"], cpu["scores"])),
                        "max_abs_err_scores": e}))
        check(e <= TOL_POST_SCORES, f"post_process scores differ by {e}")


def jpeg_bytes(image_u8: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image_u8).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def phase_detect_server(engine, bodies, tmp) -> int:
    """(d) /detect through InferenceServer against detect_path on the same
    bytes with the same engine, plus /healthz and /stats. Returns the
    number of CUDA forwards run."""
    expected = []
    for i, body in enumerate(bodies):
        path = os.path.join(tmp, f"direct_{i}")
        with open(path, "wb") as f:
            f.write(body)
        out = engine.detect_path(path)
        expected.append({"boxes": np.asarray(out["boxes"]).round(4).tolist(),
                         "labels": np.asarray(out["labels"]).tolist(),
                         "scores": np.asarray(out["scores"]).round(4)
                         .tolist(),
                         "class_names": out["class_names"]})
    n_before = engine.latency_stats()["n"]
    srv = InferenceServer(detector=engine)
    host, port = srv.start_background(port=0)
    url = f"http://{host}:{port}"
    try:
        client_ms = []
        for body, exp in zip(bodies, expected):
            t0 = time.perf_counter()
            status, data = post(url + "/detect", body)
            client_ms.append((time.perf_counter() - t0) * 1e3)
            check(status == 200, f"/detect status {status}")
            # the same engine on the same bytes; the response rounds boxes
            # and scores to 4 decimals, so one rounding step apart at most
            same = (data["labels"] == exp["labels"]
                    and data["class_names"] == exp["class_names"])
            for k in ("boxes", "scores"):
                same = same and np.allclose(data[k], exp[k], rtol=0,
                                            atol=1.01e-4)
            check(same, f"/detect {data} != detect_path {exp}")
        health = get(url + "/healthz")
        check(health == {"status": "ok", "backend": "cuda",
                         "endpoints": ["/detect"]}, f"/healthz {health}")
        stats = get(url + "/stats")
        check(stats["detect"]["n"] == n_before + len(bodies),
              f"/stats {stats}")
        log(json.dumps({"server": "/detect", "requests": len(bodies),
                        "detections": [len(e["labels"]) for e in expected],
                        "healthz": health, "stats": stats,
                        "client_p50_ms": float(np.median(client_ms))}))
    finally:
        srv.shutdown()
    return 2 * len(bodies)


def phase_detect_latency(engine, image, tmp, smi) -> int:
    """(e) detect_path p50/p99 on the host clock over single-image calls
    (each ends in the one device-to-host copy)."""
    path = os.path.join(tmp, "latency.png")
    Image.fromarray(image).save(path)
    engine.detect_path(path)
    t = []
    for _ in range(DETECT_LATENCY_CALLS):
        t0 = time.perf_counter()
        engine.detect_path(path)
        t.append((time.perf_counter() - t0) * 1e3)
    log(json.dumps({"timing": "StreamingDetector.detect_path bf16",
                    "calls": len(t), "p50_ms": float(np.percentile(t, 50)),
                    "p99_ms": float(np.percentile(t, 99)),
                    "min_ms": float(np.min(t)), "card": smi}))
    return 1 + DETECT_LATENCY_CALLS


def phase_detect_profile(engine, image) -> int:
    """(f) where a bf16 detector forward's time goes: the device's busy
    share of the host's wall time and the kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reps = 5
    engine.forward(image)
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.forward(image)
    wall_us = (time.perf_counter() - t0) / reps * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            engine.forward(image)
    per_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            rec = per_name.setdefault(e.name, [0.0, 0])
            rec[0] += e.time_range.elapsed_us() / reps
            rec[1] += 1
    busy_us = sum(v[0] for v in per_name.values())
    by_category: dict[str, float] = {}
    for name, (us, _) in per_name.items():
        cat = next((c for c, keys in PROFILE_CATEGORIES
                    if any(k in name for k in keys)), "elementwise and other")
        by_category[cat] = by_category.get(cat, 0.0) + us
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:10]
    log(json.dumps({
        "profile": "StreamingDetector.forward bf16 deit_detector_ref",
        "wall_us_per_forward": wall_us,
        "device_busy_us_per_forward": busy_us,
        # None: the profiler saw no device time (not measured)
        "device_busy_share": busy_us / wall_us if busy_us else None,
        "kernels_per_forward": sum(v[1] for v in per_name.values()) / reps,
        "us_by_category": by_category,
        "top": [{"name": k[:80], "us": v[0], "calls": v[1] / reps}
                for k, v in top]}))
    return 1 + 2 * reps


def check_detector_counts(name, counts, forwards, per_forward) -> None:
    expected = {k: per_forward.get(k, 0) * forwards for k in counts}
    log(json.dumps({"launches": counts, "expected": expected,
                    "forwards": forwards, "path": name}))
    check(counts["flash_attention_fwd"] > 0,
          f"{name}: flash_attention_fwd never launched")
    check(counts == expected, f"{name}: launches {counts} != {expected}")


def phase_detector(smi) -> dict:
    """Phase 8. Returns the head-major and encoder-attention launches of
    the detector paths."""
    rng = np.random.default_rng(8)
    images = [rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)
              for _ in range(3)]
    bodies = [png_bytes(rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)),
              jpeg_bytes(rng.integers(0, 256, (180, 240, 3),
                                      dtype=np.uint8)),
              png_bytes(rng.integers(0, 256, (300, 200, 3), dtype=np.uint8))]
    launched = dict.fromkeys(("flash_attention_fwd", "encoder_attention_fwd")
                             + NORM_NAMES, 0)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = DETECTOR_PRESETS["deit_detector_ref"]
        params = init_detector(cfg, seed=0)
        zero_counts()  # the deit_detector_ref serving path starts here
        log("# phase 8(a-b): deit_detector_ref raw outputs")
        engine, forwards, raw = phase_detector_parity(
            "deit_detector_ref", cfg, params, images)
        log("# phase 8(c): post_process on the card and on the CPU")
        phase_post_process(raw)
        log("# phase 8(d): /detect")
        forwards += phase_detect_server(engine, bodies, tmp)
        log("# phase 8(e): detect_path latency")
        forwards += phase_detect_latency(engine, images[0], tmp, smi)
        log("# phase 8(f): profile of the bf16 detector forward")
        forwards += phase_detect_profile(engine, images[0])
        counts = read_counts()
        per_forward = {"flash_attention_fwd":
                       cfg.backbone.depth + cfg.head.depth,
                       **norm_launches(cfg, forwards=1)}
        check_detector_counts("deit_detector_ref", counts, forwards,
                              per_forward)
        for k in launched:
            launched[k] += counts[k]
        del engine, params

        log("# phase 8(g): vit_base_detector")
        cfg = DETECTOR_PRESETS["vit_base_detector"]
        params = init_detector(cfg, seed=0)
        zero_counts()  # the vit_base_detector serving path starts here
        _, forwards, _ = phase_detector_parity(
            "vit_base_detector", cfg, params, images[:2], bf16=False)
        engine = StreamingDetector(params, cfg, device="cuda")
        forwards += 1 + phase_detect_server(engine, bodies[:2], tmp)
        counts = read_counts()
        check_detector_counts("vit_base_detector", counts, forwards, {
            "encoder_attention_fwd": cfg.backbone.depth,
            "flash_attention_fwd": cfg.head.depth,
            **norm_launches(cfg, forwards=1)})
        for k in launched:
            launched[k] += counts[k]
    return launched


# Phase 9: detector training. (a) fp32 card against fp32 CPU, dropout off:
# the same arithmetic in other summation orders through 18 layers and
# their backward, with the same matched pairs; loss 1e-5 relative,
# grad_norm 1e-4. The update after step 1 (step 0 has lr 0) is close to
# lr * sign(g), so an element whose gradient lies within fp32 noise of
# zero moves differently: held as the relative L2 norm of the difference
# of the two updates, 1e-4. (b) bf16 against fp32 on the card, the bench
# configuration with dropout on (the same masks: Philox from host seeds,
# the residual masks from device generators drawn in fp32): bf16 rounds
# every activation to 8 mantissa bits through 18 layers, and a near-tie in
# the matcher may pick another pair; the warm-up keeps the weights at the
# init over the 3 steps, so each step is held: loss 2e-2, grad_norm 5e-2
# relative (the classifier step's bf16 limits).
DET_TRAIN_PRESET = "deit_detector_ref"
TOL_DET_TRAIN_LOSS = 1e-5
TOL_DET_TRAIN_NORM = 1e-4
TOL_DET_TRAIN_UPDATE = 1e-4
TOL_DET_BF16_LOSS = 2e-2
TOL_DET_BF16_NORM = 5e-2
DET_METRICS = ("loss", "loss_ce", "loss_bbox", "loss_giou",
               "cardinality_error", "loss_triplet", "grad_norm")


def det_train_cfg(**kw) -> TrainConfig:
    """`bench.py::bench_detect`'s configuration: the `deit_detector_ref`
    train preset (batch 32, bf16, plateau schedule, aux loss) with the
    detection augmentation on the 256 canvas, 25 box slots and attention
    dropout 0.1 (residual dropout 0.1 from the model preset)."""
    base = dict(preset=DET_TRAIN_PRESET, canvas=256, augment="detection",
                max_objects=25, attn_dropout=0.1)
    return TRAIN_PRESETS["deit_detector_ref"].with_overrides(**{**base, **kw})


def det_bench_batch(batch_size: int = 32) -> dict:
    """`bench_detect`'s fixed batch (numpy seed 3: 256² float images, one
    box tiled over 25 slots, random labels, 1-5 real boxes), on the
    card."""
    rng = np.random.default_rng(3)
    batch = {
        "image": rng.uniform(size=(batch_size, 256, 256, 3)).astype(
            np.float32),
        "boxes": np.tile(np.array([0.2, 0.2, 0.6, 0.6], np.float32),
                         (batch_size, 25, 1)),
        "labels": rng.integers(0, 6, (batch_size, 25)).astype(np.int32),
        "mask": np.arange(25)[None, :] < rng.integers(1, 6, (batch_size, 1)),
    }
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def det_random_batch(rng, n: int, size: int = 256, m: int = 25) -> dict:
    """uint8 images and distinct random boxes (unique optimal matchings),
    1-5 real boxes an image, numpy."""
    lo = rng.uniform(0.05, 0.6, (n, m, 2))
    wh = rng.uniform(0.1, 0.35, (n, m, 2))
    return {"image": rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            "boxes": np.concatenate([lo, lo + wh], -1).astype(np.float32),
            "labels": rng.integers(0, 6, (n, m)).astype(np.int32),
            "mask": np.arange(m)[None, :] < rng.integers(1, 6, (n, 1))}


class RecordMatches:
    """Record the assignments `make_detector_step_fns` gets from the
    matcher and the host time spent in it, by wrapping the name its module
    calls. `backend` sends the step's matching down that route (the
    step's `loss_cfg.matcher` with its backend replaced); `sync_debug`
    runs each call under ``torch.cuda.set_sync_debug_mode`` ("error": a
    synchronising call raises). The assignments stay on the device while
    recording (a copy would be a wait of its own) and come to the host
    after a synchronize at exit."""

    def __init__(self, backend: str | None = None,
                 sync_debug: str | None = None):
        self.backend, self.sync_debug = backend, sync_debug

    def __enter__(self):
        self.orig = detect_step.match_layers
        self.assignments, self.seconds = [], 0.0

        def recording(layers, labels, boxes, mask, cfg):
            if self.backend is not None:
                cfg = dataclasses.replace(cfg, backend=self.backend)
            t0 = time.perf_counter()
            if self.sync_debug is not None:
                torch.cuda.set_sync_debug_mode(self.sync_debug)
            try:
                out = self.orig(layers, labels, boxes, mask, cfg)
            finally:
                if self.sync_debug is not None:
                    torch.cuda.set_sync_debug_mode(0)
            self.seconds += time.perf_counter() - t0
            self.assignments.append(torch.stack([i for i, _ in out]))
            return out

        detect_step.match_layers = recording
        return self

    def __exit__(self, *exc):
        detect_step.match_layers = self.orig
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.assignments = [a.cpu() for a in self.assignments]


def sync_calls(fn) -> list[str]:
    """Run `fn` under ``torch.cuda.set_sync_debug_mode("warn")``; returns
    one "file:line function" a synchronising call, the innermost frame of
    the port or of this script on the Python stack when it warned (a
    backward's op warns at the call that ran the backward)."""
    import traceback
    import warnings

    calls = []
    here = os.path.dirname(os.path.abspath(__file__))

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if os.path.abspath(f.filename).startswith(here)]
        where = (f"{os.path.relpath(frames[-1].filename, here)}:"
                 f"{frames[-1].lineno} {frames[-1].name}" if frames
                 else f"{filename}:{lineno}")
        calls.append(where)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return calls


def clone_state(state) -> dict:
    def copy(x):
        return x.detach().clone() if isinstance(x, torch.Tensor) else x

    return {"params": tree_map(copy, state["params"]),
            "opt_state": tree_map(copy, state["opt_state"]),
            "step": state["step"]}


def phase_det_train_parity(tcfg=None, size: int = 256) -> dict:
    """(a) 2 fp32 steps of batch 4 at `deit_detector_ref` with the preset's
    residual and positional dropout 0.1 (every mask a function of the
    site's seed and global indices: the apply kernel on the card, its plain
    version on the CPU) and attention dropout 0 (the plain (B, H, S, S)
    attention masks would add ~20-30 s of the CPU's time; the
    kernels' masks are held by phase 3's probes and 11(c)), detection
    augmentation on, on the card and on the CPU from the same init,
    batches and draws; or (phase 17(d)) the config `tcfg` on images of
    `size`."""
    tcfg = tcfg or det_train_cfg(batch_size=4, bf16=False, warmup_steps=1,
                                 attn_dropout=0.0)
    rng = np.random.default_rng(9)
    batches = [det_random_batch(rng, 4, size, tcfg.max_objects)
               for _ in range(2)]
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        init_fn, step, _ = make_detector_step_fns(tcfg, device=dev)
        state = init_fn()
        start = [p.detach().cpu().clone()
                 for p in tree_leaves(state["params"])]
        metrics = []
        with RecordMatches() as rec:
            for batch in batches:
                state, m = step(state, batch, step_seed=3)
                metrics.append({k: float(m[k]) for k in DET_METRICS})
        final = [p.detach().cpu() for p in tree_leaves(state["params"])]
        runs[dev] = (metrics, start, final, rec.assignments,
                     time.perf_counter() - t0)
        del state
    (m_gpu, s_gpu, f_gpu, a_gpu, t_gpu), (m_cpu, s_cpu, f_cpu, a_cpu,
                                          t_cpu) = runs["cuda"], runs["cpu"]
    for a, b in zip(s_gpu, s_cpu):
        check(torch.equal(a, b), "card and CPU start from different weights")
    upd_gpu = torch.cat([(f - s).flatten() for f, s in zip(f_gpu, s_gpu)])
    upd_cpu = torch.cat([(f - s).flatten() for f, s in zip(f_cpu, s_cpu)])
    rel = {k: max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                  for a, b in zip(m_gpu, m_cpu)) for k in DET_METRICS}
    same_matches = len(a_gpu) == len(a_cpu) and all(
        torch.equal(a, b) for a, b in zip(a_gpu, a_cpu))
    rec = {"check": "detector train step fp32 cuda vs cpu",
           "preset": tcfg.preset, "batch": 4, "steps": 2,
           "dropout": resolve_detector(tcfg).head.dropout,
           "attn_dropout": tcfg.attn_dropout, "augment": tcfg.augment,
           "metrics_cuda": m_gpu, "metrics_cpu": m_cpu,
           "max_rel_err": rel,
           "rel_l2_err_update": float((upd_gpu - upd_cpu).norm()
                                      / upd_cpu.norm()),
           "matched_indices_identical": same_matches,
           "matched_layers_per_step": int(a_gpu[0].shape[0]),
           "seconds_cuda": t_gpu, "seconds_cpu": t_cpu}
    log(json.dumps(rec))
    check(all(np.isfinite(list(m.values())).all() for m in m_gpu),
          "non-finite card detector train metrics")
    check(same_matches, "the card and the CPU matched different pairs")
    check(rel["loss"] <= TOL_DET_TRAIN_LOSS,
          f"detector train loss cuda vs cpu {rel['loss']}")
    check(rel["grad_norm"] <= TOL_DET_TRAIN_NORM,
          f"detector grad_norm cuda vs cpu {rel['grad_norm']}")
    check(rec["rel_l2_err_update"] <= TOL_DET_TRAIN_UPDATE,
          f"detector update cuda vs cpu {rec['rel_l2_err_update']}")
    return rec


def phase_det_train_bf16() -> dict:
    """(b) 3 steps of the bench configuration in fp32 and in bf16 on the
    card, from the same init, batch, draws and dropout masks."""
    batch = det_bench_batch()
    runs = {}
    for bf16 in (False, True):
        init_fn, step, _ = make_detector_step_fns(det_train_cfg(bf16=bf16))
        state = init_fn()
        metrics = []
        with RecordMatches() as rec:
            for _ in range(3):
                state, m = step(state, batch)
                metrics.append({k: float(m[k]) for k in DET_METRICS})
        runs[bf16] = (metrics, rec.assignments)
        del state
    (m32, a32), (m16, a16) = runs[False], runs[True]
    rel = {k: max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                  for a, b in zip(m16, m32)) for k in DET_METRICS}
    agree = sum(int((a == b).all(dim=-1).sum()) for a, b in zip(a16, a32))
    total = sum(a.shape[0] * a.shape[1] for a in a32)
    rec = {"check": "detector train step bf16 vs fp32 on the card",
           "batch": 32, "steps": 3, "metrics_fp32": m32, "metrics_bf16": m16,
           "max_rel_err": rel,
           "images_matched_alike": f"{agree}/{total}"}
    log(json.dumps(rec))
    check(all(np.isfinite(list(m.values())).all() for m in m16 + m32),
          "non-finite bf16/fp32 detector train metrics")
    check(rel["loss"] <= TOL_DET_BF16_LOSS, f"bf16 vs fp32 loss {rel}")
    check(rel["grad_norm"] <= TOL_DET_BF16_NORM,
          f"bf16 vs fp32 grad_norm {rel}")
    return rec


# 9(c)'s matcher routes, timed in turns (host speed moves between calls,
# and within one; ROADMAP "Budget"): the device route (csrc/lap.cu, the
# default) and the scipy oracle (one copy to the host a step).
DET_ROUTE_ORDER = ("device", "scipy", "scipy", "device") * 2


def det_route_window(step, state, batch, backend: str, steps: int):
    """`steps` timed steps with the matcher on `backend`: (state, losses,
    ms per step, match_layers host ms per step, lap launches)."""
    torch.cuda.synchronize()
    launches = matcher.LAUNCHES
    losses = []
    with RecordMatches(backend) as matches:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, batch)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    return (state, losses, dt / steps * 1e3, matches.seconds / steps * 1e3,
            matcher.LAUNCHES - launches)


def det_step_syncs(step, state, batch, backend: str) -> tuple[dict, dict]:
    """One whole step on `backend`: (state, its synchronising calls by
    place)."""
    out, after = {}, [state]

    def one():
        after[0] = step(state, batch)[0]

    with RecordMatches(backend):  # its exit's copy is not the step's
        calls = sync_calls(one)
    for where in calls:
        out[where] = out.get(where, 0) + 1
    return after[0], out


def phase_det_train_bench(smi: str):
    """(c) the bench configuration on both matcher routes: 2 warm-up
    steps, then 5 timed steps a window in the order `DET_ROUTE_ORDER`;
    the device route's `match_layers` under sync debug mode "error" for
    one step, and each route's synchronising calls in one whole step;
    one step run twice from the same state and seed; (d) eval_step and
    evaluate_detector over two batches; (e) a profile of one step on each
    route; before them, outside the counted path, `match_layers_calls`.
    Returns the launch counts of (c)-(e)."""
    calls = match_layers_calls()
    check(0 < calls["kernels_per_call"] <= 3,
          f"match_layers launched no kernel or more than 3 a call: {calls}")
    steps_warm, steps_timed = 2, 5
    tcfg = det_train_cfg()
    init_fn, step, eval_step = make_detector_step_fns(tcfg)
    state = init_fn()
    batch = det_bench_batch()
    det_cfg = DETECTOR_PRESETS[DET_TRAIN_PRESET]
    per_step = det_cfg.backbone.depth + det_cfg.head.depth
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()  # the detector training path starts here
    losses = []
    for _ in range(steps_warm):
        state, m = step(state, batch)
        losses.append(m["loss"])
    routes = {r: {"ms_per_step": [], "match_layers_ms_per_step": [],
                  "lap_launches": []} for r in DET_ROUTE_ORDER}
    in_order = []
    for backend in DET_ROUTE_ORDER:
        state, window, window_ms, match_ms, launched = det_route_window(
            step, state, batch, backend, steps_timed)
        in_order.append(window_ms)
        losses += window
        routes[backend]["ms_per_step"].append(window_ms)
        routes[backend]["match_layers_ms_per_step"].append(match_ms)
        routes[backend]["lap_launches"].append(launched)
    device_steps = steps_warm + steps_timed * DET_ROUTE_ORDER.count("device")
    scipy_steps = steps_timed * DET_ROUTE_ORDER.count("scipy")
    losses = [float(v) for v in losses]
    last = {k: float(m[k]) for k in DET_METRICS}
    ms = {r: float(np.mean(v["ms_per_step"])) for r, v in routes.items()}
    rec = {"timing": "detector train step deit_detector_ref bench config",
           "batch": tcfg.batch_size, "dtype": "bfloat16",
           "augment": "detection", "canvas": 256, "attn_dropout": 0.1,
           "steps_timed_per_window": steps_timed,
           "route_order": DET_ROUTE_ORDER, "routes": routes,
           # each neighbouring pair of windows holds one of each route
           "device_minus_scipy_ms_by_pair": [
               (a - b) * (1 if r == "device" else -1) for r, a, b in zip(
                   DET_ROUTE_ORDER[::2], in_order[::2], in_order[1::2])],
           "ms_per_step": ms["device"],
           "train_images_per_s": tcfg.batch_size / ms["device"] * 1e3,
           "ms_per_step_scipy": ms["scipy"],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses, "last_metrics": last, "card": smi}
    log(json.dumps(rec))
    check(all(np.isfinite(losses)) and all(np.isfinite(list(last.values()))),
          f"non-finite detector train metrics {rec}")
    windows = len(DET_ROUTE_ORDER) // 2
    check(routes["device"]["lap_launches"] == [steps_timed] * windows
          and routes["scipy"]["lap_launches"] == [0] * windows,
          f"lap launches per window {routes}")

    # the device route's matcher never waits for the card; what the whole
    # step still waits for, on each route
    with RecordMatches("device", sync_debug="error") as strict:
        state, m = step(state, batch)
    device_steps += 1
    check(len(strict.assignments) == 1, "the matcher ran no time")
    syncs = {}
    for backend in ("device", "scipy"):
        state, syncs[backend] = det_step_syncs(step, state, batch, backend)
    device_steps += 1
    scipy_steps += 1
    log(json.dumps({"check": "synchronising calls of one detector train "
                             "step, by place",
                    "match_layers_device_route_under_error_mode": "none",
                    "device_route": syncs["device"],
                    "device_route_total": sum(syncs["device"].values()),
                    "scipy_route": syncs["scipy"],
                    "scipy_route_total": sum(syncs["scipy"].values())}))

    # the same state, batch and seed give the same step
    base = clone_state(state)
    repeat = []
    for _ in range(2):
        _, m = step(clone_state(base), batch)
        repeat.append(float(m["loss"]))
    log(json.dumps({"check": "detector train step repeated", "losses":
                    repeat}))
    check(repeat[0] == repeat[1], f"a repeated step differs: {repeat}")
    device_steps += 2

    log("# phase 9(d): detector eval_step and evaluate_detector")
    rng = np.random.default_rng(10)
    evs = [dict(det_random_batch(rng, 16),
                valid=(np.arange(16) < 15).astype(np.int32)),
           det_random_batch(rng, 16)]
    e = eval_step(state["params"], evs[0])
    check(int(e["count"]) == 15 and bool(torch.isfinite(e["loss"]))
          and tuple(e["outputs"]["class_logits"].shape) == (16, 5, 7),
          f"detector eval_step {e}")
    res = evaluate_detector(eval_step, state["params"], evs, num_classes=6,
                            conf_threshold=0.05)
    check(np.isfinite(res["loss"]) and 0.0 <= res["mAP"] <= 1.0
          and len(res["per_class"]) == 6, f"evaluate_detector {res}")
    log(json.dumps({"check": "detector eval",
                    "eval_step_loss": float(e["loss"]),
                    "eval_step_count": int(e["count"]),
                    **{k: res[k] for k in ("loss", "mAP", "AP50",
                                           "total_predictions",
                                           "predictions_per_image")}}))

    log("# phase 9(e): profile of one detector train step on each route")
    prof = phase_train_profile(state, step, batch, ms["device"],
                               title="detector train step deit_detector_ref "
                                     "bench config, device matcher")
    with RecordMatches("scipy"):
        prof_scipy = phase_train_profile(
            state, step, batch, ms["scipy"],
            title="detector train step deit_detector_ref bench config, "
                  "scipy matcher")
    device_steps += 1
    scipy_steps += 1
    log(json.dumps({"timing": "detector train step by matcher route",
                    "ms_per_step": ms, "match_layers_ms_per_step": {
                        r: float(np.mean(v["match_layers_ms_per_step"]))
                        for r, v in routes.items()},
                    "device_busy_share": {
                        "device": prof["device_busy_share"],
                        "scipy": prof_scipy["device_busy_share"]},
                    "kernels_per_step": {
                        "device": prof["kernels_per_step"],
                        "scipy": prof_scipy["kernels_per_step"]},
                    "match_layers_kernels_per_call": calls[
                        "kernels_per_call"],
                    "match_layers_host_ms_per_call": calls[
                        "host_ms_per_call"],
                    "peak_memory_gb": rec["peak_memory_gb"],
                    "synchronising_calls_per_step": {
                        r: sum(v.values()) for r, v in syncs.items()},
                    "card": smi}))
    counts = read_counts()
    steps = device_steps + scipy_steps
    evals = 1 + len(evs)
    forwards = steps + evals
    # every training launch runs the dropout branch, no eval launch does;
    # one microbatch a step, 49 dropout sites each (25 in the backbone, 4
    # in each of the decoder's 6 layers), one apply launch each way; one
    # lap launch a device-route step and an eval forward (its loss
    # matches the final layer)
    expected = {**dict.fromkeys(counts, 0), "fused_adamw": steps,
                "flash_attention_fwd": per_step * forwards,
                "flash_attention_bwd": per_step * steps,
                "flash_attention_fwd_dropout": per_step * steps,
                "flash_attention_bwd_dropout": per_step * steps,
                "dropout_apply": site_launches(resolve_detector(tcfg))
                * steps,
                "lap": device_steps + evals,
                **norm_launches(det_cfg, forwards=evals,
                                micro=steps * tcfg.grad_accum,
                                aux=tcfg.aux_loss)}
    log(json.dumps({"launches": counts, "expected": expected,
                    "steps": steps, "device_route_steps": device_steps,
                    "scipy_route_steps": scipy_steps,
                    "eval_forwards": evals,
                    "path": "deit_detector_ref training",
                    "per_step": {"flash_attention_fwd": per_step,
                                 "flash_attention_bwd": per_step,
                                 "lap": 1,
                                 "kernels": prof["kernels_per_step"]}}))
    check(counts["flash_attention_bwd"] > 0,
          "flash_attention_bwd never launched")
    check(counts["lap"] > 0, "lap never launched")
    check(counts == expected, f"detector training launches {counts} != "
                              f"{expected}")
    return counts


def match_layers_calls() -> dict:
    """The kernels one `match_layers` call launches on the default route at
    the bench step's shape (6 layers, B = 32, Q = 5, M = 25, C + 1 = 7;
    seeded inputs on the card), counted by torch.profiler over 10 calls
    after a warm-up cycle of 10 (the profiler drops events at the start of
    its first cycle), and the host's ms a call over 50 calls, each made on
    an idle card. --detector-ab runs it in each tree
    (`DET_AB_CHILD` ships its source), so it imports what it uses and calls
    only `match_layers`, which every tree has."""
    import json
    import time

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from arsvt_tpu_torch.objectives.matcher import match_layers

    n_layers, b, q, m, classes = 6, 32, 5, 25, 7
    rng = np.random.default_rng(29)

    def card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    layers = [(card((rng.standard_normal((b, q, classes)) * 2)
                    .astype(np.float32)),
               card((1 / (1 + np.exp(-rng.standard_normal((b, q, 4)))))
                    .astype(np.float32))) for _ in range(n_layers)]
    lo = rng.uniform(0.0, 0.6, (b, m, 2))
    targets = (card(rng.integers(0, classes - 1, (b, m)).astype(np.int32)),
               card(np.concatenate([lo, lo + 0.2], -1).astype(np.float32)),
               card(np.arange(m)[None, :] < rng.integers(0, 6, (b, 1))))
    calls = 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            for _ in range(calls):
                match_layers(layers, *targets)
            torch.cuda.synchronize()
            prof.step()
    kernels = sum(e.device_type == DeviceType.CUDA
                  for e in prof.events()) / calls
    total = 0.0
    for _ in range(50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        match_layers(layers, *targets)
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    rec = {"timing": "match_layers calls", "shape": [n_layers, b, q, m],
           "classes": classes, "kernels_per_call": kernels,
           "host_ms_per_call": total / 50 * 1e3}
    print(json.dumps(rec), flush=True)
    return rec


# 9(c) of another tree, in a subprocess of its own: that tree's
# chip_smoke.py and package, with its build module and native loader
# pointed at this tree's build directory (ARSVT_AB_BUILD_DIR). Libraries
# are named by a hash of their source, headers and flags, so the kernels
# the two trees share are loaded as built and the others compiled there;
# nothing is written into the other tree (no bytecode either).
DET_AB_CHILD = (
    "import os, pathlib, subprocess, torch\n"
    "from arsvt_tpu_torch.data import native_loader\n"
    "from arsvt_tpu_torch.ops import build\n"
    "build.BUILD_DIR = native_loader.BUILD_DIR = pathlib.Path(\n"
    "    os.environ['ARSVT_AB_BUILD_DIR'])\n"
    "import chip_smoke as cs\n"
    "torch.backends.cuda.matmul.allow_tf32 = False\n"
    "torch.backends.cudnn.allow_tf32 = False\n"
    "cs.phase_det_train_bench(subprocess.run(['nvidia-smi', "
    "'--query-gpu=name,power.limit', '--format=csv,noheader'], "
    "capture_output=True, text=True).stdout.strip())\n"
    + inspect.getsource(match_layers_calls) + "match_layers_calls()\n")


def phase_detector_ab(parent: str, smi: str) -> None:
    """9(c) of `parent` (a checkout of the parent commit, read and never
    written) and of this tree, in turns (parent, this, this, parent), one
    subprocess each: ms/step, busy share, kernels a step and peak memory
    of each run, side by side."""
    here = os.path.dirname(os.path.abspath(__file__))
    parent = os.path.abspath(parent)
    env = {**os.environ, "PYTHONDONTWRITEBYTECODE": "1",
           "ARSVT_AB_BUILD_DIR": str(build.BUILD_DIR)}
    runs = []
    for tree in (parent, here, here, parent):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-c", DET_AB_CHILD], cwd=tree,
            env={**env, "PYTHONPATH": tree}, capture_output=True,
            text=True, timeout=900)
        check(out.returncode == 0,
              f"9(c) of {tree} failed:\n{out.stdout[-3000:]}"
              f"{out.stderr[-3000:]}")
        recs = [json.loads(line) for line in out.stdout.splitlines()
                if line.startswith("{")]
        bench = next(r for r in recs if r.get("timing", "").startswith(
            "detector train step deit_detector_ref bench"))
        route = next(r for r in recs if r.get("timing")
                     == "detector train step by matcher route")
        runs.append({"tree": "parent" if tree == parent else "this",
                     "ms_per_step": route["ms_per_step"],
                     "windows_ms": bench["routes"]["device"]["ms_per_step"],
                     "device_busy_share": route["device_busy_share"],
                     "kernels_per_step": next(
                         r["kernels_per_step"] for r in recs
                         if "kernels_per_step" in r),
                     "match_layers_ms_per_step": route[
                         "match_layers_ms_per_step"]["device"],
                     "match_layers_kernels_per_call": next(
                         r["kernels_per_call"] for r in recs
                         if r.get("timing") == "match_layers calls"),
                     "peak_memory_gb": bench["peak_memory_gb"],
                     "seconds": time.perf_counter() - t0})
        log(json.dumps({"detector_ab": runs[-1], "card": smi}))
    # the host's ms in match_layers a step, this tree against the parent in
    # each pair (parent, this) and (this, parent)
    pairs = [(runs[1], runs[0]), (runs[2], runs[3])]
    log(json.dumps({"detector_ab_match_layers_ms_per_step": [
        [t["match_layers_ms_per_step"], p["match_layers_ms_per_step"]]
        for t, p in pairs], "card": smi}))
    check(all(t["match_layers_ms_per_step"] < p["match_layers_ms_per_step"]
              for t, p in pairs),
          f"match_layers' host ms a step is not below the parent's: {runs}")


# --ab PARENT: the paths the LayerNorm and GELU kernels changed, of the
# checkout PARENT and of this tree in turns (parent, this, this, parent),
# each in a subprocess as DET_AB_CHILD runs 9(c), through functions both
# trees' chip_smoke.py have: the four bf16 kernels held on the device at
# 3(c)'s timed shapes (`NORM_AB_SHAPES`, through each tree's wrappers)
# beside F.layer_norm and F.gelu(tanh) and their autograd backwards, a B
# = 1 /classify p50 over 100 requests (ViT-B/16, bf16, a seeded head),
# 7(b)'s default ViT-B bench step with 7(d)'s profile, 9(c) and the
# vit_large_384 preset's step as 14(e) times it (1 warm-up and 3 timed
# steps) with a profile.
NORM_AB_SHAPES = {"vit_b": (6304, 768, 3072), "detector": (6336, 400, 1600),
                  "vit_l": (9232, 1024, 4096), "serve_b1": (197, 768, 3072)}
TREE_AB_CHILD = DET_AB_CHILD.rsplit("cs.phase_det_train_bench", 1)[0] + (
    "import json, numpy as np\n"
    "import torch.nn.functional as F\n"
    "smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', "
    "'--format=csv,noheader'], capture_output=True, text=True)"
    ".stdout.strip()\n"
    "gen = torch.Generator(device='cuda').manual_seed(35)\n"
    "bf = torch.bfloat16\n"
    "def held(fn):\n"
    "    for hold in (2_000_000, 8_000_000, 32_000_000):\n"
    "        try:\n"
    "            return cs.device_ms(fn, iters=50, hold_cycles=hold)\n"
    "        except RuntimeError:\n"
    "            if hold == 32_000_000:\n"
    "                raise\n"
    "kern = {}\n"
    f"for cell, (rows, d, m) in {NORM_AB_SHAPES!r}.items():\n"
    "    x, scale, bias, g = cs.ln_inputs(rows, d, bf, bf, gen)\n"
    "    _, mean, rstd = cs.ln_ops.layer_norm_fwd(x, scale, bias, "
    "cs.NORM_EPS)\n"
    "    xr, sr, br = (t.clone().requires_grad_(True) for t in (x, scale, "
    "bias))\n"
    "    y = F.layer_norm(xr, (d,), sr, br, cs.NORM_EPS)\n"
    "    u = torch.randn(rows, m, generator=gen, device='cuda').mul(4)"
    ".to(bf)\n"
    "    gu = torch.randn(rows, m, generator=gen, device='cuda').to(bf)\n"
    "    ur = u.clone().requires_grad_(True)\n"
    "    h = F.gelu(ur, approximate='tanh')\n"
    "    kern[cell] = {\n"
    "        'ln_fwd': held(lambda: cs.ln_ops.layer_norm_fwd(x, scale, "
    "bias, cs.NORM_EPS)),\n"
    "        'ln_bwd': held(lambda: cs.ln_ops.layer_norm_bwd(x, g, scale, "
    "mean, rstd)),\n"
    "        'gelu_fwd': held(lambda: cs.mlp_ops.gelu_tanh_fwd(u)),\n"
    "        'gelu_bwd': held(lambda: cs.mlp_ops.gelu_tanh_bwd(u, gu)),\n"
    "        'library_ln_fwd': held(lambda: F.layer_norm(x, (d,), scale, "
    "bias, cs.NORM_EPS)),\n"
    "        'library_ln_bwd': held(lambda: torch.autograd.grad(y, (xr, sr, "
    "br), g, retain_graph=True)),\n"
    "        'library_gelu_fwd': held(lambda: F.gelu(u, "
    "approximate='tanh')),\n"
    "        'library_gelu_bwd': held(lambda: torch.autograd.grad(h, ur, gu, "
    "retain_graph=True))}\n"
    "    del x, g, xr, y, u, gu, ur, h\n"
    "print(json.dumps({'ab': 'kernels_device_ms', **kern}), flush=True)\n"
    "def profiled(name, ms, peak, prof):\n"
    "    print(json.dumps({'ab': name, 'ms_per_step': ms, "
    "'peak_memory_gb': peak, 'device_busy_ms': "
    "prof['device_busy_ms_per_step'], 'device_busy_share': "
    "prof['device_busy_share'], 'kernels_per_step': "
    "prof['kernels_per_step'], 'ms_by_category': prof['ms_by_category']}),"
    " flush=True)\n"
    "cfg = cs.PRESETS['vit_base_16_224']\n"
    "params = cs.seeded_head(cs.init_image_classifier(cfg, 6, seed=0), "
    "cfg.embed_dim, 6, seed=1)\n"
    "srv = cs.InferenceServer(classifier=cs.StreamingClassifier(params, cfg, "
    "6, device='cuda'))\n"
    "body = cs.png_bytes(np.random.default_rng(17).integers(0, 256, "
    "(224, 224, 3), dtype=np.uint8))\n"
    "print(json.dumps({'ab': 'classify_b1', **cs.serve_latency(srv, body, "
    "100)}), flush=True)\n"
    "del srv, params\n"
    "rec, _, state, step, batch = cs.phase_train_bench(cfg, smi)\n"
    "profiled('vit_b_train', rec['ms_per_step'], rec['peak_memory_gb'], "
    "cs.phase_train_profile(state, step, batch, rec['ms_per_step']))\n"
    "del state, step, batch\n"
    "cs.phase_det_train_bench(smi)\n"
    "tcfg = cs.TRAIN_PRESETS['vit_large_384']\n"
    "init_fn, step, _ = cs.make_classifier_step_fns(tcfg)\n"
    "state = cs.fresh_vitl_state(init_fn)\n"
    "batch = cs.batch_of(tcfg, torch.Generator(device='cuda').manual_seed("
    "18), tcfg.batch_size)\n"
    "state, ms, losses, peak = cs.time_steps(step, state, batch, 1, 3)\n"
    "profiled('vit_l_train', ms, peak, cs.phase_train_profile(state, step, "
    "batch, ms, title='train step vit_large_384 as it stands'))\n")


def phase_tree_ab(parent: str, smi: str) -> None:
    """The paths of TREE_AB_CHILD for `parent` (a checkout of the parent
    commit, read and never written) and this tree, in turns (parent, this,
    this, parent), one subprocess each, side by side: ms/step, device-busy
    ms and share, kernels a step and peak memory of each training path,
    the /classify p50."""
    here = os.path.dirname(os.path.abspath(__file__))
    parent = os.path.abspath(parent)
    env = {**os.environ, "PYTHONDONTWRITEBYTECODE": "1",
           "ARSVT_AB_BUILD_DIR": str(build.BUILD_DIR)}
    runs = []
    for tree in (parent, here, here, parent):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-c", TREE_AB_CHILD], cwd=tree,
            env={**env, "PYTHONPATH": tree}, capture_output=True,
            text=True, timeout=1500)
        check(out.returncode == 0,
              f"the A/B paths of {tree} failed:\n{out.stdout[-3000:]}"
              f"{out.stderr[-3000:]}")
        recs = [json.loads(line) for line in out.stdout.splitlines()
                if line.startswith("{")]
        run = {r["ab"]: {k: v for k, v in r.items() if k != "ab"}
               for r in recs if "ab" in r}
        route = next(r for r in recs if r.get("timing")
                     == "detector train step by matcher route")
        det_prof = next(r for r in recs if r.get("profile", "").startswith(
            "detector train step deit_detector_ref bench config, device"))
        run["detector_train"] = {
            "ms_per_step": route["ms_per_step"]["device"],
            "peak_memory_gb": route["peak_memory_gb"],
            "device_busy_ms": det_prof["device_busy_ms_per_step"],
            "device_busy_share": route["device_busy_share"]["device"],
            "kernels_per_step": route["kernels_per_step"]["device"],
            "ms_by_category": det_prof["ms_by_category"]}
        log(json.dumps({"tree_ab": "parent" if tree == parent else "this",
                        **run, "seconds": time.perf_counter() - t0,
                        "card": smi}))
        runs.append(("parent" if tree == parent else "this", run))
    # each kernel's held ms, this tree's two runs over the parent's two
    kern = {t: [r["kernels_device_ms"] for n, r in runs if n == t]
            for t in ("parent", "this")}
    ratios = {c: {k: sum(r[c][k] for r in kern["this"])
                  / sum(r[c][k] for r in kern["parent"])
                  for k in kern["this"][0][c]} for c in NORM_AB_SHAPES}
    log(json.dumps({"tree_ab": "kernels, this / parent (held device ms, "
                    "two runs each)", "ratios": ratios, "card": smi}))


def phase_detector_training(smi) -> dict:
    """Phase 9. Returns the launch counts of the training path, (c)-(e)."""
    log("# phase 9(a): deit_detector_ref fp32 train step, card vs CPU")
    phase_det_train_parity()
    log("# phase 9(b): bf16 vs fp32 train steps on the card")
    phase_det_train_bf16()
    log("# phase 9(c): the bench_detect configuration")
    return phase_det_train_bench(smi)


# Phase 11: the training entry point, ``python -m
# arsvt_tpu_torch.train.cli``, driven in-process on the card, each run in a
# directory of its own (the CLI writes metrics.jsonl and checkpoints/ into
# its working directory). (a)/(b): the vit_base_bf16_flash preset (batch
# 128 as 4 x 32, bf16) with attention dropout 0.1, crop/flip, fused
# AdamW and a warm-up of 10 steps (the preset's 500 would keep the loss
# at log(6) to 6 digits over these few steps; within the linear warm-up
# the learning rate does not depend on total_steps, which --steps sets, so
# a 4-step run resumed to 6 follows the 6-step run), on the default and
# the opt-in route: 4 steps with checkpoints every 2 and one eval at step
# 4 (one, since the CLI's synthetic batches at 256² take seconds each on
# the host, and an eval reads 8 of them), a resume to step 6 (no
# eval) held against an uninterrupted 6-step run (the same
# weights, Adam state, batches and masks: the losses of steps 5-6 should
# agree to the bit; TOL_RESUME allows a last-bit difference from a
# non-deterministic reduction, which the log would show), and 3 steps of
# a run without dropout: both runs start at the same weights with a zero
# head (loss log(6)) and step 1 has lr 0, so the gradients differ from
# step 1 and the losses from step 3. The wrappers count the launches that
# ran the dropout branch: every training launch of the dropout runs, no
# eval launch and none of the run without dropout. (c) fp32 steps card vs
# CPU with dropout on each route (phase 7(a)'s limits), and the two
# routes' card runs against each other: one mask, so the loss within TOL_TRAIN_LOSS and the grad norm
# within TOL_TRAIN_NORM (the save-probs backward reads P in bf16). (d)
# `Trainer` with task="detect" on vit_base_detector.
# batch 128 as 4 x 32, a quarter of the preset's 512 as 16 x 32: the host
# makes the CLI's synthetic batches, seconds each at 512
CLI_MICRO = 4
CLI_ARGS = ["--train-preset", "vit_base_bf16_flash", "--attn-dropout", "0.1",
            "--augment", "crop_flip", "--fused-adamw", "true",
            "--batch-size", str(32 * CLI_MICRO), "--grad-accum",
            str(CLI_MICRO), "--warmup-steps", "10", "--log-every", "1"]
TOL_RESUME = 1e-6
EVAL_BATCHES = 8  # train/cli.py::make_data's eval stream


def cli_metric(directory, key: str = "loss") -> dict:
    """{step: train/<key>} from a run's metrics.jsonl."""
    out = {}
    with open(os.path.join(directory, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if f"train/{key}" in rec:
                out[rec["step"]] = float(rec[f"train/{key}"])
    return out


def run_cli(directory, args, *, expect=None, base=CLI_ARGS,
            main=None) -> tuple[dict, dict, float]:
    """`main(base + args)` (default: `train.cli.main`) with `directory` as
    the working directory; launches counted from 0 and, with `expect`,
    held exact. Returns (what `main` returns, launch counts, seconds)."""
    if main is None:
        from arsvt_tpu_torch.train.cli import main

    os.makedirs(directory, exist_ok=True)
    here = os.getcwd()
    os.chdir(directory)
    try:
        torch.cuda.synchronize()
        zero_counts()  # this run's path starts here
        t0 = time.perf_counter()
        last = main(base + args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
    finally:
        os.chdir(here)
    if expect is not None:
        what = f"{main.__module__} {' '.join(base + args)}"
        log(json.dumps({"launches": counts, "expected": expect,
                        "path": what}))
        check(counts == expect, f"{what}: launches {counts} != {expect}")
    return last, counts, seconds


def add_counts(into: dict, counts: dict) -> None:
    for k, v in counts.items():
        into[k] += v


def phase_cli(tmp, smi, opt_in: bool) -> dict:
    """(a) or (b): the CLI on one route. Returns the launches of its runs,
    the dropout branches' counts included."""
    route = "opt-in" if opt_in else "default"
    base = os.path.join(tmp, route)
    micro, depth = CLI_MICRO, PRESETS["vit_base_16_224"].depth
    total = dict.fromkeys((name for name, _, _ in COUNTERS), 0)

    def train_launches(steps, eval_forwards):
        return classifier_launches(depth, micro, steps, eval_forwards,
                                   opt_in, dropout=True)

    with switches(opt_in):
        torch.cuda.reset_peak_memory_stats()
        run = os.path.join(base, "run")
        _, counts, secs4 = run_cli(
            run, ["--steps", "4", "--eval-every", "4", "--checkpoint-every",
                  "2"], expect=train_launches(4, EVAL_BATCHES))
        add_counts(total, counts)
        peak = torch.cuda.max_memory_allocated() / 1e9
        ckpts = sorted(os.listdir(os.path.join(run, "checkpoints")))
        check(ckpts == ["step_000000002.pt", "step_000000004.pt"],
              f"{route}: checkpoints {ckpts}")
        _, counts, secs_resume = run_cli(
            run, ["--steps", "6", "--eval-every", str(10**9),
                  "--checkpoint-every", "2", "--resume"],
            expect=train_launches(2, 0))
        add_counts(total, counts)
        whole = os.path.join(base, "uninterrupted")
        _, counts, secs6 = run_cli(
            whole, ["--steps", "6", "--eval-every", str(10**9),
                    "--checkpoint-every", str(10**9)],
            expect=train_launches(6, 0))
        add_counts(total, counts)
        nodrop = os.path.join(base, "no_dropout")
        _, counts, _ = run_cli(
            nodrop, ["--steps", "3", "--attn-dropout", "0.0", "--eval-every",
                     str(10**9), "--checkpoint-every", str(10**9)],
            expect=classifier_launches(depth, micro, 3, 0, opt_in))
        add_counts(total, counts)
    resumed, ref, plain = (cli_metric(d) for d in (run, whole, nodrop))
    norm, norm_plain = cli_metric(whole, "grad_norm"), cli_metric(
        nodrop, "grad_norm")
    rel = max(abs(resumed[s] - ref[s]) / abs(ref[s]) for s in (5, 6))
    rec = {"check": f"train.cli {route} route, attention dropout 0.1",
           "losses_resumed_run": resumed, "losses_uninterrupted": ref,
           "losses_without_dropout": plain, "grad_norms": norm,
           "grad_norms_without_dropout": norm_plain,
           "max_rel_diff_loss_steps_5_6_resumed_vs_uninterrupted": rel,
           "checkpoints": ckpts, "peak_memory_gb": peak,
           "seconds_4_steps_1_eval": secs4,
           "seconds_resume_2_steps": secs_resume,
           "seconds_6_steps": secs6,
           "ms_per_step_6_step_run_with_data": secs6 / 6 * 1e3,
           "card": smi}
    log(json.dumps(rec))
    check(all(np.isfinite(list(resumed.values()) + list(ref.values()))),
          f"{route}: non-finite CLI losses {rec}")
    check(rel <= TOL_RESUME, f"{route}: resumed steps differ from the "
                             f"uninterrupted run: {rel}")
    check(resumed[1] == ref[1], f"{route}: two runs started apart {rec}")
    check(norm[1] != norm_plain[1] and ref[3] != plain[3],
          f"{route}: dropout moved neither the gradient nor the loss {rec}")
    return total


def phase_route_dropout_parity(cfg) -> dict:
    """(c) fp32 card vs CPU with dropout on each route, then the routes'
    card runs against each other."""
    runs = {}
    for opt_in in (False, True):
        with switches(opt_in):
            runs[opt_in] = phase_train_parity(
                cfg, route="opt-in" if opt_in else "default",
                attn_dropout=0.1)
    a, b = runs[False], runs[True]
    rel_loss = max(abs(x - y) / abs(y) for x, y in
                   zip(b["loss_cuda"], a["loss_cuda"]))
    rel_norm = max(abs(x - y) / abs(y) for x, y in
                   zip(b["grad_norm_cuda"], a["grad_norm_cuda"]))
    rec = {"check": "fp32 train steps with dropout, opt-in vs default route "
                    "on the card", "max_rel_err_loss": rel_loss,
           "max_rel_err_grad_norm": rel_norm}
    log(json.dumps(rec))
    check(rel_loss <= TOL_TRAIN_LOSS and rel_norm <= TOL_TRAIN_NORM,
          f"the routes disagree under dropout: {rec}")
    return rec


def phase_detect_trainer(tmp, smi) -> dict:
    """(d) `Trainer` with task="detect" on vit_base_detector, the
    deit_detector_ref recipe with attention dropout 0.1 and batch 32, on
    phase 9's fixed batch: 2 steps and the final checkpoint. Per step 12
    #1 and #2 calls with dropout in the backbone, 6 #3 and #4 calls in the
    decoder's cross-attention (8 heads of 96), one AdamW launch. Returns
    the launches."""
    from arsvt_tpu_torch.train.trainer import Trainer

    det_cfg = DETECTOR_PRESETS["vit_base_detector"]
    tcfg = det_train_cfg(
        preset="vit_base_detector", log_every=1,
        checkpoint_dir=os.path.join(tmp, "detect", "checkpoints"))
    batch = det_bench_batch(tcfg.batch_size)
    trainer = Trainer(tcfg)
    trainer.init_state()
    steps = 2
    torch.cuda.synchronize()
    zero_counts()  # the detector Trainer's path starts here
    t0 = time.perf_counter()
    last = trainer.fit(iter([batch] * steps), steps=steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    depth, head_depth = det_cfg.backbone.depth, det_cfg.head.depth
    bwd = depth * steps * encoder_attention.BWD_LAUNCHES_PER_CALL
    # one microbatch a step; its dropout sites: the decoder's 6 reference
    # self-attentions (no residual dropout in this preset)
    expected = {**dict.fromkeys(counts, 0), "fused_adamw": steps,
                "dropout_apply": site_launches(resolve_detector(tcfg))
                * steps,
                "encoder_attention_fwd": depth * steps,
                "encoder_attention_bwd": bwd,
                "encoder_attention_fwd_dropout": depth * steps,
                "encoder_attention_bwd_dropout": bwd,
                "flash_attention_fwd": head_depth * steps,
                "flash_attention_bwd": head_depth * steps,
                "flash_attention_fwd_dropout": head_depth * steps,
                "flash_attention_bwd_dropout": head_depth * steps,
                # Q = 100 > M = 25: the transposed problems, one launch a
                # microbatch
                "lap": steps,
                **norm_launches(det_cfg, micro=steps * tcfg.grad_accum,
                                aux=tcfg.aux_loss)}
    ckpts = os.listdir(tcfg.checkpoint_dir)
    rec = {"check": "Trainer task=detect vit_base_detector, attention "
                    "dropout 0.1", "batch": tcfg.batch_size, "steps": steps,
           "last_metrics": last, "seconds": seconds, "checkpoints": ckpts,
           "launches": counts, "expected": expected, "card": smi}
    log(json.dumps(rec))
    check(np.isfinite(last["loss"]), f"detector Trainer loss {last}")
    check(counts == expected, f"detector Trainer launches {counts} != "
                              f"{expected}")
    check(ckpts == ["step_000000002.pt"], f"detector checkpoints {ckpts}")
    return counts


def phase_entry_point(cfg, smi) -> dict:
    """Phase 11. Returns the launches of every path, the dropout
    branches' counts included."""
    total = dict.fromkeys((name for name, _, _ in COUNTERS), 0)
    with tempfile.TemporaryDirectory() as tmp:
        for opt_in in (False, True):
            log(f"# phase 11({'b' if opt_in else 'a'}): train.cli, "
                f"{'opt-in' if opt_in else 'default'} route")
            add_counts(total, phase_cli(tmp, smi, opt_in))
        log("# phase 11(c): fp32 steps with dropout, card vs CPU and route "
            "vs route")
        phase_route_dropout_parity(cfg)
        log("# phase 11(d): Trainer, task=detect, vit_base_detector")
        det = phase_detect_trainer(tmp, smi)
    add_counts(total, det)
    return total


# Phase 12: from images on disk to a served checkpoint, through the entry
# points a plant would call. (a) The port's writers put an unsplit TrashNet
# tree (6 class folders of DISK_PER_CLASS JPEGs from synthetic_shape_image
# at DISK_SIZES, so the letterbox resizes and pads) and a synthetic COCO
# root on disk; the decoder route is printed with the host's decode +
# letterbox ms per image on each route available. (b) train.cli.main
# fine-tunes ViT-B/16 on the tree (vit_base_finetune's recipe, batch 32,
# bf16, 3 steps, eval and checkpoint at step 3): #1, #2 and #7 held
# exact. (c) evaluation.cli.main on that checkpoint, split valid: its
# confusion matrix against evaluate_classifier on the CPU in fp32 over the
# same batches, images whose fp32 top-2 margin is within phase 4's bf16
# limit exempt. Three steps inside the recipe's 500-step warm-up leave the
# zero-initialised head near zero, so every answer of that checkpoint is a
# near-tie; (c) therefore also evaluates, and (d) serves, a params-only
# checkpoint of the same trained weights with phase 4's seeded head
# (`seeded_head`), written by the port's CheckpointManager under the same
# config. (d) InferenceServer.from_checkpoint on the card: four of the
# tree's JPEGs through /classify against classify_path on the same files
# (the PIL route, the decoder the server uses for request bodies), #1 at
# depth x forwards and no other kernel (13(d) runs `python -m
# arsvt_tpu_torch.serving.server` as a subprocess). (e) train.cli.main on
# the COCO root with deit_detector_ref's recipe (batch 8, 2 steps,
# checkpoint at 2): #3 and #4 with their dropout branches and #7 once a
# step; the eval CLI's mAP/AP50/AP75 against evaluate_detector in-process
# on the card over the same batches; from_checkpoint's /detect against
# detect_path on the same files, served from a params-only copy with a
# seeded class head (the trained one's scores stay under the 0.5
# threshold).
DISK_SIZES = ((224, 224), (180, 240), (300, 200))  # (height, width)
DISK_PER_CLASS = 16
DISK_CANVAS = 256  # vit_base_finetune's canvas
DISK_CLF_ARGS = ["--train-preset", "vit_base_finetune", "--batch-size", "32",
                 "--grad-accum", "1", "--bf16", "true", "--steps", "3",
                 "--eval-every", "3", "--checkpoint-every", "3"]
DISK_DET_ARGS = ["--train-preset", "deit_detector_ref", "--batch-size", "8",
                 "--steps", "2", "--checkpoint-every", "2"]
EVAL_CLI_BATCH = 8  # evaluation/cli.py's default --batch-size
SERVER_START_S = 300.0
# /classify and classify_path see the same pixels up to one fp32 ulp (x /
# 255 against x * (1 / 255)); the response rounds probs to 4 decimals
TOL_SERVED_PROBS = 2e-4


@contextlib.contextmanager
def pil_route():
    """Decode with PIL for the duration, as the CPU tests pin it."""
    from arsvt_tpu_torch.data import native_loader

    saved = native_loader.available
    native_loader.available = lambda: False
    try:
        yield
    finally:
        native_loader.available = saved


def write_trashnet(root: str, seed: int = 12) -> list[str]:
    """An unsplit TrashNet tree: a folder per class of DISK_PER_CLASS JPEGs
    from `synthetic_shape_image`, at the sizes of DISK_SIZES in turn."""
    from arsvt_tpu_torch.data.synthetic import synthetic_shape_image
    from arsvt_tpu_torch.data.taxonomy import RECYCLING_CLASSES

    rng = np.random.default_rng(seed)
    paths = []
    for label, name in enumerate(RECYCLING_CLASSES):
        os.makedirs(os.path.join(root, name))
        for i in range(DISK_PER_CLASS):
            h, w = DISK_SIZES[i % len(DISK_SIZES)]
            img = synthetic_shape_image(label, max(h, w), rng)
            img = Image.fromarray((img * 255).astype(np.uint8))
            path = os.path.join(root, name, f"{name}_{i:02d}.jpg")
            img.resize((w, h), Image.BILINEAR).save(path, quality=90)
            paths.append(path)
    return paths


def phase_disk_data(tmp, smi) -> tuple[str, str, list[str]]:
    """(a) Returns (the TrashNet tree, the COCO root, the tree's files)."""
    from arsvt_tpu_torch.data import native_loader
    from arsvt_tpu_torch.data.pipeline import load_letterboxed
    from arsvt_tpu_torch.data.synthetic import make_synthetic_coco

    tree = os.path.join(tmp, "trashnet")
    paths = write_trashnet(tree)
    coco = make_synthetic_coco(os.path.join(tmp, "coco"), image_size=256,
                               images_per_split=16, max_boxes=3)
    route = native_loader.route()
    log(f"# phase 12(a): host decoder route: {route}")
    rec = {"check": "host decode + letterbox", "decoder_route": route,
           "build_error": native_loader.build_error(),
           "images": len(paths), "sizes": DISK_SIZES,
           "canvas": DISK_CANVAS, "cpu_cores": os.cpu_count(), "card": smi}
    routes = {"pil": pil_route}
    if route == "native":
        routes["native"] = contextlib.nullcontext
    batches = {}
    for name, ctx in routes.items():
        with ctx():
            load_letterboxed(paths[:4], DISK_CANVAS)  # first-use costs
            t0 = time.perf_counter()
            batches[name], _ = load_letterboxed(paths, DISK_CANVAS)
            rec[f"{name}_ms_per_image"] = (
                (time.perf_counter() - t0) * 1e3 / len(paths))
    if "native" in batches:
        # the two routes resize differently (the C++ core box-reduces and
        # interpolates bilinearly, PIL's bilinear filter widens its support
        # on a downscale): reported, held only in the CPU tests at JAX's
        # own test shapes
        diff = np.abs(batches["native"].astype(np.int16)
                      - batches["pil"].astype(np.int16))
        rec["max_abs_diff_native_vs_pil_u8"] = int(diff.max())
        rec["mean_abs_diff_native_vs_pil_u8"] = float(diff.mean())
    log(json.dumps(rec))
    check(all(b.shape == (len(paths), DISK_CANVAS, DISK_CANVAS, 3)
              for b in batches.values()), "letterboxed batch shape")
    return tree, coco, paths


def cpu_fp32_probs(params, batches, backbone_cfg, num_classes,
                   normalize: bool = True):
    """evaluate_classifier's arithmetic on the CPU in fp32, per image:
    (probs (N, C), labels (N,)); `normalize` as its normalize_inputs."""
    from arsvt_tpu_torch.data.augment import eval_preprocess
    from arsvt_tpu_torch.models.classifier import apply_image_classifier

    probs, labels = [], []
    with torch.inference_mode():
        for b in batches:
            x = to_unit_float(torch.from_numpy(b["image"]), torch.float32)
            if normalize:
                x = eval_preprocess(x, size=backbone_cfg.image_size)
            logits = apply_image_classifier(params, x, backbone_cfg,
                                            num_classes)
            probs.append(torch.softmax(logits, -1).numpy())
            labels.append(b["label"])
    return np.concatenate(probs), np.concatenate(labels)


def confusion(pred, labels, n) -> np.ndarray:
    out = np.zeros((n, n), np.int64)
    np.add.at(out, (labels, pred), 1)
    return out


def eval_cli_vs_cpu(run, ckpt_dir, tree, val, title, smi,
                    step: int = 3) -> dict:
    """(c) on one checkpoint of `step`: the eval CLI on the card (launches
    exact) against evaluate_classifier in fp32 on the CPU. Returns the
    launches."""
    from arsvt_tpu_torch.data.pipeline import classification_batches
    from arsvt_tpu_torch.evaluation import cli as eval_cli
    from arsvt_tpu_torch.serving.loading import load_inference_bundle
    from arsvt_tpu_torch.train.config import input_canvas, resolve_backbone

    params, tcfg = load_inference_bundle(ckpt_dir)
    bb, n = resolve_backbone(tcfg), tcfg.num_classes
    n_batches = math.ceil(len(val) / EVAL_CLI_BATCH)
    zeros = dict.fromkeys((name for name, _, _ in COUNTERS), 0)
    out = os.path.join(run, f"eval_{title}.json")
    res, counts, secs = run_cli(
        run, ["--checkpoint-dir", ckpt_dir, "--data-dir", tree, "--split",
              "valid", "--out", out], base=[], main=eval_cli.main,
        expect={**zeros, "encoder_attention_fwd": bb.depth * n_batches,
                **norm_launches(bb, forwards=n_batches)})
    with open(out) as f:
        saved = json.load(f)
    check(saved["step"] == step and saved["split"] == "valid",
          f"eval CLI --out {saved}")

    def batches():
        return classification_batches(
            val, batch_size=EVAL_CLI_BATCH, canvas=input_canvas(tcfg),
            repeat=False, shuffle=False, drop_remainder=False)

    # the train step's eval contract: an augmented config normalizes
    normalize = tcfg.augment != "none"
    ref = evaluate_classifier(params, batches(), bb, n,
                              compute_dtype=torch.float32,
                              normalize_inputs=normalize, device="cpu")
    probs, labels = cpu_fp32_probs(params, batches(), bb, n, normalize)
    pred = probs.argmax(-1)
    conf_cpu = np.asarray(ref["confusion_matrix"])
    check((confusion(pred, labels, n) == conf_cpu).all(),
          "evaluate_classifier disagrees with its own per-image argmax")
    # a near-tie at bf16 precision may go either way: exempt images whose
    # fp32 top-2 margin is within phase 4's bf16 limit; every other image
    # keeps its cell
    exempt = top2_margin(probs) <= 2 * TOL_PROBS_BF16
    card = np.asarray(res["confusion"])
    rest = card - confusion(pred[~exempt], labels[~exempt], n)
    rec = {"check": f"eval CLI on the card vs evaluate_classifier fp32 on "
                    f"the CPU, {title} checkpoint",
           "images": int(len(labels)), "exempt": int(exempt.sum()),
           "top2_margins_fp32": np.round(top2_margin(probs), 4).tolist(),
           "confusion_card": card.tolist(), "confusion_cpu": conf_cpu.tolist(),
           "accuracy_card": res["accuracy"], "top1_cpu": ref["top1"],
           "seconds_eval_cli": secs, "launches": counts, "card": smi}
    log(json.dumps(rec))
    check(int(card.sum()) == len(labels) == ref["n"],
          f"eval CLI counted {card.sum()} images of {len(labels)}")
    check(bool((rest >= 0).all()) and (rest.sum(1) == np.bincount(
        labels[exempt], minlength=n)).all(),
        f"eval CLI confusion differs beyond the exempt images: {rec}")
    return counts


def params_only_checkpoint(src_dir, dst_dir, head: str, seed: int) -> str:
    """The params of `src_dir`'s checkpoint with a seeded random `head`
    ("classifier/head" or "detr/class_head", filled as `seeded_head`
    fills the classifier's: logits of a few units), saved by the port's
    CheckpointManager under the same config and step, without optimizer
    moments (evaluation and serving never read them)."""
    from arsvt_tpu_torch.serving.loading import load_inference_bundle
    from arsvt_tpu_torch.train.checkpoint import CheckpointManager, latest_step

    params, tcfg = load_inference_bundle(src_dir)
    outer, inner = head.split("/")
    d, n = params[outer][inner]["kernel"].shape
    gen = torch.Generator().manual_seed(seed)
    params[outer][inner] = {
        "kernel": torch.randn(d, n, generator=gen) * 3 * d ** -0.5,
        "bias": torch.randn(n, generator=gen) * 0.1,
    }
    step = latest_step(src_dir)
    CheckpointManager(dst_dir, tcfg).save(
        step, {"params": params, "opt_state": {}, "step": step})
    return dst_dir


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def served_subprocess(source, body, answer, tmp, smi) -> None:
    """`python -m arsvt_tpu_torch.serving.server` on `source`
    (["--artifact", file] in 13(d)): /healthz, then one /classify against
    the in-process `answer`."""
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    env = {k: v for k, v in os.environ.items() if k != "ARSVT_PLATFORM"}
    logpath = os.path.join(tmp, "server.log")
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    with open(logpath, "w") as logfile:
        proc = subprocess.Popen(
            [sys.executable, "-m", "arsvt_tpu_torch.serving.server",
             *source, "--port", str(port)],
            cwd=root, env=env, stdout=logfile, stderr=subprocess.STDOUT)
    try:
        health = None
        while time.perf_counter() - t0 < SERVER_START_S:
            if proc.poll() is not None:
                break
            try:
                health = get(url + "/healthz")
                break
            except OSError:
                time.sleep(0.5)
        ready = time.perf_counter() - t0
        if health is None:
            with open(logpath) as f:
                tail = f.read()[-3000:]
            check(False, f"the server subprocess did not answer /healthz "
                         f"(exit {proc.poll()}):\n{tail}")
        status, data = post(url + "/classify", body)
        diff = float(np.abs(np.asarray(data["probs"])
                            - np.asarray(answer["probs"])).max())
        rec = {"check": "python -m arsvt_tpu_torch.serving.server "
                        + source[0], "healthz": health,
               "seconds_to_healthz": ready, "classify": data,
               "in_process": answer, "max_abs_diff_probs": diff,
               "card": smi}
        log(json.dumps(rec))
        check(health["status"] == "ok" and health["backend"] == "cuda"
              and health["endpoints"] == ["/classify"],
              f"subprocess /healthz {health}")
        check(status == 200 and data["class"] == answer["class"]
              and diff <= TOL_SERVED_PROBS,
              f"subprocess /classify disagrees: {rec}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def serve_classifier(ckpt_dir, picks, smi) -> dict:
    """(d) in process (13(d) runs the server's main() as a subprocess).
    Returns the launches."""
    depth = PRESETS["vit_base_16_224"].depth
    bodies = []
    for path in picks:
        with open(path, "rb") as f:
            bodies.append(f.read())
    torch.cuda.synchronize()
    zero_counts()  # the served checkpoint's path starts here
    srv = InferenceServer.from_checkpoint(ckpt_dir)
    forwards = 1  # the engine's warm-up
    host, port = srv.start_background(port=0)
    url = f"http://{host}:{port}"
    try:
        answers, client_ms = [], []
        for body in bodies:
            t0 = time.perf_counter()
            status, data = post(url + "/classify", body)
            client_ms.append((time.perf_counter() - t0) * 1e3)
            check(status == 200, f"/classify status {status}")
            answers.append(data)
        for i in range(16):  # more samples for the latency percentiles
            t0 = time.perf_counter()
            post(url + "/classify", bodies[i % len(bodies)])
            client_ms.append((time.perf_counter() - t0) * 1e3)
        forwards += len(bodies) + 16
        with pil_route():
            direct = [srv._clf.classify_path(p) for p in picks]
        forwards += len(picks)
        health = get(url + "/healthz")
        stats = get(url + "/stats")
    finally:
        srv.shutdown()
    torch.cuda.synchronize()
    counts = read_counts()
    expected = {**dict.fromkeys(counts, 0),
                "encoder_attention_fwd": depth * forwards,
                **norm_launches(PRESETS["vit_base_16_224"],
                                forwards=forwards)}
    diffs = [float(np.abs(np.asarray(a["probs"]) - d[2]).max())
             for a, d in zip(answers, direct)]
    rec = {"check": "InferenceServer.from_checkpoint /classify vs "
                    "classify_path", "files": [os.path.basename(p)
                                               for p in picks],
           "classes": [a["class"] for a in answers],
           "classes_classify_path": [d[0] for d in direct],
           "top2_margins": [float(top2_margin(d[2])) for d in direct],
           "max_abs_diff_probs": diffs, "healthz": health, "stats": stats,
           "client_p50_ms": float(np.median(client_ms)),
           "client_p99_ms": float(np.percentile(client_ms, 99)),
           "launches": counts, "expected": expected, "card": smi}
    log(json.dumps(rec))
    check(health["backend"] == "cuda", f"/healthz {health}")
    check([a["class"] for a in answers] == [d[0] for d in direct]
          and max(diffs) <= TOL_SERVED_PROBS,
          f"/classify from the checkpoint disagrees with classify_path: "
          f"{rec}")
    check(counts == expected, f"served checkpoint launches {counts} != "
                              f"{expected}")
    return counts


def phase_disk_detector(tmp, coco, smi) -> dict:
    """(e) Returns the launches of the training, eval CLI and serving
    runs."""
    from arsvt_tpu_torch.data.coco import CocoDataset
    from arsvt_tpu_torch.data.pipeline import detection_batches
    from arsvt_tpu_torch.evaluation import cli as eval_cli
    from arsvt_tpu_torch.serving.loading import load_inference_bundle
    from arsvt_tpu_torch.train.config import input_canvas

    det_cfg = DETECTOR_PRESETS[DET_TRAIN_PRESET]
    per_step = det_cfg.backbone.depth + det_cfg.head.depth
    zeros = dict.fromkeys((name for name, _, _ in COUNTERS), 0)
    total = dict(zeros)
    run = os.path.join(tmp, "detect")
    steps = 2
    last, counts, secs = run_cli(
        run, ["--data-dir", coco], base=DISK_DET_ARGS,
        expect={**zeros, "fused_adamw": steps,
                "flash_attention_fwd": per_step * steps,
                "flash_attention_bwd": per_step * steps,
                "flash_attention_fwd_dropout": per_step * steps,
                "flash_attention_bwd_dropout": per_step * steps,
                "dropout_apply": site_launches(resolve_detector(
                    TRAIN_PRESETS[DET_TRAIN_PRESET])) * steps,
                "lap": steps,
                **norm_launches(det_cfg, micro=steps, aux=TRAIN_PRESETS[
                    DET_TRAIN_PRESET].aux_loss)})
    add_counts(total, counts)
    ckpt_dir = os.path.join(run, "checkpoints")
    ckpts = sorted(os.listdir(ckpt_dir))
    log(json.dumps({"check": "train.cli deit_detector_ref from a COCO root",
                    "last_metrics": last, "seconds": secs,
                    "steps_per_s": steps / secs, "checkpoints": ckpts,
                    "card": smi}))
    check(np.isfinite(last["loss"]), f"detector CLI loss {last}")
    check(ckpts == ["step_000000002.pt"], f"detector checkpoints {ckpts}")

    val = CocoDataset(os.path.join(coco, "valid"))
    n_batches = math.ceil(len(val) / EVAL_CLI_BATCH)
    out = os.path.join(run, "eval_valid.json")
    res, counts, secs_eval = run_cli(
        run, ["--checkpoint-dir", ckpt_dir, "--data-dir", coco, "--split",
              "valid", "--out", out], base=[], main=eval_cli.main,
        expect={**zeros, "flash_attention_fwd": per_step * n_batches,
                "lap": n_batches, **norm_launches(det_cfg,
                                                  forwards=n_batches)})
    add_counts(total, counts)
    params, tcfg = load_inference_bundle(ckpt_dir)
    _, _, eval_step = make_detector_step_fns(tcfg)
    params = tree_map(lambda t: t.to("cuda"), params)
    ref = evaluate_detector(
        eval_step, params, detection_batches(
            val, batch_size=EVAL_CLI_BATCH, canvas=input_canvas(tcfg),
            max_objects=tcfg.max_objects, repeat=False, shuffle=False,
            drop_remainder=False),
        num_classes=tcfg.num_classes)
    keys = ("mAP", "AP50", "AP75", "loss", "total_predictions")
    rec = {"check": "eval CLI deit_detector_ref vs evaluate_detector "
                    "in-process on the card",
           "cli": {k: res[k] for k in keys}, "in_process":
           {k: ref[k] for k in keys}, "seconds_eval_cli": secs_eval,
           "card": smi}
    log(json.dumps(rec))
    check(all(res[k] == ref[k] for k in keys),
          f"the eval CLI's detection metrics differ: {rec}")

    # a near-init class head scores every query under the 0.5 threshold,
    # which would leave /detect and detect_path two empty lists
    seeded = params_only_checkpoint(
        ckpt_dir, os.path.join(tmp, "detect_seeded", "checkpoints"),
        "detr/class_head", seed=2)
    picks = [r.path for r in val.records[:2]]
    torch.cuda.synchronize()
    zero_counts()  # the served detector checkpoint's path starts here
    srv = InferenceServer.from_checkpoint(seeded)
    forwards = 1  # the engine's warm-up
    host, port = srv.start_background(port=0)
    url = f"http://{host}:{port}"
    try:
        served = []
        for path in picks:
            with open(path, "rb") as f:
                status, data = post(url + "/detect", f.read())
            check(status == 200, f"/detect status {status}")
            served.append(data)
        direct = [srv._det.detect_path(p) for p in picks]
        forwards += 2 * len(picks)
        health = get(url + "/healthz")
    finally:
        srv.shutdown()
    torch.cuda.synchronize()
    counts = read_counts()
    add_counts(total, counts)
    rec = {"check": "InferenceServer.from_checkpoint /detect vs "
                    "detect_path", "detections": [len(d["labels"])
                                                  for d in served],
           "served": served,
           "healthz": health, "launches": counts, "card": smi}
    log(json.dumps(rec))
    check(health["backend"] == "cuda" and health["endpoints"] == ["/detect"],
          f"/healthz {health}")
    for data, ref_det in zip(served, direct):
        check(data["labels"] == ref_det["labels"].tolist() and np.allclose(
            np.asarray(data["boxes"], np.float32).reshape(-1, 4),
            ref_det["boxes"], atol=1e-4, rtol=0),
            f"/detect differs from detect_path: {data} vs {ref_det}")
    check(counts == {**zeros, "flash_attention_fwd": per_step * forwards,
                     **norm_launches(det_cfg, forwards=forwards)},
          f"served detector launches {counts}")
    return total


def phase_disk(smi, tmp) -> tuple[dict, str]:
    """Phase 12, in the directory `tmp`. Returns the launches of every path
    and the params-only checkpoint whose head is seeded as phase 4's,
    which phase 13 serves and exports."""
    from arsvt_tpu_torch.data.folder import open_classification_split

    t_phase = time.perf_counter()
    depth = PRESETS["vit_base_16_224"].depth
    total = dict.fromkeys((name for name, _, _ in COUNTERS), 0)
    tree, coco, paths = phase_disk_data(tmp, smi)
    log("# phase 12(b): train.cli, vit_base_finetune from the tree")
    val = open_classification_split(tree, "valid")
    run = os.path.join(tmp, "classify")
    steps = 3
    last, counts, secs = run_cli(
        run, ["--data-dir", tree], base=DISK_CLF_ARGS,
        expect=classifier_launches(depth, 1, steps,
                                   math.ceil(len(val) / 32), False))
    add_counts(total, counts)
    ckpt_dir = os.path.join(run, "checkpoints")
    ckpts = sorted(os.listdir(ckpt_dir))
    with open(os.path.join(run, "metrics.jsonl")) as f:
        val_rows = [json.loads(line) for line in f if '"val/' in line]
    log(json.dumps({"check": "train.cli vit_base_finetune from a "
                             "TrashNet tree", "train_images":
                    len(open_classification_split(tree, "train")),
                    "valid_images": len(val), "last_metrics": last,
                    "val": val_rows, "seconds": secs,
                    "steps_per_s": steps / secs, "checkpoints": ckpts,
                    "card": smi}))
    check(np.isfinite(last["loss"]), f"classifier CLI loss {last}")
    check(ckpts == ["step_000000003.pt"], f"checkpoints {ckpts}")
    check(len(val_rows) == 1 and "val/confusion" in val_rows[0],
          f"the CLI's eval at step 3: {val_rows}")

    log("# phase 12(c): evaluation.cli on the checkpoint, split valid")
    add_counts(total, eval_cli_vs_cpu(run, ckpt_dir, tree, val,
                                      "trained", smi))
    seeded = params_only_checkpoint(
        ckpt_dir, os.path.join(tmp, "seeded", "checkpoints"),
        "classifier/head", seed=1)
    add_counts(total, eval_cli_vs_cpu(run, seeded, tree, val,
                                      "seeded_head", smi))

    log("# phase 12(d): InferenceServer.from_checkpoint, /classify")
    # one file of each of four classes, at the three sizes
    picks = [paths[c * DISK_PER_CLASS + c] for c in range(4)]
    add_counts(total, serve_classifier(seeded, picks, smi))

    log("# phase 12(e): deit_detector_ref from the COCO root")
    add_counts(total, phase_disk_detector(tmp, coco, smi))
    seconds = time.perf_counter() - t_phase
    log(json.dumps({"phase": 12, "seconds": seconds, "launches": total,
                    "card": smi}))
    return total, seeded


# Phase 13: int8 W8A8 serving and export artifacts, at full width. (a)
# vit_base_16_224 with phase 4's params (seeded head) on a batch of 32
# seeded images: the int8 logits against the bf16 forward on the card
# within JAX's own limits (tests/test_quant.py: relative L2 < 0.08, argmax
# agreement >= 0.9); quant_dense's int32 products through torch._int_mm at
# the backbone's five shapes (B = 32) equal to the exact integer products
# on the CPU (float64 sums of int8 products: exact below 2^53); #1 once
# per layer and forward; the weight bytes each tree holds on the card;
# /classify p50/p99 over 20 requests from phase 12's seeded checkpoint,
# served with quantize="int8" (--int8) and without. (b)
# deit_detector_ref with a seeded class head (the init's logits near 0
# would make the class argmax a coin toss): int8 against bf16 on 8 images,
# relative L2 < 0.1 on logits and boxes, class agreement >= 0.9 (JAX's
# limits, tests/test_quant.py); #3 18 times a forward. (c) both models
# exported on the card in bf16 and int8 (the bf16 classify artifact is the
# export CLI's of (d), of phase 12's seeded checkpoint; the others phase
# 4's and (b)'s params, through export_classifier / export_detector),
# saved, loaded by load_artifact_engine: against the in-process engines of
# the same params at B = 1 and 8 (the same ops on the same device and
# shapes: probs within TOL_ARTIFACT_PROBS and classes equal; boxes within
# TOL_ARTIFACT_BOXES, labels and valid equal); the loaded artifacts'
# launches of #1 and #3; the bf16 classify artifact moved to the CPU
# against the CPU engine. (d) the export CLI (serving/export.py's main(),
# in this process) on phase 12's seeded checkpoint, then the artifact
# through from_artifact in process and, as a subprocess, python -m
# arsvt_tpu_torch.serving.server --artifact:
# /healthz and one /classify against the in-process answer.
TOL_INT8_REL_CLF = 0.08
TOL_INT8_REL_DET = 0.1
TOL_INT8_AGREE = 0.9
TOL_ARTIFACT_PROBS = 1e-5
TOL_ARTIFACT_BOXES = 1e-6
INT8_BATCH = 32
INT8_REQUESTS = 20
# (M, K, N) of quant_dense's products in one ViT-B/16@224 forward at B = 32
INT8_SHAPES = {"patch_embed": (32 * 196, 768, 768),
               "qkv": (32 * 197, 768, 2304), "proj": (32 * 197, 768, 768),
               "fc1": (32 * 197, 768, 3072), "fc2": (32 * 197, 3072, 768)}


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def normalized_bf16(images: np.ndarray) -> torch.Tensor:
    """uint8 images -> the engines' forward input on the card."""
    x = to_unit_float(torch.from_numpy(images).cuda(), torch.float32)
    return normalize(x).to(torch.bfloat16)


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-9))


def phase_int8_products(smi) -> None:
    """(a) quant_dense's int8 products on the card against exact integer
    sums on the CPU, each timed beside the bf16 product of its shape."""
    gen = torch.Generator().manual_seed(14)
    for name, (m, k, n) in INT8_SHAPES.items():
        a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
        ac, bc = a.cuda(), b.cuda()
        got = int8_matmul(ac, bc).cpu()
        exact = (a.double() @ b.double()).long()
        af, bf = ac.to(torch.bfloat16), bc.to(torch.bfloat16)
        rec = {"check": "quant_dense int8 product on the card vs exact CPU",
               "product": name, "mkn": [m, k, n],
               "equal": bool(torch.equal(got.long(), exact)),
               "int8_ms": cuda_ms(lambda: int8_matmul(ac, bc), 20),
               "bf16_matmul_ms": cuda_ms(lambda: af @ bf, 20), "card": smi}
        log(json.dumps(rec))
        check(got.dtype == torch.int32 and rec["equal"],
              f"int8 product {name} differs from the exact sums")


def serve_latency(server, body, n) -> dict:
    """n /classify requests one at a time: the server's /stats and the
    client's p50/p99."""
    host, port = server.start_background(port=0)
    url = f"http://{host}:{port}"
    try:
        client_ms, classes = [], []
        for _ in range(n):
            t0 = time.perf_counter()
            status, data = post(url + "/classify", body)
            client_ms.append((time.perf_counter() - t0) * 1e3)
            check(status == 200, f"/classify status {status}")
            classes.append(data["class"])
        stats = get(url + "/stats")["classify"]
    finally:
        server.shutdown()
    return {"server_p50_ms": stats["p50_ms"], "server_p99_ms":
            stats["p99_ms"], "client_p50_ms": float(np.median(client_ms)),
            "client_p99_ms": float(np.percentile(client_ms, 99)),
            "class": classes[0]}


def phase_int8_classify(cfg, params, seeded_ckpt, smi) -> dict:
    """(a) Returns the launches."""
    total = dict.fromkeys((name for name, _, _ in COUNTERS), 0)
    zeros = dict(total)
    rng = np.random.default_rng(13)
    x = normalized_bf16(rng.integers(0, 256, (INT8_BATCH, 224, 224, 3),
                                     dtype=np.uint8))
    trees = {q: classifier_params(params, cfg, q, torch.device("cuda"))
             for q in (None, "int8")}
    torch.cuda.synchronize()
    zero_counts()  # the bf16 and the int8 forwards, then their timing
    with torch.inference_mode():
        logits = {q: classifier_logits(trees[q], x, cfg, 6, q).cpu().numpy()
                  for q in trees}
        ms = {q or "bf16": cuda_ms(lambda q=q: classifier_logits(
            trees[q], x, cfg, 6, q), 10, warmup=2) for q in trees}
    counts = read_counts()
    add_counts(total, counts)
    ref, got = logits[None], logits["int8"]
    rec = {"check": "vit_base_16_224 int8 vs bf16 on the card",
           "batch": INT8_BATCH, "rel_l2_logits": rel_l2(got, ref),
           "max_abs_logits": float(np.abs(got - ref).max()),
           "argmax_agreement": float((got.argmax(-1) == ref.argmax(-1)).mean()),
           "forward_ms": ms, "weight_bytes": {
               "bf16_engine_fp32_tree": tree_bytes(trees[None]),
               "int8_tree": tree_bytes(trees["int8"])},
           "launches": counts, "card": smi}
    log(json.dumps(rec))
    check(np.isfinite(got).all() and got.shape == (INT8_BATCH, 6),
          "int8 logits")
    check(rec["rel_l2_logits"] < TOL_INT8_REL_CLF
          and rec["argmax_agreement"] >= TOL_INT8_AGREE,
          f"int8 classify outside JAX's limits: {rec}")
    check(counts == {**zeros, "encoder_attention_fwd": 2 * 13 * cfg.depth,
                     **norm_launches(cfg, forwards=2 * 13)},
          f"int8 classify launches {counts}")
    del trees
    phase_int8_products(smi)

    log("# phase 13(a): /classify from the checkpoint, --int8 and not")
    body = png_bytes(rng.integers(0, 256, (224, 224, 3), dtype=np.uint8))
    served = {}
    for quantize in (None, "int8"):
        torch.cuda.synchronize()
        zero_counts()
        srv = InferenceServer.from_checkpoint(seeded_ckpt, quantize=quantize)
        served[quantize or "bf16"] = serve_latency(srv, body, INT8_REQUESTS)
        torch.cuda.synchronize()
        counts = read_counts()
        add_counts(total, counts)
        check(counts == {**zeros, "encoder_attention_fwd":
                         cfg.depth * (1 + INT8_REQUESTS),
                         **norm_launches(cfg, forwards=1 + INT8_REQUESTS)},
              f"served {quantize} launches {counts}")
    log(json.dumps({"check": "/classify latency from the checkpoint",
                    "requests": INT8_REQUESTS, "served": served,
                    "card": smi}))
    return total


def seeded_class_head(params, seed):
    d, n = params["detr"]["class_head"]["kernel"].shape
    gen = torch.Generator().manual_seed(seed)
    params["detr"]["class_head"] = {
        "kernel": torch.randn(d, n, generator=gen) * 3 * d ** -0.5,
        "bias": torch.randn(n, generator=gen) * 0.1}
    return params


def phase_int8_detect(smi) -> tuple[dict, dict]:
    """(b) Returns (the launches, the detector's params)."""
    cfg = DETECTOR_PRESETS["deit_detector_ref"]
    params = seeded_class_head(init_detector(cfg, seed=0), seed=2)
    rng = np.random.default_rng(16)
    x = normalized_bf16(rng.integers(0, 256, (8, 224, 224, 3),
                                     dtype=np.uint8))
    trees = {q: detector_params(params, cfg, q, torch.device("cuda"))
             for q in (None, "int8")}
    torch.cuda.synchronize()
    zero_counts()
    with torch.inference_mode():
        outs = {q: {k: v.cpu().numpy() for k, v in detector_outputs(
            trees[q], x, cfg, q).items()} for q in trees}
    counts = read_counts()
    ref, got = outs[None], outs["int8"]
    rec = {"check": "deit_detector_ref int8 vs bf16 on the card",
           "images": 8, "rel_l2": {k: rel_l2(got[k], ref[k]) for k in ref},
           "class_agreement": float((got["class_logits"].argmax(-1)
                                     == ref["class_logits"].argmax(-1))
                                    .mean()),
           "weight_bytes": {"bf16_engine_fp32_tree": tree_bytes(trees[None]),
                            "int8_tree": tree_bytes(trees["int8"])},
           "launches": counts, "card": smi}
    log(json.dumps(rec))
    check(all(np.isfinite(v).all() for v in got.values()), "int8 detect")
    check(max(rec["rel_l2"].values()) < TOL_INT8_REL_DET
          and rec["class_agreement"] >= TOL_INT8_AGREE,
          f"int8 detect outside JAX's limits: {rec}")
    per_forward = cfg.backbone.depth + cfg.head.depth
    check(counts == {**dict.fromkeys(counts, 0),
                     "flash_attention_fwd": 2 * per_forward,
                     **norm_launches(cfg, forwards=2)},
          f"int8 detect launches {counts}")
    return counts, params


def engine_detections(engine, images) -> dict:
    """What StreamingDetector.forward and detect_path compute, for a batch:
    the forward on the card, one copy, post_process on the host."""
    with torch.inference_mode():
        x = to_unit_float(torch.from_numpy(images).cuda(), torch.float32)
        out = detector_outputs(engine._params, normalize(x).to(
            engine._compute_dtype), engine._cfg, engine._quantize)
        raw = {k: v.cpu() for k, v in out.items()}
    return post_process(raw["class_logits"], raw["boxes_cxcywh"],
                        conf_threshold=engine._conf,
                        nms_threshold=engine._nms)


def export_timed(fn, path) -> dict:
    t0 = time.perf_counter()
    exported = fn()
    t1 = time.perf_counter()
    save_exported(exported, path)
    return {"export_s": t1 - t0, "save_s": time.perf_counter() - t1,
            "bytes": os.path.getsize(path)}


def load_counted(path, forwards_per_call, launch_name, depth, model):
    """load_artifact_engine on the card, with the launches of its warm-up
    and of `forwards_per_call` calls checked: `depth` of `launch_name` a
    forward, the LayerNorm and GELU kernels of `model`'s forward, and no
    other kernel."""
    torch.cuda.synchronize()
    zero_counts()  # the loaded artifact's path starts here
    t0 = time.perf_counter()
    engine = load_artifact_engine(path)
    load_s = time.perf_counter() - t0
    results = forwards_per_call(engine)
    torch.cuda.synchronize()
    counts = read_counts()
    forwards = 1 + len(results)  # the warm-up
    check(counts == {**dict.fromkeys(counts, 0),
                     launch_name: depth * forwards,
                     **norm_launches(model, forwards=forwards)},
          f"artifact {path} launches {counts}")
    return engine, results, counts, load_s


def export_cli(seeded_ckpt, smi, tmp) -> str:
    """(d) the export CLI, `arsvt_tpu_torch.serving.export.main`, in this
    process on phase 12's seeded checkpoint (bf16; 13(c) exports in
    process too, and the served artifact below starts a process of its
    own). Returns the artifact's path."""
    from arsvt_tpu_torch.serving import export

    out = os.path.join(tmp, "cli.pt2")
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        export.main(["--checkpoint-dir", seeded_ckpt, "--out", out])
    seconds = time.perf_counter() - t0
    manifest = json.loads(printed.getvalue().strip().splitlines()[-1])
    log(json.dumps({"check": "the export CLI (serving/export.py main)",
                    "manifest": manifest, "seconds": seconds,
                    "bytes": os.path.getsize(out), "card": smi}))
    check(manifest["task"] == "classify" and manifest["normalize_inputs"]
          and manifest["quantize"] is None and manifest["image_size"] == 224,
          f"manifest {manifest}")
    return out


def phase_export(cfg, params, det_params, seeded_ckpt, cli_path, smi,
                 tmp) -> dict:
    """(c) The bf16 classify artifact is the export CLI's, of phase 12's
    seeded checkpoint; the other three are exported here. Returns the
    launches of the loaded artifacts."""
    from arsvt_tpu_torch.serving.loading import load_inference_bundle
    from arsvt_tpu_torch.train.config import resolve_backbone

    total = dict.fromkeys((name for name, _, _ in COUNTERS), 0)
    det_cfg = DETECTOR_PRESETS["deit_detector_ref"]
    rng = np.random.default_rng(15)
    batch = rng.integers(0, 256, (8, 224, 224, 3), dtype=np.uint8)
    sizes = (1, 8)
    ckpt_params, tcfg = load_inference_bundle(seeded_ckpt)
    ckpt_cfg = resolve_backbone(tcfg)
    for quantize in (None, "int8"):
        name = quantize or "bf16"
        if quantize is None:  # the CLI's artifact, of the checkpoint
            path, clf_params, clf_cfg = cli_path, ckpt_params, ckpt_cfg
            rec = {"export": "the export CLI (serving/export.py main)"}
        else:
            path, clf_params, clf_cfg = (
                os.path.join(tmp, f"classify_{name}.pt2"), params, cfg)
            rec = export_timed(lambda: export_classifier(
                params, cfg, 6, quantize=quantize), path)
        art, outs, counts, rec["load_s"] = load_counted(
            path, lambda e: [e.infer_batch(batch[:b]) for b in sizes],
            "encoder_attention_fwd", cfg.depth, clf_cfg)
        add_counts(total, counts)
        del art
        engine = StreamingClassifier(clf_params, clf_cfg, 6,
                                     quantize=quantize, device="cuda")
        diffs = []
        for b, (idx, probs) in zip(sizes, outs):
            e_idx, e_probs = engine.infer_batch(batch[:b])
            diffs.append(float(np.abs(probs - e_probs).max()))
            check(idx.tolist() == e_idx.tolist(),
                  f"classify artifact {name} B={b}: classes {idx} vs "
                  f"{e_idx}")
        rec.update(check=f"classify artifact {name} vs StreamingClassifier",
                   max_abs_diff_probs=diffs, launches=counts, card=smi)
        log(json.dumps(rec))
        check(max(diffs) <= TOL_ARTIFACT_PROBS,
              f"classify artifact {name} probs differ: {rec}")
        del engine
        if quantize is None:
            moved = load_artifact_engine(path, device="cpu")
            cpu = StreamingClassifier(clf_params, clf_cfg, 6, device="cpu")
            (idx, probs), (c_idx, c_probs) = (
                e.infer_batch(batch[:1]) for e in (moved, cpu))
            rec = {"check": "classify artifact bf16 moved to the CPU vs "
                            "the CPU engine",
                   "max_abs_diff_probs": float(np.abs(probs - c_probs).max()),
                   "class": int(idx[0]), "card": smi}
            log(json.dumps(rec))
            check(idx.tolist() == c_idx.tolist()
                  and rec["max_abs_diff_probs"] <= TOL_ARTIFACT_PROBS,
                  f"the artifact on the CPU differs: {rec}")
            del moved, cpu

        path = os.path.join(tmp, f"detect_{name}.pt2")
        rec = export_timed(lambda: export_detector(
            det_params, det_cfg, quantize=quantize), path)
        art, outs, counts, rec["load_s"] = load_counted(
            path, lambda e: [e._run(batch[:b]) for b in sizes],
            "flash_attention_fwd", det_cfg.backbone.depth + det_cfg.head.depth,
            det_cfg)
        add_counts(total, counts)
        del art
        engine = StreamingDetector(det_params, det_cfg, quantize=quantize,
                                   device="cuda")
        kept, diffs = [], []
        for b, out in zip(sizes, outs):
            ref = engine_detections(engine, batch[:b])
            out = {k: v.cpu() for k, v in out.items()}
            for key in ("labels", "valid"):
                check(torch.equal(out[key], ref[key]),
                      f"detect artifact {name} B={b}: {key} differ")
            diffs.append(float((out["boxes"] - ref["boxes"]).abs().max()))
            kept.append(int(out["valid"].sum()))
        rec.update(check=f"detect artifact {name} vs StreamingDetector",
                   max_abs_diff_boxes=diffs, detections=kept,
                   launches=counts, card=smi)
        log(json.dumps(rec))
        check(max(diffs) <= TOL_ARTIFACT_BOXES,
              f"detect artifact {name} boxes differ: {rec}")
        del engine
    return total


def serve_artifact(cli_path, smi, tmp) -> dict:
    """(d) the CLI's artifact through from_artifact in process, then
    `python -m arsvt_tpu_torch.serving.server --artifact`. Returns the
    in-process launches."""
    depth = PRESETS["vit_base_16_224"].depth
    body = png_bytes(np.random.default_rng(17).integers(
        0, 256, (200, 260, 3), dtype=np.uint8))
    torch.cuda.synchronize()
    zero_counts()
    srv = InferenceServer.from_artifact(cli_path)
    host, port = srv.start_background(port=0)
    try:
        status, answer = post(f"http://{host}:{port}/classify", body)
        health = get(f"http://{host}:{port}/healthz")
    finally:
        srv.shutdown()
    torch.cuda.synchronize()
    counts = read_counts()
    check(status == 200 and health["backend"] == "cuda", f"{health}")
    check(counts == {**dict.fromkeys(counts, 0),
                     "encoder_attention_fwd": 2 * depth,
                     **norm_launches(PRESETS["vit_base_16_224"],
                                     forwards=2)},
          f"from_artifact launches {counts}")
    log("# phase 13(d): the server's main() --artifact as a subprocess")
    served_subprocess(["--artifact", cli_path], body, answer, tmp, smi)
    return counts


def phase_int8_export(cfg, params, seeded_ckpt, smi, tmp) -> dict:
    """Phase 13. Returns the launches of every path."""
    t_phase = time.perf_counter()
    total = dict.fromkeys((name for name, _, _ in COUNTERS), 0)
    log("# phase 13(a): vit_base_16_224 int8 against bf16")
    add_counts(total, phase_int8_classify(cfg, params, seeded_ckpt, smi))
    log("# phase 13(b): deit_detector_ref int8 against bf16")
    counts, det_params = phase_int8_detect(smi)
    add_counts(total, counts)
    log("# phase 13(d): the export CLI, in process")
    cli_path = export_cli(seeded_ckpt, smi, tmp)
    log("# phase 13(c): artifacts exported and loaded on the card")
    add_counts(total, phase_export(cfg, params, det_params, seeded_ckpt,
                                   cli_path, smi, tmp))
    log("# phase 13(d): from_artifact and server --artifact")
    add_counts(total, serve_artifact(cli_path, smi, tmp))
    log(json.dumps({"phase": 13, "seconds": time.perf_counter() - t_phase,
                    "launches": total, "card": smi}))
    return total


# The libraries whose bf16 kernels must run on the tensor cores, with no
# spill or stack frame: the attention kernels on warp_tile.cuh (mma.sync,
# HMMA in the SASS) and the fused MLP's on mlp_gemm.cuh (wgmma, HGMMA).
ATTENTION_TILE_LIBRARIES = ("encoder_attention_fwd", "flash_attention_fwd",
                            "encoder_attention_bwd", "flash_attention_bwd",
                            "encoder_attention_savep_fwd",
                            "encoder_attention_savep_bwd")
MLP_LIBRARIES = ("fused_mlp_fwd", "fused_mlp_bwd")
TENSOR_CORE_LIBRARIES = ATTENTION_TILE_LIBRARIES + MLP_LIBRARIES


# Phase 14: the ViT-L/16@384 recipe, TRAIN_PRESETS["vit_large_384"]
# (RandAugment, mixup 0.2, label smoothing 0.1, full remat, a 416 canvas,
# bf16). (a) the augmentation on the card against the CPU with the same
# draws on 8 images at 384 px (RandAugment with the first image's two
# rounds forced to rotate, the classify pipeline with jitter, each warp,
# Lanczos-4, the bilinear warps in bf16 under ARSVT_AUGMENT_BF16), then
# each timed at B = 256 from the preset's canvas; (b) ViT-L at full width
# cut to 2 layers, B = 4, residual and attention dropout 0.1, fp32: each
# remat policy against no remat on the card (loss and gradients), on both
# routes, and one remat step on the card against the CPU; (c) the launches
# of (b), held to the table `REMAT_TABLE`; (d) ViT-L's width at 12 of its
# 24 layers, bf16, one microbatch of 16: peak memory and ms/step for no
# remat and each policy; (e) the preset as it stands (batch 256 as one
# microbatch), one warm and 3 timed steps, profiled once, and bench.py's
# ViT-L configuration (batch 32 as 2 x 16, no remat) at 12 layers; (f)
# train.cli.main with the preset, batch 32 as 2 x 16, 2 steps, a
# checkpoint and an eval at 384; (g) one deit_detector_ref step with remat
# and the taps warp.
VITL = "vit_large_16_384"
VITL_D2 = "vit_large_16_384_depth2"  # registered in PRESETS by phase 14
# ViT-L's width at half its depth: 14(d)'s policies and 14(e)'s bench.py
# configuration (registered in PRESETS by phase 14)
VITL_D12 = "vit_large_16_384_depth12"
# augmentation card against CPU in fp32: the same formulas, the band
# products and reductions summed in other orders: 1e-4 on [0, 1] pixels
TOL_AUG = 1e-4
# the bilinear warps in bf16: each side rounds its products to bf16 (2^-8
# near 1) in its own order: four steps
TOL_AUG_BF16 = 2.0 ** -6
# RandAugment's posterize and solarize are steps: a pixel within an ulp of
# a level or of the threshold lands on either side on the two devices.
# Held: at most this share of the pixels beyond TOL_AUG
TOL_AUG_FLIP_SHARE = 1e-4
# (b) remat against no remat: the same kernels on the same inputs, the
# masks redrawn from the same seeds: expected equal to the bit; held to
# this share of each leaf's largest gradient should a library product
# take another algorithm in the replay
TOL_REMAT = 1e-6
# forward launches per layer and microbatch under each policy: #1 (default
# route), #5, #8 calls and #9 calls (opt-in route); #2 and #6 run one call
# a layer on every policy
REMAT_TABLE = {
    "none": (1, 1, 1, 1),
    "full": (2, 2, 2, 1),
    "dots": (2, 2, 2, 1),
    "names": (1, 2, 2, 1),
    "all_but_mlp": (1, 1, 2, 1),
    "mlp_tail": (1, 1, 0, 0),
}
# the residual dropout sites a layer replays: one (the attention's) under
# the policies that recompute the whole block, whose non-reentrant
# checkpoint stops its replay at the last tensor the backward saved, so
# the MLP's site, which ends the block and saves nothing, is not drawn
# again; all_but_mlp and mlp_tail replay only MLP pieces inside the block,
# and the residual dropout lies outside them
REMAT_MASK_REPLAYS = {"none": 0, "full": 1, "dots": 1, "names": 1,
                      "all_but_mlp": 0, "mlp_tail": 0}
RECIPE_CLI_ARGS = ["--train-preset", "vit_large_384", "--batch-size", "32",
                   "--grad-accum", "2", "--steps", "2", "--eval-every", "2",
                   "--checkpoint-every", "2", "--log-every", "1"]


def augment_compare(name, fn, tol, flips: bool = False) -> dict:
    """fn(device) on the card against the CPU: the largest difference and
    the share of pixels beyond `tol` (which `flips` allows up to
    TOL_AUG_FLIP_SHARE; otherwise none)."""
    cpu = fn("cpu")
    gpu = fn("cuda")
    torch.cuda.synchronize()
    check(gpu.dtype == cpu.dtype and gpu.shape == cpu.shape,
          f"augment {name}: {gpu.dtype} {tuple(gpu.shape)} vs {cpu.dtype} "
          f"{tuple(cpu.shape)}")
    err = (gpu.cpu().float() - cpu.float()).abs()
    share = float((err > tol).float().mean())
    rec = {"check": f"augment {name} cuda vs cpu", "shape": list(gpu.shape),
           "dtype": str(gpu.dtype), "max_abs_err": float(err.max()),
           "share_beyond_tol": share, "tol": tol}
    log(json.dumps(rec))
    check(bool(torch.isfinite(gpu).all()), f"augment {name}: non-finite")
    check(share <= (TOL_AUG_FLIP_SHARE if flips else 0.0),
          f"augment {name} cuda vs cpu: {rec}")
    return rec


@contextlib.contextmanager
def augment_bf16():
    """ARSVT_AUGMENT_BF16 set for the block, unset after."""
    os.environ["ARSVT_AUGMENT_BF16"] = "1"
    try:
        yield
    finally:
        os.environ.pop("ARSVT_AUGMENT_BF16", None)


def phase_recipe_augment(smi) -> None:
    """14(a)."""
    gen = torch.Generator().manual_seed(14)
    images = torch.rand((8, 384, 384, 3), generator=gen)
    canvas = torch.rand((8, 416, 416, 3), generator=gen)
    ccfg = augment.ClassifyAugmentConfig(image_size=384, jitter_p=0.6,
                                         rand_augment=True)
    draws = augment.draw_classification_augment(gen, 8, ccfg)
    draws.rand_augment.op[0] = augment.RA_ROTATE  # both rounds rotate
    ra = draws.rand_augment
    check(bool((ra.op[0] == augment.RA_ROTATE).all()), "no both-rotate lane")
    deg = (torch.rand(8, generator=gen) * 2 - 1) * 45.0
    inv = torch.linalg.inv(augment.affine_matrix(
        384, 384, deg, 0.95 + 0.1 * torch.rand(8, generator=gen),
        (torch.rand((8, 2), generator=gen) * 2 - 1) * 0.05,
        (torch.rand((8, 2), generator=gen) * 2 - 1) * 15.0))
    augment_compare("rand_augment (shear_matmul)", lambda dev:
                    augment.rand_augment(images.to(dev), ra.to(dev)),
                    TOL_AUG, flips=True)
    augment_compare("classify crop/flip/jitter/RandAugment 416->384",
                    lambda dev: augment.classification_train_augment(
                        canvas.to(dev), draws.to(dev), ccfg),
                    TOL_AUG / 0.224, flips=True)
    j = draws.jitter
    augment_compare("classify color jitter", lambda dev: augment.color_jitter(
        images.to(dev), *(t.to(dev) for t in (
            j.apply, j.brightness, j.contrast, j.saturation, j.hue,
            j.order))), TOL_AUG)
    for variant in ("taps", "flat", "patch", "shear_matmul"):
        augment_compare(f"warp {variant}", lambda dev: augment.bilinear_warp(
            images.to(dev), inv.to(dev), variant), TOL_AUG)
    augment_compare("warp lanczos4", lambda dev: augment.lanczos4_warp(
        images.to(dev), inv.to(dev)), TOL_AUG)
    with augment_bf16():
        for variant in ("taps", "flat", "patch", "shear_matmul"):
            augment_compare(f"warp {variant} ARSVT_AUGMENT_BF16",
                            lambda dev: augment.bilinear_warp(
                                images.to(dev), inv.to(dev), variant),
                            TOL_AUG_BF16)

    # times at B = 256 from the preset's canvas, on the card
    n = 256
    cgen = torch.Generator(device="cuda").manual_seed(15)
    big_canvas = torch.rand((n, 416, 416, 3), generator=cgen, device="cuda")
    big = torch.rand((n, 384, 384, 3), generator=cgen, device="cuda")
    pcfg = augment.ClassifyAugmentConfig(image_size=384, rand_augment=True)
    pdraws = augment.draw_classification_augment(gen, n, pcfg).to("cuda")
    rdeg = (torch.rand(n, generator=gen) * 2 - 1) * 15.0
    rinv = torch.linalg.inv(augment.rotation_matrix(384, 384, rdeg)).cuda()
    timed = {
        "classify pipeline, the preset (crop 416->384, flip, RandAugment)":
            lambda: augment.classification_train_augment(big_canvas, pdraws,
                                                         pcfg),
    }
    for variant in ("taps", "flat", "patch", "shear_matmul"):
        timed[f"warp {variant}, every image"] = (
            lambda v=variant: augment.bilinear_warp(big, rinv, v))
    timed["warp lanczos4, every image"] = (
        lambda: augment.lanczos4_warp(big, rinv))
    rec = {"timing": "augmentation at B = 256, 384 px", "card": smi,
           "rotating_images_in_the_preset_draws": int(
               (pdraws.rand_augment.op == augment.RA_ROTATE).any(1).sum()),
           "ms": {}}
    for name, fn in timed.items():
        rec["ms"][name] = cuda_ms(fn, iters=2, warmup=1)
    with augment_bf16():
        for variant in ("taps", "shear_matmul"):
            rec["ms"][f"warp {variant}, every image, ARSVT_AUGMENT_BF16"] = (
                cuda_ms(lambda v=variant: augment.bilinear_warp(big, rinv, v),
                        iters=2, warmup=1))
    log(json.dumps(rec))
    del big, big_canvas


def remat_expected(route: str, policy: str, depth: int, micro: int,
                   dtype, dropout: bool = False) -> dict:
    """Launches of `micro` forward + backward passes of `depth` layers under
    `policy` on `route`, from REMAT_TABLE; with `dropout` (residual and
    attention) every launch of #1, #2, #5 and #6 runs its dropout branch,
    the replays too, and the apply kernel runs each site forward and
    backward and a layer's attention residual site again where the policy
    replays the block around it (REMAT_MASK_REPLAYS)."""
    fwd1, fwd5, fwd8, bwd9 = (depth * micro * n
                              for n in REMAT_TABLE[policy])
    counts = dict.fromkeys((name for name, _, _ in COUNTERS), 0)
    layers = depth * micro
    if route == "default":
        counts["encoder_attention_fwd"] = fwd1
        counts["encoder_attention_bwd"] = (
            layers * encoder_attention.BWD_LAUNCHES_PER_CALL)
    else:
        counts["encoder_attention_fwd_savep"] = fwd5
        counts["encoder_attention_bwd_savep"] = (
            layers * encoder_attention.SAVEP_BWD_LAUNCHES_PER_CALL)
        counts["fused_mlp_fwd"] = fwd8 * fused_mlp.FWD_LAUNCHES_PER_CALL[
            dtype]
        counts["fused_mlp_bwd"] = bwd9 * fused_mlp.BWD_LAUNCHES_PER_CALL
    if dropout:
        for name in ("encoder_attention_fwd", "encoder_attention_bwd",
                     "encoder_attention_fwd_savep",
                     "encoder_attention_bwd_savep"):
            counts[f"{name}_dropout"] = counts[name]
        sites = 1 + 2 * depth  # positional, two residual a layer
        counts["dropout_apply"] = micro * (
            2 * sites + depth * REMAT_MASK_REPLAYS[policy])
    counts.update(norm_launches(types.SimpleNamespace(depth=depth),
                                micro=micro, policy=policy,
                                fused_mlp=route != "default"))
    return counts


def remat_grads(params, images, cfg, policy, probe):
    """Loss <out, probe> (a fixed random direction: the final LayerNorm
    keeps the tokens' norms, so a loss of the norms would send no
    gradient) and its gradients under `policy`."""
    out = apply_backbone(params, images, cfg, train=True, rng=Rng(14, 0, 1),
                         remat=policy != "none",
                         remat_policy=policy.replace("none", "full"))
    loss = (out.float() * probe).mean()
    grads = torch.autograd.grad(loss, tree_leaves(params))
    torch.cuda.synchronize()
    return loss.detach(), grads


def phase_remat_checks() -> dict:
    """14(b) and (c). Returns the launches of the remat runs."""
    total = dict.fromkeys((name for name, _, _ in COUNTERS), 0)
    cfg = dataclasses.replace(PRESETS[VITL], depth=2, dropout=0.1,
                              attn_dropout=0.1)
    params = tree_map(lambda t: t.cuda(), init_backbone(cfg, 14))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(16)
    images = torch.rand((4, 384, 384, 3), generator=gen, device="cuda")
    probe = torch.randn((4, cfg.seq_len, cfg.embed_dim), generator=gen,
                        device="cuda")
    for route in ("default", "opt_in"):
        with switches(route == "opt_in"):
            refs = {}
            for policy in ("none",) + REMAT_POLICIES:
                zero_counts()
                loss, grads = remat_grads(params, images, cfg, policy, probe)
                got = read_counts()
                want = remat_expected(route, policy, 2, 1, torch.float32,
                                      dropout=True)
                add_counts(total, got)
                check(got == want, f"remat {route} {policy}: launches "
                      f"{got} != {want}")
                ref_key = ("unfused" if route == "opt_in"
                           and policy == "mlp_tail" else "none")
                if policy == "none":
                    check(all(float(g.abs().max()) > 0 for g in grads),
                          "a leaf of the remat check has no gradient")
                    refs["none"] = (loss, grads)
                    continue
                if ref_key not in refs:  # mlp_tail's reference: no fused MLP
                    os.environ.pop("ARSVT_ENABLE_FUSED_MLP")
                    refs[ref_key] = remat_grads(params, images, cfg, "none",
                                                probe)
                    os.environ["ARSVT_ENABLE_FUSED_MLP"] = "1"
                ref_loss, ref_grads = refs[ref_key]
                worst = max(float((a - b).abs().max()) /
                            max(float(b.abs().max()), 1e-30)
                            for a, b in zip(grads, ref_grads))
                equal = bool(torch.equal(loss, ref_loss)) and all(
                    torch.equal(a, b) for a, b in zip(grads, ref_grads))
                rec = {"check": f"remat {policy} vs none, {route} route",
                       "model": "ViT-L/16@384 depth 2, fp32, B = 4, dropout "
                                "0.1, attention dropout 0.1",
                       "loss": float(loss), "loss_none": float(ref_loss),
                       "equal_to_the_bit": equal,
                       "max_rel_err_grads": worst, "tol": TOL_REMAT,
                       "launches": {k: v for k, v in got.items() if v}}
                log(json.dumps(rec))
                check(abs(float(loss) - float(ref_loss)) <=
                      TOL_REMAT * abs(float(ref_loss)) and worst <= TOL_REMAT,
                      f"remat {policy} {route}: {rec}")
    del params
    # without attention dropout: the plain mask's int64 Philox over (B, H,
    # S, S) takes minutes on the host at S = 577; the masks' replay is held
    # above, and the masks card against CPU by phases 3 and 11(c)
    log("# phase 14(b): a remat step of the recipe, card vs CPU")
    PRESETS[VITL_D2] = dataclasses.replace(PRESETS[VITL], depth=2)
    phase_train_parity(PRESETS[VITL_D2], preset=VITL_D2, canvas=416,
                       mixup_alpha=0.2, label_smoothing=0.1, remat=True)
    return total


def fresh_vitl_state(init_fn):
    """The preset's init on the card."""
    t0 = time.perf_counter()
    state = init_fn()
    torch.cuda.synchronize()
    log(json.dumps({"init": VITL, "seconds": time.perf_counter() - t0,
                    "parameters": sum(p.numel() for p in tree_leaves(
                        state["params"]))}))
    return state


def time_steps(step, state, batch, warm: int, timed: int):
    """warm + timed steps; returns (state, ms a timed step, losses, peak
    GB over all of them)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for _ in range(warm):
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / timed * 1e3
    return (state, ms, [float(v) for v in losses],
            torch.cuda.max_memory_allocated() / 1e9)


def phase_remat_cost(smi) -> None:
    """14(d), at VITL_D12."""
    cfg = PRESETS[VITL_D12]
    gen = torch.Generator(device="cuda").manual_seed(17)
    batch = {"image": torch.rand((16, 384, 384, 3), generator=gen,
                                 device="cuda"),
             "label": torch.randint(0, 6, (16,), generator=gen,
                                    device="cuda")}
    base = TrainConfig(preset=VITL_D12, batch_size=16, grad_accum=1,
                       bf16=True,
                       augment="none", warmup_steps=1, total_steps=10**6)
    init_fn, _, _ = make_classifier_step_fns(base)
    state = fresh_vitl_state(init_fn)
    state_gb = torch.cuda.memory_allocated() / 1e9
    rows = {}
    for policy in ("none",) + REMAT_POLICIES:
        _, step, _ = make_classifier_step_fns(base.with_overrides(
            remat=policy != "none",
            remat_policy=policy.replace("none", "full")))
        state, ms, losses, peak = time_steps(step, state, batch, 1, 2)
        check(all(np.isfinite(losses)), f"remat cost {policy}: {losses}")
        rows[policy] = {"ms_per_step": ms, "peak_memory_gb": peak,
                        "peak_over_state_gb": peak - state_gb}
    log(json.dumps({"timing": f"remat policies, ViT-L/16@384 {cfg.depth} "
                    "layers, bf16, one microbatch of 16, default route",
                    "state_gb": state_gb, "policies": rows, "card": smi}))
    order = sorted(rows, key=lambda k: rows[k]["peak_memory_gb"])
    log(json.dumps({"peak_memory_order": order}))
    check(rows["full"]["peak_memory_gb"] < rows["none"]["peak_memory_gb"],
          f"full remat does not lower the peak: {rows}")


def remat_launches(depth, micro, steps, eval_forwards, replay=2) -> dict:
    """The default route's launches under full remat: #1 `replay` times a
    layer and microbatch (forward and replay) plus once a layer and eval
    forward, #2 one call a layer and microbatch, #7 once a step; `replay`
    1 is the run without remat. The LayerNorm and GELU kernels as
    `norm_launches` counts them."""
    counts = dict.fromkeys((name for name, _, _ in COUNTERS), 0)
    counts.update(norm_launches(types.SimpleNamespace(depth=depth),
                                forwards=eval_forwards, micro=micro * steps,
                                policy="full" if replay == 2 else "none"))
    counts["encoder_attention_fwd"] = depth * (micro * steps * replay
                                               + eval_forwards)
    counts["encoder_attention_bwd"] = (
        depth * micro * steps * encoder_attention.BWD_LAUNCHES_PER_CALL)
    counts["fused_adamw"] = steps
    return counts


def phase_recipe_train(smi) -> dict:
    """14(e). Returns the launches of its steps."""
    total = dict.fromkeys((name for name, _, _ in COUNTERS), 0)
    tcfg = TRAIN_PRESETS["vit_large_384"]
    cfg = PRESETS[VITL]
    init_fn, step, _ = make_classifier_step_fns(tcfg)
    state = fresh_vitl_state(init_fn)
    gen = torch.Generator(device="cuda").manual_seed(18)
    batch = batch_of(tcfg, gen, tcfg.batch_size)
    zero_counts()  # the preset's training path starts here
    state, ms, losses, peak = time_steps(step, state, batch, 1, 3)
    counts = read_counts()
    add_counts(total, counts)
    want = remat_launches(cfg.depth, tcfg.grad_accum, 4, 0)
    check(counts == want, f"vit_large_384 launches {counts} != {want}")
    gflop = backbone_fwd_gflops(cfg)
    rec = {"timing": "train step vit_large_384 as it stands",
           "batch": tcfg.batch_size, "grad_accum": tcfg.grad_accum,
           "remat": tcfg.remat, "remat_policy": tcfg.remat_policy,
           "augment": tcfg.augment, "mixup_alpha": tcfg.mixup_alpha,
           "label_smoothing": tcfg.label_smoothing, "canvas": tcfg.canvas,
           "dtype": "bfloat16", "steps_timed": 3, "ms_per_step": ms,
           "train_images_per_s": tcfg.batch_size / ms * 1e3,
           "peak_memory_gb": peak, "forward_gflop_per_image": gflop,
           "model_tflop_per_s_3x": 3 * gflop * tcfg.batch_size / ms,
           "model_tflop_per_s_4x_with_replay":
               4 * gflop * tcfg.batch_size / ms,
           "losses": losses, "launches": {k: v for k, v in counts.items()
                                          if v}, "card": smi}
    log(json.dumps(rec))
    check(all(np.isfinite(losses)), f"vit_large_384 losses {losses}")
    zero_counts()
    phase_train_profile(state, step, batch, ms,
                        title="train step vit_large_384 as it stands")
    add_counts(total, read_counts())
    check_recipe_adamw(step, state, batch,
                       remat_launches(cfg.depth, tcfg.grad_accum, 1, 0))
    del state, step, batch
    check_recipe_attention(cfg, tcfg.batch_size // tcfg.grad_accum)

    log("# phase 14(e): bench.py's ViT-L configuration, 32 as 2 x 16, no "
        "remat, 12 layers")
    bcfg = tcfg.with_overrides(preset=VITL_D12, batch_size=32, grad_accum=2,
                               remat=False)
    init_fn, step, _ = make_classifier_step_fns(bcfg)
    state = fresh_vitl_state(init_fn)
    batch = batch_of(tcfg, gen, 32)
    zero_counts()
    state, ms, losses, peak = time_steps(step, state, batch, 1, 3)
    counts = read_counts()
    add_counts(total, counts)
    half = PRESETS[VITL_D12]
    want = remat_launches(half.depth, 2, 4, 0, replay=1)
    check(counts == want, f"bench ViT-L launches {counts} != {want}")
    log(json.dumps({"timing": "train step vit_large_384, bench.py:350-355 "
                    "(batch 32 as 2 x 16, no remat) at 12 of ViT-L's 24 "
                    "layers", "ms_per_step": ms,
                    "train_images_per_s": 32 / ms * 1e3,
                    "peak_memory_gb": peak,
                    "model_tflop_per_s_3x":
                        3 * backbone_fwd_gflops(half) * 32 / ms,
                    "losses": losses, "card": smi}))
    check(all(np.isfinite(losses)), f"bench ViT-L losses {losses}")
    return total


def check_recipe_adamw(step, state, batch, want) -> None:
    """#7 at the preset's own call: one more step of the preset, whose
    update (the ViT-L tree, its moments and the gradients of its 256
    images) is copied as the kernel is called and held against the plain
    version leaf by leaf at phase 3's limit."""
    seen = {}
    kernel = optim.fused_adamw

    def copy_then_launch(scalars, grads, ms, vs, ps, decayed, **hyper):
        seen.update(before=[tuple(t.detach().clone() for t in leaf)
                            for leaf in zip(grads, ms, vs, ps)],
                    scalars=scalars.clone(), decayed=list(decayed),
                    hyper=hyper, after=list(zip(ms, vs, ps)))
        kernel(scalars, grads, ms, vs, ps, decayed, **hyper)

    optim.fused_adamw = copy_then_launch
    try:
        zero_counts()
        step(state, batch)
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        optim.fused_adamw = kernel
    check(counts == want, f"vit_large_384 checked step launches {counts} "
                          f"!= {want}")
    hyper, err = seen["hyper"], 0.0
    for (g, m, v, p), (m2, v2, p2), dflag in zip(
            seen["before"], seen["after"], seen["decayed"]):
        rp, rm, rv = fused_adamw.adamw_plain(
            seen["scalars"], g, m, v, p,
            **{**hyper, "wd": hyper["wd"] if dflag else 0.0})
        err = max(err, max_err(p2, rp), max_err(m2, rm), max_err(v2, rv))
    log(json.dumps({
        "check": "fused_adamw on the vit_large_384 step's own update",
        "leaves": len(seen["before"]),
        "params": sum(p.numel() for *_, p in seen["before"]),
        "max_abs_param": max(float(p.abs().max())
                             for *_, p in seen["before"]),
        "max_abs_err": err, "tol": TOL_ADAMW}))
    check(err <= TOL_ADAMW, f"fused_adamw disagrees with its plain version "
                            f"on the vit_large_384 update: {err}")


# the plain side of the preset-shape attention check runs this many
# images at a time: its fp32 (B, H, S, S) scores take 0.68 GB at 32
RECIPE_PLAIN_CHUNK = 32


def check_recipe_attention(cfg, b) -> None:
    """#1 and #2 at the preset's shapes, one microbatch of `b` images of
    ViT-L/16@384 (S = 577, D = 1,024 in 16 heads) in bf16 without dropout
    as the preset runs them, against their plain versions on the same
    inputs at phase 3's limits."""
    s, d, h = cfg.seq_len, cfg.embed_dim, cfg.num_heads
    gen = torch.Generator(device="cuda").manual_seed(20)
    qkv = torch.randn((b, s, 3 * d), generator=gen,
                      device="cuda").to(torch.bfloat16)
    dout = torch.randn((b, s, d), generator=gen,
                       device="cuda").to(torch.bfloat16)
    out, lse = encoder_attention.encoder_attention_fwd(qkv, h)
    grads = encoder_attention.encoder_attention_bwd(qkv, out, dout, lse, h)
    torch.cuda.synchronize()
    rec = {"check": "encoder_attention_fwd and _bwd at vit_large_384's "
                    "shapes", "B": b, "S": s, "D": d, "H": h,
           "dtype": "bfloat16", "tol_out": TOL_BF16, "tol_lse": TOL_LSE,
           "tol_grads": TOL_BWD_BF16}
    errs = dict.fromkeys(("out", "lse", "dq", "dk", "dv"), 0.0)
    ok = True
    for i in range(0, b, RECIPE_PLAIN_CHUNK):
        sl = slice(i, i + RECIPE_PLAIN_CHUNK)
        ref_out, ref_lse = encoder_attention.encoder_attention_fwd_plain(
            qkv[sl], h)
        ref = encoder_attention.encoder_attention_bwd_plain(
            qkv[sl], out[sl], dout[sl], lse[sl], h)
        pairs = [("out", out[sl], ref_out, TOL_BF16),
                 ("lse", lse[sl], ref_lse, None)]
        pairs += [(name, x[sl], r, TOL_BWD_BF16)
                  for name, x, r in zip(("dq", "dk", "dv"), grads, ref)]
        for name, x, r, tol in pairs:
            check(bool(torch.isfinite(x.float()).all()),
                  f"non-finite {name} at vit_large_384's shapes")
            errs[name] = max(errs[name], max_err(x, r))
            if tol is not None:
                ok &= bool(((x.float() - r.float()).abs()
                            <= tol + tol * r.float().abs()).all())
    rec.update({f"max_abs_err_{k}": v for k, v in errs.items()})
    log(json.dumps(rec))
    check(ok and errs["lse"] <= TOL_LSE,
          f"encoder attention disagrees with its plain version at "
          f"vit_large_384's shapes: {rec}")


def batch_of(tcfg, gen, n):
    """n uint8 images on the preset's canvas and labels, on the card."""
    return {"image": torch.randint(0, 256, (n, tcfg.canvas, tcfg.canvas, 3),
                                   generator=gen, device="cuda",
                                   dtype=torch.uint8),
            "label": torch.randint(0, 6, (n,), generator=gen, device="cuda")}


def phase_recipe_cli(tmp, smi) -> dict:
    """14(f)."""
    directory = os.path.join(tmp, "vit_large_384")
    cfg = PRESETS[VITL]
    want = remat_launches(cfg.depth, 2, 2, EVAL_BATCHES)
    last, counts, seconds = run_cli(directory, RECIPE_CLI_ARGS, expect=want,
                                    base=[])
    ckpts = sorted(os.listdir(os.path.join(directory, "checkpoints")))
    rows = []
    with open(os.path.join(directory, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    evals = [r for r in rows if "val/loss" in r]
    log(json.dumps({"check": "train.cli vit_large_384",
                    "args": RECIPE_CLI_ARGS, "seconds": seconds,
                    "checkpoints": ckpts, "checkpoint_bytes": [
                        os.path.getsize(os.path.join(
                            directory, "checkpoints", c)) for c in ckpts],
                    "last": {
                        k: float(v) for k, v in last.items()},
                    "eval": evals, "launches": {
                        k: v for k, v in counts.items() if v},
                    "card": smi}))
    check(ckpts == ["step_000000002.pt"], f"checkpoints {ckpts}")
    check(len(evals) == 1 and np.isfinite(evals[0]["val/loss"]),
          f"eval rows {evals}")
    check(np.isfinite(float(last["loss"])), f"last {last}")
    return counts


def phase_recipe_detector(smi) -> dict:
    """14(g): one deit_detector_ref step (batch 8) with full remat and the
    taps warp."""
    tcfg = det_train_cfg(batch_size=8, grad_accum=1, remat=True,
                         warp_variant="taps")
    init_fn, step, _ = make_detector_step_fns(tcfg)
    state = init_fn()
    batch = det_random_batch(np.random.default_rng(19), 8)
    det_cfg = DETECTOR_PRESETS[DET_TRAIN_PRESET]
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    enc, dec = det_cfg.backbone.depth, det_cfg.head.depth
    want = {"flash_attention_fwd": 2 * enc + dec,  # the encoder replays
            "flash_attention_bwd": enc + dec, "fused_adamw": 1,
            "dropout_apply": site_launches(resolve_detector(tcfg),
                                           replays=1),
            "lap_solve": 0, "lap": 1,
            **norm_launches(det_cfg, micro=1, policy=tcfg.remat_policy,
                            aux=tcfg.aux_loss)}
    got = {k: counts[k] for k in want}
    log(json.dumps({"check": "deit_detector_ref step, remat full, taps warp",
                    "seconds": seconds, "loss": float(m["loss"]),
                    "launches": {k: v for k, v in counts.items() if v},
                    "expected": want, "card": smi}))
    check(got == want, f"detector remat launches {got} != {want}")
    check(np.isfinite(float(m["loss"])), f"detector loss {m}")
    return counts


def phase_vit_large(smi) -> dict:
    """Phase 14. Returns the launches of (b)-(g)."""
    total = dict.fromkeys((name for name, _, _ in COUNTERS), 0)
    t0 = time.perf_counter()
    log("# phase 14(a): the recipe's augmentation, card vs CPU, and times")
    phase_recipe_augment(smi)
    log("# phase 14(b)-(c): remat policies at ViT-L width, depth 2")
    add_counts(total, phase_remat_checks())
    log("# phase 14(d): remat cost per policy, ViT-L 12 layers, 16 images")
    PRESETS[VITL_D12] = dataclasses.replace(PRESETS[VITL], depth=12)
    phase_remat_cost(smi)
    log("# phase 14(e): TRAIN_PRESETS['vit_large_384'] as it stands")
    add_counts(total, phase_recipe_train(smi))
    with tempfile.TemporaryDirectory() as tmp:
        log("# phase 14(f): train.cli --train-preset vit_large_384")
        add_counts(total, phase_recipe_cli(tmp, smi))
    log("# phase 14(g): deit_detector_ref with remat and the taps warp")
    add_counts(total, phase_recipe_detector(smi))
    log(json.dumps({"phase": 14, "seconds": time.perf_counter() - t0,
                    "launches": {k: v for k, v in total.items() if v}}))
    return total


# Phase 15: DeiT distillation from an imported teacher. (a) seeded timm-
# and HF-layout ViT-B/16 state dicts imported by `python -m
# arsvt_tpu_torch.models.convert --train-preset vit_base_finetune`, each a
# subprocess, all started together; each checkpoint held to its state dict
# under the layout rules (`layout_rules`) to the bit, with its source's
# ln_eps (timm 1e-6, HF 1e-12) and a zero head; a reference-layout
# deit_detector_ref .pth (the reference's envelope) imported with
# --source reference and served once on /detect from its checkpoint. (b)
# the timm import with phase 4's seeded head, its bias centred on (c)'s
# images, as the teacher, and how its argmax spreads over them. (c) the
# DeiT-400 student (deit_ref_400_16_224: 25 heads of 16, CLS and DIST
# heads seeded) with the preset's residual dropout 0.1 and attention
# dropout 0.1, in fp32, batch 4 as 2 x 2, 2 steps of each mode on the card
# against the CPU at phase 11(c)'s limits. (d) bf16 with the preset's dropout and
# attention dropout 0.1, batch 64 as 2 x 32, crop/flip on the 256 canvas,
# fused AdamW: the same steps without a teacher (peak memory's
# reference), then 1 warm-up and 3 timed steps a mode: ms/step, img/s,
# peak memory, the busy share, the student's TFLOP/s (the Trainer's
# count) and the teacher's forward GFLOP. (e) train.cli.main with
# --distillation soft for 2 steps, a checkpoint and an eval. (f) one step
# of (d) under utils.profiling.trace, whose trace names #1's, #3's and
# #4's kernels; StepTimer beside CUDA events over (d)'s timed steps;
# assert_all_finite over the state.
DISTILL_STUDENT = "deit_ref_400_16_224"
DISTILL_TEACHER = "vit_base_16_224"
DISTILL_MODES = ("hard", "soft")
DISTILL_CLI_ARGS = ["--train-preset", "vit_base_finetune", "--preset",
                    DISTILL_STUDENT, "--distillation", "soft",
                    "--batch-size", "64", "--grad-accum", "2", "--steps",
                    "2", "--eval-every", "2", "--checkpoint-every", "2",
                    "--log-every", "1"]
IMPORT_S = 600.0  # the three import subprocesses together
# the kernels of the traced step by the names the profiler gives them
# (template arguments: dtype, head_dim tile, dropout, save-P): #1 (the
# teacher, head_dim 64, no dropout), #3 and #4 (the student, head_dim 16,
# dropout)
DISTILL_TRACE_KERNELS = {
    "encoder_attention_fwd":
        "attention_fwd_kernel<__nv_bfloat16, 64, false, false>",
    "flash_attention_fwd":
        "attention_fwd_kernel<__nv_bfloat16, 16, true, false>",
    "flash_attention_bwd": "attention_bwd_dq_kernel<__nv_bfloat16, 16, true>",
}
# a teacher whose #1 Function kept its activations for a backward would
# add ~2 GB at B = 32 (12 layers of saved inputs); its bf16 weights and
# one layer's transient activations are ~0.3 GB
TOL_TEACHER_PEAK_GB = 1.0
# StepTimer (a synchronize after each step) against CUDA events around the
# same timed steps
TOL_STEP_TIMER = 0.25


def vit_state_dict(cfg, layout: str, seed: int) -> dict:
    """A seeded torch-layout ViT state dict for `cfg` ("timm", or "hf" with
    q, k and v apart) as numpy fp32: every tensor drawn with std 0.02,
    around 1 for the LayerNorm scales (around 0 they would shrink each
    block's output fifty-fold and leave the teacher one answer)."""
    rng = np.random.default_rng(seed)
    d, m, p, c = cfg.embed_dim, cfg.mlp_dim, cfg.patch_size, cfg.in_channels

    def w(*shape, mean=0.0):
        return (mean + 0.02 * rng.standard_normal(shape)).astype(np.float32)

    def ln(name):
        return {name + ".weight": w(d, mean=1.0), name + ".bias": w(d)}

    def linear(name, fan_in, fan_out):
        return {name + ".weight": w(fan_out, fan_in), name + ".bias": w(fan_out)}

    hf = layout == "hf"
    if hf:
        s = {"embeddings.patch_embeddings.projection.weight": w(d, c, p, p),
             "embeddings.patch_embeddings.projection.bias": w(d),
             "embeddings.cls_token": w(1, 1, d),
             "embeddings.position_embeddings": w(1, cfg.seq_len, d),
             **ln("layernorm")}
    else:
        s = {"patch_embed.proj.weight": w(d, c, p, p),
             "patch_embed.proj.bias": w(d), "cls_token": w(1, 1, d),
             "pos_embed": w(1, cfg.seq_len, d), **ln("norm")}
    for i in range(cfg.depth):
        if hf:
            b = f"encoder.layer.{i}."
            for n in ("query", "key", "value"):
                s.update(linear(b + f"attention.attention.{n}", d, d))
            s.update({**ln(b + "layernorm_before"),
                      **ln(b + "layernorm_after"),
                      **linear(b + "attention.output.dense", d, d),
                      **linear(b + "intermediate.dense", d, m),
                      **linear(b + "output.dense", m, d)})
        else:
            b = f"blocks.{i}."
            s.update({**ln(b + "norm1"), **ln(b + "norm2"),
                      **linear(b + "attn.qkv", d, 3 * d),
                      **linear(b + "attn.proj", d, d),
                      **linear(b + "mlp.fc1", d, m),
                      **linear(b + "mlp.fc2", m, d)})
    return s


# the port's name of each per-layer piece and its torch names, by layout
LAYOUT_NAMES = {
    "timm": {"ln1": "norm1", "ln2": "norm2", "attn/proj": "attn.proj",
             "mlp/fc1": "mlp.fc1", "mlp/fc2": "mlp.fc2"},
    "hf": {"ln1": "layernorm_before", "ln2": "layernorm_after",
           "attn/proj": "attention.output.dense",
           "mlp/fc1": "intermediate.dense", "mlp/fc2": "output.dense"},
}


def layout_rules(state: dict, layout: str, depth: int) -> dict:
    """The backbone the layout rules make of `state`, leaf by path: Linear
    weights (out, in) transposed, a LayerNorm's weight as its scale, HF's
    q, k and v concatenated in that order, the patch conv (D, C, p, p) as
    the (p·p·C, D) matrix in (kh, kw, c) order."""
    hf = layout == "hf"
    conv = ("embeddings.patch_embeddings.projection" if hf
            else "patch_embed.proj")
    w = state[conv + ".weight"]
    final = "layernorm" if hf else "norm"
    out = {"patch_embed/kernel": w.transpose(2, 3, 1, 0).reshape(-1, w.shape[0]),
           "patch_embed/bias": state[conv + ".bias"],
           "cls_token": state["embeddings.cls_token" if hf else "cls_token"],
           "pos_embed": state["embeddings.position_embeddings" if hf
                              else "pos_embed"],
           "ln_f/scale": state[final + ".weight"],
           "ln_f/bias": state[final + ".bias"]}
    for i in range(depth):
        b = f"encoder.layer.{i}." if hf else f"blocks.{i}."
        for ours, theirs in LAYOUT_NAMES[layout].items():
            weight = state[b + theirs + ".weight"]
            norm = ours.startswith("ln")
            out[f"blocks/{i}/{ours}/{'scale' if norm else 'kernel'}"] = (
                weight if norm else weight.T)
            out[f"blocks/{i}/{ours}/bias"] = state[b + theirs + ".bias"]
        if hf:
            qkv = [b + f"attention.attention.{n}" for n in
                   ("query", "key", "value")]
            kernel = np.concatenate([state[n + ".weight"].T for n in qkv], 1)
            bias = np.concatenate([state[n + ".bias"] for n in qkv])
        else:
            kernel = state[b + "attn.qkv.weight"].T
            bias = state[b + "attn.qkv.bias"]
        out[f"blocks/{i}/attn/qkv/kernel"] = kernel
        out[f"blocks/{i}/attn/qkv/bias"] = bias
    return out


def reference_detector_state(det, seed: int) -> dict:
    """A seeded state dict with the reference's DeiTObjectDetector names
    and shapes for `det` (std 0.02, LayerNorm scales around 1)."""
    rng = np.random.default_rng(seed)
    bb, h = det.backbone, det.head
    d, m, p = bb.embed_dim, bb.mlp_dim, bb.patch_size

    def w(*shape, mean=0.0):
        return (mean + 0.02 * rng.standard_normal(shape)).astype(np.float32)

    def pair(name, *shape, mean=0.0):
        return {name + ".weight": w(*shape, mean=mean),
                name + ".bias": w(shape[0])}

    s = {**pair("backbone.patch_embedding.projection", d, 3, p, p),
         "backbone.cls_token": w(1, 1, d), "backbone.dist_token": w(1, 1, d),
         "backbone.position_embedding": w(1, bb.seq_len, d),
         **pair("backbone.layer_norm", d, mean=1.0),
         **pair("triplet_projection", det.triplet_dim, d),
         "detection_head.object_queries": w(h.num_queries, d),
         **pair("detection_head.class_head", h.num_classes + 1, d),
         **pair("detection_head.bbox_head", 4, d)}
    for i in range(bb.depth):
        b = f"backbone.transformer_blocks.{i}."
        s.update({**pair(b + "attention.qkv", 3 * d, d),
                  **pair(b + "attention.projection", d, d),
                  **pair(b + "mlp.linear1", m, d),
                  **pair(b + "mlp.linear2", d, m),
                  **pair(b + "layer_norm1", d, mean=1.0),
                  **pair(b + "layer_norm2", d, mean=1.0)})
    for i in range(h.depth):
        b = f"detection_head.decoder.layers.{i}."
        for a in ("self_attn", "multihead_attn"):
            s.update({b + f"{a}.in_proj_weight": w(3 * d, d),
                      b + f"{a}.in_proj_bias": w(3 * d),
                      **pair(b + f"{a}.out_proj", d, d)})
        s.update({**pair(b + "linear1", h.ffn_dim, d),
                  **pair(b + "linear2", d, h.ffn_dim),
                  **pair(b + "norm1", d, mean=1.0),
                  **pair(b + "norm2", d, mean=1.0),
                  **pair(b + "norm3", d, mean=1.0)})
    return s


def convert_subprocesses(jobs: dict, tmp) -> dict:
    """`python -m arsvt_tpu_torch.models.convert` once for each {name:
    args}, all started together on the card; returns {name: (manifest,
    seconds)}. Every process is stopped before this returns."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "ARSVT_PLATFORM"}
    procs, logs = {}, {}
    t0 = time.perf_counter()
    try:
        for name, args in jobs.items():
            logs[name] = os.path.join(tmp, f"convert_{name}.log")
            with open(logs[name], "w") as logfile:
                procs[name] = subprocess.Popen(
                    [sys.executable, "-m", "arsvt_tpu_torch.models.convert",
                     *args], cwd=root, env=env, stdout=logfile,
                    stderr=subprocess.STDOUT)
        out = {}
        for name, proc in procs.items():
            code = proc.wait(timeout=max(1.0, IMPORT_S - (
                time.perf_counter() - t0)))
            with open(logs[name]) as f:
                text = f.read()
            check(code == 0, f"convert {name} exited {code}:\n{text[-3000:]}")
            out[name] = (json.loads(text.strip().splitlines()[-1]),
                         time.perf_counter() - t0)
        return out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


def phase_distill_import(tmp, smi) -> tuple[str, dict]:
    """15(a). Returns (the timm import's checkpoint directory, the launches
    of the served /detect)."""
    from arsvt_tpu_torch.serving.loading import load_inference_bundle

    bb = PRESETS[DISTILL_TEACHER]
    det = DETECTOR_PRESETS[DET_TRAIN_PRESET]
    t0 = time.perf_counter()
    states = {"timm": vit_state_dict(bb, "timm", seed=21),
              "hf": vit_state_dict(bb, "hf", seed=22)}
    ref_state = reference_detector_state(det, seed=23)
    files, jobs = {}, {}
    for layout, state in states.items():
        files[layout] = os.path.join(tmp, f"{layout}.bin")
        torch.save({k: torch.from_numpy(v) for k, v in state.items()},
                   files[layout])
        jobs[layout] = ["--torch-state", files[layout], "--checkpoint-dir",
                        os.path.join(tmp, f"{layout}_import"),
                        "--train-preset", "vit_base_finetune"]
    # the reference's own envelope: weights beside scalars
    files["reference"] = os.path.join(tmp, "best_vit_detector.pth")
    torch.save({"model_state_dict": {k: torch.from_numpy(v)
                                     for k, v in ref_state.items()},
                "epoch": 3, "val_loss": 0.5}, files["reference"])
    jobs["reference"] = ["--torch-state", files["reference"],
                         "--checkpoint-dir",
                         os.path.join(tmp, "reference_import"), "--source",
                         "reference", "--train-preset", DET_TRAIN_PRESET]
    written = time.perf_counter() - t0
    results = convert_subprocesses(jobs, tmp)

    for layout, state in states.items():
        params, cfg = load_inference_bundle(jobs[layout][3])
        want = layout_rules(state, layout, bb.depth)
        got = dict(named_leaves(params["backbone"]))
        check(set(got) == set(want),
              f"{layout} import: leaves {sorted(set(got) ^ set(want))}")
        differ = [k for k in want if not torch.equal(
            got[k], torch.from_numpy(np.ascontiguousarray(want[k])))]
        heads = [t for _, t in named_leaves(params["classifier"])]
        log(json.dumps({"check": f"convert {layout} ViT-B/16 import",
                        "manifest": results[layout][0],
                        "seconds": results[layout][1],
                        "leaves": len(want), "leaves_differing": differ,
                        "ln_eps": cfg.ln_eps, "card": smi}))
        check(not differ, f"{layout} import differs at {differ[:5]}")
        check(cfg.ln_eps == {"timm": 1e-6, "hf": 1e-12}[layout],
              f"{layout} import ln_eps {cfg.ln_eps}")
        check(all(not t.any() for t in heads), f"{layout} head not zero")
    del states

    params, cfg = load_inference_bundle(jobs["reference"][3])
    qkv = ref_state["backbone.transformer_blocks.0.attention.qkv.weight"]
    check(cfg.task == "detect" and torch.equal(
        params["backbone"]["blocks"][0]["attn"]["qkv"]["kernel"],
        torch.from_numpy(np.ascontiguousarray(qkv.T))) and torch.equal(
        params["detr"]["blocks"][0]["ln_cross_kv"]["scale"],
        torch.ones(det.backbone.embed_dim)),
        f"reference import {results['reference'][0]}")
    zero_counts()  # the served imported detector's path starts here
    srv = InferenceServer.from_checkpoint(jobs["reference"][3])
    host, port = srv.start_background(port=0)
    try:
        image = np.random.default_rng(24).integers(0, 256, (240, 320, 3),
                                                   dtype=np.uint8)
        status, data = post(f"http://{host}:{port}/detect",
                            jpeg_bytes(image))
    finally:
        srv.shutdown()
    torch.cuda.synchronize()
    counts = read_counts()
    per_forward = det.backbone.depth + det.head.depth
    log(json.dumps({"check": "reference deit_detector_ref import, /detect "
                    "from its checkpoint", "manifest":
                    results["reference"][0], "seconds":
                    results["reference"][1], "seconds_writing_sources":
                    written, "status": status, "detections":
                    len(data.get("labels", [])), "launches": {
                        k: v for k, v in counts.items() if v}, "card": smi}))
    check(status == 200 and "labels" in data, f"/detect {status} {data}")
    want = dict.fromkeys(counts, 0)
    want["flash_attention_fwd"] = 2 * per_forward  # warm-up and request
    want.update(norm_launches(det, forwards=2))
    check(counts == want, f"imported detector launches {counts} != {want}")
    return jobs["timm"][3], counts


def distill_launches(micro: int, steps: int, eval_forwards: int,
                     teacher: bool = True) -> dict:
    """The distillation path's launches over `micro` microbatches in
    `steps` steps and `eval_forwards` eval forwards: per microbatch the
    student's 12 #3 forward and 12 #4 calls, both on their dropout
    branch, and the teacher's 12 #1 launches without dropout (no #2), and
    the student's 25 dropout sites, one apply launch each way
    (positional and residual; the teacher draws none); per step one #7
    launch; per eval forward 12 #3 calls without dropout. The LayerNorm
    and GELU kernels of the student's microbatches and eval forwards and of
    the teacher's forwards, as `norm_launches` counts them."""
    depth = PRESETS[DISTILL_STUDENT].depth
    counts = dict.fromkeys((name for name, _, _ in COUNTERS), 0)
    counts.update(norm_launches(PRESETS[DISTILL_STUDENT],
                                forwards=eval_forwards, micro=micro))
    if teacher:
        add_counts(counts, norm_launches(PRESETS[DISTILL_TEACHER],
                                         forwards=micro))
    counts["flash_attention_fwd"] = depth * (micro + eval_forwards)
    for name in ("flash_attention_fwd_dropout", "flash_attention_bwd",
                 "flash_attention_bwd_dropout"):
        counts[name] = depth * micro
    if teacher:
        counts["encoder_attention_fwd"] = PRESETS[DISTILL_TEACHER].depth * micro
    counts["dropout_apply"] = site_launches(PRESETS[DISTILL_STUDENT]) * micro
    counts["fused_adamw"] = steps
    return counts


def phase_distill_teacher(timm_dir, tmp, smi) -> tuple[str, dict]:
    """15(b): the timm import with phase 4's seeded head, its bias then
    shifted by the mean of the head's logits over (c)'s 8 images, so the
    teacher's answers follow the images and not the bias (random weights
    see noise images alike: the raw seeded head answers one class for all
    8); saved params only under the import's
    config. Returns (its checkpoint directory, the launches of its two
    forwards)."""
    from arsvt_tpu_torch.serving.loading import load_inference_bundle
    from arsvt_tpu_torch.train.checkpoint import CheckpointManager
    from arsvt_tpu_torch.train.config import resolve_backbone

    params, tcfg = load_inference_bundle(timm_dir)
    bb = resolve_backbone(tcfg)
    params = tree_map(lambda t: t.to("cuda"),
                      seeded_head(params, bb.embed_dim, 6, seed=1))
    images = torch.from_numpy(np.concatenate(
        [b["image"] for b in parity_batches(4)])).cuda()
    zero_counts()
    with torch.no_grad():
        x = augment.eval_preprocess(to_unit_float(images), size=bb.image_size)
        raw = classifier_logits(params, x, bb, 6, None)
        params["classifier"]["head"]["bias"] -= raw.mean(0)
        answers = classifier_logits(params, x, bb, 6, None).argmax(-1).cpu()
    torch.cuda.synchronize()
    counts = read_counts()
    teacher = os.path.join(tmp, "teacher")
    CheckpointManager(teacher, tcfg).save(0, {"params": params,
                                              "opt_state": {}, "step": 0})
    spread = np.bincount(answers.numpy(), minlength=6).tolist()
    log(json.dumps({"check": "distillation teacher: the timm import with "
                    "phase 4's seeded head, bias centred", "ln_eps":
                    tcfg.ln_eps, "argmax_per_class_raw_head": np.bincount(
                        raw.argmax(-1).cpu().numpy(), minlength=6).tolist(),
                    "argmax_per_class": spread, "images": len(answers),
                    "card": smi}))
    check(sum(1 for n in spread if n) >= 2,
          f"the teacher answers one class on (c)'s images: {spread}")
    want = dict.fromkeys(counts, 0)
    want["encoder_attention_fwd"] = 2 * bb.depth
    want.update(norm_launches(bb, forwards=2))
    check(counts == want, f"teacher forward launches {counts} != {want}")
    return teacher, counts


def phase_distill_bench(teacher, tmp, smi) -> dict:
    """15(d) and (f). Returns the launches of its steps."""
    from arsvt_tpu_torch.utils.profiling import (
        StepTimer,
        assert_all_finite,
        trace,
    )

    total = dict.fromkeys((name for name, _, _ in COUNTERS), 0)
    cfg = PRESETS[DISTILL_STUDENT]
    micro, warm, timed = 2, 1, 3
    base = train_cfg(preset=DISTILL_STUDENT, batch_size=64, grad_accum=micro,
                     bf16=True)
    gen = torch.Generator(device="cuda").manual_seed(25)
    batch = batch_of(base, gen, 64)
    init_fn, step, _ = make_classifier_step_fns(base)
    zero_counts()
    _, plain_ms, _, plain_peak = time_steps(step, init_fn(), batch, 1, 2)
    counts = read_counts()
    add_counts(total, counts)
    want = distill_launches(micro * 3, 3, 0, teacher=False)
    check(counts == want, f"no-teacher launches {counts} != {want}")
    teacher_gflop = backbone_fwd_gflops(PRESETS[DISTILL_TEACHER])
    for mode in DISTILL_MODES:
        tcfg = base.with_overrides(distillation=mode,
                                   distill_teacher=teacher)
        init_fn, step, _ = make_classifier_step_fns(tcfg)
        state = init_fn()
        set_head(state["params"], cfg.embed_dim, 6, seed=1)
        timer = StepTimer(warmup=warm)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()  # this mode's timed path starts here
        metrics = []
        for i in range(warm + timed):
            if i == warm:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                start.record()
            with timer:
                state, m = step(state, batch)
            metrics.append(m)
        end.record()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / timed * 1e3
        events_ms = start.elapsed_time(end) / timed
        peak = torch.cuda.max_memory_allocated() / 1e9
        counts = read_counts()
        add_counts(total, counts)
        want = distill_launches(micro * (warm + timed), warm + timed, 0)
        check(counts == want, f"{mode} distillation launches {counts} != "
                              f"{want}")
        losses = [float(m["loss"]) for m in metrics]
        distill = [float(m["loss_distill"]) for m in metrics]
        images_per_s = 64 / ms * 1e3
        student_gflop = train_gflops_per_image(tcfg)
        timer_ms = timer.summary()
        rec = {"timing": f"distillation step {mode}, {DISTILL_STUDENT} "
                         f"from a {DISTILL_TEACHER} teacher",
               "batch": 64, "grad_accum": micro, "dtype": "bfloat16",
               "augment": "crop_flip", "canvas": 256, "steps_timed": timed,
               "ms_per_step": ms, "ms_per_step_cuda_events": events_ms,
               "step_timer": timer_ms, "train_images_per_s": images_per_s,
               "peak_memory_gb": peak, "peak_memory_gb_without_teacher":
                   plain_peak, "ms_per_step_without_teacher": plain_ms,
               "student_train_gflop_per_image": student_gflop,
               "tflops_student": images_per_s * student_gflop / 1e3,
               "teacher_fwd_gflop_per_image": teacher_gflop,
               "teacher_share_of_flops": teacher_gflop / (
                   teacher_gflop + student_gflop),
               "tflops_with_teacher": images_per_s * (
                   student_gflop + teacher_gflop) / 1e3,
               "losses": losses, "loss_distill": distill, "card": smi}
        log(json.dumps(rec))
        check(all(np.isfinite(losses + distill)),
              f"{mode}: non-finite losses {losses} {distill}")
        check(peak - plain_peak < TOL_TEACHER_PEAK_GB,
              f"{mode}: the teacher adds {peak - plain_peak:.2f} GB")
        check(abs(timer_ms["mean_ms"] - events_ms) <= TOL_STEP_TIMER
              * events_ms, f"StepTimer {timer_ms} against CUDA events "
                           f"{events_ms} ms")
        zero_counts()
        phase_train_profile(state, step, batch, ms,
                            title=f"distillation step {mode}")
        counts = read_counts()
        add_counts(total, counts)
        check(counts == distill_launches(micro, 1, 0),
              f"profiled {mode} step launches {counts}")
    # (f) the last mode's state: one more step under utils.profiling.trace
    zero_counts()
    with trace(os.path.join(tmp, "trace")) as path:
        state, _ = step(state, batch)
    counts = read_counts()
    add_counts(total, counts)
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    found = {k: sum(1 for n in names if v in n)
             for k, v in DISTILL_TRACE_KERNELS.items()}
    log(json.dumps({"check": "utils.profiling.trace over one distillation "
                    "step", "bytes": os.path.getsize(path),
                    "events_named": len(names), "kernels_found": found,
                    "launches": {k: v for k, v in counts.items() if v}}))
    check(all(found.values()), f"the trace misses a kernel: {found}")
    check(counts == distill_launches(micro, 1, 0),
          f"traced step launches {counts}")
    assert_all_finite(state, "the distillation state after (d)")
    return total


def phase_distill_cli(teacher, tmp, smi) -> dict:
    """15(e)."""
    from arsvt_tpu_torch.train.checkpoint import peek_config

    directory = os.path.join(tmp, "distill_cli")
    want = distill_launches(2 * 2, 2, EVAL_BATCHES)
    last, counts, seconds = run_cli(
        directory, ["--distill-teacher", teacher], expect=want,
        base=DISTILL_CLI_ARGS)
    ckpt_dir = os.path.join(directory, "checkpoints")
    ckpts = sorted(os.listdir(ckpt_dir))
    rows = []
    with open(os.path.join(directory, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train_rows = [r for r in rows if "train/loss" in r]
    evals = [r for r in rows if "val/loss" in r]
    bound = peek_config(ckpt_dir).distill_teacher
    log(json.dumps({"check": "train.cli --distillation soft",
                    "args": DISTILL_CLI_ARGS, "seconds": seconds,
                    "checkpoints": ckpts, "last": train_rows[-1],
                    "eval": evals, "checkpoint_teacher": bound,
                    "card": smi}))
    row = train_rows[-1]
    check(ckpts == ["step_000000002.pt"], f"checkpoints {ckpts}")
    check(bound == teacher, f"the checkpoint binds teacher {bound!r}")
    check(np.isfinite(row["train/loss_distill"]) and row["train/tflops"] > 0,
          f"the last train row {row}")
    check(len(evals) == 1 and np.isfinite(evals[0]["val/loss"]),
          f"eval rows {evals}")
    return counts


def phase_distill(smi) -> dict:
    """Phase 15. Returns the launches of every path it drives."""
    total = dict.fromkeys((name for name, _, _ in COUNTERS), 0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        log("# phase 15(a): timm, HF and reference checkpoints imported")
        timm_dir, counts = phase_distill_import(tmp, smi)
        add_counts(total, counts)
        log("# phase 15(b): the teacher")
        teacher, counts = phase_distill_teacher(timm_dir, tmp, smi)
        add_counts(total, counts)
        for mode in DISTILL_MODES:
            log(f"# phase 15(c): {mode} distillation, card vs CPU")
            zero_counts()
            phase_train_parity(PRESETS[DISTILL_STUDENT], batch=4,
                               preset=DISTILL_STUDENT,
                               distillation=mode, distill_teacher=teacher)
            counts = read_counts()
            add_counts(total, counts)
            want = distill_launches(2 * 2, 2, 0)
            check(counts == want, f"15(c) {mode} launches {counts} != {want}")
        log("# phase 15(d), (f): timed bf16 distillation steps, profiling")
        add_counts(total, phase_distill_bench(teacher, tmp, smi))
        log("# phase 15(e): train.cli --distillation soft")
        add_counts(total, phase_distill_cli(teacher, tmp, smi))
    log(json.dumps({"phase": 15, "seconds": time.perf_counter() - t0,
                    "launches": {k: v for k, v in total.items() if v}}))
    return total


# Phase 16: data- and tensor-parallel training (``arsvt_tpu_torch/
# parallel/``). (a) NCCL with world size 1: one bench-config ViT-B/16 step
# (bf16, batch 64 as 2 x 32, crop/flip on the 256 canvas, attention dropout
# 0.1) and one deit_detector_ref step (its preset's dropout) through
# `Trainer` with mesh_data=1 over an NCCL group, held to the bit against
# the same steps with no process group. (b) Two ranks on the one card:
# NCCL takes no two ranks on one GPU, so two spawned processes initialise
# gloo themselves on CUDA tensors (gloo sums them through the host) and
# `make_mesh` takes that group; DP = 2 and TP = 2 at full width, residual
# and attention dropout 0.1, ViT-B/16 in fp32 and in bf16 and
# deit_detector_ref (25 heads: 13 and 12 on the TP ranks) in fp32, each
# held against the one-process step on the global batch: fp32 loss and
# gradient norm within PAR_TOL_LOSS, the first Adam moment (one step's
# gradient) and the update within PAR_TOL_UPDATE (relative L2; an element
# whose gradient lies within noise of zero, such as a key bias column,
# whose exact gradient is 0, moves by up to 2 lr the other way, which at
# full width stays under the limit: measured 2.7e-5 to 4.9e-5 on the H100);
# bf16 within phase 7(a2)'s limits on the loss and the gradient norm (its
# update, sign flips of bf16-rounded gradients, is recorded); each rank's launches equal the one-process step's (the
# same layers and microbatches, on its rows and heads). (c) Each of the
# three switches changes the route of one fp32 ViT-B step with attention
# dropout: ARSVT_DISABLE_FUSED_ATTN sends the head_dim-64 layers to #3/#4
# (#1 = #2 = 0), ARSVT_ATTN_JNP too (it sends CPU tensors to the plain
# reference; on the card the attention stays on its kernels, so its launch
# table is ARSVT_DISABLE_FUSED_ATTN's), ARSVT_DISABLE_LN_VJP runs
# no `_LayerNorm` Function. (d) One DP = 2 step against one process,
# host clock and CUDA events, recorded: on one card the two ranks share
# the SMs and gloo crosses the host, so nothing is expected of it.
PAR_TOL_LOSS = 1e-5
PAR_TOL_UPDATE = 1e-4
PAR_DETECT_PRESET = "deit_detector_ref"


def par_classify_job(data: int, model: int, *, bf16: bool = False,
                     timed: int = 0) -> dict:
    """ViT-B/16 with residual and attention dropout 0.1: global batch 8 as
    2 microbatches, crop/flip on the 256 canvas, a seeded random head."""
    from arsvt_tpu_torch.parallel import dryrun

    backbone = dataclasses.asdict(dataclasses.replace(
        PRESETS["vit_base_16_224"], dropout=0.1, attn_dropout=0.1))
    return dryrun.classify_job(
        data, model, name=f"vit_b {'bf16' if bf16 else 'fp32'}",
        device="cuda:0", image_size=256, batch=8, backbone=backbone,
        timed=timed,
        cfg=dict(preset="vit_base_16_224_dropout", batch_size=8,
                 grad_accum=2, bf16=bf16, augment="crop_flip", canvas=256,
                 warmup_steps=0, fused_adamw=True))


def par_detect_job(data: int, model: int) -> dict:
    """deit_detector_ref with its preset's dropout, global batch 4 with
    1-25 boxes an image, detection augmentation on the 256 canvas, fp32."""
    from arsvt_tpu_torch.parallel import dryrun

    job = dryrun.detect_job(
        data, model, name="deit_detector_ref fp32", device="cuda:0",
        image_size=256, batch=4, train_preset=PAR_DETECT_PRESET,
        cfg=dict(preset=PAR_DETECT_PRESET, task="detect", batch_size=4,
                 bf16=False, augment="detection", canvas=256,
                 max_objects=25, warmup_steps=0))
    del job["backbone"], job["detr"]  # the registry's preset as it is
    return job


def phase_parallel_nccl(smi) -> dict:
    """(a) NCCL, world size 1: Trainer steps with a group against the same
    steps without one, to the bit. Returns the launches of the runs with
    the group."""
    import torch.distributed as dist

    from arsvt_tpu_torch.parallel import dryrun
    from arsvt_tpu_torch.train.trainer import Trainer

    check(dist.is_nccl_available(), "this torch has no NCCL")
    rng = np.random.default_rng(16)
    classify = {"image": rng.integers(0, 256, (64, 256, 256, 3),
                                      dtype=np.uint8),
                "label": rng.integers(0, 6, 64).astype(np.int32)}
    # no warm-up: the one step's update is the full learning rate's
    quiet = dict(log_every=1, eval_every=10**9, checkpoint_every=10**9,
                 warmup_steps=0)
    cases = [("vit_b bf16", train_cfg(batch_size=64, grad_accum=2,
                                      bf16=True, attn_dropout=0.1, **quiet),
              classify, PRESETS["vit_base_16_224"]),
             ("deit_detector_ref", det_train_cfg(batch_size=8, **quiet),
              det_random_batch(rng, 8), DETECTOR_PRESETS[DET_TRAIN_PRESET])]
    total = dict.fromkeys([n for n, _, _ in dryrun.KERNEL_COUNTERS], 0)

    def one_step(cfg, batch):
        trainer = Trainer(cfg, device="cuda")
        trainer.init_state()
        if cfg.task == "classify":
            set_head(trainer.state["params"], 768, 6, seed=1)
        dryrun.kernel_counts(zero=True)
        out = trainer.fit(iter([batch]), steps=1)
        torch.cuda.synchronize()
        params = [p.detach().cpu() for p in
                  tree_leaves(trainer.state["params"])]
        return out, params, dryrun.kernel_counts()

    for name, cfg, batch, model in cases:
        plain = one_step(cfg, batch)
        dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                                f"{free_port()}", world_size=1, rank=0,
                                device_id=torch.device("cuda", 0))
        try:
            grouped = one_step(cfg, batch)
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
        same = all(torch.equal(a, b) for a, b in zip(plain[1], grouped[1]))
        rec = {"check": "Trainer step on an NCCL group of 1 vs no group",
               "case": name, "backend": backend,
               "loss": [plain[0]["loss"], grouped[0]["loss"]],
               "params_identical": same, "launches": grouped[2],
               "launches_no_group": plain[2], "card": smi}
        log(json.dumps(rec))
        check(backend == "nccl", f"16(a) ran on {backend}")
        check(same and plain[0]["loss"] == grouped[0]["loss"],
              f"16(a) {name}: the NCCL step differs from the plain one")
        check(plain[2] == grouped[2], f"16(a) {name} launches differ")
        norms = norm_launches(model, micro=cfg.grad_accum,
                              aux=cfg.task == "detect" and cfg.aux_loss)
        check({k: grouped[2][k] for k in NORM_NAMES} == norms,
              f"16(a) {name} LayerNorm and GELU launches {grouped[2]} != "
              f"{norms}")
        for k, v in grouped[2].items():
            total[k] += v
    return total


def phase_parallel_ranks(smi) -> tuple[dict, dict]:
    """(b) and (d): two gloo ranks on the card, DP = 2 and TP = 2, against
    one process. Returns (rank 0's launches, the timing record)."""
    from arsvt_tpu_torch.parallel import dryrun

    jobs = [par_classify_job(2, 1, timed=2), par_classify_job(1, 2),
            par_classify_job(1, 2, bf16=True), par_detect_job(2, 1),
            par_detect_job(1, 2)]
    t0 = time.perf_counter()
    got = dryrun.run_grid(jobs, timeout=900)
    seconds = time.perf_counter() - t0
    total = dict.fromkeys([n for n, _, _ in dryrun.KERNEL_COUNTERS], 0)
    timing = None
    for job, g in zip(jobs, got):
        want = dryrun.run_steps({**job, "timed": job.get("timed", 0)})
        errs = dryrun.compare(g, want)
        bf16 = job["cfg"]["bf16"]
        rec = {"check": "two gloo ranks on the card vs one process",
               "case": job["name"], "grid": [job["data"], job["model"]],
               **errs, "launches_rank0": g["counts"],
               "launches_one_process": want["counts"], "card": smi}
        log(json.dumps(rec))
        if bf16:
            check(errs["loss"] <= TOL_BF16_LOSS
                  and errs["grad_norm"] <= TOL_BF16_NORM,
                  f"16(b) {job['name']} {job['data']}x{job['model']}: "
                  f"{errs}")
        else:
            check(errs["loss"] <= PAR_TOL_LOSS
                  and errs["grad_norm"] <= PAR_TOL_LOSS
                  and errs["moment"] <= PAR_TOL_UPDATE
                  and errs["update"] <= PAR_TOL_UPDATE,
                  f"16(b) {job['name']} {job['data']}x{job['model']}: "
                  f"{errs}")
        launched = ("fused_adamw", "dropout_apply") + NORM_NAMES + (
            ("lap",) if job["cfg"].get("task") == "detect" else ())
        check(g["counts"] == want["counts"] and all(
            g["counts"][k] > 0 for k in launched),
            f"16(b) {job['name']} launches {g['counts']} != "
            f"{want['counts']}")
        for k, v in g["counts"].items():
            total[k] += v
        if job.get("timed"):
            timing = {"timing": "one DP = 2 step (two gloo ranks on the "
                                "card) vs one process", "case": job["name"],
                      "dp2_rank0": g["timed"], "one_process": want["timed"],
                      "card": smi}
    log(json.dumps({"phase": "16(b)", "seconds_two_ranks": seconds}))
    log(json.dumps(timing))
    return total, timing


def phase_parallel_switches(smi) -> dict:
    """(c) each switch changes one fp32 ViT-B step's route. Returns the
    launches."""
    from arsvt_tpu_torch.ops import layernorm
    from arsvt_tpu_torch.parallel import dryrun

    tcfg = train_cfg(batch_size=2, bf16=False, attn_dropout=0.1,
                     warmup_steps=0)
    rng = np.random.default_rng(17)
    batch = {"image": rng.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8),
             "label": rng.integers(0, 6, 2).astype(np.int32)}
    ln_calls = [0]
    real_apply = layernorm._LayerNorm.apply

    def counted(*args):
        ln_calls[0] += 1
        return real_apply(*args)

    total = dict.fromkeys([n for n, _, _ in dryrun.KERNEL_COUNTERS], 0)
    runs = {}
    layernorm._LayerNorm.apply = counted
    try:
        for switch in (None, "ARSVT_DISABLE_FUSED_ATTN", "ARSVT_ATTN_JNP",
                       "ARSVT_DISABLE_LN_VJP"):
            if switch:
                os.environ[switch] = "1"
            try:
                init_fn, step, _ = make_classifier_step_fns(tcfg)
                state = init_fn()
                set_head(state["params"], 768, 6, seed=1)
                ln_calls[0] = 0
                dryrun.kernel_counts(zero=True)
                _, m = step(state, batch, step_seed=3)
                loss = float(m["loss"])
                runs[switch] = (dryrun.kernel_counts(), ln_calls[0], loss)
            finally:
                if switch:
                    os.environ.pop(switch)
    finally:
        del layernorm._LayerNorm.apply  # the inherited classmethod again
    for switch, (counts, ln, loss) in runs.items():
        log(json.dumps({"check": "a switch's route on the card",
                        "switch": switch, "launches": counts,
                        "layer_norm_functions": ln, "loss": loss,
                        "card": smi}))
        for k, v in counts.items():
            total[k] += v
    base, fused_off, plain, ln_off = (runs[k] for k in runs)
    depth = 12
    norms = norm_launches(PRESETS["vit_base_16_224"], micro=tcfg.grad_accum)
    check(base[0]["encoder_attention_fwd"] == depth
          and base[0]["flash_attention_fwd"] == 0 and base[1] > 0
          and {k: base[0][k] for k in NORM_NAMES} == norms,
          f"16(c) default route {base}")
    check(fused_off[0]["encoder_attention_fwd"] == 0
          and fused_off[0]["encoder_attention_bwd"] == 0
          and fused_off[0]["flash_attention_fwd"] == depth
          and fused_off[0]["flash_attention_bwd"] == depth
          and {k: fused_off[0][k] for k in NORM_NAMES} == norms,
          f"16(c) ARSVT_DISABLE_FUSED_ATTN {fused_off}")
    check(plain[0] == fused_off[0], f"16(c) ARSVT_ATTN_JNP {plain}")
    # no LayerNorm kernel under the switch, every other launch as before
    check(ln_off[1] == 0 and ln_off[0] == {
        **base[0], **norm_launches(PRESETS["vit_base_16_224"],
                                   micro=tcfg.grad_accum, ln_vjp=False)},
          f"16(c) ARSVT_DISABLE_LN_VJP {ln_off}")
    for name, run in (("fused_off", fused_off), ("plain", plain),
                      ("ln_off", ln_off)):
        rel = abs(run[2] - base[2]) / abs(base[2])
        check(rel <= TOL_TRAIN_LOSS, f"16(c) {name} loss {rel}")
    return total


def phase_parallel(smi) -> dict:
    """Phase 16. Returns the launches of the paths it drives."""
    from arsvt_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    log("# phase 16(a): Trainer on an NCCL group of one")
    total = phase_parallel_nccl(smi)
    log("# phase 16(b), (d): two gloo ranks on the card, DP = 2 and TP = 2")
    counts, _ = phase_parallel_ranks(smi)
    for k, v in counts.items():
        total[k] += v
    log("# phase 16(c): the three switches")
    for k, v in phase_parallel_switches(smi).items():
        total[k] += v
    log(json.dumps({"phase": 16, "seconds": time.perf_counter() - t0,
                    "launches": total}))
    return total


# Phase 17: the four presets of arsvt_tpu_torch/models/registry.py that no
# other phase runs, at full width and depth through their entry points,
# each part's launches held exactly. (a) vit_tiny_16_224, BASELINE config
# #1 (the vit_tiny_eval train preset, batch 8, bf16): train.cli.main from
# a TrashNet tree for 2 steps with a checkpoint; evaluation.cli.main on it
# (and on a copy with a seeded head) against evaluate_classifier in fp32
# on the CPU (phase 12(c)'s rule); StreamingClassifier fp32 card vs CPU
# and bf16 vs fp32 at B = 1 and 8 (phase 4's limits); /classify p50 and
# p99 at B = 1 over PRESET_REQUESTS requests on the server's clock beside
# ViT-B/16's; an fp32 step (2 microbatches of 4) card vs CPU on each route
# (phase 7(a)'s limits, TOL_TRAIN_*). (b) vit_small_16_224: phase 4's
# forwards and one fp32 step on each route. (c) vit_demo_8_96 (96 px,
# patch 8, S = 145): phase 4's forwards, and an fp32 crop/flip step on the
# demo's 112 canvas with batches of `synthetic_shape_image`. (d)
# detector_demo_96: StreamingDetector fp32 card vs CPU, bf16 vs fp32 and
# post_process (phase 8's limits); two fp32 steps of batch 4 card vs CPU
# (TOL_DET_TRAIN_*, matched pairs equal) on the device matcher, in
# benchmarks/detection_generalization_demo.py's configuration (no
# dropout, no augmentation) with 25 box slots.
PRESET_REQUESTS = 100
PRESET_CLI_STEPS = 2
PRESET_CLI_ARGS = ["--train-preset", "vit_tiny_eval", "--steps",
                   str(PRESET_CLI_STEPS), "--eval-every",
                   str(PRESET_CLI_STEPS), "--checkpoint-every",
                   str(PRESET_CLI_STEPS), "--log-every", "1"]
DEMO_CANVAS = 112  # benchmarks/classification_generalization_demo.py's


def held_path(total: dict, name: str, fn, expected):
    """Run `fn` with every count zeroed just before it and read just after
    it; hold the launches to `expected` (a dict of the counts that are not
    0, or a function of what `fn` returned that gives one) exactly, and add
    them to `total`. Returns what `fn` returned."""
    torch.cuda.synchronize()
    zero_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = read_counts()
    want = {**dict.fromkeys(counts, 0),
            **(expected(out) if callable(expected) else expected)}
    log(json.dumps({"launches": {k: v for k, v in counts.items() if v},
                    "path": name}))
    check(counts == want, f"{name}: launches {counts} != {want}")
    add_counts(total, counts)
    return out


def serving_launches(cfg, forwards: int) -> dict:
    """A classifier's forwards without a gradient: #1 once a layer, the
    LayerNorm and GELU kernels as `norm_launches` counts them."""
    return {"encoder_attention_fwd": cfg.depth * forwards,
            **norm_launches(cfg, forwards=forwards)}


def preset_forwards(total: dict, name: str, seed: int) -> None:
    """Phase 4's StreamingClassifier checks for the preset `name` with a
    seeded head, on seeded images of its size."""
    cfg = PRESETS[name]
    params = seeded_head(init_image_classifier(cfg, 6, seed=0),
                         cfg.embed_dim, 6, seed=1)
    rng = np.random.default_rng(seed)
    size = cfg.image_size
    images = [rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
              for _ in range(4)]
    batch = rng.integers(0, 256, (8, size, size, 3), dtype=np.uint8)
    held_path(total, f"{name} StreamingClassifier",
              lambda: phase_model(cfg, params, images, batch, name=name),
              lambda out: serving_launches(cfg, out[1]))


def preset_steps(total: dict, name: str, **kw) -> None:
    """One fp32 card-vs-CPU step pair (phase 7(a)) of the preset `name` on
    the default route and on the opt-in route, each with its launches."""
    cfg = PRESETS[name]
    for route, opt_in in (("default", False), ("opt-in", True)):
        with switches(opt_in):
            held_path(total, f"{name} fp32 steps, {route} route",
                      lambda: phase_train_parity(cfg, route=route,
                                                 preset=name, **kw),
                      classifier_launches(cfg.depth, 2, 2, 0, opt_in,
                                          dtype=torch.float32))


def demo_batches(batch: int) -> list[dict]:
    """Two uint8 batches of `synthetic_shape_image` on the demo's canvas."""
    from arsvt_tpu_torch.data.synthetic import synthetic_shape_image

    rng = np.random.default_rng(6)
    out = []
    for _ in range(2):
        labels = rng.integers(0, 6, batch)
        out.append({"image": np.stack([
            (synthetic_shape_image(int(c), DEMO_CANVAS, rng) * 255).astype(
                np.uint8) for c in labels]),
            "label": labels.astype(np.int32)})
    return out


def preset_latency(total: dict, smi: str) -> dict:
    """/classify at B = 1, PRESET_REQUESTS requests one at a time through
    InferenceServer, vit_tiny_16_224 then vit_base_16_224 (seeded heads),
    on the server's clock and the client's."""
    body = png_bytes(np.random.default_rng(17).integers(
        0, 256, (224, 224, 3), dtype=np.uint8))
    out = {}
    for name in ("vit_tiny_16_224", "vit_base_16_224"):
        cfg = PRESETS[name]
        params = seeded_head(init_image_classifier(cfg, 6, seed=0),
                             cfg.embed_dim, 6, seed=1)
        out[name] = held_path(
            total, f"{name} /classify latency",
            lambda: serve_latency(InferenceServer(
                classifier=StreamingClassifier(params, cfg, 6,
                                               device="cuda")),
                body, PRESET_REQUESTS),
            serving_launches(cfg, 1 + PRESET_REQUESTS))
    log(json.dumps({"timing": "/classify B = 1, one request in flight",
                    "requests": PRESET_REQUESTS, **out, "card": smi}))
    return out


def phase_preset_tiny(total: dict, tmp: str, smi: str) -> None:
    """17(a): vit_tiny_16_224, BASELINE config #1."""
    from arsvt_tpu_torch.data.folder import open_classification_split

    cfg = PRESETS["vit_tiny_16_224"]
    tree = os.path.join(tmp, "trashnet")
    write_trashnet(tree)
    val = open_classification_split(tree, "valid")
    run = os.path.join(tmp, "vit_tiny_eval")
    tcfg = TRAIN_PRESETS["vit_tiny_eval"]
    last, counts, secs = run_cli(
        run, ["--data-dir", tree], base=PRESET_CLI_ARGS,
        expect=classifier_launches(
            cfg.depth, tcfg.grad_accum, PRESET_CLI_STEPS,
            math.ceil(len(val) / tcfg.batch_size), False))
    add_counts(total, counts)
    ckpt_dir = os.path.join(run, "checkpoints")
    ckpts = sorted(os.listdir(ckpt_dir))
    log(json.dumps({"check": "train.cli vit_tiny_eval from a TrashNet tree",
                    "last_metrics": last, "seconds": secs,
                    "checkpoints": ckpts, "card": smi}))
    check(np.isfinite(last["loss"]), f"vit_tiny_eval CLI loss {last}")
    check(ckpts == [f"step_{PRESET_CLI_STEPS:09d}.pt"], f"checkpoints {ckpts}")
    log("# phase 17(a): evaluation.cli on its checkpoint")
    add_counts(total, eval_cli_vs_cpu(run, ckpt_dir, tree, val,
                                      "vit_tiny_eval", smi,
                                      step=PRESET_CLI_STEPS))
    seeded = params_only_checkpoint(
        ckpt_dir, os.path.join(tmp, "seeded", "checkpoints"),
        "classifier/head", seed=1)
    add_counts(total, eval_cli_vs_cpu(run, seeded, tree, val,
                                      "vit_tiny_eval_seeded_head", smi,
                                      step=PRESET_CLI_STEPS))
    log("# phase 17(a): StreamingClassifier, /classify, fp32 steps")
    preset_forwards(total, "vit_tiny_16_224", seed=40)
    preset_latency(total, smi)
    preset_steps(total, "vit_tiny_16_224")


def phase_preset_detector(total: dict) -> None:
    """17(d): detector_demo_96."""
    cfg = DETECTOR_PRESETS["detector_demo_96"]
    params = init_detector(cfg, seed=0)
    rng = np.random.default_rng(43)
    size = cfg.backbone.image_size
    images = [rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
              for _ in range(3)]
    per_forward = {"encoder_attention_fwd": cfg.backbone.depth,
                   "flash_attention_fwd": cfg.head.depth,
                   **norm_launches(cfg, forwards=1)}

    def serve():
        _, forwards, raw = phase_detector_parity("detector_demo_96", cfg,
                                                 params, images)
        phase_post_process(raw)
        return forwards

    held_path(total, "detector_demo_96 StreamingDetector", serve,
              lambda forwards: {k: v * forwards
                                for k, v in per_forward.items()})
    tcfg = TrainConfig(
        preset="detector_demo_96", task="detect", batch_size=4,
        image_size=size, canvas=size, augment="none", learning_rate=3e-4,
        weight_decay=1e-4, warmup_steps=1, total_steps=6000,
        schedule="cosine", bf16=False, aux_loss=True, w_triplet=0.0,
        grad_clip_norm=0.1, fused_adamw=True)
    steps, depth = 2, cfg.backbone.depth
    held_path(total, "detector_demo_96 fp32 steps",
              lambda: phase_det_train_parity(tcfg, size),
              {"encoder_attention_fwd": depth * steps,
               "encoder_attention_bwd":
                   depth * steps * encoder_attention.BWD_LAUNCHES_PER_CALL,
               "flash_attention_fwd": cfg.head.depth * steps,
               "flash_attention_bwd": cfg.head.depth * steps,
               "fused_adamw": steps, "lap": steps,
               **norm_launches(cfg, micro=steps, aux=tcfg.aux_loss)})


def phase_presets(smi: str) -> dict:
    """Phase 17. Returns the launches of every path it drives."""
    t0 = time.perf_counter()
    total = dict.fromkeys((name for name, _, _ in COUNTERS), 0)
    seconds = {}

    def part(key):
        seconds[key] = time.perf_counter() - t0 - sum(seconds.values())

    with tempfile.TemporaryDirectory() as tmp:
        log("# phase 17(a): vit_tiny_16_224 (vit_tiny_eval), BASELINE "
            "config #1")
        phase_preset_tiny(total, tmp, smi)
    part("a")
    log("# phase 17(b): vit_small_16_224")
    preset_forwards(total, "vit_small_16_224", seed=44)
    preset_steps(total, "vit_small_16_224")
    part("b")
    log("# phase 17(c): vit_demo_8_96")
    preset_forwards(total, "vit_demo_8_96", seed=45)
    preset_steps(total, "vit_demo_8_96", canvas=DEMO_CANVAS,
                 batches=demo_batches(8))
    part("c")
    log("# phase 17(d): detector_demo_96")
    phase_preset_detector(total)
    part("d")
    log(json.dumps({"phase": 17, "seconds": time.perf_counter() - t0,
                    "seconds_by_part": seconds,
                    "launches": {k: v for k, v in total.items() if v},
                    "card": smi}))
    return total


# --generalization: benchmarks/classification_generalization_demo.py's
# configuration on the port, unchanged (its lines 42-48 and 85-93): a
# vit_demo_8_96 classifier trained from init seed 0 with crop/flip (step
# seed 1) for GEN_STEPS steps of GEN_BATCH images drawn with replacement
# (numpy seed 2) from GEN_TRAIN_IMAGES `synthetic_shape_image`s on a
# GEN_CANVAS canvas (pool seed 0), then evaluate_classifier on
# GEN_VAL_IMAGES held-out ones (pool seed 10,000) and on the first
# GEN_VAL_IMAGES of the train pool. JAX's run reached val top-1 0.9995
# (classification_generalization.json); the port must reach
# GEN_MIN_VAL_TOP1.
GEN_PRESET = "vit_demo_8_96"
GEN_SIZE = 96
GEN_CANVAS = DEMO_CANVAS
GEN_BATCH = 256
GEN_STEPS = 4000
GEN_GRAD_ACCUM = 1
GEN_TRAIN_IMAGES = 16384
GEN_VAL_IMAGES = 2048
GEN_POOL_SEEDS = (0, 10_000)  # train, val
GEN_INIT_SEED = 0
GEN_STEP_SEED = 1
GEN_ORDER_SEED = 2
GEN_LOG_EVERY = 250
GEN_MIN_VAL_TOP1 = 0.98
# --generalization's parts, in the order a bare --generalization runs them,
# and the parts it runs only when named (the reference recipe: ~50 min)
GEN_PARTS = ("classification", "detection")
GEN_PARTS_NAMED = ("reference",)


def generalization_config() -> TrainConfig:
    return TrainConfig(
        preset=GEN_PRESET, num_classes=6, batch_size=GEN_BATCH,
        image_size=GEN_SIZE, canvas=GEN_CANVAS, augment="crop_flip",
        learning_rate=3e-4, weight_decay=0.05,
        warmup_steps=min(400, GEN_STEPS // 10), total_steps=GEN_STEPS,
        schedule="cosine", bf16=True, grad_accum=GEN_GRAD_ACCUM)


def generalization_pool(n: int, seed: int) -> tuple:
    """The demo's `make_pool`: n uint8 images on the canvas and labels."""
    from arsvt_tpu_torch.data.synthetic import synthetic_shape_image

    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 6, size=(n,)).astype(np.int32)
    images = np.empty((n, GEN_CANVAS, GEN_CANVAS, 3), np.uint8)
    for i, label in enumerate(labels):
        images[i] = (synthetic_shape_image(int(label), GEN_CANVAS, rng)
                     * 255).astype(np.uint8)
    return images, labels


def phase_generalization(smi: str) -> dict:
    """--generalization: train and evaluate as the JAX demo does; the pools
    live on the card and each step's rows are gathered there. Fails below
    GEN_MIN_VAL_TOP1."""
    from arsvt_tpu_torch.train.config import resolve_backbone

    t0 = time.perf_counter()
    (tr_images, tr_labels), (va_images, va_labels) = (
        generalization_pool(n, seed) for n, seed in zip(
            (GEN_TRAIN_IMAGES, GEN_VAL_IMAGES), GEN_POOL_SEEDS))
    pool_s = time.perf_counter() - t0
    cfg = generalization_config()
    init_fn, step, _ = make_classifier_step_fns(cfg)
    state = init_fn(GEN_INIT_SEED)
    images = torch.from_numpy(tr_images).cuda()
    labels = torch.from_numpy(tr_labels).cuda()
    order = np.random.default_rng(GEN_ORDER_SEED)
    bb = resolve_backbone(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    trace = []
    for t in range(GEN_STEPS):
        idx = torch.from_numpy(order.integers(0, GEN_TRAIN_IMAGES,
                                              GEN_BATCH)).cuda()
        state, m = step(state, {"image": images[idx], "label": labels[idx]},
                        step_seed=GEN_STEP_SEED)
        if t == 0 or (t + 1) % GEN_LOG_EVERY == 0:
            trace.append({"step": t + 1,
                          **{k: float(v) for k, v in m.items()}})
            log(json.dumps({"generalization": trace[-1]}))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = read_counts()
    want = {**dict.fromkeys(counts, 0), **classifier_launches(
        bb.depth, GEN_GRAD_ACCUM, GEN_STEPS, 0, False)}
    check(counts == want, f"generalization launches {counts} != {want}")
    peak = torch.cuda.max_memory_allocated() / 1e9

    def batches_of(x, y):
        for s in range(0, len(x), GEN_BATCH):
            yield {"image": x[s:s + GEN_BATCH], "label": y[s:s + GEN_BATCH]}

    val = evaluate_classifier(state["params"],
                              batches_of(va_images, va_labels), bb, 6,
                              normalize_inputs=True)
    train = evaluate_classifier(
        state["params"], batches_of(tr_images[:GEN_VAL_IMAGES],
                                    tr_labels[:GEN_VAL_IMAGES]),
        bb, 6, normalize_inputs=True)
    rec = {"generalization": "benchmarks/classification_generalization_"
                             "demo.py's configuration on the port",
           "config": {"preset": cfg.preset, "steps": GEN_STEPS,
                      "batch_size": GEN_BATCH, "grad_accum": GEN_GRAD_ACCUM,
                      "train_images": GEN_TRAIN_IMAGES,
                      "val_images": GEN_VAL_IMAGES, "augment": cfg.augment,
                      "canvas": GEN_CANVAS, "bf16": cfg.bf16},
           "val_top1": val["top1"],
           "val_per_class_accuracy": val["per_class_accuracy"],
           "val_confusion_matrix": val["confusion_matrix"],
           "train_split_top1": train["top1"],
           "final_train_metrics": trace[-1], "train_seconds": train_s,
           "ms_per_step": train_s / GEN_STEPS * 1e3,
           "peak_memory_gb": peak, "pool_seconds": pool_s,
           "launches": {k: v for k, v in counts.items() if v},
           "card": smi}
    log(json.dumps(rec))
    check(val["top1"] >= GEN_MIN_VAL_TOP1,
          f"val top-1 {val['top1']} < {GEN_MIN_VAL_TOP1}")
    return rec


# --generalization detection: benchmarks/detection_generalization_demo.py's
# configuration on the port, unchanged (its lines 46-50 and 101-115, with
# DEMO_AUG=detection, the value of JAX's two 6,000-step artifacts): a
# detector_demo_96 trained from init seed 0 with the detection augmentation
# through the default shear_matmul warp (step seed 1) for DET_GEN_STEPS
# steps of DET_GEN_BATCH images drawn with replacement (numpy seed 2, every
# step's rows drawn before the first step) from DET_GEN_TRAIN_IMAGES
# images of `make_synthetic_coco` (seed 0), then evaluate_detector at
# confidence and NMS 0.5 on DET_GEN_VAL_IMAGES held-out images (seed 1) and
# on the first DET_GEN_TRAIN_EVAL_IMAGES of the train split. JAX reached
# val mAP 0.5715 / AP50 0.942 (detection_generalization_shear.json) and
# 0.587 / 0.947 with its taps warp (detection_generalization_taps.json);
# the port must reach DET_GEN_MIN_MAP and DET_GEN_MIN_AP50 (its draws come
# from another generator than jax.random: another sample of the same
# training, and the two warps alone moved JAX's mAP by 0.016).
DET_GEN_PRESET = "detector_demo_96"
DET_GEN_CANVAS = 96
DET_GEN_BATCH = 64
DET_GEN_STEPS = 6000
DET_GEN_TRAIN_IMAGES = 4000
DET_GEN_VAL_IMAGES = 1024
DET_GEN_MAX_OBJECTS = 8
DET_GEN_COCO = {"image_size": 96, "max_boxes": 3}  # make_synthetic_coco's
DET_GEN_DATA_SEEDS = (0, 1)  # train, valid
DET_GEN_INIT_SEED = 0
DET_GEN_STEP_SEED = 1
DET_GEN_ORDER_SEED = 2
DET_GEN_TRAIN_EVAL_IMAGES = 128
DET_GEN_THRESHOLDS = {"conf_threshold": 0.5, "nms_threshold": 0.5}
DET_GEN_LOG_EVERY = 250
DET_GEN_MIN_MAP = 0.52
DET_GEN_MIN_AP50 = 0.90


def detection_generalization_config() -> TrainConfig:
    return TrainConfig(
        preset=DET_GEN_PRESET, task="detect", num_classes=6,
        batch_size=DET_GEN_BATCH, image_size=DET_GEN_CANVAS,
        canvas=DET_GEN_CANVAS, augment="detection", learning_rate=3e-4,
        weight_decay=1e-4, warmup_steps=min(500, DET_GEN_STEPS // 10),
        total_steps=DET_GEN_STEPS, schedule="cosine", bf16=True,
        max_objects=DET_GEN_MAX_OBJECTS, aux_loss=True, w_triplet=0.0,
        grad_clip_norm=0.1, warp_variant="")


def detection_generalization_split(root: str, split: str, n: int, seed: int,
                                   *, canvas: int = DET_GEN_CANVAS,
                                   max_objects: int = DET_GEN_MAX_OBJECTS,
                                   coco: dict = DET_GEN_COCO) -> tuple:
    """A demo's `make_synthetic_coco` and `load_split` for one split under
    `root`: (uint8 images on the canvas, {"boxes", "labels", "mask"}
    padded to `max_objects`), numpy. The defaults are the detection
    demo's."""
    from arsvt_tpu_torch.data.coco import CocoDataset
    from arsvt_tpu_torch.data.pipeline import load_letterboxed
    from arsvt_tpu_torch.data.synthetic import make_synthetic_coco

    make_synthetic_coco(root, splits=(split,), images_per_split=n,
                        seed=seed, **coco)
    ds = CocoDataset(os.path.join(root, split))
    images, _ = load_letterboxed([r.path for r in ds.records], canvas,
                                 records=ds.records, dtype=np.uint8)
    targets = [ds.padded_target(i, max_objects) for i in range(len(ds))]
    return images, {k: np.stack([t[k] for t in targets])
                    for k in ("boxes", "labels", "mask")}


def detection_generalization_order(n: int, steps: int = DET_GEN_STEPS,
                                   batch: int = DET_GEN_BATCH,
                                   seed: int = DET_GEN_ORDER_SEED
                                   ) -> np.ndarray:
    """Every step's `batch` row indices, (steps, batch) int64, drawn up
    front by the demo's own call, once a step, from its order rng. The
    defaults are the detection demo's."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n, batch) for _ in range(steps)])


def detection_generalization_launches(steps: int, eval_forwards: int) -> dict:
    """A detector_demo_96 demo step (one microbatch) and eval forward: #1
    and #2 once a backbone layer, #3 and #4 once a decoder layer, one #7
    launch a step (the port's update is the fused kernel whatever
    `fused_adamw` says), one lap launch a step and an eval forward (its
    loss matches the final layer), the LayerNorm and GELU kernels as
    `norm_launches` counts them with the aux layers; no dropout site."""
    cfg = DETECTOR_PRESETS[DET_GEN_PRESET]
    bb, head = cfg.backbone.depth, cfg.head.depth
    return {"encoder_attention_fwd": bb * (steps + eval_forwards),
            "encoder_attention_bwd":
                bb * steps * encoder_attention.BWD_LAUNCHES_PER_CALL,
            "flash_attention_fwd": head * (steps + eval_forwards),
            "flash_attention_bwd": head * steps,
            "fused_adamw": steps, "lap": steps + eval_forwards,
            **norm_launches(cfg, forwards=eval_forwards, micro=steps,
                            aux=True)}


def detection_pools(prefix: str, counts: tuple, seeds: tuple,
                    **split) -> tuple[dict, dict, float]:
    """A demo's train and valid splits (`detection_generalization_split`
    with `split`'s keywords) made in a temporary directory, then moved to
    the card: ({"image", "boxes", "labels", "mask"} for train, the same
    for valid, seconds)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=prefix) as tmp:
        pools = [detection_generalization_split(tmp, name, n, seed, **split)
                 for name, n, seed in zip(("train", "valid"), counts, seeds)]
    seconds = time.perf_counter() - t0
    train, val = ({k: torch.from_numpy(v).cuda()
                   for k, v in {"image": images, **targets}.items()}
                  for images, targets in pools)
    return train, val, seconds


def train_detection_demo(total: dict, path: str, tag: str, cfg: TrainConfig,
                         train: dict, order, *, init_seed: int,
                         step_seed: int, log_every: int, launches) -> tuple:
    """`make_detector_step_fns(cfg)` from init seed `init_seed`, one step a
    row of `order` (each step gathers its rows of the pools `train` on the
    card) with step seed `step_seed`; the first step's metrics and every
    `log_every`-th logged under `tag`; the launches held exactly to
    `launches(steps, 0)` (`held_path`, added to `total`). Returns (state,
    eval_step, loss trace, seconds, peak memory GB)."""
    init_fn, step, eval_step = make_detector_step_fns(cfg)
    state = init_fn(init_seed)
    trace = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def run():
        nonlocal state
        t0 = time.perf_counter()
        for t, idx in enumerate(order):
            state, m = step(state, {k: v[idx] for k, v in train.items()},
                            step_seed=step_seed)
            if t == 0 or (t + 1) % log_every == 0:
                trace.append({"step": t + 1,
                              **{k: float(v) for k, v in m.items()}})
                log(json.dumps({tag: trace[-1]}))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    seconds = held_path(total, f"{path} training", run,
                        launches(len(order), 0))
    return (state, eval_step, trace, seconds,
            torch.cuda.max_memory_allocated() / 1e9)


def evaluate_detection_demo(total: dict, path: str, eval_step, params,
                            pools, batch: int, launches,
                            **kw) -> tuple[list, int]:
    """`evaluate_detector` (keywords `kw`) over the first `limit` rows of
    each (pool, limit) of `pools`, in batches of `batch` gathered on the
    card; the launches held exactly to `launches(0, forwards)`. Returns
    (one result a pool, forwards)."""
    def batches_of(pool, limit):
        for s in range(0, limit, batch):
            yield {k: v[s:s + batch] for k, v in pool.items()}

    forwards = sum(math.ceil(limit / batch) for _, limit in pools)
    results = held_path(
        total, f"{path} evaluation",
        lambda: [evaluate_detector(eval_step, params,
                                   batches_of(pool, limit), **kw)
                 for pool, limit in pools],
        launches(0, forwards))
    return results, forwards


def phase_detection_generalization(smi: str) -> dict:
    """--generalization detection: train and evaluate as the JAX demo does;
    the uint8 pools and targets live on the card and each step gathers its
    rows there; the launches of the training and of the evaluation held
    exactly. Fails below DET_GEN_MIN_MAP or DET_GEN_MIN_AP50."""
    train, val, data_s = detection_pools(
        "arsvt_det_demo_", (DET_GEN_TRAIN_IMAGES, DET_GEN_VAL_IMAGES),
        DET_GEN_DATA_SEEDS)
    cfg = detection_generalization_config()
    order = torch.from_numpy(
        detection_generalization_order(len(train["image"]))).cuda()
    total = dict.fromkeys((name for name, _, _ in COUNTERS), 0)
    state, eval_step, trace, train_s, peak = train_detection_demo(
        total, "detection demo", "detection_generalization", cfg, train,
        order, init_seed=DET_GEN_INIT_SEED, step_seed=DET_GEN_STEP_SEED,
        log_every=DET_GEN_LOG_EVERY,
        launches=detection_generalization_launches)
    (result, train_split), forwards = evaluate_detection_demo(
        total, "detection demo", eval_step, state["params"],
        ((val, DET_GEN_VAL_IMAGES), (train, DET_GEN_TRAIN_EVAL_IMAGES)),
        DET_GEN_BATCH, detection_generalization_launches,
        num_classes=cfg.num_classes, **DET_GEN_THRESHOLDS)
    rec = {"detection_generalization": "benchmarks/detection_"
                                       "generalization_demo.py's "
                                       "configuration on the port",
           "config": {"preset": cfg.preset, "steps": len(order),
                      "batch_size": DET_GEN_BATCH,
                      "train_images": DET_GEN_TRAIN_IMAGES,
                      "val_images": DET_GEN_VAL_IMAGES,
                      "augment": cfg.augment, "aux_loss": cfg.aux_loss,
                      "warp_variant": augment.warp_variant(cfg),
                      "bf16": cfg.bf16, **DET_GEN_THRESHOLDS},
           "val": {k: v for k, v in result.items()
                   if k != "class_prediction_counts"},
           "train_split": {k: train_split[k]
                           for k in ("mAP", "AP50", "AP75")},
           "final_train_metrics": trace[-1], "loss_trace": trace,
           "train_seconds": train_s,
           "ms_per_step": train_s / len(order) * 1e3,
           "peak_memory_gb": peak, "data_seconds": data_s,
           "eval_forwards": forwards,
           "launches": {k: v for k, v in total.items() if v},
           "card": smi}
    log(json.dumps(rec))
    check(result["mAP"] >= DET_GEN_MIN_MAP and
          result["AP50"] >= DET_GEN_MIN_AP50,
          f"val mAP {result['mAP']} / AP50 {result['AP50']} below "
          f"{DET_GEN_MIN_MAP} / {DET_GEN_MIN_AP50}")
    return rec


# --generalization reference: benchmarks/recipe_ablation.py's row
# bs64_lr3e4 on the port, unchanged (the row at its lines 96-102, applied
# at 155-162; the data of its lines 141-146 through
# benchmarks/reference_recipe_demo.py's load_split, lines 60-71): the
# reference's own detector, TRAIN_PRESETS["deit_detector_ref"] (a DeiT-400
# backbone of 12 layers, 25 heads of 16 and distilled tokens; a 6-layer
# DETR decoder of 5 queries; dropout 0.1 at every residual site and in
# every layer's attention probabilities; triplet 0.6, aux loss, the
# detection augmentation on the 224 canvas), with the ablation's own
# overrides and the row's, trained from init seed 0 (step seed 1) for
# REF_GEN_STEPS steps of REF_GEN_BATCH images drawn with replacement
# (numpy seed 2, every step's rows drawn before the first step) from
# REF_GEN_TRAIN_IMAGES images of `make_synthetic_coco` (seed 0), then
# evaluate_detector at confidence and NMS 0.5 on REF_GEN_VAL_IMAGES
# held-out images (seed 1) and on the first REF_GEN_TRAIN_EVAL_IMAGES of
# the train split. The row's schedule is cosine, so the ablation's plateau
# controller never fires. JAX reached val mAP 0.1021 / AP50 0.2914 and a
# mean logged loss of 13.66 over steps 8,000-10,000 (recipe_ablation.json,
# benchmarks/logs/ablate_bs64_lr3e4.log); of the rows that did not learn,
# bs64 came highest: 0.0147 / 0.065 / 19.85. The port must reach
# REF_GEN_MIN_MAP (half JAX's, 3.4 times bs64's) and REF_GEN_MIN_AP50, and
# keep the mean of its logged losses over REF_GEN_LATE_STEPS at or below
# REF_GEN_MAX_LATE_LOSS: JAX ran once on 256 held-out images, and its
# draws come from another generator, so a tighter floor would hold the
# port to JAX's noise.
REF_GEN_ABLATION = "bs64_lr3e4"
REF_GEN_TRAIN_PRESET = "deit_detector_ref"
REF_GEN_STEPS = 10_000
REF_GEN_BATCH = 64
REF_GEN_TRAIN_IMAGES = 8000
REF_GEN_VAL_IMAGES = 256
REF_GEN_CANVAS = 224  # benchmarks/reference_recipe_demo.py's CANVAS
REF_GEN_MAX_OBJECTS = 25  # and its MAX_OBJECTS
REF_GEN_COCO = {"image_size": 224, "max_boxes": 3}  # make_synthetic_coco's
REF_GEN_DATA_SEEDS = (0, 1)  # train, valid
REF_GEN_INIT_SEED = 0
REF_GEN_STEP_SEED = 1
REF_GEN_ORDER_SEED = 2
REF_GEN_LOG_EVERY = 500
REF_GEN_TRAIN_EVAL_IMAGES = 256
REF_GEN_THRESHOLDS = {"conf_threshold": 0.5, "nms_threshold": 0.5}
# the ablation's overrides of every row, then the row's own
REF_GEN_OVERRIDES = {"total_steps": REF_GEN_STEPS, "eval_every": 10**9,
                     "checkpoint_every": 10**9,
                     "log_every": REF_GEN_LOG_EVERY,
                     "max_objects": REF_GEN_MAX_OBJECTS,
                     "batch_size": REF_GEN_BATCH, "learning_rate": 3e-4,
                     "schedule": "cosine"}
REF_GEN_MIN_MAP = 0.05
REF_GEN_MIN_AP50 = 0.15
REF_GEN_LATE_STEPS = (8000, 10_000)  # the logged steps whose mean is held
REF_GEN_MAX_LATE_LOSS = 17.0
# the JAX rows set beside the port's: the row itself, the two single
# deltas it combines and the faithful control
REF_GEN_JAX_ROWS = ("bs64_lr3e4", "bs64", "lr3e4_cosine", "faithful")


def reference_generalization_config() -> TrainConfig:
    return TRAIN_PRESETS[REF_GEN_TRAIN_PRESET].with_overrides(
        **REF_GEN_OVERRIDES)


def reference_generalization_launches(steps: int,
                                      eval_forwards: int) -> dict:
    """A deit_detector_ref step of the reference recipe (one microbatch)
    and an eval forward, as phase 9(c) counts its steps: #3 once a layer
    of the backbone (head_dim 16) and of the decoder, #4 once a layer a
    step, both on their dropout branch in every training launch and in no
    eval launch; one #7 launch a step; one lap launch a step and an eval
    forward; the apply kernel at the 49 dropout sites each way
    (`site_launches`); the LayerNorm and GELU kernels as `norm_launches`
    counts them with the aux layers."""
    cfg = reference_generalization_config()
    det = resolve_detector(cfg)
    layers = det.backbone.depth + det.head.depth
    return {"flash_attention_fwd": layers * (steps + eval_forwards),
            "flash_attention_bwd": layers * steps,
            "flash_attention_fwd_dropout": layers * steps,
            "flash_attention_bwd_dropout": layers * steps,
            "fused_adamw": steps, "lap": steps + eval_forwards,
            "dropout_apply": site_launches(det) * steps,
            **norm_launches(det, forwards=eval_forwards,
                            micro=steps * cfg.grad_accum,
                            aux=cfg.aux_loss)}


def late_loss_mean(trace) -> float:
    """The mean logged loss over REF_GEN_LATE_STEPS (NaN where none was
    logged there); `trace` holds {"step", "loss"} records."""
    lo, hi = REF_GEN_LATE_STEPS
    late = [r["loss"] for r in trace if lo <= r["step"] <= hi]
    return float(np.mean(late)) if late else float("nan")


def reference_generalization_jax() -> dict:
    """JAX's REF_GEN_JAX_ROWS, read from recipe_ablation.json and from
    each row's log, benchmarks/logs/ablate_<row>.log (the mean of its
    logged losses over REF_GEN_LATE_STEPS); read, never written."""
    import ast
    import re

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "recipe_ablation.json")) as f:
        rows = json.load(f)
    out = {}
    for row in REF_GEN_JAX_ROWS:
        line = re.compile(rf"\[{re.escape(row)}\] step (\d+): (\{{.*\}})$")
        trace = []
        with open(os.path.join(root, "benchmarks", "logs",
                               f"ablate_{row}.log")) as f:
            for m in filter(None, map(line.match, f.read().splitlines())):
                trace.append({"step": int(m.group(1)),
                              "loss": ast.literal_eval(m.group(2))["loss"]})
        out[row] = {**{k: rows[row][k] for k in (
                        "val_mAP", "val_AP50", "val_AP75", "train_mAP",
                        "train_AP50", "final_loss")},
                    "late_loss_mean": late_loss_mean(trace)}
    return out


def phase_reference_generalization(smi: str) -> dict:
    """--generalization reference: train and evaluate as the JAX ablation
    row does; the uint8 pools and targets live on the card and each step
    gathers its rows there; the launches of the training and of the
    evaluation held exactly. Fails below REF_GEN_MIN_MAP or
    REF_GEN_MIN_AP50, or above REF_GEN_MAX_LATE_LOSS."""
    train, val, data_s = detection_pools(
        "arsvt_ref_recipe_", (REF_GEN_TRAIN_IMAGES, REF_GEN_VAL_IMAGES),
        REF_GEN_DATA_SEEDS, canvas=REF_GEN_CANVAS,
        max_objects=REF_GEN_MAX_OBJECTS, coco=REF_GEN_COCO)
    cfg = reference_generalization_config()
    order = torch.from_numpy(detection_generalization_order(
        len(train["image"]), REF_GEN_STEPS, REF_GEN_BATCH,
        REF_GEN_ORDER_SEED)).cuda()
    total = dict.fromkeys((name for name, _, _ in COUNTERS), 0)
    state, eval_step, trace, train_s, peak = train_detection_demo(
        total, "reference recipe", "reference_generalization", cfg, train,
        order, init_seed=REF_GEN_INIT_SEED, step_seed=REF_GEN_STEP_SEED,
        log_every=REF_GEN_LOG_EVERY,
        launches=reference_generalization_launches)
    (result, train_split), forwards = evaluate_detection_demo(
        total, "reference recipe", eval_step, state["params"],
        ((val, REF_GEN_VAL_IMAGES), (train, REF_GEN_TRAIN_EVAL_IMAGES)),
        REF_GEN_BATCH, reference_generalization_launches,
        num_classes=cfg.num_classes, **REF_GEN_THRESHOLDS)
    late = late_loss_mean(trace)
    rec = {"reference_generalization": "benchmarks/recipe_ablation.py's "
                                       f"row {REF_GEN_ABLATION} on the port",
           "config": {"train_preset": REF_GEN_TRAIN_PRESET,
                      "steps": len(order),
                      "train_images": REF_GEN_TRAIN_IMAGES,
                      "val_images": REF_GEN_VAL_IMAGES,
                      "warp_variant": augment.warp_variant(cfg),
                      **{k: getattr(cfg, k) for k in (
                          "batch_size", "learning_rate", "schedule",
                          "warmup_steps", "total_steps", "weight_decay",
                          "grad_clip_norm", "augment", "canvas",
                          "attn_dropout", "w_triplet", "aux_loss",
                          "max_objects", "bf16")},
                      **REF_GEN_THRESHOLDS},
           "val": {k: v for k, v in result.items()
                   if k != "class_prediction_counts"},
           "train_split": {k: train_split[k]
                           for k in ("mAP", "AP50", "AP75")},
           "late_loss_mean": late, "final_train_metrics": trace[-1],
           "loss_trace": trace, "train_seconds": train_s,
           "ms_per_step": train_s / len(order) * 1e3,
           "peak_memory_gb": peak, "data_seconds": data_s,
           "eval_forwards": forwards,
           "launches": {k: v for k, v in total.items() if v},
           "jax": reference_generalization_jax(), "card": smi}
    log(json.dumps(rec))
    check(result["mAP"] >= REF_GEN_MIN_MAP
          and result["AP50"] >= REF_GEN_MIN_AP50
          and late <= REF_GEN_MAX_LATE_LOSS,
          f"val mAP {result['mAP']} / AP50 {result['AP50']} / mean loss "
          f"over steps {REF_GEN_LATE_STEPS} {late}: below {REF_GEN_MIN_MAP}"
          f" / {REF_GEN_MIN_AP50} or above {REF_GEN_MAX_LATE_LOSS}")
    return rec


def is_bf16_kernel(entry: str) -> bool:
    """A bf16 kernel by its mangled name: T = __nv_bfloat16 opens the
    template arguments (fp32 instantiations may take bf16 pointers, never
    it), or the kernel is bf16 by its own name (the fused MLP's wgmma
    kernels, ``mlpg::gemm_bf16_kernel<launch>``, take no type argument)."""
    return "I13__nv_bfloat16" in entry or "bf16_kernel" in entry


def ptxas_report(built: dict) -> list[dict]:
    """Registers and spill bytes of every kernel in the libraries built now,
    from the compiler's ``-Xptxas=-v`` report."""
    rows = []
    for name, info in built.items():
        entry = None
        for line in info["log"].splitlines():
            if "Compiling entry function" in line:
                entry = {"library": name, "entry": line.split("'")[1]}
            elif entry is not None and "spill stores" in line:
                words = line.replace(",", "").split()
                entry["stack_frame"] = int(words[0])
                entry["spill_stores"] = int(words[words.index("spill") - 2])
                entry["spill_loads"] = int(words[-4])
            elif entry is not None and "Used" in line and "registers" in line:
                words = line.replace(",", "").split()
                entry["registers"] = int(words[words.index("Used") + 1])
                rows.append(entry)
                entry = None
    return rows


def mma_per_kernel(name: str) -> dict:
    """{kernel: {"hmma": n, "hgmma": n}} in library `name`'s SASS
    (cuobjdump, beside nvcc in the toolkit): warp-level mma.sync
    instructions and warpgroup wgmma ones."""
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        counts[part.split()[0]] = {"hmma": part.count("HMMA"),
                                   "hgmma": part.count("HGMMA")}
    return counts


def phase_build_report(built: dict) -> None:
    """No spills and no stack frame (local memory) in the bf16 kernels of
    the tensor-core libraries (the fp32 ones are reported); HMMA in every
    bf16 kernel of the attention libraries, HGMMA in every bf16 kernel of
    the fused MLP's."""
    for row in ptxas_report(built):
        if row["library"] in TENSOR_CORE_LIBRARIES + (
                "fused_adamw", "dropout_mask", "lap", "layernorm",
                "gelu_tanh"):
            log(json.dumps({"ptxas": row}))
            check(not is_bf16_kernel(row["entry"]) or (
                row["spill_stores"] == 0 and row["spill_loads"] == 0
                and row["stack_frame"] == 0),
                f"{row['entry']} uses local memory: {row}")
    for name in TENSOR_CORE_LIBRARIES:
        counts = mma_per_kernel(name)
        unit = "hgmma" if name in MLP_LIBRARIES else "hmma"
        bf16 = {k: v[unit] for k, v in counts.items() if is_bf16_kernel(k)}
        log(json.dumps({"sass": name, "mma": counts}))
        check(bf16 and all(v > 0 for v in bf16.values()),
              f"a bf16 kernel of {name} has no {unit.upper()}: {counts}")


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
    for k in OPT_IN_ENV:  # the default route, but where phase 10 sets them
        os.environ.pop(k, None)
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
    phase_build_report(built)
    cfg = PRESETS["vit_base_16_224"]
    params = load_params()
    if "--vit-large" in sys.argv[1:]:
        log("# --vit-large: phase 14 alone")
        phase_vit_large(smi)
        return 0
    if "--distill" in sys.argv[1:]:
        log("# --distill: phase 15 alone")
        phase_distill(smi)
        return 0
    if "--ab" in sys.argv[1:]:
        log("# --ab: the LayerNorm and GELU paths of a parent tree and of "
            "this one")
        phase_tree_ab(sys.argv[sys.argv.index("--ab") + 1], smi)
        return 0
    if "--detector-ab" in sys.argv[1:]:
        log("# --detector-ab: phase 9(c) of a parent tree and of this one")
        phase_detector_ab(sys.argv[sys.argv.index("--detector-ab") + 1],
                          smi)
        return 0
    if "--generalization" in sys.argv[1:]:
        parts = GEN_PARTS
        after = sys.argv[sys.argv.index("--generalization") + 1:][:1]
        if after and after[0] in GEN_PARTS + GEN_PARTS_NAMED:
            parts = tuple(after)
        if "classification" in parts:
            log("# --generalization classification: benchmarks/"
                "classification_generalization_demo.py's configuration")
            phase_generalization(smi)
        if "detection" in parts:
            log("# --generalization detection: benchmarks/"
                "detection_generalization_demo.py's configuration")
            phase_detection_generalization(smi)
        if "reference" in parts:
            log("# --generalization reference: benchmarks/"
                "recipe_ablation.py's row bs64_lr3e4")
            phase_reference_generalization(smi)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--serving-load" in sys.argv[1:]:
        log("# --serving-load: benchmarks/serving_load.py's configuration")
        t0 = time.perf_counter()
        phase_serving_load(params, smi, LOAD_RUNS, LOAD_DURATION_S)
        log(json.dumps({"serving_load_s": time.perf_counter() - t0}))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--presets" in sys.argv[1:]:
        log("# --presets: the presets' attention timing and phase 17 alone")
        phase_preset_attention_timing(smi)
        log("# phase 17: the presets the card had not run")
        phase_presets(smi)
        return 0
    if "--parallel" in sys.argv[1:]:
        log("# --parallel: phase 16 alone")
        phase_parallel(smi)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if {"--disk", "--int8"} & set(sys.argv[1:]):
        log("# --disk / --int8: phase 12 (and 13) alone")
        with tempfile.TemporaryDirectory() as tmp:
            _, seeded = phase_disk(smi, tmp)
            if "--int8" in sys.argv[1:]:
                phase_int8_export(cfg, params, seeded, smi, tmp)
        return 0

    log("# phase 3: kernels against their plain versions")
    flash = phase_flash_checks()
    flash_bwd = phase_flash_train_checks()
    attn = phase_kernel_checks(cfg)
    attn_bwd = phase_bwd_checks(cfg)
    adamw = phase_adamw_checks(cfg)
    savep_fwd, savep_bwd = phase_savep_checks(cfg)
    dropout = phase_encoder_dropout_checks(cfg)
    mlp_fwd, mlp_bwd = phase_mlp_checks()
    log("# phase 3(a): the dropout apply kernel against its plain version")
    apply_err = phase_apply_kernel_checks()
    log("# phase 3(b): the dropout site timed at the detector's residual "
        "view")
    applied = phase_apply_kernel_timing(smi, apply_err)
    log("# phase 3: the matcher's kernel, its solve-only and fused entries")
    lap = phase_match_checks(smi)
    log("# phase 3(c): the LayerNorm and GELU kernels against their plain "
        "versions")
    ln_rec, gelu_rec = phase_norm_kernel_timing(smi,
                                                phase_norm_kernel_checks())
    log("# phase 3(d): #1 and #2 timed at vit_tiny_16_224's shapes")
    phase_preset_attention_timing(smi)
    if "--kernels" in sys.argv[1:]:
        log("# --kernels: stopping after phase 3")
        return 0

    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)
              for _ in range(4)]
    batch = rng.integers(0, 256, (8, 224, 224, 3), dtype=np.uint8)
    bodies = [png_bytes(rng.integers(0, 256, shape, dtype=np.uint8))
              for shape in ((224, 224, 3), (180, 240, 3), (300, 200, 3),
                            (224, 224, 3))]

    # the bf16 GELU forward's table route and the table's fills over phases
    # 4-17, in this process (both outside the exact launch tables: which
    # route a forward takes depends on its size, not on the path); the
    # table phase 3(c) filled is dropped, so the main path fills its own
    gelu_table_before = (mlp_ops.TABLE_ROUTE_LAUNCHES, mlp_ops.TABLE_LAUNCHES)
    mlp_ops._tables.clear()
    zero_counts()  # the serving path starts here
    log("# phase 4: ViT-B/16@224 StreamingClassifier")
    direct, forwards = phase_model(cfg, params, images, batch)
    log("# phase 5: InferenceServer")
    forwards += phase_server(cfg, params, direct, bodies)
    serving = read_counts()
    launches = serving["encoder_attention_fwd"]
    log(json.dumps({"launches": serving, "forwards": forwards,
                    "depth": cfg.depth}))
    check(launches > 0, "encoder_attention_fwd never launched")
    check(launches == cfg.depth * forwards,
          f"LAUNCHES {launches} != depth {cfg.depth} x {forwards} forwards")
    # and a LayerNorm kernel a LayerNorm, a GELU kernel a GELU
    expected = {**dict.fromkeys(serving, 0), "encoder_attention_fwd":
                launches, **norm_launches(cfg, forwards=forwards)}
    check(serving == expected,
          f"classify serving launches {serving} != {expected}")
    log("# phase 5(c): the micro-batched server under load, "
        f"{LOAD_SMOKE_S:g} s")
    t0 = time.perf_counter()
    load = phase_serving_load(params, smi, LOAD_RUNS[:1], LOAD_SMOKE_S)
    log(json.dumps({"phase_5c_s": time.perf_counter() - t0}))
    log("# phase 6: profile of the bf16 forward")
    phase_profile(direct, batch)

    log("# phase 7: ViT-B/16@224 training")
    phase_train_parity(cfg)
    default_bf16 = phase_train_bf16(cfg)
    bench, train, state, step, train_batch = phase_train_bench(cfg, smi)
    phase_train_profile(state, step, train_batch, bench["ms_per_step"])
    del state, step, train_batch

    log("# phase 8: detector serving")
    detect = phase_detector(smi)

    log("# phase 9: detector training")
    det_train = phase_detector_training(smi)

    log("# phase 10: ViT-B/16@224 training on the opt-in route")
    opt_in = phase_opt_in_training(cfg, smi, default_bf16)

    log("# phase 11: the training entry point with attention dropout")
    entry = phase_entry_point(cfg, smi)

    with tempfile.TemporaryDirectory() as tmp:
        log("# phase 12: from images on disk to a served checkpoint")
        disk, seeded = phase_disk(smi, tmp)
        log("# phase 13: int8 serving and export artifacts")
        int8 = phase_int8_export(cfg, params, seeded, smi, tmp)

    log("# phase 14: the ViT-L/16@384 recipe")
    recipe = phase_vit_large(smi)

    log("# phase 15: DeiT distillation from an imported teacher")
    distill = phase_distill(smi)

    log("# phase 16: data- and tensor-parallel training")
    parallel = phase_parallel(smi)

    log("# phase 17: the presets the card had not run")
    presets = phase_presets(smi)

    def row(name, source, replaces, rec, launched):
        return {"name": name, "route": "cuda",
                "source": f"arsvt_tpu_torch/csrc/{source}",
                "replaces": f"arsvt_tpu/ops/pallas/{replaces}",
                "launches": launched, "max_abs_err": rec["max_abs_err"],
                "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"]}

    def paths(name):  # launches of every path's run, phases 4-17
        return (train[name] + detect.get(name, 0) + det_train[name]
                + opt_in[name] + entry[name] + disk[name] + int8[name]
                + recipe[name] + distill[name] + parallel.get(name, 0)
                + presets[name] + serving[name] + load[name])

    # every LayerNorm and unfused GELU of phases 4-17 ran its kernels
    check(all(paths(name) > 0 for name in NORM_NAMES),
          f"LayerNorm and GELU launches over phases 4-17: "
          f"{ {name: paths(name) for name in NORM_NAMES} }")
    gelu_table = {"launches_table_route": mlp_ops.TABLE_ROUTE_LAUNCHES
                  - gelu_table_before[0],
                  "table_fills": mlp_ops.TABLE_LAUNCHES
                  - gelu_table_before[1]}
    check(0 < gelu_table["launches_table_route"] <= paths("gelu_tanh_fwd")
          and gelu_table["table_fills"] == 1,
          f"the bf16 GELU forward's table route over phases 4-17: "
          f"{gelu_table} of {paths('gelu_tanh_fwd')} forward launches")
    # every dropout site of phases 4-17 went through the apply kernel, every
    # matching through the fused entry
    check(paths("dropout_apply") > 0,
          f"dropout sites: {paths('dropout_apply')} apply launches over "
          f"phases 4-17")
    check(paths("lap") > 0 and paths("lap_solve") == 0,
          f"matching: {paths('lap')} fused and {paths('lap_solve')} "
          f"solve-only launches over phases 4-17")
    sources = {"encoder_attention_fwd": ("encoder_attention_fwd.cu",
                                         "flash_attention.py:533"),
               "encoder_attention_bwd": ("encoder_attention_bwd.cu",
                                         "flash_attention.py:629"),
               "encoder_attention_fwd_savep": (
                   "encoder_attention_savep_fwd.cu", "flash_attention.py:739"),
               "encoder_attention_bwd_savep": (
                   "encoder_attention_savep_bwd.cu", "flash_attention.py:811")}
    print(json.dumps({"kernels": [
        # #1: classify serving, training, the ViT-B detector, eval
        row("encoder_attention_fwd", *sources["encoder_attention_fwd"], attn,
            paths("encoder_attention_fwd")),
        row("encoder_attention_bwd", *sources["encoder_attention_bwd"],
            attn_bwd, paths("encoder_attention_bwd")),
        row("fused_adamw", "fused_adamw.cu", "fused_adamw.py:40", adamw,
            paths("fused_adamw")),
        # detector serving and training
        row("flash_attention_fwd", "flash_attention_fwd.cu",
            "flash_attention.py:93", flash, paths("flash_attention_fwd")),
        row("flash_attention_bwd", "flash_attention_bwd.cu",
            "flash_attention.py:172", flash_bwd,
            paths("flash_attention_bwd")),
        # the opt-in training path
        row("encoder_attention_fwd_savep",
            *sources["encoder_attention_fwd_savep"], savep_fwd,
            paths("encoder_attention_fwd_savep")),
        row("encoder_attention_bwd_savep",
            *sources["encoder_attention_bwd_savep"], savep_bwd,
            paths("encoder_attention_bwd_savep")),
        row("fused_mlp_fwd", "fused_mlp_fwd.cu", "fused_mlp.py:63",
            mlp_fwd, paths("fused_mlp_fwd")),
        row("fused_mlp_bwd", "fused_mlp_bwd.cu", "fused_mlp.py:135",
            mlp_bwd, paths("fused_mlp_bwd")),
    ] + [
        # the dropout branches (phase 3 at dropout 0.1; launches: those
        # that ran the branch, counted by the wrappers over every path)
        row(f"{name} (dropout 0.1)", *sources[name], dropout[name],
            paths(f"{name}_dropout")) for name in ENC_DROPOUT_NAMES
    ] + [
        # the port-only kernel of the residual, positional and reference-
        # attention sites: the apply kernel, one launch a site each way
        # (it replaces JAX's dropout, jax.random.bernoulli and a where that
        # XLA fuses, not a Pallas kernel); "ms" held on the device, beside
        # the host-paced time
        {**row("dropout_apply", "dropout_mask.cu", "", applied,
               paths("dropout_apply")),
         "replaces": "arsvt_tpu/models/vit.py:140 (dropout: "
                     "jax.random.bernoulli and where; no Pallas kernel)",
         "host_paced_ms": applied["host_paced_ms"],
         "int_bound_ms": applied["int_bound_ms"],
         "bytes_bound_ms": applied["bytes_bound_ms"]},
        # the port-only matcher kernel: its fused entry (the row's numbers,
        # held on the device, at the deit_detector_ref step's (6, 32, 5,
        # 25); launches the fused entry's over phases 4-17) and its
        # solve-only entry ("solve_only", timed on that step's padded
        # costs; 0 launches there). It replaces JAX's match and lap_rect,
        # plain JAX that XLA compiles, not a Pallas kernel; no PyTorch
        # call solves an assignment, so scipy's host time stands beside it
        {**row("lap", "lap.cu", "", lap, paths("lap")),
         "replaces": "arsvt_tpu/objectives/matcher.py:173 (match and "
                     "lap_rect at :41, plain JAX under jit; no Pallas "
                     "kernel)",
         "host_paced_ms": lap["host_paced_ms"], "host_us": lap["host_us"],
         "parent_route_ms": lap["parent_route_ms"],
         "floor_ms": lap["floor_ms"],
         "solve_only": {k: lap["solve_only"][k] for k in (
             "device_ms", "ms", "host_us", "plain_ms", "bound_ms",
             "scipy_host_ms")},
         "launches_solve_only": paths("lap_solve")},
    ] + [
        # the port-only LayerNorm and GELU kernels (JAX's are jit code that
        # XLA fuses, not Pallas kernels): "ms" and the rest are the
        # forward's at ViT-B's training shape, held on the device;
        # "backward" the same for the backward's launches; "launches" the
        # forwards', "launches_bwd" the backwards' over phases 4-17
        {**row(name, source, "", rec, paths(f"{name}_fwd")),
         "replaces": replaces, "launches_bwd": paths(f"{name}_bwd"),
         "host_paced_ms": rec["host_paced_ms"],
         "backward": rec["backward"], "shapes": rec["shapes"],
         **({"routes": rec["routes"], **gelu_table}
            if name == "gelu_tanh" else {})}
        for name, source, rec, replaces in (
            ("layer_norm", "layernorm.cu", ln_rec,
             "arsvt_tpu/ops/layernorm.py:22 (_ln_fwd_math and its custom "
             "VJP, jit code that XLA fuses; no Pallas kernel)"),
            ("gelu_tanh", "gelu_tanh.cu", gelu_rec,
             "arsvt_tpu/ops/mlp.py:21 (gelu_tanh and its custom VJP, jit "
             "code that XLA fuses; no Pallas kernel)"))
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
