"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1–K9) from ``nsof_tpu_torch/csrc``, holds
each, and the float32 forms of K3 and K4, against its plain PyTorch version
on the card (K8, the stream's device scan, at ``K8_CASES``; K9, the YOLO
post step's NMS, at ``K9_CASES``), then drives three paths of
``seg_batch_fast``:

- the main path on bench.py's 640×480 workload (256×384 window, grasp
  preset, memsize 80, warp radius 3) at B = 256, the fused route (K1–K4);
- the same at ``kernel_mode='fused_f32'`` (K1, K2, K3/K4 in float32);
- the autodriving preset (801×801 frames and window, memsize 200, poly_n
  10, warp radius 3) at B = 128 in ``kernel_mode`` 'auto' (the pallas_sep
  route: K1, K5, K6) and 'pallas' (K1, K7, K6).

Each path's launch counts are zeroed just before it and read just after;
it must go through exactly its kernels, make no host synchronisation and
agree with the plain route, and it is timed.  Then, on the same 640×480
grasp workload:

- ``tracking_batch_fast`` at B = 64 (``'fused'``: K1–K4, K9 for the
  head's NMS), its boxes equal
  to the plain route's, at most 32 host synchronisations (the labelling's
  convergence checks);
- ``prediction_batch_fast`` at B = 64 with a BGR next frame, its
  prediction equal to the plain route's bit for bit, no host
  synchronisation, and its SSIM against the true next-but-one frame;
- the dual path: the exact per-stage programs of the segmentation,
  tracking and prediction pipelines (``seg_stages``, ``tracking_stages``,
  ``prediction_stages``) on one frame pair as the reference's runner calls
  them, each stage timed, and the ROI path's speed-up over the full frame;
  the exact path launches no kernel.

Then the device simulation, on scripts/bench_stream.py's workload (480×640
frames, a 96×96 block moving (2, 3) px a frame over a static texture, 129
frames a call, a 6×8 device grid, n_substeps 1000, the grasp path):

- ``stream_masks`` in 'auto' (K8 once, K1–K4), every output equal to the
  plain route's (K8 on its plain loop too), no host synchronisation, timed
  (ms per call, pairs per second) and traced; ``stream_masks_chunked`` at
  64 pairs a chunk, equal to the one-shot call, timed;
- ``stream_masks_from_events``: synthetic events of a box crossing the 6×8
  grid, binned by the native binner, integrated by the event simulator,
  gating the grasp path; its launches and host synchronisations;
- the FLAG=1 stages: :func:`drive_dual` on grasp_sep at 640×480 with two
  components whose regions overlap.

Then the entry points a user calls, at 640×480 and 480×640:

- ``engine``: ``BatchingEngine`` (max_batch 128, default buckets,
  warmed up) serving 512 requests of the main path's workload from 16
  threads, each result equal bit for bit to the direct ``seg_batch_fast``
  of the padded batch it went in, K1–K4 launched as the main path's a
  dispatch; requests per second, p50/p99 latency, the host syncs of a
  dispatch, the device-resident B = 128 batch and the parts of one
  dispatch (stacking into pinned memory, upload, device, download);
- ``serve``: the demo server on a free port; ``/api/flow`` on 480×640 PNG
  pairs of the stream's moving block (K8 once and K1–K4 a request) equal
  to the direct ``stream_masks`` and ``seg_step``, ``/api/segment``, a
  JPEG payload refused with 400; ms per request;
- ``runner``: ``run_segmentation``, ``run_tracking``, ``run_prediction``
  on a 9-frame ``SceneData`` gated by the stream's state maps, their CSVs
  in the reference schemas, their results equal to the stages called
  directly, no kernel launched;
- ``cli``: ``python -m nsof_tpu_torch.cli stream`` and ``flow`` in
  processes of their own on a folder of PNG frames, their outputs equal
  to ``stream_masks_chunked`` and the exact Farnebäck's flow image; then
  ``eventsim --synthetic --no-video`` (simulated in memory where h5py is not
  installed) and ``visualize`` on the npz it writes, one keyframe every
  EVENT_KEY_EVERY frames in its ``manifest.json``.

Then the deep backends, on scripts/bench_deep.py's workload A (480×640
RGB frames at 1/3 scale, a 256×384 window, grasp at memsize 80, 26 on the
deep grid; seeded random weights).  Each flow that is timed or served
runs at PyTorch's defaults, where cuDNN's convolutions may take TF32 on
Hopper; it is held against the CPU port within DEEP_TF32_TOL.  The same
flow with TF32 off is held within DEEP_FLOW_TOL:

- ``deep_raft``: RAFT-basic at the raft-things widths, 20 iterations:
  ``deep_roi_flow_step`` (K1 twice, on RGB windows, equal to the plain
  route; no host synchronisation in the model or the step; its flow within
  DEEP_FLOW_TOL (TF32 off) and DEEP_TF32_TOL (the defaults) of the same
  weights on the CPU) and ``deep_full_flow_step``,
  each timed, the ROI speed-up, FLOPs a pair, a trace;
- ``deep_alt``: the same weights with ``corr_mode='alternate'``, within
  DEEP_ALT_TOL of all-pairs;
- ``deep_batch``: ``deep_roi_flow_batch`` at B = 8 on RAFT-small and
  RAFT-basic against the per-sample steps (TF32 off), the batch at the
  defaults within DEEP_TF32_TOL of the batch with TF32 off, timed; then
  ``BatchingEngine.for_deep_backend`` (RAFT-small) serving 64 requests from
  8 threads, each result equal to its batch's direct ``deep_roi_flow_batch``;
- ``deep_flowformer``: FlowFormer at things_eval's widths, one ROI and one
  full pair timed, its flow on a cut window within DEEP_FLOW_TOL (TF32
  off) and DEEP_TF32_TOL (the defaults) of the CPU.

Then the training slice (no kernel: its launch counts must stay 0), each
phase's seconds printed:

- ``train_parity``: one train step of RAFT-small and RAFT-basic at the CPU
  tests' size (64×96, B = 2, 2 iterations) from the same seeded weights and
  batch on the card (cuDNN TF32 off) and on the CPU port: loss within
  1e-5, gradients and updated parameters to the CPU tests' bounds; then the
  forward and backward at PyTorch's defaults (TF32 convolutions) beside the
  TF32-off one: loss and gradient gaps within the TRAIN_TF32_* bounds;
- ``train_raft``: RAFT-basic at the chairs stage of RAFT_STANDARD_STAGES
  uncut (batch 10, 368×496 crops, 12 iterations) on synthetic pairs at
  FlyingChairs' 384×512 through the chairs augmentor, at PyTorch's
  defaults: ``run_stage`` for the warm-up step and its checkpoint (restored
  equal), then TRAIN_STEPS timed steps as ``train_loop`` runs them; the
  step and data seconds, losses (finite), host syncs (0 in the step, 1
  read), launches, busy and idle share (a trace), TFLOP and peak memory;
- ``train_remat``: that step's gradients with ``remat=True`` against
  without, and both peak memories;
- ``train_flowformer``: one ff_chairs step with the twins group, the
  decoder depth cut to TRAIN_FF_DEPTH and the batch to TRAIN_FF_B: the
  groups' rates at steps 0 and 1 against the schedule, the loss finite;
- ``train_cli``: ``python -m nsof_tpu_torch train --stage chairs --small
  --steps 2`` on a FlyingChairs layout (``.ppm`` frames, ``.flo`` flows),
  then, side by side, ``deep --ckpt`` on its checkpoint over a PNG scene
  and ``validate --dataset chairs`` with it, each exit 0.

Then the detection slice (``detect``): K9 against its plain loop at
``K9_CASES``; YOLOv8n at the JAX detector's defaults (80 classes, imgsz 640,
conf 0.25, iou 0.45, max_det 300) on seeded synthetic weights (the head
scaled so that the image ranks the scores), its raw outputs on a
letterboxed 640×480 frame against the CPU port's (TF32 off and at the
defaults), ``postprocess`` of them with K9 (one launch) equal to the plain
``nms``'s and to the CPU port's on the same decoded outputs, and the
card's detections (TF32 off) against the CPU port's; a detector call's parts (letterbox, upload, forward,
decode and sort, K9, download and mapping) on the frame and on a ROI crop,
its launches and host syncs, GFLOP; ``run_detection`` on the runner's scene
with ``TorchYoloDetector`` (K9 once a detector call, counted from zero
just before the run) and ``ThresholdBlobDetector``: the YOLO time columns,
the CSV's 10 YOLO columns, every region detection inside its region box;
then YOLOv8 s, m, l and x, one forward each at 640².

Then the ground-truth tooling (no kernel: the counts stay 0), on the runner
scene's 480×640 RGB frame and seeded synthetic weights (no published
weights are in the repo):

- ``gt_sam``: SAM vit_b at full width (1024², 12 blocks) behind
  ``SamPredictor``: ``set_image`` and ``predict`` with 1 and 4 boxes, each
  one's CUDA-event median, launches, host syncs, GFLOP and peak memory;
  ``gt_sam_parity``: the card against the CPU port at vit_b's widths with
  the depth cut to GT_SAM_CUT_DEPTH, TF32 off and at the defaults, within
  GT_SAM_F32_REL and GT_SAM_TF32_REL; ``gt_sam_encoder``: vit_l and vit_h,
  one encoder forward each at 1024², depth uncut;
- ``gt_owlvit``: OWL-ViT at base-patch32's widths, its input and its
  forward with 1 and 4 text queries (a deterministic toy tokenizer), a
  proposer call; ``gt_owlvit_parity``: the card against the CPU port at
  TINY_OWLVIT and base-patch32, within GT_OWL_F32_REL and GT_OWL_TF32_REL;
- ``gt_chain``: the OWL-ViT → SAM chain through ``generate_gt_masks`` over
  GT_CHAIN_FRAMES PNG frames (ms a frame, instances a frame), then
  ``/api/segment`` with the chain injected, ``box_threshold`` unset and set.

Then the parallel slice (``parallel``), at world size 1 over NCCL (the
card's machine has one GPU; collectives across GPUs are not exercised): a
('data', 'model') mesh from ``make_mesh(1)``;
``make_sharded_seg_batch`` at the main path's workload (B = 256,
``'fused'``), K1–K4 launched as the unsharded path launches them (counts
zeroed just before, read just after), its outputs bit for bit
``seg_batch_fast``'s, both timed; the dp×tp RAFT-basic step at the chairs
stage uncut on the 1×1 mesh against the one-device step (loss and updated
parameters, cuDNN TF32 off), seconds a step for both; ``make_spatial_flow``
on one 'space' rank at 480×640 (grasp) against ``farneback`` in the
interior band; ``make_raft_pp_flow`` on one stage at the deep window
against the test-mode forward (TF32 off and at the defaults); then
``torchrun --nproc-per-node 1 -m nsof_tpu_torch train --mesh 1x1`` (RAFT-small,
one chairs step), its checkpoint restored on one device.

Last, each kernel is timed at its path's level-0 shapes beside its bound
and its plain version (K7 also at radius 8; K8 at the stream's shapes,
its plain loop at K8_PLAIN_SUBSTEPS, with its chain bound and the bound of
the substeps its longest cell ran; K1 also at the deep batch's RGB shapes;
K9 at the YOLO post step's first launch in ``run_detection``, with its
chain bound, its walk's reckoning and ``torchvision.ops.nms`` where
that imports).

Each phase prints one JSON line.  The line before the last is the card's
name and power limit as ``nvidia-smi`` reports them, the one before that
the ``kernels`` summary, and the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises, so the exit code is nonzero.  Without a CUDA device the
script exits with code 1 before printing any result.
"""

from __future__ import annotations

import base64
import collections
import contextlib
import copy
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import warnings

import numpy as np
import torch

from nsof_tpu_torch import _build
from nsof_tpu_torch.config import DATASETS
from nsof_tpu_torch.data.scenes import SceneData
from nsof_tpu_torch.device import frame_sim as tfs
from nsof_tpu_torch.device.model import DEFAULT_PARAMS
from nsof_tpu_torch.device.synthetic import generate_synthetic_events
from nsof_tpu_torch.data import gt_tooling as tgt
from nsof_tpu_torch.models import owlvit as towl
from nsof_tpu_torch.models import sam as tsam
from nsof_tpu_torch.models import yolov8 as tyolo
from nsof_tpu_torch.models.flowformer import FlowFormer, get_experiment
from nsof_tpu_torch.models.raft import RAFT, RaftConfig
from nsof_tpu_torch.ops import components as tcomp
from nsof_tpu_torch.ops import farneback_fast as tff
from nsof_tpu_torch.ops import roi as troi
from nsof_tpu_torch.ops.farneback import PRESETS, _gaussian_blur_kernel, _poly_exp_coeffs
from nsof_tpu_torch.ops.farneback import farneback
from nsof_tpu_torch.pipelines.prediction import (prediction_batch_fast, prediction_ssim,
                                                 prediction_stages)
from nsof_tpu_torch.pipelines import runner as trunner
from nsof_tpu_torch.pipelines.deep_flow import (DeepBackend, deep_full_flow_step,
                                                deep_roi_flow_batch, deep_roi_flow_step)
from nsof_tpu_torch.pipelines import detection as tdet
from nsof_tpu_torch.pipelines import stream as tstream
from nsof_tpu_torch.pipelines.segmentation import seg_batch_fast, seg_stages, seg_step
from nsof_tpu_torch.pipelines.tracking import tracking_batch_fast, tracking_stages
from nsof_tpu_torch.serve.app import make_server
from nsof_tpu_torch.serve.engine import BatchingEngine
from nsof_tpu_torch.utils import reporting
from nsof_tpu_torch.utils.flow_viz import flow_to_image
from nsof_tpu_torch.utils.png import decode_png, encode_png
from nsof_tpu_torch.data.flow_datasets import synthetic_affine_dataset, write_flo
import torch.distributed as dist

from nsof_tpu_torch.parallel import mesh as pmesh
from nsof_tpu_torch.parallel import train as ptrain
from nsof_tpu_torch.parallel.inference import make_sharded_seg_batch
from nsof_tpu_torch.parallel.pipeline import make_raft_pp_flow
from nsof_tpu_torch.parallel.spatial import make_spatial_flow
from nsof_tpu_torch.train import optim as toptim
from nsof_tpu_torch.train.curriculum import (FLOWFORMER_STAGES, RAFT_STANDARD_STAGES,
                                             build_stage_items, mixed_batch_iterator, run_stage)
from nsof_tpu_torch.train.loss import sequence_loss
from nsof_tpu_torch.train.optim import raft_optimizer
from nsof_tpu_torch.train.trainer import restore_checkpoint
from nsof_tpu_torch.utils.ppm import encode_ppm

H, W, MEMSIZE = 480, 640, 80
WIN = (256, 384)
B_MAIN = 256
B_CHECK = 16
RADIUS = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
EXPECTED_LAUNCHES = {"crop_windows": 2, "poly_expansion": 8,
                     "update_matrices_sep": 4, "fused_box_update": 12}
F32_LAUNCHES = {"crop_windows": 2, "poly_expansion": 8,
                "update_matrices_sep_f32": 4, "fused_box_update_f32": 12}
# K1 beyond the main path: name → (frames shape, dtype, window, oys, oxs);
# origins ≡ 0, 1, 15 (mod 16), ragged widths, 1-, 2-, 4- and 12-byte
# elements, negative and clamped origins, B = 1
K1_CASES = {
    "ox_mod16_0": ((4, H, W), torch.uint8, WIN, [0, 100, 224, 7], [0, 160, 256, 32]),
    "ox_mod16_1": ((4, H, W), torch.uint8, WIN, [3, 99, 1, 224], [1, 161, 17, 241]),
    "ox_mod16_15": ((4, H, W), torch.uint8, WIN, [5, 0, 200, 13], [15, 175, 255, 31]),
    "ragged_width": ((3, 120, 200), torch.uint8, (50, 77), [1, 2, 70], [3, 0, 123]),
    "bf16": ((3, 90, 130), torch.bfloat16, (37, 51), [0, 5, 53], [1, 7, 79]),
    "bf16_channels": ((2, 40, 50, 2), torch.bfloat16, (21, 29), [3, 19], [0, 21]),
    "f32": ((2, 50, 60), torch.float32, (17, 17), [0, 33], [5, 43]),
    "f32_channels": ((3, 60, 70, 3), torch.float32, (20, 33), [0, 11, 40], [0, 5, 37]),
    "negative_and_clamped": ((4, 100, 150), torch.uint8, (40, 60),
                             [-5, 1000, -1000, 70], [-7, 200, -1000, 95]),
    "batch_1": ((1, H, W), torch.uint8, WIN, [31], [77]),
}
# K2 beyond the main path: name → (B, hk, wk, hp, wp, n, blur taps, margin[,
# poly_sigma, default 1.2]); n 1 and 5 (the template instances), 7 and 10
# (the generic kernel), no blur and
# the 3-tap blur, margin (0, 0) and (8, 16), canvases larger than the image
# on both axes, widths that are not a multiple of the 128-column strip (and
# one that is not a multiple of 4), runs of 64 rows with a ragged end, B = 1
K2_CASES = {
    "n5_blur_margin": (4, 40, 50, 64, 96, 5, 3, (8, 16)),
    "n5_plain": (4, 40, 50, 64, 64, 5, 0, (0, 0)),
    "n1_blur_margin": (4, 37, 45, 64, 160, 1, 3, (8, 16)),
    "n1_plain_ragged": (3, 70, 150, 96, 200, 1, 0, (0, 0)),
    "n7_blur_margin": (2, 33, 41, 64, 64, 7, 3, (8, 16)),
    "n7_plain": (2, 33, 41, 33, 41, 7, 0, (0, 0)),
    "width_61": (2, 30, 37, 45, 61, 5, 3, (0, 0)),
    "batch_1_level0": (1, WIN[0], WIN[1], WIN[0], WIN[1], 5, 3, (8, 16)),
    # autodriving's and uav's poly_n 10 (poly_sigma 1.05) on the generic kernel
    "n10_plain": (2, 40, 50, 40, 50, 10, 0, (0, 0), 1.05),
    "n10_blur_margin": (2, 33, 41, 64, 64, 10, 3, (8, 16), 1.05),
}
# K3 (the fused route's first system, both M types, on a 40×50 level's
# 64×64 canvas with its (8, 16) margin) and K5 (float32, on a 97×131 level
# edge-padded by radius + 1): name → (route, M type, radius, B)
K3_CASES = {
    **{f"k3_{t}_r{r}": ("fused", dt, r, 3)
       for t, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)) for r in (3, 5, 7)},
    "k5_r3": ("level", torch.float32, 3, 2),
    "k5_r8": ("level", torch.float32, 8, 2),
    f"k5_r{tff.SEP_MAX_RADIUS}_b1": ("level", torch.float32, tff.SEP_MAX_RADIUS, 1),
}
# K7 on a ragged 97×131 level edge-padded by radius + 1, with k7_flow's
# flows: name → (radius, B)
K7_CASES = {"k7_r1": (1, 2), "k7_r3": (3, 2), "k7_r8": (8, 2), "k7_r37_b1": (37, 1)}
# K4's (winsize, radius) checks: grasp, tabletennis, the fused route's limits,
# the widest window the kernel takes
K4_CASES = [(15, RADIUS), (4, 5), (17, 7), (63, 7)]
# the autodriving preset: 4 pyramid levels × 3 iterations
AD_B = 128
AD_B_CHECK = 4
AD_LAUNCHES = {
    "auto": {"crop_windows": 2, "update_matrices_sep_level": 12, "box_solve": 12},
    "pallas": {"crop_windows": 2, "update_matrices": 12, "box_solve": 12},
}
# the tracking and prediction paths: batch, and the labelling's most host
# synchronisations a call (one every 8 of at most 256 sweeps); the tracking
# head's NMS is K9, once a call
B_HEADS = 64
MAX_TRACKING_SYNCS = 32
TRACKING_LAUNCHES = {**EXPECTED_LAUNCHES, "nms": 1}
# each timed call: median of TIME_N after TIME_WARM warm-up calls
TIME_WARM, TIME_N = 3, 10
# K8 against its plain version, n_substeps 1000: name → (grid, pairs,
# FrameSimConfig changes, inputs).  6×8 is memsize 80 at 480×640, 12×16
# memsize 40, 24×32 (768 cells, above 4 × 132 SMs: lanes packed) memsize
# 20; th1 = 6 puts |Δ| in (5.5, 6] in the modulation's dead zone; alpha 2
# and 1.5 raise the drive by powf.  Inputs: "random"; "mixed", a third of
# the cells static from w0 0.01 (they clamp to 0 early in the first pair),
# a third stepped by 12/256 a frame from w0 0.9999 (they clamp to 1 early),
# a third random (they run whole pairs); "exact_w0", w0 at exact 0, 1 and
# -0.0 in some cells; "nan_w0", a NaN w0 cell (compared by bits)
K8_SUBSTEPS = 1000
K8_CASES = {
    "grid_6x8": ((6, 8), 3, {}, "random"),
    "grid_12x16": ((12, 16), 3, {}, "random"),
    "ragged_7x13": ((7, 13), 2, {}, "random"),
    "dead_zone_th1_6": ((6, 8), 2, {"th1": 6.0}, "random"),
    "alpha_2_1.5": ((6, 8), 2, {"alpha_off": 2.0, "alpha_on": 1.5}, "random"),
    "mixed_lanes": ((6, 8), 3, {}, "mixed"),
    "w0_0_1_neg0": ((6, 8), 2, {}, "exact_w0"),
    "w0_nan": ((6, 8), 2, {}, "nan_w0"),
    "packed_24x32": ((24, 32), 2, {}, "random"),
}
# the stream: scripts/bench_stream.py's workload, 129 frames (128 pairs) a
# call, the grasp main path's kernels and one K8 launch
STREAM_T = 128 + 1
STREAM_CHUNK = 64
STREAM_LAUNCHES = {"device_scan": 1, **EXPECTED_LAUNCHES}
# K8's plain version is ~25 launches a substep: it is timed at this count
K8_PLAIN_SUBSTEPS = 100
# the event-gated stream: a 2×2-cell box crossing the 6×8 grid at 8 cells
# a second for 1 s, frames at 25 fps
EVENT_FPS = 25
# the serving engine: ENGINE_REQUESTS single-pair requests of the main
# path's workload from ENGINE_THREADS client threads, max_batch
# ENGINE_MAX_BATCH with the default buckets (1, 2, 4, ..., 128)
ENGINE_MAX_BATCH = 128
ENGINE_REQUESTS = 512
ENGINE_THREADS = 16
# the demo server's /api/flow requests; the frames of the runner's scene and
# of the CLI's folder (SCENE_FRAMES - 2 frame pairs a scene)
SERVE_FLOWS = 3
SCENE_FRAMES = 9
# extra arguments of the CLI runs (a CPU rehearsal passes --device cpu)
CLI_ARGS: list[str] = []
# the CLI's visualize on eventsim's result: a keyframe every this many frames
EVENT_KEY_EVERY = 100
# the deep backends on scripts/bench_deep.py's workload A: 480×640 RGB
# frames (1/3 scale), a 256×384 window, grasp at memsize 80 (26 on the deep
# grid of 18×24 cells, a 3×3-cell block active), six shifted variants;
# RAFT at 20 iterations, seeded random weights
DEEP_H, DEEP_W, DEEP_WIN = 480, 640, (256, 384)
DEEP_ITERS = 20
DEEP_LAUNCHES = {"crop_windows": 2}
# the card's flow against the port's on the CPU (float32, no TF32) and the
# two corr modes against each other on the card, in px: rounding moved
# these models' flows by 6e-6 to 3e-5 px on the CPU (weights scaled by
# 1 ± 1.2e-7), and the corr modes by 1.1e-5 (basic) at 20 iterations
DEEP_FLOW_TOL = 1e-3
DEEP_ALT_TOL = 1e-4
# the card's flow at PyTorch's defaults (cuDNN TF32 convolutions: a 10-bit
# mantissa, rounding of 2^-11 a product), the setting timed and served,
# against the CPU port's or the card's with TF32 off, in px: read on an
# H100 at 3.3e-3 (RAFT-basic ROI), 2.1e-2 (RAFT-small's B = 8 batch),
# 4.0e-3 (RAFT-basic's) and 1.2e-2 (FlowFormer's cut), masks all equal;
# the limit is ≈ 4× the largest reading
DEEP_TF32_TOL = 8e-2
DEEP_MASK_EQUAL = 0.995
# the batched step and its engine: batch, requests, client threads
DEEP_B = 8
DEEP_ENGINE_REQUESTS = 64
DEEP_ENGINE_THREADS = 8
# FlowFormer against the CPU port on a cut window
FF_CUT = (128, 192)
# the training slice: RAFT-basic at the chairs stage of RAFT_STANDARD_STAGES
# (batch 10, 368×496 crops, 12 iterations) on TRAIN_SAMPLES synthetic pairs
# at FlyingChairs' native size; TRAIN_STEPS timed steps after a warm-up;
# FlowFormer's ff_chairs stage cut to decoder depth TRAIN_FF_DEPTH (of 12)
# and batch TRAIN_FF_B (of 8); the gradient bounds of the CPU tests
# (tests/torch_train_common.py)
TRAIN_NATIVE = (384, 512)
TRAIN_SAMPLES = 12
TRAIN_STEPS = 5
TRAIN_FF_DEPTH = 4
TRAIN_FF_B = 2
GRAD_RTOL, GRAD_ATOL, GRAD_L2 = 1e-4, 5e-3, 2e-3
# one train step at PyTorch's defaults (cuDNN TF32 convolutions) against the
# TF32-off step on the same batch and weights (train_parity): the loss's
# relative gap, the gradients' relative L2 gap and their largest gap (of the
# model's largest gradient).  Read on an H100 (RAFT-small, RAFT-basic):
# 1.3e-5, 3.7e-5; 3.4e-3, 2.7e-3; 5.7e-4, 3.1e-4.  Each limit is ≈ 4× the
# largest reading
TRAIN_TF32_LOSS, TRAIN_TF32_GRAD_L2, TRAIN_TF32_GRAD_MAX = 1.5e-4, 1.5e-2, 2.5e-3
# the detection slice: YOLOv8n at the JAX detector's defaults (80 classes,
# imgsz 640, conf 0.25, iou 0.45, max_det 300) on synthetic_state_dict's
# seeded weights, the head scaled (yolo_state); the other scales one
# forward each at 640²
YOLO_IMGSZ = 640
YOLO_SCALES = ("s", "m", "l", "x")
# the card's raw outputs against the CPU port's, of the largest magnitude of
# each output's box channels and class channels apart: with cuDNN's TF32 off
# (float32, sums in other orders; read at 9.3e-7 on an H100) and at
# PyTorch's defaults (TF32 convolutions; read at 6.9e-4, 3.3e-4 on the
# unscaled head, for which the limit was set ≈ 4× the reading)
YOLO_F32_REL = 1e-3
YOLO_TF32_REL = 1.5e-3
# the card's postprocess (TF32 off) against the CPU port's on the same
# frame: equal slots and classes, the boxes (px) and scores within these
# (read at 6.1e-5 px and 2.2e-6 on an H100; at the defaults TF32 moves
# the detections themselves: 10 on the card, 12 on the CPU)
YOLO_BOX_TOL, YOLO_SCORE_TOL = 1e-3, 2e-5
# yolo_state's class bias shift.  The CPU fixture's 3 (at imgsz 160) leaves
# every one of the 8,400 anchors of the runner scene's frame above conf at
# 640², all scores within 2.5e-2 of 1 and the top 300 ulps apart; 14 leaves
# 275 candidates there, scored 0.25–0.85
YOLO_CLS_SHIFT = 14
# the ground-truth tooling (gt_sam, gt_owlvit, gt_chain): SAM vit_b at full
# width (1024², 12 blocks) on synthetic_sam_state_dict's seed-0 weights, the
# mask head's last upscaling convolution and hypernetwork outputs ×GT_SAM_HEAD
# (tests/test_torch_sam.py's mixed_state: the seeded weights alone give
# logits of ≈ 3e-3 of one sign); its predictor on the runner scene's 480×640
# RGB frame with the first 1 and all 4 of GT_BOXES; then vit_l and vit_h
# encoders at 1024², depth uncut, their weights drawn on the card
GT_SAM_HEAD = 20
GT_BOXES = [[230, 130, 420, 300], [40, 40, 200, 200], [300, 250, 630, 470], [0, 0, 640, 480]]
# OWL-ViT at google/owlvit-base-patch32's widths (towl.BASE_PATCH32) on
# synthetic_owlvit_state_dict's seed-0 weights, the toy tokenizer, GT_QUERIES
GT_QUERIES = ["moving object", "bright square", "textured background", "a dark region"]
# the card against the CPU port on the same weights and inputs: max |Δ| over
# the largest magnitude, of SAM's low-res logits, IoU and frame logits (vit_b's
# widths, depth cut to GT_SAM_CUT_DEPTH: blocks 0 and 1 windowed, 2 global)
# and of OWL-ViT's valid logits and boxes (TINY_OWLVIT and base-patch32),
# with cuDNN's TF32 off (float32) and at PyTorch's defaults (TF32
# convolutions: the patch embeddings, SAM's neck, mask downscaling and
# upscaling).  Read on an H100 80GB HBM3 at 700 W: SAM 1.4e-6 and 8.3e-4; OWL-ViT
# 7.7e-6 and 5.2e-4 (base-patch32; TINY 7.6e-7 and 3.7e-4).  Each limit is
# ≈ 4× the largest reading
GT_SAM_CUT_DEPTH = 3
GT_SAM_F32_REL, GT_SAM_TF32_REL = 6e-6, 3.5e-3
GT_OWL_F32_REL, GT_OWL_TF32_REL = 3e-5, 2e-3
# the chain over the runner scene's first GT_CHAIN_FRAMES frames as PNG
GT_CHAIN_FRAMES = 7
# the parallel slice at world size 1 over NCCL (the card's machine has one
# GPU): the dp×tp step on a 1×1 mesh against the one-device step from the
# same seed and batch, cuDNN TF32 off: the loss within PAR_TRAIN_LOSS relative
# and every parameter after the update within 2·lr₀ + 1e-6·max |p| (the CPU
# tests' bounds), then PAR_TRAIN_STEPS timed steps each at the defaults; sp on
# one 'space' rank at 480×640 with the grasp preset and a halo of SP_HALO rows
# against the exact farneback in the interior band (rows SP_HALO … H −
# SP_HALO) within the exact path's bounds, SP_MAX and SP_MEAN px (the CPU
# read 5.8e-6 and 6.3e-7); pp on one stage at the deep window, RAFT-basic, 20
# iterations, PP_M microbatches of one pair, against RAFT's test-mode forward
PAR_TRAIN_LOSS = 1e-5
PAR_TRAIN_STEPS = 3
SP_HALO = 96
SP_MAX, SP_MEAN = 1e-2, 5e-4
PP_M = 2
# K9 against its plain loop, IoU threshold 0.45: name → (B, N, inputs,
# plus_one).  YOLO's 300 candidates at B = 1 and 8, N = 1, no and every
# candidate, equal scores, boxes with the class offset (up to 79 · 7680
# px), inclusive widths, zero-area boxes (0/0 IoU), NaN scores and
# coordinates, valid -inf scores (the kernel's greedy loop), N = 1024,
# K9_GLOBAL_N (the first N whose suppression mask leaves shared memory on
# the H100, check_k9 checks it), a row wider than a block (1,500 > 1,024
# threads, its mask in the scratch too) and one whose keys and boxes leave
# shared memory too (8,192: the whole arena in the scratch)
K9_GLOBAL_N = 1227
K9_CASES = {
    "yolo_n300_b1": (1, 300, "random", False),
    "yolo_n300_b8": (8, 300, "random", False),
    "n1": (4, 1, "all", False),
    "no_candidates": (2, 300, "none", False),
    "all_candidates": (2, 300, "all", False),
    "equal_scores": (2, 300, "ties", False),
    "class_offset": (2, 300, "class_offset", False),
    "plus_one": (2, 300, "random", True),
    "zero_area": (2, 300, "zero_area", False),
    "nan": (2, 300, "nan", False),
    "neg_inf": (2, 300, "neg_inf", False),
    "n1024": (2, 1024, "random", False),
    "n_global_mask": (2, K9_GLOBAL_N, "random", False),
    "n1500_b3": (3, 1500, "random", False),
    "n8192_arena_global": (1, 8192, "random", False),
}
K9_IOU = 0.45
# one dependent step of K9 as reckoned for its chain bound: two 5-level warp
# shuffle trees (~30 cycles a level), three barriers (~40 cycles each) and
# the pick's IoU (~25 dependent float32 operations at 4 cycles, a division
# at ~40), at the H100 SXM's 1.98 GHz boost clock
K9_STEP_NS = (10 * 30 + 3 * 40 + 25 * 4 + 40) / 1.98
# the redesign's walk as reckoned: a step (a kept box, or the visit of a
# 32-bit word) is a shared load (~30 cycles), the mask's and and not, and a
# find-first-set (~4 cycles each), at 1.98 GHz; the mask's IoUs are ~23
# float32 operations each, a row's on one SM
K9_WALK_STEP_NS = (30 + 3 * 4) / 1.98
K9_IOU_OPS = 23
ROOT = pathlib.Path(__file__).resolve().parent
# one dependent step of K8 as reckoned for its chain bound: 8 float32
# operations at 4 cycles and the two special-function operations (log2,
# exp2) any powf needs at ~18 cycles, at the H100 SXM's 1.98 GHz boost clock
K8_STEP_NS = (8 * 4 + 2 * 18) / 1.98
# launch key → (source, TPU kernel it replaces, CUDA kernel name in a trace)
SOURCES = {
    "crop_windows": ("nsof_tpu_torch/csrc/crop_windows.cu",
                     "nsof_tpu/ops/roi.py:203", "crop_windows_kernel"),
    "poly_expansion": ("nsof_tpu_torch/csrc/poly_expansion.cu",
                       "nsof_tpu/ops/farneback_fast.py:600", "poly_expansion_kernel"),
    "update_matrices_sep": ("nsof_tpu_torch/csrc/update_matrices_sep.cu",
                            "nsof_tpu/ops/farneback_fast.py:268",
                            "update_matrices_sep_kernel"),
    "update_matrices_sep_f32": ("nsof_tpu_torch/csrc/update_matrices_sep.cu",
                                "nsof_tpu/ops/farneback_fast.py:268",
                                "update_matrices_sep_kernel"),
    "fused_box_update": ("nsof_tpu_torch/csrc/fused_box_update.cu",
                         "nsof_tpu/ops/farneback_fast.py:864", "fused_box_update_kernel"),
    "fused_box_update_f32": ("nsof_tpu_torch/csrc/fused_box_update.cu",
                             "nsof_tpu/ops/farneback_fast.py:864",
                             "fused_box_update_kernel"),
    "update_matrices_sep_level": ("nsof_tpu_torch/csrc/update_matrices_sep.cu",
                                  "nsof_tpu/ops/farneback_fast.py:268",
                                  "update_matrices_sep_kernel"),
    "box_solve": ("nsof_tpu_torch/csrc/box_solve.cu",
                  "nsof_tpu/ops/farneback_fast.py:488", "box_solve_"),
    "update_matrices": ("nsof_tpu_torch/csrc/update_matrices.cu",
                        "nsof_tpu/ops/farneback_fast.py:199", "update_matrices_kernel"),
    "crop_windows_rgb": ("nsof_tpu_torch/csrc/crop_windows.cu",
                         "nsof_tpu/ops/roi.py:203", "crop_windows_kernel"),
    "device_scan": ("nsof_tpu_torch/csrc/device_scan.cu",
                    "nsof_tpu/pipelines/stream.py:48 (not a TPU kernel: XLA lax.scan)",
                    "device_scan_kernel"),
    "nms": ("nsof_tpu_torch/csrc/nms.cu",
            "nsof_tpu/ops/components.py:164 (not a TPU kernel: XLA fori_loop)", "nms_kernel"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else ""


def time_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Mean device time per call over ``iters`` calls, after ``warm``."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def host_syncs(fn) -> dict:
    """Host-device synchronisations made by one call of ``fn``, by the
    Python line that made them (CUDA sync debug mode warns at each)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # each sync warns "called a synchronizing CUDA operation"; the mode
    # also warns once that it is a prototype, which is not a sync
    where = collections.Counter(f"{w.filename}:{w.lineno}" for w in caught
                                if "called a synchronizing" in str(w.message))
    return dict(where)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate or float32
    operations over the card's float32 rate, whichever is larger."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def bench_cfg():
    cfg = dataclasses.replace(
        DATASETS["grasp"], name="bench640", image_h=H, image_w=W,
        window_h=WIN[0], window_w=WIN[1], warp_radius=RADIUS,
    )
    return dataclasses.replace(cfg, roi=dataclasses.replace(cfg.roi, memsize=MEMSIZE))


def texture(h: int, w: int) -> np.ndarray:
    """bench.py's random texture, with a 32-pixel margin on every side."""
    rng = np.random.default_rng(0)
    return rng.random((h + 64, w + 64)).astype(np.float32) * 255


def frame_inputs(b: int, variant: int, dev, h: int, w: int, memsize: int,
                 cells: tuple[slice, slice]):
    """bench.py's inputs (bench.py:72-92) at h×w: a random texture moved
    by (2, -1) px, and a state map with the ``cells`` block active."""
    base = texture(h, w)
    v = variant
    prev = np.broadcast_to(base[16 + v : 16 + v + h, 16 : 16 + w], (b, h, w))
    nxt = np.broadcast_to(base[18 + v : 18 + v + h, 15 : 15 + w], (b, h, w))
    mem = np.zeros((b, h // memsize, w // memsize), np.uint8)
    mem[:, cells[0], cells[1]] = 255
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return t(mem), t(prev.astype(np.uint8)), t(nxt.astype(np.uint8))


def bench_inputs(b: int, variant: int, dev):
    """The main path's inputs: 640×480, a 6×8 state map with an active 2×2
    block."""
    return frame_inputs(b, variant, dev, H, W, MEMSIZE, (slice(2, 4), slice(3, 5)))


def ad_inputs(b: int, variant: int, dev):
    """The autodriving path's inputs: 801×801, a 4×4 state map with an
    active 2×2 block."""
    cfg = DATASETS["autodriving"]
    return frame_inputs(b, variant, dev, cfg.image_h, cfg.image_w, cfg.roi.memsize,
                        (slice(1, 3), slice(1, 3)))


def exact_check(got: torch.Tensor, ref: torch.Tensor, name: str) -> float:
    """Kernel vs plain, required equal (built with --fmad=false, summed in
    one order).  Returns max |Δ|, 0."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} vs "
                             f"{ref.dtype} {tuple(ref.shape)}")
    err = (got.float() - ref.float()).abs().max().item()
    if err != 0:
        raise AssertionError(f"{name} differs from its plain version by {err}")
    return err


def k2_case(name: str, dev):
    """K2_CASES[name] as a kernel call and its plain version's call."""
    b, hk, wk, hp, wp, n, taps, margin, *sigma = K2_CASES[name]
    rng = np.random.default_rng(len(name))
    img = torch.from_numpy((rng.random((b, hk, wk)) * 255).astype(np.float32)).to(dev)
    blur = _gaussian_blur_kernel(taps, 0.0) if taps else None
    args = (img, n, sigma[0] if sigma else 1.2, hp, wp, blur, margin)
    return (lambda: tff.poly_expansion(*args)), (lambda: tff._poly_expansion_plain(*args))


def k3_case(name: str, dev):
    """K3_CASES[name] as a kernel call and its plain version's call: random
    expansions and a flow reaching past the radius."""
    route, dtype, radius, b = K3_CASES[name]
    rng = np.random.default_rng(radius * 10 + b)
    if route == "fused":
        hk, wk, hp, wp = 40, 50, 64, 64
        mr, mc = tff.R1_MARGIN
    else:
        hk, wk = hp, wp = 97, 131
        mr = mc = radius + 1

    def t(shape, scale):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale).to(dev)

    dx, dy = t((b, hk, wk), radius + 1.0), t((b, hk, wk), radius + 1.0)
    r0 = t((b, 5, hp, wp), 50.0)
    r1 = t((b, 5, hp + 2 * mr, wp + 2 * mc), 50.0)
    bsc = tff.border_scale(hk, wk, str(dev))
    if route == "fused":
        args = (dx, dy, r0, r1, bsc, radius)
        return (lambda: tff.update_matrices_sep(*args, out_dtype=dtype),
                lambda: tff._update_matrices_sep_plain(*args, out_dtype=dtype))
    args = (dx, dy, r0, r1, bsc, radius)
    return (lambda: tff.update_matrices(*args, separable=True),
            lambda: tff._update_matrices_plain(*args, separable=True))


def k7_flow(shape, radius: int, rng) -> np.ndarray:
    """One flow plane for K7's checks: half its elements drawn from the
    values where a sum of four taps could part from the full sum (integers
    inside and beyond ±r, ±r exactly, ±0, ±1e-10, ±1e-30, ±1e-45, one ulp
    either side of each integer, far beyond the radius), half uniform over
    [-r - 2, r + 2]."""
    ks = np.arange(-radius - 2, radius + 3, dtype=np.float32)
    tiny = np.array([1e-10, 1e-30, 1e-45], np.float32)
    inf = np.float32(np.inf)
    special = np.concatenate([
        ks, np.nextafter(ks, inf), np.nextafter(ks, -inf), tiny, -tiny,
        np.array([0.0, -0.0, radius + 0.5, -radius - 0.5, 1e3, -1e3], np.float32),
    ])
    rand = rng.uniform(-radius - 2, radius + 2, size=shape).astype(np.float32)
    return np.where(rng.random(shape) < 0.5, rng.choice(special, size=shape), rand)


def k7_case(name: str, dev):
    """K7_CASES[name] as a kernel call and its plain version's call: k7_flow
    flows, random expansions."""
    radius, b = K7_CASES[name]
    h, w, e = 97, 131, radius + 1
    rng = np.random.default_rng(radius * 10 + b)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    dx, dy = t(k7_flow((b, h, w), radius, rng)), t(k7_flow((b, h, w), radius, rng))
    r0 = t(rng.normal(size=(b, 5, h, w)) * 50.0)
    r1p = t(rng.normal(size=(b, 5, h + 2 * e, w + 2 * e)) * 50.0)
    args = (dx, dy, r0, r1p, tff.border_scale(h, w, str(dev)), radius)
    return (lambda: tff.update_matrices(*args)), (lambda: tff._update_matrices_plain(*args))


def k8_inputs(name: str):
    """K8_CASES[name]'s compressed frames ``[pairs + 1, gh, gw]`` in [0, 1]
    and initial state ``[gh, gw]`` as float32 numpy arrays, and its
    FrameSimConfig: frames whose |Δ|·256 between pairs spans [0, 12] (both
    branches of the |Δ| transfer), a random initial state, edited as the
    case's inputs say."""
    (gh, gw), pairs, changes, kind = K8_CASES[name]
    rng = np.random.default_rng(gh * gw + pairs)
    params = {k: v for k, v in changes.items() if k.startswith("alpha")}
    sim = tfs.FrameSimConfig(m=MEMSIZE, n=MEMSIZE, n_substeps=K8_SUBSTEPS,
                             params=dataclasses.replace(DEFAULT_PARAMS, **params),
                             **{k: v for k, v in changes.items() if k not in params})
    steps = rng.uniform(0, 12, (pairs, gh, gw)) * rng.choice([-1, 1], (pairs, gh, gw))
    first = rng.uniform(0.1, 0.9, (1, gh, gw))
    w0 = rng.random((gh, gw))
    if kind == "mixed":
        third = np.arange(gh * gw).reshape(gh, gw) % 3
        steps[:, third == 0] = 0.0
        steps[:, third == 1] = 12.0 * (-1.0) ** np.arange(pairs)[:, None]
        w0[third == 0], w0[third == 1] = 0.01, 0.9999
    frames = np.concatenate([first, steps / 256]).cumsum(0)
    w0 = w0.astype(np.float32)
    if kind == "exact_w0":
        w0.flat[0::5], w0.flat[1::5], w0.flat[2::5] = 0.0, 1.0, -0.0
    elif kind == "nan_w0":
        w0[1, 2] = np.nan
    return np.clip(frames, 0, 1).astype(np.float32), w0, sim


def k8_case(name: str, dev):
    """K8_CASES[name] as a kernel call and its plain version's call, each
    giving (w_final, mem_gray, states)."""
    frames, w0, sim = k8_inputs(name)
    frames, w0 = torch.from_numpy(frames).to(dev), torch.from_numpy(w0).to(dev)
    return (lambda: tfs.scan_device(frames, sim, w0, keep_states=True),
            lambda: tfs.scan_device_plain(frames, sim, w0, keep_states=True))


def bits_equal(got: torch.Tensor, ref: torch.Tensor) -> bool:
    """Equal bit for bit: float32 compared as its bits (NaN equal to the
    same NaN, -0.0 not to 0.0), anything else by value."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        return False
    if got.dtype == torch.float32:
        return torch.equal(got.view(torch.int32), ref.view(torch.int32))
    return torch.equal(got, ref)


def flow_check(got, ref, name: str, tol: float = 1e-5) -> float:
    err = max((g - r).abs().max().item() for g, r in zip(got, ref))
    if not err <= tol:
        raise AssertionError(f"{name} flow differs from its plain version by {err} px")
    return err


@contextlib.contextmanager
def plain_route():
    """Swap every kernel wrapper for its plain version (the reference run
    of a path on the card)."""
    names = {"crop_windows_batch": (troi, troi.crop_windows),
             "poly_expansion": (tff, tff._poly_expansion_plain),
             "update_matrices_sep": (tff, tff._update_matrices_sep_plain),
             "fused_box_update": (tff, tff._fused_box_update_plain),
             "update_matrices": (tff, tff._update_matrices_plain),
             "box_solve": (tff, tff._box_solve_plain),
             "scan_device": (tstream, tfs.scan_device_plain),
             "nms_batch": (tcomp, tcomp.nms)}
    saved = {name: getattr(mod, name) for name, (mod, _) in names.items()}
    for name, (mod, plain) in names.items():
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for name, (mod, _) in names.items():
            setattr(mod, name, saved[name])


def poly_filters_2d(n: int, sigma: float, dev) -> torch.Tensor:
    """The five 2-D filters ``[5, 1, 2n+1, 2n+1]`` whose correlation with
    the edge-extended image is K2's expansion without blur: the separable
    taps' outer products (rows first) times the ig scales."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_exp_coeffs(n, sigma)
    o = np.outer
    f = np.stack([ig11 * o(xg, g), ig11 * o(g, xg), ig03 * o(g, g) + ig33 * o(xxg, g),
                  ig03 * o(g, g) + ig33 * o(g, xxg), ig55 * o(xg, xg)])
    return torch.from_numpy(f.astype(np.float32))[:, None].to(dev)


def level0_operands(b: int, dev):
    """Level-0 operands of the main path: 256×384 window images, their
    expansions, a smooth flow reaching past the warp radius."""
    rng = np.random.default_rng(1)
    hk, wk = WIN
    img0 = torch.from_numpy((rng.random((b, hk, wk)) * 255).astype(np.float32)).to(dev)
    img1 = torch.roll(img0, (2, -1), dims=(1, 2)).contiguous()
    coarse = torch.from_numpy(rng.normal(size=(b, 2, 10, 14)).astype(np.float32) * 2.0)
    flow = torch.nn.functional.interpolate(coarse, size=(hk, wk), mode="bilinear")
    dx, dy = flow[:, 0].contiguous().to(dev), flow[:, 1].contiguous().to(dev)
    blur = _gaussian_blur_kernel(3, 0.0)
    r0 = tff.poly_expansion(img0, 5, 1.2, hk, wk, blur)
    r1 = tff.poly_expansion(img1, 5, 1.2, hk, wk, blur, margin=tff.R1_MARGIN)
    bsc = tff.border_scale(hk, wk, str(dev))
    m = tff.update_matrices_sep(dx, dy, r0, r1, bsc, RADIUS)
    m32 = tff.update_matrices_sep(dx, dy, r0, r1, bsc, RADIUS, out_dtype=torch.float32)
    return dict(img0=img0, img1=img1, dx=dx, dy=dy, blur=blur, r0=r0, r1=r1,
                bsc=bsc, m=m, m32=m32)


def ad_level0_operands(b: int, dev, pad: int = RADIUS + 1):
    """Level-0 operands of the autodriving path: 801×801 images blurred as
    the level route blurs them, their poly_n 10 expansions (r1 edge-padded
    by ``pad``), a smooth flow reaching past the warp radius, and M."""
    cfg = DATASETS["autodriving"]
    h, w, fb = cfg.image_h, cfg.image_w, cfg.fb
    rng = np.random.default_rng(3)
    img0 = torch.from_numpy((rng.random((b, h, w)) * 255).astype(np.float32)).to(dev)
    img1 = torch.roll(img0, (2, -1), dims=(1, 2)).contiguous()
    blur = _gaussian_blur_kernel(3, 0.0)
    i0, i1 = (tff._blur_valid(tff._reflect_pad(i, 1), blur) for i in (img0, img1))
    coarse = torch.from_numpy(rng.normal(size=(b, 2, 26, 26)).astype(np.float32) * 2.0)
    flow = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear")
    dx, dy = flow[:, 0].contiguous().to(dev), flow[:, 1].contiguous().to(dev)
    r0 = tff.poly_expansion_fast(i0, fb.poly_n, fb.poly_sigma)
    r1p = tff._extend(tff.poly_expansion_fast(i1, fb.poly_n, fb.poly_sigma),
                      pad, pad, pad, pad)
    bsc = tff.border_scale(h, w, str(dev))
    m = tff.update_matrices(dx, dy, r0, r1p, bsc, RADIUS, separable=True)
    return dict(dx=dx, dy=dy, r0=r0, r1p=r1p, bsc=bsc, m=m, winsize=fb.winsize)


def device_trace(call, ms_batch: float, batch: int, keys, **meta) -> dict:
    """Device time of one call of ``call`` by kernel name (torch.profiler,
    after one untraced call), the port's kernels on it (launch ``keys``)
    against everything else, the kernels launched, and the device's idle
    share of the timed call (``ms_batch``)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return {"phase": "device_trace", **meta, "busy_ms": "not measured",
                "reason": "the profiler recorded no device events"}
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    ours = {k: 0.0 for k in keys}
    for e in kern:
        for k in ours:
            if SOURCES[k][2] in e.key:
                ours[k] += e.self_device_time_total / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:15]
    return {
        "phase": "device_trace", **meta, "batch": batch,
        "busy_ms": busy, "idle_share_of_timed_batch": 1.0 - busy / ms_batch,
        "kernels_ms": ours, "other_ms": busy - sum(ours.values()),
        "device_launches": sum(e.count for e in kern),
        "top": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                 "count": e.count} for e in top],
    }


def where_the_time_goes(cfg, mem, prev, nxt, ms_batch: float, batch: int,
                        keys, **kwargs) -> dict:
    """:func:`device_trace` of one call of a path of ``seg_batch_fast``."""
    return device_trace(lambda: seg_batch_fast(mem, prev, nxt, cfg, **kwargs),
                        ms_batch, batch, keys, path=cfg.name, kwargs=kwargs)


def drive_path(cfg, inputs, batch: int, expected: dict, dev, trace: bool,
               **kwargs) -> tuple[dict, float]:
    """One path of ``seg_batch_fast``: its launch counts (zeroed just
    before the call, read just after) must be ``expected``; its output must
    agree with the plain route's, keep the mask inside a non-empty ROI, and
    come with no host synchronisation; then it is timed (median of 10
    after 3 warm-up calls, three input variants in turn) and, with
    ``trace``, profiled.  Returns the launch counts and ms per batch."""
    mem, prev, nxt = inputs(batch, 0, dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    out = seg_batch_fast(mem, prev, nxt, cfg, return_flow=True, **kwargs)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    if launches != expected:
        raise AssertionError(f"{cfg.name} {kwargs}: launches {launches} != {expected}")
    counts = dict(_build.LAUNCHES)
    with plain_route():
        ref = seg_batch_fast(mem, prev, nxt, cfg, return_flow=True, **kwargs)
    torch.cuda.synchronize()
    if _build.LAUNCHES != counts:
        raise AssertionError("the plain route launched a kernel")
    flow_err = (out["flow"] - ref["flow"]).abs()
    mask_agree = (out["mask"] == ref["mask"]).float().mean().item()
    if not (torch.isfinite(out["flow"]).all() and flow_err.max().item() <= 1e-3
            and mask_agree >= 0.995):
        raise AssertionError(f"{cfg.name} {kwargs} vs plain route: flow "
                             f"{flow_err.max().item()} px, mask agreement {mask_agree}")
    for key in ("box", "any_active", "region_pct"):
        if not torch.equal(out[key], ref[key]):
            raise AssertionError(f"{key} differs from the plain route")
    box = out["box"][0].tolist()
    inside = out["mask"][:, box[1]:box[3], box[0]:box[2]]
    if not (out["any_active"].all() and (inside > 0).any(dim=(1, 2)).all()):
        raise AssertionError("the mask is empty inside the ROI")
    if out["mask"].sum() != inside.sum():
        raise AssertionError("the mask has pixels outside the ROI")
    probe = host_syncs(lambda: out["box"].sum().item())
    if sum(probe.values()) != 1:
        raise AssertionError(f"the sync counter saw {probe} in one .item()")
    syncs = host_syncs(lambda: seg_batch_fast(mem, prev, nxt, cfg, return_flow=True,
                                              **kwargs))
    emit({"phase": "main_path", "path": cfg.name, "kwargs": kwargs, "batch": batch,
          "frame": [cfg.image_h, cfg.image_w], "window": list(cfg.win_shape),
          "launches_per_call": launches, "flow_max_abs_err_px": flow_err.max().item(),
          "flow_mean_abs_err_px": flow_err.mean().item(), "mask_agreement": mask_agree,
          "mask_fraction_in_roi": (inside > 0).float().mean().item(), "box": box,
          "host_syncs_per_call": sum(syncs.values()), "host_sync_sites": syncs})
    if syncs:
        raise AssertionError(f"{cfg.name} {kwargs} synchronised with the host: {syncs}")
    del out, ref, flow_err, inside

    variants = [(mem, prev, nxt)] + [inputs(batch, v, dev) for v in (1, 2)]
    samples = []
    for i in range(13):
        m_, p_, n_ = variants[i % 3]
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        seg_batch_fast(m_, p_, n_, cfg, **kwargs)
        stop.record()
        torch.cuda.synchronize()
        if i >= 3:  # warm-up
            samples.append(start.elapsed_time(stop))
    ms_batch = float(np.median(samples))
    emit({"phase": "main_path_time", "path": cfg.name, "kwargs": kwargs, "batch": batch,
          "ms_per_batch": ms_batch, "fps": batch / ms_batch * 1e3,
          "samples_ms": samples, "card": smi_line()})
    if trace:
        emit(where_the_time_goes(cfg, *variants[0], ms_batch, batch, expected, **kwargs))
    return launches, ms_batch


def bgr(gray: torch.Tensor) -> torch.Tensor:
    """A uint8 BGR frame ``[..., 3]`` from a gray one: three channels
    mixed from it."""
    g = gray.to(torch.int32)
    return torch.stack([g, 255 - g, (3 * g + 17) % 256], dim=-1).to(torch.uint8)


def heads_frames(b: int, variant: int, dev):
    """The prediction path's BGR frames, both moved on by (2, -1) px from
    bench_inputs' next frame: the next frame, and the true frame after it."""
    base = texture(H, W)
    v = variant
    nxt = np.broadcast_to(base[18 + v : 18 + v + H, 15 : 15 + W], (b, H, W))
    fut = np.broadcast_to(base[20 + v : 20 + v + H, 14 : 14 + W], (b, H, W))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.astype(np.uint8))).to(dev)  # noqa: E731
    return bgr(t(nxt)), bgr(t(fut))


def median_ms(call, variants) -> tuple[float, list[float]]:
    """Device time of ``call(*args)`` by CUDA events, one call at a time
    with the ``variants`` in turn: the median of TIME_N after TIME_WARM
    warm-up calls, and the samples."""
    samples = []
    for i in range(TIME_WARM + TIME_N):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        call(*variants[i % len(variants)])
        stop.record()
        torch.cuda.synchronize()
        if i >= TIME_WARM:
            samples.append(start.elapsed_time(stop))
    return float(np.median(samples)), samples


def launched_by(call) -> tuple[dict, object]:
    """The launch counts of one call of ``call``, zeroed just before it and
    read just after, and its result."""
    torch.cuda.synchronize()
    _build.reset_launches()
    out = call()
    torch.cuda.synchronize()
    return {k: v for k, v in _build.LAUNCHES.items() if v}, out


def against_plain(call, out: dict, keys) -> None:
    """``call`` again with every kernel wrapper on its plain version: it
    must launch nothing and give ``out``'s ``keys`` bit for bit."""
    counts = dict(_build.LAUNCHES)
    with plain_route():
        ref = call()
    torch.cuda.synchronize()
    if _build.LAUNCHES != counts:
        raise AssertionError("the plain route launched a kernel")
    for key in keys:
        if not torch.equal(out[key], ref[key]):
            raise AssertionError(f"{key} differs from the plain route's")


def drive_tracking(dev) -> dict:
    """``tracking_batch_fast`` on the main path's workload at B_HEADS in
    'fused': exactly TRACKING_LAUNCHES (the main path's kernels and K9 for
    the head's NMS), the plain route's boxes, at most MAX_TRACKING_SYNCS
    host synchronisations, a box found on every sample; then timed."""
    cfg = bench_cfg()
    mem, prev, nxt = bench_inputs(B_HEADS, 0, dev)

    def call(m=mem, p=prev, n=nxt):
        return tracking_batch_fast(m, p, n, cfg, kernel_mode="fused")

    launches, out = launched_by(call)
    if launches != TRACKING_LAUNCHES:
        raise AssertionError(f"tracking: launches {launches} != {TRACKING_LAUNCHES}")
    against_plain(call, out, ("boxes", "valid", "areas", "box", "any_active"))
    n_valid = out["valid"].sum(dim=1)
    if not (out["any_active"].all() and (n_valid > 0).all()):
        raise AssertionError("tracking found no box on some sample")
    box = out["box"][0].tolist()
    first = out["boxes"][0][out["valid"][0]]
    syncs = host_syncs(call)
    n_syncs = sum(syncs.values())
    emit({"phase": "tracking_path", "batch": B_HEADS, "kwargs": {"kernel_mode": "fused"},
          "launches_per_call": launches, "host_syncs_per_call": n_syncs,
          "host_sync_sites": syncs, "valid_boxes_per_sample": sorted(set(n_valid.tolist())),
          "roi_box": box, "boxes_sample_0": first.tolist()})
    if n_syncs > MAX_TRACKING_SYNCS:
        raise AssertionError(f"tracking synchronised {n_syncs} times")
    del out
    variants = [(mem, prev, nxt)] + [bench_inputs(B_HEADS, v, dev) for v in (1, 2)]
    ms, samples = median_ms(call, variants)
    emit({"phase": "tracking_path_time", "batch": B_HEADS, "ms_per_batch": ms,
          "fps": B_HEADS / ms * 1e3, "samples_ms": samples, "card": smi_line()})
    emit(device_trace(call, ms, B_HEADS, TRACKING_LAUNCHES, path="tracking"))
    return launches


def drive_prediction(dev) -> dict:
    """``prediction_batch_fast`` on the main path's workload at B_HEADS in
    'fused' with a BGR next frame: exactly the main path's kernels, the
    plain route's prediction bit for bit, no host synchronisation, the
    prediction's SSIM against the true frame; then timed."""
    cfg = bench_cfg()
    mem, prev, nxt = bench_inputs(B_HEADS, 0, dev)
    frame, future = heads_frames(B_HEADS, 0, dev)

    def call(m=mem, p=prev, n=nxt, f=frame):
        return prediction_batch_fast(m, p, n, f, cfg, kernel_mode="fused")

    launches, out = launched_by(call)
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"prediction: launches {launches} != {EXPECTED_LAUNCHES}")
    against_plain(call, out, ("pred", "flow", "box", "any_active"))
    x0, y0, x1, y1 = out["box"][0].tolist()
    outside = torch.ones((H, W), dtype=torch.bool, device=dev)
    outside[y0:y1, x0:x1] = False
    if not torch.equal(out["pred"][:, outside], frame[:, outside]):
        raise AssertionError("the prediction changed pixels outside the ROI")
    ssim = prediction_ssim(out["pred"], future)
    ssim_next = prediction_ssim(frame, future)
    if not torch.isfinite(ssim).all():
        raise AssertionError("the prediction's SSIM is not finite")
    syncs = host_syncs(call)
    emit({"phase": "prediction_path", "batch": B_HEADS, "kwargs": {"kernel_mode": "fused"},
          "launches_per_call": launches, "host_syncs_per_call": sum(syncs.values()),
          "host_sync_sites": syncs, "roi_box": [x0, y0, x1, y1],
          "changed_fraction_in_roi": (out["pred"][:, y0:y1, x0:x1]
                                      != frame[:, y0:y1, x0:x1]).any(dim=-1)
          .float().mean().item(),
          "prediction_ssim_mean": ssim.mean().item(),
          "next_frame_ssim_mean": ssim_next.mean().item()})
    if syncs:
        raise AssertionError(f"prediction synchronised with the host: {syncs}")
    del out
    variants = [(mem, prev, nxt, frame)] + [
        (*bench_inputs(B_HEADS, v, dev), heads_frames(B_HEADS, v, dev)[0]) for v in (1, 2)]
    ms, samples = median_ms(call, variants)
    emit({"phase": "prediction_path_time", "batch": B_HEADS, "ms_per_batch": ms,
          "fps": B_HEADS / ms * 1e3, "samples_ms": samples, "card": smi_line()})
    emit(device_trace(call, ms, B_HEADS, EXPECTED_LAUNCHES, path="prediction"))
    return launches


def drive_dual(dev, cfg=None, mem=None, phase: str = "dual_path") -> None:
    """The dual path: each pipeline's exact stages on one frame pair, as
    the reference's runner calls them (pipelines/runner.py:184-199), every
    stage timed; the ROI mask must be non-empty inside the box and zero
    outside it, and no stage may launch a kernel.  By default on the main
    path's workload; ``cfg`` and the ``[gh, gw]`` state map ``mem`` replace
    its config and map (the FLAG=1 stages)."""
    cfg = cfg or bench_cfg()
    bench_mem, prev, nxt = (t[0] for t in bench_inputs(1, 0, dev))
    mem = bench_mem if mem is None else mem
    frame = heads_frames(1, 0, dev)[0][0]
    torch.cuda.synchronize()
    _build.reset_launches()
    for name, make in (("segmentation", seg_stages), ("tracking", tracking_stages),
                       ("prediction", prediction_stages)):
        st = make(cfg)
        roi = st["cal"](mem)
        flow_win, inbox = st["vel"](prev, nxt, mem, roi)
        flow_full = st["vel_full"](prev, nxt)
        calls = {"cal": lambda: st["cal"](mem),
                 "vel": lambda: st["vel"](prev, nxt, mem, roi),
                 "vel_full": lambda: st["vel_full"](prev, nxt)}
        extra = {}
        if name == "segmentation":
            mask_win = st["task"](flow_win, inbox)
            calls["task"] = lambda: st["task"](flow_win, inbox)
            calls["comb"] = lambda: st["comb"](mask_win, roi["box"], roi["origin"])
            calls["task_full"] = lambda: st["task_full"](flow_full)
            mask = calls["comb"]()
            x0, y0, x1, y1 = roi["box"].tolist()
            inside = mask[y0:y1, x0:x1]
            if not ((inside > 0).any() and mask.sum() == inside.sum()):
                raise AssertionError("the ROI mask is empty in the box or set outside it")
            extra = {"mask_fraction_in_roi": (inside > 0).float().mean().item(),
                     "full_mask_fraction": (calls["task_full"]() > 0).float().mean().item()}
        elif name == "tracking":
            calls["task"] = lambda: st["task"](flow_win, inbox, roi["origin"], roi["active"])
            calls["task_full"] = lambda: st["task_full"](flow_full)
            extra = {"valid_boxes": int(calls["task"]()["valid"].sum()),
                     "valid_boxes_full": int(calls["task_full"]()["valid"].sum())}
        else:
            flow = st["comb"](flow_win, roi["box"], roi["origin"])
            calls["comb"] = lambda: st["comb"](flow_win, roi["box"], roi["origin"])
            calls["task"] = lambda: st["task"](frame, flow, roi["box"], roi["active"])
            calls["task_full"] = lambda: st["task_full"](frame, flow_full)
        stage_ms = {k: median_ms(fn, [()])[0] for k, fn in calls.items()}
        roi_ms = sum(stage_ms[k] for k in ("cal", "vel", "task", "comb") if k in stage_ms)
        full_ms = stage_ms["vel_full"] + stage_ms["task_full"]
        emit({"phase": phase, "pipeline": name, "frame": [H, W],
              "window": list(cfg.win_shape), "roi_box": roi["box"].tolist(),
              "region_pct": roi["region_pct"].item(), "stage_ms": stage_ms,
              "vel_speedup": stage_ms["vel_full"] / stage_ms["vel"],
              "roi_speedup": full_ms / roi_ms, **extra, "card": smi_line()})
        if name == "segmentation":
            for key in ("vel", "vel_full"):
                emit(device_trace(calls[key], stage_ms[key], 1, (), path=f"{phase}_{key}"))
    torch.cuda.synchronize()
    launched = {k: v for k, v in _build.LAUNCHES.items() if v}
    if launched:
        raise AssertionError(f"the exact path launched kernels: {launched}")


def check_k8(errs: dict, dev) -> None:
    """K8 against its plain version at every K8_CASES case: the final
    state, the gray maps and the state after each pair, required equal bit
    for bit; with the substeps each cell ran."""
    ran = {}
    for name in K8_CASES:
        kernel, plain = k8_case(name, dev)
        for part, got, ref in zip(("w_final", "mem_gray", "states"), kernel(), plain()):
            if not bits_equal(got, ref):
                raise AssertionError(f"K8 {name} {part} differs from its plain version")
        frames, w0, sim = k8_inputs(name)
        w0 = torch.from_numpy(w0).to(dev)
        steps = torch.empty(w0.numel(), dtype=torch.int32, device=dev)
        tfs._scan_device_cuda(torch.from_numpy(frames).to(dev), sim, w0, False, steps)
        ran[name] = [int(steps.min()), int(steps.max())]
    # K8's main-path power against powf on every w in [0, 1], for each (s, b)
    # of DEFAULT_PARAMS and K8_CASES
    params = [DEFAULT_PARAMS] + [k8_inputs(name)[2].params for name in K8_CASES]
    pairs = sorted({pair for p in params for pair in ((p.s_off, p.b_off), (p.s_on, p.b_on))})
    mismatches = dict(zip((f"s={s}, b={b}" for s, b in pairs),
                          tfs.power_mismatches(pairs, dev)))
    errs["device_scan"] = 0.0
    emit({"phase": "check", "kernel": "device_scan", "cases": list(K8_CASES),
          "n_substeps": K8_SUBSTEPS, "outputs": ["w_final", "mem_gray", "states"],
          "compared": "bits", "substeps_min_max_cell": ran,
          "power_mismatches_w_0_to_1": mismatches, "max_abs_err": 0.0, "tolerance": 0})
    if any(mismatches.values()):
        raise AssertionError(f"K8's main-path power differs from powf: {mismatches}")


def k9_inputs(name: str, dev):
    """K9_CASES[name]'s boxes ``[B, N, 4]``, scores ``[B, N]`` and
    candidates on the card, and its ``plus_one``: boxes clustered on eight
    centres of a 640-px square (many overlaps), uniform scores, the
    candidates scoring above 0.3, edited as the case says."""
    b, n, kind, plus_one = K9_CASES[name]
    rng = np.random.default_rng(len(name) * 7 + n)
    centres = rng.uniform(0, 640, (b, 8, 2))
    xy = centres[np.arange(b)[:, None], rng.integers(0, 8, (b, n))]
    xy = xy + rng.normal(0, 6, (b, n, 2))
    wh = rng.uniform(8, 120, (b, n, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
    scores = rng.random((b, n)).astype(np.float32)
    valid = scores > 0.3
    if kind == "none":
        valid[:] = False
    elif kind == "all":
        valid[:] = True
    elif kind == "ties":  # four levels, half the boxes at exactly 0.5
        scores = (np.round(scores * 3) / 3).astype(np.float32)
        scores[:, ::2] = 0.5
    elif kind == "class_offset":  # postprocess's offset, added in float32
        boxes += rng.integers(0, 80, (b, n, 1)).astype(np.float32) * np.float32(7680.0)
    elif kind == "zero_area":  # zero widths and heights, and equal zero-area boxes
        boxes[:, ::3, 2] = boxes[:, ::3, 0]
        boxes[:, 1::3, 3] = boxes[:, 1::3, 1]
        boxes[:, 3::9] = boxes[:, :1]
    elif kind == "nan":
        scores[:, 5::37] = np.nan
        boxes[:, 11::41, 1] = np.nan
        boxes[:, 17::43, 2] = np.nan
    elif kind == "neg_inf":  # valid -inf scores behind dead boxes of lower index
        scores[:, 7::19] = -np.inf
        valid[:, 7::19] = True
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return t(boxes), t(scores), t(valid), plus_one


def k9_case(name: str, dev):
    """K9_CASES[name] as a kernel call and its plain version's call, each
    giving the ``[B, N]`` keep mask."""
    boxes, scores, valid, plus_one = k9_inputs(name, dev)
    args = (boxes, scores, valid, K9_IOU, plus_one)
    return (lambda: tcomp.nms_batch(*args)), (lambda: tcomp.nms(*args))


def check_k9(errs: dict, dev) -> None:
    """K9 against its plain version at every K9_CASES case: the keep masks
    required equal.  K9_GLOBAL_N must be past the shared-memory mask and 32
    boxes fewer within it, and at N = 8,192 the whole arena in the
    scratch."""
    scratch = {n: tcomp.nms_scratch_bytes(1, n) for n in (K9_GLOBAL_N - 32, K9_GLOBAL_N, 8192)}
    if scratch[K9_GLOBAL_N - 32] or not scratch[K9_GLOBAL_N]:
        raise AssertionError(f"K9's mask leaves shared memory elsewhere than K9_GLOBAL_N: "
                             f"scratch bytes {scratch}")
    if scratch[8192] <= 4 * (8192 // 32) * 8192:  # more than the mask: the whole arena
        raise AssertionError(f"K9's arena at N = 8192 is not all in the scratch: {scratch}")
    kept = {}
    for name in K9_CASES:
        kernel, plain = k9_case(name, dev)
        got, ref = kernel(), plain()
        if got.dtype != torch.bool or got.shape != ref.shape or not torch.equal(got, ref):
            raise AssertionError(f"K9 {name}: the keep mask differs from the plain nms's")
        kept[name] = int(ref.sum())
    errs["nms"] = 0
    emit({"phase": "check", "kernel": "nms", "cases": list(K9_CASES), "kept": kept,
          "scratch_bytes_b1": scratch, "iou_thresh": K9_IOU, "max_abs_err": 0,
          "tolerance": 0})


def stream_frames(salt: int, dev) -> torch.Tensor:
    """scripts/bench_stream.py's stream (``make_stream``): a static texture
    with a 96×96 bright block moving 2 px down and 3 px right a frame,
    ``[STREAM_T, 480, 640]`` uint8."""
    t = STREAM_T
    rng = np.random.default_rng(salt)
    base = (rng.random((H, W)) * 96).astype(np.uint8)
    frames = np.broadcast_to(base, (t, H, W)).copy()
    for i in range(t):
        y = (120 + 2 * i) % (H - 120)
        x = (260 + 3 * i + salt) % (W - 120)
        frames[i, y : y + 96, x : x + 96] = 230
    return torch.from_numpy(frames).to(dev)


def stream_sim() -> tfs.FrameSimConfig:
    return tfs.FrameSimConfig(m=MEMSIZE, n=MEMSIZE)


def drive_stream(dev) -> dict:
    """``stream_masks`` on bench_stream.py's workload in 'auto': exactly
    STREAM_LAUNCHES (K8 once, the grasp path's K1–K4), every output equal
    to the plain route's (K8 on its plain loop too), no host
    synchronisation; timed and traced.  Then ``stream_masks_chunked`` at
    STREAM_CHUNK pairs a chunk, equal to the one-shot call, timed."""
    cfg, sim = bench_cfg(), stream_sim()
    frames = stream_frames(0, dev)

    def call(f=frames):
        return tstream.stream_masks(f, cfg, sim)

    launches, out = launched_by(call)
    if launches != STREAM_LAUNCHES:
        raise AssertionError(f"stream: launches {launches} != {STREAM_LAUNCHES}")
    keys = ("masks", "boxes", "any_active", "region_pct", "mem_gray", "w_final")
    start = time.perf_counter()
    against_plain(call, out, keys)
    plain_s = time.perf_counter() - start
    n = STREAM_T - 1
    w = out["w_final"]
    if not (out["masks"].shape == (n, H, W) and out["mem_gray"].shape == (n, H // MEMSIZE,
                                                                           W // MEMSIZE)
            and torch.isfinite(w).all() and (w >= 0).all() and (w <= 1).all()):
        raise AssertionError("the stream's outputs have the wrong shape or range")
    active = out["any_active"]
    boxes = out["boxes"]
    outside = 0
    for i in torch.nonzero(active).flatten().tolist():
        x0, y0, x1, y1 = boxes[i].tolist()
        outside += int(out["masks"][i].sum()) - int(out["masks"][i, y0:y1, x0:x1].sum())
    if not active.any() or outside:
        raise AssertionError(f"stream: active {int(active.sum())}, mask outside ROI {outside}")
    syncs = host_syncs(call)
    emit({"phase": "stream_path", "frames": STREAM_T, "frame": [H, W],
          "grid": list(out["mem_gray"].shape[1:]), "n_substeps": sim.n_substeps,
          "launches_per_call": launches, "host_syncs_per_call": sum(syncs.values()),
          "host_sync_sites": syncs, "active_pairs": int(active.sum()),
          "mask_fraction": (out["masks"] > 0).float().mean().item(),
          "mem_gray_range": [int(out["mem_gray"].min()), int(out["mem_gray"].max())],
          "plain_route_seconds": plain_s, "equal_to_plain_route": list(keys)})
    if syncs:
        raise AssertionError(f"stream synchronised with the host: {syncs}")
    variants = [(frames,)] + [(stream_frames(v, dev),) for v in (7, 14)]
    ms, samples = median_ms(call, variants)
    emit({"phase": "stream_path_time", "pairs": n, "ms_per_call": ms,
          "pairs_per_s": n / ms * 1e3, "samples_ms": samples, "card": smi_line()})
    emit(device_trace(call, ms, n, STREAM_LAUNCHES, path="stream"))

    def chunked(f=frames):
        return tstream.stream_masks_chunked(f, cfg, sim, chunk_pairs=STREAM_CHUNK)

    c_launches, c_out = launched_by(chunked)
    for key in keys:
        if not torch.equal(c_out[key], out[key]):
            raise AssertionError(f"chunked {key} differs from the one-shot call's")
    c_ms, c_samples = median_ms(chunked, variants)
    emit({"phase": "stream_chunked", "chunk_pairs": STREAM_CHUNK,
          "launches_per_call": c_launches, "equal_to_one_shot": list(keys),
          "ms_per_call": c_ms, "pairs_per_s": n / c_ms * 1e3, "samples_ms": c_samples,
          "card": smi_line()})
    return launches


def drive_events(dev) -> None:
    """``stream_masks_from_events`` on the 6×8 device grid: synthetic events
    of a 2×2-cell box crossing it, binned by the native binner, integrated
    by the event simulator (plain torch) interval by interval, gating the
    grasp path on 480×640 frames with the box drawn on the texture; the
    gate must fire and the ROI cover the box; the launches of the event
    simulation are the call's minus those of its seg_batch_fast."""
    gh, gw = H // MEMSIZE, W // MEMSIZE
    x, y, p, t = generate_synthetic_events(height=gh, width=gw, box_h=2, box_w=2,
                                           speed_pps=8, duration_s=1.0)
    frame_t = np.arange(EVENT_FPS + 1, dtype=np.int64) * (1_000_000 // EVENT_FPS)
    base = texture(H, W)[32 : 32 + H, 32 : 32 + W].astype(np.uint8)
    frames = np.broadcast_to(base, (len(frame_t), H, W)).copy()
    y0 = (gh - 2) // 2 * MEMSIZE
    for i, ts in enumerate(frame_t):
        gx0 = int(ts / 1e6 * 8)
        frames[i, y0 : y0 + 2 * MEMSIZE, gx0 * MEMSIZE : (gx0 + 2) * MEMSIZE] = 230
    frames = torch.from_numpy(frames).to(dev)
    cfg = dataclasses.replace(bench_cfg(), roi=dataclasses.replace(bench_cfg().roi, thres=20))

    def call():
        return tstream.stream_masks_from_events(x, y, p, t, frames, frame_t, cfg, (gh, gw))

    launches, out = launched_by(call)
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"event stream: launches {launches} != {EXPECTED_LAUNCHES}")
    active = out["any_active"]
    if not active.any():
        raise AssertionError("the event-driven gate never fired")
    last = int(torch.nonzero(active).flatten()[-1])
    bx0, by0, bx1, by1 = out["boxes"][last].tolist()
    gx0 = int(frame_t[last + 1] / 1e6 * 8) * MEMSIZE
    if not (bx1 > gx0 - MEMSIZE and bx0 < gx0 + 3 * MEMSIZE and by1 > y0 and by0 < y0 + 160):
        raise AssertionError(f"the event-gated ROI {out['boxes'][last].tolist()} misses the box")
    syncs = host_syncs(call)
    ms, samples = median_ms(call, [()])
    whole = device_trace(call, ms, len(frame_t) - 1, EXPECTED_LAUNCHES, path="event_stream")
    seg = device_trace(lambda: seg_batch_fast(out["mem_gate"], frames[:-1], frames[1:], cfg),
                       ms, len(frame_t) - 1, EXPECTED_LAUNCHES, path="event_stream_seg")
    n_slices = sum(max(1, -(-int(b - a) // 1000)) for a, b in zip(frame_t[:-1], frame_t[1:]))
    emit({"phase": "event_stream", "events": int(x.size), "grid": [gh, gw],
          "pairs": len(frame_t) - 1, "slices": n_slices, "launches_per_call": launches,
          "active_pairs": int(active.sum()), "last_active_box": [bx0, by0, bx1, by1],
          "host_syncs_per_call": sum(syncs.values()), "host_sync_sites": syncs,
          "ms_per_call": ms, "samples_ms": samples,
          "device_launches": whole.get("device_launches"),
          "seg_device_launches": seg.get("device_launches"),
          "event_sim_device_launches": (whole["device_launches"] - seg["device_launches"]
                                        if "device_launches" in whole and
                                        "device_launches" in seg else "not measured"),
          "card": smi_line()})
    emit(whole)


def flag1_cfg():
    """grasp_sep (FLAG=1, k_max 8, 320×320 region windows, per-region head)
    at the main path's 640×480, 256×384 head window, memsize 80."""
    cfg = dataclasses.replace(DATASETS["grasp_sep"], name="grasp_sep640", image_h=H,
                              image_w=W, window_h=WIN[0], window_w=WIN[1],
                              warp_radius=RADIUS)
    return dataclasses.replace(cfg, roi=dataclasses.replace(cfg.roi, memsize=MEMSIZE))


def drive_flag1(dev) -> None:
    """The FLAG=1 stages (:func:`drive_dual` on ``flag1_cfg``) with two
    components on the 6×8 state map, whose EXTEND-padded regions overlap."""
    mem = torch.zeros((H // MEMSIZE, W // MEMSIZE), dtype=torch.uint8, device=dev)
    mem[2:4, 2:3] = 255
    mem[2:4, 4:6] = 255
    drive_dual(dev, flag1_cfg(), mem, phase="flag1_stages")


def engine_requests(n: int) -> list[tuple]:
    """``n`` single-pair requests of the main path's workload as host
    arrays: bench.py's texture at six offsets in turn, each moved by
    (2, -1) px, and a 6×8 state map with a 2×2 block active at a seeded
    place."""
    base = texture(H, W)
    pairs = [(np.ascontiguousarray(base[16 + v : 16 + v + H, 16 : 16 + W].astype(np.uint8)),
              np.ascontiguousarray(base[18 + v : 18 + v + H, 15 : 15 + W].astype(np.uint8)))
             for v in range(6)]
    rng = np.random.default_rng(5)
    reqs = []
    for i in range(n):
        mem = np.zeros((H // MEMSIZE, W // MEMSIZE), np.uint8)
        y, x = rng.integers(0, H // MEMSIZE - 1), rng.integers(0, W // MEMSIZE - 1)
        mem[y : y + 2, x : x + 2] = 255
        reqs.append((mem, *pairs[i % 6]))
    return reqs


def engine_breakdown(eng: BatchingEngine, reqs: list, dev) -> dict:
    """Host-clock ms of the parts of one full dispatch (ENGINE_MAX_BATCH
    requests), each ended by a synchronisation, median of 5: the requests
    stacked into pinned memory, their upload, seg_batch_fast, the outputs'
    download; and the engine's whole dispatch (``_execute``) beside them,
    with its results dropped at once and with them kept, as callers keep
    theirs (the outputs come back in pinned memory, which a kept result
    holds, so the next dispatch must allocate anew)."""
    cols = [[r[j] for r in reqs[:ENGINE_MAX_BATCH]] for j in range(3)]
    pinned = [torch.empty((len(c),) + c[0].shape, dtype=torch.uint8, pin_memory=True)
              for c in cols]
    parts = collections.defaultdict(list)
    kept = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c, buf in zip(cols, pinned):
            np.stack(c, out=buf.numpy())
        t1 = time.perf_counter()
        args = [buf.to(dev, non_blocking=True) for buf in pinned]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = seg_batch_fast(*args, eng.cfg)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        host = {k: v.to("cpu", non_blocking=True) for k, v in out.items()}
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        eng._execute(*cols)
        t5 = time.perf_counter()
        kept.append(eng._execute(*cols))
        t6 = time.perf_counter()
        for name, dt in (("stack_pinned", t1 - t0), ("upload", t2 - t1), ("device", t3 - t2),
                         ("download", t4 - t3), ("dispatch", t5 - t4),
                         ("dispatch_results_kept", t6 - t5)):
            parts[name].append(dt * 1e3)
    up = sum(b.numel() for b in pinned)
    down = sum(v.numel() * v.element_size() for v in host.values())
    med = {k: float(np.median(v)) for k, v in parts.items()}
    return {"batch": ENGINE_MAX_BATCH, "ms": med, "upload_bytes": up, "download_bytes": down,
            "upload_gb_per_s": up / med["upload"] / 1e6,
            "download_gb_per_s": down / med["download"] / 1e6,
            "requests_per_s_bound": ENGINE_MAX_BATCH / med["dispatch"] * 1e3}


def drive_engine(dev) -> None:
    """The batching engine on the main path's workload: max_batch
    ENGINE_MAX_BATCH, default buckets, warmed up; ENGINE_REQUESTS requests
    from ENGINE_THREADS threads, each result equal bit for bit to the
    direct ``seg_batch_fast`` of the padded batch it was dispatched in;
    K1–K4 launched EXPECTED_LAUNCHES times a dispatch; host
    synchronisations of one dispatch; requests a second and p50/p99
    latency, beside the device-resident batch's time and the parts of one
    dispatch."""
    cfg = bench_cfg()
    eng = BatchingEngine(cfg, max_batch=ENGINE_MAX_BATCH)
    try:
        start = time.perf_counter()
        eng.warmup()
        warm_s = time.perf_counter() - start
        # record each dispatch's futures and its padded batch on the device
        records = []
        dispatch, run = eng._dispatch, eng._run

        def recording_dispatch(batch):
            records.append({"futures": [item[3] for item in batch],
                            "start": time.perf_counter()})
            dispatch(batch)
            records[-1]["end"] = time.perf_counter()

        def recording_run(m, p, n):
            records[-1]["inputs"] = (m, p, n)
            records[-1]["run_start"] = time.perf_counter()
            out = run(m, p, n)
            records[-1]["run_end"] = time.perf_counter()
            return out

        eng._dispatch, eng._run = recording_dispatch, recording_run
        reqs = engine_requests(ENGINE_REQUESTS)
        futs = [None] * len(reqs)
        sent = [0.0] * len(reqs)
        done = [0.0] * len(reqs)
        per_client = len(reqs) // ENGINE_THREADS

        def client(c):
            for i in range(c * per_client, (c + 1) * per_client):
                sent[i] = time.perf_counter()
                fut = eng.submit(*reqs[i])
                fut.add_done_callback(lambda _, i=i: done.__setitem__(i, time.perf_counter()))
                futs[i] = fut

        torch.cuda.synchronize()
        _build.reset_launches()
        clients = [threading.Thread(target=client, args=(c,)) for c in range(ENGINE_THREADS)]
        t0 = time.perf_counter()
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=600)
        results = [f.result(timeout=600) for f in futs]
        wall_s = max(done) - t0
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        eng._dispatch, eng._run = dispatch, run
        n_disp = len(records)
        expected = {k: v * n_disp for k, v in EXPECTED_LAUNCHES.items()}
        if launches != expected:
            raise AssertionError(f"engine: launches {launches} != {expected} ({n_disp} dispatches)")
        index = {id(f): i for i, f in enumerate(futs)}
        checked = 0
        for rec in records:
            ref = {k: v.cpu().numpy() for k, v in seg_batch_fast(*rec["inputs"], cfg).items()}
            for row, fut in enumerate(rec["futures"]):
                got = results[index[id(fut)]]
                for k, v in ref.items():
                    if not np.array_equal(got[k], v[row]):
                        raise AssertionError(f"engine request {index[id(fut)]}: {k} differs "
                                             "from the direct seg_batch_fast of its batch")
                checked += 1
        if checked != len(reqs) or not all(r["any_active"] for r in results):
            raise AssertionError(f"engine: {checked} of {len(reqs)} results checked")
        # each dispatch in the traffic: its start and end, and its parts on
        # the host clock: stacking and the uploads' enqueue, seg_batch_fast's
        # enqueue, then the downloads, the one sync and the futures
        spans = [{"start": (r["start"] - t0) * 1e3, "end": (r["end"] - t0) * 1e3,
                  "requests": len(r["futures"]),
                  "stack_upload_ms": (r["run_start"] - r["start"]) * 1e3,
                  "enqueue_ms": (r["run_end"] - r["run_start"]) * 1e3,
                  "download_sync_results_ms": (r["end"] - r["run_end"]) * 1e3}
                 for r in records]
        del records
        syncs = host_syncs(lambda: eng.submit(*reqs[0]).result(timeout=60))
        lat = np.array([d - s for s, d in zip(sent, done)]) * 1e3
        resident, _ = median_ms(lambda m, p, n: seg_batch_fast(m, p, n, cfg),
                                [bench_inputs(ENGINE_MAX_BATCH, v, dev) for v in range(3)])
        emit({"phase": "engine", "requests": len(reqs), "threads": ENGINE_THREADS,
              "max_batch": ENGINE_MAX_BATCH, "buckets": list(eng.buckets),
              "warmup_s": warm_s, "stats": eng.stats.as_dict(), "dispatches": n_disp,
              "launches": launches, "launches_per_dispatch": EXPECTED_LAUNCHES,
              "host_syncs_per_dispatch": sum(syncs.values()), "host_sync_sites": syncs,
              "equal_to_direct_batches": checked, "wall_s": wall_s,
              "dispatch_spans_ms": spans,
              "requests_per_s": len(reqs) / wall_s,
              "latency_ms": {"p50": float(np.percentile(lat, 50)),
                             "p99": float(np.percentile(lat, 99)), "max": float(lat.max())},
              "device_resident_ms_per_batch": resident,
              "device_resident_requests_per_s": ENGINE_MAX_BATCH / resident * 1e3,
              "dispatch_parts": engine_breakdown(eng, reqs, dev), "card": smi_line()})
    finally:
        eng.shutdown()


def b64png(img: np.ndarray) -> str:
    return base64.b64encode(encode_png(img)).decode()


def http(port: int, path: str, body=None) -> tuple[int, bytes, float]:
    """One request to the demo server: status, body and ms on the host
    clock."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    start = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            code, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, raw = e.code, e.read()
    return code, raw, (time.perf_counter() - start) * 1e3


def served_grasp_cfg():
    """The server's grasp preset for 480×640 uploads: the whole frame as the
    window and the device grid snapped to the largest cell size ≤ min(h, w)
    / 8 that divides both sides, 40 px (a 12×16 grid)."""
    cfg = dataclasses.replace(DATASETS["grasp"], image_h=H, image_w=W, window_h=None,
                              window_w=None)
    return dataclasses.replace(cfg, roi=dataclasses.replace(cfg.roi, memsize=40))


def drive_serve(dev) -> None:
    """The demo server on the card: GET / and /api/health; SERVE_FLOWS
    POST /api/flow with 480×640 PNG pairs of the stream's moving block,
    preset grasp, each launching K8 once and K1–K4 as the stream does, its
    box, any_active, region_pct and mask equal to the direct stream_masks
    and seg_step; SERVE_FLOWS POST /api/segment with a PNG holding one
    bright square (no local OWL-ViT or SAM weights: the brightness
    fallback); a JPEG payload answered with 400.  Prints each endpoint's ms per request."""
    srv = make_server(port=0)
    port = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        ms = {}
        code, page, ms["page"] = http(port, "/")
        if code != 200 or b"nsof_tpu_torch" not in page:
            raise AssertionError(f"GET / gave {code}")
        code, raw, ms["health"] = http(port, "/api/health")
        health = json.loads(raw)
        if code != 200 or health["device_name"] != torch.cuda.get_device_name(dev):
            raise AssertionError(f"/api/health gave {code} {health}")
        frames = stream_frames(0, dev)[: SERVE_FLOWS + 1]
        host = frames.cpu().numpy()
        cfg, sim = served_grasp_cfg(), tfs.FrameSimConfig(m=40, n=40)
        ms["flow"], flows = [], []
        for i in range(SERVE_FLOWS):
            body = {"prev": b64png(host[i]), "next": b64png(host[i + 1]), "preset": "grasp"}
            torch.cuda.synchronize()
            _build.reset_launches()
            code, raw, dt = http(port, "/api/flow", body)
            torch.cuda.synchronize()
            launches = {k: v for k, v in _build.LAUNCHES.items() if v}
            if code != 200:
                raise AssertionError(f"/api/flow gave {code}: {raw[:300]}")
            if launches != STREAM_LAUNCHES:
                raise AssertionError(f"/api/flow: launches {launches} != {STREAM_LAUNCHES}")
            ms["flow"].append(dt)
            out = json.loads(raw)
            s = tstream.stream_masks(frames[i : i + 2], cfg, sim)
            step = seg_step(s["mem_gray"][0], frames[i], frames[i + 1], cfg)
            mask = decode_png(base64.b64decode(out["mask"].split(",")[1]), gray=True)
            if not (out["box"] == step["box"].tolist()
                    and out["any_active"] == bool(s["any_active"][0])
                    and out["region_pct"] == float(s["region_pct"][0])
                    and np.array_equal(mask, s["masks"][0].cpu().numpy())
                    and np.isfinite(out["mean_mag"])):
                raise AssertionError(f"/api/flow {i} differs from the direct stream and step")
            flows.append({k: out[k] for k in ("box", "any_active", "region_pct", "mean_mag")})
        ms["segment"] = []
        for i in range(SERVE_FLOWS):
            img = np.repeat(host[i][..., None], 3, axis=-1)
            img[100:196, 200 + 10 * i : 296 + 10 * i] = 255
            code, raw, dt = http(port, "/api/segment", {"image": b64png(img), "prompt": "bright"})
            seg = json.loads(raw)
            if code != 200 or seg["backend"] != "brightness-fallback" or seg["n_instances"] != 1:
                raise AssertionError(f"/api/segment gave {code} {str(seg)[:300]}")
            ms["segment"].append(dt)
        jpeg = base64.b64encode(b"\xff\xd8\xff\xe0" + bytes(64)).decode()
        code, raw, ms["rejected_jpeg"] = http(port, "/api/segment", {"image": jpeg})
        if code != 400 or "PNG" not in json.loads(raw)["error"]:
            raise AssertionError(f"a JPEG payload gave {code} {raw[:300]}")
        emit({"phase": "serve", "frame": [H, W], "preset": "grasp", "grid_cell": 40,
              "flow_launches_per_request": STREAM_LAUNCHES, "flows": flows,
              "segment_instances": seg["n_instances"], "health": health, "ms": ms,
              "flow_ms_median": float(np.median(ms["flow"])),
              "segment_ms_median": float(np.median(ms["segment"])), "card": smi_line()})
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)


def block_masks(t: int) -> np.ndarray:
    """The GT of stream_frames(0)'s first ``t`` frames: its moving block."""
    gt = np.zeros((t, H, W), np.uint8)
    for i in range(t):
        y, x = (120 + 2 * i) % (H - 120), (260 + 3 * i) % (W - 120)
        gt[i, y : y + 96, x : x + 96] = 255
    return gt


def runner_scene(dev):
    """(SceneData, gray frames on the card, state maps): the stream's first
    SCENE_FRAMES frames at 640×480, BGR mixed from the gray, the moving block
    as GT; pair t gated by the stream's state map after pair t."""
    cfg = bench_cfg()
    frames = stream_frames(0, dev)[:SCENE_FRAMES]
    mem = tstream.stream_masks(frames, cfg, stream_sim())["mem_gray"]
    mem = torch.cat([mem[:1], mem]).cpu().numpy()
    scene = SceneData(cfg, bgr(frames).cpu().numpy(), frames.cpu().numpy(), mem,
                      block_masks(SCENE_FRAMES), [f"{i:04d}.png" for i in range(SCENE_FRAMES)])
    return scene, frames, mem


def drive_runner(dev) -> None:
    """The scene runners on a SceneData of the stream's first SCENE_FRAMES
    frames at 640×480 (BGR mixed from the gray, the block as GT), pair t
    gated by the stream's state map after pair t: each runner writes its
    CSV and text log; the headers are the reference schemas and hold one
    row a pair; the masks, boxes and predictions equal the stages called
    directly; no kernel is launched (the exact path)."""
    cfg = bench_cfg()
    scene, frames, mem = runner_scene(dev)
    n = scene.num_pairs
    runs = (("segmentation", trunner.run_segmentation, reporting.SEG_COLUMNS),
            ("tracking", trunner.run_tracking, reporting.OB_COLUMNS),
            ("prediction", trunner.run_prediction, reporting.PRED_COLUMNS))
    with tempfile.TemporaryDirectory() as tmp:
        results = {}
        torch.cuda.synchronize()
        _build.reset_launches()
        for name, run, columns in runs:
            csv_path, txt_path = pathlib.Path(tmp) / f"{name}.csv", pathlib.Path(tmp) / f"{name}.txt"
            start = time.perf_counter()
            results[name] = run(scene, csv_path, txt_path)
            seconds = time.perf_counter() - start
            lines = csv_path.read_text().splitlines()
            if lines[0] != ",".join(columns) or len(lines) != n + 1:
                raise AssertionError(f"{name}: CSV header {lines[0]!r}, {len(lines) - 1} rows")
            if len(txt_path.read_text().splitlines()) != n + 1:
                raise AssertionError(f"{name}: the text log has the wrong length")
            res = results[name]
            emit({"phase": "runner", "pipeline": name, "pairs": n, "frame": [H, W],
                  "window": list(cfg.win_shape), "seconds": seconds,
                  "timing": {k: v for k, v in res.timing.items() if k != "stage_totals_s"},
                  "stage_ms_per_pair": {k: v * 1e3 / n
                                        for k, v in res.timing["stage_totals_s"].items()},
                  "metrics": res.metrics, "card": smi_line()})
        torch.cuda.synchronize()
        launched = {k: v for k, v in _build.LAUNCHES.items() if v}
    if launched:
        raise AssertionError(f"the runners launched kernels: {launched}")
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    seg, trk, prd = seg_stages(cfg), tracking_stages(cfg), prediction_stages(cfg)
    for i in range(n):
        m, p, nx = up(mem[i + 1]), frames[i], frames[i + 1]
        roi = seg["cal"](m)
        fw, ib = seg["vel"](p, nx, m, roi)
        full = seg["vel_full"](p, nx)
        direct = {
            ("segmentation", "masks"): seg["comb"](seg["task"](fw, ib), roi["box"], roi["origin"]),
            ("segmentation", "masks_full"): seg["task_full"](full),
        }
        box = trk["task"](fw, ib, roi["origin"], roi["active"])
        box_full = trk["task_full"](full)
        direct.update({("tracking", "boxes"): box["boxes"],
                       ("tracking", "boxes_valid"): box["valid"],
                       ("tracking", "boxes_full"): box_full["boxes"],
                       ("tracking", "boxes_full_valid"): box_full["valid"]})
        frame = up(scene.frames_bgr[i + 1])
        flow = prd["comb"](fw, roi["box"], roi["origin"])
        direct[("prediction", "preds")] = prd["task"](frame, flow, roi["box"], roi["active"])
        direct[("prediction", "preds_full")] = prd["task_full"](frame, full)
        for (name, key), ref in direct.items():
            if not np.array_equal(getattr(results[name], key)[i], ref.cpu().numpy()):
                raise AssertionError(f"runner {name}: {key} of pair {i} differs from the stages'")


def drive_cli(dev) -> None:
    """The CLI in a process of its own on a folder of the stream's first
    SCENE_FRAMES frames as 480×640 PNGs: ``stream --preset grasp``, whose
    mask files equal stream_masks_chunked's on the card, and ``flow`` on
    three of the frames, whose images equal the exact Farnebäck's coloured
    by flow_to_image on the card."""
    frames = stream_frames(0, dev)[:SCENE_FRAMES]
    host = frames.cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        d = pathlib.Path(tmp)
        for sub, count in (("frames", SCENE_FRAMES), ("three", 3)):
            (d / sub).mkdir()
            for i in range(count):
                (d / sub / f"{i}.png").write_bytes(encode_png(host[i]))
        seconds = {}
        for name, args in (("stream", ["stream", "--frames", str(d / "frames"), "--preset",
                                       "grasp", "--out", str(d / "masks")]),
                           ("flow", ["flow", "--frames", str(d / "three"), "--preset", "grasp",
                                     "--out", str(d / "flows")])):
            start = time.perf_counter()
            subprocess.run([sys.executable, "-m", "nsof_tpu_torch.cli", *args, *CLI_ARGS],
                           check=True, cwd=ROOT, capture_output=True, text=True, timeout=600)
            seconds[name] = time.perf_counter() - start
        # the CLI's grasp preset at the frames' size: the whole frame as the
        # window, memsize 80 (a 6×8 grid), chunks of 64 pairs
        cfg = dataclasses.replace(DATASETS["grasp"], image_h=H, image_w=W, window_h=None,
                                  window_w=None)
        sim = tfs.FrameSimConfig(m=cfg.roi.memsize, n=cfg.roi.memsize)
        ref = tstream.stream_masks_chunked(frames, cfg, sim, chunk_pairs=64)["masks"]
        ref = ref.cpu().numpy()
        for i in range(SCENE_FRAMES - 1):
            got = decode_png((d / "masks" / f"mask_{i + 1}.png").read_bytes(), gray=True)
            if not np.array_equal(got, ref[i]):
                raise AssertionError(f"CLI stream: mask {i + 1} differs from stream_masks_chunked")
        for i in range(2):
            got = decode_png((d / "flows" / f"flow_{i}.png").read_bytes())
            flow = farneback(frames[i], frames[i + 1], PRESETS["grasp"])
            if not np.array_equal(got, flow_to_image(flow).cpu().numpy()):
                raise AssertionError(f"CLI flow: image {i} differs from the direct one")
        ev = drive_eventsim_cli(d / "eventsim", seconds)
    emit({"phase": "cli", "frames": SCENE_FRAMES, "frame": [H, W], "seconds": seconds,
          "masks_equal": SCENE_FRAMES - 1, "active_masks": int((ref > 0).any(axis=(1, 2)).sum()),
          "flow_images_equal": 2, **ev})


def drive_eventsim_cli(ev: pathlib.Path, seconds: dict) -> dict:
    """``eventsim --synthetic --no-video`` in a process of its own in ``ev``
    (the stream simulated in memory where h5py is not installed), then
    ``visualize`` on the npz it writes: the resistances finite, one keyframe
    every EVENT_KEY_EVERY frames in ``manifest.json``, each a PNG of the
    grid's shape."""
    ev.mkdir()
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")]))}
    runs = (("eventsim", ["eventsim", "--synthetic", "--no-video", *CLI_ARGS]),
            ("visualize", ["visualize", "synthetic.V1.npz", "--mode", "delta", "--value",
                           "state", "--key-every", str(EVENT_KEY_EVERY)]))
    printed = {}
    for name, args in runs:
        start = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "nsof_tpu_torch.cli", *args], cwd=ev,
                              env=env, capture_output=True, text=True, timeout=600)
        seconds[name] = time.perf_counter() - start
        if proc.returncode != 0:
            raise AssertionError(f"CLI {name}: exit {proc.returncode}\n{proc.stderr}")
        printed[name] = proc.stdout.strip().splitlines()[0]
    res = np.load(ev / "synthetic.V1.npz")["resistances"]
    manifest = json.loads((ev / "synthetic.V1_keyframes" / "manifest.json").read_text())
    want = -(-res.shape[0] // EVENT_KEY_EVERY)
    if not np.isfinite(res).all() or len(manifest["frames"]) != want:
        raise AssertionError(f"CLI eventsim/visualize: {res.shape} resistances, "
                             f"{len(manifest['frames'])} keyframes (want {want})")
    for frame in manifest["frames"]:
        img = decode_png((ev / "synthetic.V1_keyframes" / frame["path"]).read_bytes())
        if img.shape != (*res.shape[1:], 3):
            raise AssertionError(f"CLI visualize: keyframe {frame['path']} is {img.shape}")
    return {"eventsim": {"resistances": list(res.shape), "keyframes": len(manifest["frames"]),
                         "key_every": EVENT_KEY_EVERY,
                         "hdf5_written": (ev / "synthetic.hdf5").exists(),
                         "printed": printed["eventsim"]}}


def deep_cfg():
    return dataclasses.replace(DATASETS["grasp"], name="deep640", image_h=DEEP_H, image_w=DEEP_W,
                               window_h=DEEP_WIN[0], window_w=DEEP_WIN[1])


def deep_inputs(dev):
    """scripts/bench_deep.py's workload A on the card: the 18×24 state map
    with a 3×3-cell block active, and six RGB frame variants of one texture,
    each next frame moved by (2, -1) px from its previous one."""
    rng = np.random.default_rng(0)
    base = rng.random((DEEP_H + 64, DEEP_W + 64, 3)).astype(np.float32) * 255
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.astype(np.uint8))).to(dev)  # noqa: E731
    prevs = [t(base[16 + v: 16 + v + DEEP_H, 16: 16 + DEEP_W]) for v in range(6)]
    nxts = [t(base[18 + v: 18 + v + DEEP_H, 15: 15 + DEEP_W]) for v in range(6)]
    ms = deep_cfg().roi.memsize // 3
    mem = np.zeros((DEEP_H // ms, DEEP_W // ms), np.uint8)
    mem[3:6, 4:7] = 255
    return torch.from_numpy(mem).to(dev), prevs, nxts


def deep_model(kind: str):
    """A deep model with random weights from torch's generator seeded with
    0: RAFT-basic at the published raft-things widths (its cnet
    'frozenbatch', as a converted checkpoint runs), RAFT-small, or FlowFormer
    at things_eval's."""
    torch.manual_seed(0)
    if kind == "raft-basic":
        return RAFT(RaftConfig(cnet_norm="frozenbatch", iters=DEEP_ITERS))
    if kind == "raft-small":
        return RAFT(RaftConfig(small=True, corr_radius=3, iters=DEEP_ITERS))
    return FlowFormer(get_experiment("things_eval").model)


def deep_backend(kind: str, dev):
    """(the card's backend, the same weights as a CPU backend)."""
    model = deep_model(kind)
    cpu = copy.deepcopy(model)
    if kind == "flowformer":
        return DeepBackend.from_flowformer(model, device=dev), DeepBackend.from_flowformer(
            cpu, device="cpu")
    return (DeepBackend.from_raft(model, DEEP_ITERS, device=dev),
            DeepBackend.from_raft(cpu, DEEP_ITERS, device="cpu"))


def f32_convs():
    """cuDNN convolutions in float32 (PyTorch lets them take TF32 on Hopper
    by default); matrix products are float32 unless a caller allows TF32."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matrix products are on")
    return torch.backends.cudnn.flags(enabled=True, benchmark=torch.backends.cudnn.benchmark,
                                      deterministic=torch.backends.cudnn.deterministic,
                                      allow_tf32=False)


def flops_of(call) -> float:
    """Floating-point operations of one call, counted by PyTorch's
    FlopCounterMode from the shapes of its matrix products and
    convolutions (elementwise work, softmax and gathers not counted)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        call()
    return float(counter.get_total_flops())


def deep_crop_check(frames: torch.Tensor, box: torch.Tensor) -> None:
    """K1 on RGB frames (a 3-byte element) at the deep window's origins
    equal to the plain crop, bit for bit."""
    oys, oxs = troi.window_origin(box, *DEEP_WIN, DEEP_H, DEEP_W)
    got = troi.crop_windows_batch(frames, oys, oxs, *DEEP_WIN)
    if not torch.equal(got, troi.crop_windows(frames, oys, oxs, *DEEP_WIN)):
        raise AssertionError("K1 on the deep RGB crop differs from the plain crop")


def flow_err(card: torch.Tensor, cpu: torch.Tensor, tol: float, what: str) -> float:
    if not torch.isfinite(card).all():
        raise AssertionError(f"{what}: the card's flow is not finite")
    err = (card.cpu() - cpu.cpu()).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{what}: the card's flow is {err} px from the reference's")
    return err


def drive_deep_raft(dev):
    """``deep_roi_flow_step`` and ``deep_full_flow_step`` on RAFT-basic:
    K1 launched twice a ROI step (and equal to the plain crop, the whole
    step equal to the plain route's); no host synchronisation inside the
    model or the step; the ROI flow within DEEP_FLOW_TOL of the port's on
    the CPU for the same pair and weights (float32 convolutions on the
    card), and within DEEP_TF32_TOL at PyTorch's defaults (TF32
    convolutions); then timed at the defaults and in float32, with the ROI
    speed-up, FLOPs a pair and a trace.  Returns the
    backend and the ROI step's float32 output, for the 'alternate' phase."""
    cfg = deep_cfg()
    mem, prevs, nxts = deep_inputs(dev)
    backend, cpu_backend = deep_backend("raft-basic", dev)

    def roi(m=mem, p=prevs[0], n=nxts[1]):
        return deep_roi_flow_step(m, p, n, cfg, backend)

    def full(m=mem, p=prevs[0], n=nxts[1]):
        return deep_full_flow_step(p, n, cfg, backend)

    with f32_convs():
        launches, out = launched_by(roi)
        if launches != DEEP_LAUNCHES:
            raise AssertionError(f"deep_raft: launches {launches} != {DEEP_LAUNCHES}")
        against_plain(roi, out, ("flow", "mask", "box", "any_active"))
        deep_crop_check(prevs[0][None], out["box"][None])
        if not bool(out["any_active"]):
            raise AssertionError("deep_raft: the ROI is not active")
        oys, oxs = troi.window_origin(out["box"][None], *DEEP_WIN, DEEP_H, DEEP_W)
        wins = [troi.crop_windows_batch(x[None], oys, oxs, *DEEP_WIN) for x in (prevs[0], nxts[1])]
        model_syncs = host_syncs(lambda: backend.apply(*wins))
        step_syncs = host_syncs(roi)
        if model_syncs or step_syncs:
            raise AssertionError(f"deep_raft synchronised: {model_syncs} {step_syncs}")
        ref = deep_roi_flow_step(mem.cpu(), prevs[0].cpu(), nxts[1].cpu(), cfg, cpu_backend)
        err = flow_err(out["flow"], ref["flow"], DEEP_FLOW_TOL, "deep_raft ROI")
        mask_eq = (out["mask"].cpu() == ref["mask"]).float().mean().item()
        if not (torch.equal(out["box"].cpu(), ref["box"]) and mask_eq >= DEEP_MASK_EQUAL):
            raise AssertionError(f"deep_raft: box or mask differs from the CPU's ({mask_eq})")
        full_out = full()
        if not torch.isfinite(full_out["flow"]).all():
            raise AssertionError("deep_raft: the full-frame flow is not finite")
        roi_f32, _ = median_ms(roi, [(mem, prevs[v], nxts[(v + 1) % 6]) for v in range(3)])
    tf32 = roi()
    err_tf32 = flow_err(tf32["flow"], ref["flow"], DEEP_TF32_TOL, "deep_raft ROI at the defaults")
    mask_eq_tf32 = (tf32["mask"].cpu() == ref["mask"]).float().mean().item()
    if not (torch.equal(tf32["box"].cpu(), ref["box"]) and mask_eq_tf32 >= DEEP_MASK_EQUAL):
        raise AssertionError(f"deep_raft at the defaults: box or mask differs ({mask_eq_tf32})")
    variants = [(mem, prevs[v], nxts[(v + 1) % 6]) for v in range(3)]
    roi_ms, roi_samples = median_ms(roi, variants)
    full_ms, full_samples = median_ms(full, variants)
    pad = [torch.zeros((1, DEEP_H, DEEP_W, 3), dtype=torch.uint8, device=dev)] * 2
    emit({"phase": "deep_raft", "model": "raft-basic (raft-things widths, cnet frozenbatch)",
          "iters": DEEP_ITERS, "frame": [DEEP_H, DEEP_W], "window": list(DEEP_WIN),
          "launches_per_roi_step": launches, "host_syncs_model": model_syncs,
          "host_syncs_roi_step": step_syncs, "roi_box": out["box"].tolist(),
          "flow_max_abs_err_vs_cpu": err, "tolerance_px": DEEP_FLOW_TOL,
          "mask_equal_vs_cpu": mask_eq, "max_abs_flow": out["flow"].abs().max().item(),
          "parity_precision": "float32 (cuDNN TF32 off)",
          "flow_max_abs_err_vs_cpu_at_defaults": err_tf32,
          "tolerance_px_at_defaults": DEEP_TF32_TOL, "mask_equal_vs_cpu_at_defaults": mask_eq_tf32,
          "cudnn_allow_tf32_at_defaults": torch.backends.cudnn.allow_tf32,
          "roi_ms": roi_ms, "full_ms": full_ms, "roi_speedup": full_ms / roi_ms,
          "roi_ms_f32_convs": roi_f32, "timing_precision": "PyTorch defaults: cuDNN "
          "convolutions may use TF32, matrix products float32",
          "samples_ms": {"roi": roi_samples, "full": full_samples},
          "gflops_per_pair": {"roi": flops_of(lambda: backend.apply(*wins)) / 1e9,
                              "full": flops_of(lambda: backend.apply(*pad)) / 1e9},
          "card": smi_line()})
    emit(device_trace(roi, roi_ms, 1, ("crop_windows",), path="deep_raft_roi"))
    return backend, out


def drive_deep_alt(dev, backend, allpairs_out) -> None:
    """The same RAFT-basic weights with ``corr_mode='alternate'``: its ROI
    flow within DEEP_ALT_TOL of the all-pairs one on the card (float32
    convolutions), K1 launched twice; timed."""
    cfg = deep_cfg()
    mem, prevs, nxts = deep_inputs(dev)
    model = backend.model
    saved = model.cfg
    model.cfg = dataclasses.replace(saved, corr_mode="alternate")
    try:
        def roi(m=mem, p=prevs[0], n=nxts[1]):
            return deep_roi_flow_step(m, p, n, cfg, backend)

        with f32_convs():
            launches, out = launched_by(roi)
            err = flow_err(out["flow"], allpairs_out["flow"], DEEP_ALT_TOL, "deep_alt")
        if launches != DEEP_LAUNCHES:
            raise AssertionError(f"deep_alt: launches {launches} != {DEEP_LAUNCHES}")
        ms, samples = median_ms(roi, [(mem, prevs[v], nxts[(v + 1) % 6]) for v in range(3)])
    finally:
        model.cfg = saved
    emit({"phase": "deep_alt", "model": "raft-basic, corr_mode='alternate'",
          "launches_per_roi_step": launches, "flow_max_abs_err_vs_allpairs": err,
          "tolerance_px": DEEP_ALT_TOL, "roi_ms": ms, "samples_ms": samples,
          "card": smi_line()})


def deep_batch_inputs(dev):
    """DEEP_B samples of workload A: variant i % 6 and its next frame, the
    active block moved right by i % 4 cells."""
    b = DEEP_B
    mem, prevs, nxts = deep_inputs(dev)
    mems = mem[None].repeat(b, 1, 1)
    for i in range(b):
        mems[i] = torch.roll(mem, shifts=i % 4, dims=1)
    return (mems, torch.stack([prevs[i % 6] for i in range(b)]),
            torch.stack([nxts[(i + 1) % 6] for i in range(b)]))


def drive_deep_batch(dev) -> dict:
    """``deep_roi_flow_batch`` at B = DEEP_B on RAFT-small and RAFT-basic:
    K1 twice a batch and equal to the plain crop (the batch equal to the
    plain route's), each sample within DEEP_FLOW_TOL of its own
    ``deep_roi_flow_step`` (float32 convolutions), the batch at PyTorch's
    defaults within DEEP_TF32_TOL of the float32 one, timed.  Then
    ``BatchingEngine.for_deep_backend`` on RAFT-small (max_batch DEEP_B)
    serving DEEP_ENGINE_REQUESTS requests from DEEP_ENGINE_THREADS threads:
    each result equal to the direct ``deep_roi_flow_batch`` of the padded
    batch it went in; requests a second and p50/p99 latency.  Returns the
    RAFT-basic batch's launch counts."""
    cfg = deep_cfg()
    mems, prevs, nxts = deep_batch_inputs(dev)
    result = {}
    for kind in ("raft-small", "raft-basic"):
        backend, _ = deep_backend(kind, dev)

        def call(m=mems, p=prevs, n=nxts):
            return deep_roi_flow_batch(m, p, n, cfg, backend)

        with f32_convs():
            launches, out = launched_by(call)
            if launches != DEEP_LAUNCHES:
                raise AssertionError(f"deep_batch {kind}: launches {launches}")
            against_plain(call, out, ("flow", "mask", "box", "any_active"))
            deep_crop_check(prevs, out["box"])
            err, mask_eq = 0.0, 1.0
            for i in range(DEEP_B):
                one = deep_roi_flow_step(mems[i], prevs[i], nxts[i], cfg, backend)
                err = max(err, flow_err(out["flow"][i], one["flow"], DEEP_FLOW_TOL,
                                        f"deep_batch {kind} sample {i}"))
                mask_eq = min(mask_eq, (out["mask"][i] == one["mask"]).float().mean().item())
                if not torch.equal(out["box"][i], one["box"]):
                    raise AssertionError(f"deep_batch {kind}: box {i} differs from its step's")
            if mask_eq < DEEP_MASK_EQUAL or not out["any_active"].all():
                raise AssertionError(f"deep_batch {kind}: masks {mask_eq} equal")
        tf32 = call()
        err_tf32 = flow_err(tf32["flow"], out["flow"], DEEP_TF32_TOL,
                            f"deep_batch {kind} at the defaults")
        mask_eq_tf32 = (tf32["mask"] == out["mask"]).float().mean().item()
        if not (torch.equal(tf32["box"], out["box"]) and mask_eq_tf32 >= DEEP_MASK_EQUAL):
            raise AssertionError(f"deep_batch {kind} at the defaults: masks {mask_eq_tf32} equal")
        ms, samples = median_ms(call, [(mems, prevs, nxts), (mems, nxts, prevs)])
        emit({"phase": "deep_batch", "model": kind, "batch": DEEP_B, "launches": launches,
              "flow_max_abs_err_vs_steps": err, "tolerance_px": DEEP_FLOW_TOL,
              "mask_equal_min_vs_steps": mask_eq,
              "flow_max_abs_err_at_defaults_vs_tf32_off": err_tf32,
              "tolerance_px_at_defaults": DEEP_TF32_TOL,
              "mask_equal_at_defaults_vs_tf32_off": mask_eq_tf32, "ms_per_batch": ms,
              "pairs_per_s": DEEP_B / ms * 1e3, "samples_ms": samples, "card": smi_line()})
        result[kind] = (launches, backend)
    drive_deep_engine(dev, result["raft-small"][1])
    return result["raft-basic"][0]


def drive_deep_engine(dev, backend) -> None:
    cfg = deep_cfg()
    mem, prevs, nxts = deep_inputs(dev)
    eng = BatchingEngine.for_deep_backend(cfg, backend, max_batch=DEEP_B)
    try:
        start = time.perf_counter()
        eng.warmup()
        warm_s = time.perf_counter() - start
        records = []
        dispatch, run = eng._dispatch, eng._run

        def recording_dispatch(batch):
            records.append({"futures": [item[3] for item in batch]})
            dispatch(batch)

        def recording_run(m, p, n):
            records[-1]["inputs"] = (m, p, n)
            return run(m, p, n)

        eng._dispatch, eng._run = recording_dispatch, recording_run
        host = [x.cpu().numpy() for x in prevs], [x.cpu().numpy() for x in nxts]
        grid = mem.cpu().numpy()
        reqs = [(np.roll(grid, i % 4, axis=1), host[0][i % 6], host[1][(i + 1) % 6])
                for i in range(DEEP_ENGINE_REQUESTS)]
        futs, sent, done = [None] * len(reqs), [0.0] * len(reqs), [0.0] * len(reqs)
        per_client = len(reqs) // DEEP_ENGINE_THREADS

        def client(c):
            for i in range(c * per_client, (c + 1) * per_client):
                sent[i] = time.perf_counter()
                fut = eng.submit(*reqs[i])
                fut.add_done_callback(lambda _, i=i: done.__setitem__(i, time.perf_counter()))
                futs[i] = fut

        torch.cuda.synchronize()
        _build.reset_launches()
        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(DEEP_ENGINE_THREADS)]
        t0 = time.perf_counter()
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=600)
        results = [f.result(timeout=600) for f in futs]
        wall_s = max(done) - t0
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        eng._dispatch, eng._run = dispatch, run
        expected = {k: v * len(records) for k, v in DEEP_LAUNCHES.items()}
        if launches != expected:
            raise AssertionError(f"deep engine: launches {launches} != {expected}")
        index = {id(f): i for i, f in enumerate(futs)}
        checked = 0
        for rec in records:
            ref = {k: v.cpu().numpy()
                   for k, v in deep_roi_flow_batch(*rec["inputs"], cfg, backend).items()}
            for row, fut in enumerate(rec["futures"]):
                got = results[index[id(fut)]]
                for k, v in ref.items():
                    if not np.array_equal(got[k], v[row]):
                        raise AssertionError(f"deep engine request {index[id(fut)]}: {k} "
                                             "differs from its batch's deep_roi_flow_batch")
                checked += 1
        if checked != len(reqs):
            raise AssertionError(f"deep engine: {checked} of {len(reqs)} results checked")
        lat = np.array([d - s for s, d in zip(sent, done)]) * 1e3
        emit({"phase": "deep_engine", "model": "raft-small", "requests": len(reqs),
              "threads": DEEP_ENGINE_THREADS, "max_batch": DEEP_B, "buckets": list(eng.buckets),
              "mem_grid": list(eng.mem_grid), "warmup_s": warm_s, "stats": eng.stats.as_dict(),
              "dispatches": len(records), "launches": launches,
              "equal_to_direct_batches": checked, "wall_s": wall_s,
              "requests_per_s": len(reqs) / wall_s,
              "latency_ms": {"p50": float(np.percentile(lat, 50)),
                             "p99": float(np.percentile(lat, 99)), "max": float(lat.max())},
              "card": smi_line()})
    finally:
        eng.shutdown()


def drive_deep_flowformer(dev) -> None:
    """FlowFormer at things_eval's widths (decoder depth 32): one ROI step
    (K1 twice) and one full-frame step, timed; the flows finite; on a cut
    FF_CUT window the card's flow within DEEP_FLOW_TOL of the CPU port's
    with float32 convolutions and within DEEP_TF32_TOL at PyTorch's
    defaults; FLOPs a pair."""
    cfg = deep_cfg()
    mem, prevs, nxts = deep_inputs(dev)
    backend, cpu_backend = deep_backend("flowformer", dev)

    def roi(m=mem, p=prevs[0], n=nxts[1]):
        return deep_roi_flow_step(m, p, n, cfg, backend)

    def full(m=mem, p=prevs[0], n=nxts[1]):
        return deep_full_flow_step(p, n, cfg, backend)

    ch, cw = FF_CUT
    cut = [x[None, 100:100 + ch, 160:160 + cw].contiguous() for x in (prevs[0], nxts[1])]
    with f32_convs():
        launches, out = launched_by(roi)
        if launches != DEEP_LAUNCHES:
            raise AssertionError(f"deep_flowformer: launches {launches}")
        if not (torch.isfinite(out["flow"]).all() and torch.isfinite(full()["flow"]).all()):
            raise AssertionError("deep_flowformer: a flow is not finite")
        card = backend.apply(*cut)
        ref = cpu_backend.apply(*(x.cpu() for x in cut))
        err = flow_err(card, ref, DEEP_FLOW_TOL, "deep_flowformer cut")
    err_tf32 = flow_err(backend.apply(*cut), ref, DEEP_TF32_TOL,
                        "deep_flowformer cut at the defaults")
    variants = [(mem, prevs[v], nxts[(v + 1) % 6]) for v in range(3)]
    roi_ms, roi_samples = median_ms(roi, variants)
    full_ms, full_samples = median_ms(full, variants)
    oys, oxs = troi.window_origin(out["box"][None], *DEEP_WIN, DEEP_H, DEEP_W)
    wins = [troi.crop_windows_batch(x[None], oys, oxs, *DEEP_WIN) for x in (prevs[0], nxts[1])]
    pad = [torch.zeros((1, DEEP_H, DEEP_W, 3), dtype=torch.uint8, device=dev)] * 2
    emit({"phase": "deep_flowformer", "model": "flowformer things_eval (decoder depth 32)",
          "frame": [DEEP_H, DEEP_W], "window": list(DEEP_WIN), "launches_per_roi_step": launches,
          "cut": list(FF_CUT), "flow_max_abs_err_vs_cpu": err, "tolerance_px": DEEP_FLOW_TOL,
          "flow_max_abs_err_vs_cpu_at_defaults": err_tf32,
          "tolerance_px_at_defaults": DEEP_TF32_TOL,
          "max_abs_flow_cut": card.abs().max().item(), "roi_box": out["box"].tolist(),
          "roi_ms": roi_ms, "full_ms": full_ms, "roi_speedup": full_ms / roi_ms,
          "samples_ms": {"roi": roi_samples, "full": full_samples},
          "gflops_per_pair": {"roi": flops_of(lambda: backend.apply(*wins)) / 1e9,
                              "full": flops_of(lambda: backend.apply(*pad)) / 1e9},
          "card": smi_line()})


def deep_k1_time(launches: dict, dev) -> dict:
    """K1 at the deep batch's shapes (B = DEEP_B RGB frames of 480×640,
    256×384 windows, a 3-byte element) beside its bound, its plain version
    and ``Tensor.copy_`` of one window slice."""
    entries = []
    b = DEEP_B
    _, frames, _ = deep_batch_inputs(dev)
    hk, wk = DEEP_WIN
    y0, x0 = min(100, DEEP_H - hk), min(160, DEEP_W - wk)
    oy = torch.full((b,), y0, dtype=torch.int32, device=dev)
    ox = torch.full((b,), x0, dtype=torch.int32, device=dev)
    got = troi.crop_windows_batch(frames, oy, ox, hk, wk)
    err = (got.int() - troi.crop_windows(frames, oy, ox, hk, wk).int()).abs().max().item()
    dst = torch.empty_like(got)
    kernel_entry({"crop_windows_rgb": launches["crop_windows"]}, {"crop_windows_rgb": err},
                 entries, "crop_windows_rgb",
                 lambda: troi.crop_windows_batch(frames, oy, ox, hk, wk),
                 lambda: troi.crop_windows(frames, oy, ox, hk, wk),
                 lambda: dst.copy_(frames[:, y0:y0 + hk, x0:x0 + wk]),
                 2 * b * hk * wk * 3, 0, b, path="deep_roi_flow_batch (RGB, 3-byte elements)")
    return entries[0]


# ── the training slice ───────────────────────────────────────────────────


def batch_grads(model, batch: dict, dev, iters: int, with_loss: bool = False):
    """The gradients of one forward and backward pass of RAFT ``model`` on
    ``batch`` (no optimizer step), by parameter name, on the CPU; with
    ``with_loss``, (the loss, the gradients)."""
    b = ptrain.to_device(batch, dev)
    model.zero_grad(set_to_none=True)
    loss, _ = sequence_loss(model(b["image1"], b["image2"], iters=iters), b["flow"], b["valid"])
    loss.backward()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    return (loss.item(), grads) if with_loss else grads


def grad_gap(got: dict, want: dict) -> dict:
    """``got``'s gradients against ``want``'s: the relative L2 gap over the
    whole gradient and the largest gap of an element, of the model's
    largest gradient."""
    top = max(g.abs().max().item() for g in want.values())
    worst = max((got[n] - ref).abs().max().item() for n, ref in want.items())
    sq_err = sum(float(((got[n] - ref).double() ** 2).sum()) for n, ref in want.items())
    sq_ref = sum(float((ref.double() ** 2).sum()) for ref in want.values())
    return {"grad_l2_rel_gap": (sq_err / sq_ref) ** 0.5, "grad_max_gap_of_model_largest": worst / top}


def grad_check(got: dict, want: dict, what: str) -> dict:
    """``got`` against ``want`` (name → gradient) to the CPU tests' bounds
    (GRAD_RTOL of each tensor's largest + GRAD_ATOL of the model's largest,
    GRAD_L2 over the whole gradient); returns the largest readings."""
    top = max(g.abs().max().item() for g in want.values())
    worst, sq_err, sq_ref = 0.0, 0.0, 0.0
    for name, ref in want.items():
        err = (got[name] - ref).abs().max().item()
        if not err <= GRAD_RTOL * ref.abs().max().item() + GRAD_ATOL * top:
            raise AssertionError(f"{what}: gradient of {name} is {err} off (model's largest {top})")
        worst = max(worst, err / top)
        sq_err += float(((got[name] - ref).double() ** 2).sum())
        sq_ref += float((ref.double() ** 2).sum())
    l2 = (sq_err / sq_ref) ** 0.5
    if not l2 <= GRAD_L2:
        raise AssertionError(f"{what}: gradients {l2} apart in L2")
    return {"grad_max_abs_err_of_model_largest": worst, "grad_l2_rel_err": l2}


def train_batch(b: int, h: int, w: int, seed: int) -> dict:
    """A train batch from a seed (numpy): a texture and its copy moved
    (2, 3) px, the flow that shift plus noise, a tenth of the pixels
    invalid."""
    rng = np.random.default_rng(seed)
    base = (rng.random((b, h + 8, w + 8, 3)) * 255).astype(np.uint8)
    flow = np.empty((b, h, w, 2), np.float32)
    flow[..., 0], flow[..., 1] = 3.0, 2.0
    flow += rng.normal(0, 0.5, flow.shape).astype(np.float32)
    return {"image1": base[:, 4:4 + h, 4:4 + w].astype(np.float32),
            "image2": base[:, 2:2 + h, 1:1 + w].astype(np.float32),
            "flow": flow, "valid": (rng.random((b, h, w)) > 0.1).astype(np.float32)}


def drive_train_parity(dev) -> None:
    """One train step of RAFT-small and RAFT-basic at the CPU tests' size
    (64×96, B = 2, 2 iterations), the same seeded weights and batch on the
    card (cuDNN TF32 off) and on the CPU port: the loss within 1e-5
    relative, every gradient to the CPU tests' bounds, the parameters after
    the update within 2·lr₀ + 1e-6·max |p|."""
    batch = train_batch(2, 64, 96, seed=3)
    out = {}
    with f32_convs():
        for kind in ("small", "basic"):
            cfg = RaftConfig(small=kind == "small", iters=2)
            cpu_model, cpu_tx, cpu_state = ptrain.create_train_state(0, "cpu", cfg=cfg)
            model = copy.deepcopy(cpu_model).to(dev)
            tx = raft_optimizer(model)
            grads = batch_grads(model, batch, dev, 2)
            ref = batch_grads(cpu_model, batch, torch.device("cpu"), 2)
            readings = grad_check(grads, ref, f"train_parity {kind}")
            launches, (_, got) = launched_by(lambda: ptrain.make_train_step(
                model, tx, dev, iters=2)(ptrain.TrainState(model, tx), batch))
            _, want = ptrain.make_train_step(cpu_model, cpu_tx, "cpu", iters=2)(cpu_state, batch)
            if launches:
                raise AssertionError(f"train_parity: the train step launched {launches}")
            loss_err = abs(got["loss"].item() - want["loss"].item()) / want["loss"].item()
            if not loss_err <= 1e-5:
                raise AssertionError(f"train_parity {kind}: loss {loss_err} relative off")
            lr0 = toptim.onecycle_schedule(4e-4, 100_000)(0)  # the defaults' first rate
            worst = 0.0
            cpu_params = dict(cpu_model.named_parameters())
            for name, p in model.named_parameters():
                ref_p = cpu_params[name].detach()
                err = (p.detach().cpu() - ref_p).abs().max().item()
                if not err <= 2 * lr0 + 1e-6 * ref_p.abs().max().item():
                    raise AssertionError(f"train_parity {kind}: {name} {err} off after the step")
                worst = max(worst, err / lr0)
            out[kind] = {"loss": want["loss"].item(), "loss_rel_err": loss_err,
                         "param_max_abs_err_in_lr0": worst, **readings}
    emit({"phase": "train_parity", "size": [64, 96], "batch": 2, "iters": 2,
          "precision": "float32 (cuDNN TF32 off)", "tolerances": {
              "loss_rel": 1e-5, "grad": f"{GRAD_RTOL}·tensor max + {GRAD_ATOL}·model max",
              "grad_l2": GRAD_L2, "params": "2·lr0 + 1e-6·max|p|"}, **out})
    # the step at PyTorch's defaults (TF32 convolutions, as train_raft times
    # it) beside the TF32-off step, from the same weights and batch
    tf32 = {}
    for kind in ("small", "basic"):
        model = ptrain.create_train_state(0, "cpu", cfg=RaftConfig(small=kind == "small",
                                                                   iters=2))[0].to(dev)
        with f32_convs():
            loss_off, grads_off = batch_grads(model, batch, dev, 2, with_loss=True)
        loss_tf32, grads_tf32 = batch_grads(model, batch, dev, 2, with_loss=True)
        tf32[kind] = {"loss": loss_tf32, "loss_rel_gap": abs(loss_tf32 - loss_off) / loss_off,
                      **grad_gap(grads_tf32, grads_off)}
        r = tf32[kind]
        if not (r["loss_rel_gap"] <= TRAIN_TF32_LOSS and r["grad_l2_rel_gap"] <= TRAIN_TF32_GRAD_L2
                and r["grad_max_gap_of_model_largest"] <= TRAIN_TF32_GRAD_MAX):
            raise AssertionError(f"train_parity {kind}: TF32 against float32 {r}")
    emit({"phase": "train_parity_tf32", "size": [64, 96], "batch": 2, "iters": 2,
          "precision": "PyTorch's defaults (cuDNN TF32) against cuDNN TF32 off",
          "tolerances": {"loss_rel": TRAIN_TF32_LOSS, "grad_l2_rel": TRAIN_TF32_GRAD_L2,
                         "grad_max_of_model_largest": TRAIN_TF32_GRAD_MAX}, **tf32})


def chairs_samples(n: int, seed: int):
    """``n`` synthetic pairs at FlyingChairs' native 384×512."""
    return synthetic_affine_dataset(np.random.default_rng(seed), n=n, size=TRAIN_NATIVE)


def drive_train_raft(dev, samples) -> None:
    """RAFT-basic at the chairs stage of RAFT_STANDARD_STAGES (batch 10,
    368×496 crops, 12 iterations, lr 4e-4, wdecay 1e-4, gamma 0.8) on
    synthetic 384×512 samples through the chairs augmentor, at PyTorch's
    defaults: ``run_stage`` takes the first step (the warm-up) and writes
    its checkpoint, which restores into a fresh state equal; then
    TRAIN_STEPS steps of ``make_train_step`` over ``mixed_batch_iterator``,
    as ``train_loop`` runs them (one read of the metrics a step), each
    timed; host syncs of a step and of the loop's read; the launches and
    the device's busy time of one step (a trace); FLOPs a step; peak
    memory."""
    stage = RAFT_STANDARD_STAGES[0]
    scanners = {"chairs": lambda: samples}
    rng = np.random.default_rng(0)
    cfg = RaftConfig()
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        state, info = run_stage(stage, dev, scanners, tmp, rng, raft_cfg=cfg, num_steps=1)
        warm_s = time.perf_counter() - start
        fresh = ptrain.create_train_state(1, dev, cfg=cfg, lr=stage.lr, num_steps=1)[2]
        fresh, at = restore_checkpoint(pathlib.Path(tmp) / stage.name, fresh)
        same = at == 1 and all(torch.equal(a, b) for a, b in zip(fresh.params.values(),
                                                                   state.params.values()))
        if not same:
            raise AssertionError("train_raft: the restored checkpoint differs")
        del fresh
    step = ptrain.make_train_step(state.model, state.tx, dev, iters=cfg.iters, gamma=stage.gamma)
    batches = mixed_batch_iterator(build_stage_items(stage, scanners), stage.batch_size, rng)
    losses, step_s, data_s = [], [], []
    torch.cuda.synchronize()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        batch = next(batches)
        t1 = time.perf_counter()
        state, metrics = step(state, batch)
        values = torch.stack([metrics[k].float() for k in metrics]).tolist()
        t2 = time.perf_counter()
        data_s.append(t1 - t0)
        step_s.append(t2 - t1)
        losses.append(dict(zip(metrics, values))["loss"])
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train_raft: losses {losses}")
    batch = next(batches)
    syncs_step = host_syncs(lambda: step(state, batch))
    _, metrics = step(state, batch)
    syncs_read = host_syncs(lambda: torch.stack([metrics[k].float() for k in metrics]).tolist())
    if syncs_step or sum(syncs_read.values()) != 1:
        raise AssertionError(f"train_raft: host syncs {syncs_step} in the step, {syncs_read} read")
    launches, _ = launched_by(lambda: step(state, batch))
    if launches:
        raise AssertionError(f"train_raft: the train step launched {launches}")
    flops = flops_of(lambda: step(state, batch))
    median = float(np.median(step_s))
    trace = device_trace(lambda: step(state, batch), median * 1e3, stage.batch_size, (),
                         path="train_raft_step")
    emit({"phase": "train_raft", "model": "raft-basic (cnet 'batch': GroupNorm)",
          "stage": stage.name, "batch": stage.batch_size, "crop": list(stage.image_size),
          "native": list(TRAIN_NATIVE), "iters": cfg.iters, "lr": stage.lr,
          "samples": len(samples), "warmup_step_s_with_checkpoint": warm_s,
          "warmup_wall_s": info["wall_s"], "checkpoint_restored_equal": same,
          "step_s_median": median, "step_s": step_s, "data_s_median": float(np.median(data_s)),
          "data_s": data_s, "losses": losses, "host_syncs_per_step": sum(syncs_step.values()),
          "host_syncs_per_loop_read": sum(syncs_read.values()),
          "port_kernel_launches_per_step": launches,
          "device_launches_per_step": trace.get("device_launches"),
          "device_busy_ms_per_step": trace.get("busy_ms"),
          "idle_share": trace.get("idle_share_of_timed_batch"),
          "tflop_per_step": flops / 1e12, "peak_memory_gb": peak / 1e9,
          "remat": cfg.remat, "timing_precision": "PyTorch defaults: cuDNN convolutions may "
          "use TF32, matrix products float32", "card": smi_line()})
    emit(trace)
    del state, step, metrics, batch
    torch.cuda.empty_cache()


def drive_train_remat(dev, samples) -> None:
    """One full-width step's gradients (RAFT-basic, batch 10, 368×496, 12
    iterations) with ``remat=True`` against ``remat=False`` from the same
    weights on the same augmented batch, to the CPU tests' bounds; the
    peak memory of each."""
    stage = RAFT_STANDARD_STAGES[0]
    items = build_stage_items(stage, {"chairs": lambda: samples})
    batch = next(mixed_batch_iterator(items, stage.batch_size, np.random.default_rng(1)))
    peaks, grads, seconds = {}, {}, {}
    for remat in (False, True):
        model = ptrain.create_train_state(0, dev, cfg=RaftConfig(remat=remat))[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        grads[remat] = batch_grads(model, batch, dev, 12)
        torch.cuda.synchronize()
        seconds[remat] = time.perf_counter() - start
        peaks[remat] = torch.cuda.max_memory_allocated() / 1e9
        del model
        torch.cuda.empty_cache()
    readings = grad_check(grads[True], grads[False], "train_remat")
    emit({"phase": "train_remat", "batch": stage.batch_size, "crop": list(stage.image_size),
          "iters": 12, "peak_memory_gb": {"remat_off": peaks[False], "remat_on": peaks[True]},
          "forward_backward_s": {"remat_off": seconds[False], "remat_on": seconds[True]},
          **readings, "card": smi_line()})


def drive_train_flowformer(dev, samples) -> None:
    """One FlowFormer step of the ff_chairs stage's model (twins backbones,
    decoder depth cut from 12 to TRAIN_FF_DEPTH) at batch TRAIN_FF_B (cut
    from 8) and the stage's 368×496 crops, with the twins group
    (``twins_lr_factor=0.05``): the groups' learning rates at step 0 and 1
    against the schedule, the loss finite."""
    stage = FLOWFORMER_STAGES[0]
    exp = get_experiment(stage.ff_experiment)
    cfg = dataclasses.replace(exp.model, decoder_depth=TRAIN_FF_DEPTH)
    model, tx, state = ptrain.create_flowformer_state(
        0, dev, cfg=cfg, lr=stage.lr, num_steps=100, twins_lr_factor=stage.twins_lr_factor,
        wdecay=exp.adamw_decay, eps=exp.epsilon, clip=exp.clip)
    scheds = [toptim.onecycle_schedule(stage.lr, 100),
              toptim.onecycle_schedule(stage.lr * stage.twins_lr_factor, 100)]
    lrs0 = tx.lrs()
    if lrs0 != [s(0) for s in scheds]:
        raise AssertionError(f"train_flowformer: lrs {lrs0} at step 0")
    items = build_stage_items(dataclasses.replace(stage, batch_size=TRAIN_FF_B),
                              {"chairs": lambda: samples})
    batch = next(mixed_batch_iterator(items, TRAIN_FF_B, np.random.default_rng(2)))
    step = ptrain.make_flowformer_step(model, tx, dev, gamma=stage.gamma)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    launches, (state, metrics) = launched_by(lambda: step(state, batch))
    seconds = time.perf_counter() - start
    loss = metrics["loss"].item()
    if launches or not np.isfinite(loss) or tx.lrs() != [s(1) for s in scheds]:
        raise AssertionError(f"train_flowformer: loss {loss}, lrs {tx.lrs()}, "
                             f"launches {launches}")
    n_backbone = len(tx.optimizer.param_groups[1]["params"])
    emit({"phase": "train_flowformer", "model": "ff_chairs (things widths, twins backbones)",
          "decoder_depth": TRAIN_FF_DEPTH, "decoder_depth_of_stage": exp.model.decoder_depth,
          "batch": TRAIN_FF_B, "batch_of_stage": stage.batch_size, "crop": list(stage.image_size),
          "loss": loss, "lrs_step0": lrs0, "lrs_step1": tx.lrs(),
          "backbone_params": n_backbone, "main_params": len(tx.optimizer.param_groups[0]["params"]),
          "step_s_first": seconds, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "card": smi_line()})
    del model, tx, state, step, batch
    torch.cuda.empty_cache()


def chairs_layout(root: pathlib.Path, samples) -> pathlib.Path:
    """FlyingChairs' layout as the scanner reads it: ``data/<n>_img1.ppm``,
    ``<n>_img2.ppm`` and ``<n>_flow.flo``."""
    data = root / "FlyingChairs_release" / "data"
    data.mkdir(parents=True)
    for i, (a, b, flow) in enumerate(samples):
        (data / f"{i:05d}_img1.ppm").write_bytes(encode_ppm(a))
        (data / f"{i:05d}_img2.ppm").write_bytes(encode_ppm(b))
        write_flo(data / f"{i:05d}_flow.flo", flow)
    return root


def png_scene(root: pathlib.Path) -> None:
    """A uavnew2-shaped scene of PNG frames (600×600, a texture moving (3, 6)
    px a frame) with a 15×15 state matrix and a 4×5-cell active block."""
    import scipy.io

    scene = root / "uavnew2"
    (scene / "RGB").mkdir(parents=True)
    (scene / "gtmask").mkdir()
    rng = np.random.default_rng(0)
    base = (rng.random((640, 640, 3)) * 255).astype(np.uint8)
    names = [f"{t}.png" for t in range(4)]
    for t, name in enumerate(names):
        frame = base[10 + 3 * t: 610 + 3 * t, 12 + 6 * t: 612 + 6 * t]
        (scene / "RGB" / name).write_bytes(encode_png(frame))
        gt = np.zeros((600, 600), np.uint8)
        gt[200 + 3 * t: 320 + 3 * t, 250: 400] = 255
        (scene / "gtmask" / name).write_bytes(encode_png(gt))
    (scene / "imgs.txt").write_text("\n".join(names) + "\n")
    mem = np.full((15, 15, 4), 1e-12)
    mem[5:9, 4:9, :] = 1e-5
    scipy.io.savemat(scene / "constructed_3D_matrix.mat", {"constructed3DMatrix": mem})


def drive_train_cli(dev, samples) -> None:
    """``python -m nsof_tpu_torch train --stage chairs --small --steps 2`` on a
    FlyingChairs layout of the phase's synthetic 384×512 pairs, then, side
    by side, ``deep --ckpt`` on its checkpoint over a PNG scene and
    ``validate --dataset chairs`` over the layout with that checkpoint: each
    in a process of its own, each exit 0; the seconds of each, from the
    start of its group."""
    with tempfile.TemporaryDirectory() as tmp:
        d = pathlib.Path(tmp)
        chairs_layout(d, samples)
        png_scene(d)
        ckpt = d / "ckpt" / "chairs"
        runs = {
            "train": ["train", "--data-root", str(d), "--ckpt-root", str(d / "ckpt"),
                      "--stage", "chairs", "--small", "--steps", "2"],
            "deep": ["deep", "--data-root", str(d), "--scene", "uavnew2", "--task", "track",
                     "--iters", "2", "--ckpt", str(ckpt), "--out", str(d / "deep")],
            "validate": ["validate", "--dataset", "chairs", "--data-root",
                         str(d / "FlyingChairs_release"), "--backend", "raft", "--small",
                         "--ckpt", str(ckpt), "--iters", "2", "--max-pairs", "2"],
        }
        seconds, printed = {}, {}
        # train first; then deep and validate, which only read its checkpoint, side by side
        for group in (("train",), ("deep", "validate")):
            start = time.perf_counter()
            procs = {name: subprocess.Popen(
                [sys.executable, "-m", "nsof_tpu_torch", *runs[name], *CLI_ARGS], cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for name in group}
            try:
                for name, proc in procs.items():
                    out, err = proc.communicate(timeout=600)
                    seconds[name] = time.perf_counter() - start
                    if proc.returncode != 0:
                        raise AssertionError(f"train_cli {name}: exit {proc.returncode}\n{err}")
                    printed[name] = json.loads(out.strip().splitlines()[-1])
            finally:
                for proc in procs.values():
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
        steps = sorted(int(p.name) for p in ckpt.iterdir() if p.name.isdigit())
        records = json.loads((d / "deep" / "deep_track.json").read_text())
    if steps != [2] or printed["train"] != {"stages": ["chairs"]} or len(records) != 2:
        raise AssertionError(f"train_cli: checkpoints {steps}, {printed}, records {records}")
    if not (printed["validate"]["n"] == 2 and np.isfinite(printed["validate"]["epe"])):
        raise AssertionError(f"train_cli: validate printed {printed['validate']}")
    emit({"phase": "train_cli", "pairs": len(samples), "native": list(TRAIN_NATIVE),
          "seconds": seconds, "printed": printed, "checkpoint_steps": steps,
          "card": smi_line()})


def yolo_state(scale: str) -> dict:
    """The converted state dict of YOLOv8-``scale`` on synthetic_state_dict's
    weights of seed 0, the head's last class and box convolutions scaled as
    tests/test_torch_detection.py's fixture scales them (×100 and ×10), the
    class biases lowered by YOLO_CLS_SHIFT.  The synthetic weights alone
    give class scores within 1e-6 of each other, so float32 rounding, not
    the image, would rank them."""
    cfg = tyolo.YoloConfig(scale)
    state = tyolo.synthetic_state_dict(cfg, seed=0)
    for s in range(3):
        state[f"model.22.cv3.{s}.2.weight"] = state[f"model.22.cv3.{s}.2.weight"] * 100
        state[f"model.22.cv3.{s}.2.bias"] = state[f"model.22.cv3.{s}.2.bias"] - YOLO_CLS_SHIFT
        state[f"model.22.cv2.{s}.2.weight"] = state[f"model.22.cv2.{s}.2.weight"] * 10
    return tyolo.convert_yolov8(state, cfg)


def rel_err(got, want) -> float:
    """max |got − want| over want's largest magnitude, of each output's box
    channels and class channels apart (the class logits are the larger),
    the largest across them."""
    box = 4 * tyolo.REG_MAX
    return max((g.detach().cpu()[:, part] - w[:, part]).abs().max().item()
               / w[:, part].abs().max().item()
               for g, w in zip(got, want) for part in (slice(None, box), slice(box, None)))


def post_gap(got: dict, want: dict) -> dict:
    """The card's ``postprocess`` output against the CPU port's: the slots
    and classes required equal, the boxes' and scores' largest gaps."""
    got = {k: v.cpu() for k, v in got.items()}
    if not (torch.equal(got["valid"], want["valid"])
            and torch.equal(got["classes"], want["classes"])):
        raise AssertionError(f"postprocess: {int(got['valid'].sum())} detections on the card, "
                             f"{int(want['valid'].sum())} on the CPU, or other classes")
    return {k: (got[k] - want[k]).abs().max().item() for k in ("boxes", "scores")}


@contextlib.contextmanager
def yolo_nms(fn):
    """``postprocess`` with ``fn`` as its NMS (the plain ``nms``, or a
    recording wrapper of K9)."""
    saved = tyolo.nms_batch
    tyolo.nms_batch = fn
    try:
        yield
    finally:
        tyolo.nms_batch = saved


def detector_parts(det, img: np.ndarray) -> dict:
    """One detector call on ``img`` part by part, each ended by a
    synchronisation (host clock, ms): the letterbox on the host, the upload,
    the forward, the decode and post step, within it K9 (CUDA events), the
    download and mapping; medians of TIME_N calls after TIME_WARM."""
    samples = collections.defaultdict(list)
    for i in range(TIME_WARM + TIME_N):
        times = {}

        def part(name, fn):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - start) * 1e3
            return out

        events = []

        def timed_nms(*args, **kw):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = tcomp.nms_batch(*args, **kw)
            ev[1].record()
            events.append(ev)
            return out

        canvas, gain, top, left = part("letterbox", lambda: det.letterbox(img))
        x = part("upload", lambda: det.upload(canvas))
        with torch.no_grad():
            outs = part("forward", lambda: det.model(x))
            with yolo_nms(timed_nms):
                post = part("decode_and_post", lambda: {k: v[0] for k, v in tyolo.postprocess(
                    *tyolo.decode_predictions(outs, det.config.num_classes),
                    det.conf, det.iou).items()})
        times["k9"] = events[0][0].elapsed_time(events[0][1])
        times["decode_and_sort"] = times["decode_and_post"] - times["k9"]
        part("download_and_map",
             lambda: det.detections(det.download(post), img.shape, gain, top, left))
        start = time.perf_counter()
        det(img)
        times["call"] = (time.perf_counter() - start) * 1e3
        if i >= TIME_WARM:
            for k, v in times.items():
                samples[k].append(v)
    return {k: float(np.median(v)) for k, v in samples.items()}


def drive_detect(dev) -> tuple[dict, dict]:
    """The detection slice at full width: YOLOv8n (80 classes, imgsz 640,
    conf 0.25, iou 0.45, max_det 300) on seeded synthetic weights.

    - its raw outputs on a letterboxed 640×480 frame against the CPU port's,
      within YOLO_F32_REL (TF32 off) and YOLO_TF32_REL (the defaults);
    - ``postprocess`` of the card's decoded outputs with K9 (one launch),
      with the plain ``nms`` and on the CPU: equal outputs; the card's
      detections (TF32 off) against the CPU port's: equal slots and classes,
      boxes and scores within YOLO_BOX_TOL and YOLO_SCORE_TOL;
    - the detector's parts on the full frame and on a ROI crop, the launches
      and host syncs of a call, GFLOP;
    - ``run_detection`` on the runner's 640×480 scene (counts zeroed just
      before and read just after: K9 once a detector call) with the YOLO
      and the blob detector: the YOLO time columns, the CSV's 10 columns,
      every region detection inside its region box;
    - YOLOv8 s, m, l and x: one forward each at 640².

    Returns K9's launch count on ``run_detection`` and the inputs of its
    first launch there (the kernel line's shapes)."""
    cfg = tyolo.YoloConfig()
    state = yolo_state("n")
    det = tdet.TorchYoloDetector(state, cfg, imgsz=YOLO_IMGSZ, device=dev)
    scene, _, _ = runner_scene(dev)
    frame = scene.frames_bgr[1]
    canvas, _, _, _ = det.letterbox(frame)
    x = det.upload(canvas)
    cpu_model = tyolo.YOLOv8(cfg)
    cpu_model.load_state_dict(state)
    with torch.no_grad():
        ref = cpu_model(x.cpu())
        with f32_convs():
            outs_f32 = det.model(x)
        f32_err = rel_err(outs_f32, ref)
        outs = det.model(x)
        tf32_err = rel_err(outs, ref)
    shapes = [list(o.shape) for o in outs]
    if shapes != [[1, 144, 80, 80], [1, 144, 40, 40], [1, 144, 20, 20]]:
        raise AssertionError(f"YOLOv8n outputs {shapes}")
    if not (f32_err <= YOLO_F32_REL and tf32_err <= YOLO_TF32_REL):
        raise AssertionError(f"YOLOv8n card vs CPU: {f32_err} (TF32 off), {tf32_err} (defaults)")
    boxes, scores = tyolo.decode_predictions(outs, cfg.num_classes)
    launches, post = launched_by(lambda: tyolo.postprocess(boxes, scores))
    if launches != {"nms": 1}:
        raise AssertionError(f"postprocess launched {launches}, not K9 once")
    with yolo_nms(tcomp.nms):
        plain = tyolo.postprocess(boxes, scores)
    for k in post:
        if not torch.equal(post[k], plain[k]):
            raise AssertionError(f"postprocess {k} with K9 differs from the plain nms's")
    # the CPU port's post step on the card's decoded outputs: equal; then
    # the card's detections (TF32 off) against the CPU port's on this frame
    cpu_post = tyolo.postprocess(boxes.cpu(), scores.cpu())
    for k in post:
        if not torch.equal(post[k].cpu(), cpu_post[k]):
            raise AssertionError(f"postprocess {k} on the card differs from the CPU port's")
    post_f32 = tyolo.postprocess(*tyolo.decode_predictions(outs_f32, cfg.num_classes))
    gap = post_gap(post_f32, tyolo.postprocess(*tyolo.decode_predictions(ref, cfg.num_classes)))
    if not (gap["boxes"] <= YOLO_BOX_TOL and gap["scores"] <= YOLO_SCORE_TOL):
        raise AssertionError(f"postprocess card vs CPU: {gap}")
    with torch.no_grad():
        gflop = flops_of(lambda: det.model(x)) / 1e9
        forward_ms = time_ms(lambda: det.model(x), iters=TIME_N, warm=TIME_WARM)
    emit({"phase": "detect_forward", "model": "yolov8n", "imgsz": YOLO_IMGSZ, "outputs": shapes,
          "rel_err_tf32_off": f32_err, "rel_err_defaults": tf32_err,
          "tolerances": {"tf32_off": YOLO_F32_REL, "defaults": YOLO_TF32_REL},
          "post_valid": int(post["valid"].sum()), "post_equal_plain": True,
          "post_equal_cpu_post": True, "post_valid_tf32_off": int(post_f32["valid"].sum()),
          "post_classes": sorted(set(post["classes"][post["valid"]].tolist())),
          "post_gap_cpu_tf32_off": gap,
          "post_tolerances": {"boxes_px": YOLO_BOX_TOL, "scores": YOLO_SCORE_TOL},
          "forward_ms": forward_ms, "gflop": gflop, "card": smi_line()})

    # the detector's parts on the full frame and the first pair's ROI crop
    roi = troi.roi_boxes(torch.from_numpy(scene.mem_gray[1:]).to(dev), H, W, scene.cfg.roi)
    i = int(roi["any_active"].int().argmax())
    if not bool(roi["any_active"][i]):
        raise AssertionError("detect: no pair of the scene has an active region")
    x0, y0, x1, y1 = roi["merged"][i].tolist()
    crop = scene.frames_bgr[i + 1][y0:y1, x0:x1]
    for name, img in (("full", frame), ("roi", crop)):
        parts = detector_parts(det, img)
        trace = device_trace(lambda: det(img), parts["call"], 1, ["nms"], path=f"detect_{name}")
        syncs = host_syncs(lambda: det(img))
        emit({"phase": "detect_parts", "input": name, "shape": list(img.shape),
              "ms": parts, "host_syncs": sum(syncs.values()), "sync_lines": syncs,
              "device_launches": trace.get("device_launches"), "busy_ms": trace["busy_ms"],
              "idle_share": trace.get("idle_share_of_timed_batch"),
              "top": trace.get("top", [])[:8], "card": smi_line()})

    # run_detection: the slice's main path, then the blob detector
    seen = []

    def recording(boxes, scores, valid, iou, plus_one=True):
        seen.append((boxes, scores, valid, iou, plus_one))
        return tcomp.nms_batch(boxes, scores, valid, iou, plus_one)

    with tempfile.TemporaryDirectory() as tmp:
        rows = {}
        for kind, detector in (("yolo", det), ("blob", tdet.ThresholdBlobDetector(150))):
            csv_path = pathlib.Path(tmp) / f"{kind}.csv"
            torch.cuda.synchronize()
            _build.reset_launches()
            with yolo_nms(recording):
                start = time.perf_counter()
                res = tdet.run_detection(scene, detector, csv_path, device=dev)
                seconds = time.perf_counter() - start
            torch.cuda.synchronize()
            launched = {k: v for k, v in _build.LAUNCHES.items() if v}
            calls = len(res) + sum(r.region_box is not None for r in res)
            want = {"nms": calls} if kind == "yolo" else {}
            if launched != want:
                raise AssertionError(f"run_detection {kind}: launched {launched}, want {want}")
            if kind == "yolo":
                k9_launches = launched["nms"]
            lines = csv_path.read_text().splitlines()
            head = lines[0].split(",")
            if head != reporting.SEG_COLUMNS + tdet.YOLO_COLUMNS or len(lines) != len(res) + 1:
                raise AssertionError(f"run_detection {kind}: CSV header {head}, {len(lines)} lines")
            for r in res:
                if r.region_box:
                    bx0, by0, bx1, by1 = r.region_box
                    for d in r.region_detections:
                        if not (bx0 <= d.bbox[0] <= d.bbox[2] <= bx1
                                and by0 <= d.bbox[1] <= d.bbox[3] <= by1):
                            raise AssertionError(f"{kind}: {d.bbox} outside {r.region_box}")
            region = [r.region_time_s * 1e3 for r in res if r.region_box]
            full = [r.full_time_s * 1e3 for r in res]
            rows[kind] = {"pairs": len(res), "seconds": seconds, "launches": launched,
                          "region_ms": region, "full_ms": full,
                          "roi_speedup": (float(np.median(full) / np.median(region))
                                          if region else None),
                          "region_detections": [len(r.region_detections) for r in res],
                          "full_detections": [len(r.full_detections) for r in res],
                          "region_boxes": [r.region_box for r in res]}
    emit({"phase": "detect_run", "frame": [H, W], **rows, "card": smi_line()})

    # the other scales, one forward each at 640²
    for scale in YOLO_SCALES:
        model = tyolo.YOLOv8(tyolo.YoloConfig(scale))
        model.load_state_dict(yolo_state(scale))
        model.to(dev).eval()
        with torch.no_grad():
            out = model(x)
            shapes = [list(o.shape) for o in out]
            if shapes != [[1, 144, 80, 80], [1, 144, 40, 40], [1, 144, 20, 20]]:
                raise AssertionError(f"YOLOv8{scale} outputs {shapes}")
            if not all(torch.isfinite(o).all() for o in out):
                raise AssertionError(f"YOLOv8{scale} outputs are not finite")
            emit({"phase": "detect_scale", "model": f"yolov8{scale}", "imgsz": YOLO_IMGSZ,
                  "outputs": shapes, "ms": time_ms(lambda: model(x), iters=5, warm=2),
                  "gflop": flops_of(lambda: model(x)) / 1e9,
                  "params_m": sum(p.numel() for p in model.parameters()) / 1e6,
                  "card": smi_line()})
        del model, out
        torch.cuda.empty_cache()
    return {"nms": k9_launches}, seen[0]


def gt_sam(cfg, dev=None) -> "tsam.Sam":
    """SAM at ``cfg`` on synthetic_sam_state_dict's seed-0 weights, the mask
    head scaled by GT_SAM_HEAD (see the constant), on ``dev`` or the CPU."""
    state = tsam.synthetic_sam_state_dict(cfg, seed=0)
    state["mask_decoder.output_upscaling.3.weight"] *= GT_SAM_HEAD
    for i in range(cfg.num_mask_tokens):
        state[f"mask_decoder.output_hypernetworks_mlps.{i}.layers.2.weight"] *= GT_SAM_HEAD
    model = tsam.Sam(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model.to(dev or "cpu").eval()


def gt_frame(dev) -> np.ndarray:
    """The runner scene's second frame as 480×640 uint8 RGB."""
    scene, _, _ = runner_scene(dev)
    return np.ascontiguousarray(scene.frames_bgr[1][..., ::-1])


def gap(got, want) -> float:
    """max |got − want| over want's largest magnitude (numpy or tensors)."""
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = want.detach().cpu().numpy() if torch.is_tensor(want) else np.asarray(want)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"shape {got.shape} against {want.shape}, or not finite")
    return float(np.abs(got - want).max() / np.abs(want).max())


def gt_measure(call, name: str) -> dict:
    """One entry point's numbers: CUDA-event median ms after warm-up (the
    host's work inside included: the events wait on it), the host clock's,
    the device launches and busy ms (a trace), the host syncs, GFLOP
    (FlopCounterMode: matrix products and convolutions) and peak memory."""
    samples, host = [], []
    for i in range(TIME_WARM + TIME_N):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        call()
        stop.record()
        torch.cuda.synchronize()
        if i >= TIME_WARM:
            samples.append(start.elapsed_time(stop))
            host.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(samples))
    trace = device_trace(call, ms, 1, [], path=name)
    syncs = host_syncs(call)
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    return {"ms": ms, "host_ms": float(np.median(host)),
            "device_launches": trace.get("device_launches"), "busy_ms": trace["busy_ms"],
            "idle_share": trace.get("idle_share_of_timed_batch"),
            "top": trace.get("top", [])[:6], "host_syncs": sum(syncs.values()),
            "sync_lines": syncs, "gflop": flops_of(call) / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def card_encoder(cfg, dev, seed: int = 0):
    """SAM's image encoder at ``cfg`` built on the card, every tensor drawn
    there from a seeded ``torch.Generator`` (N(0, 0.05), as the synthetic
    state dicts draw): numpy's draw of vit_l's 300 M or vit_h's 636 M values
    would cost the script tens of seconds."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        enc = tsam.ImageEncoderViT(cfg)
    with torch.no_grad():
        for t in enc.state_dict().values():
            t.normal_(0.0, 0.05, generator=gen)
    return enc.eval()


def drive_gt_sam(dev, frame: np.ndarray):
    """SAM at full width on the card.

    - vit_b (synthetic weights, GT_SAM_HEAD) behind ``SamPredictor`` on the
      480×640 frame: ``set_image`` (768×1024 resize on the host, 1024²
      encoder) and ``predict`` with 1 and 4 boxes (``postprocess`` 256² →
      1024² → crop 768×1024 → 480×640); each one's numbers
      (:func:`gt_measure`), its outputs' shapes, finite values, the mask's
      share;
    - the card against the CPU port at vit_b's widths, depth
      GT_SAM_CUT_DEPTH, TF32 off and at the defaults;
    - vit_l and vit_h: one encoder forward each at 1024², depth uncut.

    Returns the vit_b predictor's model."""
    cfg = tsam.SAM_CONFIGS["vit_b"]
    model = gt_sam(cfg, dev)
    pred = tsam.SamPredictor(model, device=dev)
    out = {"set_image": gt_measure(lambda: pred.set_image(frame), "gt_sam_set_image")}
    for nb in (1, 4):
        boxes = np.asarray(GT_BOXES[:nb], np.float32)
        masks, iou, low = pred.predict(boxes=boxes)
        side = 4 * cfg.embedding_size
        if (masks.shape != (nb, 1, H, W) or low.shape != (nb, 1, side, side)
                or not (np.isfinite(iou).all() and np.isfinite(low).all())):
            raise AssertionError(f"SAM predict: {masks.shape}, {low.shape}, finite iou/logits")
        out[f"predict_{nb}"] = {**gt_measure(lambda: pred.predict(boxes=boxes), f"gt_sam_{nb}"),
                                "mask_share": float(masks.mean()), "iou": iou[:, 0].tolist()}
    emit({"phase": "gt_sam", "model": "vit_b", "frame": [H, W], "input": [1024, 1024],
          "embedding": list(pred._embedding.shape), "weights": "numpy seed 0, head ×20",
          **out, "card": smi_line()})

    cut = dataclasses.replace(cfg, depth=GT_SAM_CUT_DEPTH, global_attn_indexes=(2,))
    boxes = np.asarray(GT_BOXES, np.float32)
    cpu = tsam.SamPredictor(gt_sam(cut), device="cpu")
    start = time.perf_counter()
    cpu.set_image(frame)
    want = cpu.predict(boxes=boxes, return_logits=True)
    cpu_s = time.perf_counter() - start
    card = tsam.SamPredictor(gt_sam(cut, dev), device=dev)
    gaps = {}
    for setting, ctx in (("tf32_off", f32_convs), ("defaults", contextlib.nullcontext)):
        with ctx():
            card.set_image(frame)
            got = card.predict(boxes=boxes, return_logits=True)
        gaps[setting] = {k: gap(g, w) for k, g, w in zip(("logits", "iou", "low_res"),
                                                           got, want)}
    worst = {k: max(v.values()) for k, v in gaps.items()}
    if not (worst["tf32_off"] <= GT_SAM_F32_REL and worst["defaults"] <= GT_SAM_TF32_REL):
        raise AssertionError(f"SAM card vs CPU: {gaps}")
    emit({"phase": "gt_sam_parity", "widths": "vit_b", "depth": GT_SAM_CUT_DEPTH,
          "boxes": len(boxes), "gaps": gaps,
          "tolerances": {"tf32_off": GT_SAM_F32_REL, "defaults": GT_SAM_TF32_REL},
          "cpu_seconds": cpu_s, "card": smi_line()})
    del cpu, card

    x = pred.preprocess(frame)
    for name in ("vit_l", "vit_h"):
        enc = card_encoder(tsam.SAM_CONFIGS[name], dev)
        with torch.inference_mode():
            emb = enc(x)
            if emb.shape != (1, 256) + (cfg.embedding_size,) * 2 or not torch.isfinite(emb).all():
                raise AssertionError(f"{name} encoder: {tuple(emb.shape)} or not finite")
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            samples = []
            for i in range(4):
                start.record()
                enc(x)
                stop.record()
                torch.cuda.synchronize()
                if i:
                    samples.append(start.elapsed_time(stop))
            gflop = flops_of(lambda: enc(x)) / 1e9
            trace = device_trace(lambda: enc(x), float(np.median(samples)), 1, [],
                                 path=f"gt_{name}")
            torch.cuda.reset_peak_memory_stats()
            enc(x)
            torch.cuda.synchronize()
        emit({"phase": "gt_sam_encoder", "model": name, "input": [1024, 1024],
              "depth": len(enc.blocks), "weights": "drawn on the card, torch.Generator seed 0",
              "ms": float(np.median(samples)), "samples": samples, "gflop": gflop,
              "device_launches": trace.get("device_launches"), "busy_ms": trace["busy_ms"],
              "params_m": sum(t.numel() for t in enc.parameters()) / 1e6,
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi_line()})
        del enc, emb
        torch.cuda.empty_cache()
    return model


def owl_ids(tok, n: int) -> torch.Tensor:
    return torch.from_numpy(np.stack([tok(q) for q in GT_QUERIES[:n]]))[None]


def drive_gt_owlvit(dev, frame: np.ndarray):
    """OWL-ViT at base-patch32's widths on the card: the proposer's input
    (768² cubic resize on the host, upload, CLIP normalisation) and the
    forward with 1 and 4 text queries, each one's numbers
    (:func:`gt_measure`); a proposer call; then the card against the CPU
    port at TINY_OWLVIT and base-patch32, TF32 off and at the defaults.
    Returns the base-patch32 proposer."""
    cfg = towl.BASE_PATCH32
    state = towl.synthetic_owlvit_state_dict(cfg, seed=0)
    tok = tgt.toy_tokenizer(cfg.vocab_size, cfg.max_text_len)
    prop = tgt.TorchOwlVitBoxProposer.from_params(cfg, state, tok, device=dev)
    out = {"pixels": gt_measure(lambda: prop.pixels(frame), "gt_owl_pixels")}
    px = prop.pixels(frame)
    for n in (1, 4):
        ids = owl_ids(tok, n).to(dev)

        def forward():
            with torch.inference_mode():
                return prop.model(px, ids)

        res = forward()
        if (res["logits"].shape != (1, cfg.grid ** 2, n) or res["pred_boxes"].shape !=
                (1, cfg.grid ** 2, 4) or not torch.isfinite(res["logits"]).all()):
            raise AssertionError(f"OWL-ViT forward: {tuple(res['logits'].shape)} or not finite")
        out[f"forward_{n}"] = gt_measure(forward, f"gt_owl_{n}")
    scores = torch.sigmoid(res["logits"][0, :, 0]).sort(descending=True).values.cpu()
    prop.score_threshold = float(scores[3:5].mean())  # four boxes for query 0 here
    boxes = prop(frame, GT_QUERIES[0])
    out["proposer_call"] = {"ms": gt_measure(lambda: prop(frame, GT_QUERIES[0]),
                                             "gt_owl_call")["host_ms"],
                            "boxes": len(boxes), "threshold": prop.score_threshold}
    emit({"phase": "gt_owlvit", "model": "owlvit-base-patch32 widths", "frame": [H, W],
          "input": [cfg.image_size, cfg.image_size], "patches": cfg.grid ** 2,
          "weights": "numpy seed 0", "tokenizer": "toy (CRC-32 of each word)", **out,
          "card": smi_line()})

    gaps = {}
    for name, c in (("tiny", towl.TINY_OWLVIT), ("base_patch32", cfg)):
        st = state if c is cfg else towl.synthetic_owlvit_state_dict(c, seed=0)
        ids = owl_ids(tgt.toy_tokenizer(c.vocab_size, c.max_text_len), 4)
        cpu_prop = tgt.TorchOwlVitBoxProposer.from_params(c, st, tok, device="cpu")
        pixels = cpu_prop.pixels(frame)
        with torch.inference_mode():
            want = cpu_prop.model(pixels, ids)
        card = towl.load_owlvit_state(st, c).to(dev).eval()
        gaps[name] = {}
        for setting, ctx in (("tf32_off", f32_convs), ("defaults", contextlib.nullcontext)):
            with ctx(), torch.inference_mode():
                got = card(pixels.to(dev), ids.to(dev))
            gaps[name][setting] = {k: gap(got[k], want[k]) for k in ("logits", "pred_boxes")}
    worst = {s: max(max(g[s].values()) for g in gaps.values()) for s in ("tf32_off", "defaults")}
    if not (worst["tf32_off"] <= GT_OWL_F32_REL and worst["defaults"] <= GT_OWL_TF32_REL):
        raise AssertionError(f"OWL-ViT card vs CPU: {gaps}")
    emit({"phase": "gt_owlvit_parity", "queries": 4, "gaps": gaps,
          "tolerances": {"tf32_off": GT_OWL_F32_REL, "defaults": GT_OWL_TF32_REL},
          "card": smi_line()})
    return prop


def drive_gt_chain(dev, sam_model, prop) -> None:
    """The OWL-ViT → SAM chain (``lang_sam_segmenter``'s pieces on the
    synthetic weights) on the card: ``generate_gt_masks`` over the runner
    scene's first GT_CHAIN_FRAMES frames written as 640×480 PNG, each mask
    the union of the chain's masks for its frame; then ``/api/segment`` on
    the demo server with the chain injected, with ``box_threshold`` unset
    and set, each answer equal in instances to the chain called directly at
    that threshold, the shared proposer's threshold left as it was.  No
    kernel of the port is launched."""
    chain = tgt.TorchSamSegmenter(sam_model, prop, device=dev)
    scene, _, _ = runner_scene(dev)
    prompt = GT_QUERIES[0]
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        names = [f"{i:04d}.png" for i in range(GT_CHAIN_FRAMES)]
        rgb = [np.ascontiguousarray(f[..., ::-1]) for f in scene.frames_bgr[:GT_CHAIN_FRAMES]]
        for name, img in zip(names, rgb):
            (root / name).write_bytes(encode_png(img))
        (root / "imgs.txt").write_text("\n".join(names))
        chain(rgb[0], prompt)  # warm-up
        start = time.perf_counter()
        launches, res = launched_by(lambda: tgt.generate_gt_masks(
            root, root / "imgs.txt", root / "gtmask", prompt, chain))
        seconds = time.perf_counter() - start
        if launches:
            raise AssertionError(f"generate_gt_masks launched {launches}")
        for r, img in zip(res, rgb):
            mask = decode_png(pathlib.Path(r.mask_path).read_bytes(), gray=True)
            if mask.shape != (H, W) or not set(np.unique(mask)) <= {0, 255}:
                raise AssertionError(f"{r.frame}: mask {mask.shape} {np.unique(mask)}")
        want = np.zeros((H, W), np.uint8)
        for m in chain(rgb[0], prompt):
            want |= m.astype(np.uint8)
        first = decode_png(pathlib.Path(res[0].mask_path).read_bytes(), gray=True)
        if not np.array_equal(first, want * 255):
            raise AssertionError("the first frame's mask differs from the chain's union")

    with torch.inference_mode():
        logits = prop.model(prop.pixels(rgb[0]), owl_ids(prop.tokenizer, 1).to(dev))["logits"]
    scores = torch.sigmoid(logits[0, :, 0]).sort(descending=True).values.cpu()
    srv = make_server(port=0, segmenter=chain, device=dev)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    served = {}
    try:
        base = prop.score_threshold
        for thr in (None, float(scores[7:9].mean())):  # eight boxes when set
            body = {"image": b64png(rgb[0]), "prompt": prompt}
            if thr is not None:
                body["box_threshold"] = thr
            code, raw, ms = http(srv.server_address[1], "/api/segment", body)
            seg = json.loads(raw)
            prop.score_threshold = base if thr is None else thr
            n = len(chain(rgb[0], prompt))
            prop.score_threshold = base
            if code != 200 or seg["backend"] != "TorchSamSegmenter" or seg["n_instances"] != n:
                raise AssertionError(f"/api/segment box_threshold={thr}: {code} "
                                     f"{str(seg)[:300]}, the chain gives {n}")
            served["unset" if thr is None else "set"] = {
                "box_threshold": thr, "n_instances": n, "ms": ms}
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    emit({"phase": "gt_chain", "frames": GT_CHAIN_FRAMES, "frame": [H, W], "prompt": prompt,
          "threshold": prop.score_threshold, "seconds": seconds,
          "ms_per_frame": seconds * 1e3 / GT_CHAIN_FRAMES,
          "instances": [r.n_instances for r in res], "api_segment": served,
          "card": smi_line()})


def drive_parallel_seg(dev, mesh) -> None:
    """``make_sharded_seg_batch`` on the 1×1 mesh at the main path's workload
    (grasp, B = 256, ``'fused'``): K1–K4 launched as the unsharded path
    launches them, masks, boxes and ``any_active`` bit for bit
    ``seg_batch_fast``'s; both timed."""
    cfg = bench_cfg()
    fn = make_sharded_seg_batch(mesh, cfg, kernel_mode="fused")
    mem, prev, nxt = bench_inputs(B_MAIN, 0, dev)
    launches, out = launched_by(lambda: fn(mem, prev, nxt))
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"parallel_seg: launches {launches} != {EXPECTED_LAUNCHES}")
    ref = seg_batch_fast(mem, prev, nxt, cfg, kernel_mode="fused")
    for key in ("mask", "box", "any_active"):
        if not torch.equal(out[key], ref[key]):
            raise AssertionError(f"parallel_seg: {key} differs from seg_batch_fast's")
    syncs = host_syncs(lambda: fn(mem, prev, nxt))
    variants = [(mem, prev, nxt)] + [bench_inputs(B_MAIN, v, dev) for v in (1, 2)]
    ms, samples = median_ms(fn, variants)
    ms_one, samples_one = median_ms(
        lambda m, p, n: seg_batch_fast(m, p, n, cfg, kernel_mode="fused"), variants)
    emit({"phase": "parallel_seg", "mesh": pmesh.mesh_shape(mesh), "batch": B_MAIN,
          "kernel_mode": "fused", "launches_per_call": launches, "bit_equal": True,
          "active": int(out["any_active"].sum()), "host_syncs_per_call": sum(syncs.values()),
          "ms_per_batch": ms, "unsharded_ms_per_batch": ms_one, "samples_ms": samples,
          "unsharded_samples_ms": samples_one, "card": smi_line()})


def drive_parallel_train(dev, mesh, samples) -> None:
    """The dp×tp step on the 1×1 mesh against the one-device step at the
    chairs stage uncut (RAFT-basic, batch 10, 368×496, 12 iterations), from
    the same seed and batch: the first step with cuDNN TF32 off held to
    PAR_TRAIN_LOSS and the update bound, then PAR_TRAIN_STEPS timed steps
    each at PyTorch's defaults after one warm-up."""
    stage = RAFT_STANDARD_STAGES[0]
    rng = np.random.default_rng(0)
    batches = mixed_batch_iterator(build_stage_items(stage, {"chairs": lambda: samples}),
                                   stage.batch_size, rng)
    first, timed = next(batches), [next(batches) for _ in range(PAR_TRAIN_STEPS + 1)]
    cfg = RaftConfig()
    runs = {}
    for name, where in (("one_device", dev), ("mesh_1x1", mesh)):
        model, tx, state = ptrain.create_train_state(0, where, cfg=cfg, lr=stage.lr,
                                                     num_steps=stage.num_steps)
        step = ptrain.make_train_step(model, tx, where, iters=cfg.iters, gamma=stage.gamma)
        with f32_convs():
            launches, (state, metrics) = launched_by(lambda: step(state, first))
        if launches:
            raise AssertionError(f"parallel_train {name}: the step launched {launches}")
        full = ptrain.full_state_dict(state)["model"] if state.mesh is not None \
            else model.state_dict()
        params = {k: v.detach().to('cpu', copy=True) for k, v in full.items()}
        step_s = []
        for b in timed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.stack([v.float() for v in m.values()]).tolist()
            step_s.append(time.perf_counter() - t0)
        runs[name] = {"loss": metrics["loss"].item(), "params": params, "step_s": step_s[1:],
                      "sharded": len(ptrain._sharded_names(model))}
        del model, tx, state, step, metrics
        torch.cuda.empty_cache()
    one, tp = runs["one_device"], runs["mesh_1x1"]
    loss_err = abs(tp["loss"] - one["loss"]) / one["loss"]
    if not (np.isfinite(one["loss"]) and loss_err <= PAR_TRAIN_LOSS):
        raise AssertionError(f"parallel_train: loss {tp['loss']} against {one['loss']}")
    lr0 = toptim.onecycle_schedule(stage.lr, stage.num_steps)(0)
    worst = 0.0
    for name, ref in one["params"].items():
        err = (tp["params"][name] - ref).abs().max().item()
        if not err <= 2 * lr0 + 1e-6 * ref.abs().max().item():
            raise AssertionError(f"parallel_train: {name} {err} off after the step")
        worst = max(worst, err / lr0)
    emit({"phase": "parallel_train", "mesh": pmesh.mesh_shape(mesh),
          "model": "raft-basic (cnet 'batch': GroupNorm)", "stage": stage.name,
          "batch": stage.batch_size, "crop": list(stage.image_size), "iters": cfg.iters,
          "tp_sharded_params": tp["sharded"], "loss": one["loss"], "mesh_loss": tp["loss"],
          "loss_rel_err": loss_err, "param_max_abs_err_in_lr0": worst,
          "tolerances": {"loss_rel": PAR_TRAIN_LOSS, "params": "2·lr0 + 1e-6·max|p|"},
          "parity_precision": "float32 (cuDNN TF32 off)",
          "step_s_one_device": one["step_s"], "step_s_mesh": tp["step_s"],
          "step_s_median_one_device": float(np.median(one["step_s"])),
          "step_s_median_mesh": float(np.median(tp["step_s"])),
          "timing_precision": "PyTorch defaults", "card": smi_line()})


def drive_parallel_sp(dev) -> None:
    """``make_spatial_flow`` on one 'space' rank at 480×640 (grasp, halo
    SP_HALO) against the exact ``farneback`` in the interior band; both
    timed."""
    params = PRESETS["grasp"]
    mesh = pmesh.init_mesh((1,), ("space",))
    fn = make_spatial_flow(mesh, params, SP_HALO)
    variants = [tuple(x[0] for x in bench_inputs(1, v, dev)[1:]) for v in range(3)]
    prev, nxt = variants[0]
    got = fn(prev, nxt)
    ref = farneback(prev, nxt, params, device=dev)
    if got.shape != (H, W, 2) or not torch.isfinite(got).all():
        raise AssertionError(f"parallel_sp: flow {tuple(got.shape)}")
    band = slice(SP_HALO, H - SP_HALO)
    err = (got[band] - ref[band]).abs()
    if not (err.max().item() <= SP_MAX and err.mean().item() <= SP_MEAN):
        raise AssertionError(f"parallel_sp: interior {err.max().item()} max, "
                             f"{err.mean().item()} mean px from farneback")
    ms, samples = median_ms(fn, variants)
    ms_one, samples_one = median_ms(lambda a, b: farneback(a, b, params, device=dev), variants)
    emit({"phase": "parallel_sp", "mesh": pmesh.mesh_shape(mesh), "frame": [H, W],
          "preset": "grasp", "halo": SP_HALO, "interior_rows": [SP_HALO, H - SP_HALO],
          "interior_max_abs_err_px": err.max().item(),
          "interior_mean_abs_err_px": err.mean().item(),
          "tolerances": {"max": SP_MAX, "mean": SP_MEAN}, "ms": ms, "unsharded_ms": ms_one,
          "samples_ms": samples, "unsharded_samples_ms": samples_one, "card": smi_line()})


def drive_parallel_pp(dev) -> None:
    """``make_raft_pp_flow`` on one stage at the deep window (RAFT-basic at
    raft-things widths, 20 iterations, PP_M microbatches of one pair)
    against the test-mode forward: within DEEP_FLOW_TOL with TF32 off and
    DEEP_TF32_TOL at the defaults; both timed at the defaults."""
    mesh = pmesh.init_mesh((1,), ("stage",))
    model = deep_model("raft-basic").to(dev).eval()
    _, prevs, nxts = deep_inputs(dev)
    img1 = torch.stack([prevs[m][:DEEP_WIN[0], :DEEP_WIN[1]] for m in range(PP_M)])[:, None]
    img2 = torch.stack([nxts[m][:DEEP_WIN[0], :DEEP_WIN[1]] for m in range(PP_M)])[:, None]
    fn = make_raft_pp_flow(mesh, model.cfg, DEEP_ITERS)

    def unsharded(a, b):
        return torch.stack([model(a[m], b[m], iters=DEEP_ITERS, test_mode=True)[1]
                            for m in range(PP_M)])

    with torch.no_grad():
        with f32_convs():
            got, ref = fn(model, img1, img2), unsharded(img1, img2)
        err = flow_err(got, ref, DEEP_FLOW_TOL, "parallel_pp (TF32 off)")
        err_tf32 = flow_err(fn(model, img1, img2), ref, DEEP_TF32_TOL, "parallel_pp (defaults)")
        ms, samples = median_ms(lambda a, b: fn(model, a, b), [(img1, img2)])
        ms_one, samples_one = median_ms(unsharded, [(img1, img2)])
    emit({"phase": "parallel_pp", "mesh": pmesh.mesh_shape(mesh), "model": "raft-basic",
          "window": list(DEEP_WIN), "iters": DEEP_ITERS, "microbatches": PP_M,
          "flow_max_abs_err_px_f32": err, "flow_max_abs_err_px_defaults": err_tf32,
          "tolerances": {"f32": DEEP_FLOW_TOL, "defaults": DEEP_TF32_TOL}, "ms": ms,
          "unsharded_ms": ms_one, "samples_ms": samples, "unsharded_samples_ms": samples_one,
          "card": smi_line()})
    del model


def drive_parallel_cli(dev, samples) -> None:
    """``torchrun --nproc-per-node 1 -m nsof_tpu_torch train --mesh 1x1
    --stage chairs --small --steps 1`` on a FlyingChairs layout of the
    phase's synthetic pairs (NCCL at world size 1); its checkpoint, written
    by the first rank in the one-device layout, restores on one device."""
    with tempfile.TemporaryDirectory() as tmp:
        d = chairs_layout(pathlib.Path(tmp), samples)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "1",
               "--master-port", str(pmesh.free_port()), "-m", "nsof_tpu_torch", "train",
               "--mesh", "1x1", "--data-root", str(d), "--ckpt-root", str(d / "ckpt"),
               "--stage", "chairs", "--small", "--steps", "1", *CLI_ARGS]
        start = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - start
        if proc.returncode != 0:
            raise AssertionError(f"parallel_cli: exit {proc.returncode}\n{proc.stderr[-4000:]}")
        printed = json.loads(proc.stdout.strip().splitlines()[-1])
        _, _, state = ptrain.create_train_state(1, dev, cfg=RaftConfig(small=True))
        state, step = restore_checkpoint(d / "ckpt" / "chairs", state)
        finite = all(torch.isfinite(v).all().item() for v in state.params.values())
    if printed != {"stages": ["chairs"]} or step != 1 or not finite:
        raise AssertionError(f"parallel_cli: printed {printed}, restored step {step}, "
                             f"finite {finite}")
    emit({"phase": "parallel_cli", "command": "torchrun --nproc-per-node 1 -m nsof_tpu_torch "
          "train --mesh 1x1 --stage chairs --small --steps 1", "seconds": seconds,
          "printed": printed, "restored_step_on_one_device": step, "card": smi_line()})


def drive_parallel(dev, samples) -> None:
    """The parallel slice at world size 1 over NCCL: dp seg, the dp×tp train
    step, sp and pp; the process group is destroyed at the end."""
    mesh = pmesh.make_mesh(1)
    try:
        emit({"phase": "parallel", "backend": dist.get_backend(),
              "world_size": dist.get_world_size(), "mesh": pmesh.mesh_shape(mesh)})
        if dist.get_backend() != "nccl":
            raise AssertionError(f"parallel: backend {dist.get_backend()}, not nccl")
        drive_parallel_seg(dev, mesh)
        drive_parallel_train(dev, mesh, samples)
        drive_parallel_sp(dev)
        drive_parallel_pp(dev)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    drive_parallel_cli(dev, samples)


def k9_time(launches: dict, errs: dict, args) -> dict:
    """K9's line at the YOLO post step's shapes (``args``: the inputs of its
    first launch in run_detection): its plain loop, ``torchvision.ops.nms``
    where it imports, the bytes bound, the greedy loop's chain bound of the
    steps this input takes (one a kept box, then the step that finds nothing
    alive) and the walk's reckoning.  The events' ``ms`` holds the wrapper's
    host work too: ``nsof_tpu_torch/time_trees.py`` gives the kernel's device
    time alone."""
    boxes, scores, valid, iou, _ = args
    keep = tcomp.nms_batch(*args)
    steps = int(keep.sum(dim=1).max()) + 1
    b, n = scores.shape
    # the redesign's reckoning: each row's walk (a step a kept box and a
    # visit a word) and its mask's IoUs (one SM a row)
    nv = valid.sum(dim=1)
    walk = int((keep.sum(dim=1) + (nv + 31) // 32).max())
    mask_ops = int((nv * (nv - 1) // 2).sum()) * K9_IOU_OPS
    sms = torch.cuda.get_device_properties(boxes.device).multi_processor_count
    walk_ms = walk * K9_WALK_STEP_NS * 1e-6
    mask_ms = mask_ops / (FP32_FLOPS * min(b, sms) / sms) * 1e3
    try:
        import torchvision
        lib_fn = (lambda: torchvision.ops.nms(boxes[0][valid[0]], scores[0][valid[0]], iou))
        library_call = "torchvision.ops.nms"
    except ImportError:
        lib_fn, library_call = None, "none installed"
    entries = []
    # a step: the argmax's compare per box, then each alive box's IoU (≈ 22
    # float32 operations); inputs read once, the keep mask written once
    kernel_entry(launches, errs, entries, "nms", lambda: tcomp.nms_batch(*args),
                 lambda: tcomp.nms(*args), lib_fn, b * n * (16 + 4 + 1) + b * n,
                 b * steps * n * 23, b, plain_iters=3, library_call=library_call, n=n, steps=steps,
                 chain_bound_ms=steps * K9_STEP_NS * 1e-6,
                 chain_bound_by="steps dependent steps, each reckoned at "
                                f"{K9_STEP_NS:.1f} ns (two warp shuffle trees, three "
                                "barriers, one IoU, 1.98 GHz)",
                 walk_steps=walk, mask_ious=mask_ops // K9_IOU_OPS,
                 walk_bound_ms=walk_ms + mask_ms,
                 walk_bound_by=f"walk_steps (kept boxes + word visits) at "
                               f"{K9_WALK_STEP_NS:.1f} ns ({walk_ms:.6f} ms) + the mask's "
                               f"{K9_IOU_OPS} float32 operations an IoU at the float32 rate "
                               f"of min(B, SMs) SMs ({mask_ms:.6f} ms)")
    return entries[0]


def tree_adds(win: int) -> int:
    """Additions of a log-tree window sum of width ``win`` a position, with
    every partial sum computed once."""
    return (win.bit_length() - 1) + (bin(win).count("1") - 1)


def check_kernels(dev) -> dict:
    """Each kernel against its plain version on the card: K1–K4 at the main
    path's level-0 shapes (B = 16), the float32 forms of K3 and K4 there,
    K1 also at ``K1_CASES``, K2 at ``K2_CASES``, K3 and K5 at ``K3_CASES``,
    K4 at every ``K4_CASES`` (winsize, radius) and K7 at ``K7_CASES``,
    K5–K7 at the autodriving path's level-0 shapes (B = 4).  Every kernel
    but K6 must equal its plain version.  Returns the max |Δ| of each."""
    hk, wk = WIN
    errs = {}
    rng = np.random.default_rng(2)
    frames = torch.from_numpy(rng.integers(0, 256, (B_CHECK, H, W), dtype=np.uint8)).to(dev)
    oys = torch.from_numpy(rng.integers(0, H - hk + 1, B_CHECK).astype(np.int32)).to(dev)
    oxs = torch.from_numpy(rng.integers(0, W - wk + 1, B_CHECK).astype(np.int32)).to(dev)
    cases = {"main_path": (frames, oys, oxs, hk, wk)}
    for name, (shape, dtype, (ch, cw), cy, cx) in K1_CASES.items():
        if dtype == torch.uint8:
            f = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
        else:
            f = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
        cases[name] = (f.to(dev), torch.tensor(cy, dtype=torch.int32, device=dev),
                       torch.tensor(cx, dtype=torch.int32, device=dev), ch, cw)
    for name, args in cases.items():
        got = troi.crop_windows_batch(*args)
        ref = troi.crop_windows(*args)
        if got.dtype != ref.dtype or not torch.equal(got, ref):
            raise AssertionError(f"K1 differs from its plain version in case {name}")
    errs["crop_windows"] = 0
    emit({"phase": "check", "kernel": "crop_windows", "cases": list(cases),
          "max_abs_err": 0, "tolerance": 0})

    ops = level0_operands(B_CHECK, dev)
    k2 = 0.0
    for blur, margin in ((None, (0, 0)), (ops["blur"], (0, 0)), (ops["blur"], tff.R1_MARGIN)):
        got = tff.poly_expansion(ops["img1"], 5, 1.2, hk, wk, blur, margin)
        ref = tff._poly_expansion_plain(ops["img1"], 5, 1.2, hk, wk, blur, margin)
        k2 = max(k2, exact_check(got, ref, f"K2 main path {margin}"))
    for name in K2_CASES:
        kernel, plain = k2_case(name, dev)
        k2 = max(k2, exact_check(kernel(), plain(), f"K2 {name}"))
    errs["poly_expansion"] = k2
    emit({"phase": "check", "kernel": "poly_expansion", "cases": ["main_path", *K2_CASES],
          "max_abs_err": k2, "tolerance": 0})

    args = (ops["dx"], ops["dy"], ops["r0"], ops["r1"], ops["bsc"], RADIUS)
    f32 = dict(out_dtype=torch.float32)
    errs["update_matrices_sep"] = exact_check(
        tff.update_matrices_sep(*args), tff._update_matrices_sep_plain(*args), "K3")
    errs["update_matrices_sep_f32"] = exact_check(
        tff.update_matrices_sep(*args, **f32),
        tff._update_matrices_sep_plain(*args, **f32), "K3 f32")
    for name, (route, dtype, radius, _) in K3_CASES.items():
        key = ("update_matrices_sep_level" if route == "level" else
               "update_matrices_sep" if dtype == torch.bfloat16 else "update_matrices_sep_f32")
        kernel, plain = k3_case(name, dev)
        errs[key] = max(errs.get(key, 0.0), exact_check(kernel(), plain(), f"K3/K5 {name}"))
    for key in ("update_matrices_sep", "update_matrices_sep_f32"):
        emit({"phase": "check", "kernel": key, "cases": ["main_path", *K3_CASES],
              "max_abs_err": errs[key], "tolerance": 0})

    for key, m in (("fused_box_update", ops["m"]), ("fused_box_update_f32", ops["m32"])):
        for winsize, radius in K4_CASES:
            for out in ("matrices", "flow"):
                kargs = (m, ops["r0"], ops["r1"], ops["bsc"], winsize, radius, out)
                err = exact_check(tff.fused_box_update(*kargs),
                                  tff._fused_box_update_plain(*kargs),
                                  f"{key} ({winsize}, {radius}) {out}")
                errs[key] = max(errs.get(key, 0.0), err)
                emit({"phase": "check", "kernel": key, "winsize": winsize, "radius": radius,
                      "emit": out, "max_abs_err": err, "tolerance": 0})
    torch.cuda.synchronize()
    del ops

    # K5–K7 at the autodriving path's level 0, radius 3 and 8 (beyond the TPU
    # kernels' halo of 8)
    for radius in (RADIUS, 8):
        ad = ad_level0_operands(AD_B_CHECK, dev, pad=radius + 1)
        uargs = (ad["dx"], ad["dy"], ad["r0"], ad["r1p"], ad["bsc"], radius)
        err = exact_check(tff.update_matrices(*uargs, separable=True),
                          tff._update_matrices_plain(*uargs, separable=True), "K5")
        errs["update_matrices_sep_level"] = max(errs["update_matrices_sep_level"], err)
        emit({"phase": "check", "kernel": "update_matrices_sep_level", "radius": radius,
              "max_abs_err": err, "tolerance": 0})
        err = exact_check(tff.update_matrices(*uargs), tff._update_matrices_plain(*uargs),
                          "K7")
        errs["update_matrices"] = max(errs.get("update_matrices", 0.0), err)
        emit({"phase": "check", "kernel": "update_matrices", "radius": radius,
              "max_abs_err": err, "tolerance": 0})
        del ad, uargs
    for name in K7_CASES:
        kernel, plain = k7_case(name, dev)
        errs["update_matrices"] = max(errs["update_matrices"],
                                      exact_check(kernel(), plain(), f"K7 {name}"))
    emit({"phase": "check", "kernel": "update_matrices", "cases": list(K7_CASES),
          "max_abs_err": errs["update_matrices"], "tolerance": 0})
    ad = ad_level0_operands(AD_B_CHECK, dev)
    for winsize in (ad["winsize"], 15, 21):  # 21: m = 10, beyond the TPU kernel's 8
        err = flow_check(tff.box_solve(ad["m"], winsize),
                         tff._box_solve_plain(ad["m"], winsize), "K6")
        errs["box_solve"] = max(errs.get("box_solve", 0.0), err)
        emit({"phase": "check", "kernel": "box_solve", "winsize": winsize,
              "max_abs_err": err, "tolerance": "1e-5 px"})
    torch.cuda.synchronize()
    return errs


def kernel_entry(launches: dict, errs: dict, entries: list, key: str, kernel, plain,
                 library, nbytes: float, flops: float, batch: int, plain_iters: int = 5,
                 **extra) -> None:
    """Time ``kernel``, its ``plain`` version and the ``library`` call (or
    None) and append the kernel's line of the ``kernels`` summary, with its
    bound from ``nbytes`` and ``flops``, to ``entries``."""
    bms, by = bound_ms(nbytes, flops)
    e = {"name": key, "route": "cuda", "source": SOURCES[key][0],
         "replaces": SOURCES[key][1], "launches": launches[key],
         "max_abs_err": errs[key], "ms": time_ms(kernel),
         "plain_ms": time_ms(plain, iters=plain_iters, warm=1), "bound_ms": bms,
         "bound_by": by, "library_ms": time_ms(library) if library else None}
    e.update(extra)
    emit({"phase": "kernel_time", "batch": batch, **e})
    entries.append(e)


def kernel_times(launches: dict, errs: dict, dev, prev) -> list[dict]:
    """Each kernel's time at its path's level-0 shapes, beside its bound,
    its plain version's time and, where one exists, the time of one PyTorch
    call computing the same function."""
    entries = []
    entry = functools.partial(kernel_entry, launches, errs, entries)

    # ── the main path's level-0 shapes, B = 256 ──
    b = B_MAIN
    hk, wk = WIN
    ops = level0_operands(b, dev)
    frames = prev
    oy = torch.full((b,), 100, dtype=torch.int32, device=dev)
    ox = torch.full((b,), 160, dtype=torch.int32, device=dev)
    dst = torch.empty((b, hk, wk), dtype=torch.uint8, device=dev)
    n_, nb = 5, 1
    hp, wp = hk, wk
    h1, w1 = hp + 2 * tff.R1_MARGIN[0], wp + 2 * tff.R1_MARGIN[1]
    e = RADIUS + 1
    px = b * hp * wp
    # the warp reads r1 at rows y + ky and columns x + kx, ky, kx in
    # [-r, r + 1]: the canvas and a ring of r (top, left) and r + 1
    # (bottom, right), not the whole margin canvas
    r1_read = b * 5 * (hp + 2 * RADIUS + 1) * (wp + 2 * RADIUS + 1) * 4
    # operations with every intermediate computed once: the blur (2 passes
    # of 4·nb+1), the expansion's vertical (9n+1) and horizontal (18n+2)
    # sums and its 9 final operations; the warp's pass 1 once per row
    # ((2r+2) taps × 14), pass 2 ((2r+2) × 14) and the build (34); the box
    # sums (recurrence 2, log tree 6, scale 1 per channel) and the solve (11)
    warp_ops = (2 * RADIUS + 2) * 14 * (1 + 2 * e / hp) + (2 * RADIUS + 2) * 14 + 34
    box_ops = (5 * (2 + 6 + 1) + 11) * (1 + 2 * e / 32)
    sep_args = (ops["dx"], ops["dy"], ops["r0"], ops["r1"], ops["bsc"], RADIUS)
    ox_odd = torch.full((b,), 161, dtype=torch.int32, device=dev)
    entry("crop_windows",
          lambda: troi.crop_windows_batch(frames, oy, ox, hk, wk),
          lambda: troi.crop_windows(frames, oy, ox, hk, wk),
          lambda: dst.copy_(frames[:, 100:100 + hk, 160:160 + wk]),
          2 * b * hk * wk, 0, b,
          unaligned_origin={"ox": 161, "ms": time_ms(
              lambda: troi.crop_windows_batch(frames, oy, ox_odd, hk, wk)),
              "library_ms": time_ms(
                  lambda: dst.copy_(frames[:, 100:100 + hk, 161:161 + wk]))})
    # K2 without the blur and margin beside one conv2d of the edge-padded
    # window with the five 2-D filters (float32, no TF32)
    xpad = tff._extend(ops["img1"], n_, hp - hk + n_, n_, wp - wk + n_)[:, None]
    filt = poly_filters_2d(n_, 1.2, dev)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        conv = lambda: torch.nn.functional.conv2d(xpad, filt)  # noqa: E731
        lib_err = (conv() - tff.poly_expansion(ops["img1"], 5, 1.2, hp, wp)).abs().max().item()
        if not lib_err <= 1e-3:
            raise AssertionError(f"the conv2d yardstick differs from K2 by {lib_err}")
        nb_bms, nb_by = bound_ms(b * hk * wk * 4 + b * 5 * hp * wp * 4,
                                 b * hp * wp * (27 * n_ + 12))
        no_blur = {"ms": time_ms(lambda: tff.poly_expansion(ops["img1"], 5, 1.2, hp, wp)),
                   "library_ms": time_ms(conv), "library_max_abs_err": lib_err,
                   "bound_ms": nb_bms, "bound_by": nb_by}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    del xpad
    entry("poly_expansion",
          lambda: tff.poly_expansion(ops["img1"], 5, 1.2, hp, wp, ops["blur"], tff.R1_MARGIN),
          lambda: tff._poly_expansion_plain(ops["img1"], 5, 1.2, hp, wp, ops["blur"],
                                            tff.R1_MARGIN), None,
          b * hk * wk * 4 + b * 5 * h1 * w1 * 4,
          b * h1 * w1 * (2 * (4 * nb + 1) + 27 * n_ + 12), b, no_blur_form=no_blur)
    for key, out_bytes, dtype in (("update_matrices_sep", 10, torch.bfloat16),
                                  ("update_matrices_sep_f32", 20, torch.float32)):
        entry(key,
              lambda: tff.update_matrices_sep(*sep_args, out_dtype=dtype),
              lambda: tff._update_matrices_sep_plain(*sep_args, out_dtype=dtype), None,
              b * hk * wk * 4 * 2 + hk * wk * 4 + px * 20 + r1_read + px * out_bytes,
              px * warp_ops, b)
    for key, m, m_bytes in (("fused_box_update", ops["m"], 10),
                            ("fused_box_update_f32", ops["m32"], 20)):
        kargs = (m, ops["r0"], ops["r1"], ops["bsc"], 15, RADIUS)
        fb, fby = bound_ms(px * m_bytes + px * 8, px * box_ops)
        flow_emit = {
            "ms": time_ms(lambda: tff.fused_box_update(
                m, None, None, ops["bsc"], 15, RADIUS, "flow")),
            "plain_ms": time_ms(lambda: tff._fused_box_update_plain(
                m, None, None, ops["bsc"], 15, RADIUS, "flow"), iters=5, warm=1),
            "bound_ms": fb, "bound_by": fby,
        }
        entry(key,
              lambda: tff.fused_box_update(*kargs, "matrices"),
              lambda: tff._fused_box_update_plain(*kargs, "matrices"), None,
              px * m_bytes + px * 20 + r1_read + hk * wk * 4 + px * m_bytes,
              px * (box_ops + warp_ops), b, flow_emit=flow_emit)
    del ops
    torch.cuda.synchronize()

    # ── the autodriving path's level-0 shapes, B = 128 ──
    b = AD_B
    ad = ad_level0_operands(b, dev)
    _, _, h, w = ad["r0"].shape
    px = b * h * w

    def upd_bytes(radius):  # dx, dy, bsc, r0, r1 and its ring of r and r + 1, M
        return px * 4 * 2 + h * w * 4 + px * 20 + b * 5 * (
            h + 2 * radius + 1) * (w + 2 * radius + 1) * 4 + px * 20

    taps = 2 * RADIUS + 2
    uargs = (ad["dx"], ad["dy"], ad["r0"], ad["r1p"], ad["bsc"], RADIUS)
    sep_ops = taps * 14 * (1 + 2 * e / h) + taps * 14 + 34
    # K7 sums the four taps whose hat weights can be non-zero: each a weight
    # product, 5 products and 5 sums; 4 hat weights of 4 operations; the build
    full_ops = 4 * 11 + 4 * 4 + 34
    entry("update_matrices_sep_level",
          lambda: tff.update_matrices(*uargs, separable=True),
          lambda: tff._update_matrices_plain(*uargs, separable=True), None,
          upd_bytes(RADIUS), px * sep_ops, b)
    # K7 also at radius 8, where the full sum has 324 taps: r1 edge-padded by 9
    r1p8 = tff._extend(ad["r1p"], 5, 5, 5, 5)
    uargs8 = (*uargs[:3], r1p8, uargs[4], 8)
    bms8, by8 = bound_ms(upd_bytes(8), px * full_ops)
    radius_8 = {"ms": time_ms(lambda: tff.update_matrices(*uargs8)),
                "plain_ms": time_ms(lambda: tff._update_matrices_plain(*uargs8),
                                    iters=2, warm=1),
                "bound_ms": bms8, "bound_by": by8}
    del r1p8, uargs8
    entry("update_matrices",
          lambda: tff.update_matrices(*uargs),
          lambda: tff._update_matrices_plain(*uargs), None,
          upd_bytes(RADIUS), px * full_ops, b, radius_8=radius_8)
    win = 2 * (ad["winsize"] // 2) + 1
    entry("box_solve",
          lambda: tff.box_solve(ad["m"], ad["winsize"]),
          lambda: tff._box_solve_plain(ad["m"], ad["winsize"]), None,
          px * 20 + px * 8, px * (5 * (2 * tree_adds(win) + 1) + 11), b)
    del ad
    torch.cuda.synchronize()

    return entries


def k8_time(launches: dict, errs: dict, dev) -> dict:
    """K8's line at the stream's shapes (129 compressed frames on the 6×8
    grid, n_substeps 1000), its plain version at K8_PLAIN_SUBSTEPS, and its
    chain bound beside the bytes-and-operations bound."""
    entries = []
    entry = functools.partial(kernel_entry, launches, errs, entries)
    sim = stream_sim()
    comp = tfs.compress_frames(stream_frames(0, dev).float() / 255.0, sim.m, sim.n)
    w0 = torch.full(comp.shape[1:], sim.params.w_init, device=dev)
    pairs, cells = comp.shape[0] - 1, w0.numel()
    steps = pairs * sim.n_substeps
    few = dataclasses.replace(sim, n_substeps=K8_PLAIN_SUBSTEPS)
    # the substeps each cell runs before its fixed-point exits
    ran = torch.empty(cells, dtype=torch.int32, device=dev)
    tfs._scan_device_cuda(comp, sim, w0, False, ran)
    longest = int(ran.max())
    # a substep: w·s, 1 − ·, the power, two products, the add and the clamp's
    # two comparisons; a pair adds the transfer, the modulation and the map
    entry("device_scan", lambda: tfs.scan_device(comp, sim, w0),
          lambda: tfs.scan_device_plain(comp, few, w0), None,
          comp.numel() * 4 + cells * 4 * 2 + pairs * cells,
          int(ran.sum()) * 8 + cells * pairs * 16,
          1, plain_iters=1, plain_n_substeps=K8_PLAIN_SUBSTEPS,
          ms_at_plain_n_substeps=time_ms(lambda: tfs.scan_device(comp, few, w0)),
          n_substeps=sim.n_substeps, pairs=pairs, cells=cells,
          chain_bound_ms=steps * K8_STEP_NS * 1e-6,
          chain_bound_by="pairs × n_substeps dependent steps, each reckoned at "
                         f"{K8_STEP_NS:.1f} ns (8 float32 operations at 4 cycles and "
                         "log2 and exp2 at ~18 cycles, 1.98 GHz)",
          substeps_longest_cell=longest, substeps_mean_cell=float(ran.float().mean()),
          chain_bound_run_ms=longest * K8_STEP_NS * 1e-6,
          chain_bound_run_by="the longest cell's substeps at the same "
                             f"{K8_STEP_NS:.1f} ns a step")
    entries[0]["ns_per_step_longest_cell"] = entries[0]["ms"] * 1e6 / max(longest, 1)
    return entries[0]


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda", torch.cuda.current_device())
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    secs = _build.build_all()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_kernel": {k: round(v, 3) for k, v in secs.items()},
          "ptxas": _build.BUILD_INFO})

    errs = check_kernels(dev)
    check_k8(errs, dev)

    # ── the paths at full width ──
    launches = {}
    grasp = bench_cfg()
    got, _ = drive_path(grasp, bench_inputs, B_MAIN, EXPECTED_LAUNCHES, dev, trace=True,
                        kernel_mode="fused")
    launches.update(got)
    got, _ = drive_path(grasp, bench_inputs, B_MAIN, F32_LAUNCHES, dev, trace=False,
                        kernel_mode="fused_f32")
    launches.update({k: v for k, v in got.items() if k.endswith("_f32")})
    ad = DATASETS["autodriving"]
    for mode, expected in AD_LAUNCHES.items():
        got, _ = drive_path(ad, ad_inputs, AD_B, expected, dev, trace=True,
                            kernel_mode=mode)
        launches.update({k: v for k, v in got.items() if k != "crop_windows"})

    # ── the tracking and prediction heads and the dual path ──
    drive_tracking(dev)
    drive_prediction(dev)
    drive_dual(dev)

    # ── the device simulation: the stream, the event-gated stream, FLAG=1 ──
    launches.update({k: v for k, v in drive_stream(dev).items() if k == "device_scan"})
    drive_events(dev)
    drive_flag1(dev)

    # ── serving, the runners and the CLI ──
    drive_engine(dev)
    drive_serve(dev)
    drive_runner(dev)
    drive_cli(dev)

    # ── the deep backends: RAFT, its alternate corr mode, the batch and its
    #    engine, FlowFormer ──
    backend, allpairs = drive_deep_raft(dev)
    drive_deep_alt(dev, backend, allpairs)
    del backend, allpairs
    deep_launches = drive_deep_batch(dev)
    drive_deep_flowformer(dev)

    # ── the training slice: parity with the CPU, RAFT-basic at full width,
    #    remat, FlowFormer with the twins group, the CLI ──
    start = time.perf_counter()
    samples = chairs_samples(TRAIN_SAMPLES, seed=0)
    emit({"phase": "phase_seconds", "name": "train_samples",
          "seconds": time.perf_counter() - start, "card": smi_line()})
    for phase, drive in (("train_parity", lambda: drive_train_parity(dev)),
                         ("train_raft", lambda: drive_train_raft(dev, samples)),
                         ("train_remat", lambda: drive_train_remat(dev, samples)),
                         ("train_flowformer", lambda: drive_train_flowformer(dev, samples)),
                         ("train_cli", lambda: drive_train_cli(dev, samples))):
        start = time.perf_counter()
        drive()
        emit({"phase": "phase_seconds", "name": phase, "seconds": time.perf_counter() - start,
              "card": smi_line()})

    # ── the detection slice: K9, YOLOv8 at every scale, run_detection ──
    start = time.perf_counter()
    check_k9(errs, dev)
    detect_launches, k9_args = drive_detect(dev)
    emit({"phase": "phase_seconds", "name": "detect", "seconds": time.perf_counter() - start,
          "card": smi_line()})

    # ── the ground-truth tooling: SAM, OWL-ViT, the chain and /api/segment ──
    start = time.perf_counter()
    frame = gt_frame(dev)
    sam_model = drive_gt_sam(dev, frame)
    prop = drive_gt_owlvit(dev, frame)
    drive_gt_chain(dev, sam_model, prop)
    del sam_model, prop
    torch.cuda.empty_cache()
    emit({"phase": "phase_seconds", "name": "gt", "seconds": time.perf_counter() - start,
          "card": smi_line()})

    # ── the parallel slice at world size 1 over NCCL: dp seg, dp×tp training,
    #    sp Farnebäck, pp RAFT ──
    start = time.perf_counter()
    drive_parallel(dev, samples)
    emit({"phase": "phase_seconds", "name": "parallel", "seconds": time.perf_counter() - start,
          "card": smi_line()})

    # ── per-kernel times at each path's level-0 shapes ──
    _, prev, _ = bench_inputs(B_MAIN, 0, dev)
    kernels = kernel_times(launches, errs, dev, prev)
    kernels.append(k8_time(launches, errs, dev))
    kernels.append(deep_k1_time(deep_launches, dev))
    kernels.append(k9_time(detect_launches, errs, k9_args))

    emit({"kernels": kernels})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
