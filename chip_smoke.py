#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (occformer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  0. probe:      the backend viability probe
                 (occformer_tpu_torch.tools.probe_viability): builds only
                 csrc/probe.cu and holds P1 (add_one) and P2 (row_gather)
                 exactly against their plain versions, then times them, x + 1
                 and index_select (by events and by the profiler's device
                 time), an empty kernel (the launch floor) and torch.gather;
                 a broken toolchain fails here in seconds.
  1. build:      compile every other CUDA kernel of the package from its
                 sources, one nvcc per source, all started together.
  2. serve:      the flagship config (occformer_nusc_r50_256x704) at full
                 width and depth, random weights from a seeded
                 torch.Generator, float32 parameters with the forward under
                 bfloat16 autocast (as the JAX package serves), through
                 build_eval_step on a synthetic 6-camera batch with 35000
                 LiDAR points: 1 warm-up frame, then 3 timed frames, and a
                 torch.profiler summary of one more frame (its ``stage:*``
                 ranges, kernels, operators); then, once, the route served
                 before (every tensor cast to bf16) on the same weights: its
                 frames, peak, point-prediction agreement and largest score
                 gap; the analytic FLOP count of a frame
                 (tools/model_analysis.py:forward_flops) on the card, held
                 equal to the count of the same config's model on the CPU
                 (the plain versions), and the MFU of the median frame
                 against the dense bf16 peak.  It runs before any
                 backward: a backward leaves the cuBLAS workspaces of
                 autograd's threads resident (65 MiB), which a serving
                 process never holds and its peak would count.
  3. kernels:    hold each kernel against its plain PyTorch version at the
                 shapes the flagship's main paths give it, and time both (CUDA
                 events, median of 30 after warm-up) beside the one PyTorch
                 call that computes the same function, where there is one
                 (each backward checked through the autograd Function the
                 train step runs, timed at its launch alone; the redesigned
                 forwards also by the profiler's device time):
                 K1 (ms_deform_gather_3d) and K1-bwd at the pixel decoder's
                 shapes in float32 and bfloat16, at uniform and at local
                 locations (K1's row-wide kernel with 16-byte vectors, two
                 calls held bit-equal; its other rows, hd 12 and 7 in bf16,
                 6 and 24 at a misaligned value in float32, held and timed
                 on the vector width the path picks); K2
                 (trilerp_sample) and K2-bwd at the per-layer loss's
                 candidate readout (bf16 feature table, border,
                 align_corners=False; K2's row-wide path, two calls held
                 bit-equal, and its narrow ("scalar") path timed beside it;
                 the narrow path at the per-slot GT masks and the GT table
                 too, beside F.grid_sample with and without the bool ->
                 float cast), K2-bwd's segmented path also
                 at its random fill, two of its calls held bit-equal, and
                 its narrow path timed at the candidate readout too (the
                 kernel the segmented one replaced there; the sweep over row
                 widths behind the path threshold is tools/time_backwards.py
                 --sweep); K2 on the per-slot GT masks and a zeros /
                 align_corners=True case; K2 (its narrow path) / K2-bwd
                 (its narrow path) at the batched loss's three readouts; K3
                 (sample_id_masks) at the batched loss's three GT reads and
                 a zeros / align_corners=True case on a 40x24x12 grid; the
                 K4 parity gate, K4 at its small shapes also by device time,
                 and at the flagship's shapes K4 with 16-byte vectors (two
                 calls bit-equal), in bf16 and float32, and its other rows
                 (C 6 in float32, 12 in bf16, 24 in bf16 at misaligned
                 tables) beside F.grid_sample; K4
                 and K4-bwd at the DepthNet DCN's shapes (two K4-bwd calls
                 bit-equal) beside F.grid_sample 2-D forward and backward.
  4. tiny:       the tiny test model's forward on the card (kernels) against
                 the same model on the CPU (plain versions), float32.
  5. tiny_train: the tiny model's train step on the card against the same
                 step on the CPU, from the same state with the same draws:
                 losses, every gradient and every updated parameter; on the
                 per-layer loss route, on the batched route, and with
                 accum_steps=2 on a 2-sample batch (batched route).
  5b. reload_determinism: pairs of train steps from one reloaded state,
                 on the port's default settings (no torch deterministic mode,
                 no global cuDNN switch, cuDNN's TF32 as torch sets it), on
                 the tiny CLI model and on the flagship, with the LSS
                 scatter's atomic order (C.4's record) and as the port runs
                 (the default), then on the flagship's batched loss route:
                 losses, LSS volumes, the loss's uncertainty selections,
                 grad_norm and every parameter's gradient compared bit for
                 bit, and on the batched route the loss's gradients; every
                 pair of the port as it runs must repeat them all (C.6-C.8);
                 then each convolution of the tiny model and of the
                 flagship, and the tiny model's linear, norm and window
                 attention modules, replayed at the inputs their step gave
                 them: none may vary as the model runs it, and those whose
                 cuDNN default backward varies, with and without TF32, are
                 named and timed beside cuDNN's deterministic backward; and
                 S1 against its plain version and the scatter's cost per
                 step in both modes, and its backward S1-bwd against its
                 plain version (the same at the KITTI and R101 kernels
                 phases; S1-rows-bwd in voxnet_kernels).
  6. train:      the flagship's train step at full width and depth, float32
                 parameters under bfloat16 autocast, batch 1, through
                 build_train_step on the per-layer loss route: 1 warm-up
                 step, then 3 timed steps, and a torch.profiler summary of
                 one more step (with each port kernel's device ms and
                 launches); the analytic FLOP count of one more step
                 (utils/flops.py) and the MFU of the median step, and the
                 same step counted again with with_cp off, which must count
                 the same (the backward's recompute is held out).  Every
                 other configuration's serve and train phase adds the same
                 (serve_phase, profile_and_reload).
  7. train_batched: the same on the all-layer batched loss route
                 (mxu_readout="on"), plus both routes' losses and Hungarian
                 assignments on one float32 copy of a step's model outputs
                 with one set of draws.
  8. data:       the flagship's nuScenes pipeline on a tree that
                 data/fixtures.py:make_nuscenes_tree writes (8 samples at a
                 forward-looking camera rig, 34000 LiDAR points, with the
                 panoptic sidecars phases 23-25 read): the host
                 ms per sample of the train and test pipelines by step, the
                 loader's rate alone and beside train steps, then the
                 flagship's train step over the epoch of pipeline batches and
                 the served frames of the test split (launch counts, finite
                 losses, the LiDAR inside the grid, depth in every camera),
                 beside the same on synthetic batches.
  9. cli:        the train and test CLIs at the flagship's full width on
                 SyntheticOccDataset (--cfg-options), as subprocesses in a
                 temporary work directory outside the repo: 2 steps, then
                 tools.test on step_2 over 2 samples; in process, step_2
                 loaded into a fresh model and optimizer and held bit-equal
                 to the saved file.
  10. resume:    (beside phase 9, in a thread of its own) a resumed run
                 repeats the uninterrupted one (ROADMAP C.9,
                 C.10): tools.train at full width on the config's own
                 CustomNuScenesOccLSSDataset over the data phase's tree (8
                 samples an epoch) to step 6 in one go, and to step 3 then
                 resumed to step 6; every logged loss, metric and grad_norm
                 equal bit for bit; tools.test on step_6 over 2 samples with
                 its per-class IoU table; one skipped-batch restart of the
                 loader timed.
  11. soak:      tools/soak.py: 8 flagship steps on the default route with
                 the checkpoint at step 4 (the reloaded state bit-equal,
                 training going on from it), then the same 8 steps without
                 it: equal trajectories and final states, a falling loss;
                 p50 / p95 s/step and the peak (40 steps before the KITTI
                 phases came, 24 before the R101-DCN phases; tools/soak.py
                 runs 120).
  12. learn:     the tiny held-out learnability run (300 steps on 12 box
                 scenes, 4 held out; data/geo_scenes.py) on the card: SC
                 IoU > 0.15 and class mIoU > 0.08.
  13. ddp:       world size 1 under nccl and DistributedDataParallel: two
                 flagship steps repeat the plain steps' losses, grad_norm
                 and every gradient bit for bit, no parameter without a
                 gradient.
  14-17. SemanticKITTI (occformer_kitti: EfficientNet-B7 at 384x1280, one
                 camera, the 128x128x16 grid, the frequency-sampled grid
                 loss, 256x256x32 output) on a tree that
                 data/fixtures.py:make_kitti_tree writes from a seed (two
                 frames of sequence 00, two of the val sequence 08):
  14. kitti_kernels (run after phase 3, the tree written first): every
                 kernel of the KITTI path held against its plain
                 version at the shapes the path gives it and timed beside
                 its bound and library call: K1 / K1-bwd at the pixel
                 decoder's pyramid, K2 at the matching readout (C = 100) and
                 the candidates (C = 1), K2-bwd's narrow path at the
                 supervision points, K4 / K4-bwd at the one-camera DCN, S1
                 at the tree's camera.
  15. kitti_serve: the full-width model, random weights from a seeded
                 torch.Generator, float32 parameters under bf16 autocast, 4
                 served val frames (voxel_pred [1, 256, 256, 32] uint8),
                 ms per frame, the peak, a profiled frame.
  16. kitti_train: 4 train steps with with_cp on pipeline batches of the
                 train frames: s/step, the peak, the losses, a profiled
                 step; then a pair of reloaded steps whose losses, grad_norm
                 and every gradient must be bit-equal (the flagship's
                 settings: cuDNN's TF32 on, no global deterministic mode;
                 two pairs before the R101-DCN phases came).
  17. kitti_cli: tools.train for 2 steps on the tree, tools.test on step_2
                 with --test-save: semkitti_SC_IoU and semkitti_SSC_mIoU,
                 and a .label per val frame read back by utils/semkitti_io.
  18-21. R101-DCN 896x1600 (occformer_nusc_r101_896x1600: the caffe-style
                 ResNet-101 with DCNv2 in layer3 and layer4, with_cp,
                 frozen_stages=1, norm_eval, 6 cameras at 896x1600) on the
                 data phase's nuScenes tree but for phase 18:
  18. r101_kernels (run after phase 14, on a one-sample tree of its own):
                 K4 and K4-bwd at the three DCN
                 maps of the path (layer3's [6, 256, 56, 100], layer4's [6,
                 512, 28, 50], the DepthNet's [6, 512, 56, 100]) and S1 at
                 the 896 x 1600 frustum (3,763,200 points), each held
                 against its plain version and timed beside its bound and
                 library call.
  19. r101_serve (after phase 10): the config's test pipeline, 4 served
                 frames (K4 27 times a frame), the peak, a profiled frame.
  20. r101_train: 4 train steps on the per-layer route with with_cp (K4 53
                 times a step, K4-bwd 27), the frozen stem and layer1 and
                 every BatchNorm statistic unmoved, a profiled step, one
                 reloaded pair bit for bit.
  21. r101_cli:  tools.train for 2 steps with --load-from a synthetic FCOS3D
                 file (only its img_neck.* unused), then tools.test with the
                 _trainval config (placeholder labels) on step_2 over 2
                 samples with --test-save.
  22-25. panoptic (occformer_nusc_panoptic_r50_256x704: the flagship's
                 model with 150 queries and with_cp, GT slots of panoptic
                 segments, class * 1000 + instance, padded to 100, PQ / SQ /
                 RQ) on the data phase's nuScenes tree, whose panoptic
                 sidecars make its boxes the instances, but for phase 22:
  22. pan_kernels (run after phase 18, on its one-sample tree, which has
                 the sidecars too): K2 and K2-bwd at the per-layer
                 route's random fill (1,254,400 rows of the bf16 mask
                 feature), K2 at the 100-slot bool GT table (candidates,
                 matching points), K3 at the panoptic ids (shared [10,
                 150528], per-slot [10, 100, 12544], bit for bit), each
                 against its plain version and timed beside its bound and
                 library call.
  23. pan_serve (after phase 21): 4 frames of the test pipeline through
                 build_eval_step(panoptic=True) (the per-query point masks
                 through one more K2), each frame's host formatting into PQ
                 counters timed apart, evaluate(panoptic=True) over the
                 frames, the peak, a profiled frame.
  24. pan_train: 3 steps on the per-layer route with with_cp and the
                 config's grad clip, a profiled step, one reloaded pair bit
                 for bit, both routes' losses and assignments on one step's
                 outputs, one batched-route step (K3 at the panoptic ids).
  25. pan_cli:   tools.train for 2 steps on the tree, then tools.test on
                 step_2 over 2 samples, printing PQ / SQ / RQ.
  26-29. temporal (no released config: the JAX package has no two-frame
                 pipeline and no temporal config; the batches are built here):
  26. stereo_kernels (run after phase 22, on its one-sample tree): K4 and
                 K4-bwd as BEVStereo sends them, held against the plain
                 version and timed beside their bounds, F.grid_sample 2-D
                 and its autograd: the stereo warp ([6, 64*176, 256] bf16 at
                 6 x 33,792 points from models/bevstereo.py:warp_grid on the
                 tree's rig, K4-bwd without d_coords), the mask warp ([6,
                 704, 112]) and DepthNetStereo's DCN.
  27. t4d_serve (after phase 25): the flagship's model as
                 OccupancyFormer4D (the occupancy encoder's input 256
                 channels) on two-frame batches of the test pipeline (sample
                 i the key frame, i + 1 the previous, 12 camera slots
                 interleaved per camera): 4 frames, K4 and S1 twice a frame,
                 the peak, a profiled frame.
  28. t4d_train: 3 steps on the per-layer route (every image and camera
                 BatchNorm moved twice a step), a profiled step, one
                 reloaded pair bit for bit, one batched-route step.
  29. stereo:    models/bevstereo.py's ViewTransformerLSSBEVStereo at full
                 width (512 / 128 channels, D = 112 in 4 ranges, 3 EM
                 steps, 2 sweeps of 6 cameras, stereo features [6, 256, 64,
                 176]) on phase 26's rig: 4 forwards (DepthNetStereo, the EM
                 stereo depth, the fusion, the splat into the flagship's
                 grid; K4 18 times, S1 once), then a fixed random weighting
                 of the fused depth differentiated twice from one state:
                 every gradient bit-equal.
  30. voxnet_kernels (run after phase 26, on its one-sample tree): S1-rows
                 (ops/scatter.py:voxel_scatter, the use_voxel_net splat) at
                 the flagship's shapes, B = 1, P = 6 * 16 * 44 * 112 =
                 473,088 rows of 128 channels into 128 x 128 x 16 at the
                 nuScenes rig's coordinates, float32 and bf16: within 1e-5 /
                 1e-2 of the plain version (atomic on the card), bit for bit
                 the plain version's on the CPU, two calls bit-equal, its
                 backward bit-equal to the plain gather; timed beside the
                 plain version, one index_add_ and its bound, its device
                 time also by kernel.
  31. voxnet_serve (after phase 28): the flagship with use_voxel_net and
                 pooling_attn_mask=False at full width and depth (3 frames
                 of the test pipeline; DepthAggregation over the lift, S1-rows
                 in place of S1, no adaptive_max_pool3d), its profiled frame's
                 view-transformer and stage:depth_aggregation device ms.
  32. voxnet_train: 3 steps on the per-layer route, a profiled step, one
                 reloaded pair bit for bit, one batched-route step.
  33. pointcloud (right after phase 30: the profiler has dropped a late
                 phase's device events): ops/pointcloud.py and ops/spconv.py
                 at their users' sizes
                 (phase_pointcloud): every op once, FPS (its one kernel)
                 launched once; FPS held to its plain version (indices
                 equal, also with invalid points), its microseconds a step
                 and the thread-block cluster it took, each op timed, the
                 sparse convs' gather backend held to the dense one at
                 [128, 128, 16].
  34. benchmark, memory (right after phase 7), export (last, in this
                 process beside the R101, panoptic and KITTI CLI phases, which
                 launch kernels only in their CLI processes): the JAX package's
                 last tools on the flagship.  benchmark: tools/benchmark.py
                 --stage-breakdown (its JSON line; the image encoder, then
                 the program through the pixel decoder, then the whole
                 forward, each slower).  memory: tools/memory_analysis.py's
                 per-layer train step (bytes by component, the peak of each
                 stage; the step's peak within 3% of phase 6's, every
                 stage's at or below it).  export: torch.library.opcheck of
                 every kernel op's CUDA implementation; the serving forward
                 (tools/export_model.py) exported at a serving frame, its
                 occformer::* nodes equal by kernel to an eager call's launch
                 counts and no operator doing a kernel's work beside them;
                 the archive loaded and run in a fresh process that imports
                 only occformer_tpu_torch.ops, its scores the eager call's
                 bit for bit, or within 1e-2 on the bf16 route (largest gap,
                 argmax agreement); with the serve phase's frames beside the
                 median frame before the kernels became dispatcher ops.
The cli phase (9) also fuses step_2 (tools/fuse_conv_bn.py) and serves one
frame from the fused checkpoint, within 1e-4 of the unfused one's.
In phases 0, 2, 6, 7, 8, 11, 12, 13, 15, 16, 19, 20, 23, 24, 27, 28, 29, 31,
32 and 33 and in the K4 parity gate every
kernel's launch count is set to 0 just before the path is driven and read
just after; each must match its per-frame, per-step or per-run count (the
learn phase: launched).  The CLIs report their own counts, which must show
their kernels.  A ``wall`` line gives each phase's seconds.  Then the card's name and power
limit (nvidia-smi), one JSON line of each configuration's analytic TFLOP a
frame and a step and MFU beside them (``ANALYTIC``), one JSON line of kernel
records (K2's and K2-bwd's two paths as two records each; K1's and K4's
other rows under ``other_rows``; S1, the LSS splat, which has no Pallas
original, and its backward S1-bwd last; each kernel of the KITTI path with
its KITTI-shape record under ``kitti``, each kernel's R101-DCN record under
``r101``, its panoptic record under ``pan``, K4's and K4-bwd's BEVStereo
records under ``stereo``; then S1-rows, S1-rows-bwd and FPS, which have no
Pallas original either),
and last
``{"ok": true, "device": {...}}``.  Any
failed check exits non-zero before that line.  Without a CUDA device, or
without the package beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "occformer_tpu_torch", "configs", "occformer_nusc_r50_256x704.py")

# kernel launches per serving frame and per train step of the flagship
# (6 deformable encoder layers; the per-layer loss route reads 10 supervised
# decoder outputs with 6 K2 launches each, 2 of them differentiated; the
# batched route reads all 10 at once: K2 at the matching points, the
# candidates and the random fill, the last two differentiated, and K3 at the
# same three point sets); PERF.md states the same counts.  "K2-bwd" counts
# both of its paths, "K2-bwd.narrow" the narrow one: the per-layer route's
# C = 192 feature takes the segmented path, the batched route's C = 17 and
# C = 1 per-slot volumes the narrow one.  The DepthNet's deformable
# convolution reads its taps through K4 (one level of Z = 1, its 512 input
# channels in bf16 rows of whole 16-byte vectors: K4's row-wide path) once a
# frame and a step, and K4-bwd once a step; the LSS splat S1 once a frame
# and a step, its backward S1-bwd once a step
_NONE = {"K1": 0, "K1.row": 0, "K1-bwd": 0, "K2": 0, "K2.row": 0, "K2-bwd": 0,
         "K2-bwd.narrow": 0, "K3": 0, "K4": 0, "K4.row": 0, "K4-bwd": 0, "P1": 0, "P2": 0,
         "S1": 0, "S1-bwd": 0, "S1-rows": 0, "S1-rows-bwd": 0, "FPS": 0}
# "K1.row": the deformable attention's hd = 24 rows take K1's row-wide path
SERVE_LAUNCHES = dict(_NONE, **{"K1": 6, "K1.row": 6, "K4": 1, "K4.row": 1, "S1": 1})
# "K2.row": the per-layer route's 30 readouts of the bf16 C = 192 feature
# take K2's row-wide path, its 30 GT-mask readouts (bool, C = 1) the narrow
# ("scalar") one; the batched route's C = 100 bf16 and C = 17 / 1 float32
# volumes all take the narrow path
_DCN = {"K4": 1, "K4.row": 1, "K4-bwd": 1}
TRAIN_LAUNCHES = {"off": dict(_NONE, **_DCN, **{"K1": 6, "K1.row": 6, "K1-bwd": 6, "K2": 60,
                                                "K2.row": 30, "K2-bwd": 20, "S1": 1,
                                                "S1-bwd": 1}),
                  "on": dict(_NONE, **_DCN, **{"K1": 6, "K1.row": 6, "K1-bwd": 6, "K2": 3,
                                               "K2-bwd": 2, "K2-bwd.narrow": 2, "K3": 3,
                                               "S1": 1, "S1-bwd": 1})}
# the K4 parity gate: bench.py's shapes at both align_corners and the
# flagship shapes, one forward (the row-wide path: C = 24 rows) and one
# backward each; the probe: P1 and P2 once
K4_GATE_LAUNCHES = dict(_NONE, **{"K4": 3, "K4.row": 3, "K4-bwd": 3})
PROBE_LAUNCHES = dict(_NONE, P1=1, P2=1)
# SemanticKITTI (occformer_kitti): one camera, so a frame launches what a
# flagship frame does; a train step the flagship's per-layer counts but for
# the grid loss's K2: per supervised layer (10) the matching voxels on the
# [X, Y, Z, 100] float32 query volume (whole 16-byte vectors: the row-wide
# path), the candidates and the supervision points on the slots' C = 1
# volumes (the narrow path), the last differentiated (K2-bwd's narrow path)
KITTI_CONFIG = os.path.join(REPO, "occformer_tpu_torch", "configs", "occformer_kitti.py")
KITTI_SERVE_LAUNCHES = SERVE_LAUNCHES
KITTI_TRAIN_LAUNCHES = dict(_NONE, **_DCN, **{"K1": 6, "K1.row": 6, "K1-bwd": 6, "K2": 30,
                                              "K2.row": 10, "K2-bwd": 10, "K2-bwd.narrow": 10,
                                              "S1": 1, "S1-bwd": 1})
# the DepthNet's deformable convolution at SemanticKITTI: one camera, 512
# channels on the 24 x 80 feature map
KITTI_DCN_SHAPE = (1, 512, 24, 80)
# R101-DCN 896x1600 (occformer_nusc_r101_896x1600): the caffe-style
# ResNet-101's 26 DCNv2 (layer3's 23 blocks, layer4's 3) and the DepthNet's
# DCN each read their taps through K4's row-wide path (bf16 rows of 256 or
# 512 channels) once a frame; a train step recomputes each of the 26 in the
# backward (with_cp) and differentiates all 27 (layer3 and layer4 are not
# frozen): K4 53 times, K4-bwd 27; the rest as the flagship's per-layer route
R101_CONFIG = os.path.join(REPO, "occformer_tpu_torch", "configs",
                           "occformer_nusc_r101_896x1600.py")
R101_TRAINVAL = os.path.join(REPO, "occformer_tpu_torch", "configs",
                             "occformer_nusc_r101_896x1600_trainval.py")
R101_SERVE_LAUNCHES = dict(SERVE_LAUNCHES, **{"K4": 27, "K4.row": 27})
R101_TRAIN_LAUNCHES = dict(TRAIN_LAUNCHES["off"], **{"K4": 53, "K4.row": 53, "K4-bwd": 27})
# the maps the deformable convolutions sample at 896 x 1600 ([B*N, C, H, W])
R101_DCN_SHAPES = {"layer3": (6, 256, 56, 100), "layer4": (6, 512, 28, 50),
                   "depthnet": (6, 512, 56, 100)}
# the panoptic configuration (occformer_nusc_panoptic_r50_256x704): the
# flagship's model with 150 queries; a served frame also reads the bf16 mask
# feature at the LiDAR points (K2's row-wide path) for the per-query point
# masks; a train step launches what the flagship's does on either route (the
# same readouts, at 100 GT slots), but that the batched route's candidate
# readout of the [10, 128, 128, 16, 100] float32 slot volumes takes K2's
# row-wide path (100 channels are whole 16-byte vectors; 17 are not)
PAN_CONFIG = os.path.join(REPO, "occformer_tpu_torch", "configs",
                          "occformer_nusc_panoptic_r50_256x704.py")
PAN_SERVE_LAUNCHES = dict(SERVE_LAUNCHES, **{"K2": 1, "K2.row": 1})
PAN_TRAIN_LAUNCHES = TRAIN_LAUNCHES["off"]
PAN_TRAIN_LAUNCHES_BATCHED = dict(TRAIN_LAUNCHES["on"], **{"K2.row": 1})
# the temporal configuration: the flagship's model as OccupancyFormer4D (the
# occupancy encoder's input doubled to 256 channels), 12 camera slots (key
# and previous frame interleaved per camera); each frame runs the image
# encoder, the DepthNet (its DCN: K4) and the splat (S1), the previous one
# without gradient: K4 and S1 twice a frame and a step, K4-bwd and S1-bwd
# once a step
_TWO_FRAMES = {"K4": 2, "K4.row": 2, "S1": 2}
T4D_SERVE_LAUNCHES = dict(SERVE_LAUNCHES, **_TWO_FRAMES)
T4D_TRAIN_LAUNCHES = {route: dict(n, **_TWO_FRAMES) for route, n in TRAIN_LAUNCHES.items()}
# the flagship with use_voxel_net and trilinear attention masks: the refined
# lift splats through S1-rows in place of S1, once a frame and a step, and
# a step differentiates it through S1-rows-bwd in place of S1-bwd; the rest
# is the flagship's
_ROWS = {"S1": 0, "S1-rows": 1}
VOXNET_SERVE_LAUNCHES = dict(SERVE_LAUNCHES, **_ROWS)
VOXNET_TRAIN_LAUNCHES = {route: dict(n, **_ROWS, **{"S1-bwd": 0, "S1-rows-bwd": 1})
                         for route, n in TRAIN_LAUNCHES.items()}
# the point-cloud surface's run: every op once, FPS its one kernel
POINTCLOUD_LAUNCHES = dict(_NONE, FPS=1)
# BEVStereo at the flagship's grid (4 ranges over dbound [2, 58, 0.5]: D = 112,
# 3 EM steps, 3 samples, 8 groups, 2 sweeps of 6 cameras): a forward runs the
# two sweeps' DepthNetStereo DCNs, 4 x 3 stereo warps of the 256-channel
# features and 4 mask warps of the 112-bin mono depth, all on K4's row-wide
# path, and one splat; the backward of the fused depth K4-bwd for the 12
# stereo warps and the key sweep's DCN (the other sweep's DepthNet reaches
# the depth only through the mask's detached input); no S1-bwd: the
# weighting is of the fused depth, upstream of the splat, whose volume no
# gradient reaches
STEREO_LAUNCHES = dict(_NONE, **{"K4": 18, "K4.row": 18, "S1": 1})
STEREO_BWD_LAUNCHES = dict(STEREO_LAUNCHES, **{"K4-bwd": 13})
STEREO_FEATURES = (6, 256, 64, 176)  # a ResNet-50 layer1's width at 1/4 of 256 x 704
STEREO_IMAGE_FEATURES = (6, 512, 16, 44)
# the pyramid of the deformable attention, largest level first, as bench.py
# (tools/time_backwards.py:K4_PYRAMID)
K4_PYRAMID = [(64, 64, 8), (32, 32, 4), (16, 16, 2)]
# the pixel decoder's deformable encoder, as grads_differ_by_module names it
ENCODER = "img_bev_encoder_neck.encoder"
# the outermost torch.profiler ranges of a frame and of a train step
SERVE_STAGES = ("upload", "image_encoder", "view_transformer", "occupancy_encoder",
                "pixel_decoder", "head", "readout")
TRAIN_STAGES = ("forward", "loss", "backward", "optimizer")


_STDOUT = threading.Lock()  # phases that run side by side write whole lines


def emit(obj):
    say(json.dumps(obj))


def say(line):
    with _STDOUT:
        sys.stdout.write(line + "\n")
        sys.stdout.flush()


def side_by_side(*calls, main=None):
    """Each ``(fn, *args)`` in a thread of its own, all at once (phases that
    only drive CLI processes), and ``main``, where given, in this thread
    meanwhile; their results in order (``main``'s last) once all have
    ended, the first failure raised then."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(calls)) as pool:
        futures = [pool.submit(fn, *args) for fn, *args in calls]
        ran = [main[0](*main[1:])] if main else []
    return [f.result() for f in futures] + ran


def check(cond, msg):
    if not cond:
        print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def time_cuda(fn, iters=30, warmup=5):
    """Median ms of ``fn()`` over CUDA-event timed calls (the port's
    ``utils/timing.py``)."""
    from occformer_tpu_torch.utils.timing import time_cuda as timed

    return timed(fn, iters, warmup)


def nbytes(*tensors):
    from occformer_tpu_torch.utils.timing import nbytes as total

    return total(*tensors)


TRACE_ATTEMPTS = 3


def device_ms(fn, iters=20, warmup=3, by_kernel=False):
    """Device ms per call of ``fn()`` from the profiler
    (``utils/timing.py:device_trace``, whose trace opens with a lead-in the
    profiler may drop in place of the calls' records).  The trace must show
    device activity and every port-kernel launch of its ``iters`` calls
    (the launch counts' rise over the warm-up and traced calls, pro rata);
    one that does not is taken again, up to ``TRACE_ATTEMPTS`` traces, and
    the run fails if none does, so that a dropped or partial trace cannot
    stand as a time (CUPTI dropped a whole trace once early in a run, PR
    13's final call; late in a run it drops a trace's first records, which
    took every launch of 7.7 ms FPS kernels in a trace of three).
    ``by_kernel``: also the device ms per call of each kernel, copy and fill
    (by the first 80 characters of its name)."""
    from occformer_tpu_torch.utils.timing import device_trace

    calls = warmup + iters
    for _ in range(TRACE_ATTEMPTS):
        before = launches()
        ms, kernels = device_trace(fn, iters, warmup)
        ran = {k: v - before[k] for k, v in launches().items()}
        want = {k: v * iters // calls for k, v in ran.items()}
        traced = traced_launches(port_kernel_ms(kernels)["by_kernel"])
        if ms > 0 and traced == want:
            if by_kernel:
                return ms, {e.key[:80]: e.self_device_time_total / 1e3 / iters
                            for e in kernels}
            return ms
    check(False, f"the profiler's device time: {TRACE_ATTEMPTS} traces, the last with "
          f"{ms} ms a call and port-kernel launches {traced}, want {want}")
    return ms


def bound(n_bytes, flops):
    """The least time the card could take (``utils/timing.py:bound``)."""
    from occformer_tpu_torch.utils.timing import bound as least

    return least(n_bytes, flops)


def launches():
    from occformer_tpu_torch.ops import launch_counts

    return launch_counts()


def reset_launches():
    from occformer_tpu_torch.ops import reset_launch_counts

    reset_launch_counts()


def free_memory():
    """Frees what earlier phases left behind (autograd graphs hold reference
    cycles), so that a phase's peak memory counts only its own tensors."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def compare(got, ref, rel, name):
    """max |got - ref| within ``rel * max|ref|``; returns the record."""
    scale = ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    limit = rel * scale
    check(bool(got.float().isfinite().all()), f"{name}: non-finite values")
    check(err <= limit, f"{name}: max|diff| {err} > {limit}")
    return {"max_abs_err": err, "max_abs_plain": scale, "limit": limit}


# each configuration's analytic count and MFU, for the summary line
ANALYTIC = {}


def _config_of(phase):
    """The configuration a serve or train phase drives: the flagship's
    phases are "serve", "train" and "train_batched", the others' are
    prefixed with the configuration ("kitti_serve", "kitti_train", ...)."""
    return "flagship" if phase in ("serve", "train", "train_batched") else phase.split("_")[0]


def analytic_serve(name, model, batch, compute_dtype, frame_ms):
    """The analytic FLOP count (``tools/model_analysis.py:forward_flops``:
    the deployment forward, the model then ``format_results``) of one of the
    phase's frames, counted on the card, and the MFU of the phase's median
    frame against the H100 SXM's dense bf16 peak (``utils/flops.py``)."""
    from occformer_tpu_torch.tools.model_analysis import forward_flops
    from occformer_tpu_torch.utils.flops import H100_PEAK_BF16, mfu

    f = forward_flops(model, batch, compute_dtype)
    B = int(np.asarray(batch["imgs"]).shape[0])
    med = float(np.median(frame_ms))
    rec = {"analytic_fwd_TFLOP_per_frame": f["total"] / B / 1e12,
           **{f"analytic_fwd_TFLOP_per_frame/{k}": f[k] / B / 1e12
              for k in ("conv", "dot", "scatter")},
           "median_frame_ms": med, "inference_mfu": mfu(f["total"] / B, 1e3 / med),
           "peak_TFLOPs": H100_PEAK_BF16 / 1e12}
    check(f["conv"] > 0 and f["dot"] > 0 and f["scatter"] > 0, f"{name}: analytic count {f}")
    ANALYTIC.setdefault(_config_of(name), {}).update(
        {k: rec[k] for k in ("analytic_fwd_TFLOP_per_frame", "median_frame_ms", "inference_mfu")})
    return rec


def analytic_train(name, step, batch, generator, step_s, model, opt):
    """The analytic FLOP count of one more train step (``utils/flops.py:
    count_flops`` around ``step``), counted on the card, and the MFU of the
    phase's median step against the H100 SXM's dense bf16 peak.  Every
    configuration the smoke trains has a module that recomputes its blocks
    in the backward (``with_cp``): the same step is counted again from the
    same model, optimizer and generator state with ``with_cp`` off, then
    turned back on; the recompute is not model work, so the two counts must
    be equal in every category."""
    import copy

    from occformer_tpu_torch.utils.flops import H100_PEAK_BF16, count_flops, mfu

    cp = [m for m in model.modules() if getattr(m, "with_cp", False) is True]
    check(bool(cp), f"{name}: no module of the model recomputes (with_cp)")
    state = copy.deepcopy((model.state_dict(), opt.state_dict(), generator.get_state()))
    t0 = time.perf_counter()
    t = count_flops(step, batch, generator)
    count_s = time.perf_counter() - t0
    med = float(np.median(step_s))
    rec = {"analytic_train_TFLOP_per_step": t["total"] / 1e12,
           **{f"analytic_train_TFLOP_per_step/{k}": t[k] / 1e12
              for k in ("conv", "dot", "scatter")},
           "median_step_s": med, "train_mfu": mfu(t["total"], 1.0 / med),
           "peak_TFLOPs": H100_PEAK_BF16 / 1e12, "count_s": count_s}
    check(t["conv"] > 0 and t["dot"] > 0, f"{name}: analytic count {t}")
    t0 = time.perf_counter()
    model.load_state_dict(state[0])
    opt.load_state_dict(state[1])
    generator.set_state(state[2])
    del state
    for m in cp:
        m.with_cp = False
    try:
        off = count_flops(step, batch, generator)
    finally:
        for m in cp:
            m.with_cp = True
    rec["with_cp_off_count_s"] = time.perf_counter() - t0
    rec["with_cp"] = sorted({type(m).__name__ for m in cp})
    rec["with_cp_off_TFLOP_per_step"] = {k: off[k] / 1e12
                                         for k in ("conv", "dot", "scatter", "total")}
    check(all(t[k] == off[k] for k in ("conv", "dot", "scatter")),
          f"{name}: the step counts {t} with with_cp on and {off} with it off")
    ANALYTIC.setdefault(_config_of(name), {}).update(
        {f"{k}{'_batched' if name.endswith('batched') else ''}": rec[k]
         for k in ("analytic_train_TFLOP_per_step", "median_step_s", "train_mfu")})
    return rec


def phase_k1():
    """K1 and K1-bwd against the plain version and its autograd, each at the
    uniform and at the local locations: K1 with the flagship's 16-byte
    vectors, two calls held bit-equal, timed by CUDA events and by the
    profiler's device time; then K1's other rows (``other_rows_record``:
    hd 12 and 7 in bf16, 6 and 24 at a misaligned value in float32) on the
    widths the path now picks.
    K1-bwd's two calls are held bit-equal too, at both locations (each
    d_value row summed in ascending sample order), and timed by the
    profiler's device time.  Tolerances relative to max |plain|: float32
    1e-5 forward and 1e-4 backward (the same float32 sums in another order),
    bfloat16 1e-2 (outputs rounded to bf16; the plain version runs in
    float32 on the same bf16-rounded inputs)."""
    import torch

    from occformer_tpu_torch.ops import trilerp_fused as k1
    from occformer_tpu_torch.tools.time_backwards import flagship_gather_inputs

    fwd, bwd = {}, {}
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        value, shapes, locs, w = flagship_gather_inputs(dtype, local=False)
        lv, _, ll, lw = flagship_gather_inputs(dtype, local=True)
        check(k1.ms_deform_fwd_path(value.shape[-1], dtype, (value.data_ptr(),)) == 16,
              f"K1 {name}: not 16-byte vectors")
        rel = 1e-5 if dtype == torch.float32 else 1e-2
        r = {"vector_bytes": 16, "lanes": k1.ROW_LANES}
        for where, (v_, l_, w_) in (("", (value, locs, w)), ("local_locs ", (lv, ll, lw))):
            got = k1.ms_deform_gather_3d(v_, shapes, l_, w_)
            again = k1.ms_deform_gather_3d(v_, shapes, l_, w_)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"K1 {name} {where}row path: two calls differ")
            ref = k1.ms_deform_gather_3d_plain(v_.float(), shapes, l_, w_.float())
            r[where + "values"] = compare(got, ref, rel, f"K1 {name} {where}row path")
            del again, ref
        got = k1.ms_deform_gather_3d(value, shapes, locs, w)
        r["bit_identical_calls"] = True
        r["max_abs_err"] = max(r[k]["max_abs_err"] for k in ("values", "local_locs values"))
        r["share_outside_01"] = ((locs < 0) | (locs > 1)).any(-1).float().mean().item()
        r["kernel_ms"] = time_cuda(lambda: k1.ms_deform_gather_3d(value, shapes, locs, w))
        r["device_ms"] = device_ms(lambda: k1.ms_deform_gather_3d(value, shapes, locs, w))
        r["plain_ms"] = time_cuda(
            lambda: k1.ms_deform_gather_3d_plain(value, shapes, locs, w), iters=20)
        r["kernel_ms_local_locs"] = time_cuda(lambda: k1.ms_deform_gather_3d(lv, shapes, ll, lw))
        B, Nq, H, L, P = w.shape
        hd = value.shape[-1]
        # every input read once, the output written once; the function needs
        # 8 corner FMAs per (sample, channel), with the attention weight
        # folded into the 8 corner weights once per sample
        r.update(bound(nbytes(value, locs, w, got), B * Nq * H * L * P * hd * 8 * 2))
        r["roofline_share"] = r["bound_ms"] / r["kernel_ms"]
        # the corner rows the gather reads (from L2: value fits in it), the
        # traffic that sets the row-wide path's pace
        r["corner_row_bytes"] = B * Nq * H * L * P * 8 * hd * value.element_size()
        fwd[name] = r

        # K1-bwd, through the autograd Function the train step runs, at the
        # uniform and at the local locations
        rel = 1e-4 if dtype == torch.float32 else 1e-2
        rb = {}
        for where, (v_, l_, w_) in (("", (value, locs, w)), ("local_locs ", (lv, ll, lw))):
            gout = torch.randn(got.shape, device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(1)).to(dtype)
            k_leaves = [t.detach().clone().requires_grad_(True) for t in (v_, l_, w_)]
            k1.ms_deform_gather_3d(k_leaves[0], shapes, k_leaves[1], k_leaves[2]).backward(gout)
            torch.cuda.synchronize()
            leaves = [t.detach().float().requires_grad_(True) for t in (v_, l_, w_)]
            out = k1.ms_deform_gather_3d_plain(leaves[0], shapes, leaves[1], leaves[2])
            refs = torch.autograd.grad(out, leaves, gout.float())
            again = k1._launch_bwd(v_, shapes, l_, w_, gout)
            for g, a, b, c in zip(("d_value", "d_locs", "d_weights"), k_leaves, refs, again):
                rb[where + g] = compare(a.grad, b, rel, f"K1-bwd {name} {where}{g}")
                check(torch.equal(a.grad, c), f"K1-bwd {name} {where}{g}: two calls differ")
            check(all(a.grad.dtype == a.dtype for a in k_leaves),
                  f"K1-bwd {name}: gradient dtypes {[a.grad.dtype for a in k_leaves]}")
            del k_leaves, leaves, out, refs, again
        rb["max_abs_err"] = max(v["max_abs_err"] for v in rb.values())
        rb["bit_identical_calls"] = True
        rb["kernel_ms"] = time_cuda(lambda: k1._launch_bwd(value, shapes, locs, w, gout))
        rb["device_ms"] = device_ms(lambda: k1._launch_bwd(value, shapes, locs, w, gout))
        rb["kernel_ms_local_locs"] = time_cuda(lambda: k1._launch_bwd(lv, shapes, ll, lw, gout))
        plain_leaves = [t.detach().clone().requires_grad_(True) for t in (value, locs, w)]
        plain_out = k1.ms_deform_gather_3d_plain(plain_leaves[0], shapes, plain_leaves[1],
                                                 plain_leaves[2])
        rb["plain_ms"] = time_cuda(lambda: torch.autograd.grad(
            plain_out, plain_leaves, gout, retain_graph=True), iters=20)
        # inputs value, locs, weights, gout; outputs d_value (value's dtype),
        # d_locs (f32), d_weights (weights' dtype).  The function needs, per
        # corner and channel, one FMA of the dot sum_c gout * value[corner]
        # (which d_weights and the three d_locs slopes share through per-sample
        # corner weights) and the d_value product and add: 8 x 4 operations
        # per (sample, channel)
        rb.update(bound(nbytes(value, locs, w, gout, value, locs, w),
                        B * Nq * H * L * P * hd * 8 * 4))
        rb["roofline_share"] = rb["bound_ms"] / rb["kernel_ms"]
        bwd[name] = rb
        del plain_out
    fwd["other_rows"] = other_rows_record("K1")
    return fwd, bwd


def other_rows_record(kernel):
    """K1's or K4's other rows (``tools/time_backwards.py:K1_OTHER_ROWS`` /
    ``K4_OTHER_ROWS``: rows that are not whole 16-byte vectors at 16-byte
    aligned pointers) on the vector width the path picks: each held against
    the plain version (float32 1e-5, bf16 1e-2 of max |plain|), two calls
    bit-equal, timed by CUDA events and the profiler's device time beside
    its bound (K4 beside F.grid_sample; a misaligned input also with its
    copy to an aligned buffer inside the timed call)."""
    from occformer_tpu_torch.tools import time_backwards as tb

    recs = (tb.k1_other_rows if kernel == "K1" else tb.k4_other_rows)(device_ms)
    for name, r in recs.items():
        rel = 1e-5 if "f32" in name else 1e-2
        r["limit"] = rel * r["max_abs_plain"]
        check(r["bit_equal_calls"], f"{kernel} {name}: two calls differ")
        check(r["max_abs_err"] <= r["limit"],
              f"{kernel} {name}: max|diff| {r['max_abs_err']} > {r['limit']}")
    return recs


def phase_k2():
    """K2 and K2-bwd against the plain version (F.grid_sample on the permuted
    table) and its autograd, at the loss's shapes: K2's row-wide path at the
    per-layer route's candidate readout (bf16 feature, C = 192), two calls
    held bit-equal, its narrow ("scalar") path beside it there, at the
    per-slot GT masks (C = 1) and at the GT table (C = 17), where the kernel
    and F.grid_sample are also timed by the profiler's device time, the
    library call both on a float copy made beforehand and with the bool ->
    float cast included; K2-bwd's segmented
    path at the candidate and random-fill readouts, with two calls held
    bit-equal, and its narrow path (the per-column gather) timed at the
    candidates beside it.
    Tolerances relative to max |plain|: bfloat16 1e-2 (bf16 output), float32
    1e-5 forward and 1e-4 backward (float32 sums in another order)."""
    import torch
    import torch.nn.functional as F

    from occformer_tpu_torch.ops import trilerp as k2

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    # the candidate readout: the mask feature [1, 128, 128, 16, 192] bf16 at
    # 3 x 50176 candidates, border padding, align_corners=False
    table = torch.randn((1, 128, 128, 16, 192), device=dev, generator=g).to(torch.bfloat16)
    coords = torch.rand((1, 150528, 3), device=dev, generator=g) * 2 - 1
    check(k2.fwd_path(table.shape, table.dtype, table.data_ptr()) == "row",
          "K2 candidates: not the row-wide path")
    got = k2.trilerp_sample(table, coords, False, "border")
    again = k2.trilerp_sample(table, coords, False, "border")
    torch.cuda.synchronize()
    ref = k2.trilerp_sample_plain(table, coords, False, "border")
    fwd = compare(got, ref, 1e-2, "K2 candidates")
    check(torch.equal(got, again), "K2 row path: two calls differ")
    fwd["bit_identical_calls"] = True
    fwd["lanes"] = k2.row_lanes(table.shape[-1], table.dtype)
    fwd["kernel_ms"] = time_cuda(lambda: k2.trilerp_sample(table, coords, False, "border"))
    fwd["device_ms"] = device_ms(lambda: k2.trilerp_sample(table, coords, False, "border"))
    fwd["plain_ms"] = time_cuda(lambda: k2.trilerp_sample_plain(table, coords, False, "border"))
    vol = table.permute(0, 4, 1, 2, 3).contiguous()  # the library call's layout
    grid = coords.flip(-1).reshape(1, -1, 1, 1, 3).to(torch.bfloat16)

    def library():
        return F.grid_sample(vol, grid, mode="bilinear", padding_mode="border",
                             align_corners=False)

    fwd["library_ms"] = time_cuda(library)
    fwd["library_device_ms"] = device_ms(library)
    # the narrow path (the one fwd_path calls "scalar") on the same inputs
    fwd["scalar_path"] = compare(k2._launch_fwd(table, coords, False, "border", path="scalar"),
                                 ref, 1e-2, "K2 scalar path candidates")
    fwd["scalar_path_ms"] = time_cuda(lambda: k2._launch_fwd(
        table, coords, False, "border", path="scalar"))
    del again, ref
    S, C = coords.shape[1], table.shape[-1]
    fwd.update(bound(nbytes(table, coords, got), S * C * 8 * 2))
    fwd["roofline_share"] = fwd["bound_ms"] / fwd["kernel_ms"]
    # the table is twice L2, and the points spread over it: each point reads
    # its 8 corner rows whole
    fwd["realistic_floor_ms"] = (S * 8 * C * table.element_size() + nbytes(coords, got)) \
        / 3.35e12 * 1e3

    # the per-slot GT readout (bool masks [17, 256, 256, 32, 1]) and a
    # zeros / align_corners=True case on a float32 table
    gt = torch.rand((17, 256, 256, 32, 1), device=dev, generator=g) < 0.06
    rc = torch.rand((17, 12544, 3), device=dev, generator=g) * 2 - 1
    check(k2.fwd_path(gt.shape, torch.uint8, gt.data_ptr()) == "scalar",
          "K2 per-slot GT: not the narrow path")
    gt_out = k2.trilerp_sample(gt, rc, False, "border")
    again = k2.trilerp_sample(gt, rc, False, "border")
    rec = compare(gt_out, k2.trilerp_sample_plain(gt, rc, False, "border"), 1e-5,
                  "K2 per-slot GT")
    check(torch.equal(gt_out, again), "K2 narrow path: two calls differ")
    rec["bit_identical_calls"] = True
    rec["points_per_lane"] = k2.NARROW_POINTS_PER_LANE
    rec["kernel_ms"] = time_cuda(lambda: k2.trilerp_sample(gt, rc, False, "border"))
    rec["device_ms"] = device_ms(lambda: k2.trilerp_sample(gt, rc, False, "border"))
    rec["plain_ms"] = time_cuda(lambda: k2.trilerp_sample_plain(gt, rc, False, "border"))
    gt_vol = gt.permute(0, 4, 1, 2, 3).float().contiguous()  # the library call's input
    gt_grid = rc.flip(-1).reshape(17, -1, 1, 1, 3).contiguous()

    def gt_library():
        return F.grid_sample(gt_vol, gt_grid, mode="bilinear", padding_mode="border",
                             align_corners=False)

    def gt_library_with_cast():  # the kernel reads the bool masks as they are
        return F.grid_sample(gt.permute(0, 4, 1, 2, 3).float(), gt_grid, mode="bilinear",
                             padding_mode="border", align_corners=False)

    rec["library_ms"] = time_cuda(gt_library)
    rec["library_device_ms"] = device_ms(gt_library)
    rec["library_with_cast_ms"] = time_cuda(gt_library_with_cast)
    rec["library_with_cast_device_ms"] = device_ms(gt_library_with_cast)
    rec.update(bound(nbytes(gt, rc, gt_out), rc.shape[0] * rc.shape[1] * 8 * 2))
    del again
    # the per-layer route's GT table (bool [1, 256, 256, 32, 17], the 17
    # class slots as channels) at the 150528 candidates, the narrow path too
    gtt = torch.rand((1, 256, 256, 32, 17), device=dev, generator=g) < 0.06
    gtt_out = k2.trilerp_sample(gtt, coords, False, "border")
    rt = compare(gtt_out, k2.trilerp_sample_plain(gtt, coords, False, "border"), 1e-5,
                 "K2 per-layer GT table")
    rt["kernel_ms"] = time_cuda(lambda: k2.trilerp_sample(gtt, coords, False, "border"))
    rt["device_ms"] = device_ms(lambda: k2.trilerp_sample(gtt, coords, False, "border"))
    rt["plain_ms"] = time_cuda(lambda: k2.trilerp_sample_plain(gtt, coords, False, "border"),
                               iters=10)
    gtt_vol = gtt.permute(0, 4, 1, 2, 3).float().contiguous()
    gtt_grid = coords.flip(-1).reshape(1, -1, 1, 1, 3).contiguous()
    rt["library_ms"] = time_cuda(lambda: F.grid_sample(
        gtt_vol, gtt_grid, mode="bilinear", padding_mode="border", align_corners=False))
    rt["library_device_ms"] = device_ms(lambda: F.grid_sample(
        gtt_vol, gtt_grid, mode="bilinear", padding_mode="border", align_corners=False))
    rt["library_with_cast_device_ms"] = device_ms(lambda: F.grid_sample(
        gtt.permute(0, 4, 1, 2, 3).float(), gtt_grid, mode="bilinear", padding_mode="border",
        align_corners=False))
    rt.update(bound(nbytes(gtt, coords, gtt_out), coords.shape[1] * 17 * 8 * 2))
    rec["gt_table"] = rt
    del gtt, gtt_out, gtt_vol
    fwd["per_slot_gt"] = rec
    del gt_vol, gt_out
    t32 = torch.randn((2, 64, 64, 8, 40), device=dev, generator=g)
    c32 = torch.rand((2, 20000, 3), device=dev, generator=g) * 2.4 - 1.2
    fwd["zeros_align"] = compare(k2.trilerp_sample(t32, c32, True, "zeros"),
                                 k2.trilerp_sample_plain(t32, c32, True, "zeros"), 1e-5,
                                 "K2 zeros/align_corners")

    # K2-bwd at the candidate readout, through the autograd Function the
    # train step runs (coordinates without grad, as in the loss: d_table), on
    # the segmented path; two calls must give the same bits
    check(k2.bwd_path(table.shape, S) == "segmented", "K2-bwd candidates: not segmented")
    gout = torch.randn(got.shape, device=dev, generator=g).to(torch.bfloat16)
    k_leaf = table.detach().clone().requires_grad_(True)
    k2.trilerp_sample(k_leaf, coords, False, "border").backward(gout)
    torch.cuda.synchronize()
    leaf = table.detach().float().requires_grad_(True)
    ref = torch.autograd.grad(k2.trilerp_sample_plain(leaf, coords, False, "border"), leaf,
                              gout.float())[0]
    check(k_leaf.grad.dtype == table.dtype, f"K2-bwd d_table dtype {k_leaf.grad.dtype}")
    bwd = compare(k_leaf.grad, ref, 1e-2, "K2-bwd candidates d_table")
    again, _ = k2._launch_bwd(table, coords, gout, False, "border", want_coords=False)
    check(torch.equal(again, k_leaf.grad), "K2-bwd: two calls differ")
    bwd["bit_identical_calls"] = True
    del k_leaf, leaf, ref, again
    t_c = t32.detach().clone().requires_grad_(True)
    c_c = c32.detach().clone().requires_grad_(True)
    go32 = torch.randn((2, 20000, 40), device=dev, generator=g)
    k2.trilerp_sample(t_c, c_c, True, "zeros").backward(go32)
    t_r = t32.detach().clone().requires_grad_(True)
    c_r = c32.detach().clone().requires_grad_(True)
    k2.trilerp_sample_plain(t_r, c_r, True, "zeros").backward(go32)
    bwd["zeros_align_d_table"] = compare(t_c.grad, t_r.grad, 1e-4, "K2-bwd d_table f32")
    bwd["zeros_align_d_coords"] = compare(c_c.grad, c_r.grad, 1e-4, "K2-bwd d_coords f32")
    bwd["kernel_ms"] = time_cuda(lambda: k2._launch_bwd(
        table, coords, gout, False, "border", want_coords=False))
    # the narrow path (the per-column gather) at C = 192, beside the
    # segmented path that bwd_path picks there
    bwd["narrow_path_ms"] = time_cuda(lambda: k2._launch_bwd(
        table, coords, gout, False, "border", want_coords=False, path="narrow"))
    p_leaf = table.detach().clone().requires_grad_(True)
    p_out = k2.trilerp_sample_plain(p_leaf, coords, False, "border")
    bwd["plain_ms"] = time_cuda(lambda: torch.autograd.grad(
        p_out, p_leaf, gout, retain_graph=True), iters=20)
    del p_out
    l_vol = vol.detach().clone().requires_grad_(True)
    l_out = F.grid_sample(l_vol, grid, mode="bilinear", padding_mode="border",
                          align_corners=False)
    l_gout = gout.transpose(1, 2).reshape(l_out.shape).contiguous()
    bwd["library_ms"] = time_cuda(lambda: torch.autograd.grad(
        l_out, l_vol, l_gout, retain_graph=True), iters=20)
    del l_out, l_vol
    # gout and coords read once, d_table (the table's dtype) written once;
    # one product per corner and channel
    bwd.update(bound(nbytes(gout, coords, table), S * C * 8 * 2))
    bwd["roofline_share"] = bwd["bound_ms"] / bwd["kernel_ms"]

    # the per-layer route's random-fill readout: 17 x 12544 points on the
    # same table, the segmented path
    rf = torch.rand((1, 17 * 12544, 3), device=dev, generator=g) * 2 - 1
    rf_gout = torch.randn((1, rf.shape[1], C), device=dev, generator=g).to(torch.bfloat16)
    rf_got, _ = k2._launch_bwd(table, rf, rf_gout, False, "border", want_coords=False)
    leaf = table.detach().float().requires_grad_(True)
    ref = torch.autograd.grad(k2.trilerp_sample_plain(leaf, rf, False, "border"), leaf,
                              rf_gout.float())[0]
    rec = compare(rf_got, ref, 1e-2, "K2-bwd random fill d_table")
    del leaf, ref, rf_got
    rec["kernel_ms"] = time_cuda(lambda: k2._launch_bwd(
        table, rf, rf_gout, False, "border", want_coords=False))
    rec.update(bound(nbytes(rf_gout, rf, table), rf.shape[1] * C * 8 * 2))
    bwd["random_fill"] = rec
    return fwd, bwd


def phase_k2_batched():
    """K2 and K2-bwd at the batched loss route's readouts of the flagship (10
    layers x 1 sample, mask volumes 128x128x16, border, align_corners=False):
    the per-query match volumes [10, 128, 128, 16, 100] bf16 at 50176 points
    each (forward only, detached), and the float32 per-slot volumes at the
    150528 candidates ([10, ..., 17]) and at the 12544 random-fill points of
    each slot ([170, ..., 1]).  All three forwards take K2's narrow
    ("scalar") path, two calls held bit-equal, timed by CUDA events and by
    the profiler's device time beside F.grid_sample on a channels-first
    copy.  Both backwards take K2-bwd's narrow path (the per-column
    gather), two calls held bit-equal, timed by CUDA events and by the
    profiler's device time at the random points and at the same points
    sorted by column (as the loss sends them), beside the plain version's
    autograd and autograd through F.grid_sample.  Tolerances as in
    phase_k2."""
    import torch
    import torch.nn.functional as F

    from occformer_tpu_torch.ops import trilerp as k2
    from occformer_tpu_torch.ops.loss_gather import sort_points_by_row

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    cases = (("matching", (10, 128, 128, 16, 100), torch.bfloat16, (10, 50176), False),
             ("candidates", (10, 128, 128, 16, 17), torch.float32, (10, 150528), True),
             ("random_fill", (170, 128, 128, 16, 1), torch.float32, (170, 12544), True))
    fwd, bwd = {}, {}
    for name, tshape, dtype, cshape, grad in cases:
        table = torch.randn(tshape, device=dev, generator=g).to(dtype)
        coords = torch.rand((*cshape, 3), device=dev, generator=g) * 2 - 1
        got = k2.trilerp_sample(table, coords, False, "border")
        again = k2.trilerp_sample(table, coords, False, "border")
        torch.cuda.synchronize()
        rel = 1e-2 if dtype == torch.bfloat16 else 1e-5
        r = compare(got, k2.trilerp_sample_plain(table, coords, False, "border"), rel,
                    f"K2 batched {name}")
        check(torch.equal(got, again), f"K2 batched {name}: two calls differ")
        del again
        r["path"] = k2.fwd_path(table.shape, table.dtype, table.data_ptr())
        check(r["path"] == "scalar", f"K2 batched {name}: not the narrow path")
        r["vec"] = k2.narrow_vec(tshape[-1], dtype, table.data_ptr())
        r["lanes"] = k2.narrow_lanes(tshape[-1], r["vec"])
        r["kernel_ms"] = time_cuda(lambda: k2.trilerp_sample(table, coords, False, "border"))
        r["device_ms"] = device_ms(lambda: k2.trilerp_sample(table, coords, False, "border"))
        r["plain_ms"] = time_cuda(
            lambda: k2.trilerp_sample_plain(table, coords, False, "border"), iters=10)
        f_vol = table.permute(0, 4, 1, 2, 3).contiguous()
        f_grid = coords.flip(-1).reshape(cshape[0], -1, 1, 1, 3).to(dtype).contiguous()

        def library():
            return F.grid_sample(f_vol, f_grid, mode="bilinear", padding_mode="border",
                                 align_corners=False)

        r["library_ms"] = time_cuda(library, iters=10)
        r["library_device_ms"] = device_ms(library, iters=10)
        del f_vol, f_grid
        S, C = cshape[0] * cshape[1], tshape[-1]
        r.update(bound(nbytes(table, coords, got), S * C * 8 * 2))
        fwd[name] = r
        if not grad:
            continue
        gout = torch.randn(got.shape, device=dev, generator=g)
        leaf = table.detach().clone().requires_grad_(True)
        k2.trilerp_sample(leaf, coords, False, "border").backward(gout)
        torch.cuda.synchronize()
        ref_leaf = table.detach().clone().requires_grad_(True)
        k2.trilerp_sample_plain(ref_leaf, coords, False, "border").backward(gout)
        rb = compare(leaf.grad, ref_leaf.grad, 1e-4, f"K2-bwd batched {name} d_table")
        again, _ = k2._launch_bwd(table, coords, gout, False, "border", want_coords=False)
        check(torch.equal(again, leaf.grad), f"K2-bwd batched {name}: two calls differ")
        rb["bit_identical_calls"] = True
        del leaf, ref_leaf, again
        check(k2.bwd_path(table.shape, cshape[1]) == "narrow", f"K2-bwd {name}: not narrow")
        rb["lanes"] = k2.column_lanes(tshape[-1])
        # timed at the points sorted by column, as the loss sends them; the
        # kernel also at the random order beside
        by_col = (sort_points_by_row((coords + 1) / 2, tshape[1:4]) * 2 - 1).contiguous()
        rb["random_order_ms"] = time_cuda(lambda: k2._launch_bwd(
            table, coords, gout, False, "border", want_coords=False))
        rb["random_order_device_ms"] = device_ms(lambda: k2._launch_bwd(
            table, coords, gout, False, "border", want_coords=False))
        rb["kernel_ms"] = time_cuda(lambda: k2._launch_bwd(
            table, by_col, gout, False, "border", want_coords=False))
        rb["device_ms"] = device_ms(lambda: k2._launch_bwd(
            table, by_col, gout, False, "border", want_coords=False))
        p_leaf = table.detach().clone().requires_grad_(True)
        p_out = k2.trilerp_sample_plain(p_leaf, by_col, False, "border")
        rb["plain_ms"] = time_cuda(lambda: torch.autograd.grad(
            p_out, p_leaf, gout, retain_graph=True), iters=10)
        del p_out, p_leaf
        # the library call: autograd through F.grid_sample on the
        # channels-first copy of the volumes
        l_vol = table.permute(0, 4, 1, 2, 3).contiguous().requires_grad_(True)
        l_grid = by_col.flip(-1).reshape(cshape[0], -1, 1, 1, 3).contiguous()
        l_out = F.grid_sample(l_vol, l_grid, mode="bilinear", padding_mode="border",
                              align_corners=False)
        l_gout = gout.transpose(1, 2).reshape(l_out.shape).contiguous()
        rb["library_ms"] = time_cuda(lambda: torch.autograd.grad(
            l_out, l_vol, l_gout, retain_graph=True), iters=10)
        del l_out, l_vol, l_gout, by_col
        rb.update(bound(nbytes(gout, coords, table), S * C * 8 * 2))
        bwd[name] = rb
        del gout
    return fwd, bwd


def phase_k3():
    """K3 (sample_id_masks) against its plain version at the batched loss
    route's three GT reads of the flagship (N = 10 layers x 1 sample, int32
    label grid [1, 256, 256, 32] with 10% of voxels 255, G = 17 class slots,
    border, align_corners=False): the 150528 candidates and the 50176
    matching points (shared points, [10, 17, S] out) and the 12544
    random-fill points of each slot ([10, 17, 12544, 3] per-slot points);
    and zeros / align_corners=True on a 40x24x12 grid (B = 2, N = 4) with
    points in [-0.15, 1.15].  Tolerance 1e-6 absolute: the kernel adds the
    plain version's float32 terms in its order.  The library call that
    computes the same function is ``F.grid_sample`` over a float one-hot
    volume [1, 17, 256, 256, 32] (built beforehand, its build timed apart),
    with every layer's points in one grid (per slot for the random fill)."""
    import torch
    import torch.nn.functional as F

    from occformer_tpu_torch.ops import loss_gather as k3

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    G, N = 17, 10
    grid = torch.randint(0, G, (1, 256, 256, 32), device=dev, generator=g, dtype=torch.int32)
    grid[torch.rand(grid.shape, device=dev, generator=g) < 0.1] = 255
    ids = torch.arange(G, device=dev, dtype=torch.int32)[None]
    onehot_ms = time_cuda(lambda: (grid[:, None] == ids[0].view(1, G, 1, 1, 1)).float(),
                          iters=10)
    onehot = (grid[:, None] == ids[0].view(1, G, 1, 1, 1)).float()  # [1, G, X, Y, Z]
    recs = {}
    for name, shape in (("candidates", (N, 150528, 3)), ("matching", (N, 50176, 3)),
                        ("random_fill", (N, G, 12544, 3))):
        pts = torch.rand(shape, device=dev, generator=g)
        got = k3.sample_id_masks(grid, ids, pts, False, "border")
        torch.cuda.synchronize()
        ref = k3.sample_id_masks_plain(grid, ids, pts, False, "border")
        r = compare(got, ref, 1e-6, f"K3 {name}")
        del ref
        r["kernel_ms"] = time_cuda(lambda: k3.sample_id_masks(grid, ids, pts, False, "border"))
        r["device_ms"] = device_ms(lambda: k3.sample_id_masks(grid, ids, pts, False, "border"))
        r["plain_ms"] = time_cuda(
            lambda: k3.sample_id_masks_plain(grid, ids, pts, False, "border"), iters=10)
        if pts.dim() == 3:  # every layer's points in one grid
            lib_in = onehot
            lib_grid = (pts.reshape(1, -1, 1, 1, 3) * 2 - 1).flip(-1)
        else:               # slot g's volume at slot g's points of every layer
            lib_in = onehot.transpose(0, 1)
            lib_grid = (pts.transpose(0, 1).reshape(G, -1, 1, 1, 3) * 2 - 1).flip(-1)
        lib_grid = lib_grid.contiguous()

        def library():
            return F.grid_sample(lib_in, lib_grid, mode="bilinear", padding_mode="border",
                                 align_corners=False)

        r["library_ms"] = time_cuda(library)
        r["library_onehot_build_ms"] = onehot_ms
        lib = library().reshape(G, N, -1).transpose(0, 1)  # [N, G, S]
        r["library_max_abs_diff"] = (lib - got.reshape(N, G, -1)).abs().max().item()
        del lib
        # points and the grid read once, the output written once; per point
        # and slot 8 compares and 8 adds
        r.update(bound(nbytes(pts, grid, ids, got), got.numel() * 16))
        r["roofline_share"] = r["bound_ms"] / r["kernel_ms"]
        recs[name] = r
    # zeros padding, align_corners=True, sides not powers of two, labels 255
    g2 = torch.Generator(device=dev).manual_seed(5)
    small = torch.randint(0, G + 2, (2, 40, 24, 12), device=dev, generator=g2,
                          dtype=torch.int32)
    small[:, :3] = 255
    sids = torch.stack([torch.arange(G), torch.arange(G).flip(0)]).to(dev, torch.int32)
    for mode, shape in (("shared", (4, 20000, 3)), ("per_slot", (4, G, 1000, 3))):
        pts = torch.rand(shape, device=dev, generator=g2) * 1.3 - 0.15
        recs[f"zeros_align_{mode}"] = compare(
            k3.sample_id_masks(small, sids, pts, True, "zeros"),
            k3.sample_id_masks_plain(small, sids, pts, True, "zeros"), 1e-6,
            f"K3 zeros/align_corners {mode}")
    return recs


def phase_probe():
    """The viability probe (P1, P2) as its CLI runs it: build csrc/probe.cu
    alone, hold both kernels exactly against their plain versions, then
    time them and torch.gather."""
    import torch

    from occformer_tpu_torch.tools.probe_viability import probe_check, probe_time

    dev = torch.device("cuda")
    reset_launches()  # the probe's path starts here
    rec = {"phase": "probe", **probe_check(dev)}
    rec["launches"] = launches()  # ... and ends here
    emit(rec)
    check(rec["add_one"] == "ok" and rec["row_gather"] == "ok",
          f"probe: add_one {rec['add_one']}, row_gather {rec['row_gather']}")
    check(rec["launches"] == PROBE_LAUNCHES, f"probe launches {rec['launches']}")
    rec["timing"] = probe_time(dev)
    emit({"phase": "probe_timing", **rec["timing"]})
    return rec


def k4_inputs(case, dtype=None):
    """K4's inputs (``tools/time_backwards.py:k4_inputs``): bench.py's
    parity-gate shapes ("gate", float32) or the deformable attention's
    ("flagship", bf16 unless ``dtype``)."""
    from occformer_tpu_torch.tools.time_backwards import k4_inputs as inputs

    return inputs(case, dtype)


def k4_check(tables, coords, C, align_corners, name, spatials=K4_PYRAMID):
    """K4 and K4-bwd through the autograd Function against the plain
    version's autograd: values, d_tables and d_coords of a random linear
    probe.  Tolerances relative to max |plain|: float32 1e-5 values and 1e-4
    gradients (the same float32 sums in another order: each d_table row in
    ascending sample order), bf16 1e-2 (outputs and d_tables rounded to
    bf16; the plain version runs in float32 on the same bf16-rounded
    inputs)."""
    import torch

    from occformer_tpu_torch.ops import trilerp_fused as k4

    dtype = tables[0].dtype
    tl = [t.detach().clone().requires_grad_(True) for t in tables]
    cl = [c.detach().clone().requires_grad_(True) for c in coords]
    got = k4.fused_multilevel_gather(tl, spatials, C, cl, align_corners)
    g = torch.Generator(device="cuda").manual_seed(7)
    gouts = [torch.randn(o.shape, device="cuda", generator=g).to(dtype) for o in got]
    torch.autograd.backward(got, gouts)
    torch.cuda.synchronize()
    pl = [t.detach().float().requires_grad_(True) for t in tables]
    pc = [c.detach().clone().requires_grad_(True) for c in coords]
    ref = k4.fused_multilevel_gather_plain(pl, spatials, C, pc, align_corners)
    torch.autograd.backward(ref, [x.float() for x in gouts])
    f32 = dtype == torch.float32
    rec = {"values": [compare(a, b, 1e-5 if f32 else 1e-2, f"K4 {name} level {l}")
                      for l, (a, b) in enumerate(zip(got, ref))],
           "d_tables": [compare(a.grad, b.grad, 1e-4 if f32 else 1e-2,
                                f"K4-bwd {name} level {l} d_table")
                        for l, (a, b) in enumerate(zip(tl, pl))],
           "d_coords": [compare(a.grad, b.grad, 1e-4 if f32 else 1e-2,
                                f"K4-bwd {name} level {l} d_coords")
                        for l, (a, b) in enumerate(zip(cl, pc))]}
    check(all(o.dtype == dtype for o in got) and all(a.grad.dtype == dtype for a in tl)
          and all(a.grad.dtype == torch.float32 for a in cl),
          f"K4 {name}: dtypes {[o.dtype for o in got]}, {[a.grad.dtype for a in tl]}")
    return rec


def phase_k4():
    """The K4 parity gate (bench.py:_kernel_parity's counterpart): K4 and
    K4-bwd at (a) bench.py's shapes in float32 at both align_corners and (b)
    the deformable attention's flagship shapes in bf16, each held against
    the plain version (k4_check); then the times at (b) of K4, K4-bwd, the
    plain version and its autograd, and of the library reference, which
    takes three calls: one F.grid_sample per level on a channels-first copy
    of the level (bf16 grid), and their backward; then K4's other rows
    (``other_rows_record``: C 6 in float32, 12 in bf16, 24 in bf16 at
    misaligned tables)."""
    import torch
    import torch.nn.functional as F

    from occformer_tpu_torch.ops import trilerp_fused as k4
    from occformer_tpu_torch.tools.time_backwards import k4_library_bwd_ms

    gate = k4_inputs("gate")
    flag = k4_inputs("flagship")
    reset_launches()  # the parity gate's path starts here
    rec = {"gate_f32": {f"align_corners={a}": k4_check(*gate, a, f"gate align_corners={a}")
                        for a in (False, True)},
           "flagship_bf16": k4_check(*flag, False, "flagship bf16")}
    rec["launches"] = launches()  # ... and ends here
    check(rec["launches"] == K4_GATE_LAUNCHES, f"K4 gate launches {rec['launches']}")

    tables, coords, C = flag
    G = tables[0].shape[0]
    S_tot = sum(c.shape[1] for c in coords)
    check(k4.multi_fwd_path(C, tables[0].dtype, [t.data_ptr() for t in tables]) == 16,
          "K4 flagship: not 16-byte vectors")
    outs = k4.fused_multilevel_gather(tables, K4_PYRAMID, C, coords)
    again = k4.fused_multilevel_gather(tables, K4_PYRAMID, C, coords)
    check(all(torch.equal(a, b) for a, b in zip(outs, again)), "K4 row path: two calls differ")
    del again
    fwd = {"max_abs_err": max(r["max_abs_err"] for r in rec["flagship_bf16"]["values"]),
           "bit_identical_calls": True}
    fwd["kernel_ms"] = time_cuda(lambda: k4._launch_multi_fwd(tables, K4_PYRAMID, C, coords,
                                                              False))
    fwd["device_ms"] = device_ms(lambda: k4._launch_multi_fwd(tables, K4_PYRAMID, C, coords,
                                                              False))
    # float32 tables at the same shapes: the kernel, the plain version and
    # the library's three calls
    t32, c32, _ = k4_inputs("flagship", torch.float32)
    ref = k4.fused_multilevel_gather_plain(t32, K4_PYRAMID, C, c32)
    fwd["f32"] = {"values": [compare(a, b, 1e-5, f"K4 f32 level {l}") for l, (a, b) in
                             enumerate(zip(k4.fused_multilevel_gather(t32, K4_PYRAMID, C, c32),
                                           ref))]}
    del ref
    v32 = [t.reshape(G, X, Y, Z, C).permute(0, 4, 1, 2, 3).contiguous()
           for t, (X, Y, Z) in zip(t32, K4_PYRAMID)]
    g32 = [c.flip(-1).reshape(G, -1, 1, 1, 3).contiguous() for c in c32]
    fwd["f32"].update(
        kernel_ms=time_cuda(lambda: k4._launch_multi_fwd(t32, K4_PYRAMID, C, c32, False)),
        plain_ms=time_cuda(lambda: k4.fused_multilevel_gather_plain(t32, K4_PYRAMID, C, c32),
                           iters=10),
        library_ms=time_cuda(lambda: [F.grid_sample(v, gr, mode="bilinear",
                                                    padding_mode="zeros", align_corners=False)
                                      for v, gr in zip(v32, g32)]))
    fwd["f32"].update(bound(nbytes(*t32, *c32) + G * S_tot * C * 4, G * S_tot * C * 8 * 2))
    del t32, c32, v32, g32
    fwd["kernel_ms_gate_f32"] = time_cuda(lambda: k4._launch_multi_fwd(
        gate[0], K4_PYRAMID, C, gate[1], False))
    # at the gate's small shapes the events also time the launch's host
    # work: the profiler's device time of the kernel alone, and of the
    # library's three grid_sample calls there
    fwd["kernel_device_ms_gate_f32"] = device_ms(lambda: k4._launch_multi_fwd(
        gate[0], K4_PYRAMID, C, gate[1], False))
    g_vols = [t.reshape(t.shape[0], X, Y, Z, C).permute(0, 4, 1, 2, 3).contiguous()
              for t, (X, Y, Z) in zip(gate[0], K4_PYRAMID)]
    g_grids = [c.flip(-1).reshape(c.shape[0], -1, 1, 1, 3).contiguous() for c in gate[1]]

    def gate_library():
        return [F.grid_sample(v, gr, mode="bilinear", padding_mode="zeros", align_corners=False)
                for v, gr in zip(g_vols, g_grids)]

    fwd["library_ms_gate_f32"] = time_cuda(gate_library)
    fwd["library_device_ms_gate_f32"] = device_ms(gate_library)
    fwd["plain_ms"] = time_cuda(lambda: k4.fused_multilevel_gather_plain(
        tables, K4_PYRAMID, C, coords), iters=10)
    vols = [t.reshape(G, X, Y, Z, C).permute(0, 4, 1, 2, 3).contiguous()
            for t, (X, Y, Z) in zip(tables, K4_PYRAMID)]
    grids = [c.flip(-1).reshape(G, -1, 1, 1, 3).to(torch.bfloat16).contiguous() for c in coords]

    def library():
        return [F.grid_sample(v, gr, mode="bilinear", padding_mode="zeros", align_corners=False)
                for v, gr in zip(vols, grids)]

    fwd["library_ms"] = time_cuda(library)
    fwd["library_calls"] = len(K4_PYRAMID)
    # every input read once, every output written once; 8 corner FMAs per
    # (sample, channel)
    fwd.update(bound(nbytes(*tables, *coords, *outs), G * S_tot * C * 8 * 2))
    fwd["roofline_share"] = fwd["bound_ms"] / fwd["kernel_ms"]

    g = torch.Generator(device="cuda").manual_seed(8)
    gouts = [torch.randn(o.shape, device="cuda", generator=g).to(o.dtype) for o in outs]
    d_tables, d_coords = k4._launch_multi_bwd(tables, K4_PYRAMID, C, coords, gouts, False, True)
    a_tables, a_coords = k4._launch_multi_bwd(tables, K4_PYRAMID, C, coords, gouts, False, True)
    check(all(torch.equal(a, b) for a, b in zip(d_tables + d_coords, a_tables + a_coords)),
          "K4-bwd: two calls differ")
    del a_tables, a_coords
    bwd = {"max_abs_err": max(r["max_abs_err"] for k in ("d_tables", "d_coords")
                              for r in rec["flagship_bf16"][k]),
           "bit_identical_calls": True}
    bwd["kernel_ms"] = time_cuda(lambda: k4._launch_multi_bwd(
        tables, K4_PYRAMID, C, coords, gouts, False, True))
    bwd["device_ms"] = device_ms(lambda: k4._launch_multi_bwd(
        tables, K4_PYRAMID, C, coords, gouts, False, True))
    bwd["kernel_ms_without_d_coords"] = time_cuda(lambda: k4._launch_multi_bwd(
        tables, K4_PYRAMID, C, coords, gouts, False, False))
    pl = [t.detach().clone().requires_grad_(True) for t in tables]
    pc = [c.detach().clone().requires_grad_(True) for c in coords]
    p_out = k4.fused_multilevel_gather_plain(pl, K4_PYRAMID, C, pc)
    bwd["plain_ms"] = time_cuda(lambda: torch.autograd.grad(
        p_out, pl + pc, gouts, retain_graph=True), iters=10)
    del p_out
    bwd["library_ms"] = k4_library_bwd_ms(tables, coords, gouts, C)
    bwd["library_calls"] = len(K4_PYRAMID)
    # tables, coords and gout read once; d_tables (the tables' dtype) and
    # d_coords (float32) written once.  Per corner and channel the d_table
    # product and add and one FMA of the dot that d_coords needs: 8 x 4
    # operations per (sample, channel)
    bwd.update(bound(nbytes(*tables, *coords, *gouts, *tables, *d_coords),
                     G * S_tot * C * 8 * 4))
    bwd["roofline_share"] = bwd["bound_ms"] / bwd["kernel_ms"]
    fwd["other_rows"] = other_rows_record("K4")
    rec["K4"], rec["K4-bwd"] = fwd, bwd
    return rec


def phase_k4_dcn(shape=None):
    """K4 and K4-bwd as the DepthNet's deformable convolution runs them
    (``tools/time_backwards.py:dcn_inputs``: one level of Z = 1, [6, 704,
    512] at the flagship, 6336 taps a camera, align_corners=True; ``shape``
    [B, C, H, W] another map, SemanticKITTI's), through ``k4_record``."""
    from occformer_tpu_torch.tools.time_backwards import dcn_inputs

    at = {} if shape is None else {"shape": shape}
    return k4_record(lambda dtype=None: dcn_inputs(dtype, **at), "DCN", True)


def k4_record(inputs, name, align_corners, coords_grad=True):
    """K4 and K4-bwd at ``inputs(dtype)``'s (tables, coords, C, spatials), bf16
    by default: held against the plain version in bf16 (1e-2) and float32
    (1e-5 values, 1e-4 gradients), two K4-bwd calls bit-equal; then K4,
    K4-bwd (its workspace and d_coords included, and without d_coords), the
    plain version and its autograd timed, beside the library's call on the
    parent's route: ``F.grid_sample`` 2-D (bilinear, zeros) on the float32
    channels-first map, forward and its backward in the map and, with
    ``coords_grad``, the grid.  Without ``coords_grad`` (a grid that carries
    no gradient, as the warps') the backward's record is K4-bwd without
    d_coords, its bound and library call without the grid's gradient."""
    import torch
    import torch.nn.functional as F

    from occformer_tpu_torch.ops import trilerp_fused as k4

    tables, coords, C, spatials = inputs()
    rec = {"shapes": {"table": list(tables[0].shape), "coords": list(coords[0].shape),
                      "spatials": spatials},
           "bf16": k4_check(tables, coords, C, align_corners, f"{name} bf16", spatials)}
    t32, c32, _, _ = inputs(torch.float32)
    rec["f32"] = k4_check(t32, c32, C, align_corners, f"{name} f32", spatials)
    del t32, c32
    check(k4.multi_fwd_path(C, tables[0].dtype, [t.data_ptr() for t in tables]) == 16,
          f"K4 {name}: not 16-byte vectors")
    outs = k4._launch_multi_fwd(tables, spatials, C, coords, align_corners)
    g = torch.Generator(device="cuda").manual_seed(9)
    gouts = [torch.randn(o.shape, device="cuda", generator=g).to(o.dtype) for o in outs]
    a = k4._launch_multi_bwd(tables, spatials, C, coords, gouts, align_corners, True)
    b = k4._launch_multi_bwd(tables, spatials, C, coords, gouts, align_corners, True)
    c = k4._launch_multi_bwd(tables, spatials, C, coords, gouts, align_corners, False)
    check(all(torch.equal(x, y) for x, y in zip(a[0] + a[1], b[0] + b[1])),
          f"K4-bwd {name}: two calls differ")
    check(all(torch.equal(x, y) for x, y in zip(a[0], c[0])),
          f"K4-bwd {name}: d_tables without d_coords differ")
    del a, b, c
    G, S = coords[0].shape[:2]
    fwd = {"max_abs_err": max(r["max_abs_err"] for r in rec["bf16"]["values"]),
           "kernel_ms": time_cuda(lambda: k4._launch_multi_fwd(tables, spatials, C, coords,
                                                                align_corners)),
           "device_ms": device_ms(lambda: k4._launch_multi_fwd(tables, spatials, C, coords,
                                                                align_corners)),
           "plain_ms": time_cuda(lambda: k4.fused_multilevel_gather_plain(
               tables, spatials, C, coords, align_corners), iters=10)}
    bwd_keys = ("d_tables", "d_coords") if coords_grad else ("d_tables",)
    bwd = {"max_abs_err": max(r["max_abs_err"] for k in bwd_keys for r in rec["bf16"][k]),
           "bit_identical_calls": True, "with_d_coords": coords_grad,
           "kernel_ms": time_cuda(lambda: k4._launch_multi_bwd(
               tables, spatials, C, coords, gouts, align_corners, coords_grad)),
           "device_ms": device_ms(lambda: k4._launch_multi_bwd(
               tables, spatials, C, coords, gouts, align_corners, coords_grad)),
           "workspace_bytes": 4 * int(k4._multi_fn("multilevel_gather3d_bwd_workspace")(
               1, k4._multi_dims(spatials, coords), G))}
    other = "kernel_ms_without_d_coords" if coords_grad else "kernel_ms_with_d_coords"
    bwd[other] = time_cuda(lambda: k4._launch_multi_bwd(
        tables, spatials, C, coords, gouts, align_corners, not coords_grad))
    pl = [t.detach().clone().requires_grad_(True) for t in tables]
    pc = [c.detach().clone().requires_grad_(coords_grad) for c in coords]
    p_out = k4.fused_multilevel_gather_plain(pl, spatials, C, pc, align_corners)
    want = pl + (pc if coords_grad else [])
    bwd["plain_ms"] = time_cuda(lambda: torch.autograd.grad(p_out, want, gouts,
                                                            retain_graph=True), iters=10)
    del p_out, pl, pc, want
    # the parent's route: the float32 channels-first map, the grid (x, y)
    (H, W, _), = spatials
    vol = tables[0].float().reshape(G, H, W, C).permute(0, 3, 1, 2).contiguous()
    grid = coords[0][..., :2].flip(-1).reshape(G, S, 1, 2).contiguous()
    lib = lambda v, gr: F.grid_sample(v, gr, mode="bilinear", padding_mode="zeros",
                                      align_corners=align_corners)
    fwd["library_ms"] = time_cuda(lambda: lib(vol, grid))
    fwd["library_device_ms"] = device_ms(lambda: lib(vol, grid))
    vl, gl = vol.requires_grad_(True), grid.requires_grad_(coords_grad)
    lib_out = lib(vl, gl)
    lib_gout = gouts[0].float().reshape(lib_out.shape)
    lib_in = (vl, gl) if coords_grad else (vl,)
    bwd["library_ms"] = time_cuda(lambda: torch.autograd.grad(lib_out, lib_in, lib_gout,
                                                              retain_graph=True), iters=10)
    bwd["library_device_ms"] = device_ms(lambda: torch.autograd.grad(
        lib_out, lib_in, lib_gout, retain_graph=True), iters=10)
    bwd["library_calls"] = fwd["library_calls"] = 1
    del vol, grid, vl, gl, lib_out, lib_gout, lib_in
    # every input read once, every output written once; 8 corner FMAs per
    # (sample, channel) forward, 8 x 4 operations backward with d_coords and
    # 8 x 2 without (k4_check's count)
    fwd.update(bound(nbytes(*tables, *coords, *outs), G * S * C * 8 * 2))
    read = (*tables, *coords, *gouts, *tables) + ((*coords,) if coords_grad else ())
    bwd.update(bound(nbytes(*read), G * S * C * 8 * (4 if coords_grad else 2)))
    for r in (fwd, bwd):
        r["roofline_share"] = r["bound_ms"] / r["kernel_ms"]
    rec["K4"], rec["K4-bwd"] = fwd, bwd
    return rec


def phase_kernels():
    k1_fwd, k1_bwd = phase_k1()
    k2_fwd, k2_bwd = phase_k2()
    k2_fwd["batched"], k2_bwd["batched"] = phase_k2_batched()
    rec = {"phase": "kernels", "K1": k1_fwd, "K1-bwd": k1_bwd, "K2": k2_fwd,
           "K2-bwd": k2_bwd, "K3": phase_k3()}
    free_memory()
    rec["K4_gate"] = phase_k4()
    rec["K4_attention"], rec["K4-bwd_attention"] = (rec["K4_gate"].pop("K4"),
                                                    rec["K4_gate"].pop("K4-bwd"))
    free_memory()
    rec["K4_dcn"] = phase_k4_dcn()
    rec["K4"], rec["K4-bwd"] = rec["K4_dcn"].pop("K4"), rec["K4_dcn"].pop("K4-bwd")
    emit(rec)
    return rec


def phase_tiny():
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import tiny_cfg

    from occformer_tpu_torch.models.detector import build_model

    cfg = tiny_cfg.model_cfg()
    cpu = build_model(cfg, device="cpu")
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    batch = tiny_cfg.make_batch(np.random.RandomState(0))
    before = launches()
    with torch.inference_mode():
        ref = cpu({k: torch.from_numpy(v) for k, v in batch.items()})
        got = gpu({k: torch.from_numpy(v).cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    n = {k: v - before[k] for k, v in launches().items()}
    # 2 deformable encoder layers; hd = 12 float32 rows take K1's row-wide
    # path; the DCN's 64 float32 channels K4's
    rec = {"phase": "tiny", "k1_launches": n["K1"], "k1_row_launches": n["K1.row"],
           "k4_launches": n["K4"], "k4_row_launches": n["K4.row"]}
    check(n["K1"] == n["K1.row"] == 2, f"tiny: K1 launched {n['K1']} times "
          f"({n['K1.row']} on the row-wide path), want 2 (2)")
    check(n["K4"] == n["K4.row"] == 1, f"tiny: K4 launched {n['K4']} times "
          f"({n['K4.row']} on the row-wide path), want 1 (1)")
    for k, r in ref.items():
        g = got[k].float().cpu()
        err = (g - r).abs().max().item()
        tol = 1e-3 * r.abs().max().item() + 1e-4
        rec[k] = {"max_abs_err": err, "tol": tol}
        check(err <= tol, f"tiny {k}: max|diff| {err} > {tol}")
    emit(rec)


def tiny_train_batch(rng, B=1):
    """The tiny train batch of tests/test_torch_train.py, with B samples."""
    import numpy as np

    import tiny_cfg

    batch = tiny_cfg.make_batch(rng, B=B)
    N, (H, W) = tiny_cfg.NUM_CAMS, tiny_cfg.INPUT_SIZE
    X, Y, Z = tiny_cfg.OCC_SIZE
    gt_occ = rng.randint(0, tiny_cfg.NUM_CLASSES, size=(B, X, Y, Z)).astype(np.int32)
    gt_occ[:, :2] = 255
    depth = rng.uniform(0, 10, size=(B, N, H, W)).astype(np.float32)
    depth[depth < 3] = 0.0
    P = 128
    batch.update(gt_occ=gt_occ, gt_depth=depth,
                 lidar_xyz=rng.uniform(0, 1, size=(B, P, 3)).astype(np.float32),
                 lidar_valid=np.arange(P)[None].repeat(B, 0) < 100,
                 lidar_label=rng.randint(0, tiny_cfg.NUM_CLASSES, (B, P)).astype(np.int32))
    return batch


def phase_tiny_train(mxu_readout="off", accum_steps=1):
    """One tiny train step in train mode (BatchNorm batch statistics,
    drop-path) on the card with the kernels and on the CPU with the plain
    versions, float32, from the same state with the same draws (drop-path
    from identically seeded CPU generators, the loss draws made once), on
    the loss route ``mxu_readout`` with ``accum_steps`` micro-batches of one
    sample each.

    Tolerances.  The tiny step is ill-conditioned in places: train-mode
    BatchNorm over 4 values per channel (ResNet layer4 is 1x2 on 2 cameras)
    amplifies a change of the images a hundredfold, and the gradients that
    reach the DepthNet through the mask loss cancel to a small share of
    their terms (a conv bias in front of a train-mode BatchNorm has a true
    gradient of 0).  So on the CPU alone, images scaled by 1 +- 1e-6 move
    grad_norm by up to about 2e-3 and dozens of gradients by more than 1% of
    their max, and whether a scaling does so is a matter of rounding
    (``cpu_moves_by_image_scale`` in the record).  No float32
    implementation can agree closer than that.  So the phase measures that
    spread anew, over the CPU step on images scaled by 1 +- 1, 2, 3, 5 e-6,
    and holds each number to its plain tolerance plus twice its largest
    move there: losses, total_loss and grad_norm 1e-3 relative; every
    gradient 1e-2 * max|ref| + 1e-6; every parameter after the update
    1e-3 * max|ref| + 1e-6 where the CPU gradient lies outside its tolerance
    of 0, and 2 * lr + 1e-6 where it does not (Adam's first step is
    lr * sign(g), whose sign such a gradient does not fix)."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import tiny_cfg

    from occformer_tpu_torch.engine.optim import build_optimizer
    from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step
    from occformer_tpu_torch.losses.mask2former_loss import make_loss_draws
    from occformer_tpu_torch.models.detector import build_model

    cfg = tiny_cfg.model_cfg()
    loss_cfg = build_loss_cfg(dict(cfg["pts_bbox_head"], mxu_readout=mxu_readout), dict(
        num_points=64, oversample_ratio=2.0, importance_sample_ratio=0.75))
    batch = tiny_train_batch(np.random.RandomState(0), B=accum_steps)
    L = cfg["pts_bbox_head"]["transformer_decoder"]["num_layers"] + 1
    gen = torch.Generator().manual_seed(4)
    draws = [make_loss_draws(gen, loss_cfg, torch.from_numpy(batch["lidar_valid"][m:m + 1]), L)
             for m in range(accum_steps)]
    lr = 1e-4

    def run(dev, scale=1.0):
        model = build_model(cfg, device="cpu", seed=0).to(dev).train()
        opt = build_optimizer(model, lr=lr, grad_clip=5.0)
        step = build_train_step(model, opt, loss_cfg, device=dev, accum_steps=accum_steps)
        before = launches()
        b = dict(batch, imgs=(batch["imgs"] * scale).astype(np.float32))
        metrics = step(b, torch.Generator().manual_seed(3), draws=draws)
        n = {k: v - before[k] for k, v in launches().items()}
        return ({k: float(v) for k, v in metrics.items()},
                {"grad": {k: p.grad.detach().float().cpu()
                          for k, p in model.named_parameters()},
                 "param": {k: v.detach().float().cpu()
                           for k, v in model.state_dict().items() if v.is_floating_point()}},
                n)

    m_got, t_got, n_got = run("cuda")
    m_ref, t_ref, _ = run("cpu")
    spread_m = {k: 0.0 for k in m_ref}
    spread_t = {w: {k: 0.0 for k in t_ref[w]} for w in t_ref}
    moves = {}  # per scaling: grad_norm's relative move, gradients moved > 1% of max
    for e in (1, -1, 2, -2, 3, -3, 5, -5):
        m_sc, t_sc, _ = run("cpu", 1 + e * 1e-6)
        for k in m_ref:
            spread_m[k] = max(spread_m[k], abs(m_sc[k] - m_ref[k]))
        moved = 0
        for w in t_ref:
            for k, r in t_ref[w].items():
                d = (t_sc[w][k] - r).abs().max().item()
                spread_t[w][k] = max(spread_t[w][k], d)
                moved += w == "grad" and d > 1e-2 * r.abs().max().item() + 1e-6
        moves[f"{1 + e * 1e-6:.6f}"] = {
            "grad_norm": abs(m_sc["grad_norm"] / m_ref["grad_norm"] - 1),
            "grads_moved_over_1e-2_of_max": moved}
    rec = {"phase": "tiny_train", "mxu_readout": mxu_readout, "accum_steps": accum_steps,
           "launches": n_got, "metrics_cuda": m_got, "metrics_cpu": m_ref,
           "metrics_cpu_spread": spread_m, "cpu_moves_by_image_scale": moves}
    failed = []
    # 2 deformable encoder layers (hd = 12 float32: K1's row-wide path), 4
    # supervised decoder outputs; the tiny feature's C = 48 (float32) takes
    # K2's row-wide path and K2-bwd's segmented one, the GT masks (C = 5 and
    # 1) K2's narrow path; on the batched route the match volumes' C = 8
    # queries take K2's row-wide path, the per-slot volumes (C = 5 and 1)
    # K2's narrow path and K2-bwd's narrow one; the DCN's sampler K4 (its
    # row-wide path) and K4-bwd once each
    per_micro = (dict(_NONE, **_DCN, **{"K1": 2, "K1.row": 2, "K1-bwd": 2, "K2": 3,
                                        "K2.row": 1, "K2-bwd": 2, "K2-bwd.narrow": 2, "K3": 3,
                                        "S1": 1, "S1-bwd": 1})
                 if loss_cfg.batched_readout else
                 dict(_NONE, **_DCN, **{"K1": 2, "K1.row": 2, "K1-bwd": 2, "K2": 24,
                                        "K2.row": 12, "K2-bwd": 8, "S1": 1, "S1-bwd": 1}))
    if n_got != {k: v * accum_steps for k, v in per_micro.items()}:
        failed.append(f"launches {n_got}")
    for k, r in m_ref.items():
        if k != "point_mean_iou" and \
                abs(m_got[k] - r) > 1e-3 * abs(r) + 1e-6 + 2 * spread_m[k]:
            failed.append(f"{k}: {m_got[k]} vs {r} (CPU spread {spread_m[k]})")
    worst = {}
    for what, rel in (("grad", 1e-2), ("param", 1e-3)):
        shares = []
        for k, r in t_ref[what].items():
            err = (t_got[what][k] - r).abs()
            base = torch.full_like(r, rel * r.abs().max().item() + 1e-6)
            if what == "param" and k in t_ref["grad"]:  # parameters take the Adam step
                g = t_ref["grad"][k].abs()
                g_tol = 1e-2 * g.max().item() + 1e-6 + 2 * spread_t["grad"][k]
                base = torch.where(g <= g_tol, torch.full_like(base, 2 * lr + 1e-6), base)
            share = (err / (base + 2 * spread_t[what][k])).max().item()
            shares.append((share, k, err.max().item(), (err / base).max().item()))
            if share > 1:
                failed.append(f"{what} {k}: max|diff| {err.max().item()} over its "
                              f"tolerance by {share:.3g}x")
        top = max(shares)
        # tensors that needed the measured spread, by module
        over = {}
        for s in shares:
            if s[3] > 1:
                mod = ".".join(s[1].split(".")[:2])
                over[mod] = over.get(mod, 0) + 1
        worst[what] = {"tensors": len(shares), "worst_share_of_tol": top[0], "worst": top[1],
                       "max_abs_err": top[2], "over_plain_tol": over}
    rec["compare"] = worst
    emit(rec)
    check(not failed, f"tiny_train {mxu_readout} x{accum_steps}: " + "; ".join(failed[:10]))


def point_scores(model, batch, compute_dtype):
    """Per-point class scores [1, P, C] float32 of the eval step's readout
    (``engine/eval.py``), the forward under autocast when ``compute_dtype``
    is given."""
    import torch

    from occformer_tpu_torch.engine.eval import lidarseg_point_logits, to_device_batch
    from occformer_tpu_torch.models.mask2former_head import (
        format_results,
        mask_logits_from_embeds,
    )

    b = to_device_batch(batch, torch.device("cuda"))
    with torch.inference_mode(), torch.autocast("cuda", dtype=compute_dtype or torch.float32,
                                                enabled=compute_dtype is not None):
        out = model(b)
        voxels = format_results(out["cls_preds"][-1], mask_logits_from_embeds(
            out["mask_embeds"][-1], out["mask_feature"]))
        return lidarseg_point_logits(voxels, b["lidar_xyz"]).float()


def serve_frames(step, batch, frames=4):
    """``frames`` calls of ``step`` (the first a warm-up): (ms of each, peak
    bytes over them, resident bytes before them, the last output)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    frames_ms = []
    for _ in range(frames):
        t = time.perf_counter()
        out = step(batch)
        torch.cuda.synchronize()
        frames_ms.append((time.perf_counter() - t) * 1e3)
    return frames_ms, torch.cuda.max_memory_allocated(), resident, out


def backward_repeats(captured, repeats=6):
    """Whether each captured module's backward repeats itself bit for bit at
    the inputs it saw, under the autocast it ran in: ``repeats`` calls of
    ``autograd.grad`` (in its first input where that needs a gradient, and
    in its parameters) of one forward, on one output gradient, against the
    first.  ``module``: the module as the model runs it.  For convolutions
    also ``default``, the plain ``nn.Conv*`` forward, whose backward takes
    cuDNN's default algorithms (the same as ``module`` but for the
    convolutions the port gives another backward, ``layers.
    Conv3dFixedOrderBackward`` and ``Conv2dIm2colBackward``), and
    ``deterministic``, that plain forward with
    ``torch.backends.cudnn.deterministic`` on around its backward.  The
    backwards are timed (CUDA events, median of 5) where the default one
    varies or the port replaces it.  Returns how many modules were probed
    and the records of those whose backward varied in some mode or was
    replaced."""
    import contextlib

    import torch

    from occformer_tpu_torch.models.layers import (
        Conv2dIm2colBackward,
        Conv3dFixedOrderBackward,
    )

    @contextlib.contextmanager
    def deterministic(on):
        before = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = on
        try:
            yield
        finally:
            torch.backends.cudnn.deterministic = before

    convs = (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.ConvTranspose2d)
    g = torch.Generator(device="cuda").manual_seed(11)
    rec = {}
    for name, (mod, args, kwargs, dtype) in captured.items():
        x = args[0]
        params = [p for p in mod.parameters() if p.requires_grad]
        if not (params or x.requires_grad):
            continue
        replaced = isinstance(mod, (Conv3dFixedOrderBackward, Conv2dIm2colBackward))
        base = torch.nn.Conv3d if isinstance(mod, Conv3dFixedOrderBackward) else torch.nn.Conv2d
        plain = (lambda *a, m=mod, **k: base.forward(m, *a, **k)) if replaced else mod.forward
        runs = {"module": (mod.forward, False)}
        if isinstance(mod, convs):
            runs.update(default=(plain, False), deterministic=(plain, True))
        r = {"type": type(mod).__name__, "input": list(x.shape), "dtype": str(x.dtype),
             "autocast": None if dtype is None else str(dtype), "replaced": replaced}
        xl = x.detach().clone().requires_grad_(x.requires_grad)
        leaves = ([xl] if x.requires_grad else []) + params
        outs = {}
        with torch.autocast("cuda", dtype=dtype or torch.float32, enabled=dtype is not None):
            gout = None
            for how, (fwd, det) in runs.items():
                outs[how] = fwd(xl, *args[1:], **kwargs)
                if gout is None:
                    gout = torch.randn(outs[how].shape, device="cuda", generator=g,
                                       dtype=outs[how].dtype)
                first, varies = None, False
                for _ in range(repeats):
                    with deterministic(det):
                        grads = torch.autograd.grad(outs[how], leaves, gout, retain_graph=True)
                    if first is None:
                        first = grads
                    else:
                        varies |= not all(torch.equal(a, b) for a, b in zip(first, grads))
                r[f"{how}_varies"] = varies
            if replaced or r.get("default_varies"):
                for how in runs:
                    with deterministic(runs[how][1]):
                        r[f"{how}_backward_ms"] = time_cuda(lambda: torch.autograd.grad(
                            outs[how], leaves, gout, retain_graph=True), iters=5, warmup=2)
        del outs, xl, leaves
        rec[name] = r
    return {"probed": len(rec),
            "varying_or_replaced": {k: r for k, r in rec.items() if r["replaced"] or any(
                r.get(f"{how}_varies") for how in ("module", "default", "deterministic"))}}


def atomic_scatter(depth, ctx, coords, valid, nx):
    """The LSS scatter through its plain version: atomic index_add_."""
    import numpy as np

    from occformer_tpu_torch.ops import scatter

    B, n_rows = depth.shape[0], depth.shape[0] * int(np.prod(nx))
    return scatter.voxel_scatter_plain(depth, ctx, scatter.voxel_rows(coords, valid, nx),
                                       n_rows).reshape(B, *nx, -1).to(depth.dtype)


def s1_check(depth, ctx, coords, valid, nx, label):
    """S1 against its plain version (the atomic index_add_), two calls
    bit-equal, both timed in turns, beside one index_add_ of the whole
    lift (the library call); the sort's segment sizes; and under
    ``backward`` S1-bwd (``s1_backward_check``)."""
    import torch

    from occformer_tpu_torch.ops import scatter
    from occformer_tpu_torch.tools.time_backwards import segment_stats

    got = scatter.voxel_scatter_lifted(depth, ctx, coords, valid, nx)
    again = scatter.voxel_scatter_lifted(depth, ctx, coords, valid, nx)
    ref = atomic_scatter(depth.float(), ctx.float(), coords, valid, nx)
    s1 = compare(got, ref, 1e-5 if got.dtype == torch.float32 else 1e-2, f"S1 {label}")
    check(torch.equal(got, again), f"S1 {label}: two calls differ")
    s1["bit_identical_calls"] = True
    s1["dtypes"] = [str(depth.dtype), str(ctx.dtype), str(coords.dtype),
                    str(valid.dtype), str(got.dtype)]
    s1["shapes"] = [list(a.shape) for a in (depth, ctx, coords, valid)]
    s1.update(segment_stats(coords, valid, nx))
    del again, ref
    ms = {"atomic_scatter": [], "deterministic_scatter": []}
    with torch.no_grad():
        for name in ("atomic_scatter", "deterministic_scatter", "deterministic_scatter",
                     "atomic_scatter"):
            fn = atomic_scatter if name == "atomic_scatter" else scatter.voxel_scatter_lifted
            ms[name].append(time_cuda(lambda: fn(depth, ctx, coords, valid, nx)))
        rows = scatter.voxel_rows(coords, valid, nx).reshape(-1)
        lift = (depth[..., None] * ctx[:, :, None]).reshape(rows.shape[0], -1).float()
        vol = torch.zeros((depth.shape[0] * int(nx[0]) * int(nx[1]) * int(nx[2]) + 1,
                           lift.shape[1]), device=lift.device)
        s1["library_ms"] = time_cuda(lambda: vol.index_add_(0, rows, lift))
        del rows, lift, vol
        # the kernels alone, the sort's included
        s1["device_ms"] = device_ms(lambda: scatter.voxel_scatter_lifted(
            depth, ctx, coords, valid, nx))
    s1["ms_in_turns"] = ms
    s1["kernel_ms"] = sum(ms["deterministic_scatter"]) / 2
    s1["plain_ms"] = sum(ms["atomic_scatter"]) / 2
    # the function's inputs read once and its volume written once; a
    # product and an add per (valid point, channel)
    s1.update(bound(nbytes(depth, ctx, coords, valid, got),
                    s1["points_valid"] * ctx.shape[-1] * 2))
    del got
    s1["backward"] = s1_backward_check(depth, ctx, coords, valid, nx, label,
                                       s1["voxels_filled"], s1["points_valid"])
    return s1


def s1_backward_check(depth, ctx, coords, valid, nx, label, voxels_filled, points_valid):
    """S1-bwd (``ops/scatter.py:_launch_bwd``) against its plain version
    (``voxel_scatter_backward_plain``: float32 gathers of every point's row
    and two products of the lift's size) on a random volume gradient:
    d_depth and d_ctx within float32 1e-5 / bf16 1e-2 of max |plain| (each
    in its own dtype), two calls bit-equal, autograd through S1 one launch
    of it and its bits, and the same bits from the gradient in the layout
    the main path hands over (the encoder's permute: a transposed view at
    batch 1, which the kernel transposes itself); the kernel and the plain
    backward timed in turns on that layout, the kernel's device ms on it
    and on rows, autograd through one ``index_add_`` of the whole lift (the
    library call) and the bound."""
    import torch
    import torch.nn.functional as F

    from occformer_tpu_torch.ops import scatter

    d_leaf, c_leaf = (t.detach().clone().requires_grad_(True) for t in (depth, ctx))
    vol = scatter.voxel_scatter_lifted(d_leaf, c_leaf, coords, valid, nx)
    g_vol = torch.randn(vol.shape, device=vol.device, dtype=vol.dtype,
                        generator=torch.Generator(device="cuda").manual_seed(17))
    C = g_vol.shape[-1]
    gout = g_vol.reshape(-1, C)
    # as the main path hands it over: the gradient of volume.permute(0, 4, 1, 2, 3)
    main_gout = g_vol.permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1).reshape(-1, C)

    def kernel(g=main_gout):
        return scatter._launch_bwd(depth, ctx, coords, valid, g, nx)

    def plain():
        return scatter.voxel_scatter_backward_plain(depth, ctx, coords, valid, main_gout, nx)

    got, again, rows = kernel(), kernel(), kernel(gout)
    check(all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(got, again, rows)),
          f"S1-bwd {label}: two calls, or the two gradient layouts, differ")
    ref = plain()
    errs = [compare(a, r, 1e-5 if a.dtype == torch.float32 else 1e-2,
                    f"S1-bwd {label} {name}")
            for a, r, name in zip(got, ref, ("d_depth", "d_ctx"))]
    before = launches()["S1-bwd"]
    auto = torch.autograd.grad(vol, (d_leaf, c_leaf), g_vol, retain_graph=True)
    check(launches()["S1-bwd"] == before + 1 and all(torch.equal(a, b)
                                                    for a, b in zip(auto, got)),
          f"S1-bwd {label}: autograd through S1 is not one launch of S1-bwd with its bits")
    rec = {"max_abs_err": max(e["max_abs_err"] for e in errs), "d_depth": errs[0],
           "d_ctx": errs[1], "bit_identical_calls": True, "autograd_bit_equal": True,
           "dtypes": [str(t.dtype) for t in got],
           "gradient_transposed": main_gout.stride() == (1, main_gout.shape[0])}
    del again, rows, ref, auto
    ms = {"plain": [], "kernel": []}
    for name in ("kernel", "plain", "plain", "kernel"):
        ms[name].append(time_cuda(kernel if name == "kernel" else plain, iters=10))
    rec.update(ms_in_turns=ms, kernel_ms=sum(ms["kernel"]) / 2, plain_ms=sum(ms["plain"]) / 2,
               device_ms=device_ms(kernel, iters=10),
               rows_device_ms=device_ms(lambda: kernel(gout), iters=10))
    # the library call: autograd through one index_add_ of the whole lift
    rows = scatter.voxel_rows(coords, valid, nx).reshape(-1)
    lift = (d_leaf[..., None] * c_leaf[:, :, None]).reshape(rows.shape[0], -1).float()
    lib_vol = lift.new_zeros((gout.shape[0] + 1, C)).index_add(0, rows, lift)
    lib_g = F.pad(gout.float(), (0, 0, 0, 1))
    rec["library_ms"] = time_cuda(lambda: torch.autograd.grad(
        lib_vol, (d_leaf, c_leaf), lib_g, retain_graph=True), iters=10)
    # the backward's least work: valid read in full; the gradient's row of
    # each filled voxel once, the valid points' depth and coords, and ctx's
    # row of each pixel that holds a valid point (an invalid point needs
    # none of them); d_depth and d_ctx written once; a product and an add
    # per (valid point, channel) for each of the two gradients
    pixels_used = int(valid.any(dim=2).sum())
    rec.update(bound(nbytes(valid, depth, ctx) + voxels_filled * C * g_vol.element_size()
                     + points_valid * (depth.element_size() + 3 * coords.element_size())
                     + pixels_used * C * ctx.element_size(), points_valid * C * 4))
    rec["pixels_with_a_valid_point"] = pixels_used
    del d_leaf, c_leaf, vol, g_vol, gout, main_gout, got, rows, lift, lib_vol, lib_g
    return rec


def phase_determinism():
    """Whether a reloaded train step on the card repeats itself bit for bit
    on the port's default settings (no torch deterministic mode, no global
    cuDNN switch, cuDNN's TF32 as torch sets it).  A model, optimizer, batch
    and step seed are fixed; each pair of steps starts from one saved state
    (model and optimizer reloaded bit for bit) and records every loss, the
    LSS volume, the loss's uncertainty selections (the per-layer route's
    top-k index sets, the batched route's 0/1 selections), the gradients the
    loss hands back to the model (of the class logits, mask embeddings and
    mask feature), grad_norm and every parameter's gradient before the
    optimizer's global-norm clip (``grads_differ_by_module``: per module,
    the parameters whose gradients differed in some pair, of those with one;
    after the clip every gradient differs where grad_norm does).

    * Per-layer route (C.4, ops/scatter.py), on the tiny CLI model
      (synthetic_tiny, frozen stem) and on the flagship at full width: pairs
      with the LSS scatter's atomic order (its plain version, index_add_;
      C.4's record), then with the port as it is (S1, the default).
    * Batched route (C.5, mxu_readout="on") on the flagship: pairs with the
      port as it is.
    Every pair of the port as it is must repeat its losses, volumes,
    selections, grad_norm and every parameter's gradient (C.6-C.8: K1-bwd,
    the FPN upsample's backward and the DepthNet DCN's sampler, K4-bwd, sum
    in a fixed order; the FPN's and the occupancy encoder's input
    convolutions take cuDNN's deterministic backward, the DepthNet's
    dilated ASPP branches of dilation 12 and 18 an im2col one),
    and the batched pairs the loss's gradients too.  Then the modules of the
    tiny model and the flagship's convolutions at the inputs their step gave
    them (``backward_repeats``): none may vary as the model runs it; which
    vary on cuDNN's default algorithms is recorded (C.8).  Then S1 (the
    splat kernel behind the default mode) on the flagship's captured depth
    and context at two geometries (``s1_check``): the voxel coordinates of a
    forward-looking nuScenes rig (``tools/time_backwards.py:NUSCENES_RIG``;
    S1's record) and those the captured step saw (the synthetic cameras,
    which look straight up)."""
    import copy

    import numpy as np
    import torch

    import occformer_tpu_torch.engine.train as train_mod
    import occformer_tpu_torch.losses.mask2former_loss as loss_mod
    import occformer_tpu_torch.models.lss as lss_mod
    from occformer_tpu_torch.config import load_config
    from occformer_tpu_torch.data.loader import build_dataloader, build_dataset
    from occformer_tpu_torch.data.synthetic import make_train_batch
    from occformer_tpu_torch.engine.optim import build_optimizer_from_config
    from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step
    from occformer_tpu_torch.models.detector import build_model
    from occformer_tpu_torch.models.swin import WindowMSA
    from occformer_tpu_torch.ops import scatter
    from occformer_tpu_torch.tools.time_backwards import s1_geometry, segment_stats

    topks, volumes, captured, loss_grads, convs = [], [], [], {}, {}
    orig_topk, orig_scatter = loss_mod.uncertainty_topk, lss_mod.voxel_scatter_lifted
    orig_select, orig_loss = loss_mod.uncertainty_select, train_mod.mask2former_loss

    def rec_topk(logits, n):
        idx = orig_topk(logits, n)
        topks.append(idx.detach().clone())
        return idx

    def rec_select(logits, n):
        sel = orig_select(logits, n)
        topks.append(sel.clone())
        return sel

    def rec_loss(cls_preds, mask_embeds, mask_feature, *rest, **kwargs):
        for name, t in (("cls_preds", cls_preds), ("mask_embeds", mask_embeds),
                        ("mask_feature", mask_feature)):
            if t.requires_grad:
                t.register_hook(lambda g, name=name: loss_grads.__setitem__(
                    name, g.detach().clone()))
        return orig_loss(cls_preds, mask_embeds, mask_feature, *rest, **kwargs)

    mode = {"atomic": False}

    def rec_scatter(*args):
        if not captured:
            captured.append([a.detach().clone() if torch.is_tensor(a) else a for a in args])
        out = (atomic_scatter if mode["atomic"] else orig_scatter)(*args)
        volumes.append(out.detach().clone())
        return out

    def pairs(cfg_path, options, batch, n_pairs, warm_step, compute_dtype, modes,
              mxu_readout=None, capture_convs=()):
        """``n_pairs`` pairs of reloaded steps in each of ``modes``: (name,
        atomic scatter).  ``capture_convs``: module types whose inputs in the
        warm step ``backward_repeats`` replays."""
        cfg = load_config(cfg_path, options)
        m = cfg["model"]
        head = m["pts_bbox_head"] if mxu_readout is None else dict(m["pts_bbox_head"],
                                                                    mxu_readout=mxu_readout)
        model = build_model(m, device="cuda", dtype=torch.float32, seed=0).train()
        opt = build_optimizer_from_config(model, cfg, 16)
        step = build_train_step(model, opt, build_loss_cfg(head, m["train_cfg"]["pts"]),
                                device="cuda", compute_dtype=compute_dtype)
        if batch is None:
            batch = next(iter(build_dataloader(build_dataset(cfg["data"]["train"]),
                                               max_points=512)))
            batch.pop("_meta")
        hooks = []

        def keep_input(name, mod, args, kwargs):
            if name not in convs:
                keep = [a.detach().clone().requires_grad_(a.requires_grad)
                        if torch.is_tensor(a) else a for a in args]
                convs[name] = (mod, keep, dict(kwargs),
                               torch.get_autocast_dtype("cuda")
                               if torch.is_autocast_enabled("cuda") else None)

        if capture_convs:
            for name, mod in model.named_modules():
                if isinstance(mod, capture_convs):
                    hooks.append(mod.register_forward_pre_hook(
                        lambda mod, args, kwargs, name=name: keep_input(name, mod, args, kwargs),
                        with_kwargs=True))
        if warm_step or capture_convs:
            step(batch, torch.Generator(device="cuda").manual_seed(0))
        for h in hooks:
            h.remove()
        state = copy.deepcopy((model.state_dict(), opt.state_dict()))
        names = [k for k, p in model.named_parameters()]

        def run():
            model.load_state_dict(state[0])
            opt.load_state_dict(state[1])
            topks.clear()
            volumes.clear()
            loss_grads.clear()
            grads = []

            def opt_step():  # the gradients as the backward left them, before the clip
                grads.extend(None if p.grad is None else p.grad.detach().clone()
                             for p in model.parameters())
                return type(opt).step(opt)

            opt.step = opt_step
            try:
                metrics = step(batch, torch.Generator(device="cuda").manual_seed(1))
            finally:
                del opt.step
            return ({k: float(v) for k, v in metrics.items()}, list(topks), list(volumes),
                    dict(loss_grads), grads)

        rec = {}
        for name, atomic in modes:
            mode["atomic"] = atomic
            counts = {"pairs": n_pairs, "losses_differ": 0, "volumes_differ": 0,
                      "topk_differ": 0, "topk_sets_differing": 0, "grad_norm_differs": 0,
                      "loss_grads_differ": 0, "max_rel_loss_diff": 0.0}
            grads_differ = {}
            for _ in range(n_pairs):
                (ma, ta, va, la, ga), (mb, tb, vb, lb, gb) = run(), run()
                losses = [k for k in ma if "loss" in k]
                counts["losses_differ"] += any(ma[k] != mb[k] for k in losses)
                counts["max_rel_loss_diff"] = max(
                    [counts["max_rel_loss_diff"]]
                    + [abs(ma[k] - mb[k]) / max(abs(ma[k]), 1e-12) for k in losses])
                counts["volumes_differ"] += not all(torch.equal(a, b) for a, b in zip(va, vb))
                differing = sum(not torch.equal(a, b) for a, b in zip(ta, tb))
                counts["topk_differ"] += differing > 0
                counts["topk_sets_differing"] += differing
                counts["grad_norm_differs"] += ma["grad_norm"] != mb["grad_norm"]
                counts["loss_grads_differ"] += sorted(la) != sorted(lb) or not all(
                    torch.equal(la[k], lb[k]) for k in la)
                for k, a, b in zip(names, ga, gb):
                    if a is None:
                        continue
                    module = ".".join(k.split(".")[:2])
                    d = grads_differ.setdefault(module, set())
                    if not torch.equal(a, b):
                        d.add(k)
                del ga, gb
            counts["topk_sets_per_step"] = len(ta)
            counts["loss_grads_compared"] = sorted(la)
            n_grads = {}
            for k, p in model.named_parameters():
                if p.grad is not None:
                    module = ".".join(k.split(".")[:2])
                    n_grads[module] = n_grads.get(module, 0) + 1
            counts["param_grads_differ"] = sum(len(v) for v in grads_differ.values())
            # by name, in the modules where only some of the gradients differ
            counts["param_grads_differing"] = sorted(
                k for mod, v in grads_differ.items() if 0 < len(v) < n_grads[mod] for k in v)
            counts["param_grads"] = sum(n_grads.values())
            counts["grads_differ_by_module"] = {
                mod: [len(v), n_grads[mod]] for mod, v in grads_differ.items() if v}
            rec[name] = counts
        del model, opt, step, state
        return rec

    scatter_modes = (("atomic_scatter", True), ("deterministic_scatter", False))
    loss_mod.uncertainty_topk, lss_mod.voxel_scatter_lifted = rec_topk, rec_scatter
    loss_mod.uncertainty_select, train_mod.mask2former_loss = rec_select, rec_loss
    # the port's default settings: torch's own cuDNN TF32 (main() turns it
    # off for the float32 references of the other phases)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    check(not torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
          and not torch.are_deterministic_algorithms_enabled(),
          "reload_determinism: a global determinism switch is on")
    try:
        tiny = os.path.join(REPO, "occformer_tpu_torch", "configs", "synthetic_tiny.py")
        conv_types = (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.ConvTranspose2d)
        rec = {"phase": "reload_determinism",
               "settings": {"cudnn.deterministic": False, "cudnn.benchmark": False,
                            "cudnn.allow_tf32": True, "deterministic_algorithms": False},
               "tiny": pairs(tiny, {"model.img_backbone.frozen_stages": 0}, None, 5, True,
                             None, scatter_modes, capture_convs=conv_types + (
                                 torch.nn.Linear, torch.nn.LayerNorm, torch.nn.GroupNorm,
                                 WindowMSA))}
        rec["tiny_modules"] = backward_repeats(convs)
        torch.backends.cudnn.allow_tf32 = False  # the float32 references' setting
        rec["tiny_modules_without_tf32"] = backward_repeats(
            {k: v for k, v in convs.items() if isinstance(v[0], conv_types)})
        torch.backends.cudnn.allow_tf32 = True
        convs.clear()
        free_memory()
        captured.clear()  # keep the flagship's inputs
        cfg = load_config(CONFIG)
        batch = make_train_batch(cfg, seed=0)
        dtype = getattr(torch, cfg["compute_dtype"])
        rec["flagship"] = pairs(CONFIG, {}, batch, 2, False, dtype, scatter_modes,
                                capture_convs=conv_types)
        rec["flagship_modules"] = backward_repeats(convs)
        convs.clear()
        free_memory()
        rec["flagship_batched"] = pairs(CONFIG, {}, batch, 2, False, dtype, (("kernels", False),),
                                        mxu_readout="on")
    finally:
        loss_mod.uncertainty_topk, lss_mod.voxel_scatter_lifted = orig_topk, orig_scatter
        loss_mod.uncertainty_select, train_mod.mask2former_loss = orig_select, orig_loss
        torch.backends.cudnn.allow_tf32 = tf32
    free_memory()

    # S1 on the flagship's captured depth and context, at a forward-looking
    # nuScenes rig's voxel coordinates (S1's record) and at those the
    # captured step saw
    depth, ctx, coords, valid, nx = captured[0]
    captured.clear()
    rig_coords, rig_valid, rig_nx, _ = s1_geometry("nuscenes")
    check(tuple(rig_nx) == tuple(nx) and rig_coords.shape == coords.shape,
          f"S1: the rig's grid {rig_nx} {list(rig_coords.shape)} is not the flagship's")
    rec["S1"] = dict(s1_check(depth, ctx, rig_coords, rig_valid, nx, "nuscenes rig"),
                     geometry="tools/time_backwards.py:NUSCENES_RIG")
    rec["S1_synthetic_cameras"] = dict(s1_check(depth, ctx, coords, valid, nx,
                                                "synthetic cameras"),
                                       geometry="data/synthetic.py:make_train_batch")
    del depth, ctx, coords, valid, rig_coords, rig_valid
    emit(rec)
    # C.4-C.8: the port as it is repeats every loss, volume, selection,
    # gradient and grad_norm in every pair; the batched route the loss's
    # gradients too
    for name, r in (("tiny", rec["tiny"]["deterministic_scatter"]),
                    ("flagship", rec["flagship"]["deterministic_scatter"]),
                    ("flagship_batched", rec["flagship_batched"]["kernels"])):
        check(r["losses_differ"] == r["volumes_differ"] == r["topk_differ"]
              == r["grad_norm_differs"] == r["param_grads_differ"] == 0
              and r["param_grads"] > 0,
              f"reload_determinism {name}: a pair differs: {r}")
    r = rec["flagship_batched"]["kernels"]
    check(r["loss_grads_differ"] == 0 and len(r["loss_grads_compared"]) == 3,
          f"reload_determinism flagship_batched: the loss's gradients differ: {r}")
    for size in ("tiny", "flagship"):
        probe = rec[f"{size}_modules"]
        varies = [k for k, v in probe["varying_or_replaced"].items() if v["module_varies"]]
        check(probe["probed"] > 0 and not varies,
              f"reload_determinism {size}: the backward of {varies} varies as the model runs it")
    return rec


def phase_serve():
    """Serving as the JAX package serves: float32 parameters, the forward
    under bf16 autocast (``build_eval_step(..., compute_dtype)``).  Then,
    once, the route the port served before (every parameter and buffer cast
    to bf16, no autocast) on the same weights and frame: its ms/frame and
    peak, and how far its predictions stand from the served ones (share of
    equal ``point_pred``, largest gap of the per-point class scores)."""
    import torch

    from occformer_tpu_torch.config import load_config
    from occformer_tpu_torch.data.synthetic import make_serving_batch
    from occformer_tpu_torch.engine.eval import build_eval_step
    from occformer_tpu_torch.models.detector import build_model

    cfg = load_config(CONFIG)
    compute_dtype = getattr(torch, cfg["compute_dtype"])
    t0 = time.perf_counter()
    model = build_model(cfg["model"], device="cuda", dtype=torch.float32, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    num_classes = cfg["model"]["pts_bbox_head"]["num_occupancy_classes"]
    occ_size = tuple(cfg["occ_size"])
    batch = make_serving_batch(cfg, seed=0)
    step = build_eval_step(model, occ_size, num_classes, compute_dtype)

    reset_launches()  # the main path's run starts here
    frames_ms, peak, resident, out = serve_frames(step, batch)
    n = launches()  # ... and ends here
    SERVE_FRAMES_MS[:] = frames_ms[1:]

    P = batch["lidar_xyz"].shape[1]
    rec = {"phase": "serve", "config": "occformer_nusc_r50_256x704",
           "param_dtype": "float32", "autocast": cfg["compute_dtype"], "model_build_s": build_s,
           "params": sum(p.numel() for p in model.parameters()),
           "warmup_frame_ms": frames_ms[0], "frame_ms": frames_ms[1:],
           "frames_run": len(frames_ms), "launches": n,
           "peak_memory_bytes": peak, "resident_bytes_at_start": resident,
           "voxel_pred": list(out["voxel_pred"].shape),
           "point_pred": list(out["point_pred"].shape)}
    want = {k: v * len(frames_ms) for k, v in SERVE_LAUNCHES.items()}
    check(n == want, f"serve launches {n} in {len(frames_ms)} frames, want {want}")
    check(rec["voxel_pred"] == [1, *occ_size], f"voxel_pred {rec['voxel_pred']}")
    check(rec["point_pred"] == [1, P], f"point_pred {rec['point_pred']}")
    cm = out["confusion"]
    check(list(cm.shape) == [num_classes] * 2 and int(cm.sum()) == P,
          f"confusion {list(cm.shape)} sums to {int(cm.sum())}, want {P}")
    check(int(out["voxel_pred"].max()) < num_classes
          and int(out["point_pred"].min()) >= 1, "predicted labels out of range")
    with torch.inference_mode(), torch.autocast("cuda", dtype=compute_dtype):
        raw = model({k: torch.as_tensor(v).cuda() for k, v in batch.items()})
    finite = {k: bool(torch.isfinite(v.float()).all()) for k, v in raw.items()}
    rec["finite"] = finite
    rec["shapes"] = {k: list(v.shape) for k, v in raw.items()}
    check(all(finite.values()), f"non-finite outputs: {finite}")
    rec["profile"] = profile(lambda: step(batch), SERVE_STAGES, SERVE_LAUNCHES)
    # the analytic count on the card, with the kernels, and on the CPU with
    # the plain versions (float32, no autocast): the same count
    rec["analytic"] = analytic_serve("serve", model, batch, compute_dtype, frames_ms[1:])
    from occformer_tpu_torch.tools.model_analysis import forward_flops

    card = forward_flops(model, batch, compute_dtype)
    t0 = time.perf_counter()
    plain = forward_flops(build_model(cfg["model"], device="cpu", seed=0), batch)
    check(card == plain, f"serve: analytic count on the card {card} != the plain versions' "
          f"{plain}")
    rec["analytic"].update(cpu_plain_versions_equal=True, cpu_count_s=time.perf_counter() - t0)

    # the route served before: the same weights, every tensor in bf16
    pred = out["point_pred"].clone()
    scores = point_scores(model, batch, compute_dtype)
    old = build_model(cfg["model"], device="cuda", dtype=torch.bfloat16, seed=1)
    old.load_state_dict(model.state_dict())  # cast to each of its tensors' dtypes
    del model, step, raw, out
    free_memory()
    old_step = build_eval_step(old, occ_size, num_classes)
    old_ms, old_peak, old_resident, old_out = serve_frames(old_step, batch)
    old_scores = point_scores(old, batch, None)
    rec["bf16_parameter_route"] = {
        "warmup_frame_ms": old_ms[0], "frame_ms": old_ms[1:], "peak_memory_bytes": old_peak,
        "resident_bytes_at_start": old_resident,
        "point_pred_agreement": (old_out["point_pred"] == pred).float().mean().item(),
        "distinct_point_classes": [len(torch.unique(pred)), len(torch.unique(old_out["point_pred"]))],
        "max_abs_point_score_gap": (old_scores - scores).abs().max().item(),
        "max_abs_point_score": scores.abs().max().item()}
    del old, old_step, old_out
    free_memory()
    emit(rec)
    return n


def phase_train(mxu_readout="off"):
    """The flagship's train step: float32 parameters, bfloat16 autocast,
    batch 1, random weights, ``make_train_batch(cfg, seed=0)``, on the loss
    route ``mxu_readout`` ("off" the per-layer route, "on" the batched
    one)."""
    import torch

    from occformer_tpu_torch.config import load_config
    from occformer_tpu_torch.data.synthetic import make_train_batch
    from occformer_tpu_torch.engine.optim import build_optimizer_from_config
    from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step
    from occformer_tpu_torch.models.detector import build_model

    cfg = load_config(CONFIG)
    m = cfg["model"]
    t0 = time.perf_counter()
    model = build_model(m, device="cuda", dtype=torch.float32, seed=0).train()
    loss_cfg = build_loss_cfg(dict(m["pts_bbox_head"], mxu_readout=mxu_readout),
                              m["train_cfg"]["pts"])
    opt = build_optimizer_from_config(model, cfg, 28130)  # nuScenes' train samples
    step = build_train_step(model, opt, loss_cfg, device="cuda",
                            compute_dtype=getattr(torch, cfg["compute_dtype"]))
    batch = make_train_batch(cfg, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    watch = {k: p.detach().clone() for k, p in model.named_parameters()
             if k in ("img_backbone.layer1.0.conv1.weight", "img_backbone.conv1.weight",
                      "img_bev_encoder_neck.encoder.layers.0.attentions.0.value_proj.weight",
                      "pts_bbox_head.query_feat.weight")}
    g = torch.Generator(device="cuda").manual_seed(0)
    name = "train" if mxu_readout == "off" else "train_batched"
    run = train_phase(name, step, [batch], TRAIN_LAUNCHES[mxu_readout], 4, g)
    TRAIN_PEAK[mxu_readout] = run["peak_memory_bytes"]
    moved = {k: (p.detach() - watch[k]).abs().max().item()
             for k, p in model.named_parameters() if k in watch}
    check(moved["img_backbone.conv1.weight"] == 0.0, "the frozen stem moved")
    check(all(v > 0 for k, v in moved.items() if k != "img_backbone.conv1.weight"),
          f"parameters did not move: {moved}")
    rec = {"phase": name, "mxu_readout": mxu_readout,
           "config": "occformer_nusc_r50_256x704",
           "param_dtype": "float32", "autocast": cfg["compute_dtype"],
           "params": sum(p.numel() for p in model.parameters()), "setup_s": build_s,
           **run, "max_param_change": moved,
           "loss_points": {"matching": loss_cfg.num_match_points,
                           "candidates": loss_cfg.num_candidates,
                           "supervised": loss_cfg.num_points}}
    rec["profile"] = profile(lambda: step(batch, g), TRAIN_STAGES,
                             TRAIN_LAUNCHES[mxu_readout])
    if loss_cfg.batched_readout:
        rec["routes"] = compare_routes(model, batch, loss_cfg)
    rec["analytic"] = analytic_train(name, step, batch, g, run["step_s"], model, opt)
    emit(rec)
    return run["launches"]


# the serving phase's frames (ms), beside the median frame before the
# kernels became dispatcher ops (PERF.md section 5: 129.2 ms on an H100 80GB
# HBM3 at 700 W), so that a slower host path through the dispatcher shows
SERVE_FRAMES_MS = []
REFERENCE_MEDIAN_FRAME_MS = 129.2
# the per-layer train phase's peak bytes, which the memory tool's step repeats
TRAIN_PEAK = {}


def phase_benchmark():
    """``tools/benchmark.py`` on the flagship with ``--stage-breakdown``:
    its JSON line, the image encoder faster than the program through the
    pixel decoder, and that faster than the whole forward."""
    from occformer_tpu_torch.tools import benchmark

    rec = benchmark.run(CONFIG, stage_breakdown=True)
    emit({"phase": "benchmark", **rec})
    check(rec["img_encoder_ms"] < rec["through_neck_ms"] < rec["full_ms"],
          f"benchmark stages out of order: {rec}")


def phase_memory():
    """``tools/memory_analysis.py`` on the flagship's per-layer train step:
    its JSON line; the step's peak within 3% of the ``train`` phase's, and
    every stage's peak at or below that."""
    from occformer_tpu_torch.tools import memory_analysis

    rec = memory_analysis.analyze(CONFIG, mxu_readout="off")
    peak = TRAIN_PEAK["off"]
    gib = 2.0 ** 30
    rec.update(phase="memory", train_phase_peak_gib=peak / gib)
    emit(rec)
    check(abs(rec["total_gib"] * gib - peak) <= 0.03 * peak,
          f"memory: the step's peak {rec['total_gib']} GiB against the train phase's "
          f"{peak / gib} GiB")
    check(all(v * gib <= 1.03 * peak for v in rec["stage_peak_gib"].values()),
          f"memory: stage peaks {rec['stage_peak_gib']} above the train phase's {peak / gib}")


# runs an exported serving program in a process that imports nothing of the
# port but its ops: argv = archive, batch file, output file
_LOAD_EXPORTED = """
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
import occformer_tpu_torch.ops as ops
extra = {"compute_dtype": ""}
ep = torch.export.load(sys.argv[2], extra_files=extra)
name = extra["compute_dtype"]
batch = torch.load(sys.argv[3])
ops.reset_launch_counts()
with torch.no_grad(), torch.autocast("cuda", dtype=getattr(torch, name),
                                     enabled=name != "float32"):
    out = ep.module()(batch)
torch.cuda.synchronize()
torch.save(out.cpu(), sys.argv[4])
print(json.dumps({"compute_dtype": name, "launches": ops.launch_counts(),
                  "modules": sorted(m for m in sys.modules if m.startswith("occformer"))}))
"""


def phase_export():
    """The flagship's serving function (``tools/export_model.py``) exported
    on the card at a serving frame: one ``occformer::*`` node per kernel
    launch of an eager call (launch counts), no operator that does a
    kernel's work outside them; the archive loaded and run in a fresh
    process that imports only ``occformer_tpu_torch.ops``, whose scores
    are the eager call's bit for bit, or within 1e-2 on the bf16 route;
    ``torch.library.opcheck`` of every op's CUDA implementation."""
    import torch

    from occformer_tpu_torch.config import load_config
    from occformer_tpu_torch.data.synthetic import make_serving_batch
    from occformer_tpu_torch.engine.eval import to_device_batch
    from occformer_tpu_torch.models.detector import build_model
    from occformer_tpu_torch.ops import library
    from occformer_tpu_torch.tools import export_model

    rec = {"phase": "export", "torch": torch.__version__,
           "serve_frame_ms": SERVE_FRAMES_MS,
           "serve_median_frame_ms": float(np.median(SERVE_FRAMES_MS)),
           "reference_median_frame_ms": REFERENCE_MEDIAN_FRAME_MS}
    cfg = load_config(CONFIG)
    dtype = export_model.compute_dtype_of(cfg)
    model = build_model(cfg["model"], device="cuda", dtype=torch.float32, seed=0)
    frame = make_serving_batch(cfg, seed=0)
    batch = to_device_batch({k: v for k, v in frame.items() if not k.startswith("lidar")},
                            torch.device("cuda"))
    export_model.eager_serving(model, batch, dtype)  # warm-up
    reset_launches()
    eager = export_model.eager_serving(model, batch, dtype)
    torch.cuda.synchronize()
    eager_launches = {k: launches()[k] for k in library.OPS}
    check(eager_launches == {k: SERVE_LAUNCHES[k] for k in library.OPS},
          f"export: an eager call launched {eager_launches}")
    t0 = time.perf_counter()
    ep = export_model.export_serving(model, batch, dtype)
    rec["export_s"] = time.perf_counter() - t0
    rec["graph_ops"] = library.graph_op_counts(ep.graph_module)
    check(rec["graph_ops"] == eager_launches,
          f"export: graph ops {rec['graph_ops']} != eager launches {eager_launches}")
    plain = sorted({str(n.target) for n in ep.graph.nodes
                    if any(p in str(n.target) for p in ("grid_sampler", "index_add",
                                                          "index_put"))})
    rec["plain_kernel_operators"] = plain
    check(not plain, f"export: operators that do a kernel's work in the graph: {plain}")
    same = export_model.run_exported(ep, dtype, batch)
    rec["in_process_max_abs_gap"] = (same.float() - eager.float()).abs().max().item()

    tmp = tempfile.mkdtemp(prefix="occformer_export_")
    try:
        path = os.path.join(tmp, "flagship.pt2")
        t0 = time.perf_counter()
        rec["archive_bytes"] = export_model.save_exported(ep, path, dtype)
        rec["save_s"] = time.perf_counter() - t0
        torch.save(batch, os.path.join(tmp, "batch.pt"))
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-c", _LOAD_EXPORTED, REPO, path,
                                 os.path.join(tmp, "batch.pt"), os.path.join(tmp, "out.pt")],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            # every op's CUDA implementation, while the fresh process starts
            rec["opcheck"] = {op: library.opcheck(op, device="cuda")
                              for op in library.OPS.values()}
            rec["opcheck_s"] = time.perf_counter() - t0
            out, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        rec["fresh_process_s"] = time.perf_counter() - t0
        check(all(set(r.values()) == {"SUCCESS"} for r in rec["opcheck"].values()),
              f"opcheck on the card: {rec['opcheck']}")
        check(proc.returncode == 0, f"export: the fresh process failed:\n{err[-3000:]}")
        child = json.loads(out.strip().splitlines()[-1])
        got = torch.load(os.path.join(tmp, "out.pt")).cuda()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["fresh_process"] = child
    check(not any(m.startswith(("occformer_tpu_torch.models", "occformer_tpu_torch.tools",
                                "occformer_tpu_torch.engine")) for m in child["modules"]),
          f"export: the fresh process imported {child['modules']}")
    check({k: child["launches"][k] for k in library.OPS} == eager_launches,
          f"export: the loaded program launched {child['launches']}")
    gap = (got.float() - eager.float()).abs().max().item()
    rec.update(max_abs_gap=gap, bit_equal=bool(torch.equal(got, eager)),
               argmax_agreement=(got.argmax(-1) == eager.argmax(-1)).float().mean().item(),
               shape=list(got.shape), dtype=str(got.dtype))
    check(got.shape == eager.shape and got.dtype == eager.dtype,
          f"export: output {got.shape} {got.dtype}, eager {eager.shape} {eager.dtype}")
    check(rec["bit_equal"] or (dtype is not None and gap <= 1e-2),
          f"export: the loaded program's scores differ from the eager call's by {gap}")
    emit(rec)


def compare_routes(model, batch, loss_cfg):
    """Both loss routes on one float32 copy of a step's model outputs (the
    train-mode forward under bf16 autocast, no grad) with one set of draws:
    every loss, and the Hungarian assignments.  A layer whose assignments
    agree must agree in its losses within 1e-4 relative (+1e-6): the two
    routes contract the volume and the feature sides in another order, and
    a candidate whose |logit| sits at the uncertainty top-k's boundary may
    swap in or out.  A layer whose assignments differ (near-tied costs can
    flip one) is reported, not held to that."""
    import dataclasses

    import torch

    from occformer_tpu_torch.engine.eval import to_device_batch
    from occformer_tpu_torch.losses.mask2former_loss import (
        make_loss_draws,
        mask2former_loss,
        match_assignments,
    )
    from occformer_tpu_torch.models.layers import drop_path_generator

    b = to_device_batch(batch, torch.device("cuda"))
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16), \
            drop_path_generator(torch.Generator(device="cuda").manual_seed(6)):
        out = model(b)
    out = {k: out[k].float() for k in ("cls_preds", "mask_embeds", "mask_feature")}
    L = out["cls_preds"].shape[0]
    # the panoptic head's GT slots, as the train step passes them
    gt = dict(panoptic_ids=b["panoptic_ids"]) if loss_cfg.panoptic else {}
    draws = make_loss_draws(torch.Generator(device="cuda").manual_seed(7), loss_cfg,
                            b["lidar_valid"], L,
                            b["panoptic_ids"].shape[1] if loss_cfg.panoptic else None)
    args = (out["cls_preds"], out["mask_embeds"], out["mask_feature"], b["gt_occ"])
    res = {}
    for route in ("off", "on"):
        cfg = dataclasses.replace(loss_cfg, mxu_readout=route)
        rest = (cfg, b["lidar_xyz"], b["lidar_valid"], draws)
        with torch.no_grad():
            losses = {k: float(v) for k, v in mask2former_loss(*args, *rest, **gt).items()}
            res[route] = (losses, match_assignments(*args, *rest, **gt).cpu())
    (ref, a_ref), (got, a_got) = res["off"], res["on"]
    differ = (a_ref != a_got).nonzero().tolist()  # [layer, sample, slot]
    layers_differ = sorted({d[0] for d in differ})
    rel = {k: abs(got[k] - r) / max(abs(r), 1e-12) for k, r in ref.items()}
    rec = {"losses_per_layer_route": ref, "losses_batched_route": got, "rel_diff": rel,
           "max_rel_diff": max(rel.values()), "assignments_differ": differ,
           "layers_with_differing_assignments": layers_differ}
    for k, r in ref.items():
        layer = L - 1 if not k.startswith("d") else int(k[1:k.index(".")])
        if k != "unassigned_gt" and layer not in layers_differ:
            check(abs(got[k] - r) <= 1e-4 * abs(r) + 1e-6,
                  f"routes: {k} {got[k]} (batched) vs {r} (per layer)")
    check(got["unassigned_gt"] == ref["unassigned_gt"] == 0.0, "routes: unassigned GT")
    return rec



class _TimedSamples:
    """A dataset whose ``__getitem__`` records its host ms (the loader's
    producer thread calls it)."""

    def __init__(self, dataset):
        self.dataset, self.ms = dataset, []

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        t = time.perf_counter()
        out = self.dataset[i]
        self.ms.append((time.perf_counter() - t) * 1e3)
        return out


def pipeline_ms(dataset, max_points):
    """Host ms per sample of ``dataset``'s pipeline on this thread, by step
    (each step's ``__call__``), and of ``collate_batch``: medians over the
    samples, and the whole sample's."""
    import statistics

    from occformer_tpu_torch.data.loader import collate_batch
    from occformer_tpu_torch.data.nuscenes import sample_rng

    by_step, whole = {}, []
    for i in range(len(dataset)):
        t0 = time.perf_counter()
        results = dataset.get_data_info(i)
        results["aug_rng"] = sample_rng(dataset.seed, dataset.epoch, i)  # as _run_pipeline
        for step in dataset.pipeline:
            t = time.perf_counter()
            results = step(results)
            by_step.setdefault(type(step).__name__, []).append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        collate_batch([results], max_points=max_points, rng=np.random.RandomState(i))
        by_step.setdefault("collate_batch", []).append((time.perf_counter() - t) * 1e3)
        whole.append((time.perf_counter() - t0) * 1e3)
    return {"samples": len(dataset), "ms_per_sample": statistics.median(whole),
            "ms_by_step": {k: statistics.median(v) for k, v in by_step.items()}}


def busy_share(run):
    """Wall ms of ``run()`` and the share of it the device spent in kernels
    (torch.profiler's device time over the host clock).  Only the device's
    activity is traced: reading a trace of the host's operators too took
    98 s for an epoch of 8 flagship train steps on an H100, and the
    host-side tracing slowed the run it measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from occformer_tpu_torch.utils.timing import device_kernels, lead_in

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        lead_in()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    dev_ms = sum(e.self_device_time_total for e in device_kernels(prof.key_averages())) / 1e3
    return {"wall_ms": wall_ms, "device_ms": dev_ms, "device_busy_share": dev_ms / wall_ms,
            "trace_read_s": time.perf_counter() - t}


def phase_data(root):
    """The flagship's nuScenes data pipeline at full size on the card's host,
    on a tree that ``data/fixtures.py:make_nuscenes_tree`` writes under
    ``root`` (8 samples at the nuScenes rig, 34000 LiDAR points each):

    * the train and test pipelines' host ms per sample on this one thread,
      by step (image load and augmentation, the depth z-buffer, the
      voxelization) and collation; a JPEG of the tree and one of pure
      per-pixel noise decoded by PIL;
    * the loader's (``build_dataloader``: one producer thread) samples per
      second alone, and its host ms per sample while flagship train steps
      run beside it;
    * the flagship's train step (per-layer route) over the epoch of 8
      pipeline batches through ``build_dataloader`` and
      ``prefetch_to_device`` (the train CLI's path: the launch counts of
      the main path, finite losses, the LiDAR inside the grid, depth in
      every camera; s/step, the time each step waited for its batch, the
      peak), beside 3 steps on ``make_train_batch`` batches;
    * the 8 frames of the test pipeline served (ms/frame, the time each
      frame waited for its batch), beside 3 on ``make_serving_batch``'s;
    each timed by the host clock, then run again under the profiler (the
    device's activity only) for the device's busy share.
    Returns (the record, the info pickle's path)."""
    import statistics

    import torch
    from PIL import Image

    from occformer_tpu_torch.config import load_config, parse_cfg_options
    from occformer_tpu_torch.data.fixtures import make_nuscenes_tree, nuscenes_cfg_options
    from occformer_tpu_torch.data.loader import (
        build_dataloader,
        build_dataset,
        prefetch_to_device,
    )
    from occformer_tpu_torch.data.synthetic import make_serving_batch, make_train_batch
    from occformer_tpu_torch.engine.eval import build_eval_step
    from occformer_tpu_torch.engine.optim import build_optimizer_from_config
    from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step
    from occformer_tpu_torch.models.detector import build_model

    rec = {"phase": "data", "cpu_count": os.cpu_count(), "samples": 8, "lidar_points": 34000}
    t = time.perf_counter()
    # the panoptic sidecars for the panoptic phases; the rest of the tree is
    # the same without them
    ann = make_nuscenes_tree(root, n_samples=8, n_points=34000, seed=0, panoptic=True)
    rec["tree_build_s"] = time.perf_counter() - t
    jpg = os.path.join(root, "samples", "CAM_FRONT", "sample0000.jpg")
    noise = os.path.join(root, "noise.jpg")
    Image.fromarray(np.random.RandomState(1).randint(0, 256, (900, 1600, 3), np.uint8)).save(
        noise, quality=90)

    def decode_ms(path):
        times = []
        for _ in range(5):
            t = time.perf_counter()
            Image.open(path).convert("RGB").load()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    rec["jpeg"] = {"bytes": os.path.getsize(jpg), "decode_ms": decode_ms(jpg),
                   "noise_bytes": os.path.getsize(noise), "noise_decode_ms": decode_ms(noise)}
    os.remove(noise)
    cfg = load_config(CONFIG)
    cfg = load_config(CONFIG, parse_cfg_options(nuscenes_cfg_options(cfg, root, ann)))
    max_points = cfg["max_lidar_points"]
    train_ds = build_dataset(cfg["data"]["train"])
    test_ds = build_dataset(cfg["data"]["val"], test_mode=True)
    rec["pipeline_ms"] = {"train": pipeline_ms(train_ds, max_points),
                          "test": pipeline_ms(test_ds, max_points)}

    timed = _TimedSamples(train_ds)
    t = time.perf_counter()
    n = sum(1 for _ in build_dataloader(timed, max_points=max_points, seed=0))
    alone_s = time.perf_counter() - t
    rec["loader_alone"] = {"batches": n, "samples_per_s": n / alone_s,
                           "ms_per_sample": statistics.median(timed.ms)}

    m = cfg["model"]
    model = build_model(m, device="cuda", dtype=torch.float32, seed=0).train()
    loss_cfg = build_loss_cfg(dict(m["pts_bbox_head"], mxu_readout="off"), m["train_cfg"]["pts"])
    opt = build_optimizer_from_config(model, cfg, 28130)
    step = build_train_step(model, opt, loss_cfg, device="cuda",
                            compute_dtype=getattr(torch, cfg["compute_dtype"]))
    g = torch.Generator(device="cuda").manual_seed(0)
    synthetic = make_train_batch(cfg, seed=0)
    step(synthetic, g)  # warm-up
    torch.cuda.synchronize()

    timed = _TimedSamples(train_ds)
    seen, history, steps_s, waits_ms = [], [], [], []

    def pipeline_epoch(epoch):
        it = iter(prefetch_to_device(build_dataloader(timed, max_points=max_points,
                                                      seed=epoch), torch.device("cuda")))
        while True:
            t = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                return
            waits_ms.append((time.perf_counter() - t) * 1e3)
            if not seen:
                seen.append({k: batch[k].detach().cpu() for k in
                             ("lidar_xyz", "lidar_valid", "gt_depth", "gt_occ", "imgs")})
            t = time.perf_counter()
            metrics = step(batch, g)
            torch.cuda.synchronize()
            steps_s.append(time.perf_counter() - t)
            history.append({k: float(v) for k, v in metrics.items()})

    # one epoch timed by the host clock, then one under the profiler for the
    # device's busy share (the profiler slows the host)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # the pipeline-fed train path starts here
    pipeline_epoch(1)
    n_train = launches()  # ... and ends here
    rec["train_pipeline"] = {
        "steps": len(steps_s), "step_s": list(steps_s), "batch_wait_ms": list(waits_ms),
        "launches": n_train, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "loader_ms_per_sample_beside_steps": statistics.median(timed.ms)}
    del steps_s[:], waits_ms[:]
    rec["train_pipeline"]["profiled_epoch"] = dict(busy_share(lambda: pipeline_epoch(2)),
                                                   step_s=steps_s, batch_wait_ms=waits_ms)
    rec["train_pipeline"]["metrics"] = history
    n_steps = rec["train_pipeline"]["steps"]
    check(n_steps == 8 and n_train == {k: v * 8 for k, v in TRAIN_LAUNCHES["off"].items()},
          f"data: pipeline-fed train launches {n_train} in {n_steps} steps, want 8 steps")
    for h in history:
        check(all(v == v and abs(v) != float("inf") for k, v in h.items()
                  if k != "point_mean_iou"), f"data: non-finite train metrics {h}")
    b = seen[0]
    xyz = b["lidar_xyz"][b["lidar_valid"]]
    in_grid = ((xyz >= 0) & (xyz <= 1)).all(-1).float().mean().item()
    depth_px = (b["gt_depth"] > 0).sum(dim=(-2, -1))[0].tolist()
    occ = torch.bincount(b["gt_occ"].reshape(-1).long().clamp(max=18), minlength=19)
    rec["first_batch"] = {"lidar_valid": int(b["lidar_valid"].sum()),
                          "lidar_in_grid_share": in_grid, "depth_pixels_per_camera": depth_px,
                          "occupied_voxels": int(occ[1:17].sum()),
                          "imgs": list(b["imgs"].shape)}
    check(b["lidar_valid"].sum() > 0 and in_grid == 1.0,
          f"data: LiDAR outside the grid ({in_grid} inside)")
    check(len(depth_px) == 6 and min(depth_px) > 0, f"data: depth per camera {depth_px}")
    check(rec["first_batch"]["occupied_voxels"] > 0, "data: no occupied voxel in the GT")

    syn_s = []

    def synthetic_steps():
        for _ in range(3):
            t = time.perf_counter()
            step(synthetic, g)
            torch.cuda.synchronize()
            syn_s.append(time.perf_counter() - t)

    torch.cuda.reset_peak_memory_stats()
    synthetic_steps()
    rec["train_synthetic"] = {"step_s": list(syn_s),
                              "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    del syn_s[:]
    rec["train_synthetic"]["profiled"] = dict(busy_share(synthetic_steps), step_s=syn_s)
    del model, opt, step, synthetic, seen
    free_memory()

    model = build_model(m, device="cuda", dtype=torch.float32, seed=0)
    eval_step = build_eval_step(model, tuple(cfg["occ_size"]), cfg["num_class"],
                                getattr(torch, cfg["compute_dtype"]))
    serving = make_serving_batch(cfg, seed=0)
    eval_step(serving)  # warm-up
    frames_ms, served, frame_waits_ms = [], [], []

    def pipeline_frames():  # the whole split: the loader's thread ends with it
        loader = build_dataloader(test_ds, samples_per_gpu=1, shuffle=False,
                                  max_points=max_points)
        it = iter(prefetch_to_device(loader, torch.device("cuda"),
                                     skip_keys=("_meta", "gt_occ")))
        while True:
            t = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                return
            frame_waits_ms.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            out = eval_step(batch)
            torch.cuda.synchronize()
            frames_ms.append((time.perf_counter() - t) * 1e3)
            served.append({k: out[k] for k in ("confusion", "voxel_pred")})

    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # the pipeline-fed serving path starts here
    pipeline_frames()
    n_serve = launches()  # ... and ends here
    rec["serve_pipeline"] = {"frames": len(frames_ms), "frame_ms": list(frames_ms),
                             "batch_wait_ms": list(frame_waits_ms), "launches": n_serve,
                             "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    n_frames = len(frames_ms)
    del frames_ms[:], frame_waits_ms[:]
    rec["serve_pipeline"]["profiled_split"] = dict(busy_share(pipeline_frames),
                                                   frame_ms=frames_ms,
                                                   batch_wait_ms=frame_waits_ms)
    check(n_frames == 8 and n_serve == {k: v * 8 for k, v in SERVE_LAUNCHES.items()},
          f"data: pipeline-fed serve launches {n_serve} in {n_frames} frames")
    for out in served:
        check(int(out["confusion"].sum()) > 0 and int(out["voxel_pred"].max()) < cfg["num_class"],
              "data: a served frame's confusion or voxel labels are wrong")
    syn_ms = []

    def synthetic_frames():
        for _ in range(3):
            t = time.perf_counter()
            eval_step(serving)
            torch.cuda.synchronize()
            syn_ms.append((time.perf_counter() - t) * 1e3)

    torch.cuda.reset_peak_memory_stats()
    synthetic_frames()
    rec["serve_synthetic"] = {"frame_ms": list(syn_ms),
                              "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    del syn_ms[:]
    rec["serve_synthetic"]["profiled"] = dict(busy_share(synthetic_frames), frame_ms=syn_ms)
    del model, eval_step, served
    free_memory()
    emit(rec)
    return rec, ann


def phase_cli():
    """The train and test CLIs at the flagship's full width and depth, as
    subprocesses in a temporary work directory that is deleted afterwards,
    on SyntheticOccDataset (6 cameras at 256x704, 17 classes, 35000 LiDAR
    points, 4 samples): tools.train to step 2 and tools.test on step_2 over
    2 samples; between them, step_2 is loaded in process into a fresh model
    and optimizer on the card and every tensor held bit-equal to the saved
    file, and the load and a save of that state are timed.  The CLIs on the
    config's own CustomNuScenesOccLSSDataset, and the train CLI's resume,
    run in the resume phase."""
    import torch

    from occformer_tpu_torch.config import load_config
    from occformer_tpu_torch.engine.checkpoint import (
        load_checkpoint,
        read_checkpoint,
        save_checkpoint,
    )
    from occformer_tpu_torch.engine.optim import build_optimizer_from_config
    from occformer_tpu_torch.models.detector import build_model

    data = dict(type="SyntheticOccDataset", num_samples=4, num_cams=6, input_size=[256, 704],
                num_classes=17, num_lidar_points=35000)
    opts = [f"data.{split}.{k}={v!r}".replace(" ", "") for split in ("train", "val", "test")
            for k, v in data.items()] + ["log_config.interval=1"]
    work = tempfile.mkdtemp(prefix="occformer_cli_")
    rec = {"phase": "cli", "config": "occformer_nusc_r50_256x704", "cfg_options": opts}

    def run(module, *args):
        return cli_run(module, *args, options=opts)

    try:
        ckpts = os.path.join(work, "ckpts")
        out1, logs1, rec["train_to_2_s"] = run("train", "--work-dir", work, "--max-steps", "2")
        check("training done at step 2" in out1, f"train to step 2:\n{out1[-2000:]}")
        step2 = os.path.join(ckpts, "step_2")
        rec["checkpoint_bytes"] = os.path.getsize(os.path.join(step2, "state.pt"))

        saved = read_checkpoint(step2)
        cfg = load_config(CONFIG)
        model = build_model(cfg["model"], device="cuda", dtype=torch.float32, seed=1)
        opt = build_optimizer_from_config(model, cfg, 4)
        torch.cuda.synchronize()
        t = time.perf_counter()
        step = load_checkpoint(step2, model, opt)
        torch.cuda.synchronize()
        rec["load_s"] = time.perf_counter() - t
        check(step == 2, f"step_2 holds step {step}")
        differ = [k for k, v in saved["model"].items()
                  if not torch.equal(model.state_dict()[k].cpu(), v)]
        o_saved, o_got = saved["optimizer"], opt.state_dict()
        n_opt = 0
        for i, st in o_saved["adamw"]["state"].items():
            for k, v in st.items():
                n_opt += 1
                if not torch.equal(o_got["adamw"]["state"][i][k].cpu(), v):
                    differ.append(f"optimizer {i}.{k}")
        check(not differ and o_got["step_count"] == o_saved["step_count"] == 2,
              f"step_2 reload differs: {differ[:10]}")
        rec["reload_bit_equal"] = {"model_tensors": len(saved["model"]),
                                   "optimizer_tensors": n_opt,
                                   "params": sum(p.numel() for p in model.parameters())}
        t = time.perf_counter()
        save_checkpoint(os.path.join(work, "save_timing"), model, opt, 2)
        rec["save_s"] = time.perf_counter() - t
        rec["fused"] = fused_frame(cfg, model, step2, os.path.join(work, "fused", "step_2"))
        del saved, model, opt, o_got
        free_memory()

        steps = [ln for ln in logs1 if "step" in ln]
        check([ln["step"] for ln in steps] == [1, 2], f"steps {[ln['step'] for ln in steps]}")
        for ln in steps:
            check(all(v == v and abs(v) != float("inf") for k, v in ln.items()
                      if k not in ("point_mean_iou", "epoch")), f"non-finite train log {ln}")
        rec["sec_per_iter"] = [ln["sec/iter"] for ln in steps]
        rec["total_loss"] = [ln["total_loss"] for ln in steps]
        rec["train_launches"] = [ln["kernel_launches"] for ln in logs1
                                 if "kernel_launches" in ln]
        check(all(n[k] > 0 for n in rec["train_launches"]
                  for k in ("K1", "K1-bwd", "K2", "K2-bwd", "K4", "K4-bwd", "S1", "S1-bwd")),
              f"train CLI launches {rec['train_launches']}")

        out3, logs3, rec["test_s"] = run("test", "--checkpoint", step2, "--max-samples", "2")
        timing, results = logs3[0], logs3[-1]
        rec["test_sec_per_sample"] = timing["sec/sample"]
        rec["test_launches"] = timing["kernel_launches"]
        rec["test_results"] = results
        check(timing["samples"] == 2 and timing["kernel_launches"]["K1"] == 2 * 6
              and timing["kernel_launches"]["K4"] == 2, f"test CLI: {timing}")
        mean = results.get("nuScenes_lidarseg_mean")
        check(mean is not None and 0.0 <= mean <= 1.0, f"test CLI results {results}")

    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit(rec)
    return rec


def fused_frame(cfg, model, step_dir, fused_dir):
    """``tools/fuse_conv_bn.py`` on the train CLI's checkpoint: the fused
    checkpoint loaded strictly into a fresh model serves one flagship frame
    in float32 (no autocast, no TF32), held to ``model``'s (the unfused
    checkpoint's) frame within 1e-4 relative."""
    import torch

    from occformer_tpu_torch.data.synthetic import make_serving_batch
    from occformer_tpu_torch.engine.checkpoint import load_checkpoint
    from occformer_tpu_torch.models.detector import build_model
    from occformer_tpu_torch.tools.fuse_conv_bn import fuse_checkpoint

    t = time.perf_counter()
    report = fuse_checkpoint(cfg, step_dir, fused_dir)
    rec = {"fuse_s": time.perf_counter() - t, "fused_pairs": report["fused_pairs"],
           "unpaired_convs": len(report["unpaired_convs"])}
    fused = build_model(cfg["model"], device="cuda", dtype=torch.float32, seed=2)
    check(load_checkpoint(fused_dir, fused) == 2, "fused checkpoint step")
    frame = {k: torch.as_tensor(v).cuda() for k, v in make_serving_batch(cfg, seed=0).items()}
    model.eval()
    with torch.no_grad():
        ref, got = model(frame), fused(frame)
    rec["outputs"] = {k: compare(got[k], ref[k], 1e-4, f"fused {k}")
                      for k in ("cls_preds", "mask_embeds", "mask_feature", "depth_prob")}
    del fused, ref, got
    return rec


def same_metrics(a, b):
    """Two dicts of metrics equal bit for bit (a NaN equal to a NaN: the
    point mIoU of a batch in which no class was predicted)."""
    return a.keys() == b.keys() and all(
        a[k] == b[k] or (a[k] != a[k] and b[k] != b[k]) for k in a)


def cli_runs(*runs, timeout=600):
    """CLI commands side by side, each ``(module, args, options, config)``:
    ``python3 -m occformer_tpu_torch.tools.<module> config *args
    --cfg-options *options`` from the repo.  Once all have ended (one still
    running at ``timeout`` is killed): per command (stdout, its JSON lines,
    the seconds it took); a non-zero exit fails the run."""
    from concurrent.futures import ThreadPoolExecutor

    t = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", f"occformer_tpu_torch.tools.{module}",
                               config, *args, "--cfg-options", *options], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for module, args, options, config in runs]

    def wait(p):
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        return out, err, time.perf_counter() - t

    with ThreadPoolExecutor(len(procs)) as pool:
        ended = list(pool.map(wait, procs))
    results = []
    for (module, args, _, _), p, (out, err, seconds) in zip(runs, procs, ended):
        check(p.returncode == 0, f"tools.{module} {' '.join(args)} exited {p.returncode}:\n"
              f"{out[-3000:]}\n{err[-3000:]}")
        results.append((out, [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")],
                        seconds))
    return results


def cli_run(module, *args, options=(), timeout=600, config=CONFIG):
    """One command of ``cli_runs``: (stdout, its JSON lines, seconds)."""
    return cli_runs((module, args, options, config), timeout=timeout)[0]


def phase_resume(nusc_root, nusc_ann):
    """A resumed train CLI run repeats the uninterrupted one (ROADMAP C.9,
    C.10), at the flagship's full width on the config's own
    CustomNuScenesOccLSSDataset over the data phase's nuScenes tree (only
    data_root, ann_file and the annotation step's data_root set by
    --cfg-options; 8 samples: an epoch of 8 steps, the train pipeline's
    augmentation drawn per sample): tools.train to step 6 in one go, and to
    step 3 then resumed to step 6 (mid-epoch: the resumed epoch skips its
    first 3 batches without building them).  Every logged loss and metric
    of steps 1-6 (grad_norm among them) must be equal, bit for bit.  Then
    tools.test on the uninterrupted run's step_6 over 2 samples of
    data.val, whose IoU table names the classes, and one skipped-batch
    restart timed in process: the loader's first batch of the epoch from
    batch 0 and from batch 3 (no skipped sample is built)."""
    from occformer_tpu_torch.config import load_config, parse_cfg_options
    from occformer_tpu_torch.data.fixtures import nuscenes_cfg_options
    from occformer_tpu_torch.data.loader import build_dataloader, build_dataset

    cfg = load_config(CONFIG)
    opts = nuscenes_cfg_options(cfg, nusc_root, nusc_ann) + ["log_config.interval=1"]
    work = tempfile.mkdtemp(prefix="occformer_resume_")
    rec = {"phase": "resume", "config": "occformer_nusc_r50_256x704", "samples": 8,
           "stop_at": 3, "resume_to": 6}

    def steps(lines):
        return {ln["step"]: {k: v for k, v in ln.items() if k not in ("step", "sec/iter")}
                for ln in lines if "step" in ln}

    try:
        split = os.path.join(work, "split")
        # side by side: the run to 6 and the run to 3; then the resumed run
        # beside the test of the first run's step_6
        (out_w, lines_w, rec["whole_s"]), (out_a, lines_a, rec["to_3_s"]) = cli_runs(
            ("train", ("--work-dir", os.path.join(work, "whole"), "--max-steps", "6"), opts,
             CONFIG),
            ("train", ("--work-dir", split, "--max-steps", "3"), opts, CONFIG))
        (out_b, lines_b, rec["resumed_3_to_6_s"]), (out_t, lines_t, rec["test_s"]) = cli_runs(
            ("train", ("--work-dir", split, "--max-steps", "6"), opts, CONFIG),
            ("test", ("--checkpoint", os.path.join(work, "whole", "ckpts", "step_6"),
                      "--max-samples", "2"), opts, CONFIG))
        check("at step 3 (epoch 0 from batch 3)" in out_b, f"resume:\n{out_b[-2000:]}")
        whole, resumed = steps(lines_w), {**steps(lines_a), **steps(lines_b)}
        check(sorted(whole) == sorted(resumed) == [1, 2, 3, 4, 5, 6],
              f"steps {sorted(whole)} / {sorted(resumed)}")
        differ = {k: [n for n in whole[k] if not same_metrics({n: whole[k][n]},
                                                               {n: resumed[k].get(n)})]
                  for k in whole}
        rec["total_loss"] = [whole[k]["total_loss"] for k in sorted(whole)]
        rec["grad_norm"] = [whole[k]["grad_norm"] for k in sorted(whole)]
        rec["differing"] = {k: v for k, v in differ.items() if v}
        check(not rec["differing"], f"the resumed run differs from the uninterrupted one: "
              f"{rec['differing']}")
        rec["sec_per_iter_whole"] = [ln["sec/iter"] for ln in lines_w if "step" in ln]
        rec["sec_per_iter_resumed"] = [ln["sec/iter"] for ln in lines_b if "step" in ln]
        rec["launches"] = [ln["kernel_launches"] for ln in lines_w + lines_a + lines_b
                           if "kernel_launches" in ln]
        check(all(n[k] > 0 for n in rec["launches"]
                  for k in ("K1", "K1-bwd", "K2", "K2-bwd", "K4", "K4-bwd", "S1", "S1-bwd")),
              f"train CLI launches {rec['launches']}")

        timing, results = lines_t[0], lines_t[-1]
        rec["test_sec_per_sample"] = timing["sec/sample"]
        rec["test_launches"] = timing["kernel_launches"]
        rec["test_results"] = results
        check(timing["samples"] == 2 and timing["kernel_launches"]["K1"] == 2 * 6
              and timing["kernel_launches"]["K4"] == 2, f"nuScenes test CLI: {timing}")
        names = [f"nuScenes_lidarseg_{c}" for c in cfg["class_names"][1:]]
        check(all(k in results for k in names) and 0.0 <= results["nuScenes_lidarseg_mean"] <= 1.0
              and all(f"| {k} |" in out_t for k in names),
              f"nuScenes test CLI: the per-class IoU table {results}\n{out_t[-2000:]}")

        train_cfg = dict(load_config(CONFIG, parse_cfg_options(opts))["data"]["train"])
        loader = build_dataloader(build_dataset(train_cfg), seed=0,
                                  max_points=cfg["max_lidar_points"])
        first_batch_s = {}
        for start in (0, 3):
            loader.set_epoch(0, start)
            t = time.perf_counter()
            it = iter(loader)
            next(it)
            first_batch_s[start] = time.perf_counter() - t
            for _ in it:  # drain: the producer thread ends with the epoch
                pass
        rec["first_batch_s"] = {"from_batch_0": first_batch_s[0],
                                "from_batch_3": first_batch_s[3]}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit(rec)
    total = dict(_NONE)
    for n in rec["launches"]:
        total = {k: total[k] + n.get(k, 0) for k in total}
    return total


# ---------------------------------------------------------------------------
# SemanticKITTI (occformer_kitti): EfficientNet-B7, one camera, the grid loss
# ---------------------------------------------------------------------------

def kitti_cfg(tree):
    """The occformer_kitti config pointed at a tree of
    ``data/fixtures.py:make_kitti_tree``."""
    from occformer_tpu_torch.config import load_config, parse_cfg_options
    from occformer_tpu_torch.data.fixtures import kitti_cfg_options

    return load_config(KITTI_CONFIG, parse_cfg_options(kitti_cfg_options(tree)))


def kitti_batches(cfg, split):
    """The split's batches of the tree, in order (test mode for val), host
    keys dropped."""
    from occformer_tpu_torch.data.loader import build_dataloader, build_dataset

    train = split == "train"
    out = []
    for b in build_dataloader(build_dataset(cfg["data"][split], test_mode=not train),
                              shuffle=train, seed=0):
        b.pop("_meta")
        out.append(b)
    return out


def phase_kitti_kernels(tree):
    """Every kernel of the SemanticKITTI path held against its plain version
    at the shapes that path gives it, and timed (CUDA events, median of 30;
    the profiler's device time beside), with its bound and the one PyTorch
    call that computes the same function:

    * K1 / K1-bwd: the pixel decoder's pyramid, the occupancy encoder's three
      coarsest scales of the 128 x 128 x 16 LSS volume, which is the
      flagship's: (16, 16, 2), (32, 32, 4), (64, 64, 8), bf16 (checked
      equal, then held and timed here at it);
    * K2 at C = 100: the matching readout, the [1, 128, 128, 16, 100]
      float32 query volume at 50176 GT voxels of the 256 x 256 x 32 grid,
      ``idx / (size - 1)``, align_corners=True, zeros (the row-wide path);
    * K2 at C = 1: the 20 slot volumes [20, 128, 128, 16, 1] at 150528
      candidates each (the narrow path);
    * K2-bwd narrow: the supervision's 50176 points a slot, d_table against
      the plain version's autograd, two calls bit-equal;
    * K4 / K4-bwd: the DepthNet DCN on one camera, [1, 512, 24, 80]
      (``phase_k4_dcn``);
    * S1: the LSS splat at the tree's camera (P2 and Tr of a KITTI
      sequence) over the 112 x 24 x 80 frustum, bf16 depth and context.
    Tolerances relative to max |plain|: float32 1e-5 forward and 1e-4
    backward, bf16 1e-2."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from occformer_tpu_torch.losses.point_sampling import voxel_points
    from occformer_tpu_torch.ops import trilerp as k2
    from occformer_tpu_torch.ops import trilerp_fused as k1
    from occformer_tpu_torch.ops.geometry import (compute_voxel_coords, create_frustum,
                                                  gen_dx_bx, get_geometry)
    from occformer_tpu_torch.tools.time_backwards import flagship_gather_inputs

    cfg = kitti_cfg(tree)
    m = cfg["model"]
    vt = m["img_view_transformer"]
    gc = vt["grid_config"]
    _, _, nx = gen_dx_bx(gc["xbound"], gc["ybound"], gc["zbound"])
    nx = tuple(int(n) for n in nx)
    enc = m["img_bev_encoder_backbone"]
    scales, size = [], np.asarray(nx)
    for stride in enc["block_strides"]:
        size = size // stride
        scales.append(tuple(int(v) for v in size))
    levels = sorted(scales[-m["img_bev_encoder_neck"]["encoder"]["transformerlayers"][
        "attn_cfgs"]["num_levels"]:])
    rec = {"phase": "kitti_kernels", "config": "occformer_kitti", "lss_grid": nx,
           "pixel_decoder_levels": levels}

    # K1 and K1-bwd at the pixel decoder's pyramid
    value, shapes, locs, w = flagship_gather_inputs(torch.bfloat16, local=False)
    check(sorted(tuple(s) for s in shapes) == levels,
          f"K1: the KITTI levels {levels} are not {shapes}")
    got = k1.ms_deform_gather_3d(value, shapes, locs, w)
    r = compare(got, k1.ms_deform_gather_3d_plain(value.float(), shapes, locs, w.float()),
                1e-2, "K1 KITTI")
    B, Nq, H, L, P = w.shape
    hd = value.shape[-1]
    r.update(kernel_ms=time_cuda(lambda: k1.ms_deform_gather_3d(value, shapes, locs, w)),
             device_ms=device_ms(lambda: k1.ms_deform_gather_3d(value, shapes, locs, w)),
             plain_ms=time_cuda(lambda: k1.ms_deform_gather_3d_plain(value, shapes, locs, w),
                                iters=20), library_ms=None)
    r.update(bound(nbytes(value, locs, w, got), B * Nq * H * L * P * hd * 8 * 2))
    rec["K1"] = r
    gout = torch.randn(got.shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(1)).to(torch.bfloat16)
    k_leaves = [t.detach().clone().requires_grad_(True) for t in (value, locs, w)]
    k1.ms_deform_gather_3d(k_leaves[0], shapes, k_leaves[1], k_leaves[2]).backward(gout)
    leaves = [t.detach().float().requires_grad_(True) for t in (value, locs, w)]
    refs = torch.autograd.grad(k1.ms_deform_gather_3d_plain(leaves[0], shapes, leaves[1],
                                                            leaves[2]), leaves, gout.float())
    again = k1._launch_bwd(value, shapes, locs, w, gout)
    rb = {}
    for name, a, b, c in zip(("d_value", "d_locs", "d_weights"), k_leaves, refs, again):
        rb[name] = compare(a.grad, b, 1e-2, f"K1-bwd KITTI {name}")
        check(torch.equal(a.grad, c), f"K1-bwd KITTI {name}: two calls differ")
    rb["max_abs_err"] = max(v["max_abs_err"] for v in rb.values())
    rb["kernel_ms"] = time_cuda(lambda: k1._launch_bwd(value, shapes, locs, w, gout))
    rb["device_ms"] = device_ms(lambda: k1._launch_bwd(value, shapes, locs, w, gout))
    p_out = k1.ms_deform_gather_3d_plain(leaves[0], shapes, leaves[1], leaves[2])
    rb["plain_ms"] = time_cuda(lambda: torch.autograd.grad(p_out, leaves, gout.float(),
                                                           retain_graph=True), iters=10)
    rb["library_ms"] = None
    rb.update(bound(nbytes(value, locs, w, gout, value, locs, w),
                    B * Nq * H * L * P * hd * 8 * 4))
    rec["K1-bwd"] = rb
    del value, locs, w, got, gout, k_leaves, leaves, refs, again, p_out
    free_memory()

    # K2 on the grid loss's readouts (align_corners=True, zeros)
    g = torch.Generator(device="cuda").manual_seed(21)
    X, Y, Z = nx
    gt = tuple(cfg["occ_size"])
    tl = m["train_cfg"]["pts"]
    n_match, n_cand = tl["num_points"], int(tl["num_points"] * tl["oversample_ratio"])
    Q, G = m["pts_bbox_head"]["num_queries"], m["pts_bbox_head"]["num_occupancy_classes"]

    def gt_coords(rows, n):
        idx = torch.randint(0, int(np.prod(gt)), (rows, n), device="cuda", generator=g)
        return (voxel_points(idx, gt) * 2.0 - 1.0).contiguous()

    def k2_record(table, coords, name, path):
        check(k2.fwd_path(table.shape, table.dtype, table.data_ptr()) == path,
              f"K2 {name}: not the {path} path")
        got = k2.trilerp_sample(table, coords, True, "zeros")
        r = compare(got, k2.trilerp_sample_plain(table, coords, True, "zeros"), 1e-5,
                    f"K2 {name}")
        vol = table.permute(0, 4, 1, 2, 3).contiguous()  # the library call's layout
        grid = coords.flip(-1).reshape(coords.shape[0], -1, 1, 1, 3)

        def library():
            return F.grid_sample(vol, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=True)

        r.update(path=path, table=list(table.shape), points=list(coords.shape),
                 kernel_ms=time_cuda(lambda: k2.trilerp_sample(table, coords, True, "zeros")),
                 device_ms=device_ms(lambda: k2.trilerp_sample(table, coords, True, "zeros")),
                 plain_ms=time_cuda(lambda: k2.trilerp_sample_plain(table, coords, True,
                                                                    "zeros"), iters=10),
                 library_ms=time_cuda(library), library_device_ms=device_ms(library))
        r.update(bound(nbytes(table, coords, got),
                       coords.shape[0] * coords.shape[1] * table.shape[-1] * 8 * 2))
        return r

    q_vol = torch.randn((1, X, Y, Z, Q), device="cuda", generator=g)
    rec["K2_matching"] = k2_record(q_vol, gt_coords(1, n_match), "KITTI matching C=100", "row")
    del q_vol
    slots = torch.randn((G, X, Y, Z, 1), device="cuda", generator=g)
    rec["K2_candidates"] = k2_record(slots, gt_coords(G, n_cand), "KITTI candidates C=1",
                                     "scalar")
    # the supervision points: K2 and K2-bwd's narrow path through the autograd
    # Function the loss runs
    coords = gt_coords(G, n_match)
    check(k2.bwd_path(slots.shape, n_match) == "narrow", "K2-bwd KITTI: not the narrow path")
    leaf = slots.detach().clone().requires_grad_(True)
    out = k2.trilerp_sample(leaf, coords, True, "zeros")
    gout = torch.randn(out.shape, device="cuda", generator=g)
    out.backward(gout)
    pl = slots.detach().clone().requires_grad_(True)
    p_out = k2.trilerp_sample_plain(pl, coords, True, "zeros")
    (ref,) = torch.autograd.grad(p_out, (pl,), gout, retain_graph=True)
    rb = compare(leaf.grad, ref, 1e-4, "K2-bwd KITTI supervision")
    a, _ = k2._launch_bwd(slots, coords, gout, True, "zeros", want_coords=False)
    b, _ = k2._launch_bwd(slots, coords, gout, True, "zeros", want_coords=False)
    check(torch.equal(a, b) and torch.equal(a, leaf.grad), "K2-bwd KITTI: two calls differ")
    vl = slots.permute(0, 4, 1, 2, 3).contiguous().requires_grad_(True)
    lib_out = F.grid_sample(vl, coords.flip(-1).reshape(G, -1, 1, 1, 3), mode="bilinear",
                            padding_mode="zeros", align_corners=True)
    lib_gout = gout.reshape(G, -1, 1).permute(0, 2, 1).reshape(lib_out.shape).contiguous()
    rb.update(path="narrow", table=list(slots.shape), points=list(coords.shape),
              bit_identical_calls=True,
              kernel_ms=time_cuda(lambda: k2._launch_bwd(slots, coords, gout, True, "zeros",
                                                         want_coords=False)),
              device_ms=device_ms(lambda: k2._launch_bwd(slots, coords, gout, True, "zeros",
                                                         want_coords=False)),
              plain_ms=time_cuda(lambda: torch.autograd.grad(p_out, (pl,), gout,
                                                             retain_graph=True), iters=10),
              library_ms=time_cuda(lambda: torch.autograd.grad(lib_out, (vl,), lib_gout,
                                                               retain_graph=True), iters=10))
    rb.update(bound(nbytes(gout, coords, slots), G * n_match * 8 * 2))
    rec["K2-bwd"] = rb
    del slots, coords, leaf, out, gout, pl, p_out, ref, a, b, vl, lib_out, lib_gout
    free_memory()

    # K4 and K4-bwd at the DepthNet DCN of one camera
    dcn = phase_k4_dcn(KITTI_DCN_SHAPE)
    rec["K4"], rec["K4-bwd"] = dcn.pop("K4"), dcn.pop("K4-bwd")
    rec["K4_dcn"] = dcn
    free_memory()

    # S1 at the tree's camera (a val frame: no augmentation)
    frame = kitti_batches(cfg, "val")[0]
    cams = [torch.from_numpy(frame[k]).cuda()
            for k in ("rots", "trans", "intrins", "post_rots", "post_trans", "bda")]
    frustum = create_frustum(gc, tuple(vt["data_config"]["input_size"]), 16)
    dx, bx, _ = gen_dx_bx(gc["xbound"], gc["ybound"], gc["zbound"])
    coords, valid = compute_voxel_coords(
        get_geometry(torch.from_numpy(frustum).cuda(), *cams), dx, bx, nx)
    D, fH, fW = frustum.shape[:3]
    depth = torch.softmax(torch.randn((1, 1, D, fH, fW), device="cuda", generator=g), 2)
    ctx = torch.randn((1, 1, fH, fW, vt["numC_Trans"]), device="cuda", generator=g)
    rec["S1"] = dict(s1_check(depth.to(torch.bfloat16), ctx.to(torch.bfloat16), coords, valid,
                              nx, "kitti camera"),
                     geometry="data/fixtures.py:KITTI_P2, KITTI_TR (a val frame)")
    emit(rec)
    return rec


def kitti_reload_pairs(model, opt, step, batch, n_pairs=2):
    """Pairs of KITTI train steps from one reloaded state (model and
    optimizer), one step seed, on the port's default settings: every loss,
    grad_norm and every parameter's gradient before the clip compared bit
    for bit (``phase_determinism``'s check, on the KITTI step).  Where a
    pair differs, the convolutions whose gradients differed are replayed at
    their step's inputs (``backward_repeats``) to name the ones whose
    backward varies."""
    import copy

    import torch

    state = copy.deepcopy((model.state_dict(), opt.state_dict()))
    names = [k for k, _ in model.named_parameters()]

    def run():
        model.load_state_dict(state[0])
        opt.load_state_dict(state[1])
        grads = []

        def opt_step():
            grads.extend(None if p.grad is None else p.grad.detach().clone()
                         for p in model.parameters())
            return type(opt).step(opt)

        opt.step = opt_step
        try:
            metrics = step(batch, torch.Generator(device="cuda").manual_seed(1))
        finally:
            del opt.step
        return {k: float(v) for k, v in metrics.items()}, grads

    rec = {"pairs": n_pairs, "losses_differ": 0, "grad_norm_differs": 0,
           "param_grads_differ": 0, "param_grads": 0}
    differing = set()
    for _ in range(n_pairs):
        (ma, ga), (mb, gb) = run(), run()
        rec["losses_differ"] += any(ma[k] != mb[k] for k in ma if "loss" in k)
        rec["grad_norm_differs"] += ma["grad_norm"] != mb["grad_norm"]
        pair = {k for k, a, b in zip(names, ga, gb) if a is not None and not torch.equal(a, b)}
        rec["param_grads_differ"] += len(pair)
        rec["param_grads"] = sum(a is not None for a in ga)
        differing |= pair
        del ga, gb
    rec["param_grads_differing"] = sorted(differing)[:40]
    if differing:
        rec["modules"] = varying_convolutions(model, differing, run)
    return rec


def varying_convolutions(model, differing, run):
    """The convolutions of ``model`` that own the ``differing`` parameters,
    their inputs captured during one more ``run()``, replayed there by
    ``backward_repeats`` to name those whose backward varies."""
    import torch

    owners = {k.rsplit(".", 1)[0] for k in differing}
    convs, hooks = {}, []
    for name, mod in model.named_modules():
        if name in owners and isinstance(mod, (torch.nn.Conv2d, torch.nn.Conv3d,
                                               torch.nn.ConvTranspose2d)):
            def keep(mod, args, kwargs, name=name):
                if name not in convs:
                    convs[name] = (mod, [a.detach().clone().requires_grad_(a.requires_grad)
                                         if torch.is_tensor(a) else a for a in args],
                                   dict(kwargs),
                                   torch.get_autocast_dtype("cuda")
                                   if torch.is_autocast_enabled("cuda") else None)
            hooks.append(mod.register_forward_pre_hook(keep, with_kwargs=True))
    run()
    for h in hooks:
        h.remove()
    return backward_repeats(convs)


def main_path_run(name, call, items, per_call, n):
    """The main path's run of a serving or training phase: ``n`` calls of
    ``call(item)`` over ``items`` in turn (the first a warm-up), each
    synchronised and timed.  The launch counts are set to 0 just before the
    run and read just after, and must be ``per_call`` times ``n``.  Returns
    (the seconds of each call, the launches, the peak bytes, the resident
    bytes at the start, the outputs)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    secs, outs = [], []
    reset_launches()  # the main path's run starts here
    for i in range(n):
        t = time.perf_counter()
        outs.append(call(items[i % len(items)]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    got = launches()  # ... and ends here
    want = {k: v * n for k, v in per_call.items()}
    check(got == want, f"{name} launches {got} in {n} calls, want {want}")
    return secs, got, torch.cuda.max_memory_allocated(), resident, outs


def serve_phase(name, config, cfg, frames, per_frame, panoptic=False, forbid=()):
    """A configuration served at full width and depth: its model (random
    weights from a seeded torch.Generator, float32 parameters under the
    config's autocast) through ``build_eval_step(..., panoptic)``, 4 frames
    over ``frames`` (``main_path_run``; the first a warm-up: ms a frame, the
    peak, the launches), every output of the model finite on the first
    frame, and a profiled frame.  Returns (the record, the model, the step,
    the outputs)."""
    import torch

    from occformer_tpu_torch.engine.eval import build_eval_step
    from occformer_tpu_torch.models.detector import build_model

    dtype = getattr(torch, cfg["compute_dtype"])
    t0 = time.perf_counter()
    model = build_model(cfg["model"], device="cuda", dtype=torch.float32, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    step = build_eval_step(model, tuple(cfg["occ_size"]), cfg["num_class"], dtype,
                           panoptic=panoptic)
    secs, n, peak, resident, outs = main_path_run(name, step, frames, per_frame, 4)
    with torch.inference_mode(), torch.autocast("cuda", dtype=dtype):
        raw = model({k: torch.as_tensor(v).cuda() for k, v in frames[0].items()})
    finite = {k: bool(torch.isfinite(v.float()).all()) for k, v in raw.items()}
    check(all(finite.values()), f"{name}: non-finite outputs {finite}")
    rec = {"phase": name, "config": config, "param_dtype": "float32",
           "autocast": cfg["compute_dtype"], "model_build_s": build_s,
           "params": sum(p.numel() for p in model.parameters()),
           "warmup_frame_ms": secs[0] * 1e3, "frame_ms": [s * 1e3 for s in secs[1:]],
           "frames_run": len(secs), "launches": n, "peak_memory_bytes": peak,
           "resident_bytes_at_start": resident, "finite": finite,
           "shapes": {k: list(v.shape) for k, v in raw.items()}}
    del raw
    rec["profile"] = profile(lambda: step(frames[0]), SERVE_STAGES, per_frame, forbid=forbid)
    rec["analytic"] = analytic_serve(name, model, frames[0], dtype, rec["frame_ms"])
    return rec, model, step, outs


def train_phase(name, step, batches, per_step, steps, generator):
    """``steps`` train steps over ``batches`` (``main_path_run``; the first a
    warm-up), every metric finite but the point mIoU (NaN where no class
    was predicted).  Returns the record's part of them."""
    secs, n, peak, resident, outs = main_path_run(name, lambda b: step(b, generator),
                                                  batches, per_step, steps)
    history = [{k: float(v) for k, v in m.items()} for m in outs]
    for h in history:
        check(all(v == v and abs(v) != float("inf") for k, v in h.items()
                  if k != "point_mean_iou"), f"{name}: non-finite metrics {h}")
    return {"warmup_step_s": secs[0], "step_s": secs[1:], "steps_run": len(secs),
            "launches": n, "peak_memory_bytes": peak, "resident_bytes_at_start": resident,
            "metrics": history}


def profile_and_reload(rec, name, model, opt, step, batch, per_step, generator, forbid=()):
    """A profiled step, then one reloaded pair (``kitti_reload_pairs``) on
    the port's default settings (cuDNN's TF32 on, no global deterministic
    mode), which must repeat every loss, grad_norm and gradient."""
    import torch

    rec["profile"] = profile(lambda: step(batch, generator), TRAIN_STAGES, per_step,
                             forbid=forbid)
    free_memory()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # the port's default settings
    check(not torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
          and not torch.are_deterministic_algorithms_enabled(),
          f"{name} reload: a global determinism switch is on")
    try:
        rec["reload_determinism"] = r = kitti_reload_pairs(model, opt, step, batch, n_pairs=1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    check(r["losses_differ"] == r["grad_norm_differs"] == r["param_grads_differ"] == 0
          and r["param_grads"] > 0, f"{name} reload_determinism: the pair differs: {r}")
    rec["analytic"] = analytic_train(f"{name}_train", step, batch, generator, rec["step_s"],
                                     model, opt)


def phase_kitti_serve(tree):
    """The SemanticKITTI config at full width (EfficientNet-B7 at 384 x 1280,
    the 128 x 128 x 16 grid, 100 queries, 9 decoder layers) served over the
    tree's two val frames (``serve_phase``): ``voxel_pred`` [1, 256, 256,
    32] uint8."""
    import torch

    cfg = kitti_cfg(tree)
    frames = kitti_batches(cfg, "val")
    for f in frames:
        f.pop("gt_occ")
    rec, _, _, outs = serve_phase("kitti_serve", "occformer_kitti", cfg, frames,
                                  KITTI_SERVE_LAUNCHES)
    vp = outs[-1]["voxel_pred"]
    check(list(vp.shape) == [1, *cfg["occ_size"]] and vp.dtype == torch.uint8,
          f"kitti voxel_pred {list(vp.shape)} {vp.dtype}")
    check(int(vp.max()) < cfg["num_class"], "kitti: predicted labels out of range")
    rec.update(voxel_pred=list(vp.shape), classes_predicted=len(torch.unique(vp)))
    emit(rec)
    return rec["launches"]


def phase_kitti_train(tree):
    """The SemanticKITTI config's train step at full width with ``with_cp``
    on (the EfficientNet's and the occupancy encoder's recomputation), float32
    parameters under bf16 autocast, batch 1, on the tree's train frames
    through the pipeline: 4 steps (``train_phase``), the parameters moved,
    then ``profile_and_reload``."""
    import torch

    from occformer_tpu_torch.engine.optim import build_optimizer_from_config
    from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step
    from occformer_tpu_torch.models.detector import build_model

    cfg = kitti_cfg(tree)
    m = cfg["model"]
    t0 = time.perf_counter()
    model = build_model(m, device="cuda", dtype=torch.float32, seed=0).train()
    check(model.img_backbone.with_cp and model.img_bev_encoder_backbone.with_cp,
          "kitti_train: with_cp is off")
    loss_cfg = build_loss_cfg(m["pts_bbox_head"], m["train_cfg"]["pts"])
    check(not loss_cfg.use_lidar_points, "kitti_train: not the grid loss")
    opt = build_optimizer_from_config(model, cfg, 3834)  # SemanticKITTI's train frames
    step = build_train_step(model, opt, loss_cfg, device="cuda",
                            compute_dtype=getattr(torch, cfg["compute_dtype"]))
    batches = kitti_batches(cfg, "train")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    watch = {k: p.detach().clone() for k, p in model.named_parameters()
             if k in ("img_backbone.layers.0.conv.weight",
                      "img_backbone.layers.5.0.depthwise_conv.conv.weight",
                      "img_bev_encoder_neck.encoder.layers.0.attentions.0.value_proj.weight",
                      "pts_bbox_head.query_feat.weight")}
    g = torch.Generator(device="cuda").manual_seed(0)
    run = train_phase("kitti_train", step, batches, KITTI_TRAIN_LAUNCHES, 4, g)
    moved = {k: (p.detach() - watch[k]).abs().max().item()
             for k, p in model.named_parameters() if k in watch}
    check(len(moved) == 4 and all(v > 0 for v in moved.values()),
          f"kitti_train: parameters did not move: {moved}")
    rec = {"phase": "kitti_train", "config": "occformer_kitti", "param_dtype": "float32",
           "autocast": cfg["compute_dtype"], "with_cp": True,
           "params": sum(p.numel() for p in model.parameters()), "setup_s": setup_s, **run,
           "max_param_change": moved,
           "loss_points": {"matching": loss_cfg.num_match_points,
                           "candidates": loss_cfg.num_candidates,
                           "supervised": loss_cfg.num_points}}
    profile_and_reload(rec, "kitti", model, opt, step, batches[0], KITTI_TRAIN_LAUNCHES, g)
    emit(rec)
    return run["launches"]


def phase_kitti_cli(tree):
    """The train and test CLIs on the SemanticKITTI config at full width over
    the tree, as subprocesses in a temporary work directory: tools.train to
    step 2, then tools.test on step_2 over the val frames with
    ``--test-save``: its SSC metrics (``semkitti_SC_IoU``,
    ``semkitti_SSC_mIoU``) and a ``.label`` file per frame, read back by
    ``utils/semkitti_io.py``."""
    import numpy as np

    from occformer_tpu_torch.data.fixtures import kitti_cfg_options
    from occformer_tpu_torch.utils.semkitti_io import read_label_voxels

    opts = kitti_cfg_options(tree) + ["log_config.interval=1"]
    work = tempfile.mkdtemp(prefix="occformer_kitti_cli_")
    rec = {"phase": "kitti_cli", "config": "occformer_kitti", "cfg_options": opts}
    try:
        out1, logs1, rec["train_to_2_s"] = cli_run(
            "train", "--work-dir", work, "--max-steps", "2", options=opts, config=KITTI_CONFIG)
        check("training done at step 2" in out1, f"kitti train to step 2:\n{out1[-2000:]}")
        steps = [ln for ln in logs1 if "step" in ln]
        check([ln["step"] for ln in steps] == [1, 2], f"kitti steps {steps}")
        for ln in steps:
            check(all(v == v and abs(v) != float("inf") for k, v in ln.items() if k != "epoch"),
                  f"kitti train CLI: non-finite log {ln}")
        rec["sec_per_iter"] = [ln["sec/iter"] for ln in steps]
        rec["total_loss"] = [ln["total_loss"] for ln in steps]
        rec["train_launches"] = [ln["kernel_launches"] for ln in logs1 if "kernel_launches" in ln]
        check(all(n[k] > 0 for n in rec["train_launches"]
                  for k in ("K1", "K1-bwd", "K2", "K2-bwd", "K4", "K4-bwd", "S1", "S1-bwd")),
              f"kitti train CLI launches {rec['train_launches']}")
        save = os.path.join(work, "save")
        out2, logs2, rec["test_s"] = cli_run(
            "test", "--checkpoint", os.path.join(work, "ckpts", "step_2"), "--test-save", save,
            options=opts, config=KITTI_CONFIG)
        timing, results = logs2[0], logs2[-1]
        rec["test_sec_per_sample"] = timing["sec/sample"]
        rec["test_launches"] = timing["kernel_launches"]
        rec["test_results"] = results
        check(timing["samples"] == 2 and timing["kernel_launches"]["K1"] == 2 * 6,
              f"kitti test CLI: {timing}")
        for k in ("semkitti_SC_IoU", "semkitti_SSC_mIoU"):
            check(k in results and (results[k] != results[k] or 0.0 <= results[k] <= 1.0),
                  f"kitti test CLI results {results}")
        labels = sorted(os.listdir(os.path.join(save, "sequences", "08", "predictions")))
        check(labels == ["000000.label", "000001.label"], f"kitti submissions {labels}")
        vox = read_label_voxels(os.path.join(save, "sequences", "08", "predictions",
                                             labels[0]))
        check(vox.shape == (256, 256, 32) and int(vox.max()) < 20,
              f"kitti .label {vox.shape} max {int(vox.max())}")
        rec["label_classes"] = int(len(np.unique(vox)))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# R101-DCN 896x1600 (occformer_nusc_r101_896x1600): the caffe-style
# ResNet-101 with DCNv2 in layer3 / layer4, with_cp, the FCOS3D init
# ---------------------------------------------------------------------------

def r101_cfg(tree, ann, config=R101_CONFIG):
    """An R101-DCN config pointed at a tree of
    ``data/fixtures.py:make_nuscenes_tree``."""
    from occformer_tpu_torch.config import load_config, parse_cfg_options
    from occformer_tpu_torch.data.fixtures import nuscenes_cfg_options

    return load_config(config, parse_cfg_options(nuscenes_cfg_options(load_config(config),
                                                                      tree, ann)))


def r101_batches(cfg, split, n):
    """The first ``n`` batches of the split on the tree (test mode but for
    the train split), host keys dropped."""
    from occformer_tpu_torch.data.loader import build_dataloader, build_dataset

    train = split == "train"
    out = []
    for b in build_dataloader(build_dataset(cfg["data"][split], test_mode=not train),
                              shuffle=train, seed=0, max_points=cfg["max_lidar_points"]):
        b.pop("_meta")
        out.append(b)
        if len(out) == n:
            break
    return out


def phase_r101_kernels(tree, ann):
    """Every kernel the R101-DCN path runs at new shapes, held against its
    plain version and timed (CUDA events, median of 30; the profiler's
    device time beside), with its bound and the one PyTorch call that
    computes the same function:

    * K4 / K4-bwd as the deformable convolutions send them
      (``phase_k4_dcn``: bf16 1e-2, float32 1e-5 values and 1e-4 gradients,
      two K4-bwd calls bit-equal, ``F.grid_sample`` 2-D forward and its
      autograd beside): layer3's DCNv2 [6, 56*100, 256] (23 blocks), layer4's
      [6, 28*50, 512] (3 blocks) and the DepthNet's DCN [6, 56*100, 512];
    * S1 at the R101 frustum: 6 cameras x 112 depth bins x 56 x 100 =
      3,763,200 points, the geometry of the tree's first test frame (the
      nuScenes rig, no augmentation), bf16 depth and context (two calls
      bit-equal, one ``index_add_`` beside)."""
    import torch

    from occformer_tpu_torch.ops.geometry import (compute_voxel_coords, create_frustum,
                                                  gen_dx_bx, get_geometry)

    rec = {"phase": "r101_kernels", "config": "occformer_nusc_r101_896x1600"}
    for name, shape in R101_DCN_SHAPES.items():
        rec[f"K4_dcn_{name}"] = phase_k4_dcn(shape)
        free_memory()
    cfg = r101_cfg(tree, ann)
    vt = cfg["model"]["img_view_transformer"]
    gc = vt["grid_config"]
    dx, bx, nx = gen_dx_bx(gc["xbound"], gc["ybound"], gc["zbound"])
    nx = tuple(int(n) for n in nx)
    frame = r101_batches(cfg, "test", 1)[0]
    cams = [torch.from_numpy(frame[k]).cuda()
            for k in ("rots", "trans", "intrins", "post_rots", "post_trans", "bda")]
    frustum = create_frustum(gc, tuple(vt["data_config"]["input_size"]),
                             vt.get("downsample", 16))
    coords, valid = compute_voxel_coords(
        get_geometry(torch.from_numpy(frustum).cuda(), *cams), dx, bx, nx)
    D, fH, fW = frustum.shape[:3]
    N = cams[0].shape[1]
    g = torch.Generator(device="cuda").manual_seed(31)
    depth = torch.softmax(torch.randn((1, N, D, fH, fW), device="cuda", generator=g), 2)
    ctx = torch.randn((1, N, fH, fW, vt["numC_Trans"]), device="cuda", generator=g)
    check(N * D * fH * fW == 3763200, f"the R101 frustum has {N * D * fH * fW} points")
    rec["S1"] = dict(s1_check(depth.to(torch.bfloat16), ctx.to(torch.bfloat16), coords, valid,
                              nx, "R101 frustum"),
                     geometry="data/fixtures.py:make_nuscenes_tree's rig (its first test frame)")
    del depth, ctx, coords, valid
    emit(rec)
    return rec


def phase_r101_serve(tree, ann):
    """The R101-DCN config at full width and depth (ResNet-101 caffe with 26
    DCNv2 blocks at 6 x 896 x 1600) serving the config's own test pipeline
    on the tree (``serve_phase`` over 3 frames built first): predicted
    labels in range, and no 2-D ``grid_sample`` in the profiled frame (its
    K4 launches those of the backbone's 26 DCNv2 and the DepthNet's DCN).
    Returns (launch counts, the model) for ``phase_r101_train``."""
    cfg = r101_cfg(tree, ann)
    t0 = time.perf_counter()
    frames = r101_batches(cfg, "test", 3)
    pipeline_s = time.perf_counter() - t0
    for f in frames:  # a served frame has no GT
        f.pop("gt_occ")
    rec, model, _, outs = serve_phase("r101_serve", "occformer_nusc_r101_896x1600", cfg,
                                      frames, R101_SERVE_LAUNCHES,
                                      forbid=("aten::grid_sampler_2d",))
    out = outs[-1]
    check(list(out["voxel_pred"].shape) == [1, *cfg["occ_size"]]
          and list(out["point_pred"].shape) == [1, frames[0]["lidar_xyz"].shape[1]],
          "r101_serve: output shapes")
    check(int(out["voxel_pred"].max()) < cfg["num_class"] and int(out["point_pred"].min()) >= 1,
          "r101_serve: predicted labels out of range")
    rec.update(pipeline_s_for_3_frames=pipeline_s, images=list(frames[0]["imgs"].shape))
    emit(rec)
    return rec["launches"], model


def phase_r101_train(tree, ann, model):
    """The R101-DCN config's train step at full width and depth on the
    per-layer loss route, float32 parameters under bf16 autocast, batch 1,
    on the config's own train pipeline over the tree, ``with_cp`` (each
    trained ResNet block recomputed in the backward: K4 twice for each of
    the 26 DCNv2), ``frozen_stages=1`` (the stem and layer1 run without
    gradient) and ``norm_eval`` (no BatchNorm statistic moves): 4 steps
    (``train_phase``), then ``profile_and_reload``."""
    import torch

    from occformer_tpu_torch.engine.optim import build_optimizer_from_config
    from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step

    cfg = r101_cfg(tree, ann)
    m = cfg["model"]
    t0 = time.perf_counter()
    model.train()
    bb = model.img_backbone
    check(bb.with_cp and bb.frozen_stages == 1 and bb.norm_eval
          and not any(x.training for x in bb.modules() if isinstance(x, torch.nn.BatchNorm2d)),
          "r101_train: the backbone is not with_cp / frozen_stages=1 / norm_eval")
    loss_cfg = build_loss_cfg(dict(m["pts_bbox_head"], mxu_readout="off"), m["train_cfg"]["pts"])
    opt = build_optimizer_from_config(model, cfg, 28130)  # nuScenes' train samples
    step = build_train_step(model, opt, loss_cfg, device="cuda",
                            compute_dtype=getattr(torch, cfg["compute_dtype"]))
    batches = r101_batches(cfg, "train", 2)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    names = ("img_backbone.conv1.weight", "img_backbone.layer1.0.conv2.weight",
             "img_backbone.layer2.0.conv1.weight", "img_backbone.layer3.0.conv2.weight",
             "img_backbone.layer3.5.conv2.conv_offset.weight",
             "img_backbone.layer4.2.conv2.conv_offset.bias", "img_backbone.layer3.0.bn2.weight",
             "img_bev_encoder_neck.encoder.layers.0.attentions.0.value_proj.weight")
    watch = {k: p.detach().clone() for k, p in model.named_parameters() if k in names}
    stats = {k: v.clone() for k, v in bb.state_dict().items() if "running" in k}
    g = torch.Generator(device="cuda").manual_seed(0)
    run = train_phase("r101_train", step, batches, R101_TRAIN_LAUNCHES, 4, g)
    moved = {k: (p.detach() - watch[k]).abs().max().item()
             for k, p in model.named_parameters() if k in watch}
    frozen = ("img_backbone.conv1.weight", "img_backbone.layer1.0.conv2.weight",
              "img_backbone.layer3.0.bn2.weight")
    check(len(moved) == len(names) and all((moved[k] == 0) == (k in frozen) for k in moved),
          f"r101_train: frozen parameters moved or trained ones did not: {moved}")
    stats_moved = [k for k, v in bb.state_dict().items() if "running" in k
                   and not torch.equal(v, stats[k])]
    check(not stats_moved, f"r101_train: BatchNorm statistics moved under norm_eval: "
          f"{stats_moved[:5]}")
    rec = {"phase": "r101_train", "config": "occformer_nusc_r101_896x1600",
           "param_dtype": "float32", "autocast": cfg["compute_dtype"], "with_cp": True,
           "frozen_stages": 1, "norm_eval": True, "route": "per-layer",
           "params": sum(p.numel() for p in model.parameters()), "setup_s": setup_s, **run,
           "max_param_change": moved}
    profile_and_reload(rec, "r101", model, opt, step, batches[0], R101_TRAIN_LAUNCHES, g,
                       forbid=("aten::grid_sampler_2d",))
    emit(rec)
    return run["launches"]


def fcos3d_pth(path):
    """A synthetic FCOS3D ``load_from`` file: the keys and shapes of
    ``tests/fixtures/key_manifests/init_r101_dcn_fcos3d.json`` (676
    ``img_backbone.*`` and 18 ``img_neck.*``), drawn on the card from a
    seeded generator (weights scaled by 1/sqrt(fan_in), BatchNorm scales
    near 1 and variances in [0.5, 2], so that the deep backbone stays
    finite), saved as ``{"state_dict": ...}``."""
    import torch

    with open(os.path.join(REPO, "tests", "fixtures", "key_manifests",
                           "init_r101_dcn_fcos3d.json")) as f:
        keys = json.load(f)["keys"]
    g = torch.Generator(device="cuda").manual_seed(0)
    sd = {}
    for k, shape in keys.items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros(shape, dtype=torch.int64, device="cuda")
        elif k.endswith("running_var"):
            sd[k] = 0.5 + 1.5 * torch.rand(shape, device="cuda", generator=g)
        elif len(shape) == 1 and k.endswith("weight"):
            sd[k] = 0.5 + torch.rand(shape, device="cuda", generator=g)
        elif len(shape) > 1:
            fan_in = float(np.prod(shape[1:]))
            sd[k] = torch.randn(shape, device="cuda", generator=g) / fan_in ** 0.5
        else:
            sd[k] = 0.1 * torch.randn(shape, device="cuda", generator=g)
    torch.save({"state_dict": sd, "meta": {"source": "synthetic"}}, path)
    return keys


def phase_r101_cli(tree, ann):
    """The CLIs on the R101-DCN configs at full width over the tree, as
    subprocesses in a temporary work directory: tools.train to step 2 with
    ``--load-from`` a synthetic FCOS3D file (``fcos3d_pth``), whose report
    must load ``img_backbone`` whole (no key kept at its init) and leave
    only the 18 ``img_neck.*`` keys unused; then tools.test with the
    ``_trainval`` config (its test pipeline's placeholder labels,
    ``is_test_submit``) on step_2 over 2 samples with ``--test-save``: a
    lidarseg ``.bin`` per sample and the submission's ``submission.json``."""
    from occformer_tpu_torch.config import load_config
    from occformer_tpu_torch.data.fixtures import nuscenes_cfg_options

    work = tempfile.mkdtemp(prefix="occformer_r101_cli_")
    rec = {"phase": "r101_cli", "config": "occformer_nusc_r101_896x1600"}
    try:
        pth = os.path.join(work, "r101_dcn_fcos3d_pretrain.pth")
        t = time.perf_counter()
        keys = fcos3d_pth(pth)
        rec["fcos3d_keys"] = len(keys)
        rec["fcos3d_build_s"] = time.perf_counter() - t
        neck = sorted(k for k in keys if k.startswith("img_neck."))
        opts = nuscenes_cfg_options(load_config(R101_CONFIG), tree, ann) + [
            "log_config.interval=1"]
        out1, logs1, rec["train_to_2_s"] = cli_run(
            "train", "--work-dir", work, "--max-steps", "2", "--load-from", pth,
            options=opts, config=R101_CONFIG)
        report = next((ln for ln in out1.splitlines() if ln.startswith("pretrained init from")),
                      "")
        rec["load_from_report"] = report
        check(f"pretrained init from {pth} (partial_load): loaded ['img_backbone'], "
              f"skipped ['img_neck'], kept_init=0, unused_keys={len(neck)}" in report
              and len(neck) == 18, f"r101 load_from report:\n{out1[-3000:]}")
        check("training done at step 2" in out1, f"r101 train to step 2:\n{out1[-2000:]}")
        steps = [ln for ln in logs1 if "step" in ln]
        check([ln["step"] for ln in steps] == [1, 2], f"r101 steps {steps}")
        for ln in steps:
            check(all(v == v and abs(v) != float("inf") for k, v in ln.items()
                      if k not in ("point_mean_iou", "epoch")), f"r101 train CLI log {ln}")
        rec["sec_per_iter"] = [ln["sec/iter"] for ln in steps]
        rec["total_loss"] = [ln["total_loss"] for ln in steps]
        rec["train_launches"] = [ln["kernel_launches"] for ln in logs1 if "kernel_launches" in ln]
        check(all(n[k] > 0 for n in rec["train_launches"]
                  for k in ("K1", "K1-bwd", "K2", "K2-bwd", "K4", "K4-bwd", "S1", "S1-bwd")),
              f"r101 train CLI launches {rec['train_launches']}")
        save = os.path.join(work, "save")
        topts = nuscenes_cfg_options(load_config(R101_TRAINVAL), tree, ann)
        out2, logs2, rec["test_s"] = cli_run(
            "test", "--checkpoint", os.path.join(work, "ckpts", "step_2"), "--max-samples", "2",
            "--test-save", save, options=topts, config=R101_TRAINVAL)
        timing, results = logs2[0], logs2[-1]
        rec["test_sec_per_sample"] = timing["sec/sample"]
        rec["test_launches"] = timing["kernel_launches"]
        rec["test_results_mean"] = results.get("nuScenes_lidarseg_mean")
        check(timing["samples"] == 2 and timing["kernel_launches"]["K4"] == 2 * 27
              and timing["kernel_launches"]["K1"] == 2 * 6, f"r101 test CLI: {timing}")
        bins = sorted(os.listdir(os.path.join(save, "lidarseg", "test")))
        check(len(bins) == 2 and all(b.endswith("_lidarseg.bin") for b in bins)
              and os.path.isfile(os.path.join(save, "test", "submission.json")),
              f"r101 test CLI submission files {bins}")
        rec["submission_bins"] = bins
        rec["submission_bytes"] = [os.path.getsize(os.path.join(save, "lidarseg", "test", b))
                                   for b in bins]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# panoptic (occformer_nusc_panoptic_r50_256x704): 150 queries, GT slots of
# panoptic segments (class * 1000 + instance) padded to 100, PQ / SQ / RQ
# ---------------------------------------------------------------------------

def pan_cfg(tree, ann):
    """The panoptic config pointed at a ``make_nuscenes_tree(...,
    panoptic=True)`` tree."""
    return r101_cfg(tree, ann, config=PAN_CONFIG)


def pan_record(run, plain, library, got, ref, tol, n_bytes, flops, name, exact=False):
    """One kernel's record at a panoptic shape: ``got`` held to ``ref`` (the
    plain version's) within ``tol`` of max|ref| or, ``exact``, bit for bit;
    CUDA-event ms of ``run``, ``plain`` and ``library``, the profiler's device
    ms of ``run`` and ``library``, and the bound of ``n_bytes`` and ``flops``."""
    import torch

    if exact:
        check(torch.equal(got, ref), f"{name}: not the plain version's bits")
        r = {"max_abs_err": 0.0, "max_abs_plain": ref.abs().max().item(), "limit": 0.0,
             "bit_equal": True}
    else:
        r = compare(got, ref, tol, name)
    r.update(kernel_ms=time_cuda(run), device_ms=device_ms(run),
             plain_ms=time_cuda(plain, iters=10), library_ms=time_cuda(library, iters=10),
             library_device_ms=device_ms(library, iters=10))
    r.update(bound(n_bytes, flops))
    return r


def cells_read(spatial, pts01):
    """How many distinct cells of a [X, Y, Z] grid the trilinear reads at
    ``pts01`` [..., 3] in [0, 1] (border, align_corners=False) touch: each
    read's 8 corners, counted once (``ops/loss_gather.py:_corner_weights``).
    A bound counts these cells of a table read at scattered points, not the
    whole table."""
    import torch

    from occformer_tpu_torch.ops.loss_gather import _corner_weights

    _, idx = _corner_weights(pts01, tuple(spatial), False, "border")
    return int(torch.unique(idx).numel())


def phase_pan_kernels(tree, ann):
    """The kernels the panoptic configuration runs at shapes no other path
    gives them, held against their plain versions and timed (CUDA events;
    the profiler's device time beside), with the bound (the table cells the
    reads touch (``cells_read``), the other inputs read and the outputs
    written once, over 3.35 TB/s, or float32 operations over 67 TFLOP/s)
    and the one PyTorch call that computes the same function:

    * K2 and K2-bwd at the per-layer route's random fill: the bf16 mask
      feature [1, 128, 128, 16, 192] read at 100 slots x 12544 points
      (1,254,400 rows, border, align_corners=False; bf16 1e-2, two K2-bwd
      calls bit-equal, K2-bwd on its segmented path); ``F.grid_sample`` and
      autograd through it beside;
    * K2 at the 100-slot GT table [1, 256, 256, 32, 100] bool (the first
      test frame's ``gt_occ == panoptic_ids``) at the 150528 candidates and
      the 50176 matching points (the narrow path; float32 1e-5);
      ``F.grid_sample`` over the float one-hot beside;
    * K3 at the frame's panoptic ids (the id grid, 100 slots with -1 after
      the frame's ids): shared at [10, 150528] and per-slot at [10, 100,
      12544], bit for bit against the plain version on the card;
      ``F.grid_sample`` over the float one-hot [1, 100, 256, 256, 32]
      beside (its build not timed); and the shared read's largest gap to
      K2's read of the GT table at the same points (the one-hot read JAX's
      route makes), recorded, not held: the two form the coordinate from
      points in [0, 1] and in [-1, 1], which round apart by up to about
      half a grid width times 2^-24."""
    import torch
    import torch.nn.functional as F

    from occformer_tpu_torch.ops import loss_gather as k3
    from occformer_tpu_torch.ops import trilerp as k2

    cfg = pan_cfg(tree, ann)
    frame = r101_batches(cfg, "test", 1)[0]
    grid = torch.from_numpy(frame["gt_occ"]).cuda().to(torch.int32).contiguous()
    ids = torch.from_numpy(frame["panoptic_ids"]).cuda().to(torch.int32).contiguous()
    G = ids.shape[1]
    n_ids = int((ids >= 0).sum())
    rec = {"phase": "pan_kernels", "config": "occformer_nusc_panoptic_r50_256x704",
           "gt_grid": list(grid.shape), "slots": G, "real_slots": n_ids,
           "noise_voxels": int((grid == 65535).sum()), "ids_min": int(ids[ids >= 0].min()),
           "ids_max": int(ids.max())}
    check(G == 100 and 0 < n_ids <= G, f"pan_kernels: the id table {G} / {n_ids}")
    tl = cfg["model"]["train_cfg"]["pts"]
    n_pts = tl["num_points"]
    n_cand = int(n_pts * tl["oversample_ratio"])
    n_rand = n_pts - int(tl["importance_sample_ratio"] * n_pts)
    g = torch.Generator(device="cuda").manual_seed(41)

    # K2 / K2-bwd at the random fill
    feat = torch.randn((1, 128, 128, 16, 192), device="cuda", generator=g).to(torch.bfloat16)
    coords = (torch.rand((1, G * n_rand, 3), device="cuda", generator=g) * 2 - 1).contiguous()
    check(k2.fwd_path(feat.shape, feat.dtype, feat.data_ptr()) == "row"
          and k2.bwd_path(feat.shape, G * n_rand) == "segmented",
          "pan K2 random fill: not the row-wide forward / segmented backward")
    got = k2.trilerp_sample(feat, coords, False, "border")
    vol = feat.permute(0, 4, 1, 2, 3).contiguous()  # the library call's layout and dtype
    lib_grid = coords.flip(-1).reshape(1, -1, 1, 1, 3).to(feat.dtype)

    def lib_fwd():
        return F.grid_sample(vol, lib_grid, mode="bilinear", padding_mode="border",
                             align_corners=False)

    cells = cells_read(feat.shape[1:4], (coords + 1) / 2)
    rec["K2_random_fill"] = dict(pan_record(
        lambda: k2.trilerp_sample(feat, coords, False, "border"),
        lambda: k2.trilerp_sample_plain(feat, coords, False, "border"), lib_fwd, got,
        k2.trilerp_sample_plain(feat.float(), coords, False, "border"), 1e-2,
        cells * 192 * feat.element_size() + nbytes(coords, got), coords.shape[1] * 192 * 8 * 2,
        "pan K2 random fill"), table=list(feat.shape), points=list(coords.shape), path="row",
        table_cells_read=cells)
    gout = torch.randn(got.shape, device="cuda", generator=g).to(torch.bfloat16)
    del got
    leaf = feat.detach().clone().requires_grad_(True)
    k2.trilerp_sample(leaf, coords, False, "border").backward(gout)
    pl = feat.detach().float().requires_grad_(True)
    p_out = k2.trilerp_sample_plain(pl, coords, False, "border")
    (ref,) = torch.autograd.grad(p_out, (pl,), gout.float(), retain_graph=True)
    a, _ = k2._launch_bwd(feat, coords, gout, False, "border", want_coords=False)
    b, _ = k2._launch_bwd(feat, coords, gout, False, "border", want_coords=False)
    check(torch.equal(a, b) and torch.equal(a, leaf.grad), "pan K2-bwd: two calls differ")
    vl = vol.detach().clone().requires_grad_(True)
    lib_out = F.grid_sample(vl, lib_grid, mode="bilinear", padding_mode="border",
                            align_corners=False)
    lib_gout = gout.reshape(1, -1, 192).permute(0, 2, 1).reshape(lib_out.shape).contiguous()
    rec["K2-bwd_random_fill"] = dict(pan_record(
        lambda: k2._launch_bwd(feat, coords, gout, False, "border", want_coords=False),
        lambda: torch.autograd.grad(p_out, (pl,), gout.float(), retain_graph=True),
        lambda: torch.autograd.grad(lib_out, (vl,), lib_gout, retain_graph=True),
        leaf.grad, ref, 1e-2, nbytes(gout, coords, feat), coords.shape[1] * 192 * 8 * 2,
        "pan K2-bwd random fill"), table=list(feat.shape), points=list(coords.shape),
        path="segmented", bit_identical_calls=True)
    del feat, coords, gout, leaf, pl, p_out, ref, a, b, vol, vl, lib_out, lib_gout, lib_grid
    free_memory()

    # K2 at the 100-slot GT table
    table = (grid[:, None] == ids[:, :, None, None, None]).permute(0, 2, 3, 4, 1).contiguous()
    onehot = table.permute(0, 4, 1, 2, 3).float().contiguous()  # [1, G, X, Y, Z]
    check(k2.fwd_path(table.shape, table.dtype, table.data_ptr()) == "scalar",
          "pan K2 GT table: not the narrow path")
    for name, n in (("candidates", n_cand), ("matching", n_pts)):
        c = (torch.rand((1, n, 3), device="cuda", generator=g) * 2 - 1).contiguous()
        lg = c.flip(-1).reshape(1, -1, 1, 1, 3)
        got = k2.trilerp_sample(table, c, False, "border")
        cells = cells_read(table.shape[1:4], (c + 1) / 2)
        rec[f"K2_gt_table_{name}"] = dict(pan_record(
            lambda: k2.trilerp_sample(table, c, False, "border"),
            lambda: k2.trilerp_sample_plain(table, c, False, "border"),
            lambda: F.grid_sample(onehot, lg, mode="bilinear", padding_mode="border",
                                  align_corners=False),
            got, k2.trilerp_sample_plain(table, c, False, "border"), 1e-5,
            cells * G * table.element_size() + nbytes(c, got), n * G * 8 * 2,
            f"pan K2 GT table {name}"),
            table=list(table.shape), points=list(c.shape), path="scalar", table_cells_read=cells)
        del got
    free_memory()

    # K3 at the panoptic ids
    N = cfg["model"]["pts_bbox_head"]["transformer_decoder"]["num_layers"] + 1
    for name, shape in (("shared", (N, n_cand, 3)), ("per_slot", (N, G, n_rand, 3))):
        pts = torch.rand(shape, device="cuda", generator=g)
        got = k3.sample_id_masks(grid, ids, pts, False, "border")
        if pts.dim() == 3:  # every layer's points in one grid
            lib_in, lg = onehot, (pts.reshape(1, -1, 1, 1, 3) * 2 - 1).flip(-1).contiguous()
        else:               # slot g's volume at slot g's points of every layer
            lib_in = onehot.transpose(0, 1)
            lg = (pts.transpose(0, 1).reshape(G, -1, 1, 1, 3) * 2 - 1).flip(-1).contiguous()
        cells = cells_read(grid.shape[1:], pts)
        rec[f"K3_{name}"] = r = dict(pan_record(
            lambda: k3.sample_id_masks(grid, ids, pts, False, "border"),
            lambda: k3.sample_id_masks_plain(grid, ids, pts, False, "border"),
            lambda: F.grid_sample(lib_in, lg, mode="bilinear", padding_mode="border",
                                  align_corners=False),
            got, k3.sample_id_masks_plain(grid, ids, pts, False, "border"), 0.0,
            cells * grid.element_size() + nbytes(pts, ids, got), got.numel() * 16,
            f"pan K3 {name}", exact=True), points=list(pts.shape), grid_cells_read=cells)
        if pts.dim() == 3:
            one_hot = k2.trilerp_sample(table, (pts.reshape(1, -1, 3) * 2 - 1).contiguous(),
                                        False, "border")
            r["max_abs_gap_to_k2_one_hot_read"] = (
                got.transpose(1, 2).reshape(one_hot.shape) - one_hot).abs().max().item()
            del one_hot
        del pts, got, lib_in, lg
    del onehot, table
    free_memory()
    emit(rec)
    return rec


def phase_pan_serve(tree, ann):
    """The panoptic config at full width and depth (150 queries) serving the
    config's test pipeline on the tree through ``build_eval_step(...,
    panoptic=True)`` (``serve_phase``: its launches the flagship frame's and
    one K2 for the mask feature at the LiDAR points); each served frame's
    host formatting into PQ counters (``engine/eval.py:add_panoptic``:
    ``format_panoptic_results`` and ``PanopticEval.add_batch`` over the
    valid points) timed apart, ``point_mask`` [1, 150, P]; then
    ``evaluate(panoptic=True)`` over the frames (PQ / SQ / RQ finite, in
    [0, 1]).  Returns (launch counts, the model)."""
    import torch

    from occformer_tpu_torch.engine.eval import (PANOPTIC_IGNORE, PANOPTIC_MIN_POINTS,
                                                  add_panoptic, evaluate)
    from occformer_tpu_torch.utils.panoptic import PanopticEval

    cfg = pan_cfg(tree, ann)
    head = cfg["model"]["pts_bbox_head"]
    things = head["thing_indices"]
    occ_size, n_cls = tuple(cfg["occ_size"]), cfg["num_class"]
    t0 = time.perf_counter()
    frames = r101_batches(cfg, "test", 3)
    pipeline_s = time.perf_counter() - t0
    for f in frames:  # a served frame keeps its panoptic LiDAR labels, not its GT grid
        f.pop("gt_occ")
    rec, model, _, outs = serve_phase("pan_serve", "occformer_nusc_panoptic_r50_256x704", cfg,
                                      frames, PAN_SERVE_LAUNCHES, panoptic=True,
                                      forbid=("aten::grid_sampler_2d",))
    pan = PanopticEval(n_cls, ignore=PANOPTIC_IGNORE, min_points=PANOPTIC_MIN_POINTS)
    host_ms = []
    for i, out in enumerate(outs):  # the host's share of each served frame
        t = time.perf_counter()
        add_panoptic(pan, out, frames[i % len(frames)], things)
        host_ms.append((time.perf_counter() - t) * 1e3)
    out = outs[-1]
    P, Q = frames[0]["lidar_xyz"].shape[1], head["num_queries"]
    check(list(out["point_mask"].shape) == [1, Q, P] and list(out["point_cls"].shape)
          == [1, Q, n_cls + 1] and bool(out["point_mask"].isfinite().all()),
          f"pan_serve: point_mask {list(out['point_mask'].shape)}")
    last = frames[(len(outs) - 1) % len(frames)]
    check(int(out["confusion"].sum()) == int(last["lidar_valid"].sum()),
          "pan_serve: the confusion matrix lost points")
    t = time.perf_counter()
    results = evaluate(model, frames, occ_size, n_cls, class_names=cfg["class_names"],
                       panoptic=True, thing_indices=things,
                       compute_dtype=getattr(torch, cfg["compute_dtype"]))
    eval_s = time.perf_counter() - t
    pq = {k: results[k] for k in ("nuScenes_panoptic_PQ", "nuScenes_panoptic_SQ",
                                  "nuScenes_panoptic_RQ")}
    check(all(0.0 <= v <= 1.0 for v in pq.values()), f"pan_serve: PQ/SQ/RQ {pq}")
    rec.update(pipeline_s_for_3_frames=pipeline_s, queries=Q, lidar_points=P,
               valid_points=int(frames[0]["lidar_valid"].sum()), host_format_ms=host_ms,
               panoptic_counters_over_4_frames={k: v.tolist() for k, v in pan.state().items()},
               evaluate_s_for_3_frames=eval_s, panoptic=pq,
               lidarseg_mean=results.get("nuScenes_lidarseg_mean"))
    emit(rec)
    return rec["launches"], model


def phase_pan_train(tree, ann, model):
    """The panoptic config's train step at full width and depth on the
    per-layer loss route (150 queries against the frame's 100 padded GT
    slots, 50,176 loss points, the random fill of 100 x 12,544 points a
    layer), float32 parameters under bf16 autocast, batch 1, ``with_cp``,
    the config's grad clip (0.01), on the train pipeline over the tree: 3
    steps (``train_phase``; no ``point_mean_iou``), ``profile_and_reload``;
    both routes' losses and Hungarian assignments on one float32 copy of a
    step's outputs with one set of draws (``compare_routes``, the panoptic
    slots); then one step on the batched route (K3 at the panoptic ids).
    Returns the per-layer and the batched step's launch counts."""
    import dataclasses

    import torch

    from occformer_tpu_torch.engine.optim import build_optimizer_from_config
    from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step

    cfg = pan_cfg(tree, ann)
    m = cfg["model"]
    t0 = time.perf_counter()
    model.train()
    check(model.img_backbone.with_cp, "pan_train: the image backbone is not with_cp")
    loss_cfg = build_loss_cfg(dict(m["pts_bbox_head"], mxu_readout="off"),
                              m["train_cfg"]["pts"])
    check(loss_cfg.panoptic and loss_cfg.num_points == 50176, "pan_train: the loss config")
    opt = build_optimizer_from_config(model, cfg, 28130)  # nuScenes' train samples
    check(opt.grad_clip == 0.01, f"pan_train: grad clip {opt.grad_clip}")
    dtype = getattr(torch, cfg["compute_dtype"])
    step = build_train_step(model, opt, loss_cfg, device="cuda", compute_dtype=dtype)
    batches = r101_batches(cfg, "train", 2)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(0)
    run = train_phase("pan_train", step, batches, PAN_TRAIN_LAUNCHES, 3, g)
    for h in run["metrics"]:
        check("point_mean_iou" not in h and h["unassigned_gt"] == 0.0 and h["loss_mask"] > 0,
              f"pan_train: metrics {h}")
    rec = {"phase": "pan_train", "config": "occformer_nusc_panoptic_r50_256x704",
           "param_dtype": "float32", "autocast": cfg["compute_dtype"], "with_cp": True,
           "route": "per-layer", "real_slots": [int((b["panoptic_ids"] >= 0).sum())
                                                for b in batches],
           "setup_s": setup_s, **run}
    profile_and_reload(rec, "pan", model, opt, step, batches[0], PAN_TRAIN_LAUNCHES, g,
                       forbid=("aten::grid_sampler_2d",))
    free_memory()
    rec["routes"] = compare_routes(model, batches[0], loss_cfg)
    free_memory()
    bstep = build_train_step(model, opt, dataclasses.replace(loss_cfg, mxu_readout="on"),
                             device="cuda", compute_dtype=dtype)
    secs, nb, rec["batched_peak_memory_bytes"], _, outs = main_path_run(
        "pan batched step", lambda b: bstep(b, g), batches[1:], PAN_TRAIN_LAUNCHES_BATCHED, 1)
    rec.update(batched_step_s=secs[0], batched_launches=nb,
               batched_metrics={k: float(v) for k, v in outs[0].items()})
    check(all(v == v and abs(v) != float("inf") for v in rec["batched_metrics"].values()),
          f"pan batched step metrics {rec['batched_metrics']}")
    emit(rec)
    return run["launches"], nb


def phase_pan_cli(tree, ann):
    """The CLIs on the panoptic config at full width over the tree, as
    subprocesses in a temporary work directory: tools.train to step 2 (the
    config's ``evaluation.interval=999``: no evaluation), then tools.test
    on step_2 over 2 samples: ``nuScenes_panoptic_PQ``, ``_SQ`` and
    ``_RQ`` in its results line."""
    from occformer_tpu_torch.config import load_config
    from occformer_tpu_torch.data.fixtures import nuscenes_cfg_options

    opts = nuscenes_cfg_options(load_config(PAN_CONFIG), tree, ann) + ["log_config.interval=1"]
    work = tempfile.mkdtemp(prefix="occformer_pan_cli_")
    rec = {"phase": "pan_cli", "config": "occformer_nusc_panoptic_r50_256x704"}
    try:
        out1, logs1, rec["train_to_2_s"] = cli_run(
            "train", "--work-dir", work, "--max-steps", "2", options=opts, config=PAN_CONFIG)
        check("training done at step 2" in out1, f"pan train to step 2:\n{out1[-2000:]}")
        steps = [ln for ln in logs1 if "step" in ln]
        check([ln["step"] for ln in steps] == [1, 2], f"pan steps {steps}")
        for ln in steps:
            check("point_mean_iou" not in ln and all(
                v == v and abs(v) != float("inf") for k, v in ln.items() if k != "epoch"),
                f"pan train CLI log {ln}")
        rec["sec_per_iter"] = [ln["sec/iter"] for ln in steps]
        rec["total_loss"] = [ln["total_loss"] for ln in steps]
        rec["grad_norm"] = [ln.get("grad_norm") for ln in steps]
        rec["train_launches"] = [ln["kernel_launches"] for ln in logs1 if "kernel_launches" in ln]
        check(all(n[k] > 0 for n in rec["train_launches"]
                  for k in ("K1", "K1-bwd", "K2", "K2-bwd", "K4", "K4-bwd", "S1", "S1-bwd")),
              f"pan train CLI launches {rec['train_launches']}")
        out2, logs2, rec["test_s"] = cli_run(
            "test", "--checkpoint", os.path.join(work, "ckpts", "step_2"), "--max-samples", "2",
            options=opts, config=PAN_CONFIG)
        timing, results = logs2[0], logs2[-1]
        rec["test_sec_per_sample"] = timing["sec/sample"]
        rec["test_launches"] = timing["kernel_launches"]
        rec["test_results"] = {k: v for k, v in results.items()
                               if "panoptic" in k or k == "nuScenes_lidarseg_mean"}
        check(timing["samples"] == 2 and timing["kernel_launches"]["K2"] == 2,
              f"pan test CLI: {timing}")
        for k in ("nuScenes_panoptic_PQ", "nuScenes_panoptic_SQ", "nuScenes_panoptic_RQ"):
            check(k in results and 0.0 <= results[k] <= 1.0, f"pan test CLI results {results}")
        say(f"pan_cli: PQ {results['nuScenes_panoptic_PQ']} SQ "
            f"{results['nuScenes_panoptic_SQ']} RQ {results['nuScenes_panoptic_RQ']}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit(rec)
    return rec


def t4d_cfg(tree, ann):
    """The flagship config on the tree, its model made ``OccupancyFormer4D``
    (the occupancy encoder's input 2 * numC_Trans = 256 channels); no
    config file of its own, as the JAX package has none."""
    cfg = r101_cfg(tree, ann, config=CONFIG)
    m = cfg["model"]
    m["type"] = "OccupancyFormer4D"
    m["img_bev_encoder_backbone"]["in_channels"] = 2 * m["img_view_transformer"]["numC_Trans"]
    return cfg


FRAME_KEYS = ("imgs", "rots", "trans", "intrins", "post_rots", "post_trans")


def two_frames(key, prev):
    """A 4D batch: the two samples' cameras interleaved, frame axis minor
    ([cam0 key, cam0 previous, cam1 key, ...]); the rest (bda, GT, LiDAR)
    the key frame's."""
    out = dict(key)
    for k in FRAME_KEYS:
        a = key[k]
        out[k] = np.stack([a, prev[k]], axis=2).reshape(a.shape[0], 2 * a.shape[1],
                                                        *a.shape[2:])
    return out


def t4d_batches(cfg, split, n):
    """``n`` 4D batches of the split: sample i the key frame, i + 1 the
    previous one."""
    samples = r101_batches(cfg, split, n + 1)
    return [two_frames(samples[i], samples[i + 1]) for i in range(n)]


def phase_t4d_serve(tree, ann):
    """The 4D model at full width and depth (the flagship's, two frames)
    serving 4D batches of the test pipeline over the tree (``serve_phase``:
    12 camera slots at 256 x 704; K4 and S1 twice a frame): output shapes,
    predicted labels in range, a profiled frame with both frames inside its
    image encoder and view transformer stages.  Returns (launch counts, the
    model)."""
    from occformer_tpu_torch.models.detector import OccupancyFormer4D

    cfg = t4d_cfg(tree, ann)
    t0 = time.perf_counter()
    frames = t4d_batches(cfg, "test", 3)
    pipeline_s = time.perf_counter() - t0
    for f in frames:  # a served frame has no GT
        f.pop("gt_occ")
    check(list(frames[0]["imgs"].shape) == [1, 12, 256, 704, 3],
          f"t4d_serve: images {list(frames[0]['imgs'].shape)}")
    rec, model, _, outs = serve_phase("t4d_serve", "occformer_nusc_r50_256x704 as "
                                      "OccupancyFormer4D", cfg, frames, T4D_SERVE_LAUNCHES,
                                      forbid=("aten::grid_sampler_2d",))
    check(type(model) is OccupancyFormer4D, f"t4d_serve: built {type(model).__name__}")
    out = outs[-1]
    check(list(out["voxel_pred"].shape) == [1, *cfg["occ_size"]]
          and list(out["point_pred"].shape) == [1, frames[0]["lidar_xyz"].shape[1]],
          "t4d_serve: output shapes")
    check(int(out["voxel_pred"].max()) < cfg["num_class"] and int(out["point_pred"].min()) >= 1,
          "t4d_serve: predicted labels out of range")
    check(rec["shapes"]["depth_prob"][0] == 6, f"t4d_serve: depth {rec['shapes']['depth_prob']}")
    rec.update(pipeline_s_for_4_samples=pipeline_s, images=list(frames[0]["imgs"].shape))
    emit(rec)
    return rec["launches"], model


def phase_t4d_train(tree, ann, model):
    """The 4D model's train step at full width and depth, float32 parameters
    under bf16 autocast, batch 1, on 4D batches of the train pipeline over
    the tree: 3 steps on the per-layer route (``train_phase``; every image
    BatchNorm and the DepthNet's camera BatchNorm move twice a step, key
    frame then previous), ``profile_and_reload`` (a profiled step, one
    reloaded pair bit for bit), then one step on the batched route.
    Returns the per-layer and the batched step's launch counts."""
    import dataclasses

    import torch

    from occformer_tpu_torch.engine.optim import build_optimizer_from_config
    from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step

    cfg = t4d_cfg(tree, ann)
    m = cfg["model"]
    t0 = time.perf_counter()
    model.train()
    loss_cfg = build_loss_cfg(dict(m["pts_bbox_head"], mxu_readout="off"), m["train_cfg"]["pts"])
    opt = build_optimizer_from_config(model, cfg, 28130)  # nuScenes' train samples
    dtype = getattr(torch, cfg["compute_dtype"])
    step = build_train_step(model, opt, loss_cfg, device="cuda", compute_dtype=dtype)
    batches = t4d_batches(cfg, "train", 2)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    bns = ("img_backbone.layer1.0.bn1.num_batches_tracked",
           "img_view_transformer.depth_net.bn.num_batches_tracked")
    counted = {k: int(model.state_dict()[k]) for k in bns}
    g = torch.Generator(device="cuda").manual_seed(0)
    run = train_phase("t4d_train", step, batches, T4D_TRAIN_LAUNCHES["off"], 3, g)
    moved = {k: int(model.state_dict()[k]) - counted[k] for k in bns}
    check(all(v == 2 * 3 for v in moved.values()),
          f"t4d_train: BatchNorm updates in 3 steps {moved}, want 2 a step")
    rec = {"phase": "t4d_train", "config": "occformer_nusc_r50_256x704 as OccupancyFormer4D",
           "param_dtype": "float32", "autocast": cfg["compute_dtype"], "route": "per-layer",
           "images": list(batches[0]["imgs"].shape), "batchnorm_updates_in_3_steps": moved,
           "params": sum(p.numel() for p in model.parameters()), "setup_s": setup_s, **run}
    profile_and_reload(rec, "t4d", model, opt, step, batches[0], T4D_TRAIN_LAUNCHES["off"], g,
                       forbid=("aten::grid_sampler_2d",))
    free_memory()
    bstep = build_train_step(model, opt, dataclasses.replace(loss_cfg, mxu_readout="on"),
                             device="cuda", compute_dtype=dtype)
    secs, nb, rec["batched_peak_memory_bytes"], _, outs = main_path_run(
        "t4d batched step", lambda b: bstep(b, g), batches[1:], T4D_TRAIN_LAUNCHES["on"], 1)
    rec.update(batched_step_s=secs[0], batched_launches=nb,
               batched_metrics={k: float(v) for k, v in outs[0].items()})
    check(all(v == v and abs(v) != float("inf") for k, v in rec["batched_metrics"].items()
              if k != "point_mean_iou"), f"t4d batched step metrics {rec['batched_metrics']}")
    emit(rec)
    return run["launches"], nb


def stereo_inputs(tree, ann):
    """BEVStereo's full-width inputs on the card: the flagship's grid and
    image size, two sweeps of the tree's first test frame's six cameras (the
    nuScenes rig; the sweep taken after the ego moved 0.5 m forward), and
    per sweep seeded random bf16 features (stereo [6, 256, 64, 176], image
    [6, 512, 16, 44]) and the camera embedding; the key frame's cameras for
    the splat.  Returns (the view transformer's config, the inputs)."""
    import torch

    from occformer_tpu_torch.models.depthnet import get_mlp_input

    cfg = r101_cfg(tree, ann, config=CONFIG)
    vt = cfg["model"]["img_view_transformer"]
    frame = r101_batches(cfg, "test", 1)[0]
    cams = [torch.from_numpy(frame[k]).cuda()
            for k in ("rots", "trans", "intrins", "post_rots", "post_trans", "bda")]
    rots, trans, intrins, post_rots, post_trans, _ = (c[0] for c in cams)
    N = rots.shape[0]
    eye = torch.eye(4, device="cuda").repeat(N, 1, 1)
    cam2ego, intrin, ida = eye.clone(), eye.clone(), eye.clone()
    cam2ego[:, :3, :3], cam2ego[:, :3, 3] = rots, trans
    intrin[:, :3, :3] = intrins
    ida[:, :3, :3], ida[:, :3, 3] = post_rots, post_trans
    shift = torch.eye(4, device="cuda")
    shift[0, 3] = -0.5  # key ego -> the sweep's ego, 0.5 m further forward
    s2s = torch.stack([eye, torch.linalg.inv(cam2ego) @ shift @ cam2ego], 1)
    mats = {"intrin_mats": torch.stack([intrin, intrin], 1),
            "ida_mats": torch.stack([ida, ida], 1), "sensor2sensor_mats": s2s}
    g = torch.Generator(device="cuda").manual_seed(41)
    feat = lambda shape: torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
    mlp = get_mlp_input(*cams).reshape(N, -1)
    return vt, {"xs": [feat(STEREO_IMAGE_FEATURES) for _ in range(2)], "mlps": [mlp, mlp],
                "feats": [feat(STEREO_FEATURES) for _ in range(2)], "mats": mats,
                "cams": cams}


def phase_stereo_kernels(tree, ann):
    """K4 and K4-bwd as BEVStereo sends them (``k4_record``: held against the
    plain version in bf16 and float32, two K4-bwd calls bit-equal, timed
    beside their bounds and ``F.grid_sample`` 2-D and its autograd):

    * the stereo warp: a sweep's [6, 64*176, 256] bf16 features at 3 depth
      hypotheses a pixel, 6 x 33,792 points, (y, x, 0) from
      ``models/bevstereo.py:warp_grid`` on ``stereo_inputs``' rig at depths
      mu + sigma * k (mu in [2, 58], sigma in [0.5, 3]), align_corners=False;
      the backward without d_coords, as the warp's grid has no gradient;
    * the mask warp: the [6, 16*44, 112] mono depth at one hypothesis a
      pixel of 1/16 (K4 alone on the path: the mask's inputs are detached);
    * DepthNetStereo's DCN: the flagship DepthNet's [6, 704, 512]
      (``phase_k4_dcn``)."""
    import torch

    from occformer_tpu_torch.models.bevstereo import (create_depth_sample_frustum,
                                                      depth_sampling_k_list, warp_grid)

    _, inp = stereo_inputs(tree, ann)
    mats = inp["mats"]
    geo = (mats["intrin_mats"][:, 0], mats["intrin_mats"][:, 1], mats["sensor2sensor_mats"][:, 1],
           mats["ida_mats"][:, 0], mats["ida_mats"][:, 1])
    g = torch.Generator(device="cuda").manual_seed(43)
    N, C, Hs, Ws = STEREO_FEATURES
    mu = 2 + 56 * torch.rand((N, 1, Hs, Ws), device="cuda", generator=g)
    sigma = 0.5 + 2.5 * torch.rand((N, 1, Hs, Ws), device="cuda", generator=g)
    ds = torch.cat([mu + sigma * float(k) for k in depth_sampling_k_list(3.0, 3)], 1)
    grid = warp_grid(*geo, ds, create_depth_sample_frustum(ds, (256, 704), 4), (Hs, Ws), 4)
    fH, fW, D = 16, 44, 112
    ds_m = 2 + 56 * torch.rand((N, 1, fH, fW), device="cuda", generator=g)
    grid_m = warp_grid(*geo, ds_m, create_depth_sample_frustum(ds_m, (256, 704), 16),
                       (fH, fW), 16)

    def warp(table_shape, coords, hw):
        def inputs(dtype=None):
            gen = torch.Generator(device="cuda").manual_seed(45)
            t = torch.randn(table_shape, device="cuda", generator=gen)
            return [t.to(dtype or torch.bfloat16)], [coords], table_shape[-1], [(*hw, 1)]
        return inputs

    inside = lambda gr: float(((gr[..., :2].abs() <= 1).all(-1)).float().mean())
    rec = {"phase": "stereo_kernels",
           "stereo_warp": k4_record(warp((N, Hs * Ws, C), grid, (Hs, Ws)), "stereo warp",
                                    False, coords_grad=False),
           "mask_warp": k4_record(warp((N, fH * fW, D), grid_m, (fH, fW)), "mask warp",
                                  False, coords_grad=False),
           "points_inside": {"stereo": inside(grid), "mask": inside(grid_m)}}
    free_memory()
    rec["dcn"] = phase_k4_dcn()
    emit(rec)
    return rec


def stereo_forward(module, inp):
    """Each sweep's DepthNetStereo, ``forward_stereo`` (sweep 0 the key),
    ``fuse_depth`` and the splat of the key sweep's context."""
    outs = [module.depth_net(x, m) for x, m in zip(inp["xs"], inp["mlps"])]
    _, ctxs, mus, sigmas, rss, monos = (list(o) for o in zip(*outs))
    sd, ms = module.forward_stereo(0, inp["feats"], monos, inp["mats"], mus, sigmas, rss)
    prob = module.fuse_depth(monos[0], sd, ms)
    N, _, fH, fW = ctxs[0].shape
    vol = module(ctxs[0].reshape(1, N, -1, fH, fW), prob, *inp["cams"])
    return sd, ms, prob, vol


def phase_stereo(tree, ann):
    """``models/bevstereo.py:ViewTransformerLSSBEVStereo`` at full width
    (numC_input 512, numC_Trans 128, the module's defaults: 4 ranges over
    dbound [2, 58, 0.5], D = 112, 3 EM steps, 3 samples, 8 groups, stereo
    factor 4, the mask on) on ``stereo_inputs``, seeded random weights,
    float32 parameters under bf16 autocast: 4 forwards in eval mode (the
    first a warm-up; ``main_path_run``: K4 18 times a forward, S1 once):
    each sweep's DepthNetStereo -> ``forward_stereo`` -> ``fuse_depth`` ->
    the splat into the flagship's [1, 128, 128, 16, 128] voxel grid (depth
    probabilities summing to 1, the mask in [0, 1], the volume finite and
    not empty); then, in train mode on the port's default settings (cuDNN's
    TF32 on), the backward of a fixed random weighting of ``fuse_depth``'s
    output, twice from the same parameters: every gradient (the parameters'
    and the stereo features') bit-equal, else the convolutions whose backward
    varies are named (``varying_convolutions``)."""
    import torch

    from occformer_tpu_torch.models.bevstereo import ViewTransformerLSSBEVStereo
    from occformer_tpu_torch.models.detector import init_weights

    vt, inp = stereo_inputs(tree, ann)
    t0 = time.perf_counter()
    with torch.device("cuda"):
        module = ViewTransformerLSSBEVStereo(vt["grid_config"], vt["data_config"],
                                             numC_input=512, numC_Trans=128)
    init_weights(module, torch.Generator(device="cuda").manual_seed(0))
    module.eval()
    build_s = time.perf_counter() - t0
    check(module.D == 112 and len(module.ranges) == 4, f"stereo: D {module.D}")

    def serve(_):
        with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
            return stereo_forward(module, inp)

    secs, n, peak, resident, outs = main_path_run("stereo", serve, [None], STEREO_LAUNCHES, 4)
    sd, ms, prob, vol = outs[-1]
    sums = prob.sum(1)
    check(bool(torch.isfinite(prob).all()) and float((sums - 1).abs().max()) < 1e-4,
          "stereo: depth probabilities")
    check(float(ms.min()) >= 0 and float(ms.max()) <= 1.0 and
          bool(torch.isfinite(sd).all()) and float(sd.min()) >= 0, "stereo: stereo depth, mask")
    check(list(vol.shape) == [1, 128, 128, 16, 128] and bool(torch.isfinite(vol.float()).all())
          and float(vol.float().abs().max()) > 0, f"stereo: volume {list(vol.shape)}")
    rec = {"phase": "stereo", "param_dtype": "float32", "autocast": "bfloat16",
           "model_build_s": build_s, "params": sum(p.numel() for p in module.parameters()),
           "stereo_features": list(STEREO_FEATURES), "image_features": list(STEREO_IMAGE_FEATURES),
           "warmup_forward_ms": secs[0] * 1e3, "forward_ms": [x * 1e3 for x in secs[1:]],
           "launches": n, "peak_memory_bytes": peak, "resident_bytes_at_start": resident,
           "shapes": {"stereo_depth": list(sd.shape), "mask_score": list(ms.shape),
                      "depth_prob": list(prob.shape), "volume": list(vol.shape)}}
    del outs, sd, ms, prob, vol
    free_memory()

    module.train()
    names = [k for k, _ in module.named_parameters()]
    w = torch.randn((6, 112, 16, 44), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(47))

    def backward():
        module.zero_grad(set_to_none=True)
        feats = [f.detach().requires_grad_(True) for f in inp["feats"]]
        with torch.autocast("cuda", dtype=torch.bfloat16):
            prob = stereo_forward(module, dict(inp, feats=feats))[2]
        (prob * w).sum().backward()
        return [None if p.grad is None else p.grad.clone() for p in module.parameters()] + \
            [f.grad for f in feats]

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # the port's default settings
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()  # the backward's run starts here
        times = []
        grads = []
        for _ in range(2):
            t = time.perf_counter()
            grads.append(backward())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        got = launches()  # ... and ends here
        want = {k: 2 * v for k, v in STEREO_BWD_LAUNCHES.items()}
        check(got == want, f"stereo backward launches {got}, want {want}")
        keys = names + ["stereo_feature_0", "stereo_feature_1"]
        differ = [k for k, a, b in zip(keys, *grads) if a is not None and not torch.equal(a, b)]
        rec.update(backward_s=times, backward_launches=got,
                   backward_peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   grads=sum(a is not None for a in grads[0]), grads_differ=len(differ),
                   grads_differing=differ[:40])
        check(grads[0][-1] is not None and float(grads[0][-1].float().abs().max()) > 0,
              "stereo: the previous sweep's features got no gradient through the warp")
        if differ:
            rec["modules"] = varying_convolutions(module, differ, backward)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    emit(rec)
    check(not differ, f"stereo: the repeated backward differs in {len(differ)} gradients")
    return rec["launches"], rec["backward_launches"]


def voxnet_cfg(tree, ann):
    """The flagship config on the tree with both branches the port used to
    refuse: ``use_voxel_net`` (the lift refined by DepthAggregation, splat
    by S1-rows) and ``pooling_attn_mask=False`` (trilinear attention
    masks); no released config sets either."""
    cfg = r101_cfg(tree, ann, config=CONFIG)
    cfg["model"]["img_view_transformer"]["use_voxel_net"] = True
    cfg["model"]["pts_bbox_head"]["pooling_attn_mask"] = False
    return cfg


def voxnet_points(tree, ann):
    """The use_voxel_net splat's coordinates at the flagship's shapes: the
    frustum of the tree's first test frame (the nuScenes rig of
    ``make_nuscenes_tree``, the data phase's), its points in the order the
    view transformer sends them (camera, row, column, depth bin): coords
    int32 [1, P, 3], valid [1, P], the grid (X, Y, Z)."""
    import torch

    from occformer_tpu_torch.ops.geometry import (
        compute_voxel_coords,
        create_frustum,
        gen_dx_bx,
        get_geometry,
    )

    cfg = r101_cfg(tree, ann, config=CONFIG)
    vt = cfg["model"]["img_view_transformer"]
    frame = r101_batches(cfg, "test", 1)[0]
    cams = [torch.from_numpy(frame[k]).cuda()
            for k in ("rots", "trans", "intrins", "post_rots", "post_trans", "bda")]
    grid = vt["grid_config"]
    dx, bx, nx = gen_dx_bx(grid["xbound"], grid["ybound"], grid["zbound"])
    frustum = torch.from_numpy(create_frustum(grid, tuple(vt["data_config"]["input_size"]),
                                              vt.get("downsample", 16))).cuda()
    coords, valid = compute_voxel_coords(get_geometry(frustum, *cams), dx, bx, nx)
    order = (0, 1, 3, 4, 2)  # [B, N, D, fH, fW] -> (camera, row, column, depth bin)
    coords = coords.permute(*order, 5).reshape(1, -1, 3).to(torch.int32).contiguous()
    valid = valid.permute(*order).reshape(1, -1).contiguous()
    return coords, valid, tuple(int(n) for n in nx)


def s1_rows_record(feats, coords, valid, nx, label):
    """S1-rows against its plain version (one index_add_ into float32 rows,
    atomic on the card) and against the plain version on the CPU (the same
    order: equal bit for bit), two calls bit-equal, its backward bit-equal
    to the plain gather, timed in turns with the plain version, the kernels'
    device ms (also by kernel: the memset, count, scan, fill, rank and
    splat), one index_add_ in feats' dtype (the library call) and the
    bound; under ``backward`` S1-rows-bwd (``_launch_rows_bwd``) bit for bit
    the plain gather, two calls bit-equal, timed in turns with it, its device
    ms, autograd through one index_add_ (the library call) and its bound."""
    import torch
    import torch.nn.functional as F

    from occformer_tpu_torch.ops import scatter

    B, P, C = feats.shape
    n_rows = B * nx[0] * nx[1] * nx[2]
    rows = scatter.voxel_rows(coords, valid, nx)

    def plain():
        return scatter.voxel_scatter_plain_rows(feats, rows, n_rows).to(feats.dtype)

    def kernel():
        return scatter.voxel_scatter(feats, coords, valid, nx)

    got, again = kernel(), kernel()
    check(torch.equal(got, again), f"S1-rows {label}: two calls differ")
    rec = compare(got.reshape(n_rows, C), plain(), 1e-5 if feats.dtype == torch.float32
                  else 1e-2, f"S1-rows {label}")
    cpu = scatter.voxel_scatter_plain_rows(feats.cpu(), rows.cpu(), n_rows).to(feats.dtype)
    rec["equal_to_cpu_plain"] = bool(torch.equal(got.reshape(n_rows, C).cpu(), cpu))
    check(rec["equal_to_cpu_plain"], f"S1-rows {label}: not the CPU plain version's bits")
    leaf = feats.detach().clone().requires_grad_(True)
    vol = scatter.voxel_scatter(leaf, coords, valid, nx)
    g = torch.randn(vol.shape, device=vol.device, generator=torch.Generator(
        device="cuda").manual_seed(7)).to(vol.dtype)
    before = launches()["S1-rows-bwd"]
    (d_feats,) = torch.autograd.grad(vol, leaf, g)
    check(launches()["S1-rows-bwd"] == before + 1,
          f"S1-rows {label}: the backward is not one launch of S1-rows-bwd")
    want = F.pad(g.reshape(n_rows, C), (0, 0, 0, 1)).index_select(0, rows.reshape(-1))
    check(torch.equal(d_feats.reshape(-1, C), want), f"S1-rows {label}: backward")
    rec.update(bit_identical_calls=True, backward_bit_equal_to_gather=True,
               dtype=str(feats.dtype), rows=[B, P, C], grid=list(nx),
               points_valid=int(valid.sum()))
    gout = g.reshape(n_rows, C)
    # as the main path hands it over: the gradient of volume.permute(0, 4, 1, 2, 3)
    main_gout = g.permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1).reshape(-1, C)

    def bwd_kernel(gg=main_gout):
        return scatter._launch_rows_bwd(gg, coords, valid, nx)

    def bwd_plain():
        return scatter.voxel_scatter_rows_backward_plain(main_gout, coords, valid, nx)

    first = bwd_kernel()
    check(torch.equal(first, bwd_kernel()) and torch.equal(first, bwd_kernel(gout))
          and torch.equal(first.reshape(-1, C), want),
          f"S1-rows-bwd {label}: two calls, the two gradient layouts or the plain gather differ")
    del first
    bwd = {"max_abs_err": 0.0, "bit_equal_to_plain": True, "bit_identical_calls": True,
           "gradient_transposed": main_gout.stride() == (1, main_gout.shape[0])}
    ms = {"plain": [], "kernel": []}
    for name in ("kernel", "plain", "plain", "kernel"):
        ms[name].append(time_cuda(bwd_kernel if name == "kernel" else bwd_plain))
    bwd.update(ms_in_turns=ms, kernel_ms=sum(ms["kernel"]) / 2, plain_ms=sum(ms["plain"]) / 2,
               device_ms=device_ms(bwd_kernel), rows_device_ms=device_ms(lambda: bwd_kernel(gout)))
    # the library call: autograd through one index_add_ into the padded rows
    lib_leaf = feats.detach().reshape(-1, C).clone().requires_grad_(True)
    lib_vol = lib_leaf.new_zeros((n_rows + 1, C)).index_add(0, rows.reshape(-1), lib_leaf)
    lib_g = F.pad(gout, (0, 0, 0, 1))
    bwd["library_ms"] = time_cuda(lambda: torch.autograd.grad(lib_vol, lib_leaf, lib_g,
                                                              retain_graph=True))
    # what the copy must move: valid read in full, the coordinates of each
    # valid point, the gradient's row of each filled voxel once (points of
    # one voxel share it), d_feats written once; no arithmetic
    n_valid = rec["points_valid"]
    filled = int((torch.bincount(rows.reshape(-1), minlength=n_rows + 1)[:n_rows] > 0).sum())
    bwd.update(bound(nbytes(valid, d_feats) + n_valid * 3 * coords.element_size()
                     + filled * C * gout.element_size(), 0), voxels_filled=filled)
    rec["backward"] = bwd
    del again, leaf, vol, g, gout, main_gout, d_feats, want, cpu, lib_leaf, lib_vol, lib_g
    ms = {"plain": [], "kernel": []}
    with torch.no_grad():
        for name in ("plain", "kernel", "kernel", "plain"):
            ms[name].append(time_cuda(plain if name == "plain" else kernel))
        lib = torch.zeros((n_rows + 1, C), dtype=feats.dtype, device=feats.device)
        flat_rows, flat = rows.reshape(-1), feats.reshape(-1, C)
        rec["library_ms"] = time_cuda(lambda: lib.index_add_(0, flat_rows, flat))
        rec["device_ms"], rec["device_ms_by_kernel"] = device_ms(kernel, by_kernel=True)
    rec.update(ms_in_turns=ms, kernel_ms=sum(ms["kernel"]) / 2, plain_ms=sum(ms["plain"]) / 2)
    # what the splat must move: valid read in full, the coordinates and the
    # row of feats of each valid point (an invalid point needs neither), the
    # volume written once; an add per (valid point, channel)
    n_valid = rec["points_valid"]
    moved = (nbytes(valid, got) + n_valid * 3 * coords.element_size()
             + n_valid * C * feats.element_size())
    rec.update(bound(moved, n_valid * C))
    return rec


def phase_voxnet_kernels(tree, ann):
    """S1-rows as the use_voxel_net flagship sends it: B = 1, P = 6 * 16 *
    44 * 112 = 473,088 rows of C = 128 (seeded random features: the refined
    lift's shape) into the 128 x 128 x 16 grid, at the nuScenes rig's
    coordinates (``voxnet_points``), in float32 and bf16
    (``s1_rows_record``).  Returns the records."""
    import torch

    coords, valid, nx = voxnet_points(tree, ann)
    check(coords.shape[1] == 473088, f"voxnet_kernels: {coords.shape[1]} points")
    feats = torch.randn((1, coords.shape[1], 128), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(5))
    rec = {"phase": "voxnet_kernels"}
    for dtype in (torch.float32, torch.bfloat16):
        rec[str(dtype).split(".")[1]] = s1_rows_record(feats.to(dtype), coords, valid, nx,
                                                       str(dtype))
        free_memory()
    emit(rec)
    return rec


def phase_voxnet_serve(tree, ann):
    """The flagship with use_voxel_net and trilinear attention masks at full
    width and depth, serving the test pipeline over the tree
    (``serve_phase``): output shapes, predicted labels in range, and the
    profiled frame's view-transformer device ms beside DepthAggregation's
    (its ``stage:depth_aggregation``).  Returns (launch counts, the
    model)."""
    cfg = voxnet_cfg(tree, ann)
    frames = r101_batches(cfg, "test", 3)
    for f in frames:  # a served frame has no GT
        f.pop("gt_occ")
    rec, model, _, outs = serve_phase("voxnet_serve", "occformer_nusc_r50_256x704 with "
                                      "use_voxel_net, pooling_attn_mask=False", cfg, frames,
                                      VOXNET_SERVE_LAUNCHES,
                                      forbid=("aten::adaptive_max_pool3d",))
    check(hasattr(model.img_view_transformer, "depth_aggregation_net")
          and not model.pts_bbox_head.pooling_attn_mask, "voxnet_serve: the branches")
    out = outs[-1]
    check(list(out["voxel_pred"].shape) == [1, *cfg["occ_size"]]
          and int(out["voxel_pred"].max()) < cfg["num_class"]
          and int(out["point_pred"].min()) >= 1, "voxnet_serve: outputs")
    st = rec["profile"]["stages"]
    rec["view_transformer_device_ms"] = st["view_transformer"]["device_ms"]
    rec["depth_aggregation_device_ms"] = st["depth_aggregation"]["device_ms"]
    emit(rec)
    return rec["launches"], model


def phase_voxnet_train(tree, ann, model):
    """The use_voxel_net / trilinear-mask flagship's train step at full width
    and depth, float32 parameters under bf16 autocast, batch 1, on the
    train pipeline over the tree: 3 steps on the per-layer route
    (``train_phase``; DepthAggregation's kernels and BatchNorm statistics
    move), ``profile_and_reload`` (a reloaded pair repeats every loss and
    gradient bit for bit), then one step on the batched route.  Returns
    the per-layer and the batched step's launch counts."""
    import dataclasses

    import torch

    from occformer_tpu_torch.engine.optim import build_optimizer_from_config
    from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step

    cfg = voxnet_cfg(tree, ann)
    m = cfg["model"]
    model.train()
    loss_cfg = build_loss_cfg(dict(m["pts_bbox_head"], mxu_readout="off"),
                              m["train_cfg"]["pts"])
    opt = build_optimizer_from_config(model, cfg, 28130)  # nuScenes' train samples
    dtype = getattr(torch, cfg["compute_dtype"])
    step = build_train_step(model, opt, loss_cfg, device="cuda", compute_dtype=dtype)
    batches = r101_batches(cfg, "train", 2)
    da = model.img_view_transformer.depth_aggregation_net
    before = da.conv1.weight.detach().clone()
    g = torch.Generator(device="cuda").manual_seed(0)
    run = train_phase("voxnet_train", step, batches, VOXNET_TRAIN_LAUNCHES["off"], 3, g)
    check(not torch.equal(da.conv1.weight, before) and int(da.bn1.num_batches_tracked) == 3,
          "voxnet_train: DepthAggregation did not train")
    rec = {"phase": "voxnet_train", "config": "occformer_nusc_r50_256x704 with use_voxel_net, "
           "pooling_attn_mask=False", "param_dtype": "float32", "autocast": cfg["compute_dtype"],
           "route": "per-layer", **run}
    profile_and_reload(rec, "voxnet", model, opt, step, batches[0],
                       VOXNET_TRAIN_LAUNCHES["off"], g, forbid=("aten::adaptive_max_pool3d",))
    free_memory()
    bstep = build_train_step(model, opt, dataclasses.replace(loss_cfg, mxu_readout="on"),
                             device="cuda", compute_dtype=dtype)
    secs, nb, rec["batched_peak_memory_bytes"], _, outs = main_path_run(
        "voxnet batched step", lambda b: bstep(b, g), batches[1:],
        VOXNET_TRAIN_LAUNCHES["on"], 1)
    rec.update(batched_step_s=secs[0], batched_launches=nb,
               batched_metrics={k: float(v) for k, v in outs[0].items()})
    check(all(v == v and abs(v) != float("inf") for k, v in rec["batched_metrics"].items()
              if k != "point_mean_iou"), f"voxnet batched step {rec['batched_metrics']}")
    emit(rec)
    return run["launches"], nb


# the point-cloud surface at sizes its users run (the first three from the
# public configs named in phase_pointcloud's docstring)
PC_NUSC_POINTS = 300000
PC_VOXEL = dict(voxel_size=[0.25, 0.25, 8], pc_range=[-50, -50, -5, 50, 50, 3],
                max_points=64, max_voxels=30000)
PC_FPS = (8, 20000, 2048)
PC_BOXES = 4096
PC_POOL_BOXES = 200
SPCONV_GRID = (1408, 1600, 41)
SPCONV_SITES = 20000
SPCONV_CHECK_GRID = (128, 128, 16)


def pc_inputs():
    """Seeded inputs on the card: a 10-sweep nuScenes-size cloud (x, y
    spread around the ego, denser near it; z near the ground; intensity;
    the sweep's time lag), ScanNet-size scenes for FPS (8 rooms of 8 x 8 x
    3 m), boxes with their scores."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(3)
    dev = "cuda"
    n = PC_NUSC_POINTS
    r = 1.0 + 59.0 * torch.rand(n, device=dev, generator=g) ** 2
    a = 2 * torch.pi * torch.rand(n, device=dev, generator=g)
    cloud = torch.stack([r * torch.cos(a), r * torch.sin(a),
                         -1.8 + 2.5 * torch.rand(n, device=dev, generator=g),
                         torch.rand(n, device=dev, generator=g),
                         0.5 * torch.randint(0, 10, (n,), device=dev, generator=g).float()], -1)
    B, N, _ = PC_FPS
    rooms = torch.rand((B, N, 3), device=dev, generator=g) * torch.tensor([8.0, 8.0, 3.0],
                                                                          device=dev)

    def boxes(m):
        ctr = (torch.rand((m, 3), device=dev, generator=g) - 0.5) * torch.tensor(
            [100.0, 100.0, 2.0], device=dev)
        dims = 0.5 + 4.0 * torch.rand((m, 3), device=dev, generator=g)
        yaw = (torch.rand((m, 1), device=dev, generator=g) - 0.5) * 2 * torch.pi
        return torch.cat([ctr, dims, yaw], -1)

    return {"cloud": cloud, "rooms": rooms, "boxes": boxes(PC_BOXES),
            "scores": torch.rand(PC_BOXES, device=dev, generator=g),
            "pool_boxes": boxes(PC_POOL_BOXES), "g": g}


def spconv_sites(grid, n, C, g):
    """``n`` distinct active sites of ``grid`` (seeded) with C features."""
    import torch

    X, Y, Z = grid
    lin = torch.randperm(X * Y * Z, device="cuda", generator=g)[:n] if X * Y * Z < 2 ** 24 \
        else torch.unique(torch.randint(0, X * Y * Z, (2 * n,), device="cuda",
                                        generator=g))[:n]
    lin = lin[torch.randperm(lin.shape[0], device="cuda", generator=g)]
    coords = torch.stack([lin // (Y * Z), (lin // Z) % Y, lin % Z], -1).to(torch.int32)
    feats = torch.randn((n, C), device="cuda", generator=g)
    return feats, coords, torch.ones(n, dtype=torch.bool, device="cuda")


def phase_pointcloud():
    """The point-cloud ops and sparse convolutions on the card at the sizes
    their users run: hard voxelization of a 10-sweep nuScenes cloud of
    300,000 points x 5 features (voxel [0.25, 0.25, 8], range [-50, -50,
    -5, 50, 50, 3], 64 points, 30,000 voxels: mmdetection3d's
    hv_pointpillars_fpn_nus config); FPS [8, 20000, 3] -> 2048 (VoteNet's
    PointNet++ SA1 on ScanNet), ball_query (radius 0.2, 64 samples) and
    group_points on those centres, three_nn / three_interpolate from 2048 to
    20,000 points; SubMConv3d 16 -> 16 and a strided SparseConv3d 16 -> 32
    on the gather backend at SECOND's KITTI grid (1408, 1600, 41) with
    20,000 active sites (SECOND's middle encoder); boxes_iou_bev and nms_bev
    on 4,096 boxes, points_in_boxes of the 300,000 points in 200 boxes and
    roiaware_pool3d (T = 7) there.  The main path's run: every op once with
    the launch counts set to 0 before and read after (FPS once, nothing
    else).  Then FPS held to its plain version (indices equal, also with
    invalid points), timed beside it and its bound, its microseconds a step
    and its cluster size; each op timed; the
    sparse convs' gather backend held to the dense one at [128, 128, 16]."""
    import torch

    from occformer_tpu_torch.ops import pointcloud as pc
    from occformer_tpu_torch.ops import spconv

    inp = pc_inputs()
    g = inp["g"]
    cloud, rooms = inp["cloud"], inp["rooms"]
    B, N, npoint = PC_FPS
    valid_cloud = torch.ones(cloud.shape[0], dtype=torch.bool, device="cuda")
    room_feats = torch.cat([rooms, rooms[..., 2:3]], -1)  # xyz and height
    fp_feats = torch.randn((B, npoint, 256), device="cuda", generator=g)
    sub = spconv.SubMConv3d(16, 16, backend="gather").cuda()
    # room for every output site: an active input feeds up to 8 at stride 2
    down = spconv.SparseConv3d(16, 32, stride=2, max_out_sites=8 * SPCONV_SITES,
                               backend="gather").cuda()
    sp_feats, sp_coords, sp_valid = spconv_sites(SPCONV_GRID, SPCONV_SITES, 16, g)
    pool_feats = torch.randn((cloud.shape[0], 16), device="cuda", generator=g)
    bev = inp["boxes"][:, [0, 1, 3, 4, 6]]
    state = {}

    def fps():
        state["idx"] = pc.furthest_point_sample(rooms, npoint)
        state["centres"] = pc.gather_points(rooms, state["idx"])
        return state["idx"]

    def ball():
        state["ball"] = pc.ball_query(rooms, state["centres"], 0.2, 64)
        return state["ball"]

    def nn3():
        state["nn"] = pc.three_nn(rooms, state["centres"])
        return state["nn"]

    ops = {
        "hard_voxelize": lambda: pc.hard_voxelize(cloud, valid_cloud, **PC_VOXEL),
        "furthest_point_sample": fps,
        "ball_query": ball,
        "group_points": lambda: pc.group_points(room_feats, state["ball"]),
        "three_nn": nn3,
        "three_interpolate": lambda: pc.three_interpolate(
            fp_feats, state["nn"][1], torch.full_like(state["nn"][0], 1.0 / 3)),
        "subm_conv3d_gather": lambda: sub(sp_feats, sp_coords, sp_valid, SPCONV_GRID),
        "sparse_conv3d_gather": lambda: down(sp_feats, sp_coords, sp_valid, SPCONV_GRID),
        "boxes_iou_bev": lambda: pc.boxes_iou_bev(bev, bev),
        "nms_bev": lambda: pc.nms_bev(bev, inp["scores"], 0.2),
        "points_in_boxes": lambda: pc.points_in_boxes(cloud[None, :, :3],
                                                      inp["pool_boxes"][None]),
        "roiaware_pool3d": lambda: pc.roiaware_pool3d(cloud[:, :3], pool_feats,
                                                      inp["pool_boxes"], 7, "max"),
    }
    rec = {"phase": "pointcloud"}
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        reset_launches()  # the main path's run starts here
        outs = {}
        for name, fn in ops.items():
            outs[name] = fn()
        torch.cuda.synchronize()
        n = launches()  # ... and ends here
        check(n == POINTCLOUD_LAUNCHES, f"pointcloud launches {n}, want {POINTCLOUD_LAUNCHES}")
        rec["launches"] = n
        rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        vox, vcoords, nump = outs["hard_voxelize"]
        rec["hard_voxelize_voxels"] = int((nump > 0).sum())
        rec["hard_voxelize_points_kept"] = int(nump.sum())
        rec["nms_kept"] = int(outs["nms_bev"].sum())
        rec["points_in_boxes"] = int(outs["points_in_boxes"].sum())
        check(bool(torch.isfinite(outs["three_interpolate"]).all())
              and bool(torch.isfinite(outs["roiaware_pool3d"]).all())
              and bool(torch.isfinite(outs["boxes_iou_bev"]).all()), "pointcloud: non-finite")
        check(int(outs["sparse_conv3d_gather"][2].sum()) > 0, "pointcloud: no strided sites")
        rec["sparse_conv3d_out_sites"] = int(outs["sparse_conv3d_gather"][2].sum())
        del outs, vox

        # FPS: the kernel against its plain version, indices equal
        idx = pc.furthest_point_sample(rooms, npoint)
        plain_idx = pc.furthest_point_sample_plain(rooms, npoint)
        check(torch.equal(idx, plain_idx), "FPS: indices differ from the plain version")
        vmask = torch.rand((B, N), device="cuda", generator=g) > 0.3
        check(torch.equal(pc.furthest_point_sample(rooms, npoint, vmask),
                          pc.furthest_point_sample_plain(rooms, npoint, vmask)),
              "FPS: indices differ from the plain version with invalid points")
        ms = {"plain": [], "kernel": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            fn = pc.furthest_point_sample_plain if name == "plain" else pc.furthest_point_sample
            ms[name].append(time_cuda(lambda: fn(rooms, npoint), iters=2, warmup=1))
        fps = {"max_abs_err": 0.0, "indices_equal": True, "indices_equal_with_invalid": True,
               "shapes": [B, N, npoint], "ms_in_turns": ms, "kernel_ms": sum(ms["kernel"]) / 2,
               "plain_ms": sum(ms["plain"]) / 2, "library_ms": None}
        fps["device_ms"] = device_ms(lambda: pc.furthest_point_sample(rooms, npoint), 10)
        # the steps depend on each other: a step's latency is FPS's yardstick
        fps["us_per_step"] = fps["device_ms"] * 1e3 / (npoint - 1)
        fps["cluster_ctas"] = pc.FPS_CLUSTER
        # 9 float32 operations a point a step (csrc/furthest_point_sample.cu)
        fps.update(bound(nbytes(rooms, idx), 9 * B * N * (npoint - 1)))
        rec["FPS"] = fps

        # every op's time (median of CUDA-event timed calls)
        rec["ms"] = {name: time_cuda(fn, iters=2, warmup=1) for name, fn in ops.items()}

        # the gather backend against the dense one where densifying is cheap
        f, c, v = spconv_sites(SPCONV_CHECK_GRID, SPCONV_SITES, 16, g)
        sub_d = spconv.SubMConv3d(16, 16).cuda()
        sub_d.load_state_dict(sub.state_dict())
        down_d = spconv.SparseConv3d(16, 32, stride=2, max_out_sites=8 * SPCONV_SITES).cuda()
        down_d.load_state_dict(down.state_dict())
        rec["subm_conv3d_gather_vs_dense"] = compare(
            sub(f, c, v, SPCONV_CHECK_GRID)[0], sub_d(f, c, v, SPCONV_CHECK_GRID)[0], 1e-5,
            "SubMConv3d gather vs dense")
        a, b = down(f, c, v, SPCONV_CHECK_GRID), down_d(f, c, v, SPCONV_CHECK_GRID)
        check(torch.equal(a[1], b[1]) and torch.equal(a[2], b[2]),
              "SparseConv3d: the backends' active sets differ")
        rec["sparse_conv3d_gather_vs_dense"] = compare(a[0], b[0], 1e-5,
                                                       "SparseConv3d gather vs dense")
    emit(rec)
    return rec, n


def phase_soak(steps=8):
    """``tools/soak.py`` at the flagship's full width on the default loss
    route: ``steps`` steps on one fixed batch with the checkpoint at the
    middle step (saved, loaded into a fresh model and optimizer, every
    tensor held bit-equal, training going on from it), then the same steps
    again without the checkpoint: the two trajectories (every loss and
    grad_norm) and the final states must be equal, and the loss must fall.
    The launch counts cover both runs."""
    import torch

    from occformer_tpu_torch.config import load_config
    from occformer_tpu_torch.tools.soak import soak

    cfg = load_config(CONFIG)
    work = tempfile.mkdtemp(prefix="occformer_soak_")
    try:
        reset_launches()  # the main path's run starts here
        rec = soak(cfg, "auto", steps, steps // 2, 0, work, log=lambda s: None)
        n = launches()  # ... and ends here
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rec = dict(rec, phase="soak", config="occformer_nusc_r50_256x704", launches=n)
    want = {k: v * 2 * steps for k, v in TRAIN_LAUNCHES["off"].items()}
    check(n == want, f"soak launches {n} in 2 x {steps} steps, want {want}")
    check(rec["mid_run_reload_bit_equal"] is True, f"soak reload: {rec['events']}")
    check(rec["replay"]["trajectory_equal"] and rec["replay"]["final_state_equal"],
          f"soak replay differs: {rec['replay']}")
    check(rec["loss_falls"] and rec["loss_last"] < rec["loss_first"],
          f"soak loss did not fall: {rec['loss_first']} -> {rec['loss_last']}")
    emit(rec)
    free_memory()
    return n


def phase_learn():
    """The tiny held-out learnability run of
    ``tests/test_torch_geometric_learnability.py`` on the card: the tiny
    model trained 300 steps on 12 box scenes of the 2-camera rig, float32,
    then the 4 held-out scenes; held-out SC IoU > 0.15 and class mIoU (every
    foreground class) > 0.08, the JAX test's thresholds."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import tiny_cfg

    from occformer_tpu_torch.engine.train import build_loss_cfg
    from occformer_tpu_torch.tools.synthetic_geo_benchmark import train_geo

    cfg = tiny_cfg.model_cfg()
    loss_cfg = build_loss_cfg(cfg["pts_bbox_head"], dict(
        num_points=128, oversample_ratio=2.0, importance_sample_ratio=0.75))
    reset_launches()  # the main path's run starts here
    rec = train_geo(cfg, loss_cfg, "tiny", steps=300, train_scenes=12, test_scenes=4,
                    device="cuda", lr=3e-4)
    n = launches()  # ... and ends here
    rec = dict(rec, phase="learn", launches=n,
               launches_per_step={k: v / 300 for k, v in n.items()})
    check(all(n[k] > 0 for k in ("K1", "K1-bwd", "K2", "K2-bwd", "S1", "S1-bwd")),
          f"learn launches {n}")
    check(rec["heldout_SC_IoU"] > 0.15, f"held-out SC IoU {rec['heldout_SC_IoU']} "
          f"(chance {rec['chance_SC_IoU']})")
    check(rec["heldout_mIoU_all_classes"] > 0.08,
          f"held-out class mIoU {rec['heldout_mIoU_all_classes']}")
    emit(rec)
    free_memory()
    return n


def phase_ddp():
    """World size 1 under ``nccl`` and ``DistributedDataParallel``
    (``engine/train.py:wrap_ddp``): two flagship train steps from the same
    seed and batch as two plain steps must repeat their losses, grad_norm
    and every gradient (captured before the optimizer touches them) bit for
    bit, and leave the same parameters without a gradient (the frozen stem,
    which DDP's search for unused parameters must skip)."""
    import socket

    import torch
    import torch.distributed as dist

    from occformer_tpu_torch.config import load_config
    from occformer_tpu_torch.data.synthetic import make_train_batch
    from occformer_tpu_torch.engine.eval import to_device_batch
    from occformer_tpu_torch.engine.optim import build_optimizer_from_config
    from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step, wrap_ddp
    from occformer_tpu_torch.models.detector import build_model
    from occformer_tpu_torch.tools.train import step_generator

    cfg = load_config(CONFIG)
    m = cfg["model"]
    loss_cfg = build_loss_cfg(m["pts_bbox_head"], m["train_cfg"]["pts"])
    batch = to_device_batch(make_train_batch(cfg, seed=0), torch.device("cuda"))

    def two_steps(ddp):
        model = build_model(m, device="cuda", dtype=torch.float32, seed=0).train()
        opt = build_optimizer_from_config(model, cfg, 28130)
        grads, missing, step_s = [], [], []
        adamw_step = opt.step

        def capture():  # the gradients as the backward (and DDP) left them
            missing.append([k for k, p in model.named_parameters() if p.grad is None])
            grads.append({k: p.grad.clone() for k, p in model.named_parameters()
                          if p.grad is not None})
            return adamw_step()

        opt.step = capture
        step = build_train_step(wrap_ddp(model) if ddp else model, opt, loss_cfg,
                                device="cuda", compute_dtype=torch.bfloat16)
        metrics = []
        for k in range(2):
            t = time.perf_counter()
            out = step(batch, step_generator(0, k, torch.device("cuda")))
            metrics.append({name: float(v) for name, v in out.items()})
            step_s.append(time.perf_counter() - t)
        return metrics, grads, missing, step_s

    plain = two_steps(False)
    free_memory()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0)
    try:
        reset_launches()  # the main path's run starts here
        ddp = two_steps(True)
        n = launches()  # ... and ends here
    finally:
        dist.destroy_process_group()
    grads_differ = [[k for k, g in ref.items() if not torch.equal(g, got[k])]
                    for ref, got in zip(plain[1], ddp[1])]
    rec = {"phase": "ddp", "config": "occformer_nusc_r50_256x704", "world_size": 1,
           "backend": "nccl", "steps": 2, "launches": n,
           "plain_metrics": plain[0], "ddp_metrics": ddp[0],
           "metrics_equal": all(same_metrics(a, b) for a, b in zip(plain[0], ddp[0])),
           "gradients": len(plain[1][0]),
           "gradients_differing": [len(d) for d in grads_differ],
           "names_differing": [d[:5] for d in grads_differ],
           "parameters_without_gradient": ddp[2],
           "plain_step_s": plain[3], "ddp_step_s": ddp[3]}
    emit(rec)
    want = {k: v * 2 for k, v in TRAIN_LAUNCHES["off"].items()}
    check(n == want, f"ddp launches {n} in 2 steps, want {want}")
    check(ddp[2] == plain[2], f"parameters without a gradient: {ddp[2]} / {plain[2]}")
    check(rec["metrics_equal"], f"DDP metrics differ: {plain[0]} / {ddp[0]}")
    check(not any(grads_differ), f"DDP gradients differ: {rec['names_differing']}")
    del plain, ddp
    free_memory()
    return n


# the port's CUDA kernels by function name -> the kernel they belong to;
# the counting sort of csrc/segment_sort.cuh runs six functions per launch
# of K2-bwd's two paths and of S1, and the binning, span sorts, entry scales
# (K1-bwd only) and corner reduce of csrc/ordered_rows.cuh ten per launch of
# K1-bwd and nine of K4-bwd, told apart by their key or geometry type (a
# template argument); the path's
# gather, splat or corner reduce (one per launch) counts the launches; S1's
# second splat kernel (its heavy voxels) runs beside it, K1-bwd's
# sample-major kernel and K4-bwd's coordinate kernel before the binning;
# S1-rows' count, scan, fill and rank kernels before its splat; S1-bwd's and
# S1-rows-bwd's transposes of a transposed gradient before their gathers
PORT_KERNELS = {"ms_deform_gather3d_kernel": "K1", "ms_deform_gather3d_rows_kernel": "K1.row",
                "ms_deform_bwd_samples_kernel": "K1-bwd",
                "trilerp_fwd_narrow_kernel": "K2", "trilerp_fwd_rows_kernel": "K2.row",
                "trilerp_bwd_gather_kernel": "K2-bwd",
                "trilerp_bwd_tiles_kernel": "K2-bwd.narrow",
                "trilerp_bwd_coords_kernel": "K2-bwd",
                "label_shared_kernel": "K3", "label_per_slot_kernel": "K3",
                "multilevel_fwd_kernel": "K4", "multilevel_fwd_rows_kernel": "K4.row",
                "multilevel_bwd_coords_kernel": "K4-bwd",
                "add_one_kernel": "P1", "row_gather_kernel": "P2",
                "voxel_splat_kernel": "S1", "voxel_splat_heavy_kernel": "S1",
                "voxel_splat_bwd_kernel": "S1-bwd", "s1_bwd_transpose_kernel": "S1-bwd",
                "rows_bwd_kernel": "S1-rows-bwd", "rows_bwd_transpose_kernel": "S1-rows-bwd",
                "rows_count_kernel": "S1-rows", "rows_scan_kernel": "S1-rows",
                "rows_fill_kernel": "S1-rows", "rows_rank_kernel": "S1-rows",
                "rows_splat_kernel": "S1-rows", "fps_kernel": "FPS"}
_UNCOUNTED = {"voxel_splat_heavy_kernel", "ms_deform_bwd_samples_kernel",
              "multilevel_bwd_coords_kernel", "rows_count_kernel", "rows_scan_kernel",
              "rows_fill_kernel", "rows_rank_kernel", "s1_bwd_transpose_kernel",
              "rows_bwd_transpose_kernel"}
_SORT_STEPS = {"seg_count_kernel", "scan_tiles_kernel", "scan_sums_kernel",
               "add_tile_offsets_kernel", "seg_fill_kernel", "seg_rank_kernel",
               "seg_fill_entries_kernel", "span_sort_warp_kernel", "span_sort_block_kernel",
               "heavy_bins_kernel", "entry_scale_kernel", "corner_reduce_kernel"}
_COUNTED_STEPS = {"corner_reduce_kernel"}
_SORT_KEYS = {"CornerKeys": "K2-bwd", "ColumnKeys": "K2-bwd.narrow", "SplatKeys": "S1",
              "K1Keys": "K1-bwd", "K1Geo": "K1-bwd", "K4Keys": "K4-bwd", "K4Geo": "K4-bwd"}


def port_kernel_ms(kernels):
    """Device ms and launches of the port's kernels among profiled kernel
    events, by kernel (K2's forward apart by path and table type: the bf16
    feature on the row-wide path, the bool GT, float32 volumes; K2-bwd's two
    paths and S1 each summed over their sort's six functions and their gather
    or splat, S1-rows over its five kernels, K1-bwd and K4-bwd over their
    sample kernel and the steps of csrc/ordered_rows.cuh) and by CUDA
    function."""
    import re

    by_kernel, by_function = {}, {}
    for e in kernels:
        m = re.match(r"(?:void )?(\w+)(<[^(]*>)?\(", e.key)
        if not m:
            continue
        if m.group(1) in _SORT_STEPS:
            name = next((v for k, v in _SORT_KEYS.items()
                         if re.search(rf"\b{k}\b", m.group(2) or "")), None)
        else:
            name = PORT_KERNELS.get(m.group(1))
            if name and m.group(1).startswith("trilerp_fwd"):
                name += " " + m.group(2)
        if name is None:
            continue
        counted = m.group(1) in _COUNTED_STEPS or (m.group(1) not in _SORT_STEPS
                                                   and m.group(1) not in _UNCOUNTED)
        for key, table, n in ((name, by_kernel, counted),
                              (m.group(1) + (m.group(2) or ""), by_function, True)):
            r = table.setdefault(key, {"launches": 0, "device_ms": 0.0})
            r["launches"] += e.count if n else 0
            r["device_ms"] += e.self_device_time_total / 1e3
    return {"by_kernel": by_kernel, "by_function": by_function}


def traced_launches(by_kernel):
    """``port_kernel_ms``'s launches by kernel in the keys of the launch
    counts (SERVE_LAUNCHES): "K1", "K2", "K2-bwd" and "K4" count both of
    their paths, K2's forward summed over its template instances."""
    n = dict(_NONE)
    for key, r in by_kernel.items():
        name = key.split(" ")[0]
        n[name] += r["launches"]
        if name in ("K1.row", "K2.row", "K4.row", "K2-bwd.narrow"):
            n[name.split(".")[0]] += r["launches"]
    return n


def profile(run, outer, want, top=12, forbid=()):
    """torch.profiler over one more call of ``run``: host and device time of
    each ``stage:*`` range (``outer`` names the outermost ones, which must
    all appear), device time by kernel name and by operator and input shape,
    and the device's busy share of the call's wall time (the profiler's own
    overhead included).  The port's kernel launches in the trace must equal
    ``want``, one call's counts, so that a trace that dropped events cannot
    feed a busy share or a stage's time: such a trace is taken again, up to
    ``TRACE_ATTEMPTS`` traces, and the run fails if none holds them all; no
    operator named in ``forbid`` may appear."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from occformer_tpu_torch.utils.timing import device_kernels, lead_in

    run()
    torch.cuda.synchronize()
    for _ in range(TRACE_ATTEMPTS):
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                           record_shapes=True) as prof:
            lead_in()
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        events = prof.key_averages()
        if traced_launches(port_kernel_ms(
                [e for e in events if e.device_type.name == "CUDA"])["by_kernel"]) == want:
            break
    stages = {e.key[len("stage:"):]: {"host_ms": e.cpu_time_total / 1e3,
                                      "device_ms": e.device_time_total / 1e3}
              for e in events
              if e.device_type.name == "CPU" and e.key.startswith("stage:")}
    missing = [k for k in outer if k not in stages]
    check(not missing, f"profiled stages {sorted(stages)} lack {missing}")
    # device rows of annotated ranges (the stages, torch.optim's
    # ``Optimizer.step#...``) span kernels; they are not kernels, nor is the
    # lead-in
    kernels = device_kernels(events)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type.name == "CPU" and e.key.startswith("aten::")]
    seen = sorted({e.key for e in ops} & set(forbid))
    check(not seen, f"profiled operators {seen} are not on this path")
    ops.sort(key=lambda e: e.self_device_time_total, reverse=True)
    # kernels that no outermost stage launched from the calling thread: for
    # the train step, the backward's, which autograd launches from its own
    # thread
    outside = device_ms - sum(stages[k]["device_ms"] for k in outer if k in stages)
    port = port_kernel_ms(kernels)
    traced = traced_launches(port["by_kernel"])
    check(traced == want, f"profiled port-kernel launches {traced}, want {want}")
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "stages": stages, "device_ms_outside_outer_stages": outside,
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "device_ms": e.self_device_time_total / 1e3}
                            for e in kernels[:top]],
            "top_ops": [{"name": e.key, "shapes": str(e.input_shapes)[:120],
                         "calls": e.count, "device_ms": e.self_device_time_total / 1e3}
                        for e in ops[:top]],
            "port_kernels": port}


def kernel_records(kern, probe, det, paths, kitti, r101, pan, stereo, voxnet, pointcloud):
    """One record per kernel path; ``paths`` maps each driven path (serve,
    train, train_batched, the pipeline-fed train steps and frames, the K4
    gate, the probe) to its launch counts, and
    a record's ``launches`` sums them.  K2 and K2-bwd each have two paths,
    two records (K2's "scalar" record is its narrow kernel at the GT masks,
    with the GT table and the batched readouts under ``readouts``); K1 and K4
    are one row-wide kernel each (every launch of either is row-wide: the
    run fails otherwise), their records at the flagship's 16-byte rows with
    their other rows, held and timed in the kernels phase, under
    ``other_rows``; K4's and K4-bwd's records are at the DepthNet DCN's
    shapes, the main path's, with the deformable attention's under
    ``attention_shapes``.  Records carry the profiler's device ms beside
    the event times where the kernels phase took them, and under ``kitti``
    the kernel at the SemanticKITTI path's shapes (``phase_kitti_kernels``;
    K2's narrow record at the candidates, with the matching readout under
    K2's row-wide record), and under ``r101`` the kernel at the R101-DCN
    path's shapes (``phase_r101_kernels``: K4 and K4-bwd at layer3's DCNv2,
    layer4's and the DepthNet's under ``layer4`` / ``depthnet``; S1 at the
    896 x 1600 frustum; the other kernels run at the flagship's shapes
    there), and under ``pan`` the kernel at the panoptic path's shapes
    (``phase_pan_kernels``: K2's row-wide record and K2-bwd's segmented one
    at the random fill of 100 slots, K2's narrow record at the 100-slot GT
    table (candidates; the matching points under ``matching``), K3 at the
    panoptic ids (shared; per-slot under ``per_slot``); the other kernels
    run at the flagship's shapes there), and under ``stereo`` K4's and
    K4-bwd's records at BEVStereo's shapes (``phase_stereo_kernels``: the
    stereo warp, its backward without d_coords, with the mask warp and the
    DepthNetStereo's DCN under ``mask_warp`` / ``dcn``; the 4D model runs
    every kernel at the flagship's shapes).  S1-rows' record is at the
    use_voxel_net flagship's shapes in bf16 (``phase_voxnet_kernels``; the
    float32 one under ``float32``), FPS's at VoteNet's SA1
    (``phase_pointcloud``); neither runs on the other configurations'
    paths."""
    src = "occformer_tpu_torch/csrc/"
    timing = probe["timing"]
    for p, n in paths.items():
        check(n["K1"] == n["K1.row"] and n["K4"] == n["K4.row"],
              f"{p}: a K1 or K4 launch that is not row-wide: {n}")
    paths = {p: dict(n, **{"K2.scalar": n["K2"] - n["K2.row"],
                           "K2-bwd.segmented": n["K2-bwd"] - n["K2-bwd.narrow"]})
             for p, n in paths.items()}
    k1 = dict(kern["K1"]["bf16"], other_rows=kern["K1"]["other_rows"])
    readouts = dict(kern["K2"]["batched"], gt_table=kern["K2"]["per_slot_gt"]["gt_table"])
    k2_narrow = dict(kern["K2"]["per_slot_gt"], readouts={
        name: {k: r[k] for k in ("max_abs_err", "kernel_ms", "device_ms", "plain_ms",
                                 "bound_ms", "library_ms", "library_device_ms")}
        for name, r in readouts.items()})
    rows = [
        ("ms_deform_gather_3d", "row", "K1.row", src + "ms_deform_gather3d.cu",
         "occformer_tpu/ops/trilerp_fused.py:284", k1),
        ("ms_deform_gather_3d_bwd", "", "K1-bwd", src + "ms_deform_gather3d.cu",
         "occformer_tpu/ops/trilerp_fused.py:354", kern["K1-bwd"]["bf16"]),
        ("trilerp_sample", "row", "K2.row", src + "trilerp_sample3d.cu",
         "occformer_tpu/ops/trilerp.py:476", kern["K2"]),
        ("trilerp_sample", "scalar", "K2.scalar", src + "trilerp_sample3d.cu",
         "occformer_tpu/ops/trilerp.py:476", k2_narrow),
        ("trilerp_sample_bwd", "segmented", "K2-bwd.segmented", src + "trilerp_sample3d.cu",
         "occformer_tpu/ops/trilerp.py:493", kern["K2-bwd"]),
        ("trilerp_sample_bwd", "narrow", "K2-bwd.narrow", src + "trilerp_sample3d.cu",
         "occformer_tpu/ops/trilerp.py:493", kern["K2-bwd"]["batched"]["candidates"]),
        ("sample_id_masks", "", "K3", src + "label_gather3d.cu",
         "occformer_tpu/ops/loss_gather.py:127", kern["K3"]["candidates"]),
        # at the DCN's shapes, the main path's; the deformable attention's
        # (the K4 gate's flagship case) under "attention_shapes"
        ("fused_multilevel_gather", "row", "K4.row", src + "multilevel_gather3d.cu",
         "occformer_tpu/ops/trilerp_fused.py:495",
         dict(kern["K4"], attention_shapes=kern["K4_attention"],
              other_rows=kern["K4_attention"]["other_rows"])),
        ("fused_multilevel_gather_bwd", "", "K4-bwd", src + "multilevel_gather3d.cu",
         "occformer_tpu/ops/trilerp_fused.py:511",
         dict(kern["K4-bwd"], attention_shapes=kern["K4-bwd_attention"])),
        ("add_one", "", "P1", src + "probe.cu", "tools/probe_pallas_viability.py:41",
         dict(timing["add_one"], kernel_ms=timing["add_one"]["ms"],
              max_abs_err=probe["add_one_max_abs_err"])),
        ("row_gather", "", "P2", src + "probe.cu", "tools/probe_pallas_viability.py:67",
         dict(timing["row_gather"], kernel_ms=timing["row_gather"]["ms"],
              max_abs_err=probe["row_gather_max_abs_err"])),
        # not a Pallas kernel's port: the JAX package leaves the splat to XLA
        # and its backward to autodiff (a gather of the cotangent)
        ("voxel_scatter_lifted", "", "S1", src + "voxel_splat.cu",
         "occformer_tpu/ops/scatter.py:55", det["S1"]),
        ("voxel_scatter_lifted_bwd", "", "S1-bwd", src + "voxel_splat.cu",
         "occformer_tpu/ops/scatter.py:55", det["S1"]["backward"]),
        # nor these: XLA's segment_sum and a fori_loop in the JAX package
        ("voxel_scatter", "", "S1-rows", src + "voxel_splat.cu",
         "occformer_tpu/ops/scatter.py:20", dict(voxnet["bfloat16"], float32={
             k: voxnet["float32"][k] for k in ("max_abs_err", "kernel_ms", "device_ms",
                                               "plain_ms", "bound_ms", "library_ms")})),
        ("voxel_scatter_bwd", "", "S1-rows-bwd", src + "voxel_splat.cu",
         "occformer_tpu/ops/scatter.py:20", dict(voxnet["bfloat16"]["backward"], float32={
             k: voxnet["float32"]["backward"][k] for k in (
                 "max_abs_err", "kernel_ms", "device_ms", "plain_ms", "bound_ms",
                 "library_ms")})),
        ("furthest_point_sample", "", "FPS", src + "furthest_point_sample.cu",
         "occformer_tpu/ops/pointcloud.py:161", pointcloud["FPS"]),
    ]
    new_keys = ("S1-rows", "S1-rows-bwd", "FPS")
    at_kitti = {"K1.row": kitti["K1"], "K1-bwd": kitti["K1-bwd"],
                "K2.row": kitti["K2_matching"], "K2.scalar": kitti["K2_candidates"],
                "K2-bwd.narrow": kitti["K2-bwd"], "K4.row": kitti["K4"],
                "K4-bwd": kitti["K4-bwd"], "S1": kitti["S1"],
                "S1-bwd": kitti["S1"]["backward"]}
    kitti_keys = ("max_abs_err", "kernel_ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms", "table", "points")

    def at_r101(key):
        if key in ("S1", "S1-bwd"):
            r = r101["S1"] if key == "S1" else r101["S1"]["backward"]
            return {k: r[k] for k in kitti_keys + ("device_ms", "points_valid", "shapes")
                    if k in r}
        if key not in ("K4.row", "K4-bwd"):
            return {"shapes": "the flagship's (the same pixel decoder, LSS grid and loss)"}
        k = key.split(".")[0]
        out = {}
        for name, shape in R101_DCN_SHAPES.items():
            r = {f: r101[f"K4_dcn_{name}"][k][f] for f in kitti_keys
                 if f in r101[f"K4_dcn_{name}"][k]}
            r["map"] = list(shape)
            if name == "layer3":
                out.update(r)
            else:
                out[name] = r
        return out

    at_pan = {"K2.row": pan["K2_random_fill"],
              "K2.scalar": dict(pan["K2_gt_table_candidates"],
                                matching={k: pan["K2_gt_table_matching"][k]
                                          for k in kitti_keys + ("device_ms",)
                                          if k in pan["K2_gt_table_matching"]}),
              "K2-bwd.segmented": pan["K2-bwd_random_fill"],
              "K3": dict(pan["K3_shared"], per_slot={k: pan["K3_per_slot"][k]
                                                     for k in kitti_keys + ("device_ms",)
                                                     if k in pan["K3_per_slot"]})}

    def at_panoptic(key):
        if key in ("P1", "P2"):
            return {"shapes": "not on this path"}
        if key not in at_pan:
            return {"shapes": "the flagship's (the same model but for 150 queries)"}
        r = at_pan[key]
        return {k: r[k] for k in kitti_keys + ("device_ms", "library_device_ms", "matching",
                                               "per_slot") if k in r}

    def at_stereo(key):
        if key not in ("K4.row", "K4-bwd"):
            return {"shapes": "the flagship's (the 4D model); not on BEVStereo's path"
                    if key != "S1" else "the flagship's grid and frustum"}
        k = key.split(".")[0]
        out = {f: stereo["stereo_warp"][k][f] for f in kitti_keys + ("device_ms", "with_d_coords")
               if f in stereo["stereo_warp"][k]}
        out["table"] = stereo["stereo_warp"]["shapes"]["table"]
        for name in ("mask_warp", "dcn"):
            if k == "K4-bwd" and name == "mask_warp":
                continue  # the mask's inputs are detached: no K4-bwd on the path
            r = stereo[name][k]
            out[name] = dict({f: r[f] for f in kitti_keys + ("device_ms",) if f in r},
                             table=stereo[name]["shapes"]["table"])
        return out

    return [{"name": name + (f".{path}" if path else ""), "path": path or None, "route": "cuda",
             "source": source, "replaces": replaces,
             "launches": sum(n[key] for n in paths.values()),
             **{f"launches_{p}": n[key] for p, n in paths.items()},
             "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "library_ms": r.get("library_ms"),
             **{k: r[k] for k in ("device_ms", "library_device_ms", "random_order_ms",
                                  "random_order_device_ms", "readouts", "attention_shapes",
                                  "other_rows",
                                  "launch_floor_ms", "bound_with_floor_ms",
                                  "device_ms_by_kernel", "us_per_step", "cluster_ctas")
                if k in r},
             **({"kitti": {k: at_kitti[key][k] for k in kitti_keys if k in at_kitti[key]}}
                if key in at_kitti else {}),
             **({"float32": r["float32"]} if "float32" in r else {}),
             **({} if key in new_keys else {"r101": at_r101(key), "pan": at_panoptic(key),
                                            "stereo": at_stereo(key)})}
            for name, path, key, source, replaces, r in rows]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from occformer_tpu_torch.ops import cuda_build
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}", file=sys.stderr)
        return 2
    # float32 references: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    start = time.perf_counter()
    probe = phase_probe()  # before any other build: a broken toolchain fails here
    t0 = time.perf_counter()
    report = cuda_build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {k: {"seconds": v["seconds"],
                          "ptxas": [ln for ln in v["log"].splitlines() if "ptxas" in ln]}
                      for k, v in report.items()}})
    wall = {"probe_and_build": time.perf_counter() - start}

    def timed(name, fn, *args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        wall[name] = time.perf_counter() - t
        free_memory()
        return out

    # the SemanticKITTI tree serves every KITTI phase; its kernels phase runs
    # beside the flagship's (late in a long process the profiler has dropped
    # some runs' device events), the rest after the flagship's paths; so do
    # the R101-DCN's and the panoptic one's, on a one-sample nuScenes tree
    # with panoptic sidecars (their other phases use the data phase's tree,
    # which has the sidecars too)
    from occformer_tpu_torch.data.fixtures import make_kitti_tree, make_nuscenes_tree

    kitti_root = tempfile.mkdtemp(prefix="occformer_kitti_")
    r101_root = tempfile.mkdtemp(prefix="occformer_r101_")
    try:
        t = time.perf_counter()
        make_kitti_tree(kitti_root)
        wall["kitti_tree"] = time.perf_counter() - t
        t = time.perf_counter()
        # with panoptic sidecars: pan_kernels reads its first frame's GT too
        r101_ann = make_nuscenes_tree(r101_root, n_samples=1, n_points=34000, seed=0,
                                      panoptic=True)
        wall["r101_tree"] = time.perf_counter() - t
        serve_n = timed("serve", phase_serve)
        kern = timed("kernels", phase_kernels)
        kitti_kern = timed("kitti_kernels", phase_kitti_kernels, kitti_root)
        r101_kern = timed("r101_kernels", phase_r101_kernels, r101_root, r101_ann)
        pan_kern = timed("pan_kernels", phase_pan_kernels, r101_root, r101_ann)
        stereo_kern = timed("stereo_kernels", phase_stereo_kernels, r101_root, r101_ann)
        voxnet_kern = timed("voxnet_kernels", phase_voxnet_kernels, r101_root, r101_ann)
        pc_rec, pc_n = timed("pointcloud", phase_pointcloud)
        timed("tiny", phase_tiny)
        timed("tiny_train", phase_tiny_train, "off")
        timed("tiny_train_batched", phase_tiny_train, "on")
        timed("tiny_train_accum", phase_tiny_train, "on", accum_steps=2)
        det = timed("reload_determinism", phase_determinism)
        train_n = timed("train", phase_train, "off")
        train_batched_n = timed("train_batched", phase_train, "on")
        # the JAX package's last tools on the flagship (the export at the end)
        timed("benchmark", phase_benchmark)
        timed("memory", phase_memory)
        tree = tempfile.mkdtemp(prefix="occformer_nusc_")
        try:
            data, ann = timed("data", phase_data, tree)
            # the CLIs on synthetic data and the resume check on the tree run
            # side by side: both drive CLI processes, whose start-up on the
            # host is most of their time
            _, resume_n = timed("cli_and_resume", side_by_side, (phase_cli,),
                                (phase_resume, tree, ann))
            r101_serve_n, r101_model = timed("r101_serve", phase_r101_serve, tree, ann)
            r101_train_n = timed("r101_train", phase_r101_train, tree, ann, r101_model)
            del r101_model
            free_memory()
            pan_serve_n, pan_model = timed("pan_serve", phase_pan_serve, tree, ann)
            pan_train_n, pan_batched_n = timed("pan_train", phase_pan_train, tree, ann,
                                               pan_model)
            del pan_model
            free_memory()
            t4d_serve_n, t4d_model = timed("t4d_serve", phase_t4d_serve, tree, ann)
            t4d_train_n, t4d_batched_n = timed("t4d_train", phase_t4d_train, tree, ann,
                                               t4d_model)
            del t4d_model
            free_memory()
            voxnet_serve_n, voxnet_model = timed("voxnet_serve", phase_voxnet_serve, tree, ann)
            voxnet_train_n, voxnet_batched_n = timed("voxnet_train", phase_voxnet_train, tree,
                                                     ann, voxnet_model)
            del voxnet_model
            free_memory()
            stereo_n, stereo_bwd_n = timed("stereo", phase_stereo, r101_root, r101_ann)
            soak_n = timed("soak", phase_soak)
            learn_n = timed("learn", phase_learn)
            ddp_n = timed("ddp", phase_ddp)
            kitti_serve_n = timed("kitti_serve", phase_kitti_serve, kitti_root)
            kitti_train_n = timed("kitti_train", phase_kitti_train, kitti_root)
            # the three configurations' CLI phases run side by side: each is
            # two CLI processes, most of whose time is start-up on the host;
            # the export phase runs in this process meanwhile, the only one
            # here that launches kernels in it (its launch counts are its own)
            timed("r101_pan_kitti_cli_and_export", side_by_side, (phase_r101_cli, tree, ann),
                  (phase_pan_cli, tree, ann), (phase_kitti_cli, kitti_root),
                  main=(phase_export,))
        finally:
            shutil.rmtree(tree, ignore_errors=True)
    finally:
        shutil.rmtree(kitti_root, ignore_errors=True)
        shutil.rmtree(r101_root, ignore_errors=True)
    emit({"phase": "wall", "seconds": wall, "total_s": time.perf_counter() - start})

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi: {smi.stderr.strip()}")
    print(card, flush=True)
    # each configuration's analytic TFLOP a frame and a step and its MFU
    # against the dense bf16 peak, beside the card's name and power limit
    emit({"analytic": ANALYTIC, "card": card})
    emit({"kernels": kernel_records(kern, probe, det, {
        "serve": serve_n, "train": train_n, "train_batched": train_batched_n,
        "data_train": data["train_pipeline"]["launches"],
        "data_serve": data["serve_pipeline"]["launches"],
        "k4_gate": kern["K4_gate"]["launches"], "probe": probe["launches"],
        "resume": resume_n, "soak": soak_n, "learn": learn_n, "ddp": ddp_n,
        "kitti_serve": kitti_serve_n, "kitti_train": kitti_train_n,
        "r101_serve": r101_serve_n, "r101_train": r101_train_n,
        "pan_serve": pan_serve_n, "pan_train": pan_train_n,
        "pan_train_batched": pan_batched_n, "t4d_serve": t4d_serve_n,
        "t4d_train": t4d_train_n, "t4d_train_batched": t4d_batched_n,
        "stereo": stereo_n, "stereo_backward": stereo_bwd_n, "voxnet_serve": voxnet_serve_n,
        "voxnet_train": voxnet_train_n, "voxnet_train_batched": voxnet_batched_n,
        "pointcloud": pc_n},
        kitti_kern, r101_kern, pan_kern, stereo_kern, voxnet_kern, pc_rec)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
