#!/usr/bin/env python3
"""Smoke test of pvd_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]
    python3 chip_smoke.py --host-ab OTHER_CHECKOUT

The second form only times the A/B recipe's teacher (phase 6) in this
checkout and another one in turn, with a host profile of each (`host_ab`).

1. Builds the CUDA kernels from pvd_tpu_torch/csrc (nvcc, sm_90a).
2. Drives the serving path at the full INGP width (14 levels x 2, 2^19
   table, bf16 heads, grid 128^3, 1024-step march, 16 samples/ray budget)
   with seeded random weights: one full occupancy sweep (2,097,152 density
   queries), then three 800x800 renders with make_eval_renderer on a
   3.18%-occupancy object grid.
3. Drives the hash -> VM distillation step at full width (VM 300^3, ranks
   16/48; the same hash teacher; 8192 rays, budget 131,072 samples, bf16
   heads) on a surface-like grid of ~8 valid samples per ray: 3 warm-up
   and 10 timed steps at each of stages 1, 2 and 3 through
   make_distill_step, then a profile of one stage-3 step.
   Each path's launch counters are zeroed just before it and read just
   after; every kernel of the path must have launched.
4. Holds each kernel against its plain PyTorch version on inputs taken from
   those paths, and times both (CUDA events, median after warm-up; the
   kernel also alone, `kernel_ms`: the profiler's device time of the
   csrc kernels a call launches); K4
   also on a ragged sample count, positions outside [-1, 1], tables off
   16-byte alignment and ranks 5 and 16 (logging the float4 or scalar
   instantiation each ran); K5 also on its hard inputs (`k5_hard_inputs`:
   every sample in one plane cell and line row, a third of the upstream
   rows zero, positions outside [-1, 1], ranks 5, 16 and 64, a line of 640
   rows, tables off 16-byte alignment; logging the
   instantiation `k5_variant` picks) and its zero fill alone; K3 also at the
   serving ladder's 16x rung (256
   slots per ray) and on its hard inputs (`k3_hard_inputs`), K1 at the
   sweep's points and on the serving chunk's compacted points (each with
   an F.embedding_bag yardstick) and on its hard inputs
   (`k1_hard_inputs`), K2 on its hard lattices (`k2_hard_inputs`), K7 on
   its hard inputs (`k7_hard_inputs`); K6 with the kernel alone and the
   first design's output fills timed apart, and the VM projection's
   backward (a cuBLAS bmm the port keeps) at the batch; holds
   one distill step on the GPU against the same step on the CPU (plain) at
   test sizes; and checks that 10 stage-3 steps on a fixed batch lower the
   loss.
5. Trains a full-width hash teacher through `Trainer.train` (the quality
   recipe: the synthetic scene with 100 training views at 96x96, PVDConfig
   defaults except grid_size 64, 600 steps (the recipe's 3000, cut): 256
   padded warm-up steps, then the compacted path; its checkpoints go to a
   temporary workspace),
   evaluates the 3 test views with `Trainer.evaluate` and fails below
   25 dB test PSNR.  Then holds K7 (table gradient), K8 and K9 (padded
   composite) against their plain versions on inputs from that run, K1 at
   its padded and compacted shapes, K2 at its training batch (8192 rays
   into 96 slots, perturbed), K3 at its compacted shape (K8 and K9 at the
   padded warm-up's [8192, 96]), profiles one
   padded and one compacted teacher
   step, and holds one small teacher step (padded and compacted) on the
   GPU against the CPU plain step.
6. Runs the JAX package's quality A/B recipe (tools/quality_ab.py) through
   the Trainer: the synthetic scene with 100/3/10 views at 96x96; a
   cell-mode hash teacher (the 9 finest levels cell-packed, kernels K10 and
   K11) for 3000 steps of 4096 rays at grid 64, whose val eval writes
   `hash_best.ckpt` into a temporary workspace; then `Trainer(mode=
   "distill")` loads that file and distills a VM student for 2000 steps
   (stages 300/800, 4096 rays, max_samples 64, 6 samples per ray); both
   are evaluated on the 10 test views (PSNR, SSIM).  Fails below 28.0 dB
   (teacher), 27.5 dB (student) or more than 1.0 dB under the teacher.
   Then holds K10 and K11 against their plain versions on the cell
   teacher's padded and compacted batches (K11's kernel and its zero fill
   also timed apart), K8 and K9 on its padded warm-up batch ([4096, 96]),
   K7 and K1 on the compacted batch's corner levels
   (0-4), K6 on the compacted batch's composite; on a stage-3 batch of the
   student (4096 rays marched into 64 slots, 24,576 compacted) K2, K5
   (with its F.grid_sample yardstick), K15 on the baked teacher's points,
   K10 on the exact teacher's, K6 on the student's composite and the VM
   projection's backward;
   profiles one compacted teacher
   step and one stage-3 distill step, and holds one small cell-mode
   teacher step (padded and compacted) on the GPU against the CPU.
7. Runs the large-scene configuration (bench.py:376-380's cascade config
   plus the background model: bound 2, so two occupancy cascades, the
   geometric march dt_gamma 1/256, bg_radius 32, grid 128, 1024 march
   steps, max_samples 64, 4096 rays) through the Trainer on the synthetic
   scene with 100/3/10 views at 96x96, its images composited over a sky
   dome on the background sphere: a cell-mode hash teacher (1500
   steps; the 256-step padded warm-up, then compacted) whose val eval
   writes `hash_best.ckpt`, then `Trainer(mode="distill")` loads it and
   distills a VM student (1000 steps, stages 150/400, 6 samples per ray);
   both evaluated on the 10 test views.  Fails below 25 dB (teacher),
   24 dB (student) or more than 1.5 dB under the teacher.  Every march of
   this path is K14 (the geometric lattice) and every composite blends in
   the field's background through K12 (and K13 in training).  Then holds
   K12, K13 and K14 against their plain versions at this phase's shapes
   (K12 also on `hard_points` at every `HARD_COUNTS` count: 1 to 24,575
   points, NaN, outside and far-face points among them),
   K8 and K9 on the teacher's padded warm-up batch ([4096, 64]), K10
   and K11 on its compacted batch (K13 also on 4096 points inside one level-0
   cell and on points on and outside the square's edges with a third of
   the upstream rows zero; K14 also on its hard lattices,
   `k14_hard_inputs`),
   renders one 800x800 view of the teacher through make_eval_renderer
   (and times `read_png` on it written with each scanline filter),
   profiles a teacher and a stage-3 distill step, and holds one small
   large-scene teacher step (padded and compacted) and one stage-3 distill
   step on the GPU against the CPU plain steps.
8. Runs the distillation CLI on the A/B recipe (inside phase 6, on its
   teacher): the same scene written to disk as a blender-format dataset
   (`write_synthetic_scene`, 100/3/10 views at 96x96), then
   `pvd_tpu_torch.cli.distill.main` with `--hash_cell_levels 9
   --hash_bake_dense --ckpt_teacher hash_best.ckpt` and flags that give
   the A/B distill config field for field (checked): it reads the scene
   without cv2, bakes the frozen teacher's 5 dense levels (K16), distills
   the 300^3 VM student for 2000 steps with every teacher replay through
   K15 + K10 (no K1), writes checkpoints, results/*.png and metrics.json
   and renames the workspace; then `--test` and `--test_teacher` render
   it again.  Fails under 27.5 dB (student, 10 test views) or more than
   1.0 dB under the A/B phase's exact-teacher student, and records the
   baked-against-exact difference of teacher and student.  Holds K15 and
   K16 against their plain versions at full width (bound 1: side 73, 5
   dense levels, the A/B teacher's table; bound 2: side 59, 4 levels) at
   131,072 and 2,097,152 points (points on the faces and outside
   included) and at the largest teacher encode of `--test_teacher` (one
   eval chunk's samples, the input the CLI's eval sends), K15 also on
   `hard_points` at every `HARD_COUNTS` count into an output prefilled
   with 7 (its other slots must stay so), times them beside F.grid_sample,
   and profiles one stage-3 distill step with the baked teacher beside
   the exact one.  Beside every K12 and K15 time it logs the device time
   of one copy_ of the same output bytes (`floor_ms`).
9. After every timing, holds K6 on its hard inputs (`k6_hard_inputs`),
   K8 on its own (`k8_hard_inputs`: K9's and a T crossing 1e-4 inside a
   tile; early stop off and on) and K9 on its own (`k9_hard_inputs`:
   rows of 1 to 130 slots, 4099 rays, masks all off, last slot only or
   scattered, an opaque first slot, dt = 0, each kind of upstream
   gradient zero), each through its C entry into outputs filled with NaN;
   K16 bit for bit its plain version on four more grids
   (`K16_HARD_SPECS`: one dense level, three, base resolution 4, a 2^22
   hash map up to side 152; tables of +-1e4 and subnormals); the NaN
   rule (`check_nan_rule`:
   K12 and K15 give NaN exactly where their plain versions do; K7 and K13
   add nothing for a NaN point); then K11 and K10 on their hard inputs
   (`k11_hard_inputs`: ray runs, one cell, colliding cell rows, zero
   levels, a padded stream, edge and NaN points, a 20-level grid with 18
   cell levels; g also off 8-byte alignment; K10 last also on an x01 and
   an out one float into larger buffers, out's other slots untouched);
   each check raises on a case over its kernel's tolerance.
10. Runs the teacher CLI (inside phase 6, on the scene phase 8 wrote):
   `pvd_tpu_torch.cli.train_teacher.main` with the A/B teacher's flags
   (--hash_cell_levels 9, 4096 rays, grid 64, 3000 steps; the config
   checked field for field) and no --preload, so every batch comes from
   the host batcher (`data/raybatch.RayBatcher`, the port's own g++ build
   of csrc/raybatch.cpp), then `--test`.  Fails under 28.0 dB or more
   than 1.0 dB under the Python-API A/B teacher of the same run; logs its
   padded and compacted ms per step beside that teacher's and profiles
   one padded and one compacted host-batcher step.
11. Trains the MLP field (PE 10, 8 x 256, skip 3, bf16 layers) and the
   plenoxel field (128^3 x 28, degree 3) as teachers through the teacher
   CLI on the same scene (1500 and 2000 steps of 4096 rays at grid 64,
   --preload),
   then distills each into the other through the distill CLI
   (mlp -> tensors, tensors -> mlp: 1500 steps, stages 225/600 with no
   stage 1, max_samples 64, 6 samples per ray;
   MATRIX_QUALITY_r05.json's recipe, its 3000 and 2000 steps cut).
   Fails under 25 dB (teachers), 24 dB (students) or a student more
   than 3.0 dB under its teacher.
   Logs each run's ms per step, a profile of one padded and one
   compacted teacher step and of one stage-3 distill step, and times the
   plenoxel query (`grid_sample_3d`, forward and backward) beside
   F.grid_sample at 65,536 points of the trained volume.
12. Trains TensoRF's coarse-to-fine VM teacher through the teacher CLI on
   the same scene (resolution 128 -> 300, shrinks and upsamples after
   steps 200, 300, 400, 550 and 700 of 1500; the A/B teacher's rays and
   grid, --preload), then `--test`; logs each resize's shape and the
   teacher's test PSNR (no floor: its eval reads the shrunk tables over
   aabb_infer, as the JAX package's does, ROADMAP C9) beside its PSNR over
   aabb_train; distills a cell-mode hash student from its best checkpoint
   through the distill CLI (600 steps, stages 90/240), then `--test`:
   fails under 24 dB.  Holds K4 and K5 against their plain versions at
   131,072 samples at the trained teacher's per-axis shape and at its
   shape after the first shrink (random tables), with their times and
   bounds.
13. Distills MATRIX_QUALITY_r05.json's hash2tensors_c2f student (the
   plenoxel volume from 64^3 to 128^3, lr 2e-2) from the A/B teacher
   through the distill CLI, cut to 2000 steps with the upsamples at 400
   and 800, then `--test`: fails under 24 dB or more than 3.0 dB under
   the A/B teacher, or if the volume does not end at 128^3.
14. Trains the A/B teacher through the teacher CLI on the host batcher
   with --error_map --ema_decay 0.95 --scan_steps 8, then distills the
   A/B student from its best checkpoint with the same three flags, each
   followed by `--test`: fails under 28.0 / 27.5 dB, a student more than
   1.0 dB under its teacher, a best checkpoint that does not hold the EMA
   weights, or a run with fewer than half its steps in 8-step calls.
   Profiles one host step with the error map and one stage-3 distill
   step with it, and holds one small preloaded teacher step with an
   error map on the GPU against the CPU: loss, gradients, params and the
   updated map row.
15. Scan steps (phase 14 runs them on the host batcher): the A/B teacher
   through the teacher CLI with --preload --scan_steps 8, then `--test`;
   fails under 28.0 dB, more than 1.0 dB under the single-step A/B
   teacher, or with fewer than half its steps in 8-step calls.  Then one
   8-step chunk against its 8 single steps on the card from the same
   checkpoint and draws (per-step losses and metrics within 1e-4
   relative); then both, warmed up alike, timed in 9 alternating rounds
   (median and range of the ms per step) and profiled once each (device
   busy share).
16. Data parallel over the ray axis: two ranks (spawned processes)
   sharing the card over gloo hold the DP teacher step and the rgb-only
   DP distill step on fixed shards (test sizes, f32 heads) against the
   single-process step on the concatenated batch (the GPU step
   tolerances), the DP occupancy sweep and one 800x800 DP eval image of
   the A/B teacher (f32 heads) against the single-process ones, hold an
   rgb-only stage-3 distill step at the A/B shapes (VM 300^3, 4096 rays)
   on fixed shards, padded against the single-process step on the
   concatenated batch and compacted (6 samples a ray) against the mean
   of single-process steps on the ranks' slices, and
   train the A/B student at its own widths, cut to 300 steps, through the
   Trainer with n_devices=2 (every rank's launch counters read around
   its run), within 1.0 dB of the single-process student; they time a
   mean all-reduce of the full A/B student's gradient size.  Then one
   rank over NCCL: `make_distill_step` over it, at test sizes and at the
   A/B shapes, against the single-chip step, and the same all-reduce's
   time.
17. The JAX package's last modules (inside phase 6, on its teacher and
   student).  Phase 2's INGP field and object grid go through a
   reference-format .pth (torch Linear layouts, the density grid in Morton
   order, `to_morton_order`) and `load_torch_reference`: params, grid and
   bitfield bit for bit, and an 800x800 `make_eval_renderer` image against
   phase 2's (K1-K3); the A/B VM student the same way, its test PSNR
   against its own eval's (K4).  The A/B teacher (cell mode, K1 + K10)
   through `render_stratified` at 512 samples a ray and at 128 + 64
   resampled (4096 rays a call, 2,097,152 points at 512), as it is and
   with its density zeroed in the cells its grid marks empty
   (`OccupancyMasked`), on the 10 test views (fails under
   STRAT_PSNR_FLOOR) and one 800x800 view, beside its occupancy renderer; the plain composite's and resampler's times at the
   call's shapes, a profile of the 800x800 render, and one perturbed,
   resampled call with its backward (K7, K11) at test sizes on the GPU
   against the CPU plain path.  Its mesh at 256^3, threshold 10
   (`extract_geometry`): the sweep and the surface timed apart, fails if
   empty or outside the box, writes an OBJ.  Four stratified calls under
   `trace`, whose Chrome trace must name K1 and K10, and the JPEG fixtures
   of tests/data/jpeg (the decoder built here with g++) bit for bit
   against their committed cv2 decodes.
18. Prints the GPU's name and power limit, a {"kernels": [...]} line, and
   ends with {"ok": true, "device": {...}}.

Exits non-zero, printing no result, if any phase fails, no GPU is present
or the package is not beside it (the script alone exits 1).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import itertools
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

from pvd_tpu_torch import kernels
from pvd_tpu_torch.cli import distill as distill_cli
from pvd_tpu_torch.cli import train_teacher as teacher_cli
from pvd_tpu_torch.config import ModelSpec, PVDConfig, RenderSpec
from pvd_tpu_torch.data import hostlib, jpeg
from pvd_tpu_torch.data.jpeg import read_jpeg
from pvd_tpu_torch.data.png import read_png, write_png
from pvd_tpu_torch.data.poses import get_rand_poses, pose_spherical
from pvd_tpu_torch.data.provider import NeRFDataset
from pvd_tpu_torch.data.raybatch import RayBatcher
from pvd_tpu_torch.data.synth import (make_synthetic_scene,
                                      write_synthetic_scene)
from pvd_tpu_torch.engine import checkpoint as ckpt
from pvd_tpu_torch.engine.optim import (build_optimizer, cosine_schedule,
                                        exp_decay_schedule)
from pvd_tpu_torch.engine.train_steps import (TrainState, chunk_rays,
                                              make_distill_step,
                                              make_eval_renderer,
                                              make_occ_update,
                                              make_teacher_step,
                                              make_teacher_step_host)
from pvd_tpu_torch.engine.import_torch import load_torch_reference
from pvd_tpu_torch.engine.trainer import Trainer
from pvd_tpu_torch.models.api import (bg_grid_spec, field_forward,
                                      param_group_label, trainable_label)
from pvd_tpu_torch.models.hash_field import HashField, grid_spec
from pvd_tpu_torch.models import vm_field
from pvd_tpu_torch.models.vm_field import normalize
from pvd_tpu_torch.ops.aabb import near_far_from_aabb, polar01_from_ray
from pvd_tpu_torch.ops.composite import (composite_rays, composite_rays_bwd,
                                         composite_rays_bwd_plain,
                                         composite_rays_compact,
                                         composite_rays_compact_bwd,
                                         composite_rays_compact_fwd,
                                         composite_rays_compact_plain,
                                         composite_rays_fwd,
                                         composite_rays_plain,
                                         composite_stratified, k3_lanes,
                                         stratified_weights)
from pvd_tpu_torch.ops.fma import fma32
from pvd_tpu_torch.ops import hashgrid
from pvd_tpu_torch.ops.grid_sample import grid_sample_3d
from pvd_tpu_torch.ops.hashgrid import (HashGridSpec, build_baked_dense,
                                        build_baked_dense_plain, cell_corners,
                                        corner_level_plain,
                                        hash_encode, hash_encode_baked_fwd,
                                        hash_encode_baked_plain,
                                        hash_encode_bwd,
                                        hash_encode_bwd_plain,
                                        hash_encode_cell_bwd,
                                        hash_encode_cell_bwd_plain,
                                        hash_encode_cell_fwd,
                                        hash_encode_cell_plain,
                                        hash_encode_fwd, hash_encode_plain,
                                        level_corners)
from pvd_tpu_torch.ops.rays import (draw_error_map_inds_np, get_rays,
                                    nerf_matrix_to_ngp)
from pvd_tpu_torch.ops.sampling import sample_pdf, stratified_z_vals
from pvd_tpu_torch.ops.vm_sample import (MAT_IDS, VEC_IDS, grad_buffers,
                                         k4_variant, k5_variant,
                                         vm_sample_bwd, vm_sample_bwd_plain,
                                         vm_sample_fwd, vm_sample_plain)
from pvd_tpu_torch.parallel.dp import (make_dp_eval_renderer,
                                       make_dp_occ_update)
from pvd_tpu_torch.parallel.mesh import init_ray_group
from pvd_tpu_torch.params import (field_from_tree, hash_field_from_jax,
                                  hash_tree_from_field, spec_from_tree,
                                  tree_from_field, vm_field_from_jax,
                                  vm_tree_from_field)
from pvd_tpu_torch.render.occupancy import (grid_coords, init_occupancy_state,
                                            query_points, set_bitfield,
                                            to_morton_order)
from pvd_tpu_torch.render.renderer import (_occupancy_lookup, _t_lattice_geom,
                                           compact_samples, dt_min_of,
                                           march_rays, march_rays_plain,
                                           render_rays, render_stratified)
from pvd_tpu_torch.utils.mesh import (density_query, extract_fields,
                                      extract_geometry, marching_tetrahedra,
                                      save_obj)
from pvd_tpu_torch.utils.metrics import psnr
from pvd_tpu_torch.utils.profiling import trace

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and f32 outside the
# tensor cores; the bounds below are the larger of bytes/BW and ops/F32
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

RES, CHUNK = 800, 4096
OUR_KERNELS = ("hash_encode_fwd_kernel", "hash_encode_fwd_per_level_kernel",
               "march_rays_kernel",
               "segment_bounds_kernel", "composite_kernel",
               "vm_sample_fwd_kernel", "vm_sample_bwd_kernel",
               "composite_bwd_kernel", "hash_encode_bwd_kernel",
               "composite_padded_fwd_kernel", "composite_padded_bwd_kernel",
               "hash_cell_fwd_kernel", "hash_cell_bwd_kernel",
               "hash_encode2_fwd_kernel", "hash_encode2_bwd_kernel",
               "march_rays_geom_kernel", "hash_baked_fwd_kernel",
               "hash_bake_kernel")
# launch records of each kernel_ms session's fullest trace
RECORDS: list = []
TOL_K1, TOL_K2_DD, TOL_K3 = 1e-5, 1e-6, 1e-5
# K4: the same f32 ops; K5: fp32 atomics add in a varying order, so each
# gradient leaf is held to 1e-4 of its max |g|; K6: the closed form against
# autograd through the plain composite
TOL_K4, TOL_K5_REL, TOL_K6 = 1e-5, 1e-4, 1e-5
SERVE_KERNELS = ("hash_encode", "march_rays", "composite_rays_compact")
DISTILL_KERNELS = {1: ("hash_encode", "march_rays", "vm_sample_fwd",
                       "vm_sample_bwd"),
                   2: ("hash_encode", "march_rays", "vm_sample_fwd",
                       "vm_sample_bwd"),
                   3: ("hash_encode", "march_rays", "vm_sample_fwd",
                       "vm_sample_bwd", "composite_rays_compact",
                       "composite_rays_compact_bwd")}
WARMUP_STEPS, TIMED_STEPS, FIXED_BATCH_STEPS = 3, 10, 10
# distill step at test sizes, kernels on the GPU against plain on the CPU
# (the sizes and tolerances of tests/test_torch_distill.py)
SMALL_TEA = dict(hash_num_levels=4, hash_log2_size=14, hash_desired_res=128,
                 compute_dtype="float32")
SMALL_STU = dict(model_type="vm", vm_sigma_rank=4, vm_color_rank=12,
                 vm_resolution=(20, 24, 28), compute_dtype="float32")
SMALL_CFG = dict(num_rays=256, grid_size=32, max_steps=128, max_samples=32,
                 samples_per_ray=8.0, precision="fp32")
SMALL_HW, SMALL_INTR = 48, (40.0, 40.0, 24.0, 24.0)
STEP_LOSS_RTOL, STEP_GRAD_REL_ATOL, STEP_GRAD_RTOL = 2e-5, 2e-5, 1e-4
STEP_PARAM_TOL, STEP_MASK_FRAC = 1e-6, 1e-3
# end-to-end image and depth, kernel path on the GPU vs plain path on the
# CPU: the same samples (K2 is exact), f32 heads summed in other orders
E2E_RES, E2E_CHUNK, TOL_E2E = 64, 1024, 1e-4
# the teacher recipe of the repo's quality A/B (tools/quality_ab.py): 100
# training views at 96x96, grid 64, 3000 steps, cut to 600 (the 256-step
# padded warm-up, then the compacted path) to keep the script's time; the
# JAX package's run of it reached ~31.5 dB test PSNR at 3000
RECIPE = dict(n_train=100, n_val=0, n_test=3, H=96, W=96, grid_size=64,
              iters=600)
PSNR_FLOOR = 25.0
TEACHER_KERNELS = ("hash_encode", "march_rays", "composite_rays_compact",
                   "composite_rays_compact_bwd", "hash_encode_bwd",
                   "composite_rays", "composite_rays_bwd")
# K7: fp32 atomics add in a varying order, so the gradient is held to 1e-4
# of its max |g|; K8: the same f32 ops as the plain cumprod, other order;
# K9: the closed form against autograd through the plain composite
TOL_K7_REL, TOL_K8, TOL_K9 = 1e-4, 1e-5, 1e-5
# teacher step at test sizes (tests/test_torch_teacher.py's), GPU vs CPU
SMALL_TEACHER_CFG = dict(num_rays=256, grid_size=32, max_steps=128,
                         max_samples=32, precision="fp32")
# the JAX package's quality A/B (tools/quality_ab.py:57-89): a cell-mode
# hash teacher, its best checkpoint, hash -> VM distillation at 6 samples
# per ray; its TPU run gave 31.40 dB (teacher) and 31.07 (student),
# STATUS.md:78
AB_SCENE = dict(n_train=100, n_val=3, n_test=10, H=96, W=96)
AB_TEACHER = dict(model_type="hash", hash_cell_levels=9, iters=3000,
                  grid_size=64, num_rays=4096, eval_interval=1000)
AB_DISTILL = dict(teacher_type="hash", model_type="vm", hash_cell_levels=9,
                  grid_size=64, iters=2000, stage1_iters=300,
                  stage2_iters=800, num_rays=4096, max_samples=64,
                  samples_per_ray=6.0, autotune_budget=False,
                  eval_interval=1000)
AB_JAX_TPU = {"teacher": 31.40, "student": 31.07}
AB_TEACHER_FLOOR, AB_STUDENT_FLOOR, AB_MAX_DROP = 28.0, 27.5, 1.0
AB_KERNELS = TEACHER_KERNELS + ("vm_sample_fwd", "vm_sample_bwd",
                                "hash_encode_cell_fwd",
                                "hash_encode_cell_bwd")
# K10: the same f32 ops as the plain version in another order, held to
# 1e-5 of max |out|; K11: fp32 atomics in a varying order, 1e-4 of the
# gradient's max
TOL_K10_REL, TOL_K11_REL = 1e-5, 1e-4
# the cell spec of tests/test_cell_mode.py (2 cell levels) for the small
# GPU-vs-CPU teacher step
SMALL_CELL_TEA = dict(hash_num_levels=6, hash_base_res=4,
                      hash_desired_res=64, hash_log2_size=9,
                      hash_cell_levels=2, compute_dtype="float32")
# the large-scene configuration: bench.py:376-380's cascade config (bound 2,
# dt_gamma 1/256, grid 128, 1024 steps, max_samples 64, 4096 rays, VM 300^3
# at 6 samples per ray, the teacher with 9 cell levels as bench.py:164-166
# builds it) plus the background model at tests/test_renderer.py:333's
# radius; the A/B recipe's scene and schedule
LS_SCENE = AB_SCENE
# the scene's images are RGB over a sky dome on the background sphere
# (bg_radius in NGP units = bg_radius / scale in the scene's): on the
# plain white background white floaters fill the outer cascade and
# overflow the sample budget, in the JAX package's Trainer as in the
# port's (tools/torch_large_scene_witness.py)
LS_SCALE = PVDConfig().scale
LS_SKY_RADIUS = 32.0 / LS_SCALE
LS_COMMON = dict(bound=2.0, dt_gamma=1.0 / 256.0, bg_radius=32.0,
                 grid_size=128, max_steps=1024, max_samples=64,
                 num_rays=4096, hash_cell_levels=9, eval_interval=1000)
# cut to 1500 teacher and 1000 student steps (stages 150/400; the A/B
# recipe's 3000 and 2000) to keep the script's time (at 1000 / 800 the
# student's eval truncated chunks at the ladder's last rung and it sat
# 1.1 dB under its teacher, against the 1.5 dB floor)
LS_TEACHER = dict(LS_COMMON, model_type="hash", iters=1500)
LS_DISTILL = dict(LS_COMMON, teacher_type="hash", model_type="vm",
                  resolution0=300, iters=1000, stage1_iters=150,
                  stage2_iters=400, samples_per_ray=6.0,
                  autotune_budget=False)
LS_TEACHER_FLOOR, LS_STUDENT_FLOOR, LS_MAX_DROP = 25.0, 24.0, 1.5
LS_KERNELS = ("hash_encode", "hash_encode_cell_fwd", "hash_encode_bwd",
              "hash_encode_cell_bwd", "march_rays_geom", "hash_encode_2d_fwd",
              "hash_encode_2d_bwd", "composite_rays", "composite_rays_bwd",
              "composite_rays_compact", "composite_rays_compact_bwd",
              "vm_sample_fwd", "vm_sample_bwd")
# K12: the same f32 ops as the plain version in another order, 1e-5 of max
# |out|; K13: fp32 atomics in a varying order, 1e-4 of the gradient's max;
# K14: t, dt, mask, t0 bit-exact and delta_depth 1e-6, as K2
TOL_K12_REL, TOL_K13_REL, TOL_K14_DD = 1e-5, 1e-4, 1e-6
LS_RENDER_RES = 800
# the distillation CLI on the A/B recipe with a baked teacher; its floors
# are the A/B student's
CLI_STUDENT_FLOOR, CLI_MAX_DROP = AB_STUDENT_FLOOR, AB_MAX_DROP
CLI_KERNELS = ("hash_encode_baked_fwd", "build_baked_dense",
               "hash_encode_cell_fwd", "march_rays", "vm_sample_fwd",
               "vm_sample_bwd", "composite_rays_compact",
               "composite_rays_compact_bwd")
# K15: the same f32 products as the plain version, summed in another order,
# 1e-5 of max |out|; K16: the same separately rounded products and sums as
# the plain version, so it is held bit for bit (its error relative to max
# |value| also logged against 1e-6)
TOL_K15_REL, TOL_K16_REL = 1e-5, 1e-6
BAKE_POINTS = (131_072, 2_097_152)
# the teacher CLI on the A/B scene on disk with the A/B teacher's flags
# and no --preload, so on the host batcher; floors against the Python-API
# A/B teacher of the same run.  `--test` renders the renamed workspace
# again from a fresh Trainer, whose eval ladder starts at the config's
# budget where the trained one's starts at the autotuned: the same samples
# in other buffers
TEACHER_CLI_FLOOR, TEACHER_CLI_MAX_DROP = AB_TEACHER_FLOOR, AB_MAX_DROP
TEACHER_CLI_RELOAD_DB = 0.01
# the MLP (PE 10, 8 x 256, skip 3) and plenoxel (128^3, degree 3) fields
# at MATRIX_QUALITY_r05.json's recipe (tools/matrix_quality.py:60-72,
# 166-177): teachers 3000 steps of 4096 rays at grid 64 with --preload
# (single steps here: phase 15 runs scan steps), students 2000 steps,
# stages 300/800, max_samples 64, 6 samples per ray, the budget frozen;
# cut to 1500 (MLP: 22.6 dB at 1000 on the H100) and 2000 (plenoxel:
# 24.2 dB at 1500, 29.9 at 2500) teacher steps and 1500 student steps
# (stages 225/600) to keep the script's time.
# The MLP's first few hundred steps learn little until the occupancy grid
# has pruned the empty space; a run that does not leave that phase
# empties its grid and stays near 17 dB (PERF.md §7)
FIELD_TEACHER = dict(grid_size=64, num_rays=4096, eval_interval=1000,
                     preload=True)
FIELD_TEACHER_ITERS = {"mlp": 1500, "tensors": 2000}
FIELD_DISTILL = dict(iters=1500, stage1_iters=225, stage2_iters=600,
                     grid_size=64, num_rays=4096, max_samples=64,
                     samples_per_ray=6.0, autotune_budget=False,
                     eval_interval=1000)
FIELD_TEACHER_KERNELS = ("march_rays", "composite_rays", "composite_rays_bwd",
                         "composite_rays_compact",
                         "composite_rays_compact_bwd")
FIELD_DISTILL_KERNELS = ("march_rays", "composite_rays_compact",
                         "composite_rays_compact_bwd")
# floors that catch a broken path, well under the JAX package's TPU run of
# the recipe (MATRIX_QUALITY_r05.json)
FIELD_TEACHER_FLOOR, FIELD_STUDENT_FLOOR, FIELD_MAX_DROP = 25.0, 24.0, 3.0
FIELD_JAX_TPU = {"mlp": 31.15, "tensors": 30.07, "mlp2tensors": 30.08,
                 "tensors2mlp": 29.49}
# phase 12: TensoRF's coarse-to-fine VM recipe through the teacher CLI:
# resolution 128 -> 300 with upsamples at its Synthetic-NeRF upsamp_list
# (2000, 3000, 4000, 5500, 7000 of 30,000 steps) scaled to 3000 steps, the
# run cut to 1500 (its resizes all inside); the A/B teacher's rays and
# grid.  Then a cell-mode hash student distilled from it (600 steps,
# stages 90/240; 33.5 dB at 1000): the hash field reads no aabb at
# eval, so its PSNR measures what the resized teacher learned.  The VM
# teacher's own test PSNR has no floor: its eval reads the shrunk tables
# over aabb_infer, as the JAX package's does (ROADMAP C9)
VM_C2F_TEACHER = dict(model_type="vm", resolution0=128, resolution1=300,
                      upsample_model_steps=(200, 300, 400, 550, 700),
                      iters=1500, grid_size=64, num_rays=4096,
                      eval_interval=1000, preload=True)
VM_C2F_STUDENT = dict(hash_cell_levels=9, iters=600, stage1_iters=90,
                      stage2_iters=240, grid_size=64, num_rays=4096,
                      max_samples=64, samples_per_ray=6.0,
                      autotune_budget=False, eval_interval=1000)
VM_C2F_TEACHER_KERNELS = FIELD_TEACHER_KERNELS + ("vm_sample_fwd",
                                                  "vm_sample_bwd")
VM_C2F_STUDENT_KERNELS = ("hash_encode", "hash_encode_cell_fwd",
                          "hash_encode_bwd", "hash_encode_cell_bwd",
                          "march_rays", "vm_sample_fwd",
                          "composite_rays_compact",
                          "composite_rays_compact_bwd")
VM_C2F_STUDENT_FLOOR = 24.0
RESIZED_SAMPLES = 131_072
# phase 13: MATRIX_QUALITY_r05.json's hash2tensors_c2f flags (a plenoxel
# student from resolution 64 to 128, lr 2e-2) from the A/B teacher, cut to
# 2000 steps (31.5 dB at 1200, 3.5 under the A/B teacher) with the
# upsamples at 400 and 800 (4000 there, at 800 and 1600; single steps
# here); JAX on the TPU 29.553 dB
C2F_PLENOXEL = dict(hash_cell_levels=9, iters=2000, stage1_iters=300,
                    stage2_iters=800, grid_size=64, num_rays=4096,
                    max_samples=64, samples_per_ray=6.0,
                    autotune_budget=False, eval_interval=1000, lr=0.02,
                    resolution0=64, resolution1=128,
                    upsample_model_steps=(400, 800))
C2F_PLENOXEL_KERNELS = ("hash_encode", "hash_encode_cell_fwd", "march_rays",
                        "composite_rays_compact",
                        "composite_rays_compact_bwd")
C2F_FLOOR, C2F_MAX_DROP, C2F_JAX_TPU = 24.0, 3.0, 29.553
# phase 14: the error map and EMA through both CLIs: the teacher CLI on
# the host batcher with the A/B teacher's flags, then the A/B distill
# flags from its best checkpoint; the A/B floors (with the teacher cut to
# 1500 steps its student sat 0.6-0.9 dB under it, near the 1.0 dB floor)
EMAP_EMA = ("--error_map", "--ema_decay", "0.95")
EMAP_DISTILL = {k: v for k, v in AB_DISTILL.items()
                if k not in ("teacher_type", "model_type")}
EMAP_DISTILL_KERNELS = ("hash_encode", "hash_encode_cell_fwd", "march_rays",
                        "vm_sample_fwd", "vm_sample_bwd",
                        "composite_rays_compact",
                        "composite_rays_compact_bwd")
# the map row of a small step, GPU against CPU: cells drawn once rtol
# 2e-5 plus 2e-5 of the row's max; a cell drawn by several rays holds one
# of their values on each device
TOL_EMAP_ROW = 2e-5
# scan steps (bench.py:233's teacher setting, --scan_steps 8): phase 14's
# error-map teacher on the host batcher and its student run in 8-step
# calls; phase 15 trains the A/B teacher with --preload --scan_steps 8 (the
# A/B floors) and holds one 8-step chunk against its 8 single steps on the
# card: K7 and K11 add with float atomics, so the per-step losses and
# metrics are held to 1e-4 relative (two runs of the same single steps are
# logged beside)
SCAN_K = 8
SCAN_FLAGS = ("--scan_steps", str(SCAN_K))
CHUNK_RTOL = 1e-4
# the chunk's time against its singles': warm-up calls a side, then rounds
# of one call a side in turns
CHUNK_WARMUP, CHUNK_ROUNDS = 2, 9
# phase 16: data parallel with two ranks sharing the card over gloo
# (NCCL refuses two ranks on one card), then one NCCL rank.  The small
# steps at test sizes (f32 heads, padded) against the single-process step
# on the concatenated batch at the GPU step tolerances above; the distill
# step rgb-only (its point losses are per-shard means in JAX, dp.py:15-23;
# those logs and its PSNR are left out).  The sweep and the 800x800 image
# of the A/B teacher with f32 heads: the grid within 1e-5 of its max, at
# most 8 bitfield cells flipped, the image within 1e-4 (the GEMMs see
# other batch shapes).  One rgb-only stage-3 distill step at the A/B
# shapes (VM 300^3 from the A/B teacher, 4096 rays, f32 heads) on fixed
# shards, at the same tolerances: padded, against the single-process step
# on the concatenated batch; compacted at 6 samples a ray, against the
# mean of single-process steps on the ranks' slices (each rank's budget is
# 6 x its own rays, as in JAX, so a slice over it loses its own tail and
# the concatenated batch's step is another objective).  DP_DISTILL: the A/B
# student at its own widths, cut in steps (2000 -> 300: a two-rank step
# takes ~180 ms, ~105 of it the gradient's all-reduce through host
# memory), through the Trainer, within 1 dB of the single-process student
# (the two draw other rays)
DP_WORLD = 2
DP_TIMEOUT_S = 600.0
DP_RGB_ONLY = dict(loss_rate_fea_sc=0.0, loss_rate_sigma=0.0,
                   loss_rate_color=0.0)
DP_SHARD_LOGS = ("loss_fea_sc", "loss_sigma", "loss_color", "psnr")
DP_DISTILL = dict(AB_DISTILL, iters=300, stage1_iters=50, stage2_iters=150)
DP_AB_SEED = 17
DP_GRID_RTOL, DP_BIT_FLIPS, DP_IMAGE_ATOL, DP_MAX_DROP = 1e-5, 8, 1e-4, 1.0
# the small large-scene steps (tests/test_torch_large_scene.py's sizes)
SMALL_LS = dict(bound=2.0, dt_gamma=1.0 / 256.0, bg_radius=32.0)
SMALL_LS_TEA = dict(SMALL_TEA, bound=2.0, bg_radius=32.0)
SMALL_LS_STU = dict(SMALL_STU, vm_resolution=(32, 32, 32), bound=2.0,
                    bg_radius=32.0)
# occupancy of their random grid: tests/test_torch_large_scene.py's 10%.
# At 25% in both cascades the geometric march fills ~88% of the padded
# slots and nearly every ray is opaque: the background's gradient then
# scales with 1 - weights_sum, a cancellation whose rounding differs
# between two composites' summation orders
SMALL_LS_OCC = 0.1


def object_like_bitfield(H: int) -> np.ndarray:
    """Deterministic 3.18% occupancy clustered like a trained object grid:
    a thick spherical shell plus a few solid blobs near the center."""
    g = np.zeros((H, H, H), bool)
    ax = (np.arange(H) + 0.5) / H * 2.0 - 1.0
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    r = np.sqrt(X**2 + Y**2 + Z**2)
    g |= (r > 0.42) & (r < 0.5)  # shell
    rng = np.random.default_rng(7)
    for _ in range(6):  # interior blobs
        c = rng.uniform(-0.3, 0.3, 3)
        rad = rng.uniform(0.08, 0.16)
        g |= ((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2) < rad**2
    return g.reshape(-1)


def surface_bitfield(H: int) -> np.ndarray:
    """Deterministic surface-like occupancy: a thin spherical shell (radius
    0.4, ~1 cell thick) and two thin blob shells, 0.27% of cells.  A
    train-mode march from the test orbit takes ~8 valid samples per ray,
    about the batch mean of a trained grid (the reference's 16 samples per
    ray of budget is ~2x that)."""
    ax = (np.arange(H) + 0.5) / H * 2.0 - 1.0
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    g = np.abs(np.sqrt(X**2 + Y**2 + Z**2) - 0.4) < 0.005
    rng = np.random.default_rng(7)
    for _ in range(2):
        c = rng.uniform(-0.25, 0.25, 3)
        rad = rng.uniform(0.06, 0.12)
        r = np.sqrt((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2)
        g |= np.abs(r - rad) < 0.005
    return g.reshape(-1)


def random_hash_params(spec, rng: np.random.Generator) -> dict:
    """Seeded params in the JAX package's layout.  The table is drawn from
    U(-0.5, 0.5): the reference's +-1e-4 init would make every level's
    features near-equal and hide indexing faults."""
    gs = grid_spec(spec)

    def mlp(dims):
        return [{"w": rng.uniform(-1, 1, (i, o)).astype(np.float32)
                 / np.float32(math.sqrt(i))}
                for i, o in zip(dims[:-1], dims[1:])]

    tree = {
        "encoder": rng.uniform(-0.5, 0.5, (gs.table_size, 2))
        .astype(np.float32),
        "sigma_net": mlp([gs.output_dim, spec.hidden_dim,
                          1 + spec.geo_feat_dim]),
        "color_net": mlp([spec.dir_sh_degree ** 2 + spec.geo_feat_dim,
                          spec.hidden_dim_color, spec.hidden_dim_color, 3]),
    }
    if gs.cell_table_size:
        tree["encoder_cell"] = rng.uniform(
            -0.5, 0.5, (gs.cell_table_size, gs.cell_row_width)) \
            .astype(np.float32)
    return with_bg(tree, spec, rng)


def with_bg(tree: dict, spec, rng: np.random.Generator) -> dict:
    """`tree` plus a seeded background subtree when spec.bg_radius > 0: the
    2-D table from U(-1e-4, 1e-4), the reference's init, and the MLP with
    bound 1/sqrt(fan_in).  An O(1) table would move the 2048-cell level's
    features by ~1e-4 per ulp of a polar coordinate (CUDA's atan2 and the
    CPU's differ by an ulp or two), enough to flip a ReLU of the background
    MLP somewhere in a batch and move its gradients by ~1% of their max;
    K12 and K13 are held on the trained table instead."""
    if spec.bg_radius > 0:
        bg = bg_grid_spec()
        dims = [bg.output_dim + spec.dir_sh_degree ** 2, spec.hidden_dim_bg,
                3]
        tree["bg"] = {
            "encoder": rng.uniform(-1e-4, 1e-4, (bg.table_size, 2))
            .astype(np.float32),
            "net": [{"w": rng.uniform(-1, 1, (i, o)).astype(np.float32)
                     / np.float32(math.sqrt(i))}
                    for i, o in zip(dims[:-1], dims[1:])]}
    return tree


def random_vm_params(spec, rng: np.random.Generator) -> dict:
    """Seeded VM params in the JAX package's layout and init
    (vm_field.py:41-69): planes and lines normal with scale 0.1, basis and
    color_net uniform with bound 1/sqrt(fan_in)."""
    res = spec.vm_resolution
    mats, vecs = ((0, 1), (0, 2), (1, 2)), (2, 1, 0)

    def normal(*shape):
        return (0.1 * rng.standard_normal(shape, np.float32))

    def lin(i, o):
        return {"w": rng.uniform(-1, 1, (i, o)).astype(np.float32)
                / np.float32(math.sqrt(i))}

    tree = {}
    for rank, name in ((spec.vm_sigma_rank, "sigma"),
                       (spec.vm_color_rank, "color")):
        tree[f"{name}_mat"] = [normal(res[m1], res[m0], rank)
                               for m0, m1 in mats]
        tree[f"{name}_vec"] = [normal(res[v], rank) for v in vecs]
    tree["basis_mat"] = lin(3 * spec.vm_color_rank, spec.geo_feat_dim)
    dims = [spec.dir_sh_degree ** 2 + spec.geo_feat_dim,
            spec.hidden_dim_color, spec.hidden_dim_color, 3]
    tree["color_net"] = [lin(i, o) for i, o in zip(dims[:-1], dims[1:])]
    return with_bg(tree, spec, rng)


def cuda_ms(fn, reps: int = 20, warmup: int = 3,
            queue_ahead: bool = True) -> float:
    """Median time of fn() in ms between CUDA events (one pair per call).

    queue_ahead=True first queues a ~2 ms spin kernel, so the host has
    enqueued all of fn's launches before the start event runs (an autograd
    backward's host work can take ~0.7 ms): the result is device time
    only.  queue_ahead=False times the call as a caller
    sees it on an idle card, the wrapper's host work included.
    """
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if queue_ahead:
            torch.cuda._sleep(4_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def timings(kernel_fn, plain_fn) -> dict:
    """Kernel device time, the kernels alone (`kernel_ms`: the profiler's
    time of the csrc kernels the call launches, without its fills and
    copies or the events' own cost), the wrapper call as a caller sees it,
    and the plain version's time."""
    return {"ms": cuda_ms(kernel_fn), "kernel_ms": kernel_ms(kernel_fn),
            "call_ms": cuda_ms(kernel_fn, queue_ahead=False),
            "plain_ms": cuda_ms(plain_fn, reps=5, warmup=1)}


def alone(c: dict) -> str:
    """The kernel-alone time of a timed case, for its log line."""
    return f", the kernel alone {c['kernel_ms']:.4f}" if "kernel_ms" in c \
        else ""


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a, b) -> float:
    """max |a - b|, inf where either holds a NaN (so a fold with max() or a
    test against a tolerance cannot pass it by)."""
    if not a.numel():
        return 0.0
    return float((a.float() - b.float()).abs().nan_to_num(math.inf).max())


# each kernel's launch counter: (wrapper, attribute); K12, K13 and K14
# count on the wrappers of K1, K7 and K2, which launch them
COUNTED = {"hash_encode": (hash_encode, "launches"),
           "march_rays": (march_rays, "launches"),
           "composite_rays_compact": (composite_rays_compact, "launches"),
           "vm_sample_fwd": (vm_sample_fwd, "launches"),
           "vm_sample_bwd": (vm_sample_bwd, "launches"),
           "composite_rays_compact_bwd": (composite_rays_compact_bwd,
                                          "launches"),
           "hash_encode_bwd": (hash_encode_bwd, "launches"),
           "composite_rays": (composite_rays, "launches"),
           "composite_rays_bwd": (composite_rays_bwd, "launches"),
           "hash_encode_cell_fwd": (hash_encode_cell_fwd, "launches"),
           "hash_encode_cell_bwd": (hash_encode_cell_bwd, "launches"),
           "hash_encode_2d_fwd": (hash_encode, "launches_2d"),
           "hash_encode_2d_bwd": (hash_encode_bwd, "launches_2d"),
           "march_rays_geom": (march_rays, "launches_geom"),
           "hash_encode_baked_fwd": (hash_encode_baked_fwd, "launches"),
           "build_baked_dense": (build_baked_dense, "launches")}


def counters() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTED.items()}


def reset_counters():
    for fn, attr in COUNTED.values():
        setattr(fn, attr, 0)


def log(msg: str):
    print(msg, flush=True)


def profile(fn, top: int = 12, cpu: bool = True) -> dict:
    """Device time by kernel over one call of fn (torch.profiler; the host
    traced too unless cpu is false), and the device's busy share of the
    call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] if cpu else []
    with torch_profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, memcpy/memset): the CPU-side
        # aten ops carry their kernels' time too and would count it twice
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    ours = {}
    for ms, n, key in rows:
        bare = key[len("void "):] if key.startswith("void ") else key
        for name in OUR_KERNELS:
            # templated kernels (one instance per VM branch) sum up
            if bare.startswith(name + "(") or bare.startswith(name + "<"):
                row = ours.setdefault(name, {"ms": 0.0, "calls": 0})
                row["ms"] += ms
                row["calls"] += n
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "ours": ours,
            "device_busy_share": busy_ms / wall_ms if wall_ms else None,
            "top": [{"kernel": k[:80], "ms": ms, "calls": n}
                    for ms, n, k in rows[:top]]}


def distill_setup(cfg, teacher, dev, rng, H: int):
    """The full-width student, its optimizer and state on the surface
    grid."""
    spec_stu = cfg.model_spec("vm")
    student = vm_field_from_jax(random_vm_params(spec_stu, rng), spec_stu,
                                dev)
    occ = set_bitfield(init_occupancy_state(cfg.render_spec()),
                       torch.from_numpy(surface_bitfield(H)).to(dev))
    params = dict(student.named_parameters())
    opt = build_optimizer(params, param_group_label(spec_stu),
                          trainable_label(spec_stu, cfg.distill_mode),
                          cosine_schedule(cfg.lr, cfg.iters),
                          cosine_schedule(1e-3, cfg.iters))
    state = TrainState(field=student, opt_state=opt.init(params), occ=occ)
    return spec_stu, opt, state


def drive_distill(cfg, spec_stu, spec_tea, opt, state, teacher, pose, intr,
                  gen) -> dict:
    """Stages 1-3 through make_distill_step: warm-up and timed steps; the
    launches of each stage are read from the counters' growth."""
    rspec = cfg.render_spec()
    stages = {}
    for stage in (1, 2, 3):
        step = make_distill_step(spec_stu, spec_tea, rspec, opt, cfg, intr,
                                 RES, RES, stage)
        before = counters()
        for _ in range(WARMUP_STEPS):
            state, logs = step(state, teacher, state.occ, pose, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            state, logs = step(state, teacher, state.occ, pose, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
        n = WARMUP_STEPS + TIMED_STEPS
        launched = {k: v - before[k] for k, v in counters().items()}
        logs = {k: float(v) for k, v in logs.items()}
        log(f"distill stage {stage}: {ms:.2f} ms/step, "
            f"{cfg.num_rays / ms * 1e3:,.0f} rays/s; last step's logs "
            + json.dumps({k: round(v, 6) for k, v in logs.items()}))
        log(f"  launches over {n} steps: {json.dumps(launched)}")
        if not all(math.isfinite(v) for v in logs.values()):
            raise RuntimeError(f"stage {stage}: a loss is not finite")
        if not logs["compact_frac"] <= 1.0:
            raise RuntimeError(f"stage {stage}: the budget cut samples")
        for name in DISTILL_KERNELS[stage]:
            if launched[name] < n:
                raise RuntimeError(f"stage {stage}: kernel {name} launched "
                                   f"{launched[name]} times in {n} steps")
        stages[stage] = {"ms_per_step": ms,
                         "rays_per_s": cfg.num_rays / ms * 1e3,
                         "logs": logs, "launches": launched}
    return stages


def path_inputs(cfg, spec_stu, state, pose, intr, gen):
    """One stage-3 batch's compacted samples from the path: the student's
    normalized positions xn [M, 3] and its composite inputs."""
    rspec = cfg.render_spec()
    dev = pose.device
    inds = torch.randint(0, RES * RES, (cfg.num_rays,), generator=gen,
                         device=dev)
    rays = get_rays(pose[None], intr, RES, RES, inds)
    o = rays["rays_o"][0].contiguous()
    d = rays["rays_d"][0].contiguous()
    u = torch.rand(cfg.num_rays, generator=gen, device=dev)
    xn, c, comp, _ = student_batch(state.field, spec_stu, rspec, state.occ,
                                   o, d, u)
    return xn, c, comp


def student_batch(field, spec, rspec, occ, o, d, u):
    """A distill batch marched on occ and compacted (`student_samples`),
    with the student's composite inputs on it: (xn, the compact stream,
    (sigmas, rgbs, dt, t_cum, ray_id, valid, n_rays), world positions)."""
    xn, out, xyz = student_samples(field, spec, rspec, occ, o, d, u)
    c = out["compact"]
    rid = c.ray_id
    with torch.no_grad():
        f = field(xyz, d[rid], occ.aabb_train)
    dt_c = torch.where(c.valid, dt_min_of(rspec), 0.0)
    t_cum = torch.where(c.valid, out["compact_t"] + dt_c
                        - out["samples"].t0[rid], 0.0)
    comp = (f.sigma.contiguous(), f.rgb.contiguous(), dt_c, t_cum, rid,
            c.valid, o.shape[0])
    return xn, c, comp, xyz


def vm_projection_case(field, xn, gen) -> dict:
    """The VM projection's backward (models/vm_field.py `features`:
    torch.bmm(prod [3, M, R], proj [3, R, 1 + geo]) in f32) at M samples:
    autograd's two bmms together, and each alone (the gradient of prod,
    g @ proj^T, and of the projection, prod^T @ g, which reduces over the
    M samples).  Bound: prod and g read once, the gradient of prod written
    once (the projection's is a few KB); ops 2 x 2 M R (1 + geo) x 3.  A
    library call the port keeps (the JAX package leaves the same product
    to XLA outside every custom-VJP op), timed for a later change."""
    planes = [p.detach() for p in field.planes]
    lines = [v.detach() for v in field.lines]
    with torch.no_grad():
        prod = vm_sample_fwd(planes, lines, xn)
        proj = field._projection().detach()
    prod.requires_grad_()
    proj.requires_grad_()
    with torch.enable_grad():
        out = torch.bmm(prod, proj)
    g = torch.randn(out.shape, generator=gen, device=xn.device)
    B, M, R = prod.shape
    K = proj.shape[-1]
    pt, gt = prod.detach(), proj.detach().transpose(1, 2)
    return {"samples": M, "shape": [B, M, R, K],
            "ms": cuda_ms(lambda: torch.autograd.grad(
                out, (prod, proj), g, retain_graph=True)),
            "d_prod_ms": cuda_ms(lambda: torch.bmm(g, gt)),
            "d_proj_ms": cuda_ms(lambda: torch.bmm(pt.transpose(1, 2), g)),
            "bound": bound(B * M * (2 * R + K) * 4, 2 * 2 * B * M * R * K)}


def log_vm_projection(label: str, c: dict):
    log(f"VM projection backward, {label} ({c['samples']} samples, bmm "
        f"{c['shape']}): {c['ms']:.4f} ms (grad of prod {c['d_prod_ms']:.4f}"
        f", grad of the projection {c['d_proj_ms']:.4f}), bound "
        f"{c['bound'][0]:.4f} ({c['bound'][1]})")


def vm_library(planes, xn, gen) -> tuple:
    """K4's and K5's library yardsticks on samples xn: F.grid_sample
    (align_corners, zeros) of the three planes computes the plane half of
    K4, and its backward (with random upstream gradients) the plane half
    of K5.  Returns the two calls."""
    import torch.nn.functional as F

    M, R = xn.shape[0], planes[0].shape[-1]
    ims = [p.permute(2, 0, 1)[None].contiguous() for p in planes]
    grids = [xn[:, [m0, m1]][None, None].contiguous()
             for m0, m1 in ((0, 1), (0, 2), (1, 2))]

    def lib_fwd():
        return [F.grid_sample(im, gr, mode="bilinear", padding_mode="zeros",
                              align_corners=True)
                for im, gr in zip(ims, grids)]

    ims_g = [im.clone().requires_grad_() for im in ims]
    g_lib = [torch.randn(1, R, 1, M, generator=gen, device=xn.device)
             for _ in range(3)]

    def lib_bwd():
        outs = [F.grid_sample(im, gr, mode="bilinear", padding_mode="zeros",
                              align_corners=True)
                for im, gr in zip(ims_g, grids)]
        return torch.autograd.grad(outs, ims_g, g_lib)

    return lib_fwd, lib_bwd


def check_vm_kernels(state, xn, compact, gen) -> list:
    """K4 and K5 against their plain versions on the path's samples."""
    planes = [p.detach() for p in state.field.planes]
    lines = [v.detach() for v in state.field.lines]
    M, R = xn.shape[0], planes[0].shape[-1]
    kind, lanes = k4_variant(R, [t.data_ptr() for t in (*planes, *lines)])
    k4 = vm_sample_fwd(planes, lines, xn)
    p4 = vm_sample_plain(planes, lines, xn)
    err4 = max_abs(k4, p4)
    log(f"K4 on the path: {kind} instantiation, {lanes} lanes per sample, "
        f"M {M}, R {R}, one launch for the three branches")
    cases4 = k4_cases(planes, lines, xn, gen)
    k5 = k5_case(planes, lines, xn, compact.valid, gen)
    b4 = bound(M * 12 + k5["touched_rows"] * R * 4 + 3 * M * R * 4,
               3 * M * R * 14)
    lib_fwd, lib_bwd = vm_library(planes, xn, gen)
    return [
        dict(name="vm_sample_fwd", source="pvd_tpu_torch/csrc/vm_sample.cu",
             replaces="pvd_tpu/models/vm_field.py:160", err=err4,
             tol=TOL_K4,
             **timings(lambda: vm_sample_fwd(planes, lines, xn),
                       lambda: vm_sample_plain(planes, lines, xn)),
             library_ms=cuda_ms(lib_fwd),
             library_call="F.grid_sample x3 planes (the plane half of K4)",
             bound=b4, shape=f"M={M} samples x 3 branches x R={R}",
             variant=kind, cases=cases4),
        dict(name="vm_sample_bwd", source="pvd_tpu_torch/csrc/vm_sample.cu",
             replaces="pvd_tpu/models/vm_field.py:173", err=k5["err"],
             abs_err=k5["abs_err"],
             tol=TOL_K5_REL, err_kind="max |kernel - plain| / max |plain| "
             "per gradient leaf", ms=k5["ms"], kernel_ms=k5["kernel_ms"],
             call_ms=k5["call_ms"],
             plain_ms=k5["plain_ms"], library_ms=cuda_ms(lib_bwd),
             library_call="F.grid_sample fwd+bwd x3 planes (the plane half "
             "of K5)", variant=k5["variant"], lanes=k5["lanes"],
             bound=k5["bound"], shape=f"M={M} samples ({k5['valid']} valid) "
             f"x 3 branches x R={R}",
             shapes={"distill_step": k5,
                     "hard_inputs": check_k5_hard_cases(xn.device)})]


def vm_touched_rows(planes, lines, xn) -> int:
    """Plane rows the samples xn touch (4 corners each) plus every line
    row, over the three branches."""
    touched = 0
    for i, (m0, m1) in enumerate(((0, 1), (0, 2), (1, 2))):
        Hp, Wp = planes[i].shape[:2]
        px = ((xn[:, m0] + 1) * 0.5 * (Wp - 1)).floor().clamp(0, Wp - 2)
        py = ((xn[:, m1] + 1) * 0.5 * (Hp - 1)).floor().clamp(0, Hp - 2)
        row = (py * Wp + px).long()
        rows = torch.cat([row, row + 1, row + Wp, row + Wp + 1]).unique()
        touched += rows.numel() + lines[i].shape[0]
    return touched


def k5_case(planes, lines, xn, valid, gen) -> dict:
    """K5 against vm_sample_bwd_plain on samples xn [M, 3] whose upstream
    gradient is random on the `valid` rows and zero on the others (the
    compacted stream's invalid tail); times, the zero fill of the six
    gradients alone, the bound and the instantiation."""
    M, R = xn.shape[0], planes[0].shape[-1]
    g = torch.randn(3, M, R, generator=gen, device=xn.device) \
        * valid[None, :, None]
    err, abs_err = k5_rel_err(vm_sample_bwd(planes, lines, xn, g),
                              vm_sample_bwd_plain(planes, lines, xn, g))
    touched = vm_touched_rows(planes, lines, xn)
    n_valid = int(valid.sum())
    dense = sum(p.numel() + v.numel() for p, v in zip(planes, lines)) * 4
    kind, lanes = k5_variant(R, [t.data_ptr() for t in (*planes, *lines,
                                                        g)])
    out = {"M": M, "valid": n_valid, "touched_rows": touched, "err": err,
           "abs_err": abs_err, "variant": kind, "lanes": lanes,
           # bytes: xn, g, the touched table rows read once, the dense
           # gradients written once; ops: ~26 per valid (sample, channel)
           "bound": bound(M * 12 + 3 * M * R * 4 + touched * R * 4 + dense,
                          3 * n_valid * R * 26),
           "zero_ms": cuda_ms(lambda: grad_buffers(planes, lines)),
           **timings(lambda: vm_sample_bwd(planes, lines, xn, g),
                     lambda: vm_sample_bwd_plain(planes, lines, xn, g))}
    log(f"K5 at M {M} ({n_valid} valid), R {R}: {kind} instantiation, "
        f"{lanes} lanes per sample: rel err {err:.3g}, {out['ms']:.4f} ms"
        f"{alone(out)} (call {out['call_ms']:.4f}, the zero fill alone "
        f"{out['zero_ms']:.4f}, plain {out['plain_ms']:.4f}), bound "
        f"{out['bound'][0]:.4f} ms ({out['bound'][1]})")
    if not err <= TOL_K5_REL:
        raise RuntimeError(f"K5 disagrees with its plain version at M {M}: "
                           f"{err:.3g}")
    return out


def student_samples(field, spec, rspec, occ, o, d, u):
    """A distill batch's compacted samples, marched (perturbed by u) on
    occ: (normalized positions xn [M, 3], render_rays' output, world
    positions [M, 3])."""
    with torch.no_grad():
        out = render_rays(field, spec, rspec, occ, o, d, training=True, u=u,
                          composite=False)
        rid = out["compact"].ray_id
        xyz = fma32(out["compact_t"][:, None], d[rid], o[rid]).clamp(
            -rspec.bound, rspec.bound)
    return normalize(xyz, occ.aabb_train).contiguous(), out, xyz


def ab_batch_cases(stu, scene, gen) -> dict:
    """Kernels at the A/B recipe's stage-3 batch: 4096 rays of one random
    pose, marched (train mode, 64 slots, perturbed) on the teacher's grid
    and compacted to the student's budget (6 samples a ray: 24,576 slots).
    K2 on that march ("k2"); K5 with the trained student's tables and its
    F.grid_sample yardstick ("k5"); K15 on the teacher's points of those
    slots, with the A/B teacher baked, as a baked distill step replays
    them ("k15"), and K10 on those points as the exact teacher's replay
    sends them ("k10"); K6 on the student's composite of the batch ("k6");
    the VM projection's backward on it ("vm_projection")."""
    train = scene["train"]
    dev = stu.device
    intr = tuple(float(v) for v in train.intrinsics)
    pose = torch.as_tensor(get_rand_poses(np.random.default_rng(1))[0],
                           device=dev)
    n = stu.cfg.num_rays
    inds = torch.randint(0, train.H * train.W, (n,), generator=gen,
                         device=dev)
    rays = get_rays(pose[None], intr, train.H, train.W, inds)
    o = rays["rays_o"][0].contiguous()
    d = rays["rays_d"][0].contiguous()
    u = torch.rand(n, generator=gen, device=dev)
    rs, occ = stu.rspec, stu.occ_tea
    nears, fars = near_far_from_aabb(o, d, occ.aabb_train, rs.min_near)
    k2 = march_case(occ.bitfield, o, d, nears, fars, rs, u)
    log_march("K2", "A/B distill batch", k2)
    xn, compact, comp, xyz = student_batch(stu.state.field, stu.spec_stu,
                                           rs, occ, o, d, u)
    field = stu.state.field
    planes = [p.detach() for p in field.planes]
    k5 = k5_case(planes, [v.detach() for v in field.lines], xn,
                 compact.valid, gen)
    k5["library_ms"] = cuda_ms(vm_library(planes, xn, gen)[1])
    log(f"K5 A/B batch: F.grid_sample fwd+bwd x3 {k5['library_ms']:.4f} ms")
    tea = stu.teacher
    b = rs.bound
    x01 = ((xyz + b) / (2.0 * b)).contiguous()
    k15 = bake_case(tea.encoder.detach(), tea.grid, gen, x01.shape[0],
                    tea.encoder_cell.detach(), x01=x01)
    log_k15("A/B distill batch", k15)
    k10 = k10_case(tea.encoder_cell.detach(), x01, tea.grid)
    log(f"K10 A/B distill replay ({k10['points']} points x {k10['levels']} "
        f"cell levels, {k10['touched_rows']} rows touched): rel err "
        f"{k10['err']:.3g}, {k10['ms']:.4f} ms{alone(k10)} (call "
        f"{k10['call_ms']:.4f}, "
        f"plain {k10['plain_ms']:.4f}, bound {k10['bound'][0]:.5f} "
        f"{k10['bound'][1]})")
    if not k10["err"] <= TOL_K10_REL:
        raise RuntimeError("K10 disagrees with its plain version on the A/B "
                           "distill batch")
    k6 = k6_case(comp, gen)
    log_k6("A/B stage-3 batch", k6)
    vm = vm_projection_case(field, xn, gen)
    log_vm_projection("A/B stage-3 batch", vm)
    return {"k2": k2, "k5": k5, "k15": k15, "k10": k10, "k6": k6,
            "vm_projection": vm}


def k4_cases(planes, lines, xn, gen) -> dict:
    """K4 where it can go wrong, each against vm_sample_plain at TOL_K4: a
    ragged M (not a multiple of a block's samples), positions outside
    [-1, 1] on every axis (the planes' tent weights vanish, the lines
    extrapolate), tables one float off 16-byte alignment at R = 64 (the
    scalar instantiation), R = 5 (scalar) and R = 16 (float4, 4 lanes);
    each case logs the instantiation that ran."""
    dev = xn.device
    M, R = xn.shape[0], planes[0].shape[-1]

    def tables(r, shift=0):
        def make(*shape):
            buf = torch.randn(math.prod(shape) + shift, generator=gen,
                              device=dev) * 0.1
            return buf[shift:].view(*shape)
        return ([make(*p.shape[:2], r) for p in planes],
                [make(v.shape[0], r) for v in lines])

    xo = torch.rand(4099, 3, generator=gen, device=dev) * 2.6 - 1.3
    xo[:6] = torch.tensor([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0],
                           [-1.3, 0.2, 1.3], [1.3, -1.3, 0.0],
                           [0.0, 1.2, -1.2], [-1.0 - 2 ** -20, 1.0, 0.5]],
                          device=dev)
    mis, r5, r16 = tables(R, shift=1), tables(5), tables(16)
    cases = {"ragged M": (planes, lines, xn[:M - 5], "float4"),
             "xn outside [-1, 1]": (planes, lines, xo, "float4"),
             "misaligned R=64": (*mis, xn, "scalar"),
             "R=5": (*r5, xn[:4101], "scalar"),
             "R=16": (*r16, xn[:4103], "float4")}
    out = {}
    for name, (pl, li, x, want) in cases.items():
        r = pl[0].shape[-1]
        kind, lanes = k4_variant(r, [t.data_ptr() for t in (*pl, *li)])
        err = max_abs(vm_sample_fwd(pl, li, x), vm_sample_plain(pl, li, x))
        out[name] = {"variant": kind, "lanes": lanes, "M": x.shape[0],
                     "R": r, "err": err}
        log(f"K4 {name}: {kind} instantiation, {lanes} lanes per sample, M "
            f"{x.shape[0]}, R {r}: max |kernel - plain| {err:.3g}")
        if not (err <= TOL_K4 and kind == want):
            raise RuntimeError(f"K4 ({name}): {kind} instantiation (want "
                               f"{want}), err {err:.3g}")
    return out


def kernel_ms(fn, name: str | None = None, reps: int = 20) -> float:
    """Device time per call of fn of the csrc kernel `name` alone (its
    templated instances summed; all of OUR_KERNELS that fn launches when
    name is None, each once a call), from torch.profiler over reps calls
    after a warm-up, the inputs in the L2 as a step leaves them: a
    wrapper's own fills and copies are left out, and so is the ~5-7 us
    that CUDA events add.  The profiler traces the device only.  Each
    kernel's time is the mean over the launches the trace holds: the
    profiler can keep only some of a session's kernel records, so a short
    session is run again, up to 3 times; the fullest counts, and a count
    short of reps is logged (RECORDS keeps every session's count)."""
    for _ in range(3):
        fn()

    def run():
        for _ in range(reps):
            fn()

    rows, kept = {}, -1
    for _ in range(4):
        ours = profile(run, cpu=False)["ours"]
        got = ours if name is None else {k: v for k, v in ours.items()
                                         if k == name}
        if got and min(r["calls"] for r in got.values()) > kept:
            rows, kept = got, min(r["calls"] for r in got.values())
        if kept >= reps:
            break
    RECORDS.append(max(kept, 0))
    for k, r in rows.items():
        if r["calls"] != reps:
            log(f"  (the profiler kept {r['calls']} of {reps} launches of "
                f"{k})")
    return sum(r["ms"] / r["calls"] for r in rows.values()) if rows \
        else math.nan


def floor_ms(nbytes: int, dev) -> float:
    """The device time of one PyTorch copy_ that reads and writes nbytes
    (int32 into float32, so that it runs as a kernel: the profiler keeps
    no record of a same-type copy's DMA here), from torch.profiler over 20
    calls, the mean over the records it keeps: about the least a launch
    that writes those bytes takes, logged beside a kernel whose bound is
    below any launch."""
    src = torch.ones(max(1, nbytes // 4), dtype=torch.int32, device=dev)
    dst = torch.empty(src.shape, device=dev)

    def run():
        for _ in range(20):
            dst.copy_(src)

    run()
    top = profile(run, top=4, cpu=False)["top"]
    calls = sum(r["calls"] for r in top)
    return sum(r["ms"] for r in top) / calls if calls else math.nan


def k6_case(comp, gen) -> dict:
    """K6 against autograd through the plain composite on one stream
    (sigmas, rgbs, dt, t_cum, ray_id, valid, n_rays), with random upstream
    gradients of all four outputs: the error, the wrapper's times, the
    kernel alone (`kernel_ms`) and the two zero fills of d_sigma [M] and
    d_rgb [M, 3] alone (what the first design's wrapper launched before
    the kernel), and the bound."""
    sig, rgb, dt_c, t_cum, rid, valid, N = comp
    M = sig.shape[0]
    dev = sig.device
    gs = (torch.randn(N, generator=gen, device=dev),
          torch.randn(N, generator=gen, device=dev),
          torch.randn(N, 3, generator=gen, device=dev),
          torch.randn(M, generator=gen, device=dev))

    def grads_of(fn):
        s = sig.detach().clone().requires_grad_()
        r = rgb.detach().clone().requires_grad_()
        outs = fn(s, r, dt_c, t_cum, rid, valid, N)
        return torch.autograd.grad(outs, (s, r), gs)

    k6 = grads_of(composite_rays_compact)
    p6 = grads_of(composite_rays_compact_plain)
    err6 = max(max_abs(a, b) for a, b in zip(k6, p6))
    s_p = sig.detach().clone().requires_grad_()
    r_p = rgb.detach().clone().requires_grad_()
    outs_p = composite_rays_compact_plain(s_p, r_p, dt_c, t_cum, rid, valid,
                                          N)
    _, _, _, weights, bounds = composite_rays_compact_fwd(
        sig, rgb, dt_c, t_cum, rid, valid, N)
    args = dict(sigmas=sig, rgbs=rgb, delta_t=dt_c, t_cum=t_cum, ray_id=rid,
                valid=valid, weights=weights, bounds=bounds, g_ws=gs[0],
                g_depth=gs[1], g_image=gs[2], g_weights=gs[3])
    # the wrapper is called directly (an autograd backward's host work can
    # outlast the queued spin)

    def kernel():
        return composite_rays_compact_bwd(**args)

    n_valid = int(valid.sum())
    return {"slots": M, "valid": n_valid, "rays": N, "err": err6,
            "lanes": k3_lanes(M, N),
            "bound": bound(n_valid * (4 + 12 + 4 + 4 + 4) + N * (8 + 4 + 4
                                                                 + 12)
                           + n_valid * 4 + M * 16, n_valid * 30),
            **timings(kernel, lambda: torch.autograd.grad(
                outs_p, (s_p, r_p), gs, retain_graph=True)),
            "fill_ms": cuda_ms(lambda: (torch.zeros(M, device=dev),
                                        torch.zeros(M, 3, device=dev)))}


def log_k6(label: str, c: dict):
    """Log one k6_case; raise above TOL_K6."""
    log(f"K6 {label}: {c['slots']} slots ({c['valid']} valid), {c['rays']} "
        f"rays, {c['lanes']} lanes per ray: max abs err {c['err']:.3g}, "
        f"{c['ms']:.4f} ms (the kernel alone {c['kernel_ms']:.4f}; two zero "
        f"fills of the outputs alone {c['fill_ms']:.4f}; call "
        f"{c['call_ms']:.4f}, plain {c['plain_ms']:.4f}, bound "
        f"{c['bound'][0]:.5f} {c['bound'][1]})")
    if not c["err"] <= TOL_K6:
        raise RuntimeError(f"K6 disagrees with its plain version ({label})")


def check_composite_bwd(comp, gen) -> dict:
    """K6's row of the kernels line: k6_case on the distill step's
    stream."""
    c = k6_case(comp, gen)
    log_k6("distill step batch", c)
    return dict(
        name="composite_rays_compact_bwd",
        source="pvd_tpu_torch/csrc/composite.cu",
        replaces="pvd_tpu/ops/composite.py:28", err=c["err"], tol=TOL_K6,
        **{k: c[k] for k in ("ms", "kernel_ms", "call_ms", "plain_ms",
                             "bound", "lanes")},
        library_ms=None, shapes={"distill_step": c},
        shape=f"M={c['slots']} slots ({c['valid']} valid), N={c['rays']} "
        "rays")


def named_leaves(tree, prefix: str = "") -> list:
    """(name, array) of a params tree's leaves, dict keys in sorted order
    ("bg.net.0.w", "encoder", ...)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in named_leaves(
            tree[k], f"{prefix}.{k}" if prefix else k)]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, x in enumerate(tree)
                for leaf in named_leaves(x, f"{prefix}.{i}")]
    return [(prefix, np.asarray(tree))]


def bg_allowance(scale: float) -> np.ndarray:
    """Extra absolute gradient tolerance of the background table's rows for
    1-ulp differences of their polar coordinates (CUDA's and the CPU's
    atan2, sqrt and division round differently): a level-l corner weight
    moves by up to level_scale(l) * 2^-24 in each of two dimensions, so
    level l's rows get 2 * level_scale(l) * 2^-24 of the leaf's max |g|.
    The background MLP's leaves get none: at the table's init scale
    (`with_bg`) such a move shifts their inputs by ~1e-8."""
    grid = bg_grid_spec()
    out = np.empty((grid.table_size, 1), np.float32)
    for lvl in range(grid.num_levels):
        out[grid.offsets[lvl]:grid.offsets[lvl + 1]] = \
            2.0 * grid.level_scale(lvl) * 2.0 ** -24 * scale
    return out


def compare_steps(gpu, cpu) -> dict:
    """One step's (logs, gradient tree, params tree) on the GPU against the
    CPU plain step's: the largest relative log difference, whether every
    gradient leaf is within STEP_GRAD_REL_ATOL of its max |g| plus
    STEP_GRAD_RTOL (the background table: plus `bg_allowance`), the largest
    gradient difference over the leaf's max and its leaf, and the largest
    param
    difference where the gradient is clear of rounding noise or exactly 0
    (Adam's first step is lr * sign(g))."""
    (lg, gg, pg), (lc, gc, pc) = gpu, cpu
    loss_err = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-12) for k in lc)
    grad_err = param_err = 0.0
    grad_leaf = ""
    failed = []
    for (name, a), (_, b), (_, pa), (_, pb) in zip(
            named_leaves(gg), named_leaves(gc), named_leaves(pg),
            named_leaves(pc)):
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max()) / max(scale, 1e-30)
        if err > grad_err:
            grad_err, grad_leaf = err, name
        atol = STEP_GRAD_REL_ATOL * scale
        if name == "bg.encoder":
            atol = atol + bg_allowance(scale)
        hold = (np.abs(b) > STEP_MASK_FRAC * scale) | (b == 0)
        p_err = float(np.abs(pa - pb)[hold].max())
        param_err = max(param_err, p_err)
        if not (np.all(np.abs(a - b) <= atol + STEP_GRAD_RTOL * np.abs(b))
                and p_err <= STEP_PARAM_TOL):
            failed.append(name)
    if failed:
        log(f"  leaves over their tolerance: {failed}")
    ok = loss_err <= STEP_LOSS_RTOL and not failed
    return {"loss_rel_err": loss_err, "grad_err_rel_leaf_max": grad_err,
            "grad_err_leaf": grad_leaf, "param_err": param_err, "ok": ok}


def small_step_gpu_vs_cpu(devices=("cuda", "cpu"),
                          large: bool = False) -> dict:
    """One stage-3 distill step at test sizes: kernels on the GPU against
    the plain path on the CPU, same params and draws (`large`: the
    large-scene settings, two cascades, dt_gamma and both fields'
    backgrounds)."""
    rng = np.random.default_rng(11)
    cfg = PVDConfig(**SMALL_CFG, **(SMALL_LS if large else {}))
    spec_tea = ModelSpec(**(SMALL_LS_TEA if large else SMALL_TEA))
    spec_stu = ModelSpec(**(SMALL_LS_STU if large else SMALL_STU))
    tea_tree = random_hash_params(spec_tea, rng)
    stu_tree = random_vm_params(spec_stu, rng)
    bits = rng.uniform(size=cfg.render_spec().cascades
                       * cfg.grid_size ** 3) < (SMALL_LS_OCC if large
                                                else 0.25)
    pose = nerf_matrix_to_ngp(pose_spherical(30.0, -30.0, 4.0), scale=0.8)
    inds = torch.from_numpy(rng.integers(0, SMALL_HW ** 2, cfg.num_rays))
    rays = get_rays(torch.from_numpy(pose)[None], SMALL_INTR, SMALL_HW,
                    SMALL_HW, inds)
    o, d = rays["rays_o"][0].contiguous(), rays["rays_d"][0].contiguous()
    bg = torch.from_numpy(rng.uniform(size=(cfg.num_rays, 3))
                          .astype(np.float32))
    u = torch.from_numpy(rng.uniform(size=cfg.num_rays).astype(np.float32))
    res = {}
    for where in devices:
        teacher = hash_field_from_jax(tea_tree, spec_tea, where)
        student = vm_field_from_jax(stu_tree, spec_stu, where)
        occ = set_bitfield(init_occupancy_state(cfg.render_spec(), where),
                           torch.from_numpy(bits).to(where))
        params = dict(student.named_parameters())
        opt = build_optimizer(params, param_group_label(spec_stu),
                              trainable_label(spec_stu, ""),
                              cosine_schedule(1e-2, 100),
                              cosine_schedule(1e-3, 100))
        state = TrainState(field=student, opt_state=opt.init(params),
                           occ=occ)
        step = make_distill_step(spec_stu, spec_tea, cfg.render_spec(), opt,
                                 cfg, SMALL_INTR, SMALL_HW, SMALL_HW, 3,
                                 device=where)
        state, logs = step.core(state, teacher, occ, *(
            t.to(where) for t in (o, d, bg, u)))
        res[where] = ({k: float(v) for k, v in logs.items()},
                      vm_tree_from_field(student, grad=True),
                      vm_tree_from_field(student))
    c = compare_steps(res[devices[0]], res[devices[1]])
    lc = res[devices[1]][0]
    label = "large-scene distill step" if large else "distill step"
    log(f"{label} GPU kernels vs CPU plain (test sizes, stage 3, f32 "
        f"heads): max rel loss/log diff {c['loss_rel_err']:.3g} (tol "
        f"{STEP_LOSS_RTOL:g}); max grad diff / leaf max "
        f"{c['grad_err_rel_leaf_max']:.3g} ({c['grad_err_leaf']}; tol "
        f"{STEP_GRAD_REL_ATOL:g} + rtol {STEP_GRAD_RTOL:g}); max param diff "
        f"under the gradient mask "
        f"{c['param_err']:.3g} (tol {STEP_PARAM_TOL:g}); loss "
        f"{lc['loss']:.6g}, compact_frac {lc['compact_frac']:.3f}")
    if not c.pop("ok"):
        raise RuntimeError(f"the GPU {label} disagrees with the CPU plain "
                           "step")
    return c


def fixed_batch_descent(cfg, spec_stu, spec_tea, opt, state, teacher, pose,
                        intr, gen) -> list:
    """Stage-3 steps on one fixed batch (same o, d, bg, u) must lower the
    loss."""
    dev = pose.device
    inds = torch.randint(0, RES * RES, (cfg.num_rays,), generator=gen,
                         device=dev)
    rays = get_rays(pose[None], intr, RES, RES, inds)
    o = rays["rays_o"][0].contiguous()
    d = rays["rays_d"][0].contiguous()
    bg = torch.rand(cfg.num_rays, 3, generator=gen, device=dev)
    u = torch.rand(cfg.num_rays, generator=gen, device=dev)
    step = make_distill_step(spec_stu, spec_tea, cfg.render_spec(), opt,
                             cfg, intr, RES, RES, 3)
    losses = []
    for _ in range(FIXED_BATCH_STEPS):
        state, logs = step.core(state, teacher, state.occ, o, d, bg, u)
        losses.append(float(logs["loss"]))
    log(f"fixed batch, {FIXED_BATCH_STEPS} stage-3 steps: loss "
        + " ".join(f"{v:.6g}" for v in losses))
    if not (all(math.isfinite(v) for v in losses)
            and losses[-1] < losses[0]):
        raise RuntimeError("stage-3 steps on a fixed batch did not lower "
                           "the loss")
    return losses


def drive_teacher(seed: int, workspace: str) -> tuple:
    """The recipe through Trainer.train (its checkpoints go to
    `workspace`), then `Trainer.evaluate` on the test views.  Returns
    (trainer, scene, info)."""
    cfg = PVDConfig(grid_size=RECIPE["grid_size"], iters=RECIPE["iters"],
                    seed=seed, workspace=workspace)
    t0 = time.perf_counter()
    scene = make_synthetic_scene(n_train=RECIPE["n_train"],
                                 n_val=RECIPE["n_val"],
                                 n_test=RECIPE["n_test"], H=RECIPE["H"],
                                 W=RECIPE["W"], seed=seed, scale=cfg.scale)
    scene_s = time.perf_counter() - t0
    trainer = Trainer(cfg)
    log(f"teacher recipe: {RECIPE['n_train']} views {RECIPE['H']}x"
        f"{RECIPE['W']} (scene made in {scene_s:.1f} s), grid "
        f"{cfg.grid_size}, {cfg.iters} steps of {cfg.num_rays} rays, "
        f"max_samples {cfg.max_samples}, samples_per_ray "
        f"{cfg.samples_per_ray:g} after the warm-up; table "
        f"{trainer.state.field.grid.table_size} rows, heads "
        f"{trainer.spec.compute_dtype}")
    trainer.train(scene["train"])
    stats = trainer.train_stats
    hist = trainer.history
    first = float(np.mean([float(m["psnr"]) for m in hist[:16]]))
    last = float(np.mean([float(m["psnr"]) for m in hist[-16:]]))
    ev = trainer.evaluate(scene["test"])
    psnr = ev["psnr"]
    occ = trainer.state.occ
    info = {"test_psnr": psnr, "test_ssim": ev["ssim"],
            "train_psnr_first16": first, "train_psnr_last16": last,
            "eval_s_per_image": ev["eval_s_per_image"],
            "eval_s_first_image": ev["eval_s_first_image"],
            "train_stats": stats, "rspec_final": {
                "max_samples": trainer.rspec.max_samples,
                "samples_per_ray": trainer.rspec.samples_per_ray},
            "occupied": float(occ.bitfield.float().mean()),
            "last_metrics": {k: float(v) for k, v in hist[-1].items()}}
    log(f"teacher: test PSNR {psnr:.3f} dB, SSIM {ev['ssim']:.4f} over "
        f"{len(scene['test'])} views (floor {PSNR_FLOOR}); train-batch PSNR "
        f"first 16 steps {first:.3f}, last 16 {last:.3f}; final S_max "
        f"{trainer.rspec.max_samples}, budget/ray "
        f"{trainer.rspec.samples_per_ray:g}; grid occupied "
        f"{info['occupied']:.4f}; render {ev['eval_s_per_image'] * 1e3:.1f}"
        f" ms per image (first {ev['eval_s_first_image'] * 1e3:.1f})")
    log("teacher train_stats " + json.dumps(stats))
    if not (np.isfinite(psnr) and psnr >= PSNR_FLOOR):
        raise RuntimeError(f"teacher test PSNR {psnr:.3f} < {PSNR_FLOOR}")
    if not last > first:
        raise RuntimeError("teacher train-batch PSNR did not rise")
    return trainer, scene, info


def teacher_rays(trainer, scene, gen, rspec):
    """One batch of the teacher path's rays: 8192 pixels of training view
    0, their near/far on the training box and the march's perturbation u
    (rays_o, rays_d, nears, fars, u)."""
    train = scene["train"]
    dev = trainer.device
    cfg = trainer.cfg
    pose = torch.as_tensor(train.poses[0], device=dev)
    intr = tuple(float(v) for v in train.intrinsics)
    inds = torch.randint(0, train.H * train.W, (cfg.num_rays,),
                         generator=gen, device=dev)
    rays = get_rays(pose[None], intr, train.H, train.W, inds)
    o = rays["rays_o"][0].contiguous()
    d = rays["rays_d"][0].contiguous()
    nears, fars = near_far_from_aabb(o, d, trainer.state.occ.aabb_train,
                                     rspec.min_near)
    u = torch.rand(cfg.num_rays, generator=gen, device=dev)
    return o, d, nears, fars, u


def teacher_batch(trainer, scene, gen, rspec):
    """One batch of the teacher path on the trained grid: `teacher_rays`,
    marched (perturbed) with `rspec`."""
    o, d, nears, fars, u = teacher_rays(trainer, scene, gen, rspec)
    samples = march_rays(trainer.state.occ.bitfield, o, d, nears, fars,
                         rspec, u)
    return o, d, samples


def k7_case(x01, g, gs, library: bool = True) -> dict:
    """K7 against its plain version on points x01 with upstream g; times,
    bound and the index_add_ yardstick of the precomputed corner
    contributions (the scatter alone)."""
    P, Lk = x01.shape[0], len(gs.corner_levels)
    p = hash_encode_bwd_plain(x01, g, gs)
    err_abs = max_abs(hash_encode_bwd(x01, g, gs), p)
    g_lv = g.reshape(P, gs.num_levels, 2)[:, gs.corner_levels]
    active = int((g_lv != 0).any(-1).sum())
    out = {"points": P, "levels": Lk, "active_pairs": active,
           "abs_err": err_abs, "err": err_abs / float(p.abs().max()),
           # bytes: x01 and g's corner slots read once, the dense [T, 2]
           # gradient written once; ops: ~48 per active pair
           "bound": bound(P * 12 + P * Lk * 8 + gs.table_size * 8,
                          active * 8 * 6),
           **timings(lambda: hash_encode_bwd(x01, g, gs),
                     lambda: hash_encode_bwd_plain(x01, g, gs))}
    if not out["err"] <= TOL_K7_REL:
        raise RuntimeError(f"K7 disagrees with its plain version: "
                           f"{out['err']:.3g}")
    if library:
        rows, vals = [], []
        for level in gs.corner_levels:
            w, r = level_corners(x01, gs, level)
            rows.append(r.reshape(-1))
            vals.append((w[:, :, None] * g[None, :, 2 * level:2 * level + 2])
                        .reshape(-1, 2))
        rows, vals = torch.cat(rows), torch.cat(vals)
        out["library_ms"] = cuda_ms(lambda: torch.zeros(
            gs.table_size, 2, device=x01.device).index_add_(0, rows, vals))
    return out


def log_k7(label: str, c: dict):
    log(f"K7 {label}: {c['points']} points x {c['levels']} levels, "
        f"{c['active_pairs']} active pairs: rel err {c['err']:.3g}, "
        f"{c['ms']:.4f} ms{alone(c)} (call {c['call_ms']:.4f}), plain "
        f"{c['plain_ms']:.4f}"
        + (f", index_add_ {c['library_ms']:.4f}" if "library_ms" in c
           else "")
        + f", bound {c['bound'][0]:.4f} ms ({c['bound'][1]})")


def check_teacher_kernels(trainer, scene, gen) -> tuple:
    """K7 at the padded and compacted shapes, K1 at both, K2 in train mode
    at the batch, K3 (no early stop) at the compacted shape, K8 (with and
    without early stop) and K9 at the padded shape, on the trained field's
    samples."""
    field = trainer.state.field
    gs = field.grid
    table = field.encoder.detach()
    b = trainer.rspec.bound
    dev = trainer.device
    extra = {}
    # the warm-up's padded shape, and the compacted path's after autotune
    rs_pad = dataclasses.replace(trainer.rspec,
                                 max_samples=trainer.cfg.max_samples,
                                 samples_per_ray=0.0)
    o, d, nears, fars, u = teacher_rays(trainer, scene, gen, rs_pad)
    bits = trainer.state.occ.bitfield
    s = march_rays(bits, o, d, nears, fars, rs_pad, u)
    N, S = s.mask.shape
    xyz = fma32(s.t[..., None], d[:, None, :], o[:, None, :]).clamp(-b, b)
    x01_pad = ((xyz.reshape(-1, 3) + b) / (2.0 * b)).contiguous()
    g_pad = torch.randn(N * S, gs.output_dim, generator=gen, device=dev) \
        * s.mask.reshape(-1, 1)
    # K2 in train mode at this batch (every teacher step's march), and K1
    # on the padded warm-up's points (all N * S slots are encoded)
    extra["k2_train"] = march_case(bits, o, d, nears, fars, rs_pad, u)
    log_march("K2", "exact teacher, train batch", extra["k2_train"])
    extra["k1_padded"] = k1_case(table, x01_pad, gs)
    log_k1("exact teacher, padded", extra["k1_padded"])
    rs_c = trainer.rspec
    _, _, s_c = teacher_batch(trainer, scene, gen, rs_c)
    budget = rs_c.sample_budget(trainer.cfg.num_rays)
    cmp = compact_samples(s_c.mask, budget, prefix=True)
    rid = cmp.ray_id
    t_c = s_c.t.reshape(-1)[cmp.idx]
    xyz_c = fma32(t_c[:, None], d[rid], o[rid]).clamp(-b, b)
    x01_c = ((xyz_c + b) / (2.0 * b)).contiguous()
    g_c = torch.randn(budget, gs.output_dim, generator=gen, device=dev) \
        * cmp.valid[:, None]

    results = []
    k7p = k7_case(x01_pad, g_pad, gs, library=False)
    extra["hash_encode_bwd_padded"] = k7p
    log_k7("exact teacher, padded", k7p)
    k7c = k7_case(x01_c, g_c, gs)
    log_k7("exact teacher, compacted", k7c)
    results.append(dict(
        name="hash_encode_bwd", source="pvd_tpu_torch/csrc/hash_encode.cu",
        replaces="pvd_tpu/ops/hashgrid.py:284", tol=TOL_K7_REL,
        err_kind="max |kernel - plain| / max |plain|",
        **{k: k7c[k] for k in ("err", "abs_err", "ms", "kernel_ms",
                               "call_ms", "plain_ms", "library_ms",
                               "bound")},
        library_call="index_add_ of the precomputed corner contributions "
        "(scatter only)",
        shape=f"M={budget} compacted points ({int(cmp.valid.sum())} valid, "
        f"{k7c['active_pairs']} active (point, level) pairs) x "
        f"{gs.num_levels} levels"))
    # K1 at the compacted shape, on the trained table
    extra["k1_compacted"] = k1_case(table, x01_c, gs)
    log_k1("exact teacher, compacted", extra["k1_compacted"])
    # K3 at the compacted shape (training: no early stop), on the trained
    # field's samples
    valid = cmp.valid
    with torch.no_grad():
        f_c = field(xyz_c, d[rid])
    dt_c = torch.where(valid, dt_min_of(rs_c), 0.0)
    t_cum = torch.where(valid, t_c + dt_c - s_c.t0[rid], 0.0)
    args3 = (f_c.sigma.float().contiguous(), f_c.rgb.float().contiguous(),
             dt_c, t_cum, rid, valid)
    extra["k3_compacted"] = k3_case(args3, trainer.cfg.num_rays, False)
    log_k3("exact teacher, compacted", extra["k3_compacted"])

    # K8 / K9 on the trained field's padded samples
    k8, k9 = k8_k9_case(field, xyz, d, s, rs_pad.density_scale, gen)
    log_k8_k9("exact teacher, padded", k8, k9)
    results += [padded_row("composite_rays", TOL_K8, k8,
                           ", early_stop off and on"),
                padded_row("composite_rays_bwd", TOL_K9, k9)]
    return results, extra


def k8_k9_case(field, xyz, d, s, density_scale: float, gen) -> tuple:
    """K8 (early stop off and on) and K9 against their plain versions on a
    trained field's padded samples (march output `s` [N, S] at positions
    xyz [N, S, 3] along d [N, 3]), with times and bounds: (k8, k9).  K8
    also alone with early stop; both alone on the same batch with its mask
    replaced by prefixes of 0-20 slots drawn uniformly, and the rows of
    both masks (`k9_rows`)."""
    N, S = s.mask.shape
    dev = xyz.device
    with torch.no_grad():
        f = field(xyz.reshape(-1, 3), d[:, None, :].expand(N, S, 3)
                  .reshape(-1, 3))
    sig = (f.sigma.reshape(N, S) * density_scale).float().contiguous()
    rgb = f.rgb.reshape(N, S, 3).float().contiguous()
    args8 = (sig, rgb, s.dt, s.delta_depth, s.mask)
    err8 = 0.0
    for early in (False, True):
        k = composite_rays_fwd(*args8, early_stop=early)
        p = composite_rays_plain(*args8, early_stop=early)
        err8 = max(err8, max(max_abs(a, c) for a, c in zip(k, p)))
    n_valid = int(s.mask.sum())
    gs9 = (torch.randn(N, generator=gen, device=dev),
           torch.randn(N, generator=gen, device=dev),
           torch.randn(N, 3, generator=gen, device=dev),
           torch.randn(N, S, generator=gen, device=dev))
    ws, _, _, weights = composite_rays_fwd(*args8)
    k9 = composite_rays_bwd(*args8, weights, *gs9)
    p9 = composite_rays_bwd_plain(*args8, *gs9)
    err9 = max(max_abs(a, c) for a, c in zip(k9, p9))
    shape = {"rays": N, "S": S, "valid": n_valid,
             "ws_mean": float(ws.mean())}
    k8 = {**shape, "err": err8, "bound": k8_bound(N, S, n_valid),
          "bound_every_slot": bound(N * S * 25 + N * S * 4 + N * 20,
                                    N * S * 16),
          **timings(lambda: composite_rays_fwd(*args8),
                    lambda: composite_rays_plain(*args8))}
    k8["early_stop"] = {"kernel_ms": kernel_ms(
        lambda: composite_rays_fwd(*args8, early_stop=True),
        "composite_padded_fwd_kernel")}
    k9 = {**shape, "err": err9, "rows": k9_rows(s.mask),
          "bound": k9_bound(N, S, n_valid),
          **timings(lambda: composite_rays_bwd(*args8, weights, *gs9),
                    lambda: composite_rays_bwd_plain(*args8, *gs9))}
    lens = torch.randint(0, 21, (N, 1), generator=gen, device=dev)
    mask_u = (torch.arange(S, device=dev) < lens).to(s.mask.dtype)
    args_u = (sig, rgb, s.dt, s.delta_depth, mask_u)
    w_u = composite_rays_fwd(*args_u)[3]
    k8["uniform_prefix"] = {
        "valid": int(mask_u.sum()), "kernel_ms": kernel_ms(
            lambda: composite_rays_fwd(*args_u),
            "composite_padded_fwd_kernel"),
        "bound": k8_bound(N, S, int(mask_u.sum())),
        "err": max(max_abs(a, c) for a, c in zip(
            composite_rays_fwd(*args_u), composite_rays_plain(*args_u)))}
    k8["err"] = max(err8, k8["uniform_prefix"]["err"])
    k9["uniform_prefix"] = {
        "rows": k9_rows(mask_u), "kernel_ms": kernel_ms(
            lambda: composite_rays_bwd(*args_u, w_u, *gs9),
            "composite_padded_bwd_kernel"),
        "err": max(max_abs(a, c) for a, c in zip(
            composite_rays_bwd(*args_u, w_u, *gs9),
            composite_rays_bwd_plain(*args_u, *gs9)))}
    k9["err"] = max(err9, k9["uniform_prefix"]["err"])
    return k8, k9


def k9_rows(mask) -> dict:
    """The rows of a padded mask [N, S] as K9 walks them (a warp a ray, in
    tiles of 32 slots, each tile's sums carried into the next): rows with
    a valid slot, their mean and largest valid count, tiles holding a
    valid slot, and whether every row's valid slots are a prefix."""
    valid = mask.bool()
    n = valid.sum(1)
    N, S = valid.shape
    t = -(-S // 32)
    m = torch.zeros(N, t * 32, dtype=torch.bool, device=mask.device)
    m[:, :S] = valid
    rows = int((n > 0).sum())
    return {"rows": rows, "mean": float(n.sum()) / max(rows, 1),
            "longest": int(n.max()) if N else 0,
            "tiles": int(m.view(N, t, 32).any(-1).sum()),
            "prefix": bool((valid[:, 1:] <= valid[:, :-1]).all())}


def k9_bound(N: int, S: int, n_valid: int) -> tuple:
    """K9's bound: bytes the mask [N, S], the valid slots' inputs
    (sigma, dt, delta_depth, weights, g_weights, rgb: 32 B), the per-ray
    upstream gradients (20 B) read once and both outputs (16 B a slot)
    written once; ops ~30 a valid slot."""
    return bound(N * S + n_valid * 32 + N * 20 + N * S * 16, n_valid * 30)


def k8_bound(N: int, S: int, n_valid: int) -> tuple:
    """K8's bound: bytes the mask [N, S] (1 B a slot) and the valid
    slots' sigma, dt, delta_depth and rgb (24 B) read once, the weights
    (4 B a slot) and the per-ray sums (20 B a ray) written once; ops ~16
    a valid slot."""
    return bound(N * S + n_valid * 24 + N * S * 4 + N * 20, n_valid * 16)


def log_k8_k9(label: str, k8: dict, k9: dict):
    """Log one k8_k9_case; raise above TOL_K8 or TOL_K9."""
    log(f"K8/K9 {label}: [{k8['rays']}, {k8['S']}], {k8['valid']} valid "
        f"slots (mask_frac {k8['valid'] / (k8['rays'] * k8['S']):.4f}), "
        f"weights_sum mean {k8['ws_mean']:.4f}")
    for name, c in (("K8", k8), ("K9", k9)):
        log(f"{name} {label}: max abs err {c['err']:.3g}, "
            f"{c['ms']:.4f} ms{alone(c)} (call {c['call_ms']:.4f}, plain "
            f"{c['plain_ms']:.4f}, bound {c['bound'][0]:.5f} "
            f"{c['bound'][1]})")
    u, e8, u8 = k9["uniform_prefix"], k8["early_stop"], \
        k8["uniform_prefix"]
    log(f"K8 {label}: the kernel alone with early stop "
        f"{e8['kernel_ms']:.4f} ms; bound {k8['bound'][0]:.5f} (every "
        f"slot's inputs counted: {k8['bound_every_slot'][0]:.5f}); on "
        f"prefixes of 0-20 slots ({u8['valid']} valid) the kernel alone "
        f"{u8['kernel_ms']:.4f} ms (bound {u8['bound'][0]:.5f}), max abs "
        f"err {u8['err']:.3g}")
    log(f"K9 {label}, rows {json.dumps(k9['rows'])}; on prefixes of 0-20 "
        f"slots (rows {json.dumps(u['rows'])}) the kernel alone "
        f"{u['kernel_ms']:.4f} ms, max abs err {u['err']:.3g}")
    if not (k8["err"] <= TOL_K8 and k9["err"] <= TOL_K9):
        raise RuntimeError(f"K8/K9 disagree with their plain versions "
                           f"({label})")


def padded_row(name: str, tol: float, c: dict, note: str = "") -> dict:
    """The kernels line's row of K8 ("composite_rays") or K9
    ("composite_rays_bwd") from a k8_k9_case at the exact teacher's
    padded batch."""
    return dict(
        name=name, source="pvd_tpu_torch/csrc/composite.cu",
        replaces="pvd_tpu/ops/composite.py:97", tol=tol,
        **{k: c[k] for k in ("err", "ms", "kernel_ms", "call_ms",
                             "plain_ms", "bound")},
        library_ms=None, shapes={"exact_teacher_padded": c},
        shape=f"[{c['rays']}, {c['S']}] padded slots ({c['valid']} valid)"
        + note)


def teacher_step_flavors(trainer, scene, label: str = "teacher") -> dict:
    """Launches of one teacher step and a profile of one step, for the
    padded (warm-up) and the compacted flavor, on the trained state."""
    train = scene["train"]
    out = {}
    images = torch.as_tensor(train.images_flat(), device=trainer.device)
    poses = torch.as_tensor(train.poses, device=trainer.device)
    flavors = {"padded": dataclasses.replace(
        trainer.rspec, max_samples=trainer.cfg.max_samples,
        samples_per_ray=0.0), "compacted": trainer.rspec}
    for name, rs in flavors.items():
        step = make_teacher_step(trainer.spec, rs, trainer.opt, trainer.cfg,
                                 train.intrinsics, train.H, train.W,
                                 image_channels=images.shape[-1],
                                 device=trainer.device)
        for i in range(3):  # warm-up
            step(trainer.state, poses[i], images[i], trainer.generator)
        torch.cuda.synchronize()
        reset_counters()
        step(trainer.state, poses[3], images[3], trainer.generator)
        torch.cuda.synchronize()
        launched = {k: v for k, v in counters().items() if v}
        prof = profile(lambda: step(trainer.state, poses[4], images[4],
                                    trainer.generator))
        log(f"{label} {name} step: launches {json.dumps(launched)}; profile "
            f"wall {prof['wall_ms']:.2f} ms, device busy "
            f"{prof['device_busy_ms']:.2f} ms (share "
            f"{prof['device_busy_share']:.3f})")
        for row in prof["top"]:
            log(f"  {row['ms']:9.3f} ms {row['calls']:6d} x {row['kernel']}")
        for kname, row in prof["ours"].items():
            log(f"  ours: {row['ms']:9.3f} ms {row['calls']:6d} x {kname}")
        out[name] = {"launches_per_step": launched, "profile": prof}
    return out


def small_teacher_gpu_vs_cpu(devices=("cuda", "cpu"), spec_kw=SMALL_TEA,
                             cfg_kw=None) -> dict:
    """One teacher step at test sizes, padded and compacted: kernels on
    the GPU against the plain path on the CPU, same params and draws
    (`spec_kw`: exact mode, cell mode with SMALL_CELL_TEA, or the large
    scene's SMALL_LS_TEA with `cfg_kw` SMALL_LS)."""
    rng = np.random.default_rng(12)
    spec = ModelSpec(**spec_kw)
    cfg_kw = cfg_kw or {}
    mode = ("large-scene" if spec.bg_radius > 0 else
            "cell" if spec.hash_cell_levels else "exact")
    tree = random_hash_params(spec, rng)
    C = PVDConfig(**cfg_kw).render_spec().cascades
    bits = rng.uniform(size=C * 32 ** 3) < (SMALL_LS_OCC
                                            if spec.bg_radius > 0 else 0.25)
    image = rng.uniform(size=(SMALL_HW ** 2, 4)).astype(np.float32)
    image[:, 3] = rng.choice([0.0, 1.0, 0.3], size=SMALL_HW ** 2)
    pose = nerf_matrix_to_ngp(pose_spherical(30.0, -30.0, 4.0), scale=0.8)
    n = SMALL_TEACHER_CFG["num_rays"]
    inds = torch.from_numpy(rng.integers(0, SMALL_HW ** 2, n))
    rays = get_rays(torch.from_numpy(pose)[None], SMALL_INTR, SMALL_HW,
                    SMALL_HW, inds)
    o, d = rays["rays_o"][0].contiguous(), rays["rays_d"][0].contiguous()
    pix = torch.from_numpy(image)[inds]
    bg = torch.from_numpy(rng.uniform(size=(n, 3)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(size=n).astype(np.float32))
    report = {}
    for spr in (0.0, 16.0):
        cfg = PVDConfig(**SMALL_TEACHER_CFG, samples_per_ray=spr, **cfg_kw)
        res = []
        for where in devices:
            field = hash_field_from_jax(tree, spec, where)
            occ = set_bitfield(init_occupancy_state(cfg.render_spec(), where),
                               torch.from_numpy(bits).to(where))
            params = dict(field.named_parameters())
            opt = build_optimizer(params, param_group_label(spec),
                                  trainable_label(spec, ""),
                                  exp_decay_schedule(1e-2, 100),
                                  exp_decay_schedule(1e-3, 100))
            state = TrainState(field=field, opt_state=opt.init(params),
                               occ=occ)
            step = make_teacher_step(spec, cfg.render_spec(), opt, cfg,
                                     SMALL_INTR, SMALL_HW, SMALL_HW, 4,
                                     device=where)
            state, m = step.core(state, *(t.to(where)
                                          for t in (o, d, pix, bg, u)))
            res.append(({k: float(v) for k, v in m.items()},
                        hash_tree_from_field(field, grad=True),
                        hash_tree_from_field(field)))
        c = compare_steps(*res)
        lc = res[1][0]
        flavor = "compacted" if spr else "padded"
        log(f"{mode}-mode teacher step GPU kernels vs CPU plain (test "
            f"sizes, {flavor}, f32 heads): max rel loss/metric diff "
            f"{c['loss_rel_err']:.3g} (tol {STEP_LOSS_RTOL:g}); max grad "
            f"diff / leaf max {c['grad_err_rel_leaf_max']:.3g} "
            f"({c['grad_err_leaf']}; tol {STEP_GRAD_REL_ATOL:g} + rtol "
            f"{STEP_GRAD_RTOL:g}); max param "
            f"diff under the gradient mask {c['param_err']:.3g} (tol "
            f"{STEP_PARAM_TOL:g}); loss {lc['loss']:.6g}, mask_frac "
            f"{lc['mask_frac']:.3f}")
        if not c.pop("ok"):
            raise RuntimeError(f"the GPU {mode}-mode teacher step "
                               f"({flavor}) disagrees with the CPU plain "
                               "step")
        report[flavor] = c
    return report


def drive_ab_recipe(seed: int, workspace: str) -> tuple:
    """The JAX package's quality A/B through the Trainer: a cell-mode hash
    teacher whose val eval writes `hash_best.ckpt`, then a distill Trainer
    that loads that file and trains a VM student; both evaluated on the
    test views.  Returns (teacher trainer, student trainer, scene, info)."""
    t0 = time.perf_counter()
    scene = make_synthetic_scene(**AB_SCENE, seed=seed,
                                 scale=PVDConfig().scale)
    scene_s = time.perf_counter() - t0
    cfg_t = PVDConfig(**AB_TEACHER, seed=seed,
                      workspace=os.path.join(workspace, "teacher"))
    tea = Trainer(cfg_t)
    gs = tea.state.field.grid
    log(f"A/B recipe: {AB_SCENE} (scene made in {scene_s:.1f} s); teacher "
        f"hash, cell levels {gs.cell_levels} (cell table "
        f"{gs.cell_table_size} x {gs.cell_row_width}, corner table "
        f"{gs.table_size} x 2), {cfg_t.iters} steps of {cfg_t.num_rays} "
        f"rays, grid {cfg_t.grid_size}, heads {tea.spec.compute_dtype}")
    tea.train(scene["train"], valid_ds=scene["val"])
    best = os.path.join(tea.workspace, "checkpoints", "hash_best.ckpt")
    if not os.path.exists(best):
        raise RuntimeError(f"the teacher's val eval wrote no {best}")
    st_t = tea.evaluate(scene["test"])
    hist = tea.history
    first = float(np.mean([float(m["psnr"]) for m in hist[:16]]))
    last = float(np.mean([float(m["psnr"]) for m in hist[-16:]]))

    cfg_d = PVDConfig(**AB_DISTILL, seed=seed,
                      workspace=os.path.join(workspace, "h2v"))
    stu = Trainer(cfg_d, mode="distill")
    stu.load_teacher(best)
    log(f"A/B distill: vm {stu.spec_stu.vm_resolution} ranks "
        f"{stu.spec_stu.vm_sigma_rank}/{stu.spec_stu.vm_color_rank}, "
        f"{cfg_d.iters} steps (stages at {cfg_d.stage1_iters}/"
        f"{cfg_d.stage2_iters}) of {cfg_d.num_rays} rays, max_samples "
        f"{cfg_d.max_samples}, samples_per_ray {cfg_d.samples_per_ray:g}; "
        f"teacher from {os.path.basename(best)}")
    stu.train(scene["train"], valid_ds=scene["val"])
    st_s = stu.evaluate(scene["test"])
    st_tt = stu.evaluate(scene["test"], use_teacher=True)

    def brief(st):
        return {k: st[k] for k in ("psnr", "ssim", "eval_s_per_image",
                                   "eval_s_first_image")}

    info = {"teacher": brief(st_t), "student": brief(st_s),
            "teacher_reloaded": brief(st_tt),
            "teacher_train_psnr_first16": first,
            "teacher_train_psnr_last16": last,
            "teacher_train_stats": tea.train_stats,
            "student_train_stats": stu.train_stats,
            "teacher_rspec_final": {
                "max_samples": tea.rspec.max_samples,
                "samples_per_ray": tea.rspec.samples_per_ray},
            "jax_tpu_reference": AB_JAX_TPU}
    for name, st in (("teacher", st_t), ("student", st_s),
                     ("teacher reloaded by the distill Trainer", st_tt)):
        log(f"A/B {name}: test PSNR {st['psnr']:.3f} dB, SSIM "
            f"{st['ssim']:.4f} over {len(scene['test'])} views, "
            f"{st['eval_s_per_image'] * 1e3:.1f} ms per image")
    log(f"A/B reference (JAX package, TPU, STATUS.md:78): teacher "
        f"{AB_JAX_TPU['teacher']}, student {AB_JAX_TPU['student']}")
    log("A/B teacher train_stats " + json.dumps(tea.train_stats))
    log("A/B student train_stats " + json.dumps(stu.train_stats))
    pt, ps = st_t["psnr"], st_s["psnr"]
    if not (np.isfinite(pt) and pt >= AB_TEACHER_FLOOR):
        raise RuntimeError(f"A/B teacher test PSNR {pt:.3f} < "
                           f"{AB_TEACHER_FLOOR}")
    if not (np.isfinite(ps) and ps >= AB_STUDENT_FLOOR
            and ps >= pt - AB_MAX_DROP):
        raise RuntimeError(f"A/B student test PSNR {ps:.3f}: floor "
                           f"{AB_STUDENT_FLOOR}, teacher {pt:.3f} - "
                           f"{AB_MAX_DROP}")
    if abs(st_tt["psnr"] - pt) > 1e-3:
        raise RuntimeError("the teacher reloaded from its checkpoint "
                           f"renders {st_tt['psnr']:.3f} dB, trained "
                           f"{pt:.3f}")
    if not last > first:
        raise RuntimeError("A/B teacher train-batch PSNR did not rise")
    return tea, stu, scene, info


def k10_case(cell, x01, gs) -> dict:
    """K10 alone (its wrapper writes the cell levels' slots of a [P, L * 2]
    output) against hash_encode_cell_plain on points x01, NaN where the
    plain version gives NaN: the error relative to max |plain| (finite
    entries), times and the bound."""
    P, Lc = x01.shape[0], len(gs.cell_levels)
    out = torch.zeros(P, gs.output_dim, device=x01.device)
    cols = [c for lv in gs.cell_levels for c in (2 * lv, 2 * lv + 1)]
    k = hash_encode_cell_fwd(cell, x01, gs, out)[:, cols]
    p = hash_encode_cell_plain(cell, x01, gs)
    abs10 = nan_abs(k, p)
    inside = ((x01 >= 0) & (x01 <= 1)).all(-1)
    rows = torch.stack([cell_corners(x01, gs, lv)[1] for lv in
                        gs.cell_levels], 1)
    touched = int(rows[inside].unique().numel())
    # bytes: x01 and the touched 64-byte rows read once, [P, Lc, 2] out
    # written once; ops: ~50 per pair (lattice, 8 weights, 16 FMAs)
    return {"points": P, "levels": Lc, "abs_err": abs10,
            "err": abs10 / float(torch.nan_to_num(p).abs().max()),
            "touched_rows": touched,
            "bound": bound(P * 12 + touched * 64 + P * Lc * 8, P * Lc * 50),
            **timings(lambda: hash_encode_cell_fwd(cell, x01, gs, out),
                      lambda: hash_encode_cell_plain(cell, x01, gs))}


def cell_case(trainer, x01, valid, gen) -> dict:
    """K10 and K11 against their plain versions on one batch of the cell
    teacher's points, with times, bounds and library yardsticks."""
    field = trainer.state.field
    gs = field.grid
    table, cell = field.encoder.detach(), field.encoder_cell.detach()
    dev = x01.device
    P, Lc = x01.shape[0], len(gs.cell_levels)
    # K1 + K10 into one output, and K10 alone, against the plain versions
    with torch.no_grad():
        full_k = hash_encode(table, x01, gs, cell)
    full_p = hash_encode_plain(table, x01, gs, cell)
    c10 = k10_case(cell, x01, gs)
    p10 = hash_encode_cell_plain(cell, x01, gs)
    err10 = max(max_abs(full_k, full_p) / float(full_p.abs().max()),
                c10["err"])
    abs10 = max(max_abs(full_k, full_p), c10["abs_err"])
    g = torch.randn(P, gs.output_dim, generator=gen, device=dev) \
        * valid.reshape(-1, 1)
    k11 = hash_encode_cell_bwd(x01, g, gs)
    p11 = hash_encode_cell_bwd_plain(x01, g, gs)
    abs11 = max_abs(k11, p11)
    err11 = abs11 / float(p11.abs().max())
    # the corner rows and weights each (point, cell level) pair needs
    rows, ws = [], []
    for level in gs.cell_levels:
        w, r = cell_corners(x01, gs, level)
        rows.append(r)
        ws.append(w.T)
    rows, ws = torch.stack(rows, 1), torch.stack(ws, 1)  # [P, Lc], [.., 8]
    inside = ((x01 >= 0) & (x01 <= 1)).all(-1)
    g_cell = g.reshape(P, gs.num_levels, 2)[:, gs.cell_levels]  # [P, Lc, 2]
    active = (g_cell != 0).any(-1) & inside[:, None]
    n_active = int(active.sum())
    # bytes: x01 and g's cell slots read once, the dense [Tc, 16] gradient
    # written once; ops: ~66 per active pair (the weights, 16 products)
    b11 = bound(P * 12 + P * Lc * 8 + gs.cell_table_size * 64,
                n_active * 66)
    # library yardsticks on the precomputed rows and weights: one
    # embedding_bag (gather + weighted sum over the 8 corners of a row,
    # viewed as [Tc * 8, 2]) and one index_add_ (the scatter alone)
    import torch.nn.functional as F

    bag_idx = (rows[..., None] * 8 + torch.arange(8, device=dev)) \
        .reshape(-1, 8)
    bag_w = ws.reshape(-1, 8).contiguous()
    cell8 = cell.reshape(-1, 2)

    def lib10():
        return F.embedding_bag(bag_idx, cell8, mode="sum",
                               per_sample_weights=bag_w)

    lib10_err = max_abs(lib10().reshape(P, Lc * 2), p10)
    add_rows = rows.reshape(-1)
    add_vals = (ws[..., :, None] * g_cell[:, :, None, :]).reshape(P * Lc, 16)

    def lib11():
        return torch.zeros(gs.cell_table_size, 16, device=dev).index_add_(
            0, add_rows, add_vals)

    t11 = timings(lambda: hash_encode_cell_bwd(x01, g, gs),
                  lambda: hash_encode_cell_bwd_plain(x01, g, gs))
    return {"err10": err10, "abs10": abs10, "err11": err11, "abs11": abs11,
            "points": P, "pairs": P * Lc, "active_pairs": n_active,
            "touched_rows": c10["touched_rows"], "bound10": c10["bound"],
            "bound11": b11,
            "t10": {k: c10[k] for k in ("ms", "kernel_ms", "call_ms",
                                        "plain_ms")},
            "t11": t11,
            # the call split: the kernel alone, and the wrapper's zero fill
            # of the dense [Tc, 16] gradient alone
            "k11_kernel_ms": t11["kernel_ms"],
            "k11_fill_ms": cuda_ms(lambda: torch.zeros(
                gs.cell_table_size, gs.cell_row_width, device=dev)),
            "lib10_ms": cuda_ms(lib10), "lib10_abs_err": lib10_err,
            "lib11_ms": cuda_ms(lib11)}


def log_cell_case(label: str, c: dict):
    """Log one cell_case; raise above TOL_K10_REL or TOL_K11_REL."""
    log(f"K10/K11 {label} batch: {c['points']} points, {c['pairs']} "
        f"(point, cell level) pairs ({c['active_pairs']} active), "
        f"{c['touched_rows']} cell rows touched; K10 rel err "
        f"{c['err10']:.3g}, {c['t10']['ms']:.4f} ms{alone(c['t10'])} (call "
        f"{c['t10']['call_ms']:.4f}, plain {c['t10']['plain_ms']:.4f}, "
        f"embedding_bag {c['lib10_ms']:.4f}, bound "
        f"{c['bound10'][0]:.4f} {c['bound10'][1]}); K11 rel err "
        f"{c['err11']:.3g}, {c['t11']['ms']:.4f} ms{alone(c['t11'])} (call "
        f"{c['t11']['call_ms']:.4f}, plain {c['t11']['plain_ms']:.4f}, "
        f"index_add_ {c['lib11_ms']:.4f}, bound {c['bound11'][0]:.4f} "
        f"{c['bound11'][1]}; the zero fill alone {c['k11_fill_ms']:.4f})")
    if not (c["err10"] <= TOL_K10_REL and c["err11"] <= TOL_K11_REL):
        raise RuntimeError(f"K10/K11 disagree with their plain versions "
                           f"on the {label} batch")


def check_cell_kernels(trainer, scene, gen) -> tuple:
    """K10 and K11 on the cell teacher's padded warm-up batch and its
    compacted batch (the kernels line carries the compacted one); K7 and
    K1 on the compacted batch's corner levels."""
    b = trainer.rspec.bound
    rs_pad = dataclasses.replace(trainer.rspec,
                                 max_samples=trainer.cfg.max_samples,
                                 samples_per_ray=0.0)
    o, d, s = teacher_batch(trainer, scene, gen, rs_pad)
    xyz = fma32(s.t[..., None], d[:, None, :], o[:, None, :]).clamp(-b, b)
    x01_pad = ((xyz.reshape(-1, 3) + b) / (2.0 * b)).contiguous()
    k8, k9 = k8_k9_case(trainer.state.field, xyz, d, s,
                        rs_pad.density_scale, gen)
    log_k8_k9("cell teacher, padded", k8, k9)
    rs_c = trainer.rspec
    o, d, s_c = teacher_batch(trainer, scene, gen, rs_c)
    budget = rs_c.sample_budget(trainer.cfg.num_rays)
    cmp = compact_samples(s_c.mask, budget, prefix=True)
    rid = cmp.ray_id
    t_c = s_c.t.reshape(-1)[cmp.idx]
    xyz_c = fma32(t_c[:, None], d[rid], o[rid]).clamp(-b, b)
    x01_c = ((xyz_c + b) / (2.0 * b)).contiguous()
    cases = {"padded": cell_case(trainer, x01_pad, s.mask.reshape(-1), gen),
             "compacted": cell_case(trainer, x01_c, cmp.valid, gen)}
    for name, c in cases.items():
        log_cell_case(f"cell teacher, {name}", c)
    c = cases["compacted"]
    shape = (f"{c['points']} compacted pts x "
             f"{len(trainer.state.field.grid.cell_levels)} cell levels "
             f"({c['active_pairs']} active pairs)")
    results = [
        dict(name="hash_encode_cell_fwd",
             source="pvd_tpu_torch/csrc/hash_encode.cu",
             replaces="pvd_tpu/ops/hashgrid.py:332", err=c["err10"],
             abs_err=c["abs10"], tol=TOL_K10_REL,
             err_kind="max |kernel - plain| / max |plain|", **c["t10"],
             library_ms=c["lib10_ms"],
             library_call="F.embedding_bag(mode='sum', per_sample_weights) "
             "on the precomputed corner rows and weights",
             bound=c["bound10"], shape=shape),
        dict(name="hash_encode_cell_bwd",
             source="pvd_tpu_torch/csrc/hash_encode.cu",
             replaces="pvd_tpu/ops/hashgrid.py:362", err=c["err11"],
             abs_err=c["abs11"], tol=TOL_K11_REL,
             err_kind="max |kernel - plain| / max |plain|", **c["t11"],
             library_ms=c["lib11_ms"],
             library_call="index_add_ of the precomputed row contributions "
             "(scatter only)", bound=c["bound11"], shape=shape,
             shapes={"cell_teacher_compacted": {
                 k: c[k] for k in ("points", "active_pairs", "k11_kernel_ms",
                                   "k11_fill_ms")}})]
    # K7 and K1 on the corner levels (0-4) of the compacted batch
    gs = trainer.state.field.grid
    table = trainer.state.field.encoder.detach()
    g7 = torch.randn(x01_c.shape[0], gs.output_dim, generator=gen,
                     device=x01_c.device) * cmp.valid[:, None]
    k7 = k7_case(x01_c, g7, gs)
    log_k7("cell teacher, compacted", k7)
    k1 = k1_case(table, x01_c, gs)
    log_k1("cell teacher, compacted", k1)
    # K6 on the compacted stream (the cell teacher's own fields)
    with torch.no_grad():
        f_c = trainer.state.field(xyz_c, d[rid])
    dt_c = torch.where(cmp.valid, dt_min_of(rs_c), 0.0)
    t_cum = torch.where(cmp.valid, t_c + dt_c - s_c.t0[rid], 0.0)
    k6 = k6_case((f_c.sigma.float().contiguous(), f_c.rgb.float()
                  .contiguous(), dt_c, t_cum, rid, cmp.valid,
                  trainer.cfg.num_rays), gen)
    log_k6("cell teacher, compacted", k6)
    extra = {"padded": cases["padded"], "k7_compacted": k7,
             "k1_compacted": k1, "k6_compacted": k6, "k8_padded": k8,
             "k9_padded": k9,
             "vector_atomics": bool(kernels.load()
                                    .pvd_hash_cell_vector_atomics())}
    return results, extra


def distill_step_profile(stu, scene, gen, label: str = "A/B",
                         teacher=None) -> dict:
    """Launches and a profile of one stage-3 step of the distill Trainer's
    state, from one of its random poses (with `teacher` in place of the
    Trainer's)."""
    teacher = stu.teacher if teacher is None else teacher
    train = scene["train"]
    intr = tuple(float(v) for v in train.intrinsics)
    emap = stu.cfg.error_map
    step = make_distill_step(stu.spec_stu, stu.spec_tea, stu.rspec, stu.opt,
                             stu.cfg, intr, train.H, train.W, 3,
                             device=stu.device, use_error_map=emap)
    pose = torch.as_tensor(get_rand_poses(np.random.default_rng(0))[0],
                           device=stu.device)
    row = torch.ones(128 * 128, device=stu.device)

    def one():
        if emap:  # the error-map flavor, on a row of ones
            step(stu.state, teacher, stu.occ_tea, pose, row, gen)
        else:
            step(stu.state, teacher, stu.occ_tea, pose, gen)

    for _ in range(3):  # warm-up
        one()
    torch.cuda.synchronize()
    reset_counters()
    one()
    torch.cuda.synchronize()
    launched = {k: v for k, v in counters().items() if v}
    prof = profile(one)
    log(f"{label} distill stage-3 step: launches {json.dumps(launched)}; "
        f"profile wall {prof['wall_ms']:.2f} ms, device busy "
        f"{prof['device_busy_ms']:.2f} ms (share "
        f"{prof['device_busy_share']:.3f})")
    for row in prof["top"]:
        log(f"  {row['ms']:9.3f} ms {row['calls']:6d} x {row['kernel']}")
    for kname, row in prof["ours"].items():
        log(f"  ours: {row['ms']:9.3f} ms {row['calls']:6d} x {kname}")
    return {"launches_per_step": launched, "profile": prof}


def cli_argv(scene: str, workspace: str, best: str, seed: int) -> list:
    """The distillation CLI's flags for the A/B distill config (AB_DISTILL)
    with a baked teacher.  --preload: the CLI's flag defaults to off where
    PVDConfig's field defaults to on (the distill Trainer reads neither)."""
    d = dict(AB_DISTILL)
    argv = [scene, "--workspace", workspace, "--seed", str(seed),
            "--hash_bake_dense", "--ckpt_teacher", best, "--preload",
            "--stage_iters", f"stage1={d.pop('stage1_iters')},"
            f"stage2={d.pop('stage2_iters')}"]
    if not d.pop("autotune_budget", True):
        argv.append("--no_autotune_budget")
    for k, v in d.items():
        argv += [f"--{k}", str(v)]
    return argv


def largest_baked_encode(fn) -> tuple:
    """fn() with HashField.encode recording the input of its baked encodes
    (K15's x01, as encode forms it): fn's result and a copy of the largest
    x01 it sent, one eval chunk's samples when fn renders."""
    seen = []
    encode = HashField.encode

    def recording(field, x):
        if field.baked is not None and (not seen
                                        or x.shape[0] > seen[0].shape[0]):
            b = field.spec.bound
            seen[:] = [((x + b) / (2.0 * b)).detach().clone()]
        return encode(field, x)

    HashField.encode = recording
    try:
        return fn(), (seen[0] if seen else None)
    finally:
        HashField.encode = encode


def drive_distill_cli(seed: int, workspace: str, best: str,
                      ab: dict) -> dict:
    """The distillation CLI with a baked teacher on the A/B recipe: the
    scene written to disk, `main` trains and evaluates, then `--test` and
    `--test_teacher` render the renamed workspace again (the largest
    teacher encode of the last kept, "test_teacher_chunk_x01")."""
    t0 = time.perf_counter()
    scene = write_synthetic_scene(os.path.join(workspace, "scene"),
                                  **AB_SCENE, seed=seed)
    write_s = time.perf_counter() - t0
    ws = os.path.join(workspace, "h2v_cli")
    argv = cli_argv(scene, ws, best, seed)
    _, cfg = distill_cli.parse_args(argv)
    want = PVDConfig(**AB_DISTILL, seed=seed)
    differ = sorted(f.name for f in dataclasses.fields(PVDConfig)
                    if getattr(cfg, f.name) != getattr(want, f.name))
    log(f"distill CLI: {' '.join(argv[1:])}")
    log(f"distill CLI config differs from the A/B distill config in "
        f"{differ}")
    if set(differ) != {"hash_bake_dense", "path", "workspace",
                       "ckpt_teacher"}:
        raise RuntimeError(f"the CLI's config is not the A/B distill "
                           f"config: {differ}")
    t0 = time.perf_counter()
    stats = distill_cli.main(argv)
    train_s = time.perf_counter() - t0
    done = glob.glob(ws + "-psnr*")
    if len(done) != 1:
        raise RuntimeError(f"no renamed workspace for {ws}: {done}")
    done = done[0]
    with open(os.path.join(done, "metrics.json")) as f:
        metrics = json.load(f)
    if metrics["psnr"] != stats["psnr"] or not glob.glob(
            os.path.join(done, "checkpoints", "hash2vm_*.ckpt")):
        raise RuntimeError("metrics.json or the checkpoints are missing")
    again = cli_argv(scene, done, best, seed)
    t0 = time.perf_counter()
    test = distill_cli.main(again + ["--test"])
    test_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    test_tea, chunk = largest_baked_encode(
        lambda: distill_cli.main(again + ["--test_teacher"]))
    test_tea_s = time.perf_counter() - t0
    H, W = AB_SCENE["H"], AB_SCENE["W"]
    for i in range(AB_SCENE["n_test"]):
        for name, shape in ((f"hash2vm_{i:04d}.png", (H, W, 3)),
                            (f"hash2vm_{i:04d}_depth.png", (H, W, 1))):
            img = read_png(os.path.join(done, "results", name))
            if img.shape != shape:
                raise RuntimeError(f"{name}: shape {img.shape} != {shape}")
    ps, pt = stats["psnr"], test_tea["psnr"]
    exact_s, exact_t = ab["student"]["psnr"], ab["teacher_reloaded"]["psnr"]
    info = {"argv": argv[1:], "scene": scene, "scene_write_s": write_s,
            "train_s": train_s,
            "test_s": test_s, "test_teacher_s": test_tea_s,
            "student": {k: stats[k] for k in ("psnr", "ssim", "lpips_proxy",
                                              "eval_s_per_image")},
            "student_reloaded_psnr": test["psnr"],
            "teacher": {k: test_tea[k] for k in ("psnr", "ssim",
                                                 "lpips_proxy",
                                                 "eval_s_per_image")},
            "baked_minus_exact_db": {"teacher": pt - exact_t,
                                     "student": ps - exact_s},
            "train_stats": {k: v for k, v in stats.items()
                            if k.startswith(("train_", "stage"))},
            "workspace_files": sorted(os.listdir(done)),
            "test_teacher_chunk_x01": chunk}
    log(f"distill CLI (baked teacher): scene written in {write_s:.1f} s; "
        f"train+eval {train_s:.1f} s, --test {test_s:.1f} s, --test_teacher "
        f"{test_tea_s:.1f} s; student {ps:.3f} dB (SSIM {stats['ssim']:.4f}, "
        f"reloaded {test['psnr']:.3f}), baked teacher {pt:.3f} dB; exact "
        f"A/B student {exact_s:.3f}, teacher {exact_t:.3f}: baked - exact "
        f"student {ps - exact_s:+.3f}, teacher {pt - exact_t:+.3f} dB")
    log("distill CLI train_stats " + json.dumps(info["train_stats"]))
    if not (np.isfinite(ps) and ps >= CLI_STUDENT_FLOOR
            and ps >= exact_s - CLI_MAX_DROP):
        raise RuntimeError(f"baked-teacher student {ps:.3f} dB: floor "
                           f"{CLI_STUDENT_FLOOR}, exact student {exact_s:.3f}"
                           f" - {CLI_MAX_DROP}")
    if abs(test["psnr"] - ps) > 1e-3 or not np.isfinite(pt):
        raise RuntimeError(f"--test renders {test['psnr']:.3f} dB against "
                           f"{ps:.3f}; --test_teacher {pt}")
    return info


def cli_flags(d: dict) -> list:
    """A config dict (AB_TEACHER, FIELD_TEACHER, ...) as CLI flags."""
    d = dict(d)
    argv = []
    if "stage1_iters" in d:
        argv += ["--stage_iters", f"stage1={d.pop('stage1_iters')},"
                 f"stage2={d.pop('stage2_iters')}"]
    if not d.pop("autotune_budget", True):
        argv.append("--no_autotune_budget")
    for k, v in d.items():
        if isinstance(v, tuple):  # an appended flag, once per value
            for x in v:
                argv += [f"--{k}", str(x)]
        else:
            argv += [f"--{k}"] if v is True else [f"--{k}", str(v)]
    return argv


def renamed(ws: str) -> str:
    """The workspace `ws` renamed with its PSNR suffix by finalize_run."""
    done = glob.glob(ws + "-psnr*")
    if len(done) != 1:
        raise RuntimeError(f"no renamed workspace for {ws}: {done}")
    return done[0]


def run_teacher_cli(argv: list, label: str, kernels: tuple) -> dict:
    """`python -m pvd_tpu_torch.cli.train_teacher` (its `main`) on argv,
    then `--test` on the renamed workspace; the launch counters set to 0
    just before the training run and read just after it.  The run must
    have taken its batches from the host batcher exactly when argv has
    no --preload.  Returns the stats, the launches, the renamed workspace
    and the run's config."""
    reset_counters()
    t0 = time.perf_counter()
    stats = teacher_cli.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = counters()
    for name in kernels:
        if launches[name] <= 0:
            raise RuntimeError(f"kernel {name} never launched on the "
                               f"{label} path")
    ws = argv[argv.index("--workspace") + 1]
    done = renamed(ws)
    again = list(argv)
    again[again.index("--workspace") + 1] = done
    t0 = time.perf_counter()
    test = teacher_cli.main(again + ["--test"])
    test_s = time.perf_counter() - t0
    if stats.get("host_batcher") != ("--preload" not in argv):
        raise RuntimeError(f"the {label} did not take its batches where "
                           f"its flags say (host_batcher "
                           f"{stats.get('host_batcher')})")
    log(f"{label}: train+eval {train_s:.1f} s, --test {test_s:.1f} s; test "
        f"PSNR {stats['psnr']:.3f} dB (SSIM {stats['ssim']:.4f}), --test "
        f"reload {test['psnr']:.3f}; padded "
        f"{stats['padded_ms_per_step']:.3f} ms/step, compacted "
        f"{stats['compacted_ms_per_step']:.3f}; launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")
    log(f"{label} train_stats " + json.dumps(
        {k: v for k, v in stats.items() if k.startswith(
            ("train_", "padded", "compacted", "occ_", "host_"))}))
    return {"stats": stats, "test_psnr": test["psnr"], "train_s": train_s,
            "test_s": test_s, "launches": launches, "workspace": done,
            "cfg": teacher_cli.parse_args(again)[1]}


def host_step_profiles(run: dict, name: str, label: str) -> dict:
    """Launches and a profile of one padded and one compacted host-batcher
    teacher step of the run's field, loaded from its last checkpoint, on
    batches of a RayBatcher over its training views."""
    cfg = run["cfg"]
    tr = Trainer(cfg)
    tr.load_student(ckpt.latest_checkpoint(os.path.join(
        run["workspace"], "checkpoints"), name))
    ds = NeRFDataset(cfg, "train")
    poses = torch.as_tensor(ds.poses, device=tr.device)
    batcher = RayBatcher(ds.images, cfg.num_rays, seed=cfg.seed)
    out = {}
    flavors = {"padded": dataclasses.replace(tr.rspec, samples_per_ray=0.0),
               "compacted": tr.rspec}
    try:
        for flv, rs in flavors.items():
            step = make_teacher_step_host(
                tr.spec, rs, tr.opt, cfg, ds.intrinsics, ds.H, ds.W,
                image_channels=ds.images.shape[-1], device=tr.device)

            def one():
                idx, inds, pix = batcher.next()
                step(tr.state, poses[idx], inds, pix, tr.generator)

            for _ in range(3):  # warm-up
                one()
            torch.cuda.synchronize()
            reset_counters()
            one()
            torch.cuda.synchronize()
            launched = {k: v for k, v in counters().items() if v}
            prof = profile(one)
            log(f"{label} {flv} host step: launches {json.dumps(launched)};"
                f" profile wall {prof['wall_ms']:.2f} ms, device busy "
                f"{prof['device_busy_ms']:.2f} ms (share "
                f"{prof['device_busy_share']:.3f})")
            for row in prof["top"]:
                log(f"  {row['ms']:9.3f} ms {row['calls']:6d} x "
                    f"{row['kernel']}")
            out[flv] = {"launches_per_step": launched, "profile": prof}
    finally:
        batcher.close()
    return out


def drive_teacher_cli(seed: int, workspace: str, scene: str,
                      ab: dict) -> dict:
    """The teacher CLI on the A/B scene on disk with the A/B teacher's
    flags and no --preload, so on the host batcher; floors against the
    Python-API A/B teacher of the same run."""
    argv = [scene, "--workspace", os.path.join(workspace, "hash_cli"),
            "--seed", str(seed)] + cli_flags(AB_TEACHER)
    _, cfg = teacher_cli.parse_args(argv)
    want = PVDConfig(**AB_TEACHER, seed=seed)
    differ = sorted(f.name for f in dataclasses.fields(PVDConfig)
                    if getattr(cfg, f.name) != getattr(want, f.name))
    log(f"teacher CLI: {' '.join(argv[1:])}; config differs from the A/B "
        f"teacher's in {differ}")
    # the teacher parser's distill loss rates (the JAX CLI's defaults) are
    # not read by a teacher step
    if set(differ) != {"path", "workspace", "preload", "loss_rate_fea_sc",
                       "loss_rate_color", "loss_rate_sigma"}:
        raise RuntimeError(f"the teacher CLI's config is not the A/B "
                           f"teacher's: {differ}")
    run = run_teacher_cli(argv, "teacher CLI", TEACHER_KERNELS + (
        "hash_encode_cell_fwd", "hash_encode_cell_bwd"))
    st, api = run["stats"], ab["teacher_train_stats"]
    pt, pa = st["psnr"], ab["teacher"]["psnr"]
    prof = host_step_profiles(run, "hash", "teacher CLI")
    info = {"argv": argv[1:], "psnr": pt, "ssim": st["ssim"],
            "test_reload_psnr": run["test_psnr"], "api_psnr": pa,
            "train_s": run["train_s"], "test_s": run["test_s"],
            "host_batcher": st["host_batcher"],
            "ms_per_step": {k: (st[f"{k}_ms_per_step"],
                                api[f"{k}_ms_per_step"])
                            for k in ("padded", "compacted")},
            "train_stats": {k: v for k, v in st.items()
                            if k.startswith(("train_", "padded",
                                             "compacted", "occ_"))},
            "launches": run["launches"], "step_profiles": prof}
    log(f"teacher CLI (host batcher {st['host_batcher']}): "
        f"test PSNR {pt:.3f} dB against the Python-API A/B teacher's "
        f"{pa:.3f}; ms per step padded {st['padded_ms_per_step']:.3f} "
        f"(API {api['padded_ms_per_step']:.3f}), compacted "
        f"{st['compacted_ms_per_step']:.3f} (API "
        f"{api['compacted_ms_per_step']:.3f})")
    if not (np.isfinite(pt) and pt >= TEACHER_CLI_FLOOR
            and pt >= pa - TEACHER_CLI_MAX_DROP):
        raise RuntimeError(f"teacher CLI test PSNR {pt:.3f}: floor "
                           f"{TEACHER_CLI_FLOOR}, API teacher {pa:.3f} - "
                           f"{TEACHER_CLI_MAX_DROP}")
    if abs(run["test_psnr"] - pt) > TEACHER_CLI_RELOAD_DB:
        raise RuntimeError(f"teacher CLI --test renders {run['test_psnr']:.3f}"
                           f" dB against {pt:.3f}")
    return info


def grid_sample_case(volume, n: int, gen) -> dict:
    """grid_sample_3d (the plenoxel query: eight row gathers, autograd's
    scatter as the backward) beside F.grid_sample on the [1, C, D, H, W]
    view, forward and forward + backward, at n random points of the
    trained volume."""
    c = (torch.rand(n, 3, generator=gen, device=volume.device) * 2 - 1)
    vol = volume.detach().clone().requires_grad_(True)
    view = vol.detach().permute(3, 0, 1, 2)[None].contiguous() \
        .requires_grad_(True)
    g = torch.randn(n, vol.shape[-1], generator=gen, device=vol.device)

    def ours():
        return grid_sample_3d(vol, c)

    def lib():
        return torch.nn.functional.grid_sample(
            view, c[None, :, None, None, :], align_corners=True,
            padding_mode="zeros")[0, :, :, 0, 0].T

    def ours_bwd():
        vol.grad = None
        (ours() * g).sum().backward()

    def lib_bwd():
        view.grad = None
        (lib() * g).sum().backward()

    with torch.no_grad():
        err = max_abs(ours(), lib())
    out = {"n": n, "channels": vol.shape[-1], "max_abs_diff": err,
           "fwd_ms": cuda_ms(ours), "library_fwd_ms": cuda_ms(lib),
           "fwd_bwd_ms": cuda_ms(ours_bwd),
           "library_fwd_bwd_ms": cuda_ms(lib_bwd)}
    log(f"grid_sample_3d at {n} points of the {tuple(vol.shape)} volume: "
        f"fwd {out['fwd_ms']:.4f} ms (F.grid_sample "
        f"{out['library_fwd_ms']:.4f}), fwd+bwd {out['fwd_bwd_ms']:.4f} "
        f"(F.grid_sample {out['library_fwd_bwd_ms']:.4f}); max |diff| "
        f"{err:.3g}")
    return out


def distill_cli_run(seed: int, workspace: str, scene: str, tea: str,
                    stu: str, best: str, gen, flags: dict = FIELD_DISTILL,
                    kernels: tuple = FIELD_DISTILL_KERNELS, extra=(),
                    label: str = "") -> dict:
    """The distill CLI on `tea`'s best checkpoint into a `stu` student
    (`flags` and `extra` flags; FIELD_DISTILL by default), the launch
    counters set to 0 just before and read just after, then `--test` on
    the renamed workspace (it must render the same PSNR); then one
    stage-3 step's launches and profile."""
    label = label or f"{tea}2{stu}"
    ws = os.path.join(workspace, f"{label}_cli")
    argv = [scene, "--workspace", ws, "--seed", str(seed), "--teacher_type",
            tea, "--model_type", stu, "--ckpt_teacher", best, "--ckpt",
            "scratch"] + cli_flags(flags) + list(extra)
    reset_counters()
    t0 = time.perf_counter()
    stats = distill_cli.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = counters()
    for name in kernels:
        if launches[name] <= 0:
            raise RuntimeError(f"kernel {name} never launched on the "
                               f"{label} path")
    done = renamed(ws)
    again = list(argv)
    again[again.index("--workspace") + 1] = done
    t0 = time.perf_counter()
    test = distill_cli.main(again + ["--test"])
    test_s = time.perf_counter() - t0
    if abs(test["psnr"] - stats["psnr"]) > TEACHER_CLI_RELOAD_DB:
        raise RuntimeError(f"{label} --test renders {test['psnr']:.3f} dB "
                           f"against {stats['psnr']:.3f}")
    _, cfg = distill_cli.parse_args(again)
    tr = Trainer(cfg, mode="distill")
    tr.load_teacher(best)
    tr.load_student(ckpt.latest_checkpoint(os.path.join(done, "checkpoints"),
                                           f"{tea}2{stu}"))
    prof = distill_step_profile(tr, {"train": NeRFDataset(cfg, "train")},
                                gen, label)
    log(f"{label} (distill CLI): train+eval {train_s:.1f} s, --test "
        f"{test_s:.1f} s; test PSNR {stats['psnr']:.3f} dB (SSIM "
        f"{stats['ssim']:.4f}, --test {test['psnr']:.3f}); stage2 "
        f"{stats['stage2_ms_per_step']:.3f} ms/step, stage3 "
        f"{stats['stage3_ms_per_step']:.3f}; stage-1 steps "
        f"{stats['stage1_steps']}; launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")
    log(f"{label} train_stats " + json.dumps(
        {k: v for k, v in stats.items() if k.startswith(("train_",
                                                         "stage"))}))
    return {"psnr": stats["psnr"], "ssim": stats["ssim"],
            "test_reload_psnr": test["psnr"], "train_s": train_s,
            "test_s": test_s, "launches": launches, "workspace": done,
            "train_stats": {k: v for k, v in stats.items()
                            if k.startswith(("train_", "stage", "chunk"))},
            "step_profile": prof}


def field_step_profiles(run: dict, name: str) -> dict:
    """Launches and a profile of one padded and one compacted preload
    teacher step (`teacher_step_flavors`) of the run's field, loaded from
    its last checkpoint, on its training views."""
    cfg = run["cfg"]
    tr = Trainer(cfg)
    tr.load_student(ckpt.latest_checkpoint(os.path.join(
        run["workspace"], "checkpoints"), name))
    return teacher_step_flavors(tr, {"train": NeRFDataset(cfg, "train")},
                                f"{name} teacher")


def drive_new_fields(seed: int, workspace: str, scene: str, gen) -> dict:
    """The MLP (PE 10, 8 x 256, skip 3) and plenoxel (128^3, degree 3)
    fields as teachers through the teacher CLI, then each distilled into
    the other through the distill CLI (MATRIX_QUALITY_r05.json's recipe);
    floors on every test PSNR."""
    info = {}
    best = {}
    for name in ("mlp", "tensors"):
        argv = [scene, "--workspace", os.path.join(workspace, f"{name}_cli"),
                "--seed", str(seed), "--model_type", name] \
            + cli_flags(dict(FIELD_TEACHER, iters=FIELD_TEACHER_ITERS[name]))
        run = run_teacher_cli(argv, f"{name} teacher",
                              FIELD_TEACHER_KERNELS)
        spec = run["cfg"].model_spec()
        log(f"{name} teacher: " + (
            f"PE {spec.pe_multires}, {spec.nerf_layer_num} x "
            f"{spec.nerf_layer_wide}, skip {spec.skip}"
            if name == "mlp" else
            f"volume {spec.plenoxel_res} x {spec.plenoxel_fea_dim} "
            f"(degree {spec.plenoxel_degree})") + f", heads "
            f"{spec.compute_dtype}")
        st = run["stats"]
        info[name] = {"psnr": st["psnr"], "ssim": st["ssim"],
                      "test_reload_psnr": run["test_psnr"],
                      "train_s": run["train_s"], "test_s": run["test_s"],
                      "ms_per_step": {k: st[f"{k}_ms_per_step"]
                                      for k in ("padded", "compacted")},
                      "train_stats": {k: v for k, v in st.items()
                                      if k.startswith(("train_", "padded",
                                                       "compacted", "occ_"))},
                      "launches": run["launches"],
                      "jax_tpu_psnr": FIELD_JAX_TPU[name],
                      "step_profiles": field_step_profiles(run, name)}
        if name == "tensors":
            tr = Trainer(run["cfg"])
            tr.load_student(ckpt.latest_checkpoint(os.path.join(
                run["workspace"], "checkpoints"), name))
            info[name]["grid_sample"] = grid_sample_case(
                tr.state.field.volume, 65_536, gen)
            del tr
        best[name] = os.path.join(run["workspace"], "checkpoints",
                                  f"{name}_best.ckpt")
        pt = st["psnr"]
        if not (np.isfinite(pt) and pt >= FIELD_TEACHER_FLOOR):
            raise RuntimeError(f"{name} teacher test PSNR {pt:.3f} < "
                               f"{FIELD_TEACHER_FLOOR}")
        if abs(run["test_psnr"] - pt) > TEACHER_CLI_RELOAD_DB:
            raise RuntimeError(f"{name} teacher --test renders "
                               f"{run['test_psnr']:.3f} dB against {pt:.3f}")
    for tea, stu in (("mlp", "tensors"), ("tensors", "mlp")):
        pair = f"{tea}2{stu}"
        info[pair] = distill_cli_run(seed, workspace, scene, tea, stu,
                                     best[tea], gen)
        info[pair]["jax_tpu_psnr"] = FIELD_JAX_TPU[pair]
        ps, pt = info[pair]["psnr"], info[tea]["psnr"]
        if not (np.isfinite(ps) and ps >= FIELD_STUDENT_FLOOR
                and ps >= pt - FIELD_MAX_DROP):
            raise RuntimeError(f"{pair} student test PSNR {ps:.3f}: floor "
                               f"{FIELD_STUDENT_FLOOR}, teacher {pt:.3f} - "
                               f"{FIELD_MAX_DROP}")
    log("new fields: test PSNR " + ", ".join(
        f"{k} {v['psnr']:.3f} dB (JAX on the TPU {v['jax_tpu_psnr']})"
        for k, v in info.items()))
    return info

@contextlib.contextmanager
def resize_log():
    """Records each VM resize the Trainer makes while active: (kind, the
    tables' per-axis resolution after it)."""
    events = []
    shrink, upsample = vm_field.shrink_params, vm_field.upsample_params

    def shrink_rec(field, *a):
        out = shrink(field, *a)
        events.append(("shrink", tuple(field.spec.vm_resolution)))
        return out

    def upsample_rec(field, *a):
        out = upsample(field, *a)
        events.append(("upsample", tuple(field.spec.vm_resolution)))
        return out

    vm_field.shrink_params, vm_field.upsample_params = shrink_rec, upsample_rec
    try:
        yield events
    finally:
        vm_field.shrink_params, vm_field.upsample_params = shrink, upsample


def vm_tables(res, R: int, gen, dev) -> tuple:
    """Random planes and lines of a VM field at per-axis resolution res."""
    planes = [torch.randn(res[m1], res[m0], R, generator=gen, device=dev)
              * 0.1 for m0, m1 in MAT_IDS]
    lines = [torch.randn(res[v], R, generator=gen, device=dev) * 0.1
             for v in VEC_IDS]
    return planes, lines


def vm_resized_case(planes, lines, gen, label: str) -> dict:
    """K4 and K5 against their plain versions on RESIZED_SAMPLES random
    points of [-1, 1]^3 over the tables of a resized (non-cubic) VM field:
    K4 timed and bounded as check_vm_kernels does, K5 through k5_case
    (every upstream row live)."""
    dev = planes[0].device
    M, R = RESIZED_SAMPLES, planes[0].shape[-1]
    xn = (torch.rand(M, 3, generator=gen, device=dev) * 2 - 1).contiguous()
    kind, lanes = k4_variant(R, [t.data_ptr() for t in (*planes, *lines)])
    err4 = max_abs(vm_sample_fwd(planes, lines, xn),
                   vm_sample_plain(planes, lines, xn))
    touched = vm_touched_rows(planes, lines, xn)
    k4 = {"M": M, "R": R, "err": err4, "variant": kind, "lanes": lanes,
          "bound": bound(M * 12 + touched * R * 4 + 3 * M * R * 4,
                         3 * M * R * 14),
          **timings(lambda: vm_sample_fwd(planes, lines, xn),
                    lambda: vm_sample_plain(planes, lines, xn))}
    k5 = k5_case(planes, lines, xn, torch.ones(M, device=dev), gen)
    # the library yardsticks at this shape: F.grid_sample of the three
    # planes, forward (K4's plane half) and backward (K5's)
    lib_fwd, lib_bwd = vm_library(planes, xn, gen)
    k4["library_ms"] = cuda_ms(lib_fwd)
    k5["library_ms"] = cuda_ms(lib_bwd)
    shape = {"planes": [list(p.shape[:2]) for p in planes],
             "lines": [v.shape[0] for v in lines], "R": R}
    log(f"K4 at the {label} VM shape {shape}: {kind} instantiation, "
        f"{lanes} lanes per sample, M {M}: max |kernel - plain| "
        f"{err4:.3g}, {k4['ms']:.4f} ms{alone(k4)} (call "
        f"{k4['call_ms']:.4f}, plain {k4['plain_ms']:.4f}, F.grid_sample "
        f"x3 {k4['library_ms']:.4f}), bound "
        f"{k4['bound'][0]:.4f} ms ({k4['bound'][1]}); K5's F.grid_sample "
        f"backward x3 {k5['library_ms']:.4f} ms")
    if not err4 <= TOL_K4:
        raise RuntimeError(f"K4 disagrees with its plain version at the "
                           f"{label} VM shape: {err4:.3g}")
    return {"shape": shape, "k4": k4, "k5": k5}


def drive_vm_c2f(seed: int, workspace: str, scene: str, gen) -> dict:
    """TensoRF's coarse-to-fine VM teacher through the teacher CLI
    (VM_C2F_TEACHER: five shrinks and upsamples), then a cell-mode hash
    student distilled from its best checkpoint (VM_C2F_STUDENT); K4 and
    K5 at the trained teacher's per-axis shape and at its shape after the
    first shrink."""
    argv = [scene, "--workspace", os.path.join(workspace, "vm_cli"),
            "--seed", str(seed)] + cli_flags(VM_C2F_TEACHER)
    with resize_log() as resizes:
        run = run_teacher_cli(argv, "VM c2f teacher", VM_C2F_TEACHER_KERNELS)
    ups = [r for kind, r in resizes if kind == "upsample"]
    shrinks = [r for kind, r in resizes if kind == "shrink"]
    log(f"VM c2f teacher resizes (training, then --test: none): {resizes}")
    if len(ups) != len(VM_C2F_TEACHER["upsample_model_steps"]) \
            or not shrinks:
        raise RuntimeError(f"the VM teacher did not resize as scheduled: "
                           f"{resizes}")
    cfg, st = run["cfg"], run["stats"]
    tr = Trainer(cfg)
    tr.load_student(ckpt.latest_checkpoint(os.path.join(
        run["workspace"], "checkpoints"), "vm"))
    res = tuple(tr.spec_stu.vm_resolution)
    if res != ups[-1]:
        raise RuntimeError(f"the checkpoint's VM shape {res} is not the "
                           f"last upsample's {ups[-1]}")
    # C9: the same field read over aabb_train at eval
    occ = tr.state.occ
    tr.state.occ = occ.replace(aabb_infer=occ.aabb_train)
    over_train = tr.evaluate(NeRFDataset(cfg, "test"), save_dir=os.path.join(
        workspace, "vm_over_aabb_train"))["psnr"]
    tr.state.occ = occ
    planes = [p.detach() for p in tr.state.field.planes]
    lines = [v.detach() for v in tr.state.field.lines]
    cases = {"final": vm_resized_case(planes, lines, gen, f"trained {res}"),
             "first_shrink": vm_resized_case(
                 *vm_tables(shrinks[0], planes[0].shape[-1], gen,
                            tr.device), gen, f"first shrink {shrinks[0]}")}
    prof = teacher_step_flavors(tr, {"train": NeRFDataset(cfg, "train")},
                                "VM c2f teacher")
    aabb = occ.aabb_train.tolist()
    del tr
    best = os.path.join(run["workspace"], "checkpoints", "vm_best.ckpt")
    stu = distill_cli_run(seed, workspace, scene, "vm", "hash", best, gen,
                          VM_C2F_STUDENT, VM_C2F_STUDENT_KERNELS)
    pt, ps = st["psnr"], stu["psnr"]
    log(f"VM c2f teacher: final shape {res}, aabb_train {aabb}; test PSNR "
        f"{pt:.3f} dB (SSIM {st['ssim']:.4f}; its eval reads the shrunk "
        f"tables over aabb_infer, as the JAX package's does: ROADMAP C9; "
        f"no floor), {over_train:.3f} dB over aabb_train; hash student "
        f"{ps:.3f} dB (floor {VM_C2F_STUDENT_FLOOR}); ms per step padded "
        f"{st['padded_ms_per_step']:.3f}, compacted "
        f"{st['compacted_ms_per_step']:.3f}")
    if not (np.isfinite(ps) and ps >= VM_C2F_STUDENT_FLOOR):
        raise RuntimeError(f"the hash student of the VM c2f teacher: "
                           f"{ps:.3f} dB < {VM_C2F_STUDENT_FLOOR}")
    if not np.isfinite(pt):
        raise RuntimeError("the VM c2f teacher's eval is not finite")
    return {"teacher": {"psnr": pt, "ssim": st["ssim"],
                        "psnr_over_aabb_train": over_train,
                        "test_reload_psnr": run["test_psnr"],
                        "train_s": run["train_s"], "test_s": run["test_s"],
                        "resizes": resizes, "final_shape": res,
                        "aabb_train": aabb,
                        "train_stats": {
                            k: v for k, v in st.items() if k.startswith((
                                "train_", "padded", "compacted", "occ_"))},
                        "launches": run["launches"],
                        "step_profiles": prof},
            "student": stu, "kernels": cases, "launches": {
                "teacher": run["launches"], "student": stu["launches"]}}


def drive_c2f_plenoxel(seed: int, workspace: str, scene: str, best: str,
                       ab: dict, gen) -> dict:
    """MATRIX_QUALITY_r05.json's hash2tensors_c2f student from the A/B
    teacher (C2F_PLENOXEL): the volume from 64^3 to 91^3 at step 400 and
    128^3 at step 800 (it must end at resolution1^3); floors against the
    A/B teacher."""
    run = distill_cli_run(seed, workspace, scene, "hash", "tensors", best,
                          gen, C2F_PLENOXEL, C2F_PLENOXEL_KERNELS,
                          label="hash2tensors_c2f")
    vol = ckpt.load_checkpoint(ckpt.latest_checkpoint(os.path.join(
        run["workspace"], "checkpoints"), "hash2tensors"), "cpu")[
            "params"]["volume"]
    ps, pt = run["psnr"], ab["teacher"]["psnr"]
    log(f"hash2tensors_c2f: volume {tuple(vol.shape)}; test PSNR {ps:.3f} "
        f"dB against the A/B teacher's {pt:.3f} (floor {C2F_FLOOR}, teacher "
        f"- {C2F_MAX_DROP}; JAX on the TPU {C2F_JAX_TPU} at 4000 steps)")
    if tuple(vol.shape[:3]) != (C2F_PLENOXEL["resolution1"],) * 3:
        raise RuntimeError(f"the c2f volume ends at {vol.shape}")
    if not (np.isfinite(ps) and ps >= C2F_FLOOR and ps >= pt - C2F_MAX_DROP):
        raise RuntimeError(f"hash2tensors_c2f {ps:.3f} dB: floor "
                           f"{C2F_FLOOR}, teacher {pt:.3f} - {C2F_MAX_DROP}")
    run["volume_shape"] = list(vol.shape)
    run["jax_tpu_psnr"] = C2F_JAX_TPU
    return run


def check_best_holds_ema(workspace: str, name: str) -> dict:
    """`{name}_best.ckpt` holds the EMA weights as its params and as its
    ema_params, the same as the final checkpoint's ema_params (both are
    written after the last step), and they differ from the final raw
    params."""
    d = os.path.join(workspace, "checkpoints")
    best = ckpt.load_checkpoint(os.path.join(d, f"{name}_best.ckpt"), "cpu")
    last = ckpt.load_checkpoint(ckpt.latest_checkpoint(d, name), "cpu")

    def diff(a, b):
        return max(float(np.abs(x - y).max()) for (_, x), (_, y) in zip(
            named_leaves(a), named_leaves(b)))

    out = {"best_params_vs_ema": diff(best["params"], best["ema_params"]),
           "best_ema_vs_last_ema": diff(best["ema_params"],
                                        last["ema_params"]),
           "ema_vs_raw_params": diff(best["ema_params"], last["params"]),
           "steps": [best["step"], last["step"]]}
    log(f"{name}_best.ckpt: max |params - ema_params| "
        f"{out['best_params_vs_ema']:.3g}, against the final checkpoint's "
        f"EMA {out['best_ema_vs_last_ema']:.3g}, EMA against the raw "
        f"params {out['ema_vs_raw_params']:.3g} (steps {out['steps']})")
    if out["best_params_vs_ema"] or out["best_ema_vs_last_ema"] \
            or not out["ema_vs_raw_params"] > 0:
        raise RuntimeError(f"{name}_best.ckpt does not hold the EMA weights")
    return out


def emap_host_profile(run: dict, name: str) -> dict:
    """Launches and a profile of one compacted host-batcher teacher step
    with the error map: the host draw from a map row, the pixel gather,
    the step, and the per-ray losses read back, as the Trainer runs it."""
    cfg = run["cfg"]
    tr = Trainer(cfg)
    tr.load_student(ckpt.latest_checkpoint(os.path.join(
        run["workspace"], "checkpoints"), name))
    ds = NeRFDataset(cfg, "train")
    poses = torch.as_tensor(ds.poses, device=tr.device)
    batcher = RayBatcher(ds.images, cfg.num_rays, seed=cfg.seed)
    step = make_teacher_step_host(
        tr.spec, tr.rspec, tr.opt, cfg, ds.intrinsics, ds.H, ds.W,
        image_channels=ds.images.shape[-1], device=tr.device,
        use_error_map=True)
    rng = np.random.default_rng(0)
    row = np.ones(128 * 128, np.float32)

    def one():
        inds, _ = draw_error_map_inds_np(rng, row, ds.H, ds.W, cfg.num_rays)
        _, per_ray, _ = step(tr.state, poses[1], inds, batcher.gather(
            1, inds), tr.generator)
        per_ray.cpu()

    try:
        for _ in range(3):  # warm-up
            one()
        torch.cuda.synchronize()
        reset_counters()
        one()
        torch.cuda.synchronize()
        launched = {k: v for k, v in counters().items() if v}
        prof = profile(one)
    finally:
        batcher.close()
    log(f"error-map teacher compacted host step: launches "
        f"{json.dumps(launched)}; profile wall {prof['wall_ms']:.2f} ms, "
        f"device busy {prof['device_busy_ms']:.2f} ms (share "
        f"{prof['device_busy_share']:.3f})")
    for r in prof["top"]:
        log(f"  {r['ms']:9.3f} ms {r['calls']:6d} x {r['kernel']}")
    return {"launches_per_step": launched, "profile": prof}


def drive_emap_ema(seed: int, workspace: str, scene: str, gen) -> dict:
    """The error map and EMA through both CLIs, in 8-step calls: the
    teacher CLI with the A/B teacher's flags on the host batcher, then the
    distill CLI with the A/B distill flags from its best checkpoint, both
    with EMAP_EMA and SCAN_FLAGS; the A/B floors; each best checkpoint
    must hold the EMA weights, and each run must have taken most of its
    steps in 8-step calls."""
    argv = [scene, "--workspace", os.path.join(workspace, "hash_emap"),
            "--seed", str(seed)] + cli_flags(AB_TEACHER) + list(EMAP_EMA) \
        + list(SCAN_FLAGS)
    run = run_teacher_cli(argv, "error-map + EMA teacher", TEACHER_KERNELS
                          + ("hash_encode_cell_fwd", "hash_encode_cell_bwd"))
    st = run["stats"]
    pt = st["psnr"]
    if abs(run["test_psnr"] - pt) > TEACHER_CLI_RELOAD_DB:
        raise RuntimeError(f"the error-map teacher's --test renders "
                           f"{run['test_psnr']:.3f} dB against {pt:.3f}")
    tea_best = check_best_holds_ema(run["workspace"], "hash")
    prof = emap_host_profile(run, "hash")
    best = os.path.join(run["workspace"], "checkpoints", "hash_best.ckpt")
    stu = distill_cli_run(seed, workspace, scene, "hash", "vm", best, gen,
                          EMAP_DISTILL, EMAP_DISTILL_KERNELS,
                          EMAP_EMA + SCAN_FLAGS, "hash2vm_emap")
    stu["best"] = check_best_holds_ema(stu["workspace"], "hash2vm")
    ps = stu["psnr"]
    for label, done in (("teacher", st), ("student", stu["train_stats"])):
        log(f"error map + EMA {label}: {done['chunk_steps']} of "
            f"{done['train_steps']} steps in {SCAN_K}-step calls")
        if done["chunk_steps"] < done["train_steps"] // 2:
            raise RuntimeError(f"the error-map {label} ran few {SCAN_K}-step"
                               " calls")
    log(f"error map + EMA: teacher (host batcher {st['host_batcher']}) "
        f"{pt:.3f} dB (floor {AB_TEACHER_FLOOR}), ms per step padded "
        f"{st['padded_ms_per_step']:.3f}, compacted "
        f"{st['compacted_ms_per_step']:.3f}; student {ps:.3f} dB (floor "
        f"{AB_STUDENT_FLOOR}, teacher - {AB_MAX_DROP})")
    if not (np.isfinite(pt) and pt >= AB_TEACHER_FLOOR):
        raise RuntimeError(f"the error-map teacher: {pt:.3f} dB < "
                           f"{AB_TEACHER_FLOOR}")
    if not (np.isfinite(ps) and ps >= AB_STUDENT_FLOOR
            and ps >= pt - AB_MAX_DROP):
        raise RuntimeError(f"the error-map student {ps:.3f} dB: floor "
                           f"{AB_STUDENT_FLOOR}, teacher {pt:.3f} - "
                           f"{AB_MAX_DROP}")
    return {"teacher": {"psnr": pt, "ssim": st["ssim"],
                        "test_reload_psnr": run["test_psnr"],
                        "host_batcher": st["host_batcher"],
                        "train_s": run["train_s"], "best": tea_best,
                        "train_stats": {
                            k: v for k, v in st.items() if k.startswith((
                                "train_", "padded", "compacted", "occ_",
                                "chunk"))},
                        "launches": run["launches"], "step_profile": prof},
            "student": stu, "launches": {"teacher": run["launches"],
                                         "student": stu["launches"]}}


def check_emap_row(got, want, old, cells, per_ray, tol: float) -> dict:
    """Two updated error-map rows (numpy) of the same step against each
    other: cells drawn once within tol (relative, plus tol of the row's
    max), a cell drawn by several rays holding one of their values
    (0.1 x old + 0.9 x the ray's loss, `per_ray` [N]) in each row, the
    others untouched."""
    atol = tol * float(np.abs(want).max())
    uniq, counts = np.unique(cells, return_counts=True)
    once, many = uniq[counts == 1], uniq[counts > 1]
    rest = np.setdiff1d(np.arange(old.shape[0]), uniq)
    ok = bool(np.array_equal(got[rest], old[rest])
              and np.array_equal(want[rest], old[rest])
              and np.allclose(got[once], want[once], rtol=tol, atol=atol))
    for c in many:
        cand = 0.1 * old[c] + 0.9 * per_ray[cells == c]
        for v in (got[c], want[c]):
            ok = ok and bool(np.min(np.abs(cand - v)) <= atol + tol * abs(v))
    return {"ok": ok, "cells_once": int(once.size),
            "cells_repeated": int(many.size),
            "max_diff_once": float(np.abs(got[once] - want[once]).max())}


def small_emap_step_gpu_vs_cpu(devices=("cuda", "cpu")) -> dict:
    """One preloaded teacher step with an error map at test sizes
    (tests/test_torch_teacher.py's, compacted): kernels on the GPU against
    the plain path on the CPU, same params, pixels drawn from the same
    map row (on 300 cells, so many are drawn twice), same background and
    perturbation: the loss, the gradients and params (compare_steps) and
    the updated map row (check_emap_row)."""
    rng = np.random.default_rng(13)
    spec = ModelSpec(**SMALL_TEA)
    tree = random_hash_params(spec, rng)
    bits = rng.uniform(size=32 ** 3) < 0.25
    image = rng.uniform(size=(SMALL_HW ** 2, 4)).astype(np.float32)
    image[:, 3] = rng.choice([0.0, 1.0, 0.3], size=SMALL_HW ** 2)
    pose = nerf_matrix_to_ngp(pose_spherical(30.0, -30.0, 4.0), scale=0.8)
    n = SMALL_TEACHER_CFG["num_rays"]
    row = rng.uniform(0.05, 1.0, 128 * 128).astype(np.float32)
    row[rng.permutation(128 * 128)[300:]] = 0.0
    inds, cells = draw_error_map_inds_np(rng, row, SMALL_HW, SMALL_HW, n)
    bg = torch.from_numpy(rng.uniform(size=(n, 3)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(size=n).astype(np.float32))
    cfg = PVDConfig(**SMALL_TEACHER_CFG, samples_per_ray=16.0)
    res, rows = [], []
    for where in devices:
        field = hash_field_from_jax(tree, spec, where)
        occ = set_bitfield(init_occupancy_state(cfg.render_spec(), where),
                           torch.from_numpy(bits).to(where))
        params = dict(field.named_parameters())
        opt = build_optimizer(params, param_group_label(spec),
                              trainable_label(spec, ""),
                              exp_decay_schedule(1e-2, 100),
                              exp_decay_schedule(1e-3, 100))
        state = TrainState(field=field, opt_state=opt.init(params), occ=occ)
        step = make_teacher_step(spec, cfg.render_spec(), opt, cfg,
                                 SMALL_INTR, SMALL_HW, SMALL_HW, 4,
                                 device=where, use_error_map=True)
        state, new_row, m = step.with_rays(
            state, torch.from_numpy(pose).to(where),
            torch.from_numpy(image).to(where), torch.from_numpy(row).to(where),
            torch.from_numpy(inds.astype(np.int64)).to(where),
            torch.from_numpy(cells.astype(np.int64)).to(where), bg.to(where),
            u.to(where))
        res.append(({k: float(v) for k, v in m.items()},
                    hash_tree_from_field(field, grad=True),
                    hash_tree_from_field(field)))
        rows.append(new_row.cpu().numpy())
        if where == devices[-1]:  # the per-ray losses, for repeated cells
            field = hash_field_from_jax(tree, spec, where)
            state = TrainState(field=field, opt_state=opt.init(dict(
                field.named_parameters())), occ=occ)
            rays = get_rays(torch.from_numpy(pose)[None], SMALL_INTR,
                            SMALL_HW, SMALL_HW,
                            torch.from_numpy(inds.astype(np.int64)))
            per_ray = step.core(state, rays["rays_o"][0].contiguous().to(
                where), rays["rays_d"][0].contiguous().to(where),
                torch.from_numpy(image[inds]).to(where), bg.to(where),
                u.to(where), per_ray=True)[2].cpu().numpy()
    c = compare_steps(*res)
    r = check_emap_row(rows[0], rows[1], row, cells, per_ray, TOL_EMAP_ROW)
    log(f"error-map teacher step GPU kernels vs CPU plain (test sizes, "
        f"compacted, f32 heads): max rel loss/metric diff "
        f"{c['loss_rel_err']:.3g} (tol {STEP_LOSS_RTOL:g}); max grad diff "
        f"/ leaf max {c['grad_err_rel_leaf_max']:.3g}; map row: "
        f"{r['cells_once']} cells drawn once, max diff "
        f"{r['max_diff_once']:.3g} (tol {TOL_EMAP_ROW:g}), "
        f"{r['cells_repeated']} drawn several times, each holding one of "
        f"its rays' values: {r['ok']}")
    if not (c.pop("ok") and r["ok"]):
        raise RuntimeError("the GPU error-map teacher step disagrees with "
                           "the CPU plain step")
    return {**c, "row": r}


def bake_case(table, gs, gen, n: int, cell=None, x01=None) -> dict:
    """K15 against its plain version on n points of [0, 1]^3 (corners,
    faces, next to the far faces and outside included; or the n points
    x01) from `table`'s bake, and the whole baked encode (K15 + K10)
    against the plain one."""
    dev = table.device
    baked = build_baked_dense(table, gs)
    if x01 is None:
        x01 = torch.rand(n, 3, generator=gen, device=dev)
        e = 1.0 - 2.0 ** -24
        x01[:12] = torch.tensor(
            [[0, 0, 0], [1, 1, 1], [0, 1, .5], [1, 0, 1], [1, 1, .3],
             [e, e, e], [1, e, 0], [.55, 1, e], [-1e-3, .5, .5],
             [.5, 1.001, .5], [.6, .55, -1], [1, 1, 1 + 1e-6]], device=dev)
    Ld = len(gs.dense_levels)
    cols = [2 * lv + c for lv in gs.dense_levels for c in (0, 1)]
    out = torch.zeros(n, gs.output_dim, device=dev)
    k15 = hash_encode_baked_fwd(baked, x01, gs, out)[:, cols]
    p15 = hash_encode_baked_plain(baked, x01, gs)
    abs15 = max_abs(k15, p15)
    err15 = abs15 / float(p15.abs().max())
    if cell is not None:
        with torch.no_grad():
            full = hash_encode(table, x01, gs, cell, baked)
        full_p = hash_encode_plain(table, x01, gs, cell, baked)
        err15 = max(err15, max_abs(full, full_p) / float(full_p.abs().max()))
    fine = gs.dense_levels[-1]
    side = gs.level_side(fine)
    inside = ((x01 >= 0) & (x01 <= 1)).all(-1)
    _, rows = level_corners(x01, gs, fine)
    touched = int((rows[:, inside] - int(gs.offsets[fine])).unique().numel())
    # bytes: x01 and the touched vertex rows read once, the Ld dense slots
    # written once; ops: ~26 per point for the lattice and 8 weights, 32
    # per (point, level) for 16 FMAs
    b15 = bound(n * 12 + touched * Ld * 8 + n * Ld * 8, n * (26 + 32 * Ld))
    # library yardstick: F.grid_sample of the [1, Ld*2, s, s, s] vertex
    # volume, align_corners=True (vertex 0 at -1, vertex s - 1 at +1), at
    # each point's lattice position; zero padding outside
    import torch.nn.functional as F

    vol = baked.reshape(side, side, side, Ld * 2).permute(3, 0, 1, 2)[None]
    vol = vol.contiguous()
    pos = fma32(x01, float(np.float32(gs.level_scale(fine))), 0.5)
    grid = (pos / (side - 1) * 2.0 - 1.0).reshape(1, n, 1, 1, 3)

    def lib():
        return F.grid_sample(vol, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    lib_err = max_abs(lib().reshape(Ld * 2, n).T[inside], p15[inside])
    return {"points": n, "dense_levels": Ld, "side": side, "err15": err15,
            "abs15": abs15, "touched_rows": touched, "bound15": b15,
            "t15": timings(lambda: hash_encode_baked_fwd(baked, x01, gs,
                                                         out),
                           lambda: hash_encode_baked_plain(baked, x01, gs)),
            "lib15_ms": cuda_ms(lib), "lib15_abs_err": lib_err,
            "floor15_ms": floor_ms(n * Ld * 8, dev)}


def log_k15(label: str, c: dict):
    """Log one bake_case's K15; raise above TOL_K15_REL."""
    log(f"K15 {label} (side {c['side']}, {c['dense_levels']} dense levels, "
        f"{c['touched_rows']} vertex rows touched): rel err "
        f"{c['err15']:.3g}, {c['t15']['ms']:.4f} ms{alone(c['t15'])} (call "
        f"{c['t15']['call_ms']:.4f}, plain {c['t15']['plain_ms']:.4f}, "
        f"F.grid_sample {c['lib15_ms']:.4f} [max diff "
        f"{c['lib15_abs_err']:.3g}], bound {c['bound15'][0]:.4f} "
        f"{c['bound15'][1]}, copy_ of the output bytes "
        f"{c['floor15_ms']:.4f})")
    if not c["err15"] <= TOL_K15_REL:
        raise RuntimeError(f"K15 disagrees with its plain version "
                           f"({label})")


def check_k15_hard_counts(baked, gs, dev) -> dict:
    """K15 on the hard points (`check_hard_counts`) into an output
    prefilled with 7: its slots against the plain version, and every other
    slot left as it was."""
    cols = [2 * lv + c for lv in gs.dense_levels for c in (0, 1)]
    others = [c for c in range(gs.output_dim) if c not in cols]

    def encode(x01):
        out = torch.full((x01.shape[0], gs.output_dim), 7.0, device=dev)
        hash_encode_baked_fwd(baked, x01, gs, out)
        if not bool((out[:, others] == 7.0).all()):
            raise RuntimeError("K15 wrote outside its slots")
        return out[:, cols]

    return check_hard_counts(
        "K15", encode, lambda x: hash_encode_baked_plain(baked, x, gs), 3,
        TOL_K15_REL, dev)


def check_bake_kernels(tea, gen, chunk=None) -> tuple:
    """K16 and K15 at full width: bound 1 (side 73, 5 dense levels) on the
    A/B teacher's trained table and cell table, bound 2 (side 59, 4 dense
    levels) on a random table; K15 also on the hard points of both bakes
    and, on bound 1, at the points `chunk` (the samples of a --test_teacher
    eval chunk)."""
    field = tea.state.field
    gs1, table1 = field.grid, field.encoder.detach()
    gs2 = HashGridSpec(desired_resolution=4096, n_cell_levels=9)
    table2 = torch.rand(gs2.table_size, 2, generator=gen,
                        device=table1.device) * 2 - 1
    k16 = {}
    for name, gs, table in (("bound1", gs1, table1),
                            ("bound2", gs2, table2)):
        bk = build_baked_dense(table, gs)
        bp = build_baked_dense_plain(table, gs)
        exact = torch.equal(bk.view(torch.int32), bp.view(torch.int32))
        abs16 = max_abs(bk, bp)
        err16 = abs16 / float(bp.abs().max())
        side = gs.level_side(gs.dense_levels[-1])
        Ld = len(gs.dense_levels)
        read = sum(gs.level_side(lv) ** 3 for lv in gs.dense_levels) * 8
        # bytes: every dense level's rows read once, the vertex table
        # written once; ops: 48 per (vertex, coarse level), 8 corners of
        # 2 weight products, 2 products and 2 sums
        b16 = bound(read + side ** 3 * Ld * 8, side ** 3 * (Ld - 1) * 48)
        k16[name] = {"side": side, "dense_levels": Ld, "err16": err16,
                     "abs16": abs16, "exact": exact,
                     "bound16": b16,
                     "t16": timings(lambda: build_baked_dense(table, gs),
                                    lambda: build_baked_dense_plain(table,
                                                                    gs))}
        log(f"K16 {name}: side {side}, {Ld} dense levels, bit for bit "
            f"{exact}, max |kernel - plain| {abs16:.3g} (rel "
            f"{err16:.3g}); {k16[name]['t16']['ms']:.4f} ms"
            f"{alone(k16[name]['t16'])} (call "
            f"{k16[name]['t16']['call_ms']:.4f}, plain "
            f"{k16[name]['t16']['plain_ms']:.4f}, bound {b16[0]:.4f} "
            f"{b16[1]})")
        if not (exact and err16 <= TOL_K16_REL):
            raise RuntimeError(f"K16 disagrees with its plain version "
                               f"({name})")
    cases, hard = {}, {}
    for name, gs, table, cell in (
            ("bound1", gs1, table1, field.encoder_cell.detach()),
            ("bound2", gs2, table2, None)):
        for n in BAKE_POINTS:
            c = bake_case(table, gs, gen, n, cell)
            cases[f"{name}_{n}"] = c
            log_k15(f"{name} at {n} points", c)
        hard[name] = check_k15_hard_counts(build_baked_dense(table, gs), gs,
                                           table.device)
    if chunk is not None:
        c = bake_case(table1, gs1, gen, chunk.shape[0],
                      field.encoder_cell.detach(), x01=chunk)
        cases["test_teacher_chunk"] = c
        log_k15("--test_teacher eval chunk", c)
    c, b = cases[f"bound1_{BAKE_POINTS[0]}"], k16["bound1"]
    results = [
        dict(name="hash_encode_baked_fwd",
             source="pvd_tpu_torch/csrc/hash_encode.cu",
             replaces="pvd_tpu/ops/hashgrid.py:635",
             err=max([c["err15"]] + [e for h in hard.values()
                                     for e in h.values()]),
             abs_err=c["abs15"], tol=TOL_K15_REL,
             err_kind="max |kernel - plain| / max |plain|", **c["t15"],
             library_ms=c["lib15_ms"],
             library_call="F.grid_sample(align_corners=True) of the "
             "[1, Ld*2, s, s, s] vertex volume at the points",
             bound=c["bound15"],
             shape=f"{c['points']} pts x {c['dense_levels']} dense levels "
             f"(side {c['side']})"),
        dict(name="build_baked_dense",
             source="pvd_tpu_torch/csrc/hash_encode.cu",
             replaces="pvd_tpu/ops/hashgrid.py:461", err=b["err16"],
             abs_err=b["abs16"], tol=TOL_K16_REL,
             err_kind="max |kernel - plain| / max |plain|", **b["t16"],
             library_ms=None,
             library_call="none: no single PyTorch call resamples with a "
             "clipped base that extrapolates at the edges",
             bound=b["bound16"],
             shape=f"{b['side']}^3 vertices x {b['dense_levels']} dense "
             "levels")]
    return results, {"k15": cases, "k15_hard": hard, "k16": k16}


def bake_step_profiles(stu, scene, gen) -> dict:
    """One stage-3 distill step with the A/B student's teacher baked,
    beside the same step with the exact teacher: launches and device time
    of the teacher's encode (K15 + K10 against K1 + K10)."""
    spec = dataclasses.replace(stu.spec_tea, hash_bake_dense=True)
    baked = field_from_tree(tree_from_field(stu.teacher), spec,
                            stu.device).requires_grad_(False).bake()
    out = {"exact": distill_step_profile(stu, scene, gen, "exact-teacher"),
           "baked": distill_step_profile(stu, scene, gen, "baked-teacher",
                                         teacher=baked)}
    for name, kernels_ in (("exact", ("hash_encode_fwd_kernel",
                                      "hash_cell_fwd_kernel")),
                           ("baked", ("hash_baked_fwd_kernel",
                                      "hash_cell_fwd_kernel"))):
        ours = out[name]["profile"]["ours"]
        out[name]["teacher_encode_ms"] = sum(
            ours.get(k, {}).get("ms", 0.0) for k in kernels_)
    log(f"teacher encode per stage-3 step: exact (K1 + K10) "
        f"{out['exact']['teacher_encode_ms']:.4f} ms, baked (K15 + K10) "
        f"{out['baked']['teacher_encode_ms']:.4f} ms")
    if out["baked"]["launches_per_step"].get("hash_encode", 0):
        raise RuntimeError("the baked teacher's step launched K1")
    return out


def drive_large_scene(seed: int, workspace: str) -> tuple:
    """The large-scene configuration through the Trainer: a cell-mode hash
    teacher with a background model on two cascades and the geometric
    march, whose val eval writes `hash_best.ckpt`; a distill Trainer that
    loads that file and trains a VM student (its background warm-started
    from the teacher's); both evaluated on the test views.  Returns
    (teacher trainer, student trainer, scene, info)."""
    t0 = time.perf_counter()
    scene = make_synthetic_scene(**LS_SCENE, seed=seed, scale=LS_SCALE,
                                 sky_radius=LS_SKY_RADIUS)
    scene_s = time.perf_counter() - t0
    cfg_t = PVDConfig(**LS_TEACHER, seed=seed,
                      workspace=os.path.join(workspace, "teacher"))
    tea = Trainer(cfg_t)
    gs = tea.state.field.grid
    log(f"large scene: {LS_SCENE} (scene made in {scene_s:.1f} s); bound "
        f"{cfg_t.bound} ({tea.rspec.cascades} cascades of "
        f"{cfg_t.grid_size}^3), dt_gamma {cfg_t.dt_gamma:g}, max_steps "
        f"{cfg_t.max_steps}, bg_radius {cfg_t.bg_radius:g} (background "
        f"table {tea.state.field.bg.grid.table_size} x 2); teacher hash, "
        f"cell levels {gs.cell_levels}, {cfg_t.iters} steps of "
        f"{cfg_t.num_rays} rays, heads {tea.spec.compute_dtype}")
    tea.train(scene["train"], valid_ds=scene["val"])
    best = os.path.join(tea.workspace, "checkpoints", "hash_best.ckpt")
    if not os.path.exists(best):
        raise RuntimeError(f"the teacher's val eval wrote no {best}")
    st_t = tea.evaluate(scene["test"])
    hist = tea.history
    first = float(np.mean([float(m["psnr"]) for m in hist[:16]]))
    last = float(np.mean([float(m["psnr"]) for m in hist[-16:]]))

    cfg_d = PVDConfig(**LS_DISTILL, seed=seed,
                      workspace=os.path.join(workspace, "h2v"))
    stu = Trainer(cfg_d, mode="distill")
    stu.load_teacher(best)
    bg_copied = all(torch.equal(a, b) for a, b in zip(
        stu.state.field.bg.parameters(), stu.teacher.bg.parameters()))
    log(f"large-scene distill: vm {stu.spec_stu.vm_resolution}, "
        f"{cfg_d.iters} steps (stages at {cfg_d.stage1_iters}/"
        f"{cfg_d.stage2_iters}) of {cfg_d.num_rays} rays, max_samples "
        f"{cfg_d.max_samples}, samples_per_ray {cfg_d.samples_per_ray:g}; "
        f"student background warm-started from the teacher's: {bg_copied}")
    if not bg_copied:
        raise RuntimeError("load_teacher did not copy the background")
    stu.train(scene["train"], valid_ds=scene["val"])
    st_s = stu.evaluate(scene["test"])
    st_tt = stu.evaluate(scene["test"], use_teacher=True)

    def brief(st):
        return {k: st[k] for k in ("psnr", "ssim", "eval_s_per_image",
                                   "eval_s_first_image")}

    info = {"teacher": brief(st_t), "student": brief(st_s),
            "teacher_reloaded": brief(st_tt),
            "teacher_train_psnr_first16": first,
            "teacher_train_psnr_last16": last,
            "teacher_train_stats": tea.train_stats,
            "student_train_stats": stu.train_stats,
            "teacher_rspec_final": {
                "max_samples": tea.rspec.max_samples,
                "samples_per_ray": tea.rspec.samples_per_ray},
            "teacher_occupied": [float(b.float().mean()) for b in
                                 tea.state.occ.bitfield.reshape(
                                     tea.rspec.cascades, -1)]}
    for name, st in (("teacher", st_t), ("student", st_s),
                     ("teacher reloaded by the distill Trainer", st_tt)):
        log(f"large-scene {name}: test PSNR {st['psnr']:.3f} dB, SSIM "
            f"{st['ssim']:.4f} over {len(scene['test'])} views, "
            f"{st['eval_s_per_image'] * 1e3:.1f} ms per image")
    log(f"large-scene grid occupied per cascade "
        f"{info['teacher_occupied']}; final S_max "
        f"{tea.rspec.max_samples}, budget/ray {tea.rspec.samples_per_ray:g}")
    log("large-scene teacher train_stats " + json.dumps(tea.train_stats))
    log("large-scene student train_stats " + json.dumps(stu.train_stats))
    pt, ps = st_t["psnr"], st_s["psnr"]
    if not (np.isfinite(pt) and pt >= LS_TEACHER_FLOOR):
        raise RuntimeError(f"large-scene teacher test PSNR {pt:.3f} < "
                           f"{LS_TEACHER_FLOOR}")
    if not (np.isfinite(ps) and ps >= LS_STUDENT_FLOOR
            and ps >= pt - LS_MAX_DROP):
        raise RuntimeError(f"large-scene student test PSNR {ps:.3f}: floor "
                           f"{LS_STUDENT_FLOOR}, teacher {pt:.3f} - "
                           f"{LS_MAX_DROP}")
    # the distill Trainer renders its teacher with the student's sample
    # budget, so hold the reloaded teacher to the trained one's parameters
    reloaded = all(torch.equal(a, b) for a, b in zip(
        stu.teacher.parameters(), tea.state.field.parameters()))
    if not reloaded:
        raise RuntimeError("the large-scene teacher reloaded from its "
                           "checkpoint differs from the trained one")
    if not last > first:
        raise RuntimeError("large-scene teacher train-batch PSNR did not "
                           "rise")
    return tea, stu, scene, info


def march_case(bits, o, d, nears, fars, rs, u=None) -> dict:
    """K2 (dt_gamma = 0) or K14 against its plain version on one batch:
    t, dt, mask and t0 bit-exact, delta_depth within TOL_K2_DD (K14's
    TOL_K14_DD is the same); times and the bound.  Ops per lattice point
    the function needs: K2 ~20 (the closed-form t's FMA, the position, the
    cell and lookup), K14 ~24 (the recurrence's 4 and the cascade pick's
    extra); every point in eval mode, in train mode each ray's points up
    to its S-th occupied one or to far."""
    k = march_rays(bits, o, d, nears, fars, rs, u)
    p = march_rays_plain(bits, o, d, nears, fars, rs, u)
    exact = all(torch.equal(getattr(k, f), getattr(p, f))
                for f in ("t", "dt", "mask", "t0"))
    err = max_abs(k.delta_depth, p.delta_depth)
    N, S, L = o.shape[0], rs.max_samples, rs.max_steps
    if S >= L:
        points = N * L
    else:
        # the lattice the rays need: up to the S-th occupied point or far
        rs_e = dataclasses.replace(rs, max_samples=L)
        occ = march_rays_plain(bits, o, d, nears, fars, rs_e, u).mask
        if rs.dt_gamma > 0:
            lattice = _t_lattice_geom(p.t0, rs)
        else:
            lattice = fma32(torch.arange(L, dtype=torch.float32,
                                         device=o.device)[None, :],
                            dt_min_of(rs), p.t0[:, None])
        live = (lattice < fars[:, None]).sum(1)
        rank = torch.cumsum(occ.long(), 1)
        stop = torch.where(rank[:, -1] >= S,
                           (rank < S).sum(1) + 1, torch.full_like(live, L))
        points = int(torch.minimum(live, stop).sum())
    ops = 24 if rs.dt_gamma > 0 else 20
    bnd = bound(N * 32 + bits.numel() + N * S * 13 + N * 4, points * ops)
    return {"rays": N, "L": L, "S": S, "exact": exact, "dd_err": err,
            "samples": int(k.mask.sum()), "points": points, "bound": bnd,
            **timings(lambda: march_rays(bits, o, d, nears, fars, rs, u),
                      lambda: march_rays_plain(bits, o, d, nears, fars, rs,
                                               u))}


def log_march(kernel: str, label: str, c: dict):
    """Log one march_case; raise if it is not exact."""
    log(f"{kernel} {label} ({c['rays']} rays, L {c['L']}, S {c['S']}): "
        f"{c['samples']} samples, {c['points']} lattice points needed; "
        f"t/dt/mask/t0 exact {c['exact']}, delta_depth err "
        f"{c['dd_err']:.3g}; kernel {c['ms']:.4f} ms{alone(c)} (call "
        f"{c['call_ms']:.4f}), plain {c['plain_ms']:.4f} ms, bound "
        f"{c['bound'][0]:.4f} ms ({c['bound'][1]})")
    if not (c["exact"] and c["dd_err"] <= TOL_K2_DD):
        raise RuntimeError(f"{kernel} differs from the plain march "
                           f"({label})")


def k12_k13_case(table, x01, gen) -> dict:
    """K12 and K13 against their plain versions on polar points x01
    [P, 2] with a dense random upstream gradient (every composited ray's
    background takes one); library yardsticks F.grid_sample (the three
    dense levels only: the hashed level 3 has no library call) and
    index_add_ of the precomputed corner contributions (the scatter
    alone)."""
    import torch.nn.functional as F

    gs = bg_grid_spec()
    P = x01.shape[0]
    k12 = hash_encode_fwd(table, x01, gs)
    p12 = hash_encode_plain(table, x01, gs)
    abs12 = max_abs(k12, p12)
    g = torch.randn(P, gs.output_dim, generator=gen, device=x01.device)
    k13 = hash_encode_bwd(x01, g, gs)
    p13 = hash_encode_bwd_plain(x01, g, gs)
    abs13 = max_abs(k13, p13)
    rows, vals = [], []
    for level in range(gs.num_levels):
        w, r = level_corners(x01, gs, level)
        rows.append(r.reshape(-1))
        vals.append((w[:, :, None] * g[None, :, 2 * level:2 * level + 2])
                    .reshape(-1, 2))
    touched = int(torch.cat(rows).unique().numel())
    # bytes: x01 once, the touched rows once, the [P, 8] output once
    b12 = bound(P * 8 + touched * 8 + P * gs.output_dim * 4,
                P * gs.num_levels * 30)
    # bytes: x01 and g once, the dense [T, 2] gradient written once
    b13 = bound(P * 8 + P * gs.output_dim * 4 + gs.table_size * 8,
                P * gs.num_levels * 38)
    rows, vals = torch.cat(rows), torch.cat(vals)
    dense = [gs.level_side(lv) for lv in range(gs.num_levels)
             if not gs.level_is_hashed(lv)]
    offs = gs.offsets
    ims = [table[offs[i]:offs[i] + side * side].reshape(side, side, 2)
           .permute(2, 0, 1)[None].contiguous()
           for i, side in enumerate(dense)]
    grid = (x01 * 2.0 - 1.0)[None, None]

    def lib12():
        return [F.grid_sample(im, grid, mode="bilinear",
                              padding_mode="border", align_corners=False)
                for im in ims]

    def lib13():
        return torch.zeros(gs.table_size, 2, device=x01.device).index_add_(
            0, rows, vals)

    return {"err12": abs12 / float(p12.abs().max()), "abs12": abs12,
            "err13": abs13 / float(p13.abs().max()), "abs13": abs13,
            "points": P, "touched_rows": touched, "bound12": b12,
            "bound13": b13,
            "t12": timings(lambda: hash_encode_fwd(table, x01, gs),
                           lambda: hash_encode_plain(table, x01, gs)),
            "t13": timings(lambda: hash_encode_bwd(x01, g, gs),
                           lambda: hash_encode_bwd_plain(x01, g, gs)),
            "lib12_ms": cuda_ms(lib12), "lib13_ms": cuda_ms(lib13),
            "floor12_ms": floor_ms(P * gs.output_dim * 4, x01.device),
            # the dense zero fill alone, which both K13's call and the
            # index_add_ yardstick begin with
            "zero13_ms": cuda_ms(lambda: torch.zeros(gs.table_size, 2,
                                                     device=x01.device))}


def k13_hard_inputs(n: int = 4096, seed: int = 0) -> dict:
    """K13's contention and edge inputs, as numpy (x01 [n, 2], g [n, 8]);
    tests/test_torch_background.py holds the plain version against JAX's
    VJP on the same ones.  "one_cell": every point inside one level-0 cell
    (pos = x * 15 + 0.5 in [7, 8)), so every level-0 add lands on 4 rows;
    "edge": points exactly on 0 and 1, a few outside [0, 1]^2, and every
    third upstream row zero."""
    rng = np.random.default_rng(seed)
    lo, hi = 6.5 / 15.0, 7.5 / 15.0
    one = rng.uniform(lo + 1e-4, hi - 1e-4, (n, 2)).astype(np.float32)
    edge = rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    q = n // 8
    edge[:q, 0], edge[q:2 * q, 1] = 0.0, 1.0
    edge[2 * q:3 * q] = rng.choice([0.0, 1.0], (q, 2))
    edge[3 * q:3 * q + 8] = [[-1e-3, 0.5], [0.5, 1.001], [1.0 + 2 ** -23, 0.5],
                             [0.5, -2 ** -24], [-0.5, -0.5], [1.5, 1.5],
                             [0.25, 2.0], [-3.0, 0.75]]
    g_edge = rng.normal(size=(n, 8)).astype(np.float32)
    g_edge[::3] = 0.0
    return {"one_cell": (one, rng.normal(size=(n, 8)).astype(np.float32)),
            "edge": (edge, g_edge)}


def check_k13_hard_cases(dev) -> dict:
    """K13 on k13_hard_inputs against hash_encode_bwd_plain at
    TOL_K13_REL."""
    gs = bg_grid_spec()
    out = {}
    for name, (x, g) in k13_hard_inputs().items():
        x01, gt = torch.from_numpy(x).to(dev), torch.from_numpy(g).to(dev)
        p = hash_encode_bwd_plain(x01, gt, gs)
        err = max_abs(hash_encode_bwd(x01, gt, gs), p) / float(p.abs().max())
        out[name] = {"err": err}
        log(f"K13 {name} ({x.shape[0]} points): rel err {err:.3g}")
        if not err <= TOL_K13_REL:
            raise RuntimeError(f"K13 disagrees with its plain version on "
                               f"the {name} case: {err:.3g}")
    return out


def k14_hard_inputs(n: int = 45, seed: int = 0) -> dict:
    """K14's hard lattices, as numpy: name -> (RenderSpec fields, min_near,
    bitfield [C*H^3], rays_o [n, 3], rays_d [n, 3], u [n] or None);
    tests/test_torch_march.py holds the plain march against JAX's on the
    same ones.  Half the rays start inside the box (near = min_near 0.01),
    half outside it.  At dt_gamma 1/16 the lattice crosses all three
    regimes of clip(t * dt_gamma, dt_min, dt_max) on one ray: dt_min below
    t = 16 dt_min (0.055 at L = 1000), geometric steps up to 16 dt_max (3.46
    at bound 2, H 32) and dt_max past it.  Eval (S = L) and train (S = 64,
    perturbed) at L = 1000; L = 100 (not a multiple of 32) with S = 1 and 2
    (a ray fills its slots inside its first window) and S = 128 (eval,
    slots past L); one cascade (bound 1).  n is not a multiple of the 8
    rays of a block."""
    rng = np.random.default_rng(seed)
    cases = {}
    specs = {"three_regimes_eval": (2.0, 1000, 1000, False),
             "three_regimes_train": (2.0, 1000, 64, True),
             "L100_S1": (2.0, 100, 1, True),
             "L100_S2": (2.0, 100, 2, False),
             "L100_eval_S128": (2.0, 100, 128, False),
             "one_cascade": (1.0, 1000, 32, True)}
    for name, (bnd, L, S, perturb) in specs.items():
        spec = dict(bound=bnd, grid_size=32, max_steps=L, max_samples=S,
                    dt_gamma=1.0 / 16.0)
        C = 1 if bnd <= 1.0 else 2
        bits = rng.uniform(size=C * 32 ** 3) < 0.3
        h = n // 2
        dirs = rng.normal(size=(n, 3))
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        o = np.concatenate([rng.uniform(-0.75 * bnd, 0.75 * bnd, (h, 3)),
                            -2.6 * bnd * dirs[h:]])
        d = dirs + rng.normal(scale=0.15, size=(n, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        u = rng.uniform(size=n).astype(np.float32) if perturb else None
        cases[name] = (spec, 0.01, bits, o.astype(np.float32),
                       d.astype(np.float32), u)
    return cases


def march_rays_from(rng, n: int, bnd: float):
    """n rays (rays_o, rays_d as float32): half start inside the box (near
    = min_near), half on a sphere outside it aimed near the center, of
    which every eighth points away from the box (far < near) and every
    eighth passes beside it (near = far = FLT_MAX)."""
    h = n // 2
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    o = np.concatenate([rng.uniform(-0.75 * bnd, 0.75 * bnd, (h, 3)),
                        -2.6 * bnd * dirs[h:]])
    d = dirs + rng.normal(scale=0.15, size=(n, 3))
    d[h::8] *= -1.0
    side = np.cross(dirs, [0.0, 0.0, 1.0])
    side /= np.linalg.norm(side, axis=-1, keepdims=True)
    o[h + 4::8] += 2.5 * bnd * side[h + 4::8]
    d[h + 4::8] = dirs[h + 4::8]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def k2_hard_inputs(n: int = 45, seed: int = 0) -> dict:
    """K2's hard lattices (dt_gamma 0), as numpy, in k14_hard_inputs'
    layout: name -> (RenderSpec fields, min_near, bitfield [C*H^3], rays_o
    [n, 3], rays_d [n, 3], u [n] or None); tests/test_torch_march.py holds
    the plain march against JAX's on the same ones.  H 32; half the rays
    start inside the box, and a quarter of the others miss it
    (`march_rays_from`).  L = 100 (not a multiple of 32) with S = 1 and 2 (a ray
    fills its slots inside its first window) and S = 128 > L (eval, slots
    past L); L = 1000 in eval (S = L) and train (S = 64, perturbed); an
    all-occupied grid where every ray's point k is occupied from its near
    to its far, so the S-th sample of an unperturbed ray is point S - 1:
    S = 32 ends on the last lane of a 32-point window, S = 128 on the last
    lane of four; an empty grid (no sample, eval and train); two cascades
    (bound 2) in eval and train; L = 101 (not a multiple of a lane's 4
    points) in eval with S = 101 and 102 (no 4-slot stores) and S = 104
    (4-slot stores but the last lane's point past L), and in train with
    S = 3.  n is not a multiple of a block's 8 rays."""
    rng = np.random.default_rng(seed)
    # name: (bound, L, S, perturbed, occupancy)
    specs = {"L100_S1": (1.0, 100, 1, True, 0.3),
             "L100_S2": (1.0, 100, 2, False, 0.3),
             "L100_eval_S128": (1.0, 100, 128, False, 0.3),
             "L1000_eval": (1.0, 1000, 1000, False, 0.3),
             "L1000_train": (1.0, 1000, 64, True, 0.3),
             "full_S32": (1.0, 1000, 32, False, 1.0),
             "full_S128": (1.0, 1000, 128, False, 1.0),
             "empty_eval": (1.0, 1000, 1000, False, 0.0),
             "empty_train": (1.0, 1000, 64, True, 0.0),
             "two_cascades_eval": (2.0, 1000, 1000, False, 0.3),
             "two_cascades_train": (2.0, 1000, 64, True, 0.3),
             "L101_eval_S101": (1.0, 101, 101, False, 0.3),
             "L101_eval_S102": (1.0, 101, 102, True, 0.3),
             "L101_eval_S104": (1.0, 101, 104, False, 0.3),
             "L101_S3": (1.0, 101, 3, True, 0.3)}
    cases = {}
    for name, (bnd, L, S, perturb, occ) in specs.items():
        spec = dict(bound=bnd, grid_size=32, max_steps=L, max_samples=S)
        C = 1 if bnd <= 1.0 else 2
        bits = rng.uniform(size=C * 32 ** 3) < occ
        o, d = march_rays_from(rng, n, bnd)
        u = rng.uniform(size=n).astype(np.float32) if perturb else None
        cases[name] = (spec, 0.01, bits, o, d, u)
    return cases


def check_march_hard_cases(kernel: str, cases: dict, dev) -> dict:
    """K2 or K14 on its hard lattices (`k2_hard_inputs`,
    `k14_hard_inputs`) against march_rays_plain: t, dt, mask and t0
    bit-exact, delta_depth within TOL_K2_DD."""
    out = {}
    for name, (spec, min_near, bits, o, d, u) in cases.items():
        rs = RenderSpec(**spec)
        bound_ = spec["bound"]
        aabb = torch.tensor([-bound_] * 3 + [bound_] * 3, device=dev)
        ot, dt_ = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
        nears, fars = near_far_from_aabb(ot, dt_, aabb, min_near)
        bt = torch.from_numpy(bits).to(dev)
        ut = None if u is None else torch.from_numpy(u).to(dev)
        k = march_rays(bt, ot, dt_, nears, fars, rs, ut)
        p = march_rays_plain(bt, ot, dt_, nears, fars, rs, ut)
        exact = all(torch.equal(getattr(k, f), getattr(p, f))
                    for f in ("t", "dt", "mask", "t0"))
        err = max_abs(k.delta_depth, p.delta_depth)
        out[name] = {"exact": exact, "dd_err": err,
                     "samples": int(k.mask.sum())}
        log(f"{kernel} {name} (L {rs.max_steps}, S {rs.max_samples}, "
            f"{o.shape[0]} rays, {int(k.mask.sum())} samples): t/dt/mask/t0 "
            f"exact {exact}, delta_depth err {err:.3g}")
        if not (exact and err <= TOL_K2_DD):
            raise RuntimeError(f"{kernel} differs from the plain march on "
                               f"the {name} case")
    return out


def check_k2_hard_cases(dev) -> dict:
    return check_march_hard_cases("K2", k2_hard_inputs(4099), dev)


def check_k14_hard_cases(dev) -> dict:
    return check_march_hard_cases("K14", k14_hard_inputs(4099), dev)


def k5_hard_inputs(n: int = 4101, res=(20, 24, 28), seed: int = 0) -> dict:
    """K5's hard inputs, as numpy: name -> (planes 3 x [H_i, W_i, R], lines
    3 x [L_i, R], x [n, 3], g [3, n, R]); tests/test_torch_vm.py holds the
    plain backward against JAX's VJP on the same ones.  The resolutions
    are not cubic (a swapped axis shows) and n is ragged.  "one_cell":
    every sample in one plane cell and one line row of every branch (the
    worst contention); "zero_rows": every third upstream row zero (K5 skips
    them); "outside": positions beyond [-1, 1] on every axis (vanishing
    tent weights, extrapolating lines); "rank5": R = 5 (the scalar
    instantiation); "long_line": one line of 640 rows at R = 64.  The
    others have R = 16."""
    rng = np.random.default_rng(seed)
    mats, vecs = ((0, 1), (0, 2), (1, 2)), (2, 1, 0)

    def tables(rs, r):
        planes = [(0.1 * rng.standard_normal((rs[m1], rs[m0], r)))
                  .astype(np.float32) for m0, m1 in mats]
        lines = [(0.1 * rng.standard_normal((rs[v], r))).astype(np.float32)
                 for v in vecs]
        return planes, lines

    def grad(r):
        return rng.standard_normal((3, n, r)).astype(np.float32)

    # mid-cell on every axis, for the axis's resolution
    mid = np.array([2.0 * (r // 3 + 0.5) / (r - 1) - 1.0 for r in res])
    one = (mid + rng.uniform(-1e-4, 1e-4, (n, 3))).astype(np.float32)
    uni = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    out_x = rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    out_x[:6] = [[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0], [-1.3, 0.2, 1.3],
                 [1.3, -1.3, 0.0], [0.0, 1.2, -1.2], [-1.0 - 2 ** -20, 1.0,
                                                      0.5]]
    g_zero = grad(16)
    g_zero[:, ::3] = 0.0
    long_res = (res[0], res[1], 640)
    return {"one_cell": (*tables(res, 16), one, grad(16)),
            "zero_rows": (*tables(res, 16), uni, g_zero),
            "outside": (*tables(res, 16), out_x, grad(16)),
            "rank5": (*tables(res, 5), uni, grad(5)),
            "long_line": (*tables(long_res, 64), uni, grad(64))}


def k5_rel_err(k, p) -> tuple:
    """(max over the six gradient leaves of max |kernel - plain| / max
    |plain|, the largest absolute difference)."""
    pairs = list(zip(k[0] + k[1], p[0] + p[1]))
    return (max(max_abs(a, b) / float(b.abs().max()) for a, b in pairs),
            max(max_abs(a, b) for a, b in pairs))


def check_k5_hard_cases(dev) -> dict:
    """K5 on k5_hard_inputs against vm_sample_bwd_plain at TOL_K5_REL, and
    the "zero_rows" tables one float off 16-byte alignment (the scalar
    instantiation at R = 16); each case logs the instantiation
    `k5_variant` picks and must pick the one it was made for."""
    cases = k5_hard_inputs()
    want = {"one_cell": "float4", "zero_rows": "float4", "outside": "float4",
            "rank5": "scalar", "long_line": "float4", "misaligned": "scalar"}

    def shifted(a):
        buf = torch.zeros(a.size + 1, device=dev)
        buf[1:] = torch.from_numpy(a).to(dev).reshape(-1)
        return buf[1:].view(a.shape)

    out = {}
    for name in want:
        planes, lines, x, g = cases["zero_rows" if name == "misaligned"
                                    else name]
        make = shifted if name == "misaligned" else \
            (lambda a: torch.from_numpy(a).to(dev))
        pl, li = [make(a) for a in planes], [make(a) for a in lines]
        xt, gt = torch.from_numpy(x).to(dev), torch.from_numpy(g).to(dev)
        R = gt.shape[-1]
        kind, lanes = k5_variant(R, [t.data_ptr() for t in (*pl, *li, gt)])
        err, abs_err = k5_rel_err(vm_sample_bwd(pl, li, xt, gt),
                                  vm_sample_bwd_plain(pl, li, xt, gt))
        out[name] = {"variant": kind, "lanes": lanes, "M": x.shape[0],
                     "R": R, "err": err, "abs_err": abs_err}
        log(f"K5 {name}: {kind} instantiation, {lanes} lanes per sample, M "
            f"{x.shape[0]}, R {R}: rel err {err:.3g}")
        if not (err <= TOL_K5_REL and kind == want[name]):
            raise RuntimeError(f"K5 ({name}): {kind} instantiation (want "
                               f"{want[name]}), rel err {err:.3g}")
    return out


def march_runs(rng, n: int, lo: int = 8, hi: int = 64) -> np.ndarray:
    """n points [n, 3] in [0, 1]^3, ray-major as the compacted stream is:
    runs of lo..hi consecutive samples of random rays at the march's step
    (2 sqrt(3) / 1024 in [-1, 1]^3, half that in x01)."""
    step = np.sqrt(3.0) / 1024.0
    runs, total = [], 0
    while total < n:
        k = int(rng.integers(lo, hi + 1))
        d = rng.normal(size=3)
        runs.append(rng.uniform(0.25, 0.75, 3)
                    + np.arange(k)[:, None] * step * d / np.linalg.norm(d))
        total += k
    return np.concatenate(runs)[:n].astype(np.float32)


def k7_collision(spec, level: int, rng, mask: int = 0) -> tuple:
    """Two lattice cells (base coordinates) of a hashed level whose corner-0
    rows collide (under `mask`, by default the corner table's hash mask;
    a cell level's rows use the cell mask): a key on that row would merge
    their lanes."""
    side = spec.level_side(level)
    mask = mask or 2 ** spec.log2_hashmap_size - 1
    b = rng.integers(0, side - 1, (40_000, 3)).astype(np.uint64)
    h = (b[:, 0] ^ (b[:, 1] * np.uint64(2654435761))
         ^ (b[:, 2] * np.uint64(805459861))) % np.uint64(2 ** 32) \
        & np.uint64(mask)
    order = np.argsort(h, kind="stable")
    for i, j in zip(order[:-1], order[1:]):
        if h[i] == h[j] and (b[i] != b[j]).any():
            return b[i].astype(np.int64), b[j].astype(np.int64)
    raise RuntimeError("no colliding cells found")


def k7_hard_inputs(n: int = 4096, seed: int = 0) -> dict:
    """K7's contention and edge inputs on the INGP grid (HashGridSpec():
    14 levels, 2^19 rows, levels 0-4 dense), as numpy: name -> (x01 [n, 3],
    g [n, 2 * levels], HashGridSpec arguments).
    tests/test_torch_hash_grad.py holds the plain version against JAX's VJP
    on the same ones.
    "one_cell": every point inside one level-0 cell (pos = x * 15 + 0.5 in
    [7, 8)), so a warp's 32 points add to 8 rows; "rays": ray-major runs of
    8-64 samples; "g_levels": those with g zero at levels 2 and 9 for every
    point and at half the (point, level) pairs; "edge": points on the
    cube's faces and corners and 8 outside it, every third g row zero;
    "padded": a padded stream, 32 slots per ray with g zero past the first
    3 (~90% zero rows); "cell_levels": the cell-mode grid (levels 5-13
    cell-packed), so K7 covers slots 0-4 of each 14-slot row;
    "collision": lanes alternating between two cells of level 5 whose
    corner-0 hashed rows collide; "odd_levels": ray-major runs on a 13-level
    grid, whose g rows K7 reads as float2s."""
    rng = np.random.default_rng(seed)
    spec = HashGridSpec()
    L2 = spec.output_dim

    def normal():
        return rng.normal(size=(n, L2)).astype(np.float32)

    lo, hi = 6.5 / 15.0, 7.5 / 15.0
    one = rng.uniform(lo + 1e-4, hi - 1e-4, (n, 3)).astype(np.float32)
    g_lv = normal().reshape(n, -1, 2)
    g_lv[:, [2, 9]] = 0.0
    g_lv[rng.uniform(size=g_lv.shape[:2]) < 0.5] = 0.0
    edge = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    q = n // 8
    edge[:q, 0], edge[q:2 * q, 1], edge[2 * q:3 * q, 2] = 0.0, 1.0, 1.0
    edge[3 * q:4 * q] = rng.choice([0.0, 1.0], (q, 3))
    edge[4 * q:4 * q + 8] = [[-1e-3, 0.5, 0.5], [0.5, 1.001, 0.5],
                             [1.0 + 2 ** -23, 0.5, 0.5], [0.5, 0.5, -2 ** -24],
                             [-0.5, -0.5, -0.5], [1.5, 1.5, 1.5],
                             [0.25, 2.0, 0.5], [-3.0, 0.75, 0.5]]
    g_edge = normal()
    g_edge[::3] = 0.0
    g_pad = normal()
    g_pad[np.arange(n) % 32 >= 3] = 0.0
    a, b = k7_collision(spec, 5, rng)
    scale = np.float32(spec.level_scale(5))
    cells = np.where((np.arange(n) % 2 == 0)[:, None], a, b)
    coll = ((cells + rng.uniform(0.1, 0.9, (n, 3)) - 0.5) / scale) \
        .astype(np.float32)
    g_odd = rng.normal(size=(n, 26)).astype(np.float32)
    return {"one_cell": (one, normal(), {}),
            "rays": (march_runs(rng, n), normal(), {}),
            "g_levels": (march_runs(rng, n), g_lv.reshape(n, L2), {}),
            "edge": (edge, g_edge, {}),
            "padded": (march_runs(rng, n, 32, 32), g_pad, {}),
            "cell_levels": (march_runs(rng, n), normal(),
                            {"n_cell_levels": 9}),
            "collision": (coll, normal(), {}),
            "odd_levels": (march_runs(rng, n), g_odd, {"num_levels": 13})}


def k3_stream(rng, alphas: list, n_rays: int = 0, tail: int = 0) -> tuple:
    """A compacted stream of rays in order, ray r's valid slots with the
    alphas alphas[r] (sigma = -log(1 - alpha) / dt), then `tail` invalid
    slots carrying ray 0; n_rays > len(alphas) adds rays with no slot."""
    dt0 = np.sqrt(3.0) / 512.0
    lengths = [len(a) for a in alphas]
    total = sum(lengths)
    M = total + tail
    n_rays = max(n_rays, len(alphas))
    valid = np.arange(M) < total
    rid = np.zeros(M, np.int64)
    rid[:total] = np.repeat(np.arange(len(alphas)), lengths)
    alpha = np.zeros(M)
    if total:
        alpha[:total] = np.concatenate([np.asarray(a, float) for a in alphas])
    sig = np.where(alpha >= 1.0, 1e5,
                   -np.log1p(-np.minimum(alpha, 0.99999)) / dt0)
    sig = np.where(valid, sig, rng.uniform(0, 50, M)).astype(np.float32)
    dt = np.where(valid, dt0, 0.0).astype(np.float32)
    t_cum = np.zeros(M, np.float32)
    start = 0
    for k in lengths:
        t_cum[start:start + k] = (rng.uniform(0.5, 2.0)
                                  + dt0 * np.arange(1, k + 1))
        start += k
    rgb = rng.uniform(0, 1, (M, 3)).astype(np.float32)
    return sig, rgb, dt, t_cum, rid, valid, n_rays


def k3_hard_inputs(seed: int = 0) -> dict:
    """K3's edge inputs, as numpy: name -> (sigmas, rgbs, delta_t, t_cum
    [M], ray_id [M] int64, valid [M] bool, n_rays); tests/
    test_torch_composite.py holds the plain version against JAX's on the
    same ones, with early stop on and off.  The mean budget per ray picks
    K3's lanes per ray (16 up to 16 slots, else 32), so each tile case
    comes in both widths.  "counts": rays with 0, 1, 15, 16, 17, 31, 32,
    33, 256 and 1024 valid slots (alpha under 0.008: the long rays stay
    above T = 1e-4); "counts_16": the same with 90 empty rays after them;
    "opaque": slots with alpha = 1 (T -> 0), one first in its ray;
    "stop": rays of 48 slots whose T falls from ~2e-4 to ~2e-5 at slot k,
    the first stopped slot, for k = 7, 8, 15, 16, 17, 31, 32, 33 (inside a
    tile and at either width's tile edge); "stop_16": the same with 24
    empty rays; "eval_tail": 30 rays of 0-20 slots, then 200 invalid slots
    carrying ray 0; "empty": no slot, 8 rays."""
    rng = np.random.default_rng(seed)

    def low(k):
        return rng.uniform(0.0, 0.008, k)

    counts = [low(k) for k in (0, 1, 15, 16, 17, 31, 32, 33, 256, 1024)]
    stops = []
    for k in (7, 8, 15, 16, 17, 31, 32, 33):
        a = np.full(48, 0.1)
        a[:k - 1] = 1.0 - 2e-4 ** (1.0 / (k - 1))
        a[k - 1] = 0.9
        stops.append(a)
    opaque = [rng.uniform(0.0, 0.2, 40), np.r_[1.0, low(39)],
              rng.uniform(0.0, 0.2, 5)]
    opaque[0][10] = 1.0
    tail = [rng.uniform(0.0, 0.3, int(k)) for k in rng.integers(0, 21, 30)]
    return {"counts": k3_stream(rng, counts),
            "counts_16": k3_stream(rng, counts, n_rays=100),
            "opaque": k3_stream(rng, opaque),
            "stop": k3_stream(rng, stops),
            "stop_16": k3_stream(rng, stops, n_rays=32),
            "eval_tail": k3_stream(rng, tail, tail=200),
            "empty": k3_stream(rng, [], n_rays=8)}


# a NaN coordinate alone, every coordinate NaN, and NaN beside a coordinate
# outside [0, 1] (cut to the grid's D coordinates)
NAN_POINTS = ((math.nan, 0.5, 0.5), (0.5, math.nan, math.nan),
              (math.nan, math.nan, math.nan), (math.nan, -1.0, 0.5),
              (1.5, math.nan, 0.25))


def with_nan_points(x: np.ndarray, every: int = 97) -> np.ndarray:
    """A copy of x [n, D] whose points every `every`-th (from 5) are
    NAN_POINTS in turn."""
    x = x.copy()
    for j, i in enumerate(range(5, x.shape[0], every)):
        x[i] = NAN_POINTS[j % len(NAN_POINTS)][:x.shape[1]]
    return x


# K12's and K15's ragged point counts: none a multiple of a block of 32,
# 64 or 128 points (24,575: one short of the distill step's 24,576)
HARD_COUNTS = (1, 31, 33, 4097, 24_575)
_E = 1.0 - 2.0 ** -24
# the hard points' first rows: the far corner first (n = 1 takes it alone),
# corners and far faces (polar 0 and 1 for the background), 1 - 2^-24,
# just outside [0, 1], NaN beside a coordinate outside and alone
HARD_ROWS = {2: ((1, 1), (0, 0), (1, 0), (0, 1), (1, _E), (_E, 1), (0.5, 1),
                 (1, 0.5), (-1e-3, 0.5), (0.5, 1.001), (math.nan, -0.5),
                 (1.5, math.nan), (math.nan, 0.5), (1 + 2.0 ** -23, 0.25)),
             3: ((1, 1, 1), (0, 0, 0), (1, 0, 1), (_E, _E, _E), (1, 1, _E),
                 (0.5, 1, 0.25), (_E, 1, 0), (1, _E, 0.5), (-1e-3, 0.5, 0.5),
                 (0.5, 1.001, 0.5), (math.nan, -1, 0.5),
                 (1.5, math.nan, 0.25), (math.nan, 0.5, 0.5),
                 (0.3, 0.6, 1 + 2.0 ** -23))}


def hard_points(n: int, dim: int, seed: int = 0) -> np.ndarray:
    """K12's (dim 2) or K15's (dim 3) hard points, as numpy [n, dim]:
    HARD_ROWS first, then uniform points of [0, 1]^dim with NaN points
    every 97th (`with_nan_points`) and every 7th point on a far face;
    tests/test_torch_background.py and tests/test_torch_bake.py hold the
    plain encodes against JAX's on them."""
    rng = np.random.default_rng(seed + n)
    x = rng.uniform(0.0, 1.0, (n, dim))
    face = np.arange(0, n, 7)
    x[face, face % dim] = 1.0
    x = with_nan_points(x)
    rows = np.asarray(HARD_ROWS[dim][:n])
    x[:len(rows)] = rows
    return x.astype(np.float32)


def check_hard_counts(kernel: str, encode, plain, dim: int, tol: float,
                      dev) -> dict:
    """An encode on hard_points at every HARD_COUNTS count, against its
    plain version: the error relative to max |plain| (finite entries), NaN
    exactly where the plain version's is; raises on a count over tol."""
    out = {}
    for n in HARD_COUNTS:
        x01 = torch.from_numpy(hard_points(n, dim)).to(dev)
        p = plain(x01)
        scale = float(torch.nan_to_num(p).abs().max()) or 1.0
        out[n] = nan_abs(encode(x01), p) / scale
    log(f"{kernel} hard points (rel err by count): " + ", ".join(
        f"{n} {v:.3g}" for n, v in out.items()))
    over = [n for n, v in out.items() if not v <= tol]
    if over:
        raise RuntimeError(f"{kernel} disagrees with its plain version on "
                           f"the hard points at counts {over}")
    return out


K11_SPEC = dict(n_cell_levels=9)  # the A/B teacher's grid: levels 5-13
# 20 levels, 18 of them cell-packed (2-19): more than a K11 block's
# K11_SPAN = 16, so a second block (blockIdx.y) takes levels 18 and 19
K11_SPEC20 = dict(num_levels=20, n_cell_levels=18, base_resolution=32,
                  log2_hashmap_size=16)


def k11_hard_inputs(n: int = 4099, seed: int = 0) -> dict:
    """K11's contention and edge inputs, as numpy: name -> (x01 [n, 3], g
    [n, L * 2], HashGridSpec kwargs); n is a multiple of no block.  All but
    "levels20" are on the A/B teacher's grid (K11_SPEC: 14 levels, the 9
    finest cell-packed).  tests/test_torch_hashgrid.py holds the plain cell
    encode and cell-table gradient against JAX's on the same ones (the
    gradient where JAX defines it: without the NaN points).  "rays":
    ray-major runs of 8-64
    samples; "one_cell": every point in one cell of the coarsest cell
    level (level 5), so every lane of a warp adds to one row there;
    "collision": lanes alternating between two cells of level 5 whose
    cell rows collide (a key on the row would merge them); "g_levels": ray
    runs with g zero at cell levels 6 and 11 for every point and at half
    the (point, level) pairs; "padded": a padded stream, 32 slots a ray
    with g zero past the first 3; "edge": points on the cube's faces and
    corners, 8 just or far outside it and NaN points (`with_nan_points`:
    NaN alone and beside a coordinate outside [0, 1]), every third g row
    zero; "levels20": ray runs on K11_SPEC20's grid (18 cell levels, two
    K11 blocks a point), g whole in the first half of the stream (dense
    blocks) and on every fourth point after it (sparse blocks)."""
    rng = np.random.default_rng(seed)
    spec = HashGridSpec(**K11_SPEC)
    L2 = spec.output_dim
    lv0 = spec.cell_levels[0]
    s0 = np.float32(spec.level_scale(lv0))

    def normal():
        return rng.normal(size=(n, L2)).astype(np.float32)

    k = float(int(s0) // 2)  # the cell [k, k + 1) of pos = x * s0 + 0.5
    one = rng.uniform((k - 0.5) / s0 + 1e-4, (k + 0.5) / s0 - 1e-4,
                      (n, 3)).astype(np.float32)
    a, b = k7_collision(spec, lv0, rng, spec.cell_rows_per_level - 1)
    cells = np.where((np.arange(n) % 2 == 0)[:, None], a, b)
    coll = ((cells + rng.uniform(0.1, 0.9, (n, 3)) - 0.5) / s0) \
        .astype(np.float32)
    g_lv = normal().reshape(n, -1, 2)
    g_lv[:, [6, 11]] = 0.0
    g_lv[rng.uniform(size=g_lv.shape[:2]) < 0.5] = 0.0
    edge = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    q = n // 8
    edge[:q, 0], edge[q:2 * q, 1], edge[2 * q:3 * q, 2] = 0.0, 1.0, 1.0
    edge[3 * q:4 * q] = rng.choice([0.0, 1.0], (q, 3))
    edge[4 * q:4 * q + 8] = [[-1e-3, 0.5, 0.5], [0.5, 1.001, 0.5],
                             [1.0 + 2 ** -23, 0.5, 0.5], [0.5, 0.5, -2 ** -24],
                             [-0.5, -0.5, -0.5], [1.5, 1.5, 1.5],
                             [0.25, 2.0, 0.5], [-3.0, 0.75, 0.5]]
    g_edge = normal()
    g_edge[::3] = 0.0
    g_pad = normal()
    g_pad[np.arange(n) % 32 >= 3] = 0.0
    g20 = rng.normal(size=(n, HashGridSpec(**K11_SPEC20).output_dim)) \
        .astype(np.float32)
    g20[(np.arange(n) >= n // 2) & (np.arange(n) % 4 != 0)] = 0.0
    cases = {"rays": (march_runs(rng, n), normal()),
             "one_cell": (one, normal()),
             "collision": (coll, normal()),
             "g_levels": (march_runs(rng, n), g_lv.reshape(n, L2)),
             "padded": (march_runs(rng, n, 32, 32), g_pad),
             "edge": (with_nan_points(edge), g_edge)}
    return {**{k: (*v, K11_SPEC) for k, v in cases.items()},
            "levels20": (march_runs(rng, n), g20, K11_SPEC20)}


def k10_on_views(cell, x01, gs) -> float:
    """K10 on an x01 and an out that are views one float into larger
    buffers (4-byte aligned only), out filled with 7 first: the cell
    slots' error relative to max |plain| (NaN where the plain version
    gives NaN, else inf), inf if a slot outside the cell levels changed."""
    dev = x01.device
    P, L2 = x01.shape[0], gs.output_dim
    xv = torch.empty(x01.numel() + 1, device=dev)[1:].view(x01.shape)
    xv.copy_(x01)
    ov = torch.full((P * L2 + 1,), 7.0, device=dev)[1:].view(P, L2)
    hash_encode_cell_fwd(cell, xv, gs, ov)
    cols = [c for lv in gs.cell_levels for c in (2 * lv, 2 * lv + 1)]
    others = [c for c in range(L2) if c not in cols]
    if not bool((ov[:, others] == 7.0).all()):
        return math.inf
    p = hash_encode_cell_plain(cell, x01, gs)
    return nan_abs(ov[:, cols], p) / float(torch.nan_to_num(p).abs().max())


def check_k11_hard_cases(dev) -> dict:
    """K11 on k11_hard_inputs, with g as given and one float into a larger
    buffer (the wrapper realigns it), against the plain gradient of the
    points without a NaN coordinate (a NaN point adds nothing; the plain
    version, as JAX, adds NaN at a row its NaN lattice casts to), relative
    to max |plain|; and K10 on the same points against
    hash_encode_cell_plain, NaN where it gives NaN, then (after every
    other case) on them as views one float into larger buffers
    (`k10_on_views`).  Raises on a case over
    TOL_K11_REL or TOL_K10_REL (a NaN in K11's gradient counts as inf);
    else each case's errors, which the caller folds into K11's and K10's
    rows."""
    gen = torch.Generator(device=dev).manual_seed(2)
    out = {}
    for name, (x, g, kw) in k11_hard_inputs().items():
        gs = HashGridSpec(**kw)
        cell = torch.rand(gs.cell_table_size, gs.cell_row_width,
                          generator=gen, device=dev) * 2 - 1
        keep = torch.from_numpy(~np.isnan(x).any(-1)).to(dev)
        x01, gt = torch.from_numpy(x).to(dev), torch.from_numpy(g).to(dev)
        shifted = torch.empty(gt.numel() + 1, device=dev)[1:].view(gt.shape)
        shifted.copy_(gt)
        p = hash_encode_cell_bwd_plain(x01[keep], gt[keep], gs)
        err11 = max(max_abs(hash_encode_cell_bwd(x01, gg, gs), p)
                    / float(p.abs().max()) for gg in (gt, shifted))
        c10 = k10_case(cell, x01, gs)
        out[name] = {"err11": err11, "err10": c10["err"],
                     "cell_levels": len(gs.cell_levels),
                     "nan_points": int((~keep).sum())}
        log(f"K11/K10 {name} ({x.shape[0]} points, {len(gs.cell_levels)} "
            f"cell levels, {out[name]['nan_points']} with a NaN coordinate): "
            f"K11 rel err {err11:.3g}, K10 rel err {c10['err']:.3g}")
        if not (err11 <= TOL_K11_REL and c10["err"] <= TOL_K10_REL):
            raise RuntimeError(f"K11 or K10 disagrees with its plain version "
                               f"on the {name} case: {err11:.3g}, "
                               f"{c10['err']:.3g}")
    # K10 on an x01 and an out that are views one float into larger
    # buffers, after every other case (a K10 that stores wider than a float
    # faults on them)
    for name, (x, _, kw) in k11_hard_inputs().items():
        gs = HashGridSpec(**kw)
        cell = torch.rand(gs.cell_table_size, gs.cell_row_width,
                          generator=gen, device=dev) * 2 - 1
        err = k10_on_views(cell, torch.from_numpy(x).to(dev), gs)
        out[name]["err10"] = max(out[name]["err10"], err)
        log(f"K10 {name} on views one float into larger buffers: rel err "
            f"{err:.3g}")
        if not err <= TOL_K10_REL:
            raise RuntimeError(f"K10 disagrees with its plain version on "
                               f"views ({name}): {err:.3g}")
    return out


def k6_hard_inputs(seed: int = 0) -> dict:
    """K6's inputs, as numpy: k3_hard_inputs' streams (rays of 0, 1, 15-17,
    31-33, 256 and 1024 slots, with and without empty rays after them, an
    opaque slot first in its ray, the eval tail of invalid slots carrying
    ray 0, no slot at all) with random upstream gradients of weights_sum
    [N], depth [N], image [N, 3] and weights [M]: name -> (sigmas, rgbs,
    delta_t, t_cum, ray_id, valid, n_rays, (g_ws, g_depth, g_image,
    g_weights)).  tests/test_torch_composite.py holds the plain
    composite's gradients against JAX's autodiff on the same ones."""
    rng = np.random.default_rng(seed + 1)
    out = {}
    for name, case in k3_hard_inputs(seed).items():
        n, M = case[-1], case[0].shape[0]
        gs = tuple(rng.normal(size=shape).astype(np.float32)
                   for shape in ((n,), (n,), (n, 3), (M,)))
        out[name] = (*case, gs)
    return out


def k6_entry(sig, rgb, dt, t_cum, rid, valid, n, g) -> tuple:
    """K6 through its C entry, as the wrapper launches it, into outputs
    filled with NaN first (the wrapper's are torch.empty), so a slot that
    no ray owns and the kernel leaves unwritten shows; no launch counted.
    (d_sigma [M], d_rgb [M, 3])."""
    _, _, _, weights, bounds = composite_rays_compact_fwd(
        sig, rgb, dt, t_cum, rid, valid, n)
    d_sigma = torch.full_like(sig, math.nan)
    d_rgb = torch.full_like(rgb, math.nan)
    kernels.launch("pvd_composite_compact_bwd", sig.data_ptr(),
                   rgb.data_ptr(), dt.data_ptr(), t_cum.data_ptr(),
                   weights.data_ptr(), bounds.data_ptr(), rid.data_ptr(),
                   valid.data_ptr(), sig.shape[0], n,
                   k3_lanes(sig.shape[0], n), *(t.data_ptr() for t in g),
                   d_sigma.data_ptr(), d_rgb.data_ptr(),
                   kernels.stream_ptr(sig))
    return d_sigma, d_rgb


def check_k6_hard_cases(dev) -> dict:
    """K6 on k6_hard_inputs (k6_entry: outputs filled with NaN first)
    against autograd through the plain composite.  Raises on a case over
    TOL_K6 (a NaN counts as inf); else each case's max abs error, which the
    caller folds into K6's row."""
    out = {}
    for name, (*arrays, n, gs) in k6_hard_inputs().items():
        sig, rgb, dt, t_cum, rid, valid = (torch.from_numpy(a).to(dev)
                                           for a in arrays)
        g = [torch.from_numpy(a).to(dev) for a in gs]
        s = sig.clone().requires_grad_()
        r = rgb.clone().requires_grad_()
        plain = torch.autograd.grad(composite_rays_compact_plain(
            s, r, dt, t_cum, rid, valid, n), (s, r), g)
        err = max(max_abs(a, b) for a, b in zip(
            k6_entry(sig, rgb, dt, t_cum, rid, valid, n, g), plain))
        out[name] = {"err": err, "slots": sig.shape[0], "rays": n,
                     "lanes": k3_lanes(sig.shape[0], n)}
        log(f"K6 {name} ({sig.shape[0]} slots, {n} rays, "
            f"{out[name]['lanes']} lanes per ray): max abs err {err:.3g}")
        if not err <= TOL_K6:
            raise RuntimeError(f"K6 disagrees with its plain version on the "
                               f"{name} case: {err:.3g}")
    return out


def k9_hard_inputs(seed: int = 0) -> dict:
    """K9's inputs, as numpy: name -> (sigmas [N, S], rgbs [N, S, 3],
    delta_t [N, S], delta_depth [N, S], mask [N, S] bool, (g_ws [N],
    g_depth [N], g_image [N, 3], g_weights [N, S])), N a multiple of no
    block.  "S<k>": rows of k slots (1, 15-17, 31-33, 64, 96, and 130, past
    the K9_ROW = 96 slots a group keeps in registers), each ray's valid
    slots a prefix of random length as the padded march leaves them;
    "S96_wide", "S130_wide": 4099 such rays (a batch past 4096 rays);
    "scattered": [N, 96] with ~11% of the slots valid anywhere, the padded
    warm-up's share; "all_masked"; "last_only": masked but for each row's
    last slot; "opaque_first": a first slot with alpha = 1 (T = 0 after
    it); "dt_zero": dt = 0 (alpha = 0) on every slot; "zero_<g>": one kind
    of upstream gradient zero throughout.  tests/test_torch_composite.py
    holds the plain padded gradient against JAX's autodiff on the same
    ones."""
    rng = np.random.default_rng(seed + 2)

    def block(N, S, mask):
        sig = rng.choice([0.0, 0.5, 3.0, 20.0, 80.0], size=(N, S))
        sig = (sig * rng.uniform(0.5, 1.5, (N, S))).astype(np.float32)
        rgb = rng.uniform(0, 1, (N, S, 3)).astype(np.float32)
        dt = rng.uniform(0.002, 0.03, (N, S)).astype(np.float32)
        dd = (dt * rng.uniform(0.8, 1.2, (N, S))).astype(np.float32)
        g = tuple(rng.normal(size=shape).astype(np.float32)
                  for shape in ((N,), (N,), (N, 3), (N, S)))
        return [sig, rgb, dt, dd, mask, g]

    def prefix(N, S, hi=None):
        lens = rng.integers(0, (hi or S) + 1, N)
        lens[:3] = (0, S, 1)
        return np.arange(S)[None] < lens[:, None]

    out = {f"S{S}": block(37 if S < 64 else 203, S,
                          prefix(37 if S < 64 else 203, S))
           for S in (1, 15, 16, 17, 31, 32, 33, 64, 96, 130)}
    for S in (96, 130):  # a batch past 4096 rays
        out[f"S{S}_wide"] = block(4099, S, prefix(4099, S, 24))
    out["scattered"] = block(203, 96, rng.uniform(size=(203, 96)) < 0.11)
    out["all_masked"] = block(37, 96, np.zeros((37, 96), bool))
    last = np.zeros((37, 96), bool)
    last[:, -1] = True
    out["last_only"] = block(37, 96, last)
    case = block(37, 96, prefix(37, 96, 20))
    case[0][:, 0] = 1e4  # alpha = 1 where the first slot is valid
    out["opaque_first"] = case
    case = block(37, 96, prefix(37, 96))
    case[2][:] = 0.0
    out["dt_zero"] = case
    for k, name in enumerate(("g_ws", "g_depth", "g_image", "g_weights")):
        case = block(37, 33, prefix(37, 33))
        case[5] = tuple(np.zeros_like(g) if i == k else g
                        for i, g in enumerate(case[5]))
        out[f"zero_{name}"] = case
    return {k: tuple(v) for k, v in out.items()}


def k9_entry(sig, rgb, dt, dd, mask, g) -> tuple:
    """K9 through its C entry, as the wrapper launches it, into outputs
    filled with NaN first (the wrapper's are torch.empty), so a slot the
    kernel leaves unwritten shows; no launch counted.  (d_sigma [N, S],
    d_rgb [N, S, 3])."""
    weights = composite_rays_fwd(sig, rgb, dt, dd, mask)[3]
    N, S = sig.shape
    d_sigma = torch.full_like(sig, math.nan)
    d_rgb = torch.full_like(rgb, math.nan)
    kernels.launch("pvd_composite_padded_bwd", sig.data_ptr(),
                   rgb.data_ptr(), dt.data_ptr(), dd.data_ptr(),
                   mask.data_ptr(), weights.data_ptr(), N, S,
                   *(t.data_ptr() for t in g),
                   d_sigma.data_ptr(), d_rgb.data_ptr(),
                   kernels.stream_ptr(sig))
    return d_sigma, d_rgb


def check_k9_hard_cases(dev) -> dict:
    """K9 on k9_hard_inputs (k9_entry: outputs filled with NaN first)
    against composite_rays_bwd_plain.  Raises on a case over TOL_K9 (a
    NaN counts as inf); else each case's max abs error, which the caller
    folds into K9's row."""
    out = {}
    for name, (*arrays, gs) in k9_hard_inputs().items():
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        g = [torch.from_numpy(a).to(dev) for a in gs]
        plain = composite_rays_bwd_plain(*args, *g)
        err = max(max_abs(a, b) for a, b in zip(k9_entry(*args, g), plain))
        N, S = arrays[0].shape
        out[name] = {"err": err, "rays": N, "S": S,
                     "valid": int(arrays[4].sum())}
        log(f"K9 {name} ([{N}, {S}], {out[name]['valid']} valid): max abs "
            f"err {err:.3g}")
        if not err <= TOL_K9:
            raise RuntimeError(f"K9 disagrees with its plain version on the "
                               f"{name} case: {err:.3g}")
    return out


def k8_hard_inputs(seed: int = 0) -> dict:
    """K8's inputs, as numpy: name -> (sigmas [N, S], rgbs [N, S, 3],
    delta_t [N, S], delta_depth [N, S], mask [N, S] bool): every case of
    `k9_hard_inputs` (its upstream gradients left out) and "t_crosses":
    [203, 96] rows with valid prefixes of 64-96 slots whose sigma * dt
    (0.15-0.6 a slot) takes T under 1e-4 after 15-61 slots, inside a tile
    of 32 in most rows (early stop zeroes the weights from there on).
    tests/test_torch_composite.py holds the plain padded composite against
    JAX's on the same ones."""
    out = {k: v[:5] for k, v in k9_hard_inputs(seed).items()}
    rng = np.random.default_rng(seed + 3)
    N, S = 203, 96
    lens = rng.integers(64, S + 1, N)
    mask = np.arange(S)[None] < lens[:, None]
    dt = rng.uniform(0.002, 0.03, (N, S)).astype(np.float32)
    rate = rng.uniform(0.15, 0.6, (N, 1))
    sig = (rate / dt * rng.uniform(0.9, 1.1, (N, S))).astype(np.float32)
    rgb = rng.uniform(0, 1, (N, S, 3)).astype(np.float32)
    dd = (dt * rng.uniform(0.8, 1.2, (N, S))).astype(np.float32)
    out["t_crosses"] = (sig, rgb, dt, dd, mask)
    return out


def k8_entry(sig, rgb, dt, dd, mask, early_stop: bool) -> tuple:
    """K8 through its C entry, as the wrapper launches it, into outputs
    filled with NaN first (the wrapper's are torch.empty), so a slot or
    ray the kernel leaves unwritten shows; no launch counted.
    (weights_sum [N], depth [N], image [N, 3], weights [N, S])."""
    N, S = sig.shape
    outs = (torch.full((N,), math.nan, device=sig.device),
            torch.full((N,), math.nan, device=sig.device),
            torch.full((N, 3), math.nan, device=sig.device),
            torch.full((N, S), math.nan, device=sig.device))
    kernels.launch("pvd_composite_padded_fwd", sig.data_ptr(),
                   rgb.data_ptr(), dt.data_ptr(), dd.data_ptr(),
                   mask.data_ptr(), N, S, int(early_stop),
                   outs[3].data_ptr(), outs[0].data_ptr(),
                   outs[1].data_ptr(), outs[2].data_ptr(),
                   kernels.stream_ptr(sig))
    return outs


def check_k8_hard_cases(dev) -> dict:
    """K8 on k8_hard_inputs with early stop off and on (k8_entry: outputs
    filled with NaN first) against composite_rays_plain.  Raises on a case
    over TOL_K8 (a NaN counts as inf); else each case's max abs error,
    which the caller folds into K8's row."""
    out = {}
    for name, arrays in k8_hard_inputs().items():
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        N, S = arrays[0].shape
        for early in (False, True):
            plain = composite_rays_plain(*args, early_stop=early)
            err = max(max_abs(a, b) for a, b in
                      zip(k8_entry(*args, early), plain))
            key = name + ("_early_stop" if early else "")
            out[key] = {"err": err, "rays": N, "S": S,
                        "valid": int(arrays[4].sum())}
            log(f"K8 {key} ([{N}, {S}], {out[key]['valid']} valid): max "
                f"abs err {err:.3g}")
            if not err <= TOL_K8:
                raise RuntimeError(f"K8 disagrees with its plain version on "
                                   f"the {key} case: {err:.3g}")
    return out


# K16's hard specs: one dense level (side 17); three (17, 25, 35); base
# resolution 4 (seven, sides 5 to 73); a 2^22-row hash map (seven, up to
# side 152: 3.5 M vertices, the largest)
K16_HARD_SPECS = {"one_level": dict(num_levels=1),
                  "three_levels": dict(num_levels=3, desired_resolution=34),
                  "base_res4": dict(base_resolution=4),
                  "log2_22": dict(log2_hashmap_size=22)}


def k16_hard_table(gs, seed: int = 0) -> np.ndarray:
    """A random corner table [T, 2] for a K16 hard spec: values of
    magnitude up to 1e4, a third of them subnormal (the build flushes
    none), some zero."""
    rng = np.random.default_rng(seed + 5)
    shape = (gs.table_size, 2)
    t = rng.uniform(-1e4, 1e4, shape)
    kind = rng.integers(0, 6, shape)
    sub = rng.uniform(-1, 1, shape) * np.float32(2.0 ** -127)
    t = np.where(kind < 2, sub, t)
    t[kind == 2] = 0.0
    return t.astype(np.float32)


def check_k16_hard_cases(dev) -> dict:
    """K16 on each of K16_HARD_SPECS (a random table of `k16_hard_table`),
    held to build_baked_dense_plain bit for bit at every vertex and level;
    raises on a difference."""
    out = {}
    for name, kw in K16_HARD_SPECS.items():
        gs = HashGridSpec(**kw)
        table = torch.from_numpy(k16_hard_table(gs)).to(dev)
        got = build_baked_dense(table, gs)
        want = build_baked_dense_plain(table, gs)
        exact = torch.equal(got.view(torch.int32), want.view(torch.int32))
        sides = [gs.level_side(lv) for lv in gs.dense_levels]
        out[name] = {"sides": sides, "exact": exact,
                     "vertices": sides[-1] ** 3}
        log(f"K16 {name}: dense sides {sides}, bit for bit the plain "
            f"version {exact}")
        if not exact:
            raise RuntimeError(f"K16 differs from its plain version on the "
                               f"{name} spec")
        del table, got, want
    return out


def check_nan_rule(dev) -> dict:
    """The NaN rule on the card: K12 and K15 (the forward encodes) give NaN
    exactly where their plain versions do on edge points with NaN points
    among them (`with_nan_points`), and K7 and K13 (the table gradients)
    add nothing for a NaN point: their gradient equals the plain one of
    the other points.  Errors relative to max |plain| (finite entries).
    Raises on one over its kernel's tolerance; else the errors, which the
    caller folds into each kernel's row.  (K1's NaN cases are
    k1_hard_inputs', K10's and K11's k11_hard_inputs', and K12 and K15
    meet NaN points again in `hard_points`.)"""
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}

    def rel(k, p):
        return nan_abs(k, p) / float(torch.nan_to_num(p).abs().max())

    # K7 on k7_hard_inputs' edge case, K13 and K12 on k13_hard_inputs'
    x, g, kw = k7_hard_inputs()["edge"]
    for key, gs, (x, g) in (
            ("k7", HashGridSpec(**kw), (x, g)),
            ("k13", bg_grid_spec(), k13_hard_inputs()["edge"])):
        x = with_nan_points(x)
        keep = torch.from_numpy(~np.isnan(x).any(-1)).to(dev)
        x01, gt = torch.from_numpy(x).to(dev), torch.from_numpy(g).to(dev)
        out[key] = rel(hash_encode_bwd(x01, gt, gs),
                       hash_encode_bwd_plain(x01[keep], gt[keep], gs))
        if key == "k13":
            table = torch.rand(gs.table_size, 2, generator=gen,
                               device=dev) * 2 - 1
            out["k12"] = rel(hash_encode_fwd(table, x01, gs),
                             hash_encode_plain(table, x01, gs))
    # K15 on the A/B teacher's grid, baked from a random table
    gs = HashGridSpec(**K11_SPEC)
    table = torch.rand(gs.table_size, 2, generator=gen, device=dev) * 2 - 1
    baked = build_baked_dense(table, gs)
    x01 = torch.from_numpy(with_nan_points(k7_hard_inputs()["edge"][0])) \
        .to(dev)
    o15 = torch.zeros(x01.shape[0], gs.output_dim, device=dev)
    cols = [2 * lv + c for lv in gs.dense_levels for c in (0, 1)]
    out["k15"] = rel(hash_encode_baked_fwd(baked, x01, gs, o15)[:, cols],
                     hash_encode_baked_plain(baked, x01, gs))
    log("NaN rule (rel err against the plain versions; K7, K13 against the "
        "points without a NaN coordinate): " + ", ".join(
            f"{k.upper()} {v:.3g}" for k, v in out.items()))
    tols = {"k7": TOL_K7_REL, "k13": TOL_K13_REL, "k12": TOL_K12_REL,
            "k15": TOL_K15_REL}
    over = [k for k, v in out.items() if not v <= tols[k]]
    if over:
        raise RuntimeError(f"the NaN rule fails in {over}")
    return out


def check_k7_hard_cases(dev) -> dict:
    """K7 on k7_hard_inputs, with g as given and with g one float into a
    larger buffer (not 16-byte aligned: the wrapper clones it), against
    hash_encode_bwd_plain at TOL_K7_REL."""
    out = {}
    for name, (x, g, kw) in k7_hard_inputs().items():
        gs = HashGridSpec(**kw)
        x01, gt = torch.from_numpy(x).to(dev), torch.from_numpy(g).to(dev)
        shifted = torch.empty(gt.numel() + 1, device=dev)[1:].view(gt.shape)
        shifted.copy_(gt)
        p = hash_encode_bwd_plain(x01, gt, gs)
        err = max(max_abs(hash_encode_bwd(x01, gg, gs), p)
                  / float(p.abs().max()) for gg in (gt, shifted))
        out[name] = {"err": err}
        log(f"K7 {name} ({x.shape[0]} points): rel err {err:.3g}")
        if not err <= TOL_K7_REL:
            raise RuntimeError(f"K7 disagrees with its plain version on the "
                               f"{name} case: {err:.3g}")
    return out


def check_k3_hard_cases(dev) -> dict:
    """K3 on k3_hard_inputs, early stop off and on, against
    composite_rays_compact_plain at TOL_K3."""
    out = {}
    for name, case in k3_hard_inputs().items():
        *arrays, n = case
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        err = 0.0
        for early in (False, True):
            k = composite_rays_compact_fwd(*args, n, early)[:4]
            p = composite_rays_compact_plain(*args, n, early)
            err = max([err] + [max_abs(a, b) for a, b in zip(k, p)])
        out[name] = {"err": err, "lanes": k3_lanes(len(arrays[0]), n)}
        log(f"K3 {name} ({len(arrays[0])} slots, {n} rays, "
            f"{out[name]['lanes']} lanes per ray): max abs err {err:.3g}")
        if not err <= TOL_K3:
            raise RuntimeError(f"K3 disagrees with its plain version on the "
                               f"{name} case: {err:.3g}")
    return out


def k1_entry(table, x01, gs, baked: bool = False):
    """K1 alone through its C entry on the corner levels of `gs` (with
    `baked`, those a baked encode leaves to K1): the [P, L * 2] output with
    those levels' slots filled and the others zero, and the level list.
    The wrapper would add K10 (cell levels) or K15 (baked), and it counts
    the launch; this does neither."""
    out = torch.zeros(x01.shape[0], gs.output_dim, device=x01.device)
    lv = hashgrid._levels(gs, False, baked)
    if lv.n_levels:
        kernels.launch("pvd_hash_encode_fwd", x01.data_ptr(),
                       table.data_ptr(), out.data_ptr(), x01.shape[0], lv,
                       kernels.stream_ptr(x01))
    return out, list(lv.level)[:lv.n_levels]


def nan_abs(a, b) -> float:
    """max |a - b| where both are finite; inf where only one is NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return math.inf
    return max_abs(torch.where(na, 0.0, a), torch.where(nb, 0.0, b))


def k1_case(table, x01, gs) -> dict:
    """K1 alone on the corner levels of `gs` at points x01: time, call and
    plain times, bound, and the F.embedding_bag yardstick (sum with
    per-sample weights) on the precomputed corner rows and weights, as
    K10's is built.  Without cell levels the wrapper `hash_encode` launches
    K1 alone, and it is what is checked and timed; with them it would add
    K10, so the C entry is ("via": "entry")."""
    import torch.nn.functional as F

    P = x01.shape[0]
    via = "entry" if gs.cell_levels else "wrapper"

    def k1():
        if via == "wrapper":
            with torch.no_grad():
                return hash_encode(table, x01, gs)
        return k1_entry(table, x01, gs)[0]

    def plain():
        return torch.cat([corner_level_plain(table, x01, gs, level)
                          for level in gs.corner_levels], -1)

    rows, ws = [], []
    for level in gs.corner_levels:
        w, r = level_corners(x01, gs, level)
        rows.append(r.T)
        ws.append(w.T)
    rows, ws = torch.stack(rows, 1), torch.stack(ws, 1)  # [P, Lk, 8]
    Lk = len(gs.corner_levels)
    touched = int(rows.unique().numel())
    cols = [c for lv_ in gs.corner_levels for c in (2 * lv_, 2 * lv_ + 1)]
    err = max_abs(k1()[:, cols], plain())
    bag_idx, bag_w = rows.reshape(-1, 8), ws.reshape(-1, 8).contiguous()
    del rows, ws

    def lib():
        return F.embedding_bag(bag_idx, table, mode="sum",
                               per_sample_weights=bag_w)

    # bytes: x01 and the touched rows read once, [P, Lk, 2] written once;
    # ops: ~50 per (point, level) (lattice, 8 weights, 16 FMAs)
    return {"points": P, "levels": Lk, "touched_rows": touched, "err": err,
            "via": via,
            "bound": bound(P * 12 + touched * 8 + P * Lk * 8, P * Lk * 50),
            **timings(k1, plain), "library_ms": cuda_ms(lib),
            "library_abs_err": max_abs(lib().reshape(P, -1), plain())}


def k1_hard_inputs(n: int = 4099, seed: int = 0) -> dict:
    """K1's edge inputs, as numpy: name -> (x01 [n, 3], HashGridSpec
    arguments, baked); tests/test_torch_hashgrid.py holds the plain encode
    against JAX's on the same ones.  n is not a multiple of any block or
    tile.  "edges": points on the cube's faces and corners, on lattice
    planes of every level (pos an integer: fractions 0 and 1), at 1 -
    2^-24, just outside [0, 1] (-2^-24, 1 + 2^-23 and farther) and NaN
    (which passes the outside test, as in JAX, and makes its row NaN);
    "rays": ray-major runs of 8-64 samples; "one_cell": a ray-ordered
    stream of slow rays whose points all fall in one level-0 cell; "cell":
    the cell teacher's list (levels 5-13 cell-packed: K1 on slots 0-4);
    "baked": the list a baked encode leaves to K1 (slots 5-13);
    "baked_cell": the baked cell teacher's, which is empty (K1 does not
    run); "odd_levels": a 13-level grid; "levels20": a 20-level grid (more
    levels than a K1 block holds: a second block takes the rest);
    "small": the test grid (4 levels, 2^14 rows, level 0 dense) and
    "one_level" a 1-level grid, both on K1's thread per (point, level), as
    is "edges_cell": the edge points on the cell teacher's 5 levels."""
    rng = np.random.default_rng(seed)
    spec = HashGridSpec()
    edges = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    q = n // 8
    edges[:q, 0], edges[q:2 * q, 1], edges[2 * q:3 * q, 2] = 0.0, 1.0, 1.0
    edges[3 * q:4 * q] = rng.choice([0.0, 1.0], (q, 3))
    # on a lattice plane of a random level along a random axis
    for i in range(4 * q, 6 * q):
        lv = int(rng.integers(0, spec.num_levels))
        s = spec.level_scale(lv)
        j = int(rng.integers(1, int(s)))
        edges[i, int(rng.integers(0, 3))] = np.float32((j - 0.5) / s)
    e = np.float32(1.0 - 2.0 ** -24)
    edges[6 * q:6 * q + 16] = [
        [e, e, e], [e, 0.5, 0.0], [0.0, e, 1.0], [1.0, 1.0, e],
        [-2.0 ** -24, 0.5, 0.5], [0.5, 1.0 + 2.0 ** -23, 0.5],
        [0.5, 0.5, -1e-3], [1.5, 0.25, 0.75], [-3.0, -3.0, -3.0],
        [0.25, 2.0, 0.5], [np.nan, 0.5, 0.5], [0.5, np.nan, np.nan],
        [np.nan, np.nan, np.nan], [np.nan, -1.0, 0.5], [0.0, 0.0, 0.0],
        [1.0, 1.0, 1.0]]
    # slow rays: consecutive points 1/64 of a march step apart, every one
    # inside level 0's cell [7, 8)^3 (pos = x * 15 + 0.5)
    slow = np.empty((n, 3))
    start = 0
    while start < n:
        k = min(n - start, int(rng.integers(48, 65)))
        d = rng.normal(size=3)
        p0 = rng.uniform(6.75 / 15.0, 6.85 / 15.0, 3)
        slow[start:start + k] = p0 + np.arange(k)[:, None] \
            * (np.sqrt(3.0) / 1024.0 / 64.0) * d / np.linalg.norm(d)
        start += k
    return {"edges": (edges, {}, False),
            "rays": (march_runs(rng, n), {}, False),
            "one_cell": (slow.astype(np.float32), {}, False),
            "cell": (march_runs(rng, n), {"n_cell_levels": 9}, False),
            "baked": (march_runs(rng, n), {}, True),
            "baked_cell": (march_runs(rng, n), {"n_cell_levels": 9}, True),
            "odd_levels": (march_runs(rng, n), {"num_levels": 13}, False),
            "levels20": (march_runs(rng, n), {"num_levels": 20}, False),
            "small": (march_runs(rng, n), {"num_levels": 4,
                                           "log2_hashmap_size": 14,
                                           "desired_resolution": 128},
                      False),
            "one_level": (march_runs(rng, n), {"num_levels": 1}, False),
            "edges_cell": (edges, {"n_cell_levels": 9}, False)}


def check_k1_hard_cases(dev) -> dict:
    """K1 (its C entry, so the cell and baked level lists run alone) on
    k1_hard_inputs with a random O(1) table, against the plain corner
    levels; a NaN point must give NaN where the plain version does.  The
    baked lists also go through the whole wrapper (K15 + K1, or K15 + K10
    with no K1) against hash_encode_plain.  Each case's max abs error;
    the caller holds them to TOL_K1 with K1's row, at the end, so a
    failing case does not cut the run's other measurements."""
    out = {}
    gen = torch.Generator(device=dev).manual_seed(1)
    for name, (x, kw, baked) in k1_hard_inputs().items():
        gs = HashGridSpec(**kw)
        x01 = torch.from_numpy(x).to(dev)
        table = torch.rand(gs.table_size, 2, generator=gen,
                           device=dev) * 2 - 1
        k, levels = k1_entry(table, x01, gs, baked)
        want = (gs.unbaked_levels if baked else gs.corner_levels)
        if levels != want:
            raise RuntimeError(f"K1 {name}: level list {levels} != {want}")
        err = 0.0
        for level in levels:
            err = max(err, nan_abs(k[:, 2 * level:2 * level + 2],
                                   corner_level_plain(table, x01, gs,
                                                      level)))
        if baked:
            cell = (torch.rand(gs.cell_table_size, 16, generator=gen,
                               device=dev) * 2 - 1
                    if gs.cell_levels else None)
            bk = build_baked_dense(table, gs)
            before = hash_encode.launches
            with torch.no_grad():
                full = hash_encode(table, x01, gs, cell, bk)
            if x01.is_cuda and (hash_encode.launches > before) != bool(
                    levels):
                raise RuntimeError(f"K1 {name}: launched with levels "
                                   f"{levels}")
            full_p = hash_encode_plain(table, x01, gs, cell, bk)
            err = max(err, nan_abs(full, full_p))
        out[name] = {"points": x.shape[0], "levels": levels, "err": err}
        log(f"K1 {name} ({x.shape[0]} points, levels {levels}): max abs "
            f"err {err:.3g}" + ("" if err <= TOL_K1 else " FAILS"))
    return out


def log_k1(label: str, c: dict):
    log(f"K1 {label}: {c['points']} points x {c['levels']} levels, "
        f"{c['touched_rows']} rows touched: max abs err {c['err']:.3g}, "
        f"{c['ms']:.4f} ms{alone(c)} (call of the {c['via']} "
        f"{c['call_ms']:.4f}, plain "
        f"{c['plain_ms']:.4f}, embedding_bag {c['library_ms']:.4f}, bound "
        f"{c['bound'][0]:.4f} {c['bound'][1]})")
    if not c["err"] <= TOL_K1:
        raise RuntimeError(f"K1 disagrees with its plain version ({label})")


def k3_case(args, n_rays: int, early_stop: bool) -> dict:
    """K3 on one stream (sigmas, rgbs, delta_t, t_cum, ray_id, valid)
    against its plain version (raises above TOL_K3), with times, bound and
    lanes per ray."""
    def kernel():
        return composite_rays_compact_fwd(*args, n_rays, early_stop)

    def plain():
        return composite_rays_compact_plain(*args, n_rays, early_stop)

    err = max(max_abs(a, b) for a, b in zip(kernel()[:4], plain()))
    if not err <= TOL_K3:
        raise RuntimeError(f"K3 disagrees with its plain version: {err:.3g}")
    M = args[0].shape[0]
    return {"slots": M, "rays": n_rays, "valid": int(args[5].sum()),
            "lanes": k3_lanes(M, n_rays), "early_stop": early_stop,
            "err": err, "bound": bound(M * 33 + M * 4 + n_rays * 20, M * 16),
            **timings(kernel, plain)}


def log_k3(label: str, c: dict):
    log(f"K3 {label}: {c['slots']} slots ({c['valid']} valid), {c['rays']} "
        f"rays, {c['lanes']} lanes per ray, early stop {c['early_stop']}: "
        f"max abs err {c['err']:.3g}, {c['ms']:.4f} ms{alone(c)} (call "
        f"{c['call_ms']:.4f}, plain {c['plain_ms']:.4f}, bound "
        f"{c['bound'][0]:.5f} {c['bound'][1]})")


def check_large_scene_kernels(tea, scene, gen) -> tuple:
    """K14 on a test view's chunk of 4096 rays in eval mode (1024 slots)
    and on a training batch of 4096 rays in train mode (64 slots, perturbed
    start), on the trained teacher's two-cascade grid; K12 and K13 on
    those 4096 rays' polar points and on the 262,144 of a 512x512 view,
    with the trained teacher's background table."""
    dev = tea.device
    occ = tea.state.occ
    bits = occ.bitfield
    test = scene["test"]
    intr = tuple(float(v) for v in test.intrinsics)
    rs_eval = dataclasses.replace(tea.rspec, max_samples=tea.rspec.max_steps)
    pose = torch.as_tensor(test.poses[0], device=dev)
    head = (test.H * test.W // 2) // CHUNK * CHUNK
    o, d = chunk_rays(pose, intr, test.H, test.W,
                      max(0, min(head, test.H * test.W - CHUNK)), CHUNK)
    o, d = o.contiguous(), d.contiguous()
    nears, fars = near_far_from_aabb(o, d, occ.aabb_infer,
                                     rs_eval.min_near)
    ev = march_case(bits, o, d, nears, fars, rs_eval)
    rs_train = dataclasses.replace(tea.rspec,
                                   max_samples=tea.cfg.max_samples,
                                   samples_per_ray=0.0)
    o_t, d_t, n_t, f_t, u = teacher_rays(tea, scene, gen, rs_train)
    tr = march_case(bits, o_t, d_t, n_t, f_t, rs_train, u)
    for name, c in (("eval", ev), ("train", tr)):
        log_march("K14", name, c)
    # K8/K9 on a padded warm-up batch of the trained field; K10/K11 on a
    # compacted batch
    b = tea.rspec.bound
    o_p, d_p, s_p = teacher_batch(tea, scene, gen, rs_train)
    xyz_p = fma32(s_p.t[..., None], d_p[:, None, :],
                  o_p[:, None, :]).clamp(-b, b)
    k8, k9 = k8_k9_case(tea.state.field, xyz_p, d_p, s_p,
                        rs_train.density_scale, gen)
    log_k8_k9("large-scene teacher, padded", k8, k9)
    del xyz_p
    o_c, d_c, s_c = teacher_batch(tea, scene, gen, tea.rspec)
    cmp = compact_samples(s_c.mask, tea.rspec.sample_budget(
        tea.cfg.num_rays), prefix=True)
    xyz_c = fma32(s_c.t.reshape(-1)[cmp.idx][:, None], d_c[cmp.ray_id],
                  o_c[cmp.ray_id]).clamp(-b, b)
    cell = cell_case(tea, ((xyz_c + b) / (2.0 * b)).contiguous(), cmp.valid,
                     gen)
    log_cell_case("large-scene teacher, compacted", cell)
    table = tea.state.field.bg.encoder.detach()
    side = 512
    big_intr = tuple(v * side / test.H for v in intr)
    o_b, d_b = chunk_rays(pose, big_intr, side, side, 0, side * side)
    cases = {"4096": k12_k13_case(table, polar01_from_ray(
        o_t, d_t, tea.spec.bg_radius).contiguous(), gen),
        "262144": k12_k13_case(table, polar01_from_ray(
            o_b, d_b, tea.spec.bg_radius).contiguous(), gen)}
    hard13 = check_k13_hard_cases(dev)
    gs = bg_grid_spec()
    hard12 = check_hard_counts(
        "K12", lambda x: hash_encode_fwd(table, x, gs),
        lambda x: hash_encode_plain(table, x, gs), 2, TOL_K12_REL, dev)
    for name, c in cases.items():
        log(f"K13 at {name} points: {-(-c['points'] // 128)} blocks of "
            f"128 threads, no shared-memory privatisation; the zero fill "
            f"alone {c['zero13_ms']:.4f} ms")
        log(f"K12/K13 at {name} polar points ({c['touched_rows']} rows "
            f"touched): K12 rel err {c['err12']:.3g}, {c['t12']['ms']:.4f} "
            f"ms{alone(c['t12'])} (call {c['t12']['call_ms']:.4f}, plain "
            f"{c['t12']['plain_ms']:.4f}, grid_sample on the dense levels "
            f"{c['lib12_ms']:.4f}, bound {c['bound12'][0]:.5f} "
            f"{c['bound12'][1]}, copy_ of the output bytes "
            f"{c['floor12_ms']:.4f}); K13 rel err {c['err13']:.3g}, "
            f"{c['t13']['ms']:.4f} ms{alone(c['t13'])} (call "
            f"{c['t13']['call_ms']:.4f}, "
            f"plain {c['t13']['plain_ms']:.4f}, index_add_ "
            f"{c['lib13_ms']:.4f}, bound {c['bound13'][0]:.5f} "
            f"{c['bound13'][1]})")
        if not (c["err12"] <= TOL_K12_REL and c["err13"] <= TOL_K13_REL):
            raise RuntimeError(f"K12/K13 disagree with their plain versions "
                               f"at {name} points")
    c = cases["4096"]
    results = [
        dict(name="march_rays_geom", source="pvd_tpu_torch/csrc/march.cu",
             replaces="pvd_tpu/render/renderer.py:643", err=ev["dd_err"],
             tol=TOL_K14_DD, ms=ev["ms"], kernel_ms=ev["kernel_ms"],
             call_ms=ev["call_ms"],
             plain_ms=ev["plain_ms"], bound=ev["bound"], library_ms=None,
             library_call="no single call",
             shape=f"N={CHUNK} rays x L={rs_eval.max_steps} eval slots, two "
             "cascades (t/dt/mask/t0 bit-exact)"),
        dict(name="hash_encode_2d_fwd",
             source="pvd_tpu_torch/csrc/hash_encode.cu",
             replaces="pvd_tpu/ops/hashgrid.py:533",
             err=max([c["err12"], *hard12.values()]),
             abs_err=c["abs12"], tol=TOL_K12_REL,
             err_kind="max |kernel - plain| / max |plain|", **c["t12"],
             library_ms=c["lib12_ms"],
             library_call="F.grid_sample on the 3 dense levels only (the "
             "hashed level 3 has no library call)", bound=c["bound12"],
             shape=f"{c['points']} polar points x 4 levels"),
        dict(name="hash_encode_2d_bwd",
             source="pvd_tpu_torch/csrc/hash_encode.cu",
             replaces="pvd_tpu/ops/hashgrid.py:284", err=c["err13"],
             abs_err=c["abs13"], tol=TOL_K13_REL,
             err_kind="max |kernel - plain| / max |plain|", **c["t13"],
             library_ms=c["lib13_ms"],
             library_call="index_add_ of the precomputed corner "
             "contributions (scatter only)", bound=c["bound13"],
             shape=f"{c['points']} polar points x 4 levels")]
    results[0]["shapes"] = {"eval_chunk": ev, "train_batch": tr,
                            "hard_inputs": check_k14_hard_cases(dev)}
    extra = {"k12_k13": cases, "k13_hard": hard13, "k12_hard": hard12,
             "k8_padded": k8, "k9_padded": k9, "cell_compacted": cell}
    return results, extra


def png_read_times(img: np.ndarray) -> dict:
    """Seconds `read_png` takes for `img` [H, W, C] uint8 written with
    each scanline filter on every row (None, Sub, Up, Average, Paeth; the
    last two take the anti-diagonal passes), and `write_png`'s seconds;
    every file must read back exactly."""
    H, W, C = img.shape
    x = img.astype(np.int32)
    a, b, c = (np.zeros_like(x) for _ in range(3))
    a[:, 1:], b[1:], c[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = {"none": 0, "sub": a, "up": b, "average": (a + b) >> 1,
             "paeth": paeth}

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "img.png")
        t0 = time.perf_counter()
        write_png(path, img)
        out["write_png_s"] = time.perf_counter() - t0
        for ftype, (name, pred) in enumerate(preds.items()):
            rows = ((x - pred) & 0xFF).astype(np.uint8).reshape(H, W * C)
            raw = np.concatenate([np.full((H, 1), ftype, np.uint8), rows], 1)
            with open(path, "wb") as f:
                f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
                    ">IIBBBBB", W, H, 8, {3: 2, 4: 6}[C], 0, 0, 0))
                    + chunk(b"IDAT", zlib.compress(raw.tobytes()))
                    + chunk(b"IEND", b""))
            t0 = time.perf_counter()
            back = read_png(path)
            out[f"read_png_{name}_s"] = time.perf_counter() - t0
            if not np.array_equal(back, img):
                raise RuntimeError(f"read_png: filter {name} read back wrong")
    return out


def render_large_scene(tea, scene) -> dict:
    """One 800x800 view of the trained large-scene teacher through
    make_eval_renderer: K14 in eval mode and K12 once per chunk."""
    test = scene["test"]
    res = LS_RENDER_RES
    intr = tuple(float(v) * res / test.H for v in test.intrinsics)
    render = make_eval_renderer(tea.spec, tea.rspec, chunk=CHUNK,
                                device=tea.device)
    render(tea.state.field, tea.state.occ, test.poses[0], intr, 64, 64)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    out = render(tea.state.field, tea.state.occ, test.poses[0], intr, res,
                 res)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launched = {k: v for k, v in counters().items() if v}
    n_chunks = -(-res * res // CHUNK)
    finite = bool(torch.isfinite(out.image).all()
                  and torch.isfinite(out.depth).all())
    hit = float((out.weights_sum > 0.01).float().mean())
    log(f"large-scene render {res}x{res}: {ms:.1f} ms, rungs {out.rungs}, "
        f"truncated chunks {out.truncated_chunks}, samples/ray "
        f"{out.samples / res ** 2:.3f}, finite {finite}, rays with "
        f"weights_sum>0.01 {hit:.4f}; launches {json.dumps(launched)}")
    if not (finite and out.image.shape == (res, res, 3) and hit > 0):
        raise RuntimeError("large-scene render: bad image")
    for name in ("march_rays_geom", "hash_encode_2d_fwd"):
        if launched.get(name, 0) < n_chunks:
            raise RuntimeError(f"large-scene render: {name} launched "
                               f"{launched.get(name, 0)} times for "
                               f"{n_chunks} chunks")
    u8 = (out.image.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
    png = png_read_times(u8)
    log(f"PNG codec on this {res}x{res} render (host): "
        + ", ".join(f"{k} {v:.4f}" for k, v in png.items()))
    return {"ms": ms, "rungs": out.rungs, "launches": launched,
            "samples_per_ray": out.samples / res ** 2, "hit_frac": hit,
            "png": png}


# `--host-ab DIR`: the A/B recipe's teacher alone (3000 steps, as phase
# 6 trains it), in a fresh process per run with the package imported from
# the checkout it runs in; then 512 more steps (256 padded, 256 compacted)
# of a fresh Trainer under cProfile for the host's Python work per step
HOST_AB_PROFILE_STEPS, HOST_AB_REPS = 512, 3
# ---- phase 15: scan steps --------------------------------------------------

def profile_brief(prof: dict) -> dict:
    return {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                 "device_busy_share", "ours")}


def scan_teacher_cli(seed: int, workspace: str, scene: str, flags: dict,
                     extra: tuple, label: str, ab: dict) -> dict:
    """The teacher CLI with `extra` (--scan_steps among them) on the A/B
    scene; every chunk that the schedule allows must have run as one
    K-step call (`chunk_steps`), and the A/B teacher's floor holds."""
    argv = [scene, "--workspace", os.path.join(workspace, label),
            "--seed", str(seed)] + cli_flags(flags) + list(extra)
    run = run_teacher_cli(argv, label, TEACHER_KERNELS + (
        "hash_encode_cell_fwd", "hash_encode_cell_bwd"))
    st = run["stats"]
    pt, pa = st["psnr"], ab["teacher"]["psnr"]
    log(f"{label}: {st['chunk_steps']} of {st['train_steps']} steps in "
        f"{SCAN_K}-step calls; test PSNR {pt:.3f} dB (the single-step A/B "
        f"teacher {pa:.3f}); ms per step padded "
        f"{st['padded_ms_per_step']:.3f}, compacted "
        f"{st['compacted_ms_per_step']:.3f} (single steps, host batcher: "
        f"{ab['teacher_train_stats']['padded_ms_per_step']:.3f} / "
        f"{ab['teacher_train_stats']['compacted_ms_per_step']:.3f})")
    if st["chunk_steps"] < st["train_steps"] // 2:
        raise RuntimeError(f"{label}: only {st['chunk_steps']} steps ran "
                           "in K-step calls")
    if not (np.isfinite(pt) and pt >= AB_TEACHER_FLOOR):
        raise RuntimeError(f"{label}: {pt:.3f} dB < {AB_TEACHER_FLOOR}")
    return run


def chunk_vs_singles(run: dict, name: str) -> dict:
    """One K-step call against K single calls on the card, from the same
    state (the run's last checkpoint, reloaded) and the same draws (one
    generator seed), on the preloaded images (compacted, the cell-mode
    teacher).  K7 and K11 add their table gradients with float atomics,
    so two runs of the same single steps differ in the last bits too:
    both spreads are logged and the chunk's per-step losses and metrics
    must lie within CHUNK_RTOL of the singles'.  Then the time: each side
    on a Trainer of its own, both warmed up alike (CHUNK_WARMUP calls),
    then CHUNK_ROUNDS rounds of one chunk and K single calls in turns (the
    order swapped every round), host-clock ms per step as the median and
    range of each side; the difference is resolved only where the ranges
    do not overlap.  Last a profile of each for the device busy time."""
    cfg = run["cfg"]
    ds = NeRFDataset(cfg, "train")
    dev = torch.device("cuda")
    images = torch.as_tensor(ds.images_flat(), device=dev)
    poses = torch.as_tensor(ds.poses, device=dev)
    idxs = np.random.default_rng(0).integers(0, len(ds), SCAN_K)
    path = ckpt.latest_checkpoint(os.path.join(run["workspace"],
                                               "checkpoints"), name)

    def fresh(k: int):
        tr = Trainer(cfg)
        tr.load_student(path)
        step = make_teacher_step(tr.spec, tr.rspec, tr.opt, cfg,
                                 ds.intrinsics, ds.H, ds.W,
                                 ds.images.shape[-1], scan_steps=k)
        return tr, step

    def singles(tr, step, gen):
        logs = []
        for j, i in enumerate(idxs):
            tr.state, m = step(tr.state, poses[i], images[i], gen)
            logs.append(m)
        return {k: torch.stack([m[k] for m in logs]) for k in logs[0]}

    def chunk(tr, step, gen):
        tr.state, logs = step(tr.state, images, idxs, poses[idxs], gen)
        return logs

    outs = []
    for fn, k in ((singles, 0), (singles, 0), (chunk, SCAN_K)):
        tr, step = fresh(k)
        gen = torch.Generator(device=dev).manual_seed(5)
        outs.append({kk: v.cpu().numpy() for kk, v in
                     fn(tr, step, gen).items()})

    def spread(a, b):
        return max(float(np.max(np.abs(a[k] - b[k]) / np.maximum(
            np.abs(b[k]), 1e-12))) for k in b)

    runs_err, chunk_err = spread(outs[1], outs[0]), spread(outs[2], outs[0])
    # where the time goes: one chunk against K single calls
    sides = {"singles": (singles,) + fresh(0),
             "chunk": (chunk,) + fresh(SCAN_K)}
    gen = torch.Generator(device=dev).manual_seed(6)

    def call(side):
        fn, tr, step = sides[side]
        fn(tr, step, gen)

    for _ in range(CHUNK_WARMUP):
        for side in sides:
            call(side)
    ms = {side: [] for side in sides}
    for r in range(CHUNK_ROUNDS):
        for side in (list(sides) if r % 2 == 0 else list(sides)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(side)
            torch.cuda.synchronize()
            ms[side].append((time.perf_counter() - t0) * 1e3 / SCAN_K)
    prof = {side: profile(lambda side=side: call(side)) for side in sides}
    rep = {side: {"ms_per_step": ms[side],
                  "median_ms": float(np.median(ms[side])),
                  "min_ms": min(ms[side]), "max_ms": max(ms[side]),
                  **profile_brief(prof[side])} for side in sides}
    a, b = rep["singles"], rep["chunk"]
    resolved = a["max_ms"] < b["min_ms"] or b["max_ms"] < a["min_ms"]

    def line(side):
        x = rep[side]
        return (f"{side} median {x['median_ms']:.3f} (range "
                f"{x['min_ms']:.3f}-{x['max_ms']:.3f}; busy "
                f"{x['device_busy_ms'] / SCAN_K:.3f}, share "
                f"{x['device_busy_share']:.3f})")

    log(f"{SCAN_K}-step chunk vs {SCAN_K} single steps on the card (cell "
        f"teacher, compacted, {cfg.num_rays} rays): max rel diff of the "
        f"per-step losses and metrics {chunk_err:.3g} (two runs of the "
        f"singles: {runs_err:.3g}; tol {CHUNK_RTOL:g}); ms per step over "
        f"{CHUNK_ROUNDS} rounds: {line('singles')}, {line('chunk')}; "
        f"difference {'resolved' if resolved else 'unresolved'}")
    if not chunk_err <= CHUNK_RTOL:
        raise RuntimeError(f"the {SCAN_K}-step chunk differs from its "
                           f"single steps by {chunk_err:.3g}")
    return {"chunk_rel_err": chunk_err, "singles_rel_err": runs_err,
            "singles": rep["singles"], "chunk": rep["chunk"],
            "resolved": resolved, "k": SCAN_K}


def drive_scan(seed: int, workspace: str, scene: str, ab: dict) -> dict:
    """Phase 15: the A/B teacher through the teacher CLI with --preload
    --scan_steps 8 (the A/B floor, and within 1.0 dB of the single-step
    A/B teacher), then one chunk against its single steps on the card."""
    pre = scan_teacher_cli(seed, workspace, scene, AB_TEACHER,
                           ("--preload",) + SCAN_FLAGS, "hash_scan", ab)
    pt = pre["stats"]["psnr"]
    if pt < ab["teacher"]["psnr"] - AB_MAX_DROP:
        raise RuntimeError(f"the scan teacher {pt:.3f} dB is more than "
                           f"{AB_MAX_DROP} dB under the single-step one")
    st = pre["stats"]
    return {"teacher": {
        "psnr": pt, "test_reload_psnr": pre["test_psnr"],
        "train_s": pre["train_s"], "host_batcher": st["host_batcher"],
        "train_stats": {k: v for k, v in st.items() if k.startswith((
            "train_", "padded", "compacted", "occ_", "chunk"))},
        "launches": pre["launches"]}, "chunk": chunk_vs_singles(pre, "hash")}


# ---- phase 16: data parallel over the ray axis ----------------------------

def dp_small_inputs() -> dict:
    """Fixed inputs of the small DP checks (numpy): a teacher step (the
    padded path) and an rgb-only stage-3 distill step (padded), SMALL_*
    sizes with f32 heads, the rays split over the ranks in order."""
    rng = np.random.default_rng(13)
    spec_tea, spec_stu = ModelSpec(**SMALL_TEA), ModelSpec(**SMALL_STU)
    n = SMALL_CFG["num_rays"]
    image = rng.uniform(size=(SMALL_HW ** 2, 4)).astype(np.float32)
    image[:, 3] = rng.choice([0.0, 1.0, 0.3], size=SMALL_HW ** 2)
    return {"tea": random_hash_params(spec_tea, rng),
            "stu": random_vm_params(spec_stu, rng),
            "bits": rng.uniform(size=32 ** 3) < 0.25, "image": image,
            "pose": nerf_matrix_to_ngp(pose_spherical(30.0, -30.0, 4.0),
                                       scale=0.8).astype(np.float32),
            "inds": rng.integers(0, SMALL_HW ** 2, n),
            "bg": rng.uniform(size=(n, 3)).astype(np.float32),
            "u": rng.uniform(size=n).astype(np.float32)}


def dp_small_steps(inp: dict, group=None, kinds=("teacher", "distill"),
                   dev: str = "cuda") -> dict:
    """The small steps on `inp`: single-process on every ray, or, with a
    group, `make_teacher_step` / `make_distill_step` over it on this
    rank's slice.  Returns {kind: (logs, grads, params)} (numpy)."""
    out = {}
    n = len(inp["inds"])
    sl = slice(None) if group is None else group.ray_slice(n)
    t = {k: torch.as_tensor(inp[k]).to(dev) for k in (
        "image", "pose", "inds", "bg", "u")}
    draws = (t["inds"][sl], t["bg"][sl], t["u"][sl])
    for kind in kinds:
        cfg = PVDConfig(**dict(SMALL_CFG, samples_per_ray=0.0),
                        **(DP_RGB_ONLY if kind == "distill" else {}))
        rspec = cfg.render_spec()
        spec_tea = ModelSpec(**SMALL_TEA)
        occ = set_bitfield(init_occupancy_state(rspec, dev),
                           torch.as_tensor(inp["bits"]).to(dev))
        if kind == "teacher":
            field = hash_field_from_jax(inp["tea"], spec_tea, dev)
            spec = spec_tea
            sched = exp_decay_schedule
        else:
            teacher = hash_field_from_jax(inp["tea"], spec_tea, dev)
            spec = ModelSpec(**SMALL_STU)
            field = vm_field_from_jax(inp["stu"], spec, dev)
            sched = cosine_schedule
        params = dict(field.named_parameters())
        opt = build_optimizer(params, param_group_label(spec),
                              trainable_label(spec, ""), sched(1e-2, 100),
                              sched(1e-3, 100))
        state = TrainState(field=field, opt_state=opt.init(params), occ=occ)
        if kind == "teacher":
            args = (spec, rspec, opt, cfg)
            step = make_teacher_step(*args, SMALL_INTR, SMALL_HW, SMALL_HW,
                                     4, device=dev, group=group)
            state, logs = step.with_rays(state, t["pose"], t["image"],
                                         *draws)
            tree = hash_tree_from_field
        else:
            args = (spec, spec_tea, rspec, opt, cfg)
            step = make_distill_step(*args, SMALL_INTR, SMALL_HW, SMALL_HW,
                                     3, device=dev, group=group)
            state, logs = step.with_rays(state, teacher, occ, t["pose"],
                                         *draws)
            tree = vm_tree_from_field
        out[kind] = ({k: float(v) for k, v in logs.items()},
                     tree(field, grad=True), tree(field))
    return out


def dp_ab_step(job: dict, group=None, padded: bool = False,
               shard: int = 0, shards: int = 1) -> dict:
    """One rgb-only stage-3 distill step at the A/B shapes: the A/B
    student (VM 300^3, f32 heads, the Trainer's seeded init) warm-started
    from the A/B teacher, 4096 fixed draws (numpy, DP_AB_SEED), either
    `padded` (all 64 slots a ray: no ray is cut) or compacted at the A/B's
    6 samples a ray (a budget of 6 x the call's rays, so a batch with
    more valid samples loses its tail).  Over `group` on this rank's
    slice; single-process on every ray, or on slice `shard` of `shards`
    (a rank's rays and budget).  Returns {"distill": (logs, grads,
    params)} (numpy)."""
    dev = torch.device("cuda")
    tag = "" if group is None else f"_{group.backend}{group.rank}"
    cfg = PVDConfig(**dict(AB_DISTILL, **DP_RGB_ONLY, precision="fp32",
                           **({"samples_per_ray": 0.0} if padded else {})),
                    path=job["scene"], seed=job["seed"],
                    workspace=os.path.join(job["workspace"], "dp_ab" + tag))
    tr = Trainer(cfg, mode="distill", device="cuda:0")
    tr.load_teacher(job["best"])
    ds = NeRFDataset(cfg, "train")
    n = cfg.num_rays
    rng = np.random.default_rng(DP_AB_SEED)
    draws = [torch.as_tensor(a, device=dev) for a in (
        rng.integers(0, ds.H * ds.W, n),
        rng.uniform(size=(n, 3)).astype(np.float32),
        rng.uniform(size=n).astype(np.float32))]
    k = n // shards
    sl = (slice(shard * k, (shard + 1) * k) if group is None
          else group.ray_slice(n))
    step = make_distill_step(tr.spec_stu, tr.spec_tea, tr.rspec, tr.opt,
                             tr.cfg, ds.intrinsics, ds.H, ds.W, 3,
                             group=group)
    tr.state, logs = step.with_rays(tr.state, tr.teacher, tr.occ_tea,
                                    ds.poses[0], *(d[sl] for d in draws))
    field = tr.state.field
    return {"distill": ({k: float(v) for k, v in logs.items()},
                        vm_tree_from_field(field, grad=True),
                        vm_tree_from_field(field))}


def dp_ab_shard_mean(job: dict, world: int) -> tuple:
    """What the compacted A/B step over `world` ranks computes, from
    single-process steps: each rank's slice at its own budget (as JAX's
    shard_map runs it), logs and gradients averaged over the slices
    (compare_steps' tree of params is the ranks' own: the slices' steps
    update no common params).  Returns ((logs, grads), the slices'
    compact_frac)."""
    outs = [dp_ab_step(job, shard=r, shards=world)["distill"]
            for r in range(world)]
    logs = {k: float(np.mean([o[0][k] for o in outs])) for k in outs[0][0]}
    grads = tree_mean([o[1] for o in outs])
    return (logs, grads), [o[0]["compact_frac"] for o in outs]


def tree_mean(trees: list):
    """The leafwise mean of nested dicts / lists of numpy arrays."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_mean([t[k] for t in trees]) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_mean([t[i] for t in trees])
                        for i in range(len(t0)))
    return np.mean(np.stack(trees), axis=0)


def dp_field(best: str, dev):
    """The A/B teacher of `best` with f32 heads, its grid, spec and
    render spec (the DP sweep and eval image)."""
    cfg = PVDConfig(**AB_TEACHER, precision="fp32")
    spec, rspec = cfg.model_spec(), cfg.render_spec()
    payload = ckpt.load_checkpoint(best, dev)
    return field_from_tree(payload["params"], spec, dev), payload["occ"], \
        spec, rspec


def dp_sweep_and_image(best: str, group=None) -> dict:
    """A full occupancy sweep (jitter from a generator seeded 0) and one
    800x800 eval image of the A/B teacher, single-process or over the
    group; grid, bitfield and image as numpy."""
    dev = torch.device("cuda")
    field, occ, spec, rspec = dp_field(best, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    H, C = rspec.grid_size, rspec.cascades
    jitter = torch.rand((C, H ** 3, 3), generator=gen, device=dev)
    if group is None:
        upd = make_occ_update(spec, rspec)
        render = make_eval_renderer(spec, rspec, chunk=CHUNK)
    else:
        upd = make_dp_occ_update(spec, rspec, group)
        render = make_dp_eval_renderer(spec, rspec, group, chunk=CHUNK)
    new = upd(occ, field, full=True, jitter=jitter)
    focal = 0.5 * RES / math.tan(0.5 * 0.6911112070083618)
    pose = nerf_matrix_to_ngp(pose_spherical(30.0, -30.0, 4.0), scale=0.8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = render(field, occ, pose, (focal, focal, RES / 2.0, RES / 2.0), RES,
                 RES)
    torch.cuda.synchronize()
    return {"grid": new.density_grid.cpu().numpy(),
            "bits": new.bitfield.cpu().numpy(),
            "image": out.image.cpu().numpy(), "rungs": out.rungs,
            "samples": out.samples, "render_ms":
            (time.perf_counter() - t0) * 1e3}


def dp_recipe(job: dict, group=None) -> dict:
    """DP_DISTILL (the A/B student, cut in steps) through the Trainer from
    the A/B teacher, over `group` (n_devices = its world) or on one process; test
    PSNR, train_stats and the launches of the training run."""
    n_dev = 1 if group is None else group.world
    cfg = PVDConfig(**DP_DISTILL, path=job["scene"], seed=job["seed"],
                    n_devices=n_dev, workspace=os.path.join(
                        job["workspace"], f"dp{n_dev}"))
    tr = Trainer(cfg, mode="distill", device="cuda:0")
    tr.load_teacher(job["best"])
    reset_counters()
    tr.train(NeRFDataset(cfg, "train"))
    torch.cuda.synchronize()
    launches = counters()
    stats = tr.evaluate(NeRFDataset(cfg, "test"))
    return {"psnr": stats["psnr"], "launches": launches,
            "num_rays": tr.cfg.num_rays, "train_stats": tr.train_stats}


def allreduce_ms(group, n_floats: int, reps: int = 5) -> float:
    """Host-clock ms of one mean over the group of n_floats floats on the
    card (a data-parallel step's gradient collective)."""
    buf = [torch.ones(n_floats, device="cuda")]
    group.mean_(buf)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        group.mean_(buf)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _dp_rank(rank: int, world: int, backend: str, rendezvous: str,
             job_file: str, out_file: str):
    """One rank of phase 16 (a spawned process): join the group on card
    0, run the job's checks, write the results."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = init_ray_group("cuda:0", backend=backend,
                           init_method="file://" + rendezvous, rank=rank,
                           world_size=world, timeout_s=DP_TIMEOUT_S)
    job = torch.load(job_file, weights_only=False)
    res = {"rank": group.rank, "world": group.world,
           "backend": group.backend,
           "small": dp_small_steps(job["small"], group,
                                   kinds=job["kinds"])}
    res["ab"] = {"padded": dp_ab_step(job, group, padded=True),
                 "compacted": dp_ab_step(job, group)}
    if backend == "gloo":
        res["field"] = dp_sweep_and_image(job["best"], group)
        res["recipe"] = dp_recipe(job, group)
    res["allreduce_ms"] = allreduce_ms(group, job["allreduce_floats"])
    torch.save(res, out_file)
    torch.distributed.destroy_process_group()


def run_ranks(world: int, backend: str, job: dict, tmp: str) -> list:
    """Start `world` ranks of `_dp_rank` (spawn) sharing the card, join
    them within DP_TIMEOUT_S, and return their results in rank order;
    a rank that fails or outlasts the limit fails the phase."""
    job_file = os.path.join(tmp, f"{backend}_job.pt")
    torch.save(job, job_file)
    ctx = torch.multiprocessing.get_context("spawn")
    outs = [os.path.join(tmp, f"{backend}_rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=_dp_rank, args=(
        r, world, backend, os.path.join(tmp, f"{backend}_rendezvous"),
        job_file, outs[r])) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + DP_TIMEOUT_S
    for p in procs:
        p.join(max(1.0, deadline - time.perf_counter()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(30)
    codes = [p.exitcode for p in procs]
    if alive or codes != [0] * world:
        raise RuntimeError(f"{backend} ranks exited {codes}")
    return [torch.load(f, weights_only=False) for f in outs]


def dp_compare_small(got: dict, want: dict, label: str,
                     sizes: str = "test sizes, padded") -> dict:
    """compare_steps of each DP step against the single-process one; the
    distill's point losses and PSNR (per-shard means, as in JAX) left out
    of the log comparison."""
    report = {}
    for kind in want:
        lg, gg, pg = got[kind]
        lw, gw, pw = want[kind]
        keep = [k for k in lw if k not in DP_SHARD_LOGS or kind == "teacher"]
        c = compare_steps(({k: lg[k] for k in keep}, gg, pg),
                          ({k: lw[k] for k in keep}, gw, pw))
        log(f"{label} {kind} step vs single-process ({sizes}, f32 heads): "
            f"max rel loss/log diff {c['loss_rel_err']:.3g}; "
            f"max grad diff / leaf max {c['grad_err_rel_leaf_max']:.3g} "
            f"({c['grad_err_leaf']}); max param diff under the gradient "
            f"mask {c['param_err']:.3g}")
        if not c.pop("ok"):
            raise RuntimeError(f"the {label} {kind} step disagrees with the "
                               "single-process step")
        report[kind] = c
    return report


def dp_compare_ab(got: dict, padded: dict, shards: tuple,
                  label: str) -> dict:
    """The A/B-shaped DP steps of one rank: the padded one against the
    single-process step on the concatenated batch; the compacted one
    against the mean of single-process steps on the ranks' slices at
    their own budgets (`dp_ab_shard_mean`), its params not held (those
    steps update no common params)."""
    (lw, gw), fracs = shards
    pg = got["compacted"]["distill"][2]
    out = {"padded": dp_compare_small(
        got["padded"], padded, label, "A/B shapes, VM 300^3, 4096 rays, "
        "padded"), "compacted": dp_compare_small(
        got["compacted"], {"distill": (lw, gw, pg)}, label,
        "A/B shapes, VM 300^3, 4096 rays, compacted, against the "
        "slices' steps"), "slices_compact_frac": fracs}
    log(f"{label}: compacted A/B step's slices fill {fracs} of their "
        "budgets (over 1: the slice's tail is cut, so the concatenated "
        "batch's step differs)")
    return out


def drive_dp(seed: int, workspace: str, scene: str, best: str) -> dict:
    """Phase 16: two ranks sharing the card over gloo (the DP teacher and
    distill steps on fixed shards at test sizes and a distill step at the
    A/B shapes, the DP sweep and an 800x800 DP eval image against the
    single-process ones, DP_DISTILL through the Trainer with n_devices=2
    against the single-process student), then one rank over NCCL (the
    distill steps over it against the single-chip ones)."""
    small = dp_small_inputs()
    want_small = dp_small_steps(small)
    want_field = dp_sweep_and_image(best)
    job = {"small": small, "kinds": ("teacher", "distill"), "best": best,
           "scene": scene, "seed": seed, "workspace": workspace}
    want_ab = dp_ab_step(job, padded=True)
    reset_counters()
    single = dp_recipe(job)
    n_floats = sum(p.numel() for p in Trainer(PVDConfig(
        **AB_DISTILL), mode="distill").state.field.parameters())
    job["allreduce_floats"] = n_floats
    want_shards = dp_ab_shard_mean(job, DP_WORLD)
    t0 = time.perf_counter()
    ranks = run_ranks(DP_WORLD, "gloo", job, workspace)
    gloo_s = time.perf_counter() - t0
    info = {"gloo_s": gloo_s, "single": single, "ranks": []}
    for r in ranks:
        label = f"gloo rank {r['rank']}/{r['world']}"
        small_c = dp_compare_small(r["small"], want_small, label)
        ab_c = dp_compare_ab(r["ab"], want_ab, want_shards, label)
        f, w = r["field"], want_field
        grid_err = float(np.abs(f["grid"] - w["grid"]).max()
                         / max(float(np.abs(w["grid"]).max()), 1e-30))
        bit_flips = int((f["bits"] != w["bits"]).sum())
        img_err = float(np.abs(f["image"] - w["image"]).max())
        rec = r["recipe"]
        launched = {k: v for k, v in rec["launches"].items() if v}
        missing = [k for k in EMAP_DISTILL_KERNELS if rec["launches"][k] <= 0]
        log(f"gloo rank {r['rank']}: sweep grid max diff / max "
            f"{grid_err:.3g} (tol {DP_GRID_RTOL:g}), bitfield flips "
            f"{bit_flips} of {w['bits'].size} (tol {DP_BIT_FLIPS}); "
            f"800x800 image max abs diff {img_err:.3g} (tol "
            f"{DP_IMAGE_ATOL:g}), rungs {f['rungs']} / {w['rungs']}, "
            f"samples {f['samples']} / {w['samples']}, render "
            f"{f['render_ms']:.1f} ms (single {w['render_ms']:.1f}); "
            f"recipe test PSNR {rec['psnr']:.3f} dB (single "
            f"{single['psnr']:.3f}, tol {DP_MAX_DROP} dB), stage-3 ms per "
            f"step {rec['train_stats']['stage3_ms_per_step']:.3f} (single "
            f"{single['train_stats']['stage3_ms_per_step']:.3f}), "
            f"{rec['num_rays'] // DP_WORLD} rays a rank; all-reduce of "
            f"{n_floats * 4 / 1e6:.1f} MB {r['allreduce_ms']:.2f} ms; "
            f"launches {json.dumps(launched)}")
        if missing:
            raise RuntimeError(f"kernels {missing} never launched on the DP "
                               "recipe")
        if not (grid_err <= DP_GRID_RTOL and bit_flips <= DP_BIT_FLIPS
                and img_err <= DP_IMAGE_ATOL):
            raise RuntimeError("the DP sweep or eval image disagrees with "
                               "the single-process one")
        if not (np.isfinite(rec["psnr"])
                and abs(rec["psnr"] - single["psnr"]) <= DP_MAX_DROP):
            raise RuntimeError(f"the DP student {rec['psnr']:.3f} dB against "
                               f"the single-process {single['psnr']:.3f}")
        info["ranks"].append({
            "small": small_c, "ab": ab_c, "grid_rel_err": grid_err,
            "bit_flips": bit_flips, "image_abs_err": img_err,
            "render_ms": f["render_ms"], "psnr": rec["psnr"],
            "recipe_launches": rec["launches"],
            "recipe_train_stats": rec["train_stats"],
            "allreduce_ms": r["allreduce_ms"]})
    if not np.array_equal(ranks[0]["field"]["image"],
                          ranks[1]["field"]["image"]):
        raise RuntimeError("the ranks' DP images differ")
    info["single_render_ms"] = want_field["render_ms"]
    # one rank over NCCL: the distill steps over it against the single-chip
    # ones
    nccl_job = dict(job, kinds=("distill",))
    (nc,) = run_ranks(1, "nccl", nccl_job, workspace)
    info["nccl"] = {"small": dp_compare_small(
        nc["small"], {"distill": want_small["distill"]}, "nccl rank 0/1"),
        "ab": dp_compare_ab(nc["ab"], want_ab, dp_ab_shard_mean(job, 1),
                            "nccl rank 0/1"),
        "allreduce_ms": nc["allreduce_ms"], "backend": nc["backend"]}
    log(f"nccl one-rank all-reduce of {n_floats * 4 / 1e6:.1f} MB "
        f"{nc['allreduce_ms']:.3f} ms; gloo phase {gloo_s:.1f} s")
    return info


# ---- phase 17: the stratified renderer, reference import, mesh, tracing
# and JPEG frames (the JAX package's last modules) -------------------------

# the stratified renders of the A/B teacher: 512 samples a ray, and 128
# plus 64 resampled (deterministic quantiles); rays in calls of 4096, the
# sweep's K1 shape at 512 samples (2,097,152 points)
STRAT_SETTINGS = {"s512": dict(num_steps=512, upsample_steps=0),
                  "s128_u64": dict(num_steps=128, upsample_steps=64)}
STRAT_CHUNK = 4096
# test-PSNR floors (PERF.md §2).  The trained teacher as it is: its
# unmarched space holds floaters the occupancy renderer never sees, and
# a ray that misses the box is composited over points clipped onto it
# (the JAX package's miss handling, ROADMAP C12), so the render sits at
# 13.7-16.7 dB from run to run, about what an empty (white) render of the
# test views scores (13.4, logged beside it); the floor sits between
# that and a uniform grey image (6.3) and catches a path that breaks into
# NaN, black or grey.  The
# same teacher with its density zeroed in the cells its grid marks empty
# (`OccupancyMasked`): the stratified path then sees what the occupancy
# march sees, and a broken sampler, composite or z order lands far under
# this floor (the occupancy renderer scores ~34.9 dB).
STRAT_PSNR_FLOOR = {"field": 8.0, "masked": 30.0}
# one stratified call at test sizes, kernels on the GPU against the plain
# path on the CPU (f32 heads, the same draws): image, depth and
# weights_sum; field gradients per leaf against its max |g| (K7 and K11
# add in a varying order, as TOL_K11_REL)
STRAT_SMALL = dict(n_rays=64, num_steps=64, upsample_steps=16)
TOL_STRAT_IMG, TOL_STRAT_GRAD_REL = 1e-5, 1e-4
# the imported INGP field renders with the same kernels on the same
# weights and bits as phase 2's; the imported student's test PSNR is its
# own eval's
TOL_IMPORT_IMAGE, TOL_IMPORT_PSNR = 1e-6, 1e-3
MESH_RES, MESH_THRESH = 256, 10.0
# the traced block: stratified calls (each launches K1 and K10 once) and
# the sessions tried before the trace is held not to name them
TRACE_CHUNKS, TRACE_SESSIONS = 4, 3
JPEG_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "data", "jpeg")
SLICE11_KERNELS = {
    "import_ingp": ("hash_encode", "march_rays", "composite_rays_compact"),
    "import_vm": ("vm_sample_fwd", "march_rays", "composite_rays_compact"),
    "stratified": ("hash_encode", "hash_encode_cell_fwd"),
    "stratified_bwd": ("hash_encode_bwd", "hash_encode_cell_bwd"),
    "mesh": ("hash_encode", "hash_encode_cell_fwd")}


def reference_state_dict(tree: dict, spec, occ) -> dict:
    """The reference Trainer's checkpoint of a field (its JAX-layout tree)
    and occupancy state: the NeRFNetwork state_dict in torch layouts
    (Linear weights [out, in], VM planes [1, R, H, W], lines [1, R, L, 1])
    with the density grid in Morton order and the aabb buffers."""
    sd = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    def mlp(prefix, layers):
        for i, layer in enumerate(layers):
            sd[f"{prefix}.{i}.weight"] = t(np.asarray(layer["w"]).T)
            if "b" in layer:
                sd[f"{prefix}.{i}.bias"] = t(layer["b"])

    if spec.model_type == "hash":
        sd["encoder.embeddings"] = t(tree["encoder"])
        mlp("sigma_net", tree["sigma_net"])
    else:
        for prefix in ("sigma", "color"):
            for i in range(3):
                sd[f"{prefix}_mat.{i}"] = t(np.asarray(
                    tree[f"{prefix}_mat"][i]).transpose(2, 0, 1)[None])
                sd[f"{prefix}_vec.{i}"] = t(np.asarray(
                    tree[f"{prefix}_vec"][i]).T[None, :, :, None])
        sd["basis_mat.weight"] = t(np.asarray(tree["basis_mat"]["w"]).T)
    mlp("color_net", tree["color_net"])
    sd["density_grid"] = to_morton_order(occ.density_grid).cpu()
    sd["aabb_train"] = occ.aabb_train.cpu()
    sd["aabb_infer"] = occ.aabb_infer.cpu()
    return {"model": sd, "epoch": 1, "global_step": 1, "stats": {},
            "mean_count": 0, "mean_density": float(occ.mean_density)}


def import_case(label: str, tree: dict, spec, rspec, occ, tmp: str,
                dev) -> tuple:
    """torch.save a reference checkpoint of (tree, occ), load it on the
    card with load_torch_reference and hold the params, the density grid
    and the bitfield bit for bit against the source."""
    path = os.path.join(tmp, f"{label}.pth")
    torch.save(reference_state_dict(tree, spec, occ), path)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    field, occ_i, meta = load_torch_reference(path, spec, rspec, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    got, want = named_leaves(tree_from_field(field)), named_leaves(tree)
    params_exact = [k for k, _ in got] == [k for k, _ in want] and all(
        np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))
    grid_exact = torch.equal(occ_i.density_grid, occ.density_grid)
    bits_exact = torch.equal(occ_i.bitfield, occ.bitfield)
    info = {"load_s": load_s, "params_exact": params_exact,
            "grid_exact": grid_exact, "bitfield_exact": bits_exact,
            "file_mb": os.path.getsize(path) / 2 ** 20,
            "occupied": float(occ_i.bitfield.float().mean())}
    log(f"reference import ({label}): {info['file_mb']:.1f} MB .pth loaded "
        f"in {load_s:.2f} s; params exact {params_exact}, density grid "
        f"exact {grid_exact}, bitfield exact {bits_exact} (occupied "
        f"{info['occupied']:.4f})")
    if not (params_exact and grid_exact and bits_exact):
        raise RuntimeError(f"the imported {label} differs from its source")
    return field, occ_i, info


def drive_reference_import(field, spec, rspec, occ, image0, pose0, intr,
                           stu, scene, tmp: str) -> dict:
    """Phase 17 (1): phase 2's full-width INGP field and object grid, and
    the A/B VM student, through a reference .pth and load_torch_reference;
    each served by make_eval_renderer and held against its source's
    render (K1-K3) or its own `evaluate` of the same moment (K4: the
    step profiles after phase 6 trained it further)."""
    dev = image0.device
    # the object grid as densities whose threshold gives its bits back
    grid = occ.bitfield.reshape(occ.density_grid.shape).float() * 20.0
    src = occ.replace(density_grid=grid, mean_density=grid.mean())
    report, launches = {}, {}
    f_imp, occ_imp, report["ingp"] = import_case(
        "ingp", hash_tree_from_field(field), spec, rspec, src, tmp, dev)
    renderer = make_eval_renderer(spec, rspec, chunk=CHUNK)
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = renderer(f_imp, occ_imp, pose0, intr, RES, RES)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches["import_ingp"] = counters()
    err = max_abs(out.image, image0)
    report["ingp"].update(render_ms=ms, image_max_abs_diff=err)
    log(f"imported INGP field, {RES}x{RES} through make_eval_renderer: "
        f"{ms:.1f} ms, max |image - phase 2's| {err:.3g} (tol "
        f"{TOL_IMPORT_IMAGE:g})")
    if not err <= TOL_IMPORT_IMAGE:
        raise RuntimeError("the imported INGP field renders another image")
    del f_imp, occ_imp, out

    tree_s = tree_from_field(stu.state.field)
    spec_imp = spec_from_tree(tree_s, stu.spec_stu)
    v_imp, occ_v, report["vm"] = import_case(
        "vm", tree_s, stu.spec_stu, stu.rspec, stu.state.occ, tmp, dev)
    render_v = make_eval_renderer(spec_imp, stu.rspec,
                                  chunk=stu.cfg.max_ray_batch)
    test = scene["test"]
    reset_counters()
    meter = []
    for i in range(len(test)):
        o = render_v(v_imp, occ_v, test.poses[i], test.intrinsics, test.H,
                     test.W)
        gt = test.images[i]
        if gt.shape[-1] == 4:
            gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
        meter.append(psnr(o.image.cpu().numpy(), gt))
    launches["import_vm"] = counters()
    p_own = stu.evaluate(test, save_dir=os.path.join(tmp, "stu"))["psnr"]
    p_imp = float(np.mean(meter))
    report["vm"].update(test_psnr=p_imp, student_eval_psnr=p_own,
                        resolution=list(spec_imp.vm_resolution))
    log(f"imported A/B VM student {spec_imp.vm_resolution}: test PSNR "
        f"{p_imp:.4f} dB over {len(test)} views, the student's own eval "
        f"{p_own:.4f} dB (tol {TOL_IMPORT_PSNR:g})")
    if not abs(p_imp - p_own) <= TOL_IMPORT_PSNR:
        raise RuntimeError("the imported VM student scores another PSNR")
    return {"report": report, "launches": launches}


class OccupancyMasked(torch.nn.Module):
    """A hash field whose density is zero in the cells of `bitfield` that
    are empty (looked up at each sample as the march looks them up): what
    the stratified renderer sees through it is what the occupancy march
    sees of the field."""

    def __init__(self, field, bitfield, rspec):
        super().__init__()
        self.field, self.bitfield, self.rspec = field, bitfield, rspec

    def forward(self, x, d, want_color: bool = True):
        out = self.field(x, d, want_color)
        keep = _occupancy_lookup(self.bitfield, x, dt_min_of(self.rspec),
                                 self.rspec)
        return out._replace(sigma=out.sigma * keep)


def stratified_image(field, spec, rspec, aabb, pose, intr, H: int, W: int,
                     chunk: int = STRAT_CHUNK) -> tuple:
    """image [H, W, 3], depth [H, W] and weights_sum [H, W] of
    render_stratified, `chunk` rays a call (the caller chunks, as the JAX
    package's callers do)."""
    pose = torch.as_tensor(np.asarray(pose, np.float32), device=aabb.device)
    parts = {"image": [], "depth": [], "weights_sum": []}
    with torch.no_grad():
        for head in range(0, H * W, chunk):
            o, d = chunk_rays(pose, tuple(float(v) for v in intr), H, W,
                              head, chunk)
            out = render_stratified(field, spec, rspec, aabb, o, d)
            for k in parts:
                parts[k].append(out[k])
    n = H * W
    return tuple(torch.cat(parts[k])[:n].reshape((H, W, 3) if k == "image"
                                                 else (H, W))
                 for k in ("image", "depth", "weights_sum"))


def stratified_parts_ms(field, spec, rspec, aabb, pose, intr) -> dict:
    """Device ms of composite_stratified (at s512: 4096 rays x 512) and of
    sample_pdf (at s128_u64: 127 bins -> 64 samples) on one chunk of the
    800x800 view through the image centre."""
    pose = torch.as_tensor(np.asarray(pose, np.float32), device=aabb.device)
    head = (RES * RES // 2) // STRAT_CHUNK * STRAT_CHUNK
    o, d = chunk_rays(pose, intr, RES, RES, head, STRAT_CHUNK)
    nears, fars = near_far_from_aabb(o, d, aabb, rspec.min_near)
    miss = nears >= 3.0e38
    nears, fars = torch.where(miss, 0.0, nears), torch.where(miss, 1.0, fars)
    out = {}
    for name, kw in STRAT_SETTINGS.items():
        rs = dataclasses.replace(rspec, **kw)
        z, sd = stratified_z_vals(nears, fars, rs.num_steps, False)
        xyz = torch.minimum(torch.maximum(
            o[:, None] + z[..., None] * d[:, None], aabb[:3]), aabb[3:])
        with torch.no_grad():
            f = field_forward(field, spec, xyz.reshape(-1, 3),
                              d[:, None].expand(xyz.shape).reshape(-1, 3),
                              aabb)
        sig = f.sigma.reshape(z.shape) * rs.density_scale
        rgb = f.rgb.reshape(*z.shape, 3)
        if rs.upsample_steps:
            w = stratified_weights(sig, z, sd)
            z_mid = z[..., :-1] + 0.5 * (z[..., 1:] - z[..., :-1])
            out["sample_pdf_ms"] = cuda_ms(lambda: sample_pdf(
                z_mid, w[:, 1:-1], rs.upsample_steps, det=True))
            out["sample_pdf_shape"] = f"{STRAT_CHUNK} rays, " \
                f"{z_mid.shape[1]} bins -> {rs.upsample_steps}"
        else:
            out["composite_stratified_ms"] = cuda_ms(
                lambda: composite_stratified(sig, z, sd, rgb))
            out["composite_shape"] = f"{STRAT_CHUNK} rays x {rs.num_steps}"
    return out


def drive_stratified(tea, scene, pose, intr, tmp: str) -> dict:
    """Phase 17 (2): the A/B teacher (cell mode: K1 + K10) through
    render_stratified on the 10 test views and one 800x800 view at each
    STRAT_SETTINGS setting, beside its occupancy renderer (its own
    `evaluate` now: the step profiles after phase 6 trained it further);
    the time of the plain composite and resampler at the chunk's shapes;
    a profile of the 800x800 render."""
    field, spec = tea.state.field, tea.spec
    aabb = tea.state.occ.aabb_infer
    test = scene["test"]
    out, launches = {}, {}
    occ_render = make_eval_renderer(spec, tea.rspec, chunk=CHUNK)
    occ_render(field, tea.state.occ, pose, intr, 64, 64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    occ_render(field, tea.state.occ, pose, intr, RES, RES)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    out["occupancy"] = {"ms_800": ms, "psnr": tea.evaluate(
        test, save_dir=os.path.join(tmp, "tea"))["psnr"]}
    gts = [gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
           if gt.shape[-1] == 4 else gt for gt in test.images]
    out["constant_psnr"] = {
        name: float(np.mean([psnr(np.full_like(gt, c), gt) for gt in gts]))
        for name, c in (("white", 1.0), ("grey", 0.5), ("black", 0.0))}
    log("test PSNR of a constant image (an empty render is white): "
        + ", ".join(f"{k} {v:.3f} dB" for k, v in
                    out["constant_psnr"].items()))
    fields = {"field": field,
              "masked": OccupancyMasked(field, tea.state.occ.bitfield,
                                        tea.rspec)}
    for (name, kw), (kind, f) in itertools.product(STRAT_SETTINGS.items(),
                                                   fields.items()):
        rs = dataclasses.replace(tea.rspec, **kw)
        reset_counters()
        psnrs = []
        t0 = time.perf_counter()
        for i in range(len(test)):
            img, _, _ = stratified_image(f, spec, rs, aabb, test.poses[i],
                                         test.intrinsics, test.H, test.W)
            psnrs.append(psnr(img.cpu().numpy(), gts[i]))
        views_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, dep, ws = stratified_image(f, spec, rs, aabb, pose, intr, RES,
                                        RES)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches[f"stratified_{name}_{kind}"] = counters()
        finite = bool(torch.isfinite(img).all() and torch.isfinite(dep).all())
        ws_ok = bool((ws >= 0).all() and (ws <= 1 + 1e-5).all())
        hit = float((ws > 0.01).float().mean())
        p = float(np.mean(psnrs))
        pts = STRAT_CHUNK * (rs.num_steps + rs.upsample_steps)
        out[f"{name}_{kind}"] = {
            "psnr": p, "psnr_per_view": psnrs, "views_s": views_s,
            "ms_800": ms, "hit_frac": hit, "points_per_call": pts}
        log(f"stratified {name}, {kind} ({rs.num_steps} + "
            f"{rs.upsample_steps} samples a ray, {pts} points a call): test "
            f"PSNR {p:.3f} dB (occupancy renderer "
            f"{out['occupancy']['psnr']:.3f}; floor "
            f"{STRAT_PSNR_FLOOR[kind]}), {len(test)} views {views_s:.2f} s; "
            f"{RES}x{RES} {ms:.1f} ms (occupancy renderer "
            f"{out['occupancy']['ms_800']:.1f} ms), finite {finite}, "
            f"weights_sum in [0,1] {ws_ok}, rays with weights_sum>0.01 "
            f"{hit:.4f}")
        if not (finite and ws_ok and p >= STRAT_PSNR_FLOOR[kind]):
            raise RuntimeError(f"stratified render {name}, {kind}: PSNR "
                               f"{p:.3f} under {STRAT_PSNR_FLOOR[kind]} or "
                               "a bad image")
    out["parts"] = stratified_parts_ms(field, spec, tea.rspec, aabb, pose,
                                       intr)
    n_calls = -(-RES * RES // STRAT_CHUNK)
    log(f"stratified plain parts on one {STRAT_CHUNK}-ray call: "
        f"composite_stratified {out['parts']['composite_stratified_ms']:.3f}"
        f" ms ({out['parts']['composite_shape']}; x{n_calls} calls an "
        f"800x800 image), sample_pdf {out['parts']['sample_pdf_ms']:.3f} ms "
        f"({out['parts']['sample_pdf_shape']})")
    rs = dataclasses.replace(tea.rspec, **STRAT_SETTINGS["s512"])
    prof = profile(lambda: stratified_image(field, spec, rs, aabb, pose,
                                            intr, RES, RES), top=15)
    out["profile_s512"] = {**profile_brief(prof), "top": prof["top"]}
    log(f"profile of the s512 {RES}x{RES} stratified render: wall "
        f"{prof['wall_ms']:.1f} ms, device busy {prof['device_busy_ms']:.1f}"
        f" ms (share {prof['device_busy_share']:.3f})")
    for row in prof["top"]:
        log(f"  {row['ms']:9.3f} ms {row['calls']:6d} x {row['kernel']}")
    return {"report": out, "launches": launches}


def small_stratified_gpu_vs_cpu(devices=("cuda", "cpu")) -> dict:
    """One perturbed, resampled render_stratified call and its backward at
    test sizes (the small cell-mode teacher, f32 heads): kernels on the
    GPU (K1, K10 forward; K7, K11 backward) against the plain path on the
    CPU, with the same draws."""
    rng = np.random.default_rng(21)
    spec = ModelSpec(**SMALL_CELL_TEA)
    tree = random_hash_params(spec, rng)
    n, T, U = (STRAT_SMALL[k] for k in ("n_rays", "num_steps",
                                         "upsample_steps"))
    pose = nerf_matrix_to_ngp(pose_spherical(30.0, -30.0, 4.0), scale=0.8)
    inds = torch.from_numpy(rng.integers(0, SMALL_HW ** 2, n))
    rays = get_rays(torch.from_numpy(pose)[None], SMALL_INTR, SMALL_HW,
                    SMALL_HW, inds)
    o, d = rays["rays_o"][0].contiguous(), rays["rays_d"][0].contiguous()
    draws = [torch.from_numpy(rng.uniform(size=s).astype(np.float32))
             for s in ((n, T), (n, U))]
    gi = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    gd = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    rs = RenderSpec(num_steps=T, upsample_steps=U)
    aabb = torch.tensor([-1.0] * 3 + [1.0] * 3)
    res = []
    for where in devices:
        field = hash_field_from_jax(tree, spec, where)
        reset_counters()
        out = render_stratified(field, spec, rs, aabb.to(where), o.to(where),
                                d.to(where), perturb=True,
                                draws=tuple(u.to(where) for u in draws))
        ((out["image"] * gi.to(where)).sum()
         + (out["depth"] * gd.to(where)).sum()).backward()
        res.append(({k: v.detach().cpu() for k, v in out.items()},
                    named_leaves(hash_tree_from_field(field, grad=True)),
                    counters()))
    img_err = max(max_abs(res[0][0][k], res[1][0][k])
                  for k in ("image", "depth", "weights_sum"))
    grad_err, worst = 0.0, ""
    for (name, a), (_, b) in zip(res[0][1], res[1][1]):
        e = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        if e > grad_err or not np.isfinite(e):
            grad_err, worst = e if np.isfinite(e) else math.inf, name
    launched = res[0][2]
    log(f"stratified call GPU kernels vs CPU plain (test sizes: {n} rays, "
        f"{T} + {U} samples, perturbed; cell-mode field, f32 heads): max "
        f"|image, depth, weights_sum diff| {img_err:.3g} (tol "
        f"{TOL_STRAT_IMG:g}); max grad diff / leaf max {grad_err:.3g} "
        f"({worst}; tol {TOL_STRAT_GRAD_REL:g}); GPU launches "
        + json.dumps({k: launched[k] for k in (
            "hash_encode", "hash_encode_cell_fwd", "hash_encode_bwd",
            "hash_encode_cell_bwd")}))
    if not (img_err <= TOL_STRAT_IMG and grad_err <= TOL_STRAT_GRAD_REL):
        raise RuntimeError("the GPU stratified call disagrees with the CPU "
                           "plain path")
    return {"img_err": img_err, "grad_err_rel_leaf_max": grad_err,
            "grad_err_leaf": worst, "launches": launched}


def drive_mesh(tea, tmp: str) -> dict:
    """Phase 17 (3): the A/B teacher's mesh at MESH_RES, threshold
    MESH_THRESH: the density sweep on the card (K1 + K10 through
    field_density), the surface in torch on the card, then the same
    through extract_geometry and an OBJ."""
    field, spec = tea.state.field, tea.spec
    b = tea.rspec.bound
    bmin, bmax = (-b,) * 3, (b,) * 3
    query = density_query(field, spec, tea.state.occ.aabb_infer)
    extract_fields(bmin, bmax, 8, query, device=tea.device)  # warm-up
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u = extract_fields(bmin, bmax, MESH_RES, query, device=tea.device)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launched = counters()
    t0 = time.perf_counter()
    v_grid, t_grid = marching_tetrahedra(u, MESH_THRESH)
    torch.cuda.synchronize()
    surface_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    verts, tris = extract_geometry(bmin, bmax, MESH_RES, MESH_THRESH, query,
                                   device=tea.device)
    geometry_s = time.perf_counter() - t0
    path = os.path.join(tmp, "ab_teacher.obj")
    t0 = time.perf_counter()
    save_obj(path, verts, tris)
    obj_s = time.perf_counter() - t0
    inside = bool(len(verts) and (verts >= np.float32(-b)).all()
                  and (verts <= np.float32(b)).all())
    same = len(t_grid) == len(tris) and np.array_equal(
        t_grid.cpu().numpy(), tris)
    info = {"sweep_s": sweep_s, "surface_s": surface_s,
            "extract_geometry_s": geometry_s, "save_obj_s": obj_s,
            "vertices": len(verts), "triangles": len(tris),
            "occupied_frac": float((u > MESH_THRESH).float().mean()),
            "obj_mb": os.path.getsize(path) / 2 ** 20,
            "inside_box": inside}
    log(f"mesh of the A/B teacher at {MESH_RES}^3, threshold {MESH_THRESH}: "
        f"sweep {sweep_s:.3f} s ({MESH_RES ** 3} density queries; launches "
        f"K1 {launched['hash_encode']}, K10 "
        f"{launched['hash_encode_cell_fwd']}), surface {surface_s:.3f} s, "
        f"extract_geometry {geometry_s:.3f} s, {len(tris)} triangles, "
        f"{len(verts)} vertices, all inside the box {inside}; OBJ "
        f"{info['obj_mb']:.1f} MB in {obj_s:.2f} s")
    if not (len(tris) and inside and same):
        raise RuntimeError("mesh: empty, outside the box or not the "
                           "surface of the sweep")
    return {"report": info, "launches": launched}


def drive_trace(tea, pose, intr, tmp: str) -> dict:
    """Phase 17 (4a): TRACE_CHUNKS stratified calls under `trace`; the
    Chrome trace must hold a kernel record of K1 and of K10.  After a long
    profiled run the profiler loses the first device records of a session
    (tools/torch_profiler_record_loss.py), so the traced block launches
    each kernel TRACE_CHUNKS times, and a session that kept no record of
    one of them is run again, up to TRACE_SESSIONS in all; every session's
    records are logged beside its launches."""
    field, spec = tea.state.field, tea.spec
    aabb = tea.state.occ.aabb_infer
    rs = dataclasses.replace(tea.rspec, **STRAT_SETTINGS["s512"])
    pose = torch.as_tensor(np.asarray(pose, np.float32), device=aabb.device)
    head = (RES * RES // 2) // STRAT_CHUNK * STRAT_CHUNK
    rays = [chunk_rays(pose, intr, RES, RES, head + i * STRAT_CHUNK,
                       STRAT_CHUNK) for i in range(TRACE_CHUNKS)]
    sessions = []
    for s in range(TRACE_SESSIONS):
        log_dir = os.path.join(tmp, f"trace{s}")
        n1, n10 = hash_encode.launches, hash_encode_cell_fwd.launches
        with torch.no_grad(), trace(log_dir):
            for o, d in rays:
                render_stratified(field, spec, rs, aabb, o, d)
        path = os.path.join(log_dir, "trace.json")
        names = [e.get("name", "") for e in
                 json.load(open(path))["traceEvents"]
                 if e.get("cat") == "kernel"]
        names = [n[len("void "):] if n.startswith("void ") else n
                 for n in names]
        sessions.append({
            "trace_mb": os.path.getsize(path) / 2 ** 20,
            "kernel_records": len(names),
            "k1_launches": hash_encode.launches - n1,
            "k1_records": sum(n.startswith(("hash_encode_fwd_kernel(",
                                            "hash_encode_fwd_per_level_"
                                            "kernel(")) for n in names),
            "k10_launches": hash_encode_cell_fwd.launches - n10,
            "k10_records": sum(n.startswith("hash_cell_fwd_kernel(")
                               for n in names)})
        r = sessions[-1]
        log(f"trace {s} of {TRACE_CHUNKS} stratified calls: "
            f"{r['trace_mb']:.2f} MB Chrome trace, {r['kernel_records']} "
            f"kernel records; K1 {r['k1_records']} of {r['k1_launches']} "
            f"launches, K10 {r['k10_records']} of {r['k10_launches']}")
        if r["k1_records"] and r["k10_records"]:
            break
    info = {"sessions": sessions, "names_k1": bool(r["k1_records"]),
            "names_k10": bool(r["k10_records"])}
    if not (info["names_k1"] and info["names_k10"]):
        raise RuntimeError(f"no trace of {TRACE_SESSIONS} names K1 and K10")
    return info


def check_jpeg_fixtures() -> dict:
    """Phase 17 (4b): the committed JPEG fixtures through the port's
    decoder (built here with g++) against their committed cv2 decodes,
    bit for bit; the progressive one refused."""
    lib = hostlib.library_path(jpeg.SOURCE, jpeg.BUILD_DIR, jpeg.GXX_FLAGS)
    found = lib.exists()
    t0 = time.perf_counter()
    jpeg.load()
    build_s = time.perf_counter() - t0
    names = sorted(f[:-4] for f in os.listdir(JPEG_FIXTURES)
                   if f.endswith(".jpg") and f != "progressive.jpg")
    exact, ms = [], 0.0
    for name in names:
        t0 = time.perf_counter()
        got = read_jpeg(os.path.join(JPEG_FIXTURES, name + ".jpg"))
        ms += (time.perf_counter() - t0) * 1e3
        want = read_png(os.path.join(JPEG_FIXTURES, name + ".png"))
        exact.append(got.shape[:2] == want.shape[:2]
                     and np.array_equal(got, want.reshape(got.shape)))
    try:
        read_jpeg(os.path.join(JPEG_FIXTURES, "progressive.jpg"))
        refused = False
    except ValueError:
        refused = True
    info = {"library_found": found, "build_s": build_s,
            "fixtures": len(names), "exact": sum(exact),
            "decode_ms_total": ms, "progressive_refused": refused}
    log(f"JPEG: decoder library {'found' if found else 'built'} in "
        f"{build_s:.2f} s; {sum(exact)} of {len(names)} fixtures bit for "
        f"bit their cv2 decodes ({ms:.2f} ms in all), progressive refused "
        f"{refused}")
    if not (all(exact) and len(names) == 8 and refused):
        raise RuntimeError("JPEG fixtures do not decode as cv2 decodes them")
    return info


def drive_slice11(field, spec, rspec, occ, image0, pose0, intr, tea, stu,
                  scene) -> dict:
    """Phase 17: reference import, the stratified renderer, the mesh, the
    trace and the JPEG fixtures; each run's counters set to 0 just before
    it and read just after."""
    t_all = time.perf_counter()
    walls = {}
    with tempfile.TemporaryDirectory(prefix="pvd_slice11_") as tmp:
        t0 = time.perf_counter()
        imp = drive_reference_import(field, spec, rspec, occ, image0, pose0,
                                     intr, stu, scene, tmp)
        walls["import"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        strat = drive_stratified(tea, scene, pose0, intr, tmp)
        strat["report"]["gpu_vs_cpu"] = small_stratified_gpu_vs_cpu()
        walls["stratified"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh_run = drive_mesh(tea, tmp)
        walls["mesh"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tr = drive_trace(tea, pose0, intr, tmp)
        jp = check_jpeg_fixtures()
        walls["trace_jpeg"] = time.perf_counter() - t0
    launches = {**imp["launches"], **strat["launches"],
                "stratified_bwd": strat["report"]["gpu_vs_cpu"]["launches"],
                "mesh": mesh_run["launches"]}
    for path, names in SLICE11_KERNELS.items():
        got = [v for k, v in launches.items() if k.startswith(path)]
        for name in names:
            if not all(c[name] > 0 for c in got):
                raise RuntimeError(f"kernel {name} never launched on the "
                                   f"{path} path")
    walls["total"] = time.perf_counter() - t_all
    log("phase 17 walls: " + ", ".join(f"{k} {v:.1f} s"
                                       for k, v in walls.items()))
    return {"import": imp["report"], "stratified": strat["report"],
            "mesh": mesh_run["report"], "trace": tr, "jpeg": jp,
            "launches": launches, "walls": walls}


HOST_AB_CHILD = r"""
import cProfile, json, os, pstats, re, sys, tempfile
import torch
from pvd_tpu_torch import kernels
from pvd_tpu_torch.config import PVDConfig
from pvd_tpu_torch.data.synth import make_synthetic_scene
from pvd_tpu_torch.engine.trainer import Trainer
scene_kw, tea_kw, seed, steps = json.loads(sys.argv[1])
kernels.build_seconds()
torch.backends.cuda.matmul.allow_tf32 = False
scene = make_synthetic_scene(**scene_kw, seed=seed, scale=PVDConfig().scale)
with tempfile.TemporaryDirectory() as ws:
    tea = Trainer(PVDConfig(**tea_kw, seed=seed, workspace=ws + "/t"))
    tea.train(scene["train"], valid_ds=scene["val"])
    short = Trainer(PVDConfig(**dict(tea_kw, iters=steps), seed=seed,
                              workspace=ws + "/p"))
    prof = cProfile.Profile()
    prof.enable()
    short.train(scene["train"])
    prof.disable()
ps = pstats.Stats(prof)
here = os.getcwd() + os.sep


def name(f, fn):  # file and function, no line number or address
    return re.sub(" at 0x[0-9a-f]+", "", f"{f.replace(here, '')}({fn})")


calls = {}
for (f, n, fn), v in ps.stats.items():
    calls[name(f, fn)] = calls.get(name(f, fn), 0.0) + v[1] / steps
top = sorted(ps.stats.items(), key=lambda kv: -kv[1][2])[:12]
print(json.dumps({
    "train_stats": tea.train_stats,
    "profiled_ms_per_step": 1e3 * short.train_stats["train_wall_s"] / steps,
    "calls_per_step": ps.total_calls / steps,
    "python_ms_per_step": 1e3 * ps.total_tt / steps,
    "calls": calls,
    "top": [[name(f, fn), v[1] / steps, 1e6 * v[2] / steps]
            for (f, n, fn), v in top]}))
"""


def host_ab(other: str, seed: int) -> int:
    """This checkout and `other` (another checkout of the repo) in turn,
    HOST_AB_REPS runs each of HOST_AB_CHILD in the order this, other,
    other, this, this, other, so that a drift over the call falls on both
    alike; logs each run, the functions whose calls per step differ, and
    one JSON summary line."""
    trees = {"this": os.path.dirname(os.path.abspath(__file__)),
             "other": os.path.abspath(other)}
    arg = json.dumps([AB_SCENE, AB_TEACHER, seed, HOST_AB_PROFILE_STEPS])
    runs = {"this": [], "other": []}
    for i in range(HOST_AB_REPS):
        for name in (("this", "other") if i % 2 == 0 else ("other", "this")):
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-c", HOST_AB_CHILD, arg], cwd=trees[name],
                env=dict(os.environ, PYTHONPATH=trees[name]),
                capture_output=True, text=True, timeout=900)
            if res.returncode:
                log(f"host A/B {name} failed:\n{res.stderr[-3000:]}")
                return 1
            run = json.loads(res.stdout.strip().splitlines()[-1])
            st = run["train_stats"]
            runs[name].append(run)
            log(f"host A/B {name} run {len(runs[name])}: process "
                f"{time.perf_counter() - t0:.1f} s, train_wall_s "
                f"{st['train_wall_s']:.2f}, padded "
                f"{st['padded_ms_per_step']:.2f} / compacted "
                f"{st['compacted_ms_per_step']:.2f} ms per step; profiled "
                f"{run['profiled_ms_per_step']:.2f} ms per step, "
                f"{run['calls_per_step']:.1f} Python calls and "
                f"{run['python_ms_per_step']:.2f} ms in them per step")
            log("  top " + json.dumps(run["top"][:8]))
    a, b = runs["this"][0]["calls"], runs["other"][0]["calls"]
    diff = {k: (a.get(k, 0.0), b.get(k, 0.0)) for k in set(a) | set(b)
            if abs(a.get(k, 0.0) - b.get(k, 0.0)) > 1e-9}
    for k, (x, y) in sorted(diff.items()):
        log(f"calls per step differ: {k}: this {x:.3f}, other {y:.3f}")

    def col(name, key):
        return [r["train_stats"][key] if key in r["train_stats"] else r[key]
                for r in runs[name]]

    print(json.dumps({"host_ab": {
        name: {key: col(name, key) for key in (
            "train_wall_s", "padded_ms_per_step", "compacted_ms_per_step",
            "profiled_ms_per_step", "calls_per_step", "python_ms_per_step")}
        for name in runs}, "trees": trees}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--host-ab", metavar="DIR", default=None,
                    help="only time the A/B teacher in this checkout and "
                         "in the checkout DIR in turn, with a host profile"
                         " of each (see host_ab)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    if args.host_ab:
        return host_ab(args.host_ab, args.seed)
    dev = torch.device("cuda")
    t_script = time.perf_counter()

    # ---- set-up -------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    build_s = kernels.build_seconds()
    log(f"kernel build+load: {build_s:.1f} s ({kernels.library_path().name})")
    for line in (kernels.library_path().parent
                 / (kernels.library_path().name + ".log")).read_text() \
            .splitlines():
        if "registers" in line or line.startswith("=="):
            log("  ptxas " + line.strip())

    cfg = PVDConfig()
    spec, rspec = cfg.model_spec(), cfg.render_spec()
    H, C = rspec.grid_size, rspec.cascades
    rng = np.random.default_rng(args.seed)
    tree = random_hash_params(spec, rng)
    field = hash_field_from_jax(tree, spec, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    jitter = torch.rand((C, H ** 3, 3), generator=gen, device=dev)
    occ_update = make_occ_update(spec, rspec)
    renderer = make_eval_renderer(spec, rspec, chunk=CHUNK)
    focal = 0.5 * RES / math.tan(0.5 * 0.6911112070083618)
    intr = (focal, focal, RES / 2.0, RES / 2.0)
    intr_e2e = tuple(v * E2E_RES / RES for v in intr)
    poses = [nerf_matrix_to_ngp(pose_spherical(th, -30.0, 4.0))
             for th in (0.0, 120.0, 240.0)]
    log(f"model: hash {spec.hash_num_levels}x{spec.hash_level_dim} "
        f"table {field.grid.table_size} rows, heads {spec.compute_dtype}; "
        f"grid {H}^3 x {C}, max_steps {rspec.max_steps}, samples_per_ray "
        f"{rspec.samples_per_ray:g}, chunk {CHUNK}")

    # ---- main path: occupancy sweep + three renders --------------------
    reset_counters()
    occ = init_occupancy_state(rspec)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    occ = occ_update(occ, field, full=True, jitter=jitter)
    torch.cuda.synchronize()
    sweep_ms = (time.perf_counter() - t0) * 1e3
    log(f"occupancy sweep: {C * H ** 3} density queries, {sweep_ms:.1f} ms, "
        f"occupied {float(occ.bitfield.float().mean()):.4f}, mean density "
        f"{float(occ.mean_density):.4f}")
    # random weights make no object: march the object grid instead
    occ = set_bitfield(occ, torch.from_numpy(object_like_bitfield(H)).to(dev))
    log(f"object grid: occupied {float(occ.bitfield.float().mean()):.4f}")
    images = []
    for i, pose in enumerate(poses):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = renderer(field, occ, pose, intr, RES, RES)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        finite = bool(torch.isfinite(out.image).all()
                      and torch.isfinite(out.depth).all())
        ws_ok = bool((out.weights_sum >= 0).all()
                     and (out.weights_sum <= 1 + 1e-5).all())
        hit = float((out.weights_sum > 0.01).float().mean())
        spr = out.samples / (RES * RES)
        log(f"render {i}: {RES}x{RES} {ms:.1f} ms, rungs {out.rungs}, "
            f"truncated chunks {out.truncated_chunks}, samples/ray "
            f"{spr:.3f}, finite {finite}, weights_sum in [0,1] {ws_ok}, "
            f"rays with weights_sum>0.01 {hit:.4f}")
        if not (finite and ws_ok and out.image.shape == (RES, RES, 3)):
            raise RuntimeError(f"render {i}: bad image")
        if not 0.0 < hit < 1.0:
            raise RuntimeError(f"render {i}: object not seen ({hit})")
        images.append({"ms": ms, "rungs": out.rungs, "samples_per_ray": spr})
        if i == 0:
            image0 = out.image  # phase 17 renders its import against it
    launches = {k: v for k, v in counters().items() if k in SERVE_KERNELS}
    log(f"launches on the serving path: {json.dumps(launches)}")
    n_chunks = -(-RES * RES // CHUNK)
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"kernel {name} never launched on the path")
    if launches["march_rays"] < n_chunks * len(poses):
        raise RuntimeError(f"march_rays launched {launches['march_rays']} "
                           f"times, expected >= {n_chunks} per image")

    # where one render's time goes (after the counted path)
    prof = profile(lambda: renderer(field, occ, poses[1], intr, RES, RES))
    log(f"profile of render 1: wall {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['device_busy_ms']:.1f} ms "
        f"(share {prof['device_busy_share']:.3f})")
    for row in prof["top"]:
        log(f"  {row['ms']:9.3f} ms {row['calls']:6d} x {row['kernel']}")
    for name, row in prof["ours"].items():
        log(f"  ours: {row['ms']:9.3f} ms {row['calls']:6d} x {name}")

    # ---- main path 2: the distill step, stages 1-3 ---------------------
    spec_stu, opt, state = distill_setup(cfg, field, dev, rng, H)
    pose_t = torch.as_tensor(poses[0], device=dev)
    log(f"distill: student vm {spec_stu.vm_resolution} ranks "
        f"{spec_stu.vm_sigma_rank}/{spec_stu.vm_color_rank} "
        f"({sum(p.numel() for p in state.field.parameters()):,} params), "
        f"teacher the hash field above (frozen); {cfg.num_rays} rays, "
        f"budget {rspec.sample_budget(cfg.num_rays)}, surface grid occupied "
        f"{float(state.occ.bitfield.float().mean()):.4f}")
    reset_counters()
    stages = drive_distill(cfg, spec_stu, spec, opt, state, field, pose_t,
                           intr, gen)
    distill_launches = counters()
    n_steps = 3 * (WARMUP_STEPS + TIMED_STEPS)
    log(f"launches on the distill path ({n_steps} steps): "
        f"{json.dumps(distill_launches)}")
    step3 = make_distill_step(spec_stu, spec, rspec, opt, cfg, intr, RES,
                              RES, 3)
    prof_d = profile(lambda: step3(state, field, state.occ, pose_t, gen))
    log(f"profile of one stage-3 step: wall {prof_d['wall_ms']:.2f} ms, "
        f"device busy {prof_d['device_busy_ms']:.2f} ms (share "
        f"{prof_d['device_busy_share']:.3f})")
    for row in prof_d["top"]:
        log(f"  {row['ms']:9.3f} ms {row['calls']:6d} x {row['kernel']}")
    for name, row in prof_d["ours"].items():
        log(f"  ours: {row['ms']:9.3f} ms {row['calls']:6d} x {name}")

    # ---- kernels vs their plain versions --------------------------------
    results = []
    # K1 on the sweep's query points
    pts = query_points(grid_coords(H, dev), 0, jitter[0], rspec)
    x01 = ((pts + rspec.bound) / (2.0 * rspec.bound)).contiguous()
    table, gs = field.encoder.detach(), field.grid
    k1_sweep = k1_case(table, x01, gs)
    log_k1("occupancy sweep", k1_sweep)
    k1_hard = check_k1_hard_cases(dev)
    results.append(dict(
        name="hash_encode", source="pvd_tpu_torch/csrc/hash_encode.cu",
        replaces="pvd_tpu/ops/hashgrid.py:533", tol=TOL_K1,
        err=max([k1_sweep["err"]] + [c["err"] for c in k1_hard.values()]),
        **{k: k1_sweep[k] for k in ("ms", "kernel_ms", "call_ms",
                                    "plain_ms", "library_ms", "bound")},
        library_call="F.embedding_bag(mode='sum', per_sample_weights) on "
        "the precomputed corner rows and weights",
        shape=f"N={x01.shape[0]} points x {gs.num_levels} levels (err: "
        "also on k1_hard_inputs)"))
    del pts, x01

    # K2 on one chunk of render 0's rays (through the image center)
    rs_eval = dataclasses.replace(rspec, max_samples=rspec.max_steps)
    head = (RES * RES // 2) // CHUNK * CHUNK
    pose0 = torch.as_tensor(poses[0], device=dev)
    o, d = chunk_rays(pose0, intr, RES, RES, head, CHUNK)
    o, d = o.contiguous(), d.contiguous()
    nears, fars = near_far_from_aabb(o, d, occ.aabb_infer, rspec.min_near)
    bf = occ.bitfield

    def k2():
        return march_rays(bf, o, d, nears, fars, rs_eval)

    sk, sp = k2(), march_rays_plain(bf, o, d, nears, fars, rs_eval)
    exact = all(torch.equal(getattr(sk, f), getattr(sp, f))
                for f in ("t", "dt", "mask", "t0"))
    err2 = max_abs(sk.delta_depth, sp.delta_depth)
    # train mode (first max_samples occupied points) with a perturbation
    u = torch.rand(CHUNK, generator=gen, device=dev)
    tk = march_rays(bf, o, d, nears, fars, rspec, u)
    tp = march_rays_plain(bf, o, d, nears, fars, rspec, u)
    exact_train = all(torch.equal(getattr(tk, f), getattr(tp, f))
                      for f in ("t", "dt", "mask", "t0"))
    err2 = max(err2, max_abs(tk.delta_depth, tp.delta_depth))
    # two cascades (bound 2, the frexp cascade pick) on a random grid;
    # these rays start inside the box
    rs2 = dataclasses.replace(rs_eval, bound=2.0)
    bf2 = torch.rand(rs2.cascades * H ** 3, generator=gen, device=dev) < 0.1
    aabb2 = torch.tensor([-2.0] * 3 + [2.0] * 3, device=dev)
    n2, f2 = near_far_from_aabb(o, d, aabb2, rs2.min_near)
    ck = march_rays(bf2, o, d, n2, f2, rs2)
    cp = march_rays_plain(bf2, o, d, n2, f2, rs2)
    exact_c2 = all(torch.equal(getattr(ck, f), getattr(cp, f))
                   for f in ("t", "dt", "mask", "t0"))
    err2 = max(err2, max_abs(ck.delta_depth, cp.delta_depth))
    log(f"K2 t/dt/mask exact: eval {exact}, train {exact_train}, two "
        f"cascades {exact_c2}; samples: eval {int(sk.mask.sum())}, train "
        f"{int(tk.mask.sum())}, two cascades {int(ck.mask.sum())}")
    if not (exact and exact_train and exact_c2):
        raise RuntimeError("march_rays kernel differs from the plain version")
    S, L = rs_eval.max_samples, rs_eval.max_steps
    b2 = bound(CHUNK * 32 + bf.numel() + CHUNK * S * 13 + CHUNK * 4,
               CHUNK * L * 20)
    results.append(dict(
        name="march_rays", source="pvd_tpu_torch/csrc/march.cu",
        replaces="pvd_tpu/render/renderer.py:643", err=err2, tol=TOL_K2_DD,
        **timings(k2, lambda: march_rays_plain(bf, o, d, nears, fars,
                                               rs_eval)),
        bound=b2, shape=f"N={CHUNK} rays x L={L} eval slots"))
    k2_hard = check_k2_hard_cases(dev)

    # K3 on that chunk's compacted stream at the 1x budget
    rs_c = dataclasses.replace(rs_eval, samples_per_ray=rspec.samples_per_ray)
    budget = rs_c.sample_budget(CHUNK)
    cmp = compact_samples(sk.mask, budget, prefix=False)
    with torch.no_grad():
        t_c = sk.t.reshape(-1)[cmp.idx]
        rid = cmp.ray_id
        xyz = (o[rid] + t_c[:, None] * d[rid]).clamp(-rspec.bound,
                                                      rspec.bound)
        f_out = field(xyz, d[rid])
    dt_c = torch.where(cmp.valid, dt_min_of(rspec), 0.0)
    t_cum = torch.where(cmp.valid, t_c + dt_c - sk.t0[rid], 0.0)
    sig = f_out.sigma.contiguous()
    rgb = f_out.rgb.contiguous()
    k3args = (sig, rgb, dt_c, t_cum, rid, cmp.valid, CHUNK, True)
    k3 = composite_rays_compact(*k3args)
    p3 = composite_rays_compact_plain(*k3args)
    err3 = max(max_abs(a, b) for a, b in zip(k3, p3))
    M = budget
    log(f"K3 stream: budget {M}, valid samples {int(cmp.total)}, "
        f"weights_sum max {float(k3[0].max()):.4f}")
    b3 = bound(M * (4 + 12 + 4 + 4 + 8 + 1) + M * 4 + CHUNK * 20, M * 16)
    results.append(dict(
        name="composite_rays_compact",
        source="pvd_tpu_torch/csrc/composite.cu",
        replaces="pvd_tpu/ops/composite.py:28", err=err3, tol=TOL_K3,
        **timings(lambda: composite_rays_compact(*k3args),
                  lambda: composite_rays_compact_plain(*k3args)),
        bound=b3, lanes=k3_lanes(M, CHUNK),
        shape=f"M={M} slots, N={CHUNK} rays"))
    # K1 on that chunk's compacted points
    k1_serving = k1_case(table, ((xyz + rspec.bound)
                                 / (2.0 * rspec.bound)).contiguous(), gs)
    log_k1("serving chunk, 1x budget", k1_serving)
    # K3 on the same chunk at the ladder's 16x rung (256 slots per ray)
    rs16 = dataclasses.replace(rs_eval,
                               samples_per_ray=16.0 * rspec.samples_per_ray)
    cmp16 = compact_samples(sk.mask, rs16.sample_budget(CHUNK), prefix=False)
    with torch.no_grad():
        t16, rid16 = sk.t.reshape(-1)[cmp16.idx], cmp16.ray_id
        f16 = field((o[rid16] + t16[:, None] * d[rid16])
                    .clamp(-rspec.bound, rspec.bound), d[rid16])
    dt16 = torch.where(cmp16.valid, dt_min_of(rspec), 0.0)
    args16 = (f16.sigma.contiguous(), f16.rgb.contiguous(), dt16,
              torch.where(cmp16.valid, t16 + dt16 - sk.t0[rid16], 0.0),
              rid16, cmp16.valid)
    del f16
    k3_16x = k3_case(args16, CHUNK, True)
    log_k3("serving chunk, 16x rung", k3_16x)
    del args16
    k3_hard, k7_hard = check_k3_hard_cases(dev), check_k7_hard_cases(dev)

    # K4, K5, K6 on one stage-3 batch of the distill path
    xn, compact, comp = path_inputs(cfg, spec_stu, state, pose_t, intr, gen)
    log(f"distill batch: {int(compact.total)} valid samples, budget "
        f"{xn.shape[0]}")
    results += check_vm_kernels(state, xn, compact, gen)
    results.append(check_composite_bwd(comp, gen))
    vm_proj = vm_projection_case(state.field, xn, gen)
    log_vm_projection("distill step batch", vm_proj)

    # ---- end to end: the kernel path on the GPU against the plain path on
    # the CPU (the path the tests hold against the JAX package), f32 heads
    spec32 = dataclasses.replace(spec, compute_dtype="float32")
    occ_cpu = occ.replace(**{f: getattr(occ, f).cpu() for f in (
        "density_grid", "bitfield", "mean_density", "aabb_train",
        "aabb_infer")})
    small = {}
    for where, f_dev, o_dev in (
            ("cuda", hash_field_from_jax(tree, spec32, dev), occ),
            ("cpu", hash_field_from_jax(tree, spec32, "cpu"), occ_cpu)):
        small[where] = make_eval_renderer(spec32, rspec, chunk=E2E_CHUNK,
                                          device=where)(
            f_dev, o_dev, poses[0], intr_e2e, E2E_RES, E2E_RES)
    e2e_err = max(max_abs(small["cuda"].image.cpu(), small["cpu"].image),
                  max_abs(small["cuda"].depth.cpu(), small["cpu"].depth))
    e2e_hit = float((small["cpu"].weights_sum > 0.01).float().mean())
    log(f"end to end {E2E_RES}x{E2E_RES} (f32 heads): max |GPU kernels - "
        f"CPU plain| {e2e_err:.3g} (tol {TOL_E2E:g}); rungs "
        f"{small['cuda'].rungs}/{small['cpu'].rungs}; rays with "
        f"weights_sum>0.01 {e2e_hit:.3f}")
    if not (e2e_err <= TOL_E2E and 0.0 < e2e_hit < 1.0):
        raise RuntimeError("the GPU render disagrees with the CPU plain "
                           "path")
    step_check = small_step_gpu_vs_cpu()
    descent = fixed_batch_descent(cfg, spec_stu, spec, opt, state, field,
                                  pose_t, intr, gen)

    # ---- main path 3: teacher training (the recipe) + its test eval -----
    with tempfile.TemporaryDirectory(prefix="pvd_teacher_") as ws:
        reset_counters()
        trainer, scene, teacher = drive_teacher(args.seed, ws)
        teacher_launches = counters()
    log(f"launches on the teacher path ({RECIPE['iters']} steps, "
        f"{RECIPE['n_test']} renders): {json.dumps(teacher_launches)}")
    for name in TEACHER_KERNELS:
        if teacher_launches[name] <= 0:
            raise RuntimeError(f"kernel {name} never launched on the "
                               "teacher path")
    t_results, t_extra = check_teacher_kernels(trainer, scene, gen)
    results += t_results
    flavors = teacher_step_flavors(trainer, scene)
    teacher_check = small_teacher_gpu_vs_cpu()
    del trainer

    # ---- main path 4: the quality A/B recipe (cell-mode teacher ->
    # checkpoint -> distill Trainer -> test eval) ----------------------------
    with tempfile.TemporaryDirectory(prefix="pvd_ab_") as ws:
        reset_counters()
        t0 = time.perf_counter()
        tea_ab, stu_ab, scene_ab, ab = drive_ab_recipe(args.seed, ws)
        ab["wall_s"] = time.perf_counter() - t0
        ab_launches = counters()
        # ---- main path 5: the distillation CLI on the A/B recipe, with
        # the A/B teacher baked -----------------------------------------
        best = os.path.join(tea_ab.workspace, "checkpoints", "hash_best.ckpt")
        reset_counters()
        t0 = time.perf_counter()
        cli = drive_distill_cli(args.seed, ws, best, ab)
        cli["wall_s"] = time.perf_counter() - t0
        cli_launches = counters()
        # ---- main path 6: the teacher CLI on that scene, on the host
        # batcher; main path 7: the MLP and plenoxel fields as teachers
        # (teacher CLI) and students (distill CLI).  Each run's counters
        # are set to 0 just before it and read just after
        t0 = time.perf_counter()
        tea_cli = drive_teacher_cli(args.seed, ws, cli["scene"], ab)
        tea_cli["wall_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fields = drive_new_fields(args.seed, ws, cli["scene"], gen)
        fields_wall_s = time.perf_counter() - t0
        log(f"teacher CLI phase {tea_cli['wall_s']:.1f} s, new fields "
            f"{fields_wall_s:.1f} s")
        # ---- main paths 8-10: resizing (the VM c2f teacher and its hash
        # student; the c2f plenoxel student), the error map and EMA
        # through both CLIs; each run's counters set to 0 just before it
        # and read just after
        walls = {}
        t0 = time.perf_counter()
        vm_c2f = drive_vm_c2f(args.seed, ws, cli["scene"], gen)
        walls["vm_c2f"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        c2f = drive_c2f_plenoxel(args.seed, ws, cli["scene"], best, ab, gen)
        walls["c2f_plenoxel"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        emap = drive_emap_ema(args.seed, ws, cli["scene"], gen)
        walls["emap_ema"] = time.perf_counter() - t0
        # ---- main paths 11-12: scan steps through both CLIs; data
        # parallel (two gloo ranks on the card, one NCCL rank); each
        # run's counters set to 0 just before it and read just after
        t0 = time.perf_counter()
        scan = drive_scan(args.seed, ws, cli["scene"], ab)
        walls["scan"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dp = drive_dp(args.seed, ws, cli["scene"], best)
        walls["dp"] = time.perf_counter() - t0
        log("resize, error-map, scan and data-parallel phases: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in walls.items()))
    emap_check = small_emap_step_gpu_vs_cpu()
    for name, key in (("vm_sample_fwd", "k4"), ("vm_sample_bwd", "k5")):
        next(r for r in results if r["name"] == name).setdefault(
            "shapes", {}).update({f"resized_{k}": v[key] for k, v in
                                  vm_c2f["kernels"].items()})
    log(f"launches on the A/B path ({AB_TEACHER['iters']} teacher + "
        f"{AB_DISTILL['iters']} distill steps, evals included, "
        f"{ab['wall_s']:.1f} s): {json.dumps(ab_launches)}")
    for name in AB_KERNELS:
        if ab_launches[name] <= 0:
            raise RuntimeError(f"kernel {name} never launched on the A/B "
                               "path")
    log(f"launches on the distill-CLI path ({AB_DISTILL['iters']} steps, "
        f"the final eval, --test and --test_teacher, {cli['wall_s']:.1f} "
        f"s): {json.dumps(cli_launches)}")
    for name in CLI_KERNELS:
        if cli_launches[name] <= 0:
            raise RuntimeError(f"kernel {name} never launched on the "
                               "distill-CLI path")
    if cli_launches["hash_encode"] or cli_launches["build_baked_dense"] != 3:
        raise RuntimeError("the distill-CLI path launched K1 or did not bake "
                           "once per load_teacher")
    c_results, c_extra = check_cell_kernels(tea_ab, scene_ab, gen)
    results += c_results
    ab_flavors = teacher_step_flavors(tea_ab, scene_ab, "cell teacher")
    ab_distill = distill_step_profile(stu_ab, scene_ab, gen)
    ab_batch = ab_batch_cases(stu_ab, scene_ab, gen)
    next(r for r in results if r["name"] == "vm_sample_bwd")["shapes"][
        "ab_stage3"] = ab_batch["k5"]
    cell_check = small_teacher_gpu_vs_cpu(spec_kw=SMALL_CELL_TEA)
    b_results, b_extra = check_bake_kernels(
        tea_ab, gen, cli.pop("test_teacher_chunk_x01"))
    results += b_results
    bake_profiles = bake_step_profiles(stu_ab, scene_ab, gen)
    # ---- main path 13 (phase 17): phase 2's field and the A/B student
    # through a reference checkpoint, the A/B teacher through the
    # stratified renderer and the mesh, a trace, the JPEG fixtures --------
    slice11 = drive_slice11(field, spec, rspec, occ, image0, poses[0], intr,
                            tea_ab, stu_ab, scene_ab)
    del tea_ab, stu_ab, image0

    # ---- main path 5: the large-scene configuration (two cascades, the
    # geometric march, the background model): teacher -> checkpoint ->
    # distill Trainer -> test eval ----------------------------------------
    with tempfile.TemporaryDirectory(prefix="pvd_large_") as ws:
        reset_counters()
        t0 = time.perf_counter()
        tea_ls, stu_ls, scene_ls, ls = drive_large_scene(args.seed, ws)
        ls["wall_s"] = time.perf_counter() - t0
        ls_launches = counters()
    log(f"launches on the large-scene path ({LS_TEACHER['iters']} teacher "
        f"+ {LS_DISTILL['iters']} distill steps, evals included, "
        f"{ls['wall_s']:.1f} s): {json.dumps(ls_launches)}")
    for name in LS_KERNELS:
        if ls_launches[name] <= 0:
            raise RuntimeError(f"kernel {name} never launched on the "
                               "large-scene path")
    if ls_launches["march_rays"]:
        raise RuntimeError("the large-scene path marched with K2")
    l_results, l_extra = check_large_scene_kernels(tea_ls, scene_ls, gen)
    results += l_results
    ls_render = render_large_scene(tea_ls, scene_ls)
    ls_flavors = teacher_step_flavors(tea_ls, scene_ls, "large-scene teacher")
    ls_distill = distill_step_profile(stu_ls, scene_ls, gen, "large-scene")
    ls_checks = {
        "teacher": small_teacher_gpu_vs_cpu(spec_kw=SMALL_LS_TEA,
                                            cfg_kw=SMALL_LS),
        "distill_stage3": small_step_gpu_vs_cpu(large=True)}

    shapes = {
        "hash_encode": {"occupancy_sweep": k1_sweep,
                        "serving_chunk_1x": k1_serving,
                        "exact_teacher_compacted": t_extra.pop(
                            "k1_compacted"),
                        "exact_teacher_padded": t_extra.pop("k1_padded"),
                        "cell_teacher_compacted": c_extra.pop(
                            "k1_compacted"),
                        "hard_inputs": k1_hard},
        "march_rays": {"exact_teacher_train": t_extra.pop("k2_train"),
                       "ab_distill_train": ab_batch["k2"],
                       "hard_inputs": k2_hard},
        "hash_encode_baked_fwd": {"ab_distill_batch": ab_batch["k15"]},
        "hash_encode_cell_fwd": {"ab_distill_replay": ab_batch["k10"]},
        "hash_encode_bwd": {"exact_teacher_padded": t_extra.pop(
                                "hash_encode_bwd_padded"),
                            "cell_teacher_compacted": c_extra.pop(
                                "k7_compacted"),
                            "hard_inputs": k7_hard},
        "composite_rays_compact": {"serving_chunk_16x": k3_16x,
                                   "exact_teacher_compacted": t_extra.pop(
                                       "k3_compacted"),
                                   "hard_inputs": k3_hard}}
    k6_row = next(r for r in results
                  if r["name"] == "composite_rays_compact_bwd")
    k6_row["shapes"].update(cell_teacher_compacted=c_extra.pop(
        "k6_compacted"), ab_stage3=ab_batch["k6"])
    for r in results:
        if r["name"] in shapes:
            r["shapes"] = shapes[r["name"]]
    for name, key in (("composite_rays", "k8_padded"),
                      ("composite_rays_bwd", "k9_padded")):
        next(r for r in results if r["name"] == name)["shapes"].update(
            cell_teacher_padded=c_extra.pop(key),
            large_scene_padded=l_extra.pop(key))
    next(r for r in results if r["name"] == "hash_encode_cell_fwd")[
        "shapes"].update(cell_teacher_padded=c_extra["padded"]["t10"],
                         large_scene_compacted=l_extra["cell_compacted"][
                             "t10"])

    # hard inputs of K6, K8, K9, K16 and K11/K10 and the NaN rule of K7,
    # K12, K13 and K15: checked after every timing, each raising on a case
    # over its tolerance, and folded into its kernel's row
    k6_hard = check_k6_hard_cases(dev)
    k8_hard = check_k8_hard_cases(dev)
    k9_hard = check_k9_hard_cases(dev)
    k16_hard = check_k16_hard_cases(dev)
    nan_rule = check_nan_rule(dev)
    k11_hard = check_k11_hard_cases(dev)
    short = [n for n in RECORDS if n < 20]
    log(f"kernel_ms: {len(RECORDS)} timings, {len(short)} on fewer than 20 "
        f"launch records ({sorted(short)})")
    held = {"hash_encode_cell_bwd": [c["err11"] for c in k11_hard.values()],
            "hash_encode_cell_fwd": [c["err10"] for c in k11_hard.values()],
            "composite_rays_compact_bwd": [c["err"] for c in
                                           k6_hard.values()],
            "composite_rays": [c["err"] for c in k8_hard.values()],
            "composite_rays_bwd": [c["err"] for c in k9_hard.values()],
            "hash_encode_bwd": [nan_rule["k7"]],
            "hash_encode_2d_bwd": [nan_rule["k13"]],
            "hash_encode_2d_fwd": [nan_rule["k12"]],
            "hash_encode_baked_fwd": [nan_rule["k15"]]}
    for r in results:
        if r["name"] in held:  # NaN-free: each check raised on a NaN
            r["err"] = max([r["err"]] + held[r["name"]])
    k6_row["shapes"]["hard_inputs"] = k6_hard
    next(r for r in results if r["name"] == "composite_rays")[
        "shapes"]["hard_inputs"] = k8_hard
    next(r for r in results if r["name"] == "composite_rays_bwd")[
        "shapes"]["hard_inputs"] = k9_hard
    next(r for r in results if r["name"] == "build_baked_dense")[
        "shapes"] = {"hard_specs": k16_hard}
    next(r for r in results if r["name"] == "hash_encode_cell_bwd")[
        "shapes"]["hard_inputs"] = k11_hard

    bad = [r["name"] for r in results if not r["err"] <= r["tol"]]
    for r in results:
        lib = r.get("library_ms")
        log(f"{r['name']} ({r['shape']}): "
            f"{r.get('err_kind', 'max |kernel - plain|')} {r['err']:.3g}"
            f" (tol {r['tol']:g}), kernel {r['ms']:.4f} ms{alone(r)} (call "
            f"{r['call_ms']:.4f} ms), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]})"
            + ("" if lib is None else f", library {lib:.4f} ms "
               f"({r['library_call']})"))
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{bad}")

    def launch_fields(name):
        if name in SERVE_KERNELS:
            f = {"launches": launches[name],
                 "launches_per_image": launches[name] / len(poses)}
        else:
            # the first path that runs it
            f = {"launches": next((n for n in (
                distill_launches[name], teacher_launches[name],
                ab_launches[name], cli_launches[name], ls_launches[name])
                if n), 0)}
        f["launches_cli"] = cli_launches[name]
        f["launches_per_baked_distill_step"] = \
            bake_profiles["baked"]["launches_per_step"].get(name, 0)
        f["launches_large_scene"] = ls_launches[name]
        f["launches_per_large_scene_step"] = {
            "teacher_" + flv: v["launches_per_step"].get(name, 0)
            for flv, v in ls_flavors.items()}
        f["launches_per_large_scene_step"]["distill_stage3"] = \
            ls_distill["launches_per_step"].get(name, 0)
        f["launches_ab"] = ab_launches[name]
        f["launches_per_ab_step"] = {
            "teacher_" + flv: v["launches_per_step"].get(name, 0)
            for flv, v in ab_flavors.items()}
        f["launches_per_ab_step"]["distill_stage3"] = \
            ab_distill["launches_per_step"].get(name, 0)
        f["launches_distill"] = distill_launches[name]
        f["launches_per_distill_step"] = distill_launches[name] / n_steps
        f["launches_teacher"] = teacher_launches[name]
        f["launches_per_teacher_step"] = {
            flv: v["launches_per_step"].get(name, 0)
            for flv, v in flavors.items()}
        f["launches_teacher_cli"] = tea_cli["launches"][name]
        f["launches_new_fields"] = {k: v["launches"][name]
                                    for k, v in fields.items()}
        per = {f"teacher_cli_{flv}": tea_cli["step_profiles"][flv][
            "launches_per_step"].get(name, 0)
            for flv in ("padded", "compacted")}
        for k, v in fields.items():
            if "step_profiles" in v:
                per.update({f"{k}_{flv}": v["step_profiles"][flv][
                    "launches_per_step"].get(name, 0)
                    for flv in ("padded", "compacted")})
            else:
                per[f"{k}_stage3"] = v["step_profile"][
                    "launches_per_step"].get(name, 0)
        f["launches_per_new_path_step"] = per
        f["launches_slice11"] = {k: v[name] for k, v in
                                 slice11["launches"].items()}
        f["launches_resize_emap"] = {
            "vm_c2f_teacher": vm_c2f["launches"]["teacher"][name],
            "vm_c2f_student": vm_c2f["launches"]["student"][name],
            "c2f_plenoxel": c2f["launches"][name],
            "emap_teacher": emap["launches"]["teacher"][name],
            "emap_student": emap["launches"]["student"][name]}
        f["launches_per_resize_emap_step"] = {
            **{f"vm_c2f_teacher_{flv}": v["launches_per_step"].get(name, 0)
               for flv, v in vm_c2f["teacher"]["step_profiles"].items()},
            "vm_c2f_student_stage3": vm_c2f["student"]["step_profile"][
                "launches_per_step"].get(name, 0),
            "c2f_plenoxel_stage3": c2f["step_profile"][
                "launches_per_step"].get(name, 0),
            "emap_teacher_compacted": emap["teacher"]["step_profile"][
                "launches_per_step"].get(name, 0),
            "emap_student_stage3": emap["student"]["step_profile"][
                "launches_per_step"].get(name, 0)}
        return f

    def brief(prof):
        return {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                     "device_busy_share", "ours")}

    line = {"kernels": [{
        "name": r["name"], "route": "cuda", "source": r["source"],
        "replaces": r["replaces"], **launch_fields(r["name"]),
        "max_abs_err": r.get("abs_err", r["err"]),
        "max_abs_diff": r.get("abs_err", r["err"]), "tol_err": r["err"],
        "tol": r["tol"],
        "ms": r["ms"], "kernel_ms": r.get("kernel_ms"),
        "call_ms": r["call_ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
        "library_ms": r.get("library_ms"),
        "library_call": r.get("library_call"), "shape": r["shape"],
        **{k: r[k] for k in ("variant", "cases", "lanes", "shapes")
           if k in r}}
        for r in results],
        "vm_projection_bwd": {"distill_step": vm_proj,
                              "ab_stage3": ab_batch["vm_projection"]},
        "sweep_ms": sweep_ms, "images": images, "build_s": build_s,
        "e2e_max_abs_diff": e2e_err, "profile": brief(prof),
        "distill": {"stages": stages, "profile_stage3": brief(prof_d),
                    "gpu_vs_cpu_step": step_check,
                    "fixed_batch_losses": descent},
        "teacher": {**teacher, "kernel_extra": t_extra,
                    "profiles": {k: brief(v["profile"])
                                 for k, v in flavors.items()},
                    "gpu_vs_cpu_step": teacher_check},
        "ab_recipe": {**ab, "launches": ab_launches, "cell_kernels": c_extra,
                      "teacher_profiles": {
                          k: brief(v["profile"])
                          for k, v in ab_flavors.items()},
                      "distill_stage3_profile": brief(ab_distill["profile"]),
                      "cell_gpu_vs_cpu_step": cell_check},
        "distill_cli": {**cli, "launches": cli_launches,
                        "bake_kernels": b_extra,
                        "stage3_profiles": {
                            k: {"launches_per_step": v["launches_per_step"],
                                "teacher_encode_ms": v["teacher_encode_ms"],
                                **brief(v["profile"])}
                            for k, v in bake_profiles.items()}},
        "large_scene": {**ls, "launches": ls_launches,
                        "kernels": l_extra, "render_800": ls_render,
                        "teacher_profiles": {
                            k: brief(v["profile"])
                            for k, v in ls_flavors.items()},
                        "distill_stage3_profile": brief(
                            ls_distill["profile"]),
                        "gpu_vs_cpu_steps": ls_checks},
        "teacher_cli": {**{k: v for k, v in tea_cli.items()
                           if k != "step_profiles"},
                        "step_profiles": {
                            flv: brief(tea_cli["step_profiles"][flv][
                                "profile"])
                            for flv in ("padded", "compacted")}},
        "new_fields": {"wall_s": fields_wall_s, **{
            k: {**{kk: vv for kk, vv in v.items()
                   if kk not in ("step_profiles", "step_profile")},
                "profiles": ({flv: brief(v["step_profiles"][flv]["profile"])
                              for flv in ("padded", "compacted")}
                             if "step_profiles" in v else
                             {"stage3": brief(v["step_profile"]["profile"])})}
            for k, v in fields.items()}},
        "vm_c2f": {
            "wall_s": walls["vm_c2f"],
            "teacher": {**{k: v for k, v in vm_c2f["teacher"].items()
                           if k != "step_profiles"}, "profiles": {
                flv: brief(v["profile"]) for flv, v in
                vm_c2f["teacher"]["step_profiles"].items()}},
            "student": {**{k: v for k, v in vm_c2f["student"].items()
                           if k != "step_profile"}, "profile": brief(
                vm_c2f["student"]["step_profile"]["profile"])},
            "kernels": vm_c2f["kernels"]},
        "c2f_plenoxel": {**{k: v for k, v in c2f.items()
                            if k != "step_profile"},
                         "wall_s": walls["c2f_plenoxel"],
                         "profile": brief(c2f["step_profile"]["profile"])},
        "emap_ema": {
            "wall_s": walls["emap_ema"],
            "teacher": {**{k: v for k, v in emap["teacher"].items()
                           if k != "step_profile"}, "profile": brief(
                emap["teacher"]["step_profile"]["profile"])},
            "student": {**{k: v for k, v in emap["student"].items()
                           if k != "step_profile"}, "profile": brief(
                emap["student"]["step_profile"]["profile"])},
            "gpu_vs_cpu_step": emap_check},
        "scan": {"wall_s": walls["scan"], **scan},
        "dp": {"wall_s": walls["dp"], **dp},
        "nan_rule": nan_rule, "slice11": slice11,
        "card": card, "wall_s": time.perf_counter() - t_script}
    log(f"chip_smoke wall {line['wall_s']:.1f} s (kernel build included)")
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
