#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``alphasurf_torch/csrc`` (K1 occupancy,
K2 phase A count + fill, K3 phase B, K4 compositor, K5 backward per ray and
per entry, K6 regularizers TV / normal / sparsify, K7 RMSprop, K1d density
occupancy, K8 cuvol forward and backward (also with the depth and log_T
cotangents), K10 dense cuvol march and its backward, K9a keep
masks, K9b lattice resample, K9c weight march, K9d visibility walk, K9e
transmittance march, K9f mask sweep, K9g iso points, K4's sigma-thresh
depth and intersect_points, K11a dense walk count + fill, K11b capped
fill, K11c the first-K cache in K4, K11d its gradient in K5, K12a-K12d the
extended surface regularizers, K12e the lumisphere TV, K12f the background
TV, K13 the MSI background forward and backward, K12g the learned texture's
TV, K5b's and K8's per-ray basis gradient, K14 the compat marches nvol and
svox1 forward and backward, and the surface types' branches of K1, K3,
K4, K5b and K6), then:

1. prints the card, its power limit, nvcc's register/spill lines and the
   build seconds;
2. holds every kernel against its plain PyTorch version on the card, at the
   shapes of the main paths (the 512^3 shell grid, one 16,384-ray chunk of
   an 800x800 orbit frame; K1 also at 128^3), and times both with CUDA
   events: K5's gradients against autograd of the plain renderer (on the
   chunk and on the 512^3 surface step's 40,960-ray batch), K4 with
   the sigma-thresh depth and its live flags and intersect_points on the
   same chunk, K6 on sampled windows of the 512^3 grid and in its
   every-cell mode at 128^3, K7 on the 512^3 parameter arrays;
3. serving: writes a 512^3, basis_dim=9 shell-grid checkpoint (density and
   SH drawn from a numpy seed) and serves two 800x800 frames of it through
   ``alphasurf_torch.app.render_circle.main``, with every launch counter
   set to 0 just before and read just after; checks the frames against the
   plain path on their central rays; profiles one more frame;
4. training: one train step with the kernels against one step of the plain
   versions (on a CPU copy) at 128^3; then
   ``alphasurf_torch.app.bench_step.main`` at full width (512^3, batch
   40960, 1 + 33 steps) with the counters set to 0 just before and read
   just after; then one profiled train step;
5. the Plenoxels warm start: K1d, K8 forward, K8 backward (against
   autograd of the plain cuvol renderer; also with depth and log_T
   cotangents), K10 and its backward (per-ray background colours with
   depth and log_T cotangents) against their plain versions on a
   256^3 blobby density grid (basis_dim 9), one 16,384-ray chunk of an
   800x800 frame; K8 on long rays (1,024 rays of the warm step's own
   256^3 grid and batch, ~250 entries a ray: the forward and its four
   backward instantiations against the plain version) and timed at the
   step's full 40,960-ray batch; the cuvol step with the kernels against
   the plain step on a CPU copy at 128^3, packed, dense and without occupancy;
   ``alphasurf_torch.app.bench_step.main --stage cuvol`` at 256^3, batch
   40960, packed and ``--renderer dense``; a batch's gradient through each
   cuvol renderer with cotangents on all three outputs; then the Trainer through
   ``alphasurf_torch.app.train.main`` on the synthetic dataset (20 train and
   2 test views at 800x800), 256^3, the Config defaults otherwise, 40
   steps and a final eval whose PSNR must beat the untrained grid's, with
   the counters set to 0 just before and read just after; then one
   profiled cuvol step, packed and dense;
6. the stage transitions: K9a-K9d against their plain versions at the
   slice's shapes (a 256^3 -> 256^3 weight-threshold resample of the
   blobby grid with one 800x800 camera, init_surface_from_density on it
   with two cameras, a 256^3 -> 512^3 resample_surface with the level-set
   band and max_elements 6,000,000), each timed; then the three stages of
   tools/recipe_run.py (256^3 cuvol, 256^3 surface, 512^3 surface, with
   the weight threshold and visibility pruning on) through
   ``alphasurf_torch.app.train.main``, with the counters set to 0 just
   before and read just after: every kernel K1-K10 launched, every stage's
   mse finite, every transition logged with capacity and seconds, no loss
   of occupied voxels at the 512^3 upsample, a final eval PSNR above the
   untrained grid's, and a finite Chamfer (the in-training extraction,
   log_pts and eval_cf) on every surface-stage eval, printed beside the
   GT grid's own;
7. extraction and evaluation: K9g against its plain version on every
   occupied cell of the 512^3 shell checkpoint (the points on the shell's
   sphere to 0.1 voxel), K9e against its plain version on the 256^3
   blobby grid with two 800x800 cameras (and the weight init on both
   maxima), each timed; ``app/extract_points.main`` and
   ``app/eval_cf.main`` on the shell (Chamfer below 0.01); then
   ``app/pipeline.run_pipeline`` at 256^3 (20 train and 2 test views at
   800x800, 60 + 60 steps, the weight init of the surface stage at the
   recipe's surface learning rate) with
   the counters set to 0 just before and read just after: every kernel
   of its path launched, a PSNR above the untrained grid's, points and a
   finite Chamfer;
8. the DTU masked-capture path: K9f against its plain version on one
   16,384-ray chunk of a 1600x1200 view of the 256^3 blobby grid, timed;
   a DTU-format scan written by the port (6 views at 1600x1200 of
   make_gt_grid(256), PNG images and masks, cameras_sphere.npz); then,
   with the counters set to 0 just before and read just after,
   ``alphasurf_torch.app.train.main`` on it with dataset_type dtu (the
   warm start, the density resample, init_surface_from_density with mask
   pruning over all 30.7M training rays, the surface stage), app/
   extract_points with --mesh, extract_points_cam and extract_points_depth
   on two views, and app/eval_dtu on each extractor's points: every kernel
   of the path launched, a PSNR above the untrained grid's, a finite DTU
   Chamfer for each extractor; the mask sweep profiled;
9. the compact and dense renderers: K11a-K11d against their plain
   versions on a 16,384-ray chunk of the 512^3 shell (the pools bit for
   bit, K11d through the compact renderer's gradient with both cache
   losses), each timed; then, each with the counters set to 0 just before
   and read just after, two 800x800 frames through render_image with the
   packed, compact and dense renderers (compact equal to packed where no
   ray has more than K crossings, dense within DENSE_ATOL), bench_step
   --renderer compact and dense at full width with a profiled step each,
   and app/train.main with the two-pass losses on the compact renderer
   (two_pass_config: its warm start through K10 and its backward, as
   JAX's; cache losses finite and non-zero on every surface step, a PSNR
   above the untrained grid's, a finite Chamfer);
10. the Blender (NeRF-synthetic) path and the extended surface
   regularizers: K12a-K12d against their plain versions on the 512^3
   shell (bench_step's 0.01 window, timed, and every present row); one
   train step with all four on against the plain step at 128^3 and
   bench_step's protocol with them at full width, with a profiled step;
   a Blender-layout scene written by the script (make_gt_grid(256)
   through the dense walk, 40 train and 8 test RGBA views at 800x800,
   nerf_synthetic's camera angle); then, with the counters set to 0 just
   before and read just after, app/pipeline.run_pipeline with
   dataset_type nerf on it at 256^3 (K12d through the Trainer's
   lambda_surface_eikonal; a test PSNR from render_imgs above the
   untrained grid's, a finite Chamfer against the scene's GT points);
   app/eval_imgs and app/debug_render on its checkpoint;
11. a Tanks-and-Temples-style capture with an MSI background: an
   NSVF-layout scene written by the script (12 train and 2 test RGB views
   at 1920x1080, cameras at radius 0.95 inside the 256^3 foreground grid
   after the loader's normalisation, a sphere of 0.25 inside, a 64-layer
   MSI at reso 1024, 2.15 GB, behind); K13 forward and backward, K12e and
   K12f against their plain versions at the background's full size, K4,
   K5a, K8 and K10 with per-ray colours; bench_step's protocol with the
   background group (K13, K12e, K12f, K7 on its rows) and a profiled step;
   then, with the counters set to 0 just before and read just after,
   app/train.main on it with dataset_type nsvf (resumed from a checkpoint
   holding the ground-truth MSI: the warm start, init_surface and the
   surface stage, 30 + 30 steps) and app/render_imgs on the test split,
   beside the same run without a background (the run with it must score
   higher); one 1920x1080 frame through app/render_circle from each;
12. the learned bases: K12g against its plain version on the 32^3 x 9
   texture; K5b's, K8's and K10's sh_mult output against autograd of the
   plain renderers (the 512^3 shell chunk, the 256^3 blobby chunk, the texture),
   their null-pointer paths bit for bit equal to the output's path on
   entries or rays whose rows nothing else touches, each timed with and
   without the output; the MLP basis on the card against float64; a
   surface step with the texture against the plain step at 128^3; then,
   with the counters set to 0 just before and read
   just after, bench_step's protocol with the texture and with the MLP, the
   cuvol step at 256^3 with the texture, and two 800x800 frames through
   app/render_circle from a 512^3 checkpoint with each basis (the texture's
   within BASIS_TEX_MAX of the SH frames);
13. the compat marches: K14 forward and backward, nvol and svox1, against
   their plain versions on a 16,384-ray chunk of the 256^3 blobby grid;
   then, with the counters set to 0 just before and read just after, an
   800x800 frame and a chunk's gradient through volume_render in each
   mode; to_svox1_npz of the grid's shell, reloaded and walked;
14. the other surface types (PLANE, UDF, UDF_ALPHA, UDF_FAKE_SAMPLE,
   VOXEL_FACE), each on create_grid(256, its initialiser, the sphere
   bound, basis_dim 9) with SH from a seed: its branches of K1, K3 (and
   K4 on its slots), K5b and, for UDF_ALPHA's one-per-level-set alpha
   table, K6 against their plain versions on a 16,384-ray chunk, each
   timed; then, with the counters set to 0 just before and read just
   after, two 800x800 frames through app/render_circle and bench.py's
   protocol (1 + 33 steps of 40960 rays) through make_surface_step, with
   finite, falling losses; then app/train.main with surface_type udf after
   a 256^3 warm start (train_udf.sh's shape), its eval PSNR above the
   untrained grid's;
15. prints one JSON line with each kernel's numbers, then the ok line.

``--phases`` runs a subset (kernels, serve, train, warm, stages,
extract, dtu, renderers, blender, tnt, basis, compat, types); the default runs
them all, as the checks above require. Exits non-zero, printing no result,
without a CUDA device or without the ``alphasurf_torch`` package beside
it. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import gc
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
RESO = 512
SMALL_RESO = 128  # K1's second grid, one of K6's every-cell checks, the step check
ODD_RESO = 130  # K1's grid with Z % 4 != 0 (its scalar loads)
WIDTH = HEIGHT = 800
CHUNK = 16384
STEP_BATCH = 4096  # rays of the kernel-against-plain train step
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

# Tolerances of kernel against plain version, both float32 on the card.
# K1 and K2 compute integer results from the same float comparisons, and
# the sources are built with --fmad=false, so they must be equal. K3 and K4
# use the device libm (acosf, cosf, powf, expf, logf) like PyTorch's CUDA
# ops but sum in other orders, so values agree to float32 rounding carried
# through the cubic roots and the per-ray sums: rtol 1e-4 / atol 1e-5 on
# values of order 1, relative on depths and loss sums. Mode and median depth
# pick one sample; a near-tie of two weights may pick another, so at most
# 1e-3 of the rays may differ there. A root within rounding of a voxel face
# may land on either side, so at most 1e-5 of K3's slot flags may differ.
RTOL, ATOL = 1e-4, 1e-5
SELECT_FRACTION = 1e-3
FLAG_FRACTION = 1e-5
# K5 against autograd of the plain renderer, both float32 on the card: the
# gradients are sums in other orders (atomics against autograd's scatter)
# of products through float32 roots, so each parameter group agrees to
# |g_k - g_p| <= GRAD_REL |g_p| in norm, and at most GRAD_ROW_FRACTION of
# the rows either touches may differ elementwise by more than
# GRAD_ATOL + GRAD_RTOL |g_p|.
GRAD_REL, GRAD_ROW_FRACTION, GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4, 1e-3, 1e-6
# K13's backward: a background row sums the contributions of up to 130 steps
# of many rays, each through exp(log_T) with log_T down to -40, and its
# gradients reach 1e2; the plain float32 version is itself 2.7e-5 of the
# largest gradient away from a float64 reference (a 2,048-ray chunk at 64
# layers, reso 128, on the CPU), and the kernel as far. So its elementwise
# floor is BG_GRAD_ATOL_REL of the plain version's largest gradient.
BG_GRAD_ATOL_REL = 1e-4
# K12e and K12f over every cell: each row's gradient sums the terms of its
# own cell and its 3 neighbours' (TV differences of a smooth field), which
# cancel to ~1e-3 of themselves, so the float32 rounding of the terms is
# ~1e-4 of the sum (2.3e-4 of the norm for K12e at 256^3 on the H100, with
# no row outside GRAD_RTOL / GRAD_ATOL); on a window the terms of most rows
# do not cancel and GRAD_REL holds
DENSE_TV_GRAD_REL = 1e-3
# K6: the same per-cell arithmetic in the same order; the loss is a float32
# sum over cells in another order (rtol 1e-5), the row gradients sums of at
# most 20 contributions in another order.
REG_LOSS_RTOL, REG_REL = 1e-5, 1e-5
# K7: elementwise, the same float32 operations in the same order
RMS_RTOL = 1e-6

# the JAX package: named for the "replaces" paths and the import check, and
# never imported
JAX_PACKAGE = "alphasurf_tpu"
_JAX_SURFACE = f"{JAX_PACKAGE}/render/surface.py"
_JAX_REG = f"{JAX_PACKAGE}/losses/reg.py"
_JAX_CUVOL = f"{JAX_PACKAGE}/render/cuvol.py"
_JAX_TOPO = f"{JAX_PACKAGE}/core/topology_device.py"
_JAX_COMPAT = f"{JAX_PACKAGE}/render/compat.py"
KERNELS = {  # name -> (source, the JAX routine it replaces)
    "occupancy": ("alphasurf_torch/csrc/occupancy.cu", f"{_JAX_SURFACE}:1149"),
    "phase_a_count": ("alphasurf_torch/csrc/phase_a.cu", f"{_JAX_SURFACE}:1652"),
    "phase_a_fill": ("alphasurf_torch/csrc/phase_a.cu", f"{_JAX_SURFACE}:1652"),
    "phase_b": ("alphasurf_torch/csrc/phase_b.cu", f"{_JAX_SURFACE}:469"),
    "composite": ("alphasurf_torch/csrc/composite.cu", f"{_JAX_SURFACE}:1804"),
    # K5 replaces jax.grad of the packed renderer: K5a the compositor's
    # backward, K5b the samples' backward with the root JVP of ops/cubic.py
    "backward_ray": ("alphasurf_torch/csrc/backward.cu", f"{_JAX_SURFACE}:1804"),
    "backward_entry": ("alphasurf_torch/csrc/backward.cu", f"{JAX_PACKAGE}/ops/cubic.py:230"),
    "reg_tv": ("alphasurf_torch/csrc/reg.cu", f"{_JAX_REG}:126"),
    "reg_normal": ("alphasurf_torch/csrc/reg.cu", f"{_JAX_REG}:202"),
    "reg_sparsify": ("alphasurf_torch/csrc/reg.cu", f"{_JAX_REG}:305"),
    "rmsprop": ("alphasurf_torch/csrc/rmsprop.cu", f"{JAX_PACKAGE}/optim/rmsprop.py:26"),
    "density_occupancy": ("alphasurf_torch/csrc/occupancy.cu", f"{_JAX_CUVOL}:30"),
    # K8: the packed cuvol renderer and jax.grad of it
    "cuvol_forward": ("alphasurf_torch/csrc/cuvol.cu", f"{_JAX_CUVOL}:79"),
    "cuvol_backward": ("alphasurf_torch/csrc/cuvol.cu", f"{_JAX_CUVOL}:79"),
    "cuvol_march": ("alphasurf_torch/csrc/cuvol.cu", f"{_JAX_CUVOL}:297"),
    "cuvol_backward_out": ("alphasurf_torch/csrc/cuvol.cu", f"{_JAX_CUVOL}:79"),
    # K10's backward: jax.grad of the dense march
    "cuvol_march_backward": ("alphasurf_torch/csrc/cuvol.cu", f"{_JAX_CUVOL}:297"),
    # K9a-K9d: the stage transitions (core/topology_device.py, core/weight_render.py)
    "keep_mask": ("alphasurf_torch/csrc/topology.cu", f"{_JAX_TOPO}:110"),
    "prune_mask": ("alphasurf_torch/csrc/topology.cu", f"{_JAX_TOPO}:223"),
    "lv_band": ("alphasurf_torch/csrc/topology.cu", f"{_JAX_TOPO}:122"),
    "resample_dense": ("alphasurf_torch/csrc/topology.cu", f"{_JAX_TOPO}:104"),
    "resample_rows": ("alphasurf_torch/csrc/topology.cu", f"{_JAX_TOPO}:167"),
    "weight_march": ("alphasurf_torch/csrc/sweep.cu", f"{JAX_PACKAGE}/core/weight_render.py:97"),
    "visibility": ("alphasurf_torch/csrc/sweep.cu", f"{JAX_PACKAGE}/core/weight_render.py:270"),
    # K9e (surf_init_type "weight") and K9g: extraction and evaluation
    "transmit_march": ("alphasurf_torch/csrc/sweep.cu",
                       f"{JAX_PACKAGE}/core/weight_render.py:160"),
    "iso_points": ("alphasurf_torch/csrc/extract.cu", f"{JAX_PACKAGE}/geometry/extract.py:46"),
    # the DTU path: K9f (mask pruning) and K3/K4's two output options
    "mask_march": ("alphasurf_torch/csrc/sweep.cu", f"{JAX_PACKAGE}/core/weight_render.py:231"),
    "composite_sigma_thresh": ("alphasurf_torch/csrc/composite.cu", f"{_JAX_SURFACE}:1902"),
    "intersect_points": ("alphasurf_torch/csrc/composite.cu", f"{_JAX_SURFACE}:1999"),
    # K11: the dense walk's voxel list (K11a), the first K occupied
    # crossings (K11b), the first-K sample cache (K11c) and its gradient (K11d)
    "dense_walk_count": ("alphasurf_torch/csrc/phase_a.cu", f"{_JAX_SURFACE}:1092"),
    "dense_walk_fill": ("alphasurf_torch/csrc/phase_a.cu", f"{_JAX_SURFACE}:1092"),
    "compact_fill": ("alphasurf_torch/csrc/phase_a.cu", f"{_JAX_SURFACE}:1284"),
    "composite_cache": ("alphasurf_torch/csrc/composite.cu", f"{_JAX_SURFACE}:951"),
    "backward_cache": ("alphasurf_torch/csrc/backward.cu", f"{_JAX_SURFACE}:1955"),
    # K12a-K12d: the extended surface regularizers
    "reg_norm_match": ("alphasurf_torch/csrc/reg.cu", f"{_JAX_REG}:569"),
    "reg_viscosity": ("alphasurf_torch/csrc/reg.cu", f"{_JAX_REG}:599"),
    "reg_sign_change": ("alphasurf_torch/csrc/reg.cu", f"{_JAX_REG}:630"),
    "reg_eikonal": ("alphasurf_torch/csrc/reg.cu", f"{_JAX_REG}:791"),
    "reg_lumisphere": ("alphasurf_torch/csrc/reg.cu", f"{_JAX_REG}:734"),
    "reg_background_tv": ("alphasurf_torch/csrc/reg.cu", f"{_JAX_REG}:673"),
    "background_forward": ("alphasurf_torch/csrc/background.cu",
                           f"{JAX_PACKAGE}/render/background.py:32"),
    "background_backward": ("alphasurf_torch/csrc/background.cu",
                            f"{JAX_PACKAGE}/render/background.py:32"),
    "reg_basis_tv": ("alphasurf_torch/csrc/reg.cu", f"{_JAX_REG}:717"),
    "backward_entry_basis": ("alphasurf_torch/csrc/backward.cu",
                             f"{JAX_PACKAGE}/core/sh.py:112"),
    "cuvol_backward_basis": ("alphasurf_torch/csrc/cuvol.cu", f"{_JAX_CUVOL}:122"),
    "compat_forward_nvol": ("alphasurf_torch/csrc/compat.cu", f"{_JAX_COMPAT}:58"),
    "compat_backward_nvol": ("alphasurf_torch/csrc/compat.cu", f"{_JAX_COMPAT}:58"),
    "compat_forward_svox1": ("alphasurf_torch/csrc/compat.cu", f"{_JAX_COMPAT}:115"),
    "compat_backward_svox1": ("alphasurf_torch/csrc/compat.cu", f"{_JAX_COMPAT}:115"),
    # the outputs' cotangents: jax.grad of the compositor through depth,
    # normal, log_T, the picked depths and the intersections (K5a), of the
    # samples through the normal (K5b), of the compat marches through depth
    # and acc (K14); return_samples' walk steps (K11a) and truncated alphas (K4)
    "backward_ray_out": ("alphasurf_torch/csrc/backward.cu", f"{_JAX_SURFACE}:1842"),
    "backward_entry_out": ("alphasurf_torch/csrc/backward.cu", f"{_JAX_SURFACE}:626"),
    "compat_backward_out_nvol": ("alphasurf_torch/csrc/compat.cu", f"{_JAX_COMPAT}:58"),
    "compat_backward_out_svox1": ("alphasurf_torch/csrc/compat.cu", f"{_JAX_COMPAT}:115"),
    "dense_walk_fill_steps": ("alphasurf_torch/csrc/phase_a.cu", f"{_JAX_SURFACE}:990"),
    "composite_samples": ("alphasurf_torch/csrc/composite.cu", f"{_JAX_SURFACE}:990"),
}
# the surface types' branches of K1, K3 and K5b (kernels.TYPE_NAMES), each at
# the JAX lines of its branch, and K6 on UDF_ALPHA's density table
_TYPE_LINES = {  # type -> (voxel_occupancy, _voxel_samples_T) lines of its branch
    "plane": (1221, 590), "udf": (1179, 534), "udf_alpha": (1171, 646),
    "udf_fake_sample": (1203, 754), "voxel_face": (1221, 556),
}
for _t, (_k1, _k3) in _TYPE_LINES.items():
    KERNELS[f"occupancy_{_t}"] = ("alphasurf_torch/csrc/occupancy.cu", f"{_JAX_SURFACE}:{_k1}")
    KERNELS[f"phase_b_{_t}"] = ("alphasurf_torch/csrc/phase_b.cu", f"{_JAX_SURFACE}:{_k3}")
    KERNELS[f"backward_entry_{_t}"] = ("alphasurf_torch/csrc/backward.cu", f"{_JAX_SURFACE}:{_k3}")
# K5b's normal branches of the types whose samples carry a normal: PLANE's
# mean plane (590-606), the UDF types' softplus corners (533-534)
OUT_TYPES = ("plane", "udf", "udf_fake_sample")
for _t in OUT_TYPES:
    KERNELS[f"backward_entry_out_{_t}"] = ("alphasurf_torch/csrc/backward.cu",
                                           f"{_JAX_SURFACE}:{_TYPE_LINES[_t][1]}")
KERNELS["reg_sparsify_table"] = ("alphasurf_torch/csrc/reg.cu", f"{_JAX_REG}:305")
TYPE_KERNELS = tuple(k for k in KERNELS if k.endswith(tuple(f"_{t}" for t in _TYPE_LINES))
                     or k.endswith("_table"))
SERVE_KERNELS = ("occupancy", "phase_a_count", "phase_a_fill", "phase_b", "composite")
TRAIN_KERNELS = SERVE_KERNELS + ("backward_ray", "backward_entry", "reg_tv", "reg_normal",
                                 "reg_sparsify", "rmsprop")
WARM_STEP_KERNELS = ("density_occupancy", "phase_a_count", "phase_a_fill", "cuvol_forward",
                     "cuvol_backward", "reg_tv", "rmsprop")
WARM_KERNELS = WARM_STEP_KERNELS + ("cuvol_march",)
WARM_NEW_KERNELS = ("density_occupancy", "cuvol_forward", "cuvol_backward", "cuvol_march")
# the warm start of a compact or dense run: K10 with its checkpoints and its
# backward
WARM_DENSE_STEP_KERNELS = ("cuvol_march", "cuvol_march_backward", "reg_tv", "rmsprop")
STAGE_KERNELS = ("keep_mask", "prune_mask", "lv_band", "resample_dense", "resample_rows",
                 "weight_march", "visibility")
EXTRACT_KERNELS = ("transmit_march", "iso_points")
DTU_KERNELS = ("mask_march", "composite_sigma_thresh", "intersect_points")
RENDERER_KERNELS = ("dense_walk_count", "dense_walk_fill", "compact_fill", "composite_cache",
                    "backward_cache")
EXTENDED_KERNELS = ("reg_norm_match", "reg_viscosity", "reg_sign_change", "reg_eikonal")
BACKGROUND_KERNELS = ("background_forward", "background_backward", "reg_lumisphere",
                      "reg_background_tv")
BASIS_KERNELS = ("reg_basis_tv", "backward_entry_basis", "cuvol_backward_basis")
COMPAT_KERNELS = ("compat_forward_nvol", "compat_backward_nvol", "compat_forward_svox1",
                  "compat_backward_svox1", "compat_backward_out_nvol", "compat_backward_out_svox1")
# K10's backward (the warm start of a compact or dense run) and K8's
# depth/log_T cotangents
CUVOL_GRAD_KERNELS = ("cuvol_march_backward", "cuvol_backward_out")
# the surface renderers' second instantiations of K5 and return_samples'
# outputs (K14's second instantiation is among COMPAT_KERNELS, K5b's type
# branches of it among TYPE_KERNELS)
OUT_PATH_KERNELS = ("backward_ray_out", "backward_entry_out", "dense_walk_fill_steps",
                    "composite_samples")
# the three-stage run initialises its surface from the density: every kernel
# but K9e, the DTU path's, the compact and dense renderers', K12's, K13's,
# the learned bases', K14's and CUVOL_GRAD_KERNELS
STAGE_RUN_KERNELS = tuple(k for k in KERNELS if k not in ("transmit_march",) + DTU_KERNELS
                          + RENDERER_KERNELS + EXTENDED_KERNELS + BACKGROUND_KERNELS
                          + BASIS_KERNELS + COMPAT_KERNELS + TYPE_KERNELS + CUVOL_GRAD_KERNELS
                          + OUT_PATH_KERNELS)
# the pipeline: the Plenoxels stage and its eval, the weight init with
# visibility pruning, the surface stage, the extraction
PIPELINE_KERNELS = TRAIN_KERNELS + WARM_NEW_KERNELS + (
    "prune_mask", "keep_mask", "visibility", "transmit_march", "iso_points",
    "dense_walk_count", "dense_walk_fill")  # K11a renders the dataset's ground truth
# the DTU path: the three stages with mask pruning at the surface init,
# the extractors: every kernel but K9e, the compact and dense renderers',
# K12's, K13's, the learned bases', K14's and CUVOL_GRAD_KERNELS
DTU_PATH_KERNELS = tuple(k for k in KERNELS if k not in ("transmit_march",) + RENDERER_KERNELS
                         + EXTENDED_KERNELS + BACKGROUND_KERNELS + BASIS_KERNELS
                         + COMPAT_KERNELS + TYPE_KERNELS + CUVOL_GRAD_KERNELS
                         + OUT_PATH_KERNELS)
PHASES = ("kernels", "serve", "train", "warm", "stages", "extract", "dtu", "renderers", "blender",
          "tnt", "basis", "compat", "types")
CUVOL_RESO = 256  # the warm start's grid (the Config's first reso)
WARM_STEPS = 40  # Trainer steps of the warm-start run (cut from 100 for time)
TRAIN_BATCH = 40960
# the loss of the K5 check: the bench loss (mse against 0.5, bench.py's
# l_entropy weight) plus small weights on every other ray loss that carries
# a gradient, so that each branch of the backward runs
K5_LAMBDAS = {"l_dist": 1e-4, "l_dist_a": 1e-4, "l_entropy": 1e-4, "l_entropy_a": 1e-4,
              "sp_logsig": 1e-6, "sp_logsig_w": 1e-6, "l_inward": 1e-4, "lap_sum": 1e-5}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps calls, by CUDA events, after one
    warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def shell_grid(reso: int, device, seed: int = SEED):
    """bench.py's sparse sphere-shell SDF grid with raw alpha in [0.5, 3]
    and a smooth SH colour field from ``seed``, and its row coords
    (app/bench_k34.shell_grid)."""
    from alphasurf_torch.app.bench_k34 import shell_grid as k34_shell_grid

    return k34_shell_grid(reso, device, seed)


def frame_camera(i: int, n_frames: int):
    """render_circle's camera of frame i (its default elevation, radius, fx)."""
    from alphasurf_torch.core.rays import Camera
    from alphasurf_torch.data.synthetic import pose_spherical

    return Camera.make(pose_spherical(360.0 * i / n_frames, 30.0, 2.7), fx=1.2 * WIDTH,
                       width=WIDTH, height=HEIGHT)


def chunk_inputs(grid, opt, rays):
    """The phase-A inputs of one chunk, as volume_render_surface_packed
    prepares them."""
    import torch

    from alphasurf_torch.render import surface as S

    origins, dirs, sh_mult, tnear, tmax, ngt, ray_ok, _ = S._prep(grid, rays, opt)
    tn = torch.where(ray_ok, tnear, torch.zeros_like(tnear))
    tx = torch.where(ray_ok, tmax, torch.full_like(tmax, -1.0))
    return origins, dirs, sh_mult, tn, tx, ngt


def allclose_err(a, b, rtol=RTOL, atol=ATOL):
    """(max abs error, fraction of elements outside atol + rtol*|b|)."""
    a, b = a.double(), b.double()
    if a.numel() == 0:
        return 0.0, 0.0
    d = (a - b).abs()
    bad = d > atol + rtol * b.abs()
    return float(d.max()), float(bad.float().mean())


def check_phase_a(grid, words, origins, dirs, tn, tx, label: str = "chunk"):
    """K2 count + fill against the plain version: the same pool element for
    element in pool order and after a (ray, t, l) sort, the same offsets
    and n_occupied. Returns the plain pool."""
    from alphasurf_torch.app import bench_k2
    from alphasurf_torch.render import surface as S

    pool_k = bench_k2.kernel_pool(grid.reso, origins, dirs, tn, tx, words)
    pool_p = S._compact_crossings_plain(grid.reso, origins, dirs, tn, tx, words)
    same = bench_k2.compare_pools(pool_k, pool_p)
    if not (same["in_order"] and same["sorted"] and same["offsets"] and same["n_occupied"]):
        raise AssertionError(f"K2 pool ({label}) differs from the plain version: {same}")
    log(f"K2 phase A ({label}): pool of {pool_k.close_t.shape[0]} entries for "
        f"{origins.shape[0]} rays equal in pool order and after a (ray, t, l) sort; offsets "
        f"and n_occupied equal")
    return pool_p


def time_phase_a(label: str, grid, words, inputs, pool, card: str) -> dict:
    """K2's count and fill timed on ``inputs`` with ``pool``'s offsets,
    beside their bounds (app/bench_k2.k2_bounds); the plain version timed
    once. Logs a line and returns the numbers."""
    from alphasurf_torch import kernels
    from alphasurf_torch.app import bench_k2
    from alphasurf_torch.render import surface as S

    B, M = inputs[0].shape[0], pool.close_t.shape[0]
    n_cand = bench_k2.n_candidates(grid.reso, *inputs)
    bound = bench_k2.k2_bounds(B, M, words.numel(), n_cand)
    ms_c = time_ms(lambda: kernels.phase_a_count(*inputs, words, grid.reso), 20)
    ms_f = time_ms(lambda: kernels.phase_a_fill(*inputs, words, grid.reso, pool.offsets, M), 20)
    plain = time_ms(lambda: S._compact_crossings_plain(grid.reso, *inputs, words), 1)
    log(f"time K2 ({label}: {B} rays, {n_cand} candidates, {M} entries): count {ms_c:.4f} ms, "
        f"fill {ms_f:.4f} ms, bounds {bound['count'][0]:.5f} / {bound['fill'][0]:.5f} ms "
        f"({bound['fill'][1]}), plain {plain:.3f} ms [{card}]")
    return dict(count=ms_c, fill=ms_f, plain_ms=plain, bound=bound)


def check_kernels(device, card: str) -> dict:
    """Phase 2: every kernel against its plain version at the main path's
    shapes. Returns per-kernel numbers for the JSON line."""
    import numpy as np
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.app import bench_k2
    from alphasurf_torch.app.bench_step import bench_options
    from alphasurf_torch.app.render_circle import circle_render_options
    from alphasurf_torch.core.rays import Camera, Rays
    from alphasurf_torch.data.synthetic import pose_spherical
    from alphasurf_torch.render import surface as S

    res = {}
    # K1 at 128^3, at 130^3 (Z % 4 != 0: the scalar loads; windows that end
    # mid-word), at 256^3 (the recipe's first surface stage) and at 512^3
    # (the main path's shape, timed per call and on the device)
    serve = circle_render_options()
    for reso in (SMALL_RESO, ODD_RESO, TYPES_RESO, RESO):
        g, _ = shell_grid(reso, device)
        dens = g.density_data.detach()[:, 0].contiguous()
        surf = g.surface_data.detach()[:, 0].contiguous()

        def k1(g=g, dens=dens, surf=surf):
            return kernels.occupancy(g.links, dens, surf, g.level_set_data, serve.sigma_thresh,
                                     S._hull_test(g, serve))

        words = k1()
        ref = S._occupancy_words_plain(g, serve)
        if not torch.equal(words, ref):
            raise AssertionError(f"K1 occupancy words differ from the plain version at {reso}^3")
        log(f"K1 occupancy {reso}^3: words equal, {int(S.unpack_occupancy_bits(words, reso - 1).sum())} "
            f"occupied voxels")
        if reso == RESO:
            from alphasurf_torch.app.bench_k34 import graph_ms

            ms = time_ms(k1, 20)
            plain = time_ms(lambda g=g: S._occupancy_words_plain(g, serve), 3)
            nb = g.links.numel() * 4 + 2 * g.capacity * 4 + words.numel() * 4
            res["occupancy"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                                    bound=bound_ms(nb, (reso - 1) ** 3 * 32))
            log(f"time K1 {reso}^3: {ms:.4f} ms a call, {graph_ms(k1, 20):.4f} ms on the device, "
                f"bound {res['occupancy']['bound'][0]:.5f} ms, plain {plain:.3f} ms [{card}]")
        del g, dens, surf, words, ref
        torch.cuda.empty_cache()

    # one full chunk of frame 0 on the 512^3 grid; K3/K4 under the bench
    # options (fake samples, truncation) so that every branch runs
    grid, row_coords = shell_grid(RESO, device)
    bench_opt = bench_options()
    rays_all = frame_camera(0, 2).gen_rays_device(device)
    s = (WIDTH * HEIGHT) // 2 - CHUNK // 2  # centre rows: the sphere is in view

    rays = Rays(rays_all.origins[s:s + CHUNK].contiguous(), rays_all.dirs[s:s + CHUNK].contiguous())
    origins, dirs, sh_mult, tn, tx, ngt = chunk_inputs(grid, bench_opt, rays)
    words = S.occupancy_words(grid, bench_opt)
    B = origins.shape[0]

    # K2, on this chunk and on the central rays of a camera on the x axis,
    # which cross voxel edges and corners where the tie rules decide; then
    # on the surface step's 40,960-ray batch (app/bench_k2.step_rays)
    pool_p = check_phase_a(grid, words, origins, dirs, tn, tx, "serving chunk")
    M = pool_p.close_t.shape[0]
    axis_rays = Camera.make(pose_spherical(0.0, 0.0, 2.7), fx=1.2 * WIDTH, width=WIDTH,
                            height=HEIGHT).gen_rays_device(device)
    o2, d2, _, tn2, tx2, _ = chunk_inputs(grid, bench_opt, Rays(
        axis_rays.origins[s:s + CHUNK].contiguous(), axis_rays.dirs[s:s + CHUNK].contiguous()))
    check_phase_a(grid, words, o2, d2, tn2, tx2, "x-axis camera")
    del o2, d2, tn2, tx2, axis_rays
    k2 = time_phase_a("serving chunk", grid, words, (origins, dirs, tn, tx), pool_p, card)
    res["phase_a_count"] = dict(max_abs_err=0.0, ms=k2["count"], plain_ms=k2["plain_ms"],
                                bound=k2["bound"]["count"])
    res["phase_a_fill"] = dict(max_abs_err=0.0, ms=k2["fill"], plain_ms=k2["plain_ms"],
                               bound=k2["bound"]["fill"])
    step_in = bench_k2.surface_inputs(grid, bench_k2.step_rays(device, TRAIN_BATCH))
    step_pool = check_phase_a(grid, words, *step_in, f"{RESO}^3 surface step batch")
    time_phase_a(f"{RESO}^3 surface step batch", grid, words, step_in, step_pool, card)
    del step_in, step_pool

    # K3 on the (equal) pool
    pool = pool_p
    packed = S.pack_grid_data(grid)
    fss = grid.fake_sample_std.detach()

    def k3():
        return kernels.phase_b(pool.ray_id, pool.l, pool.close_t, pool.far_t, origins, dirs,
                               sh_mult, grid.links, packed, kernels.SDF, grid.level_set_data, ngt,
                               fss,
                               bench_opt)

    sk = k3()
    sp = S._voxel_samples_plain(grid, bench_opt, pool, origins, dirs, sh_mult, ngt, packed)
    flips = sum(int((sk[k] != sp[k]).sum()) for k in ("contrib", "fake", "counted"))
    slots = sp["contrib"].numel()
    if flips > FLAG_FRACTION * slots:
        raise AssertionError(f"K3: {flips} of {slots} slot flags differ from the plain version")
    live = sp["contrib"] | (sp["counted"] > 0)
    errs = [allclose_err(sk["t"][live], sp["t"][live], rtol=1e-5, atol=1e-4)]
    errs += [allclose_err(sk[k], sp[k]) for k in ("alpha", "rgb", "snorm")]
    errs += [allclose_err(sk["loss_e"], sp["loss_e"], atol=1e-4)]
    if max(e[1] for e in errs) > 0:
        raise AssertionError(f"K3 values differ from the plain version: {errs}")
    k3_err = max(e[0] for e in errs)
    log(f"K3 phase B: {M} entries x {sk['n_slots']} slots, {flips} flag flips, "
        f"max abs err {k3_err:.3e}")
    links_used = torch.unique(torch.stack([
        ((torch.clamp(pool.l[:, 0].long() + dx, max=RESO - 1) * RESO
          + torch.clamp(pool.l[:, 1].long() + dy, max=RESO - 1)) * RESO
         + torch.clamp(pool.l[:, 2].long() + dz, max=RESO - 1))
        for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]))
    S0 = sk["n_slots"]
    nb3 = (M * 24 + B * (24 + 36) + links_used.numel() * (4 + packed.shape[1] * 4)
           + S0 * M * 38 + 3 * M * 4)
    n_lv = grid.level_set_data.numel()
    ops3 = M * (48 * grid.basis_dim + 60 + n_lv * 550 + 200)
    res["phase_b"] = dict(max_abs_err=k3_err, ms=time_ms(k3, 50),
                          plain_ms=time_ms(lambda: S._voxel_samples_plain(
                              grid, bench_opt, pool, origins, dirs, sh_mult, ngt, packed), 3),
                          bound=bound_ms(nb3, ops3))

    # K4 on the same slots
    smp = {k: sp[k].contiguous() for k in ("t", "alpha", "contrib", "fake", "counted", "rgb",
                                           "snorm", "loss_e")}
    trunc_a = grid.truncated_vol_render_a

    def k4():
        return kernels.composite(pool.offsets, smp, trunc_a, bench_opt)

    ck = k4()
    cp = S._composite_plain(bench_opt, grid.truncated_vol_render_a, pool.offsets, sp)
    if not torch.equal(ck["n_intersections"], cp["n_intersections"]):
        raise AssertionError("K4 n_intersections differ from the plain version")
    errs = [allclose_err(ck[k], cp[k]) for k in ("rgb", "normal", "log_T", "weight")]
    errs += [allclose_err(ck[k], cp[k], atol=1e-4) for k in ("depth", "ray_losses")]
    sel = [allclose_err(ck[k], cp[k], atol=1e-3) for k in ("depth_mode", "depth_med")]
    if max(e[1] for e in errs) > 0 or max(e[1] for e in sel) > SELECT_FRACTION:
        raise AssertionError(f"K4 differs from the plain version: {errs} {sel}")
    k4_err = max(e[0] for e in errs)
    log(f"K4 compositor: {B} rays, max abs err {k4_err:.3e}; mode/median rays off "
        f"{[round(e[1] * B) for e in sel]}")
    nb4 = S0 * M * 42 + 3 * M * 4 + (B + 1) * 8 + B * 92
    res["composite"] = dict(max_abs_err=k4_err, ms=time_ms(k4, 50),
                            plain_ms=time_ms(lambda: S._composite_plain(
                                bench_opt, grid.truncated_vol_render_a, pool.offsets, sp), 3),
                            bound=bound_ms(nb4, S0 * M * 50))

    res.update(check_composite_options(grid, bench_opt, pool, origins, dirs, sp, smp, nb4))
    res.update(check_backward(grid, bench_opt, rays, words, pool, packed, origins, dirs, sh_mult,
                              ngt, sk))
    res.update(check_reg(grid, row_coords, device))
    res.update(check_rmsprop(grid))
    del grid, row_coords, packed, pool, sk, sp, smp
    torch.cuda.empty_cache()
    for name, r in res.items():
        log(f"time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound'][0]:.5f} ms ({r['bound'][1]}) [{card}]")
    return res


SIG_THRESH = 0.1  # extract_points_depth's --depth_sigma_thresh


def check_composite_options(grid, opt, pool, origins, dirs, sp, smp, nb4: int) -> dict:
    """K3/K4's two output options on the serving chunk's slots: K4 with the
    sigma-thresh depth and the live flags against the plain compositor
    (the depth picks one sample, as the mode depth does: at most
    SELECT_FRACTION of the rays may differ by more than 1e-3; the flags
    follow the stop_thresh kill, a float32 sum: at most FLAG_FRACTION may
    flip), and intersect_points against the plain world points (the same
    float32 operations in the same order: equal to 1e-6 grid-relative)."""
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.render import surface as S

    trunc_a = grid.truncated_vol_render_a
    B, M, S0 = origins.shape[0], pool.close_t.shape[0], sp["t"].shape[0]

    def k4s():
        return kernels.composite(pool.offsets, smp, trunc_a, opt, SIG_THRESH, True)

    ck = k4s()
    cp = S._composite_plain(opt, trunc_a, pool.offsets, sp, SIG_THRESH)
    err, frac = allclose_err(ck["depth_sigma_thresh"], cp["depth_sigma_thresh"], atol=1e-3)
    flips = int((ck["live"] != cp["live"]).sum())
    if frac > SELECT_FRACTION or flips > FLAG_FRACTION * ck["live"].numel():
        raise AssertionError(f"K4's sigma-thresh depth or live flags differ from the plain "
                             f"version: {frac} of the rays, {flips} flags")
    n_hit = int((cp["depth_sigma_thresh"] > 0).sum())
    log(f"K4 with the sigma-thresh depth ({SIG_THRESH}): {n_hit} of {B} rays hit, max abs err "
        f"{err:.3e}, {round(frac * B)} rays off; {flips} live flags flip")
    plain_s = time_ms(lambda: S._composite_plain(opt, trunc_a, pool.offsets, sp, SIG_THRESH), 3)
    res = {"composite_sigma_thresh": dict(
        max_abs_err=err, ms=time_ms(k4s, 50), plain_ms=plain_s,
        bound=bound_ms(nb4 + B * 4 + S0 * M, S0 * M * 52))}

    t = sp["t"].contiguous()
    rscaling = (2.0 * grid.radius / grid.gsz).tolist()
    roffset = (-grid.radius + grid.center).tolist()

    def kip():
        return kernels.intersect_points(pool.ray_id, t, origins, dirs, rscaling, roffset)

    def plain_ip():
        rid = pool.ray_id.long()
        g = origins[rid].T[:, None, :] + t[None] * dirs[rid].T[:, None, :]
        return grid.grid2world(g.permute(2, 1, 0).reshape(-1, 3))

    pk, pp = kip(), plain_ip()
    live = ck["live"].T.reshape(-1)
    err_ip = check_close("intersect_points", pk[live], pp[live], 1e-6, 1e-6)
    log(f"intersect_points: {M} entries x {S0} slots, {int(live.sum())} live, max abs err "
        f"{err_ip:.3e} world units")
    res["intersect_points"] = dict(max_abs_err=err_ip, ms=time_ms(kip, 50),
                                   plain_ms=time_ms(plain_ip, 3),
                                   bound=bound_ms(M * 4 + S0 * M * 4 + B * 24 + S0 * M * 12,
                                                  S0 * M * 12))
    return res


def grad_stats(gk, gp, atol: float = GRAD_ATOL) -> dict:
    """Kernel gradient ``gk`` against plain ``gp`` on one parameter group:
    the rel err in norm, the touched rows and those outside GRAD_RTOL /
    ``atol`` elementwise, the max abs err, the norms."""
    gk, gp = gk.double().reshape(gk.shape[0], -1), gp.double().reshape(gp.shape[0], -1)
    d = (gk - gp).abs()
    touched = (gk != 0).any(-1) | (gp != 0).any(-1)
    bad = ((d > atol + GRAD_RTOL * gp.abs()).any(-1) & touched)
    return {"rel": float((gk - gp).norm() / gp.norm().clamp(min=1e-30)),
            "bad": int(bad.sum()), "touched": int(touched.sum()), "max_abs": float(d.max()),
            "norm": float(gp.norm()), "max_plain": float(gp.abs().max()),
            "max_kernel": float(gk.abs().max())}


def grad_ok(st: dict, rel_tol: float = GRAD_REL) -> bool:
    return st["rel"] <= rel_tol and st["bad"] / max(st["touched"], 1) <= GRAD_ROW_FRACTION


def grad_check(name: str, gk, gp, kernel: str = "K5", atol: float = GRAD_ATOL,
               rel_tol: float = GRAD_REL) -> float:
    """The backward kernels' tolerance (GRAD_*, or the floor ``atol`` and
    the norm tolerance ``rel_tol``) on one parameter group; returns the max
    abs error."""
    st = grad_stats(gk, gp, atol)
    log(f"  {name}: |g| {st['norm']:.4e}, max |g| plain {st['max_plain']:.4e} kernel "
        f"{st['max_kernel']:.4e}, rel err {st['rel']:.3e}, {st['bad']} of "
        f"{st['touched']} touched rows outside rtol {GRAD_RTOL}/atol {atol:.3e}, "
        f"max abs err {st['max_abs']:.3e}")
    if not grad_ok(st, rel_tol):
        raise AssertionError(f"{kernel} {name} gradient differs from autograd of the plain path: "
                             f"{st}")
    return st["max_abs"]


# the outputs other than rgb and the ray losses that take a cotangent, and
# the ones among them that pick one sample (a near-tie of two weights may
# pick another sample in the kernel than in the plain version: at most
# SELECT_FRACTION of the rays, whose pick then takes no cotangent on
# either side)
OUT_KEYS = ("depth", "normal", "alpha", "log_transmit", "depth_mode", "depth_med",
            "depth_sigma_thresh")
PICKED_KEYS = ("depth_mode", "depth_med", "depth_sigma_thresh")
SAMPLE_KEYS = ("ts", "alphas", "weights")


def out_weights(out, seed: int = SEED) -> dict:
    """Random cotangents from a seed (drawn on the card), at the scale of the mse's
    d/d rgb (1/B), for every output of ``out`` that takes one: the per-ray
    outputs, the intersections' points, alphas and weights and the
    samples' ts, alphas and weights."""
    import torch

    B = out["rgb"].shape[0]
    dev = out["rgb"].device
    gen = torch.Generator(device=dev).manual_seed(seed + 13)

    def draw(shape):
        return torch.randn(shape, generator=gen, device=dev) / B

    w = {k: draw(tuple(out[k].shape)) for k in OUT_KEYS if k in out}
    if "intersections" in out:
        n = out["intersections"]["alpha"].shape[0]
        w.update(pts=draw((n, 3)), i_alpha=draw(n), i_weight=draw(n))
    if "samples" in out:
        w.update({f"s_{k}": draw(tuple(out["samples"][k].shape)) for k in SAMPLE_KEYS})
    return w


def every_output_terms(out, w: dict, keep: dict, live=None, valid=None) -> dict:
    """The loss terms of every_output_loss by name: "rgb" the bench's mse
    against 0.5, then each cotangent of ``w`` on its output of ``out``."""
    import torch

    terms = {"rgb": torch.mean((out["rgb"] - 0.5) ** 2)}
    for k in OUT_KEYS:
        if k in w:
            m = keep.get(k)
            x = out[k] * w[k]
            if m is not None:
                x = torch.where(m.reshape(m.shape + (1,) * (x.dim() - 1)), x, torch.zeros_like(x))
            terms[k] = x.sum()
    if "pts" in w:
        it = out["intersections"]
        for k, x in (("pts", (it["pts"] * w["pts"]).sum(-1)),
                     ("i_alpha", it["alpha"] * w["i_alpha"]),
                     ("i_weight", it["weight"] * w["i_weight"])):
            terms[k] = torch.where(live, x, torch.zeros_like(x)).sum()
    for k in SAMPLE_KEYS:
        if f"s_{k}" in w:
            x = out["samples"][k] * w[f"s_{k}"]
            terms[f"s_{k}"] = torch.where(valid, x, torch.zeros_like(x)).sum()
    return terms


def every_output_loss(out, w: dict, keep: dict, live=None, valid=None):
    """The bench's mse against 0.5 plus the cotangents ``w`` on every
    other output of ``out`` that takes one; ``keep`` (B,) masks the picked
    depths' rays, ``live`` the intersections' slots and ``valid`` the
    samples' (the slots both the kernel and the plain version count)."""
    return sum(every_output_terms(out, w, keep, live, valid).values())


@contextlib.contextmanager
def first_calls(module, names):
    """Records the arguments of the first call of each function ``names``
    of ``module`` while the block runs (the calls themselves go through)."""
    calls, orig = {}, {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def call(*args, **kw):
            calls.setdefault(name, (args, kw))
            return fn(*args, **kw)
        return call

    for n, fn in orig.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield calls
    finally:
        for n, fn in orig.items():
            setattr(module, n, fn)


def plain_outputs(grid, opt, pool, origins, dirs, sh_mult, ngt, mode, sig=None,
                  isect: bool = False, slot=None, n_slots: int = 0) -> dict:
    """The renderer's outputs from the plain K3 and K4 on ``pool`` (under
    autograd), as the renderer lays them out: ``mode`` (S._Mode) the
    compositor's rules, ``sig`` the sigma-thresh depth's threshold,
    ``isect`` the intersections (their points by torch ops), ``slot`` each
    entry's slot of return_samples' (B, n_slots S0) layout."""
    from alphasurf_torch.render import surface as S

    smp = S._voxel_samples_plain(grid, opt, pool, origins, dirs, sh_mult, ngt,
                                 S.pack_grid_data(grid))
    comp = S._composite_plain(opt, grid.truncated_vol_render_a, pool.offsets, smp, sig, *mode)
    slots = dict(comp, t=smp["t"], alpha=smp["alpha"], fake=smp["fake"])
    if isect:
        rid = pool.ray_id.long()
        p = origins[rid].T[:, None, :] + smp["t"][None] * dirs[rid].T[:, None, :]
        slots["pts"] = grid.grid2world(p.permute(2, 1, 0).reshape(-1, 3))
    comp.update(S._slot_outputs(slots, isect, slot is not None))
    out = S._finalize(comp, mode, cache_med_depth=mode.mode_first)
    if sig is not None:
        out["depth_sigma_thresh"] = comp["depth_sigma_thresh"]
    if isect:
        out["intersections"] = comp["intersections"]
    if slot is not None:
        out["samples"] = S._samples(comp, pool, slot, n_slots, origins.shape[0])
    return out


def check_output_grads(label: str, grid, opt, rays, renderer: str, words, packed) -> dict:
    """Every output cotangent in one loss (every_output_loss) through the
    renderer's kernels (K3, K4, K5a's backward_ray_out and, for the normal,
    K5b's backward_entry_out) against autograd of the plain renderer on the
    same pool, both on the card, under GRAD_*. ``renderer``: "packed"
    (with the intersections and the sigma-thresh depth), "dense" or
    "compact" (with their cache, whose median is their depth_med, and
    their samples, checked against the plain ones). Then each output's
    cotangent alone, the same way. Returns the largest gradient error, the
    plain backward's time (of the sum), the kernel's outputs, and the
    arguments of K5a's and K5b's launches in the sum's backward
    (``calls``: what _SurfaceFn passes them)."""
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.render import surface as S

    origins, dirs, sh_mult, tnear, tmax, ngt, ok, _, _ = S._begin(grid, rays, opt, words)
    B = origins.shape[0]
    tn, tx = S._phase_a_bounds(tnear, tmax, ok)
    sig, isect, slot, n_slots = None, False, None, 0
    if renderer == "packed":
        kw = dict(return_intersections=True, depth_sigma_thresh=SIG_THRESH)
        sig, isect, mode = SIG_THRESH, True, S.PACKED
        pool = S._compact_crossings_plain(grid.reso, origins, dirs, tn, tx, words)
        render = S.volume_render_surface_packed
    elif renderer == "dense":
        kw = dict(cache_size=CACHE_K, return_samples=True)
        mv = S.max_voxels_for(grid)
        pool, slot = S._dense_walk_plain(grid.reso, origins, dirs, tnear, tmax, ok, words, mv)
        mode, n_slots = S._Mode(1, True, CACHE_K), mv
        render = S.volume_render_surface
    else:
        kw = dict(cache_size=CACHE_K, return_samples=True, max_intersect_voxels=COMPACT_K)
        pool = S._cap_pool(S._compact_crossings_plain(grid.reso, origins, dirs, tn, tx, words),
                           COMPACT_K)
        slot = (torch.arange(pool.close_t.shape[0], device=origins.device)
                - pool.offsets[pool.ray_id.long()])
        mode, n_slots = S._Mode(8, True, CACHE_K), COMPACT_K
        render = S.volume_render_surface_compact
    names = ("density", "surface", "sh", "fake_sample_std")
    params = [p for p in (grid.density_data, grid.surface_data, grid.sh_data,
                          grid.fake_sample_std) if p is not None]
    for p in params:
        p.requires_grad_(True)
    try:
        out_k = render(grid, rays, opt, occupancy=words, packed=packed, **kw)
        out_p = plain_outputs(grid, opt, pool, origins, dirs, sh_mult, ngt, mode, sig, isect,
                              slot, n_slots)
        keep = {}
        for k in PICKED_KEYS:
            if k in out_k:
                a, b = out_k[k].detach(), out_p[k].detach()
                keep[k] = (a - b).abs() <= 1e-3 + RTOL * b.abs()
        n_off = {k: int((~m).sum()) for k, m in keep.items()}
        if max(n_off.values()) > SELECT_FRACTION * B:
            raise AssertionError(f"{label}: the picked depths differ on too many rays: {n_off}")
        live = valid = None
        if isect:
            mk, mp = out_k["intersections"]["mask"], out_p["intersections"]["mask"]
            live = mk & mp
            flips = int((mk != mp).sum())
        if slot is not None:
            vk, vp = out_k["samples"]["valid"], out_p["samples"]["valid"]
            valid = vk & vp
            flips = int((vk != vp).sum())
            errs = [allclose_err(out_k["samples"][k].detach()[valid],
                                 out_p["samples"][k].detach()[valid], atol=1e-4)
                    for k in SAMPLE_KEYS]
            if max(e[1] for e in errs) > 0 or not torch.equal(
                    out_k["samples"]["fake_mask"] & valid, out_p["samples"]["fake_mask"] & valid):
                raise AssertionError(f"{label}: return_samples differs from the plain walk's: "
                                     f"{errs}")
            log(f"{label}: return_samples ({tuple(vk.shape)}) equal to the plain version's on "
                f"{int(valid.sum())} valid slots, max abs err {max(e[0] for e in errs):.3e}")
        if (isect or slot is not None) and flips > FLAG_FRACTION * live_count(live, valid):
            raise AssertionError(f"{label}: {flips} live slot flags flip")
        w = out_weights(out_k)
        terms_k = every_output_terms(out_k, w, keep, live, valid)
        terms_p = every_output_terms(out_p, w, keep, live, valid)
        with first_calls(kernels, ("backward_ray", "backward_entry")) as calls:
            g_kernel = torch.autograd.grad(sum(terms_k.values()), params, retain_graph=True)
        g_plain, plain_ms = timed_once(lambda: torch.autograd.grad(
            sum(terms_p.values()), params, retain_graph=True))
        log(f"{label}: every output cotangent over {B} rays ({', '.join(sorted(w))}), kernels "
            f"against autograd of the plain path; picks off {n_off}:")
        err = max(grad_check(f"{label} {n}", a, b) for n, a, b in zip(names, g_kernel, g_plain))
        del g_kernel, g_plain
        # each output's cotangent alone (a small term's fault could hide
        # under GRAD_REL of the sum's norm)
        alone = [k for k in terms_k if k != "rgb"]
        for i, k in enumerate(alone):
            gk, gp = (torch.autograd.grad(t[k], params, retain_graph=i < len(alone) - 1,
                                          allow_unused=True) for t in (terms_k, terms_p))
            sts = [grad_stats(torch.zeros_like(q) if a is None else a,
                              torch.zeros_like(q) if b is None else b)
                   for q, a, b in zip(params, gk, gp)]
            log(f"  {label}, {k} alone: rel err " + ", ".join(
                f"{n} {st['rel']:.2e}" for n, st in zip(names, sts)) + ", max abs err "
                + ", ".join(f"{st['max_abs']:.2e}" for st in sts))
            if not all(grad_ok(st) for st in sts):
                raise AssertionError(f"K5 {label}: the gradient of {k} alone differs from "
                                     f"autograd of the plain path: {sts}")
            err = max([err] + [st["max_abs"] for st in sts])
        del out_p, terms_k, terms_p
    finally:
        for p in params:
            p.requires_grad_(False)
    return {"err": err, "plain_ms": plain_ms, "out": out_k, "weights": w, "pool": pool,
            "slot": slot, "calls": calls}


def live_count(live, valid) -> int:
    return int((live if live is not None else valid).sum())


def k5b_work(grid, pool, packed, B: int, S0: int, normal: bool) -> tuple[float, float]:
    """K5b's bytes and operations on a pool: the pool, its rays, the corner
    links and rows, the slot cotangents (with the normal's, d_snorm), and
    the full gradient arrays it returns; the normal's Jacobian and the
    field's second derivatives cost ~120 operations a real slot."""
    import torch

    M, (X, Y, Z) = pool.close_t.shape[0], grid.reso
    pos = torch.unique(torch.stack([
        ((torch.clamp(pool.l[:, 0].long() + dx, max=X - 1) * Y
          + torch.clamp(pool.l[:, 1].long() + dy, max=Y - 1)) * Z
         + torch.clamp(pool.l[:, 2].long() + dz, max=Z - 1))
        for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]))
    n_rows = int((grid.links.reshape(-1)[pos] >= 0).sum())
    n_grad = grid.density_data.numel() + grid.surface_data.numel() + grid.sh_data.numel()
    nb = (M * 24 + B * 60 + pos.numel() * 4 + n_rows * packed.shape[1] * 4
          + S0 * M * (21 + 12 * normal) + B * 8 + n_grad * 4)
    ops = (M * 2 * (48 * grid.basis_dim + 60 + grid.level_set_data.numel() * 550 + 200)
           + S0 * M * 2 * 120 * normal)
    return nb, ops


def check_backward(grid, opt, rays, words, pool, packed, origins, dirs, sh_mult, ngt, sk) -> dict:
    """K5: the gradients of the bench loss on one chunk through the kernels
    (the renderer's autograd Function: K3, K4, then K5a and K5b) against
    autograd of the plain renderer, both on the card; then with every other
    output's cotangent too (check_output_grads: K5a's and K5b's second
    instantiations); K5a's kill and picks against K4's; the same two
    comparisons on the 512^3 surface step's batch (bench_k34.backward_check);
    then the four instantiations timed alone on the chunk's slots."""
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.app import bench_k2, bench_k34
    from alphasurf_torch.render import surface as S

    B = origins.shape[0]
    lam = torch.tensor([K5_LAMBDAS.get(k, 0.0) for k in S._RAY_LOSS_KEYS], dtype=torch.float32,
                       device=origins.device)

    def loss_of(rgb, rl):
        return torch.mean((rgb - 0.5) ** 2) + torch.sum(lam * rl.mean(dim=1))

    names = ("density", "surface", "sh", "fake_sample_std")
    params = [grid.density_data, grid.surface_data, grid.sh_data, grid.fake_sample_std]
    for p in params:
        p.requires_grad_(True)
    try:
        out = S.volume_render_surface_packed(grid, rays, opt, occupancy=words, packed=packed)
        rl_k = torch.stack([out["ray_losses"][k] for k in S._RAY_LOSS_KEYS])
        g_kernel = torch.autograd.grad(loss_of(out["rgb"], rl_k), params)
        comp = S._render_plain(grid, opt, pool, origins, dirs, sh_mult, ngt, S.pack_grid_data(grid))
        loss_p = loss_of(comp["rgb"], comp["ray_losses"])
        g_plain = torch.autograd.grad(loss_p, params, retain_graph=True)
        plain_ms = time_ms(lambda: torch.autograd.grad(loss_p, params, retain_graph=True), 3)
        del comp, loss_p
    finally:
        for p in params:
            p.requires_grad_(False)
    log(f"K5 backward: gradients of the bench loss over {B} rays, kernels against autograd of "
        f"the plain path:")
    err = max(grad_check(n, a, b) for n, a, b in zip(names, g_kernel, g_plain))
    del g_kernel, g_plain

    # K5a's stop_thresh kill and one-sample picks against K4's: K5a takes
    # them with K4's sums in K4's order, so no ray may differ
    picks = bench_k34.pick_disagreements(pool, sk, grid.truncated_vol_render_a, opt)
    log(f"K5a against K4 on the chunk's K3 slots, rays whose kill or pick differs: "
        f"{json.dumps(picks)}")
    if any(picks.values()):
        raise AssertionError(f"K5a's kill or picks differ from K4's: {picks}")

    # K5a and K5b against autograd of the plain renderer on the surface
    # step's batch: rgb and every ray loss, then every output's cotangent
    step = bench_k34.chunk_case(grid, opt, bench_k2.step_rays(origins.device, TRAIN_BATCH))
    for every in (False, True):
        chk = bench_k34.backward_check(step, every, sig=bench_k34.SIG_THRESH if every else None)
        chk.pop("calls")
        what = "every output" if every else "rgb and ray losses"
        log(f"K5 on the {RESO}^3 surface step batch ({step['origins'].shape[0]} rays, "
            f"{step['pool'].close_t.shape[0]} entries), {what}, kernels against autograd of the "
            f"plain path: " + json.dumps(chk))
        if not chk["ok"]:
            raise AssertionError(f"K5 on the surface step batch differs from autograd of the plain "
                                 f"path: {chk}")
    step_picks = bench_k34.pick_disagreements(step["pool"], bench_k34.k3_call(step)(),
                                              grid.truncated_vol_render_a, opt)
    log(f"K5a against K4 on the surface step batch, rays whose kill or pick differs: "
        f"{json.dumps(step_picks)}")
    if any(step_picks.values()):
        raise AssertionError(f"K5a's kill or picks differ from K4's on the step batch: "
                             f"{step_picks}")
    del step

    # K5a and K5b alone, on K3's slots of this chunk
    comp_k = kernels.composite(pool.offsets, sk, grid.truncated_vol_render_a, opt)
    g_rgb = (2.0 * (comp_k["rgb"] - 0.5) / (3 * B)).contiguous()
    g_rl = (lam[:, None] / B).expand(12, B).contiguous()
    fss = grid.fake_sample_std.detach()

    def k5a():
        return kernels.backward_ray(pool.offsets, sk, grid.truncated_vol_render_a, opt, g_rgb, g_rl)

    d_alpha, d_t, d_col = k5a()

    def k5b():
        return kernels.backward_entry(pool.ray_id, pool.l, pool.close_t, pool.far_t, origins, dirs,
                                      sh_mult, grid.links, packed, kernels.SDF, grid.level_set_data,
                                      ngt, fss, opt, sk["contrib"], d_alpha, d_t, d_col, g_rl)

    # every output cotangent (K5a's and K5b's second instantiations)
    # through the renderer, then both timed alone, on the arguments the
    # renderer passed them, beside the rgb-only ones
    chk = check_output_grads("K5 outputs", grid, opt, rays, "packed", words, packed)
    err_out, plain_out_ms = chk["err"], chk["plain_ms"]
    (a_ray, kw_ray), (a_ent, kw_ent) = chk["calls"]["backward_ray"], chk["calls"]["backward_entry"]
    if a_ray[0].shape[0] != B + 1:
        raise AssertionError("the renderer's K5a launch did not take the whole chunk")
    ms = {}
    for name, fn in (("backward_ray", k5a), ("backward_ray_out",
                                              lambda: kernels.backward_ray(*a_ray, **kw_ray)),
                     ("backward_entry", k5b), ("backward_entry_out",
                                               lambda: kernels.backward_entry(*a_ent, **kw_ent))):
        ms[name] = time_ms(fn, 20)
    log("K5 instantiations timed alone on the chunk's slots, ms: " + json.dumps(
        {k: round(v, 4) for k, v in ms.items()}) + f" [{card_line()}]")
    del chk, a_ray, kw_ray, a_ent, kw_ent

    M, S0 = pool.close_t.shape[0], sk["n_slots"]
    # K5a: slots read (t, alpha, flags, colour), cotangents written
    bytes_a = S0 * M * 46 + (B + 1) * 8 + B * 60
    bytes_b, ops_b = k5b_work(grid, pool, packed, B, S0, normal=False)
    bytes_bo, ops_bo = k5b_work(grid, pool, packed, B, S0, normal=True)
    # the second instantiations: K5a also reads 32 bytes of cotangents a ray
    # (depth, normal, log_T, mode, median, sigma-thresh depth), the ray's
    # direction, 20 a slot (the intersections' point, alpha and weight) and
    # K3's normal, and writes d_snorm, which K5b reads
    bytes_ao = bytes_a + B * (32 + 12) + S0 * M * (20 + 12 + 12)
    return {
        "backward_ray": dict(max_abs_err=err, ms=ms["backward_ray"], plain_ms=plain_ms,
                             bound=bound_ms(bytes_a, S0 * M * 100)),
        "backward_entry": dict(max_abs_err=err, ms=ms["backward_entry"], plain_ms=plain_ms,
                               bound=bound_ms(bytes_b, ops_b)),
        "backward_ray_out": dict(max_abs_err=err_out, ms=ms["backward_ray_out"],
                                 plain_ms=plain_out_ms, bound=bound_ms(bytes_ao, S0 * M * 130)),
        "backward_entry_out": dict(max_abs_err=err_out, ms=ms["backward_entry_out"],
                                   plain_ms=plain_out_ms,
                                   bound=bound_ms(bytes_bo, ops_bo)),
    }


def window_stats(grid, cells, offsets) -> tuple[int, int]:
    """Bytes a window of cells needs for its cell ids and for each distinct
    link it reads at ``offsets``, and the number of rows those links name."""
    import torch

    from alphasurf_torch.losses import reg as R

    x, y, z = R._cells_to_xyz(cells, grid.reso)
    lk = torch.unique(torch.stack([R._link_at(grid.links, x + a, y + b, z + c)
                                   for a, b, c in offsets]))
    return cells.numel() * 4 + lk.numel() * 4, int((lk >= 0).sum())


def reg_check(label: str, run_kernel, run_plain, grid, fields,
              rel: float = REG_REL) -> tuple[float, float, float]:
    """K6 against the plain version's autograd: (max abs err, kernel ms,
    plain ms); each gradient to ``rel`` of its norm."""
    import torch

    loss_k, *g_kernel = run_kernel()
    params = [getattr(grid, f) for f in fields]
    for p in params:
        p.requires_grad_(True)
    try:
        loss_p = run_plain()
        g_plain = [torch.zeros_like(p) if g is None else g
                   for p, g in zip(params, torch.autograd.grad(loss_p, params, allow_unused=True))]

        def plain():
            torch.autograd.grad(run_plain(), params, allow_unused=True)

        plain_ms = time_ms(plain, 3)
    finally:
        for p in params:
            p.requires_grad_(False)
    lk, lp = float(loss_k), float(loss_p.detach())
    errs = [abs(lk - lp)]
    ok = abs(lk - lp) <= REG_LOSS_RTOL * abs(lp)
    for gk, gp in zip(g_kernel, g_plain):
        rel_err = float((gk - gp).double().norm() / gp.double().norm().clamp(min=1e-30))
        errs.append(float((gk - gp).abs().max()))
        ok = ok and rel_err <= rel
    log(f"  {label}: loss {lk:.7e} (plain {lp:.7e}), grad max abs err {max(errs[1:]):.3e}")
    if not ok:
        raise AssertionError(f"K6 {label} differs from its plain version")
    return max(errs), time_ms(run_kernel, 20), plain_ms


def check_reg(grid, row_coords, device) -> dict:
    """K6 on windows of 0.01 of the 512^3 grid's rows (bench.py's
    sparsity), each against its plain version; then the every-cell mode
    (check_reg_every)."""
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.losses import reg as R

    gen = torch.Generator().manual_seed(SEED)
    L = grid.links
    out = {}

    tv_offs = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1))
    win_offs = tuple((a, b, c) for a in range(3) for b in range(3) for c in range(3))
    log("K6 regularizers on windows of 0.01 of the rows:")
    worst = {"reg_tv": 0.0, "reg_normal": 0.0, "reg_sparsify": 0.0}
    cells = R.sample_present_cells(gen, grid, row_coords, 0.01)
    n = cells.numel()
    cb, nr = window_stats(grid, cells, tv_offs)
    for label, field, c0, c1 in (("TV density", "density_data", 0, 1),
                                 ("TV sh", "sh_data", 0, 27),
                                 ("TV surface", "surface_data", 0, 1)):
        data = getattr(grid, field)
        e, ms, pms = reg_check(
            label, lambda: kernels.reg_tv(L, cells, data.detach(), c0, c1, None, 1.0 / n),
            lambda: R._tv_plain(grid, data, cells, c0, c1, None, 1.0 / n), grid, (field,))
        worst["reg_tv"] = max(worst["reg_tv"], e)
        if field == "surface_data":  # the main path's heaviest-weighted TV
            out["reg_tv"] = dict(ms=ms, plain_ms=pms, bound=bound_ms(
                cb + nr * 4 * 2 + grid.capacity * 4, n * 20))
    cb, nr = window_stats(grid, cells, win_offs)
    for use_l1 in (True, False):
        e, ms, pms = reg_check(
            f"normal {'L1' if use_l1 else 'L2'}",
            lambda: kernels.reg_normal(L, cells, grid.surface_data.detach(), grid.level_set_data,
                                       False, False, use_l1, 1.0 / n),
            lambda: R._normal_plain(grid, cells, False, False, use_l1, 1.0 / n), grid,
            ("surface_data",))
        worst["reg_normal"] = max(worst["reg_normal"], e)
        if use_l1:
            out["reg_normal"] = dict(ms=ms, plain_ms=pms, bound=bound_ms(
                cb + nr * 4 + grid.capacity * 4, n * 400))
    cb, nr = window_stats(grid, cells, ((0, 0, 0),))
    e, ms, pms = reg_check(
        "sparsify",
        lambda: kernels.reg_sparsify(L, cells, grid.density_data.detach(),
                                     grid.surface_data.detach(), 1.0, 1.0, True, 0.15, 1.0 / n),
        lambda: R._sparsify_plain(grid, cells, 1.0, 1.0, True, 0.15), grid,
        ("density_data", "surface_data"))
    worst["reg_sparsify"] = e
    out["reg_sparsify"] = dict(ms=ms, plain_ms=pms, bound=bound_ms(
        cb + nr * 8 + grid.capacity * 8, n * 30))

    check_reg_every(grid, row_coords, device, worst)
    for k, v in out.items():
        v["max_abs_err"] = worst[k]
    return out


EVERY_CHUNK = 1 << 21  # cells a chunk of the plain every-cell versions


def plain_chunked(loss_of, cells, param, extra: float = 0.0, grad_cells=None):
    """The plain loss over ``cells`` in chunks of EVERY_CHUNK, each chunk's
    autograd gradient in ``param`` summed; the losses summed in float64,
    plus ``extra``. Returns (loss, grad). With ``grad_cells`` the loss is
    summed over ``cells`` without autograd and the gradient taken over
    ``grad_cells``, the cells that can have one: a normal cell whose base
    vertex is absent skips its three terms and adds exact zeros, but its
    27 gathers all read row 0, whose accumulation makes autograd's backward
    over every 256^3 cell take ~50 s."""
    import torch

    total, grad = extra, torch.zeros_like(param)
    if grad_cells is not None:
        with torch.no_grad():
            for c in torch.split(cells, EVERY_CHUNK):
                total += float(loss_of(c).double())
    param.requires_grad_(True)
    try:
        for c in torch.split(cells if grad_cells is None else grad_cells, EVERY_CHUNK):
            lc = loss_of(c)
            grad += torch.autograd.grad(lc, [param])[0]
            if grad_cells is None:
                total += float(lc.detach().double())
    finally:
        param.requires_grad_(False)
    return total, grad


def check_reg_every(grid, row_coords, device, worst: dict) -> None:
    """K6's every-cell mode (the dense losses of the recipe's sparsity 1),
    which visits the present rows: TV, normal L1 and L2 against the plain
    version over every cell at 128^3 and 256^3 (the normal's gradient over
    the cells with a present base vertex: plain_chunked), and at 512^3 over
    the present vertices (the normal's in the interior box), in chunks,
    plus the empty cells' floor, which the plain version gives every empty
    cell; loss to REG_LOSS_RTOL, gradient to REG_REL of its norm. Then its
    device times (a CUDA graph of the calls) at 512^3 and 256^3."""
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.app import bench_k6
    from alphasurf_torch.app.bench_k34 import graph_ms
    from alphasurf_torch.losses import reg as R

    for reso in (SMALL_RESO, CUVOL_RESO, RESO):
        g, rc = (grid, row_coords) if reso == RESO else shell_grid(reso, device)
        N = g.links.numel()
        scale = 1.0 / N
        calls = bench_k6.every_cell_calls(g, rc)
        if reso == RESO:
            cells = bench_k6.present_cells(g)
            cells_n = bench_k6.interior(g, cells)
            floor = (N - cells.numel()) * kernels.TV_FLOOR * scale
            what = ("the present vertices plus the empty cells' floor",
                    "the present vertices of the interior box")
            grad_n = None
        else:
            cells, cells_n, floor = torch.arange(N, device=device), R._interior_cells(g), 0.0
            what = ("every cell", "every cell of the interior box")
            grad_n = cells_n[g.links.reshape(-1)[cells_n] >= 0]
        surf = g.surface_data
        checks = (
            ("tv_surface", "TV", lambda c: R._tv_plain(g, surf, c, 0, 1, None, scale), cells,
             floor, what[0], None),
            ("normal_l1", "normal L1",
             lambda c: R._normal_plain(g, c, False, False, True, scale), cells_n, 0.0, what[1],
             grad_n),
            ("normal_l2", "normal L2",
             lambda c: R._normal_plain(g, c, False, False, False, scale), cells_n, 0.0, what[1],
             grad_n))
        for name, label, loss_of, c, extra, over, grad_cells in checks:
            lk, gk = calls[name]()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lp, gp = plain_chunked(loss_of, c, surf, extra, grad_cells)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            rel = float((gk - gp).double().norm() / gp.double().norm().clamp(min=1e-30))
            err = max(abs(float(lk) - lp), float((gk - gp).abs().max()))
            kernel = "reg_tv" if name.startswith("tv") else "reg_normal"
            worst[kernel] = max(worst[kernel], err)
            log(f"  K6 every-cell {label} at {reso}^3 ({g.capacity} rows, against the plain "
                f"version over {over}): loss {float(lk):.9e} (plain {lp:.9e}), grad rel err "
                f"{rel:.3e}, max abs err {err:.3e}; the plain version with its gradient "
                f"{plain_ms:.3f} ms, once, on the host's clock")
            if abs(float(lk) - lp) > REG_LOSS_RTOL * abs(lp) or rel > REG_REL:
                raise AssertionError(f"K6 every-cell {label} at {reso}^3 differs from its plain "
                                     f"version")
        if reso != SMALL_RESO:
            ms = {name: graph_ms(fn, 20) for name, fn in calls.items()}
            b = bench_k6.every_cell_bounds(g)
            log(f"time K6 every-cell mode at {reso}^3 on the device ({g.capacity} threads, one a "
                f"row): TV {ms['tv_surface']:.4f} ms, normal L1 {ms['normal_l1']:.4f}, normal L2 "
                f"{ms['normal_l2']:.4f}; present-vertex bound TV {b['present_tv']:.5f}, normal "
                f"{b['present_normal']:.5f}, lattice bound {b['lattice']:.5f} ms (bytes) [{card_line()}]")
        if reso != RESO:
            del g, rc
        torch.cuda.empty_cache()


def check_rmsprop(grid) -> dict:
    """K7 on the 512^3 parameter arrays (density, SH, surface with the
    clip, fake_sample_std with the floor) against its plain version:
    elementwise to RMS_RTOL. Gradients are random, with 30% of rows zero."""
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.optim.rmsprop import _rmsprop_plain

    gen = torch.Generator(device=grid.links.device).manual_seed(SEED)
    groups = []
    for param, lr, kw in ((grid.density_data, 1e-3, {}), (grid.sh_data, 1e-3, {}),
                          (grid.surface_data, 1e-5, dict(grad_abs_max=1e-3)),
                          (grid.fake_sample_std, 1e-4, dict(minval=1e-8))):
        g = torch.randn(param.shape, generator=gen, device=param.device) * 1e-3
        g[torch.rand(param.shape[0], generator=gen, device=param.device) < 0.3] = 0.0
        rms = torch.rand(param.shape, generator=gen, device=param.device) * 1e-6
        args = (lr, 0.95, 1e-8, kw.get("minval"), kw.get("grad_abs_max"), False)
        groups.append((param.detach(), rms, g, args))
    err = 0.0
    for p0, r0, g, args in groups:
        pk, rk, pp, rp = p0.clone(), r0.clone(), p0.clone(), r0.clone()
        kernels.rmsprop(pk, rk, g, *args)
        _rmsprop_plain(pp, rp, g, *args)
        for a, b in ((pk, pp), (rk, rp)):
            err = max(err, float((a - b).abs().max()))
            if not torch.allclose(a, b, rtol=RMS_RTOL, atol=0.0):
                raise AssertionError("K7 differs from its plain version")
    n_el = sum(p0.numel() for p0, _, _, _ in groups)
    bufs = [(p0.clone(), r0.clone(), g, args) for p0, r0, g, args in groups]

    def k7():
        for p, r, g, args in bufs:
            kernels.rmsprop(p, r, g, *args)

    def plain():
        for p, r, g, args in bufs:
            _rmsprop_plain(p, r, g, *args)

    log(f"K7 RMSprop: {n_el} elements in 4 groups equal to the plain version (max abs err "
        f"{err:.3e})")
    return {"rmsprop": dict(max_abs_err=err, ms=time_ms(k7, 20), plain_ms=time_ms(plain, 3),
                            bound=bound_ms(20 * n_el, 8 * n_el))}


def plain_rgb(grid, opt, rays, words):
    """rgb of rays through the plain versions of K2-K4, on the card."""
    from alphasurf_torch.render import surface as S

    origins, dirs, sh_mult, tn, tx, ngt = chunk_inputs(grid, opt, rays)
    pool = S._compact_crossings_plain(grid.reso, origins, dirs, tn, tx, words)
    smp = S._voxel_samples_plain(grid, opt, pool, origins, dirs, sh_mult, ngt,
                                 S.pack_grid_data(grid))
    return S._composite_plain(opt, grid.truncated_vol_render_a, pool.offsets, smp)["rgb"]


def serve(device, card: str, work: Path) -> dict:
    """Phase 3: the main path at full width, through render_circle."""
    import numpy as np
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.app import render_circle
    from alphasurf_torch.core.rays import Rays
    from alphasurf_torch.render import surface as S
    from alphasurf_torch.render.image import render_image
    from alphasurf_torch.utils.io import load_grid, save_grid

    ckpt = work / "ckpt.npz"
    t0 = time.perf_counter()
    save_grid(shell_grid(RESO, device)[0], str(ckpt))
    torch.cuda.empty_cache()
    log(f"checkpoint {RESO}^3 basis_dim=9 written in {time.perf_counter() - t0:.1f} s")

    n_frames = 2
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = render_circle.main([str(ckpt), "--n_frames", str(n_frames), "--width", str(WIDTH),
                              "--height", str(HEIGHT), "--out_dir", str(work / "circle"),
                              "--device", str(device)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    secs = out["frame_seconds"]
    n_rays = WIDTH * HEIGHT * n_frames
    log(f"served {n_frames} frames {WIDTH}x{HEIGHT}: ms per frame {[round(s * 1e3, 3) for s in secs]}, "
        f"{n_rays / sum(secs):.1f} rays/s, main() wall {wall:.2f} s incl. checkpoint load, "
        f"max_memory_allocated {peak / 2**30:.3f} GiB [{card}]")
    launches = {k: launches[k] for k in SERVE_KERNELS}
    log("launches " + json.dumps(launches))
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the main path was not launched: {launches}")

    # the frames are right: finite, of the expected shape, not flat, and
    # equal to the plain path on the central rays of frame 0
    grid, _ = load_grid(str(ckpt), device=device)
    opt = render_circle.circle_render_options()
    img = render_image(grid, frame_camera(0, n_frames), opt, device=device)
    if img.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(img).all():
        raise AssertionError(f"frame 0 is not a finite {HEIGHT}x{WIDTH}x3 image")
    if img.std() < 0.05:
        raise AssertionError("frame 0 is flat")
    png = work / "circle" / "0000.png"
    if not png.exists() or png.stat().st_size < 1000:
        raise AssertionError("render_circle wrote no frame")
    rays = frame_camera(0, n_frames).gen_rays_device(device)
    s = (WIDTH * HEIGHT) // 2 - 2048
    sub = Rays(rays.origins[s:s + 4096].contiguous(), rays.dirs[s:s + 4096].contiguous())
    ref = plain_rgb(grid, opt, sub, S.occupancy_words(grid, opt)).cpu().numpy()
    err = float(np.abs(img.reshape(-1, 3)[s:s + 4096] - ref).max())
    if err > 1e-4:
        raise AssertionError(f"frame 0 differs from the plain path by {err}")
    log(f"frame 0: mean {img.mean():.4f}, std {img.std():.4f}; central 4096 rays equal the plain "
        f"path to {err:.2e}")
    profile_frame(grid, opt, device, card)
    return launches


def profile_device(fn, label: str, card: str) -> tuple[float, float, list]:
    """Where the time of fn() goes: torch.profiler over one warm call,
    device time summed by kernel name. Returns the wall and device-busy
    ms and the (ms, count, name) rows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"profile of {label}: wall {wall:.3f} ms under the profiler, device busy {busy:.3f} ms, "
        f"idle share {1.0 - busy / wall:.3f} [{card}]")
    for ms, n, key in rows[:16]:
        log(f"  {ms:9.3f} ms {n:6d}x  {key[:100]}")
    return wall, busy, rows


def profile_frame(grid, opt, device, card: str) -> None:
    """Phase 3's profile: render_image of frame 1 of the orbit."""
    from alphasurf_torch.render.image import render_image

    cam = frame_camera(1, 2)
    profile_device(lambda: render_image(grid, cam, opt, device=device),
                   f"one {WIDTH}x{HEIGHT} frame", card)


def check_step(device, flags=(), hp_extra=None, basis: str = "sh") -> None:
    """One train step through the kernels on the card against one step of
    the plain versions on a CPU copy, at 128^3 with a 4,096-ray batch of
    the bench camera and the same regularizer windows (rays whose float32
    bounds differ between the two are left out); ``flags`` turn on
    StepConfig switches, ``hp_extra`` adds HParams, ``basis`` "texture"
    gives the grid bench_step's learned texture (then trained at
    lr_basis). RMSprop's first step
    moves a row by about lr / sqrt(1 - beta) whatever its gradient, so the
    parameters agree to 1e-3 of that step on all but 1e-3 of the rows either
    updates; the rms (0.05 g^2) agrees in norm to 1e-3."""
    import torch

    from alphasurf_torch.app.bench_step import (bench_hparams, bench_options, bench_rays,
                                                with_basis)
    from alphasurf_torch.core.grid import SparseGrid
    from alphasurf_torch.core.rays import Rays
    from alphasurf_torch.render import surface as S
    from alphasurf_torch.train.steps import WINDOWS, StepConfig, init_rms, make_surface_step

    grid, rc = shell_grid(SMALL_RESO, device)
    grid = with_basis(grid, basis)
    cpu = SparseGrid.from_numpy(grid.to_numpy(), device="cpu")
    fields = ("density_data", "sh_data", "surface_data", "fake_sample_std") + (
        ("basis_data",) if basis == "texture" else ())
    old = {f: getattr(cpu, f).detach().clone() for f in fields}
    rays = bench_rays(WIDTH, device)
    # float32 ray bounds accept a plane hit only within an absolute 1e-6 of
    # the lattice (ROADMAP §3), so a ray whose prepared bounds round
    # differently on the card and on the CPU may hit on one and miss on the
    # other; the batch takes the central rays whose bounds agree exactly
    opt = bench_options()
    s = (WIDTH * HEIGHT) // 2 - STEP_BATCH
    cand = Rays(rays.origins[s:s + 2 * STEP_BATCH], rays.dirs[s:s + 2 * STEP_BATCH])
    prep_k = S._prep(grid, cand, opt)[:7]
    prep_p = S._prep(cpu, Rays(cand.origins.cpu(), cand.dirs.cpu()), opt)[:7]
    same = torch.ones(2 * STEP_BATCH, dtype=torch.bool)
    for a, b in zip(prep_k, prep_p):
        if torch.is_tensor(a):
            same &= (a.cpu() == b).reshape(2 * STEP_BATCH, -1).all(-1)
    keep = torch.nonzero(same)[:STEP_BATCH, 0]
    nb = keep.numel()
    log(f"train step check: {2 * STEP_BATCH - int(same.sum())} of {2 * STEP_BATCH} central rays "
        f"have float32 bounds that differ between the card and the CPU; {nb} agreeing rays kept")
    r_k = Rays(cand.origins[keep.to(device)].contiguous(), cand.dirs[keep.to(device)].contiguous())
    r_p = Rays(r_k.origins.cpu(), r_k.dirs.cpu())
    hp = bench_hparams()._replace(lr_fake_sample_std=1e-4, **(hp_extra or {}))
    beta = 0.95
    step = make_surface_step(StepConfig(opt=opt, cache_size=None, rms_beta=beta,
                                        **dict.fromkeys(flags, True)))
    K = max(1, int(0.01 * grid.capacity))
    gen = torch.Generator().manual_seed(SEED)
    starts = {w: int(torch.randint(0, grid.capacity - K + 1, (), generator=gen)) for w in WINDOWS}
    rms_k, rms_p = init_rms(grid), init_rms(cpu)
    _, _, st_k = step(grid, rms_k, r_k, torch.full((nb, 3), 0.5, device=device), hp,
                      torch.Generator(), row_coords=rc, window_starts=starts)
    _, _, st_p = step(cpu, rms_p, r_p, torch.full((nb, 3), 0.5), hp, torch.Generator(),
                      row_coords=rc.cpu(), window_starts=starts)
    lk, lp = float(st_k["loss"]), float(st_p["loss"])
    if abs(lk - lp) > 1e-5 * abs(lp) or abs(float(st_k["mse"]) - float(st_p["mse"])) > 1e-5 * lp:
        raise AssertionError(f"train step loss {lk} differs from the plain step's {lp}")
    lrs = {"density_data": hp.lr_alpha, "sh_data": hp.lr_sh, "surface_data": hp.lr_surface,
           "fake_sample_std": hp.lr_fake_sample_std, "basis_data": hp.lr_basis}
    msg = []
    for (f, o), rk in zip(old.items(), ("density", "sh", "surface", "fake_sample_std",
                                        "basis_data")):
        dk = (getattr(grid, f).detach().cpu() - o).reshape(o.shape[0] if o.dim() < 4 else -1,
                                                           o.shape[-1])
        dp = (getattr(cpu, f).detach() - o).reshape(dk.shape)
        unit = lrs[f] / (1.0 - beta) ** 0.5
        moved = (dk != 0).any(-1) | (dp != 0).any(-1)
        bad = ((dk - dp).abs() > 1e-3 * unit).any(-1) & moved
        frac = float(bad.sum()) / max(int(moved.sum()), 1)
        a, b = rms_k[rk].cpu().double(), rms_p[rk].double()
        rel = float((a - b).norm() / b.norm().clamp(min=1e-30))
        msg.append(f"{rk}: {int(moved.sum())} rows moved, {int(bad.sum())} off, rms rel {rel:.2e}")
        if frac > 1e-3 or rel > 1e-3 or not moved.any():
            raise AssertionError(f"train step {rk} differs from the plain step: {msg[-1]}")
    extra = ", ".join(list(flags) + ([f"the {basis} basis"] if basis != "sh" else []))
    log(f"train step at {SMALL_RESO}^3, {nb} rays{' with ' + extra if extra else ''}: "
        f"loss {lk:.7f} (plain {lp:.7f}); " + "; ".join(msg))
    del grid, rc, cpu
    torch.cuda.empty_cache()


def train(device, card: str) -> dict:
    """Phase 4: the training path at full width, through bench_step."""
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.app import bench_step
    from alphasurf_torch.core.rays import Rays
    from alphasurf_torch.render.surface import occupancy_words
    from alphasurf_torch.train.steps import StepConfig, init_rms, make_surface_step

    check_step(device)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    out = bench_step.main(["--reso", str(RESO), "--batch", str(TRAIN_BATCH), "--steps", "33",
                           "--width", str(WIDTH), "--device", str(device)])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"train: {out['steps']} steps of {out['batch']} rays at {RESO}^3 (capacity "
        f"{out['capacity']}): {out['rays_per_s_fwd_bwd']:.1f} rays/s, "
        f"{out['seconds'] / out['steps'] * 1e3:.3f} ms per step, loss {out['first_loss']:.6f} -> "
        f"{out['last_loss']:.6f}, {out['rows_moved']} rows moved, max_memory_allocated "
        f"{peak / 2**30:.3f} GiB [{card}]")
    launches = {k: launches[k] for k in TRAIN_KERNELS}
    log("launches " + json.dumps(launches))
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the training path was not launched: {launches}")
    TRAIN_RAYS_PER_S["packed"] = out["rays_per_s_fwd_bwd"]
    if not (out["losses_finite"] and out["rows_moved"] > 0):
        raise AssertionError(f"training did not run right: {out}")

    # one more step under the profiler
    grid, rc = bench_step.build_bench_grid(RESO, device)
    opt = bench_step.bench_options()
    rays = bench_step.bench_rays(WIDTH, device)
    s = int(WIDTH * HEIGHT * 0.35)
    r = Rays(rays.origins[s:s + TRAIN_BATCH], rays.dirs[s:s + TRAIN_BATCH])
    step = make_surface_step(StepConfig(opt=opt, cache_size=None))
    rms, hp, gen = init_rms(grid), bench_step.bench_hparams(), torch.Generator()
    gt = torch.full((TRAIN_BATCH, 3), 0.5, device=device)
    occ = occupancy_words(grid, opt)
    profile_device(lambda: step(grid, rms, r, gt, hp, gen, occ=occ, row_coords=rc),
                   f"one train step ({TRAIN_BATCH} rays, {RESO}^3)", card)
    # and one under the recipe's regularizers: K6's every-cell TV and normal
    from alphasurf_torch.app.bench_k6 import surface_step

    profile_device(surface_step(grid, rc, device, recipe=True),
                   f"one train step with the recipe's regularizers ({TRAIN_BATCH} rays, {RESO}^3, "
                   f"every-cell TV and normal)", card)
    return launches


# ---------------------------------------------------------------------------
# the Plenoxels warm start
# ---------------------------------------------------------------------------

def blobby_cuvol_grid(reso: int, device, seed: int = SEED):
    """The warm start's sphere-bounded grid (basis_dim 9) on the card,
    holding a blobby shell of density: a shell around radius reso/4 whose
    radius, thickness and height wobble smoothly (a numpy seed draws the
    wobble), negative away from it, so that K1d keeps the shell; and a
    smooth SH colour field. Returns the grid and its row coords."""
    import numpy as np
    import torch

    from alphasurf_torch.core.grid import create_grid
    from alphasurf_torch.losses.reg import row_coords_of

    grid = create_grid(reso, use_sphere_bound=True, init_sigma=0.0, basis_dim=9, device=device)
    rc = row_coords_of(grid)
    p = rc.float() / reso
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=device)
    freqs = torch.as_tensor(rng.normal(size=(3, 30)) * 2.0, **f32)
    phase = torch.as_tensor(rng.uniform(0, 2 * np.pi, 30), **f32)
    wave = torch.sin(p @ freqs * (2 * np.pi / 2) + phase)  # (cap, 30)
    r = torch.linalg.norm(rc.float() - reso / 2.0, dim=-1)
    radius = reso / 4.0 * (1.0 + 0.15 * wave[:, 0])
    half = reso / 64.0 * (1.0 + 0.5 * wave[:, 1])
    with torch.no_grad():
        grid.density_data.copy_((4.0 * (1.0 - (r - radius).abs() / half)
                                 * (1.0 + 0.5 * wave[:, 2]))[:, None])
        grid.sh_data.copy_(0.35 * wave[:, 3:])
    return grid, rc


def cuvol_chunk(grid, opt, rays, words):
    """What a chunk of the packed cuvol renderer prepares: the rays'
    (origins, dirs, sh_mult, delta_scale, tmin, tmax) and K2's pool."""
    from alphasurf_torch.render import cuvol as C

    ray_t = tuple(x.contiguous() for x in C._prep(grid, rays, opt))
    return ray_t, C.cuvol_pool(grid, ray_t[0], ray_t[1], ray_t[4], ray_t[5], words)


def corner_rows(grid, voxels) -> tuple[int, int]:
    """(corner links, present rows) of the 8 corners of flat voxel ids."""
    import torch

    X, Y, Z = grid.reso
    x, y, z = voxels // (Y * Z), (voxels // Z) % Y, voxels % Z
    pos = torch.unique(torch.stack([
        (torch.clamp(x + dx, max=X - 1) * Y + torch.clamp(y + dy, max=Y - 1)) * Z
        + torch.clamp(z + dz, max=Z - 1) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]))
    return pos.numel(), int((grid.links.reshape(-1)[pos] >= 0).sum())


def march_samples(grid, ray_t, step: float, n_steps: int) -> tuple:
    """The dense march's samples (t = tmin + k step <= tmax, k < n_steps),
    the flat ids of the voxels they read, as K10 clamps them, and the
    samples whose sigma > 0 (the ones K10's backward differentiates)."""
    import torch

    from alphasurf_torch.ops.trilerp import trilerp_weights_T, voxel_of
    from alphasurf_torch.render import cuvol as C

    origins, dirs, _, _, tmin, tmax = ray_t
    n = n_pos = 0
    seen = []
    X, Y, Z = grid.reso
    for k0 in range(0, n_steps, 16):
        t = tmin[:, None] + torch.arange(k0, k0 + 16, device=tmin.device)[None, :] * step
        act = t <= tmax[:, None]
        if not bool(act.any()):
            break
        n += int(act.sum())
        l, frac = voxel_of(origins[:, None, :] + t[..., None] * dirs[:, None, :], grid.reso)
        links8 = C._corner_links(grid, l.permute(2, 0, 1))
        dens8 = grid.density_data.detach()[links8.clamp(min=0).long(), 0] * (links8 >= 0)
        sigma = (trilerp_weights_T(frac.permute(2, 0, 1)) * dens8).sum(0)
        n_pos += int((act & (sigma > 0)).sum())
        lv = l[act].long()
        seen.append(torch.unique((lv[:, 0] * Y + lv[:, 1]) * Z + lv[:, 2]))
    return n, torch.unique(torch.cat(seen)), n_pos


def out_cotangents(B: int, device, seed: int = SEED) -> tuple:
    """Random cotangents of depth and log_transmit (B,) from a numpy seed,
    at the scale of the mse's d/d rgb (1/B)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 12)
    return tuple(torch.as_tensor(rng.standard_normal(B) / B, dtype=torch.float32, device=device)
                 for _ in range(2))


def out_loss(rgb, depth, log_T, cot) -> "torch.Tensor":
    """The step's mse against 0.5 plus the cotangents ``cot`` (or none) on
    depth and log_transmit."""
    loss = ((rgb - 0.5) ** 2).mean()
    if cot is not None:
        loss = loss + (depth * cot[0]).sum() + (log_T * cot[1]).sum()
    return loss


def check_cuvol_kernels(device, card: str) -> dict:
    """Phase 5a: K1d, K8 forward and backward (also with the depth and log_T
    cotangents) and K10 forward and backward (per-ray background colours
    with the depth and log_T cotangents) against their plain
    versions on the 256^3 blobby grid, one 16,384-ray chunk of an 800x800
    frame, under the Config defaults' render options; each timed."""
    import numpy as np
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.app.bench_k34 import graph_ms
    from alphasurf_torch.app.bench_step import cuvol_options
    from alphasurf_torch.core.rays import Rays
    from alphasurf_torch.render import cuvol as C
    from alphasurf_torch.render import surface as S

    res = {}
    grid, _ = blobby_cuvol_grid(CUVOL_RESO, device)
    dens = grid.density_data.detach()[:, 0].contiguous()
    sh = grid.sh_data.detach()

    def k1d():
        return kernels.density_occupancy(grid.links, dens)

    def k1d_plain():
        return S.pack_occupancy_bits(C._density_occupancy_plain(grid))

    words = k1d()
    if not torch.equal(words, k1d_plain()):
        raise AssertionError("K1d density occupancy words differ from the plain version")
    n_occ = int(S.unpack_occupancy_bits(words, CUVOL_RESO - 1).sum())
    log(f"K1d density occupancy {CUVOL_RESO}^3 (capacity {grid.capacity}): words equal, "
        f"{n_occ} occupied voxels")
    res["density_occupancy"] = dict(
        max_abs_err=0.0, ms=time_ms(k1d, 20), plain_ms=time_ms(k1d_plain, 3),
        bound=bound_ms(grid.links.numel() * 4 + grid.capacity * 4 + words.numel() * 4,
                       (CUVOL_RESO - 1) ** 3 * 8))
    r = res["density_occupancy"]
    log(f"time K1d {CUVOL_RESO}^3: {r['ms']:.4f} ms a call, {graph_ms(k1d, 20):.4f} ms on the "
        f"device, bound {r['bound'][0]:.5f} ms, plain {r['plain_ms']:.3f} ms [{card}]")

    opt = cuvol_options()
    rays_all = frame_camera(0, 2).gen_rays_device(device)
    s = (WIDTH * HEIGHT) // 2 - CHUNK // 2
    rays = Rays(rays_all.origins[s:s + CHUNK].contiguous(), rays_all.dirs[s:s + CHUNK].contiguous())
    ray_t, pool = cuvol_chunk(grid, opt, rays, words)
    chunk = C._CuvolChunk(grid, opt, pool, ray_t, None)
    B, M = CHUNK, pool.close_t.shape[0]

    # K8 forward
    fk = C._k8_forward(chunk, dens, sh, False)
    smp = C._entry_samples_plain(grid, opt, pool, *ray_t)
    fp = C._composite_cuvol_plain(pool.offsets, *smp, opt.background_brightness, None)
    errs = [allclose_err(fk["rgb"], fp["rgb"]), allclose_err(fk["depth"], fp["depth"]),
            allclose_err(fk["log_T"], fp["log_transmit"])]
    if max(e[1] for e in errs) > 0:
        raise AssertionError(f"K8 forward differs from the plain version: {errs}")
    n_active = int(smp[1].sum())
    n_links, n_rows = corner_rows(grid, ((pool.l[:, 0].long() * CUVOL_RESO + pool.l[:, 1].long())
                                         * CUVOL_RESO + pool.l[:, 2].long()))
    log(f"K8 forward: {B} rays, pool of {M} entries, {n_active} samples, max abs err "
        f"{max(e[0] for e in errs):.3e}; rgb mean {float(fk['rgb'].mean()):.4f}, log_T min "
        f"{float(fk['log_T'].min()):.3f}")
    in_bytes = M * 20 + (B + 1) * 8 + B * 72 + n_links * 4 + n_rows * 28 * 4
    entry_ops = M * 8 * 3 * 9 * 2
    res["cuvol_forward"] = dict(
        max_abs_err=max(e[0] for e in errs),
        ms=time_ms(lambda: C._k8_forward(chunk, dens, sh, True), 20),
        plain_ms=time_ms(lambda: C._composite_cuvol_plain(
            pool.offsets, *C._entry_samples_plain(grid, opt, pool, *ray_t),
            opt.background_brightness, None), 3),
        bound=bound_ms(in_bytes + B * 20 + M * 4, entry_ops + n_active * 120))
    del smp, fp

    # K8 backward through the renderer's autograd Function against autograd
    # of the plain renderer, the loss of the step (mse against 0.5)
    params = [grid.density_data, grid.sh_data]
    for p in params:
        p.requires_grad_(True)
    try:
        out = C.volume_render_cuvol_packed(grid, rays, opt, occupancy=words)
        g_kernel = torch.autograd.grad(torch.mean((out["rgb"] - 0.5) ** 2), params)
        smp = C._entry_samples_plain(grid, opt, pool, *ray_t)
        fp = C._composite_cuvol_plain(pool.offsets, *smp, opt.background_brightness, None)
        loss_p = torch.mean((fp["rgb"] - 0.5) ** 2)
        g_plain = torch.autograd.grad(loss_p, params, retain_graph=True)
        plain_ms = time_ms(lambda: torch.autograd.grad(loss_p, params, retain_graph=True), 3)
        del smp, fp, loss_p
    finally:
        for p in params:
            p.requires_grad_(False)
    log(f"K8 backward: gradients of the mse against 0.5 over {B} rays, kernels against autograd "
        f"of the plain path:")
    err = max(grad_check(n, a, b, "K8") for n, a, b in zip(("density", "sh"), g_kernel, g_plain))
    del g_kernel, g_plain
    fk = C._k8_forward(chunk, dens, sh, True)
    g_rgb = (2.0 * (fk["rgb"] - 0.5) / (3 * B)).contiguous()

    def k8b():
        return kernels.cuvol_backward(*C._k8_args(chunk, dens, sh), fk["log_T"], fk["entry_pre"],
                                      g_rgb)

    res["cuvol_backward"] = dict(
        max_abs_err=err, ms=time_ms(k8b, 20), plain_ms=plain_ms,
        bound=bound_ms(in_bytes + B * 16 + M * 4 + grid.capacity * 28 * 4,
                       2 * entry_ops + n_active * 250))
    torch.cuda.empty_cache()

    # K8's second instantiation: random cotangents on depth and log_transmit
    # beside the mse's, through the renderer against autograd of the plain one
    cot = out_cotangents(B, device)
    for p in params:
        p.requires_grad_(True)
    try:
        out = C.volume_render_cuvol_packed(grid, rays, opt, occupancy=words)
        g_kernel = torch.autograd.grad(out_loss(out["rgb"], out["depth"], out["log_transmit"],
                                                cot), params)
        smp = C._entry_samples_plain(grid, opt, pool, *ray_t)
        fp = C._composite_cuvol_plain(pool.offsets, *smp, opt.background_brightness, None)
        loss_p = out_loss(fp["rgb"], fp["depth"], fp["log_transmit"], cot)
        g_plain = torch.autograd.grad(loss_p, params, retain_graph=True)
        plain_ms = time_ms(lambda: torch.autograd.grad(loss_p, params, retain_graph=True), 3)
        del smp, fp, loss_p, out
    finally:
        for p in params:
            p.requires_grad_(False)
    log(f"K8 backward with depth and log_T cotangents over {B} rays, kernels against autograd of "
        f"the plain path:")
    err = max(grad_check(n, a, b, "K8") for n, a, b in zip(("density", "sh"), g_kernel, g_plain))
    del g_kernel, g_plain

    def k8b_out():
        return kernels.cuvol_backward(*C._k8_args(chunk, dens, sh), fk["log_T"], fk["entry_pre"],
                                      g_rgb, g_depth=cot[0], g_log_T=cot[1])

    res["cuvol_backward_out"] = dict(
        max_abs_err=err, ms=time_ms(k8b_out, 20), plain_ms=plain_ms,
        bound=bound_ms(in_bytes + B * 24 + M * 4 + grid.capacity * 28 * 4,
                       2 * entry_ops + n_active * 254))
    log(f"K8 backward: rgb only {res['cuvol_backward']['ms']:.4f} ms, with the depth and log_T "
        f"cotangents {res['cuvol_backward_out']['ms']:.4f} ms [{card}]")
    torch.cuda.empty_cache()

    # K10 on the same chunk
    n_steps = (C.max_steps_for(grid, opt) + 15) // 16 * 16

    def k10():
        return kernels.cuvol_march(*ray_t, grid.links, dens, sh, opt.step_size, n_steps,
                                   opt.last_sample_opaque, opt.background_brightness, None)

    def k10_plain():
        return C._march_plain(grid, opt, *ray_t, n_steps, 16, None)

    mk, mp = k10(), k10_plain()
    rgb_p = mp["rgb"] + torch.exp(mp["log_T"])[:, None] * opt.background_brightness
    errs = [allclose_err(mk["rgb"], rgb_p), allclose_err(mk["depth"], mp["depth"]),
            allclose_err(mk["log_T"], mp["log_T"])]
    if max(e[1] for e in errs) > 0:
        raise AssertionError(f"K10 differs from its plain version: {errs}")
    n_samp, voxels, n_pos = march_samples(grid, ray_t, opt.step_size, n_steps)
    n_links, n_rows = corner_rows(grid, voxels)
    log(f"K10 dense march: {B} rays, {n_samp} samples (at most {n_steps} a ray, {n_pos} with "
        f"sigma > 0), max abs err {max(e[0] for e in errs):.3e}")

    def k10_ckpt():
        return kernels.cuvol_march(*ray_t, grid.links, dens, sh, opt.step_size, n_steps,
                                   opt.last_sample_opaque, opt.background_brightness, None,
                                   checkpoints=True)

    mc = k10_ckpt()
    if not all(torch.equal(mc[k], mk[k]) for k in ("rgb", "depth", "log_T")):
        raise AssertionError("K10 with checkpoints differs from K10 without")
    res["cuvol_march"] = dict(
        max_abs_err=max(e[0] for e in errs), ms=time_ms(k10, 10), plain_ms=time_ms(k10_plain, 2),
        bound=bound_ms(B * 72 + n_links * 4 + n_rows * 28 * 4 + B * 20, n_samp * 490))
    ms_ckpt = time_ms(k10_ckpt, 10)
    log(f"K10 forward: {res['cuvol_march']['ms']:.4f} ms, with the backward's checkpoints "
        f"{ms_ckpt:.4f} ms (outputs bit for bit equal) [{card}]")
    del mp
    torch.cuda.empty_cache()

    # K10 backward through volume_render_cuvol's Function against autograd of
    # the plain march: the mse against 0.5 with per-ray background colours (a
    # Function input) and random cotangents on depth and log_transmit; the
    # plain backward (11.5 s on the H100) timed once
    bg_cols = torch.as_tensor(np.random.default_rng(SEED + 13).uniform(0.0, 1.0, (B, 3)),
                              dtype=torch.float32, device=device)
    mchunk = C._MarchChunk(grid, opt, ray_t, n_steps, None, bg_cols)
    bg_in = bg_cols.clone().requires_grad_(True)
    wrt = params + [bg_in]
    for p in params:
        p.requires_grad_(True)
    try:
        rgb, depth, log_T, _ = C._DenseCuvolFn.apply(*params, bg_in, ray_t[2], mchunk)
        g_kernel = torch.autograd.grad(out_loss(rgb, depth, log_T, cot), wrt)
        mp = C._march_plain(grid, opt, *ray_t, n_steps, 16, None)
        rgb_p = mp["rgb"] + torch.exp(mp["log_T"])[:, None] * bg_in
        loss_p = out_loss(rgb_p, mp["depth"], mp["log_T"], cot)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g_plain = torch.autograd.grad(loss_p, wrt)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        del mp, rgb_p, loss_p, rgb, depth, log_T
    finally:
        for p in params:
            p.requires_grad_(False)
    log(f"K10 backward over {B} rays, per-ray background colours and depth and log_T "
        f"cotangents, kernels against autograd of the plain march:")
    err = max(grad_check(n, a, b, "K10") for n, a, b in zip(("density", "sh", "bg_rgb"),
                                                             g_kernel, g_plain))
    del g_kernel, g_plain
    g_rgb10 = (2.0 * (mc["rgb"] - 0.5) / (3 * B)).contiguous()

    def k10b():
        return kernels.cuvol_march_backward(*C._k10_args(mchunk, dens, sh), mc["log_T"],
                                            mc["ckpt"], g_rgb10, cot[0], cot[1], bg_rgb=bg_cols)

    gd10, gs10 = k10b()
    n_written = int(((gd10 != 0) | (gs10 != 0).any(-1)).sum())
    # bytes: the rays, the cotangents, log_T and the checkpoints; the links
    # and rows read; the rows written. Operations: every sample's density
    # re-march (~40), and for a sample with sigma > 0 its trilerp, colour
    # and cotangents (~170) plus its share of its voxel's colour contraction
    # and flush (~350)
    res["cuvol_march_backward"] = dict(
        max_abs_err=err, ms=time_ms(k10b, 10), plain_ms=plain_ms,
        bound=bound_ms(B * (72 + 36) + mc["ckpt"].numel() * 4 + n_links * 4 + n_rows * 28 * 4
                       + n_written * 28 * 4, n_samp * 40 + n_pos * 520))
    log(f"K10 backward: {n_written} rows written, {mc['ckpt'].shape[1]} checkpoints a ray")
    del grid, dens, sh, pool, chunk, fk, mk, mc, mchunk, gd10, gs10
    torch.cuda.empty_cache()
    for name, r in res.items():
        log(f"time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound'][0]:.5f} ms ({r['bound'][1]}) [{card}]")
    return res


LONG_RAYS = 1024  # the rays of K8's long-ray check
LONG_DST = 0.1  # its depth_sigma_thresh: inside the field's density range [0.05, 0.15]


def check_k8_long(device, card: str) -> None:
    """Phase 5b: K8 on the warm step's own grid and batch
    (``app/bench_k8.warm_case``: bench_step's 256^3 grid with a smooth
    field, ~250 entries a ray, so the warp kernels cross many 32-entry
    groups), the first LONG_RAYS rays: the forward (with depth_sigma_thresh)
    and each backward instantiation (rgb only; with the depth and log_T
    cotangents; with the basis gradient; both, with per-ray background
    colours) against autograd of the plain version, to RTOL/ATOL and
    GRAD_*. Then K8 timed at the full TRAIN_BATCH rays (the plain version is
    not timed at that size)."""
    import numpy as np
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.app import bench_k2, bench_k8
    from alphasurf_torch.render import cuvol as C

    grid, opt, full = bench_k8.warm_case(CUVOL_RESO, TRAIN_BATCH, device)
    # K2 on the warm step's batch over K1d's words, in pool order, timed
    words = C.density_occupancy_words(grid)
    warm_in = bench_k2.warm_inputs(grid, full.rays)
    check_phase_a(grid, words, *warm_in, f"warm step batch, {CUVOL_RESO}^3")
    time_phase_a(f"warm step batch, {CUVOL_RESO}^3", grid, words, warm_in, full.pool, card)
    del words, warm_in
    chunk = bench_k8.sub_chunk(full, LONG_RAYS)._replace(depth_sigma_thresh=LONG_DST)
    p, B = chunk.pool, LONG_RAYS
    n_e = (p.offsets[1:] - p.offsets[:-1]).cpu()
    log(f"K8 long rays: {B} rays of the warm step's batch at {CUVOL_RESO}^3, {int(n_e.sum())} "
        f"entries, {float(n_e.float().mean()):.1f} a ray (max {int(n_e.max())}, "
        f"{int((n_e > 32).sum())} rays past one 32-entry group)")
    dens, sh = grid.density_data.detach()[:, 0].contiguous(), grid.sh_data.detach()
    bg_cols = torch.as_tensor(np.random.default_rng(SEED + 14).uniform(0.0, 1.0, (B, 3)),
                              dtype=torch.float32, device=device)
    fk = C._k8_forward(chunk, dens, sh, True)
    shm = chunk.rays[2].clone().requires_grad_(True)
    params = [grid.density_data, grid.sh_data]
    for x in params:
        x.requires_grad_(True)
    try:
        smp = C._entry_samples_plain(grid, opt, p, chunk.rays[0], chunk.rays[1], shm,
                                     *chunk.rays[3:])
        fps = [C._composite_cuvol_plain(p.offsets, *smp, bg, LONG_DST)
               for bg in (opt.background_brightness, bg_cols)]
        errs = [allclose_err(fk[k], fps[0][kp].detach()) for k, kp in (
            ("rgb", "rgb"), ("depth", "depth"), ("log_T", "log_transmit"),
            ("t_sig", "depth_sigma_thresh"))]
        if max(e[1] for e in errs) > 0:
            raise AssertionError(f"K8 forward differs from the plain version on long rays: {errs}")
        log(f"  forward (rgb, depth, log_T, t_sig): max abs err {max(e[0] for e in errs):.3e}")
        g_rgb = (2.0 * (fk["rgb"] - 0.5) / (3 * B)).contiguous()
        cot = out_cotangents(B, device)
        for out, basis in ((False, False), (True, False), (False, True), (True, True)):
            fp = fps[1] if out and basis else fps[0]
            loss = (fp["rgb"] * g_rgb).sum()
            if out:
                loss = loss + (fp["depth"] * cot[0]).sum() + (fp["log_transmit"] * cot[1]).sum()
            wrt = params + ([shm] if basis else [])
            g_plain = torch.autograd.grad(loss, wrt, retain_graph=True)
            g_kernel = kernels.cuvol_backward(
                *C._k8_args(chunk, dens, sh), fk["log_T"], fk["entry_pre"], g_rgb,
                bg_rgb=bg_cols if out and basis else None, want_sh_mult=basis,
                g_depth=cot[0] if out else None, g_log_T=cot[1] if out else None)
            log(f"  backward{' with depth/log_T' if out else ''}"
                f"{' with the basis' if basis else ''}"
                f"{' and per-ray background colours' if out and basis else ''}:")
            for name, a, b in zip(("density", "sh", "sh_mult"), g_kernel,
                                  (g_plain[0][:, 0],) + tuple(g_plain[1:])):
                grad_check(name, a, b, "K8")
        del smp, fps, fp, loss, g_plain, g_kernel
    finally:
        for x in params:
            x.requires_grad_(False)
    calls = bench_k8.k8_calls(full)
    ms = {k: time_ms(fn, 5) for k, fn in calls.items()}
    log(f"K8 at the warm step's shape ({TRAIN_BATCH} rays, {full.pool.close_t.shape[0]} "
        f"entries): forward {ms['forward']:.4f} ms, backward rgb {ms['rgb']:.4f}, out "
        f"{ms['out']:.4f}, basis {ms['basis']:.4f}, out + basis {ms['out_basis']:.4f} ms "
        f"[{card}]")
    del grid, full, chunk, calls, fk, dens, sh
    torch.cuda.empty_cache()


def check_cuvol_step(device, renderer: str = "packed", with_occ: bool = True) -> None:
    """One cuvol step through the kernels on the card against one step of
    the plain versions on a CPU copy, at 128^3 (the blobby grid) with a
    4,096-ray batch of the bench camera whose float32 bounds agree between
    the two, and the same windows; tolerances as in check_step. The step
    on ``renderer`` with or without occupancy words (the dense march
    unless packed with them)."""
    import torch

    from alphasurf_torch.app.bench_step import bench_rays, cuvol_hparams, cuvol_options
    from alphasurf_torch.core.grid import SparseGrid
    from alphasurf_torch.core.rays import Rays
    from alphasurf_torch.ops import dda
    from alphasurf_torch.render import cuvol as C
    from alphasurf_torch.train.steps import CUVOL_WINDOWS, StepConfig, init_rms, make_cuvol_step

    grid, rc = blobby_cuvol_grid(SMALL_RESO, device)
    cpu = SparseGrid.from_numpy(grid.to_numpy(), device="cpu")
    old = {f: getattr(cpu, f).detach().clone() for f in ("density_data", "sh_data")}
    opt = cuvol_options()
    rays = bench_rays(WIDTH, device)
    s = (WIDTH * HEIGHT) // 2 - STEP_BATCH
    cand = Rays(rays.origins[s:s + 2 * STEP_BATCH], rays.dirs[s:s + 2 * STEP_BATCH])

    def bounds(g, r):
        t = C._prep(g, r, opt)
        return (*t, *dda.ray_bounds(g, t[0], t[1]))

    same = torch.ones(2 * STEP_BATCH, dtype=torch.bool)
    for a, b in zip(bounds(grid, cand), bounds(cpu, Rays(cand.origins.cpu(), cand.dirs.cpu()))):
        same &= (a.cpu() == b).reshape(2 * STEP_BATCH, -1).all(-1)
    keep = torch.nonzero(same)[:STEP_BATCH, 0]
    nb = keep.numel()
    log(f"cuvol step check: {2 * STEP_BATCH - int(same.sum())} of {2 * STEP_BATCH} central rays "
        f"have float32 bounds that differ between the card and the CPU; {nb} agreeing rays kept")
    r_k = Rays(cand.origins[keep.to(device)].contiguous(), cand.dirs[keep.to(device)].contiguous())
    r_p = Rays(r_k.origins.cpu(), r_k.dirs.cpu())
    hp = cuvol_hparams()
    beta = 0.95
    step = make_cuvol_step(StepConfig(opt=opt, rms_beta=beta, renderer=renderer))
    K = max(1, int(0.01 * grid.capacity))
    gen = torch.Generator().manual_seed(SEED)
    starts = {w: int(torch.randint(0, grid.capacity - K + 1, (), generator=gen))
              for w in CUVOL_WINDOWS}
    rms_k, rms_p = init_rms(grid), init_rms(cpu)
    _, _, st_k = step(grid, rms_k, r_k, torch.full((nb, 3), 0.5, device=device), hp,
                      torch.Generator(), occ=C.density_occupancy_words(grid) if with_occ else None,
                      row_coords=rc, window_starts=starts)
    _, _, st_p = step(cpu, rms_p, r_p, torch.full((nb, 3), 0.5), hp, torch.Generator(),
                      occ=C.density_occupancy_words(cpu) if with_occ else None,
                      row_coords=rc.cpu(), window_starts=starts)
    lk, lp = float(st_k["loss"]), float(st_p["loss"])
    if abs(lk - lp) > 1e-5 * abs(lp) or abs(float(st_k["mse"]) - float(st_p["mse"])) > 1e-5 * lp:
        raise AssertionError(f"cuvol step loss {lk} differs from the plain step's {lp}")
    msg = []
    for (f, o), rk, lr in zip(old.items(), ("density", "sh"), (hp.lr_sigma, hp.lr_sh)):
        dk = getattr(grid, f).detach().cpu() - o
        dp = getattr(cpu, f).detach() - o
        unit = lr / (1.0 - beta) ** 0.5
        moved = (dk != 0).any(-1) | (dp != 0).any(-1)
        bad = ((dk - dp).abs() > 1e-3 * unit).any(-1) & moved
        frac = float(bad.sum()) / max(int(moved.sum()), 1)
        a, b = rms_k[rk].cpu().double(), rms_p[rk].double()
        rel = float((a - b).norm() / b.norm().clamp(min=1e-30))
        msg.append(f"{rk}: {int(moved.sum())} rows moved, {int(bad.sum())} off, rms rel {rel:.2e}")
        if frac > 1e-3 or rel > 1e-3 or not moved.any():
            raise AssertionError(f"cuvol step ({renderer}) {rk} differs from the plain step: "
                                 f"{msg[-1]}")
    log(f"cuvol step ({renderer}, {'with' if with_occ else 'without'} occupancy) at "
        f"{SMALL_RESO}^3, {nb} rays: loss {lk:.7f} (plain {lp:.7f}); " + "; ".join(msg))
    del grid, rc, cpu
    torch.cuda.empty_cache()


def warm_config() -> str:
    """The warm-start run's config file: the synthetic dataset (20 train
    and 2 test views, GT from make_gt_grid(SMALL_RESO)), one CUVOL_RESO^3
    stage without a surface, the Config defaults otherwise."""
    return (f"dataset_type = synthetic\nreso = [[{CUVOL_RESO}, {CUVOL_RESO}, {CUVOL_RESO}]]\n"
            f"surface_type = none\nn_train_images = 20\ndataset_width = {WIDTH}\n"
            f"dataset_height = {HEIGHT}\ndataset_reso = {SMALL_RESO}\n"
            f"dataset_renderer = packed\ndataset_test_images = 2\n")


def eval_untrained(device, dset_test) -> float:
    """The Trainer's eval PSNR of the grid it starts from."""
    import numpy as np

    from alphasurf_torch.app.config import Config, render_options_from
    from alphasurf_torch.core.grid import create_grid
    from alphasurf_torch.data.base import camera_of
    from alphasurf_torch.render.image import render_image

    cfg = Config()
    grid = create_grid(CUVOL_RESO, radius=dset_test.scene_radius, center=dset_test.scene_center,
                       basis_dim=cfg.sh_dim, use_sphere_bound=True, init_sigma=cfg.init_sigma,
                       device=device)
    opt = render_options_from(cfg, no_surface=True)
    psnrs = []
    for i in np.linspace(0, dset_test.n_images - 1, min(cfg.n_eval_test, dset_test.n_images)):
        i = int(i)
        img = render_image(grid, camera_of(dset_test, i), opt, device=device)
        psnrs.append(-10.0 * np.log10(max(float(np.mean((img - dset_test.gt[i]) ** 2)), 1e-12)))
    return float(np.mean(psnrs))


def warm(device, card: str, work: Path) -> tuple[dict, dict]:
    """Phase 5: the warm start. The kernel checks, the cuvol step check,
    bench_step --stage cuvol at full width, the Trainer through
    app/train.main, and one profiled cuvol step. Returns the kernels'
    numbers and the Trainer run's launches."""
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.app import bench_step
    from alphasurf_torch.app import train as train_app
    from alphasurf_torch.core.rays import Rays
    from alphasurf_torch.data import SyntheticDataset
    from alphasurf_torch.render.cuvol import (density_occupancy_words, volume_render_cuvol,
                                              volume_render_cuvol_packed)
    from alphasurf_torch.train.steps import StepConfig, init_rms, make_cuvol_step

    res = check_cuvol_kernels(device, card)
    check_k8_long(device, card)
    for renderer, with_occ in (("packed", True), ("dense", True), ("packed", False)):
        check_cuvol_step(device, renderer, with_occ)

    main_launches = {}
    for renderer, step_kernels in (("packed", WARM_STEP_KERNELS),
                                   ("dense", WARM_DENSE_STEP_KERNELS)):
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        out = bench_step.main(["--stage", "cuvol", "--renderer", renderer, "--reso",
                               str(CUVOL_RESO), "--batch", str(TRAIN_BATCH), "--steps", "33",
                               "--width", str(WIDTH), "--device", str(device)])
        torch.cuda.synchronize()
        bench_launches = {k: kernels.LAUNCHES[k] for k in step_kernels}
        peak = torch.cuda.max_memory_allocated()
        log(f"warm-start bench ({renderer}): {out['steps']} steps of {out['batch']} rays at "
            f"{CUVOL_RESO}^3 (capacity {out['capacity']}): {out['rays_per_s_fwd_bwd']:.1f} rays/s, "
            f"{out['seconds'] / out['steps'] * 1e3:.3f} ms per step, loss "
            f"{out['first_loss']:.6f} -> {out['last_loss']:.6f}, {out['rows_moved']} rows moved, "
            f"max_memory_allocated {peak / 2**30:.3f} GiB [{card}]")
        log("launches " + json.dumps(bench_launches))
        if any(v == 0 for v in bench_launches.values()):
            raise AssertionError(f"a kernel of the {renderer} warm-start step was not launched: "
                                 f"{bench_launches}")
        if not (out["losses_finite"] and out["rows_moved"] > 0):
            raise AssertionError(f"the {renderer} warm-start bench did not run right: {out}")
        if renderer == "dense":
            main_launches["cuvol_march_backward"] = bench_launches["cuvol_march_backward"]

    # a batch's gradient through each cuvol renderer with cotangents on rgb,
    # depth and log_transmit (the renderers' callers' path to K8's second
    # instantiation and K10's backward)
    grid, _ = bench_step.build_cuvol_grid(CUVOL_RESO, device)
    opt = bench_step.cuvol_options()
    rays = bench_step.bench_rays(WIDTH, device)
    s = int(WIDTH * HEIGHT * 0.35)
    r = Rays(rays.origins[s:s + TRAIN_BATCH], rays.dirs[s:s + TRAIN_BATCH])
    cot = out_cotangents(TRAIN_BATCH, device)
    params = [grid.density_data.requires_grad_(True), grid.sh_data.requires_grad_(True)]
    kernels.reset_launches()
    for render in (volume_render_cuvol_packed, volume_render_cuvol):
        o = render(grid, r, opt)
        g = torch.autograd.grad(out_loss(o["rgb"], o["depth"], o["log_transmit"], cot), params)
        if not all(bool(torch.isfinite(x).all()) and bool((x != 0).any()) for x in g):
            raise AssertionError(f"{render.__name__}: a gradient with the output cotangents is "
                                 "not finite and non-zero")
    torch.cuda.synchronize()
    grad_launches = {k: kernels.LAUNCHES[k] for k in ("cuvol_backward_out",
                                                      "cuvol_march_backward")}
    log("launches of a batch's gradient through each cuvol renderer with the output cotangents "
        + json.dumps(grad_launches))
    if 0 in grad_launches.values():
        raise AssertionError(f"the output cotangents missed a kernel: {grad_launches}")
    main_launches["cuvol_backward_out"] = grad_launches["cuvol_backward_out"]
    del grid, params, g, o
    torch.cuda.empty_cache()

    cfg_path = work / "warm.yaml"
    cfg_path.write_text(warm_config())
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    psnr = train_app.main(["", "-t", str(work / "warm"), "-c", str(cfg_path), "--n_iters",
                           str(WARM_STEPS), "--device", str(device)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in WARM_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    log("launches " + json.dumps(launches))
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the warm start was not launched: {launches}")
    dset_test = SyntheticDataset(split="test", n_images=2, width=WIDTH, height=HEIGHT,
                                 reso=SMALL_RESO, renderer="packed", device=device)
    psnr0 = eval_untrained(device, dset_test)
    log(f"warm start through app/train.main: {WARM_STEPS} steps at {CUVOL_RESO}^3 and a final "
        f"eval in {wall:.2f} s (data set-up included), eval PSNR {psnr:.4f} against the untrained "
        f"grid's {psnr0:.4f}, max_memory_allocated {peak / 2**30:.3f} GiB [{card}]")
    if not psnr > psnr0:
        raise AssertionError(f"the warm start did not train: PSNR {psnr} <= untrained {psnr0}")

    # one more cuvol step under the profiler, on the bench's grid and batch
    grid, rc = bench_step.build_cuvol_grid(CUVOL_RESO, device)
    opt = bench_step.cuvol_options()
    rays = bench_step.bench_rays(WIDTH, device)
    s = int(WIDTH * HEIGHT * 0.35)
    r = Rays(rays.origins[s:s + TRAIN_BATCH], rays.dirs[s:s + TRAIN_BATCH])
    step = make_cuvol_step(StepConfig(opt=opt))
    rms, hp, gen = init_rms(grid), bench_step.cuvol_hparams(), torch.Generator()
    gt = torch.full((TRAIN_BATCH, 3), 0.5, device=device)
    occ = density_occupancy_words(grid)
    pool = cuvol_chunk(grid, opt, r, occ)[1]
    log(f"the profiled cuvol step's pool: {pool.close_t.shape[0]} entries for {TRAIN_BATCH} rays")
    del pool
    profile_device(lambda: step(grid, rms, r, gt, hp, gen, occ=occ, row_coords=rc),
                   f"one cuvol step ({TRAIN_BATCH} rays, {CUVOL_RESO}^3)", card)
    dense_step = make_cuvol_step(StepConfig(opt=opt, renderer="dense"))
    profile_device(lambda: dense_step(grid, rms, r, gt, hp, gen, row_coords=rc),
                   f"one dense cuvol step ({TRAIN_BATCH} rays, {CUVOL_RESO}^3)", card)
    del grid, rc, rms
    torch.cuda.empty_cache()
    return res, {**launches, **main_launches}


# ---------------------------------------------------------------------------
# the stage transitions
# ---------------------------------------------------------------------------

# warm start, surface at 256^3, surface at 512^3: the three-stage, dtu and
# two-pass cells (cut from 100 / 100 / 50 for time)
STAGE_STEPS = (60, 60, 30)
UPSAMPLE_RESO = 512
MAX_ELEMENTS = 6_000_000  # the recipe's max_grid_elements (recipe_run.py:114)
SURF_LVS = (2.0, 6.0)  # the recipe's density level sets (recipe_run.py:105)
# K9 against its plain version, both float32 on the card. Masks, links,
# capacities and K9d's counts are integer results of the same float
# comparisons: equal. K9b computes the same lerps in the same order, built
# with --fmad=false, so its rows are expected equal; RS_RTOL/RS_ATOL leave
# float32 rounding room all the same. K9c runs the same march, but a
# sample's weight T (1 - exp(-sigma step)) cancels in its second factor, so
# one ulp of exp near 1 is up to ~1e-4 of the weight: WT_RTOL/WT_ATOL, and
# the keep mask at the threshold must be equal.
RS_RTOL, RS_ATOL = 1e-6, 1e-7
WT_RTOL, WT_ATOL = 1e-4, 1e-7


def timed_once(fn):
    """(fn(), its milliseconds) by CUDA events around one call."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_equal(label: str, got, ref) -> None:
    import torch

    if not torch.equal(got, ref):
        raise AssertionError(f"{label} differs from its plain version")


def check_close(label: str, got, ref, rtol: float, atol: float) -> float:
    err, frac = allclose_err(got, ref, rtol, atol)
    if frac > 0:
        raise AssertionError(f"{label} differs from its plain version: max abs err {err}, "
                             f"{frac} of the values outside rtol {rtol} / atol {atol}")
    return err


def check_stage_kernels(device, card: str) -> dict:
    """Phase 6a: K9a-K9d against their plain versions at the slice's shapes,
    from the warm phase's 256^3 blobby density grid: a 256^3 -> 256^3
    resample with the weight threshold (K9b every vertex, K9c with one
    800x800 camera, K9a, K9b kept rows), init_surface_from_density on it
    (K9a's prune rule, K9d with two 800x800 cameras), then a 256^3 -> 512^3
    resample_surface with keep_lv_band and max_elements 6,000,000 (K9b, K9a
    and its level-set band, K9b kept rows). Each kernel timed by CUDA
    events at its largest shape here, the plain version once; then the
    upsample with the weight threshold over 20 cameras under the
    profiler."""
    import math

    import numpy as np
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.app.config import Config
    from alphasurf_torch.core import topology as T
    from alphasurf_torch.core import weight_render as W
    from alphasurf_torch.ops import dda

    res = {}
    f32 = dict(dtype=torch.float32, device=device)
    grid, _ = blobby_cuvol_grid(CUVOL_RESO, device)
    R = CUVOL_RESO
    new = (R, R, R)
    n3 = R ** 3
    tables = T.resample_tables(grid.reso, new, True, device)

    # K9b, every vertex: the density on the new voxel-centre lattice
    dens = grid.density_data.detach()[:, 0].contiguous()
    dk = kernels.resample_dense(grid.links, dens, 0.0, tables, new)
    dp, _ = timed_once(lambda: T._resample_dense_plain(T._dense_of(grid.links, dens, 0.0), tables))
    err = check_close(f"K9b every vertex {R}^3", dk, dp, RS_RTOL, RS_ATOL)
    log(f"K9b resample {R}^3 -> {R}^3, every vertex: max abs err {err:.3e}")
    del dp

    # K9c, one 800x800 camera, the Config's weight threshold
    cam = frame_camera(0, 2)
    w_thresh = Config().weight_thresh / R
    wk = W.grid_weight_render(dk, [cam], grid.offset, grid.scaling)
    gsz = np.asarray(new, np.float32)
    sc = torch.as_tensor(grid.scaling.cpu().numpy() * gsz, **f32)
    off = torch.as_tensor(grid.offset.cpu().numpy() * gsz - 0.5, **f32)
    rays = cam.gen_rays(device=device)
    prep = [x.contiguous() for x in W._march_prep(rays.origins, rays.dirs, sc, off,
                                                  torch.as_tensor(gsz, **f32), 0.5)]
    n_steps = int(math.ceil(math.sqrt(3 * (R - 1) ** 2) / 0.5)) + 2
    wp = torch.zeros(n3, **f32)
    n_samp, wp_ms = timed_once(lambda: W._weight_march_plain(dk, wp, *prep, 0.5, 0.2, n_steps))
    wp = wp.reshape(new)
    err_w = check_close("K9c weights", wk, wp, WT_RTOL, WT_ATOL)
    check_equal("K9c keep mask at the weight threshold", wk >= w_thresh, wp >= w_thresh)
    bits = torch.zeros(n3, dtype=torch.int32, device=device)
    B = rays.origins.shape[0]
    res["weight_march"] = dict(
        max_abs_err=err_w, plain_ms=wp_ms,
        ms=time_ms(lambda: kernels.weight_march(*prep, dk, 0.5, 0.2, n_steps, bits), 3),
        bound=bound_ms(n3 * 4 + B * 9 * 4 + n3 * 4, n_samp * 40))
    log(f"K9c weight march {R}^3, one {WIDTH}x{HEIGHT} camera: {n_samp} samples, max abs err "
        f"{err_w:.3e}, {int((wk >= w_thresh).sum())} vertices at >= {w_thresh:.3e} in both")
    del wp, bits

    # K9a at the threshold bounded to max_elements, dilated by 2; K9b rows
    thresh = T._kth_largest_thresh(wk.reshape(-1), MAX_ELEMENTS, w_thresh)
    mk = kernels.keep_mask(wk, thresh, 2)
    check_equal(f"K9a keep mask {R}^3", mk, T._dilate_plain(wk >= thresh, 2))
    links_new, kept = T._links_pass(mk)
    rows = torch.cat([grid.density_data.detach(), grid.sh_data.detach()], dim=1).contiguous()
    vk, _ = kernels.resample_rows(grid.links, rows, torch.zeros(rows.shape[1], **f32), kept,
                                  tables, new, False)
    vp, _ = T._resample_rows_plain(grid.links, rows, [0.0] * rows.shape[1], kept, tables, new,
                                   False)
    err = check_close(f"K9b kept rows {R}^3", vk, vp, RS_RTOL, RS_ATOL)
    api = T.resample(grid, new, weight_thresh=w_thresh, cameras=[cam], max_elements=MAX_ELEMENTS)
    check_equal("resample's links", api.links, links_new)
    log(f"K9a keep mask {R}^3 (threshold {thresh:.4e}, dilate 2): equal, {kept.numel()} kept; "
        f"K9b kept rows ({rows.shape[1]} channels) max abs err {err:.3e}; resample's links equal")
    del wk, mk, vp, dk
    grid_r = api
    del grid, api, rows, vk
    torch.cuda.empty_cache()

    # init_surface_from_density: K9a's prune rule, then K9d
    dens_r = grid_r.density_data.detach()[:, 0].contiguous()
    prune_t = min(SURF_LVS) / 2
    pk = kernels.prune_mask(grid_r.links, dens_r, None, prune_t, 2)
    pp, pp_ms = timed_once(lambda: T._dilate_plain(
        T._prune_valid_plain(grid_r.links, dens_r, None, prune_t), 2))
    check_equal("K9a prune mask", pk, pp)
    res["prune_mask"] = dict(
        max_abs_err=0.0, plain_ms=pp_ms,
        ms=time_ms(lambda: kernels.prune_mask(grid_r.links, dens_r, None, prune_t, 2), 10),
        bound=bound_ms(n3 * 4 + grid_r.capacity * 4 + n3, n3 * 20))
    log(f"K9a prune mask {R}^3: equal, {int(pk.sum())} kept")
    del pk, pp
    init_kw = dict(density_lvs=list(SURF_LVS), alpha_rescale=0.005, prune_threshold=prune_t,
                   dilate=2)
    gs = T.init_surface_from_density(grid_r, **init_kw)
    cams = [frame_camera(0, 2), frame_camera(1, 2)]
    ck = W.sparse_grid_visibility_render_surf(gs, cams)
    surf = gs.surface_data.detach()[:, 0].contiguous()
    lvs = gs.level_set_data.float().contiguous()
    sweeps = []
    for c in cams:
        r = c.gen_rays(device=device)
        o, d, _, _ = dda.preprocess_rays(gs, r.origins, r.dirs)
        tn, tx = dda.ray_bounds(gs, o, d)
        ok = torch.isfinite(tn) & torch.isfinite(tx) & (tn <= tx)
        sweeps.append((o.contiguous(), d.contiguous(),
                       torch.where(ok, tn, torch.zeros_like(tn)).contiguous(),
                       torch.where(ok, tx, torch.full_like(tx, -1.0)).contiguous()))
    counts = torch.zeros(gs.capacity, dtype=torch.int32, device=device)

    def vis_plain():
        work = [0, 0]
        for o, d, tn, tx in sweeps:
            for s in range(0, o.shape[0], 8192):
                e = s + 8192
                n_seg, n_cub = W._visibility_chunk_plain(gs.links, surf, gs.level_set_data,
                                                         counts, o[s:e], d[s:e], tn[s:e], tx[s:e])
                work[0] += n_seg
                work[1] += n_cub
        return work

    (n_seg, n_cub), vp_ms = timed_once(vis_plain)
    check_equal("K9d visibility counts", ck, counts.float())
    scratch = torch.zeros_like(counts)

    def k9d():
        for sw in sweeps:
            kernels.visibility(*sw, gs.links, surf, lvs, scratch)

    B2 = sum(sw[0].shape[0] for sw in sweeps)
    res["visibility"] = dict(
        max_abs_err=0.0, plain_ms=vp_ms, ms=time_ms(k9d, 3),
        bound=bound_ms(n3 * 4 + gs.capacity * 8 + B2 * 8 * 4, n_seg * 30 + n_cub * 600))
    log(f"K9d visibility {R}^3 (capacity {gs.capacity}), two {WIDTH}x{HEIGHT} cameras: counts "
        f"equal, {n_seg} voxels walked, {n_cub} cubics, max count {int(ck.max())}")
    gs = T.init_surface_from_density(grid_r, weight_init_cams=cams, visibility_pruning_scale=0.01,
                                     **init_kw)
    del grid_r, counts, scratch, sweeps, ck
    torch.cuda.empty_cache()

    # resample_surface 256^3 -> 512^3, alpha threshold, keep_lv_band, max_elements
    U = UPSAMPLE_RESO
    new2 = (U, U, U)
    u3 = U ** 3
    tables2 = T.resample_tables(gs.reso, new2, False, device)
    dens_s = gs.density_data.detach()[:, 0].contiguous()
    d2 = kernels.resample_dense(gs.links, dens_s, 0.0, tables2, new2)
    d2p, d2p_ms = timed_once(lambda: T._resample_dense_plain(T._dense_of(gs.links, dens_s, 0.0),
                                                               tables2))
    err_d = check_close(f"K9b every vertex {U}^3", d2, d2p, RS_RTOL, RS_ATOL)
    res["resample_dense"] = dict(
        max_abs_err=err_d, plain_ms=d2p_ms,
        ms=time_ms(lambda: kernels.resample_dense(gs.links, dens_s, 0.0, tables2, new2), 10),
        bound=bound_ms(n3 * 4 + gs.capacity * 4 + u3 * 4, u3 * 21))
    del d2p
    thresh2 = T._kth_largest_thresh(d2.reshape(-1), MAX_ELEMENTS, 1e-8)
    m2 = kernels.keep_mask(d2, thresh2, 2)
    m2p, m2p_ms = timed_once(lambda: T._dilate_plain(d2 >= thresh2, 2))
    check_equal(f"K9a keep mask {U}^3", m2, m2p)
    res["keep_mask"] = dict(max_abs_err=0.0, plain_ms=m2p_ms,
                            ms=time_ms(lambda: kernels.keep_mask(d2, thresh2, 2), 10),
                            bound=bound_ms(u3 * 4 + u3, u3 * 16))
    del m2p
    surf_s = gs.surface_data.detach()[:, 0].contiguous()
    s2 = kernels.resample_dense(gs.links, surf_s, -1.0, tables2, new2)
    err_s = check_close(f"K9b surface {U}^3", s2, T._resample_dense_plain(
        T._dense_of(gs.links, surf_s, -1.0), tables2), RS_RTOL, RS_ATOL)
    lvs_s = gs.level_set_data.float().contiguous()
    bk = kernels.lv_band(s2, lvs_s)
    bp, bp_ms = timed_once(lambda: T._lv_band_plain(s2, lvs_s))
    check_equal(f"K9a level-set band {U}^3", bk, bp)
    res["lv_band"] = dict(max_abs_err=0.0, plain_ms=bp_ms,
                          ms=time_ms(lambda: kernels.lv_band(s2, lvs_s), 10),
                          bound=bound_ms(u3 * 4 + u3, u3 * 20 * lvs_s.numel()))
    full = m2 | bk
    log(f"K9a {U}^3: keep mask (threshold {thresh2:.4e} for {MAX_ELEMENTS} elements) "
        f"{int(m2.sum())} and level-set band {int(bk.sum())} equal, {int(full.sum())} kept; "
        f"K9b density, surface max abs err {err_d:.3e}, {err_s:.3e}")
    del bp, bk, m2, s2, d2
    links2, kept2 = T._links_pass(full)
    rows2 = torch.cat([gs.density_data.detach(), gs.sh_data.detach(), gs.surface_data.detach()],
                      dim=1).contiguous()
    C = rows2.shape[1]
    fills = [0.0] + [0.0] * (C - 2) + [-1.0]
    fills_t = torch.as_tensor(fills, **f32)
    rk, _ = kernels.resample_rows(gs.links, rows2, fills_t, kept2, tables2, new2, False)
    (rp, _), rp_ms = timed_once(lambda: T._resample_rows_plain(gs.links, rows2, fills, kept2,
                                                                tables2, new2, False))
    err_r = check_close(f"K9b kept rows {U}^3", rk, rp, RS_RTOL, RS_ATOL)
    N = kept2.numel()
    res["resample_rows"] = dict(
        max_abs_err=err_r, plain_ms=rp_ms,
        ms=time_ms(lambda: kernels.resample_rows(gs.links, rows2, fills_t, kept2, tables2, new2,
                                                 False), 5),
        bound=bound_ms(n3 * 4 + gs.capacity * C * 4 + N * 8 + N * C * 4, N * C * 21))
    del rp, rk
    api = T.resample_surface(gs, new2, alpha_thresh=1e-8, max_elements=MAX_ELEMENTS,
                             keep_lv_band=True)
    check_equal("resample_surface's links", api.links, links2)
    log(f"K9b kept rows {U}^3: {N} rows x {C} channels, max abs err {err_r:.3e}; "
        f"resample_surface's links equal (capacity {api.capacity})")
    del api, full, links2, kept2, rows2
    torch.cuda.empty_cache()
    # where the time of the Trainer's 512^3 upsample goes: the weight
    # threshold over 20 cameras, as thresh_type "weight" runs it
    cams20 = [frame_camera(i, 20) for i in range(20)]
    profile_device(lambda: T.resample_surface(
        gs, new2, weight_thresh=Config().weight_thresh / U, cameras=cams20,
        max_elements=MAX_ELEMENTS, keep_lv_band=True),
        f"the {R}^3 -> {U}^3 upsample with 20 {WIDTH}x{HEIGHT} cameras", card)
    del gs
    torch.cuda.empty_cache()
    for name, r in res.items():
        log(f"time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound'][0]:.5f} ms ({r['bound'][1]}) [{card}]")
    return res


def stages_config(steps=STAGE_STEPS) -> str:
    """The three-stage run's config file: tools/recipe_run.py's
    configuration (reso 256^3, 256^3, 512^3; its thresholds, level sets,
    alpha rescale, max_grid_elements and surface-stage schedules, with the
    stage lengths of STAGE_STEPS), with the reference's camera sweeps on
    (thresh_type "weight", visibility_pruning_scale 0.01). The density
    and colour schedules are the Config's, as the warm phase runs them: the
    recipe's undelayed lr_sigma of 30 needs its 600 steps, and its
    surface-stage lr_alpha, which ramps up from 1e-4 over the first 1,200
    surface steps, leaves the initial raw alpha (0.005 x density, 0.01-0.03
    at the level sets) nearly transparent for longer than this run. The synthetic dataset of
    the warm phase; an eval at the end of each stage, with the recipe's
    in-training extraction and Chamfer (log_pts, eval_cf, 3 samples, raw
    density threshold 0.1) against the data dir's shape.npy. ``steps``
    replaces STAGE_STEPS."""
    n0, n1, n2 = steps
    total, ns = n0 + n1 + n2, n1 + n2
    R, U = CUVOL_RESO, UPSAMPLE_RESO
    keys = {
        "dataset_type": "synthetic", "n_train_images": 20, "dataset_width": WIDTH,
        "dataset_height": HEIGHT, "dataset_reso": SMALL_RESO, "dataset_renderer": "packed",
        "dataset_test_images": 2,
        "reso": f"[[{R}, {R}, {R}], [{R}, {R}, {R}], [{U}, {U}, {U}]]", "surface_type": "sdf",
        "batch_size": 8192, "n_iters": total, "no_surface_init_iters": n0, "upsamp_every": n0,
        "density_thresh": "1.0", "surf_init_density_lvs": f"[{SURF_LVS[0]}, {SURF_LVS[1]}]",
        "surf_init_alpha_rescale": "0.005", "visibility_pruning_scale": "0.01",
        "thresh_type": "weight", "alpha_upsample_thresh": "1.0e-8",
        "max_grid_elements": MAX_ELEMENTS, "init_sigma": "0.1",
        "lr_surface": "1.0e-5", "lr_surface_final": "1.0e-5",
        "lr_surface_delay_steps": n0 + ns // 2, "lr_surface_delay_mult": "1.0e-2",
        "lr_surface_decay_steps": n0 + ns,
        "lambda_tv_alpha": "1.0e-5", "lambda_tv_surface": "1.0e-3",
        "tv_surface_sparsity": "1.0", "norm_surface_sparsity": "1.0",
        "surf_normal_loss_lambda_type": "const", "lambda_normal_loss": "1.0e-6",
        "surf_norm_reg_l1": "True", "no_surf_norm_con_check": "True",
        "lambda_sparsify_alpha": "1.0e-9", "lambda_sparsify_surf": "0.0",
        "sparsify_surf_decrease": "True", "sparsify_surf_thresh": "0.15",
        "alpha_surf_sparsify_sparsity": "0.05", "delay_sparsify_surf": n0 + ns // 2,
        "lambda_l_entropy": "1.0e-4", "lambda_conv_mode_samp": "0.0",
        "only_outward_intersect": "True", "surf_fake_sample": "False",
        "limited_fake_sample": "True", "truncated_vol_render": "True",
        "trunc_vol_render_lv_remove": "True", "trunc_vol_weight_min": "1.0e-10",
        "fs_std_decay_type": "linear", "fake_sample_std": "0.1",
        "fake_sample_std_final": "1.0e-6", "fake_sample_std_decay_steps": n0 + ns,
        "fake_sample_std_delay": n0, "trunc_vol_a_decay_type": "linear",
        "truncated_vol_render_a": "5.0", "truncated_vol_render_a_final": "1.0",
        "truncated_vol_render_a_decay_steps": n0 + ns // 2, "truncated_vol_render_a_delay": n0,
        "sigma_thresh": "-10000.0", "stop_thresh": "-10000.0", "eval_every_iter": n0,
        "print_every": max(1, min(x for x in steps if x) // 2), "save_every": -1,
        "n_eval_test": 2,
        "final_render_eval": "False", "tune_mode": "True",
        "log_pts": "True", "eval_cf": "True", "surf_eval_n_sample": 3,
        "surf_eval_intersect_th": "0.1",
    }
    return "".join(f"{k} = {v}\n" for k, v in keys.items())


class _Tee:
    """A stdout that also keeps what was written."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, s):
        self.parts.append(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()


def recipe_shape(data_dir: Path) -> Path:
    """tools/recipe_run.py's Chamfer GT in ``data_dir``: 20,000 points of
    the synthetic sphere in the extractor's frame (radius 0.5 world units
    over its scene scale 2/3)."""
    import numpy as np

    from alphasurf_torch.app.pipeline import synthetic_gt_points

    data_dir.mkdir(parents=True, exist_ok=True)
    path = data_dir / "shape.npy"
    np.save(path, synthetic_gt_points(CUVOL_RESO) / (2.0 / 3.0))
    return path


def chamfer_floor(device, shape: Path) -> dict:
    """The in-training extraction's Chamfer of the GT grid itself
    (make_gt_grid(SMALL_RESO), the synthetic dataset's), as _eval_points
    takes it: the floor of the three-stage run's cf_mean."""
    import numpy as np

    from alphasurf_torch.data.synthetic import make_gt_grid
    from alphasurf_torch.geometry.chamfer import chamfer, downsample_points
    from alphasurf_torch.geometry.extract import extract_iso_points

    pts = extract_iso_points(make_gt_grid(SMALL_RESO, device=device), n_sample=3,
                             density_thresh=0.1, scene_scale=2.0 / 3.0)
    return chamfer(downsample_points(pts, 0.001), np.load(shape))


def stages(device, card: str, work: Path) -> tuple[dict, dict]:
    """Phase 6: the K9 kernel checks, then the three stages through
    app/train.main with the counters set to 0 just before and read just
    after. Returns the kernels' numbers and the run's launches."""
    import contextlib
    import math
    import re

    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.app import train as train_app
    from alphasurf_torch.data import SyntheticDataset

    res = check_stage_kernels(device, card)
    cfg_path = work / "stages.yaml"
    cfg_path.write_text(stages_config())
    train_dir = work / "stages"
    shape = recipe_shape(work / "stages_data")
    torch.cuda.reset_peak_memory_stats()
    tee = _Tee(sys.stdout)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        psnr = train_app.main([str(shape.parent), "-t", str(train_dir), "-c", str(cfg_path),
                               "--device", str(device)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log("launches " + json.dumps(launches))
    missing = [k for k in STAGE_RUN_KERNELS + ("reg_tv_every", "reg_normal_every")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels of the three-stage run were not launched: {missing}")

    # every stage trained with a finite mse
    n0, n1, n2 = STAGE_STEPS
    mses = {}
    for m in re.finditer(r"^step (\d+) \[(\w+)\] mse=(\S+)", "".join(tee.parts), re.M):
        step, mse = int(m.group(1)), float(m.group(3))
        stage = 0 if step <= n0 else (1 if step <= n0 + n1 else 2)
        mses.setdefault(stage, []).append(mse)
    if sorted(mses) != [0, 1, 2] or not all(math.isfinite(v) for vs in mses.values() for v in vs):
        raise AssertionError(f"a stage has no finite mse: {mses}")
    # every transition logged with its capacity and seconds; no collapse
    tr = json.loads((train_dir / "transitions.json").read_text())
    kinds = [(t["kind"], t["reso"][0], t["step"]) for t in tr]
    if kinds != [("upsample", CUVOL_RESO, n0), ("init_surface_from_density", CUVOL_RESO, n0),
                 ("upsample", UPSAMPLE_RESO, n0 + n1)]:
        raise AssertionError(f"unexpected transitions: {kinds}")
    for t in tr:
        log(f"transition {t['kind']} at step {t['step']} -> {t['reso'][0]}^3: capacity "
            f"{t['capacity']}, {t['seconds']:.3f} s, occupied voxels {t['occupied_before']} -> "
            f"{t['occupied_after']} [{card}]")
        if not (t["capacity"] > 0 and t["seconds"] > 0):
            raise AssertionError(f"transition without capacity or time: {t}")
    up = tr[-1]
    if up["occupied_after"] is None or up["occupied_after"] < up["occupied_before"]:
        raise AssertionError(f"the {UPSAMPLE_RESO}^3 upsample lost occupied voxels: {up}")
    dset_test = SyntheticDataset(split="test", n_images=2, width=WIDTH, height=HEIGHT,
                                 reso=SMALL_RESO, renderer="packed", device=device)
    psnr0 = eval_untrained(device, dset_test)
    log(f"three stages through app/train.main: {STAGE_STEPS} steps at {CUVOL_RESO}^3 (cuvol), "
        f"{CUVOL_RESO}^3 and {UPSAMPLE_RESO}^3 (surface), batch 8192, in {wall:.2f} s (data set-up "
        f"and 3 evals included); last mse of each stage {[v[-1] for _, v in sorted(mses.items())]}; "
        f"final eval PSNR {psnr:.4f} against the untrained grid's {psnr0:.4f}; "
        f"max_memory_allocated {peak / 2**30:.3f} GiB [{card}]")
    if not psnr > psnr0:
        raise AssertionError(f"the three stages did not train: PSNR {psnr} <= untrained {psnr0}")
    # every surface-stage eval carries a finite Chamfer
    cfs = {}
    for m in re.finditer(r"^eval stats: step=(\d+) .*", "".join(tee.parts), re.M):
        step = int(m.group(1))
        cf = re.search(r" cf_mean=(\S+)", m.group(0))
        cfs[step] = float(cf.group(1)) if cf else None
    surf_evals = {k: v for k, v in cfs.items() if k > n0}
    if len(surf_evals) < 2 or not all(v is not None and math.isfinite(v)
                                      for v in surf_evals.values()):
        raise AssertionError(f"a surface-stage eval has no finite cf_mean: {cfs}")
    floor = chamfer_floor(device, shape)
    log(f"three stages: cf_mean at the evals {cfs} (world units over the scene scale 2/3); "
        f"the GT grid make_gt_grid({SMALL_RESO})'s own extraction against the same points: "
        f"cf_mean {floor['overall']:.5f} (d2s {floor['d2s']:.5f}, s2d {floor['s2d']:.5f})")
    return res, launches


# ---------------------------------------------------------------------------
# extraction and evaluation
# ---------------------------------------------------------------------------

ISO_N = 5  # extract_points' samples along a cell face
ISO_BATCH = 65536  # cells a K9g launch, the JAX package's batch
INTERSECT_TH = 0.1  # train_eval.sh --intersect_th, an alpha
GT_POINTS = 20000  # points of synthetic_gt_points
PIPELINE_STEPS = (100, 100)  # Plenoxels, surface: the Blender pipeline's
# the extraction phase's pipeline (cut from PIPELINE_STEPS for time; the
# Blender cell keeps its steps, its PSNR margin is 0.58 dB)
EXTRACT_PIPELINE_STEPS = (60, 60)
PIPELINE_VIEWS = 20  # train views of the pipeline's dataset
PIPELINE_BATCH = 8192
# the surface stage's overrides: the weight init, so that K9e runs, and the
# recipe's 256^3 surface learning rate (tools/recipe_run.py:126): the JAX
# pipeline's 1e-2 (to 1e-3) is set for its 32^3 default, and moves the
# metric-rescaled SDF by more than a 256^3 voxel a step
PIPELINE_SURFACE = {"surf_init_type": "weight", "lr_surface": 1e-5, "lr_surface_final": 1e-5}
# K9g against its plain version: the same float32 operations in the same
# order, built with --fmad=false, so the points are expected equal; a root
# within rounding of a face or of the density threshold may land on either
# side, so at most FLAG_FRACTION of the rays may differ (in presence or by
# more than ISO_ATOL grid units).
ISO_ATOL = 1e-6


def shell_checkpoint(device, work: Path) -> Path:
    """The serving phase's 512^3 shell checkpoint (written here when that
    phase did not run)."""
    import torch

    from alphasurf_torch.utils.io import save_grid

    ckpt = work / "ckpt.npz"
    if not ckpt.exists():
        save_grid(shell_grid(RESO, device)[0], str(ckpt))
        torch.cuda.empty_cache()
    return ckpt


def check_iso_points(device, card: str, ckpt: Path) -> dict:
    """Phase 7a: K9g against its plain version on every occupied cell of the
    512^3 shell checkpoint, extract_points' n and threshold, batch by
    batch; both timed over the whole extraction. The points in world units
    lie on the shell's analytic sphere (radius 0.5) to 0.1 voxel."""
    import math

    import numpy as np
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.core.grid import CORNER_OFFSETS
    from alphasurf_torch.geometry import extract as E
    from alphasurf_torch.utils.io import load_grid

    grid, _ = load_grid(str(ckpt), device=device)
    th = -math.log(1.0 - INTERSECT_TH)
    cells = E.occupied_cells(grid)
    N = cells.numel()
    field = grid.surface_data.detach()[:, 0].contiguous()
    dens = grid.density_data.detach()[:, 0].contiguous()
    batches = [cells[s:s + ISO_BATCH] for s in range(0, N, ISO_BATCH)]
    n_rays = N * 3 * ISO_N ** 2
    n_diff = n_k = n_p = 0
    err = 0.0
    for b in batches:
        pk = kernels.iso_points(b, grid.links, field, dens, 0.0, th, ISO_N)
        pp = E._extract_cell_points(grid, b, ISO_N, th, 0.0)
        nan_k, nan_p = torch.isnan(pk).any(-1), torch.isnan(pp).any(-1)
        both = ~nan_k & ~nan_p
        d = (pk - pp).abs().amax(-1)
        n_diff += int(((nan_k != nan_p) | (both & (d > ISO_ATOL))).sum())
        n_k += int((~nan_k).sum())
        n_p += int((~nan_p).sum())
        if bool(both.any()):
            err = max(err, float(d[both].max()))
    if n_diff > FLAG_FRACTION * n_rays:
        raise AssertionError(f"K9g differs from its plain version on {n_diff} of {n_rays} rays")
    log(f"K9g iso points {RESO}^3 shell, {N} occupied cells in {len(batches)} launches, n = "
        f"{ISO_N}: {n_k} points (plain {n_p}) of {n_rays} rays, {n_diff} rays differ, max abs err "
        f"{err:.3e} grid units")

    def k9g():
        for b in batches:
            kernels.iso_points(b, grid.links, field, dens, 0.0, th, ISO_N)

    def plain():
        for b in batches:
            E._extract_cell_points(grid, b, ISO_N, th, 0.0)

    _, plain_ms = timed_once(plain)
    # the bytes K9g must move: the cell ids, the links of the cells' distinct
    # corners and their surface and density rows (every corner of an
    # occupied cell is present, each link its own row), the points
    X, Y, Z = grid.links.shape
    corner = torch.zeros(X * Y * Z, dtype=torch.bool, device=device)
    for dx, dy, dz in CORNER_OFFSETS.tolist():
        corner[cells + (dx * Y + dy) * Z + dz] = True
    n_corners = int(corner.sum())
    del corner
    res = {"iso_points": dict(
        max_abs_err=err, ms=time_ms(k9g, 3), plain_ms=plain_ms,
        bound=bound_ms(N * 8 + n_corners * (4 + 8) + n_rays * 12, n_rays * 200))}
    log(f"K9g reads {N} cell ids and the links and rows of {n_corners} distinct corners, "
        f"writes {n_rays * 12} bytes of points")
    pts = E.extract_iso_points(grid, n_sample=ISO_N, density_thresh=th)
    dev = np.abs(np.linalg.norm(pts.astype(np.float64), axis=-1) - 0.5)
    tol = 0.1 * 2.0 / RESO
    log(f"K9g points in world units: {len(pts)}, largest distance from the sphere of radius 0.5 "
        f"{dev.max():.3e} (0.1 voxel = {tol:.3e})")
    if len(pts) != n_k or not dev.max() <= tol:
        raise AssertionError(f"the shell's points are not on its sphere: {len(pts)} points, "
                             f"largest distance {dev.max()}")
    profile_device(lambda: E.extract_iso_points(grid, n_sample=ISO_N, density_thresh=th),
                   f"the extraction of the {RESO}^3 shell", card)
    del grid, cells, field, dens, batches
    torch.cuda.empty_cache()
    return res


def check_transmit(device, card: str) -> dict:
    """Phase 7b: K9e against its plain version on the 256^3 blobby density
    grid with two 800x800 cameras, equal maxima; init_surface_from_density
    with the weight init against the same init with the plain maxima;
    both marches timed."""
    import math

    import numpy as np
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.core import topology as T
    from alphasurf_torch.core import weight_render as W

    f32 = dict(dtype=torch.float32, device=device)
    grid, _ = blobby_cuvol_grid(CUVOL_RESO, device)
    R = CUVOL_RESO
    cams = [frame_camera(0, 2), frame_camera(1, 2)]
    wk = W.sparse_grid_weight_render(grid, cams)
    gsz = np.asarray(grid.reso, np.float32)
    sc = torch.as_tensor(grid.scaling.cpu().numpy() * gsz, **f32)
    off = torch.as_tensor(grid.offset.cpu().numpy() * gsz, **f32)
    n_steps = int(math.ceil(math.sqrt(3 * (R - 1) ** 2) / 0.5)) + 2
    preps = []
    for c in cams:
        r = c.gen_rays(device=device)
        preps.append([x.contiguous() for x in W._march_prep(r.origins, r.dirs, sc, off,
                                                            torch.as_tensor(gsz, **f32), 0.5)])
    dens = grid.density_data.detach()[:, 0].contiguous()
    out = torch.zeros(grid.capacity + 1, **f32)
    n_samp, wp_ms = timed_once(lambda: sum(
        W._transmit_march_plain(grid.links, dens, out, *p, 0.5, 0.0, n_steps) for p in preps))
    wp = out[:grid.capacity]
    check_equal("K9e maxima", wk, wp)
    bits = torch.zeros(grid.capacity, dtype=torch.int32, device=device)

    def k9e():
        for p in preps:
            kernels.transmit_march(*p, grid.links, dens, 0.5, 0.0, n_steps, bits)

    B = preps[0][0].shape[0]
    res = {"transmit_march": dict(
        max_abs_err=0.0, ms=time_ms(k9e, 3) / len(cams), plain_ms=wp_ms / len(cams),
        bound=bound_ms(R ** 3 * 4 + grid.capacity * 8 + B * 9 * 4, n_samp / len(cams) * 40))}
    log(f"K9e transmittance march {R}^3 (capacity {grid.capacity}), two {WIDTH}x{HEIGHT} cameras: "
        f"{n_samp} samples, maxima equal, {int((wp > 0).sum())} vertices reached, "
        f"{n_steps} steps at most")
    # the weight init, with the kernel's maxima and with the plain ones
    kw = dict(density_lvs=list(SURF_LVS), alpha_rescale=0.005, prune_threshold=min(SURF_LVS) / 2,
              dilate=2, init_type="weight", weight_init_cams=cams)
    gk = T.init_surface_from_density(grid, **kw)
    sweep = W.sparse_grid_weight_render
    W.sparse_grid_weight_render = lambda g, c: wp.clone()
    try:
        gp = T.init_surface_from_density(grid, **kw)
    finally:
        W.sparse_grid_weight_render = sweep
    check_equal("the weight init's links", gk.links, gp.links)
    for f in ("density_data", "surface_data", "sh_data", "level_set_data"):
        check_equal(f"the weight init's {f}", getattr(gk, f), getattr(gp, f))
    log(f"init_surface_from_density(init_type='weight'): capacity {gk.capacity}, equal to the "
        f"init on the plain maxima")
    del grid, gk, gp, wk, wp, out, bits, preps
    torch.cuda.empty_cache()
    return res


def check_apps(device, card: str, ckpt: Path, work: Path) -> None:
    """Phase 7c: the shell checkpoint through app/extract_points.main
    (train_eval.sh's threshold and downsample) and app/eval_cf.main
    against GT_POINTS points of its sphere: Chamfer below 0.01 world units
    (their mean spacing is about 0.006)."""
    import numpy as np

    from alphasurf_torch.app import eval_cf, extract_points
    from alphasurf_torch.app.pipeline import synthetic_gt_points

    gt = work / "shell_gt.npy"
    np.save(gt, synthetic_gt_points(RESO, n=GT_POINTS))
    out = work / "shell_pts.npy"
    t0 = time.perf_counter()
    pts = extract_points.main([str(ckpt), "--out", str(out), "--intersect_th", str(INTERSECT_TH),
                               "--downsample", "0.001", "--device", str(device)])
    t1 = time.perf_counter()
    cf = eval_cf.main([str(out), str(gt)])
    t2 = time.perf_counter()
    log(f"extract_points on the {RESO}^3 shell: {len(pts)} points after the 0.001 downsample in "
        f"{t1 - t0:.2f} s (checkpoint load included); eval_cf against {GT_POINTS} points in "
        f"{t2 - t1:.2f} s: {json.dumps(cf)} [{card}]")
    if not (len(pts) > 0 and cf["overall"] < 0.01):
        raise AssertionError(f"the shell's Chamfer is not below 0.01: {cf}")


def pipeline_run(device, card: str, work: Path) -> dict:
    """Phase 7d: app/pipeline.run_pipeline at full width (CUVOL_RESO^3,
    PIPELINE_VIEWS train and 2 test views at 800x800, EXTRACT_PIPELINE_STEPS, the surface stage
    with PIPELINE_SURFACE, train_eval.sh's Chamfer downsample 0.001), with
    the counters set to 0 just before and read just after. Returns the
    run's launches."""
    import math

    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.app import pipeline
    from alphasurf_torch.data import SyntheticDataset

    out_dir = work / "pipeline"
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = pipeline.run_pipeline(
        str(out_dir), reso=CUVOL_RESO, n_train_images=PIPELINE_VIEWS, image_size=WIDTH,
        n_iters_plenoxels=EXTRACT_PIPELINE_STEPS[0], n_iters_surface=EXTRACT_PIPELINE_STEPS[1],
        batch_size=PIPELINE_BATCH, n_eval_images=2, overrides_surface=PIPELINE_SURFACE,
        eval_downsample=0.001, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log("launches " + json.dumps(launches))
    missing = [k for k in PIPELINE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels of the pipeline were not launched: {missing}")
    st = res["stages"]
    for name, r in st.items():
        log(f"pipeline stage {name}: " + json.dumps(r) + f" [{card}]")
    init = json.loads((out_dir / "surface" / "transitions.json").read_text())
    log(f"pipeline surface init: {json.dumps(init)} [{card}]")
    # the dataset's default ground truth, as the pipeline renders it: the
    # dense walk (K11a) on host-made rays, which renders them as the packed
    # renderer does, so the numbers stay comparable with earlier runs
    dset_test = SyntheticDataset(split="test", n_images=2, width=WIDTH, height=HEIGHT,
                                 reso=CUVOL_RESO, device=device)
    psnr0 = eval_untrained(device, dset_test)
    s = res["summary"]
    log(f"pipeline at {CUVOL_RESO}^3, {EXTRACT_PIPELINE_STEPS} steps of {PIPELINE_BATCH} rays: "
        f"PSNR {s['psnr']:.4f} against the untrained grid's {psnr0:.4f}, {st['extract']['n_points']} "
        f"points, Chamfer {s['chamfer']:.5f}, {wall:.2f} s in all (data set-up included), "
        f"max_memory_allocated {peak / 2**30:.3f} GiB [{card}]")
    if not (s["psnr"] > psnr0 and st["extract"]["n_points"] > 0 and math.isfinite(s["chamfer"])
            and (out_dir / "pipeline_results.json").is_file()):
        raise AssertionError(f"the pipeline did not run right: {s}, untrained PSNR {psnr0}")
    return launches


def extract(device, card: str, work: Path) -> tuple[dict, dict]:
    """Phase 7: K9g and K9e against their plain versions, the apps on the
    shell checkpoint, then the pipeline. Returns the kernels' numbers and
    the pipeline's launches."""
    ckpt = shell_checkpoint(device, work)
    res = check_iso_points(device, card, ckpt)
    res.update(check_transmit(device, card))
    check_apps(device, card, ckpt, work)
    launches = pipeline_run(device, card, work)
    for name, r in res.items():
        log(f"time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound'][0]:.5f} ms ({r['bound'][1]}) [{card}]")
    return res, launches


# ---------------------------------------------------------------------------
# the DTU masked-capture path
# ---------------------------------------------------------------------------

DTU_VIEWS = 6  # a DTU scan has 49 or 64: the depth cut of the time limit
DTU_W, DTU_H = 1600, 1200  # DTU's own image size
DTU_FOCAL = 2400.0
MM_PER_UNIT = 100.0  # scale_mat: the unit sphere onto a 100 mm object
MM_CENTER = (-12.5, 31.0, 640.0)  # the object's centre in the capture's millimetres
DTU_SCAN = 1
# the DTU protocol's millimetres (eval_dtu.py defaults: max_dist 20,
# patch_size 60, visualize_threshold 10; downsample_density 0.2) in the
# scene's normalized units, where the points are (pt_rescale is not applied)
DTU_PROTOCOL = {"max_dist": 20.0, "patch_size": 60.0, "visualize_threshold": 10.0,
                "downsample_density": 0.2}
DTU_OBS_RES = 0.01  # ObsMask cell, normalized units
GT_DTU_POINTS = 100000  # the stl: points of the analytic sphere


def dtu_cameras():
    """The scene's DTU_VIEWS views: (normalized c2w, fx, fy, cx, cy) on the upper
    hemisphere at distance 2.7, each with its own principal point."""
    import numpy as np

    from alphasurf_torch.data.synthetic import pose_spherical

    rng = np.random.default_rng(SEED + 6)
    cams = []
    for i in range(DTU_VIEWS):
        c2w = pose_spherical(360.0 * i / DTU_VIEWS + rng.uniform(0, 10), rng.uniform(10, 50), 2.7)
        cams.append((c2w.astype(np.float64), DTU_FOCAL, DTU_FOCAL * 1.0005,
                     DTU_W / 2 + rng.uniform(-25, 25), DTU_H / 2 + rng.uniform(-25, 25)))
    return cams


def write_dtu_scene(device, root: Path) -> dict:
    """A DTU-format scan (IDR layout) of make_gt_grid(CUVOL_RESO), rendered
    by the port's packed renderer: image/NNN.png, mask/NNN.png (255 where
    the rendered opacity is above 0.5) written by utils/png.py, and
    cameras_sphere.npz with world_mat_i = K [R|t] in millimetres and
    scale_mat_i mapping the unit sphere onto the object. Returns timings."""
    import numpy as np
    import torch

    from alphasurf_torch.core.options import RenderOptions
    from alphasurf_torch.core.rays import Camera, Rays
    from alphasurf_torch.data.synthetic import make_gt_grid
    from alphasurf_torch.render import surface as S
    from alphasurf_torch.render.surface import occupancy_words, volume_render_surface_packed
    from alphasurf_torch.utils.png import write_png

    (root / "image").mkdir(parents=True, exist_ok=True)
    (root / "mask").mkdir(parents=True, exist_ok=True)
    grid = make_gt_grid(CUVOL_RESO, device=device)
    opt = RenderOptions(sigma_thresh=-1e9, stop_thresh=-1.0, only_outward_intersect=True)
    words = occupancy_words(grid, opt)
    # the float32 ray bounds lose the exit of about 6.5% of these rays
    # (ROADMAP §3), which then render empty: as background rays through the
    # object they would prune it. Those rays go through the plain path on a
    # float64 copy of the grid.
    grid64 = make_gt_grid(CUVOL_RESO, dtype=torch.float64, device=device)
    with torch.no_grad():
        words64 = S._occupancy_words_plain(grid64, opt)
        packed64 = S.pack_grid_data(grid64)
    n_redo = 0
    scale_mat = np.eye(4)
    scale_mat[:3, :3] *= MM_PER_UNIT
    scale_mat[:3, 3] = MM_CENTER
    mats = {}
    t_render = t_png = 0.0
    for i, (c2w, fx, fy, cx, cy) in enumerate(dtu_cameras()):
        t0 = time.perf_counter()
        rays = Camera.make(c2w, fx=fx, fy=fy, cx=cx, cy=cy, width=DTU_W,
                           height=DTU_H).gen_rays(device)
        rgb, alpha = [], []
        with torch.no_grad():
            for s0 in range(0, rays.origins.shape[0], 65536):
                out = volume_render_surface_packed(
                    grid, Rays(rays.origins[s0:s0 + 65536], rays.dirs[s0:s0 + 65536]), opt,
                    occupancy=words)
                rgb.append(out["rgb"])
                alpha.append(out["alpha"])
        rgb, alpha = torch.cat(rgb), torch.cat(alpha)
        redo = torch.nonzero(_exit_lost(grid, grid64, rays))[:, 0]
        n_redo += redo.numel()
        for s0 in range(0, redo.numel(), CHUNK):
            idx = redo[s0:s0 + CHUNK]
            r64 = Rays(rays.origins[idx].double(), rays.dirs[idx].double())
            with torch.no_grad():
                origins, dirs, sh_mult, tn, tx, ngt = chunk_inputs(grid64, opt, r64)
                pool = S._compact_crossings_plain(grid64.reso, origins, dirs, tn, tx, words64)
                smp = S._voxel_samples_plain(grid64, opt, pool, origins, dirs, sh_mult, ngt,
                                             packed64)
                comp = S._composite_plain(opt, grid64.truncated_vol_render_a, pool.offsets, smp)
            rgb[idx] = comp["rgb"].float()
            alpha[idx] = (1.0 - torch.exp(comp["log_T"])).float()
        img = (torch.clamp(rgb, 0, 1) * 255 + 0.5).to(torch.uint8)
        msk = ((alpha > 0.5).to(torch.uint8) * 255)[:, None].expand(-1, 3)
        img = img.reshape(DTU_H, DTU_W, 3).cpu().numpy()
        msk = msk.reshape(DTU_H, DTU_W, 3).cpu().numpy()
        t1 = time.perf_counter()
        write_png(root / "image" / f"{i:03d}.png", img, level=1)
        write_png(root / "mask" / f"{i:03d}.png", msk, level=1)
        t_png += time.perf_counter() - t1
        t_render += t1 - t0
        K = np.eye(4)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
        c2w_mm = c2w.copy()
        c2w_mm[:3, 3] = MM_PER_UNIT * c2w[:3, 3] + np.asarray(MM_CENTER)
        mats[f"world_mat_{i}"] = K @ np.linalg.inv(c2w_mm)
        mats[f"scale_mat_{i}"] = scale_mat
    np.savez(root / "cameras_sphere.npz", **mats)
    del grid, words, grid64, words64, packed64
    torch.cuda.empty_cache()
    return {"render_s": t_render, "png_s": t_png, "redo": n_redo}


def _exit_lost(grid, grid64, rays):
    """The rays whose float32 bounds (the renderer's) differ from their
    float64 ones by more than 1e-3 grid units."""
    import torch

    from alphasurf_torch.ops import dda

    bounds = []
    for g, dt in ((grid, torch.float32), (grid64, torch.float64)):
        o, d, _, _ = dda.preprocess_rays(g, rays.origins.to(dt), rays.dirs.to(dt))
        bounds.append([b.double() for b in dda.ray_bounds(g, o, d)])
    lost = torch.zeros_like(bounds[0][0], dtype=torch.bool)
    for a, b in zip(*bounds):
        same_kind = torch.isfinite(a) == torch.isfinite(b)
        diff = torch.where(torch.isfinite(a) & torch.isfinite(b), (a - b).abs(),
                           torch.zeros_like(a))
        lost |= ~same_kind | (diff > 1e-3)
    return lost


def write_obs_mask(root: Path) -> Path:
    """The DTU evaluation's files for the scene, in its normalized units:
    ObsMask (every cell within 0.2 of the sphere of radius 0.5 observed),
    its bounding box and resolution, a ground plane below the object, and
    the stl: GT_DTU_POINTS points of the sphere."""
    import numpy as np
    from scipy.io import savemat

    from alphasurf_torch.app.pipeline import synthetic_gt_points
    from alphasurf_torch.geometry.dtu_eval import write_ply_points

    d = root / "MVS Data"
    (d / "ObsMask").mkdir(parents=True, exist_ok=True)
    (d / "Points" / "stl").mkdir(parents=True, exist_ok=True)
    BB = np.array([[-0.7, -0.7, -0.7], [0.7, 0.7, 0.7]])
    n = int(round(1.4 / DTU_OBS_RES)) + 1
    ax = BB[0, 0] + DTU_OBS_RES * np.arange(n)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    obs = (np.abs(np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 0.5) < 0.2).astype(np.uint8)
    savemat(str(d / "ObsMask" / f"ObsMask{DTU_SCAN}_10.mat"),
            {"ObsMask": obs, "BB": BB, "Res": np.array([[DTU_OBS_RES]])})
    savemat(str(d / "ObsMask" / f"Plane{DTU_SCAN}.mat"),
            {"P": np.array([[0.0], [0.0], [1.0], [0.6]])})
    write_ply_points(str(d / "Points" / "stl" / f"stl{DTU_SCAN:03d}_total.ply"),
                     synthetic_gt_points(CUVOL_RESO, n=GT_DTU_POINTS))
    return d


def dtu_config(data_dir: Path) -> str:
    """The DTU run's config: the three-stage recipe of stages_config
    (256^3 cuvol, 256^3 surface from its density with mask pruning and the
    camera sweeps, 512^3 surface; STAGE_STEPS steps, an eval of two views
    at the end of each stage) on the DTU loader."""
    keys = {}
    for line in stages_config().splitlines():
        k, v = line.split(" = ", 1)
        if not (k.startswith("dataset_") or k in ("log_pts", "eval_cf")):
            keys[k] = v
    keys.update({"dataset_type": "dtu", "data_dir": str(data_dir),
                 "save_every": STAGE_STEPS[0] + STAGE_STEPS[1]})
    return "".join(f"{k} = {v}\n" for k, v in keys.items())


def mask_plain(grid, origins, dirs, out, near_clip: float = 0.0) -> int:
    """K9f's plain version over world rays (on the host or the card), CHUNK
    rays at a time (the plain version's chunk) on the grid's device, set
    into ``out``. Returns the segments walked."""
    import torch

    from alphasurf_torch.core import weight_render as W

    dev, n_seg = grid.links.device, 0
    for s0 in range(0, origins.shape[0], CHUNK):
        rays = W._mask_rays(grid, torch.as_tensor(origins[s0:s0 + CHUNK]).to(dev),
                            torch.as_tensor(dirs[s0:s0 + CHUNK]).to(dev), near_clip)
        n_seg += W._mask_chunk_plain(grid.links, out, *rays)
    return n_seg


def mask_corners(links, o, d, tn, tx) -> int:
    """The distinct lattice positions of the corners of the voxels that K9f
    walks for these grid-space rays: the link entries it must read."""
    import torch

    from alphasurf_torch.core import weight_render as W

    X, Y, Z = links.shape
    _, _, seg_valid, l, in_bounds = W.all_crossings((X, Y, Z), o, d, tn, tx)
    base = ((l[..., 0] * Y + l[..., 1]) * Z + l[..., 2])[seg_valid & in_bounds]
    voxels = torch.unique(base)
    del base, l
    return int(torch.unique(voxels[:, None] + W._corner_offsets(Y, Z, links.device)).numel())


def check_mask_kernel(device, card: str) -> dict:
    """K9f against its plain version, equal: on one CHUNK-ray chunk of a
    1600x1200 view of the 256^3 blobby grid (the plain version's chunk),
    both timed; and in one launch over the view's 1.92M rays (the main
    path's launch shape, 2^21 rays at most) against the plain version's
    chunks over the same rays, the kernel timed."""
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.core import weight_render as W
    from alphasurf_torch.core.rays import Camera

    grid, _ = blobby_cuvol_grid(CUVOL_RESO, device)
    c2w, fx, fy, cx, cy = dtu_cameras()[0]
    rays = Camera.make(c2w, fx=fx, fy=fy, cx=cx, cy=cy, width=DTU_W,
                       height=DTU_H).gen_rays(device)
    mid = rays.origins.shape[0] // 2 - CHUNK // 2  # a chunk across the object
    o, d, tn, tx = (x.contiguous() for x in W._mask_rays(
        grid, rays.origins[mid:mid + CHUNK], rays.dirs[mid:mid + CHUNK], 0.0))
    out_k = torch.zeros(grid.capacity, dtype=torch.float32, device=device)
    kernels.mask_march(o, d, tn, tx, grid.links, out_k)
    out_p = torch.zeros(grid.capacity, dtype=torch.float32, device=device)
    n_seg = W._mask_chunk_plain(grid.links, out_p, o, d, tn, tx)
    check_equal("K9f mask", out_k, out_p)
    n_set = int(out_k.sum())
    n_corner = mask_corners(grid.links, o, d, tn, tx)
    log(f"K9f mask sweep {CUVOL_RESO}^3 (capacity {grid.capacity}), {CHUNK} rays of a "
        f"{DTU_W}x{DTU_H} view: {n_seg} segments, {n_corner} distinct corner positions, "
        f"{n_set} rows set, equal to the plain version")
    _, plain_ms = timed_once(lambda: W._mask_chunk_plain(grid.links, out_p, o, d, tn, tx))
    # bound: the rays (origin, direction, bounds) read, each link entry of
    # the walked voxels' corners read once, the rows set written
    res = {"mask_march": dict(
        max_abs_err=0.0, ms=time_ms(lambda: kernels.mask_march(o, d, tn, tx, grid.links, out_k),
                                    20),
        plain_ms=plain_ms,
        bound=bound_ms(CHUNK * 32 + n_corner * 4 + n_set * 4, n_seg * 30))}
    full = [x.contiguous() for x in W._mask_rays(grid, rays.origins, rays.dirs, 0.0)]
    out_k.zero_()
    kernels.mask_march(*full, grid.links, out_k)
    out_p.zero_()
    t0 = time.perf_counter()
    n_seg = mask_plain(grid, rays.origins, rays.dirs, out_p)
    t_plain = time.perf_counter() - t0
    check_equal(f"K9f mask over the whole {DTU_W}x{DTU_H} view", out_k, out_p)
    ms_full = time_ms(lambda: kernels.mask_march(*full, grid.links, out_k), 3)
    log(f"K9f over the whole {DTU_W}x{DTU_H} view ({rays.origins.shape[0]} rays, one launch, "
        f"{n_seg} segments, {int(out_k.sum())} rows set): {ms_full:.4f} ms, equal to the plain "
        f"version's {(rays.origins.shape[0] + CHUNK - 1) // CHUNK} chunks ({t_plain:.2f} s) "
        f"[{card}]")
    del grid, rays, full, out_k, out_p
    torch.cuda.empty_cache()
    return res


def dtu(device, card: str, work: Path) -> tuple[dict, dict]:
    """Phase 8: the DTU masked-capture path. K9f against its plain version;
    a DTU-format scene of DTU_VIEWS views at 1600x1200 written by the port; then,
    with the counters set to 0 just before and read just after,
    app/train.main on it with dataset_type dtu (the warm start, mask
    pruning over all 30.7M training rays, each K9f launch held against the
    plain version, the surface stages at 256^3 and 512^3), app/
    extract_points (n = 5, alpha 0.1) with --mesh, extract_points_cam and
    extract_points_depth (sigma-thresh depth) on two views, and
    app/eval_dtu on each extractor's points: a PSNR above the untrained
    grid's, a finite DTU Chamfer for each, a mesh with triangles (its NaN
    vertices, JAX's too, keep it from eval_dtu: ROADMAP §3). The mask sweep
    profiled on the final grid. Returns the kernels' numbers and the run's launches."""
    import contextlib
    import math
    import re

    import numpy as np
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.app import eval_dtu, extract_points, extract_points_cam
    from alphasurf_torch.app import extract_points_depth
    from alphasurf_torch.app import train as train_app
    from alphasurf_torch.core import weight_render as W
    from alphasurf_torch.data import DTUDataset
    from alphasurf_torch.train.trainer import Trainer

    res = check_mask_kernel(device, card)
    scene = work / "dtu_scan"
    t0 = time.perf_counter()
    wt = write_dtu_scene(device, scene)
    log(f"DTU scene: {DTU_VIEWS} views at {DTU_W}x{DTU_H} of make_gt_grid({CUVOL_RESO}) in "
        f"{time.perf_counter() - t0:.2f} s (render {wt['render_s']:.2f} s, {wt['redo']} rays "
        f"whose float32 bounds lose their exit rendered in float64; PNG write "
        f"{wt['png_s']:.2f} s) [{card}]")
    t0 = time.perf_counter()
    dset = DTUDataset(str(scene), split="train")
    t_load = time.perf_counter() - t0
    n_rays, n_masked = len(dset.rays_init), int(dset.rays_init.mask.sum())
    log(f"DTU loader: {dset.n_images} views, {n_rays} rays ({n_masked} masked) in {t_load:.2f} s "
        f"(PNG decode, camera decomposition, rays)")
    if n_rays != DTU_VIEWS * DTU_W * DTU_H or not 0 < n_masked < n_rays:
        raise AssertionError(f"the DTU loader's rays are wrong: {n_rays}, {n_masked} masked")
    m = torch.as_tensor(dset.rays_init.mask)
    masked = (torch.as_tensor(dset.rays_init.origins)[m], torch.as_tensor(dset.rays_init.dirs)[m])
    del dset, m
    dset_test = DTUDataset(str(scene), split="test")
    psnr0 = eval_untrained(device, dset_test)
    del dset_test

    # the mask sweep of the init, timed, and held against the plain
    # version over the same rays on the run's own grid
    sweep_ms, plain_s = [], []
    mask_render = W.sparse_grid_mask_render

    def timed_mask_render(grid, o, d, near_clip=0.0):
        out, ms = timed_once(lambda: mask_render(grid, o, d, near_clip))
        sweep_ms.append((len(o), ms, out))
        t0 = time.perf_counter()
        ref = torch.zeros_like(out)
        mask_plain(grid, o, d, ref, near_clip)
        check_equal(f"K9f mask pruning of {len(o)} rays", out, ref)
        plain_s.append(time.perf_counter() - t0)
        return out

    cfg_path = work / "dtu.yaml"
    cfg_path.write_text(dtu_config(scene))
    train_dir = work / "dtu_train"
    # the save at the end of the 256^3 surface stage (dtu_config's
    # save_every) is kept beside the final one: the iso points and the
    # mesh are extracted from it
    ckpt_256 = work / f"ckpt_{CUVOL_RESO}.npz"
    save = Trainer.save

    def keep_stage_ckpt(self):
        save(self)
        if self.gstep == STAGE_STEPS[0] + STAGE_STEPS[1]:
            shutil.copyfile(train_dir / "ckpt.npz", ckpt_256)

    torch.cuda.reset_peak_memory_stats()
    tee = _Tee(sys.stdout)
    kernels.reset_launches()
    t0 = time.perf_counter()
    W.sparse_grid_mask_render = timed_mask_render
    Trainer.save = keep_stage_ckpt
    try:
        with contextlib.redirect_stdout(tee):
            psnr = train_app.main([str(scene), "-t", str(train_dir), "-c", str(cfg_path),
                                   "--device", str(device)])
    finally:
        W.sparse_grid_mask_render = mask_render
        Trainer.save = save
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0 - sum(plain_s)
    peak = torch.cuda.max_memory_allocated()
    n_sweep = sum(n for n, _, _ in sweep_ms)
    log(f"mask pruning: K9f over {n_sweep} training rays ({[n for n, _, _ in sweep_ms]}: masked, "
        f"then the rest) in {sum(ms for _, ms, _ in sweep_ms):.1f} ms, rays to the card and their "
        f"set-up included; equal to the plain version over the same rays ({sum(plain_s):.2f} s) "
        f"[{card}]")
    if n_sweep != n_rays:
        raise AssertionError(f"mask pruning swept {n_sweep} rays, not {n_rays}")
    obj, empty = sweep_ms[0][2], sweep_ms[1][2]
    zeroed = float(((obj == 0) | (empty > 0)).float().mean())
    log(f"mask pruning zeroed the density of {zeroed:.4f} of the {obj.numel()} rows "
        f"({int((obj == 0).sum())} reached by no masked ray, {int((empty > 0).sum())} by an "
        f"unmasked one)")
    tr = json.loads((train_dir / "transitions.json").read_text())
    for t in tr:
        check = (f" ({sum(plain_s):.3f} s of it the K9f check)"
                 if t["kind"] == "init_surface_from_density" else "")
        log(f"transition {t['kind']} at step {t['step']} -> {t['reso'][0]}^3: capacity "
            f"{t['capacity']}, {t['seconds']:.3f} s{check}, occupied voxels "
            f"{t['occupied_before']} -> {t['occupied_after']} [{card}]")
    n0, n1, _ = STAGE_STEPS
    kinds = [(t["kind"], t["reso"][0], t["step"]) for t in tr]
    if kinds != [("upsample", CUVOL_RESO, n0), ("init_surface_from_density", CUVOL_RESO, n0),
                 ("upsample", UPSAMPLE_RESO, n0 + n1)]:
        raise AssertionError(f"unexpected transitions: {kinds}")
    if tr[-1]["occupied_after"] is None or tr[-1]["occupied_after"] < tr[-1]["occupied_before"]:
        raise AssertionError(f"the {UPSAMPLE_RESO}^3 upsample lost occupied voxels: {tr[-1]}")
    mses = [float(m.group(1)) for m in re.finditer(r"^step \d+ \[\w+\] mse=(\S+)",
                                                   "".join(tee.parts), re.M)]
    log(f"DTU training through app/train.main: {STAGE_STEPS} steps at {CUVOL_RESO}^3 (cuvol), "
        f"{CUVOL_RESO}^3 and {UPSAMPLE_RESO}^3 (surface), batch 8192, in {t_train:.2f} s (data "
        f"set-up, transitions and 3 evals included, the K9f checks not); final eval PSNR "
        f"{psnr:.4f} against the untrained grid's {psnr0:.4f}; max_memory_allocated "
        f"{peak / 2**30:.3f} GiB [{card}]")
    if not (psnr > psnr0 and mses and all(math.isfinite(v) for v in mses)):
        raise AssertionError(f"the DTU run did not train: PSNR {psnr} <= {psnr0}, mse {mses}")

    ckpt = train_dir / "ckpt.npz"
    mvs = write_obs_mask(work / "dtu_eval")
    mm = MM_PER_UNIT
    outs = {}
    t0 = time.perf_counter()
    extract_points.main([str(ckpt_256), "--out", str(work / "pts_iso.npy"), "--n_sample",
                         str(ISO_N), "--intersect_th", str(INTERSECT_TH), "--mesh",
                         str(work / "mesh.obj"), "--device", str(device)])
    outs["iso"] = (work / "pts_iso.npy", time.perf_counter() - t0)
    lines = (work / "mesh.obj").read_text().splitlines()
    n_v = sum(1 for ln in lines if ln.startswith("v "))
    n_f = sum(1 for ln in lines if ln.startswith("f "))
    n_nan = sum(1 for ln in lines if ln.startswith("v ") and "nan" in ln)
    del lines
    log(f"extract_points with --mesh on the {CUVOL_RESO}^3 surface stage's checkpoint: {n_v} "
        f"mesh vertices ({n_nan} NaN: a tetrahedron whose one outside corner is an empty vertex, "
        f"as in the JAX package), {n_f} triangles; points and mesh in {outs['iso'][1]:.2f} s "
        f"[{card}]")
    if not n_f > 0:
        raise AssertionError("the mesh has no triangles")
    t0 = time.perf_counter()
    extract_points_cam.main([str(ckpt), str(scene), "--dataset_type", "dtu", "--n_images", "2",
                             "--out", str(work / "pts_cam.npy"), "--device", str(device)])
    outs["cam"] = (work / "pts_cam.npy", time.perf_counter() - t0)
    t0 = time.perf_counter()
    extract_points_depth.main([str(ckpt), "--data_dir", str(scene), "--dataset_type", "dtu",
                               "--traj_type", "train", "--num_views", "2", "--depth_type",
                               "thresh", "--depth_sigma_thresh", str(SIG_THRESH), "--out",
                               str(work / "pts_depth.npy"), "--device", str(device)])
    outs["depth"] = (work / "pts_depth.npy", time.perf_counter() - t0)
    launches = dict(kernels.LAUNCHES)
    log("launches " + json.dumps(launches))
    missing = [k for k in DTU_PATH_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels of the DTU path were not launched: {missing}")
    prot = [f"--{k}={v / mm!r}" for k, v in DTU_PROTOCOL.items()]
    for name, (pts_path, secs) in outs.items():
        t0 = time.perf_counter()
        # the vis PLYs of millions of points take half a minute to write:
        # only the depth extraction's are written
        vis = [] if name == "depth" else ["--no_pts_save"]
        r = eval_dtu.main(["--input_path", str(pts_path), "--scan", str(DTU_SCAN),
                           "--dataset_dir", str(mvs), "--out_dir", str(work / f"eval_{name}"),
                           *prot, *vis])
        n_pts = len(np.load(pts_path))
        log(f"DTU Chamfer of the {name} extraction ({n_pts} points, {secs:.2f} s to extract): "
            f"d2s {r['mean_d2s']:.6f}, s2d {r['mean_s2d']:.6f}, overall {r['overall']:.6f} "
            f"normalized units (x{mm:g} mm), eval_dtu {time.perf_counter() - t0:.2f} s [{card}]")
        if not (n_pts > 0 and math.isfinite(r["overall"])):
            raise AssertionError(f"the {name} extraction has no finite DTU Chamfer: {r}")

    # the idle share of the mask sweep, on the final checkpoint's grid
    from alphasurf_torch.utils.io import load_grid

    grid, _ = load_grid(str(ckpt), device=device)
    profile_device(lambda: mask_render(grid, *masked),
                   f"the mask sweep of {len(masked[0])} masked rays ({grid.reso[0]}^3)", card)
    del grid, masked
    torch.cuda.empty_cache()
    for name, r in res.items():
        log(f"time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound'][0]:.5f} ms ({r['bound'][1]}) [{card}]")
    return res, launches


# ---------------------------------------------------------------------------
# the compact and dense renderers, the first-K cache and the two-pass losses
# ---------------------------------------------------------------------------

CACHE_K = 64  # StepConfig.cache_size, the JAX package's default
COMPACT_K = 64  # StepConfig.max_intersect_voxels and render_image's default
# the dense frame against the packed one: the float32 dense walk and the
# exact pool list the same occupied voxels save where a walk's float32
# step lands within rounding of a voxel corner, so at most this share of
# pixels may differ by more than DENSE_ATOL
DENSE_ATOL, DENSE_PIXEL_FRACTION = 1e-4, 1e-3
# the two-pass run's cache-loss weights: small enough that the terms stay
# near a tenth of the image mse (l_conv_mode_samp sums |t - t_mode| over
# the batch's cached samples, in voxels; l_samp_dist is a per-ray mean), so
# that the PSNR check still tests the image fit, and large enough that
# K11d's cotangents reach the rows in every step
TWO_PASS = {"lambda_conv_mode_samp": "1.0e-7", "lambda_l_samp_dist": "1.0e-4"}
TRAIN_RAYS_PER_S = {}  # the train phase's packed bench, for the renderers phase


def _pool_key(pool):
    from alphasurf_torch.app.bench_k2 import sorted_pool

    return sorted_pool(pool.ray_id, pool.l, pool.close_t, pool.far_t)


def check_renderer_kernels(device, card: str) -> dict:
    """K11a-K11d against their plain versions on a 16,384-ray chunk of
    frame 0 of the 512^3 serving shell, each timed: the dense walk's pool
    and the K-slot pool bit for bit (K11b also at K = 2, which truncates),
    the cache and its median (K11c), and the gradient of the bench loss
    plus both cache losses through the compact renderer (K5 with K11d)
    against autograd of the plain renderer under GRAD_*."""
    import numpy as np
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.app import bench_k2
    from alphasurf_torch.app.bench_step import bench_options
    from alphasurf_torch.core.rays import Rays
    from alphasurf_torch.losses import render_losses as RL
    from alphasurf_torch.render import surface as S

    res = {}
    grid, _ = shell_grid(RESO, device)
    opt = bench_options()
    rays_all = frame_camera(0, 2).gen_rays_device(device)
    s = (WIDTH * HEIGHT) // 2 - CHUNK // 2
    rays = Rays(rays_all.origins[s:s + CHUNK].contiguous(), rays_all.dirs[s:s + CHUNK].contiguous())
    origins, dirs, sh_mult, tnear, tmax, ngt, ok, words, _ = S._begin(grid, rays, opt, None)
    B = origins.shape[0]
    mv = S.max_voxels_for(grid)
    t0 = torch.where(ok, tnear, torch.zeros_like(tnear))

    # K11a: the dense walk
    n = kernels.dense_walk_count(origins, dirs, t0, tmax, ok, words, grid.reso, mv)
    offsets = torch.zeros(B + 1, dtype=torch.int64, device=device)
    torch.cumsum(n, 0, out=offsets[1:])
    M = int(offsets[-1])
    pool_k = S.Pool(*kernels.dense_walk_fill(origins, dirs, t0, tmax, ok, words, grid.reso, mv,
                                             offsets, M), offsets, n)
    pool_p, steps = S._dense_walk_plain(grid.reso, origins, dirs, tnear, tmax, ok, words, mv)
    if not (all(np.array_equal(a, b) for a, b in zip(_pool_key(pool_k), _pool_key(pool_p)))
            and torch.equal(offsets, pool_p.offsets)):
        raise AssertionError("K11a's dense-walk pool differs from the plain version")
    walked = int(steps.max()) + 1 if steps.numel() else 0
    # steps walked: each plane crossed in (tnear, tmax) ends one, ~40 operations
    n_cand = B
    for ax in range(3):
        p0 = origins[:, ax] + t0 * dirs[:, ax]
        p1 = origins[:, ax] + torch.maximum(tmax, t0) * dirs[:, ax]
        lo = torch.clamp(torch.floor(torch.minimum(p0, p1)) + 1, min=1)
        hi = torch.clamp(torch.ceil(torch.maximum(p0, p1)) - 1, max=RESO - 2)
        n_cand += int(torch.clamp(hi - lo + 1, min=0)[ok].sum())
    log(f"K11a dense walk: {M} entries for {B} rays equal to the plain version (the longest "
        f"entry at step {walked} of {mv}; {n_cand} steps walked)")
    ray_bytes = B * (8 * 4 + 1) + words.numel() * 4
    plain_w = time_ms(lambda: S._dense_walk_plain(grid.reso, origins, dirs, tnear, tmax, ok,
                                                  words, mv), 1)
    res["dense_walk_count"] = dict(
        max_abs_err=0.0, plain_ms=plain_w, bound=bound_ms(ray_bytes + B * 4, n_cand * 40),
        ms=time_ms(lambda: kernels.dense_walk_count(origins, dirs, t0, tmax, ok, words, grid.reso,
                                                    mv), 20))
    res["dense_walk_fill"] = dict(
        max_abs_err=0.0, plain_ms=plain_w,
        bound=bound_ms(ray_bytes + (B + 1) * 8 + M * 24, n_cand * 40),
        ms=time_ms(lambda: kernels.dense_walk_fill(origins, dirs, t0, tmax, ok, words, grid.reso,
                                                   mv, offsets, M), 20))

    # K11b: the first K occupied crossings, at the serving K and at K = 2
    tn, tx = S._phase_a_bounds(tnear, tmax, ok)
    full = S._compact_crossings_plain(grid.reso, origins, dirs, tn, tx, words)
    for K in (2, COMPACT_K):
        pk, pp = S.compact_crossings(grid, origins, dirs, tn, tx, words, K), S._cap_pool(full, K)
        same = bench_k2.compare_pools(pk, pp)
        if not (same["in_order"] and same["offsets"] and same["n_occupied"]):
            raise AssertionError(f"K11b's K = {K} pool differs from the plain version: {same}")
        log(f"K11b compact pool, K = {K}: {pk.close_t.shape[0]} entries equal to the plain "
            f"version in pool order; {int((pk.n_occupied > K).sum())} rays over K (max n_occupied "
            f"{int(pk.n_occupied.max())})")
    cap_off = torch.zeros(B + 1, dtype=torch.int64, device=device)
    torch.cumsum(torch.clamp(pk.n_occupied, max=COMPACT_K), 0, out=cap_off[1:])
    Mc = int(cap_off[-1])
    res["compact_fill"] = dict(
        max_abs_err=0.0, plain_ms=time_ms(lambda: S._cap_pool(S._compact_crossings_plain(
            grid.reso, origins, dirs, tn, tx, words), COMPACT_K), 3),
        bound=bound_ms(ray_bytes + (B + 1) * 8 + Mc * 24, n_cand * 30),
        ms=time_ms(lambda: kernels.compact_fill(origins, dirs, tn, tx, words, grid.reso, cap_off,
                                                Mc), 20))

    # K11c: the cache, on the dense walk's samples with the walk's rules
    packed = S.pack_grid_data(grid)
    sp = S._voxel_samples_plain(grid, opt, pool_p, origins, dirs, sh_mult, ngt, packed)
    smp = {k: sp[k].contiguous() for k in ("t", "alpha", "contrib", "fake", "counted", "rgb",
                                           "snorm", "loss_e")}
    mode = S._Mode(1, True, CACHE_K)
    trunc_a = grid.truncated_vol_render_a

    def k11c():
        return kernels.composite(pool_p.offsets, smp, trunc_a, opt, None, False, *mode)

    ck = k11c()
    cp = S._composite_plain(opt, trunc_a, pool_p.offsets, sp, None, *mode)
    for k in ("n_intersections",):
        if not torch.equal(ck[k], cp[k]):
            raise AssertionError(f"K11c {k} differs from the plain version")
    if not (torch.equal(ck["cache"]["n_cached"], cp["cache"]["n_cached"])
            and torch.equal(ck["cache"]["fake_mask"], cp["cache"]["fake_mask"])):
        raise AssertionError("K11c's cache counts or fake flags differ from the plain version")
    errs = [allclose_err(ck[k], cp[k]) for k in ("rgb", "normal", "log_T")]
    errs += [allclose_err(ck["cache"][k], cp["cache"][k], atol=1e-4)
             for k in ("ts", "alphas", "weights")]
    sel = [allclose_err(ck[k], cp[k], atol=1e-3) for k in ("depth_mode", "cache_med")]
    if max(e[1] for e in errs) > 0 or max(e[1] for e in sel) > SELECT_FRACTION:
        raise AssertionError(f"K11c differs from the plain version: {errs} {sel}")
    n_cached = int(ck["cache"]["n_cached"].sum())
    log(f"K11c cache: {n_cached} cached samples of {B} rays (max {int(ck['cache']['n_cached'].max())}"
        f" a ray), max abs err {max(e[0] for e in errs):.3e}; mode/median rays off "
        f"{[round(e[1] * B) for e in sel]}")
    S0 = sp["n_slots"]
    nb4 = S0 * M * 42 + 3 * M * 4 + (B + 1) * 8 + B * 92
    res["composite_cache"] = dict(
        max_abs_err=max(e[0] for e in errs), ms=time_ms(k11c, 50),
        plain_ms=time_ms(lambda: S._composite_plain(opt, trunc_a, pool_p.offsets, sp, None,
                                                    *mode), 3),
        bound=bound_ms(nb4 + B * CACHE_K * 13 + B * 8, S0 * M * 50))

    # K11d: the gradient through the cache, via the compact renderer
    def loss_of(out):
        c = out["cache"]
        return (torch.mean((out["rgb"] - 0.5) ** 2) + 1e-4 * out["ray_losses"]["l_entropy"].mean()
                + 1e-3 * RL.l_conv_mode_samp_from_cache(c) / B + 1e-2 * RL.l_samp_dist_from_cache(c)
                + 1e-2 * torch.mean(c["weights"] * c["alphas"]))

    names = ("density", "surface", "sh", "fake_sample_std")
    params = [grid.density_data, grid.surface_data, grid.sh_data, grid.fake_sample_std]
    for p in params:
        p.requires_grad_(True)
    try:
        out = S.volume_render_surface_compact(grid, rays, opt, cache_size=CACHE_K,
                                              occupancy=words, packed=packed)
        g_kernel = torch.autograd.grad(loss_of(out), params)
        pool_c = S._cap_pool(full, COMPACT_K)
        comp = S._render_plain(grid, opt, pool_c, origins, dirs, sh_mult, ngt,
                               S.pack_grid_data(grid), S._Mode(8, True, CACHE_K))
        loss_p = loss_of({"rgb": comp["rgb"], "cache": comp["cache"],
                          "ray_losses": dict(zip(S._RAY_LOSS_KEYS, comp["ray_losses"]))})
        g_plain = torch.autograd.grad(loss_p, params, retain_graph=True)
        plain_ms = time_ms(lambda: torch.autograd.grad(loss_p, params, retain_graph=True), 3)
        del comp, loss_p
    finally:
        for p in params:
            p.requires_grad_(False)
    log(f"K11d: gradients of the bench loss and both cache losses over {B} rays through the "
        f"compact renderer, kernels against autograd of the plain path:")
    err = max(grad_check(n, a, b, "K11d") for n, a, b in zip(names, g_kernel, g_plain))
    del g_kernel, g_plain
    rng = np.random.default_rng(SEED)
    g_c = tuple(torch.as_tensor(rng.standard_normal((B, CACHE_K)) * 1e-3, dtype=torch.float32,
                                device=device) for _ in range(3))
    g_rgb = torch.zeros((B, 3), dtype=torch.float32, device=device)
    g_rl = torch.zeros((12, B), dtype=torch.float32, device=device)
    bytes_a = S0 * M * 46 + (B + 1) * 8 + B * 60 + B * CACHE_K * 12
    res["backward_cache"] = dict(
        max_abs_err=err, plain_ms=plain_ms, bound=bound_ms(bytes_a, S0 * M * 100),
        ms=time_ms(lambda: kernels.backward_ray(pool_p.offsets, smp, trunc_a, opt, g_rgb, g_rl,
                                                g_c), 20))

    # return_samples' two kernel outputs: K11a's walk steps (equal to the
    # plain walk's) and K4's truncated alphas of the live slots
    steps_k = kernels.dense_walk_fill(origins, dirs, t0, tmax, ok, words, grid.reso, mv, offsets,
                                      M, want_steps=True)[4]
    if not torch.equal(steps_k.long(), steps):
        raise AssertionError("K11a's walk steps differ from the plain walk's")
    res["dense_walk_fill_steps"] = dict(
        max_abs_err=0.0, plain_ms=plain_w,
        bound=bound_ms(ray_bytes + (B + 1) * 8 + M * 28, n_cand * 40),
        ms=time_ms(lambda: kernels.dense_walk_fill(origins, dirs, t0, tmax, ok, words, grid.reso,
                                                   mv, offsets, M, want_steps=True), 20))

    def k4s():
        return kernels.composite(pool_p.offsets, smp, trunc_a, opt, None, False, *mode,
                                 want_live_alpha=True)

    cs = k4s()
    la = allclose_err(cs["live_alpha"][cs["live"]], cp["live_alpha"][cs["live"]])
    flips = int((cs["live"] != cp["live"]).sum())
    if la[1] > 0 or flips > FLAG_FRACTION * cs["live"].numel():
        raise AssertionError(f"K4's samples differ from the plain version: {la}, {flips} flips")
    log(f"K11a's walk steps equal to the plain walk's; K4's samples: {int(cs['live'].sum())} live "
        f"slots, truncated alphas max abs err {la[0]:.3e}, {flips} flags flip")
    res["composite_samples"] = dict(
        max_abs_err=la[0], ms=time_ms(k4s, 50), plain_ms=res["composite_cache"]["plain_ms"],
        bound=bound_ms(nb4 + B * CACHE_K * 13 + B * 8 + S0 * M * 5, S0 * M * 50))

    # every output cotangent through the walks (K5a's second instantiation
    # under their rules: the first-max mode, the cache's median), with
    # their samples
    for renderer in ("dense", "compact"):
        chk = check_output_grads(f"K5 outputs, {renderer}", grid, opt, rays, renderer, words,
                                 packed)
        for k in ("backward_ray_out", "backward_entry_out"):
            log(f"  {k} under the {renderer} renderer's rules: max abs err {chk['err']:.3e}, "
                f"plain backward {chk['plain_ms']:.3f} ms")
        del chk
    del grid, packed, sp, smp, pool_p, pool_k, full
    torch.cuda.empty_cache()
    return res


def out_grad_path(device, card: str) -> dict:
    """With the counters set to 0 just before and read just after: a
    chunk's gradient through each surface renderer (packed with the
    intersections and the sigma-thresh depth; dense and compact with their
    cache and samples) with the cotangents of every output
    (every_output_loss), on the 512^3 shell at bench_step's options. Each
    gradient must be finite and non-zero. Returns the launches."""
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.app.bench_step import bench_options
    from alphasurf_torch.core.rays import Rays
    from alphasurf_torch.render import surface as S

    grid, _ = shell_grid(RESO, device)
    opt = bench_options()
    rays_all = frame_camera(1, 2).gen_rays_device(device)
    s = (WIDTH * HEIGHT) // 2 - CHUNK // 2
    rays = Rays(rays_all.origins[s:s + CHUNK].contiguous(), rays_all.dirs[s:s + CHUNK].contiguous())
    params = [grid.density_data, grid.surface_data, grid.sh_data, grid.fake_sample_std]
    calls = {
        "packed": lambda: S.volume_render_surface_packed(
            grid, rays, opt, return_intersections=True, depth_sigma_thresh=SIG_THRESH),
        "dense": lambda: S.volume_render_surface(grid, rays, opt, cache_size=CACHE_K,
                                                 return_samples=True),
        "compact": lambda: S.volume_render_surface_compact(
            grid, rays, opt, cache_size=CACHE_K, return_samples=True,
            max_intersect_voxels=COMPACT_K),
    }
    for p in params:
        p.requires_grad_(True)
    kernels.reset_launches()
    try:
        for name, call in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call()
            live = out["intersections"]["mask"] if "intersections" in out else None
            valid = out["samples"]["valid"] if "samples" in out else None
            g = torch.autograd.grad(every_output_loss(out, out_weights(out), {}, live, valid),
                                    params)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if not all(bool(torch.isfinite(x).all()) and bool((x != 0).any()) for x in g):
                raise AssertionError(f"{name}: a gradient with every output cotangent is not "
                                     "finite and non-zero")
            log(f"{name}: a {CHUNK}-ray chunk's render and gradient with every output cotangent "
                f"in {ms:.3f} ms [{card}]")
    finally:
        for p in params:
            p.requires_grad_(False)
    torch.cuda.synchronize()
    got = {k: kernels.LAUNCHES[k] for k in OUT_PATH_KERNELS}
    log("launches of a chunk's gradient through each surface renderer with every output "
        "cotangent " + json.dumps(got))
    if 0 in got.values():
        raise AssertionError(f"the output cotangents missed a kernel: {got}")
    del grid, params, g, out
    torch.cuda.empty_cache()
    return got


def two_pass_config() -> str:
    """The two-pass run: stages_config cut to its 256^3 warm start and
    256^3 surface stage (STAGE_STEPS[:2] steps of 8192), the surface stage
    on the compact renderer with the two-pass losses (TWO_PASS; the Trainer
    turns use_two_pass_losses on with the cache of 64), the ground truth
    rendered by the dense walk (SyntheticDataset's default, K11a).
    truncated_vol_render_a decays to 2, not the recipe's 1: at 1 every
    intersection after a ray's first is weighted 1e-10, below the conv-mode
    loss's alpha floor of 1e-8, and that loss is 0 on every ray."""
    n0, n1 = STAGE_STEPS[:2]
    keys = dict(line.split(" = ", 1) for line in stages_config().splitlines())
    keys.update({"reso": f"[[{CUVOL_RESO}, {CUVOL_RESO}, {CUVOL_RESO}], [{CUVOL_RESO}, "
                         f"{CUVOL_RESO}, {CUVOL_RESO}]]",
                 "n_iters": n0 + n1, "dataset_renderer": "dense", "surface_renderer": "compact",
                 "truncated_vol_render_a_final": "2.0", **TWO_PASS})
    return "".join(f"{k} = {v}\n" for k, v in keys.items())


def renderers(device, card: str, work: Path) -> tuple[dict, dict]:
    """Phase 9: K11a-K11d against their plain versions; then, each with
    the counters set to 0 just before and read just after: two 800x800
    orbit frames of the 512^3 shell through render_image with the packed,
    compact and dense renderers (the compact frames equal to the packed
    ones wherever a ray has at most K occupied crossings, the dense ones
    within DENSE_ATOL on all but DENSE_PIXEL_FRACTION of the pixels);
    app/bench_step --renderer compact and dense at bench.py's protocol,
    each with a profiled step; and app/train.main at two_pass_config with
    the cache losses finite and non-zero on every surface step, a final
    PSNR above the untrained grid's and a finite Chamfer. Returns the
    kernels' numbers and the launches summed over those runs."""
    import contextlib
    import math
    import re

    import numpy as np
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.app import bench_step
    from alphasurf_torch.app import train as train_app
    from alphasurf_torch.app.render_circle import circle_render_options
    from alphasurf_torch.core.rays import Rays
    from alphasurf_torch.data import SyntheticDataset
    from alphasurf_torch.render import surface as S
    from alphasurf_torch.render.image import render_image
    from alphasurf_torch.train import steps as steps_mod

    res = check_renderer_kernels(device, card)
    launches = dict.fromkeys(RENDERER_KERNELS, 0)
    launches.update(out_grad_path(device, card))

    def count(label):
        got = {k: kernels.LAUNCHES[k] for k in RENDERER_KERNELS}
        for k, v in got.items():
            launches[k] += v
        log(f"launches of {label}: " + json.dumps(got))
        return got

    # serving: two orbit frames through each renderer
    grid, _ = shell_grid(RESO, device)
    opt = circle_render_options()
    words = S.occupancy_words(grid, opt)
    frames, times = {}, {}
    for renderer in ("packed", "compact", "dense"):
        kernels.reset_launches()
        imgs, secs, over = [], [], 0
        for i in range(2):
            stats = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            imgs.append(render_image(grid, frame_camera(i, 2), opt, renderer=renderer,
                                     max_intersect_voxels=COMPACT_K, device=device, stats=stats))
            secs.append(time.perf_counter() - t0)
            over += int(stats["overflow"])
        got = count(f"two {renderer} frames")
        if renderer == "compact" and got["compact_fill"] == 0:
            raise AssertionError("the compact frames did not launch K11b")
        if renderer == "dense" and 0 in (got["dense_walk_count"], got["dense_walk_fill"]):
            raise AssertionError("the dense frames did not launch K11a")
        for img in imgs:
            if img.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(img).all() or img.std() < 0.05:
                raise AssertionError(f"a {renderer} frame is not a finite, non-flat image")
        frames[renderer], times[renderer] = imgs, secs
        log(f"serving, {renderer}: two {WIDTH}x{HEIGHT} frames in ms "
            f"{[round(x * 1e3, 3) for x in secs]}, {2 * WIDTH * HEIGHT / sum(secs):.1f} rays/s"
            + (f", {over} occupied crossings over K = {COMPACT_K}" if renderer == "compact" else "")
            + f" [{card}]")
    for i in range(2):
        rays = frame_camera(i, 2).gen_rays_device(device)
        o, d, _, tnear, tmax, _, ok, _, _ = S._begin(grid, rays, opt, words)
        tn, tx = S._phase_a_bounds(tnear, tmax, ok)
        n_occ = torch.cat([kernels.phase_a_count(o[c:c + CHUNK].contiguous(),
                                                 d[c:c + CHUNK].contiguous(),
                                                 tn[c:c + CHUNK].contiguous(),
                                                 tx[c:c + CHUNK].contiguous(), words,
                                                 grid.reso)[1]
                           for c in range(0, o.shape[0], CHUNK)]).cpu().numpy()
        within = (n_occ <= COMPACT_K).reshape(HEIGHT, WIDTH)
        pk, cp, dn = frames["packed"][i], frames["compact"][i], frames["dense"][i]
        err_c = float(np.abs(cp - pk)[within].max())
        if err_c > 1e-6:
            raise AssertionError(f"compact frame {i} differs from the packed one by {err_c} where "
                                 f"n_occupied <= {COMPACT_K}")
        diff = np.abs(dn - pk).max(-1)
        n_bad = int((diff > DENSE_ATOL).sum())
        log(f"frame {i}: compact equals packed to {err_c:.2e} on the {int(within.sum())} rays "
            f"with n_occupied <= {COMPACT_K} (of {within.size}); dense against packed: "
            f"{int((diff > 1e-6).sum())} pixels differ by > 1e-6, {n_bad} by > {DENSE_ATOL}, "
            f"max {float(diff.max()):.3e}")
        if n_bad > DENSE_PIXEL_FRACTION * diff.size:
            raise AssertionError(f"dense frame {i}: {n_bad} pixels differ from the packed frame")
    del grid, words, frames
    torch.cuda.empty_cache()

    # training at bench.py's protocol through the compact and dense steps
    for renderer in ("compact", "dense"):
        kernels.reset_launches()
        out = bench_step.main(["--reso", str(RESO), "--batch", str(TRAIN_BATCH), "--steps", "33",
                               "--width", str(WIDTH), "--renderer", renderer, "--device",
                               str(device)])
        torch.cuda.synchronize()
        got = count(f"bench_step --renderer {renderer}")
        if not (out["losses_finite"] and out["rows_moved"] > 0):
            raise AssertionError(f"the {renderer} bench did not run right: {out}")
        packed_rps = TRAIN_RAYS_PER_S.get("packed")
        log(f"train, {renderer}: {out['rays_per_s_fwd_bwd']:.1f} rays/s, "
            f"{out['seconds'] / out['steps'] * 1e3:.3f} ms per step at {RESO}^3, batch "
            f"{TRAIN_BATCH} (packed, train phase: "
            f"{'not run' if packed_rps is None else f'{packed_rps:.1f} rays/s'}), loss "
            f"{out['first_loss']:.6f} -> {out['last_loss']:.6f} [{card}]")
        if renderer == "dense" and got["dense_walk_fill"] == 0:
            raise AssertionError("the dense steps did not launch K11a")
        if renderer == "compact" and got["compact_fill"] == 0:
            raise AssertionError("the compact steps did not launch K11b")
        g, rc = bench_step.build_bench_grid(RESO, device)
        bopt = bench_step.bench_options()
        rays = bench_step.bench_rays(WIDTH, device)
        s = int(WIDTH * HEIGHT * 0.35)
        r = Rays(rays.origins[s:s + TRAIN_BATCH], rays.dirs[s:s + TRAIN_BATCH])
        step = steps_mod.make_surface_step(steps_mod.StepConfig(opt=bopt, cache_size=None,
                                                                renderer=renderer))
        rms, hp, gen = steps_mod.init_rms(g), bench_step.bench_hparams(), torch.Generator()
        gt = torch.full((TRAIN_BATCH, 3), 0.5, device=device)
        occ = S.occupancy_words(g, bopt)
        profile_device(lambda: step(g, rms, r, gt, hp, gen, occ=occ, row_coords=rc),
                       f"one {renderer} train step ({TRAIN_BATCH} rays, {RESO}^3)", card)
        del g, rc, rms, occ
        torch.cuda.empty_cache()

    # the Trainer with the two-pass losses on the compact renderer
    terms = []
    wrapped = {}
    for name in ("l_conv_mode_samp_from_cache", "l_samp_dist_from_cache"):
        fn = getattr(steps_mod.rl, name)
        wrapped[name] = fn

        def record(cache, fn=fn, name=name):
            v = fn(cache)
            terms.append((name, v.detach()))
            return v

        setattr(steps_mod.rl, name, record)
    shape = recipe_shape(work / "two_pass_data")
    cfg_path = work / "two_pass.yaml"
    cfg_path.write_text(two_pass_config())
    tee = _Tee(sys.stdout)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            psnr = train_app.main([str(shape.parent), "-t", str(work / "two_pass"), "-c",
                                   str(cfg_path), "--device", str(device)])
    finally:
        for name, fn in wrapped.items():
            setattr(steps_mod.rl, name, fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = count("the two-pass Trainer run")
    warm_k10 = {k: kernels.LAUNCHES[k] for k in ("cuvol_march", "cuvol_march_backward")}
    log("launches of its warm start (the dense cuvol march, as the compact renderer's in JAX) "
        + json.dumps(warm_k10))
    if 0 in (got["dense_walk_fill"], got["compact_fill"], got["composite_cache"],
             got["backward_cache"], *warm_k10.values()):
        raise AssertionError(f"the two-pass run missed a kernel of its path: {got}, {warm_k10}")
    n0, n1 = STAGE_STEPS[:2]
    vals = {name: torch.stack([v for k, v in terms if k == name]).float().cpu()
            for name in wrapped}
    for name, v in vals.items():
        if v.numel() != n1 or not bool(torch.isfinite(v).all()) or bool((v == 0).any()):
            raise AssertionError(f"{name}: {v.numel()} surface steps, not all finite and non-zero: "
                                 f"{v.tolist()[:8]}")
    dset_test = SyntheticDataset(split="test", n_images=2, width=WIDTH, height=HEIGHT,
                                 reso=SMALL_RESO, device=device)
    psnr0 = eval_untrained(device, dset_test)
    cfs = [float(m.group(1)) for m in re.finditer(r"^eval stats: step=\d+ .* cf_mean=(\S+)",
                                                  "".join(tee.parts), re.M)]
    log(f"two-pass run through app/train.main: {n0} + {n1} steps of 8192 at {CUVOL_RESO}^3 "
        f"(the surface stage compact, K {COMPACT_K}, cache {CACHE_K}, "
        f"{', '.join(f'{k} {v}' for k, v in TWO_PASS.items())}), ground truth by the dense walk, "
        f"in {wall:.2f} s; cache terms per surface step: conv_mode "
        f"{float(vals['l_conv_mode_samp_from_cache'].min()):.4e}.."
        f"{float(vals['l_conv_mode_samp_from_cache'].max()):.4e}, samp_dist "
        f"{float(vals['l_samp_dist_from_cache'].min()):.4e}.."
        f"{float(vals['l_samp_dist_from_cache'].max()):.4e}; final eval PSNR {psnr:.4f} against "
        f"the untrained grid's {psnr0:.4f}; cf_mean at the evals {cfs} [{card}]")
    if not psnr > psnr0:
        raise AssertionError(f"the two-pass run did not train: PSNR {psnr} <= {psnr0}")
    if not cfs or not all(math.isfinite(c) for c in cfs):
        raise AssertionError(f"the two-pass run has no finite Chamfer: {cfs}")
    for name, r in res.items():
        log(f"time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound'][0]:.5f} ms ({r['bound'][1]}) [{card}]")
    return res, launches


# ---------------------------------------------------------------------------
# the Blender (NeRF-synthetic) path and the extended surface regularizers
# ---------------------------------------------------------------------------

# the bench protocol's weights of the four terms (a speed measurement)
EXT_HP = {"lambda_norm_match": 1e-4, "lambda_viscosity": 1e-4, "lambda_sign_change": 1e-4,
          "lambda_eikonal": 1e-4}
VISCOSITY_ETA = 1e-2  # StepConfig.viscosity_eta's default
CAMERA_ANGLE_X = 0.6911112  # nerf_synthetic's
BLENDER_TRAIN, BLENDER_TEST = 40, 8  # nerf_synthetic: 100 train, 200 test (cut for time)
SCENE_SCALE = 2.0 / 3.0  # the NeRF loader's default
# the eikonal weight of the pipeline's surface stage: near a tenth of the
# stage's test mse, as two_pass_config chose its weights (at 3e-3 the
# weighted term was 0.053 of it on the H100)
BLENDER_EIKONAL = 6e-3
BLENDER_SURFACE = {**PIPELINE_SURFACE, "lambda_surface_eikonal": BLENDER_EIKONAL}
# the pipeline on a NeRF scene: PIPELINE_KERNELS but K11a (the scene is
# rendered before the run), plus K12d
BLENDER_KERNELS = tuple(k for k in PIPELINE_KERNELS
                        if k not in ("dense_walk_count", "dense_walk_fill")) + ("reg_eikonal",)


def ext_bytes(grid, cells, offsets, fields: int) -> float:
    """Bytes one K12 launch needs: those of window_stats, each row the links
    name in ``fields`` fields and the gradient outputs (capacity rows in
    each field)."""
    cb, nr = window_stats(grid, cells, offsets)
    return cb + (nr + grid.capacity) * 4 * fields


def check_ext_reg(grid, row_coords, device) -> dict:
    """K12a-K12d against their plain versions (autograd) on the 512^3
    shell: on a window of 0.01 of the rows (bench_step's sparsity) and on
    every present row (the recipe's norm_surface_sparsity 1.0). The loss
    to REG_LOSS_RTOL, each gradient to GRAD_*; timed on the window."""
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.losses import reg as R

    L = grid.links
    h = (2.0 * torch.mean(grid.radius) / torch.mean(grid.gsz)).reshape(1)
    fwd = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1))
    six = fwd + ((-1, 0, 0), (0, -1, 0), (0, 0, -1))
    corners = tuple((a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1))
    out = {}
    gen = torch.Generator().manual_seed(SEED)
    for label, frac in (("window of 0.01 of the rows", 0.01), ("every present row", 1.0)):
        cells = R.sample_present_cells(gen, grid, row_coords, frac)
        n = cells.numel()
        log(f"K12 on the {RESO}^3 shell, {label} ({n} cells):")
        runs = {
            "reg_norm_match": (
                lambda: kernels.reg_norm_match(L, cells, grid.density_data.detach(),
                                               grid.surface_data.detach(), 1.0 / n),
                lambda: R._norm_match_plain(grid, cells, 1.0 / n),
                ("density_data", "surface_data"), fwd, 2, 90),
            "reg_viscosity": (
                lambda: kernels.reg_viscosity(L, cells, grid.surface_data.detach(), h,
                                              VISCOSITY_ETA, 1.0 / n),
                lambda: R._viscosity_plain(grid, cells, VISCOSITY_ETA, h[0], 1.0 / n),
                ("surface_data",), six, 1, 60),
            "reg_sign_change": (
                lambda: kernels.reg_sign_change(L, cells, grid.surface_data.detach(), 1.0 / n),
                lambda: R._sign_change_plain(grid, cells, 1.0 / n), ("surface_data",), fwd, 1,
                25),
            "reg_eikonal": (
                lambda: kernels.reg_eikonal(L, cells, grid.surface_data.detach(), 1.0, 1.0 / n),
                lambda: R._eikonal_plain(grid, cells, 1.0, 1.0 / n), ("surface_data",),
                corners, 1, 60),
        }
        for name, (run_k, run_p, fields, offs, n_fields, ops) in runs.items():
            loss_k, *g_k = run_k()
            params = [getattr(grid, f) for f in fields]
            for p in params:
                p.requires_grad_(True)
            try:
                loss_p = run_p()
                g_p = torch.autograd.grad(loss_p, params)

                def plain():
                    torch.autograd.grad(run_p(), params)

                plain_ms = time_ms(plain, 3) if frac < 1.0 else None
            finally:
                for p in params:
                    p.requires_grad_(False)
            lk, lp = float(loss_k), float(loss_p.detach())
            log(f"  {name}: loss {lk:.7e} (plain {lp:.7e})")
            if not abs(lk - lp) <= REG_LOSS_RTOL * abs(lp):
                raise AssertionError(f"{name} loss differs from its plain version: {lk} {lp}")
            err = abs(lk - lp)
            for f, gk, gp in zip(fields, g_k, g_p):
                err = max(err, grad_check(f"{name} {f}", gk, gp, kernel=name))
            if frac < 1.0:
                out[name] = dict(max_abs_err=err, ms=time_ms(run_k, 20), plain_ms=plain_ms,
                                 bound=bound_ms(ext_bytes(grid, cells, offs, n_fields), n * ops))
            else:
                out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
                log(f"  {name} over every present row: kernel {time_ms(run_k, 5):.4f} ms")
        del cells
        torch.cuda.empty_cache()
    return out


def ext_step_bench(device, card: str) -> dict:
    """bench_step's protocol (512^3 shell, batch 40960 of one 800x800
    camera, 1 + 33 steps) through make_surface_step with the four extended
    flags on, which bench_step has no switch for; the counters set to 0
    just before and read just after. Then one profiled step and the four
    kernels' share of its device time."""
    import math

    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.app import bench_step
    from alphasurf_torch.core.rays import Rays
    from alphasurf_torch.render.surface import occupancy_words
    from alphasurf_torch.train.steps import EXT_FLAGS, StepConfig, init_rms, make_surface_step

    grid, rc = bench_step.build_bench_grid(RESO, device)
    opt = bench_step.bench_options()
    hp = bench_step.bench_hparams()._replace(**EXT_HP)
    step = make_surface_step(StepConfig(opt=opt, cache_size=None, **dict.fromkeys(EXT_FLAGS, True)))
    rays = bench_step.bench_rays(WIDTH, device)
    rms, gen = init_rms(grid), torch.Generator().manual_seed(SEED)
    gt = torch.full((TRAIN_BATCH, 3), 0.5, device=device)
    n = rays.origins.shape[0]
    lo, span = int(n * 0.35), max(int(n * 0.30) - TRAIN_BATCH, 1)
    occ = occupancy_words(grid, opt)

    def batch(i):
        s = lo + (i * TRAIN_BATCH) % span
        return Rays(rays.origins[s:s + TRAIN_BATCH], rays.dirs[s:s + TRAIN_BATCH])

    kernels.reset_launches()
    losses = [step(grid, rms, batch(0), gt, hp, gen, occ=occ, row_coords=rc)[2]["loss"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(33):
        if i > 0 and i % 16 == 0:
            occ = occupancy_words(grid, opt)
        losses.append(step(grid, rms, batch(i), gt, hp, gen, occ=occ, row_coords=rc)[2]["loss"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in TRAIN_KERNELS + EXTENDED_KERNELS}
    losses = torch.stack(losses).tolist()
    log(f"train with the four extended regularizers: 33 steps of {TRAIN_BATCH} rays at {RESO}^3: "
        f"{33 * TRAIN_BATCH / secs:.1f} rays/s, {secs / 33 * 1e3:.3f} ms per step, loss "
        f"{losses[0]:.6f} -> {losses[-1]:.6f} [{card}]")
    log("launches " + json.dumps(launches))
    if any(v == 0 for v in launches.values()) or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"the extended step did not run right: {launches}, {losses[:4]}")
    r = batch(3)
    _, busy, rows = profile_device(lambda: step(grid, rms, r, gt, hp, gen, occ=occ, row_coords=rc),
                                   f"one train step with the four extended regularizers "
                                   f"({TRAIN_BATCH} rays, {RESO}^3)", card)
    ext_ms = sum(ms for ms, _, key in rows
                 if any(f"{k}_kernel" in key for k in EXTENDED_KERNELS))
    log(f"K12a-K12d: {ext_ms:.4f} ms of the step's {busy:.3f} ms device time "
        f"({ext_ms / busy:.4f}) [{card}]")
    del grid, rc, rms, occ
    torch.cuda.empty_cache()
    return launches


def blender_poses(n: int, split: str, seed: int = SEED):
    """OpenGL camera-to-world poses (Blender's) looking at the origin from
    radius 2.7 / SCENE_SCALE, where the NeRF loader's scale puts them at the
    synthetic dataset's 2.7: train views drawn uniformly over the upper
    hemisphere's band up to 72 degrees, test views a circle at 30 degrees
    (nerf_synthetic's test path)."""
    import numpy as np

    from alphasurf_torch.data.synthetic import pose_spherical

    rng = np.random.default_rng(seed + (0 if split == "train" else 1))
    gl = np.diag([1.0, -1.0, -1.0, 1.0])
    out = []
    for i in range(n):
        if split == "train":
            az, el = rng.uniform(0, 360), np.degrees(np.arcsin(rng.uniform(0.05, 0.95)))
        else:
            az, el = 360.0 * i / n, 30.0
        out.append(pose_spherical(az, el, 2.7 / SCENE_SCALE).astype(np.float64) @ gl)
    return out


def write_blender_scene(device, root: Path) -> dict:
    """A NeRF-synthetic scene of make_gt_grid(CUVOL_RESO): BLENDER_TRAIN
    train and BLENDER_TEST test views (cut from nerf_synthetic's 200 for
    the time limit) at 800x800 as 8-bit RGBA PNGs, rendered by the dense
    walk (K11a) on host-made rays, as the synthetic dataset renders its
    ground truth; the alpha is 1 - T (the render with a black background
    against a white one), so the loader's white compositing gives back the
    render. As in write_dtu_scene, the rays whose float32 bounds lose
    their exit (ROADMAP §3) go through the plain path on a float64 copy of
    the grid. Cameras: camera_angle_x CAMERA_ANGLE_X, blender_poses. Also
    the GT points shape.npy: synthetic_gt_points(CUVOL_RESO)."""
    import dataclasses

    import numpy as np
    import torch

    from alphasurf_torch.app.pipeline import synthetic_gt_points
    from alphasurf_torch.core.options import RenderOptions
    from alphasurf_torch.core.rays import Camera, Rays
    from alphasurf_torch.data.synthetic import make_gt_grid
    from alphasurf_torch.render import surface as S
    from alphasurf_torch.render.image import render_rays
    from alphasurf_torch.utils.png import write_png

    t0 = time.perf_counter()
    grid = make_gt_grid(CUVOL_RESO, device=device)
    grid64 = make_gt_grid(CUVOL_RESO, dtype=torch.float64, device=device)

    white = RenderOptions(sigma_thresh=-1e9, stop_thresh=-1.0, only_outward_intersect=True)
    black = dataclasses.replace(white, background_brightness=0.0)
    with torch.no_grad():
        words64 = S._occupancy_words_plain(grid64, black)
        packed64 = S.pack_grid_data(grid64)
    focal = float(0.5 * WIDTH / np.tan(0.5 * CAMERA_ANGLE_X))
    t_render, redo_n = 0.0, {}
    for split, n in (("train", BLENDER_TRAIN), ("test", BLENDER_TEST)):
        (root / split).mkdir(parents=True, exist_ok=True)
        frames = []
        for i, pose in enumerate(blender_poses(n, split)):
            # the loader's float32 camera: the flip back to OpenCV, then the scale
            c2w = np.asarray(pose, dtype=np.float32) @ np.diag(
                np.array([1, -1, -1, 1], dtype=np.float32))
            c2w[:3, 3] *= SCENE_SCALE
            rays = Camera.make(c2w, fx=focal, width=WIDTH, height=HEIGHT).gen_rays(device)
            t1 = time.perf_counter()
            with torch.no_grad():
                on_white = render_rays(grid, rays, white, renderer="dense")[0]
                on_black = render_rays(grid, rays, black, renderer="dense")[0]
                alpha = (1.0 - (on_white - on_black)[:, :1]).clamp(0.0, 1.0)
                redo = torch.nonzero(_exit_lost(grid, grid64, rays))[:, 0]
                redo_n[split] = redo_n.get(split, 0) + redo.numel()
                for s0 in range(0, redo.numel(), CHUNK):
                    idx = redo[s0:s0 + CHUNK]
                    r64 = Rays(rays.origins[idx].double(), rays.dirs[idx].double())
                    origins, dirs, sh_mult, tn, tx, ngt = chunk_inputs(grid64, black, r64)
                    pool = S._compact_crossings_plain(grid64.reso, origins, dirs, tn, tx, words64)
                    smp = S._voxel_samples_plain(grid64, black, pool, origins, dirs, sh_mult, ngt,
                                                 packed64)
                    comp = S._composite_plain(black, grid64.truncated_vol_render_a, pool.offsets,
                                              smp)
                    on_black[idx] = comp["rgb"].float()
                    alpha[idx] = (1.0 - torch.exp(comp["log_T"]))[:, None].float().clamp(0, 1)
            torch.cuda.synchronize()
            t_render += time.perf_counter() - t1
            rgb = torch.where(alpha > 0, on_black / alpha.clamp(min=1e-12),
                              torch.ones_like(on_black))
            rgba = torch.cat([rgb.clamp(0.0, 1.0), alpha], -1).reshape(HEIGHT, WIDTH, 4)
            write_png(root / split / f"r_{i}.png",
                      np.round(rgba.cpu().numpy() * 255.0).astype(np.uint8), level=1)
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": pose.tolist()})
        (root / f"transforms_{split}.json").write_text(
            json.dumps({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}, indent=1))
    gt_points = root / "shape.npy"
    np.save(gt_points, synthetic_gt_points(CUVOL_RESO))
    del grid, grid64, words64, packed64
    torch.cuda.empty_cache()
    return {"seconds": time.perf_counter() - t0, "render_seconds": t_render,
            "gt_points": gt_points, "redo": redo_n}


def hold_eikonal(grid, cells, target, v) -> float:
    """One K12d launch of a run (``v``, its loss, on the run's grid and
    window) against _eikonal_plain: the loss to REG_LOSS_RTOL and the
    gradient, read back through the launch's own autograd node (no second
    launch), to GRAD_*. Returns the max abs error."""
    import torch

    from alphasurf_torch.losses import reg as R

    (gk,) = torch.autograd.grad(v, grid.surface_data, retain_graph=True)
    plain = grid.replace(surface_data=grid.surface_data.clone())
    plain.surface_data.requires_grad_(True)
    loss_p = R._eikonal_plain(plain, cells, target, 1.0 / cells.numel())
    (gp,) = torch.autograd.grad(loss_p, plain.surface_data)
    lk, lp = float(v), float(loss_p)
    log(f"K12d on the pipeline's first surface step ({cells.numel()} cells of "
        f"{grid.reso[0]}^3): loss {lk:.7e} (plain {lp:.7e})")
    if not abs(lk - lp) <= REG_LOSS_RTOL * abs(lp):
        raise AssertionError(f"reg_eikonal loss differs from its plain version: {lk} {lp}")
    return max(abs(lk - lp), grad_check("reg_eikonal surface_data", gk, gp, kernel="reg_eikonal"))


def blender(device, card: str, work: Path) -> tuple[dict, dict]:
    """Phase 10: K12a-K12d against their plain versions; one train step with
    the four extended flags against the plain step at 128^3 and the bench
    protocol with them at full width; a Blender-layout scene; then, with the
    counters set to 0 just before and read just after,
    app/pipeline.run_pipeline with dataset_type "nerf" at CUVOL_RESO^3 (the
    PIPELINE_STEPS, 100 + 100 steps of 8192, the weight init at the
    recipe's surface rate, lambda_surface_eikonal BLENDER_EIKONAL): every
    kernel of its path launched (K12d through the Trainer), a test PSNR
    above the untrained grid's, a finite Chamfer against the scene's GT
    points, the run's first K12d launch held against its plain version
    (hold_eikonal); then app/eval_imgs (2 views, and --render_depth) and
    app/debug_render (the image and one --pixel) on its checkpoint. Returns
    the kernels' numbers and the launches: K12a-K12c from the extended
    bench, the rest from the pipeline."""
    import math

    import numpy as np
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.app import debug_render, eval_imgs, pipeline
    from alphasurf_torch.data import NeRFDataset
    from alphasurf_torch.data.base import camera_of
    from alphasurf_torch.losses import reg as R
    from alphasurf_torch.train.steps import EXT_FLAGS
    from alphasurf_torch.utils.io import load_grid
    from alphasurf_torch.utils.png import read_png

    grid, rc = shell_grid(RESO, device)
    res = check_ext_reg(grid, rc, device)
    del grid, rc
    torch.cuda.empty_cache()
    check_step(device, EXT_FLAGS, EXT_HP)
    bench_launches = ext_step_bench(device, card)

    scene = work / "blender"
    info = write_blender_scene(device, scene)
    log(f"Blender scene of make_gt_grid({CUVOL_RESO}): {BLENDER_TRAIN} + {BLENDER_TEST} RGBA "
        f"views at {WIDTH}x{HEIGHT} in {info['seconds']:.2f} s (rendering "
        f"{info['render_seconds']:.2f} s); rays whose float32 bounds lose their exit, rendered "
        f"in float64: train {info['redo']['train']} of {BLENDER_TRAIN * WIDTH * HEIGHT}, "
        f"test {info['redo']['test']} of {BLENDER_TEST * WIDTH * HEIGHT} [{card}]")

    terms, held = [], []
    eikonal = R.surface_eikonal_loss

    def record(grid, cells, target=1.0):
        v = eikonal(grid, cells, target)
        if not held:
            held.append(hold_eikonal(grid, cells, target, v))
        terms.append(v.detach() * R.present_norm_scale(grid))  # the step's reg_scale
        return v

    out_dir = work / "blender_run"
    R.surface_eikonal_loss = record
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        out = pipeline.run_pipeline(
            str(out_dir), data_dir=str(scene), dataset_type="nerf", reso=CUVOL_RESO,
            n_iters_plenoxels=PIPELINE_STEPS[0], n_iters_surface=PIPELINE_STEPS[1],
            batch_size=PIPELINE_BATCH, gt_points_path=str(info["gt_points"]),
            overrides_surface=BLENDER_SURFACE, eval_downsample=0.001, device=device)
    finally:
        R.surface_eikonal_loss = eikonal
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log("launches " + json.dumps(launches))
    res["reg_eikonal"]["max_abs_err"] = max(res["reg_eikonal"]["max_abs_err"], held[0])
    missing = [k for k in BLENDER_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels of the Blender path were not launched: {missing}")
    st = out["stages"]
    for name, r in st.items():
        log(f"blender stage {name}: " + json.dumps(r) + f" [{card}]")
    eik = torch.stack(terms).float().cpu()
    if eik.numel() != PIPELINE_STEPS[1] or not bool(torch.isfinite(eik).all()):
        raise AssertionError(f"the eikonal term ran {eik.numel()} times: {eik.tolist()[:8]}")
    # the test mse after the surface stage, against which the weighted
    # term is set
    mse = 10.0 ** (-st["surface"]["psnr"] / 10.0)
    dset_test = NeRFDataset(str(scene), "test")
    psnr0 = eval_untrained(device, dset_test)
    s = out["summary"]
    log(f"pipeline on the Blender scene at {CUVOL_RESO}^3, {PIPELINE_STEPS} steps of "
        f"{PIPELINE_BATCH} rays, lambda_surface_eikonal {BLENDER_EIKONAL}: test PSNR "
        f"{s['psnr']:.4f} (render_imgs, {dset_test.n_images} views) against the untrained grid's "
        f"{psnr0:.4f}, {st['extract']['n_points']} points, Chamfer {s['chamfer']:.5f}; the "
        f"eikonal term (times reg_scale) per surface step "
        f"{float(eik.min()):.4e}..{float(eik.max()):.4e}, weighted "
        f"{BLENDER_EIKONAL * float(eik.mean()) / mse:.3f} of the stage's test mse {mse:.5f}; "
        f"{wall:.2f} s in all (data loading included), "
        f"max_memory_allocated {peak / 2**30:.3f} GiB [{card}]")
    if not (s["psnr"] > psnr0 and st["extract"]["n_points"] > 0 and math.isfinite(s["chamfer"])):
        raise AssertionError(f"the Blender pipeline did not run right: {s}, untrained {psnr0}")

    # the image apps on the pipeline's checkpoint
    ckpt = str(out_dir / "surface" / "ckpt.npz")
    view = min(3, dset_test.n_images - 1)  # debug_render's --img_id, as the app clamps it
    t0 = time.perf_counter()
    psnrs, _ = eval_imgs.main([ckpt, str(scene), "--dataset_type", "nerf", "-N", "2",
                               "--device", str(device)])
    psnrs_d, _ = eval_imgs.main([ckpt, str(scene), "--dataset_type", "nerf", "-N", "2",
                                 "--render_depth", "--device", str(device)])
    png = debug_render.main([str(out_dir / "surface"), str(scene), "--dataset_type", "nerf",
                             "--img_id", str(view), "--device", str(device)])
    # probe the centre pixel and the pixel nearest it that the image draws
    # and whose probe ray keeps its float32 exit: the probes take host-made
    # rays, the image device-made ones (as in the JAX app), and a ray that
    # loses its exit (ROADMAP §3) draws the background
    grid, _ = load_grid(ckpt, device=device)
    grid64 = grid.replace(radius=grid.radius.double(), center=grid.center.double())
    lost = _exit_lost(grid, grid64, camera_of(dset_test, view).gen_rays(device))
    del grid, grid64
    torch.cuda.empty_cache()
    drawn = (read_png(png) < 250).any(-1) & ~lost.reshape(HEIGHT, WIDTH).cpu().numpy()
    ys, xs = np.nonzero(drawn)
    k = int(np.argmin((ys - HEIGHT // 2) ** 2 + (xs - WIDTH // 2) ** 2))
    probes = debug_render.main([str(out_dir / "surface"), str(scene), "--dataset_type", "nerf",
                                "--img_id", str(view), "--pixel", f"{WIDTH // 2},{HEIGHT // 2}",
                                "--pixel", f"{xs[k]},{ys[k]}", "--device", str(device)])
    files = [out_dir / "surface" / f for f in ("psnr.txt", "ssim.txt", "test_renders/0000.png",
                                               "test_renders/0001.png")] + [Path(png)]
    log(f"apps on the Blender checkpoint in {time.perf_counter() - t0:.2f} s: eval_imgs PSNR "
        f"{[round(p, 4) for p in psnrs]} (depth run {[round(p, 4) for p in psnrs_d]}), "
        f"debug_render {Path(png).name}, pixels {probes} [{card}]")
    if not (len(psnrs) == 2 and np.isfinite(psnrs).all() and np.isfinite(psnrs_d).all()
            and all(f.is_file() for f in files)
            and all(np.isfinite(p["rgb"]).all() for p in probes) and probes[1]["alpha"] > 0):
        raise AssertionError(f"the image apps did not run right: {psnrs}, {psnrs_d}, {probes}")
    for name, r in res.items():
        log(f"time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound'][0]:.5f} ms ({r['bound'][1]}) [{card}]")
    launches.update({k: bench_launches[k] for k in EXTENDED_KERNELS if k != "reg_eikonal"})
    return res, launches


# ---------------------------------------------------------------------------
# the Tanks-and-Temples-style capture: NSVF layout, an MSI background
# ---------------------------------------------------------------------------

TNT_W, TNT_H = 1920, 1080  # Tanks and Temples' image size
TNT_FOCAL = 1165.0  # near the intrinsics of Tanks and Temples' 1920x1080 captures
TNT_TRAIN, TNT_TEST = 6, 2  # cut from a capture's few hundred views for the time limit
# warm start, surface stage: cut from 100 + 100 for time (to 30 + 30, then to 20 + 20 for
# the output-gradient checks; the margin over the run without a background 13.4 dB)
TNT_STEPS = (20, 20)
BG_LAYERS, BG_RESO = 64, 1024  # the Plenoxels Tanks-and-Temples background
CAM_SCALE_FACTOR = 0.95  # the NSVF loader's: cameras at a median radius 0.95
TNT_OBJECT_RADIUS = 0.25  # the object's sphere, in the normalised scene (cameras outside it)
TNT_RAW_RADIUS, TNT_RAW_CENTER = 4.2, (0.6, -0.4, 1.3)  # the capture's own frame
# the step at bench.py's protocol with the background group: lr_background
# and the two background regularizers (K12e, K12f) on
TNT_HP = {"lr_background": 1e-2, "lambda_tv_background": 1e-3,
          "lambda_tv_background_density": 1e-3, "lambda_tv_lumisphere": 1e-3}
# the Trainer's path on the capture: the warm start, the surface init (the
# prune and keep masks) and the surface stage, each rendering and training
# through K13, and the eval's dense march; a run resumed at step 0 from a
# grid at the stage's reso takes no density resample before the init (both
# packages set the stage from the checkpoint's reso)
TNT_KERNELS = TRAIN_KERNELS + WARM_STEP_KERNELS + (
    "cuvol_march", "keep_mask", "prune_mask", "background_forward", "background_backward")


def tnt_poses(split: str, n: int, seed: int = SEED):
    """OpenCV camera-to-world poses of the capture in its own frame: a ring
    around TNT_RAW_CENTER at radius TNT_RAW_RADIUS, elevations -5..25
    degrees, looking at the centre; the test views between the train ones."""
    import numpy as np

    from alphasurf_torch.data.synthetic import pose_spherical

    rng = np.random.default_rng(seed + (0 if split == "train" else 1))
    out = []
    for i in range(n):
        az = 360.0 * (i + (0.0 if split == "train" else 0.5)) / n + rng.uniform(-4, 4)
        c2w = pose_spherical(az, rng.uniform(-5, 25), TNT_RAW_RADIUS).astype(np.float64)
        c2w[:3, 3] += TNT_RAW_CENTER
        out.append(c2w)
    return out


def tnt_background(device, seed: int = SEED):
    """The ground-truth MSI: every one of the (2R, R) links present, rows in
    flat order, (2R R, nlayers, 4) float32 on the card (2.15 GB at 64 x
    1024): colours a few smooth waves of (u, v), periodic in u, different
    in each layer; density 0.05-0.15 in every layer, so that the far
    layers' spacing makes the spheres opaque."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 7)
    nlayers, reso = BG_LAYERS, BG_RESO
    W, H = 2 * reso, reso
    links = torch.arange(W * H, dtype=torch.int32, device=device).reshape(W, H)
    u = (torch.arange(W, device=device, dtype=torch.float32) / W)[:, None].expand(W, H)
    v = (torch.arange(H, device=device, dtype=torch.float32) / H)[None, :].expand(W, H)
    data = torch.empty((W * H, nlayers, 4), dtype=torch.float32, device=device)
    ku = rng.integers(1, 6, (4, 3))
    kv = rng.uniform(0.5, 4.0, (4, 3))
    amp = rng.uniform(0.3, 0.8, (4, 3))
    phase = rng.uniform(0, 2 * np.pi, (4, 3))
    for layer in range(nlayers):
        f = layer / nlayers
        for c in range(3):
            acc = torch.zeros((W, H), device=device)
            for j in range(4):
                acc += float(amp[j, c]) * torch.sin(2 * np.pi * (float(ku[j, c]) * u
                                                                 + float(kv[j, c]) * v)
                                                    + float(phase[j, c]) + 3.0 * f * (j + 1))
            data[:, layer, c] = acc.reshape(-1)
        data[:, layer, 3] = (0.1 + 0.05 * torch.sin(2 * np.pi * (2 * u + 3 * v) + 5.0 * f)
                             ).reshape(-1)
    return links, data


def tnt_gt_grid(device, dtype=None):
    """The scene's foreground: make_gt_grid(CUVOL_RESO) with its sphere
    shrunk to radius TNT_OBJECT_RADIUS (the SDF shifted by the difference in
    voxels), and the ground-truth MSI of tnt_background."""
    import torch

    from alphasurf_torch.data.synthetic import make_gt_grid

    dtype = torch.float32 if dtype is None else dtype
    g = make_gt_grid(CUVOL_RESO, basis_dim=9, dtype=dtype, device=device)
    shift = (0.5 - TNT_OBJECT_RADIUS) * CUVOL_RESO / 2.0
    links, data = tnt_background(device)
    return g.replace(surface_data=g.surface_data.detach() - shift, background_links=links,
                     background_data=data.to(dtype))


def write_tnt_scene(device, root: Path) -> dict:
    """An NSVF-layout capture (rgb/0_*.png and 2_*.png, pose/*.txt,
    intrinsics.txt as a 4x4 matrix) of tnt_gt_grid: TNT_TRAIN + TNT_TEST RGB
    views at TNT_W x TNT_H with TNT_FOCAL, poses in the capture's own frame
    (tnt_poses). The images are rendered in the frame the loader normalises
    to (similarity_from_cameras over every pose, CAM_SCALE_FACTOR): cameras
    at radius 0.95 inside the unit foreground grid, the object's sphere of
    TNT_OBJECT_RADIUS at the centre, the MSI behind it, through the packed
    renderer and K13 on host-made rays; as in write_dtu_scene, the rays
    whose float32 bounds lose their exit (ROADMAP §3) are re-rendered in
    float64 through the plain path (the foreground; the background, which
    does not depend on the bounds, from K13)."""
    import numpy as np
    import torch

    from alphasurf_torch.core.options import RenderOptions
    from alphasurf_torch.core.rays import Camera, Rays
    from alphasurf_torch.data.nsvf import similarity_from_cameras
    from alphasurf_torch.render import background as BG
    from alphasurf_torch.render import surface as S
    from alphasurf_torch.render.image import render_rays
    from alphasurf_torch.utils.png import write_png

    t0 = time.perf_counter()
    (root / "rgb").mkdir(parents=True, exist_ok=True)
    (root / "pose").mkdir(exist_ok=True)
    K = np.eye(4)
    K[0, 0] = K[1, 1] = TNT_FOCAL
    K[0, 2], K[1, 2] = TNT_W / 2.0, TNT_H / 2.0
    np.savetxt(root / "intrinsics.txt", K)
    views = [(f"0_{i:04d}", p) for i, p in enumerate(tnt_poses("train", TNT_TRAIN))]
    views += [(f"2_{i:04d}", p) for i, p in enumerate(tnt_poses("test", TNT_TEST))]
    for name, pose in views:
        np.savetxt(root / "pose" / f"{name}.txt", pose)
    # the loader's normalisation, from the poses as it reads them back
    raw = {name: np.loadtxt(root / "pose" / f"{name}.txt").reshape(4, 4) for name, _ in views}
    T, sscale = similarity_from_cameras(np.stack([raw[k] for k in sorted(raw)]))
    grid = tnt_gt_grid(device)
    grid64 = grid.replace(background_links=None, background_data=None, **{
        k: getattr(grid, k).double() for k in ("density_data", "sh_data", "surface_data",
                                               "level_set_data", "truncated_vol_render_a",
                                               "radius", "center")})
    opt = RenderOptions(sigma_thresh=-1e9, stop_thresh=-1.0, only_outward_intersect=True)
    with torch.no_grad():
        words64 = S._occupancy_words_plain(grid64, opt)
        packed64 = S.pack_grid_data(grid64)
    t_render, redo_n, c2ws = 0.0, {}, {}
    for name, _ in views:
        c2w = T @ raw[name]
        c2w[:3, 3] *= CAM_SCALE_FACTOR * sscale
        c2w = c2w.astype(np.float32)
        c2ws[name] = c2w
        rays = Camera.make(c2w, fx=TNT_FOCAL, width=TNT_W, height=TNT_H).gen_rays(device)
        t1 = time.perf_counter()
        with torch.no_grad():
            rgb = render_rays(grid, rays, opt)[0]
            redo = torch.nonzero(_exit_lost(grid, grid64, rays))[:, 0]
            split = "train" if name.startswith("0_") else "test"
            redo_n[split] = redo_n.get(split, 0) + redo.numel()
            for s0 in range(0, redo.numel(), CHUNK):
                idx = redo[s0:s0 + CHUNK]
                r32 = Rays(rays.origins[idx], rays.dirs[idx])
                r64 = Rays(r32.origins.double(), r32.dirs.double())
                origins, dirs, sh_mult, tn, tx, ngt = chunk_inputs(grid64, opt, r64)
                pool = S._compact_crossings_plain(grid64.reso, origins, dirs, tn, tx, words64)
                smp = S._voxel_samples_plain(grid64, opt, pool, origins, dirs, sh_mult, ngt,
                                             packed64)
                # the background does not depend on the ray's bounds: K13's
                c_bg = BG.background_color(grid, opt, *[S._prep(grid, r32, opt)[k]
                                                        for k in (0, 1, 7)])[0]
                comp = S._composite_plain(opt, grid64.truncated_vol_render_a, pool.offsets,
                                          smp, bg_rgb=c_bg.double())
                rgb[idx] = comp["rgb"].float()
        torch.cuda.synchronize()
        t_render += time.perf_counter() - t1
        img = rgb.clamp(0.0, 1.0).reshape(TNT_H, TNT_W, 3)
        write_png(root / "rgb" / f"{name}.png",
                  np.round(img.cpu().numpy() * 255.0).astype(np.uint8), level=1)
    del grid, grid64, words64, packed64
    torch.cuda.empty_cache()
    return {"seconds": time.perf_counter() - t0, "render_seconds": t_render, "redo": redo_n,
            "c2w": c2ws}


def tnt_config(data_dir: Path) -> str:
    """The capture's run: stages_config cut to its 256^3 warm start and 256^3
    surface stage (TNT_STEPS steps of 8192) on the NSVF loader,
    resumed from the checkpoint in the train dir (load_ckpt); the surface
    init by the alpha threshold, without camera sweeps or visibility
    pruning (tools/recipe_run.py's choice: the sweeps of the full-size views
    are host work this cell does not measure); no in-training extraction
    (the capture has no GT points); one eval view."""
    n0, n1 = TNT_STEPS
    keys = dict(line.split(" = ", 1) for line in stages_config((n0, n1, 0)).splitlines())
    for k in [k for k in keys if k.startswith("dataset_")] + ["n_train_images", "log_pts",
                                                              "eval_cf", "surf_eval_n_sample",
                                                              "surf_eval_intersect_th"]:
        keys.pop(k, None)
    keys.update({"dataset_type": "nsvf", "data_dir": str(data_dir),
                 "reso": f"[[{CUVOL_RESO}, {CUVOL_RESO}, {CUVOL_RESO}], [{CUVOL_RESO}, "
                         f"{CUVOL_RESO}, {CUVOL_RESO}]]",
                 "n_iters": n0 + n1, "thresh_type": "alpha", "visibility_pruning_scale": "0.0",
                 "load_ckpt": "True", "n_eval_test": 1})
    return "".join(f"{k} = {v}\n" for k, v in keys.items())


def bg_walk_rows(grid, opt, origins, dirs, delta_scale) -> tuple[int, int]:
    """(active steps, distinct (link, layer) rows they read) of the
    background's walk of these rays, from its plain version's corners."""
    import torch

    from alphasurf_torch.render import background as BG

    with torch.no_grad():
        _, geo, lnk, lay = BG.sphere_walk(grid, opt, origins, dirs, delta_scale)
        active = torch.stack([g[2] for g in geo], 0)  # (n_steps, B)
        use = active[:, None, :] & (lnk >= 0)
        rows = torch.unique((lnk * grid.background_nlayers + lay)[use])
    return int(active.sum()), int(rows.numel())


def check_background_kernels(device, card: str, dset) -> dict:
    """K13 forward and backward against their plain versions (the forward,
    autograd of it) on a 16,384-ray chunk of a train view of the capture at
    the full background size; K12e on 0.01 of the lattice and on every cell
    of the capture's foreground (256^3, basis_dim 9), K12f on 0.01 of the
    background's cells (drawn as the step draws them) and on every cell; and
    K4, K5a, K8 and K10 with a per-ray background colour: equal to their
    scalar path at a constant colour, and K4, K8 and K10 with K13's colour
    to their plain versions. Returns the numbers of the four new kernels."""
    import numpy as np
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.core.options import RenderOptions
    from alphasurf_torch.core.rays import Rays
    from alphasurf_torch.core.sh import eval_sh_bases
    from alphasurf_torch.losses import reg as R
    from alphasurf_torch.render import background as BG
    from alphasurf_torch.render import cuvol as C
    from alphasurf_torch.render import surface as S

    grid = tnt_gt_grid(device)
    opt = RenderOptions(sigma_thresh=-1e9, stop_thresh=-1.0, only_outward_intersect=True,
                        background_brightness=0.8)
    n_view = TNT_W * TNT_H
    s = n_view // 2 - CHUNK // 2 + TNT_W // 3
    rays = Rays(torch.as_tensor(dset.rays_init.origins[s:s + CHUNK], device=device).contiguous(),
                torch.as_tensor(dset.rays_init.dirs[s:s + CHUNK], device=device).contiguous())
    origins, dirs, sh_mult, tnear, tmax, ngt, ray_ok, ds = S._prep(grid, rays, opt)
    origins, dirs, ds = origins.contiguous(), dirs.contiguous(), ds.contiguous()
    B = origins.shape[0]
    data = grid.background_data
    n_bg = data.shape[0]
    args = BG._k13_args(grid, opt, origins, dirs, ds)
    n_steps = args[5]
    out = {}

    # K13 forward
    c_k, lt_k = kernels.background_forward(*args, data)
    with torch.no_grad():
        c_p, lt_p = BG._background_plain(grid, opt, origins, dirs, ds)
    err_c, frac_c = allclose_err(c_k, c_p)
    err_l, frac_l = allclose_err(lt_k, lt_p, rtol=1e-5, atol=1e-4)
    log(f"K13 forward on {B} rays of a {TNT_W}x{TNT_H} view, {BG_LAYERS} layers at reso "
        f"{BG_RESO} ({n_bg} links, {data.numel() * 4 / 1e9:.3f} GB), {n_steps} steps a ray: "
        f"c_bg max abs err {err_c:.3e} (fraction outside {frac_c}), log_T_bg {err_l:.3e} "
        f"({frac_l}); |log_T_bg| up to {float(lt_p.abs().max()):.3f}")
    if frac_c > 0 or frac_l > 0:
        raise AssertionError("K13 forward differs from its plain version")
    # the bytes each needs: the rays (origins, dirs, step scale), the links
    # and the distinct 16-byte rows its active steps read, each once, and
    # its outputs (c_bg and log_T_bg; the backward reads them with their
    # cotangents and adds to those rows); operations: about 160 flops an
    # active step forward, 320 backward
    n_active, touched = bg_walk_rows(grid, opt, origins, dirs, ds)
    ray_bytes = B * 7 * 4
    fwd_bound = bound_ms(ray_bytes + touched * (16 + 4) + B * 16, n_active * 160)
    bwd_bound = bound_ms(ray_bytes + B * 32 + touched * (32 + 4), n_active * 320)
    out["background_forward"] = dict(
        max_abs_err=max(err_c, err_l), ms=time_ms(lambda: kernels.background_forward(*args, data),
                                                  20),
        plain_ms=time_ms(lambda: BG._background_plain(grid, opt, origins, dirs, ds), 3),
        bound=fwd_bound)
    log(f"  {n_active} active steps of {B * n_steps}")

    # K13 backward against autograd of the plain version
    gen = torch.Generator(device=device).manual_seed(SEED)
    g_c = torch.randn((B, 3), generator=gen, device=device)
    g_lt = torch.randn(B, generator=gen, device=device) * 0.1
    g_k = kernels.background_backward(*args, data, lt_k, g_c, g_lt)
    plain = grid.replace(background_data=data)
    plain.background_data.requires_grad_(True)

    def plain_bwd():
        c, lt = BG._background_plain(plain, opt, origins, dirs, ds)
        return torch.autograd.grad((c * g_c).sum() + (lt * g_lt).sum(), plain.background_data)[0]

    g_p = plain_bwd()
    err = grad_check("K13 backward background_data", g_k.reshape(-1, 4), g_p.reshape(-1, 4),
                     kernel="background_backward",
                     atol=BG_GRAD_ATOL_REL * float(g_p.abs().max()))
    out["background_backward"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: kernels.background_backward(*args, data, lt_k, g_c, g_lt), 10),
        plain_ms=time_ms(plain_bwd, 2), bound=bwd_bound)
    plain.background_data.requires_grad_(False)
    del g_k, g_p, plain
    torch.cuda.empty_cache()

    # K4, K5a, K8 and K10 with a per-ray colour
    const = torch.full((B, 3), opt.background_brightness, device=device)
    words = S.occupancy_words(grid, opt)
    tn, tx = S._phase_a_bounds(tnear, tmax, ray_ok)
    pool = S.compact_crossings_packed(grid, origins, dirs, tn, tx, words)
    packed = S.pack_grid_data(grid)
    smp = S.voxel_samples(grid, opt, pool, origins, dirs, sh_mult, ngt, packed)
    ta = grid.truncated_vol_render_a
    k_scalar = kernels.composite(pool.offsets, smp, ta, opt)
    k_const = kernels.composite(pool.offsets, smp, ta, opt, bg_rgb=const)
    check_equal("K4 rgb with a constant per-ray colour", k_const["rgb"], k_scalar["rgb"])
    k_bg = kernels.composite(pool.offsets, smp, ta, opt, bg_rgb=c_k)
    p_bg = S._composite_plain(opt, ta, pool.offsets, smp, bg_rgb=c_k)
    e4 = check_close("K4 rgb with K13's colour against its plain version", k_bg["rgb"],
                     p_bg["rgb"], RTOL, ATOL)
    g_rgb = torch.randn((B, 3), generator=gen, device=device)
    g_rl = torch.zeros((12, B), device=device)
    b_scalar = kernels.backward_ray(pool.offsets, smp, ta, opt, g_rgb, g_rl)
    b_const = kernels.backward_ray(pool.offsets, smp, ta, opt, g_rgb, g_rl, bg_rgb=const)
    # a constant colour c sums g . c as g0 c + g1 c + g2 c, the scalar path
    # as c (g0 + g1 + g2): float32 rounding, the kernels' RTOL / ATOL
    for name, a, b in zip(("d_alpha", "d_t", "d_col"), b_const, b_scalar):
        check_close(f"K5a {name} with a constant per-ray colour", a, b, RTOL, ATOL)
    cgrid = blobby_cuvol_grid(CUVOL_RESO, device)[0]
    cgrid = cgrid.replace(background_links=grid.background_links, background_data=data)
    copt = RenderOptions(background_brightness=0.8)
    ray_t = tuple(x.contiguous() for x in C._prep(cgrid, rays, copt))
    cwords = C.density_occupancy_words(cgrid)
    cpool = C.cuvol_pool(cgrid, ray_t[0], ray_t[1], ray_t[4], ray_t[5], cwords)
    k8a = (cpool.offsets, cpool.l, cpool.close_t, cpool.far_t, *ray_t, cgrid.links,
           cgrid.density_data.detach()[:, 0], cgrid.sh_data.detach(), copt.step_size,
           C.n_slots(copt), False, copt.background_brightness)
    f_scalar = kernels.cuvol_forward(*k8a, save_entry_pre=True)
    f_const = kernels.cuvol_forward(*k8a, save_entry_pre=True, bg_rgb=const)
    check_equal("K8 rgb with a constant per-ray colour", f_const["rgb"], f_scalar["rgb"])
    cb = kernels.background_forward(*BG._k13_args(cgrid, copt, ray_t[0], ray_t[1], ray_t[3]),
                                    data)[0]
    f_bg = kernels.cuvol_forward(*k8a, bg_rgb=cb)
    smp8 = C._entry_samples_plain(cgrid, copt, cpool, *ray_t)
    p8 = C._composite_cuvol_plain(cpool.offsets, *smp8, cb, None)
    e8 = check_close("K8 rgb with K13's colour against its plain version", f_bg["rgb"],
                     p8["rgb"], RTOL, ATOL)
    gs = kernels.cuvol_backward(*k8a, f_scalar["log_T"], f_scalar["entry_pre"], g_rgb)
    gc = kernels.cuvol_backward(*k8a, f_const["log_T"], f_const["entry_pre"], g_rgb, bg_rgb=const)
    for name, a, b in zip(("density", "sh"), gc, gs):
        check_close(f"K8 backward {name} with a constant per-ray colour", a, b, RTOL, ATOL)
    n_march = (C.max_steps_for(cgrid, copt) + 15) // 16 * 16
    m_scalar = kernels.cuvol_march(*ray_t, cgrid.links, cgrid.density_data.detach()[:, 0],
                                   cgrid.sh_data.detach(), copt.step_size, n_march, False,
                                   copt.background_brightness)
    m_const = kernels.cuvol_march(*ray_t, cgrid.links, cgrid.density_data.detach()[:, 0],
                                  cgrid.sh_data.detach(), copt.step_size, n_march, False,
                                  copt.background_brightness, bg_rgb=const)
    check_equal("K10 rgb with a constant per-ray colour", m_const["rgb"], m_scalar["rgb"])
    with torch.no_grad():
        m_bg = C.volume_render_cuvol(cgrid, rays, copt)
        m_p = C._march_plain(cgrid, copt, *ray_t, n_march, 16, None)
        rgb_p = m_p["rgb"] + torch.exp(m_p["log_T"])[:, None] * cb
    e10 = check_close("K10 rgb with K13's colour against its plain version", m_bg["rgb"], rgb_p,
                      RTOL, ATOL)
    log(f"K4, K8, K10 with K13's colour: max abs err {e4:.3e}, {e8:.3e}, {e10:.3e}")
    del cgrid, cwords, cpool, smp8, packed, smp, words
    torch.cuda.empty_cache()

    # K12e on the foreground's lattice, K12f on the background's cells
    corners4 = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1))
    cpu_gen = torch.Generator().manual_seed(SEED)
    d, d_p = R.lumisphere_directions(cpu_gen)
    mult = eval_sh_bases(grid.basis_dim, torch.stack([d, d_p]).to(device).float()).contiguous()
    for label, frac in (("a lattice window of 0.01", 0.01), ("every lattice cell", 1.0)):
        cells = R.sample_cells(cpu_gen, grid, frac)
        n = cells.numel()

        def run_k():
            return kernels.reg_lumisphere(grid.links, cells, grid.sh_data.detach(), mult, 1.0,
                                          1.0 / n)

        loss_k, gk = run_k()
        grid.sh_data.requires_grad_(True)
        try:
            def plain():
                loss = R._lumisphere_plain(grid, cells, mult[0], mult[1], 1.0, 1.0 / n)
                return loss, torch.autograd.grad(loss, grid.sh_data)[0]

            loss_p, gp = plain()
            plain_ms = time_ms(plain, 2) if frac < 1.0 else None
        finally:
            grid.sh_data.requires_grad_(False)
        lk, lp = float(loss_k), float(loss_p.detach())
        log(f"K12e on {label} of {CUVOL_RESO}^3 ({n} cells): loss {lk:.7e} (plain {lp:.7e})")
        if not abs(lk - lp) <= REG_LOSS_RTOL * abs(lp):
            raise AssertionError(f"reg_lumisphere loss differs from its plain version: {lk} {lp}")
        err = max(abs(lk - lp), grad_check(
            "reg_lumisphere sh_data", gk, gp, kernel="reg_lumisphere",
            rel_tol=GRAD_REL if frac < 1.0 else DENSE_TV_GRAD_REL))
        if frac < 1.0:
            out["reg_lumisphere"] = dict(
                max_abs_err=err, ms=time_ms(run_k, 20), plain_ms=plain_ms,
                bound=bound_ms(ext_bytes(grid, cells, corners4, 27), n * 500))
        else:
            out["reg_lumisphere"]["max_abs_err"] = max(out["reg_lumisphere"]["max_abs_err"], err)
            log(f"  reg_lumisphere over every cell: kernel {time_ms(run_k, 3):.4f} ms")
        del cells, gk, gp
        torch.cuda.empty_cache()
    n_bgc = grid.background_links.numel() * BG_LAYERS
    for label, cells in (("0.01 of the cells", R.sample_background_cells(cpu_gen, grid, 0.01)),
                         ("every cell", torch.arange(n_bgc, dtype=torch.int32, device=device))):
        n = cells.numel()

        def run_k():
            return kernels.reg_background_tv(grid.background_links, cells, data, 0.3, 0.05,
                                             1.0 / n)

        loss_k, gk = run_k()
        plain = grid.replace(background_data=data)
        plain.background_data.requires_grad_(True)
        step = 1 << 24  # the plain version's intermediates over every cell, in slices

        def plain_tv():
            loss, g = 0.0, None
            for c0 in range(0, n, step):
                part = R._background_tv_plain(plain, cells[c0:c0 + step], 0.3, 0.05, 1.0 / n)
                gpart = torch.autograd.grad(part, plain.background_data)[0]
                loss, g = loss + part.detach(), gpart if g is None else g + gpart
            return loss, g

        loss_p, gp = plain_tv()
        plain_ms = time_ms(plain_tv, 2) if n < n_bgc else None
        plain.background_data.requires_grad_(False)
        lk, lp = float(loss_k), float(loss_p)
        log(f"K12f on {label} of the background ({n} cells): loss {lk:.7e} (plain {lp:.7e})")
        if not abs(lk - lp) <= REG_LOSS_RTOL * abs(lp):
            raise AssertionError(f"reg_background_tv loss differs from its plain version: {lk} "
                                 f"{lp}")
        err = max(abs(lk - lp), grad_check(
            "reg_background_tv background_data", gk.reshape(-1, 4), gp.reshape(-1, 4),
            kernel="reg_background_tv", rel_tol=GRAD_REL if n < n_bgc else DENSE_TV_GRAD_REL))
        if n < n_bgc:
            uniq = int(torch.unique(cells).numel())
            out["reg_background_tv"] = dict(
                max_abs_err=err, ms=time_ms(run_k, 20), plain_ms=plain_ms,
                # cell ids, 3 links and 4 rows of 16 bytes a distinct cell
                # read, the gradient (every row) written
                bound=bound_ms(n * 4 + uniq * (12 + 64) + data.numel() * 4, n * 120))
        else:
            out["reg_background_tv"]["max_abs_err"] = max(out["reg_background_tv"]["max_abs_err"],
                                                          err)
            log(f"  reg_background_tv over every cell: kernel {time_ms(run_k, 3):.4f} ms")
        del cells, gk, gp, plain
        torch.cuda.empty_cache()
    del grid, data
    torch.cuda.empty_cache()
    for name, r in out.items():
        log(f"time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound'][0]:.5f} ms ({r['bound'][1]}) [{card}]")
    return out


def tnt_step_bench(device, card: str) -> dict:
    """bench_step's protocol (512^3 shell, batch 40960 of one 800x800
    camera, 1 + 33 steps) through make_surface_step with the capture's MSI
    as the grid's background and its rms group: K13 forward and backward,
    K12e (use_lumisphere_tv) and K12f, and K7 on the background's rows
    (TNT_HP); the counters set to 0 just before and read just after. Then
    one profiled step."""
    import math

    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.app import bench_step
    from alphasurf_torch.core.rays import Rays
    from alphasurf_torch.render.surface import occupancy_words
    from alphasurf_torch.train.steps import StepConfig, init_rms, make_surface_step

    grid, rc = bench_step.build_bench_grid(RESO, device)
    links, data = tnt_background(device)
    grid = grid.replace(background_links=links, background_data=data)
    opt = bench_step.bench_options()
    hp = bench_step.bench_hparams()._replace(**TNT_HP)
    step = make_surface_step(StepConfig(opt=opt, cache_size=None, use_lumisphere_tv=True))
    rays = bench_step.bench_rays(WIDTH, device)
    rms, gen = init_rms(grid), torch.Generator().manual_seed(SEED)
    gt = torch.full((TRAIN_BATCH, 3), 0.5, device=device)
    n = rays.origins.shape[0]
    lo, span = int(n * 0.35), max(int(n * 0.30) - TRAIN_BATCH, 1)
    occ = occupancy_words(grid, opt)
    bg0 = data.clone()

    def batch(i):
        s = lo + (i * TRAIN_BATCH) % span
        return Rays(rays.origins[s:s + TRAIN_BATCH], rays.dirs[s:s + TRAIN_BATCH])

    kernels.reset_launches()
    losses = [step(grid, rms, batch(0), gt, hp, gen, occ=occ, row_coords=rc)[2]["loss"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(33):
        if i > 0 and i % 16 == 0:
            occ = occupancy_words(grid, opt)
        losses.append(step(grid, rms, batch(i), gt, hp, gen, occ=occ, row_coords=rc)[2]["loss"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in TRAIN_KERNELS + BACKGROUND_KERNELS}
    losses = torch.stack(losses).tolist()
    moved = float((grid.background_data - bg0).abs().max())
    log(f"train with the background group: 33 steps of {TRAIN_BATCH} rays at {RESO}^3 with the "
        f"{BG_LAYERS} x {BG_RESO} MSI: {33 * TRAIN_BATCH / secs:.1f} rays/s, "
        f"{secs / 33 * 1e3:.3f} ms per step, loss {losses[0]:.6f} -> {losses[-1]:.6f}, "
        f"background rows moved by up to {moved:.3e} [{card}]")
    log("launches " + json.dumps(launches))
    if any(v == 0 for v in launches.values()) or not all(math.isfinite(x) for x in losses) \
            or not moved > 0:
        raise AssertionError(f"the background step did not run right: {launches}, {losses[:4]}")
    r = batch(3)
    _, busy, rows = profile_device(lambda: step(grid, rms, r, gt, hp, gen, occ=occ, row_coords=rc),
                                   f"one train step with the background group ({TRAIN_BATCH} "
                                   f"rays, {RESO}^3, {BG_LAYERS} x {BG_RESO} MSI)", card)
    bg_ms = sum(ms for ms, _, key in rows if "background" in key or "lumisphere" in key)
    log(f"K13, K12e, K12f: {bg_ms:.4f} ms of the step's {busy:.3f} ms device time "
        f"({bg_ms / busy:.4f}) [{card}]")
    del grid, rc, rms, occ, data, bg0
    torch.cuda.empty_cache()
    return launches


def tnt_run(device, card: str, work: Path, scene: Path, with_bg: bool) -> dict:
    """app/train.main on the capture (tnt_config), resumed from a checkpoint
    of a CUVOL_RESO^3 grid at the Config's init holding the ground-truth MSI
    (with_bg) or none (the brightness alone); then app/render_imgs on the
    test split. The counters set to 0 just before the Trainer and read just
    after render_imgs."""
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.app import render_imgs
    from alphasurf_torch.app import train as train_app
    from alphasurf_torch.app.config import Config
    from alphasurf_torch.core.grid import create_grid
    from alphasurf_torch.utils.io import save_grid

    tag = "with" if with_bg else "without"
    train_dir = work / f"tnt_{tag}"
    train_dir.mkdir(parents=True, exist_ok=True)
    cfg = Config()
    grid = create_grid(CUVOL_RESO, basis_dim=cfg.sh_dim, use_sphere_bound=True,
                       init_sigma=cfg.init_sigma, device=device)
    if with_bg:
        links, data = tnt_background(device)
        grid = grid.replace(background_links=links, background_data=data)
    t0 = time.perf_counter()
    save_grid(grid, str(train_dir / "ckpt.npz"))
    del grid
    torch.cuda.empty_cache()
    ckpt_s = time.perf_counter() - t0
    cfg_file = work / f"tnt_{tag}.yaml"
    cfg_file.write_text(tnt_config(scene))
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    train_app.main([str(scene), "-t", str(train_dir), "-c", str(cfg_file), "--device", str(device)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    psnr = render_imgs.main([str(train_dir / "ckpt.npz"), str(scene), "--dataset_type", "nsvf",
                             "--no_imsave", "--device", str(device)])
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"tnt run {tag} the background: checkpoint written in {ckpt_s:.2f} s, train "
        f"{train_s:.2f} s ({TNT_STEPS[0]} + {TNT_STEPS[1]} steps of 8192), render_imgs "
        f"{render_s:.2f} s ({TNT_TEST} test views at {TNT_W}x{TNT_H}): test PSNR {psnr:.4f}, "
        f"max_memory_allocated {peak / 2**30:.3f} GiB [{card}]")
    log("launches " + json.dumps(launches))
    return {"psnr": psnr, "launches": launches, "ckpt": train_dir / "ckpt.npz",
            "seconds": train_s + render_s}


def tnt(device, card: str, work: Path) -> tuple[dict, dict]:
    """Phase 11: the Tanks-and-Temples-style capture. An NSVF-layout scene
    (write_tnt_scene: TNT_TRAIN + TNT_TEST views at 1920x1080, cameras at radius 0.95
    inside the foreground grid, the 64 x 1024 MSI behind); K13, K12e and
    K12f against their plain versions and K4, K5a, K8 and K10 with per-ray
    colours (check_background_kernels); the step at bench.py's protocol
    with the background group (tnt_step_bench); then the capture's run
    (tnt_run) with the ground-truth background in the resumed checkpoint,
    whose Trainer and render_imgs must launch every kernel of the path,
    beside the same run without a background: the run with it must score
    the higher test PSNR; then one 1920x1080 frame served through
    app/render_circle from each run's checkpoint, with and without K13.
    Returns the four new kernels' numbers and their launches: K13 from the
    capture's run, K12e and K12f from the bench."""
    import math

    import numpy as np
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.app import render_circle
    from alphasurf_torch.data import NSVFDataset

    t_phase = time.perf_counter()
    scene = work / "tnt"
    info = write_tnt_scene(device, scene)
    log(f"tnt scene: NSVF layout, {TNT_TRAIN} + {TNT_TEST} RGB views at {TNT_W}x{TNT_H}, "
        f"make_gt_grid({CUVOL_RESO}) shrunk to a sphere of {TNT_OBJECT_RADIUS} and a "
        f"{BG_LAYERS}-layer MSI at reso {BG_RESO} in {info['seconds']:.2f} s (rendering "
        f"{info['render_seconds']:.2f} s); rays whose float32 bounds lose their exit, "
        f"rendered in float64: train {info['redo'].get('train', 0)} of "
        f"{TNT_TRAIN * TNT_W * TNT_H}, test {info['redo'].get('test', 0)} of "
        f"{TNT_TEST * TNT_W * TNT_H} [{card}]")
    t0 = time.perf_counter()
    dset = NSVFDataset(str(scene), "train")
    dset_test = NSVFDataset(str(scene), "test")
    for i in range(TNT_TEST):
        if not np.array_equal(dset_test.c2w[i], info["c2w"][f"2_{i:04d}"]):
            raise AssertionError(f"the loader's test pose {i} is not the rendered one")
    radii = np.linalg.norm(dset.c2w[:, :3, 3], axis=-1)
    log(f"NSVF loader: {dset.n_images} train and {dset_test.n_images} test views in "
        f"{time.perf_counter() - t0:.2f} s, scene_scale {dset.scene_scale:.6f}, camera radii "
        f"{radii.min():.4f}..{radii.max():.4f} (median {np.median(radii):.4f})")
    res = check_background_kernels(device, card, dset)
    del dset, dset_test
    bench_launches = tnt_step_bench(device, card)

    runs = {flag: tnt_run(device, card, work, scene, flag) for flag in (True, False)}
    launches = runs[True]["launches"]
    missing = [k for k in TNT_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels of the capture's path were not launched: {missing}")
    if runs[False]["launches"]["background_forward"] != 0:
        raise AssertionError("the run without a background launched K13")
    p_with, p_without = runs[True]["psnr"], runs[False]["psnr"]
    log(f"tnt: test PSNR {p_with:.4f} with the background against {p_without:.4f} without "
        f"(margin {p_with - p_without:+.4f} dB) [{card}]")
    if not (math.isfinite(p_with) and p_with > p_without):
        raise AssertionError(f"the run with the background did not score higher: {p_with} "
                             f"{p_without}")

    frames = {}
    for flag, r in runs.items():
        kernels.reset_launches()
        out = render_circle.main([str(r["ckpt"]), "--n_frames", "1", "--width", str(TNT_W),
                                  "--height", str(TNT_H), "--fx", str(TNT_FOCAL), "--radius",
                                  "0.95", "--elevation", "-10", "--out_dir",
                                  str(work / f"tnt_circle_{flag}"), "--device", str(device)])
        torch.cuda.synchronize()
        frames[flag] = (out["frame_seconds"][0], kernels.LAUNCHES["background_forward"])
    log(f"serving one {TNT_W}x{TNT_H} frame through render_circle: {frames[True][0] * 1e3:.1f} "
        f"ms with the background ({frames[True][1]} K13 launches), {frames[False][0] * 1e3:.1f} "
        f"ms without ({frames[False][1]}) [{card}]")
    if frames[True][1] == 0 or frames[False][1] != 0:
        raise AssertionError(f"serving did not go through K13 as expected: {frames}")
    launches = {k: launches[k] for k in ("background_forward", "background_backward")}
    launches.update({k: bench_launches[k] for k in ("reg_lumisphere", "reg_background_tv")})
    log(f"tnt phase in {time.perf_counter() - t_phase:.1f} s")
    return res, launches


# ---------------------------------------------------------------------------
# the learned bases (3D texture and MLP) and K12g
# ---------------------------------------------------------------------------

BASIS_TEX_MAX, BASIS_TEX_MEAN = 5e-3, 5e-4  # texture frames against the SH frames
# the MLP basis on the card against float64 on the CPU, relative to its
# largest value: float32 products and sums of 27 and 64 terms (~1e-6); TF32,
# were it on, would round the products' inputs to 10 bits (~1e-3)
MLP_RTOL = 1e-5


def check_mlp_basis(device) -> float:
    """The MLP basis (init_basis_mlp's defaults) at an 800x800 frame's view
    directions on the card, against the same parameters in float64 on the
    CPU; returns the error relative to the largest value."""
    import torch

    from alphasurf_torch.core.sh import BasisMLP, eval_basis_mlp, init_basis_mlp

    mlp = init_basis_mlp(torch.Generator().manual_seed(SEED), 9, device=device)
    d = frame_camera(0, 2).gen_rays_device(device).dirs
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    got = eval_basis_mlp(mlp, d).double().cpu()
    ref = eval_basis_mlp(BasisMLP.from_dict(mlp.tensors(), device="cpu", dtype=torch.float64),
                         d.double().cpu())
    err = float((got - ref).abs().max() / ref.abs().max())
    log(f"MLP basis at {d.shape[0]} view directions, the card against float64: rel err "
        f"{err:.3e} (limit {MLP_RTOL}; matmul TF32 {torch.backends.cuda.matmul.allow_tf32})")
    if not err <= MLP_RTOL:
        raise AssertionError(f"the MLP basis on the card is {err} from float64")
    return err


def disjoint_units(units, n_vertices: int, keys=None) -> list:
    """Indices of a greedy selection of ``units`` (arrays of flat vertex ids)
    that share no vertex with each other (and, with ``keys``, no key): the
    rows a kernel's atomics reach then each take adds from one thread only,
    so its outputs are bit for bit reproducible."""
    import numpy as np

    used = np.zeros(n_vertices, dtype=bool)
    seen, chosen = set(), []
    for i, ids in enumerate(units):
        if keys is not None and keys[i] in seen:
            continue
        if used[ids].any():
            continue
        used[ids] = True
        if keys is not None:
            seen.add(keys[i])
        chosen.append(i)
    return chosen


def corner_vertices(grid, l):
    """(8, M) flat vertex ids of the corners of voxels l (M, 3), clamped."""
    import torch

    X, Y, Z = grid.reso
    lx, ly, lz = (l[:, a].long() for a in range(3))
    return torch.stack([(torch.clamp(lx + dx, max=X - 1) * Y + torch.clamp(ly + dy, max=Y - 1))
                        * Z + torch.clamp(lz + dz, max=Z - 1)
                        for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)])


def basis_grad_check(label: str, kernel: str, g_kernel: dict, g_plain: dict) -> float:
    """grad_check on every group of a learned basis's gradient (the MLP's
    tensors as rows); returns the max abs error."""
    err = 0.0
    log(f"{kernel} backward with the learned basis ({label}), kernels against autograd of the "
        f"plain path:")
    for k, gp in g_plain.items():
        gk = g_kernel[k]
        if gp.dim() == 1:
            gk, gp = gk.reshape(1, -1), gp.reshape(1, -1)
        err = max(err, grad_check(k, gk.reshape(-1, gk.shape[-1]), gp.reshape(-1, gp.shape[-1]),
                                  kernel))
    return err


def check_basis_kernels(device, card: str) -> dict:
    """Phase 12a: K12g against its plain version on the 32^3 x 9 texture;
    K5b with the sh_mult output (the texture's and the SH rows' gradients of
    the bench loss on a 16,384-ray chunk of the 512^3 shell, through the
    renderer, against autograd of the plain renderer), and its null-pointer
    path bit for bit equal to the output's path on entries whose corner rows
    no other entry touches; K8's backward likewise on the 256^3 blobby grid,
    on rays whose rows no other ray touches; K10's backward with the output
    on the same chunk against autograd of the plain march. Each timed with
    and without the output."""
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.app.bench_step import (BASIS_RESO, bench_options, cuvol_options,
                                                with_basis)
    from alphasurf_torch.core.rays import Rays
    from alphasurf_torch.core.sh import eval_basis
    from alphasurf_torch.losses import reg as R
    from alphasurf_torch.render import cuvol as C
    from alphasurf_torch.render import surface as S

    res = {}
    # K12g on a perturbed SH texture (the init alone has many equal cells)
    g0 = torch.Generator(device=device).manual_seed(SEED)
    grid, _ = shell_grid(RESO, device)
    grid = with_basis(grid, "texture")
    with torch.no_grad():
        grid.basis_data.add_(0.05 * torch.randn(grid.basis_data.shape, generator=g0,
                                                 device=device))
    tex = grid.basis_data.detach()
    Rb, bd = tex.shape[0], tex.shape[-1]
    scale = 1.0 / (Rb - 1) ** 3
    lk, gk = kernels.reg_basis_tv(tex, scale)
    t = tex.clone().requires_grad_(True)
    lp = R._basis_tv_plain(t)
    (gp,) = torch.autograd.grad(lp, [t])
    if abs(float(lk) - float(lp)) > REG_LOSS_RTOL * abs(float(lp)):
        raise AssertionError(f"K12g loss {float(lk)} differs from the plain {float(lp)}")
    log(f"K12g basis TV {Rb}^3 x {bd}: loss {float(lk):.7f} (plain {float(lp):.7f})")
    err = grad_check("basis_data", gk.reshape(-1, bd), gp.reshape(-1, bd), "K12g",
                     rel_tol=DENSE_TV_GRAD_REL)

    def k12g_plain():
        t2 = tex.clone().requires_grad_(True)
        return torch.autograd.grad(R._basis_tv_plain(t2), [t2])

    res["reg_basis_tv"] = dict(max_abs_err=err, ms=time_ms(lambda: kernels.reg_basis_tv(tex, scale),
                                                           50),
                               plain_ms=time_ms(k12g_plain, 10),
                               bound=bound_ms(2 * tex.numel() * 4 + 8,
                                              (Rb - 1) ** 3 * bd * 30))
    del t, gk, gp

    # K5 with the sh_mult output, on the bench options' chunk of frame 0
    opt = bench_options()
    rays_all = frame_camera(0, 2).gen_rays_device(device)
    s = (WIDTH * HEIGHT) // 2 - CHUNK // 2
    rays = Rays(rays_all.origins[s:s + CHUNK].contiguous(), rays_all.dirs[s:s + CHUNK].contiguous())
    words = S.occupancy_words(grid, opt)
    origins, dirs, viewdirs, tnear, tmax, ngt, ok, _ = S._prep_rays(grid, rays, opt)
    tn = torch.where(ok, tnear, torch.zeros_like(tnear))
    tx = torch.where(ok, tmax, torch.full_like(tmax, -1.0))
    pool = S._compact_crossings_plain(grid.reso, origins, dirs, tn, tx, words)
    B, M = CHUNK, pool.close_t.shape[0]
    params = [grid.basis_data, grid.sh_data]
    for p in params:
        p.requires_grad_(True)
    try:
        out = S.volume_render_surface_packed(grid, rays, opt, occupancy=words)
        g_kernel = torch.autograd.grad(torch.mean((out["rgb"] - 0.5) ** 2), params)
        shm = eval_basis(grid, viewdirs)
        comp = S._render_plain(grid, opt, pool, origins, dirs, shm, ngt, S.pack_grid_data(grid))
        loss_p = torch.mean((comp["rgb"] - 0.5) ** 2)
        g_plain = torch.autograd.grad(loss_p, params, retain_graph=True)
        plain_ms = time_ms(lambda: torch.autograd.grad(loss_p, params, retain_graph=True), 3)
        del comp, loss_p, shm
    finally:
        for p in params:
            p.requires_grad_(False)
    err = basis_grad_check("texture, 512^3 shell chunk", "K5",
                           dict(zip(("basis_data", "sh"), g_kernel)),
                           dict(zip(("basis_data", "sh"), g_plain)))
    del g_kernel, g_plain
    # K5a's cotangents of the chunk, then K5b with and without the output
    sh_mult = eval_basis(grid, viewdirs).detach().contiguous()
    packed = S.pack_grid_data(grid)
    fss = grid.fake_sample_std.detach()
    sk = kernels.phase_b(pool.ray_id, pool.l, pool.close_t, pool.far_t, origins, dirs, sh_mult,
                         grid.links, packed, kernels.SDF, grid.level_set_data, ngt, fss, opt)
    ck = kernels.composite(pool.offsets, sk, grid.truncated_vol_render_a, opt)
    g_rgb = (2.0 * (ck["rgb"] - 0.5) / (3 * B)).contiguous()
    g_rl = torch.zeros((12, B), dtype=torch.float32, device=device)
    d_alpha, d_t, d_col = kernels.backward_ray(pool.offsets, sk, grid.truncated_vol_render_a, opt,
                                               g_rgb, g_rl)

    def k5b(want, sub=None, fs=fss):
        e = slice(None) if sub is None else sub
        return kernels.backward_entry(
            pool.ray_id[e].contiguous(), pool.l[e].contiguous(), pool.close_t[e].contiguous(),
            pool.far_t[e].contiguous(), origins, dirs, sh_mult, grid.links, packed, kernels.SDF,
            grid.level_set_data, ngt, fs, opt, sk["contrib"][:, e].contiguous(),
            d_alpha[:, e].contiguous(), d_t[:, e].contiguous(), d_col[:, :, e].contiguous(), g_rl,
            None, want_sh_mult=want)

    verts_t = corner_vertices(grid, pool.l)
    verts = verts_t.T.cpu().numpy()
    sub = torch.as_tensor(disjoint_units(verts, grid.links.numel(),
                                         pool.ray_id.cpu().numpy()), device=device)
    a0, a1 = k5b(False, sub, None), k5b(True, sub, None)
    if not all(torch.equal(x, y) for x, y in zip(a0[:3], a1[:3])):
        raise AssertionError("K5b's gradients with the sh_mult output differ from its null path")
    log(f"K5b null path: on {sub.numel()} of {M} entries whose corner rows no other touches (one "
        f"a ray), density, surface and SH gradients bit for bit equal with and without the "
        f"sh_mult output; |g_sh_mult| {float(a1[4].norm()):.4e}")
    M_rays = int(torch.unique(pool.ray_id).numel())
    # as check_backward's K5b bound, with the basis's gradient written
    pos = torch.unique(verts_t)
    n_rows = int((grid.links.reshape(-1)[pos] >= 0).sum())
    bytes_b = (M * 24 + B * 60 + pos.numel() * 4 + n_rows * packed.shape[1] * 4
               + sk["n_slots"] * M * 21 + B * 8 + grid.capacity * 29 * 4)
    ops_b = M * 2 * (48 * grid.basis_dim + 60 + grid.level_set_data.numel() * 550 + 200)
    ms0, ms1 = time_ms(lambda: k5b(False), 20), time_ms(lambda: k5b(True), 20)
    log(f"K5b on the chunk ({M} entries of {M_rays} rays): {ms0:.4f} ms without the sh_mult "
        f"output, {ms1:.4f} ms with it [{card}]")
    res["backward_entry_basis"] = dict(max_abs_err=err, ms=ms1, plain_ms=plain_ms,
                                       ms_without=ms0,
                                       bound=bound_ms(bytes_b + B * bd * 4,
                                                      ops_b + M * 8 * 3 * bd * 2))
    del grid, packed, pool, sk, ck, d_alpha, d_t, d_col, a0, a1
    torch.cuda.empty_cache()

    # K8's backward with the sh_mult output on the 256^3 blobby grid
    cg, _ = blobby_cuvol_grid(CUVOL_RESO, device)
    cg = with_basis(cg, "texture")
    copt = cuvol_options()
    cwords = C.density_occupancy_words(cg)
    params = [cg.basis_data, cg.sh_data, cg.density_data]
    for p in params:
        p.requires_grad_(True)
    try:
        out = C.volume_render_cuvol_packed(cg, rays, copt, occupancy=cwords)
        g_kernel = torch.autograd.grad(torch.mean((out["rgb"] - 0.5) ** 2), params)
        o, d, vd, ds, tmin, tmax = C._prep_rays(cg, rays, copt)
        cpool = C.cuvol_pool(cg, o, d, tmin, tmax, cwords)
        shm = eval_basis(cg, vd)
        smp = C._entry_samples_plain(cg, copt, cpool, o, d, shm, ds, tmin, tmax)
        fp = C._composite_cuvol_plain(cpool.offsets, *smp, copt.background_brightness, None)
        loss_p = torch.mean((fp["rgb"] - 0.5) ** 2)
        g_plain = torch.autograd.grad(loss_p, params, retain_graph=True)
        plain_ms = time_ms(lambda: torch.autograd.grad(loss_p, params, retain_graph=True), 3)
        del smp, fp, loss_p, shm
    finally:
        for p in params:
            p.requires_grad_(False)
    names = ("basis_data", "sh", "density")
    err = basis_grad_check("texture, 256^3 blobby chunk", "K8", dict(zip(names, g_kernel)),
                           dict(zip(names, g_plain)))
    del g_kernel, g_plain
    ray_t, cpool = cuvol_chunk(cg, copt, rays, cwords)
    chunk = C._CuvolChunk(cg, copt, cpool, ray_t, None)
    dens, sh = cg.density_data.detach()[:, 0].contiguous(), cg.sh_data.detach()
    fk = C._k8_forward(chunk, dens, sh, True)
    g_rgb = (2.0 * (fk["rgb"] - 0.5) / (3 * B)).contiguous()

    def k8b(want, ch=chunk, f=fk, g=g_rgb):
        return kernels.cuvol_backward(*C._k8_args(ch, dens, sh), f["log_T"], f["entry_pre"], g,
                                      want_sh_mult=want)

    # rays whose entries' corner rows no other ray's touch
    offs = cpool.offsets.cpu().numpy()
    verts = corner_vertices(cg, cpool.l).T.reshape(-1).cpu().numpy()
    units = [verts[offs[r] * 8:offs[r + 1] * 8] for r in range(B)]
    keep = [r for r in disjoint_units(units, cg.links.numel()) if offs[r + 1] > offs[r]]
    kt = torch.as_tensor(keep, device=device)
    sub_rays = Rays(rays.origins[kt].contiguous(), rays.dirs[kt].contiguous())
    sub_t, sub_pool = cuvol_chunk(cg, copt, sub_rays, cwords)
    sub_chunk = C._CuvolChunk(cg, copt, sub_pool, sub_t, None)
    sub_f = C._k8_forward(sub_chunk, dens, sh, True)
    sub_g = g_rgb[kt].contiguous()
    b0 = k8b(False, sub_chunk, sub_f, sub_g)
    b1 = k8b(True, sub_chunk, sub_f, sub_g)
    if not (torch.equal(b0[0], b1[0]) and torch.equal(b0[1], b1[1])):
        raise AssertionError("K8's gradients with the sh_mult output differ from its null path")
    log(f"K8 backward null path: on {len(keep)} of {B} rays whose rows no other ray touches, "
        f"density and SH gradients bit for bit equal with and without the sh_mult output")
    Mc = cpool.close_t.shape[0]
    n_links, n_rows = corner_rows(cg, ((cpool.l[:, 0].long() * CUVOL_RESO + cpool.l[:, 1].long())
                                       * CUVOL_RESO + cpool.l[:, 2].long()))
    in_bytes = Mc * 20 + (B + 1) * 8 + B * 72 + n_links * 4 + n_rows * 28 * 4
    ms0, ms1 = time_ms(lambda: k8b(False), 20), time_ms(lambda: k8b(True), 20)
    log(f"K8 backward on the chunk ({Mc} entries): {ms0:.4f} ms without the sh_mult output, "
        f"{ms1:.4f} ms with it [{card}]")
    res["cuvol_backward_basis"] = dict(
        max_abs_err=err, ms=ms1, plain_ms=plain_ms, ms_without=ms0,
        bound=bound_ms(in_bytes + B * 16 + Mc * 4 + cg.capacity * 28 * 4 + B * bd * 4,
                       Mc * 8 * 3 * 9 * 4))

    # K10's backward with the sh_mult output on the same chunk: the dense
    # march through volume_render_cuvol against autograd of the plain march
    n_steps = (C.max_steps_for(cg, copt) + 15) // 16 * 16
    for p in params:
        p.requires_grad_(True)
    try:
        out = C.volume_render_cuvol(cg, rays, copt)
        g_kernel = torch.autograd.grad(torch.mean((out["rgb"] - 0.5) ** 2), params)
        o, d, vd, ds, tmin, tmax = C._prep_rays(cg, rays, copt)
        mp = C._march_plain(cg, copt, o, d, eval_basis(cg, vd), ds, tmin, tmax, n_steps, 16, None)
        rgb_p = mp["rgb"] + torch.exp(mp["log_T"])[:, None] * copt.background_brightness
        g_plain = torch.autograd.grad(torch.mean((rgb_p - 0.5) ** 2), params)
        del out, mp, rgb_p
    finally:
        for p in params:
            p.requires_grad_(False)
    basis_grad_check("texture, 256^3 blobby chunk, the dense march", "K10",
                     dict(zip(names, g_kernel)), dict(zip(names, g_plain)))
    del g_kernel, g_plain
    mchunk = C._MarchChunk(cg, copt, ray_t, n_steps, None)
    mc = kernels.cuvol_march(*C._k10_args(mchunk, dens, sh), None, checkpoints=True)
    g_rgb10 = (2.0 * (mc["rgb"] - 0.5) / (3 * B)).contiguous()

    def k10b(want):
        return kernels.cuvol_march_backward(*C._k10_args(mchunk, dens, sh), mc["log_T"],
                                            mc["ckpt"], g_rgb10, want_sh_mult=want)

    ms0, ms1 = time_ms(lambda: k10b(False), 5), time_ms(lambda: k10b(True), 5)
    log(f"K10 backward on the chunk: {ms0:.4f} ms without the sh_mult output, {ms1:.4f} ms with "
        f"it [{card}]")
    del cg, chunk, cpool, fk, mchunk, mc
    torch.cuda.empty_cache()
    for name, r in res.items():
        log(f"time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound'][0]:.5f} ms ({r['bound'][1]}) [{card}]")
    return res


def basis(device, card: str, work: Path) -> tuple[dict, dict]:
    """Phase 12: the learned bases. The kernel checks (check_basis_kernels);
    a surface step with the texture against the plain step on a CPU copy at
    128^3; then, each with the counters set to 0 just before and read just
    after: bench_step's protocol (512^3, batch 40960, 1 + 33 steps) with
    each basis and the cuvol step at 256^3 with the texture, at lr_basis and
    lambda_tv_basis 1e-2 (rays/s, finite losses, basis rows moved); then
    two 800x800 frames through app/render_circle from a saved 512^3 shell
    checkpoint with each basis beside the SH one (before them, the MLP on
    the card against float64, check_mlp_basis): the texture's frames (the
    SH init on a 32^3 cube) within BASIS_TEX_MAX / BASIS_TEX_MEAN of the SH
    frames, the MLP's finite and not flat. Returns the numbers of K12g and
    K5b's and K8's basis variants and their launches from the bench runs."""
    import numpy as np
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.app import bench_step, render_circle
    from alphasurf_torch.utils.io import save_grid
    from alphasurf_torch.utils.png import read_png

    t_phase = time.perf_counter()
    res = check_basis_kernels(device, card)
    check_mlp_basis(device)
    check_step(device, hp_extra=bench_step.BASIS_HP, basis="texture")
    launches = {}
    for stage, b in (("surface", "texture"), ("surface", "mlp"), ("cuvol", "texture")):
        kernels.reset_launches()
        reso = RESO if stage == "surface" else CUVOL_RESO
        out = bench_step.main(["--stage", stage, "--reso", str(reso), "--batch", str(TRAIN_BATCH),
                               "--steps", "33", "--width", str(WIDTH), "--basis", b,
                               "--device", str(device)])
        torch.cuda.synchronize()
        got = dict(kernels.LAUNCHES)
        log(f"bench_step --stage {stage} --basis {b}: {out['steps']} steps of {out['batch']} rays "
            f"at {out['reso']}^3: {out['rays_per_s_fwd_bwd']:.1f} rays/s, "
            f"{out['seconds'] / out['steps'] * 1e3:.3f} ms per step, loss {out['first_loss']:.6f}"
            f" -> {out['last_loss']:.6f}, {out['rows_moved']} rows and {out['basis_moved']} basis "
            f"rows moved [{card}]")
        need = (("backward_entry_basis", "backward_entry", "rmsprop") if stage == "surface"
                else ("cuvol_backward_basis", "cuvol_backward", "rmsprop"))
        need += ("reg_basis_tv",) if b == "texture" else ()
        log("launches " + json.dumps({k: got[k] for k in need}))
        if any(got[k] == 0 for k in need):
            raise AssertionError(f"a kernel of the basis path was not launched: {got}")
        if not (out["losses_finite"] and out["rows_moved"] > 0 and out["basis_moved"] > 0):
            raise AssertionError(f"training with the {b} basis did not run right: {out}")
        for k in need:
            if k in BASIS_KERNELS and k not in launches:
                launches[k] = got[k]

    frames = {}
    for b in ("sh", "texture", "mlp"):
        g, _ = shell_grid(RESO, device)
        ckpt = work / f"basis_{b}.npz"
        save_grid(bench_step.with_basis(g, b), str(ckpt))
        del g
        torch.cuda.empty_cache()
        kernels.reset_launches()
        out = render_circle.main([str(ckpt), "--n_frames", "2", "--width", str(WIDTH), "--height",
                                  str(HEIGHT), "--out_dir", str(work / f"circle_{b}"),
                                  "--device", str(device)])
        torch.cuda.synchronize()
        imgs = [read_png(str(work / f"circle_{b}" / f"{i:04d}.png")) for i in range(2)]
        frames[b] = np.stack(imgs).astype(np.float64) / 255.0
        log(f"render_circle with the {b} basis: ms per frame "
            f"{[round(x * 1e3, 3) for x in out['frame_seconds']]}, frame 0 mean "
            f"{frames[b][0].mean():.4f} std {frames[b][0].std():.4f}; "
            f"{kernels.LAUNCHES['composite']} K4 launches [{card}]")
        if kernels.LAUNCHES["composite"] == 0:
            raise AssertionError(f"serving the {b} checkpoint launched no kernel")
    d = np.abs(frames["texture"] - frames["sh"])
    log(f"texture frames against the SH frames (8-bit PNGs): max {d.max():.5f}, mean "
        f"{d.mean():.6f} (limits {BASIS_TEX_MAX}, {BASIS_TEX_MEAN})")
    if not (d.max() <= BASIS_TEX_MAX and d.mean() <= BASIS_TEX_MEAN):
        raise AssertionError("the texture's frames differ from the SH frames")
    m = frames["mlp"]
    if not (np.isfinite(m).all() and m.std() > 0.01):
        raise AssertionError("the MLP's frames are flat or not finite")
    log(f"basis phase in {time.perf_counter() - t_phase:.1f} s")
    return res, launches


# ---------------------------------------------------------------------------
# the compat marches (K14) and the svox1 export
# ---------------------------------------------------------------------------

COMPAT_OPT = dict(step_size=0.5, sigma_thresh=1e-10)  # RenderOptions' defaults


def compat_work(grid, mode: str, ray_t, step: float, n_steps: int) -> tuple[int, int, int]:
    """(active steps, distinct links, distinct present rows) of a K14 march:
    t = tmin + k step <= tmax; nvol reads the 8 corners of voxel_of's voxel,
    svox1 the truncated voxel itself."""
    import torch

    from alphasurf_torch.ops.trilerp import voxel_of

    origins, dirs, _, _, tmin, tmax = ray_t
    X, Y, Z = grid.reso
    n, seen = 0, []
    for k0 in range(0, n_steps, 16):
        t = tmin[:, None] + torch.arange(k0, k0 + 16, device=tmin.device)[None, :] * step
        act = t <= tmax[:, None]
        if not bool(act.any()):
            break
        n += int(act.sum())
        pos = (origins[:, None, :] + t[..., None] * dirs[:, None, :])[act]
        if mode == "nvol":
            l, _ = voxel_of(pos, grid.reso)
        else:
            hi = torch.tensor([X - 1, Y - 1, Z - 1], device=pos.device)
            l = torch.minimum(torch.clamp(pos.to(torch.int32), min=0), hi)
        l = l.long()
        seen.append(torch.unique((l[:, 0] * Y + l[:, 1]) * Z + l[:, 2]))
    vox = torch.unique(torch.cat(seen))
    if mode == "nvol":
        return (n, *corner_rows(grid, vox))
    return n, vox.numel(), int((grid.links.reshape(-1)[vox] >= 0).sum())


def check_svox1_file(path: Path, grid) -> dict:
    """The N3Tree npz reloaded: its fields, and 4,096 present voxels walked
    from the root, each leaf equal to the voxel's row in float16."""
    import numpy as np

    z = np.load(path)
    child, data = z["child"], z["data"]
    links = grid.links.cpu().numpy()
    L = int(np.log2(links.shape[0]))
    rng = np.random.default_rng(SEED)
    occ = np.argwhere(links >= 0)
    v = occ[rng.choice(len(occ), min(4096, len(occ)), replace=False)]
    node = np.zeros(len(v), np.int64)
    for dpt in range(L - 1):
        bit = (v >> (L - 1 - dpt)) & 1
        step = child[node, bit[:, 0], bit[:, 1], bit[:, 2]]
        if (step == 0).any():
            raise AssertionError("the svox1 tree has no node above a present voxel")
        node = node + step
    bit = v & 1
    leaf = data[node, bit[:, 0], bit[:, 1], bit[:, 2]]
    rows = links[v[:, 0], v[:, 1], v[:, 2]]
    want = np.concatenate([grid.sh_data.detach().cpu().numpy()[rows],
                           grid.density_data.detach().cpu().numpy()[rows]], -1).astype(np.float16)
    if not np.array_equal(leaf, want):
        raise AssertionError("svox1 leaves differ from the grid's rows")
    fields = sorted(z.files)
    if fields != sorted(["child", "data", "data_dim", "data_format", "invradius3", "offset"]):
        raise AssertionError(f"svox1 file fields {fields}")
    return {"n_nodes": int(child.shape[0]), "data_format": str(z["data_format"]),
            "checked": len(v)}


def compat(device, card: str, work: Path) -> tuple[dict, dict]:
    """Phase 13: the compat marches. K14 forward and backward, both modes,
    against their plain versions (the backward through the autograd
    Function against autograd of the plain march, density, SH and the
    per-ray basis, from the cotangents of rgb, depth and acc) on a
    16,384-ray chunk of an 800x800 view of the 256^3 blobby grid, each
    timed (the backward with and without the depth and acc cotangents);
    then, with the counters set to 0 just before and read just after, an
    800x800 frame through volume_render with "nvol" and with "svox1"
    (finite, not flat) and two gradients of a chunk's mse through each, the
    second with cotangents on depth and log_transmit; then to_svox1_npz of
    the 256^3 grid, reloaded and checked. Returns K14's numbers and
    launches."""
    import numpy as np
    import torch

    import alphasurf_torch as pt
    from alphasurf_torch import kernels
    from alphasurf_torch.core.rays import Rays
    from alphasurf_torch.geometry.svox1 import to_svox1_npz
    from alphasurf_torch.render import compat as Cm

    t_phase = time.perf_counter()
    grid, _ = blobby_cuvol_grid(CUVOL_RESO, device)
    opt = pt.RenderOptions(**COMPAT_OPT)
    rays_all = frame_camera(0, 2).gen_rays_device(device)
    s = (WIDTH * HEIGHT) // 2 - CHUNK // 2
    rays = Rays(rays_all.origins[s:s + CHUNK].contiguous(), rays_all.dirs[s:s + CHUNK].contiguous())
    n_steps = Cm.max_steps_for(grid, opt)
    dens, sh = grid.density_data.detach()[:, 0].contiguous(), grid.sh_data.detach()
    res = {}
    for mode in Cm.BACKENDS:
        setup = Cm._march_setup(grid, rays, mode == "svox1")
        origins, dirs, ds, shm, tmin, tmax = setup
        ray_t = tuple(x.detach().contiguous() for x in (origins, dirs, shm, ds, tmin, tmax))
        c = Cm._Compat(mode, grid, opt, ray_t, n_steps)
        plain_fn = Cm._nvol_plain if mode == "nvol" else Cm._svox1_plain

        def plain(shm_in, g=grid):
            rgb, depth, acc = plain_fn(g, opt, origins, dirs, ds, shm_in, tmin, tmax, n_steps)
            bgw = (1.0 - acc) if mode == "nvol" else torch.exp(acc)
            return rgb + bgw[:, None] * opt.background_brightness, depth, acc

        fk = kernels.compat_forward(*Cm._k14_args(c, dens, sh))
        (rgb_p, depth_p, acc_p), plain_fwd_ms = timed_once(lambda: plain(ray_t[2]))
        errs = [allclose_err(fk["rgb"], rgb_p), allclose_err(fk["acc"], acc_p),
                allclose_err(fk["depth"], depth_p, atol=1e-4)]
        if max(e[1] for e in errs) > 0:
            raise AssertionError(f"K14 {mode} forward differs from its plain version: {errs}")
        n_act, n_links, n_rows = compat_work(grid, mode, ray_t, opt.step_size, n_steps)
        log(f"K14 {mode} forward: {CHUNK} rays, {n_act} steps (at most {n_steps} a ray), max abs "
            f"err {max(e[0] for e in errs):.3e}; rgb mean {float(fk['rgb'].mean()):.4f}")
        step_ops = 28 * 8 * 2 + 60 if mode == "nvol" else 60 + 27 * 2
        in_bytes = CHUNK * 72 + n_links * 4 + n_rows * 28 * 4
        res[f"compat_forward_{mode}"] = dict(
            max_abs_err=max(e[0] for e in errs),
            ms=time_ms(lambda: kernels.compat_forward(*Cm._k14_args(c, dens, sh)), 10),
            plain_ms=plain_fwd_ms,
            bound=bound_ms(in_bytes + CHUNK * 20, n_act * step_ops))
        # the backward: density, SH and the per-ray basis as leaves, from
        # the cotangents of rgb, depth and acc. Depth's is scaled by the
        # mean depth, so that no output's part swamps the others' in the
        # gradient; one plain backward holds both instantiations: the
        # second on the whole loss, the rgb-only one (rgb's cotangent
        # alone) plus the second on depth's and acc's alone
        shm_leaf = ray_t[2].clone().requires_grad_(True)
        params = [grid.density_data, grid.sh_data]
        inputs = params + [shm_leaf]
        cot = out_cotangents(CHUNK, device)
        cot = (cot[0] / depth_p.abs().mean().clamp(min=1.0), cot[1])
        for p in params:
            p.requires_grad_(True)
        try:
            outs = Cm._CompatFn.apply(grid.density_data, grid.sh_data, shm_leaf, c)
            c_rgb, c_depth, c_acc = torch.autograd.grad(out_loss(*outs, cot), outs,
                                                        retain_graph=True)
            n0 = {k: kernels.LAUNCHES[f"compat_backward{k}_{mode}"] for k in ("", "_out")}
            g_kernel = torch.autograd.grad(outs, inputs, (c_rgb, c_depth, c_acc),
                                           retain_graph=True)
            g_rgb_part = torch.autograd.grad(outs[0], inputs, c_rgb, retain_graph=True)
            n1 = {k: kernels.LAUNCHES[f"compat_backward{k}_{mode}"] for k in ("", "_out")}
            g_out_part = torch.autograd.grad(outs[1:], inputs, (c_depth, c_acc))
            if (n1[""] - n0[""], n1["_out"] - n0["_out"]) != (2, 1):
                raise AssertionError(f"K14 {mode}: the rgb cotangent alone did not launch the "
                                     "rgb-only instantiation")
            rgb_p, depth_p, acc_p = plain(shm_leaf)
            loss_p = out_loss(rgb_p, depth_p, acc_p, cot)
            # the plain march's backward is timed once: it recomputes every
            # checkpointed step (~14 s for nvol on the H100)
            g_plain, plain_ms = timed_once(lambda: torch.autograd.grad(loss_p, inputs))
            del rgb_p, loss_p, outs
        finally:
            for p in params:
                p.requires_grad_(False)
        groups = ("density", "sh", "sh_mult")
        log(f"K14 {mode} backward: the parts of the kernel's gradient, |g| of rgb's "
            + ", ".join(f"{n} {float(a.norm()):.4e}" for n, a in zip(groups, g_rgb_part))
            + "; of depth's and acc's " + ", ".join(f"{n} {float(a.norm()):.4e}"
                                                     for n, a in zip(groups, g_out_part)))
        log(f"K14 {mode} backward: gradients of the mse against 0.5 and of random cotangents on "
            f"depth and acc, the second instantiation against autograd of the plain march:")
        err_out = max(grad_check(n, a, b, "K14") for n, a, b in zip(groups, g_kernel, g_plain))
        log(f"K14 {mode} backward: the rgb-only instantiation (rgb's cotangent) plus the second "
            f"on depth's and acc's, against the same:")
        err = max(grad_check(n, a + o, b, "K14") for n, a, o, b in
                  zip(groups, g_rgb_part, g_out_part, g_plain))
        g_rgb = (2.0 * (fk["rgb"] - 0.5) / (3 * CHUNK)).contiguous()
        b_bytes = in_bytes + CHUNK * 12 + grid.capacity * 28 * 4 + CHUNK * 9 * 4
        ms_rgb, ms_out = (time_ms(lambda: kernels.compat_backward(
            *Cm._k14_args(c, dens, sh), g_rgb, want_sh_mult=True, **kw), 5)
            for kw in ({}, dict(g_depth=cot[0], g_acc=cot[1])))
        log(f"K14 {mode} backward timed alone: rgb only {ms_rgb:.4f} ms, with the depth and acc "
            f"cotangents {ms_out:.4f} ms [{card}]")
        res[f"compat_backward_{mode}"] = dict(
            max_abs_err=err, ms=ms_rgb, plain_ms=plain_ms,
            bound=bound_ms(b_bytes, n_act * step_ops * 3))
        res[f"compat_backward_out_{mode}"] = dict(
            max_abs_err=err_out, ms=ms_out, plain_ms=plain_ms,
            bound=bound_ms(b_bytes + CHUNK * 8, n_act * (step_ops * 3 + 2)))
        del g_kernel, g_plain, g_rgb_part, g_out_part, shm_leaf
        torch.cuda.empty_cache()
    for name, r in res.items():
        log(f"time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound'][0]:.5f} ms ({r['bound'][1]}) [{card}]")

    # the path: a frame and a gradient through volume_render in each mode
    kernels.reset_launches()
    for mode in Cm.BACKENDS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = pt.volume_render(grid, rays_all, opt, mode)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        img = out["rgb"].reshape(HEIGHT, WIDTH, 3).cpu().numpy()
        log(f"volume_render {mode}: one {WIDTH}x{HEIGHT} frame in {ms:.3f} ms, mean "
            f"{img.mean():.4f} std {img.std():.4f} [{card}]")
        if not (np.isfinite(img).all() and img.std() > 0.01):
            raise AssertionError(f"the {mode} frame is flat or not finite")
        params = [grid.density_data, grid.sh_data]
        for p in params:
            p.requires_grad_(True)
        cot = out_cotangents(CHUNK, device)
        try:
            # rgb's cotangent alone, then with depth's and log_transmit's
            for c_ in (None, cot):
                o = pt.volume_render(grid, rays, opt, mode)
                g = torch.autograd.grad(out_loss(o["rgb"], o["depth"], o["log_transmit"], c_),
                                        params)
                if not all(bool(torch.isfinite(x).all()) and float(x.abs().max()) > 0 for x in g):
                    raise AssertionError(f"the {mode} gradient is zero or not finite")
        finally:
            for p in params:
                p.requires_grad_(False)
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in COMPAT_KERNELS}
    log("launches " + json.dumps(launches))
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the compat path was not launched: {launches}")

    # the export of the grid's shell (its links of positive density, as a
    # trained grid is pruned): every sphere-bound link would make a 0.5 GB
    # compressed write of ~40 s
    with torch.no_grad():
        shell = grid.replace(links=torch.where(
            (grid.links >= 0) & (grid.density_data[:, 0].clamp(min=0)[grid.links.clamp(min=0)
                                                                      .long()] > 0),
            grid.links, torch.full_like(grid.links, -1)))
    t0 = time.perf_counter()
    path = work / "svox1.npz"
    info = to_svox1_npz(shell, str(path))
    t_write = time.perf_counter() - t0
    chk = check_svox1_file(path, shell)
    log(f"to_svox1_npz {CUVOL_RESO}^3, the shell's {int((shell.links >= 0).sum())} links of "
        f"{grid.capacity}: {info['n_nodes']} nodes, "
        f"data_dim {info['data_dim']}, {path.stat().st_size / 2**20:.1f} MiB in {t_write:.2f} s; "
        f"reloaded, format {chk['data_format']}, {chk['checked']} voxels walked from the root equal")
    if chk["n_nodes"] != info["n_nodes"]:
        raise AssertionError("the svox1 file's node count differs")
    log(f"compat phase in {time.perf_counter() - t_phase:.1f} s")
    return res, launches


# ---------------------------------------------------------------------------
# the other surface types: PLANE, UDF, UDF_ALPHA, UDF_FAKE_SAMPLE, VOXEL_FACE
# ---------------------------------------------------------------------------

TYPES_RESO = 256  # the recipe's surface-stage width, and the dtu, blender and tnt cells'
# name: (Config's surface_type, initialiser, render options of the checks and
# steps): the JAX package's tests/test_trainability_types.py and
# test_surface_init.py choices; the base options are the trainability test's
SURFACE_TYPES = {
    "plane": ("plane", "sphere", {}),
    "udf": ("udf", "single_lv", {}),
    "udf_alpha": ("udf_alpha", "single_lv", dict(surf_fake_sample=True,
                                                 limited_fake_sample=True)),
    "udf_fake_sample": ("udf_fake_sample", "single_lv_multi_sphere",
                        dict(surf_fake_sample=True)),
    "voxel_face": ("voxel_face", None, {}),
}
TYPE_BASE_OPT = dict(sigma_thresh=-1e9, stop_thresh=1e-7)
# The alpha gates, held at the Config's sigma_thresh on grids whose alphas
# lie on both sides of it (gate_grid): UDF_ALPHA with GATE_LEVEL_SETS level
# sets (past K5b's per-warp table of 64) and every third table row below the
# threshold, UDF_FAKE_SAMPLE with raw alpha uniform in [-3, 1]. These pools
# are several times the main grids' a ray, so their chunk is GATE_RAYS.
GATE_SIGMA = 1e-8
GATE_LEVEL_SETS = 66
GATE_RAYS = 2048
# K1-K5 branch of each type against its plain version, both float32 on the
# card: K1 equal (the same comparisons; softplus in torch.logaddexp's
# arithmetic); K3 and K5 to check_kernels' RTOL/ATOL and GRAD_* (the same
# per-entry arithmetic; sums in other orders). K6's one-row table: every
# cell of the window adds to UDF_ALPHA's single alpha, ~88k float32 terms
# summed per warp and then by atomics in any order against autograd's
# reduction, so its gradient holds to TABLE_REL of its size.
TABLE_REL = 1e-4
# Where a ray grazes a level set the cubic has a near-double root, whose
# float32 position moves with the last bits of its coefficients: at most
# ROOT_FRACTION of a type's K3 values may differ beyond RTOL/ATOL (1 of
# 104k rgb values of UDF_FAKE_SAMPLE's nested spheres in a host build of
# phase_b.cu against the plain version on the CPU).
ROOT_FRACTION = 1e-4
TYPE_STEPS = 33  # bench.py's protocol: 1 + 33 steps of TRAIN_BATCH rays
UDF_RUN_STEPS = (40, 20)  # the UDF Trainer run: warm start, UDF stage


def type_grid(name: str, device, seed: int = SEED):
    """create_grid(256, surface_type, initialiser, use_sphere_bound,
    basis_dim 9) of ``name``, SH drawn from ``seed`` (0.3 N(0, 1)), raw
    alpha uniform in [0.5, 3] (UDF_ALPHA's one-per-level-set table at 1.0),
    and a fake_sample_std of 0.3 where the type's options take fake
    samples."""
    import torch

    from alphasurf_torch import defs
    from alphasurf_torch.core.grid import create_grid

    stype, init, opts = SURFACE_TYPES[name]
    grid = create_grid(TYPES_RESO, surface_type=defs.SURFACE_TYPE_STRS[stype], surface_init=init,
                       use_sphere_bound=True, basis_dim=9, device=device,
                       trainable_fake_sample_std=bool(opts.get("surf_fake_sample")))
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        grid.sh_data.copy_(0.3 * torch.randn(grid.sh_data.shape, generator=gen, device=device))
        if name == "udf_alpha":
            grid.density_data.fill_(1.0)
        else:
            grid.density_data.uniform_(0.5, 3.0, generator=gen)
        if grid.fake_sample_std is not None:
            grid.fake_sample_std.fill_(0.3)
    return grid


def type_options(name: str):
    from alphasurf_torch.core.options import RenderOptions

    return RenderOptions(**TYPE_BASE_OPT, **SURFACE_TYPES[name][2])


def gate_grid(name: str, grid):
    """``grid`` with alphas on both sides of GATE_SIGMA: UDF_ALPHA's
    GATE_LEVEL_SETS level sets 0.25 apart around its own, each third row of
    their table at -1 and the others at 1; UDF_FAKE_SAMPLE's raw alpha
    uniform in [-3, 1]."""
    import torch

    dev = grid.links.device
    if name == "udf_alpha":
        i = torch.arange(GATE_LEVEL_SETS, device=dev)
        lv = grid.level_set_data[0] + 0.25 * (i - GATE_LEVEL_SETS // 2).float()
        table = torch.where(i % 3 == 1, -1.0, 1.0).float()[:, None]
        return grid.replace(level_set_data=lv, density_data=table)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dens = torch.empty_like(grid.density_data).uniform_(-3.0, 1.0, generator=gen)
    return grid.replace(density_data=dens)


def check_type_kernels(name: str, grid, card: str, opt=None, n_rays: int = CHUNK,
                       timed: bool = True) -> dict:
    """The type's branches of K1, K3, K4's input, K5 (and, for UDF_ALPHA,
    K6 on its table) against their plain versions on an ``n_rays`` chunk of
    an 800x800 frame at ``opt`` (type_options by default), each timed.
    Returns the variants' numbers, or with ``timed`` off their errors."""
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.core.rays import Rays
    from alphasurf_torch.render import surface as S

    opt = type_options(name) if opt is None else opt
    R = TYPES_RESO
    # K1
    words = S.occupancy_words(grid, opt)
    ref = S._occupancy_words_plain(grid, opt)
    if not torch.equal(words, ref):
        raise AssertionError(f"K1 ({name}) occupancy words differ from the plain version")
    n_occ = int(S.unpack_occupancy_bits(words, R - 1).sum())
    log(f"K1 {name}: words equal at {R}^3 at sigma_thresh {opt.sigma_thresh:g}, {n_occ} "
        "occupied voxels")
    errs_out = {f"occupancy_{name}": 0.0}
    if timed:
        ms1 = time_ms(lambda: S.occupancy_words(grid, opt), 20)
        pms1 = time_ms(lambda: S._occupancy_words_plain(grid, opt), 3)
        # the bytes the function needs: links, the density (UDF_ALPHA's one
        # value), the surface rows only under the hull test, the words
        n_dens = 1 if name == "udf_alpha" else grid.capacity
        n_surf = grid.capacity if S._hull_test(grid, opt) else 0
        nb1 = (grid.links.numel() + n_dens + n_surf + words.numel()) * 4
        res = {f"occupancy_{name}": dict(max_abs_err=0.0, ms=ms1, plain_ms=pms1,
                                         bound=bound_ms(nb1, (R - 1) ** 3 * 40))}
        log(f"  {ms1:.4f} ms, plain {pms1:.3f} ms")

    # the chunk's pool (K2) and K3
    rays_all = frame_camera(0, 2).gen_rays_device(grid.links.device)
    s = (WIDTH * HEIGHT) // 2 - n_rays // 2
    rays = Rays(rays_all.origins[s:s + n_rays].contiguous(),
                rays_all.dirs[s:s + n_rays].contiguous())
    origins, dirs, sh_mult, tn, tx, ngt = chunk_inputs(grid, opt, rays)
    pool = check_phase_a(grid, words, origins, dirs, tn, tx, f"{name}, {R}^3")
    B, M = origins.shape[0], pool.close_t.shape[0]
    packed = S.pack_grid_data(grid)
    spec, fss = S._surface_spec(grid), S._fss(grid)

    def k3():
        return kernels.phase_b(pool.ray_id, pool.l, pool.close_t, pool.far_t, origins, dirs,
                               sh_mult, grid.links, packed, spec, grid.level_set_data, ngt, fss,
                               opt)

    sk = k3()
    sp = S._voxel_samples_plain(grid, opt, pool, origins, dirs, sh_mult, ngt, packed)
    S0 = sk["n_slots"]
    if S0 != sp["n_slots"] or (name in ("plane", "voxel_face")) != (S0 == 1):
        raise AssertionError(f"K3 ({name}): {S0} slots, the plain version {sp['n_slots']}")
    flips = sum(int((sk[k] != sp[k]).sum()) for k in ("contrib", "fake", "counted"))
    if flips > FLAG_FRACTION * sp["contrib"].numel():
        raise AssertionError(f"K3 ({name}): {flips} slot flags differ from the plain version")
    live = sp["contrib"] | (sp["counted"] > 0)
    errs = [allclose_err(sk["t"][live], sp["t"][live], rtol=1e-5, atol=1e-4)]
    errs += [allclose_err(sk[k], sp[k]) for k in ("alpha", "rgb", "snorm")]
    errs += [allclose_err(sk["loss_e"], sp["loss_e"], rtol=1e-4, atol=1e-4)]
    if sk["loss_e"].shape != sp["loss_e"].shape or max(e[1] for e in errs) > ROOT_FRACTION:
        raise AssertionError(f"K3 ({name}) values differ from the plain version: {errs}")
    k3_err = max(e[0] for e in errs)
    lk = torch.unique(torch.stack([
        ((torch.clamp(pool.l[:, 0].long() + dx, max=R - 1) * R
          + torch.clamp(pool.l[:, 1].long() + dy, max=R - 1)) * R
         + torch.clamp(pool.l[:, 2].long() + dz, max=R - 1))
        for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]))
    n_rows = int((grid.links.reshape(-1)[lk] >= 0).sum())
    n_le = sk["loss_e"].shape[0]
    nb3 = M * 24 + B * (24 + 36) + lk.numel() * 4 + n_rows * packed.shape[1] * 4 + S0 * M * 38 \
        + n_le * M * 4
    ops3 = M * (48 * grid.basis_dim + 60 + S0 * 200)
    errs_out[f"phase_b_{name}"] = k3_err
    if timed:
        ms3 = time_ms(k3, 20)
        pms3 = time_ms(lambda: S._voxel_samples_plain(grid, opt, pool, origins, dirs, sh_mult,
                                                      ngt, packed), 3)
        res[f"phase_b_{name}"] = dict(max_abs_err=k3_err, ms=ms3, plain_ms=pms3,
                                      bound=bound_ms(nb3, ops3))
    # K4 on the type's slots (S0 = 1 for PLANE and VOXEL_FACE; 5 loss rows for the UDF types)
    smp = {k: sp[k].contiguous() for k in ("t", "alpha", "contrib", "fake", "counted", "rgb",
                                           "snorm", "loss_e")}
    ck = kernels.composite(pool.offsets, smp, grid.truncated_vol_render_a, opt)
    cp = S._composite_plain(opt, grid.truncated_vol_render_a, pool.offsets, sp)
    e4 = [allclose_err(ck[k], cp[k]) for k in ("rgb", "log_T")]
    e4 += [allclose_err(ck["ray_losses"], cp["ray_losses"], rtol=1e-4, atol=1e-4)]
    if not torch.equal(ck["n_intersections"], cp["n_intersections"]) or max(e[1] for e in e4) > 0:
        raise AssertionError(f"K4 on the {name} slots differs from the plain version: {e4}")
    log(f"K3 {name}: {M} entries x {S0} slots, {n_le} loss rows, {flips} flag flips, "
        f"{int(sp['contrib'].sum())} contributing, max abs err {k3_err:.3e}; K4 on its slots max "
        f"abs err {max(e[0] for e in e4):.3e}"
        + (f"; {ms3:.4f} ms, plain {pms3:.3f} ms" if timed else ""))

    # K5: the gradients through the kernels against autograd of the plain path
    names = ("density", "surface", "sh", "fake_sample_std")
    params = [p for p in (grid.density_data, grid.surface_data, grid.sh_data,
                          grid.fake_sample_std) if p is not None]
    lam = torch.tensor([K5_LAMBDAS.get(k, 0.0) + (1e-3 if k == "udf_var_sum" else 0.0)
                        for k in S._RAY_LOSS_KEYS], dtype=torch.float32, device=origins.device)

    def loss_of(rgb, rl):
        return torch.mean((rgb - 0.5) ** 2) + torch.sum(lam * rl.mean(dim=1))

    for p in params:
        p.requires_grad_(True)
    try:
        out = S.volume_render_surface_packed(grid, rays, opt, occupancy=words, packed=packed)
        rl_k = torch.stack([out["ray_losses"][k] for k in S._RAY_LOSS_KEYS])
        g_kernel = torch.autograd.grad(loss_of(out["rgb"], rl_k), params)
        comp = S._render_plain(grid, opt, pool, origins, dirs, sh_mult, ngt, S.pack_grid_data(grid))
        loss_p = loss_of(comp["rgb"], comp["ray_losses"])
        g_plain = torch.autograd.grad(loss_p, params, retain_graph=True)
        if timed:
            pms5 = time_ms(lambda: torch.autograd.grad(loss_p, params, retain_graph=True), 2)
        del comp, loss_p, out
    finally:
        for p in params:
            p.requires_grad_(False)
    log(f"K5 {name}: gradients over {B} rays, kernels against autograd of the plain path:")
    e5 = max(grad_check(f"{name} {n}", a, b) for n, a, b in zip(names, g_kernel, g_plain))
    del g_kernel, g_plain
    comp_k = kernels.composite(pool.offsets, sk, grid.truncated_vol_render_a, opt)
    g_rgb = (2.0 * (comp_k["rgb"] - 0.5) / (3 * B)).contiguous()
    g_rl = (lam[:, None] / B).expand(12, B).contiguous()
    d_alpha, d_t, d_col = kernels.backward_ray(pool.offsets, sk, grid.truncated_vol_render_a, opt,
                                               g_rgb, g_rl)

    def k5b():
        return kernels.backward_entry(pool.ray_id, pool.l, pool.close_t, pool.far_t, origins,
                                      dirs, sh_mult, grid.links, packed, spec,
                                      grid.level_set_data, ngt, fss, opt, sk["contrib"], d_alpha,
                                      d_t, d_col, g_rl)

    errs_out[f"backward_entry_{name}"] = e5
    if timed:
        ms5 = time_ms(k5b, 10)
        # the gradients written: density (UDF_ALPHA's n_lv table rows),
        # surface and SH rows
        nb5 = M * 24 + B * 60 + lk.numel() * 4 + n_rows * packed.shape[1] * 4 + S0 * M * 21 \
            + B * 8 + (grid.density_data.numel() + grid.surface_data.numel()
                       + grid.sh_data.numel()) * 4
        res[f"backward_entry_{name}"] = dict(max_abs_err=e5, ms=ms5, plain_ms=pms5,
                                             bound=bound_ms(nb5, 2 * ops3))
        log(f"K5b {name}: {ms5:.4f} ms, the plain backward {pms5:.3f} ms")
    del pool, sk, sp, smp, packed, words, ref
    torch.cuda.empty_cache()
    if name == "udf_alpha":
        table = check_table_reg(grid)
        if not timed:
            return {**errs_out, **{k: v["max_abs_err"] for k, v in table.items()}}
        res.update(table)
    return res if timed else errs_out


def type_chunk(grid):
    """The centre 16,384-ray chunk of orbit frame 0."""
    from alphasurf_torch.core.rays import Rays

    rays_all = frame_camera(0, 2).gen_rays_device(grid.links.device)
    s = (WIDTH * HEIGHT) // 2 - CHUNK // 2
    return Rays(rays_all.origins[s:s + CHUNK].contiguous(), rays_all.dirs[s:s + CHUNK].contiguous())


def check_type_out(name: str, grid, card: str) -> dict:
    """K5 with every output cotangent on the type's chunk through the
    packed renderer (check_output_grads; its branch of K5b's second
    instantiation: PLANE's mean plane, the UDF types' softplus corners)
    against autograd of the plain renderer under GRAD_*; then that branch
    timed alone beside the rgb-only one."""
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.render import surface as S

    opt = type_options(name)
    rays = type_chunk(grid)
    words = S.occupancy_words(grid, opt)
    packed = S.pack_grid_data(grid)
    chk = check_output_grads(f"K5 outputs, {name}", grid, opt, rays, "packed", words, packed)
    # the branch timed on the arguments the renderer passed it, with and
    # without the normal's cotangent
    a, kw = chk["calls"]["backward_entry"]
    ms_rgb = time_ms(lambda: kernels.backward_entry(*a, **dict(kw, d_snorm=None)), 10)
    ms_out = time_ms(lambda: kernels.backward_entry(*a, **kw), 10)
    log(f"K5b {name} timed alone: rgb only {ms_rgb:.4f} ms, with the normal's cotangent "
        f"{ms_out:.4f} ms [{card}]")
    pool = chk["pool"]
    B, S0 = rays.origins.shape[0], kw["d_snorm"].shape[1]
    nb, ops = k5b_work(grid, pool, packed, B, S0, normal=True)
    res = {f"backward_entry_out_{name}": dict(max_abs_err=chk["err"], ms=ms_out,
                                              plain_ms=chk["plain_ms"], bound=bound_ms(nb, ops))}
    del chk, a, kw, packed, words
    torch.cuda.empty_cache()
    return res


def type_out_path(name: str, grid, card: str) -> None:
    """A chunk's gradient through the packed renderer with every output
    cotangent on the type's grid (the path to its branch of K5b's second
    instantiation); finite and non-zero."""
    import torch

    from alphasurf_torch.render import surface as S

    opt = type_options(name)
    params = [p for p in (grid.density_data, grid.surface_data, grid.sh_data,
                          grid.fake_sample_std) if p is not None]
    for p in params:
        p.requires_grad_(True)
    try:
        out = S.volume_render_surface_packed(grid, type_chunk(grid), opt,
                                             return_intersections=True,
                                             depth_sigma_thresh=SIG_THRESH)
        g = torch.autograd.grad(every_output_loss(out, out_weights(out), {},
                                                  out["intersections"]["mask"]), params)
    finally:
        for p in params:
            p.requires_grad_(False)
    if not all(bool(torch.isfinite(x).all()) for x in g) or not bool((g[1] != 0).any()):
        raise AssertionError(f"{name}: a gradient with every output cotangent is not finite, or "
                             "does not reach the surface")
    log(f"{name}: a {CHUNK}-ray chunk's gradient with every output cotangent through the packed "
        f"renderer [{card}]")


def check_table_reg(grid) -> dict:
    """K6 on UDF_ALPHA's (n_lv, 1) density table, on a window of 0.01 of
    the rows: the TV of the density (every link past the table reads its
    last row; logged, its error within reg_tv's) and the sparsifier (every
    such cell's gradient on the last row), each against its plain
    version."""
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.losses import reg as R

    rc = R.row_coords_of(grid)
    cells = R.sample_present_cells(torch.Generator().manual_seed(SEED), grid, rc, 0.01)
    n, L = cells.numel(), grid.links
    rows = grid.density_data.shape[0]
    log(f"K6 on UDF_ALPHA's {rows}-row density table, a window of {n} cells:")
    e_tv, ms_tv, pms_tv = reg_check(
        "TV of the table",
        lambda: kernels.reg_tv(L, cells, grid.density_data.detach(), 0, 1, None, 1.0 / n),
        lambda: R._tv_plain(grid, grid.density_data, cells, 0, 1, None, 1.0 / n), grid,
        ("density_data",))
    e_sp, ms_sp, pms_sp = reg_check(
        "sparsify with the table",
        lambda: kernels.reg_sparsify(L, cells, grid.density_data.detach(),
                                     grid.surface_data.detach(), 1.0, 1.0, True, 0.15, 1.0 / n),
        lambda: R._sparsify_plain(grid, cells, 1.0, 1.0, True, 0.15), grid,
        ("density_data", "surface_data"), rel=TABLE_REL)
    cb, nr = window_stats(grid, cells, ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)))
    log(f"  TV of the table: {ms_tv:.4f} ms (bound {bound_ms(cb + rows * 8, n * 20)[0]:.5f} ms), "
        f"plain {pms_tv:.3f} ms, max abs err {e_tv:.3e}")
    return {
        "reg_sparsify_table": dict(max_abs_err=e_sp, ms=ms_sp, plain_ms=pms_sp,
                                   bound=bound_ms(cells.numel() * 8 + nr * 4 + rows * 8
                                                  + grid.capacity * 4, n * 30)),
    }


def check_gates(name: str, grid, card: str, res: dict) -> None:
    """The type's K1, K3, K5 (and K6) checks again at the Config's
    sigma_thresh on gate_grid's alphas, on a GATE_RAYS chunk, their errors
    joined to ``res``; for UDF_ALPHA also K1 with every table row below the
    threshold (no voxel occupied)."""
    import torch

    from alphasurf_torch.core.options import RenderOptions
    from alphasurf_torch.render import surface as S

    opt = RenderOptions(**{**TYPE_BASE_OPT, "sigma_thresh": GATE_SIGMA}, **SURFACE_TYPES[name][2])
    gated = gate_grid(name, grid)
    log(f"{name} at sigma_thresh {GATE_SIGMA:g}: {gated.level_set_data.numel()} level sets, "
        f"{int((gated.density_data > GATE_SIGMA).sum())} of {gated.density_data.numel()} alphas "
        "above it")
    for k, e in check_type_kernels(name, gated, card, opt, GATE_RAYS, timed=False).items():
        res[k]["max_abs_err"] = max(res[k]["max_abs_err"], e)
    if name == "udf_alpha":
        low = gated.replace(density_data=-gated.density_data.abs())
        words = S.occupancy_words(low, opt)
        if not (torch.equal(words, S._occupancy_words_plain(low, opt)) and not bool(words.any())):
            raise AssertionError("K1 (udf_alpha) with the table below sigma_thresh occupied voxels")
        log("K1 udf_alpha: no voxel occupied with every table row below sigma_thresh")
    del gated
    torch.cuda.empty_cache()


def type_hparams(name: str):
    """The JAX trainability test's HParams (PLANE's surface rate 0), with
    the udf-var loss and fake_sample_std's rate added."""
    from alphasurf_torch.train.steps import HParams

    return HParams(lr_alpha=1e-2, lr_surface=0.0 if name == "plane" else 1e-3, lr_sh=1e-2,
                   lambda_tv_alpha=1e-6, lambda_tv_surface=1e-6, lambda_udf_var=1e-2,
                   lr_fake_sample_std=1e-3)


def type_steps(name: str, grid, card: str) -> dict:
    """bench.py's protocol on the type's grid through make_surface_step:
    1 + 33 steps of 40960 rays of bench_step's 800x800 camera against a
    grey image, the occupancy refreshed every 16 steps, the present-cell
    windows of the Trainer; finite losses, falling. Returns its numbers."""
    import math

    import torch

    from alphasurf_torch.app import bench_step
    from alphasurf_torch.core.rays import Rays
    from alphasurf_torch.losses import reg as R
    from alphasurf_torch.render.surface import occupancy_words
    from alphasurf_torch.train.steps import StepConfig, init_rms, make_surface_step

    opt = type_options(name)
    step = make_surface_step(StepConfig(opt=opt, cache_size=None))
    hp = type_hparams(name)
    rays = bench_step.bench_rays(WIDTH, grid.links.device)
    rms, gen, rc = init_rms(grid), torch.Generator().manual_seed(SEED), R.row_coords_of(grid)
    gt = torch.full((TRAIN_BATCH, 3), 0.5, device=grid.links.device)
    n = rays.origins.shape[0]
    lo, span = int(n * 0.35), max(int(n * 0.30) - TRAIN_BATCH, 1)
    occ = occupancy_words(grid, opt)

    def batch(i):
        s = lo + (i * TRAIN_BATCH) % span
        return Rays(rays.origins[s:s + TRAIN_BATCH], rays.dirs[s:s + TRAIN_BATCH])

    losses = [step(grid, rms, batch(0), gt, hp, gen, occ=occ, row_coords=rc)[2]["loss"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TYPE_STEPS):
        if i > 0 and i % 16 == 0:
            occ = occupancy_words(grid, opt)
        losses.append(step(grid, rms, batch(i), gt, hp, gen, occ=occ, row_coords=rc)[2]["loss"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    losses = torch.stack(losses).tolist()
    rate = TYPE_STEPS * TRAIN_BATCH / secs
    log(f"train {name}: {TYPE_STEPS} steps of {TRAIN_BATCH} rays at {TYPES_RESO}^3: {rate:.1f} "
        f"rays/s, {secs / TYPE_STEPS * 1e3:.3f} ms per step, loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f} [{card}]")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"the {name} step did not train: {losses}")
    return {"rays_per_s": rate, "loss": (losses[0], losses[-1])}


def serve_type(name: str, grid, work: Path, card: str) -> dict:
    """Two 800x800 orbit frames of the type's checkpoint through
    app/render_circle.main: ms per frame, rays/s, finite frames that are
    not flat."""
    import numpy as np
    import torch

    from alphasurf_torch.app import render_circle
    from alphasurf_torch.utils.io import save_grid
    from alphasurf_torch.utils.png import read_png

    ckpt = work / f"type_{name}.npz"
    save_grid(grid, str(ckpt))
    out = render_circle.main([str(ckpt), "--n_frames", "2", "--width", str(WIDTH), "--height",
                              str(HEIGHT), "--out_dir", str(work / f"circle_{name}"), "--device",
                              str(grid.links.device)])
    torch.cuda.synchronize()
    ckpt.unlink()
    img = read_png(str(work / f"circle_{name}" / "0000.png")).astype(np.float64) / 255.0
    ms = [x * 1e3 for x in out["frame_seconds"]]
    log(f"render_circle {name}: ms per frame {[round(x, 3) for x in ms]}, "
        f"{WIDTH * HEIGHT / (ms[-1] / 1e3):.1f} rays/s, frame 0 mean {img.mean():.4f} std "
        f"{img.std():.4f} [{card}]")
    if not (np.isfinite(img).all() and img.std() > 0.01):
        raise AssertionError(f"the {name} frame is flat or not finite")
    return {"ms_per_frame": ms}


def udf_config(steps=UDF_RUN_STEPS) -> str:
    """train_udf.sh's shape: stages_config cut to its 256^3 warm start and
    a 256^3 surface stage with surface_type udf (the density -> surface
    transition at the stage boundary, then grid.replace(surface_type=udf)),
    the udf-var loss on. The init's surface is (density - zero_lv_density)
    and its level sets (levels - zero_lv_density), both divided by the
    field's mean gradient norm: at the default, the middle level, one
    level set is 0 and one below it, which no softplus of a UDF value
    reaches (no voxel is occupied). zero_lv_density -1e4 puts both far
    into softplus's linear range, so the UDF stage starts from the surfaces
    of the SDF run's density levels (2, 6)."""
    n0, n1 = steps
    keys = dict(line.split(" = ", 1) for line in stages_config((n0, n1, 0)).splitlines())
    keys.update({"reso": f"[[{TYPES_RESO}, {TYPES_RESO}, {TYPES_RESO}], [{TYPES_RESO}, "
                         f"{TYPES_RESO}, {TYPES_RESO}]]",
                 "surface_type": "udf", "n_iters": n0 + n1, "lambda_udf_var_loss": "1.0e-3",
                 "zero_lv_density": "-10000.0", "log_pts": "False", "eval_cf": "False"})
    return "".join(f"{k} = {v}\n" for k, v in keys.items())


def udf_trainer_run(device, card: str, work: Path) -> dict:
    """app/train.main with surface_type udf after a cuvol warm start on the
    synthetic dataset at 256^3 (udf_config): the UDF branches launched,
    finite mse, and an eval PSNR above the untrained grid's."""
    import torch

    from alphasurf_torch import kernels
    from alphasurf_torch.app import train as train_app
    from alphasurf_torch.data import SyntheticDataset

    cfg_path = work / "udf.yaml"
    cfg_path.write_text(udf_config())
    kernels.reset_launches()
    t0 = time.perf_counter()
    psnr = train_app.main(["", "-t", str(work / "udf"), "-c", str(cfg_path), "--device",
                           str(device)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    need = ("occupancy_udf", "phase_b_udf", "backward_entry_udf", "density_occupancy",
            "cuvol_backward", "prune_mask", "visibility")
    got = {k: kernels.LAUNCHES[k] for k in need}
    dset_test = SyntheticDataset(split="test", n_images=2, width=WIDTH, height=HEIGHT,
                                 reso=SMALL_RESO, renderer="packed", device=device)
    psnr0 = eval_untrained(device, dset_test)
    log(f"UDF Trainer run through app/train.main: {UDF_RUN_STEPS[0]} warm-start + "
        f"{UDF_RUN_STEPS[1]} UDF steps at {TYPES_RESO}^3 in {wall:.2f} s, eval PSNR {psnr:.4f} "
        f"against the untrained grid's {psnr0:.4f} [{card}]")
    log("launches " + json.dumps(got))
    if any(v == 0 for v in got.values()):
        raise AssertionError(f"a kernel of the UDF run was not launched: {got}")
    if not psnr > psnr0:
        raise AssertionError(f"the UDF run did not train: PSNR {psnr} <= untrained {psnr0}")
    return {"psnr": psnr, "psnr_untrained": psnr0, "wall": wall}


def types(device, card: str, work: Path) -> tuple[dict, dict]:
    """Phase 14: the other surface types. For each of PLANE, UDF,
    UDF_ALPHA, UDF_FAKE_SAMPLE and VOXEL_FACE at 256^3 (type_grid): its
    branches of K1, K3, K5b (and K6 on UDF_ALPHA's table) against their
    plain versions (check_type_kernels); then, with the counters set to 0
    just before and read just after, two 800x800 frames through
    app/render_circle (serve_type) and bench.py's protocol through
    make_surface_step (type_steps); then the UDF Trainer run. Returns the
    variants' numbers and their launches in the serving and training runs."""
    import torch

    from alphasurf_torch import kernels

    t_phase = time.perf_counter()
    res, launches = {}, {}
    for name in SURFACE_TYPES:
        t0 = time.perf_counter()
        grid = type_grid(name, device)
        log(f"type {name}: {grid.reso} grid, capacity {grid.capacity}, "
            f"{grid.level_set_data.numel()} level sets, surface rows {grid.surface_data.shape[1]} "
            f"wide, built in {time.perf_counter() - t0:.1f} s")
        res.update(check_type_kernels(name, grid, card))
        if name in ("udf_alpha", "udf_fake_sample"):
            check_gates(name, grid, card, res)
        if name in OUT_TYPES:
            res.update(check_type_out(name, grid, card))
        kernels.reset_launches()
        serve_type(name, grid, work, card)
        type_steps(name, grid, card)
        if name in OUT_TYPES:
            type_out_path(name, grid, card)
        got = {k: kernels.LAUNCHES[k] for k in KERNELS if k.endswith(f"_{name}")}
        if name == "udf_alpha":
            got["reg_sparsify_table"] = kernels.LAUNCHES["reg_sparsify_table"]
        log(f"launches ({name}, serving and training) " + json.dumps(got))
        if any(v == 0 for v in got.values()):
            raise AssertionError(f"a kernel branch of {name} was not launched: {got}")
        launches.update(got)
        del grid
        torch.cuda.empty_cache()
    udf_trainer_run(device, card, work)
    log(f"types phase in {time.perf_counter() - t_phase:.1f} s")
    return res, launches


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke test of the PyTorch/CUDA port on one card.")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)} (default: all)")
    phases = ap.parse_args(argv).phases.split(",")
    if set(phases) - set(PHASES):
        ap.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (HERE / "alphasurf_torch" / "csrc").is_dir():
        print("chip_smoke: the alphasurf_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from alphasurf_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"device {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build_log = kernels.build()
    build_s = time.perf_counter() - t0
    log(f"kernels built in {build_s:.1f} s")
    for name, info in build_log.items():
        log(f"  {name}: nvcc {info['seconds']:.1f} s")
        for line in info["ptxas"]:
            log(f"    {line.strip()}")

    work = HERE / "build" / "smoke"
    work.mkdir(parents=True, exist_ok=True)
    res, launches = {}, {}
    runners = {
        "kernels": lambda: (check_kernels(device, card), {}),
        "serve": lambda: ({}, serve(device, card, work)),
        "train": lambda: ({}, train(device, card)),
        "warm": lambda: warm(device, card, work),
        "stages": lambda: stages(device, card, work),
        "extract": lambda: extract(device, card, work),
        "dtu": lambda: dtu(device, card, work),
        "renderers": lambda: renderers(device, card, work),
        "blender": lambda: blender(device, card, work),
        "tnt": lambda: tnt(device, card, work),
        "basis": lambda: basis(device, card, work),
        "compat": lambda: compat(device, card, work),
        "types": lambda: types(device, card, work),
    }
    # the launches each phase reports for the JSON line: serving is the
    # main path of K1-K4, training that of K5-K7, and each later phase's
    # of the kernels it brought
    keep = {"warm": WARM_NEW_KERNELS + CUVOL_GRAD_KERNELS,
            "stages": STAGE_KERNELS, "extract": EXTRACT_KERNELS,
            "dtu": DTU_KERNELS, "blender": EXTENDED_KERNELS}
    walls = {}
    try:
        for name in PHASES:
            if name not in phases:
                continue
            t0 = time.perf_counter()
            phase_res, phase_launches = runners[name]()
            gc.collect()  # a phase's autograd graphs may sit in reference cycles
            torch.cuda.empty_cache()
            walls[name] = time.perf_counter() - t0
            log(f"phase {name}: {walls[name]:.1f} s wall")
            res.update(phase_res)
            if name in keep:
                phase_launches = {k: phase_launches[k] for k in keep[name]}
            launches.update({k: v for k, v in phase_launches.items() if k not in launches})
    finally:
        shutil.rmtree(work, ignore_errors=True)

    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", JAX_PACKAGE)]
    if leaked:
        raise AssertionError(f"the port imported JAX modules: {leaked[:5]}")
    entries = []
    for name, (source, replaces) in KERNELS.items():
        if name not in res or name not in launches:
            continue  # a phase that was not run
        r = res[name]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None,
        })
    log("phase walls " + json.dumps({k: round(v, 1) for k, v in walls.items()}) + ", build "
        f"{build_s:.1f} s")
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
