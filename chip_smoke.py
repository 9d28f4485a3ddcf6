#!/usr/bin/env python3
"""Drive pycolmap_torch on one CUDA card and check it: the bundle adjuster,
the feature front end (SIFT extraction, descriptor matching), the
known-pose entry points (global BA of a model, triangulation of a model
with known poses), the dense pipeline (undistortion, PatchMatch stereo,
stereo fusion), the gather probe, the geometric estimators, the
incremental mapper, the way from image files to a model (import,
extraction, the pair matchers with batched verification, mapping), the
meshers, vocabulary-tree retrieval with the matchers built on it,
hierarchical mapping with alignment, the rig pose, mapping with two
camera models, multi-device bundle adjustment (point shards over a
shard mesh, over gloo and NCCL process groups), and the dense reduced
camera system of small bundles.

Run from the repository root on a host with an H100 (or another sm_90a
card) and the CUDA toolkit:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits nonzero):

1. build every kernel of the port (``pycolmap_torch/*/csrc``) with nvcc,
   all sources in parallel, and print the build time, the card's name and
   power limit, and the registers, spills and resident blocks per SM of
   the window sampler, the PatchMatch cost kernel and every resjac, cost
   and finish instance, and the modes of the Schur kernels;
2. hold each bundle-adjustment kernel to its plain PyTorch version on the
   card, at the bench shapes and at an irregular shape (three cameras,
   several buckets, widths that are no multiple of 128, mask holes, points
   behind cameras, partly fixed intrinsics, all three losses, all 11 camera
   models; the Schur kernels' buckets padded to multiples of 8 columns),
   and at a ragged one (an empty [4, 128] bucket, tracks of lengths 1..T,
   tiles of padding columns only); resjac, cost, finish, prepare and the
   f32 matvec one launch each for all buckets; resjac's residual and J
   exactly zero at every masked slot; the cost bit-equal over repeated
   calls and to finish's at a zero step with every point fixed; time
   resjac, cost and finish with CUDA events, with each wrapper call's
   host wall and device ops;
3. solve a 32-image / 8192-point problem on the card and on the CPU (plain
   versions), 6 LM steps each with f32 CG matvecs (both pinned to the
   implicit PCG, ``dense_schur_max_d=0``), and compare the results;
   resjac once per LM step on the card;
4. run the bench's resident solve (128 images, 100k points, ~600k
   observations; bench.py run_ba's sequence) through the kernels, with the
   launch counters zeroed just before the timed solves and read just after,
   once with the card's default bf16 CG matvec and once with the f32 one;
   resjac, prepare and finish launch once per LM step, either matvec once
   per CG iteration and the cost once per solve, each for all buckets;
5. profile one more bench solve with torch.profiler: device time per
   kernel, device ops per LM step and the device's busy share;
6. hold the window sampler (one launch per ``sample_windows`` call, its
   window origins computed in the kernel) and the top-2 matcher to their
   plain versions (float64) on the card: the sampler at octave 0's
   orientation and descriptor calls of a 960x1280 extract and at an
   irregular shape, top-2 at 8192 x 8192 and at a ragged batch; time
   kernel, plain version, bound (top-2: its 3xTF32 operations, the f32 SIMT
   figure beside) and one PyTorch call that computes the same function,
   and the sampler's whole call;
7. extract SIFT at 240x320 on the card and on the CPU (plain versions) and
   compare the keypoint sets;
8. the front end at bench.py run_sift's size (960x1280 uint8, default
   options): ms per image single and in batches of 4, keypoints per image,
   a cross-checked match against a 5-px shift, batched matching of 4 pairs;
   the launch counters are zeroed just before and read just after; then
   top-2 against its plain version and timed at the first pair's shape
   and at the four pairs padded to powers of two in one batch;
9. profile one full-width extract with torch.profiler;
10. hold the bf16 CG matvec to its plain version (float64 on the same bf16
    values) at the bench shape, with J captured from the main path, at
    irregular shapes (NP 3, 5, 8, 12, three cameras, ragged P) and with an
    empty [4, 128] bucket beside two non-empty ones, each call one launch;
    time it and its host wall; then the bench's operands spread over
    256-10,240 images (the modes where the sums live), each checked and
    timed for the bf16 matvec, the f32 matvec and prepare (their f32 J and
    residuals captured from the same LM step);
11. ``bundle_adjustment(reconstruction)`` at full width: the bench's
    128-image / 100k-point problem as a Reconstruction, written and read
    back as a COLMAP binary model, adjusted on the card with default
    options, resjac once per LM step; then a 32-image model on the card
    and on the CPU, both with the bf16 matvec on the implicit PCG
    (``dense_schur_max_d=0``), compared;
12. ``triangulate_points`` on the card: a 128-image sequential database of
    100k points seen by about 6 images each, ground-truth poses;
13. hold the PatchMatch cost kernel to its plain version at the main
    path's inputs captured in phase 14 (photometric and geometric) and at
    irregular shapes (K 3 and 11): its full-field and both parity launches
    bit for bit against the f32 plain version, the full field against
    float64; time the full-field and the parity launch;
14. the dense pipeline at run_sift's size: 12 rendered 960x1280 images of
    two textured planes through a SIMPLE_RADIAL camera, ``undistort_images``
    -> ``patch_match_stereo`` -> ``stereo_fusion`` with default options,
    launch counts (per image and pass 10 full-field and 70 parity cost
    launches), depth and fusion accuracy against the planes, and a profile
    of one image's photometric and geometric PatchMatch (phase 14 runs
    before phase 13, which checks the inputs it captures);
15. hold the mixed-model variants of the resjac, cost and finish kernels
    (bundles whose cameras span several camera models) to their plain
    versions in float64, with phase 2's tolerances and checks: at the
    inputs captured in phase 16's solve, at an irregular three-model bundle
    of width 13 (SIMPLE_PINHOLE, FULL_OPENCV and FOV near omega = 0, plus a
    camera whose selector names no listed model), at one bundle holding
    all 11 models, and, with prepare, matvec and matvec16, at the mixed
    widths 6, 9 and 13, irregular and ragged (prepare and both matvecs
    timed at phase 16's width 9);
16. ``bundle_adjustment`` of a mixed-model model at full width: phase 11's
    128-image / 100k-point ring, even images through a SIMPLE_RADIAL camera
    and odd ones through an OPENCV camera, observations projected in
    float64 through each camera plus 0.5 px noise, written and read back as
    a binary model, default options with the bf16 matvec, resjac and
    finish once per LM step and the cost once; compared with phase 11's
    single-model solve of the same size; then a 32-image model on the card
    and on the CPU at the defaults, both solving the dense reduced system
    (phase 16 runs before phase 15);
17. hold the per-observation parameter gather to its plain version
    (exactly equal) at phase 16's bucket shapes and at a ragged shape, and
    time it beside ``index_select``;
18. the gather probe (``pycolmap_torch.scripts.proto_gather``, the port of
    scripts/proto_pallas_gather.py): its report, each of the five gather
    forms held to its plain version bit for bit and timed beside its byte
    bound and one PyTorch call at the reference's shapes, the lane gather
    at bench_a_sized's [1024, 512], the flat gather at 2,097,152 from
    2,457,600 and the bilinear baseline beside ``F.grid_sample``; then each
    form bit for bit at ragged shapes and with negative, out-of-range and
    int32-extreme indices; an empty launch timed with CUDA events, the
    floor beside the forms' byte bounds. Nothing on a user path calls the
    probe: its launch counts over phases 2-17 are 0;
19. the estimators (plain PyTorch, no kernel of their own) on the card and
    on the CPU at a user's scale, each result held to ground truth: (a)
    ``estimate_calibrated_two_view_geometry`` with the relative pose on
    4,000 matches of a 960x1280 PINHOLE pair (f 1000, 30% outliers, 0.5 px
    noise; CALIBRATED, > 80% of the true inliers, rotation < 1 degree), (b)
    its planar variant (PLANAR_OR_PANORAMIC), (c)
    ``estimate_two_view_geometry`` on phase 8's card matches of the
    5-px-shifted pair (the DLT of H's inliers maps the corners within 0.5
    px of the shift, H itself within the 4-px threshold, and the card's
    configuration equals the CPU's), (d) ``estimate_absolute_pose``
    on 2,000 correspondences with 40% outliers (rotation < 0.5 degree,
    translation < 0.05) and ``refine_absolute_pose`` from a perturbed
    pose, (e) ``estimate_triangulation`` of a 10-view track with 2 outlier
    views (within 0.05); per case the card's host wall ms per call (median
    of 3 after a warm-up), LO-RANSAC chunks, host synchronisations and
    device ops of one call, and the CPU's wall ms;
20. ``incremental_mapping`` at bench.py run_mapping's size: the
    30-image / 2,000-point orbit database of tests/test_incremental_mapping.py
    (written with the port's Database), run_mapping's options, on the card
    (every launch count zeroed just before and read just after):
    registered img/s and the stage split; 30/30 registered, mean
    reprojection error under
    1 px, median rotation error under 0.5 degrees after a similarity
    alignment, more than half the points, the model read back; every BA
    solve on the dense reduced system (D_ref <= 512), resjac, prepare and
    finish once per LM step, the cost once per solve, matvec16 once per
    implicit CG iteration (none: a dense step packs no J and launches no
    matvec; the mapper's resident-BA cache counts them), no kernel off the
    BA path; resjac, cost, finish, prepare, the f32 and the bf16 matvec
    held to their plain versions (phases 2 and 10) at the
    operands of one global step (the deepest buckets, recorded in the same
    call) and one local-window step, the global step's timed; the 8-image /
    300-point database on the card and on the CPU, both checked; the native
    graph library built from the checkout and the correspondence graph
    traversing through it;
21. images to model at run_sift's size: 30 renderings of phase 14's two
    planes at 960x1280 (``.ppm``, a SIMPLE_RADIAL camera) through
    ``extract_features`` (default options) -> ``match_exhaustive``
    (defaults, 435 pairs, verification in blocks of 16) ->
    ``incremental_mapping`` with tests/test_full_pipeline.py's C2-gate
    options, every launch count zeroed just before and read just after:
    at least half the pairs verified, 28 of 30 registered, more than 1,000
    points under 1.5 px, median rotation error under 0.5 degrees and
    center error under 0.05 after a similarity alignment; the sampler twice
    per octave and extract, top-2 twice per shape bucket, the BA kernels as
    in phase 20, nothing else; seconds per stage, SIFT ms per image, match
    and verification ms per pair, the verification block's peak memory,
    registered img/s; then tests/test_full_pipeline.py's small flow (6
    images at 512x384) on the card and on the CPU at that test's bounds,
    and on the card ``match_sequential`` (overlap 2), ``match_spatial``
    (true poses as priors) and guided exhaustive matching (no pair loses
    inliers).
22. meshing at full size, in phase 14's workspace (its ~5.3M fused points
    with normals and its ``.vis``): ``poisson_meshing`` on the card with
    default options (a 256^3 grid), by stage (read, splat and smooth,
    solve, iso, marching tetrahedra, trim, write), more than 10,000 faces
    whose centres lie a median under 0.02 from the nearer plane (phase 14's
    fused-point bound); the same solve and marching tetrahedra on the
    port's CPU path, chi within 1e-4 scaled and the vertex count within
    0.5%; ``dense_delaunay_meshing`` of the workspace on the host (the
    200k subsample, the visibility votes, the native min-cut), by stage,
    at the same plane bound; ``sparse_delaunay_meshing`` of phase 21's
    model, faces > 0;
23. retrieval at 500 of BASELINE.md C5's 1,000 images (cut for the
    script's time): a synthetic database of 90 places along a closed
    sequence, five images a place, the last 50 revisiting places 0-9, 4,096 uint8 descriptors an image (its place's
    pool plus noise, 512 from a pool all places share); ``build_visual_index``
    with defaults on the card (200k training rows, 4,096 words), seconds
    for read, train per level, quantize and index, quantize and query ms
    per image; ``retrieve_ranked_pairs`` with a same-place image in the top
    5 for >= 95% of queries, ``detect_loops`` (period 10) with the planted
    revisit first for >= 90% of the planted loop queries; the card against
    the CPU on the first 50 images (centers within 1e-4, words equal on
    >= 99.9%, the same ranked lists); on copies of phase 21's database
    (matches cleared) ``match_vocabtree`` (10 images) and
    ``match_sequential`` (overlap 2, loop detection every 5th image), each
    verifying at least half its candidate pairs, timed; every launch count
    zeroed just before phase 22 and read after phase 23: top-2 twice per
    shape bucket of those matchers, nothing else;
24. ``hierarchical_mapping`` of a 90-image / 12,000-point sequential
    database (phase 12's scene; about 700 points an image, 6 images a
    point, verified pairs of >= 30 shared points) in 3 parts with overlap
    6 on the card, run_mapping's options, every launch count zeroed just
    before and read just after: at least 86 of 90 registered in model 0,
    mean reprojection error under 1 px, median rotation error under 0.5
    degrees after a similarity alignment by ``pose_errors`` and by
    ``compare_reconstructions(..., "proj_center")`` (within 0.01 of each
    other), ``check()``, the model read back; per part its images,
    registered img/s and stage split, the partition and merge seconds; the
    BA kernels as in phase 20, summed over the parts (windows of at most
    32 images solve densely, larger solves implicitly), nothing else; then
    ``align_reconstruction_to_locations`` of the merged model onto its
    images' true centers under a known Sim3 (scale 2, a 0.3 rad turn, a
    shift) with 0.01 noise and 10% gross outliers (``max_error`` 0.1):
    every outlier rejected, every other center within 0.01 of where the
    least-squares Sim3 of those centers maps it (their residuals carry
    the model's own center errors, doubled), the card's Sim3 within 1e-4
    of the CPU's;
25. ``rig_absolute_pose_estimation`` of a four-camera rig (front, back,
    left, right, 0.2 apart; PINHOLE 960x1280, f 1000) on 2,000
    correspondences with 30% outliers and 0.5 px noise, on the card and on
    the CPU, each within 0.5 degrees and 0.05 of the truth; the card's ms
    per call (median of 3 after a warm-up), LO-RANSAC chunks, host
    synchronisations and device ops of one call, the CPU's ms, and the
    share of minimal samples whose three observations share a camera; no
    kernel launched;
26. ``incremental_mapping`` of phase 20's 30-image / 2,000-point orbit with
    the images alternating between a SIMPLE_RADIAL and a PINHOLE camera (f
    600, 640x480), tests/test_mixed_models.py's options, every launch count
    zeroed just before and read just after: 29 of 30 registered, both
    models in the model, under 1 px, median rotation error under 0.5
    degrees; every BA solve dense, the mixed resjac, cost and finish
    launched (the single-model forms only for windows of one model),
    matvec16 once per implicit CG iteration (none), prepare once per LM
    step, resjac and finish of either form once per LM step and the cost
    once per solve; the mixed kernels, prepare and both matvecs
    held to their plain versions (phases 15 and 10) and timed at the
    operands of one recorded global step;
27. multi-device bundle adjustment on the one card, every launch count
    zeroed just before and read just after each part: (a) the bench bundle
    (5 LM steps, ``cg_iters`` 15, the bf16 matvec) through
    ``solve_bundle(..., mesh=make_obs_mesh(["cuda:0", "cuda:0"]))`` and
    unsharded: the same iteration count, the initial cost within 1e-4, the
    final within 1e-3, camera translations within 1e-3; per shard resjac,
    prepare and finish once per LM step, matvec16 once per CG iteration,
    the cost once per solve; then ``dryrun_multichip(2)`` (a solve and two chained
    resident solves on the mesh); (b) two processes of this script
    (``--phase27-rank``) joined over gloo, one shard each on cuda:0: the
    ranks agree (iterations, cost within 1e-5, a quaternion and a point
    within 1e-5) and rank 0 equals (a)'s two-shard solve within 1e-6; (d)
    phase 20's mapping with ``options.devices`` the two-shard mesh: at
    least 29 of 30 registered under 1 px, the median rotation against
    phase 28 (b)'s unsharded implicit model under 0.1 degrees and the
    reprojection error within 0.05 px of it (a mesh solves implicitly
    only, so this measures sharding alone); (c) one NCCL rank: a
    one-shard mesh over its group equals the unsharded solve within 1e-6.
    The card's host has one card, so no shard runs on a second card here;
28. the dense reduced camera system (run before phase 27): (a) at the
    recorded steps of phase 20 (one global, one local-window), phase 21
    (the last global step with the deepest bucket) and phase 26 (a
    two-camera global step), each rebuilt on the card from its recorded
    operands: S built on the card against the same build on the CPU
    (1e-5 scaled), S v against the f32 matvec kernel's implicit product
    (1e-4 scaled), x of the dense and of the implicit PCG, each run to
    eta 1e-6 (1e-3 scaled) where f32 can solve the system (its free
    block's Jacobi-scaled condition under 1 / eps(f32); an indefinite or
    worse one is reported instead); the S build timed with CUDA events, the dense
    PCG and a dense step's solve (build and PCG, cap max(cg_iters, 64))
    at the default eta and the implicit step's (bf16 pack, table and PCG,
    cap cg_iters) at the same operands, host wall, with their iterations;
    (b) phase 20's orbit mapped with ``dense_schur_max_d=0``, every launch
    count zeroed just before and read just after: phase 20's checks, no
    dense solve, matvec16 once per CG iteration; registered img/s, LM
    steps and CG iterations beside phase 20's dense run.

The last lines are one JSON object describing every kernel, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import copy
import datetime
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
try:
    from pycolmap_torch import _cuda_build
    from pycolmap_torch.features import _cuda as features_cuda
    from pycolmap_torch.features import match_kernels as mk
    from pycolmap_torch.features import matcher as fm
    from pycolmap_torch.features import window_sampler as ws
    from pycolmap_torch.features.sift import Sift
    from pycolmap_torch.ops.camera_models import solver_num_params
    from pycolmap_torch.geometry import Rigid3d, Rotation3d
    from pycolmap_torch.parallel.synthetic import make_synthetic_bundle
    from pycolmap_torch.pipeline import sfm as psfm
    from pycolmap_torch.scene import (
        Camera, Database, DatabaseTransaction, Image, Reconstruction, Track,
        TrackElement,
    )
    from pycolmap_torch.sfm import _cuda as sfm_cuda
    from pycolmap_torch.sfm import ba_kernels as bk
    from pycolmap_torch.sfm import cg_kernel as ck
    from pycolmap_torch import estimators as est
    from pycolmap_torch.estimators import (
        TwoViewGeometry, TwoViewGeometryConfiguration,
    )
    from pycolmap_torch.estimators.ransac import BatchedLORANSAC
    from pycolmap_torch.ops import solvers as est_solvers
    from pycolmap_torch.sfm.bundle_adjustment import BundleAdjustmentOptions
    from pycolmap_torch.sfm.resident import ResidentBundleSolver
    from pycolmap_torch.mvs import _cuda as mvs_cuda
    from pycolmap_torch.mvs import controller as mvs_controller
    from pycolmap_torch.mvs import patch_match as pm
    from pycolmap_torch.mvs import pm_kernels as pmk
    from pycolmap_torch.mvs.depth_map_io import depth_map_path, read_mat
    from pycolmap_torch.pipeline import (
        PatchMatchOptions, patch_match_stereo, stereo_fusion, undistort_images,
    )
    from pycolmap_torch.pipeline.images import write_image
    from pycolmap_torch._timing import REPS, WARMUP, host_ms, time_gpu
    from pycolmap_torch.scripts import proto_gather as pg
    from pycolmap_torch import native
    from pycolmap_torch.ops import quaternion as qops
    from pycolmap_torch.sfm.database_cache import DatabaseCache
    from pycolmap_torch.features import SiftExtractionOptions, SiftMatchingOptions
    from pycolmap_torch.pipeline import (
        SequentialMatchingOptions, SpatialMatchingOptions, extract_features,
        infer_camera_from_image, match_exhaustive, match_sequential,
        match_spatial,
    )
    from pycolmap_torch.pipeline import match_features as mf
    from pycolmap_torch.features import retrieval
    from pycolmap_torch.features.matcher import _to_unit_float
    from pycolmap_torch.mvs import meshing
    from pycolmap_torch.pipeline import (
        VocabTreeMatchingOptions, dense_delaunay_meshing, match_vocabtree,
        poisson_meshing, sparse_delaunay_meshing,
    )
    from pycolmap_torch.parallel.graph_partition import hierarchical_mapping
    from pycolmap_torch.estimators import alignment as est_alignment
    from pycolmap_torch.parallel import distributed as pdist
    from pycolmap_torch.parallel.sharded_ba import (
        dryrun_multichip, make_obs_mesh,
    )
    from pycolmap_torch.sfm.bundle_adjustment import (
        solve_bundle as sfm_solve_bundle,
    )
except ImportError as e:  # run outside the repository
    sys.exit(f"chip_smoke: the pycolmap_torch package is missing ({e})")

# H100 SXM published peaks (NVIDIA data sheet: HBM3 rate, f32 outside the
# tensor cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12  # dense tensor-core TF32

BENCH = dict(num_images=128, num_points=100_000, obs_per_point=6,
             pose_noise=0.05, point_noise=0.10, refine_intrinsics=True,
             seed=0)
CG_ITERS = 20
LM_ITERS = 20
# The card and the CPU are compared after 6 LM steps: the medium problem's
# cost has converged by then, and past convergence the steps follow
# summation-order noise along flat directions, where two runs of the same
# solve can part by several 1e-4 in the camera translations.
MEDIUM_LM_ITERS = 6

# where each kernel lives and which TPU kernel (pallas_call site) it replaces
KERNEL_INFO = {
    "resjac": ("pycolmap_torch/sfm/csrc/resjac.cu",
               "pycolmap_tpu/sfm/cg_kernel.py:659"),
    "cost": ("pycolmap_torch/sfm/csrc/cost.cu",
             "pycolmap_tpu/sfm/cg_kernel.py:738"),
    "finish": ("pycolmap_torch/sfm/csrc/cost.cu",
               "pycolmap_tpu/sfm/cg_kernel.py:866"),
    "prepare": ("pycolmap_torch/sfm/csrc/schur.cu",
                "pycolmap_tpu/sfm/cg_kernel.py:1122"),
    "matvec": ("pycolmap_torch/sfm/csrc/schur.cu",
               "pycolmap_tpu/sfm/cg_kernel.py:220"),
    "matvec16": ("pycolmap_torch/sfm/csrc/schur.cu",
                 "pycolmap_tpu/sfm/cg_kernel.py:403"),
    "window_sampler": ("pycolmap_torch/features/csrc/window_sampler.cu",
                       "pycolmap_tpu/features/window_sampler.py:127"),
    "top2": ("pycolmap_torch/features/csrc/top2.cu",
             "pycolmap_tpu/features/pallas_kernels.py:87"),
    "pm_cost": ("pycolmap_torch/mvs/csrc/pm_cost.cu",
                "pycolmap_tpu/mvs/pm_kernels.py:412"),
    # the tuple (mixed-model) forms of the first three TPU kernels
    "resjac_mixed": ("pycolmap_torch/sfm/csrc/resjac.cu",
                     "pycolmap_tpu/sfm/cg_kernel.py:659"),
    "cost_mixed": ("pycolmap_torch/sfm/csrc/cost.cu",
                   "pycolmap_tpu/sfm/cg_kernel.py:738"),
    "finish_mixed": ("pycolmap_torch/sfm/csrc/cost.cu",
                     "pycolmap_tpu/sfm/cg_kernel.py:866"),
    "gather": ("pycolmap_torch/sfm/csrc/gather.cu",
               "pycolmap_tpu/sfm/cg_kernel.py:505"),
    # the gather probe's five forms (take_along_last also bench_a_sized's
    # pallas_call, :164)
    **{f"probe_{name}": ("pycolmap_torch/scripts/csrc/gather_probe.cu",
                         f"scripts/proto_pallas_gather.py:{line}")
       for name, line in zip(pg.KERNELS, (66, 85, 104, 125, 144))},
}
# tolerance on max |kernel - plain| / max(1, max |plain|) per output, the
# plain version evaluated in float64 (the CPU parity tests' tolerances).
# The kernels compute in f32; the Schur kernels' sums are float atomics
# whose order varies run to run outside their fixed-order mode.
TOL = {"resjac": 1e-5, "cost": 1e-5, "finish": 1e-5, "prepare": 3e-5,
       "matvec": 2e-5,
       "resjac_mixed": 1e-5, "cost_mixed": 1e-5, "finish_mixed": 1e-5,
       # the f32 matvec's: both sides multiply the same bf16 values
       "matvec16": 2e-5,
       # the reference's sampler tolerance (tests/test_window_sampler.py)
       "window_sampler": 2e-5,
       # unit-vector similarities; indices must agree where the top-2
       # margin exceeds TOP2_MARGIN
       "top2": 1e-6,
       # against the f32 plain version; against float64 plus the f32 plain
       # version's own gap (check_pm_cost)
       "pm_cost": 2e-5}
TOP2_MARGIN = 1e-5
# where a Schur kernel keeps its sums (csrc/schur.cu TileSums), and the
# image counts phase 10 also checks and times them at
SUMS = {0: "global atomics", 1: "block", 2: "fixed order"}
MATVEC16_IMAGES = (256, 1024, 2048, 5120, 10240)
SIFT_H, SIFT_W = 960, 1280  # bench.py run_sift's images
# the kernels phase 2 chains as in an LM step (the bf16 matvec: phase 10)
F32_KERNELS = ("resjac", "cost", "finish", "prepare", "matvec")
# the BA kernels of a single-model solve, and those of a mixed-model one
SINGLE_BA = ("resjac", "cost", "finish", "prepare", "matvec", "matvec16")
MIXED_BA = ("resjac_mixed", "cost_mixed", "finish_mixed", "prepare",
            "matvec", "matvec16")
# phase 16's cameras: even images SIMPLE_RADIAL, odd images OPENCV, about
# the bench's principal point and focal length
MIXED_CAMERAS = (
    ("SIMPLE_RADIAL", [1000.0, 2000.0, 1500.0, -0.03]),
    ("OPENCV", [1000.0, 1002.0, 2000.0, 1500.0, -0.03, 0.01, 1e-4, -1e-4]),
)
MIXED_PIXEL_NOISE = 0.5
# phase 12's database: the bench's image and point counts
TRI_IMAGES, TRI_POINTS = 128, 100_000
# phase 14's scene: run_sift's image size, two planes (z = 6 owns x < 0.15)
MVS_IMAGES, MVS_H, MVS_W = 12, 960, 1280
MVS_PLANES = (6.0, 7.5)
MVS_RADIAL_K = -0.03
# phase 19's scenes: run_sift's image size through a PINHOLE camera of
# focal length 1000, tests/test_estimators.py synth_two_view's geometry;
# 4,000 matches (a SIFT pair at that size matches a few thousand
# keypoints), 2,000 2D-3D correspondences, a 10-view track
EST_F, EST_MATCHES, EST_PNP, EST_VIEWS = 1000.0, 4000, 2000, 10
EST_REPS = 3  # 5 before the cuts for the script's time (PERF.md §4)
# phase 20's databases: bench.py run_mapping's (30 images of 2,000 points,
# 0.4 px noise) and tests/test_incremental_mapping.py's (8 of 300)
MAP_IMAGES, MAP_POINTS, MAP_NOISE = 30, 2000, 0.4
MAP_PARITY_IMAGES, MAP_PARITY_POINTS = 8, 300
# phase 21's scenes: render_dense_scene's two planes at run_sift's size
# (30 images, 435 pairs), and tests/test_full_pipeline.py's small scene
E2E_IMAGES = 30
E2E_SMALL_IMAGES, E2E_SMALL_H, E2E_SMALL_W = 6, 384, 512
# phase 22: PoissonMeshingOptions' default depth 13 gives a 256^3 grid;
# the card against the CPU at 128^3 (the CPU's 256^3 solve took 21.7 s:
# cut for the script's time, PERF.md §4)
POISSON_N, POISSON_PARITY_N = 256, 128
# phase 23's place database: BASELINE.md C5's shape at 500 of its 1,000
# images (cut for the script's time: PERF.md §4), along a closed sequence
# of 90 places, five consecutive images a place, the last 50 revisiting
# places 0-9; 4,096 descriptors an image (phase 21 averaged 3,536
# keypoints), 512 of them from a pool all places share
RET_IMAGES, RET_PER_PLACE, RET_REVISITS = 500, 5, 50
RET_DESCS, RET_SHARED, RET_NOISE = 4096, 512, 4
RET_PARITY_IMAGES = 50  # 100 before the cuts for the script's time
# phase 24's database: write_sequential_database's scene (C4's sequential
# shape, BASELINE.md) at 90 images of 12,000 points, mapped in 3 parts
HIER_IMAGES, HIER_POINTS, HIER_NOISE = 90, 12_000, 0.4
HIER_PARTS, HIER_OVERLAP = 3, 6
# phase 25's rig: 2,000 correspondences over four cameras
RIG_OBS = 2000
# phase 27: the bench bundle at 5 LM steps of at most 15 CG iterations, on
# two shards of the one card; a rank process's and the NCCL group's limit
SHARD_LM_ITERS, SHARD_CG_ITERS = 5, 15
SHARD_DEVICES = ("cuda:0", "cuda:0")
RANK_TIMEOUT_S = 300


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def scaled_err(got, ref):
    got = got.double().cpu()
    ref = ref.double().cpu()
    if not bool(torch.isfinite(got).all()):
        return math.inf, math.inf
    diff = float((got - ref).abs().max()) if ref.numel() else 0.0
    scale = max(float(ref.abs().max()) if ref.numel() else 0.0, 1.0)
    return diff, diff / scale


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


class Case:
    """One set of kernel inputs on the card: buckets, parameters, and the
    CG-step operands the later kernels take."""

    def __init__(self, buckets, quat, trans, intr, intr_free, model_id,
                 loss_type, loss_scale, seed):
        self.buckets = buckets
        self.quat, self.trans = quat, trans
        self.intr, self.intr_free = intr, intr_free
        self.model_id = model_id
        self.loss_type, self.loss_scale = loss_type, loss_scale
        NP = solver_num_params(model_id)
        self.NP = NP
        self.I, self.C = quat.shape[0], intr.shape[0]
        g = torch.Generator().manual_seed(seed)
        dev = quat.device
        self.lam = torch.tensor(0.37, device=dev)
        self.x_pose = (1e-3 * torch.randn(self.I, 6, generator=g)).to(dev)
        self.x_intr = (1e-3 * torch.randn(self.C, NP, generator=g)).to(dev)
        self.x_intr[:, 0] *= 100.0  # focal steps in pixels
        if isinstance(model_id, tuple):
            self.x_intr[:, NP - 1] = 0.0  # the solver never moves a selector
        nq = torch.nn.functional.normalize(
            quat + 1e-3 * torch.randn(quat.shape, generator=g).to(dev), dim=1)
        self.new_quat = nq
        self.new_trans = trans - self.x_pose[:, 3:6]
        self.new_intr = intr[:, :NP] - self.x_intr

    @property
    def pts(self):
        return [b.points for b in self.buckets]


def _bucket_as(b, dt):
    return b._replace(xy=b.xy.to(dt), mask=b.mask.to(dt),
                      points=b.points.to(dt), point_free=b.point_free.to(dt))


def check_case(case, tag, results=None):
    """Every kernel vs its plain version on one case.

    Each plain version runs on the same inputs as its kernel (the later
    kernels take the earlier kernels' outputs), evaluated in float64: at the
    bench shape the f32 plain prepare, whose index_add_ sums 600k terms onto
    one camera row, is itself 4e-4 off the float64 sum while the kernel is
    within 1e-6. Returns per kernel (max_abs_err, scaled_err); with
    `results`, also times the kernels and the f32 plain versions. A
    mixed-model case reports resjac, cost and finish as their *_mixed
    variants."""
    b_l, pts = case.buckets, case.pts
    m, lt, ls = case.model_id, case.loss_type, case.loss_scale
    NP, I, C = case.NP, case.I, case.C
    lam, x_pose, x_intr = case.lam, case.x_pose, case.x_intr

    # --- the kernels, chained as in an LM step --------------------------------
    def k_resjac():
        return ck.res_and_jac(b_l, pts, case.quat, case.trans, case.intr,
                              case.intr_free, m, lt, ls)

    def kname(name):
        return ck._kernel_name(name, m) if name in ck.KERNELS[:3] else name

    res_k, J_k = _one_launch(kname("resjac"), tag, k_resjac)
    resjac_zeros(tag, b_l, res_k, J_k)
    c_k = _one_launch(kname("cost"), tag, lambda: ck.total_cost(
        b_l, pts, case.quat, case.trans, case.intr, m, lt, ls))
    # the Schur kernels, one launch each for all buckets, take widths that
    # are multiples of 8: their inputs get empty columns (mask 0, index 0,
    # all-zero J and residuals), as bucketize pads
    b8 = [pad_bucket(b, 8) for b in b_l]
    J8 = [pad_cols(J, 8) for J in J_k]
    r8 = [pad_cols(r, 8) for r in res_k]
    prep_k = _one_launch("prepare", tag, lambda: ck.schur_prepare(
        b8, J8, r8, lam, I, C))
    Vinv8 = prep_k[0]
    Vinv_l = [V[:, :b.mask.shape[1]].contiguous() for V, b in zip(Vinv8, b_l)]
    g_l = [g[:, :b.mask.shape[1]].contiguous() for g, b in zip(prep_k[1], b_l)]
    mv_k = _one_launch("matvec", tag, lambda: ck.schur_matvec(
        b8, J8, Vinv8, x_pose, x_intr, I, C))
    fin_k = _one_launch(kname("finish"), tag, lambda: ck.backsub_and_cost(
        b_l, pts, J_k, Vinv_l, g_l, x_pose, x_intr, case.new_quat,
        case.new_trans, case.new_intr, m, lt, ls))
    kernel_out = {
        "resjac": res_k + J_k,
        "cost": [c_k],
        "prepare": list(prep_k[0]) + list(prep_k[1]) + list(prep_k[2:]),
        "matvec": list(mv_k),
        "finish": list(fin_k[0]) + [fin_k[1]],
    }

    def plain(name, dt):
        """The plain version over all buckets, in dtype dt."""
        d = lambda x: x.to(dt)  # noqa: E731
        bl = [_bucket_as(b, dt) for b in b_l]
        itab = d(torch.cat([case.quat, case.trans], 1))
        intr = d(case.intr[:, :NP])
        if name == "resjac":
            out = [ck.resjac_plain(b, b.points, itab, intr,
                                   d(case.intr_free[:, :NP]), m, lt, ls)
                   for b in bl]
            return [o[0] for o in out] + [o[1] for o in out]
        if name == "cost":
            return [sum(ck.cost_plain(b, b.points, itab, intr, m, lt, ls)
                        for b in bl)]
        if name == "prepare":
            acc_i = torch.zeros((I, 33), device=itab.device, dtype=dt)
            acc_c = torch.zeros((C, 2 * NP), device=itab.device, dtype=dt)
            vs, gs = [], []
            for b, J, r in zip([_bucket_as(b, dt) for b in b8], J8, r8):
                v, g, oi, oc = ck.prepare_plain(b, d(J), d(r), d(lam), I, C)
                vs.append(v)
                gs.append(g)
                acc_i, acc_c = acc_i + oi, acc_c + oc
            return vs + gs + [acc_i[:, :6], acc_c[:, :NP], acc_i[:, 6:12],
                              acc_c[:, NP:], acc_i[:, 12:33]]
        if name == "matvec":
            mp = torch.zeros((I, 6), device=itab.device, dtype=dt)
            mi = torch.zeros((C, NP), device=itab.device, dtype=dt)
            for b, J, V in zip([_bucket_as(b, dt) for b in b8], J8, Vinv8):
                op, oi = ck.matvec_plain(b, d(J), d(V), d(x_pose), d(x_intr),
                                         I, C)
                mp, mi = mp + op, mi + oi
            return [mp, mi]
        nitab = d(torch.cat([case.new_quat, case.new_trans], 1))
        out = [ck.finish_plain(b, b.points, d(J), d(V), d(g), d(x_pose),
                               d(x_intr), nitab, d(case.new_intr), m, lt, ls)
               for b, J, V, g in zip(bl, J_k, Vinv_l, g_l)]
        return [o[0] for o in out] + [sum(o[1] for o in out)]

    errs = {}
    for name in F32_KERNELS:
        worst = (0.0, 0.0)
        for got, ref in zip(kernel_out[name], plain(name, torch.float64)):
            e = scaled_err(got.reshape(-1), ref.reshape(-1))
            worst = (max(worst[0], e[0]), max(worst[1], e[1]))
        errs[kname(name)] = worst
        if not worst[1] <= TOL[kname(name)]:
            raise AssertionError(
                f"[{tag}] {kname(name)}: kernel vs plain scaled error "
                f"{worst[1]:.3e} > {TOL[kname(name)]:.0e} (max abs "
                f"{worst[0]:.3e})")
    torch.cuda.synchronize()
    cost_bits(case, tag, J_k, Vinv_l, g_l, c_k)

    if results is not None:
        # resjac, cost and finish as the LM step calls them: NP-narrow
        # intrinsics, resjac's table built once per solve and finish's once
        # per LM step, each for all its calls
        intr_np = case.intr[:, :NP].contiguous()
        free_np = case.intr_free[:, :NP].contiguous()
        rl = ck.resjac_launch(b_l, m)
        fl = ck.finish_launch(b_l, pts, J_k, Vinv_l, g_l)
        kern = {
            "resjac": lambda: ck.res_and_jac(
                b_l, pts, case.quat, case.trans, intr_np, free_np, m, lt, ls,
                launch=rl),
            "cost": lambda: ck.total_cost(
                b_l, pts, case.quat, case.trans, intr_np, m, lt, ls),
            "prepare": lambda: ck.schur_prepare(b8, J8, r8, lam, I, C),
            "matvec": lambda: ck.schur_matvec(b8, J8, Vinv8, x_pose,
                                              x_intr, I, C),
            "finish": lambda: ck.backsub_and_cost(
                b_l, pts, J_k, Vinv_l, g_l, x_pose, x_intr, case.new_quat,
                case.new_trans, case.new_intr, m, lt, ls, launch=fl),
        }
        for name in F32_KERNELS:
            plain32 = max(
                scaled_err(got.reshape(-1), ref.reshape(-1))[1]
                for got, ref in zip(plain(name, torch.float32),
                                    plain(name, torch.float64)))
            results[kname(name)] = dict(
                plain32_scaled_err=plain32, ms=time_gpu(kern[name]),
                plain_ms=time_gpu(lambda: plain(name, torch.float32), 5),
                max_abs_err=errs[kname(name)][0],
                scaled_err=errs[kname(name)][1], **bound(name, case),
            )
        for name in ("resjac", "cost", "finish"):
            r = results[kname(name)]
            r.update(call_host_ms=host_ms(kern[name]),
                     device_ops=device_ops(kern[name]))
            # no sum, add, fill or copy beside the kernel
            if (r["device_ops"] or 0) > 1:
                raise AssertionError(f"[{tag}] {kname(name)}: "
                                     f"{r['device_ops']} device ops in one "
                                     f"call, expected 1")
        results[kname("finish")]["build_host_ms"] = host_ms(
            lambda: ck.finish_launch(b_l, pts, J_k, Vinv_l, g_l))
        results[kname("resjac")]["build_host_ms"] = host_ms(
            lambda: ck.resjac_launch(b_l, m))
        # the host wall of a call that builds its own table (the parent's
        # form, and every caller outside the LM loop)
        results[kname("resjac")]["call_host_ms_table"] = host_ms(k_resjac)
    return errs


def resjac_zeros(tag, buckets, res_l, J_l):
    """Raise unless res and J are exactly zero at every masked slot."""
    for i, (b, r, J) in enumerate(zip(buckets, res_l, J_l)):
        dead = b.mask == 0
        if bool(r[:, dead].any()) or bool(J[:, :, dead].any()):
            raise AssertionError(f"[{tag}] resjac: bucket {i} nonzero at a "
                                 f"masked slot")


def cost_bits(case, tag, J_l, Vinv_l, g_l, c_k):
    """The cost repeats to the bit over calls; finish repeats its points and
    cost over calls with one table; finish at a zero step with every point
    fixed and the parameters unchanged returns the points and the cost's
    bits (both kernels add the same slot costs in the same order)."""
    b_l, pts, m = case.buckets, case.pts, case.model_id
    lt, ls, NP = case.loss_type, case.loss_scale, case.NP
    again = [ck.total_cost(b_l, pts, case.quat, case.trans, case.intr, m, lt,
                           ls) for _ in range(3)]
    if not all(torch.equal(a, c_k) for a in again):
        raise AssertionError(f"[{tag}] cost: repeated calls differ: "
                             f"{[float(a) for a in again]} vs {float(c_k)}")
    fl = ck.finish_launch(b_l, pts, J_l, Vinv_l, g_l)

    def fin(bl=b_l, launch=fl, **kw):
        a = {**dict(x_pose=case.x_pose, x_intr=case.x_intr, q=case.new_quat,
                    t=case.new_trans, k=case.new_intr), **kw}
        out = ck.backsub_and_cost(bl, pts, J_l, Vinv_l, g_l, a["x_pose"],
                                  a["x_intr"], a["q"], a["t"], a["k"], m, lt,
                                  ls, launch=launch)
        return [p.clone() for p in out[0]], out[1].clone()

    (p1, f1), (p2, f2) = fin(), fin()
    if not (torch.equal(f1, f2) and all(map(torch.equal, p1, p2))):
        raise AssertionError(f"[{tag}] finish: repeated calls differ")
    fixed = [b._replace(point_free=torch.zeros_like(b.point_free))
             for b in b_l]
    p0, f0 = fin(fixed, None, x_pose=torch.zeros_like(case.x_pose),
                 x_intr=torch.zeros_like(case.x_intr), q=case.quat,
                 t=case.trans, k=case.intr[:, :NP])
    if not (torch.equal(f0, c_k) and all(map(torch.equal, p0, pts))):
        raise AssertionError(f"[{tag}] finish at a zero step: cost "
                             f"{float(f0)!r} vs total_cost {float(c_k)!r}, "
                             f"points equal "
                             f"{all(map(torch.equal, p0, pts))}")


def cost_note(r):
    """resjac, cost and finish's extra numbers for a log line (else '')."""
    if "bound_ms_full" not in r:
        return ""
    return (f"; every slot {r['bound_ms_full']:.4f} ms "
            f"({r['bytes_full'] / 1e6:.1f} MB); host wall per call "
            f"{r['call_host_ms']:.4f} ms, device ops per call "
            f"{r['device_ops'] or 'not recorded'}"
            + (f"; table {r['build_host_ms']:.4f} ms"
               if "build_host_ms" in r else "")
            + (f"; a call building its table {r['call_host_ms_table']:.4f} "
               f"ms" if "call_host_ms_table" in r else ""))


def device_ops(fn, tries=3):
    """Device operations (kernels, copies, fills) one call of fn() puts on
    the card, counted by torch.profiler; None if none of `tries` profiles
    recorded device activity (in phase 15 of this script none did)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
        if n:
            return n
    return None


def bound(name, case):
    """Least time for the kernel's work on this case: the larger of its
    bytes (each input read once, each output written once) over HBM rate
    and its f32 operations over the f32 rate. Operations count only the
    observations this data holds (masked slots are skipped or zero).
    resjac, cost and finish: the bytes this data needs (every mask, the
    indices and xy of the live slots, the points of the columns with a
    live slot; resjac's residual and J of every slot written, cost's
    nothing, finish's J of the live slots read, its per-column values and
    new points); `bound_ms_full` counts every slot's inputs."""
    NP, I, C = case.NP, case.I, case.C
    nj, nk = 9 + NP, 6 + NP
    f = 4  # bytes per f32 / i32
    nbytes = 0
    live_bytes = 0
    ops = 0
    for b in case.buckets:
        T, P = b.mask.shape
        TP = T * P
        n_obs = float((b.mask != 0).sum())
        idx = 2 * TP * f
        j_bytes = 2 * nj * TP * f
        if name == "resjac":
            nbytes += idx + 3 * TP * f + 4 * P * f + 2 * TP * f + j_bytes
            live_cols = float((b.mask != 0).any(0).sum())
            live_bytes += (TP * f + 4 * n_obs * f + 4 * live_cols * f
                           + 2 * TP * f + j_bytes)
            ops += n_obs * (120 + 40 * nj)
        elif name == "cost":
            nbytes += idx + 3 * TP * f + 3 * P * f
            live_cols = float((b.mask != 0).any(0).sum())
            live_bytes += TP * f + 4 * n_obs * f + 3 * live_cols * f
            ops += n_obs * 80
        elif name == "finish":
            nbytes += j_bytes + idx + 3 * TP * f + (3 + 1 + 6 + 3 + 3) * P * f
            live_bytes += (TP * f + (2 * nj + 4) * n_obs * f
                           + (3 + 1 + 6 + 3 + 3) * P * f)
            ops += n_obs * (4 * nk + 12 + 80) + 40 * P
        elif name == "prepare":
            nbytes += j_bytes + 2 * TP * f + idx + 9 * P * f
            ops += n_obs * (24 + 4 * nk + 4 * nk + 36 + 30 + 21 * 10) + 60 * P
        elif name == "matvec":
            nbytes += j_bytes + idx + 6 * P * f
            ops += n_obs * (4 * nk + 12 + 12 + 4 * nk) + 20 * P
    tables = (I * 7 * 2 + C * NP * 3 + I * 6 + C * NP) * f
    if name in ("prepare",):
        nbytes += (I * 33 + C * 2 * NP) * f
    elif name in ("matvec",):
        nbytes += 2 * (I * 6 + C * NP) * f
    else:
        nbytes += tables
        live_bytes += tables
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    if name not in ("resjac", "cost", "finish"):
        return dict(bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    bytes=nbytes)
    t_live = live_bytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_live, t_ops),
                bound_by="bytes" if t_live >= t_ops else "operations",
                bytes=live_bytes, bound_ms_full=max(t_bytes, t_ops),
                bytes_full=nbytes)


def camera_table(rng, model_id, omega):
    """Intrinsics and intr_free of an irregular case's cameras: three of
    one model, or for a tuple one camera per listed model (at least three,
    cycling), each with its model id in the selector column, then one
    camera whose selector names no listed model. FOV cameras at `omega`."""
    from pycolmap_torch.ops.camera_models import CAMERA_MODEL_BY_ID, MAX_PARAMS

    mixed = isinstance(model_id, tuple)
    models = model_id if mixed else (model_id,)
    NP = solver_num_params(model_id)
    C = max(3, len(models)) + mixed
    intr = np.zeros((C, max(MAX_PARAMS, NP)), np.float32)
    for c in range(C):
        info = CAMERA_MODEL_BY_ID[models[c % len(models)]]
        for i in info.focal_idxs:
            intr[c, i] = 400.0 + 30 * rng.normal()
        intr[c, info.principal_idxs[0]] = 320.0
        intr[c, info.principal_idxs[1]] = 240.0
        for i in info.extra_idxs:
            intr[c, i] = rng.uniform(-0.05, 0.05)
        if info.name == "FOV":
            intr[c, info.extra_idxs[0]] = omega
        if mixed:
            intr[c, NP - 1] = info.model_id
    if mixed:
        intr[C - 1, NP - 1] = min(set(range(12)) - set(models))
    intr_free = (rng.uniform(size=intr.shape) > 0.4).astype(np.float32)
    if mixed:
        intr_free[:, NP - 1] = 0.0
    return intr, intr_free


def irregular_cases(model_id, loss_type, dev, seed, omega=0.8, ragged=False):
    """The cameras of camera_table, buckets of T = 4, 8, 16 at widths that
    are no multiple of 128, mask holes, two images behind their points,
    partly fixed intrinsics and points. `ragged`: as bucketize pads, an
    empty [4, 128] bucket, then [8, 1000] and [16, 77] buckets whose
    columns hold tracks of lengths 1..T in turn (so tiles hold live slot
    rows up to different depths), the [8, 1000] one's last 200 columns
    padding (whole tiles of padding: mask 0, index 0, point 0, fixed)."""
    rng = np.random.default_rng(seed)
    I = 20
    quat = rng.normal(size=(I, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    trans = rng.normal(size=(I, 3)).astype(np.float32)
    trans[:, 2] += 10.0
    # every point lies far behind these two cameras (far, so that no point
    # moved by the back-substitution lands near the singular depth 0)
    trans[:2, 2] = -30.0
    intr, intr_free = camera_table(rng, model_id, omega)
    C = intr.shape[0]
    buckets = []
    shapes = (((4, 128, 0), (8, 1000, 800), (16, 77, 77)) if ragged
              else ((4, 300, 300), (8, 1000, 1000), (16, 77, 77)))
    for T, P, n_real in shapes:
        if ragged:
            lens = np.where(np.arange(P) < n_real, 1 + np.arange(P) % T, 0)
            mask = np.arange(T)[:, None] < lens[None]
        else:  # mask holes; a masked slot keeps its random index
            lens = np.ones(P)
            mask = rng.uniform(size=(T, P)) > 0.3
        pad = mask if ragged else np.ones((T, P), bool)
        b = bk.Bucket(
            img_idx=(rng.integers(0, I, (T, P)) * pad).astype(np.int32),
            cam_idx=(rng.integers(0, C, (T, P)) * pad).astype(np.int32),
            xy=(rng.uniform(0, 640, (2, T, P)) * pad).astype(np.float32),
            mask=mask.astype(np.float32),
            points=(rng.normal(size=(3, P)) * (lens > 0)).astype(np.float32),
            point_free=((rng.uniform(size=P) > 0.2) & (lens > 0))
            .astype(np.float32),
            point_rows=np.arange(P, dtype=np.int32),
        )
        buckets.append(bk.bucket_to(b, dev))
    t = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    return Case(buckets, t(quat), t(trans), t(intr), t(intr_free), model_id,
                loss_type, 1.5, seed)


def bench_case(dev):
    problem = make_synthetic_bundle(**BENCH)
    buckets = [bk.bucket_to(b, dev) for b in bk.bucketize(problem)]
    t = lambda a: a.to(dev).contiguous()  # noqa: E731
    return Case(buckets, t(problem.cam_quat), t(problem.cam_trans),
                t(problem.intrinsics), t(problem.intr_free),
                problem.model_id, 0, 1.0, 0), problem


# ---------------------------------------------------------------------------
# phases 3 and 4: the solver
# ---------------------------------------------------------------------------


def options(iters):
    o = BundleAdjustmentOptions()
    o.max_num_iterations = iters
    o.function_tolerance = 0.0
    o.print_summary = False
    return o


def medium_parity():
    """Phase 3: the f32 kernels' solve, card vs CPU (phase 11 compares the
    bf16 setting through the entry point). Both sides are pinned to the
    implicit PCG (``dense_schur_max_d=0``): at 32 images both would
    otherwise solve the dense system, which runs no matvec."""
    problem = make_synthetic_bundle(32, 8192, 6, refine_intrinsics=True)
    out = {}
    for dev in ("cuda", "cpu"):
        solver = ResidentBundleSolver(problem, options(MEDIUM_LM_ITERS),
                                      cg_iters=CG_ITERS, device=dev,
                                      cg_bf16=False, dense_schur_max_d=0)
        ck.reset_counts()
        t0 = time.perf_counter()
        s = solver.solve()
        if dev == "cuda":
            torch.cuda.synchronize()
            resjac = ck.LAUNCHES["resjac"]
        out[dev] = (s, solver.fetch_problem(), time.perf_counter() - t0)
        log(f"medium 32/8192 on {dev}: {s} in {out[dev][2]:.2f} s")
    # resjac once per LM step, for all buckets
    lm = out["cuda"][0].num_iterations
    log(f"medium 32/8192 on cuda: resjac {resjac} launches over {lm} LM "
        f"steps")
    if resjac != lm:
        raise AssertionError(f"phase 3: resjac launched {resjac} times in "
                             f"{lm} LM steps")
    (sg, pg, _), (sc, pc, _) = out["cuda"], out["cpu"]
    d_trans = float((pg.cam_trans - pc.cam_trans).abs().max())
    rel = abs(sg.final_cost - sc.final_cost) / max(abs(sc.final_cost), 1e-20)
    log(f"medium parity: final cost rel diff {rel:.3e} (tol 1e-3), "
        f"cam_trans max abs diff {d_trans:.3e} (tol 1e-3)")
    if not (rel <= 1e-3 and d_trans <= 1e-3):
        raise AssertionError("card and CPU solves disagree")
    if not sg.final_cost < sg.initial_cost:
        raise AssertionError("medium solve did not lower the cost")


def bench_solve(cg_bf16):
    """bench.py run_ba's sequence with the given CG matvec setting."""
    tag = "bf16" if cg_bf16 else "f32"
    problem = make_synthetic_bundle(**BENCH)
    torch.cuda.reset_peak_memory_stats()
    solver = ResidentBundleSolver(problem, options(LM_ITERS),
                                  cg_iters=CG_ITERS, device="cuda",
                                  cg_bf16=cg_bf16)
    t0 = time.perf_counter()
    warm = solver.solve()
    torch.cuda.synchronize()
    log(f"bench {tag} warm solve: {warm} in {time.perf_counter() - t0:.3f} s")
    solver.solve(max_iterations=1)

    def timed(iters, eps):
        solver.perturb_points(eps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = solver.solve(max_iterations=iters)  # ends in a host read
        return time.perf_counter() - t0, s, solver.last_result

    # the main path: every count zeroed just before, read just after
    ck.reset_counts()
    runs = [timed(LM_ITERS, 2e-6), timed(LM_ITERS, 3e-6)]
    ones = [timed(1, 4e-6), timed(1, 5e-6)]
    launches = dict(ck.LAUNCHES)
    plain_on_cuda = dict(ck.PLAIN_ON_CUDA)
    peak = torch.cuda.max_memory_allocated()

    dt, summary, res = min(runs, key=lambda r: r[0])
    dt1 = min(r[0] for r in ones)
    iters = max(summary.num_iterations, 1)
    marginal = (iters - 1) / (dt - dt1) if iters > 1 and dt > dt1 else None
    lm_steps = sum(r[1].num_iterations for r in runs + ones)
    per_step = {k: v / lm_steps for k, v in launches.items()}
    log(f"bench {tag} solve: {summary}; {iters / dt:.2f} LM it/s "
        f"whole-solve, marginal "
        f"{marginal if marginal is None else round(marginal, 2)} it/s; "
        f"1-iteration solve {dt1 * 1e3:.2f} ms")
    log(f"bench {tag}: cg iterations {res.cg_iterations} over {iters} LM "
        f"steps, host syncs {res.host_syncs}; peak device memory "
        f"{peak / 2**30:.3f} GiB")
    log(f"bench {tag} launches over {lm_steps} LM steps of 4 solves: "
        f"{launches}; per LM step "
        f"{json.dumps({k: round(v, 3) for k, v in per_step.items()})}")
    for r in runs + ones:
        s = r[1]
        if not (math.isfinite(s.initial_cost) and math.isfinite(s.final_cost)):
            raise AssertionError(f"non-finite cost: {s}")
    if not warm.final_cost < warm.initial_cost:
        raise AssertionError(f"bench cost did not fall: {warm}")
    unused = "matvec" if cg_bf16 else "matvec16"
    missing = [k for k in SINGLE_BA if launches[k] <= 0 and k != unused]
    if missing or launches[unused]:
        raise AssertionError(f"{tag}: kernels never launched on the main "
                             f"path: {missing}; {unused} launched "
                             f"{launches[unused]} times")
    # resjac, prepare and finish launch once per LM step, either matvec
    # once per CG iteration and the cost once per solve, each for all
    # buckets
    cg_total = sum(r[2].cg_iterations for r in runs + ones)
    name = "matvec16" if cg_bf16 else "matvec"
    want = {name: cg_total, "resjac": lm_steps, "prepare": lm_steps,
            "finish": lm_steps, "cost": len(runs + ones)}
    log(f"bench {tag}: {name} launches {launches[name]} over {cg_total} CG "
        f"iterations, resjac {launches['resjac']}, prepare "
        f"{launches['prepare']} and finish "
        f"{launches['finish']} over {lm_steps} LM steps, cost "
        f"{launches['cost']} over {len(runs + ones)} solves, "
        f"{len(solver._buckets[0])} buckets (expected {want})")
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"{tag}: launches "
                             f"{ {k: launches[k] for k in want} }, "
                             f"expected {want}")
    if any(plain_on_cuda.values()):
        raise AssertionError(f"plain versions ran on CUDA tensors: "
                             f"{plain_on_cuda}")
    rate = dict(whole=iters / dt, marginal=marginal, cg=res.cg_iterations,
                lm=iters)
    return launches, per_step, solver, rate


def profile_solve(solver):
    """torch.profiler over one more timed bench solve: device time per
    kernel and the device's busy share of the solve's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    solver.perturb_points(6e-6)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s = solver.solve(max_iterations=LM_ITERS)
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy = sum(dev_us(e) for e in rows) * 1e-6
    ops = sum(e.count for e in rows)
    cg = solver.last_result.cg_iterations
    log(f"profile: {s.num_iterations} LM steps, {cg} CG iterations in "
        f"{wall * 1e3:.2f} ms wall; device busy {busy * 1e3:.2f} ms "
        f"({100 * busy / wall:.1f}%), {ops} device ops "
        f"({ops / max(s.num_iterations, 1):.1f} per LM step, "
        f"{ops / max(cg, 1):.1f} per CG iteration)")
    for e in sorted(rows, key=dev_us, reverse=True)[:15]:
        log(f"profile:   {dev_us(e) / 1e3:9.3f} ms  x{e.count:5d}  "
            f"{e.key[:90]}")


# ---------------------------------------------------------------------------
# phase 6: the feature kernels against their plain versions
# ---------------------------------------------------------------------------


def make_u8(seed, H=SIFT_H, W=SIFT_W):
    """bench.py run_sift's image: 8-px blocks of noise plus pixel noise."""
    r = np.random.default_rng(seed)
    base = r.normal(0.5, 0.15, (H // 8, W // 8))
    img = np.kron(base, np.ones((8, 8))) + r.normal(0, 0.05, (H, W))
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def capture_sampler_inputs(img):
    """The sampler's inputs of octave 0 in one card extract of img, as
    sift passes them to ``sample_windows``: the orientation call, then the
    descriptor call."""
    calls = []
    wrapper = ws.sample_windows

    def record(*args):
        calls.append(args)
        return wrapper(*args)

    ws.sample_windows = record
    try:
        Sift().extract(img)
    finally:
        ws.sample_windows = wrapper
    return {"orientation": calls[0], "descriptor": calls[1]}


def irregular_sampler_inputs(dev, seed=7):
    """A 4-channel [256, 640, 4] volume with channel bases 0 and 2 (float2
    taps), 1 (two scalar taps) and 3 (a pair outside the volume: zeros);
    K = 37 (no multiple of 8); keypoints at the four borders, left of and
    above the volume (negative origins) and inside, each spreading its
    samples past its window so that taps fall outside the window (they
    count zero)."""
    g = torch.Generator().manual_seed(seed)
    vol = ws.interleave(torch.randn(4, 256, 640, generator=g))
    K, win_y, win_x = 37, 48, 256
    LHp, Wp = vol.shape[:2]
    ch0 = torch.tensor([0, 2, 1, 3, 0], dtype=torch.int32)[torch.arange(K) % 5]
    cy = torch.tensor([1.0, LHp - 2.0, -10.0, 120.0])[torch.arange(K) % 4]
    cx = torch.tensor([2.0, Wp - 3.0, -60.0, 250.0])[(torch.arange(K) // 4) % 4]
    wy = (torch.rand(K, 256, generator=g) - 0.5) * (win_y + 4)
    wx = (torch.rand(K, 256, generator=g) - 0.5) * (win_x - 64)
    ys = (cy[:, None] + wy).reshape(K, 16, 16)
    xs = (cx[:, None] + wx).reshape(K, 16, 16)
    return tuple(t.to(dev) for t in (vol, ch0, ys, xs)) + (win_y, win_x)


def sampler_bound(vol, ch0, ys, xs, win_y, win_x):
    """Bytes: coordinates and channel bases in, samples out, and the volume
    values this data's taps touch (inside the window), each once."""
    LHp, Wp, NC = vol.shape
    K = ys.shape[0]
    ysf, xsf = ys.reshape(K, -1), xs.reshape(K, -1)
    y0, x0 = ws.window_origins(ysf, xsf, LHp, Wp, win_y, win_x)
    iy = torch.floor(ysf).long() - y0.long()[:, None]
    ix = torch.floor(xsf).long() - x0.long()[:, None]
    c0 = ch0.long()[:, None]
    flat = []
    for ty in (0, 1):
        for tx in (0, 1):
            ry, rx = iy + ty, ix + tx
            ok = ((ry >= 0) & (ry < win_y) & (rx >= 0) & (rx < win_x)
                  & (c0 >= 0) & (c0 + 1 < NC))
            pix = (y0.long()[:, None] + ry) * Wp + x0.long()[:, None] + rx
            for c in (0, 1):
                flat.append((pix * NC + c0 + c)[ok])
    touched = int(torch.unique(torch.cat(flat)).numel())
    nbytes = K * 256 * 2 * 4 + K * 4 + K * 2 * 256 * 4 + touched * 4
    ops = K * 256 * 30  # weights, 4 taps of 2 channels, 8 FMAs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, touched_values=touched)


def check_sampler(tag, args, results=None):
    """The one-launch sampler against its plain path (window origins, then
    window-coordinate sampling) in float64; timed as the kernel alone, the
    whole ``sample_windows`` call (device time and host wall per call), the
    plain path, ``F.grid_sample`` of the channel pair and the bound."""
    vol, ch0, ys, xs, win_y, win_x = args
    out = torch.stack(ws.sample_windows(*args))
    ref = torch.stack(ws.sample_windows_plain(vol.double(), ch0, ys.double(),
                                              xs.double(), win_y, win_x))
    torch.cuda.synchronize()
    err = scaled_err(out, ref)
    if not err[1] <= TOL["window_sampler"]:
        raise AssertionError(f"[{tag}] window_sampler: scaled error "
                             f"{err[1]:.3e} > {TOL['window_sampler']:.0e}")
    log(f"phase 6 sampler {tag}: K {ys.shape[0]}, window {win_y}x{win_x}, "
        f"volume {tuple(vol.shape)}; max abs err {err[0]:.3e}")
    if results is None:
        return err
    # the kernel alone: its launcher on a preallocated output
    K = ys.shape[0]
    buf = torch.empty((2, K, 16, 16), device=vol.device)
    ysc, xsc = ys.contiguous(), xs.contiguous()
    kernel = lambda: features_cuda.sample_windows(  # noqa: E731
        vol, ch0, ysc, xsc, win_y, win_x, buf)
    # yardstick: grid_sample of the channel pair at the same samples, from
    # a channel-major copy (its layout) made before the timing
    LHp, Wp = vol.shape[:2]
    grid = torch.stack([2 * xs / (Wp - 1) - 1, 2 * ys / (LHp - 1) - 1],
                       -1).reshape(1, K, 256, 2)
    pair = vol[..., 0:2].permute(2, 0, 1)[None].contiguous()
    results[tag] = dict(
        max_abs_err=err[0], scaled_err=err[1],
        ms=time_gpu(kernel),
        call_ms=time_gpu(lambda: ws.sample_windows(*args)),
        call_host_ms=host_ms(lambda: ws.sample_windows(*args)),
        plain_ms=time_gpu(lambda: ws.sample_windows_plain(*args), 5),
        library_ms=time_gpu(lambda: torch.nn.functional.grid_sample(
            pair, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True)),
        **sampler_bound(*args),
    )
    del pair
    r = results[tag]
    log(f"phase 6 sampler {tag}: kernel {r['ms']:.4f} ms, whole call "
        f"{r['call_ms']:.4f} ms device / {r['call_host_ms']:.4f} ms host "
        f"wall, plain {r['plain_ms']:.3f} ms, grid_sample "
        f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}, {r['bytes'] / 1e6:.2f} MB, "
        f"{r['touched_values']} volume values touched); kernel / bound "
        f"{r['ms'] / r['bound_ms']:.2f}x, grid_sample / kernel "
        f"{r['library_ms'] / r['ms']:.3f}x")
    return err


def unit_rows(g, *shape):
    return torch.nn.functional.normalize(torch.randn(*shape, generator=g), dim=-1)


def check_top2(tag, d1, d2, n1, n2, results=None, phase="phase 6"):
    """Kernel vs plain (float64) over the rows < n1 of every pair."""
    kb, ks, ki = mk.top2_batch(d1, d2, n2)
    pb, ps, pi = mk.top2_plain(d1.double(), d2.double(), n2)
    torch.cuda.synchronize()
    rows = torch.arange(d1.shape[1], device=d1.device)[None] < n1[:, None]
    err_b = scaled_err(kb[rows], pb[rows])
    err_s = scaled_err(ks[rows], ps[rows])
    err = (max(err_b[0], err_s[0]), max(err_b[1], err_s[1]))
    clear = rows & ((pb - ps) > TOP2_MARGIN)
    bad_idx = int((ki.long() != pi.long())[clear].sum())
    if not (err[1] <= TOL["top2"] and bad_idx == 0):
        raise AssertionError(f"[{tag}] top2: similarity error {err[1]:.3e} "
                             f"(tol {TOL['top2']:.0e}), {bad_idx} indices "
                             f"differ where the margin exceeds {TOP2_MARGIN}")
    log(f"{phase} top2 {tag}: B {d1.shape[0]}, N1 {d1.shape[1]}, N2 "
        f"{d2.shape[1]}, n1 {n1.tolist()}, n2 {n2.tolist()}; max abs err "
        f"{err[0]:.3e}, index checks on {int(clear.sum())} rows")
    if results is None:
        return err
    D = d1.shape[2]
    pairs = list(zip(n1.tolist(), n2.tolist()))
    ops = sum(2 * a * b * D for a, b in pairs)
    nbytes = sum((a + b) * D * 4 + a * 12 for a, b in pairs)
    # the kernel's work: three TF32 products (hi.hi', hi.lo', lo.hi') on
    # the tensor cores; the first port's f32 SIMT figure stays beside it
    t_ops = 3 * ops / TF32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    # yardstick: two PyTorch calls, the full product and topk over it
    results[tag] = dict(
        max_abs_err=err[0], scaled_err=err[1],
        ms=time_gpu(lambda: mk.top2_batch(d1, d2, n2)),
        call_host_ms=host_ms(lambda: mk.top2_batch(d1, d2, n2), 50),
        plain_ms=time_gpu(lambda: mk.top2_plain(d1, d2, n2), 5),
        library_ms=time_gpu(lambda: torch.topk(
            torch.matmul(d1, d2.transpose(1, 2)), 2, dim=2)),
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        bound_note="3xTF32: 3 x 2 N1 N2 D flops at 495 TFLOP/s",
        bound_ms_f32=max(ops / F32_FLOPS * 1e3, t_bytes),
        gflop=ops / 1e9,
        split=mk.top2_split(d1.shape[0], d1.shape[1], d2.shape[1],
                            torch.cuda.get_device_properties(0)
                            .multi_processor_count),
    )
    r = results[tag]
    log(f"{phase} top2 {tag}: kernel {r['ms']:.4f} ms "
        f"({r['gflop'] / r['ms']:.2f} TFLOP/s of f32 products, split "
        f"{r['split']}), host wall per call {r['call_host_ms']:.4f} ms, "
        f"plain {r['plain_ms']:.3f} ms, matmul+topk {r['library_ms']:.4f} "
        f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, 3xTF32; f32 "
        f"SIMT {r['bound_ms_f32']:.4f} ms)")
    return err


def feature_kernels():
    dev = torch.device("cuda")
    results = {}
    captured = capture_sampler_inputs(make_u8(100))
    for tag in ("orientation", "descriptor"):
        check_sampler(tag, captured[tag], results)
    del captured
    check_sampler("irregular", irregular_sampler_inputs(dev))

    g = torch.Generator().manual_seed(3)
    d1 = unit_rows(g, 1, 8192, 128).to(dev)
    d2 = unit_rows(g, 1, 8192, 128).to(dev)
    d2[0, 100:110] = d2[0, 0:10]  # exact duplicates: ties
    full = torch.tensor([8192], device=dev)
    check_top2("8192x8192", d1, d2, full, full.int(), results)
    del d1, d2
    # ragged batch: 3 pairs padded to 1000 rows and columns
    n1 = torch.tensor([300, 1000, 77], device=dev)
    n2 = torch.tensor([1000, 77, 300], device=dev, dtype=torch.int32)
    r1 = unit_rows(g, 3, 1000, 128).to(dev)
    r2 = unit_rows(g, 3, 1000, 128).to(dev)
    r1 = r1 * (torch.arange(1000, device=dev)[None, :, None] < n1[:, None, None])
    check_top2("ragged", r1, r2, n1, n2)
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phases 7 and 8: SIFT and matching end to end
# ---------------------------------------------------------------------------


def _wrap(a):
    return np.abs(np.angle(np.exp(1j * np.asarray(a, np.float64))))


def compare_features(ref, got, tag):
    """The CPU parity tests' keypoint-set criterion: >= 97% of ref's
    keypoints have a pair in got within 0.01 px and 1e-3 in scale (the
    nearest in orientation), and paired descriptors differ by at most one
    uint8 step (1/512)."""
    (kr, dr), (kg, dg) = ref, got
    pair = -np.ones(len(kr), int)
    for n, k in enumerate(kr):
        c = np.nonzero((np.hypot(kg[:, 0] - k[0], kg[:, 1] - k[1]) < 0.01)
                       & (np.abs(kg[:, 2] - k[2]) < 1e-3))[0]
        if len(c):
            pair[n] = c[np.argmin(_wrap(kg[c, 3] - k[3]))]
    ok = pair >= 0
    frac = float(ok.mean()) if len(ok) else 0.0
    d_err = float(np.abs(dg[pair[ok]] - dr[ok]).max()) if ok.any() else math.inf
    a_err = float(_wrap(kg[pair[ok], 3] - kr[ok, 3]).max()) if ok.any() else math.inf
    log(f"{tag}: {len(kr)} vs {len(kg)} keypoints, {100 * frac:.2f}% paired, "
        f"max descriptor diff {d_err:.5f}, max angle diff {a_err:.2e} rad")
    if not (len(kr) > 50 and frac >= 0.97 and d_err <= 1 / 512 + 1e-7
            and a_err < 1e-3):
        raise AssertionError(f"{tag}: keypoint sets disagree")


def sift_parity():
    img = make_u8(11, 240, 320)
    cpu = Sift(device="cpu").extract(img)
    card = Sift().extract(img)
    compare_features(cpu, card, "phase 7 SIFT 240x320 card vs CPU")


def shift_check(k1, k2, m, tag):
    dx = k2[m[:, 1], 0] - k1[m[:, 0], 0]
    good = float((np.abs(dx - 5) < 1.5).mean()) if len(m) else 0.0
    log(f"{tag}: {len(m)} matches of {len(k1)}/{len(k2)} keypoints, "
        f"{100 * good:.2f}% at dx = 5 +- 1.5 px")
    if not (len(m) > 0.3 * min(len(k1), len(k2)) and good > 0.85):
        raise AssertionError(f"{tag}: shifted-pair matches fail the check")


def _buckets(feats):
    return len({(max(256, 1 << (len(a) - 1).bit_length()),
                 max(256, 1 << (len(b) - 1).bit_length())) for a, b in feats})


def front_end():
    """bench.py run_sift's methodology on the port, then matching. Every
    launch count is zeroed just before the timed work and read after."""
    s = Sift()
    imgs = [make_u8(i) for i in range(8)]
    shifted = [np.roll(im, 5, axis=1) for im in imgs[:4]]
    s.extract(imgs[0])  # warm
    s.extract_batch(imgs[0:4])

    ws.reset_counts()
    mk.reset_counts()
    extracts = 0

    def single(idxs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in idxs:
            s.extract(imgs[i])
        return (time.perf_counter() - t0) / len(idxs)

    single_ms = min(single([1, 2, 3, 4, 5, 6]),
                    single([7, 2, 4, 6, 1, 3])) * 1e3
    extracts += 12

    def batch(ims):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = s.extract_batch(ims)
        return (time.perf_counter() - t0) / len(ims), out

    b1, feats = batch(imgs[4:8])
    b2, _ = batch([imgs[2], imgs[5], imgs[1], imgs[7]])
    batch_ms = min(b1, b2) * 1e3
    extracts += 8
    kps = [len(k) for k, _ in feats]
    base = s.extract_batch(imgs[:4])
    moved = s.extract_batch(shifted)
    extracts += 8

    # one cross-checked pair, timed twice
    (k1, d1), (k2, d2) = base[0], moved[0]
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        m = fm.match_descriptors(d1, d2)
        times.append(time.perf_counter() - t0)
    match_ms = min(times) * 1e3
    singles = 2
    # four pairs in one batched call, timed twice
    pairs = [(d_a, d_b) for (_, d_a), (_, d_b) in zip(base, moved)]
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        mb = fm.match_descriptors_batch(pairs)
        times.append(time.perf_counter() - t0)
    batch_match_ms = min(times) / len(pairs) * 1e3
    batch_calls = 2
    launches = {"window_sampler": ws.LAUNCHES["window_sampler"],
                "top2": mk.LAUNCHES["top2"]}
    plain_on_cuda = ws.PLAIN_ON_CUDA["window_sampler"] + mk.PLAIN_ON_CUDA["top2"]

    expect = {"window_sampler": 8 * extracts,
              "top2": 2 * singles + 2 * _buckets(pairs) * batch_calls}
    log(f"phase 8 SIFT {SIFT_H}x{SIFT_W}: single {single_ms:.3f} ms/image "
        f"(best of two passes over 6), batch of 4 {batch_ms:.3f} ms/image; "
        f"keypoints per image {kps} (mean {np.mean(kps):.1f})")
    log(f"phase 8 matching: one cross-checked pair {match_ms:.3f} ms "
        f"({len(d1)} x {len(d2)} descriptors), batch of 4 pairs "
        f"{batch_match_ms:.3f} ms/pair")
    log(f"phase 8 launches: {launches} over {extracts} extracts, "
        f"{singles} single matches and {batch_calls} batch calls; expected "
        f"{expect}")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    if plain_on_cuda:
        raise AssertionError("plain versions ran on CUDA tensors")

    shift_check(k1, k2, m, "phase 8 shifted pair (card)")
    for i, mm in enumerate(mb):
        shift_check(base[i][0], moved[i][0], mm, f"phase 8 batch pair {i}")
    if not np.array_equal(mb[0], m):
        raise AssertionError("batched and single matching disagree")
    cpu = fm.match_descriptors(d1, d2, device="cpu")
    a = {tuple(r) for r in m.tolist()}
    b = {tuple(r) for r in cpu.tolist()}
    jac = len(a & b) / max(len(a | b), 1)
    log(f"phase 8 card vs CPU matches of the shifted pair: {len(a)} vs "
        f"{len(b)}, Jaccard {jac:.4f} (tol 0.99)")
    if jac < 0.99:
        raise AssertionError("card and CPU match sets disagree")
    top2_res = phase8_top2(pairs)
    return launches, dict(single_ms=single_ms, batch_ms=batch_ms,
                          keypoints=float(np.mean(kps)), match_ms=match_ms,
                          batch_match_ms=batch_match_ms), top2_res, (k1, k2, m)


def phase8_top2(pairs):
    """top-2 against its plain version and timed at phase 8's shapes (after
    the main path's counts are read): the first pair as the single match
    launches it, and the four pairs padded to powers of two in one batch,
    as match_descriptors_batch launches them."""
    dev = torch.device("cuda")
    results = {}
    units = [(fm._to_unit_float(a), fm._to_unit_float(b)) for a, b in pairs]
    u1, u2 = units[0]
    n1 = torch.tensor([len(u1)], device=dev)
    check_top2("phase 8 pair", torch.from_numpy(u1)[None].to(dev),
               torch.from_numpy(u2)[None].to(dev), n1,
               torch.tensor([len(u2)], device=dev, dtype=torch.int32),
               results, phase="phase 8")
    n1p = max(256, 1 << (max(len(a) for a, _ in units) - 1).bit_length())
    n2p = max(256, 1 << (max(len(b) for _, b in units) - 1).bit_length())
    D1 = np.zeros((len(units), n1p, 128), np.float32)
    D2 = np.zeros((len(units), n2p, 128), np.float32)
    for k, (a, b) in enumerate(units):
        D1[k, :len(a)], D2[k, :len(b)] = a, b
    check_top2("phase 8 batch", torch.from_numpy(D1).to(dev),
               torch.from_numpy(D2).to(dev),
               torch.tensor([len(a) for a, _ in units], device=dev),
               torch.tensor([len(b) for _, b in units], device=dev,
                            dtype=torch.int32), results, phase="phase 8")
    torch.cuda.empty_cache()
    return results


def profile_extract():
    """torch.profiler over one full-width extract: device time per kernel
    and the device's busy share of its wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    s = Sift()
    img = make_u8(9)
    s.extract(img)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s.extract(img)
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy = sum(dev_us(e) for e in rows) * 1e-6
    log(f"phase 9 profile: one {SIFT_H}x{SIFT_W} extract in "
        f"{wall * 1e3:.2f} ms wall; device busy {busy * 1e3:.2f} ms "
        f"({100 * busy / wall:.1f}%), {sum(e.count for e in rows)} device ops")
    for e in sorted(rows, key=dev_us, reverse=True)[:15]:
        log(f"phase 9 profile:   {dev_us(e) / 1e3:9.3f} ms  x{e.count:5d}  "
            f"{e.key[:90]}")


# ---------------------------------------------------------------------------
# phase 10: the Schur kernels against their plain versions, and their modes
# ---------------------------------------------------------------------------


def capture_schur_inputs():
    """The operands of the first schur_prepare and the first bf16 CG matvec
    of one LM step of the bench solve (the main path, through recording
    wrappers): prepare's (buckets, J_l, res_l, lam, I, C) and the matvec's
    (buckets, J16_l, Vinv_l, x_pose, x_intr, I, C)."""
    calls = {}
    wrappers = {"schur_prepare": ck.schur_prepare,
                "schur_matvec16": ck.schur_matvec16}

    def recorder(name):
        def record(*args, **kw):
            calls.setdefault(name, args)
            return wrappers[name](*args, **kw)
        return record

    for name in wrappers:
        setattr(ck, name, recorder(name))
    try:
        solver = ResidentBundleSolver(make_synthetic_bundle(**BENCH),
                                      options(1), cg_iters=CG_ITERS,
                                      device="cuda")
        solver.solve()
    finally:
        for name, fn in wrappers.items():
            setattr(ck, name, fn)
    return calls["schur_prepare"], calls["schur_matvec16"]


def schur_bound(kind, buckets, J_l, I, C):
    """Bytes: J (2 B a value in bf16, 4 in f32), the index grids, and Vinv
    (matvecs) or the residuals (prepare) read once, x in and S x out
    (matvecs) or Vinv, g_pt and the image and camera rows out (prepare);
    operations: phase 2's counts (bound()) on this data's observations."""
    bf16 = kind == "matvec16"
    NP = (J_l[0].shape[0] if bf16 else J_l[0].shape[1]) - 9
    nk = 6 + NP
    if kind == "prepare":
        nbytes = (I * 33 + C * 2 * NP) * 4
    else:
        nbytes = 2 * (I * 6 + C * NP) * 4
    ops = 0
    for b, J in zip(buckets, J_l):
        T, P = b.mask.shape
        n_obs = float(b.mask.sum())
        nbytes += J.numel() * J.element_size() + 2 * T * P * 4
        if kind == "prepare":
            nbytes += 2 * T * P * 4 + 9 * P * 4
            ops += n_obs * (24 + 8 * nk + 36 + 30 + 21 * 10) + 60 * P
        else:
            nbytes += 6 * P * 4
            ops += n_obs * (8 * nk + 24) + 20 * P
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes)


def _one_launch(kind, tag, call):
    """call() with a check that it launched `kind` once for all buckets."""
    before = ck.LAUNCHES[kind]
    out = call()
    if ck.LAUNCHES[kind] != before + 1:
        raise AssertionError(f"[{tag}] {kind}: {ck.LAUNCHES[kind] - before} "
                             f"launches in one call, expected 1")
    return out


def _check_schur(kind, tag, call, plain, buckets, J_l, I, C, NP, results,
                 phase):
    """One Schur kernel (`call`: its wrapper on the card) against `plain`
    (its plain version in a dtype) in float64, one launch per call, and in
    the fixed-order mode the same bits from a second call; with `results`,
    timed beside its plain version in f32 and its bound."""
    got = [t.clone() for t in _one_launch(kind, tag, call)]
    errs = [scaled_err(g.reshape(-1), r.reshape(-1))
            for g, r in zip(got, plain(torch.float64))]
    err = (max(e[0] for e in errs), max(e[1] for e in errs))
    torch.cuda.synchronize()
    if not err[1] <= TOL[kind]:
        raise AssertionError(f"[{tag}] {kind}: kernel vs plain scaled error "
                             f"{err[1]:.3e} > {TOL[kind]:.0e}")
    config = sfm_cuda.tile_config(ck.TILE_KINDS.index(kind), NP, I, C)
    again = call()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    if config["sums"] == ck.SUMS_FIXED and not same:
        raise AssertionError(f"[{tag}] {kind}: two calls differ")
    shapes = [tuple(b.mask.shape) for b in buckets]
    log(f"{phase} {kind} {tag}: NP {NP}, I {I}, C {C}, buckets [T, P] "
        f"{shapes}; sums {SUMS[config['sums']]} "
        f"({config['smem_bytes']} B shared, {config['blocks_per_sm']} "
        f"blocks per SM, {config['clusters']} clusters); scaled err "
        f"{err[1]:.2e} (max abs {err[0]:.3e}); "
        f"a second call bit-equal: {same}")
    if results is None:
        return err
    results[tag] = dict(
        max_abs_err=err[0], scaled_err=err[1], I=I,
        sums=SUMS[config["sums"]], blocks_per_sm=config["blocks_per_sm"],
        clusters=config["clusters"],
        ms=time_gpu(call), call_host_ms=host_ms(call),
        plain_ms=time_gpu(lambda: plain(torch.float32), 5),
        **schur_bound(kind, buckets, J_l, I, C),
    )
    r = results[tag]
    log(f"{phase} {kind} {tag}: kernel {r['ms']:.4f} ms, host wall per "
        f"call {r['call_host_ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
        f"{r['bytes'] / 1e6:.1f} MB)")
    return err


def check_matvec(kind, tag, buckets, J_l, Vinv_l, x_pose, x_intr, I, C,
                 results=None, phase="phase 10"):
    """The bf16 (`kind` "matvec16", J16 [9+NP, 2T, P]) or f32 ("matvec")
    matvec vs its plain version in float64 on the same J values, with one
    table for both calls, as the CG loop of an LM step uses it."""
    bf16 = kind == "matvec16"
    NP = (J_l[0].shape[0] if bf16 else J_l[0].shape[1]) - 9
    wrapper = ck.schur_matvec16 if bf16 else ck.schur_matvec
    launch = ck.matvec_launch(kind, buckets, J_l, Vinv_l, I, C)

    def call():
        return wrapper(buckets, J_l, Vinv_l, x_pose, x_intr, I, C,
                       launch=launch)

    def plain(dt):
        mp = torch.zeros((I, 6), device=x_pose.device, dtype=dt)
        mi = torch.zeros((C, NP), device=x_pose.device, dtype=dt)
        for b, J, V in zip(buckets, J_l, Vinv_l):
            args = (V.to(dt), x_pose.to(dt), x_intr[:, :NP].to(dt), I, C)
            op, oi = (ck.matvec16_plain(b, J, *args) if bf16
                      else ck.matvec_plain(b, J.to(dt), *args))
            mp, mi = mp + op, mi + oi
        return mp, mi

    return _check_schur(kind, tag, call, plain, buckets, J_l, I, C, NP,
                        results, phase)


def check_prepare(tag, buckets, J_l, res_l, lam, I, C, results=None,
                  phase="phase 10"):
    """prepare vs its plain version in float64: every output, the
    per-bucket Vinv and g_pt included."""
    NP = J_l[0].shape[1] - 9

    def call():
        out = ck.schur_prepare(buckets, J_l, res_l, lam, I, C)
        return list(out[0]) + list(out[1]) + list(out[2:])

    def plain(dt):
        acc_i = torch.zeros((I, 33), device=lam.device, dtype=dt)
        acc_c = torch.zeros((C, 2 * NP), device=lam.device, dtype=dt)
        vs, gs = [], []
        for b, J, r in zip(buckets, J_l, res_l):
            v, g, oi, oc = ck.prepare_plain(b, J.to(dt), r.to(dt),
                                            lam.to(dt), I, C)
            vs.append(v)
            gs.append(g)
            acc_i, acc_c = acc_i + oi, acc_c + oc
        return vs + gs + [acc_i[:, :6], acc_c[:, :NP], acc_i[:, 6:12],
                          acc_c[:, NP:], acc_i[:, 12:33]]

    return _check_schur("prepare", tag, call, plain, buckets, J_l, I, C, NP,
                        results, phase)


def pad_cols(t, mult):
    """t with zero columns appended to a multiple of `mult` (last dim)."""
    w = -(-t.shape[-1] // mult) * mult
    return torch.nn.functional.pad(t, (0, w - t.shape[-1])).contiguous()


def pad_bucket(b, mult):
    """A bucket padded to a multiple of `mult` columns, as bucketize pads
    (padded columns: mask 0, index 0)."""
    return bk.Bucket(*(pad_cols(t, mult) for t in b))


def ladder_widths(case):
    """The case with each bucket padded to a multiple of 128 columns, as
    bucketize pads (padded columns: mask 0, index 0, all-zero J)."""
    out = copy.copy(case)
    out.buckets = [pad_bucket(b, 128) for b in case.buckets]
    return out


def check_case_schur(tag, case, phase, results=None):
    """prepare, the f32 matvec and the bf16 matvec (check_prepare,
    check_matvec) on a case's own J, residuals and Vinv, as the kernels of
    an LM step give them, at ladder widths. `results`: per kernel, the
    timings under `tag`. Returns each kernel's error."""
    case = ladder_widths(case)
    res_l, J_l = ck.res_and_jac(case.buckets, case.pts, case.quat,
                                case.trans, case.intr, case.intr_free,
                                case.model_id, case.loss_type,
                                case.loss_scale)
    Vinv_l = ck.schur_prepare(case.buckets, J_l, res_l, case.lam, case.I,
                              case.C)[0]
    args = (case.x_pose, case.x_intr, case.I, case.C)
    results = results or {}
    return {
        "prepare": check_prepare(tag, case.buckets, J_l, res_l, case.lam,
                                 case.I, case.C, results.get("prepare"),
                                 phase),
        "matvec": check_matvec("matvec", tag, case.buckets, J_l, Vinv_l,
                               *args, results=results.get("matvec"),
                               phase=phase),
        "matvec16": check_matvec("matvec16", tag, case.buckets,
                                 [ck.pack_j_bf16(J) for J in J_l], Vinv_l,
                                 *args, results=results.get("matvec16"),
                                 phase=phase),
    }


def spread_images(buckets, x_pose, I0, I):
    """Bench buckets over I images (a multiple of I0 = 128): the columns of
    each run of 1024 points see the bench's images shifted by I0 (run %
    (I / I0)), so co-visible images stay local as in a large scene; J,
    residuals, Vinv and the CG direction stay the bench's, x_pose repeated
    per I0 images. Returns (buckets, x_pose)."""
    out = []
    for b in buckets:
        col = torch.arange(b.img_idx.shape[1], device=b.img_idx.device)
        shift = I0 * ((col // 1024) % (I // I0))
        out.append(b._replace(img_idx=(b.img_idx + shift).int().contiguous()))
    return out, x_pose.repeat(I // I0, 1).contiguous()


def schur_kernels():
    """Phase 10. Returns per Schur kernel its numbers at the bench's
    captured operands, with those at larger I under "larger"."""
    dev = torch.device("cuda")
    (buckets, J_l, res_l, lam, I0, C), mv16 = capture_schur_inputs()
    J16_l, Vinv_l, x_pose, x_intr = mv16[1:5]
    results = {k: {} for k in ck.TILE_KINDS}

    def check_all(tag, b_l, xp, I):
        check_matvec("matvec16", tag, b_l, J16_l, Vinv_l, xp, x_intr, I, C,
                     results=results["matvec16"])
        check_matvec("matvec", tag, b_l, J_l, Vinv_l, xp, x_intr, I, C,
                     results=results["matvec"])
        check_prepare(tag, b_l, J_l, res_l, lam, I, C,
                      results=results["prepare"])

    check_all("bench", buckets, x_pose, I0)
    # larger reconstructions, each checked and timed: at NP 4 with one
    # camera each kernel moves from its fixed-order or block sums to global
    # atomics as the images grow
    for I in MATVEC16_IMAGES:
        check_all(f"{I} images", *spread_images(buckets, x_pose, I0, I), I)
    del J_l, res_l, J16_l, Vinv_l
    torch.cuda.empty_cache()
    # NP 3, 5, 8, 12 (SIMPLE_PINHOLE, RADIAL, OPENCV, FULL_OPENCV), three
    # cameras, buckets of widths 300, 1000 and 77 padded to the ladder's;
    # 20 images: each kernel sums in its fixed order
    for model_id in (0, 3, 4, 6):
        case = irregular_cases(model_id, 0, dev, seed=20 + model_id)
        check_case_schur(f"irregular model {model_id}", case, "phase 10")
    # one launch for an empty [4, 128] bucket (all-zero J, index 0) beside
    # two non-empty ones
    case = ladder_widths(irregular_cases(2, 0, dev, seed=29))
    res_c, J_c = ck.res_and_jac(case.buckets, case.pts, case.quat,
                                case.trans, case.intr, case.intr_free,
                                case.model_id, case.loss_type,
                                case.loss_scale)
    Vinv_c = ck.schur_prepare(case.buckets, J_c, res_c, case.lam, case.I,
                              case.C)[0]
    zi = torch.zeros((4, 128), dtype=torch.int32, device=dev)
    empty = case.buckets[0]._replace(img_idx=zi, cam_idx=zi,
                                     mask=torch.zeros((4, 128), device=dev))
    check_matvec("matvec16", "empty + 2 buckets", [empty] + case.buckets[1:],
                 [torch.zeros((9 + case.NP, 8, 128), dtype=torch.bfloat16,
                              device=dev)]
                 + [ck.pack_j_bf16(J) for J in J_c[1:]],
                 [torch.zeros((6, 128), device=dev)] + Vinv_c[1:],
                 case.x_pose, case.x_intr, case.I, case.C)
    out = {}
    for kind, r in results.items():
        bench = r.pop("bench")
        out[kind] = dict(bench, larger=r)
    return out


# ---------------------------------------------------------------------------
# phase 11: bundle_adjustment(reconstruction)
# ---------------------------------------------------------------------------


def reconstruction_from_bundle(problem, cameras=None, xy=None):
    """A Reconstruction of the port's scene classes holding a synthetic
    bundle's initial state: image i's keypoints are its observations
    (`xy`, default the bundle's), point j's track the observations of j.
    Image i sees through cameras[i % len(cameras)]; the default is the
    bundle's one SIMPLE_RADIAL camera."""
    intr = problem.intrinsics[0].double().numpy()
    quat = problem.cam_quat.double().numpy()  # wxyz
    trans = problem.cam_trans.double().numpy()
    obs_img = problem.obs_image_idx.numpy()
    obs_pt = problem.obs_point_idx.numpy()
    if xy is None:
        xy = problem.obs_xy.double().numpy()
    if cameras is None:
        cameras = [Camera(1, "SIMPLE_RADIAL", int(2 * intr[1]),
                          int(2 * intr[2]), intr[:4])]
    rec = Reconstruction()
    for cam in cameras:
        rec.add_camera(cam)
    kp_idx = np.zeros(len(obs_img), np.int64)
    for i in range(problem.num_images):
        sel = np.nonzero(obs_img == i)[0]
        kp_idx[sel] = np.arange(len(sel))
        img = Image(name=f"image{i:04d}.jpg",
                    camera_id=cameras[i % len(cameras)].camera_id, id=i + 1,
                    keypoints_xy=xy[sel])
        img.cam_from_world = Rigid3d(Rotation3d(quat[i, [1, 2, 3, 0]]),
                                     trans[i])
        img.registered = True
        rec.add_image(img)
    order = np.argsort(obs_pt, kind="stable")
    bounds = np.searchsorted(obs_pt[order], np.arange(problem.num_points + 1))
    points = problem.points.double().numpy()
    for j in range(problem.num_points):
        ms = order[bounds[j]:bounds[j + 1]]
        rec.add_point3D(points[j], Track([
            TrackElement(int(obs_img[m]) + 1, int(kp_idx[m])) for m in ms]))
    return rec


def model_bundle_adjustment(tmp):
    """The entry point at full width: read, adjust, write."""
    t0 = time.perf_counter()
    rec = reconstruction_from_bundle(make_synthetic_bundle(**BENCH))
    t1 = time.perf_counter()
    rec.write_binary(tmp / "bench_in")
    t2 = time.perf_counter()
    rec = Reconstruction(tmp / "bench_in")
    t3 = time.perf_counter()
    err0 = rec.compute_mean_reprojection_error()
    n_obs = rec.compute_num_observations()
    split = {}
    ck.reset_counts()
    t4 = time.perf_counter()
    summary = psfm.bundle_adjustment(rec, timings=split)
    t5 = time.perf_counter()
    launches = dict(ck.LAUNCHES)
    err1 = rec.compute_mean_reprojection_error()
    rec.write_binary(tmp / "bench_out")
    t6 = time.perf_counter()
    log(f"phase 11 model: {rec.num_reg_images} images, {rec.num_points3D} "
        f"points, {n_obs} observations; built in {t1 - t0:.2f} s, written "
        f"in {t2 - t1:.2f} s")
    log(f"phase 11 bundle_adjustment: {summary}; mean reprojection error "
        f"{err0:.4f} -> {err1:.4f} px; launches {launches}")
    log(f"phase 11 wall: read {t3 - t2:.3f} s, entry point {t5 - t4:.3f} s "
        f"(problem build {split['build']:.3f} s, solve {split['solve']:.3f} "
        f"s, write back {split['write_back']:.3f} s), model write "
        f"{t6 - t5:.3f} s")
    if not (summary.final_cost < summary.initial_cost and err1 < err0):
        raise AssertionError("phase 11: cost or reprojection error did not "
                             "fall")
    missing = [k for k in SINGLE_BA if launches[k] <= 0 and k != "matvec"]
    if missing or launches["matvec"]:
        raise AssertionError(f"phase 11: kernels never launched {missing}; "
                             f"f32 matvec launched {launches['matvec']}")
    if launches["resjac"] != summary.num_iterations:  # once per LM step
        raise AssertionError(f"phase 11: resjac launched "
                             f"{launches['resjac']} times in "
                             f"{summary.num_iterations} LM steps")
    return dict(read_s=t3 - t2, entry_s=t5 - t4, lm=summary.num_iterations,
                err0=err0, err1=err1, launches=launches, **split)


def model_ba_parity(tmp, rec=None, tag="phase 11 medium 32/8192 bf16",
                    kwargs=(("cuda", {}),
                            ("cpu", dict(device="cpu", cg_bf16=True))),
                    dense_schur_max_d=0):
    """32 images (`rec`, default phase 11's scene): the card (bf16, its
    default) vs the CPU with the bf16 setting through the plain versions,
    both with `dense_schur_max_d` (0: the implicit PCG, whose matvecs the
    bf16 setting changes; None: the defaults, which solve 32 images
    densely on both)."""
    if rec is None:
        rec = reconstruction_from_bundle(
            make_synthetic_bundle(32, 8192, 6, refine_intrinsics=True))
    rec.write_binary(tmp / "medium")
    opts = options(MEDIUM_LM_ITERS)
    got = {}
    for dev, kw in kwargs:
        r = Reconstruction(tmp / "medium")
        got[dev] = (psfm.bundle_adjustment(
            r, opts, dense_schur_max_d=dense_schur_max_d, **kw), r)
    (sg, rg), (sc, rc) = got["cuda"], got["cpu"]
    rel = abs(sg.final_cost - sc.final_cost) / max(abs(sc.final_cost), 1e-20)
    d_trans = max(float(np.abs(rg.images[i].cam_from_world.translation
                               - rc.images[i].cam_from_world.translation).max())
                  for i in rg.images)
    log(f"{tag}: card {sg}, CPU {sc}; final cost rel diff {rel:.3e} (tol "
        f"1e-3), translation max abs diff {d_trans:.3e} (tol 1e-3)")
    if not (rel <= 1e-3 and d_trans <= 1e-3 and sg.final_cost < sg.initial_cost):
        raise AssertionError(f"{tag}: card and CPU solves disagree")


# ---------------------------------------------------------------------------
# phase 12: triangulate_points
# ---------------------------------------------------------------------------


def write_sequential_database(path, num_images, num_points, pixel_noise=0.4,
                              seed=0):
    """tests/test_incremental_mapping.py make_synthetic_database's
    mode="sequential" with the port's Database: a forward-moving trajectory
    over an extended scene, ground-truth keypoints plus noise in a random
    order, verified pairs of every two images that share >= 30 points.
    The camera steps 1.0 instead of 0.3, so that a point is seen by about
    6 images; descriptors are not written (triangulation does not read
    them). Returns the ground-truth model (poses and keypoints, no points)
    and each image's keypoint -> true point ids."""
    rng = np.random.default_rng(seed)
    cam = Camera.create(1, "SIMPLE_PINHOLE", 600.0, 640, 480)
    step = 1.0
    span = num_images * step + 5.0
    points = np.stack([rng.uniform(-1.0, span, num_points),
                       rng.uniform(-2.0, 2.0, num_points),
                       rng.uniform(4.0, 7.0, num_points)], axis=1)
    gt = Reconstruction()
    gt.add_camera(cam)
    kp_pid = []
    for i in range(num_images):
        yaw = 0.08 * np.sin(0.3 * i)
        c, s = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
        center = np.array([i * step, 0.1 * np.sin(0.5 * i), 0.0])
        pose = Rigid3d(Rotation3d(R_wc), -R_wc @ center)
        p_cam = pose * points
        xy = cam.img_from_cam(p_cam[:, :2] / p_cam[:, 2:])
        vis = ((p_cam[:, 2] > 0.2) & (xy[:, 0] >= 0) & (xy[:, 0] < cam.width)
               & (xy[:, 1] >= 0) & (xy[:, 1] < cam.height))
        ids = np.nonzero(vis)[0]
        ids = ids[rng.permutation(len(ids))]
        kp_pid.append(ids)
        img = Image(name=f"img{i:03d}.jpg", camera_id=1, id=i + 1,
                    keypoints_xy=xy[ids] + rng.normal(0, pixel_noise,
                                                      (len(ids), 2)))
        img.cam_from_world = pose
        img.registered = True
        gt.add_image(img)
    return gt, kp_pid, write_database(path, gt, kp_pid)


def write_database(path, gt, kp_pid):
    """Write a ground-truth model's camera, images and keypoints (image i + 1
    observing true points kp_pid[i]) as a database, with verified pairs of
    every two images that share >= 30 points (the true matches and relative
    pose). Returns the number of verified pairs."""
    num_images = len(kp_pid)
    db = Database(path)
    with DatabaseTransaction(db):
        for cam in gt.cameras.values():
            db.write_camera(cam, use_camera_id=True)
        for i in range(num_images):
            img = gt.images[i + 1]
            db.write_image(img, use_image_id=True)
            db.write_keypoints(img.image_id,
                               img.points2D_xy.astype(np.float32))
        for i in range(num_images):
            for j in range(i + 1, num_images):
                common, ii, jj = np.intersect1d(kp_pid[i], kp_pid[j],
                                                return_indices=True)
                if len(common) < 30:
                    continue
                g = TwoViewGeometry()
                g.config = int(TwoViewGeometryConfiguration.CALIBRATED)
                g.inlier_matches = np.stack([ii, jj], axis=1).astype(np.uint32)
                rel = (gt.images[j + 1].cam_from_world
                       * gt.images[i + 1].cam_from_world.inverse())
                g.E = rel.essential_matrix()
                g.cam2_from_cam1 = rel
                db.write_two_view_geometry(i + 1, j + 1, g)
    n_pairs = db.num_verified_image_pairs
    db.close()
    return n_pairs


def known_pose_triangulation(tmp):
    t0 = time.perf_counter()
    rec, kp_pid, n_pairs = write_sequential_database(
        tmp / "tri.db", TRI_IMAGES, TRI_POINTS)
    views = np.bincount(np.concatenate(kp_pid), minlength=TRI_POINTS)
    n_true = int((views >= 2).sum())
    t1 = time.perf_counter()
    split = {}
    ck.reset_counts()
    out = psfm.triangulate_points(rec, tmp / "tri.db", tmp, tmp / "tri_out",
                                  timings=split)
    t2 = time.perf_counter()
    # each triangulated point's true point: the majority of its track's
    found, pure = set(), 0
    for pt in out.points3D.values():
        ids = [int(kp_pid[e.image_id - 1][e.point2D_idx])
               for e in pt.track.elements]
        vals, counts = np.unique(ids, return_counts=True)
        found.add(int(vals[np.argmax(counts)]))
        pure += len(vals) == 1
    share = len(found) / max(n_true, 1)
    err = out.compute_mean_reprojection_error()
    track = out.compute_mean_track_length()
    log(f"phase 12 database: {TRI_IMAGES} images, {TRI_POINTS} points "
        f"({n_true} seen by >= 2 images, {views[views > 0].mean():.2f} views "
        f"each), {n_pairs} verified pairs; written in {t1 - t0:.2f} s")
    log(f"phase 12 triangulate_points: {out.num_points3D} points, mean track "
        f"{track:.2f}, {100 * share:.2f}% of the true points triangulated, "
        f"{pure} tracks of one true point, mean reprojection error "
        f"{err:.4f} px; BA launches {dict(ck.LAUNCHES)}")
    total = t2 - t1
    log(f"phase 12 wall: {total:.3f} s: "
        + ", ".join(f"{k} {v:.3f} s ({100 * v / total:.1f}%)"
                    for k, v in split.items()))
    out.check()
    if not (share >= 0.8 and err < 1.5):
        raise AssertionError(f"phase 12: {100 * share:.2f}% triangulated "
                             f"(need 80%), error {err:.4f} px (need < 1.5)")
    return dict(total_s=total, share=share, err=err, points=out.num_points3D,
                **split)


# ---------------------------------------------------------------------------
# phases 13 and 14: dense MVS
# ---------------------------------------------------------------------------


def noise_texture(rng, cells=(16, 32, 64, 128, 256)):
    """Multi-octave value noise: one periodic random grid per octave, finer
    octaves weaker (tests/test_full_pipeline.py's texture, in numpy)."""
    return [(rng.normal(size=(c, c)), c ** -0.3) for c in cells]


def sample_texture(grids, u, v, period=8.0):
    """Texture value in [0, 1] at world coordinates (u, v): the bilinear
    sum of the octaves, wrapped every `period` units."""
    out = np.zeros(u.shape)
    for g, amp in grids:
        c = g.shape[0]
        tu, tv = u / period * c, v / period * c
        x0, y0 = np.floor(tu), np.floor(tv)
        fx, fy = tu - x0, tv - y0
        x0 = x0.astype(np.int64) % c
        y0 = y0.astype(np.int64) % c
        x1, y1 = (x0 + 1) % c, (y0 + 1) % c
        out += amp * (g[y0, x0] * (1 - fy) * (1 - fx) + g[y0, x1] * (1 - fy) * fx
                      + g[y1, x0] * fy * (1 - fx) + g[y1, x1] * fy * fx)
    norm = math.sqrt(sum(a * a for _, a in grids))
    return np.clip(0.5 + 0.16 * out / norm, 0.0, 1.0)


def dense_poses(num_images):
    """render_scene's camera arc (tests/test_full_pipeline.py:33): cameras
    6.5 units from a target between the planes, over 0.7 rad."""
    target = np.array([0.0, 0.0, 6.5])
    poses = []
    for i in range(num_images):
        theta = -0.35 + i * (0.7 / max(num_images - 1, 1))
        center = target + 6.5 * np.array(
            [np.sin(theta), 0.10 * np.sin(2 * theta), -np.cos(theta)])
        fwd = (target - center) / np.linalg.norm(target - center)
        right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        R_wc = np.stack([right, np.cross(fwd, right), fwd], axis=0)
        poses.append(Rigid3d(Rotation3d(R_wc), -R_wc @ center))
    return poses


def plane_hits(center, dirs):
    """Depth along world rays `dirs` [..., 3] (camera z = 1) to the two
    planes: z = 6 owns x < 0.15, z = 7.5 the rest. Returns (t, plane index),
    t = inf where nothing is hit."""
    t_hit = np.full(dirs.shape[:-1], np.inf)
    plane = np.full(dirs.shape[:-1], -1)
    for k, z0 in enumerate(MVS_PLANES):
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (z0 - center[2]) / dirs[..., 2]
        px = center[0] + t * dirs[..., 0]
        own = (px < 0.15) if k == 0 else (px >= 0.15)
        sel = (t > 0.1) & np.isfinite(t) & own & (t < t_hit)
        t_hit[sel] = t[sel]
        plane[sel] = k
    return t_hit, plane


_RAYS = {}  # (H, W) -> undistorted camera rays, shared by phases 14 and 21


def render_dense_scene(root, num_images, H, W, seed=0, num_points=2000):
    """Two textured planes seen by a SIMPLE_RADIAL camera (small k) along
    render_scene's arc, written as .ppm images, and the ground-truth sparse
    model: every camera, and `num_points` surface points with the tracks of
    the images that see them (unoccluded, inside the frame). The images
    render in threads (numpy's loops release the interpreter lock), the
    same values in any order."""
    rng = np.random.default_rng(seed)
    f = 450.0 * W / 512
    cam = Camera(1, "SIMPLE_RADIAL", W, H, [f, W / 2, H / 2, MVS_RADIAL_K])
    textures = [noise_texture(rng) for _ in MVS_PLANES]
    poses = dense_poses(num_images)
    if (H, W) not in _RAYS:  # the camera is a function of (H, W)
        yy, xx = np.mgrid[0:H, 0:W]
        pix = np.stack([xx.ravel() + 0.5, yy.ravel() + 0.5], axis=1)
        uv = cam.cam_from_img(pix)  # undistorted rays through each pixel
        _RAYS[H, W] = np.concatenate([uv, np.ones((len(uv), 1))], axis=1)
    d_cam = _RAYS[H, W]
    (root / "images").mkdir(parents=True)

    def render(pose):
        inv = pose.inverse()
        t, plane = plane_hits(inv.translation, d_cam @ inv.rotation.matrix().T)
        hit = d_cam @ inv.rotation.matrix().T * t[:, None] + inv.translation
        img = np.full(len(d_cam), 0.5)
        for k in range(len(MVS_PLANES)):
            sel = plane == k
            img[sel] = sample_texture(textures[k], hit[sel, 0], hit[sel, 1])
        return (img.reshape(H, W) * 255).round().astype(np.uint8)

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        for i, u8 in enumerate(pool.map(render, poses)):
            write_image(root / "images" / f"view{i:02d}.ppm",
                        np.stack([u8, u8, (u8 * 0.9).astype(np.uint8)],
                                 axis=-1))

    n0 = num_points // 2
    pts = np.stack([
        np.concatenate([rng.uniform(-3.0, 0.15, n0),
                        rng.uniform(0.15, 3.0, num_points - n0)]),
        rng.uniform(-2.5, 2.5, num_points),
        np.where(np.arange(num_points) < n0, *MVS_PLANES),
    ], axis=1)
    rec = Reconstruction()
    rec.add_camera(cam)
    seen = []
    for i, pose in enumerate(poses):
        p_cam = pose * pts
        center = pose.inverse().translation
        xy = cam.img_from_cam(p_cam[:, :2] / p_cam[:, 2:])
        # a far-plane point is hidden where its ray crosses the near plane
        s = (MVS_PLANES[0] - center[2]) / (pts[:, 2] - center[2])
        hidden = (pts[:, 2] > MVS_PLANES[0]) & (
            center[0] + s * (pts[:, 0] - center[0]) < 0.15)
        ids = np.nonzero((p_cam[:, 2] > 0) & ~hidden & (xy[:, 0] >= 0)
                         & (xy[:, 0] < W) & (xy[:, 1] >= 0) & (xy[:, 1] < H))[0]
        seen.append(ids)
        img = Image(name=f"view{i:02d}.ppm", camera_id=1, id=i + 1,
                    keypoints_xy=xy[ids])
        img.cam_from_world = pose
        img.registered = True
        rec.add_image(img)
    kp = [dict(zip(ids.tolist(), range(len(ids)))) for ids in seen]
    for j in range(num_points):
        els = [TrackElement(i + 1, kp[i][j]) for i in range(num_images)
               if j in kp[i]]
        if len(els) >= 2:
            rec.add_point3D(pts[j], Track(els))
    (root / "sparse").mkdir()
    rec.write_binary(root / "sparse")
    return rec


def depth_accuracy(ws):
    """Valid share and median relative error of the geometric depth maps
    against the planes, through the undistorted (PINHOLE) camera; both
    pooled over every image."""
    rec = Reconstruction(ws / "sparse")
    n_valid = n_px = 0
    errs = []
    for img in rec.images.values():
        d = read_mat(depth_map_path(ws, img.name, "geometric"))
        cam = rec.cameras[img.camera_id]
        H, W = d.shape
        K = cam.calibration_matrix()
        inv = img.cam_from_world.inverse()
        yy, xx = np.mgrid[0:H, 0:W]
        dirs = np.stack([(xx + 0.5 - K[0, 2]) / K[0, 0],
                         (yy + 0.5 - K[1, 2]) / K[1, 1],
                         np.ones((H, W))], -1) @ inv.rotation.matrix().T
        gt, _ = plane_hits(inv.translation, dirs)
        valid = (d > 0) & np.isfinite(gt)
        n_valid += int(valid.sum())
        n_px += H * W
        errs.append(np.abs(d[valid] - gt[valid]) / gt[valid])
    errs = np.concatenate(errs)
    return n_valid / n_px, float(np.median(errs)) if len(errs) else math.inf


class CostRecorder:
    """Wraps the PatchMatch loop's cost call: passes every call through to
    the wrapper (its launches count) and keeps the arguments of the calls
    whose index is in `keep`."""

    def __init__(self, keep):
        self.keep, self.calls, self.kept = dict(keep), 0, {}
        self.wrapped = pm.pm_view_costs

    def __call__(self, *args, **kw):
        for tag, idx in self.keep.items():
            if self.calls == idx:
                self.kept[tag] = (args, kw)
        self.calls += 1
        return self.wrapped(*args, **kw)


def dense_pipeline(tmp):
    """Phase 14: undistort_images -> patch_match_stereo -> stereo_fusion at
    full width with default options; the cost kernel's launch count is
    zeroed just before and read just after. Captures the inputs of one
    photometric and one geometric cost call for phase 13, and the first
    image's PatchMatch call for the profile."""
    t0 = time.perf_counter()
    render_dense_scene(tmp / "scene", MVS_IMAGES, MVS_H, MVS_W)
    t_render = time.perf_counter() - t0
    per_image = 8 * 2 * PatchMatchOptions().num_iterations
    per_pass = per_image * MVS_IMAGES
    # the middle image's refresh at step 4, in each pass
    at = MVS_IMAGES // 2 * per_image + 32
    rec = CostRecorder({"photometric": at, "geometric": per_pass + at})
    first = {}
    kernel = mvs_controller.patch_match_kernel

    def record_first(*args, **kw):
        kind = "geometric" if kw.get("geom_consistency") else "photometric"
        first.setdefault(kind, (args, kw))
        return kernel(*args, **kw)

    pm.pm_view_costs = rec
    mvs_controller.patch_match_kernel = record_first
    split = {}
    try:
        pmk.reset_counts()
        t1 = time.perf_counter()
        undistort_images(tmp / "dense", tmp / "scene" / "sparse",
                         tmp / "scene" / "images")
        t2 = time.perf_counter()
        patch_match_stereo(tmp / "dense", timings=split)
        t3 = time.perf_counter()
        xyz, _ = stereo_fusion(tmp / "dense" / "fused.ply", tmp / "dense")
        t4 = time.perf_counter()
        launches = dict(pmk.LAUNCHES)
        plain_on_cuda = dict(pmk.PLAIN_ON_CUDA)
    finally:
        pm.pm_view_costs = rec.wrapped
        mvs_controller.patch_match_kernel = kernel
    split = dict(undistort=t2 - t1, **split, fusion=t4 - t3)
    valid, med = depth_accuracy(tmp / "dense")
    fused_med = plane_distance(xyz)
    log(f"phase 14 scene: {MVS_IMAGES} images {MVS_H}x{MVS_W} SIMPLE_RADIAL "
        f"k {MVS_RADIAL_K}, rendered in {t_render:.2f} s")
    log(f"phase 14 wall: {t4 - t1:.3f} s: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in split.items())
        + f"; PatchMatch {(split['photometric'] + split['geometric']) / (2 * MVS_IMAGES):.3f}"
        " s per image and pass")
    # per red/black step one full-field refresh and 7 candidates at the
    # step's colour (parity launches)
    expect = {"pm_cost": 2 * per_pass // 8,
              "pm_cost_parity": 2 * per_pass * 7 // 8}
    log(f"phase 14 launches {launches} (expected {expect}: per image and "
        f"pass {expect['pm_cost'] // (2 * MVS_IMAGES)} full-field and "
        f"{expect['pm_cost_parity'] // (2 * MVS_IMAGES)} parity); geometric "
        f"maps {100 * valid:.2f}% valid, median relative depth error "
        f"{med:.5f}; {len(xyz)} fused points, median distance to the planes "
        f"{fused_med:.5f}")
    if launches != expect or any(plain_on_cuda.values()):
        raise AssertionError(f"phase 14: cost launches {launches}, expected "
                             f"{expect}; plain on CUDA {plain_on_cuda}")
    if not (valid > 0.2 and med < 0.01 and len(xyz) > 1000
            and fused_med < 0.02):
        raise AssertionError("phase 14: dense accuracy below the thresholds "
                             "(valid > 0.2, error < 0.01, > 1000 fused "
                             "points at < 0.02)")
    return launches, dict(split, valid=valid, median_rel_err=med,
                          fused=len(xyz), fused_median_dist=fused_med), \
        rec.kept, first


def profile_patch_match(call, kind):
    """torch.profiler over one image's PatchMatch call of one pass, re-run
    with a fresh generator: device busy share and the top device ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args, kw = call
    args = (torch.Generator(device="cuda").manual_seed(1),) + tuple(args[1:])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = mvs_controller.patch_match_kernel(*args, **kw)
        out[0].cpu()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy = sum(dev_us(e) for e in rows) * 1e-6
    kernel = sum(dev_us(e) for e in rows if "pm_cost" in e.key) * 1e-6
    log(f"phase 14 profile: one {kind} PatchMatch call in "
        f"{wall * 1e3:.2f} ms wall; device busy {busy * 1e3:.2f} ms "
        f"({100 * busy / wall:.1f}%), {sum(e.count for e in rows)} device "
        f"ops; the cost kernel {kernel * 1e3:.2f} ms, "
        f"{100 * kernel / max(busy, 1e-12):.1f}% of the busy time")
    for e in sorted(rows, key=dev_us, reverse=True)[:12]:
        log(f"phase 14 profile:   {dev_us(e) / 1e3:9.3f} ms  x{e.count:5d}  "
            f"{e.key[:90]}")
    return busy / wall, kernel / max(busy, 1e-12)


def irregular_pm_inputs(dev, geom, seed=13):
    """H, W no multiples of 8 / 128, K = 3, radius 3 / step 1 (nw = 49), a
    slanted plane with a patch of random normals, a wide-angle reference and
    a source turned 75 degrees, behind which part of the plane lies; with
    geom, source depth maps with a hole."""
    g = torch.Generator().manual_seed(seed)
    H, W, K, radius, step = 203, 317, 3, 3, 1
    f = 200.0
    Kr = torch.tensor([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    yy, xx = torch.meshgrid(torch.arange(H) + 0.5, torch.arange(W) + 0.5,
                            indexing="ij")
    rays = torch.stack([(xx - W / 2) / f, (yy - H / 2) / f, torch.ones(H, W)])

    def texture():
        img = torch.zeros(H, W)
        for _ in range(10):
            fy, fx, ph, a = torch.rand(4, generator=g)
            img += (0.2 + a) * torch.sin((fy - 0.5) * yy + (fx - 0.5) * xx
                                         + 6.28 * ph)
        return (img - img.min()) / (img.max() - img.min())

    ref = texture()
    srcs = torch.stack([texture() for _ in range(K)])
    n = torch.tensor([0.35, 0.15, -1.0])
    n = n / n.norm()
    normal = n[:, None, None].expand(3, H, W).clone()
    normal[:, 50:90, 100:160] = torch.nn.functional.normalize(
        torch.randn(3, 40, 60, generator=g) - 2 * rays[:, 50:90, 100:160],
        dim=0)
    depth = -5.0 / torch.einsum("c,chw->hw", n, rays)
    a = math.radians(75.0)
    R_rel = torch.stack([
        torch.eye(3),
        torch.tensor([[math.cos(a), 0, math.sin(a)], [0, 1.0, 0],
                      [-math.sin(a), 0, math.cos(a)]]),
        torch.tensor([[0.999, -0.04, 0], [0.04, 0.999, 0], [0, 0, 1.0]]),
    ])
    t_rel = torch.tensor([[0.3, 0.1, 0.0], [-3.0, 0.0, 1.5], [0.2, -0.3, 0.1]])
    Ks = torch.stack([Kr, Kr * torch.tensor([[1.2], [1.2], [1.0]]), Kr])
    offsets = pm._window_offsets(radius, step)
    ref_off, w_off, w_sum, ref_mean, ref_var = pm.window_stats(
        ref, offsets, radius, 0.2)
    sdep = None
    if geom:
        sdep = 4.0 + 3.0 * srcs
        sdep[:, 120:150, 200:260] = 0.0
    params = pmk.pm_view_params(R_rel, t_rel, Ks, Kr, 0.2, 0.3, 3.0)
    to = lambda x: None if x is None else x.to(dev).contiguous()  # noqa: E731
    return tuple(to(x) for x in (
        srcs, sdep, w_off, w_off * ref_off, depth, normal,
        torch.stack([w_sum, ref_mean, ref_var]), params,
        torch.as_tensor(offsets, dtype=torch.float32)))


def _active(H, W, dev, parity):
    """The pixels a parity launch evaluates ((y + x) % 2 == parity), all
    for parity None."""
    if parity is None:
        return torch.ones(H, W, dtype=torch.bool, device=dev)
    return (torch.arange(H, device=dev)[:, None]
            + torch.arange(W, device=dev)[None, :]) % 2 == parity


def pm_valid_samples(args, parity=None):
    """Valid (pixel, view, offset) samples of one cost call at the pixels it
    evaluates: the kernel's warp and validity test in float64."""
    srcs, _, _, _, depth, normal, _, params, offs = args
    K, H, W = srcs.shape
    P = params.double()
    R, t, ks = P[:, 0:9, None, None], P[:, 9:12, None, None], P[:, 12:16]
    kr = P[0, 16:20]
    py, px = torch.meshgrid(torch.arange(H, device=srcs.device) + 0.5,
                            torch.arange(W, device=srcs.device) + 0.5,
                            indexing="ij")
    n = normal.double()
    ndotr = n[0] * (px - kr[2]) / kr[0] + n[1] * (py - kr[3]) / kr[1] + n[2]
    denom = depth.double() * torch.where(ndotr.abs() < 1e-6, -1e-6, ndotr)
    active = _active(H, W, srcs.device, parity)
    count = 0
    for dy, dx in offs.tolist():
        rq = torch.stack([(px + dx - kr[2]) / kr[0], (py + dy - kr[3]) / kr[1],
                          torch.ones_like(px)])
        scale = (n * rq).sum(0) / denom
        m = [(R[:, 3 * i:3 * i + 3] * rq).sum(1) + t[:, i] * scale
             for i in range(3)]
        z = torch.where(m[2].abs() < 1e-9, 1e-9, m[2])
        us = ks[:, 0, None, None] * (m[0] / z) + ks[:, 2, None, None] - 0.5
        vs = ks[:, 1, None, None] * (m[1] / z) + ks[:, 3, None, None] - 0.5
        count += int(((us >= 0) & (us < W - 1) & (vs >= 0) & (vs < H - 1)
                      & (m[2] > 0) & active).sum())
    return count


def pm_bound(args, geom, parity=None):
    """Least time of one cost call: bytes (every input the evaluated pixels
    need read once, the cost written once) over HBM rate against f32
    operations over the f32 rate. Operations, as counted in
    csrc/pm_cost.cu: 33 per sample for the warp and validity, 28 more per
    valid sample, 13 per (pixel, offset), 15 per (pixel, view) for the NCC
    and 50 more with the geometric term, at the evaluated pixels."""
    srcs, sdep, w_off = args[0], args[1], args[2]
    K, H, W = srcs.shape
    nw = w_off.shape[0]
    HW = H * W
    hw = HW if parity is None else int(_active(H, W, srcs.device,
                                               parity).sum())
    nbytes = 4 * (K * HW * (1 + geom) + K * HW + (2 * nw + 7) * hw
                  + args[7].numel() + args[8].numel())
    valid = pm_valid_samples(args, parity)
    ops = (33 * K * nw * hw + 28 * valid + 13 * nw * hw
           + K * hw * (15 + 50 * geom))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, gflop=ops / 1e9,
                valid_share=valid / (K * nw * hw))


def check_pm_cost(tag, args, geom, results=None):
    """Kernel vs its plain version on the same inputs. In f32, which the kernel computes operation for
    operation: the full-field and both parity launches bit for bit, and a
    parity launch's active pixels equal to the full field's. In float64
    (full field): every entry within TOL["pm_cost"] scaled plus the f32
    plain version's own distance from float64 there; that distance is large
    only where a cost is ill-conditioned in f32 (a sample within rounding of
    the image edge, a plane nearly parallel to its ray, a source depth map
    that jumps between the taps of a geometric sample), and is reported."""
    got = pmk.pm_view_costs(*args, geom=geom)
    p32 = pmk.pm_view_costs_plain(*args, geom=geom)
    bad = {}
    e32 = float((got - p32).abs().max())
    if not torch.equal(got, p32):
        bad["full"] = e32
    K, H, W = got.shape
    for parity in (0, 1):
        gp = pmk.pm_view_costs(*args, geom=geom, parity=parity)
        pp = pmk.pm_view_costs_plain(*args, geom=geom, parity=parity)
        ep = float((gp - pp).abs().max())
        e32 = max(e32, ep)
        act = _active(H, W, got.device, parity)
        if not (torch.equal(gp, pp) and torch.equal(gp[:, act], got[:, act])
                and bool((gp[:, ~act] == 2.0).all())):
            bad[f"parity {parity}"] = ep
    ref = pmk.pm_view_costs_plain(args[0].double(), *args[1:], geom=geom)
    torch.cuda.synchronize()
    got, p32 = got.double(), p32.double()
    scale = max(1.0, float(ref.abs().max()))
    tol = TOL["pm_cost"] * scale
    gap32 = (p32 - ref).abs()
    err = (got - ref).abs()
    n_bad = int((err > tol + gap32).sum())
    if bad or not (bool(torch.isfinite(got).all()) and n_bad == 0):
        raise AssertionError(
            f"[{tag}] pm_cost: kernel differs from the f32 plain version "
            f"(max |diff| by launch) {bad}; {n_bad} entries beyond "
            f"{TOL['pm_cost']:.0e} scaled + the f32 gap from float64")
    q = torch.tensor([0.99, 0.999], device=err.device, dtype=err.dtype)
    p99, p999 = (float(v) for v in torch.quantile(err.flatten(), q))
    e_all = float(err.max())
    share = float((err > tol).double().mean())
    log(f"phase 13 pm_cost {tag}: K {K}, {H}x{W}, nw {args[2].shape[0]}, geom "
        f"{geom}; full field and parity 0 / 1 bit for bit equal to the f32 "
        f"plain version, parity launches equal to the full field at their "
        f"pixels; |kernel - float64| max {e_all:.3e} (f32 plain "
        f"{float(gap32.max()):.3e}), p99 {p99:.3e}, p99.9 {p999:.3e}, "
        f"{100 * share:.4f}% of entries beyond {TOL['pm_cost']:.0e} scaled "
        f"(scale {scale:.3f})")
    if results is None:
        return
    b = pm_bound(args, geom)
    bp = pm_bound(args, geom, parity=0)

    results[tag] = dict(
        max_abs_err=e_all, max_abs_err_vs_f32_plain=e32, p999_abs_err=p999,
        beyond_tol_share=share, scaled_err=e_all / scale,
        ms=time_gpu(lambda: pmk.pm_view_costs(*args, geom=geom)),
        ms_parity=time_gpu(lambda: pmk.pm_view_costs(*args, geom=geom,
                                                     parity=0)),
        plain_ms=time_gpu(lambda: pmk.pm_view_costs_plain(*args, geom=geom),
                          3),
        bound_ms_parity=bp["bound_ms"], gflop_parity=bp["gflop"], **b)
    r = results[tag]
    log(f"phase 13 pm_cost {tag}: kernel {r['ms']:.4f} ms "
        f"({r['gflop'] / r['ms']:.2f} TFLOP/s), parity launch "
        f"{r['ms_parity']:.4f} ms ({r['ms_parity'] / r['ms']:.3f} of the "
        f"full field; bound {r['bound_ms_parity']:.4f} ms), plain "
        f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}; {r['gflop']:.2f} GFLOP, {r['bytes'] / 1e6:.1f} "
        f"MB, {100 * r['valid_share']:.1f}% valid samples); kernel / bound "
        f"{r['ms'] / r['bound_ms']:.2f}x")


def pm_cost_kernel(captured):
    """Phase 13: the cost kernel vs its plain version at the main path's
    captured inputs and at the irregular shape."""
    dev = torch.device("cuda")
    results = {}
    for tag in ("photometric", "geometric"):
        args, kw = captured[tag]
        check_pm_cost(tag, args, kw.get("geom", False), results)
    for geom in (False, True):
        check_pm_cost(f"irregular geom={geom}", irregular_pm_inputs(dev, geom),
                      geom)
    # 11 views: the kernel's second block of views along z
    args = list(irregular_pm_inputs(dev, True))
    args[0] = args[0].repeat(4, 1, 1)[:11].contiguous()
    args[1] = args[1].repeat(4, 1, 1)[:11].contiguous()
    args[7] = args[7].repeat(4, 1)[:11].contiguous()
    check_pm_cost("irregular K=11 geom=True", tuple(args), True)
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phases 15-17: mixed-model bundles and the parameter gather
# ---------------------------------------------------------------------------


def quat_matrices(q):
    """[N, 4] wxyz -> [N, 3, 3] rotation matrices, float64."""
    w, x, y, z = (q[:, i] for i in range(4))
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], 1)


def mixed_reconstruction(num_images, num_points, seed=0):
    """Phase 11's ring scene through MIXED_CAMERAS: image i through camera
    i % 2 + 1. The observations are the generator's true points projected
    in float64 through each image's camera, plus MIXED_PIXEL_NOISE px;
    poses and points start at the generator's values perturbed with the
    bench's noise (the generator draws the same structure and noise at any
    noise level)."""
    kw = dict(BENCH, num_images=num_images, num_points=num_points, seed=seed)
    start = make_synthetic_bundle(**kw)
    truth = make_synthetic_bundle(**dict(kw, pixel_noise=0.0, pose_noise=0.0,
                                         point_noise=0.0))
    cams = [Camera(c + 1, name, 4000, 3000, np.array(params))
            for c, (name, params) in enumerate(MIXED_CAMERAS)]
    obs_img = truth.obs_image_idx.numpy()
    obs_pt = truth.obs_point_idx.numpy()
    R = quat_matrices(truth.cam_quat.double().numpy())
    Xc = (np.einsum("mij,mj->mi", R[obs_img],
                    truth.points.double().numpy()[obs_pt])
          + truth.cam_trans.double().numpy()[obs_img])
    uv = Xc[:, :2] / Xc[:, 2:]
    xy = np.empty_like(uv)
    for c, cam in enumerate(cams):
        sel = obs_img % len(cams) == c
        xy[sel] = cam.img_from_cam(uv[sel])
    xy += np.random.default_rng(seed + 1).normal(0, MIXED_PIXEL_NOISE,
                                                 xy.shape)
    return reconstruction_from_bundle(start, cams, xy)


def mixed_model_bundle_adjustment(tmp, single):
    """Phase 16: the entry point on the mixed model at full width, with
    the launch counts zeroed just before and read just after. `single`:
    phase 11's numbers for the single-model model of the same size.
    Returns the phase's numbers and the first res_and_jac call's inputs."""
    captured, problems = [], []
    res_and_jac, solve_bundle = ck.res_and_jac, psfm.solve_bundle

    def record_resjac(*args, **kw):
        if not captured:
            captured.append(args)
        return res_and_jac(*args, **kw)

    def record_solve(problem, *args, **kw):
        out = solve_bundle(problem, *args, **kw)
        problems.append((problem, out[0]))
        return out

    t0 = time.perf_counter()
    rec = mixed_reconstruction(BENCH["num_images"], BENCH["num_points"])
    t1 = time.perf_counter()
    rec.write_binary(tmp / "mixed_in")
    t2 = time.perf_counter()
    rec = Reconstruction(tmp / "mixed_in")
    t3 = time.perf_counter()
    err0 = rec.compute_mean_reprojection_error()
    split = {}
    ck.reset_counts()
    ck.res_and_jac, psfm.solve_bundle = record_resjac, record_solve
    try:
        t4 = time.perf_counter()
        summary = psfm.bundle_adjustment(rec, timings=split)
        t5 = time.perf_counter()
    finally:
        ck.res_and_jac, psfm.solve_bundle = res_and_jac, solve_bundle
    launches = dict(ck.LAUNCHES)
    plain_on_cuda = dict(ck.PLAIN_ON_CUDA)
    err1 = rec.compute_mean_reprojection_error()
    rec.write_binary(tmp / "mixed_out")
    t6 = time.perf_counter()
    problem, solved = problems[0]
    sel = solver_num_params(problem.model_id) - 1
    sel_same = torch.equal(problem.intrinsics[:, sel],
                           solved.intrinsics[:, sel].cpu())
    lm = summary.num_iterations
    rate = lm / split["solve"]
    per_step = {k: launches[k] / lm for k in MIXED_BA}
    single_rate = single["lm"] / single["solve"]
    single_step = {k: single["launches"][k] / single["lm"] for k in SINGLE_BA}
    log(f"phase 16 model: {rec.num_reg_images} images through "
        f"{[c.model for c in rec.cameras.values()]} (model_id "
        f"{problem.model_id}, width {sel + 1}), {rec.num_points3D} points, "
        f"{rec.compute_num_observations()} observations; built in "
        f"{t1 - t0:.2f} s, written in {t2 - t1:.2f} s")
    log(f"phase 16 bundle_adjustment: {summary}; mean reprojection error "
        f"{err0:.4f} -> {err1:.4f} px; selector column unchanged {sel_same}")
    log(f"phase 16 wall: read {t3 - t2:.3f} s, entry point {t5 - t4:.3f} s "
        f"(problem build {split['build']:.3f} s, solve {split['solve']:.3f} "
        f"s, write back {split['write_back']:.3f} s), model write "
        f"{t6 - t5:.3f} s; {rate:.2f} LM it/s over the solve")
    log(f"phase 16 launches {launches}; per LM step "
        f"{json.dumps({k: round(v, 3) for k, v in per_step.items()})}")
    log(f"phase 16 vs phase 11's single-model SIMPLE_RADIAL model of the same "
        f"size: solve {split['solve']:.3f} s / {single['solve']:.3f} s, "
        f"{lm} / {single['lm']} LM steps, {rate:.2f} / {single_rate:.2f} LM "
        f"it/s, entry point {t5 - t4:.3f} s / {single['entry_s']:.3f} s; "
        f"single-model launches per LM step "
        f"{json.dumps({k: round(v, 3) for k, v in single_step.items()})}")
    if not (summary.final_cost < summary.initial_cost and err1 < err0
            and err1 < 1.0):
        raise AssertionError("phase 16: cost or reprojection error did not "
                             "fall below 1 px")
    if not sel_same:
        raise AssertionError("phase 16: the solve moved the selector column")
    missing = [k for k in MIXED_BA if launches[k] <= 0 and k != "matvec"]
    single_run = [k for k in ("resjac", "cost", "finish", "matvec")
                  if launches[k]]
    if missing or single_run:
        raise AssertionError(f"phase 16: kernels never launched {missing}; "
                             f"single-model or f32 kernels launched "
                             f"{single_run}")
    if any(plain_on_cuda.values()):
        raise AssertionError(f"phase 16: plain versions ran on CUDA tensors: "
                             f"{plain_on_cuda}")
    # resjac and finish once per LM step, the cost once per solve
    want = {"resjac_mixed": lm, "finish_mixed": lm,
            "cost_mixed": len(problems)}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"phase 16: launches "
                             f"{ {k: launches[k] for k in want} }, expected "
                             f"{want}")
    out = dict(read_s=t3 - t2, entry_s=t5 - t4, lm=lm, lm_per_s=rate,
               err0=err0, err1=err1, single_lm_per_s=single_rate,
               launches=launches, per_step=per_step, **split)
    return out, captured[0]


def mixed_kernels(captured):
    """Phase 15: the mixed kernels and the Schur kernels (prepare and both
    matvecs) vs their float64 plain versions at the inputs captured in
    phase 16 (all timed), then at irregular shapes."""
    dev = torch.device("cuda")
    (buckets, pts, quat, trans, intr, intr_free, model_id, loss_type,
     loss_scale) = captured
    case = Case([b._replace(points=p) for b, p in zip(buckets, pts)], quat,
                trans, intr, intr_free, model_id, loss_type, loss_scale, 0)
    results = {}
    check_case(case, "phase 16 capture", results)
    # the Schur kernels at the width and buckets phase 16's LM step gives
    # them, each with its mode and table
    schur = {k: {} for k in ck.TILE_KINDS}
    check_case_schur("phase 16 capture", case, "phase 15", schur)
    del case
    torch.cuda.empty_cache()
    for name, r in results.items():
        log(f"phase 15 {name} at phase 16's inputs (model_id {model_id}): "
            f"scaled err {r['scaled_err']:.2e} (max abs "
            f"{r['max_abs_err']:.3e}; plain f32 err "
            f"{r['plain32_scaled_err']:.2e}); kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB)" + cost_note(r))
    # widths 6, 9, 13 (13: FOV near omega = 0), and every model at once;
    # each case has one camera whose selector names no listed model
    for models, loss, omega in (((2, 3), 0, 0.8), ((2, 4), 1, 0.8),
                                ((0, 6, 7), 2, 1e-9),
                                (tuple(range(11)), 1, 0.8)):
        case = irregular_cases(models, loss, dev, seed=40 + len(models),
                               omega=omega)
        errs = check_case(case, f"irregular {models}")
        errs.update({f"{k} (ladder widths)": v for k, v in check_case_schur(
            f"irregular {models}", case, "phase 15").items()})
        if len(models) < 11:
            # widths 6, 9, 13: tracks of lengths 1..T, at phase 2's ragged
            # loss (SOFT_L1). At TRIVIAL the width-6 case's cost is
            # ill-conditioned in f32: its f32 plain version misses float64
            # by 3.5e-5, as the kernel does (PERF.md)
            errs.update({f"{k} (ragged)": v for k, v in check_case(
                irregular_cases(models, 1, dev, seed=50 + len(models),
                                omega=omega, ragged=True),
                f"ragged {models}").items()})
        log(f"phase 15 irregular {models} (NP {case.NP}, {case.C} cameras, "
            f"loss {loss}): " + ", ".join(f"{k} {v[1]:.2e}"
                                          for k, v in errs.items()))
    results["schur"] = {k: v["phase 16 capture"] for k, v in schur.items()}
    return results


def gather_bound(buckets, Ri, I, Rc, C):
    """Bytes: the two index grids read and the Ri + Rc planes written once
    per slot, and the tables read once; no arithmetic."""
    nbytes = 4 * (Ri * I + Rc * C)
    for b in buckets:
        nbytes += 4 * b.mask.numel() * (2 + Ri + Rc)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=t_bytes, bound_by="bytes", bytes=nbytes)


def check_gather(tag, buckets, img_tab, cam_tab, results=None):
    """Kernel vs plain version on the card: exactly equal."""
    for b in buckets:
        got = ck.gather_params_bucket(img_tab, cam_tab, b.img_idx, b.cam_idx)
        ref = ck.gather_params_plain(img_tab, cam_tab, b.img_idx, b.cam_idx)
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"[{tag}] gather: kernel differs from plain")
    torch.cuda.synchronize()
    shapes = [tuple(b.mask.shape) for b in buckets]
    log(f"phase 17 gather {tag}: tables {tuple(img_tab.shape)} and "
        f"{tuple(cam_tab.shape)}, buckets [T, P] {shapes}: exactly equal")
    if results is None:
        return

    def each(fn):
        return lambda: [fn(b) for b in buckets]

    results[tag] = dict(
        max_abs_err=0.0, scaled_err=0.0,
        ms=time_gpu(each(lambda b: ck.gather_params_bucket(
            img_tab, cam_tab, b.img_idx, b.cam_idx))),
        plain_ms=time_gpu(each(lambda b: ck.gather_params_plain(
            img_tab, cam_tab, b.img_idx, b.cam_idx))),
        library_ms=time_gpu(each(lambda b: (
            img_tab.index_select(1, b.img_idx.flatten()),
            cam_tab.index_select(1, b.cam_idx.flatten())))),
        **gather_bound(buckets, *img_tab.shape, *cam_tab.shape))
    r = results[tag]
    log(f"phase 17 gather {tag}: kernel {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, index_select x2 {r['library_ms']:.4f} ms, "
        f"bound {r['bound_ms']:.4f} ms ({r['bytes'] / 1e6:.1f} MB)")


def gather_kernel(captured):
    """Phase 17: phase 16's buckets with its parameter tables (quat | trans
    per image, the intrinsics per camera, selector included), then a ragged
    shape with indices outside the tables."""
    buckets, _, quat, trans, intr, _, model_id = captured[:7]
    NP = solver_num_params(model_id)
    results = {}
    check_gather("phase 16 buckets", buckets,
                 torch.cat([quat, trans], 1).T.contiguous(),
                 intr[:, :NP].T.contiguous(), results)
    g = torch.Generator().manual_seed(17)
    dev = quat.device
    T, P, I, C = 5, 1001, 37, 3
    idx = lambda n: torch.randint(-2, n + 2, (T, P), generator=g,  # noqa: E731
                                  dtype=torch.int32).to(dev)
    b = bk.Bucket(idx(I), idx(C), None, torch.ones(T, P, device=dev), None,
                  None, None)
    check_gather("ragged", [b], torch.randn(7, I, generator=g).to(dev),
                 torch.randn(13, C, generator=g).to(dev))
    return results["phase 16 buckets"]


# ---------------------------------------------------------------------------
# phase 18: the gather probe

def gather_probe():
    """Phase 18: the probe's own run (its report, checks and times), with
    its launch counts zeroed just before and read just after; then every
    form bit for bit at ragged shapes, in range and with edge indices, and
    at the probe's shapes with edge indices. Returns the probe's records and
    its launches."""
    pg.reset_counts()
    res = pg.run(log=lambda m: log(f"phase 18 {m}"))
    launches = dict(pg.LAUNCHES)
    failed = {k: r["error"] for k, r in res.items()
              if not r.get("correct", True)}
    if failed:
        raise AssertionError(f"phase 18: probe cases failed: {failed}")
    unequal = [k for k, r in res.items() if r.get("library_equal") is False]
    if unequal:
        raise AssertionError(f"phase 18: the library call differs from the "
                             f"kernel at in-range indices: {unequal}")
    # each measure() launches once to check and WARMUP + REPS times to
    # time; the lane and flat gathers are measured again at their sizes
    per = 1 + WARMUP + REPS
    expected = {k: per * (2 if k in ("take_along_last", "take_flat") else 1)
                for k in pg.KERNELS}
    if launches != expected:
        raise AssertionError(f"phase 18: the probe's run launched {launches}, "
                             f"expected {expected}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(18)
    for name in pg.KERNELS:
        nans = []
        for s_shape, i_shapes, edge in ((*pg.RAGGED[name], False),
                                        (*pg.RAGGED[name], True),
                                        (*pg.PROBES[name][1:], True)):
            src, idx = pg.to_device(dev, *pg.make_inputs(
                name, s_shape, i_shapes, rng, edge=edge))
            nans.append(int(torch.isnan(pg.check(name, src, idx)).sum()))
        log(f"phase 18 {name}: bit for bit at {pg.RAGGED[name][0]} "
            f"(indices {pg.RAGGED[name][1]}) in range and with edge "
            f"indices, and at the probe's shape with edge indices; NaN "
            f"fills {nans}")
    # the floor beside the forms' byte bounds: one empty launch (PyTorch's
    # spin kernel at 0 cycles), its device time between CUDA events
    res["empty_launch_ms"] = time_gpu(lambda: torch.cuda._sleep(0))
    log(f"phase 18 empty launch: {res['empty_launch_ms']:.5f} ms between "
        f"CUDA events; the forms' byte bounds "
        + ", ".join(f"{k} {res[k]['bound_ms']:.6f}" for k in pg.KERNELS)
        + " ms")
    return res, launches


# ---------------------------------------------------------------------------
# phase 19: the estimators
# ---------------------------------------------------------------------------


def est_camera():
    return Camera.create(1, "PINHOLE", EST_F, SIFT_W, SIFT_H)


def est_pair(seed, outlier_ratio=0.3, noise=0.5, planar=False):
    """tests/test_estimators.py synth_two_view at run_sift's size: pixel
    matches of a known relative pose, 0.5 px noise, uniform outliers."""
    rng = np.random.default_rng(seed)
    cam = est_camera()
    n = EST_MATCHES
    X = rng.uniform(-2, 2, (n, 3)) + np.array([0, 0, 6.0])
    if planar:
        X[:, 2] = 6.0
    rel = Rigid3d(Rotation3d(np.array([0.05, 0.3, -0.02])),
                  np.array([1.0, 0.1, 0.05]))
    x1 = cam.img_from_cam(X[:, :2] / X[:, 2:])
    Xc2 = rel * X
    x2 = cam.img_from_cam(Xc2[:, :2] / Xc2[:, 2:])
    x1 += rng.normal(0, noise, x1.shape)
    x2 += rng.normal(0, noise, x2.shape)
    out = rng.choice(n, int(outlier_ratio * n), replace=False)
    x2[out] = rng.uniform(0, [cam.width, cam.height], (len(out), 2))
    inlier = np.ones(n, dtype=bool)
    inlier[out] = False
    return cam, x1, x2, rel, inlier


def est_pnp(seed=19, outlier_ratio=0.4):
    rng = np.random.default_rng(seed)
    cam = est_camera()
    n = EST_PNP
    X = rng.uniform(-2, 2, (n, 3)) + np.array([0, 0, 6.0])
    pose = Rigid3d(Rotation3d(np.array([0.2, -0.1, 0.4])),
                   np.array([0.3, -0.2, 0.5]))
    Xc = pose * X
    x = cam.img_from_cam(Xc[:, :2] / Xc[:, 2:]) + rng.normal(0, 0.5, (n, 2))
    out = rng.choice(n, int(outlier_ratio * n), replace=False)
    x[out] = rng.uniform(0, [cam.width, cam.height], (len(out), 2))
    inlier = np.ones(n, dtype=bool)
    inlier[out] = False
    return cam, x, X, pose, inlier


def est_track(seed=20, bad=2):
    rng = np.random.default_rng(seed)
    cam = est_camera()
    X_true = np.array([0.5, -0.3, 8.0])
    poses, obs = [], []
    for i in range(EST_VIEWS):
        pose = Rigid3d(Rotation3d(np.array([0.0, 0.08 * i, 0.0])),
                       np.array([0.6 * i - 2.7, 0.0, 0.0]))
        Xc = pose * X_true
        obs.append(cam.img_from_cam(Xc[None, :2] / Xc[2])[0]
                   + rng.normal(0, 0.3, 2))
        poses.append(pose)
    outliers = rng.choice(EST_VIEWS, bad, replace=False)
    for i in outliers:
        obs[i] = obs[i] + rng.uniform(30, 60, 2)
    return cam, obs, poses, X_true, outliers


def count_chunks(fn):
    """LO-RANSAC chunks one call of fn() draws: the fused first chunk runs
    its chunk through ``run_chunk`` as the later ones do."""
    plain = BatchedLORANSAC.run_chunk
    count = [0]

    def run_chunk(engine, *a, **kw):
        count[0] += 1
        return plain(engine, *a, **kw)

    BatchedLORANSAC.run_chunk = run_chunk
    try:
        fn()
    finally:
        BatchedLORANSAC.run_chunk = plain
    return count[0]


def host_syncs(fn):
    """Host synchronisations one call of fn() makes, as PyTorch's
    sync-debug mode reports them (a warning for each synchronising CUDA
    call: copies to the host, ``.item()``, ``linalg`` status checks); None
    if the mode reported none."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n = sum("synchroniz" in str(w.message) for w in caught)
    return n or None


def est_measure(tag, call, check, phase="phase 19"):
    """Phase 19's (or `phase`'s) record of one case: the card's and the
    CPU's results, each held to `check`; the card's host wall ms per call
    (median of EST_REPS after one warm-up), chunks, host syncs and device
    ops of one call; the CPU's wall ms of one call."""
    t_case = time.perf_counter()
    card = call("cuda")
    cpu_t0 = time.perf_counter()
    cpu = call("cpu")
    cpu_ms = (time.perf_counter() - cpu_t0) * 1e3
    card_out, cpu_out = check(card, "card"), check(cpu, "cpu")
    times = []
    for _ in range(EST_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call("cuda")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    syncs = []
    chunks = count_chunks(
        lambda: syncs.append(host_syncs(lambda: call("cuda"))))
    rec = dict(ms=float(np.median(times)), ms_runs=times, cpu_ms=cpu_ms,
               chunks=chunks, host_syncs=syncs[0],
               device_ops=device_ops(lambda: call("cuda"), tries=1),
               card=card_out, cpu=cpu_out,
               phase_s=time.perf_counter() - t_case)
    log(f"{phase} {tag} ({rec['phase_s']:.1f} s): card {card_out} | cpu "
        f"{cpu_out}; card "
        f"{rec['ms']:.1f} ms per call (median of {EST_REPS}: "
        f"{', '.join(f'{t:.1f}' for t in times)}), cpu {cpu_ms:.1f} ms; "
        f"{rec['chunks']} chunks, {rec['host_syncs']} host syncs, "
        f"{rec['device_ops']} device ops per call")
    return rec


def _rot_deg(a, b):
    return float(np.rad2deg(a.rotation.angle_to(b.rotation)))


def estimators_phase(shifted):
    """Phase 19: the estimators at a user's scale on the card and on the
    CPU (the plain path), each held to ground truth; `shifted` is phase 8's
    card matches of the 5-px-shifted pair (keypoints 1, 2 and matches)."""
    C = TwoViewGeometryConfiguration
    res = {}

    # (a) calibrated two-view with the relative pose
    cam, x1, x2, rel, gt = est_pair(seed=191)
    opts = est.TwoViewGeometryOptions(compute_relative_pose=True)

    def check_a(g, where):
        inl, err = len(g.inlier_matches), _rot_deg(g.cam2_from_cam1, rel)
        if (g.config != int(C.CALIBRATED) or inl <= 0.8 * gt.sum()
                or not err < 1.0):
            raise AssertionError(f"phase 19 (a) {where}: config {g.config}, "
                                 f"{inl} inliers of {gt.sum()}, rotation "
                                 f"error {err} deg")
        return dict(config=C(g.config).name, inliers=inl, rot_err_deg=err,
                    tri_angle_deg=float(np.rad2deg(g.tri_angle)))

    res["a_calibrated"] = est_measure(
        "(a) calibrated two-view + pose", lambda d:
        est.estimate_calibrated_two_view_geometry(cam, x1, cam, x2,
                                                  options=opts, device=d),
        check_a)

    # (b) its planar variant
    cam, x1, x2, rel, gt = est_pair(seed=192, planar=True)

    def check_b(g, where):
        inl = len(g.inlier_matches)
        if g.config != int(C.PLANAR_OR_PANORAMIC) or inl <= 0.8 * gt.sum():
            raise AssertionError(f"phase 19 (b) {where}: config {g.config}, "
                                 f"{inl} inliers of {gt.sum()}")
        return dict(config=C(g.config).name, inliers=inl)

    res["b_planar"] = est_measure(
        "(b) calibrated two-view, planar", lambda d:
        est.estimate_calibrated_two_view_geometry(cam, x1, cam, x2, device=d),
        check_b)

    # (c) phase 8's card matches of the 5-px-shifted pair. H's inliers lie
    # within the RANSAC threshold (4 px) by construction, and so do its
    # corners at the inliers' extent: the minimal-sample H wins over the
    # LO refit whenever the refit keeps fewer inliers (the reference's rule;
    # on this pair the reference's H is 1.7-2.6 px off at the corners).
    # The DLT of H's inliers is held to 0.5 px: the inliers are the shift.
    k1, k2, m = shifted
    cam = est_camera()
    corners = np.array([[0, 0, 1], [SIFT_W, 0, 1], [0, SIFT_H, 1],
                        [SIFT_W, SIFT_H, 1]], dtype=np.float64)

    def corner_err(H):
        p = corners @ np.asarray(H, np.float64).T
        return float(np.abs(p[:, :2] / p[:, 2:] - corners[:, :2]
                            - [5.0, 0.0]).max())

    def check_c(g, where):
        inl = g.inlier_matches.astype(np.int64)
        refit = est_solvers.homography_dlt(
            torch.from_numpy(k1[inl[:, 0], :2].astype(np.float64))[None],
            torch.from_numpy(k2[inl[:, 1], :2].astype(np.float64))[None])[0]
        err, err_refit = corner_err(g.H), corner_err(refit.numpy())
        if (g.config == int(C.DEGENERATE) or not err < 4.0
                or not err_refit < 0.5):
            raise AssertionError(f"phase 19 (c) {where}: config {g.config}, "
                                 f"corners off the 5-px shift by {err} px, "
                                 f"by {err_refit} px for the DLT of H's "
                                 f"inliers")
        return dict(config=C(g.config).name, inliers=len(inl),
                    corner_err_px=err, inlier_dlt_corner_err_px=err_refit)

    res["c_sift_pair"] = est_measure(
        f"(c) two-view of phase 8's {len(m)} matches", lambda d:
        est.estimate_two_view_geometry(cam, k1[:, :2], cam, k2[:, :2], m,
                                       device=d), check_c)
    if res["c_sift_pair"]["card"]["config"] != res["c_sift_pair"]["cpu"]["config"]:
        raise AssertionError("phase 19 (c): card and CPU configurations differ")

    # (d) absolute pose, then its refinement
    cam, x, X, pose, inlier = est_pnp()

    def check_d(r, where):
        est_pose = r["cam_from_world"]
        err_r = _rot_deg(est_pose, pose)
        err_t = float(np.abs(est_pose.translation - pose.translation).max())
        if not (err_r < 0.5 and err_t < 0.05):
            raise AssertionError(f"phase 19 (d) {where}: rotation {err_r} "
                                 f"deg, translation {err_t}")
        return dict(inliers=int(r["num_inliers"]), rot_err_deg=err_r,
                    t_err=err_t)

    res["d_absolute_pose"] = est_measure(
        f"(d) absolute pose, {EST_PNP} correspondences", lambda d:
        est.estimate_absolute_pose(x, X, cam, device=d), check_d)
    # a start off the truth by about a degree and 0.05 (the reference
    # test's perturbation), the true inliers
    bad = Rigid3d(Rotation3d(np.array([0.23, -0.09, 0.42])),
                  pose.translation + 0.05)

    def check_refine(out, where):
        est_pose = out["cam_from_world"]
        err_r = _rot_deg(est_pose, pose)
        err_t = float(np.abs(est_pose.translation - pose.translation).max())
        if not (err_r < 0.5 and err_t < 0.01):
            raise AssertionError(f"phase 19 (d) refine {where}: rotation "
                                 f"{err_r} deg, translation {err_t}")
        return dict(rot_err_deg=err_r, t_err=err_t)

    res["d_refine"] = est_measure(
        "(d) refine_absolute_pose from a perturbed start", lambda d:
        est.refine_absolute_pose(bad, x, X, inlier, cam, device=d),
        check_refine)

    # (e) a 10-view track with 2 outlier views
    cam, obs, poses, X_true, bad_views = est_track()

    def check_e(out, where):
        err = float(np.abs(out["point3D"] - X_true).max())
        if not err < 0.05 or out["inliers"][bad_views].any():
            raise AssertionError(f"phase 19 (e) {where}: point off by {err}, "
                                 f"inliers {out['inliers']}")
        return dict(inliers=int(out["num_inliers"]), point_err=err)

    res["e_triangulation"] = est_measure(
        f"(e) triangulation, {EST_VIEWS} views, 2 outliers", lambda d:
        est.estimate_triangulation(obs, poses, [cam] * EST_VIEWS, device=d),
        check_e)
    return res


# ---------------------------------------------------------------------------
# phase 20: incremental_mapping
# ---------------------------------------------------------------------------


def write_orbit_database(path, num_images, num_points, pixel_noise=0.4,
                         seed=0, cameras=None):
    """tests/test_incremental_mapping.py make_synthetic_database's default
    mode="orbit" with the port's Database: one SIMPLE_PINHOLE camera (f 600,
    640x480) unless `cameras` lists several (image i through camera
    i % len(cameras), as that function's ``cameras`` argument), the cameras
    on an arc of 1.2 rad at 5 units from a cube of points, each image's true
    keypoints plus noise in a random order, verified pairs of every two
    images that share >= 30 points. The same random draws in the same
    order, so keypoints and matches are the reference's; descriptors are
    not written (mapping does not read them). Returns the ground-truth
    model (poses and keypoints, no points)."""
    rng = np.random.default_rng(seed)
    if cameras is None:
        cameras = [Camera.create(1, "SIMPLE_PINHOLE", 600.0, 640, 480)]
    target = np.array([0.0, 0.0, 5.0])
    points = rng.uniform(-1.5, 1.5, (num_points, 3)) + target
    gt = Reconstruction()
    for cam in cameras:
        gt.add_camera(cam)
    kp_pid = []
    for i in range(num_images):
        cam = cameras[i % len(cameras)]
        theta = -0.6 + i * (1.2 / max(num_images - 1, 1))
        center = target + 5.0 * np.array(
            [np.sin(theta), 0.15 * np.sin(2 * theta), -np.cos(theta)])
        fwd = (target - center) / np.linalg.norm(target - center)
        right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        R_wc = np.stack([right, np.cross(fwd, right), fwd], axis=0)
        pose = Rigid3d(Rotation3d(R_wc), -R_wc @ center)
        p_cam = pose * points
        xy = cam.img_from_cam(p_cam[:, :2] / p_cam[:, 2:])
        vis = ((p_cam[:, 2] > 0.2) & (xy[:, 0] >= 0) & (xy[:, 0] < cam.width)
               & (xy[:, 1] >= 0) & (xy[:, 1] < cam.height))
        ids = np.nonzero(vis)[0]
        ids = ids[rng.permutation(len(ids))]
        kp_pid.append(ids)
        img = Image(name=f"img{i:03d}.jpg", camera_id=cam.camera_id,
                    id=i + 1, keypoints_xy=xy[ids] + rng.normal(
                        0, pixel_noise, (len(ids), 2)))
        img.cam_from_world = pose
        img.registered = True
        gt.add_image(img)
    write_database(path, gt, kp_pid)
    return gt


def mapping_options(min_model_size=6):
    """bench.py run_mapping's options (tests/test_incremental_mapping.py's
    with min_model_size 4)."""
    o = psfm.IncrementalPipelineOptions()
    o.min_model_size = min_model_size
    o.extract_colors = False
    return o


def pose_errors(rec, gt):
    """Each registered image's rotation error in degrees and projection
    center error against the truth, after the similarity (the port's
    Umeyama, float64) that maps the model's projection centers onto the
    true ones (the reference's ``compare_reconstructions(...,
    "proj_center")``)."""
    truth = {img.name: img for img in gt.images.values()}
    imgs = [rec.images[i] for i in rec.reg_image_ids]
    R = np.stack([im.cam_from_world.rotation.matrix() for im in imgs])
    Rg = np.stack([truth[im.name].cam_from_world.rotation.matrix()
                   for im in imgs])
    c = np.stack([im.projection_center() for im in imgs])
    cg = np.stack([truth[im.name].projection_center() for im in imgs])
    scale, q, t = est_solvers.umeyama(torch.from_numpy(c),
                                      torch.from_numpy(cg))
    Ra = qops.quat_to_matrix(q).numpy()
    centers = np.linalg.norm(scale.item() * c @ Ra.T + t.numpy() - cg, axis=1)
    # the aligned model's cam_from_world rotation is R Ra^T
    D = np.swapaxes(Rg, 1, 2) @ R @ Ra.T
    cos = np.clip((np.trace(D, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return np.degrees(np.arccos(cos)), centers


def map_and_check(db, out, gt, opts, device, tag, min_reg, **kw):
    """incremental_mapping of `db` into `out` on `device` (`kw`: its other
    arguments), timed, with the outcome checks: at least `min_reg` images
    registered, mean reprojection error under 1 px, median rotation error
    under 0.5 degrees, the model written and read back. Returns (model,
    seconds, timings)."""
    timings = {}
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    recs = psfm.incremental_mapping(db, out, out / "sparse", opts,
                                    device=device, timings=timings, **kw)
    dt = time.perf_counter() - t0
    if not recs:
        raise AssertionError(f"[{tag}] no model")
    rec = recs[0]
    err = rec.compute_mean_reprojection_error()
    rot = float(np.median(pose_errors(rec, gt)[0]))
    back = Reconstruction(out / "sparse" / "0")
    log(f"{tag}: {len(recs)} model(s), {rec.num_reg_images} images "
        f"registered, {rec.num_points3D} points, mean reprojection error "
        f"{err:.4f} px, median rotation error {rot:.4f} deg, in {dt:.2f} s "
        f"({rec.num_reg_images / dt:.4f} registered img/s)")
    rec.check()
    if not (rec.num_reg_images >= min_reg and err < 1.0 and rot < 0.5):
        raise AssertionError(f"[{tag}] {rec.num_reg_images} registered "
                             f"(need {min_reg}), error {err:.4f} px (need "
                             f"< 1), rotation {rot:.4f} deg (need < 0.5)")
    if (back.reg_image_ids != rec.reg_image_ids
            or back.num_points3D != rec.num_points3D):
        raise AssertionError(f"[{tag}] the model read back differs")
    return rec, dt, dict(timings, err=err, rot=rot)


class ResJacRecorder:
    """Keeps the operands of bundle adjustment's residual and Jacobian calls
    on the main path (through the module attributes the LM loop calls):
    those of the last global step (TRIVIAL loss) with the deepest bucket,
    and of the last local-window step (SOFT_L1); and where that step
    solved the dense reduced system, that system's other operands (lam,
    pose_free, intr_free, img2cam) in ``global_dense`` / ``local_dense``
    (None for an implicit step). The LM loop replaces its tensors rather
    than writing into them, so references suffice."""

    def __init__(self):
        self.global_args = self.local_args = None
        self.global_dense = self.local_dense = None
        self._deepest = 0
        self._pending = None

    def __enter__(self):
        self._wrapped = ck.res_and_jac
        self._dense = bk.dense_schur_system
        ck.res_and_jac = self._record
        bk.dense_schur_system = self._record_dense
        return self

    def __exit__(self, *exc):
        ck.res_and_jac = self._wrapped
        bk.dense_schur_system = self._dense

    def _record(self, *args, **kw):
        b_l, loss_type = args[0], args[7]
        T = max(b.mask.shape[0] for b in b_l)
        self._pending = None
        if loss_type == 0:
            if T >= self._deepest:
                self._deepest, self.global_args = T, args
                self.global_dense, self._pending = None, "global"
        else:
            self.local_args = args
            self.local_dense, self._pending = None, "local"
        return self._wrapped(*args, **kw)

    def _record_dense(self, *args):
        if self._pending is not None:  # the recorded step's own system
            setattr(self, f"{self._pending}_dense", args[3:7])
            self._pending = None
        return self._dense(*args)


def mapping_case(args, seed):
    """A phase 2 Case from recorded res_and_jac operands."""
    b_l, pts, quat, trans, intr, intr_free, m, lt, ls = args
    buckets = [b._replace(points=p) for b, p in zip(b_l, pts)]
    return Case(buckets, quat, trans, intr, intr_free, m, lt, ls, seed)


def other_launch_counts():
    """The launch counts of every kernel outside bundle adjustment."""
    return {**mk.LAUNCHES, **ws.LAUNCHES, **pmk.LAUNCHES,
            **{f"probe_{k}": v for k, v in pg.LAUNCHES.items()}}


def zero_counts():
    """Every kernel's launch count and plain-on-CUDA count to 0."""
    for mod in (ck, mk, ws, pmk, pg):
        mod.reset_counts()


def read_counts():
    """(every kernel's launches, plain versions run on CUDA tensors) since
    the last zero_counts()."""
    return ({**ck.LAUNCHES, **other_launch_counts()},
            {**ck.PLAIN_ON_CUDA, **pmk.PLAIN_ON_CUDA, **ws.PLAIN_ON_CUDA,
             **mk.PLAIN_ON_CUDA})


def launch_check(phase, launches, plain_on_cuda, want, used):
    """The launch rule of a stretch of a main path: every kernel in `used`
    launched, each count in `want` met exactly (a key naming several
    kernels, "a+b", sums them), no other kernel launched and no plain
    version run on a CUDA tensor."""
    missing = [k for k in used if launches[k] <= 0]
    off_path = {k: v for k, v in launches.items() if k not in used and v}
    got = {k: sum(launches[n] for n in k.split("+")) for k in want}
    if missing or off_path or got != want:
        raise AssertionError(f"{phase}: kernels never launched {missing}, "
                             f"launched off the path {off_path}, or launches "
                             f"{got} != {want}")
    if any(plain_on_cuda.values()):
        raise AssertionError(f"{phase}: plain versions ran on CUDA tensors: "
                             f"{plain_on_cuda}")


BA_COUNTERS = ("ba_solves", "ba_lm_steps", "ba_cg_iterations",
               "ba_dense_solves", "ba_dense_lm_steps", "ba_dense_cg_iterations")


def ba_rule(t):
    """The BA part of a mapping run's launch rule from its counters `t`
    (``incremental_mapping``'s timings): resjac, prepare and finish once
    per LM step, the cost once per solve, matvec16 once per CG iteration
    of the implicit steps. A step of the dense reduced system launches
    resjac, prepare and finish, and no matvec (nor packs J): its PCG
    iterations (``ba_dense_cg_iterations``) launch nothing. Returns (want,
    used)."""
    want = {"matvec16": t["ba_cg_iterations"], "resjac": t["ba_lm_steps"],
            "prepare": t["ba_lm_steps"], "finish": t["ba_lm_steps"],
            "cost": t["ba_solves"]}
    used = ("resjac", "prepare", "finish", "cost") + (
        ("matvec16",) if t["ba_cg_iterations"] else ())
    return want, used


def ba_counts(t):
    """The BA counters of a mapping run, for its log line."""
    return (f"{t['ba_solves']} BA solves ({t['ba_dense_solves']} dense), "
            f"{t['ba_lm_steps']} LM steps ({t['ba_dense_lm_steps']} dense), "
            f"{t['ba_cg_iterations']} implicit CG iterations (matvecs), "
            f"{t['ba_dense_cg_iterations']} dense PCG iterations")


def all_dense(phase, t):
    """Raise unless every BA solve of the run solved the dense system (every
    solve of a mapping of at most 32 images on the card: D_ref <= 512)."""
    if not t["ba_dense_solves"] == t["ba_solves"] > 0:
        raise AssertionError(f"{phase}: {ba_counts(t)}; every solve should "
                             f"be dense")


def mapping_phase(tmp):
    """Phase 20: incremental_mapping on the card at bench.py run_mapping's
    size, checked against the truth and launch by launch; the BA kernels at
    the mapper's captured operands; the card against the CPU at 8 images.
    Returns the kernel numbers and the timed run's launches."""
    t20 = time.perf_counter()
    # (g) the native graph library: built from the checkout and loaded
    if native.get_lib() is None:
        raise AssertionError(f"phase 20: the native graph library did not "
                             f"build or load: {native.build_error}")
    log(f"phase 20 native: {native.lib_path().relative_to(ROOT)} loaded")

    # (a) the database
    db = tmp / "map.db"
    gt = write_orbit_database(db, MAP_IMAGES, MAP_POINTS, MAP_NOISE)
    trav = DatabaseCache.load(db).correspondence_graph._get_traversal()
    if trav is None or not trav.native:
        raise AssertionError("phase 20: the correspondence graph does not "
                             "traverse natively")
    opts = mapping_options()

    # (b) the timed run, every launch count zeroed just before it and read
    # just after, recording one global and one local step's operands (the
    # recorder keeps references only)
    zero_counts()
    with ResJacRecorder() as rec_ops:
        rec, dt, t = map_and_check(db, tmp / "map2", gt, opts, "cuda",
                                      "phase 20", MAP_IMAGES)
    launches, plain_on_cuda = read_counts()
    if not rec.num_points3D > MAP_POINTS // 2:
        raise AssertionError(f"phase 20: {rec.num_points3D} points of "
                             f"{MAP_POINTS} reconstructed")
    stages = ("load", "initial_pair", "register", "triangulate", "local_ba",
              "global_ba", "pose_graph", "write")
    log(f"phase 20: {rec.num_reg_images / dt:.4f} registered img/s "
        f"({rec.num_reg_images} / {dt:.3f} s); split "
        + ", ".join(f"{k} {t.get(k, 0.0):.3f} s" for k in stages)
        + "; detail " + json.dumps({k: round(v, 4) for k, v in t.items()
                                    if k not in stages}))
    # (d) launch counts of the timed run: every solve dense
    solves, steps, cg = (t["ba_solves"], t["ba_lm_steps"],
                         t["ba_cg_iterations"])
    log(f"phase 20 launches: {launches}; {ba_counts(t)} "
        f"({t['ba_cache_hits']} resident-cache hits, "
        f"{t['ba_cache_misses']} misses); resjac, prepare and finish once "
        f"per LM step ({steps}), the cost once per solve ({solves})")
    all_dense("phase 20", t)
    launch_check("phase 20", launches, plain_on_cuda, *ba_rule(t))

    # (e) the kernels at the mapper's operands: one global step (the
    # deepest buckets) checked and timed, one local-window step checked
    if rec_ops.global_args is None or rec_ops.local_args is None:
        raise AssertionError("phase 20: no global or local step recorded")
    case_g = mapping_case(rec_ops.global_args, 201)
    case_l = mapping_case(rec_ops.local_args, 202)
    # the same two steps' operands for phase 28's dense system
    steps28 = {"phase 20 global": (rec_ops.global_args, rec_ops.global_dense),
               "phase 20 local": (rec_ops.local_args, rec_ops.local_dense)}
    del rec_ops
    kern, schur = {}, {"prepare": {}, "matvec": {}, "matvec16": {}}
    for tag, case, res in (("mapping global", case_g, kern),
                           ("mapping local", case_l, None)):
        shapes = [tuple(b.mask.shape) for b in case.buckets]
        errs = check_case(case, tag, res)
        errs.update(check_case_schur(
            tag, case, "phase 20", schur if res is not None else None))
        log(f"phase 20 {tag} step: I {case.I}, C {case.C}, buckets [T, P] "
            f"{shapes}; scaled errors "
            + ", ".join(f"{k} {v[1]:.2e}" for k, v in errs.items()))
    kern["matvec16"] = schur["matvec16"]["mapping global"]
    for name, r in kern.items():
        log(f"phase 20 global step {name}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})" + cost_note(r))

    # (f) the card against the CPU on the 8-image database
    db8 = tmp / "map8.db"
    gt8 = write_orbit_database(db8, MAP_PARITY_IMAGES, MAP_PARITY_POINTS)
    opts8 = mapping_options(4)
    out8 = {dev: map_and_check(db8, tmp / f"map8_{dev}", gt8, opts8, dev,
                               f"phase 20 8 images on {dev}",
                               MAP_PARITY_IMAGES - 1)
            for dev in ("cuda", "cpu")}
    if out8["cuda"][0].num_reg_images != out8["cpu"][0].num_reg_images:
        raise AssertionError("phase 20: the card and the CPU register "
                             "different image counts")
    total = time.perf_counter() - t20
    log(f"phase 20: {total:.2f} s")
    return dict(launches=launches, kernels=kern, seconds=total,
                img_per_s=rec.num_reg_images / dt,
                timings=t, lm_steps=steps, cg_iterations=cg, solves=solves,
                dense_cg_iterations=t["ba_dense_cg_iterations"],
                cpu_8=dict(cuda=out8["cuda"][1], cpu=out8["cpu"][1]),
                steps=steps28)


# ---------------------------------------------------------------------------
# phase 21: images to model
# ---------------------------------------------------------------------------


def e2e_options(min_model_size):
    """tests/test_full_pipeline.py's options for its rendered scenes: the
    C2 gate's (min_model_size 6) or the small test's (4); no colors."""
    o = psfm.IncrementalPipelineOptions()
    o.min_model_size = min_model_size
    o.extract_colors = False
    o.min_num_matches = 15
    o.mapper.init_min_num_inliers = 30
    o.mapper.abs_pose_min_num_inliers = 15
    o.mapper.init_min_tri_angle = 4.0
    return o


class MatchRecorder:
    """Wraps the pair matchers' two device calls (through the module
    attributes ``match_features`` calls): descriptor matching per chunk of
    64 pairs and verification per block of 16. Keeps their host wall (each
    returns host arrays, so it includes the device's time), the pairs,
    top-2's shape buckets, the largest block's matches per pair, and the
    blocks' peak device memory above what was allocated before each."""

    def __init__(self):
        self.match_s = self.verify_s = 0.0
        self.matched = self.verified = self.blocks = self.buckets = 0
        self.peak_bytes = self.max_matches = 0

    def __enter__(self):
        self._match = mf.match_descriptors_batch
        self._verify = mf.verify_pairs_batch
        mf.match_descriptors_batch = self._record_match
        mf.verify_pairs_batch = self._record_verify
        return self

    def __exit__(self, *exc):
        mf.match_descriptors_batch = self._match
        mf.verify_pairs_batch = self._verify

    def _record_match(self, pairs, options=None, device=None):
        self.buckets += _buckets([(a, b) for a, b in pairs
                                  if len(a) and len(b)])
        t0 = time.perf_counter()
        out = self._match(pairs, options, device=device)
        self.match_s += time.perf_counter() - t0
        self.matched += len(pairs)
        return out

    def _record_verify(self, pair_data, options=None, device=None):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = self._verify(pair_data, options, device=device)
        self.verify_s += time.perf_counter() - t0
        self.peak_bytes = max(self.peak_bytes,
                              torch.cuda.max_memory_allocated() - base)
        self.verified += len(pair_data)
        self.blocks += 1
        self.max_matches = max([self.max_matches]
                               + [len(p["x1_px"]) for p in pair_data])
        return out


def pair_inliers(db_path):
    """{pair id: inlier count} of a database's two-view geometries."""
    db = Database(db_path)
    try:
        ids, counts = db.read_two_view_geometry_num_inliers()
    finally:
        db.close()
    return dict(zip(ids, counts))


def check_model(recs, gt, tag, min_reg, min_points, centers=True):
    """The largest model against the bounds of tests/test_full_pipeline.py:
    at least `min_reg` registered, more than `min_points` points, mean
    reprojection error under 1.5 px; with `centers`, the C2 gate's median
    rotation error under 0.5 degrees and projection center error under
    0.05 after a similarity alignment. Returns the numbers."""
    if not recs:
        raise AssertionError(f"[{tag}] no model")
    rec = max(recs.values(), key=lambda r: r.num_reg_images)
    rec.check()
    err = rec.compute_mean_reprojection_error()
    rot, ctr = pose_errors(rec, gt)
    out = dict(models=len(recs), registered=rec.num_reg_images,
               points=rec.num_points3D, reproj_px=err,
               median_rot_deg=float(np.median(rot)),
               median_center_err=float(np.median(ctr)))
    log(f"{tag}: {json.dumps(out)}")
    ok = (rec.num_reg_images >= min_reg and rec.num_points3D > min_points
          and err < 1.5)
    if centers:
        ok &= out["median_rot_deg"] < 0.5 and out["median_center_err"] < 0.05
    if not ok:
        raise AssertionError(f"[{tag}] model {out} misses the bounds "
                             f"(registered >= {min_reg}, points > "
                             f"{min_points}, < 1.5 px"
                             + (", rotation < 0.5 deg, center < 0.05)"
                                if centers else ")"))
    return out


def small_scene(tmp, gt, device):
    """tests/test_full_pipeline.py's small flow on render_dense_scene's 6
    images at 512x384 (2,000 features): extract, match exhaustively, map,
    checked at that test's bounds. Returns the seconds, the numbers and
    the database as extracted (before matching)."""
    root = tmp / "small"
    db = root / f"{device}.db"
    so = SiftExtractionOptions()
    so.max_num_features = 2000
    t0 = time.perf_counter()
    extract_features(db, root / "images", sift_options=so, device=device)
    features_only = root / f"{device}_features.db"
    shutil.copy(db, features_only)
    n_verified = match_exhaustive(db, device=device)
    recs = psfm.incremental_mapping(db, root / "images", root / f"{device}_model",
                                    e2e_options(4), device=device)
    dt = time.perf_counter() - t0
    tag = f"phase 21 small scene on {device}"
    log(f"{tag}: {n_verified} of 15 pairs verified, {dt:.2f} s")
    if n_verified < 8:
        raise AssertionError(f"[{tag}] {n_verified} pairs verified (need 8)")
    out = check_model(recs, gt, tag, 5, 50, centers=False)
    return dict(out, seconds=dt, verified=n_verified), features_only


def small_scene_matchers(tmp, gt, features_db, unguided_db):
    """On the card, the other matchers on the small scene's features:
    sequential (overlap 2), spatial (the true poses as priors, written with
    the database's images), and exhaustive again with guided matching, each
    pair's inliers at least the unguided run's (the same blocks draw the
    same samples; guided matching only replaces a geometry by a better
    one). Returns the counts and seconds."""
    root = tmp / "small"
    out = {}
    db = root / "sequential.db"
    shutil.copy(features_db, db)
    t0 = time.perf_counter()
    n = match_sequential(db, matching_options=SequentialMatchingOptions(
        overlap=2))
    out["sequential"] = dict(verified=n, seconds=time.perf_counter() - t0)
    if n < 4:
        raise AssertionError(f"phase 21 sequential: {n} pairs verified "
                             f"(need 4)")

    db = root / "spatial.db"
    d = Database(db)
    try:
        names = sorted(im.name for im in gt.images.values())
        cam_id = d.write_camera(infer_camera_from_image(root / "images"
                                                        / names[0]))
        truth = {im.name: im for im in gt.images.values()}
        for name in names:
            img = Image(name=name, camera_id=cam_id)
            img.cam_from_world_prior = truth[name].cam_from_world
            d.write_image(img)
        d.commit()
    finally:
        d.close()
    so = SiftExtractionOptions()
    so.max_num_features = 2000
    extract_features(db, root / "images", sift_options=so)
    t0 = time.perf_counter()
    n = match_spatial(db, matching_options=SpatialMatchingOptions(
        max_num_neighbors=2, max_distance=2.0))
    out["spatial"] = dict(verified=n, seconds=time.perf_counter() - t0)
    if n < 3:
        raise AssertionError(f"phase 21 spatial: {n} pairs verified (need 3)")

    db = root / "guided.db"
    shutil.copy(features_db, db)
    t0 = time.perf_counter()
    n = match_exhaustive(db, sift_options=SiftMatchingOptions(
        guided_matching=True))
    plain, guided = pair_inliers(unguided_db), pair_inliers(db)
    worse = {k: (v, guided.get(k, 0)) for k, v in plain.items()
             if guided.get(k, 0) < v}
    gained = sum(guided[k] - plain.get(k, 0) for k in guided)
    out["guided"] = dict(verified=n, seconds=time.perf_counter() - t0,
                         inliers_gained=int(gained))
    log(f"phase 21 small-scene matchers on the card: {json.dumps(out)}")
    if worse or set(guided) != set(plain):
        raise AssertionError(f"phase 21 guided matching lost inliers: {worse}")
    return out


def images_to_model_phase(tmp):
    """Phase 21: the README's flow on the card at run_sift's size, checked
    against the truth and launch by launch; the small scene on the card and
    the CPU; the other matchers on the card."""
    t21 = time.perf_counter()
    stages = {}
    t0 = time.perf_counter()
    root = tmp / "e2e"
    gt = render_dense_scene(root, E2E_IMAGES, SIFT_H, SIFT_W, num_points=2)
    stages["render"] = time.perf_counter() - t0
    images, db = root / "images", root / "e2e.db"
    octaves = Sift(SiftExtractionOptions(),
                   "cuda")._static_params(SIFT_H, SIFT_W)[2]

    # (a) images -> database -> model, every launch count zeroed just
    # before and read just after
    zero_counts()
    torch.cuda.synchronize()
    t_start = t0 = time.perf_counter()
    extract_features(db, images)
    stages["extract"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with MatchRecorder() as rm:
        n_verified = match_exhaustive(db)
    stages["match"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    timings = {}
    # the last global step's operands, for phase 28
    with ResJacRecorder() as rec_ops:
        recs = psfm.incremental_mapping(db, images, root / "model",
                                        e2e_options(6), timings=timings)
    stages["map"] = time.perf_counter() - t0
    total = time.perf_counter() - t_start
    launches, plain_on_cuda = read_counts()

    d = Database(db)
    try:
        n_kp, n_db_pairs = d.num_keypoints, d.num_verified_image_pairs
    finally:
        d.close()
    n_pairs = E2E_IMAGES * (E2E_IMAGES - 1) // 2
    model = check_model(recs, gt, "phase 21 model", E2E_IMAGES - 2, 1000)
    reg = model["registered"]
    numbers = dict(
        seconds=stages, images_to_model_s=total,
        registered_img_per_s=reg / stages["map"],
        sift_ms_per_image=stages["extract"] / E2E_IMAGES * 1e3,
        keypoints_per_image=n_kp / E2E_IMAGES,
        pairs=n_pairs, verified=n_verified, geometries_written=n_db_pairs,
        match_ms_per_pair=rm.match_s / max(rm.matched, 1) * 1e3,
        verify_ms_per_pair=rm.verify_s / max(rm.verified, 1) * 1e3,
        match_stage_ms_per_pair=stages["match"] / n_pairs * 1e3,
        verify_blocks=rm.blocks, pairs_in_blocks=rm.verified,
        block_max_matches=rm.max_matches,
        verify_block_peak_mb=rm.peak_bytes / 2**20,
        mapping={k: timings.get(k) for k in (
            "load", "initial_pair", "register", "triangulate", "local_ba",
            "global_ba", "pose_graph", "write", *BA_COUNTERS)},
        model=model)
    log(f"phase 21 images to model ({E2E_IMAGES} images, {SIFT_H}x{SIFT_W}, "
        f"default options): {json.dumps(numbers)}")
    if n_verified < n_pairs / 2:
        raise AssertionError(f"phase 21: {n_verified} of {n_pairs} pairs "
                             f"verified (need half)")

    solves, steps, cg = (timings["ba_solves"], timings["ba_lm_steps"],
                         timings["ba_cg_iterations"])
    want, used = ba_rule(timings)
    want.update(window_sampler=2 * octaves * E2E_IMAGES, top2=2 * rm.buckets)
    log(f"phase 21 launches: {json.dumps(launches)}; expected "
        f"{json.dumps(want)} (the sampler 2 per octave x {octaves} octaves "
        f"per extract over {E2E_IMAGES} extracts, top-2 2 per shape bucket "
        f"over {rm.buckets} buckets of {rm.matched} pairs, resjac, prepare "
        f"and finish once per LM step ({steps}), matvec16 once per implicit "
        f"CG iteration ({cg}), the cost once per solve ({solves})); "
        f"{ba_counts(timings)}")
    all_dense("phase 21", timings)
    launch_check("phase 21", launches, plain_on_cuda, want,
                 ("window_sampler", "top2") + used)
    steps28 = {"phase 21 global": (rec_ops.global_args, rec_ops.global_dense)}
    del rec_ops

    # (b) the small scene on the card and on the CPU, then the other
    # matchers on the card
    gt_small = render_dense_scene(tmp / "small", E2E_SMALL_IMAGES,
                                  E2E_SMALL_H, E2E_SMALL_W, num_points=2)
    small = {}
    for device in ("cuda", "cpu"):
        small[device], features_db = small_scene(tmp, gt_small, device)
        if device == "cuda":
            small["matchers"] = small_scene_matchers(
                tmp, gt_small, features_db, tmp / "small" / "cuda.db")
    numbers["small"] = small
    numbers["phase_s"] = time.perf_counter() - t21
    log(f"phase 21: {numbers['phase_s']:.2f} s")
    return dict(launches=launches, numbers=numbers, steps=steps28)


def read_mesh_ply(path):
    """(vertices [V, 3] float32, faces [F, 3] int32) of a mesh PLY that
    ``write_mesh_ply`` wrote."""
    b = Path(path).read_bytes()
    h = b.index(b"end_header\n") + len(b"end_header\n")
    head = b[:h].decode()
    nv = int(head.split("element vertex ")[1].split()[0])
    verts = np.frombuffer(b[h:h + 12 * nv], "<f4").reshape(nv, 3)
    faces = np.frombuffer(b[h + 12 * nv:],
                          np.dtype([("n", "u1"), ("i", "<i4", (3,))]))["i"]
    return verts, faces


def plane_distance(xyz):
    """Median distance of points to the nearer of phase 14's planes."""
    if not len(xyz):
        return math.inf
    return float(np.median(np.minimum(
        *(np.abs(xyz[:, 2] - z) for z in MVS_PLANES))))


def meshing_phase(dense, model, out):
    """Phase 22: the three meshers on phase 14's workspace (``dense``) and
    phase 21's model, at full size: Poisson on the card by stage and its
    solve on the CPU beside it, dense Delaunay by stage, sparse Delaunay."""
    t22 = time.perf_counter()
    numbers = {}
    # (a) Poisson on the card with default options (a 256^3 grid)
    stages = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poisson_meshing(dense / "fused.ply", out / "poisson.ply", timings=stages)
    wall = time.perf_counter() - t0
    verts, faces = read_mesh_ply(out / "poisson.ply")
    dist = plane_distance(verts[faces].mean(axis=1)) if len(faces) else math.inf
    numbers["poisson"] = dict(seconds=wall, stages=stages, vertices=len(verts),
                              faces=len(faces), median_plane_dist=dist)
    log(f"phase 22 poisson_meshing on the card ({POISSON_N}^3): "
        f"{json.dumps(numbers['poisson'])}")
    if not (len(faces) > 10_000 and dist < 0.02):
        raise AssertionError(f"phase 22: Poisson mesh of {len(faces)} faces "
                             f"at {dist} from the planes (need > 10,000 "
                             "faces at < 0.02)")

    # (b) the same solve on the port's CPU path: chi and the vertex count
    xyz, normals, _ = meshing.read_fused_ply(dense / "fused.ply")
    fields, nverts, secs = {}, {}, {}
    for name in ("cuda", "cpu"):
        t0 = time.perf_counter()
        f = meshing.poisson_field(xyz, normals, POISSON_PARITY_N,
                                  meshing.resolve_device(name))
        v, _ = meshing.marching_tetrahedra(
            f["chi"], f["iso"], f["lo"] + 0.5 * f["spacing"], f["spacing"])
        secs[name] = time.perf_counter() - t0
        fields[name], nverts[name] = f, len(v)
    _, chi_err = scaled_err(fields["cuda"]["chi"], fields["cpu"]["chi"])
    iso_err = abs(fields["cuda"]["iso"] - fields["cpu"]["iso"])
    del fields
    torch.cuda.empty_cache()
    numbers["poisson_parity"] = dict(
        points=len(xyz), chi_scaled_err=chi_err, iso_abs_err=iso_err,
        vertices_card=nverts["cuda"], vertices_cpu=nverts["cpu"],
        field_and_mt_s=secs)
    log(f"phase 22 Poisson card vs CPU: {json.dumps(numbers['poisson_parity'])}")
    if not (chi_err < 1e-4 and abs(nverts["cuda"] - nverts["cpu"])
            <= 0.005 * nverts["cpu"]):
        raise AssertionError("phase 22: the card's chi or vertex count "
                             "disagrees with the CPU's (1e-4 scaled, 0.5%)")

    # (c) dense Delaunay on the workspace: the 200k subsample, the
    # visibility votes and the native min-cut, on the host
    stages = {}
    t0 = time.perf_counter()
    dense_delaunay_meshing(dense, out / "delaunay.ply", timings=stages)
    wall = time.perf_counter() - t0
    verts, faces = read_mesh_ply(out / "delaunay.ply")
    dist = plane_distance(verts[faces].mean(axis=1)) if len(faces) else math.inf
    numbers["dense_delaunay"] = dict(
        seconds=wall, stages=stages, vertices=len(verts), faces=len(faces),
        median_plane_dist=dist, native_min_cut=native.get_lib() is not None)
    log(f"phase 22 dense_delaunay_meshing: "
        f"{json.dumps(numbers['dense_delaunay'])}")
    if not (len(faces) > 0 and dist < 0.02):
        raise AssertionError(f"phase 22: dense Delaunay mesh of {len(faces)} "
                             f"faces at {dist} from the planes (need < 0.02)")

    # (d) sparse Delaunay on phase 21's model
    t0 = time.perf_counter()
    sparse_delaunay_meshing(model, out / "sparse_mesh.ply")
    wall = time.perf_counter() - t0
    verts, faces = read_mesh_ply(out / "sparse_mesh.ply")
    numbers["sparse_delaunay"] = dict(seconds=wall, vertices=len(verts),
                                      faces=len(faces))
    log(f"phase 22 sparse_delaunay_meshing of phase 21's model: "
        f"{json.dumps(numbers['sparse_delaunay'])}")
    if not len(faces):
        raise AssertionError("phase 22: the sparse Delaunay mesh is empty")
    numbers["phase_s"] = time.perf_counter() - t22
    return numbers


def place_of_image(i):
    """Phase 23's place of image i: five consecutive images a place; the
    last RET_REVISITS images revisit places 0, 1, ..."""
    places = (RET_IMAGES - RET_REVISITS) // RET_PER_PLACE
    return (i // RET_PER_PLACE) % places


def write_place_database(path, seed=0):
    """Phase 23's database: each image's descriptors are its place's pool
    plus noise, and RET_SHARED rows of a pool all places share (which idf
    must down-weight) plus noise. Returns the image ids in sequence
    order."""
    rng = np.random.default_rng(seed)
    own = RET_DESCS - RET_SHARED
    places = (RET_IMAGES - RET_REVISITS) // RET_PER_PLACE
    pools = rng.integers(0, 256, (places, own, 128), dtype=np.uint8)
    shared = rng.integers(0, 256, (4 * RET_SHARED, 128), dtype=np.uint8)
    db = Database(path)
    try:
        cam_id = db.write_camera(Camera.create(0, "SIMPLE_PINHOLE", 1125.0,
                                               SIFT_W, SIFT_H))
        ids = []
        for i in range(RET_IMAGES):
            base = np.concatenate([
                pools[place_of_image(i)],
                shared[rng.choice(len(shared), RET_SHARED, replace=False)]])
            noise = rng.integers(-RET_NOISE, RET_NOISE + 1, base.shape,
                                 dtype=np.int16)
            ids.append(db.write_image(Image(name=f"place{i:04d}.ppm",
                                            camera_id=cam_id)))
            db.write_descriptors(ids[-1], np.clip(base + noise, 0, 255)
                                 .astype(np.uint8))
        db.commit()
    finally:
        db.close()
    return ids


def clear_matches(path):
    """A copy of a database's features without its matches or geometries."""
    import sqlite3

    con = sqlite3.connect(path)
    try:
        con.execute("DELETE FROM matches")
        con.execute("DELETE FROM two_view_geometries")
        con.commit()
    finally:
        con.close()


def retrieval_phase(tmp, e2e_db):
    """Phase 23: vocabulary-tree retrieval at 500 of C5's images on the card,
    its recall, the card against the CPU on the first 50 images, and the
    retrieval-driven matchers on a copy of phase 21's database."""
    t23 = time.perf_counter()
    numbers = {}
    t0 = time.perf_counter()
    ids = write_place_database(tmp / "places.db")
    numbers["setup_s"] = time.perf_counter() - t0
    place = {iid: place_of_image(k) for k, iid in enumerate(ids)}
    db = Database(tmp / "places.db")
    try:
        # (a) build_visual_index with defaults: 200k training rows, 4,096
        # words, every descriptor quantized on the card
        stages = {}
        t0 = time.perf_counter()
        tree, index = retrieval.build_visual_index(db, ids, timings=stages)
        build_s = time.perf_counter() - t0
        # a query of every 10th image (retrieve_ranked_pairs below queries
        # all of them)
        rows = range(0, len(ids), 10)
        t0 = time.perf_counter()
        for row in rows:
            index.query_row(row, 5)
        query_s = time.perf_counter() - t0
        numbers["build"] = dict(
            seconds=build_s, stages=stages, words=tree.num_words,
            depth=tree.depth, descriptors=RET_IMAGES * RET_DESCS,
            quantize_ms_per_image=stages["quantize"] / len(ids) * 1e3,
            query_ms_per_image=query_s / len(rows) * 1e3)
        log(f"phase 23 build_visual_index ({RET_IMAGES} images, "
            f"{RET_DESCS} descriptors each): {json.dumps(numbers['build'])}")

        # (b) recall of the entry points
        t0 = time.perf_counter()
        ranked = retrieval.retrieve_ranked_pairs(db, ids, num_images=5)
        ranked_s = time.perf_counter() - t0
        hit = np.mean([any(place[m] == place[q] for m, _ in c)
                       for q, c in ranked])
        t0 = time.perf_counter()
        loops = dict(retrieval.detect_loops(db, ids, period=10))
        loops_s = time.perf_counter() - t0
        planted = [iid for k, iid in enumerate(ids[::10])
                   if place_of_image(10 * k) < RET_REVISITS // RET_PER_PLACE]
        found = np.mean([bool(loops.get(q)) and place[loops[q][0][0]]
                         == place[q] for q in planted])
        numbers["recall"] = dict(
            top5_same_place=float(hit), retrieve_ranked_pairs_s=ranked_s,
            planted_loop_queries=len(planted), loops_found=float(found),
            detect_loops_s=loops_s, loop_queries=len(loops))
        log(f"phase 23 recall: {json.dumps(numbers['recall'])}")
        if hit < 0.95 or found < 0.9:
            raise AssertionError(f"phase 23: top-5 same-place recall {hit} "
                                 f"(need 0.95), planted loops found {found} "
                                 "(need 0.9)")

        # (c) the card against the CPU on the first RET_PARITY_IMAGES
        sub = ids[:RET_PARITY_IMAGES]
        trees, indexes, words, secs = {}, {}, {}, {}
        unit = _to_unit_float(np.concatenate(
            [db.read_descriptors(i) for i in sub]))
        for name in ("cuda", "cpu"):
            t0 = time.perf_counter()
            trees[name], indexes[name] = retrieval.build_visual_index(
                db, sub, device=name)
            words[name] = trees[name].quantize(unit, device=name)
            secs[name] = time.perf_counter() - t0
    finally:
        db.close()
    center_err = max(float(np.abs(a - b).max()) for a, b in
                     zip(trees["cuda"].levels, trees["cpu"].levels))
    same_words = float((words["cuda"] == words["cpu"]).mean())
    lists = {name: [ix.query_row(r, 10) for r in range(len(sub))]
             for name, ix in indexes.items()}
    same_lists = all(
        [m for m, _ in a] == [m for m, _ in b]
        and np.allclose([s for _, s in a], [s for _, s in b], atol=1e-5)
        for a, b in zip(lists["cuda"], lists["cpu"]))
    numbers["parity"] = dict(images=len(sub), center_max_abs_err=center_err,
                             words_equal=same_words, same_ranked_lists=same_lists,
                             seconds=secs)
    log(f"phase 23 card vs CPU: {json.dumps(numbers['parity'])}")
    if not (center_err < 1e-4 and same_words >= 0.999 and same_lists):
        raise AssertionError("phase 23: the card's tree, words or ranked lists "
                             "disagree with the CPU's")

    # (d) the retrieval-driven matchers on phase 21's 30 images
    matchers = {}
    buckets = 0
    for name, call in (
            ("match_vocabtree", lambda p: match_vocabtree(
                p, matching_options=VocabTreeMatchingOptions(num_images=10))),
            ("match_sequential_loops", lambda p: match_sequential(
                p, matching_options=SequentialMatchingOptions(
                    overlap=2, loop_detection=True,
                    loop_detection_period=5)))):
        path = tmp / f"{name}.db"
        shutil.copy(e2e_db, path)
        clear_matches(path)
        with MatchRecorder() as rm:
            t0 = time.perf_counter()
            verified = call(path)
            wall = time.perf_counter() - t0
        buckets += rm.buckets
        matchers[name] = dict(seconds=wall, candidates=rm.matched,
                              verified=verified, top2_buckets=rm.buckets,
                              match_s=rm.match_s, verify_s=rm.verify_s)
        if not (rm.matched and verified >= rm.matched / 2):
            raise AssertionError(f"phase 23: {name} verified {verified} of "
                                 f"{rm.matched} candidate pairs (need half)")
    numbers["matchers"] = matchers
    log(f"phase 23 matchers on phase 21's database: {json.dumps(matchers)}")
    numbers["phase_s"] = time.perf_counter() - t23
    return numbers, buckets


# ---------------------------------------------------------------------------
# phases 24-26: hierarchical mapping, the rig pose, two camera models
# ---------------------------------------------------------------------------


def axis_rotation(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def sim3_gap(a, b):
    """Largest difference of two Sim3s' scale, rotation matrix entries and
    translation, each scaled by max(1, |b's value|)."""
    return max(abs(a.scale - b.scale) / max(1.0, abs(b.scale)),
               float(np.abs(a.rotation.matrix() - b.rotation.matrix()).max()),
               float(np.abs(a.translation - b.translation).max())
               / max(1.0, float(np.abs(b.translation).max())))


def align_to_locations_check(rec, gt):
    """Phase 24 (b): ``align_reconstruction_to_locations`` of the merged
    model onto its images' true centers under a known Sim3 (scale 2, a 0.3
    rad turn, a shift) plus 0.01 noise, 10% of them gross outliers, on the
    card and on the CPU (the same inputs and seed). The residuals carry the
    model's own center errors, doubled by the scale, so the alignment is
    held to the least-squares Sim3 of the planted inliers (float64
    Umeyama): every planted outlier rejected, every planted inlier within
    0.01 of its residual there, and the card's Sim3 within 1e-4 of the
    CPU's."""
    rng = np.random.default_rng(24)
    truth = {img.name: img for img in gt.images.values()}
    names = [rec.images[i].name for i in rec.reg_image_ids]
    centers = np.stack([rec.images[i].projection_center()
                        for i in rec.reg_image_ids])
    R = axis_rotation([0.2, 1.0, -0.3], 0.3)
    shift = np.array([10.0, -5.0, 2.0])
    locations = np.stack([2.0 * R @ truth[n].projection_center() + shift
                          for n in names])
    locations += rng.normal(0, 0.01, locations.shape)
    bad = rng.random(len(names)) < 0.1
    locations[bad] += rng.choice([-1.0, 1.0], (int(bad.sum()), 3)) \
        * rng.uniform(5.0, 10.0, (int(bad.sum()), 3))
    opts = est.RANSACOptions()
    opts.max_error = 0.1
    tf, ms = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        tf[dev] = est.align_reconstruction_to_locations(
            rec, names, locations, 3, opts, device=dev)
        ms[dev] = (time.perf_counter() - t0) * 1e3
        if tf[dev] is None:
            raise AssertionError(f"phase 24 locations on {dev}: no Sim3")
    oracle = est_alignment._sim3_from_umeyama(centers[~bad], locations[~bad])
    resid = np.linalg.norm(tf["cuda"] * centers - locations, axis=1)
    best = np.linalg.norm(oracle * centers - locations, axis=1)
    gap = sim3_gap(tf["cuda"], tf["cpu"])
    out = dict(images=len(names), outliers=int(bad.sum()),
               scale=tf["cuda"].scale, max_inlier_resid=float(
                   resid[~bad].max()), max_inlier_resid_least_squares=float(
                   best[~bad].max()),
               max_gap_to_least_squares=float(
                   np.abs(resid - best)[~bad].max()),
               min_outlier_resid=float(resid[bad].min()) if bad.any()
               else None, card_cpu_gap=gap, card_ms=ms["cuda"],
               cpu_ms=ms["cpu"])
    log(f"phase 24 align_reconstruction_to_locations: {json.dumps(out)}")
    if not (out["max_gap_to_least_squares"] < 0.01 and gap < 1e-4
            and (out["min_outlier_resid"] or math.inf) > opts.max_error):
        raise AssertionError(f"phase 24 locations: an inlier center maps "
                             f"{out['max_gap_to_least_squares']:.4f} from "
                             f"the least-squares Sim3 (need < 0.01), an "
                             f"outlier within {opts.max_error}, or card and "
                             f"CPU differ by {gap:.2e} (need < 1e-4)")
    return out


def hierarchical_phase(tmp):
    """Phase 24: ``hierarchical_mapping`` of a 90-image sequential database
    in 3 parts (overlap 6) on the card, checked against the truth and launch
    by launch; then the merged model aligned to located centers."""
    t24 = time.perf_counter()
    db = tmp / "hier.db"
    gt, kp_pid, n_pairs = write_sequential_database(
        db, HIER_IMAGES, HIER_POINTS, HIER_NOISE)
    seen = np.bincount(np.concatenate(kp_pid), minlength=HIER_POINTS)
    shared = [len(np.intersect1d(kp_pid[i], kp_pid[i + 1]))
              for i in range(HIER_IMAGES - 1)]
    data = dict(images=HIER_IMAGES, points=HIER_POINTS,
                points_per_image=float(np.mean([len(k) for k in kp_pid])),
                images_per_point=float(seen[seen > 0].mean()),
                verified_pairs=n_pairs, min_neighbour_shared=min(shared),
                seconds=time.perf_counter() - t24)
    log(f"phase 24 database: {json.dumps(data)}")

    zero_counts()
    timings = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recs = hierarchical_mapping(db, tmp, tmp / "hier", HIER_PARTS,
                                HIER_OVERLAP, options=mapping_options(),
                                device="cuda", timings=timings)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, plain_on_cuda = read_counts()
    if not recs:
        raise AssertionError("phase 24: no model")
    rec = recs[0]
    err = rec.compute_mean_reprojection_error()
    rot = float(np.median(pose_errors(rec, gt)[0]))
    cmp = est.compare_reconstructions(rec, gt, "proj_center")
    rot_cmp = float(np.median([e.rotation_error_deg for e in cmp["errors"]]))
    rec.check()
    back = Reconstruction(tmp / "hier" / "0")
    parts = timings["parts"]
    stages = ("load", "initial_pair", "register", "triangulate", "local_ba",
              "global_ba", "pose_graph", "write")
    for k, p in enumerate(parts):
        log(f"phase 24 part {k}: {p['images']} images, {p['registered']} "
            f"registered in {p['seconds']:.2f} s "
            f"({p['registered'] / p['seconds']:.4f} registered img/s); "
            + ", ".join(f"{s} {p['timings'].get(s, 0.0):.3f} s"
                        for s in stages)
            + f"; {ba_counts(p['timings'])}")
    numbers = dict(
        seconds=dt, registered=rec.num_reg_images, models=len(recs),
        img_per_s=rec.num_reg_images / dt, points3D=rec.num_points3D,
        err=err, rot_pose_errors=rot, rot_compare=rot_cmp,
        partition_s=timings["partition"], merge_s=timings["merge"],
        parts=[dict(images=p["images"], registered=p["registered"],
                    seconds=p["seconds"],
                    img_per_s=p["registered"] / p["seconds"],
                    **{s: p["timings"].get(s, 0.0) for s in stages})
               for p in parts])
    log(f"phase 24 hierarchical_mapping ({HIER_PARTS} parts, overlap "
        f"{HIER_OVERLAP}): {rec.num_reg_images} of {HIER_IMAGES} registered "
        f"in {dt:.2f} s ({numbers['img_per_s']:.4f} registered img/s), "
        f"{len(recs)} model(s), {rec.num_points3D} points, mean "
        f"reprojection error {err:.4f} px, median rotation error {rot:.4f} "
        f"deg (compare_reconstructions {rot_cmp:.4f}); partition "
        f"{timings['partition']:.3f} s, merge {timings['merge']:.3f} s")
    # the BA kernels as in phase 20, summed over the parts (windows of at
    # most 32 images solve densely, larger solves implicitly)
    ba = {k: sum(p["timings"][k] for p in parts) for k in BA_COUNTERS}
    log(f"phase 24 launches: {launches}; {ba_counts(ba)}")
    launch_check("phase 24", launches, plain_on_cuda, *ba_rule(ba))
    if not (rec.num_reg_images >= HIER_IMAGES - 4 and err < 1.0
            and rot < 0.5 and abs(rot - rot_cmp) < 0.01):
        raise AssertionError(f"phase 24: {rec.num_reg_images} registered "
                             f"(need {HIER_IMAGES - 4}), error {err:.4f} px, "
                             f"rotation {rot:.4f} / {rot_cmp:.4f} deg")
    if (sorted(back.reg_image_ids) != sorted(rec.reg_image_ids)
            or back.num_points3D != rec.num_points3D):
        raise AssertionError("phase 24: the model read back differs")

    numbers["locations"] = align_to_locations_check(rec, gt)
    numbers["phase_s"] = time.perf_counter() - t24
    numbers.update({k[3:]: v for k, v in ba.items()})
    log(f"phase 24: {numbers['phase_s']:.2f} s")
    return dict(launches=launches, numbers=numbers)


def rig_case(seed=25):
    """Phase 25's rig: four PINHOLE cameras (f 1000, run_sift's 960x1280)
    facing front, back, left and right, 0.1 from the rig origin (0.2
    apart); RIG_OBS correspondences, observation i in camera i % 4 at a
    random pixel and depth 3-8, 0.5 px noise, 30% replaced by random
    pixels. Returns (camera, per-observation cams_from_rig, pixels, world
    points, true rig_from_world, outlier mask)."""
    rng = np.random.default_rng(seed)
    cam = est_camera()
    f, n = EST_F, RIG_OBS
    cams = []
    for d in ([0, 0, 1], [0, 0, -1], [1, 0, 0], [-1, 0, 0]):
        fwd = np.asarray(d, np.float64)
        right = np.cross([0.0, -1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        cams.append(Rigid3d(Rotation3d(R), -R @ (0.1 * fwd)))
    truth = Rigid3d(Rotation3d(np.array([0.1, -0.2, 0.05])),
                    np.array([0.3, 0.1, 1.0]))
    idx = np.arange(n) % len(cams)
    xy = rng.uniform([0, 0], [SIFT_W, SIFT_H], (n, 2))
    depth = rng.uniform(3.0, 8.0, n)
    X_cam = np.stack([(xy[:, 0] - SIFT_W / 2) / f, (xy[:, 1] - SIFT_H / 2)
                      / f, np.ones(n)], axis=1) * depth[:, None]
    world_from_rig = truth.inverse()
    X = np.zeros((n, 3))
    for k, c in enumerate(cams):
        sel = idx == k
        X[sel] = world_from_rig * (c.inverse() * X_cam[sel])
    obs = xy + rng.normal(0, 0.5, (n, 2))
    bad = rng.random(n) < 0.3
    obs[bad] = rng.uniform([0, 0], [SIFT_W, SIFT_H], (int(bad.sum()), 2))
    return cam, [cams[k] for k in idx], obs, X, truth, bad


def rig_phase():
    """Phase 25: ``rig_absolute_pose_estimation`` of a four-camera rig on
    the card and on the CPU against the truth, timed as phase 19 times the
    estimators, with the share of minimal samples whose three observations
    share a camera."""
    t25 = time.perf_counter()
    cam, extr, obs, X, truth, bad = rig_case()
    zero_counts()

    def check(r, where):
        pose = r["rig_from_world"]
        err_r = _rot_deg(pose, truth)
        err_t = float(np.abs(pose.translation - truth.translation).max())
        inl = r["inliers"]
        if not (err_r < 0.5 and err_t < 0.05):
            raise AssertionError(f"phase 25 {where}: rotation {err_r} deg, "
                                 f"translation {err_t}")
        return dict(inliers=int(r["num_inliers"]), rot_err_deg=err_r,
                    t_err=err_t, true_inliers_kept=int((inl & ~bad).sum()),
                    outliers_kept=int((inl & bad).sum()))

    rec = est_measure(
        f"rig pose, 4 cameras, {RIG_OBS} correspondences, 30% outliers",
        lambda d: est.rig_absolute_pose_estimation(
            obs, X, [cam] * RIG_OBS, extr, device=d), check,
        phase="phase 25")
    stats = {}
    est.rig_absolute_pose_estimation(obs, X, [cam] * RIG_OBS, extr,
                                     device="cuda", stats=stats)
    rec.update(samples=stats["samples"], valid_samples=stats["valid_samples"],
               valid_share=stats["valid_samples"] / stats["samples"])
    launch_check("phase 25", *read_counts(), {}, ())
    rec["phase_s"] = time.perf_counter() - t25
    log(f"phase 25: {rec['phase_s']:.2f} s; {stats['samples']} samples, "
        f"{stats['valid_samples']} within one camera (share "
        f"{rec['valid_share']:.4f}; 1/16 = 0.0625 expected)")
    return rec


def mixed_mapping_phase(tmp):
    """Phase 26: ``incremental_mapping`` of phase 20's orbit with the
    images alternating between a SIMPLE_RADIAL and a PINHOLE camera, on the
    card, every launch count zeroed just before and read just after; the
    mixed kernels held to their plain versions and timed at one recorded
    global step of the mapping."""
    t26 = time.perf_counter()
    db = tmp / "mixed.db"
    cameras = [Camera.create(1, "SIMPLE_RADIAL", 600.0, 640, 480),
               Camera.create(2, "PINHOLE", 600.0, 640, 480)]
    gt = write_orbit_database(db, MAP_IMAGES, MAP_POINTS, MAP_NOISE,
                              cameras=cameras)
    opts = mapping_options(4)
    opts.ba_refine_principal_point = False
    zero_counts()
    with ResJacRecorder() as rec_ops:
        rec, dt, t = map_and_check(db, tmp / "mixed", gt, opts, "cuda",
                                   "phase 26 two camera models",
                                   MAP_IMAGES - 1)
    launches, plain_on_cuda = read_counts()
    models = sorted({c.model for c in rec.cameras.values()})
    if models != ["PINHOLE", "SIMPLE_RADIAL"]:
        raise AssertionError(f"phase 26: camera models {models}")
    solves, steps, cg = t["ba_solves"], t["ba_lm_steps"], t["ba_cg_iterations"]
    log(f"phase 26 launches: {launches}; {ba_counts(t)}; "
        f"{launches['resjac'] + launches['resjac_mixed']} resjac launches "
        f"({launches['resjac_mixed']} mixed)")
    all_dense("phase 26", t)
    # the single-model forms serve windows of one camera model, if any;
    # matvec16 only on implicit steps
    used = ("resjac_mixed", "cost_mixed", "finish_mixed", "prepare") + tuple(
        k for k in ("resjac", "cost", "finish") if launches[k]) + (
        ("matvec16",) if cg else ())
    launch_check("phase 26", launches, plain_on_cuda,
                 {"matvec16": cg, "prepare": steps,
                  "resjac+resjac_mixed": steps,
                  "finish+finish_mixed": steps, "cost+cost_mixed": solves},
                 used)
    if rec_ops.global_args is None:
        raise AssertionError("phase 26: no global step recorded")
    case = mapping_case(rec_ops.global_args, 261)
    steps28 = {"phase 26 global": (rec_ops.global_args, rec_ops.global_dense)}
    del rec_ops
    if not isinstance(case.model_id, tuple):
        raise AssertionError(f"phase 26: the recorded global step has model "
                             f"{case.model_id}, not two")
    kern, schur = {}, {"prepare": {}, "matvec": {}, "matvec16": {}}
    shapes = [tuple(b.mask.shape) for b in case.buckets]
    errs = check_case(case, "mixed mapping global", kern)
    errs.update(check_case_schur("mixed mapping global", case, "phase 26",
                                 schur))
    kern["matvec16"] = schur["matvec16"]["mixed mapping global"]
    log(f"phase 26 global step: model {case.model_id}, NP {case.NP}, I "
        f"{case.I}, C {case.C}, buckets [T, P] {shapes}; scaled errors "
        + ", ".join(f"{k} {v[1]:.2e}" for k, v in errs.items()))
    for name, r in kern.items():
        log(f"phase 26 global step {name}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), max abs err {r['max_abs_err']:.3e}"
            + cost_note(r))
    numbers = dict(seconds=dt, registered=rec.num_reg_images,
                   img_per_s=rec.num_reg_images / dt, err=t["err"],
                   rot=t["rot"], models=models, solves=solves, lm_steps=steps,
                   cg_iterations=cg, phase_s=time.perf_counter() - t26)
    log(f"phase 26: {numbers['phase_s']:.2f} s")
    return dict(launches=launches, kernels=kern, numbers=numbers,
                steps=steps28)


def policy_resources(source, kinds):
    """ptxas registers and spill bytes of every instance of the kernels
    `kinds` (names before ``_kernel``) of a BA source, by (kernel, camera
    policy, model id or width)."""
    import re

    out, name = {}, None
    pat = (r"Compiling entry function '_Z\d+(" + "|".join(kinds)
           + r")_kernelI\d+(Single|Mixed)ILi(\d+)E")
    for ln in _cuda_build.source_log(source).splitlines():
        m = re.search(pat, ln)
        if m:
            name = (m[1], m[2], int(m[3]))
            out[name] = {}
        elif "Compiling entry function" in ln:
            name = None
        elif name and "spill stores" in ln:
            v = re.findall(r"(\d+) bytes spill (stores|loads)", ln)
            out[name].update({f"spill_{k}": int(b) for b, k in v})
        elif name and "Used" in ln and "registers" in ln:
            out[name]["registers"] = int(ln.split("Used ")[1].split()[0])
    return out


def cost_resources():
    """ptxas registers and spill bytes of every cost and finish instance
    (sfm/csrc/cost.cu), by kernel and camera policy, with its resident
    blocks per SM and dynamic shared memory."""
    out = policy_resources("sfm/csrc/cost.cu", ("cost", "finish"))
    for (kind, pol, n), r in out.items():
        r.update(sfm_cuda.cost_config(kind == "finish", pol == "Mixed", n))
    return {f"{k} {p}<{n}>": r for (k, p, n), r in out.items()}


def resjac_resources():
    """ptxas registers and spill bytes of every resjac instance
    (sfm/csrc/resjac.cu), by camera policy."""
    out = policy_resources("sfm/csrc/resjac.cu", ("resjac",))
    return {f"{k} {p}<{n}>": r for (k, p, n), r in out.items()}


def kernel_resources(source):
    """ptxas registers and spill bytes of each kernel of one source, by
    kernel name (template arguments as <a,b,...>)."""
    import re

    out, name = {}, None
    for ln in _cuda_build.source_log(source).splitlines():
        m = re.search(r"Compiling entry function '_Z(\d+)(\w+)'", ln)
        if m:
            n = int(m[1])
            base, rest = m[2][:n], m[2][n:]
            args = re.findall(r"L[a-z](\d+)E", rest.split("Ev")[0] + "E") \
                if rest.startswith("I") else []
            name = base + (f"<{','.join(args)}>" if args else "")
            out[name] = {}
        elif name and "spill stores" in ln:
            v = re.findall(r"(\d+) bytes spill (stores|loads)", ln)
            out[name].update({f"spill_{k}": int(b) for b, k in v})
        elif name and "Used" in ln and "registers" in ln:
            out[name]["registers"] = int(ln.split("Used ")[1].split()[0])
    return out


def resjac_row(r, resources, policy):
    """resjac's extra fields of its JSON row: the every-slot bound, host
    wall and device ops per call as the LM step calls it (its table built
    once per solve), the table's host wall and a call's that builds its
    own, and the instance's registers and spills."""
    keys = ("bound_ms_full", "call_host_ms", "device_ops", "build_host_ms",
            "call_host_ms_table")
    return dict({k: r[k] for k in keys if k in r}, launches_per_call=1,
                resources=resources[f"resjac {policy}"])


def cost_row(r, resources, kind, policy):
    """Cost and finish's extra fields of their JSON row: the every-slot
    bound, host wall and device ops per call, the per-LM-step table's host
    wall (finish), and the instance's registers, spills and occupancy."""
    keys = ("bound_ms_full", "call_host_ms", "device_ops", "build_host_ms")
    return dict({k: r[k] for k in keys if k in r}, launches_per_call=1,
                resources=resources[f"{kind} {policy}"])


# ---------------------------------------------------------------------------
# phase 27: multi-device bundle adjustment
# ---------------------------------------------------------------------------


class SolveRecorder:
    """Keeps the LMResult of each ResidentBundleSolver solve (through the
    class attribute that solve_bundle's solver and the mapper's cache
    call), for the launch rule: its LM steps and CG iterations."""

    def __enter__(self):
        self.results = []
        self._solve = ResidentBundleSolver.solve
        outer = self

        def solve(solver, *args, **kw):
            out = outer._solve(solver, *args, **kw)
            outer.results.append(solver.last_result)
            return out

        ResidentBundleSolver.solve = solve
        return self

    def __exit__(self, *exc):
        ResidentBundleSolver.solve = self._solve

    def want(self, shards):
        """Per shard, the launches of phase 4's rule: resjac, prepare and
        finish once per LM step, matvec16 once per CG iteration, the cost
        once per solve."""
        steps = sum(r.iterations for r in self.results)
        cg = sum(r.cg_iterations for r in self.results)
        return {"matvec16": shards * cg, "resjac": shards * steps,
                "prepare": shards * steps, "finish": shards * steps,
                "cost": shards * len(self.results)}


def sharded_run(tag, shards, fn):
    """fn() with every launch count zeroed just before and read just after,
    its LM results recorded, timed (fn ends in a host read), and the launch
    rule of `shards` shards checked. Returns (fn(), seconds, launches,
    the rule's counts)."""
    torch.cuda.synchronize()
    zero_counts()
    with SolveRecorder() as rec:
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
    launches, plain_on_cuda = read_counts()
    want = rec.want(shards)
    launch_check(tag, launches, plain_on_cuda, want,
                 ("resjac", "prepare", "finish", "cost", "matvec16"))
    log(f"{tag}: {dt:.3f} s; {shards} shard(s), launches "
        f"{ {k: v for k, v in launches.items() if v} } ({want} by the "
        f"rule: {len(rec.results)} solve(s), "
        f"{sum(r.iterations for r in rec.results)} LM steps, "
        f"{sum(r.cg_iterations for r in rec.results)} CG iterations)")
    return out, dt, launches, want


def rel_diff(a, b):
    """max |a - b| / max(1, max |b|) of two arrays, and |a - b| / |b| of
    two numbers."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.ndim == 0:
        return float(abs(a - b) / max(abs(b), 1e-30))
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def shard_solve(problem, mesh=None, device=None):
    """Phase 27's solve of the bench bundle through ``solve_bundle``: on
    `mesh`, or unsharded on `device`. Returns (problem, summary)."""
    opts = options(SHARD_LM_ITERS)
    opts.devices = "none"
    return sfm_solve_bundle(problem, opts, cg_iters=SHARD_CG_ITERS,
                            device=device, mesh=mesh)


def phase27_rank(rank, port, out):
    """One gloo rank of phase 27 (b): a process of ``chip_smoke.py
    --phase27-rank RANK PORT OUT``, one shard on cuda:0, writing its
    result and launch counts to OUT/rank<RANK>.npz."""
    torch.backends.cuda.matmul.allow_tf32 = False
    got = pdist.init_distributed(f"127.0.0.1:{port}", 2, rank,
                                 backend="gloo", timeout_s=RANK_TIMEOUT_S)
    if got != (rank, 2):
        raise AssertionError(f"rank {rank} joined as {got}")
    try:
        _cuda_build.libs()
        mesh = make_obs_mesh(["cuda:0"],
                             group=torch.distributed.group.WORLD)
        bench = make_synthetic_bundle(**BENCH)
        (problem, s), dt, launches, _ = sharded_run(
            f"phase 27 (b) rank {rank}", 1, lambda: shard_solve(bench, mesh))
        np.savez(Path(out) / f"rank{rank}.npz",
                 summary=np.array([s.initial_cost, s.final_cost,
                                   s.num_iterations, dt], np.float64),
                 cam_quat=problem.cam_quat.numpy(),
                 cam_trans=problem.cam_trans.numpy(),
                 points=problem.points.numpy(),
                 launches=json.dumps({k: v for k, v in launches.items()
                                      if v}))
        pdist.barrier()
    finally:
        torch.distributed.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharded_phase(tmp, model_implicit):
    """Phase 27: multi-device bundle adjustment on the one card, every
    launch count zeroed just before and read just after each part: (a)
    the bench bundle through ``solve_bundle`` on a two-shard mesh of
    cuda:0 against the unsharded solve, then ``dryrun_multichip(2)``; (b)
    two gloo processes of one shard each against (a)'s two-shard solve;
    (d) phase 20's mapping with ``options.devices`` the two-shard mesh
    against `model_implicit`, phase 28 (b)'s unsharded mapping of the same
    orbit on the implicit PCG, the only solver on a mesh (phase 20's own
    run solves densely); (c) one NCCL rank's one-shard mesh
    against the unsharded solve. (b)'s processes run first and are joined
    before (a) starts, so (a) and (d) have the card to themselves. Returns
    the numbers and each part's launches."""
    t27 = time.perf_counter()
    numbers, launches = {}, {}
    mesh = make_obs_mesh(list(SHARD_DEVICES))

    # (b) starts: two gloo processes on cuda:0, one shard each
    out = tmp / "ranks"
    out.mkdir()
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--phase27-rank",
         str(k), str(port), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for k in range(2)]
    bench = make_synthetic_bundle(**BENCH)
    try:
        texts = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    b_seconds = time.perf_counter() - t27
    numbers["a"], ref1, ref2, launches["a"] = shard_part_a(bench, mesh)
    numbers["b"], launches["b"] = shard_part_b(
        out, texts, [p.returncode for p in procs], ref2, b_seconds)
    numbers["d"], launches["d"] = shard_part_d(tmp, mesh, model_implicit)
    numbers["c"], launches["c"] = shard_part_c(bench, ref1)
    numbers["seconds"] = time.perf_counter() - t27
    log(f"phase 27: {numbers['seconds']:.2f} s (b "
        f"{numbers['b']['seconds']:.1f} from the start to both ranks' exit, "
        f"a {numbers['a']['unsharded_s'] + numbers['a']['sharded_s']:.1f} + "
        f"dryrun {numbers['a']['dryrun_s']:.1f}, d "
        f"{numbers['d']['seconds']:.1f}, c {numbers['c']['seconds']:.1f})")
    return dict(numbers=numbers, launches=launches)


def shard_part_a(bench, mesh):
    """Phase 27 (a): the bench bundle `bench` on `mesh` against the
    unsharded solve, then ``dryrun_multichip(2)``. Returns the numbers, the
    two solves' results (unsharded, sharded) and the launches."""
    (p1, s1), dt1, _, _ = sharded_run(
        "phase 27 (a) unsharded", 1,
        lambda: shard_solve(bench, device="cuda"))
    (p2, s2), dt2, launches, _ = sharded_run(
        "phase 27 (a) 2 shards", 2, lambda: shard_solve(bench, mesh))
    d_trans = float((p2.cam_trans - p1.cam_trans).abs().max())
    a = dict(unsharded=s1._asdict(), sharded=s2._asdict(),
             unsharded_s=dt1, sharded_s=dt2,
             initial_rel=rel_diff(s2.initial_cost, s1.initial_cost),
             final_rel=rel_diff(s2.final_cost, s1.final_cost),
             cam_trans_max_abs=d_trans)
    log(f"phase 27 (a): unsharded {s1} in {dt1:.3f} s, 2 shards {s2} in "
        f"{dt2:.3f} s; initial cost rel {a['initial_rel']:.2e} (tol 1e-4), "
        f"final {a['final_rel']:.2e} (tol 1e-3), camera translations "
        f"{d_trans:.2e} (tol 1e-3)")
    if not (s2.num_iterations == s1.num_iterations
            and a["initial_rel"] <= 1e-4 and a["final_rel"] <= 1e-3
            and d_trans <= 1e-3 and s2.final_cost < s2.initial_cost):
        raise AssertionError(f"phase 27 (a): the sharded solve {s2} differs "
                             f"from the unsharded {s1}")
    dry, dt, dry_launches, _ = sharded_run(
        "phase 27 (a) dryrun_multichip(2)", 2, lambda: dryrun_multichip(2))
    a.update(dryrun=dry, dryrun_s=dt)
    log(f"phase 27 (a) dryrun_multichip(2): {json.dumps(dry)}")
    refs = [dict(summary=s, cam_quat=p.cam_quat.numpy(),
                 cam_trans=p.cam_trans.numpy(), points=p.points.numpy())
            for p, s in ((p1, s1), (p2, s2))]
    return (a, *refs,
            {k: v + dry_launches[k] for k, v in launches.items()})


def shard_part_d(tmp, mesh, model_implicit):
    """Phase 27 (d): phase 20's mapping with ``options.devices`` `mesh`,
    against phase 28 (b)'s implicit unsharded model of the same orbit.
    Returns the numbers and the launches."""
    db = tmp / "map.db"
    gt = write_orbit_database(db, MAP_IMAGES, MAP_POINTS, MAP_NOISE)
    opts = mapping_options()
    opts.devices = mesh
    (rec, dt, t), _, launches, _ = sharded_run(
        "phase 27 (d) incremental_mapping", 2,
        lambda: map_and_check(db, tmp / "map27", gt, opts, "cuda",
                              "phase 27 (d)", MAP_IMAGES - 1))
    cmp = est.compare_reconstructions(rec, model_implicit)
    if cmp is None:
        raise AssertionError("phase 27 (d): no alignment to the implicit "
                             "unsharded model")
    rot = float(np.median([e.rotation_error_deg for e in cmp["errors"]]))
    err20 = model_implicit.compute_mean_reprojection_error()
    d = dict(seconds=dt, img_per_s=rec.num_reg_images / dt,
             registered=rec.num_reg_images, err=t["err"],
             err_implicit=err20, rot_vs_implicit=rot,
             lm_steps=t["ba_lm_steps"],
             cg_iterations=t["ba_cg_iterations"], solves=t["ba_solves"],
             split={k: t.get(k, 0.0) for k in ("register", "local_ba",
                                               "global_ba")})
    log(f"phase 27 (d): {rec.num_reg_images} registered in {dt:.2f} s "
        f"({d['img_per_s']:.4f} img/s), {t['err']:.4f} px against the "
        f"implicit unsharded model's {err20:.4f}; median rotation against "
        f"it {rot:.4f} deg (tol 0.1); {json.dumps(d['split'])}")
    if not (rot < 0.1 and abs(t["err"] - err20) < 0.05):
        raise AssertionError(f"phase 27 (d): rotation {rot:.4f} deg, "
                             f"reprojection {t['err']:.4f} against "
                             f"{err20:.4f} px")
    return d, launches


def shard_part_b(out, texts, codes, ref2, seconds):
    """Phase 27 (b): the two gloo ranks' results (in `out`; their output
    `texts`, exit codes `codes`) against each other and against (a)'s
    two-shard solve `ref2`. Returns the numbers and the ranks' launches
    summed."""
    r = []
    for k, (text, code) in enumerate(zip(texts, codes)):
        log("\n".join(f"phase 27 (b) rank {k} | {ln}"
                      for ln in text.strip().splitlines()[-6:]))
        if code != 0:
            raise AssertionError(f"phase 27 (b): rank {k} exited {code}")
        r.append(np.load(out / f"rank{k}.npz"))
    b = dict(seconds=seconds,
             rank_solve_s=[float(x["summary"][3]) for x in r],
             ranks_final_rel=rel_diff(r[0]["summary"][1], r[1]["summary"][1]),
             ranks_quat=float(np.abs(r[0]["cam_quat"][1]
                                     - r[1]["cam_quat"][1]).max()),
             ranks_point=float(np.abs(r[0]["points"][7]
                                      - r[1]["points"][7]).max()),
             vs_a={f: rel_diff(r[0][f], ref2[f])
                   for f in ("cam_quat", "cam_trans", "points")})
    b["vs_a"].update(initial_cost=rel_diff(r[0]["summary"][0],
                                           ref2["summary"].initial_cost),
                     final_cost=rel_diff(r[0]["summary"][1],
                                         ref2["summary"].final_cost))
    launches = {}
    for x in r:
        for k, v in json.loads(str(x["launches"])).items():
            launches[k] = launches.get(k, 0) + v
    log(f"phase 27 (b): ranks agree: final cost rel "
        f"{b['ranks_final_rel']:.2e} (tol 1e-5), quaternion "
        f"{b['ranks_quat']:.2e}, point {b['ranks_point']:.2e} (tol 1e-5); "
        f"rank 0 against (a)'s two shards {json.dumps(b['vs_a'])} (tol "
        f"1e-6)")
    if not (r[0]["summary"][2] == r[1]["summary"][2]
            == ref2["summary"].num_iterations
            and b["ranks_final_rel"] <= 1e-5 and b["ranks_quat"] <= 1e-5
            and b["ranks_point"] <= 1e-5
            and max(b["vs_a"].values()) <= 1e-6):
        raise AssertionError("phase 27 (b): the ranks disagree, or differ "
                             "from (a)'s two-shard solve")
    return b, launches


def shard_part_c(bench, ref1):
    """Phase 27 (c): one NCCL rank, the bench bundle `bench` on a one-shard
    mesh over its group, against the unsharded solve `ref1`. Returns the
    numbers and the launches."""
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        nccl = make_obs_mesh(["cuda:0"], group=torch.distributed.group.WORLD)
        (p3, s3), dt, launches, _ = sharded_run(
            "phase 27 (c) one NCCL rank", 1,
            lambda: shard_solve(bench, nccl))
    finally:
        torch.distributed.destroy_process_group()
    c = dict(seconds=dt, vs_unsharded={
        f: rel_diff(getattr(p3, f).numpy(), ref1[f])
        for f in ("cam_quat", "cam_trans", "points")})
    c["vs_unsharded"].update(
        initial_cost=rel_diff(s3.initial_cost, ref1["summary"].initial_cost),
        final_cost=rel_diff(s3.final_cost, ref1["summary"].final_cost))
    log(f"phase 27 (c): {s3} in {dt:.3f} s; against the unsharded solve "
        f"{json.dumps(c['vs_unsharded'])} (tol 1e-6)")
    if not (s3.num_iterations == ref1["summary"].num_iterations
            and max(c["vs_unsharded"].values()) <= 1e-6):
        raise AssertionError("phase 27 (c): the NCCL rank's solve differs "
                             "from the unsharded one")
    return c, launches


# ---------------------------------------------------------------------------
# phase 28: the dense reduced camera system
# ---------------------------------------------------------------------------

MAPPER_CG_ITERS = 30  # the incremental mapper's cg_iters
DENSE_ETA = 0.1  # BundleAdjustmentOptions' eta
CHECK_ETA, CHECK_CAP = 1e-6, 1000  # both PCGs run far past the default


def wall_ms(fn, reps=5):
    """Median host wall ms of fn() (which ends in host reads) over `reps`
    calls after one warm-up, the card synchronised around each; and the
    last call's result."""
    out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def dense_step_check(tag, args, dense_ops):
    """Phase 28 (a) at one recorded LM step (`args`: its res_and_jac
    operands; `dense_ops`: lam, pose_free, intr_free and img2cam of its
    dense system). Rebuilds the step's J, Vinv and reduced rows on the
    card, then: S built on the card against the same build on the CPU
    (1e-5 scaled); S v against the f32 matvec kernel's implicit product
    (damping and free masks as in the LM loop; 1e-4 scaled); x of the
    dense PCG and of the implicit PCG (f32 matvec kernel), each run to eta
    1e-6, against each other (1e-3 scaled), where f32 can solve the
    system: its free block's Jacobi-scaled condition number (float64
    eigenvalues on the host) under 1 / eps(f32); there both PCGs must
    reach eta 1e-6 within 1,000 iterations. An indefinite or
    worse-conditioned system (a converged local window: lam ~1e-7, a few
    points' f32 Vinv off their inverse) is reported, and its x are not
    compared: neither PCG has a solution to converge to. Times the S build (CUDA
    events), the dense PCG and a dense step's whole solve (S build and
    PCG, cap max(cg_iters, 64)) at the default eta, and the implicit
    step's solve at the same operands (the card's default: bf16 pack,
    matvec16 table and PCG, cap cg_iters), host wall each."""
    if dense_ops is None:
        raise AssertionError(f"phase 28 {tag}: the recorded step did not "
                             f"solve the dense system")
    lam, pose_free, intr_free, img2cam = dense_ops
    b_l, quat, intr = args[0], args[2], args[4]
    I, C, NP = quat.shape[0], intr.shape[0], intr_free.shape[1]
    res_l, J_l = ck.res_and_jac(*args)
    Vinv_l, _, rhs_pose, rhs_intr, udp, udi, S_blocks = ck.schur_prepare(
        b_l, J_l, res_l, lam, I, C)
    rhs = (rhs_pose * pose_free, rhs_intr * intr_free)
    # the solve's tables, built once as the LM loop builds them
    sys_args = (b_l, J_l, Vinv_l, lam, pose_free, intr_free, img2cam,
                bk.dense_schur_index(b_l, I, NP))
    S = bk.dense_schur_system(*sys_args)
    cpu_args = ([bk.Bucket(*(a.cpu() for a in b)) for b in b_l],
                [J.cpu() for J in J_l], [V.cpu() for V in Vinv_l],
                *(a.cpu() for a in sys_args[3:7]))
    s_err = scaled_err(S, bk.dense_schur_system(*cpu_args))

    jacobi = bk._schur_jacobi(pose_free, intr_free)
    damp_pose, damp_intr, precond = jacobi(lam, udp, udi, S_blocks)
    g = torch.Generator().manual_seed(28)
    dev = pose_free.device
    v_pose = torch.randn((I, 6), generator=g).to(dev) * pose_free
    v_intr = torch.randn((C, NP), generator=g).to(dev) * intr_free
    mp, mi = ck.schur_matvec(b_l, J_l, Vinv_l, v_pose, v_intr, I, C)
    want = torch.cat([((damp_pose * v_pose + mp) * pose_free).reshape(-1),
                      ((damp_intr * v_intr + mi) * intr_free).reshape(-1)])
    mv_err = scaled_err(
        S @ torch.cat([v_pose.reshape(-1), v_intr.reshape(-1)]), want)

    def dense_solve(eta, cap, S=None):
        if S is None:
            S = bk.dense_schur_system(*sys_args)
        return bk._dense_schur_solve(S, *rhs, pose_free, intr_free, cap,
                                     eta)

    def implicit_solve(kind, eta, cap):
        Jk = ([ck.pack_j_bf16(J) for J in J_l] if kind == "matvec16"
              else J_l)
        launch = ck.matvec_launch(kind, b_l, Jk, Vinv_l, I, C)
        damp_pose, damp_intr, precond = jacobi(lam, udp, udi, S_blocks)
        mv = ck.schur_matvec16 if kind == "matvec16" else ck.schur_matvec

        def matvec(x_pose, x_intr):
            mp, mi = mv(b_l, Jk, Vinv_l, x_pose, x_intr, I, C, launch=launch)
            return ((damp_pose * x_pose + mp) * pose_free,
                    (damp_intr * x_intr + mi) * intr_free)

        (x_pose, x_intr), k, _ = bk._pcg(matvec, precond, rhs, cap, eta)
        return x_pose, x_intr, k

    free = (torch.cat([pose_free.reshape(-1), intr_free.reshape(-1)])
            > 0).cpu()
    Sf = S.double().cpu()[free][:, free]
    d = Sf.diagonal().abs().sqrt().clamp(min=1e-30)
    ev = torch.linalg.eigvalsh(Sf / d[:, None] / d[None, :])
    cond = float(ev[-1] / ev[0]) if ev[0] > 0 else math.inf
    well_posed = cond < 1.0 / torch.finfo(torch.float32).eps
    xd = dense_solve(CHECK_ETA, CHECK_CAP, S)
    xi = implicit_solve("matvec", CHECK_ETA, CHECK_CAP)
    x_err = scaled_err(torch.cat([xd[0].reshape(-1), xd[1].reshape(-1)]),
                       torch.cat([xi[0].reshape(-1), xi[1].reshape(-1)]))
    converged = xd[2] < CHECK_CAP and xi[2] < CHECK_CAP

    cap = max(MAPPER_CG_ITERS, 64)
    build_ms = time_gpu(lambda: bk.dense_schur_system(*sys_args))
    pcg_ms, (_, _, k_dense, _) = wall_ms(
        lambda: dense_solve(DENSE_ETA, cap, S))
    dense_ms, _ = wall_ms(lambda: dense_solve(DENSE_ETA, cap))
    impl_ms, (_, _, k_impl) = wall_ms(
        lambda: implicit_solve("matvec16", DENSE_ETA, MAPPER_CG_ITERS))
    cols = 3 * sum(J.shape[-1] for J in J_l)
    D = 6 * I + NP * C
    r = dict(I=I, C=C, NP=NP, D=D, D_ref=bk.dense_schur_dim(I, C, NP),
             Z_columns=cols, ZZt_gflop=2.0 * D * D * cols / 1e9,
             S_max_abs_err=s_err[0], S_scaled_err=s_err[1],
             Sv_scaled_err=mv_err[1], scaled_condition=cond,
             min_scaled_eigenvalue=float(ev[0]), well_posed=well_posed,
             x_scaled_err=x_err[1],
             check_iterations=dict(dense=xd[2], implicit=xi[2]),
             build_ms=build_ms, dense_pcg_ms=pcg_ms,
             dense_iterations=k_dense, dense_step_ms=dense_ms,
             implicit_step_ms=impl_ms, implicit_iterations=k_impl)
    log(f"phase 28 {tag}: {json.dumps(r)}")
    x_ok = not well_posed or (converged and x_err[1] <= 1e-3)
    if not (s_err[1] <= 1e-5 and mv_err[1] <= 1e-4 and x_ok):
        raise AssertionError(f"phase 28 {tag}: S card vs CPU {s_err[1]:.2e} "
                             f"(tol 1e-5), S v vs the matvec kernel "
                             f"{mv_err[1]:.2e} (tol 1e-4), dense vs implicit "
                             f"x {x_err[1]:.2e} (tol 1e-3) after {xd[2]} / "
                             f"{xi[2]} iterations at scaled condition "
                             f"{cond:.3e}")
    return r


def implicit_mapping(tmp, dense):
    """Phase 28 (b): phase 20's orbit mapped on the card with every solve
    pinned to the implicit PCG (``dense_schur_max_d=0``), every launch
    count zeroed just before and read just after: phase 20's checks and
    the implicit launch rule (matvec16 once per CG iteration, no dense
    solve); registered img/s, LM steps and CG iterations beside phase 20's
    dense run (`dense`, phase 20's numbers). Returns the model and the
    numbers."""
    db = tmp / "map.db"
    gt = write_orbit_database(db, MAP_IMAGES, MAP_POINTS, MAP_NOISE)
    zero_counts()
    rec, dt, t = map_and_check(db, tmp / "map28", gt, mapping_options(),
                               "cuda", "phase 28 (b) implicit", MAP_IMAGES,
                               dense_schur_max_d=0)
    launches, plain_on_cuda = read_counts()
    if t["ba_dense_solves"] or not t["ba_cg_iterations"]:
        raise AssertionError(f"phase 28 (b): {ba_counts(t)}; every solve "
                             f"should be implicit")
    launch_check("phase 28 (b)", launches, plain_on_cuda, *ba_rule(t))
    split = ("local_ba_solve", "global_ba_solve", "local_ba", "global_ba")
    b = dict(seconds=dt, img_per_s=rec.num_reg_images / dt, err=t["err"],
             rot=t["rot"], solves=t["ba_solves"], lm_steps=t["ba_lm_steps"],
             cg_iterations=t["ba_cg_iterations"],
             **{k: t.get(k, 0.0) for k in split},
             dense=dict(img_per_s=dense["img_per_s"],
                        lm_steps=dense["lm_steps"],
                        dense_cg_iterations=dense["dense_cg_iterations"],
                        **{k: dense["timings"].get(k, 0.0) for k in split}))
    log(f"phase 28 (b) implicit mapping beside phase 20's dense run: "
        f"{json.dumps(b)}; {ba_counts(t)}")
    return rec, b


def dense_phase(tmp, steps, mapping):
    """Phase 28: (a) the dense reduced system at the recorded steps
    `steps` ({tag: (res_and_jac operands, dense operands)}) of phases 20,
    21 and 26; (b) phase 20's orbit mapped with the implicit PCG. Returns
    the numbers and (b)'s model."""
    t28 = time.perf_counter()
    numbers = {tag: dense_step_check(tag, *ops) for tag, ops in steps.items()}
    model, numbers["b"] = implicit_mapping(tmp, mapping)
    numbers["phase_s"] = time.perf_counter() - t28
    log(f"phase 28: {numbers['phase_s']:.2f} s")
    return numbers, model


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    # plain f32 products everywhere, on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log(f"card: {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    # --- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    _cuda_build.libs()
    nvcc_s = _cuda_build.build_seconds
    log(f"phase 1: {len(_cuda_build.SOURCES)} sources built and loaded in "
        f"{time.perf_counter() - t0:.1f} s (nvcc wall "
        f"{nvcc_s if nvcc_s is None else round(nvcc_s, 1)} s)")
    regs = [ln.strip() for ln in _cuda_build.build_log.splitlines()
            if "registers" in ln]
    log(f"phase 1: ptxas reports {len(regs)} kernels; max "
        f"{max((int(ln.split('Used ')[1].split()[0]) for ln in regs), default=0)}"
        f" registers")
    resources = {
        "window_sampler": dict(
            kernels=kernel_resources("features/csrc/window_sampler.cu"),
            blocks_per_sm=features_cuda.sample_windows_occupancy()),
        "pm_cost": dict(
            kernels=kernel_resources("mvs/csrc/pm_cost.cu"),
            blocks_per_sm={"full field": mvs_cuda.occupancy(False, 36),
                           "parity": mvs_cuda.occupancy(True, 36)}),
        # the Schur kernels' registers, and their modes at the bench's
        # width and tables, at phase 16's and at phase 10's image counts
        **{kind: dict(
            kernels={k: v for k, v in
                     kernel_resources("sfm/csrc/schur.cu").items()
                     if k.startswith(f"{kind}_kernel<")},
            bench=sfm_cuda.tile_config(ki, 4, 128, 1),
            width9=sfm_cuda.tile_config(ki, 9, 128, 2),
            **{f"{i} images": sfm_cuda.tile_config(ki, 4, i, 1)
               for i in MATVEC16_IMAGES})
           for ki, kind in enumerate(ck.TILE_KINDS)},
        "top2": dict(kernels=kernel_resources("features/csrc/top2.cu"),
                     **features_cuda.top2_resources(128)),
    }
    resources["cost"] = cost_resources()
    resources["resjac"] = resjac_resources()
    log(f"phase 1: registers, spills and resident blocks per SM (nw 36) of "
        f"the sampler and the cost kernel, and the Schur and top-2 kernels, "
        f"and every cost and finish instance: {json.dumps(resources)}")
    spilled = {k: v for k, v in resources["resjac"].items()
               if v.get("spill_stores") or v.get("spill_loads")}
    log(f"phase 1: registers and spills of every resjac instance: "
        f"{json.dumps(resources['resjac'])}; spilling: "
        f"{json.dumps(spilled) if spilled else 'none'}")

    # the probe's counts over phases 2-17, the user paths
    pg.reset_counts()

    # --- phase 2: kernels vs plain ----------------------------------------
    dev = torch.device("cuda")
    for model_id in range(11):
        for loss_type in (0, 1, 2):
            if model_id != 2 and loss_type != 1:
                continue  # every model once, every loss on SIMPLE_RADIAL
            errs = check_case(irregular_cases(model_id, loss_type, dev,
                                              seed=model_id), "irregular")
            log(f"phase 2 irregular model {model_id} loss {loss_type}: "
                + ", ".join(f"{k} {v[1]:.2e}" for k, v in errs.items()))
    # tracks of lengths 1..T, an empty bucket and tiles of padding only
    for model_id in (2, 6):
        errs = check_case(irregular_cases(model_id, 1, dev, seed=50 + model_id,
                                          ragged=True), "ragged")
        log(f"phase 2 ragged model {model_id}: "
            + ", ".join(f"{k} {v[1]:.2e}" for k, v in errs.items()))
    case, _ = bench_case(dev)
    results = {}
    check_case(case, "bench", results)
    del case
    torch.cuda.empty_cache()
    for name, r in results.items():
        log(f"phase 2 bench {name}: scaled err {r['scaled_err']:.2e} "
            f"(max abs {r['max_abs_err']:.3e}; plain f32 err "
            f"{r['plain32_scaled_err']:.2e}); kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB)" + cost_note(r))

    # --- phase 3: card vs CPU ----------------------------------------------
    medium_parity()

    # --- phase 4: the bench's resident solve, bf16 (default) and f32 -------
    launches, per_step, solver, rate16 = bench_solve(cg_bf16=True)
    launches32, per_step32, solver32, rate32 = bench_solve(cg_bf16=False)
    del solver32
    log(f"phase 4 LM it/s whole-solve / marginal: bf16 "
        f"{rate16['whole']:.2f} / {rate16['marginal']}, f32 "
        f"{rate32['whole']:.2f} / {rate32['marginal']}")

    # --- phase 5: where the time goes --------------------------------------
    profile_solve(solver)
    del solver
    torch.cuda.empty_cache()

    # --- phases 6-9: the feature front end ----------------------------------
    feat = feature_kernels()
    sift_parity()
    feat_launches, e2e, feat8, shifted = front_end()
    profile_extract()
    log(f"front end summary: {json.dumps(e2e)}")

    # --- phases 10-12: the Schur kernels and the known-pose entry points ---
    schur = schur_kernels()
    results["matvec16"] = schur["matvec16"]
    (ROOT / "build").mkdir(exist_ok=True)
    # phase 14's workspace stays for phase 22's meshers
    dense_dir = tempfile.TemporaryDirectory(dir=ROOT / "build")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        known_pose = dict(bundle_adjustment=model_bundle_adjustment(Path(tmp)))
        model_ba_parity(Path(tmp))
        known_pose["triangulate_points"] = known_pose_triangulation(Path(tmp))
        log(f"known-pose summary: {json.dumps(known_pose)}")

        # --- phases 16, 15 and 17: mixed-model bundles, the gather -------
        t16 = time.perf_counter()
        mixed, captured_ba = mixed_model_bundle_adjustment(
            Path(tmp), known_pose["bundle_adjustment"])
        model_ba_parity(Path(tmp), mixed_reconstruction(32, 8192),
                        tag="phase 16 medium 32/8192 mixed dense",
                        dense_schur_max_d=None)
        t15 = time.perf_counter()
        mixed_res = mixed_kernels(captured_ba)
        t17 = time.perf_counter()
        gather_res = gather_kernel(captured_ba)
        del captured_ba
        torch.cuda.empty_cache()
        mixed["phase_s"] = {"16": t15 - t16, "15": t17 - t15,
                            "17": time.perf_counter() - t17}
        log(f"mixed summary: {json.dumps(mixed)}")

        # --- phases 14 and 13: the dense pipeline and its cost kernel -----
        pm_launches, dense, captured, first_call = dense_pipeline(
            Path(dense_dir.name))
    for kind in ("photometric", "geometric"):
        dense[f"{kind}_busy_share"], dense[f"{kind}_kernel_share"] = \
            profile_patch_match(first_call[kind], kind)
    del first_call
    log(f"dense summary: {json.dumps(dense)}")
    pm_res = pm_cost_kernel(captured)
    del captured
    torch.cuda.empty_cache()

    # --- phase 18: the gather probe ----------------------------------------
    user_launches = dict(pg.LAUNCHES)
    t18 = time.perf_counter()
    probe, probe_launches = gather_probe()
    log(f"phase 18: {time.perf_counter() - t18:.2f} s; probe launches on "
        f"phases 2-17 {user_launches}, in its own run {probe_launches}")

    # --- phase 19: the estimators ------------------------------------------
    t19 = time.perf_counter()
    estimators = estimators_phase(shifted)
    log(f"phase 19: {time.perf_counter() - t19:.2f} s; estimators summary: "
        f"{json.dumps(estimators)}")

    # --- phase 20: incremental_mapping --------------------------------------
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        mapping = mapping_phase(Path(tmp))
    summary = {k: v for k, v in mapping.items()
               if k not in ("launches", "kernels", "steps")}
    log(f"mapping summary: {json.dumps(summary)}")

    # --- phase 21: images to model ------------------------------------------
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        e2e = images_to_model_phase(Path(tmp))
        log(f"images-to-model summary: {json.dumps(e2e['numbers'])}")

        # --- phases 22 and 23: meshing and retrieval ----------------------
        # every launch count zeroed just before and read just after: only
        # top-2 launches, from the retrieval matchers' descriptor matching
        zero_counts()
        tmp = Path(tmp)
        meshes = Path(dense_dir.name) / "meshes"
        meshes.mkdir()
        mesh = meshing_phase(Path(dense_dir.name) / "dense",
                             tmp / "e2e" / "model" / "0", meshes)
        log(f"meshing summary: {json.dumps(mesh)}")
        ret, buckets = retrieval_phase(tmp, tmp / "e2e" / "e2e.db")
        log(f"retrieval summary: {json.dumps(ret)}")
        late, late_plain = read_counts()
        log(f"phases 22-23 launches: {json.dumps(late)}; expected top-2 "
            f"{2 * buckets} (2 per shape bucket over {buckets} buckets), "
            "nothing else")
        if ({k: v for k, v in late.items() if v}
                != ({"top2": 2 * buckets} if buckets else {})
                or any(late_plain.values())):
            raise AssertionError(f"phases 22-23: launches {late}, expected "
                                 f"top-2 {2 * buckets} and nothing else; "
                                 f"plain on CUDA {late_plain}")
    dense_dir.cleanup()

    # --- phases 24-26: hierarchical mapping, the rig pose, two models ------
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        hier = hierarchical_phase(Path(tmp))
    log(f"hierarchical summary: {json.dumps(hier['numbers'])}")
    rig = rig_phase()
    log(f"rig summary: {json.dumps(rig)}")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        mixed_map = mixed_mapping_phase(Path(tmp))
    log(f"mixed mapping summary: {json.dumps(mixed_map['numbers'])}")
    late_map = {k: v + mixed_map["launches"][k]
                for k, v in hier["launches"].items()}

    # --- phase 28: the dense reduced camera system (its implicit mapping
    # is phase 27 (d)'s reference) -------------------------------------------
    steps28 = {**mapping.pop("steps"), **e2e.pop("steps"),
               **mixed_map.pop("steps")}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        dense28, model_implicit = dense_phase(Path(tmp), steps28, mapping)
    del steps28
    torch.cuda.empty_cache()
    log(f"dense system summary: {json.dumps(dense28)}")

    # --- phase 27: multi-device bundle adjustment ---------------------------
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        sharded = sharded_phase(Path(tmp), model_implicit)
    log(f"sharded summary: {json.dumps(sharded['numbers'])}")

    kernels = []
    for name in SINGLE_BA:
        src, rep = KERNEL_INFO[name]
        r = results[name]
        extra = {}
        if name in ck.TILE_KINDS:
            # phase 10's mode, host wall and larger reconstructions, phase
            # 15's width 9 (matvec16's row is phase 10's; the f32 kernels'
            # rows are phase 2's, and phase 10's time at the main path's
            # operands is ms_captured)
            p10, w9 = schur[name], mixed_res["schur"][name]
            extra = dict(mode=p10["sums"], blocks_per_sm=p10["blocks_per_sm"],
                         ms_captured=p10["ms"],
                         call_host_ms=p10["call_host_ms"], ms_width9=w9["ms"],
                         bound_ms_width9=w9["bound_ms"],
                         call_host_ms_width9=w9["call_host_ms"],
                         max_scaled_err_width9=w9["scaled_err"],
                         mode_width9=w9["sums"],
                         larger={k: {f: v[f] for f in ("sums", "blocks_per_sm",
                                                       "ms", "bound_ms",
                                                       "max_abs_err")}
                                 for k, v in p10["larger"].items()},
                         resources=resources[name])
        if name in ("cost", "finish"):
            extra = cost_row(r, resources["cost"], name, "Single<2>")
        if name == "resjac":
            extra = resjac_row(r, resources["resjac"], "Single<2>")
        # the f32 matvec runs in the f32-setting bench solve; every other
        # BA kernel's count is the default (bf16) solve's
        ln, ps = ((launches32, per_step32) if name == "matvec"
                  else (launches, per_step))
        # phase 20: launches of the timed mapping, and the kernel at the
        # captured global step's operands (matvec16 too; the f32 matvec
        # there from the same step's f32 J)
        m = mapping["kernels"][name]
        extra.update(launches_mapping=mapping["launches"][name],
                     ms_mapping=m["ms"], plain_ms_mapping=m["plain_ms"],
                     bound_ms_mapping=m["bound_ms"],
                     max_abs_err_mapping=m["max_abs_err"],
                     **({"call_host_ms_mapping": m["call_host_ms"]}
                        if "call_host_ms" in m else {}))
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=ln[name], launches_per_lm_step=ps[name],
            run="bench f32 CG" if name == "matvec" else "bench bf16 CG",
            max_abs_err=r["max_abs_err"], max_scaled_err=r["scaled_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            library_note="no single PyTorch call computes this function",
            **extra,
        ))
    # the sampler's row is its descriptor launch (the larger of the two per
    # octave); the orientation launch is logged in phase 6
    for name, tag in (("window_sampler", "descriptor"), ("top2", "8192x8192")):
        src, rep = KERNEL_INFO[name]
        r = feat[tag]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep, shape=tag,
            launches=feat_launches[name],
            max_abs_err=r["max_abs_err"], max_scaled_err=r["scaled_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
    # the sampler's whole call (one launch and its allocations) and its
    # orientation launch
    o = feat["orientation"]
    kernels[-2].update(
        call_ms=feat["descriptor"]["call_ms"],
        call_host_ms=feat["descriptor"]["call_host_ms"],
        ms_orientation=o["ms"], call_ms_orientation=o["call_ms"],
        call_host_ms_orientation=o["call_host_ms"],
        library_ms_orientation=o["library_ms"],
        bound_ms_orientation=o["bound_ms"],
        resources=resources["window_sampler"])
    # top-2 at phase 8's pair and padded batch beside the 8192^2 row
    kernels[-1].update(
        bound_ms_f32=feat["8192x8192"]["bound_ms_f32"],
        bound_note=feat["8192x8192"]["bound_note"],
        split=feat["8192x8192"]["split"],
        call_host_ms=feat["8192x8192"]["call_host_ms"],
        resources=resources["top2"],
        **{f"{k}_{tag}": feat8[f"phase 8 {tag}"][k]
           for tag in ("pair", "batch")
           for k in ("ms", "bound_ms", "bound_ms_f32", "library_ms",
                     "plain_ms", "max_abs_err", "split", "call_host_ms")})
    # the cost kernel's row: the captured photometric call (the geometric
    # one is logged in phase 13)
    src, rep = KERNEL_INFO["pm_cost"]
    r = pm_res["photometric"]
    kernels.append(dict(
        name="pm_cost", route="cuda", source=src, replaces=rep,
        shape=f"{MVS_H}x{MVS_W}, K 8, nw 36, photometric",
        launches=pm_launches["pm_cost"] + pm_launches["pm_cost_parity"],
        launches_full_field=pm_launches["pm_cost"],
        launches_parity=pm_launches["pm_cost_parity"],
        ms_parity=r["ms_parity"], bound_ms_parity=r["bound_ms_parity"],
        resources=resources["pm_cost"],
        max_abs_err=r["max_abs_err"], max_scaled_err=r["scaled_err"],
        max_abs_err_vs_f32_plain=r["max_abs_err_vs_f32_plain"],
        p999_abs_err=r["p999_abs_err"],
        share_beyond_tol=r["beyond_tol_share"], ms=r["ms"],
        ms_geometric=pm_res["geometric"]["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
        library_note="no single PyTorch call computes the windowed NCC; "
                     "grid_sample alone does only the sampling",
    ))
    # the mixed variants: timed at phase 16's captured inputs, launched on
    # phase 16's main path
    for name in MIXED_BA[:3]:
        src, rep = KERNEL_INFO[name]
        r = mixed_res[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            shape="phase 16: 128 images, 100k points, SIMPLE_RADIAL + OPENCV",
            launches=mixed["launches"][name],
            launches_per_lm_step=mixed["per_step"][name],
            run="phase 16 bundle_adjustment, bf16 CG",
            max_abs_err=r["max_abs_err"], max_scaled_err=r["scaled_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            library_note="no single PyTorch call computes this function",
            **(cost_row(r, resources["cost"], name[:-6], "Mixed<9>")
               if name != "resjac_mixed"
               else resjac_row(r, resources["resjac"], "Mixed<9>")),
        ))
    # the gather has no caller on the main path (neither has the TPU
    # kernel's): its launches there are 0; phase 17 launches it itself
    src, rep = KERNEL_INFO["gather"]
    r = gather_res
    kernels.append(dict(
        name="gather", route="cuda", source=src, replaces=rep,
        shape="phase 16's buckets and tables",
        launches=mixed["launches"]["gather"], main_path=False,
        max_abs_err=r["max_abs_err"], max_scaled_err=r["scaled_err"],
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r["library_ms"],
        library_note="two index_select calls, one per table",
    ))
    # the gather probe: no user path calls it (neither the TPU probe), so
    # its launches over phases 2-17 are 0; phase 18 runs it itself
    for name in pg.KERNELS:
        src, rep = KERNEL_INFO[f"probe_{name}"]
        r = probe[name]
        row = dict(
            name=f"probe_{name}", route="cuda", source=src, replaces=rep,
            shape=r["shape"], launches=user_launches[name], main_path=False,
            launches_probe_run=probe_launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], library_note=r["library"],
            empty_launch_ms=probe["empty_launch_ms"])
        sized = {"take_along_last": "take_along_last sized",
                 "take_flat": "take_flat sized"}.get(name)
        if sized:
            s = probe[sized]
            row.update(shape_sized=s["shape"], ms_sized=s["ms"],
                       plain_ms_sized=s["plain_ms"],
                       library_ms_sized=s["library_ms"],
                       bound_ms_sized=s["bound_ms"])
        kernels.append(row)
    # phase 21: each kernel's launches on the images-to-model path
    for row in kernels:
        name = row["name"]
        row["launches_images_to_model"] = e2e["launches"].get(name, 0) + (
            e2e["launches"]["pm_cost_parity"] if name == "pm_cost" else 0)
        # phases 22-23: meshing and retrieval
        row["launches_meshing_retrieval"] = late.get(name, 0) + (
            late["pm_cost_parity"] if name == "pm_cost" else 0)
        # phases 24-26: hierarchical mapping (24) and mapping with two
        # camera models (26); the rig pose (25) launches none
        row["launches_phases_24_26"] = late_map.get(name, 0)
        row["launches_hierarchical"] = hier["launches"].get(name, 0)
        row["launches_mixed_mapping"] = mixed_map["launches"].get(name, 0)
        # phase 27, by part: (a) the two-shard solve and the dryrun, (b)
        # both gloo ranks, (c) the NCCL rank, (d) the sharded mapping
        row["launches_phase_27"] = {
            part: counts.get(name, 0)
            for part, counts in sorted(sharded["launches"].items())}
        # the kernels at phase 26's recorded mixed global step
        m = mixed_map["kernels"].get(name)
        if m is not None:
            row.update(ms_mixed_mapping=m["ms"],
                       plain_ms_mixed_mapping=m["plain_ms"],
                       bound_ms_mixed_mapping=m["bound_ms"],
                       max_abs_err_mixed_mapping=m["max_abs_err"],
                       **({"call_host_ms_mixed_mapping": m["call_host_ms"]}
                          if "call_host_ms" in m else {}))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--phase27-rank":
        phase27_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    sys.exit(main())
