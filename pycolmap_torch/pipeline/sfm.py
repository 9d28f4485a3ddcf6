"""SfM pipeline stages: incremental_mapping, bundle_adjustment,
triangulate_points.

Port of ``pycolmap_tpu/pipeline/sfm.py`` (API parity: pycolmap/pipeline/sfm.h
— ``incremental_mapping`` :46-93, ``bundle_adjustment`` :95-103,
``triangulate_points`` :23-44, ``IncrementalPipelineOptions`` :117-258). The
controller loop follows the reference call stack (SURVEY.md §3.3): init pair
→ register/triangulate loop → iterative local refinement →
growth-ratio-gated global refinement → filtering → pose-graph relaxation →
multi-model management, with snapshots, resume and callbacks. The
reference's BA-compile prewarm has no counterpart: the port compiles no
executables per shape.

Every entry point runs on the card unless ``device="cpu"`` is given; on a
host without CUDA and no device they raise. ``cg_bf16`` selects the CG
matvec of the solve (see :func:`pycolmap_torch.sfm.ba_kernels.
solve_bundle_fast`): None takes the device's default, bf16 on the card
and f32 on the CPU, as the reference does on its accelerator and its CPU.
``dense_schur_max_d`` is the cutoff of the dense reduced camera system:
None takes the device's, 512 on the card and 2048 on the CPU, as the
reference's; 0 keeps every solve on the implicit PCG.

Given a ``timings`` dict, each entry point fills in the wall-time split of
its call in seconds (the solve ends in a host read, so its time includes
the device's).
"""

from __future__ import annotations

import copy
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import numpy as np

from pycolmap_torch import resolve_device
from pycolmap_torch.scene import Reconstruction
from pycolmap_torch.sfm.bundle_adjustment import (
    BundleAdjustmentOptions,
    LossFunctionType,
    solve_bundle,
)
from pycolmap_torch.sfm.database_cache import DatabaseCache
from pycolmap_torch.sfm.incremental_mapper import (
    IncrementalMapper,
    IncrementalMapperOptions,
)
from pycolmap_torch.sfm.pose_graph import relax_pose_graph
from pycolmap_torch.sfm.incremental_triangulator import (
    IncrementalTriangulator,
    IncrementalTriangulatorOptions,
)
from pycolmap_torch.sfm.link_index import LinkIndex
from pycolmap_torch.sfm.problem import apply_bundle_solution, build_bundle_problem
from pycolmap_torch.utils import logging as _logging
from pycolmap_torch.utils.options import BaseOptions, options_dataclass


@options_dataclass
class IncrementalPipelineOptions(BaseOptions):
    """Mirrors reference IncrementalPipelineOptions (pipeline/sfm.h:117-258).

    ``devices`` selects the shard mesh of every BA solve of the pipeline
    (``get_local_ba`` / ``get_global_ba`` pass it on), as the reference's
    selects its JAX mesh: see ``BundleAdjustmentOptions``. The device of
    everything else is an argument of the entry points."""

    min_num_matches: int = 15
    ignore_watermarks: bool = False
    multiple_models: bool = True
    max_num_models: int = 50
    max_model_overlap: int = 20
    min_model_size: int = 10
    init_image_id1: int = -1
    init_image_id2: int = -1
    init_num_trials: int = 200
    extract_colors: bool = True
    num_threads: int = -1
    min_focal_length_ratio: float = 0.1
    max_focal_length_ratio: float = 10.0
    max_extra_param: float = 1.0
    ba_refine_focal_length: bool = True
    ba_refine_principal_point: bool = False
    ba_refine_extra_params: bool = True
    ba_min_num_residuals_for_multi_threading: int = 50000
    ba_local_num_images: int = 6
    ba_local_function_tolerance: float = 0.0
    ba_local_max_num_iterations: int = 25
    ba_global_images_ratio: float = 1.1
    ba_global_points_ratio: float = 1.1
    ba_global_images_freq: int = 500
    ba_global_points_freq: int = 250000
    ba_global_function_tolerance: float = 0.0
    ba_global_max_num_iterations: int = 50
    ba_local_max_refinements: int = 2
    ba_local_max_refinement_change: float = 0.001
    ba_global_max_refinements: int = 5
    ba_global_max_refinement_change: float = 0.0005
    snapshot_path: str = ""
    snapshot_images_freq: int = 0
    image_names: list = None
    fix_existing_images: bool = False
    # pose-graph relaxation (rotation averaging + position solve +
    # retriangulation, sfm/pose_graph.py) after the final refinement when
    # the verified pair graph disagrees with the reconstruction. No-op on
    # healthy scenes (residual check).
    pose_graph_relaxation: bool = True
    pose_graph_min_residual_deg: float = 1.0
    # the shard mesh of every BA solve in the pipeline: "auto", "none", a
    # card count, or a ShardMesh (parallel/device_ctx.resolve_mesh)
    devices: object = "auto"
    mapper: IncrementalMapperOptions = None
    triangulation: IncrementalTriangulatorOptions = None

    def __post_init__(self):
        if self.mapper is None:
            self.mapper = IncrementalMapperOptions()
        if self.triangulation is None:
            self.triangulation = IncrementalTriangulatorOptions()
        if self.image_names is None:
            self.image_names = []

    def get_mapper(self) -> IncrementalMapperOptions:
        m = copy.deepcopy(self.mapper)
        m.local_ba_num_images = self.ba_local_num_images
        m.max_model_overlap = self.max_model_overlap
        m.fix_existing_images = self.fix_existing_images
        m.min_focal_length_ratio = self.min_focal_length_ratio
        m.max_focal_length_ratio = self.max_focal_length_ratio
        m.max_extra_param = self.max_extra_param
        return m

    def get_local_ba(self) -> BundleAdjustmentOptions:
        ba = BundleAdjustmentOptions()
        ba.loss_function_type = LossFunctionType.SOFT_L1
        ba.loss_function_scale = 1.0
        ba.refine_focal_length = self.ba_refine_focal_length
        ba.refine_principal_point = self.ba_refine_principal_point
        ba.refine_extra_params = self.ba_refine_extra_params
        ba.max_num_iterations = self.ba_local_max_num_iterations
        ba.print_summary = False
        ba.devices = self.devices
        return ba

    def get_global_ba(self) -> BundleAdjustmentOptions:
        ba = BundleAdjustmentOptions()
        ba.loss_function_type = LossFunctionType.TRIVIAL
        ba.refine_focal_length = self.ba_refine_focal_length
        ba.refine_principal_point = self.ba_refine_principal_point
        ba.refine_extra_params = self.ba_refine_extra_params
        ba.max_num_iterations = self.ba_global_max_num_iterations
        ba.print_summary = False
        ba.devices = self.devices
        return ba


class ReconstructionManager:
    """Holds the set of models (ref: pipeline/sfm.h:59-63 usage)."""

    def __init__(self):
        self.reconstructions: list[Reconstruction] = []

    def add(self) -> int:
        self.reconstructions.append(Reconstruction())
        return len(self.reconstructions) - 1

    def get(self, idx) -> Reconstruction:
        return self.reconstructions[idx]

    def delete(self, idx):
        del self.reconstructions[idx]

    def __len__(self):
        return len(self.reconstructions)

    def write(self, path):
        path = Path(path)
        for i, rec in enumerate(self.reconstructions):
            out = path / str(i)
            out.mkdir(parents=True, exist_ok=True)
            rec.write_binary(out)


def _iterative_local_refinement(mapper, options, image_id):
    """Repeated local BA until relative change small (upstream
    IterativeLocalRefinement; ref: sfm.h ba_local_max_refinements)."""
    ba = options.get_local_ba()
    for _ in range(options.ba_local_max_refinements):
        summary = mapper.adjust_local_bundle(
            options.get_mapper(), ba, options.triangulation, image_id
        )
        if summary is None:
            break
        mapper.triangulator.complete_image(image_id)
        mapper.triangulator.clear_cache()
        if summary.initial_cost <= 0:
            break
        change = abs(summary.final_cost - summary.initial_cost) / max(
            summary.initial_cost, 1e-12
        )
        if change < options.ba_local_max_refinement_change:
            break


def _iterative_global_refinement(mapper, options):
    """Retriangulate + global BA rounds (upstream IterativeGlobalRefinement)."""
    mapper.triangulator.clear_cache()
    mapper.triangulator.complete_tracks()
    mapper.triangulator.merge_tracks()
    mapper.triangulator.retriangulate()
    for _ in range(options.ba_global_max_refinements):
        summary = mapper.adjust_global_bundle(
            options.get_mapper(), options.get_global_ba()
        )
        if summary is None:
            break
        mapper.triangulator.clear_cache()
        mapper.triangulator.complete_tracks()
        mapper.triangulator.merge_tracks()
        mapper.filter_points(options.get_mapper())
        if summary.initial_cost <= 0:
            break
        change = abs(summary.final_cost - summary.initial_cost) / max(
            summary.initial_cost, 1e-12
        )
        if change < options.ba_global_max_refinement_change:
            break
    mapper.filter_images(options.get_mapper())


def _extract_colors(rec, image_path):
    """Mean track color from source images (ref: reconstruction.h:361-382).

    Vectorized per image: one fancy-indexed color fetch + one segment sum
    over point ids."""
    from pycolmap_torch.pipeline.images import read_image_rgb
    from pycolmap_torch.scene.point2d import INVALID_POINT3D_ID

    image_path = Path(image_path)
    pids_all = np.fromiter(rec.points3D.keys(), dtype=np.int64)
    if len(pids_all) == 0:
        return
    row_of = {int(p): k for k, p in enumerate(pids_all)}
    sums = np.zeros((len(pids_all), 3), np.float64)
    counts = np.zeros(len(pids_all), np.int64)
    for iid in rec.reg_image_ids:
        img = rec.images[iid]
        f = image_path / img.name
        if not f.exists():
            continue
        try:
            arr = read_image_rgb(f)
        except (OSError, ValueError):  # unreadable: no colors from it
            continue
        h, w = arr.shape[:2]
        p3d = img.points2D_point3D_ids
        valid = p3d != np.uint64(INVALID_POINT3D_ID)
        if not valid.any():
            continue
        obs_pid = p3d[valid].astype(np.int64)
        rows = np.fromiter(
            (row_of.get(int(p), -1) for p in obs_pid), dtype=np.int64,
            count=len(obs_pid),
        )
        xy = np.rint(img.points2D_xy[valid]).astype(np.int64)
        ok = (
            (rows >= 0)
            & (xy[:, 0] >= 0) & (xy[:, 0] < w)
            & (xy[:, 1] >= 0) & (xy[:, 1] < h)
        )
        rows = rows[ok]
        xy = xy[ok]
        colors = arr[xy[:, 1], xy[:, 0]].astype(np.float64)
        np.add.at(sums, rows, colors)
        np.add.at(counts, rows, 1)
    got = counts > 0
    mean = np.zeros_like(sums)
    mean[got] = sums[got] / counts[got, None]
    mean = np.clip(mean, 0, 255).astype(np.uint8)
    for k in np.nonzero(got)[0]:
        rec.points3D[int(pids_all[k])].color = mean[k]


@contextmanager
def _timed(timings, key):
    """Adds the block's wall seconds to ``timings[key]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        timings[key] += time.perf_counter() - t0


def _reconstruct_model(mapper, cache, options, split, initial_callback=None,
                       next_callback=None):
    """Grow one model; returns (kept, init_ok). `split`: wall seconds per
    stage, added to."""
    log = _logging.get_logger()
    mopts = options.get_mapper()
    rec = mapper.reconstruction

    if rec.num_reg_images == 0:
        init1, init2 = options.init_image_id1, options.init_image_id2
        success = False
        with _timed(split, "initial_pair"):
            for _ in range(options.init_num_trials):
                if init1 < 0 or init2 < 0:
                    id1, id2 = mapper.find_initial_image_pair(mopts)
                else:
                    id1, id2 = init1, init2
                if id1 is None:
                    break
                if mapper.register_initial_image_pair(mopts, id1, id2):
                    success = True
                    break
                if init1 >= 0 and init2 >= 0:
                    break
        if not success:
            return False, False  # (kept, init_ok): no init pair left
        log.info(
            f"Initialized with image pair, {rec.num_points3D} seed points"
        )
        if initial_callback:
            initial_callback()
        with _timed(split, "global_ba"):
            _iterative_global_refinement(mapper, options)

    num_global_images = max(rec.num_reg_images, 2)
    num_global_points = max(rec.num_points3D, 1)

    while True:
        with _timed(split, "register"):
            candidates = mapper.find_next_images(mopts)
        if not candidates:
            break
        registered_any = False
        for image_id in candidates[:5]:
            with _timed(split, "register"):
                registered = mapper.register_next_image(mopts, image_id)
            if registered:
                registered_any = True
                with _timed(split, "triangulate"):
                    mapper.triangulator.clear_cache()
                    mapper.triangulate_image(options.triangulation, image_id)
                with _timed(split, "local_ba"):
                    _iterative_local_refinement(mapper, options, image_id)
                if next_callback:
                    next_callback()
                log.info(
                    f"Registered image #{image_id} "
                    f"({rec.num_reg_images} images, {rec.num_points3D} points)"
                )
                # growth-gated global refinement (ref: sfm.h:194-208)
                if (
                    rec.num_reg_images
                    >= options.ba_global_images_ratio * num_global_images
                    or rec.num_points3D
                    >= options.ba_global_points_ratio * num_global_points
                    or rec.num_reg_images
                    >= num_global_images + options.ba_global_images_freq
                    or rec.num_points3D
                    >= num_global_points + options.ba_global_points_freq
                ):
                    with _timed(split, "global_ba"):
                        _iterative_global_refinement(mapper, options)
                    num_global_images = max(rec.num_reg_images, 2)
                    num_global_points = max(rec.num_points3D, 1)
                break
        if not registered_any:
            break

    with _timed(split, "global_ba"):
        _iterative_global_refinement(mapper, options)

    # drift-fold recovery: when the verified pair graph still disagrees with
    # the mapped poses (folded loop), relax the pose graph and re-refine; at
    # most 2 rounds, no-op when healthy
    if options.pose_graph_relaxation:
        pair_pose = getattr(cache, "pair_pose", None) or {}
        if pair_pose:
            for _ in range(2):
                with _timed(split, "pose_graph"):
                    relaxed = relax_pose_graph(
                        rec, pair_pose,
                        min_residual_deg=options.pose_graph_min_residual_deg,
                        device=mapper.device,
                    )
                if not relaxed:
                    break
                with _timed(split, "global_ba"):
                    _iterative_global_refinement(mapper, options)
    return rec.num_reg_images >= 2, True


def incremental_mapping(
    database_path,
    image_path,
    output_path,
    options: IncrementalPipelineOptions = None,
    input_path: str = "",
    initial_image_pair_callback=None,
    next_image_callback=None,
    device=None,
    cg_bf16=None,
    timings: dict = None,
    dense_schur_max_d=None,
):
    """Full incremental SfM (ref: pipeline/sfm.h:46-93).

    Returns dict {index: Reconstruction}; also writes models under
    output_path/<index>/ like the reference. The estimators, triangulation
    and bundle adjustment run on ``device`` (None = the card); ``cg_bf16``
    selects the BA's CG matvec (None = the device's default),
    ``dense_schur_max_d`` its dense reduced system's cutoff. Given a
    ``timings`` dict, fills in wall seconds per stage (load, initial_pair,
    register, triangulate, local_ba, global_ba, pose_graph, extract_colors,
    write), the mapper's own split of its methods (``register_pnp``,
    ``local_ba_solve``, ``global_ba_solve``, ...) and its BA counters
    (``ba_solves``, ``ba_lm_steps``, ``ba_cg_iterations``,
    ``ba_cache_hits``, ``ba_cache_misses``, and of the dense solves apart
    ``ba_dense_solves``, ``ba_dense_lm_steps``,
    ``ba_dense_cg_iterations``).
    """
    device = resolve_device(device)
    if options is None:
        options = IncrementalPipelineOptions()
    log = _logging.get_logger()
    output_path = Path(output_path)
    output_path.mkdir(parents=True, exist_ok=True)
    split = defaultdict(float)

    with _timed(split, "load"):
        cache = DatabaseCache.load(
            database_path,
            min_num_matches=options.min_num_matches,
            ignore_watermarks=options.ignore_watermarks,
            image_names=options.image_names or None,
        )
    log.info(
        f"Loaded database: {cache.num_images} images, "
        f"{cache.correspondence_graph.num_image_pairs} verified pairs"
    )

    manager = ReconstructionManager()
    if input_path:
        idx = manager.add()
        manager.get(idx).read(input_path)

    mapper = IncrementalMapper(cache, device=device, cg_bf16=cg_bf16,
                               dense_schur_max_d=dense_schur_max_d)

    initial_models = len(manager)
    max_models = options.max_num_models if options.multiple_models else 1
    processed_initial = False
    while True:
        if initial_models and not processed_initial:
            idx = 0  # resume the model read from input_path exactly once
            processed_initial = True
        elif len(manager) < max_models + initial_models:
            idx = manager.add()
        else:
            break
        rec = manager.get(idx)
        cache.setup_reconstruction(rec)
        mapper.begin_reconstruction(rec, options.triangulation)

        num_snapshot_state = {"count": 0, "last": 0}

        def _snapshot_cb():
            if next_image_callback:
                next_image_callback()
            if options.snapshot_path and options.snapshot_images_freq > 0:
                n = rec.num_reg_images
                if n - num_snapshot_state["last"] >= options.snapshot_images_freq:
                    num_snapshot_state["last"] = n
                    snap = (
                        Path(options.snapshot_path)
                        / f"{num_snapshot_state['count']:06d}"
                    )
                    snap.mkdir(parents=True, exist_ok=True)
                    rec.write_binary(snap)
                    num_snapshot_state["count"] += 1

        kept, init_ok = _reconstruct_model(
            mapper, cache, options, split,
            initial_callback=initial_image_pair_callback,
            next_callback=_snapshot_cb,
        )
        total_reg = rec.num_reg_images
        mapper.end_reconstruction(discard=not kept)
        if not kept or total_reg < options.min_model_size:
            if len(manager) > 1 or not kept:
                manager.delete(idx)
            if not init_ok:
                break  # no initialization pair left anywhere — done
            # init succeeded but the model collapsed (e.g. a degenerate
            # short-baseline seed whose focal ran away and was culled by
            # filter_images, ref has_bogus_params) — try the NEXT init
            # pair; find_initial_image_pair never repeats pairs, so this
            # terminates
            continue
        # stop if most images registered
        reg_total = {
            i for r in manager.reconstructions for i in r.reg_image_ids
        }
        if len(reg_total) >= cache.num_images - 2:
            break
        if not options.multiple_models:
            break

    if options.extract_colors:
        with _timed(split, "extract_colors"):
            for rec in manager.reconstructions:
                _extract_colors(rec, image_path)

    with _timed(split, "write"):
        manager.write(output_path)
    if timings is not None:
        ba = mapper.resident_ba
        timings.update(split)
        timings.update(mapper.timings)
        timings.update(ba_solves=ba.solves, ba_lm_steps=ba.lm_steps,
                       ba_cg_iterations=ba.cg_iterations,
                       ba_cache_hits=ba.hits, ba_cache_misses=ba.misses,
                       ba_dense_solves=ba.dense_solves,
                       ba_dense_lm_steps=ba.dense_lm_steps,
                       ba_dense_cg_iterations=ba.dense_cg_iterations)
    return {i: manager.get(i) for i in range(len(manager))}


def bundle_adjustment(reconstruction, options: BundleAdjustmentOptions = None,
                      device=None, cg_bf16=None, timings: dict = None,
                      dense_schur_max_d=None):
    """Global BA on an existing reconstruction (ref: pipeline/sfm.h:95-103).

    The first registered image's pose and the second's x translation are
    held constant (the gauge). The solve is sharded over the mesh that
    ``options.devices`` resolves to, if any. Returns the BASummary, or None
    with fewer than two registered images."""
    device = resolve_device(device)
    if options is None:
        options = BundleAdjustmentOptions()
    reg = reconstruction.reg_image_ids
    if len(reg) < 2:
        return None
    t0 = time.perf_counter()
    problem, mapping = build_bundle_problem(
        reconstruction, options,
        constant_pose_ids=[reg[0]], constant_tvec_x_ids=[reg[1]],
    )
    t1 = time.perf_counter()
    new_problem, summary = solve_bundle(problem, options, device=device,
                                        cg_bf16=cg_bf16,
                                        dense_schur_max_d=dense_schur_max_d)
    t2 = time.perf_counter()
    apply_bundle_solution(reconstruction, new_problem, mapping)
    t3 = time.perf_counter()
    if timings is not None:
        timings.update(build=t1 - t0, solve=t2 - t1, write_back=t3 - t2)
    if options.print_summary:
        _logging.get_logger().info(str(summary))
    return summary


def triangulate_points(
    reconstruction,
    database_path,
    image_path,
    output_path,
    clear_points: bool = True,
    options: IncrementalPipelineOptions = None,
    refine_intrinsics: bool = False,
    device=None,
    cg_bf16=None,
    timings: dict = None,
    dense_schur_max_d=None,
):
    """Triangulate a model with known fixed poses (ref: pipeline/sfm.h:23-44).

    Triangulates every registered image from the database's verified
    matches, completes and merges the tracks, runs global BA over the
    points (poses fixed; intrinsics too unless ``refine_intrinsics``),
    filters, and writes the model to ``output_path``. ``image_path`` is
    unused, as in the reference."""
    device = resolve_device(device)
    if options is None:
        options = IncrementalPipelineOptions()
    output_path = Path(output_path)
    output_path.mkdir(parents=True, exist_ok=True)

    t0 = time.perf_counter()
    cache = DatabaseCache.load(database_path, options.min_num_matches)
    # align db image ids with reconstruction by name
    name_to_dbid = {img.name: iid for iid, img in cache.images.items()}
    if clear_points:
        for pid in list(reconstruction.points3D):
            reconstruction.delete_point3D(pid)
    # rebuild images with db keypoints (poses kept)
    for iid, img in list(reconstruction.images.items()):
        dbid = name_to_dbid.get(img.name)
        if dbid is None:
            continue
        db_img = cache.images[dbid]
        if img.num_points2D == 0:
            img.set_keypoints(db_img.points2D_xy)

    t1 = time.perf_counter()
    graph = cache.correspondence_graph
    triangulator = IncrementalTriangulator(
        graph, reconstruction, options.triangulation,
        link_index=LinkIndex(graph, reconstruction), device=device,
    )
    for iid in reconstruction.reg_image_ids:
        triangulator.triangulate_image(iid)
    triangulator.complete_tracks()
    triangulator.merge_tracks()
    t2 = time.perf_counter()
    ba = options.get_global_ba()
    ba.refine_extrinsics = False
    if not refine_intrinsics:
        ba.refine_focal_length = False
        ba.refine_extra_params = False
    bundle_adjustment(reconstruction, ba, device=device, cg_bf16=cg_bf16,
                      dense_schur_max_d=dense_schur_max_d)
    t3 = time.perf_counter()
    reconstruction.filter_points3D(
        options.mapper.filter_max_reproj_error, options.mapper.filter_min_tri_angle
    )
    reconstruction.write_binary(output_path)
    t4 = time.perf_counter()
    if timings is not None:
        timings.update(load=t1 - t0, triangulate=t2 - t1,
                       bundle_adjustment=t3 - t2, filter_write=t4 - t3)
    return reconstruction
