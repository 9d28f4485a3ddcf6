"""SfM pipeline stages: bundle_adjustment and triangulate_points.

Port of ``pycolmap_tpu/pipeline/sfm.py`` (API parity: pycolmap/pipeline/sfm.h
— ``bundle_adjustment`` :95-103, ``triangulate_points`` :23-44,
``IncrementalPipelineOptions`` :117-258), for now the known-pose half:
global BA of a model, and triangulation of a model whose poses are known.
``incremental_mapping`` waits for the mapping slice (ROADMAP.md).

Both entry points run on the card unless ``device="cpu"`` is given; on a
host without CUDA and no device they raise. ``cg_bf16`` selects the CG
matvec of the solve (see :func:`pycolmap_torch.sfm.ba_kernels.
solve_bundle_fast`): None takes the device's default, bf16 on the card
and f32 on the CPU, as the reference does on its accelerator and its CPU.

Given a ``timings`` dict, each entry point fills in the wall-time split of
its call in seconds (the solve ends in a host read, so its time includes
the device's).
"""

from __future__ import annotations

import time
from pathlib import Path

from pycolmap_torch import resolve_device
from pycolmap_torch.sfm.bundle_adjustment import (
    BundleAdjustmentOptions,
    LossFunctionType,
    solve_bundle,
)
from pycolmap_torch.sfm.database_cache import DatabaseCache
from pycolmap_torch.sfm.incremental_mapper import IncrementalMapperOptions
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

    The reference's ``devices`` option (a JAX mesh selector) has no
    counterpart: the device is an argument of the entry points. Its
    ``get_mapper`` and ``get_local_ba`` come with ``incremental_mapping``,
    their only caller."""

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
    pose_graph_relaxation: bool = True
    pose_graph_min_residual_deg: float = 1.0
    mapper: IncrementalMapperOptions = None
    triangulation: IncrementalTriangulatorOptions = None

    def __post_init__(self):
        if self.mapper is None:
            self.mapper = IncrementalMapperOptions()
        if self.triangulation is None:
            self.triangulation = IncrementalTriangulatorOptions()
        if self.image_names is None:
            self.image_names = []

    def get_global_ba(self) -> BundleAdjustmentOptions:
        ba = BundleAdjustmentOptions()
        ba.loss_function_type = LossFunctionType.TRIVIAL
        ba.refine_focal_length = self.ba_refine_focal_length
        ba.refine_principal_point = self.ba_refine_principal_point
        ba.refine_extra_params = self.ba_refine_extra_params
        ba.max_num_iterations = self.ba_global_max_num_iterations
        ba.print_summary = False
        return ba


def bundle_adjustment(reconstruction, options: BundleAdjustmentOptions = None,
                      device=None, cg_bf16=None, timings: dict = None):
    """Global BA on an existing reconstruction (ref: pipeline/sfm.h:95-103).

    The first registered image's pose and the second's x translation are
    held constant (the gauge). Returns the BASummary, or None with fewer
    than two registered images."""
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
                                        cg_bf16=cg_bf16)
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
    bundle_adjustment(reconstruction, ba, device=device, cg_bf16=cg_bf16)
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
