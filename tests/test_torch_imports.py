"""The port stands alone: no module of pycolmap_torch/, and none of
chip_smoke.py, chip_ab.py, example_torch.py and the card scripts under
scripts/ that drive the port, imports jax, jaxlib or the reference
package, at any depth of the file (function-level imports included). And
``import pycolmap_torch`` works cold, in a fresh interpreter, and exposes
the public names of the README's quick start."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "pycolmap_tpu")
FILES = sorted((ROOT / "pycolmap_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_ab.py", ROOT / "example_torch.py",
    ROOT / "scripts" / "resjac_launch_bounds.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_imports(path):
    bad = [m for m in _imports(path)
           if m and m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_port_is_scanned():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert "pycolmap_torch/features/sift.py" in names
    assert "pycolmap_torch/sfm/cg_kernel.py" in names
    for mod in ("scene/reconstruction.py", "scene/database.py",
                "scene/correspondence_graph.py", "geometry/types.py",
                "sfm/problem.py", "sfm/incremental_triangulator.py",
                "pipeline/sfm.py", "ops/solvers.py",
                "estimators/two_view_geometry.py", "pipeline/images.py",
                "pipeline/mvs.py", "mvs/workspace.py", "mvs/depth_map_io.py",
                "mvs/consistency_graph.py", "mvs/pm_kernels.py",
                "mvs/_cuda.py", "mvs/patch_match.py", "mvs/controller.py",
                "mvs/fusion.py", "scripts/proto_gather.py",
                "scripts/_cuda.py", "_timing.py", "ops/epipolar.py",
                "estimators/__init__.py", "estimators/ransac.py",
                "estimators/fundamental_matrix.py",
                "estimators/homography_matrix.py",
                "estimators/homography_decomposition.py",
                "estimators/essential_matrix.py",
                "estimators/triangulation.py",
                "estimators/absolute_pose.py", "utils/timer.py",
                "scene/exporters.py", "convert.py",
                "sfm/incremental_mapper.py", "sfm/pose_graph.py",
                "sfm/resident.py", "native/__init__.py",
                "pipeline/__init__.py", "pipeline/extract_features.py",
                "pipeline/match_features.py", "estimators/batch_two_view.py",
                "features/matcher.py", "__init__.py", "mvs/meshing.py",
                "features/retrieval.py", "estimators/alignment.py",
                "estimators/generalized_absolute_pose.py",
                "parallel/graph_partition.py", "parallel/__init__.py",
                "parallel/device_ctx.py", "parallel/sharded_ba.py",
                "parallel/camera_sharding.py", "parallel/distributed.py"):
        assert f"pycolmap_torch/{mod}" in names
    assert len(FILES) > 20


QUICK_START = ("extract_features", "match_exhaustive", "incremental_mapping",
               "import_images", "match_sequential", "match_spatial",
               "match_vocabtree", "poisson_meshing", "sparse_delaunay_meshing",
               "dense_delaunay_meshing", "VocabTree", "InvertedIndex",
               "build_visual_index", "PoissonMeshingOptions",
               "DelaunayMeshingOptions",
               "verify_matches", "match_guided", "infer_camera_from_image",
               "Reconstruction", "Database", "Camera", "Rigid3d",
               "SiftExtractionOptions", "SiftMatchingOptions",
               "IncrementalPipelineOptions", "BundleAdjustmentOptions",
               "ImageReaderOptions", "CameraMode", "Device", "logging",
               "hierarchical_mapping", "rig_absolute_pose_estimation",
               "compare_reconstructions", "align_reconstruction_to_locations",
               "has_cuda", "has_tpu")


@pytest.mark.parametrize("first", ["pycolmap_torch",
                                   "pycolmap_torch.pipeline.match_features",
                                   "pycolmap_torch.sfm.cg_kernel"])
def test_cold_import(first):
    """A fresh interpreter imports the package (or a submodule first, which
    imports the package while resolve_device is all it holds), with its
    public names and no JAX."""
    code = (f"import sys, importlib; importlib.import_module({first!r}); "
            "import pycolmap_torch as pt; "
            f"missing = [n for n in {QUICK_START!r} if not hasattr(pt, n)]; "
            "assert not missing, missing; "
            "assert pt.resolve_device(pt.Device.cpu).type == 'cpu'; "
            "assert hasattr(pt, 'match_vocabtree'); "
            "assert 'jax' not in sys.modules and "
            "'pycolmap_tpu' not in sys.modules")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


def test_namespaces_match_the_reference():
    """Every public name of the reference's top level is the port's, the
    multi-device modules' mesh selectors among them, but the reference's
    private module names; the estimators' names are all the port's. ``has_cuda``
    says whether this host has the card, ``has_tpu`` is False."""
    import torch

    import pycolmap_torch as pt
    import pycolmap_torch.estimators as te
    import pycolmap_tpu as jt
    import pycolmap_tpu.estimators as je

    assert set(dir(jt)) - set(dir(pt)) == {"_detect_tpu", "_os"}
    assert set(dir(je)) - set(dir(te)) == set()
    assert pt.has_cuda is torch.cuda.is_available()
    assert pt.has_tpu is False
    assert pt.parallel.graph_partition.hierarchical_mapping is (
        pt.hierarchical_mapping)
