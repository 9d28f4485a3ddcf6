"""The port's known-pose entry points vs the reference on the CPU:
``bundle_adjustment`` on the 5-image / 120-point model of
tests/test_pipeline_entry_points.py:43 and ``triangulate_points`` on its
6-image / 200-point database (:23). Both packages read the same model files
and database and run under identical options (pycolmap_torch.convert). Both
are pinned to the implicit Schur-PCG path (the reference by
PYCOLMAP_TPU_DENSE_SCHUR_MAX_D=0, the port by dense_schur_max_d=0: on the
CPU both would otherwise solve D <= 2048 densely)."""

import numpy as np
import pytest

from pycolmap_tpu.pipeline.sfm import IncrementalPipelineOptions as JPipe
from pycolmap_tpu.pipeline.sfm import bundle_adjustment as j_bundle_adjustment
from pycolmap_tpu.pipeline.sfm import triangulate_points as j_triangulate_points
from pycolmap_tpu.scene import Reconstruction as JRec
from pycolmap_tpu.sfm.bundle_adjustment import BundleAdjustmentOptions as JOpt
from pycolmap_torch import convert
from pycolmap_torch.pipeline import bundle_adjustment, triangulate_points
from pycolmap_torch.scene import Reconstruction

from test_incremental_mapping import make_synthetic_database
from test_scene import build_synthetic_reconstruction


@pytest.fixture(autouse=True)
def _implicit_reference_path(monkeypatch):
    monkeypatch.setenv("PYCOLMAP_TPU_DENSE_SCHUR_MAX_D", "0")


def _perturbed_model(path):
    rec = build_synthetic_reconstruction(num_images=5, num_points=120, seed=7)
    rng = np.random.default_rng(0)
    for pt in rec.points3D.values():
        pt.xyz = pt.xyz + rng.normal(0, 0.01, 3)
    rec.write_binary(path)


def test_bundle_adjustment_matches_reference(tmp_path):
    _perturbed_model(tmp_path / "in")
    jrec, trec = JRec(tmp_path / "in"), Reconstruction(tmp_path / "in")
    err_before = trec.compute_mean_reprojection_error()
    assert err_before == jrec.compute_mean_reprojection_error()
    jo = JOpt()
    jo.refine_focal_length = False
    jo.refine_extra_params = False
    jo.max_num_iterations = 30
    jo.print_summary = False
    jo.devices = "none"
    to = convert.ba_options_from_dict(jo.todict())
    js = j_bundle_adjustment(jrec, jo)
    ts = bundle_adjustment(trec, to, device="cpu", dense_schur_max_d=0)
    assert jrec.compute_mean_reprojection_error() < err_before
    assert trec.compute_mean_reprojection_error() < err_before
    assert ts.final_cost < ts.initial_cost
    assert ts.initial_cost == pytest.approx(js.initial_cost, rel=1e-5)
    # both solve the same f32 problem to convergence; the rest is f32
    # summation order
    assert ts.final_cost == pytest.approx(js.final_cost, rel=1e-4)


def test_bundle_adjustment_needs_two_images(tmp_path):
    rec = Reconstruction()
    assert bundle_adjustment(rec, device="cpu") is None


def _tracks(rec):
    return {frozenset((e.image_id, e.point2D_idx) for e in p.track.elements):
            p.xyz for p in rec.points3D.values()}


def test_triangulate_points_matches_reference(tmp_path):
    db = tmp_path / "db.db"
    gt = make_synthetic_database(db, num_images=6, num_points=200)
    gt.write_binary(tmp_path / "gt")  # poses and keypoints, no points
    jrec, trec = JRec(tmp_path / "gt"), Reconstruction(tmp_path / "gt")
    jo = JPipe()
    jo.devices = "none"
    to = convert.pipeline_options_from_dict(jo.todict())
    j_triangulate_points(jrec, db, tmp_path, tmp_path / "tri_j",
                         clear_points=True, options=jo)
    out = triangulate_points(trec, db, tmp_path, tmp_path / "tri_t",
                             clear_points=True, options=to, device="cpu",
                             dense_schur_max_d=0)
    # the reference test's outcome asserts, on the port
    assert out is trec
    assert out.num_points3D > 100
    assert out.compute_mean_reprojection_error() < 1.5
    out.check()
    # against the reference: the stage is deterministic (DLT and angle
    # tests, no RANSAC); the accepted differences are threshold flips after
    # f32 eigh on the two sides
    jt, tt = _tracks(jrec), _tracks(trec)
    scale = float(np.abs(np.stack(list(jt.values()))).max())
    assert abs(len(tt) - len(jt)) <= 0.01 * len(jt)
    same = jt.keys() & tt.keys()
    assert len(same) >= 0.99 * max(len(jt), len(tt))
    d = max(np.abs(jt[k] - tt[k]).max() for k in same)
    assert d <= 1e-4 * scale
    assert Reconstruction(tmp_path / "tri_t").num_points3D == out.num_points3D


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """With no device on a host without CUDA, both entry points raise."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rec = build_synthetic_reconstruction(num_images=3, num_points=20)
    with pytest.raises(RuntimeError, match="CUDA"):
        bundle_adjustment(rec)
    with pytest.raises(RuntimeError, match="CUDA"):
        triangulate_points(rec, tmp_path / "none.db", tmp_path, tmp_path / "o")
