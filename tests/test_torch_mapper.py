"""The port's incremental mapper and ``incremental_mapping`` against the
reference on the CPU.

Both packages read the same database (tests/test_incremental_mapping.py's
6-image / 200-point orbit) and the same binary models. Both are pinned to
the implicit Schur-PCG path (the reference by
PYCOLMAP_TPU_DENSE_SCHUR_MAX_D=0, the port by dense_schur_max_d=0; both
solve these small bundles densely by default, which
tests/test_torch_dense_schur.py compares). Rankings, tie-breaks and filters are
host numpy in both packages and compare exactly; bundle adjustment compares
within 1e-5 (initial cost) and 1e-4 (final cost) relative; whole mappings
compare on outcomes, since the estimators' random streams differ
(``torch.Generator`` against ``jax.random``)."""

import numpy as np
import pytest
import torch

from pycolmap_tpu.estimators import compare_reconstructions
from pycolmap_tpu.pipeline.sfm import IncrementalPipelineOptions as JPipe
from pycolmap_tpu.pipeline.sfm import incremental_mapping as j_mapping
from pycolmap_tpu.scene import Reconstruction as JRec
from pycolmap_tpu.sfm.database_cache import DatabaseCache as JCache
from pycolmap_tpu.sfm.incremental_mapper import ImageSelectionMethod as JSel
from pycolmap_tpu.sfm.incremental_mapper import IncrementalMapper as JMapper
from pycolmap_tpu.sfm.incremental_mapper import VisibilityPyramid as JPyr
from pycolmap_torch import convert
from pycolmap_torch.pipeline import (
    ImageSelectionMethod,
    IncrementalMapper,
    IncrementalPipelineOptions,
    incremental_mapping,
)
from pycolmap_torch.scene import Reconstruction
from pycolmap_torch.sfm.database_cache import DatabaseCache
from pycolmap_torch.sfm.incremental_mapper import VisibilityPyramid

from test_incremental_mapping import make_synthetic_database


@pytest.fixture(autouse=True)
def _one_thread():
    """Many tiny CPU ops: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _options():
    """tests/test_incremental_mapping.py's options, for both packages."""
    jo = JPipe()
    jo.min_model_size = 4
    jo.extract_colors = False
    jo.ba_refine_principal_point = False
    jo.devices = "none"
    return jo, convert.pipeline_options_from_dict(jo.todict())


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """One incremental_mapping run of each package on the same database."""
    root = tmp_path_factory.mktemp("mapper")
    db = root / "db.db"
    gt = make_synthetic_database(db, num_images=6, num_points=200)
    jo, to = _options()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYCOLMAP_TPU_DENSE_SCHUR_MAX_D", "0")
        jrecs = j_mapping(db, root, root / "sparse_j", jo)
    timings = {}
    trecs = incremental_mapping(db, root, root / "sparse_t", to,
                                device="cpu", timings=timings,
                                dense_schur_max_d=0)
    return dict(root=root, db=db, gt=gt, jrecs=jrecs, trecs=trecs,
                timings=timings)


def _median_rot_err(rec, gt):
    result = compare_reconstructions(rec, gt)
    assert result is not None
    return float(np.median([e.rotation_error_deg for e in result["errors"]]))


def test_incremental_mapping_matches_reference(mapped):
    """The slice as a whole: the same registered count, both under 1 px,
    point counts within 10%, both within 0.5 degrees of the truth (the
    port's model judged by the reference's compare_reconstructions after
    reading it back from disk)."""
    jrec, trec = mapped["jrecs"][0], mapped["trecs"][0]
    assert len(mapped["trecs"]) == len(mapped["jrecs"]) == 1
    assert trec.num_reg_images == jrec.num_reg_images == 6
    assert trec.compute_mean_reprojection_error() < 1.0
    assert jrec.compute_mean_reprojection_error() < 1.0
    assert abs(trec.num_points3D - jrec.num_points3D) <= 0.1 * max(
        trec.num_points3D, jrec.num_points3D)
    assert trec.num_points3D > 150
    trec.check()
    t_disk = JRec(mapped["root"] / "sparse_t" / "0")
    assert _median_rot_err(t_disk, mapped["gt"]) < 0.5
    assert _median_rot_err(jrec, mapped["gt"]) < 0.5


def test_model_reads_back(mapped):
    trec = mapped["trecs"][0]
    back = Reconstruction(mapped["root"] / "sparse_t" / "0")
    assert back.reg_image_ids == trec.reg_image_ids
    assert back.num_points3D == trec.num_points3D


def test_timings_and_counters(mapped):
    t = mapped["timings"]
    for key in ("load", "initial_pair", "register", "triangulate",
                "local_ba", "global_ba", "pose_graph", "write",
                "register_pnp", "local_ba_solve", "global_ba_solve"):
        assert t[key] >= 0.0, key
    assert t["register_pnp"] <= t["register"]
    assert t["ba_solves"] == t["ba_cache_hits"] + t["ba_cache_misses"]
    assert t["ba_lm_steps"] >= t["ba_solves"] > 0
    assert t["ba_cg_iterations"] >= t["ba_lm_steps"]
    # pinned to the implicit path: no dense solve
    assert (t["ba_dense_solves"], t["ba_dense_lm_steps"],
            t["ba_dense_cg_iterations"]) == (0, 0, 0)
    # converged refinement rounds re-solve unchanged problems
    assert t["ba_cache_hits"] > 0


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """With no device on a host without CUDA, the mapper and
    incremental_mapping raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        incremental_mapping(tmp_path / "none.db", tmp_path, tmp_path / "o")
    with pytest.raises(RuntimeError, match="CUDA"):
        IncrementalMapper(DatabaseCache())


def test_visibility_pyramid_score_matches():
    rng = np.random.default_rng(0)
    for n, (w, h) in zip((0, 1, 37, 500, 4000),
                         ((640, 480), (640, 480), (100, 50), (1280, 960),
                          (0, 0))):
        xy = rng.uniform(-20, max(w, h) + 20, (n, 2))
        assert VisibilityPyramid(w, h).score(xy) == JPyr(w, h).score(xy)


def _mappers(db):
    return (JMapper(JCache.load(db)),
            IncrementalMapper(DatabaseCache.load(db), device="cpu",
                              dense_schur_max_d=0))


def test_find_initial_image_pair_matches(mapped):
    jm, tm = _mappers(mapped["db"])
    jo, to = _options()
    jmo, tmo = jo.get_mapper(), to.get_mapper()
    got = [tm.find_initial_image_pair(tmo) for _ in range(10)]
    want = [jm.find_initial_image_pair(jmo) for _ in range(10)]
    assert got == want
    assert sum(p[0] is not None for p in got) == 10


def _shared_models(mapped, deregister=()):
    """The port's mapped model read into both packages, with `deregister`
    images taken out, and a mapper of each package begun on it."""
    path = mapped["root"] / "sparse_t" / "0"
    jm, tm = _mappers(mapped["db"])
    jrec, trec = JRec(path), Reconstruction(path)
    for rec in (jrec, trec):
        for iid in deregister:
            rec.deregister_image(iid)
    jm.cache.setup_reconstruction(jrec)
    tm.cache.setup_reconstruction(trec)
    jm.begin_reconstruction(jrec)
    tm.begin_reconstruction(trec)
    return jm, tm


@pytest.mark.parametrize("method", list(ImageSelectionMethod))
def test_find_next_images_matches(mapped, method):
    jm, tm = _shared_models(mapped, deregister=(2, 5))
    jo, to = _options()
    jmo, tmo = jo.get_mapper(), to.get_mapper()
    jmo.image_selection_method = JSel(int(method))
    tmo.image_selection_method = method
    got = tm.find_next_images(tmo)
    assert got == jm.find_next_images(jmo)
    assert sorted(got) == [2, 5]


@pytest.mark.parametrize("window", [3, 6])
def test_local_bundle_images_match(mapped, window):
    jm, tm = _shared_models(mapped)
    jo, to = _options()
    jmo, tmo = jo.get_mapper(), to.get_mapper()
    jmo.local_ba_num_images = tmo.local_ba_num_images = window
    for iid in tm.reconstruction.reg_image_ids:
        got = tm._local_bundle_images(tmo, iid)
        assert got == jm._local_bundle_images(jmo, iid)
        assert len(got) == window


def test_filter_images_matches(mapped):
    """Deleting every observation of image 3 leaves it with no point: both
    mappers deregister it, and only it."""
    jm, tm = _shared_models(mapped)
    jo, to = _options()
    for m in (jm, tm):
        rec = m.reconstruction
        m.existing_image_ids = set()
        for idx in rec.images[3].get_observation_points2D_idxs():
            rec.delete_observation(3, int(idx))
    assert tm.filter_images(to.get_mapper()) == jm.filter_images(
        jo.get_mapper()) == 1
    assert tm.filtered_images == jm.filtered_images == {3}
    assert (tm.reconstruction.reg_image_ids
            == jm.reconstruction.reg_image_ids)


def _perturbed_models(mapped, tmp_path):
    """The port's mapped model with every point moved by ~1 cm, written
    once and read into both packages, each with its mapper."""
    rec = Reconstruction(mapped["root"] / "sparse_t" / "0")
    rng = np.random.default_rng(0)
    for pid in sorted(rec.points3D):
        rec.points3D[pid].xyz = rec.points3D[pid].xyz + rng.normal(0, 0.01, 3)
    rec.write_binary(tmp_path)
    jm, tm = _mappers(mapped["db"])
    jrec, trec = JRec(tmp_path), Reconstruction(tmp_path)
    jm.begin_reconstruction(jrec)
    tm.begin_reconstruction(trec)
    return jm, tm


def _close_summaries(ts, js):
    assert ts.initial_cost == pytest.approx(js.initial_cost, rel=1e-5)
    assert ts.final_cost == pytest.approx(js.final_cost, rel=1e-4)
    assert ts.final_cost < ts.initial_cost


def test_adjust_global_bundle_matches(mapped, tmp_path, monkeypatch):
    monkeypatch.setenv("PYCOLMAP_TPU_DENSE_SCHUR_MAX_D", "0")
    jm, tm = _perturbed_models(mapped, tmp_path)
    jo, to = _options()
    js = jm.adjust_global_bundle(jo.get_mapper(), jo.get_global_ba())
    ts = tm.adjust_global_bundle(to.get_mapper(), to.get_global_ba())
    _close_summaries(ts, js)
    assert tm.resident_ba.misses == 1


def test_adjust_local_bundle_matches(mapped, tmp_path, monkeypatch):
    monkeypatch.setenv("PYCOLMAP_TPU_DENSE_SCHUR_MAX_D", "0")
    jm, tm = _perturbed_models(mapped, tmp_path)
    jo, to = _options()
    iid = tm.reconstruction.reg_image_ids[-1]
    js = jm.adjust_local_bundle(jo.get_mapper(), jo.get_local_ba(),
                                jo.triangulation, iid)
    ts = tm.adjust_local_bundle(to.get_mapper(), to.get_local_ba(),
                                to.triangulation, iid)
    _close_summaries(ts, js)


def test_pipeline_options_convert():
    """get_mapper / get_local_ba carry the same values in both packages,
    the mesh selector ``devices`` among them."""
    jo, to = _options()
    assert to.get_mapper().todict() == jo.get_mapper().todict()
    assert to.get_local_ba().todict() == jo.get_local_ba().todict()


@pytest.mark.parametrize("mode", ["reprojection", "proj_center"])
def test_port_compare_reconstructions_judges_alike(mapped, tmp_path, mode):
    """The port's own compare_reconstructions beside the reference's: on
    the port's model against the truth, the same images and errors within
    1e-4; the two packages' models against each other align through their
    common points (the robust Sim3) within 0.5 degrees."""
    from pycolmap_torch.estimators import compare_reconstructions as t_compare

    mapped["gt"].write_binary(tmp_path / "gt")
    t_disk = Reconstruction(mapped["root"] / "sparse_t" / "0")
    j_disk = JRec(mapped["root"] / "sparse_t" / "0")
    got = t_compare(t_disk, Reconstruction(tmp_path / "gt"), mode,
                    device="cpu")
    ref = compare_reconstructions(j_disk, mapped["gt"], mode)
    assert [e.image_name for e in got["errors"]] == [
        e.image_name for e in ref["errors"]]
    for g, r in zip(got["errors"], ref["errors"]):
        assert abs(g.rotation_error_deg - r.rotation_error_deg) < 1e-4
        assert abs(g.proj_center_error - r.proj_center_error) < 1e-4
    assert np.median([e.rotation_error_deg for e in got["errors"]]) < 0.5
    mapped["jrecs"][0].write_binary(tmp_path / "j")
    cross = t_compare(t_disk, Reconstruction(tmp_path / "j"), mode,
                      device="cpu")
    assert len(cross["errors"]) == 6
    assert np.median([e.rotation_error_deg for e in cross["errors"]]) < 0.5
