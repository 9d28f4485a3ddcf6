"""The port's hierarchical mapping (pycolmap_torch/parallel/graph_partition.py)
against the reference on the CPU.

- ``partition_images`` and ``expand_with_overlap`` equal to the
  reference's on tests/test_hierarchical.py's four cases and on a random
  pair graph of 200 images (host Python, deterministic);
- ``merge_reconstructions`` of two sub-models cut from one synthetic model
  (the second under a Sim3) in both packages: the same image set and point
  count, and projection centers within 1e-4; a sub-model whose images
  still defer their keypoints to the database merges whole; sub-models
  whose common cameras stand on one line merge by their common points,
  where the reference's alignment by centers finds nothing;
- the port's ``hierarchical_mapping`` of a 12-image orbit in 2 parts with
  overlap 4, judged against the truth at tests/test_hierarchical.py's
  bounds (the reference's slow whole mapping is not replayed), with its
  timings;
- the device rule.
"""

import numpy as np
import pytest
import torch

import pycolmap_torch as pt
from pycolmap_torch.parallel import graph_partition as tgp
from pycolmap_tpu.geometry import Rotation3d as JRotation3d
from pycolmap_tpu.geometry import Sim3d as JSim3d
from pycolmap_tpu.parallel import graph_partition as jgp
from pycolmap_tpu.scene import Reconstruction as JRec

from test_incremental_mapping import make_synthetic_database
from test_scene import build_synthetic_reconstruction

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    """Many tiny CPU ops: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chain(n, w=100):
    return {(i, i + 1): w for i in range(1, n)}


def _random_graph(n=200, seed=0):
    """A sparse random pair graph: a noisy chain plus random long edges,
    weights 1-500, a few isolated images."""
    rng = np.random.default_rng(seed)
    counts = {}
    for i in range(1, n):
        if rng.random() < 0.9:
            counts[(i, i + 1)] = int(rng.integers(1, 500))
    for _ in range(3 * n):
        a, b = sorted(rng.choice(np.arange(1, n - 4), 2, replace=False))
        counts[(int(a), int(b))] = int(rng.integers(1, 500))
    return counts, range(1, n + 1)


CASES = {
    "covers_all_balanced": (_chain(20), range(1, 21), 4, 2),
    "chain_contiguous": (_chain(16), range(1, 17), 2, 2),
    "overlap_boundary": (_chain(10), range(1, 11), 2, 2),
    "deterministic": ({(i, j): ((i * 7 + j) % 13) + 1 for i in range(1, 15)
                       for j in range(i + 1, 15)}, range(1, 15), 3, 2),
    "random_200": (*_random_graph(), 5, 10),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_partitions_equal_reference(case):
    counts, ids, num_parts, overlap = CASES[case]
    got = tgp.partition_images(counts, ids, num_parts)
    ref = jgp.partition_images(counts, ids, num_parts)
    assert got == ref
    assert sorted(x for p in got for x in p) == list(ids)
    assert (tgp.expand_with_overlap(got, counts, overlap=overlap)
            == jgp.expand_with_overlap(ref, counts, overlap=overlap))


def _cut(path, keep):
    """The model at `path` with only the images in `keep` registered (and
    the points they still see twice)."""
    rec = JRec(path)
    for iid in list(rec.images):
        if iid not in keep:
            rec.deregister_image(iid)
    return rec


def _sub_models(tmp_path):
    """Two overlapping sub-models of one synthetic scene (images 1-5 and
    2-8), the second under a Sim3 of 170 degrees, as both packages read
    them."""
    full = build_synthetic_reconstruction(num_images=8, num_points=60,
                                          seed=4)
    full.write_binary(tmp_path / "full")
    a = _cut(tmp_path / "full", {1, 2, 3, 4, 5})
    b = _cut(tmp_path / "full", {2, 3, 4, 5, 6, 7, 8})
    b.transform(JSim3d(0.6, JRotation3d(np.array([0.0, 2.9, 0.7])),
                       np.array([1.0, -2.0, 0.5])))
    for name, rec in (("a", a), ("b", b)):
        rec.write_binary(tmp_path / name)
    return {pkg: (cls(tmp_path / "a"), cls(tmp_path / "b"))
            for pkg, cls in (("port", pt.Reconstruction), ("ref", JRec))}


def test_merge_reconstructions_matches_reference(tmp_path):
    models = _sub_models(tmp_path)
    (ta, tb), (ja, jb) = models["port"], models["ref"]
    assert tgp.merge_reconstructions(ta, tb, device=CPU)
    assert jgp.merge_reconstructions(ja, jb)
    assert ta.reg_image_ids == ja.reg_image_ids == list(range(1, 9))
    assert ta.num_points3D == ja.num_points3D
    for iid in ta.reg_image_ids:
        np.testing.assert_allclose(ta.images[iid].projection_center(),
                                   ja.images[iid].projection_center(),
                                   rtol=0, atol=1e-4)
    ta.check()
    # too few common images leave the base untouched
    lone = pt.Reconstruction(tmp_path / "b")
    for iid in (2, 3, 4, 5, 6):
        lone.deregister_image(iid)
    n = ta.num_points3D
    assert not tgp.merge_reconstructions(ta, lone, device=CPU)
    assert ta.num_points3D == n


def test_merge_database_backed_images(tmp_path):
    """Images that still defer their keypoints to the database (as the
    mapper's cache loads them above 200 images): the merged copies hold
    their keypoints and only the links the merge made."""
    models = _sub_models(tmp_path)
    ta, tb = models["port"]
    reads = []
    for img in tb.images.values():
        xy = img.points2D_xy.copy()
        ids = img.points2D_point3D_ids.copy()
        img.set_lazy_keypoints(len(xy), lambda xy=xy: reads.append(1) or xy)
        img._p3d_ids[:] = ids
    assert tgp.merge_reconstructions(ta, tb, device=CPU)
    assert len(reads) == 3  # the images new to the base, read once each
    for iid in (6, 7, 8):
        img = ta.images[iid]
        assert img.points2D_xy is not None and img.num_points2D == 60
        linked = img.points2D_point3D_ids != np.uint64(
            pt.scene.point2d.INVALID_POINT3D_ID)
        assert img.num_points3D == int(linked.sum())
    ta.check()
    ta.write(tmp_path / "merged")
    back = pt.Reconstruction(tmp_path / "merged")
    assert back.num_points3D == ta.num_points3D


def test_merge_aligns_by_common_points(tmp_path):
    """Sub-models whose common images stand on one straight line: their
    projection centers leave the roll about the line free, the common 3D
    points do not. The port's merge (by points) puts every image of the
    second model within 1e-3 degrees of the first's frame; the reference's
    (by centers only) finds no Sim3 and merges nothing."""
    rng = np.random.default_rng(8)
    rec = pt.Reconstruction()
    rec.add_camera(pt.Camera.create(1, "SIMPLE_PINHOLE", 500.0, 640, 480))
    points = rng.uniform([-1, -2, 4], [8, 2, 7], (150, 3))
    for i in range(8):
        img = pt.Image(name=f"im{i}.jpg", camera_id=1, id=i + 1)
        img.cam_from_world = pt.Rigid3d(pt.Rotation3d(np.eye(3)),
                                        np.array([-float(i), 0.0, 0.0]))
        xc = img.cam_from_world * points
        img.set_keypoints(500.0 * xc[:, :2] / xc[:, 2:] + [320.0, 240.0])
        img.registered = True
        rec.add_image(img)
    for j in range(len(points)):
        rec.add_point3D(points[j], pt.Track(
            [pt.TrackElement(i + 1, j) for i in range(8)]))
    rec.write_binary(tmp_path / "full")
    a = _cut(tmp_path / "full", {1, 2, 3, 4, 5})
    b = _cut(tmp_path / "full", {3, 4, 5, 6, 7, 8})
    b.transform(JSim3d(0.6, JRotation3d(np.array([0.4, -1.1, 0.7])),
                       np.array([1.0, -2.0, 0.5])))
    a.write_binary(tmp_path / "a")
    b.write_binary(tmp_path / "b")
    ta, tb = pt.Reconstruction(tmp_path / "a"), pt.Reconstruction(
        tmp_path / "b")
    ja, jb = JRec(tmp_path / "a"), JRec(tmp_path / "b")
    assert tgp.merge_reconstructions(ta, tb, device=CPU)
    assert not jgp.merge_reconstructions(ja, jb)
    for i in (6, 7, 8):
        rot = ta.images[i].cam_from_world.rotation
        assert np.rad2deg(rot.angle_to(pt.Rotation3d(np.eye(3)))) < 1e-3


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    root = tmp_path_factory.mktemp("hier")
    gt = make_synthetic_database(root / "db.db", num_images=12,
                                 num_points=150, pixel_noise=0.4)
    gt.write_binary(root / "gt")
    options = pt.IncrementalPipelineOptions()
    options.min_model_size = 4
    options.extract_colors = False
    timings = {}
    torch.set_num_threads(1)
    recs = pt.hierarchical_mapping(root / "db.db", root, root / "sparse",
                                   num_partitions=2, overlap=4,
                                   options=options, device=CPU,
                                   timings=timings)
    return root, recs, timings


def test_hierarchical_mapping_merges_partitions(mapped):
    root, recs, timings = mapped
    merged = recs[0]
    assert merged.num_reg_images >= 10
    result = pt.compare_reconstructions(
        merged, pt.Reconstruction(root / "gt"), device=CPU)
    rot = np.median([e.rotation_error_deg for e in result["errors"]])
    assert rot < 0.5
    merged.check()
    back = pt.Reconstruction(root / "sparse" / "0")
    assert sorted(back.reg_image_ids) == sorted(merged.reg_image_ids)


def test_hierarchical_mapping_timings(mapped):
    _, _, timings = mapped
    assert timings["partition"] >= 0 and timings["merge"] >= 0
    parts = timings["parts"]
    assert len(parts) == 2
    for p in parts:
        assert p["images"] >= 6 and 0 < p["registered"] <= p["images"]
        assert p["seconds"] > 0 and p["timings"]["load"] > 0
        assert p["timings"]["ba_solves"] > 0


def test_device_rule(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.hierarchical_mapping(tmp_path / "none.db", tmp_path, tmp_path)
