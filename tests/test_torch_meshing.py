"""The port's meshing (pycolmap_torch/mvs/meshing.py) and its fused.ply.vis
reader against the reference on the CPU.

- PLY files: the fused-cloud reader and the mesh writer give the same
  arrays and bytes;
- ``marching_tetrahedra`` on a 32^3 sphere distance field: the same
  vertices and faces, bit for bit, and the same mesh file;
- the DCT-II / DCT-III pair against scipy's ``dctn`` / ``idctn`` (ortho);
- the Poisson solve on a 2,000-point sphere at depth 5: chi within 1e-4
  scaled of the reference's (captured from the reference's call of its
  marching tetrahedra), the same grid, iso level and mesh size; the mesh at
  depths 5 and 6 within 0.5% in vertices, 99.9% of vertices within 1e-3 of
  a grid cell; tests/test_mvs.py's sphere-quality bounds on the port;
- the Delaunay meshers: the visibility-carved faces on tests/test_mvs.py's
  sphere, and the graph-cut and threshold labels on its spurious-vote case
  and on random votes over ~25k cells (the port's native cut is
  Boykov-Kolmogorov, the reference's Dinic), equal to the reference's; ``sparse_`` and ``dense_delaunay_meshing``
  write byte-identical files on a small model and workspace (the 200k
  subsample is not reached at this size);
- ``read_fused_vis`` (pointer jumping) against the reference's loop on
  random files with zero-count points;
- the options' converters and the device rule.
"""

import numpy as np
import pytest
import torch
from scipy.fft import dctn, idctn
from scipy.spatial import Delaunay

from pycolmap_tpu.mvs import fusion as fu_ref
from pycolmap_tpu.mvs import meshing as ref
from pycolmap_torch import convert
from pycolmap_torch.mvs import fusion as fu
from pycolmap_torch.mvs import meshing as tm
from test_mvs import build_workspace

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sphere_cloud(path, n, R=2.0, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    fu_ref._write_ply(path, R * v, np.full((n, 3), 128, np.uint8), v)
    return R


def _read_mesh(path):
    b = path.read_bytes()
    h = b.index(b"end_header\n") + len(b"end_header\n")
    head = b[:h].decode()
    nv = int(head.split("element vertex ")[1].split()[0])
    V = np.frombuffer(b[h:h + 12 * nv], "<f4").reshape(nv, 3)
    F = np.frombuffer(b[h + 12 * nv:],
                      np.dtype([("n", "u1"), ("i", "<i4", (3,))]))["i"]
    return V, F


def test_ply_files_match(tmp_path):
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(300, 3))
    nrm = rng.normal(size=(300, 3))
    rgb = rng.integers(0, 256, (300, 3)).astype(np.uint8)
    fu_ref._write_ply(tmp_path / "fused.ply", xyz, rgb, nrm)
    ascii_ply = tmp_path / "ascii.ply"
    ascii_ply.write_text(
        "ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\n"
        "property float y\nproperty float z\nend_header\n1 2 3\n4.5 5 6\n")
    for path in (tmp_path / "fused.ply", ascii_ply):
        for a, b in zip(tm.read_fused_ply(path), ref.read_fused_ply(path)):
            assert (a is None and b is None) or np.array_equal(a, b)
    faces = rng.integers(0, 300, (500, 3))
    ref.write_mesh_ply(tmp_path / "a.ply", xyz, faces)
    tm.write_mesh_ply(tmp_path / "b.ply", xyz, faces)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()


def test_marching_tetrahedra_bit_equal(tmp_path):
    n = 32
    g = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1)
    field = (np.linalg.norm(g - [15.3, 16.1, 14.7], axis=-1) - 9.7).astype(
        np.float32)
    origin, spacing = np.array([0.1, -0.2, 0.3]), np.array([0.1, 0.12, 0.09])
    v_ref, f_ref = ref.marching_tetrahedra(field, 0.013, origin, spacing)
    v, f = tm.marching_tetrahedra(field, 0.013, origin, spacing, device=CPU)
    assert len(f_ref) > 1000
    assert np.array_equal(v, v_ref) and np.array_equal(f, f_ref)
    ref.write_mesh_ply(tmp_path / "a.ply", v_ref, f_ref)
    tm.write_mesh_ply(tmp_path / "b.ply", v, f)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    # a tensor runs on its own device; no crossing cell gives empty arrays
    v2, f2 = tm.marching_tetrahedra(torch.from_numpy(field), 0.013, origin,
                                    spacing)
    assert np.array_equal(v2, v_ref) and np.array_equal(f2, f_ref)
    v3, f3 = tm.marching_tetrahedra(field, 100.0, origin, spacing, device=CPU)
    assert v3.shape == (0, 3) and f3.shape == (0, 3)


@pytest.mark.parametrize("shape", [(8, 9, 7), (16, 16, 16), (5, 32, 3)])
def test_dct_pair_matches_scipy(shape):
    x = np.random.default_rng(2).normal(size=shape)
    t = torch.from_numpy(x)
    y = t
    for ax in range(3):
        y = tm._dct2(y, ax)
    want = dctn(x, type=2, norm="ortho")
    assert np.abs(y.numpy() - want).max() < 1e-5 * max(1, np.abs(want).max())
    z = torch.from_numpy(want)
    for ax in range(3):
        z = tm._idct2(z, ax)
    assert np.abs(z.numpy() - idctn(want, type=2, norm="ortho")).max() < 1e-5


def _reference_field(monkeypatch, path, depth):
    """The reference's poisson_meshing, with chi and the grid captured at
    its call of marching_tetrahedra."""
    seen = {}
    mt = ref.marching_tetrahedra

    def capture(field, iso, origin, spacing):
        seen.update(chi=field, iso=iso, origin=origin, spacing=spacing)
        return mt(field, iso, origin, spacing)

    monkeypatch.setattr(ref, "marching_tetrahedra", capture)
    mo = ref.PoissonMeshingOptions()
    mo.depth = depth
    assert ref.poisson_meshing(path, path.with_name(f"ref{depth}.ply"), mo)
    monkeypatch.setattr(ref, "marching_tetrahedra", mt)
    return seen


def test_poisson_field_matches_reference(tmp_path, monkeypatch):
    _sphere_cloud(tmp_path / "fused.ply", 2000)
    want = _reference_field(monkeypatch, tmp_path / "fused.ply", 5)
    xyz, nrm, _ = tm.read_fused_ply(tmp_path / "fused.ply")
    got = tm.poisson_field(xyz, nrm, 32, torch.device(CPU))
    chi = got["chi"].numpy()
    assert chi.dtype == np.float32 and chi.shape == (32, 32, 32)
    assert np.abs(chi - want["chi"]).max() < 1e-4 * max(
        1.0, np.abs(want["chi"]).max())
    assert got["iso"] == pytest.approx(want["iso"], rel=1e-5, abs=1e-7)
    assert np.allclose(got["lo"] + 0.5 * got["spacing"], want["origin"],
                       rtol=0, atol=1e-12)
    assert np.allclose(got["spacing"], want["spacing"], rtol=1e-14)
    # the reference's field through the port's marching tetrahedra: the
    # reference's mesh before its trim, bit for bit
    v_ref, f_ref = ref.marching_tetrahedra(want["chi"], want["iso"],
                                           want["origin"], want["spacing"])
    v, f = tm.marching_tetrahedra(want["chi"], want["iso"], want["origin"],
                                  want["spacing"], device=CPU)
    assert np.array_equal(v, v_ref) and np.array_equal(f, f_ref)


@pytest.mark.parametrize("depth", [5, 6])
def test_poisson_mesh_matches_reference(tmp_path, monkeypatch, depth):
    _sphere_cloud(tmp_path / "fused.ply", 2000)
    want = _reference_field(monkeypatch, tmp_path / "fused.ply", depth)
    timings = {}
    assert tm.poisson_meshing(tmp_path / "fused.ply", tmp_path / "port.ply",
                              tm.PoissonMeshingOptions(depth=depth),
                              device=CPU, timings=timings)
    assert set(timings) == {"read", "splat_smooth", "solve", "iso",
                            "marching_tetrahedra", "trim", "write"}
    from scipy.spatial import cKDTree

    v_ref, f_ref = _read_mesh(tmp_path / f"ref{depth}.ply")
    v, f = _read_mesh(tmp_path / "port.ply")
    assert abs(len(v) - len(v_ref)) <= 0.005 * len(v_ref)
    assert abs(len(f) - len(f_ref)) <= 0.005 * len(f_ref)
    dist, _ = cKDTree(v_ref.astype(np.float64)).query(v.astype(np.float64))
    cell = np.min(want["spacing"])
    assert (dist < 1e-3 * cell).mean() >= 0.999


def test_poisson_sphere_quality(tmp_path):
    """tests/test_mvs.py's quality gate on the port."""
    R = _sphere_cloud(tmp_path / "fused.ply", 4000)
    mo = tm.PoissonMeshingOptions()
    mo.depth = 6
    assert tm.poisson_meshing(tmp_path / "fused.ply", tmp_path / "mesh.ply",
                              mo, device=CPU)
    verts, _ = _read_mesh(tmp_path / "mesh.ply")
    r = np.linalg.norm(verts, axis=1)
    assert np.median(np.abs(r - R)) < 0.1 * R
    assert (np.abs(r - R) < 0.25 * R).mean() > 0.9


def test_delaunay_visibility_mesh_matches_reference():
    """tests/test_mvs.py's sphere seen by 20 cameras: the same faces."""
    rng = np.random.default_rng(0)
    n, R = 800, 2.0
    v = rng.normal(size=(n, 3))
    xyz = R * v / np.linalg.norm(v, axis=1, keepdims=True)
    c = rng.normal(size=(20, 3))
    centers = 6.0 * c / np.linalg.norm(c, axis=1, keepdims=True)
    d = np.linalg.norm(xyz[:, None] - centers[None], axis=2)
    obs = [(i, j) for i in range(n) for j in np.argsort(d[i])[:3]]
    timings = {}
    faces = tm._delaunay_visibility_mesh(xyz, centers, np.array(obs),
                                         timings=timings)
    assert np.array_equal(faces, ref._delaunay_visibility_mesh(xyz, centers,
                                                               obs))
    assert set(timings) == {"qhull", "votes", "cut"}
    r = np.linalg.norm(xyz[faces].mean(axis=1), axis=1)
    assert len(faces) > 200 and np.median(np.abs(r - R)) < 0.15 * R


def test_graphcut_and_threshold_labels_match_reference():
    """tests/test_mvs.py's spurious free-space vote in solid matter."""
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(300, 3))
    tri = Delaunay(xyz)
    tets, nb = tri.simplices, tri.neighbors
    in_votes = np.full(len(tets), 10.0)
    out_votes = np.zeros(len(tets))
    spur = np.nonzero((nb >= 0).all(axis=1))[0][0]
    out_votes[spur], in_votes[spur] = 11.0, 0.0
    thr = tm._threshold_labels(tets, nb, out_votes, in_votes)
    assert np.array_equal(thr, ref._threshold_labels(tets, nb, out_votes,
                                                     in_votes))
    gc = tm._graphcut_labels(xyz, tets, nb, out_votes, in_votes, 5.0)
    assert np.array_equal(gc, ref._graphcut_labels(xyz, tets, nb, out_votes,
                                                   in_votes, 5.0))
    assert thr[spur] and not gc[spur] and gc.sum() < 0.1 * len(tets)
    assert np.array_equal(tm._delaunay_mesh_points(xyz),
                          ref._delaunay_mesh_points(xyz))


@pytest.mark.parametrize("seed", [0, 1])
def test_graphcut_labels_match_reference_on_random_votes(seed):
    """~25k cells with random visibility votes: the port's native cut
    (Boykov-Kolmogorov) labels as the reference's native Dinic does."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(4000, 3))
    tri = Delaunay(xyz)
    tets, nb = tri.simplices, tri.neighbors
    out_votes = rng.poisson(2.0, len(tets)).astype(np.float64)
    in_votes = rng.poisson(2.0, len(tets)).astype(np.float64)
    want = ref._graphcut_labels(xyz, tets, nb, out_votes, in_votes, 1.0)
    got = tm._graphcut_labels(xyz, tets, nb, out_votes, in_votes, 1.0)
    assert 0.05 * len(tets) < want.sum() < 0.95 * len(tets)
    assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """tests/test_mvs.py's small workspace (4 images, 100 model points) with
    a fused cloud on its two planes and a .vis that lists ids outside the
    model and points with no image."""
    torch.set_num_threads(1)
    ws, _, _ = build_workspace(tmp_path_factory.mktemp("mesh"), num_images=4,
                               W=96, H=72)
    rng = np.random.default_rng(5)
    n = 3000
    x = rng.uniform(-2.5, 2.5, n)
    xyz = np.stack([x, rng.uniform(-2, 2, n), np.where(x < 0.15, 6.0, 7.5)],
                   axis=1)
    xyz += rng.normal(0, 0.01, xyz.shape)
    nrm = np.tile([0.0, 0.0, -1.0], (n, 1))
    fu_ref._write_ply(ws / "fused.ply", xyz, np.full((n, 3), 90, np.uint8),
                      nrm)
    counts = rng.integers(0, 5, n).astype(np.uint32)
    flat = rng.choice([1, 2, 3, 4, 99], int(counts.sum())).astype(np.uint32)
    fu_ref.write_fused_vis(ws / "fused.ply.vis", counts, flat)
    return ws


def test_delaunay_meshers_write_the_same_files(workspace):
    ws = workspace
    timings = {}
    assert tm.dense_delaunay_meshing(ws, ws / "dense_port.ply",
                                     timings=timings)
    assert ref.dense_delaunay_meshing(ws, ws / "dense_ref.ply")
    assert set(timings) == {"read", "qhull", "votes", "cut", "write"}
    assert tm.sparse_delaunay_meshing(ws / "sparse", ws / "sparse_port.ply")
    assert ref.sparse_delaunay_meshing(ws / "sparse", ws / "sparse_ref.ply")
    # a bare PLY takes the alpha-shape path
    assert tm.dense_delaunay_meshing(ws / "fused.ply", ws / "alpha_port.ply")
    assert ref.dense_delaunay_meshing(ws / "fused.ply", ws / "alpha_ref.ply")
    for name in ("dense", "sparse", "alpha"):
        a = (ws / f"{name}_port.ply").read_bytes()
        assert a == (ws / f"{name}_ref.ply").read_bytes(), name
        assert len(_read_mesh(ws / f"{name}_port.ply")[1]) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_read_fused_vis_matches_reference(tmp_path, seed):
    rng = np.random.default_rng(seed)
    n = [1, 300, 5000][seed]
    counts = rng.integers(0, [2, 6, 40][seed], n).astype(np.uint32)
    counts[rng.random(n) < 0.2] = 0
    flat = rng.integers(0, 2 ** 32, int(counts.sum()), dtype=np.uint64).astype(
        np.uint32)
    path = tmp_path / "fused.ply.vis"
    fu.write_fused_vis(path, counts, flat)
    c, f = fu.read_fused_vis(path)
    c_ref, f_ref = fu_ref.read_fused_vis(path)
    assert np.array_equal(c, c_ref) and np.array_equal(f, f_ref)
    assert np.array_equal(c, counts) and np.array_equal(f, flat)
    assert c.dtype == np.uint32 and f.dtype == np.uint32


def test_read_fused_vis_empty_and_truncated(tmp_path):
    path = tmp_path / "fused.ply.vis"
    fu.write_fused_vis(path, np.zeros(0, np.uint32), np.zeros(0, np.uint32))
    c, f = fu.read_fused_vis(path)
    assert len(c) == 0 and len(f) == 0
    fu.write_fused_vis(path, np.array([2, 3], np.uint32),
                       np.arange(5, dtype=np.uint32))
    path.write_bytes(path.read_bytes()[:-4])
    with pytest.raises(ValueError, match="malformed"):
        fu.read_fused_vis(path)


@pytest.mark.parametrize("name", ["poisson", "delaunay"])
def test_meshing_options_round_trip(name):
    cls_ref = {"poisson": ref.PoissonMeshingOptions,
               "delaunay": ref.DelaunayMeshingOptions}[name]
    conv = {"poisson": convert.poisson_meshing_options_from_dict,
            "delaunay": convert.delaunay_meshing_options_from_dict}[name]
    o = cls_ref()
    for k, v in o.todict().items():
        setattr(o, k, type(v)(v * 2 + 1))
    assert conv(o.todict()).todict() == o.todict()
    assert conv(cls_ref().todict()).todict() == cls_ref().todict()


def test_poisson_default_device_needs_cuda(tmp_path, monkeypatch):
    _sphere_cloud(tmp_path / "fused.ply", 200)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.poisson_meshing(tmp_path / "fused.ply", tmp_path / "mesh.ply")


def test_pipeline_namespace_matches_reference():
    """Every public name of the reference's pipeline package, and its
    top-level retrieval and meshing names, exist in the port's."""
    import types

    import pycolmap_tpu
    import pycolmap_tpu.pipeline as ref_pipeline

    import pycolmap_torch
    import pycolmap_torch.pipeline as pipeline

    names = {n for n, v in vars(ref_pipeline).items()
             if not n.startswith("_") and not isinstance(v, types.ModuleType)}
    assert not names - set(vars(pipeline)), names - set(vars(pipeline))
    assert names <= set(pipeline.__all__)
    for n in ("VocabTree", "InvertedIndex", "build_visual_index",
              "match_vocabtree", "poisson_meshing", "PoissonMeshingOptions",
              "DelaunayMeshingOptions", "sparse_delaunay_meshing",
              "dense_delaunay_meshing"):
        assert hasattr(pycolmap_tpu, n) and hasattr(pycolmap_torch, n), n
