"""The port's vocabulary-tree retrieval (pycolmap_torch/features/retrieval.py)
and the matchers built on it against the reference on the CPU.

- training: trees from the same sample against both reference paths (the
  host path and the jitted ``_jit_hkm_level``): centers within 1e-4, and
  each level's children of the sample equal on >= 99.9%; one level against
  ``_jit_hkm_level`` directly;
- quantization: flat words equal on >= 99.9% and top-3 on >= 99% (the
  reference's own bounds), ``quantize_batch_device`` likewise, the beam
  descent of an 8^5-word tree too; ties broken as numpy's argmax;
- npz trees cross between the packages, and ``vocab_tree_from_reference``;
- tests/test_retrieval.py's place databases: the same ranked lists,
  pairs and loops, the planted loop among them; the inverted index's
  scores;
- ``match_vocabtree`` (with and without ``num_images_after_verification``,
  and from a match list) and ``match_sequential``'s loop detection on a
  database of places revisited after 22 images, through both packages on
  copies of one database: the same verified pairs and configurations,
  each pair's inliers at least 0.85 of the reference's (the RANSAC draws
  differ), as tests/test_torch_match_features.py compares.
"""

import shutil

import numpy as np
import pytest
import torch

from pycolmap_tpu.features import retrieval as jr
from pycolmap_tpu.pipeline import match_features as jmf
from pycolmap_torch import convert
from pycolmap_torch.features import retrieval as tr
from pycolmap_torch.pipeline import match_features as tmf
from pycolmap_torch.scene import Camera, Database, Image
from pycolmap_torch.geometry import Rigid3d, Rotation3d
from test_retrieval import _clustered_descs, _make_place_db

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _descend(levels, branching, descs):
    """Each level's child of every row, by greedy descent (numpy)."""
    parent = np.zeros(len(descs), np.int64)
    out = []
    for c in levels:
        blocks = c.reshape(-1, branching, c.shape[1])[parent]
        sims = np.einsum("nbd,nd->nb", blocks.astype(np.float64),
                         descs.astype(np.float64))
        parent = parent * branching + np.argmax(sims, axis=1)
        out.append(parent)
    return out


@pytest.fixture(scope="module")
def sample():
    descs, labels = _clustered_descs(np.random.default_rng(0), 64, 40)
    return descs, labels


@pytest.mark.parametrize("use_device", [False, True])
def test_train_matches_reference(sample, use_device):
    descs, _ = sample
    want = jr.VocabTree.train(descs, branching=4, depth=3, seed=0,
                              use_device=use_device)
    got = tr.VocabTree.train(descs, branching=4, depth=3, seed=0, device=CPU)
    assert got.branching == 4 and got.depth == 3 and got.num_words == 64
    for a, b in zip(got.levels, want.levels):
        assert a.dtype == np.float32 and a.shape == b.shape
        assert np.abs(a - b).max() < 1e-4
    for a, b in zip(_descend(got.levels, 4, descs),
                    _descend(want.levels, 4, descs)):
        assert (a == b).mean() >= 0.999


def test_hkm_level_matches_jit_level():
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    B, K, N = 4, 16, 512
    true = jr._unit_rows(rng.normal(size=(K, 16)).astype(np.float32))
    labels = rng.integers(0, K, N)
    descs = jr._unit_rows((true[labels] + rng.normal(0, 0.05, (N, 16)))
                          .astype(np.float32))
    parent = (labels // B).astype(np.int64)
    centers0 = descs[[np.nonzero(labels == k)[0][0] for k in range(K)]]
    c_ref, child_ref = jr._jit_hkm_level()(
        jnp.asarray(descs), jnp.asarray(parent.astype(np.int32)),
        jnp.asarray(centers0), B, K, 8, 4)
    c, child = tr._hkm_level(torch.from_numpy(descs), torch.from_numpy(parent),
                             torch.from_numpy(centers0), B, 8)
    assert np.abs(c.numpy() - np.asarray(c_ref)).max() < 1e-4
    assert (child.numpy() == np.asarray(child_ref)).mean() >= 0.999
    assert (child.numpy() // B == parent).all()


def test_quantize_matches_reference(sample):
    descs, labels = sample
    tree = jr.VocabTree.train(descs, branching=4, depth=3, seed=0)
    port = convert.vocab_tree_from_reference(tree)
    w = port.quantize(descs, num_neighbors=3, device=CPU)
    w_ref = tree.quantize(descs, num_neighbors=3)
    assert w.dtype == np.int32 and w.shape == w_ref.shape
    assert (w[:, 0] == w_ref[:, 0]).mean() >= 0.999
    assert (w == w_ref).mean() >= 0.99
    assert np.array_equal(port.quantize(descs, device=CPU)[:, 0], w[:, 0])
    # uint8 rows normalized on the device, as the reference's device path
    u8 = np.random.default_rng(1).integers(0, 256, (500, 128)).astype(np.uint8)
    for nn in (1, 3):
        got = tr.quantize_batch_device(u8, tree.levels[-1], nn, device=CPU)
        want = jr.quantize_batch_device(u8, tree.levels[-1], nn)
        assert got.shape == (500, nn) and got.dtype == np.int32
        assert (got == want).mean() >= (0.999 if nn == 1 else 0.99)


def test_ties_break_to_the_lower_index():
    c = np.eye(4, 8, dtype=np.float32)
    c[2] = c[1]  # a duplicate center: equal similarities
    d = torch.tensor([[0.0, 1.0, 0, 0, 0, 0, 0, 0],
                      [0.6, 0.8, 0, 0, 0, 0, 0, 0]], dtype=torch.float64)
    got = tr._flat_words(d, torch.from_numpy(c).double(), 3)
    assert got.tolist() == [[1, 2, 0], [1, 2, 0]]
    assert tr._flat_words(d, torch.from_numpy(c).double(), 1).tolist() == [
        [1], [1]]
    assert tr._flat_words(d, torch.from_numpy(c).double(), 9).shape == (2, 4)


def test_beam_descent_matches_reference():
    """An 8^5-word tree (children near their parents) above the flat
    limit: the beam descent's words and top-2 equal the reference's."""
    rng = np.random.default_rng(4)
    B, D = 8, 32
    levels = [jr._unit_rows(rng.normal(size=(B, D)).astype(np.float32))]
    for lvl in range(1, 5):
        par = np.repeat(levels[-1], B, axis=0)
        levels.append(jr._unit_rows(
            (par + rng.normal(0, 0.6 / lvl, par.shape)).astype(np.float32)))
    tree = jr.VocabTree(levels, B)
    assert tree.num_words == 32768 > jr._FLAT_QUANT_MAX_WORDS
    leaves = rng.integers(0, tree.num_words, 800)
    descs = jr._unit_rows((levels[-1][leaves]
                           + rng.normal(0, 0.05, (800, D))).astype(np.float32))
    port = convert.vocab_tree_from_reference(tree)
    for nn, checks in ((1, 256), (2, 64)):
        want = tree.quantize(descs, num_neighbors=nn, num_checks=checks)
        got = port.quantize(descs, num_neighbors=nn, num_checks=checks,
                            device=CPU)
        assert got.shape == want.shape
        assert (got == want).mean() >= 0.999


def test_npz_trees_cross(tmp_path, sample):
    descs, _ = sample
    t_ref = jr.VocabTree.train(descs, branching=2, depth=3, seed=0)
    t_port = tr.VocabTree.train(descs, branching=2, depth=3, seed=0,
                                device=CPU)
    t_ref.save(tmp_path / "ref.npz")
    t_port.save(tmp_path / "port.npz")
    for a, b in ((tr.VocabTree.load(tmp_path / "ref.npz"), t_ref),
                 (jr.VocabTree.load(tmp_path / "port.npz"), t_port)):
        assert a.branching == b.branching and a.depth == b.depth
        for la, lb in zip(a.levels, b.levels):
            assert np.array_equal(la, lb)
    assert np.array_equal(
        tr.VocabTree.load(tmp_path / "ref.npz").quantize(descs, device=CPU),
        tr.VocabTree.load(tmp_path / "ref.npz").quantize(
            torch.from_numpy(descs)))


@pytest.mark.parametrize("images, words, per_image",
                         [(12, 64, 40), (200, 512, 600)])
def test_inverted_index_matches_reference(images, words, per_image):
    """The same ranked lists and scores, bit for bit: the port sums each
    image's postings a word at a time where the reference runs np.add.at
    (at the larger size most words are in most images)."""
    out = []
    for mod in (jr, tr):
        rng = np.random.default_rng(7)
        idx = mod.InvertedIndex(num_words=words)
        for i in range(images):
            idx.add_image(100 + i, rng.integers(0, words, per_image) if i != 5
                          else np.zeros(0, np.int64))
        idx.finalize()
        out.append([idx.query_row(r, 5) for r in range(images)]
                   + [idx.query(np.array([1, 2, 3, 3]), 4)])
    assert out[0] == out[1]
    assert out[1][0] and out[1][5] == []


def _ranked_equal(a, b):
    assert [q for q, _ in a] == [q for q, _ in b]
    for (_, ca), (_, cb) in zip(a, b):
        assert [m for m, _ in ca] == [m for m, _ in cb]
        assert np.allclose([s for _, s in ca], [s for _, s in cb], atol=1e-5)


def test_place_databases_rank_alike(tmp_path):
    places = list(range(27)) + [3, 27, 28]
    db, ids = _make_place_db(tmp_path / "loop.db", places)
    try:
        loops_ref = jr.detect_loops(db, ids, period=1, num_images=3)
        loops = tr.detect_loops(db, ids, period=1, num_images=3, device=CPU)
    finally:
        db.close()
    _ranked_equal(loops, loops_ref)
    hits = {(q, m) for q, c in loops for m, _ in c}
    assert (ids[27], ids[3]) in hits or (ids[3], ids[27]) in hits

    places = [0, 0, 0, 1, 1, 1, 2, 2, 2]
    db, ids = _make_place_db(tmp_path / "groups.db", places)
    try:
        pairs = tr.retrieve_pairs(db, ids, num_images=2, device=CPU)
        assert pairs == jr.retrieve_pairs(db, ids, num_images=2)
        _ranked_equal(
            tr.retrieve_ranked_pairs(db, ids, num_images=3, device=CPU),
            jr.retrieve_ranked_pairs(db, ids, num_images=3))
        centers, vecs = tr.build_bow_index(db, ids, device=CPU)
        centers_ref, vecs_ref = jr.build_bow_index(db, ids)
        assert np.abs(centers - centers_ref).max() < 1e-4
        for iid in ids:
            assert np.allclose(vecs[iid], vecs_ref[iid], atol=1e-5)
        timings = {}
        tree, index = tr.build_visual_index(
            db, ids, vocab_tree_path=str(tmp_path / "tree.npz"), device=CPU,
            timings=timings)
        again, _ = tr.build_visual_index(
            db, ids, vocab_tree_path=str(tmp_path / "tree.npz"), device=CPU)
        from_ref, _ = jr.build_visual_index(
            db, ids, vocab_tree_path=str(tmp_path / "tree.npz"))
    finally:
        db.close()
    same = sum(places[ids.index(a)] == places[ids.index(b)] for a, b in pairs)
    assert same / len(pairs) > 0.8
    assert set(timings) == {"read", "train", "train_levels", "quantize",
                            "index"}
    assert len(timings["train_levels"]) == tree.depth
    for a, b, c in zip(tree.levels, again.levels, from_ref.levels):
        assert np.array_equal(a, b) and np.array_equal(a, c)


def test_default_device_needs_cuda(tmp_path, monkeypatch):
    db, ids = _make_place_db(tmp_path / "db.db", [0, 0, 1, 1])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tr.build_visual_index(db, ids)
    finally:
        db.close()


# -- the matchers on a database of revisited places --------------------------

LOOP_PLACES, LOOP_REVISITS = 22, 6


def make_loop_db(db_path, seed=0):
    """A sequence of LOOP_PLACES places, then LOOP_REVISITS images that
    revisit places 0, 1, ... from a shifted pose. Each place has its own
    3-D points and descriptors, so only an image and its revisit match
    (and verify); they are LOOP_PLACES apart in the sequence, beyond
    detect_loops' gap of 20. Returns the image ids in sequence order."""
    rng = np.random.default_rng(seed)
    cam = Camera.create(0, "SIMPLE_PINHOLE", 500.0, 640, 480)
    db = Database(db_path)
    cam_id = db.write_camera(cam)
    X = rng.uniform(-2, 2, (LOOP_PLACES, 180, 3)) + [0, 0, 6]
    D = rng.integers(10, 250, (LOOP_PLACES, 180, 128))
    ids = []
    visits = list(range(LOOP_PLACES)) + list(range(LOOP_REVISITS))
    for i, place in enumerate(visits):
        shift = 0.0 if i < LOOP_PLACES else 0.6
        pose = Rigid3d(Rotation3d(), np.array([shift, 0.1 * shift, 0.0]))
        uv = (pose * X[place])
        xy = cam.img_from_cam(uv[:, :2] / uv[:, 2:])
        ids.append(db.write_image(Image(name=f"im{i:02d}.png",
                                        camera_id=cam_id)))
        db.write_keypoints(ids[-1], (xy + rng.normal(0, 0.3, xy.shape))
                           .astype(np.float32))
        db.write_descriptors(ids[-1], np.clip(
            D[place] + rng.integers(-3, 3, D[place].shape), 0, 255)
            .astype(np.uint8))
    db.commit()
    db.close()
    return ids


def loop_pairs(ids):
    return {(ids[k], ids[LOOP_PLACES + k]) for k in range(LOOP_REVISITS)}


def _geometries(db_path):
    from pycolmap_torch.scene import pair_id_to_image_pair

    db = Database(db_path)
    try:
        pairs = [tuple(int(i) for i in pair_id_to_image_pair(pid))
                 for pid in db.read_two_view_geometries()[0]]
        return {p: db.read_two_view_geometry(*p) for p in pairs}
    finally:
        db.close()


@pytest.fixture(scope="module")
def matched(tmp_path_factory):
    """Each strategy through both packages on copies of one database; the
    reference verifies one pair per block throughout (one compile)."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("vocabtree")
    ids = make_loop_db(root / "src.db")
    (root / "list.txt").write_text("im01.png im23.png\n"
                                   "im02.png missing.png\n")
    vt = jmf.VocabTreeMatchingOptions()
    vt.num_images = 3
    capped = jmf.VocabTreeMatchingOptions()
    capped.num_images = 5
    capped.num_images_after_verification = 1
    listed = jmf.VocabTreeMatchingOptions()
    listed.match_list_path = str(root / "list.txt")
    seq = jmf.SequentialMatchingOptions()
    seq.overlap = 1
    seq.quadratic_overlap = False
    seq.loop_detection = True
    seq.loop_detection_period = 1
    seq.loop_detection_num_images = 3
    runs = {}
    for name, opts, fn_j, fn_t, conv in (
            ("vocabtree", vt, jmf.match_vocabtree, tmf.match_vocabtree,
             convert.vocab_tree_matching_options_from_dict),
            ("capped", capped, jmf.match_vocabtree, tmf.match_vocabtree,
             convert.vocab_tree_matching_options_from_dict),
            ("match_list", listed, jmf.match_vocabtree, tmf.match_vocabtree,
             convert.vocab_tree_matching_options_from_dict),
            ("loop_detection", seq, jmf.match_sequential,
             tmf.match_sequential,
             convert.sequential_matching_options_from_dict)):
        runs[name] = {}
        for tag in ("j", "t"):
            db = root / f"{name}_{tag}.db"
            shutil.copy(root / "src.db", db)
            n = (fn_j(db, matching_options=opts) if tag == "j" else
                 fn_t(db, matching_options=conv(opts.todict()), device=CPU))
            runs[name][tag] = (n, _geometries(db))
    return ids, runs


@pytest.mark.parametrize("strategy", ["vocabtree", "capped", "match_list",
                                      "loop_detection"])
def test_vocabtree_matchers_match_reference(matched, strategy):
    ids, runs = matched
    (n_j, g_j), (n_t, g_t) = runs[strategy]["j"], runs[strategy]["t"]
    verified = {p for p, g in g_t.items() if len(g.inlier_matches) >= 15}
    want = loop_pairs(ids)
    if strategy == "match_list":
        want = {(ids[1], ids[LOOP_PLACES + 1])}
    # every revisit found and verified, nothing else passes
    assert n_t == n_j == len(want) and verified == want
    assert set(g_t) == set(g_j)
    for pair, gj in g_j.items():
        gt = g_t[pair]
        assert gt.config == gj.config, pair
        assert len(gt.inlier_matches) >= 0.85 * len(gj.inlier_matches), pair
