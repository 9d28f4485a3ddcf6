"""The port's batched LO-RANSAC (pycolmap_torch/estimators/ransac.py) against
the reference's engine, on the CPU.

- ``RANSACOptions`` and ``dyn_num_trials`` equal the reference's;
- one chunk of the fundamental, homography, absolute-pose and triangulation
  estimators given the reference's drawn indices (its ``_sample_indices``
  for key 0): the same best inlier count and a model within 1e-4 (up to
  sign for F), plain and fused with the LO loop;
- the host orchestration: the stopping rule and trial counts, the host LO
  refit of a later winner, determinism, too few points.

Data are made from a seed with numpy; every reference chunk runs at the
correspondences' own count (valid mask all ones), as the port does.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pycolmap_tpu.estimators import absolute_pose as jap
from pycolmap_tpu.estimators import fundamental_matrix as jfm
from pycolmap_tpu.estimators import homography_matrix as jhm
from pycolmap_tpu.estimators import ransac as jr
from pycolmap_tpu.estimators import triangulation as jtr
from pycolmap_torch.estimators import absolute_pose as tap
from pycolmap_torch.estimators import fundamental_matrix as tfm
from pycolmap_torch.estimators import homography_matrix as thm
from pycolmap_torch.estimators import ransac as tr
from pycolmap_torch.estimators import triangulation as ttr


@pytest.fixture(autouse=True)
def _one_thread():
    """Many tiny CPU ops: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_options_and_report():
    assert tr.RANSACOptions().todict() == jr.RANSACOptions().todict()
    rep = tr.RANSACReport(success=True, support_num_inliers=3,
                          inlier_mask=np.array([1, 1, 1, 0], bool))
    assert rep.inlier_ratio == 0.75
    assert tr.RANSACReport(success=False).inlier_ratio == 0.0


def test_dyn_num_trials_equals_reference():
    for n in (0, 1, 7, 100, 4000):
        for inl in sorted({0, 1, n // 10, n // 2, n - 1, n}):
            for m in (2, 3, 4, 5, 7):
                for conf in (0.99, 0.9999, 1.0):
                    args = (inl, n, m, conf, 3.0)
                    assert tr.dyn_num_trials(*args) == jr.dyn_num_trials(*args)


def test_sample_indices():
    g = torch.Generator().manual_seed(0)
    idx = tr.sample_indices(g, 50, 7, 512)
    assert idx.shape == (512, 7) and idx.min() >= 0 and idx.max() < 50
    srt = torch.sort(idx, dim=1).values
    assert bool((srt[:, 1:] != srt[:, :-1]).all())  # distinct in each row
    again = tr.sample_indices(torch.Generator().manual_seed(0), 50, 7, 512)
    assert torch.equal(idx, again)
    # every point is drawn: the keys are uniform over rows
    assert len(torch.unique(idx)) == 50


# ---------------------------------------------------------------------------
# one chunk given the reference's indices
# ---------------------------------------------------------------------------


def _two_view(rng, n=120, outliers=0.3, planar=False):
    X = rng.uniform(-2, 2, (n, 3)) + np.array([0, 0, 6.0])
    if planar:
        X[:, 2] = 6.0
    R = np.array([[0.98, -0.02, 0.2], [0.02, 1.0, 0.0], [-0.2, 0.0, 0.98]])
    R, _ = np.linalg.qr(R)
    Xc = X @ R.T + np.array([1.0, 0.1, 0.05])
    x1 = 600 * X[:, :2] / X[:, 2:] + 320
    x2 = 600 * Xc[:, :2] / Xc[:, 2:] + 240
    x1 += rng.normal(0, 0.5, x1.shape)
    x2 += rng.normal(0, 0.5, x2.shape)
    out = rng.choice(n, int(outliers * n), replace=False)
    x2[out] = rng.uniform(0, 640, (len(out), 2))
    return x1.astype(np.float32), x2.astype(np.float32)


def _pnp(rng, n=150, outliers=0.3):
    X = rng.uniform(-2, 2, (n, 3)) + np.array([0, 0, 6.0])
    ang = 0.3
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    Xc = X @ R.T + np.array([0.3, -0.2, 0.5])
    x = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 0.5 / 600, (n, 2))
    out = rng.choice(n, int(outliers * n), replace=False)
    x[out] = rng.uniform(-0.5, 0.5, (len(out), 2))
    return x.astype(np.float32), X.astype(np.float32)


def _track(rng, M=10, bad=2):
    X = np.array([0.5, -0.3, 8.0])
    proj, xs, centers = [], [], []
    for i in range(M):
        ang = 0.05 * i
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        t = np.array([0.6 * i - 2.5, 0.0, 0.0])
        Xc = R @ X + t
        xs.append(Xc[:2] / Xc[2] + rng.normal(0, 0.3 / 600, 2))
        proj.append(np.concatenate([R, t[:, None]], 1))
        centers.append(-R.T @ t)
    xs = np.array(xs)
    xs[rng.choice(M, bad, replace=False)] += rng.uniform(0.05, 0.1, (bad, 2))
    f = np.float32
    return (xs.astype(f), np.array(proj, f), np.full(M, 600.0**2, f),
            np.array(centers, f))


def _cases():
    """(name, reference engine, port engine, data, max_error, sign-free)."""
    rng = np.random.default_rng(0)
    angle = float(np.deg2rad(1.5))
    return {
        "fundamental": (jfm._engine, tfm._engine, _two_view(rng), 4.0, True),
        "homography": (jhm._engine, thm._engine,
                       _two_view(rng, planar=True), 4.0, False),
        "absolute_pose": (jap._engine, tap._engine, _pnp(rng), 12.0 / 600,
                          False),
        "triangulation": (
            jr.BatchedLORANSAC(
                minimal_solver=jtr._make_minimal(jnp.float32(angle)),
                residual_fn=lambda m, x, p, f, c: jtr._tri_residual(
                    m, x, p, f, c, angle),
                sample_size=2, refit_solver=jtr._refit, chunk_size=64),
            tr.BatchedLORANSAC(
                minimal_solver=ttr._make_minimal(
                    float(np.float32(angle))),
                residual_fn=ttr._tri_residual, sample_size=2,
                refit_solver=ttr._refit, chunk_size=64),
            _track(rng), 4.0, False),
    }


def _leaves(model):
    return model if isinstance(model, tuple) else (model,)


@pytest.mark.parametrize("fused", [False, True], ids=["chunk", "chunk_lo"])
@pytest.mark.parametrize("name", ["fundamental", "homography",
                                  "absolute_pose", "triangulation"])
def test_chunk_given_reference_indices(name, fused):
    ref, port, data, max_error, signed = _cases()[name]
    n = len(data[0])
    max_sq = np.float32(max_error**2)
    key = jax.random.PRNGKey(0)
    valid = jnp.ones(n, jnp.float32)
    idx = jr._sample_indices(key, n, ref.sample_size, ref.chunk_size, valid)
    run = ref._run_chunk_lo if fused else ref._run_chunk
    want = jax.jit(run)(key, max_sq, valid, *map(jnp.asarray, data))
    port_run = port.run_chunk_lo if fused else port.run_chunk
    got = port_run(torch.from_numpy(np.array(idx)), float(max_sq),
                   *map(torch.from_numpy, data))
    assert int(got[1]) == int(want[1]) > 0.5 * n
    for g, w in zip(_leaves(got[0]), _leaves(want[0])):
        g, w = g.numpy().astype(np.float64), np.asarray(w, np.float64)
        if name == "absolute_pose" and g.shape == (4,):
            g = g * np.sign(np.dot(g, w))  # q and -q: one rotation
        if signed:
            g = g * np.sign(np.sum(g * w))
        scale = max(1.0, np.abs(w).max())
        assert np.abs(g - w).max() <= 1e-4 * scale, (name, g, w)
    np.testing.assert_array_equal(got[3].numpy() <= max_sq,
                                  np.asarray(want[3]) <= max_sq)


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------


class _Line:
    """A toy estimator: a horizontal line y = c. The minimal solver reads
    one point; chunk k's hypotheses are offset by `offsets[k]`, so a test
    decides which chunk wins. The refit is the weighted mean."""

    def __init__(self, offsets, refit=True):
        self.offsets = list(offsets)
        self.calls = {"chunk": 0, "refit": 0}
        self.engine = tr.BatchedLORANSAC(
            minimal_solver=self.minimal, residual_fn=self.residual,
            sample_size=1, refit_solver=self.refit if refit else None,
            chunk_size=8)

    def minimal(self, idx, y):
        k = self.calls["chunk"]
        self.calls["chunk"] += 1
        off = self.offsets[min(k, len(self.offsets) - 1)]
        return y[idx] + off, torch.ones(idx.shape, dtype=torch.bool)

    def residual(self, c, y):
        return (c[..., None] - y) ** 2

    def refit(self, w, y):
        self.calls["refit"] += 1
        c = torch.sum(w * y) / torch.clamp(torch.sum(w), min=1.0)
        return c.reshape(1, 1), torch.ones((1, 1), dtype=torch.bool)


def _line_data(n=40, bad=8, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.normal(0, 0.05, n).astype(np.float32)
    y[:bad] = rng.uniform(5, 10, bad)
    return y


def test_stopping_rule_and_trials():
    """All-inlier data: the first check after min_num_trials stops, at the
    chunk size's multiple; a low confidence cap (max_trials) stops first."""
    y = np.zeros(40, np.float32)
    line = _Line([0.0])
    opts = tr.RANSACOptions(max_error=0.5, min_num_trials=20)
    rep = line.engine.estimate(opts, y, device="cpu")
    assert rep.success and rep.num_trials == 24 and rep.support_num_inliers == 40
    assert line.calls["chunk"] == 3 and line.calls["refit"] == 2  # fused LO
    opts = tr.RANSACOptions(max_error=0.5, min_num_trials=20,
                            max_num_trials=9)
    assert _Line([0.0]).engine.estimate(opts, y, device="cpu").num_trials == 16
    # too few points, or no hypothesis clears the sample size
    assert not _Line([0.0]).engine.estimate(
        opts, y[:0], device="cpu").success
    bad = _Line([100.0]).engine.estimate(opts, y, device="cpu")
    assert not bad.success and bad.num_trials == 16


def test_later_winner_gets_the_host_refit():
    """Chunk 1 finds nothing, so its fused LO keeps nothing; chunk 2's
    hypotheses are sample points and win; the host LO refit (the mean of
    their inliers) replaces the winner, and a second refit that is no
    better ends the loop, as in the reference."""
    y = _line_data()
    line = _Line([100.0, 0.0, 100.0])
    opts = tr.RANSACOptions(max_error=0.5, min_num_trials=16)
    rep = line.engine.estimate(opts, y, device="cpu")
    # after 16 trials 32/40 inliers need 18 (dyn_num_trials), so 3 chunks
    assert rep.success and rep.num_trials == 24
    assert line.calls["chunk"] == 3
    assert line.calls["refit"] == 2 + 2  # the fused pair, then the host's
    inl = np.abs(y) < 0.5
    assert rep.support_num_inliers == inl.sum() == 32
    np.testing.assert_array_equal(rep.inlier_mask, inl)
    assert abs(float(rep.model) - y[inl].mean()) < 1e-6


def test_no_refit_solver():
    y = _line_data()
    line = _Line([0.0], refit=False)
    rep = line.engine.estimate(tr.RANSACOptions(max_error=0.5), y,
                               device="cpu")
    assert rep.success and rep.support_num_inliers == 32
    assert line.calls["refit"] == 0


def test_estimate_is_deterministic():
    rng = np.random.default_rng(1)
    x1, x2 = _two_view(rng, n=100)
    a = tfm.estimate_fundamental_matrix(x1, x2, device="cpu")
    b = tfm.estimate_fundamental_matrix(x1, x2, device="cpu")
    np.testing.assert_array_equal(a["F"], b["F"])
    np.testing.assert_array_equal(a["inliers"], b["inliers"])
    assert a["num_trials"] == b["num_trials"] and a["num_trials"] % 512 == 0
    assert math.isclose(a["num_inliers"], 70, abs_tol=3)
