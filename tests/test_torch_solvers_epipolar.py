"""The port's solvers and epipolar functions (pycolmap_torch/ops/solvers.py,
ops/epipolar.py) against the reference's on the same float32 inputs, made
from a seed with numpy, on the CPU.

Tolerances: 1e-5 of the largest magnitude for the residual and error
functions and the linear solvers on normalized coordinates (normalization,
the homography DLT, midpoint, Umeyama); 1e-4 for the DLTs on raw
coordinates (triangulation, PnP), whose Gram matrix squares the design's
condition number in float32; points triangulated from two views under a
recovered pose must be as close to the float64 triangulation as the
reference's (within twice its error, plus 1e-5), since float32 resolves
them only to ~1e-3 where the rays meet at a small angle; solution sets (7pt, 8pt, 5pt, P3P, decompositions) matched up to
sign, each port solution within 1e-4 of one of the reference's. Where the
solvers take a null space of dimension above one (5pt: four, 7pt: two), any
orthonormal basis of it is as right as another, so the port gets the
reference's basis; with its own basis every 5-point E still satisfies
|x2ᵀ E x1| <= 1e-5 and the true E is among the solutions. The reference's
5-point solver runs once, from a module-scoped fixture of 8 samples (it is
slow outside ``jit``); its output also drives the essential estimator's
same-indices chunk.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pycolmap_tpu.estimators import essential_matrix as jem
from pycolmap_tpu.estimators import ransac as jrs
from pycolmap_tpu.estimators.ransac import BatchedLORANSAC as JaxLORANSAC
from pycolmap_tpu.ops import epipolar as jep
from pycolmap_tpu.ops import quaternion as jq
from pycolmap_tpu.ops import solvers as js
from pycolmap_torch.estimators import essential_matrix as tem
from pycolmap_torch.estimators import fundamental_matrix as tfm
from pycolmap_torch.estimators.ransac import BatchedLORANSAC
from pycolmap_torch.ops import epipolar as tep
from pycolmap_torch.ops import quaternion as tq
from pycolmap_torch.ops import solvers as ts


@pytest.fixture(autouse=True)
def _one_thread():
    """Many tiny CPU ops: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jit(fn):
    """The reference function under ``jax.jit``: eager JAX dispatches op by
    op and takes seconds where the compiled function takes a fraction."""
    return jax.jit(fn)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(a):
    return np.asarray(a, dtype=np.float64)


def _close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol} x {scale}"


def _rotation(rng, lo=0.1, hi=0.6):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = rng.uniform(lo, hi)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K


def _skew(t):
    return np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])


def two_view(rng, n, K):
    """K noise-free calibrated pairs of n points: (x1, x2 [K, n, 2], unit E,
    R, t)."""
    x1, x2, E, R, t = [], [], [], [], []
    for _ in range(K):
        Rk = _rotation(rng)
        tk = rng.normal(size=3)
        tk /= np.linalg.norm(tk)
        X = rng.uniform(-1, 1, size=(n, 3)) + np.array([0, 0, 4.0])
        Xc = X @ Rk.T + tk
        x1.append(X[:, :2] / X[:, 2:])
        x2.append(Xc[:, :2] / Xc[:, 2:])
        Ek = _skew(tk) @ Rk
        E.append(Ek / np.linalg.norm(Ek))
        R.append(Rk)
        t.append(tk)
    f = np.float32
    return (np.array(x1, f), np.array(x2, f), np.array(E), np.array(R),
            np.array(t))


def _unit(M):
    return M / np.linalg.norm(M, axis=(-2, -1), keepdims=True)


def _nearest(M, S, valid):
    """Distance of M to the nearest valid member of S, up to sign."""
    return min((min(np.abs(M - s).max(), np.abs(M + s).max())
                for s, ok in zip(S, valid) if ok), default=np.inf)


def _epipolar_residual(E, x1, x2):
    p1 = np.concatenate([x1, np.ones(x1.shape[:-1] + (1,))], -1)
    p2 = np.concatenate([x2, np.ones(x2.shape[:-1] + (1,))], -1)
    return np.abs(np.einsum("ni,ij,nj->n", p2, E, p1)).max()


# ---------------------------------------------------------------------------
# polynomial roots and the linear solvers
# ---------------------------------------------------------------------------


def test_cubic_and_quartic_roots():
    rng = np.random.default_rng(0)
    c = rng.normal(size=(5, 256)).astype(np.float32)
    c[0, :16] = 0.0  # degenerate leading coefficients: the quadratic path
    for fn, k in (("solve_cubic_real", 4), ("solve_quartic_real", 5)):
        r1, v1 = _jit(getattr(js, fn))(*map(jnp.asarray, c[:k]))
        r2, v2 = getattr(ts, fn)(*map(_t, c[:k]))
        np.testing.assert_array_equal(v2.numpy(), np.asarray(v1))
        v = np.asarray(v1)
        _close(np.where(v, r2.numpy(), 0), np.where(v, r1, 0), 1e-5, fn)


def test_normalize_points_and_dlts():
    rng = np.random.default_rng(1)
    x1, x2, _, R, t = two_view(rng, 40, 4)
    w = (rng.uniform(size=(4, 40)) > 0.2).astype(np.float32)
    xn1, T1 = _jit(js.normalize_points_2d)(jnp.asarray(x1), jnp.asarray(w))
    xn2, T2 = ts.normalize_points_2d(_t(x1), _t(w))
    _close(xn2, xn1, 1e-5, "x_norm")
    _close(T2, T1, 1e-5, "T")
    # a plane's homography: the DLT's null space is one-dimensional
    Xp = np.concatenate([rng.uniform(-1, 1, (4, 40, 2)),
                         np.full((4, 40, 1), 4.0)], -1)
    xp1 = (Xp[..., :2] / Xp[..., 2:]).astype(np.float32)
    Xc = np.einsum("kij,knj->kni", R, Xp) + t[:, None]
    xp2 = (Xc[..., :2] / Xc[..., 2:]).astype(np.float32)
    H1 = _jit(js.homography_dlt)(jnp.asarray(xp1), jnp.asarray(xp2), jnp.asarray(w))
    H2 = ts.homography_dlt(_t(xp1), _t(xp2), _t(w))
    _close(H2, H1, 1e-5, "homography_dlt")


@pytest.mark.parametrize("name", ["fundamental_8pt", "essential_8pt"])
def test_eight_point(name):
    rng = np.random.default_rng(2)
    x1, x2, E, _, _ = two_view(rng, 30, 6)
    w = (rng.uniform(size=(6, 30)) > 0.2).astype(np.float32)
    want = _np(_jit(getattr(js, name))(jnp.asarray(x1), jnp.asarray(x2),
                                 jnp.asarray(w)))
    got = getattr(ts, name)(_t(x1), _t(x2), _t(w)).numpy()
    for k in range(6):
        assert _nearest(_unit(got[k]), _unit(want[k])[None], [True]) < 1e-4
        # noise-free data: the true E (F in normalized coordinates)
        assert _nearest(_unit(got[k]), E[k][None], [True]) < 1e-3


def test_seven_point():
    """Given the reference's two null vectors the port's solutions are the
    reference's; with its own, each satisfies the seven constraints."""
    rng = np.random.default_rng(3)
    x1, x2, E, _, _ = two_view(rng, 7, 12)
    F1, v1 = js.fundamental_7pt(jnp.asarray(x1), jnp.asarray(x2))
    w = jnp.ones(x1.shape[:-1])
    x1n, T1 = js.normalize_points_2d(jnp.asarray(x1), w)
    x2n, T2 = js.normalize_points_2d(jnp.asarray(x2), w)
    A = js._epipolar_design(x1n, x2n, w)
    _, V = jnp.linalg.eigh(jnp.einsum("...ni,...nj->...ij", A, A))
    F2, v2 = ts.fundamental_7pt_from_null(
        _t(V[..., :, 0]), _t(V[..., :, 1]), _t(T1), _t(T2))
    np.testing.assert_array_equal(v2.numpy(), np.asarray(v1))
    F1, v1, F2 = _np(F1), np.asarray(v1), F2.numpy()
    for k in range(12):
        for i in np.flatnonzero(v1[k]):
            assert _nearest(F2[k, i], F1[k], v1[k]) < 1e-4, (k, i)
    F3, v3 = ts.fundamental_7pt(_t(x1), _t(x2))
    F3, v3 = F3.numpy(), v3.numpy()
    for k in range(12):
        for i in np.flatnonzero(v3[k]):
            assert _epipolar_residual(F3[k, i], x1[k], x2[k]) < 1e-5
        assert _nearest(E[k], _unit(F3[k]), v3[k]) < 1e-2


def _design(a, b):
    one = np.ones(a.shape[:-1], np.float32)
    return np.stack([b[..., 0] * a[..., 0], b[..., 0] * a[..., 1], b[..., 0],
                     b[..., 1] * a[..., 0], b[..., 1] * a[..., 1], b[..., 1],
                     a[..., 0], a[..., 1], one], -1).astype(np.float32)


@pytest.fixture(scope="module")
def five_point():
    """One noise-free calibrated pair of 60 points, 6 of them outliers; the
    reference engine's first chunk of 8 samples (its key 0), the
    reference's null space basis of each sample and the reference's
    solutions (its one 5-point call)."""
    rng = np.random.default_rng(4)
    x1, x2, E, _, _ = two_view(rng, 60, 1)
    x1, x2, E = x1[0], x2[0].copy(), E[0]
    x2[:6] = rng.uniform(-0.3, 0.3, (6, 2))
    key = jax.random.PRNGKey(0)
    idx = np.asarray(jrs._sample_indices(key, 60, 5, 8, jnp.ones(60)))
    _, _, Vt = jnp.linalg.svd(jnp.asarray(_design(x1[idx], x2[idx])),
                              full_matrices=True)
    Ej, vj = js.essential_5pt(jnp.asarray(x1[idx]), jnp.asarray(x2[idx]))
    return dict(x1=x1, x2=x2, E=E, idx=idx, key=key,
                basis=np.asarray(Vt)[:, 5:9], Ej=_np(Ej), vj=np.asarray(vj))


def test_five_point_same_basis(five_point):
    """In the reference's basis, on the samples that basis resolves to
    float32 precision (every reference solution on the essential manifold,
    |det E| <= 1e-6), the port's solutions are the reference's, within
    1e-4; on every sample each satisfies the five constraints."""
    f = five_point
    E, v = ts.essential_5pt_from_basis(_t(f["basis"]))
    E, v = E.numpy(), v.numpy()
    resolved = 0
    for k, s in enumerate(f["idx"]):
        for i in np.flatnonzero(v[k]):
            assert _epipolar_residual(E[k, i], f["x1"][s], f["x2"][s]) <= 1e-5
        dets = [abs(np.linalg.det(e)) for e in f["Ej"][k][f["vj"][k]]]
        if max(dets) > 1e-6:
            continue
        resolved += 1
        np.testing.assert_array_equal(v[k], f["vj"][k])
        for i in np.flatnonzero(v[k]):
            assert _nearest(E[k, i], f["Ej"][k], f["vj"][k]) < 1e-4, (k, i)
    assert resolved >= 5


def test_five_point_own_basis(five_point):
    """The port's own basis: every valid E satisfies the constraints, and
    in each sample of inliers only the true E is a solution (within 1e-2,
    the reference test's hit rule), as it is among the reference's."""
    f = five_point
    E, v = ts.essential_5pt(_t(f["x1"][f["idx"]]), _t(f["x2"][f["idx"]]))
    E, v = E.numpy(), v.numpy()
    clean = 0
    for k, s in enumerate(f["idx"]):
        for i in np.flatnonzero(v[k]):
            assert _epipolar_residual(E[k, i], f["x1"][s], f["x2"][s]) <= 1e-5
        if s.min() >= 6:
            clean += 1
            assert _nearest(f["E"], E[k], v[k]) < 1e-2
            assert _nearest(f["E"], _unit(f["Ej"][k]), f["vj"][k]) < 1e-2
    assert clean >= 3


def test_essential_chunk_same_indices(five_point):
    """One chunk of the essential estimator given the reference's drawn
    indices (its key 0): the reference engine scores the reference's
    solutions; the port engine scores its own in the reference's basis (same
    best inlier count, model within 1e-4) and in its own basis (same best
    inlier count)."""
    f = five_point
    max_sq = np.float32(1e-4)
    ref = JaxLORANSAC(
        minimal_solver=lambda i, p, q: (jnp.asarray(f["Ej"], jnp.float32),
                                        jnp.asarray(f["vj"])),
        residual_fn=jem._sampson_batched, sample_size=5, chunk_size=8)
    want = ref._run_chunk(f["key"], max_sq, jnp.ones(60, jnp.float32),
                          jnp.asarray(f["x1"]), jnp.asarray(f["x2"]))
    port = BatchedLORANSAC(
        minimal_solver=lambda i, p, q: ts.essential_5pt_from_basis(
            _t(f["basis"])),
        residual_fn=tfm._sampson_batched, sample_size=5)
    idx = torch.from_numpy(np.array(f["idx"]))
    got = port.run_chunk(idx, float(max_sq), _t(f["x1"]), _t(f["x2"]))
    assert int(got[1]) == int(want[1]) == 54
    g, w = got[0].numpy(), _np(want[0])
    _close(g * np.sign(np.sum(g * w)), w, 1e-4, "essential chunk model")
    np.testing.assert_array_equal(got[3].numpy() <= max_sq,
                                  np.asarray(want[3]) <= max_sq)
    own = tem._engine.run_chunk(idx, float(max_sq), _t(f["x1"]), _t(f["x2"]))
    assert int(own[1]) == int(want[1])


# ---------------------------------------------------------------------------
# decompositions, triangulation, absolute pose, similarity
# ---------------------------------------------------------------------------


def test_decompose_essential():
    rng = np.random.default_rng(6)
    _, _, E, _, _ = two_view(rng, 5, 8)
    R1j, R2j, tj = map(_np, _jit(js.decompose_essential)(jnp.asarray(E, jnp.float32)))
    R1, R2, t = (a.numpy() for a in ts.decompose_essential(_t(E)))
    for k in range(8):
        got = sorted([R1[k], R2[k]], key=lambda r: r[0, 0])
        want = sorted([R1j[k], R2j[k]], key=lambda r: r[0, 0])
        _close(got[0], want[0], 1e-4, "R")
        _close(got[1], want[1], 1e-4, "R")
        assert _nearest(t[k][None], tj[k][None][None], [True]) < 1e-4


def test_triangulation():
    rng = np.random.default_rng(7)
    M, N = 4, 32
    R = np.stack([_rotation(rng, 0.0, 0.2) for _ in range(M)])
    t = rng.normal(0, 0.5, (M, 3))
    proj = np.concatenate([R, t[:, :, None]], -1).astype(np.float32)
    X = rng.uniform(-1, 1, (N, 3)) + np.array([0, 0, 5.0])
    Xc = np.einsum("mij,nj->nmi", R, X) + t
    x = (Xc[..., :2] / Xc[..., 2:]).astype(np.float32)  # [N, M, 2]
    w = (rng.uniform(size=(N, M)) > 0.2).astype(np.float32)
    w[:, :2] = 1.0  # every point in at least two views
    P = np.broadcast_to(proj, (N, M, 3, 4))
    want = _jit(js.triangulate_dlt)(jnp.asarray(P), jnp.asarray(x), jnp.asarray(w))
    got = ts.triangulate_dlt(_t(P), _t(x), _t(w))
    _close(got, want, 1e-4, "triangulate_dlt")
    c = rng.normal(size=(2, N, 3)).astype(np.float32)
    d = rng.normal(size=(2, N, 3)).astype(np.float32)
    _close(ts.triangulate_midpoint(_t(c[0]), _t(d[0]), _t(c[1]), _t(d[1])),
           _jit(js.triangulate_midpoint)(*map(jnp.asarray, (c[0], d[0], c[1], d[1]))),
           1e-5, "triangulate_midpoint")


def _pnp_problem(rng, B, n, depth=6.0):
    """World points about the origin (scale 1) and cameras `depth` away:
    the linear solvers' design matrices are well conditioned."""
    X = rng.uniform(-1, 1, (B, n, 3))
    R = np.stack([_rotation(rng, 0.05, 0.5) for _ in range(B)])
    t = rng.normal(0, 0.3, (B, 3)) + np.array([0, 0, depth])
    Xc = np.einsum("bij,bnj->bni", R, X) + t[:, None]
    x = Xc[..., :2] / Xc[..., 2:]
    return x.astype(np.float32), X.astype(np.float32), R, t


def _rot(q):
    return _np(jq.quat_to_matrix(jnp.asarray(q, jnp.float32)))


def test_p3p():
    rng = np.random.default_rng(8)
    x, X, R, t = _pnp_problem(rng, 32, 3)
    qj, tj, vj = _jit(js.p3p)(jnp.asarray(x), jnp.asarray(X))
    q, tt, v = ts.p3p(_t(x), _t(X))
    np.testing.assert_array_equal(v.numpy(), np.asarray(vj))
    vj = np.asarray(vj)
    Rj, R2 = _rot(qj), _rot(q.numpy())
    tj, tt = _np(tj), tt.numpy()
    found = 0
    for b in range(32):
        ok = np.flatnonzero(vj[b])
        if not len(ok):
            continue
        # the solution nearest the truth, in each: the one RANSAC keeps
        # (the other roots of the quartic may lie close together); compared
        # where the reference resolves it to 1e-5 (a well-conditioned
        # triangle: near a double root both lose digits)
        k = ok[np.argmin([np.abs(Rj[b, i] - R[b]).max() for i in ok])]
        i = ok[np.argmin([np.abs(R2[b, i] - R[b]).max() for i in ok])]
        if np.abs(Rj[b, k] - R[b]).max() > 1e-5:
            continue
        _close(R2[b, i], Rj[b, k], 1e-4, "P3P R")
        _close(tt[b, i], tj[b, k], 1e-4, "P3P t")
        found += 1
    assert found >= 24


def test_pnp_dlt_epnp_umeyama():
    rng = np.random.default_rng(9)
    x, X, R, t = _pnp_problem(rng, 4, 24, depth=4.0)
    w = (rng.uniform(size=(4, 24)) > 0.1).astype(np.float32)
    for fn, tol in (("pnp_dlt", 1e-4), ("epnp", 1e-4)):
        qj, tj = _jit(getattr(js, fn))(jnp.asarray(x), jnp.asarray(X), jnp.asarray(w))
        q, tt = getattr(ts, fn)(_t(x), _t(X), _t(w))
        _close(_rot(q.numpy()), _rot(qj), tol, fn)
        _close(tt, tj, tol, fn)
        _close(_rot(q.numpy()), R, 1e-3, fn)
    src = X
    dst = 1.7 * np.einsum("bij,bnj->bni", R, X) + t[:, None]
    sj, qj, tj = _jit(js.umeyama)(jnp.asarray(src), jnp.asarray(dst, jnp.float32),
                            jnp.asarray(w))
    s, q, tt = ts.umeyama(_t(src), _t(dst), _t(w))
    _close(s, sj, 1e-5, "umeyama scale")
    _close(_rot(q.numpy()), _rot(qj), 1e-5, "umeyama R")
    _close(tt, tj, 1e-5, "umeyama t")


# ---------------------------------------------------------------------------
# ops/epipolar.py
# ---------------------------------------------------------------------------


def test_residuals():
    rng = np.random.default_rng(10)
    x1, x2, E, R, t = two_view(rng, 64, 3)
    x2 = x2 + rng.normal(0, 0.01, x2.shape).astype(np.float32)
    E32 = E.astype(np.float32)
    for fn in ("sampson_error", "epipolar_line_error",
               "homography_transfer_error"):
        M = E32 if fn != "homography_transfer_error" else R.astype(np.float32)
        _close(getattr(tep, fn)(_t(M), _t(x1), _t(x2)),
               _jit(getattr(jep, fn))(jnp.asarray(M), jnp.asarray(x1),
                                jnp.asarray(x2)), 1e-5, fn)
    q = _np(jq.matrix_to_quat(jnp.asarray(R, jnp.float32)))
    X = rng.uniform(-1, 1, (3, 64, 3)).astype(np.float32) + [0, 0, 4]
    X[:, :4, 2] = -1.0  # behind the camera
    _close(tep.reprojection_error_normalized(_t(q), _t(t), _t(x1), _t(X)),
           _jit(jep.reprojection_error_normalized)(
               jnp.asarray(q, jnp.float32), jnp.asarray(t, jnp.float32),
               jnp.asarray(x1), jnp.asarray(X)), 1e-5, "reprojection")


def _dlt64(R, t, x1, x2):
    """Two-view DLT points [K, N, 3] in float64 under cam2_from_cam1 (R, t)."""
    P1 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1)
    out = np.zeros(x1.shape[:-1] + (3,))
    for k in range(x1.shape[0]):
        P2 = np.concatenate([R[k], t[k][:, None]], 1)
        for n in range(x1.shape[1]):
            A = np.concatenate(
                [[x[n, 0] * P[2] - P[0], x[n, 1] * P[2] - P[1]]
                 for P, x in ((P1, x1[k]), (P2, x2[k]))])
            h = np.linalg.svd(A)[2][-1]
            out[k, n] = h[:3] / h[3]
    return out


def _as_accurate(got, want, exact, what):
    """got is no further from exact than twice want's distance, + 1e-5."""
    err_got = np.abs(_np(got) - exact).max()
    err_want = np.abs(_np(want) - exact).max()
    scale = max(1.0, float(np.abs(exact).max()))
    assert err_got <= 2 * err_want + 1e-5 * scale, (what, err_got, err_want)


def test_pose_from_essential():
    rng = np.random.default_rng(11)
    x1, x2, E, R, t = two_view(rng, 80, 3)
    mask = rng.uniform(size=(3, 80)) > 0.1
    qj, tj, Xj, fj = _jit(jep.pose_from_essential)(
        jnp.asarray(E, jnp.float32), jnp.asarray(x1), jnp.asarray(x2),
        jnp.asarray(mask))
    q, tt, X, f = tep.pose_from_essential(_t(E), _t(x1), _t(x2),
                                          torch.from_numpy(mask))
    np.testing.assert_array_equal(f.numpy(), np.asarray(fj))
    _close(_rot(q.numpy()), _rot(qj), 1e-4, "R")
    _close(_rot(q.numpy()), R, 1e-4, "R vs truth")
    _close(tt, tj, 1e-4, "t")
    exact = _dlt64(_rot(qj), _np(tj), _np(x1), _np(x2))
    _as_accurate(X, Xj, exact, "X")
    Xc, front = tep.triangulate_and_count_cheirality(q, tt, _t(x1), _t(x2))
    Xcj, frontj = _jit(jep.triangulate_and_count_cheirality)(
        qj, tj, jnp.asarray(x1), jnp.asarray(x2))
    np.testing.assert_array_equal(front.numpy(), np.asarray(frontj))
    _as_accurate(Xc, Xcj, exact, "triangulated")


def test_pose_from_homography():
    rng = np.random.default_rng(12)
    K = 3
    R = np.stack([_rotation(rng, 0.05, 0.3) for _ in range(K)])
    t = rng.normal(0, 1.0, (K, 3))
    X = np.concatenate([rng.uniform(-1, 1, (K, 50, 2)),
                        np.full((K, 50, 1), 4.0)], -1)
    Xc = np.einsum("kij,knj->kni", R, X) + t[:, None]
    x1 = (X[..., :2] / X[..., 2:]).astype(np.float32)
    x2 = (Xc[..., :2] / Xc[..., 2:]).astype(np.float32)
    n = np.array([0, 0, 1.0])
    H = (R + np.einsum("ki,j->kij", t, n) / 4.0).astype(np.float32)
    Rj, tj, nj = map(_np, _jit(jep.decompose_homography)(jnp.asarray(H)))
    Rc, tc, nc = (a.numpy() for a in tep.decompose_homography(_t(H)))
    for k in range(K):
        for c in range(4):
            d = min(max(np.abs(Rc[k, c] - Rj[k, e]).max(),
                        np.abs(tc[k, c] - tj[k, e]).max(),
                        np.abs(nc[k, c] - nj[k, e]).max()) for e in range(4))
            assert d < 1e-4, (k, c, d)
    out_j = _jit(jep.pose_from_homography)(jnp.asarray(H), jnp.asarray(x1),
                                     jnp.asarray(x2))
    out = tep.pose_from_homography(_t(H), _t(x1), _t(x2))
    # a plane's homography has two physical decompositions, so the pose is
    # held to the reference's choice, not to the truth
    np.testing.assert_array_equal(out[4].numpy(), np.asarray(out_j[4]))
    _close(_rot(out[0].numpy()), _rot(out_j[0]), 1e-4, "R")
    for a, b, what in zip(out[1:3], out_j[1:3], ("t", "n")):
        _close(a, b, 1e-4, what)
    exact = _dlt64(_rot(out_j[0]), _np(out_j[1]), _np(x1), _np(x2))
    _as_accurate(out[3], out_j[3], exact, "X")


def test_quaternion_additions():
    rng = np.random.default_rng(13)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    _close(tq.quat_to_matrix(_t(q)), jq.quat_to_matrix(jnp.asarray(q)), 1e-6,
           "quat_to_matrix")
    _close(tq.quat_conj(_t(q)), jq.quat_conj(jnp.asarray(q)), 0, "quat_conj")


def test_linalg_guards_return_nan():
    """Non-finite input: NaN out, as XLA gives, where torch.linalg raises."""
    A = torch.full((2, 3, 3), float("nan"))
    A[1] = torch.eye(3)
    w, v = ts._eigh(A)
    U, S, Vt = ts._svd(A)
    assert torch.isnan(w[0]).all() and torch.isnan(S[0]).all()
    assert torch.isfinite(w[1]).all() and torch.isfinite(U[1]).all()
    x = torch.zeros(1, 5, 2)  # a degenerate sample: no valid solution
    E, valid = ts.essential_5pt(x, x)
    assert not valid.any() and torch.isfinite(E).all()
