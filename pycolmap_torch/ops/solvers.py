"""Batched minimal and linear solvers: the hypothesis generators of RANSAC.

Port of ``pycolmap_tpu/ops/solvers.py``. Every solver maps a batch of sample
sets (leading dimensions) to a batch of hypotheses of fixed shape, in
float32 on the device of its inputs. Image points are in normalized camera
coordinates unless noted; an invalid solution comes back as identity / zero
with a validity mask, never as NaN.

Differences from the reference that change no result beyond rounding:

- ``torch.linalg.eigh`` / ``svd`` raise on non-finite input where XLA
  returns NaN. :func:`_eigh` and :func:`_svd` factor a zero matrix in place
  of a non-finite one and return NaN for it, as the reference does.
  ``torch.linalg.solve`` raises on a singular matrix; ``solve_ex`` returns
  inf / NaN as XLA does, and does not synchronise the card.
- Polynomial products are contractions with constant 0/1 tensors (one
  ``einsum`` each) instead of per-coefficient sums; ``jnp.convolve`` has no
  batched torch counterpart.
- The loops of the reference over P3P roots and EPnP's three beta
  initialisations run as one batched call each.

On CUDA, ``eigh`` and ``svd`` check their solver's status on the host, so
each call is one host synchronisation (PyTorch documents this).
"""

from __future__ import annotations

import math

import torch

from pycolmap_torch.ops import quaternion as qops


_CONSTS: dict = {}


def _const(name, like, build):
    """A constant tensor, built once per device and dtype: a host-to-device
    copy synchronises the card, so none is made per call."""
    key = (name, like.device, like.dtype)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = build().to(like.device)
    return t


def _nan(like):
    return torch.full((), float("nan"), dtype=like.dtype, device=like.device)


def _eigh(A):
    """``eigh`` of the symmetrised A [..., n, n] (as ``jnp.linalg.eigh``);
    NaN for a matrix with non-finite entries."""
    ok = torch.isfinite(A).flatten(-2).all(-1)
    A = torch.where(ok[..., None, None], 0.5 * (A + A.mT),
                    torch.zeros((), dtype=A.dtype, device=A.device))
    w, v = torch.linalg.eigh(A)
    return (torch.where(ok[..., None], w, _nan(w)),
            torch.where(ok[..., None, None], v, _nan(v)))


def _svd(A, full_matrices=True):
    """``svd`` of A [..., m, n]; NaN for a matrix with non-finite entries."""
    ok = torch.isfinite(A).flatten(-2).all(-1)
    A = torch.where(ok[..., None, None], A,
                    torch.zeros((), dtype=A.dtype, device=A.device))
    U, S, Vh = torch.linalg.svd(A, full_matrices=full_matrices)
    return (torch.where(ok[..., None, None], U, _nan(U)),
            torch.where(ok[..., None], S, _nan(S)),
            torch.where(ok[..., None, None], Vh, _nan(Vh)))


def _solve(A, B):
    """A^-1 B without raising or synchronising on a singular A."""
    return torch.linalg.solve_ex(A, B).result


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _safe(x, eps, value=None):
    """x, with |x| < eps replaced by `value` (default eps)."""
    return torch.where(torch.abs(x) < eps,
                       torch.full_like(x, eps if value is None else value), x)


# ---------------------------------------------------------------------------
# closed-form polynomial roots (batched)
# ---------------------------------------------------------------------------


def solve_cubic_real(a, b, c, d):
    """Real roots of a x^3 + b x^2 + c x + d = 0 (batched scalars).

    Returns (roots [..., 3], valid [..., 3]); always at least one real root
    when a != 0 (falls back to quadratic/linear when a ~ 0).
    """
    eps = 1e-12
    a_safe = _safe(a, eps, 1.0)
    p = (3 * a_safe * c - b * b) / (3 * a_safe * a_safe)
    q = (2 * b**3 - 9 * a_safe * b * c + 27 * a_safe**2 * d) / (27 * a_safe**3)
    shift = -b / (3 * a_safe)
    disc = (q / 2) ** 2 + (p / 3) ** 3

    # one real root (disc > 0): Cardano
    sqrt_disc = torch.sqrt(torch.clamp(disc, min=0.0))
    t_single = _cbrt(-q / 2 + sqrt_disc) + _cbrt(-q / 2 - sqrt_disc)

    # three real roots (disc <= 0): trigonometric form
    p_neg = torch.clamp(p, max=-eps)
    m = 2 * torch.sqrt(-p_neg / 3)
    theta = torch.arccos(torch.clamp(3 * q / (p_neg * m), -1.0, 1.0)) / 3
    t0 = m * torch.cos(theta)
    t1 = m * torch.cos(theta - 2 * math.pi / 3)
    t2 = m * torch.cos(theta - 4 * math.pi / 3)

    three = disc <= 0
    roots = torch.stack(
        [torch.where(three, t, t_single) + shift for t in (t0, t1, t2)], dim=-1)
    valid = torch.stack([torch.ones_like(three), three, three], dim=-1)
    # two Newton polish steps recover float32 accuracy lost in Cardano
    an, bn, cn, dn = (v[..., None] for v in (a, b, c, d))
    for _ in range(2):
        pv = ((an * roots + bn) * roots + cn) * roots + dn
        dv = (3 * an * roots + 2 * bn) * roots + cn
        roots = roots - pv / _safe(dv, eps)

    # degenerate cubic -> quadratic b x^2 + c x + d
    is_quad = (torch.abs(a) < eps)[..., None]
    b_safe = _safe(b, eps, 1.0)
    qdisc = c * c - 4 * b * d
    qs = torch.sqrt(torch.clamp(qdisc, min=0.0))
    q0 = (-c + qs) / (2 * b_safe)
    q1 = (-c - qs) / (2 * b_safe)
    quad_roots = torch.stack([q0, q1, torch.zeros_like(q0)], dim=-1)
    quad_valid = torch.stack(
        [qdisc >= 0, qdisc >= 0, torch.zeros_like(qdisc, dtype=torch.bool)],
        dim=-1)
    return (torch.where(is_quad, quad_roots, roots),
            torch.where(is_quad, quad_valid, valid))


def solve_quartic_real(a, b, c, d, e):
    """Real roots of a x^4 + b x^3 + c x^2 + d x + e = 0 (batched).

    Ferrari's method via the resolvent cubic. Returns (roots [..., 4],
    valid [..., 4]).
    """
    eps = 1e-12
    a_safe = _safe(a, eps, 1.0)
    # depressed quartic y^4 + p y^2 + q y + r, x = y - b/(4a)
    b_, c_, d_, e_ = b / a_safe, c / a_safe, d / a_safe, e / a_safe
    p = c_ - 3 * b_ * b_ / 8
    q = d_ - b_ * c_ / 2 + b_**3 / 8
    r = e_ - b_ * d_ / 4 + b_ * b_ * c_ / 16 - 3 * b_**4 / 256
    shift = -b_ / 4

    # resolvent cubic: z^3 - p z^2 - 4 r z + (4 p r - q^2) = 0
    zr, zv = solve_cubic_real(torch.ones_like(p), -p, -4 * r, 4 * p * r - q * q)
    # pick the real root maximizing z - p (so sqrt arg is largest / stable)
    score = torch.where(zv, zr - p[..., None],
                        torch.full_like(zr, -math.inf))
    z = torch.gather(zr, -1, torch.argmax(score, dim=-1, keepdim=True))[..., 0]

    u = torch.sqrt(torch.clamp(z - p, min=0.0))
    u_safe = torch.where(u < eps, torch.ones_like(u), u)
    # factor into two quadratics: y^2 ± u y + (z/2 ∓ q/(2u))
    w1 = z / 2 - q / (2 * u_safe)
    w2 = z / 2 + q / (2 * u_safe)
    d1 = u * u - 4 * w1
    d2 = u * u - 4 * w2
    s1 = torch.sqrt(torch.clamp(d1, min=0.0))
    s2 = torch.sqrt(torch.clamp(d2, min=0.0))
    roots = torch.stack(
        [(-u + s1) / 2, (-u - s1) / 2, (u + s2) / 2, (u - s2) / 2], dim=-1
    ) + shift[..., None]
    valid = torch.stack([d1 >= 0, d1 >= 0, d2 >= 0, d2 >= 0], dim=-1)
    # u ~ 0 degenerate (biquadratic): y^2 = (-p ± sqrt(p^2-4r))/2
    bi = (u < eps)[..., None]
    bdisc = p * p - 4 * r
    bs = torch.sqrt(torch.clamp(bdisc, min=0.0))
    t_pos = (-p + bs) / 2
    t_neg = (-p - bs) / 2
    by0 = torch.sqrt(torch.clamp(t_pos, min=0.0))
    by2 = torch.sqrt(torch.clamp(t_neg, min=0.0))
    b_roots = torch.stack([by0, -by0, by2, -by2], dim=-1) + shift[..., None]
    b_valid = torch.stack(
        [(bdisc >= 0) & (t_pos >= 0)] * 2 + [(bdisc >= 0) & (t_neg >= 0)] * 2,
        dim=-1)
    roots = torch.where(bi, b_roots, roots)
    valid = torch.where(bi, b_valid, valid)
    # Newton polish for float32 accuracy
    an, bn, cn, dn, en = (x[..., None] for x in (a, b, c, d, e))
    for _ in range(2):
        pv = (((an * roots + bn) * roots + cn) * roots + dn) * roots + en
        dv = ((4 * an * roots + 3 * bn) * roots + 2 * cn) * roots + dn
        roots = roots - pv / _safe(dv, eps)
    return roots, valid


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def smallest_eigvec(A):
    """Eigenvector of the smallest eigenvalue of symmetric A [..., n, n]."""
    _, v = _eigh(A)
    return v[..., :, 0]


def _ones_weights(x):
    return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)


def normalize_points_2d(x, w=None):
    """Hartley normalization: similarity T s.t. centroid 0, RMS dist sqrt(2).

    x: [..., N, 2]; w: optional [..., N] weights. Returns (x_norm, T [...,3,3]).
    """
    if w is None:
        w = _ones_weights(x)
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
    centroid = torch.sum(x * w[..., None], dim=-2) / wsum
    diff = x - centroid[..., None, :]
    rms = torch.sqrt(torch.clamp(
        torch.sum(torch.sum(diff * diff, dim=-1) * w, dim=-1) / wsum[..., 0],
        min=1e-12))
    scale = math.sqrt(2.0) / rms
    x_norm = diff * scale[..., None, None]
    zeros = torch.zeros_like(scale)
    ones = torch.ones_like(scale)
    T = torch.stack(
        [
            scale, zeros, -scale * centroid[..., 0],
            zeros, scale, -scale * centroid[..., 1],
            zeros, zeros, ones,
        ],
        dim=-1,
    ).reshape(x.shape[:-2] + (3, 3))
    return x_norm, T


def _gram(A):
    return torch.einsum("...ni,...nj->...ij", A, A)


# ---------------------------------------------------------------------------
# homography: n-point weighted DLT (n >= 4)
# ---------------------------------------------------------------------------


def homography_dlt(x1, x2, w=None):
    """H such that x2 ~ H x1. x1, x2: [..., N, 2]; w: [..., N] weights.

    Weighted normalized DLT; works for minimal (N=4) and refit (N large,
    weights = inlier mask). Returns H [..., 3, 3] (unnormalized scale).
    """
    if w is None:
        w = _ones_weights(x1)
    x1n, T1 = normalize_points_2d(x1, w)
    x2n, T2 = normalize_points_2d(x2, w)
    u, v = x1n[..., 0], x1n[..., 1]
    up, vp = x2n[..., 0], x2n[..., 1]
    zero = torch.zeros_like(u)
    one = torch.ones_like(u)
    # rows: [-u,-v,-1, 0,0,0, u*up, v*up, up] and [0,0,0, -u,-v,-1, u*vp, v*vp, vp]
    r1 = torch.stack([-u, -v, -one, zero, zero, zero, u * up, v * up, up], dim=-1)
    r2 = torch.stack([zero, zero, zero, -u, -v, -one, u * vp, v * vp, vp], dim=-1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)
    h = smallest_eigvec(_gram(A))
    Hn = h.reshape(h.shape[:-1] + (3, 3))
    # denormalize: H = T2^-1 Hn T1
    H = _solve(T2, Hn @ T1)
    return H / _safe(H[..., 2:3, 2:3], 1e-12, 1.0)


# ---------------------------------------------------------------------------
# fundamental / essential matrices
# ---------------------------------------------------------------------------


def _epipolar_design(x1, x2, w):
    u, v = x1[..., 0], x1[..., 1]
    up, vp = x2[..., 0], x2[..., 1]
    one = torch.ones_like(u)
    A = torch.stack([up * u, up * v, up, vp * u, vp * v, vp, u, v, one], dim=-1)
    return A * w[..., None]


def fundamental_8pt(x1, x2, w=None):
    """Normalized weighted 8-point algorithm. x: [..., N, 2], N >= 8.

    Returns F [..., 3, 3] with rank-2 constraint enforced.
    """
    if w is None:
        w = _ones_weights(x1)
    x1n, T1 = normalize_points_2d(x1, w)
    x2n, T2 = normalize_points_2d(x2, w)
    f = smallest_eigvec(_gram(_epipolar_design(x1n, x2n, w)))
    Fn = f.reshape(f.shape[:-1] + (3, 3))
    # rank-2 projection
    U, S, Vt = _svd(Fn)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    Fn = U @ (S[..., :, None] * Vt)
    F = T2.mT @ Fn @ T1
    norm = torch.linalg.norm(F.reshape(F.shape[:-2] + (9,)), dim=-1, keepdim=True)
    return F / torch.clamp(norm[..., None], min=1e-12)


def essential_8pt(x1, x2, w=None):
    """8-point essential matrix: 8pt + projection onto the essential manifold
    (singular values (1, 1, 0)); the LO refit of the essential estimator."""
    U, _, Vt = _svd(fundamental_8pt(x1, x2, w))
    s = _const("s110", U, lambda: torch.tensor([1.0, 1.0, 0.0], dtype=U.dtype))
    return U @ (s[:, None] * Vt)


# ---------------------------------------------------------------------------
# Nistér 5-point essential matrix
# ---------------------------------------------------------------------------
#
# Polynomial bookkeeping for E(x, y, z) = x*B0 + y*B1 + z*B2 + B3 where
# {B0..B3} is the 4-dim null space of the 5x9 epipolar design matrix.
# Degree-1 polynomials are length-4 coefficient vectors over [x, y, z, 1];
# degree-2 over MON2; degree-3 over MON3 (20 monomials).

_MON2 = "x2 xy xz y2 yz z2 x y z 1"  # indices 0..9 (documentation)
_MON3 = (
    "x3 x2y x2z x2 xy2 xyz xy xz2 xz x y3 y2z y2 yz2 yz y z3 z2 z 1"
)  # indices 0..19

# (deg1 index, deg1 index) -> mon2 index, over [x, y, z, 1]
_O1_MAP = tuple(
    (i, j, k)
    for k, pairs in enumerate((
        ((0, 0),), ((0, 1), (1, 0)), ((0, 2), (2, 0)), ((1, 1),),
        ((1, 2), (2, 1)), ((2, 2),), ((0, 3), (3, 0)), ((1, 3), (3, 1)),
        ((2, 3), (3, 2)), ((3, 3),),
    ))
    for i, j in pairs
)

# (mon2 index, deg1 index over [x,y,z,1]) -> mon3 index
_O2_MAP = (
    (0, 0, 0), (0, 1, 1), (0, 2, 2), (0, 3, 3),
    (1, 0, 1), (1, 1, 4), (1, 2, 5), (1, 3, 6),
    (2, 0, 2), (2, 1, 5), (2, 2, 7), (2, 3, 8),
    (3, 0, 4), (3, 1, 10), (3, 2, 11), (3, 3, 12),
    (4, 0, 5), (4, 1, 11), (4, 2, 13), (4, 3, 14),
    (5, 0, 7), (5, 1, 13), (5, 2, 16), (5, 3, 17),
    (6, 0, 3), (6, 1, 6), (6, 2, 8), (6, 3, 9),
    (7, 0, 6), (7, 1, 12), (7, 2, 14), (7, 3, 15),
    (8, 0, 8), (8, 1, 14), (8, 2, 17), (8, 3, 18),
    (9, 0, 9), (9, 1, 15), (9, 2, 18), (9, 3, 19),
)

# Nistér column order: 10 "eliminated" monomials first, then
# [xz2, xz, x, yz2, yz, y, z3, z2, z, 1]
_NISTER_PERM = (0, 10, 1, 4, 2, 3, 11, 12, 5, 6, 7, 8, 9, 13, 14, 15, 16, 17, 18, 19)

# entry (row, col) of E -> flat index; the cofactors of row 0 as pairs of
# products: c_j = E[a] E[b] - E[c] E[d]
_COF = ((4, 8, 5, 7), (5, 6, 3, 8), (3, 7, 4, 6))

_GRID = 512  # tan-angle sign-change grid of the degree-10 root search
_BISECTIONS = 48


def _product_map(name, like, shape, triples):
    def build():
        m = torch.zeros(shape, dtype=like.dtype)
        for i, j, k in triples:
            m[i, j, k] = 1.0
        return m

    return _const(name, like, build)


def _conv(a, b):
    """jnp.convolve(a, b) over the last axis, batched."""
    na, nb = a.shape[-1], b.shape[-1]
    S = _product_map(("conv", na, nb), a, (na, nb, na + nb - 1),
                     [(i, j, i + j) for i in range(na) for j in range(nb)])
    return torch.einsum("...i,...j,ijk->...k", a, b, S)


def _homogeneous_eval(n, s, t):
    """sum_d n[..., d] s^(10-d) t^d: t^10 n(s/t), bounded for every angle.

    n [K, 11]; s, t [K, M] -> [K, M]."""
    def powers(v):
        ones = torch.ones_like(v)[..., None]
        return torch.cumprod(
            torch.cat([ones, v[..., None].expand(v.shape + (10,))], -1), -1)

    return torch.sum(n[:, None, :] * powers(s).flip(-1) * powers(t), dim=-1)


def _polyval_desc(coeffs, z):
    """Horner evaluation; coeffs [..., C, D+1] highest degree first, z [..., M]
    -> [..., C, M]."""
    out = coeffs[..., 0, None].expand(coeffs.shape[:-1] + z.shape[-1:])
    for k in range(1, coeffs.shape[-1]):
        out = out * z[..., None, :] + coeffs[..., k, None]
    return out


def essential_5pt(x1, x2):
    """Batched Nistér 5-point. x1, x2: [K, 5, 2] -> (E [K, 10, 3, 3], valid [K, 10]).

    The degree-10 polynomial is solved by sign-change isolation on a
    tan-angle grid and a fixed number of bisection steps, every loop batched
    over K (ref parity: estimators/essential_matrix.h:48-52).
    """
    one = torch.ones_like(x1[..., 0])
    A = torch.stack(
        [
            x2[..., 0] * x1[..., 0], x2[..., 0] * x1[..., 1], x2[..., 0],
            x2[..., 1] * x1[..., 0], x2[..., 1] * x1[..., 1], x2[..., 1],
            x1[..., 0], x1[..., 1], one,
        ],
        dim=-1,
    )  # [K, 5, 9]
    _, _, Vt = _svd(A, full_matrices=True)
    return essential_5pt_from_basis(Vt[:, 5:9])


def essential_5pt_from_basis(basis):
    """The 5-point solutions in a null space basis [K, 4, 9] of the design
    matrix, E = x*B0 + y*B1 + z*B2 + B3 (the reference's :376-502).

    Any orthonormal basis of the null space spans the same solutions, but
    how well float32 resolves them depends on the basis: solutions agree
    with the reference's to float32 rounding given the same basis."""
    K = basis.shape[0]
    dev, dt = basis.device, basis.dtype
    Ef = basis.mT  # [K, 9, 4]: E entries as degree-1 polynomials

    # --- the 10 cubic constraints -> M [K, 10, 20] -----------------------
    M1 = _product_map("o1", basis, (4, 4, 10), _O1_MAP)
    M2 = _product_map("o2", basis, (10, 4, 20), _O2_MAP)
    # every product of two entries of E: O[k, a, b] = E_a E_b (degree 2)
    O = torch.einsum("kai,kbj,ijm->kabm", Ef, Ef, M1)
    cof = _const("cof", basis, lambda: torch.tensor(_COF))
    c = O[:, cof[:, 0], cof[:, 1]] - O[:, cof[:, 2], cof[:, 3]]  # [K, 3, 10]
    det_row = torch.einsum("kji,kjb,ibm->km", c, Ef[:, 0:3], M2)
    # T = E E^T (degree 2, symmetric), rows of 2 T E - tr(T) E
    T = torch.einsum("kiajam->kijm", O.reshape(K, 3, 3, 3, 3, 10))
    tr = torch.einsum("kiim->km", T)
    Ep = Ef.reshape(K, 3, 3, 4)
    rows = (torch.einsum("kilp,kljq,pqm->kijm", 2.0 * T, Ep, M2)
            - torch.einsum("kp,kijq,pqm->kijm", tr, Ep, M2))
    M = torch.cat([det_row[:, None], rows.reshape(K, 9, 20)], dim=1)
    M = M[:, :, _const("perm", basis, lambda: torch.tensor(_NISTER_PERM))]

    # --- Gauss-Jordan: R = M_left^-1 M_right -----------------------------
    R = _solve(M[:, :, :10], M[:, :, 10:])  # [K, 10, 10]
    # last-10 monomial order: [xz2, xz, x, yz2, yz, y, z3, z2, z, 1]; the
    # rows <u> - z <v> for (u, v) = (e, f), (g, h), (i, j)
    U, V = R[:, 4::2], R[:, 5::2]  # [K, 3, 10]
    p = torch.cat([-V[..., 0:1], U[..., 0:2] - V[..., 1:3], U[..., 2:3]], -1)
    q = torch.cat([-V[..., 3:4], U[..., 3:5] - V[..., 4:6], U[..., 5:6]], -1)
    r = torch.cat([-V[..., 6:7], U[..., 6:9] - V[..., 7:10], U[..., 9:10]], -1)
    kp, lp, mp = p.unbind(1)
    kq, lq, mq = q.unbind(1)
    kr, lr, mr = r.unbind(1)

    # det of the 3x3 polynomial matrix B = [[kp,kq,kr],[lp,lq,lr],[mp,mq,mr]]
    qr_lm = _conv(lq, mr) - _conv(lr, mq)  # deg 7 [8]
    pr_lm = _conv(lp, mr) - _conv(lr, mp)  # deg 7 [8]
    pq_lm = _conv(lp, mq) - _conv(lq, mp)  # deg 6 [7]
    n = _conv(kp, qr_lm) - _conv(kq, pr_lm) + _conv(kr, pq_lm)  # z^10..1
    n = n / torch.clamp(torch.amax(torch.abs(n), dim=-1, keepdim=True),
                        min=1e-20)

    # --- real roots: tan-angle grid + bisection ---------------------------
    G = _GRID
    theta = torch.linspace(-math.pi / 2 + 1e-4, math.pi / 2 - 1e-4, G,
                           dtype=dt, device=dev)
    qg = _homogeneous_eval(n, torch.sin(theta).expand(K, G),
                           torch.cos(theta).expand(K, G))
    change = torch.sign(qg[:, :-1]) * torch.sign(qg[:, 1:]) < 0  # [K, G-1]
    pos = torch.where(change, torch.arange(G - 1, device=dev),
                      torch.full((), 2 * G, device=dev))
    take = torch.sort(pos, dim=-1).values[:, :10]
    valid = take < G
    take_safe = torch.where(valid, take, torch.zeros_like(take))
    lo = theta[take_safe]
    hi = theta[take_safe + 1]
    qlo = _homogeneous_eval(n, torch.sin(lo), torch.cos(lo))
    for _ in range(_BISECTIONS):
        mid = 0.5 * (lo + hi)
        qm = _homogeneous_eval(n, torch.sin(mid), torch.cos(mid))
        go_right = torch.sign(qm) == torch.sign(qlo)
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid)
        qlo = torch.where(go_right, qm, qlo)
    z = torch.tan(0.5 * (lo + hi))  # [K, 10]

    # --- back-substitute x, y; assemble E ---------------------------------
    kp_z, kq_z, lp_z, lq_z = _polyval_desc(
        torch.stack([kp, kq, lp, lq], 1), z).unbind(1)
    kr_z, lr_z = _polyval_desc(torch.stack([kr, lr], 1), z).unbind(1)
    det2 = kp_z * lq_z - kq_z * lp_z
    det2_safe = _safe(det2, 1e-20)
    x = (kq_z * lr_z - kr_z * lq_z) / det2_safe
    y = (kr_z * lp_z - kp_z * lr_z) / det2_safe

    coef = torch.stack([x, y, z, torch.ones_like(z)], dim=-1)  # [K, 10, 4]
    E = torch.einsum("krc,kcab->krab", coef, basis.reshape(K, 4, 3, 3))
    norm = torch.linalg.norm(E.reshape(K, 10, 9), dim=-1)
    ok = (
        valid
        & torch.isfinite(norm)
        & (norm > 1e-12)
        & torch.isfinite(E.reshape(K, 10, 9)).all(-1)
    )
    E = E / torch.where(norm > 1e-12, norm, torch.ones_like(norm))[..., None, None]
    E = torch.where(ok[..., None, None], E, torch.eye(3, dtype=dt, device=dev))
    return E, ok


def fundamental_7pt(x1, x2):
    """7-point algorithm: up to 3 solutions. x: [..., 7, 2].

    Returns (F [..., 3, 3, 3], valid [..., 3]).
    """
    w = _ones_weights(x1)
    x1n, T1 = normalize_points_2d(x1, w)
    x2n, T2 = normalize_points_2d(x2, w)
    _, eigv = _eigh(_gram(_epipolar_design(x1n, x2n, w)))
    return fundamental_7pt_from_null(eigv[..., :, 0], eigv[..., :, 1], T1, T2)


def fundamental_7pt_from_null(f1, f2, T1, T2):
    """The 7-point solutions in a null space basis f1, f2 [..., 9] of the
    normalized design matrix, denormalized by T1, T2 [..., 3, 3] (the
    reference's :521-554). The two eigenvectors of a double zero eigenvalue
    are any orthonormal pair of that plane, so only the same pair gives the
    reference's solutions to float32 rounding."""
    F1 = f1.reshape(f1.shape[:-1] + (3, 3))
    F2 = f2.reshape(f2.shape[:-1] + (3, 3))

    # det(a F1 + (1-a) F2) = 0 -> cubic in a; p(a) = det(F2 + a D) evaluated
    # at a = 0, 1, -1, 2 (deg-3 interpolation)
    D = F1 - F2
    steps = _const("steps7", f1, lambda: torch.tensor([0.0, 1.0, -1.0, 2.0],
                                                      dtype=f1.dtype))
    p0, p1, pm1, p2 = torch.linalg.det(
        F2[..., None, :, :] + steps[:, None, None] * D[..., None, :, :]
    ).unbind(-1)
    # p(a) = c3 a^3 + c2 a^2 + c1 a + c0
    c0 = p0
    c2 = (p1 + pm1) / 2 - p0
    c3 = (p2 - 2 * p1 + p0 - 2 * c2) / 6
    c1 = p1 - c0 - c2 - c3
    roots, valid = solve_cubic_real(c3, c2, c1, c0)
    Fn = F2[..., None, :, :] + roots[..., :, None, None] * D[..., None, :, :]
    F = T2.mT[..., None, :, :] @ Fn @ T1[..., None, :, :]
    norm = torch.linalg.norm(F.reshape(F.shape[:-2] + (9,)), dim=-1,
                             keepdim=True)[..., None]
    return F / torch.clamp(norm, min=1e-12), valid


def decompose_essential(E):
    """E [..., 3, 3] -> (R1, R2, t) candidate decompositions (Hartley-Zisserman)."""
    U, _, Vt = _svd(E)
    # flip signs so U and V are proper rotations
    detU = torch.linalg.det(U)
    detV = torch.linalg.det(Vt.mT)
    U = U * torch.where(detU < 0, -1.0, 1.0)[..., None, None]
    Vt = Vt * torch.where(detV < 0, -1.0, 1.0)[..., None, None]
    W = _const("W", E, lambda: torch.tensor(
        [[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype))
    return U @ W @ Vt, U @ W.T @ Vt, U[..., :, 2]


# ---------------------------------------------------------------------------
# triangulation
# ---------------------------------------------------------------------------


def triangulate_dlt(proj, x, w=None):
    """Multi-view DLT triangulation.

    proj: [..., M, 3, 4] projection matrices (world -> normalized image plane,
    i.e. [R|t] for calibrated cameras); x: [..., M, 2] normalized points;
    w: [..., M] view weights/mask. Returns X [..., 3] (world).
    """
    if w is None:
        w = _ones_weights(x)
    r0 = x[..., 0:1] * proj[..., 2, :] - proj[..., 0, :]  # [..., M, 4]
    r1 = x[..., 1:2] * proj[..., 2, :] - proj[..., 1, :]
    A = torch.cat([r0 * w[..., None], r1 * w[..., None]], dim=-2)
    Xh = smallest_eigvec(_gram(A))
    return Xh[..., :3] / _safe(Xh[..., 3], 1e-12)[..., None]


def triangulate_midpoint(center1, dir1, center2, dir2):
    """Mid-point triangulation for two rays (world frame)."""
    # solve [d1, -d2] [s; t] = c2 - c1 in least squares
    d11 = torch.sum(dir1 * dir1, dim=-1)
    d12 = torch.sum(dir1 * dir2, dim=-1)
    d22 = torch.sum(dir2 * dir2, dim=-1)
    dc = center2 - center1
    b1 = torch.sum(dir1 * dc, dim=-1)
    b2 = torch.sum(dir2 * dc, dim=-1)
    det = _safe(d11 * d22 - d12 * d12, 1e-12)
    s = (b1 * d22 - b2 * d12) / det
    t = (b1 * d12 - b2 * d11) / det
    return 0.5 * (center1 + s[..., None] * dir1 + center2 + t[..., None] * dir2)


# ---------------------------------------------------------------------------
# absolute pose: P3P (Grunert) + DLT-PnP + EPnP
# ---------------------------------------------------------------------------


def p3p(x, X):
    """P3P (Grunert's distance formulation + quartic).

    x: [..., 3, 2] normalized image points; X: [..., 3, 3] world points.
    Returns (quat [..., 4, 4] wxyz, trans [..., 4, 3], valid [..., 4]) — up
    to 4 cam_from_world pose candidates.
    """
    rays = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
    f1, f2, f3 = rays[..., 0, :], rays[..., 1, :], rays[..., 2, :]
    P1, P2, P3 = X[..., 0, :], X[..., 1, :], X[..., 2, :]

    # inter-point distances
    a = torch.linalg.norm(P2 - P3, dim=-1)  # opposite vertex 1
    b = torch.linalg.norm(P1 - P3, dim=-1)
    c = torch.linalg.norm(P1 - P2, dim=-1)
    cos_alpha = torch.sum(f2 * f3, dim=-1)
    cos_beta = torch.sum(f1 * f3, dim=-1)
    cos_gamma = torch.sum(f1 * f2, dim=-1)

    a2, b2, c2 = a * a, b * b, c * c
    # Grunert's quartic in v = s3/s1 (coefficients per Haralick et al. 1991)
    eps = 1e-12
    b2_safe = torch.where(b2 < eps, torch.ones_like(b2), b2)
    p = (a2 - c2) / b2_safe
    q = (a2 + c2) / b2_safe

    A4 = (p - 1) ** 2 - 4 * c2 / b2_safe * cos_alpha**2
    A3 = 4 * (
        p * (1 - p) * cos_beta
        - (1 - q) * cos_alpha * cos_gamma
        + 2 * c2 / b2_safe * cos_alpha**2 * cos_beta
    )
    A2 = 2 * (
        p**2
        - 1
        + 2 * p**2 * cos_beta**2
        + 2 * (b2 - c2) / b2_safe * cos_alpha**2
        - 4 * q * cos_alpha * cos_beta * cos_gamma
        + 2 * (b2 - a2) / b2_safe * cos_gamma**2
    )
    A1 = 4 * (
        -p * (1 + p) * cos_beta
        + 2 * a2 / b2_safe * cos_gamma**2 * cos_beta
        - (1 - q) * cos_alpha * cos_gamma
    )
    A0 = (1 + p) ** 2 - 4 * a2 / b2_safe * cos_gamma**2

    v, valid = solve_quartic_real(A4, A3, A2, A1, A0)  # v = s3/s1, [..., 4]

    # every root at once: the scalars broadcast over the last axis
    ca, cb, cg = cos_alpha[..., None], cos_beta[..., None], cos_gamma[..., None]
    a2e, b2e, c2e, pe = a2[..., None], b2[..., None], c2[..., None], p[..., None]
    # s1 from the beta equation: s1^2 (1 + v^2 - 2 v cos_beta) = b^2
    denom1 = 1 + v * v - 2 * v * cb
    s1 = torch.sqrt(b2e / torch.where(denom1 < eps, torch.full_like(denom1, eps),
                                      denom1))
    # u = s2/s1 from combining the alpha and gamma equations
    u = ((-1 + pe) * v * v - 2 * pe * cb * v + 1 + pe) / _safe(
        2 * (cg - v * ca), eps)
    s2 = u * s1
    s3 = v * s1
    # Newton polish of (s1,s2,s3) on the three law-of-cosines equations —
    # recovers the accuracy float32 loses in the quartic
    eye = 1e-9 * torch.eye(3, dtype=x.dtype, device=x.device)
    for _ in range(3):
        g = torch.stack([
            s2 * s2 + s3 * s3 - 2 * s2 * s3 * ca - a2e,
            s1 * s1 + s3 * s3 - 2 * s1 * s3 * cb - b2e,
            s1 * s1 + s2 * s2 - 2 * s1 * s2 * cg - c2e,
        ], dim=-1)
        zero = torch.zeros_like(s1)
        J = torch.stack(
            [
                zero, 2 * s2 - 2 * s3 * ca, 2 * s3 - 2 * s2 * ca,
                2 * s1 - 2 * s3 * cb, zero, 2 * s3 - 2 * s1 * cb,
                2 * s1 - 2 * s2 * cg, 2 * s2 - 2 * s1 * cg, zero,
            ],
            dim=-1,
        ).reshape(s1.shape + (3, 3))
        rhs = torch.einsum("...ji,...j->...i", J, g)
        delta = _solve(J.mT @ J + eye, rhs[..., None])[..., 0]
        s1 = s1 - delta[..., 0]
        s2 = s2 - delta[..., 1]
        s3 = s3 - delta[..., 2]
    cam_pts = torch.stack(
        [s1[..., None] * f1[..., None, :], s2[..., None] * f2[..., None, :],
         s3[..., None] * f3[..., None, :]], dim=-2)  # [..., 4, 3, 3]
    pos_ok = (s1 > 0) & (s2 > 0) & (s3 > 0) & (denom1 > eps)
    quat, trans, ok = _rigid_from_3pts(X[..., None, :, :].expand(cam_pts.shape),
                                       cam_pts)
    return quat, trans, valid & pos_ok & ok


def _rigid_from_3pts(world_pts, cam_pts):
    """Absolute orientation cam_from_world from 3 corresponding points.

    Procrustes on the 3-point sets (centroid + SVD). Returns (quat, t, ok).
    """
    wc = torch.mean(world_pts, dim=-2, keepdim=True)
    cc = torch.mean(cam_pts, dim=-2, keepdim=True)
    H = torch.einsum("...ni,...nj->...ij", world_pts - wc, cam_pts - cc)
    U, S, Vt = _svd(H)
    d = torch.linalg.det(Vt.mT @ U.mT)
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = Vt.mT @ (D[..., :, None] * U.mT)
    t = cc[..., 0, :] - torch.einsum("...ij,...j->...i", R, wc[..., 0, :])
    ok = S[..., 1] > 1e-12  # non-degenerate (not collinear)
    return qops.matrix_to_quat(R), t, ok


def pnp_dlt(x, X, w=None):
    """Linear PnP for n >= 6 points (DLT on the 3x4 projection matrix).

    x: [..., N, 2] normalized points; X: [..., N, 3] world points; w weights.
    Returns (quat wxyz, trans) of cam_from_world with R orthogonalized.
    """
    if w is None:
        w = _ones_weights(x)
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    zero = torch.zeros_like(Xh)
    u = x[..., 0:1]
    v = x[..., 1:2]
    r1 = torch.cat([Xh, zero, -u * Xh], dim=-1)  # [..., N, 12]
    r2 = torch.cat([zero, Xh, -v * Xh], dim=-1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)
    pvec = smallest_eigvec(_gram(A))
    P = pvec.reshape(pvec.shape[:-1] + (3, 4))
    # sign: points should have positive depth on average
    depths = torch.einsum("...ij,...nj->...ni", P, Xh)[..., 2]
    sign = torch.sign(torch.sum(torch.sign(depths) * w, dim=-1))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    P = P * sign[..., None, None]
    # scale + orthogonalize via SVD
    U, S, Vt = _svd(P[..., :3])
    detUV = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(detUV)] * 2 + [detUV], dim=-1)
    R = U @ (D[..., :, None] * Vt)
    scale = torch.mean(S, dim=-1)
    scale = torch.where(scale < 1e-12, torch.full_like(scale, 1e-12), scale)
    return qops.matrix_to_quat(R), P[..., 3] / scale[..., None]


_EPNP_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def epnp(x, X, w=None, gn_iters: int = 5):
    """EPnP non-minimal PnP for n >= 4 points (Lepetit et al. IJCV'09; the
    reference's non-minimal absolute-pose solver, ref absolute_pose.h:148).

    x: [..., N, 2] normalized image points; X: [..., N, 3] world points;
    w: [..., N] weights. Returns (quat wxyz, trans) of cam_from_world.

    Control points from weighted PCA, 12x12 eigendecomposition, the N=1/2/3
    beta approximations each Gauss-Newton refined on the 6 control-point
    distance constraints (the three as one batch), best case chosen by
    weighted reprojection error.
    """
    if w is None:
        w = _ones_weights(x)
    eps = 1e-10
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=eps)
    wn = w / wsum  # [..., N]

    # -- control points: weighted centroid + principal directions ----------
    c0 = torch.sum(X * wn[..., None], dim=-2)  # [..., 3]
    A = X - c0[..., None, :]
    lam, V = _eigh(torch.einsum("...n,...ni,...nj->...ij", wn, A, A))
    sig = torch.sqrt(torch.clamp(lam, min=eps))
    # planar guard: floor each sigma relative to the largest so the control
    # tetrahedron keeps finite volume for (near-)coplanar scenes
    sig = torch.maximum(sig, sig[..., -1:] * 1e-3)
    ctrl_w = torch.stack(
        [c0] + [c0 + sig[..., k, None] * V[..., :, k] for k in (2, 1, 0)],
        dim=-2,
    )  # [..., 4, 3]

    # -- barycentric coordinates -------------------------------------------
    ones4 = torch.ones(ctrl_w.shape[:-2] + (1, 4), dtype=x.dtype, device=x.device)
    Cmat = torch.cat([ctrl_w.mT, ones4], dim=-2)  # columns are [c_j; 1]
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    alpha = _solve(Cmat, Xh.mT).mT  # [..., N, 4]

    # -- M^T M (never materialize M beyond per-point rows) -----------------
    u = x[..., 0:1, None]  # [..., N, 1, 1]
    v = x[..., 1:2, None]
    a = alpha[..., None]  # [..., N, 4, 1]
    zero = torch.zeros_like(a)
    # per control point j the 3 columns are alpha_j*(1,0,-u) / (0,1,-v)
    ru = torch.cat([a, zero, -a * u], dim=-1).reshape(alpha.shape[:-1] + (12,))
    rv = torch.cat([zero, a, -a * v], dim=-1).reshape(alpha.shape[:-1] + (12,))
    rows = torch.stack([ru, rv], dim=-2)  # [..., N, 2, 12]
    MtM = torch.einsum("...nri,...nrj->...ij", rows * w[..., None, None], rows)
    _, evecs = _eigh(MtM)
    V4 = evecs[..., :, :4]  # 4 smallest — [..., 12, 4]
    vctrl = V4.mT.reshape(V4.shape[:-2] + (4, 4, 3))
    # vctrl[k, j] = control point j of null-basis vector k

    ia, ib = _const("pairs", x, lambda: torch.tensor(_EPNP_PAIRS).T)
    dv = vctrl[..., ia, :] - vctrl[..., ib, :]  # [..., 4, 6, 3]
    dw = ctrl_w[..., ia, :] - ctrl_w[..., ib, :]
    rho = torch.sum(dw * dw, dim=-1)  # [..., 6]

    def ddot(j, k):
        return torch.sum(dv[..., j, :, :] * dv[..., k, :, :], dim=-1)

    d11, d12, d22 = ddot(0, 0), ddot(0, 1), ddot(1, 1)
    d13, d23, d33 = ddot(0, 2), ddot(1, 2), ddot(2, 2)

    def lstsq_sym(L, b):
        # normal-equation least squares, batched small systems
        LtL = torch.einsum("...pi,...pj->...ij", L, L)
        LtL = LtL + eps * torch.eye(LtL.shape[-1], dtype=L.dtype, device=L.device)
        Ltb = torch.einsum("...pi,...p->...i", L, b)
        return _solve(LtL, Ltb[..., None])[..., 0]

    zeros = torch.zeros_like(d11[..., 0])
    # case N=1
    b11 = torch.sum(d11 * rho, dim=-1) / torch.clamp(
        torch.sum(d11 * d11, dim=-1), min=eps)
    beta_c1 = torch.stack(
        [torch.sqrt(torch.clamp(b11, min=0.0)), zeros, zeros, zeros], dim=-1)
    # case N=2: unknowns (b11, b12, b22)
    s2 = lstsq_sym(torch.stack([d11, 2 * d12, d22], dim=-1), rho)
    b1 = torch.sqrt(torch.abs(s2[..., 0]))
    b2 = torch.sqrt(torch.abs(s2[..., 2])) * torch.sign(s2[..., 1]) * torch.where(
        s2[..., 0] < 0, -1.0, 1.0)
    beta_c2 = torch.stack([b1, b2, zeros, zeros], dim=-1)
    # case N=3: unknowns (b11, b12, b22, b13, b23, b33) — 6 eqs, 6 unknowns
    s3 = lstsq_sym(
        torch.stack([d11, 2 * d12, d22, 2 * d13, 2 * d23, d33], dim=-1), rho)
    b1 = torch.sqrt(torch.abs(s3[..., 0]))
    b2 = torch.sqrt(torch.abs(s3[..., 2])) * torch.sign(s3[..., 1])
    b3 = torch.sqrt(torch.abs(s3[..., 5])) * torch.sign(s3[..., 3])
    beta_c3 = torch.stack([b1, b2, b3, zeros], dim=-1)

    # the three cases as one batch: [..., 3 cases, 4]
    beta = torch.stack([beta_c1, beta_c2, beta_c3], dim=-2)
    dvc = dv[..., None, :, :, :]
    eye4 = 1e-8 * torch.eye(4, dtype=x.dtype, device=x.device)
    for _ in range(gn_iters):
        cc_d = torch.einsum("...k,...kpi->...pi", beta, dvc)  # [..., 3, 6, 3]
        r = torch.sum(cc_d * cc_d, dim=-1) - rho[..., None, :]
        J = 2 * torch.einsum("...pi,...kpi->...pk", cc_d, dvc)  # [..., 3, 6, 4]
        JtJ = torch.einsum("...pi,...pj->...ij", J, J) + eye4
        Jtr = torch.einsum("...pi,...p->...i", J, r)
        beta = beta - _solve(JtJ, Jtr[..., None])[..., 0]

    cc = torch.einsum("...k,...kji->...ji", beta, vctrl[..., None, :, :, :])
    pc = torch.einsum("...nj,...ji->...ni", alpha[..., None, :, :], cc)
    # cheirality: flip the null-space sign so depths are positive
    flip = torch.where(
        torch.sum(torch.sign(pc[..., 2]) * w[..., None, :], dim=-1) < 0, -1.0, 1.0)
    pc = pc * flip[..., None, None]
    Xc = X[..., None, :, :].expand(pc.shape)
    _, quat, t = umeyama(Xc, pc, w[..., None, :].expand(pc.shape[:-1]),
                         with_scale=False)

    # weighted reprojection error of each case
    p_cam = qops.quat_rotate(quat[..., None, :], Xc) + t[..., None, :]
    z = p_cam[..., 2]
    proj = p_cam[..., :2] / _safe(z, 1e-8)[..., None]
    err = torch.sum((proj - x[..., None, :, :]) ** 2, dim=-1)
    err = torch.where(z <= 1e-8, torch.full_like(err, 1e6), err)
    e = torch.sum(err * wn[..., None, :], dim=-1)  # [..., 3]

    # keep the first case unless a later one is strictly better (a NaN error
    # poisons the running minimum, as in the reference's sequential pick)
    best_q, best_t, best_e = quat[..., 0, :], t[..., 0, :], e[..., 0]
    for k in (1, 2):
        take = e[..., k] < best_e
        best_q = torch.where(take[..., None], quat[..., k, :], best_q)
        best_t = torch.where(take[..., None], t[..., k, :], best_t)
        best_e = torch.minimum(e[..., k], best_e)
    return best_q, best_t


# ---------------------------------------------------------------------------
# similarity transform (Umeyama)
# ---------------------------------------------------------------------------


def umeyama(src, dst, w=None, with_scale=True):
    """Weighted Umeyama: s, R, t minimizing |dst - (s R src + t)|².

    src, dst: [..., N, 3]; w: [..., N]. Returns (scale, quat wxyz, t).
    """
    if w is None:
        w = _ones_weights(src)
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
    mu_s = torch.sum(src * w[..., None], dim=-2) / wsum
    mu_d = torch.sum(dst * w[..., None], dim=-2) / wsum
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    cov = torch.einsum("...n,...ni,...nj->...ij", w, dc, sc) / wsum[..., :, None]
    var_s = torch.sum(torch.sum(sc * sc, dim=-1) * w, dim=-1) / wsum[..., 0]
    U, S, Vt = _svd(cov)
    d = torch.linalg.det(U) * torch.linalg.det(Vt.mT)
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = U @ (D[..., :, None] * Vt)
    if with_scale:
        scale = torch.sum(S * D, dim=-1) / torch.clamp(var_s, min=1e-12)
    else:
        scale = torch.ones_like(var_s)
    t = mu_d - scale[..., None] * torch.einsum("...ij,...j->...i", R, mu_s)
    return scale, qops.matrix_to_quat(R), t
