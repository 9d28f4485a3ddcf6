"""Meshing: Poisson surface reconstruction and Delaunay-based meshing.

Port of ``pycolmap_tpu/mvs/meshing.py`` (API parity:
pycolmap/pipeline/meshing.h — ``poisson_meshing`` :119-133 and
``sparse/dense_delaunay_meshing`` :135-165, with the reference's option
structs).

- Poisson runs on the entry point's device (default: the card): the
  oriented points are splatted into a regular grid with
  ``index_put_(accumulate=True)``, smoothed by separable box passes, and
  the Neumann problem lap(chi) = div(V) is solved with an orthonormal 3-D
  DCT-II and its inverse, built on ``torch.fft`` (PyTorch has no ``dctn``).
  The iso-surface comes from :func:`marching_tetrahedra`, which handles all
  cells crossing the level at once, in the reference's arithmetic (edge
  points in float64, the weld at 1e-5 of a cell), so the same field gives
  the same mesh file.
- The Delaunay meshers run on the host, as the reference's do, and take no
  ``device``: their work is Qhull's triangulation, scipy's point location
  of the sight-ray samples and the s-t min-cut
  (``pycolmap_torch.native.min_cut``), none of which has a PyTorch form.
  Their mesh files equal the reference's byte for byte.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from pycolmap_torch import resolve_device
from pycolmap_torch.utils import logging as _logging
from pycolmap_torch.utils.options import BaseOptions, options_dataclass


@options_dataclass
class PoissonMeshingOptions(BaseOptions):
    """Mirrors reference PoissonMeshingOptions (meshing.h:15-50)."""

    point_weight: float = 1.0
    depth: int = 13
    color: float = 32.0
    trim: float = 10.0
    num_threads: int = -1


@options_dataclass
class DelaunayMeshingOptions(BaseOptions):
    """Mirrors reference DelaunayMeshingOptions (meshing.h:52-117)."""

    max_proj_dist: float = 20.0
    max_depth_dist: float = 2.5
    visibility_sigma: float = 3.0
    distance_sigma_factor: float = 1.0
    quality_regularization: float = 1.0
    max_side_length_factor: float = 25.0
    max_side_length_percentile: float = 95.0
    num_threads: int = -1


def read_fused_ply(path):
    """Read a fused PLY with optional normals. Returns (xyz, normals, rgb)."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply"
        fmt = None
        num = 0
        props = []
        while True:
            line = f.readline().strip().decode("ascii")
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                num = int(line.split()[2])
            elif line.startswith("element"):
                pass
            elif line.startswith("property"):
                props.append(tuple(line.split()[1:]))
            elif line == "end_header":
                break
        np_types = {"float": "<f4", "double": "<f8", "uchar": "u1", "int": "<i4"}
        names = [n for _, n in props]
        dt = np.dtype([(n, np_types[t]) for t, n in props])
        if fmt == "ascii":
            rows = [f.readline().split() for _ in range(num)]
            rec = np.zeros(num, dtype=dt)
            for k, row in enumerate(rows):
                for (t, n), val in zip(props, row):
                    rec[n][k] = float(val)
        else:
            rec = np.frombuffer(f.read(dt.itemsize * num), dtype=dt)
    xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float64)
    if "nx" in names:
        normals = np.stack([rec["nx"], rec["ny"], rec["nz"]], axis=1).astype(
            np.float64
        )
    else:
        normals = None
    if "red" in names:
        rgb = np.stack([rec["red"], rec["green"], rec["blue"]], axis=1)
    else:
        rgb = None
    return xyz, normals, rgb


def write_mesh_ply(path, vertices, faces):
    with open(path, "wb") as f:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(vertices)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_index\n"
            "end_header\n"
        )
        f.write(header.encode("ascii"))
        f.write(np.asarray(vertices, dtype="<f4").tobytes())
        fr = np.empty(
            len(faces), dtype=np.dtype([("n", "u1"), ("idx", "<i4", (3,))])
        )
        fr["n"] = 3
        fr["idx"] = np.asarray(faces, dtype=np.int32)
        f.write(fr.tobytes())


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# marching tetrahedra iso-surface extraction
# ---------------------------------------------------------------------------

# 6-tetrahedra decomposition of the unit cube (vertex indices 0..7 where
# vertex v has coords (v&1, (v>>1)&1, (v>>2)&1))
_CUBE_TETS = (
    (0, 5, 1, 6), (0, 1, 3, 6), (0, 3, 2, 6),
    (0, 2, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6),
)
_CUBE_COORDS = tuple(((v & 1), (v >> 1) & 1, (v >> 2) & 1) for v in range(8))


def _weld(V):
    """The reference's weld on the device: rows of round(V * 1e5) made
    unique in lexicographic order (three stable sorts); each unique row
    takes the coordinates of its LAST occurrence in V, as numpy's
    ``out_v[inverse] = V`` leaves them. Returns (unique V, inverse)."""
    Vq = torch.round(V * 1e5).long()
    perm = torch.arange(len(V), device=V.device)
    for c in (2, 1, 0):
        perm = perm[torch.argsort(Vq[perm, c], stable=True)]
    sq = Vq[perm]
    new = torch.ones(len(V), dtype=torch.bool, device=V.device)
    new[1:] = (sq[1:] != sq[:-1]).any(dim=1)
    gid = torch.cumsum(new, 0) - 1
    inverse = torch.empty_like(gid)
    inverse[perm] = gid
    last = torch.ones_like(new)
    last[:-1] = new[1:]
    return V[perm[last]], inverse


def marching_tetrahedra(field, iso: float, origin, spacing, device=None):
    """Extract the iso-surface of a scalar grid. Returns (verts [V, 3]
    float64, faces [F, 3] int32) as numpy arrays.

    ``field`` is a tensor (the work runs on its device) or an array (on
    ``device``: None means the card). Faces come in the reference's order
    (tetrahedron, then case 1-14, then cell), so the same field and level
    give the same vertices and faces."""
    if isinstance(field, torch.Tensor):
        dev = field.device
    else:
        dev = resolve_device(device)
        field = torch.from_numpy(np.ascontiguousarray(field)).to(dev)
    # float32(field) - float32(iso), numpy's arithmetic for a float32 grid
    F = field - torch.tensor(iso, dtype=field.dtype, device=dev)
    nx, ny, nz = F.shape
    shifted = [F[dx:nx - 1 + dx, dy:ny - 1 + dy, dz:nz - 1 + dz]
               for dx, dy, dz in _CUBE_COORDS]
    all_pos = torch.ones(shifted[0].shape, dtype=torch.bool, device=dev)
    all_neg = torch.ones_like(all_pos)
    for s in shifted:
        all_pos &= s > 0
        all_neg &= s < 0
    # only process cells crossing the iso level, in row-major cell order
    cell = torch.nonzero(~(all_pos | all_neg).reshape(-1)).squeeze(1)
    if len(cell) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int32)
    cy_cz = (ny - 1) * (nz - 1)
    cell_idx = torch.stack([cell // cy_cz, (cell // (nz - 1)) % (ny - 1),
                            cell % (nz - 1)], dim=1)
    corners = torch.stack([s.reshape(-1)[cell] for s in shifted], dim=1)
    coords = torch.tensor(_CUBE_COORDS, dtype=torch.int64, device=dev)
    bits = torch.tensor([1, 2, 4, 8], dtype=torch.int64, device=dev)

    verts = []
    faces = []
    nverts = 0

    def edge_point(ci, va, vb, fa, fb):
        t = fa / (fa - fb)  # in the field's float32
        pa = ci + coords[va]
        pb = ci + coords[vb]
        return pa.double() + t.double()[:, None] * (pb - pa).double()

    for tet in _CUBE_TETS:
        f4 = corners[:, list(tet)]  # [M, 4]
        code = ((f4 < 0).long() * bits).sum(dim=1)
        # cells grouped by case, in cell order within each case
        order = torch.argsort(code, stable=True)
        counts = torch.bincount(code, minlength=16).tolist()
        starts = np.concatenate([[0], np.cumsum(counts)]).tolist()
        for case in range(1, 15):
            n = counts[case]
            if n == 0:
                continue
            sel = order[starts[case]:starts[case] + n]
            ins = [i for i in range(4) if case & (1 << i)]
            outs = [i for i in range(4) if not case & (1 << i)]
            ci = cell_idx[sel]
            fv = f4[sel]
            ar = torch.arange(n, device=dev)
            tri = torch.stack([ar, ar + n, ar + 2 * n], dim=1)
            if len(ins) == 1:
                a = ins[0]
                pts = [edge_point(ci, tet[a], tet[o], fv[:, a], fv[:, o])
                       for o in outs]
                faces.append(nverts + tri)
            elif len(ins) == 3:
                a = outs[0]
                pts = [edge_point(ci, tet[i], tet[a], fv[:, i], fv[:, a])
                       for i in ins]
                faces.append(nverts + tri)
            else:  # two in, two out -> quad
                (i0, i1), (o0, o1) = ins, outs
                pts = [edge_point(ci, tet[i], tet[o], fv[:, i], fv[:, o])
                       for i, o in ((i0, o0), (i0, o1), (i1, o0), (i1, o1))]
                faces.append(nverts + tri)
                faces.append(nverts + torch.stack(
                    [ar + n, ar + 3 * n, ar + 2 * n], dim=1))
            verts.extend(pts)
            nverts += n * len(pts)

    out_v, inverse = _weld(torch.cat(verts))
    Fc = inverse[torch.cat(faces)]
    # drop degenerate faces
    good = ((Fc[:, 0] != Fc[:, 1]) & (Fc[:, 1] != Fc[:, 2])
            & (Fc[:, 0] != Fc[:, 2]))
    Fc = Fc[good]
    sp = torch.as_tensor(np.asarray(spacing, np.float64), device=dev)
    org = torch.as_tensor(np.asarray(origin, np.float64), device=dev)
    out_v = out_v * sp[None, :] + org[None, :]
    return out_v.cpu().numpy(), Fc.to(torch.int32).cpu().numpy()


# ---------------------------------------------------------------------------
# Poisson meshing
# ---------------------------------------------------------------------------


def _percentile(x, q):
    """np.percentile(x, q, axis=0) (linear method) of a [N, C] tensor,
    with numpy's two-sided interpolation."""
    s = torch.sort(x, dim=0).values
    pos = q / 100.0 * (len(x) - 1)
    i = int(np.floor(pos))
    t = pos - i
    a, b = s[i], s[min(i + 1, len(x) - 1)]
    d = b - a
    v = b - d * (1.0 - t) if t >= 0.5 else a + d * t
    return v.cpu().numpy()


def _box3(v, dim):
    """One pass of scipy's ``uniform_filter1d(size=3, mode="nearest")``:
    the window mean in float64, rounded to the grid's float32."""
    x = v.double()
    n = x.shape[dim]
    idx = torch.arange(n, device=v.device)
    lo = x.index_select(dim, (idx - 1).clamp(min=0))
    hi = x.index_select(dim, (idx + 1).clamp(max=n - 1))
    return ((lo + x + hi) / 3.0).to(v.dtype)


def _gradient(v, h: float, dim):
    """np.gradient(v, h, axis=dim) of a float32 grid (edge_order 1):
    float32 differences divided by the float64 step, rounded to float32."""
    n = v.shape[dim]
    out = torch.empty_like(v)
    out.narrow(dim, 1, n - 2).copy_(
        ((v.narrow(dim, 2, n - 2) - v.narrow(dim, 0, n - 2)).double()
         / (2.0 * h)).float())
    out.narrow(dim, 0, 1).copy_(
        ((v.narrow(dim, 1, 1) - v.narrow(dim, 0, 1)).double() / h).float())
    out.narrow(dim, n - 1, 1).copy_(
        ((v.narrow(dim, n - 1, 1) - v.narrow(dim, n - 2, 1)).double()
         / h).float())
    return out


def _dct2(x, dim):
    """scipy.fft.dct(x, type=2, norm="ortho", axis=dim) through one complex
    FFT of the even/odd-reordered sequence (Makhoul)."""
    x = x.movedim(dim, -1)
    N = x.shape[-1]
    v = torch.cat([x[..., ::2], x[..., 1::2].flip(-1)], dim=-1)
    V = torch.fft.fft(v, dim=-1)
    theta = torch.arange(N, device=x.device, dtype=x.dtype) * (np.pi / (2 * N))
    y = 2.0 * (V.real * torch.cos(theta) + V.imag * torch.sin(theta))
    scale = torch.full((N,), np.sqrt(1.0 / (2 * N)), dtype=x.dtype,
                       device=x.device)
    scale[0] = np.sqrt(1.0 / (4 * N))  # ortho's k = 0 factor
    return (y * scale).movedim(-1, dim)


def _idct2(X, dim):
    """scipy.fft.idct(X, type=2, norm="ortho", axis=dim) (the orthonormal
    DCT-III), inverting :func:`_dct2`'s steps."""
    X = X.movedim(dim, -1)
    N = X.shape[-1]
    scale = torch.full((N,), np.sqrt(2.0 * N), dtype=X.dtype, device=X.device)
    scale[0] = np.sqrt(4.0 * N)
    y = X * scale  # the unnormalised DCT-II coefficients
    y_rev = torch.cat([torch.zeros_like(y[..., :1]), y.flip(-1)[..., :-1]],
                      dim=-1)  # y[N - k], y[N] = 0
    theta = torch.arange(N, device=X.device, dtype=X.dtype) * (np.pi / (2 * N))
    c, s = torch.cos(theta), torch.sin(theta)
    V = torch.complex(0.5 * (y * c + y_rev * s), 0.5 * (y * s - y_rev * c))
    v = torch.fft.ifft(V, dim=-1).real
    h = (N + 1) // 2
    x = torch.empty_like(v)
    x[..., ::2] = v[..., :h]
    x[..., 1::2] = v[..., h:].flip(-1)
    return x.movedim(-1, dim)


def _dilate(occ):
    """One step of scipy's ``binary_dilation`` with its default
    (6-neighbour cross) structure and border 0."""
    p = torch.nn.functional.pad(occ.to(torch.uint8)[None, None],
                                (1, 1, 1, 1, 1, 1))[0, 0].bool()
    return (occ | p[2:, 1:-1, 1:-1] | p[:-2, 1:-1, 1:-1]
            | p[1:-1, 2:, 1:-1] | p[1:-1, :-2, 1:-1]
            | p[1:-1, 1:-1, 2:] | p[1:-1, 1:-1, :-2])


def poisson_field(xyz, normals, n: int, device, timings=None):
    """The indicator function of an oriented point set on an n^3 grid:
    splat, smooth, divergence and the Neumann DCT solve, on ``device``.

    Returns dict(chi [n, n, n] float32 tensor, iso (mean chi at the
    samples), lo and spacing (numpy float64, the grid's corner and cell),
    W (the splat weights))."""
    t = time.perf_counter()
    x = torch.from_numpy(np.ascontiguousarray(xyz, np.float64)).to(device)
    lo = _percentile(x, 2)
    hi = _percentile(x, 98)
    pad = 0.1 * (hi - lo).max()
    lo -= pad
    hi += pad
    spacing = (hi - lo) / n

    # splat normals into the grid (nearest cell)
    ijk = torch.floor((x - torch.from_numpy(lo).to(device))
                      / torch.from_numpy(spacing).to(device)).long()
    inb = ((ijk >= 0) & (ijk < n)).all(dim=1)
    ijk = ijk[inb]
    nr = torch.from_numpy(np.ascontiguousarray(normals, np.float64)).to(
        device)[inb]
    nr = nr / torch.linalg.norm(nr, dim=1, keepdim=True).clamp(min=1e-9)
    lin = (ijk[:, 0] * n + ijk[:, 1]) * n + ijk[:, 2]
    W = torch.zeros(n ** 3, dtype=torch.float32, device=device)
    W.index_put_((lin,), torch.ones_like(lin, dtype=torch.float32),
                 accumulate=True)
    V = torch.zeros((3, n ** 3), dtype=torch.float32, device=device)
    for c in range(3):
        V[c].index_put_((lin,), nr[:, c].float(), accumulate=True)
    V = V.view(3, n, n, n)
    # smooth the vector field a little (3-tap box per axis, twice);
    # 'nearest' edge handling — no periodic wraparound
    for c in range(3):
        for _ in range(2):
            for ax in range(3):
                V[c] = _box3(V[c], ax)
    _sync(device)
    t_splat = time.perf_counter()

    # divergence (one-sided differences at the borders), then the spectral
    # Poisson solve under Neumann conditions (DCT-II), in float64
    div = (_gradient(V[0], float(spacing[0]), 0)
           + _gradient(V[1], float(spacing[1]), 1)
           + _gradient(V[2], float(spacing[2]), 2))
    del V
    k = np.arange(n)
    lam = 2.0 * (np.cos(np.pi * k / n) - 1.0)
    lam = torch.from_numpy(lam).to(device)
    denom = (lam[:, None, None] / spacing[0] ** 2
             + lam[None, :, None] / spacing[1] ** 2
             + lam[None, None, :] / spacing[2] ** 2)
    denom[0, 0, 0] = 1.0
    chi_hat = div.double()
    del div
    for ax in range(3):
        chi_hat = _dct2(chi_hat, ax)
    chi_hat = chi_hat / denom
    del denom
    chi_hat[0, 0, 0] = 0.0
    for ax in range(3):
        chi_hat = _idct2(chi_hat, ax)
    chi = chi_hat.float()
    del chi_hat
    _sync(device)
    t_solve = time.perf_counter()

    # iso level = mean chi at the input samples
    iso = float(chi.reshape(-1)[lin].double().mean())
    t_iso = time.perf_counter()
    if timings is not None:
        timings.update(splat_smooth=t_splat - t, solve=t_solve - t_splat,
                       iso=t_iso - t_solve)
    return dict(chi=chi, iso=iso, lo=lo, spacing=spacing, W=W.view(n, n, n))


def poisson_meshing(input_path, output_path,
                    options: PoissonMeshingOptions = None, device=None,
                    timings=None):
    """Oriented point cloud (fused PLY) -> triangle mesh PLY, on ``device``
    (default: the card). ``timings`` (a dict) gets seconds per stage: read,
    splat_smooth, solve, iso, marching_tetrahedra, trim, write."""
    if options is None:
        options = PoissonMeshingOptions()
    device = resolve_device(device)
    log = _logging.get_logger()
    stages = {}
    t = time.perf_counter()
    xyz, normals, _ = read_fused_ply(input_path)
    stages["read"] = time.perf_counter() - t
    if len(xyz) < 100:
        write_mesh_ply(output_path, np.zeros((0, 3)), np.zeros((0, 3), int))
        return False
    if normals is None or not np.any(np.linalg.norm(normals, axis=1) > 1e-6):
        raise ValueError("poisson_meshing requires oriented normals in the PLY")

    n = min(1 << min(options.depth, 8), 256)
    f = poisson_field(xyz, normals, n, device, timings=stages)
    lo, spacing = f["lo"], f["spacing"]
    t = time.perf_counter()
    verts, faces = marching_tetrahedra(f["chi"], f["iso"], lo + 0.5 * spacing,
                                       spacing)
    t_mt = time.perf_counter()
    stages["marching_tetrahedra"] = t_mt - t

    # trim: drop triangles far from any input point (weight grid empty)
    if options.trim > 0 and len(faces):
        occ = _dilate(_dilate(f["W"] > 0))
        v = torch.from_numpy(verts).to(device)
        fc = torch.from_numpy(faces).to(device).long()
        centers = v[fc].mean(dim=1)
        cijk = torch.floor((centers - torch.from_numpy(lo).to(device))
                           / torch.from_numpy(spacing).to(device)).long()
        cijk = cijk.clamp(0, n - 1)
        keep = occ[cijk[:, 0], cijk[:, 1], cijk[:, 2]]
        faces = faces[keep.cpu().numpy()]
    t_trim = time.perf_counter()
    stages["trim"] = t_trim - t_mt

    write_mesh_ply(output_path, verts, faces)
    stages["write"] = time.perf_counter() - t_trim
    if timings is not None:
        timings.update(stages)
    log.info(
        f"poisson_meshing: {len(verts)} vertices, {len(faces)} faces -> {output_path}"
    )
    return len(faces) > 0


# ---------------------------------------------------------------------------
# Delaunay meshing (host: Qhull, point location and the native min-cut)
# ---------------------------------------------------------------------------


def _delaunay_mesh_points(xyz, side_len_factor=5.0):
    from scipy.spatial import Delaunay

    tri = Delaunay(xyz)
    tets = tri.simplices
    # alpha-ish filter: drop tets with long edges
    edges = np.concatenate(
        [tets[:, [a, b]] for a, b in
         ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))]
    )
    lens = np.linalg.norm(xyz[edges[:, 0]] - xyz[edges[:, 1]], axis=1)
    med = np.median(lens)
    max_edge = side_len_factor * med
    tet_edges = lens.reshape(6, -1).T
    good = (tet_edges < max_edge).all(axis=1)
    tets = tets[good]
    # surface = faces appearing exactly once
    faces = np.concatenate(
        [tets[:, [0, 1, 2]], tets[:, [0, 1, 3]], tets[:, [0, 2, 3]], tets[:, [1, 2, 3]]]
    )
    key = np.sort(faces, axis=1)
    _, idx, counts = np.unique(key, axis=0, return_index=True, return_counts=True)
    surface = faces[idx[counts == 1]]
    return surface


def _face_areas(xyz, tets, face_idx):
    """Areas of the faces opposite vertex k=face_idx of each tet."""
    face_of = ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2))
    v = xyz[tets[:, face_of[face_idx]]]  # [ntet, 3, 3]
    return 0.5 * np.linalg.norm(
        np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=1
    )


def _threshold_labels(tets, nb, out_votes, in_votes):
    """Vote-majority labeling + outside flood fill from the hull that
    in-voted cells block (the labeler used when the native min-cut is
    unavailable on a large graph). Returns outside[ntet] bool."""
    voted_out = out_votes > in_votes
    voted_in = (in_votes >= out_votes) & (in_votes > 0)
    outside = voted_out.copy()
    blocked = voted_in
    frontier = np.zeros(len(tets), bool)
    hull_tet = (nb == -1).any(axis=1)
    frontier |= hull_tet & ~blocked & ~outside
    outside |= frontier
    while frontier.any():
        reach = np.zeros(len(tets), bool)
        nbs = nb[frontier].reshape(-1)
        nbs = nbs[nbs >= 0]
        reach[nbs] = True
        frontier = reach & ~outside & ~blocked
        outside |= frontier
    return outside


def _graphcut_labels(xyz, tets, nb, out_votes, in_votes, regularization):
    """Labatut-Pons graph-cut labeling (the reference CGAL mesher's energy,
    ref meshing.h:52-117 `quality_regularization`): per-cell terminal
    capacities from the visibility votes, face-area-weighted smoothness
    n-links between adjacent cells, hull cells source-linked through their
    hull-face area (the infinite outside cell), minimized exactly by s-t
    min-cut (pycolmap_torch/native/graph_ops.cc). Returns
    outside[ntet] bool, or None if no solver is viable at this size."""
    from pycolmap_torch import native

    ntet = len(tets)
    if native.get_lib() is None and ntet > 30_000:
        return None  # the Python fallback is too slow at this size
    eu, ev, areas = [], [], []
    hull_bonus = np.zeros(ntet, np.float64)
    for k in range(4):
        a_k = _face_areas(xyz, tets, k)
        nbk = nb[:, k]
        sel = nbk > np.arange(ntet)  # each adjacent pair once
        eu.append(np.nonzero(sel)[0])
        ev.append(nbk[sel])
        areas.append(a_k[sel])
        hull_bonus += np.where(nbk == -1, a_k, 0.0)
    eu = np.concatenate(eu)
    ev = np.concatenate(ev)
    areas = np.concatenate(areas)
    med_area = max(float(np.median(areas)), 1e-12) if len(areas) else 1.0
    lam = float(regularization)
    ecap = (lam * areas / med_area).astype(np.float32)
    net = (out_votes - in_votes + lam * hull_bonus / med_area).astype(
        np.float32
    )
    return native.min_cut(ntet, eu, ev, ecap, net).astype(bool)


def _delaunay_visibility_mesh(xyz, centers, obs_pairs, samples: int = 24,
                              behind_frac: float = 0.15,
                              regularization: float = 1.0, timings=None):
    """Visibility-carved Delaunay surface (the reference CGAL mesher's
    energy, ref meshing.h:52-117):

    - every sight ray (camera center -> observed point) votes the
      tetrahedra it crosses OUTSIDE (free space), located by vectorized
      point-location of samples along the segment;
    - short ray extensions BEHIND each point vote their tetrahedra INSIDE
      (matter behind the observed surface);
    - cells are labeled by the Labatut-Pons graph cut (`_graphcut_labels`;
      vote-threshold + flood-fill fallback), and the surface is the set of
      faces between outside and inside cells (plus hull faces of inside
      cells).

    obs_pairs: [M, 2] (point_idx, center_idx) observations. Returns faces
    [F, 3] (indices into xyz). ``timings`` (a dict) gets seconds for
    qhull, votes and cut.
    """
    from scipy.spatial import Delaunay

    t = time.perf_counter()
    tri = Delaunay(xyz)
    tets = tri.simplices
    ntet = len(tets)
    t_qhull = time.perf_counter()
    out_votes = np.zeros(ntet, np.float64)
    in_votes = np.zeros(ntet, np.float64)
    obs = np.asarray(obs_pairs, np.int64).reshape(-1, 2)
    chunk = max(1, 2_000_000 // max(samples, 1))
    ts = np.linspace(0.03, 0.97, samples)
    for s in range(0, len(obs), chunk):
        ob = obs[s:s + chunk]
        p = xyz[ob[:, 0]]
        c = centers[ob[:, 1]]
        seg = p - c
        pts = c[:, None, :] + seg[:, None, :] * ts[None, :, None]
        simp = tri.find_simplex(pts.reshape(-1, 3))
        simp = simp[simp >= 0]
        np.add.at(out_votes, simp, 1.0)
        # two samples just behind the point
        for f in (0.4 * behind_frac, behind_frac):
            back = p + seg * f
            sb = tri.find_simplex(back)
            sb = sb[sb >= 0]
            np.add.at(in_votes, sb, 1.0)
    t_votes = time.perf_counter()
    nb = tri.neighbors  # [ntet, 4], -1 = hull
    outside = _graphcut_labels(
        xyz, tets, nb, out_votes, in_votes, regularization
    )
    if outside is None:
        outside = _threshold_labels(tets, nb, out_votes, in_votes)
    inside = ~outside
    # surface: faces between an outside cell and an inside neighbor, plus
    # hull faces of inside cells (the shell seen from free space beyond
    # the hull); face k of a tet is opposite vertex k
    face_of = ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2))
    surf = []
    for k in range(4):
        nbk = nb[:, k]
        sel = outside & (nbk >= 0) & inside[np.maximum(nbk, 0)]
        sel |= inside & (nbk == -1)
        if sel.any():
            surf.append(tets[sel][:, face_of[k]])
    if timings is not None:
        timings.update(qhull=t_qhull - t, votes=t_votes - t_qhull,
                       cut=time.perf_counter() - t_votes)
    if not surf:
        return np.zeros((0, 3), np.int64)
    return np.concatenate(surf)


def _lookup(keys, values, query):
    """Map ``query`` through the dict ``keys[i] -> values[i]``. Returns
    (found mask, mapped values of the found entries)."""
    keys = np.asarray(keys, np.int64)
    values = np.asarray(values, np.int64)
    order = np.argsort(keys)
    ks, vs = keys[order], values[order]
    pos = np.minimum(np.searchsorted(ks, query), max(len(ks) - 1, 0))
    found = (ks[pos] == query) if len(ks) else np.zeros(len(query), bool)
    return found, vs[pos[found]]


def sparse_delaunay_meshing(input_path, output_path,
                            options: DelaunayMeshingOptions = None):
    """Sparse model -> surface mesh (ref: meshing.h:135-149), on the host.

    Visibility-carved Delaunay: the tracks' sight rays label free and solid
    cells, and the surface is their boundary."""
    if options is None:
        options = DelaunayMeshingOptions()
    from pycolmap_torch.scene import Reconstruction

    rec = Reconstruction(input_path)
    pids = list(rec.points3D.keys())
    xyz = np.array([rec.points3D[p].xyz for p in pids])
    if len(xyz) < 10:
        write_mesh_ply(output_path, np.zeros((0, 3)), np.zeros((0, 3), int))
        return False
    # the reconstruction's tracks supply the sight rays
    centers_by_img = {
        iid: rec.images[iid].projection_center()
        for iid in rec.reg_image_ids
    }
    centers = np.array(list(centers_by_img.values())).reshape(-1, 3)
    # (point row, image row) per track element, in track order
    tracks = [rec.points3D[p].track.elements for p in pids]
    lens = np.fromiter((len(t) for t in tracks), np.int64, len(tracks))
    img = np.fromiter((el.image_id for t in tracks for el in t), np.int64,
                      int(lens.sum()))
    rows = np.repeat(np.arange(len(pids), dtype=np.int64), lens)
    found, img_row = _lookup(list(centers_by_img), np.arange(len(centers)),
                             img)
    obs_pairs = np.stack([rows[found], img_row], axis=1)
    if len(centers) and len(obs_pairs):
        faces = _delaunay_visibility_mesh(
            xyz, centers, obs_pairs,
            regularization=options.quality_regularization,
        )
        if len(faces) == 0:  # degenerate visibility -> alpha-shape fallback
            faces = _delaunay_mesh_points(xyz)
    else:
        faces = _delaunay_mesh_points(xyz)
    write_mesh_ply(output_path, xyz, faces)
    return len(faces) > 0


def dense_delaunay_meshing(input_path, output_path,
                           options: DelaunayMeshingOptions = None,
                           timings=None):
    """Dense workspace (or fused PLY) -> surface mesh (ref:
    meshing.h:151-165), on the host.

    A directory input (as the reference takes the dense workspace and reads
    fused.ply + fused.ply.vis) runs the visibility-carved graph-cut mesher
    on the fusion's per-point visibility lists and the workspace's camera
    centers. A bare PLY path (no visibility) gives the alpha-shape surface.
    ``timings`` (a dict) gets seconds for read, qhull, votes, cut, write."""
    if options is None:
        options = DelaunayMeshingOptions()
    stages = {}
    t = time.perf_counter()
    input_path = Path(input_path)
    vis = None
    centers = None
    if input_path.is_dir():
        ply = input_path / "fused.ply"
        vis_path = Path(str(ply) + ".vis")
        xyz, _, _ = read_fused_ply(ply)
        if vis_path.exists():
            from pycolmap_torch.mvs.fusion import read_fused_vis
            from pycolmap_torch.mvs.workspace import MVSModel

            counts, flat = read_fused_vis(vis_path)
            if len(counts) == len(xyz):
                model = MVSModel(input_path)
                cam_ids = []
                cams = []
                for iid, m in model.images.items():
                    cam_ids.append(iid)
                    cams.append(-m.R.T @ m.t)
                centers = np.asarray(cams).reshape(-1, 3)
                vis = (counts, flat, cam_ids)
    else:
        xyz, _, _ = read_fused_ply(input_path)
    stages["read"] = time.perf_counter() - t
    if len(xyz) < 10:
        write_mesh_ply(output_path, np.zeros((0, 3)), np.zeros((0, 3), int))
        return False
    # subsample for tractable Delaunay
    sel = None
    if len(xyz) > 200_000:
        sel = np.random.default_rng(0).choice(len(xyz), 200_000, replace=False)
        xyz = xyz[sel]
    if vis is not None and len(centers):
        counts, flat, cam_ids = vis
        offsets = np.zeros(len(counts) + 1, np.int64)
        np.cumsum(counts, dtype=np.int64, out=offsets[1:])
        pts_idx = sel if sel is not None else np.arange(len(counts))
        # (row, camera row) of every listed image of every kept point, in
        # point order, then list order
        cnt = counts[pts_idx].astype(np.int64)
        first = np.zeros(len(cnt) + 1, np.int64)
        np.cumsum(cnt, out=first[1:])
        rows = np.repeat(np.arange(len(pts_idx), dtype=np.int64), cnt)
        at = (np.repeat(offsets[pts_idx], cnt)
              + np.arange(first[-1], dtype=np.int64) - first[rows])
        found, cam = _lookup(cam_ids, np.arange(len(cam_ids)),
                             flat[at].astype(np.int64))
        obs_pairs = np.stack([rows[found], cam], axis=1)
        faces = _delaunay_visibility_mesh(
            xyz, centers, obs_pairs,
            regularization=options.quality_regularization, timings=stages,
        )
        if len(faces) == 0:
            faces = _delaunay_mesh_points(xyz)
    else:
        faces = _delaunay_mesh_points(xyz)
    t = time.perf_counter()
    write_mesh_ply(output_path, xyz, faces)
    stages["write"] = time.perf_counter() - t
    if timings is not None:
        timings.update(stages)
    return len(faces) > 0
