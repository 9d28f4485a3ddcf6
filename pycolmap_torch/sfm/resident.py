"""Device-resident bundle-adjustment solver.

Port of ``pycolmap_tpu/sfm/resident.py`` (``ResidentBundleSolver``). The
bucket structure AND the parameters stay on the device between solves:
each ``solve()`` runs the LM loop on the resident tensors and reads back
only its summary scalars; ``fetch_problem()`` downloads the parameters and
writes the bucketed points back to their flat rows. Given a
:class:`~pycolmap_torch.parallel.device_ctx.ShardMesh`, each shard keeps
its slice of every bucket's point columns and its point planes resident
on its device, and the camera system lives on the mesh's first device
(the reference's sharded point planes with replicated camera blocks).
``MapperResidentBA`` is the incremental mapper's cache of such solvers,
keyed by a hash of the whole problem and the mesh's content: a refinement
round that re-solves an unchanged problem reuses the resident solver
instead of rebuilding it.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from pycolmap_torch import resolve_device
from pycolmap_torch.parallel.device_ctx import mesh_device
from pycolmap_torch.ops.camera_models import solver_num_params
from pycolmap_torch.sfm import ba_kernels as bk
from pycolmap_torch.sfm.bundle_adjustment import BASummary, BundleProblem


_FLOAT_FIELDS = ("cam_quat", "cam_trans", "intrinsics", "points", "obs_xy",
                 "obs_mask", "pose_free", "intr_free", "point_free")


def check_kernel_dtype(problem: BundleProblem, device) -> None:
    """Raise TypeError if a CUDA solve is given float arrays other than
    float32: the card's kernels take float32 only, and a problem of another
    dtype is never cast quietly. The CPU's plain path solves in float32, as
    the reference's does."""
    if torch.device(device).type != "cuda":
        return
    bad = sorted({
        f"{f}: {bk._np(getattr(problem, f)).dtype}" for f in _FLOAT_FIELDS
        if bk._np(getattr(problem, f)).dtype != np.float32
    })
    if bad:
        raise TypeError(
            "the card's BA kernels take float32 only; build the problem "
            f"with dtype=torch.float32 ({', '.join(bad)})"
        )


class ResidentBundleSolver:
    """Re-solvable BA problem with device-resident structure AND parameters.

    Usage::

        solver = ResidentBundleSolver(problem, options, cg_iters=20)
        summary = solver.solve()          # params advance on device
        solver.perturb_points(1e-6)       # optional device-side edit
        summary = solver.solve()          # re-solve from current params
        new_problem = solver.fetch_problem()   # one download + write-back

    device: None = the card (raises on a host without CUDA), or ``"cpu"``
    for the plain PyTorch versions of the kernels. cg_bf16: run the CG
    matvecs from J packed to bf16; None = bf16 on the card, f32 on the CPU
    (``ba_kernels.cg_bf16_default``). mesh: a ShardMesh to shard the points
    over (its devices take the place of ``device``; one that disagrees
    raises ValueError), or None for one device. dense_schur_max_d: the
    dense reduced system's cutoff, None = the device's
    (``ba_kernels.dense_schur_selected``); without a mesh the solver maps
    each image to its camera from the valid observations, as the
    reference's does, so a small problem solves densely.

    After each solve, ``last_result`` holds the loop's counters
    (``host_syncs``: condition reads of the LM and CG loops, plus the one
    summary read; ``cg_iterations``: implicit matvecs; ``dense``: the
    dense system was solved, ``dense_cg_iterations`` times its PCG
    iterated).
    """

    def __init__(self, problem: BundleProblem, options, cg_iters: int = 30,
                 device=None, cg_bf16=None, mesh=None,
                 dense_schur_max_d=None):
        self.device = mesh_device(mesh, device)
        self.mesh = mesh
        self.cg_bf16 = bk.cg_bf16_default(self.device, cg_bf16)
        self.dense_schur_max_d = dense_schur_max_d
        check_kernel_dtype(problem, self.device)
        if problem.num_obs == 0:
            raise ValueError("empty problem")
        self._problem = problem
        self._options = options
        self._cg_iters = int(cg_iters)
        # one tuple of buckets per local shard, on its device (one shard
        # without a mesh); every bucket's point rows and the columns holding
        # a point, for the write-back
        if mesh is None:
            shards = [bk.bucketize(problem)]
            # padded columns repeat row 0 and are fully masked: harmless to
            # solve, excluded from the write-back
            self._rows_sel = [(b.point_rows,
                               (b.mask[0] > 0) | (b.point_free > 0))
                              for b in shards[0]]
        else:
            shards = bk.shard_buckets(problem, mesh)
            self._rows_sel = [(rows, sel) for rows, sel, _, _
                              in bk.bucket_meta(problem)]
        if not shards[0]:
            raise ValueError("no observation buckets")
        devs = (self.device,) if mesh is None else mesh.devices
        self._buckets = [[bk.bucket_to(b, d) for b in bl]
                         for bl, d in zip(shards, devs)]
        self._pts = [[b.points for b in bl] for bl in self._buckets]

        def put(a):
            return torch.as_tensor(
                np.ascontiguousarray(bk._np(a), dtype=np.float32)
            ).to(self.device)

        self._quat = put(problem.cam_quat)
        self._trans = put(problem.cam_trans)
        self._intr = put(problem.intrinsics)  # [C, MAX_PARAMS]
        self._pose_free = put(problem.pose_free)
        self._intr_free = put(problem.intr_free)
        self._NP = solver_num_params(problem.model_id)
        # each image's camera (the last valid observation's), for the dense
        # system's pose-intrinsics blocks; the dense path never runs on a
        # mesh (the reference's resident.py:135-159)
        self._img2cam = None
        if mesh is None:
            img2cam = np.zeros(problem.num_images, np.int64)
            valid = bk._np(problem.obs_mask) > 0
            img2cam[bk._np(problem.obs_image_idx)[valid]] = bk._np(
                problem.obs_camera_idx)[valid]
            self._img2cam = torch.from_numpy(img2cam).to(self.device)
        self.last_result = None

    def perturb_points(self, eps: float) -> None:
        """Add eps to every point coordinate ON DEVICE (no host transfer)."""
        self._pts = [[p + eps for p in sl] for sl in self._pts]

    def solve(self, max_iterations: int = None) -> BASummary:
        """One LM solve from the current device-resident parameters."""
        options = self._options
        max_iters = int(
            options.max_num_iterations
            if max_iterations is None else max_iterations
        )
        buckets = [[b._replace(points=p) for b, p in zip(bl, sl)]
                   for bl, sl in zip(self._buckets, self._pts)]
        r = bk._lm_solve_bucketed(
            buckets, self._quat, self._trans, self._intr, self._pose_free,
            self._intr_free, self._problem.model_id,
            int(options.loss_function_type),
            float(options.loss_function_scale), self._cg_iters, max_iters,
            eta=float(getattr(options, "eta", 0.1)), cg_bf16=self.cg_bf16,
            mesh=self.mesh, img2cam=self._img2cam,
            dense_schur_max_d=self.dense_schur_max_d,
        )
        self._quat, self._trans = r.quat, r.trans
        # the solver runs NP-narrow intrinsics; columns >= NP are untouched
        intr = self._intr.clone()
        intr[:, :self._NP] = r.intr
        self._intr = intr
        self._pts = list(r.points)
        cost0, cost = torch.stack([r.initial_cost, r.final_cost]).tolist()
        self.last_result = r._replace(host_syncs=r.host_syncs + 1)
        return BASummary(float(cost0), float(cost), int(r.iterations),
                         2 * self._problem.num_obs)

    def fetch_problem(self) -> BundleProblem:
        """Download the current parameters into a BundleProblem (host
        tensors), writing the bucketed points back to their flat rows."""
        problem = self._problem
        points = bk._np(problem.points).astype(np.float32, copy=True)
        for pts, rows, sel in self._point_planes():
            vals = pts.detach().cpu().numpy().T  # [P, 3]
            points[rows[sel]] = vals[sel]
        return problem._replace(
            cam_quat=self._quat.cpu(),
            cam_trans=self._trans.cpu(),
            intrinsics=self._intr.cpu(),
            points=torch.from_numpy(points),
        )

    def _point_planes(self):
        """(points [3, P], point rows [P], columns holding a point [P]) per
        bucket. The local shards hold contiguous columns in order, so their
        concatenation is this process's block; across processes each
        block is placed in a zero-filled full-width plane and the planes
        are summed by an ``all_reduce`` (exact: each column has one nonzero
        term, and gloo reduces CUDA tensors in ``all_reduce``), so every
        rank holds every point."""
        mesh = self.mesh
        for j, (rows, sel) in enumerate(self._rows_sel):
            plane = torch.cat([sl[j].to(self.device) for sl in self._pts], 1)
            if mesh is not None and mesh.group is not None:
                full = torch.zeros((3, len(rows)), device=self.device)
                c0 = mesh.rank * plane.shape[1]
                full[:, c0:c0 + plane.shape[1]] = plane
                plane = mesh.reduce([full])
            yield plane, rows, sel


def _problem_fingerprint(problem: BundleProblem) -> bytes:
    """Hash of EVERYTHING (structure AND parameters): two problems with
    equal fingerprints are the same solve input bit-for-bit."""
    h = hashlib.blake2b(digest_size=16)
    for a in (
        problem.obs_point_idx, problem.obs_image_idx, problem.obs_camera_idx,
        problem.obs_xy, problem.obs_mask, problem.point_free,
        problem.pose_free, problem.intr_free, problem.cam_quat,
        problem.cam_trans, problem.intrinsics, problem.points,
    ):
        a = np.ascontiguousarray(bk._np(a))
        h.update(str((a.shape, a.dtype.str)).encode())
        h.update(a.tobytes())
    h.update(str(problem.model_id).encode())
    return h.digest()


class MapperResidentBA:
    """Structure-keyed resident-solver cache for the mapper's refinement
    loops (port of the reference's ``MapperResidentBA``).

    The mapper's iterative local/global refinement re-solves the same
    observation graph whenever the intervening completion/merge/filter
    round changed nothing. `solve()` fingerprints the problem (structure
    AND parameters); on a hit the cached solver's device state IS the
    requested input (the previous fetch round-trips bit-exactly through
    float64 scene objects: ``fetch_problem`` returns float32 host tensors,
    and the next ``build_bundle_problem`` rounds the scene back to the
    same float32 values), so the solve runs on the resident tensors: no
    rebuild, no upload. On a miss it builds a fresh resident solver and
    caches it.

    device / cg_bf16 / dense_schur_max_d: as :class:`ResidentBundleSolver`
    (a cached solver is reused only under the same ``dense_schur_max_d``).
    The counters ``hits``, ``misses``, ``solves``, ``lm_steps`` and
    ``cg_iterations`` add up over the cache's solves (an LM step is one
    prepare and one finish launch, a CG iteration one matvec launch);
    ``dense_solves``, ``dense_lm_steps`` and ``dense_cg_iterations`` count
    the solves of the dense reduced system apart (their steps are in
    ``lm_steps`` too; their PCG iterations launch no matvec).
    """

    def __init__(self, max_entries: int = 3, device=None, cg_bf16=None,
                 dense_schur_max_d=None):
        self.device = resolve_device(device)
        self.cg_bf16 = cg_bf16
        self.dense_schur_max_d = dense_schur_max_d
        self._entries = {}  # fingerprint -> ResidentBundleSolver
        self._max = max_entries
        self.hits = 0
        self.misses = 0
        self.solves = 0
        self.lm_steps = 0
        self.cg_iterations = 0
        self.dense_solves = 0
        self.dense_lm_steps = 0
        self.dense_cg_iterations = 0

    def solve(self, problem: BundleProblem, options, cg_iters: int = 30,
              mesh=None):
        """Same contract as solve_bundle: (new_problem, summary). mesh: a
        ShardMesh to shard the points over, or None; a cached solver is
        reused only on a mesh of the same content (``ShardMesh.key``)."""
        if problem.num_obs == 0 or float(bk._np(problem.obs_mask).sum()) == 0:
            return problem, BASummary(0.0, 0.0, 0, 0)
        setting = (None if mesh is None else mesh.key(),
                   self.dense_schur_max_d)
        key = (_problem_fingerprint(problem), setting)
        solver = self._entries.pop(key, None)
        if solver is None:
            self.misses += 1
            # only an empty problem is passed over (above): a mesh that
            # cannot split the buckets, or a kernel launch that fails,
            # raises
            solver = ResidentBundleSolver(
                problem, options, cg_iters=cg_iters, device=self.device,
                cg_bf16=self.cg_bf16, mesh=mesh,
                dense_schur_max_d=self.dense_schur_max_d,
            )
        else:
            self.hits += 1
            solver._options = options
        summary = solver.solve()
        self.solves += 1
        r = solver.last_result
        self.lm_steps += r.iterations
        self.cg_iterations += r.cg_iterations
        if r.dense:
            self.dense_solves += 1
            self.dense_lm_steps += r.iterations
            self.dense_cg_iterations += r.dense_cg_iterations
        new_problem = solver.fetch_problem()
        # re-key under the POST-solve state so the next refinement round
        # (which rebuilds from the scene we are about to write back) hits
        if len(self._entries) >= self._max:
            self._entries.pop(next(iter(self._entries)))
        self._entries[(_problem_fingerprint(new_problem), setting)] = solver
        return new_problem, summary
