"""The plain versions of the five CUDA kernels (pycolmap_torch/sfm/
cg_kernel.py) vs the reference's Pallas kernels run in interpret mode on the
CPU, on the same numpy inputs: T=4, P=128, C=2, SIMPLE_RADIAL, built
NP-wide (the NP-narrow J comes out of res_and_jac itself). Tolerances are
the reference's own kernel tests' (tests/test_cg_kernel.py,
tests/test_cg_kernel_fused.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pycolmap_tpu.ops import ba_math as jbm
from pycolmap_tpu.ops.camera_models import MAX_PARAMS
from pycolmap_tpu.sfm import ba_kernels as jbk
from pycolmap_tpu.sfm import cg_kernel as jck
from pycolmap_torch.ops.camera_models import solver_num_params
from pycolmap_torch.sfm import ba_kernels as tbk
from pycolmap_torch.sfm import cg_kernel as tck

MODEL_ID = 2  # SIMPLE_RADIAL
NP = 4
T, P, I, C = 4, 128, 6, 2


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch intra-op thread per test: the suite runs test files in
    parallel workers, whose thread pools would otherwise contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed):
    """numpy inputs of one bucket; ~30% mask holes, ~20% fixed points."""
    rng = np.random.default_rng(seed)
    bucket = dict(
        img_idx=rng.integers(0, I, (T, P)).astype(np.int32),
        cam_idx=rng.integers(0, C, (T, P)).astype(np.int32),
        xy=rng.normal(scale=200.0, size=(2, T, P)).astype(np.float32),
        mask=(rng.uniform(size=(T, P)) > 0.3).astype(np.float32),
        points=rng.normal(scale=1.0, size=(3, P)).astype(np.float32),
        point_free=(rng.uniform(size=P) > 0.2).astype(np.float32),
        point_rows=np.arange(P, dtype=np.int32),
    )
    quat = rng.normal(size=(I, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    trans = rng.normal(size=(I, 3)).astype(np.float32)
    trans[:, 2] += 8.0
    trans[0, 2] = -30.0  # every point behind image 0
    intr = np.zeros((C, MAX_PARAMS), np.float32)
    intr[:, 0] = 900.0 + 50 * rng.normal(size=C)
    intr[:, 1] = 320.0
    intr[:, 2] = 240.0
    intr[:, 3] = 0.05 * rng.normal(size=C)
    intr_free = (rng.uniform(size=(C, MAX_PARAMS)) > 0.5).astype(np.float32)
    return dict(bucket=bucket, quat=quat, trans=trans, intr=intr,
                intr_free=intr_free, rng=rng)


def _jb(case):
    return jbk.Bucket(**{k: jnp.asarray(v) for k, v in case["bucket"].items()})


def _tb(case):
    return tbk.Bucket(**{k: torch.from_numpy(v)
                         for k, v in case["bucket"].items()})


def _j(a):
    return jnp.asarray(np.asarray(a))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_scaled(got, ref, atol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(got / scale, ref / scale, atol=atol)


def _resjac_both(case, loss_type, scale):
    jb = _jb(case)
    ref = jck.res_and_jac(
        [jb], [jb.points], _j(case["quat"]), _j(case["trans"]),
        _j(case["intr"]), _j(case["intr_free"]), MODEL_ID, loss_type,
        jnp.float32(scale), interpret=True,
    )
    tb = _tb(case)
    got = tck.res_and_jac(
        [tb], [tb.points], _t(case["quat"]), _t(case["trans"]),
        _t(case["intr"]), _t(case["intr_free"]), MODEL_ID, loss_type, scale,
    )
    return ref, got


@pytest.mark.parametrize("loss_type", [0, 1, 2])
def test_resjac_matches_pallas(loss_type):
    case = _case(loss_type)
    (ref_res, ref_J), (got_res, got_J) = _resjac_both(case, loss_type, 1.5)
    assert got_J[0].shape == (2, 9 + NP, T, P)
    _close_scaled(got_res[0], ref_res[0], 1e-5)
    _close_scaled(got_J[0], ref_J[0], 1e-5)


@pytest.mark.parametrize("loss_type", [0, 1, 2])
def test_total_cost_matches_pallas(loss_type):
    case = _case(10 + loss_type)
    jb = _jb(case)
    ref = float(jck.total_cost(
        [jb], [jb.points], _j(case["quat"]), _j(case["trans"]),
        _j(case["intr"]), MODEL_ID, loss_type, jnp.float32(1.5),
        interpret=True,
    ))
    tb = _tb(case)
    got = float(tck.total_cost(
        [tb], [tb.points], _t(case["quat"]), _t(case["trans"]),
        _t(case["intr"]), MODEL_ID, loss_type, 1.5,
    ))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_backsub_and_cost_matches_pallas():
    case = _case(20)
    rng = case["rng"]
    (_, ref_J), _ = _resjac_both(case, 1, 1.5)
    J = np.asarray(ref_J[0])  # NP-narrow, from the reference kernel
    Vinv = rng.normal(scale=1e-3, size=(6, P)).astype(np.float32)
    g_pt = rng.normal(size=(3, P)).astype(np.float32)
    x_pose = rng.normal(scale=1e-3, size=(I, 6)).astype(np.float32)
    x_intr = rng.normal(scale=1e-3, size=(C, NP)).astype(np.float32)
    q = case["quat"]
    nq = jbm.quat_boxplus_cf(tuple(jnp.asarray(q[:, i]) for i in range(4)),
                             tuple(jnp.asarray(-x_pose[:, i])
                                   for i in range(3)))
    new_quat = np.stack([np.asarray(a) for a in nq], axis=1)
    new_trans = case["trans"] - x_pose[:, 3:6]
    new_intr = case["intr"].copy()
    new_intr[:, :NP] -= x_intr

    jb = _jb(case)
    ref_pts, ref_cost = jck.backsub_and_cost(
        [jb], [jb.points], [_j(J)], [_j(Vinv)], [_j(g_pt)], _j(x_pose),
        _j(x_intr), _j(new_quat), _j(new_trans), _j(new_intr), MODEL_ID, 1,
        jnp.float32(1.5), interpret=True,
    )
    tb = _tb(case)
    got_pts, got_cost = tck.backsub_and_cost(
        [tb], [tb.points], [_t(J)], [_t(Vinv)], [_t(g_pt)], _t(x_pose),
        _t(x_intr), _t(new_quat), _t(new_trans), _t(new_intr), MODEL_ID, 1,
        1.5,
    )
    _close_scaled(got_pts[0], ref_pts[0], 1e-5)
    np.testing.assert_allclose(float(got_cost), float(ref_cost), rtol=1e-4)


@pytest.mark.parametrize("lam", [0.37, 0.05])
def test_schur_prepare_matches_pallas(lam):
    case = _case(30)
    (ref_res, ref_J), _ = _resjac_both(case, 0, 1.0)
    J, res = np.asarray(ref_J[0]), np.asarray(ref_res[0])
    jb = _jb(case)
    ref = jck.schur_prepare([jb], [_j(J)], [_j(res)], jnp.float32(lam), I, C,
                            interpret=True)
    tb = _tb(case)
    got = tck.schur_prepare([tb], [_t(J)], [_t(res)],
                            torch.tensor(lam, dtype=torch.float32), I, C)
    for k in (0, 1):  # per-bucket Vinv, g_pt
        _close_scaled(got[k][0], ref[k][0], 3e-5)
    for g, r in zip(got[2:], ref[2:]):  # rhs, U diagonals, S blocks
        _close_scaled(g, r, 3e-5)


@pytest.mark.parametrize("seed", [40, 41])
def test_schur_matvec_matches_pallas(seed):
    case = _case(seed)
    rng = case["rng"]
    (_, ref_J), _ = _resjac_both(case, 0, 1.0)
    J = np.asarray(ref_J[0])
    Vinv = rng.normal(scale=1e-3, size=(6, P)).astype(np.float32)
    x_pose = rng.normal(size=(I, 6)).astype(np.float32)
    x_intr = rng.normal(size=(C, NP)).astype(np.float32)
    jb = _jb(case)
    ref = jck.schur_matvec([jb], [_j(J)], [_j(Vinv)], _j(x_pose),
                           _j(x_intr), I, C, interpret=True)
    tb = _tb(case)
    got = tck.schur_matvec([tb], [_t(J)], [_t(Vinv)], _t(x_pose),
                           _t(x_intr), I, C)
    scale = max(np.abs(np.asarray(ref[0])).max(),
                np.abs(np.asarray(ref[1])).max(), 1.0)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g) / scale,
                                   np.asarray(r) / scale, atol=2e-5)


def test_cpu_wrappers_launch_no_kernel():
    """On CPU tensors every wrapper runs its plain version: no launches."""
    tck.reset_counts()
    case = _case(50)
    tb = _tb(case)
    args = (_t(case["quat"]), _t(case["trans"]), _t(case["intr"]))
    res_l, J_l = tck.res_and_jac([tb], [tb.points], *args,
                                 _t(case["intr_free"]), MODEL_ID, 0, 1.0)
    tck.total_cost([tb], [tb.points], *args, MODEL_ID, 0, 1.0)
    prep = tck.schur_prepare([tb], J_l, res_l, 0.1, I, C)
    tck.schur_matvec([tb], J_l, prep[0], torch.zeros(I, 6),
                     torch.zeros(C, NP), I, C)
    # a mixed-model tuple takes its plain version too
    tck.total_cost([tb], [tb.points], *args, (2, 4), 0, 1.0)
    assert all(v == 0 for v in tck.LAUNCHES.values())
    assert all(v == 0 for v in tck.PLAIN_ON_CUDA.values())


def test_kernel_operands_must_be_cuda():
    from pycolmap_torch import _cuda_build

    with pytest.raises(ValueError, match="CUDA"):
        _cuda_build.ptr(torch.zeros(3))


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No toolkit, no kernels: the build raises instead of falling back."""
    from pycolmap_torch import _cuda_build as _cuda

    monkeypatch.setattr(_cuda, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_cuda, "_libs", None)
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.libs()
    assert _cuda._libs is None


# ---------------------------------------------------------------------------
# the bf16-packed matvec (reference cg_matvec16_bucket, cg_kernel.py:352)
# ---------------------------------------------------------------------------


def _bf16_case(seed, NPm, Cm, T16=4, P16=256, ragged=219):
    """An f32 J of the NP-wide layout whose columns >= `ragged` are padding
    (all-zero J, index 0), so P stays the multiple of 128 the reference's
    kernel needs while the data is ragged."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(2, 9 + NPm, T16, P16)).astype(np.float32)
    mask = (rng.uniform(size=(T16, P16)) > 0.3).astype(np.float32)
    mask[:, ragged:] = 0.0
    J *= mask[None, None]
    ii = (rng.integers(0, I, (T16, P16)) * mask).astype(np.int32)
    ci = (rng.integers(0, Cm, (T16, P16)) * mask).astype(np.int32)
    Vinv = rng.normal(size=(6, P16)).astype(np.float32)
    x_pose = rng.normal(size=(I, 6)).astype(np.float32)
    x_intr = rng.normal(size=(Cm, NPm)).astype(np.float32)
    return J, ii, ci, Vinv, x_pose, x_intr


def _bucket16(ii, ci):
    return tbk.Bucket(torch.from_numpy(ii), torch.from_numpy(ci),
                      *([None] * 5))


def _to_torch_bf16(j16):
    """The reference's bf16 array as a torch bf16 tensor, bit for bit."""
    return torch.from_numpy(np.asarray(j16).view(np.int16).copy()).view(
        torch.bfloat16)


@pytest.mark.parametrize("NPm", [3, 4, 8])
def test_pack_j_bf16_is_bit_equal(NPm):
    """Both round f32 to nearest even; the layouts match exactly."""
    J = _bf16_case(60 + NPm, NPm, 1)[0]
    J[0, 0, 0, :4] = [1.00390625, 1.01171875, -3.0e38, 1e-40]  # ties, edges
    ref = _to_torch_bf16(jck.pack_j_bf16(jnp.asarray(J)))
    got = tck.pack_j_bf16(torch.from_numpy(J))
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))
    np.testing.assert_array_equal(
        tck.unpack_j_bf16(got).numpy(),
        np.asarray(jnp.asarray(J).astype(jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("NPm", [3, 4, 8])
@pytest.mark.parametrize("Cm", [1, 3])
def test_schur_matvec16_matches_pallas(NPm, Cm):
    """The plain bf16 matvec vs the reference's Pallas kernel (interpret
    mode) on the reference's own packed J16. Tolerance 2e-5 scaled, the f32
    matvec's (tests/test_cg_kernel.py:64): both sides multiply the same
    bf16 values in f32. Cm = 1 is the reference's single_cam variant."""
    J, ii, ci, Vinv, x_pose, x_intr = _bf16_case(70 + NPm + Cm, NPm, Cm)
    J16 = jck.pack_j_bf16(jnp.asarray(J))
    jb = tbk.Bucket(jnp.asarray(ii), jnp.asarray(ci), *([None] * 5))
    ref = jck.schur_matvec16([jb], [J16], [jnp.asarray(Vinv)],
                             jnp.asarray(x_pose), jnp.asarray(x_intr), I, Cm,
                             interpret=True)
    tck.reset_counts()
    got = tck.schur_matvec16([_bucket16(ii, ci)], [_to_torch_bf16(J16)],
                             [torch.from_numpy(Vinv)], torch.from_numpy(x_pose),
                             torch.from_numpy(x_intr), I, Cm)
    assert tck.LAUNCHES["matvec16"] == 0
    scale = max(np.abs(np.asarray(ref[0])).max(),
                np.abs(np.asarray(ref[1])).max(), 1.0)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy() / scale, np.asarray(r) / scale,
                                   atol=2e-5)
    # the ragged data without its padding columns gives the same sums, up
    # to f32 summation order
    R = 219
    cut = tck.schur_matvec16(
        [_bucket16(np.ascontiguousarray(ii[:, :R]),
                   np.ascontiguousarray(ci[:, :R]))],
        [_to_torch_bf16(J16)[:, :, :R]], [torch.from_numpy(Vinv[:, :R])],
        torch.from_numpy(x_pose), torch.from_numpy(x_intr), I, Cm)
    for g, c in zip(got, cut):
        np.testing.assert_allclose(c.numpy() / scale, g.numpy() / scale,
                                   atol=1e-6)


def test_schur_matvec16_matches_f32():
    """bf16 storage of J vs the f32 matvec: 3e-2 scaled, the reference's
    tolerance (tests/test_cg_kernel.py:239; ~8e-3 relative on the
    quadratic form)."""
    J, ii, ci, Vinv, x_pose, x_intr = _bf16_case(11, 4, 2, T16=8)
    b = _bucket16(ii, ci)
    args = ([torch.from_numpy(Vinv)], torch.from_numpy(x_pose),
            torch.from_numpy(x_intr), I, 2)
    ref = tck.schur_matvec([b], [torch.from_numpy(J)], *args)
    got = tck.schur_matvec16([b], [tck.pack_j_bf16(torch.from_numpy(J))],
                             *args)
    scale = max(float(ref[0].abs().max()), float(ref[1].abs().max()), 1.0)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy() / scale, r.numpy() / scale,
                                   atol=3e-2)


# ---------------------------------------------------------------------------
# the Schur kernels' bucket table (csrc/schur.cu: matvec16_kernel,
# matvec_kernel and prepare_kernel, one launch over every bucket's tiles)
# ---------------------------------------------------------------------------


def test_matvec16_tiles():
    """Tiles hold at most 256 slots: 128 columns up to T = 2, 4 at the
    ladder's T = 64; tiles run bucket after bucket."""
    assert [tck.tile_p(t) for t in (1, 4, 5, 8, 12, 16, 32, 64)] \
        == [128, 64, 32, 32, 16, 16, 8, 4]
    with pytest.raises(ValueError):
        tck.tile_p(65)
    rows, n = tck.tile_table([(4, 128), (8, 131072), (16, 88)])
    assert rows == ((4, 128, 64, 0), (8, 131072, 32, 2),
                    (16, 88, 16, 4098)) and n == 4104
    with pytest.raises(ValueError):
        tck.tile_table([(4, 128)] * 9)
    with pytest.raises(ValueError):  # widths are multiples of 8
        tck.tile_table([(16, 77)])


@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "f32"])
def test_tile_widths(esize):
    """For every T the ladder may give (1..64), in both J types (bf16 for
    matvec16, f32 for prepare and the f32 matvec): the widest power-of-two
    tile of at most 256 slots and 128 columns; each J row piece at least
    the kernels' smallest copy (8 bytes of bf16, 16 of f32) and each index
    row piece 16 bytes or more."""
    for T in range(1, tck.TILE_MAX_T + 1):
        tp = tck.tile_p(T)
        assert tp & (tp - 1) == 0 and 4 <= tp <= 128
        assert T * tp <= tck.TILE_SLOTS
        assert tp == 128 or T * 2 * tp > tck.TILE_SLOTS  # the widest
        assert tp * esize >= (8 if esize == 2 else 16) and tp * 4 >= 16
    assert tck.tile_p(64) * esize == 4 * esize
    assert tck.tile_p(8) * esize == 32 * esize  # the bench's long bucket


@pytest.mark.parametrize("shapes, why", [
    ([], "no bucket"),
    ([(4, 128)] * 9, "more buckets than the table holds"),
    ([(0, 128)], "T = 0"),
    ([(65, 128)], "T above the ladder's 64"),
    ([(8, 131072), (16, 1004)], "a width no multiple of 8"),
])
def test_tile_table_rejects(shapes, why):
    with pytest.raises(ValueError):
        tck.tile_table(shapes)


def test_tile_launch_needs_the_card():
    """Off the card no table is built: the plain versions need none."""
    J, ii, ci, Vinv, _, _ = _bf16_case(5, 4, 1)
    assert tck.matvec_launch("matvec", [_bucket16(ii, ci)],
                             [torch.from_numpy(J)],
                             [torch.from_numpy(Vinv)], I, 1) is None


def _walk_tiles(rows, n_tiles, blocks, cluster):
    """The kernels' walk of a table: `blocks` blocks take contiguous runs
    of ceil(n_tiles / blocks) tiles, yielded per block as (bucket, columns)
    in tile order; blocks come in clusters of `cluster`."""
    starts = [r[3] for r in rows]
    per = -(-n_tiles // blocks)
    for blk in range(blocks):
        tiles = []
        for tile in range(blk * per, min((blk + 1) * per, n_tiles)):
            bi = max(i for i, f in enumerate(starts) if f <= tile)
            T, P, tp, first = rows[bi]
            tiles.append((bi, slice((tile - first) * tp,
                                    min((tile - first + 1) * tp, P))))
        yield tiles


def _cluster_order(sums, cluster):
    """Block sums added per cluster in rank order, the clusters' rows in
    cluster order (tile_finish)."""
    out = None
    for c in range(0, len(sums), cluster):
        part = [sum(x[k] for x in sums[c:c + cluster])
                for k in range(len(sums[0]))]
        out = part if out is None else [o + q for o, q in zip(out, part)]
    return out


def _matvec_walk(plain, rows, n_tiles, buckets, J_l, Vinv_l, x_pose, x_intr,
                 I, C, blocks=8, cluster=tck.TILE_CLUSTER):
    """A matvec kernel's walk in plain PyTorch (`plain`: matvec_plain on f32
    J or matvec16_plain on bf16 J; both layouts keep columns last): each
    block sums its tiles' S x, then _cluster_order. Returns ([I, 6],
    [C, NP]) in the dtype of Vinv."""
    NP = x_intr.shape[1]
    dt = Vinv_l[0].dtype
    sums = []
    for tiles in _walk_tiles(rows, n_tiles, blocks, cluster):
        acc = [torch.zeros((I, 6), dtype=dt), torch.zeros((C, NP), dtype=dt)]
        for bi, cols in tiles:
            b = buckets[bi]
            part = b._replace(img_idx=b.img_idx[:, cols],
                              cam_idx=b.cam_idx[:, cols])
            op, oi = plain(part, J_l[bi][..., cols], Vinv_l[bi][:, cols],
                           x_pose.to(dt), x_intr.to(dt), I, C)
            acc = [acc[0] + op, acc[1] + oi]
        sums.append(acc)
    return tuple(_cluster_order(sums, cluster))


@pytest.mark.parametrize("NPm", [4, 9])
def test_matvec16_walk_matches_pallas(NPm):
    """The kernel's walk of its table (tiles dealt to blocks, block sums
    added per cluster, cluster rows in order) equals schur_matvec16's plain
    result and the reference's Pallas kernel (interpret mode), with the
    bench's empty [4, 128] bucket beside a full one. Width 9 is the mixed
    SIMPLE_RADIAL + OPENCV bundle's. Tolerance 2e-5 scaled, as the bf16
    matvec's other tests."""
    J, ii, ci, Vinv, x_pose, x_intr = _bf16_case(90 + NPm, NPm, 2, T16=8,
                                                 P16=256, ragged=201)
    J16_full = jck.pack_j_bf16(jnp.asarray(J))
    J16_empty = jnp.zeros((9 + NPm, 8, 128), jnp.bfloat16)
    z_idx = np.zeros((4, 128), np.int32)
    V_empty = np.zeros((6, 128), np.float32)
    ref = jck.schur_matvec16(
        [jbk.Bucket(jnp.asarray(z_idx), jnp.asarray(z_idx), *([None] * 5)),
         jbk.Bucket(jnp.asarray(ii), jnp.asarray(ci), *([None] * 5))],
        [J16_empty, J16_full], [jnp.asarray(V_empty), jnp.asarray(Vinv)],
        jnp.asarray(x_pose), jnp.asarray(x_intr), I, 2, interpret=True)
    buckets = [_bucket16(z_idx, z_idx), _bucket16(ii, ci)]
    J16_l = [_to_torch_bf16(J16_empty), _to_torch_bf16(J16_full)]
    V_l = [torch.from_numpy(V_empty), torch.from_numpy(Vinv)]
    tck.reset_counts()
    plain = tck.schur_matvec16(buckets, J16_l, V_l, torch.from_numpy(x_pose),
                               torch.from_numpy(x_intr), I, 2)
    assert tck.LAUNCHES["matvec16"] == 0
    rows, n_tiles = tck.tile_table([tuple(b.img_idx.shape)
                                    for b in buckets])
    assert rows == ((4, 128, 64, 0), (8, 256, 32, 2)) and n_tiles == 10
    walk = _matvec_walk(tck.matvec16_plain, rows, n_tiles, buckets, J16_l,
                        [v.double() for v in V_l],
                        torch.from_numpy(x_pose).double(),
                        torch.from_numpy(x_intr).double(), I, 2,
                        blocks=4, cluster=2)  # runs of 3 tiles
    scale = max(np.abs(np.asarray(ref[0])).max(),
                np.abs(np.asarray(ref[1])).max(), 1.0)
    for w, p, r in zip(walk, plain, ref):
        assert w.shape == p.shape == r.shape
        np.testing.assert_allclose(w.numpy() / scale, np.asarray(r) / scale,
                                   atol=2e-5)
        np.testing.assert_allclose(w.numpy() / scale, p.numpy() / scale,
                                   atol=2e-5)


# ---------------------------------------------------------------------------
# the f32 matvec and prepare over their tables
# ---------------------------------------------------------------------------


def _f32_table_case(NPm, seed):
    """The bench's empty [4, 128] bucket beside a ragged [8, 256] one (f32
    J and residuals, masked), two cameras; the reference's Bucket and the
    port's."""
    J, ii, ci, _, x_pose, x_intr = _bf16_case(seed, NPm, 2, T16=8, P16=256,
                                              ragged=201)
    rng = np.random.default_rng(seed + 1)
    res = rng.normal(size=(2, 8, 256)).astype(np.float32)
    res *= (J != 0).any(axis=1)
    z_idx = np.zeros((4, 128), np.int32)
    ops = dict(
        J=[np.zeros((2, 9 + NPm, 4, 128), np.float32), J],
        res=[np.zeros((2, 4, 128), np.float32), res],
        idx=[(z_idx, z_idx), (ii, ci)],
        x_pose=x_pose, x_intr=x_intr,
    )
    jb = [jbk.Bucket(jnp.asarray(a), jnp.asarray(c), *([None] * 5))
          for a, c in ops["idx"]]
    tb = [_bucket16(a, c) for a, c in ops["idx"]]
    return ops, jb, tb


def _scaled_max(arrays):
    return max(max(float(np.abs(np.asarray(a)).max()) for a in arrays), 1.0)


@pytest.mark.parametrize("NPm", [4, 9])
def test_f32_matvec_walk_matches_pallas(NPm):
    """The f32 matvec kernel's walk of its table (tiles dealt to blocks, block sums added per cluster, cluster rows in order) against
    the reference's Pallas cg_matvec_bucket (interpret mode) and
    schur_matvec's plain result, with the bench's empty [4, 128] bucket
    beside a full one. Width 9 is the mixed SIMPLE_RADIAL + OPENCV
    bundle's. Tolerance 2e-5 scaled (tests/test_cg_kernel.py:64)."""
    ops, jb, tb = _f32_table_case(NPm, 110 + NPm)
    rng = np.random.default_rng(120 + NPm)
    V_l = [rng.normal(size=(6, J.shape[-1])).astype(np.float32)
           for J in ops["J"]]
    ref = jck.schur_matvec(jb, [jnp.asarray(J) for J in ops["J"]],
                           [jnp.asarray(V) for V in V_l],
                           jnp.asarray(ops["x_pose"]),
                           jnp.asarray(ops["x_intr"]), I, 2, interpret=True)
    J_l = [torch.from_numpy(J) for J in ops["J"]]
    tV = [torch.from_numpy(V) for V in V_l]
    xp, xi = torch.from_numpy(ops["x_pose"]), torch.from_numpy(ops["x_intr"])
    tck.reset_counts()
    plain = tck.schur_matvec(tb, J_l, tV, xp, xi, I, 2)
    assert tck.LAUNCHES["matvec"] == 0
    rows, n_tiles = tck.tile_table([tuple(b.img_idx.shape) for b in tb])
    assert rows == ((4, 128, 64, 0), (8, 256, 32, 2)) and n_tiles == 10
    walk = _matvec_walk(tck.matvec_plain, rows, n_tiles, tb,
                        [J.double() for J in J_l], [v.double() for v in tV],
                        xp.double(), xi.double(), I, 2,
                        blocks=4, cluster=2)  # runs of 3 tiles
    scale = _scaled_max(ref)
    for w, p, r in zip(walk, plain, ref):
        assert w.shape == p.shape == r.shape
        np.testing.assert_allclose(w.numpy() / scale, np.asarray(r) / scale,
                                   atol=2e-5)
        np.testing.assert_allclose(w.numpy() / scale, p.numpy() / scale,
                                   atol=2e-5)


def _prepare_walk(rows, n_tiles, buckets, J_l, res_l, lam, I, C, blocks,
                  cluster):
    """prepare_kernel's walk in plain PyTorch: per tile, its columns' Vinv
    and g_pt (each column lies whole in one tile) and its image and camera
    sums; each block sums its tiles', then _cluster_order."""
    NP = J_l[0].shape[1] - 9
    dt = J_l[0].dtype
    Vinv_l = [torch.zeros((6, J.shape[-1]), dtype=dt) for J in J_l]
    g_l = [torch.zeros((3, J.shape[-1]), dtype=dt) for J in J_l]
    sums = []
    for tiles in _walk_tiles(rows, n_tiles, blocks, cluster):
        acc = [torch.zeros((I, 33), dtype=dt),
               torch.zeros((C, 2 * NP), dtype=dt)]
        for bi, cols in tiles:
            b = buckets[bi]
            part = b._replace(img_idx=b.img_idx[:, cols],
                              cam_idx=b.cam_idx[:, cols])
            v, g, oi, oc = tck.prepare_plain(part, J_l[bi][..., cols],
                                             res_l[bi][..., cols], lam, I, C)
            Vinv_l[bi][:, cols] = v
            g_l[bi][:, cols] = g
            acc = [acc[0] + oi, acc[1] + oc]
        sums.append(acc)
    acc_i, acc_c = _cluster_order(sums, cluster)
    return (Vinv_l, g_l, acc_i[:, :6], acc_c[:, :NP], acc_i[:, 6:12],
            acc_c[:, NP:], acc_i[:, 12:33])


@pytest.mark.parametrize("NPm", [4, 9])
def test_prepare_walk_matches_pallas(NPm):
    """prepare_kernel's walk of its table against the reference's Pallas
    schur_prepare_bucket (interpret mode) and schur_prepare's plain result,
    with the bench's empty [4, 128] bucket beside a full one; width 9 is
    the mixed SIMPLE_RADIAL + OPENCV bundle's. Tolerance 3e-5 scaled
    (tests/test_cg_kernel.py:176)."""
    ops, jb, tb = _f32_table_case(NPm, 130 + NPm)
    lam = 0.37
    ref = jck.schur_prepare(jb, [jnp.asarray(J) for J in ops["J"]],
                            [jnp.asarray(r) for r in ops["res"]],
                            jnp.float32(lam), I, 2, interpret=True)
    J_l = [torch.from_numpy(J) for J in ops["J"]]
    r_l = [torch.from_numpy(r) for r in ops["res"]]
    tck.reset_counts()
    plain = tck.schur_prepare(tb, J_l, r_l, torch.tensor(lam), I, 2)
    assert tck.LAUNCHES["prepare"] == 0
    rows, n_tiles = tck.tile_table([tuple(b.img_idx.shape) for b in tb])
    walk = _prepare_walk(rows, n_tiles, tb, [J.double() for J in J_l],
                         [r.double() for r in r_l],
                         torch.tensor(lam, dtype=torch.float64), I, 2,
                         blocks=4, cluster=2)
    for k in (0, 1):  # per-bucket Vinv, g_pt
        for w, p, r in zip(walk[k], plain[k], ref[k]):
            _close_scaled(w, r, 3e-5)
            _close_scaled(w, p, 3e-5)
    for w, p, r in zip(walk[2:], plain[2:], ref[2:]):
        assert w.shape == p.shape == r.shape
        _close_scaled(w, r, 3e-5)
        _close_scaled(w, p, 3e-5)


# ---------------------------------------------------------------------------
# cost and finish over their table (csrc/cost.cu: cost_kernel and
# finish_kernel, one launch over every bucket's tiles of any width)
# ---------------------------------------------------------------------------


def test_cost_table_rows():
    """The Schur kernels' tiles at any width, buckets of no tile included;
    up to 16 buckets."""
    rows, n = tck.cost_table([(4, 128), (8, 131072), (16, 77), (8, 0),
                              (64, 5)])
    assert rows == ((4, 128, 64, 0), (8, 131072, 32, 2), (16, 77, 16, 4098),
                    (8, 0, 32, 4103), (64, 5, 4, 4103)) and n == 4105
    assert tck.cost_table([(8, 0)]) == (((8, 0, 32, 0),), 0)
    assert len(tck.cost_table([(4, 128)] * 16)[0]) == 16


@pytest.mark.parametrize("shapes, why", [
    ([], "no bucket"),
    ([(4, 128)] * 17, "more buckets than the table holds"),
    ([(0, 128)], "T = 0"),
    ([(65, 128)], "T above the ladder's 64"),
    ([(8, 256), (4, -1)], "a negative width"),
])
def test_cost_table_rejects(shapes, why):
    with pytest.raises(ValueError):
        tck.cost_table(shapes)


def test_cost_launch_needs_the_card():
    """Off the card finish builds no table (the plain versions need none),
    and a table of host tensors is refused."""
    case = _case(60)
    tb = _tb(case)
    J = torch.zeros((2, 9 + NP, T, P))
    V, g = torch.zeros((6, P)), torch.zeros((3, P))
    assert tck.finish_launch([tb], [tb.points], [J], [V], [g]) is None
    with pytest.raises(ValueError, match="CUDA"):
        tck.CostLaunch("cost", [tb], [tb.points])
    with pytest.raises(ValueError, match="CUDA"):
        tck.CostLaunch("finish", [tb], [tb.points], [J], [V], [g])
    with pytest.raises(ValueError, match="shape"):
        tck.CostLaunch("finish", [tb], [tb.points], [J[..., :64]], [V], [g])


def walk_buckets(seed, I, C, Tn=8, Pn=256, n_real=201):
    """The bench's empty [4, 128] bucket beside a [Tn, Pn] one whose
    columns hold tracks of lengths 1..Tn in turn (so a tile's live slot
    rows end at different depths) up to n_real, then padding columns (mask
    0, index 0, point 0, fixed), as bucketize pads; numpy fields."""
    rng = np.random.default_rng(seed)
    lens = np.where(np.arange(Pn) < n_real, 1 + np.arange(Pn) % Tn, 0)
    live = np.arange(Tn)[:, None] < lens[None]
    full = dict(
        img_idx=np.where(live, rng.integers(0, I, (Tn, Pn)), 0),
        cam_idx=np.where(live, rng.integers(0, C, (Tn, Pn)), 0),
        xy=np.where(live, rng.normal(scale=200.0, size=(2, Tn, Pn)), 0.0),
        mask=live.astype(np.float32),
        points=np.where(lens > 0, rng.normal(size=(3, Pn)), 0.0),
        point_free=((rng.uniform(size=Pn) > 0.2) & (lens > 0)),
        point_rows=np.arange(Pn),
    )
    empty = dict(img_idx=np.zeros((4, 128)), cam_idx=np.zeros((4, 128)),
                 xy=np.zeros((2, 4, 128)), mask=np.zeros((4, 128)),
                 points=np.zeros((3, 128)), point_free=np.zeros(128),
                 point_rows=np.arange(128))
    types = dict(img_idx=np.int32, cam_idx=np.int32, point_rows=np.int32)
    return [{k: np.asarray(v, types.get(k, np.float32)) for k, v in b.items()}
            for b in (empty, full)]


def _slot_costs(b, X, itab, intr, model_id, loss_type, scale):
    """Each slot's robust cost [T, w] at points X [3, w] (plain arithmetic,
    in X's dtype)."""
    from pycolmap_torch.sfm.bundle_adjustment import _robust_cost

    q = tbk._gather_table(itab[:, :4], b.img_idx)
    t = tbk._gather_table(itab[:, 4:7], b.img_idx)
    k = tbk._gather_table(intr, b.cam_idx)
    rx, ry = tbk._residual_vals(model_id, b.xy, b.mask, q, t, k,
                                (X[0][None], X[1][None], X[2][None]))
    return _robust_cost(rx * rx + ry * ry, loss_type, scale) * b.mask


def cost_walk(rows, n_tiles, buckets, pts_l, itab, intr, model_id,
              loss_type, scale, fin=None, threads=256):
    """cost_kernel's (fin None) or finish_kernel's walk of its table in
    plain PyTorch. Per tile only its live slots are read (the J of a dead
    slot is NaN here: the kernel fetches none of it); finish adds each
    column's J_p^T J_c x over its live slots, makes the column's new point
    (also where no slot is live) and takes the slot costs there; the slot
    costs go to threads (slot g of column p: thread g tile_p + p), are
    summed per warp of 32 and the warps in order into the tile's partial.
    The partials are then added in tile order: each of `threads` threads a
    strided run, then the threads. fin: (J_l, Vinv_l, g_pt_l, x_pose,
    x_intr). Returns (new points per bucket or None, total, partials)."""
    dt = itab.dtype
    starts = [r[3] for r in rows]
    new_l = ([torch.zeros((3, r[1]), dtype=dt) for r in rows] if fin
             else None)
    partials = []
    for tile in range(n_tiles):
        bi = max(i for i, f in enumerate(starts) if f <= tile)
        Tn, Pn, tp, first = rows[bi]
        cols = slice((tile - first) * tp, min((tile - first + 1) * tp, Pn))
        b = buckets[bi]
        part = b._replace(img_idx=b.img_idx[:, cols],
                          cam_idx=b.cam_idx[:, cols], xy=b.xy[..., cols],
                          mask=b.mask[:, cols])
        live = part.mask != 0
        X = pts_l[bi][:, cols]
        if fin:
            J_l, V_l, g_l, x_pose, x_intr = fin
            nk = J_l[bi].shape[1] - 3
            J = torch.where(live, J_l[bi][..., cols], float("nan"))
            xc = torch.cat([
                torch.stack(tbk._gather_table(x_pose, part.img_idx)),
                torch.stack(tbk._gather_table(x_intr, part.cam_idx)),
            ])
            a = torch.where(live, torch.sum(J[:, :nk] * xc[None], dim=1), 0.0)
            Jp = torch.where(live, J[:, nk:nk + 3], 0.0)
            y = torch.sum(Jp[0] * a[0][None] + Jp[1] * a[1][None], dim=1)
            g = g_l[bi][:, cols]
            dp = torch.stack(tbk._sym3_apply(
                V_l[bi][:, cols], (g[0] - y[0], g[1] - y[1], g[2] - y[2])))
            X = X - dp * b.point_free[cols][None]
            new_l[bi][:, cols] = X
        c = torch.where(live, _slot_costs(part, X, itab, intr, model_id,
                                          loss_type, scale), 0.0)
        thr = torch.zeros(threads, dtype=dt)
        for gs in range(Tn):
            thr[gs * tp:gs * tp + c.shape[1]] = c[gs]
        v = torch.zeros((), dtype=dt)
        for w in thr.reshape(-1, 32):  # warps in order
            v = v + torch.sum(w)
        partials.append(v)
    per = [sum(partials[j::threads], torch.zeros((), dtype=dt))
           for j in range(threads)]
    return new_l, sum(per, torch.zeros((), dtype=dt)), partials


def check_cost_walk(tables, buckets_np, model_id, loss_type, seed,
                    atol=1e-5):
    """cost_walk against the reference's Pallas cost_bucket and
    finish_bucket (interpret mode) and the port's plain total_cost and
    backsub_and_cost on the same buckets: every new point and both costs
    within `atol` scaled. tables: (quat, trans, intr, intr_free) numpy, J
    from the reference's resjac."""
    quat, trans, intr, intr_free = tables
    NPm = solver_num_params(model_id)
    I_, C_ = quat.shape[0], intr.shape[0]
    rng = np.random.default_rng(seed)
    jb = [jbk.Bucket(**{k: jnp.asarray(v) for k, v in b.items()})
          for b in buckets_np]
    tb = [tbk.Bucket(**{k: torch.from_numpy(v) for k, v in b.items()})
          for b in buckets_np]
    _, ref_J = jck.res_and_jac(jb, [b.points for b in jb], _j(quat), _j(trans),
                               _j(intr), _j(intr_free), model_id, loss_type,
                               jnp.float32(1.5), interpret=True)
    J_l = [np.array(J) for J in ref_J]
    V_l = [rng.normal(scale=1e-3, size=(6, J.shape[-1])).astype(np.float32)
           for J in J_l]
    g_l = [rng.normal(size=(3, J.shape[-1])).astype(np.float32) for J in J_l]
    x_pose = rng.normal(scale=1e-3, size=(I_, 6)).astype(np.float32)
    x_intr = rng.normal(scale=1e-3, size=(C_, NPm)).astype(np.float32)
    x_intr *= intr_free[:, :NPm]  # the solver's step: 0 at a selector
    nq = jbm.quat_boxplus_cf(tuple(jnp.asarray(quat[:, i]) for i in range(4)),
                             tuple(jnp.asarray(-x_pose[:, i])
                                   for i in range(3)))
    new_quat = np.stack([np.asarray(a) for a in nq], axis=1)
    new_trans = trans - x_pose[:, 3:6]
    new_intr = intr[:, :NPm] - x_intr

    ref_cost = float(jck.total_cost(jb, [b.points for b in jb], _j(quat),
                                    _j(trans), _j(intr), model_id, loss_type,
                                    jnp.float32(1.5), interpret=True))
    ref_pts, ref_fin = jck.backsub_and_cost(
        jb, [b.points for b in jb], [_j(J) for J in J_l],
        [_j(V) for V in V_l], [_j(g) for g in g_l], _j(x_pose), _j(x_intr),
        _j(new_quat), _j(new_trans), _j(new_intr), model_id, loss_type,
        jnp.float32(1.5), interpret=True)
    tJ = [torch.from_numpy(J) for J in J_l]
    tV = [torch.from_numpy(V) for V in V_l]
    tg = [torch.from_numpy(g) for g in g_l]
    plain_cost = float(tck.total_cost(tb, [b.points for b in tb], _t(quat),
                                      _t(trans), _t(intr), model_id,
                                      loss_type, 1.5))
    plain_pts, plain_fin = tck.backsub_and_cost(
        tb, [b.points for b in tb], tJ, tV, tg, _t(x_pose), _t(x_intr),
        _t(new_quat), _t(new_trans), _t(new_intr), model_id, loss_type, 1.5)

    rows, n_tiles = tck.cost_table([tuple(b.mask.shape) for b in tb])
    d = lambda a: torch.from_numpy(np.asarray(a, np.float64))  # noqa: E731
    tb64 = [b._replace(xy=b.xy.double(), mask=b.mask.double(),
                       points=b.points.double(),
                       point_free=b.point_free.double()) for b in tb]
    itab = torch.cat([d(quat), d(trans)], 1)
    _, walk_cost, _ = cost_walk(rows, n_tiles, tb64,
                                [b.points for b in tb64], itab,
                                d(intr[:, :NPm]), model_id, loss_type, 1.5)
    nitab = torch.cat([d(new_quat), d(new_trans)], 1)
    walk_pts, walk_fin, _ = cost_walk(
        rows, n_tiles, tb64, [b.points for b in tb64], nitab, d(new_intr),
        model_id, loss_type, 1.5,
        fin=([J.double() for J in tJ], [V.double() for V in tV],
             [g.double() for g in tg], d(x_pose), d(x_intr)))
    for w, p, r in zip(walk_pts, plain_pts, ref_pts):
        _close_scaled(w, r, atol)
        _close_scaled(w, p, atol)
    for w, p, r in ((walk_cost, plain_cost, ref_cost),
                    (walk_fin, plain_fin, ref_fin)):
        scale = max(abs(float(r)), 1.0)
        assert abs(float(w) - float(r)) / scale <= atol
        assert abs(float(w) - float(p)) / scale <= atol
    return rows, n_tiles


@pytest.mark.parametrize("loss_type", [0, 1, 2])
def test_cost_finish_walk_matches_pallas(loss_type):
    """The cost and finish kernels' walk of their table (live slots only,
    tile partials in warp order, partials in tile order) against the
    reference's Pallas cost_bucket and finish_bucket (interpret mode) and
    the plain versions, with the bench's empty [4, 128] bucket beside a
    [8, 256] one of tracks of lengths 1..8 and 55 padding columns (its last
    tile all padding). Tolerance 1e-5 scaled."""
    case = _case(150 + loss_type)
    tables = (case["quat"], case["trans"], case["intr"], case["intr_free"])
    rows, n_tiles = check_cost_walk(tables, walk_buckets(160 + loss_type, I,
                                                         C),
                                    MODEL_ID, loss_type, 170 + loss_type)
    assert rows == ((4, 128, 64, 0), (8, 256, 32, 2)) and n_tiles == 10


def test_finish_at_zero_step_is_the_cost():
    """At x = 0 with every point fixed and the parameters unchanged, finish
    returns the points and the cost of total_cost: the plain versions
    within 1e-6 relative, and the kernels' walk to the bit (both walk the
    same tiles and add alike)."""
    case = _case(180)
    b_np = walk_buckets(181, I, C)
    tb = [tbk.Bucket(**{k: torch.from_numpy(v) for k, v in b.items()})
          for b in b_np]
    tb = [b._replace(point_free=torch.zeros_like(b.point_free)) for b in tb]
    pts = [b.points for b in tb]
    q, t, k = _t(case["quat"]), _t(case["trans"]), _t(case["intr"])
    res_l, J_l = tck.res_and_jac(tb, pts, q, t, k, _t(case["intr_free"]),
                                 MODEL_ID, 1, 1.5)
    V_l, g_l = tck.schur_prepare(tb, J_l, res_l, 0.37, I, C)[:2]
    zp, zi = torch.zeros((I, 6)), torch.zeros((C, NP))
    cost = tck.total_cost(tb, pts, q, t, k, MODEL_ID, 1, 1.5)
    new_pts, fin = tck.backsub_and_cost(tb, pts, J_l, V_l, g_l, zp, zi, q,
                                        t, k, MODEL_ID, 1, 1.5)
    for n, p in zip(new_pts, pts):
        assert torch.equal(n, p)
    assert abs(float(fin) - float(cost)) <= 1e-6 * abs(float(cost))
    rows, n_tiles = tck.cost_table([tuple(b.mask.shape) for b in tb])
    itab = torch.cat([q, t], 1)
    _, w_cost, w_parts = cost_walk(rows, n_tiles, tb, pts, itab, k[:, :NP],
                                   MODEL_ID, 1, 1.5)
    w_pts, w_fin, f_parts = cost_walk(rows, n_tiles, tb, pts, itab,
                                      k[:, :NP], MODEL_ID, 1, 1.5,
                                      fin=(J_l, V_l, g_l, zp, zi))
    assert all(torch.equal(a, b) for a, b in zip(w_parts, f_parts))
    assert torch.equal(w_cost, w_fin)
    assert all(torch.equal(a, b) for a, b in zip(w_pts, pts))


# ---------------------------------------------------------------------------
# resjac over its table (csrc/resjac.cu: one launch over every bucket, one
# thread per track slot, blocks of (bucket, slot row, run of 256 columns))
# ---------------------------------------------------------------------------


def test_resjac_table_rows():
    """The incremental mapper's global-step buckets at NP 4: T blocks of
    ceil(P / 256) runs per bucket, in bucket order; each bucket's residual
    and then its Jacobian in one allocation, every view on 64 floats."""
    rows, n_blocks, n_floats = tck.resjac_table(
        [(4, 128), (8, 128), (16, 128), (32, 2048)], 4)
    assert rows == ((4, 128, 1, 0, 0, 1024),
                    (8, 128, 1, 4, 14336, 16384),
                    (16, 128, 1, 12, 43008, 47104),
                    (32, 2048, 8, 28, 100352, 231424))
    assert n_blocks == 284 and n_floats == 1935360


def test_resjac_table_ragged():
    """An empty [4, 128] bucket (every slot masked) beside widths that are
    no multiple of 256 and a bucket of no column: the views tile the
    allocation in order without overlap, each on a multiple of 64 floats,
    and the blocks cover every (bucket, slot row, run) once."""
    shapes = [(4, 128), (8, 1000), (16, 77), (8, 0), (64, 5)]
    NPm = 9
    rows, n_blocks, n_floats = tck.resjac_table(shapes, NPm)
    res_v, J_v = tck.resjac_views(rows, NPm)
    end, first = 0, 0
    for (T_, P_), row, rv, jv in zip(shapes, rows, res_v, J_v):
        assert row[:4] == (T_, P_, -(-P_ // 256), first)
        first += T_ * row[2]
        for size, stride, off in (rv, jv):
            assert off % 64 == 0 and off >= end
            n = int(np.prod(size))
            assert stride == tuple(int(np.prod(size[k + 1:]))
                                   for k in range(len(size)))
            end = off + n
    assert n_blocks == first == 4 + 32 + 16 + 0 + 64 and end <= n_floats
    assert n_floats - end < 64


@pytest.mark.parametrize("shapes, why", [
    ([], "no bucket"),
    ([(4, 128)] * 17, "more buckets than the table holds"),
    ([(0, 128)], "T = 0"),
    ([(8, 256), (4, -1)], "a negative width"),
])
def test_resjac_table_rejects(shapes, why):
    with pytest.raises(ValueError):
        tck.resjac_table(shapes, 4)


def test_resjac_launch_needs_the_card():
    """Off the card the LM solve builds no table (the plain version needs
    none), and a table of host tensors is refused."""
    case = _case(70)
    tb = _tb(case)
    assert tck.resjac_launch([tb], MODEL_ID) is None
    with pytest.raises(ValueError, match="CUDA"):
        tck.ResJacLaunch([tb], NP)
    with pytest.raises(ValueError, match="shape"):
        tck.ResJacLaunch([tb._replace(xy=tb.xy[..., :64])], NP)


def resjac_walk(rows, n_blocks, n_floats, buckets, pts_l, itab, intr, ifree,
                model_id, loss_type, scale):
    """resjac_kernel's walk of its table in plain PyTorch: block -> (bucket,
    slot row t, run of 256 columns); each thread p < P of a block writes
    its slot's residual and Jacobian (resjac_plain on that row's columns: a
    dead slot gives zeros) into one allocation, which starts as NaN so that
    a slot no block writes shows. Returns the views (res_l, J_l)."""
    NPm = solver_num_params(model_id)
    intr, ifree = intr[:, :NPm], ifree[:, :NPm]
    out = torch.full((n_floats,), float("nan"), dtype=itab.dtype)
    res_v, J_v = tck.resjac_views(rows, NPm)
    res_l = [out.as_strided(*v) for v in res_v]
    J_l = [out.as_strided(*v) for v in J_v]
    starts = [r[3] for r in rows]
    for blk in range(n_blocks):
        bi = max(i for i, f in enumerate(starts)
                 if f <= blk and rows[i][2])
        Tn, Pn, runs, first = rows[bi][:4]
        t, run = divmod(blk - first, runs)
        cols = slice(run * 256, min((run + 1) * 256, Pn))
        b = buckets[bi]
        part = b._replace(img_idx=b.img_idx[t:t + 1, cols],
                          cam_idx=b.cam_idx[t:t + 1, cols],
                          xy=b.xy[:, t:t + 1, cols], mask=b.mask[t:t + 1, cols],
                          point_free=b.point_free[cols])
        r, J = tck.resjac_plain(part, pts_l[bi][:, cols], itab, intr, ifree,
                                model_id, loss_type, scale)
        res_l[bi][:, t:t + 1, cols] = r
        J_l[bi][:, :, t:t + 1, cols] = J
    return res_l, J_l


def _resjac_buckets(seed, I_, C_):
    """An empty [4, 128] bucket (every slot masked, index 0), a [8, 256] one
    of tracks of lengths 1..8 and 55 padding columns, and a [4, 256] one
    with ~30% mask holes and ~20% fixed points; numpy fields."""
    rng = np.random.default_rng(seed)
    empty, ragged = walk_buckets(seed, I_, C_)
    holes = dict(
        img_idx=rng.integers(0, I_, (4, 256)).astype(np.int32),
        cam_idx=rng.integers(0, C_, (4, 256)).astype(np.int32),
        xy=rng.normal(scale=200.0, size=(2, 4, 256)).astype(np.float32),
        mask=(rng.uniform(size=(4, 256)) > 0.3).astype(np.float32),
        points=rng.normal(size=(3, 256)).astype(np.float32),
        point_free=(rng.uniform(size=256) > 0.2).astype(np.float32),
        point_rows=np.arange(256, dtype=np.int32),
    )
    return [empty, ragged, holes]


def _mixed_tables(seed, models, C_):
    """Intrinsics [C, NP] of C cameras cycling through `models` (the
    selector column last; the last camera's names no listed model) and
    their free flags, 0 at the selector."""
    from pycolmap_torch.ops.camera_models import CAMERA_MODEL_BY_ID

    rng = np.random.default_rng(seed)
    NPm = solver_num_params(models)
    intr = np.zeros((C_, NPm), np.float32)
    for c in range(C_):
        info = CAMERA_MODEL_BY_ID[models[c % len(models)]]
        for i in info.focal_idxs:
            intr[c, i] = 400.0 + 30.0 * rng.normal()
        intr[c, info.principal_idxs[0]] = 320.0
        intr[c, info.principal_idxs[1]] = 240.0
        for i in info.extra_idxs:
            intr[c, i] = rng.uniform(-0.05, 0.05)
        intr[c, NPm - 1] = info.model_id
    intr[C_ - 1, NPm - 1] = min(set(range(11)) - set(models))
    intr_free = (rng.uniform(size=(C_, NPm)) > 0.3).astype(np.float32)
    intr_free[:, NPm - 1] = 0.0
    return intr, intr_free


@pytest.mark.parametrize("model_id", [MODEL_ID, (2, 4)],
                         ids=["single", "mixed"])
def test_resjac_buckets_match_pallas(model_id):
    """res_and_jac over several buckets, one of them empty, against the
    reference's res_and_jac (its Pallas resjac_bucket in interpret mode)
    at 1e-5 scaled, single-model (SIMPLE_RADIAL) and mixed (SIMPLE_RADIAL
    and OPENCV plus a camera naming no listed model, width 9); exact zeros
    at every masked slot; and the kernel's walk of its table, which every
    slot of every bucket reaches once, equal to it bit for bit."""
    case = _case(80)
    if isinstance(model_id, tuple):
        C_ = 3
        intr, intr_free = _mixed_tables(81, model_id, C_)
    else:
        C_ = C
        intr, intr_free = case["intr"], case["intr_free"]
    quat, trans = case["quat"], case["trans"]
    b_np = _resjac_buckets(82, I, C_)
    jb = [jbk.Bucket(**{k: jnp.asarray(v) for k, v in b.items()})
          for b in b_np]
    tb = [tbk.Bucket(**{k: torch.from_numpy(v) for k, v in b.items()})
          for b in b_np]
    ref_res, ref_J = jck.res_and_jac(
        jb, [b.points for b in jb], _j(quat), _j(trans), _j(intr),
        _j(intr_free), model_id, 1, jnp.float32(1.5), interpret=True)
    tck.reset_counts()
    got_res, got_J = tck.res_and_jac(
        tb, [b.points for b in tb], _t(quat), _t(trans), _t(intr),
        _t(intr_free), model_id, 1, 1.5)
    assert not any(tck.LAUNCHES.values())
    NPm = solver_num_params(model_id)
    for b, gr, gJ, rr, rJ in zip(tb, got_res, got_J, ref_res, ref_J):
        assert gJ.shape == (2, 9 + NPm) + tuple(b.mask.shape)
        _close_scaled(gr, rr, 1e-5)
        _close_scaled(gJ, rJ, 1e-5)
        dead = b.mask == 0
        assert not gr[:, dead].any() and not gJ[:, :, dead].any()
    assert not got_J[0].any()  # the empty bucket
    rows, n_blocks, n_floats = tck.resjac_table(
        [tuple(b.mask.shape) for b in tb], NPm)
    itab = torch.cat([_t(quat), _t(trans)], 1)
    w_res, w_J = resjac_walk(rows, n_blocks, n_floats, tb,
                             [b.points for b in tb], itab, _t(intr),
                             _t(intr_free), model_id, 1, 1.5)
    for a, b in zip(w_res + w_J, got_res + got_J):
        assert torch.equal(a, b)
