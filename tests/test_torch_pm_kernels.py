"""The port's PatchMatch window cost (pycolmap_torch/mvs/pm_kernels.py, its
plain version on the CPU) against the reference's XLA formulation and its
Pallas kernel in interpret mode, on the reference test's scenes
(tests/test_pm_kernels.py: 40x60, K = 2, radius 2 / step 2).

Tolerances and mask are the reference test's own: interior pixels (the XLA
path's rolled window planes wrap at the border; the kernels compute the
offset rays) whose XLA cost is below 1.99; 5e-3 against the XLA path and
the exact-f32 Pallas path, 2.5e-2 against the default bf16-pair-packed one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycolmap_tpu.mvs import patch_match as pm_ref
from pycolmap_torch.mvs import patch_match as pm
from pycolmap_torch.mvs import pm_kernels as pmk

from test_pm_kernels import _scene, _window_stats

H, W, K = 40, 60, 2
RADIUS, STEP = 2, 2


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch intra-op thread per test: the suite runs test files in
    parallel workers, where every worker's thread pool would contend for
    the host's cores (a 20 s test took 21 minutes so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fronto(H, W):
    return np.full((H, W), 5.0)


def _ramp(H, W):
    return 4.0 + 2.0 * np.linspace(0, 1, W)[None, :] * np.ones((H, 1))


def _facing(rays):
    return -rays / np.linalg.norm(rays, axis=0)


def _slanted(rays):
    n = np.array([0.35, 0.15, -1.0], np.float32)
    n /= np.linalg.norm(n)
    return np.broadcast_to(n[:, None, None], rays.shape).copy()


SCENES = {
    "fronto": (False, _fronto, _facing),
    "slanted": (False, _ramp, _slanted),
    "geometric": (True, _fronto, _facing),
}


def _case(name):
    geom, depth_field, normal_field = SCENES[name]
    ref, srcs, rays, Kmat, R_rel, t_rel = _scene(H, W, K)
    depth = depth_field(H, W).astype(np.float32)
    normal = normal_field(rays).astype(np.float32)
    src_depths = np.broadcast_to(depth[None], (K, H, W)).copy()
    return dict(geom=geom, ref=ref, srcs=srcs, rays=rays, Kmat=Kmat,
                R_rel=R_rel, t_rel=t_rel, depth=depth, normal=normal,
                src_depths=src_depths, Ks=np.stack([Kmat] * K))


def _reference_costs(c, kind):
    offsets = pm_ref._window_offsets(RADIUS, STEP)
    sg = (max(RADIUS, 1) / 1.5) ** 2
    ref_j = jnp.asarray(c["ref"])
    ref_off, w_off, w_sum, ref_mean, ref_var = _window_stats(
        ref_j, offsets, sg, jnp.float32(0.2))
    j = jnp.asarray
    geom_w, geom_max = jnp.float32(0.3), jnp.float32(3.0)
    if kind == "xla":
        rays_j = j(c["rays"])
        rays_off = jnp.stack(
            [jnp.roll(rays_j, (-dy, -dx), axis=(1, 2)) for dy, dx in offsets])
        out = pm_ref.view_costs_xla(
            j(c["depth"]), j(c["normal"]), j(c["srcs"]), rays_j, j(c["R_rel"]),
            j(c["t_rel"]), j(c["Ks"]), rays_off, ref_off, w_off, w_sum,
            ref_mean, ref_var, c["geom"], j(c["Kmat"]),
            j(np.linalg.inv(c["Ks"])), j(c["src_depths"]), geom_w, geom_max)
    else:
        vc = pm_ref.make_pallas_view_costs(
            ref_j, j(c["srcs"]), j(c["rays"]), j(c["Ks"]), j(c["R_rel"]),
            j(c["t_rel"]), j(c["Kmat"]), w_off, ref_off, w_sum, ref_mean,
            ref_var, offsets, jnp.float32(0.2), c["geom"],
            j(c["src_depths"]), geom_w, geom_max, RADIUS, interpret=True,
            pack_pairs=kind == "packed")
        out = vc(j(c["depth"]), j(c["normal"]))
    return np.asarray(out)


def _port_costs(c, parity=None):
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    offsets = pm._window_offsets(RADIUS, STEP)
    ref_off, w_off, w_sum, ref_mean, ref_var = pm.window_stats(
        t(c["ref"]), offsets, RADIUS, 0.2)
    params = pmk.pm_view_params(t(c["R_rel"]), t(c["t_rel"]), t(c["Ks"]),
                                t(c["Kmat"]), 0.2, 0.3, 3.0)
    out = pmk.pm_view_costs(
        t(c["srcs"]), t(c["src_depths"]) if c["geom"] else None, w_off,
        w_off * ref_off, t(c["depth"]), t(c["normal"]),
        torch.stack([w_sum, ref_mean, ref_var]), params,
        torch.as_tensor(offsets, dtype=torch.float32), geom=c["geom"],
        parity=parity)
    return out.numpy()


@pytest.mark.parametrize("kind,atol", [("xla", 5e-3), ("exact", 5e-3),
                                       ("packed", 2.5e-2)])
@pytest.mark.parametrize("scene", list(SCENES))
def test_cost_matches_reference(scene, kind, atol):
    c = _case(scene)
    got = _port_costs(c)
    assert got.shape == (K, H, W) and np.isfinite(got).all()
    m = RADIUS + 1
    a = _reference_costs(c, "xla")[:, m:-m, m:-m]
    b = _reference_costs(c, kind)[:, m:-m, m:-m] if kind != "xla" else a
    g = got[:, m:-m, m:-m]
    valid = a < 1.99
    assert valid.mean() > 0.7
    np.testing.assert_allclose(g[valid], b[valid], atol=atol, rtol=0)


def test_cost_whole_image_against_exact_pallas():
    """Where the Pallas kernel's window fits its band (every pixel of this
    small scene), the port equals it on the whole image, borders included:
    both compute the offset rays and zero-pad the sources."""
    c = _case("slanted")
    got = _port_costs(c)
    exact = _reference_costs(c, "exact")
    np.testing.assert_allclose(got, exact, atol=5e-3, rtol=0)


def test_window_stats_match_reference():
    ref, *_ = _scene(H, W, K)
    for radius, step in ((2, 2), (5, 2)):
        offsets = pm._window_offsets(radius, step)
        np.testing.assert_array_equal(offsets,
                                      pm_ref._window_offsets(radius, step))
        sg = (max(radius, 1) / 1.5) ** 2
        want = _window_stats(jnp.asarray(ref), offsets, sg, jnp.float32(0.2))
        got = pm.window_stats(torch.from_numpy(ref), offsets, radius, 0.2)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                       rtol=1e-6)


def test_view_params_match_reference():
    _, _, _, Kmat, R_rel, t_rel = _scene(H, W, K)
    Ks = np.stack([Kmat * 1.1, Kmat * 0.9])
    Ks[:, 2, 2] = 1.0
    want = np.asarray(pm_ref._pm_view_params(
        jnp.asarray(R_rel), jnp.asarray(t_rel), jnp.asarray(Ks),
        jnp.asarray(Kmat), jnp.float32(0.2), jnp.float32(0.3),
        jnp.float32(3.0)))
    got = pmk.pm_view_params(torch.from_numpy(R_rel), torch.from_numpy(t_rel),
                             torch.from_numpy(Ks), torch.from_numpy(Kmat),
                             0.2, 0.3, 3.0).numpy()
    assert got.shape == (K, 32) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_wrapper_checks_shapes_and_counts():
    c = _case("fronto")
    pmk.reset_counts()
    _port_costs(c)
    _port_costs(c, parity=1)
    assert pmk.LAUNCHES == {"pm_cost": 0, "pm_cost_parity": 0}
    assert pmk.PLAIN_ON_CUDA["pm_cost"] == 0
    with pytest.raises(ValueError):
        _port_costs(c, parity=2)
    z = torch.zeros
    with pytest.raises(ValueError):
        pmk.pm_view_costs(z(2, 8, 9), None, z(4, 8, 9), z(4, 8, 9), z(8, 9),
                          z(3, 8, 9), z(3, 8, 9), z(2, 32), z(5, 2))
    with pytest.raises(ValueError):
        pmk.pm_view_costs(z(2, 8, 9), None, z(4, 8, 9), z(4, 8, 9), z(8, 9),
                          z(3, 8, 9), z(3, 8, 9), z(2, 32), z(4, 2), geom=True)


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("scene", list(SCENES))
def test_plain_parity_keeps_active_pixels(scene, parity):
    """With a parity the plain version equals the full field exactly at the
    pixels with (y + x) % 2 == parity and is 2.0 at the others (geometric
    term included)."""
    c = _case(scene)
    full = _port_costs(c)
    got = _port_costs(c, parity=parity)
    active = (np.arange(H)[:, None] + np.arange(W)[None, :]) % 2 == parity
    np.testing.assert_array_equal(got[:, active], full[:, active])
    assert np.all(got[:, ~active] == 2.0)
    assert np.any(full[:, ~active] != 2.0)


def test_patch_match_same_with_and_without_parity(monkeypatch):
    """patch_match_kernel on a small scene gives the same depth, normal and
    cost, bit for bit, when its candidates' costs cover every pixel (the
    full-field function injected here) as with the parity path: a step
    keeps a candidate only at the pixels of its colour."""
    ref, srcs, rays, Kmat, R_rel, t_rel = _scene(H, W, K)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    depth0 = np.full((H, W), 5.0, np.float32)
    normal0 = -rays / np.linalg.norm(rays, axis=0)
    parities = []

    def run(geom):
        args = (t(ref), t(srcs), t(rays), t(np.stack([Kmat] * K)), t(R_rel),
                t(t_rel), t(depth0), t(normal0), 1.0, 10.0, 0.2, 0.6, 1,
                RADIUS, STEP)
        kw = dict(Kr=t(Kmat))
        if geom:
            kw.update(geom_consistency=True,
                      src_depths=t(np.full((K, H, W), 5.0)))
        return pm.patch_match_kernel(torch.Generator().manual_seed(4), *args,
                                     **kw)

    def full_field(*args, parity=None, **kw):
        parities.append(parity)
        return pmk.pm_view_costs(*args, **kw)

    for geom in (False, True):
        with_parity = run(geom)
        with monkeypatch.context() as m:
            m.setattr(pm, "pm_view_costs", full_field)
            parities.clear()
            without = run(geom)
        # one refresh and seven candidates per step, two steps
        assert parities == [None, 0, 0, 0, 0, 0, 0, 0,
                            None, 1, 1, 1, 1, 1, 1, 1]
        for a, b in zip(with_parity, without):
            assert torch.equal(a, b)
