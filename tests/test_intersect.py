"""The two intersection routes of Scene.intersect_route, against oracles.

"brute" (scene/intersect.chunked_intersect / chunked_occluded, a scan over
64-triangle chunks) is checked against a float64 NumPy Möller-Trumbore
oracle; "xla-walk" (bvh_intersect / bvh_occluded, the skip-link BVH walk)
against the chunked brute force on a mesh above the brute-force cap."""
import numpy as np
import jax.numpy as jnp
import pytest

from mitsuba3_plt_tpu.scene import intersect as isect
from mitsuba3_plt_tpu.scene import shape as shp
from mitsuba3_plt_tpu.scene.bvh import build_bvh


def _soup(subdiv):
    mesh = shp.make_sphere(subdiv=subdiv)
    f = np.asarray(mesh.faces)
    v = np.asarray(mesh.vertices, np.float32)
    return v, f, v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]


def _packed(p0, p1, p2, chunk=64):
    rows = np.concatenate([p0, p1 - p0, p2 - p0], axis=-1).astype(np.float32)
    pad = (-len(rows)) % chunk
    return jnp.asarray(np.concatenate([rows, np.zeros((pad, 9), np.float32)]))


def _np_closest(p0, p1, p2, o, d, maxt):
    """Float64 Möller-Trumbore over every triangle: (t, prim, u, v)."""
    p0, p1, p2, o, d = (np.asarray(x, np.float64) for x in (p0, p1, p2, o, d))
    e1, e2 = p1 - p0, p2 - p0                           # [F, 3]
    pvec = np.cross(d[:, None, :], e2[None])            # [N, F, 3]
    det = np.einsum("fk,nfk->nf", e1, pvec)
    ok = np.abs(det) > 1e-12
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    tvec = o[:, None, :] - p0[None]
    u = np.einsum("nfk,nfk->nf", tvec, pvec) * inv
    qvec = np.cross(tvec, e1[None])
    v = np.einsum("nk,nfk->nf", d, qvec) * inv
    t = np.einsum("fk,nfk->nf", e2, qvec) * inv
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0) & (
        t < np.asarray(maxt, np.float64)[:, None])
    t = np.where(hit, t, np.inf)
    prim = np.argmin(t, axis=-1)
    rows = np.arange(len(o))
    tb = t[rows, prim]
    found = np.isfinite(tb)
    return (tb, np.where(found, prim, -1), u[rows, prim], v[rows, prim])


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 3.0
    d = rng.normal(size=(n, 3)) * 0.4 - o          # mostly toward the sphere
    d[n // 2:] = rng.normal(size=(n - n // 2, 3))  # half random
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


@pytest.fixture(scope="module")
def soup320():
    return _soup(2)  # 320 faces


def test_chunked_closest_matches_numpy_oracle(soup320):
    _, _, p0, p1, p2 = soup320
    o, d = _rays(512, seed=0)
    maxt = jnp.full((512,), jnp.inf)
    t, prim, u, v = map(np.asarray, isect.chunked_intersect(
        _packed(p0, p1, p2), o, d, maxt))
    t0, prim0, u0, v0 = _np_closest(p0, p1, p2, o, d, maxt)
    np.testing.assert_array_equal(prim >= 0, prim0 >= 0)
    assert (prim == prim0).mean() > 0.995  # shared-edge ties may differ
    hit = prim0 >= 0
    np.testing.assert_allclose(t[hit], t0[hit], rtol=1e-4, atol=1e-5)
    same = (prim == prim0) & hit
    np.testing.assert_allclose(u[same], u0[same], atol=1e-3)
    np.testing.assert_allclose(v[same], v0[same], atol=1e-3)


def test_chunked_anyhit_matches_numpy_oracle(soup320):
    _, _, p0, p1, p2 = soup320
    o, d = _rays(512, seed=1)
    rng = np.random.default_rng(2)
    # maxt lands some rays before the sphere and some beyond it
    maxt = jnp.asarray(rng.uniform(1.0, 5.0, 512).astype(np.float32))
    occ = np.asarray(isect.chunked_occluded(_packed(p0, p1, p2), o, d, maxt))
    _, prim0, _, _ = _np_closest(p0, p1, p2, o, d, maxt)
    assert (occ == (prim0 >= 0)).mean() > 0.995  # boundary-t ties only
    assert occ.any() and not occ.all()


def test_chunked_single_triangle_edge_cases():
    """One triangle padded to a whole chunk: an interior hit with exact
    (t, u, v), a miss beside it, a hit beyond maxt, a ray parallel to the
    plane, and a ray starting behind the triangle facing away."""
    tri = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    packed = _packed(tri[0:1], tri[1:2], tri[2:3])
    o = jnp.asarray([[0.2, 0.3, -1.0], [5.0, 5.0, -1.0], [0.2, 0.2, -1.0],
                     [0.2, 0.2, -1.0], [0.2, 0.2, -1.0]], jnp.float32)
    d = jnp.asarray([[0, 0, 1], [0, 0, 1], [0, 0, 1], [1, 0, 0],
                     [0, 0, -1]], jnp.float32)
    maxt = jnp.asarray([np.inf, np.inf, 0.5, np.inf, np.inf], jnp.float32)
    t, prim, u, v = map(np.asarray, isect.chunked_intersect(packed, o, d, maxt))
    np.testing.assert_array_equal(prim, [0, -1, -1, -1, -1])
    np.testing.assert_allclose([t[0], u[0], v[0]], [1.0, 0.2, 0.3], atol=1e-6)
    occ = np.asarray(isect.chunked_occluded(packed, o, d, maxt))
    np.testing.assert_array_equal(occ, [True, False, False, False, False])


@pytest.fixture(scope="module")
def sphere20k():
    v, f, p0, p1, p2 = _soup(5)  # 20480 faces, above the brute-force cap
    bvh = build_bvh(v, f)
    return bvh, p0, p1, p2


def _walk_vs_brute(sphere20k, o, d, maxt):
    bvh, p0, p1, p2 = sphere20k
    walk = isect.bvh_intersect(bvh, jnp.asarray(p0), jnp.asarray(p1),
                               jnp.asarray(p2), o, d, maxt)
    brute = isect.chunked_intersect(_packed(p0, p1, p2), o, d, maxt)
    return [np.asarray(x) for x in walk], [np.asarray(x) for x in brute]


def test_bvh_walk_closest_matches_brute(sphere20k):
    o, d = _rays(1024, seed=3)
    maxt = jnp.full((1024,), jnp.inf)
    (t, prim, u, _), (t0, prim0, u0, _) = _walk_vs_brute(sphere20k, o, d, maxt)
    hit = prim0 >= 0
    np.testing.assert_array_equal(prim >= 0, hit)
    np.testing.assert_allclose(t[hit], t0[hit], rtol=1e-5, atol=1e-6)
    # same prim everywhere except shared-edge ties (equal t)
    same = prim == prim0
    assert np.all(same | np.isclose(t, t0, rtol=1e-5, atol=1e-6))
    np.testing.assert_allclose(u[same & hit], u0[same & hit], atol=1e-4)


def test_bvh_walk_anyhit_matches_brute(sphere20k):
    bvh, p0, p1, p2 = sphere20k
    o, d = _rays(1024, seed=4)
    rng = np.random.default_rng(5)
    maxt = jnp.asarray(rng.uniform(1.0, 5.0, 1024).astype(np.float32))
    occ = np.asarray(isect.bvh_occluded(
        bvh, jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(p2), o, d, maxt))
    occ0 = np.asarray(isect.chunked_occluded(_packed(p0, p1, p2), o, d, maxt))
    assert (occ == occ0).mean() > 0.998  # boundary-t ties only
    assert occ.any() and not occ.all()


def test_bvh_walk_missing_rays(sphere20k):
    """Rays that point away from the sphere, or stop before it, miss."""
    o, d = _rays(256, seed=6)
    away = o / jnp.linalg.norm(o, axis=-1, keepdims=True)
    short = jnp.full((256,), 0.5)  # the surface is >= 2 away from |o| = 3
    for dirs, maxt in ((away, jnp.full((256,), jnp.inf)),
                       (d, short)):
        (t, prim, _, _), (_, prim0, _, _) = _walk_vs_brute(
            sphere20k, o, dirs, maxt)
        assert np.all(prim == -1) and np.all(prim0 == -1)
        assert np.all(np.isinf(t) | (t >= np.asarray(maxt)))
