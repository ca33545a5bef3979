"""Visibility (silhouette) gradients for geometry parameters.

The interior term of a geometry derivative comes for free from `jax.grad`
through the render (ad/render.py): shading, foreshortening, normals. What
naive AD misses is the BOUNDARY term — the radiance jump swept by a moving
silhouette — which is exactly why the reference grew its projective-sampling
machinery (PSIntegrator, src/python/python/ad/integrators/common.py:785-1298,
direct_projective/prb_projective, scene silhouette API
src/render/scene.cpp:369-434).

Array formulation (edge sampling of the primary-visibility boundary):

    dI/dtheta = interior(AD)  +  sum over view silhouettes of
                w(px) * (L_minus - L_plus) * (n_hat . d px(theta)/d theta) dl

sampled uniformly by 3D edge length; the radiance jump is probed with two
rays offset +-delta pixels across the projected edge, and the edge-point
screen velocity is pulled back to the triangle-soup vertex rows with a
per-sample `jax.vjp` of the camera projection. Everything is one fixed-shape
wavefront — no per-lane control flow.

Scope: perspective sensors. `primary_boundary_grad` covers camera-visibility
silhouettes; `nee_boundary_grad` covers shadow silhouettes of occluders
under point-like emitters (the same screen-space estimator driven through
the light->edge->receiver extension; FD-validated in
tests/test_projective.py::test_nee_boundary_grad_vs_fd);
`area_nee_boundary_grad` covers area-light penumbra boundaries via
(edge, emitter-point) pair sampling with a closed-form visibility jump
(FD-validated), and `area_nee_boundary_grad_guided` adds the reference's
guiding role (ad/guiding.py) as a two-pass pilot-mass edge sampler.
Cotangents for a shared vertex land on the sampled edge's OWN face rows —
correct for any parameterization that moves coincident soup rows together
(translations, LargeSteps vertex fields).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict

import numpy as np
import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..core.rng import Sampler
from ..librender.records import Ray


# ---------------------------------------------------------------------------
# host-side edge extraction
# ---------------------------------------------------------------------------

_EDGE_CACHE: Dict[int, Any] = {}


def build_edges(geo):
    """Unique-edge table of the triangle soup (host, numpy).

    Soup rows duplicate shared vertices, so edges are matched by quantized
    endpoint coordinates. Returns dict of arrays:
      a_face, a_corner, b_face, b_corner [E] — provenance of both endpoints
      (corner k of face f is tri_p{k}[f]),
      f1, f2 [E] — adjacent faces (f2 = -1 for open edges).
    """
    p = [np.asarray(geo.tri_p0), np.asarray(geo.tri_p1),
         np.asarray(geo.tri_p2)]
    F = p[0].shape[0]

    def q(x):  # quantized coordinate key
        return tuple(np.round(np.asarray(x, np.float64) * 1e5).astype(
            np.int64).tolist())

    edges = {}
    for f in range(F):
        for c in range(3):
            va, vb = p[c][f], p[(c + 1) % 3][f]
            ka, kb = q(va), q(vb)
            if ka == kb:
                continue  # degenerate
            key = (ka, kb) if ka < kb else (kb, ka)
            rec = edges.setdefault(key, [])
            rec.append((f, c))

    a_face, a_corner, b_face, b_corner, f1, f2 = [], [], [], [], [], []
    for key, recs in edges.items():
        f, c = recs[0]
        a_face.append(f)
        a_corner.append(c)
        b_face.append(f)
        b_corner.append((c + 1) % 3)
        f1.append(f)
        f2.append(recs[1][0] if len(recs) > 1 else -1)

    out = dict(
        a_face=np.asarray(a_face, np.int32),
        a_corner=np.asarray(a_corner, np.int32),
        b_face=np.asarray(b_face, np.int32),
        b_corner=np.asarray(b_corner, np.int32),
        f1=np.asarray(f1, np.int32),
        f2=np.asarray(f2, np.int32),
    )
    return out


def _edges_for(scene):
    import hashlib

    # content-keyed (id() recycles after GC and would alias across scenes)
    key = hashlib.sha1(np.asarray(scene.geo.tri_p0).tobytes()).digest()
    if key not in _EDGE_CACHE:
        _EDGE_CACHE.clear()  # single-entry cache
        _EDGE_CACHE[key] = build_edges(scene.geo)
    return _EDGE_CACHE[key]


# ---------------------------------------------------------------------------
# camera projection (perspective)
# ---------------------------------------------------------------------------

def _project_px(sensor, x):
    """World point [.., 3] -> continuous pixel coords [.., 2] (+ depth).

    Inverse of Sensor.sample_ray's perspective mapping (librender/sensor.py):
    u = (1 - x_c/(z_c tx))/2 - ppo_x, scaled by resolution.
    """
    R = sensor.to_world[:3, :3]
    t = sensor.to_world[:3, 3]
    xc = (x - t) @ R  # camera frame (R orthonormal)
    z = xc[..., 2]
    tx = sensor.tan_half_x
    ty = sensor.tan_half_x / sensor.aspect
    u = (1.0 - xc[..., 0] / (jnp.maximum(z, 1e-6) * tx)) * 0.5 - sensor.ppo[0]
    v = (1.0 - xc[..., 1] / (jnp.maximum(z, 1e-6) * ty)) * 0.5 - sensor.ppo[1]
    w, h = sensor.resolution
    return jnp.stack([u * w, v * h], axis=-1), z


# ---------------------------------------------------------------------------
# boundary gradient estimator
# ---------------------------------------------------------------------------

def primary_boundary_grad(
    scene,
    integrator_sample,
    grad_image,
    key: int | Any = 0,
    n_samples: int = 1 << 14,
    cfg: RenderConfig = RenderConfig(),
    delta_px: float = 0.35,
):
    """Boundary-term cotangents {tri_p0, tri_p1, tri_p2: [F, 3]} for
    d(loss)/d(vertex rows), where loss = sum(grad_image * image).

    grad_image: [H, W, C] adjoint of the loss w.r.t. the developed image.
    """
    ed = _edges_for(scene)
    geo = scene.geo
    sensor = scene.sensor
    wpx, hpx = sensor.resolution
    tri_p = (geo.tri_p0, geo.tri_p1, geo.tri_p2)

    a_face = jnp.asarray(ed["a_face"])
    a_corner = jnp.asarray(ed["a_corner"])
    b_face = jnp.asarray(ed["b_face"])
    b_corner = jnp.asarray(ed["b_corner"])
    f1 = jnp.asarray(ed["f1"])
    f2 = jnp.asarray(ed["f2"])

    def corner_pos(face, corner):
        stacked = jnp.stack(
            [p[face] for p in tri_p], axis=0
        )  # [3, E, 3]
        return jnp.take_along_axis(
            stacked, corner[None, :, None].astype(jnp.int32), axis=0
        )[0]

    pa_all = corner_pos(a_face, a_corner)  # [E, 3]
    pb_all = corner_pos(b_face, b_corner)
    elen = jnp.linalg.norm(pb_all - pa_all, axis=-1)
    cum = jnp.cumsum(elen)
    total_len = cum[-1]

    sampler = Sampler.create(int(key), n_samples)
    r_e = sampler.next_1d(0)
    r_u = sampler.next_1d(1)

    e_idx = jnp.searchsorted(cum, r_e * total_len)
    e_idx = jnp.clip(e_idx, 0, elen.shape[0] - 1).astype(jnp.int32)
    u = r_u

    pa = pa_all[e_idx]
    pb = pb_all[e_idx]
    x = pa + (pb - pa) * u[:, None]

    # silhouette test w.r.t. the camera origin
    cam_o = sensor.to_world[:3, 3]
    view = x - cam_o
    fn = geo.face_n
    s1 = jnp.sum(fn[f1[e_idx]] * view, axis=-1)
    f2e = f2[e_idx]
    s2 = jnp.sum(fn[jnp.maximum(f2e, 0)] * view, axis=-1)
    sil = jnp.where(f2e >= 0, s1 * s2 < 0.0, True)

    # projection + on-screen check
    px, z = _project_px(sensor, x)
    pa_px, _ = _project_px(sensor, pa)
    pb_px, _ = _project_px(sensor, pb)
    on_screen = (
        (z > 1e-4)
        & (px[:, 0] > 0.5) & (px[:, 0] < wpx - 0.5)
        & (px[:, 1] > 0.5) & (px[:, 1] < hpx - 0.5)
    )

    e2d = pb_px - pa_px
    e2d_len = jnp.linalg.norm(e2d, axis=-1)
    n2d = jnp.stack([-e2d[:, 1], e2d[:, 0]], axis=-1) / jnp.maximum(
        e2d_len, 1e-9
    )[:, None]

    # visibility of the edge point from the camera
    dist = jnp.linalg.norm(view, axis=-1)
    vdir = view / jnp.maximum(dist, 1e-9)[:, None]
    occ = scene.ray_test(
        Ray(
            o=jnp.broadcast_to(cam_o, x.shape),
            d=vdir,
            maxt=dist * (1.0 - 1e-3),
        )
    )
    active = sil & on_screen & ~occ

    # radiance on both sides: rays through px +- delta * n2d
    res = jnp.asarray([wpx, hpx], jnp.float32)
    uv_plus = (px + delta_px * n2d) / res
    uv_minus = (px - delta_px * n2d) / res
    uv2 = jnp.concatenate([uv_plus, uv_minus], axis=0)
    o2, d2 = sensor.sample_ray(uv2)
    ray2 = Ray.create(o2, d2)
    sam2 = Sampler.create(int(key) + 1, 2 * n_samples)
    wl = None
    if cfg.spectral:
        from ..core import spectrum as spec

        wl, _ = spec.sample_hero_wavelengths(
            sam2.next_1d(1023), cfg.n_channels
        )
    values, valid = integrator_sample(scene, sam2, ray2, wl, cfg)
    values = jnp.where(valid[:, None], values, 0.0)
    L_plus = values[:n_samples]
    L_minus = values[n_samples:]

    # loss weight at the pixel
    pix = jnp.clip(px.astype(jnp.int32),
                   jnp.zeros(2, jnp.int32),
                   jnp.asarray([wpx - 1, hpx - 1], jnp.int32))
    w_px = grad_image[pix[:, 1], pix[:, 0]]  # [N, C]

    # moving the edge along +n2d grows the L_minus region
    jump = jnp.sum(w_px * (L_minus - L_plus), axis=-1)  # [N]

    # screen velocity of the edge point pulled back to the endpoints, and
    # the du -> screen-arclength Jacobian
    def s_of(a3, b3, uu, nn):
        p2d, _ = _project_px(sensor, a3 + (b3 - a3) * uu)
        return jnp.sum(p2d * nn)

    g_a, g_b = jax.vmap(jax.grad(s_of, argnums=(0, 1)))(pa, pb, u, n2d)

    def px_of_u(uu, a3, b3):
        p2d, _ = _project_px(sensor, a3 + (b3 - a3) * uu)
        return p2d

    dpx_du = jax.vmap(
        lambda uu, a3, b3: jax.jacfwd(px_of_u)(uu, a3, b3)
    )(u, pa, pb)
    arc = jnp.linalg.norm(dpx_du, axis=-1)  # |d px / d u|

    # pdf of the sample point per unit u on its edge: elen_e / total_len
    inv_pdf = total_len / jnp.maximum(elen[e_idx], 1e-12)
    coef = jnp.where(active, jump * arc * inv_pdf, 0.0) / n_samples

    cot_a = g_a * coef[:, None]  # [N, 3]
    cot_b = g_b * coef[:, None]

    # scatter back to soup rows: flat slot = face * 3 + corner
    F = geo.tri_p0.shape[0]
    slots = jnp.concatenate(
        [a_face[e_idx] * 3 + a_corner[e_idx],
         b_face[e_idx] * 3 + b_corner[e_idx]]
    )
    cots = jnp.concatenate([cot_a, cot_b], axis=0)
    acc = jnp.zeros((3 * F, 3), jnp.float32).at[slots].add(cots)
    return {
        "geo.tri_p0": acc[0::3],
        "geo.tri_p1": acc[1::3],
        "geo.tri_p2": acc[2::3],
    }


# ---------------------------------------------------------------------------
# NEE / shadow-ray boundary (occluder silhouettes as seen from the light)
# ---------------------------------------------------------------------------

def nee_boundary_grad(
    scene,
    integrator_sample,
    grad_image,
    key: int | Any = 0,
    n_samples: int = 1 << 14,
    cfg: RenderConfig = RenderConfig(),
    delta_px: float = 0.6,
):
    """Shadow-silhouette boundary cotangents for d(loss)/d(vertex rows) —
    the NEE/indirect-visibility term the reference handles with its
    projective PSIntegrator (common.py:785-1298). This covers the dominant
    emitter-occluder case: point-like emitters (point/spot/projector) whose
    shadows jump as an occluder's light-side silhouette moves.

    Estimator (same screen-space form as primary_boundary_grad, applied to
    the SHADOW curve): sample an edge point x uniformly by length; keep it
    when it is a silhouette w.r.t. the light position e and visible from
    the light; extend the ray e->x to the receiver hit y — the point where
    the shadow boundary lies; probe the radiance jump with two camera rays
    offset +-delta px across the projected curve; the screen velocity of
    the shadow point is pulled back through the ANALYTIC line-plane
    extension y(x) = e + (x - e) * ((q0 - e).nr) / ((x - e).nr) (receiver
    plane held fixed: this term differentiates the OCCLUDER geometry; the
    receiver's own motion is the primary-visibility term).

    Returns {geo.tri_p0/1/2: [F, 3]} cotangents, summed over every
    point-like emitter in the scene (each with its own sample set / key),
    zero when the scene has none.
    """
    from ..scene.emitters import (
        EMITTER_POINT, EMITTER_SPOT, EMITTER_PROJECTOR,
    )

    em = scene.emitters
    etype = np.asarray(em.etype)
    pointlike = np.isin(
        etype, [EMITTER_POINT, EMITTER_SPOT, EMITTER_PROJECTOR]
    )
    geo = scene.geo
    F = geo.tri_p0.shape[0]
    zeros = {
        "geo.tri_p0": jnp.zeros((F, 3), jnp.float32),
        "geo.tri_p1": jnp.zeros((F, 3), jnp.float32),
        "geo.tri_p2": jnp.zeros((F, 3), jnp.float32),
    }
    if not pointlike.any():
        return zeros
    out = zeros
    for i, e_pos_np in enumerate(np.asarray(em.position)[pointlike]):
        g = _nee_boundary_grad_one(
            scene, integrator_sample, grad_image, jnp.asarray(e_pos_np),
            key=int(key) + 2 * i, n_samples=n_samples, cfg=cfg,
            delta_px=delta_px,
        )
        out = {k: out[k] + g[k] for k in out}
    return out


def area_nee_boundary_grad(
    scene,
    grad_image,
    key: int | Any = 0,
    n_samples: int = 1 << 14,
    cfg: RenderConfig = RenderConfig(),
    delta_px: float = 0.8,
    edge_weights: Any = None,
    return_edge_mass: bool = False,
):
    """Penumbra (area-light shadow-boundary) cotangents for
    d(loss)/d(vertex rows) — the term the reference's PSIntegrator +
    guiding machinery estimates (src/python/python/ad/integrators/
    common.py:785-1298, ad/guiding.py), reformulated without guiding as a
    fixed-shape (edge point, emitter point) pair sampler:

    For a FIXED emitter point e on the area light, the moving occluder
    edge sweeps a sharp visibility discontinuity whose radiance jump is
    the closed-form single-point direct term
        delta(y; e) = f(y; w_cam, w_e) * Le * cos(theta_e) / r^2
    (no probe renders needed — unlike the point-light estimator, the
    penumbra is smooth in screen space, so probing total radiance would
    measure nothing). The lit/shadow orientation of the projected curve is
    resolved with two shadow rays from y +- delta on the receiver plane;
    velocities pull back through the analytic e->x->receiver-plane
    extension exactly as in the point-light case.

    Samples ALL area emitters (emitter chosen per-sample by area).
    Returns {geo.tri_p0/1/2: [F, 3]} cotangents (zero without area lights).
    FD-validated by tests/test_projective.py::test_area_penumbra_grad_vs_fd.
    """
    from ..librender import bsdfs as bsdfs_mod
    from ..librender.bsdf import BSDFContext
    from ..scene.emitters import EMITTER_AREA

    em = scene.emitters
    geo = scene.geo
    F = geo.tri_p0.shape[0]
    zeros = {
        "geo.tri_p0": jnp.zeros((F, 3), jnp.float32),
        "geo.tri_p1": jnp.zeros((F, 3), jnp.float32),
        "geo.tri_p2": jnp.zeros((F, 3), jnp.float32),
    }
    etype = np.asarray(em.etype)
    area_em = np.where(etype == EMITTER_AREA)[0]
    area_em = [
        int(i) for i in area_em if float(np.asarray(em.area)[i]) > 0
    ]
    if not area_em:
        return zeros

    sensor = scene.sensor
    wpx, hpx = sensor.resolution
    tri_p = (geo.tri_p0, geo.tri_p1, geo.tri_p2)
    ed = _edges_for(scene)

    a_face = jnp.asarray(ed["a_face"])
    a_corner = jnp.asarray(ed["a_corner"])
    b_face = jnp.asarray(ed["b_face"])
    b_corner = jnp.asarray(ed["b_corner"])
    f1 = jnp.asarray(ed["f1"])
    f2 = jnp.asarray(ed["f2"])

    def corner_pos(face, corner):
        stacked = jnp.stack([p[face] for p in tri_p], axis=0)
        return jnp.take_along_axis(
            stacked, corner[None, :, None].astype(jnp.int32), axis=0
        )[0]

    pa_all = corner_pos(a_face, a_corner)
    pb_all = corner_pos(b_face, b_corner)
    # exclude edges that belong to an emitter mesh: those are the light's
    # own silhouette (a different, emitter-side term), and the analytic
    # extension degenerates for them
    on_emitter = (geo.tri_emitter[f1] >= 0) | (
        geo.tri_emitter[jnp.maximum(f2, 0)] >= 0
    )
    elen = jnp.where(
        on_emitter, 0.0, jnp.linalg.norm(pb_all - pa_all, axis=-1)
    )
    # edge-sampling density: length-uniform, or guided weights (the
    # reference ad/guiding.py role — see area_nee_boundary_grad_guided)
    samp_w = elen if edge_weights is None else jnp.where(
        elen > 0, jnp.maximum(edge_weights, 0.0), 0.0
    )
    cum = jnp.cumsum(samp_w)
    total_len = cum[-1]

    sampler = Sampler.create(int(key), n_samples)
    r_e = sampler.next_1d(0)
    r_u = sampler.next_1d(1)
    e_idx = jnp.clip(
        jnp.searchsorted(cum, r_e * total_len), 0, elen.shape[0] - 1
    ).astype(jnp.int32)
    u = r_u

    pa = pa_all[e_idx]
    pb = pb_all[e_idx]
    x = pa + (pb - pa) * u[:, None]

    # ---- emitter point: pick an area emitter by area, then a triangle by
    # its cdf, then a uniform barycentric point --------------------------
    areas = np.asarray([float(np.asarray(em.area)[i]) for i in area_em])
    probs = areas / areas.sum()
    u_sel = sampler.next_1d(2)
    cdf_sel = jnp.asarray(np.cumsum(probs), jnp.float32)
    which = jnp.clip(
        jnp.searchsorted(cdf_sel, u_sel), 0, len(area_em) - 1
    ).astype(jnp.int32)
    ei_arr = jnp.asarray(np.asarray(area_em, np.int32))[which]  # [N]

    u_tri = sampler.next_1d(3)
    tri_cdf = em.tri_cdf[ei_arr]                    # [N, maxT]
    ti = jnp.clip(
        jnp.sum((tri_cdf < u_tri[:, None]).astype(jnp.int32), axis=-1),
        0, tri_cdf.shape[-1] - 1,
    )
    f_e = em.tri_idx[ei_arr, ti]                    # [N] face index
    f_e = jnp.maximum(f_e, 0)
    ub = sampler.next_2d(4)
    b1 = ub[:, 0]
    b2 = ub[:, 1]
    fold = b1 + b2 > 1.0
    b1 = jnp.where(fold, 1.0 - b1, b1)
    b2 = jnp.where(fold, 1.0 - b2, b2)
    e_pt = (
        geo.tri_p0[f_e]
        + b1[:, None] * (geo.tri_p1[f_e] - geo.tri_p0[f_e])
        + b2[:, None] * (geo.tri_p2[f_e] - geo.tri_p0[f_e])
    )
    n_e = geo.face_n[f_e]
    # per-sample reciprocal pdf over the joint (emitter, point) measure:
    # pdf = (area_i / sum) * (1 / area_i) = 1 / sum(areas)
    inv_pdf_e = jnp.float32(areas.sum())
    Le = em.radiance[ei_arr]                        # [N, 3]

    # ---- silhouette w.r.t. the sampled emitter point -------------------
    lview = x - e_pt
    fn = geo.face_n
    s1 = jnp.sum(fn[f1[e_idx]] * lview, axis=-1)
    f2e = f2[e_idx]
    s2 = jnp.sum(fn[jnp.maximum(f2e, 0)] * lview, axis=-1)
    sil = jnp.where(f2e >= 0, s1 * s2 < 0.0, True)

    ldist = jnp.linalg.norm(lview, axis=-1)
    ldir = lview / jnp.maximum(ldist, 1e-9)[:, None]
    cos_e = jnp.sum(n_e * ldir, axis=-1)  # emission side: cos > 0
    occ_l = scene.ray_test(
        Ray(o=e_pt + ldir * 1e-4, d=ldir, maxt=ldist * (1.0 - 2e-3))
    )

    # ---- extend past x to the receiver ---------------------------------
    si = scene.ray_intersect(Ray.create(x + ldir * 1e-4, ldir))
    y = si.p
    recv_n = si.n
    recv_q0 = si.p
    hit_recv = si.valid

    px, z = _project_px(sensor, y)
    cam_o = sensor.to_world[:3, 3]
    cview = y - cam_o
    cdist = jnp.linalg.norm(cview, axis=-1)
    cdir = cview / jnp.maximum(cdist, 1e-9)[:, None]
    occ_c = scene.ray_test(
        Ray(o=jnp.broadcast_to(cam_o, y.shape), d=cdir,
            maxt=cdist * (1.0 - 1e-3))
    )
    on_screen = (
        (z > 1e-4)
        & (px[:, 0] > 0.5) & (px[:, 0] < wpx - 0.5)
        & (px[:, 1] > 0.5) & (px[:, 1] < hpx - 0.5)
    )
    active = (
        sil & ~occ_l & hit_recv & on_screen & ~occ_c & (cos_e > 1e-4)
        & (total_len > 0)
    )

    # ---- screen direction of the penumbra curve ------------------------
    def shadow_pt(a3, b3, uu, e3):
        xx = a3 + (b3 - a3) * uu[..., None]
        w = xx - e3
        denom = jnp.sum(w * recv_n, axis=-1)
        s = jnp.sum((recv_q0 - e3) * recv_n, axis=-1) / jnp.where(
            jnp.abs(denom) > 1e-9, denom, 1e-9
        )
        return e3 + w * s[..., None]

    eps_u = 1e-3
    p_l, _ = _project_px(sensor, shadow_pt(pa, pb, u - eps_u, e_pt))
    p_r, _ = _project_px(sensor, shadow_pt(pa, pb, u + eps_u, e_pt))
    e2d = p_r - p_l
    e2d_len = jnp.linalg.norm(e2d, axis=-1)
    n2d = jnp.stack([-e2d[:, 1], e2d[:, 0]], axis=-1) / jnp.maximum(
        e2d_len, 1e-9
    )[:, None]
    arc = e2d_len / (2 * eps_u)
    active = active & (e2d_len > 1e-6)

    # ---- closed-form radiance jump at y for emitter point e ------------
    # direction conventions of the NEE integrand: si.wi = camera side,
    # wo = light side (librender/bsdfs eval contract)
    to_cam = -cdir
    wi_cam = si.to_local(to_cam)
    wo_e = si.to_local(-ldir)
    si_eval = dataclasses.replace(si, wi=wi_cam)
    ctx = BSDFContext()
    wl = None
    if cfg.spectral:
        from ..core import spectrum as spec

        wl, _ = spec.sample_hero_wavelengths(
            sampler.next_1d(1023), cfg.n_channels
        )
    f_val = bsdfs_mod.eval_(
        scene.materials, jnp.maximum(si.mat_idx, 0), si_eval, wo_e, ctx,
        cfg, wl,
    )  # [N, C] (includes cos at y)
    r_ye = jnp.linalg.norm(y - e_pt, axis=-1)
    Le_c = Le if not cfg.spectral else jnp.broadcast_to(
        jnp.mean(Le, axis=-1, keepdims=True), (n_samples, cfg.n_channels)
    )
    delta_rgb = f_val * Le_c * (
        cos_e / jnp.maximum(r_ye * r_ye, 1e-9)
    )[:, None]

    # ---- lit/shadow orientation via two receiver-plane shadow rays -----
    res = jnp.asarray([wpx, hpx], jnp.float32)

    def plane_point(px2):
        o2, d2 = sensor.sample_ray(px2 / res)
        denom = jnp.sum(d2 * recv_n, axis=-1)
        t = jnp.sum((recv_q0 - o2) * recv_n, axis=-1) / jnp.where(
            jnp.abs(denom) > 1e-6, denom, 1e-6
        )
        return o2 + d2 * t[:, None]

    y_plus = plane_point(px + delta_px * n2d)
    y_minus = plane_point(px - delta_px * n2d)

    def vis_from(yq):
        dv = e_pt - yq
        dl = jnp.linalg.norm(dv, axis=-1)
        dn = dv / jnp.maximum(dl, 1e-9)[:, None]
        off = jnp.where(
            jnp.sum(dn * recv_n, axis=-1) >= 0, 1e-4, -1e-4
        )[:, None] * recv_n
        occ = scene.ray_test(
            Ray(o=yq + off, d=dn, maxt=dl * (1.0 - 2e-3))
        )
        return (~occ).astype(jnp.float32)

    v_jump = vis_from(y_plus) - vis_from(y_minus)  # +1: +n2d side is lit

    # ---- pixel weight + velocity pullback ------------------------------
    pix = jnp.clip(px.astype(jnp.int32),
                   jnp.zeros(2, jnp.int32),
                   jnp.asarray([wpx - 1, hpx - 1], jnp.int32))
    w_px = grad_image[pix[:, 1], pix[:, 0]]
    # moving the curve along +n2d converts lit <-> shadow by v_jump sign:
    # growth of the LIT region adds +delta to the pixel
    jump = jnp.sum(w_px * delta_rgb, axis=-1) * (-v_jump)

    def s_of(a3, b3, uu, nn, q0, nr, e3):
        xx = a3 + (b3 - a3) * uu
        w = xx - e3
        denom = jnp.sum(w * nr)
        s = jnp.sum((q0 - e3) * nr) / jnp.where(
            jnp.abs(denom) > 1e-9, denom, 1e-9
        )
        yy = e3 + w * s
        p2d, _ = _project_px(sensor, yy)
        return jnp.sum(p2d * nn)

    g_a, g_b = jax.vmap(jax.grad(s_of, argnums=(0, 1)))(
        pa, pb, u, n2d, recv_q0, recv_n, e_pt
    )

    # sampling density per unit u on edge e is samp_w_e / total (see above)
    inv_pdf = total_len / jnp.maximum(samp_w[e_idx], 1e-12)
    coef = jnp.where(
        active, jump * arc * inv_pdf * inv_pdf_e, 0.0
    ) / n_samples

    cot_a = g_a * coef[:, None]
    cot_b = g_b * coef[:, None]
    slots = jnp.concatenate(
        [a_face[e_idx] * 3 + a_corner[e_idx],
         b_face[e_idx] * 3 + b_corner[e_idx]]
    )
    cots = jnp.concatenate([cot_a, cot_b], axis=0)
    acc = jnp.zeros((3 * F, 3), jnp.float32).at[slots].add(cots)
    out = {
        "geo.tri_p0": acc[0::3],
        "geo.tri_p1": acc[1::3],
        "geo.tri_p2": acc[2::3],
    }
    if return_edge_mass:
        mass = jnp.zeros((elen.shape[0],), jnp.float32).at[e_idx].add(
            jnp.abs(coef)
        )
        return out, mass
    return out


def area_nee_boundary_grad_guided(
    scene,
    grad_image,
    key: int | Any = 0,
    n_samples: int = 1 << 14,
    cfg: RenderConfig = RenderConfig(),
    delta_px: float = 0.8,
    pilot_frac: float = 0.25,
):
    """Guided penumbra estimator — the role of the reference's projective
    GUIDING machinery (ad/guiding.py octree/grid), recast fixed-shape:

    pass 1 (pilot, pilot_frac of the budget): length-uniform edge sampling
    that also accumulates per-edge contribution mass |coef|;
    pass 2: edge sampling proportional to (pilot mass, defensively mixed
    with a uniform floor so unvisited edges keep coverage).

    Both passes are unbiased; the result is their sample-count-weighted
    average. Variance reduction pinned by
    tests/test_projective.py::test_area_penumbra_guiding_reduces_variance.
    """
    n1 = max(int(n_samples * pilot_frac), 256)
    n2 = max(n_samples - n1, 256)
    g1, mass = area_nee_boundary_grad(
        scene, grad_image, key=key, n_samples=n1, cfg=cfg,
        delta_px=delta_px, return_edge_mass=True,
    )
    # defensive mixture (reference guiding keeps an exploration floor):
    # 75% proportional to pilot mass, 25% by length
    ed = _edges_for(scene)
    a_face = jnp.asarray(ed["a_face"])
    total = jnp.maximum(jnp.sum(mass), 1e-20)
    # length term for the floor (recomputed cheaply host-side cache)
    tri_p = (scene.geo.tri_p0, scene.geo.tri_p1, scene.geo.tri_p2)

    def corner_pos(face, corner):
        stacked = jnp.stack([p[face] for p in tri_p], axis=0)
        return jnp.take_along_axis(
            stacked, corner[None, :, None].astype(jnp.int32), axis=0
        )[0]

    pa = corner_pos(a_face, jnp.asarray(ed["a_corner"]))
    pb = corner_pos(jnp.asarray(ed["b_face"]), jnp.asarray(ed["b_corner"]))
    elen = jnp.linalg.norm(pb - pa, axis=-1)
    tot_len = jnp.maximum(jnp.sum(elen), 1e-20)
    weights = 0.75 * mass / total + 0.25 * elen / tot_len
    g2 = area_nee_boundary_grad(
        scene, grad_image, key=int(key) + 7919, n_samples=n2, cfg=cfg,
        delta_px=delta_px, edge_weights=weights,
    )
    w1 = n1 / (n1 + n2)
    return {k: w1 * g1[k] + (1.0 - w1) * g2[k] for k in g1}


def _nee_boundary_grad_one(
    scene, integrator_sample, grad_image, e_pos, key, n_samples, cfg,
    delta_px,
):
    """Shadow-silhouette cotangents for ONE point-like emitter at e_pos."""
    geo = scene.geo
    F = geo.tri_p0.shape[0]
    ed = _edges_for(scene)
    sensor = scene.sensor
    wpx, hpx = sensor.resolution
    tri_p = (geo.tri_p0, geo.tri_p1, geo.tri_p2)

    a_face = jnp.asarray(ed["a_face"])
    a_corner = jnp.asarray(ed["a_corner"])
    b_face = jnp.asarray(ed["b_face"])
    b_corner = jnp.asarray(ed["b_corner"])
    f1 = jnp.asarray(ed["f1"])
    f2 = jnp.asarray(ed["f2"])

    def corner_pos(face, corner):
        stacked = jnp.stack([p[face] for p in tri_p], axis=0)
        return jnp.take_along_axis(
            stacked, corner[None, :, None].astype(jnp.int32), axis=0
        )[0]

    pa_all = corner_pos(a_face, a_corner)
    pb_all = corner_pos(b_face, b_corner)
    elen = jnp.linalg.norm(pb_all - pa_all, axis=-1)
    cum = jnp.cumsum(elen)
    total_len = cum[-1]

    sampler = Sampler.create(int(key), n_samples)
    r_e = sampler.next_1d(0)
    r_u = sampler.next_1d(1)
    e_idx = jnp.clip(
        jnp.searchsorted(cum, r_e * total_len), 0, elen.shape[0] - 1
    ).astype(jnp.int32)
    u = r_u

    pa = pa_all[e_idx]
    pb = pb_all[e_idx]
    x = pa + (pb - pa) * u[:, None]

    # silhouette w.r.t. the LIGHT
    lview = x - e_pos
    fn = geo.face_n
    s1 = jnp.sum(fn[f1[e_idx]] * lview, axis=-1)
    f2e = f2[e_idx]
    s2 = jnp.sum(fn[jnp.maximum(f2e, 0)] * lview, axis=-1)
    sil = jnp.where(f2e >= 0, s1 * s2 < 0.0, True)

    # x visible from the light
    ldist = jnp.linalg.norm(lview, axis=-1)
    ldir = lview / jnp.maximum(ldist, 1e-9)[:, None]
    occ_l = scene.ray_test(
        Ray(o=jnp.broadcast_to(e_pos, x.shape), d=ldir,
            maxt=ldist * (1.0 - 1e-3))
    )

    # extend past x to the receiver
    si = scene.ray_intersect(Ray.create(x + ldir * 1e-4, ldir))
    y = si.p
    recv_n = si.n
    recv_q0 = si.p  # point on the receiver plane
    hit_recv = si.valid

    # project the shadow point; on-screen + camera-visible checks
    px, z = _project_px(sensor, y)
    cam_o = sensor.to_world[:3, 3]
    cview = y - cam_o
    cdist = jnp.linalg.norm(cview, axis=-1)
    cdir = cview / jnp.maximum(cdist, 1e-9)[:, None]
    occ_c = scene.ray_test(
        Ray(o=jnp.broadcast_to(cam_o, y.shape), d=cdir,
            maxt=cdist * (1.0 - 1e-3))
    )
    on_screen = (
        (z > 1e-4)
        & (px[:, 0] > 0.5) & (px[:, 0] < wpx - 0.5)
        & (px[:, 1] > 0.5) & (px[:, 1] < hpx - 0.5)
    )
    active = sil & ~occ_l & hit_recv & on_screen & ~occ_c

    # screen direction of the shadow curve: project y(u +- du)
    def shadow_pt(a3, b3, uu):
        xx = a3 + (b3 - a3) * uu[..., None]
        w = xx - e_pos
        denom = jnp.sum(w * recv_n, axis=-1)
        s = jnp.sum((recv_q0 - e_pos) * recv_n, axis=-1) / jnp.where(
            jnp.abs(denom) > 1e-9, denom, 1e-9
        )
        return e_pos + w * s[..., None]

    eps_u = 1e-3
    y_l = shadow_pt(pa, pb, u - eps_u)
    y_r = shadow_pt(pa, pb, u + eps_u)
    p_l, _ = _project_px(sensor, y_l)
    p_r, _ = _project_px(sensor, y_r)
    e2d = p_r - p_l
    e2d_len = jnp.linalg.norm(e2d, axis=-1)
    n2d = jnp.stack([-e2d[:, 1], e2d[:, 0]], axis=-1) / jnp.maximum(
        e2d_len, 1e-9
    )[:, None]
    arc = e2d_len / (2 * eps_u)  # |d px / d u|
    active = active & (e2d_len > 1e-6)

    # radiance probes across the projected shadow curve
    res = jnp.asarray([wpx, hpx], jnp.float32)
    uv_plus = (px + delta_px * n2d) / res
    uv_minus = (px - delta_px * n2d) / res
    uv2 = jnp.concatenate([uv_plus, uv_minus], axis=0)
    o2, d2 = sensor.sample_ray(uv2)
    ray2 = Ray.create(o2, d2)
    sam2 = Sampler.create(int(key) + 1, 2 * n_samples)
    wl = None
    if cfg.spectral:
        from ..core import spectrum as spec

        wl, _ = spec.sample_hero_wavelengths(
            sam2.next_1d(1023), cfg.n_channels
        )
    values, valid = integrator_sample(scene, sam2, ray2, wl, cfg)
    values = jnp.where(valid[:, None], values, 0.0)
    L_plus = values[:n_samples]
    L_minus = values[n_samples:]

    pix = jnp.clip(px.astype(jnp.int32),
                   jnp.zeros(2, jnp.int32),
                   jnp.asarray([wpx - 1, hpx - 1], jnp.int32))
    w_px = grad_image[pix[:, 1], pix[:, 0]]
    jump = jnp.sum(w_px * (L_minus - L_plus), axis=-1)

    # screen velocity of the shadow point pulled back to edge endpoints
    # through the analytic extension (receiver plane fixed)
    def s_of(a3, b3, uu, nn, q0, nr):
        xx = a3 + (b3 - a3) * uu
        w = xx - e_pos
        denom = jnp.sum(w * nr)
        s = jnp.sum((q0 - e_pos) * nr) / jnp.where(
            jnp.abs(denom) > 1e-9, denom, 1e-9
        )
        yy = e_pos + w * s
        p2d, _ = _project_px(sensor, yy)
        return jnp.sum(p2d * nn)

    g_a, g_b = jax.vmap(jax.grad(s_of, argnums=(0, 1)))(
        pa, pb, u, n2d, recv_q0, recv_n
    )

    inv_pdf = total_len / jnp.maximum(elen[e_idx], 1e-12)
    coef = jnp.where(active, jump * arc * inv_pdf, 0.0) / n_samples

    cot_a = g_a * coef[:, None]
    cot_b = g_b * coef[:, None]
    slots = jnp.concatenate(
        [a_face[e_idx] * 3 + a_corner[e_idx],
         b_face[e_idx] * 3 + b_corner[e_idx]]
    )
    cots = jnp.concatenate([cot_a, cot_b], axis=0)
    acc = jnp.zeros((3 * F, 3), jnp.float32).at[slots].add(cots)
    return {
        "geo.tri_p0": acc[0::3],
        "geo.tri_p1": acc[1::3],
        "geo.tri_p2": acc[2::3],
    }
