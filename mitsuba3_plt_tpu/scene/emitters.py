"""Emitter table + NEE direction sampling (masked dispatch over types).

Functional twin of Scene::sample_emitter_direction / pdf_emitter_direction
(reference src/render/scene.cpp:294-368) with Mitsuba's semantics: emitter
chosen uniformly, then a position ∝ area on it; solid-angle densities.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as m
from ..core import frame as fr
from ..core import warp
from ..librender.records import DirectionSample

EMITTER_AREA = 0
EMITTER_POINT = 1
EMITTER_CONSTANT = 2
EMITTER_DIRECTIONAL = 3
EMITTER_ENVMAP = 4
EMITTER_SPOT = 5
EMITTER_DIRECTIONALAREA = 6
EMITTER_SPHERE = 7   # analytic-sphere area light (sphere.cpp sample_direction);
                     # the sphere radius rides in the (spot-only) cutoff_cos slot
EMITTER_DIRECTIONALSPOT = 8  # directional with angular spread (reference
                             # src/emitters/directionalspot.cpp): NEE direction
                             # jittered within a disk of radius sin(spread_angle);
                             # sin(spread_angle) rides in the cutoff_cos slot
EMITTER_PROJECTOR = 9        # textured perspective point source (reference
                             # src/emitters/projector.cpp); tan(fov/2) rides in
                             # cutoff_cos, intensity scale in beam_cos


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EmitterTable:
    etype: Any        # [E] int32
    radiance: Any     # [E, 3] radiance (area/constant/directional) or intensity (point/spot)
    position: Any     # [E, 3]
    direction: Any    # [E, 3] (directional/spot main axis)
    cutoff_cos: Any   # [E] spot cutoff cosine
    beam_cos: Any     # [E] spot falloff-start cosine
    # --- area emitter triangle sampling (padded per emitter) ---
    tri_idx: Any      # [E, T] int32 triangle indices (-1 pad)
    tri_cdf: Any      # [E, T] area cdf (normalized to 1 at the last valid slot)
    area: Any         # [E] total surface area
    # bounding sphere of the scene (constant/directional sampling)
    scene_center: Any  # [3]
    scene_radius: Any  # scalar
    # --- environment map (at most one; reference src/emitters/envmap.cpp:
    # lat-long image with luminance-proportional 2D importance sampling) ---
    env_image: Any = None    # [He, We, 3] or None
    env_row_cdf: Any = None  # [He] marginal cdf over rows (sin-weighted)
    env_col_cdf: Any = None  # [He, We] conditional cdf per row
    env_scale: Any = None    # scalar
    # per-emitter spectral radiance curve on the CIE grid (reference spectra
    # plugins src/spectra/{uniform,regular,irregular,d65,blackbody}.cpp);
    # None -> RGB `radiance` is authoritative
    spectra: Any = None      # [E, 95] or None
    # projector local frame x/y axes (None unless a projector is present;
    # reference src/emitters/projector.cpp camera_to_sample)
    frame_s: Any = None      # [E, 3]
    frame_t: Any = None      # [E, 3]
    proj_image: Any = None   # [Hp, Wp, 3] projector irradiance texture

    present_types: tuple = dataclasses.field(default=(), metadata=dict(static=True))

    @property
    def count(self):
        return self.etype.shape[0]

    def gather(self, e_idx):
        """Per-lane emitter params via ONE packed row fetch (same in-loop
        gather economics as MaterialTable.gather): etype, radiance, position,
        direction, cutoff_cos, beam_cos, area."""
        packed = jnp.concatenate(
            [
                self.etype[:, None].astype(jnp.float32),
                self.radiance,
                self.position,
                self.direction,
                self.cutoff_cos[:, None],
                self.beam_cos[:, None],
                self.area[:, None],
            ],
            axis=-1,
        )
        rows = m.small_gather(packed, e_idx)
        return {
            "etype": rows[..., 0].astype(jnp.int32),
            "radiance": rows[..., 1:4],
            "position": rows[..., 4:7],
            "direction": rows[..., 7:10],
            "cutoff_cos": rows[..., 10],
            "beam_cos": rows[..., 11],
            "area": rows[..., 12],
        }


def sample_emitter_direction(
    em: EmitterTable, geo, ref_p, sample1, sample2, active=True
):
    """Sample a direction toward one uniformly-chosen emitter.

    geo: Geometry (for triangle vertex lookup).
    Returns (DirectionSample, visibility ray needed) — radiance evaluation is
    separate (eval_emitter) so polarized integrators can rotate bases.
    """
    n = ref_p.shape[0]
    e_count = em.count
    # uniform emitter pick with sample reuse
    scaled = sample1 * e_count
    e_idx = jnp.clip(scaled.astype(jnp.int32), 0, e_count - 1)
    # (sample1 is consumed; sample2 drives the position sample)

    ep = em.gather(e_idx)  # ONE packed row fetch for all scalar fields
    etype = ep["etype"]
    ds = _zeros_ds(n)

    for t in em.present_types:
        mask = etype == t
        if t == EMITTER_AREA:
            cand = _sample_area(em, geo, ref_p, e_idx, sample2, ep)
        elif t == EMITTER_POINT:
            cand = _sample_point(em, ref_p, e_idx, ep)
        elif t == EMITTER_CONSTANT:
            cand = _sample_constant(em, ref_p, e_idx, sample2)
        elif t == EMITTER_DIRECTIONAL:
            cand = _sample_directional(em, ref_p, e_idx, ep)
        elif t == EMITTER_SPOT:
            cand = _sample_point(em, ref_p, e_idx, ep)  # spot shares point geometry
        elif t == EMITTER_ENVMAP:
            cand = _sample_envmap(em, ref_p, e_idx, sample2)
        elif t == EMITTER_SPHERE:
            cand = _sample_sphere(em, ref_p, e_idx, sample2, ep)
        elif t == EMITTER_DIRECTIONALSPOT:
            cand = _sample_directionalspot(em, ref_p, e_idx, sample2, ep)
        elif t == EMITTER_PROJECTOR:
            cand = _sample_point(em, ref_p, e_idx, ep)  # textured point source
        else:
            continue
        ds = _select_ds(mask, cand, ds)

    # divide by uniform emitter-pick probability
    pdf = ds.pdf / e_count
    ds = dataclasses.replace(ds, pdf=jnp.where(active, pdf, 0.0))
    return ds


def pdf_emitter_direction(em: EmitterTable, geo, ref_p, ds: DirectionSample):
    """Solid-angle density of sample_emitter_direction producing ds (for MIS).
    Only non-delta emitters return nonzero."""
    e_idx = jnp.maximum(ds.emitter_idx, 0)
    ep = em.gather(e_idx)
    etype = ep["etype"]
    pdf = jnp.zeros(ref_p.shape[0], jnp.float32)
    for t in em.present_types:
        mask = etype == t
        if t == EMITTER_AREA:
            cos_l = -fr.dot(ds.d, ds.n)
            p = jnp.where(
                cos_l > 0,
                ds.dist * ds.dist / (jnp.maximum(cos_l, 1e-9) * jnp.maximum(ep["area"], 1e-12)),
                0.0,
            )
        elif t == EMITTER_CONSTANT:
            p = jnp.full_like(pdf, m.InvFourPi)
        elif t == EMITTER_ENVMAP:
            p = envmap_pdf(em, ds.d)
        elif t == EMITTER_SPHERE:
            # visible-cone density (sphere.cpp pdf_direction)
            dvec = ep["position"] - ref_p
            dc = jnp.linalg.norm(dvec, axis=-1)
            r = ep["cutoff_cos"]
            sin2 = jnp.clip((r / jnp.maximum(dc, 1e-9)) ** 2, 0.0, 1.0)
            cos_max = jnp.sqrt(jnp.maximum(1.0 - sin2, 0.0))
            p = jnp.where(
                dc > r,
                1.0 / jnp.maximum(2.0 * m.Pi * (1.0 - cos_max), 1e-9),
                # inside the sphere: uniform-area fallback density
                ds.dist * ds.dist / jnp.maximum(
                    jnp.abs(fr.dot(ds.d, ds.n)) * 4.0 * m.Pi * r * r, 1e-9
                ),
            )
        else:
            continue
        pdf = jnp.where(mask, p, pdf)
    return pdf / em.count


def eval_emitter(em: EmitterTable, e_idx, d, dist, active):
    """Unpolarized RGB radiance arriving along -d from emitter e_idx.

    Point/spot emitters fold the 1/r^2 falloff here (their DirectionSample pdf
    is 1 with delta flag).
    """
    e_idx_c = jnp.maximum(e_idx, 0)
    ep = em.gather(e_idx_c)
    etype = ep["etype"]
    rad = ep["radiance"]
    val = rad
    # point: intensity / r^2
    is_point = (etype == EMITTER_POINT) | (etype == EMITTER_SPOT)
    val = jnp.where(
        is_point[..., None], rad / jnp.maximum(dist * dist, 1e-12)[..., None], val
    )
    # spot falloff
    is_spot = etype == EMITTER_SPOT
    if True:
        cd = fr.dot(d, ep["direction"])  # d points toward emitter; spot dir outward
        cos_angle = -cd
        cutoff = ep["cutoff_cos"]
        beam = ep["beam_cos"]
        falloff = jnp.clip(
            (cos_angle - cutoff) / jnp.maximum(beam - cutoff, 1e-6), 0.0, 1.0
        )
        val = jnp.where(is_spot[..., None], val * falloff[..., None], val)
    # envmap: radiance from the image along the sampled direction
    if EMITTER_ENVMAP in em.present_types:
        is_env = etype == EMITTER_ENVMAP
        val = jnp.where(is_env[..., None], eval_envmap(em, d), val)
    # projector: perspective-projected texture, irradiance normalized at z=1
    # (reference src/emitters/projector.cpp sample_direction:
    #  spec = pi * scale * tex(uv) / (z_local^2 * cos_theta), and
    #  z_local^2 * cos_theta = dist^2 * cos_theta^3)
    if EMITTER_PROJECTOR in em.present_types:
        is_proj = etype == EMITTER_PROJECTOR
        d_out = -d  # propagation direction: from the projector toward ref_p
        cos_t = fr.dot(d_out, ep["direction"])
        s_loc = fr.dot(d_out, m.small_gather(em.frame_s, e_idx_c))
        t_loc = fr.dot(d_out, m.small_gather(em.frame_t, e_idx_c))
        tan_half = jnp.maximum(ep["cutoff_cos"], 1e-6)  # tan(fov_x/2)
        hp, wp = em.proj_image.shape[:2]
        aspect = wp / hp
        z_safe = jnp.where(cos_t > 1e-6, cos_t, 1.0)
        u = 0.5 - 0.5 * (s_loc / z_safe) / tan_half
        v = 0.5 - 0.5 * (t_loc / z_safe) * aspect / tan_half
        inside = (
            (cos_t > 1e-6) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
        )
        tex = _proj_tex(em.proj_image, u, v)
        proj_val = (
            m.Pi * ep["beam_cos"][..., None] * tex
            / jnp.maximum(dist * dist * z_safe ** 3, 1e-12)[..., None]
        )
        proj_val = jnp.where(inside[..., None], proj_val, 0.0)
        val = jnp.where(is_proj[..., None], proj_val, val)
    # directionalarea: delta emission along the surface normal only —
    # measure-zero for BSDF/camera hits and NEE (directionalarea.cpp:126-164
    # eval/sample_direction return 0); only ptracer's sample_ray emits
    is_darea = etype == EMITTER_DIRECTIONALAREA
    val = jnp.where(is_darea[..., None], 0.0, val)
    ok = active & (e_idx >= 0)
    return jnp.where(ok[..., None], val, 0.0)


def _proj_tex(img, u, v):
    """Clamped bilinear lookup of the projector irradiance texture."""
    hp, wp = img.shape[:2]
    x = jnp.clip(u * wp - 0.5, 0.0, wp - 1.0)
    y = jnp.clip(v * hp - 0.5, 0.0, hp - 1.0)
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, wp - 2) if wp > 1 else jnp.zeros_like(x, jnp.int32)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, hp - 2) if hp > 1 else jnp.zeros_like(y, jnp.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x1 = jnp.minimum(x0 + 1, wp - 1)
    y1 = jnp.minimum(y0 + 1, hp - 1)
    return (
        img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x1] * fx * (1 - fy)
        + img[y1, x0] * (1 - fx) * fy + img[y1, x1] * fx * fy
    )


def eval_env(em: EmitterTable, d):
    """Radiance for escaped rays (constant and/or environment-map emitter)."""
    out = jnp.zeros((*d.shape[:-1], 3), jnp.float32)
    for i_t in em.present_types:
        if i_t == EMITTER_CONSTANT:
            is_const = em.etype == EMITTER_CONSTANT
            # single constant emitter assumed: take its radiance
            rad = jnp.sum(
                jnp.where(is_const[:, None], em.radiance, 0.0), axis=0
            )
            out = out + rad
        elif i_t == EMITTER_ENVMAP:
            out = out + eval_envmap(em, d)
    return out


def build_env_tables(image: np.ndarray):
    """Host-side: luminance x sin(theta) 2D sampling tables for a lat-long
    environment image (reference src/emitters/envmap.cpp DiscreteDistribution2D)."""
    img = np.asarray(image, np.float32)
    he, we = img.shape[:2]
    lum = img[..., 0] * 0.2126 + img[..., 1] * 0.7152 + img[..., 2] * 0.0722
    theta = (np.arange(he) + 0.5) / he * np.pi
    w = lum * np.sin(theta)[:, None] + 1e-12
    row_w = w.sum(axis=1)
    row_cdf = np.cumsum(row_w) / row_w.sum()
    col_cdf = np.cumsum(w, axis=1) / w.sum(axis=1, keepdims=True)
    return (
        jnp.asarray(img), jnp.asarray(row_cdf.astype(np.float32)),
        jnp.asarray(col_cdf.astype(np.float32)),
    )


def _env_dir_to_uv(d):
    """World direction -> lat-long uv in [0,1]^2 (Mitsuba convention:
    u = (1 + atan2(x, -z)/pi)/2, v = theta/pi)."""
    u = 0.5 * (1.0 + jnp.arctan2(d[..., 0], -d[..., 2]) * m.InvPi)
    v = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0)) * m.InvPi
    return u, v


def _env_uv_to_dir(u, v):
    phi = (2.0 * u - 1.0) * m.Pi
    theta = v * m.Pi
    st = jnp.sin(theta)
    return jnp.stack(
        [st * jnp.sin(phi), jnp.cos(theta), -st * jnp.cos(phi)], axis=-1
    )


def eval_envmap(em: EmitterTable, d):
    """Bilinear lat-long lookup of radiance arriving from direction d."""
    img = em.env_image
    he, we = img.shape[:2]
    u, v = _env_dir_to_uv(d)
    x = u * we - 0.5
    y = v * he - 0.5
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, he - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0m = jnp.mod(x0, we)
    x1m = jnp.mod(x0 + 1, we)
    y1 = jnp.clip(y0 + 1, 0, he - 1)
    c00 = img[y0, x0m]
    c01 = img[y0, x1m]
    c10 = img[y1, x0m]
    c11 = img[y1, x1m]
    out = (
        c00 * (1 - fx) * (1 - fy) + c01 * fx * (1 - fy)
        + c10 * (1 - fx) * fy + c11 * fx * fy
    )
    return out * em.env_scale


def envmap_pdf(em: EmitterTable, d):
    """Solid-angle pdf of _sample_envmap producing direction d."""
    img = em.env_image
    he, we = img.shape[:2]
    u, v = _env_dir_to_uv(d)
    xi = jnp.clip((u * we).astype(jnp.int32), 0, we - 1)
    yi = jnp.clip((v * he).astype(jnp.int32), 0, he - 1)
    lum = (
        img[..., 0] * 0.2126 + img[..., 1] * 0.7152 + img[..., 2] * 0.0722
    )
    theta_rows = (jnp.arange(he) + 0.5) / he * m.Pi
    w = lum * jnp.sin(theta_rows)[:, None] + 1e-12
    total = jnp.sum(w)
    pix_p = w[yi, xi] / total  # probability of the texel
    sin_t = jnp.maximum(jnp.sin(v * m.Pi), 1e-6)
    # d_omega per texel = (pi/he)(2pi/we) sin(theta)
    return pix_p * he * we / (2.0 * m.Pi * m.Pi * sin_t)


def _sample_envmap(em: EmitterTable, ref_p, e_idx, sample2):
    n = ref_p.shape[0]
    img = em.env_image
    he, we = img.shape[:2]
    u1 = sample2[..., 0]
    u2 = sample2[..., 1]
    row = jnp.clip(
        jnp.searchsorted(em.env_row_cdf, u1, side="right"), 0, he - 1
    ).astype(jnp.int32)
    # continuous offset within the row via cdf re-scaling
    prev_r = jnp.where(row > 0, em.env_row_cdf[jnp.maximum(row - 1, 0)], 0.0)
    fr_row = (u1 - prev_r) / jnp.maximum(em.env_row_cdf[row] - prev_r, 1e-12)
    col_cdf_row = em.env_col_cdf[row]  # [N, We]
    col = jnp.clip(
        jax.vmap(lambda c, u: jnp.searchsorted(c, u, side="right"))(
            col_cdf_row, u2
        ),
        0, we - 1,
    ).astype(jnp.int32)
    prev_c = jnp.where(
        col > 0, jnp.take_along_axis(col_cdf_row, jnp.maximum(col - 1, 0)[..., None], -1)[..., 0], 0.0
    )
    cur_c = jnp.take_along_axis(col_cdf_row, col[..., None], -1)[..., 0]
    fr_col = (u2 - prev_c) / jnp.maximum(cur_c - prev_c, 1e-12)

    v = (row.astype(jnp.float32) + fr_row) / he
    u = (col.astype(jnp.float32) + fr_col) / we
    d = _env_uv_to_dir(u, v)
    pdf = envmap_pdf(em, d)
    dist = jnp.broadcast_to(2.0 * em.scene_radius, (n,))
    return DirectionSample(
        p=ref_p + d * dist[..., None],
        n=-d,
        uv=jnp.stack([u, v], axis=-1),
        d=d,
        dist=dist,
        pdf=pdf,
        delta=jnp.zeros((n,), bool),
        emitter_idx=e_idx,
    )


def emitter_value(em: EmitterTable, e_idx, d, dist, active, cfg, wavelengths):
    """Radiance in the active config representation [N, C]: RGB directly, or
    the per-emitter spectral curve sampled at `wavelengths`, both including
    the geometric factors (1/r^2, spot falloff) of eval_emitter."""
    rgb = eval_emitter(em, e_idx, d, dist, active)
    if not cfg.spectral or wavelengths is None:
        return rgb
    from ..core import spectrum as spec

    e_idx_c = jnp.maximum(e_idx, 0)
    base_lum = spec.luminance_rgb(em.radiance[e_idx_c])
    factor = spec.luminance_rgb(rgb) / jnp.maximum(base_lum, 1e-20)
    return eval_emitter_spectral(em, e_idx, wavelengths, active) * factor[..., None]


def eval_emitter_spectral(em: EmitterTable, e_idx, wavelengths, active):
    """Spectral radiance [N, C] at `wavelengths` nm from the per-emitter
    curve (falls back to flat luminance of the RGB radiance)."""
    from ..core import spectrum as spec

    e_idx_c = jnp.maximum(e_idx, 0)
    if em.spectra is None:
        lum = spec.luminance_rgb(em.radiance[e_idx_c])
        out = jnp.broadcast_to(lum[..., None], wavelengths.shape)
    else:
        curve = em.spectra[e_idx_c]  # [N, K]
        K = curve.shape[-1]
        t = (wavelengths - spec.CIE_MIN) / (spec.CIE_MAX - spec.CIE_MIN) * (K - 1)
        i = jnp.clip(jnp.floor(t).astype(jnp.int32), 0, K - 2)
        f = t - i
        v0 = jnp.take_along_axis(curve, i, axis=-1)
        v1 = jnp.take_along_axis(curve, i + 1, axis=-1)
        out = v0 * (1 - f) + v1 * f
    return jnp.where((active & (e_idx >= 0))[..., None], out, 0.0)


def env_value(em: EmitterTable, env_idx: int, d, cfg, wavelengths):
    """Environment radiance for escaped rays in the active representation
    [N, C] — the spectral twin of `eval_env` (same per-emitter curve as
    emitter_value, so the BSDF-hit and NEE env estimators agree)."""
    rgb = eval_env(em, d)
    if not cfg.spectral or wavelengths is None:
        if getattr(cfg, "mono", False):
            from ..core import spectrum as spec

            return spec.luminance_rgb(rgb)[..., None]
        return rgb
    from ..core import spectrum as spec

    n = d.shape[0]
    e_idx = jnp.full((n,), env_idx, jnp.int32)
    base = spec.luminance_rgb(em.radiance[env_idx])
    factor = spec.luminance_rgb(rgb) / jnp.maximum(base, 1e-20)
    act = jnp.ones((n,), bool)
    return eval_emitter_spectral(em, e_idx, wavelengths, act) * factor[..., None]


def escape_pdf(em: EmitterTable, d):
    """NEE pdf of the environment emitter (constant or envmap) producing
    direction d — the MIS counterpart for escaped rays."""
    p = jnp.zeros(d.shape[:-1], jnp.float32)
    for t in em.present_types:
        if t == EMITTER_CONSTANT:
            p = p + m.InvFourPi
        elif t == EMITTER_ENVMAP:
            p = p + envmap_pdf(em, d)
    return p / jnp.maximum(em.count, 1)


def env_emitter_index(em: EmitterTable):
    """Index of the environment (constant) emitter, -1 if none — host-side."""
    et = np.asarray(em.etype)
    idx = np.where(et == EMITTER_CONSTANT)[0]
    return int(idx[0]) if len(idx) else -1


# --- per-type samplers -------------------------------------------------------

def _zeros_ds(n):
    z3 = jnp.zeros((n, 3), jnp.float32)
    z1 = jnp.zeros((n,), jnp.float32)
    return DirectionSample(
        p=z3, n=z3, uv=jnp.zeros((n, 2), jnp.float32), d=z3,
        dist=z1, pdf=z1, delta=jnp.zeros((n,), bool),
        emitter_idx=jnp.full((n,), -1, jnp.int32),
    )


def _select_ds(mask, a: DirectionSample, b: DirectionSample) -> DirectionSample:
    mm = mask[..., None]
    return DirectionSample(
        p=jnp.where(mm, a.p, b.p),
        n=jnp.where(mm, a.n, b.n),
        uv=jnp.where(mm, a.uv, b.uv),
        d=jnp.where(mm, a.d, b.d),
        dist=jnp.where(mask, a.dist, b.dist),
        pdf=jnp.where(mask, a.pdf, b.pdf),
        delta=jnp.where(mask, a.delta, b.delta),
        emitter_idx=jnp.where(mask, a.emitter_idx, b.emitter_idx),
    )


def _sample_sphere(em, ref_p, e_idx, sample2, ep=None):
    """Visible-cone sampling of an analytic sphere light
    (sphere.cpp sample_direction / PBRT cone sampling). The radius rides in
    the cutoff_cos slot; area holds 4 pi r^2."""
    if ep is None:
        ep = em.gather(e_idx)
    n = ref_p.shape[0]
    c = ep["position"]
    r = ep["cutoff_cos"]
    dvec = c - ref_p
    dc = jnp.linalg.norm(dvec, axis=-1)
    dc_safe = jnp.maximum(dc, 1e-9)
    dhat = dvec / dc_safe[..., None]
    outside = dc > r * 1.0001

    sin2_max = jnp.clip((r / dc_safe) ** 2, 0.0, 1.0)
    cos_max = jnp.sqrt(jnp.maximum(1.0 - sin2_max, 0.0))
    u1 = sample2[..., 0]
    u2 = sample2[..., 1]
    cos_t = 1.0 - u1 * (1.0 - cos_max)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * m.Pi * u2
    s_ax, t_ax = fr.coordinate_system(dhat)
    d = (
        s_ax * (sin_t * jnp.cos(phi))[..., None]
        + t_ax * (sin_t * jnp.sin(phi))[..., None]
        + dhat * cos_t[..., None]
    )
    # distance to the near intersection along d
    under = r * r - dc * dc * (1.0 - cos_t * cos_t)
    dist = dc * cos_t - jnp.sqrt(jnp.maximum(under, 0.0))
    p_hit = ref_p + d * dist[..., None]
    n_hit = fr.normalize(p_hit - c)
    pdf_cone = 1.0 / jnp.maximum(2.0 * m.Pi * (1.0 - cos_max), 1e-9)

    # inside the sphere: uniform area sampling with density conversion
    from ..core import warp

    p_area = c + warp.square_to_uniform_sphere(sample2) * r[..., None]
    d_in = p_area - ref_p
    dist_in = jnp.linalg.norm(d_in, axis=-1)
    d_in = d_in / jnp.maximum(dist_in, 1e-9)[..., None]
    n_in = fr.normalize(p_area - c)
    cos_l_in = jnp.abs(fr.dot(d_in, n_in))
    pdf_in = dist_in * dist_in / jnp.maximum(
        cos_l_in * 4.0 * m.Pi * r * r, 1e-9
    )

    return DirectionSample(
        p=jnp.where(outside[..., None], p_hit, p_area),
        n=jnp.where(outside[..., None], n_hit, n_in),
        uv=jnp.zeros((n, 2), jnp.float32),
        d=jnp.where(outside[..., None], d, d_in),
        dist=jnp.where(outside, dist, dist_in),
        pdf=jnp.where(outside, pdf_cone, pdf_in),
        delta=jnp.zeros((n,), bool),
        emitter_idx=e_idx,
    )


def _sample_area(em, geo, ref_p, e_idx, sample2, ep=None):
    if ep is None:
        ep = em.gather(e_idx)
    n = ref_p.shape[0]
    # triangle pick by per-emitter area CDF; row fetches via one-hot matmul
    # (see core.math.small_gather)
    cdf_rows = m.small_gather(em.tri_cdf, e_idx)  # [N, T]
    idx_rows = m.small_gather(em.tri_idx.astype(jnp.float32), e_idx)  # [N, T]
    u = sample2[..., 0]
    slot = jnp.sum((cdf_rows < u[..., None]).astype(jnp.int32), axis=-1)
    slot = jnp.clip(slot, 0, em.tri_cdf.shape[1] - 1)
    tri = m.select_along(idx_rows, slot).astype(jnp.int32)
    tri_c = jnp.maximum(tri, 0)

    # reuse u within the chosen cdf cell, sample barycentric with (u', v)
    lo = jnp.where(slot > 0, m.select_along(cdf_rows, jnp.maximum(slot - 1, 0)), 0.0)
    hi = m.select_along(cdf_rows, slot)
    u_re = jnp.clip((u - lo) / jnp.maximum(hi - lo, 1e-12), 0.0, 1.0 - 1e-6)
    bary = warp.square_to_uniform_triangle(
        jnp.stack([u_re, sample2[..., 1]], axis=-1)
    )

    # single packed fetch (p0, e1, e2) instead of three vertex gathers
    rows = m.small_gather(geo.tri_isect, tri_c)
    p0 = rows[..., 0:3]
    p1 = p0 + rows[..., 3:6]
    p2 = p0 + rows[..., 6:9]
    pos = (
        p0 * (1.0 - bary[..., 0:1] - bary[..., 1:2])
        + p1 * bary[..., 0:1]
        + p2 * bary[..., 1:2]
    )
    ng = fr.normalize(jnp.cross(p1 - p0, p2 - p0))

    to_l = pos - ref_p
    dist2 = fr.squared_norm(to_l)
    dist = jnp.sqrt(jnp.maximum(dist2, 1e-20))
    d = to_l / dist[..., None]
    cos_l = -fr.dot(d, ng)
    area = jnp.maximum(ep["area"], 1e-12)
    pdf = jnp.where(cos_l > 1e-6, dist2 / (jnp.maximum(cos_l, 1e-9) * area), 0.0)
    return DirectionSample(
        p=pos, n=ng, uv=bary, d=d, dist=dist, pdf=pdf,
        delta=jnp.zeros((n,), bool), emitter_idx=e_idx,
    )


def _sample_point(em, ref_p, e_idx, ep=None):
    if ep is None:
        ep = em.gather(e_idx)
    n = ref_p.shape[0]
    pos = ep["position"]
    to_l = pos - ref_p
    dist = jnp.sqrt(jnp.maximum(fr.squared_norm(to_l), 1e-20))
    d = to_l / dist[..., None]
    return DirectionSample(
        p=pos, n=-d, uv=jnp.zeros((n, 2), jnp.float32), d=d, dist=dist,
        pdf=jnp.ones((n,), jnp.float32), delta=jnp.ones((n,), bool),
        emitter_idx=e_idx,
    )


def _sample_constant(em, ref_p, e_idx, sample2):
    n = ref_p.shape[0]
    d = warp.square_to_uniform_sphere(sample2)
    dist = jnp.full((n,), 2.0) * em.scene_radius + 1.0
    return DirectionSample(
        p=ref_p + d * dist[..., None], n=-d,
        uv=jnp.zeros((n, 2), jnp.float32), d=d, dist=dist,
        pdf=jnp.full((n,), m.InvFourPi), delta=jnp.zeros((n,), bool),
        emitter_idx=e_idx,
    )


def _sample_directionalspot(em, ref_p, e_idx, sample2, ep=None):
    """Directional emitter with angular spread (reference
    src/emitters/directionalspot.cpp:155-186).

    DOCUMENTED DEVIATION: the reference jitters the NEE delta direction
    within a sin(spread_angle) disk. Combined with this renderer's
    lobe-centered angular-coherence falloff (see ROUND1_NOTES — the
    reference's own specular-offset falloff effectively zeroes every
    non-zero diffraction order, so ITS jitter never meets a narrow lobe),
    that jitter turns the delta-light x narrow-wave-lobe product into an
    extreme-variance estimator: measured parity against the reference's
    shipped gratings renders DEGRADES 3x (tonemapped MAD 23.7 vs 8.4 at
    64 spp, 800x600) when jittering. We therefore sample the exact axis
    (pure delta); the spread still defines the source solid angle for
    PLT beam sourcing (integrators/plt.py source_beam)."""
    return _sample_directional(em, ref_p, e_idx, ep)


def _sample_directional(em, ref_p, e_idx, ep=None):
    if ep is None:
        ep = em.gather(e_idx)
    n = ref_p.shape[0]
    d = -ep["direction"]  # direction property points *from* the emitter
    dist = 2.0 * em.scene_radius * jnp.ones((n,)) + 1.0
    return DirectionSample(
        p=ref_p + d * dist[..., None], n=-d,
        uv=jnp.zeros((n, 2), jnp.float32), d=d, dist=dist,
        pdf=jnp.ones((n,), jnp.float32), delta=jnp.ones((n,), bool),
        emitter_idx=e_idx,
    )
