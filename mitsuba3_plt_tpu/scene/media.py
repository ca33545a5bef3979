"""Participating media: homogeneous + heterogeneous (grid) media + phase
functions.

Functional twin of the reference's media/phase/volume layer (src/media/
{homogeneous,heterogeneous}.cpp, src/volumes/grid.cpp, src/phase/
{hg,isotropic,rayleigh}.cpp): ONE global medium filling the scene.
Heterogeneous transport is null-collision tracking: distance
sampling by delta tracking and transmittance by ratio tracking, both as
fixed-trip-count lax.scan sweeps with active masks (no data-dependent
loop bounds under jit).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core import frame as fr

PHASE_ISOTROPIC = 0
PHASE_HG = 1
PHASE_RAYLEIGH = 2
PHASE_SGGX = 3      # specular SGGX microflakes (src/phase/sggx.cpp)
PHASE_TAB = 4       # tabulated over cos(theta) (src/phase/tabphase.cpp)
PHASE_BLEND = 5     # weight-blend of two phases (src/phase/blendphase.cpp)

# fixed null-collision sweep length: majorant-normalized free paths per
# lane; enough for optical depths ~ tens (masked lanes idle, XLA-friendly)
TRACK_STEPS = 64


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Medium:
    sigma_t: Any   # [3] extinction (heterogeneous: scaled by density)
    albedo: Any    # [3] single-scattering albedo (sigma_s = albedo * sigma_t)
    g: Any         # scalar HG asymmetry
    phase_type: int = dataclasses.field(default=PHASE_HG, metadata=dict(static=True))
    # heterogeneous density grid (reference src/volumes/grid.cpp):
    # density [Dz, Dy, Dx] sampled trilinearly inside the world-space box
    # [box_min, box_max]; density outside is 0
    density: Any = None
    box_min: Any = None
    box_max: Any = None
    majorant: Any = None  # scalar: max density (delta-tracking bound)
    heterogeneous: bool = dataclasses.field(
        default=False, metadata=dict(static=True)
    )
    # SGGX microflake matrix S, 6 components (Sxx, Syy, Szz, Sxy, Sxz, Syz)
    sggx_S: Any = None
    # tabulated phase over cos(theta) in [-1, 1]: normalized node pdf values
    # + cumulative trapezoids (physics convention, tabphase.cpp:59-66)
    tab_pdf: Any = None   # [K]
    tab_cdf: Any = None   # [K-1]
    # blendphase: second phase type + blend weight (weight = probability of
    # the SECOND phase, matching blendphase.cpp semantics)
    phase2_type: int = dataclasses.field(
        default=PHASE_ISOTROPIC, metadata=dict(static=True)
    )
    blend_weight: Any = None
    g2: Any = None        # HG asymmetry of the second blended phase

    @staticmethod
    def create(sigma_t=(0.5, 0.5, 0.5), albedo=(0.8, 0.8, 0.8), g=0.0,
               phase_type=PHASE_HG, sggx_S=None, tab_values=None,
               phase2_type=PHASE_ISOTROPIC, blend_weight=0.5, g2=0.0):
        kw = {}
        if sggx_S is not None:
            kw["sggx_S"] = jnp.asarray(sggx_S, jnp.float32)
        if tab_values is not None:
            pdf, cdf = build_tab_tables(tab_values)
            kw["tab_pdf"] = pdf
            kw["tab_cdf"] = cdf
        return Medium(
            sigma_t=jnp.asarray(sigma_t, jnp.float32),
            albedo=jnp.asarray(albedo, jnp.float32),
            g=jnp.asarray(g, jnp.float32),
            phase_type=phase_type,
            phase2_type=phase2_type,
            blend_weight=jnp.asarray(blend_weight, jnp.float32),
            g2=jnp.asarray(g2, jnp.float32),
            **kw,
        )

    @staticmethod
    def create_heterogeneous(density, box_min=(-1, -1, -1), box_max=(1, 1, 1),
                             sigma_t=(1.0, 1.0, 1.0), albedo=(0.8, 0.8, 0.8),
                             g=0.0, phase_type=PHASE_HG):
        import numpy as np

        density = jnp.asarray(density, jnp.float32)
        return Medium(
            sigma_t=jnp.asarray(sigma_t, jnp.float32),
            albedo=jnp.asarray(albedo, jnp.float32),
            g=jnp.asarray(g, jnp.float32),
            phase_type=phase_type,
            density=density,
            box_min=jnp.asarray(box_min, jnp.float32),
            box_max=jnp.asarray(box_max, jnp.float32),
            majorant=jnp.asarray(
                float(np.asarray(density).max()), jnp.float32
            ),
            heterogeneous=True,
        )

    # ------------------------------------------------------------------
    def density_at(self, p):
        """Trilinear density lookup at world positions p [N, 3] -> [N]
        (grid.cpp eval); zero outside the box."""
        rel = (p - self.box_min) / (self.box_max - self.box_min)
        inside = jnp.all((rel >= 0.0) & (rel <= 1.0), axis=-1)
        D = jnp.asarray(self.density)
        dz, dy, dx = D.shape
        # grid sample coords (cell centers at integer + 0.5 like bitmap)
        gx = jnp.clip(rel[..., 0] * dx - 0.5, 0.0, dx - 1.0)
        gy = jnp.clip(rel[..., 1] * dy - 0.5, 0.0, dy - 1.0)
        gz = jnp.clip(rel[..., 2] * dz - 0.5, 0.0, dz - 1.0)
        x0 = jnp.floor(gx).astype(jnp.int32)
        y0 = jnp.floor(gy).astype(jnp.int32)
        z0 = jnp.floor(gz).astype(jnp.int32)
        x1 = jnp.minimum(x0 + 1, dx - 1)
        y1 = jnp.minimum(y0 + 1, dy - 1)
        z1 = jnp.minimum(z0 + 1, dz - 1)
        fx, fy, fz = gx - x0, gy - y0, gz - z0
        c000 = D[z0, y0, x0]
        c001 = D[z0, y0, x1]
        c010 = D[z0, y1, x0]
        c011 = D[z0, y1, x1]
        c100 = D[z1, y0, x0]
        c101 = D[z1, y0, x1]
        c110 = D[z1, y1, x0]
        c111 = D[z1, y1, x1]
        c00 = c000 * (1 - fx) + c001 * fx
        c01 = c010 * (1 - fx) + c011 * fx
        c10 = c100 * (1 - fx) + c101 * fx
        c11 = c110 * (1 - fx) + c111 * fx
        c0 = c00 * (1 - fy) + c01 * fy
        c1 = c10 * (1 - fy) + c11 * fy
        return jnp.where(inside, c0 * (1 - fz) + c1 * fz, 0.0)

    def transmittance(self, dist):
        """exp(-sigma_t * d) [N, 3] (homogeneous Beer-Lambert)."""
        return jnp.exp(-self.sigma_t[None, :] * dist[..., None])

    def transmittance_ratio(self, o, d, dist, sampler, dim0):
        """Heterogeneous transmittance by ratio tracking
        (heterogeneous.cpp's unbiased estimator): [N] scalar estimate of
        exp(-int sigma_t0 density ds) along o + t d, t in [0, dist]."""
        n = o.shape[0]
        s0 = jnp.maximum(self.sigma_t[0] * self.majorant, 1e-8)

        def body(carry, i):
            t, tr, alive = carry
            u = sampler.next_1d(dim0 + 2 * i)
            t_new = t - jnp.log(jnp.maximum(1.0 - u, 1e-20)) / s0
            esc = t_new >= dist
            dens = self.density_at(o + d * t_new[..., None])
            ratio = 1.0 - dens / jnp.maximum(self.majorant, 1e-8)
            tr_new = jnp.where(alive & ~esc, tr * ratio, tr)
            alive = alive & ~esc & (tr_new > 1e-5)
            return (jnp.where(alive, t_new, t), tr_new, alive), None

        init = (
            jnp.zeros((n,), jnp.float32), jnp.ones((n,), jnp.float32),
            jnp.ones((n,), bool),
        )
        (t, tr, alive), _ = jax.lax.scan(
            body, init, jnp.arange(TRACK_STEPS, dtype=jnp.uint32)
        )
        # lanes still alive after the sweep: conservative zero (deep media)
        return jnp.where(alive, 0.0, tr)

    def sample_distance_delta(self, o, d, t_max, sampler, dim0):
        """Heterogeneous free-flight by delta tracking
        (heterogeneous.cpp sample_interaction): returns (t, is_real) where
        is_real marks a real collision before t_max; the estimator weight
        of the chain is 1 (null collisions cancel)."""
        n = o.shape[0]
        s0 = jnp.maximum(self.sigma_t[0] * self.majorant, 1e-8)

        def body(carry, i):
            t, done, real = carry
            u = sampler.next_1d(dim0 + 2 * i)
            u2 = sampler.next_1d(dim0 + 2 * i + 1)
            t_new = t - jnp.log(jnp.maximum(1.0 - u, 1e-20)) / s0
            esc = t_new >= t_max
            dens = self.density_at(o + d * t_new[..., None])
            p_real = dens / jnp.maximum(self.majorant, 1e-8)
            hit_real = u2 < p_real
            newly_done = ~done & (esc | hit_real)
            real = jnp.where(newly_done, hit_real & ~esc, real)
            t = jnp.where(done, t, jnp.where(esc, t_max, t_new))
            done = done | newly_done
            return (t, done, real), None

        init = (
            jnp.zeros((n,), jnp.float32), jnp.zeros((n,), bool),
            jnp.zeros((n,), bool),
        )
        (t, done, real), _ = jax.lax.scan(
            body, init, jnp.arange(TRACK_STEPS, dtype=jnp.uint32)
        )
        # unfinished lanes: treat as escaped (bounded optical depth)
        real = real & done
        t = jnp.where(done, t, t_max)
        return t, real

    def sample_distance(self, u, channel):
        """Free-flight distance sampled from the `channel` extinction
        (reference homogeneous.cpp sample_interaction); returns t."""
        s = self.sigma_t[channel]
        return -jnp.log(jnp.maximum(1.0 - u, 1e-20)) / jnp.maximum(s, 1e-8)

    def pdf_distance(self, t, channel):
        s = self.sigma_t[channel]
        return s * jnp.exp(-s * t)

    def pdf_surface(self, t, channel):
        """Probability of flying past distance t without interaction."""
        s = self.sigma_t[channel]
        return jnp.exp(-s * t)


# --- Henyey-Greenstein phase (reference src/phase/hg.cpp) ------------------

def hg_eval(g, cos_theta):
    """cos_theta is measured against the PROPAGATION direction (forward
    scattering = +1, where the g>0 peak sits)."""
    denom = 1.0 + g * g - 2.0 * g * cos_theta
    return m.InvFourPi * (1.0 - g * g) / jnp.maximum(
        denom * jnp.sqrt(jnp.maximum(denom, 1e-12)), 1e-12
    )


def hg_sample(g, u2):
    """Sample wo about +z; returns (wo_local [N,3], pdf [N])."""
    u1 = u2[..., 0]
    g_safe = jnp.where(jnp.abs(g) < 1e-3, 1e-3, g)
    sqr_term = (1.0 - g_safe * g_safe) / (1.0 - g_safe + 2.0 * g_safe * u1)
    cos_theta = jnp.where(
        jnp.abs(g) < 1e-3,
        1.0 - 2.0 * u1,  # isotropic limit
        (1.0 + g_safe * g_safe - sqr_term * sqr_term) / (2.0 * g_safe),
    )
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    phi = 2.0 * m.Pi * u2[..., 1]
    wo = jnp.stack(
        [sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta],
        axis=-1,
    )
    # note: HG sampled about the INCOMING propagation direction; cos_theta is
    # measured against it, so eval(g, cos) == pdf
    return wo, hg_eval(g, cos_theta)


def rayleigh_eval(cos_theta):
    return (3.0 / (16.0 * m.Pi)) * (1.0 + cos_theta * cos_theta)


# --- SGGX specular microflakes (reference src/phase/sggx.cpp; Heitz et al.
# 2015 "The SGGX Microflake Distribution") -----------------------------------

def _sggx_mat(S6):
    """Symmetric matrix from (Sxx, Syy, Szz, Sxy, Sxz, Syz)."""
    sxx, syy, szz, sxy, sxz, syz = (S6[..., i] for i in range(6))
    return jnp.stack(
        [
            jnp.stack([sxx, sxy, sxz], -1),
            jnp.stack([sxy, syy, syz], -1),
            jnp.stack([sxz, syz, szz], -1),
        ],
        axis=-2,
    )


def sggx_projected_area(wi, S6):
    """sigma(wi) = sqrt(wi^T S wi)."""
    S = _sggx_mat(S6)
    Swi = jnp.einsum("...ij,...j->...i", S, wi)
    return jnp.sqrt(jnp.maximum(jnp.sum(wi * Swi, -1), 1e-12))


def sggx_ndf(m_vec, S6):
    """D(m) = 1 / (pi sqrt|S| (m^T S^-1 m)^2)."""
    S = _sggx_mat(S6)
    det = jnp.linalg.det(S)
    Sinv = jnp.linalg.inv(S + 1e-9 * jnp.eye(3))
    q = jnp.einsum("...i,...ij,...j->...", m_vec, Sinv, m_vec)
    return 1.0 / jnp.maximum(
        m.Pi * jnp.sqrt(jnp.maximum(det, 1e-18)) * q * q, 1e-12
    )


def sggx_sample_vn(wi, u2, S6):
    """Sample a visible microflake normal around wi (paper supplemental
    'sample_VNDF'): disk sample lifted through the Cholesky-like factor of
    S projected into an orthonormal basis (wk, wj, wi)."""
    r = jnp.sqrt(u2[..., 0])
    phi = 2.0 * m.Pi * u2[..., 1]
    u = r * jnp.cos(phi)
    v = r * jnp.sin(phi)
    w = jnp.sqrt(jnp.maximum(1.0 - u * u - v * v, 0.0))

    wk, wj = fr.coordinate_system(wi)
    S = _sggx_mat(S6)

    def q(a, b):
        return jnp.einsum(
            "...i,...i->...", a, jnp.einsum("...ij,...j->...i", S, b)
        )

    S_kk = q(wk, wk)
    S_jj = q(wj, wj)
    S_ii = q(wi, wi)
    S_kj = q(wk, wj)
    S_ki = q(wk, wi)
    S_ji = q(wj, wi)

    det = (
        S_kk * S_jj * S_ii - S_kj * S_kj * S_ii - S_ki * S_ki * S_jj
        - S_ji * S_ji * S_kk + 2.0 * S_kj * S_ki * S_ji
    )
    sqrt_det = jnp.sqrt(jnp.maximum(jnp.abs(det), 1e-18))
    inv_sqrt_Sii = 1.0 / jnp.sqrt(jnp.maximum(S_ii, 1e-12))
    tmp = jnp.sqrt(jnp.maximum(S_jj * S_ii - S_ji * S_ji, 1e-12))
    Mk = jnp.stack([sqrt_det / tmp, jnp.zeros_like(tmp), jnp.zeros_like(tmp)], -1)
    Mj = jnp.stack(
        [
            -inv_sqrt_Sii * (S_ki * S_ji - S_kj * S_ii) / tmp,
            inv_sqrt_Sii * tmp,
            jnp.zeros_like(tmp),
        ],
        -1,
    )
    Mi = jnp.stack(
        [inv_sqrt_Sii * S_ki, inv_sqrt_Sii * S_ji, inv_sqrt_Sii * S_ii], -1
    )
    wm_kji = fr.normalize(
        u[..., None] * Mk + v[..., None] * Mj + w[..., None] * Mi
    )
    return (
        wk * wm_kji[..., 0:1] + wj * wm_kji[..., 1:2] + wi * wm_kji[..., 2:3]
    )


def sggx_pdf_wo(wi, wo, S6):
    """Phase value/pdf of the specular SGGX: wo = reflect(wi, m) with m a
    visible normal => p(wo) = D(h) / (4 sigma(wi)) with h = |wi + wo| hat
    (sggx.cpp sample(): 0.25 * sggx_pdf / projected_area)."""
    h = fr.normalize(wi + wo)
    return 0.25 * sggx_ndf(h, S6) / sggx_projected_area(wi, S6)


# --- tabulated phase over cos(theta) (reference src/phase/tabphase.cpp) ----

def build_tab_tables(values):
    """Host: normalized node pdf over the cos grid [-1, 1] + cumulative
    trapezoids (K-1 bands). Normalization: 2*pi * integral d(cos) = 1."""
    import numpy as np

    v = np.asarray(values, np.float64)
    K = len(v)
    dc = 2.0 / (K - 1)
    band = 0.5 * (v[:-1] + v[1:]) * dc
    total = band.sum() * 2.0 * np.pi
    total = total if total > 0 else 1.0
    pdf = (v / total).astype(np.float32)           # per-steradian at node
    cdf = np.cumsum(band / band.sum()).astype(np.float32)
    cdf[-1] = 1.0
    return jnp.asarray(pdf), jnp.asarray(cdf)


def tab_eval(medium, cos_theta):
    """Phase value at cos(theta) against the propagation direction. The
    reference tabulates in physics convention (theta' = pi - theta,
    tabphase.cpp:85-99): eval at cos_theta' = -cos_theta."""
    pdf = medium.tab_pdf
    K = pdf.shape[0]
    tpos = (-cos_theta + 1.0) * 0.5 * (K - 1)
    i = jnp.clip(jnp.floor(tpos).astype(jnp.int32), 0, K - 2)
    f = tpos - i
    return pdf[i] * (1.0 - f) + pdf[i + 1] * f


def tab_sample_cos(medium, u1):
    """Inverse-CDF sample of cos_theta' (physics), returns cos_theta
    (graphics, against propagation)."""
    pdf = medium.tab_pdf
    cdf = medium.tab_cdf
    K = pdf.shape[0]
    dc = 2.0 / (K - 1)
    i = jnp.clip(
        jnp.sum((cdf < u1[..., None]).astype(jnp.int32), -1), 0, K - 2
    )
    prev = jnp.where(i > 0, cdf[jnp.maximum(i - 1, 0)], 0.0)
    # band mass in the normalized-cdf domain -> convert via total band mass
    d0 = pdf[i]
    d1 = pdf[i + 1]
    band = 0.5 * (d0 + d1)
    xi = jnp.maximum(u1 - prev, 0.0) / jnp.maximum(
        cdf[i] - prev, 1e-12
    ) * band  # rescaled mass within the band (linear density d0->d1)
    disc = jnp.maximum(d0 * d0 + 2.0 * (d1 - d0) * xi, 0.0)
    t = jnp.where(
        jnp.abs(d1 - d0) > 1e-9,
        (jnp.sqrt(disc) - d0) / jnp.where(jnp.abs(d1 - d0) > 1e-9, d1 - d0, 1.0),
        xi / jnp.maximum(d0, 1e-12),
    )
    t = jnp.clip(t, 0.0, 1.0)
    cos_prime = -1.0 + (i.astype(jnp.float32) + t) * dc
    return -cos_prime  # physics -> graphics convention


# --- dispatch ---------------------------------------------------------------

def _phase_eval_single(ptype, medium, g, wi_world, wo_world):
    """Phase value for one analytic type; wi_world points TOWARD the
    incident source, wo_world is the outgoing scattering direction."""
    cos_theta = fr.dot(wo_world, -wi_world)
    if ptype == PHASE_HG:
        return hg_eval(g, cos_theta)
    if ptype == PHASE_RAYLEIGH:
        return rayleigh_eval(cos_theta)
    if ptype == PHASE_SGGX:
        return sggx_pdf_wo(wi_world, wo_world, medium.sggx_S)
    if ptype == PHASE_TAB:
        return tab_eval(medium, cos_theta)
    return jnp.full_like(cos_theta, m.InvFourPi)


def _phase_sample_single(ptype, medium, g, wi_world, u2):
    d = -wi_world  # propagation direction
    if ptype == PHASE_HG:
        wo_local, pdf = hg_sample(g, u2)
    elif ptype == PHASE_SGGX:
        mvec = sggx_sample_vn(wi_world, u2, medium.sggx_S)
        wo = fr.normalize(fr.reflect_n(wi_world, mvec))
        return wo, sggx_pdf_wo(wi_world, wo, medium.sggx_S)
    elif ptype == PHASE_TAB:
        cos_theta = tab_sample_cos(medium, u2[..., 0])
        sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
        phi = 2.0 * m.Pi * u2[..., 1]
        wo_local = jnp.stack(
            [sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta],
            axis=-1,
        )
        pdf = tab_eval(medium, cos_theta)
    else:
        from ..core import warp

        wo_local = warp.square_to_uniform_sphere(u2)
        pdf = jnp.full(wo_local.shape[:-1], m.InvFourPi)
        if ptype == PHASE_RAYLEIGH:
            pdf = rayleigh_eval(wo_local[..., 2])  # approximate via reuse
    s, t = fr.coordinate_system(d)
    wo_world = (
        s * wo_local[..., 0:1] + t * wo_local[..., 1:2] + d * wo_local[..., 2:3]
    )
    return wo_world, pdf


def phase_eval_dir(medium: Medium, wi_world, wo_world):
    """Phase value/pdf for scattering wi -> wo (full directions; SGGX is
    anisotropic so a cosine alone is not enough)."""
    if medium.phase_type == PHASE_BLEND:
        w = medium.blend_weight
        v0 = _phase_eval_single(PHASE_HG, medium, medium.g, wi_world, wo_world)
        v1 = _phase_eval_single(
            medium.phase2_type, medium, medium.g2, wi_world, wo_world
        )
        return (1.0 - w) * v0 + w * v1
    return _phase_eval_single(
        medium.phase_type, medium, medium.g, wi_world, wo_world
    )


def phase_eval(medium: Medium, cos_theta):
    """Legacy cosine-only entry (isotropic-in-azimuth phases). Kept for
    callers that precompute cos(theta) against the propagation direction."""
    if medium.phase_type == PHASE_HG:
        return hg_eval(medium.g, cos_theta)
    if medium.phase_type == PHASE_RAYLEIGH:
        return rayleigh_eval(cos_theta)
    if medium.phase_type == PHASE_TAB:
        return tab_eval(medium, cos_theta)
    if medium.phase_type == PHASE_BLEND:
        w = medium.blend_weight
        v0 = hg_eval(medium.g, cos_theta)
        if medium.phase2_type == PHASE_HG:
            v1 = hg_eval(medium.g2, cos_theta)
        elif medium.phase2_type == PHASE_RAYLEIGH:
            v1 = rayleigh_eval(cos_theta)
        elif medium.phase2_type == PHASE_TAB:
            v1 = tab_eval(medium, cos_theta)
        else:
            v1 = jnp.full_like(cos_theta, m.InvFourPi)
        return (1.0 - w) * v0 + w * v1
    return jnp.full_like(cos_theta, m.InvFourPi)


def phase_sample(medium: Medium, wi_world, u2):
    """Sample a world-space scattering direction about the propagation
    direction d = -wi_world. Returns (wo_world, pdf)."""
    if medium.phase_type == PHASE_BLEND:
        w = medium.blend_weight
        pick2 = u2[..., 0] < w
        u0 = jnp.where(
            pick2, u2[..., 0] / jnp.maximum(w, 1e-9),
            (u2[..., 0] - w) / jnp.maximum(1.0 - w, 1e-9),
        )
        u2r = jnp.stack([u0, u2[..., 1]], -1)
        wo0, _ = _phase_sample_single(PHASE_HG, medium, medium.g, wi_world, u2r)
        wo1, _ = _phase_sample_single(
            medium.phase2_type, medium, medium.g2, wi_world, u2r
        )
        wo = jnp.where(pick2[..., None], wo1, wo0)
        return wo, phase_eval_dir(medium, wi_world, wo)
    return _phase_sample_single(
        medium.phase_type, medium, medium.g, wi_world, u2
    )
