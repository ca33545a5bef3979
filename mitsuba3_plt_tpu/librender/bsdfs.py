"""BSDF implementations + masked dispatch.

Each implementation is a set of pure functions over gathered per-lane
parameter dicts, operating in the local shading frame (z-up, wi/wo point away
from the surface). `sample` returns (BSDFSample, weight) where weight is
f*cos/pdf — the same contract as the reference (bsdf.h sample()).

Value shapes: unpolarized [N, C]; polarized values are PLANAR Mueller stacks
(mueller.MuellerP: 16 row-major [N, C] planes with None = structural zero)
whose implicit Stokes bases follow the reference convention (light travels
-wo_hat -> +wi_hat, bases = stokes_basis of those local directions; cf.
src/bsdfs/conductor.cpp:270-305) — converted to world bases by the caller via
`to_world_mueller`. Planar instead of [N, 4, 4, C]: every jnp.stack lowers
to a materializing XLA concatenate; planes fuse.
"""
from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core import frame as fr
from ..core import warp
from ..core import spectrum as spec
from ..config import RenderConfig
from . import fresnel as fres
from . import microfacet as mf
from . import mueller as mu
from .records import BSDFSample
from .bsdf import (
    BSDFContext,
    BSDFFlags,
    MaterialTable,
    TransportMode,
    BSDF_NULL,
    BSDF_DIFFUSE,
    BSDF_CONDUCTOR,
    BSDF_ROUGH_CONDUCTOR,
    BSDF_DIELECTRIC,
    BSDF_THIN_DIELECTRIC,
    BSDF_ROUGH_DIELECTRIC,
    BSDF_PLASTIC,
    BSDF_ROUGH_PLASTIC,
    BSDF_MASK,
    BSDF_POLARIZER,
    BSDF_RETARDER,
    BSDF_CIRCULAR,
    BSDF_PPLASTIC,
    BSDF_MEASURED,
    BSDF_ROUGH_GRATING,
    BSDF_BLEND,
    BSDF_NORMALMAP,
    BSDF_BUMPMAP,
    BSDF_PRINCIPLED,
    BSDF_PRINCIPLED_THIN,
    BSDF_HAIR,
    BSDF_MEASURED_POLARIZED,
)


# --- helpers ---------------------------------------------------------------

def eval_color(p, key: str, cfg: RenderConfig, wavelengths):
    """Color parameter as [N, C]: RGB (optionally textured), or spectral
    upsampling. Texture lookups (bitmap stack / procedural checkerboard)
    apply to base_color when the dispatcher stashed '_uv'/'_tex_stack'
    (reference src/textures/{bitmap,checkerboard}.cpp)."""
    rgb = p[key]
    if key == "base_color" and p.get("tex_mode") is not None and "_uv" in p:
        uv = p["_uv"] * p["tex_uv_scale"]
        mode = p["tex_mode"]
        # checkerboard
        cell = (jnp.floor(uv[..., 0]) + jnp.floor(uv[..., 1])).astype(jnp.int32)
        checker = jnp.where((cell % 2 == 0)[..., None], rgb, p["tex_color1"])
        rgb = jnp.where((mode == 2)[..., None], checker, rgb)
        # bitmap stack (bilinear, repeat wrap)
        tex_stack = p.get("_tex_stack")
        if tex_stack is not None:
            ti = jnp.clip(p["tex_idx"], 0, tex_stack.shape[0] - 1)
            c = _bitmap_bilinear(tex_stack, ti, uv)
            rgb = jnp.where((mode == 1)[..., None], c, rgb)
        # mesh_attribute: interpolated vertex color (mesh_attribute.cpp)
        vcol = p.get("_vcol")
        if vcol is not None:
            rgb = jnp.where((mode == 3)[..., None], vcol, rgb)
        # volume texture: 3D grid sampled at the world hit point
        # (src/textures/volume.cpp)
        vgrid = p.get("_vtex_grid")
        if vgrid is not None and "_p" in p:
            lo = p["_vtex_min"]
            hi = p["_vtex_max"]
            q = jnp.clip(
                (p["_p"] - lo) / jnp.maximum(hi - lo, 1e-9), 0.0, 1.0
            )
            dz, dy, dx = vgrid.shape[:3]
            xi = jnp.clip(
                jnp.round(q[..., 0] * (dx - 1)).astype(jnp.int32), 0, dx - 1
            )
            yi = jnp.clip(
                jnp.round(q[..., 1] * (dy - 1)).astype(jnp.int32), 0, dy - 1
            )
            zi = jnp.clip(
                jnp.round(q[..., 2] * (dz - 1)).astype(jnp.int32), 0, dz - 1
            )
            vc = vgrid[zi, yi, xi]
            rgb = jnp.where((mode == 4)[..., None], vc, rgb)
    if cfg.spectral:
        coeff = p.get(key + "_coeff")
        flat = jnp.broadcast_to(
            spec.luminance_rgb(rgb)[..., None],
            (*rgb.shape[:-1], cfg.n_channels),
        )
        if coeff is None:
            return flat
        up = spec.sigmoid_poly_eval(coeff[..., None, :], wavelengths)
        if key == "base_color" and p.get("tex_mode") is not None:
            # textured lanes fall back to flat-luminance spectra (per-texel
            # spectral upsampling arrives with the rgb2spec table module)
            return jnp.where((p["tex_mode"] == 0)[..., None], up, flat)
        return up
    if cfg.mono:
        return spec.luminance_rgb(rgb)[..., None]
    return rgb


def spectral_or_rgb(v_rgb, cfg):
    return v_rgb


def depolarized(value, cfg: RenderConfig):
    """Lift an unpolarized [N, C] value to the configured representation."""
    if not cfg.polarized:
        return value
    return mu.MuellerP.depolarizer(value)


def mueller_from_unpolarized(mueller_nc, cfg):
    """[N, C, 4, 4] stacked -> planar MuellerP."""
    return mu.MuellerP(m=tuple(
        mueller_nc[..., i, j] for i in range(4) for j in range(4)
    ))


def mul_value(a, b_unpol, cfg: RenderConfig):
    """Multiply a (possibly Mueller) value by an unpolarized [N, C] factor."""
    if cfg.polarized:
        return mu.p_scale(a, b_unpol)
    return a * b_unpol


def zeros_value(n, cfg: RenderConfig):
    if cfg.polarized:
        return mu.MuellerP.zero()
    return jnp.zeros((n, cfg.n_channels), jnp.float32)


def where_value(mask, a, b, cfg: RenderConfig):
    if cfg.polarized:
        return mu.p_where(mask, a, b)
    return jnp.where(mask[..., None], a, b)


def add_value(a, b, cfg: RenderConfig):
    if cfg.polarized:
        return mu.p_padd(a, b)
    return a + b


def _bitmap_bilinear(tex_stack, ti, uv):
    """Bilinear fetch from the bitmap stack [T, R, R, 3] (repeat wrap)."""
    R = tex_stack.shape[1]
    x = jnp.mod(uv[..., 0], 1.0) * R - 0.5
    y = jnp.mod(uv[..., 1], 1.0) * R - 0.5
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0m, x1m = jnp.mod(x0, R), jnp.mod(x0 + 1, R)
    y0m, y1m = jnp.mod(y0, R), jnp.mod(y0 + 1, R)
    return (
        tex_stack[ti, y0m, x0m] * (1 - fx) * (1 - fy)
        + tex_stack[ti, y0m, x1m] * fx * (1 - fy)
        + tex_stack[ti, y1m, x0m] * (1 - fx) * fy
        + tex_stack[ti, y1m, x1m] * fx * fy
    )


def _spec_reflect_mueller(wo_hat, wi_hat, mueller_fn, normal, cfg):
    """Shared polarized specular-reflection assembly in the local frame.

    `mueller_fn()` builds the planar reflection MuellerP ([N, C] planes);
    normal is the (local) reflection normal (z or microfacet normal m).
    Implements the reference's basis alignment (conductor.cpp:270-305),
    entirely in planar form (no [N, 4, 4, C] stacks materialize).
    """
    M = mueller_fn()  # MuellerP

    s_axis_in = jnp.cross(normal, -wo_hat)
    s_axis_out = jnp.cross(normal, wi_hat)
    degenerate = fr.squared_norm(s_axis_in) < 1e-12
    fallback = jnp.broadcast_to(
        jnp.asarray([1.0, 0.0, 0.0], jnp.float32), s_axis_in.shape
    )
    s_axis_in = jnp.where(degenerate[..., None], fallback, fr.normalize(s_axis_in))
    s_axis_out = jnp.where(degenerate[..., None], fallback, fr.normalize(s_axis_out))

    R_in = mu.p_rotate_stokes_basis(
        -wo_hat, s_axis_in, mu.stokes_basis(-wo_hat)
    )
    R_out = mu.p_rotate_stokes_basis(
        wi_hat, s_axis_out, mu.stokes_basis(wi_hat)
    )
    return mu.p_matmul(R_out, mu.p_matmul(M, mu.p_transpose(R_in)))


def to_world_mueller(si, M, in_forward_local, out_forward_local):
    """Rotate a local-basis planar MuellerP to world implicit bases."""
    in_fwd_w = si.to_world(in_forward_local)
    out_fwd_w = si.to_world(out_forward_local)
    in_basis_cur = si.to_world(mu.stokes_basis(in_forward_local))
    out_basis_cur = si.to_world(mu.stokes_basis(out_forward_local))
    R_in = mu.p_rotate_stokes_basis(
        in_fwd_w, in_basis_cur, mu.stokes_basis(in_fwd_w)
    )
    R_out = mu.p_rotate_stokes_basis(
        out_fwd_w, out_basis_cur, mu.stokes_basis(out_fwd_w)
    )
    return mu.p_matmul(R_out, mu.p_matmul(M, mu.p_transpose(R_in)))


# ---------------------------------------------------------------------------
# diffuse  (reference: src/bsdfs/diffuse.cpp)
# ---------------------------------------------------------------------------

class Diffuse:
    @staticmethod
    def sample(p, si, u1, u2, ctx, cfg, wavelengths):
        n = si.wi.shape[0]
        cos_i = fr.cos_theta(si.wi)
        active = cos_i > 0
        wo = warp.square_to_cosine_hemisphere(u2)
        pdf = warp.square_to_cosine_hemisphere_pdf(wo)
        bs = BSDFSample(
            wo=wo,
            pdf=pdf,
            eta=jnp.ones((n,), jnp.float32),
            sampled_type=jnp.full((n,), BSDFFlags.DiffuseReflection, jnp.uint32),
            sampled_component=jnp.zeros((n,), jnp.int32),
        )
        albedo = eval_color(p, "base_color", cfg, wavelengths)
        weight = depolarized(albedo, cfg)
        ok = jnp.logical_and(active, pdf > 0)
        return bs, where_value(ok, weight, zeros_value(n, cfg), cfg), ok

    @staticmethod
    def eval(p, si, wo, ctx, cfg, wavelengths):
        cos_i = fr.cos_theta(si.wi)
        cos_o = fr.cos_theta(wo)
        active = jnp.logical_and(cos_i > 0, cos_o > 0)
        albedo = eval_color(p, "base_color", cfg, wavelengths)
        val = albedo * (m.InvPi * jnp.maximum(cos_o, 0.0))[..., None]
        val = depolarized(val, cfg)
        return where_value(active, val, zeros_value(si.wi.shape[0], cfg), cfg)

    @staticmethod
    def pdf(p, si, wo, ctx, cfg):
        cos_i = fr.cos_theta(si.wi)
        cos_o = fr.cos_theta(wo)
        pdf = warp.square_to_cosine_hemisphere_pdf(wo)
        return jnp.where(jnp.logical_and(cos_i > 0, cos_o > 0), pdf, 0.0)


# ---------------------------------------------------------------------------
# smooth conductor  (reference: src/bsdfs/conductor.cpp)
# ---------------------------------------------------------------------------


def spectral_eta(p, cfg, wavelengths, n):
    """Per-lane conductor (eta, k) in [N, C]: spectral variants interpolate
    the embedded IOR curves (core/ior.py, the resources/data/ior role) at
    the hero wavelengths; RGB variants use the RGB triples directly."""
    if not cfg.spectral or wavelengths is None:
        if cfg.mono:
            return (
                jnp.mean(p["eta_re"], -1, keepdims=True),
                jnp.mean(p["eta_im"], -1, keepdims=True),
            )
        return (
            p["eta_re"][..., : cfg.n_channels],
            p["eta_im"][..., : cfg.n_channels],
        )
    es = p.get("eta_spec")
    if es is None:
        # no curves in this scene: flat average (dispersive data absent)
        return (
            jnp.broadcast_to(
                jnp.mean(p["eta_re"], -1, keepdims=True), (n, cfg.n_channels)
            ),
            jnp.broadcast_to(
                jnp.mean(p["eta_im"], -1, keepdims=True), (n, cfg.n_channels)
            ),
        )
    from ..core import ior as ior_mod

    return (
        ior_mod.interp_ior(es, wavelengths),
        ior_mod.interp_ior(p["k_spec"], wavelengths),
    )


class Conductor:
    @staticmethod
    def sample(p, si, u1, u2, ctx, cfg, wavelengths):
        n = si.wi.shape[0]
        cos_i = fr.cos_theta(si.wi)
        active = cos_i > 0
        wo = fr.reflect(si.wi)
        bs = BSDFSample(
            wo=wo,
            pdf=jnp.ones((n,), jnp.float32),
            eta=jnp.ones((n,), jnp.float32),
            sampled_type=jnp.full((n,), BSDFFlags.DeltaReflection, jnp.uint32),
            sampled_component=jnp.zeros((n,), jnp.int32),
        )
        refl = eval_color(p, "base_color", cfg, wavelengths)
        eta_re, eta_im = spectral_eta(p, cfg, wavelengths, n)

        if cfg.polarized:
            wo_hat = wo if ctx.mode == TransportMode.Radiance else si.wi
            wi_hat = si.wi if ctx.mode == TransportMode.Radiance else wo
            ct = fr.cos_theta(wo_hat)

            def build():
                return mu.p_specular_reflection_conductor(
                    ct[..., None], eta_re, eta_im
                )  # planar [N, C] planes

            normal = jnp.broadcast_to(
                jnp.asarray([0.0, 0.0, 1.0], jnp.float32), wo.shape
            )
            value = _spec_reflect_mueller(wo_hat, wi_hat, build, normal, cfg)
            value = mul_value(value, refl, cfg)
        else:
            F = fres.fresnel_conductor(cos_i[..., None], eta_re, eta_im)
            value = refl * F
        ok = active
        return bs, where_value(ok, value, zeros_value(n, cfg), cfg), ok

    @staticmethod
    def eval(p, si, wo, ctx, cfg, wavelengths):
        return zeros_value(si.wi.shape[0], cfg)

    @staticmethod
    def pdf(p, si, wo, ctx, cfg):
        return jnp.zeros(si.wi.shape[0], jnp.float32)


# ---------------------------------------------------------------------------
# rough conductor  (reference: src/bsdfs/roughconductor.cpp)
# ---------------------------------------------------------------------------

class RoughConductor:
    @staticmethod
    def _fresnel_value(p, si, wo, mvec, ctx, cfg, wavelengths):
        n = si.wi.shape[0]
        refl = eval_color(p, "base_color", cfg, wavelengths)
        eta_re, eta_im = spectral_eta(p, cfg, wavelengths, n)
        if cfg.polarized:
            wo_hat = wo if ctx.mode == TransportMode.Radiance else si.wi
            wi_hat = si.wi if ctx.mode == TransportMode.Radiance else wo
            ct = fr.dot(wo_hat, mvec)

            def build():
                return mu.p_specular_reflection_conductor(
                    ct[..., None], eta_re, eta_im
                )

            F = _spec_reflect_mueller(wo_hat, wi_hat, build, mvec, cfg)
            return mul_value(F, refl, cfg)
        ct = fr.dot(si.wi, mvec)
        F = fres.fresnel_conductor(ct[..., None], eta_re, eta_im)
        return refl * F

    @staticmethod
    def sample(p, si, u1, u2, ctx, cfg, wavelengths):
        n = si.wi.shape[0]
        cos_i = fr.cos_theta(si.wi)
        active = cos_i > 0
        au = p["alpha"][..., 0]
        av = p["alpha"][..., 1]
        # NDF is a per-scene static consensus (MaterialTable.mf_static;
        # the reference's default for every rough plugin is Beckmann)
        mvec, mpdf = mf.sample_vndf(
            jnp.where((cos_i < 0)[..., None], -si.wi, si.wi), u2, au, av,
            p.get("_ndf", mf.GGX),
        )
        wo = fr.reflect_n(si.wi, mvec)
        # reflection jacobian: pdf_wo = pdf_m / (4 |wo.m|)
        pdf = mpdf / jnp.maximum(4.0 * jnp.abs(fr.dot(wo, mvec)), 1e-12)
        cos_o = fr.cos_theta(wo)
        ok = active & (cos_o > 0) & (mpdf > 0)

        # VNDF sampling weight: eval/pdf = F * G2/G1
        G = mf.g_smith(si.wi, wo, mvec, au, av, p.get("_ndf", mf.GGX))
        G1 = mf.smith_g1(si.wi, mvec, au, av, p.get("_ndf", mf.GGX))
        # VNDF weight simplifies to F * G2/G1
        w_scalar = G / jnp.maximum(G1, 1e-12)
        Fv = RoughConductor._fresnel_value(p, si, wo, mvec, ctx, cfg, wavelengths)
        weight = mul_value(Fv, jnp.broadcast_to(w_scalar[..., None], (n, cfg.n_channels)), cfg)
        bs = BSDFSample(
            wo=wo,
            pdf=pdf,
            eta=jnp.ones((n,), jnp.float32),
            sampled_type=jnp.full((n,), BSDFFlags.GlossyReflection, jnp.uint32),
            sampled_component=jnp.zeros((n,), jnp.int32),
        )
        return bs, where_value(ok, weight, zeros_value(n, cfg), cfg), ok

    @staticmethod
    def eval(p, si, wo, ctx, cfg, wavelengths):
        n = si.wi.shape[0]
        cos_i = fr.cos_theta(si.wi)
        cos_o = fr.cos_theta(wo)
        active = (cos_i > 0) & (cos_o > 0)
        au = p["alpha"][..., 0]
        av = p["alpha"][..., 1]
        h = fr.normalize(si.wi + wo)
        D = mf.ndf_eval(h, au, av, p.get("_ndf", mf.GGX))
        G = mf.g_smith(si.wi, wo, h, au, av, p.get("_ndf", mf.GGX))
        scalar = D * G / jnp.maximum(4.0 * cos_i, 1e-12)
        Fv = RoughConductor._fresnel_value(p, si, wo, h, ctx, cfg, wavelengths)
        val = mul_value(Fv, jnp.broadcast_to(scalar[..., None], (n, cfg.n_channels)), cfg)
        return where_value(active & (D > 0), val, zeros_value(n, cfg), cfg)

    @staticmethod
    def pdf(p, si, wo, ctx, cfg):
        cos_i = fr.cos_theta(si.wi)
        cos_o = fr.cos_theta(wo)
        active = (cos_i > 0) & (cos_o > 0)
        au = p["alpha"][..., 0]
        av = p["alpha"][..., 1]
        h = fr.normalize(si.wi + wo)
        mpdf = mf.pdf_vndf(si.wi, h, au, av, p.get("_ndf", mf.GGX))
        pdf = mpdf / jnp.maximum(4.0 * jnp.abs(fr.dot(wo, h)), 1e-12)
        return jnp.where(active, pdf, 0.0)


# ---------------------------------------------------------------------------
# smooth dielectric  (reference: src/bsdfs/dielectric.cpp)
# ---------------------------------------------------------------------------

class Dielectric:
    @staticmethod
    def sample(p, si, u1, u2, ctx, cfg, wavelengths):
        n = si.wi.shape[0]
        eta = p["eta_re"][..., 0]  # relative IOR int/ext
        cos_i = fr.cos_theta(si.wi)
        F, cos_t, eta_it, eta_ti = fres.fresnel_dielectric(cos_i, eta)

        sel_reflect = u1 <= F
        wo_r = fr.reflect(si.wi)
        wo_t = fr.refract(si.wi, cos_t, eta_ti)
        wo = jnp.where(sel_reflect[..., None], wo_r, wo_t)
        pdf = jnp.where(sel_reflect, F, 1.0 - F)
        bs = BSDFSample(
            wo=wo,
            pdf=pdf,
            eta=jnp.where(sel_reflect, 1.0, eta_it),
            sampled_type=jnp.where(
                sel_reflect,
                jnp.uint32(BSDFFlags.DeltaReflection),
                jnp.uint32(BSDFFlags.DeltaTransmission),
            ),
            sampled_component=jnp.where(sel_reflect, 0, 1).astype(jnp.int32),
        )
        refl_c = eval_color(p, "base_color", cfg, wavelengths)
        tran_c = eval_color(p, "transmittance", cfg, wavelengths)

        if cfg.polarized:
            wo_hat = wo if ctx.mode == TransportMode.Radiance else si.wi
            wi_hat = si.wi if ctx.mode == TransportMode.Radiance else wo
            ct_hat = fr.cos_theta(wo_hat)
            MR = mu.p_specular_reflection_dielectric(
                ct_hat[..., None], eta[..., None]
            )
            MT = mu.p_specular_transmission(ct_hat[..., None], eta[..., None])
            Msel = mu.p_where(sel_reflect, MR, MT)
            # weight contract is f/pdf: divide the Mueller by the detached
            # lobe probability (reference dielectric.cpp:335-337
            # `weight = select(selected_r, R, T) / bs.pdf`) — the scalar
            # branch below cancels F analytically; without this division
            # the polarized S0 was F (resp. 1-F) times too dark
            pdf_det = jax.lax.stop_gradient(pdf)
            Msel = mu.p_scale(
                Msel, (1.0 / jnp.maximum(pdf_det, 1e-6))[..., None]
            )
            normal = jnp.broadcast_to(
                jnp.asarray([0.0, 0.0, 1.0], jnp.float32), wo.shape
            )
            value = _spec_reflect_mueller(
                wo_hat, wi_hat, lambda: Msel, normal, cfg
            )
            color = jnp.where(sel_reflect[..., None], refl_c, tran_c)
            value = mul_value(value, color, cfg)
        else:
            w = jnp.where(sel_reflect[..., None], refl_c, tran_c)
            value = w

        # radiance transport: account for solid-angle compression eta^2
        if True:
            factor = jnp.where(
                sel_reflect,
                1.0,
                jnp.where(
                    jnp.full((n,), ctx.mode == TransportMode.Radiance),
                    eta_ti * eta_ti,
                    1.0,
                ),
            )
            value = mul_value(
                value, jnp.broadcast_to(factor[..., None], (n, cfg.n_channels)), cfg
            )
        ok = jnp.ones((n,), bool)
        return bs, value, ok

    @staticmethod
    def eval(p, si, wo, ctx, cfg, wavelengths):
        return zeros_value(si.wi.shape[0], cfg)

    @staticmethod
    def pdf(p, si, wo, ctx, cfg):
        return jnp.zeros(si.wi.shape[0], jnp.float32)


# ---------------------------------------------------------------------------
# null (pass-through)
# ---------------------------------------------------------------------------

class Null:
    @staticmethod
    def sample(p, si, u1, u2, ctx, cfg, wavelengths):
        n = si.wi.shape[0]
        bs = BSDFSample(
            wo=-si.wi,
            pdf=jnp.ones((n,), jnp.float32),
            eta=jnp.ones((n,), jnp.float32),
            sampled_type=jnp.full((n,), BSDFFlags.Null, jnp.uint32),
            sampled_component=jnp.zeros((n,), jnp.int32),
        )
        one = jnp.ones((n, cfg.n_channels), jnp.float32)
        # identity mueller for pass-through (not depolarizing!)
        val = mu.MuellerP.identity() if cfg.polarized else one
        return bs, val, jnp.ones((n,), bool)

    @staticmethod
    def eval(p, si, wo, ctx, cfg, wavelengths):
        return zeros_value(si.wi.shape[0], cfg)

    @staticmethod
    def pdf(p, si, wo, ctx, cfg):
        return jnp.zeros(si.wi.shape[0], jnp.float32)


# ---------------------------------------------------------------------------
# rough dielectric  (reference: src/bsdfs/roughdielectric.cpp)
# ---------------------------------------------------------------------------

class RoughDielectric:
    @staticmethod
    def sample(p, si, u1, u2, ctx, cfg, wavelengths):
        n = si.wi.shape[0]
        eta = p["eta_re"][..., 0]
        cos_i = fr.cos_theta(si.wi)
        au = p["alpha"][..., 0]
        av = p["alpha"][..., 1]

        # microfacet normal stays in the UPPER hemisphere; the signed cosine
        # dot(wi, m) orients the Fresnel terms (reference roughdielectric.cpp)
        flip = cos_i < 0
        wi_up = jnp.where(flip[..., None], -si.wi, si.wi)
        mvec, mpdf = mf.sample_vndf(wi_up, u2, au, av,
                                    p.get("_ndf", mf.GGX))

        ct_m = fr.dot(si.wi, mvec)
        F, cos_t, eta_it, eta_ti = fres.fresnel_dielectric(ct_m, eta)
        sel_reflect = u1 <= F

        wo_r = fr.reflect_n(si.wi, mvec)
        wo_t = fr.refract_n(si.wi, mvec, cos_t, eta_ti)
        wo = jnp.where(sel_reflect[..., None], wo_r, wo_t)
        cos_o = fr.cos_theta(wo)

        # jacobians of the half-vector mappings
        dwh_dwo_r = 1.0 / jnp.maximum(4.0 * jnp.abs(fr.dot(wo_r, mvec)), 1e-12)
        denom_t = fr.dot(si.wi, mvec) + eta_it * fr.dot(wo_t, mvec)
        dwh_dwo_t = (
            eta_it * eta_it * jnp.abs(fr.dot(wo_t, mvec))
            / jnp.maximum(denom_t * denom_t, 1e-12)
        )
        pdf = mpdf * jnp.where(sel_reflect, F * dwh_dwo_r, (1 - F) * dwh_dwo_t)

        # VNDF weight: G2/G1 (+ radiance compression for transmission)
        G = mf.g_smith(si.wi, wo, mvec, au, av, p.get("_ndf", mf.GGX))
        G1 = mf.smith_g1(si.wi, mvec, au, av, p.get("_ndf", mf.GGX))
        w_scalar = G / jnp.maximum(G1, 1e-12)
        factor = jnp.where(
            sel_reflect, 1.0,
            eta_ti * eta_ti if ctx.mode == TransportMode.Radiance else 1.0,
        )
        refl_c = eval_color(p, "base_color", cfg, wavelengths)
        tran_c = eval_color(p, "transmittance", cfg, wavelengths)
        color = jnp.where(sel_reflect[..., None], refl_c, tran_c)
        value = depolarized(
            color * (w_scalar * factor)[..., None], cfg
        )

        ok = (mpdf > 0) & jnp.where(
            sel_reflect, cos_i * cos_o > 0, cos_i * cos_o < 0
        )
        bs = BSDFSample(
            wo=wo,
            pdf=pdf,
            eta=jnp.where(sel_reflect, 1.0, eta_it),
            sampled_type=jnp.where(
                sel_reflect,
                jnp.uint32(BSDFFlags.GlossyReflection),
                jnp.uint32(BSDFFlags.GlossyTransmission),
            ),
            sampled_component=jnp.where(sel_reflect, 0, 1).astype(jnp.int32),
        )
        return bs, where_value(ok, value, zeros_value(n, cfg), cfg), ok

    @staticmethod
    def eval(p, si, wo, ctx, cfg, wavelengths):
        n = si.wi.shape[0]
        eta = p["eta_re"][..., 0]
        cos_i = fr.cos_theta(si.wi)
        cos_o = fr.cos_theta(wo)
        au = p["alpha"][..., 0]
        av = p["alpha"][..., 1]
        reflect = cos_i * cos_o > 0

        eta_l = jnp.where(cos_i > 0, eta, 1.0 / eta)
        h_r = fr.normalize(si.wi + wo)
        h_t = fr.normalize(si.wi + wo * eta_l[..., None])
        h = jnp.where(reflect[..., None], h_r, h_t)
        h = h * m.sign(fr.cos_theta(h))[..., None]

        # micro/macro sidedness (reference roughdielectric.cpp): both
        # directions must lie on the same side of the microsurface as of the
        # macrosurface, else no microfacet maps wi -> wo
        side_ok = (fr.dot(si.wi, h) * cos_i > 0) & (fr.dot(wo, h) * cos_o > 0)

        F, _, eta_it, eta_ti = fres.fresnel_dielectric(fr.dot(si.wi, h), eta)
        D = mf.ndf_eval(h, au, av, p.get("_ndf", mf.GGX))
        G = mf.g_smith(si.wi, wo, h, au, av, p.get("_ndf", mf.GGX))

        val_r = F * D * G / jnp.maximum(4.0 * jnp.abs(cos_i), 1e-12)
        denom = fr.dot(si.wi, h) + eta_it * fr.dot(wo, h)
        val_t = (
            (1 - F) * D * G * eta_it * eta_it
            * jnp.abs(fr.dot(si.wi, h) * fr.dot(wo, h))
            / jnp.maximum(jnp.abs(cos_i) * denom * denom, 1e-12)
        )
        if ctx.mode == TransportMode.Radiance:
            val_t = val_t * eta_ti * eta_ti
        refl_c = eval_color(p, "base_color", cfg, wavelengths)
        tran_c = eval_color(p, "transmittance", cfg, wavelengths)
        scalar = jnp.where(reflect, val_r, val_t)
        color = jnp.where(reflect[..., None], refl_c, tran_c)
        val = depolarized(color * scalar[..., None], cfg)
        ok = (D > 0) & (jnp.abs(cos_i) > 1e-6) & side_ok
        return where_value(ok, val, zeros_value(n, cfg), cfg)

    @staticmethod
    def pdf(p, si, wo, ctx, cfg):
        eta = p["eta_re"][..., 0]
        cos_i = fr.cos_theta(si.wi)
        cos_o = fr.cos_theta(wo)
        au = p["alpha"][..., 0]
        av = p["alpha"][..., 1]
        reflect = cos_i * cos_o > 0
        eta_l = jnp.where(cos_i > 0, eta, 1.0 / eta)
        h_r = fr.normalize(si.wi + wo)
        h_t = fr.normalize(si.wi + wo * eta_l[..., None])
        h = jnp.where(reflect[..., None], h_r, h_t)
        h = h * m.sign(fr.cos_theta(h))[..., None]

        side_ok = (fr.dot(si.wi, h) * cos_i > 0) & (fr.dot(wo, h) * cos_o > 0)

        F, _, eta_it, _ = fres.fresnel_dielectric(fr.dot(si.wi, h), eta)
        flip = cos_i < 0
        wi_up = jnp.where(flip[..., None], -si.wi, si.wi)
        mpdf = mf.pdf_vndf(wi_up, h, au, av, p.get("_ndf", mf.GGX))
        dwh_r = 1.0 / jnp.maximum(4.0 * jnp.abs(fr.dot(wo, h)), 1e-12)
        denom = fr.dot(si.wi, h) + eta_it * fr.dot(wo, h)
        dwh_t = (
            eta_it * eta_it * jnp.abs(fr.dot(wo, h))
            / jnp.maximum(denom * denom, 1e-12)
        )
        pdf = mpdf * jnp.where(reflect, F * dwh_r, (1 - F) * dwh_t)
        return jnp.where(side_ok, pdf, 0.0)


# ---------------------------------------------------------------------------
# thin dielectric  (reference: src/bsdfs/thindielectric.cpp)
# ---------------------------------------------------------------------------

class ThinDielectric:
    @staticmethod
    def sample(p, si, u1, u2, ctx, cfg, wavelengths):
        n = si.wi.shape[0]
        eta = p["eta_re"][..., 0]
        cos_i = fr.cos_theta(si.wi)
        F, _, _, _ = fres.fresnel_dielectric(jnp.abs(cos_i), eta)
        # account for internal bounces: R' = R + TRT + ... = 2R/(1+R)
        R = jnp.clip(2.0 * F / (1.0 + jnp.maximum(F, 1e-9)), 0.0, 1.0)
        sel_reflect = u1 <= R
        wo = jnp.where(sel_reflect[..., None], fr.reflect(si.wi), -si.wi)
        refl_c = eval_color(p, "base_color", cfg, wavelengths)
        tran_c = eval_color(p, "transmittance", cfg, wavelengths)
        value = depolarized(
            jnp.where(sel_reflect[..., None], refl_c, tran_c), cfg
        )
        bs = BSDFSample(
            wo=wo,
            pdf=jnp.where(sel_reflect, R, 1.0 - R),
            eta=jnp.ones((n,), jnp.float32),
            sampled_type=jnp.where(
                sel_reflect,
                jnp.uint32(BSDFFlags.DeltaReflection),
                jnp.uint32(BSDFFlags.Null),
            ),
            sampled_component=jnp.where(sel_reflect, 0, 1).astype(jnp.int32),
        )
        return bs, value, jnp.ones((n,), bool)

    @staticmethod
    def eval(p, si, wo, ctx, cfg, wavelengths):
        return zeros_value(si.wi.shape[0], cfg)

    @staticmethod
    def pdf(p, si, wo, ctx, cfg):
        return jnp.zeros(si.wi.shape[0], jnp.float32)


# ---------------------------------------------------------------------------
# plastic (smooth)  (reference: src/bsdfs/plastic.cpp)
# ---------------------------------------------------------------------------

class Plastic:
    @staticmethod
    def _weights(p, cos_i):
        eta = p["eta_re"][..., 0]
        F_i, _, _, _ = fres.fresnel_dielectric(cos_i, eta)
        # internal diffuse reflectance for the nonlinear interreflection term
        fdr_int = fres.fresnel_diffuse_reflectance(1.0 / eta)
        return eta, F_i, fdr_int

    @staticmethod
    def sample(p, si, u1, u2, ctx, cfg, wavelengths):
        n = si.wi.shape[0]
        cos_i = fr.cos_theta(si.wi)
        active = cos_i > 0
        eta, F_i, fdr_int = Plastic._weights(p, cos_i)
        spec_w = F_i
        prob_spec = spec_w  # sampling weight split per reference defaults
        sel_spec = u1 < prob_spec

        wo_spec = fr.reflect(si.wi)
        wo_diff = warp.square_to_cosine_hemisphere(u2)
        wo = jnp.where(sel_spec[..., None], wo_spec, wo_diff)
        cos_o = fr.cos_theta(wo)
        F_o, _, _, _ = fres.fresnel_dielectric(cos_o, eta)

        diff = eval_color(p, "base_color", cfg, wavelengths)
        inv_eta2 = 1.0 / (eta * eta)
        diff_val = (
            diff / jnp.maximum(1.0 - diff * fdr_int[..., None], 1e-6)
            * (inv_eta2 * (1.0 - F_i) * (1.0 - F_o))[..., None]
        )
        pdf_diff = warp.square_to_cosine_hemisphere_pdf(wo) * (1.0 - prob_spec)
        # specular lane: weight = F / prob = 1 (color via spec reflectance=1)
        w_spec = jnp.ones((n, cfg.n_channels), jnp.float32)
        # diffuse lane: f*cos/pdf = diff_val / (1 - prob_spec)
        w_diff = diff_val / jnp.maximum((1.0 - prob_spec)[..., None], 1e-6)
        value = jnp.where(sel_spec[..., None], w_spec, w_diff)
        value = depolarized(value, cfg)

        bs = BSDFSample(
            wo=wo,
            pdf=jnp.where(sel_spec, prob_spec, pdf_diff),
            eta=jnp.ones((n,), jnp.float32),
            sampled_type=jnp.where(
                sel_spec,
                jnp.uint32(BSDFFlags.DeltaReflection),
                jnp.uint32(BSDFFlags.DiffuseReflection),
            ),
            sampled_component=jnp.where(sel_spec, 0, 1).astype(jnp.int32),
        )
        ok = active & (cos_o > 0)
        return bs, where_value(ok, value, zeros_value(n, cfg), cfg), ok

    @staticmethod
    def eval(p, si, wo, ctx, cfg, wavelengths):
        n = si.wi.shape[0]
        cos_i = fr.cos_theta(si.wi)
        cos_o = fr.cos_theta(wo)
        active = (cos_i > 0) & (cos_o > 0)
        eta, F_i, fdr_int = Plastic._weights(p, cos_i)
        F_o, _, _, _ = fres.fresnel_dielectric(cos_o, eta)
        diff = eval_color(p, "base_color", cfg, wavelengths)
        inv_eta2 = 1.0 / (eta * eta)
        val = (
            diff / jnp.maximum(1.0 - diff * fdr_int[..., None], 1e-6)
            * (m.InvPi * cos_o * inv_eta2 * (1.0 - F_i) * (1.0 - F_o))[..., None]
        )
        return where_value(active, depolarized(val, cfg),
                           zeros_value(n, cfg), cfg)

    @staticmethod
    def pdf(p, si, wo, ctx, cfg):
        cos_i = fr.cos_theta(si.wi)
        cos_o = fr.cos_theta(wo)
        eta = p["eta_re"][..., 0]
        F_i, _, _, _ = fres.fresnel_dielectric(cos_i, eta)
        pdf = warp.square_to_cosine_hemisphere_pdf(wo) * (1.0 - F_i)
        return jnp.where((cos_i > 0) & (cos_o > 0), pdf, 0.0)


# ---------------------------------------------------------------------------
# rough plastic  (reference: src/bsdfs/roughplastic.cpp) — GGX coat + diffuse
# ---------------------------------------------------------------------------

class RoughPlastic:
    @staticmethod
    def sample(p, si, u1, u2, ctx, cfg, wavelengths):
        n = si.wi.shape[0]
        cos_i = fr.cos_theta(si.wi)
        active = cos_i > 0
        eta = p["eta_re"][..., 0]
        au = p["alpha"][..., 0]
        av = p["alpha"][..., 1]
        F_i, _, _, _ = fres.fresnel_dielectric(cos_i, eta)
        prob_spec = F_i

        sel_spec = u1 < prob_spec
        mvec, mpdf = mf.sample_vndf(
            jnp.where((cos_i < 0)[..., None], -si.wi, si.wi), u2, au, av,
            p.get("_ndf", mf.GGX),
        )
        wo_spec = fr.reflect_n(si.wi, mvec)
        wo_diff = warp.square_to_cosine_hemisphere(u2)
        wo = jnp.where(sel_spec[..., None], wo_spec, wo_diff)
        cos_o = fr.cos_theta(wo)
        ok = active & (cos_o > 0)

        val = RoughPlastic.eval(p, si, wo, ctx, cfg, wavelengths)
        pdf = RoughPlastic.pdf(p, si, wo, ctx, cfg)
        weight = mul_value(
            val,
            jnp.broadcast_to(
                jnp.where(pdf > 0, 1.0 / jnp.maximum(pdf, 1e-20), 0.0)[..., None],
                (n, cfg.n_channels),
            ),
            cfg,
        )
        bs = BSDFSample(
            wo=wo,
            pdf=pdf,
            eta=jnp.ones((n,), jnp.float32),
            sampled_type=jnp.where(
                sel_spec,
                jnp.uint32(BSDFFlags.GlossyReflection),
                jnp.uint32(BSDFFlags.DiffuseReflection),
            ),
            sampled_component=jnp.where(sel_spec, 0, 1).astype(jnp.int32),
        )
        ok = ok & (pdf > 0)
        return bs, where_value(ok, weight, zeros_value(n, cfg), cfg), ok

    @staticmethod
    def eval(p, si, wo, ctx, cfg, wavelengths):
        n = si.wi.shape[0]
        cos_i = fr.cos_theta(si.wi)
        cos_o = fr.cos_theta(wo)
        active = (cos_i > 0) & (cos_o > 0)
        eta = p["eta_re"][..., 0]
        au = p["alpha"][..., 0]
        av = p["alpha"][..., 1]
        h = fr.normalize(si.wi + wo)
        F, _, _, _ = fres.fresnel_dielectric(fr.dot(si.wi, h), eta)
        D = mf.ndf_eval(h, au, av, p.get("_ndf", mf.GGX))
        G = mf.g_smith(si.wi, wo, h, au, av, p.get("_ndf", mf.GGX))
        spec = F * D * G / jnp.maximum(4.0 * cos_i, 1e-12)

        F_i, _, _, _ = fres.fresnel_dielectric(cos_i, eta)
        F_o, _, _, _ = fres.fresnel_dielectric(cos_o, eta)
        fdr_int = fres.fresnel_diffuse_reflectance(1.0 / eta)
        diff = eval_color(p, "base_color", cfg, wavelengths)
        inv_eta2 = 1.0 / (eta * eta)
        diff_val = (
            diff / jnp.maximum(1.0 - diff * fdr_int[..., None], 1e-6)
            * (m.InvPi * cos_o * inv_eta2 * (1.0 - F_i) * (1.0 - F_o))[..., None]
        )
        val = depolarized(spec[..., None] * jnp.ones((n, cfg.n_channels)) + diff_val, cfg)
        return where_value(active, val, zeros_value(n, cfg), cfg)

    @staticmethod
    def pdf(p, si, wo, ctx, cfg):
        cos_i = fr.cos_theta(si.wi)
        cos_o = fr.cos_theta(wo)
        active = (cos_i > 0) & (cos_o > 0)
        eta = p["eta_re"][..., 0]
        au = p["alpha"][..., 0]
        av = p["alpha"][..., 1]
        F_i, _, _, _ = fres.fresnel_dielectric(cos_i, eta)
        h = fr.normalize(si.wi + wo)
        mpdf = mf.pdf_vndf(si.wi, h, au, av, p.get("_ndf", mf.GGX))
        pdf_spec = mpdf / jnp.maximum(4.0 * jnp.abs(fr.dot(wo, h)), 1e-12)
        pdf_diff = warp.square_to_cosine_hemisphere_pdf(wo)
        pdf = F_i * pdf_spec + (1.0 - F_i) * pdf_diff
        return jnp.where(active, pdf, 0.0)


# ---------------------------------------------------------------------------
# principled (opaque Disney subset) — reference src/bsdfs/principled.cpp:
# metallic/roughness/specular/spec_tint/sheen/clearcoat/anisotropic; the
# transmissive branch (spec_trans > 0) is not implemented (every bundled
# scene uses spec_trans = 0).
# ---------------------------------------------------------------------------

def _schlick(F0, cos_t):
    m5 = jnp.power(jnp.clip(1.0 - cos_t, 0.0, 1.0), 5.0)
    return F0 + (1.0 - F0) * m5[..., None]


def _gtr1(cos_h, alpha):
    a2 = alpha * alpha
    denom = m.Pi * jnp.log(jnp.maximum(a2, 1e-8)) * (
        1.0 + (a2 - 1.0) * cos_h * cos_h
    )
    return jnp.where(
        alpha < 1.0, (a2 - 1.0) / jnp.where(jnp.abs(denom) > 1e-8, denom, 1e-8),
        m.InvPi,
    )


class Principled:
    """Opaque principled material (principled.cpp:36-1000, spec_trans=0)."""

    @staticmethod
    def _alphas(p):
        rough = p["alpha"][..., 0]
        aniso = p["pr_params"][..., 7]
        aspect = jnp.sqrt(1.0 - 0.9 * jnp.clip(aniso, 0.0, 1.0))
        a = jnp.maximum(rough * rough, 1e-4)
        return a / aspect, a * aspect

    @staticmethod
    def _lobes(p, si, wo, cfg, wavelengths):
        """Shared eval pieces: (f_total*cos_o [N,C], active)."""
        n = si.wi.shape[0]
        cos_i = fr.cos_theta(si.wi)
        cos_o = fr.cos_theta(wo)
        active = (cos_i > 0) & (cos_o > 0)
        base = eval_color(p, "base_color", cfg, wavelengths)  # [N, C]
        pr = p["pr_params"]
        metallic = jnp.clip(pr[..., 0], 0.0, 1.0)
        specular = pr[..., 1]
        spec_tint = jnp.clip(pr[..., 2], 0.0, 1.0)
        sheen = pr[..., 3]
        sheen_tint = jnp.clip(pr[..., 4], 0.0, 1.0)
        clearcoat = pr[..., 5]
        cc_gloss = jnp.clip(pr[..., 6], 0.0, 1.0)

        h = fr.normalize(si.wi + wo)
        cos_hwo = jnp.abs(fr.dot(wo, h))
        au, av = Principled._alphas(p)
        D = mf.ndf_eval(h, au, av, mf.GGX)
        G = mf.g_smith(si.wi, wo, h, au, av, mf.GGX)

        lum = jnp.mean(base, axis=-1, keepdims=True)
        hue = base / jnp.maximum(lum, 1e-6)
        F0_diel = 0.08 * specular[..., None] * (
            1.0 + spec_tint[..., None] * (hue - 1.0)
        )
        m5 = jnp.power(jnp.clip(1.0 - cos_hwo, 0.0, 1.0), 5.0)[..., None]
        F_diel = F0_diel + (1.0 - F0_diel) * m5
        F_metal = base + (1.0 - base) * m5
        F = F_diel + metallic[..., None] * (F_metal - F_diel)
        spec = F * (D * G / jnp.maximum(4.0 * cos_i, 1e-9))[..., None]

        # Disney retro-diffuse
        fd90 = 0.5 + 2.0 * p["alpha"][..., 0] * cos_hwo * cos_hwo
        def fd(cos_x):
            return 1.0 + (fd90 - 1.0) * jnp.power(
                jnp.clip(1.0 - cos_x, 0.0, 1.0), 5.0
            )
        diff = (
            base * (1.0 / m.Pi)
            * (fd(cos_i) * fd(cos_o) * cos_o * (1.0 - metallic))[..., None]
        )

        # sheen at grazing half angles
        c_sheen = 1.0 + sheen_tint[..., None] * (hue - 1.0)
        sh = (
            c_sheen
            * (sheen * jnp.power(jnp.clip(1.0 - cos_hwo, 0.0, 1.0), 5.0)
               * cos_o * (1.0 - metallic))[..., None]
        )

        # clearcoat (GTR1, fixed 0.25 smith alpha, F = 0.04 schlick)
        a_cc = 0.1 + (0.001 - 0.1) * cc_gloss
        Dc = _gtr1(jnp.abs(fr.cos_theta(h)), a_cc)
        Gc = mf.g_smith(si.wi, wo, h, jnp.full_like(a_cc, 0.25),
                        jnp.full_like(a_cc, 0.25), mf.GGX)
        Fc = 0.04 + 0.96 * jnp.power(jnp.clip(1.0 - cos_hwo, 0.0, 1.0), 5.0)
        cc = (
            0.25 * clearcoat * Dc * Fc * Gc / jnp.maximum(4.0 * cos_i, 1e-9)
        )[..., None]

        f = spec + diff + sh + cc
        return jnp.where(active[..., None], f, 0.0), active

    @staticmethod
    def _lobe_weights(p):
        metallic = jnp.clip(p["pr_params"][..., 0], 0.0, 1.0)
        w_spec = 1.0 / (2.0 - metallic)
        return w_spec, 1.0 - w_spec

    @staticmethod
    def eval(p, si, wo, ctx, cfg, wavelengths):
        f, active = Principled._lobes(p, si, wo, cfg, wavelengths)
        return depolarized(f, cfg)

    @staticmethod
    def pdf(p, si, wo, ctx, cfg):
        cos_i = fr.cos_theta(si.wi)
        cos_o = fr.cos_theta(wo)
        active = (cos_i > 0) & (cos_o > 0)
        au, av = Principled._alphas(p)
        h = fr.normalize(si.wi + wo)
        mpdf = mf.pdf_vndf(si.wi, h, au, av, mf.GGX)
        pdf_spec = mpdf / jnp.maximum(4.0 * jnp.abs(fr.dot(wo, h)), 1e-12)
        pdf_diff = jnp.maximum(cos_o, 0.0) * (1.0 / m.Pi)
        w_spec, w_diff = Principled._lobe_weights(p)
        return jnp.where(active, w_spec * pdf_spec + w_diff * pdf_diff, 0.0)

    @staticmethod
    def sample(p, si, u1, u2, ctx, cfg, wavelengths):
        n = si.wi.shape[0]
        cos_i = fr.cos_theta(si.wi)
        active = cos_i > 0
        au, av = Principled._alphas(p)
        w_spec, w_diff = Principled._lobe_weights(p)
        pick_spec = u1 < w_spec

        wi_up = jnp.where((cos_i < 0)[..., None], -si.wi, si.wi)
        mvec, _ = mf.sample_vndf_ggx(wi_up, u2, au, av)
        wo_s = fr.reflect_n(si.wi, mvec)
        from ..core import warp

        wo_d = warp.square_to_cosine_hemisphere(u2)
        wo = jnp.where(pick_spec[..., None], wo_s, wo_d)

        pdf = Principled.pdf(p, si, wo, ctx, cfg)
        f, act2 = Principled._lobes(p, si, wo, cfg, wavelengths)
        ok = active & act2 & (pdf > 1e-9)
        weight = jnp.where(
            ok[..., None], f / jnp.maximum(pdf, 1e-9)[..., None], 0.0
        )
        bs = BSDFSample(
            wo=wo,
            pdf=pdf,
            eta=jnp.ones((n,), jnp.float32),
            sampled_type=jnp.where(
                pick_spec, jnp.uint32(BSDFFlags.GlossyReflection),
                jnp.uint32(BSDFFlags.DiffuseReflection),
            ),
            sampled_component=jnp.where(pick_spec, 0, 1),
        )
        return bs, depolarized(weight, cfg), ok


# ---------------------------------------------------------------------------
# measured (RGL data-driven BRDF) — reference src/bsdfs/measured.cpp.
# Tables ride on MaterialTable.meas (a MeasuredTables pytree, stashed into
# the gathered dict as p["_meas"]); p["meas_idx"] selects the material.
# ---------------------------------------------------------------------------

class Measured:
    @staticmethod
    def _folded_wi(meas, k, wi):
        """Symmetry reduction sign-folding (measured.cpp:411-419)."""
        red = meas.reduction[k]
        sy = wi[..., 1]
        sx = jnp.where(red == 4, wi[..., 0], sy)
        flip_x = jnp.where((red >= 2) & (sx < 0), -1.0, 1.0)
        flip_y = jnp.where((red >= 2) & (sy < 0), -1.0, 1.0)
        flip = jnp.stack([flip_x, flip_y, jnp.ones_like(flip_x)], axis=-1)
        return wi * flip, flip

    @staticmethod
    def _common(p, si, wo):
        from . import measured as meas_mod

        meas = p["_meas"]
        k = jnp.maximum(p["meas_idx"].astype(jnp.int32), 0)
        wi, flip = Measured._folded_wi(meas, k, si.wi)
        wo_f = wo * flip
        cos_i = fr.cos_theta(wi)
        cos_o = fr.cos_theta(wo_f)
        active = (cos_i > 0) & (cos_o > 0)
        h = fr.normalize(wi + wo_f)
        theta_i = meas_mod._elevation(wi)
        phi_i = jnp.arctan2(wi[..., 1], wi[..., 0])
        theta_m = meas_mod._elevation(h)
        phi_m = jnp.arctan2(h[..., 1], h[..., 0])
        iso = meas.isotropic[k]
        u_x = meas_mod._theta2u(theta_m)
        u_y = meas_mod._phi2u(jnp.where(iso, phi_m - phi_i, phi_m))
        u_y = u_y - jnp.floor(u_y)
        return meas, k, wi, wo_f, h, theta_i, phi_i, u_x, u_y, active

    @staticmethod
    def _mixture_pdf_and_sample_pos(meas, sl, w, u_x, u_y):
        """Per-slice vndf inversion at u_m: returns mixture pdf over the
        unit square (vndf density x luminance density at the inverted
        position) and the mixture-averaged sample position (x_s, y_s)."""
        from . import measured as meas_mod

        pdf_acc = 0.0
        xs_acc = 0.0
        ys_acc = 0.0
        for s in range(4):
            sls = sl[..., s]
            a, b, pdf_v = meas_mod.warp_invert(
                sls, u_x, u_y, meas.vndf_d, meas.vndf_row, meas.vndf_marg,
                meas.vndf_cond,
            )
            # vndf input drivers (a, b) = lum output position (y_s, x_s)
            x_s, y_s = b, a
            pdf_l = meas_mod.grid_eval(sls, x_s, y_s, meas.lum_d)
            pdf_acc = pdf_acc + w[..., s] * pdf_v * pdf_l
            xs_acc = xs_acc + w[..., s] * x_s
            ys_acc = ys_acc + w[..., s] * y_s
        return pdf_acc, xs_acc, ys_acc

    @staticmethod
    def _jacobian(wi, h, u_x):
        theta_m = jnp.arccos(jnp.clip(fr.cos_theta(h), -1.0, 1.0))
        return jnp.maximum(
            2.0 * (jnp.pi ** 2) * u_x * jnp.sin(theta_m), 1e-6
        ) * 4.0 * jnp.maximum(fr.dot(wi, h), 1e-9)

    @staticmethod
    def eval(p, si, wo, ctx, cfg, wavelengths):
        from . import measured as meas_mod

        meas, k, wi, wo_f, h, theta_i, phi_i, u_x, u_y, active = \
            Measured._common(p, si, wo)
        sl, w = meas_mod._slice_weights(meas, k, theta_i, phi_i)
        _, x_s, y_s = Measured._mixture_pdf_and_sample_pos(
            meas, sl, w, u_x, u_y
        )
        spec = meas_mod._spectra_eval(meas, sl, w, x_s, y_s, wavelengths, cfg)
        # jacobian term: ndf(u_m) / (4 sigma(u_wi)) (measured.cpp:352-355)
        u_wi_x = meas_mod._theta2u(theta_i)
        u_wi_y = meas_mod._phi2u(phi_i)
        ndf_v = meas_mod.grid_eval(k, u_x, u_y, meas.ndf)
        sigma_v = meas_mod.grid_eval(k, u_wi_x, u_wi_y, meas.sigma)
        jfac = jnp.where(
            meas.jacobian[k], ndf_v / jnp.maximum(4.0 * sigma_v, 1e-12), 1.0
        )
        out = spec * jfac[..., None]
        out = jnp.where(active[..., None], out, 0.0)
        return depolarized(out, cfg)

    @staticmethod
    def pdf(p, si, wo, ctx, cfg):
        from . import measured as meas_mod

        meas, k, wi, wo_f, h, theta_i, phi_i, u_x, u_y, active = \
            Measured._common(p, si, wo)
        sl, w = meas_mod._slice_weights(meas, k, theta_i, phi_i)
        pdf_sq, _, _ = Measured._mixture_pdf_and_sample_pos(
            meas, sl, w, u_x, u_y
        )
        pdf = pdf_sq / Measured._jacobian(wi, h, u_x)
        return jnp.where(active, pdf, 0.0)

    @staticmethod
    def sample(p, si, u1, u2, ctx, cfg, wavelengths):
        from . import measured as meas_mod

        meas = p["_meas"]
        n = si.wi.shape[0]
        k = jnp.maximum(p["meas_idx"].astype(jnp.int32), 0)
        wi, flip = Measured._folded_wi(meas, k, si.wi)
        cos_i = fr.cos_theta(wi)
        active = cos_i > 0
        theta_i = meas_mod._elevation(wi)
        phi_i = jnp.arctan2(wi[..., 1], wi[..., 0])
        sl, w = meas_mod._slice_weights(meas, k, theta_i, phi_i)

        # stochastic slice pick by bilinear weight (uses u1, which the
        # reference discards) — realized density = sum_s w_s p_s
        c1 = w[..., 0]
        c2 = c1 + w[..., 1]
        c3 = c2 + w[..., 2]
        s_pick = (
            (u1 >= c1).astype(jnp.int32) + (u1 >= c2).astype(jnp.int32)
            + (u1 >= c3).astype(jnp.int32)
        )
        sl_pick = jnp.take_along_axis(sl, s_pick[..., None], -1)[..., 0]

        # luminance warp then vndf warp (measured.cpp:270-276)
        x_s, y_s, _ = meas_mod.warp_sample(
            sl_pick, u2[..., 1], u2[..., 0], meas.lum_d, meas.lum_row,
            meas.lum_marg, meas.lum_cond,
        )
        u_x, u_y, _ = meas_mod.warp_sample(
            sl_pick, y_s, x_s, meas.vndf_d, meas.vndf_row, meas.vndf_marg,
            meas.vndf_cond,
        )
        theta_m = meas_mod._u2theta(u_x)
        phi_m = meas_mod._u2phi(u_y)
        iso = meas.isotropic[k]
        phi_m = jnp.where(iso, phi_m + phi_i, phi_m)
        st, ct = jnp.sin(theta_m), jnp.cos(theta_m)
        h = jnp.stack(
            [jnp.cos(phi_m) * st, jnp.sin(phi_m) * st, ct], axis=-1
        )
        wo_f = fr.reflect_n(wi, h)
        wo = wo_f * flip

        pdf = Measured.pdf(p, si, wo, ctx, cfg)
        f = Measured.eval(p, si, wo, ctx, cfg, wavelengths)
        ok = active & (fr.cos_theta(wo_f) > 0) & (pdf > 1e-12)
        weight = where_value(
            ok,
            mul_value(
                f,
                jnp.broadcast_to(
                    (1.0 / jnp.maximum(pdf, 1e-12))[..., None],
                    (n, cfg.n_channels),
                ),
                cfg,
            ),
            zeros_value(n, cfg),
            cfg,
        )
        bs = BSDFSample(
            wo=wo,
            pdf=pdf,
            eta=jnp.ones((n,), jnp.float32),
            sampled_type=jnp.full((n,), jnp.uint32(BSDFFlags.GlossyReflection)),
            sampled_component=jnp.zeros((n,), jnp.int32),
        )
        return bs, weight, ok


# ---------------------------------------------------------------------------
# principledthin — reference src/bsdfs/principledthin.cpp: symmetric thin
# sheet with 4 lobes (GGX specular reflection, thin specular transmission
# with Burley's IOR-scaled roughness, Disney diffuse/retro/fake-subsurface/
# sheen reflection, Lambertian diffuse transmission).
#
# pr_params layout for THIS type: [spec_trans, diff_trans (stored already
# halved to 0..1), spec_tint, sheen, sheen_tint, flatness, unused,
# anisotropic]; alpha[:,0] = roughness, eta_re[:,0] = eta.
# ---------------------------------------------------------------------------

def _schlick_weight(cos_t):
    return jnp.power(jnp.clip(1.0 - cos_t, 0.0, 1.0), 5.0)


class PrincipledThin:
    @staticmethod
    def _alphas(p, scaled: bool):
        rough = p["alpha"][..., 0]
        if scaled:
            # Burley 2015 Fig. 15: thin transmission roughness scales with IOR
            rough = jnp.clip((0.65 * p["eta_re"][..., 0] - 0.35), 0.0, None) * rough
        aniso = jnp.clip(p["pr_params"][..., 7], 0.0, 1.0)
        aspect = jnp.sqrt(1.0 - 0.9 * aniso)
        a = jnp.maximum(rough * rough, 1e-4)
        return a / aspect, a * aspect

    @staticmethod
    def _fold(si, wo):
        """Thin BSDF is symmetric: fold wi/wo to the front side
        (principledthin.cpp eval: mulsign by cos_theta_i)."""
        cos_raw = fr.cos_theta(si.wi)
        sgn = jnp.where(cos_raw < 0.0, -1.0, 1.0)
        wi = si.wi * sgn[..., None]
        wo_t = wo * sgn[..., None]
        return wi, wo_t, jnp.abs(cos_raw), sgn

    @staticmethod
    def _probs(p):
        """Normalized lobe-pick probabilities (srates = 1, the reference
        defaults): [spec_reflect, spec_trans, diff_reflect, diff_trans]."""
        pr = p["pr_params"]
        st = jnp.clip(pr[..., 0], 0.0, 1.0)
        dt = jnp.clip(pr[..., 1], 0.0, 1.0)
        w = jnp.stack(
            [0.5 * st, 0.5 * st, (1.0 - st) * (1.0 - dt), (1.0 - st) * dt],
            axis=-1,
        )
        return w / jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-12)

    @staticmethod
    def _lobes(p, si, wo, cfg, wavelengths):
        wi, wo_t, cos_i, _ = PrincipledThin._fold(si, wo)
        cos_o = fr.cos_theta(wo_t)
        active = cos_i > 1e-9
        reflect = cos_o > 0.0
        refract = cos_o < 0.0

        pr = p["pr_params"]
        spec_trans = jnp.clip(pr[..., 0], 0.0, 1.0)
        diff_trans = jnp.clip(pr[..., 1], 0.0, 1.0)
        spec_tint = jnp.clip(pr[..., 2], 0.0, 1.0)
        sheen = pr[..., 3]
        sheen_tint = jnp.clip(pr[..., 4], 0.0, 1.0)
        flatness = jnp.clip(pr[..., 5], 0.0, 1.0)
        rough = p["alpha"][..., 0]
        eta_t = p["eta_re"][..., 0]
        base = eval_color(p, "base_color", cfg, wavelengths)  # [N, C]

        # halfway vector of the REFLECTED image of wo (abs z)
        wo_r = jnp.concatenate(
            [wo_t[..., :2], jnp.abs(wo_t[..., 2:3])], axis=-1
        )
        wh = fr.normalize(wi + wo_r)
        # macro-micro compatibility (principledhelpers.h:199-211; wi is
        # front-side so mulsign(m, cos_i) = m)
        compat_r = (fr.dot(wi, wh) > 0) & (fr.dot(wo_t, wh) > 0)
        compat_t = (fr.dot(wi, wh) > 0) & (fr.dot(wo_t, -wh) > 0)

        F_diel, _, _, _ = fres.fresnel_dielectric(fr.dot(wi, wh), eta_t)

        value = jnp.zeros_like(base)

        # --- specular reflection: spec_trans * F_thin * D G / (4 cos_i)
        au, av = PrincipledThin._alphas(p, scaled=False)
        D = mf.ndf_eval(wh, au, av, mf.GGX)
        G = mf.g_smith(wi, wo_t, wh, au, av, mf.GGX)
        lum = jnp.mean(base, axis=-1, keepdims=True)
        c_tint = jnp.where(lum > 0, base / jnp.maximum(lum, 1e-9), 1.0)
        R0 = ((eta_t - 1.0) / (eta_t + 1.0)) ** 2
        F0_tint = c_tint * R0[..., None]
        F_schlick = F0_tint + (1.0 - F0_tint) * _schlick_weight(
            fr.dot(wi, wh)
        )[..., None]
        F_thin = (
            F_diel[..., None] * (1.0 - spec_tint[..., None])
            + F_schlick * spec_tint[..., None]
        )
        m_sr = active & reflect & (spec_trans > 0) & compat_r
        value = value + jnp.where(
            m_sr[..., None],
            spec_trans[..., None] * F_thin
            * (D * G / jnp.maximum(4.0 * cos_i, 1e-9))[..., None],
            0.0,
        )

        # --- specular transmission: spec_trans * base * (1-F) D' G' /(4 cos_i)
        aus, avs = PrincipledThin._alphas(p, scaled=True)
        Ds = mf.ndf_eval(wh, aus, avs, mf.GGX)
        Gs = mf.g_smith(wi, wo_t, wh, aus, avs, mf.GGX)
        m_st = active & refract & (spec_trans > 0) & compat_t
        value = value + jnp.where(
            m_st[..., None],
            spec_trans[..., None] * base * (1.0 - F_diel)[..., None]
            * (Ds * Gs / jnp.maximum(4.0 * cos_i, 1e-9))[..., None],
            0.0,
        )

        # --- diffuse reflection: diff + retro (+ fake subsurface) + sheen
        Fo = _schlick_weight(jnp.abs(cos_o))
        Fi = _schlick_weight(cos_i)
        f_diff = (1.0 - 0.5 * Fi) * (1.0 - 0.5 * Fo)
        cos_d = fr.dot(wh, wo_t)
        Rr = 2.0 * rough * cos_d * cos_d
        f_retro = Rr * (Fo + Fi + Fo * Fi * (Rr - 1.0))
        Fss90 = 0.5 * Rr
        Fss = (1.0 + (Fss90 - 1.0) * Fo) * (1.0 + (Fss90 - 1.0) * Fi)
        f_ss = 1.25 * (
            Fss * (1.0 / jnp.maximum(jnp.abs(cos_o) + cos_i, 1e-6) - 0.5)
            + 0.5
        )
        diff_term = (1.0 - flatness) * (f_diff + f_retro) + flatness * f_ss
        m_dr = active & reflect & (spec_trans < 1.0) & (diff_trans < 1.0)
        value = value + jnp.where(
            m_dr[..., None],
            ((1.0 - spec_trans) * (1.0 - diff_trans) * cos_o * m.InvPi
             * diff_term)[..., None] * base,
            0.0,
        )
        # sheen (reflect side, scaled by (1-spec_trans)(1-diff_trans))
        Fd = _schlick_weight(jnp.abs(cos_d))
        c_sheen = 1.0 + sheen_tint[..., None] * (c_tint - 1.0)
        value = value + jnp.where(
            (m_dr & (sheen > 0))[..., None],
            (sheen * (1.0 - spec_trans) * (1.0 - diff_trans) * Fd
             * jnp.abs(cos_o))[..., None] * c_sheen,
            0.0,
        )

        # --- diffuse transmission (Lambertian through the sheet)
        m_dt = active & refract & (spec_trans < 1.0) & (diff_trans > 0)
        value = value + jnp.where(
            m_dt[..., None],
            ((1.0 - spec_trans) * diff_trans * m.InvPi
             * jnp.abs(cos_o))[..., None] * base,
            0.0,
        )
        return jnp.where(active[..., None], value, 0.0), active

    @staticmethod
    def eval(p, si, wo, ctx, cfg, wavelengths):
        f, _ = PrincipledThin._lobes(p, si, wo, cfg, wavelengths)
        return depolarized(f, cfg)

    @staticmethod
    def pdf(p, si, wo, ctx, cfg):
        wi, wo_t, cos_i, _ = PrincipledThin._fold(si, wo)
        cos_o = fr.cos_theta(wo_t)
        active = cos_i > 1e-9
        reflect = cos_o > 0.0
        refract = cos_o < 0.0
        w = PrincipledThin._probs(p)

        wo_r = jnp.concatenate(
            [wo_t[..., :2], jnp.abs(wo_t[..., 2:3])], axis=-1
        )
        wh = fr.normalize(wi + wo_r)
        compat_r = (fr.dot(wi, wh) > 0) & (fr.dot(wo_t, wh) > 0)
        compat_t = (fr.dot(wi, wh) > 0) & (fr.dot(wo_t, -wh) > 0)
        dwh_dwo = 1.0 / jnp.maximum(4.0 * jnp.abs(fr.dot(wo_r, wh)), 1e-9)

        au, av = PrincipledThin._alphas(p, scaled=False)
        aus, avs = PrincipledThin._alphas(p, scaled=True)
        pdf_sr = mf.pdf_vndf(wi, wh, au, av, mf.GGX) * dwh_dwo
        pdf_st = mf.pdf_vndf(wi, wh, aus, avs, mf.GGX) * dwh_dwo
        pdf = (
            jnp.where(reflect & compat_r, w[..., 0] * pdf_sr, 0.0)
            + jnp.where(refract & compat_t, w[..., 1] * pdf_st, 0.0)
            + jnp.where(reflect, w[..., 2] * jnp.abs(cos_o) * m.InvPi, 0.0)
            + jnp.where(refract, w[..., 3] * jnp.abs(cos_o) * m.InvPi, 0.0)
        )
        return jnp.where(active, pdf, 0.0)

    @staticmethod
    def sample(p, si, u1, u2, ctx, cfg, wavelengths):
        n = si.wi.shape[0]
        wi, _, cos_i, sgn = PrincipledThin._fold(si, si.wi)  # wo arg unused
        active = cos_i > 1e-9
        w = PrincipledThin._probs(p)
        c0 = w[..., 0]
        c1 = c0 + w[..., 1]
        c2 = c1 + w[..., 2]
        pick_sr = u1 < c0
        pick_st = (u1 >= c0) & (u1 < c1)
        pick_dr = (u1 >= c1) & (u1 < c2)
        pick_dt = u1 >= c2

        au, av = PrincipledThin._alphas(p, scaled=False)
        aus, avs = PrincipledThin._alphas(p, scaled=True)
        mh_r, _ = mf.sample_vndf_ggx(wi, u2, au, av)
        mh_t, _ = mf.sample_vndf_ggx(wi, u2, aus, avs)
        wo_sr = fr.reflect_n(wi, mh_r)
        wo_st_up = fr.reflect_n(wi, mh_t)
        wo_st = jnp.concatenate(
            [wo_st_up[..., :2], -jnp.abs(wo_st_up[..., 2:3])], axis=-1
        )
        wo_cos = warp.square_to_cosine_hemisphere(u2)
        wo_dt = jnp.concatenate(
            [wo_cos[..., :2], -wo_cos[..., 2:3]], axis=-1
        )
        wo_t = jnp.where(
            pick_sr[..., None], wo_sr,
            jnp.where(
                pick_st[..., None], wo_st,
                jnp.where(pick_dr[..., None], wo_cos, wo_dt),
            ),
        )
        wo = wo_t * sgn[..., None]  # unfold to the original side

        # kill samples whose micro/macro sides disagree for the PICKED lobe
        # (principledthin.cpp sample: active &= mac_mic_compatibility && side)
        side_sr = (
            (fr.cos_theta(wo_sr) > 0) & (fr.dot(wi, mh_r) > 0)
            & (fr.dot(wo_sr, mh_r) > 0)
        )
        side_st = (
            (fr.cos_theta(wo_st) < 0) & (fr.dot(wi, mh_t) > 0)
            & (fr.dot(wo_st, -mh_t) > 0)
        )
        lobe_ok = jnp.where(
            pick_sr, side_sr, jnp.where(pick_st, side_st, True)
        )

        pdf = PrincipledThin.pdf(p, si, wo, ctx, cfg)
        f, act2 = PrincipledThin._lobes(p, si, wo, cfg, wavelengths)
        ok = active & act2 & lobe_ok & (pdf > 1e-9)
        weight = jnp.where(
            ok[..., None], f / jnp.maximum(pdf, 1e-9)[..., None], 0.0
        )
        glossy = pick_sr | pick_st
        transmit = pick_st | pick_dt
        bs = BSDFSample(
            wo=wo,
            pdf=pdf,
            eta=jnp.ones((n,), jnp.float32),
            sampled_type=jnp.where(
                glossy & ~transmit, jnp.uint32(BSDFFlags.GlossyReflection),
                jnp.where(
                    glossy, jnp.uint32(BSDFFlags.GlossyTransmission),
                    jnp.where(
                        transmit,
                        jnp.uint32(BSDFFlags.DiffuseTransmission),
                        jnp.uint32(BSDFFlags.DiffuseReflection),
                    ),
                ),
            ),
            sampled_component=jnp.where(
                pick_sr, 0,
                jnp.where(pick_st, 1, jnp.where(pick_dr, 2, 3)),
            ),
        )
        return bs, depolarized(weight, cfg), ok


# ---------------------------------------------------------------------------
# measured_polarized (Mueller pBSDF tensor) — reference
# src/bsdfs/measured_polarized.cpp; algebra in librender/measured_polarized.py
# ---------------------------------------------------------------------------

class MeasuredPolarized:
    @staticmethod
    def eval(p, si, wo, ctx, cfg, wavelengths):
        from . import measured_polarized as mp_mod

        tab = p["_mpol"]
        val = mp_mod.eval_pbsdf(
            tab, si.wi, wo, ctx.mode == TransportMode.Radiance, cfg,
            wavelengths,
        )
        # eval_pbsdf keeps its public stacked [N, 4, 4, C] contract; the
        # dispatch layer trades in planar MuellerP values
        return mu.MuellerP.from_stack(val) if cfg.polarized else val

    @staticmethod
    def pdf(p, si, wo, ctx, cfg):
        from . import measured_polarized as mp_mod

        return mp_mod.pdf_pbsdf(p["_mpol"], si.wi, wo)

    @staticmethod
    def sample(p, si, u1, u2, ctx, cfg, wavelengths):
        from . import measured_polarized as mp_mod

        n = si.wi.shape[0]
        tab = p["_mpol"]
        wo, pdf = mp_mod.sample_pbsdf(tab, si.wi, u1, u2)
        f = MeasuredPolarized.eval(p, si, wo, ctx, cfg, wavelengths)
        ok = pdf > 1e-9
        inv = jnp.where(ok, 1.0 / jnp.maximum(pdf, 1e-9), 0.0)
        weight = mul_value(
            f, jnp.broadcast_to(inv[..., None], (n, cfg.n_channels)), cfg
        )
        bs = BSDFSample(
            wo=wo,
            pdf=pdf,
            eta=jnp.ones((n,), jnp.float32),
            sampled_type=jnp.full(
                (n,), jnp.uint32(BSDFFlags.GlossyReflection)
            ),
            sampled_component=jnp.zeros((n,), jnp.int32),
        )
        return bs, weight, ok


# ---------------------------------------------------------------------------
# hair (Chiang fiber model) — reference src/bsdfs/hair.cpp; algebra lives in
# librender/hair.py. Full-sphere scattering: no upper-hemisphere gating.
# ---------------------------------------------------------------------------

class Hair:
    @staticmethod
    def eval(p, si, wo, ctx, cfg, wavelengths):
        from . import hair as hair_mod

        return depolarized(
            hair_mod.hair_eval(p, si.wi, wo, cfg, wavelengths), cfg
        )

    @staticmethod
    def pdf(p, si, wo, ctx, cfg):
        from . import hair as hair_mod

        return hair_mod.hair_pdf(p, si.wi, wo, cfg)

    @staticmethod
    def sample(p, si, u1, u2, ctx, cfg, wavelengths):
        from . import hair as hair_mod

        n = si.wi.shape[0]
        wo, pdf = hair_mod.hair_sample(p, si.wi, u1, u2, cfg, wavelengths)
        f = hair_mod.hair_eval(p, si.wi, wo, cfg, wavelengths)
        ok = pdf > 1e-9
        weight = jnp.where(
            ok[..., None], f / jnp.maximum(pdf, 1e-9)[..., None], 0.0
        )
        bs = BSDFSample(
            wo=wo,
            pdf=pdf,
            eta=jnp.ones((n,), jnp.float32),
            sampled_type=jnp.full(
                (n,), jnp.uint32(BSDFFlags.GlossyReflection
                                 | BSDFFlags.GlossyTransmission)
            ),
            sampled_component=jnp.zeros((n,), jnp.int32),
        )
        return bs, depolarized(weight, cfg), ok


# ---------------------------------------------------------------------------
# mask (opacity blend with null transmission) — reference src/bsdfs/mask.cpp
# nested BSDF rides in `nested_idx`; opacity in `weight`.
# ---------------------------------------------------------------------------

class MaskBSDF:
    @staticmethod
    def sample(p, si, u1, u2, ctx, cfg, wavelengths):
        n = si.wi.shape[0]
        opacity = p["weight"]
        sel_pass = u1 >= opacity
        # nested diffuse fallback (full nested dispatch happens at the
        # dispatcher level via nested parameter remapping)
        u1n = jnp.where(sel_pass, 0.0, u1 / jnp.maximum(opacity, 1e-6))
        bs_n, val_n, ok_n = Diffuse.sample(p, si, u1n, u2, ctx, cfg, wavelengths)
        wo = jnp.where(sel_pass[..., None], -si.wi, bs_n.wo)
        one = jnp.ones((n, cfg.n_channels), jnp.float32)
        value = where_value(sel_pass, depolarized(one, cfg), val_n, cfg)
        bs = BSDFSample(
            wo=wo,
            pdf=jnp.where(sel_pass, 1.0 - opacity, bs_n.pdf * opacity),
            eta=jnp.ones((n,), jnp.float32),
            sampled_type=jnp.where(
                sel_pass, jnp.uint32(BSDFFlags.Null), bs_n.sampled_type
            ),
            sampled_component=jnp.where(sel_pass, 0, bs_n.sampled_component),
        )
        ok = jnp.where(sel_pass, jnp.ones((n,), bool), ok_n)
        return bs, value, ok

    @staticmethod
    def eval(p, si, wo, ctx, cfg, wavelengths):
        opacity = p["weight"]
        val = Diffuse.eval(p, si, wo, ctx, cfg, wavelengths)
        return mul_value(
            val, jnp.broadcast_to(opacity[..., None], (si.wi.shape[0], cfg.n_channels)), cfg
        )

    @staticmethod
    def pdf(p, si, wo, ctx, cfg):
        return Diffuse.pdf(p, si, wo, ctx, cfg) * p["weight"]


# ---------------------------------------------------------------------------
# ideal polarizer / retarder — reference src/bsdfs/{polarizer,retarder}.cpp
# (transmissive polarization elements; `weight` = element angle in degrees)
# ---------------------------------------------------------------------------

class Polarizer:
    @staticmethod
    def sample(p, si, u1, u2, ctx, cfg, wavelengths):
        n = si.wi.shape[0]
        wo = -si.wi
        theta = jnp.deg2rad(p["weight"])
        refl = eval_color(p, "base_color", cfg, wavelengths)  # transmittance
        if cfg.polarized:
            M = mu.rotated_element(theta, mu.linear_polarizer(jnp.ones_like(theta)))
            value = mul_value(mu.MuellerP.from_stack(M), refl, cfg)
        else:
            value = 0.5 * refl
        bs = BSDFSample(
            wo=wo,
            pdf=jnp.ones((n,), jnp.float32),
            eta=jnp.ones((n,), jnp.float32),
            sampled_type=jnp.full((n,), BSDFFlags.Null, jnp.uint32),
            sampled_component=jnp.zeros((n,), jnp.int32),
        )
        return bs, value, jnp.ones((n,), bool)

    @staticmethod
    def eval(p, si, wo, ctx, cfg, wavelengths):
        return zeros_value(si.wi.shape[0], cfg)

    @staticmethod
    def pdf(p, si, wo, ctx, cfg):
        return jnp.zeros(si.wi.shape[0], jnp.float32)


class Retarder:
    @staticmethod
    def sample(p, si, u1, u2, ctx, cfg, wavelengths):
        n = si.wi.shape[0]
        wo = -si.wi
        theta = jnp.deg2rad(p["weight"])
        delta = jnp.deg2rad(p["grt_height"])  # phase delay reuses a slot
        refl = eval_color(p, "base_color", cfg, wavelengths)
        if cfg.polarized:
            M = mu.rotated_element(theta, mu.linear_retarder(delta))
            value = mul_value(mu.MuellerP.from_stack(M), refl, cfg)
        else:
            value = refl
        bs = BSDFSample(
            wo=wo,
            pdf=jnp.ones((n,), jnp.float32),
            eta=jnp.ones((n,), jnp.float32),
            sampled_type=jnp.full((n,), BSDFFlags.Null, jnp.uint32),
            sampled_component=jnp.zeros((n,), jnp.int32),
        )
        return bs, value, jnp.ones((n,), bool)

    @staticmethod
    def eval(p, si, wo, ctx, cfg, wavelengths):
        return zeros_value(si.wi.shape[0], cfg)

    @staticmethod
    def pdf(p, si, wo, ctx, cfg):
        return jnp.zeros(si.wi.shape[0], jnp.float32)


class CircularPolarizer:
    """Ideal circular polarizer (reference src/bsdfs/circular.cpp):
    transmissive element passing right- (weight >= 0) or left-handed
    (weight < 0) circular polarization."""

    @staticmethod
    def sample(p, si, u1, u2, ctx, cfg, wavelengths):
        n = si.wi.shape[0]
        wo = -si.wi
        refl = eval_color(p, "base_color", cfg, wavelengths)
        if cfg.polarized:
            right = (p["weight"] >= 0)[..., None, None]
            M = jnp.where(
                right,
                mu.right_circular_polarizer((n,)),
                mu.left_circular_polarizer((n,)),
            )
            value = mul_value(mu.MuellerP.from_stack(M), refl, cfg)
        else:
            value = 0.5 * refl
        bs = BSDFSample(
            wo=wo,
            pdf=jnp.ones((n,), jnp.float32),
            eta=jnp.ones((n,), jnp.float32),
            sampled_type=jnp.full((n,), BSDFFlags.Null, jnp.uint32),
            sampled_component=jnp.zeros((n,), jnp.int32),
        )
        return bs, value, jnp.ones((n,), bool)

    @staticmethod
    def eval(p, si, wo, ctx, cfg, wavelengths):
        return zeros_value(si.wi.shape[0], cfg)

    @staticmethod
    def pdf(p, si, wo, ctx, cfg):
        return jnp.zeros(si.wi.shape[0], jnp.float32)


class PPlastic:
    """Polarized plastic (reference src/bsdfs/pplastic.cpp): specular
    dielectric coat with full Mueller Fresnel over a depolarizing diffuse
    base."""

    @staticmethod
    def sample(p, si, u1, u2, ctx, cfg, wavelengths):
        n = si.wi.shape[0]
        cos_i = fr.cos_theta(si.wi)
        active = cos_i > 0
        eta = p["eta_re"][..., 0]
        F_i, _, _, _ = fres.fresnel_dielectric(cos_i, eta)
        prob_spec = F_i
        sel_spec = u1 < prob_spec

        wo_spec = fr.reflect(si.wi)
        wo_diff = warp.square_to_cosine_hemisphere(u2)
        wo = jnp.where(sel_spec[..., None], wo_spec, wo_diff)
        cos_o = fr.cos_theta(wo)
        F_o, _, _, _ = fres.fresnel_dielectric(cos_o, eta)
        diff = eval_color(p, "base_color", cfg, wavelengths)
        diff_val = diff * ((1.0 - F_i) * (1.0 - F_o))[..., None]

        if cfg.polarized:
            wo_hat = wo if ctx.mode == TransportMode.Radiance else si.wi
            wi_hat = si.wi if ctx.mode == TransportMode.Radiance else wo
            ct_hat = fr.cos_theta(wo_hat)
            MR = mu.p_specular_reflection_dielectric(
                ct_hat[..., None], eta[..., None]
            )
            normal = jnp.broadcast_to(
                jnp.asarray([0.0, 0.0, 1.0], jnp.float32), wo.shape
            )
            spec_M = _spec_reflect_mueller(wo_hat, wi_hat, lambda: MR, normal, cfg)
            spec_M = mul_value(
                spec_M, jnp.where(F_i > 0, 1.0 / jnp.maximum(F_i, 1e-6), 0.0)[
                    ..., None
                ] * jnp.ones((n, cfg.n_channels)), cfg,
            )
            diff_M = depolarized(
                diff_val / jnp.maximum(1.0 - prob_spec, 1e-6)[..., None], cfg
            )
            value = where_value(sel_spec, spec_M, diff_M, cfg)
        else:
            w_spec = jnp.ones((n, cfg.n_channels), jnp.float32)
            w_diff = diff_val / jnp.maximum(1.0 - prob_spec, 1e-6)[..., None]
            value = jnp.where(sel_spec[..., None], w_spec, w_diff)

        pdf_diff = warp.square_to_cosine_hemisphere_pdf(wo) * (1.0 - prob_spec)
        bs = BSDFSample(
            wo=wo,
            pdf=jnp.where(sel_spec, prob_spec, pdf_diff),
            eta=jnp.ones((n,), jnp.float32),
            sampled_type=jnp.where(
                sel_spec,
                jnp.uint32(BSDFFlags.DeltaReflection),
                jnp.uint32(BSDFFlags.DiffuseReflection),
            ),
            sampled_component=jnp.where(sel_spec, 0, 1).astype(jnp.int32),
        )
        ok = active & (cos_o > 0)
        return bs, where_value(ok, value, zeros_value(n, cfg), cfg), ok

    @staticmethod
    def eval(p, si, wo, ctx, cfg, wavelengths):
        n = si.wi.shape[0]
        cos_i = fr.cos_theta(si.wi)
        cos_o = fr.cos_theta(wo)
        active = (cos_i > 0) & (cos_o > 0)
        eta = p["eta_re"][..., 0]
        F_i, _, _, _ = fres.fresnel_dielectric(cos_i, eta)
        F_o, _, _, _ = fres.fresnel_dielectric(cos_o, eta)
        diff = eval_color(p, "base_color", cfg, wavelengths)
        val = diff * (m.InvPi * cos_o * (1.0 - F_i) * (1.0 - F_o))[..., None]
        return where_value(active, depolarized(val, cfg),
                           zeros_value(n, cfg), cfg)

    @staticmethod
    def pdf(p, si, wo, ctx, cfg):
        cos_i = fr.cos_theta(si.wi)
        cos_o = fr.cos_theta(wo)
        eta = p["eta_re"][..., 0]
        F_i, _, _, _ = fres.fresnel_dielectric(cos_i, eta)
        pdf = warp.square_to_cosine_hemisphere_pdf(wo) * (1.0 - F_i)
        return jnp.where((cos_i > 0) & (cos_o > 0), pdf, 0.0)


IMPLS = {
    BSDF_NULL: Null,
    BSDF_DIFFUSE: Diffuse,
    BSDF_CONDUCTOR: Conductor,
    BSDF_ROUGH_CONDUCTOR: RoughConductor,
    BSDF_DIELECTRIC: Dielectric,
    BSDF_ROUGH_DIELECTRIC: RoughDielectric,
    BSDF_THIN_DIELECTRIC: ThinDielectric,
    BSDF_PLASTIC: Plastic,
    BSDF_ROUGH_PLASTIC: RoughPlastic,
    BSDF_MASK: MaskBSDF,
    BSDF_POLARIZER: Polarizer,
    BSDF_RETARDER: Retarder,
    BSDF_CIRCULAR: CircularPolarizer,
    BSDF_PPLASTIC: PPlastic,
    BSDF_PRINCIPLED: Principled,
    BSDF_PRINCIPLED_THIN: PrincipledThin,
    BSDF_MEASURED: Measured,
    BSDF_HAIR: Hair,
    BSDF_MEASURED_POLARIZED: MeasuredPolarized,
}


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _flip_z(v):
    return v * jnp.asarray([1.0, 1.0, -1.0], jnp.float32)


def _effective_si(p, si):
    """Twosided handling: mirror the local frame for back-facing lanes of
    twosided materials (reference: src/bsdfs/twosided.cpp)."""
    flip = jnp.logical_and(p["twosided"], si.wi[..., 2] < 0)
    import dataclasses as _dc

    wi_eff = jnp.where(flip[..., None], _flip_z(si.wi), si.wi)
    return _dc.replace(si, wi=wi_eff), flip


def _loop_sample(mat, p, si, u1, u2, ctx, cfg, wavelengths):
    """Masked per-type sample loop over a gathered parameter dict."""
    n = si.wi.shape[0]
    bs_acc = BSDFSample.zeros(n)
    val_acc = zeros_value(n, cfg)
    ok_acc = jnp.zeros((n,), bool)
    for t in mat.present_types:
        impl = IMPLS.get(t)
        if impl is None:
            continue
        mask = p["mtype"] == t
        bs, val, ok = impl.sample(p, si, u1, u2, ctx, cfg, wavelengths)
        bs_acc = BSDFSample(
            wo=jnp.where(mask[..., None], bs.wo, bs_acc.wo),
            pdf=jnp.where(mask, bs.pdf, bs_acc.pdf),
            eta=jnp.where(mask, bs.eta, bs_acc.eta),
            sampled_type=jnp.where(mask, bs.sampled_type, bs_acc.sampled_type),
            sampled_component=jnp.where(
                mask, bs.sampled_component, bs_acc.sampled_component
            ),
        )
        val_acc = where_value(mask, val, val_acc, cfg)
        ok_acc = jnp.where(mask, ok, ok_acc)
    return bs_acc, val_acc, ok_acc


def _loop_eval(mat, p, si, wo, ctx, cfg, wavelengths):
    val_acc = zeros_value(si.wi.shape[0], cfg)
    for t in mat.present_types:
        impl = IMPLS.get(t)
        if impl is None:
            continue
        mask = p["mtype"] == t
        val = impl.eval(p, si, wo, ctx, cfg, wavelengths)
        val_acc = where_value(mask, val, val_acc, cfg)
    return val_acc


def _loop_pdf(mat, p, si, wo, ctx, cfg):
    pdf_acc = jnp.zeros(si.wi.shape[0], jnp.float32)
    for t in mat.present_types:
        impl = IMPLS.get(t)
        if impl is None:
            continue
        mask = p["mtype"] == t
        pd = impl.pdf(p, si, wo, ctx, cfg)
        pdf_acc = jnp.where(mask, pd, pdf_acc)
    return pdf_acc


# ---------------------------------------------------------------------------
# nested wrappers: blendbsdf / normalmap / bumpmap
# (reference src/bsdfs/{blendbsdf,normalmap,bumpmap}.cpp). One level of
# nesting: the wrapper row is resolved to its child row(s) by parameter
# remapping before the masked type loop; normal/bump perturb the shading
# frame, blend mixes two children.
# ---------------------------------------------------------------------------

NESTED_WRAPPERS = (BSDF_BLEND, BSDF_NORMALMAP, BSDF_BUMPMAP)


def _has_nested(mat):
    return any(t in mat.present_types for t in NESTED_WRAPPERS)


def _perturbed_frame(p, si):
    """Per-lane perturbed shading frame (s', t', n') in the CURRENT local
    frame, from the wrapper row's own texture: normalmap decodes 2c-1
    (normalmap.cpp), bumpmap uses height-map finite differences scaled by
    `weight` (bumpmap.cpp)."""
    n_lanes = si.wi.shape[0]
    mtype = p["mtype"]
    is_nm = mtype == BSDF_NORMALMAP
    is_bm = mtype == BSDF_BUMPMAP
    n_loc = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 1.0], jnp.float32), (n_lanes, 3)
    )
    tex_stack = p.get("_tex_stack")
    if tex_stack is not None and p.get("tex_idx") is not None:
        uv = si.uv * p["tex_uv_scale"]
        ti = jnp.clip(p["tex_idx"], 0, tex_stack.shape[0] - 1)
        c = _bitmap_bilinear(tex_stack, ti, uv)
        has_tex = p["tex_idx"] >= 0
        nm = c * 2.0 - 1.0
        nm = nm / jnp.maximum(
            jnp.linalg.norm(nm, axis=-1, keepdims=True), 1e-6
        )
        # bump: central differences of the height (luminance)
        R = tex_stack.shape[1]
        eps = 1.0 / R
        def h(du, dv):
            cc = _bitmap_bilinear(
                tex_stack, ti, uv + jnp.asarray([du, dv], jnp.float32)
            )
            return jnp.mean(cc, axis=-1)
        dhdu = (h(eps, 0.0) - h(-eps, 0.0)) / (2 * eps)
        dhdv = (h(0.0, eps) - h(0.0, -eps)) / (2 * eps)
        scale = p["weight"]
        bn = jnp.stack(
            [-scale * dhdu, -scale * dhdv, jnp.ones((n_lanes,), jnp.float32)],
            axis=-1,
        )
        bn = bn / jnp.maximum(jnp.linalg.norm(bn, axis=-1, keepdims=True), 1e-6)
        n_loc = jnp.where(
            (is_nm & has_tex)[..., None], nm,
            jnp.where((is_bm & has_tex)[..., None], bn, n_loc),
        )
    # frame from n_loc: s' = normalize(x - n * n.x)
    nx = n_loc[..., 0:1]
    s = jnp.asarray([1.0, 0.0, 0.0], jnp.float32) - n_loc * nx
    s = s / jnp.maximum(jnp.linalg.norm(s, axis=-1, keepdims=True), 1e-6)
    t = jnp.cross(n_loc, s)
    return s, t, n_loc


def _nested_remap(mat, midx, p, si, u1):
    """Resolve wrapper lanes: returns (p_eff_A, p_eff_B, si_perturbed,
    (s', t', n'), u1_eff, is_blend, w, perturb) — p_eff_B differs from A
    only on blend lanes (child B)."""
    mtype = p["mtype"]
    is_wrap = jnp.zeros_like(mtype, dtype=bool)
    for t in NESTED_WRAPPERS:
        is_wrap = is_wrap | (mtype == t)
    is_blend = mtype == BSDF_BLEND
    w = jnp.clip(p["weight"], 0.0, 1.0)

    nested_a = jnp.maximum(p["nested_idx"], 0)
    nested_b = jnp.maximum(p["nested_idx2"], 0)
    # blend sample: child A with probability w (reference blendbsdf.cpp
    # samples nested_bsdf[sample1 < weight ? 1 : 0] with weight for B —
    # here A carries `weight`, B carries 1-weight)
    pick_a = u1 < w
    u1_eff = jnp.where(
        is_blend,
        jnp.where(pick_a, u1 / jnp.maximum(w, 1e-6),
                  (u1 - w) / jnp.maximum(1.0 - w, 1e-6)),
        u1,
    )
    child = jnp.where(is_blend & ~pick_a, nested_b, nested_a)
    midx_a = jnp.where(is_wrap, child, midx)
    midx_b = jnp.where(is_blend, nested_b, midx_a)

    # perturbed frame for normal/bump lanes
    s_, t_, n_ = _perturbed_frame(p, si)
    perturb = (mtype == BSDF_NORMALMAP) | (mtype == BSDF_BUMPMAP)
    ident_s = jnp.asarray([1.0, 0.0, 0.0], jnp.float32)
    ident_t = jnp.asarray([0.0, 1.0, 0.0], jnp.float32)
    ident_n = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
    s_ = jnp.where(perturb[..., None], s_, ident_s)
    t_ = jnp.where(perturb[..., None], t_, ident_t)
    n_ = jnp.where(perturb[..., None], n_, ident_n)

    import dataclasses as _dc

    wi_p = jnp.stack(
        [jnp.sum(si.wi * s_, -1), jnp.sum(si.wi * t_, -1),
         jnp.sum(si.wi * n_, -1)], axis=-1
    )
    si_p = _dc.replace(si, wi=wi_p)

    p_a = mat.gather(midx_a)
    p_a["_uv"] = si.uv
    p_a["_tex_stack"] = mat.tex_stack
    p_a["_meas"] = mat.meas
    p_a["_mpol"] = mat.mpol
    p_a["_vcol"] = getattr(si, "vcol", None)
    p_a["_p"] = si.p
    p_a["_vtex_grid"] = mat.vtex_grid
    p_a["_vtex_min"] = mat.vtex_min
    p_a["_vtex_max"] = mat.vtex_max
    p_b = mat.gather(midx_b)
    p_b["_uv"] = si.uv
    p_b["_tex_stack"] = mat.tex_stack
    p_b["_meas"] = mat.meas
    p_b["_mpol"] = mat.mpol
    p_b["_vcol"] = getattr(si, "vcol", None)
    p_b["_p"] = si.p
    p_b["_vtex_grid"] = mat.vtex_grid
    p_b["_vtex_min"] = mat.vtex_min
    p_b["_vtex_max"] = mat.vtex_max
    return p_a, p_b, si_p, (s_, t_, n_), u1_eff, is_blend, w, perturb


def _to_frame(v, frame):
    s_, t_, n_ = frame
    return jnp.stack(
        [jnp.sum(v * s_, -1), jnp.sum(v * t_, -1), jnp.sum(v * n_, -1)],
        axis=-1,
    )


def _from_frame(v, frame):
    s_, t_, n_ = frame
    return s_ * v[..., 0:1] + t_ * v[..., 1:2] + n_ * v[..., 2:3]


def sample(mat: MaterialTable, midx, si, u1, u2, ctx, cfg, wavelengths=None):
    """Dispatching BSDF sample over all present material types.

    Returns (BSDFSample, weight_value, active_mask).
    """
    n = si.wi.shape[0]
    p = mat.gather(midx)
    si_eff, flip = _effective_si(p, si)
    p["_uv"] = si_eff.uv
    p["_tex_stack"] = mat.tex_stack
    p["_meas"] = mat.meas
    p["_mpol"] = mat.mpol
    p["_vcol"] = getattr(si_eff, "vcol", None)
    p["_p"] = si_eff.p
    p["_vtex_grid"] = mat.vtex_grid
    p["_vtex_min"] = mat.vtex_min
    p["_vtex_max"] = mat.vtex_max

    if not _has_nested(mat):
        bs_acc, val_acc, ok_acc = _loop_sample(
            mat, p, si_eff, u1, u2, ctx, cfg, wavelengths
        )
    else:
        p_a, p_b, si_p, frame, u1_eff, is_blend, w, perturb = _nested_remap(
            mat, midx, p, si_eff, u1
        )
        bs_acc, val_acc, ok_acc = _loop_sample(
            mat, p_a, si_p, u1_eff, u2, ctx, cfg, wavelengths
        )
        wo_back = _from_frame(bs_acc.wo, frame)
        # sampled direction must lie on the same side of BOTH frames
        # (normalmap.cpp:131-132)
        perturb_ok = (wo_back[..., 2] * bs_acc.wo[..., 2]) > 0
        ok_acc = ok_acc & (~perturb | perturb_ok)
        bs_acc = BSDFSample(
            wo=wo_back, pdf=bs_acc.pdf, eta=bs_acc.eta,
            sampled_type=bs_acc.sampled_type,
            sampled_component=bs_acc.sampled_component,
        )
        if BSDF_BLEND in mat.present_types:
            # mixture weight/pdf on blend lanes (blendbsdf.cpp eval/pdf)
            ev_a = _loop_eval(mat, p_a, si_p, bs_acc.wo, ctx, cfg, wavelengths)
            ev_b = _loop_eval(mat, p_b, si_p, bs_acc.wo, ctx, cfg, wavelengths)
            pd_a = _loop_pdf(mat, p_a, si_p, bs_acc.wo, ctx, cfg)
            pd_b = _loop_pdf(mat, p_b, si_p, bs_acc.wo, ctx, cfg)
            pdf_mix = w * pd_a + (1.0 - w) * pd_b
            wc = jnp.broadcast_to(w[..., None], (n, cfg.n_channels))
            ev_mix = add_value(
                mul_value(ev_a, wc, cfg), mul_value(ev_b, 1.0 - wc, cfg), cfg
            )
            inv_pdf = jnp.where(pdf_mix > 0, 1.0 / jnp.maximum(pdf_mix, 1e-20), 0.0)
            val_mix = mul_value(
                ev_mix,
                jnp.broadcast_to(inv_pdf[..., None], (n, cfg.n_channels)),
                cfg,
            )
            bs_acc = BSDFSample(
                wo=bs_acc.wo,
                pdf=jnp.where(is_blend, pdf_mix, bs_acc.pdf),
                eta=bs_acc.eta,
                sampled_type=bs_acc.sampled_type,
                sampled_component=bs_acc.sampled_component,
            )
            val_acc = where_value(is_blend, val_mix, val_acc, cfg)
            ok_acc = jnp.where(is_blend, pdf_mix > 0, ok_acc)

    # un-flip wo for mirrored lanes
    wo_out = jnp.where(flip[..., None], _flip_z(bs_acc.wo), bs_acc.wo)
    bs_acc = BSDFSample(
        wo=wo_out,
        pdf=bs_acc.pdf,
        eta=bs_acc.eta,
        sampled_type=bs_acc.sampled_type,
        sampled_component=bs_acc.sampled_component,
    )
    return bs_acc, val_acc, ok_acc


def eval_(mat: MaterialTable, midx, si, wo, ctx, cfg, wavelengths=None):
    p = mat.gather(midx)
    si_eff, flip = _effective_si(p, si)
    wo_eff = jnp.where(flip[..., None], _flip_z(wo), wo)
    p["_uv"] = si_eff.uv
    p["_tex_stack"] = mat.tex_stack
    p["_meas"] = mat.meas
    p["_mpol"] = mat.mpol
    p["_vcol"] = getattr(si_eff, "vcol", None)
    p["_p"] = si_eff.p
    p["_vtex_grid"] = mat.vtex_grid
    p["_vtex_min"] = mat.vtex_min
    p["_vtex_max"] = mat.vtex_max

    if not _has_nested(mat):
        return _loop_eval(mat, p, si_eff, wo_eff, ctx, cfg, wavelengths)

    p_a, p_b, si_p, frame, _, is_blend, w, perturb = _nested_remap(
        mat, midx, p, si_eff, jnp.zeros_like(p["weight"])
    )
    wo_p = _to_frame(wo_eff, frame)
    val = _loop_eval(mat, p_a, si_p, wo_p, ctx, cfg, wavelengths)
    if BSDF_BLEND in mat.present_types:
        val_b = _loop_eval(mat, p_b, si_p, wo_p, ctx, cfg, wavelengths)
        n = si.wi.shape[0]
        wc = jnp.broadcast_to(w[..., None], (n, cfg.n_channels))
        mix = add_value(
            mul_value(val, wc, cfg), mul_value(val_b, 1.0 - wc, cfg), cfg
        )
        val = where_value(is_blend, mix, val, cfg)
    # same-side mask on perturbed lanes (normalmap.cpp:147-148)
    side_ok = (wo_eff[..., 2] * wo_p[..., 2]) > 0
    val = where_value(
        ~perturb | side_ok, val, zeros_value(si.wi.shape[0], cfg), cfg
    )
    return val


def pdf(mat: MaterialTable, midx, si, wo, ctx, cfg):
    p = mat.gather(midx)
    si_eff, flip = _effective_si(p, si)
    p["_uv"] = si_eff.uv
    p["_tex_stack"] = mat.tex_stack
    p["_meas"] = mat.meas
    p["_mpol"] = mat.mpol
    p["_vcol"] = getattr(si_eff, "vcol", None)
    p["_p"] = si_eff.p
    p["_vtex_grid"] = mat.vtex_grid
    p["_vtex_min"] = mat.vtex_min
    p["_vtex_max"] = mat.vtex_max
    wo_eff = jnp.where(flip[..., None], _flip_z(wo), wo)

    if not _has_nested(mat):
        return _loop_pdf(mat, p, si_eff, wo_eff, ctx, cfg)

    p_a, p_b, si_p, frame, _, is_blend, w, perturb = _nested_remap(
        mat, midx, p, si_eff, jnp.zeros_like(p["weight"])
    )
    wo_p = _to_frame(wo_eff, frame)
    pd = _loop_pdf(mat, p_a, si_p, wo_p, ctx, cfg)
    if BSDF_BLEND in mat.present_types:
        pd_b = _loop_pdf(mat, p_b, si_p, wo_p, ctx, cfg)
        pd = jnp.where(is_blend, w * pd + (1.0 - w) * pd_b, pd)
    side_ok = (wo_eff[..., 2] * wo_p[..., 2]) > 0
    return jnp.where(~perturb | side_ok, pd, 0.0)


def eval_pdf(mat, midx, si, wo, ctx, cfg, wavelengths=None):
    return (
        eval_(mat, midx, si, wo, ctx, cfg, wavelengths),
        pdf(mat, midx, si, wo, ctx, cfg),
    )


def flags_for(mat: MaterialTable, midx):
    """Per-lane BSDFFlags."""
    return mat.flags[midx]
