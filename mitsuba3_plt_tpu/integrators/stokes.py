"""Polarized transport: Mueller path tracer + Stokes AOV wrappers.

Functional twins of the reference's polarized variants + `stokes` /
`stokes_fw` integrator plugins (src/integrators/stokes.cpp,
src/integrators/stokes_fw.cpp:88-140): the path tracer carries a Mueller
throughput [N, 4, 4, C] (the polarized `Spectrum` of the reference) chained
camera-side-first, so the final Stokes radiance is T @ S_emitter. The
wrapper emits 15 channels: RGB intensity + S0..S3 (each RGB), matching the
fork's stokes_to_bitmaps layout (scripts/utils/polarization.py:6-26).

`stokes_fw` additionally rotates the final Stokes basis to the sensor's
horizontal axis (stokes_fw.cpp:100-110) so S1/S2 are reported in a fixed
camera frame.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..core import frame as fr
from ..core import math as mth
from ..core.rng import Sampler, bounce_dim
from ..librender import bsdfs
from ..librender import mueller as mu
from ..librender.bsdf import BSDFContext, BSDFFlags
from ..librender.records import Ray, DirectionSample
from ..scene import emitters as em_mod
from .common import mis_weight
from .path import _to_channels


def _s_add(a, b):
    """Add two planar Stokes 4-tuples (None = structural zero)."""
    return tuple(
        y if x is None else (x if y is None else x + y) for x, y in zip(a, b)
    )


def _s_scale(s, f):
    """Scale a planar Stokes 4-tuple by [N] (broadcast over C)."""
    fc = f[..., None]
    return tuple(None if x is None else x * fc for x in s)


def _s_where(mask, a, b):
    mc = mask[..., None]
    return tuple(
        None if (x is None and y is None) else jnp.where(
            mc,
            jnp.zeros((), jnp.float32) if x is None else x,
            jnp.zeros((), jnp.float32) if y is None else y,
        )
        for x, y in zip(a, b)
    )


def _s_stack(s, n, C):
    """Planar Stokes 4-tuple -> stacked [N, 4, C]."""
    return jnp.stack([
        jnp.broadcast_to(
            jnp.zeros((), jnp.float32) if x is None else x, (n, C)
        )
        for x in s
    ], axis=1)


def _unpol_stokes(value):
    """Unpolarized radiance [N, C] -> Stokes [N, 4, C]."""
    z = jnp.zeros_like(value)
    return jnp.stack([value, z, z, z], axis=1)


# BSDF types whose polarized Mueller values are S0-SEPARABLE in this
# implementation: block-diagonal with first row and column (m00, 0, 0, 0) —
# depolarizers (`bsdfs.depolarized`), identity pass-throughs (null), and
# wrappers of such. For a scene whose every material is in this set (and
# unpolarized emitters, which is all of them — emitter radiance enters as
# `_unpol_stokes`), the Mueller chain satisfies
#     T @ S_unpol = (prod m00 * s0, 0, 0, 0)
# exactly: a product of such matrices is itself S0-separable, and rotator
# basis changes preserve the property (R has first row/col e0). The Stokes
# image is therefore (L_scalar, 0, 0, 0) and the integrator can run the
# SCALAR transport — the depolarizer-collapse fast path (equivalence pinned
# by tests/test_stokes.py::test_depolarizer_collapse_equivalence).
_S0_SEPARABLE_TYPES = frozenset({
    bsdfs.BSDF_NULL,
    bsdfs.BSDF_DIFFUSE,
    bsdfs.BSDF_THIN_DIELECTRIC,     # depolarized() in this impl
    bsdfs.BSDF_ROUGH_DIELECTRIC,    # depolarized() in this impl
    bsdfs.BSDF_PLASTIC,             # depolarized() in this impl
    bsdfs.BSDF_ROUGH_PLASTIC,
    bsdfs.BSDF_PRINCIPLED,
    bsdfs.BSDF_PRINCIPLED_THIN,
    bsdfs.BSDF_MEASURED,
    bsdfs.BSDF_HAIR,
    # wrappers: S0-separable iff their children are — children occupy their
    # own table rows, so present_types covers them independently
    bsdfs.BSDF_MASK,
    bsdfs.BSDF_BLEND,
    bsdfs.BSDF_NORMALMAP,
    bsdfs.BSDF_BUMPMAP,
})


def depolarizer_collapse_ok(scene) -> bool:
    """Static (host-side) check: every material lobe in the scene maps
    unpolarized light to unpolarized light with scalar weight m00 equal to
    the unpolarized eval — i.e. full Mueller transport provably equals the
    scalar path with S1..S3 = 0."""
    return set(scene.materials.present_types) <= _S0_SEPARABLE_TYPES


@dataclasses.dataclass(frozen=True)
class PolarizedPathIntegrator:
    """NEE+MIS path tracer with full Mueller-matrix throughput.

    Returns Stokes radiance [N, 4, C] whose implicit basis is
    stokes_basis(-ray.d) (the arriving beam toward the sensor).
    """

    max_depth: int = 6
    rr_depth: int = 5
    force_full: bool = False  # disable the collapse (testing/diagnostics)

    def sample_stokes(self, scene, sampler: Sampler, ray: Ray, wavelengths,
                      cfg: RenderConfig):
        assert cfg.polarized, "PolarizedPathIntegrator needs a polarized config"
        if not self.force_full and depolarizer_collapse_ok(scene):
            # depolarizer collapse (static): the scene's Mueller chain is
            # provably (L_scalar, 0, 0, 0) — run the scalar transport (same
            # sampler dims; bit-identical m00 chain) instead of carrying a
            # [N, 4, 4, C] throughput. ~1.8x on all-diffuse scenes.
            from .path import PathIntegrator

            L, _ = PathIntegrator(
                max_depth=self.max_depth, rr_depth=self.rr_depth
            ).sample(
                scene, sampler, ray, wavelengths,
                dataclasses.replace(cfg, polarized=False),
            )
            return _unpol_stokes(L)
        n = ray.o.shape[0]
        C = cfg.n_channels
        em = scene.emitters
        geo = scene.geo
        has_emitters = em.count > 0
        ctx = BSDFContext()

        L = tuple(jnp.zeros((n, C), jnp.float32) for _ in range(4))
        T = mu.MuellerP.identity().materialize(n, C)
        eta0 = jnp.ones((n,), jnp.float32)
        active = jnp.ones((n,), bool)
        prev_pdf = jnp.ones((n,), jnp.float32)
        prev_delta = jnp.ones((n,), bool)
        prev_p = ray.o

        def world_mueller(si, M_local, wo_local):
            """Local BSDF Mueller -> world implicit bases (Radiance mode:
            light arrives along -wo, leaves along +wi)."""
            return bsdfs.to_world_mueller(si, M_local, -wo_local, si.wi)

        def body(carry, b, coherent=False):
            (ray_o, ray_d, L, T, eta, active, prev_pdf, prev_delta,
             prev_p) = carry
            b_arr = jnp.asarray(b)
            coh0 = (b_arr == 0) if b_arr.ndim == 0 else False
            ray_b = Ray.create(ray_o, ray_d)
            si = scene.ray_intersect(ray_b, coherent=coh0)
            hit = si.valid & active

            # ---- emitter hit with MIS ---------------------------------
            if has_emitters:
                hit_emitter = hit & (si.emitter_idx >= 0) & (
                    fr.cos_theta(si.wi) > 0
                )
                d = ray_d
                ds_hit = DirectionSample(
                    p=si.p, n=si.n, uv=si.uv, d=d,
                    dist=jnp.where(si.valid, si.t, 1.0),
                    pdf=jnp.zeros((n,)), delta=jnp.zeros((n,), bool),
                    emitter_idx=si.emitter_idx,
                )
                em_pdf = em_mod.pdf_emitter_direction(em, geo, prev_p, ds_hit)
                em_pdf = jnp.where(prev_delta, 0.0, em_pdf)
                mis_bsdf = mis_weight(prev_pdf, em_pdf)
                e_val = em_mod.emitter_value(
                    em, si.emitter_idx, d, ds_hit.dist, hit_emitter, cfg,
                    wavelengths,
                )
                if not cfg.spectral:
                    e_val = _to_channels(e_val, cfg)
                w = jnp.where(hit_emitter, mis_bsdf, 0.0)
                L = _s_add(
                    L,
                    _s_scale(mu.p_apply(T, (e_val, None, None, None)), w),
                )

                # escaped -> environment (parity with path.py)
                escaped = active & ~si.valid
                if scene.env_emitter >= 0:
                    env_val = em_mod.env_value(
                        em, scene.env_emitter, ray_d, cfg, wavelengths
                    )
                    env_pdf = jnp.where(
                        prev_delta, 0.0, em_mod.escape_pdf(em, ray_d)
                    )
                    mis_env = mis_weight(prev_pdf, env_pdf)
                    w_env = jnp.where(escaped, mis_env, 0.0)
                    L = _s_add(
                        L,
                        _s_scale(
                            mu.p_apply(T, (env_val, None, None, None)), w_env
                        ),
                    )

            active_next = hit & (b + 1 < self.max_depth)

            # ---- NEE ---------------------------------------------------
            if has_emitters:
                u_nee1 = sampler.next_1d(bounce_dim(b, 5))
                u_nee2 = sampler.next_2d(bounce_dim(b, 3))
                mat_flags = scene.materials.flags[jnp.maximum(si.mat_idx, 0)]
                smooth_lane = (mat_flags & BSDFFlags.Smooth) != 0
                nee_active = active_next & smooth_lane
                ds = em_mod.sample_emitter_direction(
                    em, geo, si.p, u_nee1, u_nee2, nee_active
                )
                occ_ray = Ray(
                    o=si.p + si.n * jnp.where(
                        fr.dot(ds.d, si.n) >= 0, mth.RayEpsilon,
                        -mth.RayEpsilon,
                    )[..., None],
                    d=ds.d,
                    maxt=ds.dist * (1.0 - mth.ShadowEpsilon),
                )
                occluded = scene.ray_test(occ_ray, coherent=coh0)
                vis = nee_active & ~occluded & (ds.pdf > 0)

                wo_local = si.to_local(ds.d)
                M_local = bsdfs.eval_(
                    scene.materials, jnp.maximum(si.mat_idx, 0), si, wo_local,
                    ctx, cfg, wavelengths,
                )
                bsdf_pdf = bsdfs.pdf(
                    scene.materials, jnp.maximum(si.mat_idx, 0), si, wo_local,
                    ctx, cfg,
                )
                M_world = world_mueller(si, M_local, wo_local)
                mis_em = jnp.where(ds.delta, 1.0, mis_weight(ds.pdf, bsdf_pdf))
                e_val = em_mod.emitter_value(
                    em, ds.emitter_idx, ds.d, ds.dist, vis, cfg, wavelengths
                )
                if not cfg.spectral:
                    e_val = _to_channels(e_val, cfg)
                # associativity: T @ (M @ S) — two matrix-VECTOR applies
                contrib = _s_scale(
                    mu.p_apply(
                        T, mu.p_apply(M_world, (e_val, None, None, None))
                    ),
                    jnp.where(vis, mis_em / jnp.maximum(ds.pdf, 1e-20), 0.0),
                )
                L = _s_add(L, contrib)

            # ---- BSDF sampling ----------------------------------------
            u1 = sampler.next_1d(bounce_dim(b, 0))
            u2 = sampler.next_2d(bounce_dim(b, 1))
            bs, weight, ok = bsdfs.sample(
                scene.materials, jnp.maximum(si.mat_idx, 0), si, u1, u2,
                ctx, cfg, wavelengths,
            )
            W_world = world_mueller(si, weight, bs.wo)
            T_next = mu.p_matmul(T, W_world)
            eta_next = eta * bs.eta
            wo_world = si.to_world(bs.wo)
            new_o = si.p + si.n * jnp.where(
                fr.dot(wo_world, si.n) >= 0, mth.RayEpsilon, -mth.RayEpsilon
            )[..., None]

            thr = jnp.abs(T_next.m00()).max(axis=-1)
            active_next = active_next & ok & (bs.pdf > 0) & (thr > 0)

            # ---- Russian roulette (eta^2-corrected, parity with path.py)
            rr_prob = jnp.minimum(thr * eta_next * eta_next, 0.95)
            rr_active = b + 1 >= self.rr_depth
            u_rr = sampler.next_1d(bounce_dim(b, 6))
            rr_continue = ~rr_active | (u_rr < rr_prob)
            rr_scale = jnp.where(
                rr_active, 1.0 / jnp.maximum(rr_prob, 1e-6), 1.0
            )
            T_next = mu.p_scale(T_next, rr_scale[:, None])
            active_next = active_next & rr_continue

            is_delta = (bs.sampled_type & jnp.uint32(BSDFFlags.Delta)) != 0
            carry = (
                new_o, wo_world, L,
                mu.p_where(active_next, T_next, T),
                jnp.where(active_next, eta_next, eta),
                active_next,
                jnp.where(active_next, bs.pdf, prev_pdf),
                jnp.where(active_next, is_delta, prev_delta),
                jnp.where(active_next[..., None], si.p, prev_p),
            )
            return carry, None

        carry = (ray.o, ray.d, L, T, eta0, active, prev_pdf, prev_delta,
                 prev_p)
        carry, _ = jax.lax.scan(
            body, carry, jnp.arange(self.max_depth, dtype=jnp.uint32)
        )
        return _s_stack(carry[2], n, C)


@dataclasses.dataclass(frozen=True)
class StokesIntegrator:
    """`stokes` / `stokes_fw` AOV wrapper: renders with a polarized inner
    integrator and emits 15 channels [rgb, S0.rgb, S1.rgb, S2.rgb, S3.rgb].

    forward_basis=True reproduces `stokes_fw` (rotate the final Stokes basis
    to the sensor x-axis, stokes_fw.cpp:100-110); False keeps the implicit
    basis of the arriving direction (`stokes`, stokes.cpp).
    """

    inner: Any = None
    forward_basis: bool = True
    n_out_channels: int = 15
    # byte-compatible 16-channel layout [R, G, B, A, S0..S3] — what the
    # reference's polvis consumers assert (16-channel EXR, alpha at ch 3,
    # S0 at 4:7; src/python/python/polvis.py:16)
    compat16: bool = False

    def __post_init__(self):
        if self.inner is None:
            object.__setattr__(self, "inner", PolarizedPathIntegrator())
        if self.compat16:
            object.__setattr__(self, "n_out_channels", 16)

    def sample(self, scene, sampler: Sampler, ray: Ray, wavelengths,
               cfg: RenderConfig):
        pol_cfg = dataclasses.replace(cfg, polarized=True)
        S = self.inner.sample_stokes(scene, sampler, ray, wavelengths, pol_cfg)

        collapsed = (
            isinstance(self.inner, PolarizedPathIntegrator)
            and depolarizer_collapse_ok(scene)
        )
        if self.forward_basis and not collapsed:
            # (collapsed scenes skip the rotation: rotators fix (s,0,0,0))
            # rotate basis: current = stokes_basis(-ray.d); target = the
            # sensor's horizontal axis projected perpendicular to -d
            forward = -ray.d
            cur = mu.stokes_basis(forward)
            x_axis = scene.sensor.to_world[:3, 0]
            tgt = x_axis[None, :] - forward * fr.dot(
                x_axis[None, :], forward
            )[..., None]
            tgt_len = fr.norm(tgt, keepdims=True)
            degenerate = tgt_len[..., 0] < 1e-6
            tgt = jnp.where(
                degenerate[..., None], cur, tgt / jnp.maximum(tgt_len, 1e-12)
            )
            # planar rotator apply (the rotator has 5 live entries; an
            # einsum would contract all 16)
            R = mu.p_rotate_stokes_basis(forward, cur, tgt)
            s4 = mu.p_apply(R, (S[:, 0], S[:, 1], S[:, 2], S[:, 3]))
            S = _s_stack(s4, S.shape[0], S.shape[-1])

        rgb = S[:, 0, :]
        n = ray.o.shape[0]
        if self.compat16:
            alpha = jnp.ones((n, 1), jnp.float32)
            out = jnp.concatenate(
                [rgb, alpha, S.reshape(n, 4 * S.shape[-1])], axis=-1
            )
        else:
            out = jnp.concatenate(
                [rgb, S.reshape(n, 4 * S.shape[-1])], axis=-1
            )
        return out, jnp.ones((n,), bool)
