"""Path tracer with NEE + MIS — the lax.scan bounce megakernel.

Functional twin of the reference `path` plugin (src/integrators/path.cpp:158-246
dr::while_loop formulation): detached sampling, power-heuristic MIS between
BSDF sampling and emitter sampling, Russian roulette after rr_depth.

Unpolarized transport ([N, C] throughput); the polarized Stokes/Mueller
variant lives in stokes.py which wraps this module's polarized sibling.
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
from ..librender.bsdf import BSDFContext, BSDFFlags
from ..librender.records import Ray, spawn_ray, DirectionSample
from ..scene import emitters as em_mod
from .common import mis_weight


@dataclasses.dataclass(frozen=True)
class PathIntegrator:
    max_depth: int = 6
    rr_depth: int = 5
    hide_emitters: bool = False

    def sample(self, scene, sampler: Sampler, ray: Ray, wavelengths, cfg: RenderConfig):
        """Returns (L [N, C], valid [N])."""
        if cfg.polarized:
            # polarized variants transparently switch to Mueller transport
            # (the reference's polarized Spectrum type does this at compile
            # time); the film records S0, as its develop step does
            from .stokes import PolarizedPathIntegrator

            L_s = PolarizedPathIntegrator(
                max_depth=self.max_depth, rr_depth=self.rr_depth
            ).sample_stokes(scene, sampler, ray, wavelengths, cfg)
            return L_s[:, 0], jnp.ones((ray.o.shape[0],), bool)
        n = ray.o.shape[0]
        C = cfg.n_channels

        L = jnp.zeros((n, C), jnp.float32)
        beta = jnp.ones((n, C), jnp.float32)
        eta = jnp.ones((n,), jnp.float32)
        active = jnp.ones((n,), bool)
        prev_pdf = jnp.ones((n,), jnp.float32)
        prev_delta = jnp.ones((n,), bool)  # depth 0 counts as "delta" (no MIS)
        prev_p = ray.o

        def body(carry, b, coherent=False):
            carry, active_next = self._bounce_step(
                scene, sampler, cfg, wavelengths, carry, b,
                coherent=coherent,
            )
            (new_o, wo_world, L, beta, eta, _, prev_pdf, prev_delta,
             prev_p) = carry
            # dead lanes get ONE canonical far-away ray: their next
            # intersect exits at the root box instead of walking the BVH
            # with garbage directions (and the coherence sort clusters
            # them into all-dead tiles). Results on dead lanes are masked
            # everywhere, so this is output-identical.
            dead = ~active_next
            new_o = jnp.where(dead[..., None], 1e8, new_o)
            wo_world = jnp.where(
                dead[..., None],
                jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
                wo_world,
            )
            carry = (new_o, wo_world, L, beta, eta, active_next, prev_pdf,
                     prev_delta, prev_p)
            return carry, None

        carry = (ray.o, ray.d, L, beta, eta, active, prev_pdf, prev_delta, prev_p)
        # bounce 0 is not peeled out of the scan: one routing serves every
        # bounce, and a peeled copy of the body would double compile time
        carry, _ = jax.lax.scan(
            body, carry, jnp.arange(self.max_depth, dtype=jnp.uint32)
        )
        L = carry[2]
        return L, jnp.ones((n,), bool)

    # ------------------------------------------------------------------
    def _bounce_step(self, scene, sampler: Sampler, cfg: RenderConfig,
                     wavelengths, carry, b, coherent: bool = False):
        """One path-tracing bounce over the whole wavefront.

        `b` (the current depth) may be a traced scalar (the lax.scan
        megakernel) or a per-lane u32 vector (the regenerative wavefront,
        sample_regen) — every use is elementwise. `coherent` (static) marks
        the peeled camera bounce for intersection-kernel routing. Returns
        (carry, active_next) where carry holds the NEXT ray; the caller
        decides what dead lanes do (canonical far ray vs camera
        regeneration).
        """
        n = carry[0].shape[0]
        C = cfg.n_channels
        em = scene.emitters
        geo = scene.geo
        has_emitters = em.count > 0
        ctx = BSDFContext()
        (ray_o, ray_d, L, beta, eta, active, prev_pdf, prev_delta, prev_p) = carry

        # bounce-0 ray sets (camera rays, and their shadow rays) are
        # tile-coherent: route them to the clu2 treelet kernel via a traced
        # predicate (lax.cond in scene.ray_intersect). Vector depths (the
        # regen wavefront) mix fresh and bounce lanes -> incoherent.
        b_arr = jnp.asarray(b)
        coh0 = (b_arr == 0) if b_arr.ndim == 0 else False

        ray_b = Ray.create(ray_o, ray_d)
        si = scene.ray_intersect(ray_b, coherent=coh0)
        hit = si.valid & active

        # ---- emitter hit (and environment) with MIS ----------------
        if has_emitters:
            hit_emitter = hit & (si.emitter_idx >= 0) & (
                fr.cos_theta(si.wi) > 0
            )
            # d/dist from the ray itself: equal to the p-difference form
            # for hits, and finite (gradient-safe) on miss lanes
            ds_hit = DirectionSample(
                p=si.p, n=si.n, uv=si.uv,
                d=ray_d,
                dist=jnp.where(si.valid, si.t, 1.0),
                pdf=jnp.zeros((n,)), delta=jnp.zeros((n,), bool),
                emitter_idx=si.emitter_idx,
            )
            em_pdf = em_mod.pdf_emitter_direction(em, geo, prev_p, ds_hit)
            em_pdf = jnp.where(prev_delta, 0.0, em_pdf)
            mis_bsdf = mis_weight(prev_pdf, em_pdf)
            e_val = em_mod.emitter_value(
                em, si.emitter_idx, ds_hit.d, ds_hit.dist, hit_emitter,
                cfg, wavelengths,
            )
            if not cfg.spectral:
                e_val = _to_channels(e_val, cfg)
            L = L + beta * e_val * jnp.where(hit_emitter, mis_bsdf, 0.0)[..., None]

            # escaped -> environment
            escaped = active & ~si.valid
            if scene.env_emitter >= 0:
                env_val = em_mod.env_value(
                    em, scene.env_emitter, ray_d, cfg, wavelengths
                )
                # MIS vs the environment emitter's NEE pdf
                env_pdf = jnp.where(
                    prev_delta, 0.0, em_mod.escape_pdf(em, ray_d)
                )
                mis_env = mis_weight(prev_pdf, env_pdf)
                L = L + beta * env_val * jnp.where(escaped, mis_env, 0.0)[..., None]

        active_next = hit & (b + 1 < self.max_depth)

        # ---- NEE ------------------------------------------------------
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
                o=jnp.where(
                    nee_active[..., None],
                    si.p + si.n * jnp.where(
                        fr.dot(ds.d, si.n) >= 0,
                        mth.RayEpsilon, -mth.RayEpsilon
                    )[..., None],
                    1e8,  # canonical dead shadow ray (see carry note)
                ),
                d=ds.d,
                maxt=jnp.where(
                    nee_active, ds.dist * (1.0 - mth.ShadowEpsilon), 0.0
                ),
            )
            occluded = scene.ray_test(occ_ray, coherent=coh0)
            vis = nee_active & ~occluded & (ds.pdf > 0)

            wo_local = si.to_local(ds.d)
            bsdf_val, bsdf_pdf = bsdfs.eval_pdf(
                scene.materials, jnp.maximum(si.mat_idx, 0), si, wo_local,
                ctx, cfg, wavelengths,
            )
            mis_em = jnp.where(ds.delta, 1.0, mis_weight(ds.pdf, bsdf_pdf))
            e_val = em_mod.emitter_value(
                em, ds.emitter_idx, ds.d, ds.dist, vis, cfg, wavelengths
            )
            if not cfg.spectral:
                e_val = _to_channels(e_val, cfg)
            contrib = beta * bsdf_val * e_val * (
                mis_em / jnp.maximum(ds.pdf, 1e-20)
            )[..., None]
            L = L + jnp.where(vis[..., None], contrib, 0.0)

        # ---- BSDF sampling ---------------------------------------------
        u1 = sampler.next_1d(bounce_dim(b, 0))
        u2 = sampler.next_2d(bounce_dim(b, 1))
        bs, weight, ok = bsdfs.sample(
            scene.materials, jnp.maximum(si.mat_idx, 0), si, u1, u2,
            ctx, cfg, wavelengths,
        )
        beta_next = beta * weight
        eta_next = eta * bs.eta
        wo_world = si.to_world(bs.wo)
        new_o = si.p + si.n * jnp.where(
            fr.dot(wo_world, si.n) >= 0, mth.RayEpsilon, -mth.RayEpsilon
        )[..., None]

        active_next = active_next & ok & (bs.pdf > 0) & (
            jnp.max(beta_next, axis=-1) > 0
        )

        # ---- Russian roulette ------------------------------------------
        beta_max = jnp.max(beta_next, axis=-1) * eta_next * eta_next
        rr_prob = jnp.minimum(beta_max, 0.95)
        rr_active = b + 1 >= self.rr_depth
        u_rr = sampler.next_1d(bounce_dim(b, 6))
        rr_continue = ~rr_active | (u_rr < rr_prob)
        rr_scale = jnp.where(
            rr_active, 1.0 / jnp.maximum(rr_prob, 1e-6), 1.0
        )
        beta_next = beta_next * jnp.where(rr_active, rr_scale, 1.0)[..., None]
        active_next = active_next & rr_continue

        is_delta = (bs.sampled_type & jnp.uint32(BSDFFlags.Delta)) != 0

        carry = (
            new_o, wo_world,
            L,
            jnp.where(active_next[..., None], beta_next, beta),
            jnp.where(active_next, eta_next, eta),
            active_next,
            jnp.where(active_next, bs.pdf, prev_pdf),
            jnp.where(active_next, is_delta, prev_delta),
            jnp.where(active_next[..., None], ray_o * 0 + si.p, prev_p),
        )
        return carry, active_next

    # ------------------------------------------------------------------
    def sample_regen(self, scene, seed, width, height, spp_pass,
                     cfg: RenderConfig, n_lanes: int,
                     sampler_type: str = "independent",
                     pixel_order: str = "scanline"):
        """Regenerative (persistent-lanes) wavefront, the reference's
        megakernel-with-respawn strategy reshaped for XLA: a lax.while_loop
        keeps N lanes saturated by restarting each finished path on the
        lane's NEXT strided camera sample instead of idling until the whole
        scan retires (the fixed-depth scan wastes (max_depth - E[len]) /
        max_depth of all bounce work in open scenes — ~60% on the gratings
        and mesh scenes).

        Lane i processes sample ids i, i+N, ..., i+(Q-1)N; every random
        number is the same pure hash of (seed, sample id, dim) the scan
        megakernel uses, so per-sample radiance is IDENTICAL — regeneration
        changes scheduling, not the estimator. Returns values
        [width*height*spp_pass, C] in sample-id order (pixel-major, ready
        for ImageBlock.put_ordered). Primal-only: the while_loop is not
        reverse-differentiable; AD renders keep the scan path.
        """
        from .common import camera_rays_at

        if cfg.polarized:
            raise NotImplementedError("regen wavefront is unpolarized-only")
        total = width * height * spp_pass
        N = int(n_lanes)
        Q = -(-total // N)
        C = cfg.n_channels
        seed = jnp.asarray(seed, jnp.uint32)

        def fresh(sid):
            ray, _uv, wl, _wlw = camera_rays_at(
                scene, seed, sid, width, height, spp_pass, cfg,
                sampler_type=sampler_type, pixel_order=pixel_order,
            )
            return ray, wl

        sid0 = jnp.arange(N, dtype=jnp.uint32)
        ray0, wl0 = fresh(sid0)
        wl_c0 = wl0 if cfg.spectral else jnp.zeros((N, 1), jnp.float32)
        bcarry0 = (
            ray0.o, ray0.d,
            jnp.zeros((N, C), jnp.float32),   # L
            jnp.ones((N, C), jnp.float32),    # beta
            jnp.ones((N,), jnp.float32),      # eta
            jnp.ones((N,), bool),             # active
            jnp.ones((N,), jnp.float32),      # prev_pdf
            jnp.ones((N,), bool),             # prev_delta
            ray0.o,                           # prev_p
        )
        state0 = (
            sid0,
            jnp.zeros((N,), jnp.uint32),      # depth
            jnp.zeros((Q, N, C), jnp.float32),  # banked samples out[q, lane]
            wl_c0,
            bcarry0,
        )
        # respawn gate: only onto REAL sample ids (< total, not Q*N) — lanes
        # past the padded tail would trace full paths through out-of-film
        # camera rays whose results the [:total] trim discards
        limit = jnp.uint32(total)
        far = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)

        def cond(state):
            return jnp.any(state[4][5])

        def body(state):
            sid, depth, out, wl_c, bcarry = state
            sampler = Sampler(seed=seed, lane=sid)
            was_active = bcarry[5]
            bcarry, active_next = self._bounce_step(
                scene, sampler, cfg,
                wl_c if cfg.spectral else None, bcarry, depth,
            )
            (new_o, wo_world, L, beta, eta, _, prev_pdf, prev_delta,
             prev_p) = bcarry
            finished = was_active & ~active_next

            # bank finished samples: out[q, lane] += L via a one-hot over
            # the stride index — a fused [Q, N, C] vector op (no scatter)
            q = (sid // jnp.uint32(N)).astype(jnp.int32)
            onehot = (
                jax.lax.broadcasted_iota(jnp.int32, (Q, N), 0) == q[None, :]
            ) & finished[None, :]
            out = out + jnp.where(onehot[..., None], L[None, :, :], 0.0)

            # regenerate finished lanes on their next strided sample id
            more = finished & (sid + jnp.uint32(N) < limit)
            sid = jnp.where(more, sid + jnp.uint32(N), sid)
            depth = jnp.where(more, jnp.uint32(0), depth + jnp.uint32(1))
            ray_f, wl_f = fresh(sid)
            alive = active_next | more
            m3 = more[..., None]
            dead3 = (~alive)[..., None]
            # dead lanes get ONE canonical far-away ray (see sample())
            o_n = jnp.where(dead3, 1e8, jnp.where(m3, ray_f.o, new_o))
            d_n = jnp.where(dead3, far, jnp.where(m3, ray_f.d, wo_world))
            bcarry = (
                o_n, d_n,
                jnp.where(m3, 0.0, L),
                jnp.where(m3, 1.0, beta),
                jnp.where(more, 1.0, eta),
                alive,
                jnp.where(more, 1.0, prev_pdf),
                more | prev_delta,  # regen lanes restart as "delta" (no MIS)
                jnp.where(m3, ray_f.o, prev_p),
            )
            if cfg.spectral:
                wl_c = jnp.where(m3, wl_f, wl_c)
            return (sid, depth, out, wl_c, bcarry)

        state = jax.lax.while_loop(cond, body, state0)
        out = state[2]
        return out.reshape(Q * N, C)[:total]


def _to_channels(rgb, cfg: RenderConfig):
    """Adapt an RGB emitter value to the configured channel count.

    Spectral mode: treat stored RGB radiance as a smooth spectrum via
    luminance (proper spectral emitter curves arrive with the spectra module).
    Mono mode: Rec.709 luminance channel.
    """
    if cfg.spectral:
        from ..core import spectrum as spec

        return jnp.broadcast_to(
            spec.luminance_rgb(rgb)[..., None], (*rgb.shape[:-1], cfg.n_channels)
        )
    if cfg.mono:
        from ..core import spectrum as spec

        return spec.luminance_rgb(rgb)[..., None]
    return rgb
