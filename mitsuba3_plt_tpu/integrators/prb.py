"""Path-Replay Backpropagation (PRB) — array formulation.

Functional twin of the reference's prb plugin
(src/python/python/ad/integrators/prb.py:64-251). The reference needs a
hand-written two-pass adjoint because Dr.Jit cannot tape its recorded
loops; in JAX we express the SAME estimator as a single forward value
whose autodiff gradient *is* the PRB gradient:

  phase 1 (detached walk, prb.py's sample(mode=Primal)): trace the path
  with `stop_gradient(scene)`, recording a per-bounce buffer (the path
  replay state: interaction, sampled wo, pdfs, MIS weights, RR scale,
  NEE record);

  phase 2 (attached re-eval, prb.py:200-248's Lr_ind trick): ONE batched
  re-evaluation over all [D x N] bounces (no loop):

    L_prb = sum_i beta_i * (Le_i(theta) * mis + f_i(theta) * E_i(theta) * k)
          + sum_i beta_i * (w_i(theta) - stop_grad(w_i(theta))) * S_{i+1}

  with beta_i the DETACHED throughput prefix, S_{i+1} the DETACHED suffix
  radiance (reverse scan over the recorded contributions), and w_i(theta)
  = f(si_i, wo_i)/pdf_det — detached-sampling semantics exactly as the
  reference (sampling decisions never differentiated). The second sum is
  zero-valued and carries the indirect-illumination gradient; the value of
  L_prb equals the detached path tracer's L bit-for-bit.

  Differences from naive remat AD (ad/render.py): O(D*N) replay buffer
  instead of rematerializing the sampling logic in the backward pass, no
  gradient flow through intersection positions (geometry silhouette terms
  are the projective integrator's job), and detached sampling pdfs.
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
from ..librender.records import Ray, DirectionSample, SurfaceInteraction
from ..scene import emitters as em_mod
from .common import mis_weight
from .path import _to_channels

sg = jax.lax.stop_gradient


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PRBBounce:
    """Per-bounce replay record (stacked [D, N, ...] by the recording scan)."""

    # interaction (detached)
    valid: Any
    p: Any
    n: Any
    sh_s: Any
    sh_t: Any
    sh_n: Any
    uv: Any
    wi: Any
    t: Any
    mat_idx: Any
    emitter_idx: Any
    active: Any            # lane was alive at this bounce
    # emitter-hit term
    eh_mask: Any           # [N] emitter hit counted at this bounce
    eh_d: Any              # [N, 3] direction into the emitter
    eh_dist: Any
    eh_mis: Any            # [N] detached MIS weight
    esc_mask: Any          # [N] escaped to the environment at this bounce
    esc_d: Any             # [N, 3] escape direction
    esc_mis: Any
    # NEE term
    nee_vis: Any           # [N]
    nee_d: Any             # [N, 3]
    nee_dist: Any
    nee_emitter: Any       # [N]
    nee_k: Any             # [N] detached mis/pdf scalar
    # BSDF sampling
    wo: Any                # [N, 3] sampled local direction
    w_det: Any             # [N, C] detached weight incl. RR scale
    pdf_rr: Any            # [N] detached pdf / rr normalization: w_att = f/pdf_rr
    is_delta: Any          # [N] sampled lobe is delta (no eval-based grad)

    def si(self) -> SurfaceInteraction:
        return SurfaceInteraction(
            valid=self.valid, t=self.t, p=self.p, n=self.n,
            sh_s=self.sh_s, sh_t=self.sh_t, sh_n=self.sh_n, uv=self.uv,
            wi=self.wi, prim_idx=jnp.zeros_like(self.mat_idx),
            mat_idx=self.mat_idx, emitter_idx=self.emitter_idx,
            shape_idx=jnp.zeros_like(self.mat_idx),
        )


@dataclasses.dataclass(frozen=True)
class PRBIntegrator:
    """Drop-in integrator whose `sample` is PRB-differentiable."""

    max_depth: int = 6
    rr_depth: int = 5
    max_wavefront: int = 1 << 20

    # ------------------------------------------------------------------
    def _record(self, scene_d, sampler, ray, wavelengths, cfg):
        """Detached recording walk (phase 1). scene_d must be detached."""
        n = ray.o.shape[0]
        C = cfg.n_channels
        em = scene_d.emitters
        geo = scene_d.geo
        has_emitters = em.count > 0
        ctx = BSDFContext()

        def body(carry, b, coherent=False):
            ray_o, ray_d, active, prev_pdf, prev_delta, prev_p = carry
            b_arr = jnp.asarray(b)
            coh0 = (b_arr == 0) if b_arr.ndim == 0 else False
            ray_b = Ray.create(ray_o, ray_d)
            si = scene_d.ray_intersect(ray_b, coherent=coh0)
            hit = si.valid & active

            eh_mask = jnp.zeros((n,), bool)
            eh_mis = jnp.zeros((n,), jnp.float32)
            esc_mask = jnp.zeros((n,), bool)
            esc_mis = jnp.zeros((n,), jnp.float32)
            if has_emitters:
                eh_mask = hit & (si.emitter_idx >= 0) & (fr.cos_theta(si.wi) > 0)
                ds_hit = DirectionSample(
                    p=si.p, n=si.n, uv=si.uv, d=ray_d,
                    dist=jnp.where(si.valid, si.t, 1.0),
                    pdf=jnp.zeros((n,)), delta=jnp.zeros((n,), bool),
                    emitter_idx=si.emitter_idx,
                )
                em_pdf = em_mod.pdf_emitter_direction(em, geo, prev_p, ds_hit)
                em_pdf = jnp.where(prev_delta, 0.0, em_pdf)
                eh_mis = mis_weight(prev_pdf, em_pdf)
                esc_mask = active & ~si.valid
                if scene_d.env_emitter >= 0:
                    env_pdf = jnp.where(
                        prev_delta, 0.0, em_mod.escape_pdf(em, ray_d)
                    )
                    esc_mis = mis_weight(prev_pdf, env_pdf)
                else:
                    esc_mask = jnp.zeros((n,), bool)

            active_next = hit & (b + 1 < self.max_depth)

            # NEE record
            nee_vis = jnp.zeros((n,), bool)
            nee_d = jnp.zeros((n, 3), jnp.float32)
            nee_dist = jnp.ones((n,), jnp.float32)
            nee_emitter = jnp.zeros((n,), jnp.int32)
            nee_k = jnp.zeros((n,), jnp.float32)
            if has_emitters:
                u_nee1 = sampler.next_1d(bounce_dim(b, 5))
                u_nee2 = sampler.next_2d(bounce_dim(b, 3))
                mat_flags = scene_d.materials.flags[jnp.maximum(si.mat_idx, 0)]
                smooth_lane = (mat_flags & BSDFFlags.Smooth) != 0
                nee_active = active_next & smooth_lane
                ds = em_mod.sample_emitter_direction(
                    em, geo, si.p, u_nee1, u_nee2, nee_active
                )
                occ_ray = Ray(
                    o=si.p + si.n * jnp.where(
                        fr.dot(ds.d, si.n) >= 0, mth.RayEpsilon,
                        -mth.RayEpsilon
                    )[..., None],
                    d=ds.d,
                    maxt=ds.dist * (1.0 - mth.ShadowEpsilon),
                )
                occluded = scene_d.ray_test(occ_ray)
                nee_vis = nee_active & ~occluded & (ds.pdf > 0)
                wo_nee = si.to_local(ds.d)
                _, bsdf_pdf = bsdfs.eval_pdf(
                    scene_d.materials, jnp.maximum(si.mat_idx, 0), si, wo_nee,
                    ctx, cfg, wavelengths,
                )
                mis_em = jnp.where(ds.delta, 1.0, mis_weight(ds.pdf, bsdf_pdf))
                nee_d, nee_dist = ds.d, ds.dist
                nee_emitter = ds.emitter_idx
                nee_k = jnp.where(
                    nee_vis, mis_em / jnp.maximum(ds.pdf, 1e-20), 0.0
                )

            # BSDF sampling
            u1 = sampler.next_1d(bounce_dim(b, 0))
            u2 = sampler.next_2d(bounce_dim(b, 1))
            bs, weight, ok = bsdfs.sample(
                scene_d.materials, jnp.maximum(si.mat_idx, 0), si, u1, u2,
                ctx, cfg, wavelengths,
            )
            wo_world = si.to_world(bs.wo)
            new_o = si.p + si.n * jnp.where(
                fr.dot(wo_world, si.n) >= 0, mth.RayEpsilon, -mth.RayEpsilon
            )[..., None]
            active_next = active_next & ok & (bs.pdf > 0) & (
                jnp.max(weight, axis=-1) > 0
            )

            # Russian roulette (weights folded into w_det and pdf_rr)
            w_max = jnp.max(weight, axis=-1)
            rr_prob = jnp.minimum(w_max, 0.95)
            rr_active = b + 1 >= self.rr_depth
            u_rr = sampler.next_1d(bounce_dim(b, 6))
            rr_continue = ~rr_active | (u_rr < rr_prob)
            rr_scale = jnp.where(rr_active, 1.0 / jnp.maximum(rr_prob, 1e-6), 1.0)
            w_det = weight * rr_scale[..., None]
            active_next = active_next & rr_continue

            is_delta = (bs.sampled_type & jnp.uint32(BSDFFlags.Delta)) != 0
            # attached re-eval normalization: w_att = f(si, wo) cos / pdf_rr
            pdf_rr = bs.pdf / rr_scale

            bounce = PRBBounce(
                valid=si.valid, p=si.p, n=si.n, sh_s=si.sh_s, sh_t=si.sh_t,
                sh_n=si.sh_n, uv=si.uv, wi=si.wi, t=si.t,
                mat_idx=si.mat_idx, emitter_idx=si.emitter_idx,
                active=active & (si.valid | esc_mask),
                eh_mask=eh_mask, eh_d=ray_d,
                eh_dist=jnp.where(si.valid, si.t, 1.0), eh_mis=eh_mis,
                esc_mask=esc_mask, esc_d=ray_d, esc_mis=esc_mis,
                nee_vis=nee_vis, nee_d=nee_d, nee_dist=nee_dist,
                nee_emitter=nee_emitter, nee_k=nee_k,
                wo=bs.wo, w_det=w_det, pdf_rr=pdf_rr,
                is_delta=is_delta,
            )
            carry = (
                new_o, wo_world, active_next,
                jnp.where(active_next, bs.pdf, prev_pdf),
                jnp.where(active_next, is_delta, prev_delta),
                jnp.where(active_next[..., None], si.p, prev_p),
            )
            return carry, bounce

        carry0 = (
            ray.o, ray.d, jnp.ones((n,), bool), jnp.ones((n,), jnp.float32),
            jnp.ones((n,), bool), ray.o,
        )
        _, bounces = jax.lax.scan(
            body, carry0, jnp.arange(self.max_depth, dtype=jnp.uint32)
        )
        return bounces

    # ------------------------------------------------------------------
    def sample(self, scene, sampler: Sampler, ray: Ray, wavelengths,
               cfg: RenderConfig):
        """(L [N, C], valid [N]); jax.grad of this IS the PRB gradient."""
        if cfg.polarized:
            # PRB differentiates the S0 radiance; the reference's prb is
            # likewise an intensity-loss gradient estimator. Run the
            # scalar formulation (exact S0 for S0-separable scenes; the
            # polarized PRIMAL image, when needed, comes from the
            # StokesIntegrator whose transport is fully Mueller).
            import dataclasses as _dc

            return self.sample(
                scene, sampler, ray, wavelengths,
                _dc.replace(cfg, polarized=False),
            )
        n = ray.o.shape[0]
        C = cfg.n_channels
        ctx = BSDFContext()
        D = self.max_depth

        scene_d = sg(scene)
        wl_d = sg(wavelengths) if wavelengths is not None else None
        bounces = self._record(scene_d, sampler, ray, wl_d, cfg)

        # ---- phase 2: one batched attached re-eval over [D*N] ------------
        em = scene.emitters  # ATTACHED emitter table
        flat = jax.tree.map(lambda x: x.reshape((D * n,) + x.shape[2:]), bounces)
        si_f = flat.si()
        wl_f = (
            jnp.tile(wavelengths, (D, 1))
            if wavelengths is not None else None
        )
        mat_attached = scene.materials

        # emitter-hit radiance, attached through emitter params
        le_att = em_mod.emitter_value(
            em, flat.emitter_idx, flat.eh_d, flat.eh_dist, flat.eh_mask, cfg,
            wl_f,
        )
        if not cfg.spectral:
            le_att = _to_channels(le_att, cfg)
        ce_att = jnp.where(
            flat.eh_mask[..., None], le_att * flat.eh_mis[..., None], 0.0
        )
        if scene.env_emitter >= 0:
            env_att = _to_channels(em_mod.eval_env(em, flat.esc_d), cfg)
            ce_att = ce_att + jnp.where(
                flat.esc_mask[..., None], env_att * flat.esc_mis[..., None], 0.0
            )

        # NEE: attached BSDF eval x attached emitter value x detached kernel
        wo_nee_f = si_f.to_local(flat.nee_d)
        f_att, _ = bsdfs.eval_pdf(
            mat_attached, jnp.maximum(si_f.mat_idx, 0), si_f, wo_nee_f, ctx,
            cfg, wl_f,
        )
        e_att = em_mod.emitter_value(
            em, flat.nee_emitter, flat.nee_d, flat.nee_dist, flat.nee_vis,
            cfg, wl_f,
        )
        if not cfg.spectral:
            e_att = _to_channels(e_att, cfg)
        cn_att = jnp.where(
            flat.nee_vis[..., None], f_att * e_att * flat.nee_k[..., None], 0.0
        )

        # attached replay weight: f(theta) / detached pdf (delta lobes keep
        # the detached weight — eval() is zero there, like reference PRB)
        f_wo, _ = bsdfs.eval_pdf(
            mat_attached, jnp.maximum(si_f.mat_idx, 0), si_f, flat.wo, ctx,
            cfg, wl_f,
        )
        w_att = f_wo / jnp.maximum(flat.pdf_rr, 1e-20)[..., None]
        # delta lobes (eval = 0 there), dead lanes, and misses keep the
        # detached weight — also keeps re-eval NaNs at garbage interactions
        # out of the zero-valued gradient term
        w_att = jnp.where(
            (flat.is_delta | ~flat.active | ~flat.valid)[..., None],
            flat.w_det, w_att,
        )

        D_shape = (D, n, C)
        ce = ce_att.reshape(D_shape)
        cn = cn_att.reshape(D_shape)
        w_att = w_att.reshape(D_shape)
        w_det = sg(bounces.w_det)
        w_det_g = jnp.where(bounces.active[..., None], w_det, 1.0)

        # detached throughput prefixes beta_i = prod_{j<i} w_j
        cum = jnp.cumprod(w_det_g, axis=0)
        beta = jnp.concatenate(
            [jnp.ones((1, n, C), jnp.float32), cum[:-1]], axis=0
        )

        # detached suffix radiance S_i = ce_i + cn_i + w_i * S_{i+1}
        def suffix_body(s_next, xs):
            ce_i, cn_i, w_i = xs
            s_i = ce_i + cn_i + w_i * s_next
            return s_i, s_i

        _, S = jax.lax.scan(
            suffix_body, jnp.zeros((n, C)),
            (sg(ce), sg(cn), w_det_g), reverse=True,
        )
        S_next = jnp.concatenate([S[1:], jnp.zeros((1, n, C))], axis=0)

        L = jnp.sum(
            beta * (ce + cn + (w_att - sg(w_att)) * S_next), axis=0
        )
        return L, jnp.ones((n,), bool)
