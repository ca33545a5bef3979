"""PLT integrator: two-phase sample-solve wave transport.

Functional twin of the fork's centerpiece (scripts/rendering/integrators/
plt.py:13-531), restructured for XLA:

Phase 1 (`sample_phase`, reference plt.py:50-171): backward path from the
sensor under lax.scan; each bounce records a BounceData slice — the bounce
buffer is the stacked scan output [D, N, ...] instead of dr.alloc_local.

Phase 2 (`solve_phase`, reference plt.py:174-218): for every prefix length i,
add (a) the emissive-hit replay with MIS vs the last non-delta pdf
(plt.py:315-405) and (b) an NEE replay with wbsdf MIS (plt.py:221-300).

Restructuring of the O(depth^2) replay: the reference's
`replay_path` weight product prod_{j<i} wbsdf_weight(bounce_j)
(plt.py:408-472) does not depend on the prefix index i (coherence opl is
propagated but the replay weights are coherence-independent, exactly as in
the reference where wbsdf_weight never reads sd.coherence), so all prefix
products are ONE exclusive cumulative product along the depth axis — O(D)
instead of O(D^2) wbsdf evaluations.

Deviations from the reference (documented intent over replicated quirks):
  * sampling wavelengths: lam = u*(CIE_MAX-150-CIE_MIN)+CIE_MIN — the C++
    intent (roughgrating.cpp:504-505); the fork's Python drops the +CIE_MIN
    offset (plt.py:65, a bug).
  * Russian-roulette compensation: the prefix weight includes the recorded
    1/p_rr survival correction (the reference stores rr_thp in BounceData
    but its replay never applies it — plt.py:464 variant A).
  * NEE shadow rays are traced (scene.sample_emitter_direction(test
    visibility), as sample_emitter_direction does in C++).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..core import frame as fr
from ..core import math as mth
from ..core.rng import Sampler, bounce_dim, DIM_WAVELENGTH
from ..librender import bsdfs
from ..librender import mueller as mu
from ..librender.bsdf import BSDFContext, BSDFFlags
from ..librender.records import Ray, DirectionSample
from ..plt import wbsdf as wb
from ..plt.coherence import Coherence, GeneralizedRadiance
from ..scene import emitters as em_mod
from .common import mis_weight
from .path import _to_channels
from .stokes import _unpol_stokes, _s_add, _s_scale, _s_stack


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BounceData:
    """Per-bounce record (reference include/mitsuba/plt/bouncebuffer.h:21-95),
    stacked [D, N, ...] by the sample-phase scan."""

    valid: Any          # [N] hit a surface
    t: Any              # [N] hit distance (coherence propagation)
    p: Any              # [N, 3]
    n: Any              # [N, 3] geometric normal
    # shading-frame tangents are None for scenes without mesh tangents
    # (the frame is then the deterministic coordinate_system(sh_n) and is
    # recomputed at replay — 24 B/lane/bounce less buffer traffic)
    sh_s: Any           # [N, 3] or None
    sh_t: Any           # [N, 3] or None
    sh_n: Any
    uv: Any             # [N, 2]
    wi: Any             # [N, 3] local incident dir
    mat_idx: Any        # [N]
    emitter_idx: Any    # [N]
    wo: Any             # [N, 3] local sampled outgoing dir
    bsdf_flags: Any     # [N] u32 sampled lobe flags
    rr_rcp: Any         # [N] reciprocal RR survival probability (1 if none)
    bsdf_weight: Any    # [N, C] wbsdf_sample weight (debug replay variant B)
    is_emitter: Any     # [N]
    last_nd_pdf: Any    # [N] last non-delta pdf before this bounce
    lobe: Any           # [N, 2] sampled diffraction lobe
    active: Any         # [N] lane recorded a real bounce

    def si(self):
        """Reconstruct the SurfaceInteraction view of this bounce."""
        from ..librender.records import SurfaceInteraction

        sh_s, sh_t = self.sh_s, self.sh_t
        if sh_s is None:
            from ..core import frame as _fr

            sh_s, sh_t = _fr.coordinate_system(self.sh_n)
        return SurfaceInteraction(
            valid=self.valid, t=self.t, p=self.p, n=self.n,
            sh_s=sh_s, sh_t=sh_t, sh_n=self.sh_n, uv=self.uv,
            wi=self.wi, prim_idx=jnp.zeros_like(self.mat_idx),
            mat_idx=self.mat_idx, emitter_idx=self.emitter_idx,
            shape_idx=jnp.zeros_like(self.mat_idx),
        )


@dataclasses.dataclass(frozen=True)
class PLTIntegrator:
    max_depth: int = 8
    rr_depth: int = 4
    # the stacked [max_depth, N] bounce buffer dominates memory: cap the
    # wavefront so buffer + solve temporaries stay bounded (the right
    # size on the H100 is ROADMAP S4)
    max_wavefront: int = 1 << 21
    emissive_sourcing_area: float = 1e-4
    distant_sourcing_area: float = 1e-7
    max_angular_spread: float = 1e-7

    # ------------------------------------------------------------------
    def sample_phase(self, scene, sampler: Sampler, ray: Ray, cfg: RenderConfig,
                     wavelengths=None):
        """Backward walk recording the bounce buffer (plt.py:50-171).

        wavelengths: optional externally-sampled hero wavelengths [N, C]
        (spectral mode); otherwise PLT samples its own in
        [CIE_MIN, CIE_MAX-150] (reference plt.py:65-70)."""
        n = ray.o.shape[0]
        C = cfg.n_channels
        ctx = BSDFContext()

        if wavelengths is None:
            u_wl = jnp.stack(
                [sampler.next_1d(DIM_WAVELENGTH + i) for i in range(C)],
                axis=-1,
            )
            wavelengths = wb.sample_plt_wavelengths(u_wl, C)

        def body(carry, b, coherent=False):
            ray_o, ray_d, active, last_nd_pdf, prev_delta = carry
            b_arr = jnp.asarray(b)
            coh0 = (b_arr == 0) if b_arr.ndim == 0 else False
            ray_b = Ray.create(ray_o, ray_d)
            si = scene.ray_intersect(ray_b, coherent=coh0)
            hit = si.valid & active

            is_emitter = hit & (si.emitter_idx >= 0)
            active_next = hit & (b + 1 < self.max_depth)

            u1 = sampler.next_1d(bounce_dim(b, 0))
            u2 = sampler.next_2d(bounce_dim(b, 1))
            lobe_u2 = sampler.next_2d(bounce_dim(b, 3))
            sd, weight, ok = wb.wbsdf_sample(
                scene.materials, jnp.maximum(si.mat_idx, 0), si,
                u1, u2, lobe_u2, ctx, cfg, wavelengths,
            )
            bs = sd.bs

            # Russian roulette (plt.py:133-143)
            w_max = jnp.max(
                weight if not cfg.polarized else jnp.broadcast_to(
                    weight.m00(), (n, C)
                ),
                axis=-1,
            )
            rr_prob = jnp.minimum(jnp.maximum(w_max, 0.05), 0.95)
            rr_active = (b + 1) >= self.rr_depth
            u_rr = sampler.next_1d(bounce_dim(b, 6))
            rr_continue = ~rr_active | (u_rr < rr_prob)
            rr_rcp = jnp.where(rr_active, 1.0 / jnp.maximum(rr_prob, 1e-6), 1.0)

            active_next = active_next & ok & (bs.pdf > 0) & rr_continue

            wo_world = si.to_world(bs.wo)
            new_o = si.p + si.n * jnp.where(
                fr.dot(wo_world, si.n) >= 0, mth.RayEpsilon, -mth.RayEpsilon
            )[..., None]

            is_delta = (bs.sampled_type & jnp.uint32(BSDFFlags.Delta)) != 0

            # scenes without mesh tangents have deterministic frames:
            # don't ship them through the bounce buffer
            has_tan_frames = scene.geo.tri_attr.shape[1] >= 40
            bounce = BounceData(
                valid=si.valid, t=si.t, p=si.p, n=si.n,
                sh_s=si.sh_s if has_tan_frames else None,
                sh_t=si.sh_t if has_tan_frames else None,
                sh_n=si.sh_n, uv=si.uv,
                wi=si.wi, mat_idx=si.mat_idx, emitter_idx=si.emitter_idx,
                wo=bs.wo, bsdf_flags=bs.sampled_type, rr_rcp=rr_rcp,
                bsdf_weight=(weight if not cfg.polarized
                             else jnp.broadcast_to(weight.m00(), (n, C))),
                is_emitter=is_emitter, last_nd_pdf=last_nd_pdf,
                lobe=sd.lobe, active=hit,
            )

            nd_pdf_next = jnp.where(is_delta, last_nd_pdf, bs.pdf)
            carry = (
                new_o, wo_world, active_next,
                jnp.where(active_next, nd_pdf_next, last_nd_pdf),
                jnp.where(active_next, is_delta, prev_delta),
            )
            return carry, bounce

        carry0 = (
            ray.o, ray.d, jnp.ones((n,), bool), jnp.ones((n,), jnp.float32),
            jnp.ones((n,), bool),
        )
        _, bounces = jax.lax.scan(
            body, carry0, jnp.arange(self.max_depth, dtype=jnp.uint32)
        )
        return bounces, wavelengths

    # ------------------------------------------------------------------
    def solve_phase(self, scene, sampler: Sampler, bounces: BounceData,
                    wavelengths, cfg: RenderConfig):
        """Forward solve with cumulative-product prefix weights."""
        D = self.max_depth
        n = bounces.valid.shape[1]
        C = cfg.n_channels
        ctx = BSDFContext()
        em = scene.emitters
        geo = scene.geo

        # --- replay weights per bounce: W_j [D, N, C] (or Mueller
        # [D, N, 4, 4, C] under a polarized config) ----------------------
        def weight_at(bounce_j):
            si = bounce_j.si()
            sd = wb.PLTSamplePhaseData(
                bs=None, lobe=bounce_j.lobe,
                internal_frame=jnp.zeros((n, 3), jnp.float32),
                coherence=Coherence.isotropic(
                    jnp.full((n,), 1e-18, jnp.float32),
                    jnp.zeros((n,), jnp.float32),
                ),
                sampling_wavelengths=wavelengths,
            )
            w = wb.wbsdf_weight(
                scene.materials, jnp.maximum(si.mat_idx, 0), si,
                bounce_j.wo, sd, ctx, cfg,
            )
            if cfg.polarized:
                W_w = bsdfs.to_world_mueller(si, w, -bounce_j.wo, si.wi)
                W_w = mu.p_scale(W_w, bounce_j.rr_rcp[..., None])
                eye = mu.MuellerP.identity().materialize(n, C)
                return mu.p_where(bounce_j.active, W_w, eye)
            w = w * bounce_j.rr_rcp[..., None]
            return jnp.where(bounce_j.active[..., None], w, 1.0)

        W = jax.vmap(weight_at)(bounces)  # [D, N, C] / planar [D, N, C]x16
        # exclusive cumulative product: alpha[i] = prod_{j<i} W_j (camera-
        # first matrix order in the polarized case)
        if cfg.polarized:
            eye0 = mu.MuellerP.identity().materialize(n, C)

            def chain(carry, Wj):
                return mu.p_matmul(carry, Wj), carry

            _, alpha = jax.lax.scan(chain, eye0, W)  # planar [D, N, C]x16
        else:
            cum = jnp.cumprod(W, axis=0)
            alpha = jnp.concatenate(
                [jnp.ones((1, n, C), jnp.float32), cum[:-1]], axis=0
            )  # [D, N, C]

        # previous-vertex stacks for the emissive replay (the sensor "vertex"
        # for i = 0: wi points back toward the camera, only the direction and
        # delta-ness matter)
        b0 = jax.tree.map(lambda x: x[0], bounces)
        prev_p0 = b0.p + b0.si().to_world(b0.wi)
        prev_delta_flags = (
            bounces.bsdf_flags & jnp.uint32(BSDFFlags.Delta)
        ) != 0  # [D, N]
        prev_p = jnp.concatenate([prev_p0[None], bounces.p[:-1]], axis=0)
        prev_delta = jnp.concatenate(
            [jnp.ones((1, n), bool), prev_delta_flags[:-1]], axis=0
        )

        # hoist the CIE colour interpolation out of the depth loop: the
        # sampled wavelengths are loop-invariant, so one one-hot
        # [N*C, 95] contraction serves every NEE depth
        rgb_colour = None
        if not cfg.spectral:
            from ..core import spectrum as spec

            rgb_colour = spec.xyz_to_srgb(spec.cie1931_xyz(wavelengths))

        # one scan over depth (not a Python unroll: D-fold smaller HLO and
        # the same fused kernels run for every prefix)
        def solve_body(L, xs):
            b_i, prev_p_i, prev_delta_i, alpha_i, i = xs
            em_t = self._emissive_term(
                scene, b_i, prev_p_i, prev_delta_i, alpha_i, wavelengths, cfg
            )
            nee_t = self._nee_term(
                scene, sampler, b_i, i, alpha_i, wavelengths, cfg,
                rgb_colour=rgb_colour,
            )
            if cfg.polarized:
                L = _s_add(L, _s_add(em_t, nee_t))
            else:
                L = L + em_t + nee_t
            return L, None

        L0 = (tuple(jnp.zeros((n, C), jnp.float32) for _ in range(4))
              if cfg.polarized else jnp.zeros((n, C), jnp.float32))
        L, _ = jax.lax.scan(
            solve_body, L0,
            (bounces, prev_p, prev_delta, alpha,
             jnp.arange(D, dtype=jnp.uint32)),
        )
        return _s_stack(L, n, C) if cfg.polarized else L

    # ------------------------------------------------------------------
    def _emissive_term(self, scene, b_i, prev_p, prev_delta, alpha_i,
                       wavelengths, cfg):
        """Emissive-hit replay (plt.py:315-405); prev_p/prev_delta are the
        previous path vertex (the sensor stand-in for i = 0).

        Polarized: alpha_i is the world-basis Mueller prefix chain
        [N, 4, 4, C]; the unpolarized emitter Stokes is pushed through it
        and the contribution is a Stokes vector [N, 4, C] wrapped (with the
        sourced beam's coherence) in a GeneralizedRadiance for measure()."""
        em = scene.emitters
        geo = scene.geo
        n = b_i.valid.shape[0]

        active = b_i.active & b_i.is_emitter
        d = fr.normalize(b_i.p - prev_p)
        ds = DirectionSample(
            p=b_i.p, n=b_i.n, uv=b_i.uv, d=d,
            dist=fr.norm(b_i.p - prev_p),
            pdf=jnp.zeros((n,)), delta=jnp.zeros((n,), bool),
            emitter_idx=b_i.emitter_idx,
        )
        em_pdf = em_mod.pdf_emitter_direction(em, geo, prev_p, ds)
        em_pdf = jnp.where(prev_delta, 0.0, em_pdf)
        mis_bsdf = mis_weight(b_i.last_nd_pdf, em_pdf)

        facing = fr.cos_theta(b_i.wi) > 0
        e_val = em_mod.emitter_value(
            em, b_i.emitter_idx, ds.d, ds.dist, active & facing, cfg,
            wavelengths,
        )
        if not cfg.spectral:
            e_val = _to_channels(e_val, cfg)
        beam = self.source_beam(em, b_i, ds.d, ds.dist, e_val)
        if cfg.polarized:
            # planar: alpha_i @ (e, 0, 0, 0), masked + MIS-scaled
            w = jnp.where(active & facing, mis_bsdf, 0.0)
            S = _s_scale(
                mu.p_apply(alpha_i, (e_val, None, None, None)), w
            )
            z = jnp.zeros((n, e_val.shape[-1]), jnp.float32)
            gr_in = GeneralizedRadiance(
                L=S[0] if S[0] is not None else z,
                L1=S[1] if S[1] is not None else z,
                L2=S[2] if S[2] is not None else z,
                L3=S[3] if S[3] is not None else z,
                coherence=beam.coherence,
            )
            gr_out = self.measure(beam, prev_p, gr_in)
            return (gr_out.L, gr_out.L1, gr_out.L2, gr_out.L3)
        contrib = e_val * alpha_i * mis_bsdf[..., None]
        # beam sourcing + measurement (coherence plumbing; radiometrically
        # the replayed contribution — see measure())
        contrib = self.measure(beam, prev_p, contrib)
        return jnp.where((active & facing)[..., None], contrib, 0.0)

    # ------------------------------------------------------------------
    def source_beam(self, em, b_i, d, dist, Le):
        """Source a PLTBeam at the hit emitter by type (the documented intent
        of the fork's commented-out source_PLT_beam + emissive/distant
        sourcing areas, reference plt.py:28-34, 302-311, beam.h:173-205)."""
        from ..plt.beam import PLTBeam
        from ..scene.emitters import (
            EMITTER_DIRECTIONAL, EMITTER_CONSTANT, EMITTER_ENVMAP,
            EMITTER_DIRECTIONALSPOT,
        )

        n = d.shape[0]
        e_idx = jnp.maximum(b_i.emitter_idx, 0)
        etype = em.etype[e_idx]
        is_distant = (
            (etype == EMITTER_DIRECTIONAL) | (etype == EMITTER_CONSTANT)
            | (etype == EMITTER_ENVMAP) | (etype == EMITTER_DIRECTIONALSPOT)
        )
        # directionalspot: the emitter's angular spread IS the source solid
        # angle seen by the beam (pi * sin^2(spread_angle)); plain
        # directional/env sources use the integrator default
        sin_spread = em.cutoff_cos[e_idx]
        spot_omega = jnp.pi * sin_spread * sin_spread
        distant_sa = jnp.where(
            (etype == EMITTER_DIRECTIONALSPOT) & (spot_omega > 0),
            spot_omega,
            jnp.full((n,), self.distant_sourcing_area, jnp.float32),
        )
        beam_d = PLTBeam.source_distant(
            d, distant_sa, Le, self.max_angular_spread,
        )
        beam_a = PLTBeam.source_area(
            b_i.p, d, jnp.full((n,), self.emissive_sourcing_area, jnp.float32),
            dist, Le, self.max_angular_spread,
        )
        return jax.tree.map(
            lambda a, b: jnp.where(
                is_distant.reshape((n,) + (1,) * (a.ndim - 1)), a, b
            ),
            beam_d, beam_a,
        )

    def measure(self, beam, sensor_p, Li, sensor=None):
        """Beam-to-sensor measurement — the implemented intent of the
        fork's stub ("Propagate beam to camera (TODO); return Li",
        reference plt.py:475-490) using the PLTBeam machinery the fork left
        unwired (beam.h:83-150, 167-171).

        The beam is propagated to the measurement point (coherence opl
        grows by the covered distance, beam.h:167-171) and its Stokes
        basis is rotated onto the sensor's horizontal axis when a sensor
        frame is supplied (the stokes_fw convention, stokes_fw.cpp:100-110).

        MEASURED DECISION (round 4, VERDICT item 9): for every sensor this
        framework and the reference ship — perspective, thinlens,
        orthographic, radiance/irradiancemeter, batch, all with optional
        SRF — the detector responds to INTENSITY: the measurement operator
        on the arriving generalized Stokes vector is projection onto S0,
        and the spatial/angular mutual-coherence kernels (beam.h:83-122)
        enter only where amplitudes SUPERPOSE, i.e. inside wbsdf_eval's
        lobe sums — never at an intensity detector. Hence the radiometric
        measurement equals the replayed Li for every shipped scene; the
        propagated beam is exposed via measured_beam() for diagnostics and
        is pinned live by tests/test_plt.py::test_measure_beam_contract
        (opl growth + frame rotation + intensity invariance)."""
        self.measured_beam(beam, sensor_p, sensor)
        return Li

    def measured_beam(self, beam, sensor_p, sensor=None):
        """The beam state at the sensor (see measure()): propagated to the
        measurement point, Stokes basis rotated to the sensor's horizontal
        axis when a sensor frame is supplied."""
        beam = beam.propagate(sensor_p)
        if sensor is not None and getattr(sensor, "to_world", None) is not None:
            x_axis = sensor.to_world[:3, 0]
            fwd = -beam.dir
            tgt = x_axis[None, :] - fwd * jnp.sum(
                x_axis[None, :] * fwd, axis=-1, keepdims=True
            )
            tlen = jnp.linalg.norm(tgt, axis=-1, keepdims=True)
            ok = tlen[..., 0] > 1e-6
            tgt = jnp.where(
                ok[..., None], tgt / jnp.maximum(tlen, 1e-12), beam.tangent
            )
            beam = beam.rotate_frame(tgt)
        return beam

    # ------------------------------------------------------------------
    def _nee_term(self, scene, sampler, b_i, i, alpha_i, wavelengths, cfg,
                  rgb_colour=None):
        """NEE replay at bounce i (plt.py:221-300)."""
        em = scene.emitters
        geo = scene.geo
        n = b_i.valid.shape[0]
        ctx = BSDFContext()
        if em.count == 0:
            if cfg.polarized:
                return (None, None, None, None)
            return jnp.zeros((n, cfg.n_channels), jnp.float32)

        smooth = (b_i.bsdf_flags & jnp.uint32(BSDFFlags.Smooth)) != 0
        active_em = b_i.active & smooth

        u1 = sampler.next_1d(bounce_dim(i, 8))
        u2 = sampler.next_2d(bounce_dim(i, 9))
        ds = em_mod.sample_emitter_direction(em, geo, b_i.p, u1, u2, active_em)

        # shadow ray (inactive lanes get the canonical dead ray, see the
        # sample() carry note)
        occ_ray = Ray(
            o=jnp.where(
                active_em[..., None],
                b_i.p + b_i.n * jnp.where(
                    fr.dot(ds.d, b_i.n) >= 0, mth.RayEpsilon, -mth.RayEpsilon
                )[..., None],
                1e8,
            ),
            d=ds.d,
            maxt=jnp.where(
                active_em, ds.dist * (1.0 - mth.ShadowEpsilon), 0.0
            ),
        )
        i_arr = jnp.asarray(i)
        occluded = scene.ray_test(
            occ_ray,
            coherent=(i_arr == 0) if i_arr.ndim == 0 else False,
        )
        vis = active_em & ~occluded & (ds.pdf > 0)

        si = b_i.si()
        wo_local = si.to_local(ds.d)
        sd = wb.PLTSamplePhaseData(
            bs=None, lobe=b_i.lobe,
            internal_frame=jnp.zeros((n, 3), jnp.float32),
            coherence=Coherence.isotropic(
                jnp.zeros((n,), jnp.float32), jnp.zeros((n,), jnp.float32)
            ),
            sampling_wavelengths=wavelengths,
        )
        bsdf_val = wb.wbsdf_eval(
            scene.materials, jnp.maximum(si.mat_idx, 0), si, wo_local, sd,
            ctx, cfg, rgb_colour=rgb_colour,
        )
        bsdf_pdf = wb.wbsdf_pdf(
            scene.materials, jnp.maximum(si.mat_idx, 0), si, wo_local, sd,
            ctx, cfg,
        )
        if bsdf_pdf.ndim > 1:
            bsdf_pdf = bsdf_pdf[..., 0]
        mis_em = jnp.where(ds.delta, 1.0, mis_weight(ds.pdf, bsdf_pdf))

        e_val = em_mod.emitter_value(
            em, ds.emitter_idx, ds.d, ds.dist, vis, cfg, wavelengths
        )
        if not cfg.spectral:
            e_val = _to_channels(e_val, cfg)
        if cfg.polarized:
            # full Mueller NEE (ref roughgrating.cpp:925-999 carries the
            # polarized Spectrum): rotate the local-basis Mueller to world
            # implicit bases and push the emitter Stokes through
            # alpha @ (M @ S) — two planar matrix-vector applies.
            M_world = bsdfs.to_world_mueller(si, bsdf_val, -wo_local, si.wi)
            s0 = e_val / jnp.maximum(ds.pdf, 1e-20)[..., None]
            return _s_scale(
                mu.p_apply(
                    alpha_i, mu.p_apply(M_world, (s0, None, None, None))
                ),
                jnp.where(vis, mis_em, 0.0),
            )
        em_weight = e_val / jnp.maximum(ds.pdf, 1e-20)[..., None]
        contrib = em_weight * bsdf_val * alpha_i * mis_em[..., None]
        return jnp.where(vis[..., None], contrib, 0.0)

    # ------------------------------------------------------------------
    def sample(self, scene, sampler: Sampler, ray: Ray, wavelengths,
               cfg: RenderConfig):
        """ADIntegrator-compatible entry: radiance [N, C] (S0 under a
        polarized config) + valid mask."""
        L = self._sample_impl(scene, sampler, ray, wavelengths, cfg)
        n = ray.o.shape[0]
        if cfg.polarized:
            # film records intensity; the full Stokes vector is available
            # via sample_stokes (StokesIntegrator(inner=PLTIntegrator()))
            return L[:, 0, :], jnp.ones((n,), bool)
        return L, jnp.ones((n,), bool)

    def _sample_impl(self, scene, sampler: Sampler, ray: Ray, wavelengths, cfg: RenderConfig):
        """Fused single-scan transport (plt.py:493-529). In spectral mode
        the camera-sampled hero wavelengths are used (so the standard
        spectral->XYZ conversion applies); in RGB mode PLT samples its own
        per-channel wavelengths (plt.py:65-70). Returns [N, C] radiance, or
        Stokes [N, 4, C] under a polarized config (full Mueller chain, ref
        roughgrating.cpp:925-999 / bsdf.h:379-620 polarized Spectrum).

        FUSED single-scan execution: because the replay
        weights are coherence-independent (the same fact that collapsed the
        O(D^2) replay to one cumprod — see the module docstring), the
        prefix product alpha_i is a RUNNING product available at bounce
        time, so the emissive and NEE terms of solve_phase can be
        accumulated in the SAME scan that samples the path. This removes
        the stacked [D, N, ...] bounce buffer entirely: no
        dynamic-update-slice writes, no solve-side
        re-reads, no duplicated SurfaceInteraction reconstruction. The
        math, term order, sampler dimensions, and masking are identical to
        sample_phase + solve_phase (kept for the spectrograph experiment,
        which needs the explicit bounce buffer)."""
        n = ray.o.shape[0]
        C = cfg.n_channels
        ctx = BSDFContext()
        sg = jax.lax.stop_gradient

        if cfg.spectral and wavelengths is not None:
            wl = wavelengths
        else:
            u_wl = jnp.stack(
                [sampler.next_1d(DIM_WAVELENGTH + i) for i in range(C)],
                axis=-1,
            )
            wl = wb.sample_plt_wavelengths(u_wl, C)

        # loop-invariant CIE colour (see solve_phase)
        rgb_colour = None
        if not cfg.spectral:
            from ..core import spectrum as spec

            rgb_colour = spec.xyz_to_srgb(spec.cie1931_xyz(wl))

        has_tan_frames = scene.geo.tri_attr.shape[1] >= 40

        def body(carry, b, coherent=False):
            (ray_o, ray_d, active, last_nd_pdf, prev_delta, prev_p,
             alpha, L) = carry
            b_arr = jnp.asarray(b)
            coh0 = (b_arr == 0) if b_arr.ndim == 0 else False
            ray_b = Ray.create(ray_o, ray_d)
            # detached-sampling semantics (reference PRB / wbsdf replay):
            # the sampled path carries no gradient; parameters
            # differentiate through the attached re-evaluations below.
            si = jax.tree.map(sg, scene.ray_intersect(ray_b, coherent=coh0))
            hit = si.valid & active
            is_emitter = hit & (si.emitter_idx >= 0)
            active_next = hit & (b + 1 < self.max_depth)

            u1 = sampler.next_1d(bounce_dim(b, 0))
            u2 = sampler.next_2d(bounce_dim(b, 1))
            lobe_u2 = sampler.next_2d(bounce_dim(b, 3))
            sd, weight, ok = wb.wbsdf_sample(
                scene.materials, jnp.maximum(si.mat_idx, 0), si,
                u1, u2, lobe_u2, ctx, cfg, wl,
            )
            bs = jax.tree.map(sg, sd.bs)
            lobe = sg(sd.lobe)
            weight = sg(weight)

            # Russian roulette (plt.py:133-143)
            w_max = jnp.max(
                weight if not cfg.polarized else jnp.broadcast_to(
                    weight.m00(), (n, C)
                ),
                axis=-1,
            )
            rr_prob = jnp.minimum(jnp.maximum(w_max, 0.05), 0.95)
            rr_active = (b + 1) >= self.rr_depth
            u_rr = sampler.next_1d(bounce_dim(b, 6))
            rr_continue = ~rr_active | (u_rr < rr_prob)
            rr_rcp = jnp.where(
                rr_active, 1.0 / jnp.maximum(rr_prob, 1e-6), 1.0
            )

            active_next = active_next & ok & (bs.pdf > 0) & rr_continue
            is_delta = (bs.sampled_type & jnp.uint32(BSDFFlags.Delta)) != 0

            b_i = BounceData(
                valid=si.valid, t=si.t, p=si.p, n=si.n,
                sh_s=si.sh_s if has_tan_frames else None,
                sh_t=si.sh_t if has_tan_frames else None,
                sh_n=si.sh_n, uv=si.uv,
                wi=si.wi, mat_idx=si.mat_idx, emitter_idx=si.emitter_idx,
                wo=bs.wo, bsdf_flags=bs.sampled_type, rr_rcp=rr_rcp,
                bsdf_weight=(weight if not cfg.polarized
                             else jnp.broadcast_to(weight.m00(), (n, C))),
                is_emitter=is_emitter, last_nd_pdf=last_nd_pdf,
                lobe=lobe, active=hit,
            )

            # solve terms for THIS prefix (identical to solve_body)
            prev_p_eff = jnp.where(
                (b == 0), si.p + si.to_world(si.wi), prev_p
            )
            em_term = self._emissive_term(
                scene, b_i, prev_p_eff, prev_delta, alpha, wl, cfg
            )
            nee_term = self._nee_term(
                scene, sampler, b_i, b, alpha, wl, cfg,
                rgb_colour=rgb_colour,
            )
            if cfg.polarized:
                L = _s_add(L, _s_add(em_term, nee_term))
            else:
                L = L + em_term + nee_term

            # running replay weight (solve_phase weight_at)
            sd_w = wb.PLTSamplePhaseData(
                bs=None, lobe=lobe,
                internal_frame=jnp.zeros((n, 3), jnp.float32),
                coherence=Coherence.isotropic(
                    jnp.full((n,), 1e-18, jnp.float32),
                    jnp.zeros((n,), jnp.float32),
                ),
                sampling_wavelengths=wl,
            )
            w_rep = wb.wbsdf_weight(
                scene.materials, jnp.maximum(si.mat_idx, 0), si,
                bs.wo, sd_w, ctx, cfg,
            )
            if cfg.polarized:
                # Mueller prefix chain: rotate the local-basis weight to
                # world implicit bases and right-multiply (camera-first
                # order, exactly the polarized path tracer's T chain)
                W_world = bsdfs.to_world_mueller(si, w_rep, -bs.wo, si.wi)
                W_world = mu.p_scale(W_world, rr_rcp[..., None])
                alpha = mu.p_where(hit, mu.p_matmul(alpha, W_world), alpha)
            else:
                w_rep = w_rep * rr_rcp[..., None]
                alpha = alpha * jnp.where(hit[..., None], w_rep, 1.0)

            wo_world = si.to_world(bs.wo)
            new_o = si.p + si.n * jnp.where(
                fr.dot(wo_world, si.n) >= 0, mth.RayEpsilon, -mth.RayEpsilon
            )[..., None]
            # canonical far-away ray for dead lanes (see path.py): exits
            # the BVH at the root instead of traversing garbage directions
            dead = ~active_next
            new_o = jnp.where(dead[..., None], 1e8, new_o)
            wo_world = jnp.where(
                dead[..., None],
                jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
                wo_world,
            )
            nd_pdf_next = jnp.where(is_delta, last_nd_pdf, bs.pdf)
            carry = (
                new_o, wo_world, active_next,
                jnp.where(active_next, nd_pdf_next, last_nd_pdf),
                is_delta,   # solve's prev_delta[i] = flags[i-1] & Delta
                si.p, alpha, L,
            )
            return carry, None

        if cfg.polarized:
            alpha0 = mu.MuellerP.identity().materialize(n, C)
            L0 = tuple(jnp.zeros((n, C), jnp.float32) for _ in range(4))
        else:
            alpha0 = jnp.ones((n, C), jnp.float32)
            L0 = jnp.zeros((n, C), jnp.float32)
        carry0 = (
            ray.o, ray.d, jnp.ones((n,), bool),
            jnp.ones((n,), jnp.float32),
            jnp.ones((n,), bool),           # sensor vertex counts as delta
            jnp.zeros((n, 3), jnp.float32),  # prev_p (unused at b = 0)
            alpha0,
            L0,
        )
        carry0, _ = jax.lax.scan(
            body, carry0, jnp.arange(self.max_depth, dtype=jnp.uint32)
        )
        L = carry0[-1]
        return _s_stack(L, n, C) if cfg.polarized else L

    # ------------------------------------------------------------------
    def sample_stokes(self, scene, sampler: Sampler, ray: Ray, wavelengths,
                      cfg: RenderConfig):
        """Stokes radiance [N, 4, C] of the wave transport (implicit basis
        stokes_basis(-ray.d)) — the StokesIntegrator inner-integrator
        surface, so `stokes`/`stokes_fw` wrap PLT exactly as the
        reference's main-headless.py does (stokes ∘ plt)."""
        assert cfg.polarized
        return self._sample_impl(scene, sampler, ray, wavelengths, cfg)
