"""Integrator framework: wavefront construction, spp-pass loop, film splat.

Functional twin of ADIntegrator.render / sample_rays / prepare (reference
src/python/python/ad/integrators/common.py:46-368) redesigned for XLA: one
jitted megakernel renders (pixels x spp_per_pass) lanes; the host loops over
passes and accumulates the film (analog of integrator.cpp:246-355 wavefront
splitting).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..core import spectrum as spec
from ..core.rng import Sampler, DIM_CAMERA, DIM_WAVELENGTH
from ..librender.film import ImageBlock, FILTER_BOX
from ..librender.records import Ray


def sample_rays(scene, sampler: Sampler, width, height, spp_pass, cfg: RenderConfig,
                lane_offset=0, sampler_type: str = "independent"):
    """Build the camera wavefront: one lane per (pixel, sample).

    sampler_type: "independent" (counter hash) or "stratified"/"multijitter"
    (correlated multi-jittered pixel positions, src/samplers/ role).
    Returns (ray, pos_uv [N,2], wavelengths [N,C] or None, wl_weight or None).
    """
    n = width * height * spp_pass
    lane = jnp.arange(n, dtype=jnp.uint32)
    return camera_rays_at(
        scene, sampler.seed, lane, width, height, spp_pass, cfg,
        sampler_type=sampler_type,
    )


def _morton_compact(x):
    """Drop every other bit of a u32 (morton decode half), elementwise."""
    x = x & jnp.uint32(0x55555555)
    x = (x | (x >> 1)) & jnp.uint32(0x33333333)
    x = (x | (x >> 2)) & jnp.uint32(0x0F0F0F0F)
    x = (x | (x >> 4)) & jnp.uint32(0x00FF00FF)
    x = (x | (x >> 8)) & jnp.uint32(0x0000FFFF)
    return x


def morton_pixel_of(pix, width):
    """Scanline pixel index of morton slot `pix` — pure u32 bit arithmetic
    (no gathers). Power-of-two square resolutions only.

    Morton sample layout makes a [16, 128] Pallas ray tile cover a SQUARE
    image block instead of a scanline strip — the treelet-union gating of
    the clu2 kernel prunes far better on square tiles (camera rays AND the
    bounce rays that inherit their lane's locality)."""
    px = _morton_compact(pix)
    py = _morton_compact(pix >> 1)
    return py * jnp.uint32(width) + px


def morton_pixel_perm(width, height):
    """Host-side [W*H] permutation: mp[j] = scanline pixel of morton slot j
    (the numpy twin of morton_pixel_of, for output unscrambling)."""
    import numpy as np

    assert width == height and (width & (width - 1)) == 0
    j = np.arange(width * height, dtype=np.uint32)

    def compact(x):
        x = x & np.uint32(0x55555555)
        x = (x | (x >> np.uint32(1))) & np.uint32(0x33333333)
        x = (x | (x >> np.uint32(2))) & np.uint32(0x0F0F0F0F)
        x = (x | (x >> np.uint32(4))) & np.uint32(0x00FF00FF)
        x = (x | (x >> np.uint32(8))) & np.uint32(0x0000FFFF)
        return x

    return (compact(j >> np.uint32(1)) * width + compact(j)).astype(np.int64)


def camera_rays_at(scene, seed, sample_lane, width, height, spp_pass,
                   cfg: RenderConfig, sampler_type: str = "independent",
                   pixel_order: str = "scanline"):
    """Camera ray generation for explicit sample ids.

    Identical math to the arange layout of sample_rays — sample id s maps to
    pixel s // spp_pass and sub-sample s % spp_pass — but callable with any
    per-lane id vector. This is what lets the regenerative-wavefront
    integrators (path.py sample_regen) restart finished lanes on NEW samples
    mid-flight and still produce bit-identical per-sample values.

    pixel_order: "scanline" (default) or "morton" (po2 square only): remaps
    which PIXEL each sample slot renders (morton_pixel_of); the sample
    stream (RNG keyed on sample id) is unchanged. Callers assembling images
    from sample-slot order must unscramble with morton_pixel_perm.
    """
    from ..core.rng import (
        cmj_sample_2d, halton_2d, ld_2d, orthogonal_2d, hash_combine,
    )

    sampler = Sampler(seed=jnp.asarray(seed, jnp.uint32),
                      lane=jnp.asarray(sample_lane, jnp.uint32))
    lane = sampler.lane
    pix = (lane // spp_pass).astype(jnp.uint32)
    if pixel_order == "morton":
        # morton_pixel_of is pure bit arithmetic and silently scrambles
        # non-square / non-po2 resolutions; mirror morton_pixel_perm's
        # host-side assert here (width/height are static).
        assert width == height and (width & (width - 1)) == 0, (
            "pixel_order='morton' requires a power-of-two square resolution"
        )
        pix = morton_pixel_of(pix, width)
    px = (pix % width).astype(jnp.float32)
    py = (pix // width).astype(jnp.float32)

    if sampler_type in ("stratified", "multijitter") and spp_pass > 1:
        s_idx = (lane % spp_pass).astype(jnp.uint32)
        pattern = hash_combine(sampler.seed, pix)
        jitter = cmj_sample_2d(s_idx, spp_pass, pattern)
    elif sampler_type == "ldsampler" and spp_pass > 1:
        # scrambled (0,2)-sequence (reference ldsampler.cpp)
        s_idx = (lane % spp_pass).astype(jnp.uint32)
        pattern = hash_combine(sampler.seed, pix)
        jitter = ld_2d(s_idx, pattern)
    elif sampler_type == "halton" and spp_pass > 1:
        s_idx = (lane % spp_pass).astype(jnp.uint32)
        pattern = hash_combine(sampler.seed, pix)
        jitter = halton_2d(s_idx, pattern)
    elif sampler_type == "orthogonal" and spp_pass > 1:
        s_idx = (lane % spp_pass).astype(jnp.uint32)
        pattern = hash_combine(sampler.seed, pix)
        jitter = orthogonal_2d(s_idx, spp_pass, pattern)
    else:
        jitter = sampler.next_2d(DIM_CAMERA)
    uv = jnp.stack(
        [(px + jitter[..., 0]) / width, (py + jitter[..., 1]) / height], axis=-1
    )
    aperture = sampler.next_2d(DIM_CAMERA + 2)
    o, d = scene.sensor.sample_ray(uv, aperture)

    wavelengths = None
    wl_weight = None
    if cfg.spectral:
        u_wl = sampler.next_1d(DIM_WAVELENGTH)
        wavelengths, wl_weight = spec.sample_hero_wavelengths(u_wl, cfg.n_channels)

    return Ray.create(o, d), uv, wavelengths, wl_weight


def mis_weight(pdf_a, pdf_b):
    """Power heuristic (beta=2), reference common.py:1304-1312.

    Scale-invariant ratio form 1/(1 + (b/a)^2): the naive a^2/(a^2+b^2)
    overflows f32 for pdfs beyond ~1e19, and its VJP produces inf*0 NaNs
    whenever either pdf carries tangents on degenerate lanes (volumetric
    NEE vertices depend on the sampled flight distance, so ds.pdf is
    differentiated there). Non-finite inputs are sanitized — they only
    occur on masked garbage lanes, whose weight must stay inert."""
    a = jnp.where(jnp.isfinite(pdf_a), pdf_a, 0.0)
    b = jnp.where(jnp.isfinite(pdf_b), pdf_b, 0.0)
    a_ok = a > 0
    r = jnp.clip(
        b / jnp.where(a_ok, jnp.maximum(a, 1e-30), 1.0), 0.0, 1e12
    )
    w = 1.0 / (1.0 + r * r)
    return jnp.where(a_ok, w, 0.0)


# module-level jitted-pass cache (see render() below); strong refs, tiny LRU
_PASS_CACHE: dict = {}
_PASS_CACHE_MAX = 4


def render(
    scene,
    integrator_sample,
    seed: int = 0,
    spp: int = 16,
    cfg: RenderConfig = RenderConfig(),
    spp_per_pass: int | None = None,
    rfilter: int = FILTER_BOX,
    n_out_channels: int | None = None,
    sampler_type: str = "independent",
    device_pass_loop: bool = False,
    timeout: float | None = None,
    progress=None,
    stats: dict | None = None,
    regen: bool = False,
):
    """Render orchestration: loops spp passes on host, jits the per-pass
    megakernel, accumulates an ImageBlock, develops to [H, W, C].

    integrator_sample(scene, sampler, ray, wavelengths, cfg) -> (values [N,C'],
    valid [N]) where C' = n_out_channels (3 for RGB L, 12 for stokes AOVs...).

    Observability (reference integrator.cpp:91-170 timeout/cancel +
    ProgressReporter): `timeout` stops cooperatively between passes and
    develops the partial accumulation (the reference's SIGHUP partial-dump
    role); `progress(done, total, elapsed_s)` fires after each pass;
    `stats` (a dict) receives compile_s / steady-state timing / passes_done.

    `regen=True` selects the integrator's regenerative wavefront
    (sample_regen) when it has one: finished lanes respawn on their next
    strided camera sample instead of idling to the end of the bounce scan.
    Per-sample values are identical (same counter RNG keyed on sample id);
    only the schedule changes. Primal renders only.
    """
    width, height = scene.sensor.resolution
    if spp_per_pass is None:
        # cap wavefront at ~2^21 lanes to bound device memory. When the
        # cap BINDS, round the per-pass spp down to a power of two:
        # arbitrary cap-derived values (e.g. 109) would give every sweep
        # setting its own compiled shape; po2 passes share one cached
        # executable. Single-pass renders keep the exact requested spp.
        cap = max(1, (1 << 21) // (width * height) or 1)
        if spp <= cap:
            spp_per_pass = spp
        else:
            spp_per_pass = 1 << (cap.bit_length() - 1)
    n_pass = (spp + spp_per_pass - 1) // spp_per_pass
    # default film channels: RGB, or the variant's own channel count for
    # non-spectral configs (mono = 1); spectral converts to RGB at develop
    ch = n_out_channels or (cfg.n_channels if not cfg.spectral else 3)

    # Reuse the jitted pass across render() calls, so an spp sweep or
    # repeated renders of the same scene trace and compile once. The seed
    # is a traced argument so different seeds share one executable; the
    # cache holds strong scene refs (id-keyed).
    integ_obj = getattr(integrator_sample, "__self__", None)
    # regen lane count: Q ~ 8 strided samples per lane keeps respawn
    # bookkeeping amortized while cutting dead-lane waste ~Q-fold; tiny
    # renders (< 64k samples) can't amortize the while_loop and stay on
    # the scan megakernel.
    total_pass = width * height * spp_per_pass
    use_regen = bool(
        regen
        and integ_obj is not None
        and hasattr(integ_obj, "sample_regen")
        and not cfg.polarized
        and total_pass >= (1 << 16)
        # never nest the regen lax.while_loop inside the device pass
        # fori_loop: that combination is untested
        and not device_pass_loop
    )
    regen_lanes = -(-total_pass // 8) if use_regen else 0

    try:
        ikey = integrator_sample.__self__
        hash(ikey)
    except (AttributeError, TypeError):
        ikey = id(getattr(integrator_sample, "__self__", integrator_sample))
    fkey = getattr(
        integrator_sample, "__func__", integrator_sample
    ).__qualname__
    cache_key = (
        id(scene), ikey, fkey, width, height, spp_per_pass, cfg, rfilter,
        ch, sampler_type, use_regen, jax.default_backend(),
    )
    cached = _PASS_CACHE.get(cache_key)
    if cached is None:
        def _compute(pass_idx, seed_u32):
            sampler = Sampler.create(seed_u32, width * height * spp_per_pass)
            sampler = sampler.fork_traced(pass_idx)
            with jax.named_scope("sample_rays"):
                ray, uv, wavelengths, wl_weight = sample_rays(
                    scene, sampler, width, height, spp_per_pass, cfg,
                    sampler_type=sampler_type,
                )
            with jax.named_scope("integrator"):
                if use_regen:
                    values = integ_obj.sample_regen(
                        scene, sampler.seed, width, height, spp_per_pass,
                        cfg, regen_lanes, sampler_type=sampler_type,
                    )
                    valid = jnp.ones((values.shape[0],), bool)
                else:
                    values, valid = integrator_sample(
                        scene, sampler, ray, wavelengths, cfg
                    )
            if cfg.spectral:
                # convert hero-wavelength spectral values to RGB via CIE XYZ
                xyz = spec.spectrum_to_xyz(values, wavelengths, wl_weight)
                values = spec.xyz_to_srgb(xyz)
            return uv, values, valid

        @jax.jit
        def render_pass(block_data, pass_idx, seed_u32):
            uv, values, valid = _compute(pass_idx, seed_u32)
            block = ImageBlock(
                data=block_data, width=width, height=height,
                n_channels=values.shape[-1], rfilter=rfilter,
            )
            # lanes are pixel-ordered (lane // spp_pass = pixel): segment
            # sums instead of scatter-adds
            if rfilter == FILTER_BOX:
                block = block.put_ordered(values, valid, spp_per_pass)
            else:
                block = block.put_ordered_filtered(
                    uv, values, valid, spp_per_pass
                )
            return block.data

        _PASS_CACHE[cache_key] = render_pass
        while len(_PASS_CACHE) > _PASS_CACHE_MAX:
            _PASS_CACHE.pop(next(iter(_PASS_CACHE)))
        cached = render_pass
    render_pass = cached
    seed_arr = jnp.uint32(seed)

    block = ImageBlock.create(width, height, ch, rfilter)
    data = block.data

    if device_pass_loop and rfilter == FILTER_BOX:
        # pass loop on-device: one dispatch per 32 passes instead of one
        # per pass. Default off: the host loop pipelines async dispatches;
        # which is faster on the GPU is not measured yet.
        @jax.jit
        def render_chunk(data, p0, n):
            def body(i, d):
                return render_pass(d, p0 + i.astype(jnp.uint32), seed_arr)

            return jax.lax.fori_loop(0, n, body, data)

        done = 0
        while done < n_pass:
            todo = min(32, n_pass - done)
            data = render_chunk(data, jnp.uint32(done), jnp.int32(todo))
            done += todo
    else:
        import time as _time

        t_start = _time.perf_counter()
        t_compile = None
        done = 0
        for p in range(n_pass):
            data = render_pass(data, jnp.uint32(p), seed_arr)
            if p == 0 and (timeout or progress or stats is not None):
                data.block_until_ready()
                t_compile = _time.perf_counter() - t_start
            done = p + 1
            elapsed = _time.perf_counter() - t_start
            if progress is not None:
                progress(done, n_pass, elapsed)
            if timeout is not None and elapsed > timeout and done < n_pass:
                # cooperative cancel: develop the partial accumulation
                break
        if stats is not None:
            data.block_until_ready()
            total = _time.perf_counter() - t_start
            stats.update(
                passes_done=done, n_pass=n_pass,
                compile_s=round(t_compile, 4) if t_compile else None,
                total_s=round(total, 4),
                steady_s_per_pass=(
                    round((total - t_compile) / max(done - 1, 1), 4)
                    if t_compile is not None and done > 1 else None
                ),
                spp_done=done * spp_per_pass,
            )
    block = dataclasses.replace(block, data=data)
    with jax.named_scope("develop"):
        return block.develop()
