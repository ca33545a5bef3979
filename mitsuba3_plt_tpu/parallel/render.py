"""shard_map render path: camera lanes sharded over a device mesh.

Equivalent role to the reference's tile/wavefront parallelism
(src/render/integrator.cpp:158-355) recast for a device mesh: lanes are globally
indexed, so a device's slice of the wavefront draws exactly the same sampler
values as a single-device run (core/rng.py counter-based streams) — the
distributed image is bit-identical to the local one up to film summation
order. Film reduction is a psum over per-device scatter-add partials.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import RenderConfig
from ..core import spectrum as spec
from ..core.rng import Sampler
from ..integrators.common import sample_rays
from ..librender.film import ImageBlock, FILTER_BOX


def make_mesh(n_devices: int | None = None, axis: str = "rays") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def make_render_pass_sharded(
    integrator_sample,
    mesh: Mesh,
    width: int,
    height: int,
    spp_pass: int,
    cfg: RenderConfig,
    rfilter: int = FILTER_BOX,
):
    """Build a jitted sharded pass function (scene, seed, pass_idx) -> film
    data [H*W, C+1] (replicated). The lane space is padded so it divides the
    device count; padded lanes are masked inactive.
    """
    n_dev = mesh.devices.size
    axis = mesh.axis_names[0]
    n_lanes = width * height * spp_pass
    per_dev = (n_lanes + n_dev - 1) // n_dev

    def pass_fn(scene, seed, pass_idx, lane_start_shard):
        offset = lane_start_shard[0]
        sampler = Sampler.create(0, per_dev)
        sampler = dataclasses.replace(
            sampler,
            seed=jnp.asarray(seed, jnp.uint32),
            lane=sampler.lane + offset,
        )
        sampler = sampler.fork_traced(pass_idx)
        lane = sampler.lane
        live = lane < jnp.uint32(n_lanes)

        ray, uv, wavelengths, wl_weight = _rays_for_lanes(
            scene, sampler, lane, width, height, spp_pass, cfg
        )
        values, valid = integrator_sample(scene, sampler, ray, wavelengths, cfg)
        if cfg.spectral:
            xyz = spec.spectrum_to_xyz(values, wavelengths, wl_weight)
            values = spec.xyz_to_srgb(xyz)
        block = ImageBlock.create(width, height, values.shape[-1], rfilter)
        block = block.put(uv, values, valid & live)
        return jax.lax.psum(block.data, axis)

    sharded = jax.shard_map(
        pass_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(axis)),
        out_specs=P(),
        check_vma=False,  # scan carries mix replicated scene + varying lanes
    )

    @jax.jit
    def run(scene, seed, pass_idx):
        lane_start = jnp.arange(n_dev, dtype=jnp.uint32) * jnp.uint32(per_dev)
        return sharded(scene, seed, pass_idx, lane_start)

    return run


def _rays_for_lanes(scene, sampler, lane, width, height, spp_pass, cfg):
    """sample_rays twin that derives pixel coords from explicit global lane
    ids (needed when a device holds a contiguous lane slice)."""
    pix = (lane // jnp.uint32(spp_pass)).astype(jnp.uint32)
    pix = jnp.minimum(pix, jnp.uint32(width * height - 1))
    px = (pix % width).astype(jnp.float32)
    py = (pix // width).astype(jnp.float32)

    from ..core.rng import DIM_CAMERA, DIM_WAVELENGTH
    from ..librender.records import Ray

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


def render_sharded(
    scene,
    integrator_sample,
    mesh: Mesh,
    seed: int = 0,
    spp: int = 16,
    cfg: RenderConfig = RenderConfig(),
    spp_per_pass: int | None = None,
    rfilter: int = FILTER_BOX,
):
    """Full sharded render: host loop over spp passes, jitted sharded pass."""
    width, height = scene.sensor.resolution
    if spp_per_pass is None:
        spp_per_pass = max(
            1, min(spp, (1 << 22) // (width * height) or 1)
        )
    n_pass = (spp + spp_per_pass - 1) // spp_per_pass

    run = make_render_pass_sharded(
        integrator_sample, mesh, width, height, spp_per_pass, cfg, rfilter
    )

    data = None
    for p in range(n_pass):
        d = run(scene, seed, p)
        data = d if data is None else data + d
    block = ImageBlock(
        data=data, width=width, height=height, n_channels=data.shape[-1] - 1,
        rfilter=rfilter,
    )
    return block.develop()
