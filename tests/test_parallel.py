"""Sharded-render equivalence: the shard_map wavefront path must reproduce
the single-device render (lane-indexed counter RNG makes device slices
bit-identical — parallel/render.py docstring contract)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mitsuba3_plt_tpu.config import RGB
from mitsuba3_plt_tpu.integrators.common import render
from mitsuba3_plt_tpu.integrators.path import PathIntegrator
from mitsuba3_plt_tpu.parallel.render import make_mesh, make_render_pass_sharded
from mitsuba3_plt_tpu.scene.presets import cornell_box


def test_sharded_matches_single_device():
    assert len(jax.devices()) >= 8, "conftest forces an 8-device virtual mesh"
    W = H = 16
    spp = 4
    scene, _ = cornell_box(W, H)
    integ = PathIntegrator(max_depth=3, rr_depth=8)

    img_single = np.asarray(
        render(scene, integ.sample, seed=0, spp=spp, cfg=RGB,
               spp_per_pass=spp)
    )

    mesh = make_mesh(8)
    run = make_render_pass_sharded(integ.sample, mesh, W, H, spp, RGB)
    data = np.asarray(run(scene, 0, 0))
    img_sharded = (
        data[..., :3] / np.maximum(data[..., 3:4], 1e-8)
    ).reshape(H, W, 3)

    np.testing.assert_allclose(img_sharded, img_single, rtol=2e-5, atol=2e-6)


def test_sharded_grad_psum():
    """Scene-parameter gradients through the sharded path: psum'd film
    gradients match the single-device gradients."""
    W = H = 8
    spp = 2
    scene, _ = cornell_box(W, H)
    integ = PathIntegrator(max_depth=2, rr_depth=8)
    from mitsuba3_plt_tpu.ad import traverse
    from mitsuba3_plt_tpu.ad.render import render_differentiable

    params = traverse(scene)
    key = "emitters.radiance"

    def loss_single(v):
        sc = params.update({key: v})
        img = render_differentiable(sc, integ.sample, seed=0, spp=spp,
                                    cfg=RGB, spp_per_pass=spp)
        return jnp.mean(img)

    g1 = np.asarray(jax.grad(loss_single)(params[key]))

    mesh = make_mesh(8)

    def loss_sharded(v):
        sc = params.update({key: v})
        run = make_render_pass_sharded(integ.sample, mesh, W, H, spp, RGB)
        data = run(sc, 0, 0)
        img = data[..., :3] / jnp.maximum(data[..., 3:4], 1e-8)
        return jnp.mean(img)

    g8 = np.asarray(jax.grad(loss_sharded)(params[key]))
    np.testing.assert_allclose(g8, g1, rtol=1e-4, atol=1e-7)


def test_plt_sharded_matches_single_device():
    """The fused single-scan PLT integrator under shard_map reproduces the
    single-device render bit-close (lane-indexed RNG contract; the fused
    path is the flagship multi-chip workload)."""
    from mitsuba3_plt_tpu.integrators.plt import PLTIntegrator
    from mitsuba3_plt_tpu.scene.presets import grating_scene

    W = H = 16
    spp = 4
    scene, _ = grating_scene(W, H)
    integ = PLTIntegrator(max_depth=3, rr_depth=8)

    img_single = np.asarray(
        render(scene, integ.sample, seed=0, spp=spp, cfg=RGB,
               spp_per_pass=spp)
    )
    mesh = make_mesh(8)
    run = make_render_pass_sharded(integ.sample, mesh, W, H, spp, RGB)
    data = np.asarray(run(scene, 0, 0))
    img_sharded = (
        data[..., :3] / np.maximum(data[..., 3:4], 1e-8)
    ).reshape(H, W, 3)
    np.testing.assert_allclose(img_sharded, img_single, rtol=2e-5, atol=2e-6)
