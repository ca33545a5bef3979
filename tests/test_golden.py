"""Golden-image regression tests (the reference's test_renders.py z-test
scheme, SURVEY §4): small fixed-seed renders compared against stored
references with a per-pixel z-test at Sidak-corrected significance.

References live in tests/golden/*.npz (mean + variance over spp). Regenerate
after INTENDED changes with (all configs, or the ones named):
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_golden.py [name ...]
"""
import os

import numpy as np
import pytest

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _configs():
    from mitsuba3_plt_tpu.config import RGB
    from mitsuba3_plt_tpu.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu.integrators.plt import PLTIntegrator
    from mitsuba3_plt_tpu.integrators.stokes import StokesIntegrator
    from mitsuba3_plt_tpu.scene.presets import cornell_box, grating_scene

    def _cbox_xml():
        import mitsuba3_plt_tpu as mi
        from mitsuba3_plt_tpu.scene.presets import CBOX_STANDIN_XML

        return mi.load_file(CBOX_STANDIN_XML, resx=48, resy=48)[0]

    def _mesh20k():
        import mitsuba3_plt_tpu as mi
        from mitsuba3_plt_tpu.core import transform as tf
        from mitsuba3_plt_tpu.scene import shape as shp

        mesh = shp.make_sphere(subdiv=5)  # 20480 faces: above the brute cap
        return mi.load_dict({
            "type": "scene",
            "sensor": {
                "type": "perspective", "fov": 45,
                "to_world": tf.look_at([0, 0, 4], [0, 0, 0], [0, 1, 0]),
                "film": {"type": "hdrfilm", "width": 32, "height": 32},
            },
            "light": {"type": "point", "position": [2, 2, 3],
                      "intensity": [40, 40, 40]},
            "ball": {"type": "mesh", "mesh": mesh,
                     "bsdf": {"type": "diffuse", "reflectance": 0.7}},
        })[0]

    return {
        "cbox_path": dict(
            scene=lambda: cornell_box(32, 32)[0],
            integ=lambda: PathIntegrator(max_depth=4, rr_depth=9),
            spp=64, ch=3,
        ),
        # the in-repo cbox.xml stand-in (2572 faces, dielectric glass +
        # conductor + diffuse through the XML loader): the brute-force
        # routing regime at a realistic face count, gaussian rfilter
        "cbox_xml": dict(
            scene=_cbox_xml,
            integ=lambda: PathIntegrator(max_depth=4, rr_depth=9),
            spp=32, ch=3,
        ),
        # 20k-face mesh: the big-mesh BVH-walk regime
        "mesh20k_path": dict(
            scene=_mesh20k,
            integ=lambda: PathIntegrator(max_depth=3, rr_depth=9),
            spp=32, ch=3,
        ),
        "cbox_stokes": dict(
            scene=lambda: cornell_box(24, 24, box_material="dielectric")[0],
            integ=lambda: StokesIntegrator(),
            spp=48, ch=15,
        ),
        "grating_plt": dict(
            scene=lambda: grating_scene(24, 24, coherence=1e3)[0],
            integ=lambda: PLTIntegrator(max_depth=3, rr_depth=9),
            spp=48, ch=3,
        ),
    }


def _render_mean_var(cfg_entry, n_runs=4):
    """Render n_runs independent-seed images; return per-pixel mean + var."""
    from mitsuba3_plt_tpu.config import RGB
    from mitsuba3_plt_tpu.integrators.common import render

    scene = cfg_entry["scene"]()
    integ = cfg_entry["integ"]()
    imgs = []
    for seed in range(n_runs):
        imgs.append(
            np.asarray(
                render(scene, integ.sample, seed=seed,
                       spp=cfg_entry["spp"] // n_runs, cfg=RGB,
                       n_out_channels=cfg_entry["ch"])
            )
        )
    imgs = np.stack(imgs)
    return imgs.mean(0), imgs.var(0, ddof=1)


@pytest.mark.parametrize("name", list(_configs().keys()))
def test_golden(name):
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    if not os.path.exists(path):
        pytest.skip(f"golden reference missing: run tests/test_golden.py")
    mean, var = _render_mean_var(_configs()[name])
    n_fail, n_pix, z_max, thresh = z_test(name, mean, var)
    assert n_fail == 0, (
        f"{name}: {n_fail}/{n_pix} pixels fail the z-test "
        f"(max z = {z_max:.1f}, thresh = {thresh:.1f})"
    )


def z_test(name, mean, var):
    """Per-pixel z-test of a 4-run render (mean, var) against the stored
    golden: returns (n_fail, n_pix, max z, Sidak threshold at alpha 0.01)."""
    ref = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    ref_mean, ref_var = ref["mean"], ref["var"]
    # difference of two noisy estimates, 4 runs each
    sigma = np.sqrt((var + ref_var) / 4 + 1e-8)
    z = np.abs(mean - ref_mean) / sigma
    n_pix = z.size
    alpha = 1.0 - (1.0 - 0.01) ** (1.0 / n_pix)
    from scipy.stats import norm

    thresh = norm.isf(alpha / 2)
    return int((z > thresh).sum()), n_pix, float(z.max()), float(thresh)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import sys

    os.makedirs(GOLDEN_DIR, exist_ok=True)
    names = sys.argv[1:] or list(_configs())
    for name in names:
        entry = _configs()[name]
        mean, var = _render_mean_var(entry)
        np.savez_compressed(
            os.path.join(GOLDEN_DIR, f"{name}.npz"), mean=mean, var=var
        )
        print(f"wrote {name}: mean {mean.mean():.4f}")


def test_intersect_routing_tripwire():
    """Pin which intersector each scene class selects. intersect_route IS
    the dispatch (ray_intersect and ray_test both call it), so these
    assertions pin production routing."""
    import mitsuba3_plt_tpu as mi
    from mitsuba3_plt_tpu.scene.presets import CBOX_STANDIN_XML, cornell_box

    # tiny preset (36 tris) and the cbox stand-in (2572 tris): brute force
    tiny = cornell_box(16, 16)[0]
    assert tiny.intersect_route() == "brute"
    cbox = mi.load_file(CBOX_STANDIN_XML, resx=32, resy=32)[0]
    assert cbox.geo.n_faces == 2572
    assert cbox.intersect_route() == "brute"
    assert cbox.intersect_route(brute_force=True) == "brute"

    # big mesh (> brute cap): the XLA skip-link BVH walk, unless forced
    from mitsuba3_plt_tpu.core import transform as tf
    from mitsuba3_plt_tpu.scene import shape as shp

    big = mi.load_dict({
        "type": "scene",
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": tf.look_at([0, 0, 4], [0, 0, 0], [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": 16, "height": 16}},
        "light": {"type": "point", "position": [2, 2, 3],
                  "intensity": [1, 1, 1]},
        "ball": {"type": "mesh", "mesh": shp.make_sphere(subdiv=5),
                 "bsdf": {"type": "diffuse", "reflectance": 0.5}},
    })[0]
    assert big.geo.n_faces > big.BRUTE_FORCE_MAX_FACES
    assert big.intersect_route() == "xla-walk"
    assert big.intersect_route(brute_force=True) == "brute"


def test_filtered_splat_paths_agree():
    """put_ordered_filtered (the segment-sum splat of the render loop) must
    match the scatter splat `put` to float precision."""
    import numpy as np
    import jax.numpy as jnp
    from mitsuba3_plt_tpu.librender.film import ImageBlock, FILTER_NAMES

    W, H, spp = 64, 48, 4
    n = W * H * spp
    rng = np.random.default_rng(0)
    lane = np.arange(n) // spp
    px = lane % W
    py = lane // W
    uv = np.stack(
        [(px + rng.random(n)) / W, (py + rng.random(n)) / H], -1
    ).astype(np.float32)
    vals = rng.random((n, 3)).astype(np.float32)
    ok = rng.random(n) > 0.1
    for fname in ("gaussian", "mitchell", "tent"):
        rf = FILTER_NAMES[fname]
        b0 = ImageBlock.create(W, H, 3, rf)
        a = b0.put_ordered_filtered(
            jnp.asarray(uv), jnp.asarray(vals), jnp.asarray(ok), spp
        )
        b = b0.put(jnp.asarray(uv), jnp.asarray(vals), jnp.asarray(ok))
        np.testing.assert_allclose(
            np.asarray(a.develop()), np.asarray(b.develop()), atol=5e-5,
            err_msg=fname,
        )
