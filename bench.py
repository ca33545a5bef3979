"""Benchmark harness: renders the flagship PLT gratings workload (and the
classic-path Cornell box) on one NVIDIA GPU and prints ONE JSON line
{"metric", "value", "unit", "vs_baseline", "device", "extra"}. It refuses to
run without a GPU; "device" names the card and its power limit.

Baseline anchors (BASELINE.md, the reference on its own GPU; the scenes here
are in-repo stand-ins, so vs_baseline is approximate):
  * gratings.xml 800x600 PLT: ~104 ms/spp at 256 spp => ~4.6 M camera
    samples/s (results/grating-spp/plt/params_256.json) — the headline
    metric: it exercises the wave-BSDF lobe sum, the two-phase
    sample-solve integrator, and the diffraction sampling path.
  * Cornell box classic path: 500^2 / 44.64 ms-per-spp => ~5.6 M camera
    samples/s (results/cbox-path/params.json) — reported in "extra".

Methodology: one jitted pass function built once (scene passed as an
argument, not a closure constant), one warmup call for compilation, then
the median of repeated timed passes. Compile and steady-state are reported
separately (the reference's params.json reports steady render time).
"""
from __future__ import annotations

import json
import subprocess
import time

REF_GRATINGS_SAMPLES_PER_S = 4.6e6  # BASELINE.md grating-spp anchor
REF_CBOX_SAMPLES_PER_S = 5.6e6      # BASELINE.md cbox-path anchor


def _device():
    """The GPU this runs on; raises without one (never falls back)."""
    import jax

    dev = jax.devices()
    if dev[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev[0].platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return {"platform": dev[0].platform, "kind": dev[0].device_kind,
            "count": len(dev), "card": card}


def _time_pass(render_pass, data, n_timed=3):
    t0 = time.perf_counter()
    data = render_pass(data, 0)
    data.block_until_ready()
    compile_s = time.perf_counter() - t0
    times = []
    for p in range(1, n_timed + 1):
        t0 = time.perf_counter()
        data = render_pass(data, p)
        data.block_until_ready()
        times.append(time.perf_counter() - t0)
    return compile_s, sorted(times)[len(times) // 2]


def bench_gratings():
    import jax
    import jax.numpy as jnp

    from mitsuba3_plt_tpu.config import RGB
    from mitsuba3_plt_tpu.core.rng import Sampler
    from mitsuba3_plt_tpu.integrators.common import sample_rays
    from mitsuba3_plt_tpu.integrators.plt import PLTIntegrator
    from mitsuba3_plt_tpu.librender.film import ImageBlock
    from mitsuba3_plt_tpu.scene.presets import grating_scene

    W, H, spp_pass = 800, 600, 4
    # the preset carries gratings.xml's grating parameters
    scene, _ = grating_scene(W, H)
    # anchor-exact integrator config: the reference harness overrides every
    # recorded run to max_depth=7, rr_depth=50 (render.py:21-28)
    integ = PLTIntegrator(max_depth=7, rr_depth=50)

    @jax.jit
    def render_pass(block_data, pass_idx):
        sampler = Sampler.create(0, W * H * spp_pass).fork_traced(pass_idx)
        ray, uv, wl, _ = sample_rays(scene, sampler, W, H, spp_pass, RGB)
        values, valid = integ.sample(scene, sampler, ray, wl, RGB)
        block = ImageBlock(
            data=block_data, width=W, height=H, n_channels=3, rfilter=0
        )
        return block.put_ordered(values, valid, spp_pass).data

    data = ImageBlock.create(W, H, 3).data
    compile_s, dt = _time_pass(render_pass, data)
    return {
        "samples_per_s": W * H * spp_pass / dt,
        "ms_per_spp": dt / spp_pass * 1e3,
        "compile_s": compile_s,
    }


def bench_cbox():
    import jax
    import jax.numpy as jnp

    from mitsuba3_plt_tpu.config import RGB
    from mitsuba3_plt_tpu.core.rng import Sampler
    from mitsuba3_plt_tpu.integrators.common import sample_rays
    from mitsuba3_plt_tpu.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu.librender.film import ImageBlock
    from mitsuba3_plt_tpu.scene.presets import cornell_box

    W = H = 512
    spp_pass = 8
    scene, _ = cornell_box(W, H)
    # anchor-exact depth/RR (render.py:21-28: max_depth=7, rr_depth=50)
    integ = PathIntegrator(max_depth=7, rr_depth=50)

    @jax.jit
    def render_pass(block_data, pass_idx):
        sampler = Sampler.create(0, W * H * spp_pass).fork_traced(pass_idx)
        ray, uv, wl, _ = sample_rays(scene, sampler, W, H, spp_pass, RGB)
        values, valid = integ.sample(scene, sampler, ray, wl, RGB)
        block = ImageBlock(
            data=block_data, width=W, height=H, n_channels=3, rfilter=0
        )
        return block.put_ordered(values, valid, spp_pass).data

    data = ImageBlock.create(W, H, 3).data
    compile_s, dt = _time_pass(render_pass, data)
    return {
        "samples_per_s": W * H * spp_pass / dt,
        "ms_per_spp": dt / spp_pass * 1e3,
        "compile_s": compile_s,
    }


def bench_mesh_heavy():
    """81,920-face tessellated sphere through the BVH walk — tracks
    large-scene throughput (the only scene above the brute-force cap)."""
    import jax
    import jax.numpy as jnp

    import mitsuba3_plt_tpu as mi
    from mitsuba3_plt_tpu.config import RGB
    from mitsuba3_plt_tpu.core import transform as tf
    from mitsuba3_plt_tpu.core.rng import Sampler
    from mitsuba3_plt_tpu.integrators.common import sample_rays
    from mitsuba3_plt_tpu.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu.librender.film import ImageBlock
    from mitsuba3_plt_tpu.scene import shape as shp

    W = H = 512
    spp_pass = 4
    mesh = shp.make_sphere(subdiv=6)  # 81,920 faces > BRUTE_FORCE_MAX_FACES
    scene, _ = mi.load_dict({
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 4},
        "sensor": {
            "type": "perspective", "fov": 45,
            "to_world": tf.look_at([0, 0, 4], [0, 0, 0], [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": W, "height": H},
        },
        "light": {"type": "point", "position": [2, 2, 3],
                  "intensity": [40, 40, 40]},
        "ball": {"type": "mesh", "mesh": mesh,
                 "bsdf": {"type": "diffuse", "reflectance": 0.7}},
    })
    integ = PathIntegrator(max_depth=4, rr_depth=3)

    # regenerative wavefront (path.sample_regen): finished lanes respawn on
    # their next strided sample instead of idling out the bounce scan —
    # bit-identical output (tests/test_regen.py). MORTON pixel layout:
    # neighbouring lanes cover a square image block instead of a scanline
    # strip (output unscrambled by the static inverse permutation).
    from mitsuba3_plt_tpu.core.rng import hash_combine
    from mitsuba3_plt_tpu.integrators.common import morton_pixel_perm
    import numpy as np

    total = W * H * spp_pass
    n_lanes = total // 8
    mp = morton_pixel_perm(W, H)           # morton slot -> scanline pixel
    inv_mp = np.empty_like(mp)
    inv_mp[mp] = np.arange(len(mp))        # scanline pixel -> morton slot
    inv_mp_j = jnp.asarray(inv_mp)

    @jax.jit
    def render_pass(block_data, pass_idx):
        seed = hash_combine(jnp.uint32(0), pass_idx)
        values = integ.sample_regen(
            scene, seed, W, H, spp_pass, RGB, n_lanes, pixel_order="morton"
        )
        sums = values.reshape(W * H, spp_pass, 3).sum(axis=1)
        return block_data + sums[inv_mp_j].reshape(H, W, 3) / spp_pass

    data = jnp.zeros((H, W, 3), jnp.float32)
    compile_s, dt = _time_pass(render_pass, data)
    return {
        "samples_per_s": W * H * spp_pass / dt,
        "ms_per_spp": dt / spp_pass * 1e3,
        "compile_s": compile_s,
        "n_faces": int(mesh.faces.shape[0]),
    }


def bench_cbox_xml():
    """The in-repo stand-in for the reference's cbox.xml (2572 faces,
    gaussian rfilter) via the library-surface render loop — the comparison
    against the cbox-path anchor (the preset metric above uses a
    36-triangle box and flatters the intersection cost)."""
    import mitsuba3_plt_tpu as mi

    import numpy as np

    from mitsuba3_plt_tpu.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu.scene.presets import CBOX_STANDIN_XML

    scene, meta = mi.load_file(CBOX_STANDIN_XML, resx=500, resy=500)
    stats = {}
    # anchor-exact depth/RR (render.py:21-28), not the scene's max_depth=6
    np.asarray(mi.render(
        (scene, meta), integrator=PathIntegrator(max_depth=7, rr_depth=50),
        spp=64, seed=0, stats=stats,
    ))
    spp_pass = stats["spp_done"] // stats["passes_done"]
    dt = stats["steady_s_per_pass"]
    return {
        "samples_per_s": 500 * 500 * spp_pass / dt,
        "ms_per_spp": dt / spp_pass * 1e3,
        "compile_s": stats["compile_s"],
    }


def bench_cbox_xml_polarized():
    """Polarized, stokes-wrapped cbox.xml stand-in through the render loop —
    the configuration the reference anchor actually ran
    (main-headless.py:128-133 renders in cuda_ad_rgb_polarized with the
    integrator wrapped in `stokes`): Mueller 4x4xC throughput, S0..S3 AOV
    develop, gaussian rfilter. Divided against the SAME 44.64 ms/spp
    anchor as the RGB row, so no headline uses an easier config than its
    denominator."""
    import numpy as np

    import mitsuba3_plt_tpu as mi
    from mitsuba3_plt_tpu.config import RGB_POLARIZED
    from mitsuba3_plt_tpu.integrators.stokes import StokesIntegrator
    from mitsuba3_plt_tpu.scene.presets import CBOX_STANDIN_XML

    scene, meta = mi.load_file(CBOX_STANDIN_XML, resx=500, resy=500)
    from mitsuba3_plt_tpu.integrators.stokes import (
        PolarizedPathIntegrator, depolarizer_collapse_ok,
    )

    # the anchor's EXACT integrator config: the reference harness wraps in
    # `stokes` and OVERRIDES max_depth=7, rr_depth=50 (scripts/rendering/
    # utils/render.py:21-28), not the scene's max_depth=6
    integ = StokesIntegrator(
        inner=PolarizedPathIntegrator(max_depth=7, rr_depth=50),
        forward_basis=False,
    )
    stats = {}
    # an all-diffuse scene takes the static depolarizer collapse (the
    # Stokes transport runs the scalar chain, pinned by
    # tests/test_stokes.py) and the default wavefront; scenes with
    # polarizing lobes (the stand-in's conductor and glass) carry
    # [N, 4, 4, C] Mueller throughput and use small passes (spp 2/pass).
    kw = {} if depolarizer_collapse_ok(scene) else {"spp_per_pass": 2}
    np.asarray(
        mi.render(
            (scene, meta), integrator=integ, spp=32, seed=0,
            cfg=RGB_POLARIZED, stats=stats, **kw,
        )
    )
    spp_pass = stats["spp_done"] // stats["passes_done"]
    dt = stats["steady_s_per_pass"]
    return {
        "samples_per_s": 500 * 500 * spp_pass / dt,
        "ms_per_spp": dt / spp_pass * 1e3,
        "compile_s": stats["compile_s"],
    }


def bench_gratings_polarized():
    """Polarized PLT on the gratings preset through the library render loop
    (grating-spp anchor): the wave BSDF produces Mueller-valued weights and
    the Stokes film records S0."""
    import numpy as np

    import mitsuba3_plt_tpu as mi
    from mitsuba3_plt_tpu.config import RGB_POLARIZED
    from mitsuba3_plt_tpu.integrators.plt import PLTIntegrator
    from mitsuba3_plt_tpu.scene.presets import grating_scene

    scene, meta = grating_scene(800, 600)
    integ = PLTIntegrator(max_depth=7, rr_depth=50)  # anchor-exact config
    stats = {}
    # polarized wave path: full Mueller chain through the wave BSDF, at a
    # 960k-lane wavefront (2 spp/pass)
    np.asarray(
        mi.render(
            (scene, meta), integrator=integ, spp=16, seed=0,
            cfg=RGB_POLARIZED, stats=stats, spp_per_pass=2,
        )
    )
    spp_pass = stats["spp_done"] // stats["passes_done"]
    dt = stats["steady_s_per_pass"]
    return {
        "samples_per_s": 800 * 600 * spp_pass / dt,
        "ms_per_spp": dt / spp_pass * 1e3,
        "compile_s": stats["compile_s"],
    }


def main():
    device = _device()
    g = bench_gratings()
    c = bench_cbox()
    cx = bench_cbox_xml()
    mh = bench_mesh_heavy()
    cxp = bench_cbox_xml_polarized()
    gp = bench_gratings_polarized()
    print(
        json.dumps(
            {
                "metric": "gratings_plt_camera_samples_per_s",
                "value": round(g["samples_per_s"], 1),
                "unit": "samples/s",
                "device": device,
                "vs_baseline": round(
                    g["samples_per_s"] / REF_GRATINGS_SAMPLES_PER_S, 4
                ),
                "extra": {
                    "gratings_ms_per_spp": round(g["ms_per_spp"], 2),
                    "gratings_compile_s": round(g["compile_s"], 2),
                    "cbox_path_camera_samples_per_s": round(
                        c["samples_per_s"], 1
                    ),
                    "cbox_vs_baseline": round(
                        c["samples_per_s"] / REF_CBOX_SAMPLES_PER_S, 4
                    ),
                    "cbox_ms_per_spp": round(c["ms_per_spp"], 3),
                    "cbox_compile_s": round(c["compile_s"], 2),
                    "cbox_xml_camera_samples_per_s": round(
                        cx["samples_per_s"], 1
                    ),
                    "cbox_xml_vs_baseline": round(
                        cx["samples_per_s"] / REF_CBOX_SAMPLES_PER_S, 4
                    ),
                    "cbox_xml_ms_per_spp": round(cx["ms_per_spp"], 3),
                    "mesh82k_camera_samples_per_s": round(
                        mh["samples_per_s"], 1
                    ),
                    "mesh82k_ms_per_spp": round(mh["ms_per_spp"], 3),
                    "mesh82k_compile_s": round(mh["compile_s"], 2),
                    "cbox_xml_polarized_camera_samples_per_s": round(
                        cxp["samples_per_s"], 1
                    ),
                    "cbox_xml_polarized_vs_baseline": round(
                        cxp["samples_per_s"] / REF_CBOX_SAMPLES_PER_S, 4
                    ),
                    "cbox_xml_polarized_ms_per_spp": round(
                        cxp["ms_per_spp"], 3
                    ),
                    "gratings_polarized_camera_samples_per_s": round(
                        gp["samples_per_s"], 1
                    ),
                    "gratings_polarized_vs_baseline": round(
                        gp["samples_per_s"] / REF_GRATINGS_SAMPLES_PER_S, 4
                    ),
                    "gratings_polarized_ms_per_spp": round(
                        gp["ms_per_spp"], 3
                    ),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
