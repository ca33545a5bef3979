"""Smoke test of the renderer on an NVIDIA GPU, through the library's own
entry points.

    python chip_smoke.py              # one card: phases 0-4
    python chip_smoke.py --devices 4  # only the sharded pass over 4 cards

Phases (any failure exits non-zero; nothing is caught and skipped):
  0. device gate: refuse to run unless JAX's first device is a GPU; print
     the card's name and power limit (nvidia-smi), the JAX version and
     whether the native BVH builder loaded.
  1. each fused grating kernel against its plain XLA chain at a real
     wavefront (800x600x4 lanes, 3 channels, separable and 2-D lobe grids).
  2. the golden configs of tests/test_golden.py rendered on the card and
     z-tested against the committed CPU goldens.
  3. full-width renders through mi.render, timed.
  4. gradients: Adam on the Cornell preset, and jax.grad through the
     grating parameters of the gratings preset (the lobe-sum custom_vjp).

The last line of standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Everything runs in this one process, so only one process holds each card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# gratings wavefront: 800x600 pixels at 4 spp per pass
GRATINGS_W, GRATINGS_H, GRATINGS_SPP_PASS = 800, 600, 4
CORNELL_RES = 512   # Cornell preset and the 82k-face mesh, square
CBOX_RES = 500      # the cbox.xml stand-in, square
MAX_FLIP_SHARE = 1e-5  # lobe-sum lanes allowed to flip a boundary lobe
MIN_SAMPLE_AGREE = 0.999  # sample kernel: share of lanes that must agree
MAX_SHARDED_PIXEL_SHARE = 1e-3  # sharded vs one card: pixels that may differ

CARD = ""  # "name, power limit" from nvidia-smi, prefixed to every number


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def require_gpu(devices):
    """Raise unless the first JAX device is a GPU (never fall back to the
    CPU)."""
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "none"
        raise SmokeFailure(f"no GPU: JAX's first device is {found!r}")


def report(msg):
    print(f"[{CARD}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# phase 0
# ---------------------------------------------------------------------------

def phase0_gate():
    global CARD
    import jax

    require_gpu(jax.devices())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    CARD = smi.splitlines()[0].strip()

    from mitsuba3_plt_tpu.scene import native

    print(f"jax {jax.__version__}; devices {len(jax.devices())} x "
          f"{jax.devices()[0].device_kind}; native BVH builder loaded: "
          f"{native._load() is not None}", flush=True)


# ---------------------------------------------------------------------------
# phase 1: kernel parity at real widths
# ---------------------------------------------------------------------------

def _unit_dirs(rng, n):
    v = rng.normal(size=(n, 3))
    v[:, 2] = np.abs(v[:, 2]) + 0.1
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _chunked(fn, n, chunk, *arrays):
    """Apply fn to lane chunks (the plain reference at full width would
    materialize [N, C, L] tensors of several GB)."""
    outs = [fn(*[a[i:i + chunk] for a in arrays]) for i in range(0, n, chunk)]
    if isinstance(outs[0], dict):
        return {k: np.concatenate([np.asarray(o[k]) for o in outs])
                for k in outs[0]}
    return np.concatenate([np.asarray(o) for o in outs])


def phase1_kernels():
    import jax
    import jax.numpy as jnp

    from mitsuba3_plt_tpu.ops import grating_pallas as gp
    from mitsuba3_plt_tpu.scene.presets import grating_scene

    half = int(grating_scene(16, 16)[0].materials.grt_static[0])
    n, c = GRATINGS_W * GRATINGS_H * GRATINGS_SPP_PASS, 3
    rng = np.random.default_rng(0)
    wi, wo = _unit_dirs(rng, n), _unit_dirs(rng, n)
    wl = rng.uniform(380, 680, (n, c)).astype(np.float32)
    gdir = np.stack([np.ones(n), np.zeros(n)], -1).astype(np.float32)
    q = rng.uniform(0.02, 0.3, n).astype(np.float32)
    lobes = rng.choice([3, 5, 7], n).astype(np.int32)
    gt = np.zeros(n, np.int32)
    mult = np.full(n, 1.3, np.float32)
    coh = rng.uniform(1.0, 120.0, n).astype(np.float32)
    a_cone = rng.uniform(0.05, 0.4, n).astype(np.float32)
    rtol, atol = 1e-3, 1e-6

    with jax.default_matmul_precision("highest"):
        for separable, ip_y in ((True, 0.0), (False, 1.5)):
            ip = np.stack([np.full(n, 2.0), np.full(n, ip_y)],
                          -1).astype(np.float32)
            args = [jnp.asarray(x) for x in
                    (wi, wo, wl, gdir, ip, q, lobes, gt, mult, coh, a_cone)]
            got = np.asarray(gp.grating_lobe_sum(
                *args, half=half, separable=separable, n_channels=c))

            ref = jax.jit(lambda *a: gp._lobe_sum_xla(
                *a, half=half, separable=separable))
            f = lambda *a: ref(*a[:6], a[6].astype(jnp.float32),
                               a[7].astype(jnp.float32), *a[8:])
            want = _chunked(f, n, 1 << 18, *args)
            err = np.abs(got - want)
            excess = err - (atol + rtol * np.abs(want))
            # A lobe centred on its acceptance-cone edge (|angle| < a_cone)
            # or on the evanescence edge (|a|, |b| <= 1) is in or out
            # depending on the last ulp, and takes its whole intensity with
            # it: such lanes may flip, the rest must agree.
            flipped = (excess > 0).any(-1)
            check(np.isfinite(got).all(), "lobe sum: non-finite output")
            report(f"phase1 grating_lobe_sum half={half} "
                   f"separable={separable} lanes={n} C={c}: "
                   f"{int(flipped.sum())} lanes flip a boundary lobe (limit "
                   f"{MAX_FLIP_SHARE:g} of lanes); elsewhere max abs err "
                   f"{err[~flipped].max():.3e}, worst |err|-(atol+rtol|ref|) "
                   f"{excess[~flipped].max():.3e} (limit 0: rtol {rtol}, "
                   f"atol {atol})")
            check(flipped.mean() <= MAX_FLIP_SHARE,
                  "lobe sum exceeds its tolerance on too many lanes")

        _phase1_sample(rng, n, half)


def _phase1_sample(rng, n, half):
    import jax
    import jax.numpy as jnp

    from mitsuba3_plt_tpu.librender import microfacet as mf
    from mitsuba3_plt_tpu.ops import grating_pallas as gp
    from mitsuba3_plt_tpu.plt import grating as gr
    from mitsuba3_plt_tpu.plt.wbsdf import grating_sample_xla

    wi = _unit_dirs(rng, n)
    u2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    lu2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    wl_um = rng.uniform(0.38, 0.68, n).astype(np.float32)
    alpha = rng.uniform(0.03, 0.3, (n, 2)).astype(np.float32)
    ip = np.stack([np.full(n, 2.0), np.zeros(n)], -1).astype(np.float32)
    gdir = np.stack([np.ones(n), np.zeros(n)], -1).astype(np.float32)
    q = rng.uniform(0.02, 0.3, n).astype(np.float32)
    lobes = rng.choice([3, 5, 7], n).astype(np.int32)
    gt = np.zeros(n, np.int32)
    mult = np.full(n, 1.1, np.float32)
    args = [jnp.asarray(x) for x in
            (wi, u2, lu2, wl_um, alpha, gdir, ip, q, lobes, gt, mult)]

    got = {k: np.asarray(v) for k, v in gp.grating_sample(
        *args, half=half).items()}

    def xla(wi, u2, lu2, wl_um, alpha, gdir, ip, q, lobes, gt, mult):
        g = gr.Grating(grating_dir=gdir, inv_period=ip, q=q, lobes=lobes,
                       gtype=gt, multiplier=mult)
        return grating_sample_xla(wi, u2, lu2, wl_um, alpha, g, half,
                                  mf.GGX)

    want = _chunked(jax.jit(xla), n, 1 << 18, *args)

    # lanes whose lobe-CDF draw sits on a bucket boundary may flip
    lobe_eq = (got["lobe"] == want["lobe"]).all(-1)
    ok_eq = got["ok"] == want["ok"]
    agree = float((lobe_eq & ok_eq).mean())
    report(f"phase1 grating_sample half={half} lanes={n}: lobe and ok agree "
           f"on {agree:.6f} of lanes (limit >= {MIN_SAMPLE_AGREE})")
    check(agree >= MIN_SAMPLE_AGREE,
          "sample kernel: lobe/ok disagree too often")

    live = lobe_eq & got["ok"] & want["ok"]
    rtol, atol = 1e-3, 1e-5
    for k in ("wo", "mvec", "pdf", "w_g1_int"):
        a, b = got[k][live], want[k][live]
        if k == "pdf":
            # near-specular lanes reach 1/cos^4 blow-ups that differ in the
            # last ulp; pdfs that large are equivalent under MIS
            a, b = np.minimum(a, 1e6), np.minimum(b, 1e6)
        if a.ndim == 2:
            # unit vectors: the error is relative to the vector's length, as
            # a component near zero carries the others' rounding
            err = np.linalg.norm(a - b, axis=-1)
            scale = np.linalg.norm(b, axis=-1)
        else:
            err, scale = np.abs(a - b), np.abs(b)
        # The two forms agree on the microfacet normal to a few 1e-5; near
        # grazing microfacets the Bessel argument 4 pi q / (lambda cos)
        # magnifies that in pdf and intensity, so a small share of lanes
        # may exceed rtol (the same share as lobe flips above).
        beyond = float((err > atol + rtol * scale).mean())
        rel = err / np.maximum(scale, atol)
        report(f"phase1 grating_sample {k}: max abs err {err.max():.3e}; "
               f"share of lanes beyond rtol {rtol}, atol {atol}: "
               f"{beyond:.3e} (limit {1 - MIN_SAMPLE_AGREE:g}); relative "
               f"err 99.99th percentile {np.quantile(rel, 0.9999):.3e}, "
               f"max {rel.max():.3e}")
        check(np.isfinite(a).all() and beyond <= 1 - MIN_SAMPLE_AGREE,
              f"sample kernel: {k} exceeds its tolerance on too many lanes")


# ---------------------------------------------------------------------------
# phase 2: golden z-tests on the card
# ---------------------------------------------------------------------------

def phase2_golden():
    spec = importlib.util.spec_from_file_location(
        "golden", os.path.join(ROOT, "tests", "test_golden.py"))
    golden = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(golden)
    for name, entry in golden._configs().items():
        t0 = time.perf_counter()
        mean, var = golden._render_mean_var(entry)
        n_fail, n_pix, z_max, thresh = golden.z_test(name, mean, var)
        report(f"phase2 golden {name}: {n_fail}/{n_pix} pixels fail, max z "
               f"{z_max:.2f} (Sidak threshold {thresh:.2f}), "
               f"{time.perf_counter() - t0:.1f} s")
        check(np.isfinite(mean).all() and n_fail == 0,
              f"golden {name} fails its z-test on the card")


# ---------------------------------------------------------------------------
# phase 3: full-width renders through mi.render
# ---------------------------------------------------------------------------

def _timed_render(label, scene, integrator, spp, **kw):
    import mitsuba3_plt_tpu as mi

    stats = {}
    img = np.asarray(mi.render(scene, integrator=integrator, spp=spp,
                               seed=0, stats=stats, **kw))
    w, h = (scene[0] if isinstance(scene, tuple) else scene).sensor.resolution
    spp_pass = stats["spp_done"] // stats["passes_done"]
    dt = stats["steady_s_per_pass"]
    report(f"phase3 {label} {w}x{h} spp/pass {spp_pass}: compile_s "
           f"{stats['compile_s']}, ms/spp {dt / spp_pass * 1e3:.3f}, "
           f"camera samples/s {w * h * spp_pass / dt:.4g}")
    check(np.isfinite(img).all(), f"{label}: non-finite pixels")
    check(float(np.abs(img).mean()) > 0.0, f"{label}: image is all zero")
    return img


def mesh82k_scene(width, height):
    """81,920-face icosphere under a point light (above the brute cap)."""
    import mitsuba3_plt_tpu as mi
    from mitsuba3_plt_tpu.core import transform as tf
    from mitsuba3_plt_tpu.scene import shape as shp

    return mi.load_dict({
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 4},
        "sensor": {
            "type": "perspective", "fov": 45,
            "to_world": tf.look_at([0, 0, 4], [0, 0, 0], [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": width, "height": height},
        },
        "light": {"type": "point", "position": [2, 2, 3],
                  "intensity": [40, 40, 40]},
        "ball": {"type": "mesh", "mesh": shp.make_sphere(subdiv=6),
                 "bsdf": {"type": "diffuse", "reflectance": 0.7}},
    })


def phase3_renders():
    import mitsuba3_plt_tpu as mi
    from mitsuba3_plt_tpu.config import RGB_POLARIZED
    from mitsuba3_plt_tpu.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu.integrators.plt import PLTIntegrator
    from mitsuba3_plt_tpu.scene.presets import (
        CBOX_STANDIN_XML, cornell_box, grating_scene,
    )

    W, H = GRATINGS_W, GRATINGS_H
    gscene = grating_scene(W, H)
    _timed_render("gratings PLT", gscene, PLTIntegrator(max_depth=7, rr_depth=50), spp=16,
                  spp_per_pass=GRATINGS_SPP_PASS)
    _timed_render("gratings PLT rgb_polarized", gscene, PLTIntegrator(max_depth=7, rr_depth=50),
                  spp=8, spp_per_pass=2, cfg=RGB_POLARIZED)
    _timed_render("cornell preset path", cornell_box(CORNELL_RES, CORNELL_RES),
                  PathIntegrator(max_depth=7, rr_depth=50), spp=32,
                  spp_per_pass=8)
    _timed_render("cbox stand-in (xml, gaussian)",
                  mi.load_file(CBOX_STANDIN_XML, resx=CBOX_RES, resy=CBOX_RES),
                  PathIntegrator(max_depth=7, rr_depth=50), spp=32,
                  spp_per_pass=8)
    _timed_render("mesh82k path regen", mesh82k_scene(CORNELL_RES, CORNELL_RES),
                  PathIntegrator(max_depth=4, rr_depth=3), spp=16,
                  spp_per_pass=4, regen=True)


# ---------------------------------------------------------------------------
# phase 4: gradients
# ---------------------------------------------------------------------------

def phase4_gradients():
    import jax
    import jax.numpy as jnp

    from mitsuba3_plt_tpu.ad import traverse
    from mitsuba3_plt_tpu.ad.optimizers import Adam
    from mitsuba3_plt_tpu.ad.render import render_differentiable
    from mitsuba3_plt_tpu.config import RGB
    from mitsuba3_plt_tpu.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu.integrators.plt import PLTIntegrator
    from mitsuba3_plt_tpu.ops import grating_pallas as gp
    from mitsuba3_plt_tpu.scene.presets import cornell_box, grating_scene

    # Adam on the Cornell preset's albedos towards a darker-wall target
    scene, _ = cornell_box(128, 128)
    integ = PathIntegrator(max_depth=4, rr_depth=8)
    params = traverse(scene)
    key = "materials.base_color"
    target = render_differentiable(
        params.update({key: params[key].at[0].multiply(0.5)}),
        integ.sample, seed=0, spp=8, cfg=RGB)

    def loss_of(p):
        img = render_differentiable(params.update(p), integ.sample, seed=0,
                                    spp=8, cfg=RGB)
        return jnp.mean((img - target) ** 2)

    grad_fn = jax.jit(jax.value_and_grad(loss_of))
    opt = Adam(lr=0.1)
    p = {key: params[key]}
    state = opt.init(p)
    losses = []
    for _ in range(2):
        loss, grads = grad_fn(p)
        check(np.isfinite(np.asarray(grads[key])).all(),
              "Adam: non-finite gradient")
        losses.append(float(loss))
        p, state = opt.step(p, grads, state)
    losses.append(float(grad_fn(p)[0]))
    report(f"phase4 Adam on cornell 128x128 {key}: loss "
           f"{' -> '.join(f'{x:.6g}' for x in losses)}")
    check(losses[-1] < losses[0], "Adam: the loss did not go down")

    # jax.grad through the grating parameters: the kernel primal with its
    # XLA backward, against autodiff of the plain XLA lobe sum
    gscene, _ = grating_scene(128, 96)
    plt_integ = PLTIntegrator(max_depth=3, rr_depth=8)
    gparams = traverse(gscene)
    keys = ("materials.grt_height", "materials.grt_inv_period",
            "materials.grt_multiplier", "materials.grt_coherence")

    def grating_grad():
        def f(p):
            img = render_differentiable(gparams.update(p), plt_integ.sample,
                                        seed=0, spp=4, cfg=RGB)
            return jnp.mean(img)

        g = jax.jit(jax.grad(f))({k: gparams[k] for k in keys})
        return {k: np.asarray(v) for k, v in g.items()}

    g_kernel = grating_grad()
    kernel_lobe_sum = gp.grating_lobe_sum

    def xla_lobe_sum(wi, wo, wl_nm, gd, ip, q, lobes, gtype, mult, coh,
                     a_cone, half, separable, n_channels):
        return gp._lobe_sum_xla(
            wi, wo, wl_nm, gd, ip, q, lobes.astype(jnp.float32),
            gtype.astype(jnp.float32), mult, coh, a_cone, half=half,
            separable=separable)

    gp.grating_lobe_sum = xla_lobe_sum
    try:
        g_xla = grating_grad()
    finally:
        gp.grating_lobe_sum = kernel_lobe_sum
    rtol, atol = 1e-3, 1e-9
    for k in keys:
        a, b = g_kernel[k], g_xla[k]
        check(np.isfinite(a).all(), f"grating grad {k}: non-finite")
        err = np.abs(a - b)
        excess = (err - (atol + rtol * np.abs(b))).max()
        report(f"phase4 grating grad {k}: max |grad| {np.abs(b).max():.4e}, "
               f"max abs err vs XLA {err.max():.3e}, worst "
               f"|err|-(atol+rtol|ref|) {excess:.3e} (limit 0: rtol {rtol})")
        check(excess <= 0.0, f"grating grad {k} differs from the XLA grad")
    check(any(np.abs(g_kernel[k]).max() > 0 for k in keys),
          "grating grads are all zero")


# ---------------------------------------------------------------------------
# --devices 4: the sharded pass
# ---------------------------------------------------------------------------

def phase_sharded(n_dev):
    import jax

    from mitsuba3_plt_tpu.config import RGB
    from mitsuba3_plt_tpu.integrators.common import render
    from mitsuba3_plt_tpu.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu.integrators.plt import PLTIntegrator
    from mitsuba3_plt_tpu.parallel.render import (
        make_mesh, make_render_pass_sharded,
    )
    from mitsuba3_plt_tpu.scene.presets import cornell_box, grating_scene

    check(len(jax.devices()) >= n_dev,
          f"--devices {n_dev}: only {len(jax.devices())} devices")
    mesh = make_mesh(n_dev)
    # The sharded film is a scatter-add `put` (atomics, no fixed order)
    # against the single card's ordered segment sums, so pixel sums may
    # differ in their last bits: rtol 2e-5 as on the CPU mesh. Besides, each
    # card runs a program compiled for a quarter of the lanes, which XLA may
    # fuse and round differently; a sample on a discrete boundary (lobe
    # CDF, acceptance cone, evanescence) then takes another path and its
    # pixel moves by that sample's whole value. Such pixels must be rare
    # and spread over all shards.
    rtol, atol = 2e-5, 2e-6
    cases = (
        ("gratings PLT", grating_scene(GRATINGS_W, GRATINGS_H)[0],
         PLTIntegrator(max_depth=7, rr_depth=50), GRATINGS_SPP_PASS),
        ("cornell preset path", cornell_box(CORNELL_RES, CORNELL_RES)[0],
         PathIntegrator(max_depth=7, rr_depth=50), 8),
    )
    for label, scene, integ, spp in cases:
        w, h = scene.sensor.resolution
        single = np.asarray(render(scene, integ.sample, seed=0, spp=spp,
                                   cfg=RGB, spp_per_pass=spp))
        run = make_render_pass_sharded(integ.sample, mesh, w, h, spp, RGB)
        t0 = time.perf_counter()
        hlo = run.lower(scene, 0, 0).compile().as_text()
        compile_s = time.perf_counter() - t0
        check(f"num_partitions={n_dev}" in hlo,
              f"{label}: the pass is not partitioned over {n_dev} devices")
        run(scene, 0, 0).block_until_ready()
        t0 = time.perf_counter()
        data = run(scene, 0, 1)
        data.block_until_ready()
        dt = time.perf_counter() - t0
        data = np.asarray(run(scene, 0, 0))
        img = (data[..., :3] / np.maximum(data[..., 3:4], 1e-8)).reshape(
            h, w, 3)
        err = np.abs(img - single)
        bad = (err > atol + rtol * np.abs(single)).any(-1)  # [h, w]
        # lanes are pixel-major and split in contiguous quarters, so card
        # d renders rows [d h / n, (d + 1) h / n)
        per_card = [int(b.sum()) for b in np.array_split(bad, n_dev)]
        mean_rel = abs(img.mean() - single.mean()) / abs(single.mean())
        report(f"sharded {label} {w}x{h} spp {spp} on {n_dev} devices: "
               f"compile_s {compile_s:.2f}, ms/spp {dt / spp * 1e3:.3f}; "
               f"vs one card: max abs err {err.max():.3e}, pixels beyond "
               f"rtol {rtol}, atol {atol}: {bad.mean():.3e} of {h * w} "
               f"(limit {MAX_SHARDED_PIXEL_SHARE:g}), per card {per_card}; "
               f"image mean {img.mean():.6e} vs {single.mean():.6e} "
               f"(relative {mean_rel:.3e})")
        check(np.isfinite(img).all() and bad.mean() <= MAX_SHARDED_PIXEL_SHARE,
              f"sharded {label} differs from the single-card pass")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="4: run only the sharded pass over 4 cards")
    args = ap.parse_args(argv)

    import jax

    phase0_gate()
    if args.devices > 1:
        phase_sharded(args.devices)
    else:
        for phase in (phase1_kernels, phase2_golden, phase3_renders,
                      phase4_gradients):
            t0 = time.perf_counter()
            phase()
            report(f"{phase.__name__} done in "
                   f"{time.perf_counter() - t0:.1f} s")
    dev = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": dev[0].platform, "kind": dev[0].device_kind,
        "count": len(dev)}}))


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
