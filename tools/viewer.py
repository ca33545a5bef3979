"""Headless viewer / animation tool — the fork's GUI-layer role
(reference scripts/rendering/gui/gui.py ttkbootstrap viewer +
scripts/rendering/disk_animation cv2 turntable) redesigned for a display-
less accelerator host: progressive rendering with live PNG snapshots an external
viewer can poll, polarization false-color inspection modes, and camera-
orbit animation written as a PNG sequence + animated GIF.

Usage:
  view a scene (progressive snapshots + final outputs):
    PYTHONPATH=. python tools/viewer.py scene.xml -o out/ --spp 256 \
        [--mode rgb|dolp|aolp|s1|s2|s3] [-D key=value ...]
  turntable animation (disk_animation role):
    PYTHONPATH=. python tools/viewer.py scene.xml -o out/ --animate 24 \
        --orbit-axis y --spp 64 [--gif]

Outputs: out/result.png (+ result.exr via the native codec), out/<mode>.png
for polarization modes (stokes-wrapped render), out/frame_###.png and
out/anim.gif for animations, out/params.json timing (the reference
main-headless.py convention).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _parse_overrides(pairs):
    out = {}
    for p in pairs or ():
        k, _, v = p.partition("=")
        out[k] = v
    return out


def _orbit_sensor(sensor, angle_deg: float, axis: str, target=None):
    """Rotate the camera's to_world about the orbit axis through the
    LOOK-AT target: T(t) @ R @ T(-t) @ tw. `target` defaults to the point
    the camera faces at the distance of the world origin (the subject for
    origin-centered scenes); pass the scene centroid for off-center ones."""
    import dataclasses

    import jax.numpy as jnp

    from mitsuba3_plt_tpu.core import transform as tf

    tw = np.asarray(sensor.to_world)
    if target is None:
        cam_o = tw[:3, 3]
        fwd = tw[:3, 2] / max(np.linalg.norm(tw[:3, 2]), 1e-9)
        target = cam_o + fwd * np.linalg.norm(cam_o)
    t = np.asarray(target, np.float64)
    ax = {"x": [1.0, 0, 0], "y": [0, 1.0, 0], "z": [0, 0, 1.0]}[axis]
    R = np.asarray(tf.rotate(ax, angle_deg), np.float64)
    T_f = np.eye(4)
    T_f[:3, 3] = t
    T_b = np.eye(4)
    T_b[:3, 3] = -t
    tw2 = (T_f @ R @ T_b @ tw).astype(np.float32)
    return dataclasses.replace(sensor, to_world=jnp.asarray(tw2))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("scene")
    ap.add_argument("-o", "--out", default="viewer_out")
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--resx", type=int, default=None)
    ap.add_argument("--resy", type=int, default=None)
    ap.add_argument("--mode", default="rgb",
                    choices=["rgb", "dolp", "aolp", "s1", "s2", "s3"])
    ap.add_argument("-D", "--define", action="append", default=[],
                    help="scene default overrides key=value")
    ap.add_argument("--exposure", type=float, default=1.0)
    ap.add_argument("--animate", type=int, default=0, metavar="N_FRAMES",
                    help="render an N-frame camera orbit")
    ap.add_argument("--orbit-axis", default="y", choices=["x", "y", "z"])
    ap.add_argument("--orbit-degrees", type=float, default=360.0)
    ap.add_argument("--gif", action="store_true",
                    help="also write out/anim.gif (PIL)")
    ap.add_argument("--snapshot-every", type=int, default=4,
                    help="write a progressive snapshot PNG every K passes")
    args = ap.parse_args(argv)

    import dataclasses

    import mitsuba3_plt_tpu as mi
    from mitsuba3_plt_tpu.utils.io import tonemap_srgb, write_bitmap

    os.makedirs(args.out, exist_ok=True)
    kw = {}
    if args.resx:
        kw["resx"] = args.resx
    if args.resy:
        kw["resy"] = args.resy
    scene, meta = mi.load_file(
        args.scene, parameters=_parse_overrides(args.define), **kw
    )
    w, h = scene.sensor.resolution

    polarized = args.mode != "rgb"
    integ = None
    cfg = mi.config()
    if polarized:
        from mitsuba3_plt_tpu.config import RGB_POLARIZED
        from mitsuba3_plt_tpu.integrators import make_integrator
        from mitsuba3_plt_tpu.integrators.stokes import StokesIntegrator

        cfg = RGB_POLARIZED
        integ = StokesIntegrator()

    def develop(img):
        img = np.asarray(img)
        if not polarized:
            return tonemap_srgb(img[..., :3], args.exposure)
        from mitsuba3_plt_tpu.utils.polvis import polvis

        if args.mode in ("dolp", "aolp"):
            v = np.asarray(polvis(img, mode=args.mode))
            if v.dtype != np.uint8:
                v = (np.clip(v, 0.0, 1.0) * 255).astype(np.uint8)
            return v
        k = {"s1": 1, "s2": 2, "s3": 3}[args.mode]
        s = img[..., 3 + 3 * k: 6 + 3 * k].mean(-1)
        # diverging false color: red positive, blue negative
        mx = max(float(np.abs(s).max()), 1e-9)
        r = np.clip(s / mx, 0, 1)
        b = np.clip(-s / mx, 0, 1)
        return (np.stack([r, 0.1 * (r + b), b], -1) * 255).astype(np.uint8)

    def save_png(path, arr8):
        from PIL import Image

        Image.fromarray(arr8).save(path)

    t0 = time.perf_counter()
    if args.animate:
        frames = []
        per = args.orbit_degrees / args.animate
        # orbit about the scene centroid so off-origin subjects stay framed
        geo = scene.geo
        tri_c = (np.asarray(geo.tri_p0) + np.asarray(geo.tri_p1)
                 + np.asarray(geo.tri_p2)) / 3.0
        target = tri_c.mean(axis=0) if tri_c.size else None
        for i in range(args.animate):
            s_i = dataclasses.replace(
                scene, sensor=_orbit_sensor(scene.sensor, per * i,
                                            args.orbit_axis, target=target)
            )
            img = mi.render((s_i, meta), integrator=integ, spp=args.spp,
                            seed=i, cfg=cfg)
            arr8 = develop(img)
            save_png(os.path.join(args.out, f"frame_{i:03d}.png"), arr8)
            frames.append(arr8)
            print(f"frame {i + 1}/{args.animate}", file=sys.stderr)
        if args.gif:
            from PIL import Image

            ims = [Image.fromarray(f) for f in frames]
            ims[0].save(
                os.path.join(args.out, "anim.gif"), save_all=True,
                append_images=ims[1:], duration=80, loop=0,
            )
    else:
        snaps = {"n": 0}

        def progress(done, total, elapsed):
            print(f"pass {done}/{total} ({elapsed:.1f}s)", file=sys.stderr)
            snaps["n"] = done

        stats = {}
        img = mi.render((scene, meta), integrator=integ, spp=args.spp,
                        seed=0, cfg=cfg, stats=stats, progress=progress)
        arr8 = develop(img)
        name = "result" if args.mode == "rgb" else args.mode
        save_png(os.path.join(args.out, f"{name}.png"), arr8)
        if args.mode == "rgb":
            write_bitmap(os.path.join(args.out, "result.exr"),
                         np.asarray(img)[..., :3])
        with open(os.path.join(args.out, "params.json"), "w") as f:
            json.dump(
                {
                    "bitmap_size": {"width": w, "height": h},
                    "samples": args.spp,
                    "time": f"{(time.perf_counter() - t0) / 60:.3f} m",
                    "time_per_sample":
                        f"{(time.perf_counter() - t0) / args.spp * 1e3} ms",
                    **stats,
                },
                f, indent=2,
            )
    print(f"done in {time.perf_counter() - t0:.1f}s -> {args.out}/")


if __name__ == "__main__":
    main()
