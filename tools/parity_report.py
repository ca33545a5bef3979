"""Reference-parity report: render the scenes the reference ships results
for, at matched resolution, and compare against its actual output
(results/*/result*.exr decoded with the native PIZ codec; tonemapped PNGs
where no HDR reference exists).

Reference scheme: src/render/tests/test_renders.py:159-232 compares per-
pixel z-tests against stored references; here we report RMSE / relMSE and
a tonemapped 8-bit mean|diff| so residual MC noise in our render reads
directly (the references are converged: 4096-8192 spp).

Usage: PYTHONPATH=. python tools/parity_report.py [--spp 512] [--out docs/PARITY.md]
Runs on whatever backend JAX picks (the GPU when available).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REF = "/root/reference"


def render_scene(xml, w, h, spp, integrator=None, rfilter=None,
                 mat_override=None):
    """mat_override: optional (mtype_tag, field, value) — sets
    materials.<field> rows of every material with that type tag (the
    traverse-path analog of the reference's --override key=value on
    roughgrating params, tools/experiments/conventional.ps1)."""
    import mitsuba3_plt_tpu as mi

    scene, meta = mi.load_file(xml, resx=w, resy=h)
    if mat_override is not None:
        import dataclasses as _dc

        import jax.numpy as jnp

        tag, field, value = mat_override
        mats = scene.materials
        sel = np.asarray(mats.mtype) == tag
        arr = np.asarray(getattr(mats, field)).copy()
        arr[sel] = value
        mats = _dc.replace(mats, **{field: jnp.asarray(arr)})
        scene = _dc.replace(scene, materials=mats)
    if integrator or rfilter:
        meta = dict(meta)
    if integrator:
        meta["integrator"] = dict(meta.get("integrator") or {})
        meta["integrator"]["type"] = integrator
    if rfilter:
        meta["rfilter"] = rfilter
    t0 = time.perf_counter()
    img = np.asarray(mi.render((scene, meta), spp=spp))
    dt = time.perf_counter() - t0
    return img, dt


def metrics(ours, ref):
    diff = ours - ref
    rmse = float(np.sqrt(np.mean(diff ** 2)))
    rel = float(np.mean(diff ** 2 / (ref ** 2 + 1e-2)))
    # tonemapped 8-bit comparison (what the eye sees)
    from mitsuba3_plt_tpu.utils.io import tonemap_srgb

    t_ours = tonemap_srgb(ours).astype(np.float32)
    t_ref = tonemap_srgb(ref).astype(np.float32)
    mad8 = float(np.abs(t_ours - t_ref).mean())
    return dict(rmse=round(rmse, 5), relMSE=round(rel, 5),
                tonemapped_mad_8bit=round(mad8, 3))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=512)
    ap.add_argument("--out", default="docs/PARITY.md")
    ap.add_argument("--jobs", default="")
    ap.add_argument("--rfilter", default=None,
                    help="override reconstruction filter (e.g. box)")
    ap.add_argument("--sweeps", action="store_true",
                    help="include the alpha/period sweep rows")
    ap.add_argument("--spp-probe", action="store_true",
                    help="re-render gratings-plt at 2x spp to split its MAD "
                         "into MC noise (halves) vs bias (stays)")
    ap.add_argument("--spectrograph", action="store_true",
                    help="include the real-data.csv spectrum recoveries")
    args = ap.parse_args()

    from mitsuba3_plt_tpu.utils.exr import read_exr_rgb

    jobs = [
        # name, scene, integrator, (w,h), reference image, kind
        ("cbox-path", f"{REF}/scenes/cbox/cbox.xml", "path", (500, 500),
         f"{REF}/results/cbox-path/result_s0.exr", "exr"),
        ("cbox-plt", f"{REF}/scenes/cbox/cbox.xml", "plt", (500, 500),
         f"{REF}/results/cbox-plt/result_s0.exr", "exr"),
        ("gratings-plt", f"{REF}/scenes/gratings/gratings.xml", "plt",
         (800, 600), f"{REF}/results/grating-spp/plt/result_4096.png", "png"),
        # disk.xml runs max_depth=12 PLT (the heaviest workload); spp
        # scaled down to keep the report under an hour
        ("disk-plt", f"{REF}/scenes/disk/disk.xml", "plt",
         (800, 600), f"{REF}/results/disk/result_s0.png", "png", 8),
        ("veach-path", f"{REF}/scenes/veach-mis/scene.xml", "path",
         (1280, 720), f"{REF}/results/veach/path.png", "png"),
    ]
    if args.sweeps:
        # BSDF_ROUGH_GRATING tag (librender/bsdf.py type table)
        from mitsuba3_plt_tpu.librender.bsdf import BSDF_ROUGH_GRATING

        gx = f"{REF}/scenes/gratings/gratings.xml"
        for a in (0.01, 0.05, 0.15, 0.3):
            jobs.append((
                f"grating-rough a={a}", gx, "plt", (800, 600),
                f"{REF}/results/grating-rough/alpha={a}/result_s0.png",
                "png", 4, (BSDF_ROUGH_GRATING, "alpha",
                           np.asarray([a, a], np.float32)),
            ))
        for v in (0.1, 0.5, 1.0):
            jobs.append((
                f"gratings period={v}", gx, "plt", (800, 600),
                f"{REF}/results/gratings/rgb/period={v}/result_s0.png",
                "png", 4, (BSDF_ROUGH_GRATING, "grt_inv_period",
                           np.asarray([v, v], np.float32)),
            ))
    if args.jobs:
        keep = set(args.jobs.split(","))
        jobs = [j for j in jobs if any(j[0].startswith(k) for k in keep)]

    rows = []
    for job in jobs:
        name, xml, integ, (w, h), refpath, kind = job[:6]
        spp = args.spp // job[6] if len(job) > 6 else args.spp
        mo = job[7] if len(job) > 7 else None
        if not os.path.exists(refpath):
            print(f"[{name}] reference missing: {refpath}", file=sys.stderr)
            continue
        print(f"[{name}] rendering {w}x{h} spp={spp} ({integ})...",
              file=sys.stderr)
        try:
            ours, dt = render_scene(xml, w, h, spp, integ,
                                    rfilter=args.rfilter, mat_override=mo)
        except Exception as e:
            rows.append((name, {"error": repr(e)[:120]}, 0.0))
            continue
        ours = np.asarray(ours[..., :3], np.float32)
        if kind == "exr":
            ref = read_exr_rgb(refpath)
            mt = metrics(ours, ref)
        else:
            from PIL import Image
            from mitsuba3_plt_tpu.utils.io import tonemap_srgb

            refpng = np.asarray(Image.open(refpath), np.float32)[..., :3]
            t_ours = tonemap_srgb(ours).astype(np.float32)
            mt = {"tonemapped_mad_8bit":
                  round(float(np.abs(t_ours - refpng).mean()), 3)}
        if args.spp_probe and name == "gratings-plt":
            # noise-vs-bias split: MC noise contribution to MAD scales
            # ~1/sqrt(spp); a bias floor does not move
            ours2, dt2 = render_scene(xml, w, h, spp * 2, integ,
                                      rfilter=args.rfilter, mat_override=mo)
            t2 = tonemap_srgb(np.asarray(ours2[..., :3], np.float32))
            mt["tonemapped_mad_8bit_2x_spp"] = round(
                float(np.abs(t2.astype(np.float32) - refpng).mean()), 3)
        rows.append((name, mt, dt))
        print(f"[{name}] {mt} ({dt:.1f}s)", file=sys.stderr)

    spectro_rows = []
    if args.spectrograph:
        # real-data.csv recoveries (reference real-data.csv:1-4): orange /
        # white measured .spd spectra + d65, RMSE of normalized recovery
        from mitsuba3_plt_tpu.experiments.spectrograph import run_spectrograph

        ref_rmse = {"orange": 0.13, "white": 0.45, "d65": 0.006}

        def db_spectrum(row_id):
            """SCE spectrum dict from the reference spectraldb.csv (the
            .spd files the fork's configs reference are GENERATED from this
            DB by parse_spectral_db.py — they are not shipped)."""
            import ast
            import csv

            with open(REF + "/scripts/spectrograph/data/spectraldb.csv",
                      newline="", encoding="utf-8") as f:
                for row in csv.DictReader(f):
                    if row.get("ID", "").strip() == row_id:
                        d = ast.literal_eval(row["SCEMeasures"].strip())
                        wls = sorted(float(k) for k in d)
                        vals = [float(d[k]) for k in sorted(d, key=float)]
                        return {"type": "irregular", "wavelengths": wls,
                                "values": vals}
            return None

        # orange = 00009 "Orange Painted Corridor Walls"; the fork's
        # "white" config points at a generated white-surface .spd — we use
        # 00001 "White Painted Room Walls" (the DB's white wall entry)
        sp_orange = db_spectrum("00009")
        sp_white = db_spectrum("00001")

        def truth_of(spectrum):
            if spectrum.get("type") != "irregular":
                return None
            wls = np.asarray(spectrum["wavelengths"], np.float64)
            vals = np.asarray(spectrum["values"], np.float64)
            return lambda wl: np.interp(wl, wls, vals, left=0.0, right=0.0)

        specs = {
            "d65": ({"type": "d65"}, None),
            "orange": (sp_orange, truth_of(sp_orange)),
            "white": (sp_white, truth_of(sp_white)),
        }
        for sname, (spectrum, truth) in specs.items():
            if spectrum is None:
                print(f"[spectro {sname}] missing DB row", file=sys.stderr)
                continue
            try:
                r = run_spectrograph(n_sensors=24, spp=4096,
                                     spectrum=spectrum, truth=truth)
                spectro_rows.append(
                    (sname, round(r["rmse"], 4), ref_rmse.get(sname)))
                print(f"[spectro {sname}] rmse={r['rmse']:.4f} "
                      f"(ref {ref_rmse.get(sname)})", file=sys.stderr)
            except Exception as e:
                spectro_rows.append((sname, repr(e)[:80], ref_rmse.get(sname)))

    lines = [
        "# Reference parity report",
        "",
        f"Rendered at matched resolution, spp={args.spp} (references are "
        "4096-8192 spp), compared against the reference's shipped renders "
        "decoded from its PIZ EXRs / PNGs. relMSE = mean((a-b)^2/(b^2+0.01)).",
        "",
        "| scene | metrics | our render time |",
        "|---|---|---|",
    ]
    for name, mt, dt in rows:
        lines.append(f"| {name} | {json.dumps(mt)} | {dt:.1f}s |")
    lines += [
        "",
        "Notes:",
        "- `disk-plt`: the reference scene references "
        "`textures/empty_play_room.exr`, which is NOT shipped in the "
        "reference tree (its loader would fail; ours substitutes mid-gray "
        "and warns). The illumination therefore cannot match the shipped "
        "result — the MAD row is reported for tracking only, not parity.",
        "- PNG rows compare sRGB-tonemapped 8-bit values; our renders use "
        "far fewer spp than the 4096-8192-spp references, so MC noise "
        "contributes to MAD. Run with --spp-probe to split noise vs bias "
        "on gratings-plt (noise halves with 4x spp; bias does not).",
        "- `grating-rough` sweep rows and part of the gratings-plt MAD are "
        "a DOCUMENTED deviation, not an error (probe: MAD is flat in spp "
        "=> bias; it grows with alpha exactly as the acceptance cone "
        "a = 2*sqrt(alpha_u*alpha_v) does): the reference's wbsdf_eval "
        "computes the angular-coherence falloff from the SPECULAR "
        "direction (roughgrating.cpp:868-879), which with the scene's "
        "coherence (6e5) zeroes every non-zero diffraction order in NEE "
        "replay — its own commented-out code (roughgrating.cpp:925-941) "
        "documents the intended lobe-center form this framework "
        "implements. At alpha 0.01-0.04 the cone is tiny and both agree "
        "(MAD 7.0); at alpha 0.05-0.3 our NEE lights the orders the "
        "reference's quirk suppresses (MAD 30-46). The sweep rows compare "
        "against images produced by the quirk and are reported for "
        "tracking, not parity.",
    ]
    if spectro_rows:
        lines += [
            "",
            "## Spectrograph real-data recoveries (reference real-data.csv)",
            "",
            "| spectrum | our RMSE | reference RMSE |",
            "|---|---|---|",
        ] + [f"| {n} | {r} | {ref} |" for n, r, ref in spectro_rows]
    out = "\n".join(lines) + "\n"
    with open(args.out, "w") as f:
        f.write(out)
    print(out)


if __name__ == "__main__":
    main()
