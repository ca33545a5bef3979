#!/usr/bin/env python
"""Roofline analysis of the render passes on an NVIDIA GPU.

Methodology: lower + compile the benchmark pass, pull XLA's own cost
analysis (flops + bytes accessed), time the steady-state pass, and place it
on the card's roofline:

    achieved_flops  = xla_flops / pass_time
    achieved_bw     = xla_bytes / pass_time
    bound           = whichever fraction of peak is higher

Peaks come from PEAKS, keyed by JAX's device_kind; any other device is an
error, not a default. Prints a markdown table. Run on the GPU:
    python tools/roofline.py
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

# Published dense peaks (NVIDIA H100 SXM data sheet, no sparsity) at the
# full 700 W power limit: f32 outside the tensor cores, and HBM3.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peaks_for(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device {device_kind!r}")
    return PEAKS[device_kind]


def analyze_pass(name, render_pass, data0, peaks, n_timed=4):
    import jax

    lowered = jax.jit(render_pass).lower(data0, 0)
    compiled = lowered.compile()
    try:
        ca = compiled.cost_analysis()
        if isinstance(ca, list):
            ca = ca[0]
        flops = float(ca.get("flops", 0.0))
        bytes_acc = float(ca.get("bytes accessed", 0.0))
    except Exception as e:  # noqa: BLE001 — cost analysis is best-effort
        flops = bytes_acc = 0.0
        print(f"[{name}] cost_analysis unavailable: {e}")

    fn = jax.jit(render_pass)
    data = fn(data0, 0)
    data.block_until_ready()
    times = []
    for p in range(1, n_timed + 1):
        t0 = time.perf_counter()
        data = fn(data, p)
        data.block_until_ready()
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[len(times) // 2]

    return {
        "name": name,
        "pass_s": dt,
        "xla_flops": flops,
        "xla_bytes": bytes_acc,
        "achieved_gflops": flops / dt / 1e9,
        "achieved_gbs": bytes_acc / dt / 1e9,
        "pct_f32_peak": 100.0 * flops / dt / peaks["f32_flops"],
        "pct_bw_peak": 100.0 * bytes_acc / dt / peaks["hbm_bytes"],
        "arithmetic_intensity": flops / max(bytes_acc, 1.0),
    }


def main():
    import jax

    from mitsuba3_plt_tpu.config import RGB
    from mitsuba3_plt_tpu.core.rng import Sampler
    from mitsuba3_plt_tpu.integrators.common import sample_rays
    from mitsuba3_plt_tpu.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu.integrators.plt import PLTIntegrator
    from mitsuba3_plt_tpu.librender.film import ImageBlock
    from mitsuba3_plt_tpu.scene.presets import cornell_box, grating_scene

    kind = jax.devices()[0].device_kind
    peaks = peaks_for(kind)
    rows = []

    # --- cbox classic path -------------------------------------------------
    W = H = 500
    spp_pass = 8
    scene, _ = cornell_box(W, H)
    integ = PathIntegrator(max_depth=6, rr_depth=4)

    def cbox_pass(block_data, pass_idx):
        sampler = Sampler.create(0, W * H * spp_pass).fork(pass_idx)
        ray, uv, wl, wlw = sample_rays(scene, sampler, W, H, spp_pass, RGB)
        values, valid = integ.sample(scene, sampler, ray, wl, RGB)
        block = ImageBlock(
            data=block_data, width=W, height=H, n_channels=3, rfilter=0
        )
        return block.put_ordered(values, valid, spp_pass).data

    data0 = ImageBlock.create(W, H, 3, 0).data
    r = analyze_pass("cbox path 500^2 spp8 d6", cbox_pass, data0, peaks)
    r["samples_per_s"] = W * H * spp_pass / r["pass_s"]
    rows.append(r)

    # --- gratings PLT ------------------------------------------------------
    gw, gh, gspp = 800, 600, 4
    gscene, _ = grating_scene(gw, gh)
    ginteg = PLTIntegrator(max_depth=6, rr_depth=4)

    def grat_pass(block_data, pass_idx):
        sampler = Sampler.create(0, gw * gh * gspp).fork(pass_idx)
        ray, uv, wl, wlw = sample_rays(gscene, sampler, gw, gh, gspp, RGB)
        values, valid = ginteg.sample(gscene, sampler, ray, wl, RGB)
        block = ImageBlock(
            data=block_data, width=gw, height=gh, n_channels=3, rfilter=0
        )
        return block.put_ordered(values, valid, gspp).data

    gdata0 = ImageBlock.create(gw, gh, 3, 0).data
    r = analyze_pass("gratings PLT 800x600 spp4 d6", grat_pass, gdata0,
                     peaks)
    r["samples_per_s"] = gw * gh * gspp / r["pass_s"]
    rows.append(r)

    # --- report ------------------------------------------------------------
    lines = [
        f"Device: {kind}. XLA cost analysis (flops / bytes accessed) of the "
        "compiled render pass, divided by the steady-state pass time, "
        f"against {peaks['f32_flops'] / 1e12:.0f} TFLOP/s f32 and "
        f"{peaks['hbm_bytes'] / 1e12:.2f} TB/s HBM (published peaks).",
        "",
        "| pass | time (ms) | Msamples/s | GFLOP/s | GB/s | % f32 peak | "
        "% HBM peak | flops/byte |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['name']} | {r['pass_s'] * 1e3:.1f} | "
            f"{r.get('samples_per_s', 0) / 1e6:.2f} | "
            f"{r['achieved_gflops']:.0f} | {r['achieved_gbs']:.0f} | "
            f"{r['pct_f32_peak']:.1f}% | {r['pct_bw_peak']:.1f}% | "
            f"{r['arithmetic_intensity']:.1f} |"
        )
    lines += [
        "",
        "Caveat: XLA's cost analysis does not see inside Pallas custom "
        "calls (the fused grating kernels), so both columns are lower "
        "bounds on the gratings row.",
    ]
    print("\n".join(lines))


if __name__ == "__main__":
    main()
