"""Gated reference parity: render the reference's own scenes small and
compare against its SHIPPED converged results (decoded with the native PIZ
codec), with hard per-scene thresholds.

Scheme: the reference's golden z-test suite renders every test scene and
compares per-pixel statistics against stored references
(src/render/tests/test_renders.py:159-232). Full-size parity lives in
tools/parity_report.py (accelerator, docs/PARITY.md); this CI gate renders at
reduced resolution and compares BOX-downsampled images — downsampling
averages out MC noise (a 64^2 render box-reduced to 16^2 carries ~16x the
effective spp), so the thresholds bound BIAS, not noise.

disk-plt is deliberately excluded: the reference scene references
textures/empty_play_room.exr which is NOT shipped in the reference tree,
so its illumination cannot be reproduced (docs/PARITY.md note).
"""
import os

import numpy as np
import pytest

REF = "/root/reference"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference tree not mounted"
)


def _box_resize(img, size):
    from PIL import Image

    arr = np.asarray(img, np.float32)
    chans = [
        np.asarray(
            Image.fromarray(arr[..., c]).resize(size, Image.BOX),
            np.float32,
        )
        for c in range(arr.shape[-1])
    ]
    return np.stack(chans, axis=-1)


def _render_small(xml, w, h, spp, integrator=None):
    import mitsuba3_plt_tpu as mi

    scene, meta = mi.load_file(xml, resx=w, resy=h)
    if integrator:
        meta = dict(meta)
        meta["integrator"] = dict(meta.get("integrator") or {})
        meta["integrator"]["type"] = integrator
    return np.asarray(mi.render((scene, meta), spp=spp))[..., :3]


def _rel_mse(ours, ref):
    """Interior relMSE: the outer block ring is excluded — downsampled edge
    blocks mix the reference's rfilter border falloff and sub-block
    alignment of the light's hard edge (a half-pixel shift of a 10-vs-0.2
    boundary dominates the block mean), neither of which is radiometric
    bias."""
    a = ours[1:-1, 1:-1]
    b = ref[1:-1, 1:-1]
    return float(np.mean((a - b) ** 2 / (b ** 2 + 1e-2)))


@pytest.mark.slow
def test_cbox_path_parity():
    """cbox.xml via `path` vs results/cbox-path/result_s0.exr (8192 spp)."""
    from mitsuba3_plt_tpu.utils.exr import read_exr_rgb

    ours = _render_small(f"{REF}/scenes/cbox/cbox.xml", 64, 64, 16, "path")
    ref = read_exr_rgb(f"{REF}/results/cbox-path/result_s0.exr")
    a = _box_resize(ours, (16, 16))
    b = _box_resize(ref, (16, 16))
    rel = _rel_mse(a, b)
    # recorded ~0.009 at these settings (16 and 64 spp); 3x margin
    assert rel < 0.03, f"cbox-path relMSE {rel:.4f}"


@pytest.mark.slow
def test_cbox_path_stokes_sign_parity():
    """S1/S2 structure vs the reference's SHIPPED stokes EXRs
    (results/cbox-path/result_s{1,2}.exr, 8192 spp, stokes-wrapped
    mispath): per-pixel correlation and sign agreement on strong pixels.

    Anchor choice (round 5): the reference's cbox-PLT stokes EXRs are NOT
    self-consistent with its own cbox-path ones (S1 corr 0.18, sign
    agreement 42% — the fork's Python plt chain loses/realigns the
    polarized state), so cbox-path is the meaningful convention anchor.
    Measured at these settings: corr 0.72-0.77, agree 0.69-0.78."""
    import mitsuba3_plt_tpu as mi
    from mitsuba3_plt_tpu.config import RGB
    from mitsuba3_plt_tpu.integrators.stokes import (
        PolarizedPathIntegrator, StokesIntegrator,
    )
    from mitsuba3_plt_tpu.utils.exr import read_exr

    R = 50
    scene, meta = mi.load_file(f"{REF}/scenes/cbox/cbox.xml", resx=R, resy=R)
    integ = StokesIntegrator(
        inner=PolarizedPathIntegrator(max_depth=7, rr_depth=50),
        forward_basis=False,  # the reference wraps in plain `stokes`
    )
    img = np.asarray(
        mi.render((scene, meta), integrator=integ, spp=160, seed=0, cfg=RGB)
    )

    def ref_s(ch):
        chans, _ = read_exr(f"{REF}/results/cbox-path/result_{ch}.exr")
        a = np.stack([chans[k] for k in ("R", "G", "B")], -1).mean(-1)
        h, w = a.shape
        return a[: h // R * R, : w // R * R].reshape(
            R, h // R, R, w // R
        ).mean((1, 3))

    for i, nm in ((1, "s1"), (2, "s2")):
        ours = img[..., 3 + 3 * i : 6 + 3 * i].mean(-1)
        rr = ref_s(nm)
        # magnitude-weighted sign agreement: counting flips of near-zero
        # pixels is MC/executable-noise-limited; weighting by |ours * ref|
        # asks "does the polarized ENERGY agree in sign"
        w = np.abs(ours * rr)
        same = np.sign(ours) == np.sign(rr)
        agree_w = float(w[same].sum() / max(w.sum(), 1e-20))
        corr = float(np.corrcoef(ours.ravel(), rr.ravel())[0, 1])
        assert corr > 0.5, f"{nm} corr {corr:.3f}"
        assert agree_w > 0.75, f"{nm} weighted sign agreement {agree_w:.3f}"


@pytest.mark.slow
def test_cbox_plt_parity():
    """cbox.xml via the PLT integrator vs results/cbox-plt/result_s0.exr —
    the wave-transport estimator must converge to the same radiometry on a
    grating-free scene."""
    from mitsuba3_plt_tpu.utils.exr import read_exr_rgb

    ours = _render_small(f"{REF}/scenes/cbox/cbox.xml", 64, 64, 16, "plt")
    ref = read_exr_rgb(f"{REF}/results/cbox-plt/result_s0.exr")
    a = _box_resize(ours, (16, 16))
    b = _box_resize(ref, (16, 16))
    rel = _rel_mse(a, b)
    # recorded ~0.01 at these settings; 3x margin
    assert rel < 0.035, f"cbox-plt relMSE {rel:.4f}"


@pytest.mark.slow
def test_gratings_plt_parity():
    """gratings.xml via PLT vs the tonemapped 4096-spp reference PNG
    (no HDR s0 is shipped for this scene)."""
    from PIL import Image

    from mitsuba3_plt_tpu.utils.io import tonemap_srgb

    ours = _render_small(
        f"{REF}/scenes/gratings/gratings.xml", 100, 75, 8, "plt"
    )
    ref = np.asarray(
        Image.open(f"{REF}/results/grating-spp/plt/result_4096.png"),
        np.float32,
    )[..., :3]
    t_ours = _box_resize(tonemap_srgb(ours).astype(np.float32), (25, 19))
    t_ref = _box_resize(ref, (25, 19))
    mad = float(np.abs(t_ours - t_ref).mean())
    # recorded ~5-8/255 at these settings; margin to 15
    assert mad < 15.0, f"gratings-plt tonemapped MAD {mad:.2f}/255"
