"""Fused Pallas grating kernels (Triton route) vs the plain XLA chains.

On the GPU the render path swaps the [N, C, L] lobe-sum broadcast of
RoughGratingW.wbsdf_eval, and the wbsdf_sample chain, for the fused kernels
in ops/grating_pallas.py (reference algebra: roughgrating.cpp:414-970).
This runs the kernels in interpret mode on the CPU against the XLA chains
for every grating profile and both lobe-grid layouts, plus the wrapper's
padding to whole blocks and the one dispatch point that picks the kernels.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import mitsuba3_plt_tpu.plt.grating as gr
from mitsuba3_plt_tpu.core import math as m
from mitsuba3_plt_tpu.ops.grating_pallas import BLOCK, grating_lobe_sum
from mitsuba3_plt_tpu.plt.coherence import Coherence


def _rand_dir(rng, n):
    v = rng.normal(size=(n, 3))
    v[:, 2] = np.abs(v[:, 2]) + 0.1
    return jnp.asarray(
        (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    )


def _xla_lobe_sum(g, wi, wo, wl, coh, a_cone, half, separable):
    """The wbsdf.py eval chain, reduced to the per-wavelength sum."""
    N, C = wl.shape
    wl_um = wl * 1e-3
    k = 2.0 * m.Pi / jnp.maximum(wl_um, 1e-6)
    side = np.arange(-half, half + 1)
    if separable:
        lx_g, ly_g = side, np.zeros_like(side)
    else:
        gx, gy = np.meshgrid(side, side, indexing="ij")
        lx_g, ly_g = gx.ravel(), gy.ravel()
    lane_half = (g.lobes // 2)[:, None, None]
    live = (jnp.asarray(np.abs(lx_g))[None, None, :] <= lane_half) & (
        jnp.asarray(np.abs(ly_g))[None, None, :] <= lane_half
    )
    base = gr.order_intensities(g, wi, wl_um, half)
    ix = base[:, :, np.abs(lx_g)]
    iy = jnp.where(g.is_1d()[:, None, None], ix, base[:, :, np.abs(ly_g)])
    lobe_int = g.multiplier[:, None, None] * ix * iy
    wi_x, wi_y, wi_z = wi[..., 0], wi[..., 1], wi[..., 2]
    px = jnp.sqrt(wi_x * wi_x + wi_z * wi_z)
    py = jnp.sqrt(wi_y * wi_y + wi_z * wi_z)
    sin_ix = jnp.where(px > m.Epsilon, wi_x / jnp.maximum(px, 1e-20), 0.0)
    sin_iy = jnp.where(py > m.Epsilon, wi_y / jnp.maximum(py, 1e-20), 0.0)
    cg = g.grating_dir[..., 0][:, None, None]
    sg = g.grating_dir[..., 1][:, None, None]
    lxf = jnp.asarray(lx_g, jnp.float32)[None, None, :]
    lyf = jnp.asarray(ly_g, jnp.float32)[None, None, :]
    a = wl_um[:, :, None] * (cg * lxf - sg * lyf) \
        * g.inv_period[:, 0][:, None, None] - sin_ix[:, None, None]
    b = wl_um[:, :, None] * (sg * lxf + cg * lyf) \
        * g.inv_period[:, 1][:, None, None] - sin_iy[:, None, None]
    mm = (m.sqr(a) - 1.0) / jnp.where(
        jnp.abs(m.sqr(a * b) - 1.0) > 1e-12, m.sqr(a * b) - 1.0, 1e-12
    )
    qq = 1.0 - m.sqr(b) * mm
    lobe_ok = (jnp.abs(a) <= 1.0) & (jnp.abs(b) <= 1.0)
    cd_dot_wo = (
        a * m.safe_sqrt(qq) * wo[:, 0][:, None, None]
        + b * m.safe_sqrt(mm) * wo[:, 1][:, None, None]
        + m.safe_sqrt(1.0 - m.sqr(a) * qq - m.sqr(b) * mm)
        * wo[:, 2][:, None, None]
    )
    ang = m.unit_angle_dot(cd_dot_wo)
    in_cone = jnp.abs(ang) < a_cone[:, None, None]
    inv_det = Coherence.isotropic(
        coh, jnp.ones((N,), jnp.float32)
    ).inv_coherence_det(k)
    ang_coh = jnp.exp(-0.5 * ang * ang * inv_det[:, :, None])
    is_zero = jnp.asarray((lx_g == 0) & (ly_g == 0))[None, None, :]
    contrib = jnp.where(
        lobe_ok & in_cone & live,
        lobe_int * jnp.where(is_zero, 1.0, ang_coh), 0.0,
    )
    if separable:
        ny = (2 * (g.lobes // 2) + 1).astype(jnp.float32)[:, None, None]
        corr = jnp.where(
            is_zero & lobe_ok & in_cone & live,
            lobe_int * (ang_coh - 1.0) * (ny - 1.0), 0.0,
        )
        contrib = contrib * ny + corr
    return jnp.sum(contrib, axis=-1)


@pytest.mark.parametrize(
    "half,separable,gtype,ip_y",
    [
        (3, True, gr.SINUSOIDAL, 0.0),
        (3, False, gr.SINUSOIDAL, 1.5),
        (4, True, gr.RECTANGULAR, 0.0),
        (2, True, gr.LINEAR, 0.0),
    ],
)
def test_kernel_matches_xla(half, separable, gtype, ip_y):
    rng = np.random.default_rng(7)
    N, C = 2048, 3
    wi, wo = _rand_dir(rng, N), _rand_dir(rng, N)
    wl = jnp.asarray(rng.uniform(380, 680, (N, C)).astype(np.float32))
    ip_t = jnp.stack([jnp.full((N,), 2.0), jnp.full((N,), ip_y)], -1)
    q = jnp.asarray(rng.uniform(0.02, 0.3, N).astype(np.float32))
    lobes = jnp.asarray(rng.choice([3, 5, 7, 9], N).astype(np.int32))
    gt = jnp.full((N,), gtype, jnp.int32)
    mult = jnp.full((N,), 1.3)
    coh = jnp.asarray(rng.uniform(1.0, 120.0, N).astype(np.float32))
    a_cone = jnp.asarray(rng.uniform(0.05, 0.4, N).astype(np.float32))
    gdir = jnp.stack([jnp.ones((N,)), jnp.zeros((N,))], -1)
    g = gr.Grating(grating_dir=gdir, inv_period=ip_t, q=q, lobes=lobes,
                   gtype=gt, multiplier=mult)

    got = grating_lobe_sum(
        wi, wo, wl, gdir, ip_t, q, lobes, gt, mult, coh, a_cone,
        half=half, separable=separable, n_channels=C, interpret=True,
    )
    want = _xla_lobe_sum(g, wi, wo, wl, coh, a_cone, half, separable)

    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=2e-3, atol=2e-5
    )


@pytest.mark.parametrize("gtype,ip_y", [(gr.SINUSOIDAL, 0.0),
                                        (gr.RECTANGULAR, 1.5)])
def test_sample_kernel_matches_xla(gtype, ip_y):
    """grating_sample (interpret) vs the XLA chain wbsdf_sample runs
    elsewhere (wbsdf.grating_sample_xla)."""
    from mitsuba3_plt_tpu.librender import microfacet as mf
    from mitsuba3_plt_tpu.ops.grating_pallas import grating_sample
    from mitsuba3_plt_tpu.plt.wbsdf import grating_sample_xla

    rng = np.random.default_rng(11)
    N, half = 2048, 3
    wi = _rand_dir(rng, N)
    u2 = jnp.asarray(rng.uniform(0, 1, (N, 2)).astype(np.float32))
    lu2 = jnp.asarray(rng.uniform(0, 1, (N, 2)).astype(np.float32))
    wl_um = jnp.asarray(rng.uniform(0.38, 0.68, N).astype(np.float32))
    alpha = jnp.asarray(rng.uniform(0.03, 0.3, (N, 2)).astype(np.float32))
    ip_t = jnp.stack([jnp.full((N,), 2.0), jnp.full((N,), ip_y)], -1)
    q = jnp.asarray(rng.uniform(0.02, 0.3, N).astype(np.float32))
    lobes = jnp.asarray(rng.choice([3, 5, 7], N).astype(np.int32))
    gt = jnp.full((N,), gtype, jnp.int32)
    mult = jnp.full((N,), 1.1)
    gdir = jnp.stack([jnp.ones((N,)), jnp.zeros((N,))], -1)
    g = gr.Grating(grating_dir=gdir, inv_period=ip_t, q=q, lobes=lobes,
                   gtype=gt, multiplier=mult)

    got = grating_sample(wi, u2, lobe_u2=lu2, wl_um=wl_um, alpha=alpha,
                         grating_dir=gdir, inv_period=ip_t, q=q,
                         lobes=lobes, gtype=gt, multiplier=mult,
                         half=half, interpret=True)

    want = grating_sample_xla(wi, u2, lu2, wl_um, alpha, g, half, mf.GGX)
    mvec, lobe, ok, wo, pdf, w_g1_int = (
        want[k] for k in ("mvec", "lobe", "ok", "wo", "pdf", "w_g1_int"))

    np.testing.assert_allclose(np.asarray(got["mvec"]), np.asarray(mvec),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got["lobe"]), np.asarray(lobe))
    m_ok = np.asarray(ok)
    np.testing.assert_array_equal(np.asarray(got["ok"]), m_ok)
    # only compare live lanes for direction-dependent outputs
    np.testing.assert_allclose(np.asarray(got["wo"])[m_ok],
                               np.asarray(wo)[m_ok], rtol=1e-4, atol=1e-5)
    # near-specular lanes can saturate to inf in one path only (1/cos^4 at
    # f32 eps differences); pdfs that large are MIS-equivalent — clip
    got_pdf = np.minimum(np.asarray(got["pdf"])[m_ok], 1e6)
    want_pdf = np.minimum(np.asarray(pdf)[m_ok], 1e6)
    np.testing.assert_allclose(got_pdf, want_pdf, rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got["w_g1_int"])[m_ok],
                               np.asarray(w_g1_int)[m_ok],
                               rtol=2e-3, atol=1e-6)


def test_lobe_sum_custom_vjp_grads():
    """jax.grad through grating_lobe_sum (primal = kernel, vjp = XLA
    re-implementation) matches grads of the pure-XLA chain — the PLT
    grating parameters (inv_period, height, multiplier, coherence) must
    stay differentiable on the GPU, where the kernel is the primal."""
    rng = np.random.default_rng(3)
    N, C, half = 512, 3, 3
    wi, wo = _rand_dir(rng, N), _rand_dir(rng, N)
    wl = jnp.asarray(rng.uniform(380, 680, (N, C)).astype(np.float32))
    gdir = jnp.stack([jnp.ones((N,)), jnp.zeros((N,))], -1)
    ip_t = jnp.stack([jnp.full((N,), 2.0), jnp.zeros((N,))], -1)
    q = jnp.asarray(rng.uniform(0.05, 0.2, N).astype(np.float32))
    lobes = jnp.full((N,), 7, jnp.int32)
    gt = jnp.zeros((N,), jnp.int32)
    mult = jnp.full((N,), 1.2)
    coh = jnp.full((N,), 40.0)
    a_cone = jnp.full((N,), 0.3)

    from mitsuba3_plt_tpu.ops.grating_pallas import (
        grating_lobe_sum, _lobe_sum_xla,
    )

    def loss_kernel(qv, ipx, mu, co):
        ip2 = jnp.stack([ipx, jnp.zeros_like(ipx)], -1)
        out = grating_lobe_sum(
            wi, wo, wl, gdir, ip2, qv, lobes, gt, mu, co, a_cone,
            half=half, separable=True, n_channels=C, interpret=True,
        )
        return jnp.sum(out * out)

    def loss_xla(qv, ipx, mu, co):
        ip2 = jnp.stack([ipx, jnp.zeros_like(ipx)], -1)
        out = _lobe_sum_xla(
            wi, wo, wl, gdir, ip2, qv, lobes.astype(jnp.float32),
            gt.astype(jnp.float32), mu, co, a_cone,
            half=half, separable=True,
        )
        return jnp.sum(out * out)

    ipx = ip_t[:, 0]
    gk = jax.grad(loss_kernel, argnums=(0, 1, 2, 3))(q, ipx, mult, coh)
    gx = jax.grad(loss_xla, argnums=(0, 1, 2, 3))(q, ipx, mult, coh)
    for a, b, name in zip(gk, gx, ("q", "inv_period", "mult", "coh")):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=5e-3, atol=1e-4,
            err_msg=name,
        )


def _lobe_inputs(rng, n, C=3):
    wi, wo = _rand_dir(rng, n), _rand_dir(rng, n)
    wl = jnp.asarray(rng.uniform(380, 680, (n, C)).astype(np.float32))
    gdir = jnp.stack([jnp.ones((n,)), jnp.zeros((n,))], -1)
    ip = jnp.stack([jnp.full((n,), 2.0), jnp.zeros((n,))], -1)
    q = jnp.asarray(rng.uniform(0.02, 0.3, n).astype(np.float32))
    lobes = jnp.asarray(rng.choice([3, 5, 7], n).astype(np.int32))
    gt = jnp.zeros((n,), jnp.int32)
    mult = jnp.full((n,), 1.3)
    coh = jnp.asarray(rng.uniform(1.0, 120.0, n).astype(np.float32))
    a_cone = jnp.asarray(rng.uniform(0.05, 0.4, n).astype(np.float32))
    return wi, wo, wl, gdir, ip, q, lobes, gt, mult, coh, a_cone


@pytest.mark.parametrize("n", [1, BLOCK + 1])
def test_lobe_sum_pads_to_whole_blocks(n):
    """Lane counts that are not a multiple of the block: the wrapper pads
    and trims, and every real lane matches the XLA chain."""
    from mitsuba3_plt_tpu.ops.grating_pallas import _lobe_sum_xla

    args = _lobe_inputs(np.random.default_rng(n), n)
    got = grating_lobe_sum(*args, half=3, separable=True, n_channels=3,
                           interpret=True)
    assert got.shape == (n, 3)
    want = _lobe_sum_xla(*args[:6], args[6].astype(jnp.float32),
                         args[7].astype(jnp.float32), *args[8:], half=3,
                         separable=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("n", [1, BLOCK + 1])
def test_sample_pads_to_whole_blocks(n):
    from mitsuba3_plt_tpu.ops.grating_pallas import grating_sample

    rng = np.random.default_rng(n)
    wi = _rand_dir(rng, n)
    u2 = jnp.asarray(rng.uniform(0, 1, (n, 2)).astype(np.float32))
    wl_um = jnp.full((n,), 0.55)
    alpha = jnp.full((n, 2), 0.1)
    gdir = jnp.stack([jnp.ones((n,)), jnp.zeros((n,))], -1)
    ip = jnp.stack([jnp.full((n,), 2.0), jnp.zeros((n,))], -1)
    out = grating_sample(wi, u2, u2, wl_um, alpha, gdir, ip,
                         jnp.full((n,), 0.1), jnp.full((n,), 5, jnp.int32),
                         jnp.zeros((n,), jnp.int32), jnp.ones((n,)), half=2,
                         interpret=True)
    shapes = {"wo": (n, 3), "pdf": (n,), "lobe": (n, 2), "w_g1_int": (n,),
              "reflection_dir": (n, 3), "mvec": (n, 3), "ok": (n,)}
    assert {k: v.shape for k, v in out.items()} == shapes
    assert out["lobe"].dtype == jnp.int32 and out["ok"].dtype == bool
    assert np.all(np.abs(np.asarray(out["lobe"])) <= 2)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(out["mvec"]), axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("platform,fused", [
    ("gpu", True), ("cpu", False), ("rocm", False),
])
def test_dispatch_picks_kernels_only_on_gpu(platform, fused):
    from mitsuba3_plt_tpu import ops

    assert ops.use_fused_kernels(platform) is fused
    # the test process runs on the CPU: the renderer takes the XLA chains
    assert ops.use_fused_kernels() is False
