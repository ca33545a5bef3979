"""Fused Pallas kernels (Triton route) for the roughgrating wave path.

The PLT NEE replay evaluates the diffraction-lobe sum for every lane at
every depth (reference roughgrating.cpp:676-970). The plain XLA version in
plt/wbsdf.py materializes ~100 [N, C, L] intermediates across fusion
boundaries (the Bessel fori_loop splits the fusion), so they round-trip
through device memory. `grating_lobe_sum` fuses the whole chain — Miller
Bessel sweep, per-order intensities, grating-equation lobe centers,
acceptance cone and angular-coherence falloff — into one pass over the
wavefront: every temporary lives in registers, and device-memory traffic is
one read of the lane inputs plus one [N, C] write. `grating_sample` does
the same for the sample chain.

Both kernels are per-lane elementwise math over 1-D blocks of BLOCK lanes;
the wrapper pads the wavefront to a whole number of blocks. They are
compiled through Triton (`backend="triton"`); tests run them with
`interpret=True` on the CPU. Which form the renderer runs is decided in one
place, `ops.use_fused_kernels`.

The (half, separable) specialization mirrors MaterialTable.grt_static:
separable means every grating in the scene is 1D and axis-aligned, so the
2D lobe grid collapses to one row times the ly multiplicity (identical
algebra to the XLA path in wbsdf.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt_triton

from ..core import math as m

# Lanes per program (a power of two, as Triton requires) and warps per
# program, per kernel: the kernels hold only per-lane scalars, so blocks are
# sized for registers (chosen by a sweep of 128-1024 lanes on the H100,
# PERF.md).
BLOCK = 256
LOBE_SUM_WARPS = 8
SAMPLE_WARPS = 4

# grating type tags (plt/grating.py)
_SINUSOIDAL = 0
_RECTANGULAR = 1
_LINEAR = 2

_BESSEL_M = 64          # Miller start order (matches core.math.bessel_jn_fast)
_ASYMP_SWITCH = 0.75 * _BESSEL_M


def _unit_angle_dot(dot_uv):
    """core.math.unit_angle_dot."""
    d = jnp.sqrt(jnp.maximum(2.0 - 2.0 * jnp.abs(dot_uv), 0.0))
    theta = 2.0 * jnp.arcsin(jnp.clip(0.5 * d, -1.0, 1.0))
    return jnp.where(dot_uv < 0, m.Pi - theta, theta)


def _safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


def _bessel_sweep(a, half):
    """J_0(|a|)..J_half(|a|) by Miller downward recurrence, fully unrolled
    in registers (core.math.bessel_jn_fast algebra, M = 64, scale guards).

    Returns list of half+1 tiles."""
    x_abs = jnp.abs(a)
    x_safe = jnp.maximum(x_abs, 1e-6)
    inv_x = 1.0 / x_safe

    jp1 = jnp.zeros_like(x_safe)
    jk = jnp.full_like(x_safe, 1e-30)
    norm = jnp.zeros_like(x_safe)
    outs = [None] * (half + 1)
    for i in range(_BESSEL_M):
        k = float(_BESSEL_M - i)
        jm1 = (2.0 * k) * inv_x * jk - jp1
        jp1, jk = jk, jm1
        scale = jnp.where(jnp.abs(jk) > 1e18, 1e-18, 1.0)
        kk = int(k) - 1  # jk now holds J_kk (unnormalized)
        contrib = jnp.where(kk == 0, jk, 2.0 * jk) if kk % 2 == 0 else None
        if contrib is not None:
            norm = norm + contrib
        jp1 = jp1 * scale
        jk = jk * scale
        norm = norm * scale
        if kk <= half:
            outs[kk] = jk
            for j in range(kk + 1, half + 1):
                outs[j] = outs[j] * scale

    inv_norm = jnp.where(norm >= 0, 1.0, -1.0) / jnp.maximum(
        jnp.abs(norm), 1e-30
    )
    res = [o * inv_norm for o in outs]

    # two-term Hankel asymptotics beyond the recurrence's validity
    use_asym = x_abs > _ASYMP_SWITCH
    i8x = 1.0 / (8.0 * x_safe)
    sq = jnp.sqrt(2.0 / (m.Pi * x_safe))
    at_zero = x_abs < 1e-6
    for nu in range(half + 1):
        mu = 4.0 * float(nu) * float(nu)
        p = 1.0 - (mu - 1.0) * (mu - 9.0) * 0.5 * i8x * i8x
        q = (mu - 1.0) * i8x
        omega = x_abs - (0.5 * nu + 0.25) * m.Pi
        asym = sq * (jnp.cos(omega) * p - jnp.sin(omega) * q)
        r = jnp.where(use_asym, asym, res[nu])
        r = jnp.where(at_zero, 1.0 if nu == 0 else 0.0, r)
        res[nu] = r
    return res


def _base_intensities(a, sin_half_a, is_sin, is_rect, half):
    """Per-order intensities 0..half (grating.order_intensities algebra):
    sinusoidal J_j(a)^2, rectangular sin(a/2)*sinc(pi j/2), linear
    1/sqrt(j); order 0 is 1 for every profile."""
    import math as _math

    J = _bessel_sweep(a, half)
    base = [None] * (half + 1)
    base[0] = jnp.ones_like(a)
    for j in range(1, half + 1):
        _x = _math.pi * 0.5 * j
        sc = _math.sin(_x) / _x
        base[j] = jnp.where(
            is_sin, J[j] * J[j],
            jnp.where(is_rect, sin_half_a * sc, 1.0 / float(j) ** 0.5),
        )
    return base


def _kernel(wix, wiy, wiz, wox, woy, woz,
            gdc, gds, ipx, ipy, q, lobes, gtype, mult, coh, acone,
            *wl_and_out, half: int, separable: bool, n_channels: int):
    wl_refs = wl_and_out[:n_channels]
    out_refs = wl_and_out[n_channels:]

    wi_x, wi_y, wi_z = wix[...], wiy[...], wiz[...]
    wo_x, wo_y, wo_z = wox[...], woy[...], woz[...]
    cg, sg = gdc[...], gds[...]
    ip_x, ip_y = ipx[...], ipy[...]
    qv, lob, gt = q[...], lobes[...], gtype[...]
    mu_, co_, ac_ = mult[...], coh[...], acone[...]

    # lane-invariant (channel-independent) quantities
    px = jnp.sqrt(wi_x * wi_x + wi_z * wi_z)
    py = jnp.sqrt(wi_y * wi_y + wi_z * wi_z)
    sin_ix = jnp.where(px > m.Epsilon, wi_x / jnp.maximum(px, 1e-20), 0.0)
    sin_iy = jnp.where(py > m.Epsilon, wi_y / jnp.maximum(py, 1e-20), 0.0)
    cos_t = jnp.abs(wi_z)
    half_lobes = jnp.floor(lob * 0.5)  # lobes//2 as float
    is_1d = ip_y < m.Epsilon
    is_sin = gt < 0.5           # SINUSOIDAL = 0
    is_rect = jnp.abs(gt - 1.0) < 0.5

    if separable:
        lobe_list = [(lx, 0) for lx in range(-half, half + 1)]
    else:
        lobe_list = [
            (lx, ly)
            for lx in range(-half, half + 1)
            for ly in range(-half, half + 1)
        ]

    for c in range(n_channels):
        wl_um = wl_refs[c][...] * 1e-3
        kwn = 2.0 * m.Pi / jnp.maximum(wl_um, 1e-6)

        # ---- order intensities 0..half (grating.order_intensities) ----
        a = 4.0 * m.Pi * qv / jnp.maximum(wl_um * cos_t, 1e-12)
        base = _base_intensities(a, jnp.sin(a * 0.5), is_sin, is_rect, half)

        # inv coherence det: Coherence.isotropic(coh, 1).inv_coherence_det(k)
        # = (coh * k / (2 pi * 1e3))^2
        s = co_ * kwn * (1.0 / (2.0 * m.Pi * 1e3))
        inv_det = s * s

        acc = jnp.zeros_like(a)
        corr = jnp.zeros_like(a) if separable else None
        for (lx, ly) in lobe_list:
            ax_, ay_ = abs(lx), abs(ly)
            live = half_lobes >= float(max(ax_, ay_))
            ix = base[ax_]
            iy = jnp.where(is_1d, ix, base[ay_]) if ay_ <= half else ix
            lobe_int = mu_ * ix * iy

            lob_rx = cg * float(lx) - sg * float(ly)
            lob_ry = sg * float(lx) + cg * float(ly)
            aa = wl_um * lob_rx * ip_x - sin_ix
            bb = wl_um * lob_ry * ip_y - sin_iy
            den = aa * aa * bb * bb - 1.0
            mm = (aa * aa - 1.0) / jnp.where(
                jnp.abs(den) > 1e-12, den, 1e-12
            )
            qq = 1.0 - bb * bb * mm
            lobe_ok = (jnp.abs(aa) <= 1.0) & (jnp.abs(bb) <= 1.0)
            cd_dot_wo = (
                aa * _safe_sqrt(qq) * wo_x
                + bb * _safe_sqrt(mm) * wo_y
                + _safe_sqrt(1.0 - aa * aa * qq - bb * bb * mm) * wo_z
            )
            ang = _unit_angle_dot(cd_dot_wo)
            in_cone = jnp.abs(ang) < ac_
            ang_coh = jnp.exp(-0.5 * ang * ang * inv_det)

            sel = lobe_ok & in_cone & live
            if lx == 0 and ly == 0:
                acc = acc + jnp.where(sel, lobe_int, 0.0)
                if separable:
                    ny = 2.0 * half_lobes + 1.0
                    corr = jnp.where(
                        sel, lobe_int * (ang_coh - 1.0) * (ny - 1.0), 0.0
                    )
            else:
                acc = acc + jnp.where(sel, lobe_int * ang_coh, 0.0)

        if separable:
            ny = 2.0 * half_lobes + 1.0
            acc = acc * ny + corr
        out_refs[c][...] = acc


def grating_lobe_sum(
    wi, wo, wl_nm, grating_dir, inv_period, q, lobes, gtype, multiplier,
    coherence, a_cone, half: int, separable: bool, n_channels: int,
    interpret: bool = False,
):
    """Fused lobe-sum eval: returns per-sampled-wavelength intensity [N, C].

    Inputs are per-lane: wi/wo [N,3] local dirs, wl_nm [N,C], grating_dir
    [N,2], inv_period [N,2] (1/um), q [N] (um), lobes [N] int, gtype [N]
    int (masked to TYPE_MASK by caller), multiplier/coherence/a_cone [N].

    Differentiable: primal = fused kernel, vjp = XLA re-implementation
    (see _make_lobe_sum_vjp)."""
    f = _make_lobe_sum_vjp(int(half), bool(separable), int(n_channels),
                           bool(interpret))
    return f(
        wi, wo, wl_nm, grating_dir, inv_period, q,
        lobes.astype(jnp.float32), gtype.astype(jnp.float32),
        multiplier, coherence, a_cone,
    )


@functools.partial(
    jax.jit,
    static_argnames=("half", "separable", "n_channels", "interpret"),
)
def _grating_lobe_sum_impl(
    wi, wo, wl_nm, grating_dir, inv_period, q, lobes, gtype, multiplier,
    coherence, a_cone, half: int, separable: bool, n_channels: int,
    interpret: bool = False,
):
    ins = [
        wi[:, 0], wi[:, 1], wi[:, 2], wo[:, 0], wo[:, 1], wo[:, 2],
        grating_dir[:, 0], grating_dir[:, 1],
        inv_period[:, 0], inv_period[:, 1], q, lobes, gtype, multiplier,
        coherence, a_cone,
    ] + [wl_nm[:, c] for c in range(n_channels)]
    outs = _lane_call(
        functools.partial(
            _kernel, half=half, separable=separable, n_channels=n_channels
        ),
        ins, n_channels, "grating_lobe_sum", interpret, LOBE_SUM_WARPS,
    )
    return jnp.stack(outs, axis=-1)


def _lane_call(kernel, ins, n_out, name, interpret, num_warps):
    """Run a per-lane kernel over [N] f32 inputs in 1-D blocks of BLOCK
    lanes (padded to a whole block); returns n_out [N] f32 outputs."""
    n = ins[0].shape[0]
    pad = (-n) % BLOCK
    npad = n + pad
    ins = [jnp.pad(x.astype(jnp.float32), (0, pad)) for x in ins]
    spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    outs = pl.pallas_call(
        kernel,
        grid=(npad // BLOCK,),
        in_specs=[spec] * len(ins),
        out_specs=[spec] * n_out,
        out_shape=[jax.ShapeDtypeStruct((npad,), jnp.float32)] * n_out,
        backend="triton",
        compiler_params=plt_triton.CompilerParams(
            num_warps=num_warps, num_stages=1
        ),
        interpret=interpret,
        name=name,
    )(*ins)
    return [o[:n] for o in outs]


# ---------------------------------------------------------------------------
# Fused grating SAMPLE kernel
#
# The roughgrating wbsdf_sample chain (VNDF microfacet normal, frame
# rotation, Bessel order sweep, lobe-CDF walk, grating-equation diffract,
# Smith G1) compiles to ~40 small XLA fusions per bounce inside the render
# scan. This kernel runs the whole chain in one pass: inputs are the lane
# dirs + uniforms + per-lane grating params, outputs everything the
# dispatcher needs (wo, pdf, lobe, G1*intensity, reflection dir and
# microfacet normal for the Fresnel evaluated outside on [N, C]).
# Algebra mirrors plt/wbsdf.py RoughGratingW.wbsdf_sample +
# plt/grating.py sample_lobe/diffract + librender/microfacet.py VNDF/G1.
# ---------------------------------------------------------------------------


def _g1_ggx(vx, vy, vz, mx, my, mz, au, av):
    """microfacet.smith_g1 (GGX branch)."""
    xy2 = (au * vx) ** 2 + (av * vy) ** 2
    tan2 = xy2 / jnp.maximum(vz * vz, 1e-20)
    g = 2.0 / (1.0 + jnp.sqrt(1.0 + tan2))
    g = jnp.where(xy2 == 0.0, 1.0, g)
    backfacing = (vx * mx + vy * my + vz * mz) * vz <= 0.0
    return jnp.where(backfacing, 0.0, g)


def _g1(vx, vy, vz, mx, my, mz, au, av, ndf: int):
    """microfacet.smith_g1, static-NDF dispatched (0 GGX / 1 Beckmann)."""
    if ndf != 1:
        return _g1_ggx(vx, vy, vz, mx, my, mz, au, av)
    xy2 = (au * vx) ** 2 + (av * vy) ** 2
    tan2 = xy2 / jnp.maximum(vz * vz, 1e-20)
    a = jax.lax.rsqrt(jnp.maximum(tan2, 1e-30))
    a2 = a * a
    approx = (3.535 * a + 2.181 * a2) / (1.0 + 2.276 * a + 2.577 * a2)
    g = jnp.minimum(jnp.where(a >= 1.6, 1.0, approx), 1.0)
    g = jnp.where(xy2 == 0.0, 1.0, g)
    backfacing = (vx * mx + vy * my + vz * mz) * vz <= 0.0
    return jnp.where(backfacing, 0.0, g)


def _erf(x):
    """Abramowitz & Stegun 7.1.26 (max err 1.5e-7)."""
    s = jnp.where(x >= 0, 1.0, -1.0)
    ax = jnp.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * ax)
    y = 1.0 - (((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t
                - 0.284496736) * t + 0.254829592) * t * jnp.exp(-ax * ax)
    return s * y


def _erfinv(x):
    """Giles 2010 single-precision erfinv polynomial."""
    w = -jnp.log(jnp.maximum((1.0 - x) * (1.0 + x), 1e-30))
    # central branch (w < 5)
    wc = w - 2.5
    p1 = jnp.float32(2.81022636e-08)
    for c in (3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              0.00021858087, -0.00125372503, -0.00417768164,
              0.246640727, 1.50140941):
        p1 = jnp.float32(c) + p1 * wc
    # tail branch
    wt = jnp.sqrt(jnp.maximum(w, 5.0)) - 3.0
    p2 = jnp.float32(-0.000200214257)
    for c in (0.000100950558, 0.00134934322, -0.00367342844,
              0.00573950773, -0.0076224613, 0.00943887047,
              1.00167406, 2.83297682):
        p2 = jnp.float32(c) + p2 * wt
    return jnp.where(w < 5.0, p1, p2) * x


def _sample_kernel(wix, wiy, wiz, ua, ub, la, lb, wlum,
                   au_r, av_r, gdc, gds, ipx, ipy, q, lobes, gtype, mult,
                   wox_o, woy_o, woz_o, pdf_o, lx_o, ly_o, wint_o,
                   rx_o, ry_o, rz_o, mx_o, my_o, mz_o, ok_o, *, half: int,
                   ndf: int = 0):
    wi_x, wi_y, wi_z = wix[...], wiy[...], wiz[...]
    u1, u2 = ua[...], ub[...]
    lu1, lu2 = la[...], lb[...]
    wl_um = wlum[...]
    au, av = au_r[...], av_r[...]
    cg, sg_ = gdc[...], gds[...]
    ip_x, ip_y = ipx[...], ipy[...]
    qv, lob, gt, mu_ = q[...], lobes[...], gtype[...], mult[...]

    cos_i = wi_z
    flip = cos_i < 0
    wux = jnp.where(flip, -wi_x, wi_x)
    wuy = jnp.where(flip, -wi_y, wi_y)
    wuz = jnp.where(flip, -wi_z, wi_z)

    # --- VNDF visible-normal sample, static-NDF dispatched
    # (microfacet.sample_vndf: GGX Heitz 2018 / Beckmann erf-domain Newton) ---
    vx, vy, vz = au * wux, av * wuy, wuz
    inv_n = jax.lax.rsqrt(jnp.maximum(vx * vx + vy * vy + vz * vz, 1e-24))
    vhx, vhy, vhz = vx * inv_n, vy * inv_n, vz * inv_n
    if ndf == 1:  # Beckmann (sample_vndf_beckmann)
        sin2d = vhx * vhx + vhy * vhy
        inv_l = jax.lax.rsqrt(jnp.maximum(sin2d, 1e-30))
        near_n = sin2d < 1e-14
        cos_phi = jnp.where(near_n, 1.0, vhx * inv_l)
        sin_phi = jnp.where(near_n, 0.0, vhy * inv_l)
        ct = jnp.clip(vhz, 1e-6, 1.0)
        tan_t = _safe_sqrt(1.0 - ct * ct) / ct
        cot_t = 1.0 / jnp.maximum(tan_t, 1e-12)
        maxval = _erf(jnp.minimum(cot_t, 6.0))
        uxs = jnp.clip(u1, 1e-6, 1.0 - 1e-6)
        uys = jnp.clip(u2, 1e-6, 1.0 - 1e-6)
        inv_sqrt_pi = 0.5641895835477563
        x = maxval - (maxval + 1.0) * _erf(jnp.sqrt(-jnp.log(uxs)))
        uxs = uxs * (
            1.0 + maxval + inv_sqrt_pi * tan_t * jnp.exp(-(cot_t * cot_t))
        )
        for _ in range(3):
            x = jnp.clip(x, -1.0 + 1e-6, 1.0 - 1e-6)
            slope = _erfinv(x)
            value = (1.0 + x + inv_sqrt_pi * tan_t
                     * jnp.exp(-(slope * slope)) - uxs)
            deriv = 1.0 - slope * tan_t
            x = x - value / jnp.where(
                jnp.abs(deriv) > 1e-6, deriv,
                jnp.where(deriv >= 0, 1e-6, -1e-6),
            )
        x = jnp.clip(x, -1.0 + 1e-6, 1.0 - 1e-6)
        slope_x = _erfinv(x)
        slope_y = _erfinv(2.0 * uys - 1.0)
        sxs = (cos_phi * slope_x - sin_phi * slope_y) * au
        sys_ = (sin_phi * slope_x + cos_phi * slope_y) * av
        inv_m = jax.lax.rsqrt(
            jnp.maximum(sxs * sxs + sys_ * sys_ + 1.0, 1e-24)
        )
        mx, my, mz = -sxs * inv_m, -sys_ * inv_m, inv_m
    else:  # GGX (sample_vndf_ggx)
        lensq = vhx * vhx + vhy * vhy
        inv_len = jax.lax.rsqrt(jnp.maximum(lensq, 1e-30))  # m.safe_rsqrt
        big = lensq > 1e-12
        t1x = jnp.where(big, -vhy * inv_len, 1.0)
        t1y = jnp.where(big, vhx * inv_len, 0.0)
        # t1z = 0
        t2x = vhy * 0.0 - vhz * t1y
        t2y = vhz * t1x - vhx * 0.0
        t2z = vhx * t1y - vhy * t1x
        r = jnp.sqrt(jnp.maximum(u1, 0.0))
        phi = (2.0 * m.Pi) * u2
        p1 = r * jnp.cos(phi)
        p2 = r * jnp.sin(phi)
        s = 0.5 * (1.0 + vhz)
        p2 = (1.0 - s) * _safe_sqrt(1.0 - p1 * p1) + s * p2
        p3 = _safe_sqrt(1.0 - p1 * p1 - p2 * p2)
        nhx = p1 * t1x + p2 * t2x + p3 * vhx
        nhy = p1 * t1y + p2 * t2y + p3 * vhy
        nhz = p1 * 0.0 + p2 * t2z + p3 * vhz
        mx_u, my_u, mz_u = au * nhx, av * nhy, jnp.maximum(nhz, 1e-6)
        inv_m = jax.lax.rsqrt(jnp.maximum(mx_u * mx_u + my_u * my_u + mz_u * mz_u,
                                          1e-24))  # fr.normalize default eps
        mx, my, mz = mx_u * inv_m, my_u * inv_m, mz_u * inv_m

    # pdf_vndf(wi_up, m) = G1 * |wi.m| * D / |wi_z|
    ct2 = mz * mz
    cos4 = ct2 * ct2
    inv_ct = 1.0 / jnp.maximum(jnp.abs(mz), 1e-12)
    su = (-mx * inv_ct) / au
    sv = (-my * inv_ct) / av
    s2 = su * su + sv * sv
    if ndf == 1:  # Beckmann D
        d_ndf = jnp.exp(-s2) / (
            m.Pi * au * av * jnp.maximum(cos4, 1e-20)
        )
    else:  # GGX D
        tmp = 1.0 + s2
        d_ndf = 1.0 / (m.Pi * au * av * tmp * tmp
                       * jnp.maximum(cos4, 1e-20))
    d_ndf = jnp.where(mz > 0, d_ndf, 0.0)
    g1_wi = _g1(wux, wuy, wuz, mx, my, mz, au, av, ndf)
    dot_wm = wux * mx + wuy * my + wuz * mz
    mpdf = g1_wi * jnp.abs(dot_wm) * d_ndf / jnp.maximum(jnp.abs(wuz), 1e-12)

    # reflection of the ORIGINAL wi around m (frame.reflect_n)
    dwm = wi_x * mx + wi_y * my + wi_z * mz
    rx = 2.0 * dwm * mx - wi_x
    ry = 2.0 * dwm * my - wi_y
    rz = 2.0 * dwm * mz - wi_z

    # coordinate_system(m) (Duff et al., core.frame)
    sgn = jnp.where(mz >= 0, 1.0, -1.0)
    a_c = -1.0 / (sgn + mz)
    b_c = mx * my * a_c

    def _ms(x):  # mulsign(x, mz)
        return jnp.where(mz >= 0, x, -x)

    msx = _ms(mx * mx * a_c) + 1.0
    msy = _ms(b_c)
    msz = jnp.where(mz >= 0, -mx, mx)
    mtx = b_c
    mty = my * my * a_c + sgn
    mtz = -my

    wmx = wi_x * msx + wi_y * msy + wi_z * msz
    wmy = wi_x * mtx + wi_y * mty + wi_z * mtz
    wmz = wi_x * mx + wi_y * my + wi_z * mz

    # --- order intensities at the hero wavelength ---
    is_sin = gt < 0.5
    is_rect = jnp.abs(gt - 1.0) < 0.5
    cos_t = jnp.abs(wmz)
    a_b = 4.0 * m.Pi * qv / jnp.maximum(wl_um * cos_t, 1e-12)
    base = _base_intensities(a_b, jnp.sin(a_b * 0.5), is_sin, is_rect, half)

    # --- lobe CDF walk (grating.sample_lobe) ---
    half_lobes = jnp.floor(lob * 0.5)
    ints = []
    for j in range(half + 1):
        v = base[j] * mu_
        if j == 0:
            v = v * 0.5
        ints.append(jnp.where(half_lobes >= float(j), v, 0.0))
    total = ints[0]
    for j in range(1, half + 1):
        total = total + ints[j]
    inv_tot = 1.0 / jnp.maximum(total, 1e-30)
    p_ord = [i * inv_tot for i in ints]

    def pick(u):
        rn = (u - 0.5) * 2.0
        sgn_r = jnp.where(rn >= 0, 1.0, -1.0)
        arn = jnp.abs(rn)
        cdf_excl = jnp.zeros_like(arn)
        count = jnp.zeros_like(arn)
        for j in range(half + 1):
            count = count + jnp.where(arn > cdf_excl, 1.0, 0.0)
            cdf_excl = cdf_excl + p_ord[j]
        idx = jnp.clip(count - 1.0, 0.0, float(half))
        pj = jnp.zeros_like(arn)
        for j in range(half + 1):
            pj = jnp.where(idx == float(j), p_ord[j], pj)
        pj = jnp.where(idx == 0.0, pj, pj * 0.5)
        return idx, sgn_r, pj

    ix_o, sgx, px = pick(lu1)
    iy_o, sgy, py = pick(lu2)
    lx = ix_o * sgx
    ly = iy_o * sgy

    # intensity (grating.lobe_intensity_xy: mult * I(|lx|) * I(|ly|))
    bx = jnp.zeros_like(wl_um)
    by = jnp.zeros_like(wl_um)
    for j in range(half + 1):
        bx = jnp.where(ix_o == float(j), base[j], bx)
        by = jnp.where(iy_o == float(j), base[j], by)
    is_1d = ip_y < m.Epsilon
    inten = mu_ * bx * jnp.where(is_1d, bx, by)

    # --- diffract (grating equation, plt/grating.py diffract) ---
    pxm = jnp.sqrt(wmx * wmx + wmz * wmz)
    pym = jnp.sqrt(wmy * wmy + wmz * wmz)
    sin_ix = jnp.where(pxm > m.Epsilon, wmx / jnp.maximum(pxm, 1e-20), 0.0)
    sin_iy = jnp.where(pym > m.Epsilon, wmy / jnp.maximum(pym, 1e-20), 0.0)
    lob_rx = cg * lx - sg_ * ly
    lob_ry = sg_ * lx + cg * ly
    aa = wl_um * lob_rx * ip_x - sin_ix
    bb = wl_um * lob_ry * ip_y - sin_iy
    den = aa * aa * bb * bb - 1.0
    mm_ = (aa * aa - 1.0) / jnp.where(jnp.abs(den) > 1e-12, den, 1e-12)
    qq_ = 1.0 - bb * bb * mm_
    diff_ok = (jnp.abs(aa) <= 1.0) & (jnp.abs(bb) <= 1.0)
    womx = aa * _safe_sqrt(qq_)
    womy = bb * _safe_sqrt(mm_)
    womz = _safe_sqrt(1.0 - aa * aa * qq_ - bb * bb * mm_)

    wox = msx * womx + mtx * womy + mx * womz
    woy = msy * womx + mty * womy + my * womz
    woz = msz * womx + mtz * womy + mz * womz

    grating_pdf = px * py
    dot_rm = rx * mx + ry * my + rz * mz
    pdf = mpdf * grating_pdf / jnp.maximum(4.0 * jnp.abs(dot_rm), 1e-12)

    ok = (cos_i > 0) & (mpdf > 0) & (woz > 0) & diff_ok
    g1_r = _g1(rx, ry, rz, mx, my, mz, au, av, ndf)

    wox_o[...] = wox
    woy_o[...] = woy
    woz_o[...] = woz
    pdf_o[...] = pdf
    lx_o[...] = lx
    ly_o[...] = ly
    wint_o[...] = g1_r * inten
    rx_o[...] = rx
    ry_o[...] = ry
    rz_o[...] = rz
    mx_o[...] = mx
    my_o[...] = my
    mz_o[...] = mz
    ok_o[...] = jnp.where(ok, 1.0, 0.0)


@functools.partial(jax.jit, static_argnames=("half", "ndf", "interpret"))
def grating_sample(wi, u2, lobe_u2, wl_um, alpha, grating_dir, inv_period,
                   q, lobes, gtype, multiplier, half: int,
                   ndf: int = 0, interpret: bool = False):
    """Fused roughgrating wbsdf_sample chain.

    wi [N,3] local; u2/lobe_u2 [N,2] uniforms; wl_um [N] hero wavelength
    (um); alpha [N,2]; grating params per lane. Returns dict with wo [N,3],
    pdf [N], lobe [N,2] i32, w_g1_int [N] (G1 * lobe intensity),
    reflection_dir [N,3], mvec [N,3], ok [N] bool.
    """
    ins = [
        wi[:, 0], wi[:, 1], wi[:, 2], u2[:, 0], u2[:, 1],
        lobe_u2[:, 0], lobe_u2[:, 1], wl_um, alpha[:, 0], alpha[:, 1],
        grating_dir[:, 0], grating_dir[:, 1],
        inv_period[:, 0], inv_period[:, 1], q, lobes, gtype, multiplier,
    ]
    o = _lane_call(
        functools.partial(_sample_kernel, half=half, ndf=ndf),
        ins, 14, "grating_sample", interpret, SAMPLE_WARPS,
    )
    return {
        "wo": jnp.stack(o[0:3], axis=-1),
        "pdf": o[3],
        "lobe": jnp.stack(
            [o[4].astype(jnp.int32), o[5].astype(jnp.int32)], axis=-1
        ),
        "w_g1_int": o[6],
        "reflection_dir": jnp.stack(o[7:10], axis=-1),
        "mvec": jnp.stack(o[10:13], axis=-1),
        "ok": o[13] > 0.5,
    }


# ---------------------------------------------------------------------------
# Differentiation: pallas_call has no AD rule, but the NEE eval carries the
# grating-parameter gradients (inv_period/height/multiplier/coherence — the
# quantities a PLT researcher optimizes; tests/test_ad.py FD-checks them).
# grating_lobe_sum is therefore a custom_vjp op: the PRIMAL runs the fused
# kernel; the BACKWARD linearizes a pure-XLA re-implementation of the same
# algebra at the saved inputs (runs only under jax.grad, where the extra
# memory of the [N, C, L] chain is the pre-existing AD cost anyway).
# ---------------------------------------------------------------------------


def _lobe_sum_xla(wi, wo, wl_nm, grating_dir, inv_period, q, lobes_f,
                  gtype_f, multiplier, coherence, a_cone,
                  half: int, separable: bool):
    """Reference XLA implementation of the kernel's per-wavelength sum
    (mirrors plt/wbsdf.py's eval chain; float lobes/gtype for AD)."""
    import numpy as np

    N, C = wl_nm.shape
    wl_um = wl_nm * 1e-3
    k = 2.0 * m.Pi / jnp.maximum(wl_um, 1e-6)
    side = np.arange(-half, half + 1)
    if separable:
        lx_g, ly_g = side, np.zeros_like(side)
    else:
        gx, gy = np.meshgrid(side, side, indexing="ij")
        lx_g, ly_g = gx.ravel(), gy.ravel()
    half_lobes = jnp.floor(lobes_f * 0.5)[:, None, None]
    live = (jnp.asarray(np.abs(lx_g))[None, None, :] <= half_lobes) & (
        jnp.asarray(np.abs(ly_g))[None, None, :] <= half_lobes
    )
    # order intensities (grating.order_intensities with float gtype)
    cos_t = jnp.abs(wi[..., 2])[:, None]
    a_b = 4.0 * m.Pi * q[:, None] / jnp.maximum(wl_um * cos_t, 1e-12)
    jn = m.bessel_jn_fast(a_b, half)
    sin_i = jnp.square(jn).at[..., 0].set(1.0)
    orders = jnp.arange(half + 1, dtype=jnp.float32)
    rect = (jnp.sin(a_b * 0.5)[..., None] * m.sinc(m.Pi * orders * 0.5))
    rect = rect.at[..., 0].set(1.0)
    lin = 1.0 / jnp.sqrt(jnp.maximum(orders, 1.0))
    is_sin = (gtype_f < 0.5)[:, None, None]
    is_rect = (jnp.abs(gtype_f - 1.0) < 0.5)[:, None, None]
    base = jnp.where(is_sin, sin_i,
                     jnp.where(is_rect, rect,
                               jnp.broadcast_to(lin, sin_i.shape)))
    ix = base[:, :, np.abs(lx_g)]
    is1d = (inv_period[:, 1] < m.Epsilon)[:, None, None]
    iy = jnp.where(is1d, ix, base[:, :, np.abs(ly_g)])
    lobe_int = multiplier[:, None, None] * ix * iy

    wi_x, wi_y, wi_z = wi[..., 0], wi[..., 1], wi[..., 2]
    px = jnp.sqrt(wi_x * wi_x + wi_z * wi_z)
    py = jnp.sqrt(wi_y * wi_y + wi_z * wi_z)
    sin_ix = jnp.where(px > m.Epsilon, wi_x / jnp.maximum(px, 1e-20), 0.0)
    sin_iy = jnp.where(py > m.Epsilon, wi_y / jnp.maximum(py, 1e-20), 0.0)
    cg = grating_dir[:, 0][:, None, None]
    sg = grating_dir[:, 1][:, None, None]
    lxf = jnp.asarray(lx_g, jnp.float32)[None, None, :]
    lyf = jnp.asarray(ly_g, jnp.float32)[None, None, :]
    aa = wl_um[:, :, None] * (cg * lxf - sg * lyf) \
        * inv_period[:, 0][:, None, None] - sin_ix[:, None, None]
    bb = wl_um[:, :, None] * (sg * lxf + cg * lyf) \
        * inv_period[:, 1][:, None, None] - sin_iy[:, None, None]
    den = m.sqr(aa * bb) - 1.0
    mm = (m.sqr(aa) - 1.0) / jnp.where(jnp.abs(den) > 1e-12, den, 1e-12)
    qq = 1.0 - m.sqr(bb) * mm
    lobe_ok = (jnp.abs(aa) <= 1.0) & (jnp.abs(bb) <= 1.0)
    cd_dot_wo = (
        aa * m.safe_sqrt(qq) * wo[:, 0][:, None, None]
        + bb * m.safe_sqrt(mm) * wo[:, 1][:, None, None]
        + m.safe_sqrt(1.0 - m.sqr(aa) * qq - m.sqr(bb) * mm)
        * wo[:, 2][:, None, None]
    )
    ang = m.unit_angle_dot(cd_dot_wo)
    in_cone = jnp.abs(ang) < a_cone[:, None, None]
    s = coherence[:, None] * k * (1.0 / (2.0 * m.Pi * 1e3))
    inv_det = (s * s)[:, :, None]
    ang_coh = jnp.exp(-0.5 * ang * ang * inv_det)
    is_zero = jnp.asarray((lx_g == 0) & (ly_g == 0))[None, None, :]
    contrib = jnp.where(
        lobe_ok & in_cone & live,
        lobe_int * jnp.where(is_zero, 1.0, ang_coh), 0.0,
    )
    if separable:
        ny = 2.0 * half_lobes + 1.0
        corr = jnp.where(
            is_zero & lobe_ok & in_cone & live,
            lobe_int * (ang_coh - 1.0) * (ny - 1.0), 0.0,
        )
        contrib = contrib * ny + corr
    return jnp.sum(contrib, axis=-1)


@functools.lru_cache(maxsize=None)
def _make_lobe_sum_vjp(half: int, separable: bool, n_channels: int,
                       interpret: bool):
    def impl(wi, wo, wl_nm, gd, ip, q, lob_f, gt_f, mu_, co, ac):
        return _grating_lobe_sum_impl(
            wi, wo, wl_nm, gd, ip, q, lob_f, gt_f, mu_, co, ac,
            half=half, separable=separable, n_channels=n_channels,
            interpret=interpret,
        )

    @jax.custom_vjp
    def f(wi, wo, wl_nm, gd, ip, q, lob_f, gt_f, mu_, co, ac):
        return impl(wi, wo, wl_nm, gd, ip, q, lob_f, gt_f, mu_, co, ac)

    def fwd(*args):
        return impl(*args), args

    def bwd(res, g):
        _, vjp = jax.vjp(
            lambda *a: _lobe_sum_xla(*a, half=half, separable=separable),
            *res,
        )
        return vjp(g)

    f.defvjp(fwd, bwd)
    return f
