"""Core math utilities for the renderer.

Vectorized special functions, numeric helpers and epsilon conventions.
Behavioural parity targets (reference, for documentation only — independent
implementation): /root/reference/include/mitsuba/core/math.h (RayEpsilon:18-23,
bessel_j:280-347).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

Pi = 3.14159265358979323846
InvPi = 1.0 / Pi
TwoPi = 2.0 * Pi
InvTwoPi = 1.0 / TwoPi
InvFourPi = 1.0 / (4.0 * Pi)
SqrtPi = 1.77245385090551602793
InvSqrtPi = 1.0 / SqrtPi

# float32 machine epsilon / 2 is what drjit calls Epsilon
Epsilon = float(jnp.finfo(jnp.float32).eps) / 2.0
RayEpsilon = Epsilon * 1500.0          # ~8.9e-5
ShadowEpsilon = RayEpsilon * 10.0      # ~8.9e-4
ShapeEpsilon = RayEpsilon / 80.0
Infinity = float("inf")


def sqr(x):
    return x * x


def safe_sqrt(x):
    """sqrt clamped at 0 with a NaN-free gradient (plain sqrt's vjp is
    0.5/sqrt(x) = inf at 0, which turns a zero cotangent into NaN)."""
    pos = x > 0
    return jnp.sqrt(jnp.where(pos, x, 1.0)) * pos.astype(
        jnp.result_type(x, jnp.float32)
    )


def safe_rsqrt(x):
    return jax.lax.rsqrt(jnp.maximum(x, 1e-30))


def safe_acos(x):
    return jnp.arccos(jnp.clip(x, -1.0, 1.0))


def safe_asin(x):
    return jnp.arcsin(jnp.clip(x, -1.0, 1.0))


def rcp(x):
    return 1.0 / x


def safe_rcp(x, eps=1e-20):
    """Reciprocal that returns 0 where |x| is (near) zero."""
    return jnp.where(jnp.abs(x) > eps, 1.0 / jnp.where(jnp.abs(x) > eps, x, 1.0), 0.0)


def mulsign(x, s):
    """x * sign(s) with sign(0) == +1 (copysign semantics on the sign bit)."""
    return jnp.where(s >= 0, x, -x)


def mulsign_neg(x, s):
    return jnp.where(s >= 0, -x, x)


def sign(x):
    """sign with sign(0) == +1 (drjit convention)."""
    return jnp.where(x >= 0, 1.0, -1.0)


def lerp(a, b, t):
    return a * (1.0 - t) + b * t


def fmadd(a, b, c):
    return a * b + c


def select(mask, a, b):
    return jnp.where(mask, a, b)


def clamp(x, lo, hi):
    return jnp.clip(x, lo, hi)


def hypot2(a, b):
    return jnp.sqrt(a * a + b * b)


def unit_angle(u, v):
    """Numerically well-behaved angle between two *unit* vectors.

    Uses the half-angle formulation 2*asin(|u -/+ v|/2) which is accurate for
    both small and near-pi angles (unlike acos(dot)).
    """
    dot_uv = jnp.sum(u * v, axis=-1)
    d = jnp.linalg.norm(jnp.where(dot_uv[..., None] < 0, u + v, u - v), axis=-1)
    theta = 2.0 * safe_asin(0.5 * d)
    return jnp.where(dot_uv < 0, Pi - theta, theta)


def unit_angle_dot(dot_uv):
    """unit_angle from the dot product alone (|u-v|^2 = 2 - 2 u.v for unit
    vectors) — lets callers avoid materializing broadcasted 3-vectors.
    safe_sqrt: at |dot| = 1 the plain sqrt vjp is infinite."""
    d = safe_sqrt(2.0 - 2.0 * jnp.abs(dot_uv))
    theta = 2.0 * safe_asin(0.5 * d)
    return jnp.where(dot_uv < 0, Pi - theta, theta)


# ---------------------------------------------------------------------------
# Composite Simpson quadrature (used by bessel_j_small); static point count so
# it unrolls at trace time into pure vector math.
# ---------------------------------------------------------------------------

def integrate_simpson(f, a, b, points: int = 20):
    """Composite Simpson integration of callable `f` over [a, b].

    `points` must be even; f is evaluated at points+1 static abscissae and may
    return batched arrays.
    """
    assert points % 2 == 0, "Simpson rule needs an even interval count"
    h = (b - a) / points
    # Evaluate at all nodes in one shot: shape (points+1,) broadcast against f's batch
    ts = a + h * jnp.arange(points + 1, dtype=jnp.float32)
    vals = jax.vmap(f, in_axes=0, out_axes=-1)(ts)  # [..., points+1]
    w = jnp.ones(points + 1, dtype=jnp.float32)
    w = w.at[1:-1:2].set(4.0)
    w = w.at[2:-1:2].set(2.0)
    return (h / 3.0) * jnp.sum(vals * w, axis=-1)


# ---------------------------------------------------------------------------
# Bessel function of the first kind J_nu(x), vectorized, f32.
#
# The reference fork blends a 20-point Simpson integral with a one-term
# asymptotic form (math.h:280-347); that scheme loses multiple digits in the
# oscillatory crossover region.  We instead use Miller's downward recurrence
# (normalized by J0 + 2*sum J_2k = 1), which yields *all* orders 0..n_max in
# one O(M) vector sweep — exactly what the grating lobe loop consumes — and
# is accurate to f32 roundoff for |x| <= ~0.8*M.  Very large |x| falls back
# to the two-term Hankel asymptotic expansion.
# ---------------------------------------------------------------------------

_BESSEL_M = 160          # recurrence start order: accurate for |x| <= ~128
_BESSEL_X_SWITCH = 100.0  # beyond this, use the asymptotic expansion


def bessel_jn(x, n_max: int, M: int = _BESSEL_M):
    """J_0(|x|) .. J_{n_max}(|x|) by Miller's algorithm.

    Returns array [..., n_max+1]. Caller applies parity for negative x/order.
    Accurate (f32 level) for |x| up to about 0.8*M.
    """
    x_abs = jnp.abs(jnp.asarray(x, jnp.float32))
    # substitute a SAFE argument (not a clamp) outside the recurrence's
    # domain: below the exact-value cutoff and above the asymptotic switch
    # the PRIMAL is rescued by selects, but the recurrence's intermediate
    # partial derivatives overflow to inf and the masked-out cotangent
    # turns 0 * inf = NaN (the double-where rule).
    unsafe = (x_abs < 1e-6) | (x_abs > _BESSEL_X_SWITCH)
    x_safe = jnp.where(unsafe, 1.0, x_abs)
    inv_x = 1.0 / x_safe

    order_idx = jnp.arange(n_max + 1, dtype=jnp.int32)  # static small axis

    def body(i, carry):
        jp1, jk, norm, outs = carry
        k = (M - i).astype(jnp.float32)  # i = 0..M-1  ->  k = M..1
        jm1 = (2.0 * k) * inv_x * jk - jp1
        jp1, jk = jk, jm1
        # prevent f32 overflow of the unnormalized recurrence
        scale = jnp.where(jnp.abs(jk) > 1e18, 1e-18, 1.0)
        jp1 = jp1 * scale
        jk = jk * scale
        norm = norm * scale
        outs = outs * scale[..., None]
        kk = (M - i - 1).astype(jnp.int32)  # jk now holds (unnormalized) J_{kk}
        outs = jnp.where(order_idx == kk, jk[..., None], outs)
        even = (kk % 2) == 0
        contrib = jnp.where(kk == 0, jk, 2.0 * jk)
        norm = norm + jnp.where(even, contrib, 0.0)
        return jp1, jk, norm, outs

    init = (
        jnp.zeros_like(x_safe),                      # J_{k+1}
        jnp.full_like(x_safe, 1e-30),                # J_k (arbitrary scale)
        jnp.zeros_like(x_safe),                      # norm: J0 + 2*sum J_{2k}
        jnp.zeros((*x_safe.shape, n_max + 1), jnp.float32),
    )
    _, _, norm, outs = jax.lax.fori_loop(
        0, M, body, init, unroll=4
    )

    res = outs / jnp.maximum(jnp.abs(norm), 1e-30)[..., None]
    res = res * jnp.sign(norm)[..., None]
    # exact values at x == 0
    at_zero = (x_abs < 1e-6)[..., None]
    exact0 = jnp.zeros(n_max + 1, jnp.float32).at[0].set(1.0)
    return jnp.where(at_zero, exact0, res)


def bessel_jn_fast(x, n_max: int, M: int = 64):
    """J_0..J_{n_max} tuned for the grating hot loop.

    Two-stage Miller recurrence: the first M-(n_max+1) steps carry only
    (J_{k+1}, J_k, norm) — keeping the output block out of the loop carry
    halves the HBM traffic of the sweep — then a short unrolled tail emits
    orders n_max..0.  Valid to f32 roundoff for |x| <= ~0.8*M; beyond that
    the two-term Hankel asymptotic expansion takes over (where it is
    accurate, since |x| >> n_max^2 there).
    """
    x_abs = jnp.abs(jnp.asarray(x, jnp.float32))
    # asymptotic switch lowered to 0.5*M: the recurrence's GRADIENT blows
    # up from ~0.56*M (measured NaN at x >= 36 with M = 64) even where its
    # primal is still fine, so both the select and the safe-substitution
    # (see bessel_jn: 0 * inf under the double-where rule) move to 0.5*M.
    # The two-term Hankel form is within ~3%% for nu <= 4 there and
    # carries the gradient.
    switch = 0.5 * M
    unsafe = (x_abs < 1e-6) | (x_abs > switch)
    x_safe = jnp.where(unsafe, 1.0, x_abs)
    inv_x = 1.0 / x_safe

    def step(k, jp1, jk, norm):
        jm1 = (2.0 * k) * inv_x * jk - jp1
        jp1, jk = jk, jm1
        scale = jnp.where(jnp.abs(jk) > 1e18, 1e-18, 1.0)
        kk = k - 1.0  # jk now holds J_{kk}
        even = (jnp.asarray(kk, jnp.int32) % 2) == 0
        contrib = jnp.where(kk == 0, jk, 2.0 * jk)
        norm = norm + jnp.where(even, contrib, 0.0)
        return jp1 * scale, jk * scale, norm * scale, scale

    def body(i, carry):
        jp1, jk, norm = carry
        k = (M - i).astype(jnp.float32)
        jp1, jk, norm, _ = step(k, jp1, jk, norm)
        return jp1, jk, norm

    init = (
        jnp.zeros_like(x_safe),
        jnp.full_like(x_safe, 1e-30),
        jnp.zeros_like(x_safe),
    )
    n_head = M - (n_max + 1)
    jp1, jk, norm = jax.lax.fori_loop(0, n_head, body, init, unroll=8)

    outs = [None] * (n_max + 1)
    for i in range(n_head, M):
        k = float(M - i)
        jp1, jk, norm, scale = step(k, jp1, jk, norm)
        kk = M - i - 1
        outs[kk] = jk
        for j in range(kk + 1, n_max + 1):
            outs[j] = outs[j] * scale

    res = jnp.stack(outs, axis=-1)
    res = res / jnp.maximum(jnp.abs(norm), 1e-30)[..., None]
    res = res * jnp.sign(norm)[..., None]

    orders = jnp.arange(n_max + 1, dtype=jnp.float32)
    asym = bessel_j_asymp(x_abs[..., None], orders)
    res = jnp.where((x_abs > switch)[..., None], asym, res)

    at_zero = (x_abs < 1e-6)[..., None]
    exact0 = jnp.zeros(n_max + 1, jnp.float32).at[0].set(1.0)
    return jnp.where(at_zero, exact0, res)


def bessel_j_asymp(x, nu):
    """Two-term Hankel asymptotic expansion; accurate for |x| >> nu^2."""
    x_abs = jnp.abs(jnp.asarray(x, jnp.float32))
    x_safe = jnp.maximum(x_abs, 1e-12)
    nub = jnp.asarray(nu, jnp.float32)
    mu = 4.0 * nub * nub
    i8x = 1.0 / (8.0 * x_safe)
    p = 1.0 - (mu - 1.0) * (mu - 9.0) * 0.5 * i8x * i8x
    q = (mu - 1.0) * i8x
    omega = x_abs - (0.5 * nub + 0.25) * Pi
    val = jnp.sqrt(2.0 / (Pi * x_safe)) * (
        jnp.cos(omega) * p - jnp.sin(omega) * q
    )
    tiny = x_abs <= 10.0 * Epsilon
    return jnp.where(tiny, jnp.where(nub == 0, 1.0, 0.0), val)


def bessel_j(x, nu):
    """J_nu(x) for integer scalar-or-array order nu, vectorized over x.

    Miller recurrence for |x| <= 100, two-term asymptotics beyond; parity
    identities J_{-n}(x) = (-1)^n J_n(x), J_n(-x) = (-1)^n J_n(x).
    """
    x = jnp.asarray(x, jnp.float32)
    nu_arr = jnp.asarray(nu)
    n_max = int(jnp.max(jnp.abs(nu_arr)))  # static: orders are lobe indices
    nu_abs = jnp.abs(nu_arr).astype(jnp.int32)

    all_orders = bessel_jn(x, n_max)  # [..., n_max+1] at |x|
    j_small = jnp.take_along_axis(
        all_orders,
        jnp.broadcast_to(nu_abs, x.shape)[..., None],
        axis=-1,
    )[..., 0]
    j_large = bessel_j_asymp(x, nu_abs.astype(jnp.float32))
    j_pos = jnp.where(jnp.abs(x) > _BESSEL_X_SWITCH, j_large, j_small)

    odd = (nu_abs % 2) == 1
    parity = jnp.where(odd, -1.0, 1.0)
    out = j_pos
    out = jnp.where(nu_arr < 0, parity * out, out)
    out = jnp.where(x < 0, parity * out, out)
    return out


def sinc(x):
    """Unnormalized sinc: sin(x)/x with sinc(0) = 1."""
    x_safe = jnp.where(jnp.abs(x) < 1e-8, 1.0, x)
    return jnp.where(jnp.abs(x) < 1e-8, 1.0, jnp.sin(x_safe) / x_safe)


def matmul_hi(a, b):
    """a @ b at full f32 precision: on the GPU a default-precision f32
    contraction may run in TF32 (~3 decimal digits), which would shift
    camera rays, colours and Mueller frames."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def small_gather(table, idx, threshold: int = 128):
    """Row fetch table[idx] for small tables via a one-hot [N, T] @ [T, D]
    contraction at full f32 precision (exact for 0/1 selectors), chosen
    over a random row gather inside scan bodies. Falls back to a plain
    gather for larger tables. Which is faster on the GPU is ROADMAP S6.
    """
    T = table.shape[0]
    if table.ndim != 2:
        return table[idx]
    if T <= 8:
        # tiny table: chain of broadcast selects — one fused elementwise
        # pass over [N, D] with the T rows living in registers (a
        # compare+masked-sum would materialize a [N, T, D] intermediate)
        out = jnp.broadcast_to(table[0], (idx.shape[0], table.shape[1]))
        for t in range(1, T):
            out = jnp.where((idx == t)[:, None], table[t], out)
        return out
    if T > threshold or table.shape[1] < 8:
        return table[idx]
    oh = (idx[:, None] == jnp.arange(T, dtype=idx.dtype)[None, :]).astype(
        table.dtype
    )
    return jax.lax.dot_general(
        oh, table, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=table.dtype,
    )


def select_along(rows, idx):
    """rows[n, idx[n]] for small static last dims via compare+masked-sum
    (take_along_axis would be a per-lane gather inside the scan)."""
    T = rows.shape[-1]
    iota = jnp.arange(T, dtype=idx.dtype)
    return jnp.sum(jnp.where(idx[..., None] == iota, rows, 0), axis=-1)


def find_interval(cdf, x):
    """Binary-search index i such that cdf[i] <= x < cdf[i+1] (batched).

    cdf: [..., K] monotone array (shared leading dims broadcastable with x).
    Returns int32 indices clipped to [0, K-2].
    """
    idx = jnp.searchsorted(cdf, x, side="right") - 1
    return jnp.clip(idx, 0, cdf.shape[-1] - 2)


def morton_encode2(x, y):
    """Interleave bits of two uint32 (lower 16 bits each) — utility for tiling."""
    def part(v):
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    x = part(jnp.asarray(x, jnp.uint32))
    y = part(jnp.asarray(y, jnp.uint32))
    return x | (y << 1)
