"""Spectra, color, and hero-wavelength sampling.

- CIE 1931 XYZ color matching functions + D65 (standard public data tables,
  5nm grid 360..830nm, 95 samples — same grid as the reference,
  include/mitsuba/core/spectrum.h:126-157).
- Hero-wavelength sampling: Radziszewski et al.'s published importance
  distribution for the visible range (constants are from the paper; same ones
  the reference uses, spectrum.h sample_rgb_spectrum).
- Spectral <-> sRGB conversion.

Spectral arrays use a trailing lambda axis of size N_HERO (default 4).
"""
from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

from .math import matmul_hi as _mm

CIE_MIN = 360.0
CIE_MAX = 830.0
CIE_SAMPLES = 95
CIE_Y_NORMALIZATION = 1.0 / 106.7502593994140625
CIE_D65_NORMALIZATION = 1.0 / 98.99741751876255
N_HERO = 4

_data = np.load(os.path.join(os.path.dirname(__file__), "data_cie1931.npz"))
CIE_XYZ_TABLE = jnp.asarray(_data["xyz"])        # [3, 95]
CIE_D65_TABLE = jnp.asarray(_data["d65"])        # [95]
CIE_WAVELENGTHS = jnp.asarray(_data["wavelengths"])  # [95]

# ITU-R Rec. BT.709 linear RGB <-> CIE XYZ (D65 white point)
XYZ_TO_SRGB = jnp.asarray(
    np.array(
        [
            [3.240479, -1.537150, -0.498535],
            [-0.969256, 1.875991, 0.041556],
            [0.055648, -0.204043, 1.057311],
        ],
        np.float32,
    )
)
SRGB_TO_XYZ = jnp.asarray(np.linalg.inv(np.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ], np.float64)).astype(np.float32))


def _interp_table(table, wavelengths):
    """Linear interpolation of a [K] table defined on the CIE grid."""
    t = (wavelengths - CIE_MIN) / (CIE_MAX - CIE_MIN) * (CIE_SAMPLES - 1)
    i = jnp.clip(jnp.floor(t).astype(jnp.int32), 0, CIE_SAMPLES - 2)
    f = t - i
    val = table[i] * (1.0 - f) + table[i + 1] * f
    inside = jnp.logical_and(wavelengths >= CIE_MIN, wavelengths <= CIE_MAX)
    return jnp.where(inside, val, 0.0)


def cie1931_xyz(wavelengths):
    """CIE XYZ color matching values at `wavelengths` [nm] -> [..., 3].

    Gather-free: the linear interpolation is expressed as a soft one-hot
    [L, K] @ [K, 3] contraction at full f32 precision (exact — the weight
    row holds 1-f and f at the two bracketing table entries), in place of
    six per-lane table gathers inside hot loops."""
    flat = jnp.asarray(wavelengths, jnp.float32).reshape(-1)
    t = (flat - CIE_MIN) / (CIE_MAX - CIE_MIN) * (CIE_SAMPLES - 1)
    i = jnp.clip(jnp.floor(t).astype(jnp.int32), 0, CIE_SAMPLES - 2)
    f = (t - i)[:, None]
    k = jnp.arange(CIE_SAMPLES, dtype=jnp.int32)[None, :]
    W = jnp.where(k == i[:, None], 1.0 - f, 0.0) + jnp.where(
        k == i[:, None] + 1, f, 0.0
    )  # [L, K]
    xyz = _mm(W, CIE_XYZ_TABLE.T.astype(jnp.float32))  # [L, 3]
    inside = (flat >= CIE_MIN) & (flat <= CIE_MAX)
    xyz = jnp.where(inside[:, None], xyz, 0.0)
    return xyz.reshape(jnp.shape(wavelengths) + (3,))


def cie1931_y(wavelengths):
    return _interp_table(CIE_XYZ_TABLE[1], wavelengths)


def cie_d65(wavelengths, normalized: bool = True):
    v = _interp_table(CIE_D65_TABLE, wavelengths)
    return v * (CIE_D65_NORMALIZATION if normalized else 1.0)


def blackbody(wavelengths_nm, temperature):
    """Planck's law spectral radiance (W / (m^2 sr nm)), physics constants."""
    h = 6.62607015e-34
    c = 2.99792458e8
    kb = 1.380649e-23
    lam = wavelengths_nm * 1e-9
    p = 2.0 * h * c * c / (lam ** 5 * (jnp.exp(h * c / (lam * kb * temperature)) - 1.0))
    return p * 1e-9  # per nm


# --- hero wavelength sampling ------------------------------------------------

def sample_rgb_spectrum(sample):
    """Importance-sample the visible range (Radziszewski et al. distribution).

    Returns (wavelengths [nm], reciprocal-pdf weight).
    """
    wav = 538.0 - jnp.arctanh(0.8569106254698279 - 1.8275019724092267 * sample) * (
        138.88888888888889
    )
    tmp = jnp.cosh(0.0072 * (wav - 538.0))
    weight = 253.82 * tmp * tmp
    return wav, weight


def pdf_rgb_spectrum(wavelengths):
    tmp = jnp.cosh(0.0072 * (wavelengths - 538.0))
    pdf = 1.0 / (253.82 * tmp * tmp)
    inside = jnp.logical_and(wavelengths >= CIE_MIN, wavelengths <= CIE_MAX)
    return jnp.where(inside, pdf, 0.0)


def sample_uniform_spectrum(sample, lambda_min=CIE_MIN, lambda_max=CIE_MAX):
    span = lambda_max - lambda_min
    return lambda_min + span * sample, jnp.full_like(sample, span)


def sample_hero_wavelengths(sample, n=N_HERO, lambda_min=CIE_MIN, lambda_max=CIE_MAX):
    """One uniform sample -> n rotated hero wavelengths + recip pdf weights.

    Uses the standard hero-wavelength rotation: lambda_j derived from equally
    spaced shifts of the primary sample, each importance-sampled by the RGB
    spectrum distribution.
    """
    shifts = jnp.arange(n, dtype=jnp.float32) / n
    u = jnp.mod(sample[..., None] + shifts, 1.0)
    return sample_rgb_spectrum(u)


def spectrum_to_xyz(values, wavelengths, pdf_weights=None):
    """MC estimate: mean over the hero axis of value * xyz(lambda) [* weight]."""
    xyz_w = cie1931_xyz(wavelengths)  # [..., n, 3]
    v = values[..., None] * xyz_w
    if pdf_weights is not None:
        v = v * pdf_weights[..., None]
    return jnp.mean(v, axis=-2) * CIE_Y_NORMALIZATION


def xyz_to_srgb(xyz):
    return _mm(xyz, XYZ_TO_SRGB.T)


def srgb_to_xyz(rgb):
    return _mm(rgb, SRGB_TO_XYZ.T)


def luminance_rgb(rgb):
    w = jnp.asarray([0.212671, 0.715160, 0.072169], rgb.dtype)
    return jnp.sum(rgb * w, axis=-1)


def luminance_spectral(values, wavelengths, pdf_weights=None):
    y = cie1931_y(wavelengths)
    v = values * y
    if pdf_weights is not None:
        v = v * pdf_weights
    return jnp.mean(v, axis=-1) * CIE_Y_NORMALIZATION


# --- sRGB reflectance -> smooth spectrum (Jakob & Hanika 2019 style) ---------
#
# Rather than shipping binary rgb2spec tables, unique scene albedos are fit
# host-side at load time to the sigmoid-polynomial model
#     f(lambda) = s(c0*x^2 + c1*x + c2),   s(t) = 1/2 + t / (2 sqrt(1 + t^2))
# which is smooth, bounded to [0,1] and cheap to evaluate on device.

def sigmoid_poly_eval(coeffs, wavelengths):
    """coeffs [..., 3]; wavelengths [nm] broadcastable -> reflectance."""
    x = (wavelengths - 360.0) / (830.0 - 360.0) * 2.0 - 1.0
    t = coeffs[..., 0] * x * x + coeffs[..., 1] * x + coeffs[..., 2]
    return 0.5 + t / (2.0 * jnp.sqrt(1.0 + t * t))


def fit_srgb_to_spectrum(rgb: np.ndarray, n_iter: int = 80) -> np.ndarray:
    """Host-side Gauss-Newton fit of sigmoid-polynomial coefficients to an sRGB
    reflectance target under D65. Returns [3] coefficients (numpy)."""
    import numpy as _np

    wl = _np.linspace(360.0, 830.0, CIE_SAMPLES)
    xyz = _np.asarray(CIE_XYZ_TABLE).T  # [95, 3]
    d65 = _np.asarray(CIE_D65_TABLE)
    # Normalize so a unit reflectance maps to RGB (1,1,1)
    M = _np.asarray(XYZ_TO_SRGB)
    basis = xyz * d65[:, None]  # [95, 3]
    norm = (M @ basis.sum(0))
    x = (wl - 360.0) / 470.0 * 2.0 - 1.0
    A = _np.stack([x * x, x, _np.ones_like(x)], axis=-1)  # [95, 3]

    target = _np.asarray(rgb, _np.float64)
    c = _np.array([0.0, 0.0, _np.arctanh(_np.clip(2.0 * target.mean() - 1.0, -0.999, 0.999))])

    for _ in range(n_iter):
        t = A @ c
        s = 0.5 + t / (2.0 * _np.sqrt(1.0 + t * t))
        ds = 0.5 / (1.0 + t * t) ** 1.5
        out = (M @ (basis.T @ s)) / norm
        r = out - target
        J = (M @ (basis.T * ds[None, :]) @ A) / norm[:, None]
        try:
            step = _np.linalg.solve(J.T @ J + 1e-9 * _np.eye(3), J.T @ r)
        except _np.linalg.LinAlgError:
            break
        c = c - step
        if _np.abs(step).max() < 1e-10:
            break
    return c.astype(_np.float32)
