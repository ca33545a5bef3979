"""RGL measured-material BSDF (reference src/bsdfs/measured.cpp + the
tensor-file container src/core/tensor.cpp).

Data model: the Dupuy-Jakob adaptive BRDF parameterization. A measurement
ships as a "tensor_file" with fields theta_i/phi_i (incident grids),
ndf/sigma (microfacet NDF + projected area on the u_m unit-square grid),
vndf (per-incident-slice visible-NDF warp densities), luminance (per-slice
importance), spectra or rgb (reflectance over the *warped* sample square),
and a jacobian flag.

Deviations from the reference (documented, self-consistent):
- the reference's Marginal2D parameter interpolation (lazy 4-slice bilinear
  CDF mixing, include/mitsuba/core/distr_2d.h) is replaced by STOCHASTIC
  SLICE MIXTURE sampling: each lane picks one neighboring (phi_i, theta_i)
  measurement slice with probability equal to its bilinear weight (using
  sample1, which the reference discards), then samples that slice's warp
  exactly. The realized density is exactly the mixture sum(w_s * p_s), and
  pdf() evaluates the same mixture in closed form, so sample/pdf agree by
  construction (chi2-tested).
- warp inversion (needed to address the spectra tables) is evaluated per
  slice and mixture-averaged.
- table fetches are XLA dynamic row gathers; measured lanes are niche
  relative to the analytic-BSDF hot path, so correctness wins over the
  one-hot-matmul trick used for small tables.
"""
from __future__ import annotations

import dataclasses
import struct as _struct
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..core import frame as fr
from ..core import math as m

# ---------------------------------------------------------------------------
# tensor_file container IO (src/core/tensor.cpp:7-53)
# ---------------------------------------------------------------------------

_DTYPES = {
    1: np.uint8, 2: np.int8, 3: np.uint16, 4: np.int16,
    5: np.uint32, 6: np.int32, 7: np.uint64, 8: np.int64,
    9: np.float16, 10: np.float32, 11: np.float64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def read_tensor_file(path: str) -> dict:
    """Parse an RGL tensor_file into {name: np.ndarray}."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:12] != b"tensor_file\x00":
        raise ValueError(f"{path}: not a tensor_file (bad magic)")
    n_fields = _struct.unpack_from("<I", raw, 14)[0]
    pos = 18
    out = {}
    for _ in range(n_fields):
        (name_len,) = _struct.unpack_from("<H", raw, pos)
        pos += 2
        name = raw[pos : pos + name_len].decode()
        pos += name_len
        ndim, dtype = _struct.unpack_from("<HB", raw, pos)
        pos += 3
        (offset,) = _struct.unpack_from("<Q", raw, pos)
        pos += 8
        shape = _struct.unpack_from("<" + "Q" * ndim, raw, pos)
        pos += 8 * ndim
        dt = _DTYPES[dtype]
        count = int(np.prod(shape)) if ndim else 1
        arr = np.frombuffer(raw, dtype=dt, count=count, offset=offset)
        out[name] = arr.reshape(shape).copy()
    return out


def write_tensor_file(path: str, fields: dict):
    """Write {name: np.ndarray} as a tensor_file (tests + tooling)."""
    header = b"tensor_file\x00" + bytes([1, 0])
    items = list(fields.items())
    header += _struct.pack("<I", len(items))
    # first pass: compute header size
    meta_size = 18
    for name, arr in items:
        meta_size += 2 + len(name.encode()) + 3 + 8 + 8 * np.ndim(arr)
    body = b""
    meta = b""
    offset = meta_size
    for name, arr in items:
        arr = np.ascontiguousarray(arr)
        nb = name.encode()
        meta += _struct.pack("<H", len(nb)) + nb
        meta += _struct.pack("<HB", arr.ndim, _DTYPE_CODES[arr.dtype])
        meta += _struct.pack("<Q", offset)
        meta += _struct.pack("<" + "Q" * arr.ndim, *arr.shape)
        body += arr.tobytes()
        offset += arr.nbytes
    with open(path, "wb") as f:
        f.write(header + meta + body)


# ---------------------------------------------------------------------------
# Continuous 2D marginal warp over a bilinear density grid.
# Equivalent role to Marginal2D<.., Continuous=true> (distr_2d.h): density is
# the bilinear interpolant of node values on a [Ry, Rx] unit-square grid;
# sampling inverts the exact piecewise-quadratic CDFs.
# ---------------------------------------------------------------------------

def _warp_tables_np(D: np.ndarray):
    """Host precompute for one slice. D [Ry, Rx] nonnegative node values.
    Returns (Dn, row_int, marg_cdf, cond_cdf, total):
      Dn        normalized node values (density integrates to 1)
      row_int   [Ry]  integral of each node row's linear interpolant in x
      marg_cdf  [Ry-1] cumulative band integrals (last = 1)
      cond_cdf  [Ry, Rx] cumulative trapezoids along x per node row
    """
    D = np.asarray(D, np.float64)
    ry, rx = D.shape
    dx = 1.0 / (rx - 1)
    dy = 1.0 / (ry - 1)
    trap = 0.5 * (D[:, :-1] + D[:, 1:]) * dx           # [Ry, Rx-1]
    row_int = trap.sum(axis=1)                          # [Ry]
    band = 0.5 * (row_int[:-1] + row_int[1:]) * dy      # [Ry-1]
    total = band.sum()
    total = total if total > 0 else 1.0
    Dn = D / total
    row_int = row_int / total
    marg_cdf = np.cumsum(band / total)
    marg_cdf[-1] = 1.0
    cond = np.zeros((ry, rx))
    cond[:, 1:] = np.cumsum(trap / total, axis=1)
    return (
        Dn.astype(np.float32), row_int.astype(np.float32),
        marg_cdf.astype(np.float32), cond.astype(np.float32),
        np.float32(total),
    )


def _solve_quad(a, b, xi):
    """Smallest positive root of (a/2) t^2 + b t - xi = 0, clamped to [0,1]
    (inverse CDF within one cell of a linear density: b = d0, a = d1 - d0)."""
    disc = jnp.maximum(b * b + 2.0 * a * xi, 0.0)
    lin = xi / jnp.maximum(b, 1e-12)
    quad = (jnp.sqrt(disc) - b) / jnp.where(jnp.abs(a) > 1e-9, a, 1.0)
    t = jnp.where(jnp.abs(a) > 1e-9, quad, lin)
    return jnp.clip(t, 0.0, 1.0)


def warp_sample(sl, u1, u2, Dn, row_int, marg_cdf, cond_cdf):
    """Sample the slice warp. sl [N] flat slice index; u1/u2 in [0,1).
    Tables: Dn [S, Ry, Rx], row_int [S, Ry], marg_cdf [S, Ry-1],
    cond_cdf [S, Ry, Rx]. Returns (x, y, pdf) with pdf the normalized
    unit-square density at (x, y)."""
    S, ry, rx = Dn.shape
    dx = 1.0 / (rx - 1)
    dy = 1.0 / (ry - 1)
    mc = marg_cdf[sl]                                   # [N, Ry-1]
    i = jnp.clip(
        jnp.sum((mc < u1[..., None]).astype(jnp.int32), axis=-1), 0, ry - 2
    )
    prev = jnp.where(
        i > 0, jnp.take_along_axis(mc, jnp.maximum(i - 1, 0)[..., None], -1)[..., 0], 0.0
    )
    xi_band = jnp.maximum(u1 - prev, 0.0)
    ri = row_int[sl]                                    # [N, Ry]
    r0 = jnp.take_along_axis(ri, i[..., None], -1)[..., 0]
    r1 = jnp.take_along_axis(ri, (i + 1)[..., None], -1)[..., 0]
    t = _solve_quad((r1 - r0) * dy, r0 * dy, xi_band)
    y = (i.astype(jnp.float32) + t) * dy

    cc = cond_cdf[sl]                                   # [N, Ry, Rx]
    cc_t = (
        jnp.take_along_axis(cc, i[..., None, None], -2)[..., 0, :] * (1.0 - t[..., None])
        + jnp.take_along_axis(cc, (i + 1)[..., None, None], -2)[..., 0, :] * t[..., None]
    )                                                    # [N, Rx]
    m_row = jnp.maximum(r0 + (r1 - r0) * t, 1e-12)
    xi2 = u2 * m_row
    j = jnp.clip(
        jnp.sum((cc_t <= xi2[..., None]).astype(jnp.int32), axis=-1) - 1,
        0, rx - 2,
    )
    cj = jnp.take_along_axis(cc_t, j[..., None], -1)[..., 0]
    xi_cell = jnp.maximum(xi2 - cj, 0.0)
    Drows = Dn[sl]                                       # [N, Ry, Rx]
    Di = (
        jnp.take_along_axis(Drows, i[..., None, None], -2)[..., 0, :] * (1.0 - t[..., None])
        + jnp.take_along_axis(Drows, (i + 1)[..., None, None], -2)[..., 0, :] * t[..., None]
    )                                                    # [N, Rx] lerped row
    d0 = jnp.take_along_axis(Di, j[..., None], -1)[..., 0]
    d1 = jnp.take_along_axis(Di, (j + 1)[..., None], -1)[..., 0]
    s = _solve_quad((d1 - d0) * dx, d0 * dx, xi_cell)
    x = (j.astype(jnp.float32) + s) * dx
    pdf = jnp.maximum(d0 + (d1 - d0) * s, 0.0)
    return x, y, pdf


def warp_invert(sl, x, y, Dn, row_int, marg_cdf, cond_cdf):
    """Inverse of warp_sample: (x, y) -> (u1, u2, pdf)."""
    S, ry, rx = Dn.shape
    dx = 1.0 / (rx - 1)
    dy = 1.0 / (ry - 1)
    fy = jnp.clip(y, 0.0, 1.0) * (ry - 1)
    i = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, ry - 2)
    t = fy - i
    ri = row_int[sl]
    r0 = jnp.take_along_axis(ri, i[..., None], -1)[..., 0]
    r1 = jnp.take_along_axis(ri, (i + 1)[..., None], -1)[..., 0]
    mc = marg_cdf[sl]
    prev = jnp.where(
        i > 0, jnp.take_along_axis(mc, jnp.maximum(i - 1, 0)[..., None], -1)[..., 0], 0.0
    )
    u1 = prev + (r0 * t + 0.5 * (r1 - r0) * t * t) * dy

    fx = jnp.clip(x, 0.0, 1.0) * (rx - 1)
    j = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, rx - 2)
    s = fx - j
    cc = cond_cdf[sl]
    cc_t = (
        jnp.take_along_axis(cc, i[..., None, None], -2)[..., 0, :] * (1.0 - t[..., None])
        + jnp.take_along_axis(cc, (i + 1)[..., None, None], -2)[..., 0, :] * t[..., None]
    )
    cj = jnp.take_along_axis(cc_t, j[..., None], -1)[..., 0]
    Drows = Dn[sl]
    Di = (
        jnp.take_along_axis(Drows, i[..., None, None], -2)[..., 0, :] * (1.0 - t[..., None])
        + jnp.take_along_axis(Drows, (i + 1)[..., None, None], -2)[..., 0, :] * t[..., None]
    )
    d0 = jnp.take_along_axis(Di, j[..., None], -1)[..., 0]
    d1 = jnp.take_along_axis(Di, (j + 1)[..., None], -1)[..., 0]
    xi2 = cj + (d0 * s + 0.5 * (d1 - d0) * s * s) * dx
    m_row = jnp.maximum(r0 + (r1 - r0) * t, 1e-12)
    u2 = jnp.clip(xi2 / m_row, 0.0, 1.0)
    pdf = jnp.maximum(d0 + (d1 - d0) * s, 0.0)
    return u1, u2, pdf


def grid_eval(sl, x, y, table):
    """Plain bilinear evaluation of table [S, Ry, Rx] at (x, y)."""
    S, ry, rx = table.shape
    fy = jnp.clip(y, 0.0, 1.0) * (ry - 1)
    fx = jnp.clip(x, 0.0, 1.0) * (rx - 1)
    i = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, ry - 2)
    j = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, rx - 2)
    t = (fy - i)[..., None]
    rows = table[sl]                                    # [N, Ry, Rx]
    Di = (
        jnp.take_along_axis(rows, i[..., None, None], -2)[..., 0, :] * (1.0 - t)
        + jnp.take_along_axis(rows, (i + 1)[..., None, None], -2)[..., 0, :] * t
    )
    s = fx - j
    d0 = jnp.take_along_axis(Di, j[..., None], -1)[..., 0]
    d1 = jnp.take_along_axis(Di, (j + 1)[..., None], -1)[..., 0]
    return d0 + (d1 - d0) * s


# ---------------------------------------------------------------------------
# Stacked measured-material tables
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MeasuredTables:
    """K measured materials, padded to common grid sizes. Slice axis order:
    flat slice index sl = (k * NPI + pi) * NTI + ti."""

    theta_i: Any     # [K, NTI] incident elevations (radians, padded w/ last)
    phi_i: Any       # [K, NPI] incident azimuths
    n_theta_i: Any   # [K] int32 valid counts
    n_phi_i: Any     # [K] int32
    ndf: Any         # [K, Ry, Rx]
    sigma: Any       # [K, Ry, Rx]
    # vndf warp (S = K*NPI*NTI slices)
    vndf_d: Any      # [S, Ry, Rx] normalized density
    vndf_row: Any    # [S, Ry]
    vndf_marg: Any   # [S, Ry-1]
    vndf_cond: Any   # [S, Ry, Rx]
    # luminance warp
    lum_d: Any
    lum_row: Any
    lum_marg: Any
    lum_cond: Any
    # spectra [K*NWL*NPI*NTI? no: [K, NPI, NTI, NWL, Ry, Rx] flattened to
    # rows [K*NPI*NTI*NWL, Ry, Rx] with sl_spec = (sl * NWL + w)
    spectra: Any     # [S*NWL, Ry, Rx]
    wavelengths: Any  # [K, NWL] (RGB mode: 0, 1, 2)
    jacobian: Any    # [K] bool
    isotropic: Any   # [K] bool
    reduction: Any = None  # [K] int32 symmetry reduction (measured.cpp:169-172)

    n_wl: int = dataclasses.field(default=3, metadata=dict(static=True))
    spectral: bool = dataclasses.field(default=False, metadata=dict(static=True))


def build_measured_tables(datasets: list) -> MeasuredTables:
    """Stack parsed tensor-file dicts (RGB or spectral) into device tables."""
    K = len(datasets)
    NTI = max(2, max(int(d["theta_i"].shape[0]) for d in datasets))
    NPI = max(1, max(int(d["phi_i"].shape[0]) for d in datasets))
    Ry = max(int(d["vndf"].shape[2]) for d in datasets)
    Rx = max(int(d["vndf"].shape[3]) for d in datasets)
    spectral = any("wavelengths" in d for d in datasets)
    NWL = max(
        int(d["spectra"].shape[2]) if "spectra" in d else 3 for d in datasets
    ) if spectral else 3

    theta_i = np.zeros((K, NTI), np.float32)
    phi_i = np.zeros((K, NPI), np.float32)
    n_ti = np.zeros(K, np.int32)
    n_pi = np.zeros(K, np.int32)
    ndf = np.zeros((K, Ry, Rx), np.float32)
    sigma = np.ones((K, Ry, Rx), np.float32)
    S = K * NPI * NTI
    vndf_d = np.zeros((S, Ry, Rx), np.float32)
    vndf_row = np.zeros((S, Ry), np.float32)
    vndf_marg = np.ones((S, Ry - 1), np.float32)
    vndf_cond = np.zeros((S, Ry, Rx), np.float32)
    lum_d = np.zeros_like(vndf_d)
    lum_row = np.zeros_like(vndf_row)
    lum_marg = np.ones_like(vndf_marg)
    lum_cond = np.zeros_like(vndf_cond)
    spectra = np.zeros((S * NWL, Ry, Rx), np.float32)
    wavelengths = np.zeros((K, NWL), np.float32)
    jac = np.zeros(K, bool)
    iso = np.zeros(K, bool)
    red = np.ones(K, np.int32)

    for k, d in enumerate(datasets):
        nti = int(d["theta_i"].shape[0])
        npi = int(d["phi_i"].shape[0])
        n_ti[k], n_pi[k] = nti, npi
        theta_i[k, :nti] = d["theta_i"]
        theta_i[k, nti:] = d["theta_i"][-1] if nti else 0
        phi_i[k, :npi] = d["phi_i"]
        phi_i[k, npi:] = d["phi_i"][-1] if npi else 0
        ry, rx = d["ndf"].shape
        ndf[k, :ry, :rx] = d["ndf"]
        sigma[k, :ry, :rx] = d["sigma"]
        jac[k] = bool(np.asarray(d["jacobian"]).ravel()[0])
        iso[k] = npi <= 2
        if npi > 2:
            span = float(d["phi_i"][-1] - d["phi_i"][0])
            red[k] = int(round(2.0 * np.pi / span)) if span > 0 else 1
        spec_field = d["spectra"] if "spectra" in d else d["rgb"]
        nwl = spec_field.shape[2]
        if "wavelengths" in d:
            wavelengths[k, :nwl] = d["wavelengths"]
        else:
            wavelengths[k, :nwl] = np.arange(nwl)
        for pi in range(npi):
            for ti in range(nti):
                sl = (k * NPI + pi) * NTI + ti
                vd, vr, vm, vc, _ = _warp_tables_np(d["vndf"][pi, ti])
                vndf_d[sl, :ry, :rx] = vd
                vndf_row[sl, :ry] = vr
                vndf_marg[sl, : ry - 1] = vm
                vndf_cond[sl, :ry, :rx] = vc
                ld, lr, lm, lc, _ = _warp_tables_np(d["luminance"][pi, ti])
                lum_d[sl, :ry, :rx] = ld
                lum_row[sl, :ry] = lr
                lum_marg[sl, : ry - 1] = lm
                lum_cond[sl, :ry, :rx] = lc
                for w in range(nwl):
                    spectra[sl * NWL + w, :ry, :rx] = spec_field[pi, ti, w]
        # replicate edge slices into padded (pi, ti) positions so the
        # neighbor indexing in _slice_weights never reads zeros
        for pi in range(NPI):
            src_pi = min(pi, npi - 1)
            for ti in range(NTI):
                src_ti = min(ti, nti - 1)
                if pi == src_pi and ti == src_ti:
                    continue
                dst = (k * NPI + pi) * NTI + ti
                src = (k * NPI + src_pi) * NTI + src_ti
                for arr in (vndf_d, vndf_row, vndf_marg, vndf_cond,
                            lum_d, lum_row, lum_marg, lum_cond):
                    arr[dst] = arr[src]
                for w in range(NWL):
                    spectra[dst * NWL + w] = spectra[src * NWL + w]

    return MeasuredTables(
        theta_i=jnp.asarray(theta_i), phi_i=jnp.asarray(phi_i),
        n_theta_i=jnp.asarray(n_ti), n_phi_i=jnp.asarray(n_pi),
        ndf=jnp.asarray(ndf), sigma=jnp.asarray(sigma),
        vndf_d=jnp.asarray(vndf_d), vndf_row=jnp.asarray(vndf_row),
        vndf_marg=jnp.asarray(vndf_marg), vndf_cond=jnp.asarray(vndf_cond),
        lum_d=jnp.asarray(lum_d), lum_row=jnp.asarray(lum_row),
        lum_marg=jnp.asarray(lum_marg), lum_cond=jnp.asarray(lum_cond),
        spectra=jnp.asarray(spectra), wavelengths=jnp.asarray(wavelengths),
        jacobian=jnp.asarray(jac), isotropic=jnp.asarray(iso),
        reduction=jnp.asarray(red),
        n_wl=NWL, spectral=spectral,
    )


# ---------------------------------------------------------------------------
# parameterization helpers (measured.cpp:232-260)
# ---------------------------------------------------------------------------

def _elevation(d):
    """Numerically-stable elevation angle (measured.cpp:237-241)."""
    dz = jnp.stack([d[..., 0], d[..., 1], d[..., 2] - 1.0], axis=-1)
    return 2.0 * jnp.arcsin(jnp.clip(0.5 * fr.norm(dz), 0.0, 1.0))


def _theta2u(theta):
    return jnp.sqrt(jnp.clip(theta * (2.0 / jnp.pi), 0.0, 1.0))


def _u2theta(u):
    return u * u * (jnp.pi / 2.0)


def _phi2u(phi):
    return 0.5 * (phi / jnp.pi + 1.0)


def _u2phi(u):
    return (2.0 * u - 1.0) * jnp.pi


def _slice_weights(meas: MeasuredTables, k, theta_i, phi_i):
    """4 neighbor slice indices + bilinear weights over the incident grid.
    Returns (sl [N, 4] flat slice indices, w [N, 4])."""
    K, NTI = meas.theta_i.shape
    NPI = meas.phi_i.shape[1]
    tg = meas.theta_i[k]                                 # [N, NTI]
    nt = meas.n_theta_i[k]
    ti = jnp.clip(
        jnp.sum((tg <= theta_i[..., None]).astype(jnp.int32), axis=-1) - 1,
        0, jnp.maximum(nt - 2, 0),
    )
    t0 = jnp.take_along_axis(tg, ti[..., None], -1)[..., 0]
    t1 = jnp.take_along_axis(tg, (ti + 1)[..., None], -1)[..., 0]
    wt = jnp.clip((theta_i - t0) / jnp.maximum(t1 - t0, 1e-9), 0.0, 1.0)

    pg = meas.phi_i[k]
    npi = meas.n_phi_i[k]
    pi0 = jnp.clip(
        jnp.sum((pg <= phi_i[..., None]).astype(jnp.int32), axis=-1) - 1,
        0, jnp.maximum(npi - 2, 0),
    )
    p0 = jnp.take_along_axis(pg, pi0[..., None], -1)[..., 0]
    p1 = jnp.take_along_axis(
        pg, jnp.minimum(pi0 + 1, npi - 1)[..., None], -1
    )[..., 0]
    wp = jnp.where(
        npi >= 2,
        jnp.clip((phi_i - p0) / jnp.maximum(p1 - p0, 1e-9), 0.0, 1.0),
        0.0,
    )
    pi1 = jnp.minimum(pi0 + 1, jnp.maximum(npi - 1, 0))

    base = k * NPI
    sl = jnp.stack(
        [
            (base + pi0) * NTI + ti,
            (base + pi0) * NTI + ti + 1,
            (base + pi1) * NTI + ti,
            (base + pi1) * NTI + ti + 1,
        ],
        axis=-1,
    )
    w = jnp.stack(
        [
            (1 - wp) * (1 - wt), (1 - wp) * wt,
            wp * (1 - wt), wp * wt,
        ],
        axis=-1,
    )
    return sl, w


def _spectra_eval(meas: MeasuredTables, sl, w, x, y, wavelengths, cfg):
    """Mixture-weighted spectra lookup at warped position (x, y) -> [N, C]."""
    NWL = meas.n_wl
    n = x.shape[0]
    C = cfg.n_channels
    if not meas.spectral or wavelengths is None:
        # RGB storage: channel c at spectra row sl*NWL + c
        out = []
        for c in range(min(3, NWL)):
            acc = jnp.zeros((n,), jnp.float32)
            for s in range(4):
                acc = acc + w[..., s] * grid_eval(
                    sl[..., s] * NWL + c, x, y, meas.spectra
                )
            out.append(acc)
        rgb = jnp.stack(out, axis=-1)
        if C == 3:
            return rgb
        return jnp.broadcast_to(
            jnp.mean(rgb, axis=-1, keepdims=True), (n, C)
        )
    # spectral storage: linear interp over the wavelength grid
    k0 = jnp.zeros((n,), jnp.int32)  # wavelength grids are per-material but
    # identical across lanes of one material; use searchsorted per channel
    wl_grid = meas.wavelengths[0]  # [NWL] (single-material spectral case)
    out = jnp.zeros((n, C), jnp.float32)
    for c in range(C):
        lam = wavelengths[..., c]
        wi_ = jnp.clip(
            jnp.sum((wl_grid <= lam[..., None]).astype(jnp.int32), axis=-1) - 1,
            0, NWL - 2,
        )
        l0 = wl_grid[wi_]
        l1 = wl_grid[wi_ + 1]
        tw = jnp.clip((lam - l0) / jnp.maximum(l1 - l0, 1e-9), 0.0, 1.0)
        acc = jnp.zeros((n,), jnp.float32)
        for s in range(4):
            v0 = grid_eval(sl[..., s] * NWL + wi_, x, y, meas.spectra)
            v1 = grid_eval(sl[..., s] * NWL + wi_ + 1, x, y, meas.spectra)
            acc = acc + w[..., s] * (v0 * (1 - tw) + v1 * tw)
        out = out.at[..., c].set(acc)
    return out
