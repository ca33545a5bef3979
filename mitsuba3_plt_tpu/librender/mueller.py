"""Mueller/Stokes calculus, batched as [..., 4, 4] / [..., 4] arrays.

Frame conventions follow the reference exactly (independent implementation):
stokes_basis(forward) = coordinate_system(forward).first; rotations follow
"Polarized Light" (Collett); specular reflection/transmission use the Verdet
a_p sign convention. See /root/reference/include/mitsuba/render/mueller.h.

When a spectral channel axis is present it trails: Mueller [..., 4, 4, C].
All constructors here produce [..., 4, 4]; use `expand` to add the channel
axis, or multiply by a [..., C] spectrum after `apply`.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core import math as m
from ..core.frame import coordinate_system, dot, cross, normalize
from . import fresnel as fr


def _mm(rows, batch_shape, dtype=jnp.float32):
    """Build [..., 4, 4] from 16 broadcastable entries (row-major)."""
    flat = [jnp.broadcast_to(jnp.asarray(e, dtype), batch_shape) for e in rows]
    out = jnp.stack(flat, axis=-1)
    return out.reshape(*batch_shape, 4, 4)


def identity(batch_shape=()):
    return jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (*batch_shape, 4, 4))


def depolarizer(value):
    value = jnp.asarray(value, jnp.float32)
    out = jnp.zeros((*value.shape, 4, 4), jnp.float32)
    return out.at[..., 0, 0].set(value)


def absorber(value):
    value = jnp.asarray(value, jnp.float32)
    return identity(value.shape) * value[..., None, None]


def linear_polarizer(value=1.0):
    value = jnp.asarray(value, jnp.float32)
    a = value * 0.5
    z = jnp.zeros_like(a)
    return _mm([a, a, z, z,
                a, a, z, z,
                z, z, z, z,
                z, z, z, z], a.shape)


def linear_retarder(phase):
    phase = jnp.asarray(phase, jnp.float32)
    s, c = jnp.sin(phase), jnp.cos(phase)
    o, z = jnp.ones_like(s), jnp.zeros_like(s)
    return _mm([o, z, z, z,
                z, o, z, z,
                z, z, c, s,
                z, z, -s, c], s.shape)


def right_circular_polarizer(batch_shape=()):
    M = jnp.array(
        [[1, 0, 0, 1], [0, 0, 0, 0], [0, 0, 0, 0], [1, 0, 0, 1]], jnp.float32
    ) * 0.5
    return jnp.broadcast_to(M, (*batch_shape, 4, 4))


def left_circular_polarizer(batch_shape=()):
    M = jnp.array(
        [[1, 0, 0, -1], [0, 0, 0, 0], [0, 0, 0, 0], [-1, 0, 0, 1]], jnp.float32
    ) * 0.5
    return jnp.broadcast_to(M, (*batch_shape, 4, 4))


def diattenuator(x, y):
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    a = 0.5 * (x + y)
    b = 0.5 * (x - y)
    c = m.safe_sqrt(x * y)
    z = jnp.zeros_like(a)
    return _mm([a, b, z, z,
                b, a, z, z,
                z, z, c, z,
                z, z, z, c], a.shape)


def rotator(theta):
    """Counter-clockwise rotation of the Stokes reference frame by theta."""
    theta = jnp.asarray(theta, jnp.float32)
    s, c = jnp.sin(2.0 * theta), jnp.cos(2.0 * theta)
    o, z = jnp.ones_like(s), jnp.zeros_like(s)
    return _mm([o, z, z, z,
                z, c, s, z,
                z, -s, c, z,
                z, z, z, o], s.shape)


def rotated_element(theta, M):
    R = rotator(theta)
    Rt = jnp.swapaxes(R, -1, -2)
    return m.matmul_hi(m.matmul_hi(Rt, M), R)


def specular_reflection_dielectric(cos_theta_i, eta):
    a_s, a_p, _, _, _ = fr.fresnel_polarized_dielectric(cos_theta_i, eta)
    return _reflection_mueller(a_s, a_p)


def specular_reflection_conductor(cos_theta_i, eta_re, eta_im):
    a_s, a_p, _, _, _ = fr.fresnel_polarized_conductor(cos_theta_i, eta_re, eta_im)
    return _reflection_mueller(a_s, a_p)


def _reflection_mueller(a_s, a_p):
    sin_delta, cos_delta = fr.sincos_arg_diff(a_p, a_s)
    r_s = fr.c_abs2(a_s)
    r_p = fr.c_abs2(a_p)
    a = 0.5 * (r_s + r_p)
    b = 0.5 * (r_s - r_p)
    c = m.safe_sqrt(r_s * r_p)
    zero_c = c == 0.0
    sin_delta = jnp.where(zero_c, 0.0, sin_delta)
    cos_delta = jnp.where(zero_c, 0.0, cos_delta)
    z = jnp.zeros_like(a)
    return _mm([a, b, z, z,
                b, a, z, z,
                z, z, c * cos_delta, -c * sin_delta,
                z, z, c * sin_delta, c * cos_delta], a.shape)


def specular_transmission(cos_theta_i, eta):
    a_s, a_p, cos_theta_t, eta_it, eta_ti = fr.fresnel_polarized_dielectric(
        cos_theta_i, eta
    )
    factor = -eta_it * jnp.where(
        jnp.abs(cos_theta_i) > 1e-8,
        cos_theta_t / jnp.where(jnp.abs(cos_theta_i) > 1e-8, cos_theta_i, 1.0),
        0.0,
    )
    a_s_r = 1.0 + a_s[0]
    a_p_r = (1.0 + a_p[0]) * eta_ti
    t_s = a_s_r * a_s_r
    t_p = a_p_r * a_p_r
    a = 0.5 * factor * (t_s + t_p)
    b = 0.5 * factor * (t_s - t_p)
    c = factor * m.safe_sqrt(t_s * t_p)
    z = jnp.zeros_like(a)
    return _mm([a, b, z, z,
                b, a, z, z,
                z, z, c, z,
                z, z, z, c], a.shape)


# --- Stokes reference frames --------------------------------------------------

def stokes_basis(forward):
    """Implicit Stokes basis for a propagation direction (first basis vector
    of coordinate_system — must match the reference convention)."""
    return coordinate_system(forward)[0]


def rotate_stokes_basis(forward, basis_current, basis_target):
    theta = m.unit_angle(normalize(basis_current), normalize(basis_target))
    flip = dot(forward, cross(basis_current, basis_target)) < 0
    theta = jnp.where(flip, -theta, theta)
    return rotator(theta)


def rotate_mueller_basis(
    M, in_forward, in_basis_current, in_basis_target,
    out_forward, out_basis_current, out_basis_target,
):
    R_in = rotate_stokes_basis(in_forward, in_basis_current, in_basis_target)
    R_out = rotate_stokes_basis(out_forward, out_basis_current, out_basis_target)
    return m.matmul_hi(m.matmul_hi(R_out, M), jnp.swapaxes(R_in, -1, -2))


def rotate_mueller_basis_collinear(M, forward, basis_current, basis_target):
    R = rotate_stokes_basis(forward, basis_current, basis_target)
    return m.matmul_hi(m.matmul_hi(R, M), jnp.swapaxes(R, -1, -2))


# --- planar Mueller representation --------------------------------------------
#
# The hot polarized transport keeps Mueller values as 16 SEPARATE row-major
# planes (each [N, C] or a broadcastable smaller array) instead of a stacked
# [N, 4, 4, C] tensor: every jnp.stack lowers to an XLA concatenate, which
# materializes a full-wavefront buffer, while the planar form fuses into the
# surrounding elementwise cluster. `None` marks a STRUCTURALLY ZERO plane, giving
# trace-time sparsity: a depolarizer is one live plane, a Fresnel
# reflection eight — products prune automatically.

import dataclasses as _dc
from typing import Any as _Any, Tuple as _Tuple

import jax as _jax


@_jax.tree_util.register_dataclass
@_dc.dataclass(frozen=True)
class MuellerP:
    """Planar Mueller value: m[i*4+j] is row i, column j ([N, C] /
    broadcastable / None for a structural zero)."""

    m: _Tuple[_Any, ...]

    @staticmethod
    def zero():
        return MuellerP(m=(None,) * 16)

    @staticmethod
    def identity():
        one = jnp.float32(1.0)
        return MuellerP(m=tuple(
            one if i == j else None for i in range(4) for j in range(4)
        ))

    @staticmethod
    def depolarizer(value):
        return MuellerP(m=(value,) + (None,) * 15)

    @staticmethod
    def absorber(value):
        return MuellerP(m=tuple(
            value if i == j else None for i in range(4) for j in range(4)
        ))

    @staticmethod
    def from_stack(M):
        """Stacked [..., 4, 4, C] (or [..., 4, 4]) -> planes [..., C]."""
        if M.shape[-1] == 4 and M.shape[-2] == 4:
            return MuellerP(m=tuple(
                M[..., i, j, None] for i in range(4) for j in range(4)
            ))
        return MuellerP(m=tuple(
            M[..., i, j, :] for i in range(4) for j in range(4)
        ))

    def stack(self, n, C):
        """Materialize [n, 4, 4, C]."""
        planes = [
            jnp.broadcast_to(
                jnp.zeros((), jnp.float32) if p is None else p, (n, C)
            )
            for p in self.m
        ]
        return jnp.stack(
            [jnp.stack(planes[i * 4:(i + 1) * 4], axis=1) for i in range(4)],
            axis=1,
        )

    def m00(self):
        p = self.m[0]
        return jnp.zeros((), jnp.float32) if p is None else p

    def materialize(self, n, C):
        """Concrete [n, C] planes (for lax.scan carries, which need a fixed
        pytree structure and fixed shapes)."""
        return MuellerP(m=tuple(
            jnp.broadcast_to(
                jnp.zeros((), jnp.float32) if p is None else p, (n, C)
            )
            for p in self.m
        ))


def _p_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a + b


def _p_mul(a, b):
    if a is None or b is None:
        return None
    return a * b


def p_matmul(A: MuellerP, B: MuellerP) -> MuellerP:
    """Planar A @ B with structural-zero pruning."""
    out = []
    for i in range(4):
        for j in range(4):
            acc = None
            for k in range(4):
                acc = _p_add(acc, _p_mul(A.m[i * 4 + k], B.m[k * 4 + j]))
            out.append(acc)
    return MuellerP(m=tuple(out))


def p_apply(A: MuellerP, s):
    """Planar A @ s for a Stokes 4-tuple of planes ([N, C] / None each)."""
    out = []
    for i in range(4):
        acc = None
        for j in range(4):
            acc = _p_add(acc, _p_mul(A.m[i * 4 + j], s[j]))
        out.append(acc)
    return tuple(out)


def p_scale(A: MuellerP, s) -> MuellerP:
    """Multiply every plane by an unpolarized factor ([N, C] / scalar)."""
    return MuellerP(m=tuple(None if p is None else p * s for p in A.m))


def p_where(mask, A: MuellerP, B: MuellerP) -> MuellerP:
    """Lane-select between two planar values (mask [N])."""
    mask_c = mask[..., None]
    out = []
    for a, b in zip(A.m, B.m):
        if a is None and b is None:
            out.append(None)
        else:
            out.append(jnp.where(
                mask_c,
                jnp.zeros((), jnp.float32) if a is None else a,
                jnp.zeros((), jnp.float32) if b is None else b,
            ))
    return MuellerP(m=tuple(out))


def p_padd(A: MuellerP, B: MuellerP) -> MuellerP:
    return MuellerP(m=tuple(_p_add(a, b) for a, b in zip(A.m, B.m)))


def p_rotator(theta) -> MuellerP:
    """Planar rotator (see rotator()); planes are [N]-shaped (no channel
    axis) and broadcast against [N, C] planes via a trailing unit axis."""
    s = jnp.sin(2.0 * theta)[..., None]
    c = jnp.cos(2.0 * theta)[..., None]
    one = jnp.float32(1.0)
    return MuellerP(m=(
        one, None, None, None,
        None, c, s, None,
        None, -s, c, None,
        None, None, None, one,
    ))


def p_rotate_stokes_basis(forward, basis_current, basis_target) -> MuellerP:
    theta = m.unit_angle(normalize(basis_current), normalize(basis_target))
    flip = dot(forward, cross(basis_current, basis_target)) < 0
    return p_rotator(jnp.where(flip, -theta, theta))


def p_transpose(A: MuellerP) -> MuellerP:
    return MuellerP(m=tuple(
        A.m[j * 4 + i] for i in range(4) for j in range(4)
    ))


def p_reflection(a_s, a_p) -> MuellerP:
    """Planar _reflection_mueller: planes [N, C] from complex amplitudes."""
    sin_delta, cos_delta = fr.sincos_arg_diff(a_p, a_s)
    r_s = fr.c_abs2(a_s)
    r_p = fr.c_abs2(a_p)
    a = 0.5 * (r_s + r_p)
    b = 0.5 * (r_s - r_p)
    c = m.safe_sqrt(r_s * r_p)
    zero_c = c == 0.0
    sin_delta = jnp.where(zero_c, 0.0, sin_delta)
    cos_delta = jnp.where(zero_c, 0.0, cos_delta)
    return MuellerP(m=(
        a, b, None, None,
        b, a, None, None,
        None, None, c * cos_delta, -c * sin_delta,
        None, None, c * sin_delta, c * cos_delta,
    ))


def p_specular_reflection_conductor(cos_theta_i, eta_re, eta_im) -> MuellerP:
    a_s, a_p, _, _, _ = fr.fresnel_polarized_conductor(
        cos_theta_i, eta_re, eta_im
    )
    return p_reflection(a_s, a_p)


def p_specular_reflection_dielectric(cos_theta_i, eta) -> MuellerP:
    a_s, a_p, _, _, _ = fr.fresnel_polarized_dielectric(cos_theta_i, eta)
    return p_reflection(a_s, a_p)


def p_specular_transmission(cos_theta_i, eta) -> MuellerP:
    a_s, a_p, cos_theta_t, eta_it, eta_ti = fr.fresnel_polarized_dielectric(
        cos_theta_i, eta
    )
    factor = -eta_it * jnp.where(
        jnp.abs(cos_theta_i) > 1e-8,
        cos_theta_t / jnp.where(jnp.abs(cos_theta_i) > 1e-8, cos_theta_i, 1.0),
        0.0,
    )
    a_s_r = 1.0 + a_s[0]
    a_p_r = (1.0 + a_p[0]) * eta_ti
    t_s = a_s_r * a_s_r
    t_p = a_p_r * a_p_r
    a = 0.5 * factor * (t_s + t_p)
    b = 0.5 * factor * (t_s - t_p)
    c = factor * m.safe_sqrt(t_s * t_p)
    return MuellerP(m=(
        a, b, None, None,
        b, a, None, None,
        None, None, c, None,
        None, None, None, c,
    ))


# --- helpers for spectrally-valued Mueller stacks ------------------------------

def expand(M, n_channels):
    """[..., 4, 4] -> [..., 4, 4, C] by broadcast."""
    return jnp.broadcast_to(M[..., None], (*M.shape, n_channels))


def matmul_spectral(A, B):
    """Multiply two [..., 4, 4, C] Mueller stacks channel-wise.

    Unrolled into [..., C] vector FMAs: the einsum's dot_general lowering
    batches over (..., c) with 4x4 contractions and forces layout
    transposes in/out of the render scan."""
    rows = []
    for i in range(4):
        cols = []
        for j in range(4):
            acc = A[..., i, 0, :] * B[..., 0, j, :]
            for k in range(1, 4):
                acc = acc + A[..., i, k, :] * B[..., k, j, :]
            cols.append(acc)
        rows.append(jnp.stack(cols, axis=-2))
    return jnp.stack(rows, axis=-3)


def apply_stokes(M, s):
    """[..., 4, 4, C] x [..., 4, C] -> [..., 4, C] (unrolled, see
    matmul_spectral)."""
    rows = []
    for i in range(4):
        acc = M[..., i, 0, :] * s[..., 0, :]
        for j in range(1, 4):
            acc = acc + M[..., i, j, :] * s[..., j, :]
        rows.append(acc)
    return jnp.stack(rows, axis=-2)
