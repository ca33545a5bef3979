"""SDF-grid shape (reference src/shapes/sdfgrid.cpp): a signed-distance
grid spanning the unit cube in local space, transformed by to_world.

Intersection: fixed-trip-count sphere tracing (lax.fori_loop,
no data-dependent bounds under jit) followed by bisection refinement —
the reference's per-voxel trilinear root solve is replaced by a bounded
march with the same trilinear field, which XLA compiles to one fused
loop. Normals are the analytic trilinear gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..core import frame as fr

MARCH_STEPS = 96
BISECT_STEPS = 10


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SDFGrid:
    """One SDF grid instance. grid [Dz, Dy, Dx] signed distances in LOCAL
    units over the unit cube; to_world/inv as 4x4."""

    grid: Any
    to_world: Any     # [4, 4]
    to_local: Any     # [4, 4]
    attr: Any         # [3] (mat, emitter, shape) f32

    @staticmethod
    def create(grid, to_world=None, mat=0, shape_id=40000):
        tw = np.eye(4, np.float32) if to_world is None else np.asarray(
            to_world, np.float32
        )
        return SDFGrid(
            grid=jnp.asarray(grid, jnp.float32),
            to_world=jnp.asarray(tw),
            to_local=jnp.asarray(np.linalg.inv(tw).astype(np.float32)),
            attr=jnp.asarray([mat, -1, shape_id], jnp.float32),
        )


def _trilinear(grid, p):
    """Trilinear SDF lookup at local p in [0,1]^3 (clamped); [N]."""
    dz, dy, dx = grid.shape
    x = jnp.clip(p[..., 0], 0.0, 1.0) * (dx - 1)
    y = jnp.clip(p[..., 1], 0.0, 1.0) * (dy - 1)
    z = jnp.clip(p[..., 2], 0.0, 1.0) * (dz - 1)
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, dx - 2)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, dy - 2)
    z0 = jnp.clip(jnp.floor(z).astype(jnp.int32), 0, dz - 2)
    fx = x - x0
    fy = y - y0
    fz = z - z0
    flat = grid.reshape(-1)

    def at(zi, yi, xi):
        return flat[(zi * dy + yi) * dx + xi]

    c000 = at(z0, y0, x0)
    c001 = at(z0, y0, x0 + 1)
    c010 = at(z0, y0 + 1, x0)
    c011 = at(z0, y0 + 1, x0 + 1)
    c100 = at(z0 + 1, y0, x0)
    c101 = at(z0 + 1, y0, x0 + 1)
    c110 = at(z0 + 1, y0 + 1, x0)
    c111 = at(z0 + 1, y0 + 1, x0 + 1)
    c00 = c000 * (1 - fx) + c001 * fx
    c01 = c010 * (1 - fx) + c011 * fx
    c10 = c100 * (1 - fx) + c101 * fx
    c11 = c110 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def _gradient(grid, p, eps=1e-3):
    gx = _trilinear(grid, p + jnp.asarray([eps, 0, 0])) - _trilinear(
        grid, p - jnp.asarray([eps, 0, 0])
    )
    gy = _trilinear(grid, p + jnp.asarray([0, eps, 0])) - _trilinear(
        grid, p - jnp.asarray([0, eps, 0])
    )
    gz = _trilinear(grid, p + jnp.asarray([0, 0, eps])) - _trilinear(
        grid, p - jnp.asarray([0, 0, eps])
    )
    return jnp.stack([gx, gy, gz], axis=-1)


def sdf_intersect(sdf: SDFGrid, o, d, maxt):
    """Sphere-trace the grid. Returns (t [N] world-parameter, hit [N] bool,
    n_world [N, 3], uv [N, 2])."""
    R = sdf.to_local[:3, :3]
    o_l = o @ R.T + sdf.to_local[:3, 3]
    d_l = d @ R.T                      # unnormalized: t matches world t
    d_norm = jnp.maximum(jnp.linalg.norm(d_l, axis=-1), 1e-12)

    # unit-cube slab test in local space
    inv_d = 1.0 / jnp.where(jnp.abs(d_l) > 1e-12, d_l, 1e-12)
    t_lo = (0.0 - o_l) * inv_d
    t_hi = (1.0 - o_l) * inv_d
    t_near = jnp.max(jnp.minimum(t_lo, t_hi), axis=-1)
    t_far = jnp.min(jnp.maximum(t_lo, t_hi), axis=-1)
    t_near = jnp.maximum(t_near, 1e-4)
    box_ok = (t_far > t_near) & (t_near < maxt)

    eps_hit = 5e-4

    def march(_, carry):
        t, done = carry
        p = o_l + t[..., None] * d_l
        f = _trilinear(sdf.grid, p)
        hit_now = f < eps_hit
        # conservative step: SDF value is in local units; d_l is
        # unnormalized so divide by |d_l|
        step = jnp.maximum(f, eps_hit * 0.5) / d_norm
        t_new = jnp.where(done | hit_now, t, t + step)
        return t_new, done | hit_now

    t0 = jnp.where(box_ok, t_near, jnp.inf)
    t, hit = jax.lax.fori_loop(
        0, MARCH_STEPS, march, (t0, jnp.zeros(o.shape[0], bool))
    )
    inside = (o_l >= 0).all(-1) & (o_l <= 1).all(-1)
    valid = hit & box_ok & (t < maxt) & (t >= t_near) & (t <= t_far + 1e-3)

    # bisection refinement between the last outside point and the hit
    def bisect(_, carry):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        f = _trilinear(sdf.grid, o_l + mid[..., None] * d_l)
        lo2 = jnp.where(f > 0, mid, lo)
        hi2 = jnp.where(f > 0, hi, mid)
        return lo2, hi2

    back = jnp.maximum(t - 2.0 * eps_hit / d_norm, t_near)
    lo, hi = jax.lax.fori_loop(0, BISECT_STEPS, bisect, (back, t))
    t_ref = jnp.where(valid, hi, jnp.inf)

    p_hit = o_l + t_ref[..., None] * d_l
    g = _gradient(sdf.grid, jnp.where(valid[..., None], p_hit, 0.5))
    # normals transform by the inverse-transpose of to_world's linear part
    n_world = fr.normalize(g @ sdf.to_local[:3, :3])
    uv = jnp.stack([p_hit[..., 0], p_hit[..., 1]], axis=-1)
    uv = jnp.clip(jnp.where(valid[..., None], uv, 0.0), 0.0, 1.0)
    return t_ref, valid, n_world, uv


def sphere_sdf_grid(res=32, radius=0.35, center=(0.5, 0.5, 0.5)):
    """Host helper: an analytic-sphere SDF sampled on a res^3 grid
    (tests + demos)."""
    ax = (np.arange(res) + 0.0) / (res - 1)
    Z, Y, X = np.meshgrid(ax, ax, ax, indexing="ij")
    c = np.asarray(center)
    d = np.sqrt((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2) - radius
    return d.astype(np.float32)
