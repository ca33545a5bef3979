"""Device-side ray intersection: Möller–Trumbore triangles + stackless
skip-link BVH traversal (lax.while_loop), plus a brute-force oracle.

Plain JAX, compiled by XLA for every backend; Scene.intersect_route picks
the chunked brute force or the BVH walk per scene.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import math as m
from .bvh import BVH, LEAF_SIZE

INF = jnp.float32(jnp.inf)


def ray_triangle(o, d, p0, p1, p2, t_max):
    """Möller–Trumbore. All inputs broadcastable [..., 3]; returns
    (hit, t, u, v). Watertight enough for rendering; epsilon-guarded."""
    e1 = p1 - p0
    e2 = p2 - p0
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1.0), 0.0)
    tvec = o - p0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = (
        (jnp.abs(det) > 1e-12)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > 0.0)
        & (t < t_max)
    )
    return hit, t, u, v


def ray_aabb(o, inv_d, lo, hi, t_max):
    """Slab test; returns bool hit for t in (0, t_max)."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tmin = jnp.minimum(t0, t1)
    tmax = jnp.maximum(t0, t1)
    t_near = jnp.max(tmin, axis=-1)
    t_far = jnp.min(tmax, axis=-1)
    return (t_near <= t_far) & (t_far > 0.0) & (t_near < t_max)


def bvh_intersect(bvh: BVH, tri_p0, tri_p1, tri_p2, o, d, t_max):
    """Closest-hit traversal for a wavefront of rays.

    Returns (t [N], prim [N] (-1 miss), u [N], v [N]).
    """
    n = o.shape[0]
    inv_d = 1.0 / jnp.where(jnp.abs(d) > 1e-12, d, jnp.where(d >= 0, 1e-12, -1e-12))

    def cond(state):
        node, _, _, _, _ = state
        return jnp.any(node >= 0)

    def body(state):
        node, t_best, prim_best, u_best, v_best = state
        node_c = jnp.maximum(node, 0)
        lo = bvh.node_lo[node_c]
        hi = bvh.node_hi[node_c]
        cnt = bvh.node_count[node_c]
        first = bvh.node_first[node_c]
        alive = node >= 0

        box_hit = ray_aabb(o, inv_d, lo, hi, t_best) & alive
        is_leaf = (cnt > 0) & box_hit

        # --- leaf: test LEAF_SIZE padded prims -----------------------------
        slot = first[:, None] + jnp.arange(LEAF_SIZE, dtype=jnp.int32)[None, :]
        pidx = bvh.prim_idx[slot]                       # [N, L]
        pidx_c = jnp.maximum(pidx, 0)
        p0 = tri_p0[pidx_c]                             # [N, L, 3]
        p1 = tri_p1[pidx_c]
        p2 = tri_p2[pidx_c]
        hit, t, u, v = ray_triangle(
            o[:, None, :], d[:, None, :], p0, p1, p2, t_best[:, None]
        )
        hit = hit & (pidx >= 0) & is_leaf[:, None]
        t = jnp.where(hit, t, INF)
        best = jnp.argmin(t, axis=-1)
        t_leaf = jnp.take_along_axis(t, best[:, None], -1)[:, 0]
        any_hit = jnp.take_along_axis(hit, best[:, None], -1)[:, 0]
        upd = any_hit & (t_leaf < t_best)
        t_best = jnp.where(upd, t_leaf, t_best)
        prim_best = jnp.where(
            upd, jnp.take_along_axis(pidx, best[:, None], -1)[:, 0], prim_best
        )
        u_best = jnp.where(upd, jnp.take_along_axis(u, best[:, None], -1)[:, 0], u_best)
        v_best = jnp.where(upd, jnp.take_along_axis(v, best[:, None], -1)[:, 0], v_best)

        # --- next node ------------------------------------------------------
        hit_inner = box_hit & (cnt == 0)
        next_node = jnp.where(
            hit_inner,
            first,                      # descend to first child
            bvh.node_miss[node_c],      # skip (also the post-leaf path)
        )
        node = jnp.where(alive, next_node, node)
        return node, t_best, prim_best, u_best, v_best

    node0 = jnp.zeros((n,), jnp.int32)
    state = (
        node0,
        jnp.asarray(t_max, jnp.float32) * jnp.ones((n,), jnp.float32),
        jnp.full((n,), -1, jnp.int32),
        jnp.zeros((n,), jnp.float32),
        jnp.zeros((n,), jnp.float32),
    )
    _, t_best, prim_best, u_best, v_best = jax.lax.while_loop(cond, body, state)
    return t_best, prim_best, u_best, v_best


def bvh_occluded(bvh: BVH, tri_p0, tri_p1, tri_p2, o, d, t_max):
    """Any-hit traversal (shadow rays): early-out per lane once occluded."""
    n = o.shape[0]
    inv_d = 1.0 / jnp.where(jnp.abs(d) > 1e-12, d, jnp.where(d >= 0, 1e-12, -1e-12))

    def cond(state):
        node, occluded = state
        return jnp.any((node >= 0) & ~occluded)

    def body(state):
        node, occluded = state
        node_c = jnp.maximum(node, 0)
        lo = bvh.node_lo[node_c]
        hi = bvh.node_hi[node_c]
        cnt = bvh.node_count[node_c]
        first = bvh.node_first[node_c]
        alive = (node >= 0) & ~occluded

        box_hit = ray_aabb(o, inv_d, lo, hi, t_max) & alive
        is_leaf = (cnt > 0) & box_hit

        slot = first[:, None] + jnp.arange(LEAF_SIZE, dtype=jnp.int32)[None, :]
        pidx = bvh.prim_idx[slot]
        pidx_c = jnp.maximum(pidx, 0)
        hit, _, _, _ = ray_triangle(
            o[:, None, :],
            d[:, None, :],
            tri_p0[pidx_c],
            tri_p1[pidx_c],
            tri_p2[pidx_c],
            t_max[:, None],
        )
        hit_any = jnp.any(hit & (pidx >= 0) & is_leaf[:, None], axis=-1)
        occluded = occluded | hit_any

        hit_inner = box_hit & (cnt == 0)
        next_node = jnp.where(hit_inner, first, bvh.node_miss[node_c])
        node = jnp.where(alive, next_node, node)
        return node, occluded

    state = (jnp.zeros((n,), jnp.int32), jnp.zeros((n,), bool))
    _, occluded = jax.lax.while_loop(cond, body, state)
    return occluded


def chunked_intersect(tri_packed, o, d, t_max, chunk: int = 64):
    """Closest-hit by brute force over contiguous triangle chunks.

    tri_packed: [T_pad, 9] rows (p0, e1, e2), T_pad a multiple of `chunk`,
    padding rows degenerate (e1 = e2 = 0 -> det 0 -> never hit).

    `lax.scan` feeds each chunk as a sliced `xs` argument: contiguous
    dynamic slices and no gathers in the loop body, which is pure
    elementwise math. It is the small-scene path of Scene.ray_intersect.
    """
    n = o.shape[0]
    t_pad = tri_packed.shape[0]
    n_chunk = t_pad // chunk
    xs = tri_packed.reshape(n_chunk, chunk, 9)
    base = jnp.arange(n_chunk, dtype=jnp.int32) * chunk

    def body(carry, xs_i):
        tris, s = xs_i
        t_best, prim_best, u_best, v_best = carry
        p0 = tris[:, 0:3][None]
        e1 = tris[:, 3:6][None]
        e2 = tris[:, 6:9][None]
        # Moller-Trumbore with precomputed edges
        pvec = jnp.cross(d[:, None, :], e2)
        det = jnp.sum(e1 * pvec, axis=-1)
        ok_det = jnp.abs(det) > 1e-12
        inv_det = jnp.where(ok_det, 1.0 / jnp.where(ok_det, det, 1.0), 0.0)
        tvec = o[:, None, :] - p0
        u = jnp.sum(tvec * pvec, axis=-1) * inv_det
        qvec = jnp.cross(tvec, e1)
        v = jnp.sum(d[:, None, :] * qvec, axis=-1) * inv_det
        t = jnp.sum(e2 * qvec, axis=-1) * inv_det
        hit = ok_det & (u >= 0) & (v >= 0) & (u + v <= 1.0) & (t > 0) & (
            t < t_best[:, None]
        )
        t = jnp.where(hit, t, INF)
        best = jnp.argmin(t, axis=-1)
        tb = jnp.take_along_axis(t, best[:, None], -1)[:, 0]
        hb = jnp.take_along_axis(hit, best[:, None], -1)[:, 0]
        upd = hb & (tb < t_best)
        t_best = jnp.where(upd, tb, t_best)
        prim_best = jnp.where(upd, s + best.astype(jnp.int32), prim_best)
        u_best = jnp.where(
            upd, jnp.take_along_axis(u, best[:, None], -1)[:, 0], u_best
        )
        v_best = jnp.where(
            upd, jnp.take_along_axis(v, best[:, None], -1)[:, 0], v_best
        )
        return (t_best, prim_best, u_best, v_best), None

    init = (
        jnp.asarray(t_max, jnp.float32) * jnp.ones((n,), jnp.float32),
        jnp.full((n,), -1, jnp.int32),
        jnp.zeros((n,), jnp.float32),
        jnp.zeros((n,), jnp.float32),
    )
    if n_chunk == 1:
        (t_best, prim_best, u_best, v_best), _ = body(init, (xs[0], base[0]))
    else:
        (t_best, prim_best, u_best, v_best), _ = jax.lax.scan(
            body, init, (xs, base)
        )
    return t_best, prim_best, u_best, v_best


def chunked_occluded(tri_packed, o, d, t_max, chunk: int = 64):
    """Any-hit by brute force over contiguous chunks (see chunked_intersect)."""
    n = o.shape[0]
    t_pad = tri_packed.shape[0]
    n_chunk = t_pad // chunk
    xs = tri_packed.reshape(n_chunk, chunk, 9)

    def body(occ, tris):
        p0 = tris[:, 0:3][None]
        e1 = tris[:, 3:6][None]
        e2 = tris[:, 6:9][None]
        pvec = jnp.cross(d[:, None, :], e2)
        det = jnp.sum(e1 * pvec, axis=-1)
        ok_det = jnp.abs(det) > 1e-12
        inv_det = jnp.where(ok_det, 1.0 / jnp.where(ok_det, det, 1.0), 0.0)
        tvec = o[:, None, :] - p0
        u = jnp.sum(tvec * pvec, axis=-1) * inv_det
        qvec = jnp.cross(tvec, e1)
        v = jnp.sum(d[:, None, :] * qvec, axis=-1) * inv_det
        t = jnp.sum(e2 * qvec, axis=-1) * inv_det
        hit = ok_det & (u >= 0) & (v >= 0) & (u + v <= 1.0) & (t > 0) & (
            t < t_max[:, None]
        )
        return occ | jnp.any(hit, axis=-1), None

    occ0 = jnp.zeros((n,), bool)
    if n_chunk == 1:
        occ, _ = body(occ0, xs[0])
    else:
        occ, _ = jax.lax.scan(body, occ0, xs)
    return occ


def brute_force_intersect(tri_p0, tri_p1, tri_p2, o, d, t_max, chunk=512):
    """Oracle: test all triangles (scan over chunks). For tests/tiny scenes."""
    n = o.shape[0]
    f = tri_p0.shape[0]
    pad = (-f) % chunk
    p0 = jnp.concatenate([tri_p0, jnp.zeros((pad, 3), tri_p0.dtype)])
    p1 = jnp.concatenate([tri_p1, jnp.zeros((pad, 3), tri_p0.dtype)])
    p2 = jnp.concatenate([tri_p2, jnp.zeros((pad, 3), tri_p0.dtype)])
    nchunk = (f + pad) // chunk
    valid_tri = jnp.arange(f + pad) < f

    def body(carry, ci):
        t_best, prim_best, u_best, v_best = carry
        s = ci * chunk
        idx = s + jnp.arange(chunk)
        hit, t, u, v = ray_triangle(
            o[:, None, :],
            d[:, None, :],
            p0[idx][None],
            p1[idx][None],
            p2[idx][None],
            t_best[:, None],
        )
        hit = hit & valid_tri[idx][None]
        t = jnp.where(hit, t, INF)
        best = jnp.argmin(t, axis=-1)
        tb = jnp.take_along_axis(t, best[:, None], -1)[:, 0]
        hb = jnp.take_along_axis(hit, best[:, None], -1)[:, 0]
        upd = hb & (tb < t_best)
        t_best = jnp.where(upd, tb, t_best)
        prim_best = jnp.where(upd, (s + best).astype(jnp.int32), prim_best)
        u_best = jnp.where(upd, jnp.take_along_axis(u, best[:, None], -1)[:, 0], u_best)
        v_best = jnp.where(upd, jnp.take_along_axis(v, best[:, None], -1)[:, 0], v_best)
        return (t_best, prim_best, u_best, v_best), None

    init = (
        jnp.asarray(t_max, jnp.float32) * jnp.ones((n,), jnp.float32),
        jnp.full((n,), -1, jnp.int32),
        jnp.zeros((n,), jnp.float32),
        jnp.zeros((n,), jnp.float32),
    )
    (t_best, prim_best, u_best, v_best), _ = jax.lax.scan(
        body, init, jnp.arange(nchunk)
    )
    return t_best, prim_best, u_best, v_best
