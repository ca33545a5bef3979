"""Host-side BVH construction -> flat skip-link layout for stackless traversal.

Layout (DFS pre-order):
  node_lo/hi [NN, 3]  — AABB
  node_first [NN]     — inner: unused (hit child = node+1); leaf: offset into
                         the padded prim-index array (multiple of LEAF_SIZE)
  node_count [NN]     — 0 for inner nodes, #prims (<= LEAF_SIZE) for leaves
  node_miss  [NN]     — next node when the AABB test fails / after a leaf;
                         -1 terminates traversal

Skip links make the device loop a single `while node >= 0` with no stack —
the array-program replacement for the reference's stack-based kd-tree/
Embree/OptiX backends (src/render/scene_embree.inl, kdtree.h).

Leaves are padded to exactly LEAF_SIZE prim slots (padding = -1) so the
device inner loop is static. A C++ builder for multi-million-triangle scenes
lives in native/ (this numpy builder handles ~100k tris in seconds).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

LEAF_SIZE = 4
SAH_BINS = 16


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BVH:
    node_lo: Any     # [NN, 3] f32
    node_hi: Any     # [NN, 3] f32
    node_first: Any  # [NN] i32
    node_count: Any  # [NN] i32
    node_miss: Any   # [NN] i32
    prim_idx: Any    # [P] i32 padded triangle indices (-1 = empty slot)


def build_bvh(vertices: np.ndarray, faces: np.ndarray) -> BVH:
    f = np.asarray(faces)
    v = np.asarray(vertices)
    nf = len(f)
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]

    # native C++ SAH builder (native/bvh_builder.cpp) when available; the
    # numpy path below is the reference implementation / fallback
    from .native import build_bvh_native

    out = build_bvh_native(p0, p1, p2) if nf > 0 else None
    if out is not None:
        lo, hi, first, count, miss, prim = out
        return BVH(
            node_lo=jnp.asarray(lo), node_hi=jnp.asarray(hi),
            node_first=jnp.asarray(first), node_count=jnp.asarray(count),
            node_miss=jnp.asarray(miss), prim_idx=jnp.asarray(prim),
        )
    tri_lo = np.minimum(np.minimum(p0, p1), p2)
    tri_hi = np.maximum(np.maximum(p0, p1), p2)
    cent = (tri_lo + tri_hi) * 0.5

    # --- top-down binned-SAH build over index lists -------------------------
    nodes = []  # dicts: lo, hi, first/count or children placeholder

    def make_node(idx):
        lo = tri_lo[idx].min(0)
        hi = tri_hi[idx].max(0)
        node = {"lo": lo, "hi": hi, "left": -1, "right": -1, "prims": None}
        nodes.append(node)
        ni = len(nodes) - 1

        if len(idx) <= LEAF_SIZE:
            node["prims"] = idx
            return ni

        # binned SAH on the widest centroid axis
        c = cent[idx]
        cmin, cmax = c.min(0), c.max(0)
        ext = cmax - cmin
        axis = int(np.argmax(ext))
        if ext[axis] < 1e-12:
            # degenerate: split in half arbitrarily
            half = len(idx) // 2
            order = np.argsort(c[:, axis], kind="stable")
            l_idx, r_idx = idx[order[:half]], idx[order[half:]]
        else:
            rel = (c[:, axis] - cmin[axis]) / ext[axis]
            bins = np.minimum((rel * SAH_BINS).astype(np.int32), SAH_BINS - 1)
            counts = np.bincount(bins, minlength=SAH_BINS)
            # per-bin bounds
            bl = np.full((SAH_BINS, 3), np.inf)
            bh = np.full((SAH_BINS, 3), -np.inf)
            np.minimum.at(bl, bins, tri_lo[idx])
            np.maximum.at(bh, bins, tri_hi[idx])

            def area(lo_, hi_):
                d = np.maximum(hi_ - lo_, 0.0)
                return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

            # prefix/suffix sweep
            lft_lo = np.minimum.accumulate(bl, 0)
            lft_hi = np.maximum.accumulate(bh, 0)
            rgt_lo = np.minimum.accumulate(bl[::-1], 0)[::-1]
            rgt_hi = np.maximum.accumulate(bh[::-1], 0)[::-1]
            n_l = np.cumsum(counts)[:-1]
            n_r = len(idx) - n_l
            cost = area(lft_lo[:-1], lft_hi[:-1]) * n_l + area(
                rgt_lo[1:], rgt_hi[1:]
            ) * n_r
            valid = (n_l > 0) & (n_r > 0)
            if not valid.any():
                half = len(idx) // 2
                order = np.argsort(c[:, axis], kind="stable")
                l_idx, r_idx = idx[order[:half]], idx[order[half:]]
            else:
                cost = np.where(valid, cost, np.inf)
                split = int(np.argmin(cost))
                go_left = bins <= split
                l_idx, r_idx = idx[go_left], idx[~go_left]

        node["left"] = make_node(l_idx)
        node["right"] = make_node(r_idx)
        return ni

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        if nf > 0:
            make_node(np.arange(nf))
        else:
            nodes.append(
                {
                    "lo": np.zeros(3),
                    "hi": np.zeros(3),
                    "left": -1,
                    "right": -1,
                    "prims": np.zeros(0, np.int64),
                }
            )
    finally:
        sys.setrecursionlimit(old_limit)

    # --- flatten to DFS pre-order with skip links ----------------------------
    nn = len(nodes)
    order = np.empty(nn, np.int32)       # old -> new
    miss = np.full(nn, -1, np.int32)     # new-index miss links
    lo = np.empty((nn, 3), np.float32)
    hi = np.empty((nn, 3), np.float32)
    first = np.zeros(nn, np.int32)
    count = np.zeros(nn, np.int32)
    prim_list = []

    # subtree sizes bottom-up (children always have larger indices than their
    # parent in the `nodes` append order? NO — children are appended after the
    # parent, so a reverse sweep sees children first)
    sizes = np.ones(nn, np.int64)
    for i in range(nn - 1, -1, -1):
        node = nodes[i]
        if node["prims"] is None:
            sizes[i] = 1 + sizes[node["left"]] + sizes[node["right"]]

    # Iterative DFS pre-order flatten with miss-link wiring: left child sits
    # at new_i+1, right child at new_i+1+size(left); left's miss -> right,
    # right's miss -> our miss.
    counter = 0
    stack = [(0, -1)]  # (old node index, miss link in *new* numbering)
    while stack:
        old_i, miss_new = stack.pop()
        node = nodes[old_i]
        new_i = counter
        counter += 1
        lo[new_i] = node["lo"]
        hi[new_i] = node["hi"]
        miss[new_i] = miss_new
        if node["prims"] is not None:
            k = len(node["prims"])
            first[new_i] = len(prim_list)
            count[new_i] = k
            prim_list.extend(np.asarray(node["prims"]).tolist())
            prim_list.extend([-1] * (LEAF_SIZE - k))
        else:
            first[new_i] = new_i + 1  # hit link (left child)
            right_new = new_i + 1 + int(sizes[node["left"]])
            stack.append((node["right"], miss_new))
            stack.append((node["left"], right_new))

    return BVH(
        node_lo=jnp.asarray(lo),
        node_hi=jnp.asarray(hi),
        node_first=jnp.asarray(first),
        node_count=jnp.asarray(count),
        node_miss=jnp.asarray(miss),
        prim_idx=jnp.asarray(np.asarray(prim_list, np.int32)),
    )
