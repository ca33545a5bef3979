// Native scene-preparation runtime: binned-SAH BVH builder producing the
// flat skip-link layout consumed by the device traversal kernels
// (mitsuba3_plt_tpu/scene/bvh.py documents the layout contract).
//
// Role parity: the reference's accel backends build on native code too
// (embree BVH / kd-tree, src/render/scene_embree.inl, kdtree.h); here the
// host-side build is the native piece while traversal runs on the device. The
// numpy builder in bvh.py stays as a fallback; this one handles
// multi-million-triangle scenes at interactive build times.
//
// Exposed C ABI (ctypes): build_bvh(...) fills caller-allocated arrays and
// returns the node count (or -1 if capacity was insufficient).

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int LEAF_SIZE = 4;
constexpr int SAH_BINS = 16;

struct Vec3 {
    float x, y, z;
    Vec3() : x(0), y(0), z(0) {}
    Vec3(float a, float b, float c) : x(a), y(b), z(c) {}
};

inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
    return Vec3(std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z));
}
inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
    return Vec3(std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z));
}

struct AABB {
    Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
    Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
    void grow(const Vec3 &p) { lo = vmin(lo, p); hi = vmax(hi, p); }
    void grow(const AABB &b) { lo = vmin(lo, b.lo); hi = vmax(hi, b.hi); }
    float area() const {
        float dx = std::max(hi.x - lo.x, 0.f);
        float dy = std::max(hi.y - lo.y, 0.f);
        float dz = std::max(hi.z - lo.z, 0.f);
        return dx * dy + dy * dz + dz * dx;
    }
};

struct BuildNode {
    AABB box;
    int32_t left = -1, right = -1;   // build-tree children
    int32_t prim_start = -1;          // into the ordered prim index list
    int32_t prim_count = 0;
    int32_t subtree = 1;              // nodes in this subtree (for layout)
};

struct Builder {
    const float *p0, *p1, *p2;
    std::vector<AABB> tri_box;
    std::vector<Vec3> cent;
    std::vector<int32_t> prims;       // permuted triangle indices
    std::vector<BuildNode> nodes;

    Vec3 tri(const float *base, int32_t i) const {
        return Vec3(base[3 * i], base[3 * i + 1], base[3 * i + 2]);
    }

    int32_t build(int32_t begin, int32_t end) {
        BuildNode node;
        for (int32_t k = begin; k < end; ++k) node.box.grow(tri_box[prims[k]]);
        int32_t ni = (int32_t)nodes.size();
        nodes.push_back(node);

        int32_t count = end - begin;
        if (count <= LEAF_SIZE) {
            nodes[ni].prim_start = begin;
            nodes[ni].prim_count = count;
            return ni;
        }

        // centroid bounds + widest axis
        AABB cb;
        for (int32_t k = begin; k < end; ++k) cb.grow(cent[prims[k]]);
        float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
        int axis = ext[1] > ext[0] ? 1 : 0;
        if (ext[2] > ext[axis]) axis = 2;
        float lo = axis == 0 ? cb.lo.x : (axis == 1 ? cb.lo.y : cb.lo.z);
        float extent = ext[axis];

        int32_t mid;
        if (extent < 1e-12f) {
            mid = begin + count / 2;
        } else {
            // binned SAH
            struct Bin { AABB box; int32_t n = 0; } bins[SAH_BINS];
            auto bin_of = [&](int32_t t) {
                float c = axis == 0 ? cent[t].x : (axis == 1 ? cent[t].y : cent[t].z);
                int b = (int)((c - lo) / extent * SAH_BINS);
                return std::min(std::max(b, 0), SAH_BINS - 1);
            };
            for (int32_t k = begin; k < end; ++k) {
                int b = bin_of(prims[k]);
                bins[b].box.grow(tri_box[prims[k]]);
                bins[b].n++;
            }
            AABB lbox[SAH_BINS], rbox[SAH_BINS];
            int32_t lcnt[SAH_BINS], rcnt[SAH_BINS];
            AABB acc; int32_t cnt = 0;
            for (int b = 0; b < SAH_BINS; ++b) {
                acc.grow(bins[b].box); cnt += bins[b].n;
                lbox[b] = acc; lcnt[b] = cnt;
            }
            acc = AABB(); cnt = 0;
            for (int b = SAH_BINS - 1; b >= 0; --b) {
                acc.grow(bins[b].box); cnt += bins[b].n;
                rbox[b] = acc; rcnt[b] = cnt;
            }
            float best = FLT_MAX; int best_split = -1;
            for (int b = 0; b < SAH_BINS - 1; ++b) {
                if (lcnt[b] == 0 || rcnt[b + 1] == 0) continue;
                float c = lbox[b].area() * lcnt[b] + rbox[b + 1].area() * rcnt[b + 1];
                if (c < best) { best = c; best_split = b; }
            }
            if (best_split < 0) {
                mid = begin + count / 2;
                std::nth_element(
                    prims.begin() + begin, prims.begin() + mid,
                    prims.begin() + end, [&](int32_t a, int32_t b) {
                        float ca = axis == 0 ? cent[a].x : (axis == 1 ? cent[a].y : cent[a].z);
                        float cbv = axis == 0 ? cent[b].x : (axis == 1 ? cent[b].y : cent[b].z);
                        return ca < cbv;
                    });
            } else {
                auto it = std::partition(
                    prims.begin() + begin, prims.begin() + end,
                    [&](int32_t t) { return bin_of(t) <= best_split; });
                mid = (int32_t)(it - prims.begin());
                if (mid == begin || mid == end) mid = begin + count / 2;
            }
        }

        int32_t l = build(begin, mid);
        int32_t r = build(mid, end);
        nodes[ni].left = l;
        nodes[ni].right = r;
        nodes[ni].subtree = 1 + nodes[l].subtree + nodes[r].subtree;
        return ni;
    }
};

}  // namespace

extern "C" {

// Returns node count written, or -1 if node_capacity/prim_capacity too small.
// Outputs (caller-allocated):
//   node_lo/node_hi [cap,3] f32; node_first/node_count/node_miss [cap] i32;
//   prim_idx [prim_cap] i32 (leaf slots padded with -1, LEAF_SIZE stride).
// prim_pad_out receives the number of prim slots written.
int32_t build_bvh(
    const float *p0, const float *p1, const float *p2, int32_t nf,
    float *node_lo, float *node_hi, int32_t *node_first, int32_t *node_count,
    int32_t *node_miss, int32_t node_capacity,
    int32_t *prim_idx, int32_t prim_capacity, int32_t *prim_pad_out) {
    Builder B;
    B.p0 = p0; B.p1 = p1; B.p2 = p2;
    B.tri_box.resize(nf);
    B.cent.resize(nf);
    B.prims.resize(nf);
    for (int32_t i = 0; i < nf; ++i) {
        AABB b;
        b.grow(B.tri(p0, i));
        b.grow(B.tri(p1, i));
        b.grow(B.tri(p2, i));
        B.tri_box[i] = b;
        B.cent[i] = Vec3(0.5f * (b.lo.x + b.hi.x), 0.5f * (b.lo.y + b.hi.y),
                         0.5f * (b.lo.z + b.hi.z));
        B.prims[i] = i;
    }
    if (nf == 0) {
        if (node_capacity < 1) return -1;
        std::memset(node_lo, 0, 3 * sizeof(float));
        std::memset(node_hi, 0, 3 * sizeof(float));
        node_first[0] = 0; node_count[0] = 0; node_miss[0] = -1;
        *prim_pad_out = 0;
        return 1;
    }
    B.nodes.reserve(2 * nf / LEAF_SIZE + 2);
    B.build(0, nf);

    int32_t nn = (int32_t)B.nodes.size();
    if (nn > node_capacity) return -1;

    // DFS pre-order flatten with skip links (same wiring as bvh.py:154-177)
    struct Item { int32_t old_i; int32_t miss; };
    std::vector<Item> stack;
    stack.push_back({0, -1});
    int32_t counter = 0;
    int32_t prim_cursor = 0;
    while (!stack.empty()) {
        Item it = stack.back();
        stack.pop_back();
        const BuildNode &n = B.nodes[it.old_i];
        int32_t new_i = counter++;
        node_lo[3 * new_i] = n.box.lo.x;
        node_lo[3 * new_i + 1] = n.box.lo.y;
        node_lo[3 * new_i + 2] = n.box.lo.z;
        node_hi[3 * new_i] = n.box.hi.x;
        node_hi[3 * new_i + 1] = n.box.hi.y;
        node_hi[3 * new_i + 2] = n.box.hi.z;
        node_miss[new_i] = it.miss;
        if (n.prim_count > 0) {
            if (prim_cursor + LEAF_SIZE > prim_capacity) return -1;
            node_first[new_i] = prim_cursor;
            node_count[new_i] = n.prim_count;
            for (int32_t k = 0; k < LEAF_SIZE; ++k) {
                prim_idx[prim_cursor + k] =
                    k < n.prim_count ? B.prims[n.prim_start + k] : -1;
            }
            prim_cursor += LEAF_SIZE;
        } else {
            node_first[new_i] = new_i + 1;  // hit link = left child
            int32_t right_new = new_i + 1 + B.nodes[n.left].subtree;
            node_count[new_i] = 0;
            stack.push_back({n.right, it.miss});
            stack.push_back({n.left, right_new});
        }
    }
    *prim_pad_out = prim_cursor;
    return nn;
}

// Fast binary little-endian PLY vertex/face extraction is in mesh_io.cpp.

}  // extern "C"
