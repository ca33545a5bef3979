"""Scene: SoA geometry + materials + emitters + sensors + BVH, with
ray_intersect producing SurfaceInteraction records.

Array-program replacement for the reference's Scene/Shape plugin aggregation
(src/render/scene.cpp, include/mitsuba/render/scene.h:76-262): everything is
a pytree of arrays; the host loader (loader.py) flattens plugin objects into
these tables at load time.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import frame as fr
from ..core import math as m
from ..librender.bsdf import MaterialTable
from ..librender.records import Ray, SurfaceInteraction
from ..librender.sensor import Sensor
from . import intersect as isect
from .bvh import BVH, build_bvh
from .emitters import EmitterTable


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Geometry:
    """Triangle soup (pre-gathered vertex data, one row per face).

    `tri_isect` packs (p0, e1, e2) rows padded to the intersection chunk size
    for the gather-free chunked intersector; `tri_attr` packs every per-face
    attribute into one [F, 32] matrix so hit-point shading does a SINGLE
    gather per bounce (one packed fetch instead of 12 separate ones)."""

    tri_p0: Any  # [F, 3]
    tri_p1: Any
    tri_p2: Any
    tri_n0: Any  # [F, 3] shading normals per corner
    tri_n1: Any
    tri_n2: Any
    tri_uv0: Any  # [F, 2]
    tri_uv1: Any
    tri_uv2: Any
    face_n: Any    # [F, 3] geometric normal
    tri_mat: Any   # [F] int32 material index
    tri_emitter: Any  # [F] int32 emitter index (-1)
    tri_shape: Any    # [F] int32 source shape id
    tri_isect: Any  # [F_pad, 9] packed (p0, e1, e2) for chunked intersection
    tri_attr: Any   # [F, 40] packed shading attributes (see pack_attributes)
    # --- analytic spheres (reference src/shapes/sphere.cpp:240-330) -------
    # intersected exactly (no tessellation bias); S is small so the test is
    # a vectorized [N, S] broadcast merged with the triangle result
    sph_center: Any = None  # [S, 3]
    sph_radius: Any = None  # [S]
    sph_attr: Any = None    # [S, 3] (mat, emitter, shape) as f32
    # --- analytic disks (reference src/shapes/disk.cpp): plane hit clipped
    # to radius; frame (n, s) carries the uv orientation ---
    dsk_center: Any = None  # [D, 3]
    dsk_n: Any = None       # [D, 3]
    dsk_s: Any = None       # [D, 3] in-plane u axis
    dsk_radius: Any = None  # [D]
    dsk_attr: Any = None    # [D, 3]
    # --- analytic open cylinders (reference src/shapes/cylinder.cpp) ---
    cyl_p0: Any = None      # [C, 3]
    cyl_axis: Any = None    # [C, 3] unit
    cyl_len: Any = None     # [C]
    cyl_radius: Any = None  # [C]
    cyl_attr: Any = None    # [C, 3]

    @property
    def n_faces(self):
        return self.tri_p0.shape[0]

    @property
    def n_spheres(self):
        return 0 if self.sph_center is None else self.sph_center.shape[0]

    @property
    def n_disks(self):
        return 0 if self.dsk_center is None else self.dsk_center.shape[0]

    @property
    def n_cylinders(self):
        return 0 if self.cyl_p0 is None else self.cyl_p0.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scene:
    geo: Geometry
    bvh: BVH
    materials: MaterialTable
    emitters: EmitterTable
    sensor: Sensor
    medium: Any = None  # optional global homogeneous medium (scene/media.py)
    sdfs: Any = ()      # tuple of SDFGrid shapes (scene/sdf.py, sphere-traced)
    env_emitter: int = dataclasses.field(default=-1, metadata=dict(static=True))

    # At or below this face count, the gather-free chunked brute force
    # serves every ray; above it the skip-link BVH walk does. The value was
    # tuned on another accelerator and is kept until the per-lane BVH
    # kernel (ROADMAP S2) measures where the crossover lies on the GPU.
    BRUTE_FORCE_MAX_FACES = 4096

    def _sphere_intersect(self, ray: Ray):
        """Nearest analytic sphere hit: [N] (t, sphere index or -1).

        Vectorized [N, S] quadratic (sphere.cpp:240-290); S is tiny so this
        is pure fused elementwise work, no gathers."""
        geo = self.geo
        c = geo.sph_center  # [S, 3]
        r = geo.sph_radius  # [S]
        oc = ray.o[:, None, :] - c[None, :, :]          # [N, S, 3]
        b = jnp.sum(oc * ray.d[:, None, :], axis=-1)    # [N, S]
        cc = jnp.sum(oc * oc, axis=-1) - (r * r)[None, :]
        disc = b * b - cc
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t0 = -b - sq
        t1 = -b + sq
        eps = 1e-4
        t_hit = jnp.where(t0 > eps, t0, jnp.where(t1 > eps, t1, jnp.inf))
        t_hit = jnp.where(disc >= 0, t_hit, jnp.inf)
        t_hit = jnp.where(t_hit < ray.maxt[:, None], t_hit, jnp.inf)
        best = jnp.argmin(t_hit, axis=-1)
        t_best = jnp.min(t_hit, axis=-1)
        idx = jnp.where(jnp.isfinite(t_best), best.astype(jnp.int32), -1)
        return t_best, idx

    def _disk_intersect(self, ray: Ray):
        """Nearest analytic disk hit (disk.cpp:200-260): plane intersection
        clipped to the radius. Vectorized [N, D]."""
        geo = self.geo
        c = geo.dsk_center
        nrm = geo.dsk_n
        r = geo.dsk_radius
        dn = jnp.sum(ray.d[:, None, :] * nrm[None, :, :], axis=-1)  # [N, D]
        t = jnp.sum((c[None, :, :] - ray.o[:, None, :]) * nrm[None, :, :],
                    axis=-1) / jnp.where(jnp.abs(dn) > 1e-9, dn, 1e-9)
        p = ray.o[:, None, :] + ray.d[:, None, :] * t[..., None]
        rel = p - c[None, :, :]
        r2 = jnp.sum(rel * rel, axis=-1)
        eps = 1e-4
        ok = (jnp.abs(dn) > 1e-9) & (t > eps) & (r2 <= (r * r)[None, :])
        t_hit = jnp.where(ok & (t < ray.maxt[:, None]), t, jnp.inf)
        best = jnp.argmin(t_hit, axis=-1)
        t_best = jnp.min(t_hit, axis=-1)
        idx = jnp.where(jnp.isfinite(t_best), best.astype(jnp.int32), -1)
        return t_best, idx

    def _cyl_intersect(self, ray: Ray):
        """Nearest analytic open-cylinder hit (cylinder.cpp:240-320):
        quadratic against the infinite cylinder, clipped to [0, len] along
        the axis. Vectorized [N, C]."""
        geo = self.geo
        p0 = geo.cyl_p0
        ax = geo.cyl_axis
        ln = geo.cyl_len
        r = geo.cyl_radius
        oc = ray.o[:, None, :] - p0[None, :, :]            # [N, C, 3]
        d_a = jnp.sum(ray.d[:, None, :] * ax[None, :, :], -1)
        oc_a = jnp.sum(oc * ax[None, :, :], -1)
        d_perp = ray.d[:, None, :] - d_a[..., None] * ax[None, :, :]
        oc_perp = oc - oc_a[..., None] * ax[None, :, :]
        A = jnp.sum(d_perp * d_perp, -1)
        B = jnp.sum(d_perp * oc_perp, -1)
        Cc = jnp.sum(oc_perp * oc_perp, -1) - (r * r)[None, :]
        disc = B * B - A * Cc
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        A_safe = jnp.where(A > 1e-12, A, 1e-12)
        t0 = (-B - sq) / A_safe
        t1 = (-B + sq) / A_safe
        eps = 1e-4

        def clipped(t):
            h = oc_a + t * d_a
            return jnp.where(
                (t > eps) & (h >= 0.0) & (h <= ln[None, :]), t, jnp.inf
            )

        t_hit = jnp.minimum(clipped(t0), clipped(t1))
        t_hit = jnp.where((disc >= 0) & (A > 1e-12), t_hit, jnp.inf)
        t_hit = jnp.where(t_hit < ray.maxt[:, None], t_hit, jnp.inf)
        best = jnp.argmin(t_hit, axis=-1)
        t_best = jnp.min(t_hit, axis=-1)
        idx = jnp.where(jnp.isfinite(t_best), best.astype(jnp.int32), -1)
        return t_best, idx

    def _analytic_intersect(self, ray: Ray):
        """Merge all analytic primitive families: returns (t, flat_idx) with
        flat_idx in the extended-prim numbering starting at n_faces:
        [spheres | disks | cylinders]; -1 = no analytic hit."""
        geo = self.geo
        t_best = jnp.full(ray.o.shape[0], jnp.inf)
        idx_best = jnp.full(ray.o.shape[0], -1, jnp.int32)
        off = 0
        if geo.n_spheres:
            t_s, i_s = self._sphere_intersect(ray)
            win = (i_s >= 0) & (t_s < t_best)
            t_best = jnp.where(win, t_s, t_best)
            idx_best = jnp.where(win, i_s + off, idx_best)
        off += geo.n_spheres
        if geo.n_disks:
            t_d, i_d = self._disk_intersect(ray)
            win = (i_d >= 0) & (t_d < t_best)
            t_best = jnp.where(win, t_d, t_best)
            idx_best = jnp.where(win, i_d + off, idx_best)
        off += geo.n_disks
        if geo.n_cylinders:
            t_c, i_c = self._cyl_intersect(ray)
            win = (i_c >= 0) & (t_c < t_best)
            t_best = jnp.where(win, t_c, t_best)
            idx_best = jnp.where(win, i_c + off, idx_best)
        return t_best, idx_best

    @property
    def _n_analytic(self):
        g = self.geo
        return g.n_spheres + g.n_disks + g.n_cylinders

    # ------------------------------------------------------------------
    def intersect_route(self, brute_force: bool = False) -> str:
        """The single routing decision used by ray_intersect/ray_test,
        exposed so tests can pin which intersector a scene selects
        (tests/test_golden.py::test_intersect_routing_tripwire).

        Returns "brute" (isect.chunked_intersect / chunked_occluded: a scan
        over 64-triangle chunks) at or below BRUTE_FORCE_MAX_FACES or when
        forced, else "xla-walk" (the skip-link BVH walk)."""
        if brute_force or self.geo.n_faces <= Scene.BRUTE_FORCE_MAX_FACES:
            return "brute"
        return "xla-walk"

    def ray_intersect(self, ray: Ray, brute_force: bool = False,
                      coherent: Any = False) -> SurfaceInteraction:
        """Closest hit for every lane.

        `coherent` is the reference's hint for ray sets with tile locality
        (camera rays at bounce 0, scene.h:96): a static bool or a traced
        scalar. It is accepted for API parity; no route uses it yet."""
        geo = self.geo
        if self.intersect_route(brute_force) == "brute":
            t, prim, u, v = isect.chunked_intersect(
                geo.tri_isect, ray.o, ray.d, ray.maxt
            )
        else:
            t, prim, u, v = isect.bvh_intersect(
                self.bvh, geo.tri_p0, geo.tri_p1, geo.tri_p2, ray.o, ray.d, ray.maxt
            )
        if self._n_analytic:
            t_a, a_idx = self._analytic_intersect(ray)
            tri_valid = prim >= 0
            a_wins = (a_idx >= 0) & (
                ~tri_valid | (t_a < jnp.where(tri_valid, t, jnp.inf))
            )
            t = jnp.where(a_wins, t_a, t)
            prim = jnp.where(a_wins, geo.n_faces + jnp.maximum(a_idx, 0),
                             prim)
        sdf_n = sdf_uv = sdf_attr = None
        if self.sdfs:
            from .sdf import sdf_intersect

            n_lanes = ray.o.shape[0]
            base_sdf = geo.n_faces + self._n_analytic
            sdf_n = jnp.zeros((n_lanes, 3), jnp.float32)
            sdf_uv = jnp.zeros((n_lanes, 2), jnp.float32)
            sdf_attr = jnp.zeros((n_lanes, 3), jnp.float32)
            for s_i, sdf in enumerate(self.sdfs):
                t_s, hit_s, n_s, uv_s = sdf_intersect(
                    sdf, ray.o, ray.d, ray.maxt
                )
                cur_valid = prim >= 0
                win = hit_s & (
                    ~cur_valid | (t_s < jnp.where(cur_valid, t, jnp.inf))
                )
                t = jnp.where(win, t_s, t)
                prim = jnp.where(win, base_sdf + s_i, prim)
                sdf_n = jnp.where(win[..., None], n_s, sdf_n)
                sdf_uv = jnp.where(win[..., None], uv_s, sdf_uv)
                sdf_attr = jnp.where(win[..., None], sdf.attr[None, :], sdf_attr)
        valid = prim >= 0
        prim_c = jnp.maximum(prim, 0)

        # keep p finite on miss lanes (t = inf would poison gradients of any
        # downstream expression even under where-masks)
        p = ray.o + ray.d * jnp.where(valid, t, 1.0)[..., None]
        # ONE packed fetch for all shading attributes (one-hot contraction
        # for small scenes, see core.math.small_gather)
        attr = m.small_gather(geo.tri_attr, prim_c)  # [N, 32]
        ng = attr[..., 0:3]
        n0 = attr[..., 3:6]
        n1 = attr[..., 6:9]
        n2 = attr[..., 9:12]
        uv0 = attr[..., 12:14]
        uv1 = attr[..., 14:16]
        uv2 = attr[..., 16:18]
        a_mat = attr[..., 18].astype(jnp.int32)
        a_emitter = attr[..., 19].astype(jnp.int32)
        a_shape = attr[..., 20].astype(jnp.int32)
        has_extra = geo.tri_attr.shape[1] >= 40  # static
        w = 1.0 - u - v
        if has_extra:
            a_tan = attr[..., 21:24]
            c0 = attr[..., 24:27]
            c1 = attr[..., 27:30]
            c2 = attr[..., 30:33]
            vcol = c0 * w[..., None] + c1 * u[..., None] + c2 * v[..., None]
        else:
            a_tan = None
            vcol = None
        ns = fr.normalize(
            n0 * w[..., None] + n1 * u[..., None] + n2 * v[..., None]
        )
        # flip geometric normal to the shading side consistency (Mitsuba keeps
        # ng fixed and shading frame from ns)
        uv = uv0 * w[..., None] + uv1 * u[..., None] + uv2 * v[..., None]

        if geo.n_spheres:
            # analytic-sphere overrides (exact normal/uv, sphere.cpp:290-330)
            is_sph = valid & (prim >= geo.n_faces) & (
                prim < geo.n_faces + geo.n_spheres
            )
            s_c = jnp.clip(prim - geo.n_faces, 0, geo.n_spheres - 1)
            center = m.small_gather(geo.sph_center, s_c)
            n_sph = fr.normalize(p - center)
            phi = jnp.arctan2(n_sph[..., 1], n_sph[..., 0])
            theta = m.safe_acos(n_sph[..., 2])
            uv_sph = jnp.stack(
                [phi * (0.5 / jnp.pi) + 0.5, theta / jnp.pi], axis=-1
            )
            sattr = m.small_gather(geo.sph_attr, s_c)
            ng = jnp.where(is_sph[..., None], n_sph, ng)
            ns = jnp.where(is_sph[..., None], n_sph, ns)
            uv = jnp.where(is_sph[..., None], uv_sph, uv)
            a_mat = jnp.where(is_sph, sattr[..., 0].astype(jnp.int32), a_mat)
            a_emitter = jnp.where(
                is_sph, sattr[..., 1].astype(jnp.int32), a_emitter
            )
            a_shape = jnp.where(
                is_sph, sattr[..., 2].astype(jnp.int32), a_shape
            )
        if geo.n_disks:
            # analytic-disk overrides (disk.cpp:260-300): exact frame + polar uv
            base = geo.n_faces + geo.n_spheres
            is_dsk = valid & (prim >= base) & (prim < base + geo.n_disks)
            d_c = jnp.clip(prim - base, 0, geo.n_disks - 1)
            c_d = m.small_gather(geo.dsk_center, d_c)
            n_d = m.small_gather(geo.dsk_n, d_c)
            s_d = m.small_gather(geo.dsk_s, d_c)
            r_d = m.small_gather(geo.dsk_radius[:, None], d_c)[..., 0]
            rel = p - c_d
            xloc = fr.dot(rel, s_d)
            yloc = fr.dot(rel, fr.cross(n_d, s_d))
            r_frac = jnp.sqrt(jnp.maximum(xloc * xloc + yloc * yloc, 0.0)) \
                / jnp.maximum(r_d, 1e-9)
            phi_d = jnp.arctan2(yloc, xloc) * (0.5 / jnp.pi) + 0.5
            uv_d = jnp.stack([r_frac, phi_d], axis=-1)
            dattr = m.small_gather(geo.dsk_attr, d_c)
            ng = jnp.where(is_dsk[..., None], n_d, ng)
            ns = jnp.where(is_dsk[..., None], n_d, ns)
            uv = jnp.where(is_dsk[..., None], uv_d, uv)
            a_mat = jnp.where(is_dsk, dattr[..., 0].astype(jnp.int32), a_mat)
            a_emitter = jnp.where(
                is_dsk, dattr[..., 1].astype(jnp.int32), a_emitter
            )
            a_shape = jnp.where(
                is_dsk, dattr[..., 2].astype(jnp.int32), a_shape
            )
        if geo.n_cylinders:
            # analytic-cylinder overrides (cylinder.cpp:320-360): radial
            # normal + (phi, h) uv
            base = geo.n_faces + geo.n_spheres + geo.n_disks
            is_cyl = valid & (prim >= base) & (prim < base + geo.n_cylinders)
            c_i = jnp.clip(prim - base, 0, geo.n_cylinders - 1)
            p0_c = m.small_gather(geo.cyl_p0, c_i)
            ax_c = m.small_gather(geo.cyl_axis, c_i)
            ln_c = m.small_gather(geo.cyl_len[:, None], c_i)[..., 0]
            rel = p - p0_c
            h = fr.dot(rel, ax_c)
            n_c = fr.normalize(rel - h[..., None] * ax_c)
            s_ax, t_ax = fr.coordinate_system(ax_c)
            phi_c = jnp.arctan2(fr.dot(n_c, t_ax), fr.dot(n_c, s_ax))
            uv_c = jnp.stack(
                [phi_c * (0.5 / jnp.pi) + 0.5,
                 h / jnp.maximum(ln_c, 1e-9)], axis=-1
            )
            cattr = m.small_gather(geo.cyl_attr, c_i)
            ng = jnp.where(is_cyl[..., None], n_c, ng)
            ns = jnp.where(is_cyl[..., None], n_c, ns)
            uv = jnp.where(is_cyl[..., None], uv_c, uv)
            a_mat = jnp.where(is_cyl, cattr[..., 0].astype(jnp.int32), a_mat)
            a_emitter = jnp.where(
                is_cyl, cattr[..., 1].astype(jnp.int32), a_emitter
            )
            a_shape = jnp.where(
                is_cyl, cattr[..., 2].astype(jnp.int32), a_shape
            )

        if self.sdfs:
            base_sdf = geo.n_faces + self._n_analytic
            is_sdf = valid & (prim >= base_sdf)
            ng = jnp.where(is_sdf[..., None], sdf_n, ng)
            ns = jnp.where(is_sdf[..., None], sdf_n, ns)
            uv = jnp.where(is_sdf[..., None], sdf_uv, uv)
            a_mat = jnp.where(is_sdf, sdf_attr[..., 0].astype(jnp.int32), a_mat)
            a_emitter = jnp.where(
                is_sdf, sdf_attr[..., 1].astype(jnp.int32), a_emitter
            )
            a_shape = jnp.where(
                is_sdf, sdf_attr[..., 2].astype(jnp.int32), a_shape
            )

        # tangent-aligned shading frame when the mesh carries fiber/uv
        # tangents (hair fibers need sh_s along the fiber axis); zero
        # tangent rows keep the default arbitrary frame
        sh_s, sh_t = fr.coordinate_system(ns)
        if has_extra:
            tan_len2 = jnp.sum(a_tan * a_tan, axis=-1)
            has_tan = tan_len2 > 0.25
            t_proj = a_tan - fr.dot(a_tan, ns)[..., None] * ns
            t_ok = fr.squared_norm(t_proj) > 1e-12
            t_unit = fr.normalize(
                jnp.where(t_ok[..., None], t_proj, sh_s)
            )
            use_tan = has_tan & t_ok
            sh_s = jnp.where(use_tan[..., None], t_unit, sh_s)
            sh_t = jnp.where(
                use_tan[..., None], fr.cross(ns, t_unit), sh_t
            )
        wi_world = -ray.d
        wi_local = jnp.stack(
            [
                fr.dot(wi_world, sh_s),
                fr.dot(wi_world, sh_t),
                fr.dot(wi_world, ns),
            ],
            axis=-1,
        )
        return SurfaceInteraction(
            valid=valid,
            t=jnp.where(valid, t, jnp.inf),
            p=p,
            n=ng,
            sh_s=sh_s,
            sh_t=sh_t,
            sh_n=ns,
            uv=uv,
            wi=wi_local,
            prim_idx=prim,
            mat_idx=jnp.where(valid, a_mat, -1),
            emitter_idx=jnp.where(valid, a_emitter, -1),
            shape_idx=jnp.where(valid, a_shape, -1),
            vcol=vcol,
        )

    def ray_test(self, ray: Ray, coherent: Any = False) -> Any:
        """Shadow-ray occlusion test (True = occluded), routed like
        ray_intersect; `coherent` is accepted and unused as there."""
        geo = self.geo
        if self.intersect_route() == "brute":
            occ = isect.chunked_occluded(geo.tri_isect, ray.o, ray.d, ray.maxt)
        else:
            occ = isect.bvh_occluded(
                self.bvh, geo.tri_p0, geo.tri_p1, geo.tri_p2, ray.o, ray.d,
                ray.maxt,
            )
        if self._n_analytic:
            _, a_idx = self._analytic_intersect(ray)
            occ = occ | (a_idx >= 0)
        if self.sdfs:
            from .sdf import sdf_intersect

            for sdf in self.sdfs:
                _, hit_s, _, _ = sdf_intersect(sdf, ray.o, ray.d, ray.maxt)
                occ = occ | hit_s
        return occ


# ---------------------------------------------------------------------------
# host-side assembly
# ---------------------------------------------------------------------------

def build_geometry(
    meshes, mat_ids, emitter_ids, shape_ids=None, spheres=None, disks=None,
    cylinders=None,
) -> Tuple[Geometry, BVH]:
    """meshes: list[HostMesh] (already transformed to world); mat_ids /
    emitter_ids: per-mesh ints (-1 = no emitter); spheres / disks /
    cylinders: optional lists of analytic-primitive dicts (exact
    intersections, no tessellation bias — sphere.cpp / disk.cpp /
    cylinder.cpp roles)."""
    P0, P1, P2, N0, N1, N2, U0, U1, U2 = [], [], [], [], [], [], [], [], []
    FN, MAT, EMI, SHP, TAN, VC = [], [], [], [], [], []

    for k, mesh in enumerate(meshes):
        f = mesh.faces
        v = mesh.vertices
        p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
        fn = np.cross(p1 - p0, p2 - p0)
        fn_len = np.linalg.norm(fn, axis=-1, keepdims=True)
        fn = fn / np.maximum(fn_len, 1e-20)
        if mesh.normals is not None and not mesh.face_normals:
            n0, n1, n2 = (
                mesh.normals[f[:, 0]],
                mesh.normals[f[:, 1]],
                mesh.normals[f[:, 2]],
            )
        else:
            n0 = n1 = n2 = fn
        if mesh.uvs is not None:
            u0, u1, u2 = mesh.uvs[f[:, 0]], mesh.uvs[f[:, 1]], mesh.uvs[f[:, 2]]
        else:
            u0 = u1 = u2 = np.zeros((len(f), 2), np.float32)

        P0.append(p0); P1.append(p1); P2.append(p2)
        N0.append(n0); N1.append(n1); N2.append(n2)
        U0.append(u0); U1.append(u1); U2.append(u2)
        FN.append(fn)
        if mesh.tangents is not None:
            tg = (
                mesh.tangents[f[:, 0]] + mesh.tangents[f[:, 1]]
                + mesh.tangents[f[:, 2]]
            )
            tg /= np.maximum(np.linalg.norm(tg, axis=-1, keepdims=True), 1e-9)
            TAN.append(tg)
        else:
            TAN.append(np.zeros((len(f), 3), np.float32))
        if mesh.colors is not None:
            VC.append(np.concatenate(
                [mesh.colors[f[:, 0]], mesh.colors[f[:, 1]],
                 mesh.colors[f[:, 2]]], axis=-1
            ))
        else:
            VC.append(np.zeros((len(f), 9), np.float32))
        MAT.append(np.full(len(f), mat_ids[k], np.int32))
        EMI.append(np.full(len(f), emitter_ids[k], np.int32))
        SHP.append(np.full(len(f), k if shape_ids is None else shape_ids[k], np.int32))

    cat = lambda xs: np.concatenate(xs, 0).astype(np.float32)
    cati = lambda xs: np.concatenate(xs, 0).astype(np.int32)

    p0c, p1c, p2c = cat(P0), cat(P1), cat(P2)
    nf_total = len(p0c)

    # packed intersection rows (p0, e1, e2), chunk-padded with degenerate tris
    CHUNK = 64
    pad = (-nf_total) % CHUNK
    isect_rows = np.concatenate([p0c, p1c - p0c, p2c - p0c], axis=-1)
    isect_rows = np.concatenate(
        [isect_rows, np.zeros((pad, 9), np.float32)], axis=0
    )

    # packed shading attributes: ng(3) n0(3) n1(3) n2(3) uv0(2) uv1(2)
    # uv2(2) mat(1) emitter(1) shape(1) [tangent(3) corner-colors(9) only
    # when some mesh carries them — the narrow 24-col layout keeps the
    # common per-bounce gather small]
    tan_cat = cat(TAN)
    vc_cat = cat(VC)
    has_extra = bool((np.abs(tan_cat).max() if len(tan_cat) else 0.0) > 0
                     or (np.abs(vc_cat).max() if len(vc_cat) else 0.0) > 0)
    attr = np.zeros((nf_total, 40 if has_extra else 24), np.float32)
    attr[:, 0:3] = cat(FN)
    attr[:, 3:6] = cat(N0)
    attr[:, 6:9] = cat(N1)
    attr[:, 9:12] = cat(N2)
    attr[:, 12:14] = cat(U0)
    attr[:, 14:16] = cat(U1)
    attr[:, 16:18] = cat(U2)
    attr[:, 18] = cati(MAT)
    attr[:, 19] = cati(EMI)
    attr[:, 20] = cati(SHP)
    if has_extra:
        # fiber/uv tangent (zero = no tangent; frame falls back to
        # coordinate_system), consumed by the hair BSDF's fiber frame +
        # per-corner vertex colors (mesh_attribute texture role)
        attr[:, 21:24] = tan_cat
        attr[:, 24:33] = vc_cat

    geo = Geometry(
        tri_p0=jnp.asarray(p0c), tri_p1=jnp.asarray(p1c),
        tri_p2=jnp.asarray(p2c),
        tri_n0=jnp.asarray(cat(N0)), tri_n1=jnp.asarray(cat(N1)),
        tri_n2=jnp.asarray(cat(N2)),
        tri_uv0=jnp.asarray(cat(U0)), tri_uv1=jnp.asarray(cat(U1)),
        tri_uv2=jnp.asarray(cat(U2)),
        face_n=jnp.asarray(cat(FN)),
        tri_mat=jnp.asarray(cati(MAT)),
        tri_emitter=jnp.asarray(cati(EMI)),
        tri_shape=jnp.asarray(cati(SHP)),
        tri_isect=jnp.asarray(isect_rows),
        tri_attr=jnp.asarray(attr),
        **(
            dict(
                sph_center=jnp.asarray(
                    np.stack([np.asarray(s["center"], np.float32)
                              for s in spheres])
                ),
                sph_radius=jnp.asarray(
                    np.asarray([s["radius"] for s in spheres], np.float32)
                ),
                sph_attr=jnp.asarray(
                    np.asarray(
                        [[s.get("mat", 0), s.get("emitter", -1),
                          s.get("shape", -1)] for s in spheres],
                        np.float32,
                    )
                ),
            )
            if spheres
            else {}
        ),
        **(
            dict(
                dsk_center=jnp.asarray(
                    np.stack([np.asarray(d["center"], np.float32)
                              for d in disks])
                ),
                dsk_n=jnp.asarray(
                    np.stack([np.asarray(d["n"], np.float32) for d in disks])
                ),
                dsk_s=jnp.asarray(
                    np.stack([np.asarray(d["s"], np.float32) for d in disks])
                ),
                dsk_radius=jnp.asarray(
                    np.asarray([d["radius"] for d in disks], np.float32)
                ),
                dsk_attr=jnp.asarray(
                    np.asarray(
                        [[d.get("mat", 0), d.get("emitter", -1),
                          d.get("shape", -1)] for d in disks],
                        np.float32,
                    )
                ),
            )
            if disks
            else {}
        ),
        **(
            dict(
                cyl_p0=jnp.asarray(
                    np.stack([np.asarray(c["p0"], np.float32)
                              for c in cylinders])
                ),
                cyl_axis=jnp.asarray(
                    np.stack([np.asarray(c["axis"], np.float32)
                              for c in cylinders])
                ),
                cyl_len=jnp.asarray(
                    np.asarray([c["length"] for c in cylinders], np.float32)
                ),
                cyl_radius=jnp.asarray(
                    np.asarray([c["radius"] for c in cylinders], np.float32)
                ),
                cyl_attr=jnp.asarray(
                    np.asarray(
                        [[c.get("mat", 0), c.get("emitter", -1),
                          c.get("shape", -1)] for c in cylinders],
                        np.float32,
                    )
                ),
            )
            if cylinders
            else {}
        ),
    )

    # BVH build over the concatenated soup
    p0_np, p1_np, p2_np = cat(P0), cat(P1), cat(P2)
    nf = len(p0_np)
    verts = np.concatenate([p0_np, p1_np, p2_np], 0)
    faces = np.stack(
        [np.arange(nf), np.arange(nf) + nf, np.arange(nf) + 2 * nf], -1
    ).astype(np.int32)
    bvh = build_bvh(verts, faces)
    return geo, bvh


def scene_bounds(geo: Geometry):
    lo = np.minimum.reduce(
        [np.asarray(geo.tri_p0).min(0), np.asarray(geo.tri_p1).min(0),
         np.asarray(geo.tri_p2).min(0)]
    )
    hi = np.maximum.reduce(
        [np.asarray(geo.tri_p0).max(0), np.asarray(geo.tri_p1).max(0),
         np.asarray(geo.tri_p2).max(0)]
    )
    if geo.sph_center is not None:
        c = np.asarray(geo.sph_center)
        r = np.asarray(geo.sph_radius)[:, None]
        lo = np.minimum(lo, (c - r).min(0))
        hi = np.maximum(hi, (c + r).max(0))
    if geo.dsk_center is not None:
        c = np.asarray(geo.dsk_center)
        r = np.asarray(geo.dsk_radius)[:, None]
        lo = np.minimum(lo, (c - r).min(0))
        hi = np.maximum(hi, (c + r).max(0))
    if geo.cyl_p0 is not None:
        a = np.asarray(geo.cyl_p0)
        b = a + np.asarray(geo.cyl_axis) * np.asarray(geo.cyl_len)[:, None]
        r = np.asarray(geo.cyl_radius)[:, None]
        lo = np.minimum(lo, np.minimum(a, b).min(0) - r.max())
        hi = np.maximum(hi, np.maximum(a, b).max(0) + r.max())
    center = (lo + hi) / 2
    radius = float(np.linalg.norm(hi - lo) / 2)
    return center.astype(np.float32), radius
