"""BSDF framework: flags, context, material table, masked-dispatch.

Array-program replacement for the reference's virtual-call plugin dispatch
(include/mitsuba/render/bsdf.h): materials live in a struct-of-arrays table;
a wavefront is evaluated by running every *present* BSDF type on all lanes
and masking — the idiomatic XLA formulation of Dr.Jit's vcall grouping
(there is no per-lane control flow on the VPU anyway, so this is also the
fast formulation).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp


class BSDFFlags:
    Empty = 0
    Null = 0x00001
    DiffuseReflection = 0x00002
    DiffuseTransmission = 0x00004
    GlossyReflection = 0x00008
    GlossyTransmission = 0x00010
    DeltaReflection = 0x00020
    DeltaTransmission = 0x00040
    Anisotropic = 0x01000
    SpatiallyVarying = 0x02000
    NonSymmetric = 0x04000
    FrontSide = 0x08000
    BackSide = 0x10000

    Reflection = DiffuseReflection | DeltaReflection | GlossyReflection
    Transmission = DiffuseTransmission | DeltaTransmission | GlossyTransmission | Null
    Diffuse = DiffuseReflection | DiffuseTransmission
    Glossy = GlossyReflection | GlossyTransmission
    Smooth = Diffuse | Glossy
    Delta = DeltaReflection | DeltaTransmission | Null
    All = Reflection | Transmission


class TransportMode:
    Radiance = 0
    Importance = 1


@dataclasses.dataclass(frozen=True)
class BSDFContext:
    """Static per-trace context (hashable; not a pytree)."""

    mode: int = TransportMode.Radiance
    type_mask: int = BSDFFlags.All
    component: int = -1  # -1: all

    def is_enabled(self, flags: int) -> bool:
        return (self.type_mask & flags) != 0

    def reverse(self) -> "BSDFContext":
        return BSDFContext(
            mode=1 - self.mode, type_mask=self.type_mask, component=self.component
        )


# BSDF type tags (values are table indices — keep stable, loaders depend on them)
BSDF_NULL = 0
BSDF_DIFFUSE = 1
BSDF_CONDUCTOR = 2
BSDF_ROUGH_CONDUCTOR = 3
BSDF_DIELECTRIC = 4
BSDF_THIN_DIELECTRIC = 5
BSDF_ROUGH_DIELECTRIC = 6
BSDF_PLASTIC = 7
BSDF_ROUGH_PLASTIC = 8
BSDF_ROUGH_GRATING = 9
BSDF_MASK = 10
BSDF_POLARIZER = 11
BSDF_RETARDER = 12
BSDF_PPLASTIC = 13
BSDF_MEASURED = 14
BSDF_BLEND = 15
BSDF_NORMALMAP = 16
BSDF_BUMPMAP = 17
BSDF_CIRCULAR = 18
BSDF_PRINCIPLED = 19
BSDF_PRINCIPLED_THIN = 20
BSDF_HAIR = 21
BSDF_MEASURED_POLARIZED = 22

BSDF_TYPE_NAMES = {
    BSDF_NULL: "null",
    BSDF_DIFFUSE: "diffuse",
    BSDF_CONDUCTOR: "conductor",
    BSDF_ROUGH_CONDUCTOR: "roughconductor",
    BSDF_DIELECTRIC: "dielectric",
    BSDF_THIN_DIELECTRIC: "thindielectric",
    BSDF_ROUGH_DIELECTRIC: "roughdielectric",
    BSDF_PLASTIC: "plastic",
    BSDF_ROUGH_PLASTIC: "roughplastic",
    BSDF_ROUGH_GRATING: "roughgrating",
    BSDF_MASK: "mask",
    BSDF_POLARIZER: "polarizer",
    BSDF_RETARDER: "retarder",
    BSDF_PPLASTIC: "pplastic",
    BSDF_MEASURED: "measured",
    BSDF_BLEND: "blendbsdf",
    BSDF_NORMALMAP: "normalmap",
    BSDF_BUMPMAP: "bumpmap",
    BSDF_CIRCULAR: "circular",
    BSDF_PRINCIPLED: "principled",
    BSDF_PRINCIPLED_THIN: "principledthin",
    BSDF_HAIR: "hair",
    BSDF_MEASURED_POLARIZED: "measured_polarized",
}


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """Struct-of-arrays material storage, [M, ...] per field.

    `present_types` is static metadata: the sorted tuple of BSDF type tags in
    this scene — the dispatcher unrolls over it at trace time.
    All color-like fields are stored in RGB; spectral variants up-sample on
    the fly via the sigmoid-polynomial coefficients in `*_coeff` fields.
    """

    mtype: Any          # [M] int32 tag
    flags: Any          # [M] uint32 BSDFFlags
    twosided: Any       # [M] bool — wrap in twosided adapter
    base_color: Any     # [M, 3] reflectance / specular_reflectance / diffuse
    base_color_coeff: Any  # [M, 3] sigmoid-poly coeffs of base_color
    transmittance: Any  # [M, 3] specular_transmittance
    eta_re: Any         # [M, 3] conductor eta (RGB) or dielectric eta in [:,0]
    eta_im: Any         # [M, 3] conductor k
    alpha: Any          # [M, 2] roughness (u, v)
    mf_type: Any        # [M] int32 microfacet type (GGX=0 / Beckmann=1)
    # --- diffraction grating parameters (roughgrating) ---
    grt_inv_period: Any  # [M, 2] 1/period in x,y (units 1/um)
    grt_height: Any      # [M] peak-to-trough height (um)
    grt_lobes: Any       # [M] int32 number of lobes per side
    grt_type: Any        # [M] int32 DiffractionGratingType
    grt_multiplier: Any  # [M] intensity multiplier
    grt_coherence: Any   # [M] coherence mode weight
    # --- nested-bsdf indirection (mask/blend/normalmap wrap another entry) ---
    nested_idx: Any      # [M] int32, -1 when unused (blend: child A)
    nested_idx2: Any     # [M] int32, -1 when unused (blend: child B)
    weight: Any          # [M] blend weight / opacity / bumpmap scale
    # --- principled extras [M, 8]: metallic, specular, spec_tint, sheen,
    # sheen_tint, clearcoat, clearcoat_gloss, anisotropic
    # (reference src/bsdfs/principled.cpp props) ---
    pr_params: Any = None
    # --- textured base_color (reference src/textures/{bitmap,checkerboard}) ---
    tex_mode: Any = None      # [M] int32: 0 const, 1 bitmap, 2 checkerboard
    tex_idx: Any = None       # [M] int32 index into tex_stack (-1 none)
    tex_uv_scale: Any = None  # [M, 2] uv tiling
    tex_color1: Any = None    # [M, 3] checkerboard second color
    tex_stack: Any = None     # [T, R, R, 3] bitmap stack (common resolution)
    # --- measured materials (reference src/bsdfs/measured.cpp): index into
    # the scene's MeasuredTables pytree riding in `meas` ---
    meas_idx: Any = None      # [M] int32 (-1 none)
    meas: Any = None          # MeasuredTables or None
    # polarized measured pBSDF (measured_polarized.cpp); ONE dataset per
    # scene (the tensor is 6-D; stacking differently-sized measurements is
    # not supported — matching typical usage)
    mpol: Any = None          # PolarizedMeasurement or None
    # volume texture (src/textures/volume.cpp): ONE 3D RGB grid per scene,
    # sampled at the world-space hit point inside [vtex_min, vtex_max]
    vtex_grid: Any = None     # [Dz, Dy, Dx, 3]
    vtex_min: Any = None      # [3]
    vtex_max: Any = None      # [3]
    # --- spectral conductor IOR curves on core.ior.IOR_WAVELENGTHS
    # (role of resources/data/ior/*.spd; None -> RGB eta/k only) ---
    eta_spec: Any = None      # [M, N_IOR]
    k_spec: Any = None        # [M, N_IOR]

    present_types: Tuple[int, ...] = dataclasses.field(
        default=(), metadata=dict(static=True)
    )
    # static grating metadata, computed host-side at scene build
    # (finalize_grating_meta): (max_half, separable_1d). max_half bounds the
    # lobe grid the wave-eval sums over; separable_1d=True means every
    # grating in the scene is 1D, axis-aligned and non-radial, so the 2D
    # lobe-grid sum collapses to one row times the ly multiplicity.
    grt_static: Tuple[int, int] = dataclasses.field(
        default=(4, 0), metadata=dict(static=True)
    )
    # static microfacet-NDF consensus over the scene's rough materials
    # (0 = GGX, 1 = Beckmann — the reference's DEFAULT for roughconductor/
    # roughdielectric/roughplastic/roughgrating is Beckmann): computed in
    # finalize_grating_meta; mixed scenes fall back to the majority with a
    # warning (per-lane NDF selection is not worth the dual evaluation)
    mf_static: int = dataclasses.field(
        default=1, metadata=dict(static=True)
    )

    @staticmethod
    def empty(m: int, present_types=()):
        z3 = jnp.zeros((m, 3), jnp.float32)
        z1 = jnp.zeros((m,), jnp.float32)
        return MaterialTable(
            mtype=jnp.zeros((m,), jnp.int32),
            flags=jnp.zeros((m,), jnp.uint32),
            twosided=jnp.zeros((m,), bool),
            base_color=z3 + 0.5,
            base_color_coeff=z3,
            transmittance=z3 + 1.0,
            eta_re=z3,
            eta_im=z3 + 1.0,
            alpha=jnp.full((m, 2), 0.1, jnp.float32),
            mf_type=jnp.ones((m,), jnp.int32),  # Beckmann — the
            # reference's default for every rough plugin
            grt_inv_period=jnp.ones((m, 2), jnp.float32),
            grt_height=z1 + 0.1,
            grt_lobes=jnp.full((m,), 3, jnp.int32),
            grt_type=jnp.zeros((m,), jnp.int32),
            grt_multiplier=z1 + 1.0,
            grt_coherence=z1 + 1.0,
            pr_params=jnp.zeros((m, 8), jnp.float32),
            nested_idx=jnp.full((m,), -1, jnp.int32),
            nested_idx2=jnp.full((m,), -1, jnp.int32),
            weight=z1 + 0.5,
            present_types=tuple(present_types),
        )

    def gather(self, midx) -> Dict[str, Any]:
        """Per-lane parameter dict for material indices midx [N].

        Small tables (M <= 8, the common case): each field is a chain of
        broadcast selects over the M rows — the rows are trace-time
        constants living in registers, so every field FUSES INTO ITS
        CONSUMER and no per-lane buffer materializes at all (a packed
        [N, 55] one-fetch buffer would be re-read by every column slice).

        Larger tables: one packed [M, D] f32 matrix + a single fetch
        instead of one in-loop gather per field; integer fields
        are exact in f32 (all values < 2^24)."""
        fields = []
        for f in dataclasses.fields(self):
            if f.metadata.get("static") or f.name in (
                "tex_stack", "meas", "mpol", "vtex_grid", "vtex_min",
                "vtex_max",
            ):
                continue
            arr = getattr(self, f.name)
            if arr is None:
                continue
            fields.append((f.name, arr))

        M = self.mtype.shape[0]
        if M <= 8:
            out = {}
            for name, arr in fields:
                if arr.ndim == 1:
                    res = jnp.broadcast_to(arr[0], midx.shape)
                    for t in range(1, M):
                        res = jnp.where(midx == t, arr[t], res)
                else:
                    res = jnp.broadcast_to(
                        arr[0], midx.shape + (arr.shape[1],)
                    )
                    for t in range(1, M):
                        res = jnp.where((midx == t)[..., None], arr[t], res)
                out[name] = res
            out["_ndf"] = int(self.mf_static)  # static, not per-lane
            return out

        parts = []
        names = []
        widths = []
        dtypes = []
        for name, arr in fields:
            a2 = arr[:, None] if arr.ndim == 1 else arr
            parts.append(a2.astype(jnp.float32))
            names.append(name)
            widths.append(a2.shape[1])
            dtypes.append((arr.dtype, arr.ndim))
        packed = jnp.concatenate(parts, axis=-1)  # [M, D]
        from ..core.math import small_gather

        rows = small_gather(packed, midx)  # [N, D] — ONE fetch (one-hot contraction)
        out = {}
        off = 0
        for name, w, (dt, nd) in zip(names, widths, dtypes):
            sl = rows[..., off : off + w]
            if nd == 1:
                sl = sl[..., 0]
            if jnp.issubdtype(dt, jnp.integer) or dt == jnp.bool_:
                sl = sl.astype(dt)
            out[name] = sl
            off += w
        out["_ndf"] = int(self.mf_static)  # static, not per-lane
        return out


def finalize_grating_meta(tab: "MaterialTable") -> "MaterialTable":
    """Compute the static grating metadata from a host-built table.

    Call after the material arrays are filled with concrete values (loader /
    dict loader / presets). max_half bounds the wave-eval lobe grid to the
    scene's actual maximum order (the reference's per-instance m_lobes,
    diffractiongrating.h:24 caps at 9); separable_1d records that every
    grating is 1D + axis-aligned + non-radial, in which case the diffracted
    direction is independent of ly (diffractiongrating.h:201-226 with
    inv_period.y = 0) and the 2D sum collapses to one row."""
    import numpy as np

    mtype = np.asarray(tab.mtype)

    # static microfacet-NDF consensus over rough materials (mf_static)
    rough = np.isin(mtype, [BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_DIELECTRIC,
                            BSDF_ROUGH_PLASTIC, BSDF_PPLASTIC,
                            BSDF_ROUGH_GRATING])
    if rough.any():
        mts = np.asarray(tab.mf_type)[rough]
        vals, counts = np.unique(mts, return_counts=True)
        mf_static = int(vals[np.argmax(counts)])
        if len(vals) > 1:
            import warnings

            warnings.warn(
                "scene mixes microfacet distributions "
                f"({dict(zip(vals.tolist(), counts.tolist()))}); using the "
                f"majority NDF {mf_static} for every rough material"
            )
    else:
        mf_static = 1  # reference default: Beckmann
    tab = dataclasses.replace(tab, mf_static=mf_static)

    grating = mtype == BSDF_ROUGH_GRATING
    if not grating.any():
        return dataclasses.replace(tab, grt_static=(0, 0))
    lobes = np.asarray(tab.grt_lobes)[grating]
    inv_p = np.asarray(tab.grt_inv_period)[grating]
    gtype = np.asarray(tab.grt_type)[grating]
    max_half = int(min(max(lobes) // 2, 4))
    radial = (gtype & 0x10) != 0  # DiffractionGratingType::Radial
    separable = bool((~radial).all() and (inv_p[:, 1] < 1e-9).all())
    return dataclasses.replace(tab, grt_static=(max_half, int(separable)))
