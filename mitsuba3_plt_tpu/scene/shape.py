"""Host-side geometry: mesh loading (PLY/OBJ), analytic-shape tessellation,
and flattening into the SoA triangle soup consumed by the device.

All shapes become triangles (reference keeps analytic sphere/disk prims,
src/shapes/*; we tessellate — wavefront-uniform triangle intersection is the
vectorization-friendly choice. Analytic quadrics can be added as a second prim stream
later if golden-image parity demands it).
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Optional

import numpy as np


@dataclasses.dataclass
class HostMesh:
    vertices: np.ndarray            # [V, 3] f32
    faces: np.ndarray               # [F, 3] i32
    normals: Optional[np.ndarray] = None   # [V, 3] f32 (vertex normals)
    uvs: Optional[np.ndarray] = None       # [V, 2] f32
    face_normals: bool = False      # force flat shading
    tangents: Optional[np.ndarray] = None  # [V, 3] f32 (fiber/uv tangents)
    colors: Optional[np.ndarray] = None    # [V, 3] f32 vertex colors

    def transformed(self, to_world: np.ndarray) -> "HostMesh":
        v = self.vertices @ to_world[:3, :3].T + to_world[:3, 3]
        tg = None
        if self.tangents is not None:
            tg = self.tangents @ to_world[:3, :3].T
            tg = tg / np.maximum(
                np.linalg.norm(tg, axis=-1, keepdims=True), 1e-9
            )
        n = None
        if self.normals is not None:
            inv = np.linalg.inv(to_world[:3, :3])
            n = self.normals @ inv  # inverse transpose: (A^-1)^T applied = n @ A^-1
            norms = np.linalg.norm(n, axis=-1, keepdims=True)
            n = n / np.maximum(norms, 1e-20)
        return HostMesh(
            vertices=v.astype(np.float32),
            faces=self.faces,
            normals=None if n is None else n.astype(np.float32),
            uvs=self.uvs,
            face_normals=self.face_normals,
            tangents=None if tg is None else tg.astype(np.float32),
            colors=self.colors,
        )

    def surface_areas(self) -> np.ndarray:
        p0 = self.vertices[self.faces[:, 0]]
        p1 = self.vertices[self.faces[:, 1]]
        p2 = self.vertices[self.faces[:, 2]]
        return 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)


# ---------------------------------------------------------------------------
# PLY loader (ascii + binary_little_endian), minimal but covers Mitsuba/Blender
# exports used by the bundled scenes.
# ---------------------------------------------------------------------------

_PLY_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def load_ply(path: str) -> HostMesh:
    with open(path, "rb") as f:
        data = f.read()

    # --- header ---
    end = data.find(b"end_header\n")
    if end < 0:
        raise ValueError(f"{path}: no PLY end_header")
    header = data[:end].decode("ascii", "replace").splitlines()
    body = data[end + len(b"end_header\n"):]

    fmt = None
    elements = []  # (name, count, [(prop_type, prop_name) | ('list', idx_t, cnt_t, name)])
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append(("list", tok[2], tok[3], tok[4]))
            else:
                elements[-1][2].append((tok[1], tok[2]))

    verts = normals = uvs = vcolors = None
    faces = []

    if fmt == "ascii":
        lines = body.decode("ascii", "replace").split("\n")
        li = 0
        for name, count, props in elements:
            if name == "vertex":
                rows = np.array(
                    [lines[li + i].split() for i in range(count)], dtype=np.float64
                )
                li += count
                cols = [p[1] for p in props]
                verts, normals, uvs, vcolors = _extract_vertex_data(rows, cols)
            elif name == "face":
                for i in range(count):
                    tok = lines[li + i].split()
                    k = int(tok[0])
                    idx = list(map(int, tok[1 : 1 + k]))
                    for j in range(1, k - 1):
                        faces.append((idx[0], idx[j], idx[j + 1]))
                li += count
            else:
                li += count
    else:
        if fmt != "binary_little_endian":
            raise ValueError(f"{path}: unsupported PLY format {fmt}")
        off = 0
        for name, count, props in elements:
            if name == "vertex":
                dt = np.dtype(
                    [(p[1], "<" + _PLY_TYPES[p[0]][0]) for p in props]
                )
                arr = np.frombuffer(body, dtype=dt, count=count, offset=off)
                off += count * dt.itemsize
                cols = [p[1] for p in props]
                rows = np.stack(
                    [arr[c].astype(np.float64) for c in cols], axis=-1
                )
                verts, normals, uvs, vcolors = _extract_vertex_data(rows, cols)
            elif name == "face":
                lp = props[0]
                cnt_fmt, cnt_sz = _PLY_TYPES[lp[1]]
                idx_fmt, idx_sz = _PLY_TYPES[lp[2]]
                # fast path: all faces are triangles (the common export case)
                tri_stride = cnt_sz + 3 * idx_sz
                if off + count * tri_stride <= len(body):
                    dt = np.dtype(
                        [("k", "<" + cnt_fmt), ("idx", "<" + idx_fmt, (3,))]
                    )
                    probe = np.frombuffer(body, dtype=dt, count=count, offset=off)
                    if (probe["k"] == 3).all():
                        faces = probe["idx"].astype(np.int32).reshape(-1, 3)
                        off += count * tri_stride
                        probe = None
                    else:
                        probe = None
                if isinstance(faces, list):
                    for _ in range(count):
                        (k,) = struct.unpack_from("<" + cnt_fmt, body, off)
                        off += cnt_sz
                        idx = struct.unpack_from("<" + idx_fmt * k, body, off)
                        off += idx_sz * k
                        for j in range(1, k - 1):
                            faces.append((idx[0], idx[j], idx[j + 1]))
            else:
                # skip fixed-size elements
                fmt_str = "<" + "".join(_PLY_TYPES[p[0]][0] for p in props)
                off += count * struct.calcsize(fmt_str)

    return HostMesh(
        vertices=np.asarray(verts, np.float32),
        faces=np.asarray(faces, np.int32).reshape(-1, 3),
        normals=None if normals is None else np.asarray(normals, np.float32),
        uvs=None if uvs is None else np.asarray(uvs, np.float32),
        colors=None if vcolors is None else np.asarray(vcolors, np.float32),
    )


def _extract_vertex_data(rows, cols):
    def col(name):
        return rows[:, cols.index(name)] if name in cols else None

    verts = np.stack([col("x"), col("y"), col("z")], -1)
    normals = None
    if "nx" in cols:
        normals = np.stack([col("nx"), col("ny"), col("nz")], -1)
    uvs = None
    for uname, vname in (("u", "v"), ("s", "t"), ("texture_u", "texture_v")):
        if uname in cols:
            uvs = np.stack([col(uname), col(vname)], -1)
            break
    colors = None
    if "red" in cols:
        colors = np.stack([col("red"), col("green"), col("blue")], -1)
        if colors.max() > 1.0:  # 8-bit colors
            colors = colors / 255.0
    return verts, normals, uvs, colors


def load_obj(path: str) -> HostMesh:
    verts, norms, uvs = [], [], []
    fv, fn, ft = [], [], []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                verts.append(tuple(map(float, tok[1:4])))
            elif tok[0] == "vn":
                norms.append(tuple(map(float, tok[1:4])))
            elif tok[0] == "vt":
                uvs.append(tuple(map(float, tok[1:3])))
            elif tok[0] == "f":
                idx = []
                for t in tok[1:]:
                    parts = t.split("/")
                    vi = int(parts[0])
                    ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
                    ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
                    idx.append((vi, ti, ni))
                for j in range(1, len(idx) - 1):
                    for vi, ti, ni in (idx[0], idx[j], idx[j + 1]):
                        fv.append(vi - 1 if vi > 0 else len(verts) + vi)
                        ft.append(ti - 1 if ti > 0 else -1)
                        fn.append(ni - 1 if ni > 0 else -1)

    v = np.asarray(verts, np.float32)
    faces = np.asarray(fv, np.int32).reshape(-1, 3)
    mesh_normals = None
    mesh_uvs = None
    # OBJ may index normals/uvs separately — rebuild per-corner then average
    if norms and all(n >= 0 for n in fn):
        ncorner = np.asarray(norms, np.float32)[np.asarray(fn).reshape(-1, 3)]
        acc = np.zeros_like(v)
        np.add.at(acc, faces.ravel(), ncorner.reshape(-1, 3))
        ln = np.linalg.norm(acc, axis=-1, keepdims=True)
        mesh_normals = acc / np.maximum(ln, 1e-20)
    if uvs and all(t >= 0 for t in ft):
        ucorner = np.asarray(uvs, np.float32)[np.asarray(ft).reshape(-1, 3)]
        mesh_uvs = np.zeros((len(v), 2), np.float32)
        mesh_uvs[faces.ravel()] = ucorner.reshape(-1, 2)
    return HostMesh(vertices=v, faces=faces, normals=mesh_normals, uvs=mesh_uvs)


# ---------------------------------------------------------------------------
# analytic-shape tessellation
# ---------------------------------------------------------------------------

def make_rectangle() -> HostMesh:
    """Unit rectangle on the xy-plane, z=0, spanning [-1,1]^2 (Mitsuba's)."""
    v = np.array(
        [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32
    )
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    n = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return HostMesh(vertices=v, faces=f, normals=n, uvs=uv)


def make_cube() -> HostMesh:
    """Mitsuba cube: [-1,1]^3."""
    corners = np.array(
        [
            [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
            [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
        ],
        np.float32,
    )
    quads = [
        (0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4),
        (2, 3, 7, 6), (1, 2, 6, 5), (0, 4, 7, 3),
    ]
    verts, faces = [], []
    for q in quads:
        b = len(verts)
        for i in q:
            verts.append(corners[i])
        faces += [[b, b + 1, b + 2], [b, b + 2, b + 3]]
    return HostMesh(
        vertices=np.asarray(verts, np.float32),
        faces=np.asarray(faces, np.int32),
        face_normals=True,
    )


def make_sphere(subdiv: int = 4) -> HostMesh:
    """Unit icosphere (smooth normals = exact sphere normals at vertices)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    f = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdiv):
        edge_mid = {}
        verts = list(map(tuple, v))

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                mid = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2
                mid = mid / np.linalg.norm(mid)
                verts.append(tuple(mid))
                edge_mid[key] = len(verts) - 1
            return edge_mid[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(verts)
        f = np.asarray(nf, np.int64)

    v = v.astype(np.float32)
    return HostMesh(
        vertices=v, faces=f.astype(np.int32), normals=v.copy()
    )


def make_disk(segments: int = 64) -> HostMesh:
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    rim = np.stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)], -1)
    v = np.concatenate([[[0.0, 0.0, 0.0]], rim]).astype(np.float32)
    f = np.array(
        [[0, 1 + i, 1 + ((i + 1) % segments)] for i in range(segments)], np.int32
    )
    n = np.tile(np.array([[0, 0, 1]], np.float32), (len(v), 1))
    return HostMesh(vertices=v, faces=f, normals=n)


def make_cylinder(n_seg: int = 64):
    """Tessellated open cylinder along +z, radius 1, length 1 (fallback for
    non-uniformly scaled cylinder shapes; the analytic path handles the
    uniform case exactly — reference src/shapes/cylinder.cpp)."""
    import numpy as np

    ang = np.arange(n_seg) / n_seg * 2.0 * np.pi
    ring = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    v0 = np.concatenate([ring, np.zeros((n_seg, 1))], axis=-1)
    v1 = np.concatenate([ring, np.ones((n_seg, 1))], axis=-1)
    verts = np.concatenate([v0, v1], axis=0).astype(np.float32)
    faces = []
    for i in range(n_seg):
        j = (i + 1) % n_seg
        faces.append([i, j, n_seg + i])
        faces.append([j, n_seg + j, n_seg + i])
    nrm = np.concatenate([ring, np.zeros((n_seg, 1))], axis=-1)
    normals = np.concatenate([nrm, nrm], axis=0).astype(np.float32)
    uv = np.stack(
        [np.concatenate([ang, ang]) / (2.0 * np.pi),
         np.concatenate([np.zeros(n_seg), np.ones(n_seg)])], axis=-1
    ).astype(np.float32)
    return HostMesh(
        vertices=verts, faces=np.asarray(faces, np.int32), normals=normals,
        uvs=uv,
    )


def load_serialized(path: str, shape_index: int = 0) -> HostMesh:
    """Mitsuba .serialized mesh loader (reference src/shapes/serialized.cpp:
    0x041C header, zlib-compressed per-mesh streams, trailing offset table).
    Supports format versions 3 and 4, single/double precision, normals and
    texcoords (colors skipped)."""
    import struct
    import zlib

    with open(path, "rb") as f:
        raw = f.read()
    fmt, version = struct.unpack_from("<hh", raw, 0)
    if fmt != 0x041C:
        raise ValueError(f"{path}: not a .serialized mesh (format {fmt:#x})")
    if version not in (3, 4):
        raise ValueError(f"{path}: unsupported .serialized version {version}")

    start = 4
    if shape_index != 0:
        (count,) = struct.unpack_from("<I", raw, len(raw) - 4)
        if shape_index >= count:
            raise ValueError(f"shape_index {shape_index} out of range 0..{count-1}")
        if version == 4:
            off_pos = len(raw) - 8 * (count - shape_index) - 4
            (offset,) = struct.unpack_from("<Q", raw, off_pos)
        else:
            off_pos = len(raw) - 4 * (count - shape_index + 1)
            (offset,) = struct.unpack_from("<I", raw, off_pos)
        start = offset + 4  # skip the per-mesh copy of the header

    data = zlib.decompress(raw[start:])
    pos = 0
    (flags,) = struct.unpack_from("<I", data, pos)
    pos += 4
    if version == 4:
        end = data.index(b"\x00", pos)
        pos = end + 1
    v_count, f_count = struct.unpack_from("<QQ", data, pos)
    pos += 16

    double_precision = bool(flags & 0x2000)
    has_normals = bool(flags & 0x0001)
    has_texcoords = bool(flags & 0x0002)
    has_colors = bool(flags & 0x0008)
    face_normals = bool(flags & 0x0010)
    ftype = np.float64 if double_precision else np.float32
    fsize = 8 if double_precision else 4

    def read_f(n):
        nonlocal pos
        arr = np.frombuffer(data, ftype, n, pos)
        pos += n * fsize
        return arr.astype(np.float32)

    verts = read_f(v_count * 3).reshape(-1, 3)
    normals = None
    if has_normals:
        normals = read_f(v_count * 3).reshape(-1, 3)
    uvs = None
    if has_texcoords:
        uvs = read_f(v_count * 2).reshape(-1, 2)
    if has_colors:
        read_f(v_count * 3)
    faces = np.frombuffer(data, np.uint32, f_count * 3, pos).astype(
        np.int32
    ).reshape(-1, 3)
    return HostMesh(
        vertices=verts, faces=faces, normals=normals, uvs=uvs,
        face_normals=face_normals,
    )


def save_serialized(path: str, mesh: HostMesh):
    """Write a single-mesh v3 .serialized file (tests + tooling)."""
    import struct
    import zlib

    flags = 0x1000  # single precision
    if mesh.normals is not None:
        flags |= 0x0001
    if mesh.uvs is not None:
        flags |= 0x0002
    if mesh.face_normals:
        flags |= 0x0010
    body = struct.pack("<I", flags)
    body += struct.pack("<QQ", len(mesh.vertices), len(mesh.faces))
    body += np.asarray(mesh.vertices, np.float32).tobytes()
    if mesh.normals is not None:
        body += np.asarray(mesh.normals, np.float32).tobytes()
    if mesh.uvs is not None:
        body += np.asarray(mesh.uvs, np.float32).tobytes()
    body += np.asarray(mesh.faces, np.uint32).tobytes()
    out = struct.pack("<hh", 0x041C, 3) + zlib.compress(body)
    out += struct.pack("<I", 0)       # offset of mesh 0
    out += struct.pack("<I", 1)       # mesh count
    with open(path, "wb") as f:
        f.write(out)


def load_curves(path: str):
    """Parse a Mitsuba curves .txt file (reference src/shapes/
    bsplinecurve.cpp:82-95: one 'x y z radius' control point per line,
    blank lines separate curves). Returns list of [K, 4] arrays."""
    curves = []
    cur = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                if cur:
                    curves.append(np.asarray(cur, np.float32))
                    cur = []
                continue
            parts = line.split()
            cur.append([float(parts[0]), float(parts[1]), float(parts[2]),
                        float(parts[3]) if len(parts) > 3 else 0.01])
    if cur:
        curves.append(np.asarray(cur, np.float32))
    return curves


def _bspline_eval(cp, t):
    """Uniform cubic B-spline point+radius at parameter t in [0, n_spans):
    cp [K, 4] control points; standard basis (bsplinecurve.cpp kernel)."""
    n_spans = len(cp) - 3
    span = np.clip(np.floor(t).astype(int), 0, n_spans - 1)
    u = t - span
    b0 = (1 - u) ** 3 / 6.0
    b1 = (3 * u ** 3 - 6 * u ** 2 + 4) / 6.0
    b2 = (-3 * u ** 3 + 3 * u ** 2 + 3 * u + 1) / 6.0
    b3 = u ** 3 / 6.0
    return (
        cp[span] * b0[..., None] + cp[span + 1] * b1[..., None]
        + cp[span + 2] * b2[..., None] + cp[span + 3] * b3[..., None]
    )


def tessellate_curve(cp, bspline=True, seg_per_span=8, n_phi=8):
    """Sweep a circular cross-section along one curve -> HostMesh tube.

    Stance: the reference ray-traces curve primitives
    analytically on the GPU (bsplinecurve.cpp / linearcurve.cpp +
    optix); here curves tessellate at load time into the same flat
    triangle soup every other shape uses — one BVH, no per-type
    traversal branches. seg_per_span/n_phi control the fidelity."""
    cp = np.asarray(cp, np.float32)
    if bspline and len(cp) >= 4:
        n_spans = len(cp) - 3
        t = np.linspace(0, n_spans - 1e-4, n_spans * seg_per_span + 1)
        pts = _bspline_eval(cp, t)
    else:
        # linear: interpolate straight segments (linearcurve.cpp)
        k = len(cp)
        t = np.linspace(0, k - 1 - 1e-4, (k - 1) * seg_per_span + 1)
        i = np.clip(np.floor(t).astype(int), 0, k - 2)
        u = (t - i)[..., None]
        pts = cp[i] * (1 - u) + cp[i + 1] * u

    centers = pts[:, :3]
    radii = np.maximum(pts[:, 3], 1e-5)
    # parallel-transported frames along the curve
    tangents = np.gradient(centers, axis=0)
    tangents /= np.maximum(
        np.linalg.norm(tangents, axis=-1, keepdims=True), 1e-9
    )
    normal = np.array([1.0, 0.0, 0.0])
    if abs(np.dot(normal, tangents[0])) > 0.9:
        normal = np.array([0.0, 1.0, 0.0])
    frames = []
    for tg in tangents:
        normal = normal - tg * np.dot(normal, tg)
        nn = np.linalg.norm(normal)
        if nn < 1e-6:
            normal = np.array([1.0, 0.0, 0.0])
            normal = normal - tg * np.dot(normal, tg)
            nn = np.linalg.norm(normal)
        normal = normal / nn
        frames.append((normal.copy(), np.cross(tg, normal)))

    ang = np.arange(n_phi) / n_phi * 2 * np.pi
    ca, sa = np.cos(ang), np.sin(ang)
    verts = []
    norms = []
    tangs = []
    for c, r, tg, (nv, bv) in zip(centers, radii, tangents, frames):
        ring_n = nv[None, :] * ca[:, None] + bv[None, :] * sa[:, None]
        verts.append(c[None, :] + ring_n * r)
        norms.append(ring_n)
        tangs.append(np.tile(tg[None, :], (len(ca), 1)))
    verts = np.concatenate(verts, 0).astype(np.float32)
    norms = np.concatenate(norms, 0).astype(np.float32)
    tangs = np.concatenate(tangs, 0).astype(np.float32)

    faces = []
    n_rings = len(centers)
    for i in range(n_rings - 1):
        for j in range(n_phi):
            j2 = (j + 1) % n_phi
            a = i * n_phi + j
            b = i * n_phi + j2
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + j2
            faces.append([a, b, c])
            faces.append([b, d, c])
    uv = np.stack(
        [np.tile(ang / (2 * np.pi), n_rings),
         np.repeat(np.linspace(0, 1, n_rings), n_phi)], axis=-1
    ).astype(np.float32)
    return HostMesh(
        vertices=verts, faces=np.asarray(faces, np.int32), normals=norms,
        uvs=uv, tangents=tangs,
    )


def load_curve_mesh(path: str, bspline=True, seg_per_span=8, n_phi=8):
    """All curves in a file merged into one HostMesh."""
    parts = [
        tessellate_curve(cp, bspline=bspline, seg_per_span=seg_per_span,
                         n_phi=n_phi)
        for cp in load_curves(path)
        if len(cp) >= (4 if bspline else 2)
    ]
    if not parts:
        raise ValueError(f"{path}: no usable curves")
    v_off = 0
    verts, faces, norms, uvs, tangs = [], [], [], [], []
    for pm in parts:
        verts.append(pm.vertices)
        faces.append(pm.faces + v_off)
        norms.append(pm.normals)
        uvs.append(pm.uvs)
        tangs.append(pm.tangents)
        v_off += len(pm.vertices)
    return HostMesh(
        vertices=np.concatenate(verts, 0),
        faces=np.concatenate(faces, 0),
        normals=np.concatenate(norms, 0),
        uvs=np.concatenate(uvs, 0),
        tangents=np.concatenate(tangs, 0),
    )
