"""Built-in test scenes constructed in code (no asset files needed).

`cornell_box()` mirrors the canonical Mitsuba 3 `mi.cornell_box()` scene dict
(reference: src/python/python/util.py cornell_box — same geometry/eta/albedos
as the classic Cornell data), used by the benchmark harness, golden tests and
BASELINE configs. `grating_scene()` is a roughgrating slab lit by a
directional emitter — the minimal PLT showcase (analog of the fork's
gratings.xml experiment scene).
"""
from __future__ import annotations

import os

import numpy as np

from ..core import transform as tf
from ..librender.sensor import Sensor
from .loader import LoadedBSDF, assemble_scene
from .shape import HostMesh, make_rectangle, make_cube, make_sphere
from ..librender.bsdf import (
    BSDF_DIFFUSE,
    BSDF_CONDUCTOR,
    BSDF_ROUGH_CONDUCTOR,
    BSDF_DIELECTRIC,
    BSDF_ROUGH_GRATING,
)


# XML stand-in for Mitsuba 3's cbox.xml (see the file's header), loaded
# through mi.load_file like any scene file.
CBOX_STANDIN_XML = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "scenes", "cbox_standin", "cbox.xml"
))


def _rect(to_world: np.ndarray) -> HostMesh:
    return make_rectangle().transformed(np.asarray(to_world, np.float32))


def cornell_box(width: int = 256, height: int = 256, *, light_scale: float = 1.0,
                box_material: str = "diffuse"):
    """The canonical Cornell box (white walls, red/green sides, area light).

    box_material: material for the two interior boxes — "diffuse",
    "conductor", "roughconductor", "dielectric" or "grating" (PLT showcase).
    Returns (scene, meta) like load_file.
    """
    white = (0.885809, 0.698859, 0.666422)
    green = (0.105421, 0.37798, 0.076425)
    red = (0.570068, 0.0430135, 0.0443706)
    light_rad = tuple(light_scale * c for c in (18.387, 13.9873, 6.75357))

    bsdf_white = LoadedBSDF(BSDF_DIFFUSE, base_color=white)
    bsdf_green = LoadedBSDF(BSDF_DIFFUSE, base_color=green)
    bsdf_red = LoadedBSDF(BSDF_DIFFUSE, base_color=red)
    if box_material == "conductor":
        bsdf_box = LoadedBSDF(
            BSDF_CONDUCTOR, eta_re=(0.2, 0.92, 1.1), eta_im=(3.9, 2.45, 2.14)
        )
    elif box_material == "roughconductor":
        bsdf_box = LoadedBSDF(
            BSDF_ROUGH_CONDUCTOR, eta_re=(0.2, 0.92, 1.1),
            eta_im=(3.9, 2.45, 2.14), alpha=(0.1, 0.1),
        )
    elif box_material == "dielectric":
        bsdf_box = LoadedBSDF(BSDF_DIELECTRIC, eta_re=(1.5046,) * 3)
    elif box_material == "grating":
        bsdf_box = LoadedBSDF(
            BSDF_ROUGH_GRATING, eta_re=(0.2, 0.92, 1.1),
            eta_im=(3.9, 2.45, 2.14), alpha=(0.05, 0.05),
            grt_inv_period=(0.5, 0.0), grt_height=0.25, grt_lobes=5,
            grt_type=0, grt_multiplier=1.0, grt_coherence=1.0,
        )
    else:
        bsdf_box = LoadedBSDF(BSDF_DIFFUSE, base_color=white)

    bsdfs = [bsdf_white, bsdf_green, bsdf_red, bsdf_box]
    W, G, R, BOX = 0, 1, 2, 3

    T = tf.translate
    Rt = tf.rotate
    S = tf.scale

    def compose(*ms):
        out = np.eye(4, dtype=np.float64)
        for mm in ms:
            out = out @ np.asarray(mm, np.float64)
        return out

    meshes, mats, ems = [], [], []

    def add(mesh, mat, em=-1):
        meshes.append(mesh)
        mats.append(mat)
        ems.append(em)

    # Walls (unit rects): floor y=-1, ceiling y=1, back z=-1, left x=-1 (red),
    # right x=1 (green) — the mi.cornell_box() layout.
    add(_rect(compose(T([0, -1, 0]), Rt([1, 0, 0], -90))), W)   # floor
    add(_rect(compose(T([0, 1, 0]), Rt([1, 0, 0], 90))), W)     # ceiling
    add(_rect(compose(T([0, 0, -1]))), W)                        # back wall
    add(_rect(compose(T([1, 0, 0]), Rt([0, 1, 0], -90))), G)    # right/green
    add(_rect(compose(T([-1, 0, 0]), Rt([0, 1, 0], 90))), R)    # left/red

    # Small box (front right), tall box (back left) — classic proportions.
    small = make_cube().transformed(
        compose(
            T([0.335, -0.7, 0.38]), Rt([0, 1, 0], -17), S([0.25, 0.3, 0.25])
        ).astype(np.float32)
    )
    tall = make_cube().transformed(
        compose(
            T([-0.33, -0.4, -0.28]), Rt([0, 1, 0], 18.25), S([0.25, 0.6, 0.25])
        ).astype(np.float32)
    )
    add(small, BOX)
    add(tall, BOX)

    # Area light: small rect just below the ceiling, facing down.
    light = _rect(
        compose(T([0, 0.99, 0.01]), Rt([1, 0, 0], 90), S([0.23, 0.19, 1.0]))
    )
    emitters = [{"type": "area", "mesh_index": len(meshes), "radiance": light_rad}]
    add(light, W, 0)

    sensor = Sensor.perspective(
        tf.look_at([0, 0, 3.90], [0, 0, 0], [0, 1, 0]), 39.3077, width, height,
    )
    return assemble_scene(
        meshes, mats, ems, bsdfs, emitters, sensor, {"type": "path"}, 16
    )


def grating_scene(width: int = 256, height: int = 256, *,
                  inv_period=(0.6, 0.0), lobes: int = 7, height_um: float = 0.04,
                  alpha: float = 0.04, radial: bool = False, grt_type: int = 0,
                  coherence: float = 6e5, multiplier: float = 10.0,
                  light_angle_deg: float = -15.0):
    """A rough diffraction-grating slab on a dark floor, directional light.

    The minimal wave-optics showcase (grating parameters follow the
    reference's scenes/gratings/gratings.xml: sinusoidal, height 0.04 um,
    inv_period 0.6/um, 7 lobes, alpha 0.04, multiplier 10, coherence 6e5).
    The camera sits near the specular direction in the plane of incidence so
    the diffraction orders sweep across the view.
    """
    bsdfs = [
        LoadedBSDF(BSDF_DIFFUSE, base_color=(0.1, 0.1, 0.1)),
        LoadedBSDF(
            BSDF_ROUGH_GRATING, eta_re=(0.2, 0.92, 1.1),
            eta_im=(3.9, 2.45, 2.14), alpha=(alpha, alpha),
            grt_inv_period=tuple(inv_period), grt_height=height_um,
            grt_lobes=lobes, grt_type=grt_type + (16 if radial else 0),
            grt_multiplier=multiplier, grt_coherence=coherence,
        ),
    ]
    meshes, mats, ems = [], [], []
    floor = make_rectangle().transformed(
        (tf.translate([0, -0.501, 0]) @ tf.rotate([1, 0, 0], -90)
         @ tf.scale([4, 4, 1])).astype(np.float32)
    )
    slab = make_rectangle().transformed(
        (tf.translate([0, -0.5, 0]) @ tf.rotate([1, 0, 0], -90)).astype(
            np.float32
        )
    )
    meshes += [floor, slab]
    mats += [0, 1]
    ems += [-1, -1]

    th = np.deg2rad(light_angle_deg)
    d = np.array([np.sin(th), -np.cos(th), 0.0])  # light propagation dir
    emitters = [
        {"type": "directional", "direction": tuple(d), "radiance": (4.0, 4.0, 4.0)},
        {"type": "constant", "radiance": (0.01, 0.01, 0.01)},
    ]
    # camera on the specular side, in the plane of incidence (x-y)
    spec = np.array([-np.sin(th), np.cos(th), 0.0])
    cam_pos = np.array([0.0, -0.5, 0.0]) + 2.2 * spec + np.array([0, 0, 0.35])
    sensor = Sensor.perspective(
        tf.look_at(cam_pos, [0, -0.5, 0], [0, 1, 0]), 45.0, width, height,
    )
    return assemble_scene(
        meshes, mats, ems, bsdfs, emitters, sensor,
        {"type": "plt"}, 16,
    )


def furnace_scene(width: int = 64, height: int = 64, albedo: float = 0.75,
                  radiance: float = 1.0, material: str = "diffuse"):
    """White-furnace: a sphere inside a constant environment. Analytic answer
    for a diffuse sphere: L = radiance / (1 - albedo)."""
    if material == "diffuse":
        b = LoadedBSDF(BSDF_DIFFUSE, base_color=(albedo,) * 3)
    elif material == "conductor":
        b = LoadedBSDF(BSDF_CONDUCTOR, eta_re=(0.2,) * 3, eta_im=(3.9,) * 3)
    else:
        b = LoadedBSDF(BSDF_ROUGH_CONDUCTOR, eta_re=(0.2,) * 3,
                       eta_im=(3.9,) * 3, alpha=(0.3, 0.3))
    sphere = make_sphere(3)
    emitters = [{"type": "constant", "radiance": (radiance,) * 3}]
    sensor = Sensor.perspective(
        tf.look_at([0, 0, 4], [0, 0, 0], [0, 1, 0]), 45.0, width, height,
    )
    return assemble_scene(
        [sphere], [0], [-1], [b], emitters, sensor, {"type": "path"}, 16
    )
