"""Sensors: perspective / orthographic / thinlens / batch, with optional
spectral response (srf) hooks.

Functional twin of src/sensors/*.cpp + src/render/sensor.cpp. A sensor is a
small pytree of parameters; `sample_ray` maps film-plane samples in [0,1]^2
(plus aperture samples) to world-space rays.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..core import frame as fr
from ..core.math import matmul_hi as _mm

SENSOR_PERSPECTIVE = 0
SENSOR_ORTHOGRAPHIC = 1
SENSOR_THINLENS = 2
SENSOR_BATCH = 3
SENSOR_RADIANCEMETER = 4
SENSOR_IRRADIANCEMETER = 5
SENSOR_DISTANT = 6


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Sensor:
    stype: Any            # scalar int32
    to_world: Any         # [4, 4]
    tan_half_x: Any       # scalar: tan(fov_x/2) (perspective/thinlens)
    aspect: Any           # scalar: width/height
    near: Any
    far: Any
    aperture_radius: Any  # thinlens
    focus_distance: Any
    ortho_scale: Any      # [2] orthographic half-extents
    ppo: Any              # [2] principal point offset
    srf: Any = None               # [S, K] per-sub-sensor spectral response
    srf_wavelengths: Any = None   # [K] nm grid for srf

    resolution: tuple = dataclasses.field(default=(256, 256), metadata=dict(static=True))
    stype_static: int = dataclasses.field(default=0, metadata=dict(static=True))

    @staticmethod
    def perspective(to_world, fov_x_deg, width, height, near=1e-2, far=1e4,
                    ppo=(0.0, 0.0)):
        return Sensor(
            stype=jnp.asarray(SENSOR_PERSPECTIVE, jnp.int32),
            to_world=jnp.asarray(to_world, jnp.float32),
            tan_half_x=jnp.asarray(np.tan(np.deg2rad(fov_x_deg) / 2), jnp.float32),
            aspect=jnp.asarray(width / height, jnp.float32),
            near=jnp.asarray(near, jnp.float32),
            far=jnp.asarray(far, jnp.float32),
            aperture_radius=jnp.asarray(0.0, jnp.float32),
            focus_distance=jnp.asarray(1.0, jnp.float32),
            ortho_scale=jnp.ones((2,), jnp.float32),
            ppo=jnp.asarray(ppo, jnp.float32),
            resolution=(width, height),
            stype_static=SENSOR_PERSPECTIVE,
        )

    @staticmethod
    def orthographic(to_world, width, height, scale_x=1.0, scale_y=None,
                     near=1e-2, far=1e4):
        if scale_y is None:
            scale_y = scale_x * height / width
        return Sensor(
            stype=jnp.asarray(SENSOR_ORTHOGRAPHIC, jnp.int32),
            to_world=jnp.asarray(to_world, jnp.float32),
            tan_half_x=jnp.asarray(0.0, jnp.float32),
            aspect=jnp.asarray(width / height, jnp.float32),
            near=jnp.asarray(near, jnp.float32),
            far=jnp.asarray(far, jnp.float32),
            aperture_radius=jnp.asarray(0.0, jnp.float32),
            focus_distance=jnp.asarray(1.0, jnp.float32),
            ortho_scale=jnp.asarray([scale_x, scale_y], jnp.float32),
            ppo=jnp.zeros((2,), jnp.float32),
            resolution=(width, height),
            stype_static=SENSOR_ORTHOGRAPHIC,
        )

    @staticmethod
    def thinlens(to_world, fov_x_deg, width, height, aperture_radius,
                 focus_distance, near=1e-2, far=1e4):
        s = Sensor.perspective(to_world, fov_x_deg, width, height, near, far)
        return dataclasses.replace(
            s,
            stype=jnp.asarray(SENSOR_THINLENS, jnp.int32),
            aperture_radius=jnp.asarray(aperture_radius, jnp.float32),
            focus_distance=jnp.asarray(focus_distance, jnp.float32),
            stype_static=SENSOR_THINLENS,
        )

    @staticmethod
    def radiancemeter(to_world):
        """Single-ray radiance probe along the sensor's +z axis
        (reference src/sensors/radiancemeter.cpp): a 1x1 film whose pixel is
        the radiance arriving at the origin from the viewing direction."""
        s = Sensor.orthographic(to_world, 1, 1, scale_x=0.0, scale_y=0.0)
        return dataclasses.replace(
            s,
            stype=jnp.asarray(SENSOR_RADIANCEMETER, jnp.int32),
            stype_static=SENSOR_RADIANCEMETER,
        )

    @staticmethod
    def irradiancemeter(to_world, scale_x=1.0, scale_y=1.0):
        """Cosine-weighted hemispherical irradiance probe over a surface
        patch (reference src/sensors/irradiancemeter.cpp): rays start on the
        patch with cosine-distributed directions; the developed pixel
        estimates E = integral L cos dw (the pi factor of the cosine pdf is
        folded into sample_ray's uniform weighting)."""
        s = Sensor.orthographic(to_world, 1, 1, scale_x=scale_x,
                                scale_y=scale_y)
        return dataclasses.replace(
            s,
            stype=jnp.asarray(SENSOR_IRRADIANCEMETER, jnp.int32),
            stype_static=SENSOR_IRRADIANCEMETER,
        )

    @staticmethod
    def distant(direction, width=1, height=1, target=(0.0, 0.0, 0.0),
                radius=1.0):
        """Distant directional sensor (reference src/sensors/distant.cpp):
        parallel rays arriving along `direction` over a disk of `radius`
        around `target`."""
        import numpy as _np

        d = _np.asarray(direction, _np.float64)
        d = d / _np.linalg.norm(d)
        from ..core import transform as _tf

        tw = _tf.look_at(
            _np.asarray(target) - d * 1e4, target,
            [0, 1, 0] if abs(d[1]) < 0.9 else [1, 0, 0],
        )
        s = Sensor.orthographic(tw, width, height, scale_x=radius,
                                scale_y=radius)
        return dataclasses.replace(
            s,
            stype=jnp.asarray(SENSOR_DISTANT, jnp.int32),
            stype_static=SENSOR_DISTANT,
        )

    @staticmethod
    def batch_orthographic(to_worlds, sub_width, height, scale_x=1.0,
                           scale_y=None, srf=None, srf_wavelengths=None):
        """Batch of orthographic sub-sensors laid side-by-side in one film
        (reference src/sensors/batch.cpp + per-sensor `srf` property,
        src/render/sensor.cpp:56-118). to_worlds: [S, 4, 4]; film width =
        S * sub_width. srf: optional [S, K] spectral response curves on the
        grid `srf_wavelengths` [K] (nm)."""
        tws = np.asarray(to_worlds, np.float32)
        S = tws.shape[0]
        if scale_y is None:
            scale_y = scale_x * height / sub_width
        s = Sensor.orthographic(
            np.eye(4, dtype=np.float32), S * sub_width, height,
            scale_x=scale_x, scale_y=scale_y,
        )
        return dataclasses.replace(
            s,
            to_world=jnp.asarray(tws),
            stype=jnp.asarray(SENSOR_BATCH, jnp.int32),
            stype_static=SENSOR_BATCH,
            srf=None if srf is None else jnp.asarray(srf, jnp.float32),
            srf_wavelengths=(
                None if srf_wavelengths is None
                else jnp.asarray(srf_wavelengths, jnp.float32)
            ),
            ortho_scale=jnp.asarray([scale_x, scale_y], jnp.float32),
        )

    @property
    def n_sub_sensors(self):
        return self.to_world.shape[0] if self.to_world.ndim == 3 else 1

    def eval_srf(self, sensor_idx, wavelengths):
        """Per-lane SRF weight: sensor_idx [N], wavelengths [N, C] nm ->
        [N, C]. 1 when no srf is attached."""
        if self.srf is None:
            return jnp.ones_like(wavelengths)
        grid = self.srf_wavelengths  # [K]
        K = grid.shape[0]
        t = (wavelengths - grid[0]) / (grid[-1] - grid[0]) * (K - 1)
        i = jnp.clip(jnp.floor(t).astype(jnp.int32), 0, K - 2)
        f = t - i
        curve = self.srf[sensor_idx]  # [N, K]
        v0 = jnp.take_along_axis(curve, i, axis=-1)
        v1 = jnp.take_along_axis(curve, i + 1, axis=-1)
        inside = (wavelengths >= grid[0]) & (wavelengths <= grid[-1])
        return jnp.where(inside, v0 * (1 - f) + v1 * f, 0.0)

    def sample_ray(self, film_uv, aperture_uv=None):
        """film_uv [N,2] in [0,1]^2 -> (o [N,3], d [N,3]) world-space.

        Convention matches the reference perspective projection chain
        (transform.py:perspective_projection): u=0 -> +x (camera 'left'),
        v=0 -> +y (top), camera looks along +z.
        """
        u = film_uv[..., 0]
        v = film_uv[..., 1]

        if self.stype_static == SENSOR_BATCH:
            S = self.to_world.shape[0]
            s_idx = jnp.clip((u * S).astype(jnp.int32), 0, S - 1)
            u_local = u * S - s_idx.astype(jnp.float32)
            Rb = self.to_world[s_idx, :3, :3]   # [N, 3, 3]
            tb = self.to_world[s_idx, :3, 3]
            x = (1.0 - 2.0 * u_local) * self.ortho_scale[0]
            y = (1.0 - 2.0 * v) * self.ortho_scale[1]
            o_cam = jnp.stack([x, y, jnp.zeros_like(x)], axis=-1)
            d_cam = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
            o = jnp.einsum("nij,nj->ni", Rb, o_cam,
                           precision=jax.lax.Precision.HIGHEST) + tb
            d = Rb[..., :, 2]
            return o, fr.normalize(d)

        R = self.to_world[:3, :3]
        t = self.to_world[:3, 3]

        if self.stype_static == SENSOR_RADIANCEMETER:
            o = jnp.broadcast_to(t, (*u.shape, 3))
            d = jnp.broadcast_to(R[:, 2], (*u.shape, 3))
            return o, fr.normalize(d)

        if self.stype_static == SENSOR_IRRADIANCEMETER:
            # origin jittered over the patch, cosine-weighted direction about
            # the patch normal (+z of to_world)
            from ..core import warp as _warp

            x = (1.0 - 2.0 * u) * self.ortho_scale[0]
            y = (1.0 - 2.0 * v) * self.ortho_scale[1]
            o_cam = jnp.stack([x, y, jnp.zeros_like(x)], axis=-1)
            if aperture_uv is None:
                aperture_uv = jnp.stack([u, v], -1)
            d_local = _warp.square_to_cosine_hemisphere(aperture_uv)
            o = _mm(o_cam, R.T) + t
            d = _mm(d_local, R.T)
            return o, fr.normalize(d)

        if self.stype_static in (SENSOR_ORTHOGRAPHIC, SENSOR_DISTANT):
            x = (1.0 - 2.0 * u) * self.ortho_scale[0]
            y = (1.0 - 2.0 * v) * self.ortho_scale[1]
            o_cam = jnp.stack([x, y, jnp.zeros_like(x)], axis=-1)
            d_cam = jnp.broadcast_to(
                jnp.asarray([0.0, 0.0, 1.0], jnp.float32), o_cam.shape
            )
            o = _mm(o_cam, R.T) + t
            d = _mm(d_cam, R.T)
            return o, fr.normalize(d)

        tx = self.tan_half_x
        ty = self.tan_half_x / self.aspect
        x = (1.0 - 2.0 * (u + self.ppo[0])) * tx
        y = (1.0 - 2.0 * (v + self.ppo[1])) * ty
        d_cam = jnp.stack([x, y, jnp.ones_like(x)], axis=-1)

        if self.stype_static == SENSOR_THINLENS and aperture_uv is not None:
            from ..core import warp as _warp

            p_lens = (
                _warp.square_to_uniform_disk_concentric(aperture_uv)
                * self.aperture_radius
            )
            ft = self.focus_distance  # focal plane at z = focus_distance
            p_focus = d_cam * (ft / d_cam[..., 2:3])
            o_cam = jnp.concatenate(
                [p_lens, jnp.zeros_like(p_lens[..., :1])], axis=-1
            )
            d_cam = p_focus - o_cam
            o = _mm(o_cam, R.T) + t
            d = fr.normalize(_mm(d_cam, R.T))
            return o, d

        o = jnp.broadcast_to(t, d_cam.shape)
        d = fr.normalize(_mm(d_cam, R.T))
        return o, d
