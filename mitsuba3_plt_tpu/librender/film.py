"""Film / ImageBlock: deterministic scatter-add sample accumulation + develop.

Functional twin of ImageBlock::put + Film::develop (reference
src/render/imageblock.cpp:119-430, include/mitsuba/render/film.h). Instead of
atomic scatter_reduce we use jnp scatter-add into a
flat [H*W, C+1] buffer whose last channel is the filter weight.

Reconstruction filters: box (single-pixel) and gaussian (3x3 taps with
Mitsuba's truncated-gaussian radius-2 default).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

FILTER_BOX = 0
FILTER_GAUSSIAN = 1
FILTER_TENT = 2
FILTER_MITCHELL = 3
FILTER_CATMULLROM = 4
FILTER_LANCZOS = 5

FILTER_RADIUS = {
    FILTER_BOX: 1,
    FILTER_GAUSSIAN: 2,
    FILTER_TENT: 1,
    FILTER_MITCHELL: 2,
    FILTER_CATMULLROM: 2,
    FILTER_LANCZOS: 3,
}

FILTER_NAMES = {
    "box": FILTER_BOX, "gaussian": FILTER_GAUSSIAN, "tent": FILTER_TENT,
    "mitchell": FILTER_MITCHELL, "catmullrom": FILTER_CATMULLROM,
    "lanczos": FILTER_LANCZOS,
}


def _mitchell_1d(x, B, C):
    x = jnp.abs(x)
    x2 = x * x
    x3 = x2 * x
    inner = (
        (12 - 9 * B - 6 * C) * x3 + (-18 + 12 * B + 6 * C) * x2 + (6 - 2 * B)
    ) * (1.0 / 6.0)
    outer = (
        (-B - 6 * C) * x3 + (6 * B + 30 * C) * x2 + (-12 * B - 48 * C) * x
        + (8 * B + 24 * C)
    ) * (1.0 / 6.0)
    return jnp.where(x < 1.0, inner, jnp.where(x < 2.0, outer, 0.0))


def filter_eval(rfilter: int, x):
    """1D reconstruction filter value at offset x (pixels)."""
    if rfilter == FILTER_GAUSSIAN:
        sigma2 = 1.0  # radius/2 with radius 2
        v = jnp.exp(-0.5 * x * x / sigma2) - jnp.exp(-2.0 / sigma2)
        return jnp.maximum(v, 0.0)
    if rfilter == FILTER_TENT:
        return jnp.maximum(1.0 - jnp.abs(x), 0.0)
    if rfilter == FILTER_MITCHELL:
        return _mitchell_1d(x, 1.0 / 3.0, 1.0 / 3.0)
    if rfilter == FILTER_CATMULLROM:
        return _mitchell_1d(x, 0.0, 0.5)
    if rfilter == FILTER_LANCZOS:
        ax = jnp.abs(x)
        pix = jnp.pi * jnp.where(ax > 1e-6, x, 1.0)
        sinc = jnp.where(ax > 1e-6, jnp.sin(pix) / pix, 1.0)
        pix3 = pix / 3.0
        sinc3 = jnp.where(ax > 1e-6, jnp.sin(pix3) / pix3, 1.0)
        return jnp.where(ax < 3.0, sinc * sinc3, 0.0)
    return jnp.where(jnp.abs(x) <= 0.5, 1.0, 0.0)  # box


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ImageBlock:
    data: Any  # [H*W, C+1] accumulated (filter-weighted) values + weight
    width: int = dataclasses.field(metadata=dict(static=True))
    height: int = dataclasses.field(metadata=dict(static=True))
    n_channels: int = dataclasses.field(metadata=dict(static=True))
    rfilter: int = dataclasses.field(default=FILTER_BOX, metadata=dict(static=True))

    @staticmethod
    def create(width, height, n_channels, rfilter=FILTER_BOX):
        return ImageBlock(
            data=jnp.zeros((width * height, n_channels + 1), jnp.float32),
            width=width,
            height=height,
            n_channels=n_channels,
            rfilter=rfilter,
        )

    def put(self, pos_uv, values, active=None):
        """Splat values [N, C] at film positions pos_uv [N, 2] in [0,1]^2."""
        w, h = self.width, self.height
        n = values.shape[0]
        if active is None:
            active = jnp.ones((n,), bool)
        # guard NaNs/Infs like the reference's compensating accumulation
        finite = jnp.all(jnp.isfinite(values), axis=-1)
        active = active & finite
        vals = jnp.where(active[..., None], values, 0.0)

        px = pos_uv[..., 0] * w - 0.5  # continuous pixel coords (center at .0)
        py = pos_uv[..., 1] * h - 0.5

        payload = jnp.concatenate(
            [vals, active.astype(jnp.float32)[..., None]], axis=-1
        )

        if self.rfilter == FILTER_BOX:
            ix = jnp.clip(jnp.round(px).astype(jnp.int32), 0, w - 1)
            iy = jnp.clip(jnp.round(py).astype(jnp.int32), 0, h - 1)
            flat = iy * w + ix
            data = self.data.at[flat].add(payload, mode="drop")
            return dataclasses.replace(self, data=data)

        return self._put_splat(px, py, payload, active)

    def put_ordered(self, values, active, spp: int):
        """Box-filter accumulation for pixel-ordered wavefronts.

        When lane i belongs to pixel i // spp (the sample_rays layout) and
        the reconstruction filter is a box, the film 'splat' is a plain
        segment sum — a reshape+reduce instead of a scatter-add
        (ImageBlock::put scatter_reduce role, reference
        src/render/imageblock.cpp:119-126)."""
        assert self.rfilter == FILTER_BOX
        n = values.shape[0]
        if active is None:
            active = jnp.ones((n,), bool)
        finite = jnp.all(jnp.isfinite(values), axis=-1)
        active = active & finite
        vals = jnp.where(active[..., None], values, 0.0)
        payload = jnp.concatenate(
            [vals, active.astype(jnp.float32)[..., None]], axis=-1
        )
        add = payload.reshape(self.width * self.height, spp, -1).sum(axis=1)
        return dataclasses.replace(self, data=self.data + add)

    def put_ordered_filtered(self, pos_uv, values, active, spp: int):
        """Filtered accumulation for pixel-ordered wavefronts, scatter-free.

        Per filter tap (dx, dy) in the (2r+1)^2 neighborhood: weight each
        lane by f(dx - jx) f(dy - jy) (j = subpixel offset within the lane's
        own pixel), segment-sum to a per-pixel image, then shift-add that
        image by the tap offset (out-of-bounds contributions drop, like the
        scatter path's mode='drop'). (2r+1)^2 reshape-reduces replace
        (2r)^2 scatter-adds."""
        w, h = self.width, self.height
        n = values.shape[0]
        if active is None:
            active = jnp.ones((n,), bool)
        finite = jnp.all(jnp.isfinite(values), axis=-1)
        active = active & finite
        vals = jnp.where(active[..., None], values, 0.0)
        payload = jnp.concatenate(
            [vals, active.astype(jnp.float32)[..., None]], axis=-1
        )
        # subpixel offset relative to the lane's own pixel center
        px = pos_uv[..., 0] * w - 0.5
        py = pos_uv[..., 1] * h - 0.5
        lane = jnp.arange(n) // spp
        jx = px - (lane % w).astype(jnp.float32)
        jy = py - (lane // w).astype(jnp.float32)

        radius = FILTER_RADIUS[self.rfilter]
        C1 = payload.shape[-1]
        if C1 > 8:
            # wide-payload films (stokes AOVs, spectral bands): the
            # channel-major transposes + [C1, spp, H, W] working set cost
            # more than they save here; the tap loop stays transpose-free
            img = self.data.reshape(h, w, -1)
            acc = jnp.zeros_like(img)
            for dy in range(-radius, radius + 1):
                wy = filter_eval(self.rfilter, dy - jy)
                for dx in range(-radius, radius + 1):
                    wgt = filter_eval(self.rfilter, dx - jx) * wy
                    tap = (payload * wgt[..., None]).reshape(
                        h * w, spp, -1
                    ).sum(axis=1).reshape(h, w, -1)
                    ys = slice(max(dy, 0), h + min(dy, 0))
                    yd = slice(max(-dy, 0), h + min(-dy, 0))
                    xs = slice(max(dx, 0), w + min(dx, 0))
                    xd = slice(max(-dx, 0), w + min(-dx, 0))
                    acc = acc.at[ys, xs].add(tap[yd, xd])
            return dataclasses.replace(
                self, data=(img + acc).reshape(h * w, -1)
            )
        # channel-major [C1, spp, h, w] working layout: the per-tap
        # weighted reduce then runs with W in the minor dimension instead
        # of the narrow C1 (<= 8). Two transposes at the boundaries.
        pay_t = payload.reshape(h, w, spp, C1).transpose(3, 2, 0, 1)
        jx_t = jx.reshape(h, w, spp).transpose(2, 0, 1)   # [spp, h, w]
        jy_t = jy.reshape(h, w, spp).transpose(2, 0, 1)
        # separable taps: 2r+1 evals per axis instead of (2r+1)^2
        wxs = [
            filter_eval(self.rfilter, dx - jx_t)
            for dx in range(-radius, radius + 1)
        ]
        wys = [
            filter_eval(self.rfilter, dy - jy_t)
            for dy in range(-radius, radius + 1)
        ]
        img_t = self.data.reshape(h, w, C1).transpose(2, 0, 1)
        acc = jnp.zeros_like(img_t)
        for iy, dy in enumerate(range(-radius, radius + 1)):
            for ix, dx in enumerate(range(-radius, radius + 1)):
                wgt = wxs[ix] * wys[iy]                   # [spp, h, w]
                tap = (pay_t * wgt[None]).sum(axis=1)     # [C1, h, w]
                # contribution of pixel p lands at p + (dx, dy)
                ys = slice(max(dy, 0), h + min(dy, 0))
                yd = slice(max(-dy, 0), h + min(-dy, 0))
                xs = slice(max(dx, 0), w + min(dx, 0))
                xd = slice(max(-dx, 0), w + min(-dx, 0))
                acc = acc.at[:, ys, xs].add(tap[:, yd, xd])
        return dataclasses.replace(
            self,
            data=(img_t + acc).transpose(1, 2, 0).reshape(h * w, C1),
        )

    def _put_splat(self, px, py, payload, active):
        w, h = self.width, self.height

        # separable splat over a (2*radius)^2 neighborhood; weight channel
        # normalizes (reference rfilters: src/rfilters/{tent,gaussian,
        # mitchell,catmullrom,lanczos}.cpp)
        radius = FILTER_RADIUS[self.rfilter]
        base_x = jnp.floor(px).astype(jnp.int32)
        base_y = jnp.floor(py).astype(jnp.int32)
        data = self.data
        for dy in range(-radius + 1, radius + 1):
            for dx in range(-radius + 1, radius + 1):
                ix = base_x + dx
                iy = base_y + dy
                fx = ix.astype(jnp.float32) - px
                fy = iy.astype(jnp.float32) - py
                wgt = filter_eval(self.rfilter, fx) * filter_eval(
                    self.rfilter, fy
                )
                inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
                wgt = jnp.where(inb & active, wgt, 0.0)
                flat = jnp.clip(iy, 0, h - 1) * w + jnp.clip(ix, 0, w - 1)
                data = data.at[flat].add(payload * wgt[..., None], mode="drop")
        return dataclasses.replace(self, data=data)

    def develop(self):
        """-> [H, W, C] image: value / weight."""
        wsum = self.data[..., -1:]
        img = self.data[..., :-1] / jnp.maximum(wsum, 1e-8)
        return img.reshape(self.height, self.width, self.n_channels)

    def merge(self, other: "ImageBlock") -> "ImageBlock":
        return dataclasses.replace(self, data=self.data + other.data)
