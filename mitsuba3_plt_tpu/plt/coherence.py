"""PLT coherence model: wave-packet angular-variance tracking.

Functional twin of the reference's Coherence / GeneralizedRadiance
(include/mitsuba/plt/plt.h:22-171): a pytree of batched arrays; all methods
are pure functions. The diffusivity matrix `dmat` [N, 2, 2] characterizes the
wave distribution function's angular variance around the mean propagation
direction; `opl` [N] is the optical path length travelled from the source in
meters.  inv_coherence_matrix implements Eq. 41 of "A Generalized Ray
formulation for wave optics rendering" (Steinberg et al.).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ..core import math as m

TwoPi = 2.0 * m.Pi


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Coherence:
    """Batched coherence state (reference plt.h:22-129)."""

    dmat: Any  # [N, 2, 2] diffusivity matrix
    opl: Any   # [N] optical path length from source (meters)

    @staticmethod
    def isotropic(diffusivity, opl):
        """Isotropic diffusivity ctor (plt.h:32-37)."""
        d = jnp.asarray(diffusivity, jnp.float32)
        o = jnp.asarray(opl, jnp.float32)
        d, o = jnp.broadcast_arrays(d, o)
        eye = jnp.eye(2, dtype=jnp.float32)
        return Coherence(dmat=d[..., None, None] * eye, opl=o)

    def rmm(self):
        """Distance travelled from the source in millimeters (plt.h:55)."""
        return self.opl * 1e3

    def propagate(self, rd, mask=None):
        """Advance the optical path length by distance rd (plt.h:57-59)."""
        opl = self.opl + rd if mask is None else jnp.where(mask, self.opl + rd, self.opl)
        return dataclasses.replace(self, opl=opl)

    def inv_coherence_matrix(self, k=None):
        """Inverse coherence matrix, optionally wavenumber-scaled
        (plt.h:68-80). k has units 1/um; rmm in mm. k may carry trailing
        batch dims beyond opl's (e.g. a wavelength axis [N, C])."""
        scale = 1.0 / jnp.maximum(self.rmm(), 1e-30)
        dmat = self.dmat
        if k is not None:
            k = jnp.asarray(k)
            extra = k.ndim - scale.ndim
            if extra > 0:
                scale = scale.reshape(scale.shape + (1,) * extra)
                dmat = dmat.reshape(
                    dmat.shape[:-2] + (1,) * extra + dmat.shape[-2:]
                )
            scale = scale * (k / TwoPi)
        return scale[..., None, None] * dmat

    def inv_coherence_det(self, k=None):
        """det of the inverse coherence matrix (plt.h:88-100)."""
        ic = self.inv_coherence_matrix(k)
        return ic[..., 0, 0] * ic[..., 1, 1] - ic[..., 0, 1] * ic[..., 1, 0]

    def transform(self, U, mask=None):
        """Interaction transform dmat <- U^T (dmat U) (plt.h:108-110)."""
        new = jnp.einsum("...ji,...jk,...kl->...il", U, self.dmat, U)
        if mask is not None:
            new = jnp.where(mask[..., None, None], new, self.dmat)
        return dataclasses.replace(self, dmat=new)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GeneralizedRadiance:
    """Generalized Stokes parameters of a wave packet (plt.h:146-171):
    intensity L plus the polarization components L1..L3 (each [N, C]) and
    the packet's coherence state.

    This is the value type flowing out of the polarized PLT transport: the
    emissive replay pushes the sourced beam's (unpolarized) Stokes vector
    through the world-basis Mueller prefix chain and wraps the result +
    beam coherence here, and measure() consumes it
    (integrators/plt.py _emissive_term)."""

    L: Any
    L1: Any
    L2: Any
    L3: Any
    coherence: Coherence

    @staticmethod
    def from_value(L):
        z = jnp.zeros_like(L)
        n = L.shape[0]
        return GeneralizedRadiance(
            L=L, L1=z, L2=z, L3=z,
            coherence=Coherence.isotropic(
                jnp.full((n,), 1e-3, jnp.float32), jnp.zeros((n,), jnp.float32)
            ),
        )

    @staticmethod
    def from_stokes(S, coherence: "Coherence"):
        """Stokes [N, 4, C] + coherence -> GeneralizedRadiance."""
        return GeneralizedRadiance(
            L=S[:, 0, :], L1=S[:, 1, :], L2=S[:, 2, :], L3=S[:, 3, :],
            coherence=coherence,
        )

    def stokes(self):
        """[N, 4, C] Stokes view (basis implicit in the transport chain)."""
        return jnp.stack([self.L, self.L1, self.L2, self.L3], axis=1)


def mutual_coherence(coh: Coherence, diff_xy, k=None):
    """Spatial mutual coherence between two points separated by diff_xy
    [N, 2] in the transverse plane (reference beam.h:83-105)."""
    inv_c = coh.inv_coherence_matrix(k)
    q = jnp.einsum("...i,...ij,...j->...", diff_xy, inv_c, diff_xy)
    return jnp.exp(-0.5 * q)


def mutual_coherence_angular(coh: Coherence, d1, d2):
    """Angular mutual coherence between two transverse directions
    (reference beam.h:108-122)."""
    dxy = jnp.abs(d1[..., :2] - d2[..., :2])
    v = 1.0 / jnp.maximum(jnp.sqrt(4.0 * m.Pi) * dxy, m.Epsilon)
    inv_c = coh.inv_coherence_matrix() * coh.rmm()[..., None, None]
    q = jnp.einsum("...i,...ij,...j->...", v, inv_c, v)
    return jnp.exp(-0.5 / jnp.maximum(q, 1e-30))
