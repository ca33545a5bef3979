"""LargeSteps: Laplacian-preconditioned shape optimization.

Functional twin of the reference's `LargeSteps` (src/python/python/ad/
largesteps.py:55, after Nicolet et al. 2021 "Large Steps in Inverse
Rendering of Geometry"): optimize in the differential domain u = (I + l*L)v
so gradient steps stay smooth; recover vertices by solving the SPD system
with conjugate gradients (jax.scipy CG on a segment-sum matvec — no sparse
factorization needed).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp


def _edges_from_faces(faces: np.ndarray):
    f = np.asarray(faces, np.int64)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    e = np.sort(e, axis=1)
    e = np.unique(e, axis=0)
    return e.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class LargeSteps:
    """Combinatorial-Laplacian preconditioner for a fixed-topology mesh."""

    edges: Any        # [E, 2] int32
    n_vertices: int
    lambda_: float = 19.0

    @staticmethod
    def create(vertices, faces, lambda_: float = 19.0) -> "LargeSteps":
        return LargeSteps(
            edges=jnp.asarray(_edges_from_faces(faces)),
            n_vertices=len(vertices),
            lambda_=float(lambda_),
        )

    def _laplacian_matvec(self, x):
        """(I + lambda * L) x with L = D - A (uniform weights)."""
        i = self.edges[:, 0]
        j = self.edges[:, 1]
        diff_ij = x[i] - x[j]
        out = jnp.zeros_like(x)
        out = out.at[i].add(diff_ij)
        out = out.at[j].add(-diff_ij)
        return x + self.lambda_ * out

    def to_differential(self, v):
        """v -> u = (I + lambda L) v (largesteps.py to_differential)."""
        return self._laplacian_matvec(jnp.asarray(v, jnp.float32))

    def from_differential(self, u, tol: float = 1e-6, maxiter: int = 200):
        """u -> v: CG solve of the SPD system (largesteps.py from_differential;
        the reference uses a Cholesky factorization — CG is the matrix-free
        equivalent)."""
        v, _ = jax.scipy.sparse.linalg.cg(
            self._laplacian_matvec, jnp.asarray(u, jnp.float32),
            tol=tol, maxiter=maxiter,
        )
        return v
