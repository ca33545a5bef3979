"""1D discrete / continuous distributions (emitter pick, spectra, SRFs).

Functional twins of Mitsuba's distr_1d.h: cdf tables built host-side (numpy)
or traced (jnp), sampled with searchsorted — no data-dependent control flow.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from . import math as m


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DiscreteDistribution:
    pmf: jax.Array   # [K] nonnegative weights
    cdf: jax.Array   # [K] inclusive cumulative sum (unnormalized)
    total: jax.Array  # scalar sum

    @staticmethod
    def create(weights) -> "DiscreteDistribution":
        w = jnp.asarray(weights, jnp.float32)
        cdf = jnp.cumsum(w)
        return DiscreteDistribution(pmf=w, cdf=cdf, total=cdf[-1])

    def sample(self, u):
        """Returns index i with prob pmf[i]/total. u in [0,1)."""
        x = u * self.total
        idx = jnp.searchsorted(self.cdf, x, side="right")
        return jnp.clip(idx, 0, self.pmf.shape[0] - 1).astype(jnp.int32)

    def sample_reuse(self, u):
        """Returns (index, remapped u in [0,1))."""
        idx = self.sample(u)
        lo = jnp.where(idx > 0, self.cdf[jnp.maximum(idx - 1, 0)], 0.0)
        w = jnp.maximum(self.pmf[idx], 1e-20)
        u2 = (u * self.total - lo) / w
        return idx, jnp.clip(u2, 0.0, 1.0 - 1e-7)

    def eval_pmf_normalized(self, idx):
        return self.pmf[idx] / jnp.maximum(self.total, 1e-20)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ContinuousDistribution:
    """Piecewise-linear density over [range[0], range[1]] on a regular grid."""

    values: jax.Array  # [K] density samples (unnormalized)
    cdf: jax.Array     # [K-1] integral up to each cell end (unnormalized)
    range: jax.Array   # [2]
    integral: jax.Array  # scalar

    @staticmethod
    def create(range_, values) -> "ContinuousDistribution":
        v = jnp.asarray(values, jnp.float32)
        r = jnp.asarray(range_, jnp.float32)
        dx = (r[1] - r[0]) / (v.shape[0] - 1)
        cell = 0.5 * (v[:-1] + v[1:]) * dx
        cdf = jnp.cumsum(cell)
        return ContinuousDistribution(values=v, cdf=cdf, range=r, integral=cdf[-1])

    def eval_pdf(self, x):
        """Unnormalized linear-interpolated density at x (0 outside range)."""
        r = self.range
        k = self.values.shape[0]
        t = (x - r[0]) / (r[1] - r[0]) * (k - 1)
        i = jnp.clip(jnp.floor(t).astype(jnp.int32), 0, k - 2)
        f = t - i
        val = self.values[i] * (1.0 - f) + self.values[i + 1] * f
        inside = jnp.logical_and(x >= r[0], x <= r[1])
        return jnp.where(inside, val, 0.0)

    def pdf_normalized(self, x):
        return self.eval_pdf(x) / jnp.maximum(self.integral, 1e-20)

    def sample(self, u):
        """Inverse-CDF sample; returns x in range."""
        r = self.range
        k = self.values.shape[0]
        dx = (r[1] - r[0]) / (k - 1)
        target = u * self.integral
        i = jnp.clip(
            jnp.searchsorted(self.cdf, target, side="right"), 0, k - 2
        ).astype(jnp.int32)
        cdf_lo = jnp.where(i > 0, self.cdf[jnp.maximum(i - 1, 0)], 0.0)
        rem = target - cdf_lo
        v0 = self.values[i]
        v1 = self.values[i + 1]
        # solve 0.5*(v0 + v(t))*t*dx = rem  with v(t) = lerp(v0,v1,t)
        a = 0.5 * (v1 - v0) * dx
        b = v0 * dx
        disc = jnp.maximum(b * b + 4.0 * a * rem, 0.0)
        t_lin = rem / jnp.maximum(b, 1e-20)
        t_quad = (jnp.sqrt(disc) - b) / jnp.maximum(2.0 * a, 1e-20)
        t = jnp.where(jnp.abs(a) < 1e-9 * jnp.maximum(jnp.abs(b), 1e-9), t_lin, t_quad)
        t = jnp.clip(t, 0.0, 1.0)
        return r[0] + (i + t) * dx


def build_alias_table(weights: np.ndarray):
    """Host-side O(K) alias-method table -> (prob [K], alias [K]).

    Sampling with an alias table is a single gather (no binary search), which
    is the vectorization-friendly path for large emitter counts.
    """
    w = np.asarray(weights, np.float64)
    k = len(w)
    total = w.sum()
    if total <= 0:
        return np.full(k, 1.0, np.float32), np.arange(k, dtype=np.int32)
    p = w * k / total
    small = [i for i in range(k) if p[i] < 1.0]
    large = [i for i in range(k) if p[i] >= 1.0]
    prob = np.zeros(k, np.float64)
    alias = np.arange(k)
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = p[s]
        alias[s] = l
        p[l] = p[l] + p[s] - 1.0
        (small if p[l] < 1.0 else large).append(l)
    for i in large + small:
        prob[i] = 1.0
    return prob.astype(np.float32), alias.astype(np.int32)
