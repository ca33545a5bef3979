"""Stateless counter-based sampler for Monte Carlo rendering on accelerators.

Design: instead of a mutable PCG32 state per lane (reference:
include/mitsuba/render/sampler.h:63-180), every sample value is a pure hash
of (seed, lane, dimension). This makes the sampler

  * fully replayable — path-replay backprop re-derives identical numbers
    without storing anything,
  * order-independent — no dimension-consumption bookkeeping inside lax.scan,
  * trivially shardable — lanes are globally indexed, so any device slice of
    the wavefront draws the same numbers as a single-device run.

The hash is PCG-family (Jarzynski & Olano, "Hash Functions for GPU Rendering",
JCGT 2020 — public domain constants), 2 rounds over a mixed 32-bit counter.
Quality is well above what unbiased MC integration needs; a threefry-based
fallback is provided for gold-standard verification.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

U32 = jnp.uint32


def _pcg_hash(x):
    x = x * U32(747796405) + U32(2891336453)
    word = ((x >> ((x >> U32(28)) + U32(4))) ^ x) * U32(277803737)
    return (word >> U32(22)) ^ word


def hash_combine(a, b):
    """Mix two u32 streams (boost-style golden-ratio combine, then PCG round)."""
    a = jnp.asarray(a, U32)
    b = jnp.asarray(b, U32)
    h = a ^ (b + U32(0x9E3779B9) + (a << U32(6)) + (a >> U32(2)))
    return _pcg_hash(h)


def random_bits(seed, lane, dim):
    """u32 random bits as a pure function of (seed, lane, dim)."""
    s = jnp.asarray(seed, U32)
    l = jnp.asarray(lane, U32)
    d = jnp.asarray(dim, U32)
    return _pcg_hash(hash_combine(hash_combine(s, l), d))


def uniform(seed, lane, dim):
    """f32 uniform in [0, 1) from (seed, lane, dim)."""
    bits = random_bits(seed, lane, dim)
    # take the top 24 bits -> exactly representable in f32, in [0,1)
    return (bits >> U32(8)).astype(jnp.float32) * jnp.float32(1.0 / 16777216.0)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Sampler:
    """Functional sampler: immutable seed + lane ids; `dim` is advanced by the
    caller (an integer carried through the bounce scan)."""

    seed: jax.Array  # scalar u32
    lane: jax.Array  # [N] u32 global lane indices

    @staticmethod
    def create(seed: int, wavefront_size: int, lane_offset: int = 0) -> "Sampler":
        lanes = jnp.arange(wavefront_size, dtype=U32) + U32(lane_offset)
        return Sampler(seed=jnp.asarray(seed, U32), lane=lanes)

    def next_1d(self, dim):
        return uniform(self.seed, self.lane, dim)

    def next_2d(self, dim):
        return jnp.stack(
            [
                uniform(self.seed, self.lane, dim),
                uniform(self.seed, self.lane, dim + 1),
            ],
            axis=-1,
        )

    def fork(self, salt: int) -> "Sampler":
        return Sampler(
            seed=hash_combine(self.seed, jnp.asarray(salt, U32)), lane=self.lane
        )

    # traced-salt variant (same computation; separate name documents that the
    # salt may be a tracer, e.g. the pass index inside a jitted pass loop)
    fork_traced = fork


# ---------------------------------------------------------------------------
# Stratified / correlated multi-jittered pixel sampling (the role of the
# reference's stratified/multijitter/orthogonal sampler plugins,
# src/samplers/). Only the camera dimensions benefit from stratification in a
# wavefront renderer; bounce dims stay independent (pure counter hashes).
# Algorithm: Kensler, "Correlated Multi-Jittered Sampling" (Pixar TM 13-01).
# ---------------------------------------------------------------------------

def _cmj_permute(i, l, p):
    """Cycle-walking pseudorandom permutation of [0, l).

    Rounds of {xor-key, odd-multiply, xor-shift} masked to the next power of
    two — every op is invertible mod 2^k, so the composition is a true
    bijection on the padded domain; cycle-walking maps back into [0, l)
    (zero walks when l is itself a power of two, the common spp case).
    """
    i = jnp.asarray(i, U32)
    l = jnp.asarray(l, U32)
    p = jnp.asarray(p, U32)
    w = l - U32(1)
    w = w | (w >> U32(1))
    w = w | (w >> U32(2))
    w = w | (w >> U32(4))
    w = w | (w >> U32(8))
    w = w | (w >> U32(16))

    keys = [
        _pcg_hash(p + U32(0x9E3779B9) * U32(r + 1)) for r in range(4)
    ]

    def scramble(i):
        for k in keys:
            i = (i ^ (k & w)) & w
            i = (i * U32(0x6935FA69)) & w      # odd multiplier: invertible
            i = (i ^ (i >> U32(3))) & w        # xorshift: invertible
            i = (i * U32(0x74DCCA9B)) & w
            i = (i ^ (i >> U32(7))) & w
        return i

    # cycle walk until every lane lands in [0, l) — exact bijectivity
    # (expected <2 rounds: the padded domain is < 2*l)
    i = scramble(i)

    def cond(i):
        return jnp.any(i >= l)

    def walk(i):
        return jnp.where(i >= l, scramble(i), i)

    i = jax.lax.while_loop(cond, walk, i)
    return (i + p) % l


def _cmj_randfloat(i, p):
    bits = _pcg_hash(hash_combine(jnp.asarray(i, U32), jnp.asarray(p, U32)))
    return (bits >> U32(8)).astype(jnp.float32) * jnp.float32(1.0 / 16777216.0)


def cmj_sample_2d(s, spp: int, pattern):
    """Correlated multi-jittered 2D sample s of spp for pattern id `pattern`
    (a u32 array broadcastable with s). spp is static."""
    import math

    m = max(int(math.sqrt(spp)), 1)
    n = (spp + m - 1) // m
    s = _cmj_permute(s, spp, pattern * U32(0x51633E2D))
    sx = _cmj_permute(s % m, m, pattern * U32(0x68BC21EB))
    sy = _cmj_permute(s // m, n, pattern * U32(0x02E5BE93))
    jx = _cmj_randfloat(s, pattern * U32(0x967A889B))
    jy = _cmj_randfloat(s, pattern * U32(0x368CC8B7))
    x = (sx.astype(jnp.float32) + (sy.astype(jnp.float32) + jx) / n) / m
    y = (s.astype(jnp.float32) + jy) / spp
    return jnp.stack([x, y], axis=-1)


def _bit_reverse32(i):
    i = jnp.asarray(i, U32)
    i = ((i & U32(0x55555555)) << 1) | ((i & U32(0xAAAAAAAA)) >> 1)
    i = ((i & U32(0x33333333)) << 2) | ((i & U32(0xCCCCCCCC)) >> 2)
    i = ((i & U32(0x0F0F0F0F)) << 4) | ((i & U32(0xF0F0F0F0)) >> 4)
    i = ((i & U32(0x00FF00FF)) << 8) | ((i & U32(0xFF00FF00)) >> 8)
    return (i << 16) | (i >> 16)


def _radical_inverse_base2(i):
    """Van der Corput sequence (bit reversal / 2^32)."""
    return _bit_reverse32(i).astype(jnp.float32) * jnp.float32(
        2.3283064365386963e-10
    )


def _radical_inverse_base3(i, digits: int = 20):
    """Base-3 radical inverse with a static digit count (covers 3^20 > 2^31)."""
    i = jnp.asarray(i, jnp.uint32)
    f = jnp.zeros(i.shape, jnp.float32)
    inv = jnp.float32(1.0 / 3.0)
    scale = jnp.full(i.shape, inv)
    for _ in range(digits):
        digit = (i % 3).astype(jnp.float32)
        f = f + digit * scale
        i = i // 3
        scale = scale * inv
    return f


def halton_2d(s, pattern):
    """Low-discrepancy 2D point: (base-2, base-3) radical inverses of sample
    index s with a Cranley-Patterson rotation per `pattern` (u32) — the role
    of the reference's ldsampler/halton plugins (src/samplers/)."""
    rx = _cmj_randfloat(jnp.zeros_like(pattern), pattern * U32(0x9E3779B1))
    ry = _cmj_randfloat(jnp.ones_like(pattern), pattern * U32(0x85EBCA77))
    x = jnp.mod(_radical_inverse_base2(s) + rx, 1.0)
    y = jnp.mod(_radical_inverse_base3(s) + ry, 1.0)
    return jnp.stack([x, y], axis=-1)


def _sobol2(i, scramble):
    """Second dimension of the Sobol' (0,2)-sequence, XOR-scrambled.

    32 static steps over the direction numbers v_{k+1} = v_k ^ (v_k >> 1)
    (v_0 = 2^31) — pure vectorized bit ops, no gathers."""
    i = jnp.asarray(i, U32)
    res = jnp.asarray(scramble, U32)
    v = 0x80000000
    for k in range(32):
        res = res ^ jnp.where((i >> U32(k)) & U32(1) != 0, U32(v), U32(0))
        v ^= v >> 1
    return res


def ld_2d(s, pattern):
    """Scrambled (0,2)-sequence point s (the reference ldsampler's pixel
    pair, src/samplers/ldsampler.cpp): x = van der Corput (bit reversal),
    y = Sobol' dim 2, both XOR-scrambled per `pattern` (u32). Every
    2^a x 2^b stratification of any prefix holds the right point count —
    strictly better equidistribution than the Halton pair it replaces."""
    s = jnp.asarray(s, U32)
    scr1 = _pcg_hash(pattern * U32(0x9E3779B1) + U32(0x2545F491))
    scr2 = _pcg_hash(pattern * U32(0x85EBCA77) + U32(0x633D9B4F))
    xb = _bit_reverse32(s) ^ scr1
    yb = _sobol2(s, scr2)
    to_f = jnp.float32(2.3283064365386963e-10)
    return jnp.stack(
        [xb.astype(jnp.float32) * to_f, yb.astype(jnp.float32) * to_f],
        axis=-1,
    )


def orthogonal_2d(s, spp: int, pattern):
    """Orthogonal-array 2D sample via the Bose construction, strength 2
    (reference src/samplers/orthogonal.cpp:224-252, Jarosz et al. 2019).

    resolution = ceil(sqrt(spp)); the OA has res^2 points — when spp is a
    perfect square (the recommended usage, as in the reference) every
    res x res stratum holds exactly one point AND each 1D projection is an
    N-rooks pattern; otherwise the first spp points of the permuted OA are
    used. spp is static; pattern is a u32 array (per-pixel seed).
    """
    import math

    res = max(int(math.ceil(math.sqrt(spp))), 1)
    N = res * res
    i = _cmj_permute(s, N, pattern)
    a_i0 = i // U32(res)
    a_i1 = i % U32(res)
    # Bose: dimension j=0 uses (a_i0, a_i1); j=1 uses (a_i1, a_i0); the
    # stratum/sub-stratum pair is independently permuted per dimension
    sx = _cmj_permute(a_i0, res, pattern * U32(1) * U32(0x51633E2D))
    ssx = _cmj_permute(a_i1, res, pattern * U32(1) * U32(0x68BC21EB))
    sy = _cmj_permute(a_i1, res, pattern * U32(2) * U32(0x51633E2D))
    ssy = _cmj_permute(a_i0, res, pattern * U32(2) * U32(0x68BC21EB))
    jx = _cmj_randfloat(i, pattern * U32(0x967A889B))
    jy = _cmj_randfloat(i, pattern * U32(0x368CC8B7))
    x = (sx.astype(jnp.float32) + (ssx.astype(jnp.float32) + jx) / res) / res
    y = (sy.astype(jnp.float32) + (ssy.astype(jnp.float32) + jy) / res) / res
    return jnp.stack([x, y], axis=-1)


SAMPLER_INDEPENDENT = "independent"
SAMPLER_STRATIFIED = "stratified"
SAMPLER_MULTIJITTER = "multijitter"
SAMPLER_LD = "ldsampler"
SAMPLER_ORTHOGONAL = "orthogonal"


# Fixed dimension-allocation map for the path/PLT integrators. Each bounce gets
# a static stride of dimensions so sample/replay phases agree by construction.
DIMS_PER_BOUNCE = 12
DIM_CAMERA = 0          # 4 dims: film jitter (2), aperture (2)
DIM_WAVELENGTH = 4      # 1 dim
DIM_BOUNCE_BASE = 8     # bounce b uses [8 + b*12, 8 + (b+1)*12)
DIM_MEDIUM_BASE = 1 << 20  # null-collision tracking chains: b*512 + slot


def bounce_dim(bounce, offset):
    return DIM_BOUNCE_BASE + bounce * DIMS_PER_BOUNCE + offset
