"""Hand-written Pallas kernels, and the one place that decides whether the
renderer runs them."""
from __future__ import annotations

import jax


def use_fused_kernels(platform: str | None = None) -> bool:
    """True where the renderer runs the fused Pallas kernels (the GPU, where
    they are compiled through Triton); elsewhere it runs the plain XLA
    chains they replace. `platform` defaults to jax.default_backend(); this
    is the only place in the library that reads it."""
    if platform is None:
        platform = jax.default_backend()
    return platform == "gpu"
