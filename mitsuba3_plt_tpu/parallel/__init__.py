"""Multi-device rendering: shard the camera wavefront over a jax.sharding.Mesh.

Array-program replacement for the reference's single-node parallelism
(nanothread tile loop, src/render/integrator.cpp:158-241 and the 2^32-lane
Dr.Jit wavefront, integrator.cpp:246-355): lanes (pixel x spp samples) are
sharded across devices with shard_map; every device renders its slice of the
wavefront against a replicated scene, splats into a local film copy, and the
films are summed with psum — a deterministic scatter-add + all-reduce instead
of atomics. Scene-parameter gradients ride the same psum in the backward pass.
"""
from .render import make_mesh, render_sharded, make_render_pass_sharded

__all__ = ["make_mesh", "render_sharded", "make_render_pass_sharded"]
