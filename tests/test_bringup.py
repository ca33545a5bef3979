"""What the GPU bring-up relies on, checked on the CPU: the smoke script's
device gate, the compile-cache location, and full f32 precision in the
small contractions of the main path (a default-precision f32 dot may run in
TF32 on the GPU)."""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_gate_refuses_cpu_devices():
    cs = _load_chip_smoke()
    with pytest.raises(cs.SmokeFailure, match="no GPU"):
        cs.require_gpu(jax.devices())
    with pytest.raises(cs.SmokeFailure):
        cs.require_gpu([])


@pytest.mark.parametrize("env_dir", [None, "explicit"])
def test_compile_cache_dir(tmp_path, env_dir):
    import mitsuba3_plt_tpu as mi

    environ = {} if env_dir is None else {
        "JAX_COMPILATION_CACHE_DIR": str(tmp_path / env_dir)}
    old = jax.config.jax_compilation_cache_dir
    try:
        got = mi._configure_compile_cache(environ)
        assert jax.config.jax_compilation_cache_dir == got
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 2.0
        assert jax.config.jax_persistent_cache_min_entry_size_bytes == 0
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    if env_dir is None:
        assert got == os.path.join(ROOT, ".jax_cache")
    else:
        assert got == str(tmp_path / env_dir)


def _dot_precisions(jaxpr):
    """Precision config of every dot_general in a jaxpr, sub-jaxprs too."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out += _dot_precisions(sub)
    return out


def _assert_all_highest(fn, *args):
    precs = _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert precs, "expected at least one contraction"
    hi = jax.lax.Precision.HIGHEST
    for p in precs:
        assert p is not None and all(x == hi for x in p), precs


@pytest.mark.parametrize("variant", ["rgb", "spectral"])
def test_sample_rays_contractions_at_highest_precision(variant):
    from mitsuba3_plt_tpu.config import VARIANTS
    from mitsuba3_plt_tpu.core.rng import Sampler
    from mitsuba3_plt_tpu.integrators.common import sample_rays
    from mitsuba3_plt_tpu.scene.presets import cornell_box

    scene, _ = cornell_box(8, 8)
    cfg = VARIANTS[variant]

    def f(seed):
        sampler = Sampler.create(seed, 8 * 8 * 2)
        return sample_rays(scene, sampler, 8, 8, 2, cfg)

    _assert_all_highest(f, jnp.uint32(0))


def test_colour_and_mueller_contractions_at_highest_precision():
    from mitsuba3_plt_tpu.core import spectrum as spec
    from mitsuba3_plt_tpu.librender import mueller as mu

    xyz = jnp.ones((4, 3))
    _assert_all_highest(spec.xyz_to_srgb, xyz)
    _assert_all_highest(spec.srgb_to_xyz, xyz)
    _assert_all_highest(spec.cie1931_xyz, jnp.full((4, 3), 550.0))
    M = jnp.broadcast_to(jnp.eye(4), (4, 4, 4))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (4, 1))
    b0 = jnp.tile(jnp.asarray([[1.0, 0.0, 0.0]]), (4, 1))
    b1 = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (4, 1))
    _assert_all_highest(
        lambda m_: mu.rotate_mueller_basis(m_, d, b0, b1, d, b0, b1), M)
    _assert_all_highest(
        lambda m_: mu.rotate_mueller_basis_collinear(m_, d, b0, b1), M)
    _assert_all_highest(lambda m_: mu.rotated_element(
        jnp.full((4,), 0.3), m_), M)
    # the pinned colour transform is exact to f32 against NumPy in float64
    v = np.random.default_rng(0).random((16, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(spec.xyz_to_srgb(jnp.asarray(v))),
        v.astype(np.float64) @ np.asarray(spec.XYZ_TO_SRGB, np.float64).T,
        rtol=1e-5, atol=1e-6)
