"""mitsuba3_plt_tpu — a differentiable wave-optics renderer in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of Mitsuba 3 +
the PLT (Physical Light Transport) research fork: path tracing with NEE/MIS,
polarized Stokes/Mueller transport, coherence-aware diffraction-grating
rendering, and path-replay differentiation — expressed as pure functions over
pytrees of arrays, sharded with jax.sharding across devices.
"""

import os as _os

import jax as _jax


def _compile_cache_dir(environ=None) -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else `<checkout>/.jax_cache`."""
    environ = _os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.abspath(
        _os.path.join(_os.path.dirname(__file__), "..", ".jax_cache")
    )


def _configure_compile_cache(environ=None) -> str:
    """Persistent XLA compilation cache: render programs take tens of
    seconds to compile, so every run after the first starts from the
    cache. Returns the directory in use."""
    cache_dir = _compile_cache_dir(environ)
    _jax.config.update("jax_compilation_cache_dir", cache_dir)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir


_configure_compile_cache()

from .config import RenderConfig, RGB, RGB_POLARIZED, SPECTRAL, SPECTRAL_POLARIZED, VARIANTS

__version__ = "0.1.0"

_variant = "rgb"


def set_variant(name: str):
    global _variant
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}; have {list(VARIANTS)}")
    _variant = name


def variant() -> str:
    return _variant


def config() -> RenderConfig:
    return VARIANTS[_variant]


def load_file(path, parameters=None, **overrides):
    from .scene.loader import load_file as _lf

    return _lf(path, parameters, **overrides)


def load_dict(d):
    from .scene.dict_loader import load_dict as _ld

    return _ld(d)


def render(scene, integrator=None, spp=16, seed=0, cfg=None, **kw):
    """Convenience render: scene (+meta) -> [H, W, C] image array (C = 3, or
    the integrator's AOV channel count, e.g. 15 for stokes)."""
    from .integrators import make_integrator
    from .integrators.common import render as _render

    if isinstance(scene, tuple):
        scene, meta = scene
        if integrator is None:
            integrator = make_integrator(meta.get("integrator", {"type": "path"}))
        if "rfilter" in meta and "rfilter" not in kw:
            from .librender.film import FILTER_NAMES

            kw["rfilter"] = FILTER_NAMES.get(meta["rfilter"], 0)
        if "sampler" in meta and "sampler_type" not in kw:
            kw["sampler_type"] = meta["sampler"]
    if integrator is None:
        integrator = make_integrator({"type": "path"})
    cfg = cfg or config()
    kw.setdefault("n_out_channels", getattr(integrator, "n_out_channels", None))
    mw = getattr(integrator, "max_wavefront", None)
    if mw is not None and "spp_per_pass" not in kw:
        w, h = scene.sensor.resolution
        cap = max(1, mw // (w * h) or 1)
        # po2 passes when the cap binds, so spp sweeps share compiled
        # shapes; exact spp otherwise
        kw["spp_per_pass"] = (
            spp if spp <= cap else 1 << (cap.bit_length() - 1)
        )
    return _render(scene, integrator.sample, seed=seed, spp=spp, cfg=cfg, **kw)
