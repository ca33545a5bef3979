"""Integrator registry (analog of the reference's plugin name lookup)."""


def _int(cfg, key, default):
    try:
        return int(cfg.get(key, default))
    except (TypeError, ValueError):  # unresolved "$param" defaults
        return default



def make_integrator(cfg: dict):
    t = cfg.get("type", "path")
    if t in ("path", "mispath"):
        from .path import PathIntegrator

        return PathIntegrator(
            max_depth=_int(cfg, "max_depth", 6),
            rr_depth=_int(cfg, "rr_depth", 5),
        )
    if t == "direct":
        from .direct import DirectIntegrator

        shading = _int(cfg, "shading_samples", 1)
        return DirectIntegrator(
            emitter_samples=_int(cfg, "emitter_samples", shading),
            bsdf_samples=_int(cfg, "bsdf_samples", shading),
            hide_emitters=bool(cfg.get("hide_emitters", False)),
        )
    if t in ("prb", "prb_basic", "prb_projective"):
        # prb_projective's PRIMAL equals prb (reference prb_projective.py
        # subclasses the same estimator); its projective boundary terms
        # live in the AD layer here (ad/render.render_loss_grad's
        # edge-sampled silhouette gradients), not in the integrator
        from .prb import PRBIntegrator

        return PRBIntegrator(
            max_depth=_int(cfg, "max_depth", 6),
            rr_depth=_int(cfg, "rr_depth", 5),
        )
    if t == "direct_projective":
        # same story: primal = the dedicated direct estimator
        from .direct import DirectIntegrator

        return DirectIntegrator(
            emitter_samples=_int(cfg, "sppc", 1) or 1,
            bsdf_samples=_int(cfg, "sppe", 1) or 1,
        )
    if t == "depth":
        from .aov import DepthIntegrator

        return DepthIntegrator()
    if t == "aov":
        from .aov import AOVIntegrator

        return AOVIntegrator()
    if t == "moment":
        from .aov import MomentIntegrator

        inner = make_integrator(cfg.get("nested", {"type": "path"}))
        return MomentIntegrator(inner=inner)
    if t in ("plt",):
        from .plt import PLTIntegrator

        d = _int(cfg, "max_depth", 6)
        # The solve phase materializes [max_depth * N] bounce rows; keep
        # depth x wavefront under ~12.6M rows (at max_depth=12 a 2^21
        # wavefront would flatten to an 11 GB [D*N, 3] tensor).
        return PLTIntegrator(
            max_depth=d,
            rr_depth=_int(cfg, "rr_depth", 5),
            max_wavefront=min(1 << 21, (12 << 20) // max(d, 1)),
        )
    if t in ("volpath", "volpathmis", "prbvolpath"):
        # prbvolpath: the volumetric detached-sampling AD estimator IS the
        # volpath sample function (flight distances + event decisions
        # detached, densities attached — see volpath.py); jax.grad through
        # ad/render.render_differentiable with jax.checkpoint provides the
        # O(1)-memory replay role of the reference's prbvolpath.py
        from .volpath import VolPathIntegrator

        return VolPathIntegrator(
            max_depth=_int(cfg, "max_depth", 8),
            rr_depth=_int(cfg, "rr_depth", 5),
            spectral_mis=(t == "volpathmis"),
        )
    if t in ("stokes", "stokes_fw"):
        from .stokes import StokesIntegrator, PolarizedPathIntegrator

        nested = cfg.get("nested")
        inner = None
        if nested is not None and nested.get("type", "path") in ("path", "mispath"):
            inner = PolarizedPathIntegrator(
                max_depth=_int(nested, "max_depth", 6),
                rr_depth=_int(nested, "rr_depth", 5),
            )
        return StokesIntegrator(inner=inner, forward_basis=(t == "stokes_fw"))
    if t in ("ptracer",):
        from .ptracer import ParticleTracer

        return ParticleTracer(
            max_depth=_int(cfg, "max_depth", 6),
            rr_depth=_int(cfg, "rr_depth", 5),
        )
    # unresolved -D defaults ("$integrator") fall back to the path tracer
    import warnings

    warnings.warn(f"integrator type {t!r} unavailable; using 'path'")
    from .path import PathIntegrator

    return PathIntegrator(
        max_depth=_int(cfg, "max_depth", 6),
        rr_depth=_int(cfg, "rr_depth", 5),
    )
