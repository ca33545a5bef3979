"""Render-mode configuration (the array-program analog of Mitsuba's compiled
variants, resources/mitsuba.conf.template:86-382).

A `RenderConfig` is a small hashable static dataclass passed through jit:
  - rgb            : C = 3 fixed RGB channels
  - spectral       : C = 4 hero wavelengths, sampled per ray
  - polarized      : radiance becomes a Stokes 4-vector; BSDF values become
                     4x4 Mueller matrices, stored [..., 4, 4, C]

Array shape conventions:
  unpolarized spectrum: [N, C]
  Stokes vector:        [N, 4, C]
  Mueller matrix:       [N, 4, 4, C]
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    polarized: bool = False
    spectral: bool = False
    # monochrome variant (reference mitsuba.conf mono modes): one
    # luminance channel; color-valued inputs collapse via Rec.709
    # luminance at evaluation time (the reference converts on load)
    mono: bool = False

    @property
    def n_channels(self) -> int:
        if self.spectral:
            return 4
        return 1 if self.mono else 3

    @property
    def name(self) -> str:
        base = ("spectral" if self.spectral
                else ("mono" if self.mono else "rgb"))
        return base + ("_polarized" if self.polarized else "")


RGB = RenderConfig(polarized=False, spectral=False)
RGB_POLARIZED = RenderConfig(polarized=True, spectral=False)
SPECTRAL = RenderConfig(polarized=False, spectral=True)
SPECTRAL_POLARIZED = RenderConfig(polarized=True, spectral=True)
MONO = RenderConfig(mono=True)
MONO_POLARIZED = RenderConfig(mono=True, polarized=True)

VARIANTS = {
    "rgb": RGB,
    "rgb_polarized": RGB_POLARIZED,
    "spectral": SPECTRAL,
    "spectral_polarized": SPECTRAL_POLARIZED,
    "mono": MONO,
    "mono_polarized": MONO_POLARIZED,
}
