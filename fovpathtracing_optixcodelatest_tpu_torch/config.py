"""Typed configuration for the renderer (fields and defaults as in the JAX
package's ``config.py``).

The TPU traversal-mechanism knobs of the JAX ``RenderConfig``
(``compact_bounces``, ``frame_compaction``, ``traversal_phase1_cap*``) have no
counterpart here: they change how the TPU schedules work, never the result.
``catcher_passthrough`` and ``dispersion`` come with the catcher and
spectral paths, which are not ported.
Features this port does not implement yet raise ``NotImplementedError`` from
``RenderConfig.check_supported``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FoveationPass:
    """One foveated launch region: pixel stride ``factor`` (also the block
    replication size), ``spp``, ring radii around the gaze, ``redraw``
    (no progressive accumulation), and the launch grid in strided coords
    (None = the whole frame at this stride). ``centered`` passes sit at
    ``gaze - center_offset``."""

    factor: int
    spp: int
    r_inner: float
    r_outer: float
    redraw: bool
    launch_w: int | None = None
    launch_h: int | None = None
    centered: bool = False
    center_offset: int = 0


INNER_RADIUS = 74
OUTER_RADIUS = 241


@dataclasses.dataclass(frozen=True)
class FoveationSchedule:
    passes: Tuple[FoveationPass, ...]

    @staticmethod
    def reference_32_16_8(
        inner: int = INNER_RADIUS, outer: int = OUTER_RADIUS
    ) -> "FoveationSchedule":
        """Periphery stride 4 / 8 spp, annulus stride 2 / 16 spp, fovea
        stride 1 / 32 spp."""
        return FoveationSchedule(
            passes=(
                FoveationPass(
                    factor=4, spp=8, r_inner=float(outer), r_outer=1e9,
                    redraw=False,
                ),
                FoveationPass(
                    factor=2, spp=16, r_inner=float(inner),
                    r_outer=float(outer + 2), redraw=True,
                    launch_w=outer + 2, launch_h=outer + 2,
                    centered=True, center_offset=outer + 2,
                ),
                FoveationPass(
                    factor=1, spp=32, r_inner=0.0, r_outer=float(inner + 1),
                    redraw=True, launch_w=2 * (inner + 1),
                    launch_h=2 * (inner + 1), centered=True,
                    center_offset=inner + 1,
                ),
            )
        )

    @staticmethod
    def uniform(spp: int = 4) -> "FoveationSchedule":
        """One full-frame launch at stride 1."""
        return FoveationSchedule(
            passes=(
                FoveationPass(
                    factor=1, spp=spp, r_inner=0.0, r_outer=1e9, redraw=False
                ),
            )
        )

    def scaled(self, s: int) -> "FoveationSchedule":
        """The same schedule at 1/s resolution: radii, launch grids and gaze
        offsets shrink by s; each inner pass keeps the coarser pass's block
        diagonal as coverage margin."""
        if s <= 1:
            return self
        passes = []
        for i, p in enumerate(self.passes):
            pad = 0.0
            if i > 0 and p.r_outer < 1e8:
                pad = math.ceil(self.passes[i - 1].factor * math.sqrt(2)) + 1
            r_out = p.r_outer if p.r_outer >= 1e8 else p.r_outer / s + pad
            grow = int(math.ceil(pad / max(p.factor, 1)))
            passes.append(dataclasses.replace(
                p,
                r_inner=p.r_inner / s,
                r_outer=r_out,
                launch_w=None if p.launch_w is None
                else max(1, p.launch_w // s) + 2 * grow,
                launch_h=None if p.launch_h is None
                else max(1, p.launch_h // s) + 2 * grow,
                center_offset=(p.center_offset // s + grow * p.factor)
                if p.centered else 0,
            ))
        return FoveationSchedule(passes=tuple(passes))


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 960
    height: int = 540
    max_depth: int = 4
    tmin: float = 0.01
    tmax: float = 1e16
    antialias: bool = True
    exposure_stops: float = 4.0
    tone_mapping: bool = True
    exposure_correction: bool = True
    white: float = 1.0
    accumulate: bool = True
    # AA-jitter generator; only "random" is ported
    sampler: str = "random"
    # intersection backend; only the BVH traversal is ported
    traversal: str = "bvh"
    spectral: bool = False

    def check_supported(self) -> None:
        if self.sampler != "random":
            raise NotImplementedError(
                f"sampler {self.sampler!r}: only 'random' is ported"
            )
        if self.spectral:
            raise NotImplementedError("spectral rendering is not ported")
        if self.traversal != "bvh":
            raise NotImplementedError(
                f"traversal {self.traversal!r}: only 'bvh' is ported"
            )
