"""Reconstruction filters (port of tpuprt/filters/filters.py for the box
filter, the only one the port's film splats)."""
from __future__ import annotations

FILTER_BOX = "box"

DEFAULT_WIDTHS = {FILTER_BOX: (0.5, 0.5)}


def check(kind: str, xwidth: float, ywidth: float):
    """A half-pixel box touches exactly the sample's own pixel, which is
    the film's single-scatter path (film.py); wider filters splat over a
    window that is not ported."""
    if kind != FILTER_BOX or xwidth > 0.5 or ywidth > 0.5:
        raise NotImplementedError(
            f'pixel filter "{kind}" {xwidth}x{ywidth} is not ported '
            "(box of width <= 0.5 only)")
