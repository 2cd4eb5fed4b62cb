"""Seeded AMReX plotfile datasets: real plotfiles written by
:func:`wavelet_tpu.io.plotfile.write_plotfile`, generated with no download.

Two generators:

- :func:`write_amr_dataset`: a multi-level, multi-component AMR hierarchy
  laid out the way AMReX grids it (``amr.ref_ratio``, ``amr.blocking_factor``,
  ``amr.max_grid_size``): nested refined regions aligned to the blocking
  factor, chopped into boxes of at most ``max_grid_size`` cells per side,
  so edge boxes are ragged.  Fields are smooth with sharp fronts (tanh
  shocks on seeded spheres and planes), evaluated at cell centres in
  physical space so every level samples the same flow.
- :func:`write_constant_fixture`: the two-timestep, two-level fixture of
  constant-valued boxes (``plt00074``/``plt00075``) whose facts the
  plotfile and pipeline tests assert; constant boxes survive the lossy
  codec exactly, so a round trip regenerates the plotfiles byte for byte.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from wavelet_tpu.io import plotfile

__all__ = ["AmrLayout", "amr_layout", "write_amr_dataset",
           "write_constant_fixture", "FIXTURE_COMPONENTS"]


@dataclasses.dataclass
class AmrLayout:
    """Per level: box lower corners and extents in that level's index
    space, plus the level-0 domain."""

    base_dims: tuple
    ref_ratio: int
    locations: list        # [level][box] -> (x, y, z)
    dimensions: list       # [level][box] -> (nx, ny, nz)

    def cells(self) -> int:
        return sum(int(np.prod(d)) for lev in self.dimensions for d in lev)

    def n_boxes(self) -> int:
        return sum(len(lev) for lev in self.dimensions)


def _chop(lo, extent, max_grid_size: int):
    """AMReX-style chop of one region into boxes of <= max_grid_size."""
    cuts = [list(range(0, e, max_grid_size)) for e in extent]
    out = []
    for i in cuts[0]:
        for j in cuts[1]:
            for k in cuts[2]:
                start = (i, j, k)
                size = tuple(min(max_grid_size, e - s)
                             for e, s in zip(extent, start))
                out.append((tuple(a + b for a, b in zip(lo, start)), size))
    return out


def amr_layout(base_dims, region_fractions, ref_ratio: int = 2,
               blocking_factor: int = 8, max_grid_size: int = 32,
               seed: int = 0) -> AmrLayout:
    """Level 0 covers the whole ``base_dims`` domain; level ``l >= 1`` is
    one refined region whose extent per axis is about
    ``region_fractions[l-1]`` of that level's domain, rounded to the
    blocking factor, placed at a seeded offset and nested inside the
    refinement of level ``l-1``'s region."""
    rng = np.random.default_rng(seed)
    bf = blocking_factor
    locs, dims = [], []
    region_lo = (0, 0, 0)
    region_ext = tuple(int(d) for d in base_dims)
    for lev in range(len(region_fractions) + 1):
        if lev:
            frac = float(region_fractions[lev - 1])
            parent_lo = tuple(v * ref_ratio for v in region_lo)
            parent_ext = tuple(v * ref_ratio for v in region_ext)
            domain = tuple(int(d) * ref_ratio ** lev for d in base_dims)
            ext = tuple(max(bf, int(frac * d) // bf * bf) for d in domain)
            ext = tuple(min(e, p) for e, p in zip(ext, parent_ext))
            slack = [(p - e) // bf for e, p in zip(ext, parent_ext)]
            region_lo = tuple(pl + int(rng.integers(0, s + 1)) * bf
                              for pl, s in zip(parent_lo, slack))
            region_ext = ext
        boxes = _chop(region_lo, region_ext, max_grid_size)
        locs.append([b[0] for b in boxes])
        dims.append([b[1] for b in boxes])
    return AmrLayout(tuple(int(d) for d in base_dims), ref_ratio, locs, dims)


def _fronts(rng, n_comp: int):
    """Per component: a base level, an amplitude, a smooth wave and a few
    sharp fronts (spheres and planes) with seeded positions."""
    comps = []
    for _ in range(n_comp):
        comps.append({
            "base": float(rng.uniform(1.0, 1000.0)),
            "amp": float(rng.uniform(0.5, 300.0)),
            "k": rng.uniform(2.0, 9.0, size=3),
            "phase": rng.uniform(0, 2 * np.pi, size=3),
            "spheres": [(rng.uniform(0.2, 0.8, size=3),
                         float(rng.uniform(0.1, 0.35)),
                         float(rng.uniform(0.003, 0.02)))
                        for _ in range(2)],
            "plane": (rng.normal(size=3), float(rng.uniform(0.3, 0.7)),
                      float(rng.uniform(0.002, 0.01))),
        })
    return comps


def _eval_box(comps, lo, size, dx, t: float) -> np.ndarray:
    """(C, X, Y, Z) float32 field values at the cell centres of one box."""
    axes = [(np.arange(n) + lo_i + 0.5) * dx
            for lo_i, n in zip(lo, size)]
    x, y, z = np.meshgrid(*axes, indexing="ij", sparse=True)
    out = np.empty((len(comps),) + tuple(size), np.float32)
    for c, f in enumerate(comps):
        k, ph = f["k"], f["phase"]
        v = (np.sin(k[0] * x + ph[0]) * np.cos(k[1] * y + ph[1])
             + 0.5 * np.sin(k[2] * z + ph[2] + t))
        for centre, radius, width in f["spheres"]:
            r = np.sqrt((x - centre[0]) ** 2 + (y - centre[1]) ** 2
                        + (z - centre[2]) ** 2)
            v = v + 2.0 * np.tanh((radius + 0.05 * t - r) / width)
        normal, offset, width = f["plane"]
        nrm = normal / np.linalg.norm(normal)
        v = v + np.tanh((nrm[0] * x + nrm[1] * y + nrm[2] * z
                         - offset - 0.02 * t) / width)
        out[c] = f["base"] + f["amp"] * v
    return out


def write_amr_dataset(root: str, layout: AmrLayout, names, times,
                      seed: int = 0, first_step: int = 100) -> list:
    """Write one plotfile per entry of ``times`` under ``root`` (named
    ``plt%05d`` from ``first_step``); returns their paths.  The domain is
    the unit cube; components get their own seeded fronts."""
    rng = np.random.default_rng(seed)
    comps = _fronts(rng, len(names))
    n_levels = len(layout.dimensions)
    paths = []
    for i, t in enumerate(times):
        boxes = []
        for lev in range(n_levels):
            dx = 1.0 / (layout.base_dims[0] * layout.ref_ratio ** lev)
            boxes.append([_eval_box(comps, lo, size, dx, float(t))
                          for lo, size in zip(layout.locations[lev],
                                              layout.dimensions[lev])])
        path = os.path.join(root, "plt%05d" % (first_step + i))
        r = layout.ref_ratio
        plotfile.write_plotfile(
            path, boxes, layout.locations, layout.dimensions, list(names),
            float(t), [0.0, 0.0, 0.0], [1.0, 1.0, 1.0], (r, r, r),
            layout.base_dims, [10 * (i + 1) * r ** lev
                               for lev in range(n_levels)])
        paths.append(path)
    return paths


FIXTURE_COMPONENTS = ["temp", "pressure"]


def write_constant_fixture(root: str) -> list:
    """The golden two-timestep fixture (``plt00074``, ``plt00075``) under
    ``root``: 2 components (temp, pressure), levels 0-1 at ratio 2, level-0
    domain 256 x 512 x 256, two boxes per level — a 16x32x64 box of
    constant 3902.4 at (0, 0, 0) and an 8x4x2 box of constant 16.0 at
    (16, 32, 64) — written as real plotfiles."""
    dims = [(16, 32, 64), (8, 4, 2)]
    locs = [(0, 0, 0), (16, 32, 64)]
    values = [np.float32(3902.4), np.float32(16.0)]
    boxes = [np.full((2,) + d, v, np.float32) for d, v in zip(dims, values)]
    paths = []
    for name in ("plt00074", "plt00075"):
        path = os.path.join(root, name)
        plotfile.write_plotfile(
            path, [boxes, boxes], [locs, locs], [dims, dims],
            FIXTURE_COMPONENTS, 0.2219392, [0.6, 0.5, 0.4],
            [0.8, 0.9, 1.0], (2, 2, 2), (256, 512, 256), [1200, 1500])
        paths.append(path)
    return paths
