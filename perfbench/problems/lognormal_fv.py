"""The `lognormal_fv` problem: diffusion with a log-normal coefficient,
-div(a grad u) = f on the unit square with u = 0 on its boundary, one new
coefficient field a = exp(g) for each solve (the elliptic problem with
random coefficients of Cliffe, Giles, Scheichl, Teckentrup, Comput. Visual.
Sci. 14 (2011) 3-15).

The plain reference of the deployment, in numpy and float64, independent
of the port:

- `field(grid, sigma2, lam, rng)`: g, a periodic Gaussian field on the
  grid's cell centres with covariance sigma2 * exp(-r / lam), r the
  distance on the unit torus, made by FFT: the square root of the
  covariance's spectrum (clipped at 0) times the transform of white noise.
- `assemble(a)`: cell-centred finite volumes on that grid: each interior
  face carries the harmonic mean 2 a_i a_j / (a_i + a_j) of its two cells,
  each boundary face 2 a_i (the Dirichlet value sits half a cell away).
  The operator is SPD with the pattern of the 5-point Laplacian: rows are
  C-order cells, each row's columns ascending, as `poisson_fd` builds it.

`build(config)` gives the operator of the constant field a = 1, whose
pattern every sample shares; the driver makes the fields from the run's
seed.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def field(grid: Sequence[int], sigma2: float, lam: float,
          rng: np.random.Generator) -> np.ndarray:
    """One sample of g on `grid` (float64, the grid's shape), from
    standard normal noise drawn from `rng`."""
    grid = tuple(int(s) for s in grid)
    axes = []
    for s in grid:
        d = np.arange(s) / s                 # offsets in cell widths of 1/s
        axes.append(np.minimum(d, 1.0 - d))  # on the torus
    r = np.sqrt(sum(np.meshgrid(*[d ** 2 for d in axes], indexing="ij")))
    cov = sigma2 * np.exp(-r / lam)
    spectrum = np.maximum(np.fft.fftn(cov).real, 0.0)
    noise = rng.standard_normal(grid)
    return np.fft.ifftn(np.sqrt(spectrum) * np.fft.fftn(noise)).real


def assemble(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     int]:
    """(rows, cols, vals, n) of the finite-volume operator of the 2-D
    coefficient `a` (cells in C order), row-sorted with ascending columns
    in each row; rows and cols int32, vals float64."""
    a = np.asarray(a, dtype=np.float64)
    if a.ndim != 2 or min(a.shape) < 1 or not np.all(a > 0):
        raise ValueError("a is a positive 2-D array of cell values")
    nx, ny = a.shape
    n = nx * ny
    # the faces between (i, j) and (i + 1, j), and (i, j) and (i, j + 1)
    down = 2.0 * a[:-1] * a[1:] / (a[:-1] + a[1:])
    right = 2.0 * a[:, :-1] * a[:, 1:] / (a[:, :-1] + a[:, 1:])
    up_c = np.zeros_like(a)      # coefficient to (i - 1, j)
    up_c[1:] = down
    down_c = np.zeros_like(a)    # to (i + 1, j)
    down_c[:-1] = down
    left_c = np.zeros_like(a)    # to (i, j - 1)
    left_c[:, 1:] = right
    right_c = np.zeros_like(a)   # to (i, j + 1)
    right_c[:, :-1] = right
    boundary = np.zeros_like(a)  # 2 a on each face on the boundary
    boundary[0] += 2.0 * a[0]
    boundary[-1] += 2.0 * a[-1]
    boundary[:, 0] += 2.0 * a[:, 0]
    boundary[:, -1] += 2.0 * a[:, -1]
    diag = up_c + down_c + left_c + right_c + boundary
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    idx = (i * ny + j).reshape(-1)
    # the five points in ascending column order: -ny, -1, 0, +1, +ny
    points = ((-ny, i > 0, -up_c), (-1, j > 0, -left_c), (0, None, diag),
              (1, j < ny - 1, -right_c), (ny, i < nx - 1, -down_c))
    cols = np.stack([idx + off for off, _, _ in points], axis=1)
    vals = np.stack([v.reshape(-1) for _, _, v in points], axis=1)
    valid = np.stack([np.ones(n, dtype=bool) if m is None else m.reshape(-1)
                      for _, m, _ in points], axis=1)
    rows = np.broadcast_to(idx[:, None], cols.shape)
    return (rows[valid].astype(np.int32), cols[valid].astype(np.int32),
            vals[valid], n)


def sample(config: dict, rng: np.random.Generator) -> np.ndarray:
    """The operator's values (in `build`'s pattern) of one coefficient
    field of the configuration, drawn from `rng`."""
    f = config["field"]
    g = field(config["grid"], f["sigma2"], f["lambda"], rng)
    return assemble(np.exp(g))[2]


def build(config: dict):
    """The configuration's pattern: the operator of a = 1, as (rows, cols,
    vals, n)."""
    return assemble(np.ones(tuple(int(s) for s in config["grid"])))
