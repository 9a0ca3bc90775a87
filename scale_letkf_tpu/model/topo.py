"""Topography ingestion: the `scale-rm_pp_ens` preprocessing step.

The reference delegates topo/landuse preparation to the external SCALE
library (scale/ensmodel/scale-rm_pp_ens.f90 calls scalerm_prep, which runs
SCALE's CNVTOPO on GTOPO30/DEM50M rasters); the LETKF executables then read
the prepared per-rank topo files (read_topo, common_scale.f90:785).
Here the same step is a single vectorized remap + slope-limited
smoothing producing the global topo array consumed by Grid.calc_z.

Pipeline (cnvtopo equivalent):
  1. read a lat/lon DEM raster (flat binary or .npz),
  2. bilinear/area-average remap onto the model grid's (lon, lat) points,
  3. iterative Laplacian smoothing until the steepest slope is below a
     limit (SCALE's CNVTOPO_(no_)copy smoothing with maximum-slope-angle
     control), as a jit-compiled lax.while_loop,
  4. flatten the lateral halo ring so boundary relaxation sees constant
     terrain.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from scale_letkf_tpu.grid import Grid


def read_dem(path: str, *, nlon: int | None = None, nlat: int | None = None,
             lon0: float | None = None, dlon: float | None = None,
             lat0: float | None = None, dlat: float | None = None):
    """Read a lat/lon DEM. Two layouts:

    - ``.npz`` with arrays ``elev`` (nlat, nlon), ``lon`` (nlon,), ``lat``
      (nlat,);
    - flat binary float32 raster (GrADS-style, the format SCALE's CNVTOPO
      consumes for GTOPO30 tiles) with the geometry passed explicitly.

    Returns (elev (nlat, nlon) float64, lon (nlon,), lat (nlat,)).
    """
    if path.endswith(".npz"):
        d = np.load(path)
        return (np.asarray(d["elev"], np.float64),
                np.asarray(d["lon"], np.float64),
                np.asarray(d["lat"], np.float64))
    if None in (nlon, nlat, lon0, dlon, lat0, dlat):
        raise ValueError("flat-binary DEM needs nlon/nlat/lon0/dlon/lat0/dlat")
    elev = np.fromfile(path, np.float32).astype(np.float64)
    if elev.size != nlon * nlat:
        raise ValueError(f"{path}: size {elev.size} != {nlon}x{nlat}")
    return (elev.reshape(nlat, nlon),
            lon0 + dlon * np.arange(nlon),
            lat0 + dlat * np.arange(nlat))


def remap_dem_to_grid(elev: np.ndarray, dem_lon: np.ndarray,
                      dem_lat: np.ndarray, grid: Grid,
                      supersample: int = 2) -> np.ndarray:
    """DEM raster → model-grid topography (ny, nx).

    Area-averaging remap: each model cell is sampled on a supersample×
    supersample sub-grid of its footprint, each sample bilinear in the DEM
    (CNVTOPO's averaged interpolation). Ocean/missing cells (elev < 0 or
    NaN) clamp to 0.
    """
    ny, nx = grid.ny, grid.nx
    s = max(1, int(supersample))
    # sub-cell fractional offsets in (-0.5, 0.5)
    off = (np.arange(s) + 0.5) / s - 0.5
    oj, oi = np.meshgrid(off, off, indexing="ij")
    jj, ii = np.meshgrid(np.arange(ny, dtype=np.float64),
                         np.arange(nx, dtype=np.float64), indexing="ij")
    ri = (ii[None, None] + oi[:, :, None, None]).reshape(-1, ny, nx)
    rj = (jj[None, None] + oj[:, :, None, None]).reshape(-1, ny, nx)
    lon, lat = grid.ij_to_lonlat(ri, rj)
    lon = np.asarray(lon)
    lat = np.asarray(lat)

    # bilinear sample of the DEM at each (lon, lat)
    fi = np.interp(lon.ravel(), dem_lon, np.arange(len(dem_lon)))
    fj = np.interp(lat.ravel(), dem_lat, np.arange(len(dem_lat)))
    i0 = np.clip(fi.astype(int), 0, len(dem_lon) - 2)
    j0 = np.clip(fj.astype(int), 0, len(dem_lat) - 2)
    ai = np.clip(fi - i0, 0.0, 1.0)
    aj = np.clip(fj - j0, 0.0, 1.0)
    e = np.nan_to_num(elev, nan=0.0)
    v = (e[j0, i0] * (1 - ai) * (1 - aj) + e[j0, i0 + 1] * ai * (1 - aj)
         + e[j0 + 1, i0] * (1 - ai) * aj + e[j0 + 1, i0 + 1] * ai * aj)
    topo = v.reshape(s * s, ny, nx).mean(axis=0)
    return np.maximum(topo, 0.0)


def smooth_topo(topo, dx: float, dy: float,
                max_slope_ratio: float = 0.5,
                itelim: int = 100) -> jax.Array:
    """Slope-limited Laplacian smoothing (CNVTOPO maximum-slope control).

    Repeats a conservative 1-2-1 filter pass until max(|∂h/∂x|, |∂h/∂y|)
    ≤ max_slope_ratio (tan of the maximum slope angle) or `itelim` passes,
    as a single jit-compiled while_loop. The domain-mean elevation is
    preserved by the filter stencil.
    """
    topo = jnp.asarray(topo, jnp.float32)
    inv = jnp.float32(1.0 / min(dx, dy))
    lim = jnp.float32(max_slope_ratio)

    def max_slope(h):
        gx = jnp.abs(jnp.diff(h, axis=1)) / dx
        gy = jnp.abs(jnp.diff(h, axis=0)) / dy
        return jnp.maximum(gx.max(), gy.max())

    def smooth_pass(h):
        hp = jnp.pad(h, 1, mode="edge")
        lap = (hp[1:-1, :-2] + hp[1:-1, 2:] + hp[:-2, 1:-1] + hp[2:, 1:-1]
               - 4.0 * h)
        return h + 0.125 * lap

    def cond(carry):
        h, it = carry
        return (max_slope(h) > lim) & (it < itelim)

    def body(carry):
        h, it = carry
        return smooth_pass(h), it + 1

    h, _ = jax.lax.while_loop(cond, body, (topo, jnp.int32(0)))
    return h


def flatten_halo(topo, width: int = 2) -> jax.Array:
    """Relax the outermost `width` rings toward their mean so lateral
    boundary forcing sees quasi-uniform terrain (the reference's domains
    use buffer zones for the same purpose)."""
    topo = jnp.asarray(topo)
    if width <= 0:
        return topo
    ny, nx = topo.shape
    edge = jnp.concatenate([topo[:width].ravel(), topo[-width:].ravel(),
                            topo[:, :width].ravel(), topo[:, -width:].ravel()])
    mean = edge.mean()
    j = jnp.arange(ny)[:, None]
    i = jnp.arange(nx)[None, :]
    d = jnp.minimum(jnp.minimum(j, ny - 1 - j), jnp.minimum(i, nx - 1 - i))
    w = jnp.clip(d / width, 0.0, 1.0)   # 0 at the edge, 1 inside
    return topo * w + mean * (1.0 - w)


def prepare_topo(elev: np.ndarray, dem_lon: np.ndarray, dem_lat: np.ndarray,
                 grid: Grid, *, max_slope_ratio: float = 0.5,
                 halo_width: int = 2, supersample: int = 2) -> np.ndarray:
    """Full pp step: remap + smooth + halo flatten → (ny, nx) float64."""
    topo = remap_dem_to_grid(elev, dem_lon, dem_lat, grid,
                             supersample=supersample)
    topo = smooth_topo(topo, grid.dx, grid.dy,
                       max_slope_ratio=max_slope_ratio)
    topo = flatten_halo(topo, halo_width)
    return np.asarray(topo, np.float64)
