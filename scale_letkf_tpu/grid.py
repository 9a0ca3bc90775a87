"""Grid geometry and map projection for the limited-area domain.

Array-native equivalent of the reference's grid handling (reference:
scale/common/common_scale.f90:117-129 grid sizes and halo convention;
scale_calc_z terrain-following height at common_scale.f90:1434-1495) and
SCALE's map-projection module used through MPRJ_rotcoef / phys2ij
(common_obs_scale.f90:294,1241).

Design: a static `Grid` dataclass carries global geometry; all arrays are
global (the per-device view is produced by jax.sharding, not by index
bookkeeping). Halos are not stored in state arrays — halo exchange happens
inside shard_map at stencil time (parallel/halo.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np
import jax.numpy as jnp

from scale_letkf_tpu.constants import RE, D2R, R2D

HALO = 2  # stencil halo width, matching the reference convention (IHALO=JHALO=KHALO=2)


@dataclass(frozen=True)
class Projection:
    """Conformal map projection (Lambert conformal / Mercator / polar
    stereographic / equirectangular), mirroring the SCALE MPRJ options the
    reference relies on for phys2ij and wind rotation.

    For conformal projections the local map factor is isotropic and winds
    rotate by the angle between grid north and true north; `rotcoef` returns
    (cosθ, sinθ) exactly as MPRJ_rotcoef does.
    """
    kind: str = "LC"          # 'LC' | 'MER' | 'PS' | 'EQ'
    basepoint_lon: float = 135.0
    basepoint_lat: float = 35.0
    lc_lat1: float = 30.0     # Lambert standard parallels
    lc_lat2: float = 40.0

    @cached_property
    def _lc(self):
        """Lambert conformal cone constant and scale."""
        la1, la2 = self.lc_lat1 * D2R, self.lc_lat2 * D2R
        if abs(self.lc_lat1 - self.lc_lat2) < 1e-10:
            n = np.sin(la1)
        else:
            n = (np.log(np.cos(la1)) - np.log(np.cos(la2))) / (
                np.log(np.tan(np.pi / 4 + la2 / 2))
                - np.log(np.tan(np.pi / 4 + la1 / 2)))
        f = np.cos(la1) * np.tan(np.pi / 4 + la1 / 2) ** n / n
        return n, f

    def lonlat_to_xy(self, lon, lat):
        """Lon/lat [deg] → projection coordinates [m] (basepoint at origin).

        Dispatches numpy-vs-jax on the input type: host-side setup calls
        this with large numpy arrays (obs preprocessing), where eager jax
        op-by-op dispatch would pay a device round trip per op;
        traced callers (H(x) inside jit) keep the jnp path."""
        import jax as _jax
        jnp_ = jnp if isinstance(lon, (_jax.Array,)) else np
        lam = (lon - self.basepoint_lon) * D2R
        phi = lat * D2R
        phi0 = self.basepoint_lat * D2R
        if self.kind == "EQ":
            x = RE * np.cos(phi0) * lam
            y = RE * (phi - phi0)
        elif self.kind == "MER":
            x = RE * np.cos(phi0) * lam
            y = RE * np.cos(phi0) * (
                jnp_.log(jnp_.tan(np.pi / 4 + phi / 2))
                - np.log(np.tan(np.pi / 4 + phi0 / 2)))
        elif self.kind == "LC":
            n, f = self._lc
            rho = RE * f / jnp_.tan(np.pi / 4 + phi / 2) ** n
            rho0 = RE * f / np.tan(np.pi / 4 + phi0 / 2) ** n
            x = rho * jnp_.sin(n * lam)
            y = rho0 - rho * jnp_.cos(n * lam)
        elif self.kind == "PS":
            s = np.sign(self.basepoint_lat) or 1.0
            k = 2 * RE / (1 + s * jnp_.sin(phi))
            k0 = 2 * RE / (1 + s * np.sin(phi0))
            x = k * jnp_.cos(phi) * jnp_.sin(lam)
            y = -s * k * jnp_.cos(phi) * jnp_.cos(lam) + s * k0 * np.cos(phi0)
        else:
            raise ValueError(self.kind)
        return x, y

    def xy_to_lonlat(self, x, y):
        import jax as _jax
        jnp_ = jnp if isinstance(x, (_jax.Array,)) else np
        phi0 = self.basepoint_lat * D2R
        if self.kind == "EQ":
            lon = self.basepoint_lon + x / (RE * np.cos(phi0)) * R2D
            lat = (phi0 + y / RE) * R2D
        elif self.kind == "MER":
            c = RE * np.cos(phi0)
            lon = self.basepoint_lon + x / c * R2D
            t = jnp_.exp(y / c) * np.tan(np.pi / 4 + phi0 / 2)
            lat = (2 * jnp_.arctan(t) - np.pi / 2) * R2D
        elif self.kind == "LC":
            n, f = self._lc
            rho0 = RE * f / np.tan(np.pi / 4 + phi0 / 2) ** n
            yy = rho0 - y
            rho = jnp_.sqrt(x * x + yy * yy) * np.sign(n)
            theta = jnp_.arctan2(x, yy)
            lon = self.basepoint_lon + theta / n * R2D
            lat = (2 * jnp_.arctan((RE * f / rho) ** (1.0 / n)) - np.pi / 2) * R2D
        elif self.kind == "PS":
            s = np.sign(self.basepoint_lat) or 1.0
            k0 = 2 * RE / (1 + s * np.sin(phi0))
            yy = y - s * k0 * np.cos(phi0)
            r = jnp_.sqrt(x * x + yy * yy)
            lat = s * (np.pi / 2 - 2 * jnp_.arctan(r / (2 * RE))) * R2D
            lon = self.basepoint_lon + jnp_.arctan2(x, -s * yy) * R2D
        else:
            raise ValueError(self.kind)
        return lon, lat

    def rotcoef(self, lon, lat):
        """(cosθ, sinθ) rotating true-north winds to grid-relative, as
        MPRJ_rotcoef (used at common_obs_scale.f90:294): u_grid = u·c - v·s."""
        lam = (lon - self.basepoint_lon) * D2R
        if self.kind in ("EQ", "MER"):
            one = jnp.ones_like(jnp.asarray(lon, jnp.result_type(lon, 1.0)))
            return one, jnp.zeros_like(one)
        if self.kind == "LC":
            n, _ = self._lc
            ang = n * lam
        else:  # PS
            s = np.sign(self.basepoint_lat) or 1.0
            ang = s * lam
        return jnp.cos(ang), jnp.sin(ang)


@dataclass(frozen=True)
class Grid:
    """Global limited-area grid geometry.

    nx, ny      — global horizontal gridpoint counts (reference nlong/nlatg)
    nz          — vertical levels (reference nlev)
    dx, dy      — horizontal spacing [m]
    cz, fz      — vertical cell centers / faces of the flat reference column [m]
                  (fz has nz+1 entries, fz[0]=0 at the surface)
    """
    nx: int
    ny: int
    nz: int
    dx: float
    dy: float
    cz: np.ndarray = field(repr=False)
    fz: np.ndarray = field(repr=False)
    proj: Projection = field(default_factory=Projection)

    @staticmethod
    def uniform(nx, ny, nz, dx, dy, dz, proj: Projection | None = None) -> "Grid":
        fz = np.arange(nz + 1) * dz
        cz = 0.5 * (fz[:-1] + fz[1:])
        return Grid(nx=nx, ny=ny, nz=nz, dx=dx, dy=dy, cz=cz, fz=fz,
                    proj=proj or Projection())

    @staticmethod
    def stretched(nx, ny, nz, dx, dy, dz0, stretch, proj: Projection | None = None) -> "Grid":
        """Geometrically stretched vertical levels (dz0 at surface)."""
        dzs = dz0 * stretch ** np.arange(nz)
        fz = np.concatenate([[0.0], np.cumsum(dzs)])
        cz = 0.5 * (fz[:-1] + fz[1:])
        return Grid(nx=nx, ny=ny, nz=nz, dx=dx, dy=dy, cz=cz, fz=fz,
                    proj=proj or Projection())

    @property
    def ztop(self) -> float:
        return float(self.fz[-1])

    @cached_property
    def xy(self):
        """Projection coordinates of cell centers, basepoint at domain center."""
        x = (np.arange(self.nx) + 0.5 - self.nx / 2) * self.dx
        y = (np.arange(self.ny) + 0.5 - self.ny / 2) * self.dy
        return x, y

    @cached_property
    def lonlat(self):
        """(lon2d, lat2d) of cell centers, shape (ny, nx) [deg]."""
        x, y = self.xy
        xx, yy = np.meshgrid(x, y)
        lon, lat = self.proj.xy_to_lonlat(xx, yy)
        return np.asarray(lon), np.asarray(lat)

    def calc_z(self, topo):
        """Terrain-following height of cell centers: shape (nz, ny, nx).

        z = (ztop - topo)/ztop · cz + topo  — the same BTF coordinate as the
        reference (common_scale.f90:1434-1459).
        """
        topo = jnp.asarray(topo)
        cz = jnp.asarray(self.cz, topo.dtype)
        return (self.ztop - topo)[None] / self.ztop * cz[:, None, None] + topo[None]

    def calc_z_faces(self, topo):
        """Terrain-following height of cell faces: shape (nz+1, ny, nx)."""
        topo = jnp.asarray(topo)
        fz = jnp.asarray(self.fz, topo.dtype)
        return (self.ztop - topo)[None] / self.ztop * fz[:, None, None] + topo[None]

    def ij_to_lonlat(self, ri, rj):
        """Fractional gridpoint (ri, rj) → lon/lat [deg] (ij2phys analogue,
        common_obs_scale.f90:1264). ri, rj are 0-based cell-center indices."""
        x = (ri + 0.5 - self.nx / 2) * self.dx
        y = (rj + 0.5 - self.ny / 2) * self.dy
        return self.proj.xy_to_lonlat(x, y)

    def lonlat_to_ij(self, lon, lat):
        """Lon/lat → fractional 0-based gridpoint (ri, rj) (phys2ij analogue,
        common_obs_scale.f90:1241)."""
        x, y = self.proj.lonlat_to_xy(lon, lat)
        ri = x / self.dx + self.nx / 2 - 0.5
        rj = y / self.dy + self.ny / 2 - 0.5
        return ri, rj
