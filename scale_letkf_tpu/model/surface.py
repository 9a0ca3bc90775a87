"""Bulk surface-layer scheme (Louis 1979) + screen-level diagnostics.

The reference system runs the SCALE library's surface/land physics inside
the external model (SURVEY §2.6: the SCALE-RM physics suite is outside the
reference repo but is a required capability; the DA side consumes its
screen-level outputs u10m/v10m/t2m/q2m through the history state,
reference: scale/common/common_scale.f90:60-98 nv2dd fields). This module
is the vectorized surface layer: fully vectorized over (ny, nx), no
iterative Monin-Obukhov solve (the Louis analytic stability functions are
the standard non-iterative formulation, giving branch-free XLA-friendly
code).

Outputs both the surface fluxes (lower boundary condition of the PBL
vertical diffusion, model/pbl.py) and the 10-m wind / 2-m temperature and
humidity diagnostics that populate the history 2-D fields.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from scale_letkf_tpu.constants import GRAV, RD, CVDRY, PRE00, FVIRT
from scale_letkf_tpu.model.physics import qsat_liq

CPDRY = RD + CVDRY
KARMAN = 0.4
LHV = 2.501e6


class SurfaceFluxes(NamedTuple):
    """Kinematic surface fluxes and exchange diagnostics, all (ny, nx)."""
    taux: jax.Array     # momentum flux u [kg/m/s^2] (ρ CD |U| u1, down = +)
    tauy: jax.Array
    shf: jax.Array      # sensible heat flux [W/m^2] (+: surface → atmos)
    lhf: jax.Array      # latent heat flux [W/m^2]
    wtheta: jax.Array   # kinematic θ flux ρ⁻¹ SH/cp [K m/s]
    wq: jax.Array       # kinematic moisture flux [kg/kg m/s]
    ch_mod: jax.Array   # ρ C_H |U| [kg/m^2/s] (implicit-BC coefficient)
    ce_mod: jax.Array   # ρ C_E |U|
    cd_mod: jax.Array   # ρ C_D |U|
    ustar: jax.Array    # friction velocity [m/s]
    u10: jax.Array      # 10-m wind components (log-profile reduction)
    v10: jax.Array
    t2: jax.Array       # 2-m temperature [K]
    q2: jax.Array       # 2-m specific humidity [kg/kg]


def louis_stability(rib: jax.Array, z1_over_z0: jax.Array,
                    a2: jax.Array):
    """Louis (1979) analytic stability functions f_m, f_h of the bulk
    Richardson number. b=c=d=5 (the classical coefficients)."""
    b = 5.0
    c = 5.0
    d = 5.0
    sq = jnp.sqrt(jnp.maximum(-rib, 0.0) * z1_over_z0)
    denom_m = 1.0 + 3.0 * b * c * a2 * sq
    fm_un = 1.0 - 2.0 * b * rib / denom_m
    fh_un = 1.0 - 3.0 * b * rib / denom_m
    rib_p = jnp.maximum(rib, 0.0)
    fm_st = 1.0 / (1.0 + 2.0 * b * rib_p / jnp.sqrt(1.0 + d * rib_p))
    fh_st = 1.0 / (1.0 + 3.0 * b * rib_p * jnp.sqrt(1.0 + d * rib_p))
    unstable = rib < 0.0
    fm = jnp.where(unstable, fm_un, fm_st)
    fh = jnp.where(unstable, fh_un, fh_st)
    return fm, fh


def surface_fluxes(u1, v1, t1, qv1, p1, rho1, z1, tsfc, psfc,
                   z0: float = 1.0e-2, z0h: float = 1.0e-3,
                   beta: float = 1.0, min_wind: float = 0.5
                   ) -> SurfaceFluxes:
    """Bulk aerodynamic surface fluxes from lowest-model-level state.

    All field arguments are (ny, nx) slabs. `beta` is the surface
    evaporation efficiency (1 over water). `min_wind` is the gustiness
    floor applied to |U| (prevents flux collapse in calm columns).
    """
    kappa = RD / CPDRY
    exner1 = (p1 / PRE00) ** kappa
    exner_s = (psfc / PRE00) ** kappa
    th1 = t1 / exner1
    ths = tsfc / exner_s
    qs_sfc = beta * qsat_liq(tsfc, psfc)
    thv1 = th1 * (1.0 + FVIRT * qv1)
    thvs = ths * (1.0 + FVIRT * qs_sfc)

    wind = jnp.sqrt(u1 * u1 + v1 * v1)
    wind = jnp.maximum(wind, min_wind)

    rib = (GRAV * z1 * (thv1 - thvs)
           / (0.5 * (thv1 + thvs) * wind * wind))
    ln_m = jnp.log(z1 / z0)
    ln_h = jnp.log(z1 / z0h)
    a2_m = (KARMAN / ln_m) ** 2
    a2_h = KARMAN * KARMAN / (ln_m * ln_h)
    fm, fh = louis_stability(rib, z1 / z0, a2_m)
    cd = a2_m * fm
    ch = a2_h * fh
    ce = ch  # moisture exchange = heat exchange (standard bulk assumption)

    cd_mod = rho1 * cd * wind
    ch_mod = rho1 * ch * wind
    ce_mod = rho1 * ce * wind

    taux = cd_mod * u1
    tauy = cd_mod * v1
    wtheta = ch * wind * (ths - th1)
    wq = ce * wind * (qs_sfc - qv1)
    shf = rho1 * CPDRY * wtheta * exner_s
    lhf = rho1 * LHV * wq
    ustar = jnp.sqrt(jnp.sqrt(taux ** 2 + tauy ** 2) / rho1)

    # screen-level diagnostics: neutral log-profile reduction between the
    # surface value and level 1 (history fields u10m/v10m/t2m/q2m,
    # common_scale.f90:82-90)
    r10 = jnp.log(jnp.maximum(10.0, z0 * 2.0) / z0) / ln_m
    r2 = jnp.log(jnp.maximum(2.0, z0h * 2.0) / z0h) / ln_h
    u10 = u1 * jnp.minimum(r10, 1.0)
    v10 = v1 * jnp.minimum(r10, 1.0)
    t2 = (ths + (th1 - ths) * jnp.minimum(r2, 1.0)) * exner_s
    q2 = qs_sfc + (qv1 - qs_sfc) * jnp.minimum(r2, 1.0)

    return SurfaceFluxes(taux=taux, tauy=tauy, shf=shf, lhf=lhf,
                         wtheta=wtheta, wq=wq, ch_mod=ch_mod,
                         ce_mod=ce_mod, cd_mod=cd_mod, ustar=ustar,
                         u10=u10, v10=v10, t2=t2, q2=q2)
