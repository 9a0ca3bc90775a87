"""Radiation: gray two-stream longwave + Beer-law shortwave.

Vectorized stand-in for the SCALE-RM radiation physics (mstrnX in the
external SCALE library; SURVEY §2.6 lists radiation as a required
capability of the rebuild — the reference's 18-km case steps it every
600 s, BASELINE.md PARAM_TIME). A broadband gray-gas longwave scheme with
water-vapor/cloud/ice absorbers and a single-beam shortwave with Rayleigh
+ vapor + cloud extinction. Flux ladders are `lax.scan`s over the (small,
static) vertical axis operating on whole (ny, nx) slabs — batched across
the horizontal domain, sharding cleanly over the (dy, dx) mesh axes.

Returns heating rates as ρθ tendencies plus the surface radiative budget
terms needed by the slab surface-temperature evolution
(model/physics_suite.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from scale_letkf_tpu.constants import RD, CVDRY, PRE00
from scale_letkf_tpu.model.dycore import DycoreState, moist_pressure

CPDRY = RD + CVDRY
SIGMA_SB = 5.670374e-8

# Broadband gray mass-absorption coefficients [m^2/kg]
K_LW_QV = 0.10
K_LW_CLOUD = 60.0     # liquid (qc+qr)
K_LW_ICE = 30.0       # ice (qi+qs+qg)
K_LW_DRY = 2.0e-4     # well-mixed gases (CO2 etc.)
K_SW_QV = 2.0e-3
K_SW_CLOUD = 30.0
K_SW_RAYLEIGH = 1.0e-5

S0 = 1361.0           # solar constant [W/m^2]


class RadResult(NamedTuple):
    drhot: jax.Array      # ρθ tendency [kg K /m^3 /s] (nz, ny, nx)
    lw_down_sfc: jax.Array   # surface downward LW [W/m^2] (ny, nx)
    sw_down_sfc: jax.Array   # surface downward SW [W/m^2]
    olr: jax.Array           # outgoing LW at TOA [W/m^2]
    heating: jax.Array       # temperature tendency [K/s] (diagnostic)


def _lw_fluxes(temp, trans, emis, tsfc, eps_sfc):
    """Gray longwave flux ladders via scans.

    temp/trans/emis: (nz, ny, nx) layer temperature, transmission,
    emission=1-trans. Returns fluxes on interfaces (nz+1, ny, nx):
    up[k] at the bottom interface of layer k (up[nz]=TOA), down likewise.
    """
    b = SIGMA_SB * temp ** 4

    # upward: from the surface up through the layers
    up0 = eps_sfc * SIGMA_SB * tsfc ** 4

    def up_body(f, row):
        t, e, bb = row
        f_new = f * t + bb * e
        return f_new, f_new

    _, up_rest = jax.lax.scan(up_body, up0, (trans, emis, b))
    up = jnp.concatenate([up0[None], up_rest], axis=0)

    # downward: from TOA (0) down through the layers (reverse scan)
    def dn_body(f, row):
        t, e, bb = row
        f_new = f * t + bb * e
        return f_new, f_new

    zero = jnp.zeros_like(up0)
    _, dn_rest = jax.lax.scan(dn_body, zero, (trans, emis, b),
                              reverse=True)
    down = jnp.concatenate([dn_rest, zero[None]], axis=0)
    return up, down


def radiation_step(s: DycoreState, dz: float, mu0, albedo: float = 0.2,
                   eps_sfc: float = 0.98, tsfc=None) -> RadResult:
    """Compute radiative heating for the current state.

    mu0: cosine solar zenith angle (scalar or (ny, nx)); 0 = night.
    tsfc: surface skin temperature (ny, nx); defaults to the lowest-level
    air temperature.
    """
    rho = s.rho
    q_mr = s.rhoq / rho[None]
    p = moist_pressure(s.rhot, q_mr)
    kappa = RD / CPDRY
    exner = (p / PRE00) ** kappa
    temp = (s.rhot / rho) * exner
    if tsfc is None:
        tsfc = temp[0]

    qv = q_mr[0]
    q_liq = q_mr[1] + q_mr[2]
    q_ice = q_mr[3] + q_mr[4] + q_mr[5]

    dtau_lw = (K_LW_QV * qv + K_LW_CLOUD * q_liq + K_LW_ICE * q_ice
               + K_LW_DRY) * rho * dz
    trans = jnp.exp(-1.66 * dtau_lw)          # 1.66: diffusivity factor
    emis = 1.0 - trans

    up, down = _lw_fluxes(temp, trans, emis, tsfc, eps_sfc)
    net_lw = up - down                         # (nz+1, ny, nx), + upward

    # shortwave: direct beam attenuated from TOA
    mu = jnp.maximum(jnp.asarray(mu0, rho.dtype), 0.0)
    dtau_sw = (K_SW_QV * qv + K_SW_CLOUD * (q_liq + q_ice)
               + K_SW_RAYLEIGH) * rho * dz
    mu_safe = jnp.maximum(mu, 1.0e-3)
    # cumulative optical depth above each interface (top-down)
    tau_above = jnp.cumsum(dtau_sw[::-1], axis=0)[::-1]
    sw_top = S0 * mu
    flux_at_lower = sw_top * jnp.exp(-tau_above / mu_safe)
    sw_down = jnp.concatenate(
        [flux_at_lower, sw_top * jnp.ones_like(flux_at_lower[:1])], axis=0)
    sw_down_sfc = sw_down[0]
    # upward reflected beam: absorbed on the way up with the same dtau
    tau_below = jnp.cumsum(dtau_sw, axis=0) - dtau_sw   # below layer k
    sw_up_sfc = albedo * sw_down_sfc
    sw_up = jnp.concatenate(
        [sw_up_sfc[None] * jnp.ones_like(flux_at_lower[:1]),
         sw_up_sfc * jnp.exp(-(tau_below + dtau_sw) / mu_safe)], axis=0)

    net = net_lw + (sw_up - sw_down)           # + upward
    # heating = -1/(ρ cp) dF_net/dz with F_net positive upward
    div = (net[1:] - net[:-1]) / dz
    heating = -div / (rho * CPDRY)
    drhot = rho * heating / exner
    olr = up[-1]
    lw_down_sfc = down[0]
    return RadResult(drhot=drhot, lw_down_sfc=lw_down_sfc,
                     sw_down_sfc=sw_down_sfc, olr=olr, heating=heating)
