"""Boundary-layer turbulence: local K closure + implicit vertical diffusion.

Vectorized stand-in for the SCALE-RM boundary-layer physics (the reference
runs it inside the external SCALE library; SURVEY §2.6 lists the
boundary-layer scheme as a required capability of the rebuild). A
Richardson-number-dependent first-order local closure (Louis-type, the
level-2 reduction of Mellor-Yamada) diagnoses eddy diffusivities on the
vertical interfaces, and u, v, θ, qv are diffused with a backward-Euler
implicit column solve, with the bulk surface fluxes (model/surface.py) as
an implicit lower boundary condition — unconditionally stable at the long
physics time steps of the reference's configs (30 s physics vs 3 s
dynamics, BASELINE 18-km case).

The tridiagonal solve is the Thomas algorithm expressed as two
`lax.scan`s over the (small, static) vertical dimension; every scan step
processes whole (ny, nx) slabs, so the work is batched across the
horizontal domain and shards cleanly over the (dy, dx) mesh axes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from scale_letkf_tpu.constants import GRAV, RD, CVDRY, PRE00, FVIRT
from scale_letkf_tpu.model.dycore import DycoreState, moist_pressure, \
    _roll_x, _roll_y
from scale_letkf_tpu.model.surface import surface_fluxes, SurfaceFluxes

CPDRY = RD + CVDRY
KARMAN = 0.4
LAMBDA_MIX = 150.0    # asymptotic mixing length [m]
RI_CRIT = 0.25
K_MIN = 1.0e-3        # background diffusivity [m^2/s]
K_MAX = 200.0
PRANDTL = 0.74


def tridiag_solve(lower, diag, upper, rhs):
    """Thomas algorithm over the leading axis, batched over the rest.

    Solves T x = rhs where T has sub/diag/super diagonals `lower` (first
    element unused), `diag`, `upper` (last element unused), each of shape
    (nz, ...).
    """
    def fwd(carry, row):
        cp_prev, dp_prev = carry
        l, d, u, r = row
        denom = d - l * cp_prev
        cp = u / denom
        dp = (r - l * dp_prev) / denom
        return (cp, dp), (cp, dp)

    zero = jnp.zeros_like(diag[0])
    (_, _), (cps, dps) = jax.lax.scan(
        fwd, (zero, zero), (lower, diag, upper, rhs))

    def bwd(x_next, row):
        cp, dp = row
        x = dp - cp * x_next
        return x, x

    _, xs = jax.lax.scan(bwd, zero, (cps, dps), reverse=True)
    return xs


def eddy_diffusivity(u, v, thv, zc, dz):
    """K_m, K_h on interior interfaces (nz-1, ny, nx) from local shear and
    stability (Louis-type level-2 closure)."""
    du = (u[1:] - u[:-1]) / dz
    dv = (v[1:] - v[:-1]) / dz
    s2 = du * du + dv * dv
    thv_i = 0.5 * (thv[1:] + thv[:-1])
    n2 = GRAV / thv_i * (thv[1:] - thv[:-1]) / dz
    ri = n2 / jnp.maximum(s2, 1.0e-10)

    z_i = 0.5 * (zc[1:] + zc[:-1])
    l_mix = KARMAN * z_i / (1.0 + KARMAN * z_i / LAMBDA_MIX)
    l2s = (l_mix ** 2)[:, None, None] * jnp.sqrt(s2)

    f_un = jnp.sqrt(jnp.maximum(1.0 - 16.0 * ri, 1.0))
    f_st = jnp.maximum(1.0 - ri / RI_CRIT, 0.0) ** 2
    f = jnp.where(ri < 0.0, f_un, f_st)
    km = jnp.clip(l2s * f + K_MIN, K_MIN, K_MAX)
    kh = jnp.clip(km / PRANDTL, K_MIN, K_MAX)
    return km, kh


def diffuse_column(phi, rhok_int, rho_c, dt, dz, sfc_coef, sfc_val):
    """Backward-Euler vertical diffusion of cell-centered `phi` (nz,ny,nx).

    rhok_int: ρK at interior interfaces (nz-1,ny,nx); rho_c: ρ at centers.
    Surface exchange enters implicitly: flux = sfc_coef·(sfc_val − φ₁)
    with sfc_coef in kg/m²/s.
    """
    zero = jnp.zeros_like(phi[:1])
    c_up = jnp.concatenate([rhok_int / (rho_c[:-1] * dz * dz), zero],
                           axis=0)
    c_dn = jnp.concatenate([zero, rhok_int / (rho_c[1:] * dz * dz)],
                           axis=0)
    sfc = sfc_coef / (rho_c[0] * dz)

    diag = 1.0 + dt * (c_up + c_dn)
    diag = diag.at[0].add(dt * sfc)
    lower = -dt * c_dn
    upper = -dt * c_up
    rhs = phi.at[0].add(dt * sfc * sfc_val)
    return tridiag_solve(lower, diag, upper, rhs)


class PblResult(NamedTuple):
    state: DycoreState
    sfc: SurfaceFluxes


def pbl_step(s: DycoreState, dt: float, dz: float, zc: jax.Array,
             tsfc: jax.Array, z0: float = 1.0e-2, z0h: float = 1.0e-3,
             beta: float = 1.0) -> PblResult:
    """One surface-layer + PBL-diffusion step on the dycore state.

    `zc` are cell-center heights (nz,), `tsfc` the surface skin
    temperature (ny, nx). Diffuses u, v, θ, qv; mass is untouched.
    """
    rho = s.rho
    u = 0.5 * (s.rhou + _roll_x(s.rhou, -1)) / rho
    v = 0.5 * (s.rhov + _roll_y(s.rhov, -1)) / rho
    theta = s.rhot / rho
    qv = s.rhoq[0] / rho

    q_mr = s.rhoq / rho[None]
    p = moist_pressure(s.rhot, q_mr)
    kappa = RD / CPDRY
    t_full = theta * (p / PRE00) ** kappa
    thv = theta * (1.0 + FVIRT * qv)

    # surface: extrapolate surface pressure hydrostatically from level 0
    psfc = p[0] + rho[0] * GRAV * zc[0]
    sfc = surface_fluxes(u[0], v[0], t_full[0], qv[0], p[0], rho[0],
                         zc[0], tsfc, psfc, z0=z0, z0h=z0h, beta=beta)

    km, kh = eddy_diffusivity(u, v, thv, zc, dz)
    rho_i = 0.5 * (rho[1:] + rho[:-1])
    rkm = rho_i * km
    rkh = rho_i * kh

    zero_val = jnp.zeros_like(tsfc)
    exner_s = ((psfc / PRE00) ** kappa)
    ths = tsfc / exner_s
    from scale_letkf_tpu.model.physics import qsat_liq
    qs_sfc = beta * qsat_liq(tsfc, psfc)

    u_new = diffuse_column(u, rkm, rho, dt, dz, sfc.cd_mod, zero_val)
    v_new = diffuse_column(v, rkm, rho, dt, dz, sfc.cd_mod, zero_val)
    th_new = diffuse_column(theta, rkh, rho, dt, dz, sfc.ch_mod, ths)
    qv_new = diffuse_column(qv, rkh, rho, dt, dz, sfc.ce_mod, qs_sfc)

    # back to staggered momenta: face-average the velocity increments
    du = u_new - u
    dv = v_new - v
    rhou = s.rhou + 0.5 * (du + _roll_x(du, 1)) \
        * 0.5 * (rho + _roll_x(rho, 1))
    rhov = s.rhov + 0.5 * (dv + _roll_y(dv, 1)) \
        * 0.5 * (rho + _roll_y(rho, 1))
    rhot = rho * th_new
    rhoq = s.rhoq.at[0].set(rho * jnp.maximum(qv_new, 0.0))
    return PblResult(
        state=s._replace(rhou=rhou, rhov=rhov, rhot=rhot, rhoq=rhoq),
        sfc=sfc)
