"""Compressible nonhydrostatic finite-volume dynamical core (JAX).

Regional model in JAX providing the capability the reference outsources
to the external SCALE-RM library (reference: scale/ensmodel/scale-rm_ens.f90
runs `scalerm` per member; the state contract it must satisfy is the restart
variable set DENS/MOMX/MOMY/MOMZ/RHOT/QV..QG of common_scale.f90:36-51).

Design (idiomatic XLA, not a port):
- Arakawa C-grid flux-form equations: ρ, ρθ, ρq at cell centers; ρu at
  x-faces, ρv at y-faces, ρw at vertical faces (nz+1 levels, rigid
  top/bottom).
- 3rd-order upwind-biased (UD3) scalar advection, centered momentum
  advection, fully explicit 3-stage Wicker–Skamarock Runge–Kutta; the
  acoustic mode is resolved explicitly (dt limited by vertical sound CFL)
  with 4th-order divergence damping as the acoustic filter.
- Lateral boundaries: periodic via jnp.roll (XLA lowers rolls on sharded
  axes to collective-permutes, so the same code runs single-chip and
  multi-chip), or open via edge-clamped shifts (DycoreConfig.lateral =
  'open': limited-area mode, signals exit the domain; pair with Davies
  boundary forcing — the reference's BDY_FORMAT file forcing,
  config/example/config.main.hakushu:72-78); Rayleigh sponge near the
  model top.
- Everything is pure-functional over a dict pytree so `vmap` provides the
  ensemble axis and `jit`/`shard_map` the device mesh.

Pressure uses the same moist thermodynamics as the DA state contract
(state.py _moist_rtot_cvtot), keeping H(x) and the model consistent.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from scale_letkf_tpu.constants import RD, CVDRY, PRE00, GRAV, RV, TRACER_CV
from scale_letkf_tpu.state import (
    IR_RHO, IR_RHOU, IR_RHOV, IR_RHOW, IR_RHOT, IR_Q0, NQ, NV3D,
)

CPDRY = RD + CVDRY


@dataclass(frozen=True)
class DycoreConfig:
    dx: float
    dy: float
    dz: float                  # nominal vertical spacing (pass a VGrid for stretched levels)
    dt: float                  # model step (one RK3 step)
    divdmp: float = 0.05       # divergence damping coefficient (nondim, of dx²/dt)
    kdiff4: float = 1.0e-3     # 4th-order hyperdiffusion coefficient (nondim)
    sponge_height: float = 0.0 # Rayleigh sponge bottom [m] (0: off)
    sponge_tau: float = 60.0   # sponge damping timescale [s]
    ztop: float = 0.0          # set from grid
    lateral: str = "periodic"  # 'periodic' (ideal) | 'open' (limited-area:
                               # edge-clamped stencils, signals exit; use
                               # with Davies boundary forcing)
    halo: str = "gspmd"        # multi-chip halo backend: 'gspmd' (sharded
                               # rolls auto-lower to collective-permutes) |
                               # 'explicit' (parallel/halo.py shard_map
                               # ppermute, COMM_vars8-style batched) |
                               # 'explicit_overlap' (+ interior compute
                               # overlapped with the exchange)


class DycoreState(NamedTuple):
    """Staggered prognostic fields (C-grid)."""
    rho: jax.Array    # (nz, ny, nx) cell centers
    rhou: jax.Array   # (nz, ny, nx) x-faces (i+1/2)
    rhov: jax.Array   # (nz, ny, nx) y-faces (j+1/2)
    rhow: jax.Array   # (nz+1, ny, nx) z-faces; [0] and [nz] are rigid (0)
    rhot: jax.Array   # (nz, ny, nx) ρθ (moist density-weighted θ)
    rhoq: jax.Array   # (NQ, nz, ny, nx) tracer densities ρq (conservative form)


class VGrid(NamedTuple):
    """Stretched-vertical-level metric (the reference's FZ levels; every
    reference domain uses geometrically stretched dz — PARAM_GRID FZ read
    through scale_calc_z, common_scale.f90:1434-1470). None ⇒ uniform
    cfg.dz everywhere."""
    dzc: jax.Array    # (nz, 1, 1)   cell thickness fz[k+1] − fz[k]
    dzf: jax.Array    # (nz-1, 1, 1) center-to-center spacing cz[k] − cz[k-1]
                      #              (at interior z-faces k = 1..nz-1)


def make_vgrid(cz: np.ndarray, fz: np.ndarray, dtype=jnp.float32) -> VGrid:
    cz = np.asarray(cz, np.float64)
    fz = np.asarray(fz, np.float64)
    return VGrid(
        dzc=jnp.asarray((fz[1:] - fz[:-1])[:, None, None], dtype),
        dzf=jnp.asarray((cz[1:] - cz[:-1])[:, None, None], dtype))


# ---------------------------------------------------------------------------
# Stencil helpers (lateral: periodic roll or open/clamped shift; vertical
# always clamped)
# ---------------------------------------------------------------------------

# Lateral boundary mode, bound at TRACE time by the step entry points from
# DycoreConfig.lateral (the reference's limited-area BDY file forcing vs
# doubly-periodic ideal runs; config/example/config.main.hakushu:72-78
# BDY_FORMAT). The traced graph bakes the choice in: every jit that reaches
# these helpers closes over a DycoreConfig, so distinct modes are distinct
# compilations. 'periodic' wraps (jnp.roll); 'open' shifts with edge-clamped
# ghost values (zero-gradient), so signals LEAVE the domain instead of
# re-entering — pair with Davies relaxation toward boundary targets
# (model/boundary.py) for inflow forcing.
from contextlib import contextmanager

_LATERAL = ["periodic"]


@contextmanager
def lateral_bc(kind: str):
    if kind not in ("periodic", "open"):
        raise ValueError(f"unknown lateral BC {kind!r} "
                         "(valid: 'periodic', 'open')")
    old = _LATERAL[0]
    _LATERAL[0] = kind
    try:
        yield
    finally:
        _LATERAL[0] = old


def _shift_clamp(f, n, axis):
    """Value from index i+n with edge clamp (ghost cells repeat the
    boundary value)."""
    size = f.shape[axis]
    if n > 0:
        main = jax.lax.slice_in_dim(f, n, size, axis=axis)
        edge = jax.lax.slice_in_dim(f, size - 1, size, axis=axis)
        return jnp.concatenate([main] + [edge] * n, axis=axis)
    main = jax.lax.slice_in_dim(f, 0, size + n, axis=axis)
    edge = jax.lax.slice_in_dim(f, 0, 1, axis=axis)
    return jnp.concatenate([edge] * (-n) + [main], axis=axis)


def _roll_x(f, n):  # +n: value from i+n
    if _LATERAL[0] == "open":
        return _shift_clamp(f, n, f.ndim - 1)
    return jnp.roll(f, -n, axis=-1)


def _roll_y(f, n):
    if _LATERAL[0] == "open":
        return _shift_clamp(f, n, f.ndim - 2)
    return jnp.roll(f, -n, axis=-2)


def ud3_face_x(f, mflux):
    """3rd-order upwind-biased face value of center field f at x-face i+1/2,
    selected by the sign of the face mass flux."""
    fm1, f0, fp1, fp2 = _roll_x(f, -1), f, _roll_x(f, 1), _roll_x(f, 2)
    pos = (2.0 * fp1 + 5.0 * f0 - fm1) / 6.0
    neg = (2.0 * f0 + 5.0 * fp1 - fp2) / 6.0
    return jnp.where(mflux >= 0, pos, neg)


def ud3_face_y(f, mflux):
    fm1, f0, fp1, fp2 = _roll_y(f, -1), f, _roll_y(f, 1), _roll_y(f, 2)
    pos = (2.0 * fp1 + 5.0 * f0 - fm1) / 6.0
    neg = (2.0 * f0 + 5.0 * fp1 - fp2) / 6.0
    return jnp.where(mflux >= 0, pos, neg)


def ud3_face_z(f, mflux_w):
    """Face value at interior z-faces (k+1/2, k=0..nz-2), shape (nz-1,...).

    Falls back to centered 2nd order at the faces adjacent to boundaries."""
    nz = f.shape[0]
    # interior high-order (faces 1..nz-2 need f[k-1..k+2])
    pos = (2.0 * f[1:] + 5.0 * f[:-1]
           - jnp.concatenate([f[:1], f[:-2]], axis=0)) / 6.0
    neg = (2.0 * f[:-1] + 5.0 * f[1:]
           - jnp.concatenate([f[2:], f[-1:]], axis=0)) / 6.0
    hi = jnp.where(mflux_w >= 0, pos, neg)
    centered = 0.5 * (f[1:] + f[:-1])
    k = jnp.arange(nz - 1)[:, None, None]
    edge = (k == 0) | (k == nz - 2)
    return jnp.where(edge, centered, hi)


def hyperdiff4(f, coef):
    """Scale-selective 4th-order horizontal hyperdiffusion: -coef ∇⁴f with
    the Laplacian in index space (coef absorbs dx)."""
    lap = (_roll_x(f, 1) + _roll_x(f, -1) + _roll_y(f, 1) + _roll_y(f, -1)
           - 4.0 * f)
    lap2 = (_roll_x(lap, 1) + _roll_x(lap, -1) + _roll_y(lap, 1)
            + _roll_y(lap, -1) - 4.0 * lap)
    return -coef * lap2


# ---------------------------------------------------------------------------
# Thermodynamics
# ---------------------------------------------------------------------------

def moist_pressure(rhot: jax.Array, q: jax.Array) -> jax.Array:
    """p = PRE00 (ρθ R_tot/PRE00)^(Cp_tot/Cv_tot) with the same moist R/CV
    as the DA state transform (state.py / common_scale.f90:1181)."""
    dtype = rhot.dtype
    tracer_cv = jnp.asarray(TRACER_CV, dtype)
    qdry = 1.0 - jnp.sum(q, axis=0)
    cvtot = CVDRY * qdry + jnp.einsum("qkji,q->kji", q, tracer_cv)
    rtot = RD * qdry + RV * q[0]
    cpovcv = (cvtot + rtot) / cvtot
    return PRE00 * (rhot * rtot / PRE00) ** cpovcv


def hydrostatic_reference(theta_prof: np.ndarray, dz: float,
                          p_sfc: float = PRE00,
                          cz: np.ndarray | None = None):
    """Dry hydrostatically balanced reference column ρ̄(z), p̄(z) for a given
    potential-temperature profile at cell centers (numpy, setup-time).

    cz: optional stretched cell-center heights; None ⇒ uniform spacing dz."""
    nz = len(theta_prof)
    if cz is None:
        cz = (np.arange(nz) + 0.5) * dz
    cz = np.asarray(cz, np.float64)
    # integrate hydrostatic balance in Exner function:
    # dπ/dz = -g/(cp θ);  π = (p/p00)^(Rd/cp)
    kappa = RD / CPDRY
    pi_sfc = (p_sfc / PRE00) ** kappa
    pi = np.zeros(nz)
    pi[0] = pi_sfc - GRAV / (CPDRY * theta_prof[0]) * cz[0]
    for k in range(1, nz):
        th_face = 0.5 * (theta_prof[k - 1] + theta_prof[k])
        pi[k] = pi[k - 1] - GRAV / (CPDRY * th_face) * (cz[k] - cz[k - 1])
    p = PRE00 * pi ** (1.0 / kappa)
    t = theta_prof * pi
    rho = p / (RD * t)
    return rho, p


# ---------------------------------------------------------------------------
# Tendencies
# ---------------------------------------------------------------------------

def tendencies(s: DycoreState, cfg: DycoreConfig,
               rho_ref: jax.Array, p_ref: jax.Array,
               vg: VGrid | None = None) -> DycoreState:
    """Flux-form tendencies. rho_ref/p_ref: (nz, 1, 1) reference column.
    vg: stretched vertical spacings (None ⇒ uniform cfg.dz)."""
    dx, dy, dz = cfg.dx, cfg.dy, cfg.dz
    dzc = dz if vg is None else vg.dzc      # cell thickness (centers)
    dzf = dz if vg is None else vg.dzf      # center spacing (interior faces)
    nz = s.rho.shape[0]

    q_mr = s.rhoq / jnp.maximum(s.rho, 1e-10)[None]
    p = moist_pressure(s.rhot, q_mr)
    p_pert = p - p_ref

    # --- mass fluxes at faces
    fx = s.rhou                      # x-face (i+1/2)
    fy = s.rhov                      # y-face (j+1/2)
    fw_int = s.rhow[1:-1]            # interior z-faces (k+1/2, k=0..nz-2)

    def div_center(fx_, fy_, fw_full):
        """Divergence at centers from face fluxes; fw_full has nz+1 levels."""
        ddx = (fx_ - _roll_x(fx_, -1)) / dx
        ddy = (fy_ - _roll_y(fy_, -1)) / dy
        ddz = (fw_full[1:] - fw_full[:-1]) / dzc
        return ddx + ddy + ddz

    # --- continuity
    drho = -div_center(fx, fy, s.rhow)

    # --- scalar advection (ρθ and tracers): flux = mass flux × face value
    def scalar_tend(fcen):
        phi = fcen / s.rho           # mixing-ratio form for consistency
        fl_x = fx * ud3_face_x(phi, fx)
        fl_y = fy * ud3_face_y(phi, fy)
        fl_z_int = fw_int * ud3_face_z(phi, fw_int)
        zeros = jnp.zeros_like(fl_z_int[:1])
        fl_z = jnp.concatenate([zeros, fl_z_int, zeros], axis=0)
        return -div_center(fl_x, fl_y, fl_z) + hyperdiff4(fcen, cfg.kdiff4)

    drhot = scalar_tend(s.rhot)
    drhoq = jax.vmap(scalar_tend)(s.rhoq)

    # --- momentum advection (2nd-order centered) + pressure gradient
    # u-momentum at x-face i+1/2
    u_face = s.rhou / (0.5 * (s.rho + _roll_x(s.rho, 1)))
    v_face = s.rhov / (0.5 * (s.rho + _roll_y(s.rho, 1)))

    # advective fluxes for ρu: x-flux at centers, y-flux at corners, z at face
    fx_c = 0.5 * (fx + _roll_x(fx, -1))              # mass flux at centers
    adv_u_x = fx_c * 0.5 * (u_face + _roll_x(u_face, -1))
    dadv_u = (_roll_x(adv_u_x, 1) - adv_u_x) / dx
    fy_corner = 0.5 * (fy + _roll_x(fy, 1))          # y-mass-flux at (i+1/2, j+1/2)
    adv_u_y = fy_corner * 0.5 * (u_face + _roll_y(u_face, 1))
    dadv_u = dadv_u + (adv_u_y - _roll_y(adv_u_y, -1)) / dy
    fw_xface = 0.5 * (s.rhow + _roll_x(s.rhow, 1))   # (nz+1) at x-faces
    u_zface = jnp.concatenate([
        u_face[:1], 0.5 * (u_face[1:] + u_face[:-1]), u_face[-1:]], axis=0)
    adv_u_z = fw_xface * u_zface
    adv_u_z = adv_u_z.at[0].set(0.0).at[-1].set(0.0)
    dadv_u = dadv_u + (adv_u_z[1:] - adv_u_z[:-1]) / dzc

    dpx = (_roll_x(p_pert, 1) - p_pert) / dx
    drhou = -dadv_u - dpx + hyperdiff4(s.rhou, cfg.kdiff4)

    # v-momentum at y-face j+1/2 (mirror of u)
    fy_c = 0.5 * (fy + _roll_y(fy, -1))
    adv_v_y = fy_c * 0.5 * (v_face + _roll_y(v_face, -1))
    dadv_v = (_roll_y(adv_v_y, 1) - adv_v_y) / dy
    fx_corner = 0.5 * (fx + _roll_y(fx, 1))
    adv_v_x = fx_corner * 0.5 * (v_face + _roll_x(v_face, 1))
    dadv_v = dadv_v + (adv_v_x - _roll_x(adv_v_x, -1)) / dx
    fw_yface = 0.5 * (s.rhow + _roll_y(s.rhow, 1))
    v_zface = jnp.concatenate([
        v_face[:1], 0.5 * (v_face[1:] + v_face[:-1]), v_face[-1:]], axis=0)
    adv_v_z = fw_yface * v_zface
    adv_v_z = adv_v_z.at[0].set(0.0).at[-1].set(0.0)
    dadv_v = dadv_v + (adv_v_z[1:] - adv_v_z[:-1]) / dzc

    dpy = (_roll_y(p_pert, 1) - p_pert) / dy
    drhov = -dadv_v - dpy + hyperdiff4(s.rhov, cfg.kdiff4)

    # w-momentum at interior z-faces (faces 1..nz-1 of the nz+1 faces)
    rho_face_full = jnp.concatenate([
        s.rho[:1], 0.5 * (s.rho[1:] + s.rho[:-1]), s.rho[-1:]], axis=0)
    w_full = s.rhow / rho_face_full                  # (nz+1); 0 at boundaries
    w_face = w_full[1:-1]
    # vertical advective flux of ρw at cell centers k = 0..nz-1
    fw_c = 0.5 * (s.rhow[1:] + s.rhow[:-1])          # mass flux at centers
    adv_w_z = fw_c * 0.5 * (w_full[1:] + w_full[:-1])
    dadv_w = (adv_w_z[1:] - adv_w_z[:-1]) / dzf      # at interior faces
    # horizontal advection of ρw
    fx_zface = 0.5 * (fx[1:] + fx[:-1])              # x-face, interior z-face
    adv_w_x = fx_zface * 0.5 * (w_face + _roll_x(w_face, 1))
    dadv_w = dadv_w + (adv_w_x - _roll_x(adv_w_x, -1)) / dx
    fy_zface = 0.5 * (fy[1:] + fy[:-1])
    adv_w_y = fy_zface * 0.5 * (w_face + _roll_y(w_face, 1))
    dadv_w = dadv_w + (adv_w_y - _roll_y(adv_w_y, -1)) / dy

    dpz = (p_pert[1:] - p_pert[:-1]) / dzf
    rho_pert_face = 0.5 * ((s.rho - rho_ref)[1:] + (s.rho - rho_ref)[:-1])
    buoy = -rho_pert_face * GRAV
    drhow_int = -dadv_w - dpz + buoy + hyperdiff4(s.rhow[1:-1], cfg.kdiff4)
    zeros_face = jnp.zeros_like(s.rhow[:1])
    drhow = jnp.concatenate([zeros_face, drhow_int, zeros_face], axis=0)

    # --- divergence damping (acoustic filter): ∂ρu/∂t += α ∂D/∂x, D=∇·(ρu)
    if cfg.divdmp > 0:
        alpha = cfg.divdmp * dx * dx / cfg.dt
        div = div_center(fx, fy, s.rhow)
        drhou = drhou + alpha * (_roll_x(div, 1) - div) / dx
        drhov = drhov + alpha * (_roll_y(div, 1) - div) / dy
        alpha_z = cfg.divdmp * dzf * dzf / cfg.dt
        drhow = drhow.at[1:-1].add(alpha_z * (div[1:] - div[:-1]) / dzf)

    return DycoreState(rho=drho, rhou=drhou, rhov=drhov, rhow=drhow,
                       rhot=drhot, rhoq=drhoq)


def _axpy(s: DycoreState, t: DycoreState, a: float, dt) -> DycoreState:
    return DycoreState(*(x + a * dt * dx for x, dx in zip(s, t)))


def rayleigh_sponge(s: DycoreState, s0: DycoreState, cfg: DycoreConfig,
                    z_center: jax.Array, dt: float) -> DycoreState:
    """Damp w (and perturbation winds) toward zero above sponge_height."""
    if cfg.sponge_height <= 0:
        return s
    ztop = cfg.ztop
    zs = cfg.sponge_height
    coef_c = jnp.where(z_center > zs,
                       jnp.sin(0.5 * jnp.pi * (z_center - zs) / (ztop - zs)) ** 2,
                       0.0) / cfg.sponge_tau
    dz_lo = z_center[1] - z_center[0]
    dz_hi = z_center[-1] - z_center[-2]
    z_face = jnp.concatenate([z_center[:1] - dz_lo * 0.5,
                              0.5 * (z_center[1:] + z_center[:-1]),
                              z_center[-1:] + dz_hi * 0.5])
    coef_f = jnp.where(z_face > zs,
                       jnp.sin(0.5 * jnp.pi * jnp.clip(
                           (z_face - zs) / (ztop - zs), 0, 1)) ** 2,
                       0.0) / cfg.sponge_tau
    damp_c = 1.0 / (1.0 + dt * coef_c)[:, None, None]
    damp_f = 1.0 / (1.0 + dt * coef_f)[:, None, None]
    return s._replace(rhow=s.rhow * damp_f,
                      rhou=s.rhou * damp_c,
                      rhov=s.rhov * damp_c)


@partial(jax.jit, static_argnames=("cfg",))
def rk3_step(s: DycoreState, cfg: DycoreConfig, rho_ref: jax.Array,
             p_ref: jax.Array, z_center: jax.Array,
             vg: VGrid | None = None) -> DycoreState:
    """One Wicker–Skamarock RK3 step: s1 = s + dt/3 f(s); s2 = s + dt/2 f(s1);
    s3 = s + dt f(s2); then Rayleigh sponge."""
    dt = cfg.dt
    with lateral_bc(cfg.lateral):
        f1 = tendencies(s, cfg, rho_ref, p_ref, vg)
        s1 = _axpy(s, f1, 1.0 / 3.0, dt)
        f2 = tendencies(s1, cfg, rho_ref, p_ref, vg)
        s2 = _axpy(s, f2, 0.5, dt)
        f3 = tendencies(s2, cfg, rho_ref, p_ref, vg)
        s3 = _axpy(s, f3, 1.0, dt)
    return rayleigh_sponge(s3, s, cfg, z_center, dt)


def integrate(s: DycoreState, cfg: DycoreConfig, rho_ref, p_ref, z_center,
              nsteps: int, vg: VGrid | None = None) -> DycoreState:
    """nsteps RK3 steps under lax.scan (single trace, static shapes)."""
    def body(carry, _):
        return rk3_step(carry, cfg, rho_ref, p_ref, z_center, vg), None
    out, _ = jax.lax.scan(body, s, None, length=nsteps)
    return out


# ---------------------------------------------------------------------------
# Conversion between the staggered dycore state and the collocated DA state
# ---------------------------------------------------------------------------

def to_collocated(s: DycoreState) -> jax.Array:
    """Staggered → stacked collocated restart view (..., NV3D, nz, ny, nx).

    Momenta are averaged to cell centers. (The reference stores staggered
    momenta in restarts and lets the DA ignore staggering,
    common_scale.f90:1213; we average, which is strictly more accurate.)"""
    rhou_c = 0.5 * (s.rhou + _roll_x(s.rhou, -1))
    rhov_c = 0.5 * (s.rhov + _roll_y(s.rhov, -1))
    rhow_c = 0.5 * (s.rhow[1:] + s.rhow[:-1])
    core = jnp.stack([s.rho, rhou_c, rhov_c, rhow_c, s.rhot], axis=0)
    q_mr = s.rhoq / jnp.maximum(s.rho, 1e-10)[None]
    return jnp.concatenate([core, q_mr], axis=0)


def from_collocated(v: jax.Array) -> DycoreState:
    """Stacked collocated restart view → staggered dycore state.

    Center momenta are averaged back to faces; w boundary faces reset to 0."""
    rho = v[IR_RHO]
    rhou = 0.5 * (v[IR_RHOU] + _roll_x(v[IR_RHOU], 1))
    rhov = 0.5 * (v[IR_RHOV] + _roll_y(v[IR_RHOV], 1))
    rhow_c = v[IR_RHOW]
    rhow_int = 0.5 * (rhow_c[1:] + rhow_c[:-1])
    zeros = jnp.zeros_like(rhow_c[:1])
    rhow = jnp.concatenate([zeros, rhow_int, zeros], axis=0)
    return DycoreState(rho=rho, rhou=rhou, rhov=rhov, rhow=rhow,
                       rhot=v[IR_RHOT], rhoq=v[IR_Q0:] * rho[None])
