"""Model state contract: restart variables ↔ analysis variables ↔ history view.

Reference semantics reproduced (with citations):
- restart/prognostic set: ρ, ρu, ρv, ρw, ρθ + 6 moisture tracers
  (common_scale.f90:36-51, v3d_name DENS/MOMX/MOMY/MOMZ/RHOT/QV..QG)
- analysis set: u, v, w, T, p, qv, qc, qr, qi, qs, qg (nv3d = 11)
- `state_trans` (common_scale.f90:1181-1226): moist Exner diagnosis of (T, p)
  from (ρθ, ρ, q) with moisture-dependent R_tot, CV_tot
- `state_trans_inv` (common_scale.f90:1229-1289): inverse incl.
  positive-definite clipping of q / hydrometeors
- `state_to_history` (common_scale.f90:1292-1404): analysis vars + rh + height
  → obs-operator field view with surface diagnostics

Array-native design: the state is a flax-free pytree dataclass of stacked
arrays with layout (..., nz, ny, nx) — variables stacked on a leading axis so
member/variable batching vmaps cleanly and XLA fuses the pointwise
thermodynamics into one kernel. No halos are stored; the obs-operator view is
a plain dict of global arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from scale_letkf_tpu.constants import (
    RD, RV, CVDRY, PRE00, TRACER_CV, PSAT0, TETENS_A_LIQ, TETENS_B_LIQ, T00,
)

# Variable index conventions (match reference ordering, common_scale.f90:36-51)
# Restart (prognostic) stacking order:
IR_RHO, IR_RHOU, IR_RHOV, IR_RHOW, IR_RHOT = 0, 1, 2, 3, 4
IR_Q0 = 5  # first moisture tracer (qv); 6 tracers total
# Analysis (LETKF) stacking order:
IA_U, IA_V, IA_W, IA_T, IA_P = 0, 1, 2, 3, 4
IA_Q0 = 5
NV3D = 11
NQ = 6
V3D_RESTART_NAMES = ("DENS", "MOMX", "MOMY", "MOMZ", "RHOT",
                     "QV", "QC", "QR", "QI", "QS", "QG")
V3D_ANAL_NAMES = ("U", "V", "W", "T", "PRES",
                  "QV", "QC", "QR", "QI", "QS", "QG")
# 2-D analysis variables: none by default, as in the reference (nv2d=0 for SCALE)
NV2D = 0


class ModelState(NamedTuple):
    """Prognostic state of the dynamical core (restart view).

    vars: (..., NV3D, nz, ny, nx) stacked [ρ, ρu, ρv, ρw, ρθ, q×6].
    Leading axes are batch axes (e.g. ensemble member).
    """
    vars: jax.Array

    @property
    def rho(self): return self.vars[..., IR_RHO, :, :, :]
    @property
    def rhou(self): return self.vars[..., IR_RHOU, :, :, :]
    @property
    def rhov(self): return self.vars[..., IR_RHOV, :, :, :]
    @property
    def rhow(self): return self.vars[..., IR_RHOW, :, :, :]
    @property
    def rhot(self): return self.vars[..., IR_RHOT, :, :, :]
    @property
    def q(self): return self.vars[..., IR_Q0:IR_Q0 + NQ, :, :, :]


def _moist_rtot_cvtot(q, dtype):
    """R_tot, CV_tot from the 6-tracer moisture set (state_trans inner loop).

    q: (..., NQ, nz, ny, nx) with q[...,0] = qv.
    """
    tracer_cv = jnp.asarray(TRACER_CV, dtype)
    qdry = 1.0 - jnp.sum(q, axis=-4)
    cvtot = CVDRY * qdry + jnp.einsum("...qkji,q->...kji", q, tracer_cv,
                                      preferred_element_type=dtype)
    rtot = RD * qdry + RV * q[..., 0, :, :, :]
    return rtot, cvtot


def state_trans(restart: jax.Array) -> jax.Array:
    """Restart → analysis variables (reference: common_scale.f90:1181-1226).

    restart: (..., NV3D, nz, ny, nx) stacked [ρ, ρu, ρv, ρw, ρθ, q×6]
    returns: same shape stacked [u, v, w, T, p, q×6]

    p = PRE00 (ρθ R_tot / PRE00)^(Cp/Cv);  T = p / (ρ R_tot);
    u = ρu/ρ etc. — like the reference, staggering is ignored here (the
    dycore keeps its own staggered fields; this is the collocated DA view).
    """
    dtype = restart.dtype
    q = restart[..., IR_Q0:, :, :, :]
    rtot, cvtot = _moist_rtot_cvtot(q, dtype)
    cpovcv = (cvtot + rtot) / cvtot

    rho = restart[..., IR_RHO, :, :, :]
    pres = PRE00 * (restart[..., IR_RHOT, :, :, :] * rtot / PRE00) ** cpovcv
    temp = pres / (rho * rtot)

    out = jnp.stack([
        restart[..., IR_RHOU, :, :, :] / rho,
        restart[..., IR_RHOV, :, :, :] / rho,
        restart[..., IR_RHOW, :, :, :] / rho,
        temp,
        pres,
    ], axis=-4)
    return jnp.concatenate([out, q], axis=-4)


def state_trans_inv(anal: jax.Array, *, positive_definite_q: bool = False,
                    positive_definite_qhyd: bool = False) -> jax.Array:
    """Analysis → restart variables (reference: common_scale.f90:1229-1289).

    ρ = p/(R_tot T);  ρθ = PRE00/R_tot (p/PRE00)^(Cv/Cp);  ρu = u·ρ etc.
    Optional positive-definite clipping of qv / hydrometeors before the
    transform, as POSITIVE_DEFINITE_Q/QHYD.
    """
    dtype = anal.dtype
    q = anal[..., IA_Q0:, :, :, :]
    if positive_definite_q:
        q = q.at[..., 0, :, :, :].set(jnp.maximum(q[..., 0, :, :, :], 0.0))
    if positive_definite_qhyd:
        q = q.at[..., 1:, :, :, :].set(jnp.maximum(q[..., 1:, :, :, :], 0.0))
    rtot, cvtot = _moist_rtot_cvtot(q, dtype)
    cvovcp = cvtot / (cvtot + rtot)

    pres = anal[..., IA_P, :, :, :]
    temp = anal[..., IA_T, :, :, :]
    rho = pres / (rtot * temp)
    rhot = PRE00 / rtot * (pres / PRE00) ** cvovcp

    out = jnp.stack([
        rho,
        anal[..., IA_U, :, :, :] * rho,
        anal[..., IA_V, :, :, :] * rho,
        anal[..., IA_W, :, :, :] * rho,
        rhot,
    ], axis=-4)
    return jnp.concatenate([out, q], axis=-4)


def relative_humidity(temp: jax.Array, pres: jax.Array, qv: jax.Array) -> jax.Array:
    """RH [%] over liquid water (Tetens). The reference leaves the history RH
    field unfilled (common_scale.f90:1330 is commented out); we provide it so
    RH observations are assimilable end-to-end."""
    es = PSAT0 * jnp.exp(TETENS_A_LIQ * (temp - T00) / (temp - TETENS_B_LIQ))
    qs = 0.622 * es / jnp.maximum(pres - 0.378 * es, 1.0)
    return 100.0 * qv / qs


def state_to_history(anal: jax.Array, z_full: jax.Array,
                     topo: jax.Array | None = None,
                     z0: float = 1.0e-2,
                     tsfc: jax.Array | None = None) -> dict[str, jax.Array]:
    """Analysis variables → obs-operator field view
    (reference: common_scale.f90:1292-1404).

    anal:   (..., NV3D, nz, ny, nx) analysis-variable stack
    z_full: (nz, ny, nx) terrain-following heights from Grid.calc_z
    topo:   (ny, nx) surface height (None ⇒ flat, topo = 0)
    Returns a dict of named fields; 3-D: u,v,w,t,p,q,qc,qr,qi,qs,qg,rh,hgt;
    2-D surface diagnostics (the reference's nv2dd set, read from the
    external model's history output, common_scale.f90:60-98) are DIAGNOSED
    from the lowest-level state:
      ps   — hydrostatic extrapolation to the surface with the level-1
             virtual temperature
      t2m  — dry-adiabatic (θ-conserving) reduction to 2 m above ground
      u10m/v10m — neutral logarithmic wind-profile reduction to 10 m
      q2m  — level-1 specific humidity (well-mixed surface layer)
    replacing the level-0 copies of earlier versions.

    tsfc: optional (ny, nx) slab skin temperature carried by the physics
    suite (CycleDriver persists it across forecasts). When given, the
    screen diagnostics t2m/q2m/u10m/v10m come from model/surface.py's
    stability-corrected bulk surface layer (Louis scheme) instead of the
    neutral reductions — the physics-consistent analogue of the
    reference's T2/Q2/U10/V10 history fields (common_scale.f90:82-90).
    """
    names3d = ("u", "v", "w", "t", "p", "q", "qc", "qr", "qi", "qs", "qg")
    f = {n: anal[..., i, :, :, :] for i, n in enumerate(names3d)}
    f["rh"] = relative_humidity(f["t"], f["p"], f["q"])
    f["hgt"] = jnp.broadcast_to(z_full, anal.shape[:-4] + z_full.shape)

    from scale_letkf_tpu.constants import GRAV, FVIRT
    if topo is None:
        topo = jnp.zeros(z_full.shape[-2:], z_full.dtype)
    else:
        topo = jnp.asarray(topo, z_full.dtype)
    f["topo"] = jnp.broadcast_to(topo, anal.shape[:-4] + topo.shape)

    t1 = f["t"][..., 0, :, :]
    p1 = f["p"][..., 0, :, :]
    qv1 = jnp.maximum(f["q"][..., 0, :, :], 0.0)
    u1 = f["u"][..., 0, :, :]
    v1 = f["v"][..., 0, :, :]
    z1 = jnp.maximum(z_full[0] - topo, 1.0)      # level-1 height above ground
    tv1 = t1 * (1.0 + FVIRT * qv1)

    kappa = RD / (RD + CVDRY)
    ps = p1 * jnp.exp(GRAV * z1 / (RD * tv1))
    th1 = t1 * (PRE00 / p1) ** kappa
    p2m = ps * jnp.exp(-GRAV * 2.0 / (RD * tv1))
    f["ps"] = ps
    f["t2m"] = th1 * (p2m / PRE00) ** kappa
    r10 = jnp.clip(jnp.log(10.0 / z0)
                   / jnp.log(jnp.maximum(z1, 2.0 * z0) / z0), 0.0, 1.0)
    f["u10m"] = u1 * r10
    f["v10m"] = v1 * r10
    f["q2m"] = qv1

    if tsfc is not None:
        # stability-corrected screen diagnostics from the persisted slab
        # skin state (model/surface.py Louis surface layer)
        from scale_letkf_tpu.model.surface import surface_fluxes
        rho1 = p1 / (RD * tv1)
        sf = surface_fluxes(u1, v1, t1, qv1, p1, rho1, z1,
                            jnp.asarray(tsfc, t1.dtype), ps, z0=z0)
        f["t2m"] = sf.t2
        f["q2m"] = sf.q2
        f["u10m"] = sf.u10
        f["v10m"] = sf.v10
    return f


def ensemble_mean(stack: jax.Array, axis: int = 0) -> jax.Array:
    """Ensemble mean over the member axis (ensmean_grd analogue,
    common_scale.f90:1498-1540)."""
    return jnp.mean(stack, axis=axis)


def ensemble_spread(stack: jax.Array, axis: int = 0) -> jax.Array:
    """Ensemble spread (stdev with 1/(K-1)) (enssprd_grd analogue)."""
    k = stack.shape[axis]
    mean = jnp.mean(stack, axis=axis, keepdims=True)
    var = jnp.sum((stack - mean) ** 2, axis=axis) / (k - 1)
    return jnp.sqrt(var)
