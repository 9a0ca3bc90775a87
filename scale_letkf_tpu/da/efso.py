"""EFSO: ensemble forecast sensitivity to observations (Ota et al. 2013).

The reference carries an EFSO implementation that is not built (reference:
scale/letkf/efso.f90:186, efso_tools.f90 — energy norm `lnorm` :52,
localization advection :158, obs impact :197; das_efso is commented out at
letkf_tools.f90:1170 and the GFS-era modules are absent). This module
provides a working EFSO in JAX.

Estimate of each observation's contribution to forecast-error change:

  ΔJ_j ≈ 1/(K-1) · (δy_j / r_j) · Σ_k (HX^a)_{jk} · s_{jk}
  s_{jk} = Σ_x ρ_loc(x, x_j) · X^f_{k}(x) · C(x) · ē(x)

with X^f the forecast perturbations at evaluation time, C the (moist) total
energy weights, ē the mean of the forecast errors from the analysis and the
background (e_{t|0} + e_{t|-6})/2 against a verifying analysis.

Array-native step: the per-obs localized sums s are a GAUSSIAN CONVOLUTION of
the K weighted error fields, computed with separable 1-D convolutions over
(x, y[, z]) and then sampled at the obs locations — O(K · ngrid · kernel)
as dense array work, instead of the reference's per-obs gridpoint
loops. Negative ΔJ = beneficial observation.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from scale_letkf_tpu.constants import RD, CVDRY, PRE00
from scale_letkf_tpu.grid import Grid
from scale_letkf_tpu.obs.operators import itpl_3d
from scale_letkf_tpu.state import IA_U, IA_V, IA_T, IA_P, IA_Q0

CPDRY = RD + CVDRY
LHV = 2.501e6
TR = 280.0      # reference temperature  (efso_tools lnorm conventions)
PR = 1.0e5      # reference pressure
WQ = 1.0        # moist-energy switch weight


def energy_weights(nv: int, wq: float = WQ) -> np.ndarray:
    """Per-variable weights of the (moist) total energy norm
    (efso_tools.f90:52 lnorm): ½(u² + v² + cp/Tr·T² + wq·L²/(cp·Tr)·q²)."""
    w = np.zeros(nv)
    w[IA_U] = 1.0
    w[IA_V] = 1.0
    w[IA_T] = CPDRY / TR
    w[IA_Q0] = wq * LHV**2 / (CPDRY * TR)
    w[IA_P] = RD * TR / PR**2
    return 0.5 * w


def _gauss_kernel_1d(sigma_cells: float, cutoff_fac: float = 3.65):
    half = max(1, int(np.ceil(sigma_cells * cutoff_fac)))
    x = np.arange(-half, half + 1)
    k = np.exp(-0.5 * (x / max(sigma_cells, 1e-6)) ** 2)
    k[np.abs(x) > sigma_cells * cutoff_fac] = 0.0
    return jnp.asarray(k, jnp.float32)


def _conv1d(field: jax.Array, kernel: jax.Array, axis: int) -> jax.Array:
    """Same-size 1-D convolution along `axis` (zero-padded)."""
    moved = jnp.moveaxis(field, axis, -1)
    shape = moved.shape
    flat = moved.reshape(-1, 1, shape[-1])
    out = jax.lax.conv_general_dilated(
        flat, kernel.reshape(1, 1, -1).astype(flat.dtype),
        window_strides=(1,), padding="SAME")
    return jnp.moveaxis(out.reshape(shape), -1, axis)


def localized_sums(fields: jax.Array, sigma_x: float, sigma_y: float,
                   sigma_z: float) -> jax.Array:
    """Gaussian-localized running sums of (K, nz, ny, nx) fields via
    separable convolutions (σ in cell units; σ ≤ 0 skips that axis)."""
    out = fields
    if sigma_x > 0:
        out = _conv1d(out, _gauss_kernel_1d(sigma_x), -1)
    if sigma_y > 0:
        out = _conv1d(out, _gauss_kernel_1d(sigma_y), -2)
    if sigma_z > 0:
        out = _conv1d(out, _gauss_kernel_1d(sigma_z), -3)
    return out


def advected_obs_coords(
    obs_ri: jax.Array, obs_rj: jax.Array, obs_rk: jax.Array,
    u_mean: jax.Array, v_mean: jax.Array,   # (nz, ny, nx) ½(u_anal + u_fcst)
    grid: Grid,
    adv_time: float,                        # evaluation period eft [s]
    locadv_rate: float = 1.0,               # LOCADV_RATE
) -> tuple[jax.Array, jax.Array]:
    """Advected localization (loc_advection, efso_tools.f90:158): the
    reference shifts each gridpoint upstream by −½(ua+uf)·rate·eft before
    measuring its distance to an obs; equivalently (for winds smooth on the
    localization scale) the obs sampling location moves DOWNSTREAM with the
    mean wind interpolated at the obs — which is how the convolution
    formulation applies it: sample the localized sums at the advected
    coordinates."""
    u_at = itpl_3d(u_mean, obs_rk, obs_ri, obs_rj)
    v_at = itpl_3d(v_mean, obs_rk, obs_ri, obs_rj)
    d = locadv_rate * adv_time
    return obs_ri + d * u_at / grid.dx, obs_rj + d * v_at / grid.dy


def efso_impact(
    obs_ri: jax.Array,          # (nobs,) fractional x-index of each obs
    obs_rj: jax.Array,
    obs_rk: jax.Array,          # fractional level (0 for surface obs)
    dep: jax.Array,             # (nobs,) innovations y - H(x̄b)
    rdiag: jax.Array,           # (nobs,) obs error variances
    hdxa: jax.Array,            # (nobs, K) ANALYSIS ensemble obs perturbations
    fcst_pert: jax.Array,       # (K, nv, nz, ny, nx) forecast perturbations at t
    err_mean: jax.Array,        # (nv, nz, ny, nx) (e_{t|0}+e_{t|-6})/2
    grid: Grid,
    hori_scale: float,          # localization scale [m]
    vert_scale_cells: float = 0.0,
    u_adv: jax.Array | None = None,   # (nz, ny, nx) ½(ua+uf) for advected
    v_adv: jax.Array | None = None,   # localization (None: no advection)
    adv_time: float = 0.0,            # evaluation period eft [s]
    locadv_rate: float = 1.0,
) -> jax.Array:
    """Per-obs forecast-error impact ΔJ (negative = beneficial)."""
    if u_adv is not None and adv_time > 0:
        obs_ri, obs_rj = advected_obs_coords(
            obs_ri, obs_rj, obs_rk, u_adv, v_adv, grid, adv_time,
            locadv_rate)
    K = fcst_pert.shape[0]
    w_var = jnp.asarray(energy_weights(fcst_pert.shape[1]),
                        fcst_pert.dtype)
    # F_k(x) = Σ_v w_v · Xf_k,v(x) · ē_v(x)
    f_k = jnp.einsum("mv...,v...,v->m...", fcst_pert, err_mean, w_var)

    sig_x = hori_scale / grid.dx
    sig_y = hori_scale / grid.dy
    s_k = localized_sums(f_k, sig_x, sig_y, vert_scale_cells)  # (K, nz, ny, nx)

    # sample at obs locations
    s_at_obs = jax.vmap(lambda f: itpl_3d(f, obs_rk, obs_ri, obs_rj))(s_k)
    # ΔJ_j = 1/(K-1) · dep_j/r_j · Σ_k hdxa_jk s_kj
    inner = jnp.einsum("jm,mj->j", hdxa, s_at_obs)
    return dep / rdiag * inner / (K - 1)
