"""Observation-operator driver: ensemble H(x) over assimilation-window slots.

Equivalent of the reference's integrated obs operator `obsope_cal`
(reference: scale/obs/obsope_tools.f90:38-762): horizontal localization of
obs to grid coordinates, per-slot matching of obs against model history
states (4-D LETKF, SLOT_* config in common_nml.f90:89-92), per-member
forward operator, and QC aggregation across members.

Array-native design: members and obs are dense batch axes. For each time slot,
all obs in that slot go through the vectorized operators against each
member's history fields (vmapped over members); there is no per-rank obs
bucketing — the device mesh sees the full obs vector and the sharded fields.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from scale_letkf_tpu.config import Config
from scale_letkf_tpu.grid import Grid
from scale_letkf_tpu.obs.types import (
    Observations, ObsDataset, ID_PS, ID_RADAR_REF, ID_RADAR_REF_ZERO,
    ID_RADAR_VR, ID_H08IR, QC_GOOD, QC_OUT_H, QC_TIME, TYP_PHARAD,
)
from scale_letkf_tpu.obs import operators as op
from scale_letkf_tpu.obs.h08 import trans_xtoy_h08


def is_radar_elem(elem: np.ndarray) -> np.ndarray:
    return ((elem == ID_RADAR_REF) | (elem == ID_RADAR_REF_ZERO)
            | (elem == ID_RADAR_VR))


def assign_slots(dif: np.ndarray, cfg: Config) -> np.ndarray:
    """Time slot per obs (obsope_tools.f90:256: ceil(dif/Tslot - 0.5) + base)."""
    o = cfg.obsope
    return (np.ceil(dif / o.slot_tinterval - 0.5) + o.slot_base).astype(np.int32)


@dataclass
class ObsOpeResult:
    """Per-obs ensemble H(x) with QC (obs_da_value analogue).

    ensval STAYS ON DEVICE (jax.Array): the reference materializes it on
    every rank via MPI allreduce (obs_da_value_allreduce,
    common_mpi_scale.f90:1879); here it feeds the jitted analysis directly
    and the O(K·nobs) matrix never crosses the host boundary. The small
    (nobs,) QC/aux vectors are host numpy — they drive the data-dependent
    bucket construction."""
    ensval: np.ndarray | jax.Array   # (K, nobs)
    qc: np.ndarray        # (nobs,) worst QC across members
    lev: np.ndarray | None = None    # (nobs,) H08 sensitive pressure [Pa]
    val2: np.ndarray | None = None   # (nobs,) H08 clear-sky BT [K]


def compute_hx_single(
    fields: dict[str, jax.Array],
    obs: Observations,
    grid: Grid,
    cfg: Config,
    z_full: jax.Array,
    with_aux: bool = False,
) -> tuple[jax.Array, ...]:
    """H(x) of one member's history fields for all obs. Returns (y, qc),
    or (y, qc, lev, val2) when with_aux (H08 sensitive pressure +
    clear-sky BT; zeros for non-H08 obs)."""
    lon = jnp.asarray(obs.lon)
    lat = jnp.asarray(obs.lat)
    lev = jnp.asarray(obs.lev)
    elem = jnp.asarray(obs.elem)
    ri, rj = grid.lonlat_to_ij(lon, lat)

    radar = jnp.asarray(is_radar_elem(obs.elem))
    # the radar branch is gated HOST-side (like H08 below): conventional
    # workloads pay nothing for the radar operator, and on very large
    # grids (the 480x360x36 18-km domain) the unused radar interpolations
    # would be fused into the conventional graph
    has_radar = bool(np.any(is_radar_elem(obs.elem)))

    # vertical coordinate: z for radar obs, log-p for conventional
    rk_p, qc_p = op.phys2ijk(fields["p"], elem, ri, rj, lev)
    if has_radar:
        rk_z, qc_z = op.phys2ijkz(z_full, ri, rj, lev)
        rk = jnp.where(radar, rk_z, rk_p)
        qc_vert = jnp.where(radar, qc_z, qc_p)
    else:
        rk, qc_vert = rk_p, qc_p

    y_conv, qc_conv = op.trans_xtoy_conv(
        elem, ri, rj, rk, lon, lat, fields, grid.proj.rotcoef,
        ps_adjust_thres=cfg.letkf.ps_adjust_thres)
    y = y_conv
    qc = qc_conv.astype(jnp.int32)
    if has_radar:
        y_rad, qc_rad = op.trans_xtoy_radar(
            elem, ri, rj, rk, lon, lat, lev,
            tuple(obs.meta), fields, grid.proj.rotcoef,
            method=cfg.radar.method_ref_calc,
            use_terminal_velocity=cfg.radar.use_terminal_velocity,
            min_radar_ref=cfg.radar.min_radar_ref,
            min_radar_ref_dbz=cfg.radar.min_radar_ref_dbz,
            low_ref_shift=cfg.radar.low_ref_shift)
        y = jnp.where(radar, y_rad, y_conv)
        qc = jnp.where(radar, qc_rad, qc_conv).astype(jnp.int32)
    qc = jnp.maximum(qc, qc_vert)
    if has_radar:
        # radar height limit (RADAR_ZMAX, common_nml.f90:278; QC radar_vhi)
        qc = jnp.where(radar & (lev > cfg.radar.radar_zmax), 19, qc)

    # Himawari-8 IR radiances (Trans_XtoY_H08; channel stored in obs lev,
    # letkf_obs.f90:463-465) — gated host-side so non-H08 workloads pay
    # nothing for the radiative transfer.
    lev_aux = jnp.zeros(elem.shape)
    val2 = jnp.zeros(elem.shape)
    if bool(np.any(obs.elem == ID_H08IR)):
        h = cfg.h08
        y_h, bclr, plev, qc_h = trans_xtoy_h08(
            lev, ri, rj, lon, lat, fields,
            ch_use=h.h08_ch_use, cldsky_thrs=h.h08_cldsky_thrs,
            reject_land=h.h08_reject_land)
        ny, nx = fields["ps"].shape[-2:]
        out_h = (ri < 0) | (ri > nx - 1) | (rj < 0) | (rj > ny - 1)
        qc_h = jnp.where(out_h, QC_OUT_H, qc_h)
        is_h08 = elem == ID_H08IR
        y = jnp.where(is_h08, y_h, y)
        qc = jnp.where(is_h08, qc_h, qc)     # H08 bypasses phys2ijk QC
        lev_aux = jnp.where(is_h08, plev, 0.0)
        val2 = jnp.where(is_h08, bclr, 0.0)
    if with_aux:
        return y, qc, lev_aux, val2
    return y, qc


def obsope_ensemble(
    hist_fields: dict[str, jax.Array],   # each (K, [slots,] nz, ny, nx) or 2-D
    obs: Observations,
    grid: Grid,
    cfg: Config,
    z_full: jax.Array,
    slots: np.ndarray | None = None,     # per-obs slot index (None: single slot)
) -> ObsOpeResult:
    """Ensemble H(x). hist_fields values carry a leading member axis; if a
    slot axis is present (K, S, ...), obs are matched to their time slot
    (4-D LETKF; the analysis itself stays 3-D, obsope_tools.f90:431-508)."""
    has_slots = hist_fields["t"].ndim == 5

    def member_hx(fields_k):
        return compute_hx_single(fields_k, obs, grid, cfg, z_full,
                                 with_aux=True)

    if not has_slots:
        y, qc, lev, v2 = jax.vmap(member_hx)(hist_fields)
        return ObsOpeResult(ensval=y, qc=np.asarray(qc.max(axis=0)),
                            lev=np.asarray(lev.mean(axis=0)),
                            val2=np.asarray(v2.mean(axis=0)))

    # 4-D window: each obs is evaluated ONLY against its own time slot
    # (obsope_tools.f90:431-508 processes the per-slot subsets). The host
    # partitions the obs by slot, pads each subset to a power-of-two bucket
    # (stable jit cache across cycles: subset sizes are data-dependent),
    # and scatters the per-slot results back into original obs order —
    # 1x the forward-operator work instead of n_slots x.
    n_slots = hist_fields["t"].shape[1]
    slots_np = np.asarray(slots)
    sl = np.clip(slots_np - cfg.obsope.slot_start, 0, n_slots - 1)
    in_window = ((slots_np >= cfg.obsope.slot_start)
                 & (slots_np <= cfg.obsope.slot_end))
    K = hist_fields["t"].shape[0]
    nobs = obs.nobs
    y = jnp.zeros((K, nobs))
    qc = jnp.zeros((K, nobs), jnp.int32)
    lev = jnp.zeros((K, nobs))
    v2 = jnp.zeros((K, nobs))
    for s in range(n_slots):
        m = np.nonzero(sl == s)[0]
        if len(m) == 0:
            continue
        nb = 64
        while nb < len(m):
            nb *= 2
        mp = np.concatenate([m, np.full(nb - len(m), m[-1])])
        obs_s = obs.select(mp)
        f_s = {k: v[:, s] for k, v in hist_fields.items()}
        y_s, qc_s, lev_s, v2_s = jax.vmap(
            lambda fk: compute_hx_single(fk, obs_s, grid, cfg, z_full,
                                         with_aux=True))(f_s)
        midx = jnp.asarray(m)
        n = len(m)
        y = y.at[:, midx].set(y_s[:, :n])
        qc = qc.at[:, midx].set(qc_s[:, :n])
        lev = lev.at[:, midx].set(lev_s[:, :n])
        v2 = v2.at[:, midx].set(v2_s[:, :n])
    qc_w = np.asarray(qc.max(axis=0))
    qc_w = np.where(in_window, qc_w, QC_TIME)
    return ObsOpeResult(ensval=y, qc=qc_w,
                        lev=np.asarray(lev.mean(axis=0)),
                        val2=np.asarray(v2.mean(axis=0)))
