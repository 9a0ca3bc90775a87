"""Fused DA cycling: the whole cycle step as ONE jitted device program.

The reference's per-cycle step sequence is five separate executables glued
by bash and the filesystem (scale-rm_ens → obsope → letkf,
scale/run/cycle.sh:141-345); the host-driven pipeline in cycle.py mirrors
that structure with one jitted graph per stage and host work between.
Either way, on an accelerator every stage boundary costs host↔device
round trips, which at small sizes cost more than the cycle's compute.

This module removes the host from the loop entirely for the common
production case of a FIXED observation network (positions/types known up
front, values arriving each cycle — exactly the reference's fixed radar
volume scans in the big-data-assimilation demos, 30-s cycles of a
stationary phased-array radar, config/BDA_d3_100m_256p_bf40):

  ensemble forecast → H(x) → departures → in-graph QC (gross error, radar
  min-member) → localized selection (good-mask aware top-k) → LETKF
  transform → back-transform

is ONE `jax.jit` program; an entire OSSE experiment (nature run + obsmake
+ N cycles) runs as ONE `lax.scan` over cycles with zero host transfers
inside. QC runs in-graph as an obs mask fed to the analysis selection
(ops in da/letkf.py fn obs_good), replacing the host path's array
subsetting — bad obs lose their localization weight before the top-k, so
they neither occupy selection slots nor touch the transform.

Restrictions vs the host pipeline (cycle.py): the obs *template*
(positions, types, errors) is static per FusedCycle instance; radar
reflectivity obs must arrive preprocessed (already in dBZ with ref-zero
relabeling applied — preprocess_radar_obs is value-dependent and would
change the bucket structure); Himawari-8 obs are not supported (their QC
needs the per-member cloud flag pipeline). Use cycle.py for those.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from scale_letkf_tpu.config import Config
from scale_letkf_tpu.obs.types import (
    Observations, ID_RAIN, ID_RADAR_REF, ID_RADAR_REF_ZERO, ID_RADAR_VR,
    ID_H08IR, QC_GOOD,
)
from scale_letkf_tpu.da.letkf import _make_plan, _build_analysis_fn
from scale_letkf_tpu.da.letkf_obs import build_obs_context
from scale_letkf_tpu.da.obsope import compute_hx_single
from scale_letkf_tpu.state import (
    state_trans, state_trans_inv, state_to_history, IA_P, NV3D,
)
from scale_letkf_tpu.model.dycore import to_collocated, from_collocated


class FusedCycle:
    """One-jit DA cycle for a fixed obs network.

    Parameters
    ----------
    driver : cycle.CycleDriver
        Supplies the composed forecast model, grid, config, mesh.
    template : Observations
        The fixed network: elem/typ/lon/lat/lev/err are static; per-cycle
        `dat` values are runtime inputs. Radar obs must be pre-preprocessed
        (dBZ + ref-zero relabeling); H08 unsupported.
    nsteps : int
        Forecast steps per cycle.
    """

    def __init__(self, driver, template: Observations, nsteps: int):
        if np.any(template.elem == ID_H08IR):
            raise NotImplementedError(
                "fused cycling does not support H08 obs (per-member cloud "
                "QC pipeline); use the host pipeline in cycle.py")
        if np.any((template.elem == ID_RADAR_REF)
                  & (template.dat >= 0) & (template.dat < 1e10)
                  & (template.dat > 100.0)):
            raise ValueError(
                "fused cycling needs radar reflectivity pre-converted to "
                "dBZ (preprocess_radar_obs) — template dat looks linear-Z")
        self.driver = driver
        self.template = template
        self.nsteps = int(nsteps)
        cfg: Config = driver.cfg
        grid = driver.grid
        self.cfg = cfg
        self.grid = grid

        # geometric obs context: every template obs enters the buckets (the
        # per-cycle QC is the in-graph good mask, not a host subsetting).
        # structural=True guarantees no value-dependent preprocessing or QC
        # touches the (already preprocessed) template — only static checks
        # (disabled obs kinds, undefined values) run here, so no-rain
        # ref-zero obs keep their bucket slots and dBZ values stay intact.
        template = template.select(slice(None))  # private copy
        r = cfg.radar
        is_ref_t = ((template.elem == ID_RADAR_REF)
                    | (template.elem == ID_RADAR_REF_ZERO))
        if r.use_obserr_radar_ref:   # idempotent err override from
            template.err[is_ref_t] = cfg.obs_error.radar_ref  # preprocess
        if r.use_obserr_radar_vr:
            template.err[template.elem == ID_RADAR_VR] = \
                cfg.obs_error.radar_vr
        self.template = template     # the copy, with err overrides applied
        ctx = build_obs_context(template, None,
                                np.zeros(template.nobs, np.int32), cfg, grid,
                                structural=True)
        if len(ctx.ctypes) == 0:
            raise ValueError("obs template produced no usable ctypes")
        self.ctx = ctx

        from scale_letkf_tpu.da.letkf import _auto_level_chunk
        plan = _make_plan(ctx, cfg, NV3D, has_det=False)
        plan = dataclasses.replace(
            plan, has_obs_good=True,
            level_chunk=_auto_level_chunk(grid.nz, grid.ny * grid.nx,
                                          cfg.letkf.level_batch))
        self._afn = _build_analysis_fn(plan, driver.mesh)
        self._plan = plan

        # static per-obs QC constants (letkf_obs.f90:503-561)
        thr = np.full(template.nobs, cfg.letkf.gross_error)
        thr[template.elem == ID_RAIN] = cfg.letkf.gross_thresh("rain")
        is_ref = ((template.elem == ID_RADAR_REF)
                  | (template.elem == ID_RADAR_REF_ZERO))
        thr[is_ref] = cfg.letkf.gross_thresh("radar_ref")
        thr[template.elem == ID_RADAR_VR] = cfg.letkf.gross_thresh(
            "radar_vr")
        self._gross_thr = jnp.asarray(thr * template.err)
        self._is_ref = jnp.asarray(is_ref)
        self._has_ref = bool(is_ref.any())

        # static grid-batch arrays (same prep as da/letkf.py analyze())
        ny, nx = grid.ny, grid.nx
        xs, ys = grid.xy
        self._gp_x = jnp.asarray(
            np.broadcast_to(xs[None, :], (ny, nx)).reshape(-1))
        self._gp_y = jnp.asarray(
            np.broadcast_to(ys[:, None], (ny, nx)).reshape(-1))
        dist_x = np.minimum(
            np.broadcast_to(xs[None, :], (ny, nx)) - xs[0],
            xs[-1] - np.broadcast_to(xs[None, :], (ny, nx)))
        dist_y = np.minimum(
            np.broadcast_to(ys[:, None], (ny, nx)) - ys[0],
            ys[-1] - np.broadcast_to(ys[:, None], (ny, nx)))
        self._dist_bdy = jnp.asarray(
            np.minimum(dist_x, dist_y).reshape(-1))
        from scale_letkf_tpu.ops.obs_select import gather_candidates
        self._cand = tuple(
            gather_candidates(ct.buckets, self._gp_x, self._gp_y)
            for ct in ctx.ctypes)
        self._obs_x = jnp.asarray(ctx.x)
        self._obs_y = jnp.asarray(ctx.y)
        self._obs_vert = jnp.asarray(ctx.vert)
        self._obs_err = jnp.asarray(ctx.err)
        self._z_zb = jnp.asarray(driver.z_full).reshape(
            grid.nz, ny * nx)

        self.step = jax.jit(self._step)
        self.assimilate = jax.jit(self._assimilate)

    # ----- in-graph pipeline pieces -----

    def _hx_ens(self, gues):
        """Ensemble H(x) + worst-member QC, fully in-graph."""
        d = self.driver
        fields = jax.vmap(
            lambda g: state_to_history(g, d.z_full, d.topo))(gues)
        y, qc = jax.vmap(
            lambda f: compute_hx_single(f, self.template, self.grid,
                                        self.cfg, d.z_full))(fields)
        return y, qc.max(axis=0)

    def _qc_mask(self, y, qc_worst, dep):
        """In-graph QC → good mask: operator QC, gross error, radar
        min-member (letkf_obs.f90:384-561)."""
        r = self.cfg.radar
        good = (qc_worst == QC_GOOD) & (jnp.abs(dep) <= self._gross_thr)
        if self._has_ref:
            mem_ref = (y > r.radar_ref_thres_dbz + 1e-6).sum(axis=0)
            obs_rainy = (jnp.asarray(self.template.dat, y.dtype)
                         > r.radar_ref_thres_dbz + 1e-6)
            need = jnp.where(obs_rainy, r.min_radar_ref_member_obsref,
                             r.min_radar_ref_member)
            good = good & (~self._is_ref | (mem_ref >= need))
        return good

    def _assimilate(self, ens_f, obs_dat, infl0_zb):
        """Forecast-state ensemble + obs values + inflation field →
        (analysis ensemble state, inflation, diag dict)."""
        d = self.driver
        nz, ny, nx = self.grid.nz, self.grid.ny, self.grid.nx
        B = ny * nx
        restart = jax.vmap(to_collocated)(ens_f)
        gues = state_trans(restart)
        K, nv = gues.shape[0], gues.shape[1]
        dtype = gues.dtype

        y, qc_worst = self._hx_ens(gues)
        mean_y = jnp.mean(y, axis=0)
        hdxb = (y - mean_y[None]).T
        obs_dat = jnp.asarray(obs_dat, dtype)
        dep = obs_dat - mean_y
        good = self._qc_mask(y, qc_worst, dep)

        mean = jnp.mean(gues, axis=0)
        pert = gues - mean[None]
        logp = jnp.log(jnp.maximum(mean[IA_P], 1e-3)).reshape(nz, B)
        pert_zkvb = jnp.transpose(pert.reshape(K, nv, nz, B), (2, 0, 1, 3))
        mean_zvb = jnp.transpose(mean.reshape(nv, nz, B), (1, 0, 2))

        anal_kvzb, infl_zb, nobs_zb, _det, _rtps = self._afn(
            pert_zkvb, mean_zvb, infl0_zb, logp, self._z_zb,
            self._gp_x, self._gp_y, self._dist_bdy, self._cand,
            self._obs_x, self._obs_y, self._obs_vert, self._obs_err,
            dep.astype(dtype), hdxb.astype(dtype),
            None, None, None, good)

        anal = anal_kvzb.reshape(K, nv, nz, ny, nx)
        anal_restart = state_trans_inv(
            anal,
            positive_definite_q=self.cfg.letkf.positive_definite_q,
            positive_definite_qhyd=self.cfg.letkf.positive_definite_qhyd)
        ens_out = jax.vmap(from_collocated)(anal_restart)

        ngood = good.sum()
        omb_rmse = jnp.sqrt(
            jnp.sum(jnp.where(good, dep**2, 0.0)) / jnp.maximum(ngood, 1))
        # O−A in obs space from the analysis-mean H(x) (in-graph monitor)
        anal_mean_fields = state_to_history(
            jnp.mean(anal, axis=0), d.z_full, d.topo)
        y_a, _ = compute_hx_single(anal_mean_fields, self.template,
                                   self.grid, self.cfg, d.z_full)
        oma = obs_dat - y_a
        oma_rmse = jnp.sqrt(
            jnp.sum(jnp.where(good, oma**2, 0.0)) / jnp.maximum(ngood, 1))
        diag = {"nobs_used": ngood, "omb_rmse": omb_rmse,
                "oma_rmse": oma_rmse,
                "nobs_per_level": nobs_zb.mean(axis=1)}
        return ens_out, infl_zb, diag

    def _step(self, ens, obs_dat, infl0_zb, t0=0.0):
        """One full cycle: forecast nsteps then assimilate."""
        ens_f = self.driver._fcst_ens_raw(ens, self.nsteps,
                                          jnp.float32(t0))
        ens_a, infl_zb, diag = self._assimilate(ens_f, obs_dat, infl0_zb)
        return ens_a, infl_zb, diag

    def initial_inflation(self):
        nz, ny, nx = self.grid.nz, self.grid.ny, self.grid.nx
        return jnp.full((nz, ny * nx), self.cfg.letkf.infl_mul,
                        jnp.asarray(0.0).dtype)

    # ----- whole-experiment fusion -----

    def _osse_body(self, carry, key):
        """One OSSE cycle: nature forecast → synthetic obs (H(truth)+noise)
        → ensemble forecast → assimilation, with RMSE diagnostics."""
        d = self.driver
        err = jnp.asarray(self.template.err)
        truth, ens, infl = carry
        truth = d._fcst_one(truth, self.nsteps)
        truth_anal = state_trans(to_collocated(truth))
        nf = state_to_history(truth_anal, d.z_full, d.topo)
        y_nat, _ = compute_hx_single(nf, self.template, self.grid,
                                     self.cfg, d.z_full)
        obs_dat = y_nat + err * jax.random.normal(key, err.shape)

        ens_f = d._fcst_ens_raw(ens, self.nsteps, jnp.float32(0.0))
        gues_stack = state_trans(jax.vmap(to_collocated)(ens_f))
        gm = jnp.mean(gues_stack, axis=0)
        rmse_g = jnp.sqrt(jnp.mean((gm[:4] - truth_anal[:4]) ** 2))

        ens_a, infl, diag = self._assimilate(ens_f, obs_dat, infl)
        am_stack = state_trans(jax.vmap(to_collocated)(ens_a))
        am = jnp.mean(am_stack, axis=0)
        rmse_a = jnp.sqrt(jnp.mean((am[:4] - truth_anal[:4]) ** 2))
        out = (rmse_g, rmse_a, diag["omb_rmse"], diag["oma_rmse"],
               diag["nobs_used"])
        return (truth, ens_a, infl), out

    def run_osse(self, truth0, ens0, n_cycles: int, seed: int = 0):
        """Entire twin experiment as one device program: a lax.scan of
        _osse_body over cycles. Returns (truth, ens, series) where series
        holds per-cycle (rmse_gues, rmse_anal, omb, oma, nobs_used) device
        arrays. The jitted scan is shared across calls; each distinct
        n_cycles is one compilation (the scan length is a shape)."""
        if not hasattr(self, "_osse_jit"):
            self._osse_jit = jax.jit(
                lambda c, ks: jax.lax.scan(self._osse_body, c, ks))
        keys = jax.random.split(jax.random.PRNGKey(seed), n_cycles)
        (truth, ens, _infl), series = self._osse_jit(
            (truth0, ens0, self.initial_inflation()), keys)
        return truth, ens, series
