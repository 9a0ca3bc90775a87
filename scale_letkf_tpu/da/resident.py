"""Device-resident full-size DA cycle: the ensemble lives in device memory.

The member-streamed executor (da/bigcycle.py) moves the whole state
across the host↔device link every cycle. The reference never pays this
cost — its state lives in the 48x50 ranks' memory
(common_mpi_scale.f90:367-512). This executor is the single-card
equivalent: the WHOLE K-member ensemble stays resident in device memory,
compressed as

    mean  : (NV3D, nz, ny, nx) float32   — ensemble mean, analysis vars
    dev   : (K, NV3D, nz, ny, nx) bfloat16 — member deviations from a
            float32 reference mean

which fits both flagship configs (radar 192x192x48 K=50: 2.0 GB;
18-km 480x360x36 K=50: 6.9 GB — vs 13.7 GB uncompressed f32). The
mean/deviation split preserves increment-relative precision (storing
whole members in bf16 quantizes T≈280 K at ~1 K, da/letkf_tiled.py);
deviations carry bf16's 0.4% relative error of the DEVIATION magnitude,
which is the same order as the bf16 perturbation transport the streamed
executor already uses.

Phases (all device-side; zero steady-state host↔device traffic):

- forecast: member batches are SLICED from the resident buffers
  (dynamic_slice), reconstructed to prognostic state (state_trans_inv),
  integrated (with the full production composition: physics suite slab
  state resident as a (K, ny, nx) buffer, terrain, boundary forcing,
  4-D slot H(x) — same segment logic as da/bigcycle.py), and the
  analysis-variable results written back IN PLACE (buffer donation +
  dynamic_update_slice). The forecast-mean accumulator makes deviations
  rebasable: after the phase, member_i = mean_ref + dev_i with
  mean_new = accum/K, so analysis perturbations are
  dev_i - (mean_new - mean_ref) — exact in f32 up to the bf16 storage.
- analysis: row tiles are sliced from the resident buffers on device and
  updated in place (the da/letkf.py tile program); the obs-space arrays
  and bucket tables are uploaded once.
- H(x): rides the forecast batches; (K, nobs) ensval stays on device
  (consumed directly by build_obs_context's device path).

The host-streamed executors (da/bigcycle.py + da/letkf_tiled.py) remain
the capability path for domains whose bf16 ensemble exceeds HBM.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial

import numpy as np

from scale_letkf_tpu.obs.types import Observations, QC_TIME
from scale_letkf_tpu.da.bigcycle import (
    _batch_of, _slot_parts, _log, bdy_batch)


def _donate():
    """Whether the in-place updates donate their input buffers. The CPU
    backend ignores donation (with a warning); every other backend reuses
    the donated buffer, so the update is not a full copy."""
    import jax
    return jax.default_backend() != "cpu"


class ResidentEnsemble:
    """HBM-resident ensemble in analysis variables (mean/deviation split).

    Invariant between cycles: member_i = ref + dev_i where ref == mean.
    During a cycle the forecast phase moves mean ahead of ref (devs stay
    against ref until the analysis rebases them)."""

    def __init__(self, mean, dev, ref=None, tsfc=None, infl=None):
        self.mean = mean            # (NV3D, nz, ny, nx) f32
        self.dev = dev              # (K, NV3D, nz, ny, nx) bf16
        self.ref = mean if ref is None else ref
        self.tsfc = tsfc            # (K, ny, nx) f32 or None
        self.infl = infl            # (nz, ny, nx) f32 or None

    @property
    def K(self):
        return self.dev.shape[0]

    @classmethod
    def from_host_gues(cls, gues_host, batch=8):
        """Upload a host (K, NV3D, nz, ny, nx) analysis-variable ensemble
        (f32 mean + bf16 deviations: half the f32 upload bytes)."""
        import jax.numpy as jnp
        import ml_dtypes
        mean = gues_host.mean(axis=0, dtype=np.float32)
        mean_d = jnp.asarray(mean)
        K = gues_host.shape[0]
        parts = []
        for i0 in range(0, K, batch):
            dev_np = (gues_host[i0:i0 + batch] - mean[None]).astype(
                ml_dtypes.bfloat16)
            parts.append(jnp.asarray(dev_np))
        return cls(mean_d, jnp.concatenate(parts, axis=0))

    def to_host_gues(self, batch=8):
        """(K, NV3D, nz, ny, nx) float32 host ensemble. Members are
        ref + dev by the storage invariant (mean is auxiliary)."""
        import jax
        import jax.numpy as jnp
        K = self.K

        @jax.jit
        def member_block(ref, dev, i0):
            d = jax.lax.dynamic_slice_in_dim(dev, i0, batch, axis=0)
            return ref[None] + d.astype(jnp.float32)

        out = None
        for i0 in range(0, K, batch):
            i0c = min(i0, K - batch)
            blk = np.asarray(member_block(self.ref, self.dev,
                                          jnp.int32(i0c)))
            if out is None:
                out = np.empty((K,) + blk.shape[1:], np.float32)
            out[i0c:i0c + batch] = blk
        return out


class ResidentCycle:
    """Full-size cycle executor with the ensemble resident in HBM."""

    def __init__(self, driver, member_batch: int = 5, tile_rows: int = 24,
                 verbose: bool = False, max_steps_per_call: int = 60):
        self.d = driver
        self.member_batch = member_batch
        self.tile_rows = tile_rows
        self.verbose = verbose
        # upper bound on integration steps per device call: the window is
        # a chain of bounded executions, so progress stays observable and
        # no single device call runs for minutes
        self.max_steps_per_call = max_steps_per_call
        self._jit_cache = {}
        # per-obs departures from the latest monitored cycle
        self.last_ctx = None
        self.last_oma = None

    @property
    def _has_phys(self):
        return self.d._fcst_ens_phys_raw is not None

    # ------------------------------------------------------------------
    # forecast phase
    # ------------------------------------------------------------------

    def _fcst_programs(self, obs: Observations, nsteps: int, b: int):
        """Per-batch forecast pieces. The window is integrated as a CHAIN
        of bounded device calls (≤ max_steps_per_call steps each, state
        staying device-resident between calls) instead of one monolithic
        program, which keeps each execution short and progress
        observable."""
        import jax
        import jax.numpy as jnp
        from scale_letkf_tpu.state import (
            state_trans, state_trans_inv, state_to_history)
        from scale_letkf_tpu.model.dycore import (
            to_collocated, from_collocated)
        from scale_letkf_tpu.da.obsope import compute_hx_single

        d = self.d
        key = ("fcst", id(obs), nsteps, b)
        if key in self._jit_cache:
            return self._jit_cache[key]

        dt = d.dycfg.dt
        parts, in_window = _slot_parts(obs, d.cfg, dt, nsteps)
        if parts is None:
            parts = [(nsteps, obs, np.arange(obs.nobs), obs.nobs)]
            in_window = np.ones(obs.nobs, bool)
        self._in_window = in_window
        has_phys = self._has_phys

        def start(dev, tsfc_buf, mean0, i0):
            d_b = jax.lax.dynamic_slice_in_dim(dev, i0, b, axis=0)
            anal_b = mean0[None] + d_b.astype(jnp.float32)
            state = jax.vmap(from_collocated)(state_trans_inv(
                anal_b,
                positive_definite_q=d.cfg.letkf.positive_definite_q,
                positive_definite_qhyd=d.cfg.letkf.positive_definite_qhyd))
            if has_phys:
                tsfc = jax.lax.dynamic_slice_in_dim(tsfc_buf, i0, b,
                                                    axis=0)
            else:
                tsfc = jnp.zeros((1,), jnp.float32)
            return state, tsfc

        seg_cache = {}

        def seg_jit(n):
            if n not in seg_cache:
                def advance(state, tsfc, t0c, bdy):
                    if has_phys:
                        return d._fcst_ens_phys_raw(state, n, t0c, tsfc,
                                                    bdy)
                    return d._fcst_ens_raw(state, n, t0c, bdy), tsfc
                seg_cache[n] = jax.jit(
                    advance, donate_argnums=(0,) if _donate() else ())
            return seg_cache[n]

        hx_cache = {}

        def hx_jit(part_i):
            """Slot-matched H(x) of the CURRENT state for part part_i."""
            if part_i not in hx_cache:
                obs_s = parts[part_i][1]

                midx = parts[part_i][2]
                n_real = parts[part_i][3]

                def hx(state, tsfc, y_dev, qc_dev):
                    snap = state_trans(jax.vmap(to_collocated)(state))
                    if has_phys:
                        fields = jax.vmap(
                            lambda g, ts: state_to_history(
                                g, d.z_full, d.topo, tsfc=ts))(snap, tsfc)
                    else:
                        fields = jax.vmap(
                            lambda g: state_to_history(
                                g, d.z_full, d.topo))(snap)
                    y_s, qc_s = jax.vmap(
                        lambda f: compute_hx_single(f, obs_s, d.grid,
                                                    d.cfg, d.z_full))(
                        fields)
                    idx = jnp.asarray(midx)
                    y_dev = y_dev.at[:, idx].set(y_s[:, :n_real])
                    qc_dev = qc_dev.at[:, idx].set(qc_s[:, :n_real])
                    return y_dev, qc_dev
                hx_cache[part_i] = jax.jit(
                    hx, donate_argnums=(2, 3) if _donate() else ())
            return hx_cache[part_i]

        def finalize(dev, accum, tsfc_buf, state, tsfc, mean0, i0):
            """Write the analysis-time deviations + slab state in place
            (called when the integration reaches nsteps, BEFORE any
            beyond-window slot segments)."""
            gues_out = state_trans(jax.vmap(to_collocated)(state))
            accum = accum + jnp.sum(gues_out, axis=0)
            dev = jax.lax.dynamic_update_slice_in_dim(
                dev, (gues_out - mean0[None]).astype(dev.dtype), i0,
                axis=0)
            if has_phys:
                tsfc_buf = jax.lax.dynamic_update_slice_in_dim(
                    tsfc_buf, tsfc, i0, axis=0)
            return dev, accum, tsfc_buf

        donate = (0, 1, 2) if _donate() else ()
        progs = {
            "parts": parts,
            "start": jax.jit(start),
            "seg": seg_jit,
            "hx": hx_jit,
            "finalize": jax.jit(finalize, donate_argnums=donate),
        }
        self._jit_cache = {key: progs}    # latest (obs, nsteps) only
        return progs

    def forecast_and_hx(self, ens: ResidentEnsemble, nsteps: int,
                        obs: Observations, t0: float = 0.0):
        """Resident forecast + H(x). Mutates `ens` (mean advances; devs
        stay against ens.ref until the analysis). Returns
        (ensval device (K, nobs), qc_worst host (nobs,), timers)."""
        import jax
        import jax.numpy as jnp
        from scale_letkf_tpu.model.physics_suite import init_physics_state

        d = self.d
        K = ens.K
        b = _batch_of(K, self.member_batch)
        progs = self._fcst_programs(obs, nsteps, b)
        parts = progs["parts"]
        chunk = max(1, int(self.max_steps_per_call))
        dt_model = d.dycfg.dt
        t = {"fcst_s": 0.0, "fcst_compile_s": 0.0, "batches": K // b}

        if self._has_phys and ens.tsfc is None:
            # cold start: lowest-level air temperature per member
            @jax.jit
            def init_tsfc(mean0, dev, i0):
                d_b = jax.lax.dynamic_slice_in_dim(dev, i0, b, axis=0)
                anal_b = mean0[None] + d_b.astype(jnp.float32)
                from scale_letkf_tpu.state import state_trans_inv
                from scale_letkf_tpu.model.dycore import from_collocated
                st = jax.vmap(from_collocated)(state_trans_inv(anal_b))
                return jax.vmap(
                    lambda s: init_physics_state(
                        s, d.dz_phys, d._phys_cfg).tsfc)(st)
            blocks = [init_tsfc(ens.mean, ens.dev, jnp.int32(i0))
                      for i0 in range(0, K, b)]
            ens.tsfc = jnp.concatenate(blocks, axis=0)

        accum = jnp.zeros_like(ens.mean)
        ys = []
        qc_worst = np.zeros(obs.nobs, np.int32)
        # members are ref + dev by the storage invariant — ref equals mean
        # right after an analysis/load, but NOT after a forecast-only
        # cycle (control/truth runs): using ens.mean here re-added the
        # mean drift to every member each cycle
        mean0 = ens.ref
        tsfc_buf = (ens.tsfc if ens.tsfc is not None
                    else jnp.zeros((1, 1, 1), jnp.float32))
        bdy_full = d._bdy_args()
        per_member_bdy = (bdy_full is not None
                          and bdy_full[0].rho.ndim == 4)
        for i0 in range(0, K, b):
            tt = time.time()
            bdy = bdy_batch(d, i0, b) if per_member_bdy else bdy_full
            state, tsfc = progs["start"](ens.dev, tsfc_buf, mean0,
                                         jnp.int32(i0))
            y_dev = jnp.zeros((b, obs.nobs), jnp.float32)
            qc_dev = jnp.zeros((b, obs.nobs), jnp.int32)
            cur = 0
            for pi, (pt, obs_s, midx, n_real) in enumerate(parts):
                while cur < pt:
                    n = min(chunk, pt - cur)
                    state, tsfc = progs["seg"](n)(
                        state, tsfc, jnp.float32(t0 + cur * dt_model),
                        bdy)
                    cur += n
                if pt == nsteps:
                    # analysis-time write-back (beyond-window slot
                    # segments must not touch the stored guess/slab state)
                    ens.dev, accum, tsfc_buf = progs["finalize"](
                        ens.dev, accum, tsfc_buf, state, tsfc, mean0,
                        jnp.int32(i0))
                if obs_s is not None:
                    y_dev, qc_dev = progs["hx"](pi)(state, tsfc, y_dev,
                                                    qc_dev)
            ys.append(y_dev)
            qc_worst = np.maximum(qc_worst, np.asarray(qc_dev.max(axis=0)))
            dt_w = time.time() - tt
            if i0 == 0:
                t["fcst_compile_s"] = dt_w
            else:
                t["fcst_s"] += dt_w
            if self.verbose:
                _log(f"resident fcst batch {i0 // b + 1}/{K // b}")
        if K > b:
            t["fcst_s"] *= K / (K - b)
        ens.ref = mean0
        ens.mean = accum / K
        if self._has_phys:
            ens.tsfc = tsfc_buf
        ensval = jnp.concatenate(ys, axis=0)
        qc_worst = np.where(self._in_window, qc_worst, QC_TIME)
        return ensval, qc_worst, t

    # ------------------------------------------------------------------
    # analysis phase
    # ------------------------------------------------------------------

    def analysis(self, ens: ResidentEnsemble, obs: Observations, ensval,
                 qc_worst):
        from scale_letkf_tpu.da.letkf_obs import build_obs_context

        d = self.d
        t = {}
        tt = time.time()
        ctx = build_obs_context(obs, ensval, qc_worst, d.cfg, d.grid)
        t["process_obs_s"] = time.time() - tt
        if self.verbose:
            _log(f"resident analysis: {ctx.nobs} obs")
        tt = time.time()
        stats = analyze_resident(ens, ctx, d.cfg, d.grid, d.z_full,
                                 tile_rows=self.tile_rows,
                                 verbose=self.verbose)
        t["das_letkf_s"] = time.time() - tt
        t.update({f"letkf_{k}": v for k, v in stats.items()})
        return ctx, t

    def cycle(self, ens: ResidentEnsemble, obs: Observations, nsteps: int,
              t0: float = 0.0, monitor: bool = True):
        """One complete resident DA cycle. Mutates `ens` to the analysis
        ensemble; returns a report dict (phase timers + O-B/O-A stats)."""
        import jax
        import jax.numpy as jnp
        from scale_letkf_tpu.da.monitor import monit_dep
        from scale_letkf_tpu.state import state_to_history
        from scale_letkf_tpu.da.obsope import compute_hx_single

        d = self.d
        total0 = time.time()
        ensval, qc_worst, t_f = self.forecast_and_hx(ens, nsteps, obs, t0)
        ctx, t_a = self.analysis(ens, obs, ensval, qc_worst)
        report = {**t_f, **t_a}
        report["stats_gues"] = monit_dep(ctx.elem, np.asarray(ctx.dep),
                                         ctx.qc)
        if monitor:
            tt = time.time()

            @jax.jit
            def mean_hx(mean_vars, tsfc_mean):
                fields = state_to_history(mean_vars, d.z_full, d.topo,
                                          tsfc=tsfc_mean)
                y, _ = compute_hx_single(fields, obs, d.grid, d.cfg,
                                         d.z_full)
                return y

            tsfc_mean = (jnp.mean(ens.tsfc, axis=0)
                         if ens.tsfc is not None else None)
            y_a = np.asarray(mean_hx(ens.mean, tsfc_mean)).copy()
            from scale_letkf_tpu.obs.types import ID_H08IR
            m_h08 = ctx.elem == ID_H08IR
            y_a[m_h08] = np.abs(y_a[m_h08])
            oma = ctx.dat - y_a
            report["stats_anal"] = monit_dep(ctx.elem, oma, ctx.qc)
            report["monitor_s"] = time.time() - tt
            # per-obs departures for callers needing subset stats (4-D
            # windows: the O-A monitor is 3-D at analysis time — the
            # reference's monit semantics — so off-center slots mix
            # time-displacement into O-A; the center-slot subset is the
            # time-consistent comparison)
            self.last_ctx = ctx
            self.last_oma = oma
        report["total_s"] = time.time() - total0
        return report


def analyze_resident(ens: ResidentEnsemble, ctx, cfg, grid, z_full,
                     tile_rows: int = 24, verbose: bool = False) -> dict:
    """Tiled LETKF analysis over the resident buffers: tiles are sliced
    and written back entirely on device (da/letkf.py level-scan program
    per tile; da/letkf_tiled.py guards apply). Updates ens IN PLACE
    (dev rebased against the new analysis mean; ref := mean) and returns
    a stats dict."""
    import jax
    import jax.numpy as jnp
    from scale_letkf_tpu.da.letkf import (
        _make_plan, _build_analysis_fn, _auto_level_chunk)
    from scale_letkf_tpu.da.letkf_tiled import _tiled_guards
    from scale_letkf_tpu.ops.obs_select import gather_candidates
    from scale_letkf_tpu.state import IA_P

    _tiled_guards(cfg)
    K, nv, nz, ny, nx = ens.dev.shape
    while ny % tile_rows:
        tile_rows -= 1
    n_tiles = ny // tile_rows
    Bt = tile_rows * nx

    plan = _make_plan(ctx, cfg, nv, has_det=False)
    plan = dataclasses.replace(
        plan, level_chunk=_auto_level_chunk(nz, Bt, cfg.letkf.level_batch,
                                            target=16384))
    fn = _build_analysis_fn(plan, None)

    f32 = jnp.float32
    obs_dev = (jnp.asarray(ctx.x, f32), jnp.asarray(ctx.y, f32),
               jnp.asarray(ctx.vert, f32), jnp.asarray(ctx.err, f32),
               jnp.asarray(ctx.dep, f32), jnp.asarray(ctx.hdxb, f32))

    xs, ys = grid.xy
    gpx_full = jnp.asarray(
        np.broadcast_to(xs[None, :], (ny, nx)).astype(np.float32))
    gpy_full = jnp.asarray(
        np.broadcast_to(ys[:, None], (ny, nx)).astype(np.float32))
    dist_x = np.minimum(np.broadcast_to(xs[None, :], (ny, nx)) - xs[0],
                        xs[-1] - np.broadcast_to(xs[None, :], (ny, nx)))
    dist_y = np.minimum(np.broadcast_to(ys[:, None], (ny, nx)) - ys[0],
                        ys[-1] - np.broadcast_to(ys[:, None], (ny, nx)))
    dbdy_full = jnp.asarray(np.minimum(dist_x, dist_y).astype(np.float32))
    z_dev = jnp.asarray(z_full, f32)

    tables_dev = tuple(jnp.asarray(ct.buckets.table) for ct in ctx.ctypes)

    if ens.infl is None:
        infl0 = cfg.letkf.infl_mul if cfg.letkf.infl_mul > 0 else 1.0
        infl_buf = jnp.full((nz, ny, nx), infl0, f32)
    else:
        infl_buf = jnp.asarray(ens.infl, f32)

    def tile_step(dev, meanbuf, infl_b, mean0, y0, tables):
        z0 = jnp.zeros((), y0.dtype)
        d_t = jax.lax.dynamic_slice(
            dev, (z0, z0, z0, y0, z0), (K, nv, nz, tile_rows, nx))
        m1_t = jax.lax.dynamic_slice(
            meanbuf, (z0, z0, y0, z0), (nv, nz, tile_rows, nx))
        m0_t = jax.lax.dynamic_slice(
            mean0, (z0, z0, y0, z0), (nv, nz, tile_rows, nx))
        pert = d_t.astype(f32) - (m1_t - m0_t)[None]
        pert_zkvb = jnp.transpose(pert.reshape(K, nv, nz, Bt), (2, 0, 1, 3))
        mean_zvb = jnp.transpose(m1_t.reshape(nv, nz, Bt), (1, 0, 2))
        logp = jnp.log(jnp.maximum(mean_zvb[:, IA_P], 1e-3))
        z_t = jax.lax.dynamic_slice(
            z_dev, (z0, y0, z0), (nz, tile_rows, nx)).reshape(nz, Bt)
        infl_t = jax.lax.dynamic_slice(
            infl_b, (z0, y0, z0), (nz, tile_rows, nx)).reshape(nz, Bt)
        gpx = jax.lax.dynamic_slice(
            gpx_full, (y0, z0), (tile_rows, nx)).reshape(-1)
        gpy = jax.lax.dynamic_slice(
            gpy_full, (y0, z0), (tile_rows, nx)).reshape(-1)
        dbdy = jax.lax.dynamic_slice(
            dbdy_full, (y0, z0), (tile_rows, nx)).reshape(-1)
        cand = tuple(gather_candidates(ct.buckets, gpx, gpy, table=tb)
                     for ct, tb in zip(ctx.ctypes, tables))
        anal, infl_z, nobs_z, _det, _rtps = fn(
            pert_zkvb, mean_zvb, infl_t, logp, z_t, gpx, gpy, dbdy, cand,
            *obs_dev, None, None, None, None)
        # anal: (K, nv, nz, Bt) → rebase devs against the tile anal mean
        anal_mean = jnp.mean(anal, axis=0)
        dev_new = (anal - anal_mean[None]).astype(dev.dtype).reshape(
            K, nv, nz, tile_rows, nx)
        dev = jax.lax.dynamic_update_slice(dev, dev_new,
                                           (z0, z0, z0, y0, z0))
        meanbuf = jax.lax.dynamic_update_slice(
            meanbuf, anal_mean.reshape(nv, nz, tile_rows, nx),
            (z0, z0, y0, z0))
        infl_b = jax.lax.dynamic_update_slice(
            infl_b, infl_z.reshape(nz, tile_rows, nx), (z0, y0, z0))
        return dev, meanbuf, infl_b, jnp.mean(nobs_z)

    donate = (0, 1, 2) if _donate() else ()
    tile_jit = jax.jit(tile_step, donate_argnums=donate)

    stats = {"compute_s": 0.0, "compile_s": 0.0, "tiles": n_tiles,
             "transfer_s": 0.0}
    dev, meanbuf, mean0 = ens.dev, ens.mean, ens.ref
    nobs_means = []
    for ti in range(n_tiles):
        tc = time.time()
        dev, meanbuf, infl_buf, nb = tile_jit(
            dev, meanbuf, infl_buf, mean0, jnp.int32(ti * tile_rows),
            tables_dev)
        jax.block_until_ready(nb)
        dt_w = time.time() - tc
        nobs_means.append(nb)
        if ti == 0:
            stats["compile_s"] = dt_w
        else:
            stats["compute_s"] += dt_w
        if verbose and (ti % 4 == 0 or ti == n_tiles - 1):
            _log(f"resident tile {ti + 1}/{n_tiles}")
    if n_tiles > 1:
        stats["compute_s"] *= n_tiles / (n_tiles - 1)
    stats["nobs_mean"] = float(np.mean([float(x) for x in nobs_means]))
    ens.dev = dev
    ens.mean = meanbuf
    ens.ref = meanbuf
    adaptive = cfg.letkf.infl_mul_adaptive or cfg.letkf.infl_mul <= 0
    ens.infl = infl_buf if adaptive else ens.infl
    return stats
