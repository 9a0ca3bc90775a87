"""Host-streamed tiled LETKF analysis for domains exceeding device memory.

The 18-km reference domain at MEMBER=50 (480x360x36, PARAM_PRC of
config/2015summer_18km/config.nml.scale) is a 13.7-GB float32 state — the
reference spreads it over 48 MPI ranks x 50 members
(common_mpi_scale.f90:367-512); a device too small for the state plus
analysis work buffers streams it. The LETKF update is embarrassingly parallel
across gridpoints once the (small) observation-space arrays are device
resident, so this executor streams horizontal row-tiles of the ensemble
through the chip:

  host RAM ensemble → per tile: perturbation/mean split (numpy) →
  bfloat16 upload → f32 analysis on device (da/letkf.py fn) →
  bfloat16 download → host assembly

Tiles need NO halo: localization is resolved through the global obs
bucket tables, which are uploaded once. bfloat16 is applied only to the
perturbation transport (mean in float32), so the relative precision of
the increments is preserved. On a pod slice the same tiling becomes the
per-host shard loop (each host streams its own rows).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from scale_letkf_tpu.da.letkf import (
    _make_plan, _build_analysis_fn, _auto_level_chunk,
)
from scale_letkf_tpu.state import IA_P


def _tiled_guards(cfg):
    """Explicit guards instead of silently feature-stripped analyses: the
    tile loops (host-streamed here; device-resident in da/resident.py) do
    not thread a deterministic member, additive inflation, or the RTPS
    output field (mirrors analyze()'s raise-on-unsupported contract)."""
    if cfg.letkf.infl_add > 0:
        raise NotImplementedError(
            "tiled analysis does not support additive inflation "
            "(INFL_ADD > 0; letkf_tools.f90:804-929) — use analyze()")
    if cfg.letkf.relax_spread_out:
        raise NotImplementedError(
            "tiled analysis does not support RELAX_SPREAD_OUT — "
            "use analyze()")
    if cfg.ensemble.det_run:
        raise NotImplementedError(
            "tiled analysis does not support a deterministic member "
            "(DET_RUN; letkf_tools.f90:489-497) — use analyze()")


def analyze_tiled(
    gues_host: np.ndarray,        # (K, NV3D, nz, ny, nx) float32, host RAM
    ctx,                          # ObsContext (da/letkf_obs.py)
    cfg,
    grid,
    z_full: np.ndarray,           # (nz, ny, nx)
    infl_field: np.ndarray | None = None,
    tile_rows: int = 24,
    out: np.ndarray | None = None,
    pipeline: bool = False,
) -> tuple[np.ndarray, np.ndarray | None, dict]:
    """Tiled analysis. Returns (anal (same shape/layout, float32),
    infl_field or None, stats dict with compute_s/transfer_s/compile_s).

    pipeline=True double-buffers the stream: tile t+1's host prep + upload
    are dispatched while tile t computes, so per-tile wall approaches
    max(transfer, compute) instead of their sum. Phase attribution is then
    impossible (the download wait covers whatever did not overlap), so
    stats reports stream_s (steady pipelined wall) with compute_s aliased
    to it and transfer_s = 0; use pipeline=False to measure components."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    _tiled_guards(cfg)

    K, nv, nz, ny, nx = gues_host.shape
    if ny % tile_rows:
        # largest divisor of ny not exceeding the request
        while ny % tile_rows:
            tile_rows -= 1
    n_tiles = ny // tile_rows
    Bt = tile_rows * nx

    plan = _make_plan(ctx, cfg, nv, has_det=False)
    plan = dataclasses.replace(
        plan, level_chunk=_auto_level_chunk(nz, Bt, cfg.letkf.level_batch,
                                            target=16384))
    fn = _build_analysis_fn(plan, None)

    # obs-space arrays: device resident once (small next to the state)
    f32 = jnp.float32
    obs_dev = (jnp.asarray(ctx.x, f32), jnp.asarray(ctx.y, f32),
               jnp.asarray(ctx.vert, f32), jnp.asarray(ctx.err, f32),
               jnp.asarray(ctx.dep, f32), jnp.asarray(ctx.hdxb, f32))

    xs, ys = grid.xy
    dist_x = np.minimum(np.broadcast_to(xs[None, :], (ny, nx)) - xs[0],
                        xs[-1] - np.broadcast_to(xs[None, :], (ny, nx)))
    dist_y = np.minimum(np.broadcast_to(ys[:, None], (ny, nx)) - ys[0],
                        ys[-1] - np.broadcast_to(ys[:, None], (ny, nx)))
    dist_bdy_full = np.minimum(dist_x, dist_y).astype(np.float32)

    bf16 = ml_dtypes.bfloat16

    def tile_step(pert_bf, mean_f, infl0, logp, z_t, gpx, gpy, dbdy, cand):
        pert = pert_bf.astype(f32)
        anal, infl_z, nobs_z, _det, _rtps = fn(
            pert, mean_f, infl0, logp, z_t, gpx, gpy, dbdy, cand,
            *obs_dev, None, None, None, None)
        # bf16 rides ONLY on perturbations both ways: casting the full
        # members would quantize T≈280 K at ~1 K — larger than typical
        # increments; the f32 mean is small next to the (K,...) block
        anal_mean = jnp.mean(anal, axis=0)
        anal_pert = (anal - anal_mean[None]).astype(jnp.bfloat16)
        return anal_mean, anal_pert, infl_z, nobs_z

    tile_jit = jax.jit(tile_step)

    anal_out = out if out is not None else np.empty_like(gues_host)
    infl_out = (np.empty((nz, ny, nx), np.float32)
                if (cfg.letkf.infl_mul_adaptive or cfg.letkf.infl_mul <= 0)
                else None)
    stats = {"compute_s": 0.0, "transfer_s": 0.0, "compile_s": 0.0,
             "host_s": 0.0, "tiles": n_tiles}

    from scale_letkf_tpu.ops.obs_select import gather_candidates

    def prep_upload(t):
        """Host prep + (async) upload of tile t's arguments."""
        y0, y1 = t * tile_rows, (t + 1) * tile_rows
        th = time.time()
        slab = gues_host[:, :, :, y0:y1, :]               # (K,nv,nz,tr,nx)
        mean = slab.mean(axis=0)                          # (nv,nz,tr,nx)
        pert = (slab - mean[None]).astype(bf16)
        # (nz, K, nv, Bt) scan layout on host (cheap vs device HBM)
        pert_zkvb = np.ascontiguousarray(
            pert.reshape(K, nv, nz, Bt).transpose(2, 0, 1, 3))
        mean_zvb = np.ascontiguousarray(
            mean.reshape(nv, nz, Bt).transpose(1, 0, 2)).astype(np.float32)
        logp = np.log(np.maximum(mean_zvb[:, IA_P], 1e-3))
        z_t = z_full[:, y0:y1, :].reshape(nz, Bt).astype(np.float32)
        if infl_field is None:
            # match analyze(): configured value as-is (deflation 0<mul<1
            # included); 1.0 only as the adaptive cold start when mul <= 0
            infl0 = np.full(
                (nz, Bt),
                cfg.letkf.infl_mul if cfg.letkf.infl_mul > 0 else 1.0,
                np.float32)
        else:
            infl0 = infl_field[:, y0:y1, :].reshape(nz, Bt).astype(
                np.float32)
        gpx = np.broadcast_to(xs[None, :], (tile_rows, nx)).reshape(-1)
        gpy = np.broadcast_to(ys[y0:y1, None],
                              (tile_rows, nx)).reshape(-1)
        dbdy = dist_bdy_full[y0:y1].reshape(-1)
        stats["host_s"] += time.time() - th
        gpx_d = jnp.asarray(gpx, f32)
        gpy_d = jnp.asarray(gpy, f32)
        cand = tuple(gather_candidates(ct.buckets, gpx_d, gpy_d)
                     for ct in ctx.ctypes)
        return (jnp.asarray(pert_zkvb), jnp.asarray(mean_zvb),
                jnp.asarray(infl0), jnp.asarray(logp), jnp.asarray(z_t),
                gpx_d, gpy_d, jnp.asarray(dbdy, f32), cand)

    def download(t, anal_mean, anal_pert, infl_z):
        y0, y1 = t * tile_rows, (t + 1) * tile_rows
        mean_np = np.asarray(anal_mean)                   # (nv,nz,Bt) f32
        pert_np = np.asarray(anal_pert).astype(np.float32)
        th = time.time()
        anal_out[:, :, :, y0:y1, :] = (
            mean_np[None] + pert_np).reshape(K, nv, nz, tile_rows, nx)
        if infl_out is not None:
            infl_out[:, y0:y1, :] = np.asarray(infl_z).reshape(
                nz, tile_rows, nx)
        stats["host_s"] += time.time() - th

    if pipeline:
        stats["pipelined"] = True
        stats["stream_s"] = 0.0
        args = prep_upload(0)
        for t in range(n_tiles):
            tc = time.time()
            anal_mean, anal_pert, infl_z, nobs_z = tile_jit(*args)
            if t + 1 < n_tiles:
                # prefetch the next tile while this one computes: the
                # upload DMA and the analysis kernels overlap, so steady
                # per-tile wall ≈ max(transfer, compute)
                args = prep_upload(t + 1)
            download(t, anal_mean, anal_pert, infl_z)   # blocks
            dt = time.time() - tc
            if t == 0:
                stats["compile_s"] = dt
            else:
                stats["stream_s"] += dt
        if n_tiles > 1:
            stats["stream_s"] *= n_tiles / (n_tiles - 1)
        # alias for rate-computing callers: with overlap the stream wall is
        # the honest (conservative) per-tile cost; components are not
        # separable in this mode
        stats["compute_s"] = stats["stream_s"]
        return anal_out, infl_out, stats

    for t in range(n_tiles):
        tt = time.time()
        h0 = stats["host_s"]
        args = prep_upload(t)
        jax.block_until_ready(args[0])
        stats["transfer_s"] += time.time() - tt - (stats["host_s"] - h0)

        tc = time.time()
        anal_mean, anal_pert, infl_z, nobs_z = tile_jit(*args)
        jax.block_until_ready(anal_pert)
        dt = time.time() - tc
        if t == 0:
            stats["compile_s"] = dt   # first tile pays the compile
        else:
            stats["compute_s"] += dt

        tt = time.time()
        h0 = stats["host_s"]
        download(t, anal_mean, anal_pert, infl_z)
        stats["transfer_s"] += time.time() - tt - (stats["host_s"] - h0)

    # steady-state rate excludes the compiled first tile
    if n_tiles > 1:
        stats["compute_s"] *= n_tiles / (n_tiles - 1)
    return anal_out, infl_out, stats
