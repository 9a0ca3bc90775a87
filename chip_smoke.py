#!/usr/bin/env python3
"""Smoke test of the DA system on the GPU, through its normal entry points.

    python chip_smoke.py               # phases a-e on one card
    python chip_smoke.py --four-cards  # device check + the multi-card phase

Phases, in order (each prints its results and seconds):

  a device     JAX must find a GPU; nothing continues on the CPU.
  b transform  letkf_core at K=8/50/100 against eigh_impl='lax' in float64
               on the host, and every solver backend timed on the card;
               the fused Newton–Schulz kernel against float64 eigh on
               LETKF-shaped Grams of cond 1e2-1e4.
  c cycle      analyze() on a small grid against the float64 per-point
               oracle (tests/oracle_letkf.py), then 4 cycles of the fused
               48x48x16 K=8 OSSE (finite, O-A < O-B).
  d cli        fcst → obsmake → obsope → letkf → cycle, each a separate
               `python -m scale_letkf_tpu` process on the card.
  e fullsize   one complete dense-radar cycle of configs/bda_1km_radar.toml
               (192x192x48, K=50, 15 steps, ~888k obs) through
               ResidentCycle.cycle: finite state, O-A ≤ O-B for REF.
  four_cards   (--four-cards) __graft_entry__.dryrun_multichip(4); the
               mesh-sharded analyze() against one card at K=8 and K=50
               (with the solver each picks, and the fused kernel forced
               onto the mesh); the explicit-halo forecast against the
               GSPMD forecast.

Each phase runs in its own child process, one after another, so exactly
one process holds the card at any time (a JAX process reserves most of the
card's memory when it starts). The first line is the card's name and power
limit from nvidia-smi; the last line is one JSON object,
{"ok": ..., "device": {"platform", "kind", "count"}}. Any failed phase
makes the exit code non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BUDGET_S = 1150.0            # the whole run, compilation included
ONE_CARD = ("device", "transform", "cycle", "cli", "fullsize")
FOUR_CARDS = ("device", "four_cards")


def _say(msg: str) -> None:
    print(msg, flush=True)


def _max_rel(a, b) -> float:
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# phase a: the device
# ---------------------------------------------------------------------------

def phase_device(want: int) -> None:
    import jax
    devs = jax.devices()
    dev = {"platform": devs[0].platform, "kind": devs[0].device_kind,
           "count": len(devs)}
    _say("DEVICE " + json.dumps(dev))
    if dev["platform"] != "gpu":
        raise RuntimeError(f"no GPU: JAX found {dev['platform']}")
    if len(devs) < want:
        raise RuntimeError(f"need {want} cards, JAX found {len(devs)}")


# ---------------------------------------------------------------------------
# phase b: the LETKF transform and its solvers
# ---------------------------------------------------------------------------

# Tolerances against float64, as max |err| / max |ref| of W (trans), Pa
# (pao) and w̄ (transm). The Gram is HIGHEST (full float32), so what remains
# is the float32 solve: its error grows with cond(C)·eps32 (cond ≲ 10 in
# these well-conditioned random batches, eps32 = 6e-8), plus the K-term
# sums. The iterative solvers converge to float32 roundoff, not beyond it,
# so every backend gets the same bound, two decades above roundoff.
TRANSFORM_TOL = 1e-4
# 'jacobi' runs a fixed 8 sweeps, and cyclic Jacobi needs more sweeps as K
# grows: at K ≥ 50 the slowest-converging Grams of a batch keep an
# off-diagonal residue of order 1e-4 after 8 (K=100, B=2048 on the CPU:
# 5.3e-5 after 8 sweeps, 8.3e-6 after 10). Where 'auto' picks it (K ≤ 16)
# it meets TRANSFORM_TOL; above, JACOBI_TOL checks only that it converges.
JACOBI_TOL = 1e-3


def _transform_tol(impl: str, K: int) -> float:
    return JACOBI_TOL if impl == "jacobi" and K > 16 else TRANSFORM_TOL

# The fused kernel against float64 eigh on LETKF-shaped Grams: the inverse
# square root of C loses about cond(C)·eps32 relative accuracy in float32
# arithmetic, and the TF32x3 bulk phase adds no more than that. Bound:
# 50·cond·eps32 (cond 1e2: 3e-4; cond 1e4: 3e-2).
def _invsqrt_tol(cond: float) -> float:
    return 50.0 * cond * 6e-8


def _transform_inputs(rng, B, L, K):
    import numpy as np
    return (rng.standard_normal((B, L, K)).astype(np.float32),
            rng.uniform(0.5, 2.0, (B, L)).astype(np.float32),
            rng.uniform(0.05, 1.0, (B, L)).astype(np.float32),
            rng.standard_normal((B, L)).astype(np.float32),
            np.full(B, 1.1, np.float32))


def _time_call(fn, args, reps=5) -> float:
    """Median seconds of fn(*args) after one warm-up call."""
    import jax
    import numpy as np
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# (K, batch) of the transform cases: the K=8 headline unit, MEMBER=50 and
# MEMBER=100 at batches of one analysis level's tile, and the K where
# 'auto' changes hands or the fused kernel changes width (15: odd, width
# 16; 17: width 32; 20, 32; 64: the widest it serves); GRAM_BATCH Grams
# per condition number for the kernel check.
TRANSFORM_CASES = ((8, 10_000), (15, 4096), (17, 4096), (20, 4096),
                   (32, 4096), (50, 4096), (64, 4096), (100, 2048))
GRAM_BATCH = 1024


def _letkf_gram(rng, B, K, L, cond):
    """Grams shaped like the LETKF's: C = S + s·I with S = HᵀH of rank
    L < K (so most eigenvalues equal the inflation shift s) scaled so that
    cond(C) = cond exactly."""
    import numpy as np
    h = rng.standard_normal((B, L, K))
    s_mat = np.einsum("blk,blj->bkj", h, h)
    lmax = np.linalg.eigvalsh(s_mat)[:, -1]
    shift = K - 1.0
    s_mat *= ((cond - 1.0) * shift / lmax)[:, None, None]
    return s_mat + shift * np.eye(K), np.full(B, shift)


def phase_transform() -> None:
    import numpy as np
    import jax
    import jax.numpy as jnp
    from functools import partial
    from scale_letkf_tpu.ops.letkf_core import letkf_core, resolve_eigh_impl
    from scale_letkf_tpu.ops.invsqrt import (
        FUSED_MAX_WIDTH, fused_width, invsqrt_newton_schulz,
        invsqrt_ns_fused)

    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(0)
    L = 30
    failures = []
    for K, B in TRANSFORM_CASES:
        host = _transform_inputs(rng, B, L, K)
        with jax.enable_x64(True), jax.default_device(cpu):
            ref = letkf_core(*(jnp.asarray(a, jnp.float64) for a in host),
                             infl_update=True, eigh_impl="lax")
            ref = jax.tree.map(np.asarray, ref)
        dev_args = tuple(jnp.asarray(a) for a in host)
        auto = resolve_eigh_impl("auto", K, jnp.float32)
        served = fused_width(K) <= FUSED_MAX_WIDTH
        impls = ["lax", "jacobi", "ns"] + (["ns_fused"] if served else [])
        for impl in impls:
            if impl == "jacobi" and K % 2:
                continue
            fn = jax.jit(partial(letkf_core, infl_update=True,
                                 eigh_impl=impl))
            out = fn(*dev_args)
            err = max(_max_rel(out.trans, ref.trans),
                      _max_rel(out.pao, ref.pao),
                      _max_rel(out.transm, ref.transm))
            tol = _transform_tol(impl, K)
            ok = bool(np.isfinite(err) and err <= tol)
            t = _time_call(fn, dev_args)
            _say(f"  transform K={K} B={B} L={L} {impl:8s} "
                 f"{t * 1e3:9.3f} ms  {B / t:12.1f} pts/s  "
                 f"err_vs_f64={err:.2e} (tol {tol:.0e})"
                 f"{'  <- auto' if impl == auto else ''}"
                 f"{'' if ok else '  FAIL'}")
            if not ok:
                failures.append(f"K={K} {impl} err {err:.2e}")

    for K in (50, 64, 100):
        served = fused_width(K) <= FUSED_MAX_WIDTH
        for cond in (1e2, 1e3, 1e4):
            c64, shift = _letkf_gram(rng, GRAM_BATCH, K, 30, cond)
            w, v = np.linalg.eigh(c64)
            isq_ref = np.einsum("bik,bk,bjk->bij", v, 1.0 / np.sqrt(w), v)
            c32 = jnp.asarray(c64, jnp.float32)
            sh32 = jnp.asarray(shift, jnp.float32)
            tol = _invsqrt_tol(cond)
            isq_n, _ = invsqrt_newton_schulz(c32)
            e_n = _max_rel(isq_n, isq_ref)
            t_n = _time_call(invsqrt_newton_schulz, (c32,))
            line = (f"  invsqrt K={K} B={GRAM_BATCH} cond={cond:.0e} "
                    f"(tol {tol:.1e}): ns(HIGHEST) err={e_n:.2e} "
                    f"{t_n * 1e3:.3f} ms")
            ok = bool(np.isfinite(e_n) and e_n <= tol)
            if served:
                fused = jax.jit(invsqrt_ns_fused)
                isq_f, _ = fused(c32, sh32)
                e_f = _max_rel(isq_f, isq_ref)
                t_f = _time_call(fused, (c32, sh32))
                line += f" | ns_fused err={e_f:.2e} {t_f * 1e3:.3f} ms"
                ok = ok and bool(np.isfinite(e_f) and e_f <= tol)
            else:
                line += f" | ns_fused: not served (K > {FUSED_MAX_WIDTH})"
            _say(line + ("" if ok else "  FAIL"))
            if not ok:
                failures.append(f"invsqrt K={K} cond={cond:.0e}")
    if failures:
        raise AssertionError("; ".join(failures))


# ---------------------------------------------------------------------------
# phase c: analyze() against the float64 oracle, then the fused OSSE
# ---------------------------------------------------------------------------

# analyze() on the card against the float64 per-point oracle. Bound per
# variable: ANALYZE_TOL · (ensemble spread) for the float32 transform and
# apply (~1e-5 of the spread measured on CPU), plus two float32 ulps of the
# value itself for storing the state in float32 (pressure: 2 ulp at 850 hPa
# is 0.02 Pa against a 1 Pa spread). The weight apply asks for full float32
# (da/letkf.py); TF32 products (10-bit mantissa) in its K-term sums would
# give ~1e-3 of the spread and fail this bound.
ANALYZE_TOL = 2e-4
EPS32 = float(2.0 ** -23)


def _analysis_errors(anal, ref, gues):
    """Per variable: max |anal - ref| over the bound above, and over the
    ensemble spread; and the spread."""
    import numpy as np
    axes = (0, 2, 3, 4)
    ref = np.asarray(ref, np.float64)
    spread = np.asarray(gues, np.float64).std(axis=0).max(axis=(1, 2, 3))
    bound = ANALYZE_TOL * spread + 2 * EPS32 * np.abs(ref).max(axis=axes)
    err = np.abs(np.asarray(anal, np.float64) - ref).max(axis=axes)
    return (err / np.maximum(bound, 1e-30),
            err / np.maximum(spread, 1e-30), spread)


def _oracle_case():
    """Small analysis case whose per-point answer is easy to state: every
    obs reaches every gridpoint (domain diagonal < localization cutoff), no
    vertical localization, no relaxation, fixed inflation, f32 gathers."""
    import numpy as np
    import jax.numpy as jnp
    from scale_letkf_tpu.config import Config, EnsembleConfig, LetkfConfig
    from scale_letkf_tpu.grid import Grid, Projection
    from scale_letkf_tpu.da.letkf_obs import build_obs_context
    from scale_letkf_tpu.obs.types import Observations, ID_T, ID_U
    from scale_letkf_tpu.state import NV3D, IA_T, IA_P, IA_U, IA_Q0

    K, NZ, NY, NX, nobs = 8, 4, 16, 16, 40
    grid = Grid.uniform(nx=NX, ny=NY, nz=NZ, dx=2e3, dy=2e3, dz=500.0,
                        proj=Projection(kind="LC"))
    rng = np.random.default_rng(0)
    gues = np.zeros((K, NV3D, NZ, NY, NX), np.float32)
    sh = (K, NZ, NY, NX)
    gues[:, IA_U] = 5.0 + rng.standard_normal(sh)
    gues[:, IA_T] = 280.0 + rng.standard_normal(sh)
    gues[:, IA_P] = (850e2 * np.exp(-np.arange(NZ) * 0.1)[None, :, None,
                                                          None]
                     + rng.standard_normal(sh))
    gues[:, IA_Q0] = 1e-3 + 1e-4 * rng.standard_normal(sh)
    lon2d, lat2d = grid.lonlat
    jj = rng.integers(1, NY - 1, nobs)
    ii = rng.integers(1, NX - 1, nobs)
    kk = rng.integers(0, NZ, nobs)
    elem = np.where(rng.uniform(size=nobs) < 0.5, ID_T, ID_U).astype(
        np.int32)
    obs = Observations(
        elem=elem, lon=lon2d[jj, ii], lat=lat2d[jj, ii],
        lev=850e2 * np.exp(-kk * 0.1),
        dat=np.where(elem == ID_T, 280.0, 5.0) + rng.standard_normal(nobs),
        err=np.ones(nobs), typ=np.zeros(nobs, np.int32),
        dif=np.zeros(nobs))
    ia = np.where(elem == ID_T, IA_T, IA_U)
    ensval = np.stack([gues[m, ia, kk, jj, ii] for m in range(K)])
    cfg = Config(ensemble=EnsembleConfig(member=K),
                 letkf=LetkfConfig(infl_mul=1.1, hdxb_gather_bf16=False))
    cfg.letkf_obs.hori_local = tuple([15.0e3] + [-1.0] * 23)
    cfg.letkf_obs.vert_local = tuple([0.0] + [-1.0] * 23)
    ctx = build_obs_context(obs, ensval, np.zeros(nobs, np.int32), cfg,
                            grid)
    z_full = grid.calc_z(jnp.zeros((NY, NX)))
    return grid, gues, ctx, cfg, z_full


def _oracle_analysis(gues, ctx, cfg, grid):
    """Per-gridpoint float64 analysis from tests/oracle_letkf.py."""
    import numpy as np
    sys.path.insert(0, str(ROOT / "tests"))
    from oracle_letkf import letkf_core_np, total_weight_np
    from scale_letkf_tpu.ops.localization import DIST_ZERO_FAC

    g = np.asarray(gues, np.float64)
    K, nv, nz, ny, nx = g.shape
    mean = g.mean(axis=0)
    pert = g - mean[None]
    good = np.asarray(ctx.qc) == 0
    ox, oy = np.asarray(ctx.x)[good], np.asarray(ctx.y)[good]
    err = np.asarray(ctx.err, np.float64)[good]
    dep = np.asarray(ctx.dep, np.float64)[good]
    hdxb = np.asarray(ctx.hdxb, np.float64)[good]
    hs = cfg.letkf_obs.hori_local_for(0)
    xs, ys = grid.xy
    infl = cfg.letkf.infl_mul
    out = np.empty_like(g)
    for j in range(ny):
        for i in range(nx):
            nd2 = ((xs[i] - ox) ** 2 + (ys[j] - oy) ** 2) / hs ** 2
            assert nd2.max() < DIST_ZERO_FAC ** 2
            r = letkf_core_np(hdxb, err ** 2, np.exp(-0.5 * nd2), dep, infl)
            w = total_weight_np(r["trans"], r["transm"], 1.0)
            out[:, :, :, j, i] = mean[None, :, :, j, i] + np.einsum(
                "kvz,km->mvz", pert[:, :, :, j, i], w)
    return out


def phase_cycle() -> None:
    import numpy as np
    import jax
    import jax.numpy as jnp
    from scale_letkf_tpu.da.letkf import analyze
    sys.path.insert(0, str(ROOT))
    from bench import fused_osse_case

    grid, gues, ctx, cfg, z_full = _oracle_case()
    t0 = time.perf_counter()
    anal, _, _ = analyze(jnp.asarray(gues), ctx, cfg, grid, z_full)
    ref = _oracle_analysis(gues, ctx, cfg, grid)
    ratio, rel, spread = _analysis_errors(anal, ref, gues)
    _say(f"  analyze() K=8 16x16x4 vs float64 oracle: max err/spread "
         f"{np.max(rel[spread > 0]):.2e}, max err/bound {ratio.max():.2f} "
         f"(bound {ANALYZE_TOL:.0e}·spread + 2 ulp), "
         f"{time.perf_counter() - t0:.1f} s incl. compile")
    if not ratio.max() <= 1.0:
        raise AssertionError(f"analyze() vs oracle, err/bound: {ratio}")

    fc, truth0, ens = fused_osse_case()
    t0 = time.perf_counter()
    _, ens_a, series = fc.run_osse(truth0, ens, 4, seed=0)
    rmse_g, rmse_a, omb, oma, nobs = (np.asarray(x) for x in series)
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(fc.run_osse(truth0, ens, 4, seed=1)[2][0])
    t_warm = time.perf_counter() - t0
    finite = all(bool(np.isfinite(np.asarray(a)).all()) for a in ens_a)
    _say(f"  fused OSSE 48x48x16 K=8, 4 cycles: O-B {np.round(omb, 4)} "
         f"O-A {np.round(oma, 4)} rmse gues {np.round(rmse_g, 4)} anal "
         f"{np.round(rmse_a, 4)} nobs {nobs}; {t_cold:.1f} s cold, "
         f"{t_warm / 4:.4f} s/cycle warm")
    if not (finite and np.isfinite(omb).all() and (oma < omb).all()):
        raise AssertionError("fused OSSE: not finite or O-A >= O-B")


# ---------------------------------------------------------------------------
# phase d: the CLI chain, one process per step
# ---------------------------------------------------------------------------

CLI_CONFIG = """
[domain]
nx = 12
ny = 12
nz = 8
dx = 2000.0
dy = 2000.0
dz = 500.0
dt = 1.0
qv_surface = 0.008

[ensemble]
member = 4

[letkf]
infl_mul = 1.1

[letkf_obs]
hori_local = [6.0e3, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0]

[obs_error]
t = 0.2
u = 0.2
v = 0.2
"""


def phase_cli_setup(work: str) -> None:
    """Initial ensemble, nature run, obs template (the CLI's inputs),
    written by a process pinned to the CPU."""
    import numpy as np
    import jax
    from scale_letkf_tpu.model.ideal import (
        balanced_state, add_warm_bubble, perturb_ensemble)
    from scale_letkf_tpu.io.checkpoint import save_ensemble, save_member
    from scale_letkf_tpu.da.obsmake import make_obs_network
    from scale_letkf_tpu.obs import io as obsio
    from scale_letkf_tpu.grid import Grid, Projection

    w = Path(work)
    (w / "exp.toml").write_text(CLI_CONFIG)
    nz, ny, nx, dz = 8, 12, 12, 500.0
    qv = 0.008 * np.exp(-(np.arange(nz) + 0.5) * dz / 3000.0)
    s0, _, _ = balanced_state(nz, ny, nx, dz, qv_prof=qv)
    base = add_warm_bubble(s0, dz, 2000.0, 2000.0, amplitude=3.0,
                           center=(12e3, 12e3, 1.5e3))
    allp = perturb_ensemble(jax.random.PRNGKey(0), base, 5, amplitude=0.5)
    save_ensemble(w / "init", jax.tree.map(lambda a: a[1:], allp),
                  basename="anal.@@@@")
    save_member(w / "nature.npz", jax.tree.map(lambda a: a[0], allp))
    grid = Grid.uniform(nx=nx, ny=ny, nz=nz, dx=2000.0, dy=2000.0, dz=dz,
                        proj=Projection())
    template = make_obs_network(grid, np.random.default_rng(0),
                                n_profiles=15, levels_hpa=(900.0, 800.0))
    obsio.write_obs(str(w / "template.dat"), template)


def run_cli_chain(deadline: float) -> None:
    import numpy as np
    with tempfile.TemporaryDirectory() as work:
        w = Path(work)
        env_cpu = dict(os.environ, JAX_PLATFORMS="cpu")
        _child(["--phase", "cli_setup", "--work", work], env_cpu, deadline)
        env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
        cfg = str(w / "exp.toml")
        steps = [
            ("fcst", ["--config", cfg, "--init", str(w / "init"),
                      "--steps", "20", "--out", str(w / "gues")]),
            ("obsmake", ["--config", cfg, "--nature", str(w / "nature.npz"),
                         "--obs-template", str(w / "template.dat"),
                         "--out", str(w / "obs.dat")]),
            ("obsope", ["--config", cfg, "--gues", str(w / "gues"),
                        "--obs", str(w / "obs.dat"),
                        "--out", str(w / "obsda.@@@@")]),
            ("letkf", ["--config", cfg, "--gues", str(w / "gues"),
                       "--obs", str(w / "obs.dat"),
                       "--anal", str(w / "anal")]),
            ("cycle", ["--config", cfg, "--init", str(w / "init"),
                       "--cycles", "2", "--steps-per-cycle", "10",
                       "--obs-pattern", str(w / "obs.dat"),
                       "--out", str(w / "final")]),
        ]
        for cmd, args in steps:
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, "-m", "scale_letkf_tpu", cmd, *args],
                cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=max(1.0, deadline - time.monotonic()))
            dev = [ln for ln in p.stderr.splitlines() if "devices:" in ln]
            _say(f"  cli {cmd}: rc={p.returncode} "
                 f"{time.perf_counter() - t0:.1f} s "
                 f"{dev[-1].split('devices:')[-1].strip() if dev else ''}")
            if p.returncode != 0:
                raise RuntimeError(f"cli {cmd} failed:\n{p.stderr[-3000:]}")
            if not dev or " gpu " not in dev[-1] + " ":
                raise RuntimeError(f"cli {cmd} did not run on the GPU")
            if cmd == "letkf":
                tables = [ln for ln in p.stdout.splitlines()
                          if "O-B" in ln or "O-A" in ln or "RMSE" in ln]
                for ln in tables[:6]:
                    _say(f"    {ln}")
                if not ("O-B" in p.stdout and "O-A" in p.stdout):
                    raise RuntimeError("letkf printed no O-B/O-A tables")
        for d in ("anal", "final"):
            a = np.load(w / d / "anal.0001.npz")
            if not np.isfinite(a["rhot"]).all():
                raise RuntimeError(f"cli {d}: non-finite analysis")


# ---------------------------------------------------------------------------
# phase e: one full-size dense-radar cycle through the resident executor
# ---------------------------------------------------------------------------

def phase_fullsize() -> None:
    import numpy as np
    import jax
    import jax.numpy as jnp
    from scale_letkf_tpu.bench_fullsize import radar_cycle_resident

    t0 = time.perf_counter()
    report, ens = radar_cycle_resident()
    wall = time.perf_counter() - t0
    finite = bool(jnp.isfinite(ens.mean).all()) and bool(
        jnp.isfinite(ens.dev.astype(jnp.float32)).all())
    sg, sa = report.pop("stats_gues"), report.pop("stats_anal")
    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use", 0)
    timers = {k: round(v, 2) for k, v in report.items()
              if isinstance(v, float)}
    _say(f"  radar cycle {report['grid']} K={report['members']} "
         f"{report['steps']} steps, {report['nobs']} obs: {wall:.1f} s "
         f"wall; peak_bytes_in_use {peak / 2**30:.2f} GiB")
    _say(f"  phase timers (s): {json.dumps(timers)}")
    omb, oma = sg.rmse.get("REF", np.nan), sa.rmse.get("REF", np.nan)
    _say(f"  REF: {sg.nobs.get('REF', 0)} obs, O-B rmse {omb:.4f}, "
         f"O-A rmse {oma:.4f}; Vr O-B {sg.rmse.get('Vr', np.nan):.4f} "
         f"O-A {sa.rmse.get('Vr', np.nan):.4f}; state finite {finite}")
    if not (finite and np.isfinite(omb) and oma <= omb):
        raise AssertionError("full-size radar cycle: not finite or "
                             "O-A > O-B for REF")


# ---------------------------------------------------------------------------
# --four-cards: the multi-card paths against one card
# ---------------------------------------------------------------------------

# Sharded against single-card analyze(): the same float32 arithmetic in a
# different reduction order across the all-to-all layout (CPU-mesh test:
# rtol 1e-5, atol 1e-6). Explicit halo against GSPMD forecast: float32
# reassociation accumulated over the acoustic substeps, relative to each
# field's magnitude (the CPU-mesh test's class).
SHARDED_TOL = (1e-5, 1e-6)
HALO_TOL = (3e-5, 1e-4)


def _hlo_census(hlo: str):
    """(batch of each fused-kernel custom call, number of all-gathers) in
    a compiled HLO module."""
    import re
    batches, gathers = [], 0
    for ln in hlo.splitlines():
        if "custom-call" in ln and ("ns_invsqrt_fused" in ln
                                    or "xla.gpu.triton" in ln):
            m = re.search(r"f32\[(\d+),\d+,\d+\]", ln)
            batches.append(int(m.group(1)) if m else -1)
        if re.search(r" all-gather(-start)?\(", ln):
            gathers += 1
    return batches, gathers


def _sharded_k50(mesh) -> None:
    """K=50 on the mesh against one card. One card's 'auto' is the fused
    kernel; the mesh's is 'ns' (resolve_eigh_impl, sharded=True), so the
    two differ by solver roundoff: phase c's bound (ANALYZE_TOL·spread +
    2 ulp). The compiled mesh program must hold no fused-kernel call; the
    same analysis forced onto the fused kernel shows what the partitioner
    makes of that call (its batch per card: gathered or split)."""
    import numpy as np
    import jax
    from scale_letkf_tpu.da.letkf import analyze, _auto_level_chunk
    from scale_letkf_tpu.ops.letkf_core import resolve_eigh_impl
    from test_analysis_sharded import make_case

    t0 = time.perf_counter()
    NZ, NY, NX = 4, 32, 32
    grid, gues, ctx, cfg, z_full = make_case(K=50, NZ=NZ, NY=NY, NX=NX,
                                             nobs=200)
    gues = np.asarray(gues, np.float32)
    batch = _auto_level_chunk(NZ, NY * NX, cfg.letkf.level_batch) * NY * NX
    anal_1, _, _ = analyze(jax.device_put(gues, jax.devices()[0]), ctx,
                           cfg, grid, z_full)
    anal_1 = np.asarray(anal_1)
    anal_4, _, _ = analyze(gues, ctx, cfg, grid, z_full, mesh=mesh)
    calls, gathers = _hlo_census(analyze(gues, ctx, cfg, grid, z_full,
                                         mesh=mesh, lower_only=True))
    ratio = _analysis_errors(anal_4, anal_1, gues)[0].max()
    impl_1, impl_4 = (resolve_eigh_impl("auto", 50, np.float32, sharded=s)
                      for s in (False, True))
    _say(f"  analyze() K=50 {NX}x{NY}x{NZ} mesh ('auto' -> {impl_4}) vs one "
         f"card ('auto' -> {impl_1}): max err/bound {ratio:.2f} "
         f"(bound {ANALYZE_TOL:.0e}·spread + 2 ulp); fused calls in the "
         f"mesh program: {len(calls)}, all-gathers: {gathers}; "
         f"{time.perf_counter() - t0:.1f} s")
    if not ratio <= 1.0 or calls:
        raise AssertionError("K=50 sharded analyze differs from one card, "
                             "or its program calls the fused kernel")

    t0 = time.perf_counter()
    cfg.letkf.eigh_impl = "ns_fused"
    try:
        calls, gathers = _hlo_census(analyze(gues, ctx, cfg, grid, z_full,
                                             mesh=mesh, lower_only=True))
        anal_f, _, _ = analyze(gues, ctx, cfg, grid, z_full, mesh=mesh)
        ratio = _analysis_errors(anal_f, anal_1, gues)[0].max()
        _say(f"  forced ns_fused on the mesh: fused-call batch {calls} of "
             f"{batch} gridpoints per scan step ({batch // 4} per card if "
             f"split), all-gathers {gathers}; vs one card max err/bound "
             f"{ratio:.2f}; {time.perf_counter() - t0:.1f} s")
    except Exception as e:      # an observation, not the mesh's own path
        _say(f"  forced ns_fused on the mesh: {type(e).__name__}: "
             f"{str(e).splitlines()[0][:300]}")


def phase_four_cards() -> None:
    import numpy as np
    import jax
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import __graft_entry__
    from scale_letkf_tpu.da.letkf import analyze
    from scale_letkf_tpu.parallel.mesh import make_mesh, shard_ensemble
    from scale_letkf_tpu.config import Config, EnsembleConfig
    from scale_letkf_tpu.grid import Grid, Projection
    from scale_letkf_tpu.cycle import CycleDriver
    from scale_letkf_tpu.model.dycore import DycoreConfig
    from scale_letkf_tpu.model.ideal import (
        balanced_state, add_warm_bubble, perturb_ensemble)
    from test_analysis_sharded import make_case

    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(4)
    _say(f"  dryrun_multichip(4): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    grid, gues, ctx, cfg, z_full = make_case(K=8, NZ=4, NY=32, NX=32,
                                             nobs=200)
    gues = np.asarray(gues, np.float32)
    anal_1, _, _ = analyze(jax.device_put(gues, jax.devices()[0]), ctx,
                           cfg, grid, z_full)
    mesh = make_mesh(2, 2, 1)
    anal_4, _, _ = analyze(gues, ctx, cfg, grid, z_full, mesh=mesh)
    spread = len(anal_4.sharding.device_set)
    a1, a4 = np.asarray(anal_1), np.asarray(anal_4)
    err = float(np.abs(a4 - a1).max())
    ok = np.allclose(a4, a1, rtol=SHARDED_TOL[0], atol=SHARDED_TOL[1])
    _say(f"  analyze() mesh (member=2, dy=2, dx=1) vs one card: max abs "
         f"diff {err:.2e} (rtol {SHARDED_TOL[0]:.0e} atol "
         f"{SHARDED_TOL[1]:.0e}); output on {spread} devices; "
         f"{time.perf_counter() - t0:.1f} s")
    if not ok or spread != 4:
        raise AssertionError("sharded analyze differs from one card")
    _sharded_k50(mesh)

    t0 = time.perf_counter()
    NZ, NY, NX, DX, DZ, K = 16, 64, 64, 2000.0, 400.0, 4
    g2 = Grid.stretched(nx=NX, ny=NY, nz=NZ, dx=DX, dy=DX, dz0=DZ,
                        stretch=1.05, proj=Projection(kind="LC"))
    qv = 0.006 * np.exp(-np.asarray(g2.cz) / 3000.0)
    s, rho_ref, p_ref = balanced_state(NZ, NY, NX, DZ, qv_prof=qv,
                                       cz=g2.cz)
    s = add_warm_bubble(s, DZ, DX, DX, amplitude=2.0)
    ens = perturb_ensemble(jax.random.PRNGKey(3), s, K, amplitude=0.5)
    xg, yg = np.meshgrid(np.arange(NX), np.arange(NY))
    topo = 120.0 * np.exp(-(((xg - NX / 2) / 6.0) ** 2
                            + ((yg - NY / 2) / 6.0) ** 2))
    outs = {}
    for halo in ("gspmd", "explicit"):
        dycfg = DycoreConfig(dx=DX, dy=DX, dz=DZ, dt=4.0, ztop=g2.ztop,
                             sponge_height=0.8 * g2.ztop, sponge_tau=60.0,
                             halo=halo)
        d = CycleDriver(g2, Config(ensemble=EnsembleConfig(member=K)),
                        dycfg, rho_ref, p_ref, mesh=mesh, core="si",
                        n_small=4, topo=topo)
        outs[halo] = jax.device_get(d.forecast(shard_ensemble(mesh, ens),
                                               4))
    worst = 0.0
    for name, a, b in zip(outs["gspmd"]._fields, outs["gspmd"],
                          outs["explicit"]):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(np.abs(a).max(), 1e-6)
        worst = max(worst, float(np.abs(b - a).max() / scale))
        if not np.allclose(b, a, rtol=HALO_TOL[0], atol=HALO_TOL[1] * scale):
            raise AssertionError(f"explicit halo differs from GSPMD: {name}")
    _say(f"  SI forecast {NX}x{NY}x{NZ} K={K}, 4 steps: explicit halo vs "
         f"GSPMD max diff/|field| {worst:.2e} (rtol {HALO_TOL[0]:.0e}, "
         f"atol {HALO_TOL[1]:.0e}·|field|); {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _child(args, env, deadline) -> str:
    """Run this script as a child process for one phase; relay its output.
    Returns its stdout; raises if it fails or outlives the deadline."""
    p = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                          *args], cwd=ROOT,
                         env=dict(env, PYTHONUNBUFFERED="1"),
                         stdout=subprocess.PIPE, text=True)
    # relay lines as they come, so a phase cut by the deadline still shows
    # how far it got
    timer = threading.Timer(max(1.0, deadline - time.monotonic()), p.kill)
    timer.start()
    try:
        lines = []
        for ln in p.stdout:
            _say(ln.rstrip("\n"))
            lines.append(ln)
        rc = p.wait()
    finally:
        timer.cancel()
        p.stdout.close()
    if rc != 0:
        raise RuntimeError(f"phase {args[1]} exited {rc}")
    return "".join(lines)


def _card_line() -> str:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return p.stdout.strip() or f"nvidia-smi rc={p.returncode}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def _run_phase(name: str, argv) -> None:
    """Child side: run one phase in this process."""
    if name in ("transform", "cycle", "fullsize", "four_cards"):
        sys.path.insert(0, str(ROOT))
        from scale_letkf_tpu.utils.compile_cache import enable_compile_cache
        enable_compile_cache()
    if name == "device":
        phase_device(int(argv[argv.index("--want") + 1]))
    elif name == "cli_setup":
        phase_cli_setup(argv[argv.index("--work") + 1])
    else:
        {"transform": phase_transform, "cycle": phase_cycle,
         "fullsize": phase_fullsize, "four_cards": phase_four_cards}[name]()


def main(argv) -> int:
    if "--phase" in argv:
        _run_phase(argv[argv.index("--phase") + 1], argv)
        return 0

    t_start = time.monotonic()
    deadline = t_start + BUDGET_S
    four = "--four-cards" in argv
    _say(f"card: {_card_line()}")
    device = None
    failed = []
    if not (ROOT / "scale_letkf_tpu").is_dir():
        failed.append("repo: scale_letkf_tpu package not next to the script")
        phases = ()
    else:
        phases = FOUR_CARDS if four else ONE_CARD
    for i, name in enumerate(phases):
        t0 = time.monotonic()
        letter = "abcde"[i] if not four else ("a", "f")[i]
        try:
            if name == "cli":
                run_cli_chain(deadline)
            else:
                extra = ["--want", "4" if four else "1"] \
                    if name == "device" else []
                out = _child(["--phase", name, *extra], dict(os.environ),
                             deadline)
                if name == "device":
                    line = [ln for ln in out.splitlines()
                            if ln.startswith("DEVICE ")][-1]
                    device = json.loads(line[len("DEVICE "):])
            status = "ok"
        except (RuntimeError, AssertionError, OSError,
                subprocess.SubprocessError, ValueError, IndexError) as e:
            status = "FAILED"
            failed.append(f"{name}: {str(e).splitlines()[0][:200]}")
        _say(f"phase {letter} {name}: {status} "
             f"{time.monotonic() - t0:.1f} s")
        if name == "device" and status != "ok":
            break
    _say(f"total {time.monotonic() - t_start:.1f} s")
    ok = not failed and device is not None
    result = {"ok": ok, "device": device}
    if not ok:
        result["failed"] = failed
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
