"""Benchmark: LETKF analysis + full DA-cycle performance on real hardware.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Budgeted to finish inside the driver's timeout: a global wall-clock budget
(BENCH_BUDGET_S env var, default 780 s) is enforced — every phase checks the
remaining budget before starting and bounds itself with a SIGALRM capped at
what is left, so the final JSON line ALWAYS prints. Phases that don't fit
report "skipped(budget...)" strings instead of hanging the whole run.

- headline: letkf transform throughput at the BASELINE.json config[0] unit
  (K=8, 30 local obs, 1e4 gridpoints), latency-compensated salted chains.
- letkf_core_sweep: reference ensemble sizes (MEMBER=50/100 operational,
  K=1024 big-ensemble north star) on the backend eigh_impl='auto' picks
  for each K on this device (ops/letkf_core.py resolve_eigh_impl).
- da_cycle: marginal per-cycle wall-clock of the FUSED cycle (forecast +
  H(x) + QC + LETKF as one device program, da/fastcycle.py) vs the SAME
  fused pipeline on host CPU — BASELINE.md's ≥10x cycle target. CPU
  baselines run as CONCURRENT subprocesses pinned to JAX_PLATFORMS=cpu, so
  they never open the accelerator.
- full_size: the flagship configs at REFERENCE size — only when enough
  budget remains (raise BENCH_BUDGET_S to include them).

The run refuses to start without an accelerator: a number taken on the
CPU is never reported under the device metric's name. Every result names
the device it ran on (platform, device_kind, device count).

Failures are REPORTED as strings in the JSON (never silently nulled).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

_T0 = time.monotonic()
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "780"))


def _remaining():
    return BUDGET_S - (time.monotonic() - _T0)


def _note(msg):
    print(f"[bench +{time.monotonic() - _T0:.0f}s] {msg}", file=sys.stderr,
          flush=True)


class _Timeout(Exception):
    pass


def _alarm(seconds: float):
    """Bound a phase with SIGALRM, capped at the remaining global budget
    (minus margin for the final JSON print)."""
    seconds = max(1, int(min(seconds, _remaining() - 20)))

    def handler(signum, frame):
        raise _Timeout(f"phase exceeded {seconds}s alarm")
    signal.signal(signal.SIGALRM, handler)
    signal.alarm(seconds)


def _err_str(e):
    return f"{type(e).__name__}: {str(e)[:300]}"


def bench_transform(B=10_000, L=30, K=8, n_lo=8, n_hi=208, reps=4,
                    eigh_impl="auto"):
    """Throughput of the full transform. Timing is to-value (a device
    reduction is fetched, so asynchronous dispatch cannot fake the number)
    and LATENCY-COMPENSATED: each call runs a dependent in-device chain of
    n iterations (every iteration sees different, iteration-salted inputs,
    so none can be elided), and the per-iteration time is the difference
    quotient between two chain lengths — the host↔device round-trip
    latency cancels exactly."""
    import jax
    import jax.numpy as jnp
    from functools import partial
    from scale_letkf_tpu.ops.letkf_core import letkf_core, total_weight

    rng = np.random.default_rng(0)
    hdxb = jnp.asarray(rng.standard_normal((B, L, K)), jnp.float32)
    rdiag = jnp.asarray(rng.uniform(0.5, 2.0, (B, L)), jnp.float32)
    rloc = jnp.asarray(rng.uniform(0.05, 1.0, (B, L)), jnp.float32)
    dep = jnp.asarray(rng.standard_normal((B, L)), jnp.float32)
    infl = jnp.ones(B, jnp.float32)

    @partial(jax.jit, static_argnums=6)
    def run(hdxb, rdiag, rloc, dep, infl, salt0, n):
        def body(carry, i):
            # salt EVERY input that feeds the transform — in particular
            # hdxb, so the Gram matrix + inverse-sqrt (the dominant cost)
            # cannot be hoisted out of the scan as loop-invariant
            s = salt0 + 1e-6 * i.astype(jnp.float32)
            res = letkf_core(hdxb * (1.0 + s), rdiag, rloc,
                             dep + s,
                             infl, infl_update=True, eigh_impl=eigh_impl)
            w = total_weight(res.trans, res.transm, jnp.ones_like(infl))
            return carry + w.sum() * 1e-6 + res.infl.sum() * 1e-6, None
        out, _ = jax.lax.scan(body, jnp.float32(0.0), jnp.arange(n))
        return out

    def timed(n, salt0):
        t0 = time.perf_counter()
        float(run(hdxb, rdiag, rloc, dep, infl, salt0, n))
        return time.perf_counter() - t0

    timed(n_lo, 0.0)   # warm-up/compile both shapes
    timed(n_hi, 0.0)
    best = np.inf
    for r in range(reps):
        t_lo = timed(n_lo, 1e-5 * r)
        t_hi = timed(n_hi, 1e-5 * r + 1e-7)
        per_iter = (t_hi - t_lo) / (n_hi - n_lo)
        if per_iter > 0:
            best = min(best, per_iter)
    if not np.isfinite(best):
        raise RuntimeError("timing difference non-positive")
    return B / best


def bench_sweep(headline_gps=None, L=30):
    """letkf_core throughput at reference ensemble sizes (MEMBER=50/100
    operational configs, K=1024 big-ensemble north star — BASELINE.md) on
    the backend eigh_impl='auto' picks for each K on this device. K=8
    reuses the headline measurement (identical configuration) instead of
    re-timing it."""
    import jax.numpy as jnp
    from scale_letkf_tpu.ops.letkf_core import resolve_eigh_impl
    plan = [  # (K, B, n_lo, n_hi, est_seconds)
        (50, 4096, 4, 24, 150),
        (100, 2048, 4, 16, 150),
        (1024, 32, 1, 3, 180),
    ]
    out = {}
    if headline_gps is not None:
        out["K8"] = {resolve_eigh_impl("auto", 8, jnp.float32):
                     round(headline_gps, 1)}
    for K, B, n_lo, n_hi, est in plan:
        impl = resolve_eigh_impl("auto", K, jnp.float32)
        out.setdefault(f"K{K}", {})
        if _remaining() < est:
            out[f"K{K}"][impl] = f"skipped(budget: {_remaining():.0f}s left)"
            continue
        try:
            _alarm(est * 2)
            gps = bench_transform(B=B, L=L, K=K, n_lo=n_lo, n_hi=n_hi,
                                  reps=2)
            signal.alarm(0)
            out[f"K{K}"][impl] = round(gps, 1)
            _note(f"sweep K={K} {impl}: {gps:.1f} pts/s")
        except Exception as e:
            signal.alarm(0)
            out[f"K{K}"][impl] = _err_str(e)
            _note(f"sweep K={K} {impl} FAILED: {_err_str(e)}")
    return out


def fused_osse_case(nsteps=5):
    """The small-but-real fused-cycle OSSE: 48x48x16 stretched grid, K=8,
    SI core (HEVI), conventional network with the reference BDA obs cap.
    Returns (FusedCycle, truth0, ens0); FusedCycle.run_osse drives it."""
    import jax
    import jax.random as jrandom
    from scale_letkf_tpu.config import Config, EnsembleConfig, LetkfConfig
    from scale_letkf_tpu.grid import Grid, Projection
    from scale_letkf_tpu.cycle import CycleDriver
    from scale_letkf_tpu.model.dycore import DycoreConfig
    from scale_letkf_tpu.model.ideal import (
        balanced_state, add_warm_bubble, perturb_ensemble)
    from scale_letkf_tpu.da.obsmake import make_obs_network
    from scale_letkf_tpu.da.fastcycle import FusedCycle

    NX = NY = 48
    NZ = 16
    DX = DY = 2000.0
    DZ0, STRETCH = 300.0, 1.08
    K = 8
    grid = Grid.stretched(nx=NX, ny=NY, nz=NZ, dx=DX, dy=DY, dz0=DZ0,
                          stretch=STRETCH, proj=Projection(kind="LC"))
    qv = 0.008 * np.exp(-grid.cz / 3000.0)
    s0, rho_ref, p_ref = balanced_state(NZ, NY, NX, DZ0, qv_prof=qv,
                                        cz=grid.cz)
    base = add_warm_bubble(s0, DZ0, DX, DY, amplitude=3.0)
    cfg = Config(ensemble=EnsembleConfig(member=K),
                 letkf=LetkfConfig(infl_mul=1.1, relax_alpha=0.5))
    cfg.letkf_obs.hori_local = tuple([40.0e3] + [-1.0] * 23)
    cfg.letkf_obs.max_nobs_per_grid = tuple([100] + [-1] * 23)
    dycfg = DycoreConfig(dx=DX, dy=DY, dz=DZ0, dt=4.0, ztop=grid.ztop,
                         sponge_height=0.8 * grid.ztop, sponge_tau=120.0)
    driver = CycleDriver(grid, cfg, dycfg, rho_ref, p_ref,
                         core="si", n_small=4)

    allp = perturb_ensemble(jrandom.PRNGKey(0), base, K + 1, amplitude=0.5)
    truth0 = jax.tree.map(lambda a: a[0], allp)
    ens = jax.tree.map(lambda a: a[1:], allp)
    rng = np.random.default_rng(0)
    template = make_obs_network(grid, rng, n_profiles=40,
                                levels_hpa=(900.0, 700.0, 500.0))
    return FusedCycle(driver, template, nsteps=nsteps), truth0, ens


def bench_cycle(nsteps=5, n_cycles=4, seeds=2):
    """Marginal per-cycle wall-clock of the FUSED DA cycle (ensemble
    forecast + H(x) + in-graph QC + LETKF analysis as ONE device program,
    da/fastcycle.py) on fused_osse_case().

    One scan length only (one big compile); per-cycle = total/n_cycles.
    The uncompensated host↔device latency (~ms) is <2% of n_cycles×cycle
    time. Each rep uses a different seed so no call repeats inputs.
    Returns (seconds_per_cycle, meta)."""
    import jax
    fc, truth0, ens = fused_osse_case(nsteps)
    # warm-up compiles the single scan length
    jax.block_until_ready(fc.run_osse(truth0, ens, n_cycles, seed=99)[2][0])
    best = np.inf
    for r in range(seeds):
        t0 = time.perf_counter()
        jax.block_until_ready(
            fc.run_osse(truth0, ens, n_cycles, seed=r)[2][0])
        best = min(best, (time.perf_counter() - t0) / n_cycles)
    g = fc.grid
    meta = {"grid": f"{g.nx}x{g.ny}x{g.nz}", "members": fc.cfg.ensemble.member,
            "steps": nsteps, "nobs": int(fc.template.nobs), "core": "si",
            "mode": "fused"}
    return best, meta


def _collect_subprocess(proc, deadline_s, label, result, err_key):
    """Collect a concurrently-launched CPU-baseline subprocess: wait up to
    deadline_s (but never past the global budget), parse the last stdout
    line as a float, record errors under err_key."""
    if proc is None:
        return None
    try:
        timeout = max(1.0, min(deadline_s, _remaining() - 15))
        out, _ = proc.communicate(timeout=timeout)
        val = float(out.strip().splitlines()[-1])
        _note(f"{label} cpu baseline: {val}")
        return val
    except Exception as e:
        try:
            proc.kill()
            proc.communicate(timeout=10)
        except Exception:
            pass
        result[err_key] = _err_str(e)
        _note(f"{label} cpu baseline FAILED: {_err_str(e)}")
        return None


def _device():
    import jax
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def main():
    if "--cpu-raw" in sys.argv:
        # the CPU baseline keeps LAPACK eigh (lax) — the reference's own
        # algorithm choice and the fastest backend on CPU
        print(bench_transform(n_lo=2, n_hi=12, reps=2, eigh_impl="lax"))
        return

    if "--cycle-cpu-raw" in sys.argv:
        s, _ = bench_cycle()
        print(s)
        return

    from scale_letkf_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    device = _device()
    if device["platform"] == "cpu":
        print(json.dumps({"error": "no accelerator: JAX found only the "
                                   "CPU", "device": device}))
        sys.exit(2)
    _note(f"budget {BUDGET_S:.0f}s on {device}")
    result = {"device": device}

    # CPU baselines run CONCURRENTLY with the device phases as subprocesses
    # pinned to the CPU (they never open the accelerator), collected at
    # the end; niced so they cannot starve the main process's compiles
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cpu_proc = subprocess.Popen(
        ["nice", "-n", "10", sys.executable, __file__, "--cpu-raw"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    cpu_cycle_proc = subprocess.Popen(
        ["nice", "-n", "10", sys.executable, __file__, "--cycle-cpu-raw"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)

    try:
        _alarm(300)
        dev_gps = bench_transform()
        signal.alarm(0)
        _note(f"headline: {dev_gps:.1f} pts/s")
    except BaseException:
        signal.alarm(0)
        cpu_proc.kill()
        cpu_cycle_proc.kill()
        raise

    try:
        result["letkf_core_sweep_gridpoints_per_s"] = bench_sweep(
            headline_gps=dev_gps)
    except Exception as e:
        result["letkf_core_sweep_gridpoints_per_s"] = _err_str(e)

    # full DA-cycle wall-clock (fused forecast+obsope+analysis), device vs
    # the same fused pipeline on host CPU — BASELINE.md's ≥10x target
    if _remaining() >= 180:
        try:
            _alarm(max(240, _remaining() - 120))
            dev_cycle_s, meta = bench_cycle()
            signal.alarm(0)
            _note(f"fused cycle: {dev_cycle_s:.4f}s/cycle on device")
            cycle = {"device_s": round(dev_cycle_s, 4), **meta}
            cpu_cycle_s = _collect_subprocess(
                cpu_cycle_proc, 600, "cycle", cycle, "cpu_error")
            if cpu_cycle_s:
                cycle["cpu_s"] = round(cpu_cycle_s, 4)
                cycle["speedup_vs_cpu"] = round(cpu_cycle_s / dev_cycle_s, 2)
            result["da_cycle"] = cycle
        except Exception as e:
            signal.alarm(0)
            result["da_cycle"] = _err_str(e)
            _note(f"fused cycle FAILED: {_err_str(e)}")
    else:
        result["da_cycle"] = f"skipped(budget: {_remaining():.0f}s left)"
    cpu_cycle_proc.kill()

    # flagship configs at reference size (no domain_overrides) via the
    # DEVICE-RESIDENT executor (da/resident.py): the ensemble is generated
    # and analyzed entirely in device memory
    full = {}
    for key, fn_name, est in (
            ("japan_18km", "bench_18km_analysis_resident", 400),
            ("radar_1km", "bench_radar_analysis_resident", 170)):
        if _remaining() < est:
            full[key] = f"skipped(budget: {_remaining():.0f}s left < {est}s)"
            continue
        try:
            _alarm(_remaining() - 60)
            import scale_letkf_tpu.bench_fullsize as bf
            full[key] = getattr(bf, fn_name)()
            signal.alarm(0)
            _note(f"full_size {key}: done")
        except Exception as e:
            signal.alarm(0)
            full[key] = _err_str(e)
            _note(f"full_size {key} FAILED: {_err_str(e)}")
    result["full_size"] = full

    # make sure the CPU headline subprocess is reaped
    cpu_gps = _collect_subprocess(cpu_proc, 60, "headline", result,
                                  "cpu_baseline_error")

    unit = (f"gridpoints/s (K=8, nobsl=30, B=1e4, platform="
            f"{device['platform']}; baseline=same batched pipeline on "
            f"host CPU)")
    print(json.dumps({
        "metric": "letkf_analysis_gridpoints_per_s_per_chip",
        "value": round(dev_gps, 1),
        "unit": unit,
        "vs_baseline": (round(dev_gps / cpu_gps, 2) if cpu_gps else None),
        **result,
    }))


if __name__ == "__main__":
    main()
