"""The full-size cycle benchmarks (bench_fullsize.bench_{18km,radar}_cycle)
run end-to-end on coarsened versions of the shipped flagship configs —
proving the member-streamed complete-cycle path (forecast + obsope +
analysis) works AS WIRED for both configurations (reference:
cycle.sh:141-345 runs the whole cycle at 480x360x36, K=50)."""

import numpy as np
import pytest

from scale_letkf_tpu.bench_fullsize import bench_18km_cycle, \
    bench_radar_cycle, radar_cycle_resident

SMALL = {"nx": 16, "ny": 16, "nz": 12}


def test_18km_cycle_coarse():
    out = bench_18km_cycle(nsteps=4, overrides=SMALL, members=4,
                           member_batch=2, tile_rows=4,
                           n_sonde=10, n_ps=10)
    assert out["members"] == 4
    assert out["nobs_good"] > 0
    assert out["steps_run"] == 4 and out["window_steps"] == 720
    assert out["s_per_member_step"] > 0
    assert "das_letkf_s" in out
    # O-B/O-A recorded and the analysis fits the obs at least as well
    if "oma_rmse_T" in out:
        assert out["oma_rmse_T"] <= out["omb_rmse_T"] * 1.05


def test_radar_cycle_coarse():
    out = bench_radar_cycle(overrides=dict(SMALL, dx=3000.0, dy=3000.0),
                            members=4, member_batch=2, tile_rows=4,
                            n_obs_target=4000)
    assert out["members"] == 4
    assert out["steps_run"] == 15          # the FULL 30-s window at dt=2
    assert out["nobs"] > 100
    assert np.isfinite(out["total_s"])


def test_radar_cycle_resident_coarse():
    """The device-resident radar cycle chip_smoke.py runs at full size, on
    a coarsened grid: the full 30-s window, finite analysis, REF obs with
    echoes, and the analysis fits them at least as well as the guess."""
    import jax.numpy as jnp
    rep, ens = radar_cycle_resident(
        overrides=dict(SMALL, dx=3000.0, dy=3000.0), members=4,
        member_batch=2, tile_rows=4, n_obs_target=4000)
    assert rep["steps"] == 15 and rep["members"] == 4
    assert bool(jnp.isfinite(ens.mean).all())
    sg, sa = rep["stats_gues"], rep["stats_anal"]
    assert sg.nobs["REF"] > 100
    assert sa.rmse["REF"] <= sg.rmse["REF"]


def test_osse_impact_coarsened():
    """Multi-cycle OSSE with a no-DA control (coarsened shape of the
    bench_osse_impact experiment): by the last cycle the DA system's
    guess must beat the control, and the analysis must beat the guess
    on average."""
    import numpy as np
    from scale_letkf_tpu.bench_fullsize import bench_osse_impact
    out = bench_osse_impact(
        members=16, n_cycles=3, steps_per_cycle=8, spinup_steps=8,
        member_batch=8, tile_rows=4, n_sonde=40, n_ps=60,
        overrides={"nx": 32, "ny": 24, "nz": 8, "n_small": 4},
        infl_mul=1.1, relax_alpha=0.5, obs_err_scale=0.3)
    g = np.asarray(out["rmse_gues"])
    a = np.asarray(out["rmse_anal"])
    c = np.asarray(out["rmse_ctrl"])
    assert np.isfinite(g).all() and np.isfinite(a).all()
    # analyses improve on their guesses on average
    assert a.mean() < g.mean()
    # the DA system beats the free-running control by the final cycle
    # (the truth carries unmodeled solar forcing the control cannot know
    # about; the margin grows with cycle length — the full-size
    # bench_osse_impact experiment uses 30-min cycles)
    assert g[-1] < c[-1] * 0.97
