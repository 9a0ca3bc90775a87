"""Device-resident cycle executor (da/resident.py) equals the
member-streamed executor — the zero-transfer path for flagship configs
whose bf16 ensemble fits HBM (SURVEY §2.7 beyond-HBM, single-chip
counterpart of the reference's resident 48x50-rank state,
common_mpi_scale.f90:367-512)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from scale_letkf_tpu.da.bigcycle import StreamedCycle
from scale_letkf_tpu.da.resident import ResidentCycle, ResidentEnsemble
from scale_letkf_tpu.state import state_trans
from scale_letkf_tpu.model.dycore import to_collocated

from test_bigcycle import _setup, _setup_production


def _to_anal_vars(ens):
    return np.asarray(state_trans(jax.vmap(to_collocated)(ens)))


def test_resident_roundtrip():
    rng = np.random.default_rng(0)
    gues = (280.0 + rng.standard_normal((5, 11, 4, 8, 8))).astype(
        np.float32)
    re = ResidentEnsemble.from_host_gues(gues, batch=2)
    back = re.to_host_gues(batch=2)
    # members to bf16-of-deviation precision (the reconstructed mean
    # re-includes the devs' bf16 quantization: ~0.4%·|dev|/√K)
    dev_scale = np.abs(gues - gues.mean(axis=0)[None]).max()
    np.testing.assert_allclose(back.mean(axis=0), gues.mean(axis=0),
                               atol=0.005 * dev_scale)
    np.testing.assert_allclose(back, gues, atol=0.01 * dev_scale)


def test_resident_cycle_matches_streamed_production():
    """Full production composition (si + stretch + terrain + physics +
    boundary): resident cycle ≡ streamed cycle within the shared bf16
    deviation-storage tolerance."""
    grid, cfg, driver, ens, obs = _setup_production(K=4)
    nsteps = 4
    ens_host = jax.tree.map(lambda a: np.asarray(a), ens)

    sc = StreamedCycle(driver, member_batch=2, tile_rows=4)
    out_s, infl_s, rep_s = sc.cycle(
        jax.tree.map(np.copy, ens_host), obs, nsteps)
    anal_s = _to_anal_vars(out_s)

    driver.tsfc = None
    rc = ResidentCycle(driver, member_batch=2, tile_rows=4)
    re = ResidentEnsemble.from_host_gues(_to_anal_vars(ens), batch=2)
    rep_r = rc.cycle(re, obs, nsteps)
    anal_r = re.to_host_gues(batch=2)

    scale = max(np.abs(anal_s).max(), 1e-6)
    np.testing.assert_allclose(anal_r, anal_s, atol=4e-2 * scale, rtol=4e-2)
    # departure statistics agree
    for key in ("stats_gues", "stats_anal"):
        rs, rr = rep_s[key], rep_r[key]
        for v in rs.rmse:
            if rs.nobs[v]:
                assert abs(rr.rmse[v] - rs.rmse[v]) < 0.1 * rs.rmse[v] + 1e-3
    # tsfc threaded
    np.testing.assert_allclose(np.asarray(re.tsfc), sc.tsfc_host,
                               rtol=1e-4, atol=1e-2)


def test_resident_4d_slots_matches_streamed():
    grid, cfg, driver, ens, obs = _setup(K=4, core="si")
    cfg.obsope.slot_start, cfg.obsope.slot_end = 1, 3
    cfg.obsope.slot_base = 2
    cfg.obsope.slot_tinterval = 4.0
    rng = np.random.default_rng(1)
    obs.dif = rng.choice([-4.0, 0.0, 4.0], obs.nobs)
    nsteps = 4

    # both executors start from the SAME analysis-variable representation
    # (the resident store is analysis variables; the collocation roundtrip
    # prognostic -> anal vars -> prognostic is not exact for staggered w)
    from scale_letkf_tpu.state import state_trans_inv
    from scale_letkf_tpu.model.dycore import from_collocated
    anal0 = _to_anal_vars(ens)
    ens_rt = jax.vmap(from_collocated)(state_trans_inv(jnp.asarray(anal0)))
    ens_host = jax.tree.map(lambda a: np.asarray(a), ens_rt)
    sc = StreamedCycle(driver, member_batch=2, tile_rows=4)
    gues_s, ensval_s, qc_s, _ = sc.forecast_and_hx(ens_host, nsteps, obs)

    rc = ResidentCycle(driver, member_batch=2, tile_rows=4)
    re = ResidentEnsemble.from_host_gues(anal0, batch=2)
    ensval_r, qc_r, _ = rc.forecast_and_hx(re, nsteps, obs)

    np.testing.assert_array_equal(qc_r, qc_s)
    good = qc_s == 0
    # the resident path starts from bf16-quantized deviations, so member
    # H(x) differs by ~0.4% of the perturbation magnitude — compare
    # against the ensemble spread, not the (possibly tiny) values
    diff = np.abs(np.asarray(ensval_r)[:, good] - ensval_s[:, good])
    sprd = ensval_s[:, good].std(axis=0)
    assert (diff <= 0.2 * sprd[None] + 1e-3).all(), \
        f"max diff {diff.max()} vs spread {sprd.max()}"


@pytest.mark.parametrize("backend,expected", [("gpu", True),
                                              ("cpu", False)])
def test_donate_on_every_backend_but_cpu(monkeypatch, backend, expected):
    """The resident executor's in-place updates donate their buffers on the
    GPU (and any non-CPU backend); the CPU backend ignores donation."""
    from scale_letkf_tpu.da import resident
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert resident._donate() is expected
