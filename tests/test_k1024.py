"""Big-ensemble (K=1024) assimilation actually COMPOSED — not just the
letkf_core microbenchmark. Exercises the 1024-member forecast, obsope,
ensemble transpose (mesh member axis), and transform memory behavior on a
tiny grid (BASELINE config 5 / the reference's K-computer 1000-member
scale intent, scale/run/misc/k_stg.py:3-12)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from scale_letkf_tpu.config import Config, EnsembleConfig, LetkfConfig
from scale_letkf_tpu.grid import Grid, Projection
from scale_letkf_tpu.cycle import CycleDriver
from scale_letkf_tpu.model.dycore import DycoreConfig
from scale_letkf_tpu.model.ideal import (
    balanced_state, add_warm_bubble, perturb_ensemble)
from scale_letkf_tpu.da.obsmake import make_obs_network

K = 1024
NZ, NY, NX = 3, 6, 6
DZ, DX, DY = 500.0, 2000.0, 2000.0


def _case(mesh=None):
    grid = Grid.uniform(nx=NX, ny=NY, nz=NZ, dx=DX, dy=DY, dz=DZ,
                        proj=Projection(kind="LC"))
    cfg = Config(ensemble=EnsembleConfig(member=K),
                 letkf=LetkfConfig(infl_mul=1.02, relax_alpha=0.2,
                                   # LAPACK eigh is the fast CPU backend;
                                   # at K=1024 'auto' resolves to the
                                   # Newton-Schulz matmul path
                                   eigh_impl="lax"))
    cfg.letkf_obs.hori_local = tuple([3.0 * DX] + [-1.0] * 23)
    cfg.obs_error.u = cfg.obs_error.v = cfg.obs_error.t = 0.05
    dycfg = DycoreConfig(dx=DX, dy=DY, dz=DZ, dt=1.0, ztop=NZ * DZ)
    s0, rho_ref, p_ref = balanced_state(NZ, NY, NX, DZ)
    s0 = add_warm_bubble(s0, DZ, DX, DY, amplitude=2.0,
                         center=(NX * DX / 2, NY * DY / 2, 0.8e3),
                         radius=(3e3, 3e3, 1e3))
    driver = CycleDriver(grid, cfg, dycfg, rho_ref, p_ref, mesh=mesh)
    allp = perturb_ensemble(jax.random.PRNGKey(0), s0, K + 1, amplitude=0.5)
    truth = jax.tree.map(lambda a: a[0], allp)
    ens = jax.tree.map(lambda a: a[1:], allp)
    return grid, cfg, driver, truth, ens


@pytest.mark.slow
def test_k1024_mini_osse():
    grid, cfg, driver, truth, ens = _case()
    rng = np.random.default_rng(0)
    template = make_obs_network(grid, rng, n_profiles=8,
                                levels_hpa=(960.0, 890.0),
                                elems=(2819, 3073))   # U, T
    truth, ens_a, res = driver.run_osse(
        truth0=truth, ens0=ens, obs_template=template,
        n_cycles=1, steps_per_cycle=2, seed=0)
    for a in ens_a:
        assert np.isfinite(np.asarray(a)).all()
    # with K >> nobs the ensemble-space update is essentially exact:
    # both state-space and obs-space errors must improve
    assert res.rmse_anal[0] < res.rmse_gues[0], (res.rmse_gues,
                                                 res.rmse_anal)
    sg, sa = res.stats_gues[0], res.stats_anal[0]
    assert sa.rmse["T"] < sg.rmse["T"]
    assert res.spread[0] > 0


@pytest.mark.slow
def test_k1024_sharded_transpose():
    """K=1024 with the member axis on a mesh: the ensemble transpose
    (member-sharded forecast layout -> gridpoint-sharded analysis layout)
    must lower to an all-to-all and execute. The 1-vs-N-device analysis
    EQUALITY is covered at K=8 by test_analysis_sharded; re-running two
    full K=1024 analyses here exceeds the CPU rig, so this asserts the
    sharded path alone (compile + finite + transpose in the HLO)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from scale_letkf_tpu.parallel.mesh import make_mesh, AXIS_MEMBER

    mesh = make_mesh(2, 2, 2)
    nz, B = 2, 16
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((nz, K, B)), jnp.float32)
    x = jax.device_put(
        x, NamedSharding(mesh, P(None, AXIS_MEMBER, None)))

    @jax.jit
    def transpose(a):
        # the production two-step reshard (da/letkf.py gp_in: member on K
        # + (dy,dx) on B first — the direct reshard triggers GSPMD's
        # involuntary-full-rematerialization fallback)
        a = jax.lax.with_sharding_constraint(
            a, NamedSharding(mesh, P(None, AXIS_MEMBER, ("dy", "dx"))))
        a = jax.lax.with_sharding_constraint(
            a, NamedSharding(mesh,
                             P(None, None, ("dy", "dx", AXIS_MEMBER))))
        return a * 2.0

    hlo = transpose.lower(x).compile().as_text()
    assert "all-to-all" in hlo, "transpose did not lower to all-to-all"
    out = np.asarray(jax.device_get(transpose(x)))
    np.testing.assert_allclose(out, 2.0 * np.asarray(x), rtol=1e-6)
