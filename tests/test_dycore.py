"""Dynamical core tests: steady base state, warm bubble, conservation."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from scale_letkf_tpu.model.dycore import (
    DycoreConfig, DycoreState, rk3_step, integrate, to_collocated,
    from_collocated, moist_pressure,
)
from scale_letkf_tpu.model.ideal import (
    balanced_state, add_warm_bubble, perturb_ensemble,
)
from scale_letkf_tpu.state import state_trans, IA_W, IA_T, IR_RHO


NZ, NY, NX = 20, 16, 16
DZ, DX, DY = 500.0, 2000.0, 2000.0
DT = 1.0


def make_cfg(**kw):
    d = dict(dx=DX, dy=DY, dz=DZ, dt=DT, ztop=NZ * DZ,
             sponge_height=8.0e3, sponge_tau=120.0)
    d.update(kw)
    return DycoreConfig(**d)


def z_centers():
    return jnp.asarray((np.arange(NZ) + 0.5) * DZ, jnp.float32)


def test_base_state_steady():
    """A hydrostatically balanced resting atmosphere must stay at rest."""
    s, rho_ref, p_ref = balanced_state(NZ, NY, NX, DZ)
    cfg = make_cfg(sponge_height=0.0)
    s2 = integrate(s, cfg, rho_ref, p_ref, z_centers(), 50)
    w_max = float(jnp.abs(s2.rhow).max())
    assert w_max < 1e-3, f"spurious w in balanced state: {w_max}"
    drho = float(jnp.abs(s2.rho - s.rho).max())
    assert drho < 1e-6


def test_warm_bubble_rises():
    s, rho_ref, p_ref = balanced_state(NZ, NY, NX, DZ)
    s = add_warm_bubble(s, DZ, DX, DY, amplitude=2.0,
                        center=(NX * DX / 2, NY * DY / 2, 2.0e3))
    cfg = make_cfg()
    s2 = integrate(s, cfg, rho_ref, p_ref, z_centers(), 300)  # 5 minutes
    v = to_collocated(s2)
    anal = state_trans(v)
    w = np.asarray(anal[IA_W])
    # updraft forms above bubble center
    assert w.max() > 0.5, f"bubble did not rise: wmax={w.max()}"
    # field stays finite and bounded
    assert np.isfinite(np.asarray(s2.rhot)).all()
    assert float(jnp.abs(s2.rhow).max()) < 50.0
    # θ maximum altitude increased: center of mass of θ' rises
    theta0 = np.asarray(s.rhot / s.rho)
    theta2 = np.asarray(s2.rhot / s2.rho)
    base = theta0.mean(axis=(1, 2), keepdims=True)
    zc = (np.arange(NZ) + 0.5) * DZ
    anom0 = np.maximum(theta0 - base, 0).sum(axis=(1, 2))
    anom2 = np.maximum(theta2 - base, 0).sum(axis=(1, 2))
    com0 = (zc * anom0).sum() / anom0.sum()
    com2 = (zc * anom2).sum() / anom2.sum()
    assert com2 > com0 + 100.0, f"bubble center of mass did not rise: {com0} -> {com2}"


def test_mass_conservation():
    s, rho_ref, p_ref = balanced_state(NZ, NY, NX, DZ)
    s = add_warm_bubble(s, DZ, DX, DY)
    cfg = make_cfg(sponge_height=0.0)
    s2 = integrate(s, cfg, rho_ref, p_ref, z_centers(), 100)
    # accumulate in f64: the flux-form scheme is exactly conservative, but a
    # float32 jnp.sum over the domain has ~1e-5 relative noise of its own
    m0 = np.asarray(s.rho, np.float64).sum()
    m2 = np.asarray(s2.rho, np.float64).sum()
    assert abs(m2 - m0) / m0 < 1e-6, "mass not conserved"
    t0 = np.asarray(s.rhot, np.float64).sum()
    t2 = np.asarray(s2.rhot, np.float64).sum()
    assert abs(t2 - t0) / t0 < 1e-6, "rho-theta not conserved"


def test_tracer_advection_conservation():
    s, rho_ref, p_ref = balanced_state(NZ, NY, NX, DZ)
    # blob of qv
    rhoq = np.zeros((6, NZ, NY, NX), np.float32)
    rhoq[0, 3:6, 6:10, 6:10] = 0.005
    s = s._replace(rhoq=jnp.asarray(rhoq) * s.rho[None])
    s = add_warm_bubble(s, DZ, DX, DY)
    cfg = make_cfg(sponge_height=0.0)
    s2 = integrate(s, cfg, rho_ref, p_ref, z_centers(), 100)
    q0 = np.asarray(s.rhoq[0], np.float64).sum()
    q2 = np.asarray(s2.rhoq[0], np.float64).sum()
    assert abs(q2 - q0) / q0 < 1e-5


def test_collocated_round_trip_shapes():
    s, _, _ = balanced_state(NZ, NY, NX, DZ)
    v = to_collocated(s)
    assert v.shape == (11, NZ, NY, NX)
    s2 = from_collocated(v)
    np.testing.assert_allclose(s2.rho, s.rho, rtol=1e-6)
    np.testing.assert_allclose(s2.rhot, s.rhot, rtol=1e-6)
    # staggered round trip on smooth fields is near-exact for uniform winds
    s3 = s._replace(rhou=jnp.full_like(s.rhou, 5.0))
    v3 = to_collocated(s3)
    s4 = from_collocated(v3)
    np.testing.assert_allclose(s4.rhou, s3.rhou, rtol=1e-6)


def test_ensemble_vmap():
    s, rho_ref, p_ref = balanced_state(NZ, NY, NX, DZ)
    s = add_warm_bubble(s, DZ, DX, DY)
    ens = perturb_ensemble(jax.random.PRNGKey(0), s, 4, amplitude=0.3)
    assert ens.rho.shape == (4, NZ, NY, NX)
    cfg = make_cfg()
    zc = z_centers()
    step = jax.vmap(lambda st: rk3_step(st, cfg, rho_ref, p_ref, zc))
    ens2 = step(ens)
    assert ens2.rhot.shape == (4, NZ, NY, NX)
    # members differ
    d = float(jnp.abs(ens2.rhot[0] - ens2.rhot[1]).max())
    assert d > 0


def test_pressure_eos_matches_state_trans():
    s, _, _ = balanced_state(NZ, NY, NX, DZ)
    q_mr = s.rhoq / s.rho[None]
    p = moist_pressure(s.rhot, q_mr)
    anal = state_trans(to_collocated(s))
    np.testing.assert_allclose(np.asarray(p), np.asarray(anal[4]), rtol=1e-5)


def test_removed_advection_option_raises():
    """The tendency-backend switch is gone (only the XLA path remains):
    asking for it is a named error, not a silent default."""
    with pytest.raises(TypeError, match="advection"):
        make_cfg(advection="pallas")
