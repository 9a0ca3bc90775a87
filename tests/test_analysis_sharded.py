"""Mesh-sharded production analysis + newly-wired DA options.

1. `analyze()` on an 8-device (member, dy, dx) mesh must equal the
   single-device result (the GSPMD 'ensemble transpose' path replacing
   scatter_grd_mpi_alltoall, reference common_mpi_scale.f90:1279).
2. Additive inflation (INFL_ADD, letkf_tools.f90:804-929) wired into
   analyze(): shuffle, radar-proximity (REF_ONLY) weight, q-ratio.
3. RELAX_SPREAD_OUT produces the RTPS factor field (letkf_tools.f90:735-759).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from scale_letkf_tpu.config import Config, LetkfConfig, EnsembleConfig
from scale_letkf_tpu.grid import Grid, Projection
from scale_letkf_tpu.da.letkf_obs import build_obs_context
from scale_letkf_tpu.da.letkf import analyze
from scale_letkf_tpu.parallel.mesh import make_mesh
from scale_letkf_tpu.obs.types import (
    Observations, ID_T, ID_U, ID_RADAR_REF, TYP_PHARAD,
)
from scale_letkf_tpu.state import NV3D, IA_T, IA_P, IA_U, IA_Q0


def make_case(K=8, NZ=3, NY=8, NX=8, nobs=25, seed=0, letkf_kw=None):
    grid = Grid.uniform(nx=NX, ny=NY, nz=NZ, dx=2e3, dy=2e3, dz=500.0,
                        proj=Projection(kind="LC"))
    rng = np.random.default_rng(seed)
    gues = np.zeros((K, NV3D, NZ, NY, NX))
    gues[:, IA_U] = 5.0 + rng.standard_normal((K, NZ, NY, NX))
    gues[:, IA_T] = 280.0 + rng.standard_normal((K, NZ, NY, NX))
    gues[:, IA_P] = 850e2 * np.exp(
        -np.arange(NZ)[None, :, None, None] * 0.1) \
        + rng.standard_normal((K, NZ, NY, NX))
    gues[:, IA_Q0] = 1e-3 + 1e-4 * rng.standard_normal((K, NZ, NY, NX))
    gues = jnp.asarray(gues)

    lon2d, lat2d = grid.lonlat
    jj = rng.integers(1, NY - 1, nobs)
    ii = rng.integers(1, NX - 1, nobs)
    kk = rng.integers(0, NZ, nobs)
    elem = np.where(rng.uniform(size=nobs) < 0.5, ID_T, ID_U).astype(np.int32)
    obs = Observations(
        elem=elem,
        lon=lon2d[jj, ii], lat=lat2d[jj, ii],
        lev=850e2 * np.exp(-kk * 0.1),
        dat=np.where(elem == ID_T, 280.0, 5.0)
        + rng.standard_normal(nobs),
        err=np.ones(nobs), typ=np.zeros(nobs, np.int32),
        dif=np.zeros(nobs))
    ia = np.where(elem == ID_T, IA_T, IA_U)
    ensval = np.stack([
        np.asarray(gues[m, ia, kk, jj, ii]) for m in range(K)])
    cfg = Config(ensemble=EnsembleConfig(member=K),
                 letkf=LetkfConfig(**(letkf_kw or {"infl_mul": 1.1})))
    cfg.letkf_obs.hori_local = tuple([10.0e3] + [-1.0] * 23)
    ctx = build_obs_context(obs, ensval, np.zeros(nobs, np.int32), cfg, grid)
    z_full = grid.calc_z(jnp.zeros((NY, NX)))
    return grid, gues, ctx, cfg, z_full


def test_sharded_analyze_equals_single_device():
    grid, gues, ctx, cfg, z_full = make_case()
    anal_ref, _, diag_ref = analyze(gues, ctx, cfg, grid, z_full)

    mesh = make_mesh(2, 2, 2)
    anal_sh, _, diag_sh = analyze(gues, ctx, cfg, grid, z_full, mesh=mesh)
    np.testing.assert_allclose(np.asarray(anal_sh), np.asarray(anal_ref),
                               rtol=1e-5, atol=1e-6)


def test_sharded_analyze_transpose_is_alltoall():
    """The member→gridpoint 'ensemble transpose' must lower to all-to-all,
    not GSPMD's 'involuntary full rematerialization' (replicate+slice)
    fallback (reference: scatter_grd_mpi_alltoall,
    common_mpi_scale.f90:1279)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    grid, gues, ctx, cfg, z_full = make_case()
    mesh = make_mesh(2, 2, 2)
    # hand analyze() the forecast layout: member-sharded K, (dy,dx) spatial
    gues_sh = jax.device_put(
        gues, NamedSharding(mesh, P("member", None, None, "dy", "dx")))
    hlo = analyze(gues_sh, ctx, cfg, grid, z_full, mesh=mesh,
                  lower_only=True)
    assert "all-to-all" in hlo
    # the remat fallback manifests as an all-gather over every mesh axis of
    # the pert input; a clean transpose needs none on the big arrays
    assert "full rematerialization" not in hlo


def test_sharded_analyze_auto_avoids_fused_kernel(monkeypatch):
    """On a mesh eigh_impl='auto' never picks the fused kernel, a custom
    call the partitioner would gather the whole batch for. With the
    backend reported as 'gpu', K=20 alone resolves to that kernel (which
    cannot lower here); on the mesh it resolves to 'ns', which runs here
    and equals the single-device analysis."""
    from scale_letkf_tpu.ops import letkf_core as lc
    grid, gues, ctx, cfg, z_full = make_case(K=20)
    gues = gues.astype(jnp.float32)       # the kernel's dtype
    anal_ref, _, _ = analyze(gues, ctx, cfg, grid, z_full)
    monkeypatch.setattr(lc.jax, "default_backend", lambda: "gpu")
    assert lc.resolve_eigh_impl("auto", 20, jnp.float32) == "ns_fused"
    mesh = make_mesh(2, 2, 2)
    anal_sh, _, _ = analyze(gues, ctx, cfg, grid, z_full, mesh=mesh)
    np.testing.assert_allclose(np.asarray(anal_sh), np.asarray(anal_ref),
                               rtol=1e-5, atol=1e-6)


def test_sharded_analyze_adaptive_and_det():
    grid, gues, ctx, cfg, z_full = make_case(
        letkf_kw={"infl_mul": 1.0, "infl_mul_adaptive": True})
    det = gues[0] + 0.1
    a_ref, d_ref, g_ref = analyze(gues, ctx, cfg, grid, z_full, gues_det=det)
    mesh = make_mesh(2, 2, 2)
    a_sh, d_sh, g_sh = analyze(gues, ctx, cfg, grid, z_full, gues_det=det,
                               mesh=mesh)
    np.testing.assert_allclose(np.asarray(a_sh), np.asarray(a_ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(d_sh), np.asarray(d_ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g_sh.infl_field, g_ref.infl_field,
                               rtol=1e-6, atol=1e-8)


def test_additive_inflation_in_analyze():
    grid, gues, ctx, cfg, z_full = make_case()
    anal0, _, _ = analyze(gues, ctx, cfg, grid, z_full)

    cfg.letkf.infl_add = 0.5
    rng = np.random.default_rng(1)
    addi = jnp.asarray(np.asarray(gues)
                       + rng.standard_normal(gues.shape))
    anal1, _, _ = analyze(gues, ctx, cfg, grid, z_full, addi_ens=addi,
                          rng=rng)
    # mean unchanged (perturbation-only addition), spread increased
    np.testing.assert_allclose(np.asarray(anal1.mean(axis=0)),
                               np.asarray(anal0.mean(axis=0)),
                               rtol=1e-5, atol=1e-5)
    s0 = float(jnp.std(anal0[:, IA_T], axis=0).mean())
    s1 = float(jnp.std(anal1[:, IA_T], axis=0).mean())
    assert s1 > s0

    # shuffle keeps mean too
    cfg.letkf.infl_add_shuffle = True
    anal2, _, _ = analyze(gues, ctx, cfg, grid, z_full, addi_ens=addi,
                          rng=np.random.default_rng(2))
    np.testing.assert_allclose(np.asarray(anal2.mean(axis=0)),
                               np.asarray(anal0.mean(axis=0)),
                               rtol=1e-5, atol=1e-5)

    # missing addi ensemble is an error, not a silent no-op
    with pytest.raises(ValueError, match="INFL_ADD"):
        analyze(gues, ctx, cfg, grid, z_full)


def test_additive_inflation_ref_only_weight():
    """REF_ONLY: increments vanish away from radar reflectivity obs."""
    grid, gues, ctx, cfg, z_full = make_case(NY=12, NX=12, nobs=10)
    # add one radar-reflectivity ctype near a corner
    lon2d, lat2d = grid.lonlat
    K = gues.shape[0]
    robs = Observations(
        elem=np.asarray([ID_RADAR_REF], np.int32),
        lon=np.asarray([lon2d[2, 2]]), lat=np.asarray([lat2d[2, 2]]),
        lev=np.asarray([1000.0]), dat=np.asarray([30.0]),
        err=np.asarray([5.0]), typ=np.full(1, TYP_PHARAD, np.int32),
        dif=np.zeros(1),
        meta=np.asarray([float(lon2d[2, 2]), float(lat2d[2, 2]), 0.0]))
    ensval = 25.0 + np.random.default_rng(3).standard_normal((K, 1))
    # short radar localization so the far corner lies beyond the cutoff
    hl = [10.0e3] + [-1.0] * 23
    hl[TYP_PHARAD] = 2.0e3
    cfg.letkf_obs.hori_local = tuple(hl)
    ctx2 = build_obs_context(robs, ensval, np.zeros(1, np.int32), cfg, grid)

    addi = jnp.asarray(np.asarray(gues)
                       + np.random.default_rng(4).standard_normal(gues.shape))
    base, _, _ = analyze(gues, ctx2, cfg, grid, z_full)
    cfg.letkf.infl_add = 1.0
    cfg.letkf.infl_add_ref_only = True
    anal1, _, _ = analyze(gues, ctx2, cfg, grid, z_full, addi_ens=addi)
    d = np.abs(np.asarray(anal1) - np.asarray(base))
    # increment present near the radar obs, zero at the far corner
    assert d[:, IA_T, :, 2, 2].max() > 1e-4
    assert d[:, IA_T, :, 10, 10].max() < 1e-7


def test_rtps_field_output():
    grid, gues, ctx, cfg, z_full = make_case(
        letkf_kw={"infl_mul": 1.0, "relax_alpha_spread": 0.9,
                  "relax_spread_out": True})
    _, _, diag = analyze(gues, ctx, cfg, grid, z_full)
    assert diag.rtps_field is not None
    assert diag.rtps_field.shape == (NV3D,) + (3, 8, 8)
    # where obs constrained the ensemble, the RTPS factor exceeds 1;
    # far from obs it stays exactly 1 (reference work3da default)
    assert diag.rtps_field.max() > 1.0
    assert diag.rtps_field.min() >= 1.0 - 1e-6

    # RELAX_SPREAD_OUT without RTPS is a config error, not a no-op
    cfg.letkf.relax_alpha_spread = 0.0
    with pytest.raises(ValueError, match="RELAX_SPREAD_OUT"):
        analyze(gues, ctx, cfg, grid, z_full)
