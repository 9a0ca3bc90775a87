"""Full-size flagship-configuration benchmarks (BASELINE configs 3 & 4).

Runs the production `analyze()` at the REFERENCE's native problem sizes —
no domain_overrides — on one chip and reports wall-clock + peak HBM:

- dense-radar analysis: the bda_1km_radar.toml domain (192x192x48, K=50)
  with a ≥1e6-obs synthetic phased-array volume at 1-km localization
  (reference: config/BDA_d3_100m_256p_bf40/config.nml.letkf:38 HORI_LOCAL,
  config.main.K:69-77 MEMBER=100/30-s cycles)
- 18-km Japan analysis: the 2015summer_18km domain (480x360x36, K=50)
  with a synthetic PREPBUFR-style network (reference:
  config/2015summer_18km/config.nml.scale PARAM_PRC/PARAM_INDEX)

The states are synthetic (smooth random perturbations around a balanced
profile): the benchmark measures the analysis engine at full scale, not
forecast skill. Invoked by bench.py; also usable standalone:
    python -m scale_letkf_tpu.bench_fullsize [radar|18km]
"""

from __future__ import annotations

import time

import numpy as np


def _device_mem_gb():
    import jax
    try:
        st = jax.local_devices()[0].memory_stats()
        return round(st.get("peak_bytes_in_use", 0) / 2**30, 2)
    except Exception:
        return None


def _smooth_noise(rng, shape, passes=2):
    """Spatially-correlated noise (1-2-1 smoothed) for ensemble perts."""
    a = rng.standard_normal(shape).astype(np.float32)
    for ax in (-1, -2):
        for _ in range(passes):
            a = 0.5 * a + 0.25 * (np.roll(a, 1, ax) + np.roll(a, -1, ax))
    return a


def _synthetic_gues(rng, K, nz, ny, nx, cz):
    """(K, NV3D, nz, ny, nx) float32 analysis-variable ensemble around a
    hydrostatic profile — generated var by var to bound host memory."""
    from scale_letkf_tpu.state import NV3D, IA_U, IA_V, IA_W, IA_T, IA_P, \
        IA_Q0
    from scale_letkf_tpu.constants import RD, GRAV
    t_prof = (300.0 - 0.0065 * cz).astype(np.float32)
    p_prof = (1.0e5 * np.exp(-GRAV * cz / (RD * 280.0))).astype(np.float32)
    out = np.zeros((K, NV3D, nz, ny, nx), np.float32)
    base = {IA_U: 5.0, IA_V: 0.0, IA_W: 0.0}
    amp = {IA_U: 1.0, IA_V: 1.0, IA_W: 0.1, IA_T: 0.5, IA_P: 50.0}
    for v in range(NV3D):
        prof = (t_prof if v == IA_T else p_prof if v == IA_P
                else np.full(nz, base.get(v, 0.0), np.float32))
        a = amp.get(v, 1e-4 if v >= IA_Q0 else 0.5)
        for m in range(K):
            out[m, v] = prof[:, None, None] + a * _smooth_noise(
                rng, (nz, ny, nx))
        if v == IA_Q0:
            out[:, v] = np.abs(out[:, v]) + 1e-3
    return out


def _load_cfg(path, overrides=None):
    from scale_letkf_tpu.cli.main import load_config_and_grid
    return load_config_and_grid(path, domain_overrides=overrides)


def _synthetic_resident_gues(seed, K, grid, batch=10, t_offset=0.0,
                             smooth_strides=(1,), qr_blob: float = 0.0):
    """smooth_strides=(1,) reproduces the classic 2-pass 1-2-1 noise
    (correlation ~2 cells). Longer stride sets build SYNOPTIC-scale
    perturbations (multigrid smoothing, renormalized to the nominal
    amplitude) whose spatial degrees of freedom a K~50 ensemble can
    actually span — required for assimilation-impact OSSEs: with ~2-cell
    noise a localization volume holds hundreds of dofs and the ensemble
    subspace captures only a few percent of any truth error, so even a
    perfect LETKF cannot correct it.

    Device-generated synthetic analysis-variable ensemble in the
    RESIDENT (f32 mean + bf16 deviation) layout — the state never crosses
    the host↔device link. Matches _synthetic_gues's construction
    (hydrostatic profile + smoothed noise). qr_blob > 0 [kg/kg] adds one
    rain blob per member at a random position, so the radar operator
    sees echoes (as _synthetic_ens_dycore's host recipe)."""
    import jax
    import jax.numpy as jnp
    from scale_letkf_tpu.da.resident import ResidentEnsemble
    from scale_letkf_tpu.state import NV3D, IA_U, IA_V, IA_W, IA_T, IA_P, \
        IA_Q0
    from scale_letkf_tpu.constants import RD, GRAV
    from scale_letkf_tpu.da.bigcycle import _batch_of

    nz, ny, nx = grid.nz, grid.ny, grid.nx
    cz = np.asarray(grid.cz)
    # HYDROSTATICALLY CONSISTENT base: theta profile + hydrostatic p, then
    # T = theta*(p/p00)^(R/cp). The earlier ad-hoc pair (T from a lapse
    # rate, p from an isothermal scale height) was imbalanced enough to
    # blow up multi-ten-step integrations (w -> 45 m/s within 8 steps at
    # 36-km dx).
    from scale_letkf_tpu.model.ideal import (
        standard_theta_profile, hydrostatic_reference)
    from scale_letkf_tpu.constants import CPDRY
    dz0 = float(np.asarray(grid.fz)[1] - np.asarray(grid.fz)[0])
    theta_p = np.asarray(standard_theta_profile(nz, dz0, cz=cz),
                         np.float32)
    _, p_prof = (np.asarray(a, np.float32)
                 for a in hydrostatic_reference(theta_p, dz0, cz=cz))
    t_prof = theta_p * (p_prof / 1.0e5) ** (RD / CPDRY)
    prof = np.zeros((NV3D, nz), np.float32)
    prof[IA_T] = t_prof + t_offset
    prof[IA_P] = p_prof
    prof[IA_U] = 5.0
    prof[IA_Q0] = 1e-3
    amp = np.full(NV3D, 0.5, np.float32)
    amp[[IA_U, IA_V]] = 1.0
    amp[IA_W] = 0.1
    amp[IA_T] = 0.5
    amp[IA_P] = 50.0
    amp[IA_Q0:] = 1e-4
    prof_d = jnp.asarray(prof)[:, :, None, None]
    amp_d = jnp.asarray(amp)[:, None, None, None]

    # bound the generator's f32 temporaries (noise + smoothing copies
    # next to the donated bf16 dev buffer): ~0.6 GB per member-batch field
    field_elems = NV3D * nz * ny * nx
    batch = max(1, min(batch, int(150e6 // field_elems)))
    b = _batch_of(K, batch)
    from scale_letkf_tpu.da.resident import _donate

    def gen_batch(dev, accum, key, i0):
        noise = jax.random.normal(key, (b, NV3D, nz, ny, nx), jnp.float32)
        for s_ in smooth_strides:     # 1-2-1 smoothing, 2 passes/stride
            for ax in (-1, -2):
                for _ in range(2):
                    noise = 0.5 * noise + 0.25 * (
                        jnp.roll(noise, s_, ax) + jnp.roll(noise, -s_, ax))
        if smooth_strides != (1,):
            # vertical coherence (sondes sample columns; vertically jagged
            # perturbations destabilize the analysis states)
            for _ in range(2):
                noise = 0.5 * noise + 0.25 * (
                    jnp.roll(noise, 1, -3) + jnp.roll(noise, -1, -3))
            # renormalize toward the nominal amplitude, with a floor so
            # near-uniform fields are not inflated into giant modes
            std = jnp.std(noise, axis=(-1, -2), keepdims=True)
            noise = noise / jnp.maximum(std, 0.5)
        members = prof_d[None] + amp_d[None] * noise
        if qr_blob > 0:
            ctr = jax.random.uniform(jax.random.fold_in(key, 1), (b, 2),
                                     jnp.float32, minval=0.35, maxval=0.65)
            kk = jnp.arange(nz, dtype=jnp.float32)[:, None, None]
            jj = jnp.arange(ny, dtype=jnp.float32)[None, :, None]
            ii = jnp.arange(nx, dtype=jnp.float32)[None, None, :]
            cx = (ctr[:, 0] * nx)[:, None, None, None]
            cy = (ctr[:, 1] * ny)[:, None, None, None]
            blob = jnp.exp(-(((ii - cx) / (0.12 * nx)) ** 2
                             + ((jj - cy) / (0.12 * ny)) ** 2
                             + ((kk - 0.3 * nz) / (0.2 * nz)) ** 2))
            members = members.at[:, IA_Q0 + 2].add(qr_blob * blob)
        # positive moisture floor (as the host generator)
        q = jnp.abs(members[:, IA_Q0]) + 1e-3
        members = members.at[:, IA_Q0].set(q)
        # in-place batch write (donated buffer): the concat formulation
        # transiently doubled the 18-km dev allocation and OOM'd
        dev = jax.lax.dynamic_update_slice_in_dim(
            dev, (members - prof_d[None]).astype(jnp.bfloat16), i0, axis=0)
        return dev, accum + jnp.sum(members, axis=0)

    gen_jit = jax.jit(gen_batch,
                      donate_argnums=(0, 1) if _donate() else ())
    key = jax.random.PRNGKey(seed)
    dev = jnp.zeros((K, NV3D, nz, ny, nx), jnp.bfloat16)
    accum = jnp.zeros((NV3D, nz, ny, nx), jnp.float32)
    for i0 in range(0, K, b):
        key, sub = jax.random.split(key)
        dev, accum = gen_jit(dev, accum, sub, jnp.int32(i0))
    mean = accum / K
    return ResidentEnsemble(mean, dev, ref=jnp.broadcast_to(
        prof_d, (NV3D, nz, ny, nx)))


def _host_profiles(grid, dom):
    """Hydrostatic base profiles on HOST (no device transfers — eager jnp
    on big host arrays would be a host↔device round trip per op)."""
    from scale_letkf_tpu.model.ideal import (
        standard_theta_profile, hydrostatic_reference)
    cz = np.asarray(grid.cz)
    dz0 = float(np.asarray(grid.fz)[1] - np.asarray(grid.fz)[0])
    theta = np.asarray(standard_theta_profile(grid.nz, dz0, cz=cz))
    rho1d, p1d = (np.asarray(a) for a in
                  hydrostatic_reference(theta, dz0, cz=cz))
    qv0 = dom.get("qv_surface", 0.0)
    qv = (qv0 * np.exp(-cz / dom.get("qv_scale_height", 3000.0))
          ).astype(np.float32) if qv0 > 0 else np.zeros(grid.nz, np.float32)
    return theta.astype(np.float32), rho1d.astype(np.float32), \
        p1d.astype(np.float32), qv


def _synthetic_ens_dycore(rng, K, grid, dom, amp_theta=0.5,
                          qr_blob: float = 0.0):
    """Host-RAM DycoreState ensemble around the balanced base state with
    tapered per-member RHOT perturbations (the reference's init_perturb.py
    recipe: random tapered RHOT noise, scale/run/python/init_perturb.py).
    Optional per-member rain blobs (qr_blob [kg/kg] peak) give the radar
    operator echoes. Returns (DycoreState of np arrays (K leading),
    rho_ref (nz,1,1), p_ref (nz,1,1))."""
    from scale_letkf_tpu.model.dycore import DycoreState
    from scale_letkf_tpu.state import NQ
    from scale_letkf_tpu.constants import RD, CPDRY, CVDRY, PRE00

    nz, ny, nx = grid.nz, grid.ny, grid.nx
    theta, rho1d, p1d, qv = _host_profiles(grid, dom)
    # lateral taper (perturbations vanish at the boundary buffer)
    tx = np.minimum(np.arange(nx), nx - 1 - np.arange(nx))
    ty = np.minimum(np.arange(ny), ny - 1 - np.arange(ny))
    taper = (np.minimum(1.0, tx / 8.0)[None, :]
             * np.minimum(1.0, ty / 8.0)[:, None]).astype(np.float32)

    rho = np.broadcast_to(rho1d[:, None, None], (nz, ny, nx))
    s = DycoreState(
        rho=np.empty((K, nz, ny, nx), np.float32),
        rhou=np.zeros((K, nz, ny, nx), np.float32),
        rhov=np.zeros((K, nz, ny, nx), np.float32),
        rhow=np.zeros((K, nz + 1, ny, nx), np.float32),
        rhot=np.empty((K, nz, ny, nx), np.float32),
        rhoq=np.zeros((K, NQ, nz, ny, nx), np.float32))
    base_rhot = (rho1d * theta)[:, None, None]
    qv_rho = (qv * rho1d)[:, None, None]
    k, j, i = np.mgrid[0:nz, 0:ny, 0:nx]
    for m in range(K):
        s.rho[m] = rho
        dtheta = amp_theta * _smooth_noise(rng, (nz, ny, nx), passes=1)
        s.rhot[m] = base_rhot + rho * dtheta * taper[None]
        s.rhoq[m, 0] = qv_rho
        if qr_blob > 0:
            cx = nx * (0.35 + 0.3 * rng.random())
            cy = ny * (0.35 + 0.3 * rng.random())
            blob = np.exp(-(((i - cx) / (0.12 * nx)) ** 2
                            + ((j - cy) / (0.12 * ny)) ** 2
                            + ((k - 0.3 * nz) / (0.2 * nz)) ** 2)
                          ).astype(np.float32)
            s.rhoq[m, 2] += qr_blob * blob * rho
            s.rhoq[m, 1] += 0.5 * qr_blob * blob * rho
    p_ref = PRE00 * (rho1d * theta * RD / PRE00) ** (CPDRY / CVDRY)
    return s, rho1d.reshape(nz, 1, 1), p_ref.astype(np.float32).reshape(
        nz, 1, 1)


def _synthetic_topo(rng, ny, nx, amp=400.0, n_hills=12):
    """Smooth synthetic orography (Gaussian hills) standing in for the
    reference's scale-rm_pp_ens topo preprocessing (cycle.sh step 1)."""
    j, i = np.mgrid[0:ny, 0:nx]
    topo = np.zeros((ny, nx), np.float32)
    for _ in range(n_hills):
        cx = nx * rng.random()
        cy = ny * rng.random()
        sx = nx * (0.03 + 0.08 * rng.random())
        h = amp * rng.random()
        topo += h * np.exp(-(((i - cx) / sx) ** 2 + ((j - cy) / sx) ** 2))
    # flatten toward the lateral boundaries (bdy buffer compatibility)
    tx = np.minimum(i, nx - 1 - i) / 12.0
    ty = np.minimum(j, ny - 1 - j) / 12.0
    return (topo * np.clip(np.minimum(tx, ty), 0.0, 1.0)).astype(
        np.float32)


def _make_fullsize_driver(cfg, grid, dycfg, dom, rho_ref, p_ref,
                          production=True, ens_base=None, seed=7):
    """CycleDriver without make_driver's full-3-D balanced_state device
    allocation (only the (nz,1,1) reference columns are needed).

    production=True composes the reference's flagship configuration
    (common_mpi_scale.f90:833; config/example/config.main.hakushu:72-78):
    SI core + terrain + full physics suite + Davies boundary forcing
    toward the balanced base state (the scale_init parent-file stand-in).
    """
    import jax.numpy as jnp
    from scale_letkf_tpu.cycle import CycleDriver

    topo = None
    phys_cfg = None
    bdy = None
    bdy_width = 0
    if production:
        from scale_letkf_tpu.model.physics_suite import PhysicsConfig
        from scale_letkf_tpu.model.boundary import BoundaryData
        from scale_letkf_tpu.model.dycore import DycoreState
        from scale_letkf_tpu.state import NQ
        rng = np.random.default_rng(seed)
        topo = _synthetic_topo(rng, grid.ny, grid.nx,
                               amp=dom.get("topo_amp", 400.0))
        phys = dict(dom.get("physics", {}))
        phys.setdefault("mp_scheme",
                        "kessler" if dom.get("use_physics") else "nsw6")
        phys.setdefault("rad_interval", 10)
        phys.setdefault("slab_capacity", 2.0e5)
        phys_cfg = PhysicsConfig(**phys)
        # boundary target: the balanced base columns broadcast to 3-D,
        # HOST-resident numpy (uploaded per member batch by the stream)
        nz, ny, nx = grid.nz, grid.ny, grid.nx
        theta, rho1d, p1d, qv = _host_profiles(grid, dom)
        rho3 = np.broadcast_to(rho1d[:, None, None],
                               (nz, ny, nx)).astype(np.float32)
        rhot3 = np.broadcast_to((rho1d * theta)[:, None, None],
                                (nz, ny, nx)).astype(np.float32)
        rhoq3 = np.zeros((NQ, nz, ny, nx), np.float32)
        rhoq3[0] = (qv * rho1d)[:, None, None]
        zeros = np.zeros((nz, ny, nx), np.float32)
        base = DycoreState(rho=rho3, rhou=zeros, rhov=zeros,
                           rhow=np.zeros((nz + 1, ny, nx), np.float32),
                           rhot=rhot3, rhoq=rhoq3)
        bdy = BoundaryData(state0=base, state1=base, t0=0.0, t1=1.0e9)
        bdy_width = dom.get("bdy_width", 8)
    return CycleDriver(grid, cfg, dycfg, jnp.asarray(rho_ref),
                       jnp.asarray(p_ref),
                       use_physics=False if production
                       else dom.get("use_physics", False),
                       topo=topo, phys_cfg=phys_cfg, bdy=bdy,
                       bdy_width=bdy_width,
                       bdy_tau=dom.get("bdy_tau", 600.0),
                       core=dom.get("core", "explicit"),
                       n_small=dom.get("n_small", 6))


def _synthetic_radar_volume(cfg, dom, rng, n_obs_target=1_000_000):
    """Synthetic phased-array volume positions: az × elev × range gates
    around the configured radar (the reference PAWR: 100-m gates, 110
    elevations). dat is filled with plausible linear-Z noise; cycle
    benches overwrite it with H(truth)."""
    from scale_letkf_tpu.obs.types import (
        Observations, ID_RADAR_REF, ID_RADAR_VR, TYP_PHARAD)
    radar_lon = dom.get("radar_lon", 135.5)
    radar_lat = dom.get("radar_lat", 34.8)
    n_az, n_el = 120, 55
    n_gate = max(1, n_obs_target // (n_az * n_el * 2))
    az = np.linspace(0, 360, n_az, endpoint=False)
    el = np.linspace(1.0, 25.0, n_el)
    r = np.linspace(2e3, 58e3, n_gate)
    azg, elg, rg = np.meshgrid(az, el, r, indexing="ij")
    azr = np.deg2rad(azg).ravel()
    elr = np.deg2rad(elg).ravel()
    rr = rg.ravel()
    gx = rr * np.cos(elr) * np.sin(azr)
    gy = rr * np.cos(elr) * np.cos(azr)
    gz = dom.get("radar_z", 80.0) + rr * np.sin(elr)
    # projection → lon/lat via the grid (meters per degree approximation
    # around the basepoint is adequate for a synthetic volume)
    lon = radar_lon + gx / (111e3 * np.cos(np.deg2rad(radar_lat)))
    lat = radar_lat + gy / 111e3
    keep = gz < 15e3
    n2 = int(keep.sum())
    elem = np.empty(2 * n2, np.int32)
    elem[0::2] = ID_RADAR_REF
    elem[1::2] = ID_RADAR_VR
    dup = lambda a: np.repeat(a[keep], 2)
    dat = np.empty(2 * n2)
    dat[0::2] = 10.0 ** (np.clip(
        20.0 + 15.0 * _smooth_noise(rng, (n2,), 0), 5.0, 55.0) / 10.0)
    dat[1::2] = 5.0 * rng.standard_normal(n2)
    err = np.where(elem == ID_RADAR_REF, cfg.obs_error.radar_ref,
                   cfg.obs_error.radar_vr)
    return Observations(
        elem=elem, lon=dup(lon), lat=dup(lat), lev=dup(gz), dat=dat,
        err=err, typ=np.full(2 * n2, TYP_PHARAD, np.int32),
        dif=np.zeros(2 * n2),
        meta=np.asarray([radar_lon, radar_lat, dom.get("radar_z", 80.0)]))


def bench_radar_analysis(config="configs/bda_1km_radar.toml",
                         n_obs_target=1_000_000, seed=0):
    """Full-size dense-radar analysis on device. Returns a result dict."""
    from scale_letkf_tpu.da.letkf_obs import build_obs_context

    cfg, grid, dycfg, dom = _load_cfg(config)
    K = cfg.ensemble.member
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    rng = np.random.default_rng(seed)

    t0 = time.time()
    gues_np = _synthetic_gues(rng, K, nz, ny, nx, np.asarray(grid.cz))
    gen_s = time.time() - t0

    obs = _synthetic_radar_volume(cfg, dom, rng, n_obs_target)
    dat = obs.dat

    # synthetic ensemble H(x): dat + spread-consistent noise (the bench
    # measures the analysis engine; obsope is benchmarked separately)
    t0 = time.time()
    ensval = (dat[None, :]
              + rng.standard_normal((K, len(dat))).astype(np.float32)
              * obs.err[None, :])
    ctx = build_obs_context(obs, ensval, np.zeros(len(dat), np.int32),
                            cfg, grid)
    prep_s = time.time() - t0

    z_full = np.asarray(grid.calc_z(np.zeros((ny, nx))))

    # the K=50 state (3.9 GB) fits HBM but the analysis working set at
    # 1800-wide radar candidate tables does not — stream y-row tiles
    # through the chip (da/letkf_tiled.py; device compute and host↔device
    # transfer are reported separately)
    from scale_letkf_tpu.da.letkf_tiled import analyze_tiled
    t0 = time.time()
    anal, infl, stats = analyze_tiled(gues_np, ctx, cfg, grid, z_full,
                                      tile_rows=48)
    wall_s = time.time() - t0
    assert np.isfinite(anal).all()
    npts = nz * ny * nx
    return {
        "config": config, "grid": f"{nx}x{ny}x{nz}", "members": K,
        "nobs": int(len(dat)), "nobs_good": int((ctx.qc == 0).sum()),
        "analysis_s": round(wall_s, 1),
        "gridpoints_per_s": round(npts / max(stats["compute_s"], 1e-9), 1),
        "compute_s": round(stats["compute_s"], 2),
        "transfer_s": round(stats["transfer_s"], 2),
        "compile_s": round(stats["compile_s"], 2),
        "tiles": stats["tiles"],
        "peak_hbm_gb": _device_mem_gb(),
        "state_gen_s": round(gen_s, 1), "obs_prep_s": round(prep_s, 1),
    }


def _synthetic_conv_network(cfg, grid, rng, n_sonde=700, n_ps=2000):
    """Synthetic PREPBUFR-style network: ~700 sondes × 8 levels × 4 vars
    + 2000 surface pressure reports (JMA-era conventional density). dat is
    filled with plausible constants; cycle benches overwrite with
    H(truth) + noise."""
    from scale_letkf_tpu.obs.types import Observations, ID_U, ID_V, ID_T, \
        ID_Q, ID_PS
    nx, ny = grid.nx, grid.ny
    lon2d, lat2d = grid.lonlat
    si = rng.integers(2, nx - 2, n_sonde)
    sj = rng.integers(2, ny - 2, n_sonde)
    levs = np.asarray([925., 850., 700., 500., 400., 300., 250., 200.]) * 100
    rec_elem, rec_lon, rec_lat, rec_lev, rec_err = [], [], [], [], []
    e = cfg.obs_error
    for p in range(n_sonde):
        for lv in levs:
            for el, er in ((ID_U, e.u), (ID_V, e.v), (ID_T, e.t),
                           (ID_Q, e.q)):
                rec_elem.append(el)
                rec_lon.append(lon2d[sj[p], si[p]])
                rec_lat.append(lat2d[sj[p], si[p]])
                rec_lev.append(lv)
                rec_err.append(er)
    pi = rng.integers(2, nx - 2, n_ps)
    pj = rng.integers(2, ny - 2, n_ps)
    for p in range(n_ps):
        rec_elem.append(ID_PS)
        rec_lon.append(lon2d[pj[p], pi[p]])
        rec_lat.append(lat2d[pj[p], pi[p]])
        rec_lev.append(0.0)        # PS obs lev = station elevation [m]
        rec_err.append(e.ps)
    elem = np.asarray(rec_elem, np.int32)
    nobs = len(elem)
    dat = np.where(elem == ID_T, 280.0,
                   np.where(elem == ID_PS, 1000e2,
                            np.where(elem == ID_Q, 5e-3, 5.0))).astype(float)
    return Observations(elem=elem, lon=np.asarray(rec_lon),
                        lat=np.asarray(rec_lat), lev=np.asarray(rec_lev),
                        dat=dat, err=np.asarray(rec_err),
                        typ=np.zeros(nobs, np.int32), dif=np.zeros(nobs))


def bench_18km_analysis(config="configs/18km_japan.toml", seed=0,
                        tile_rows=20):
    """Full-size 18-km analysis. The K=50 480x360x36 state (13.7 GB f32)
    plus analysis buffers exceed one chip's HBM, so this uses the
    host-streamed tiled executor (da/letkf_tiled.py) — the single-chip
    counterpart of the reference's 48-rank domain decomposition."""
    from scale_letkf_tpu.da.letkf_obs import build_obs_context
    from scale_letkf_tpu.da.letkf_tiled import analyze_tiled

    cfg, grid, dycfg, dom = _load_cfg(config)
    K = cfg.ensemble.member
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    rng = np.random.default_rng(seed)

    t0 = time.time()
    gues_np = _synthetic_gues(rng, K, nz, ny, nx, np.asarray(grid.cz))
    gen_s = time.time() - t0

    obs = _synthetic_conv_network(cfg, grid, rng)
    nobs = obs.nobs
    dat, err = obs.dat, obs.err
    ensval = (dat[None, :] + rng.standard_normal((K, nobs)) * err[None, :]
              ).astype(np.float32)
    t0 = time.time()
    ctx = build_obs_context(obs, ensval, np.zeros(nobs, np.int32), cfg, grid)
    prep_s = time.time() - t0

    z_full = np.asarray(grid.calc_z(np.zeros((ny, nx))))
    t0 = time.time()
    anal, infl, stats = analyze_tiled(gues_np, ctx, cfg, grid, z_full,
                                      tile_rows=tile_rows)
    wall_s = time.time() - t0
    npts = nz * ny * nx
    return {
        "config": config, "grid": f"{nx}x{ny}x{nz}", "members": K,
        "nobs": int(nobs),
        "analysis_s": round(wall_s, 1),
        "gridpoints_per_s": round(npts / max(stats["compute_s"], 1e-9), 1),
        "compute_s": round(stats["compute_s"], 2),
        "transfer_s": round(stats["transfer_s"], 2),
        "compile_s": round(stats["compile_s"], 2),
        "tiles": stats["tiles"], "peak_hbm_gb": _device_mem_gb(),
        "state_gen_s": round(gen_s, 1), "obs_prep_s": round(prep_s, 1),
    }


def _cache_entries():
    import os
    from scale_letkf_tpu.utils.compile_cache import enable_compile_cache
    try:
        return len(os.listdir(enable_compile_cache()))
    except OSError:
        return 0


def _bench_resident_analysis(config, obs, seed, tile_rows, extra=None):
    """Shared driver for the RESIDENT full-size analysis benches: the
    ensemble is generated ON DEVICE in the f32-mean + bf16-deviation
    layout, the (K, nobs) synthetic ensemble H(x) is generated on device,
    and the tiled analysis slices/writes the resident buffers in place —
    no state ever crosses the host↔device link (da/resident.py)."""
    import jax
    import jax.numpy as jnp
    from scale_letkf_tpu.da.letkf_obs import build_obs_context
    from scale_letkf_tpu.da.resident import analyze_resident

    cfg, grid, dycfg, dom = config
    K = cfg.ensemble.member
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    cache0 = _cache_entries()

    t0 = time.time()
    ens = _synthetic_resident_gues(seed, K, grid)
    jax.block_until_ready(ens.dev)
    gen_s = time.time() - t0

    # synthetic ensemble H(x) on device: dat + spread-consistent noise
    t0 = time.time()
    nobs = obs.nobs
    dat_d = jnp.asarray(np.asarray(obs.dat, np.float32))
    err_d = jnp.asarray(np.asarray(obs.err, np.float32))

    @jax.jit
    def gen_ensval(key):
        return dat_d[None] + err_d[None] * jax.random.normal(
            key, (K, nobs), jnp.float32)

    ensval = gen_ensval(jax.random.PRNGKey(seed + 1))
    ctx = build_obs_context(obs, ensval, np.zeros(nobs, np.int32), cfg,
                            grid)
    prep_s = time.time() - t0

    z_full = np.asarray(grid.calc_z(np.zeros((ny, nx))))
    t0 = time.time()
    stats = analyze_resident(ens, ctx, cfg, grid, z_full,
                             tile_rows=tile_rows)
    wall_s = time.time() - t0
    assert bool(jnp.isfinite(ens.mean).all())
    npts = nz * ny * nx
    out = {
        "grid": f"{nx}x{ny}x{nz}", "members": K, "executor": "resident",
        "nobs": int(nobs), "nobs_good": int((ctx.qc == 0).sum()),
        "analysis_s": round(wall_s, 1),
        "gridpoints_per_s": round(npts / max(stats["compute_s"], 1e-9), 1),
        "compute_s": round(stats["compute_s"], 2),
        "transfer_s": 0.0,
        "compile_s": round(stats["compile_s"], 2),
        "tiles": stats["tiles"],
        "nobs_local_mean": round(stats["nobs_mean"], 1),
        "peak_hbm_gb": _device_mem_gb(),
        "state_gen_s": round(gen_s, 1), "obs_prep_s": round(prep_s, 1),
        "new_compile_cache_entries": _cache_entries() - cache0,
    }
    if extra:
        out.update(extra)
    return out


def bench_radar_analysis_resident(config="configs/bda_1km_radar.toml",
                                  n_obs_target=1_000_000, seed=0,
                                  tile_rows=48):
    """Full-size dense-radar analysis, device-resident executor."""
    loaded = _load_cfg(config)
    cfg, grid, dycfg, dom = loaded
    rng = np.random.default_rng(seed)
    obs = _synthetic_radar_volume(cfg, dom, rng, n_obs_target)
    return _bench_resident_analysis(loaded, obs, seed, tile_rows,
                                    extra={"config": config})


def bench_18km_analysis_resident(config="configs/18km_japan.toml", seed=0,
                                 tile_rows=8):
    """Full-size 18-km analysis, device-resident executor: the 13.7 GB
    f32 K=50 state lives in HBM as 7.0 GB of f32 mean + bf16 deviations."""
    loaded = _load_cfg(config)
    cfg, grid, dycfg, dom = loaded
    # one level per scan iteration: the auto level-chunker would batch 2+
    # levels at small row tiles, doubling the per-iteration obs-gather
    # buffers next to the 6.9 GB resident state
    cfg.letkf.level_batch = 1
    rng = np.random.default_rng(seed)
    obs = _synthetic_conv_network(cfg, grid, rng)
    return _bench_resident_analysis(loaded, obs, seed, tile_rows,
                                    extra={"config": config})


def _obs_from_truth(sc, truth_1, obs, nsteps, rng, radar=False, cfg=None):
    """Overwrite obs.dat with H(truth at analysis time) + noise using the
    streamed executor (truth_1: 1-member DycoreState host arrays). Radar
    REF values are converted back to the linear-Z file convention and
    below-floor gates become weak echoes (the preprocessing relabels them
    ref-zero, as with real radar files). Obs whose operator QC failed are
    dropped."""
    from scale_letkf_tpu.da.bigcycle import StreamedCycle
    # separate executor: the 1-member truth stream must not seed the
    # K-member cycle's persisted tsfc (slab skin state) with a (1,ny,nx)
    # array
    sc = StreamedCycle(sc.d, member_batch=1, tile_rows=sc.tile_rows,
                       verbose=sc.verbose)
    _, y, qc, _ = sc.forecast_and_hx(truth_1, nsteps, obs)
    return _fill_obs(obs, y[0], qc, rng, radar, cfg)


def _fill_obs(obs, y, qc, rng, radar=False, cfg=None):
    """Obs that passed the operator's QC, valued H(truth) y + noise (y, qc:
    the truth's (nobs,) H(x) and QC). With radar=True weak echoes are kept
    and REF is written in the linear-Z file convention."""
    from scale_letkf_tpu.obs.types import (
        QC_GOOD, QC_REF_LOW, ID_RADAR_REF)
    keep = (qc == QC_GOOD) | (radar & (qc == QC_REF_LOW))
    obs = obs.select(keep)
    yk = y[keep] + rng.standard_normal(int(keep.sum())) * obs.err
    if radar:
        m = obs.elem == ID_RADAR_REF
        yk[m] = 10.0 ** (yk[m] / 10.0)          # dBZ -> linear Z file units
        low = m & (qc[keep] == QC_REF_LOW)
        yk[low] = 0.5 * cfg.radar.min_radar_ref  # weak echo -> ref-zero
    obs.dat = yk
    return obs


def _resident_driver(cfg, grid, dycfg, dom):
    """Production-composition driver for the resident executor, its
    reference columns taken from the host base profiles."""
    from scale_letkf_tpu.constants import RD, CPDRY, CVDRY, PRE00
    theta, rho1d, _, _ = _host_profiles(grid, dom)
    p_ref = PRE00 * (rho1d * theta * RD / PRE00) ** (CPDRY / CVDRY)
    col = (grid.nz, 1, 1)
    return _make_fullsize_driver(cfg, grid, dycfg, dom, rho1d.reshape(col),
                                 p_ref.astype(np.float32).reshape(col),
                                 production=True)


def _resident_truth_obs(driver, truth, obs, nsteps, rng, radar=False):
    """_fill_obs from a 1-member resident truth (ResidentEnsemble)
    forecast nsteps through its own 1-member executor."""
    from scale_letkf_tpu.da.resident import ResidentCycle
    rc_t = ResidentCycle(driver, member_batch=1, verbose=True)
    y_t, qc_t, _ = rc_t.forecast_and_hx(truth, nsteps, obs)
    return _fill_obs(obs, np.asarray(y_t)[0], qc_t, rng, radar, driver.cfg)


def bench_18km_cycle(config="configs/18km_japan.toml", nsteps=10, seed=0,
                     member_batch=2, tile_rows=20, overrides=None,
                     n_sonde=700, n_ps=2000, members=None,
                     production=True, slots=False, pipeline=True):
    """ONE complete 18-km DA cycle at reference size — ensemble forecast +
    full-size obsope + LETKF — via the member-streamed executor
    (da/bigcycle.py). production=True runs the reference's flagship model
    composition (SI + terrain + physics suite + Davies boundary).
    slots=True additionally spreads obs over the configured LTIMESLOT
    window (slot-matched H(x) extends the integration past the analysis
    time, so nsteps should then be >= the window span). The forecast runs
    `nsteps` of the 720-step 6-h window (LCYCLE=21600 s at dt=30 s,
    config/2015summer_18km); the measured steady-state per-member-step
    cost extrapolates to the full window and is reported alongside."""
    from scale_letkf_tpu.da.bigcycle import StreamedCycle, phase_table

    cfg, grid, dycfg, dom = _load_cfg(config, overrides)
    if members:
        cfg.ensemble.member = members
    K = cfg.ensemble.member
    if not slots:
        # 3-D window for the budgeted bench: the full 4-D window extends
        # the integration to slot_end (coarsened 4-D equality is covered
        # by tests/test_bigcycle.py::test_streamed_4d_slots_matches_incore)
        cfg.obsope.slot_end = cfg.obsope.slot_start
    rng = np.random.default_rng(seed)

    t0 = time.time()
    ens, rho_ref, p_ref = _synthetic_ens_dycore(rng, K + 1, grid, dom)
    gen_s = time.time() - t0
    driver = _make_fullsize_driver(cfg, grid, dycfg, dom, rho_ref, p_ref,
                                   production=production)
    sc = StreamedCycle(driver, member_batch=member_batch,
                       tile_rows=tile_rows, pipeline=pipeline,
                       verbose=True)

    import jax
    truth = jax.tree.map(lambda a: a[:1], ens)
    ens = jax.tree.map(lambda a: np.ascontiguousarray(a[1:]), ens)
    obs = _synthetic_conv_network(cfg, grid, rng, n_sonde=n_sonde,
                                  n_ps=n_ps)
    if slots:
        # spread reports over the window's time slots
        o = cfg.obsope
        slot_times = (np.arange(o.slot_start, o.slot_end + 1)
                      - o.slot_base) * o.slot_tinterval
        obs.dif = rng.choice(slot_times, obs.nobs)
    obs = _obs_from_truth(sc, truth, obs, nsteps, rng)

    ens_a, infl, report = sc.cycle(ens, obs, nsteps)
    print(phase_table(report))
    window_steps = int(round(21600.0 / dycfg.dt))
    per_mem_step = report["fcst_s"] / (K * nsteps)
    sg = report.pop("stats_gues")
    sa = report.pop("stats_anal", None)
    out = {
        "config": config, "grid": f"{grid.nx}x{grid.ny}x{grid.nz}",
        "members": K, "nobs": int(obs.nobs),
        "nobs_good": int(sum(sg.nobs.values())),
        "composition": ("si+stretch+terrain+physics_suite+davies_bdy"
                        if production else "si+stretch"),
        "window_4d_slots": (f"{cfg.obsope.slot_start}..{cfg.obsope.slot_end}"
                            if slots else "single"),
        "steps_run": nsteps, "window_steps": window_steps,
        "s_per_member_step": round(per_mem_step, 4),
        "fcst_full_window_extrapolated_s": round(
            per_mem_step * K * window_steps, 1),
        "state_gen_s": round(gen_s, 1),
        "peak_hbm_gb": _device_mem_gb(),
        **{k: round(v, 2) for k, v in report.items()
           if isinstance(v, (int, float))},
    }
    if sa is not None and sg.nobs.get("T"):
        out["omb_rmse_T"] = round(sg.rmse["T"], 4)
        out["oma_rmse_T"] = round(sa.rmse["T"], 4)
    return out


def bench_radar_cycle(config="configs/bda_1km_radar.toml", seed=0,
                      member_batch=10, tile_rows=48,
                      n_obs_target=1_000_000, overrides=None, members=None,
                      production=True):
    """ONE complete dense-radar DA cycle at reference size: the FULL 30-s
    window (15 steps at dt=2 s — the reference's LCYCLE=30 s BDA regime,
    config/BDA_d3_100m_256p_bf40) + 888k-obs obsope for all members +
    1-km-localization LETKF, via the member-streamed executor.
    production=True runs the full model composition (SI + terrain +
    physics suite + Davies boundary)."""
    from scale_letkf_tpu.da.bigcycle import StreamedCycle, phase_table

    cfg, grid, dycfg, dom = _load_cfg(config, overrides)
    if members:
        cfg.ensemble.member = members
    K = cfg.ensemble.member
    rng = np.random.default_rng(seed)
    nsteps = int(round(30.0 / dycfg.dt))

    t0 = time.time()
    ens, rho_ref, p_ref = _synthetic_ens_dycore(rng, K + 1, grid, dom,
                                                qr_blob=2.0e-3)
    gen_s = time.time() - t0
    driver = _make_fullsize_driver(cfg, grid, dycfg, dom, rho_ref, p_ref,
                                   production=production)
    sc = StreamedCycle(driver, member_batch=member_batch,
                       tile_rows=tile_rows, verbose=True)

    import jax
    truth = jax.tree.map(lambda a: a[:1], ens)
    ens = jax.tree.map(lambda a: np.ascontiguousarray(a[1:]), ens)
    obs = _synthetic_radar_volume(cfg, dom, rng, n_obs_target)
    obs = _obs_from_truth(sc, truth, obs, nsteps, rng, radar=True, cfg=cfg)

    ens_a, infl, report = sc.cycle(ens, obs, nsteps)
    print(phase_table(report))
    sg = report.pop("stats_gues")
    sa = report.pop("stats_anal", None)
    out = {
        "config": config, "grid": f"{grid.nx}x{grid.ny}x{grid.nz}",
        "members": K, "nobs": int(obs.nobs),
        "nobs_good": int(sum(sg.nobs.values())),
        "composition": ("si+stretch+terrain+physics_suite+davies_bdy"
                        if production else "si+stretch+kessler"),
        "steps_run": nsteps, "window_steps": nsteps,
        "s_per_member_step": round(report["fcst_s"] / (K * nsteps), 4),
        "state_gen_s": round(gen_s, 1),
        "peak_hbm_gb": _device_mem_gb(),
        **{k: round(v, 2) for k, v in report.items()
           if isinstance(v, (int, float))},
    }
    if sa is not None and sg.nobs.get("REF"):
        out["omb_rmse_REF"] = round(sg.rmse["REF"], 3)
        out["oma_rmse_REF"] = round(sa.rmse["REF"], 3)
    return out


def bench_18km_cycle_resident(config="configs/18km_japan.toml",
                              nsteps=720, slots=True, seed=0,
                              member_batch=2, tile_rows=8, members=None,
                              n_sonde=700, n_ps=2000, overrides=None):
    """The COMPLETE 18-km cycle with the FULL 6-h window integrated —
    all 720 steps (LCYCLE=21600 s at dt=30 s,
    config/2015summer_18km/config.nml.scale PARAM_TIME) per member batch,
    production composition, device-resident executor (zero transfer), and
    with slots=True the full LTIMESLOT 4-D window (slot-matched H(x)
    extends the integration to nsteps + 3 h = 1080 steps). Timers are
    per-batch blocking (honest device attribution; fcst_s extrapolates
    only the compiled first batch, labeled in the report).

    Also reports a coarse SI-step roofline: a LOWER-BOUND byte/FLOP model
    of one split-explicit step vs the measured per-step time."""
    import jax
    import jax.numpy as jnp
    from scale_letkf_tpu.da.resident import ResidentCycle, ResidentEnsemble
    from scale_letkf_tpu.da.monitor import monit_dep

    cfg, grid, dycfg, dom = _load_cfg(config, overrides)
    if members:
        cfg.ensemble.member = members
    K = cfg.ensemble.member
    cfg.letkf.level_batch = 1
    if not slots:
        cfg.obsope.slot_end = cfg.obsope.slot_start
    rng = np.random.default_rng(seed)
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    driver = _resident_driver(cfg, grid, dycfg, dom)

    # obs with slot-spread time offsets; dat filled from a 1-member truth
    obs = _synthetic_conv_network(cfg, grid, rng, n_sonde=n_sonde,
                                  n_ps=n_ps)
    if slots:
        o = cfg.obsope
        slot_times = (np.arange(o.slot_start, o.slot_end + 1)
                      - o.slot_base) * o.slot_tinterval
        obs.dif = rng.choice(slot_times, obs.nobs)

    t0 = time.time()
    truth = _synthetic_resident_gues(seed + 101, 1, grid)   # independent
    obs = _resident_truth_obs(driver, truth, obs, nsteps, rng)
    truth_s = time.time() - t0
    del truth

    t0 = time.time()
    ens = _synthetic_resident_gues(seed, K, grid)
    jax.block_until_ready(ens.dev)
    gen_s = time.time() - t0

    rc = ResidentCycle(driver, member_batch=member_batch,
                       tile_rows=tile_rows, verbose=True)
    report = rc.cycle(ens, obs, nsteps)

    # window span actually integrated per member (slots extend past the
    # analysis time)
    o = cfg.obsope
    spb = int(round(o.slot_tinterval / dycfg.dt)) if slots else 0
    span = nsteps + max(0, (o.slot_end - o.slot_base) * spb) if slots \
        else nsteps
    per_mem_step = report["fcst_s"] / (K * span)

    # --- coarse SI-step roofline (LOWER BOUND byte/FLOP model):
    # state 11 fields f32; per rk3_step_si: 3 stages x (slow tendencies:
    # read state + write tendency = 2S) + (ns1+ns2+ns3) acoustic substeps
    # x (5 deviation fields read+write ~ 10/11 S) + per-physics-step
    # microphysics/PBL (~2S every phys_interval steps, amortized)
    S = 11 * nz * ny * nx * 4
    n_small = dom.get("n_small", 10)
    ns_total = max(1, n_small // 3) + max(1, n_small // 2) + n_small
    bytes_per_step = 3 * 2 * S + ns_total * (10 / 11) * S + 2 * S / 5
    # FLOPs: ~150 flops/point/stage slow + ~60/point/substep acoustic
    pts = nz * ny * nx
    flops_per_step = 3 * 150 * pts + ns_total * 60 * pts
    step_t = per_mem_step
    roofline = {
        "si_step_bytes_model_gb": round(bytes_per_step / 1e9, 3),
        "si_step_achieved_gbps": round(bytes_per_step / step_t / 1e9, 1),
        "si_step_achieved_gflops": round(flops_per_step / step_t / 1e9, 1),
        "note": "lower-bound traffic model: achieved_gbps over the "
                "device's memory bandwidth is a utilization floor for "
                "the fused step",
    }

    sg = report.pop("stats_gues")
    sa = report.pop("stats_anal", None)
    out = {
        "config": config, "grid": f"{nx}x{ny}x{nz}", "members": K,
        "executor": "resident",
        "composition": "si+stretch+terrain+physics_suite+davies_bdy",
        "window_4d_slots": (f"{o.slot_start}..{o.slot_end}" if slots
                            else "single"),
        "nobs": int(obs.nobs), "nobs_good": int(sum(sg.nobs.values())),
        "steps_run": nsteps, "window_steps": 720,
        "window_span_steps_with_slots": span,
        "s_per_member_step": round(per_mem_step, 4),
        "truth_prep_s": round(truth_s, 1),
        "state_gen_s": round(gen_s, 1),
        "roofline": roofline,
        **{k: round(v, 2) for k, v in report.items()
           if isinstance(v, (int, float))},
    }
    if sa is not None and sg.nobs.get("T"):
        out["omb_rmse_T"] = round(sg.rmse["T"], 4)
        out["oma_rmse_T"] = round(sa.rmse["T"], 4)
    if slots and rc.last_ctx is not None:
        # time-consistent impact metric: obs in the analysis-time slot
        # (the 3-D O-A monitor mixes time displacement into off-center
        # slots — reference monit semantics)
        from scale_letkf_tpu.da.obsope import assign_slots
        ctx = rc.last_ctx
        sl = assign_slots(np.asarray(obs.dif), cfg)[:ctx.nobs]
        center = sl == cfg.obsope.slot_base
        sgc = monit_dep(ctx.elem[center], np.asarray(ctx.dep)[center],
                        ctx.qc[center])
        sac = monit_dep(ctx.elem[center], rc.last_oma[center],
                        ctx.qc[center])
        if sgc.nobs.get("T"):
            out["omb_rmse_T_centerslot"] = round(sgc.rmse["T"], 4)
            out["oma_rmse_T_centerslot"] = round(sac.rmse["T"], 4)
    return out


def radar_cycle_resident(config="configs/bda_1km_radar.toml", seed=0,
                         member_batch=10, tile_rows=48,
                         n_obs_target=1_000_000, overrides=None,
                         members=None):
    """ONE complete dense-radar DA cycle at reference size through the
    device-resident executor (ResidentCycle.cycle): the bda_1km_radar.toml
    domain with no overrides (192x192x48, K=50), the FULL 30-s window
    (15 steps at dt=2 s — the reference's LCYCLE=30 s BDA regime,
    config/BDA_d3_100m_256p_bf40), the production composition (SI +
    stretched z + terrain + physics suite + Davies boundary) and a
    synthetic phased-array volume at 1-km localization.

    The obs are H(truth) + noise from an independent 1-member truth draw
    (as bench_18km_cycle_resident). overrides/members coarsen the
    configuration for CPU tests. Returns (report, ens): the cycle's report
    dict (phase timers, O-B/O-A stats) and the analysis ResidentEnsemble."""
    import jax
    from scale_letkf_tpu.da.resident import ResidentCycle

    cfg, grid, dycfg, dom = _load_cfg(config, overrides)
    if members:
        cfg.ensemble.member = members
    K = cfg.ensemble.member
    nsteps = int(round(30.0 / dycfg.dt))
    rng = np.random.default_rng(seed)
    driver = _resident_driver(cfg, grid, dycfg, dom)

    t0 = time.time()
    obs = _synthetic_radar_volume(cfg, dom, rng, n_obs_target)
    truth = _synthetic_resident_gues(seed + 101, 1, grid, qr_blob=2.0e-3)
    obs = _resident_truth_obs(driver, truth, obs, nsteps, rng, radar=True)
    truth_s = time.time() - t0
    del truth

    t0 = time.time()
    ens = _synthetic_resident_gues(seed, K, grid, qr_blob=2.0e-3)
    jax.block_until_ready(ens.dev)
    gen_s = time.time() - t0

    rc = ResidentCycle(driver, member_batch=member_batch,
                       tile_rows=tile_rows, verbose=True)
    report = rc.cycle(ens, obs, nsteps)
    report.update(truth_prep_s=truth_s, state_gen_s=gen_s,
                  nobs=int(obs.nobs), steps=nsteps,
                  grid=f"{grid.nx}x{grid.ny}x{grid.nz}", members=K)
    return report, ens


def bench_osse_impact(config="configs/18km_japan.toml", members=50,
                      n_cycles=4, steps_per_cycle=60, spinup_steps=60,
                      seed=0, member_batch=2, tile_rows=12,
                      n_sonde=400, n_ps=800, overrides=None,
                      infl_mul=None, relax_alpha=None,
                      obs_err_scale=1.0):
    """Multi-cycle large-shape OSSE with a no-DA control (the de-facto
    verification layer of the reference, common_mpi_scale.f90:1481-1633):
    a spun-up ensemble cycles forecast+analysis against obs drawn from an
    independently-drawn truth, while an identical control ensemble only
    forecasts. Reports the error-vs-cycle curve (domain T RMSE of the
    ensemble mean vs truth, gues/anal/control) + spread — the
    assimilation-impact evidence a single-cycle O-B/O-A cannot give.

    Defaults target a 240x180x36 coarsened-18-km shape (pass overrides);
    everything runs on the device-resident executor with the production
    composition."""
    import jax
    import jax.numpy as jnp
    from scale_letkf_tpu.da.resident import ResidentCycle
    from scale_letkf_tpu.da.bigcycle import _log
    from scale_letkf_tpu.state import IA_T

    if overrides is None:
        overrides = {"nx": 240, "ny": 180, "nz": 36,
                     "dx": 36000.0, "dy": 36000.0}
    cfg, grid, dycfg, dom = _load_cfg(config, overrides)
    cfg.ensemble.member = members
    cfg.letkf.level_batch = 1
    cfg.obsope.slot_end = cfg.obsope.slot_start      # 3-D cycles
    if infl_mul is not None:
        cfg.letkf.infl_mul = infl_mul
    if relax_alpha is not None:
        cfg.letkf.relax_alpha = relax_alpha
    K = members
    rng = np.random.default_rng(seed)
    nz, ny, nx = grid.nz, grid.ny, grid.nx

    theta, rho1d, p1d, qv = _host_profiles(grid, dom)
    from scale_letkf_tpu.constants import RD, CPDRY, CVDRY, PRE00
    rho_ref = rho1d.reshape(nz, 1, 1)
    p_ref = (PRE00 * (rho1d * theta * RD / PRE00) ** (CPDRY / CVDRY)
             ).astype(np.float32).reshape(nz, 1, 1)
    driver = _make_fullsize_driver(cfg, grid, dycfg, dom, rho_ref, p_ref,
                                   production=True)

    obs = _synthetic_conv_network(cfg, grid, rng, n_sonde=n_sonde,
                                  n_ps=n_ps)
    obs.err = obs.err * obs_err_scale

    strides = (1, 2, 4, 8)
    ens = _synthetic_resident_gues(seed, K, grid, smooth_strides=strides)
    ctrl = _synthetic_resident_gues(seed, K, grid,
                                    smooth_strides=strides)
    # truth: INDEPENDENT draw (the OSSE truth-draw rule) + UNMODELED
    # FORCING: the truth's physics runs a stronger solar constant
    # (mu0 0.5 -> 0.8), a persistent balanced large-scale warming the DA
    # system must keep learning from the obs while the free-running
    # control drifts away. (A plain perfect-model twin shows no impact
    # here: the idealized large-scale state has no chaotic error growth,
    # so control error never grows. An earlier rhot-scaled warm boundary
    # target was hydrostatically imbalanced and wrecked the truth run.)
    truth = _synthetic_resident_gues(seed + 101, 1, grid, t_offset=1.0,
                                     smooth_strides=strides)
    dom_t = dict(dom)
    dom_t["physics"] = dict(dom.get("physics", {}), mu0=0.65)
    driver_t = _make_fullsize_driver(cfg, grid, dycfg, dom_t, rho_ref,
                                     p_ref, production=True)
    rc = ResidentCycle(driver, member_batch=member_batch,
                       tile_rows=tile_rows, verbose=True)
    rc_c = ResidentCycle(driver, member_batch=member_batch,
                         tile_rows=tile_rows)
    rc_t = ResidentCycle(driver_t, member_batch=1, tile_rows=tile_rows)

    # score over the OBSERVED layer (below ~11 km — the sonde network
    # tops out at 200 hPa): the unmodeled solar forcing also heats the
    # unconstrained low-density stratosphere by tens of K, which no DA
    # system could correct and which would swamp the tropospheric signal
    zmask = jnp.asarray((np.asarray(grid.cz) < 11000.0).astype(np.float32)
                        )[:, None, None]
    zw = zmask / jnp.sum(zmask) / (ny * nx)

    @jax.jit
    def t_rmse(mean_a, ref_t, dev_t):
        tr = ref_t[IA_T] + dev_t[0, IA_T].astype(jnp.float32)
        return jnp.sqrt(jnp.sum(zw * (mean_a[IA_T] - tr) ** 2))

    @jax.jit
    def t_spread(dev, K_):
        d = dev[:, IA_T].astype(jnp.float32)
        d = d - jnp.mean(d, axis=0, keepdims=True)
        return jnp.sqrt(jnp.mean(jnp.sum(d * d, axis=0) / (K_ - 1)))

    curve = {"rmse_gues": [], "rmse_anal": [], "rmse_ctrl": [],
             "spread_gues": []}

    t_total = time.time()
    # spin-up (all three systems; H(x) rides along unused)
    if spinup_steps > 0:
        rc.forecast_and_hx(ens, spinup_steps, obs)
        rc_c.forecast_and_hx(ctrl, spinup_steps, obs)
        rc_t.forecast_and_hx(truth, spinup_steps, obs)
    for c in range(n_cycles):
        y_t, qc_t, _ = rc_t.forecast_and_hx(truth, steps_per_cycle, obs)
        y_t = np.asarray(y_t)[0]
        good = qc_t == 0
        # obs positions fixed; values refreshed in place (stable jit keys)
        obs.dat[:] = np.where(
            good, y_t + rng.standard_normal(obs.nobs) * obs.err, obs.dat)

        ensval, qc_w, _ = rc.forecast_and_hx(ens, steps_per_cycle, obs)
        curve["rmse_gues"].append(float(t_rmse(ens.mean, truth.ref,
                                               truth.dev)))
        curve["spread_gues"].append(float(t_spread(ens.dev, K)))
        rc.analysis(ens, obs, ensval, np.where(good, qc_w, 99))
        curve["rmse_anal"].append(float(t_rmse(ens.mean, truth.ref,
                                               truth.dev)))

        rc_c.forecast_and_hx(ctrl, steps_per_cycle, obs)
        curve["rmse_ctrl"].append(float(t_rmse(ctrl.mean, truth.ref,
                                               truth.dev)))
        _log(f"osse cycle {c}: gues={curve['rmse_gues'][-1]:.4f} "
             f"anal={curve['rmse_anal'][-1]:.4f} "
             f"ctrl={curve['rmse_ctrl'][-1]:.4f} "
             f"sprd={curve['spread_gues'][-1]:.4f}")

    return {
        "config": config, "grid": f"{nx}x{ny}x{nz}", "members": K,
        "executor": "resident",
        "composition": "si+stretch+terrain+physics_suite+davies_bdy",
        "n_cycles": n_cycles, "steps_per_cycle": steps_per_cycle,
        "spinup_steps": spinup_steps,
        "nobs": int(obs.nobs), "nobs_good": int(good.sum()),
        "infl_mul": cfg.letkf.infl_mul,
        "relax_alpha": cfg.letkf.relax_alpha,
        "total_s": round(time.time() - t_total, 1),
        **{k: [round(v, 4) for v in vs] for k, vs in curve.items()},
    }


if __name__ == "__main__":
    import sys
    import json
    from scale_letkf_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    which = sys.argv[1] if len(sys.argv) > 1 else "radar"
    fn = {"radar": bench_radar_analysis,
          "18km": bench_18km_analysis,
          "radar_resident": bench_radar_analysis_resident,
          "18km_resident": bench_18km_analysis_resident,
          "radar_cycle": bench_radar_cycle,
          "18km_cycle": bench_18km_cycle,
          "18km_fullwindow": bench_18km_cycle_resident,
          "osse_impact": bench_osse_impact}[which]
    print(json.dumps(fn()))
