"""Command-line programs: the reference's executable layer.

Equivalent of the reference L6 executables + L7 workflow driver
(reference: scale/letkf/letkf.f90, scale/obs/{obsope,obsmake,obssim}.f90,
scale/ensmodel/scale-rm_ens.f90, scale/run/cycle.sh, scale/run/fcst.sh):

  python -m scale_letkf_tpu letkf   --config c.toml --gues DIR --obs F --anal DIR
  python -m scale_letkf_tpu obsope  --config c.toml --gues DIR --obs F --out F
  python -m scale_letkf_tpu obsmake --config c.toml --nature F --obs-template F --out F
  python -m scale_letkf_tpu obssim  --config c.toml --state F --vars REF,VR --out F
  python -m scale_letkf_tpu fcst    --config c.toml --init DIR --steps N --out DIR
  python -m scale_letkf_tpu cycle   --config c.toml --init DIR --cycles N ...

States are checkpoint directories (io/checkpoint.py); obs are the reference
binary formats (obs/io.py). The experiment geometry lives in the [domain]
section of the TOML config (an addition over the reference namelists, which
get geometry from SCALE restart metadata).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tomllib

import numpy as np


def load_config_and_grid(path: str, domain_overrides: dict | None = None):
    """domain_overrides: optional [domain] key overrides (e.g. coarsened
    grid sizes for tests of the full-size experiment configs)."""
    from scale_letkf_tpu.config import Config
    from scale_letkf_tpu.grid import Grid, Projection
    from scale_letkf_tpu.model.dycore import DycoreConfig

    with open(path, "rb") as f:
        raw = tomllib.load(f)
    dom = raw.pop("domain", {})
    nest = raw.pop("nest", None)   # one-way nested child domain (nested.py)
    if domain_overrides:
        dom.update(domain_overrides)
    if nest is not None:
        dom["nest"] = nest
    phys = raw.pop("physics", None)
    if phys is not None:
        dom["physics"] = phys
    cfg = Config.from_dict(raw)
    proj = Projection(**dom.get("projection", {}))
    stretch = dom.get("dz_stretch", 1.0)
    if stretch != 1.0:
        # geometrically stretched FZ levels (every reference domain
        # stretches the vertical; PARAM_GRID FZ)
        grid = Grid.stretched(
            nx=dom.get("nx", 40), ny=dom.get("ny", 40), nz=dom.get("nz", 30),
            dx=dom.get("dx", 2000.0), dy=dom.get("dy", 2000.0),
            dz0=dom.get("dz", 500.0), stretch=stretch, proj=proj)
    else:
        grid = Grid.uniform(
            nx=dom.get("nx", 40), ny=dom.get("ny", 40), nz=dom.get("nz", 30),
            dx=dom.get("dx", 2000.0), dy=dom.get("dy", 2000.0),
            dz=dom.get("dz", 500.0), proj=proj)
    dycfg = DycoreConfig(
        dx=grid.dx, dy=grid.dy, dz=float(grid.fz[1] - grid.fz[0]),
        dt=dom.get("dt", 1.0), ztop=grid.ztop,
        sponge_height=dom.get("sponge_height", 0.0),
        sponge_tau=dom.get("sponge_tau", 120.0),
        divdmp=dom.get("divdmp", 0.05), kdiff4=dom.get("kdiff4", 1.0e-3))
    return cfg, grid, dycfg, dom


def make_driver(cfg, grid, dycfg, dom):
    from scale_letkf_tpu.cycle import CycleDriver
    from scale_letkf_tpu.model.ideal import balanced_state
    qv0 = dom.get("qv_surface", 0.0)
    qv_prof = (qv0 * np.exp(-grid.cz / dom.get("qv_scale_height", 3000.0))
               if qv0 > 0 else None)
    _, rho_ref, p_ref = balanced_state(grid.nz, grid.ny, grid.nx,
                                       float(grid.fz[1] - grid.fz[0]),
                                       qv_prof=qv_prof, cz=grid.cz)
    topo = None
    if dom.get("topo_file"):
        topo = np.load(dom["topo_file"])["topo"]
    bdy = None
    if dom.get("bdy_file"):
        from scale_letkf_tpu.model.boundary import load_boundary
        bdy = load_boundary(dom["bdy_file"])
    phys_cfg = None
    if "physics" in dom:
        from scale_letkf_tpu.model.physics_suite import PhysicsConfig
        import dataclasses
        valid = {f.name for f in dataclasses.fields(PhysicsConfig)}
        unknown = set(dom["physics"]) - valid
        if unknown:
            raise ValueError(
                f"unknown [physics] keys: {sorted(unknown)} "
                f"(valid: {sorted(valid)})")
        phys_cfg = PhysicsConfig(**dom["physics"])
    mesh = None
    pc = cfg.process
    if pc.mesh_member * pc.mesh_y * pc.mesh_x > 1:
        from scale_letkf_tpu.parallel.mesh import make_mesh
        mesh = make_mesh(pc.mesh_member, pc.mesh_y, pc.mesh_x)
    return CycleDriver(grid, cfg, dycfg, rho_ref, p_ref,
                       use_physics=dom.get("use_physics", False),
                       topo=topo, phys_cfg=phys_cfg, mesh=mesh,
                       core=dom.get("core", "explicit"),
                       n_small=dom.get("n_small", 6),
                       bdy=bdy, bdy_width=dom.get("bdy_width", 0),
                       bdy_tau=dom.get("bdy_tau", 300.0))


def make_nested(cfg, grid, dycfg, dom):
    """[nest] section → (child driver, NestedCycleDriver, steps ratio).
    The child inherits the parent's DA config; its domain is the [nest]
    geometry (reference: NUM_DOMAIN telescoping nests, common_nml.f90:56)."""
    from scale_letkf_tpu.grid import Grid, Projection
    from scale_letkf_tpu.model.dycore import DycoreConfig
    from scale_letkf_tpu.model.nesting import NestGeometry
    from scale_letkf_tpu.nested import NestedCycleDriver

    n = dom["nest"]
    ratio = int(n.get("ratio", 3))
    proj = Projection(**dom.get("projection", {}))
    cgrid = Grid.uniform(
        nx=n.get("nx", 24), ny=n.get("ny", 24), nz=n.get("nz", grid.nz),
        dx=grid.dx / ratio, dy=grid.dy / ratio,
        dz=n.get("dz", float(grid.fz[1] - grid.fz[0])), proj=proj)
    cdycfg = DycoreConfig(
        dx=cgrid.dx, dy=cgrid.dy, dz=float(cgrid.fz[1] - cgrid.fz[0]),
        dt=n.get("dt", dycfg.dt / ratio), ztop=cgrid.ztop,
        sponge_height=n.get("sponge_height", dycfg.sponge_height),
        sponge_tau=n.get("sponge_tau", dycfg.sponge_tau),
        lateral=n.get("lateral", "periodic"))
    cdom = {"bdy_width": n.get("bdy_width", 4),
            "bdy_tau": n.get("bdy_tau", 120.0)}
    child = make_driver(cfg, cgrid, cdycfg, cdom)
    geom = NestGeometry(i0=float(n.get("i0", 0.0)),
                        j0=float(n.get("j0", 0.0)), ratio=ratio)
    return child, geom, NestedCycleDriver


def load_addi_ens(cfg, dirpath):
    """Additive-inflation source ensemble in analysis variables (the
    INFL_ADD_IN_BASENAME read, common_mpi_scale.f90:1163-1202); required
    when INFL_ADD > 0."""
    if cfg.letkf.infl_add <= 0:
        return None
    import jax
    import jax.numpy as jnp
    from scale_letkf_tpu.io.checkpoint import load_ensemble
    from scale_letkf_tpu.model.dycore import DycoreState, to_collocated
    from scale_letkf_tpu.state import state_trans
    addi, _, _ = load_ensemble(dirpath, basename=cfg.letkf.infl_add_in_basename)
    addi = DycoreState(*(jnp.asarray(a) for a in addi))
    return state_trans(jax.vmap(to_collocated)(addi))


def slot_steps_from_cfg(cfg, nsteps: int, dt: float) -> list[int] | None:
    """Step counts (from forecast start) of the assimilation-window time
    slots (SLOT_START..SLOT_END with SLOT_BASE at the analysis time,
    common_nml.f90:89-92). None when the window is a single slot."""
    o = cfg.obsope
    if o.slot_end <= o.slot_start:
        return None
    spb = o.slot_tinterval / dt
    if abs(spb - round(spb)) > 1e-6:
        raise ValueError(
            f"slot_tinterval={o.slot_tinterval} must be a multiple of the "
            f"model dt={dt}")
    spb = int(round(spb))
    return [max(0, nsteps + (i - o.slot_base) * spb)
            for i in range(o.slot_start, o.slot_end + 1)]


def read_obs_files(cfg, paths):
    from scale_letkf_tpu.obs import io as obsio
    from scale_letkf_tpu.obs.types import Observations
    parts = []
    fmts = list(cfg.obsope.obs_in_format) + ["PREPBUFR"] * len(paths)
    for p, fmt in zip(paths, fmts):
        if fmt.upper() == "RADAR" or p.endswith(".radar"):
            parts.append(obsio.read_obs_radar(p))
        elif fmt.upper() == "HIMAWARI8" or p.endswith(".h08"):
            parts.append(obsio.read_obs_h08(p, cfg))
        else:
            parts.append(obsio.read_obs(p, cfg))
    return Observations.concatenate(parts)


def cmd_letkf(args):
    import jax
    import jax.numpy as jnp
    from scale_letkf_tpu.io.checkpoint import (
        save_ensemble, load_ensemble, load_det, filename_replace_mem)
    from scale_letkf_tpu.model.dycore import DycoreState, to_collocated
    from scale_letkf_tpu.state import state_trans, ensemble_mean, \
        ensemble_spread
    from scale_letkf_tpu.obs import io as obsio
    cfg, grid, dycfg, dom = load_config_and_grid(args.config)
    driver = make_driver(cfg, grid, dycfg, dom)
    ens, aux, meta = load_ensemble(args.gues)
    ens = DycoreState(*(jnp.asarray(a) for a in ens))
    det = load_det(args.gues)
    if det is not None:
        det = DycoreState(*(jnp.asarray(a) for a in det))
    obs = read_obs_files(cfg, args.obs)
    infl = aux.get("infl")

    precomputed = None
    if args.obsda:
        # OBSDA_IN path: read per-member H(x) files from a separate obsope
        K = ens.rho.shape[0]
        vals, qcs, levs = [], [], []
        for m in range(K):
            rec = obsio.read_obs_da(
                filename_replace_mem(args.obsda, m), obs.nobs)
            vals.append(rec[2])
            qcs.append(rec[3])
            if len(rec) > 4:
                levs.append(rec[4])
        lev = np.stack(levs).mean(axis=0) if levs else None
        precomputed = (np.stack(vals), np.stack(qcs).max(axis=0), lev)

    addi = load_addi_ens(cfg, args.addi or args.gues)
    # 4-D obsope: per-slot history snapshots written by fcst
    from scale_letkf_tpu.io.checkpoint import load_history
    from scale_letkf_tpu.da.obsope import assign_slots
    hist = load_history(args.gues)
    slots = assign_slots(obs.dif, cfg) if hist is not None else None
    ens_a, info = driver.analysis(ens, obs, infl_field=infl, det=det,
                                  precomputed_hx=precomputed, addi_ens=addi,
                                  rng=np.random.default_rng(args.seed),
                                  hist_slots=hist, slots=slots)
    print(info["stats_gues"].format("O-B"))
    print(info["stats_anal"].format("O-A"))
    if cfg.monitor.departure_stat:
        # per-report-type × variable tables (monit_obs_mpi,
        # common_mpi_scale.f90:1481-1633)
        print(info["stats_gues_bytype"].format("O-B"))
        print(info["stats_anal_bytype"].format("O-A"))
    aux_out = {}
    if info["diag"].infl_field is not None:
        aux_out["infl"] = info["diag"].infl_field
    if info["diag"].rtps_field is not None:
        aux_out["rtps"] = info["diag"].rtps_field
    if info["diag"].nobs_field is not None:
        aux_out["nobs"] = info["diag"].nobs_field
    # mean/spread outputs (GUES_SPRD_OUT/ANAL_SPRD_OUT semantics)
    aux_out["anal_mean"] = np.asarray(ensemble_mean(info["anal"]))
    aux_out["anal_sprd"] = np.asarray(ensemble_spread(info["anal"]))
    aux_out["gues_mean"] = np.asarray(ensemble_mean(info["gues"]))
    aux_out["gues_sprd"] = np.asarray(ensemble_spread(info["gues"]))
    save_ensemble(args.anal, ens_a, basename="anal.@@@@", aux=aux_out,
                  det=info["det"], meta={**meta, "step": "letkf"})
    if cfg.monitor.obsdep_out:
        info["obsdep"].save(f"{args.anal}/{cfg.monitor.obsdep_out_basename}.npz")
        info["obsdep"].save_binary(
            f"{args.anal}/{cfg.monitor.obsdep_out_basename}.dat",
            dif=obs.dif)
    print(driver.timer.report())


def cmd_obsope(args):
    import jax
    import jax.numpy as jnp
    from scale_letkf_tpu.io.checkpoint import load_ensemble
    from scale_letkf_tpu.model.dycore import DycoreState, to_collocated
    from scale_letkf_tpu.state import state_trans, state_to_history
    from scale_letkf_tpu.da.obsope import obsope_ensemble
    from scale_letkf_tpu.obs import io as obsio
    cfg, grid, dycfg, dom = load_config_and_grid(args.config)
    driver = make_driver(cfg, grid, dycfg, dom)
    ens, _, _ = load_ensemble(args.gues)
    ens = DycoreState(*(jnp.asarray(a) for a in ens))
    obs = read_obs_files(cfg, args.obs)
    from scale_letkf_tpu.io.checkpoint import load_history
    from scale_letkf_tpu.da.obsope import assign_slots
    hist = load_history(args.gues)
    if hist is not None:
        # 4-D: match each obs against its time-slot history snapshot
        fields = jax.vmap(
            lambda g: state_to_history(g, driver.z_full, driver.topo))(
            jnp.asarray(hist))
        hx = obsope_ensemble(fields, obs, grid, cfg, driver.z_full,
                             slots=assign_slots(obs.dif, cfg))
    else:
        gues = state_trans(jax.vmap(to_collocated)(ens))
        fields = jax.vmap(
            lambda g: state_to_history(g, driver.z_full, driver.topo))(gues)
        hx = obsope_ensemble(fields, obs, grid, cfg, driver.z_full)
    ensval_np = np.asarray(hx.ensval)   # host pull at the file-IO boundary
    K = ensval_np.shape[0]
    from scale_letkf_tpu.obs.types import ID_H08IR
    has_h08 = bool(np.any(obs.elem == ID_H08IR))
    for m in range(K):
        from scale_letkf_tpu.io.checkpoint import filename_replace_mem
        path = filename_replace_mem(args.out, m)
        obsio.write_obs_da(path, np.zeros(obs.nobs, np.int32),
                           np.arange(obs.nobs, dtype=np.int32),
                           ensval_np[m].astype(np.float32),
                           hx.qc.astype(np.int32),
                           lev=hx.lev if has_h08 else None,
                           val2=hx.val2 if has_h08 else None)
    print(f"obsope: {obs.nobs} obs x {K} members -> {args.out}")


def cmd_obsmake(args):
    import jax.numpy as jnp
    from scale_letkf_tpu.io.checkpoint import load_member
    from scale_letkf_tpu.model.dycore import to_collocated, DycoreState
    from scale_letkf_tpu.state import state_trans, state_to_history
    from scale_letkf_tpu.da.obsmake import obsmake
    from scale_letkf_tpu.obs import io as obsio
    cfg, grid, dycfg, dom = load_config_and_grid(args.config)
    driver = make_driver(cfg, grid, dycfg, dom)
    nat = load_member(args.nature)
    nat = DycoreState(*(jnp.asarray(a) for a in nat))
    template = read_obs_files(cfg, [args.obs_template])
    fields = state_to_history(state_trans(to_collocated(nat)),
                              driver.z_full, driver.topo)
    rng = np.random.default_rng(args.seed)
    obs = obsmake(fields, template, grid, cfg, driver.z_full, rng)
    from scale_letkf_tpu.obs.types import ID_H08IR, TYP_PHARAD
    if obs.nobs and (obs.elem == ID_H08IR).all():
        obsio.write_obs_h08(args.out, obs)
    elif obs.nobs and (obs.typ == TYP_PHARAD).all():
        obsio.write_obs_radar(args.out, obs)
    else:
        obsio.write_obs(args.out, obs)
    print(f"obsmake: wrote {obs.nobs} obs -> {args.out}")


def cmd_obssim(args):
    import jax.numpy as jnp
    from scale_letkf_tpu.io.checkpoint import load_member
    from scale_letkf_tpu.model.dycore import to_collocated, DycoreState
    from scale_letkf_tpu.state import state_trans, state_to_history
    from scale_letkf_tpu.da.obssim import obssim, write_grads
    from scale_letkf_tpu.obs.types import OBELM_NAMES, ELEM_UID
    cfg, grid, dycfg, dom = load_config_and_grid(args.config)
    driver = make_driver(cfg, grid, dycfg, dom)
    s = load_member(args.state)
    s = DycoreState(*(jnp.asarray(a) for a in s))
    fields = state_to_history(state_trans(to_collocated(s)),
                              driver.z_full, driver.topo)
    name_to_id = {n.strip().upper(): e for n, e in zip(OBELM_NAMES, ELEM_UID)}
    elems = []
    for v in args.vars.split(","):
        key = v.strip().upper()
        if key not in name_to_id:
            sys.exit(f"error: unknown obssim variable '{v.strip()}' "
                     f"(valid: {', '.join(sorted(name_to_id))})")
        elems.append(name_to_id[key])
    radar = (dom.get("radar_lon"), dom.get("radar_lat"),
             dom.get("radar_z", 0.0))
    radar = None if radar[0] is None else radar
    out = obssim(fields, elems, grid, cfg, radar_lonlatz=radar)
    arrays3d = [np.asarray(out[e]) for e in elems
                if np.asarray(out[e]).ndim == 3]
    arrays2d = [np.asarray(out[e]) for e in elems
                if np.asarray(out[e]).ndim == 2]
    write_grads(args.out, arrays3d, arrays2d)
    print(f"obssim: wrote {len(elems)} vars -> {args.out}")


def cmd_pp(args):
    """Topography preprocessing (scale-rm_pp_ens equivalent): DEM raster →
    smoothed model-grid topo written as npz for the [domain] topo_file key."""
    from scale_letkf_tpu.model.topo import read_dem, prepare_topo
    cfg, grid, dycfg, dom = load_config_and_grid(args.config)
    dem_kw = {}
    if args.dem_geometry:
        nlon, nlat, lon0, dlon, lat0, dlat = \
            [float(v) for v in args.dem_geometry.split(",")]
        dem_kw = dict(nlon=int(nlon), nlat=int(nlat), lon0=lon0, dlon=dlon,
                      lat0=lat0, dlat=dlat)
    elev, dlons, dlats = read_dem(args.dem, **dem_kw)
    topo = prepare_topo(elev, dlons, dlats, grid,
                        max_slope_ratio=args.max_slope_ratio)
    np.savez(args.out, topo=topo)
    print(f"pp: topo {topo.shape} min={topo.min():.1f} max={topo.max():.1f} "
          f"-> {args.out}")


def cmd_fcst(args):
    import jax.numpy as jnp
    from scale_letkf_tpu.io.checkpoint import (
        load_ensemble, save_ensemble, load_det)
    from scale_letkf_tpu.model.dycore import DycoreState
    cfg, grid, dycfg, dom = load_config_and_grid(args.config)
    driver = make_driver(cfg, grid, dycfg, dom)
    ens, aux, meta = load_ensemble(args.init)
    ens = DycoreState(*(jnp.asarray(a) for a in ens))
    det = load_det(args.init)
    slot_steps = slot_steps_from_cfg(cfg, args.steps, dycfg.dt)
    hist = None
    if slot_steps is not None:
        # 4-D window: emit per-slot history snapshots alongside the gues
        # (the reference model's history output consumed by obsope)
        ens, hist = driver.forecast_slots(ens, args.steps, slot_steps)
    else:
        ens = driver.forecast(ens, args.steps)
    if det is not None:
        det = DycoreState(*(jnp.asarray(a) for a in det))
        det = driver.forecast_one(det, args.steps)
    save_ensemble(args.out, ens, basename="gues.@@@@", aux=aux, det=det,
                  meta={**meta, "step": "fcst", "steps": args.steps})
    if hist is not None:
        from scale_letkf_tpu.io.checkpoint import save_history
        save_history(args.out, np.asarray(hist),
                     slot_ids=list(range(cfg.obsope.slot_start,
                                         cfg.obsope.slot_end + 1)))
        print(f"fcst: wrote {hist.shape[1]} history slots")
    print(f"fcst: {args.steps} steps -> {args.out}")
    print(driver.timer.report())


def cmd_cycle(args):
    import jax
    import jax.numpy as jnp
    from scale_letkf_tpu.io.checkpoint import load_ensemble, save_ensemble
    from scale_letkf_tpu.model.dycore import DycoreState
    from scale_letkf_tpu.io.checkpoint import load_det
    cfg, grid, dycfg, dom = load_config_and_grid(args.config)
    driver = make_driver(cfg, grid, dycfg, dom)
    ens, aux, meta = load_ensemble(args.init)
    ens = DycoreState(*(jnp.asarray(a) for a in ens))
    # DET_RUN_CYCLED: a deterministic member present in the initial
    # checkpoint is forecast and analyzed (transmd weights) every cycle
    det = load_det(args.init)
    if det is not None:
        det = DycoreState(*(jnp.asarray(a) for a in det))
    infl = aux.get("infl")
    if "tsfc" in aux:
        # resume the persisted slab skin state (physics-suite runs)
        driver.tsfc = jnp.asarray(aux["tsfc"])
    addi = load_addi_ens(cfg, args.init)
    rng = np.random.default_rng(0)
    from scale_letkf_tpu.da.obsope import assign_slots
    slot_steps = slot_steps_from_cfg(cfg, args.steps_per_cycle, dycfg.dt)

    # one-way nested child domain ([nest] section → nested.py)
    nested = c_ens = c_infl = None
    steps_child = 0
    if "nest" in dom:
        if not (args.nest_init and args.nest_obs_pattern):
            sys.exit("error: config has a [nest] section — pass both "
                     "--nest-init and --nest-obs-pattern (or remove [nest])")
        if det is not None or slot_steps is not None or addi is not None:
            sys.exit("error: nested cycling does not combine with DET_RUN, "
                     "4-D slots, or additive inflation yet")
        child, geom, NestedCycleDriver = make_nested(cfg, grid, dycfg, dom)
        nested = NestedCycleDriver(driver, child, geom)
        # same wall-clock window at the child's finer dt
        steps_child = int(round(args.steps_per_cycle * dycfg.dt
                                / child.dycfg.dt))
        c_ens, c_aux, _ = load_ensemble(args.nest_init)
        c_ens = DycoreState(*(jnp.asarray(a) for a in c_ens))
        c_infl = c_aux.get("infl")

    # beyond-HBM member-streamed executor (da/bigcycle.py): full-size
    # domains where the in-core K-member state does not fit one chip
    if args.streamed:
        if nested is not None or det is not None or addi is not None:
            sys.exit("error: --streamed does not combine with [nest], "
                     "DET_RUN, or additive inflation yet")
        # physics-suite slab state, per-member boundaries, and 4-D slots
        # all thread through the stream (da/bigcycle.py)
        from scale_letkf_tpu.da.bigcycle import StreamedCycle, phase_table
        sc = StreamedCycle(driver, member_batch=args.member_batch,
                           tile_rows=args.tile_rows,
                           pipeline=args.pipeline)
        if "tsfc" in aux:
            sc.tsfc_host = np.asarray(aux["tsfc"], np.float32)
        ens_host = jax.tree.map(np.asarray, ens)
        for c in range(args.cycles):
            obs = read_obs_files(cfg, [args.obs_pattern.format(cycle=c)])
            ens_host, infl, rep = sc.cycle(ens_host, obs,
                                           args.steps_per_cycle,
                                           infl_field=infl)
            print(f"=== cycle {c} ===")
            print(rep["stats_gues"].format("O-B"))
            if "stats_anal" in rep:
                print(rep["stats_anal"].format("O-A"))
            print(phase_table(rep))
        aux_out = {"infl": infl} if infl is not None else {}
        if sc.tsfc_host is not None:
            aux_out["tsfc"] = sc.tsfc_host
        save_ensemble(args.out, ens_host, basename="anal.@@@@",
                      aux=aux_out, meta={"cycles": args.cycles,
                                         "streamed": True})
        return

    for c in range(args.cycles):
        if nested is not None:
            obs = read_obs_files(cfg, [args.obs_pattern.format(cycle=c)])
            c_obs = read_obs_files(
                cfg, [args.nest_obs_pattern.format(cycle=c)])
            ens, c_ens, ninfo = nested.cycle(
                ens, c_ens, obs, c_obs, args.steps_per_cycle, steps_child,
                infl_p=infl, infl_c=c_infl)
            info, c_info = ninfo["parent"], ninfo["child"]
            if info["diag"].infl_field is not None:
                infl = info["diag"].infl_field
            if c_info["diag"].infl_field is not None:
                c_infl = c_info["diag"].infl_field
            print(f"=== cycle {c} ===")
            print(info["stats_gues"].format("O-B"))
            print(info["stats_anal"].format("O-A"))
            print(c_info["stats_gues"].format("nest O-B"))
            print(c_info["stats_anal"].format("nest O-A"))
            continue
        hist = None
        if slot_steps is not None:
            ens, hist = driver.forecast_slots(ens, args.steps_per_cycle,
                                              slot_steps)
        else:
            ens = driver.forecast(ens, args.steps_per_cycle)
        if det is not None:
            det = driver.forecast_one(det, args.steps_per_cycle)
        obs = read_obs_files(cfg, [args.obs_pattern.format(cycle=c)])
        slots = assign_slots(obs.dif, cfg) if hist is not None else None
        ens, info = driver.analysis(ens, obs, infl_field=infl, det=det,
                                    addi_ens=addi, rng=rng,
                                    hist_slots=hist, slots=slots)
        if det is not None:
            det = info["det"]
        if info["diag"].infl_field is not None:
            infl = info["diag"].infl_field
        print(f"=== cycle {c} ===")
        print(info["stats_gues"].format("O-B"))
        print(info["stats_anal"].format("O-A"))
        if cfg.monitor.departure_stat:
            print(info["stats_gues_bytype"].format("O-B"))
            print(info["stats_anal_bytype"].format("O-A"))
    aux_out = {"infl": infl} if infl is not None else {}
    if driver.tsfc is not None:
        aux_out["tsfc"] = np.asarray(driver.tsfc)
    save_ensemble(args.out, ens, basename="anal.@@@@", aux=aux_out, det=det,
                  meta={"cycles": args.cycles})
    if nested is not None:
        c_aux_out = {"infl": c_infl} if c_infl is not None else {}
        save_ensemble(os.path.join(args.out, "nest"), c_ens,
                      basename="anal.@@@@", aux=c_aux_out,
                      meta={"cycles": args.cycles, "nest": True})
    print(driver.timer.report())


def main(argv=None):
    p = argparse.ArgumentParser(prog="scale_letkf_tpu")
    # multi-host runtime (reference: the MPI launcher layer,
    # common_mpi_scale.f90:367-512). Given BEFORE the subcommand:
    #   python -m scale_letkf_tpu --coordinator host:1234 \
    #       --num-processes 4 --process-id $RANK letkf ...
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0; enables jax.distributed "
                        "so the device mesh spans every host")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--local-device-count", type=int, default=None,
                   help="force N virtual host-platform devices per process "
                        "(CPU test rig; omit on accelerator hosts)")
    sub = p.add_subparsers(dest="cmd", required=True)

    q = sub.add_parser("letkf", help="LETKF analysis step")
    q.add_argument("--config", required=True)
    q.add_argument("--gues", required=True)
    q.add_argument("--obs", nargs="+", required=True)
    q.add_argument("--anal", required=True)
    q.add_argument("--obsda", default=None,
                   help="read precomputed H(x) files (basename with @@@@)")
    q.add_argument("--addi", default=None,
                   help="directory with the additive-inflation ensemble "
                        "(INFL_ADD_IN_BASENAME files; default: --gues dir)")
    q.add_argument("--seed", type=int, default=0,
                   help="RNG seed (INFL_ADD_SHUFFLE)")
    q.set_defaults(fn=cmd_letkf)

    q = sub.add_parser("obsope", help="observation operator")
    q.add_argument("--config", required=True)
    q.add_argument("--gues", required=True)
    q.add_argument("--obs", nargs="+", required=True)
    q.add_argument("--out", required=True)
    q.set_defaults(fn=cmd_obsope)

    q = sub.add_parser("obsmake", help="synthetic obs from a nature run")
    q.add_argument("--config", required=True)
    q.add_argument("--nature", required=True)
    q.add_argument("--obs-template", required=True)
    q.add_argument("--out", required=True)
    q.add_argument("--seed", type=int, default=0)
    q.set_defaults(fn=cmd_obsmake)

    q = sub.add_parser("obssim", help="simulate obs fields on the model grid")
    q.add_argument("--config", required=True)
    q.add_argument("--state", required=True)
    q.add_argument("--vars", required=True, help="e.g. REF,Vr,T")
    q.add_argument("--out", required=True)
    q.set_defaults(fn=cmd_obssim)

    q = sub.add_parser("pp", help="topography preprocessing (scale-rm_pp)")
    q.add_argument("--config", required=True)
    q.add_argument("--dem", required=True,
                   help="DEM raster: .npz (elev/lon/lat) or flat binary")
    q.add_argument("--dem-geometry", default=None,
                   help="flat binary geometry: nlon,nlat,lon0,dlon,lat0,dlat")
    q.add_argument("--max-slope-ratio", type=float, default=0.5)
    q.add_argument("--out", required=True)
    q.set_defaults(fn=cmd_pp)

    q = sub.add_parser("fcst", help="ensemble forecast")
    q.add_argument("--config", required=True)
    q.add_argument("--init", required=True)
    q.add_argument("--steps", type=int, required=True)
    q.add_argument("--out", required=True)
    q.set_defaults(fn=cmd_fcst)

    q = sub.add_parser("cycle", help="cycling DA")
    q.add_argument("--config", required=True)
    q.add_argument("--init", required=True)
    q.add_argument("--cycles", type=int, required=True)
    q.add_argument("--steps-per-cycle", type=int, required=True)
    q.add_argument("--obs-pattern", required=True,
                   help="per-cycle obs path, e.g. obs/cycle{cycle}.dat")
    q.add_argument("--out", required=True)
    q.add_argument("--nest-init", default=None,
                   help="child-domain initial ensemble dir ([nest] configs)")
    q.add_argument("--nest-obs-pattern", default=None,
                   help="per-cycle child-domain obs path ([nest] configs)")
    q.add_argument("--streamed", action="store_true",
                   help="member-streamed beyond-HBM executor "
                        "(da/bigcycle.py) for reference-size domains")
    q.add_argument("--member-batch", type=int, default=5,
                   help="members per streamed device batch (--streamed)")
    q.add_argument("--tile-rows", type=int, default=24,
                   help="analysis row-tile height (--streamed)")
    q.add_argument("--pipeline", action="store_true",
                   help="double-buffer the streams (--streamed; faster "
                        "wall-clock, approximate phase attribution)")
    q.set_defaults(fn=cmd_cycle)

    args = p.parse_args(argv)
    if args.coordinator:
        from scale_letkf_tpu.parallel.distributed import init_distributed
        init_distributed(args.coordinator, args.num_processes,
                         args.process_id, args.local_device_count)
    import jax
    devs = jax.devices()
    print(f"[scale_letkf_tpu {args.cmd}] devices: {devs[0].platform} "
          f"({devs[0].device_kind}) x{len(devs)}", file=sys.stderr)
    args.fn(args)


if __name__ == "__main__":
    main()
