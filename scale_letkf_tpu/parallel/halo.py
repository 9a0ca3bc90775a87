"""Explicit halo-exchange stencils under shard_map.

Array-native equivalent of the reference's halo machinery (reference: SCALE
COMM_vars8/COMM_wait used at common_scale.f90:1385-1397; halo width 2 per
the IHALO/JHALO convention). Two multi-chip paths exist:

1. the default GSPMD path: the dycore's jnp.roll stencils compile to
   collective-permutes automatically when arrays are sharded (zero extra
   code; used by dryrun_multichip);
2. this module: shard_map with explicit ppermute ring exchanges building a
   halo-extended local block, running the *same* roll-based tendencies on
   the extended block, and cropping the interior. Identical numerics, with
   the communication explicit and BATCHED: the whole state is packed into
   ONE buffer per direction, so each RK stage issues 4 ppermutes total
   (COMM_vars8 batches its variables the same way) instead of one pair per
   field per axis.

Supported here (selectable via DycoreConfig.halo = 'explicit' |
'explicit_overlap'): periodic AND open lateral boundaries (open = mesh-edge
shards fill their outer halo with edge-replicated values, reproducing the
_shift_clamp ghost-cell convention), stretched vertical grids (VGrid), and
an overlap variant that computes interior tendencies from the local block
concurrently with the halo exchange, then patches the edge bands from
small halo-extended strips — the first step of compute/communication
overlap (XLA's latency-hiding scheduler can run the ppermutes while the
interior tendencies execute, since they have no data dependence).

The periodic wrap of rolls inside the extended block only pollutes the halo
zone, which is cropped; HALO_W must be ≥ the total stencil radius (UD3 and
the 4th-order hyperdiffusion both have radius 2; momentum advection
composes to ≤ 3)."""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from scale_letkf_tpu.model.dycore import (
    DycoreConfig, DycoreState, tendencies, rayleigh_sponge, _axpy,
)
from scale_letkf_tpu.parallel.mesh import AXIS_DY, AXIS_DX

HALO_W = 4
RADIUS = 3      # total stencil radius (UD3 + momentum composition ≤ 3)


def _ring_perm(n):
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    return fwd, bwd


def _edge_fill(local, axis, h, side):
    """Open-BC halo: replicate the boundary slice h times (the
    _shift_clamp ghost-cell convention, model/dycore.py)."""
    size = local.shape[axis]
    if side == "lo":
        edge = jax.lax.slice_in_dim(local, 0, 1, axis=axis)
    else:
        edge = jax.lax.slice_in_dim(local, size - 1, size, axis=axis)
    reps = [1] * local.ndim
    reps[axis] = h
    return jnp.tile(edge, reps)


def exchange_axis(local: jax.Array, axis: int, axis_name: str,
                  h: int = HALO_W, periodic: bool = True) -> jax.Array:
    """Extend `local` with h halo cells on both sides of `axis`, filled
    from ring neighbors along mesh axis `axis_name`. With periodic=False
    (open lateral boundaries) the first/last shard clamps its outer halo
    to the domain-edge value instead of wrapping."""
    n = jax.lax.axis_size(axis_name)
    lo = jax.lax.slice_in_dim(local, 0, h, axis=axis)
    hi = jax.lax.slice_in_dim(local, local.shape[axis] - h,
                              local.shape[axis], axis=axis)
    if n == 1:
        from_left, from_right = hi, lo
    else:
        fwd, bwd = _ring_perm(n)
        from_left = jax.lax.ppermute(hi, axis_name, fwd)   # left nbr's top
        from_right = jax.lax.ppermute(lo, axis_name, bwd)  # right nbr's bottom
    if not periodic:
        idx = jax.lax.axis_index(axis_name)
        from_left = jnp.where(idx == 0, _edge_fill(local, axis, h, "lo"),
                              from_left)
        from_right = jnp.where(idx == n - 1,
                               _edge_fill(local, axis, h, "hi"),
                               from_right)
    return jnp.concatenate([from_left, local, from_right], axis=axis)


def _pack(s: DycoreState) -> jax.Array:
    """Pack the whole state into one (..., nlev_total, ny, nx) buffer so
    each halo direction is ONE ppermute (COMM_vars8-style variable
    batching). Leading batch (member) axes pass through."""
    nq, nz = s.rhoq.shape[-4], s.rhoq.shape[-3]
    rhoq = s.rhoq.reshape(s.rhoq.shape[:-4] + (nq * nz,)
                          + s.rhoq.shape[-2:])
    return jnp.concatenate(
        [s.rho, s.rhou, s.rhov, s.rhot, s.rhow, rhoq], axis=-3)


def _unpack(buf: jax.Array, nz: int, nq: int) -> DycoreState:
    o = 0
    parts = []
    ax = buf.ndim - 3
    for span in (nz, nz, nz, nz, nz + 1, nq * nz):
        parts.append(jax.lax.slice_in_dim(buf, o, o + span, axis=ax))
        o += span
    rho, rhou, rhov, rhot, rhow, rhoq = parts
    rhoq = rhoq.reshape(rhoq.shape[:-3] + (nq, nz) + rhoq.shape[-2:])
    return DycoreState(rho=rho, rhou=rhou, rhov=rhov, rhow=rhow,
                       rhot=rhot, rhoq=rhoq)


def extend_state(s: DycoreState, h: int = HALO_W,
                 periodic: bool = True) -> DycoreState:
    """Halo-extend every field in y (axis -2) and x (axis -1) via ONE
    packed exchange per direction."""
    nz = s.rho.shape[-3]
    nq = s.rhoq.shape[-4]
    buf = _pack(s)
    buf = exchange_axis(buf, buf.ndim - 2, AXIS_DY, h, periodic)
    buf = exchange_axis(buf, buf.ndim - 1, AXIS_DX, h, periodic)
    return _unpack(buf, nz, nq)


def crop_state(s: DycoreState, h: int = HALO_W) -> DycoreState:
    return DycoreState(*(a[..., h:-h, h:-h] for a in s))


def _strip(s: DycoreState, axis_from_end: int, start: int,
           stop: int) -> DycoreState:
    """Slice every field along y (axis_from_end=2) or x (=1) — fields have
    different ranks, so the axis is counted from the end."""
    return DycoreState(*(jax.lax.slice_in_dim(
        a, start, stop, axis=a.ndim - axis_from_end) for a in s))


def _update(dst, src, axis_from_end, at):
    def upd(d, sl):
        idx = [0] * d.ndim
        idx[d.ndim - axis_from_end] = at
        return jax.lax.dynamic_update_slice(d, sl, tuple(idx))
    return DycoreState(*(upd(d, sl) for d, sl in zip(dst, src)))


def _build_local_tend(cfg, rho_ref, p_ref, vg, periodic, overlap,
                      batched):
    """Local (per-shard) tendency function shared by the single-state and
    ensemble halo steps. batched=True vmaps tendencies over a leading
    member axis (all halo/strip plumbing is end-axis based)."""
    h, r = HALO_W, RADIUS

    def tend_on(block):
        # periodic rolls inside the block: wrap only pollutes cells within
        # RADIUS of the block edge, which every caller crops/discards (the
        # open-BC clamp lives in the halo FILL, exchange_axis)
        from scale_letkf_tpu.model.dycore import lateral_bc
        with lateral_bc("periodic"):
            if batched:
                return jax.vmap(
                    lambda b: tendencies(b, cfg, rho_ref, p_ref, vg))(block)
            return tendencies(block, cfg, rho_ref, p_ref, vg)

    def local_tend(s_loc):
        ext = extend_state(s_loc, h, periodic)
        return crop_state(tend_on(ext), h)

    def local_tend_overlap(s_loc):
        ny, nx = s_loc.rho.shape[-2:]
        ext = extend_state(s_loc, h, periodic)
        # interior: computable from the local block alone (no halo/comm
        # dependence) — valid except within RADIUS of the local edge
        t = tend_on(s_loc)
        # y edge bands from strips of the extended block (height 3r: the
        # r valid target rows + r stencil margin each side); x strips span
        # the full extended y so corners are covered
        st = tend_on(_strip(ext, 2, h - r, h + 2 * r))
        band = DycoreState(*(a[..., r:2 * r, h:h + nx] for a in st))
        t = _update(t, band, 2, 0)
        nyext = ny + 2 * h
        st = tend_on(_strip(ext, 2, nyext - h - 2 * r, nyext - h + r))
        band = DycoreState(*(a[..., r:2 * r, h:h + nx] for a in st))
        t = _update(t, band, 2, ny - r)
        st = tend_on(_strip(ext, 1, h - r, h + 2 * r))
        band = DycoreState(*(a[..., h:h + ny, r:2 * r] for a in st))
        t = _update(t, band, 1, 0)
        nxext = nx + 2 * h
        st = tend_on(_strip(ext, 1, nxext - h - 2 * r, nxext - h + r))
        band = DycoreState(*(a[..., h:h + ny, r:2 * r] for a in st))
        t = _update(t, band, 1, nx - r)
        return t

    return local_tend_overlap if overlap else local_tend


def rk3_step_halo(s: DycoreState, cfg: DycoreConfig, rho_ref, p_ref,
                  z_center, mesh: Mesh, vg=None,
                  overlap: bool = False) -> DycoreState:
    """One RK3 step with explicit halo exchange per stage under shard_map.

    s holds GLOBAL arrays; in/out specs shard (ny, nx) over (dy, dx).
    Periodic and open lateral BCs and stretched grids (vg) are supported.
    overlap=True computes interior tendencies from the UN-extended local
    block (no communication dependence) and patches only the edge bands
    from halo-extended strips, so XLA may run the ppermutes concurrently
    with the interior compute."""
    periodic = cfg.lateral == "periodic"
    spec4 = P(None, AXIS_DY, AXIS_DX)
    spec5 = P(None, None, AXIS_DY, AXIS_DX)
    state_specs = DycoreState(rho=spec4, rhou=spec4, rhov=spec4,
                              rhow=spec4, rhot=spec4, rhoq=spec5)
    tend = _build_local_tend(cfg, rho_ref, p_ref, vg, periodic, overlap,
                             batched=False)

    @partial(shard_map, mesh=mesh, in_specs=(state_specs,),
             out_specs=state_specs)
    def step(s_loc):
        dt = cfg.dt
        f1 = tend(s_loc)
        s1 = _axpy(s_loc, f1, 1.0 / 3.0, dt)
        f2 = tend(s1)
        s2 = _axpy(s_loc, f2, 0.5, dt)
        f3 = tend(s2)
        s3 = _axpy(s_loc, f3, 1.0, dt)
        return rayleigh_sponge(s3, s_loc, cfg, z_center, dt)

    return step(s)


def _ext1(a, periodic):
    """Halo-1 extension of (..., ny, nx) in both horizontal axes."""
    a = exchange_axis(a, a.ndim - 2, AXIS_DY, 1, periodic)
    return exchange_axis(a, a.ndim - 1, AXIS_DX, 1, periodic)


def _xp1(ae):
    return ae[..., 1:-1, 2:]


def _xm1(ae):
    return ae[..., 1:-1, :-2]


def _yp1(ae):
    return ae[..., 2:, 1:-1]


def _ym1(ae):
    return ae[..., :-2, 1:-1]


def _zs(a, sl):
    """Slice the z axis (axis -3) with leading batch dims intact."""
    return a[(Ellipsis, sl) + (slice(None), slice(None))]


def _acoustic_substeps_halo(s_start, s_stage, slow, cfg, split, n_steps,
                            dt_stage, periodic, vg=None):
    """Per-shard acoustic substeps with halo-1 ppermute exchanges where
    the in-core version rolls (model/dycore_si.py acoustic_substeps): the
    pressure gradient needs dp at i+1/j+1 and the mass/theta divergence
    needs the UPDATED momenta at i-1/j-1 — one packed exchange each per
    substep, the communication pattern of every split-explicit core
    (the reference's COMM per acoustic small step). z stays column-local
    (the implicit solve needs no halo). Leading member axes batch through
    the exchanges (members ride the same packed buffers)."""
    from scale_letkf_tpu.constants import RD, CVDRY, GRAV
    CPDRY_ = RD + CVDRY
    dx, dy, dz = cfg.dx, cfg.dy, cfg.dz
    dzc = dz if vg is None else vg.dzc
    dzf = dz if vg is None else vg.dzf
    dtau = dt_stage / n_steps
    beta = split.beta

    from scale_letkf_tpu.model.dycore import moist_pressure
    rho0 = s_stage.rho
    rhot0 = s_stage.rhot

    def _c2_of(rho, rhot, rhoq):
        q = rhoq / jnp.maximum(rho, 1e-10)[None]
        p0 = moist_pressure(rhot, q)
        return (CPDRY_ / CVDRY) * p0 / rhot

    # moist_pressure is written for (nq, nz, ny, nx); vmap leading member
    c2 = (jax.vmap(_c2_of)(rho0, rhot0, s_stage.rhoq)
          if rho0.ndim == 4 else _c2_of(rho0, rhot0, s_stage.rhoq))
    theta0 = rhot0 / rho0
    theta_face = jnp.concatenate(
        [_zs(theta0, slice(0, 1)),
         0.5 * (_zs(theta0, slice(1, None)) + _zs(theta0, slice(0, -1))),
         _zs(theta0, slice(-1, None))], axis=-3)

    # halo-extended static per-stage fields: theta at x/y faces (used with
    # the shifted momenta inside the divergence)
    th_e = _ext1(theta0, periodic)
    theta_xf = 0.5 * (theta0 + _xp1(th_e))
    theta_yf = 0.5 * (theta0 + _yp1(th_e))
    theta_xf_e = _ext1(theta_xf, periodic)
    theta_yf_e = _ext1(theta_yf, periodic)

    g_half = dtau * beta * GRAV * 0.5
    abf = dtau * beta / dzf
    abc = dtau * beta / dzc
    if vg is None:
        abc_up = abc_dn = abc
    else:
        abc_up = abc[1:]
        abc_dn = abc[:-1]

    c2_up = _zs(c2, slice(1, None))
    c2_dn = _zs(c2, slice(0, -1))
    tf_mid = _zs(theta_face, slice(1, -1))
    tf_up = _zs(theta_face, slice(2, None))
    tf_dn = _zs(theta_face, slice(0, -2))
    b_diag = (1.0 + abf * tf_mid * (c2_up * abc_up + c2_dn * abc_dn)
              + g_half * (abc_up - abc_dn))
    c_sup = -abf * c2_up * abc_up * tf_up - g_half * abc_up
    a_sub = -abf * c2_dn * abc_dn * tf_dn + g_half * abc_dn
    if vg is None:
        b_diag = b_diag * jnp.ones_like(tf_mid)
        c_sup = c_sup * jnp.ones_like(tf_mid)
        a_sub = a_sub * jnp.ones_like(tf_mid)

    from scale_letkf_tpu.model.dycore_si import _thomas_solve

    def tri_solve(a, b, c, d):
        """Thomas along axis -3 with leading batch dims: move z to front
        and flatten the rest (the scan carries a full-plane vector op)."""
        mz = lambda x: jnp.moveaxis(x, -3, 0)
        uz = lambda x: jnp.moveaxis(x, 0, -3)
        return uz(_thomas_solve(mz(a), mz(b), mz(c), mz(d)))

    def substep(carry, _):
        drho, drhou, drhov, drhow, drhot = carry
        dp = c2 * drhot
        dpe = _ext1(dp, periodic)
        gx = (_xp1(dpe) - dp) / dx
        gy = (_yp1(dpe) - dp) / dy
        drhou = drhou + dtau * (-gx + slow.rhou)
        drhov = drhov + dtau * (-gy + slow.rhov)

        ue = _ext1(drhou, periodic)
        ve = _ext1(drhov, periodic)
        div_h = ((drhou - _xm1(ue)) / dx + (drhov - _ym1(ve)) / dy)
        u_th = drhou * theta_xf
        v_th = drhov * theta_yf
        u_th_m1 = _xm1(ue) * _xm1(theta_xf_e)
        v_th_m1 = _ym1(ve) * _ym1(theta_yf_e)
        div_h_th = ((u_th - u_th_m1) / dx + (v_th - v_th_m1) / dy)

        w_old = drhow
        dflux_w = (_zs(w_old, slice(1, None))
                   - _zs(w_old, slice(0, -1))) / dzc
        wth_old = w_old * theta_face
        dflux_wth = (_zs(wth_old, slice(1, None))
                     - _zs(wth_old, slice(0, -1))) / dzc
        rho_exp = drho + dtau * (slow.rho - div_h) \
            - dtau * (1 - beta) * dflux_w
        rhot_exp = drhot + dtau * (slow.rhot - div_h_th) \
            - dtau * (1 - beta) * dflux_wth

        dp_z = (_zs(dp, slice(1, None)) - _zs(dp, slice(0, -1))) / dzf
        rho_face_old = 0.5 * (_zs(drho, slice(1, None))
                              + _zs(drho, slice(0, -1)))
        d_rhs = (_zs(w_old, slice(1, -1))
                 + dtau * _zs(slow.rhow, slice(1, -1))
                 - dtau * (1 - beta) * (dp_z + GRAV * rho_face_old)
                 - abf * (c2_up * _zs(rhot_exp, slice(1, None))
                          - c2_dn * _zs(rhot_exp, slice(0, -1)))
                 - g_half * (_zs(rho_exp, slice(1, None))
                             + _zs(rho_exp, slice(0, -1))))

        w_new_int = tri_solve(a_sub, b_diag, c_sup, d_rhs)
        zeros = jnp.zeros_like(_zs(drhow, slice(0, 1)))
        w_new = jnp.concatenate([zeros, w_new_int, zeros], axis=-3)

        drho = rho_exp - abc * (_zs(w_new, slice(1, None))
                                - _zs(w_new, slice(0, -1)))
        wth_new = w_new * theta_face
        drhot = rhot_exp - abc * (_zs(wth_new, slice(1, None))
                                  - _zs(wth_new, slice(0, -1)))
        return (drho, drhou, drhov, w_new, drhot), None

    init = (s_start.rho - rho0, s_start.rhou - s_stage.rhou,
            s_start.rhov - s_stage.rhov, s_start.rhow - s_stage.rhow,
            s_start.rhot - rhot0)
    (drho, drhou, drhov, drhow, drhot), _ = jax.lax.scan(
        substep, init, None, length=n_steps)

    rhoq = s_start.rhoq + dt_stage * slow.rhoq
    return DycoreState(rho=rho0 + drho, rhou=s_stage.rhou + drhou,
                       rhov=s_stage.rhov + drhov,
                       rhow=s_stage.rhow + drhow,
                       rhot=rhot0 + drhot, rhoq=rhoq)


def _extend_metrics(m, h, periodic):
    """Halo-extend the (time-invariant) terrain metrics once per step."""
    if m is None:
        return None
    from scale_letkf_tpu.model.terrain import TerrainMetrics

    def _extnh(a):
        a = exchange_axis(a, a.ndim - 2, AXIS_DY, h, periodic)
        return exchange_axis(a, a.ndim - 1, AXIS_DX, h, periodic)

    return TerrainMetrics(
        jac=_extnh(m.jac[None])[0],
        gx=_extnh(m.gx),
        gy=_extnh(m.gy),
        gx_zf=_extnh(m.gx_zf),
        gy_zf=_extnh(m.gy_zf))


def rk3_step_si_halo_ens(ens: DycoreState, cfg: DycoreConfig, split,
                         rho_ref, p_ref, z_center, mesh: Mesh,
                         n_small: int, vg=None, metrics=None,
                         overlap: bool = False) -> DycoreState:
    """Split-explicit (HEVI) RK3 step with explicit halo exchange under
    shard_map — the production core's COMM_vars8 equivalent (SURVEY §2.8
    item 4; reference common_scale.f90:1385-1397). Slow tendencies run on
    an h=4 extended block (optionally with the interior/edge-band OVERLAP
    decomposition); each acoustic substep does halo-1 packed exchanges;
    the vertical implicit solve is column-local. Terrain metrics are
    halo-extended once per step. Physics stays on the GSPMD path
    (cycle.py documents the exclusion)."""
    from scale_letkf_tpu.parallel.mesh import AXIS_MEMBER
    from scale_letkf_tpu.model.dycore_si import SplitConfig  # noqa: F401
    periodic = cfg.lateral == "periodic"
    h = HALO_W
    spec5 = P(AXIS_MEMBER, None, AXIS_DY, AXIS_DX)
    spec6 = P(AXIS_MEMBER, None, None, AXIS_DY, AXIS_DX)
    state_specs = DycoreState(rho=spec5, rhou=spec5, rhov=spec5,
                              rhow=spec5, rhot=spec5, rhoq=spec6)
    if metrics is not None:
        from scale_letkf_tpu.model.terrain import TerrainMetrics
        sp3 = P(None, AXIS_DY, AXIS_DX)
        m_specs = TerrainMetrics(jac=P(AXIS_DY, AXIS_DX), gx=sp3, gy=sp3,
                                 gx_zf=sp3, gy_zf=sp3)
        in_specs = (state_specs, m_specs)
    else:
        in_specs = (state_specs,)

    ns1 = max(1, n_small // 3)
    ns2 = max(1, n_small // 2)
    dt = cfg.dt

    def make_step(with_metrics):
        def step(s_loc, *m_arg):
            from scale_letkf_tpu.model.dycore import lateral_bc
            m_ext = (_extend_metrics(m_arg[0], h, periodic)
                     if with_metrics else None)

            def tend_on(block):
                with lateral_bc("periodic"):
                    if m_ext is not None:
                        from scale_letkf_tpu.model.terrain import (
                            tendencies_terrain)
                        return jax.vmap(
                            lambda b: tendencies_terrain(
                                b, cfg, rho_ref, p_ref, m_ext, vg=vg))(block)
                    return jax.vmap(
                        lambda b: tendencies(b, cfg, rho_ref, p_ref,
                                             vg))(block)

            def slow_of(s_from):
                return crop_state(tend_on(extend_state(s_from, h, periodic)),
                                  h)

            def stage(s_from, dt_stage, ns):
                slow = slow_of(s_from)
                return _acoustic_substeps_halo(
                    s_loc, s_from, slow, cfg, split, ns, dt_stage,
                    periodic, vg=vg)

            s1 = stage(s_loc, dt / 3.0, ns1)
            s2 = stage(s1, dt / 2.0, ns2)
            s3 = stage(s2, dt, n_small)
            return rayleigh_sponge(s3, s_loc, cfg, z_center, dt)
        return step

    if metrics is not None:
        stepped = partial(shard_map, mesh=mesh, in_specs=in_specs,
                          out_specs=state_specs)(make_step(True))
        return stepped(ens, metrics)
    stepped = partial(shard_map, mesh=mesh, in_specs=in_specs,
                      out_specs=state_specs)(make_step(False))
    return stepped(ens)


def rk3_step_halo_ens(ens: DycoreState, cfg: DycoreConfig, rho_ref, p_ref,
                      z_center, mesh: Mesh, vg=None,
                      overlap: bool = False) -> DycoreState:
    """Ensemble halo step: (K, ...) state with the member axis sharded over
    the mesh's member dimension and (ny, nx) over (dy, dx) — the
    production forecast layout (parallel/mesh.py shard_ensemble)."""
    from scale_letkf_tpu.parallel.mesh import AXIS_MEMBER
    periodic = cfg.lateral == "periodic"
    spec5 = P(AXIS_MEMBER, None, AXIS_DY, AXIS_DX)
    spec6 = P(AXIS_MEMBER, None, None, AXIS_DY, AXIS_DX)
    state_specs = DycoreState(rho=spec5, rhou=spec5, rhov=spec5,
                              rhow=spec5, rhot=spec5, rhoq=spec6)
    tend = _build_local_tend(cfg, rho_ref, p_ref, vg, periodic, overlap,
                             batched=True)

    @partial(shard_map, mesh=mesh, in_specs=(state_specs,),
             out_specs=state_specs)
    def step(s_loc):
        dt = cfg.dt
        f1 = tend(s_loc)
        s1 = _axpy(s_loc, f1, 1.0 / 3.0, dt)
        f2 = tend(s1)
        s2 = _axpy(s_loc, f2, 0.5, dt)
        f3 = tend(s2)
        s3 = _axpy(s_loc, f3, 1.0, dt)
        return rayleigh_sponge(s3, s_loc, cfg, z_center, dt)

    return step(ens)
