"""LETKF analysis driver: the batched das_letkf.

Equivalent of `das_letkf` (reference: scale/letkf/letkf_tools.f90:50-932) —
but where the reference loops (ilev, ij) gridpoints under OpenMP and calls
scalar letkf_core per point, this driver runs ONE jitted computation: a
`lax.scan` over vertical levels whose body updates all horizontal points of
one level at once:

  per level: per-ctype candidate weights (vectorized obs_local_cal)
             → obs-number limit (top_k)
             → ONE gather of (dep, hdxb) shared by all var-local groups
             → batched K×K letkf_core per var-local group (the reference's
               var_local_n2n dedup, letkf_tools.f90:129-163, is exact here:
               the candidate selection is provably group-independent, so
               groups differ only by a per-slot multiplicative factor)
             → RTPP/RTPS relaxation, boundary β damping, weight application
             → deterministic-member update
  post:      q-spread limiter, Q_UPDATE_TOP masking, additive inflation

Var-local dedup correctness: the selection (distance rejection + top-k) uses
rloc computed with factor 1. Within one ctype the var-local factor is a
single constant, so scaling rloc (criterion 2) or rdiag (criterion 3) by it
never changes the per-ctype top-k ordering, and criterion 1 (distance) is
factor-free; a factor of 0 removes the ctype entirely, which we reproduce by
zeroing (rloc, dep, hdxb) after the shared gather.

Multi-device: pass `mesh` (the (member, dy, dx) jax Mesh) and every per-level
batch array is constrained to the gridpoint sharding — the LETKF "ensemble
transpose" of the reference (scatter_grd_mpi_alltoall,
common_mpi_scale.f90:1279) becomes a GSPMD resharding from the member-sharded
forecast layout to gridpoint-sharded analysis batches.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from scale_letkf_tpu.config import Config
from scale_letkf_tpu.grid import Grid
from scale_letkf_tpu.da.letkf_obs import ObsContext
from scale_letkf_tpu.ops.letkf_core import (
    letkf_core, weight_rtpp, weight_rtps, total_weight, relax_beta,
    resolve_eigh_impl,
)
from scale_letkf_tpu.ops.obs_select import (
    gather_candidates, local_weights, limit_obs_topk, gather_obs_data,
    pack_obs_table, gather_obs_data_packed,
)
from scale_letkf_tpu.state import IA_P, IA_Q0

# The weight apply is a K-term sum per analysis value; at DEFAULT precision
# a float32 product may run in TF32 (10-bit mantissa) on the GPU, so it
# asks for full float32 like the transform itself (ops/letkf_core.py).
HIGHEST = jax.lax.Precision.HIGHEST


@dataclass
class AnalysisDiag:
    nobs_per_level: np.ndarray       # (nz,) mean local obs count
    infl_field: np.ndarray | None    # updated adaptive inflation (nz, ny, nx)
    rtps_field: np.ndarray | None    # (NV3D, nz, ny, nx) RTPS factor
                                     # (RELAX_SPREAD_OUT, letkf_tools.f90:735)
    nobs_field: np.ndarray | None = None  # (nz, ny, nx) local obs counts
                                          # (NOBS_OUT, letkf_tools.f90:763-798)


@dataclass(frozen=True)
class _CtypePlan:
    """Static per-combined-type selection parameters."""
    hori_scale: float
    vert_scale: float
    vert_is_z: bool
    max_nobs: int


@dataclass(frozen=True)
class _Plan:
    """Everything statically shaping the compiled analysis (hashable: it is
    the jit-cache key together with the mesh and array shapes)."""
    ctypes: tuple[_CtypePlan, ...]
    group_vars: tuple[tuple[int, ...], ...]     # model vars per var-local group
    group_factors: tuple[tuple[float, ...], ...]  # per group, per ctype
    criterion: int
    adaptive: bool
    min_infl: float
    relax_alpha: float
    relax_alpha_spread: float
    relax_to_inflated_prior: bool
    relax_spread_out: bool
    boundary_buffer_width: float
    q_update_top: float
    q_sprd_max: float
    has_det: bool
    has_depd: bool
    eigh_impl: str
    has_obs_good: bool = False   # fused path: per-obs usable mask applied
                                 # to rloc before selection (QC in-graph)
    bf16_gather: bool = True     # bf16-packed (dep|hdxb) table gather —
                                 # halves the bytes of the dominant
                                 # per-level gather; f32-only
    level_chunk: int = 1         # levels batched per scan iteration (see
                                 # _auto_level_chunk)


@lru_cache(maxsize=4)
def _prep_jit(donate: bool):
    """Mean/perturbation split + scan-layout transposes as ONE jitted
    program. Eager one-op-at-a-time execution would materialize three
    full-state copies; fused (and optionally donating the input buffer)
    the peak is two at the full-size configs (the 13.7 GB f32 18-km
    state)."""
    def prep(g):
        K, nv, nz, ny, nx = g.shape
        B = ny * nx
        g = g.reshape(K, nv, nz, B)
        mean = jnp.mean(g, axis=0)                   # (nv, nz, B)
        pert_zkvb = jnp.transpose(g - mean[None], (2, 0, 1, 3))
        mean_zvb = jnp.transpose(mean, (1, 0, 2))
        logp_mean = jnp.log(jnp.maximum(mean_zvb[:, IA_P], 1e-3))
        return pert_zkvb, mean_zvb, mean, logp_mean
    return jax.jit(prep, donate_argnums=(0,) if donate else ())


def _auto_level_chunk(nz: int, B: int, requested: int = 0,
                      target: int = 4096) -> int:
    """Levels per scan iteration. Tiny domains (test grids, the multichip
    dryrun) are launch-bound in a per-level scan, so batch levels until the
    gridpoint batch reaches ~`target`; production domains keep chunk 1,
    which bounds the per-iteration obs-gather buffers.
    Must divide nz."""
    if requested > 0:
        c = min(requested, nz)
    else:
        c = max(1, min(nz, target // max(B, 1)))
    while nz % c:
        c -= 1
    return c


def _gp_spec(ndim: int) -> P:
    """PartitionSpec sharding the LAST axis over all mesh axes (the
    gridpoint-major 'ensemble transpose' layout). Axis order
    ('dy','dx','member') keeps the spatially-sharded blocks in place and
    splits each further over members — GSPMD lowers the reshard from the
    forecast layout to a clean all-to-all (the reference's
    scatter_grd_mpi_alltoall, common_mpi_scale.f90:1279) with no
    collective-permute."""
    return P(*([None] * (ndim - 1) + [("dy", "dx", "member")]))


@lru_cache(maxsize=32)
def _build_analysis_fn(plan: _Plan, mesh: Mesh | None):
    """Compile-cached analysis function for one (plan, mesh)."""

    def gp(a):
        if mesh is None or a is None:
            return a
        return jax.lax.with_sharding_constraint(
            a, NamedSharding(mesh, _gp_spec(a.ndim)))

    def gp_in(a, member_axis=None):
        """Entry reshard to the gridpoint layout ('ensemble transpose').
        Goes through the explicit intermediate sharding (member on the K
        axis, (dy,dx) on B) first: a direct reshard from the eagerly
        reshaped input layout triggers GSPMD's 'involuntary full
        rematerialization' fallback, while the two-step form lowers to the
        intended all-to-all (the reference's scatter_grd_mpi_alltoall;
        verified in tests/test_analysis_sharded.py)."""
        if mesh is None or a is None:
            return a
        mid = [None] * a.ndim
        if member_axis is not None:
            mid[member_axis] = "member"
        mid[a.ndim - 1] = ("dy", "dx")
        a = jax.lax.with_sharding_constraint(
            a, NamedSharding(mesh, P(*mid)))
        return gp(a)

    def repl(a):
        if mesh is None or a is None:
            return a
        return jax.lax.with_sharding_constraint(a, NamedSharding(mesh, P()))

    def fn(pert_zkvb,           # (nz, K, nv, B)
           mean_zvb,            # (nz, nv, B)
           infl0_zb,            # (nz, B)
           logp_zb, z_zb,       # (nz, B)
           gp_x, gp_y,          # (B,)
           dist_bdy,            # (B,) distance to lateral boundary
           cand,                # tuple of (B, C_ct) int32 candidate tables
           obs_x, obs_y, obs_vert, obs_err,   # (nobs,)
           dep_g,               # (nobs,)
           hdxb_g,              # (nobs, K)
           depd_g,              # (nobs,) or None
           pert_det_zvb,        # (nz, nv, B) or None
           mean_det_zvb,        # (nz, nv, B) or None
           obs_good=None):      # (nobs,) bool or None — fused-path QC mask
        dtype = pert_zkvb.dtype
        nz, K, nv, B = pert_zkvb.shape
        pert_orig, mean_orig = pert_zkvb, mean_zvb    # for Q_UPDATE_TOP

        # --- level chunking: process `ch` levels per scan iteration as one
        # ch·B batch. At small horizontal sizes a per-level scan is
        # launch-bound (dozens of tiny sequential kernels per level);
        # batching levels amortizes them. ch=1 at full-size domains keeps
        # the per-iteration gather memory bounded.
        ch = plan.level_chunk
        nzc = nz // ch if ch > 1 else nz
        B0 = B
        if ch > 1 and mesh is not None:
            # replicate before the chunk reshapes: merging part of the
            # (sharded) level axis into the gridpoint axis otherwise
            # triggers GSPMD's involuntary-full-rematerialization fallback
            # on the transposes (chunking only activates on SMALL domains,
            # so the all-gather is over tiny tensors; the production
            # full-size paths run ch == 1)
            (pert_zkvb, mean_zvb, infl0_zb, logp_zb, z_zb, gp_x, gp_y,
             dist_bdy) = map(repl, (pert_zkvb, mean_zvb, infl0_zb,
                                    logp_zb, z_zb, gp_x, gp_y, dist_bdy))
            cand = tuple(repl(c) for c in cand)
            pert_det_zvb = repl(pert_det_zvb)
            mean_det_zvb = repl(mean_det_zvb)
        if ch > 1:
            def m_zkvb(a):       # (nz,K,nv,B) → (nzc,K,nv,ch·B)
                a = a.reshape(nzc, ch, K, nv, B0)
                return jnp.transpose(a, (0, 2, 3, 1, 4)).reshape(
                    nzc, K, nv, ch * B0)

            def m_zvb(a):        # (nz,nv,B) → (nzc,nv,ch·B)
                if a is None:
                    return None
                a = a.reshape(nzc, ch, nv, B0)
                return jnp.transpose(a, (0, 2, 1, 3)).reshape(
                    nzc, nv, ch * B0)

            def m_zb(a):         # (nz,B) → (nzc,ch·B)
                return a.reshape(nzc, ch * B0)

            pert_zkvb = m_zkvb(pert_zkvb)
            mean_zvb = m_zvb(mean_zvb)
            infl0_zb, logp_zb, z_zb = map(m_zb, (infl0_zb, logp_zb, z_zb))
            pert_det_zvb = m_zvb(pert_det_zvb)
            mean_det_zvb = m_zvb(mean_det_zvb)
            gp_x = jnp.tile(gp_x, ch)
            gp_y = jnp.tile(gp_y, ch)
            dist_bdy = jnp.tile(dist_bdy, ch)
            cand = tuple(jnp.tile(c, (ch, 1)) for c in cand)
            B = ch * B0

        pert_zkvb = gp_in(pert_zkvb, member_axis=1)
        mean_zvb = gp_in(mean_zvb)
        infl0_zb = gp_in(infl0_zb)
        logp_zb = gp_in(logp_zb)
        z_zb = gp_in(z_zb)
        gp_x, gp_y, dist_bdy = gp_in(gp_x), gp_in(gp_y), gp_in(dist_bdy)
        cand = tuple(gp_in(c) for c in cand)
        obs_x, obs_y = repl(obs_x), repl(obs_y)
        obs_vert, obs_err = repl(obs_vert), repl(obs_err)
        dep_g, hdxb_g = repl(dep_g), repl(hdxb_g)
        depd_g = repl(depd_g)
        # expected post-top-k selection width (static): the packed gather
        # only wins when the per-level gather is large enough to be
        # element-count bound (small fused cycles are launch-bound and the
        # pack/bitcast overhead costs time)
        L_tot = sum(
            (min(cp.max_nobs, cand[ic].shape[-1]) if cp.max_nobs > 0
             else cand[ic].shape[-1])
            for ic, cp in enumerate(plan.ctypes)) if plan.ctypes else 1
        use_packed = (plan.bf16_gather and dtype == jnp.float32
                      and B * L_tot * (K + 1) >= 3e7)
        packed_g = pack_obs_table(dep_g, hdxb_g) if use_packed else None
        pert_det_zvb = gp_in(pert_det_zvb)
        mean_det_zvb = gp_in(mean_det_zvb)
        # on a mesh the gridpoint batch of every solve is split
        eigh_impl = resolve_eigh_impl(plan.eigh_impl, K, dtype,
                                      sharded=mesh is not None)

        def level_body(carry, xs):
            (pert_l, mean_l, infl_l, logp_l, z_l,
             pert_det_l, mean_det_l) = xs
            pert_l = gp(pert_l)

            if plan.boundary_buffer_width > 0:
                beta = relax_beta(dist_bdy, z_l,
                                  buffer_width=plan.boundary_buffer_width)
            else:
                beta = jnp.ones(B, dtype)

            # --- shared local-obs selection (factor-1 weights + top-k)
            idx_parts, rloc_parts, rdiag_parts = [], [], []
            for ic, cp in enumerate(plan.ctypes):
                gp_vert = z_l if cp.vert_is_z else logp_l
                nd2, rloc, rdiag = local_weights(
                    cand[ic], obs_x, obs_y, obs_vert, obs_err,
                    gp_x, gp_y, gp_vert, cp.hori_scale, cp.vert_scale)
                if plan.has_obs_good:
                    # in-graph QC: bad obs lose their localization weight
                    # BEFORE the top-k so they neither occupy selection
                    # slots nor touch the transform (host path filters
                    # them out of the arrays instead)
                    gm = jnp.where(cand[ic] >= 0,
                                   obs_good[jnp.maximum(cand[ic], 0)],
                                   False)
                    rloc = jnp.where(gm, rloc, 0.0)
                if cp.max_nobs > 0:
                    idx_k, rloc_k, rdiag_k = limit_obs_topk(
                        cand[ic], nd2, rloc, rdiag, cp.max_nobs,
                        plan.criterion, obs_err=obs_err)
                else:
                    idx_k = jnp.where(rloc > 0, cand[ic], -1)
                    rloc_k, rdiag_k = rloc, rdiag
                idx_parts.append(idx_k)
                rloc_parts.append(rloc_k)
                rdiag_parts.append(rdiag_k)
            if idx_parts:
                idx = gp(jnp.concatenate(idx_parts, axis=-1))
                rloc0 = gp(jnp.concatenate(rloc_parts, axis=-1))
                rdiag0 = gp(jnp.concatenate(rdiag_parts, axis=-1))
                widths = [p.shape[-1] for p in idx_parts]
            else:   # no usable obs types: one all-padded slot
                idx = jnp.full((B, 1), -1, jnp.int32)
                rloc0 = jnp.zeros((B, 1), dtype)
                rdiag0 = jnp.ones((B, 1), dtype)
                widths = [1]

            # ONE gather shared by every var-local group
            if use_packed:
                dep_l, hdxb_l = gather_obs_data_packed(idx, packed_g, K)
            else:
                dep_l, hdxb_l = gather_obs_data(idx, dep_g, hdxb_g)
            dep_l, hdxb_l = gp(dep_l), gp(hdxb_l)
            if plan.has_depd:
                depd_l, _ = gather_obs_data(idx, depd_g, hdxb_g)
            else:
                depd_l = None
            nobs_pt = jnp.sum(rloc0 > 0, axis=-1)

            pert_vbk = jnp.transpose(pert_l, (1, 2, 0))   # (nv, B, K)
            parm = infl_l if plan.relax_to_inflated_prior \
                else jnp.ones_like(infl_l)

            anal_parts = [None] * nv
            det_parts = [None] * nv
            rtps_parts = [None] * nv
            infl_out = infl_l

            for g, vidx in enumerate(plan.group_vars):
                facs = plan.group_factors[g] if plan.group_factors else ()
                if facs and any(f != 1.0 for f in facs):
                    fac_np = np.concatenate(
                        [np.full(w, f, np.float64)
                         for w, f in zip(widths, facs)])
                    fac = jnp.asarray(fac_np, dtype)
                    rloc_g = rloc0 * fac
                    sel = rloc_g > 0
                    rdiag_g = jnp.where(sel, rdiag0 / jnp.maximum(fac, 1e-30),
                                        1.0)
                    dep_gm = jnp.where(sel, dep_l, 0.0)
                    hdxb_gm = jnp.where(sel[..., None], hdxb_l, 0.0)
                    depd_gm = (jnp.where(sel, depd_l, 0.0)
                               if depd_l is not None else None)
                else:
                    rloc_g, rdiag_g = rloc0, rdiag0
                    dep_gm, hdxb_gm, depd_gm = dep_l, hdxb_l, depd_l

                res = letkf_core(hdxb_gm, rdiag_g, rloc_g, dep_gm, infl_l,
                                 rdiag_wloc=True,
                                 infl_update=plan.adaptive and g == 0,
                                 depd=depd_gm,
                                 min_infl=max(plan.min_infl, 0.0),
                                 eigh_impl=eigh_impl)
                if g == 0:
                    infl_out = res.infl

                pert_g = pert_vbk[np.asarray(vidx)]       # (nvg, B, K)
                if plan.relax_alpha != 0.0:
                    trans_rlx = weight_rtpp(res.trans, parm, plan.relax_alpha)
                    w_tot = total_weight(trans_rlx, res.transm, beta)
                    anal_g = mean_l[np.asarray(vidx)][..., None] + jnp.einsum(
                        "vbk,bkm->vbm", pert_g, w_tot,
                        preferred_element_type=dtype,
                        precision=HIGHEST)
                    m_g = jnp.ones((len(vidx), B), dtype)
                elif plan.relax_alpha_spread != 0.0:
                    # RTPS is per-variable (xb = that variable's perturbations)
                    trans_all, m_g = jax.vmap(
                        lambda xb: weight_rtps(res.trans, res.pao, xb, parm,
                                               plan.relax_alpha_spread))(
                        pert_g)
                    w_tots = jax.vmap(
                        lambda tv: total_weight(tv, res.transm, beta))(
                        trans_all)
                    anal_g = mean_l[np.asarray(vidx)][..., None] + jnp.einsum(
                        "vbk,vbkm->vbm", pert_g, w_tots,
                        preferred_element_type=dtype,
                        precision=HIGHEST)
                else:
                    w_tot = total_weight(res.trans, res.transm, beta)
                    anal_g = mean_l[np.asarray(vidx)][..., None] + jnp.einsum(
                        "vbk,bkm->vbm", pert_g, w_tot,
                        preferred_element_type=dtype,
                        precision=HIGHEST)
                    m_g = jnp.ones((len(vidx), B), dtype)

                for j, v in enumerate(vidx):
                    anal_parts[int(v)] = anal_g[j]
                    rtps_parts[int(v)] = m_g[j]

                if plan.has_det:
                    incr = jnp.einsum("vbk,bk->vb", pert_g, res.transmd,
                                      preferred_element_type=dtype,
                                      precision=HIGHEST)
                    det_g = mean_det_l[np.asarray(vidx)] + incr * beta[None]
                    for j, v in enumerate(vidx):
                        det_parts[int(v)] = det_g[j]

            anal_l = jnp.stack(anal_parts, axis=0)        # (nv, B, K)
            rtps_l = jnp.stack(rtps_parts, axis=0)        # (nv, B)
            det_l = (jnp.stack(det_parts, axis=0)
                     if plan.has_det else jnp.zeros((1, 1), dtype))
            return carry, (anal_l, infl_out, nobs_pt, det_l, rtps_l)

        xs = (pert_zkvb, mean_zvb, infl0_zb, logp_zb, z_zb,
              pert_det_zvb if plan.has_det else jnp.zeros((nzc, 1, 1), dtype),
              mean_det_zvb if plan.has_det else jnp.zeros((nzc, 1, 1), dtype))
        _, (anal_z, infl_z, nobs_z, det_z, rtps_z) = jax.lax.scan(
            level_body, 0.0, xs)

        if ch > 1:
            # un-chunk: (nzc, …, ch·B[, K]) → (nz, …, B[, K])
            def u_out(a):        # (nzc, nv, ch·B, K)
                a = a.reshape(nzc, nv, ch, B0, K)
                return jnp.transpose(a, (0, 2, 1, 3, 4)).reshape(
                    nz, nv, B0, K)

            def u_vb(a):         # (nzc, nv, ch·B)
                a = a.reshape(nzc, nv, ch, B0)
                return jnp.transpose(a, (0, 2, 1, 3)).reshape(nz, nv, B0)

            anal_z = u_out(anal_z)
            infl_z = infl_z.reshape(nz, B0)
            nobs_z = nobs_z.reshape(nz, B0)
            rtps_z = u_vb(rtps_z)
            if plan.has_det:
                det_z = u_vb(det_z)
            B = B0

        anal = jnp.transpose(anal_z, (3, 1, 0, 2))        # (K, nv, nz, B)
        if mesh is not None:
            # reverse 'ensemble transpose': hand the analysis back in the
            # forecast layout (member-sharded K, spatially-sharded B)
            anal = jax.lax.with_sharding_constraint(
                anal, NamedSharding(mesh, P("member", None, None,
                                            ("dy", "dx"))))
        mean_p = mean_orig[:, IA_P]                       # (nz, B)

        # Q_UPDATE_TOP: keep the first guess for moisture above the level
        # where mean p < Q_UPDATE_TOP (letkf_tools.f90:371)
        if plan.q_update_top > 0:
            gues_full = mean_orig[None].transpose(0, 2, 1, 3) + \
                pert_orig.transpose(1, 2, 0, 3)           # (K, nv, nz, B)
            qmask = (mean_p < plan.q_update_top)[None, None]
            var_is_q = jnp.arange(nv)[None, :, None, None] >= IA_Q0
            anal = jnp.where(qmask & var_is_q, gues_full, anal)

        # q-spread limiter (letkf_tools.f90:500-513)
        if plan.q_sprd_max > 0:
            q = anal[:, IA_Q0]
            q_mean = jnp.mean(q, axis=0)
            q_pert = q - q_mean[None]
            q_sprd = jnp.sqrt(jnp.sum(q_pert**2, axis=0) / (K - 1)) \
                / jnp.maximum(jnp.abs(q_mean), 1e-30)
            scale = jnp.where(
                q_sprd > plan.q_sprd_max,
                plan.q_sprd_max / jnp.maximum(q_sprd, 1e-30), 1.0)
            anal = anal.at[:, IA_Q0].set(q_mean[None] + q_pert * scale[None])

        return anal, infl_z, nobs_z, det_z, rtps_z

    return jax.jit(fn)


def _make_plan(ctx: ObsContext, cfg: Config, nv: int,
               has_det: bool) -> _Plan:
    """Derive the static analysis plan from the obs context + config."""
    # variable-localization groups: model variables sharing the same column
    # of the var_local table share one transform (var_local_n2n dedup,
    # letkf_tools.f90:129-163)
    vl_table = cfg.var_local.table(nv)            # (9, nv)
    cols = [tuple(float(x) for x in vl_table[:, v]) for v in range(nv)]
    unique_cols = list(dict.fromkeys(cols))
    group_vars = tuple(
        tuple(int(v) for v in range(nv) if cols[v] == c)
        for c in unique_cols)
    group_factors = tuple(
        tuple(col[ct.varlocal_group] for ct in ctx.ctypes)
        for col in unique_cols)

    ctypes = tuple(_CtypePlan(
        hori_scale=float(ct.hori_scale),
        vert_scale=float(ct.vert_scale),
        vert_is_z=(ct.vert_kind == "z"),
        max_nobs=int(ct.max_nobs)) for ct in ctx.ctypes)

    adaptive = cfg.letkf.infl_mul_adaptive or cfg.letkf.infl_mul <= 0
    return _Plan(
        ctypes=ctypes,
        group_vars=group_vars,
        group_factors=group_factors,
        criterion=int(cfg.letkf_obs.max_nobs_per_grid_criterion),
        adaptive=bool(adaptive),
        min_infl=float(cfg.letkf.infl_mul_min),
        relax_alpha=float(cfg.letkf.relax_alpha),
        relax_alpha_spread=float(cfg.letkf.relax_alpha_spread),
        relax_to_inflated_prior=bool(cfg.letkf.relax_to_inflated_prior),
        relax_spread_out=bool(cfg.letkf.relax_spread_out),
        boundary_buffer_width=float(cfg.letkf.boundary_buffer_width),
        q_update_top=float(cfg.letkf.q_update_top),
        q_sprd_max=float(cfg.letkf.q_sprd_max),
        has_det=has_det,
        has_depd=ctx.depd is not None,
        eigh_impl=str(cfg.letkf.eigh_impl),
        bf16_gather=bool(cfg.letkf.hdxb_gather_bf16),
    )


def analyze(
    gues: jax.Array,              # (K, NV3D, nz, ny, nx) analysis variables
    ctx: ObsContext,
    cfg: Config,
    grid: Grid,
    z_full: jax.Array,            # (nz, ny, nx) heights
    infl_field: jax.Array | None = None,   # (nz, ny, nx); None → INFL_MUL
    gues_det: jax.Array | None = None,     # (NV3D, nz, ny, nx) deterministic
    mesh: Mesh | None = None,              # (member, dy, dx) device mesh
    addi_ens: jax.Array | None = None,     # (K, NV3D, nz, ny, nx) additive-
                                           # inflation source ensemble
    rng: np.random.Generator | None = None,  # for INFL_ADD_SHUFFLE
    lower_only: bool = False,     # return compiled HLO text (tests: verify
                                  # the ensemble transpose lowers to
                                  # all-to-all, not a remat fallback)
    donate_gues: bool = False,    # hand the gues buffer to the prep jit so
                                  # XLA reuses it (full-size domains: the
                                  # state is GBs; the caller's array is
                                  # invalidated)
) -> tuple[jax.Array, jax.Array | None, AnalysisDiag]:
    """Analysis update. Returns (anal, anal_det, diag)."""
    K, nv, nz, ny, nx = gues.shape
    dtype = gues.dtype
    B = ny * nx
    if mesh is not None:
        # start from the forecast layout on the mesh: an unplaced input
        # would otherwise be split into mean/perturbations on one device
        from scale_letkf_tpu.parallel.mesh import stacked_state_sharding
        gues = jax.device_put(gues, stacked_state_sharding(mesh))

    pert_zkvb, mean_zvb, mean, logp_mean = _prep_jit(bool(donate_gues))(
        gues)

    if infl_field is None:
        infl0 = jnp.full((nz, B), cfg.letkf.infl_mul, dtype)
    else:
        infl0 = jnp.asarray(infl_field, dtype).reshape(nz, B)

    # gridpoint coordinates in projection space
    xs, ys = grid.xy
    gp_x = jnp.asarray(
        np.broadcast_to(xs[None, :], (ny, nx)).reshape(-1), dtype)
    gp_y = jnp.asarray(
        np.broadcast_to(ys[:, None], (ny, nx)).reshape(-1), dtype)
    dist_x = np.minimum(
        np.broadcast_to(xs[None, :], (ny, nx)) - xs[0],
        xs[-1] - np.broadcast_to(xs[None, :], (ny, nx)))
    dist_y = np.minimum(
        np.broadcast_to(ys[:, None], (ny, nx)) - ys[0],
        ys[-1] - np.broadcast_to(ys[:, None], (ny, nx)))
    dist_bdy = jnp.asarray(np.minimum(dist_x, dist_y).reshape(-1), dtype)

    # per-ctype candidate gathers (level-independent)
    cand = tuple(gather_candidates(ct.buckets, gp_x, gp_y)
                 for ct in ctx.ctypes)

    plan = _make_plan(ctx, cfg, nv, gues_det is not None)
    chunk = _auto_level_chunk(nz, B, cfg.letkf.level_batch)
    if chunk > 1:
        import dataclasses
        plan = dataclasses.replace(plan, level_chunk=chunk)
    if cfg.letkf.infl_add > 0 and addi_ens is None:
        raise ValueError(
            "INFL_ADD > 0 requires an additive-inflation ensemble "
            "(addi_ens; reference INFL_ADD_IN_BASENAME files)")

    fn = _build_analysis_fn(plan, mesh)

    z_zb = jnp.asarray(z_full, dtype).reshape(nz, B)
    if gues_det is not None:
        det_r = jnp.asarray(gues_det, dtype).reshape(nv, nz, B)
        pert_det_zvb = jnp.transpose(det_r - mean, (1, 0, 2))
        mean_det_zvb = jnp.transpose(det_r, (1, 0, 2))
    else:
        pert_det_zvb = None
        mean_det_zvb = None

    depd_dev = (jnp.asarray(ctx.depd, dtype)
                if ctx.depd is not None else None)

    fn_args = (
        pert_zkvb, mean_zvb, infl0, logp_mean, z_zb,
        gp_x, gp_y, dist_bdy, cand,
        jnp.asarray(ctx.x, dtype), jnp.asarray(ctx.y, dtype),
        jnp.asarray(ctx.vert, dtype), jnp.asarray(ctx.err, dtype),
        jnp.asarray(ctx.dep, dtype), jnp.asarray(ctx.hdxb, dtype),
        depd_dev, pert_det_zvb, mean_det_zvb, None)
    if lower_only:
        return fn.lower(*fn_args).compile().as_text()
    anal_kvzb, infl_zb, nobs_zb, det_zvb, rtps_zvb = fn(*fn_args)

    anal = anal_kvzb.reshape(K, nv, nz, ny, nx)
    anal_det_out = (jnp.transpose(det_zvb, (1, 0, 2)).reshape(nv, nz, ny, nx)
                    if gues_det is not None else None)

    # --- additive inflation (letkf_tools.f90:804-929)
    if cfg.letkf.infl_add > 0:
        from scale_letkf_tpu.da.inflation import (
            apply_additive_inflation, knuth_shuffle, radar_proximity_weight)
        from scale_letkf_tpu.obs.types import ID_RADAR_REF
        weight = None
        if cfg.letkf.infl_add_ref_only:
            ref_ct = [ct for ct in ctx.ctypes if ct.elem == ID_RADAR_REF]
            if ref_ct:
                ct = ref_ct[0]
                weight = radar_proximity_weight(
                    np.asarray(gp_x), np.asarray(gp_y),
                    ctx.x[ct.obs_idx], ctx.y[ct.obs_idx],
                    ct.hori_scale, buckets=ct.buckets,
                    obs_x_all=ctx.x, obs_y_all=ctx.y)
            else:
                weight = np.zeros(B)
            weight = jnp.asarray(weight.reshape(ny, nx), dtype)
        shuffle = None
        if cfg.letkf.infl_add_shuffle:
            shuffle = knuth_shuffle(rng or np.random.default_rng(0), K)
        anal = apply_additive_inflation(
            anal, jnp.asarray(addi_ens, dtype), cfg.letkf.infl_add,
            shuffle=shuffle, weight=weight,
            q_ratio=cfg.letkf.infl_add_q_ratio,
            gues_mean=mean.reshape(nv, nz, ny, nx))

    adaptive = plan.adaptive
    rtps_out = None
    if cfg.letkf.relax_spread_out:
        if cfg.letkf.relax_alpha_spread == 0.0:
            raise ValueError("RELAX_SPREAD_OUT requires RELAX_ALPHA_SPREAD")
        rtps_out = np.asarray(
            jnp.transpose(rtps_zvb, (1, 0, 2))).reshape(nv, nz, ny, nx)

    nobs_np = np.asarray(nobs_zb)
    diag = AnalysisDiag(
        nobs_per_level=nobs_np.mean(axis=1),
        infl_field=(np.asarray(infl_zb).reshape(nz, ny, nx)
                    if adaptive else None),
        rtps_field=rtps_out,
        nobs_field=(nobs_np.reshape(nz, ny, nx).astype(np.float64)
                    if cfg.letkf.nobs_out else None))
    return anal, anal_det_out, diag
