"""Local observation selection: bucket grid + fixed-capacity candidate gather.

Batched replacement for the reference's per-gridpoint incremental search
(reference: letkf_obs.f90:660-855 bucket counting sort per combined obs type;
letkf_tools.f90:1325-1759 obs_local rectangle search + QUICKSELECT top-k).

Design: observation coordinates are data-dependent, so the bucket structure
is built once per analysis on the host (cheap, O(nobs)); everything
per-gridpoint then runs as dense gathers on device:

  host:  obs (x, y) → (mesh_ny, mesh_nx, cap) int32 bucket table (-1 pad)
  device: gridpoint (x, y) → 3×3 bucket neighborhood → 9·cap candidate ids
          → vectorized obs_local_cal weights → lax.top_k obs-number limit

With bucket spacing >= the localization cutoff radius, the 3×3 neighborhood
provably covers the cutoff disc, matching the reference's rectangle search.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from scale_letkf_tpu.ops.localization import (
    DIST_ZERO_FAC, DIST_ZERO_FAC_SQ, gauss_taper,
)


@dataclass(frozen=True)
class BucketGrid:
    """Fixed-capacity obs bucket table for one combined obs type."""
    table: np.ndarray      # (mesh_ny, mesh_nx, cap) int32 obs indices, -1 pad
    x0: float              # mesh origin
    y0: float
    spacing_x: float
    spacing_y: float
    n_dropped: int         # obs dropped due to capacity overflow (0 normally)
    nsch: int = 1          # search halo in cells: the candidate gather scans
                           # (2·nsch+1)² cells so nsch·spacing must cover the
                           # localization cutoff (the reference's ngrdsch,
                           # letkf_obs.f90:676-677)

    @property
    def mesh_shape(self):
        return self.table.shape[:2]


def build_buckets(
    x: np.ndarray, y: np.ndarray,
    x0: float, y0: float, x1: float, y1: float,
    spacing: float,
    min_capacity: int = 4,
    max_capacity: int = 0,
    index_map: np.ndarray | None = None,
    nsch: int = 1,
) -> BucketGrid:
    """Host-side counting sort of obs into mesh cells
    (letkf_obs.f90:746-806 analogue). Capacity = max cell count (rounded up
    to a multiple of 4) so nothing is dropped unless min_capacity forces it.

    max_capacity > 0 bounds the per-cell capacity INDEPENDENTLY of the
    global max cell count — the HBM-capacity analogue of the reference's
    incremental-radius obs-number limit (letkf_tools.f90:1479-1617): cells
    holding more obs are stratified-thinned (every n/cap-th obs in stable
    order, spatially unbiased for ray/file-ordered radar volumes) and the
    dropped count is reported in n_dropped. With a per-gridpoint top-k
    limit of L obs, cap ≈ 2·L keeps the selection near-exact while the
    candidate width stays 9·cap regardless of obs density.

    index_map: optional (nobs,) mapping from local to global obs ids,
    applied to the stored table entries."""
    nx = max(1, int(np.ceil((x1 - x0) / spacing)))
    ny = max(1, int(np.ceil((y1 - y0) / spacing)))

    n_prethinned = 0
    if max_capacity > 0 and len(x) > 0:
        # stratified pre-thinning of overflowing cells (vectorized)
        ci0 = np.clip(((x - x0) / spacing).astype(np.int64), 0, nx - 1)
        cj0 = np.clip(((y - y0) / spacing).astype(np.int64), 0, ny - 1)
        flat0 = cj0 * nx + ci0
        order = np.argsort(flat0, kind="stable")
        sf = flat0[order]
        counts = np.bincount(flat0, minlength=nx * ny)
        # position of each (sorted) obs within its cell
        first_of_cell = np.zeros(nx * ny, np.int64)
        np.cumsum(counts[:-1], out=first_of_cell[1:])
        pos = np.arange(len(x)) - first_of_cell[sf]
        n_cell = counts[sf]
        cap = max_capacity
        keep_sorted = ((pos + 1) * cap) // np.maximum(n_cell, 1) \
            > (pos * cap) // np.maximum(n_cell, 1)
        keep_sorted |= n_cell <= cap
        keep = np.zeros(len(x), bool)
        keep[order] = keep_sorted
        n_prethinned = int((~keep).sum())
        if n_prethinned:
            x = x[keep]
            y = y[keep]
            index_map = (index_map[keep] if index_map is not None
                         else np.nonzero(keep)[0].astype(np.int32))

    def _remap(table):
        if index_map is None:
            return table
        return np.where(table >= 0,
                        index_map[np.clip(table, 0, None)], -1).astype(
            np.int32)

    from scale_letkf_tpu.utils import native
    lib = native.load()
    if lib is not None and len(x):
        import ctypes
        xd = np.ascontiguousarray(x, np.float64)
        yd = np.ascontiguousarray(y, np.float64)
        pd = ctypes.POINTER(ctypes.c_double)
        cap = lib.bucket_max_count(xd.ctypes.data_as(pd),
                                   yd.ctypes.data_as(pd), len(x),
                                   x0, y0, spacing, spacing, nx, ny)
        cap = -(-max(cap, min_capacity) // 4) * 4
        table = np.empty(ny * nx * cap, np.int32)
        dropped = lib.bucket_sort(
            xd.ctypes.data_as(pd), yd.ctypes.data_as(pd), len(x),
            x0, y0, spacing, spacing, nx, ny, cap,
            table.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return BucketGrid(table=_remap(table.reshape(ny, nx, cap)),
                          x0=x0, y0=y0,
                          spacing_x=spacing, spacing_y=spacing,
                          n_dropped=int(dropped) + n_prethinned,
                          nsch=nsch)

    ci = np.clip(((x - x0) / spacing).astype(np.int64), 0, nx - 1)
    cj = np.clip(((y - y0) / spacing).astype(np.int64), 0, ny - 1)
    flat = cj * nx + ci
    counts = np.bincount(flat, minlength=nx * ny)
    cap = max(min_capacity, int(counts.max()) if len(x) else min_capacity)
    cap = -(-cap // 4) * 4
    table = np.full((ny * nx, cap), -1, np.int32)
    order = np.argsort(flat, kind="stable")
    slot = np.zeros(nx * ny, np.int64)
    dropped = 0
    for idx in order:
        c = flat[idx]
        s = slot[c]
        if s < cap:
            table[c, s] = idx
            slot[c] = s + 1
        else:
            dropped += 1
    return BucketGrid(table=_remap(table.reshape(ny, nx, cap)),
                      x0=x0, y0=y0,
                      spacing_x=spacing, spacing_y=spacing,
                      n_dropped=dropped + n_prethinned,
                      nsch=nsch)


def gather_candidates(grid: BucketGrid, gx: jax.Array, gy: jax.Array,
                      table: jax.Array | None = None) -> jax.Array:
    """Candidate obs ids for each gridpoint from its (2·nsch+1)² bucket
    neighborhood (nsch=1 → the classic 3×3; finer sort meshes carry a wider
    static halo, the reference's ngrdsch search rectangle,
    letkf_obs.f90:676-677 + obs_local_range).

    gx, gy: (B,) gridpoint coordinates in the bucket coordinate system.
    `table`: optional pre-uploaded device copy of grid.table — pass it
    when calling inside jit (otherwise the host table is baked into the
    program as a constant: at radar densities that bloats the executable
    and the compile time).
    Returns (B, (2·nsch+1)²·cap) int32 with -1 padding.
    """
    if table is None:
        table = jnp.asarray(grid.table)
    ny, nx, cap = table.shape
    n = grid.nsch
    ci = jnp.floor((gx - grid.x0) / grid.spacing_x).astype(jnp.int32)
    cj = jnp.floor((gy - grid.y0) / grid.spacing_y).astype(jnp.int32)
    # static trim: offsets that are out of range for EVERY gridpoint are
    # skipped, so small domains (few cells per axis) keep a narrow
    # candidate width instead of rows of -1 padding
    djs = tuple(d for d in range(-n, n + 1) if -d < ny and d < ny)
    dis = tuple(d for d in range(-n, n + 1) if -d < nx and d < nx)
    out = []
    for dj in djs:
        for di in dis:
            jj = cj + dj
            ii = ci + di
            inside = (jj >= 0) & (jj < ny) & (ii >= 0) & (ii < nx)
            jj = jnp.clip(jj, 0, ny - 1)
            ii = jnp.clip(ii, 0, nx - 1)
            vals = table[jj, ii]                      # (B, cap)
            out.append(jnp.where(inside[:, None], vals, -1))
    return jnp.concatenate(out, axis=-1)


def local_weights(
    cand_idx: jax.Array,        # (B, C) candidate obs ids, -1 pad
    obs_x: jax.Array, obs_y: jax.Array,   # (nobs,) obs coords [m]
    obs_vert: jax.Array,        # (nobs,) ln p (conventional) or z (radar)
    obs_err: jax.Array,         # (nobs,) obs error stdev
    gp_x: jax.Array, gp_y: jax.Array,     # (B,) gridpoint coords [m]
    gp_vert: jax.Array,         # (B,) gridpoint ln p or z (must match obs_vert kind)
    hori_scale: float,
    vert_scale: float,          # 0 => no vertical localization
    var_local_factor: float = 1.0,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Vectorized obs_local_cal (letkf_tools.f90:1793-1906).

    Returns (ndist2, rloc, rdiag) of shape (B, C); rejected/padded candidates
    get rloc = 0 and rdiag = 1. rdiag is err²/rloc (the rdiag_wloc=True
    convention the reference uses)."""
    valid = cand_idx >= 0
    safe = jnp.maximum(cand_idx, 0)
    # separate scalar gathers here; a packed (·, 4) table gather puts the
    # narrow slice dim minor, which a tiled device layout may pad to the
    # tile width (a large memory blowup at the full-size configs)
    ox = obs_x[safe]
    oy = obs_y[safe]
    ov = obs_vert[safe]
    oe = obs_err[safe]

    nd_h2 = ((gp_x[:, None] - ox) ** 2 + (gp_y[:, None] - oy) ** 2) / (
        hori_scale * hori_scale)
    if vert_scale > 0:
        nd_v = jnp.abs(ov - gp_vert[:, None]) / vert_scale
        nd_v2 = nd_v * nd_v
    else:
        nd_v2 = jnp.zeros_like(nd_h2)
    ndist2 = nd_h2 + nd_v2

    reject = (~valid) | (nd_h2 > DIST_ZERO_FAC_SQ) | (nd_v2 > DIST_ZERO_FAC_SQ) \
        | (ndist2 > DIST_ZERO_FAC_SQ)
    rloc = jnp.where(reject, 0.0, var_local_factor * gauss_taper(ndist2))
    rdiag = jnp.where(rloc > 0, oe * oe / jnp.maximum(rloc, 1e-300), 1.0)
    return jnp.where(reject, -1.0, ndist2), rloc, rdiag


def limit_obs_topk(
    cand_idx: jax.Array,     # (B, C)
    ndist2: jax.Array,       # (B, C) -1 for rejected
    rloc: jax.Array,         # (B, C) 0 for rejected
    rdiag: jax.Array,        # (B, C)
    max_nobs: int,           # output capacity L; 0/negative not allowed here
    criterion: int = 1,      # 1: nearest 3-D distance, 2: largest rloc,
                             # 3: smallest rdiag (MAX_NOBS_PER_GRID_CRITERION)
    obs_err: jax.Array | None = None,   # (nobs,) — enables the 2-payload
                             # fast path (rloc/rdiag recomputed post-slice)
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Select up to max_nobs obs per gridpoint by the configured criterion
    (reference: QUICKSELECT by distance/weight/variance,
    letkf_tools.f90:1614-1617,1694-1703) via lax.top_k.

    Returns (idx, rloc, rdiag) of shape (B, max_nobs) with -1/0/1 padding.

    With obs_err given, the sort carries only (score, idx) — half the
    data movement of the 4-payload variant (the sort dominates dense-radar
    selection) — and rloc/rdiag are
    recomputed exactly from the sliced score + a small (B, L) err gather:
      criterion 1: score = ndist2  → rloc = taper(score)
      criterion 2: score = -rloc   → rloc = -score
      criterion 3: score = rdiag   → rdiag = score, rloc = err²/rdiag
    """
    bad = rloc <= 0
    if criterion == 2:
        score = jnp.where(bad, jnp.inf, -rloc)
    elif criterion == 3:
        score = jnp.where(bad, jnp.inf, rdiag)
    else:
        score = jnp.where(bad, jnp.inf, ndist2)
    k = min(max_nobs, cand_idx.shape[-1])
    B = cand_idx.shape[0]
    # variadic sort carrying the payloads, then a contiguous slice: the
    # equivalent top_k + take_along_axis adds element-wise gathers; the
    # sort moves the payload rows natively. Ascending by score (best first), bad slots pushed to the
    # end by +inf.
    # The 2-payload path only wins when the sort is wide enough to
    # dominate — at narrow candidate tables the extra (B, L) err gather
    # is launch-bound and costs time (the 48x48x16 fused cycle is on that
    # side of the gate).
    if obs_err is not None and cand_idx.shape[-1] >= 512:
        score_s, idx_s = jax.lax.sort(
            (score, cand_idx), dimension=-1, num_keys=1, is_stable=False)
        score_k = score_s[..., :k]
        idx_k = idx_s[..., :k]
        keep = jnp.isfinite(score_k)
        idx_k = jnp.where(keep, idx_k, -1)
        oe = obs_err[jnp.maximum(idx_k, 0)]
        if criterion == 2:
            rloc_k = jnp.where(keep, -score_k, 0.0)
            rdiag_k = jnp.where(keep, oe * oe / jnp.maximum(-score_k, 1e-30),
                                1.0)
        elif criterion == 3:
            rdiag_k = jnp.where(keep, score_k, 1.0)
            rloc_k = jnp.where(keep,
                               oe * oe / jnp.maximum(score_k, 1e-30), 0.0)
        else:
            rl = gauss_taper(score_k)
            rloc_k = jnp.where(keep, rl, 0.0)
            rdiag_k = jnp.where(keep, oe * oe / jnp.maximum(rl, 1e-30), 1.0)
    else:
        _, idx_s, rloc_s, rdiag_s = jax.lax.sort(
            (score, cand_idx, rloc, rdiag), dimension=-1, num_keys=1,
            is_stable=False)
        idx_k = idx_s[..., :k]
        rloc_k = rloc_s[..., :k]
        rdiag_k = rdiag_s[..., :k]
        keep = rloc_k > 0      # rejected/padded candidates carry rloc == 0
        idx_k = jnp.where(keep, idx_k, -1)
        rloc_k = jnp.where(keep, rloc_k, 0.0)
        rdiag_k = jnp.where(keep, rdiag_k, 1.0)
    if max_nobs > k:
        pad = max_nobs - k
        idx_k = jnp.concatenate(
            [idx_k, jnp.full((B, pad), -1, idx_k.dtype)], axis=-1)
        rloc_k = jnp.concatenate([rloc_k, jnp.zeros((B, pad), rloc_k.dtype)],
                                 axis=-1)
        rdiag_k = jnp.concatenate([rdiag_k, jnp.ones((B, pad), rdiag_k.dtype)],
                                  axis=-1)
    return idx_k, rloc_k, rdiag_k


def pack_obs_table(dep: jax.Array, ensval_pert: jax.Array) -> jax.Array:
    """Pack the (dep | hdxb) obs table into bf16 PAIRS bitcast as float32:
    halving the element count halves the bytes and the elements of the
    dominant per-level gather. hdxb at bf16 carries ~0.4% of the
    H(x)-perturbation magnitude — the same transport precision the tiled
    executors already use for state perturbations (da/letkf_tiled.py).

    Returns (ceil((1+K)/2), nobs) float32 (bitcast bf16 pairs). The pair
    axis LEADS so the per-level gather's minor dimension is the (large)
    selection axis — a (B·L, P/2) layout would lane-pad P/2 → 128, a ~5x
    HBM blowup that OOMs the 18-km tile program."""
    K = ensval_pert.shape[-1]
    tab = jnp.concatenate([dep[:, None], ensval_pert],
                          axis=1).astype(jnp.bfloat16)
    if (1 + K) % 2:
        tab = jnp.pad(tab, ((0, 0), (0, 1)))
    n, p = tab.shape
    packed = jax.lax.bitcast_convert_type(
        tab.reshape(n, p // 2, 2), jnp.float32)    # (nobs, P/2)
    return packed.T                                # (P/2, nobs)


def gather_obs_data_packed(
    idx: jax.Array,          # (B, L) selected obs ids, -1 pad
    packed: jax.Array,       # (P/2, nobs) float32 from pack_obs_table
    K: int,
) -> tuple[jax.Array, jax.Array]:
    """gather_obs_data over the bf16-packed table: ONE row gather of half
    the elements, then bitcast/unpack. Returns (dep (B,L), hdxb (B,L,K))
    in float32 with zero padding."""
    if packed.shape[-1] == 0:
        return (jnp.zeros(idx.shape, jnp.float32),
                jnp.zeros(idx.shape + (K,), jnp.float32))
    valid = (idx >= 0)[..., None]
    safe = jnp.maximum(idx, 0)
    rows = packed[:, safe]                         # (P/2, B, L)
    un = jax.lax.bitcast_convert_type(rows, jnp.bfloat16)  # (P/2, B, L, 2)
    # pair c holds table entries (2c, 2c+1): (P/2, B, L, 2) → (B, L, P)
    un = jnp.moveaxis(un, 0, 2)                    # (B, L, P/2, 2)
    un = un.reshape(un.shape[:2] + (2 * rows.shape[0],))
    d = jnp.where(valid[..., 0], un[..., 0].astype(jnp.float32), 0.0)
    h = jnp.where(valid, un[..., 1:1 + K].astype(jnp.float32), 0.0)
    return d, h


def gather_obs_data(
    idx: jax.Array,          # (B, L) selected obs ids, -1 pad
    dep: jax.Array,          # (nobs,) departures
    ensval_pert: jax.Array,  # (nobs, K) ensemble H(x) perturbations
) -> tuple[jax.Array, jax.Array]:
    """Gather (dep, hdxb) for the selected obs; padded slots get zeros
    (harmless because their rloc is 0 — see letkf_core padding contract).

    dep rides along as an extra row of the hdxb table so the whole pull is
    ONE gather instead of a second, separate scalar gather from the 1-D dep
    vector. The member axis leads in the gather
    ((1+K, B, L)) so the large L dim stays minor; gathering (B, L, 1+K)
    directly would put the narrow 1+K dim minor."""
    K = ensval_pert.shape[-1]
    if ensval_pert.shape[0] == 0:
        # zero-obs analysis (reference common_letkf.f90:89 zero-obs
        # branch): every slot is padding
        return (jnp.zeros(idx.shape, dep.dtype),
                jnp.zeros(idx.shape + (K,), ensval_pert.dtype))
    valid = (idx >= 0)[..., None]
    safe = jnp.maximum(idx, 0)
    table = jnp.concatenate([dep[None, :], ensval_pert.T], axis=0)
    rows = table[:, safe]                     # (1+K, B, L)
    d = jnp.where(valid[..., 0], rows[0], 0.0)
    h = jnp.where(valid, jnp.moveaxis(rows[1:], 0, -1), 0.0)
    return d, h
