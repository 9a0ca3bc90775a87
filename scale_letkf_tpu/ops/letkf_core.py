"""Batched LETKF ensemble-transform core (Hunt et al. 2007).

Batched re-design of the per-point transform the reference computes one
gridpoint at a time (reference: common/common_letkf.f90:52-257, using
dgemm + EISPACK `rs` via common/common_mtx.f90:41). Here the whole batch of
gridpoints is processed at once: every step is a batched einsum or a
batched symmetric inverse square root, so XLA can hand the K×K
ensemble-space algebra to batched matrix kernels and fuse the elementwise
pieces.

Padding convention (replaces the reference's variable `nobsl`): each batch
row carries a fixed-capacity obs dimension L; unused slots MUST have
rloc == 0 (and finite rdiag > 0, e.g. 1). Because every observation enters
the algebra only through hdxb^T R^{-1}·rloc or dep²/r·rloc terms, rloc == 0
slots contribute exactly zero, reproducing the reference semantics for any
nobsl <= L, including nobsl == 0: with no obs the shifted Gram matrix is
((K-1)/ρ)·I whose transform is sqrt(ρ)·I — identical to the reference's
explicit zero-obs branch (common_letkf.f90:89-107).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

# Error stdev of the inflation parameter in the adaptive-inflation Kalman
# filter (Miyoshi 2011). Matches the reference constant sigma_b
# (common_letkf.f90:79).
SIGMA_B_INFL = 0.04


# Backends of the batched K×K solve:
#   'lax'      jnp.linalg.eigh (the vendor solver on the GPU)
#   'jacobi'   parallel cyclic Jacobi (ops/eigh_jacobi.py), elementwise at
#              small K
#   'ns'       matmul-only coupled Newton–Schulz (ops/invsqrt.py, XLA)
#   'ns_fused' the same iteration as one fused Pallas kernel through
#              Triton (ops/invsqrt.py; GPU, float32)
#   'auto'     resolve_eigh_impl()
EIGH_IMPLS = ("auto", "lax", "jacobi", "ns", "ns_fused")


def resolve_eigh_impl(eigh_impl: str, K: int, dtype,
                      sharded: bool = False) -> str:
    """The backend 'auto' stands for at ensemble size K and compute dtype:
    Jacobi for small even K; on the GPU at float32 the fused kernel for
    every K it serves; else matmul-only Newton–Schulz.

    sharded=True: the batch is split over a device mesh inside a GSPMD
    program. The fused kernel is a custom call without a partitioning
    rule, so the partitioner would gather the whole batch onto every
    device; 'auto' then keeps to 'ns', whose batched products partition."""
    from scale_letkf_tpu.ops.invsqrt import FUSED_MAX_WIDTH, fused_width
    if eigh_impl not in EIGH_IMPLS:
        raise ValueError(f"unknown eigh_impl {eigh_impl!r} "
                         f"(valid: {', '.join(EIGH_IMPLS)})")
    if eigh_impl != "auto":
        return eigh_impl
    if K <= 16 and K % 2 == 0:
        return "jacobi"
    if (not sharded and fused_width(K) <= FUSED_MAX_WIDTH
            and jnp.dtype(dtype) == jnp.float32
            and jax.default_backend() == "gpu"):
        return "ns_fused"
    return "ns"


class LetkfResult(NamedTuple):
    trans: jax.Array       # (..., K, K) perturbation transform W
    transm: jax.Array      # (..., K)    mean-update weight w̄
    pao: jax.Array         # (..., K, K) analysis covariance in ensemble space
    infl: jax.Array        # (...,)      updated inflation parameter
    transmd: jax.Array     # (..., K)    deterministic-member weight (zeros if unused)


def letkf_core(
    hdxb: jax.Array,          # (..., L, K) ensemble H(x) perturbations
    rdiag: jax.Array,         # (..., L)    obs error variances
    rloc: jax.Array,          # (..., L)    localization weights (0 = padded/unused)
    dep: jax.Array,           # (..., L)    departures y - H(x̄)
    parm_infl: jax.Array,     # (...,)      multiplicative inflation parameter
    *,
    rdiag_wloc: bool = False, # if True, rdiag already includes /rloc (common_letkf.f90:111)
    infl_update: bool = False,
    depd: jax.Array | None = None,  # (..., L) deterministic-member departures
    min_infl: float = 0.0,
    eigh_impl: str = "auto",  # see EIGH_IMPLS
) -> LetkfResult:
    """Compute the LETKF transform for a batch of local analysis problems.

    All leading dimensions are batch dimensions. Compute dtype follows the
    inputs (float32 on the accelerator; float64 under x64 for parity tests).
    """
    K = hdxb.shape[-1]
    dtype = hdxb.dtype
    km1 = jnp.asarray(K - 1, dtype)

    # R^{-1}·rloc weighting of ensemble obs perturbations
    # (common_letkf.f90:111-123)
    if rdiag_wloc:
        w_r = 1.0 / rdiag
    else:
        w_r = rloc / rdiag
    hdxb_rinv = hdxb * w_r[..., None]

    # Gram matrix C = hdxb^T R^{-1} hdxb + (K-1)/ρ I  (common_letkf.f90:127-143)
    gram = jnp.einsum("...lk,...lj->...kj", hdxb_rinv, hdxb,
                      preferred_element_type=dtype,
                      precision=jax.lax.Precision.HIGHEST)
    shift = km1 / parm_infl[..., None]
    gram = gram + shift[..., None] * jnp.eye(K, dtype=dtype)

    eigh_impl = resolve_eigh_impl(eigh_impl, K, dtype)
    if eigh_impl == "ns_fused":
        # Fused Newton–Schulz kernel (ops/invsqrt.py): the whole iteration
        # in one Pallas program. The phase-1 eigenvalue floor uses the EXACT
        # bound λ_min(gram) ≥ (K-1)/ρ — the inflation shift added above.
        from scale_letkf_tpu.ops.invsqrt import invsqrt_ns_fused
        inv_sqrt, pao = invsqrt_ns_fused(gram, shift[..., 0])
        trans = jnp.sqrt(km1) * inv_sqrt
    elif eigh_impl == "ns":
        # Matmul-only path: the transform needs only C^{-1} (= Pa) and
        # C^{-1/2} (= W/√(K-1)), never the eigenpairs — coupled
        # Newton–Schulz computes both with batched matmuls (ops/invsqrt.py).
        from scale_letkf_tpu.ops.invsqrt import invsqrt_newton_schulz
        inv_sqrt, pao = invsqrt_newton_schulz(gram)
        trans = jnp.sqrt(km1) * inv_sqrt
    else:
        # Symmetric eigendecomposition (batched; replaces EISPACK rs/point)
        if eigh_impl == "jacobi":
            from scale_letkf_tpu.ops.eigh_jacobi import eigh_jacobi
            eival, eivec = eigh_jacobi(gram)
        else:
            eival, eivec = jnp.linalg.eigh(gram)

        # Pa = V Λ^{-1} V^T   (common_letkf.f90:151-157)
        v_over_l = eivec / eival[..., None, :]
        pao = jnp.einsum("...ik,...jk->...ij", v_over_l, eivec,
                         preferred_element_type=dtype,
                         precision=jax.lax.Precision.HIGHEST)

        # Sqrt transform W = V sqrt((K-1) Λ^{-1}) V^T (common_letkf.f90:199)
        v_sqrt = eivec * jnp.sqrt(km1 / eival)[..., None, :]
        trans = jnp.einsum("...ik,...jk->...ij", v_sqrt, eivec,
                           preferred_element_type=dtype,
                           precision=jax.lax.Precision.HIGHEST)

    # Mean weight w̄ = Pa (HδX)^T R^{-1} d   (common_letkf.f90:169-187)
    # Contract obs dimension first: t = hdxb_rinv^T dep is (..., K), then Pa t.
    t = jnp.einsum("...lk,...l->...k", hdxb_rinv, dep,
                   preferred_element_type=dtype,
                      precision=jax.lax.Precision.HIGHEST)
    transm = jnp.einsum("...ij,...j->...i", pao, t,
                        preferred_element_type=dtype,
                      precision=jax.lax.Precision.HIGHEST)

    if depd is not None:
        td = jnp.einsum("...lk,...l->...k", hdxb_rinv, depd,
                        preferred_element_type=dtype,
                      precision=jax.lax.Precision.HIGHEST)
        transmd = jnp.einsum("...ij,...j->...i", pao, td,
                             preferred_element_type=dtype,
                      precision=jax.lax.Precision.HIGHEST)
    else:
        transmd = jnp.zeros_like(transm)

    # Adaptive multiplicative inflation estimate (Miyoshi 2011 innovation
    # statistics with a scalar KF; common_letkf.f90:233-254). Guarded for the
    # zero-obs case, where the reference leaves parm_infl untouched.
    if infl_update:
        if rdiag_wloc:
            p1 = jnp.sum(dep * dep / rdiag, axis=-1)
        else:
            p1 = jnp.sum(dep * dep / rdiag * rloc, axis=-1)
        p2 = jnp.sum(hdxb_rinv * hdxb, axis=(-2, -1)) / km1
        p3 = jnp.sum(rloc, axis=-1)
        has_obs = p3 > 0
        p2s = jnp.where(has_obs, p2, 1.0)
        p3s = jnp.where(has_obs, p3, 1.0)
        p4 = (p1 - p3s) / p2s - parm_infl
        sigma_o = 2.0 / p3s * ((parm_infl * p2s + p3s) / p2s) ** 2
        gain = SIGMA_B_INFL**2 / (sigma_o + SIGMA_B_INFL**2)
        new_infl = parm_infl + gain * p4
        if min_infl > 0:
            new_infl = jnp.maximum(new_infl, min_infl)
        infl_out = jnp.where(has_obs, new_infl, parm_infl)
    else:
        infl_out = parm_infl

    return LetkfResult(trans=trans, transm=transm, pao=pao, infl=infl_out,
                       transmd=transmd)


def total_weight(
    trans_rlx: jax.Array,  # (..., K, K) (possibly relaxed) perturbation transform
    transm: jax.Array,     # (..., K)    mean weight
    beta: jax.Array,       # (...,)      boundary/radar-top damping factor in [0,1]
) -> jax.Array:
    """Total weight W' = (W_rlx + 1 w̄^T)·β + (1-β)·I
    (reference: letkf_tools.f90:472-477)."""
    K = trans_rlx.shape[-1]
    b = beta[..., None, None]
    # w̄ is added along the ensemble-perturbation (row) index k, the same for
    # every analysis member column m.
    w = (trans_rlx + transm[..., :, None]) * b
    return w + (1.0 - b) * jnp.eye(K, dtype=trans_rlx.dtype)


def apply_weights(
    pert: jax.Array,       # (..., K) forecast perturbations (ensemble last axis)
    mean: jax.Array,       # (...)    forecast mean
    w_total: jax.Array,    # (..., K, K) total weight from total_weight()
) -> jax.Array:
    """Analysis ensemble  xa_m = x̄ + Σ_k Xb'_k W'_{km}  (letkf_tools.f90:480-487)."""
    upd = jnp.einsum("...k,...km->...m", pert, w_total,
                     preferred_element_type=pert.dtype,
                     precision=jax.lax.Precision.HIGHEST)
    return mean[..., None] + upd


def weight_rtpp(trans: jax.Array, infl: jax.Array, alpha: float) -> jax.Array:
    """Relaxation-to-prior-perturbation, Zhang et al. 2004
    (reference: letkf_tools.f90:1953-1968): W ← (1-α)·W + α·√infl·I."""
    K = trans.shape[-1]
    diag = alpha * jnp.sqrt(infl)
    return (1.0 - alpha) * trans + diag[..., None, None] * jnp.eye(K, dtype=trans.dtype)


def weight_rtps(
    trans: jax.Array,      # (..., K, K)
    pao: jax.Array,        # (..., K, K)
    xb: jax.Array,         # (..., K) forecast perturbations of ONE variable at the point
    infl: jax.Array,       # (...,)   multiplicative inflation at the point
    alpha: float,
) -> tuple[jax.Array, jax.Array]:
    """Relaxation-to-prior-spread, Whitaker & Hamill 2012
    (reference: letkf_tools.f90:1971-2004).

    m = α·sqrt(var_g·infl / (var_a·(K-1))) - α + 1, with
    var_g = Σ_k xb_k², var_a = xb^T Pao xb; W ← W·m. When either variance is
    non-positive the reference leaves W unchanged and reports m = 1.
    Returns (W_scaled, m).
    """
    K = trans.shape[-1]
    var_g = jnp.sum(xb * xb, axis=-1)
    pa_xb = jnp.einsum("...ij,...j->...i", pao, xb,
                       preferred_element_type=xb.dtype,
                       precision=jax.lax.Precision.HIGHEST)
    var_a = jnp.sum(xb * pa_xb, axis=-1)
    safe = (var_g > 0) & (var_a > 0)
    ratio = var_g * infl / (jnp.where(safe, var_a, 1.0) * (K - 1))
    m = jnp.where(safe, alpha * jnp.sqrt(ratio) - alpha + 1.0, 1.0)
    return trans * m[..., None, None], m


def relax_beta(
    dist_to_boundary: jax.Array,  # (...,) distance to nearest lateral boundary [m]
    z: jax.Array,                 # (...,) gridpoint height [m]
    *,
    buffer_width: float = 0.0,
    radar_only: bool = False,
    radar_zmax: float = 99.0e3,
    vert_cutoff: float = 0.0,     # max radar vertical loc scale × dist_zero_fac [m]
) -> jax.Array:
    """Damping factor β for lateral-boundary buffer and radar-top capping
    (reference: letkf_tools.f90:1911-1948)."""
    beta = jnp.ones_like(z)
    if buffer_width > 0.0:
        frac = dist_to_boundary / buffer_width
        beta = jnp.clip(frac, 0.0, 1.0)
    if radar_only:
        beta = jnp.where(z > radar_zmax + vert_cutoff, 0.0, beta)
    return beta


# jit-compiled convenience wrapper with static flags
letkf_core_jit = jax.jit(
    partial(letkf_core),
    static_argnames=("rdiag_wloc", "infl_update", "min_infl", "eigh_impl"),
)
