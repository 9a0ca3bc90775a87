"""Batched SPD inverse square root via coupled Newton–Schulz iteration.

Matmul-only replacement for the eigendecomposition inside the LETKF
transform. The reference diagonalizes the K×K ensemble-space Gram matrix
per gridpoint (EISPACK `rs`, common/common_mtx.f90:41) and then forms
  Pa   = V Λ⁻¹ Vᵀ        = C⁻¹
  W    = V √((K-1)Λ⁻¹) Vᵀ = √(K-1) · C^{-1/2}
(common/common_letkf.f90:151-206) — i.e. the algorithm never needs the
eigenpairs themselves, only the inverse and the inverse square root of an
SPD matrix. A batched eigendecomposition is a sequence of small dependent
sweeps, while the inverse square root has a classic matmul-only
algorithm: the coupled Newton–Schulz iteration (Higham, "Functions of
Matrices", §6.3; stable, unlike uncoupled Newton):

  A = C / c                      (c ≥ λ_max : Gershgorin row-sum bound)
  Y₀ = A, Z₀ = I
  T_k = (3I − Z_k Y_k)/2 ;  Y_{k+1} = Y_k T_k ;  Z_{k+1} = T_k Z_k
  Y_k → A^{1/2},  Z_k → A^{-1/2}

Every step is three batched K×K matmuls. Convergence: with eigenvalues of
A in (0, 1], the scalar error map is p ← p(3−p)²/4 (p = z·y eigenvalue
product), which grows small p by ×2.25 per step and then converges
quadratically near 1, so the sweep count is ~log(cond)/log(2.25) + 5. The
LETKF Gram matrix C = HδXᵀR⁻¹HδX + (K-1)/ρ·I has
cond ≈ 1 + ρ/(K-1)·λ_max(S) ~ Σ_l ρ_loc(spread/err)² — a few hundred even
for dense radar volumes — so the default 22 iterations reach float32
accuracy with large margin (validated against jnp.linalg.eigh in
tests/test_invsqrt.py).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("iters",))
def invsqrt_newton_schulz(c_mat: jax.Array, iters: int = 22):
    """Batched inverse square root + inverse of an SPD matrix.

    Args:
      c_mat: (..., K, K) symmetric positive definite.
      iters: Newton–Schulz sweeps (static). 22 covers cond ≲ 1e5 at float32.

    Returns:
      (inv_sqrt, inv): (..., K, K) arrays with inv_sqrt ≈ C^{-1/2} and
      inv ≈ C^{-1} (both symmetric).
    """
    K = c_mat.shape[-1]
    dtype = c_mat.dtype
    # Gershgorin upper bound on λ_max; also bounds the spectrum into (0, 1]
    # after normalization. For SPD matrices max row-sum ≥ λ_max.
    c = jnp.max(jnp.sum(jnp.abs(c_mat), axis=-1), axis=-1)
    c = jnp.maximum(c, jnp.finfo(dtype).tiny)
    a = c_mat / c[..., None, None]

    eye = jnp.eye(K, dtype=dtype)
    mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST,
                 preferred_element_type=dtype)

    def body(i, carry):
        y, z = carry
        t = 1.5 * eye - 0.5 * mm(z, y)
        return mm(y, t), mm(t, z)

    y0 = a
    z0 = jnp.broadcast_to(eye, a.shape)
    _, z = jax.lax.fori_loop(0, iters, body, (y0, z0))

    # un-normalize: C^{-1/2} = A^{-1/2}/√c ; C^{-1} = A^{-1}/c
    rsqrt_c = jax.lax.rsqrt(c)[..., None, None]
    inv_sqrt = z * rsqrt_c
    inv_sqrt = 0.5 * (inv_sqrt + jnp.swapaxes(inv_sqrt, -1, -2))
    inv = mm(inv_sqrt, inv_sqrt)
    inv = 0.5 * (inv + jnp.swapaxes(inv, -1, -2))
    return inv_sqrt, inv


# ---------------------------------------------------------------------------
# Fused kernel (Pallas through Triton): the whole iteration on chip
# ---------------------------------------------------------------------------
#
# The XLA path above launches three batched K×K products per iteration,
# each reading Y/Z/T from device memory and writing its result back: at
# K=50, B=4096 one batch of matrices is 41 MB, so 22 iterations move about
# 8 GB. The fused kernel runs one matrix per program and keeps Y, Z and T
# on chip for the whole iteration (a 64×64 f32 triple is 48 KB), so device
# memory sees one read of the inputs and one write of each output.
#
# Numerics:
#   phase 1: TF32x3 products (three TF32 tensor-core passes, ≈ f32) on a
#            REGULARIZED matrix whose spectrum is floored at EIG_FLOOR of
#            λ_max, which makes the phase unconditionally convergent at
#            that precision. The floor uses the EXACT lower bound
#            λ_min(C) ≥ (K-1)/ρ (the inflation shift:
#            C = HδXᵀR⁻¹HδX·rloc + (K-1)/ρ·I with the first term PSD), so
#            well-conditioned matrices (cond ≤ 1/EIG_FLOOR) are untouched.
#   phase 2: re-anchor the coupled invariant Y = A·Z (exact by
#            construction) on the TRUE matrix and polish with IEEE f32
#            iterations.

EIG_FLOOR = 1e-4       # phase-1 spectrum floor (fraction of λ_max bound)


def _ns_fused_kernel(a_ref, areg_ref, isq_ref, inv_ref, *, it_lo, it_hi,
                     bulk, polish):
    a = a_ref[...]
    areg = areg_ref[...]
    kp = a.shape[-1]
    ii = jax.lax.broadcasted_iota(jnp.int32, (kp, kp), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (kp, kp), 1)
    eye = (ii == jj).astype(a.dtype)

    def dot(x, y, prec):
        return jax.lax.dot(x, y, precision=prec,
                           preferred_element_type=jnp.float32)

    def sweep(prec):
        def body(i, carry):
            y, z = carry
            t = 1.5 * eye - 0.5 * dot(z, y, prec)
            return dot(y, t, prec), dot(t, z, prec)
        return body

    _, z = jax.lax.fori_loop(0, it_lo, sweep(bulk), (areg, eye))
    # re-anchor Y = A·Z on the true matrix, then quadratic polish
    y = dot(a, z, polish)
    _, z = jax.lax.fori_loop(0, it_hi, sweep(polish), (y, z))
    z = 0.5 * (z + z.T)
    isq_ref[...] = z
    inv_ref[...] = dot(z, z, polish)


def _power_bound(c_mat, iters: int = 8):
    """Per-matrix λ_max estimate: power iteration (tight, unlike
    Gershgorin's up-to-K× overestimate) ×1.05, FLOORED at Gershgorin/2.9.

    The floor is what makes this safe: NS converges for normalized
    spectrum in (0, 3), and a power start vector near-orthogonal to the
    top eigenvector can underestimate λ_max badly (observed on real radar
    Grams — 16 NaN analysis points at 48x48x16 K=50). Since
    gersh ≥ λ_max always, c ≥ gersh/2.9 guarantees λ_max/c ≤ 2.9 < 3
    regardless of the power estimate."""
    HI = jax.lax.Precision.HIGHEST
    gersh = jnp.max(jnp.sum(jnp.abs(c_mat), axis=-1), axis=-1)
    v = jnp.ones(c_mat.shape[:-1], c_mat.dtype)[..., None]
    for _ in range(iters):
        v = jnp.matmul(c_mat, v, precision=HI)
        v = v / jnp.linalg.norm(v, axis=-2, keepdims=True)
    w = jnp.matmul(c_mat, v, precision=HI)
    power = jnp.linalg.norm(w, axis=(-2, -1))
    return jnp.maximum(1.05 * power, gersh / 2.9)


# Widest padded matrix the kernel serves: Triton stages each dot's operands
# through shared memory, and at width 128 the TF32x3 products ask for
# 320 KB, beyond the 227 KB an H100 block may use (measured on the card).
FUSED_MAX_WIDTH = 64
# Warps per program: at width 64 four warps beat eight (4.994 against
# 5.594 ms for the kernel alone at B=4096 K=50 on an H100 80GB HBM3,
# 700 W); two spill (142.7 ms). To measure again, change this value and
# rerun phase b of chip_smoke.py.
NUM_WARPS = 4


def fused_width(K: int) -> int:
    """Padded matrix width of the fused kernel: the next power of two
    (Triton's block rule), at least 16 (its smallest dot operand)."""
    return max(16, 1 << (int(K) - 1).bit_length())


def invsqrt_ns_fused(
    c_mat: jax.Array,         # (..., K, K) SPD (float32)
    smin: jax.Array,          # (...,) EXACT lower bound on λ_min (the
                              # LETKF inflation shift (K-1)/ρ; pass 0 for
                              # "unknown" — phase 1 then always floors)
    it_lo: int = 18,
    it_hi: int = 2,
    interpret: bool = False,
):
    """Fused batched inverse square root + inverse (Pallas, Triton route).

    Returns (inv_sqrt, inv) like invsqrt_newton_schulz. K is padded to
    fused_width(K) block-diagonally with identity (exact). Leading batch
    dims are flattened; each program solves one matrix.

    interpret=True runs the kernel body in the Pallas interpreter (CPU
    tests). The interpreter's CPU dot offers no TF32x3 product, so phase 1
    then uses the IEEE f32 product that TF32x3 approximates."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pltriton

    *lead, K, _ = c_mat.shape
    dtype = c_mat.dtype
    if dtype != jnp.float32:
        raise ValueError(f"invsqrt_ns_fused is float32-only, got {dtype}")
    B = int(np.prod(lead)) if lead else 1
    c_flat = c_mat.reshape(B, K, K)
    smin_flat = jnp.broadcast_to(jnp.asarray(smin, dtype),
                                 tuple(lead)).reshape(B)

    kp = fused_width(K)
    if kp > FUSED_MAX_WIDTH:
        raise ValueError(f"invsqrt_ns_fused serves K <= {FUSED_MAX_WIDTH}, "
                         f"got K={K}")

    c = jnp.maximum(_power_bound(c_flat), jnp.finfo(dtype).tiny)
    a = c_flat / c[..., None, None]
    m = smin_flat / c
    bump = jnp.maximum(EIG_FLOOR - m, 0.0)
    areg = a + bump[..., None, None] * jnp.eye(K, dtype=dtype)[None]
    if kp > K:
        pad_eye = jnp.pad(jnp.eye(kp - K, dtype=dtype),
                          ((K, 0), (K, 0)))[None]
        a = jnp.pad(a, ((0, 0), (0, kp - K), (0, kp - K))) + pad_eye
        areg = jnp.pad(areg, ((0, 0), (0, kp - K), (0, kp - K))) + pad_eye

    presets = jax.lax.DotAlgorithmPreset
    polish = presets.F32_F32_F32
    bulk = polish if interpret else presets.TF32_TF32_F32_X3
    spec = pl.BlockSpec((None, kp, kp), lambda i: (i, 0, 0))
    isq, inv = pl.pallas_call(
        partial(_ns_fused_kernel, it_lo=it_lo, it_hi=it_hi, bulk=bulk,
                polish=polish),
        grid=(B,),
        in_specs=[spec, spec],
        out_specs=(spec, spec),
        out_shape=(jax.ShapeDtypeStruct((B, kp, kp), dtype),) * 2,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="ns_invsqrt_fused",
    )(a, areg)
    isq = isq[:, :K, :K] * jax.lax.rsqrt(c)[..., None, None]
    inv = inv[:, :K, :K] / c[..., None, None]
    out_shape = tuple(lead) + (K, K)
    return isq.reshape(out_shape), inv.reshape(out_shape)
