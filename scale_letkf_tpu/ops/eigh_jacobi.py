"""Batched symmetric eigensolver via parallel cyclic Jacobi.

Alternative backend to jnp.linalg.eigh for the LETKF's batched K×K
eigendecompositions (reference: the per-point EISPACK `rs` call,
common/common_mtx.f90:41).

Role: the row/column elementwise form below is what eigh_impl='auto'
picks at small ensembles (K ≤ 16); its place on the GPU against the
vendor batched eigh is measured by chip_smoke.py phase b (PERF.md). At
larger K 'auto' uses the Newton–Schulz inverse-sqrt path (ops/invsqrt.py), which sidesteps the
eigendecomposition entirely — the LETKF transform needs only C^{-1/2} and
C^{-1}. The matmul Jacobi form is
kept for callers that need actual eigenpairs at K > 64 without LAPACK.

Algorithm: round-robin parallel ordering — each round pairs up all K
indices into K/2 disjoint (p, q) pairs; the K-1 rounds of a sweep touch
every pair once. Per round, the K/2 Givens rotations commute, so they form
one orthogonal matrix J and the update is A ← JᵀAJ, V ← VJ — two batched
matmuls (or, at small K, elementwise row/column combinations).
Convergence: off-diagonal norm decays quadratically; 6-10 sweeps reach
float32 machine precision.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


def _round_robin_schedule(K: int) -> np.ndarray:
    """(K-1, K/2, 2) pairs: the standard round-robin tournament ordering."""
    assert K % 2 == 0, "parallel Jacobi needs even K (pad odd sizes)"
    players = list(range(K))
    rounds = []
    for _ in range(K - 1):
        pairs = [(players[i], players[K - 1 - i]) for i in range(K // 2)]
        rounds.append([(min(p, q), max(p, q)) for p, q in pairs])
        # rotate all but the first
        players = [players[0]] + [players[-1]] + players[1:-1]
    return np.asarray(rounds, np.int32)


def _round_rotation(a: jax.Array, p_idx: jax.Array, q_idx: jax.Array):
    """Build the (..., K, K) orthogonal matrix of K/2 disjoint Givens
    rotations annihilating a[p,q] for each pair."""
    K = a.shape[-1]
    app = a[..., p_idx, p_idx]              # (..., K/2)
    aqq = a[..., q_idx, q_idx]
    apq = a[..., p_idx, q_idx]

    # stable Jacobi rotation angles
    tau = (aqq - app) / (2.0 * jnp.where(jnp.abs(apq) > 0, apq, 1.0))
    t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
    t = jnp.where(jnp.abs(apq) > 0, t, 0.0)
    c = 1.0 / jnp.sqrt(1.0 + t * t)
    s = t * c

    batch = a.shape[:-2]
    eye = jnp.broadcast_to(jnp.eye(K, dtype=a.dtype), batch + (K, K))
    j = eye
    j = j.at[..., p_idx, p_idx].set(c)
    j = j.at[..., q_idx, q_idx].set(c)
    j = j.at[..., p_idx, q_idx].set(s)
    j = j.at[..., q_idx, p_idx].set(-s)
    return j


def _angles(a, p_idx, q_idx):
    """Stable Jacobi rotation (c, s) per pair, from the current A."""
    app = a[..., p_idx, p_idx]
    aqq = a[..., q_idx, q_idx]
    apq = a[..., p_idx, q_idx]
    tau = (aqq - app) / (2.0 * jnp.where(jnp.abs(apq) > 0, apq, 1.0))
    t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
    t = jnp.where(jnp.abs(apq) > 0, t, 0.0)
    c = 1.0 / jnp.sqrt(1.0 + t * t)
    return c, t * c


@partial(jax.jit, static_argnames=("sweeps",))
def _eigh_jacobi_rowcol(a: jax.Array, sweeps: int = 8):
    """Row/column-update formulation: each round applies its K/2 disjoint
    Givens rotations as elementwise row and column combinations instead of
    K×K matmuls. O(K²) work per round instead of O(K³), all of it
    elementwise — at small K (the common ensemble sizes) a matrix unit
    would be almost idle on 8×8 operands."""
    K = a.shape[-1]
    sched = _round_robin_schedule(K)           # (K-1, K/2, 2)
    batch = a.shape[:-2]
    v = jnp.broadcast_to(jnp.eye(K, dtype=a.dtype), batch + (K, K))

    def one_sweep(carry, _):
        a, v = carry
        for r in range(K - 1):                 # static unroll: constant indices
            p_idx, q_idx = sched[r, :, 0], sched[r, :, 1]
            c, s = _angles(a, p_idx, q_idx)
            cr, sr = c[..., None], s[..., None]
            # A ← JᵀA (rows), then ·J (columns); V ← V·J (columns)
            ap, aq = a[..., p_idx, :], a[..., q_idx, :]
            a = a.at[..., p_idx, :].set(cr * ap - sr * aq)
            a = a.at[..., q_idx, :].set(sr * ap + cr * aq)
            cc, sc = c[..., None, :], s[..., None, :]
            ap, aq = a[..., :, p_idx], a[..., :, q_idx]
            a = a.at[..., :, p_idx].set(cc * ap - sc * aq)
            a = a.at[..., :, q_idx].set(sc * ap + cc * aq)
            vp, vq = v[..., :, p_idx], v[..., :, q_idx]
            v = v.at[..., :, p_idx].set(cc * vp - sc * vq)
            v = v.at[..., :, q_idx].set(sc * vp + cc * vq)
        a = 0.5 * (a + jnp.swapaxes(a, -1, -2))
        return (a, v), None

    (a_f, v_f), _ = jax.lax.scan(one_sweep, (a, v), None, length=sweeps)
    w = jnp.diagonal(a_f, axis1=-2, axis2=-1)
    order = jnp.argsort(w, axis=-1)
    w_sorted = jnp.take_along_axis(w, order, axis=-1)
    v_sorted = jnp.take_along_axis(v_f, order[..., None, :], axis=-1)
    return w_sorted, v_sorted


# Below this size the row/col form (elementwise) is used; above it the
# matmul form's fewer, larger products.
_ROWCOL_MAX_K = 64


@partial(jax.jit, static_argnames=("sweeps",))
def eigh_jacobi(a: jax.Array, sweeps: int = 8):
    """Batched symmetric eigendecomposition. a: (..., K, K) symmetric.

    Returns (eigenvalues ascending (..., K), eigenvectors (..., K, K)) with
    A = V diag(w) Vᵀ (columns are eigenvectors), matching jnp.linalg.eigh.
    Dispatches between the row/col-update form (small K) and the batched
    matmul form (large K).
    """
    K = a.shape[-1]
    if K <= _ROWCOL_MAX_K:
        return _eigh_jacobi_rowcol(a, sweeps=sweeps)
    sched = _round_robin_schedule(K)           # (K-1, K/2, 2)
    sched_j = jnp.asarray(sched)
    batch = a.shape[:-2]
    v0 = jnp.broadcast_to(jnp.eye(K, dtype=a.dtype), batch + (K, K))

    # The rotation products MUST run at full float32 precision: reduced
    # precision products (bf16, TF32) put a floor on the eigenvector
    # accuracy that no sweep count removes.
    mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

    def one_round(carry, pairs):
        a_c, v_c = carry
        j = _round_rotation(a_c, pairs[:, 0], pairs[:, 1])
        a_n = mm(mm(jnp.swapaxes(j, -1, -2), a_c), j)
        # re-symmetrize to keep float roundoff from accumulating
        a_n = 0.5 * (a_n + jnp.swapaxes(a_n, -1, -2))
        v_n = mm(v_c, j)
        return (a_n, v_n), None

    def one_sweep(carry, _):
        carry, _ = jax.lax.scan(one_round, carry, sched_j)
        return carry, None

    (a_f, v_f), _ = jax.lax.scan(one_sweep, (a, v0), None, length=sweeps)
    w = jnp.diagonal(a_f, axis1=-2, axis2=-1)
    order = jnp.argsort(w, axis=-1)
    w_sorted = jnp.take_along_axis(w, order, axis=-1)
    v_sorted = jnp.take_along_axis(
        v_f, order[..., None, :], axis=-1)
    return w_sorted, v_sorted
