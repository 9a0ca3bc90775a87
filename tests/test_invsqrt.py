"""Newton–Schulz inverse-sqrt backends: accuracy vs eigh, letkf_core 'ns'
backend parity vs the 'lax' eigendecomposition path (SURVEY.md §4a), and
the fused Pallas kernel (interpreted here; compiled on the GPU)."""

import numpy as np
import jax.numpy as jnp
import pytest

from scale_letkf_tpu.ops.invsqrt import (
    fused_width, invsqrt_newton_schulz, invsqrt_ns_fused)
from scale_letkf_tpu.ops.letkf_core import letkf_core


def _spd_batch(rng, B, K, scale):
    h = rng.standard_normal((B, 40, K))
    s = np.einsum("blk,blj->bkj", h, h) * (scale / 40)
    return s + (K - 1) * np.eye(K)


def test_invsqrt_matches_eigh():
    rng = np.random.default_rng(0)
    for K, scale in [(7, 5.0), (50, 200.0), (100, 1000.0)]:
        c = _spd_batch(rng, 8, K, scale)
        isq, inv = invsqrt_newton_schulz(jnp.asarray(c))
        w, v = np.linalg.eigh(c)
        isq_ref = np.einsum("bik,bk,bjk->bij", v, 1.0 / np.sqrt(w), v)
        inv_ref = np.einsum("bik,bk,bjk->bij", v, 1.0 / w, v)
        np.testing.assert_allclose(np.asarray(isq), isq_ref,
                                   atol=1e-8 * scale)
        np.testing.assert_allclose(np.asarray(inv), inv_ref,
                                   atol=1e-8)


def test_invsqrt_identity_exact():
    # zero-obs LETKF case: C = s·I must give exactly s^{-1/2}·I, s^{-1}·I
    K = 12
    s = 11.0 / 1.25
    c = jnp.broadcast_to(s * jnp.eye(K), (4, K, K))
    isq, inv = invsqrt_newton_schulz(c)
    np.testing.assert_allclose(np.asarray(isq),
                               np.broadcast_to(np.eye(K) / np.sqrt(s),
                                               (4, K, K)), atol=1e-12)
    np.testing.assert_allclose(np.asarray(inv),
                               np.broadcast_to(np.eye(K) / s, (4, K, K)),
                               atol=1e-12)


def _letkf_gram(rng, B, K, cond):
    """LETKF-shaped Grams: rank-30 HᵀH plus the inflation shift (K-1)·I,
    scaled to condition number `cond`. Returns (C, shift)."""
    h = rng.standard_normal((B, 30, K))
    s = np.einsum("blk,blj->bkj", h, h)
    lmax = np.linalg.eigvalsh(s)[:, -1]
    s *= ((cond - 1.0) * (K - 1) / lmax)[:, None, None]
    return s + (K - 1) * np.eye(K), np.full(B, K - 1.0)


def _eigh_isq_inv(c):
    w, v = np.linalg.eigh(c)
    return (np.einsum("...ik,...k,...jk->...ij", v, 1.0 / np.sqrt(w), v),
            np.einsum("...ik,...k,...jk->...ij", v, 1.0 / w, v))


def _check_fused(c, shift, interpret, cond):
    isq, inv = invsqrt_ns_fused(jnp.asarray(c, jnp.float32),
                                jnp.asarray(shift, jnp.float32),
                                interpret=interpret)
    isq_ref, inv_ref = _eigh_isq_inv(c)
    # float32 inverse square root: ~cond·eps32 relative error
    tol = 50.0 * cond * 6e-8
    for got, ref in ((isq, isq_ref), (inv, inv_ref)):
        got = np.asarray(got, np.float64)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("K", [8, 15, 50, 64])
def test_ns_fused_interpret_matches_eigh(K):
    """The fused kernel's arithmetic (Pallas interpreter) against float64
    eigh at ensemble sizes it serves; K pads to 16/16/64/64."""
    c, shift = _letkf_gram(np.random.default_rng(K), 3, K, 1e3)
    _check_fused(c, shift, interpret=True, cond=1e3)


def test_ns_fused_refuses_wider_than_64():
    """K=100 pads to 128, whose dot operands overflow a block's shared
    memory on the H100: a named error, before any compile."""
    c, shift = _letkf_gram(np.random.default_rng(100), 2, 100, 1e2)
    with pytest.raises(ValueError, match="K <= 64"):
        invsqrt_ns_fused(jnp.asarray(c, jnp.float32),
                         jnp.asarray(shift, jnp.float32), interpret=True)


def test_ns_fused_interpret_batch_shapes():
    """Leading batch dims of any shape (here 2x3, one program per matrix)
    and a zero-obs Gram (s·I) that must come back exact."""
    rng = np.random.default_rng(1)
    c, shift = _letkf_gram(rng, 6, 20, 1e2)
    c[2] = 19.0 * np.eye(20)
    c = c.reshape(2, 3, 20, 20)
    shift = shift.reshape(2, 3)
    _check_fused(c, shift, interpret=True, cond=1e2)
    isq, _ = invsqrt_ns_fused(jnp.asarray(c, jnp.float32),
                              jnp.asarray(shift, jnp.float32),
                              interpret=True)
    np.testing.assert_allclose(np.asarray(isq)[0, 2],
                               np.eye(20) / np.sqrt(19.0), rtol=1e-6,
                               atol=1e-7)


def test_fused_width():
    assert [fused_width(k) for k in (3, 8, 16, 17, 50, 64, 100, 128)] == \
        [16, 16, 16, 32, 64, 64, 128, 128]


def test_ns_fused_rejects_float64():
    with pytest.raises(ValueError, match="float32"):
        invsqrt_ns_fused(jnp.eye(4, dtype=jnp.float64)[None],
                         jnp.ones(1, jnp.float64), interpret=True)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [15, 20, 50, 64])
def test_ns_fused_compiled_matches_eigh(K):
    """The kernel as Triton compiles it for the card (TF32x3 bulk phase)
    against float64 eigh, cond 1e2..1e4."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("compiles a Triton kernel: needs a GPU")
    rng = np.random.default_rng(K)
    for cond in (1e2, 1e3, 1e4):
        c, shift = _letkf_gram(rng, 64, K, cond)
        _check_fused(c, shift, interpret=False, cond=cond)


def test_letkf_core_ns_matches_lax():
    rng = np.random.default_rng(2)
    B, L, K = 16, 30, 20
    hdxb = rng.standard_normal((B, L, K))
    rdiag = rng.uniform(0.5, 2.0, (B, L))
    rloc = rng.uniform(0.0, 1.0, (B, L))
    rloc[:, 20:] = 0.0          # padded slots
    dep = rng.standard_normal((B, L))
    infl = np.full(B, 1.1)
    args = (jnp.asarray(hdxb), jnp.asarray(rdiag), jnp.asarray(rloc),
            jnp.asarray(dep), jnp.asarray(infl))
    r_lax = letkf_core(*args, infl_update=True, eigh_impl="lax")
    r_ns = letkf_core(*args, infl_update=True, eigh_impl="ns")
    np.testing.assert_allclose(np.asarray(r_ns.trans),
                               np.asarray(r_lax.trans), atol=1e-8)
    np.testing.assert_allclose(np.asarray(r_ns.transm),
                               np.asarray(r_lax.transm), atol=1e-8)
    np.testing.assert_allclose(np.asarray(r_ns.pao),
                               np.asarray(r_lax.pao), atol=1e-8)
    np.testing.assert_allclose(np.asarray(r_ns.infl),
                               np.asarray(r_lax.infl), atol=1e-9)
