"""LETKF core parity tests vs the float64 NumPy oracle (SURVEY.md §4a)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from scale_letkf_tpu.ops.letkf_core import (
    letkf_core, weight_rtpp, weight_rtps, total_weight, apply_weights,
    relax_beta,
)
from oracle_letkf import (
    letkf_core_np, rtpp_np, rtps_np, total_weight_np,
)


def make_problem(rng, B, L, K, frac_empty=0.0, nobsl=None):
    """Random batch of local analysis problems with rloc-zero padding."""
    hdxb = rng.standard_normal((B, L, K))
    hdxb -= hdxb.mean(axis=-1, keepdims=True)  # perturbations sum to ~0
    rdiag = rng.uniform(0.5, 2.0, (B, L))
    rloc = rng.uniform(0.05, 1.0, (B, L))
    dep = rng.standard_normal((B, L))
    infl = rng.uniform(1.0, 1.3, (B,))
    nl = np.full(B, L if nobsl is None else nobsl)
    if frac_empty > 0:
        empty = rng.uniform(size=B) < frac_empty
        nl[empty] = 0
    for b in range(B):
        rloc[b, nl[b]:] = 0.0
        hdxb[b, nl[b]:] = 0.0
        dep[b, nl[b]:] = 0.0
    return hdxb, rdiag, rloc, dep, infl, nl


@pytest.mark.parametrize("K", [4, 8, 20])
def test_matches_oracle_f64(K):
    rng = np.random.default_rng(0)
    B, L = 16, 30
    hdxb, rdiag, rloc, dep, infl, nl = make_problem(rng, B, L, K)
    res = letkf_core(jnp.asarray(hdxb), jnp.asarray(rdiag), jnp.asarray(rloc),
                     jnp.asarray(dep), jnp.asarray(infl), infl_update=True)
    for b in range(B):
        o = letkf_core_np(hdxb[b], rdiag[b], rloc[b], dep[b], infl[b],
                          nobsl=nl[b], infl_update=True)
        np.testing.assert_allclose(res.trans[b], o["trans"], atol=1e-9)
        np.testing.assert_allclose(res.transm[b], o["transm"], atol=1e-9)
        np.testing.assert_allclose(res.pao[b], o["pao"], atol=1e-9)
        np.testing.assert_allclose(res.infl[b], o["infl"], atol=1e-9)


def test_zero_obs_identity():
    """nobsl == 0 must yield W = sqrt(infl)·I, w̄ = 0, Pao = infl/(K-1)·I
    (reference behavior: common_letkf.f90:89-107) — via the padding path."""
    rng = np.random.default_rng(1)
    K, B, L = 8, 4, 12
    hdxb, rdiag, rloc, dep, infl, _ = make_problem(rng, B, L, K, nobsl=0)
    res = letkf_core(jnp.asarray(hdxb), jnp.asarray(rdiag), jnp.asarray(rloc),
                     jnp.asarray(dep), jnp.asarray(infl), infl_update=True)
    for b in range(B):
        np.testing.assert_allclose(res.trans[b], np.sqrt(infl[b]) * np.eye(K),
                                   atol=1e-10)
        np.testing.assert_allclose(res.transm[b], 0.0, atol=1e-12)
        np.testing.assert_allclose(res.pao[b], infl[b] / (K - 1) * np.eye(K),
                                   atol=1e-12)
        # inflation not updated when no obs
        np.testing.assert_allclose(res.infl[b], infl[b], atol=0)


def test_mixed_empty_batch():
    rng = np.random.default_rng(2)
    B, L, K = 64, 20, 8
    hdxb, rdiag, rloc, dep, infl, nl = make_problem(rng, B, L, K, frac_empty=0.4)
    res = letkf_core(jnp.asarray(hdxb), jnp.asarray(rdiag), jnp.asarray(rloc),
                     jnp.asarray(dep), jnp.asarray(infl), infl_update=True)
    for b in range(B):
        o = letkf_core_np(hdxb[b], rdiag[b], rloc[b], dep[b], infl[b],
                          nobsl=nl[b], infl_update=True)
        np.testing.assert_allclose(res.trans[b], o["trans"], atol=1e-9)
        np.testing.assert_allclose(res.infl[b], o["infl"], atol=1e-9)


def test_deterministic_member_weight():
    rng = np.random.default_rng(3)
    B, L, K = 8, 15, 6
    hdxb, rdiag, rloc, dep, infl, nl = make_problem(rng, B, L, K)
    depd = rng.standard_normal((B, L))
    res = letkf_core(jnp.asarray(hdxb), jnp.asarray(rdiag), jnp.asarray(rloc),
                     jnp.asarray(dep), jnp.asarray(infl),
                     depd=jnp.asarray(depd))
    for b in range(B):
        o = letkf_core_np(hdxb[b], rdiag[b], rloc[b], dep[b], infl[b],
                          depd=depd[b])
        np.testing.assert_allclose(res.transmd[b], o["transmd"], atol=1e-9)


def test_transform_properties():
    """W must be symmetric positive-definite with mean-preserving structure:
    the sqrt transform satisfies W C W = (K-1) C^{-1}... basic invariants."""
    rng = np.random.default_rng(4)
    B, L, K = 8, 25, 10
    hdxb, rdiag, rloc, dep, infl, _ = make_problem(rng, B, L, K)
    res = letkf_core(jnp.asarray(hdxb), jnp.asarray(rdiag), jnp.asarray(rloc),
                     jnp.asarray(dep), jnp.asarray(infl))
    t = np.asarray(res.trans)
    # symmetry
    np.testing.assert_allclose(t, np.swapaxes(t, -1, -2), atol=1e-10)
    # positive definiteness
    ev = np.linalg.eigvalsh(t)
    assert (ev > 0).all()
    # trans² = (K-1)·Pao
    t2 = np.einsum("bij,bjk->bik", t, t)
    np.testing.assert_allclose(t2, (K - 1) * np.asarray(res.pao), atol=1e-8)


def test_rtpp_rtps_and_total_weight():
    rng = np.random.default_rng(5)
    B, L, K = 6, 18, 8
    hdxb, rdiag, rloc, dep, infl, _ = make_problem(rng, B, L, K)
    res = letkf_core(jnp.asarray(hdxb), jnp.asarray(rdiag), jnp.asarray(rloc),
                     jnp.asarray(dep), jnp.asarray(infl))
    alpha = 0.6
    w_rtpp = weight_rtpp(res.trans, jnp.asarray(infl), alpha)
    xb = rng.standard_normal((B, K))
    w_rtps, m = weight_rtps(res.trans, res.pao, jnp.asarray(xb),
                            jnp.asarray(infl), alpha)
    beta = jnp.asarray(rng.uniform(0, 1, B))
    w_tot = total_weight(w_rtpp, res.transm, beta)
    for b in range(B):
        np.testing.assert_allclose(
            w_rtpp[b], rtpp_np(np.asarray(res.trans[b]), infl[b], alpha),
            atol=1e-10)
        wr, mr = rtps_np(np.asarray(res.trans[b]), np.asarray(res.pao[b]),
                         xb[b], infl[b], alpha)
        np.testing.assert_allclose(w_rtps[b], wr, atol=1e-10)
        np.testing.assert_allclose(m[b], mr, atol=1e-10)
        np.testing.assert_allclose(
            w_tot[b],
            total_weight_np(np.asarray(w_rtpp[b]), np.asarray(res.transm[b]),
                            float(beta[b])),
            atol=1e-10)


def test_apply_weights_reduces_error():
    """Assimilating direct noisy obs of the state must pull the analysis mean
    toward the truth (sanity of the full transform + application)."""
    rng = np.random.default_rng(6)
    K, L = 20, 10
    truth = 5.0
    ens = truth + rng.standard_normal(K) * 2.0 + 1.5   # biased prior
    mean = ens.mean()
    pert = ens - mean
    obs = truth + rng.standard_normal(L) * 0.1
    hdxb = np.tile(pert[None, :], (L, 1))
    dep = obs - mean
    res = letkf_core(jnp.asarray(hdxb[None]), jnp.full((1, L), 0.01),
                     jnp.ones((1, L)), jnp.asarray(dep[None]),
                     jnp.ones(1))
    w = total_weight(res.trans, res.transm, jnp.ones(1))
    anal = apply_weights(jnp.asarray(pert[None]), jnp.asarray([mean]), w)
    anal_mean = float(np.asarray(anal).mean())
    assert abs(anal_mean - truth) < abs(mean - truth) * 0.2


def test_relax_beta():
    z = jnp.asarray([0.0, 5e3, 20e3])
    d = jnp.asarray([1e3, 50e3, 200e3])
    beta = relax_beta(d, z, buffer_width=100e3)
    np.testing.assert_allclose(beta, [0.01, 0.5, 1.0], atol=1e-12)
    beta = relax_beta(d, z, radar_only=True, radar_zmax=10e3, vert_cutoff=1e3)
    np.testing.assert_allclose(beta, [1.0, 1.0, 0.0])
    beta = relax_beta(d, z, buffer_width=100e3, radar_only=True,
                      radar_zmax=10e3, vert_cutoff=1e3)
    np.testing.assert_allclose(beta, [0.01, 0.5, 0.0], atol=1e-12)


@pytest.mark.parametrize("backend,K,dtype,sharded,expected", [
    ("gpu", 8, jnp.float32, False, "jacobi"),
    ("gpu", 15, jnp.float32, False, "ns_fused"),
    ("gpu", 17, jnp.float32, False, "ns_fused"),
    ("gpu", 50, jnp.float32, False, "ns_fused"),
    ("gpu", 64, jnp.float32, False, "ns_fused"),
    ("gpu", 100, jnp.float32, False, "ns"),
    ("gpu", 1024, jnp.float32, False, "ns"),
    ("gpu", 50, jnp.float64, False, "ns"),
    ("cpu", 50, jnp.float32, False, "ns"),
    ("gpu", 50, jnp.float32, True, "ns"),
    ("gpu", 8, jnp.float32, True, "jacobi"),
])
def test_auto_routing(monkeypatch, backend, K, dtype, sharded, expected):
    """eigh_impl='auto' picks the backend from K, the dtype, the platform
    JAX reports (patched here) and whether a mesh splits the batch."""
    from scale_letkf_tpu.ops import letkf_core as lc
    monkeypatch.setattr(lc.jax, "default_backend", lambda: backend)
    assert lc.resolve_eigh_impl("auto", K, dtype, sharded) == expected
    assert lc.resolve_eigh_impl("lax", K, dtype, sharded) == "lax"


@pytest.mark.parametrize("impl", ["ns_pallas", "eigh"])
def test_unknown_eigh_impl_raises(impl):
    """Removed or misspelled backends are named errors, not silent
    fallbacks."""
    rng = np.random.default_rng(0)
    hdxb, rdiag, rloc, dep, infl, _ = make_problem(rng, 2, 5, 4)
    with pytest.raises(ValueError, match=impl):
        letkf_core(jnp.asarray(hdxb), jnp.asarray(rdiag), jnp.asarray(rloc),
                   jnp.asarray(dep), jnp.asarray(infl), eigh_impl=impl)
