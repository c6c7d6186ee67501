"""The plain version of the CG on a given Sigma (what the CUDA kernel
computes, ``masked_cg_reference``) against the JAX package's Pallas kernel
``lanes_masked_cg`` in interpret mode, on tests/test_kriging.py's inputs
(C = 5 chains at K = 48, and C = 3 at K = 16 with a per-chain eps).

Tolerances as tests/test_kriging.py states them: against the Pallas
kernel rtol/atol 2e-4 (the same CG iterations, float32 sums in another
order); against ``np.linalg.solve`` of the masked subsystem 1e-3 (CG
truncation at well-conditioned systems).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_tpu.ops.cg_kernel import lanes_masked_cg
from mcmc_tpu_torch.ops.cg_kernel import masked_cg, masked_cg_reference


def _spd(rng, C, K):
    A = rng.normal(size=(C, K, K))
    return (A @ np.swapaxes(A, -1, -2) / K + np.eye(K)).astype(np.float32)


def _inputs(seed, C, K, mask_p, eps):
    rng = np.random.default_rng(seed)
    Sigma = _spd(rng, C, K)
    mask = (rng.random((C, K)) < mask_p).astype(np.float32)
    mask[:, 0] = 1.0
    rhs = rng.normal(size=(C, K)).astype(np.float32)
    return Sigma, mask, rhs, eps


CASES = {
    # tests/test_kriging.py:180-209: C = 5, K = 48, scalar eps, 64 iters
    "k48_scalar_eps": (_inputs(0, 5, 48, 0.8, np.float32(1e-3)), 64),
    # tests/test_kriging.py:272-289: C = 3, K = 16, per-chain eps, 96 iters
    "k16_per_chain_eps": (_inputs(1, 3, 16, 1.0,
                                  np.asarray([1e-3, 2e-3, 5e-3], np.float32)),
                          96),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_cg_matches_pallas_and_numpy(case):
    (Sigma, mask, rhs, eps), n_iters = CASES[case]
    want = np.asarray(lanes_masked_cg(
        jnp.asarray(Sigma), jnp.asarray(mask), jnp.asarray(rhs),
        jnp.asarray(eps), n_iters, interpret=True))
    teps = torch.from_numpy(eps) if eps.ndim else float(eps)
    args = (torch.from_numpy(Sigma), torch.from_numpy(mask),
            torch.from_numpy(rhs), teps)
    got = masked_cg_reference(*args, n_iters).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert np.all(got[mask == 0] == 0.0)
    epsv = np.broadcast_to(eps, (Sigma.shape[0],))
    for c in range(Sigma.shape[0]):
        idx = np.where(mask[c] > 0)[0]
        sub = Sigma[c][np.ix_(idx, idx)] + epsv[c] * np.eye(len(idx))
        np.testing.assert_allclose(got[c, idx],
                                   np.linalg.solve(sub, rhs[c, idx]),
                                   rtol=1e-3, atol=1e-3)
    # the dispatcher runs the plain version for CPU tensors, no kernel
    before = masked_cg.launches
    np.testing.assert_array_equal(masked_cg(*args, n_iters).numpy(), got)
    assert masked_cg.launches == before


def test_row_j_serves_as_column_j():
    """Like the kernel and ``_cg_core``, the plain version reads row j of
    Sigma as column j: on a symmetric Sigma the same as a transposed
    copy, bitwise."""
    (Sigma, mask, rhs, eps), _ = CASES["k48_scalar_eps"]
    S = torch.from_numpy(Sigma)
    S = (S + S.transpose(1, 2)) / 2  # exactly symmetric
    m, b = torch.from_numpy(mask), torch.from_numpy(rhs)
    a = masked_cg_reference(S, m, b, float(eps), 48)
    t = masked_cg_reference(S.transpose(1, 2).contiguous(), m, b,
                            float(eps), 48)
    assert torch.equal(a, t)


def test_dispatcher_refusals():
    (Sigma, mask, rhs, eps), _ = CASES["k16_per_chain_eps"]
    S, m, b = (torch.from_numpy(a) for a in (Sigma, mask, rhs))
    with pytest.raises(TypeError, match="float32"):
        masked_cg(S.double(), m, b, 1e-3)
    with pytest.raises(ValueError, match="shape"):
        masked_cg(S[:, :8], m, b, 1e-3)
    with pytest.raises(ValueError, match="shape"):
        masked_cg(S, m, b[:2], 1e-3)
    with pytest.raises(ValueError, match="contiguous"):
        masked_cg(S.transpose(1, 2), m, b, 1e-3)
    with pytest.raises(ValueError, match="device"):
        masked_cg(S.to("meta"), m.to("meta"), b.to("meta"), 1e-3)
    # no K limit on the CPU: the kernels' limit is the card's shared
    # memory, held by the dispatcher on CUDA tensors only
    S, m, b = (torch.from_numpy(a)
               for a in _inputs(5, 2, 96, 0.8, np.float32(1e-3))[:3])
    got = masked_cg(S, m, b, 1e-3, 48)
    assert got.shape == (2, 96) and torch.isfinite(got).all()
    assert torch.equal(got, masked_cg_reference(S, m, b, 1e-3, 48))
