"""The plain version of the Philox noise kernel (``batched_normal_reference``,
what the CUDA kernel computes) on the CPU.

The JAX package's kernel draws the TPU's hardware PRNG bits, which have no
CPU interpret mode, so nothing here can be compared draw for draw with it
(tests/test_noise_kernel.py skips there too).  Instead: the Philox words
against Random123's published known answers; the transform against a
numpy transcription of ``mcmc_tpu/ops/noise_kernel.py:67-76`` on the same
24-bit integers (atol 2e-6: float32 log / sin / cos of another library,
on values up to 5.9); and the statistics tests/test_noise_kernel.py:41-53
holds the TPU kernel to, at its shape (64 chains x 160 x 41).
"""

import numpy as np
import pytest
import torch
from scipy import stats

from mcmc_tpu_torch.ops.noise_kernel import (batched_normal,
                                             batched_normal_reference,
                                             box_muller, draw_seed,
                                             philox4x32_10)

# Random123 kat_vectors: philox4x32 10 (counter, key) -> output
KNOWN_ANSWERS = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
SHAPE = (64, 160, 41)
CAP = 5.8871  # sqrt(-2 ln 2^-25) = 5.88705, rounded up for float32


@pytest.mark.parametrize("ctr,key,want", KNOWN_ANSWERS)
def test_philox_known_answers(ctr, key, want):
    words = philox4x32_10(*(torch.tensor([v], dtype=torch.int64)
                            for v in ctr + key))
    assert tuple(int(w[0]) for w in words) == want


def _numpy_transform(bits1, bits2):
    """mcmc_tpu/ops/noise_kernel.py:67-76, transcribed to numpy."""
    b1 = (bits1 & 0xFFFFFF).astype(np.float32)
    b2 = (bits2 & 0xFFFFFF).astype(np.float32)
    u1 = b1 * np.float32(2.0 ** -24) + np.float32(2.0 ** -25)
    u2 = b2 * np.float32(2.0 ** -24)
    r = np.sqrt(np.float32(-2.0) * np.log(u1))
    t = np.float32(2.0 * np.pi) * u2
    return r * np.cos(t), r * np.sin(t)


def test_transform_matches_the_jax_kernel():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 32, (2, 100_000), dtype=np.int64)
    # the extremes of the 24-bit range, and high bits that must be masked
    bits[:, :4] = [[0, 0xFFFFFF, 0xFF000000, 0xFFFFFFFF],
                   [0xFFFFFF, 0, 0x00FFFFFF, 0x12345678]]
    zc, zs = box_muller(torch.from_numpy(bits[0]), torch.from_numpy(bits[1]))
    wc, ws = _numpy_transform(bits[0], bits[1])
    assert zc.dtype == torch.float32
    np.testing.assert_allclose(zc.numpy(), wc, rtol=0, atol=2e-6)
    np.testing.assert_allclose(zs.numpy(), ws, rtol=0, atol=2e-6)
    assert float(zc.abs().max()) <= CAP


def test_layout_pairs_cos_and_sin_halves():
    """Pair q of chain c: Philox call q // 2 on counter (q // 2, c, 0, 0),
    words (0, 1) or (2, 3); cos into row-half 0 at q, sin into half 1."""
    seed = torch.tensor([(7 << 32) | 11], dtype=torch.int64)
    z = batched_normal_reference(seed, 3, 6, 5)      # 15 pairs, odd
    pairs = 3 * 5
    for c, q in ((0, 0), (1, 5), (2, 14)):
        words = philox4x32_10(*(torch.tensor([v]) for v in
                                (q // 2, c, 0, 0, 11, 7)))
        b1, b2 = (words[0], words[1]) if q % 2 == 0 else (words[2],
                                                          words[3])
        zc, zs = box_muller(b1, b2)
        flat = z[c].reshape(-1)
        assert flat[q] == zc[0] and flat[pairs + q] == zs[0]


@pytest.fixture(scope="module")
def normals():
    seed = draw_seed(torch.Generator().manual_seed(0), "cpu")
    return seed, batched_normal(seed, *SHAPE)


def test_statistics(normals):
    seed, z = normals
    assert z.shape == SHAPE and z.dtype == torch.float32
    zn = z.numpy()
    assert abs(zn.mean()) < 0.01
    assert abs(zn.std() - 1.0) < 0.01
    assert np.abs(zn).max() <= CAP
    sample = zn.reshape(-1)[::7]
    assert stats.kstest(sample, "norm").pvalue > 1e-3
    corr = np.corrcoef(zn.reshape(SHAPE[0], -1))
    assert np.abs(corr - np.eye(SHAPE[0])).max() < 0.08


def test_deterministic_in_the_seed(normals):
    seed, z = normals
    assert torch.equal(batched_normal(seed, *SHAPE), z)
    assert not torch.allclose(batched_normal(seed + 1, *SHAPE), z)
    # a chain's normals do not depend on how many chains are drawn
    assert torch.equal(batched_normal(seed, 5, 160, 41), z[:5])


def test_refusals():
    seed = torch.tensor([3], dtype=torch.int64)
    with pytest.raises(ValueError, match="even"):
        batched_normal(seed, 4, 7, 8)
    with pytest.raises(ValueError, match="even"):
        batched_normal_reference(seed, 4, 7, 8)
    with pytest.raises(TypeError, match="int64"):
        batched_normal(seed.to(torch.int32), 4, 8, 8)
    with pytest.raises(TypeError, match="int64"):
        batched_normal(torch.tensor([1, 2]), 4, 8, 8)
    before = batched_normal.launches
    batched_normal(seed, 2, 8, 8)
    assert batched_normal.launches == before  # the plain version ran
