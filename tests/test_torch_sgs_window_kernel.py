"""The plain versions of the SGS window extract and writeback (what the
CUDA kernels compute) against the JAX package's Pallas kernels in
interpret mode: pure data movement, so BITWISE.  Window starts cover all
four clamped edges, the grid is not square (45 x 67 with an odd SB = 37
too), and the write mask mixes True and False."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_tpu.ops.sgs_window_kernel import (make_window_extract,
                                            make_window_writeback)
from mcmc_tpu_torch.ops.sgs_window_kernel import (window_extract,
                                                  window_extract_reference,
                                                  window_writeback,
                                                  window_writeback_reference)

NP, NS, N = 10, 4, 9


def _data(H, W, SB, seed=0):
    rng = np.random.default_rng(seed)
    cons = rng.normal(size=(NP, H, W)).astype(np.float32)
    fields = rng.normal(size=(N, NS, H, W)).astype(np.float32)
    sx = rng.integers(0, H - SB + 1, N).astype(np.int32)
    sy = rng.integers(0, W - SB + 1, N).astype(np.int32)
    # the four clamped edges: top-left, bottom-right, and the mixed corners
    sx[:4] = [0, H - SB, 0, H - SB]
    sy[:4] = [0, W - SB, W - SB, 0]
    return cons, fields, sx, sy


@pytest.mark.parametrize("H,W,SB", [(64, 256, 20), (48, 72, 36), (40, 40, 40),
                                    (45, 67, 37)])
def test_extract_bitwise(H, W, SB):
    cons, fields, sx, sy = _data(H, W, SB)
    fn = make_window_extract(H, W, SB, NP, NS, interpret=True)
    want = np.asarray(jax.jit(fn)(jnp.asarray(cons), jnp.asarray(fields),
                                  jnp.asarray(sx), jnp.asarray(sy)))
    args = (torch.from_numpy(cons), torch.from_numpy(fields),
            torch.from_numpy(sx), torch.from_numpy(sy), SB)
    got = window_extract_reference(*args)
    assert got.shape == (N, NP + NS, SB, SB)
    np.testing.assert_array_equal(got.numpy(), want)
    before = window_extract.launches
    np.testing.assert_array_equal(window_extract(*args).numpy(), want)
    assert window_extract.launches == before  # the CPU runs no kernel


@pytest.mark.parametrize("H,W,SB", [(64, 256, 20), (48, 72, 36), (45, 67, 37)])
def test_writeback_bitwise(H, W, SB):
    _, fields, sx, sy = _data(H, W, SB, seed=1)
    rng = np.random.default_rng(2)
    new_w = rng.normal(size=(N, NS, SB, SB)).astype(np.float32)
    write = rng.random(N) < 0.6
    write[:4] = [True, True, False, True]
    write[4] = False
    fn = make_window_writeback(H, W, SB, NS, interpret=True)
    want = np.asarray(jax.jit(fn)(jnp.asarray(fields), jnp.asarray(new_w),
                                  jnp.asarray(sx), jnp.asarray(sy),
                                  jnp.asarray(write)))
    for op in (window_writeback_reference, window_writeback):
        got = torch.from_numpy(fields.copy())
        out = op(got, torch.from_numpy(new_w), torch.from_numpy(sx),
                 torch.from_numpy(sy), torch.from_numpy(write))
        assert out is got  # in place
        np.testing.assert_array_equal(got.numpy(), want)
        # rejected chains' planes are untouched
        np.testing.assert_array_equal(got.numpy()[~write], fields[~write])
