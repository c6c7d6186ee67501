"""The port's grid-sharded residual, loss and CRF step against the JAX
package's, at the seam.

JAX runs here, in the test process, on conftest's 8 virtual CPU devices;
the port's ranks run in gloo workers (``tests/torch_dist.py``, no JAX in
them) on the same seeded numpy planes:

- ``make_sharded_residual`` and ``make_sharded_loss``: the port at 2 and
  4 ranks against JAX's 8-shard result, rtol 1e-5;
- the sharded step: ``make_sharded_crf_chain``'s draws replayed here (per
  step ``key, k_blk, k_c, k_u = jax.random.split(key, 4)``, the block from
  ``draw_block(k_blk, ...)``, the centre from ``randint(k_c, (), 0,
  n_cells)``, the MH uniform from ``uniform(k_u, ())``, as
  ``mcmc_tpu/parallel/grid_sharded.py:199-201,309`` draws them) and fed
  to the port's draws-injected step (``ShardedCRF.step``) at 4 ranks,
  held against JAX's 4-shard run over 40 steps with the JAX package's own
  gates: steps equal, loss rtol 1e-5, bed rtol 1e-5 / atol 1e-3.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mcmc_tpu.models.randfield import draw_block
from mcmc_tpu.parallel.grid_sharded import (make_sharded_crf_chain,
                                            make_sharded_loss,
                                            make_sharded_residual,
                                            shard_grid_arrays)
from mcmc_tpu.parallel.mesh import chains_grid_mesh
from tests import torch_dist as td
from tests.conftest import make_synthetic_problem
from tests.test_chain_crf import build_small_chain

STEPS = 40
SEED = 7
RESOLUTION, SIGMA = 500.0, 5.0


def _planes(rng):
    H, W = 64, 32
    a = {k: rng.normal(size=(H, W)).astype(np.float32)
         for k in "bed surf velx vely dhdt smb res".split()}
    a["mask"] = rng.random((H, W)) < 0.5
    return a


def _jax_residual_and_loss(a):
    mesh = chains_grid_mesh(1, 8)
    s = shard_grid_arrays(mesh, a)
    res = make_sharded_residual(mesh)(
        s["bed"], s["surf"], s["velx"], s["vely"], s["dhdt"], s["smb"],
        jnp.float32(RESOLUTION))
    loss = make_sharded_loss(mesh)(s["res"], s["mask"], jnp.float32(SIGMA))
    return np.asarray(res), float(loss)


def _jax_chain_and_draws():
    """JAX's 4-shard single-chain run and the draws it made, replayed,
    with the planes and values the port's ranks need."""
    p = make_synthetic_problem(H=64, W=64)
    static, consts = build_small_chain(p).build()
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("grid",))
    planes = dict(
        surf=np.asarray(consts.surf), velx=np.asarray(consts.velx),
        vely=np.asarray(consts.vely), dhdt=np.asarray(consts.forcing),
        smb=np.zeros_like(np.asarray(consts.forcing)),
        update_mask=np.asarray(consts.update_mask),
        mc_mask=np.asarray(consts.mc_mask, np.float32),
        crf_weight=np.asarray(consts.crf_weight))
    sharded = shard_grid_arrays(mesh, planes)
    sharded.update(rf=consts.rf, region_cells=consts.region_cells,
                   sigma_mc=consts.sigma_mc, resolution=consts.resolution)
    bed0 = np.asarray(p["initial_bed"], np.float32)
    bed = jax.device_put(jnp.asarray(bed0), NamedSharding(mesh,
                                                          P("grid", None)))
    bed_f, losses, steps = make_sharded_crf_chain(mesh, static)(
        bed, sharded, jax.random.key(SEED), STEPS)

    n_cells = consts.region_cells.shape[0]
    block = jax.jit(lambda k: draw_block(k, static.rf, consts.rf))
    key = jax.random.key(SEED)
    draws = {k: [] for k in ("f", "w", "h", "cidx", "u")}
    for _ in range(STEPS):
        key, k_blk, k_c, k_u = jax.random.split(key, 4)
        f, _, w, h = block(k_blk)
        for name, v in (("f", f), ("w", w), ("h", h),
                        ("cidx", jax.random.randint(k_c, (), 0, n_cells)),
                        ("u", jax.random.uniform(k_u, ()))):
            draws[name].append(np.asarray(v))
    seam = {k: np.stack(v) for k, v in draws.items()}
    seam.update(planes, region_cells=np.asarray(consts.region_cells),
                sigma_mc=np.float32(consts.sigma_mc),
                resolution=np.float32(consts.resolution), initial_bed=bed0)
    static_json = {"H": static.H, "W": static.W, "B": static.rf.B}
    return (np.asarray(bed_f), np.asarray(losses), np.asarray(steps), seam,
            static_json)


@pytest.fixture(scope="module")
def seam(tmp_path_factory):
    """JAX's results here, the port's at 2 and 4 ranks from the workers."""
    out = tmp_path_factory.mktemp("seam")
    a = _planes(np.random.default_rng(1234))
    np.savez(out / "seam_planes.npz", **a)
    jax_res, jax_loss = _jax_residual_and_loss(a)
    td.launch("seam", 2, out)
    bed, losses, steps, draws, static = _jax_chain_and_draws()
    np.savez(out / "seam_draws.npz", **draws)
    (out / "seam_static.json").write_text(json.dumps(static))
    td.launch("seam", 4, out)
    port = {n: dict(np.load(out / f"seam.world{n}.npz")) for n in (2, 4)}
    return dict(res=jax_res, loss=jax_loss, bed=bed, losses=losses,
                steps=steps, port=port)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_residual_matches_jax(seam, world):
    np.testing.assert_allclose(seam["port"][world]["residual"], seam["res"],
                               rtol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_loss_matches_jax(seam, world):
    assert float(seam["port"][world]["loss"]) == pytest.approx(seam["loss"],
                                                               rel=1e-5)


def test_sharded_step_at_the_seam_matches_jax(seam):
    port = seam["port"][4]
    np.testing.assert_array_equal(port["steps"], seam["steps"])
    np.testing.assert_allclose(port["losses"], seam["losses"], rtol=1e-5)
    np.testing.assert_allclose(port["bed"], seam["bed"], rtol=1e-5,
                               atol=1e-3)
    assert seam["steps"].sum() > 0  # the chain moved
