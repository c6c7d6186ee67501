"""Multi-rank runs of the PyTorch port on the CPU, for the tests.

``launch`` starts N gloo ranks of ``python -m tests.torch_dist CASE OUT``
with torchrun's variables, the way ``tests/test_distributed.py`` starts
the JAX package's two-process cluster: a scrubbed environment (no
pre-imported JAX), a free port with one retry, each worker under
coreutils ``timeout -s KILL`` and its process group killed on expiry, and
any rank that fails ending the others.  The workers import no JAX (each
asserts so before it reports) and write their results to ``OUT``.

The worker cases are below: the sharded farm of either family, its
checkpoints and the CLI (2 ranks), the grid-sharded chains (4 ranks), and
the parity seam of the grid step (``test_torch_grid_sharded.py``).  The
tests compare what the ranks wrote with one-rank runs in the test process.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OK = "RANK-OK"


def _free_port() -> int:
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _killpg(p):
    """Kill a worker and its ``timeout`` wrapper, the leader of their
    process group (``p.kill()`` alone would orphan the worker)."""
    try:
        os.killpg(p.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        p.kill()


def launch(case: str, n_ranks: int, out, *args, timeout: int = 150,
           module: str = "tests.torch_dist"):
    """Run ``case`` on ``n_ranks`` gloo ranks writing to ``out``; returns
    their logs after asserting that every rank exited 0 and reported.  A
    rank that fails or outlives ``timeout`` seconds ends them all."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               MASTER_ADDR="localhost", WORLD_SIZE=str(n_ranks),
               LOCAL_WORLD_SIZE=str(n_ranks))
    for attempt in (0, 1):
        env["MASTER_PORT"] = str(_free_port())
        logs = [out / f"{case}.rank{i}.log" for i in range(n_ranks)]
        procs = []
        for i, log in enumerate(logs):
            with open(log, "w") as fh:
                procs.append(subprocess.Popen(
                    ["timeout", "-s", "KILL", str(timeout + 30),
                     sys.executable, "-m", module, case, str(out), *args],
                    stdout=fh, stderr=subprocess.STDOUT, cwd=ROOT,
                    env=dict(env, RANK=str(i), LOCAL_RANK=str(i))))
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if (time.monotonic() > deadline
                        or any(p.poll() not in (None, 0) for p in procs)):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    _killpg(p)
                    p.wait()
        texts = [log.read_text() for log in logs]
        if (attempt == 0 and any(p.returncode for p in procs)
                and "address already in use" in "".join(texts).lower()):
            continue  # the rendezvous lost its port: once more, on another
        break
    for i, (p, text) in enumerate(zip(procs, texts)):
        assert p.returncode == 0 and OK in text, (
            f"rank {i} of {case} exited {p.returncode}:\n{text[-4000:]}")
    return texts


# -- the worker side ---------------------------------------------------------

FARM_CHAINS = 4
FARM_ITERS = 12
FARM_SEGMENT = 5
CKPT_ITERS = (20, 40)
SEEDS = {"int": 7, "list": [101, 102, 103, 104]}
GRID_CASES = {"2x2": (2, 2, 2), "2x2-list": (2, 2, 2), "1x4": (1, 4, 1),
              "crossing": (1, 4, 1), "three": (1, 4, 1)}
# chains axis, grid axis, chains; "-list": per-chain streams, else a
# generator seeded alike on every rank
GRID_ITERS = 30


def farm_problem():
    from tests.torch_helpers import small_problem

    return small_problem(H=40, W=40)


def farm_chain(family, p):
    from tests.torch_helpers import small_chain, small_sgs_chain

    if family == "crf":
        return small_chain(p, blocks=(8, 12))
    return small_sgs_chain(p)


def first_draws(sampler):
    """The first step's draws of a fresh farm, as numpy (``chain_crf`` /
    ``chain_sgs.draw`` from the sampler's stream)."""
    import dataclasses

    import torch

    from mcmc_tpu_torch.models import chain_crf, chain_sgs

    fam = chain_sgs if sampler.is_sgs else chain_crf
    d = fam.draw(sampler.stream(), sampler.static, sampler.consts,
                 sampler.rows[1] - sampler.rows[0])
    out = {}
    for f in dataclasses.fields(d):
        v = getattr(d, f.name)
        if v is not None:
            out[f.name] = (torch.view_as_real(v) if v.is_complex()
                           else v).cpu().numpy()
    return out


def farm_run(family, seeding, device="cpu"):
    """(first draws, traces, final fields of this rank's chains) of the
    test farm: FARM_ITERS iterations in segments of FARM_SEGMENT with bed
    snapshots, on every rank of the run (or alone)."""
    from mcmc_tpu_torch import MultiChainSampler

    chain = farm_chain(family, farm_problem())
    sampler = MultiChainSampler(chain, FARM_CHAINS, device=device)
    sampler.init(seeds=SEEDS[seeding])
    draws = first_draws(sampler)
    states = sampler.init(seeds=SEEDS[seeding])
    states, traces = sampler.run(states, FARM_ITERS,
                                 segment_size=FARM_SEGMENT, progress=False,
                                 collect_beds=True)
    return draws, traces, states.fields.cpu().numpy(), sampler.rows


def ckpt_run(family, seeding, directory, n_iter, device="cpu"):
    """``run_with_checkpointing`` of the test farm to ``n_iter``; returns
    (histories, this rank's final fields)."""
    from mcmc_tpu_torch import MultiChainSampler
    from mcmc_tpu_torch.io.checkpoint import run_with_checkpointing

    chain = farm_chain(family, farm_problem())
    sampler = MultiChainSampler(chain, FARM_CHAINS, device=device)
    states, hist, _ = run_with_checkpointing(
        sampler, n_iter, directory, seeds=SEEDS[seeding], segment_size=10,
        checkpoint_every=10)
    return hist, states.fields.cpu().numpy()


def _save(path, **arrays):
    np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})


def _flat(prefix, d):
    return {f"{prefix}{k}": v for k, v in d.items()}


def case_farm(out, rank):
    """2 ranks: each family and seeding's farm, the refused chain count,
    ``shard_chains``, and the checkpoints (CKPT_ITERS): the first count
    then the second, the second straight, and the first left for a
    one-rank resume."""
    from mcmc_tpu_torch import MultiChainSampler

    for family in ("crf", "sgs"):
        for seeding in SEEDS:
            draws, traces, fields, rows = farm_run(family, seeding)
            _save(out / f"farm_{family}_{seeding}.rank{rank}.npz",
                  fields=fields, rows=rows, **_flat("draw_", draws),
                  **_flat("trace_", traces))
        for seeding in SEEDS:
            tag = f"{family}_{seeding}"
            for n in CKPT_ITERS:
                hist, fields = ckpt_run(family, seeding,
                                        out / f"ckpt_resumed_{tag}", n)
            _save(out / f"ckpt_resumed_{tag}.rank{rank}.npz", fields=fields,
                  **_flat("hist_", hist))
            hist, fields = ckpt_run(family, seeding,
                                    out / f"ckpt_straight_{tag}",
                                    CKPT_ITERS[1])
            _save(out / f"ckpt_straight_{tag}.rank{rank}.npz", fields=fields,
                  **_flat("hist_", hist))
            ckpt_run(family, seeding, out / f"ckpt_half_{tag}",
                     CKPT_ITERS[0])
    try:
        MultiChainSampler(farm_chain("crf", farm_problem()), 3,
                          device="cpu")
        refused = ""
    except ValueError as e:
        refused = str(e)
    (out / f"refused.rank{rank}.txt").write_text(refused)
    from mcmc_tpu_torch.parallel import (global_chains_mesh, replicate,
                                         shard_chains)

    mesh = global_chains_mesh(device="cpu")
    tree = {"batch": np.arange(8.0).reshape(4, 2), "odd": np.arange(3),
            "scalar": 2.5, "pair": (np.arange(6), None)}
    sharded, whole = shard_chains(tree, mesh), replicate(tree, mesh)
    _save(out / f"shard.rank{rank}.npz", batch=sharded["batch"],
          odd=sharded["odd"], scalar=sharded["scalar"],
          pair=sharded["pair"][0], whole=whole["batch"])


def case_cli(out, rank):
    """2 ranks: the CLI on the configs the test wrote, crf (with its
    progress, banner and summary) then sgs (quiet); the CLI joins the run
    itself."""
    from mcmc_tpu_torch import cli

    for family, quiet in (("crf", []), ("sgs", ["--quiet"])):
        rc = cli.main([str(out / f"{family}.json"), "--device", "cpu",
                       *quiet])
        assert rc == 0


def grid_problem(case):
    """(problem, chain) of a grid case: the crossing case's region hugs
    the 4-shard boundaries; the three-shard case has 8-row shards and
    10-12-row blocks."""
    from tests.torch_helpers import small_chain, small_problem

    case = case.removesuffix("-list")
    if case == "three":
        p = small_problem(H=32, W=32)
        return p, small_chain(p, blocks=(10, 12))
    p = small_problem(H=48, W=48)
    chain = small_chain(p, blocks=(8, 12))
    if case == "crossing":
        region = np.zeros((48, 48), np.float32)
        for b in (12, 24, 36):
            region[b - 2:b + 2, 8:-8] = 1
        chain.set_update_region(True, region)
    return p, chain


def grid_run(case, mesh):
    """(beds, losses, steps) of this rank's block of a grid case's
    chains, from a generator seeded alike on every rank."""
    import torch

    from mcmc_tpu_torch.parallel import (make_sharded_crf_chains,
                                         shard_chains, shard_grid_arrays)
    from mcmc_tpu_torch.parallel.grid_sharded import shard_crf_consts
    from mcmc_tpu_torch.utils.rng import PerChainStreams

    _, _, n_chains = GRID_CASES[case]
    p, chain = grid_problem(case)
    static, consts = chain.build("cpu")
    beds = np.broadcast_to(np.asarray(p["initial_bed"], np.float32),
                           (n_chains, static.H, static.W)).copy()
    beds = shard_grid_arrays(mesh, shard_chains(beds, mesh))
    run = make_sharded_crf_chains(mesh, static)
    rng = (PerChainStreams.from_seeds(range(31, 31 + n_chains), "cpu")
           if case.endswith("-list") else torch.Generator().manual_seed(3))
    out = run(beds, shard_crf_consts(mesh, consts), GRID_ITERS, rng=rng)
    return [x.cpu().numpy() for x in out]


def case_grid(out, rank):
    """4 ranks: the mesh layouts and their refusals, then every grid
    case."""
    from mcmc_tpu_torch.parallel import (chains_grid_mesh,
                                         global_chains_grid_mesh)

    mesh = global_chains_grid_mesh(2, device="cpu")
    layout = {"shape": mesh.shape, "ranks": mesh.ranks.tolist(),
              "coords": list(mesh.coords), "refused": []}
    for n_grid in (3, 8):
        try:
            global_chains_grid_mesh(n_grid, device="cpu")
        except ValueError as e:
            layout["refused"].append(str(e))
    (out / f"layout.rank{rank}.json").write_text(json.dumps(layout))
    for case, (n_c, n_g, _) in GRID_CASES.items():
        mesh = chains_grid_mesh(n_c, n_g, device="cpu")
        beds, losses, steps = grid_run(case, mesh)
        _save(out / f"grid_{case}.rank{rank}.npz", beds=beds, losses=losses,
              steps=steps, coords=mesh.coords)


def case_seam(out, rank):
    """The parity seam (``test_torch_grid_sharded.py``): the residual and
    loss on the planes in ``seam_planes.npz``, and the grid step fed the
    JAX package's draws in ``seam_draws.npz``, on a 1 x N mesh."""
    import torch

    from mcmc_tpu_torch.parallel import (chains_grid_mesh, make_sharded_loss,
                                         make_sharded_residual,
                                         shard_grid_arrays)
    from mcmc_tpu_torch.parallel.grid_sharded import ShardedCRF
    from mcmc_tpu_torch.parallel.distributed import world
    from mcmc_tpu_torch.parallel.mesh import gather_rows

    mesh = chains_grid_mesh(1, world()[1], device="cpu")

    def whole(x):
        return gather_rows(x, mesh, "grid", dim=-2).numpy()

    with np.load(out / "seam_planes.npz") as z:
        a = shard_grid_arrays(mesh, {k: z[k] for k in z.files})
    res = make_sharded_residual(mesh)(a["bed"], a["surf"], a["velx"],
                                      a["vely"], a["dhdt"], a["smb"], 500.0)
    loss = make_sharded_loss(mesh)(a["res"], a["mask"], 5.0)
    result = {"residual": whole(res), "loss": float(loss)}
    seam = out / "seam_draws.npz"
    if seam.exists():
        with np.load(seam) as z:
            d = {k: z[k] for k in z.files}
        static = json.loads((out / "seam_static.json").read_text())
        consts = shard_grid_arrays(mesh, {k: d[k] for k in (
            "surf", "velx", "vely", "dhdt", "smb", "update_mask", "mc_mask",
            "crf_weight")})
        consts.update(rf=None, region_cells=d["region_cells"],
                      sigma_mc=float(d["sigma_mc"]),
                      resolution=float(d["resolution"]))
        crf = ShardedCRF(mesh, _Static(**static), consts, 1, None)
        bed = shard_grid_arrays(mesh, d["initial_bed"])[None]
        state, loss, comp = crf.init(bed)
        losses, steps = [], []
        for t in range(d["f"].shape[0]):
            loss, comp, acc = crf.step(
                state, loss, comp, torch.from_numpy(d["f"][t][None]),
                *(torch.tensor([int(d[k][t])]) for k in ("w", "h", "cidx")),
                torch.tensor([float(d["u"][t])], dtype=torch.float32))
            losses.append(float(loss[0]))
            steps.append(bool(acc[0]))
        result.update(bed=whole(state[0, 0]), losses=losses, steps=steps)
    if rank == 0:
        _save(out / f"seam.world{world()[1]}.npz", **result)


class _Static:
    """The grid step's reading of a chain's static: H, W and the block
    side B (``static.rf.B``), as the parity test hands them over."""

    def __init__(self, H, W, B):
        self.H, self.W = H, W
        self.rf = type("RF", (), {"B": B, "spectral": True,
                                  "has_nugget": False})()


def case_nccl(out, rank):
    """1 rank on card 0 over NCCL: each family's farm through a one-rank
    mesh against the same farm built without one, bitwise."""
    from mcmc_tpu_torch import MultiChainSampler
    from mcmc_tpu_torch.parallel import global_chains_mesh

    same = {}
    for family in ("crf", "sgs"):
        runs = []
        for mesh in (global_chains_mesh(), None):
            sampler = MultiChainSampler(farm_chain(family, farm_problem()),
                                        FARM_CHAINS, mesh=mesh,
                                        use_mesh=False)
            states = sampler.init(seeds=SEEDS["int"])
            states, traces = sampler.run(states, 3 * FARM_SEGMENT,
                                         segment_size=FARM_SEGMENT,
                                         progress=False, collect_beds=True)
            runs.append((traces, states.fields.cpu().numpy()))
        (a, fa), (b, fb) = runs
        same[family] = bool(np.array_equal(fa, fb) and all(
            np.array_equal(a[k], b[k], equal_nan=True) for k in a))
    (out / "nccl.json").write_text(json.dumps(same))


CASES = {"farm": case_farm, "cli": case_cli, "grid": case_grid,
         "seam": case_seam, "nccl": case_nccl}


def main(case, out):
    import torch

    from mcmc_tpu_torch.parallel import initialize_distributed
    from mcmc_tpu_torch.parallel.distributed import world

    torch.set_num_threads(1)
    out = Path(out)
    if case == "nccl":  # one rank on the card, the default backend
        assert initialize_distributed() is False
        assert torch.distributed.get_backend() == "nccl"
    elif case != "cli":  # the CLI joins the run itself
        assert initialize_distributed(device="cpu")
    CASES[case](out, int(os.environ["RANK"]))
    rank, size = world()
    assert "jax" not in sys.modules, "a worker imported jax"
    print(f"{OK} {rank} of {size}", flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:3])
