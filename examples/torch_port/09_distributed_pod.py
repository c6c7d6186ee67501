"""Multi-process deployment on the PyTorch port — one program, many ranks.

The reference scales by forking a `multiprocessing.Pool` on one machine
(largeScaleChain_multiprocessing.py:75-79). The port's equivalent is ONE
program launched once per card under ``torchrun``: every rank joins a
``torch.distributed`` process group, builds the SAME global ``chains`` mesh
over all ranks, and runs the identical sampler code — the chain batch is
split across the ranks, chains never communicate during sampling, and each
rank checkpoints only its own shard of the state.

On a machine with several cards the recipe is just:

    # torchrun --nproc-per-node N this_script.py
    from mcmc_tpu_torch.parallel import (initialize_distributed,
                                         global_chains_mesh)
    initialize_distributed()          # reads torchrun's MASTER_ADDR /
                                      # MASTER_PORT / WORLD_SIZE / RANK /
                                      # LOCAL_RANK; NCCL, a card a rank
    mesh = global_chains_mesh()       # all ranks
    sampler = MultiChainSampler(chain, n_chains=256, mesh=mesh)
    run_with_checkpointing(sampler, n_iter, "runs/denman", seeds=0)

and every rank executes this same script. Checkpoints are written as
per-rank shard files ``checkpoint_{N}.proc{k}of{P}.npz`` plus a completion
marker published by rank 0 after a barrier (io/checkpoint.py);
re-invoking the script resumes from them, at any rank count.

This example DEMONSTRATES the path by launching this script as two ranks
under ``python -m torch.distributed.run --standalone --nproc-per-node 2``:
on the card both ranks share card 0 over gloo (NCCL refuses two ranks on
one card), with ``--device cpu`` they run on the CPU over gloo. The parent
then checks that (a) both ranks observed the identical global loss trace,
(b) the checkpoint directory holds one shard file per rank plus the
marker, and (c) a plain single-process ``CheckpointManager.load()``
reassembles the full chain batch.

Run: ``python examples/torch_port/09_distributed_pod.py [--device cpu]``
"""

import argparse
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from examples.torch_port.synthetic_glacier import (  # noqa: E402
    example_out,
    make_dataset,
    quick_mode,
    require,
    run_main,
)

from mcmc_tpu_torch.utils.rng import resolve_device  # noqa: E402

N_CHAINS = 4
N_RANKS = 2
TIMEOUT = 300  # s, the whole two-rank launch


def worker(argv):
    """One rank (``--worker``, started by torchrun): join the group, run
    the sharded farm with checkpoints, write the global loss line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    for name in ("--device", "--dataset", "--ckdir"):
        ap.add_argument(name)
    ap.add_argument("--n-iter", type=int)
    ap.add_argument("--segment", type=int)
    args = ap.parse_args(argv)
    import torch.distributed as dist

    from mcmc_tpu_torch.io import run_with_checkpointing
    from mcmc_tpu_torch.models import ChainCRF
    from mcmc_tpu_torch.parallel import (MultiChainSampler,
                                         global_chains_mesh,
                                         initialize_distributed)
    from mcmc_tpu_torch.parallel.distributed import world
    from mcmc_tpu_torch.utils.config import (BlockMenuConfig,
                                             RandFieldConfig, WeightConfig)

    # 1. join the group before anything touches a device: every rank on
    # card 0 over gloo, or on the CPU
    if args.device == "cuda":
        ok = initialize_distributed(local_device_ids=[0], backend="gloo")
    else:
        ok = initialize_distributed(device="cpu")
    rank, size = world()
    require(ok and size == N_RANKS, f"joined a {size}-rank group")

    # 2. identical chain setup in every rank (the reference broadcasts
    #    __dict__ snapshots to pool workers; here the config IS the code)
    ds = dict(np.load(args.dataset))
    res = float(ds["resolution"])
    chain = ChainCRF(ds["xx"], ds["yy"], ds["initial_bed"], ds["surf"],
                     ds["velx"], ds["vely"], ds["dhdt"], ds["smb"],
                     ds["cond_bed"], ds["data_mask"], ds["grounded"], res)
    chain.set_update_region(True, ds["highvel_mask"])
    chain.set_loss_type(sigma_mc=5.0, massConvInRegion=True)
    chain.configure_randfield(
        RandFieldConfig(range_min_x=5e3, range_max_x=20e3, range_min_y=5e3,
                        range_max_y=20e3, scale_min=20.0, scale_max=60.0,
                        nugget_max=0.0, model_name="Gaussian",
                        isotropic=True),
        BlockMenuConfig(8, 16, 8, 16, steps=2),
        WeightConfig(L=2, x0=0, k=6, offset=1, max_dist=5e3,
                     resolution=res))
    chain.set_update_type("RF")

    # 3. global mesh over every rank; the chains shard across it
    mesh = global_chains_mesh()
    sampler = MultiChainSampler(chain, n_chains=N_CHAINS, mesh=mesh)
    states, hist, done = run_with_checkpointing(
        sampler, args.n_iter, args.ckdir, seeds=2026,
        segment_size=args.segment, progress=False)

    # every rank holds the same GLOBAL trace (the chains are sharded, the
    # traces gathered)
    loss = np.asarray(hist["loss"])
    require(loss.shape == (N_CHAINS, args.n_iter), f"trace {loss.shape}")
    require(np.isfinite(loss).all(), "non-finite loss trace")
    require(not any(m.split(".")[0] in ("jax", "mcmc_tpu")
                    for m in sys.modules), "a rank imported JAX")
    line = (f"PROC{rank} done={done} device={sampler.device} "
            f"rows={list(sampler.rows)} loss0={loss[:, 0].mean():.6e} "
            f"lossN={loss[:, -1].mean():.6e}")
    print(line, flush=True)
    Path(args.ckdir).parent.joinpath(f"pod_rank{rank}.txt").write_text(line)
    dist.destroy_process_group()
    return 0


def _launch(device, dataset, ckdir, n_iter, segment):
    """Both ranks under torchrun (``timeout -s KILL`` around it, its
    process group killed if it outlives TIMEOUT); one more try on a fresh
    port if the rendezvous lost its port.  Returns (exit code, output)."""
    cmd = ["timeout", "-s", "KILL", str(TIMEOUT + 30), sys.executable, "-m",
           "torch.distributed.run", "--standalone",
           f"--nproc-per-node={N_RANKS}", str(Path(__file__).resolve()),
           "--worker", "--device", device.type, "--dataset",
           str(dataset), "--ckdir", str(ckdir), "--n-iter", str(n_iter),
           "--segment", str(segment)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = str(ROOT)
    for attempt in (0, 1):
        p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, env=env,
                             cwd=str(ROOT))
        try:
            out = p.communicate(timeout=TIMEOUT)[0]
        except subprocess.TimeoutExpired:
            # kill the whole group: p.kill() would hit only the timeout
            # wrapper and orphan torchrun's ranks
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                p.kill()
            out = p.communicate()[0]
        if (attempt == 0 and p.returncode != 0
                and "address already in use" in out.lower()):
            continue  # the rendezvous lost its port: once more
        return p.returncode, out


def main(device=None):
    device = resolve_device(device)
    out = example_out()
    quick = quick_mode()
    hw = 48 if quick else 96
    n_iter = 60 if quick else 400
    ds = make_dataset(H=hw, W=hw)
    dataset = out / "pod_dataset.npz"
    np.savez(dataset, **{k: v for k, v in ds.items()})

    # fresh demo run: a leftover checkpoint from a different problem size
    # would otherwise be picked up by resume-on-reinvoke and rejected
    ckdir = out / "pod_run"
    if ckdir.exists():
        shutil.rmtree(ckdir)
    ckdir.mkdir()
    for k in range(N_RANKS):
        (out / f"pod_rank{k}.txt").unlink(missing_ok=True)

    print(f"launching {N_RANKS} ranks under torchrun ({device.type}, gloo), "
          f"{N_CHAINS} chains x {n_iter} iters sharded across them")
    t0 = time.time()
    rc, log = _launch(device, dataset, ckdir, n_iter,
                      max(n_iter // 4, 10))
    seconds = time.time() - t0
    if rc != 0:
        raise RuntimeError(f"torchrun exited {rc}:\n{log[-4000:]}")

    # (a) identical global trace on both ranks
    lines = [(out / f"pod_rank{k}.txt").read_text() for k in range(N_RANKS)]
    print("\n".join(lines))
    same_trace = len({ln.split(" loss0=", 1)[1] for ln in lines}) == 1
    require(same_trace, f"the ranks' global traces differ: {lines}")

    # (b) per-rank shard files + the completion marker
    names = sorted(f.name for f in ckdir.iterdir())
    print("checkpoint dir:", ", ".join(names))
    want = {f"checkpoint_{n_iter}.proc{k}of{N_RANKS}.npz"
            for k in range(N_RANKS)} | {f"checkpoint_{n_iter}.ok"}
    require(want <= set(names), f"missing {sorted(want - set(names))}")

    # (c) a plain single-process load reassembles the full chain batch
    from mcmc_tpu_torch.io import CheckpointManager

    done, states, hist, _ = CheckpointManager(ckdir).load(device=device)
    beds = states.bed.cpu().numpy()
    require(done == n_iter and beds.shape == (N_CHAINS, hw, hw),
            f"reassembled iter {done}, beds {beds.shape}")
    require(np.isfinite(beds).all(), "non-finite reassembled beds")
    print(f"reassembled from shards: iter={done}, beds {beds.shape} on "
          f"{states.bed.device} — the sharded run round-trips through a "
          f"single-process reader ({seconds:.1f} s for the launch)")
    return {"device": str(device), "ranks": lines, "same_trace": same_trace,
            "checkpoint_files": names, "reassembled": beds.shape,
            "seconds": seconds}


if __name__ == "__main__":
    if "--worker" in sys.argv:
        sys.exit(worker(sys.argv[1:]))
    sys.exit(run_main(main))
