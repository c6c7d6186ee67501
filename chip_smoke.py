#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

The quickest proof that the port (``mcmc_tpu_torch``) still starts and is
right on the card.  It needs one CUDA device and nvcc, imports nothing of
JAX or of the JAX package, and exits non-zero on any failure.  Phases, one
line or more each:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds every ``ops/csrc/*.cu`` for sm_90a, one process per
   source, all started together, with the ptxas register and
   shared-memory lines and each kernel's SASS instruction count;
3. CRF kernel vs plain version: the CUDA window kernel against its plain
   PyTorch version on the same state and draws, at the headline geometry
   (768 chains on a 512 x 512 grid, blocks up to 80), then with blocks of
   50 and 80 forced onto every domain edge and corner (NaN in surf and the
   data, with and without the data loss and a prefinished proposal); the
   launch's shared memory, registers and resident CTAs per multiprocessor;
   both times per launch from CUDA events on the parity steps' own state
   (a cold L2, as on the main path) and back to back, GB/s and the share
   of the bound;
4. irfft2 on the card against the CPU on the same half-spectrum noise;
5. CRF main path: ChainCRF -> MultiChainSampler(chain, 768) ->
   init(seeds=0) -> run(3 segments x 500 iterations) -> diagnostics,
   checking that every step launched the window kernel and the Philox
   noise kernel once each, the loss is finite and falls, acceptance is in
   (0.02, 0.98) and the bed outside the update region is untouched; the
   diagnostics on the card held key by key to the same call on the CPU
   (``[diag] (a)``); then a short profiled window for the device's busy
   share;
6. SGS kernels vs plain versions: 10 steps at the SGS headline (512
   chains on the same 512 x 512 grid), the state advancing on the
   kernels' results: window extract and writeback bitwise, the inverse
   LUT bitwise (or within 1 ulp, counted; its launch and an empty
   kernel's time on the same grid), the mixture CG within rtol /
   atol 2e-4 and, run to convergence, within 2e-3 of a float64 solve for
   a sample of chains, and a plain step from the same state and draws
   flipping at most 1e-3 of the MH decisions; both times per launch; each
   window kernel's launch (CTAs, threads a CTA, registers, resident CTAs
   per multiprocessor) and share of its bound; the CG kernel's launch
   (chains and threads a CTA, shared bytes, registers, resident CTAs and
   warps per multiprocessor) and its time at 0 and 1
   iterations (the system's build alone, and one iteration); then an SGS
   chain with 96 neighbours at the same width (``[cg-k96]``: K = 96, the
   mixture CG kernel against its plain version on its own packed systems
   and a few steps on the kernels against plain steps); and both window
   kernels bitwise against their plain versions with SB 37 on the odd
   45 x 67 grid and on 45 x 64 (the two writeback paths), the four
   clamped corners among the starts (``[sgs-window-edge]``);
7. SGS main path: ChainSGS -> MultiChainSampler(chain, 512) ->
   init(seeds=0) -> run(3 segments x 400 iterations) -> diagnostics,
   checking that each of the four kernels ran once per step, the loss is
   finite and falls, acceptance is in (0.02, 0.98), the bed beyond every
   block's reach is untouched and the patched residual equals a full-grid
   recompute; the diagnostics card against CPU as in 5; then a profiled
   window;
8. noise kernel vs plain version: the Philox normals at the CRF
   headline's shape (768 chains x 160 x 41) and at an odd pair count
   (5 x 18 x 7) bitwise equal to the plain version, their moments, tail
   cap and cross-chain correlation, both times per launch and
   ``torch.randn`` of the same shape;
9. the CRF step on its kernels (noise, cuFFT, window) against the plain
   step (plain Philox, plain window op) from the same state and generator
   state: 20 steps at 768 chains, at most 1e-3 of MH decisions flipping;
10. the CG on a given Sigma vs its plain version: 10 steps at the
   spherical SGS headline (``make_sgs_chain`` with a spherical 10 km
   variogram, which has no mixture fit: K = 48, 48 CG iterations), within
   rtol / atol 2e-4, run to convergence within 2e-3 of a float64 solve,
   MH flips against a plain step at most 1e-3; both times per launch;
   the kernel's launch and its time at 0 and 1 iterations, as in 6;
11. the entry point at full width: the problem as an ``.npz`` and JSON
   configs in a temporary directory under the checkout, run through
   ``mcmc_tpu_torch.cli.main``: (a) the spherical SGS farm, 512 chains,
   400 iterations, then resumed to 600, bitwise equal in traces and final
   beds to an uninterrupted 600, the given-Sigma CG once per step, and
   ``--info`` listing the checkpoint; (b) the CRF farm at 768 chains
   through ``drivers.large_scale_chain_farm``, 300 iterations;
12. per-chain draws (``[draws]``, between phases 9 and 10): the draw
   kernel of seed-listed farms against its plain version on the CRF
   headline's draw plan (768 chains) and the SGS headline's (512 chains,
   6,400 normals a chain), and the keyed noise entry at 768 x 160 x 41,
   over 10 step counters (one past 2^32), bitwise; both times per launch
   beside an empty kernel on the draw kernel's grid, the bound by bytes
   and by operations (the SASS instructions one normal call issues, from
   a probe kernel built from the source, at the card's issue rate), and
   ``torch.rand`` / ``torch.randn`` of the same shape;
13. chain independence (``[independence]``): at each headline a farm
   seeded with a list and a 1-chain farm seeded with its first seed, 50
   CRF / 399 SGS steps on the kernels: chain 0's draws, loss traces and
   final state bitwise equal; where they are not, the SGS farms run again
   with each step taken apart (``testing.sgs_step_stages``) to name the
   first op whose chain-0 result depends on the batch; whether cuFFT
   gives chain 0 the same bits in a batch as alone;
   and ``ops/physics.masked_sq_sum`` on random fields, chain 0 in a
   batch against alone (beside a one-pass ``sum``, which is not);
14. seeding and launches (``[seeds]``): an int-seeded and a list-seeded
   farm of each family in turn (int, list, list, int): chain-it/s (no
   claim) and device ops a step, the list-seeded step making no more
   than the int-seeded one; the list-seeded runs are the draw kernel's
   main path, one launch a step;
15. the entry point with a seed list (``[entry-list]``, after phase 11):
   the Matérn SGS headline through ``mcmc_tpu_torch.cli.main`` with a
   512-seed ``rng_seeds`` list, 400 iterations resumed to 600, bitwise
   equal to an uninterrupted 600, one draw-kernel launch a step;
16. the single-chain run API (``[run]``): ``ChainCRF.run(1000)`` (beds
   saved) and ``ChainSGS.run(400)`` at the headline's width, one chain
   seeded [1000], each kernel of the path once a step: traces bitwise the
   1-chain farm seeded [1000], draws and traces bitwise chain 0's in the
   headline farm seeded [1000, ...],
   bitwise the same with ``progress_bar`` every 100 iterations and (CRF)
   with a ``RandField`` configured like the chain, a second run
   continuing the stream, (CRF) the last saved bed the final state's,
   the loss finite and falling, acceptance in (0.02, 0.98); it/s and a
   profiled window; then every kernel of each path at one chain against
   its plain version over 10 steps, timed beside an empty kernel on the
   same number of CTAs;
17. bed snapshots and the profiler (``[collect]``): ``run(collect_beds=
   True, profile_dir=...)`` at 768 CRF chains (3 segments) and 512 SGS
   chains (2): ``bed_thin`` (n_chains, n_segments, 512, 512) ending on
   the final full-space bed bitwise, and one Chrome trace, of the second
   segment, naming the family's window kernel;
18. geostatistics (``[geostats]``, the T2 workflow at full width):
   ``fit_variogram`` on the radar picks, two ``generate_initial_beds``
   at 512^2 (exponential fit, bounded below the surface): data honoured
   within 1 m, the bounds kept, the seeds' beds different and the same
   seed's bitwise; ``krige`` at 512^2; the same call on a 128^2 cut on
   the card and on the CPU within 5e-2 m; the beds as a 2-chain CRF
   farm's initial beds for 50 steps, all on the captured chunk loop
   (one CUDA graph a call, replayed a chunk); then the first bed, a
   bounded Matern bed and the ``krige`` maps on the eager loop against
   the captured one, bitwise, with seconds a bed, ms a chunk, capture
   ms and added peak memory; and on each loop 20 profiled chunks'
   Python-launched and device ops, idle share and graph nodes;
19. the gstools-SRF proposal method (``[srf]``): the SRF kernel
   (``ops/csrc/srf_kernel.cu``, the harmonic sum of 1000 modes as a
   separable product in 3xTF32 on the tensor cores) at the CRF headline
   (768 chains x 80 x 80, Matern), with anisotropic Exponential ranges
   and azimuths and at one 512 x 512 field, each held (i) within 2e-5
   of the float64 field on the unrounded phase and (ii) within the
   phase rounding's per-cell bound plus 2e-5 of its plain version
   (``mcmc_tpu_torch/testing.py``), chain 5 bitwise alone and in the
   batch, with its time, the plain version's, a ``torch.bmm``
   composition's (a yardstick the port never calls), both forms of the
   bound, registers, spills, shared bytes and resident CTAs; the SRF step
   on its kernels against the plain step (10 steps, at most 1e-3 of MH
   decisions flipping); the SRF farm's main path (ChainCRF with
   ``spectral=False`` -> MultiChainSampler(chain, 768) -> init(seeds=0)
   -> run(2 x 150) -> diagnostics: the SRF and window kernels once a
   step, the noise kernel never, the loss finite and falling, acceptance
   in (0.02, 0.98), the bed outside the region untouched; chain-it/s and
   a profiled window); a 768-seed SRF farm and the 1-chain farm of its
   first seed (one draw-kernel launch a step, chain 0's draws bitwise over
   50 steps); the SRF farm through ``mcmc_tpu_torch.cli.main``, 200
   iterations resumed to 300, bitwise against 300 straight; and
   ``RandField.get_random_field`` at 512^2 by the SRF method (seconds a
   field, the same seed's bits again);
20. multi-GPU ranks (``[dist]``), each part a
   ``python -m torch.distributed.run --standalone`` launch of this script
   as ``--dist-worker`` (or of the CLI) under a timeout, a failed rank
   failing the phase: (a) one NCCL rank, the CRF headline (768 chains x
   512^2, 200 steps) through ``MultiChainSampler(mesh=
   global_chains_mesh())``, traces and final state bitwise the same farm
   without a mesh; (b) two gloo ranks sharing card 0
   (``local_device_ids=[0]``), one launch for (b) and (c): the CRF
   headline int-seeded and with 768
   seeds, and the SGS headline (512 chains, 2.15 GB of state) int-seeded,
   200 steps each, the gathered traces bitwise the one-rank farm's and
   every chain's final state by bit checksums, each rank's us a step, the
   gather's ms a segment and its kernels once a step; (c) the row-sharded
   grid on the same two ranks: ``make_sharded_crf_chain`` on the native
   900 x 900 problem for 1000 steps and ``make_sharded_crf_chains`` at 768
   chains x 512^2 for 100, each against grid 1 on the card under the JAX
   package's gates (accepted steps equal, loss rtol 1e-5, bed rtol 1e-5 /
   atol 1e-3), with the collectives a step and us a step; (d) ``torchrun
   --nproc-per-node 2 -m mcmc_tpu_torch`` on a spherical SGS config (64
   chains) to 400, re-invoked to 600 on 2 ranks (the
   ``checkpoint_600.proc{0,1}of2.npz`` set and its ``.ok`` marker), then
   to 800 on 1 rank, bitwise an uninterrupted 1-rank 800.  Each part's
   seconds are printed;
21. the tutorial workflow (``[examples]``, last): ``examples/torch_port``
   01 -> 09, each through its ``main(device="cuda")`` in this process at
   its default scale, into one ``chip_smoke_*`` directory under the
   checkout (03's checkpoint and beds are 04's and 05's inputs): T1's
   CSV; T2's variogram fits and two SGS beds at 96^2; T3's 8-chain CRF
   farm (4,000 iterations at 256^2, the window and noise kernels once a
   step); T4's seed-listed SGS farm (the draw kernel and the four SGS
   kernels once a step); 05's diagnostics from 03's checkpoint; 06's
   convergence validation at its production scale (256 chains x 512^2,
   60,000 CRF then 8,000 SGS iterations: its five checks, its STATS line
   and each stage's chain-it/s, the window and noise kernels once a CRF
   step, extract, writeback, mixture CG and LUT once an SGS step); 07 on
   the native 900 x 900 grid (the window kernel once a step; a resume on
   another grid refused); 08 through the CLI in a subprocess (resumed
   bitwise); 09 as two gloo ranks on card 0 under torchrun (the same
   global trace, the sharded checkpoint set reassembled).  Each line
   gives the example's launches and seconds;
22. the segment scan (``[graph]``, after phase 9): ``run_chains`` on the
   card replays one captured CUDA graph of ``CHUNK_STEPS`` steps
   (``mcmc_tpu_torch/parallel/sampler.py``), and every phase above runs
   through it.  Here each farm runs twice in this process from cloned
   states and cloned random sources, once on ``run_chains_eager`` (the
   plain loop) and once captured, over 58 steps (a warm-up, a capture,
   replays and an eager rest) then 200: the CRF headline int- and
   list-seeded, the SGS headline int- and list-seeded, the spherical SGS
   farm and the SRF farm, then ``ChainCRF.run`` / ``ChainSGS.run`` at one
   chain.  Gated bitwise: traces, final states and the generator's state
   or the per-chain step; each kernel's count equal to the steps both
   ways (a replay adds what its capture counted), and what a capture
   counted read back from the graph itself: a ``keep_graph`` capture's
   DOT dump holds, for each counted dispatcher, as many kernel nodes of
   its ``__global__`` functions as the capture counted launches, and
   none of a dispatcher it did not count.  Printed for each: µs a step
   both ways, the idle share of 50 profiled steps both ways, capture ms,
   graph nodes a step by kind, the added peak memory and the memory the
   farm's graph holds (given back when it is dropped), for the single
   chains what a finished call still holds; then a sweep of the chunk
   length (10, 25, 50, 100 steps: capture ms, µs a replayed step), from
   which ``CHUNK_STEPS`` is set.  No gain is claimed;
23. convergence diagnostics on the card (``[diag]``, after phase 7): (a)
   is phases 5's and 7's (every key of ``sampler.diagnostics`` of the
   main paths' own traces against the same call with ``device="cpu"``,
   within rtol 1e-4); (b) traces at production length made from a seed
   with numpy, an AR(1) stream (phi 0.99) held over MH-like rejections
   at 0.3 acceptance: a 768 x 100,001 loss trace with its step trace and
   a 256 x 20,000 x 8 probes trace; each of the six functions (on the
   loss trace; ``acceptance_rate`` on the steps) and
   ``sampler.diagnostics`` (on all three) from card tensors: card
   seconds (a warm call, then the median of 3, each ended by
   ``torch.cuda.synchronize()``), peak device memory above the start,
   agreement with ``device="cpu"`` (rtol 1e-4) and the CPU's seconds, one
   call at full length and one on a 20,000-iteration cut; (c)
   ``rank_normalized_rhat`` of iid normals at 2000 x 6000 and 1536 x
   8000 on the card, finite and within 0.02 of 1; (d) one
   ``rank_normalized_rhat`` call at (b)'s size under ``torch.profiler``:
   its device ops, and a single device-to-host copy, the result's, last.

The problems are ``bench.py``'s headlines (its ``build_problem``,
``make_chain`` and ``make_sgs_chain``): Matérn nu=1.3 CRF_weight
proposals with block menu 50-80 in 5 steps; and the SGS chain at the
reference's production settings (blocks 5-20, 48 neighbours within
30 km, detrend, 1000-quantile normal-score transform, Matérn nu=1.3,
10 km).  The second-to-last line is a JSON object describing the seven
kernels, the per-chain draw kernel and the SRF kernel: each one's
launches on the path that runs it (counts set to 0 just before the path
and read just after; the draw kernel's over phase 14's SGS list-seeded
runs, whose draw plan its times are from; the SRF kernel's over phase
19's main path, its times from the headline case), its error against its plain version, its
time, the plain version's, the least time the card could take for the
same work (``bound_ms``: the bytes the function must move at
3.35 TB/s or its float32 operations at 67 TFLOP/s, whichever is larger;
the SRF kernel's its 3xTF32 products at 495 TFLOP/s)
and, where one PyTorch call computes the same function, that call's
time.  Phases 16-21 run last and count their own launches, so the line's
``launches`` are those of the paths above (the SRF kernel's its own).  The last line is the JSON
contract ``{"ok": true, "device": ...}``.
"""

import contextlib
import dataclasses
import functools
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

DEVICE = "cuda"  # every phase runs on the card (phase_device insists)
GRID = 512
N_CHAINS = 768
SIGMA_MC = 5.0
RES = 500.0
PARITY_STEPS = 20
SEGMENTS = 3
SEGMENT = 500
SGS_CHAINS = 512
SGS_PARITY_STEPS = 10
SGS_SEGMENTS = 3
SGS_SEGMENT = 400
KERNEL_SOURCES = ("window_kernel", "sgs_window_kernel", "cg_kernel",
                  "lut_kernel", "noise_kernel", "chain_draws", "srf_kernel")
NOISE_SEEDS = 10         # phase 8's launches per timed loop
SPH_PARITY_STEPS = 10
K96 = 96                 # [cg-k96]: neighbours of the wide SGS chain
K96_STEPS = 3
WINDOW_EDGE = ((45, 67, 37), (45, 64, 37))  # [sgs-window-edge]: H, W, SB
ENTRY_SGS_ITERS = (400, 600)  # phase 11a: run, then resume to
ENTRY_SEGMENT = 200
ENTRY_CRF_ITERS = 300
DRAW_STEPS = 10          # [draws]: recorded steps of the per-chain draws
# [independence]: steps of each pair of farms (SGS: the 399 of [run]'s
# ChainSGS.run(400)), and the loss values printed of each
SEED_STEPS = {"crf": 50, "sgs": 399}
SEED_PRINTED = 50
SUM_TRIALS = 20          # [independence]: random fields a shape
SEED_RATE_STEPS = {"crf": 300, "sgs": 200}  # [seeds]: timed steps a run
ENTRY_LIST_ITERS = (400, 600)  # [entry-list]: run, then resume to
RUN_ITERS = {"crf": 1000, "sgs": 400}  # [run]: each single-chain run
RUN_INFO = 100           # [run]: info_per_iter of the observed run
RUN_KERNEL_STEPS = 10    # [run]: recorded steps of the one-chain kernels
RUN_PROFILE_STEPS = 50   # [run]: profiled single-chain steps
COLLECT_RUNS = {"crf": (301, 100), "sgs": (201, 100)}  # n_iter, segment
GEO_KW = dict(radius=50e3, num_points=32, chunk=64, half_window=40)
GEO_SEED = 11            # [geostats]: the first bed's seed
GEO_CUT = 128            # [geostats]: the card-vs-CPU cut of the grid
GEO_PROFILE_CHUNKS = 20
GEO_MATERN_S = 1.3       # [geostats]: the bounded Matérn bed (the reference's)
# the runtime calls by which Python launches device work (profiler events)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
                "cudaGraphLaunch")
GEO_FARM_STEPS = 50
SRF_PARITY_STEPS = 10    # [srf]: the SRF step on its kernels vs plain
SRF_SEGMENTS, SRF_SEGMENT = 2, 150  # [srf]: the SRF farm's main path
SRF_SEED_STEPS = 50      # [srf]: the seed-listed pair's steps
SRF_ENTRY_ITERS = (200, 300)  # [srf]: CLI run, then resume to
SRF_FIELD = 512          # [srf]: get_random_field's grid side
SRF_FIELDS = 5           # [srf]: fields timed
DIAG_LOSS = (768, 100_001)     # [diag] (b): loss trace, chains x iterations
DIAG_PROBES = (256, 20_000, 8)  # [diag] (b): probes trace, ... x probes
DIAG_CPU_ITERS = 20_000        # [diag] (b): the cut also timed on the CPU
DIAG_PHI = 0.99                # [diag] (b): the AR(1) stream's coefficient
DIAG_ACCEPT = 0.3              # [diag] (b): MH-like acceptance
DIAG_SEED = 17
DIAG_TIMED = 3                 # [diag] (b): timed card calls after a warm one
DIAG_RTOL = 1e-4               # card vs CPU: the same ranks and quantiles,
                               # float32 sums and FFTs in another order
DIAG_IID = ((2000, 6000), (1536, 8000))  # [diag] (c): chains x samples
DIAG_IID_ATOL = 0.02
DIAG_FUNCTIONS = ("split_rhat", "ess", "rank_normalized_rhat", "ess_bulk",
                  "ess_tail", "acceptance_rate")
ROOT = Path(__file__).resolve().parent
# (wrapper, source under mcmc_tpu_torch/ops/csrc, the Pallas kernel it
# replaces): every function of the JAX package that reaches pallas_call
KERNELS = (
    ("fused_window_update", "window_kernel.cu",
     "mcmc_tpu/ops/window_kernel.py:60"),
    ("window_extract", "sgs_window_kernel.cu",
     "mcmc_tpu/ops/sgs_window_kernel.py:67"),
    ("window_writeback", "sgs_window_kernel.cu",
     "mcmc_tpu/ops/sgs_window_kernel.py:151"),
    ("mix_masked_cg", "cg_kernel.cu", "mcmc_tpu/ops/cg_kernel.py:232"),
    ("masked_cg", "cg_kernel.cu", "mcmc_tpu/ops/cg_kernel.py:184"),
    ("lut_interp", "lut_kernel.cu", "mcmc_tpu/ops/lut_kernel.py:97"),
    ("batched_normal", "noise_kernel.cu", "mcmc_tpu/ops/noise_kernel.py:80"),
    # the port's own kernel: the seed-listed farms' per-chain draws, which
    # the JAX package makes with jax.random (no pallas_call) at this site
    ("chain_draws", "chain_draws.cu", "mcmc_tpu/models/chain_sgs.py:874"),
    # the port's own kernel: the gstools-SRF proposal's harmonic sum, which
    # the JAX package computes with XLA ops (no pallas_call) at this site
    ("srf_harmonics", "srf_kernel.cu", "mcmc_tpu/ops/srf.py:121"),
)

# kernel vs plain version bounds
FLIP_RATE_MAX = 1e-3     # MH decisions that differ (f32 sums in another order)
DELTA_REL_MAX = 1e-4     # delta error relative to the block loss it sums
FIELD_RTOL, FIELD_ATOL = 5e-5, 1e-3
EDGE_SIZES = (50, 80)    # block sides forced onto the domain's edges
HBM_GBS = 3350           # H100 SXM device-memory bandwidth (data sheet)
F32_TFLOPS = 67          # H100 SXM float32 peak outside the tensor cores
SM_COUNT = 132           # H100 SXM streaming multiprocessors
SM_IPC = 4               # warp instructions an SM issues a clock
TF32_TFLOPS = 495        # H100 SXM dense TF32 tensor-core peak
IRFFT_REL_MAX = 1e-5     # card vs a float64 transform, relative to field rms
SLEEP_CYCLES = 50_000_000  # ~25 ms of device spin ahead of a timed loop
# SGS kernels vs plain versions
CG_RTOL = CG_ATOL = 2e-4  # same sums in the same order; expf may round apart
CG_F64_TOL = 2e-3        # kernel run to convergence vs a float64 solve
CG_F64_CHAINS = 16       # the sample of chains solved in float64
CG_CONVERGED_ITERS = 512  # the production 64 stop short of convergence
LUT_ULP_MAX = 1
RESID_RTOL, RESID_ATOL = 2e-3, 2e-2  # patched vs full-grid residual
# noise kernel vs plain version: the same Philox words and transform;
# logf / sinf / cosf against PyTorch's CUDA log / sin / cos
NOISE_ATOL = 1e-5
NOISE_CAP = 5.8872       # sqrt(-2 ln 2^-25) = sqrt(50 ln 2), the tail cap
NOISE_CORR_MAX = 0.08    # largest cross-chain |corr| over 64 chains
NOISE_MOMENT_TOL = 0.01  # |mean| and |std - 1| of all the normals
NOISE_ODD_SHAPE = (5, 18, 7)  # 63 pairs a chain: odd
# geostats: the data honoured as tests/test_geostats.py:38 holds the JAX
# package; the bounds to rounding; the card against the CPU, the same
# picks and draws with float32 kriging solves apart
GEO_DATA_ATOL = 1.0      # m
GEO_BOUND_ATOL = 1e-3    # m
GEO_CPU_ATOL = 5e-2      # m
# the SRF kernel, a separable product that never rounds the phase a + b,
# on a unit-variance field of 1000 modes: (i) within SRF_ATOL of the
# float64 field on the unrounded a + b (testing.srf_separable_float64),
# the 3xTF32 products', sincosf's and float32 sums' rounding; (ii) within
# the phase rounding's per-cell bound (testing.srf_rounding_bound) plus
# SRF_ATOL of the plain version, which rounds a + b as the JAX package
# does, in every case, the Exponential's 1e8-rad phases included
SRF_ATOL = 2e-5
SRF_TIMED = 5            # [srf]: launches a timed loop


def build_problem(H=GRID, W=GRID, res=RES, seed=0):
    """The synthetic ice stream of bench.py's headline (seeded numpy)."""
    rng = np.random.default_rng(seed)
    x = np.arange(W) * res
    y = np.arange(H) * res
    xx, yy = np.meshgrid(x, y)
    Lx, Ly = W * res, H * res
    bed_true = 300 * np.sin(2 * np.pi * xx / (Lx / 3)) * np.cos(
        2 * np.pi * yy / (Ly / 3)) - 400
    surf = 1800 + 0.3e-3 * xx + 150 * np.sin(2 * np.pi * yy / Ly)
    velx = 150 + 80 * np.sin(2 * np.pi * yy / Ly)
    vely = 30 * np.cos(2 * np.pi * xx / Lx)
    thick = surf - bed_true
    smb = (np.gradient(velx * thick, res, axis=1)
           + np.gradient(vely * thick, res, axis=0))
    dhdt = np.zeros_like(xx)
    grounded = np.ones((H, W), bool)
    region = np.zeros((H, W), np.float32)
    region[20:-20, 20:-20] = 1
    data_mask = rng.random((H, W)) < 0.005
    cond_bed = np.where(data_mask, bed_true, np.nan)
    initial_bed = np.minimum(bed_true + rng.normal(0, 100, (H, W)), surf - 5)
    return dict(xx=xx, yy=yy, surf=surf, velx=velx, vely=vely, dhdt=dhdt,
                smb=smb, grounded=grounded, region=region,
                data_mask=data_mask, cond_bed=cond_bed,
                initial_bed=initial_bed, resolution=res)


def make_chain(p):
    from mcmc_tpu_torch import (BlockMenuConfig, ChainCRF, RandFieldConfig,
                                WeightConfig)

    chain = ChainCRF(p["xx"], p["yy"], p["initial_bed"], p["surf"],
                     p["velx"], p["vely"], p["dhdt"], p["smb"],
                     p["cond_bed"], p["data_mask"], p["grounded"],
                     p["resolution"])
    chain.set_update_region(True, p["region"])
    chain.set_loss_type(sigma_mc=SIGMA_MC, massConvInRegion=True)
    chain.configure_randfield(
        RandFieldConfig(10e3, 50e3, 10e3, 50e3, scale_min=50, scale_max=150,
                        nugget_max=0.0, model_name="Matern", isotropic=True,
                        smoothness=1.3),
        BlockMenuConfig(50, 80, 50, 80, steps=5),
        WeightConfig(L=2, x0=0, k=6, offset=1, max_dist=30e3, resolution=RES))
    chain.set_update_type("CRF_weight")
    return chain


def make_sgs_chain(p):
    """The SGS chain at bench.py's production configuration
    (smallScaleChain_multiprocessing.py:403-585: blocks 5-20,
    set_sgs_param(48, 30e3), detrend + 1000-quantile transform)."""
    from scipy.ndimage import gaussian_filter

    from mcmc_tpu_torch import ChainSGS, NormalScoreTransform

    chain = ChainSGS(p["xx"], p["yy"], p["initial_bed"], p["surf"],
                     p["velx"], p["vely"], p["dhdt"], p["smb"],
                     p["cond_bed"], p["data_mask"], p["grounded"],
                     p["resolution"])
    chain.set_update_region(True, p["region"])
    chain.set_loss_type(sigma_mc=SIGMA_MC, massConvInRegion=True)
    trend = gaussian_filter(p["initial_bed"], sigma=10).astype(np.float32)
    chain.set_trend(trend, detrend_map=True)
    nst = NormalScoreTransform.fit((p["initial_bed"] - trend).ravel(), 1000)
    chain.set_normal_transformation(nst, do_transform=True)
    chain.set_variogram("Matern", 10e3, 1.0, 0.0, vario_smoothness=1.3)
    chain.set_sgs_param(48, 30e3)
    chain.set_block_sizes(5, 20, 5, 20)
    return chain


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "the port's main path needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{name} | count {torch.cuda.device_count()}", flush=True)
    return card, name


def phase_build():
    from mcmc_tpu_torch.ops.cuda_build import load_libraries

    t0 = time.perf_counter()
    libs = load_libraries(KERNEL_SOURCES)
    print(f"[build] {len(libs)} sources in parallel: "
          f"{time.perf_counter() - t0:.2f} s wall", flush=True)
    for name, kl in libs.items():
        print(f"[build] {kl.path.name}: nvcc {kl.build_seconds:.2f} s",
              flush=True)
        for line in kl.ptxas:
            print(f"[build]   {line}", flush=True)
        if not any("Used" in line for line in kl.ptxas):
            raise RuntimeError(f"nvcc printed no ptxas resource line for "
                               f"{name}")
        counts = _sass_counts(kl.path)
        print(f"[build]   SASS instructions (static, cuobjdump): "
              + (", ".join(f"{k} {v}" for k, v in counts.items())
                 or "not measured (no cuobjdump)"), flush=True)


def _sass_listing(lib_path):
    """{mangled kernel name: its SASS instruction lines} of a built
    library, from the toolkit's cuobjdump; {} where the toolkit has
    none."""
    from mcmc_tpu_torch.ops.cuda_build import find_nvcc

    tool = Path(find_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    out = subprocess.run([str(tool), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    listing, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            listing[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            listing[name].append(line)
    return listing


def _sass_counts(lib_path):
    """{mangled kernel name: instructions in its SASS} of a built library;
    {} where the toolkit has no cuobjdump."""
    return {k: len(v) for k, v in _sass_listing(lib_path).items()}


# A thread's work for PROBE_CALLS normal calls of chain_draws.cu's kernel
# under one key schedule, and for one: each call a Philox call, both
# Box-Muller pairs and one 16-byte store.  Appended to the source so that
# it uses the kernel's own device functions (external linkage, so that
# nvcc keeps both).  Never launched: the difference of their SASS counts
# is the instructions a call needs past the prologue (key load, key
# schedule, step load) that a chain's calls share, for the kernel's bound
# by operations (``draw_call_instructions``).
PROBE_CALLS = 4
DRAW_PROBE = r"""
template <int kN>
__device__ __forceinline__ void probe_calls(const uint2* __restrict__ keys,
                                            const long long* __restrict__ step,
                                            float4* __restrict__ out) {
  const Keys k = key_schedule(keys[blockIdx.x]);
  const unsigned long long s = (unsigned long long)step[0];
  uint4 w[kN];
#pragma unroll
  for (int c = 0; c < kN; ++c)
    w[c] = philox4x32_10(make_uint4((uint32_t)s, 12u,
                                    threadIdx.x + c * blockDim.x,
                                    (uint32_t)(s >> 32)), k);
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    float c0, s0, c1, s1;
    box_muller(w[c].x, w[c].y, c0, s0);
    box_muller(w[c].z, w[c].w, c1, s1);
    out[(blockIdx.x * kN + c) * blockDim.x + threadIdx.x] =
        make_float4(c0, s0, c1, s1);
  }
}
extern "C" __global__ void probe_normal_calls_1(const uint2* keys,
                                                const long long* step,
                                                float4* out) {
  probe_calls<1>(keys, step, out);
}
extern "C" __global__ void probe_normal_calls_n(const uint2* keys,
                                                const long long* step,
                                                float4* out) {
  probe_calls<PROBE_CALLS>(keys, step, out);
}
"""


def build_draw_source(tag, text):
    """Build ``text``, a version of ``chain_draws.cu``, with the port's
    flags into the build directory as ``libchain_draws_<tag>.so``;
    returns (library typed by ``bind_library``, path, ptxas lines)."""
    import ctypes

    from mcmc_tpu_torch.ops.chain_draws import bind_library
    from mcmc_tpu_torch.ops.cuda_build import (BUILD_DIR, NVCC_FLAGS,
                                               _ptxas_lines, find_nvcc)

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = BUILD_DIR / f"chain_draws_{tag}.cu"
    cu.write_text(text)
    out = BUILD_DIR / f"libchain_draws_{tag}.so"
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(out),
                           str(cu)], capture_output=True, text=True,
                          check=False)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on chain_draws ({tag}):\n"
                           + proc.stdout + proc.stderr)
    return (bind_library(ctypes.CDLL(str(out))), out,
            _ptxas_lines(proc.stdout + proc.stderr))


def _hot_path(lines):
    """(instructions a call issues, all to the first EXIT) of a
    straight-line kernel's SASS ``lines``: those to the first EXIT less
    each region that a conditional forward branch skips where the region
    touches local memory or calls out (the math library's slow paths:
    sincosf's Payne-Hanek reduction, which t = 2 pi u2 < 2 pi never takes,
    and sqrtf's special cases)."""
    rows = []
    for line in lines:
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(.*?);", line)
        if m:
            rows.append((int(m.group(1), 16), m.group(2)))
    end = next((i for i, (_, text) in enumerate(rows) if "EXIT" in text),
               len(rows) - 1) + 1
    rows = rows[:end]
    skipped = set()
    for addr, text in rows:
        m = re.match(r"@!?U?P\w+\s+BRA\s+(?:`\()?0x([0-9a-f]+)", text)
        if not m or int(m.group(1), 16) <= addr:
            continue
        region = [i for i, (a, _) in enumerate(rows)
                  if addr < a < int(m.group(1), 16)]
        if any(re.search(r"\b(LDL|STL|CALL)", rows[i][1]) for i in region):
            skipped.update(region)
    return end - len(skipped), end


def draw_call_instructions():
    """SASS instructions a normal call of the draw kernel needs past the
    prologue its chain's calls share: the DRAW_PROBE kernels built from
    this checkout's source, each counted to its first EXIT without the
    slow paths it never takes (``_hot_path``), (PROBE_CALLS calls less
    one call) / (PROBE_CALLS - 1).  Returns (that, the one-call probe's
    count, prologue included).  Raises where the toolkit has no
    cuobjdump: the bound by operations is not guessed."""
    from mcmc_tpu_torch.ops.cuda_build import CSRC

    _, path, _ = build_draw_source(
        "probe", (CSRC / "chain_draws.cu").read_text()
        + DRAW_PROBE.replace("PROBE_CALLS", str(PROBE_CALLS)))
    listing = _sass_listing(path)
    hot = {}
    for tag in ("1", "n"):
        lines = next((v for k, v in listing.items()
                      if f"probe_normal_calls_{tag}" in k), None)
        if lines is None:
            raise RuntimeError("no SASS of the draw probe (cuobjdump "
                               "missing?): the draw kernel's bound by "
                               "operations cannot be counted")
        hot[tag] = _hot_path(lines)[0]
    return (hot["n"] - hot["1"]) / (PROBE_CALLS - 1), hot["1"]


def max_sm_clock_hz():
    """The card's maximum SM clock, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]
    return float(out) * 1e6


def draw_bound(n_chains, plan, per_call, clock_hz):
    """(ms, "bytes" or "operations", bytes ms, operations ms) of one
    draw-kernel launch: its bytes (``_plan_bytes``) at 3.35 TB/s, and its
    normal entries' Philox calls at ``per_call`` SASS instructions each
    (``draw_call_instructions``; the few index and uniform calls left
    out) at the card's issue rate: 4 warp instructions a clock on each of
    132 SMs at ``clock_hz``."""
    normal_calls = sum(-(-e.count // 4) for e in plan.entries
                       if e.kind == "normal")
    bytes_ms = _plan_bytes(n_chains, plan) / (HBM_GBS * 1e9) * 1e3
    ops_ms = (n_chains * normal_calls * per_call / 32
              / (SM_IPC * SM_COUNT * clock_hz) * 1e3)
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes", bytes_ms, ops_ms
    return ops_ms, "operations", bytes_ms, ops_ms


def _block_sums(values, mask, geom):
    """Per chain, the float64 sum of the NaN-safe squares of ``values``
    (N, H, W) over the chain's block and ``mask`` (H, W)."""
    import torch

    H, W = values.shape[-2:]
    dev = values.device
    g = geom.long()
    r = torch.arange(H, device=dev)
    c = torch.arange(W, device=dev)
    rows = (r[None] >= g[:, 0:1]) & (r[None] < g[:, 1:2])
    cols = (c[None] >= g[:, 2:3]) & (c[None] < g[:, 3:4])
    out = torch.zeros(values.shape[0], dtype=torch.float64, device=dev)
    for i in range(0, values.shape[0], 128):  # bound the temporaries
        m = rows[i:i + 128, :, None] & cols[i:i + 128, None, :] & mask[None]
        sq = torch.nan_to_num(values[i:i + 128].double() ** 2, nan=0.0)
        out[i:i + 128] = torch.where(m, sq, 0.0).sum(dim=(1, 2))
    return out


def _block_losses(fields_old, geom, consts):
    """Per chain, the block's old mc loss (the size of the sums a delta is
    the difference of), in nats."""
    return (_block_sums(fields_old[:, 1], consts.mc_mask, geom)
            / (2.0 * consts.sigma_mc ** 2))


def _window_bytes(geom, acc, H, W, n_const=6):
    """Bytes one launch of the window op must move, each input byte once:
    the const planes over the distinct cells the launch covers (surf,
    velx and vely over the windows, the block and its one-cell ring
    clipped to the grid; the rest over the blocks); per chain its bed
    over the window, its old residual over the block and its raw (h, w)
    proposal, and on accept the resample count read and the three state
    planes written over the block; each edge mask the launch uses, once,
    over its (h, w); geom, fvals and the three outputs."""
    g = geom.cpu().numpy().astype(np.int64)
    bx0, bx1, by0, by1 = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
    r0, r1 = np.maximum(bx0 - 1, 0), np.minimum(bx1 + 1, H)
    c0, c1 = np.maximum(by0 - 1, 0), np.minimum(by1 + 1, W)
    block = np.maximum(bx1 - bx0, 0) * np.maximum(by1 - by0, 0)
    window = np.where(block > 0, (r1 - r0) * (c1 - c0), 0)
    hw = g[:, 6] * g[:, 7]
    const = (3 * _covered_cells(r0, r1, c0, c1, H, W)
             + (n_const - 3) * _covered_cells(bx0, bx1, by0, by1, H, W))
    masks = dict(zip(g[:, 8].tolist(), hw.tolist()))
    accepted = acc.cpu().numpy() > 0
    per_chain = window + block + hw + 4 * block * accepted
    return 4.0 * float(const + per_chain.sum() + sum(masks.values())
                       + g.shape[0] * (9 + 6 + 3))


def _bound(bytes_moved=0.0, flops=0.0, peak_tflops=F32_TFLOPS):
    """(ms, "bytes" or "operations"): the least time the card could take
    for work that moves ``bytes_moved`` and does ``flops`` operations, at
    3.35 TB/s and ``peak_tflops`` (float32 outside the tensor cores, 67
    TFLOP/s, unless given)."""
    t_bytes = bytes_moved / (HBM_GBS * 1e9) * 1e3
    t_ops = flops / (peak_tflops * 1e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _cg_work(N, K, n_iters, build_per_entry, bytes_in):
    """(bytes, flops) of one CG launch: per iteration a K x K matvec
    (2K^2), two dot products and three axpys (~10K); the system's build
    costs ``build_per_entry`` operations a matrix entry.  ``bytes_in``
    per chain, plus w written."""
    flops = N * (n_iters * (2 * K * K + 10 * K) + build_per_entry * K * K)
    return N * (bytes_in + 4 * K), flops


def _covered_cells(r0, r1, c0, c1, H, W):
    """Distinct cells of an (H, W) grid that the rectangles [r0, r1) x
    [c0, c1) cover: the cells of a shared plane a launch must read once."""
    cover = np.zeros((H, W), bool)
    for a, b, c, d in zip(r0.tolist(), r1.tolist(), c0.tolist(),
                          c1.tolist()):
        cover[a:b, c:d] = True
    return int(cover.sum())


def extract_bytes(sx, sy, SB, H, W):
    """Bytes one window extract must move: the state windows and the
    distinct const cells they cover read, the (N, 14, SB, SB) windows
    written, the starts read."""
    N = sx.shape[0]
    covered = _covered_cells(sx.cpu(), sx.cpu() + SB, sy.cpu(),
                             sy.cpu() + SB, H, W)
    return 4.0 * (N * 4 * SB * SB + 10 * covered + N * 14 * SB * SB) + 8 * N


def writeback_bytes(write, SB):
    """Bytes one window writeback must move: the written chains' windows
    read and written back; the starts and write flags read."""
    return 4.0 * 2 * int(write.sum()) * 4 * SB * SB + 9 * write.shape[0]


def _time_ops(fn, ops):
    """Mean ms per launch of ``fn(*op)`` over the recorded operands in
    turn, from CUDA events, after one warm-up launch.  The card first
    spins for ~25 ms (``torch.cuda._sleep``) so that the host queues the
    launches ahead of it and the events time the device's back-to-back
    work rather than the host's launch rate; a plain version whose many
    small launches outrun that head start is timed in part on the host."""
    import torch

    fn(*ops[0])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for op in ops:
        fn(*op)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(ops)


def _clone_state(state):
    """A copy of a chain state whose tensors share nothing with it."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(state)})


def _pair_times(plain, kernel, recorded):
    """Mean ms per launch of the plain version and the kernel over the
    recorded operands, timed in turn: plain, kernel, kernel, plain."""
    t = {"plain": [], "kernel": []}
    for which, fn in (("plain", plain), ("kernel", kernel),
                      ("kernel", kernel), ("plain", plain)):
        t[which].append(_time_ops(fn, recorded))
    return float(np.mean(t["plain"])), float(np.mean(t["kernel"]))


def phase_kernel_vs_plain(chain, card):
    import torch

    from mcmc_tpu_torch.models.chain_crf import (draw, init_state, propose,
                                                 window_operands)
    from mcmc_tpu_torch.ops.window_kernel import (
        fused_window_update, fused_window_update_reference,
        window_kernel_info)
    from mcmc_tpu_torch.utils.rng import make_generator

    dev = torch.device(DEVICE)
    static, consts = chain.build(dev)
    state = init_state(chain.initial_bed, consts, N_CHAINS)
    gen = make_generator(1, dev)
    n_dec = n_flip = 0
    delta_rel = field_err = 0.0
    field_viol = 0
    ops = []  # each step's operands, replayed below
    events = []  # each step's (kernel, plain) launches on its own state
    for _ in range(PARITY_STEPS):
        d = draw(gen, static, consts, N_CHAINS)
        f = propose(static, consts, d).contiguous()
        cx = consts.region_cells[d.cidx, 0]
        cy = consts.region_cells[d.cidx, 1]
        geom, fvals = window_operands(static, consts, state, d.size_idx,
                                      d.scale, cx, cy, d.u)
        old = state.fields.clone()
        plain = old.clone()
        args = (consts.rf.edge_masks, geom, fvals)
        # the two 2.4 GB copies above are still running, so the host
        # queues the launches between the events ahead of the device, and
        # they leave the L2 cold, as the main path's step does
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        acc_k, dk, ddk = fused_window_update(consts.stacked, state.fields, f,
                                             *args)
        ev[1].record()
        acc_p, dp, ddp = fused_window_update_reference(consts.stacked, plain,
                                                       f, *args)
        ev[2].record()
        events.append(ev)
        same = acc_k == acc_p
        n_dec += N_CHAINS
        n_flip += int((~same).sum())
        scale = _block_losses(old, geom, consts)
        err = (dk.double() - dp.double()).abs() / (scale + dp.double().abs()
                                                   + 1e-12)
        delta_rel = max(delta_rel, float(err[same].max()))
        diff = (state.fields - plain).abs()[same]
        field_err = max(field_err, float(diff.max()))
        field_viol += int((diff > FIELD_ATOL
                           + FIELD_RTOL * plain[same].abs()).sum())
        # the chains advance on the kernel's result
        state.loss_mc = state.loss_mc + dk
        state.loss_data = state.loss_data + ddk
        ops.append((f, geom, fvals, acc_k))
    flip_rate = n_flip / n_dec
    print(f"[parity] {PARITY_STEPS} steps x {N_CHAINS} chains: accept flips "
          f"{n_flip}/{n_dec} = {flip_rate:.3e} (bound {FLIP_RATE_MAX:g}) | "
          f"max delta err / block loss {delta_rel:.3e} (bound "
          f"{DELTA_REL_MAX:g}) | field max abs err {field_err:.3e}, "
          f"{field_viol} cells beyond rtol {FIELD_RTOL:g} / atol "
          f"{FIELD_ATOL:g}", flush=True)
    if flip_rate > FLIP_RATE_MAX or delta_rel > DELTA_REL_MAX or field_viol:
        raise RuntimeError("CUDA window kernel disagrees with its plain "
                           "version")

    _window_edges(static, consts, state, gen, card)

    # the times on the steps' own state, with their own accept decisions
    # (the plain version's partly the host's); the first step, which
    # loads the module, left out
    ms = float(np.mean([e[0].elapsed_time(e[1]) for e in events[1:]]))
    plain_ms = float(np.mean([e[1].elapsed_time(e[2]) for e in events[1:]]))
    n_acc = int(sum(float(op[3].sum()) for op in ops))
    # and back to back over the recorded operands, plain / kernel / kernel
    # / plain, into a copy of the last state: its accept decisions differ
    scratch = state.fields.clone()
    recorded = [(consts.stacked, scratch, f, consts.rf.edge_masks, geom,
                 fvals) for f, geom, fvals, _ in ops]
    n_acc_replay = int(sum(float(fused_window_update(*op)[0].sum())
                           for op in recorded))
    replay_plain_ms, replay_ms = _pair_times(fused_window_update_reference,
                                             fused_window_update, recorded)
    moved = float(np.mean([_window_bytes(geom, acc, GRID, GRID)
                           for _, geom, _, acc in ops]))
    gbs = moved / (ms * 1e-3) / 1e9
    bound_ms, bound_by = _bound(moved)
    B = static.rf.B
    info = window_kernel_info(B)
    print(f"[parity] launch at B={B}: {info['threads']} threads, "
          f"{info['dynamic_shared_bytes']} B dynamic + "
          f"{info['static_shared_bytes']} B static shared memory, "
          f"{info['registers']} registers and {info['local_bytes']} B local "
          f"memory a thread, {info['resident_ctas_per_sm']} resident CTAs a "
          f"multiprocessor (cudaOccupancyMaxActiveBlocksPerMultiprocessor)",
          flush=True)
    print(f"[parity] time per launch at {N_CHAINS} chains x {GRID}^2, "
          f"B={B}, on the parity steps' own state ({n_acc} of {n_dec} "
          f"chains accepting), each launch after the state copies (a cold "
          f"L2, as on the main path): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms ({card}; CUDA events around each, "
          f"{len(events) - 1} launches) | kernel {gbs:.0f} GB/s = "
          f"{gbs / HBM_GBS:.3f} of {HBM_GBS} GB/s | bound {bound_ms:.4f} ms "
          f"({moved / 1e6:.1f} MB, each input byte once) = "
          f"{bound_ms / ms:.3f} of the kernel's time", flush=True)
    print(f"[parity] back to back over the same operands into a copy of "
          f"the last state (the shared planes warm in L2; {n_acc_replay} of {n_dec} chains "
          f"accepting): kernel {replay_ms:.4f} ms, plain "
          f"{replay_plain_ms:.4f} ms ({len(ops)} launches x 2 each)",
          flush=True)
    return dict(max_abs_err=field_err, ms=ms, plain_ms=plain_ms,
                flip_rate=flip_rate, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def _window_edges(static, consts, state, gen, card):
    """The window kernel against its plain version with blocks forced onto
    the domain's edges and corners, where the window is clipped, the
    stencil one-sided and the offsets negative (``mcmc_tpu_torch.testing.
    edge_window_operands``: every cell updated and in the mc mask, radar
    data at 5 % of the cells, NaN in surf and in the data at a few edge
    cells; the first chain's state); with and without the data loss and
    a prefinished proposal.  The same bounds as the headline parity."""
    import torch

    from mcmc_tpu_torch.models.chain_crf import draw, propose
    from mcmc_tpu_torch.ops.window_kernel import (
        fused_window_update, fused_window_update_reference)
    from mcmc_tpu_torch.testing import edge_window_operands

    stacked, old, geom, n_cases = edge_window_operands(
        consts, state.fields, EDGE_SIZES, N_CHAINS)
    loss_prev = (state.loss_mc + state.loss_data)[:1].expand(N_CHAINS)
    sigma_data = 20.0
    mc_scale = (_block_sums(old[:, 1], stacked[4] >= 2.0, geom)
                / (2.0 * consts.sigma_mc ** 2))
    data_scale = (_block_sums(old[:, 0] - stacked[6], stacked[7] > 0, geom)
                  / (2.0 * sigma_data ** 2))
    n_dec = n_flip = field_viol = nan_diff = n_acc = 0
    delta_rel = 0.0
    for use_data_loss in (False, True):
        for prefinished in (False, True):
            d = draw(gen, static, consts, N_CHAINS)
            f = propose(static, consts, d).contiguous()
            fvals = torch.stack([
                d.u, loss_prev, torch.full_like(loss_prev, consts.sigma_mc),
                torch.full_like(loss_prev, consts.resolution),
                torch.full_like(loss_prev, sigma_data), d.scale], dim=1)
            args = (f, consts.rf.edge_masks, geom, fvals)
            kw = dict(use_data_loss=use_data_loss, prefinished=prefinished)
            fk, fp = old.clone(), old.clone()
            acc_k, dk, ddk = fused_window_update(stacked, fk, *args, **kw)
            acc_p, dp, ddp = fused_window_update_reference(stacked, fp, *args,
                                                           **kw)
            same = acc_k == acc_p
            n_dec += N_CHAINS
            n_flip += int((~same).sum())
            n_acc += int(acc_p.sum())
            for got, want, scale in ((dk, dp, mc_scale),
                                     (ddk, ddp, data_scale)):
                err = (got.double() - want.double()).abs() / (
                    scale + want.double().abs() + 1e-12)
                delta_rel = max(delta_rel, float(err[same].max()))
            a, b = fk[same], fp[same]
            nan_a, nan_b = torch.isnan(a), torch.isnan(b)
            nan_diff += int((nan_a != nan_b).sum())
            ok = ~(nan_a | nan_b)
            field_viol += int(((a - b).abs()[ok] > FIELD_ATOL
                               + FIELD_RTOL * b[ok].abs()).sum())
            del fk, fp, a, b
    flip_rate = n_flip / n_dec
    print(f"[parity-edge] blocks on every domain edge and corner ({n_cases} "
          f"geometries over {N_CHAINS} chains, h, w in {EDGE_SIZES}; NaN in "
          f"surf and data), with and without the data loss and prefinished: "
          f"{n_acc}/{n_dec} accepted, flips {n_flip} = {flip_rate:.3e} (bound "
          f"{FLIP_RATE_MAX:g}) | max delta err / block loss {delta_rel:.3e} "
          f"(bound {DELTA_REL_MAX:g}) | {field_viol} cells beyond rtol "
          f"{FIELD_RTOL:g} / atol {FIELD_ATOL:g}, {nan_diff} NaN cells "
          f"differ ({card})", flush=True)
    if (flip_rate > FLIP_RATE_MAX or delta_rel > DELTA_REL_MAX or field_viol
            or nan_diff or not 0 < n_acc < n_dec):
        raise RuntimeError("CUDA window kernel disagrees with its plain "
                           "version at the domain's edges")


def phase_irfft2(chain):
    import torch

    from mcmc_tpu_torch.ops.spectral import (_rfreq_grid_np,
                                             half_spectrum_noise,
                                             spectral_density,
                                             spectral_field_from_noise)
    from mcmc_tpu_torch.utils.rng import make_generator

    dev = torch.device(DEVICE)
    static, _ = chain.build(dev)
    rf = static.rf
    shape = (rf.B, rf.B)
    gen = make_generator(2, dev)
    # the half-spectrum noise is not Hermitian along the kx = 0 and Nyquist
    # columns, where a C2R transform may project it its own way
    noise = half_spectrum_noise(gen, N_CHAINS, shape, dev)
    rx = torch.empty(N_CHAINS, device=dev).uniform_(10e3, 50e3,
                                                    generator=gen)

    def field(nz, r):
        return spectral_field_from_noise(nz, shape, rf.resolution,
                                         rf.model_name, r, r, rf.smoothness)

    gpu = field(noise, rx).cpu().double()
    cpu = field(noise.cpu(), rx.cpu()).double()
    r64 = rx.cpu().double()[:, None, None]
    k64 = torch.from_numpy(_rfreq_grid_np(shape, rf.resolution)).double()
    s64 = spectral_density(rf.model_name, k64, r64, r64, rf.smoothness)
    exact = torch.fft.irfft2(noise.cpu().to(torch.complex128)
                             * torch.sqrt(s64), s=shape)
    rms = exact.square().mean(dim=(1, 2), keepdim=True).sqrt()

    def err(x):
        return float(((x - exact).abs() / rms).max())

    card, host = err(gpu), err(cpu)
    print(f"[irfft2] proposal fields from the same noise ({N_CHAINS} x "
          f"{rf.B}^2) against a float64 CPU transform, max |err| / field "
          f"rms: card (cuFFT) {card:.3e}, CPU (float32) {host:.3e} (bound "
          f"{IRFFT_REL_MAX:g})", flush=True)
    if not card <= IRFFT_REL_MAX:
        raise RuntimeError("irfft2 on the card departs from the CPU's")


def phase_main_path(chain, card):
    import torch

    from mcmc_tpu_torch import MultiChainSampler
    from mcmc_tpu_torch.ops.noise_kernel import batched_normal
    from mcmc_tpu_torch.ops.window_kernel import fused_window_update

    kernels = (fused_window_update, batched_normal)
    torch.cuda.reset_peak_memory_stats()
    sampler = MultiChainSampler(chain, N_CHAINS, device=DEVICE)
    states = sampler.init(seeds=0)
    bed0 = states.bed[0].clone()
    n_iter = SEGMENTS * SEGMENT + 1
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, traces = sampler.run(states, n_iter, segment_size=SEGMENT,
                                 progress=False)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    steps = n_iter - 1
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    loss = traces["loss"]
    acc = float(np.mean(traces["step"][:, 1:]))
    outside = ~(sampler.consts.update_mask > 0)
    moved = int((states.bed[:, outside] != bed0[outside]).sum())
    diag = diag_card_vs_cpu("[main] CRF", sampler, traces, elapsed, card)
    print(f"[main] {steps} steps x {N_CHAINS} chains in {elapsed:.3f} s: "
          f"{diag['chain_iters_per_sec']:,.0f} chain-it/s | ESS(loss) "
          f"{diag['ess_loss']:.1f} -> {diag['ess_per_sec']:.2f} ESS/s | "
          f"acc {acc:.3f} | loss mean {loss[:, 0].mean():.6e} -> "
          f"{loss[:, -1].mean():.6e} | peak memory {peak_gb:.2f} GB | "
          f"launches {launches} ({card})", flush=True)
    for name, n in launches.items():
        if n != steps:
            raise RuntimeError(f"{name} ran {n} times in {steps} steps")
    if not np.isfinite(loss).all():
        raise RuntimeError("non-finite loss on the main path")
    if not loss[:, -1].mean() < loss[:, 0].mean():
        raise RuntimeError("the loss did not decrease")
    if not 0.02 < acc < 0.98:
        raise RuntimeError(f"acceptance {acc:.3f} outside (0.02, 0.98)")
    if moved:
        raise RuntimeError(f"{moved} bed cells outside the update region "
                           "changed")
    if tuple(loss.shape) != (N_CHAINS, n_iter):
        raise RuntimeError(f"loss trace shape {loss.shape}")
    busy_share(sampler, states, card, elapsed / steps * 1e6)
    return launches


def _ulps(a, b):
    """Per element, how many float32 steps apart two finite float32 CPU
    tensors are."""
    import torch

    def line(t):  # sign-magnitude bit patterns onto a monotone integer line
        i = t.contiguous().view(torch.int32).numpy().astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(line(a) - line(b))


def _cg_vs_float64(tag, solve, S64, prep, cg_iters, card):
    """A CG kernel on the first ``CG_F64_CHAINS`` chains' packed systems
    against a float64 solve of each masked subsystem: run to convergence
    (``CG_CONVERGED_ITERS``) it must agree within ``CG_F64_TOL``; the
    production iteration count's distance is printed beside it.
    ``solve(n_iters)`` runs the kernel on those chains; ``S64`` is their
    (n, K, K) system matrix in float64, before the mask and the diagonal."""
    import torch

    w_conv, w_prod = solve(CG_CONVERGED_ITERS), solve(cg_iters)
    worst_conv = worst_prod = 0.0
    for i in range(S64.shape[0]):
        sel = prep.sel[i]
        A = S64[i][sel][:, sel] + prep.eps * torch.eye(
            int(sel.sum()), dtype=torch.float64, device=S64.device)
        w64 = torch.linalg.solve(A, prep.rhs_p[i][sel].double())
        scale = CG_F64_TOL + CG_F64_TOL * w64.abs()
        worst_conv = max(worst_conv, float(
            ((w_conv[i][sel].double() - w64).abs() / scale).max()))
        worst_prod = max(worst_prod, float(
            ((w_prod[i][sel].double() - w64).abs() / w64.abs().max()).max()))
    print(f"[{tag}] CG kernel vs a float64 solve on {S64.shape[0]} chains' "
          f"systems: run {CG_CONVERGED_ITERS} iterations, worst |err| / "
          f"(atol + rtol |w|) = {worst_conv:.3f} (bound 1 at {CG_F64_TOL:g})"
          f" | at the production {cg_iters} iterations, worst |err| / max "
          f"|w| = {worst_prod:.3e} ({card})", flush=True)
    if not worst_conv <= 1.0:
        raise RuntimeError(f"[{tag}] the CG kernel does not solve the "
                           "packed system")


def _mix_cg_vs_float64(static, prep, card):
    """``_cg_vs_float64`` for the mixture CG: the float64 system is the
    mixture evaluated at the packed neighbours' offsets."""
    from mcmc_tpu_torch.ops.cg_kernel import mix_masked_cg
    from mcmc_tpu_torch.ops.covariance import eval_mixture_static

    n = CG_F64_CHAINS
    iaf, jaf, m, rhs = [t[:n].contiguous() for t in (
        prep.iaf, prep.jaf, prep.m_sel, prep.rhs_p)]
    q = static.mix[4]
    dif = iaf[:, :, None] - iaf[:, None, :]
    djf = jaf[:, :, None] - jaf[:, None, :]
    S = eval_mixture_static(static.mix, q[0] * djf * djf + q[1] * djf * dif
                            + q[2] * dif * dif)

    def solve(n_iters):
        return mix_masked_cg(iaf, jaf, m, rhs, prep.eps, static.mix, n_iters)

    _cg_vs_float64("sgs-parity", solve, S.double(), prep, static.cg_iters,
                   card)


def _sgs_kernel_steps(static, consts, state, gen, n_steps, card,
                      f64=False):
    """``n_steps`` SGS steps through the step's stages with each of the
    four kernels beside its plain version on the same operands, the state
    advancing on the kernels' results; ``gen`` a generator or per-chain
    streams (advanced a step at a time).  Returns (state, max abs errors,
    counts (CG values beyond rtol/atol, MH flips against a plain step from
    the same state and draws, LUT values that differ and their largest
    ulp distance), each kernel's recorded operands, and (bytes, flops)
    each launch must move and do).  ``f64``: the first step's CG also
    against a float64 solve."""
    import torch

    from mcmc_tpu_torch.models import chain_sgs as sgs
    from mcmc_tpu_torch.ops.cg_kernel import (mix_masked_cg,
                                              mix_masked_cg_reference)
    from mcmc_tpu_torch.ops.lut_kernel import (lut_interp,
                                               lut_interp_reference)
    from mcmc_tpu_torch.ops.sgs_window_kernel import (
        window_extract, window_extract_reference, window_writeback,
        window_writeback_reference)
    from mcmc_tpu_torch.utils.rng import PerChainStreams

    N, SB, nst = state.fields.shape[0], static.SB, consts.nst
    plain_step = sgs.make_sgs_kernel(static, "eager")
    err = dict(extract=0.0, writeback=0.0, cg=0.0, lut=0.0)
    cg_viol = n_flip = n_lut_diff = 0
    lut_ulp = 0
    ops = dict(extract=[], writeback=[], cg=[], lut=[])
    work = dict(extract=[], writeback=[], cg=[], lut=[])  # (bytes, flops)
    K, H, W = static.K, static.H, static.W
    table_bytes = 4 * nst.inv_table.numel()
    for it in range(n_steps):
        d = sgs.draw(gen, static, consts, N)
        draws = (d.cx, d.cy, d.bsx, d.bsy, d.noise, d.drop_u, d.u)
        _, tr_plain = plain_step(consts, _clone_state(state), *draws)

        geo = sgs.window_start(static, d.cx, d.cy, d.bsx, d.bsy)
        sx, sy = geo.sx32, geo.sy32
        win = window_extract(consts.stacked, state.fields, sx, sy, SB)
        win_p = window_extract_reference(consts.stacked, state.fields, sx,
                                         sy, SB)
        err["extract"] = max(err["extract"],
                             float((win - win_p).abs().max()))
        if not torch.equal(win, win_p):
            raise RuntimeError("window extract kernel is not bitwise")
        prep = sgs.prepare(static, consts, win, geo, d.noise, d.drop_u)
        cg_args = (prep.iaf, prep.jaf, prep.m_sel, prep.rhs_p, prep.eps,
                   static.mix, static.cg_iters)
        w = mix_masked_cg(*cg_args)
        w_p = mix_masked_cg_reference(*cg_args)
        diff = (w - w_p).abs()
        err["cg"] = max(err["cg"], float(diff.max()))
        cg_viol += int((diff > CG_ATOL + CG_RTOL * w_p.abs()).sum())
        if it == 0 and f64:
            _mix_cg_vs_float64(static, prep, card)
        z_new, z_cache = sgs.draw_z(static, consts, prep, w, d.noise)
        args = (z_new, nst.inv_lo, nst.inv_scale, nst.inv_table)
        inv = lut_interp(*args)
        inv_p = lut_interp_reference(*args)
        if not torch.equal(torch.isnan(inv), torch.isnan(inv_p)):
            raise RuntimeError("LUT kernel disagrees on NaN")
        ok = ~torch.isnan(inv_p)
        err["lut"] = max(err["lut"], float((inv - inv_p)[ok].abs().max()))
        n_lut_diff += int((inv != inv_p)[ok].sum())
        lut_ulp = max(lut_ulp, int(_ulps(inv[ok].cpu(),
                                         inv_p[ok].cpu()).max()))
        new_w, sc = sgs.commit_core(consts, state, prep, z_new, z_cache,
                                    inv, d.u)
        fields_p = state.fields.clone()
        window_writeback(state.fields, new_w, sx, sy, sc.write)
        window_writeback_reference(fields_p, new_w, sx, sy, sc.write)
        err["writeback"] = max(err["writeback"], float(
            (state.fields - fields_p).abs().max()))
        if not torch.equal(state.fields, fields_p):
            raise RuntimeError("window writeback kernel is not bitwise")
        del fields_p
        state, tr = sgs.assemble(consts, state, sc, d.cx, d.cy, d.bsx,
                                 d.bsy)
        n_flip += int((tr["step"] != tr_plain["step"]).sum())
        ops["extract"].append((consts.stacked, state.fields, sx, sy, SB))
        ops["writeback"].append((new_w, sx, sy, sc.write))
        ops["cg"].append(cg_args)
        ops["lut"].append(args)
        # bytes each function must move (the LUT's values in and out and
        # its table)
        work["extract"].append((extract_bytes(sx, sy, SB, H, W), 0.0))
        work["writeback"].append((writeback_bytes(sc.write, SB), 0.0))
        work["cg"].append(_cg_work(N, K, static.cg_iters,
                                   11 + 3 * (static.Mg + static.Me),
                                   4 * (4 * K + 1)))
        work["lut"].append((4.0 * 2 * N * SB * SB + table_bytes, 0.0))
        if isinstance(gen, PerChainStreams):
            gen.advance()
    stats = dict(cg_viol=cg_viol, n_flip=n_flip, n_lut_diff=n_lut_diff,
                 lut_ulp=lut_ulp)
    return state, err, stats, ops, work


def phase_sgs_kernels_vs_plain(chain, card):
    """The four SGS kernels against their plain versions through the
    step's stages, at the headline, the state advancing on the kernels'
    results; a plain step from the same state and draws counts the MH
    decisions that flip."""
    import torch

    from mcmc_tpu_torch.models import chain_sgs as sgs
    from mcmc_tpu_torch.ops.cg_kernel import (mix_masked_cg,
                                              mix_masked_cg_reference)
    from mcmc_tpu_torch.ops.lut_kernel import (lut_interp,
                                               lut_interp_reference)
    from mcmc_tpu_torch.ops.sgs_window_kernel import (
        window_extract, window_extract_reference, window_writeback,
        window_writeback_reference)
    from mcmc_tpu_torch.utils.rng import make_generator

    dev = torch.device(DEVICE)
    static, consts = chain.build(dev)
    if not (static.mix and static.use_transform):
        raise RuntimeError("the SGS headline must take the mixture CG and "
                           "the normal-score transform")
    print(f"[sgs-parity] SB {static.SB}, M {static.M}, K {static.K}, NE "
          f"{static.NE}, NA {static.NA}, Mg {static.Mg}, Me {static.Me}, "
          f"cg_iters {static.cg_iters}, n_region {static.n_region}, "
          f"inverse table {tuple(consts.nst.inv_table.shape)}", flush=True)
    N, SB = SGS_CHAINS, static.SB
    state = sgs.sgs_init_state(chain._initial_detrended, consts,
                               chain._initial_z, True, N)
    gen = make_generator(11, dev)
    state, err, stats, ops, work = _sgs_kernel_steps(
        static, consts, state, gen, SGS_PARITY_STEPS, card, f64=True)
    cg_viol, n_flip = stats["cg_viol"], stats["n_flip"]
    n_lut_diff, lut_ulp = stats["n_lut_diff"], stats["lut_ulp"]
    K = static.K
    flip_rate = n_flip / (SGS_PARITY_STEPS * N)
    n_lut = SGS_PARITY_STEPS * N * SB * SB
    print(f"[sgs-parity] {SGS_PARITY_STEPS} steps x {N} chains: extract and "
          f"writeback bitwise | CG max abs err {err['cg']:.3e}, {cg_viol} "
          f"values beyond rtol/atol {CG_RTOL:g} | LUT {n_lut_diff} of "
          f"{n_lut} values differ, at most {lut_ulp} ulp (bound "
          f"{LUT_ULP_MAX}) | MH flips against a plain step {n_flip}/"
          f"{SGS_PARITY_STEPS * N} = {flip_rate:.3e} (bound "
          f"{FLIP_RATE_MAX:g})", flush=True)
    if cg_viol or lut_ulp > LUT_ULP_MAX or flip_rate > FLIP_RATE_MAX:
        raise RuntimeError("an SGS kernel disagrees with its plain version")

    # times per launch over the recorded operands, plain / kernel /
    # kernel / plain; the writebacks go to a scratch copy of the state
    scratch = state.fields.clone()
    pairs = {
        "extract": (window_extract_reference, window_extract, ops["extract"]),
        "writeback": (lambda *a: window_writeback_reference(scratch, *a),
                      lambda *a: window_writeback(scratch, *a),
                      ops["writeback"]),
        "cg": (mix_masked_cg_reference, mix_masked_cg, ops["cg"]),
        "lut": (lut_interp_reference, lut_interp, ops["lut"]),
    }
    out = {}
    for name, (plain, kernel, recorded) in pairs.items():
        plain_ms, ms = _pair_times(plain, kernel, recorded)
        bound_ms, bound_by = _bound(*np.mean(work[name], axis=0))
        out[name] = dict(max_abs_err=err[name], ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=None)
        print(f"[sgs-parity] {name}: kernel {out[name]['ms']:.4f} ms, plain "
              f"{out[name]['plain_ms']:.4f} ms per launch at {N} chains x "
              f"{GRID}^2, SB={SB} | bound {bound_ms:.4f} ms by {bound_by} "
              f"({card}; CUDA events, {len(recorded)} launches x 2 each)",
              flush=True)
    _window_launches(N, consts.stacked.shape[0], state.fields.shape[1], SB,
                     out, card)
    _lut_launch_and_floor(ops["lut"], out["lut"], card)
    _cg_launch_and_split("sgs-parity", mix_masked_cg, ops["cg"], K, True,
                         out["cg"]["ms"], card)
    return out


def _lut_launch_and_floor(recorded, row, card):
    """The LUT kernel's launch as the CUDA runtime reports it, and the
    time of an empty kernel on the same grid, timed as the kernel was
    (the floor any launch of that grid pays)."""
    from mcmc_tpu_torch.ops.lut_kernel import empty_launch, lut_kernel_info

    info = lut_kernel_info(recorded[0][0])
    floor_ms = float(np.mean([_time_ops(
        lambda: empty_launch(info["ctas"]), [()] * len(recorded))
        for _ in range(2)]))
    print(f"[sgs-parity] lut launch: {info['ctas']} CTAs x "
          f"{info['threads']} threads, {info['registers']} registers, "
          f"{info['local_bytes']} local bytes, "
          f"{info['resident_ctas_per_sm']} resident CTAs an SM | an empty "
          f"kernel on the same grid {floor_ms:.4f} ms: the kernel "
          f"{row['ms']:.4f} ms is {row['ms'] / floor_ms:.2f}x the floor, "
          f"{row['ms'] / row['bound_ms']:.2f}x its {row['bound_ms']:.4f} ms "
          f"bound ({card}; CUDA events)", flush=True)


def _window_launches(N, NP, NS, SB, out, card):
    """Each window kernel's launch as the CUDA runtime reports it, beside
    its time per launch and share of the bound.  PyTorch's allocations
    are 32-byte aligned, so the writeback covers whole sectors where
    GRID % 8 == 0."""
    from mcmc_tpu_torch.ops.sgs_window_kernel import sgs_window_kernel_info

    writeback = "writeback_sectors" if GRID % 8 == 0 else "writeback_in_window"
    for name, kernel, planes in (("extract", "extract", NP + NS),
                                 ("writeback", writeback, NS)):
        info = sgs_window_kernel_info(kernel)
        r = out[name]
        print(f"[sgs-parity] window_{name} launch at SB={SB} ({kernel}): "
              f"{N} x {planes} = {N * planes} CTAs of {info['threads']} "
              f"threads, {info['registers']} registers and "
              f"{info['local_bytes']} B local memory a thread, "
              f"{info['resident_ctas_per_sm']} resident CTAs a "
              f"multiprocessor (cudaOccupancyMaxActiveBlocksPerMultiprocessor)"
              f" | {r['ms']:.4f} ms = {r['bound_ms'] / r['ms']:.3f} of its "
              f"{r['bound_ms']:.4f} ms bound ({card})", flush=True)


def phase_sgs_window_edges(card):
    """Both window kernels bitwise against their plain versions with an
    odd SB = 37 on the odd 45 x 67 grid (the writeback within the window)
    and on 45 x 64 (the full-sector writeback), the four clamped corners
    among the starts and a mixed write mask
    (``mcmc_tpu_torch.testing.sgs_window_operands``)."""
    import torch

    from mcmc_tpu_torch.ops.sgs_window_kernel import (
        window_extract, window_extract_reference, window_writeback,
        window_writeback_reference)
    from mcmc_tpu_torch.testing import sgs_window_operands

    same = {}
    for H, W, SB in WINDOW_EDGE:
        cons, fields, sx, sy, new_w, write = sgs_window_operands(
            H, W, SB, SGS_CHAINS, DEVICE)
        got = window_extract(cons, fields, sx, sy, SB)
        same[f"extract {H}x{W}"] = torch.equal(
            got, window_extract_reference(cons, fields, sx, sy, SB))
        k, p = fields.clone(), fields.clone()
        window_writeback(k, new_w, sx, sy, write)
        window_writeback_reference(p, new_w, sx, sy, write)
        same[f"writeback {H}x{W}"] = (torch.equal(k, p) and torch.equal(
            k[~write], fields[~write]))
        n_write = int(write.sum())
    print(f"[sgs-window-edge] SB {SB}, {SGS_CHAINS} chains, the four "
          f"clamped corners among the starts, {n_write} chains writing: "
          f"bitwise against the plain versions {same} ({card})", flush=True)
    if not all(same.values()):
        raise RuntimeError("a window kernel disagrees with its plain version "
                           "on the odd grid")


def _cg_launch_and_split(tag, kernel, recorded, K, mix, ms, card):
    """A CG kernel's launch as the CUDA runtime reports it, and its time
    per launch over the recorded operands (whose last item is the
    iteration count) at 0 iterations (the system's build or load and w)
    and at 1, beside ``ms`` at the recorded count."""
    from mcmc_tpu_torch.ops.cg_kernel import cg_kernel_info

    info = cg_kernel_info(K, mix=mix)
    print(f"[{tag}] {kernel.__name__} launch at K={K}: "
          f"{info['chains_per_cta']} chains ({info['threads']} threads) a "
          f"CTA, {info['dynamic_shared_bytes']} B dynamic + "
          f"{info['static_shared_bytes']} B static shared memory, "
          f"{info['registers']} registers and {info['local_bytes']} B local "
          f"memory a thread, {info['resident_ctas_per_sm']} resident CTAs = "
          f"{info['resident_warps_per_sm']} warps a multiprocessor "
          f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor)", flush=True)
    n_iters = recorded[0][-1]
    t0, t1 = (float(np.mean([_time_ops(kernel, [op[:-1] + (it,)
                                                for op in recorded])
                             for _ in range(2)])) for it in (0, 1))
    print(f"[{tag}] {kernel.__name__} per launch: 0 iterations {t0:.4f} ms "
          f"(the system's build or load, and w), 1 iteration {t1:.4f} ms, "
          f"{n_iters} iterations {ms:.4f} ms -> an iteration "
          f"{(t1 - t0) * 1e3:.3f} us (from 0 to 1), "
          f"{(ms - t0) / n_iters * 1e3:.3f} us (from 0 to {n_iters}) "
          f"({card}; CUDA events, {len(recorded)} launches x 2 each)",
          flush=True)


def phase_cg_k96(p, card):
    """An SGS chain with 96 neighbours (K = 96, three 32-row slots in the
    CG kernel) at the headline's width: the mixture CG kernel against its
    plain version on the chain's own packed systems, the state advancing
    on the kernel step, a plain step from the same state and draws
    flipping at most 1e-3 of the MH decisions."""
    import torch

    from mcmc_tpu_torch.models import chain_sgs as sgs
    from mcmc_tpu_torch.ops.cg_kernel import (mix_masked_cg,
                                              mix_masked_cg_reference)
    from mcmc_tpu_torch.utils.rng import make_generator

    dev = torch.device(DEVICE)
    chain = make_sgs_chain(p)
    chain.set_sgs_param(K96, 30e3)
    static, consts = chain.build(dev)
    if static.K != K96 or not static.mix:
        raise RuntimeError(f"the wide SGS chain has K = {static.K}, mixture "
                           f"{bool(static.mix)}")
    N = SGS_CHAINS
    state = sgs.sgs_init_state(chain._initial_detrended, consts,
                               chain._initial_z, True, N)
    kernel_step = sgs.make_sgs_kernel(static, "auto")
    plain_step = sgs.make_sgs_kernel(static, "eager")
    gen = make_generator(17, dev)
    err = 0.0
    viol = n_flip = 0
    before = mix_masked_cg.launches
    for _ in range(K96_STEPS):
        d = sgs.draw(gen, static, consts, N)
        draws = (d.cx, d.cy, d.bsx, d.bsy, d.noise, d.drop_u, d.u)
        _, tr_p = plain_step(consts, _clone_state(state), *draws)
        geo = sgs.window_start(static, d.cx, d.cy, d.bsx, d.bsy)
        win = sgs.window_extract(consts.stacked, state.fields, geo.sx32,
                                 geo.sy32, static.SB)
        prep = sgs.prepare(static, consts, win, geo, d.noise, d.drop_u)
        args = (prep.iaf, prep.jaf, prep.m_sel, prep.rhs_p, prep.eps,
                static.mix, static.cg_iters)
        w, w_p = mix_masked_cg(*args), mix_masked_cg_reference(*args)
        diff = (w - w_p).abs()
        err = max(err, float(diff.max()))
        viol += int((diff > CG_ATOL + CG_RTOL * w_p.abs()).sum())
        state, tr = kernel_step(consts, state, *draws)
        n_flip += int((tr["step"] != tr_p["step"]).sum())
    launches = mix_masked_cg.launches - before
    flip_rate = n_flip / (K96_STEPS * N)
    finite = bool(torch.isfinite(state.loss_mc).all())
    print(f"[cg-k96] SGS chain with {K96} neighbours: K {static.K}, SB "
          f"{static.SB}, cg_iters {static.cg_iters}, {K96_STEPS} steps x {N} "
          f"chains | mixture CG kernel vs plain: max abs err {err:.3e}, "
          f"{viol} values beyond rtol/atol {CG_RTOL:g} | MH flips against a "
          f"plain step {n_flip} = {flip_rate:.3e} (bound {FLIP_RATE_MAX:g}) "
          f"| kernel launches {launches} | loss finite {finite} ({card})",
          flush=True)
    if viol or flip_rate > FLIP_RATE_MAX or not finite or launches != (
            2 * K96_STEPS):
        raise RuntimeError("the K = 96 SGS chain departs from its plain "
                           "version on the card")


def _sgs_reach(region, static):
    """Cells some block can touch: the region's centre cells dilated by
    the largest half block."""
    from scipy.ndimage import maximum_filter

    size = (2 * (static.BMX // 2) + 1, 2 * (static.BMY // 2) + 1)
    return maximum_filter(np.asarray(region) > 0, size=size)


def phase_sgs_main_path(chain, p, card):
    import torch

    from mcmc_tpu_torch import MultiChainSampler
    from mcmc_tpu_torch.ops.cg_kernel import mix_masked_cg
    from mcmc_tpu_torch.ops.lut_kernel import lut_interp
    from mcmc_tpu_torch.ops.physics import (masked_gaussian_loss,
                                            mass_conservation_residual)
    from mcmc_tpu_torch.ops.sgs_window_kernel import (window_extract,
                                                      window_writeback)

    kernels = (window_extract, mix_masked_cg, lut_interp, window_writeback)
    torch.cuda.reset_peak_memory_stats()
    sampler = MultiChainSampler(chain, SGS_CHAINS, device=DEVICE)
    static, consts = sampler.static, sampler.consts
    if not (static.mix and static.use_transform):
        raise RuntimeError("the SGS main path must take the mixture CG and "
                           "the normal-score transform")
    states = sampler.init(seeds=0)
    bed0 = states.bed.clone()
    n_iter = SGS_SEGMENTS * SGS_SEGMENT + 1
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, traces = sampler.run(states, n_iter, segment_size=SGS_SEGMENT,
                                 progress=False)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    steps = n_iter - 1
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    loss = traces["loss"]
    acc = float(np.mean(traces["step"][:, 1:]))
    outside = torch.as_tensor(~_sgs_reach(p["region"], static),
                              device=states.bed.device)
    moved = int((states.bed[:, outside] != bed0[:, outside]).sum())
    del bed0
    # the patched residual against a float64 full-grid recompute
    c64 = consts.stacked.double()
    res_err = loss_err = 0.0
    res_viol = 0
    for i in range(0, SGS_CHAINS, 64):
        bed = states.bed[i:i + 64].double() + c64[5]
        full = mass_conservation_residual(bed, c64[0], c64[1], c64[2],
                                          c64[3], c64[4], consts.resolution)
        got = states.mc_res[i:i + 64].double()
        res_err = max(res_err, float((got - full).abs().max()))
        res_viol += int(((got - full).abs()
                         > RESID_ATOL + RESID_RTOL * full.abs()).sum())
        rec = masked_gaussian_loss(got, c64[7] > 0, consts.sigma_mc)
        loss_err = max(loss_err, float(
            ((states.loss_mc[i:i + 64].double() - rec).abs() / rec).max()))
    diag = diag_card_vs_cpu("[sgs-main] SGS", sampler, traces, elapsed,
                            card)
    print(f"[sgs-main] {steps} steps x {SGS_CHAINS} chains in "
          f"{elapsed:.3f} s: {diag['chain_iters_per_sec']:,.0f} chain-it/s | "
          f"ESS(loss) {diag['ess_loss']:.1f} -> {diag['ess_per_sec']:.2f} "
          f"ESS/s | acc {acc:.3f} | loss mean {loss[:, 0].mean():.6e} -> "
          f"{loss[:, -1].mean():.6e} | peak memory {peak_gb:.2f} GB | "
          f"launches {launches} ({card})", flush=True)
    print(f"[sgs-main] patched residual vs a float64 full-grid recompute: "
          f"max abs err {res_err:.3e}, {res_viol} cells beyond rtol "
          f"{RESID_RTOL:g} / atol {RESID_ATOL:g} | loss_mc vs its recompute "
          f"max rel err {loss_err:.3e} | bed cells beyond every block's "
          f"reach that moved: {moved}", flush=True)
    for name, n in launches.items():
        if n != steps:
            raise RuntimeError(f"{name} ran {n} times in {steps} steps")
    if not np.isfinite(loss).all():
        raise RuntimeError("non-finite loss on the SGS main path")
    if not loss[:, -1].mean() < loss[:, 0].mean():
        raise RuntimeError("the SGS loss did not decrease")
    if not 0.02 < acc < 0.98:
        raise RuntimeError(f"SGS acceptance {acc:.3f} outside (0.02, 0.98)")
    if moved:
        raise RuntimeError(f"{moved} bed cells beyond every block's reach "
                           "changed")
    if res_viol or not loss_err <= 1e-3:
        raise RuntimeError("the patched residual or loss departs from a "
                           "full-grid recompute")
    if tuple(loss.shape) != (SGS_CHAINS, n_iter):
        raise RuntimeError(f"loss trace shape {loss.shape}")
    busy_share(sampler, states, card, elapsed / steps * 1e6, top=10,
               watch=("lut_kernel",))
    return launches


def _rel_err(got, want):
    """Largest |got - want| / |want| over a value or an array (0 where both
    are 0; inf where only ``want`` is)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    diff = np.abs(got - want)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(diff == 0, 0.0, diff / np.abs(want))
    return float(rel.max()) if rel.size else 0.0


def diag_card_vs_cpu(tag, sampler, traces, elapsed, card):
    """[diag] (a): every key of ``sampler.diagnostics`` of a main path's
    own traces, on the card (the sampler's device) against the same call
    with ``device="cpu"``, within DIAG_RTOL; all finite.  Returns the
    card's summary."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = sampler.diagnostics(traces, elapsed)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = sampler.diagnostics(traces, elapsed, device="cpu")
    cpu_s = time.perf_counter() - t0
    errs = {k: _rel_err(got[k], want[k]) for k in want}
    finite = all(np.isfinite(v).all() for v in got.values())
    print(f"[diag] (a) {tag} traces {traces['loss'].shape}: "
          f"sampler.diagnostics on {sampler.device} {card_s:.3f} s (first "
          f"call), on the CPU {cpu_s:.3f} s | max rel err a key, card vs "
          f"CPU (rtol {DIAG_RTOL:g}): "
          f"{ {k: float(f'{e:.3g}') for k, e in errs.items()} } | finite "
          f"{finite} ({card})", flush=True)
    if set(got) != set(want) or not finite or not all(
            e <= DIAG_RTOL for e in errs.values()):
        raise RuntimeError(f"[diag] (a) {tag}: the card's diagnostics depart "
                           f"from the CPU's: {errs}, finite {finite}")
    return got


def mh_like_trace(rng, chains, iters, probes=()):
    """An AR(1) stream (coefficient DIAG_PHI) seen through MH-like
    rejections: a step accepts with probability DIAG_ACCEPT and otherwise
    holds its chain's last value.  Returns the chain-major float32 trace
    (chains, iters, *probes) and the accepted steps (chains, iters)."""
    shape = (iters, chains) + tuple(probes)
    noise = rng.standard_normal(shape, dtype=np.float32)
    accepted = rng.random((iters, chains)) < DIAG_ACCEPT
    held = ~accepted.reshape((iters, chains) + (1,) * len(probes))
    x = np.empty(shape, np.float32)
    x[0] = prop = noise[0]
    for t in range(1, iters):
        prop = np.float32(DIAG_PHI) * prop + noise[t]
        x[t] = np.where(held[t], x[t - 1], prop)
    return (np.ascontiguousarray(np.moveaxis(x, 0, 1)),
            np.ascontiguousarray(accepted.T))


def _card_seconds(fn):
    """``fn()`` on the card: one warm call, then the median seconds of
    DIAG_TIMED, each ended by ``torch.cuda.synchronize()``; the peak device
    memory above the start, the largest of the timed calls; the last
    result."""
    import torch

    fn()
    times, peak = [], 0
    for _ in range(DIAG_TIMED):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        peak = max(peak, torch.cuda.max_memory_allocated() - base)
    return float(np.median(times)), peak, out


def _cpu_seconds(fn):
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def _diag_input(traces, key, cut=None):
    """A diagnostic's input: the ``key`` trace, or the whole dict for
    ``sampler.diagnostics`` (``key`` None), its first ``cut`` iterations."""
    traces = {k: v[:, :cut] for k, v in traces.items()}
    return traces if key is None else traces[key]


def _diag_errs(got, want):
    if isinstance(want, dict):
        return {k: _rel_err(got[k], want[k]) for k in want}
    return {"": _rel_err(got, want)}


def _diag_copies(fn):
    """One call of ``fn`` under ``torch.profiler``: its device ops in
    order of start, the device busy us, and the indices of the
    device-to-host copies among them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = sorted(_device_events(prof.events()),
                 key=lambda e: e.time_range.start)
    busy = sum(e.time_range.elapsed_us() for e in ops)
    return ops, busy, [i for i, e in enumerate(ops) if "DtoH" in e.name]


def phase_diag(chain, card):
    """[diag] (b)-(d) (the docstring's phase 23): the six diagnostics and
    ``sampler.diagnostics`` at production length on the card, timed and
    held to the CPU; the JAX package's regression sizes; no early host
    copy."""
    import torch

    from mcmc_tpu_torch import MultiChainSampler
    from mcmc_tpu_torch.parallel import diagnostics as diag

    rng = np.random.default_rng(DIAG_SEED)
    t0 = time.perf_counter()
    loss, accepted = mh_like_trace(rng, *DIAG_LOSS)
    probes, _ = mh_like_trace(rng, *DIAG_PROBES[:2], DIAG_PROBES[2:])
    traces = {"loss": loss, "step": accepted, "samples": probes}
    print(f"[diag] (b) traces made on the host in "
          f"{time.perf_counter() - t0:.1f} s (seed {DIAG_SEED}): loss "
          f"{loss.shape}, steps at acceptance {accepted.mean():.4f}, probes "
          f"{probes.shape}", flush=True)
    on_card = {k: torch.as_tensor(v, device=DEVICE) for k, v in
               traces.items()}
    sampler = MultiChainSampler(chain, DIAG_LOSS[0], device=DEVICE)
    calls = {name: (getattr(diag, name),
                    "step" if name == "acceptance_rate" else "loss")
             for name in DIAG_FUNCTIONS}
    calls["sampler.diagnostics"] = (sampler.diagnostics, None)
    failed = []
    for name, (fn, key) in calls.items():
        card_in = _diag_input(on_card, key)
        sec, peak, got = _card_seconds(lambda: fn(card_in))
        cpu_s, want = _cpu_seconds(
            lambda: fn(_diag_input(traces, key), device="cpu"))
        cut_s, _ = _cpu_seconds(lambda: fn(
            _diag_input(traces, key, DIAG_CPU_ITERS), device="cpu"))
        errs = _diag_errs(got, want)
        finite = all(np.isfinite(v).all() for v in (
            got.values() if isinstance(got, dict) else [got]))
        print(f"[diag] (b) {name}: card {sec:.4f} s (median of "
              f"{DIAG_TIMED} after a warm call), peak {peak / 2**20:.1f} "
              f"MiB above the start | CPU {cpu_s:.2f} s (one call), "
              f"{cut_s:.2f} s at {DIAG_CPU_ITERS:,} iterations | max rel "
              f"err card vs CPU {max(errs.values()):.3g} (rtol "
              f"{DIAG_RTOL:g}) | finite {finite} ({card})", flush=True)
        if not finite or not all(e <= DIAG_RTOL for e in errs.values()):
            failed.append((name, errs, finite))
    for m, n in DIAG_IID:
        x = rng.standard_normal((m, n), dtype=np.float32)
        t0 = time.perf_counter()
        r = float(diag.rank_normalized_rhat(x, device=DEVICE))
        ok = np.isfinite(r) and abs(r - 1.0) <= DIAG_IID_ATOL
        print(f"[diag] (c) rank_normalized_rhat of iid normals {m} x {n} "
              f"({m * n:,} pooled) on the card: {r:.6f} in "
              f"{time.perf_counter() - t0:.3f} s (numpy in) | finite and "
              f"within {DIAG_IID_ATOL} of 1: {ok} ({card})", flush=True)
        if not ok:
            failed.append((f"iid {m} x {n}", r, ok))
    ops, busy, copies = _diag_copies(
        lambda: diag.rank_normalized_rhat(on_card["loss"]))
    kinds = {}
    for e in ops:
        kind = ("copy" if "Memcpy" in e.name else "memset"
                if "Memset" in e.name else "kernel")
        kinds[kind] = kinds.get(kind, 0) + 1
    early = not ops or copies != [len(ops) - 1]
    print(f"[diag] (d) rank_normalized_rhat({tuple(loss.shape)}) profiled: "
          f"{len(ops)} device ops {kinds}, busy {busy / 1e3:.2f} ms | "
          f"device-to-host copies at op {copies} of {len(ops)} "
          f"({[ops[i].name for i in copies]}) | an early host copy: "
          f"{early} ({card})", flush=True)
    if early:
        failed.append(("profile", copies, len(ops)))
    if failed:
        raise RuntimeError(f"[diag] failed: {failed}")


def phase_noise_vs_plain(chain, card):
    """The Philox noise kernel against its plain version at the CRF
    headline's half-spectrum shape (768 chains x 2B x (B/2 + 1))."""
    import torch

    from mcmc_tpu_torch.ops.noise_kernel import (batched_normal,
                                                 batched_normal_reference,
                                                 draw_seed)
    from mcmc_tpu_torch.utils.rng import make_generator

    dev = torch.device(DEVICE)
    static, _ = chain.build(dev)
    B = static.rf.B
    shape = (N_CHAINS, 2 * B, B // 2 + 1)
    gen = make_generator(21, dev)
    seeds = [draw_seed(gen, dev) for _ in range(NOISE_SEEDS)]
    err = 0.0
    n_far = n_diff = 0
    for seed in seeds:
        z = batched_normal(seed, *shape)
        want = batched_normal_reference(seed, *shape)
        diff = (z - want).abs()
        err = max(err, float(diff.max()))
        n_far += int((diff > NOISE_ATOL).sum())
        n_diff += int((z != want).sum())
    # an odd pair count takes the kernel's scalar stores
    odd_diff = int((batched_normal(seeds[0], *NOISE_ODD_SHAPE)
                    != batched_normal_reference(seeds[0], *NOISE_ODD_SHAPE)
                    ).sum())
    z = batched_normal(seeds[0], *shape)
    same = torch.equal(z, batched_normal(seeds[0], *shape))
    mean, std = float(z.mean()), float(z.std())
    zmax = float(z.abs().max())
    n_corr = min(64, shape[0])
    corr = torch.corrcoef(z[:n_corr].reshape(n_corr, -1).double())
    corr_max = float((corr - torch.eye(n_corr, dtype=corr.dtype,
                                       device=dev)).abs().max())
    recorded = [(seed,) + shape for seed in seeds]
    plain_ms, ms = _pair_times(batched_normal_reference, batched_normal,
                               recorded)
    lib_gen = make_generator(22, dev)
    library_ms = _time_ops(
        lambda: torch.randn(shape, generator=lib_gen, device=dev),
        [()] * NOISE_SEEDS)
    bound_ms, bound_by = _bound(4.0 * np.prod(shape) + 8)
    print(f"[noise] {NOISE_SEEDS} launches of {shape}: max |kernel - plain| "
          f"{err:.3e}, {n_far} values beyond {NOISE_ATOL:g} (bound 0), "
          f"{n_diff} of {NOISE_SEEDS * int(np.prod(shape))} not bitwise equal "
          f"(bound 0) | odd shape {NOISE_ODD_SHAPE}: {odd_diff} not bitwise "
          f"equal (bound 0) | "
          f"deterministic {same} | mean {mean:.3e}, std {std:.5f}, max |z| "
          f"{zmax:.4f} (cap {NOISE_CAP}) | largest cross-chain |corr| over "
          f"{n_corr} chains {corr_max:.4f} (bound {NOISE_CORR_MAX}) ({card})",
          flush=True)
    print(f"[noise] per launch: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.randn of the same shape {library_ms:.4f} ms (kernel / "
          f"torch.randn {ms / library_ms:.3f}) | bound {bound_ms:.4f} ms by "
          f"{bound_by} = {bound_ms / ms:.3f} of the kernel's time ({card}; "
          f"CUDA events)", flush=True)
    if (n_far or n_diff or odd_diff or not same
            or abs(mean) > NOISE_MOMENT_TOL
            or abs(std - 1.0) > NOISE_MOMENT_TOL or zmax > NOISE_CAP
            or corr_max >= NOISE_CORR_MAX):
        raise RuntimeError("the noise kernel disagrees with its plain "
                           "version or is not N(0, 1)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def phase_crf_step_vs_plain(chain, card):
    """The whole CRF step (noise kernel, cuFFT, window kernel) against the
    plain step (plain Philox, plain window op) from the same state and
    generator state, 20 steps, the chains advancing on the kernels'."""
    import torch

    from mcmc_tpu_torch.models.chain_crf import init_state, make_step
    from mcmc_tpu_torch.utils.rng import make_generator

    static, consts = chain.build(torch.device(DEVICE))
    fused = make_step(static, "auto")
    plain = make_step(static, "eager")
    state = init_state(chain.initial_bed, consts, N_CHAINS)
    gen = make_generator(5, DEVICE)
    n_flip = 0
    for _ in range(PARITY_STEPS):
        shadow = _clone_state(state)
        gen_p = torch.Generator(device=DEVICE)
        gen_p.set_state(gen.get_state())
        _, tr_p = plain(consts, shadow, gen_p)
        del shadow
        state, tr = fused(consts, state, gen)
        n_flip += int((tr["step"] != tr_p["step"]).sum())
    flip_rate = n_flip / (PARITY_STEPS * N_CHAINS)
    print(f"[crf-step] {PARITY_STEPS} steps x {N_CHAINS} chains against "
          f"the plain step (same draws): MH flips {n_flip} = "
          f"{flip_rate:.3e} (bound {FLIP_RATE_MAX:g}) ({card})", flush=True)
    if flip_rate > FLIP_RATE_MAX:
        raise RuntimeError("the CRF step on the kernels departs from the "
                           "plain one")


def make_spherical_chain(p):
    """The SGS headline with a spherical 10 km variogram: no mixture fit,
    so the packed solve gathers Sigma from the covariance stamp."""
    chain = make_sgs_chain(p)
    chain.set_variogram("Spherical", 10e3, 1.0, 0.0)
    return chain


def phase_masked_cg_vs_plain(chain, card):
    """The CG on a given Sigma against its plain version through 10 steps
    at the spherical SGS headline, the state advancing on the kernels'
    results; a plain step from the same state and draws counts the MH
    decisions that flip."""
    import torch

    from mcmc_tpu_torch.models import chain_sgs as sgs
    from mcmc_tpu_torch.ops.cg_kernel import masked_cg, masked_cg_reference
    from mcmc_tpu_torch.utils.rng import make_generator

    dev = torch.device(DEVICE)
    static, consts = chain.build(dev)
    print(f"[sph-parity] SB {static.SB}, K {static.K}, NE {static.NE}, NA "
          f"{static.NA}, Mg {static.Mg}, Me {static.Me}, cg_iters "
          f"{static.cg_iters}", flush=True)
    if static.Mg + static.Me != 0 or static.cg_iters != 48:
        raise RuntimeError("the spherical headline must take the given-Sigma "
                           "CG at 48 iterations")
    N, K = SGS_CHAINS, static.K
    state = sgs.sgs_init_state(chain._initial_detrended, consts,
                               chain._initial_z, True, N)
    kernel_step = sgs.make_sgs_kernel(static, "auto")
    plain_step = sgs.make_sgs_kernel(static, "eager")
    gen = make_generator(13, dev)
    err = 0.0
    viol = n_flip = 0
    recorded = []
    for it in range(SPH_PARITY_STEPS):
        d = sgs.draw(gen, static, consts, N)
        draws = (d.cx, d.cy, d.bsx, d.bsy, d.noise, d.drop_u, d.u)
        _, tr_p = plain_step(consts, _clone_state(state),
                             *draws)
        geo = sgs.window_start(static, d.cx, d.cy, d.bsx, d.bsy)
        win = sgs.window_extract(consts.stacked, state.fields, geo.sx32,
                                 geo.sy32, static.SB)
        prep = sgs.prepare(static, consts, win, geo, d.noise, d.drop_u)
        Sigma = sgs.stamp_sigma(static, consts, prep)
        args = (Sigma, prep.m_sel, prep.rhs_p, prep.eps, static.cg_iters)
        w = masked_cg(*args)
        w_p = masked_cg_reference(*args)
        diff = (w - w_p).abs()
        err = max(err, float(diff.max()))
        viol += int((diff > CG_ATOL + CG_RTOL * w_p.abs()).sum())
        if it == 0:
            n = CG_F64_CHAINS
            S, m, rhs = [t[:n].contiguous() for t in (Sigma, prep.m_sel,
                                                      prep.rhs_p)]
            _cg_vs_float64(
                "sph-parity",
                lambda n_iters: masked_cg(S, m, rhs, prep.eps, n_iters),
                S.double(), prep, static.cg_iters, card)
        recorded.append(args)
        state, tr = kernel_step(consts, state, *draws)
        n_flip += int((tr["step"] != tr_p["step"]).sum())
    flip_rate = n_flip / (SPH_PARITY_STEPS * N)
    print(f"[sph-parity] {SPH_PARITY_STEPS} steps x {N} chains: CG on a "
          f"given Sigma max abs err {err:.3e}, {viol} values beyond rtol/atol "
          f"{CG_RTOL:g} | MH flips against a plain step {n_flip} = "
          f"{flip_rate:.3e} (bound {FLIP_RATE_MAX:g})", flush=True)
    if viol or flip_rate > FLIP_RATE_MAX:
        raise RuntimeError("the given-Sigma CG kernel disagrees with its "
                           "plain version")
    plain_ms, ms = _pair_times(masked_cg_reference, masked_cg, recorded)
    solve_ms = _time_ops(_linalg_solve, [(a[0], a[1], a[2], a[3])
                                         for a in recorded])
    bound_ms, bound_by = _bound(*_cg_work(N, K, static.cg_iters, 4,
                                          4 * (K * K + 2 * K + 1)))
    print(f"[sph-parity] masked_cg: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms per launch at {N} chains, K={K}, {static.cg_iters} iterations "
          f"| bound {bound_ms:.4f} ms by {bound_by} | torch.linalg.solve of "
          f"the same masked systems to convergence (not the same function) "
          f"{solve_ms:.4f} ms ({card}; CUDA events, {len(recorded)} launches "
          f"x 2 each)", flush=True)
    _cg_launch_and_split("sph-parity", masked_cg, recorded, K, False, ms,
                         card)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def _linalg_solve(Sigma, m, rhs, eps):
    """The masked systems solved by ``torch.linalg.solve``: a note beside
    the fixed-iteration CG, which has no one-call counterpart."""
    import torch

    A = Sigma * m[:, :, None] * m[:, None, :]
    A = A + torch.diag_embed(eps + (1.0 - m))
    return torch.linalg.solve(A, m * rhs)


def _write_dataset(p, path):
    np.savez(path, **{k: p[k] for k in (
        "xx", "yy", "initial_bed", "surf", "velx", "vely", "dhdt", "smb",
        "cond_bed", "data_mask", "grounded", "region")},
        resolution=p["resolution"])


SPHERICAL = {"vtype": "Spherical", "range": 10e3, "sill": 1.0,
             "nugget": 0.0}
MATERN = {"vtype": "Matern", "range": 10e3, "sill": 1.0, "nugget": 0.0,
          "smoothness": 1.3}


def _sgs_config(n_iter, out, variogram=SPHERICAL, seeds=0):
    """``make_spherical_chain``'s configuration as a CLI config (or, with
    ``MATERN``, ``make_sgs_chain``'s), seeded by ``seeds``."""
    return {
        "family": "sgs", "dataset": "dataset.npz",
        "update_region": {"in_region": True, "mask": "region"},
        "loss": {"sigma_mc": SIGMA_MC, "mass_conv_in_region": True},
        "sgs": {
            "variogram": variogram,
            "params": {"num_neighbors": 48, "search_radius": 30e3},
            "blocks": {"min_x": 5, "max_x": 20, "min_y": 5, "max_y": 20},
            "trend": {"gaussian_sigma": 10.0},
            "normal_transform": {"n_quantiles": 1000}},
        "farm": {"n_chains": SGS_CHAINS, "n_iter": n_iter,
                 "rng_seeds": seeds,
                 "output_path": out, "segment_size": ENTRY_SEGMENT,
                 "checkpoint_every": ENTRY_SGS_ITERS[0]},
        "save": {"final_beds": f"{out}_beds.npy",
                 "histories": f"{out}_hist.npz"}}


def phase_entry_point(p, card):
    """The user's entry point at full width (module docstring, phase 11):
    the spherical SGS farm through the CLI, run, resumed and compared
    bitwise with an uninterrupted run; the CRF farm through the driver."""
    import torch

    from mcmc_tpu_torch.drivers import large_scale_chain_farm
    from mcmc_tpu_torch.ops.cg_kernel import masked_cg, mix_masked_cg
    from mcmc_tpu_torch.ops.lut_kernel import lut_interp
    from mcmc_tpu_torch.ops.sgs_window_kernel import (window_extract,
                                                      window_writeback)
    from mcmc_tpu_torch.ops.window_kernel import fused_window_update

    first, total = ENTRY_SGS_ITERS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT) as tmp:
        tmp = Path(tmp)
        _write_dataset(p, tmp / "dataset.npz")

        def cli_run(n_iter, out, *extra):
            return _cli_run(tmp, _sgs_config(n_iter, out), *extra)

        kernels = (window_extract, masked_cg, lut_interp, window_writeback)
        for k in kernels + (mix_masked_cg,):
            k.launches = 0
        t0 = time.perf_counter()
        cli_run(first, "resumed")
        t1 = time.perf_counter()
        cli_run(total, "resumed")
        t2 = time.perf_counter()
        cli_run(total, "straight")
        t3 = time.perf_counter()
        launches = {k.__name__: k.launches for k in kernels}
        steps = (first - 1) + (total - first) + (total - 1)
        info = cli_run(total, "resumed", "--info")
        same = {}
        with np.load(tmp / "resumed_hist.npz") as a, \
                np.load(tmp / "straight_hist.npz") as b:
            for key in a.files:
                same[key] = bool(np.array_equal(
                    a[key], b[key], equal_nan=a[key].dtype.kind == "f"))
            shape = a["loss"].shape
            loss = a["loss"]
            acc = float(np.mean(a["steps"][:, 1:]))
        same["final_beds"] = bool(np.array_equal(
            np.load(tmp / "resumed_beds.npy"),
            np.load(tmp / "straight_beds.npy")))
    print(f"[entry] SGS spherical, {SGS_CHAINS} chains x {GRID}^2 through "
          f"python -m mcmc_tpu_torch: {first} iterations {t1 - t0:.1f} s, "
          f"resumed to {total} {t2 - t1:.1f} s, uninterrupted {total} "
          f"{t3 - t2:.1f} s (each with its build and checkpoint writes) | "
          f"traces {shape}, acc {acc:.3f}, loss mean {loss[:, 0].mean():.6e}"
          f" -> {loss[:, -1].mean():.6e} | resumed == uninterrupted, bitwise: "
          f"{same} | launches {launches} in {steps} steps, mixture CG "
          f"{mix_masked_cg.launches} ({card})", flush=True)
    print("[entry] --info: " + " | ".join(info.strip().splitlines()),
          flush=True)
    if not all(same.values()):
        raise RuntimeError("the resumed farm departs from the uninterrupted "
                           "one")
    if shape != (SGS_CHAINS, total) or not np.isfinite(loss).all():
        raise RuntimeError(f"SGS traces {shape}, finite "
                           f"{np.isfinite(loss).all()}")
    if not loss[:, -1].mean() < loss[:, 0].mean():
        raise RuntimeError("the SGS loss did not decrease through the CLI")
    if any(n != steps for n in launches.values()) or mix_masked_cg.launches:
        raise RuntimeError(f"kernel launches {launches} in {steps} steps")
    if f"checkpoint @ iter {total}" not in info:
        raise RuntimeError("--info does not list the checkpoint")

    fused_window_update.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT) as tmp:
        t0 = time.perf_counter()
        results = large_scale_chain_farm(
            make_chain(p), N_CHAINS, rng_seeds=0, n_iter=ENTRY_CRF_ITERS,
            output_path=tmp, segment_size=ENTRY_CRF_ITERS, progress=False,
            quiet=True, device=DEVICE)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    crf_launches = fused_window_update.launches
    loss = np.stack([r[3] for r in results])
    beds = np.stack([r[0] for r in results])
    print(f"[entry] CRF, {N_CHAINS} chains x {GRID}^2 through "
          f"large_scale_chain_farm: {ENTRY_CRF_ITERS} iterations in "
          f"{elapsed:.1f} s with build and checkpoint | loss mean "
          f"{loss[:, 0].mean():.6e} -> {loss[:, -1].mean():.6e} | window "
          f"kernel launches {crf_launches} ({card})", flush=True)
    if crf_launches != ENTRY_CRF_ITERS - 1:
        raise RuntimeError(f"the window kernel ran {crf_launches} times")
    if loss.shape != (N_CHAINS, ENTRY_CRF_ITERS) or not (
            np.isfinite(loss).all() and np.isfinite(beds).all()):
        raise RuntimeError("non-finite CRF farm results")
    if not loss[:, -1].mean() < loss[:, 0].mean():
        raise RuntimeError("the CRF loss did not decrease through the driver")
    return launches["masked_cg"]


def _seed_list(n, first=1000):
    """A per-chain seed list: ``n`` consecutive ints."""
    return list(range(first, first + n))


def _family(chain):
    """(static, consts, draw, update, initial state of n chains) of a
    CRF or SGS chain on the card, ``update(consts, state, draws)`` the
    step's MH update on drawn values, as its ``make_step`` applies it."""
    from mcmc_tpu_torch.models import chain_crf as crf
    from mcmc_tpu_torch.models import chain_sgs as sgs

    static, consts = chain.build(DEVICE)
    if isinstance(chain, sgs.ChainSGS):
        kernel = sgs.make_sgs_kernel(static)

        def update(consts, state, d):
            return kernel(consts, state, d.cx, d.cy, d.bsx, d.bsy, d.noise,
                          d.drop_u, d.u)

        def init(n):
            return sgs.sgs_init_state(chain._initial_detrended, consts,
                                      chain._initial_z, True, n)

        return static, consts, sgs.draw, update, init
    kernel = crf.make_kernel(static)

    def update(consts, state, d):
        cx = consts.region_cells[d.cidx, 0]
        cy = consts.region_cells[d.cidx, 1]
        return kernel(consts, state, crf.propose(static, consts, d),
                      d.size_idx, d.scale, cx, cy, d.u)

    def init(n):
        return crf.init_state(chain.initial_bed, consts, n)

    return static, consts, crf.draw, update, init


def _draw_fields(d):
    """The tensors of a step's draws, by name."""
    return {f.name: getattr(d, f.name) for f in dataclasses.fields(d)
            if getattr(d, f.name) is not None}


def _plan_bytes(n_chains, plan):
    """Bytes one draw-kernel launch must move: each chain's key and the
    step read, every drawn value written once (4 bytes a uniform or
    normal, 8 an index)."""
    values = sum(e.count * (8 if e.kind == "index" else 4)
                 for e in plan.entries)
    return float(n_chains * (8 + values) + 8)


def phase_draws_vs_plain(crf_chain, sgs_chain, card):
    """The per-chain draw kernel against its plain version on each
    headline's draw plan (768 CRF chains, 512 SGS chains), and the keyed
    noise entry at 768 x 160 x 41, over DRAW_STEPS steps' counters:
    every value bitwise; both times per launch beside the launch floor
    (an empty kernel on the kernel's grid), the bound by bytes and by
    operations (``draw_bound``), and ``torch.rand`` and ``torch.randn``
    of the plan's values (uniforms, and the normals most of them are)."""
    import torch

    from mcmc_tpu_torch.models import chain_crf as crf
    from mcmc_tpu_torch.models import chain_sgs as sgs
    from mcmc_tpu_torch.ops.chain_draws import (SLOTS, cached_plan,
                                                chain_draws,
                                                chain_draws_info,
                                                chain_draws_reference,
                                                empty_draws_launch)
    from mcmc_tpu_torch.ops.noise_kernel import (
        batched_normal_keyed, batched_normal_keyed_reference)
    from mcmc_tpu_torch.utils.rng import PerChainStreams

    dev = torch.device(DEVICE)
    per_call, one_call = draw_call_instructions()
    clock_hz = max_sm_clock_hz()
    print(f"[draws] a normal call of the draw kernel: {per_call:g} SASS "
          f"instructions on its path past the shared prologue ({PROBE_CALLS}"
          f" calls under one key schedule less one, over "
          f"{PROBE_CALLS - 1}; one call with its prologue {one_call}; "
          f"cuobjdump) | max SM clock {clock_hz / 1e6:.0f} MHz ({card})",
          flush=True)
    steps = [torch.tensor([t], dtype=torch.int64, device=dev)
             for t in range(DRAW_STEPS - 1)] + [
        torch.tensor([(1 << 32) + 5], dtype=torch.int64, device=dev)]
    rows = {}
    for family, chain, n in (("crf", crf_chain, N_CHAINS),
                             ("sgs", sgs_chain, SGS_CHAINS)):
        static, consts = chain.build(dev)
        entries = (crf.draw_plan_entries(static) if family == "crf"
                   else sgs.draw_plan_entries(static, consts))
        plan = cached_plan(entries)
        keys = PerChainStreams.from_seeds(_seed_list(n), dev).keys
        n_diff = n_values = 0
        err = 0.0
        for step in steps:
            got = plan.views(*chain_draws(keys, step, plan))
            want = plan.views(*chain_draws_reference(keys, step, plan))
            for name, w in want.items():
                n_diff += int((got[name] != w).sum())
                n_values += w.numel()
                err = max(err, float((got[name].double()
                                      - w.double()).abs().max()))
        recorded = [(keys, step) for step in steps]
        plain_ms, ms = _pair_times(
            lambda k, t: chain_draws_reference(k, t, plan),
            lambda k, t: chain_draws(k, t, plan), recorded)
        floor_ms = _time_ops(lambda: empty_draws_launch(n, plan.calls),
                             [()] * DRAW_STEPS)
        lib_gen = torch.Generator(device=dev)
        lib_gen.manual_seed(23)
        library_ms = _time_ops(
            lambda: torch.rand((n, plan.floats), generator=lib_gen,
                               device=dev), [()] * DRAW_STEPS)
        normals = sum(e.count for e in plan.entries if e.kind == "normal")
        randn_ms = (_time_ops(
            lambda: torch.randn((n, normals), generator=lib_gen, device=dev),
            [()] * DRAW_STEPS) if normals else None)
        bound_ms, bound_by, bytes_ms, ops_ms = draw_bound(
            n, plan, per_call, clock_hz)
        info = chain_draws_info(n, plan.calls)
        randn = ("" if randn_ms is None else
                 f", torch.randn of ({n}, {normals}) {randn_ms:.4f} ms")
        print(f"[draws] {family} plan ({', '.join(f'{e.name} {e.kind} x'
                                               f'{e.count}'
                                               for e in plan.entries)}): "
              f"{n} chains, {plan.calls} Philox calls a chain, "
              f"{DRAW_STEPS} steps: {n_diff} of {n_values} values not "
              f"bitwise equal to the plain version (bound 0) | per launch: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, an empty "
              f"kernel on its grid {floor_ms:.4f} ms, torch.rand of "
              f"({n}, {plan.floats}) {library_ms:.4f} ms{randn} | bound "
              f"{bound_ms:.3e} ms by {bound_by} (bytes {bytes_ms:.3e} ms, "
              f"{_plan_bytes(n, plan):,.0f} B; operations {ops_ms:.3e} "
              f"ms) = {bound_ms / ms:.3f} of the kernel's time | launch "
              f"{info} ({card}; CUDA events)", flush=True)
        if n_diff:
            raise RuntimeError(f"the {family} draw kernel disagrees with "
                               "its plain version")
        rows[family] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=library_ms)

    # the keyed noise entry at the CRF headline's half-spectrum shape
    B = crf_chain.build(dev)[0].rf.B
    shape = (N_CHAINS, 2 * B, B // 2 + 1)
    keys = PerChainStreams.from_seeds(_seed_list(N_CHAINS), dev).keys
    slot = SLOTS["spectrum"]
    n_diff = 0
    for step in steps:
        n_diff += int((batched_normal_keyed(keys, step, slot, *shape[1:])
                       != batched_normal_keyed_reference(
                           keys, step, slot, *shape[1:])).sum())
    recorded = [(keys, step, slot) + shape[1:] for step in steps]
    plain_ms, ms = _pair_times(batched_normal_keyed_reference,
                               batched_normal_keyed, recorded)
    lib_gen = torch.Generator(device=dev)
    lib_gen.manual_seed(24)
    library_ms = _time_ops(
        lambda: torch.randn(shape, generator=lib_gen, device=dev),
        [()] * DRAW_STEPS)
    bound_ms, bound_by = _bound(4.0 * np.prod(shape) + 8 * N_CHAINS + 8)
    print(f"[draws] keyed noise {shape}, {DRAW_STEPS} steps: {n_diff} of "
          f"{DRAW_STEPS * int(np.prod(shape))} values not bitwise equal to "
          f"the plain version (bound 0) | per launch: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, torch.randn of the same shape "
          f"{library_ms:.4f} ms | bound {bound_ms:.4f} ms by {bound_by} = "
          f"{bound_ms / ms:.3f} of the kernel's time ({card}; CUDA events)",
          flush=True)
    if n_diff:
        raise RuntimeError("the keyed noise entry disagrees with its plain "
                           "version")
    return rows


def phase_independence(crf_chain, sgs_chain, card):
    """At each headline, a farm seeded with a list and a 1-chain farm
    seeded with its first seed, SEED_STEPS steps each on the kernels:
    chain 0's draws, its loss traces and its final state must be bitwise
    equal in the two.  Where they are not, the SGS farms are run again
    with each step taken apart (``testing.sgs_step_stages``) until one
    stage's chain-0 result differs: the first step and op that depend on
    the batch are printed.  cuFFT's C2R transform of chain 0's noise in a
    batch of N against a batch of 1 says whether the FFT is
    batch-invariant."""
    import torch

    from mcmc_tpu_torch.testing import (first_batch_dependence,
                                        sgs_step_stages)
    from mcmc_tpu_torch.utils.rng import PerChainStreams

    failed = []
    for family, chain, n in (("crf", crf_chain, N_CHAINS),
                             ("sgs", sgs_chain, SGS_CHAINS)):
        static, consts, draw, update, init = _family(chain)
        seeds = _seed_list(n)
        steps = SEED_STEPS[family]

        def run(probe):
            """(chain 0's draws that differ, draw values, step-1 noise by
            farm, loss traces by farm, final states equal, the (step,
            stage) of the first batch dependence when ``probe``)."""
            farms = {m: [PerChainStreams.from_seeds(seeds[:m], DEVICE),
                         init(m), []] for m in (n, 1)}
            n_diff = n_values = 0
            noise0, batch_op = {}, None
            for t in range(steps):
                drawn = {m: draw(f[0], static, consts, m)
                         for m, f in farms.items()}
                a, b = _draw_fields(drawn[n]), _draw_fields(drawn[1])
                for name in a:
                    n_diff += int((a[name][0] != b[name][0]).sum())
                    n_values += b[name][0].numel()
                if t == 0:
                    noise0 = {m: d.noise for m, d in drawn.items()}
                if probe and batch_op is None:
                    stage = first_batch_dependence(*(
                        sgs_step_stages(static, consts, farms[m][1],
                                        drawn[m]) for m in (n, 1)))
                    if stage is not None:
                        batch_op = (t + 1, stage)
                for m, f in farms.items():
                    f[1], tr = update(consts, f[1], drawn[m])
                    f[2].append(tr["loss"][0])
                    f[0].advance()
                if probe and batch_op is not None:
                    break
            loss = {m: torch.stack(f[2]).cpu().numpy()
                    for m, f in farms.items()}
            state_same = torch.equal(farms[n][1].fields[:1],
                                     farms[1][1].fields[:1])
            return n_diff, n_values, noise0, loss, state_same, batch_op

        n_diff, n_values, noise0, loss, state_same, _ = run(False)
        same = loss[n] == loss[1]
        first = int(np.argmin(same)) if not same.all() else None
        batch_op = None
        if family == "sgs" and (first is not None or not state_same):
            batch_op = run(True)[5]
        fft_same = _fft_batch_invariant(family, static, consts, noise0, n)
        rel = float(np.max(np.abs(loss[n] - loss[1]) / np.abs(loss[1])))
        traces = ("bitwise equal at every step" if first is None else
                  f"first differ after step {first + 1} (max rel "
                  f"{rel:.3e})")
        stages = ("" if family != "sgs" or (first is None and state_same)
                  else " | first op whose chain-0 result depends on the "
                  "batch: " + ("none found" if batch_op is None else
                               f"{batch_op[1]!r} at step {batch_op[0]}"))
        print(f"[independence] {family}: farm of {n} seeded "
              f"{seeds[0]}..{seeds[-1]} against a farm of 1 seeded "
              f"[{seeds[0]}], {steps} steps on the kernels: chain 0's "
              f"draws {n_diff} of {n_values} values not bitwise equal "
              f"(bound 0) | chain 0's loss traces {traces}, final state "
              f"bitwise equal: {state_same} (bound: bitwise){stages} | "
              f"cuFFT C2R of chain 0's step-1 noise in a batch of {n} vs "
              f"1 bitwise equal: {fft_same} ({card})", flush=True)
        for m in (n, 1):
            print(f"[independence] {family} chain 0 loss, farm of {m}: "
                  + json.dumps([float(v) for v in loss[m][:SEED_PRINTED]]),
                  flush=True)
        if n_diff:
            failed.append(f"the {family} farm's chain 0 draws depend on "
                          "the other chains")
        if first is not None or not state_same:
            failed.append(f"the {family} farm's chain 0 traces depend on "
                          "the other chains")
    sums = _sums_batch_invariant()
    print(f"[independence] masked square sums (ops/physics.masked_sq_sum) "
          f"whose chain 0 differs in a batch from alone, of "
          f"{SUM_TRIALS} random fields a shape: "
          + ", ".join(f"{n} x {h} x {w}: {new} (one-pass sum: {old})"
                      for (n, h, w), (new, old) in sums.items())
          + f" (bound 0; {card})", flush=True)
    if any(new for new, _ in sums.values()):
        failed.append("masked_sq_sum depends on the batch")
    if failed:
        raise RuntimeError("; ".join(failed))


def _sums_batch_invariant():
    """{(n, h, w): (trials whose chain 0 ``masked_sq_sum`` differs in a
    batch of n from alone, the same for a one-pass ``sum`` over both
    axes)} over SUM_TRIALS random fields and masks at the SGS window, the
    full grid and an odd window."""
    import torch

    from mcmc_tpu_torch.ops.physics import masked_sq_sum

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(5)
    out = {}
    for n, h, w in ((SGS_CHAINS, 36, 36), (64, GRID, GRID),
                    (SGS_CHAINS, 45, 67)):
        new = old = 0
        for _ in range(SUM_TRIALS):
            res = torch.randn((n, h, w), generator=gen, device=DEVICE)
            mask = torch.rand((n, h, w), generator=gen, device=DEVICE) < 0.4
            new += not torch.equal(masked_sq_sum(res, mask)[:1],
                                   masked_sq_sum(res[:1], mask[:1]))
            sq = torch.where(mask, res * res, 0.0)
            old += not torch.equal(sq.sum(dim=(-2, -1))[:1],
                                   sq[:1].sum(dim=(-2, -1)))
        out[(n, h, w)] = (new, old)
    return out


def _fft_batch_invariant(family, static, consts, noise, n):
    """Whether the family's first inverse FFT (the CRF proposal's irfft2,
    the SGS unconditional draw's) gives chain 0 the same bits in a batch
    of ``n`` as alone, on the same noise."""
    import torch

    from mcmc_tpu_torch.models.chain_sgs import halfspec_noise
    from mcmc_tpu_torch.ops.spectral import spectral_field_from_noise

    if family == "crf":
        rf = static.rf
        rx = torch.full((n,), 30e3, device=DEVICE)

        def fft(z):
            m = z.shape[0]
            return spectral_field_from_noise(z, (rf.B, rf.B), rf.resolution,
                                             rf.model_name, rx[:m], rx[:m],
                                             rf.smoothness)
    else:
        NE = static.NE

        def fft(z):
            return torch.fft.irfft2(halfspec_noise(z[:, :NE * NE], NE)
                                    * consts.embed_sqrt, s=(NE, NE))
    return bool(torch.equal(fft(noise[n])[0], fft(noise[1])[0]))


def phase_seed_rates(p, card):
    """Device ops a step and chain-it/s of an int-seeded and a list-seeded
    farm of each family at its headline, in turn int, list, list, int:
    no claim, the host sets the pace.  The list-seeded runs are the draw
    kernel's main path: its count (and the keyed noise entry's) is set to
    0 just before each and read just after: one launch a step.  Returns
    the draw kernel's launches over the SGS list-seeded runs, the family
    whose draw plan its ``kernels`` row times."""
    import torch

    from mcmc_tpu_torch import MultiChainSampler
    from mcmc_tpu_torch.ops.chain_draws import chain_draws
    from mcmc_tpu_torch.ops.noise_kernel import (batched_normal,
                                                 batched_normal_keyed)

    launches = 0
    for family, make, n in (("crf", make_chain, N_CHAINS),
                            ("sgs", make_sgs_chain, SGS_CHAINS)):
        steps = SEED_RATE_STEPS[family]
        rates = {"int": [], "list": []}
        ops = {}
        for kind in ("int", "list", "list", "int"):
            sampler = MultiChainSampler(make(p), n, device=DEVICE)
            states = sampler.init(seeds=0 if kind == "int"
                                  else _seed_list(n))
            states, _ = sampler.run_segment(states, 20)  # warm
            counts = (chain_draws, batched_normal_keyed, batched_normal)
            for k in counts:
                k.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states, traces = sampler.run(states, steps + 1,
                                         segment_size=steps, progress=False)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            got = [k.launches for k in counts]
            want = ([0, 0, steps] if kind == "int" and family == "crf"
                    else [0, 0, 0] if kind == "int"
                    else [steps, steps if family == "crf" else 0, 0])
            if got != want:
                raise RuntimeError(f"{family} {kind}-seeded launches "
                                   f"(draws, keyed noise, noise) {got}, "
                                   f"expected {want}")
            if kind == "list" and family == "sgs":
                launches += got[0]
            if not np.isfinite(traces["loss"]).all():
                raise RuntimeError(f"non-finite {family} {kind}-seeded loss")
            rates[kind].append(steps * n / elapsed)
            if kind not in ops:
                ops[kind] = busy_share(sampler, states, card,
                                       elapsed / steps * 1e6, n_steps=20,
                                       top=0, tag=f"seeds-{family}-{kind}")
            del sampler, states
            torch.cuda.empty_cache()
        per_step = {k: (v or {}).get("ops_per_step") for k, v in ops.items()}
        print(f"[seeds] {family}, {n} chains x {GRID}^2, {steps} steps a "
              f"run: chain-it/s int-seeded {rates['int']}, list-seeded "
              f"{rates['list']} (no claim: host-bound, runs in the order "
              f"int, list, list, int) | device ops a step: int "
              f"{per_step['int']}, list {per_step['list']} ({card})",
              flush=True)
        if (None not in per_step.values()
                and per_step["list"] > per_step["int"]):
            raise RuntimeError(f"the list-seeded {family} step makes more "
                               "device launches than the int-seeded one")
    return launches


def _cli_run(tmp, cfg, *extra):
    """``mcmc_tpu_torch.cli.main`` on ``cfg`` written into ``tmp``; its
    standard output."""
    from mcmc_tpu_torch import cli

    path = tmp / f"{cfg['farm']['output_path']}.json"
    path.write_text(json.dumps(cfg))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(path), "--quiet", "--device", DEVICE, *extra])
    if rc != 0:
        raise RuntimeError(f"the CLI returned {rc}")
    return buf.getvalue()


def phase_entry_seed_list(p, card):
    """The SGS headline through ``python -m mcmc_tpu_torch``'s main with a
    512-seed ``rng_seeds`` list: ENTRY_LIST_ITERS[0] iterations, resumed
    to ENTRY_LIST_ITERS[1], bitwise against an uninterrupted run; one
    draw-kernel launch a step."""
    from mcmc_tpu_torch.ops.cg_kernel import mix_masked_cg
    from mcmc_tpu_torch.ops.chain_draws import chain_draws
    from mcmc_tpu_torch.ops.lut_kernel import lut_interp

    first, total = ENTRY_LIST_ITERS
    seeds = _seed_list(SGS_CHAINS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT) as tmp:
        tmp = Path(tmp)
        _write_dataset(p, tmp / "dataset.npz")
        kernels = (chain_draws, mix_masked_cg, lut_interp)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        for n_iter, out in ((first, "resumed"), (total, "resumed"),
                            (total, "straight")):
            _cli_run(tmp, _sgs_config(n_iter, out, MATERN, seeds))
        elapsed = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels}
        steps = (first - 1) + (total - first) + (total - 1)
        same = {}
        with np.load(tmp / "resumed_hist.npz") as a, \
                np.load(tmp / "straight_hist.npz") as b:
            for key in a.files:
                same[key] = bool(np.array_equal(
                    a[key], b[key], equal_nan=a[key].dtype.kind == "f"))
            loss = a["loss"]
        same["final_beds"] = bool(np.array_equal(
            np.load(tmp / "resumed_beds.npy"),
            np.load(tmp / "straight_beds.npy")))
        ckpt = sorted(tmp.glob("resumed/**/checkpoint_*.npz"))
        with np.load(ckpt[-1]) as z:
            kind = json.loads(bytes(z["meta_json"]).decode())["rng_kind"]
    print(f"[entry-list] SGS Matern headline, {SGS_CHAINS} chains x "
          f"{GRID}^2 through python -m mcmc_tpu_torch with rng_seeds "
          f"[{seeds[0]}, ..., {seeds[-1]}]: {first} iterations resumed to "
          f"{total} and {total} straight in {elapsed:.1f} s with builds and "
          f"checkpoints | checkpoint stream kind {kind!r} | resumed == "
          f"uninterrupted, bitwise: {same} | loss mean "
          f"{loss[:, 0].mean():.6e} -> {loss[:, -1].mean():.6e} | launches "
          f"{launches} in {steps} steps ({card})", flush=True)
    if not all(same.values()):
        raise RuntimeError("the resumed list-seeded farm departs from the "
                           "uninterrupted one")
    if kind != "philox-per-chain":
        raise RuntimeError(f"the checkpoint holds a {kind!r} stream")
    if loss.shape != (SGS_CHAINS, total) or not np.isfinite(loss).all():
        raise RuntimeError(f"list-seeded SGS traces {loss.shape}")
    if not loss[:, -1].mean() < loss[:, 0].mean():
        raise RuntimeError("the list-seeded SGS loss did not decrease")
    if any(n != steps for n in launches.values()):
        raise RuntimeError(f"kernel launches {launches} in {steps} steps")


def _run_kernels(family):
    """The kernels a list-seeded single-chain run of ``family`` launches,
    each once a step."""
    from mcmc_tpu_torch.ops.cg_kernel import mix_masked_cg
    from mcmc_tpu_torch.ops.chain_draws import chain_draws
    from mcmc_tpu_torch.ops.lut_kernel import lut_interp
    from mcmc_tpu_torch.ops.noise_kernel import batched_normal_keyed
    from mcmc_tpu_torch.ops.sgs_window_kernel import (window_extract,
                                                      window_writeback)
    from mcmc_tpu_torch.ops.window_kernel import fused_window_update

    if family == "crf":
        return (fused_window_update, batched_normal_keyed, chain_draws)
    return (window_extract, window_writeback, mix_masked_cg, lut_interp,
            chain_draws)


# (farm trace, run dict key) pairs a single-chain run returns
RUN_TRACES = (("loss", "loss"), ("loss_mc", "loss_mc"),
              ("loss_data", "loss_data"), ("step", "steps"),
              ("block", "blocks"))


def _run_matches_farm(out, traces, chain):
    """Whether a single-chain run's traces equal chain ``chain`` of a
    farm's, bit for bit (NaN blocks of row 0 equal)."""
    return all(np.array_equal(out[name], traces[k][chain],
                              equal_nan=out[name].dtype.kind == "f")
               for k, name in RUN_TRACES)


def _runs_equal(a, b):
    """Two single-chain run dicts equal bit for bit, final states aside."""
    return set(a) == set(b) and all(
        np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f")
        for k in a if k != "final_state")


def _randfield_like(chain):
    """A ``RandField`` wrapper configured as the CRF chain is."""
    from mcmc_tpu_torch.models.randfield import RandField

    cfg, blocks, w = chain._rf_cfg, chain._block_cfg, chain._weight_cfg
    rf = RandField(cfg.range_min_x, cfg.range_max_x, cfg.range_min_y,
                   cfg.range_max_y, cfg.scale_min, cfg.scale_max,
                   cfg.nugget_max, cfg.model_name, cfg.isotropic,
                   cfg.smoothness, device=DEVICE)
    rf.set_block_sizes(blocks.min_block_x, blocks.max_block_x,
                       blocks.min_block_y, blocks.max_block_y, blocks.steps)
    rf.set_weight_param(w.L, w.x0, w.k, w.offset, w.max_dist, w.resolution)
    return rf


def _draws_vs_chain0(chain, n, steps):
    """Over ``steps`` step counters, how many of the 1-chain stream
    [s]'s draw values differ from chain 0's in the n-chain stream [s, s +
    1, ...], and how many were compared."""
    import torch

    from mcmc_tpu_torch.models import chain_crf as crf
    from mcmc_tpu_torch.models import chain_sgs as sgs
    from mcmc_tpu_torch.utils.rng import PerChainStreams

    static, consts = chain.build(DEVICE)
    draw = sgs.draw if isinstance(chain, sgs.ChainSGS) else crf.draw
    one = PerChainStreams.from_seeds(_seed_list(1), DEVICE)
    many = PerChainStreams.from_seeds(_seed_list(n), DEVICE)
    n_diff = torch.zeros((), dtype=torch.int64, device=DEVICE)
    n_values = 0
    for _ in range(steps):
        a = _draw_fields(draw(one, static, consts, 1))
        b = _draw_fields(draw(many, static, consts, n))
        for name, v in a.items():
            n_diff += (v[0] != b[name][0]).sum()
            n_values += v[0].numel()
        one.advance()
        many.advance()
    return int(n_diff), n_values


def _plan_diff(keys, step, plan):
    """How many of a draw plan's values (its views: the buffers' unused
    slots are not values) the draw kernel and its plain version give
    differently."""
    from mcmc_tpu_torch.ops.chain_draws import (chain_draws,
                                                chain_draws_reference)

    got = plan.views(*chain_draws(keys, step, plan))
    want = plan.views(*chain_draws_reference(keys, step, plan))
    return sum(int((got[k] != w).sum()) for k, w in want.items())


def _empty_floor(ctas, n):
    """ms per launch of an empty kernel on ``ctas`` CTAs of 256 threads,
    timed as the kernels are (``_time_ops`` over ``n`` launches, twice)."""
    from mcmc_tpu_torch.ops.lut_kernel import empty_launch

    return float(np.mean([_time_ops(lambda: empty_launch(ctas), [()] * n)
                          for _ in range(2)]))


def _one_chain_times(family, pairs, card):
    """Each kernel's ms per launch at one chain (plain / kernel / kernel /
    plain over its recorded operands) beside an empty launch on its grid;
    ``pairs`` maps a name to (plain, kernel, recorded, CTAs)."""
    rows = {}
    for name, (plain, kernel, recorded, ctas) in pairs.items():
        plain_ms, ms = _pair_times(plain, kernel, recorded)
        floor_ms = _empty_floor(ctas, len(recorded))
        rows[name] = dict(ms=ms, plain_ms=plain_ms, floor_ms=floor_ms,
                          ctas=ctas)
        print(f"[run] {family} at one chain, {name}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms per launch | an empty kernel on "
              f"its {ctas} CTA(s) {floor_ms:.4f} ms: the kernel is "
              f"{ms / floor_ms:.2f}x the floor ({card}; CUDA events, "
              f"{len(recorded)} launches x 2 each)", flush=True)
    return rows


def _crf_one_chain_kernels(chain, card):
    """The CRF single-chain path's kernels against their plain versions at
    one chain over RUN_KERNEL_STEPS steps of the stream [s]: the draw
    kernel and the keyed noise bitwise, the window kernel by MH flips
    (the headline's bounds), the state advancing on the kernel; then
    their times beside the launch floor."""
    from mcmc_tpu_torch.models import chain_crf as crf
    from mcmc_tpu_torch.ops.chain_draws import (SLOTS, cached_plan,
                                                chain_draws,
                                                chain_draws_reference)
    from mcmc_tpu_torch.ops.noise_kernel import (
        batched_normal_keyed, batched_normal_keyed_reference)
    from mcmc_tpu_torch.ops.window_kernel import (
        fused_window_update, fused_window_update_reference)
    from mcmc_tpu_torch.utils.rng import PerChainStreams

    static, consts = chain.build(DEVICE)
    state = crf.init_state(chain.initial_bed, consts, 1)
    streams = PerChainStreams.from_seeds(_seed_list(1), DEVICE)
    plan = cached_plan(crf.draw_plan_entries(static))
    B = static.rf.B
    n_diff = n_flip = field_viol = 0
    delta_rel = 0.0
    ops = dict(window=[], noise=[], draws=[])
    for _ in range(RUN_KERNEL_STEPS):
        step = streams.step.clone()
        n_diff += _plan_diff(streams.keys, step, plan)
        nargs = (streams.keys, step, SLOTS["spectrum"], 2 * B, B // 2 + 1)
        n_diff += int((batched_normal_keyed(*nargs)
                       != batched_normal_keyed_reference(*nargs)).sum())
        d = crf.draw(streams, static, consts, 1)
        f = crf.propose(static, consts, d).contiguous()
        cx = consts.region_cells[d.cidx, 0]
        cy = consts.region_cells[d.cidx, 1]
        geom, fvals = crf.window_operands(static, consts, state, d.size_idx,
                                          d.scale, cx, cy, d.u)
        old = state.fields.clone()
        plain = old.clone()
        args = (f, consts.rf.edge_masks, geom, fvals)
        acc_k, dk, ddk = fused_window_update(consts.stacked, state.fields,
                                             *args)
        acc_p, dp, ddp = fused_window_update_reference(consts.stacked, plain,
                                                       *args)
        same = acc_k == acc_p
        n_flip += int((~same).sum())
        if bool(same.all()):
            scale = _block_losses(old, geom, consts)
            err = ((dk.double() - dp.double()).abs()
                   / (scale + dp.double().abs() + 1e-12))
            delta_rel = max(delta_rel, float(err.max()))
            diff = (state.fields - plain).abs()
            field_viol += int((diff > FIELD_ATOL
                               + FIELD_RTOL * plain.abs()).sum())
        state.loss_mc = state.loss_mc + dk
        state.loss_data = state.loss_data + ddk
        ops["window"].append(args)
        ops["noise"].append(nargs)
        ops["draws"].append((streams.keys, step))
        streams.advance()
    print(f"[run] crf at one chain, {RUN_KERNEL_STEPS} steps of the stream "
          f"[{_seed_list(1)[0]}]: draw kernel and keyed noise {n_diff} "
          f"values not bitwise equal to their plain versions (bound 0) | "
          f"window kernel MH flips {n_flip}/{RUN_KERNEL_STEPS} (bound "
          f"{FLIP_RATE_MAX:g} of decisions), max delta err / block loss "
          f"{delta_rel:.3e} (bound {DELTA_REL_MAX:g}), {field_viol} cells "
          f"beyond rtol {FIELD_RTOL:g} / atol {FIELD_ATOL:g}", flush=True)
    if (n_diff or n_flip > FLIP_RATE_MAX * RUN_KERNEL_STEPS
            or delta_rel > DELTA_REL_MAX or field_viol):
        raise RuntimeError("a CRF kernel disagrees with its plain version "
                           "at one chain")
    scratch = state.fields.clone()
    window = [(consts.stacked, scratch) + a for a in ops["window"]]
    noise_calls = (B * (B // 2 + 1) + 1) // 2  # Philox calls a chain
    return _one_chain_times("crf", {
        # grids at one chain: 1 CTA; (1, calls / 128); calls / 256
        "fused_window_update": (fused_window_update_reference,
                                fused_window_update, window, 1),
        "batched_normal_keyed": (batched_normal_keyed_reference,
                                 batched_normal_keyed, ops["noise"],
                                 -(-noise_calls // 128)),
        "chain_draws": (lambda k, t: chain_draws_reference(k, t, plan),
                        lambda k, t: chain_draws(k, t, plan), ops["draws"],
                        -(-plan.calls // 256)),
    }, card)


def _sgs_one_chain_kernels(chain, card):
    """The SGS single-chain path's kernels against their plain versions at
    one chain over RUN_KERNEL_STEPS steps of the stream [s], through the
    headline's stages (``_sgs_kernel_steps``) and bounds, and the draw
    kernel bitwise at the same step counters; then their times beside the
    launch floor.  At K = 48 a CG CTA packs 4 chains, so 3 of its 4 warps
    have none."""
    import torch

    from mcmc_tpu_torch.models import chain_sgs as sgs
    from mcmc_tpu_torch.ops.cg_kernel import (cg_kernel_info, mix_masked_cg,
                                              mix_masked_cg_reference)
    from mcmc_tpu_torch.ops.chain_draws import (cached_plan, chain_draws,
                                                chain_draws_reference)
    from mcmc_tpu_torch.ops.lut_kernel import (lut_interp,
                                               lut_interp_reference,
                                               lut_kernel_info)
    from mcmc_tpu_torch.ops.sgs_window_kernel import (
        window_extract, window_extract_reference, window_writeback,
        window_writeback_reference)
    from mcmc_tpu_torch.utils.rng import PerChainStreams

    static, consts = chain.build(DEVICE)
    state = sgs.sgs_init_state(chain._initial_detrended, consts,
                               chain._initial_z, True, 1)
    streams = PerChainStreams.from_seeds(_seed_list(1), DEVICE)
    plan = cached_plan(sgs.draw_plan_entries(static, consts))
    steps = [torch.tensor([t], dtype=torch.int64, device=DEVICE)
             for t in range(RUN_KERNEL_STEPS)]
    n_diff = 0
    for step in steps:
        n_diff += _plan_diff(streams.keys, step, plan)
    state, err, stats, ops, _ = _sgs_kernel_steps(
        static, consts, state, streams, RUN_KERNEL_STEPS, card)
    print(f"[run] sgs at one chain, {RUN_KERNEL_STEPS} steps of the stream "
          f"[{_seed_list(1)[0]}]: extract and writeback bitwise | draw "
          f"kernel {n_diff} values not bitwise equal (bound 0) | CG max abs "
          f"err {err['cg']:.3e}, {stats['cg_viol']} values beyond rtol/atol "
          f"{CG_RTOL:g} | LUT {stats['n_lut_diff']} values differ, at most "
          f"{stats['lut_ulp']} ulp (bound {LUT_ULP_MAX}) | MH flips against "
          f"a plain step {stats['n_flip']}/{RUN_KERNEL_STEPS}", flush=True)
    if (n_diff or stats["cg_viol"] or stats["lut_ulp"] > LUT_ULP_MAX
            or stats["n_flip"] > FLIP_RATE_MAX * RUN_KERNEL_STEPS):
        raise RuntimeError("an SGS kernel disagrees with its plain version "
                           "at one chain")
    scratch = state.fields.clone()
    cpb = cg_kernel_info(static.K, True)["chains_per_cta"]
    return _one_chain_times("sgs", {
        # grids at one chain: (1, 14 planes), (1, 4 planes), 1 CTA of
        # ``cpb`` chain slots, the LUT's own, calls / 256
        "window_extract": (window_extract_reference, window_extract,
                           ops["extract"], consts.stacked.shape[0]
                           + state.fields.shape[1]),
        "window_writeback": (
            lambda *a: window_writeback_reference(scratch, *a),
            lambda *a: window_writeback(scratch, *a), ops["writeback"],
            state.fields.shape[1]),
        "mix_masked_cg": (mix_masked_cg_reference, mix_masked_cg, ops["cg"],
                          -(-1 // cpb)),
        "lut_interp": (lut_interp_reference, lut_interp, ops["lut"],
                       lut_kernel_info(ops["lut"][0][0])["ctas"]),
        "chain_draws": (lambda k, t: chain_draws_reference(k, t, plan),
                        lambda k, t: chain_draws(k, t, plan),
                        [(streams.keys, t) for t in steps],
                        -(-plan.calls // 256)),
    }, card)


def phase_run(p, card):
    """[run]: ``ChainCRF.run`` / ``ChainSGS.run`` at the headline's width,
    one chain seeded [s] (each run's launches counted from 0 just before
    it and read just after: every kernel of the path once a step).
    Checks: the traces equal the 1-chain farm seeded [s] bit for bit, and
    the draws and the traces chain 0's in the headline farm seeded [s, s
    + 1, ...] (the SGS farm's, since its masked sums are batch-invariant);
    ``progress_bar`` with ``info_per_iter`` changes no bit; (CRF) a
    ``RandField`` configured like the chain changes no bit; a second run
    continues the stream and differs; (CRF) the last saved bed is the
    final state's; the loss is finite and falls, acceptance in (0.02,
    0.98).  Prints single-chain it/s, the device-idle share over
    RUN_PROFILE_STEPS profiled steps, and each kernel at one chain
    against its plain version and the launch floor."""
    import torch

    from mcmc_tpu_torch import MultiChainSampler

    seed = _seed_list(1)[0]
    rows = {}
    for family, make, n_farm in (("crf", make_chain, N_CHAINS),
                                 ("sgs", make_sgs_chain, SGS_CHAINS)):
        chain = make(p)
        n_iter = RUN_ITERS[family]
        steps = n_iter - 1
        is_crf = family == "crf"
        kernels = _run_kernels(family)
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = chain.run(n_iter, seed=seed, save_beds=is_crf, device=DEVICE)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels}
        farm = MultiChainSampler(chain, 1, device=DEVICE)
        state1, tr1 = farm.run(farm.init(seeds=[seed]), n_iter,
                               segment_size=steps, progress=False)
        checks = {"farm [s]": _run_matches_farm(out, tr1, 0)}
        n_diff, n_values = _draws_vs_chain0(chain, n_farm, steps)
        checks[f"draws = chain 0 of {n_farm}"] = n_diff == 0
        big = MultiChainSampler(chain, n_farm, device=DEVICE)
        _, trn = big.run(big.init(seeds=_seed_list(n_farm)), n_iter,
                         segment_size=steps, progress=False)
        checks[f"traces = chain 0 of {n_farm}"] = _run_matches_farm(out,
                                                                 trn, 0)
        del big, trn
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            seen = chain.run(n_iter, seed=seed, save_beds=is_crf,
                             progress_bar=True, info_per_iter=RUN_INFO,
                             device=DEVICE)
        progress = buf.getvalue().strip().splitlines()
        checks["observers"] = (_runs_equal(out, seen)
                               and len(progress) == -(-steps // RUN_INFO))
        if is_crf:
            checks["RandField"] = _runs_equal(out, chain.run(
                n_iter, _randfield_like(chain), seed=seed, save_beds=True,
                device=DEVICE))
        second = chain.run(n_iter, device=DEVICE)
        checks["second run differs"] = not np.array_equal(second["loss"],
                                                          out["loss"])
        if is_crf:
            checks["last bed = final"] = np.array_equal(
                out["bed"][-1], out["final_state"].bed[0].cpu().numpy())
        loss = out["loss"]
        acc = float(out["steps"][1:].mean())
        checks["loss finite, falls"] = bool(np.isfinite(loss).all()
                                            and loss[-1] < loss[0])
        checks["acc in (0.02, 0.98)"] = 0.02 < acc < 0.98
        print(f"[run] {family} {type(chain).__name__}.run({n_iter}, seed="
              f"{seed}) at {GRID}^2, one chain: {steps / elapsed:,.0f} it/s "
              f"({elapsed:.2f} s) | loss {loss[0]:.6e} -> {loss[-1]:.6e}, "
              f"acc {acc:.3f} | launches {launches} in {steps} steps | "
              f"chain 0's draws in the farm of {n_farm}: {n_diff} of "
              f"{n_values} values differ | progress: "
              f"{progress[-1] if progress else None!r} | checks "
              f"{checks} ({card})", flush=True)
        if any(n != steps for n in launches.values()):
            raise RuntimeError(f"{family} single-chain launches {launches} "
                               f"in {steps} steps")
        if not all(checks.values()):
            raise RuntimeError(f"{family} single-chain run checks failed: "
                               f"{checks}")
        busy_share(farm, state1, card, elapsed / steps * 1e6,
                   n_steps=RUN_PROFILE_STEPS, tag=f"run-{family}-profile")
        del farm, state1, out, seen, second
        one = (_crf_one_chain_kernels if is_crf
               else _sgs_one_chain_kernels)(chain, card)
        rows[family] = one
        del chain
        torch.cuda.empty_cache()
    return rows


def phase_collect(p, card):
    """[collect]: ``MultiChainSampler.run(collect_beds=True,
    profile_dir=...)`` at both headlines (COLLECT_RUNS): ``bed_thin`` is
    (n_chains, n_segments, H, W) with its last snapshot the final
    full-space bed bit for bit, and a Chrome trace of the second segment
    was written into ``profile_dir`` (a temporary directory under the
    checkout) naming the family's first kernel."""
    import torch

    from mcmc_tpu_torch import MultiChainSampler

    for family, make, n, kernel in (
            ("crf", make_chain, N_CHAINS, "fused_window_kernel"),
            ("sgs", make_sgs_chain, SGS_CHAINS, "window_extract_kernel")):
        n_iter, seg = COLLECT_RUNS[family]
        n_seg = -(-(n_iter - 1) // seg)
        sampler = MultiChainSampler(make(p), n, device=DEVICE)
        states = sampler.init(seeds=0)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                         dir=ROOT) as tmp:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states, traces = sampler.run(states, n_iter, segment_size=seg,
                                         progress=False, collect_beds=True,
                                         profile_dir=tmp)
            elapsed = time.perf_counter() - t0
            thin = traces.pop("bed_thin")
            last = np.array_equal(thin[:, -1],
                                  sampler.full_bed(states).cpu().numpy())
            files = sorted(Path(tmp).iterdir())
            names = [f.name for f in files]
            size_mb = sum(f.stat().st_size for f in files) / 1e6
            named = bool(files) and kernel in files[0].read_text()
        print(f"[collect] {family}, {n} chains x {GRID}^2, run({n_iter}, "
              f"segment_size={seg}, collect_beds=True, profile_dir=...) in "
              f"{elapsed:.2f} s: bed_thin {thin.shape} ({thin.nbytes / 1e9:.2f}"
              f" GB), last snapshot = final full-space bed bitwise: {last} "
              f"| trace files {names} ({size_mb:.1f} MB), naming "
              f"{kernel}: {named} ({card})", flush=True)
        if thin.shape != (n, n_seg, GRID, GRID) or not last:
            raise RuntimeError(f"{family} bed_thin {thin.shape} wrong")
        if names != ["segment1.pt.trace.json"] or not named:
            raise RuntimeError(f"{family} profile_dir holds {names}")
        del thin, traces, sampler, states
        torch.cuda.empty_cache()


def _device_busy(fn):
    """(device busy us, wall us, device ops) of ``fn()`` under
    ``torch.profiler`` (busy None where it recorded no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = _device_events(prof.key_averages())
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in events)
    return (busy or None), wall_us, sum(e.count for e in events)


def _device_events(events):
    """The profiled device work among ``events``: kernels, copies and
    memsets, without the device-side copies of the port's ``mcmc.*``
    spans (user annotations, which cover the work they launched)."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _same_array(a, b):
    """Two numpy arrays equal in shape, type and every byte."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(np.ascontiguousarray(a).view(np.uint8),
                               np.ascontiguousarray(b).view(np.uint8)))


@contextlib.contextmanager
def _geo_loops(way, keep_graph=False):
    """Inside, ``sgs`` and ``krige`` on the card run ``way``'s chunk loops:
    "eager" (the plain versions, every op launched from Python) or
    "graph" (the captured ones ``sgs`` runs there, each capture timed).
    Yields the list of (graph if ``keep_graph`` else None, capture ms)."""
    import importlib

    import torch

    from mcmc_tpu_torch.utils.graphs import capture_graph

    S = importlib.import_module("mcmc_tpu_torch.geostats.sgs")
    captures = []

    def capture(body, generator=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph = capture_graph(body, generator, keep_graph=keep_graph)
        captures.append((graph if keep_graph else None,
                         (time.perf_counter() - t0) * 1e3))
        return graph

    loops = S._chunk_loops
    S._chunk_loops = ((lambda device: (S._sgs_loop_eager,
                                       S._krige_loop_eager))
                      if way == "eager" else (lambda device: (
                          functools.partial(S._sgs_loop_captured,
                                            capture=capture),
                          functools.partial(S._krige_loop_captured,
                                            capture=capture))))
    try:
        yield captures
    finally:
        S._chunk_loops = loops


def _profiled_chunks(p, vario, bounds, card, way, pinned=True):
    """[geostats], one way ("eager" or "graph", ``_geo_loops``):
    GEO_PROFILE_CHUNKS chunks of the bounded SGS loop at full width
    profiled after as many warm ones, through the loop ``sgs`` runs that
    way (the host's truncated-normal draws included): device ops,
    Python-launched device ops (the runtime calls LAUNCH_CALLS) and
    device-busy ms a chunk, the idle share of the profiled wall, and the
    captured loop's graph nodes a chunk (its DOT dump).  ``pinned=False``
    solves with torch's default batched LU (MAGMA's, eager only), not
    the cuBLAS one ``sgs`` pins on the card (``_batched_lu``)."""
    import importlib

    import torch
    from scipy.stats import truncnorm
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    S = importlib.import_module("mcmc_tpu_torch.geostats.sgs")
    kw, per = GEO_KW, GEO_PROFILE_CHUNKS
    dev = torch.device(DEVICE)
    prep = S._prepare(p["xx"], p["cond_bed"], vario, None, kw["num_points"],
                      "ok", kw["half_window"], dev)
    lo_b, hi_b = (prep["nst"].transform_np(np.broadcast_to(b, (GRID, GRID)))
                  for b in bounds)
    zg = S._score_grid(prep, dev)
    path = prep["cells"][:(2 * per + 1) * kw["chunk"]]
    rng = np.random.default_rng(0)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    drawn, window = [], {}

    def draw(cells, est, var):
        # est and var are on the host, so the device is idle here: the
        # window is whole chunks, from draw `per` to draw 2 `per`
        if len(drawn) == per:
            prof.start()
            window["t0"] = time.perf_counter()
        elif len(drawn) == 2 * per:
            torch.cuda.synchronize()
            window["wall_us"] = (time.perf_counter() - window["t0"]) * 1e6
            prof.stop()
        drawn.append(len(cells))
        sd = np.maximum(np.sqrt(np.abs(var)), 1e-12)
        lo, hi = (b[cells[:, 0], cells[:, 1]] for b in (lo_b, hi_b))
        return truncnorm.rvs((lo - est) / sd, (hi - est) / sd, loc=est,
                             scale=sd, random_state=rng)

    lu = S._batched_lu(dev) if pinned else contextlib.nullcontext()
    with _geo_loops(way, keep_graph=True) as captures, lu:
        S._chunk_loops(dev)[0](prep, zg, path, kw["radius"], kw["chunk"],
                               draw)
    torch.cuda.synchronize()
    events = prof.key_averages()
    on_device = _device_events(events)
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in on_device) or None
    launched = sum(e.count for e in events
                   if e.device_type == DeviceType.CPU
                   and e.key in LAUNCH_CALLS)
    wall = window["wall_us"]
    nodes, kinds = (_dot_nodes(captures[0][0])[:2] if captures
                    else (None, None))
    row = dict(launched=launched / per,
               ops=sum(e.count for e in on_device) / per,
               busy_ms=None if busy is None else busy / per / 1e3,
               wall_ms=wall / per / 1e3,
               idle=None if busy is None else 1 - busy / wall,
               nodes=nodes, kinds=kinds)
    idle = ("not measured (the profiler recorded no device time)"
            if busy is None else f"{row['idle']:.3f}")
    print(f"[geostats] {way}{'' if pinned else ', torch default LU'}: "
          f"{per} profiled chunks of {kw['chunk']} cells "
          f"at {GRID}^2 (window {2 * kw['half_window'] + 1}^2, "
          f"{kw['num_points']} neighbours): {row['launched']:.1f} "
          f"Python-launched device ops a chunk, {row['ops']:.1f} device ops "
          f"a chunk, device busy {row['busy_ms']} ms a chunk against "
          f"{row['wall_ms']:.3f} ms of profiled wall -> idle share {idle} | "
          f"graph nodes a chunk {nodes} {kinds} ({card})", flush=True)
    return row


def phase_geostats(p, card):
    """[geostats]: the T2 workflow at full width.  ``fit_variogram`` on the
    headline's radar picks, then ``generate_initial_beds`` at GRID^2 with
    the exponential fit (2 beds, surf bounds, GEO_KW): the data cells
    honoured within GEO_DATA_ATOL, every simulated cell within
    [nanmin(data) - 2000, surf - 1] to GEO_BOUND_ATOL, the two beds
    differ and the same seed reproduces the first bitwise; ``krige`` at
    GRID^2 (finite maps, the mean honouring the data); the same ``sgs``
    call on a GEO_CUT^2 cut on the card and on the CPU within
    GEO_CPU_ATOL; the two beds as a 2-chain CRF farm's initial beds,
    GEO_FARM_STEPS steps with a finite loss.  All of that runs the
    captured chunk loop, as ``sgs`` on the card does.  Then the A/B in
    this process: the first bed, a bounded Matérn bed (s GEO_MATERN_S)
    and the ``krige`` maps on the eager loop (the plain version) against
    the captured loop, bitwise; seconds a bed and ms a chunk, capture ms
    and added peak memory; and each loop's profiled chunks
    (``_profiled_chunks``), and the eager loop's under torch's default
    batched LU."""
    import torch

    from mcmc_tpu_torch import MultiChainSampler
    from mcmc_tpu_torch.geostats import (fit_variogram, generate_initial_beds,
                                         krige)

    # the chunk loop is host-bound: start it with the caching allocator
    # emptied of the earlier phases' multi-GB blocks
    torch.cuda.empty_cache()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    if tf32 != (False, "highest"):
        raise RuntimeError(f"float32 matmuls may use TF32: {tf32}")
    xx, yy, cond, surf = p["xx"], p["yy"], p["cond_bed"], p["surf"]
    m = ~np.isnan(cond)
    t0 = time.perf_counter()
    _, _, params, _ = fit_variogram(cond[m], np.column_stack([xx[m],
                                                              yy[m]]))
    t_fit = time.perf_counter() - t0
    vario = dict(azimuth=0.0, nugget=0.0, major_range=params[1][0],
                 minor_range=params[1][0], sill=params[1][1],
                 vtype="Exponential")
    lower = float(np.nanmin(cond) - 2000.0)
    beds_kw = dict(surf=surf, seed=GEO_SEED, device=DEVICE, **GEO_KW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    beds = generate_initial_beds(xx, yy, cond, vario, n_beds=2, **beds_kw)
    t_beds = time.perf_counter() - t0
    again = generate_initial_beds(xx, yy, cond, vario, n_beds=1,
                                  **beds_kw)[0]
    n_cells = int((~m).sum())
    n_chunks = -(-n_cells // GEO_KW["chunk"])
    per_bed = t_beds / 2
    data_err = max(float(np.abs(b[m] - cond[m]).max()) for b in beds)
    above = max(float((b[~m] - (surf[~m] - 1.0)).max()) for b in beds)
    below = max(float((lower - b[~m]).max()) for b in beds)
    t0 = time.perf_counter()
    mean, std = krige(xx, yy, cond, vario, radius=GEO_KW["radius"],
                      num_points=GEO_KW["num_points"],
                      half_window=GEO_KW["half_window"], device=DEVICE)
    t_krige = time.perf_counter() - t0
    krige_err = float(np.abs(mean[m] - cond[m]).max())
    cut = slice(0, GEO_CUT)
    sub = [a[cut, cut] for a in (xx, yy, cond, surf)]
    t0 = time.perf_counter()
    on_card = generate_initial_beds(*sub[:3], vario,
                                    **dict(beds_kw, surf=sub[3]))[0]
    t_cut_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = generate_initial_beds(*sub[:3], vario, **dict(
        beds_kw, surf=sub[3], device="cpu"))[0]
    t_cut_cpu = time.perf_counter() - t0
    cpu_diff = float(np.abs(on_card - on_cpu).max())
    farm = MultiChainSampler(make_chain(p), 2, device=DEVICE)
    _, tr = farm.run(farm.init(initial_beds=np.stack(beds), seeds=0),
                     GEO_FARM_STEPS + 1, progress=False)
    farm_loss = tr["loss"]
    checks = {
        "data honoured": data_err <= GEO_DATA_ATOL,
        "below surf - 1": above <= GEO_BOUND_ATOL,
        "above the lower bound": below <= GEO_BOUND_ATOL,
        "beds differ": not np.array_equal(beds[0], beds[1]),
        "same seed bitwise": np.array_equal(again, beds[0]),
        "krige finite": bool(np.isfinite(mean).all()
                             and np.isfinite(std).all()),
        "krige honours data": krige_err <= GEO_DATA_ATOL,
        "card = CPU": cpu_diff <= GEO_CPU_ATOL,
        "farm loss finite": bool(np.isfinite(farm_loss).all()),
    }
    print(f"[geostats] fit_variogram on {int(m.sum())} radar picks in "
          f"{t_fit:.2f} s: exponential range {params[1][0]:.0f} m, sill "
          f"{params[1][1]:.3f} | generate_initial_beds at {GRID}^2 "
          f"(n_beds 2, radius {GEO_KW['radius']:.0f}, num_points "
          f"{GEO_KW['num_points']}, chunk {GEO_KW['chunk']}, half_window "
          f"{GEO_KW['half_window']}): {per_bed:.2f} s a bed, {n_chunks} "
          f"chunks of {n_cells} cells, {per_bed / n_chunks * 1e3:.3f} ms a "
          f"chunk | data cells max |err| {data_err:.3e} m, max above surf "
          f"- 1 {above:.3e} m, max below the lower bound {below:.3e} m | "
          f"krige at {GRID}^2 in {t_krige:.2f} s, data max |err| "
          f"{krige_err:.3e} m ({card})", flush=True)
    print(f"[geostats] {GEO_CUT}^2 cut, same call on the card "
          f"({t_cut_card:.2f} s) and the CPU ({t_cut_cpu:.2f} s): beds max "
          f"|card - CPU| {cpu_diff:.3e} m (bound {GEO_CPU_ATOL:g}) | 2-chain "
          f"CRF farm from the two beds, {GEO_FARM_STEPS} steps: loss "
          f"{farm_loss[:, 0].mean():.6e} -> {farm_loss[:, -1].mean():.6e} | "
          f"TF32 {tf32} | checks {checks}", flush=True)
    if not all(checks.values()):
        raise RuntimeError(f"geostats checks failed: {checks}")

    # the A/B: the same calls on the eager loop, and a Matérn bed both ways
    with _geo_loops("eager"):
        t0 = time.perf_counter()
        exp_eager = generate_initial_beds(xx, yy, cond, vario, n_beds=1,
                                          **beds_kw)[0]
        t_exp_eager = time.perf_counter() - t0
        t0 = time.perf_counter()
        maps_eager = krige(xx, yy, cond, vario, radius=GEO_KW["radius"],
                           num_points=GEO_KW["num_points"],
                           half_window=GEO_KW["half_window"], device=DEVICE)
        t_krige_eager = time.perf_counter() - t0
    matern = dict(vario, vtype="Matern", s=GEO_MATERN_S)
    mat = {}
    for way in ("graph", "eager"):
        with _geo_loops(way) as captures:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            bed = generate_initial_beds(xx, yy, cond, matern, n_beds=1,
                                        **beds_kw)[0]
            mat[way] = dict(bed=bed, s=time.perf_counter() - t0,
                            peak=torch.cuda.max_memory_allocated() - base,
                            capture_ms=[ms for _, ms in captures])
    mat_above = float((mat["graph"]["bed"][~m] - (surf[~m] - 1.0)).max())
    mat_below = float((lower - mat["graph"]["bed"][~m]).max())
    krige_chunks = -(-n_cells // 256)
    ab = {
        "exponential bed captured = eager bitwise": _same_array(beds[0],
                                                                exp_eager),
        "Matern bed captured = eager bitwise": _same_array(
            mat["graph"]["bed"], mat["eager"]["bed"]),
        "krige maps captured = eager bitwise": all(
            _same_array(a, b) for a, b in zip((mean, std), maps_eager)),
        "Matern bed within the bounds": max(mat_above, mat_below)
        <= GEO_BOUND_ATOL,
        "one capture a bed": len(mat["graph"]["capture_ms"]) == 1,
    }
    print(f"[geostats] eager -> captured chunk loop at {GRID}^2, one "
          f"process: exponential bed {t_exp_eager:.2f} -> {per_bed:.2f} s "
          f"({t_exp_eager / n_chunks * 1e3:.3f} -> "
          f"{per_bed / n_chunks * 1e3:.3f} ms a chunk) | Matern s "
          f"{GEO_MATERN_S} bed {mat['eager']['s']:.2f} -> "
          f"{mat['graph']['s']:.2f} s ({mat['eager']['s'] / n_chunks * 1e3:.3f}"
          f" -> {mat['graph']['s'] / n_chunks * 1e3:.3f} ms a chunk), "
          f"capture {mat['graph']['capture_ms']} ms, peak memory above the "
          f"start eager {mat['eager']['peak'] / 2**20:.1f} MiB, captured "
          f"{mat['graph']['peak'] / 2**20:.1f} MiB (added "
          f"{(mat['graph']['peak'] - mat['eager']['peak']) / 2**20:.1f} "
          f"MiB) | krige {t_krige_eager:.2f} -> {t_krige:.2f} s a map "
          f"({krige_chunks} chunks of 256) | Matern max above surf - 1 "
          f"{mat_above:.3e} m, below the lower bound {mat_below:.3e} m | "
          f"checks {ab} ({card})", flush=True)
    if not all(ab.values()):
        raise RuntimeError(f"geostats A/B checks failed: {ab}")
    rows = {way: _profiled_chunks(p, vario, (lower, surf - 1.0), card, way)
            for way in ("eager", "graph")}
    # what the pinned cuBLAS LU costs the device a chunk against MAGMA's
    rows["eager-default-lu"] = _profiled_chunks(
        p, vario, (lower, surf - 1.0), card, "eager", pinned=False)
    return dict(seconds_per_bed=per_bed, chunks=n_chunks, profiled=rows)


def make_srf_chain(p):
    """The CRF headline chain with the gstools-SRF generation method."""
    chain = make_chain(p)
    chain._rf_cfg = dataclasses.replace(chain._rf_cfg, spectral=False)
    return chain


def _srf_operands(gen, n, model, isotropic, dev):
    """(kv, z1, z2) of ``n`` chains from ``gen``: the ranges 10-50 km
    (and, anisotropic, azimuths), as the farm draws them."""
    import torch

    from mcmc_tpu_torch.ops.srf import draw_srf, sample_wavevectors

    u, theta, z1, z2, angle = draw_srf(gen, n, isotropic, dev)
    rx = 10e3 + 40e3 * torch.rand((n,), generator=gen, device=dev)
    ry = rx if isotropic else 10e3 + 40e3 * torch.rand(
        (n,), generator=gen, device=dev)
    return sample_wavevectors(u, theta, model, rx, ry, 1.3, angle), z1, z2


def srf_separable_torch(kv, z1, z2, ny, nx, res):
    """The separable form as PyTorch ops, the SRF kernel's yardstick,
    which the port never calls: the products a and b, sin and cos of
    each, then one ``torch.bmm`` (float32, "highest": no TF32)."""
    import torch

    from mcmc_tpu_torch.ops.srf_kernel import srf_norm

    x = torch.arange(nx, dtype=torch.float32, device=kv.device) * float(res)
    y = torch.arange(ny, dtype=torch.float32, device=kv.device) * float(res)
    a = x[None, :, None] * kv[:, 0, None, :]
    b = y[None, :, None] * kv[:, 1, None, :]
    cb, sb = torch.cos(b), torch.sin(b)
    w1, w2 = z1[:, None, :], z2[:, None, :]
    left = torch.cat([w1 * cb + w2 * sb, w2 * cb - w1 * sb], dim=-1)
    right = torch.cat([torch.cos(a), torch.sin(a)], dim=-1)
    return torch.bmm(left, right.transpose(1, 2)) * srf_norm(kv.shape[-1])


@contextlib.contextmanager
def _float32_matmul_highest():
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


def _srf_kernel_cases(card):
    """The SRF kernel at the farm's headline (768 chains x 80 x 80,
    Matern), with anisotropic Exponential ranges and azimuths, and at one
    512 x 512 field: checks (i) against the float64 separable field and
    (ii) against the plain version within the phase's rounding bound,
    every cell; chain 5's field alone bitwise its field in the headline's
    batch; each case's launch, time, plain time, the ``torch.bmm``
    yardstick's time and both forms of the bound.  Returns the headline's
    kernel-table row."""
    import torch

    from mcmc_tpu_torch.ops.srf_kernel import (srf_harmonics,
                                               srf_harmonics_reference,
                                               srf_kernel_info)
    from mcmc_tpu_torch.testing import (srf_rounding_bound,
                                        srf_separable_float64)

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    row = None
    B = 80  # the headline's canvas: blocks up to 80
    for tag, model, iso, n, ny, nx in (
            ("headline", "Matern", True, N_CHAINS, B, B),
            ("exponential-aniso", "Exponential", False, N_CHAINS, B, B),
            ("field", "Matern", True, 1, SRF_FIELD, SRF_FIELD)):
        kv, z1, z2 = _srf_operands(gen, n, model, iso, dev)
        M = kv.shape[-1]
        op = (kv, z1, z2, ny, nx, RES)
        got = srf_harmonics(*op)
        want = srf_harmonics_reference(*op)
        sep = srf_separable_float64(*op)
        bound = srf_rounding_bound(*op)
        err_sep = float((got.double() - sep).abs().max())
        err = (got.double() - want.double()).abs()
        max_err = float(err.max())
        excess = float((err - bound).max())
        beyond = int((err > SRF_ATOL).sum())
        with _float32_matmul_highest():
            yard = srf_separable_torch(*op)
            yard_err = float((yard.double() - sep).abs().max())
            del yard
            plain_ms, ms = _pair_times(srf_harmonics_reference,
                                       srf_harmonics, [op] * SRF_TIMED)
            yard_ms = _time_ops(srf_separable_torch, [op] * SRF_TIMED)
        info = srf_kernel_info(ny, nx)
        work = float(n) * ny * nx * M
        moved = 4.0 * (4 * n * M + n * ny * nx)
        f32_ms, _ = _bound(moved, 4.0 * work)
        bound_ms, by = _bound(moved, 3 * 2.0 * 2 * work, TF32_TFLOPS)
        alone = ""
        if n > 5:
            one = srf_harmonics(kv[5:6], z1[5:6], z2[5:6], ny, nx, RES)
            same = bool(torch.equal(one[0], got[5]))
            alone = f" | chain 5 alone bitwise its field in the batch: {same}"
            if not same:
                raise RuntimeError("the SRF kernel gives chain 5 other bits "
                                   f"alone than in a batch of {n}")
        print(f"[srf] kernel {tag}: {model} {n} x {ny} x {nx}, M {M}: (i) max "
              f"|kernel - separable float64| {err_sep:.3e} (bound "
              f"{SRF_ATOL:g}) | (ii) max |kernel - plain| {max_err:.3e}, "
              f"largest rounding bound {float(bound.max()):.3e}, largest "
              f"excess over it {excess:.3e} (bound {SRF_ATOL:g}); {beyond} "
              f"cells beyond {SRF_ATOL:g} of the plain version{alone} "
              f"({card})", flush=True)
        print(f"[srf] kernel {tag}: {ms:.4f} ms a launch ({work / ms / 1e6:.2f}"
              f" G terms/s), plain {plain_ms:.4f} ms, torch.bmm yardstick "
              f"{yard_ms:.4f} ms (max |err| {yard_err:.3e} against the "
              f"separable float64) | bound {bound_ms:.4f} ms ({by}: 3xTF32 "
              f"at {TF32_TFLOPS} TFLOP/s, {n * (ny + nx) * M:.3e} sincosf "
              f"pairs beside it) -> {bound_ms / ms:.3f} of it; direct form's "
              f"{f32_ms:.4f} ms (4 float32 operations a term at "
              f"{F32_TFLOPS} TFLOP/s) -> {f32_ms / ms:.3f} | tile "
              f"{info['tile']}, {info['threads']} threads, "
              f"{info['registers']} registers, {info['local_bytes']} local "
              f"bytes, {info['shared_bytes']} shared bytes, "
              f"{info['resident_ctas_per_sm']} resident CTAs/SM ({card})",
              flush=True)
        if err_sep > SRF_ATOL or excess > SRF_ATOL:
            raise RuntimeError(f"the SRF kernel fails its checks ({tag}: "
                               f"(i) {err_sep:.3e}, (ii) excess "
                               f"{excess:.3e}, bound {SRF_ATOL:g})")
        if not torch.isfinite(got).all():
            raise RuntimeError(f"non-finite SRF fields ({tag})")
        if tag == "headline":
            row = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=by, library_ms=None)
        del got, want, sep, bound, err
    return row


def _srf_step_vs_plain(chain, card):
    """The SRF step on its kernels (SRF, window) against the plain step
    from the same state and generator state: SRF_PARITY_STEPS steps at
    768 chains, at most FLIP_RATE_MAX of the MH decisions flipping."""
    import torch

    from mcmc_tpu_torch.models.chain_crf import init_state, make_step
    from mcmc_tpu_torch.utils.rng import make_generator

    static, consts = chain.build(torch.device(DEVICE))
    fused = make_step(static, "auto")
    plain = make_step(static, "eager")
    state = init_state(chain.initial_bed, consts, N_CHAINS)
    gen = make_generator(6, DEVICE)
    n_flip = 0
    for _ in range(SRF_PARITY_STEPS):
        shadow = _clone_state(state)
        gen_p = torch.Generator(device=DEVICE)
        gen_p.set_state(gen.get_state())
        _, tr_p = plain(consts, shadow, gen_p)
        del shadow
        state, tr = fused(consts, state, gen)
        n_flip += int((tr["step"] != tr_p["step"]).sum())
    flip_rate = n_flip / (SRF_PARITY_STEPS * N_CHAINS)
    print(f"[srf] step: {SRF_PARITY_STEPS} steps x {N_CHAINS} chains on the "
          f"kernels against the plain step (same draws): MH flips {n_flip} "
          f"= {flip_rate:.3e} (bound {FLIP_RATE_MAX:g}) ({card})",
          flush=True)
    if flip_rate > FLIP_RATE_MAX:
        raise RuntimeError("the SRF step on the kernels departs from the "
                           "plain one")


def _srf_main_path(chain, card):
    """ChainCRF -> MultiChainSampler(chain, 768) -> init(seeds=0) ->
    run(SRF_SEGMENTS x SRF_SEGMENT) -> diagnostics with the SRF method:
    the SRF and window kernels once a step, the noise kernel never; the
    loss finite and falling, acceptance in (0.02, 0.98), the bed outside
    the update region untouched; then a profiled window.  Returns the
    SRF kernel's launches."""
    import torch

    from mcmc_tpu_torch import MultiChainSampler
    from mcmc_tpu_torch.ops.noise_kernel import (batched_normal,
                                                 batched_normal_keyed)
    from mcmc_tpu_torch.ops.srf_kernel import srf_harmonics
    from mcmc_tpu_torch.ops.window_kernel import fused_window_update

    kernels = (srf_harmonics, fused_window_update, batched_normal,
               batched_normal_keyed)
    sampler = MultiChainSampler(chain, N_CHAINS, device=DEVICE)
    states = sampler.init(seeds=0)
    bed0 = states.bed[0].clone()
    n_iter = SRF_SEGMENTS * SRF_SEGMENT + 1
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, traces = sampler.run(states, n_iter, segment_size=SRF_SEGMENT,
                                 progress=False)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    steps = n_iter - 1
    loss = traces["loss"]
    acc = float(np.mean(traces["step"][:, 1:]))
    outside = ~(sampler.consts.update_mask > 0)
    moved = int((states.bed[:, outside] != bed0[outside]).sum())
    diag = sampler.diagnostics(traces, elapsed)
    print(f"[srf] main path: {steps} steps x {N_CHAINS} chains in "
          f"{elapsed:.3f} s: {diag['chain_iters_per_sec']:,.0f} chain-it/s, "
          f"{elapsed / steps * 1e3:.3f} ms a step | ESS(loss) "
          f"{diag['ess_loss']:.1f} | acc {acc:.3f} | loss mean "
          f"{loss[:, 0].mean():.6e} -> {loss[:, -1].mean():.6e} | launches "
          f"{launches} ({card})", flush=True)
    want = {"srf_harmonics": steps, "fused_window_update": steps,
            "batched_normal": 0, "batched_normal_keyed": 0}
    if launches != want:
        raise RuntimeError(f"SRF main path launches {launches}, want {want}")
    if not np.isfinite(loss).all():
        raise RuntimeError("non-finite loss on the SRF main path")
    if not loss[:, -1].mean() < loss[:, 0].mean():
        raise RuntimeError("the SRF loss did not decrease")
    if not 0.02 < acc < 0.98:
        raise RuntimeError(f"SRF acceptance {acc:.3f} outside (0.02, 0.98)")
    if moved:
        raise RuntimeError(f"{moved} bed cells outside the update region "
                           "changed on the SRF path")
    busy_share(sampler, states, card, elapsed / steps * 1e6, n_steps=20,
               watch=("srf",), tag="srf-profile")
    return launches["srf_harmonics"]


def _srf_seed_list(chain, card):
    """A 768-seed SRF farm and the 1-chain farm of its first seed,
    SRF_SEED_STEPS steps each: one draw-kernel launch a step and no keyed
    noise; chain 0's draws bitwise equal (and its traces, reported)."""
    import torch

    from mcmc_tpu_torch import MultiChainSampler
    from mcmc_tpu_torch.ops.chain_draws import chain_draws
    from mcmc_tpu_torch.ops.noise_kernel import batched_normal_keyed
    from mcmc_tpu_torch.ops.srf_kernel import srf_harmonics

    n_iter = SRF_SEED_STEPS + 1
    kernels = (chain_draws, batched_normal_keyed, srf_harmonics)
    traces = {}
    for n in (N_CHAINS, 1):
        for k in kernels:
            k.launches = 0
        sampler = MultiChainSampler(chain, n, device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, traces[n] = sampler.run(sampler.init(seeds=_seed_list(n)),
                                   n_iter, segment_size=n_iter,
                                   progress=False)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels}
        print(f"[srf] seed-listed {n} chains, seeds [{_seed_list(n)[0]}, "
              f"...]: {SRF_SEED_STEPS} steps in {elapsed:.3f} s | launches "
              f"{launches} ({card})", flush=True)
        want = {"chain_draws": SRF_SEED_STEPS, "batched_normal_keyed": 0,
                "srf_harmonics": SRF_SEED_STEPS}
        if launches != want:
            raise RuntimeError(f"seed-listed SRF launches {launches}")
    n_diff, n_values = _draws_vs_chain0(chain, N_CHAINS, SRF_SEED_STEPS)
    same = {k: bool(np.array_equal(traces[N_CHAINS][k][0], traces[1][k][0],
                                   equal_nan=True))
            for k in ("loss", "step", "block")}
    print(f"[srf] chain 0 of {N_CHAINS} against the 1-chain farm: "
          f"{n_diff} of {n_values:,} draw values differ over "
          f"{SRF_SEED_STEPS} steps (bound 0) | traces bitwise (not gated): "
          f"{same} ({card})", flush=True)
    if n_diff:
        raise RuntimeError("chain 0's SRF draws depend on the other chains")


def _srf_cli_config(n_iter, out):
    """``make_srf_chain``'s configuration as a CLI config."""
    return {
        "family": "crf", "dataset": "dataset.npz",
        "update_region": {"in_region": True, "mask": "region"},
        "loss": {"sigma_mc": SIGMA_MC, "mass_conv_in_region": True},
        "crf": {
            "update_type": "CRF_weight",
            "randfield": {"range_min_x": 10e3, "range_max_x": 50e3,
                          "range_min_y": 10e3, "range_max_y": 50e3,
                          "scale_min": 50, "scale_max": 150,
                          "nugget_max": 0.0, "model_name": "Matern",
                          "isotropic": True, "smoothness": 1.3,
                          "spectral": False},
            "blocks": {"min_block_x": 50, "max_block_x": 80,
                       "min_block_y": 50, "max_block_y": 80, "steps": 5},
            "weight": {"L": 2, "x0": 0, "k": 6, "offset": 1,
                       "max_dist": 30e3}},
        "farm": {"n_chains": N_CHAINS, "n_iter": n_iter, "rng_seeds": 0,
                 "output_path": out, "segment_size": 100,
                 "checkpoint_every": SRF_ENTRY_ITERS[0]},
        "save": {"final_beds": f"{out}_beds.npy",
                 "histories": f"{out}_hist.npz"}}


def _srf_entry(p, card):
    """The CLI with ``crf.randfield.spectral: false`` at 768 chains:
    SRF_ENTRY_ITERS[0] iterations resumed to SRF_ENTRY_ITERS[1], bitwise
    against an uninterrupted run in traces and final beds."""
    from mcmc_tpu_torch.ops.srf_kernel import srf_harmonics

    first, total = SRF_ENTRY_ITERS
    srf_harmonics.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT) as tmp:
        tmp = Path(tmp)
        _write_dataset(p, tmp / "dataset.npz")
        t0 = time.perf_counter()
        for n_iter, out in ((first, "resumed"), (total, "resumed"),
                            (total, "straight")):
            _cli_run(tmp, _srf_cli_config(n_iter, out))
        elapsed = time.perf_counter() - t0
        same = {}
        with np.load(tmp / "resumed_hist.npz") as a, \
                np.load(tmp / "straight_hist.npz") as b:
            for key in a.files:
                same[key] = bool(np.array_equal(
                    a[key], b[key], equal_nan=a[key].dtype.kind == "f"))
            loss = a["loss"]
        same["final_beds"] = bool(np.array_equal(
            np.load(tmp / "resumed_beds.npy"),
            np.load(tmp / "straight_beds.npy")))
    steps = (first - 1) + (total - first) + (total - 1)
    print(f"[srf] entry: the SRF CRF farm, {N_CHAINS} chains x {GRID}^2 "
          f"through python -m mcmc_tpu_torch: {first} iterations resumed to "
          f"{total} and {total} straight in {elapsed:.1f} s with builds and "
          f"checkpoints | resumed == uninterrupted, bitwise: {same} | loss "
          f"mean {loss[:, 0].mean():.6e} -> {loss[:, -1].mean():.6e} | SRF "
          f"kernel launches {srf_harmonics.launches} in {steps} steps "
          f"({card})", flush=True)
    if not all(same.values()):
        raise RuntimeError("the resumed SRF farm departs from the "
                           "uninterrupted one")
    if loss.shape != (N_CHAINS, total) or not np.isfinite(loss).all():
        raise RuntimeError(f"SRF CLI traces {loss.shape}")
    if srf_harmonics.launches != steps:
        raise RuntimeError(f"the SRF kernel ran {srf_harmonics.launches} "
                           f"times in {steps} steps")


def _srf_random_field(card):
    """``RandField.get_random_field`` at 512^2 by the SRF method: seconds
    a field, one kernel launch a field, the same seed's bits again."""
    import torch

    from mcmc_tpu_torch.models.randfield import RandField
    from mcmc_tpu_torch.ops.srf_kernel import srf_harmonics

    def wrapper():
        rf = RandField(10e3, 50e3, 10e3, 50e3, 50, 150, 0.0, "Matern", True,
                       1.3, rng_seed=77, device=DEVICE)
        rf.set_generation_method(False)
        return rf

    X = np.arange(SRF_FIELD) * RES
    rf = wrapper()
    first = rf.get_random_field(X, X)  # warm
    srf_harmonics.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fields = rf.get_random_field(X, X, SRF_FIELDS)
    seconds = (time.perf_counter() - t0) / SRF_FIELDS
    launches = srf_harmonics.launches
    again = wrapper().get_random_field(X, X)
    same = bool(np.array_equal(first, again))
    stds = fields.reshape(SRF_FIELDS, -1).std(axis=1)
    print(f"[srf] get_random_field {SRF_FIELD}^2 (SRF): {seconds:.4f} s a "
          f"field over {SRF_FIELDS}, {launches} kernel launches | field "
          f"std {np.round(stds, 2).tolist()} (scaled, not standardized) | "
          f"same seed bitwise: {same} ({card})", flush=True)
    if launches != SRF_FIELDS or not same:
        raise RuntimeError("get_random_field by the SRF method: launches "
                           f"{launches}, same seed {same}")
    if fields.shape != (SRF_FIELDS, SRF_FIELD, SRF_FIELD) or not (
            np.isfinite(fields).all()):
        raise RuntimeError(f"SRF fields {fields.shape}")


def phase_srf(p, card):
    """The gstools-SRF proposal method (``[srf]``, module docstring phase
    19): the SRF kernel against its plain version, the SRF step against
    the plain step, the SRF farm's main path, the seed-listed pair, the
    CLI resumed bitwise and ``get_random_field`` at 512^2.  Returns (the
    kernel table's row, the SRF kernel's launches on the main path)."""
    row = _srf_kernel_cases(card)
    chain = make_srf_chain(p)
    _srf_step_vs_plain(chain, card)
    launches = _srf_main_path(chain, card)
    _srf_seed_list(chain, card)
    _srf_entry(p, card)
    _srf_random_field(card)
    return row, launches


# -- [dist]: multi-GPU ranks (phase 20) --------------------------------------

DIST_STEPS = 200         # [dist] (a), (b): steps of each farm
DIST_SEGMENT = 100       # [dist]: segment size of those farms
DIST_GRID = {"chain": (1000, 900), "chains": (100, GRID)}  # steps, side
DIST_GRID_SEED = 5
DIST_ENTRY_ITERS = (400, 600, 800)  # [dist] (d): 2 ranks, 2 ranks, 1 rank
DIST_ENTRY_CHAINS = 64
DIST_TIMEOUT = 300       # s, each torchrun launch
GRID_RTOL, GRID_ATOL = 1e-5, 1e-3  # tests/test_parallel.py:277-283
DIST_FARMS = (("crf", "int"), ("crf", "list"), ("sgs", "int"))


def _dist_kernels(family):
    """The kernel wrappers a family's farm launches once a step."""
    if family == "crf":
        from mcmc_tpu_torch.ops.chain_draws import chain_draws
        from mcmc_tpu_torch.ops.noise_kernel import (batched_normal,
                                                     batched_normal_keyed)
        from mcmc_tpu_torch.ops.window_kernel import fused_window_update

        return (fused_window_update, batched_normal, batched_normal_keyed,
                chain_draws)
    from mcmc_tpu_torch.ops.cg_kernel import mix_masked_cg
    from mcmc_tpu_torch.ops.lut_kernel import lut_interp
    from mcmc_tpu_torch.ops.sgs_window_kernel import (window_extract,
                                                      window_writeback)

    return (window_extract, mix_masked_cg, lut_interp, window_writeback)


def _bit_sums(fields):
    """(N, 2) int64 checksums of each chain's bits: the sum of its float32
    bit patterns, and their sum weighted by position.  Equal sums on
    every chain stand for a bitwise match without moving 2 GB of state
    to the host."""
    import torch

    out = []
    for part in fields.split(32):
        bits = part.reshape(part.shape[0], -1).view(torch.int32).to(
            torch.int64)
        w = torch.arange(bits.shape[1], device=bits.device) % 65521 + 1
        out.append(torch.stack([bits.sum(1), (bits * w).sum(1)], 1))
    return torch.cat(out).cpu().numpy()


def _dist_farm(p, family, seeding, mesh=None, use_mesh=True):
    """One farm of the [dist] phase, DIST_STEPS steps in segments of
    DIST_SEGMENT: (sampler, final states, traces, seconds, launches)."""
    import torch

    from mcmc_tpu_torch import MultiChainSampler

    chain = make_chain(p) if family == "crf" else make_sgs_chain(p)
    n = N_CHAINS if family == "crf" else SGS_CHAINS
    sampler = MultiChainSampler(chain, n, mesh=mesh, use_mesh=use_mesh,
                                device=DEVICE)
    states = sampler.init(seeds=0 if seeding == "int" else _seed_list(n))
    kernels = _dist_kernels(family)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, traces = sampler.run(states, DIST_STEPS + 1,
                                 segment_size=DIST_SEGMENT, progress=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (sampler, states, traces, seconds,
            {k.__name__: k.launches for k in kernels})


def _gather_ms(sampler):
    """ms to gather one segment's traces over the ranks, on buffers of a
    segment's shapes (the gathers ``run`` makes at a segment's end)."""
    import torch

    from mcmc_tpu_torch.parallel.sampler import trace_buffers

    bufs = trace_buffers(sampler.static, sampler.rows[1] - sampler.rows[0],
                         DIST_SEGMENT, sampler.device)
    for v in bufs.values():
        v.zero_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for v in bufs.values():
        sampler.gather(v, dim=1)
    return (time.perf_counter() - t0) * 1e3


def _count_collectives():
    """Count this process's all_gather / all_reduce calls (the grid's two
    collectives) in a dict, by wrapping torch.distributed's functions."""
    import torch.distributed as dist

    counts = {"all_gather": 0, "all_reduce": 0}
    for name in counts:
        fn = getattr(dist, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)

        setattr(dist, name, counted)
    return counts


def _grid_run(kind, mesh, out=None):
    """``make_sharded_crf_chain`` on the native 900 x 900 problem, or
    ``make_sharded_crf_chains`` at 768 chains x 512^2, on ``mesh``: (bed
    or beds of this rank's rows, losses, steps, seconds)."""
    import torch

    from mcmc_tpu_torch.parallel import (make_sharded_crf_chain,
                                         make_sharded_crf_chains,
                                         shard_grid_arrays)
    from mcmc_tpu_torch.parallel.grid_sharded import shard_crf_consts

    steps, side = DIST_GRID[kind]
    p = build_problem(H=side, W=side)
    static, consts = make_chain(p).build(DEVICE)
    local = shard_crf_consts(mesh, consts)
    bed = shard_grid_arrays(mesh, p["initial_bed"].astype(np.float32))
    gen = torch.Generator(device=mesh.device).manual_seed(DIST_GRID_SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if kind == "chain":
        bed, losses, acc = make_sharded_crf_chain(mesh, static)(
            bed, local, steps, rng=gen)
    else:
        beds = bed.expand(N_CHAINS, -1, -1).contiguous()
        bed, losses, acc = make_sharded_crf_chains(mesh, static)(
            beds, local, steps, rng=gen)
    torch.cuda.synchronize()
    return bed, losses, acc, time.perf_counter() - t0


def _dist_worker(case, out):
    """One rank of a [dist] launch (``chip_smoke.py --dist-worker CASE
    OUT`` under torchrun); writes its results into OUT."""
    import torch

    from mcmc_tpu_torch.parallel import (chains_grid_mesh,
                                         global_chains_mesh,
                                         initialize_distributed)
    from mcmc_tpu_torch.parallel.distributed import world

    out = Path(out)
    if case == "nccl":
        initialize_distributed()
        assert torch.distributed.get_backend() == "nccl"
    else:  # every rank on card 0, over gloo
        initialize_distributed(local_device_ids=[0], backend="gloo")
    rank, size = world()
    p = build_problem()
    result = {"rank": rank, "world": size}
    if case == "nccl":
        # the mesh-less farm first, to warm the process (cuFFT plans,
        # kernel libraries), then the farm on the mesh and again without
        mesh = global_chains_mesh()
        runs = [_dist_farm(p, "crf", "int", mesh=m, use_mesh=False)
                for m in (None, mesh, None)]
        (s1, st1, tr1, sec1, l1), (_, st2, tr2, sec2, _) = runs[1:]
        result.update(
            traces_same=all(np.array_equal(tr1[k], tr2[k], equal_nan=True)
                            for k in tr1),
            beds_same=bool(torch.equal(st1.fields, st2.fields)),
            us_step=[sec1 / DIST_STEPS * 1e6, sec2 / DIST_STEPS * 1e6],
            launches=l1, mesh=s1.mesh.shape)
    else:  # "gloo": (b)'s farms, then (c)'s grid, in one launch
        for family, seeding in DIST_FARMS:
            sampler, states, traces, sec, launches = _dist_farm(
                p, family, seeding)
            tag = f"{family}_{seeding}"
            result[tag] = {"us_step": sec / DIST_STEPS * 1e6,
                           "gather_ms": _gather_ms(sampler),
                           "launches": launches, "rows": sampler.rows}
            np.save(out / f"{tag}.sums.rank{rank}.npy",
                    _bit_sums(states.fields))
            if rank == 0:
                np.savez(out / f"{tag}.traces.npz", **traces)
            del sampler, states
            torch.cuda.empty_cache()
        counts = _count_collectives()
        for kind in DIST_GRID:
            mesh = chains_grid_mesh(1, size)
            before = dict(counts)
            bed, losses, acc, sec = _grid_run(kind, mesh)
            # the initial residual and loss make one of each
            result[kind] = {
                "us_step": sec / DIST_GRID[kind][0] * 1e6,
                "collectives_per_step": {
                    k: (counts[k] - before[k] - 1) / DIST_GRID[kind][0]
                    for k in counts}}
            np.save(out / f"grid_{kind}.bed.rank{rank}.npy",
                    bed.cpu().numpy())
            np.savez(out / f"grid_{kind}.rank{rank}.npz",
                     losses=losses.cpu().numpy(), steps=acc.cpu().numpy())
    (out / f"{case}.rank{rank}.json").write_text(json.dumps(result))
    return 0


def _torchrun(n, args, label):
    """``python -m torch.distributed.run --standalone --nproc-per-node n
    ARGS`` from the checkout, under a timeout; its output, or a raise
    with its tail if a rank failed."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=DIST_TIMEOUT, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"[dist] {label}: torchrun exited "
                           f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-6000:]}")
    return proc.stdout, seconds


def _worker_results(out, case, n):
    return [json.loads((out / f"{case}.rank{k}.json").read_text())
            for k in range(n)]


def _dist_nccl(out, card):
    """(a) one NCCL rank: the CRF headline through a one-rank mesh against
    the same farm without one, bitwise."""
    _, seconds = _torchrun(1, [str(ROOT / "chip_smoke.py"), "--dist-worker",
                               "nccl", str(out)], "(a)")
    r = _worker_results(out, "nccl", 1)[0]
    ok = r["traces_same"] and r["beds_same"]
    print(f"[dist] (a) 1 NCCL rank, CRF {N_CHAINS} x {GRID}^2, {DIST_STEPS} "
          f"steps through MultiChainSampler(mesh=global_chains_mesh()) "
          f"{r['mesh']}: traces bitwise the mesh-less farm's "
          f"{r['traces_same']}, final state {r['beds_same']} | "
          f"{r['us_step'][0]:.1f} us/step on the mesh, "
          f"{r['us_step'][1]:.1f} without (after a warm-up farm) | "
          f"launches {r['launches']} | launch {seconds:.1f} s ({card})",
          flush=True)
    if not ok:
        raise RuntimeError("(a) the one-rank mesh departs from the farm")
    if r["launches"]["fused_window_update"] != DIST_STEPS:
        raise RuntimeError(f"(a) launches {r['launches']}")


def _dist_farms(p, out, ranks, card):
    """(b) two gloo ranks on card 0 (``ranks``: their results): each
    farm's gathered traces and every chain's final state against the
    one-rank farm, bitwise."""
    import torch

    for family, seeding in DIST_FARMS:
        tag = f"{family}_{seeding}"
        _, states, traces, sec, _ = _dist_farm(p, family, seeding,
                                               use_mesh=False)
        sums = _bit_sums(states.fields)
        del states
        torch.cuda.empty_cache()
        with np.load(out / f"{tag}.traces.npz") as z:
            same = {k: bool(np.array_equal(z[k], traces[k], equal_nan=True))
                    for k in traces}
        got = np.concatenate([np.load(out / f"{tag}.sums.rank{k}.npy")
                              for k in range(2)])
        state_same = bool(np.array_equal(got, sums))
        steps = DIST_STEPS
        runs = [r[tag] for r in ranks]
        launches_ok = all(
            n in (0, steps) and (n == steps or name in (
                "batched_normal", "batched_normal_keyed", "chain_draws"))
            for r in runs for name, n in r["launches"].items())
        print(f"[dist] (b) 2 gloo ranks on card 0, {family} {seeding}-seeded "
              f"{traces['loss'].shape[0]} chains x {GRID}^2, {steps} steps: "
              f"gathered traces bitwise the 1-rank farm's {same}, final "
              f"states (per-chain bit checksums) {state_same} | rank us/step "
              f"{[round(r['us_step'], 1) for r in runs]} (1 rank alone "
              f"{sec / steps * 1e6:.1f}) | gather ms a segment "
              f"{[round(r['gather_ms'], 2) for r in runs]} | launches "
              f"{[r['launches'] for r in runs]} ({card})", flush=True)
        if not (all(same.values()) and state_same and launches_ok):
            raise RuntimeError(f"(b) the 2-rank {tag} farm departs from the "
                               "1-rank farm")


def _dist_grid(out, ranks, card):
    """(c) the row-sharded grid on 2 gloo ranks of card 0 (``ranks``:
    their results) against grid 1 on the card, under the JAX package's
    gates."""
    import torch

    from mcmc_tpu_torch.parallel import chains_grid_mesh

    for kind, (steps, side) in DIST_GRID.items():
        bed1, loss1, acc1, sec1 = _grid_run(
            kind, chains_grid_mesh(1, 1, device=DEVICE))
        loss1, acc1 = loss1.cpu().numpy(), acc1.cpu().numpy()
        half = side // 2
        errs, beds_ok, same_steps, loss_rel = [], True, True, 0.0
        bitwise = True
        for k in range(2):
            bed = torch.from_numpy(np.load(
                out / f"grid_{kind}.bed.rank{k}.npy")).to(bed1.device)
            with np.load(out / f"grid_{kind}.rank{k}.npz") as z:
                losses, acc = z["losses"], z["steps"]
            want = bed1[..., k * half:(k + 1) * half, :]
            errs.append(float((bed - want).abs().max()))
            beds_ok &= bool(torch.allclose(bed, want, rtol=GRID_RTOL,
                                           atol=GRID_ATOL))
            bitwise &= bool(torch.equal(bed, want)
                            and np.array_equal(losses, loss1))
            del bed, want
            same_steps &= bool(np.array_equal(acc, acc1))
            loss_rel = max(loss_rel, float(np.max(np.abs(losses - loss1)
                                                  / np.abs(loss1))))
        del bed1
        torch.cuda.empty_cache()
        runs = [r[kind] for r in ranks]
        what = "1 chain" if kind == "chain" else f"{N_CHAINS} chains"
        print(f"[dist] (c) {kind}: {what} x {side}^2, mesh (1 x 2), {steps} "
              f"steps: accepted steps equal "
              f"{same_steps} ({int(acc1.sum())} accepted), loss max rel "
              f"{loss_rel:.3e} (rtol {GRID_RTOL:g}), bed max abs "
              f"{errs} within rtol {GRID_RTOL:g} / atol "
              f"{GRID_ATOL:g}: {beds_ok} (bed and loss bitwise: {bitwise})"
              f" | collectives a step "
              f"{runs[0]['collectives_per_step']} | rank us/step "
              f"{[round(r['us_step'], 1) for r in runs]} (grid 1 "
              f"{sec1 / steps * 1e6:.1f}) ({card})", flush=True)
        if not (same_steps and loss_rel <= GRID_RTOL and beds_ok
                and acc1.sum() > 0):
            raise RuntimeError(f"(c) the sharded {kind} departs from grid 1")


def _dist_entry(p, out, card):
    """(d) the CLI under torchrun: 2 ranks to 400, 2 ranks to 600, then 1
    rank to 800, bitwise an uninterrupted 1-rank 800."""
    first, second, total = DIST_ENTRY_ITERS
    _write_dataset(p, out / "dataset.npz")

    def config(n_iter, name):
        cfg = _sgs_config(n_iter, name)
        cfg["farm"].update(n_chains=DIST_ENTRY_CHAINS,
                           checkpoint_every=ENTRY_SEGMENT)
        path = out / f"{name}_{n_iter}.json"
        path.write_text(json.dumps(cfg))
        return path

    times = []
    for n_iter in (first, second):
        _, seconds = _torchrun(2, ["-m", "mcmc_tpu_torch",
                                   str(config(n_iter, "resumed")),
                                   "--quiet", "--backend", "gloo", "--card",
                                   "0"], "(d)")
        times.append(seconds)
    run_dir = out / "resumed" / "LargeScaleChain" / "root" / "SmallScaleChain"
    names = {f.name for f in run_dir.iterdir()}
    shards = {f"checkpoint_{second}.proc0of2.npz",
              f"checkpoint_{second}.proc1of2.npz", f"checkpoint_{second}.ok"}
    t0 = time.perf_counter()
    _cli_run(out, json.loads(config(total, "resumed").read_text()))
    times.append(time.perf_counter() - t0)
    _cli_run(out, json.loads(config(total, "straight").read_text()))
    same = {}
    with np.load(out / "resumed_hist.npz") as a, \
            np.load(out / "straight_hist.npz") as b:
        for key in a.files:
            same[key] = bool(np.array_equal(a[key], b[key], equal_nan=True))
        shape = a["loss"].shape
    same["final_beds"] = bool(np.array_equal(
        np.load(out / "resumed_beds.npy"), np.load(out / "straight_beds.npy")))
    print(f"[dist] (d) torchrun --nproc-per-node 2 -m mcmc_tpu_torch: SGS "
          f"spherical {DIST_ENTRY_CHAINS} chains x {GRID}^2 to {first} "
          f"({times[0]:.1f} s), to {second} ({times[1]:.1f} s) on 2 ranks, "
          f"then to {total} on 1 rank ({times[2]:.1f} s) | the 2-rank set "
          f"{sorted(shards & names)} | == uninterrupted 1-rank {total}, "
          f"bitwise: {same} ({card})", flush=True)
    if not shards <= names:
        raise RuntimeError(f"(d) no 2-rank checkpoint set: {sorted(names)}")
    if not all(same.values()) or shape != (DIST_ENTRY_CHAINS, total):
        raise RuntimeError("(d) the resumed 2-rank run departs from the "
                           "uninterrupted one")


def phase_dist(p, card):
    """Multi-GPU ranks (``[dist]``, module docstring phase 20): (a) one
    NCCL rank, (b) two gloo ranks' farms, (c) the row-sharded grid, (d)
    the CLI under torchrun resumed across rank counts."""
    import torch

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT) as tmp:
        tmp = Path(tmp)

        def gloo():  # (b) and (c) share one launch of two ranks
            _, seconds = _torchrun(2, [str(ROOT / "chip_smoke.py"),
                                       "--dist-worker", "gloo", str(tmp)],
                                   "(b), (c)")
            print(f"[dist] (b), (c) launch {seconds:.1f} s", flush=True)
            return _worker_results(tmp, "gloo", 2)

        ranks = []
        for tag, part in (("a", lambda: _dist_nccl(tmp, card)),
                          ("b, c launch", lambda: ranks.extend(gloo())),
                          ("b", lambda: _dist_farms(p, tmp, ranks, card)),
                          ("c", lambda: _dist_grid(tmp, ranks, card)),
                          ("d", lambda: _dist_entry(p, tmp, card))):
            t0 = time.perf_counter()
            part()
            print(f"[dist] ({tag}) part {time.perf_counter() - t0:.1f} s",
                  flush=True)


# -- [examples]: the tutorial workflow on the card (phase 21) ----------------

EXAMPLES = ROOT / "examples" / "torch_port"
EXAMPLE_RUNS = ("01_load_data", "02_statistical_analysis",
                "03_large_scale_chain", "04_small_scale_chain",
                "05_visualization", "06_convergence_validation",
                "07_native_production_grid", "08_cli_experiment",
                "09_distributed_pod")
# 06's production scale (its SCALES["cuda"]): the gate holds the example to it
VALIDATION_SCALE = {"grid": 512, "n_chains": 256, "crf_iters": 60_000,
                    "sgs_iters": 8_000}


def _example_module(name):
    """``examples/torch_port/<name>.py`` as a module (its file name starts
    with a digit, so it is loaded by path)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"torch_port_example_{name[:2]}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _example_gates(name, r, launches):
    """What [examples] holds each example's result to: (summary, the
    failed gates)."""
    crf = {k: launches.get(k, 0) for k in ("fused_window_update",
                                           "batched_normal")}
    sgs = {k: launches.get(k, 0) for k in ("window_extract",
                                           "window_writeback",
                                           "mix_masked_cg", "lut_interp")}
    tag = name[:2]
    if tag == "01":
        return (f"{r['grid'][0]}x{r['grid'][1]} grid, {r['data_cells']} data"
                f" cells, residual rms {r['residual_rms']:.3g}",
                [] if r["above_surface"] == 0 else ["picks above surface"])
    if tag == "02":
        return (f"{r['n_beds']} SGS beds in {r['seconds']:.1f} s, exponential"
                f" fit {r['fits']['exponential'][:2]}",
                [] if r["n_beds"] == 2 and not any(r["cells_above_surface"])
                else ["beds"])
    if tag == "03":
        steps = r["n_iter"] - 1
        bad = [] if set(crf.values()) == {steps} else ["launches"]
        if not np.all((r["acceptance"] > 0.05) & (r["acceptance"] < 0.95)):
            bad.append("acceptance")
        return (f"{r['n_iter']} iters x {len(r['acceptance'])} chains at "
                f"{r['grid']}^2 in {r['seconds']:.1f} s, acceptance "
                f"{np.round(r['acceptance'], 3).tolist()}, split R-hat "
                f"{r['split_rhat']:.4f}", bad)
    if tag == "04":
        steps = r["n_iter"] - 1
        bad = [] if launches.get("chain_draws") == steps else ["draws"]
        if set(sgs.values()) != {steps}:
            bad.append("launches")
        return (f"{r['n_iter']} iters x 2 chains at {r['grid']}^2 from "
                f"{'03' if r['from_03'] else 'fresh'} beds in "
                f"{r['seconds']:.1f} s, acceptance "
                f"{np.round(r['acceptance'], 3).tolist()}", bad)
    if tag == "05":
        return (f"{r['iterations']} iterations x {r['n_chains']} chains from "
                f"03's checkpoint, figure {r['figure']}, rank-normalized "
                f"R-hat {r.get('rank_normalized_rhat', float('nan')):.4f}, "
                f"ESS bulk {r.get('ess_bulk', float('nan')):.1f} / tail "
                f"{r.get('ess_tail', float('nan')):.1f}",
                [] if "ess_bulk" in r else ["diagnostics"])
    if tag == "06":
        s = r["stats"]
        scale = {k: r[k] for k in VALIDATION_SCALE}
        bad = list(r["failures"])
        if scale != VALIDATION_SCALE:
            bad.append(f"scale {scale}")
        if set(crf.values()) != {r["crf_iters"]}:
            bad.append("CRF launches")
        if set(sgs.values()) != {r["sgs_iters"]}:
            bad.append("SGS launches")
        return (f"{r['n_chains']} chains x {r['grid']}^2, {r['crf_iters']} "
                f"CRF + {r['sgs_iters']} SGS iters: CRF "
                f"{s['crf_chain_it_s']:,.0f} chain-it/s, SGS "
                f"{s['sgs_chain_it_s']:,.0f} chain-it/s, gap closed "
                f"{1 - s['gap_final'] / s['gap_initial']:.4f}, RMSE "
                f"{s['rmse_initial']:.2f} -> {s['rmse_posterior_mean']:.2f}"
                f" m, {'ALL PASS' if not r['failures'] else r['failures']}",
                bad)
    if tag == "07":
        s = r["stats"]
        bad = [] if s["grid"] == [900, 900] else ["grid"]
        if set(crf.values()) != {399}:
            bad.append("launches")
        return (f"{s['grid'][0]}x{s['grid'][1]} native, 4 chains x 400 "
                f"iters in {s['seconds']:.1f} s, acceptance "
                f"{s['acceptance']:.3f}, another grid's resume refused",
                bad)
    if tag == "08":
        return (f"CLI {r['n_iter'][0]} then {r['n_iter'][1]} iters at "
                f"{r['grid']}^2 ({r['seconds'][0]:.1f} s, "
                f"{r['seconds'][1]:.1f} s), first run reused bitwise "
                f"{r['bitwise_reused']}",
                [] if r["bitwise_reused"] else ["resume"])
    return (f"2 gloo ranks on card 0 ({r['seconds']:.1f} s): same global "
            f"trace {r['same_trace']}, {len(r['checkpoint_files'])} files "
            f"({[f for f in r['checkpoint_files'] if 'checkpoint' in f]}), "
            f"reassembled {tuple(r['reassembled'])}",
            [] if r["same_trace"] and tuple(r["reassembled"]) == (4, 96, 96)
            else ["ranks"])


def phase_examples(card):
    """The tutorial workflow (``[examples]``, module docstring phase 21):
    ``examples/torch_port`` 01 -> 09 in-process through their
    ``main(device="cuda")`` at their default scale, into one temporary
    directory under the checkout, each example's kernel launches counted
    from zero."""
    import os

    import torch

    kernels = {k.__name__: k for family in ("crf", "sgs")
               for k in _dist_kernels(family)}
    saved = {k: os.environ.pop(k, None)
             for k in ("MCMC_TPU_EXAMPLE_OUT", "MCMC_TPU_EXAMPLE_QUICK")}
    failed = []
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                         dir=ROOT) as tmp:
            os.environ["MCMC_TPU_EXAMPLE_OUT"] = tmp
            for name in EXAMPLE_RUNS:
                torch.cuda.empty_cache()
                for k in kernels.values():
                    k.launches = 0
                t0 = time.perf_counter()
                result = _example_module(name).main(device=DEVICE)
                seconds = time.perf_counter() - t0
                launches = {n: k.launches for n, k in kernels.items()
                            if k.launches}
                summary, bad = _example_gates(name, result, launches)
                print(f"[examples] {name}: {summary} | launches {launches}"
                      f" | {seconds:.1f} s ({card})", flush=True)
                failed += [f"{name[:2]}: {b}" for b in bad]
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    if failed:
        raise RuntimeError(f"[examples] failed gates: {failed}")


GRAPH_SEGMENTS = (58, 200)  # [graph]: warm-up, capture, replay and rest;
                             # then whole chunks (timed)
GRAPH_PROFILE_STEPS = 50     # [graph]: profiled steps each way
GRAPH_RUN_ITERS = 401        # [graph]: each single-chain run
GRAPH_SWEEP = (10, 25, 50, 100)  # [graph]: chunk lengths swept
# [graph]'s farms: (tag, chain maker, chains, seeding, the kernels a step)
GRAPH_FARMS = (
    ("crf-int", "crf", N_CHAINS, "int",
     ("fused_window_update", "batched_normal")),
    ("crf-list", "crf", N_CHAINS, "list",
     ("fused_window_update", "batched_normal_keyed", "chain_draws")),
    ("sgs-int", "sgs", SGS_CHAINS, "int",
     ("window_extract", "window_writeback", "mix_masked_cg", "lut_interp")),
    ("sgs-list", "sgs", SGS_CHAINS, "list",
     ("window_extract", "window_writeback", "mix_masked_cg", "lut_interp",
      "chain_draws")),
    ("sph-int", "sph", SGS_CHAINS, "int",
     ("window_extract", "window_writeback", "masked_cg", "lut_interp")),
    ("srf-int", "srf", N_CHAINS, "int",
     ("fused_window_update", "srf_harmonics")),
)
GRAPH_RUN_KERNELS = {
    "crf": ("fused_window_update", "batched_normal_keyed", "chain_draws"),
    "sgs": ("window_extract", "window_writeback", "mix_masked_cg",
            "lut_interp", "chain_draws")}


def _launch_counts():
    """{name: launches} of every dispatcher that counts kernel launches
    (``ops/launch_counts.COUNTED``)."""
    from mcmc_tpu_torch.ops.launch_counts import COUNTED

    return {k.__name__: k.launches for k in COUNTED}


def _zero_launches():
    from mcmc_tpu_torch.ops.launch_counts import COUNTED

    for k in COUNTED:
        k.launches = 0


def _clone_stream(rng):
    """A random source that draws what ``rng`` would, sharing nothing."""
    import torch

    from mcmc_tpu_torch.utils.rng import PerChainStreams

    if isinstance(rng, PerChainStreams):
        return PerChainStreams(keys=rng.keys.clone(), step=rng.step.clone())
    gen = torch.Generator(device=rng.device)
    gen.set_state(rng.get_state())
    return gen


def _same_bits(a, b):
    """Two tensors equal in shape, type and every byte."""
    import torch

    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def _same_stream(a, b):
    import torch

    if isinstance(a, torch.Generator):
        return torch.equal(a.get_state(), b.get_state())
    return torch.equal(a.step, b.step) and torch.equal(a.keys, b.keys)


@contextlib.contextmanager
def _eager_loop():
    """Inside, the one-chain runners step through ``run_chains_eager``
    (the plain loop) instead of the captured ``run_chains``."""
    from mcmc_tpu_torch.parallel import sampler as ps

    captured = ps.run_chains

    def eager(*args, graphs=None, **kw):  # the plain loop keeps no graph
        return ps.run_chains_eager(*args, **kw)

    ps.run_chains = eager
    try:
        yield
    finally:
        ps.run_chains = captured


def _dot_nodes(graph):
    """(nodes, {kind: nodes}, [(KIND, kernel symbol or "")]) of a CUDA
    graph captured with ``keep_graph=True``, from its DOT dump."""
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="chip_smoke_") as d:
        path = Path(d) / "graph.dot"
        graph.debug_dump(str(path))
        text = path.read_text()
    # a node's record label opens with its kind; a kernel's next field is
    # "ID | n (topoId: m) | <mangled symbol><<<grid, block, smem>>>"
    records = re.findall(r'"graph_\d+_node_\d+"\[[^\n]*label="\{\s*(\w+)'
                         r'(?:\s*\|\s*\{ID \| [^|]*\| ([^\s}]*))?', text)
    kinds = {}
    for kind, _ in records:
        kinds[kind.lower()] = kinds.get(kind.lower(), 0) + 1
    return len(set(re.findall(r"graph_\d+_node_\d+", text))), kinds, records


def _graph_nodes(static, consts, states, rng, tag):
    """Nodes a step of a chunk captured from ``states`` and ``rng`` (which
    it advances), all and by kind, from the CUDA graph's DOT dump (a
    ``run_chains_chunked`` call through ``capture_graph(keep_graph=
    True)``); and the capture's launch counts read back from the graph:
    each counted dispatcher's kernel nodes (its ``kernels``' mangled
    names) must number the launches the capture counted, which each
    replay adds to its count.  Raises where they differ, or where a
    kernel node names two dispatchers."""
    from mcmc_tpu_torch.ops.launch_counts import COUNTED
    from mcmc_tpu_torch.parallel import sampler as ps

    graphs = ps.GraphCache()
    ps.run_chains_chunked(static, consts, states,
                          ps.WARM_STEPS + ps.CHUNK_STEPS, rng=rng,
                          graphs=graphs,
                          capture=functools.partial(ps.capture_graph,
                                                    keep_graph=True))
    seg = graphs.graph
    total, kinds, records = _dot_nodes(seg.graph)
    graphs.drop()
    in_graph = {c.__name__: 0 for c in COUNTED}
    for kind, symbol in records:
        owners = [c.__name__ for c in COUNTED
                  if kind == "KERNEL" and any(k in symbol for k in c.kernels)]
        if len(owners) > 1:
            raise RuntimeError(f"[graph] {tag}: kernel node {symbol[:80]} "
                               f"names {owners}")
        for name in owners:
            in_graph[name] += 1
    counted = {c.__name__: 0 for c in COUNTED}
    counted.update({c.__name__: n for c, n in seg.launches})
    if in_graph != counted:
        raise RuntimeError(f"[graph] {tag}: the graph holds the kernel nodes "
                           f"{in_graph}, its capture counted {counted}")
    return (total / seg.steps if total else None,
            {k: v / seg.steps for k, v in sorted(kinds.items())},
            {k: v for k, v in in_graph.items() if v})


def _held_mib(release):
    """MiB of device memory allocated and reserved that ``release()``
    gives back (the allocator's idle cache emptied before and after)."""
    import gc

    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    release()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return ((a0 - torch.cuda.memory_allocated()) / 2**20,
            (r0 - torch.cuda.memory_reserved()) / 2**20)


def _capture_ms(fn):
    """``fn()``'s result and the milliseconds of the segment captures it
    made: its ``mcmc.run_chains.capture`` spans under a CPU profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sum(e.cpu_time_total for e in prof.events()
                    if e.name == "mcmc.run_chains.capture") / 1e3


def _idle(r):
    """1 - device busy / unprofiled wall, a step (None unmeasured)."""
    return None if r["busy"] is None else 1 - r["busy"] / r["us"]


def _graph_farm(sampler, tag, seeding, names, card):
    """[graph], one farm: eager and captured ``run_chains`` from cloned
    states and streams over GRAPH_SEGMENTS, bitwise; µs a step of the
    last segment, the idle share over GRAPH_PROFILE_STEPS profiled steps,
    capture ms, graph nodes a step (the counted kernels' nodes held to the
    capture's counts, ``_graph_nodes``), the added peak memory, what the
    farm's graph holds, and the launches, each kernel once a step both
    ways."""
    import torch

    from mcmc_tpu_torch.parallel import sampler as ps

    n = sampler.n_chains
    st0 = sampler.init(seeds=0 if seeding == "int" else _seed_list(n))
    rng0 = sampler.generator
    static, consts = sampler.static, sampler.consts
    out = {}
    graphs = ps.GraphCache()  # the captured way's, as a sampler keeps one
    for way, run in (("eager", ps.run_chains_eager),
                     ("graph", functools.partial(ps.run_chains,
                                                 graphs=graphs))):
        st, rng = _clone_state(st0), _clone_stream(rng0)
        _zero_launches()
        traces, us, peak = [], None, None
        for i, steps in enumerate(GRAPH_SEGMENTS):
            torch.cuda.synchronize()
            if i == 0:
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            if i == 0:  # the graph's capture
                (st, tr), capture_ms = _capture_ms(
                    lambda: run(static, consts, st, steps, rng=rng))
            else:
                st, tr = run(static, consts, st, steps, rng=rng)
            torch.cuda.synchronize()
            if i == 0:
                peak = torch.cuda.max_memory_allocated() - base
            else:
                us = (time.perf_counter() - t0) / steps * 1e6
            traces.append(tr)
        out[way] = dict(run=run, state=st, rng=rng, traces=traces, us=us,
                        peak=peak, launches=_launch_counts(),
                        capture_ms=capture_ms if way == "graph" else None)
    e, g = out["eager"], out["graph"]
    same = {
        "traces": all(set(a) == set(b) and all(_same_bits(a[k], b[k])
                                               for k in a)
                      for a, b in zip(e["traces"], g["traces"])),
        "state": all(_same_bits(getattr(e["state"], f.name),
                                getattr(g["state"], f.name))
                     for f in dataclasses.fields(e["state"])),
        "stream": _same_stream(e["rng"], g["rng"])}
    for r in (e, g):  # the captured way replays the graph its cache keeps
        busy, wall, ops = _device_busy(lambda: r["run"](
            static, consts, r["state"], GRAPH_PROFILE_STEPS, rng=r["rng"]))
        r.update(idle=None if busy is None else 1 - busy / wall,
                 busy=None if busy is None else busy / GRAPH_PROFILE_STEPS,
                 ops=ops / GRAPH_PROFILE_STEPS)
    held = _held_mib(graphs.drop)
    steps = sum(GRAPH_SEGMENTS)
    want = {k: steps if k in names else 0 for k in e["launches"]}
    nodes, kinds, in_graph = _graph_nodes(static, consts, g["state"],
                                          g["rng"], tag)
    print(f"[graph] {tag} ({n} chains x {GRID}^2): bitwise {same} | "
          f"us a step eager {e['us']:.1f}, graph {g['us']:.1f} | idle share "
          f"of the profiled wall eager {e['idle']}, graph {g['idle']}; of "
          f"the unprofiled wall eager {_idle(e)}, graph {_idle(g)} (device "
          f"busy {e['busy']} / {g['busy']} us a step; device ops a step "
          f"{e['ops']:.1f} / {g['ops']:.1f}) | capture {g['capture_ms']:.1f} ms for "
          f"{ps.CHUNK_STEPS} steps | graph nodes a step {nodes} {kinds}, "
          f"counted kernels' nodes a capture {in_graph} = its counts | "
          f"added peak memory {(g['peak'] - e['peak']) / 2**20:.1f} MiB "
          f"(eager {e['peak'] / 2**30:.2f} GiB) | the farm's graph held "
          f"{held[0]:.1f} MiB allocated, {held[1]:.1f} MiB reserved, given "
          f"back on drop | launches in {steps} steps "
          f"{ {k: v for k, v in g['launches'].items() if v} } ({card})",
          flush=True)
    if not all(same.values()):
        raise RuntimeError(f"[graph] {tag}: the captured loop is not the "
                           f"eager loop bit for bit: {same}")
    for way in ("eager", "graph"):
        if out[way]["launches"] != want:
            raise RuntimeError(f"[graph] {tag} {way} launches "
                               f"{out[way]['launches']}, want {want}")
    return {"us": (e["us"], g["us"]), "idle": (_idle(e), _idle(g)),
            "capture_ms": g["capture_ms"], "nodes": nodes}


def _graph_run(chain, family, card):
    """[graph], a single-chain run: ``Chain*.run(GRAPH_RUN_ITERS)`` on the
    eager loop and on the captured one, the same seed: the same dict bit
    for bit (final state included), the stream at the same step, each
    kernel once a step both ways; it/s of the whole call each way, the
    idle share of a whole profiled call of GRAPH_PROFILE_STEPS steps (a
    profile of the long call holds ~10^5 device events), and the device
    memory a finished call still holds beside its final state (its farm
    and graph go with the call)."""
    import gc

    import torch

    seed = _seed_list(1)[0]
    steps = GRAPH_RUN_ITERS - 1
    res = {}
    for way in ("eager", "graph"):
        ctx = _eager_loop() if way == "eager" else contextlib.nullcontext()
        with ctx:
            _zero_launches()
            gc.collect()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out = chain.run(GRAPH_RUN_ITERS, seed=seed, device=DEVICE)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            launches = _launch_counts()
            gc.collect()
            held = torch.cuda.memory_allocated() - before
            step = chain._streams.step.clone()
            busy, wall, _ = _device_busy(lambda: chain.run(
                GRAPH_PROFILE_STEPS + 1, seed=seed, device=DEVICE))
        res[way] = dict(out=out, its=steps / elapsed, launches=launches,
                        step=step, held=held,
                        idle=None if busy is None else 1 - busy / wall)
    e, g = res["eager"], res["graph"]
    fs_e, fs_g = e["out"]["final_state"], g["out"]["final_state"]
    state_bytes = sum(getattr(fs_g, f.name).nbytes
                      for f in dataclasses.fields(fs_g)
                      if getattr(fs_g, f.name).is_cuda)
    same = {"run": _runs_equal(e["out"], g["out"]),
            "state": all(_same_bits(getattr(fs_e, f.name),
                                    getattr(fs_g, f.name))
                         for f in dataclasses.fields(fs_e)),
            "stream": torch.equal(e["step"], g["step"])}
    want = {k: steps if k in GRAPH_RUN_KERNELS[family] else 0
            for k in e["launches"]}
    print(f"[graph] {type(chain).__name__}.run({GRAPH_RUN_ITERS}) at "
          f"{GRID}^2: bitwise {same} | it/s eager {e['its']:,.0f}, graph "
          f"{g['its']:,.0f} (whole calls, build and capture included) | "
          f"idle share of a whole {GRAPH_PROFILE_STEPS}-step call eager "
          f"{e['idle']}, graph {g['idle']} | a finished call holds "
          f"{e['held'] / 2**20:.2f} / {g['held'] / 2**20:.2f} MiB eager / "
          f"graph (its final state {state_bytes / 2**20:.2f} MiB) | "
          f"launches { {k: v for k, v in g['launches'].items() if v} } "
          f"({card})", flush=True)
    if not all(same.values()):
        raise RuntimeError(f"[graph] {family} run: the captured loop is not "
                           f"the eager loop bit for bit: {same}")
    for way in ("eager", "graph"):
        if res[way]["launches"] != want:
            raise RuntimeError(f"[graph] {family} run {way} launches "
                               f"{res[way]['launches']}, want {want}")
    return {"its": (e["its"], g["its"]), "idle": (e["idle"], g["idle"])}


def _chunk_sweep(samplers, card):
    """[graph]'s sweep of the chunk length (``CHUNK_STEPS`` is set from
    it): for each of GRAPH_SWEEP's lengths, set as ``CHUNK_STEPS`` for the
    while, a fresh int-seeded farm of each family captures one chunk, then
    replays GRAPH_SEGMENTS[-1] steps: capture ms and µs a replayed step."""
    import torch

    from mcmc_tpu_torch.parallel import sampler as ps

    chunk_steps = ps.CHUNK_STEPS
    try:
        for family, sampler in samplers.items():
            line = []
            for chunk in GRAPH_SWEEP:
                ps.CHUNK_STEPS = chunk
                states = sampler.init(seeds=0)
                steps = -(-GRAPH_SEGMENTS[-1] // chunk) * chunk
                _, capture_ms = _capture_ms(lambda: sampler.run_segment(
                    states, ps.WARM_STEPS + chunk))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sampler.run_segment(states, steps)
                torch.cuda.synchronize()
                us = (time.perf_counter() - t0) / steps * 1e6
                line.append(f"{chunk}: capture {capture_ms:.1f} ms, "
                            f"replayed {us:.1f} us a step")
                sampler.graphs.drop()
            print(f"[graph] chunk sweep, {family} {sampler.n_chains} chains "
                  f"x {GRID}^2: {' | '.join(line)} ({card})", flush=True)
    finally:
        ps.CHUNK_STEPS = chunk_steps


def phase_graph(p, chain, sgs_chain, card):
    """[graph]: each farm and single-chain run eager and captured in this
    process (``_graph_farm``, ``_graph_run``), bitwise, then the sweep of
    the chunk length; no gain claimed.  Returns {tag: numbers}."""
    import torch

    from mcmc_tpu_torch import MultiChainSampler

    chains = {"crf": chain, "sgs": sgs_chain,
              "sph": make_spherical_chain(p), "srf": make_srf_chain(p)}
    samplers = {}
    rows = {}
    for tag, family, n, seeding, names in GRAPH_FARMS:
        t0 = time.perf_counter()
        if family not in samplers:
            samplers[family] = MultiChainSampler(chains[family], n,
                                                 device=DEVICE)
        rows[tag] = _graph_farm(samplers[family], tag, seeding, names, card)
        torch.cuda.empty_cache()
        print(f"[graph] {tag} {time.perf_counter() - t0:.1f} s", flush=True)
    for family in ("crf", "sgs"):
        t0 = time.perf_counter()
        rows[f"run-{family}"] = _graph_run(chains[family], family, card)
        print(f"[graph] run-{family} {time.perf_counter() - t0:.1f} s",
              flush=True)
    t0 = time.perf_counter()
    _chunk_sweep({k: samplers[k] for k in ("crf", "sgs")}, card)
    print(f"[graph] chunk sweep {time.perf_counter() - t0:.1f} s",
          flush=True)
    return rows


def busy_share(sampler, states, card, step_us, n_steps=50, top=6,
               watch=(), tag="profile"):
    """Device-busy share of a short steady window from torch.profiler,
    against the profiled wall time and against ``step_us``, the main
    path's wall time per step without the profiler; the ``top`` kernels
    by device time, and each kernel whose name holds a ``watch`` string.
    Returns {"ops_per_step", "busy_us"} (None where the profiler recorded
    no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mcmc_tpu_torch.parallel.sampler import CHUNK_STEPS, WARM_STEPS

    n_steps = -(-n_steps // CHUNK_STEPS) * CHUNK_STEPS  # whole replays
    states, _ = sampler.run_segment(states, WARM_STEPS + CHUNK_STEPS)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sampler.run_segment(states, n_steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): a CPU op's device time
    # repeats its kernels' time
    events = _device_events(prof.key_averages())

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy_us = sum(dev_us(e) for e in events)
    per_step = sum(e.count for e in events) / n_steps
    if busy_us <= 0:
        print(f"[{tag}] device busy share: not measured (the profiler "
              "recorded no device time)", flush=True)
        return None
    ranked = sorted(events, key=dev_us, reverse=True)
    shown = ranked[:top] + [e for e in ranked[top:]
                            if any(w in e.key for w in watch)]
    busy = busy_us / n_steps
    print(f"[{tag}] {n_steps} steps: {per_step:.0f} device ops/step, "
          f"device busy {busy:.1f} us/step | "
          f"profiled wall {wall_us / n_steps:.1f} us/step -> idle share "
          f"{1 - busy_us / wall_us:.3f} | unprofiled wall {step_us:.1f} "
          f"us/step -> idle share {1 - busy / step_us:.3f} ({card})",
          flush=True)
    for e in shown:
        print(f"[{tag}]   {dev_us(e) / n_steps:9.1f} us/step  "
              f"{e.count // n_steps:3d}/step  {e.key[:70]}", flush=True)
    return {"ops_per_step": per_step, "busy_us": busy}


def main():
    if sys.argv[1:2] == ["--dist-worker"]:  # one rank of a [dist] launch
        return _dist_worker(*sys.argv[2:4])
    card, _ = phase_device()
    import torch

    phase_build()
    p = build_problem()
    chain = make_chain(p)
    rows = {"fused_window_update": phase_kernel_vs_plain(chain, card)}
    phase_irfft2(chain)
    launches = phase_main_path(chain, card)
    sgs_chain = make_sgs_chain(p)
    sgs_parity = phase_sgs_kernels_vs_plain(sgs_chain, card)
    phase_sgs_window_edges(card)
    phase_cg_k96(p, card)
    sgs_launches = phase_sgs_main_path(sgs_chain, p, card)
    t0 = time.perf_counter()
    phase_diag(chain, card)
    print(f"[diag] phase {time.perf_counter() - t0:.1f} s", flush=True)
    for kernel, key in (("window_extract", "extract"),
                        ("window_writeback", "writeback"),
                        ("mix_masked_cg", "cg"), ("lut_interp", "lut")):
        rows[kernel] = sgs_parity[key]
        launches[kernel] = sgs_launches[kernel]
    rows["batched_normal"] = phase_noise_vs_plain(chain, card)
    phase_crf_step_vs_plain(chain, card)
    t0 = time.perf_counter()
    phase_graph(p, chain, sgs_chain, card)
    print(f"[graph] phase {time.perf_counter() - t0:.1f} s", flush=True)
    rows["chain_draws"] = phase_draws_vs_plain(chain, sgs_chain, card)["sgs"]
    phase_independence(chain, sgs_chain, card)
    del chain, sgs_chain
    launches["chain_draws"] = phase_seed_rates(p, card)
    rows["masked_cg"] = phase_masked_cg_vs_plain(make_spherical_chain(p),
                                                 card)
    launches["masked_cg"] = phase_entry_point(p, card)
    phase_entry_seed_list(p, card)
    for tag, phase in (("run", phase_run), ("collect", phase_collect),
                       ("geostats", phase_geostats)):
        t0 = time.perf_counter()
        phase(p, card)
        print(f"[{tag}] phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    rows["srf_harmonics"], launches["srf_harmonics"] = phase_srf(p, card)
    print(f"[srf] phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_dist(p, card)
    print(f"[dist] phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_examples(card)
    print(f"[examples] phase {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": [{
        "name": kernel, "route": "cuda",
        "source": "mcmc_tpu_torch/ops/csrc/" + source,
        "replaces": replaces, "launches": launches[kernel],
        **{k: rows[kernel][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}} for kernel, source, replaces in KERNELS]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
