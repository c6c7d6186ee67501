#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

The quickest proof that the port (``mcmc_tpu_torch``) still starts and is
right on the card.  It needs one CUDA device and nvcc, imports nothing of
JAX or of the JAX package, and exits non-zero on any failure.  Phases, one
line or more each:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds ``ops/csrc/window_kernel.cu`` for sm_90a, with the
   ptxas register and shared-memory lines;
3. kernel vs plain version: the CUDA window kernel against its plain
   PyTorch version on the same state and draws, at the headline geometry
   (768 chains on a 512 x 512 grid, blocks up to 80), with both times per
   launch from CUDA events;
4. irfft2 on the card against the CPU on the same half-spectrum noise;
5. main path: ChainCRF -> MultiChainSampler(chain, 768) -> init(seeds=0)
   -> run(3 segments x 500 iterations) -> diagnostics, checking that every
   step launched the kernel, the loss is finite and falls, acceptance is
   in (0.02, 0.98) and the bed outside the update region is untouched;
   then a short profiled window for the device's busy share.

The problem is the headline of ``bench.py`` (its ``build_problem`` and
``make_chain``): Matérn nu=1.3 CRF_weight proposals, block menu 50-80 in 5
steps.  The second-to-last line is a JSON object describing the kernel;
the last line is the JSON contract ``{"ok": true, "device": ...}``.
"""

import json
import subprocess
import sys
import time

import numpy as np

GRID = 512
N_CHAINS = 768
SIGMA_MC = 5.0
RES = 500.0
PARITY_STEPS = 20
SEGMENTS = 3
SEGMENT = 500

# kernel vs plain version bounds
FLIP_RATE_MAX = 1e-3     # MH decisions that differ (f32 sums in another order)
DELTA_REL_MAX = 1e-4     # delta error relative to the block loss it sums
FIELD_RTOL, FIELD_ATOL = 5e-5, 1e-3
HBM_GBS = 3350           # H100 SXM device-memory bandwidth (data sheet)
IRFFT_REL_MAX = 1e-5     # card vs a float64 transform, relative to field rms


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
    from mcmc_tpu_torch.ops.cuda_build import load_library

    kl = load_library("window_kernel")
    print(f"[build] {kl.path.name}: nvcc {kl.build_seconds:.2f} s",
          flush=True)
    for line in kl.ptxas:
        print(f"[build] {line}", flush=True)
    if not any("Used" in line for line in kl.ptxas):
        raise RuntimeError("nvcc printed no ptxas resource line")


def _block_losses(fields_old, geom, consts):
    """Per chain, the block's old mc loss (the size of the sums a delta is
    the difference of), in nats."""
    import torch

    H, W = fields_old.shape[-2:]
    dev = fields_old.device
    g = geom.long()
    r = torch.arange(H, device=dev)
    c = torch.arange(W, device=dev)
    rows = (r[None] >= g[:, 0:1]) & (r[None] < g[:, 1:2])
    cols = (c[None] >= g[:, 2:3]) & (c[None] < g[:, 3:4])
    res = fields_old[:, 1].double()
    out = torch.zeros(fields_old.shape[0], dtype=torch.float64, device=dev)
    for i in range(0, fields_old.shape[0], 128):  # bound the temporaries
        m = (rows[i:i + 128, :, None] & cols[i:i + 128, None, :]
             & consts.mc_mask[None])
        sq = torch.nan_to_num(res[i:i + 128] ** 2, nan=0.0)
        out[i:i + 128] = torch.where(m, sq, 0.0).sum(dim=(1, 2))
    return out / (2.0 * consts.sigma_mc ** 2)


def _window_bytes(geom, acc, B, n_const=6):
    """Bytes one launch of the window op moves: per chain, its window of
    the const planes and of bed and residual over the block plus its
    one-cell ring, the raw (B, B) field and the (h, w) edge mask, and on
    accept the three state planes rewritten over the block."""
    g = geom.double()
    h, w = g[:, 1] - g[:, 0], g[:, 3] - g[:, 2]
    reads = (n_const + 2) * (h + 2) * (w + 2) + B * B + h * w
    writes = 3 * h * w * (acc > 0).double()
    return 4.0 * float((reads + writes).sum())


def _time_per_launch(fn, n=20):
    import torch

    fn()  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_kernel_vs_plain(chain, card):
    import torch

    from mcmc_tpu_torch.models.chain_crf import (draw, init_state, propose,
                                                 window_operands)
    from mcmc_tpu_torch.ops.window_kernel import (
        fused_window_update, fused_window_update_reference)
    from mcmc_tpu_torch.utils.rng import make_generator

    dev = torch.device("cuda")
    static, consts = chain.build(dev)
    state = init_state(chain.initial_bed, consts, N_CHAINS)
    gen = make_generator(1, dev)
    n_dec = n_flip = 0
    delta_rel = field_err = 0.0
    field_viol = 0
    ops = []  # each step's operands, replayed below for the timing
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
        acc_k, dk, ddk = fused_window_update(consts.stacked, state.fields, f,
                                             *args)
        acc_p, dp, ddp = fused_window_update_reference(consts.stacked, plain,
                                                       f, *args)
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
        ops.append((f, geom, fvals, _window_bytes(geom, acc_k, f.shape[-1])))
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

    # time both over the recorded steps' operands in turn (fresh windows
    # each launch, as on the main path), plain / kernel / kernel / plain
    scratch = state.fields.clone()
    turn = iter(range(1 << 62))

    def launcher(fn):
        def run():
            f, geom, fvals, _ = ops[next(turn) % len(ops)]
            fn(consts.stacked, scratch, f, consts.rf.edge_masks, geom, fvals)
        return run

    t = {"plain": [], "kernel": []}
    for name, fn in (("plain", fused_window_update_reference),
                     ("kernel", fused_window_update),
                     ("kernel", fused_window_update),
                     ("plain", fused_window_update_reference)):
        t[name].append(_time_per_launch(launcher(fn), n=len(ops)))
    ms = float(np.mean(t["kernel"]))
    plain_ms = float(np.mean(t["plain"]))
    gbs = float(np.mean([op[3] for op in ops])) / (ms * 1e-3) / 1e9
    print(f"[parity] time per launch at {N_CHAINS} chains x {GRID}^2, "
          f"B={static.rf.B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"({card}; CUDA events, {len(ops)} launches x 2 each) | kernel "
          f"{gbs:.0f} GB/s = {gbs / HBM_GBS:.3f} of {HBM_GBS} GB/s",
          flush=True)
    return dict(max_abs_err=field_err, ms=ms, plain_ms=plain_ms,
                flip_rate=flip_rate)


def phase_irfft2(chain):
    import torch

    from mcmc_tpu_torch.ops.spectral import (_rfreq_grid_np,
                                             half_spectrum_noise,
                                             spectral_density,
                                             spectral_field_from_noise)
    from mcmc_tpu_torch.utils.rng import make_generator

    dev = torch.device("cuda")
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
    from mcmc_tpu_torch.ops.window_kernel import fused_window_update

    torch.cuda.reset_peak_memory_stats()
    sampler = MultiChainSampler(chain, N_CHAINS, device="cuda")
    states = sampler.init(seeds=0)
    bed0 = states.bed[0].clone()
    n_iter = SEGMENTS * SEGMENT + 1
    fused_window_update.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, traces = sampler.run(states, n_iter, segment_size=SEGMENT,
                                 progress=True)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = fused_window_update.launches
    steps = n_iter - 1
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    loss = traces["loss"]
    acc = float(np.mean(traces["step"][:, 1:]))
    outside = ~(sampler.consts.update_mask > 0)
    moved = int((states.bed[:, outside] != bed0[outside]).sum())
    diag = sampler.diagnostics(traces, elapsed)
    print(f"[main] {steps} steps x {N_CHAINS} chains in {elapsed:.3f} s: "
          f"{diag['chain_iters_per_sec']:,.0f} chain-it/s | ESS(loss) "
          f"{diag['ess_loss']:.1f} -> {diag['ess_per_sec']:.2f} ESS/s | "
          f"acc {acc:.3f} | loss mean {loss[:, 0].mean():.6e} -> "
          f"{loss[:, -1].mean():.6e} | peak memory {peak_gb:.2f} GB | "
          f"kernel launches {launches} ({card})", flush=True)
    if launches != steps:
        raise RuntimeError(f"the window kernel ran {launches} times in "
                           f"{steps} steps")
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


def busy_share(sampler, states, card, step_us, n_steps=50):
    """Device-busy share of a short steady window from torch.profiler,
    against the profiled wall time and against ``step_us``, the main
    path's wall time per step without the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    states, _ = sampler.run_segment(states, n_steps)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sampler.run_segment(states, n_steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): a CPU op's device time
    # repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy_us = sum(dev_us(e) for e in events)
    if busy_us <= 0:
        print("[profile] device busy share: not measured (the profiler "
              "recorded no device time)", flush=True)
        return
    top = sorted(events, key=dev_us, reverse=True)[:6]
    busy = busy_us / n_steps
    print(f"[profile] {n_steps} steps: device busy {busy:.1f} us/step | "
          f"profiled wall {wall_us / n_steps:.1f} us/step -> idle share "
          f"{1 - busy_us / wall_us:.3f} | unprofiled wall {step_us:.1f} "
          f"us/step -> idle share {1 - busy / step_us:.3f} ({card})",
          flush=True)
    for e in top:
        print(f"[profile]   {dev_us(e) / n_steps:9.1f} us/step  "
              f"{e.count // n_steps:3d}/step  {e.key[:70]}", flush=True)


def main():
    card, name = phase_device()
    import torch

    phase_build()
    p = build_problem()
    chain = make_chain(p)
    parity = phase_kernel_vs_plain(chain, card)
    phase_irfft2(chain)
    launches = phase_main_path(chain, card)
    print(json.dumps({"kernels": [{
        "name": "fused_window_update", "route": "cuda",
        "source": "mcmc_tpu_torch/ops/csrc/window_kernel.cu",
        "replaces": "mcmc_tpu/ops/window_kernel.py:60",
        "launches": launches, "max_abs_err": parity["max_abs_err"],
        "ms": parity["ms"], "plain_ms": parity["plain_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
