#!/usr/bin/env python3
"""GPU smoke run of nerfpp_tpu_torch, the PyTorch/CUDA port (one H100).

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; TF32 off for matrix products and convolutions.
  2. build: every CUDA kernel from nerfpp_tpu_torch/csrc, in parallel.
  3. kernels: K1 and K2 against their plain PyTorch versions at flagship
     shapes (16 levels, T = 2^19; one 65,536-ray chunk of the 800x800 view at
     64 samples, 2^20 uniformly random points, and the training chunk of
     phase 6), with their median times over CUDA-event-timed launches, the
     plain versions' times and bounds, and K2's library yardstick: one
     embedding_bag over the precomputed corner indices and weights.
  4. parity: a 64x64 full-width render on the GPU (kernels) against the same
     state on the CPU (plain versions).
  5. serving: render_view of hashnerf_blocked_preset(n_importance=0,
     use_occupancy_grid=True) at full width, 800x800, 64 samples, auto
     two-class budget, 1 + 5 frames; the kernels' launch counts are reset
     just before and read just after.
  6. gradient: K3 against its plain version at the training chunk (4,096
     tile-ordered rays x 64 samples, sample-major) and on the 2^20 random
     points, beside one index_add_ of the precomputed corner products.
  7. train parity: one step of a tiny configuration on the GPU and on the
     CPU from the same seeded state with the same draws.
  8. training: the flagship configuration of bench.py (the 800x800
     synthetic bench scene built on the card, NRand 4096 in 8x16 tiles, 64
     occupancy-guided samples) from step 0 to step 2,099 through
     NeRFExecutor.train: full refresh and full render before step 1,024,
     phased refresh and the two-class budget after. Steps 33-64 (as
     bench.py times them) and 1,056-1,087 are timed windows; launch counts are reset before step 0
     and read after the last step; the loss curve must fall; the held-out
     PSNR of the unbudgeted test view after 1,088 and 2,100 steps (the JAX
     reference's 2,100-step quality point).
  9. small-table kernels: encode_small (K4 and K5) against its plain version
     in every mode (packed and f32 table, fixed and random scheme, the v1
     route) at 16 levels, T = 2^13, on one serving chunk's fine-pass points
     (32,768 rays x 256 depths), on 2^20 random points and on the dense fine
     class of a train step (1,024 rays x 256 depths), and at T = 2^15, beside
     one embedding_bag over the precomputed corner indices and weights;
     grad_small against its plain version on the dense fine class of a
     train step (1,024 rays x 256 depths) and on the 2^20 random points,
     beside one index_add_ of the precomputed corner products.
 10. hierarchical train parity: one tiny hier-budget train step, GPU
     against CPU from the same seeded state with the same draws.
 11. hierarchical training: NeRFExecutor.train of hashnerf_tpu_preset() on
     the same bench scene with the README's TrainParams(n_iters=2000,
     n_rand=4096, n_samples=64, chunk=4096), steps 0-1,998 unless the
     script's time budget cuts them (the cut is printed); steps 1,024-1,055
     are timed; launch counts are reset before step 0 and read after the
     last step; the loss curve must fall. Then a 64x64 render of the
     trained state with the f32 MLP, GPU against CPU.
 12. hierarchical serving: render_view of the trained state at full width,
     800x800, TrainParams() (64 + 192 samples, chunk 32,768), 1 + 3 frames
     of the test view, launch counts reset just before and read just after;
     its held-out PSNR.
The line before the last is the kernel summary JSON; the last line is
{"ok": true, "device": {...}}. Any failed check raises, and the script exits
non-zero; without CUDA, or without the nerfpp_tpu_torch package beside it, it
fails before printing a result.
"""
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
NONTENSOR_OPS_PER_S = 67e12    # H100 SXM f32 outside the tensor cores
BBOX = [-1.2, -1.2, -1.2, 1.2, 1.2, 1.2]
SEED = 0
SPIN_CYCLES = 1 << 22          # ~2 ms of card time ahead of each timing
SERVE_KERNELS = ("window_lists", "encode_blocked")
TRAIN_KERNELS = ("window_lists", "encode_blocked", "grad_blocked")
HIER_KERNELS = ("encode_small", "grad_small")
TIME_BUDGET_S = 960            # the hierarchical run is cut to stay inside


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps=10, inner=10, warmup=3):
    """Median over ``reps`` of the CUDA-event time of ``inner`` back-to-back
    launches, divided by ``inner`` (ms). A spin kernel queued before the
    first event keeps the card busy while the host enqueues the launches, so
    that a short kernel is timed on the card and not by its wrapper's host
    cost."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def sphere_grid(res, radius_frac, density, device):
    """Occupancy density: ``density`` inside a centred sphere, 0 outside."""
    import torch
    ii = torch.arange(res, dtype=torch.float32) + 0.5 - res / 2
    r2 = ii[:, None, None] ** 2 + ii[None, :, None] ** 2 + ii[None, None, :] ** 2
    d = torch.where(r2 < (radius_frac * res / 2) ** 2, density, 0.0)
    return d.to(device)


def camera(res):
    import numpy as np
    from nerfpp_tpu_torch.core.rays import calibration_matrix, pose_spherical
    k = calibration_matrix(1.1 * res, res, res)
    return k, pose_spherical(30.0, -30.0, 3.0).astype(np.float32)


def chunk_points(enc, occupancy, n_rays, n_samples, device):
    """One chunk of the 800x800 view: tile-ordered rays around the image
    centre (where the object is), occupancy-guided tile-shared depths,
    sample-major flattening, clamped to the bbox."""
    import torch
    from nerfpp_tpu_torch.core import rays as R
    from nerfpp_tpu_torch.core.occupancy import tiled_ray_z
    from nerfpp_tpu_torch.render.renderer import _tile_flatten
    k, pose = camera(800)
    kt = torch.tensor(k, device=device)
    pt = torch.tensor(pose, device=device)
    bb = torch.tensor(BBOX, device=device)
    ro, rd, _ = R.get_rays(800, 800, kt, pt)
    start = (800 * 800 // 2 - n_rays // 2) // 128 * 128
    ro = _tile_flatten(ro, 800, 800)[start:start + n_rays]
    rd = _tile_flatten(rd, 800, 800)[start:start + n_rays]
    near, far = R.intersect_aabb(ro, rd, bb)
    z = tiled_ray_z(occupancy, ro, rd, near, far, bb, 64, n_samples)
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    pts = pts.transpose(0, 1).reshape(-1, 3)
    return torch.minimum(torch.maximum(pts, enc.box_min), enc.box_max)


def embedding_bag_ms(enc, table_f32, pts, ref):
    """The library yardstick of K2 and encode_small: one
    F.embedding_bag(idx, table, per_sample_weights=w, mode="sum") over the
    precomputed corner indices and weights ([N * L, 8] each; their
    computation is excluded, as index_add_'s is for the gradients) and the
    f32 table (the bf16-rounded one for a packed kernel). Checked against
    the plain version ``ref`` within 1e-6; returns (ms, max |err|)."""
    import torch
    import torch.nn.functional as F
    from nerfpp_tpu_torch.encoders.hashgrid import trilerp_weights
    n, nl = pts.shape[0], enc.n_levels
    idx = torch.empty((n * nl, 8), dtype=torch.int32, device=pts.device)
    w = torch.empty((n * nl, 8), dtype=torch.float32, device=pts.device)
    step = 1 << 20
    for i in range(0, n, step):
        ci, frac = enc.corner_indices(pts[i:i + step])
        rows = slice(i * nl, (i + ci.shape[0]) * nl)
        idx[rows] = ci.reshape(-1, 8).to(torch.int32)
        w[rows] = trilerp_weights(frac).reshape(-1, 8)
        del ci, frac

    def call():
        return F.embedding_bag(idx, table_f32, per_sample_weights=w,
                               mode="sum")
    out = call().reshape(n, 2 * nl)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if not err <= 1e-6:
        raise AssertionError(f"embedding_bag differs from the plain version "
                             f"by {err} > 1e-6")
    del out
    ms = cuda_ms(call, reps=5, inner=2, warmup=1)
    del idx, w
    return ms, err


def kernel_phase(enc, table, pts, label):
    """K1 and K2 against their plain versions on one point set."""
    import torch
    from nerfpp_tpu_torch.kernels import hash_encode_blocked as K
    n, nl = pts.shape[0], enc.n_levels
    ng = n // 128
    packed = K.pack_table_bf16(table)
    wids, counts = K.window_lists(pts, enc)
    torch.cuda.synchronize()
    wids_p, counts_p = K.window_lists_plain(pts, enc)
    if not (torch.equal(wids, wids_p) and torch.equal(counts, counts_p)):
        raise AssertionError(f"{label}: window_lists differs from its plain "
                             "version")
    out = K.encode_blocked(packed, pts, wids, counts, enc)
    torch.cuda.synchronize()
    out_p = K.encode_blocked_plain(packed, pts, wids, counts, enc)
    err = float((out - out_p).abs().max())
    # f32 weights on both sides, |table| <= 1: only the order of the eight
    # corner products (and fused multiply-adds) differs
    if not err <= 1e-6:
        raise AssertionError(f"{label}: encode_blocked max |err| {err} "
                             "> 1e-6")
    del out
    lib_ms, lib_err = embedding_bag_ms(enc, K.unpack_table_bf16(packed), pts,
                                       out_p)
    del out_p
    k1_ms = cuda_ms(lambda: K.window_lists(pts, enc))
    k2_ms = cuda_ms(lambda: K.encode_blocked(packed, pts, wids, counts, enc))
    k1_plain = cuda_ms(lambda: K.window_lists_plain(pts, enc), reps=5,
                       inner=1, warmup=1)
    k2_plain = cuda_ms(lambda: K.encode_blocked_plain(packed, pts, wids,
                                                      counts, enc),
                       reps=5, inner=1, warmup=1)
    # bytes each must move: every input read once, every output written once.
    # K1 writes every sentinel-padded id list; K2 needs only the counts and
    # the unique ids of each (group, level)
    small = nl * 4 + 3 * nl * 4
    k1_bytes = n * 12 + nl * ng * 128 * 4 + nl * ng * 4 + small
    cell, _ = enc.blocked_cell_frac(pts)
    rows = (enc.blocked_slot(cell).to(torch.int64)
            + torch.arange(nl, device=pts.device) * enc.block_slots)
    touched = int(torch.unique(rows).numel())
    k2_ids = nl * ng * 4 + 4 * int(counts.sum())
    k2_bytes = n * 12 + k2_ids + n * 2 * nl * 4 + touched * 512 + small
    # operations per (point, level), counted from the arithmetic itself:
    # K1 ~50 (cell, Morton code, its share of a 128-element sort and dedup),
    # K2 ~100 (cell, fractions, row and lane, 8 weights, 8 unpacks, 16 FMAs)
    k1_ops, k2_ops = 50.0 * n * nl, 100.0 * n * nl
    mean_count = float(counts.float().mean())
    stats = {}
    for name, ms, plain, nbytes, ops, e in (
            ("window_lists", k1_ms, k1_plain, k1_bytes, k1_ops, 0.0),
            ("encode_blocked", k2_ms, k2_plain, k2_bytes, k2_ops, err)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / NONTENSOR_OPS_PER_S * 1e3
        # no single PyTorch call lists the unique ids per row (K1)
        lib = lib_ms if name == "encode_blocked" else None
        stats[name] = dict(ms=ms, plain_ms=plain, max_abs_err=e,
                           bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops
                           else "operations", library_ms=lib)
        log("kernels", f"{label} {name}: N={n} ms={ms:.4f} "
            f"plain_ms={plain:.4f} bound_ms={max(t_bytes, t_ops):.4f} "
            f"(bytes {nbytes} -> {t_bytes:.4f} ms, ops {ops:.3g} -> "
            f"{t_ops:.4f} ms) max_abs_err={e:.3g}"
            + ("" if lib is None else f" embedding_bag_ms={lib:.4f} "
               f"(excluding the index computation; max |err| "
               f"{lib_err:.3g})"))
    log("kernels", f"{label}: mean windows per (group, level) "
        f"{mean_count:.2f}, touched table rows {touched} of "
        f"{nl * enc.block_slots}")
    return stats


def grad_phase(enc, pts, label):
    """K3 against its plain version on one point set, beside one PyTorch
    call (index_add_ of the precomputed corner products)."""
    import torch
    from nerfpp_tpu_torch.encoders.hashgrid import trilerp_weights
    from nerfpp_tpu_torch.kernels import hash_encode_blocked as K
    n, nl = pts.shape[0], enc.n_levels
    gen = torch.Generator().manual_seed(SEED + 3)
    g = torch.randn(n, 2 * nl, generator=gen).to(pts.device)
    out = K.grad_blocked(g, pts, enc)
    torch.cuda.synchronize()
    out_p = K.grad_blocked_plain(g, pts, enc)
    # atomics sum in a different order each run: hold each entry against
    # the sum of its terms' magnitudes, sum |w * g| (w >= 0)
    mag = K.grad_blocked_plain(g.abs(), pts, enc)
    diff = (out - out_p).abs()
    err = float(diff.max())
    rel = float((diff / mag.clamp(min=1e-30)).max())
    lanes_zero = bool((out.reshape(-1, 128, 2)[:, 125:] == 0).all())
    if not (rel <= 1e-5 and lanes_zero and bool(torch.isfinite(out).all())):
        raise AssertionError(f"{label}: grad_blocked max |err| {err}, "
                             f"max |err| / sum|w*g| {rel} > 1e-5, or "
                             f"lanes 125-127 not zero ({lanes_zero})")
    k3_ms = cuda_ms(lambda: K.grad_blocked(g, pts, enc))
    k3_plain = cuda_ms(lambda: K.grad_blocked_plain(g, pts, enc), reps=5,
                       inner=1, warmup=1)
    idx, frac = enc.corner_indices(pts)
    vals = (trilerp_weights(frac)[..., None]
            * g.reshape(n, nl, 1, 2)).reshape(-1, 2)
    idx = idx.reshape(-1)
    del frac
    lib_ms = cuda_ms(lambda: torch.zeros(
        (enc.table_rows, 2), device=pts.device).index_add_(0, idx, vals),
        reps=5, inner=2, warmup=1)
    del idx, vals
    # bytes: coordinates and cotangent read once, the gradient written once
    nbytes = n * 12 + n * 8 * nl + enc.table_rows * 8 + nl * 16
    # ~60 operations per (point, level): cell, slot, 8 weights, 16 products
    ops = 60.0 * n * nl
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / NONTENSOR_OPS_PER_S * 1e3
    log("grad", f"{label} grad_blocked: N={n} ms={k3_ms:.4f} "
        f"plain_ms={k3_plain:.4f} index_add_ms={lib_ms:.4f} (excluding "
        f"the index computation) bound_ms={max(t_bytes, t_ops):.4f} (bytes "
        f"{nbytes} -> {t_bytes:.4f} ms, ops {ops:.3g} -> {t_ops:.4f} ms) "
        f"max_abs_err={err:.3g} max_err/sum|w*g|={rel:.3g}")
    return dict(ms=k3_ms, plain_ms=k3_plain, library_ms=lib_ms,
                max_abs_err=err, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def compare(label, a, b, tol):
    """Worst |a - b| / max|b| of two tensors, against ``tol``."""
    import torch
    ratio = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    if not (bool(torch.isfinite(a).all()) and ratio <= tol):
        raise AssertionError(f"{label} differs by {ratio:.3g} of its largest "
                             f"value (limit {tol})")
    return ratio


def train_parity():
    """One train step of a tiny configuration (L = 4, T = 2^12, NRand 256,
    8 samples, the two-class budget, the full refresh of step 0, density
    noise and cone scatter on) on the card and on the CPU, from the same
    seeded state; one CPU generator gives both runs the same draws. The MLP
    runs in f32 so that the comparison sees the kernels and the step, not
    bf16 rounding. Tolerances: the loss to 1e-4 of itself; gradients and
    first moments to 1e-3 of each tensor's largest (K3's atomics and the
    card's matrix products sum in other orders); second moments to 2e-3;
    the refreshed grid to 1e-4."""
    import torch
    from nerfpp_tpu_torch.config import TrainParams, hashnerf_blocked_preset
    from nerfpp_tpu_torch.data.dataset import RayBatchSampler
    from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
    from nerfpp_tpu_torch.executor import NeRFExecutor
    from nerfpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    scene = make_synthetic_scene(n_train=2, n_val=1, n_test=1, image_hw=32,
                                 n_samples=32, white_bkgr=False, device="cpu")
    p = hashnerf_blocked_preset(
        n_importance=0, use_occupancy_grid=True, n_levels=4,
        log2_hashmap_size=12, finest_resolution=128, occ_grid_resolution=16,
        occ_n_bins=8, occ_sparse_samples=4, occ_tile_budget_warmup=0,
        compute_dtype="float32")
    tp = TrainParams(n_samples=8, n_rand=256, chunk=256, n_iters=100)
    runs = {}
    for name in ("cuda", "cpu"):
        ex = NeRFExecutor(p, device=name)
        ex.white_bkgr = scene.white_bkgr
        ex.initialize(scene.bounding_box, tp.lrate_decay, seed=SEED)
        sampler = RayBatchSampler.from_scene(scene, tp.n_rand, tile_h=8,
                                             tile_w=16, device=name)
        reset_launch_counts()
        m = ex._build_train_step(tp)(
            0, sampler, torch.Generator().manual_seed(SEED + 7))
        if name == "cuda" and 0 in [launch_counts()[k]
                                    for k in TRAIN_KERNELS]:
            raise AssertionError(f"train parity: a kernel did not launch "
                                 f"on the card ({launch_counts()})")
        run = {"loss": m["loss"].cpu().reshape(1),
               "occupancy": ex.occupancy.density.cpu()}
        for k, v in ex.named_parameters().items():
            run[f"grad {k}"] = v.grad.cpu()
            run[f"mu {k}"] = ex.optimizer.mu[k].cpu()
            run[f"nu {k}"] = ex.optimizer.nu[k].cpu()
        runs[name] = run
    worst = {}
    for key, a in runs["cuda"].items():
        kind = key.split(" ")[0]
        tol = {"loss": 1e-4, "occupancy": 1e-4, "grad": 1e-3, "mu": 1e-3,
               "nu": 2e-3}[kind]
        worst[kind] = max(worst.get(kind, 0.0),
                          compare(f"train parity: {key}", a,
                                  runs["cpu"][key], tol))
    log("train-parity", f"loss gpu {float(runs['cuda']['loss']):.6f} cpu "
        f"{float(runs['cpu']['loss']):.6f}; worst |gpu - cpu| / max|cpu|: "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))


def bench_scene(dev):
    """The 800x800 synthetic bench scene of bench.py, built on the card."""
    from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
    t0 = time.perf_counter()
    scene = make_synthetic_scene(n_train=16, n_val=1, n_test=1,
                                 image_hw=800, n_samples=64, white_bkgr=False,
                                 device=dev)
    log("train", f"bench scene (16 + 1 + 1 views, 800x800, 64 GT samples) "
        f"built on the card in {time.perf_counter() - t0:.2f} s")
    return scene


def train_phase(scene, dev):
    """The flagship train run; returns the launch counts of steps 0-2,099."""
    import numpy as np
    import torch
    from nerfpp_tpu_torch.config import TrainParams, hashnerf_blocked_preset
    from nerfpp_tpu_torch.data.dataset import RayBatchSampler
    from nerfpp_tpu_torch.executor import NeRFExecutor
    from nerfpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    p = hashnerf_blocked_preset(n_importance=0, use_occupancy_grid=True,
                                occ_update_every=32)
    tmp = tempfile.TemporaryDirectory()
    tp = TrainParams(n_samples=64, n_rand=4096, n_iters=8100, chunk=4096,
                     i_print=32, i_img=0, i_weights=0, i_testset=0,
                     steps_per_call=25, base_dir=tmp.name)
    ex = NeRFExecutor(p, device=dev)
    ex.white_bkgr = scene.white_bkgr
    ex.initialize(scene.bounding_box, tp.lrate_decay, seed=SEED)
    sampler = RayBatchSampler.from_scene(scene, tp.n_rand, tile_h=8,
                                         tile_w=16, device=dev)
    curve = []

    def run(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ex.train(scene, tp, seed=SEED, sampler=sampler, steps=n,
                 progress_fn=lambda i, m: curve.append((i, m["loss"],
                                                        m["psnr"])))
        torch.cuda.synchronize()
        return time.perf_counter() - t

    def per_step(a, b, n):
        return {k: (b[k] - a[k]) / n for k in TRAIN_KERNELS}

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    run(33)                                   # steps 0-32
    c0 = launch_counts()
    early_s = run(32)                         # steps 33-64: one full refresh
    c1 = launch_counts()
    run(1056 - 65)                            # steps 65-1055: warmups end
    c2 = launch_counts()
    late_s = run(32)                          # steps 1056-1087: one phased
    c3 = launch_counts()
    test_view = scene.views[list(scene.split_indices("test"))[0]]

    def held_out_psnr():
        """PSNR of the unbudgeted 800x800 test view, as bench.py renders
        it for its quality numbers."""
        budget = ex.params.render_dense_frac
        ex.params.render_dense_frac = 0.0
        out = ex.render_view(test_view.pose, test_view.h, test_view.w,
                             test_view.k,
                             TrainParams(n_samples=64, chunk=65536))
        ex.params.render_dense_frac = budget
        rgb = torch.clamp(out["nerf"].rgb, 0.0, 1.0).cpu().numpy()
        mse = float(np.mean((rgb - scene.images[test_view.id]) ** 2))
        return -10.0 * math.log10(max(mse, 1e-10))

    peak = torch.cuda.max_memory_allocated()
    psnr_1088 = held_out_psnr()               # outside the counts and peak
    c4 = launch_counts()
    torch.cuda.reset_peak_memory_stats()
    run(2100 - 1088)                          # steps 1088-2099
    counts = {k: v + launch_counts()[k] - c4[k] for k, v in c3.items()}
    peak = max(peak, torch.cuda.max_memory_allocated())
    tmp.cleanup()
    for name in TRAIN_KERNELS:
        if counts[name] == 0:
            raise AssertionError(f"{name} was not launched on the training "
                                 "path")
    for label, secs, a, b in (("steps 33-64 (warmups: full refresh, full "
                               "render; density noise on)", early_s, c0, c1),
                              ("steps 1056-1087 (phased refresh, two-class "
                               "budget)", late_s, c2, c3)):
        ms = secs / 32 * 1e3
        log("train", f"{label}: {ms:.3f} ms/step, "
            f"{tp.n_rand / (ms / 1e3):.1f} rays/s; launches per step "
            + ", ".join(f"{k} {v:.3f}" for k, v in per_step(a, b, 32).items()))
    log("train", f"steps 0-{ex.step - 1} ({ex.step} steps): launches "
        + ", ".join(f"{k} {counts[k]}" for k in TRAIN_KERNELS)
        + f"; peak memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    log("train", "loss curve (step, loss, batch PSNR): "
        + " ".join(f"({i}, {l:.5f}, {q:.2f})" for i, l, q in curve))
    first = statistics.mean(l for _, l, _ in curve[:4])
    last = statistics.mean(l for _, l, _ in curve[-4:])
    if not (math.isfinite(last) and last < 0.5 * first):
        raise AssertionError(f"training loss did not fall: mean of the "
                             f"first four readings {first}, last four {last}")
    psnr = held_out_psnr()
    log("train", f"loss mean {first:.5f} (first four readings) -> "
        f"{last:.5f} (last four); held-out PSNR {psnr_1088:.2f} dB after "
        f"1088 steps, {psnr:.2f} dB after {ex.step} steps (test view "
        f"{test_view.id}, 800x800, unbudgeted)")
    if not psnr > 20.0:
        raise AssertionError(f"held-out PSNR {psnr:.2f} dB <= 20 dB")
    return counts


def view_rays(n_rays, dev, seed=None):
    """Rays of the 800x800 view in row-major pixel order (the small-table
    path neither tiles nor reorders): the n_rays around the image centre,
    or with ``seed`` n_rays random pixels, as a training batch draws them."""
    import torch
    from nerfpp_tpu_torch.core import rays as R
    k, pose = camera(800)
    ro, rd, _ = R.get_rays(800, 800, torch.tensor(k, device=dev),
                           torch.tensor(pose, device=dev))
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    if seed is None:
        start = 800 * 800 // 2 - n_rays // 2
        sel = torch.arange(start, start + n_rays, device=dev)
    else:
        gen = torch.Generator().manual_seed(seed)
        sel = torch.randperm(800 * 800, generator=gen)[:n_rays].to(dev)
    return ro[sel], rd[sel]


def depth_points(enc, ro, rd, n_samples):
    """n_samples evenly spaced depths per ray across the bbox, ray-major
    (as the small-table path flattens samples), clamped to the bbox."""
    import torch
    from nerfpp_tpu_torch.core import rays as R
    near, far = R.intersect_aabb(ro, rd, torch.cat([enc.box_min,
                                                    enc.box_max]))
    t = torch.linspace(0.0, 1.0, n_samples, device=ro.device)
    z = near[:, None] + (far - near)[:, None] * t
    pts = (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(-1, 3)
    return torch.minimum(torch.maximum(pts, enc.box_min), enc.box_max)


def small_encoder(scheme, log2_t, dev):
    from nerfpp_tpu_torch.encoders.hashgrid import HashGridEncoder
    return HashGridEncoder(BBOX, 16, 2, log2_t, 16, 1024, scheme=scheme,
                           use_kernel=True, device=dev)


def small_kernel_phase(enc, table, pts, label):
    """encode_small against its plain version in every mode on one point
    set (packed and f32 table through v2, and the v1 route); the times,
    bound and plain time of the path's mode (packed)."""
    import torch
    from nerfpp_tpu_torch.kernels import hash_encode as KS
    from nerfpp_tpu_torch.kernels.hash_encode_blocked import (
        pack_table_bf16, unpack_table_bf16)
    n, nl = pts.shape[0], enc.n_levels
    packed = pack_table_bf16(table)
    errs, outs = {}, {}
    for mode, tab, pk, version in (("packed", packed, True, "v2"),
                                   ("f32", table, False, "v2"),
                                   ("v1", table, False, "v1")):
        out = KS.hash_encode_fused(table, pts, enc, version, pk)
        torch.cuda.synchronize()
        ref = KS.encode_small_plain(tab, pts, enc, pk)
        # f32 weights on both sides, |table| <= 1: only the order of the
        # eight corner products (and fused multiply-adds) differs
        errs[mode] = float((out - ref).abs().max())
        if not (errs[mode] <= 1e-6 and bool(torch.isfinite(out).all())):
            raise AssertionError(f"{label} {enc.scheme} {mode}: encode_small "
                                 f"max |err| {errs[mode]} > 1e-6")
        outs[mode] = out if mode != "packed" else None
        del ref
    if not torch.equal(outs["f32"], outs["v1"]):
        raise AssertionError(f"{label}: v1 and v2 (f32 table) differ")
    del outs
    ms = cuda_ms(lambda: KS.encode_small(packed, pts, enc, True))
    ms_f32 = cuda_ms(lambda: KS.encode_small(table, pts, enc, False))
    plain = cuda_ms(lambda: KS.encode_small_plain(packed, pts, enc, True),
                    reps=3, inner=1, warmup=1)
    lib_ms, lib_err = embedding_bag_ms(
        enc, unpack_table_bf16(packed), pts,
        KS.encode_small_plain(packed, pts, enc, True))
    # bytes: coordinates read and features written once, the packed table
    # read once; ~100 operations per (point, level): cell, hashes of 8
    # corners, 8 weights, 8 unpacks, 16 FMAs
    nbytes = n * 12 + n * 8 * nl + enc.table_rows * 4 + nl * 24
    ops = 100.0 * n * nl
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / NONTENSOR_OPS_PER_S * 1e3
    log("small", f"{label} encode_small {enc.scheme} T=2^"
        f"{enc.log2_hashmap_size}: N={n} ms={ms:.4f} (f32 table "
        f"{ms_f32:.4f}) plain_ms={plain:.4f} embedding_bag_ms={lib_ms:.4f} "
        f"(excluding the index computation; max |err| {lib_err:.3g}) "
        f"bound_ms={max(t_bytes, t_ops):.4f} (bytes {nbytes} -> "
        f"{t_bytes:.4f} ms, ops {ops:.3g} -> {t_ops:.4f} ms) max_abs_err "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    return dict(ms=ms, ms_f32=ms_f32, plain_ms=plain,
                max_abs_err=max(errs.values()), bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=lib_ms)


def small_grad_phase(enc, pts, label):
    """grad_small against its plain version on one point set, beside one
    PyTorch call (index_add_ of the precomputed corner products)."""
    import torch
    from nerfpp_tpu_torch.encoders.hashgrid import trilerp_weights
    from nerfpp_tpu_torch.kernels import hash_encode as KS
    n, nl = pts.shape[0], enc.n_levels
    gen = torch.Generator().manual_seed(SEED + 5)
    g = torch.randn(n, 2 * nl, generator=gen).to(pts.device)
    out = KS.grad_small(g, pts, enc)
    torch.cuda.synchronize()
    out_p = KS.grad_small_plain(g, pts, enc)
    # atomics sum in a different order each run: hold each entry against
    # the sum of its terms' magnitudes, sum |w * g| (w >= 0)
    mag = KS.grad_small_plain(g.abs(), pts, enc)
    diff = (out - out_p).abs()
    err = float(diff.max())
    rel = float((diff / mag.clamp(min=1e-30)).max())
    if not (rel <= 1e-5 and bool(torch.isfinite(out).all())):
        raise AssertionError(f"{label}: grad_small max |err| {err}, max "
                             f"|err| / sum|w*g| {rel} > 1e-5")
    ms = cuda_ms(lambda: KS.grad_small(g, pts, enc))
    plain = cuda_ms(lambda: KS.grad_small_plain(g, pts, enc), reps=3,
                    inner=1, warmup=1)
    idx, frac = enc.corner_indices(pts)
    vals = (trilerp_weights(frac)[..., None]
            * g.reshape(n, nl, 1, 2)).reshape(-1, 2)
    idx = idx.reshape(-1)
    del frac
    lib_ms = cuda_ms(lambda: torch.zeros(
        (enc.table_rows, 2), device=pts.device).index_add_(0, idx, vals),
        reps=5, inner=2, warmup=1)
    del idx, vals
    # bytes: coordinates and cotangent read once, the gradient written once
    nbytes = n * 12 + n * 8 * nl + enc.table_rows * 8 + nl * 24
    # ~60 operations per (point, level): cell, 8 hashes, 8 weights, 16
    # products
    ops = 60.0 * n * nl
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / NONTENSOR_OPS_PER_S * 1e3
    log("small", f"{label} grad_small {enc.scheme}: N={n} ms={ms:.4f} "
        f"plain_ms={plain:.4f} index_add_ms={lib_ms:.4f} (excluding the "
        f"index computation) bound_ms={max(t_bytes, t_ops):.4f} (bytes "
        f"{nbytes} -> {t_bytes:.4f} ms, ops {ops:.3g} -> {t_ops:.4f} ms) "
        f"max_abs_err={err:.3g} max_err/sum|w*g|={rel:.3g}")
    return dict(ms=ms, plain_ms=plain, library_ms=lib_ms, max_abs_err=err,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def small_phase(dev):
    """Phase 9: both small-table kernels in every mode; returns the stats
    of the serving chunk (encode_small) and the train class (grad_small)."""
    import torch
    gen = torch.Generator().manual_seed(SEED + 1)
    stats = {}
    ro, rd = view_rays(32768, dev)
    for scheme in ("random", "fixed"):
        enc = small_encoder(scheme, 13, dev)
        table = (torch.rand(enc.table_rows, 2, generator=gen) * 2
                 - 1).to(dev)
        pts = depth_points(enc, ro, rd, 256)
        s = small_kernel_phase(enc, table, pts, "serving chunk")
        if scheme == "random":
            stats["encode_small"] = s
        del pts
        pts = (torch.rand(1 << 20, 3, generator=gen) * 2.4 - 1.2).to(dev)
        small_kernel_phase(enc, table, pts, "random points")
        if scheme == "random":
            tro, trd = view_rays(1024, dev, seed=SEED + 2)
            dense = depth_points(enc, tro, trd, 256)
            small_kernel_phase(enc, table, dense, "dense fine class")
            stats["grad_small"] = small_grad_phase(enc, dense,
                                                   "dense fine class")
            del dense
        small_grad_phase(enc, pts, "random points")
        del pts, table
    enc = small_encoder("random", 15, dev)
    table = (torch.rand(enc.table_rows, 2, generator=gen) * 2 - 1).to(dev)
    pts = (torch.rand(1 << 20, 3, generator=gen) * 2.4 - 1.2).to(dev)
    small_kernel_phase(enc, table, pts, "random points")
    small_grad_phase(enc, pts, "random points")
    torch.cuda.empty_cache()
    return stats


def hier_render_parity(state):
    """A 64x64 render of hashnerf_tpu_preset() (64 + 192 samples) with the
    f32 MLP from a trained state, on the card and on the CPU: the 99th
    percentile and the max of |gpu - cpu| (a fine sample an ulp from a
    hash-cell boundary may land in the other cell on one side, and the fine
    depths follow the coarse weights, which the card sums in another
    order)."""
    import torch
    from nerfpp_tpu_torch.config import TrainParams, hashnerf_tpu_preset
    from nerfpp_tpu_torch.executor import NeRFExecutor
    from nerfpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    p = hashnerf_tpu_preset(compute_dtype="float32")
    k64, pose = camera(64)
    outs = {}
    for name in ("cuda", "cpu"):
        ex = NeRFExecutor(p, device=name).initialize(BBOX, seed=SEED)
        ex.load_state({k: v for k, v in state.items()
                       if k.startswith(("embed.", "model."))})
        reset_launch_counts()
        # one CPU generator: both devices draw the same cone scatter
        outs[name] = ex.render_view(
            pose, 64, 64, k64, TrainParams(),
            generator=torch.Generator().manual_seed(SEED))["nerf"]
        if name == "cuda" and launch_counts()["encode_small"] != 2:
            raise AssertionError(f"hier parity: encode_small launches "
                                 f"{launch_counts()} (expected 2)")
    for f, tol in (("rgb", 2e-3), ("acc", 2e-3), ("depth", 2e-3)):
        a, b = getattr(outs["cuda"], f).cpu(), getattr(outs["cpu"], f)
        diff = (a - b).abs()
        p99 = float(torch.quantile(diff.flatten(), 0.99))
        mx = float(diff.max())
        log("hier-parity", f"64x64 {f}: max |gpu - cpu| {mx:.3g}, p99 "
            f"{p99:.3g} (p99 limit {tol}, max limit {25 * tol})")
        if not (torch.isfinite(a).all() and p99 <= tol and mx <= 25 * tol):
            raise AssertionError(f"64x64 hierarchical {f} GPU vs CPU out of "
                                 "tolerance")


def hier_parity():
    """One tiny hier-budget train step (L = 4, T = 2^12, NRand 512, 8 + 16
    samples, sparse class 4, the preconditioning noise and cone scatter on)
    on the card and on the CPU from the same seeded state; one CPU generator
    gives both runs the same draws. The loss to 1e-4 of itself, gradients
    and first moments to 1e-3 of each tensor's largest (the card's kernels
    and matrix products sum in other orders, the gradient with atomics),
    second moments to 2e-3."""
    import torch
    from nerfpp_tpu_torch.config import TrainParams, hashnerf_tpu_preset
    from nerfpp_tpu_torch.data.dataset import RayBatchSampler
    from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
    from nerfpp_tpu_torch.executor import NeRFExecutor
    from nerfpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    scene = make_synthetic_scene(n_train=2, n_val=1, n_test=1, image_hw=32,
                                 n_samples=32, white_bkgr=False, device="cpu")
    p = hashnerf_tpu_preset(n_levels=4, log2_hashmap_size=12,
                            n_importance=16, hier_sparse_importance=4,
                            compute_dtype="float32")
    tp = TrainParams(n_samples=8, n_rand=512, chunk=512, n_iters=100)
    runs = {}
    for name in ("cuda", "cpu"):
        ex = NeRFExecutor(p, device=name)
        ex.white_bkgr = scene.white_bkgr
        ex.initialize(scene.bounding_box, tp.lrate_decay, seed=SEED)
        sampler = RayBatchSampler.from_scene(scene, tp.n_rand, device=name)
        reset_launch_counts()
        m = ex._build_train_step(tp)(
            0, sampler, torch.Generator().manual_seed(SEED + 7))
        if name == "cuda" and 0 in [launch_counts()[k]
                                    for k in HIER_KERNELS]:
            raise AssertionError(f"hier train parity: a kernel did not "
                                 f"launch on the card ({launch_counts()})")
        run = {"loss": m["loss"].cpu().reshape(1)}
        for k, v in ex.named_parameters().items():
            run[f"grad {k}"] = v.grad.cpu()
            run[f"mu {k}"] = ex.optimizer.mu[k].cpu()
            run[f"nu {k}"] = ex.optimizer.nu[k].cpu()
        runs[name] = run
    worst = {}
    for key, a in runs["cuda"].items():
        kind = key.split(" ")[0]
        tol = {"loss": 1e-4, "grad": 1e-3, "mu": 1e-3, "nu": 2e-3}[kind]
        worst[kind] = max(worst.get(kind, 0.0),
                          compare(f"hier train parity: {key}", a,
                                  runs["cpu"][key], tol))
    log("hier-parity", f"train step loss gpu "
        f"{float(runs['cuda']['loss']):.6f} cpu "
        f"{float(runs['cpu']['loss']):.6f}; worst |gpu - cpu| / max|cpu|: "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))


def hier_phase(scene, dev, t_start):
    """Phases 11 and 12: the README's training run of hashnerf_tpu_preset()
    on the bench scene, then serving of the trained state. Returns the
    launch counts of both runs."""
    import numpy as np
    import torch
    from nerfpp_tpu_torch.config import TrainParams, hashnerf_tpu_preset
    from nerfpp_tpu_torch.data.dataset import RayBatchSampler
    from nerfpp_tpu_torch.executor import NeRFExecutor
    from nerfpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    p = hashnerf_tpu_preset()
    tmp = tempfile.TemporaryDirectory()
    # the README's run; i_img 0: image writing is not ported
    tp = TrainParams(n_iters=2000, n_rand=4096, n_samples=64, chunk=4096,
                     i_print=32, i_img=0, i_weights=0, i_testset=0,
                     base_dir=tmp.name)
    ex = NeRFExecutor(p, device=dev)
    ex.white_bkgr = scene.white_bkgr
    ex.initialize(scene.bounding_box, tp.lrate_decay, seed=SEED)
    sampler = RayBatchSampler.from_scene(scene, tp.n_rand, device=dev)
    curve = []

    def run(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ex.train(scene, tp, seed=SEED, sampler=sampler, steps=n,
                 progress_fn=lambda i, m: curve.append((i, m["loss"],
                                                        m["psnr"])))
        torch.cuda.synchronize()
        return time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    run(1024)                                 # steps 0-1023
    c0 = launch_counts()
    window_s = run(32)                        # steps 1024-1055
    c1 = launch_counts()
    per_step = {k: (c1[k] - c0[k]) / 32 for k in HIER_KERNELS}
    # the rest, in pieces, while the script's time budget allows
    last = tp.n_iters - 1
    while ex.step < last:
        if time.perf_counter() - t_start > TIME_BUDGET_S:
            log("hier-train", f"CUT: stopped at step {ex.step} of {last} "
                f"after {time.perf_counter() - t_start:.1f} s of the script")
            break
        run(min(128, last - ex.step))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tmp.cleanup()
    ms = window_s / 32 * 1e3
    log("hier-train", f"steps 1024-1055: {ms:.3f} ms/step, "
        f"{tp.n_rand / (ms / 1e3):.1f} rays/s; launches per step "
        + ", ".join(f"{k} {v:.3f}" for k, v in per_step.items()))
    log("hier-train", f"steps 0-{ex.step - 1} ({ex.step} steps): launches "
        + ", ".join(f"{k} {counts[k]}" for k in HIER_KERNELS)
        + f"; peak memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    log("hier-train", "loss curve (step, loss, batch PSNR): "
        + " ".join(f"({i}, {l:.5f}, {q:.2f})" for i, l, q in curve))
    for name in HIER_KERNELS:
        if counts[name] == 0:
            raise AssertionError(f"{name} was not launched on the "
                                 "hierarchical training path")
    first = statistics.mean(l for _, l, _ in curve[:4])
    final = statistics.mean(l for _, l, _ in curve[-4:])
    if not (math.isfinite(final) and final < 0.5 * first):
        raise AssertionError(f"hierarchical training loss did not fall: "
                             f"mean of the first four readings {first}, "
                             f"last four {final}")
    log("hier-train", f"loss mean {first:.5f} (first four readings) -> "
        f"{final:.5f} (last four)")
    hier_render_parity(ex.state_dict())

    # 12. serving of the trained state -----------------------------------
    view = scene.views[list(scene.split_indices("test"))[0]]
    serve_tp = TrainParams()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    frame_ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ex.render_view(view.pose, view.h, view.w, view.k, serve_tp)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    serve_counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    res = out["nerf"]
    for f, shape in (("rgb", (800, 800, 3)), ("depth", (800, 800)),
                     ("acc", (800, 800))):
        v = getattr(res, f)
        if tuple(v.shape) != shape or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"hierarchical 800x800 {f}: shape "
                                 f"{tuple(v.shape)} or non-finite values")
    if serve_counts["encode_small"] == 0:
        raise AssertionError("encode_small was not launched on the "
                             "hierarchical serving path")
    def psnr_of(v, out):
        rgb = torch.clamp(out["nerf"].rgb, 0.0, 1.0).cpu().numpy()
        mse = float(np.mean((rgb - scene.images[v.id]) ** 2))
        return -10.0 * math.log10(max(mse, 1e-10))

    psnr = psnr_of(view, out)
    train_view = scene.views[list(scene.split_indices("train"))[0]]
    psnr_train = psnr_of(train_view, ex.render_view(
        train_view.pose, train_view.h, train_view.w, train_view.k, serve_tp))
    med = statistics.median(frame_ms[1:])
    log("hier-serve", f"800x800 frames ms {[round(t, 3) for t in frame_ms]}; "
        f"median {med:.3f} ms/frame, {0.64 / (med / 1e3):.4f} Mpix/s, "
        f"{800 * 800 * (serve_tp.n_samples + p.n_importance + serve_tp.n_samples) / (med / 1e3) / 1e6:.1f} M points/s")
    log("hier-serve", f"launches per frame: encode_small "
        f"{serve_counts['encode_small'] / 4:.2f}; peak memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB)")
    log("hier-serve", f"held-out PSNR {psnr:.2f} dB after {ex.step} steps "
        f"(test view {view.id}, 800x800); training view {train_view.id} "
        f"{psnr_train:.2f} dB")
    return {k: counts[k] + serve_counts[k] for k in HIER_KERNELS}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "a GPU", file=sys.stderr)
        return 1
    if not (Path(__file__).resolve().parent / "nerfpp_tpu_torch").is_dir():
        print("chip_smoke: the nerfpp_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 1
    import numpy as np
    from nerfpp_tpu_torch.config import TrainParams, hashnerf_blocked_preset
    from nerfpp_tpu_torch.core.occupancy import OccupancyGrid
    from nerfpp_tpu_torch.encoders.hashgrid import HashGridEncoder
    from nerfpp_tpu_torch.executor import NeRFExecutor
    from nerfpp_tpu_torch.kernels import (build, launch_counts,
                                          reset_launch_counts)
    from nerfpp_tpu_torch.render.renderer import k_dense_of
    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # 1. device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log("device", f"{kind} | {smi} | torch {torch.__version__} | "
        f"CUDA {torch.version.cuda} | python {sys.version.split()[0]}")

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    reports = build.build_all(verbose=True)
    seconds = time.perf_counter() - t0
    log("build", f"{len(reports)} kernels built in {seconds:.2f} s "
        f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"{name}: {line.strip()}")

    # 3. kernels against their plain versions -----------------------------
    enc = HashGridEncoder(BBOX, 16, 2, 19, 16, 1024, use_kernel=True,
                          device=dev)
    gen = torch.Generator().manual_seed(SEED)
    table = (torch.rand(enc.table_rows, 2, generator=gen) * 2 - 1).to(dev)
    occ = OccupancyGrid(density=sphere_grid(128, 0.5, 10.0, dev))
    pts_chunk = chunk_points(enc, occ, 65536, 64, dev)
    stats = kernel_phase(enc, table, pts_chunk, "chunk")
    pts_rand = (torch.rand(1 << 20, 3, generator=gen) * 2.4 - 1.2).to(dev)
    kernel_phase(enc, table, pts_rand, "random")
    pts_train = chunk_points(enc, occ, 4096, 64, dev)
    kernel_phase(enc, table, pts_train, "train chunk")
    del pts_chunk

    # 4. full-width 64x64 render: GPU path against the CPU plain path -----
    p = hashnerf_blocked_preset(n_importance=0, use_occupancy_grid=True,
                                thin_ray=True)
    tp = TrainParams(n_samples=64, chunk=65536)
    k64, pose = camera(64)
    outs = {}
    fracs = {}
    for name in ("cuda", "cpu"):
        ex = NeRFExecutor(p, device=name).initialize(BBOX, seed=SEED)
        ex.embedder.table.data.copy_(table)       # |table| <= 1, seeded
        ex.load_state({"occupancy": occ.density})
        outs[name] = ex.render_view(pose, 64, 64, k64, tp)["nerf"]
        fracs[name] = ex._auto_dense_frac(64, 64, k64, pose)
    if fracs["cuda"] != fracs["cpu"]:
        raise AssertionError(f"auto dense_frac differs: {fracs}")
    for f, tol in (("rgb", 2e-3), ("acc", 2e-3), ("depth", 2e-3)):
        a, b = getattr(outs["cuda"], f).cpu(), getattr(outs["cpu"], f)
        diff = (a - b).abs()
        # bf16 MLP inputs: a feature one f32 ulp apart can round to the
        # neighbouring bf16 value (2^-8 relative), so rare samples differ
        # more; the 99th percentile holds the bulk, the max the outliers
        p99 = float(torch.quantile(diff.flatten(), 0.99))
        mx = float(diff.max())
        log("parity", f"{f}: max |gpu - cpu| {mx:.3g}, p99 {p99:.3g} "
            f"(p99 limit {tol}, max limit {5 * tol})")
        if not (torch.isfinite(a).all() and p99 <= tol and mx <= 5 * tol):
            raise AssertionError(f"64x64 {f} GPU vs CPU out of tolerance")
    log("parity", f"auto dense_frac {fracs['cuda']} on both devices")

    # 5. full-width serving ------------------------------------------------
    p = hashnerf_blocked_preset(n_importance=0, use_occupancy_grid=True)
    ex = NeRFExecutor(p, device=dev).initialize(BBOX, seed=SEED)
    ex.load_state({"occupancy": occ.density})
    k800, pose = camera(800)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    frame_ms = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ex.render_view(pose, 800, 800, k800, tp)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    res = out["nerf"]
    for f, shape in (("rgb", (800, 800, 3)), ("depth", (800, 800)),
                     ("acc", (800, 800))):
        v = getattr(res, f)
        if tuple(v.shape) != shape or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"800x800 {f}: shape {tuple(v.shape)} or "
                                 "non-finite values")
    if tuple(out["rgb8"].shape) != (800, 800, 3):
        raise AssertionError("rgb8 shape")
    for name in SERVE_KERNELS:
        if counts[name] == 0:
            raise AssertionError(f"{name} was not launched on the serving "
                                 "path")
    frac = ex._auto_dense_frac(800, 800, k800, pose)
    n_tiles = 800 * 800 // 128
    kd = k_dense_of(frac, n_tiles)
    med = statistics.median(frame_ms[1:])
    log("serve", f"800x800 frames ms {[round(t, 3) for t in frame_ms]} "
        f"(first includes the occupancy probe)")
    log("serve", f"median {med:.3f} ms/frame, {0.64 / (med / 1e3):.4f} "
        f"Mpix/s; auto dense_frac {frac}; tiles dense {kd} sparse "
        f"{n_tiles - kd}")
    log("serve", f"launches per frame: "
        + ", ".join(f"{k} {counts[k] / 6:.2f}" for k in SERVE_KERNELS)
        + f"; peak memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    log("serve", f"image: rgb mean {float(res.rgb.mean()):.4f}, acc mean "
        f"{float(res.acc.mean()):.4f}; total run "
        f"{time.perf_counter() - t_start:.1f} s")

    del ex, out, res

    # 6. K3 against its plain version ---------------------------------------
    stats["grad_blocked"] = grad_phase(enc, pts_train, "train chunk")
    grad_phase(enc, pts_rand, "random")
    del pts_train, pts_rand, table
    torch.cuda.empty_cache()

    # 7. one tiny train step, GPU against CPU -------------------------------
    train_parity()

    # 8. full-width training ----------------------------------------------
    scene = bench_scene(dev)
    counts = train_phase(scene, dev)
    log("train", f"total run {time.perf_counter() - t_start:.1f} s")

    # 9. small-table kernels against their plain versions ------------------
    stats.update(small_phase(dev))

    # 10. a hierarchical train step, GPU against CPU -----------------------
    hier_parity()

    # 11, 12. hierarchical training and serving ----------------------------
    counts.update(hier_phase(scene, dev, t_start))
    log("hier-serve", f"total run {time.perf_counter() - t_start:.1f} s")

    sources = {"window_lists": ("nerfpp_tpu_torch/csrc/window_lists.cu",
                                "nerfpp_tpu/pallas/hash_encode_blocked.py:140"),
               "encode_blocked": ("nerfpp_tpu_torch/csrc/encode_blocked.cu",
                                  "nerfpp_tpu/pallas/hash_encode_blocked.py:270"),
               "grad_blocked": ("nerfpp_tpu_torch/csrc/grad_blocked.cu",
                                "nerfpp_tpu/pallas/hash_encode_blocked.py:451"),
               "encode_small": ("nerfpp_tpu_torch/csrc/encode_small.cu",
                                "nerfpp_tpu/pallas/hash_encode.py:127 and "
                                "nerfpp_tpu/pallas/hash_encode.py:48"),
               "grad_small": ("nerfpp_tpu_torch/csrc/grad_small.cu",
                              "nerfpp_tpu/encoders/hashgrid.py:334")}
    kernels = [dict(name=name, route="cuda", source=sources[name][0],
                    replaces=sources[name][1], launches=counts[name],
                    max_abs_err=s["max_abs_err"], ms=s["ms"],
                    plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
                    bound_by=s["bound_by"],
                    library_ms=s.get("library_ms"))
               for name, s in stats.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
