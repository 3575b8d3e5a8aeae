#!/usr/bin/env python3
"""GPU smoke run of nerfpp_tpu_torch, the PyTorch/CUDA port (one H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --repeat-train K [--preset P] [--seed S]
    python3 chip_smoke.py --capture-only
    python3 chip_smoke.py --options-only
    python3 chip_smoke.py --jpeg-only
    python3 chip_smoke.py --formats-only

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
  6. gradient: K3 (grad_blocked, and its index kernel grad_blocked_index)
     against its plain versions at the training chunk (4,096 tile-ordered
     rays x 64 samples, sample-major) and on the 2^20 random points, beside
     one index_add_ of the precomputed corner products; two launches must be
     bitwise equal and the index exact.
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
     reference's 2,100-step quality point). Then determinism: the same
     configuration trained twice from seed 0 for 64 steps, fresh executors
     and samplers; the losses must be bitwise equal at every step and the
     parameters, Adam state and occupancy grid after the last.
  9. small-table kernels: encode_small (K4 and K5) against its plain version
     in every mode (packed and f32 table, fixed and random scheme, the v1
     route) at 16 levels, T = 2^13, on one serving chunk's fine-pass points
     (32,768 rays x 256 depths), on 2^20 random points and on the dense fine
     class of a train step (1,024 rays x 256 depths), and at T = 2^15, beside
     one embedding_bag over the precomputed corner indices and weights;
     grad_small (the order-fixed gradient's bin pass and owner pass)
     against its plain version on the dense fine class of a train step
     (1,024 rays x 256 depths) and on the 2^20 random points, beside one
     index_add_ of the precomputed corner products; two launches must be
     bitwise equal.
 10. hierarchical train parity: one tiny hier-budget train step, GPU
     against CPU from the same seeded state with the same draws.
 11. hierarchical training: NeRFExecutor.train of hashnerf_tpu_preset() on
     the same bench scene with the README's TrainParams(n_iters=2000,
     n_rand=4096, n_samples=64, chunk=4096), steps 0-1,998 unless the
     script's time budget cuts them (the cut is printed); steps 1,024-1,055
     are timed; launch counts are reset before step 0 and read after the
     last step; the loss curve must fall. Then a 64x64 render of the
     trained state with the f32 MLP, GPU against CPU. (Cut before 600 s of
     the script, to leave phases 12-15 their time.)
 12. hierarchical serving: render_view of the trained state at full width,
     800x800, TrainParams() (64 + 192 samples, chunk 32,768), 1 + 3 frames
     of the test view, launch counts reset just before and read just after;
     its held-out PSNR. Then determinism of hashnerf_tpu_preset(): phase
     8's check, two 64-step runs from seed 0 bitwise equal.
 13. large-table kernels: encode_large, grad_large and its bin pass
     grad_large_bins against their plain versions at hashnerf_preset()'s
     table (16 levels x 2^19 f32 entries), fixed and random schemes, on a
     serving chunk's fine pass (32,768 rays x 256 depths), a train step's
     coarse pass (4,096 rays x 64) and dense fine class (1,024 x 256) and
     2^20 random points, beside one embedding_bag or index_add_; two
     gradient launches must be bitwise equal, the bin pass's records, run
     offsets and plan exactly its plain version's; the mean distinct 128-byte
     table lines a warp's gather touches in encode_large's former layout
     (a thread a (point, level)) and its level-major one, from the serving
     chunk's corner indices.
 14. reference-parity preset: a tiny hashnerf_preset() train step GPU
     against CPU; determinism of hashnerf_preset() (two 64-step runs from
     seed 0 on the bench scene bitwise equal); then the README's command
     line in-process: the bench
     scene exported as a Blender tree, ``cli train --preset hashnerf
     --set-train NIters=2000`` (launch counts reset before step 0 and read
     after; steps 1,024-1,055 timed; the loss must fall; only encode_large
     and grad_large may launch), ``cli render`` of the test split read back
     with the port's PNG reader (held-out PSNR), ``cli render
     --spherical-path --n-poses 2`` (the PNGs decode and are not constant),
     and 1 + 3 800x800 frames of the trained state at TrainParams().
 15. classic NeRF: a tiny classic_nerf_preset() train step GPU against CPU,
     then bench.py's classic configuration at full width (8 x 256, 64 + 64
     samples, NRand 4,096), 1 + 10 timed steps; no kernel may launch.
 16. LeRF, hashnerf_preset(use_lerf=True): (a) a tiny LeRF train step GPU
     against CPU (99 % of each gradient within phase 7's limits, every
     entry within ten times them: the importance depths of near-empty bins
     move with the rounding), then a 64x64 LeRF render of the stepped state
     with relevancy within phase 4's limits; (b) encode_large, grad_large
     and grad_large_bins against their plain versions at the language
     table (14 levels x 2^16 f32, primes seed 1) on a step's fine pass
     (4,096 random pixels x 256 depths), beside embedding_bag and
     index_add_; two gradient launches bitwise equal; (c) the stand-in CLIP
     pyramid of the bench scene at E = 768 as ``cli train`` builds it
     (windows of 168 / 336 / 672 px), then 512 steps with launch counts
     reset before step 0 and read after the last, steps 449-512 timed,
     both the image and the language loss falling (means of the last 32
     steps below the first 32), peak memory; (d) 1 + 2 800x800 frames with
     relevancy at TrainParams() (the prompts stand-in embeddings of flat
     patches of the blue prim against the red one and black), relevancy
     [800, 800, 1] finite in [0, 1] and not constant, its AUC and IoU
     against the blue prim's mask, render_path's relevancy_0.png read back;
     (e) two 32-step seed-0 LeRF runs bitwise equal; (f) bench.py's LeRF
     quality configuration (128 px, 8 views, 24-d stand-in, 32 + 16
     samples, 1,000 steps): both losses must fall and the held-out map
     must not be constant; its relevancy AUC and IoU@0.5 are printed.
 17. real capture: (a) the bench scene written as a COLMAP workspace by
     scripts/colmap_export.py (12 train views at 800x800 and 4 by a second
     camera at 1000x1000 with the same field of view, both OPENCV cameras
     with small non-zero k1, k2, p1, p2, every image distorted; about 50 k
     surface points from the rendered depths, each observed in every train
     view whose depth agrees; sparse/0 in .bin and .txt; the test view left
     out); (b) the port's native parser built and reading it, equal to the
     Python .bin and the .txt parsers, the poses back within 1e-5, the new
     K, the undistortion and both resizes on the card equal to the CPU's,
     load and undistortion seconds, the COLMAP box against the scene's;
     (c) ``cli train --dataset-type colmap --preset hashnerf_blocked --set
     use_occupancy_grid=true --set n_importance=0 --set occ_update_every=32
     --set-train NIters=2100 --set-train NRand=4096 --set-train NSamples=64
     --set-train Chunk=4096`` in-process (launch counts reset before step 0
     and read after: K1, K2, K3 and its index, no other kernel; steps
     1,056-1,087 timed; the loss must fall), the held-out PSNR of the test
     view at its true pose and K beside phase 8's, then two 64-step seed-0
     runs of the same command bitwise equal; (d) the same command on the
     Blender export of the scene (the loader's loose corner-ray box),
     without and with ``--set-train BboxRefitStep=1024``: the refit must
     fire with a volume shrink of at least 1.5 and K1-K3 must launch after
     it on the new box; both held-out PSNRs beside phase 8's.
 18. data parallelism (parallel/mesh.py): (a) the flagship under an NCCL
     mesh of one rank for 64 steps from seed 0, bitwise phase 8's
     determinism run, steps 32-63 timed beside phase 8's 33-64; (b) two
     ranks on the one card through gloo from phase 8's state at step 992
     for 64 steps across 1,024 (the implicit path: one chunk, 16 tiles a
     rank, the budget ranked over all 32): with the MLP in f32 every step
     against one device's step from the same state (rank 0 keeps a
     lock-step copy; loss to 2e-4, summed gradients to 1e-3 of each
     tensor's largest), then the flagship itself free-running: both
     ranks' losses and states bitwise equal, K1-K3 launches a step a
     rank, its losses beside phase 8's; the all-reduce alone
     on the flagship's gradient buffer, f32 and bf16, at one rank (NCCL)
     and two (gloo); (c) ``cli train --n-devices 1`` of hashnerf_preset()
     for 8 steps, only the large pair launching.
 19. the stack's remaining options: (a) a LeRF-only stack,
     hashnerf_preset(use_nerf=False, use_lerf=True) at full width: a tiny
     step GPU against CPU, ``cli train --set use_nerf=false --set
     use_lerf=true`` on the bench scene's Blender export for 257 steps
     (steps 128-255 timed, launch counts reset before and read after: only
     the large pair; the language loss must fall; non-finite losses and
     state tensors counted), 2 800x800 frames with relevancy (AUC, IoU@0.5
     as phase 16), a 64x64 crop GPU against CPU, ``cli render`` of the
     checkpoint; (b) the normals head on the flagship
     (hashnerf_blocked_preset(..., use_pred_normal=True)), 64 steps from
     seed 0 through NeRFExecutor.train with profile_dir: its losses and
     shared state against phase 8's determinism run (bitwise predicted;
     a miss is reported, not raised), the trace must name K1's, K2's and
     K3's kernels, and its 800x800 frame must be bitwise the headless
     state's; (c) NDC: render_ray_batch(focal=, hw=) forward and backward
     on 4,096 forward-facing rays x (64 + 192) of hashnerf_preset(
     hier_ray_tile=0, hier_tile_budget_frac=0.0) (only the large pair),
     encode_large and the hashed gradient against their plain versions on
     its fine pass's NDC points, 800x800 frames under TrainParams(ndc=True)
     with and without c2w_staticcam, and 64x64 windows GPU against CPU.
 20. JPEG capture (utils/jpeg.py, csrc/jpeg_entropy.cpp): (a) phase 17's
     COLMAP export with JPEG views, encoded on the card; (b) the
     undistortion on the card (decode, undistort, re-encode at quality
     95), views 1 and 4 also through the CPU (the files byte-equal), every
     exported and undistorted file decoded on the card and the CPU
     (bitwise equal) and re-encoded on both (byte-equal), the committed
     cv2 fixtures (tests/data/jpeg) decoded and encoded on the card to
     cv2's pixels and bytes, decode and encode seconds, MB/s and Mpix/s
     (host entropy pass and device stages apart) for the 16 views and a
     4,000x3,000 upscale, load_images of the undistorted views; (c) phase
     17(c)'s flagship ``cli train --dataset-type colmap`` on the JPEG
     workspace to NIters 2,100, cut to 1,088 (and the cut printed) if the
     script, with it and phase 21 at its shortest, would pass 1,080 s
     (launch counts reset before step 0 and read after: K1, K2, K3 and its
     index, no other kernel; steps 1,056-1,087 timed, 1,024-1,055 after a
     cut; the loss must fall), its held-out PSNR beside phase 17's.
 21. image files (utils/png.py, utils/jpeg.py progressive, utils/tiff.py,
     csrc/tiff_codec.cpp): (a) phase 17's COLMAP export with the 800x800
     camera's 12 views as progressive JPEG and the 1000x1000 camera's 4 as
     LZW TIFF, written on the card; (b) the undistortion on the card
     (progressive views written back as baseline JPEG at quality 95, TIFF
     as TIFF), views 1 and 4 also through the CPU, every exported and
     undistorted file decoded on the card and the CPU (bitwise equal), the
     committed cv2 fixtures (tests/data/image: progressive JPEG whole and
     cut, PNG kinds, TIFF variants) decoded on the card to cv2's pixels and
     prog_source encoded progressive on the card to cv2's bytes, a 16-bit
     PNG copy of views 1 and 4 through undistort_images and load_images on
     the card against the CPU, the decode seconds of the 12 progressive
     views and of a 4,000x3,000 progressive upscale (host entropy pass and
     device stages apart), of the 4 TIFF views, the undistortion and
     load_images; (c) phase 17(c)'s flagship ``cli train --dataset-type
     colmap`` on the mixed workspace to NIters 2,100 (cut to 1,088, and
     the cut printed, if the script would pass 1,080 s; launch counts reset
     before step 0 and read after: K1, K2, K3 and its index, no other
     kernel; steps 1,056-1,087 timed; the loss must fall), its held-out
     PSNR beside phases 17 and 20.
The line before the last is the kernel summary JSON, each kernel's
launches those of the main path it runs on: phase 3's serving for K1/K2,
phase 8's, phase 17's, phase 20's and phase 21's COLMAP training for K1-K3
(phases 17, 20 and 21 add their own), phase 11's for encode_small and
grad_small, phase 14's cli train and phase 16's LeRF training and frames
for encode_large, grad_large and the bin pass grad_large_bins (which phase
11's path launches too, once per grad_small: its count is printed there);
its times are phases 3, 6, 9 and 13's. The last line is
{"ok": true, "device": {...}}.

``--repeat-train K`` runs only phases 1-2 and then one preset's training K
times in one process from seed S (``--seed``, default 0), each run with a
fresh executor and sampler: ``--preset flagship`` (the default) phase 8,
with its held-out PSNRs after 1,088 and 2,100 steps; ``tpu`` or
``hashnerf`` hashnerf_tpu_preset() or hashnerf_preset() with phase 11's
run (the README's TrainParams(n_iters=2000) on the bench scene, steps
0-1,998), with the held-out PSNR of the test view at TrainParams() after
it. Per run it prints the first step whose loss differs bitwise from run
1's and the largest |table - run 1's table| after step 64; it ends with
the same last line. ``--capture-only`` runs phases 1-2 and then phase 17
alone (without phase 8's PSNR to print beside its own); ``--options-only``
phases 1-2 and phase 19, against a 64-step seed-0 flagship run of its own
in place of phase 8's; ``--jpeg-only`` phases 1-2 and phase 20 (without
phase 17's PSNR); ``--formats-only`` phases 1-2 and phase 21 (without
phases 17's and 20's PSNRs). Any failed check raises, and the script exits
non-zero; without CUDA, or without the nerfpp_tpu_torch package beside it, it
fails before printing a result.
"""
import argparse
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
TRAIN_KERNELS = ("window_lists", "encode_blocked", "grad_blocked_index",
                 "grad_blocked")
HIER_KERNELS = ("encode_small", "grad_large_bins", "grad_small")
LARGE_KERNELS = ("encode_large", "grad_large_bins", "grad_large")
TIME_BUDGET_S = 600            # phase 11 is cut to leave phases 12-15 room
DP_FIRST, DP_STEPS = 992, 64   # phase 18's 2-rank window: across step 1,024
COLMAP_TRAIN_S = 100           # a 2,100-step flagship cli train and its
                               # render in phases 20-21: 66-87 s on an H100
FORMATS_MIN_S = 70             # phase 21 with its cut: 62 s on an H100
SOFT_LIMIT_S = 1080            # phases 20-21 cut their training to end by it


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
    """K3 (its index kernel and the owner kernel, over K1's lists of the
    points) against its plain version on one point set: two launches
    bitwise equal, the index exactly its plain version's; beside one
    PyTorch call (index_add_ of the precomputed corner products). Returns
    the stats of grad_blocked (index build included) and of its index."""
    import torch
    from nerfpp_tpu_torch.encoders.hashgrid import trilerp_weights
    from nerfpp_tpu_torch.kernels import hash_encode_blocked as K
    n, nl = pts.shape[0], enc.n_levels
    ng = n // 128
    gen = torch.Generator().manual_seed(SEED + 3)
    g = torch.randn(n, 2 * nl, generator=gen).to(pts.device)
    wids, counts = K.window_lists(pts, enc)
    out = K.grad_blocked(g, pts, wids, counts, enc)
    again = K.grad_blocked(g, pts, wids, counts, enc)
    index = K.grad_blocked_index(pts, wids, counts, enc)
    torch.cuda.synchronize()
    index_p = K.grad_blocked_index_plain(pts, wids, counts, enc)
    # mask, permutation and plan exactly; the run table where the mask is
    # set (the kernel writes nothing elsewhere)
    lst = K.listed(index_p[0], ng)
    if not (torch.equal(index[0], index_p[0])
            and torch.equal(index[1], index_p[1])
            and torch.equal(index[2][lst], index_p[2][lst])
            and torch.equal(index[3], index_p[3])):
        raise AssertionError(f"{label}: grad_blocked_index differs from its "
                             "plain version")
    n_items, n_slots = int(index[3][0]), int(index[3][1])
    most = int(index[3][4:4 + nl * K.index_shape(enc, ng)[1]].max())
    n_runs = int(lst.sum())
    del lst
    if not torch.equal(out, again):
        raise AssertionError(f"{label}: two grad_blocked launches on the "
                             "same inputs differ")
    out_p = K.grad_blocked_plain(g, pts, enc)
    # the kernel and index_add_ add each entry's terms in other orders:
    # hold each entry against the sum of its terms' magnitudes, sum |w * g|
    # (w >= 0); where no term falls, exactly zero
    mag = K.grad_blocked_plain(g.abs(), pts, enc)
    diff = (out - out_p).abs()
    err = float(diff.max())
    rel = float((diff / mag.clamp(min=1e-30)).max())
    zeros = not bool(out[mag == 0].any())
    if not (rel <= 1e-5 and zeros and bool(torch.isfinite(out).all())):
        raise AssertionError(f"{label}: grad_blocked max |err| {err}, "
                             f"max |err| / sum|w*g| {rel} > 1e-5, or an "
                             f"entry with no term not zero ({zeros})")
    del out, again, out_p, mag, diff, index, index_p
    k3_ms = cuda_ms(lambda: K.grad_blocked(g, pts, wids, counts, enc))
    idx_ms = cuda_ms(lambda: K.grad_blocked_index(pts, wids, counts, enc))
    k3_plain = cuda_ms(lambda: K.grad_blocked_plain(g, pts, enc), reps=5,
                       inner=1, warmup=1)
    idx_plain = cuda_ms(lambda: K.grad_blocked_index_plain(pts, wids, counts,
                                                           enc),
                        reps=5, inner=1, warmup=1)
    idx, frac = enc.corner_indices(pts)
    vals = (trilerp_weights(frac)[..., None]
            * g.reshape(n, nl, 1, 2)).reshape(-1, 2)
    idx = idx.reshape(-1)
    del frac
    lib_ms = cuda_ms(lambda: torch.zeros(
        (enc.table_rows, 2), device=pts.device).index_add_(0, idx, vals),
        reps=5, inner=2, warmup=1)
    del idx, vals
    # bytes: coordinates and cotangent read once, K1's counts and unique
    # window ids read once, the gradient written once; the index writes a
    # permutation byte a point and level, a run a (level, window, group),
    # the bitmask and the plan
    _, nw, words, _ = K.index_shape(enc, ng)
    k1_ids = nl * ng * 4 + 4 * int(counts.sum())
    small = nl * 16
    k3_bytes = n * 12 + n * 8 * nl + k1_ids + enc.table_rows * 8 + small
    idx_bytes = (n * 12 + k1_ids + n * nl + 2 * n_runs
                 + nl * nw * words * 4 + (16 + 12 * nl * nw + 8 * n_items)
                 + small)
    # operations per (point, level): K3 ~60 (cell, slot, 8 weights, 16
    # products), its index ~20 (cell, window code)
    stats = {}
    for name, ms, plain, nbytes, ops, e, lib in (
            ("grad_blocked_index", idx_ms, idx_plain, idx_bytes,
             20.0 * n * nl, 0.0, None),
            ("grad_blocked", k3_ms, k3_plain, k3_bytes, 60.0 * n * nl, err,
             lib_ms)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / NONTENSOR_OPS_PER_S * 1e3
        stats[name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                           max_abs_err=e, bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops
                           else "operations")
        log("grad", f"{label} {name}: N={n} ms={ms:.4f} plain_ms="
            f"{plain:.4f} bound_ms={max(t_bytes, t_ops):.4f} (bytes "
            f"{nbytes} -> {t_bytes:.4f} ms, ops {ops:.3g} -> {t_ops:.4f} "
            f"ms) max_abs_err={e:.3g}"
            + ("" if lib is None else f" max_err/sum|w*g|={rel:.3g} "
               f"index_add_ms={lib:.4f} (excluding the index computation)"))
    log("grad", f"{label}: two grad_blocked launches bitwise equal; index "
        f"exact; mean windows per (group, level) "
        f"{float(counts.float().mean()):.2f}; the most points in one window "
        f"{most}; {n_items} parts of windows, {n_slots} of them partial "
        f"sums")
    return stats


def compare(label, a, b, tol):
    """Worst |a - b| / max|b| of two tensors, against ``tol``."""
    import torch
    ratio = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    if not (bool(torch.isfinite(a).all()) and ratio <= tol):
        raise AssertionError(f"{label} differs by {ratio:.3g} of its largest "
                             f"value (limit {tol})")
    return ratio


def compare_bulk(label, a, b, top, bulk, frac=0.99):
    """compare() with ``top`` for every entry, and at least ``frac`` of the
    entries within ``bulk`` of max|b|."""
    ratio = compare(label, a, b, top)
    share = float(((a - b).abs() <= bulk * b.abs().max()).float().mean())
    if not share >= frac:
        raise AssertionError(f"{label}: {share:.4f} of the entries within "
                             f"{bulk} of its largest value (limit {frac})")
    return ratio


def train_parity():
    """One train step of a tiny configuration (L = 4, T = 2^12, NRand 256,
    8 samples, the two-class budget, the full refresh of step 0, density
    noise and cone scatter on) on the card and on the CPU, from the same
    seeded state; one CPU generator gives both runs the same draws. The MLP
    runs in f32 so that the comparison sees the kernels and the step, not
    bf16 rounding. Tolerances: the loss to 1e-4 of itself; gradients and
    first moments to 1e-3 of each tensor's largest (K3 and the card's
    matrix products sum in other orders than the CPU); second moments to
    2e-3;
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


PRESETS = ("flagship", "tpu", "hashnerf")
BLUE, RED = (0.2, 0.5, 0.9), (0.9, 0.25, 0.2)    # two of the scene's prims


class Trainer:
    """One training run of a preset on the bench scene from ``seed``: a
    fresh executor and sampler, and the loss of every step it trains
    (device scalars, read only by the caller). ``flagship``: bench.py's
    make_flagship (NRand 4,096 in 8x16 tiles, 64 occupancy-guided samples,
    the 8,100-step schedule); ``tpu`` and ``hashnerf``:
    hashnerf_tpu_preset() and hashnerf_preset() with the README's
    TrainParams(n_iters=2000) (NRand 4,096 random pixels, 64 + 192
    samples); ``lerf``: hashnerf_preset(use_lerf=True) with the same
    TrainParams against ``pyramid`` (its image and language losses are
    recorded too). ``p`` and ``tp`` replace the preset's parameters;
    ``mesh`` (parallel/mesh.py) trains data-parallel."""

    def __init__(self, scene, dev, seed, preset="flagship", pyramid=None,
                 p=None, tp=None, mesh=None):
        import torch
        from nerfpp_tpu_torch.config import (TrainParams,
                                             hashnerf_blocked_preset,
                                             hashnerf_preset,
                                             hashnerf_tpu_preset)
        from nerfpp_tpu_torch.data.dataset import RayBatchSampler
        from nerfpp_tpu_torch.executor import NeRFExecutor
        self.tmp = tempfile.TemporaryDirectory()
        common = dict(n_samples=64, n_rand=4096, chunk=4096, i_img=0,
                      i_print=32, i_weights=0, i_testset=0,
                      base_dir=self.tmp.name)
        tiles = {}
        if preset == "flagship":
            p = p or hashnerf_blocked_preset(n_importance=0,
                                             use_occupancy_grid=True,
                                             occ_update_every=32)
            self.tp = TrainParams(n_iters=8100, steps_per_call=25, **common)
            tiles = dict(tile_h=8, tile_w=16)
        elif preset == "lerf":
            p = p or hashnerf_preset(use_lerf=True)
            self.tp = tp or TrainParams(n_iters=2000, **common)
        else:
            p = (hashnerf_tpu_preset if preset == "tpu"
                 else hashnerf_preset)()
            self.tp = TrainParams(n_iters=2000, **common)
        self.scene, self.seed, self.preset = scene, seed, preset
        self.mesh = mesh
        ex = NeRFExecutor(p, device=dev)
        ex.white_bkgr = scene.white_bkgr
        ex.initialize(scene.bounding_box, self.tp.lrate_decay, seed=seed)
        self.sampler = RayBatchSampler.from_scene(scene, self.tp.n_rand,
                                                  device=dev, pyramid=pyramid,
                                                  **tiles)
        self.losses, self.curve, self.parts = [], [], []
        build = ex._build_train_step

        def recording(tp, *mesh):
            step = build(tp, *mesh)

            def run_step(*args, **kwargs):
                m = step(*args, **kwargs)
                self.losses.append(m["loss"].detach().reshape(1))
                if "lang_loss" in m:
                    self.parts.append(torch.stack([m["img_loss"],
                                                   m["lang_loss"]]))
                return m
            return run_step
        # the collapse recovery rebuilds the step through this attribute too
        ex._build_train_step = recording
        self.ex = ex
        self.sync = torch.cuda.synchronize

    def run(self, n, profile_dir=None):
        """Train the next n steps (``profile_dir``: train's trace of steps
        start + 9 to start + 20); returns their wall time (s)."""
        self.sync()
        t = time.perf_counter()
        self.ex.train(self.scene, self.tp, seed=self.seed,
                      sampler=self.sampler, steps=n, mesh=self.mesh,
                      progress_fn=lambda i, m: self.curve.append(
                          (i, m["loss"], m["psnr"])),
                      profile_dir=profile_dir)
        self.sync()
        return time.perf_counter() - t

    def loss_bits(self):
        """The losses so far as int32 bit patterns (bitwise comparison)."""
        import torch
        return torch.cat(self.losses).view(torch.int32).cpu()

    def held_out_psnr(self):
        """PSNR of the 800x800 test view: for the flagship unbudgeted at 64
        samples, as bench.py renders it for its quality numbers; for the
        hierarchical presets at TrainParams() (64 + 192 samples, chunk
        32,768), as phase 12 serves it."""
        from nerfpp_tpu_torch.config import TrainParams
        ex, scene = self.ex, self.scene
        view = scene.views[list(scene.split_indices("test"))[0]]
        if self.preset != "flagship":
            out = ex.render_view(view.pose, view.h, view.w, view.k,
                                 TrainParams())
            return psnr_of(out["nerf"].rgb.cpu().numpy(),
                           scene.images[view.id]), view.id
        budget = ex.params.render_dense_frac
        ex.params.render_dense_frac = 0.0
        out = ex.render_view(view.pose, view.h, view.w, view.k,
                             TrainParams(n_samples=64, chunk=65536))
        ex.params.render_dense_frac = budget
        return psnr_of(out["nerf"].rgb.cpu().numpy(),
                       scene.images[view.id]), view.id


def train_phase(scene, dev, seed=SEED, observe=None, record=None):
    """The flagship train run, steps 0-2,099. Returns the launch counts,
    the held-out PSNRs after 1,088 and 2,100 steps and the list of failed
    checks (empty when it passed). ``observe(run)`` is called after step 64
    (the table then is the 65-step state). ``record`` (a dict): the run
    saves its state at step DP_FIRST as a checkpoint under
    record["state_dir"] and leaves the losses of steps DP_FIRST to
    DP_FIRST + 63 under "losses" and the ms per step of steps 33-64 under
    "early_ms" (phase 18 reads them)."""
    import torch
    from nerfpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    f = Trainer(scene, dev, seed)
    ex, tp, run, curve = f.ex, f.tp, f.run, f.curve

    def per_step(a, b, n):
        return {k: (b[k] - a[k]) / n for k in TRAIN_KERNELS}

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    run(33)                                   # steps 0-32
    c0 = launch_counts()
    early_s = run(32)                         # steps 33-64: one full refresh
    c1 = launch_counts()
    if observe is not None:
        observe(f)
    if record is None:
        run(1056 - 65)                        # steps 65-1055: warmups end
    else:
        run(DP_FIRST - 65)
        ex.save_checkpoint(record["state_dir"])
        run(1056 - DP_FIRST)
        record["losses"] = torch.cat(
            f.losses[DP_FIRST:DP_FIRST + DP_STEPS]).cpu()
        record["early_ms"] = early_s / 32 * 1e3
    c2 = launch_counts()
    late_s = run(32)                          # steps 1056-1087: one phased
    c3 = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    psnr_1088, view_id = f.held_out_psnr()    # outside the counts and peak
    c4 = launch_counts()
    torch.cuda.reset_peak_memory_stats()
    run(2100 - 1088)                          # steps 1088-2099
    counts = {k: v + launch_counts()[k] - c4[k] for k, v in c3.items()}
    peak = max(peak, torch.cuda.max_memory_allocated())
    f.tmp.cleanup()
    failed = [f"{name} was not launched on the training path"
              for name in TRAIN_KERNELS if counts[name] == 0]
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
        failed.append(f"training loss did not fall: mean of the first four "
                      f"readings {first}, last four {last}")
    psnr, _ = f.held_out_psnr()
    log("train", f"loss mean {first:.5f} (first four readings) -> "
        f"{last:.5f} (last four); held-out PSNR {psnr_1088:.2f} dB after "
        f"1088 steps, {psnr:.2f} dB after {ex.step} steps (test view "
        f"{view_id}, 800x800, unbudgeted)")
    if not psnr > 20.0:
        failed.append(f"held-out PSNR {psnr:.2f} dB <= 20 dB")
    return counts, (psnr_1088, psnr), failed


def state_of(ex):
    """Copies of the parameters, Adam's moments and step count, and the
    occupancy grid (where the preset has one) of an executor."""
    st = {f"param {k}": v.detach().clone()
          for k, v in ex.named_parameters().items()}
    st.update({f"mu {k}": v.clone() for k, v in ex.optimizer.mu.items()})
    st.update({f"nu {k}": v.clone() for k, v in ex.optimizer.nu.items()})
    st["adam count"] = ex.optimizer.count.clone()
    if ex.occupancy is not None:
        st["occupancy"] = ex.occupancy.density.clone()
    return st


def first_difference(a, b):
    """The first index at which two int32 bit-pattern vectors differ, or
    None."""
    import torch
    n = min(a.numel(), b.numel())
    diff = torch.nonzero(a[:n] != b[:n]).flatten()
    if diff.numel():
        return int(diff[0])
    return None if a.numel() == b.numel() else n


def determinism_phase(scene, dev, preset="flagship", steps=64,
                      pyramid=None):
    """A preset (Trainer) trained twice from seed 0 for ``steps`` steps,
    each run with a fresh executor and sampler: the losses must be bitwise
    equal at every step, and the parameters, Adam state and occupancy grid
    bitwise equal after the last step. Names the first differing step and
    the tensors that differ. Returns the first run's loss bits and state
    (on the host)."""
    import torch
    runs = []
    for _ in range(2):
        f = Trainer(scene, dev, SEED, preset, pyramid)
        f.run(steps)
        runs.append((f.loss_bits(), state_of(f.ex)))
        f.tmp.cleanup()
        del f
    (la, sa), (lb, sb) = runs
    step = first_difference(la, lb)
    bad = [k for k in sa if not torch.equal(sa[k], sb[k])]
    if step is not None or bad:
        raise AssertionError(f"determinism ({preset}): the losses of two "
                             f"seed-{SEED} runs first differ at step {step}; "
                             f"after {steps} steps they differ in "
                             f"{', '.join(bad) or 'no tensor'}")
    log("determinism", f"{preset}: two seed-{SEED} runs of {steps} steps: "
        f"losses bitwise equal at every step ({la.numel()} steps), "
        f"parameters, Adam state"
        + (" and occupancy grid" if "occupancy" in sa else "")
        + f" bitwise equal ({len(sa)} tensors)")
    return la, {k: v.cpu() for k, v in sa.items()}


def hier_run(scene, dev, seed, preset, observe):
    """Phase 11's training run of a hierarchical preset (steps 0-1,998 of
    the README's TrainParams(n_iters=2000)), ``observe(run)`` after step
    64. Returns the run, its held-out PSNR and the failed checks."""
    f = Trainer(scene, dev, seed, preset)
    f.run(65)
    observe(f)
    f.run(f.tp.n_iters - 1 - 65)
    first = statistics.mean(l for _, l, _ in f.curve[:4])
    last = statistics.mean(l for _, l, _ in f.curve[-4:])
    failed = [] if math.isfinite(last) and last < 0.5 * first else [
        f"training loss did not fall: mean of the first four readings "
        f"{first}, last four {last}"]
    psnr, _ = f.held_out_psnr()
    f.tmp.cleanup()
    return f, psnr, failed


def repeat_train(scene, dev, k, seed, preset="flagship"):
    """The experiment of ``--repeat-train K``: a preset's training K times
    from one seed, each with a fresh executor and sampler (the flagship:
    phase 8; ``tpu`` and ``hashnerf``: hier_run); per run its held-out
    PSNRs, the first step whose loss differs bitwise from run 1's and the
    largest |table - run 1's table| after step 64. Raises after the last
    run if a run failed its checks."""
    import torch
    ref, failures, rows = {}, [], []
    for r in range(k):
        seen = {}

        def observe(f):
            seen["run"] = f
            table = f.ex.embedder.table.detach()
            if r == 0:
                ref["table"] = table.clone()
            seen["dtable"] = float((table - ref["table"]).abs().max())

        if preset == "flagship":
            _, (p1088, p2100), failed = train_phase(scene, dev, seed,
                                                    observe)
            psnrs = dict(psnr_1088=p1088, psnr_2100=p2100)
        else:
            _, psnr, failed = hier_run(scene, dev, seed, preset, observe)
            psnrs = dict(psnr_1999=psnr)
        bits = seen.pop("run").loss_bits()
        if r == 0:
            ref["bits"] = bits
        step = first_difference(bits, ref["bits"])
        rows.append(dict(run=r + 1, preset=preset, seed=seed, **psnrs,
                         first_differing_step=step,
                         max_abs_dtable_after_step_64=seen["dtable"],
                         steps=bits.numel()))
        log("repeat", json.dumps(rows[-1]))
        failures += [f"run {r + 1}: {m}" for m in failed]
        torch.cuda.empty_cache()
    log("repeat", f"{preset}, seed {seed}, {k} runs: held-out PSNR "
        + "; ".join(f"after {key[5:]} steps "
                    + ", ".join(f"{row[key]:.2f}" for row in rows) + " dB"
                    for key in rows[0] if key.startswith("psnr_"))
        + "; first step whose loss differs from run 1's: "
        + ", ".join(str(row["first_differing_step"]) for row in rows[1:]))
    if failures:
        raise AssertionError("; ".join(failures))


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


def small_kernel_phase(enc, table, pts, label, f32_figures=False):
    """encode_small against its plain version in every mode on one point
    set (packed and f32 table through v2, and the v1 route); the times,
    bound and plain time of the path's mode (packed). ``f32_figures``: also
    the f32 table's (K5's) bound, plain time and embedding_bag time."""
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
    if f32_figures:
        # K5 reads the f32 table: 8 B an entry
        plain32 = cuda_ms(lambda: KS.encode_small_plain(table, pts, enc,
                                                        False),
                          reps=3, inner=1, warmup=1)
        lib32, err32 = embedding_bag_ms(
            enc, table, pts, KS.encode_small_plain(table, pts, enc, False))
        bytes32 = nbytes + enc.table_rows * 4
        t32 = bytes32 / HBM_BYTES_PER_S * 1e3
        log("small", f"{label} encode_small {enc.scheme} f32 table (K5): "
            f"ms={ms_f32:.4f} plain_ms={plain32:.4f} embedding_bag_ms="
            f"{lib32:.4f} (max |err| {err32:.3g}) bound_ms="
            f"{max(t32, t_ops):.4f} (bytes {bytes32} -> {t32:.4f} ms)")
    return dict(ms=ms, ms_f32=ms_f32, plain_ms=plain,
                max_abs_err=max(errs.values()), bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=lib_ms)


def small_grad_phase(enc, pts, label):
    """grad_small against its plain version on one point set, beside one
    PyTorch call (index_add_ of the precomputed corner products); two
    launches bitwise equal."""
    import torch
    from nerfpp_tpu_torch.encoders.hashgrid import trilerp_weights
    from nerfpp_tpu_torch.kernels import hash_encode as KS
    from nerfpp_tpu_torch.kernels import hash_encode_large as KL
    n, nl = pts.shape[0], enc.n_levels
    gen = torch.Generator().manual_seed(SEED + 5)
    g = torch.randn(n, 2 * nl, generator=gen).to(pts.device)
    out = KS.grad_small(g, pts, enc)
    again = KS.grad_small(g, pts, enc)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{label} {enc.scheme}: two grad_small launches "
                             "on the same inputs differ")
    del again
    out_p = KS.grad_small_plain(g, pts, enc)
    # the kernel and index_add_ add each entry's terms in other orders: hold
    # each entry against the sum of its terms' magnitudes, sum |w * g|
    # (w >= 0)
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
        f"max_abs_err={err:.3g} max_err/sum|w*g|={rel:.3g}; two launches "
        f"bitwise equal; its bin pass alone "
        f"{cuda_ms(lambda: KL.grad_large_bins(pts, enc)):.4f} ms")
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
        s = small_kernel_phase(enc, table, pts, "serving chunk",
                               f32_figures=scheme == "random")
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


def step_parity(label, p, tp, kernels, pyramid_of=None):
    """One tiny train step on the card and on the CPU from the same seeded
    state; one CPU generator gives both runs the same draws. ``kernels``
    must launch on the card (with none, no kernel may launch). The loss to
    1e-4 of itself, gradients and first moments to 1e-3 of each tensor's
    largest (the card's kernels and matrix products sum in other orders),
    second moments to 2e-3. ``pyramid_of(scene, device)``: the LeRF
    supervision; a LeRF step holds 99 % of each gradient and moment to
    those limits and every entry to ten times them, because its two
    importance passes move depths in near-empty bins with the rounding of
    the weights (2 ulps of them move the table gradients by up to 4.7e-3 of
    their largest on the CPU alone). Returns the two stepped executors."""
    import torch
    from nerfpp_tpu_torch.data.dataset import RayBatchSampler
    from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
    from nerfpp_tpu_torch.executor import NeRFExecutor
    from nerfpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    scene = make_synthetic_scene(n_train=2, n_val=1, n_test=1, image_hw=32,
                                 n_samples=32, white_bkgr=False, device="cpu")
    runs, exs = {}, {}
    for name in ("cuda", "cpu"):
        ex = exs[name] = NeRFExecutor(p, device=name)
        ex.white_bkgr = scene.white_bkgr
        ex.initialize(scene.bounding_box, tp.lrate_decay, seed=SEED)
        sampler = RayBatchSampler.from_scene(
            scene, tp.n_rand, device=name,
            pyramid=pyramid_of(scene, name) if pyramid_of else None)
        reset_launch_counts()
        m = ex._build_train_step(tp)(
            0, sampler, torch.Generator().manual_seed(SEED + 7))
        counts = launch_counts()
        if name == "cuda" and (0 in [counts[k] for k in kernels] or (
                not kernels and any(counts.values()))):
            raise AssertionError(f"{label}: launches on the card {counts}, "
                                 f"expected {list(kernels) or 'none'}")
        run = {"loss": m["loss"].cpu().reshape(1)}
        if "lang_loss" in m:
            run["loss lang"] = m["lang_loss"].cpu().reshape(1)
        for k, v in ex.named_parameters().items():
            run[f"grad {k}"] = v.grad.cpu()
            run[f"mu {k}"] = ex.optimizer.mu[k].cpu()
            run[f"nu {k}"] = ex.optimizer.nu[k].cpu()
        runs[name] = run
    worst = {}
    for key, a in runs["cuda"].items():
        kind = key.split(" ")[0]
        tol = {"loss": 1e-4, "grad": 1e-3, "mu": 1e-3, "nu": 2e-3}[kind]
        if pyramid_of is not None and kind != "loss":
            r = compare_bulk(f"{label}: {key}", a, runs["cpu"][key],
                             10 * tol, tol)
        else:
            r = compare(f"{label}: {key}", a, runs["cpu"][key], tol)
        worst[kind] = max(worst.get(kind, 0.0), r)
    log(label, f"train step loss gpu {float(runs['cuda']['loss']):.6f} cpu "
        f"{float(runs['cpu']['loss']):.6f}; worst |gpu - cpu| / max|cpu|: "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    return exs


def hier_parity():
    """Phase 10: one tiny hier-budget train step of hashnerf_tpu_preset()
    (L = 4, T = 2^12, NRand 512, 8 + 16 samples, sparse class 4, the
    preconditioning noise and cone scatter on), GPU against CPU."""
    from nerfpp_tpu_torch.config import TrainParams, hashnerf_tpu_preset
    p = hashnerf_tpu_preset(n_levels=4, log2_hashmap_size=12,
                            n_importance=16, hier_sparse_importance=4,
                            compute_dtype="float32")
    step_parity("hier-parity", p,
                TrainParams(n_samples=8, n_rand=512, chunk=512, n_iters=100),
                HIER_KERNELS)


def hier_phase(scene, dev, t_start):
    """Phases 11 and 12: the README's training run of hashnerf_tpu_preset()
    on the bench scene, then serving of the trained state. Returns the
    launch counts of both runs."""
    import torch
    from nerfpp_tpu_torch.config import TrainParams
    from nerfpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    # the README's run (i_img 0: no images written)
    f = Trainer(scene, dev, SEED, "tpu")
    ex, tp, run, curve, p = f.ex, f.tp, f.run, f.curve, f.ex.params
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
    f.tmp.cleanup()
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
    def view_psnr(v, out):
        return psnr_of(out["nerf"].rgb.cpu().numpy(), scene.images[v.id])

    psnr = view_psnr(view, out)
    train_view = scene.views[list(scene.split_indices("train"))[0]]
    psnr_train = view_psnr(train_view, ex.render_view(
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


def large_encoder(scheme, dev):
    """hashnerf_preset()'s encoder: 16 levels x 2^19 f32 entries, base 16
    -> finest 1024, the large-table kernels (use_pallas_encoder=False)."""
    from nerfpp_tpu_torch.encoders.hashgrid import HashGridEncoder
    return HashGridEncoder(BBOX, 16, 2, 19, 16, 1024, scheme=scheme,
                           use_kernel=False, device=dev)


def touched_sectors(enc, pts):
    """Distinct 32-byte sectors (4 entries of 8 B) of the f32 table that
    the points' corners touch: what a launch must read (or write) of it."""
    import torch
    seen = torch.zeros(enc.table_rows // 4, dtype=torch.bool,
                       device=pts.device)
    for i in range(0, pts.shape[0], 1 << 20):
        idx, _ = enc.corner_indices(pts[i:i + (1 << 20)])
        seen[idx.reshape(-1) >> 2] = True
        del idx
    return int(seen.sum())


def large_bound(enc, pts, ops_per):
    """(bound ms, bound_by, bytes, touched sectors) of a large-table kernel:
    12 B of coordinates and 8L B of features or cotangent a point, the
    touched 32-byte sectors of the table (at most the whole table), the
    level constants; ``ops_per`` operations a (point, level)."""
    n, nl = pts.shape[0], enc.n_levels
    sectors = touched_sectors(enc, pts)
    nbytes = n * 12 + n * 8 * nl + sectors * 32 + nl * 24
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_per * n * nl / NONTENSOR_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, sectors)


def large_kernel_phase(enc, table, pts, label):
    """encode_large against its plain version on one point set, beside one
    embedding_bag over the precomputed corner indices and weights."""
    import torch
    from nerfpp_tpu_torch.kernels import hash_encode_large as KL
    n = pts.shape[0]
    out = KL.encode_large(table, pts, enc)
    torch.cuda.synchronize()
    ref = KL.encode_large_plain(table, pts, enc)
    # f32 weights on both sides, |table| <= 1: only the order of the eight
    # corner products (and fused multiply-adds) differs
    err = float((out - ref).abs().max())
    if not (err <= 1e-6 and bool(torch.isfinite(out).all())):
        raise AssertionError(f"{label} {enc.scheme}: encode_large max |err| "
                             f"{err} > 1e-6")
    del out
    ms = cuda_ms(lambda: KL.encode_large(table, pts, enc))
    plain = cuda_ms(lambda: KL.encode_large_plain(table, pts, enc), reps=3,
                    inner=1, warmup=1)
    lib_ms, lib_err = embedding_bag_ms(enc, table, pts, ref)
    del ref
    # ~100 operations a (point, level): cell, 8 hashes, 8 weights, 16 FMAs
    bound, by, nbytes, sectors = large_bound(enc, pts, 100.0)
    log("large", f"{label} encode_large {enc.scheme}: N={n} ms={ms:.4f} "
        f"plain_ms={plain:.4f} embedding_bag_ms={lib_ms:.4f} (excluding "
        f"the index computation; max |err| {lib_err:.3g}) bound_ms="
        f"{bound:.4f} ({by}; bytes {nbytes}, touched sectors {sectors} of "
        f"{enc.table_rows // 4}) max_abs_err={err:.3g}")
    return dict(ms=ms, plain_ms=plain, max_abs_err=err, bound_ms=bound,
                bound_by=by, library_ms=lib_ms)


def warp_lines(enc, pts, n_max=1 << 21):
    """Mean distinct 128-byte lines of the f32 table that one warp's gather
    of one corner touches, over the first n_max points: in encode_large's
    former layout (a thread a (point, level), a point's levels on
    consecutive threads) and in its level-major one (32 consecutive points
    of one level), from the corner indices."""
    import torch
    n, nl = min(pts.shape[0], n_max) // 32 * 32, enc.n_levels

    def distinct(lines):                        # [warps, 32, 8]
        s = torch.sort(lines, dim=1).values
        return (1 + (s[:, 1:] != s[:, :-1]).sum(1)).float().sum()

    old = new = 0.0
    for i in range(0, n, 1 << 16):
        idx, _ = enc.corner_indices(pts[i:min(i + (1 << 16), n)])
        line = idx >> 4                         # 16 entries of 8 B a line
        old += float(distinct(line.reshape(-1, 32, 8)))
        new += float(distinct(line.transpose(0, 1).reshape(-1, 32, 8)))
        del idx, line
    loads = n * nl / 32 * 8
    return old / loads, new / loads


def large_grad_phase(enc, pts, label):
    """grad_large (its bin pass and owner pass) against its plain version
    on one point set, beside one index_add_ of the precomputed corner
    products: two launches bitwise equal, the bin pass exactly its plain
    version. Returns the stats of grad_large (bin pass included) and of
    the bin pass."""
    import torch
    from nerfpp_tpu_torch.encoders.hashgrid import trilerp_weights
    from nerfpp_tpu_torch.kernels import hash_encode_large as KL
    n, nl = pts.shape[0], enc.n_levels
    gen = torch.Generator().manual_seed(SEED + 13)
    g = torch.randn(n, 2 * nl, generator=gen).to(pts.device)
    out = KL.grad_large(g, pts, enc)
    again = KL.grad_large(g, pts, enc)
    recs, offs, plan = KL.grad_large_bins(pts, enc)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{label} {enc.scheme}: two grad_large launches "
                             "on the same inputs differ")
    del again
    recs_p, offs_p, plan_p = KL.grad_large_bins_plain(pts, enc)
    _, nb, _, part, nt, _ = KL.bins_shape(n, enc)
    n_items, n_slots = int(plan_p[0]), int(plan_p[1])
    head = 4 + 4 * nl * nb + 2 * n_items
    # the records, run offsets and plan head against the plain version's:
    # the largest absolute difference of any of them, which must be 0
    bins_err = max(float((a.long() - b.long()).abs().max())
                   for a, b in ((recs, recs_p), (offs, offs_p),
                                (plan[:head], plan_p[:head])))
    if bins_err != 0:
        raise AssertionError(f"{label} {enc.scheme}: grad_large_bins differs "
                             f"from its plain version by {bins_err}")
    most = int(plan_p[4:4 + nl * nb].max())
    del recs, offs, plan, recs_p, offs_p
    out_p = KL.grad_large_plain(g, pts, enc)
    # the kernel and index_add_ add each entry's terms in other orders: hold
    # each entry against the sum of its terms' magnitudes, sum |w * g|
    # (w >= 0); where no term falls, exactly zero
    mag = KL.grad_large_plain(g.abs(), pts, enc)
    diff = (out - out_p).abs()
    err = float(diff.max())
    rel = float((diff / mag.clamp(min=1e-30)).max())
    zeros = not bool(out[mag == 0].any())
    if not (rel <= 1e-5 and zeros and bool(torch.isfinite(out).all())):
        raise AssertionError(f"{label} {enc.scheme}: grad_large max |err| "
                             f"{err}, max |err| / sum|w*g| {rel} > 1e-5, or an "
                             f"entry with no term not zero ({zeros})")
    del out, out_p, mag, diff
    ms = cuda_ms(lambda: KL.grad_large(g, pts, enc))
    bins_ms = cuda_ms(lambda: KL.grad_large_bins(pts, enc))
    plain = cuda_ms(lambda: KL.grad_large_plain(g, pts, enc), reps=3,
                    inner=1, warmup=1)
    bins_plain = cuda_ms(lambda: KL.grad_large_bins_plain(pts, enc), reps=3,
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
    # ~60 operations a (point, level): cell, 8 hashes, 8 weights, 16
    # products; the gradient's touched sectors written
    bound, by, nbytes, sectors = large_bound(enc, pts, 60.0)
    # the bin pass: coordinates read, a 4-byte record a (point, level,
    # corner), the run offsets and the plan written; ~60 operations a
    # (point, level): cell, 8 hashes and bins
    b_bytes = (n * 12 + 32 * n * nl + 4 * nl * nb * nt + 4 * head
               + nl * 24)
    b_bound = max(b_bytes / HBM_BYTES_PER_S * 1e3,
                  60.0 * n * nl / NONTENSOR_OPS_PER_S * 1e3)
    b_by = ("bytes" if b_bytes / HBM_BYTES_PER_S
            >= 60.0 * n * nl / NONTENSOR_OPS_PER_S else "operations")
    log("large", f"{label} grad_large {enc.scheme}: N={n} ms={ms:.4f} (bin "
        f"pass included) plain_ms={plain:.4f} index_add_ms={lib_ms:.4f} "
        f"(excluding the index computation) bound_ms={bound:.4f} ({by}; "
        f"bytes {nbytes}, touched sectors {sectors}) max_abs_err={err:.3g} "
        f"max_err/sum|w*g|={rel:.3g}; two launches bitwise equal")
    log("large", f"{label} grad_large_bins {enc.scheme}: ms={bins_ms:.4f} "
        f"plain_ms={bins_plain:.4f} bound_ms={b_bound:.4f} ({b_by}; bytes "
        f"{b_bytes}); max |err| of records, offsets and plan {bins_err}; "
        f"{nb} bins a level, {nt} tiles, {n_items} parts "
        f"of at most {part} records, {n_slots} of them partial sums; the "
        f"most records in one bin {most}")
    return {"grad_large": dict(ms=ms, plain_ms=plain, max_abs_err=err,
                               bound_ms=bound, bound_by=by,
                               library_ms=lib_ms),
            "grad_large_bins": dict(ms=bins_ms, plain_ms=bins_plain,
                                    max_abs_err=bins_err, bound_ms=b_bound,
                                    bound_by=b_by, library_ms=None)}


def large_phase(dev):
    """Phase 13: the large-table kernels against their plain versions at
    hashnerf_preset()'s table (16 x 2^19 f32), both schemes: a serving
    chunk's fine pass (32,768 rays x 256 depths), a train step's coarse
    pass (4,096 random pixels x 64) and dense fine class (1,024 x 256),
    and 2^20 random points. Returns the stats of the serving chunk
    (encode_large) and of the dense fine class (grad_large and its bin
    pass), random scheme."""
    import torch
    gen = torch.Generator().manual_seed(SEED + 11)
    stats = {}
    ro, rd = view_rays(32768, dev)
    cro, crd = view_rays(4096, dev, seed=SEED + 2)
    for scheme in ("random", "fixed"):
        enc = large_encoder(scheme, dev)
        table = (torch.rand(enc.table_rows, 2, generator=gen) * 2
                 - 1).to(dev)
        pts = depth_points(enc, ro, rd, 256)
        s = large_kernel_phase(enc, table, pts, "serving chunk")
        old, new = warp_lines(enc, pts)
        log("large", f"serving chunk {scheme}: mean distinct 128-byte table "
            f"lines a warp's gather touches (first 2^21 points): {old:.3f} "
            f"a thread a (point, level), {new:.3f} level-major")
        if scheme == "random":
            stats["encode_large"] = s
        del pts
        dense = depth_points(enc, cro[:1024], crd[:1024], 256)
        s = large_grad_phase(enc, dense, "dense fine class")
        if scheme == "random":
            stats.update(s)
            large_kernel_phase(enc, table, dense, "dense fine class")
            coarse = depth_points(enc, cro, crd, 64)
            large_kernel_phase(enc, table, coarse, "train coarse")
            large_grad_phase(enc, coarse, "train coarse")
            del coarse
        del dense
        rnd = (torch.rand(1 << 20, 3, generator=gen) * 2.4 - 1.2).to(dev)
        large_kernel_phase(enc, table, rnd, "random points")
        large_grad_phase(enc, rnd, "random points")
        del rnd, table
    torch.cuda.empty_cache()
    return stats


def psnr_of(a, b):
    """PSNR of the image a (clipped to [0, 1]) against b."""
    import numpy as np
    mse = float(np.mean((np.clip(a, 0.0, 1.0) - b) ** 2))
    return -10.0 * math.log10(max(mse, 1e-10))


def cli_phase(scene, dev):
    """Phase 14, after a tiny hashnerf_preset() train step GPU against CPU
    and its determinism check (two 64-step runs from seed 0 on the bench
    scene bitwise equal): the README's command line in-process. The bench scene is exported as a
    Blender tree; ``cli train --preset hashnerf --set-train NIters=2000``
    (TrainParams() otherwise: NRand 4,096, 64 + 192 samples, validation
    images every 500 steps), steps 1,024-1,055 timed; ``cli render`` of the
    test split, read back with the port's PNG reader (held-out PSNR); ``cli
    render --spherical-path --n-poses 2``; then 1 + 3 800x800 frames of
    the trained state at TrainParams(). Returns the launch counts of the
    training and the frames."""
    import numpy as np
    import torch
    from nerfpp_tpu_torch import cli
    from nerfpp_tpu_torch.config import TrainParams, hashnerf_preset
    from nerfpp_tpu_torch.data.blender import (export_blender_scene,
                                               load_blender_data)
    from nerfpp_tpu_torch.data.dataset import load_images
    from nerfpp_tpu_torch.executor import NeRFExecutor
    from nerfpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    from nerfpp_tpu_torch.utils.png import read_png
    step_parity("large-parity", hashnerf_preset(
        n_levels=4, log2_hashmap_size=12, n_importance=16,
        hier_sparse_importance=4, compute_dtype="float32"),
        TrainParams(n_samples=8, n_rand=512, chunk=512, n_iters=100),
        LARGE_KERNELS)
    determinism_phase(scene, dev, "hashnerf")
    tmp = tempfile.TemporaryDirectory()
    data, out = Path(tmp.name) / "blender", Path(tmp.name) / "out"
    t0 = time.perf_counter()
    export_blender_scene(scene, data)
    log("cli", f"bench scene exported as a Blender tree (16 + 1 + 1 "
        f"800x800 PNGs) in {time.perf_counter() - t0:.2f} s")
    common = ["--dataset-type", "blender", "--data-dir", str(data),
              "--preset", "hashnerf", "--base-dir", str(out)]
    # every loss recorded, steps 1,024 and 1,056 marked (synchronised)
    run = CliTrain(["train", *common, "--set-train", "NIters=2000"],
                   window=(1024, 1056))
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    train_s = run.run()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    loss = run.loss()
    ms, per_step = run.window_ms(LARGE_KERNELS)
    log("cli", f"cli train: {loss.size} steps in {train_s:.1f} s (export "
        f"excluded; validation images at 500, 1000, 1500 included); steps "
        f"1024-1055: {ms:.3f} ms/step, {4096 / (ms / 1e3):.1f} rays/s; "
        f"launches per step "
        + ", ".join(f"{k} {v:.3f}" for k, v in per_step.items()))
    log("cli", f"steps 0-{loss.size - 1}: launches "
        + ", ".join(f"{k} {v}" for k, v in counts.items())
        + f"; peak memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    first, last = float(loss[:32].mean()), float(loss[-32:].mean())
    log("cli", "loss every 100 steps: " + " ".join(
        f"({i}, {loss[i]:.5f})" for i in range(0, loss.size, 100)))
    if not (loss.size == 1999 and math.isfinite(last) and last < 0.5 * first):
        raise AssertionError(f"cli train: {loss.size} steps, loss mean "
                             f"{first} (steps 0-31) -> {last} (last 32)")
    for name in LARGE_KERNELS:
        if counts[name] == 0:
            raise AssertionError(f"{name} was not launched by cli train")
    others = {k: v for k, v in counts.items() if k not in LARGE_KERNELS}
    if any(others.values()):
        raise AssertionError(f"cli train launched other kernels: {others}")
    saved = sorted(p.name for p in out.iterdir())
    for name in ("executor_params.json", "executor_train_params.json",
                 "data.json", "metrics.csv", "step_1999"):
        if name not in saved:
            raise AssertionError(f"cli train did not write {name}: {saved}")

    # held-out PSNR through cli render and the PNG reader
    reset_launch_counts()
    cli.main(["render", *common])
    sc = load_blender_data(data, testskip=False)
    test_i = list(sc.split_indices("test"))[0]
    gt = load_images(sc, [test_i])[0]
    pred = read_png(out / "renders" / "0.png").astype(np.float32) / 255.0
    psnr_cli = psnr_of(pred, gt)
    cli.main(["render", *common, "--spherical-path", "--n-poses", "2"])
    for i in range(2):
        for name, shape in ((f"{i}.png", (800, 800, 3)),
                            (f"disp_{i}.png", (800, 800)),
                            (f"depth_{i}.png", (800, 800))):
            img = read_png(out / "renders" / name)
            if img.shape != shape or not img.std() > 0:
                raise AssertionError(f"cli render: {name} has shape "
                                     f"{img.shape}, std {img.std()}")
    render_counts = launch_counts()
    if render_counts["encode_large"] == 0 or any(
            v for k, v in render_counts.items() if k != "encode_large"):
        raise AssertionError(f"cli render launches {render_counts}")
    log("cli", f"cli render: test view {test_i} held-out PSNR {psnr_cli:.2f} "
        f"dB (8-bit PNG against the exported PNG); spherical path, 2 poses: "
        f"rgb, disp and depth PNGs decode, not constant; launches "
        + ", ".join(f"{k} {render_counts[k]}" for k in LARGE_KERNELS))

    # 800x800 frames of the trained state
    ex = NeRFExecutor(hashnerf_preset(ft_path=str(out)), device=dev)
    ex.white_bkgr = sc.white_bkgr
    ex.initialize(sc.bounding_box)
    view = sc.views[test_i]
    serve_tp = TrainParams()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    frame_ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ex.render_view(view.pose, view.h, view.w, view.k,
                             serve_tp)["nerf"]
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    serve = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if (tuple(res.rgb.shape) != (800, 800, 3)
            or not bool(torch.isfinite(res.rgb).all())):
        raise AssertionError("hashnerf 800x800 frame: shape or values")
    if serve["encode_large"] == 0 or any(
            v for k, v in serve.items() if k != "encode_large"):
        raise AssertionError(f"hashnerf frame launches {serve}")
    rgb = res.rgb.cpu().numpy()
    med = statistics.median(frame_ms[1:])
    n_pts = 800 * 800 * (2 * serve_tp.n_samples + ex.n_importance)
    log("cli", f"800x800 frames ms {[round(t, 3) for t in frame_ms]}; "
        f"median {med:.3f} ms/frame, {0.64 / (med / 1e3):.4f} Mpix/s, "
        f"{n_pts / (med / 1e3) / 1e6:.1f} M points/s; chunk "
        f"{serve_tp.chunk} rays; launches per frame: encode_large "
        f"{serve['encode_large'] / 4:.2f}; peak memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB); held-out PSNR {psnr_of(rgb, gt):.2f} dB "
        f"(f32 image)")
    tmp.cleanup()
    return {k: counts[k] + serve[k] for k in LARGE_KERNELS}


def classic_phase(scene, dev):
    """Phase 15: a tiny classic_nerf_preset() train step GPU against CPU
    (8 layers of 32, coarse only), then bench.py:381-395's configuration
    at full width (8 x 256, frequency encodings 10 / 4, 64 + 64 samples,
    trunc_exp, gain 1; NRand 4,096, chunk 4,096) on the bench scene: 1 + 10
    timed steps. No hand-written kernel runs: none may launch."""
    import torch
    from nerfpp_tpu_torch.config import TrainParams, classic_nerf_preset
    from nerfpp_tpu_torch.data.dataset import RayBatchSampler
    from nerfpp_tpu_torch.executor import NeRFExecutor
    from nerfpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    step_parity("classic-parity", classic_nerf_preset(
        net_width=32, compute_dtype="float32", mlp_init_gain=1.0,
        density_activation="trunc_exp"),
        TrainParams(n_samples=8, n_rand=256, chunk=256, n_iters=100), ())
    p = classic_nerf_preset(n_importance=64, density_activation="trunc_exp",
                            mlp_init_gain=1.0)
    tp = TrainParams(n_samples=64, n_rand=4096, n_iters=800, chunk=4096,
                     i_print=0, i_weights=0, i_testset=0)
    ex = NeRFExecutor(p, device=dev)
    ex.white_bkgr = scene.white_bkgr
    ex.initialize(scene.bounding_box, tp.lrate_decay, seed=SEED)
    sampler = RayBatchSampler.from_scene(scene, tp.n_rand, device=dev)
    step = ex._build_train_step(tp)
    gen = torch.Generator(device=dev)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses = []
    for i in range(11):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        gen.manual_seed((SEED + 1) * 1_000_003 + i)
        losses.append(step(i, sampler, gen)["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 10 * 1e3
    peak = torch.cuda.max_memory_allocated()
    loss = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in loss):
        raise AssertionError(f"classic train: losses {loss}")
    if any(launch_counts().values()):
        raise AssertionError(f"classic train launched {launch_counts()}")
    log("classic", f"bench.py's classic configuration: steps 1-10 "
        f"{ms:.3f} ms/step, {tp.n_rand / (ms / 1e3):.1f} rays/s; peak memory "
        f"{peak} bytes ({peak / 2**30:.2f} GiB); losses "
        + " ".join(f"{v:.5f}" for v in loss))


def le_encoder(dev):
    """hashnerf_preset(use_lerf=True)'s language table: 14 levels x 2^16
    f32 entries, base 16 -> finest 128, random primes from seed 1."""
    from nerfpp_tpu_torch.encoders.hashgrid import HashGridEncoder
    return HashGridEncoder(BBOX, 14, 2, 16, 16, 128, scheme="random",
                           primes_seed=1, use_kernel=False, device=dev)


def flat_patches(enc, colours, size):
    """Stand-in embeddings of flat patches of the given colours, as
    bench.py:475-498 makes its prompts."""
    import numpy as np
    return enc(np.stack([np.broadcast_to(np.asarray(c, np.float32),
                                         (size, size, 3)) for c in colours]))


def auc_iou(rel, mask):
    """The relevancy map's localisation of the mask: the Mann-Whitney AUC
    (midranks, so a constant map scores 0.5) and IoU at 0.5, as
    bench.py:516-538 scores them."""
    import numpy as np
    from scipy.stats import rankdata
    r, m = rel.ravel(), mask.ravel()
    ranks = rankdata(r, method="average")
    n_pos, n_neg = int(m.sum()), int((~m).sum())
    auc = ((ranks[m].sum() - n_pos * (n_pos + 1) / 2.0)
           / max(n_pos * n_neg, 1))
    pred = rel > 0.5
    iou = (float(np.logical_and(pred, mask).sum())
           / max(float(np.logical_or(pred, mask).sum()), 1.0))
    return float(auc), iou


def fell(parts, what):
    """Mean of the last 32 steps below the mean of the first 32, for the
    image (column 0) and language (column 1) losses."""
    import torch
    x = torch.stack(parts).cpu()
    out = []
    for col, name in ((0, "image"), (1, "language")):
        first, last = float(x[:32, col].mean()), float(x[-32:, col].mean())
        if not (math.isfinite(last) and last < first):
            raise AssertionError(f"{what}: the {name} loss did not fall "
                                 f"({first} over the first 32 steps, {last} "
                                 f"over the last 32)")
        out.append((first, last))
    return out


def lerf_phase(scene, dev):
    """Phase 16: LeRF, hashnerf_preset(use_lerf=True). (a) a tiny LeRF
    train step GPU against CPU, then a 64x64 LeRF render of the stepped
    state with phase 4's limits; (b) encode_large, grad_large and its bin
    pass at the language table (14 x 2^16) on a step's fine pass (4,096
    random pixels x 256 depths); (c) the stand-in pyramid of the bench
    scene at E = 768 as the CLI builds it, and 512 full-width steps (steps
    449-512 timed); (d) 1 + 2 800x800 frames with relevancy at
    TrainParams(), and render_path's relevancy_0.png; (e) two 32-step
    seed-0 runs bitwise equal; (f) bench.py's LeRF quality configuration
    and its relevancy AUC and IoU. Returns the launch counts of (c) and
    (d)."""
    import numpy as np
    import torch
    from nerfpp_tpu_torch import cli
    from nerfpp_tpu_torch.config import TrainParams, hashnerf_preset
    from nerfpp_tpu_torch.data.pyramid_clip import (
        PyramidEmbedder, PyramidEmbedderProperties, PyramidEmbedding,
        RandomProjectionPatchEncoder, make_device_pyramid)
    from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
    from nerfpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    from nerfpp_tpu_torch.utils.png import read_png
    t_phase = time.perf_counter()

    # (a) a tiny step and a 64x64 render, GPU against CPU
    tiny_enc = RandomProjectionPatchEncoder(embed_dim=32, input_size=8)
    tiny_pyr = {}

    def pyramid_of(sc, name):
        if "emb" not in tiny_pyr:
            tiny_pyr["emb"] = PyramidEmbedder(
                tiny_enc, PyramidEmbedderProperties(img_size=8, overlap=0.5),
                device="cpu")(sc.images[list(sc.split_indices("train"))])
        return make_device_pyramid(tiny_pyr["emb"], 0.5, device=name)

    p = hashnerf_preset(n_levels=4, log2_hashmap_size=12, n_importance=16,
                        hier_sparse_importance=4, compute_dtype="float32",
                        use_lerf=True, lang_embed_dim=32, n_levels_le=6,
                        log2_hashmap_size_le=12, finest_resolution_le=64)
    exs = step_parity("lerf-parity", p, TrainParams(
        n_samples=8, n_rand=512, chunk=512, n_iters=100), LARGE_KERNELS,
        pyramid_of)
    p.thin_ray = True               # no cone scatter: no draws in the render
    k64, pose = camera(64)
    prompts = flat_patches(tiny_enc, (BLUE, RED, (0, 0, 0)), 8)
    outs = {}
    for name, ex in exs.items():
        ex.set_lerf_prompts(prompts[:1], prompts[1:])
        outs[name] = ex.render_view(pose, 64, 64, k64,
                                    TrainParams(n_samples=16))["lerf"]
    for f in ("rendered_lang_embedding", "acc", "depth", "relevancy"):
        a, b = getattr(outs["cuda"], f).cpu(), getattr(outs["cpu"], f)
        diff = (a - b).abs()
        p99, mx = float(torch.quantile(diff.flatten(), 0.99)), float(diff.max())
        log("lerf", f"64x64 {f}: max |gpu - cpu| {mx:.3g}, p99 {p99:.3g} "
            f"(limits 2e-3, 1e-2)")
        if not (bool(torch.isfinite(a).all()) and p99 <= 2e-3 and mx <= 1e-2):
            raise AssertionError(f"LeRF 64x64 {f} GPU vs CPU out of tolerance")
    del exs, outs

    # (b) the large-table kernels at the language table
    enc = le_encoder(dev)
    gen = torch.Generator().manual_seed(SEED + 17)
    table = (torch.rand(enc.table_rows, 2, generator=gen) * 2 - 1).to(dev)
    ro, rd = view_rays(4096, dev, seed=SEED + 2)
    pts = depth_points(enc, ro, rd, 256)
    le_stats = {"encode_large": large_kernel_phase(enc, table, pts,
                                                   "LeRF fine pass")}
    le_stats.update(large_grad_phase(enc, pts, "LeRF fine pass"))
    for k, v in le_stats.items():
        log("lerf", f"{k} at the language table (14 x 2^16, random, primes "
            f"seed 1), 4,096 rays x 256: " + json.dumps(v))
    del enc, table, pts, ro, rd
    torch.cuda.empty_cache()

    # (c) the pyramid at E = 768 as cli train builds it, 512 steps
    p = hashnerf_preset(use_lerf=True)
    tmp = tempfile.TemporaryDirectory()
    ptp = TrainParams(base_dir=tmp.name)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pyr, _ = cli._build_lerf_supervision(scene, p, ptp, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cached = PyramidEmbedding.load(Path(tmp.name) / "pyramid_embeddings.npz")
    wins = {z: g.shape[0] * g.shape[1]
            for (i, z), g in cached.grids.items() if i == 0}
    log("lerf", f"stand-in pyramid, E = {p.lang_embed_dim}: "
        f"{len(cached.image_sizes)} views x {sum(wins.values())} windows "
        + ", ".join(f"{n} of {cached.props.img_size * 2.0 ** z:g} px"
                    for z, n in sorted(wins.items()))
        + f", built and cached in {build_s:.2f} s; device grids "
        f"{[tuple(g.shape) for g in pyr.grids]}, blend t {pyr.t}")
    f = Trainer(scene, dev, SEED, "lerf", pyr)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    f.run(448)                                # steps 0-447
    c0 = launch_counts()
    window_s = f.run(64)                      # steps 448-511 (449-512)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    ms = window_s / 64 * 1e3
    (i0, i1), (l0, l1) = fell(f.parts, "LeRF training")
    log("lerf", f"512 steps of hashnerf_preset(use_lerf=True) (NRand 4,096, "
        f"64 + 192 samples, TrainParams(n_iters=2000)); steps 449-512: "
        f"{ms:.3f} ms/step, {4096 / (ms / 1e3):.1f} rays/s; launches per "
        f"step " + ", ".join(f"{k} {(counts[k] - c0[k]) / 64:.3f}"
                             for k in LARGE_KERNELS)
        + f"; steps 1-512: " + ", ".join(f"{k} {counts[k]}"
                                          for k in LARGE_KERNELS)
        + f"; peak memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    log("lerf", f"image loss {i0:.5f} -> {i1:.5f}, language loss {l0:.5f} "
        f"-> {l1:.5f} (means of the first and last 32 steps)")
    for name in LARGE_KERNELS:
        if counts[name] == 0:
            raise AssertionError(f"{name} was not launched by LeRF training")
    others = {k: v for k, v in counts.items() if k not in LARGE_KERNELS}
    if any(others.values()):
        raise AssertionError(f"LeRF training launched other kernels: {others}")

    # (d) serving with relevancy
    ex = f.ex
    stub = RandomProjectionPatchEncoder(embed_dim=p.lang_embed_dim)
    prompts = flat_patches(stub, (BLUE, RED, (0, 0, 0)), 336)
    ex.set_lerf_prompts(prompts[:1], prompts[1:])
    view = scene.views[list(scene.split_indices("test"))[0]]
    serve_tp = TrainParams()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    frame_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ex.render_view(view.pose, view.h, view.w, view.k, serve_tp)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    serve = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rel = out["lerf"].relevancy
    if (tuple(rel.shape) != (view.h, view.w, 1)
            or not bool(torch.isfinite(rel).all())
            or float(rel.min()) < 0 or float(rel.max()) > 1
            or not float(rel.std()) > 0):
        raise AssertionError(f"LeRF 800x800 relevancy: shape "
                             f"{tuple(rel.shape)}, range [{float(rel.min())}, "
                             f"{float(rel.max())}], std {float(rel.std())}")
    if serve["encode_large"] == 0 or any(
            v for k, v in serve.items() if k != "encode_large"):
        raise AssertionError(f"LeRF frame launches {serve}")
    mask = np.linalg.norm(np.asarray(scene.images[view.id])
                          - np.asarray(BLUE, np.float32), axis=-1) < 0.25
    auc, iou = auc_iou(rel[..., 0].cpu().numpy(), mask)
    med = statistics.median(frame_ms[1:])
    log("lerf", f"{view.h}x{view.w} frames (NeRF + LeRF with relevancy, "
        f"TrainParams():"
        f" 64 + 192, chunk 32,768, LeRF parts of "
        f"{ex._lerf_max_rays(ex.make_render_config(serve_tp, False))} rays) "
        f"ms {[round(t, 3) for t in frame_ms]}; median {med:.3f} ms/frame; "
        f"launches per frame: encode_large {serve['encode_large'] / 3:.2f}; "
        f"peak memory {peak} bytes ({peak / 2**30:.2f} GiB); relevancy "
        f"(blue prim against red and black) range [{float(rel.min()):.4f}, "
        f"{float(rel.max()):.4f}], AUC {auc:.4f}, IoU@0.5 {iou:.4f} after "
        f"512 steps (test view {view.id})")
    ex.render_path([view.pose], view.h, view.w, view.k, serve_tp,
                   Path(tmp.name) / "path")
    png = read_png(Path(tmp.name) / "path" / "relevancy_0.png")
    if png.shape != (view.h, view.w, 3) or not png.std() > 0:
        raise AssertionError(f"relevancy_0.png: shape {png.shape}, "
                             f"std {png.std()}")
    log("lerf", f"render_path: relevancy_0.png decodes, {png.shape}, not "
        "constant")
    del f, ex, out, rel
    tmp.cleanup()
    torch.cuda.empty_cache()

    # (e) determinism
    determinism_phase(scene, dev, "lerf", 32, pyr)
    del pyr
    torch.cuda.empty_cache()

    # (f) bench.py's LeRF quality configuration
    t0 = time.perf_counter()
    sc = make_synthetic_scene(n_train=8, n_val=1, n_test=1, image_hw=128,
                              white_bkgr=False, n_samples=64, device=dev)
    enc24 = RandomProjectionPatchEncoder(embed_dim=24, input_size=8)
    emb = PyramidEmbedder(enc24, PyramidEmbedderProperties(
        img_size=16, overlap=0.5, max_zoom_out=1), device=dev)(
        sc.images[list(sc.split_indices("train"))])
    pl = hashnerf_preset(
        n_importance=16, hier_ray_tile=0, hier_tile_budget_frac=0.0,
        log2_hashmap_size=14, n_levels=8, finest_resolution=128,
        use_lerf=True, lang_embed_dim=24, n_levels_le=4,
        log2_hashmap_size_le=12, finest_resolution_le=64)
    qtmp = tempfile.TemporaryDirectory()
    tpl = TrainParams(n_samples=32, n_rand=2048, n_iters=1001, chunk=2048,
                      i_print=0, i_weights=0, i_testset=0, i_img=0,
                      base_dir=qtmp.name, steps_per_call=50)
    q = Trainer(sc, dev, SEED, "lerf", make_device_pyramid(emb, 0.5, dev),
                p=pl, tp=tpl)
    prompts = flat_patches(enc24, (BLUE, RED, (0, 0, 0)), 16)
    q.ex.set_lerf_prompts(prompts[:1], prompts[1:])
    q.run(1000)
    (i0, i1), (l0, l1) = fell(q.parts, "LeRF quality run")
    vl = sc.views[list(sc.split_indices("test"))[0]]
    rel = q.ex.render_view(vl.pose, vl.h, vl.w, vl.k,
                           tpl)["lerf"].relevancy[..., 0].cpu().numpy()
    if not rel.std() > 0:
        raise AssertionError("LeRF quality run: constant relevancy map")
    mask = np.linalg.norm(np.asarray(sc.images[vl.id])
                          - np.asarray(BLUE, np.float32), axis=-1) < 0.25
    auc, iou = auc_iou(rel, mask)
    q.tmp.cleanup()
    qtmp.cleanup()
    log("lerf", f"bench.py's LeRF quality configuration (128 px, 8 views, "
        f"24-d stand-in, 32 + 16 samples, {len(q.losses)} steps): held-out "
        f"relevancy AUC {auc:.4f}, IoU@0.5 {iou:.4f} (mask {int(mask.sum())} "
        f"px; relevancy range [{rel.min():.4f}, {rel.max():.4f}]); image loss"
        f" {i0:.5f} -> {i1:.5f}, language loss {l0:.5f} -> {l1:.5f}; the JAX"
        f" package: AUC 0.411 (BENCH_r04.json, TPU, before the integrator "
        f"fix), 0.988 / IoU 0.855 claimed in VERDICT.md:72 with no record; "
        f"{time.perf_counter() - t0:.1f} s")
    log("lerf", f"phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return {k: counts[k] + serve[k] for k in LARGE_KERNELS}


def flagship_argv(dataset_type, data_dir, out, dev, n_iters=2100, extra=()):
    """``cli train`` of the flagship configuration (phase 17):
    ``--preset hashnerf_blocked`` with the occupancy grid, no importance
    pass, a refresh every 32 steps, NRand 4,096 (8x16 tiles), 64 samples,
    chunk 4,096, NIters ``n_iters``."""
    return ["train", "--device", dev.type, "--dataset-type", dataset_type,
            "--data-dir", str(data_dir), "--preset", "hashnerf_blocked",
            "--set", "use_occupancy_grid=true", "--set", "n_importance=0",
            "--set", "occ_update_every=32", "--set-train", f"NIters={n_iters}",
            "--set-train", "NRand=4096", "--set-train", "NSamples=64",
            "--set-train", "Chunk=4096", "--base-dir", str(out), *extra]


class CliTrain:
    """``cli train`` in-process (phases 14 and 17). It records every step's
    loss, the time and launch counts at the two ``window`` steps
    (synchronised), the executor the CLI trains (for serving it
    afterwards), and each bbox refit's old and new box; the launch counts
    are reset after a refit that fires, so ``after_refit`` holds the
    launches before it."""

    def __init__(self, argv, window=(1056, 1088)):
        self.argv, self.window = list(argv), window
        self.losses, self.marks, self.refits = [], {}, []
        self.ex = None
        self.after_refit = None

    def run(self):
        """Train; returns the wall seconds."""
        import torch
        from nerfpp_tpu_torch import cli
        from nerfpp_tpu_torch.executor import NeRFExecutor
        from nerfpp_tpu_torch.kernels import (launch_counts,
                                              reset_launch_counts)
        build, train = NeRFExecutor._build_train_step, NeRFExecutor.train
        refit = NeRFExecutor.refit_bbox_from_grid

        def recording(ex, tp):
            step = build(ex, tp)

            def run_step(i, *args, **kwargs):
                if i in self.window:
                    torch.cuda.synchronize()
                    self.marks[i] = (time.perf_counter(), launch_counts())
                m = step(i, *args, **kwargs)
                self.losses.append(m["loss"].detach().reshape(1))
                return m
            return run_step

        def training(ex, *args, **kwargs):
            self.ex = ex
            return train(ex, *args, **kwargs)

        def refitting(ex, *args, **kwargs):
            old = ex.bounding_box.copy()
            fired = refit(ex, *args, **kwargs)
            self.refits.append((ex.step, fired, old, ex.bounding_box.copy()))
            if fired:
                self.after_refit = launch_counts()
                reset_launch_counts()
            return fired

        NeRFExecutor._build_train_step = recording
        NeRFExecutor.train = training
        NeRFExecutor.refit_bbox_from_grid = refitting
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cli.main(self.argv)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        finally:
            NeRFExecutor._build_train_step = build
            NeRFExecutor.train = train
            NeRFExecutor.refit_bbox_from_grid = refit

    def loss(self):
        import torch
        return torch.cat(self.losses).cpu().numpy()

    def window_ms(self, kernels=TRAIN_KERNELS):
        """ms/step over the window and the launches per step (nan and none
        where a collapse restart kept the state's step below its end)."""
        if not set(self.window) <= set(self.marks):
            return math.nan, {}
        (ta, ca), (tb, cb) = (self.marks[i] for i in self.window)
        n = self.window[1] - self.window[0]
        return ((tb - ta) / n * 1e3,
                {k: (cb[k] - ca[k]) / n for k in kernels})

    def held_out_psnr(self, scene):
        """PSNR of the bench scene's 800x800 test view rendered by the
        trained executor at its true pose and K, unbudgeted at 64 samples
        (phase 8's reading)."""
        from nerfpp_tpu_torch.config import TrainParams
        ex = self.ex
        view = scene.views[list(scene.split_indices("test"))[0]]
        budget = ex.params.render_dense_frac
        ex.params.render_dense_frac = 0.0
        out = ex.render_view(view.pose, view.h, view.w, view.k,
                             TrainParams(n_samples=64, chunk=65536))
        ex.params.render_dense_frac = budget
        return psnr_of(out["nerf"].rgb.cpu().numpy(), scene.images[view.id])


def same_reconstruction(a, b):
    """The names of the fields in which two COLMAP reconstructions differ
    (exact comparison), or an empty list."""
    import numpy as np
    bad = []
    if sorted(a.cameras) != sorted(b.cameras) or sorted(a.images) != sorted(
            b.images):
        return ["ids"]
    for cid in a.cameras:
        x, y = a.cameras[cid], b.cameras[cid]
        if (x.model, x.width, x.height) != (y.model, y.width, y.height) or (
                not np.array_equal(x.params, y.params)):
            bad.append(f"camera {cid}")
    for iid in a.images:
        x, y = a.images[iid], b.images[iid]
        if (x.camera_id, x.name) != (y.camera_id, y.name) or not all(
                np.array_equal(getattr(x, f), getattr(y, f))
                for f in ("qvec", "tvec", "xys", "point3d_ids")):
            bad.append(f"image {iid}")
    if not (np.array_equal(a.points_xyz, b.points_xyz)
            and np.array_equal(a.points_ids, b.points_ids)):
        bad.append("points")
    return bad


def capture_phase(scene, dev, psnr_direct):
    """Phase 17, real capture: (a) the bench scene exported as a COLMAP
    workspace (scripts/colmap_export.py: 12 train views at 800x800 and 4
    by a second camera at 1000x1000, two distorted OPENCV cameras, surface
    points from the rendered depths; the test view left out); (b) the
    native, Python .bin and .txt parsers equal, the poses back within 1e-5,
    the undistortion and the resizes on the card equal to the CPU's, load
    and undistortion seconds, the COLMAP box; (c) the flagship ``cli train
    --dataset-type colmap`` to NIters 2,100 (launch counts reset before
    step 0 and read after: K1, K2, K3 and its index, nothing else; steps
    1,056-1,087 timed; the loss must fall; the held-out PSNR of the test
    view beside phase 8's), then two 64-step seed-0 runs of it bitwise
    equal; (d) the same command on phase 14's Blender export (its loose
    corner-ray box) without and with ``BboxRefitStep=1024``: the refit
    must fire with a shrink of at least 1.5 and K1-K3 launch after it;
    both held-out PSNRs. Returns the launch counts of (c)'s 2,100-step
    run and its held-out PSNR."""
    import numpy as np
    import torch
    from nerfpp_tpu_torch import native
    from nerfpp_tpu_torch.data import colmap as C
    from nerfpp_tpu_torch.data.blender import export_blender_scene
    from nerfpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    from nerfpp_tpu_torch.utils import image as I
    from nerfpp_tpu_torch.utils.png import read_png
    from scripts.colmap_export import export_colmap_scene
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    ws = root / "colmap"

    # (a) export
    t0 = time.perf_counter()
    exp = export_colmap_scene(scene, ws, dev, n_samples=64, n_points=50_000,
                              log=lambda m: log("capture", m))
    log("capture", f"exported in {time.perf_counter() - t0:.2f} s; OPENCV "
        f"cameras (fx, fy, cx, cy, k1, k2, p1, p2): "
        + "; ".join(f"{c.width}x{c.height} {c.params.tolist()}"
                    for c in exp.cameras))

    # (b) load
    sparse = ws / "sparse" / "0"
    t0 = time.perf_counter()
    if native.load() is None:
        raise AssertionError(f"the native parser did not build "
                             f"({native.lib_path()})")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec = C._read_model_native(sparse)
    native_s = time.perf_counter() - t0
    if rec is None:
        raise AssertionError("the native parser did not read the workspace")
    t0 = time.perf_counter()
    py = C.ColmapReconstruction(C._read_cameras_bin(sparse / "cameras.bin"),
                                C._read_images_bin(sparse / "images.bin"),
                                *C._read_points3d_bin(sparse / "points3D.bin"))
    py_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    txt = C.ColmapReconstruction(C._read_cameras_txt(sparse / "cameras.txt"),
                                 C._read_images_txt(sparse / "images.txt"),
                                 *C._read_points3d_txt(sparse / "points3D.txt"))
    txt_s = time.perf_counter() - t0
    for name, other in (("Python .bin", py), (".txt", txt)):
        bad = same_reconstruction(rec, other)
        if bad:
            raise AssertionError(f"the native and the {name} parser differ "
                                 f"in {bad[:5]}")
    n_obs = sum(len(im.point3d_ids) for im in rec.images.values())
    pose_err = max(float(np.abs(C.colmap_w2c_to_nerf_c2w(
        rec.images[i + 1].qvec, rec.images[i + 1].tvec) - p).max())
        for i, p in enumerate(exp.poses))
    if not pose_err <= 1e-5:
        raise AssertionError(f"recovered poses off by {pose_err}")
    log("capture", f"parsers equal (native, Python .bin, .txt): "
        f"{len(rec.images)} images, {len(rec.points_ids)} points, {n_obs} "
        f"observations; native build {build_s:.2f} s, read native "
        f"{native_s:.3f} s, Python .bin {py_s:.3f} s, .txt {txt_s:.3f} s; "
        f"poses within {pose_err:.3g} of the exported (limit 1e-5)")
    # the card against the CPU: new K, undistortion, both resizes
    for i in (0, 3):
        im = rec.images[i + 1]
        cam = rec.cameras[im.camera_id]
        k = cam.k_matrix().astype(np.float64)
        d = cam.distortion().astype(np.float64)
        img = torch.from_numpy(read_png(ws / "images" / im.name))
        devs = {"card": dev, "cpu": torch.device("cpu")}
        nk = {n: I.optimal_new_camera_matrix(k, d, (cam.width, cam.height),
                                             0.0, v) for n, v in devs.items()}
        if not np.array_equal(nk["card"], nk["cpu"]):
            raise AssertionError(f"{im.name}: new K differs, card "
                                 f"{nk['card']} CPU {nk['cpu']}")
        und = {n: I.undistort(img.to(v), k, d, nk["cpu"]).cpu()
               for n, v in devs.items()}
        small = {n: I.resize_linear_u8(und["cpu"].to(v), (800, 800)).cpu()
                 for n, v in devs.items()}
        fl = {n: I.resize_linear(und["cpu"].to(v).float() / 255.0,
                                 (800, 800)).cpu() for n, v in devs.items()}
        fdiff = float((fl["card"] - fl["cpu"]).abs().max())
        if not (torch.equal(und["card"], und["cpu"])
                and torch.equal(small["card"], small["cpu"])
                and fdiff <= 1e-6):
            raise AssertionError(f"{im.name}: card against CPU: undistort "
                                 f"{int((und['card'] != und['cpu']).sum())} "
                                 f"pixels differ, 8-bit resize "
                                 f"{int((small['card'] != small['cpu']).sum())}"
                                 f", float resize {fdiff}")
        log("capture", f"{im.name} ({cam.width}x{cam.height}): new K and "
            f"undistortion on the card equal to the CPU's; 8-bit resize to "
            f"800x800 equal, float resize within {fdiff:.3g} (limit 1e-6)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sc = C.load_from_colmap_reconstruction(ws, undistort=False, device=dev)
    parse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    C.undistort_images(sc, ws / "undistorted", dev)
    torch.cuda.synchronize()
    und_s = time.perf_counter() - t0
    box = sc.bounding_box
    vol = float(np.prod(box[3:] - box[:3]))
    log("capture", f"load_from_colmap_reconstruction: parse, near/far and box"
        f" {parse_s:.3f} s, undistortion of {len(sc.views)} views on the "
        f"card {und_s:.3f} s (PNG decode and encode included); COLMAP box "
        f"{np.round(box, 4).tolist()}, volume {vol:.4f} against the scene's "
        f"[-1.2, 1.2]^3 {2.4 ** 3:.4f} ({2.4 ** 3 / vol:.2f}x smaller); "
        f"near/far of view 1 {sc.views[0].near:.4f} / {sc.views[0].far:.4f}")

    # (c) cli train --dataset-type colmap, the flagship
    run = CliTrain(flagship_argv("colmap", ws, root / "out", dev))
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    train_s = run.run()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    loss = run.loss()
    ms, per_step = run.window_ms()
    psnr = run.held_out_psnr(scene)
    first, last = float(loss[:32].mean()), float(loss[-32:].mean())
    if not (loss.size == 2099 and math.isfinite(last)
            and last < 0.5 * first):
        raise AssertionError(f"colmap train: {loss.size} steps, loss mean "
                             f"{first} (steps 0-31) -> {last} (last 32)")
    for name in TRAIN_KERNELS:
        if counts[name] == 0:
            raise AssertionError(f"{name} was not launched by the COLMAP "
                                 "training")
    others = {k: v for k, v in counts.items() if k not in TRAIN_KERNELS}
    if any(others.values()):
        raise AssertionError(f"the COLMAP training launched other kernels: "
                             f"{others}")
    log("capture", f"cli train --dataset-type colmap (flagship): "
        f"{loss.size} steps in {train_s:.1f} s (load, undistortion and "
        f"validation images included); steps 1056-1087: {ms:.3f} ms/step, "
        f"{4096 / (ms / 1e3):.1f} rays/s; launches per step "
        + ", ".join(f"{k} {v:.3f}" for k, v in per_step.items())
        + f"; peak memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    log("capture", f"launches, steps 0-{loss.size - 1}: "
        + ", ".join(f"{k} {counts[k]}" for k in TRAIN_KERNELS)
        + "; no other kernel")
    log("capture", "loss every 300 steps: " + " ".join(
        f"({i}, {loss[i]:.5f})" for i in range(0, loss.size, 300))
        + f"; mean {first:.5f} (steps 0-31) -> {last:.5f} (last 32)")
    log("capture", f"held-out PSNR after {loss.size} steps through the COLMAP"
        f" capture: {psnr:.2f} dB (test view at its true pose and K, "
        f"800x800, unbudgeted); phase 8 on the scene itself: "
        + (f"{psnr_direct:.2f} dB" if psnr_direct is not None
           else "not run"))
    del run
    torch.cuda.empty_cache()
    # two 64-step seed-0 runs of the same path
    runs = []
    for r in range(2):
        f = CliTrain(flagship_argv("colmap", ws, root / f"det{r}", dev,
                                   n_iters=65))
        f.run()
        runs.append((torch.cat(f.losses).view(torch.int32).cpu(),
                     state_of(f.ex)))
        del f
    (la, sa), (lb, sb) = runs
    step = first_difference(la, lb)
    bad = [k for k in sa if not torch.equal(sa[k], sb[k])]
    if step is not None or bad:
        raise AssertionError(f"determinism (colmap): the losses of two "
                             f"seed-0 runs first differ at step {step}; "
                             f"after 64 steps they differ in "
                             f"{', '.join(bad) or 'no tensor'}")
    log("determinism", f"colmap: two seed-0 runs of cli train (NIters 65, "
        f"{la.numel()} steps): losses bitwise equal at every step, "
        f"parameters, Adam state and occupancy grid bitwise equal "
        f"({len(sa)} tensors)")
    del runs
    torch.cuda.empty_cache()

    # (d) the refit, on the Blender export's loose corner-ray box
    data = root / "blender"
    export_blender_scene(scene, data)
    psnrs = {}
    for label, extra in (("no refit", ()),
                         ("BboxRefitStep=1024",
                          ("--set-train", "BboxRefitStep=1024"))):
        f = CliTrain(flagship_argv("blender", data,
                                   root / label.replace("=", "_"), dev,
                                   extra=extra))
        reset_launch_counts()
        secs = f.run()
        after = launch_counts()
        loss = f.loss()
        first, last = float(loss[:32].mean()), float(loss[-32:].mean())
        if not (math.isfinite(last) and last < 0.5 * first):
            raise AssertionError(f"blender train ({label}): loss mean "
                                 f"{first} -> {last}")
        psnrs[label] = f.held_out_psnr(scene)
        ms, _ = f.window_ms()
        log("capture", f"cli train --dataset-type blender ({label}): "
            f"{loss.size} steps in {secs:.1f} s, steps 1056-1087 {ms:.3f} "
            f"ms/step; loss {first:.5f} -> {last:.5f}; held-out PSNR "
            f"{psnrs[label]:.2f} dB")
        if extra:
            fired = [r for r in f.refits if r[1]]
            if len(f.refits) != 1 or not fired:
                raise AssertionError(f"the refit did not fire: {f.refits}")
            step, _, old, new = fired[0]
            shrink = float(np.prod(old[3:] - old[:3])
                           / np.prod(new[3:] - new[:3]))
            log("capture", f"bbox refit at step {step}: "
                f"{np.round(old, 4).tolist()} -> {np.round(new, 4).tolist()},"
                f" {shrink:.2f}x volume shrink; launches after it: "
                + ", ".join(f"{k} {after[k]}" for k in TRAIN_KERNELS)
                + "; before it: "
                + ", ".join(f"{k} {f.after_refit[k]}" for k in TRAIN_KERNELS))
            if not shrink >= 1.5:
                raise AssertionError(f"refit shrink {shrink} < 1.5")
            if not np.array_equal(f.ex.embedder.bounding_box, new):
                raise AssertionError("the encoder is not on the new box")
            for name in TRAIN_KERNELS:
                if after[name] == 0:
                    raise AssertionError(f"{name} did not launch after the "
                                         "refit")
        del f
        torch.cuda.empty_cache()
    log("capture", "held-out PSNR at 2,100 steps (test view, 800x800, "
        "unbudgeted): the scene itself (phase 8) "
        + (f"{psnr_direct:.2f}" if psnr_direct is not None else "not run")
        + f" dB; the COLMAP capture {psnr:.2f} dB; the Blender export "
        f"{psnrs['no refit']:.2f} dB, with the refit at 1,024 "
        f"{psnrs['BboxRefitStep=1024']:.2f} dB")
    tmp.cleanup()
    log("capture", f"phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return {k: counts[k] for k in TRAIN_KERNELS}, psnr


def state_digests(ex):
    """A sha256 of each state tensor's bytes (bitwise comparison across
    processes)."""
    import hashlib
    import torch
    return {k: hashlib.sha256(v.detach().reshape(-1).contiguous().view(
        torch.uint8).cpu().numpy().tobytes()).hexdigest()
        for k, v in state_of(ex).items()}


def all_reduce_ms(mesh, n, reps=10):
    """Median ms of one SUM all-reduce of ``n`` f32 and of ``n`` bf16
    elements over ``mesh`` (CUDA events; every rank calls it)."""
    import torch
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        buf = torch.ones(n, dtype=dt, device=mesh.device)
        for _ in range(2):
            mesh.all_reduce(buf)
        ms = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            mesh.all_reduce(buf)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        out[str(dt).split(".")[1]] = statistics.median(ms)
    return out


def dp_rank(mesh, state_dir):
    """Phase 18 (b), one rank of two on the card (gloo), from phase 8's
    state at step DP_FIRST, DP_STEPS steps each through
    NeRFExecutor.train on this rank's tiles: first the flagship with its
    MLP in f32, rank 0 also taking each step on one device from a copy of
    the same state with the same draws (a second executor) and comparing
    the loss and every summed gradient (in f32 the two differ only by the
    order of the sums, as in phase 7; the bf16 MLP rounds each rank's
    partial weight gradient to bf16, another function); then the flagship
    itself, free-running. Then the all-reduce alone on the flagship's
    gradient buffer. -> the lock-step comparison, the free run's losses,
    K1-K3 launches and state digests, seconds and all-reduce times."""
    import torch
    from nerfpp_tpu_torch.config import hashnerf_blocked_preset
    from nerfpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    from nerfpp_tpu_torch.utils import checkpoint as ckpt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    scene = bench_scene(dev)
    state = ckpt.restore_latest(state_dir)
    p32 = hashnerf_blocked_preset(n_importance=0, use_occupancy_grid=True,
                                  occ_update_every=32,
                                  compute_dtype="float32")
    f = Trainer(scene, dev, SEED, p=p32, mesh=mesh)
    ex = f.ex
    ex.load_state(state)
    ref = Trainer(scene, dev, SEED, p=p32).ex if mesh.rank == 0 else None
    build = ex._build_train_step
    lock = []

    def lockstep(tp, *m):
        step = build(tp, *m)
        ref_step = ref._build_train_step(tp) if ref is not None else None

        def run(i, sampler, generator):
            if ref_step is not None:
                # train seeds the generator just before each step
                ref.load_state({k: v.clone()
                                for k, v in ex.state_dict().items()})
                g = torch.Generator(device=generator.device).manual_seed(
                    generator.initial_seed())
                mr = ref_step(i, sampler, g)
            m = step(i, sampler, generator)
            if ref_step is not None:
                worst = max(float((p.grad - ref_p.grad).abs().max()
                                  / ref_p.grad.abs().max().clamp(min=1e-30))
                            for p, ref_p in zip(
                                ex.named_parameters().values(),
                                ref.named_parameters().values()))
                lock.append((i, float(m["loss"]), float(mr["loss"]), worst))
            return m
        return run

    ex._build_train_step = lockstep
    f.run(DP_STEPS)
    del f, ex, ref
    f = Trainer(scene, dev, SEED, mesh=mesh)
    f.ex.load_state(state)
    reset_launch_counts()
    secs = f.run(DP_STEPS)
    launches = launch_counts()
    n = sum(p.numel() for p in f.ex.named_parameters().values())
    return {"first": int(state["step"]), "lock": lock,
            "losses": torch.cat(f.losses).cpu(),
            "launches": {k: launches[k] for k in TRAIN_KERNELS},
            "secs": secs, "digests": state_digests(f.ex),
            "all_reduce": all_reduce_ms(mesh, n), "n": n}


def dp_phase(scene, dev, record):
    """Phase 18, data parallelism (parallel/mesh.py). (a) The flagship
    under an NCCL mesh of one rank for 64 steps from seed 0: losses and
    state bitwise phase 8's determinism run (the JAX step takes its plain
    path at one device), steps 32-63 timed beside phase 8's 33-64, the
    all-reduce alone on the gradient buffer at one rank. (b) Two ranks on
    the one card through gloo (NCCL refuses two ranks on one device), the
    flagship from phase 8's state at step 992 for 64 steps (the two-class
    budget and the phased refresh switch on at 1,024; one chunk of 32
    tiles, so the implicit path: 16 tiles a rank, the budget ranked over
    all 32): with the MLP in f32, every step's loss and summed gradients
    against one device's step from the same state (rank 0's lock-step
    copy; loss to 2e-4 of itself, gradients to 1e-3 of each tensor's
    largest); then the flagship itself (bf16 MLP), free-running: the two
    ranks' losses and states bitwise equal, K1-K3 launches a step a rank,
    its losses beside phase 8's (trajectories part with the order of the
    gradient sum); the all-reduce at two ranks. (c) ``cli
    train --n-devices 1`` of hashnerf_preset() for 8 steps: only the
    large pair launches. Two ranks sharing one card are no scaling
    figure."""
    import numpy as np
    import torch
    from nerfpp_tpu_torch import cli
    from nerfpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    from nerfpp_tpu_torch.parallel import mesh as mesh_utils
    t_phase = time.perf_counter()
    bits, ref = record["run"]
    with mesh_utils.one_rank("cuda") as mesh:
        f = Trainer(scene, dev, SEED, mesh=mesh)
        reset_launch_counts()
        f.run(32)
        c0 = launch_counts()
        secs = f.run(32)
        c1 = launch_counts()
        st = state_of(f.ex)
        step = first_difference(f.loss_bits(), bits)
        bad = [k for k in ref if not torch.equal(st[k].cpu(), ref[k])]
        if step is not None or bad:
            raise AssertionError(f"dp (a): the NCCL mesh of one differs "
                                 f"from phase 8's run: first loss at step "
                                 f"{step}, tensors {bad}")
        n = sum(p.numel() for p in f.ex.named_parameters().values())
        one = all_reduce_ms(mesh, n)
        del f, st
    ms = secs / 32 * 1e3
    log("dp", f"(a) NCCL mesh of 1 (torch.distributed, world 1): 64 "
        f"flagship steps from seed {SEED} bitwise phase 8's determinism "
        f"run (losses at every step, {len(ref)} state tensors); steps "
        f"32-63 {ms:.3f} ms/step against phase 8's steps 33-64 "
        f"{record['early_ms']:.3f} ms/step; launches a step "
        + ", ".join(f"{k} {(c1[k] - c0[k]) / 32:.3f}"
                    for k in TRAIN_KERNELS))
    log("dp", f"(a) all-reduce alone, world 1 (NCCL), the flagship's "
        f"gradient buffer of {n} elements ({4 * n} B f32, {2 * n} B bf16): "
        f"f32 {one['float32']:.4f} ms, bf16 {one['bfloat16']:.4f} ms")
    t0 = time.perf_counter()
    ranks = mesh_utils.launch(dp_rank, 2, "cuda:0", record["state_dir"],
                              backend="gloo", timeout=600)
    wall = time.perf_counter() - t0
    r0, r1 = ranks
    if r0["first"] != DP_FIRST:
        raise AssertionError(f"dp (b): phase 8's state is at step "
                             f"{r0['first']}, not {DP_FIRST}")
    if not (np.array_equal(r0["losses"], r1["losses"])
            and r0["digests"] == r1["digests"]):
        raise AssertionError("dp (b): the two ranks' losses or states "
                             "differ")
    worst_loss = max(abs(a - b) / abs(b) for _, a, b, _ in r0["lock"])
    worst_grad = max(g for *_, g in r0["lock"])
    if len(r0["lock"]) != DP_STEPS or worst_loss > 2e-4 or worst_grad > 1e-3:
        raise AssertionError(f"dp (b): a 2-rank step against one device's "
                             f"from the same state: loss {worst_loss:.3g} "
                             f"(limit 2e-4), gradients {worst_grad:.3g} "
                             f"(limit 1e-3), {len(r0['lock'])} steps")
    free = np.abs(r0["losses"] - record["losses"].numpy()) / np.abs(
        record["losses"].numpy())
    for name, r in (("rank 0", r0), ("rank 1", r1)):
        if 0 in [r["launches"][k] for k in TRAIN_KERNELS]:
            raise AssertionError(f"dp (b): {name} launched "
                                 f"{r['launches']}")
    log("dp", f"(b) 2 ranks on one card (gloo, cuda:0; two ranks sharing "
        f"one card, not a scaling figure), steps {DP_FIRST}-"
        f"{DP_FIRST + DP_STEPS - 1} from phase 8's state, the MLP in f32: "
        f"every step against one device's from the same state: loss within "
        f"{worst_loss:.3g} of itself, summed gradients within "
        f"{worst_grad:.3g} of each tensor's largest. The flagship (bf16 "
        f"MLP), free-running: the ranks' losses and "
        f"{len(r0['digests'])} state tensors bitwise equal; "
        f"{r0['secs'] / DP_STEPS * 1e3:.3f} ms/step; launch {wall:.1f} s")
    log("dp", "(b) K1-K3 launches a step a rank: " + "; ".join(
        f"{name} " + ", ".join(f"{k} {r['launches'][k] / DP_STEPS:.3f}"
                               for k in TRAIN_KERNELS)
        for name, r in (("rank 0", r0), ("rank 1", r1))))
    log("dp", f"(b) free-running losses against phase 8's steps "
        f"{DP_FIRST}-{DP_FIRST + DP_STEPS - 1}: first step "
        f"{free[0]:.3g}, largest {free.max():.3g}, median "
        f"{float(np.median(free)):.3g} of phase 8's (the trajectories part "
        f"with the order of the gradient sum)")
    two = r0["all_reduce"]
    log("dp", f"(b) all-reduce alone, world 2 (gloo on CUDA tensors, two "
        f"ranks on one card): f32 {two['float32']:.4f} ms, bf16 "
        f"{two['bfloat16']:.4f} ms ({r0['n']} elements)")
    # (c) the command line at one device
    with tempfile.TemporaryDirectory() as tmp:
        reset_launch_counts()
        t0 = time.perf_counter()
        cli.main(["train", "--dataset-type", "synthetic", "--preset",
                  "hashnerf", "--n-devices", "1", "--base-dir", tmp,
                  "--set-train", "NIters=9", "--set-train", "IPrint=4",
                  "--set-train", "ITestset=0", "--set-train", "IImg=0",
                  "--set-train", "IWeights=0"])
        torch.cuda.synchronize()
        c = launch_counts()
        secs = time.perf_counter() - t0
        rows = (Path(tmp) / "metrics.csv").read_text().splitlines()
    ran = {k: v for k, v in c.items() if v}
    if (set(ran) != set(LARGE_KERNELS) or len(rows) != 3):
        raise AssertionError(f"dp (c): cli train --n-devices 1 launched "
                             f"{ran}, metrics rows {rows}")
    log("dp", f"(c) cli train --n-devices 1 --preset hashnerf, 8 steps in "
        f"{secs:.1f} s (synthetic scene, build and load included): "
        + ", ".join(f"{k} {v}" for k, v in ran.items()))
    log("dp", f"phase 18 took {time.perf_counter() - t_phase:.1f} s")


def crop_k(k, x0, y0):
    """Intrinsics of the window of a view whose top-left pixel is (x0, y0)."""
    import numpy as np
    kc = np.asarray(k, np.float32).copy()
    kc[0, 2] -= x0
    kc[1, 2] -= y0
    return kc


def crop_parity(label, fields, outs, tol=2e-3):
    """Card against CPU on a 64x64 render: every field finite, its 99th
    percentile of |gpu - cpu| within ``tol`` and its largest within 25 x
    ``tol`` (phase 12's limits for a render of a stepped state: the
    importance depths of near-empty bins move with the rounding)."""
    import torch
    for f in fields:
        a = getattr(outs["cuda"], f).float().cpu()
        b = getattr(outs["cpu"], f).float()
        diff = (a - b).abs()
        p99, mx = float(torch.quantile(diff.flatten(), 0.99)), float(
            diff.max())
        log("options", f"{label} 64x64 {f}: max |gpu - cpu| {mx:.3g}, p99 "
            f"{p99:.3g} (limits {tol}, {25 * tol})")
        if not (bool(torch.isfinite(a).all()) and p99 <= tol
                and mx <= 25 * tol):
            raise AssertionError(f"{label} 64x64 {f}: GPU vs CPU out of "
                                 "tolerance")


def cpu_copy(ex, prompts=None):
    """An executor on the CPU holding ``ex``'s state (and prompts)."""
    import dataclasses
    from nerfpp_tpu_torch.executor import NeRFExecutor
    cpu = NeRFExecutor(dataclasses.replace(ex.params, ft_path=""),
                       device="cpu")
    cpu.white_bkgr = ex.white_bkgr
    cpu.initialize(ex.bounding_box, seed=SEED)
    cpu.load_state({k: v.cpu() for k, v in ex.state_dict().items()})
    if prompts is not None:
        cpu.set_lerf_prompts(prompts[:1], prompts[1:])
    return cpu


def timed_frames(ex, view_args, tp, n, **kw):
    """n frames of render_view, synchronised: (ms of each, last output,
    launches, peak memory)."""
    import torch
    from nerfpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ex.render_view(*view_args, tp, **kw)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, out, launch_counts(), torch.cuda.max_memory_allocated()


def lerf_only_part(scene, dev):
    """Phase 19 (a): a LeRF-only stack, hashnerf_preset(use_nerf=False,
    use_lerf=True), at full width. A tiny step GPU against CPU, then ``cli
    train`` on the bench scene's Blender export (NIters 258: steps 0-256,
    128-255 timed), 2 800x800 frames with relevancy, a 64x64 crop GPU
    against CPU, and ``cli render`` of the checkpoint. Returns the launch
    counts of the training and the frames."""
    import numpy as np
    import torch
    from nerfpp_tpu_torch import cli
    from nerfpp_tpu_torch.config import TrainParams, hashnerf_preset
    from nerfpp_tpu_torch.data.blender import export_blender_scene
    from nerfpp_tpu_torch.data.pyramid_clip import (
        PyramidEmbedder, PyramidEmbedderProperties,
        RandomProjectionPatchEncoder, make_device_pyramid)
    from nerfpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    tiny_enc = RandomProjectionPatchEncoder(embed_dim=32, input_size=8)

    def pyramid_of(sc, name):
        emb = PyramidEmbedder(tiny_enc, PyramidEmbedderProperties(
            img_size=8, overlap=0.5), device="cpu")(
            sc.images[list(sc.split_indices("train"))])
        return make_device_pyramid(emb, 0.5, device=name)

    step_parity("lerf-only-parity", hashnerf_preset(
        use_nerf=False, use_lerf=True, n_importance=16,
        compute_dtype="float32", lang_embed_dim=32, n_levels_le=6,
        log2_hashmap_size_le=12, finest_resolution_le=64), TrainParams(
        n_samples=8, n_rand=512, chunk=512, n_iters=100), LARGE_KERNELS,
        pyramid_of)
    tmp = tempfile.TemporaryDirectory()
    data, out = Path(tmp.name) / "blender", Path(tmp.name) / "out"
    export_blender_scene(scene, data)
    common = ["--dataset-type", "blender", "--data-dir", str(data),
              "--preset", "hashnerf", "--base-dir", str(out),
              "--set", "use_nerf=false", "--set", "use_lerf=true"]
    run = CliTrain(["train", *common, "--set-train", "NIters=258",
                    "--set-train", "IImg=0", "--set-train", "ITestset=0"],
                   window=(128, 256))
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    train_s = run.run()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    loss = run.loss()
    ms, per_step = run.window_ms(LARGE_KERNELS)
    ex = run.ex
    bad = [k for k, v in ex.state_dict().items()
           if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    finite = np.isfinite(loss)
    pe = ex.params
    log("options", f"(a) LeRF-only cli train (hashnerf_preset(use_nerf="
        f"False, use_lerf=True): {pe.n_levels_le} x "
        f"2^{pe.log2_hashmap_size_le} language table, E = "
        f"{pe.lang_embed_dim}, TrainParams(): NRand 4,096, 64 + 192 "
        f"samples): {loss.size} steps in {train_s:.1f} s "
        f"(pyramid built and cached in it); steps 128-255: {ms:.3f} ms/step, "
        f"{4096 / (ms / 1e3):.1f} rays/s; launches per step "
        + ", ".join(f"{k} {v:.3f}" for k, v in per_step.items())
        + f"; steps 0-{loss.size - 1}: "
        + ", ".join(f"{k} {v}" for k, v in counts.items() if v)
        + f"; peak memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    log("options", f"(a) non-finite: {int((~finite).sum())} of {loss.size} "
        f"step losses, {len(bad)} state tensors ({bad[:4]}); language loss "
        "every 32 steps: " + " ".join(f"({i}, {loss[i]:.5f})"
                                      for i in range(0, loss.size, 32)))
    first, last = float(loss[:32].mean()), float(loss[-32:].mean())
    log("options", f"(a) language loss {first:.5f} (steps 0-31) -> "
        f"{last:.5f} (last 32)")
    if not (loss.size == 257 and math.isfinite(last) and last < first):
        raise AssertionError(f"LeRF-only cli train: {loss.size} steps, "
                             f"language loss {first} -> {last}")
    for name in LARGE_KERNELS:
        if counts[name] == 0:
            raise AssertionError(f"{name} was not launched by LeRF-only "
                                 "training")
    if any(v for k, v in counts.items() if k not in LARGE_KERNELS):
        raise AssertionError(f"LeRF-only training launched {counts}")

    # two 800x800 frames with relevancy, a 64x64 crop GPU against CPU
    stub = RandomProjectionPatchEncoder(embed_dim=ex.params.lang_embed_dim)
    prompts = flat_patches(stub, (BLUE, RED, (0, 0, 0)), 336)
    ex.set_lerf_prompts(prompts[:1], prompts[1:])
    view = scene.views[list(scene.split_indices("test"))[0]]
    serve_tp = TrainParams()
    frame_ms, res, serve, fpeak = timed_frames(
        ex, (view.pose, view.h, view.w, view.k), serve_tp, 2)
    if set(res) != {"lerf"}:
        raise AssertionError(f"LeRF-only render_view returned {set(res)}")
    rel = res["lerf"].relevancy
    if (tuple(rel.shape) != (view.h, view.w, 1)
            or not bool(torch.isfinite(rel).all())
            or not float(rel.std()) > 0):
        raise AssertionError(f"LeRF-only relevancy: shape "
                             f"{tuple(rel.shape)}, std {float(rel.std())}")
    if serve["encode_large"] == 0 or any(
            v for k, v in serve.items() if k != "encode_large"):
        raise AssertionError(f"LeRF-only frame launches {serve}")
    mask = np.linalg.norm(np.asarray(scene.images[view.id])
                          - np.asarray(BLUE, np.float32), axis=-1) < 0.25
    auc, iou = auc_iou(rel[..., 0].cpu().numpy(), mask)
    log("options", f"(a) {view.h}x{view.w} frames with relevancy "
        f"(TrainParams(): 64 + 192, LeRF parts of "
        f"{ex._lerf_max_rays(ex.make_render_config(serve_tp, False))} rays)"
        f" ms {[round(t, 3) for t in frame_ms]}; launches per frame: "
        f"encode_large {serve['encode_large'] / 2:.2f}; peak memory {fpeak} "
        f"bytes ({fpeak / 2**30:.2f} GiB); relevancy range "
        f"[{float(rel.min()):.4f}, {float(rel.max()):.4f}], AUC {auc:.4f}, "
        f"IoU@0.5 {iou:.4f} (test view {view.id}, blue prim against red "
        "and black)")
    kc = crop_k(view.k, 368, 368)
    outs = {"cuda": ex.render_view(view.pose, 64, 64, kc, serve_tp,
                                   torch.Generator().manual_seed(SEED))}
    outs["cpu"] = cpu_copy(ex, prompts).render_view(
        view.pose, 64, 64, kc, serve_tp,
        torch.Generator().manual_seed(SEED))
    outs = {k: v["lerf"] for k, v in outs.items()}
    crop_parity("(a) LeRF-only crop (368, 368)",
                ("rendered_lang_embedding", "acc", "depth", "relevancy"),
                outs)
    del res, rel, outs

    # cli render of the checkpoint (no prompts, as the JAX CLI: no PNG)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.main(["render", *common])
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    rc = launch_counts()
    written = sorted(q.name for q in (out / "renders").iterdir())
    if written or rc["encode_large"] == 0 or any(
            v for k, v in rc.items() if k != "encode_large"):
        raise AssertionError(f"LeRF-only cli render: wrote {written}, "
                             f"launches {rc}")
    log("options", f"(a) cli render of step_{ex.step}: the test "
        f"split in {render_s:.1f} s, no PNG written (no prompts); "
        f"launches encode_large {rc['encode_large']}")
    del run, ex
    tmp.cleanup()
    torch.cuda.empty_cache()
    return {k: counts[k] + serve[k] for k in LARGE_KERNELS}


def trace_kernels(path):
    """The kernel events of a torch.profiler Chrome trace: (names, count,
    summed duration ms, span ms of the kernels)."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    ks = [e for e in events if e.get("cat") == "kernel"]
    if not ks:
        return set(), 0, 0.0, 0.0
    busy = sum(float(e.get("dur", 0.0)) for e in ks) / 1e3
    span = (max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in ks)
            - min(float(e["ts"]) for e in ks)) / 1e3
    return {e["name"] for e in ks}, len(ks), busy, span


def normals_part(scene, dev, reference):
    """Phase 19 (b): the flagship with the normals head,
    hashnerf_blocked_preset(n_importance=0, use_occupancy_grid=True,
    use_pred_normal=True), 64 steps from seed 0 through
    NeRFExecutor.train with profile_dir: its losses and shared state
    against ``reference`` (phase 8's determinism run: loss bits, host
    state), the trace's kernels; one 800x800 frame against the headless
    state's, bitwise. Returns the launch counts of the 64 steps."""
    import torch
    from nerfpp_tpu_torch.config import TrainParams, hashnerf_blocked_preset
    from nerfpp_tpu_torch.executor import NeRFExecutor
    from nerfpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    tmp = tempfile.TemporaryDirectory()
    prof = Path(tmp.name) / "trace"
    kw = dict(n_importance=0, use_occupancy_grid=True, occ_update_every=32)
    f = Trainer(scene, dev, SEED, "flagship",
                p=hashnerf_blocked_preset(use_pred_normal=True, **kw))
    reset_launch_counts()
    secs = f.run(64, profile_dir=str(prof))
    counts = launch_counts()
    bits, st = f.loss_bits(), state_of(f.ex)
    ref_bits, ref_state = reference
    step = first_difference(bits, ref_bits)
    differ = [k for k in ref_state if not torch.equal(st[k].cpu(),
                                                      ref_state[k])]
    head = sorted(k for k in st if "normals_net" in k)
    log("options", f"(b) normals head, 64 steps from seed {SEED} with "
        f"profile_dir in {secs:.2f} s: launches "
        + ", ".join(f"{k} {counts[k]}" for k in TRAIN_KERNELS)
        + f"; against phase 8's headless determinism run: first differing "
        f"loss step {step}; of {len(ref_state)} shared state tensors "
        f"{len(differ)} differ {differ[:6]}; {len(head)} head tensors "
        f"(params and moments) beside them")
    if step is not None and step < min(bits.numel(), ref_bits.numel()):
        a, b = (x[step:step + 1].view(torch.float32) for x in (bits,
                                                               ref_bits))
        log("options", f"(b) the bitwise prediction missed: first loss "
            f"difference at step {step}: {float(a)} against {float(b)}")
    for name in TRAIN_KERNELS:
        if counts[name] == 0:
            raise AssertionError(f"{name} was not launched with the normals "
                                 "head")
    trace = prof / "trace.json"
    names, n_k, busy, span = trace_kernels(trace)
    want = ("window_lists_kernel", "encode_blocked_kernel",
            "grad_index_kernel", "grad_owner_kernel")
    seen = {w: sum(w in n for n in names) for w in want}
    log("options", f"(b) trace {trace.name}: {trace.stat().st_size} bytes, "
        f"{n_k} kernel events of {len(names)} names over {span:.3f} ms "
        f"(kernels busy {busy:.3f} ms, steps 9-19 and the synchronise); "
        f"names holding " + ", ".join(f"{k} {v}" for k, v in seen.items()))
    if not all(seen.values()):
        raise AssertionError(f"the trace names none of "
                             f"{[k for k, v in seen.items() if not v]}")

    # one 800x800 frame with the head and one of the headless state
    ex = f.ex
    bare = NeRFExecutor(hashnerf_blocked_preset(**kw), device=dev)
    bare.white_bkgr = ex.white_bkgr
    bare.initialize(ex.bounding_box, seed=SEED)
    bare.load_state({k: v for k, v in ex.state_dict().items()
                     if "normals_net" not in k})
    view = scene.views[list(scene.split_indices("test"))[0]]
    tp = TrainParams(n_samples=64, chunk=65536)
    args = (view.pose, view.h, view.w, view.k)
    ms_h, out_h, c_h, _ = timed_frames(ex, args, tp, 2)
    ms_b, out_b, _, _ = timed_frames(bare, args, tp, 2)
    same = all(torch.equal(getattr(out_h["nerf"], x),
                           getattr(out_b["nerf"], x))
               for x in ("rgb", "depth", "acc"))
    log("options", f"(b) 800x800 frames (phase 5's TrainParams(n_samples="
        f"64, chunk=65536), auto budget, test view {view.id}): with the "
        f"head ms {[round(t, 3) for t in ms_h]}, headless "
        f"{[round(t, 3) for t in ms_b]}; launches per frame "
        + ", ".join(f"{k} {c_h[k] / 2:.2f}" for k in SERVE_KERNELS)
        + f"; rgb, depth and acc bitwise the headless frame's: {same}")
    if not same:
        raise AssertionError("the normals head changed the rendered frame")
    f.tmp.cleanup()
    tmp.cleanup()
    del f, ex, bare, out_h, out_b
    torch.cuda.empty_cache()
    return counts


def ndc_part(dev):
    """Phase 19 (c): NDC rays, hashnerf_preset(hier_ray_tile=0,
    hier_tile_budget_frac=0.0) at full width (16 x 2^19 f32) with a seeded
    table of |values| <= 0.25: one render_ray_batch(focal=, hw=) forward and
    backward on 4,096 forward-facing rays x (64 + 192); encode_large and
    the hashed gradient against their plain versions on its fine pass's
    NDC points; render_view at 800x800 under TrainParams(ndc=True) with
    and without c2w_staticcam; a 64x64 window GPU against CPU. Returns the
    launch counts of the batch and the frames."""
    import numpy as np
    import torch
    from nerfpp_tpu_torch.config import TrainParams, hashnerf_preset
    from nerfpp_tpu_torch.core import rays as R
    from nerfpp_tpu_torch.executor import NeRFExecutor
    from nerfpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    from nerfpp_tpu_torch.render import renderer as TR
    p = hashnerf_preset(hier_ray_tile=0, hier_tile_budget_frac=0.0)
    ex = NeRFExecutor(p, device=dev).initialize(BBOX, seed=SEED)
    gen = torch.Generator().manual_seed(SEED + 19)
    with torch.no_grad():
        ex.embedder.table.copy_(
            ((torch.rand(ex.embedder.table.shape, generator=gen) * 2 - 1)
             * 0.25).to(dev))
    k, _ = camera(800)
    pose = np.eye(4, dtype=np.float32)            # forward-facing, down -z
    pose[2, 3] = 0.5
    static = pose.copy()
    c, s = math.cos(math.radians(10.0)), math.sin(math.radians(10.0))
    static[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    static[0, 3] = 0.1
    tp = TrainParams(ndc=True)
    cfg = ex.make_render_config(tp, train=False, return_weights=True)
    sel = torch.randperm(800 * 800, generator=gen)[:4096]
    kt, pt = torch.tensor(k, device=dev), torch.tensor(pose, device=dev)
    ro, rd, cone = R.get_ray_batch((sel % 800).to(dev), (sel // 800).to(dev),
                                   kt, pt)
    seen = []

    def embed(x):
        seen.append(x.detach())
        return ex.embedder(x)

    net = TR.make_nerf_network_fn(embed, ex.embeddirs, ex.model)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = TR.render_ray_batch(
        net, TR.make_nerf_integrate_fn(cfg), ro, rd, cone, cfg,
        ex._tensor(BBOX), generator=torch.Generator(device=dev).manual_seed(
            SEED), focal=float(k[0, 0]), hw=(800, 800))
    res.outputs.rgb.sum().backward()
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    fine = seen[-1]
    lo, hi = fine.amin(0).tolist(), fine.amax(0).tolist()
    log("options", f"(c) NDC render_ray_batch forward and backward, 4,096 "
        f"forward-facing rays x ({cfg.n_samples} + {cfg.n_importance}) in "
        f"{batch_ms:.3f} ms (first call); launches "
        + ", ".join(f"{k_} {counts[k_]}" for k_ in LARGE_KERNELS)
        + f"; acc mean {float(res.outputs.acc.detach().mean()):.4f}; "
        f"fine-pass NDC "
        f"points {tuple(fine.shape)} in [{', '.join(f'{v:.3f}' for v in lo)}]"
        f" .. [{', '.join(f'{v:.3f}' for v in hi)}]")
    if not bool(torch.isfinite(res.outputs.rgb).all()) or 0 in [
            counts[k_] for k_ in LARGE_KERNELS] or any(
            v for k_, v in counts.items() if k_ not in LARGE_KERNELS):
        raise AssertionError(f"NDC batch: launches {counts} or non-finite "
                             "rgb")
    del res, seen
    ex.embedder.table.grad = None
    table = ex.embedder.table.detach()
    stats = {"encode_large": large_kernel_phase(ex.embedder, table, fine,
                                                "NDC fine pass")}
    stats.update(large_grad_phase(ex.embedder, fine, "NDC fine pass"))
    for name, v in stats.items():
        log("options", f"(c) {name} on the NDC fine pass "
            f"({ex.embedder.n_levels} x 2^{p.log2_hashmap_size}, "
            f"{ex.embedder.scheme} scheme), 4,096 rays x 256: "
            + json.dumps(v))
    del fine
    torch.cuda.empty_cache()

    # 800x800 frames under NDC, with and without c2w_staticcam
    frames = {}
    serve = {k_: 0 for k_ in LARGE_KERNELS}
    for name, kw, n in (("plain", {}, 2),
                        ("staticcam", {"c2w_staticcam": static}, 1)):
        ms, out, c_, peak = timed_frames(ex, (pose, 800, 800, k), tp, n,
                                         **kw)
        res = out["nerf"]
        if tuple(res.rgb.shape) != (800, 800, 3) or not bool(
                torch.isfinite(res.rgb).all()):
            raise AssertionError(f"NDC frame ({name}): shape or values")
        if c_["encode_large"] == 0 or any(
                v for k_, v in c_.items() if k_ != "encode_large"):
            raise AssertionError(f"NDC frame launches {c_}")
        serve["encode_large"] += c_["encode_large"]
        frames[name] = res.rgb
        log("options", f"(c) NDC 800x800 frame ({name}; TrainParams(ndc="
            f"True): 64 + 192, chunk 32,768) ms {[round(t, 3) for t in ms]}"
            f"; launches per frame encode_large {c_['encode_large'] / n:.2f};"
            f" peak memory {peak} bytes ({peak / 2**30:.2f} GiB); rgb mean "
            f"{float(res.rgb.mean()):.4f}, acc mean "
            f"{float(res.acc.mean()):.4f}")
    if torch.equal(frames["plain"], frames["staticcam"]):
        raise AssertionError("c2w_staticcam did not change the NDC frame")
    kc = crop_k(k, 368, 368)
    cpu = cpu_copy(ex)
    for name, kw in (("plain", {}), ("staticcam", {"c2w_staticcam": static})):
        outs = {"cuda": ex.render_view(pose, 64, 64, kc, tp,
                                       torch.Generator().manual_seed(SEED),
                                       **kw)["nerf"],
                "cpu": cpu.render_view(pose, 64, 64, kc, tp,
                                       torch.Generator().manual_seed(SEED),
                                       **kw)["nerf"]}
        crop_parity(f"(c) NDC window (368, 368) {name}",
                    ("rgb", "acc", "depth"), outs)
    del ex, cpu, frames
    torch.cuda.empty_cache()
    return {k_: counts[k_] + serve[k_] for k_ in LARGE_KERNELS}


def options_phase(scene, dev, reference):
    """Phase 19: the JAX stack's remaining options. (a) a LeRF-only stack
    at full width, (b) the normals head with train(profile_dir=), (c) NDC
    rays and c2w_staticcam. ``reference``: phase 8's determinism run (loss
    bits, host state) for (b)'s bitwise check."""
    t0 = time.perf_counter()
    a = lerf_only_part(scene, dev)
    log("options", f"(a) took {time.perf_counter() - t0:.1f} s; launches "
        "(training and frames) " + ", ".join(f"{k} {v}" for k, v in a.items()))
    t1 = time.perf_counter()
    b = normals_part(scene, dev, reference)
    log("options", f"(b) took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    c = ndc_part(dev)
    log("options", f"(c) took {time.perf_counter() - t1:.1f} s; launches "
        "(batch and frames) " + ", ".join(f"{k} {v}" for k, v in c.items()))
    log("options", f"phase 19 took {time.perf_counter() - t0:.1f} s; "
        f"launches on its paths: LeRF-only "
        + ", ".join(f"{k} {v}" for k, v in a.items()) + "; normals head "
        + ", ".join(f"{k} {b[k]}" for k in TRAIN_KERNELS) + "; NDC "
        + ", ".join(f"{k} {v}" for k, v in c.items()))


def codec_times(files, dev, progressive=False):
    """Decode every JPEG file on ``dev`` and encode the decoded image
    again (progressive with ``progressive``), each split into its host part
    (markers and the C++ entropy pass; for encoding also the block copy to
    the host) and its device part (synchronised): {"decode": (host s,
    device s), "encode": (...), "bytes", "pixels"}, and the decoded
    images."""
    import torch
    from nerfpp_tpu_torch.utils import jpeg as J
    t = {"decode": [0.0, 0.0], "encode": [0.0, 0.0], "bytes": 0,
         "pixels": 0}
    images = []
    for path in files:
        data = Path(path).read_bytes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = J.decode_coefficients(data, path)
        t1 = time.perf_counter()
        img = J.frame_pixels(frame, dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        enc = J.jpeg_blocks(img, 95, dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        J.encode_file(enc, progressive)
        t4 = time.perf_counter()
        t["decode"][0] += t1 - t0
        t["decode"][1] += t2 - t1
        t["encode"][1] += t3 - t2
        t["encode"][0] += t4 - t3
        t["bytes"] += len(data)
        t["pixels"] += frame.height * frame.width
        images.append(img)
    return t, images


def codec_line(label, t):
    """One log line of codec_times' figures."""
    parts = []
    for what in ("decode", "encode"):
        host, device = t[what]
        total = host + device
        parts.append(f"{what} {total:.4f} s (host entropy {host:.4f} s, "
                     f"device stages {device:.4f} s): "
                     f"{t['bytes'] / total / 1e6:.1f} MB/s, "
                     f"{t['pixels'] / total / 1e6:.1f} Mpix/s")
    return (f"{label} ({t['bytes']} bytes of JPEG, {t['pixels'] / 1e6:.2f} "
            f"Mpix): " + "; ".join(parts))


def colmap_depth(label, t_start, after_s=0.0):
    """(NIters, timed window) of phase 20's or 21's flagship ``cli train``:
    2,100 steps (window 1,056-1,088), or 1,088 (phase 8's first PSNR point;
    window 1,024-1,056) when the script, with the full run and the
    ``after_s`` seconds still to come after it, would pass SOFT_LIMIT_S. The
    cut is printed."""
    elapsed = time.perf_counter() - t_start
    if elapsed + COLMAP_TRAIN_S + after_s <= SOFT_LIMIT_S:
        return 2100, (1056, 1088)
    log(label, f"(c) cut to NIters 1088: the script is at {elapsed:.1f} s, "
        f"and the full run (about {COLMAP_TRAIN_S} s) with {after_s:.0f} s "
        f"still to come would take it past {SOFT_LIMIT_S} s")
    return 1088, (1024, 1056)


def jpeg_phase(scene, dev, psnr_png, t_start, after_s=0.0):
    """Phase 20, JPEG capture: (a) the bench scene exported as phase 17(a)
    exports it with JPEG views (utils/jpeg.py, encoded on the card); (b) the
    undistortion on the card (each distorted view decoded, undistorted and
    re-encoded as JPEG at quality 95), views 1 and 4 also through the CPU
    (the undistorted file byte for byte the card's), every exported and
    undistorted file decoded on the card and the CPU (bitwise equal) and
    its image encoded on both (byte-equal), the committed cv2 fixtures
    (tests/data/jpeg) decoded and encoded on the card to cv2's pixels and
    bytes, decode and encode seconds for the 16 views and for a 4,000 x
    3,000 upscale of view 1 (host entropy and device stages apart, MB/s,
    Mpix/s), and load_images of the 16 undistorted views; (c) phase
    17(c)'s flagship ``cli train --dataset-type colmap`` on the JPEG
    workspace to the NIters of ``colmap_depth`` (with ``after_s`` seconds
    still to come after it; launch counts reset before step 0 and read
    after: K1, K2, K3 and its index, nothing else; its window timed; the
    loss must fall; the held-out PSNR beside phase 17's on the PNG export,
    ``psnr_png``). Returns (c)'s launch counts and PSNR."""
    import numpy as np
    import torch
    from nerfpp_tpu_torch import native
    from nerfpp_tpu_torch.data import colmap as C
    from nerfpp_tpu_torch.data.dataset import load_images
    from nerfpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    from nerfpp_tpu_torch.utils import image as I
    from nerfpp_tpu_torch.utils import jpeg as J
    from scripts.colmap_export import export_colmap_scene
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    ws = root / "colmap_jpeg"
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    lib = J.entropy_library()
    t1 = time.perf_counter()
    if native.load() is None:
        raise AssertionError(f"the native parser did not build "
                             f"({native.lib_path()})")
    log("jpeg", f"entropy coder built and loaded in {t1 - t0:.2f} s "
        f"({lib._name}); the native parser in "
        f"{time.perf_counter() - t1:.2f} s (0 where phase 17 built it)")

    # (a) export with JPEG views
    t0 = time.perf_counter()
    export_colmap_scene(scene, ws, dev, n_samples=64, n_points=50_000,
                        image_format="jpg", log=lambda m: log("jpeg", m))
    sources = sorted((ws / "images").glob("*.jpg"))
    log("jpeg", f"(a) exported in {time.perf_counter() - t0:.2f} s: "
        f"{len(sources)} JPEG views, "
        f"{sum(f.stat().st_size for f in sources)} bytes")

    # (b) undistortion on the card, then the codec card against CPU
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sc = C.load_from_colmap_reconstruction(ws, device=dev)
    torch.cuda.synchronize()
    und_s = time.perf_counter() - t0
    undistorted = [Path(v.image_path) for v in sc.views]
    if sorted(f.name for f in undistorted) != [f.name for f in sources] or \
            any(f.parent.name != "undistorted" for f in undistorted):
        raise AssertionError(f"undistorted files {undistorted[:3]}...")
    raw = C.read_model(ws / "sparse" / "0")
    for i in (0, 3):
        cam = raw.cameras[raw.images[sc.views[i].id].camera_id]
        k = cam.k_matrix().astype(np.float64)
        d = cam.distortion().astype(np.float64)
        new_k = I.optimal_new_camera_matrix(k, d, (cam.width, cam.height),
                                            0.0, cpu)
        und = I.undistort(I.read_image(sources[i], cpu), k, d, new_k)
        if J.encode_jpeg(und, device=cpu) != undistorted[i].read_bytes():
            raise AssertionError(f"{undistorted[i].name}: the card's "
                                 "undistorted JPEG differs from the CPU's")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    C.load_from_colmap_reconstruction(ws, device=dev)
    torch.cuda.synchronize()
    und_warm = time.perf_counter() - t0
    log("jpeg", f"(b) load_from_colmap_reconstruction with undistortion on "
        f"the card (parse, near/far, box; JPEG decode, undistort, JPEG "
        f"encode of {len(sc.views)} views): {und_s:.3f} s the first time, "
        f"{und_warm:.3f} s again; views 1 and 4 through the CPU: the "
        f"undistorted files byte for byte the card's")
    for f in sources + undistorted:
        data = f.read_bytes()
        frame = J.decode_coefficients(data, f)
        card, host = J.frame_pixels(frame, dev).cpu(), J.frame_pixels(frame,
                                                                       cpu)
        if not torch.equal(card, host):
            raise AssertionError(f"{f}: decode card against CPU: "
                                 f"{int((card != host).sum())} values differ")
        if J.encode_jpeg(card.to(dev), device=dev) != J.encode_jpeg(
                host, device=cpu):
            raise AssertionError(f"{f}: encode card against CPU differs")
    log("jpeg", f"(b) {len(sources)} exported and {len(undistorted)} "
        f"undistorted files: decoded on the card bitwise the CPU's, their "
        f"images encoded on the card byte for byte the CPU's")
    fixtures = Path(__file__).resolve().parent / "tests" / "data" / "jpeg"
    names = sorted(f.stem for f in fixtures.glob("*.jpg")
                   if f.stem != "source")
    for name in names:
        want = np.load(fixtures / f"{name}.npy")
        got = J.read_jpeg(fixtures / f"{name}.jpg", dev).cpu().numpy()
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"fixture {name}: the card's decode is not "
                                 "cv2's")
    src = np.load(fixtures / "source.npy")
    if J.encode_jpeg(torch.from_numpy(src).to(dev), device=dev) != (
            fixtures / "source.jpg").read_bytes():
        raise AssertionError("fixture source: the card's encoding is not "
                             "cv2's")
    log("jpeg", f"(b) cv2 fixtures (libjpeg-turbo 3.1.2): {', '.join(names)}"
        f" decoded on the card to cv2.imread's pixels; source encoded on "
        f"the card to cv2.imencode's bytes")
    codec_times(sources[:1], dev)                    # warm the card's path
    t, images = codec_times(sources, dev)
    log("jpeg", codec_line(f"(b) the {len(sources)} exported views", t))
    big = I.resize_linear_u8(images[0], (3000, 4000))
    big_path = root / "big.jpg"
    J.write_jpeg(big_path, big, device=dev)
    t, (back,) = codec_times([big_path], dev)
    frame = J.decode_coefficients(big_path.read_bytes(), big_path)
    if not torch.equal(back.cpu(), J.frame_pixels(frame, cpu)):
        raise AssertionError("4000x3000: decode card against CPU differs")
    log("jpeg", codec_line("(b) view 1 upscaled to 4000x3000 (decoded "
                           "bitwise the CPU's)", t))
    del big, back, images
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stack = load_images(sc, list(range(len(sc.views))),
                        target_hw=(sc.views[0].h, sc.views[0].w), device=dev)
    load_s = time.perf_counter() - t0
    log("jpeg", f"(b) load_images of the {len(sc.views)} undistorted views "
        f"(decode on the card, 1000x1000 views resized to 800x800): "
        f"{load_s:.3f} s, stack {stack.shape}")
    del stack
    torch.cuda.empty_cache()

    # (c) cli train --dataset-type colmap on the JPEG workspace
    n_iters, window = colmap_depth("jpeg", t_start, after_s)
    run = CliTrain(flagship_argv("colmap", ws, root / "out", dev, n_iters),
                   window)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    train_s = run.run()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    loss = run.loss()
    ms, per_step = run.window_ms()
    psnr = run.held_out_psnr(scene)
    first, last = float(loss[:32].mean()), float(loss[-32:].mean())
    if not (loss.size == n_iters - 1 and math.isfinite(last)
            and last < 0.5 * first):
        raise AssertionError(f"JPEG colmap train: {loss.size} steps, loss "
                             f"mean {first} (steps 0-31) -> {last}")
    for name in TRAIN_KERNELS:
        if counts[name] == 0:
            raise AssertionError(f"{name} was not launched by the JPEG "
                                 "capture's training")
    others = {k: v for k, v in counts.items() if k not in TRAIN_KERNELS}
    if any(others.values()):
        raise AssertionError(f"the JPEG capture's training launched other "
                             f"kernels: {others}")
    log("jpeg", f"(c) cli train --dataset-type colmap on the JPEG capture "
        f"(flagship): {loss.size} steps in {train_s:.1f} s (the load, "
        f"JPEG decode, undistortion and re-encoding included: about "
        f"{und_warm + load_s:.2f} s of it, "
        f"{100 * (und_warm + load_s) / train_s:.1f} %, (b)'s second load "
        f"and load_images); steps {window[0]}-{window[1] - 1}: "
        f"{ms:.3f} ms/step, "
        f"{4096 / (ms / 1e3):.1f} rays/s; launches per step "
        + ", ".join(f"{k} {v:.3f}" for k, v in per_step.items())
        + f"; peak memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    log("jpeg", f"(c) launches, steps 0-{loss.size - 1}: "
        + ", ".join(f"{k} {counts[k]}" for k in TRAIN_KERNELS)
        + "; no other kernel")
    log("jpeg", "(c) loss every 300 steps: " + " ".join(
        f"({i}, {loss[i]:.5f})" for i in range(0, loss.size, 300))
        + f"; mean {first:.5f} (steps 0-31) -> {last:.5f} (last 32)")
    log("jpeg", f"(c) held-out PSNR after {loss.size} steps (test view at its"
        f" true pose and K, 800x800, unbudgeted): the JPEG capture "
        f"{psnr:.2f} dB; phase 17's PNG capture "
        + (f"{psnr_png:.2f} dB" if psnr_png is not None else "not run"))
    del run
    torch.cuda.empty_cache()
    tmp.cleanup()
    log("jpeg", f"phase 20 took {time.perf_counter() - t_phase:.1f} s")
    return {k: counts[k] for k in TRAIN_KERNELS}, psnr


def tiff_times(files, dev):
    """Read every TIFF file (host: the IFD, the C++ LZW pass, the numpy
    predictor and layout) and move it to ``dev`` (synchronised): (host s,
    device s, bytes, pixels), and the images on ``dev``."""
    import torch
    from nerfpp_tpu_torch.utils.tiff import read_tiff
    host = device = 0.0
    size = pixels = 0
    images = []
    for path in files:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = read_tiff(path)
        t1 = time.perf_counter()
        images.append(torch.from_numpy(img).to(dev))
        torch.cuda.synchronize()
        host += t1 - t0
        device += time.perf_counter() - t1
        size += Path(path).stat().st_size
        pixels += img.shape[0] * img.shape[1]
    return (host, device, size, pixels), images


def formats_phase(scene, dev, psnrs, t_start):
    """Phase 21, the image files cv2.imread reads (utils/png.py,
    utils/jpeg.py progressive, utils/tiff.py, csrc/tiff_codec.cpp): (a)
    phase 17's COLMAP export with the 800x800 camera's 12 views as
    progressive JPEG and the 1000x1000 camera's 4 as 8-bit LZW TIFF, written
    on the card; (b) the undistortion on the card (progressive decode,
    undistort, baseline JPEG at quality 95; TIFF read, undistort, TIFF
    write), views 1 and 4 also through the CPU (the JPEG byte for byte, the
    TIFF pixel for pixel), every exported and undistorted file decoded on
    the card and the CPU (bitwise equal), the committed cv2 fixtures
    (tests/data/image: progressive JPEG whole and cut, PNG kinds, TIFF
    variants) decoded on the card to cv2's pixels and prog_source encoded
    progressive on the card to cv2's bytes, a 16-bit PNG copy of views 1
    and 4 through undistort_images and load_images on the card and the CPU
    (bitwise equal; values up to 257, the JAX package's division of every
    depth by 255), decode seconds of the 12 progressive views and of a
    4,000 x 3,000 progressive upscale (host entropy pass and device stages
    apart, with the progressive encode's), of the 4 TIFF views (host read
    and the copy to the card), the undistortion and load_images; (c) phase
    17(c)'s flagship ``cli train --dataset-type colmap`` on the mixed
    workspace to NIters 2,100, or 1,088 if the whole script would pass
    1,080 s (the cut is printed; steps 1,024-1,055 then timed in place of
    1,056-1,087), launch counts reset before step 0 and read after (K1, K2,
    K3 and its index, no other kernel), the loss must fall, the held-out
    PSNR beside ``psnrs`` (phases 17 and 20). Returns (c)'s launch
    counts."""
    import copy

    import numpy as np
    import torch
    from nerfpp_tpu_torch.data import colmap as C
    from nerfpp_tpu_torch.data.dataset import SceneData, View, load_images
    from nerfpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    from nerfpp_tpu_torch.utils import image as I
    from nerfpp_tpu_torch.utils import jpeg as J
    from nerfpp_tpu_torch.utils import tiff as T
    from nerfpp_tpu_torch.utils.png import write_png
    from scripts.colmap_export import export_colmap_scene
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    ws = root / "colmap_formats"
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    lib = T.codec_library()
    log("formats", f"TIFF codec built and loaded in "
        f"{time.perf_counter() - t0:.2f} s ({lib._name})")

    # (a) export: progressive JPEG and TIFF
    t0 = time.perf_counter()
    export_colmap_scene(scene, ws, dev, n_samples=64, n_points=50_000,
                        image_format=("pjpg", "tif"),
                        log=lambda m: log("formats", m))
    sources = sorted((ws / "images").iterdir())
    jpgs = [f for f in sources if f.suffix == ".jpg"]
    tifs = [f for f in sources if f.suffix == ".tif"]
    if len(jpgs) != 12 or len(tifs) != 4 or not all(
            J.decode_coefficients(f.read_bytes()).progressive for f in jpgs):
        raise AssertionError(f"export: {len(jpgs)} progressive JPEG and "
                             f"{len(tifs)} TIFF views")
    log("formats", f"(a) exported in {time.perf_counter() - t0:.2f} s: "
        f"{len(jpgs)} progressive JPEG views "
        f"({sum(f.stat().st_size for f in jpgs)} bytes), {len(tifs)} TIFF "
        f"views ({sum(f.stat().st_size for f in tifs)} bytes)")

    # (b) undistortion on the card, then the codecs card against CPU
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sc = C.load_from_colmap_reconstruction(ws, device=dev)
    torch.cuda.synchronize()
    und_s = time.perf_counter() - t0
    undistorted = [Path(v.image_path) for v in sc.views]
    if sorted(f.name for f in undistorted) != [f.name for f in sources] or \
            any(f.parent.name != "undistorted" for f in undistorted):
        raise AssertionError(f"undistorted files {undistorted[:3]}...")
    raw = C.read_model(ws / "sparse" / "0")
    for i in (0, 3):
        cam = raw.cameras[raw.images[sc.views[i].id].camera_id]
        k = cam.k_matrix().astype(np.float64)
        d = cam.distortion().astype(np.float64)
        new_k = I.optimal_new_camera_matrix(k, d, (cam.width, cam.height),
                                            0.0, cpu)
        und = I.undistort(I.read_image(sources[i], cpu), k, d, new_k)
        if undistorted[i].suffix == ".jpg":
            same = J.encode_jpeg(und, device=cpu) == undistorted[
                i].read_bytes()
        else:
            same = np.array_equal(T.read_tiff(undistorted[i]), und.numpy())
        if not same:
            raise AssertionError(f"{undistorted[i].name}: the card's "
                                 "undistorted file differs from the CPU's")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    C.load_from_colmap_reconstruction(ws, device=dev)
    torch.cuda.synchronize()
    und_warm = time.perf_counter() - t0
    log("formats", f"(b) load_from_colmap_reconstruction with undistortion "
        f"on the card (parse, near/far, box; progressive decode, undistort, "
        f"baseline encode of 12 views; TIFF read, undistort, TIFF write of "
        f"4): {und_s:.3f} s the first time, {und_warm:.3f} s again; views 1 "
        f"(JPEG) and 4 (TIFF) through the CPU: the same files")
    for f in sources + undistorted:
        card = I.read_image(f, dev).cpu()
        host = I.read_image(f, cpu)
        if card.dtype != host.dtype or not torch.equal(
                card.to(torch.int32), host.to(torch.int32)):
            raise AssertionError(f"{f}: decode card against CPU differs")
    log("formats", f"(b) {len(sources)} exported and {len(undistorted)} "
        "undistorted files (progressive and baseline JPEG, TIFF) decoded on "
        "the card bitwise the CPU's")
    fixtures = Path(__file__).resolve().parent / "tests" / "data" / "image"
    names = []
    for f in sorted(fixtures.iterdir()):
        if f.suffix == ".npy" or f.stem == "prog_source":
            continue
        want = np.load(f.with_suffix(".npy"))
        got = I.read_image(f, dev).cpu().numpy()
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise AssertionError(f"fixture {f.name}: the card's decode is "
                                 "not cv2's")
        names.append(f.name)
    if J.encode_jpeg(torch.from_numpy(np.load(fixtures / "prog_source.npy"))
                     .to(dev), device=dev, progressive=True) != (
                         fixtures / "prog_source.jpg").read_bytes():
        raise AssertionError("fixture prog_source: the card's progressive "
                             "encoding is not cv2's")
    log("formats", f"(b) {len(names)} cv2 fixtures ({', '.join(names)}) "
        "decoded on the card to cv2.imread's pixels; prog_source encoded "
        "progressive on the card to cv2.imencode's bytes")

    # a 16-bit PNG copy of views 1 and 4 (x 257 plus seeded noise below
    # 257) through the undistortion and load_images, card against CPU
    rng = np.random.RandomState(SEED)
    deep_views = []
    for i in (0, 3):
        cam = raw.cameras[raw.images[sc.views[i].id].camera_id]
        img8 = I.read_image(sources[i], cpu).numpy().astype(np.uint32)
        img16 = (img8 * 257 + rng.randint(0, 257, img8.shape)).clip(
            0, 65535).astype(np.uint16)
        path = root / "deep" / f"view_{i:03d}.png"
        path.parent.mkdir(exist_ok=True)
        write_png(path, img16)
        deep_views.append(View(
            id=len(deep_views), h=cam.height, w=cam.width,
            focal=float(cam.params[0]), near=sc.views[i].near,
            far=sc.views[i].far, k=cam.k_matrix().astype(np.float32),
            pose=sc.views[i].pose, d=cam.distortion().astype(np.float32),
            image_path=str(path)))
    stacks, files = {}, {}
    for name, device in (("card", dev), ("cpu", cpu)):
        deep = SceneData(views=copy.deepcopy(deep_views),
                         splits_idx=[2, 0, 0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C.undistort_images(deep, root / f"deep_{name}", device)
        stacks[name] = load_images(deep, [0, 1], target_hw=(800, 800),
                                   device=device)
        torch.cuda.synchronize()
        files[name] = [I.read_image(v.image_path, cpu) for v in deep.views]
        if name == "card":
            deep_s = time.perf_counter() - t0
    for a, b in zip(files["card"], files["cpu"]):
        if a.dtype != torch.uint16 or not torch.equal(a.to(torch.int32),
                                                      b.to(torch.int32)):
            raise AssertionError("16-bit undistortion card against CPU "
                                 "differs")
    if not np.array_equal(stacks["card"], stacks["cpu"]):
        raise AssertionError("16-bit load_images card against CPU differs")
    top = float(stacks["card"].max())
    if not 1.0 < top <= 65535 / 255:
        raise AssertionError(f"16-bit load_images: max {top}")
    log("formats", f"(b) 16-bit PNG views 1 and 4 ("
        + " and ".join(f"{v.w}x{v.h}" for v in deep_views)
        + f"): undistorted and loaded (resized to 800x800 in 16 bits, then "
        f"/ 255) on the card in {deep_s:.3f} s, bitwise the CPU's; values up "
        f"to {top:.4f} (the JAX package's / 255 of every depth, mirrored)")

    codec_times(jpgs[:1], dev, progressive=True)      # warm the card's path
    t, images = codec_times(jpgs, dev, progressive=True)
    log("formats", codec_line(f"(b) the {len(jpgs)} progressive views "
                              "(progressive re-encode)", t))
    big = I.resize_linear_u8(images[0], (3000, 4000))
    big_path = root / "big.jpg"
    J.write_jpeg(big_path, big, device=dev, progressive=True)
    t, (back,) = codec_times([big_path], dev, progressive=True)
    frame = J.decode_coefficients(big_path.read_bytes(), big_path)
    if not torch.equal(back.cpu(), J.frame_pixels(frame, cpu)):
        raise AssertionError("4000x3000 progressive: decode card against "
                             "CPU differs")
    log("formats", codec_line("(b) view 1 upscaled to 4000x3000, "
                              "progressive (decoded bitwise the CPU's)", t))
    del big, back, images
    tiff_times(tifs[:1], dev)
    (host, device, size, pixels), _ = tiff_times(tifs, dev)
    log("formats", f"(b) the {len(tifs)} TIFF views ({size} bytes of LZW, "
        f"{pixels / 1e6:.2f} Mpix): read {host + device:.4f} s (host IFD, "
        f"LZW and predictor {host:.4f} s, copy to the card {device:.4f} s): "
        f"{size / (host + device) / 1e6:.1f} MB/s, "
        f"{pixels / (host + device) / 1e6:.1f} Mpix/s")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stack = load_images(sc, list(range(len(sc.views))),
                        target_hw=(sc.views[0].h, sc.views[0].w), device=dev)
    load_s = time.perf_counter() - t0
    log("formats", f"(b) load_images of the {len(sc.views)} undistorted "
        f"views (baseline JPEG and TIFF decoded on the card, 1000x1000 "
        f"resized to 800x800): {load_s:.3f} s, stack {stack.shape}")
    del stack
    torch.cuda.empty_cache()

    # (c) cli train --dataset-type colmap on the mixed workspace
    n_iters, window = colmap_depth("formats", t_start)
    run = CliTrain(flagship_argv("colmap", ws, root / "out", dev, n_iters),
                   window)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    train_s = run.run()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    loss = run.loss()
    ms, per_step = run.window_ms()
    psnr = run.held_out_psnr(scene)
    first, last = float(loss[:32].mean()), float(loss[-32:].mean())
    if not (loss.size == n_iters - 1 and math.isfinite(last)
            and last < 0.5 * first):
        raise AssertionError(f"mixed colmap train: {loss.size} steps, loss "
                             f"mean {first} (steps 0-31) -> {last}")
    for name in TRAIN_KERNELS:
        if counts[name] == 0:
            raise AssertionError(f"{name} was not launched by the mixed "
                                 "capture's training")
    others = {k: v for k, v in counts.items() if k not in TRAIN_KERNELS}
    if any(others.values()):
        raise AssertionError(f"the mixed capture's training launched other "
                             f"kernels: {others}")
    log("formats", f"(c) cli train --dataset-type colmap on the progressive "
        f"JPEG + TIFF capture (flagship): {loss.size} steps in "
        f"{train_s:.1f} s (the load, decode, undistortion and re-encoding "
        f"included: about {und_warm + load_s:.2f} s of it, "
        f"{100 * (und_warm + load_s) / train_s:.1f} %); steps "
        f"{window[0]}-{window[1] - 1}: {ms:.3f} ms/step, "
        f"{4096 / (ms / 1e3):.1f} rays/s; launches per step "
        + ", ".join(f"{k} {v:.3f}" for k, v in per_step.items())
        + f"; peak memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    log("formats", f"(c) launches, steps 0-{loss.size - 1}: "
        + ", ".join(f"{k} {counts[k]}" for k in TRAIN_KERNELS)
        + "; no other kernel")
    log("formats", "(c) loss every 300 steps: " + " ".join(
        f"({i}, {loss[i]:.5f})" for i in range(0, loss.size, 300))
        + f"; mean {first:.5f} (steps 0-31) -> {last:.5f} (last 32)")
    log("formats", f"(c) held-out PSNR after {loss.size} steps (test view at "
        f"its true pose and K, 800x800, unbudgeted): the progressive JPEG + "
        f"TIFF capture {psnr:.2f} dB; "
        + "; ".join(f"{k} {v:.2f} dB" if v is not None else f"{k} not run"
                    for k, v in psnrs.items()))
    del run
    torch.cuda.empty_cache()
    tmp.cleanup()
    log("formats", f"phase 21 took {time.perf_counter() - t_phase:.1f} s")
    return {k: counts[k] for k in TRAIN_KERNELS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="GPU smoke run of "
                                 "nerfpp_tpu_torch (one H100)")
    ap.add_argument("--repeat-train", type=int, default=0, metavar="K",
                    help="only phases 1-2, then one preset's training K "
                    "times from one seed: the repeatability experiment")
    ap.add_argument("--preset", choices=PRESETS, default="flagship",
                    help="the preset of --repeat-train (flagship: phase 8; "
                    "tpu, hashnerf: phase 11's run of hashnerf_tpu_preset()"
                    " or hashnerf_preset())")
    ap.add_argument("--seed", type=int, default=SEED,
                    help="the seed of --repeat-train's runs (default 0)")
    ap.add_argument("--capture-only", action="store_true",
                    help="only phases 1-2, then phase 17 (real capture)")
    ap.add_argument("--options-only", action="store_true",
                    help="only phases 1-2, then phase 19 (stack options) "
                    "against a 64-step flagship run of its own")
    ap.add_argument("--jpeg-only", action="store_true",
                    help="only phases 1-2, then phase 20 (JPEG capture)")
    ap.add_argument("--formats-only", action="store_true",
                    help="only phases 1-2, then phase 21 (progressive JPEG, "
                    "PNG kinds and TIFF)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "a GPU", file=sys.stderr)
        return 1
    if not (Path(__file__).resolve().parent / "nerfpp_tpu_torch").is_dir():
        print("chip_smoke: the nerfpp_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 1
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
    last_line = json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}})

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

    if args.capture_only:
        capture_phase(bench_scene(dev), dev, None)
        log("capture", f"total run {time.perf_counter() - t_start:.1f} s")
        print(last_line, flush=True)
        return 0

    if args.jpeg_only:
        jpeg_phase(bench_scene(dev), dev, None, t_start)
        log("jpeg", f"total run {time.perf_counter() - t_start:.1f} s")
        print(last_line, flush=True)
        return 0

    if args.formats_only:
        formats_phase(bench_scene(dev), dev, {"phase 17's PNG capture": None,
                                              "phase 20's JPEG capture": None},
                      t_start)
        log("formats", f"total run {time.perf_counter() - t_start:.1f} s")
        print(last_line, flush=True)
        return 0

    if args.options_only:
        scene = bench_scene(dev)
        ref = Trainer(scene, dev, SEED)
        ref.run(64)
        options_phase(scene, dev, (ref.loss_bits(), {
            k: v.cpu() for k, v in state_of(ref.ex).items()}))
        ref.tmp.cleanup()
        log("options", f"total run {time.perf_counter() - t_start:.1f} s")
        print(last_line, flush=True)
        return 0

    if args.repeat_train > 0:
        repeat_train(bench_scene(dev), dev, args.repeat_train, args.seed,
                     args.preset)
        log("repeat", f"total run {time.perf_counter() - t_start:.1f} s")
        print(last_line, flush=True)
        return 0

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
    stats.update(grad_phase(enc, pts_train, "train chunk"))
    grad_phase(enc, pts_rand, "random")
    del pts_train, pts_rand, table
    torch.cuda.empty_cache()

    # 7. one tiny train step, GPU against CPU -------------------------------
    train_parity()

    # 8. full-width training ----------------------------------------------
    scene = bench_scene(dev)
    dp_dir = tempfile.TemporaryDirectory()
    record = {"state_dir": dp_dir.name}
    counts, (_, psnr_2100), failed = train_phase(scene, dev, record=record)
    if failed:
        raise AssertionError("; ".join(failed))
    record["run"] = determinism_phase(scene, dev, "flagship")
    log("train", f"total run {time.perf_counter() - t_start:.1f} s")

    # 9. small-table kernels against their plain versions ------------------
    stats.update(small_phase(dev))

    # 10. a hierarchical train step, GPU against CPU -----------------------
    hier_parity()

    # 11, 12. hierarchical training and serving, determinism ---------------
    counts.update(hier_phase(scene, dev, t_start))
    determinism_phase(scene, dev, "tpu")
    log("hier-serve", f"total run {time.perf_counter() - t_start:.1f} s")

    # 13. large-table kernels against their plain versions -----------------
    stats.update(large_phase(dev))
    log("large", f"total run {time.perf_counter() - t_start:.1f} s")

    # 14. hashnerf_preset(): a train step GPU against CPU, determinism, the
    # CLI path
    # grad_large_bins runs on both hierarchical paths: its entry in the
    # kernels line counts phase 14's cli train (phase 11 prints its own)
    counts.update(cli_phase(scene, dev))
    log("cli", f"total run {time.perf_counter() - t_start:.1f} s")

    # 15. classic NeRF ---------------------------------------------------------
    classic_phase(scene, dev)
    log("classic", f"total run {time.perf_counter() - t_start:.1f} s")

    # 16. LeRF -------------------------------------------------------------
    # the large-table kernels' launches in the kernels line: phase 14's
    # path and phase 16's training and serving together
    for k, v in lerf_phase(scene, dev).items():
        counts[k] += v
    log("lerf", f"total run {time.perf_counter() - t_start:.1f} s")

    # 17. real capture: the COLMAP path and the bbox refit -----------------
    # K1-K3's launches in the kernels line: phase 8's and phase 17's
    # COLMAP training together
    capture, psnr_capture = capture_phase(scene, dev, psnr_2100)
    log("capture", "phase 17 launches (cli train --dataset-type colmap, "
        "steps 0-2098): " + ", ".join(f"{k} {v}" for k, v in capture.items()))
    for k, v in capture.items():
        counts[k] += v
    log("capture", f"total run {time.perf_counter() - t_start:.1f} s")

    # 18. data parallelism -------------------------------------------------
    dp_phase(scene, dev, record)
    dp_dir.cleanup()
    log("dp", f"total run {time.perf_counter() - t_start:.1f} s")

    # 19. the stack's remaining options: LeRF-only, the normals head with
    # the train loop's trace, NDC rays (their launches are printed there)
    options_phase(scene, dev, record["run"])
    log("options", f"total run {time.perf_counter() - t_start:.1f} s")

    # 20. JPEG capture: the codec, and the flagship on a JPEG workspace
    # (its K1-K3 launches join the kernels line's)
    jpeg, psnr_jpeg = jpeg_phase(scene, dev, psnr_capture, t_start,
                                 FORMATS_MIN_S)
    log("jpeg", "phase 20 launches (cli train --dataset-type colmap on "
        "JPEG): " + ", ".join(f"{k} {v}" for k, v in jpeg.items()))
    for k, v in jpeg.items():
        counts[k] += v
    log("jpeg", f"total run {time.perf_counter() - t_start:.1f} s")

    # 21. progressive JPEG, PNG kinds and TIFF: the codecs, and the flagship
    # on a progressive JPEG + TIFF workspace (its K1-K3 launches join the
    # kernels line's)
    formats = formats_phase(scene, dev, {
        "phase 17's PNG capture": psnr_capture,
        "phase 20's JPEG capture": psnr_jpeg}, t_start)
    log("formats", "phase 21 launches (cli train --dataset-type colmap on "
        "progressive JPEG + TIFF): " + ", ".join(
            f"{k} {v}" for k, v in formats.items()))
    for k, v in formats.items():
        counts[k] += v
    log("formats", f"total run {time.perf_counter() - t_start:.1f} s")

    sources = {"window_lists": ("nerfpp_tpu_torch/csrc/window_lists.cu",
                                "nerfpp_tpu/pallas/hash_encode_blocked.py:140"),
               "encode_blocked": ("nerfpp_tpu_torch/csrc/encode_blocked.cu",
                                  "nerfpp_tpu/pallas/hash_encode_blocked.py:270"),
               "grad_blocked_index": (
                   "nerfpp_tpu_torch/csrc/grad_blocked.cu",
                   "nerfpp_tpu/pallas/hash_encode_blocked.py:451"),
               "grad_blocked": ("nerfpp_tpu_torch/csrc/grad_blocked.cu",
                                "nerfpp_tpu/pallas/hash_encode_blocked.py:451"),
               "encode_small": ("nerfpp_tpu_torch/csrc/encode_small.cu",
                                "nerfpp_tpu/pallas/hash_encode.py:127 and "
                                "nerfpp_tpu/pallas/hash_encode.py:48"),
               "grad_small": ("nerfpp_tpu_torch/csrc/grad_large.cu",
                              "nerfpp_tpu/encoders/hashgrid.py:334"),
               "encode_large": ("nerfpp_tpu_torch/csrc/encode_large.cu",
                                "nerfpp_tpu/encoders/hashgrid.py:408"),
               "grad_large_bins": ("nerfpp_tpu_torch/csrc/grad_large.cu",
                                   "nerfpp_tpu/encoders/hashgrid.py:408"),
               "grad_large": ("nerfpp_tpu_torch/csrc/grad_large.cu",
                              "nerfpp_tpu/encoders/hashgrid.py:408")}
    kernels = [dict(name=name, route="cuda", source=sources[name][0],
                    replaces=sources[name][1], launches=counts[name],
                    max_abs_err=s["max_abs_err"], ms=s["ms"],
                    plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
                    bound_by=s["bound_by"],
                    library_ms=s.get("library_ms"))
               for name, s in stats.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(last_line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
