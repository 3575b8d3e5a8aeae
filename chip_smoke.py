#!/usr/bin/env python3
"""GPU smoke run of nerfpp_tpu_torch, the PyTorch/CUDA port (one H100).

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; TF32 off for matrix products and convolutions.
  2. build: every CUDA kernel of the serving path from nerfpp_tpu_torch/csrc.
  3. kernels: each kernel against its plain PyTorch version at flagship
     shapes (16 levels, T = 2^19; one 65,536-ray chunk of the 800x800 view at
     64 samples, and 2^20 uniformly random points), with its median time over
     CUDA-event-timed launches, the plain version's time and its bound.
  4. parity: a 64x64 full-width render on the GPU (kernels) against the same
     state on the CPU (plain versions).
  5. serving: render_view of hashnerf_blocked_preset(n_importance=0,
     use_occupancy_grid=True) at full width, 800x800, 64 samples, auto
     two-class budget, 1 + 5 frames; the kernels' launch counts are reset
     just before and read just after.
The line before the last is the kernel summary JSON; the last line is
{"ok": true, "device": {...}}. Any failed check raises, and the script exits
non-zero; without CUDA, or without the nerfpp_tpu_torch package beside it, it
fails before printing a result.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
NONTENSOR_OPS_PER_S = 67e12    # H100 SXM f32 outside the tensor cores
BBOX = [-1.2, -1.2, -1.2, 1.2, 1.2, 1.2]
SEED = 0


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps=10, inner=10, warmup=3):
    """Median over ``reps`` of the CUDA-event time of ``inner`` back-to-back
    launches, divided by ``inner`` (ms)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
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
        stats[name] = dict(ms=ms, plain_ms=plain, max_abs_err=e,
                           bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops
                           else "operations")
        log("kernels", f"{label} {name}: N={n} ms={ms:.4f} "
            f"plain_ms={plain:.4f} bound_ms={max(t_bytes, t_ops):.4f} "
            f"(bytes {nbytes} -> {t_bytes:.4f} ms, ops {ops:.3g} -> "
            f"{t_ops:.4f} ms) max_abs_err={e:.3g}")
    log("kernels", f"{label}: mean windows per (group, level) "
        f"{mean_count:.2f}, touched table rows {touched} of "
        f"{nl * enc.block_slots}")
    return stats


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
    del pts_chunk, pts_rand

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
    for name, c in counts.items():
        if c == 0:
            raise AssertionError(f"{name} was not launched on the main path")
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
        + ", ".join(f"{k} {v / 6:.2f}" for k, v in counts.items())
        + f"; peak memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    log("serve", f"image: rgb mean {float(res.rgb.mean()):.4f}, acc mean "
        f"{float(res.acc.mean()):.4f}; total run "
        f"{time.perf_counter() - t_start:.1f} s")

    sources = {"window_lists": ("nerfpp_tpu_torch/csrc/window_lists.cu",
                                "nerfpp_tpu/pallas/hash_encode_blocked.py:140"),
               "encode_blocked": ("nerfpp_tpu_torch/csrc/encode_blocked.cu",
                                  "nerfpp_tpu/pallas/hash_encode_blocked.py:270")}
    kernels = [dict(name=name, route="cuda", source=sources[name][0],
                    replaces=sources[name][1], launches=counts[name],
                    max_abs_err=s["max_abs_err"], ms=s["ms"],
                    plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
                    bound_by=s["bound_by"], library_ms=None)
               for name, s in stats.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
