#!/usr/bin/env python3
"""Where the time of one full-width train step goes, on one GPU.

    python3 profile_train.py [--preset blocked|tpu|hashnerf|lerf] [--steps 8]
                             [--trace train_trace.json]

Builds a training configuration of chip_smoke.py on a 200x200 copy of the
synthetic bench scene (the step samples 4,096 rays whatever the image size).
``blocked`` (the default) is the flagship of phase 8 (hashnerf_blocked_preset
with n_importance=0, the 128^3 occupancy grid refreshed every 32 steps,
NRand 4096 in 8x16 tiles, 64 samples), in two regimes:

- warmup: full refresh and full render, as before step 1,024;
- budget: phased refresh and the two-class budget, as after step 1,024
  (a second executor whose warmups end at step 0).

``tpu`` is the README's run of phase 11 (hashnerf_tpu_preset: 64 coarse
samples on every ray, the coarse-ranked fine budget 0.25 / 16 of 192
importance samples, untiled NRand 4096), one regime, ``hier``;
``hashnerf`` the same run of hashnerf_preset() (phase 14: the 16 x 2^19 f32
table through the large-table kernels), one regime, ``large``; ``lerf``
the same with the language field (hashnerf_preset(use_lerf=True), E = 768,
against the stand-in CLIP pyramid of the scene as ``cli train`` builds it),
one regime, ``lerf``.

Each regime trains 40 steps (one refresh at step 32), then:

1. ``--steps`` steps under torch.profiler: wall time per step, the device's
   busy time (sum of its kernels, copies and memsets), the idle share, the
   device kernels per step, and the 15 kernels with the most device time;
2. 32 steps (one refresh) with a synchronise around each part of the step
   (batch, refresh, render forward, backward, Adam): the wall time of each
   part alone and its calls per step, which shows whether the host or the
   device sets it.

Needs a CUDA device.
"""
import argparse
import subprocess
import sys
import tempfile
import time

import chip_smoke as C


def split_timer(ex, store):
    """Wrap the parts of the train step with synchronised host timers;
    returns a function that takes the wrappers off again."""
    import torch
    import nerfpp_tpu_torch.executor as E
    saved = [(E, k, getattr(E, k)) for k in (
        "update_grid", "update_grid_phased", "render_ray_batch",
        "render_ray_batch_budgeted", "render_ray_batch_hier_budgeted")]
    saved += [(E.RayBatchSampler, "sample", E.RayBatchSampler.sample),
              (torch.Tensor, "backward", torch.Tensor.backward)]

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            t_n = store.setdefault(name, [0.0, 0])
            t_n[0] += time.perf_counter() - t
            t_n[1] += 1
            return out
        return run

    E.update_grid = timed("refresh", E.update_grid)
    E.update_grid_phased = timed("refresh", E.update_grid_phased)
    E.render_ray_batch = timed("render forward", E.render_ray_batch)
    E.render_ray_batch_budgeted = timed("render forward",
                                        E.render_ray_batch_budgeted)
    E.render_ray_batch_hier_budgeted = timed(
        "render forward", E.render_ray_batch_hier_budgeted)
    E.RayBatchSampler.sample = timed("batch", E.RayBatchSampler.sample)
    torch.Tensor.backward = timed("backward", torch.Tensor.backward)
    ex.optimizer.step = timed("adam", ex.optimizer.step)

    def restore():
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    return restore


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", choices=("blocked", "tpu", "hashnerf",
                                         "lerf"), default="blocked")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--trace", default="",
                    help="write a Chrome trace of the budget regime here")
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_train: CUDA is not available", file=sys.stderr)
        return 1
    from nerfpp_tpu_torch.config import (TrainParams, hashnerf_blocked_preset,
                                         hashnerf_preset, hashnerf_tpu_preset)
    from nerfpp_tpu_torch.data.dataset import RayBatchSampler
    from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
    from nerfpp_tpu_torch.executor import NeRFExecutor
    from nerfpp_tpu_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build.build_all()
    dev = torch.device("cuda")
    scene = make_synthetic_scene(n_train=16, n_val=1, n_test=1,
                                 image_hw=200, n_samples=64,
                                 white_bkgr=False, device=dev)
    tp = TrainParams(n_samples=64, n_rand=4096, chunk=4096,
                     n_iters=8100 if args.preset == "blocked" else 2000,
                     i_print=0, i_img=0, i_weights=0, i_testset=0)
    n = args.steps
    if args.preset == "blocked":
        sampler = RayBatchSampler.from_scene(scene, tp.n_rand, tile_h=8,
                                             tile_w=16, device=dev)
        regimes = [(r, hashnerf_blocked_preset(
            n_importance=0, use_occupancy_grid=True, occ_update_every=32,
            **warm)) for r, warm in (
                ("warmup", {}), ("budget", dict(occ_phased_warmup=0,
                                                occ_tile_budget_warmup=0)))]
    elif args.preset == "lerf":
        from nerfpp_tpu_torch.cli import _build_lerf_supervision
        params = hashnerf_preset(use_lerf=True)
        pyr, _ = _build_lerf_supervision(
            scene, params, TrainParams(base_dir=tempfile.mkdtemp()), dev)
        sampler = RayBatchSampler.from_scene(scene, tp.n_rand, device=dev,
                                             pyramid=pyr)
        regimes = [("lerf", params)]
    else:
        sampler = RayBatchSampler.from_scene(scene, tp.n_rand, device=dev)
        regimes = [("hier", hashnerf_tpu_preset()) if args.preset == "tpu"
                   else ("large", hashnerf_preset())]
    for regime, params in regimes:
        ex = NeRFExecutor(params, device=dev)
        ex.initialize(scene.bounding_box, tp.lrate_decay, seed=C.SEED)
        ex.train(scene, tp, seed=C.SEED, sampler=sampler, steps=40)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ex.train(scene, tp, seed=C.SEED, sampler=sampler, steps=n)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        if args.trace and regime == regimes[-1][0]:
            prof.export_chrome_trace(args.trace)
        work = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in work) / 1e3 / n
        print(f"[profile] {regime} | {smi} | steps {ex.step - n}-"
              f"{ex.step - 1} | wall {wall_ms:.3f} ms/step | device busy "
              f"{busy_ms:.3f} ms/step | idle share "
              f"{max(0.0, 1 - busy_ms / wall_ms):.4f} | device events "
              f"{len(work) / n:.1f} per step")
        kern = [a for a in prof.key_averages()
                if a.device_type == DeviceType.CUDA]
        kern.sort(key=lambda a: a.self_device_time_total, reverse=True)
        for a in kern[:15]:
            ms = a.self_device_time_total / 1e3 / n
            print(f"[profile]   {regime} {ms:8.3f} ms/step "
                  f"{a.count / n:7.1f}x  {a.key[:90]}")
        parts = {}
        restore = split_timer(ex, parts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.train(scene, tp, seed=C.SEED, sampler=sampler, steps=32)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3 / 32
        print(f"[split] {regime} | steps {ex.step - 32}-{ex.step - 1} | "
              f"synchronised step {total:.3f} ms | "
              + " | ".join(f"{k} {t * 1e3 / c:.3f} ms x {c / 32:.3f}/step"
                           for k, (t, c) in parts.items()))
        restore()
    return 0


if __name__ == "__main__":
    sys.exit(main())
