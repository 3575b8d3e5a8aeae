#!/usr/bin/env python3
"""Kernel, serving-frame and train-step times of two trees in turns, one GPU.

    python3 profile_kernels.py [--parent DIR [--turns K]] [--variants]
                               [--train-only]

Without ``--parent``, one pass over this tree. With it, four passes in one
process each, in turns: DIR, this tree, this tree, DIR (DIR is another
checkout of the repo, for example the parent commit unpacked with
``git archive``), the four repeated K times with ``--turns K``. Each pass
imports chip_smoke.py and nerfpp_tpu_torch from its own tree and runs, with
that tree's functions (``--train-only``: the train steps alone):
  - kernel_phase (K1, K2) on chip_smoke.py's phase-3 point sets: one
    65,536-ray chunk of the 800x800 view at 64 samples (4,194,304 points),
    2^20 random points, and the 4,096-ray training chunk (262,144 points);
  - grad_phase (K3, its index build included) on the training chunk and
    the 2^20 random points;
  - small_kernel_phase (encode_small in every mode) on phase 9's point sets:
    the serving chunk (32,768 rays x 256 depths), 2^20 random points and the
    dense fine class of a train step (1,024 rays x 256), both schemes at T =
    2^13, and 2^20 random points at T = 2^15;
  - small_grad_phase (grad_small) on the dense fine class and 2^20 random
    points at T = 2^13, and on 2^20 random points at T = 2^15, both schemes;
  - large_kernel_phase and large_grad_phase (encode_large, grad_large) on
    phase 13's point sets at hashnerf_preset()'s table (16 x 2^19 f32):
    the serving chunk, the dense fine class, a train step's coarse pass and
    2^20 random points, both schemes (a tree without them skips this);
  - the serving frames of phases 5 and 12 from seeded random weights:
    hashnerf_blocked_preset with the sphere grid (1 + 5 frames) and
    hashnerf_tpu_preset (64 + 192 samples, 1 + 3 frames);
  - train steps on profile_train.py's 200x200 copy of the bench scene: the
    flagship of phase 8 in both regimes (warmup: full refresh and render;
    budget: phased refresh and the two-class budget) and the hashnerf_tpu
    run of phase 11; each trains 40 steps, then times 32 (one refresh) on
    the host clock with a synchronise at both ends.
``--variants`` (this tree only) also times encode_small's other launch plans
at the serving shapes: two of each group's four levels gathered from L2 and
all four (no stage, the simplest alternative), and groups of fewer levels
(row slices under a sector), on the packed and the f32 table and at T =
2^15. Each pass prints chip_smoke.py's log lines, then one JSON line of its
times; the last line is the card's name and power limit; before it, per time, the median of each tree's passes.
"""
import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path


def run_pass(tree: Path, variants: bool, train_only: bool) -> dict:
    sys.path.insert(0, str(tree))
    os.chdir(tree)
    import chip_smoke as C
    import torch
    # every tree's phases time with this tree's cuda_ms, so that both sides
    # of a comparison use one timer
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timer", Path(__file__).resolve().parent / "chip_smoke.py")
    timer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timer)
    C.cuda_ms = timer.cuda_ms
    from nerfpp_tpu_torch.config import (TrainParams, hashnerf_blocked_preset,
                                         hashnerf_tpu_preset)
    from nerfpp_tpu_torch.core.occupancy import OccupancyGrid
    from nerfpp_tpu_torch.encoders.hashgrid import HashGridEncoder
    from nerfpp_tpu_torch.executor import NeRFExecutor
    from nerfpp_tpu_torch.kernels import build
    from nerfpp_tpu_torch.kernels import hash_encode as KS
    assert Path(C.__file__).resolve().parent == tree.resolve()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    dev = torch.device("cuda")
    times = {}
    if train_only:
        train_window(C, dev, times)
        return times

    # phase-3 shapes: K1 and K2
    enc = HashGridEncoder(C.BBOX, 16, 2, 19, 16, 1024, use_kernel=True,
                          device=dev)
    gen = torch.Generator().manual_seed(C.SEED)
    table = (torch.rand(enc.table_rows, 2, generator=gen) * 2 - 1).to(dev)
    occ = OccupancyGrid(density=C.sphere_grid(128, 0.5, 10.0, dev))
    sets = {"chunk": C.chunk_points(enc, occ, 65536, 64, dev)}
    sets["random"] = (torch.rand(1 << 20, 3, generator=gen) * 2.4
                      - 1.2).to(dev)
    sets["train chunk"] = C.chunk_points(enc, occ, 4096, 64, dev)
    for label, pts in sets.items():
        s = C.kernel_phase(enc, table, pts, label)
        times[f"window_lists {label}"] = s["window_lists"]["ms"]
        times[f"encode_blocked {label}"] = s["encode_blocked"]["ms"]
    # phase-6 shapes: K3 (a tree before the order-fixed K3 returns its
    # stats alone)
    for label in ("train chunk", "random"):
        s = C.grad_phase(enc, sets[label], label)
        times[f"grad_blocked {label}"] = s.get("grad_blocked", s)["ms"]
    del sets, table

    # phase-9 shapes: encode_small
    gen = torch.Generator().manual_seed(C.SEED + 1)
    ro, rd = C.view_rays(32768, dev)
    def small(enc, table, pts, label):
        # the tree's own phase (packed) and the f32 table, timed alike
        times[f"encode_small {label}"] = C.small_kernel_phase(
            enc, table, pts, label.split(" ", 1)[1])["ms"]
        times[f"encode_small {label} f32 table"] = C.cuda_ms(
            lambda: KS.encode_small(table, pts, enc, False))

    def grad(enc, pts, label):
        times[f"grad_small {label}"] = C.small_grad_phase(
            enc, pts, label.split(" ", 1)[1])["ms"]

    for scheme in ("random", "fixed"):
        enc = C.small_encoder(scheme, 13, dev)
        table = (torch.rand(enc.table_rows, 2, generator=gen) * 2
                 - 1).to(dev)
        pts = C.depth_points(enc, ro, rd, 256)
        small(enc, table, pts, f"{scheme} serving chunk")
        if variants and scheme == "random":
            for m in (1 << 21, 1 << 22):
                small_variants(enc, table, pts[:m], False, (
                    ("three of four levels staged", 4, 3),
                    ("2 levels staged (16-byte slices)", 2, 2)))
            small_variants(enc, table, pts, True, (
                ("4 levels staged", 4, 4),
                ("two of four levels from L2", 4, 2),
                ("no stage, every level from L2", 4, 0),
                ("2 levels staged (16-byte slices)", 2, 2)))
            small_variants(enc, table, pts, False, (
                ("three of four levels staged", 4, 3),
                ("2 levels staged (16-byte slices)", 2, 2)))
        del pts
        pts = (torch.rand(1 << 20, 3, generator=gen) * 2.4 - 1.2).to(dev)
        small(enc, table, pts, f"{scheme} random points")
        grad(enc, pts, f"{scheme} random points")
        tro, trd = C.view_rays(1024, dev, seed=C.SEED + 2)
        dense = C.depth_points(enc, tro, trd, 256)
        if scheme == "random":
            small(enc, table, dense, "random dense fine class")
        grad(enc, dense, f"{scheme} dense fine class")
        del pts, table, dense
    enc = C.small_encoder("random", 15, dev)
    table = (torch.rand(enc.table_rows, 2, generator=gen) * 2 - 1).to(dev)
    if variants:
        small_variants(enc, table, C.depth_points(enc, ro, rd, 256), True, (
            ("one of four levels staged", 4, 1),
            ("1 level staged (8-byte slices)", 1, 1)))
    pts = (torch.rand(1 << 20, 3, generator=gen) * 2.4 - 1.2).to(dev)
    small(enc, table, pts, "T=2^15 random points")
    if variants:
        small_variants(enc, table, pts, True, (
            ("one of four levels staged", 4, 1),
            ("1 level staged (8-byte slices)", 1, 1)))
        small_variants(enc, table, pts, False, (
            ("4 levels from L2", 4, 0),
            ("1 level from L2 (8-byte slices)", 1, 0),
            ("16 levels from L2 (whole rows)", 16, 0)))
    for scheme in ("random", "fixed"):
        grad(C.small_encoder(scheme, 15, dev), pts,
             f"{scheme} T=2^15 random points")
    del pts, table
    torch.cuda.empty_cache()

    # phase-13 shapes: encode_large and grad_large
    if hasattr(C, "large_kernel_phase"):
        gen = torch.Generator().manual_seed(C.SEED + 11)
        cro, crd = C.view_rays(4096, dev, seed=C.SEED + 2)
        for scheme in ("random", "fixed"):
            enc = C.large_encoder(scheme, dev)
            table = (torch.rand(enc.table_rows, 2, generator=gen) * 2
                     - 1).to(dev)
            sets = {"serving chunk": C.depth_points(enc, ro, rd, 256),
                    "dense fine class": C.depth_points(enc, cro[:1024],
                                                       crd[:1024], 256),
                    "train coarse": C.depth_points(enc, cro, crd, 64),
                    "random points": (torch.rand(1 << 20, 3, generator=gen)
                                      * 2.4 - 1.2).to(dev)}
            for label, pts in sets.items():
                times[f"encode_large {scheme} {label}"] = (
                    C.large_kernel_phase(enc, table, pts, label)["ms"])
                if label != "serving chunk":
                    # a tree before the order-fixed gradient returns its
                    # stats alone
                    s = C.large_grad_phase(enc, pts, label)
                    times[f"grad_large {scheme} {label}"] = s.get(
                        "grad_large", s)["ms"]
            del sets, table
            torch.cuda.empty_cache()

    # phases 5 and 12: serving frames from seeded random weights
    k, pose = C.camera(800)
    for name, ex, tp, frames in (
            ("serve blocked", NeRFExecutor(hashnerf_blocked_preset(
                n_importance=0, use_occupancy_grid=True), device=dev),
             TrainParams(n_samples=64, chunk=65536), 6),
            ("serve tpu", NeRFExecutor(hashnerf_tpu_preset(), device=dev),
             TrainParams(), 4)):
        ex.initialize(C.BBOX, seed=C.SEED)
        if name == "serve blocked":
            ex.load_state({"occupancy": occ.density})
        frame_ms = []
        for _ in range(frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ex.render_view(pose, 800, 800, k, tp)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
        times[f"{name} frame median"] = statistics.median(frame_ms[1:])
        C.log("frames", f"{name}: 800x800 frames ms "
              f"{[round(t, 3) for t in frame_ms]}")
        del ex
        torch.cuda.empty_cache()
    train_window(C, dev, times)
    return times


def train_window(C, dev, times):
    """ms per train step over 32 steps after 40, for the flagship's two
    regimes and the hashnerf_tpu run, on a 200x200 copy of the bench scene
    (profile_train.py's configurations)."""
    import torch
    from nerfpp_tpu_torch.config import (TrainParams, hashnerf_blocked_preset,
                                         hashnerf_tpu_preset)
    from nerfpp_tpu_torch.data.dataset import RayBatchSampler
    from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
    from nerfpp_tpu_torch.executor import NeRFExecutor
    scene = make_synthetic_scene(n_train=16, n_val=1, n_test=1,
                                 image_hw=200, n_samples=64,
                                 white_bkgr=False, device=dev)
    tiled = RayBatchSampler.from_scene(scene, 4096, tile_h=8, tile_w=16,
                                       device=dev)
    untiled = RayBatchSampler.from_scene(scene, 4096, device=dev)
    for name, params, sampler, iters in (
            ("train blocked warmup", hashnerf_blocked_preset(
                n_importance=0, use_occupancy_grid=True,
                occ_update_every=32), tiled, 8100),
            ("train blocked budget", hashnerf_blocked_preset(
                n_importance=0, use_occupancy_grid=True, occ_update_every=32,
                occ_phased_warmup=0, occ_tile_budget_warmup=0), tiled, 8100),
            ("train tpu", hashnerf_tpu_preset(), untiled, 2000)):
        tp = TrainParams(n_samples=64, n_rand=4096, chunk=4096,
                         n_iters=iters, i_print=0, i_img=0, i_weights=0,
                         i_testset=0)
        ex = NeRFExecutor(params, device=dev)
        ex.initialize(scene.bounding_box, tp.lrate_decay, seed=C.SEED)
        ex.train(scene, tp, seed=C.SEED, sampler=sampler, steps=40)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.train(scene, tp, seed=C.SEED, sampler=sampler, steps=32)
        torch.cuda.synchronize()
        times[f"{name} step"] = (time.perf_counter() - t0) * 1e3 / 32
        C.log("train", f"{name}: steps {ex.step - 32}-{ex.step - 1} "
              f"{times[f'{name} step']:.4f} ms/step")
        del ex
        torch.cuda.empty_cache()


def small_variants(enc, table, pts, packed, plans):
    """encode_small's plans (label, G levels a group, S of them staged) at
    one shape, on the packed or the f32 table."""
    import torch
    from nerfpp_tpu_torch.kernels import hash_encode as KS
    tab = KS.pack_table_bf16(table) if packed else table
    ref = KS.encode_small_plain(tab, pts, enc, packed)
    n, nl = pts.shape[0], enc.n_levels
    for label, g, staged in plans:
        smem = (staged * enc.level_size * (4 if packed else 8)
                + KS.small_tile_bytes(g))
        ng = -(-nl // g)
        with torch.cuda.device(pts.device):
            blocks = KS._resident_blocks(KS._scheme_id(enc), packed, g,
                                         staged, smem)
        per_group = max(1, min(-(-n // KS.TILE), blocks // ng))
        plan = KS.SmallPlan(g, ng, staged, smem, per_group * ng)
        out = KS.encode_small_planned(tab, pts, enc, packed, plan)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ms = _ms(lambda: KS.encode_small_planned(tab, pts, enc, packed,
                                                 plan))
        _log("variants", f"encode_small T=2^{enc.log2_hashmap_size} "
             f"{'packed' if packed else 'f32 table'} {label} {plan}: N={n} "
             f"ms={ms:.4f} max_abs_err={err:.3g}")


def _ms(fn):
    import chip_smoke as C
    return C.cuda_ms(fn)


def _log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default="",
                    help="another tree, timed in turns with this one")
    ap.add_argument("--variants", action="store_true",
                    help="also time encode_small's other launch plans")
    ap.add_argument("--turns", type=int, default=1,
                    help="repeat the four passes of --parent this many times")
    ap.add_argument("--train-only", action="store_true",
                    help="time the train steps alone")
    ap.add_argument("--pass-tree", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    here = Path(__file__).resolve().parent
    if args.pass_tree:
        times = run_pass(Path(args.pass_tree).resolve(), args.variants,
                         args.train_only)
        print("PASS " + json.dumps(times), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("profile_kernels: CUDA is not available", file=sys.stderr)
        return 1
    trees = [here]
    if args.parent:
        parent = Path(args.parent).resolve()
        trees = [parent, here, here, parent] * args.turns
    results = []
    for i, tree in enumerate(trees):
        name = "change" if tree == here else "parent"
        _log("pass", f"{i + 1} of {len(trees)}: {name} ({tree})")
        cmd = [sys.executable, str(here / "profile_kernels.py"),
               "--pass-tree", str(tree)]
        if args.train_only:
            cmd.append("--train-only")
        if args.variants and tree == here and name == "change" and \
                not any(r[0] == "change" for r in results):
            cmd.append("--variants")
        proc = subprocess.run(cmd, capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            _log("pass", f"{name} pass failed with exit code "
                 f"{proc.returncode}")
            return 1
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("PASS ")][-1]
        results.append((name, json.loads(line[5:])))
    keys = list(results[0][1])
    _log("summary", "ms per launch, frame or step, passes in order: "
         + ", ".join(name for name, _ in results))
    for key in keys:
        _log("summary", f"{key}: " + " / ".join(
            f"{r.get(key, float('nan')):.4f}" for _, r in results))
        if len(results) > 1:
            _log("median", f"{key}: " + ", ".join(
                f"{side} " + format(statistics.median(
                    r[key] for n, r in results if n == side), ".4f")
                for side in ("parent", "change")))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
