"""bench.py's LeRF relevancy section (bench.py:459-549) over seeds, on the
JAX package (the reference, on the CPU) or on the PyTorch port (on the CPU
or the card).

    JAX_PLATFORMS=cpu python scripts/lerf_relevancy.py --package jax \
        --seeds 0 1
    python3 scripts/lerf_relevancy.py --package port --device cuda \
        --seeds 0 1 2 3 --dtypes bfloat16 float32

The 128 px synthetic scene (8 views), the 24-d random-projection stand-in
pyramid, hashnerf_preset(use_lerf=True) at bench.py's widths with 32 + 16
samples, 1,000 steps of 2,048 rays; the relevancy of the blue prim's flat
patch against the red prim's and black on the held-out view, scored as
bench.py scores it: the Mann-Whitney AUC with midranks (0.5 for a constant
map) and IoU at 0.5 against the blue prim's colour mask. Prints one line
a run, with the card's name and power limit first on the card.
chip_smoke.py's phase 16 (f) runs the port's seed 0 in bfloat16 on the card.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BLUE = np.array([0.2, 0.5, 0.9], np.float32)
RED = np.array([0.9, 0.25, 0.2], np.float32)
PRESET = dict(n_importance=16, hier_ray_tile=0, hier_tile_budget_frac=0.0,
              log2_hashmap_size=14, n_levels=8, finest_resolution=128,
              use_lerf=True, lang_embed_dim=24, n_levels_le=4,
              log2_hashmap_size_le=12, finest_resolution_le=64)
TRAIN = dict(n_samples=32, n_rand=2048, n_iters=1001, chunk=2048,
             i_print=0, i_weights=0, i_testset=0, i_img=0,
             steps_per_call=50)


def score(rel, mask):
    from scipy.stats import rankdata
    r, m = rel.ravel(), mask.ravel()
    ranks = rankdata(r, method="average")
    n_pos, n_neg = int(m.sum()), int((~m).sum())
    auc = ((ranks[m].sum() - n_pos * (n_pos + 1) / 2.0)
           / max(n_pos * n_neg, 1))
    iou = (float(np.logical_and(rel > 0.5, mask).sum())
           / max(float(np.logical_or(rel > 0.5, mask).sum()), 1.0))
    return float(auc), iou


def run(package, seed, base_dir, device="cpu", dtype="bfloat16"):
    if package == "jax":
        from nerfpp_tpu.config import TrainParams, hashnerf_preset
        from nerfpp_tpu.data import pyramid_clip as P
        from nerfpp_tpu.data.synthetic import make_synthetic_scene
        from nerfpp_tpu.executor import NeRFExecutor
        scene = make_synthetic_scene(n_train=8, n_val=1, n_test=1,
                                     image_hw=128, white_bkgr=False,
                                     n_samples=64)
        kw = {}
    else:
        from nerfpp_tpu_torch.config import TrainParams, hashnerf_preset
        from nerfpp_tpu_torch.data import pyramid_clip as P
        from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
        from nerfpp_tpu_torch.executor import NeRFExecutor
        scene = make_synthetic_scene(n_train=8, n_val=1, n_test=1,
                                     image_hw=128, white_bkgr=False,
                                     n_samples=64, device=device)
        kw = {"device": device}
    enc = P.RandomProjectionPatchEncoder(embed_dim=24, input_size=8)
    emb = P.PyramidEmbedder(enc, P.PyramidEmbedderProperties(
        img_size=16, overlap=0.5, max_zoom_out=1), **kw)(
        scene.images[list(scene.split_indices("train"))])
    pyramid = P.make_device_pyramid(emb, 0.5, **kw)

    def patch(c):
        return np.broadcast_to(c, (1, 16, 16, 3)).astype(np.float32)

    tp = TrainParams(base_dir=base_dir, **TRAIN)
    ex = NeRFExecutor(hashnerf_preset(compute_dtype=dtype, **PRESET), **kw)
    ex.white_bkgr = scene.white_bkgr
    ex.initialize(scene.bounding_box, tp.lrate_decay, seed=seed)
    ex.set_lerf_prompts(enc(patch(BLUE)), np.concatenate(
        [enc(patch(RED)), enc(patch(np.zeros(3, np.float32)))]))
    m = ex.train(scene, tp, seed=seed, lang_embeddings=pyramid)
    v = scene.views[list(scene.split_indices("test"))[0]]
    out = ex.render_view(v.pose, v.h, v.w, v.k, tp)["lerf"]
    rel = np.asarray(out.relevancy if package == "jax"
                     else out.relevancy.cpu())[..., 0]
    mask = np.linalg.norm(np.asarray(scene.images[v.id]) - BLUE,
                          axis=-1) < 0.25
    return score(rel, mask), float(m["lang_loss"]), rel


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu",
                    help="the port's device (the JAX package runs on the CPU)")
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16"],
                    choices=("bfloat16", "float32"),
                    help="the MLPs' compute_dtype (the preset's: bfloat16)")
    ap.add_argument("--base-dir", default="output/lerf_relevancy")
    args = ap.parse_args()
    if args.package == "jax":
        import os
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        jax.config.update("jax_platforms", "cpu")
        if args.device != "cpu" or args.dtypes != ["bfloat16"]:
            ap.error("the JAX package runs here on the CPU in bfloat16")
    elif args.device == "cuda":
        import subprocess
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    for dtype in args.dtypes:
        for seed in args.seeds:
            t0 = time.perf_counter()
            (auc, iou), lang_loss, rel = run(args.package, seed,
                                             args.base_dir, args.device,
                                             dtype)
            print(f"{args.package} ({args.device}, {dtype}) seed {seed}: "
                  f"relevancy AUC {auc:.4f}, IoU@0.5 {iou:.4f}, range "
                  f"[{rel.min():.4f}, {rel.max():.4f}]; last lang_loss "
                  f"{lang_loss:.5f}; {time.perf_counter() - t0:.1f} s",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
