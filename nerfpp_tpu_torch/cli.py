"""Command-line interface of the port (the counterpart of
nerfpp_tpu/cli.py): the same subcommands, flags, presets and JSON overrides,
plus ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).

  python -m nerfpp_tpu_torch.cli train --dataset-type blender --data-dir <dir> \\
      --preset hashnerf --base-dir out [--executor-params p.json] \\
      [--train-params tp.json] [--set learning_rate=1e-2] [--set-train NIters=8100]
  python -m nerfpp_tpu_torch.cli render --dataset-type blender --data-dir <dir> \\
      --preset hashnerf --base-dir out [--spherical-path --n-poses 40]

``train`` trains, saves the final checkpoint and writes the three JSON
configs (executor_params.json, executor_train_params.json, data.json) to
the base directory; ``render`` restores the latest checkpoint (ft_path, by
default the base directory) and writes {i,disp_i,depth_i}.png to
<base>/renders. The ``bench`` subcommand is not ported yet and raises.

``--n-devices N`` other than 1 runs data-parallel (parallel/mesh.py): N
processes, one a device (NCCL on cuda:0 .. N-1, or gloo with ``--device
cpu``), each loading the scene and building its executor; ``train``
shards every step's rays over them and sums the gradients
(``dp_grad_reduce``), ``render`` renders the views view-parallel; rank 0
alone writes. N = 0 means every visible card (with ``--device cpu`` give
the count). NRand must divide by N.

``--dataset-type colmap --data-dir <workspace>`` reads a COLMAP workspace
(sparse/0 in .bin or .txt, images under images/ in any format that
utils/image.py ``read_image`` reads: PNG, JPEG, TIFF, BMP, the portable
formats, HDR, Sun raster or WebP): distorted views are undistorted on
``--device`` into <workspace>/undistorted (a JPEG re-encoded at quality 95,
a WebP written lossless, as the JAX package's cv2.imwrite does), and views
of other sizes than the first are resized to it when training. With
``--set-train BboxRefitStep=N`` (and an occupancy grid) training shrinks
the loader's box to the field's mass at step N.

With ``--set use_lerf=true``, ``train`` builds the CLIP pyramid of the
training views (a local CLIP checkpoint at ``path_to_clip``, else the
deterministic stand-in encoder; cached as pyramid_embeddings.npz) and sets
the prompts ``lerf_positives`` / ``lerf_negatives``, so its test-split
renders write relevancy_{i}.png. ``render`` sets no prompts, as the JAX
package's does: it writes no relevancy PNG. ``--set use_nerf=false --set
use_lerf=true`` trains and renders the language field alone (a LeRF-only
stack: no rgb, disparity or depth PNGs).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from nerfpp_tpu_torch.executor import _not_ported


def _apply_overrides(obj, pairs, keymap_reverse=None):
    for pair in pairs or []:
        k, _, v = pair.partition("=")
        field = k
        if keymap_reverse and k in keymap_reverse:
            field = keymap_reverse[k]
        if not hasattr(obj, field):
            raise SystemExit(f"unknown config field: {k}")
        cur = getattr(obj, field)
        if isinstance(cur, bool):
            val = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            val = int(v)
        elif isinstance(cur, float):
            val = float(v)
        elif isinstance(cur, list):
            val = json.loads(v)
        else:
            val = v
        setattr(obj, field, val)
    return obj


def _n_devices(args) -> int:
    """The ranks --n-devices asks for: 0 means every visible card; more
    than there are raises (never fewer)."""
    n = args.n_devices
    if n == 1:
        return 1
    if n < 0:
        raise SystemExit(f"--n-devices {n}: give a count, or 0 for every "
                         "visible card")
    if args.device == "cpu":
        if n == 0:
            raise SystemExit("--n-devices 0 means every visible card; with "
                             "--device cpu give the number of processes")
        return n
    import torch
    avail = torch.cuda.device_count()
    n = n or avail
    if n > avail or n == 0:
        raise SystemExit(f"--n-devices {args.n_devices}: {avail} CUDA "
                         "device(s) visible")
    return n


def _run(fn, args) -> None:
    """``fn(None, args)`` in this process at one device, else
    ``fn(mesh, args)`` on --n-devices ranks (parallel/mesh.py
    ``launch``)."""
    n = _n_devices(args)
    if n == 1:
        fn(None, args)
        return
    from nerfpp_tpu_torch.parallel import mesh as mesh_utils
    print(f"data-parallel over {n} ranks ({args.device})")
    mesh_utils.launch(fn, n, args.device, args, timeout=None)


def _in_turn(mesh, fn):
    """``fn()`` on each rank, one rank after another (what it writes, the
    next rank reads: the COLMAP loader's undistorted views, the CLIP
    pyramid's cache)."""
    if mesh is None:
        return fn()
    out = None
    for r in range(mesh.world):
        if r == mesh.rank:
            out = fn()
        mesh.barrier()
    return out


def _load_scene(args, device):
    from nerfpp_tpu_torch.data.blender import load_blender_data
    from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
    if args.dataset_type == "blender":
        return load_blender_data(args.data_dir, half_res=args.half_res,
                                 testskip=args.test_skip,
                                 white_bkgr=args.white_bkgr)
    if args.dataset_type == "colmap":
        from nerfpp_tpu_torch.data.colmap import \
            load_from_colmap_reconstruction
        scene = load_from_colmap_reconstruction(args.data_dir,
                                                device=device)
        scene.white_bkgr = args.white_bkgr
        return scene
    if args.dataset_type == "synthetic":
        return make_synthetic_scene(white_bkgr=args.white_bkgr,
                                    device=device)
    raise SystemExit(f"unknown dataset type {args.dataset_type}")


def _build_params(args):
    from nerfpp_tpu_torch.config import (ExecutorParams, TrainParams,
                                         classic_nerf_preset,
                                         hashnerf_blocked_preset,
                                         hashnerf_preset, hashnerf_tpu_preset)
    presets = {"hashnerf": hashnerf_preset,
               "hashnerf_blocked": hashnerf_blocked_preset,
               "hashnerf_tpu": hashnerf_tpu_preset,
               "classic": classic_nerf_preset, "none": ExecutorParams}
    if args.executor_params:
        p = ExecutorParams.load(args.executor_params)
    else:
        p = presets[args.preset]()
    tp = (TrainParams.load(args.train_params) if args.train_params
          else TrainParams())
    if getattr(args, "base_dir", None):
        tp.base_dir = args.base_dir
    _apply_overrides(p, args.set)
    rev = {v: k for k, v in TrainParams.KEYMAP.items()}
    _apply_overrides(tp, args.set_train, rev)
    return p, tp


def _build_lerf_supervision(scene, p, tp, device="cuda"):
    """The CLIP pyramid of the training views (cached or computed, on
    ``device``) as a DevicePyramid of the training lookup scale 0.5, and
    the text encoder of the prompts: a real CLIP checkpoint when
    path_to_clip is set, else the random-projection stand-in."""
    from nerfpp_tpu_torch.data.dataset import load_images
    from nerfpp_tpu_torch.data.pyramid_clip import (
        PyramidEmbedderProperties, RandomProjectionPatchEncoder,
        compute_or_load_pyramid, load_clip_encoder, make_device_pyramid)
    if p.path_to_clip:
        encode_images, encode_text = load_clip_encoder(p.path_to_clip,
                                                       device)
    else:
        stub = RandomProjectionPatchEncoder(embed_dim=p.lang_embed_dim)
        encode_images, encode_text = stub, stub.encode_text
    props = PyramidEmbedderProperties(
        img_size=p.clip_input_img_size, overlap=p.pyr_embedder_overlap,
        max_zoom_out=max(p.pyr_embed_min_zoom_out, 1))
    images = load_images(scene, list(scene.split_indices("train")),
                         device=device)
    # a smaller window where the images are smaller than twice the input
    if min(images.shape[1:3]) < props.img_size * 2:
        props.img_size = max(8, min(images.shape[1:3]) // 4)
    cache = (Path(tp.pyramid_clip_embedding_save_dir or tp.base_dir)
             / "pyramid_embeddings.npz")
    pyramid = compute_or_load_pyramid(images, encode_images, props, cache,
                                      device)
    return make_device_pyramid(pyramid, 0.5, device), encode_text


def cmd_train(args) -> None:
    n = _n_devices(args)
    _, tp = _build_params(args)
    if tp.n_rand % n:
        raise SystemExit(f"NRand ({tp.n_rand}) must divide by the device "
                         f"count ({n}) for data parallelism")
    _run(_train, args)


def _train(mesh, args) -> None:
    from nerfpp_tpu_torch.executor import NeRFExecutor
    device = args.device if mesh is None else mesh.device
    root = mesh is None or mesh.rank == 0
    scene = _in_turn(mesh, lambda: _load_scene(args, device))
    p, tp = _build_params(args)
    ex = NeRFExecutor(p, device=device)
    base_dir = Path(tp.base_dir)
    if root:
        base_dir.mkdir(parents=True, exist_ok=True)
    lang_embeddings = None
    if p.use_lerf:
        lang_embeddings, encode_text = _in_turn(
            mesh, lambda: _build_lerf_supervision(scene, p, tp, device))
        ex.set_clip_encoder(encode_text)
        if p.lerf_positives:
            ex.set_lerf_prompts(p.lerf_positives, p.lerf_negatives)
    ex.train(scene, tp, lang_embeddings=lang_embeddings, mesh=mesh)
    if not root:
        return
    ex.save_checkpoint(base_dir)
    # the three configs, as the reference saves them
    p.save(base_dir / "executor_params.json")
    tp.save(base_dir / "executor_train_params.json")
    scene.save(base_dir / "data.json")
    print(f"done; artifacts in {base_dir}")


def cmd_render(args) -> None:
    _run(_render, args)


def _render(mesh, args) -> None:
    from nerfpp_tpu_torch.core.rays import pose_spherical
    from nerfpp_tpu_torch.executor import NeRFExecutor
    device = args.device if mesh is None else mesh.device
    scene = _in_turn(mesh, lambda: _load_scene(args, device))
    p, tp = _build_params(args)
    if not p.ft_path:
        p.ft_path = tp.base_dir
    ex = NeRFExecutor(p, device=device)
    ex.white_bkgr = scene.white_bkgr
    ex.initialize(scene.bounding_box, tp.lrate_decay)
    v0 = scene.views[0]
    if args.spherical_path:
        poses = [pose_spherical(th, -30.0, 4.0)
                 for th in np.linspace(-180, 180, args.n_poses,
                                       endpoint=False)]
    else:
        poses = ([scene.views[i].pose for i in scene.split_indices("test")]
                 or [v.pose for v in scene.views[:args.n_poses]])
    out_dir = Path(tp.base_dir) / "renders"
    ex.render_path(poses, v0.h, v0.w, v0.k, tp, out_dir, mesh=mesh)
    if mesh is None or mesh.rank == 0:
        print(f"wrote {len(poses)} renders to {out_dir}")


def cmd_bench(args) -> None:
    raise _not_ported("the bench subcommand")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="nerfpp_tpu_torch",
                                 description="NeRF/HashNeRF on PyTorch and "
                                 "CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(s):
        s.add_argument("--dataset-type", default="synthetic",
                       choices=["blender", "colmap", "synthetic"],
                       help="blender: a Blender export; colmap: a COLMAP "
                       "workspace (sparse/0, images in any format that "
                       "utils/image.py read_image reads); "
                       "synthetic: the generated scene")
        s.add_argument("--data-dir", default="")
        s.add_argument("--half-res", action="store_true")
        s.add_argument("--test-skip", action="store_true")
        s.add_argument("--white-bkgr", action="store_true")
        s.add_argument("--preset", default="hashnerf",
                       choices=["hashnerf", "hashnerf_blocked", "hashnerf_tpu",
                                "classic", "none"])
        s.add_argument("--executor-params", default="")
        s.add_argument("--train-params", default="")
        s.add_argument("--n-devices", type=int, default=1, metavar="N",
                       help="data-parallel ranks, one a device (0: every "
                       "visible card)")
        s.add_argument("--base-dir", default="output")
        s.add_argument("--set", action="append", metavar="FIELD=VALUE",
                       help="override an ExecutorParams field")
        s.add_argument("--set-train", action="append", metavar="FIELD=VALUE",
                       help="override a TrainParams field (JSON key names ok)")
        s.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="cuda (the kernels) or cpu (plain PyTorch)")

    t = sub.add_parser("train", help="train a radiance field")
    common(t)
    t.set_defaults(fn=cmd_train)

    r = sub.add_parser("render", help="render a trained field")
    common(r)
    r.add_argument("--spherical-path", action="store_true")
    r.add_argument("--n-poses", type=int, default=40)
    r.set_defaults(fn=cmd_render)

    b = sub.add_parser("bench", help="run the benchmark (not ported)")
    b.set_defaults(fn=cmd_bench)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
