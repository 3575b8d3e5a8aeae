"""Rank bodies for tests/test_torch_parallel.py and
tests/test_torch_parallel_cli.py.

``nerfpp_tpu_torch.parallel.mesh.launch`` runs module-level functions in
spawned processes, and a spawned child imports the module its target lives
in: so these live here, in a module that imports no JAX (a child that
imports JAX pays seconds for it). Each case builds a tiny executor on the
CPU and returns numpy results; the test compares them with the JAX package
and with the port's single device.
"""
import functools
import tempfile
import time

import numpy as np
import torch

from nerfpp_tpu_torch.config import (TrainParams, hashnerf_blocked_preset,
                                     hashnerf_preset)
from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
from nerfpp_tpu_torch.executor import NeRFExecutor


@functools.lru_cache(maxsize=None)
def scene_of(hw=16, n_train=2):
    return make_synthetic_scene(n_train=n_train, n_val=1, n_test=1,
                                image_hw=hw, n_samples=16, white_bkgr=False,
                                device="cpu")


def snapshot(ex):
    """Parameters, Adam moments and count, occupancy grid (numpy)."""
    out = {}
    for k, v in ex.named_parameters().items():
        out[f"param {k}"] = v.detach().numpy().copy()
        out[f"mu {k}"] = ex.optimizer.mu[k].numpy().copy()
        out[f"nu {k}"] = ex.optimizer.nu[k].numpy().copy()
    out["adam count"] = ex.optimizer.count.numpy().copy()
    if ex.occupancy is not None:
        out["occupancy"] = ex.occupancy.density.numpy().copy()
    return out


def executor(preset, bbox, state=None, white_bkgr=False, blocked=False):
    make = hashnerf_blocked_preset if blocked else hashnerf_preset
    ex = NeRFExecutor(make(**preset), device="cpu")
    ex.white_bkgr = white_bkgr
    ex.initialize(bbox, TrainParams().lrate_decay, seed=0)
    if state is not None:
        ex.load_state({k: torch.from_numpy(v) for k, v in state.items()})
    return ex


def one_step(case, mesh=None):
    """One train step from a carried state on a given batch (no draws)."""
    ex = executor(case["preset"], case["bbox"], case["state"])
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    m = ex._build_train_step(TrainParams(**case["tp"]), mesh)(case["step"],
                                                             batch)
    out = {k: float(v) for k, v in m.items()}
    out["grads"] = {k: v.grad.numpy().copy()
                    for k, v in ex.named_parameters().items()}
    out["state"] = snapshot(ex)
    return out


def train_steps(case, mesh=None):
    """``steps`` steps of ``train`` from seed 0 on a tiny synthetic scene:
    the loss of every step and the state after the last."""
    scene = scene_of(case.get("hw", 16))
    ex = executor(case["preset"], scene.bounding_box)
    losses = []
    lang = None
    if case.get("lang_dim"):
        lang = np.random.RandomState(3).standard_normal(
            (2, scene.views[0].h, scene.views[0].w, case["lang_dim"])
        ).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        ex.train(scene, TrainParams(**case["tp"], i_print=1, i_img=0,
                                    i_weights=0, i_testset=0, base_dir=tmp),
                 steps=case["steps"], mesh=mesh, lang_embeddings=lang,
                 progress_fn=lambda i, m: losses.append(m["loss"]))
    return {"losses": losses, "state": snapshot(ex)}


def render_views(case, mesh=None):
    """render_views of the case's poses (a planted grid, seed-0 weights):
    the 8-bit frames and depths, and the list's dense fraction; without a
    mesh the sequential renders given that fraction."""
    ex = executor(case["preset"], case["bbox"], case["state"], blocked=True)
    tp = TrainParams(**case["tp"])
    k, hw, poses = case["k"], case["hw"], case["poses"]
    frac = ex._auto_dense_frac(hw, hw, k, poses)
    if mesh is None:
        outs = [ex.render_view(p, hw, hw, k, tp, dense_frac=frac)
                for p in poses]
    else:
        outs = ex.render_views(poses, hw, hw, k, tp, mesh=mesh)
    return {"frac": frac,
            "rgb8": [o["rgb8"].numpy() for o in outs],
            "depth": [o["nerf"].depth.numpy() for o in outs],
            "near_far": [(float(o["near_far"][0]), float(o["near_far"][1]))
                         for o in outs]}


def run_cases(mesh, cases):
    """Each case ({"fn": name, ...}) on this rank, in order; rank 0 then
    runs each case marked ``reference`` on its own (no mesh) too."""
    torch.set_num_threads(1)
    fns = {"one_step": one_step, "train_steps": train_steps,
           "render_views": render_views}
    out = {"mesh": [fns[c["fn"]](c, mesh) for c in cases]}
    if mesh.rank == 0:
        out["single"] = [fns[c["fn"]](c, None) if c.get("reference")
                         else None for c in cases]
    return out


def fails(mesh):
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails")
    mesh.barrier()


def hangs(mesh):
    time.sleep(600)
