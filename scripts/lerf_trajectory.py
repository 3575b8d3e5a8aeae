"""The JAX package's and the port's LeRF training side by side on the CPU:
the same converted state, the same batches, many steps.

    JAX_PLATFORMS=cpu python scripts/lerf_trajectory.py [--steps 150]
                                                        [--dtype float32]

bench.py's LeRF quality configuration (bench.py:459-549: 128 px, 8 views,
24-d stand-in pyramid, 32 + 16 samples, 2,048 rays) with thin rays and
n_iters 8, so that from step 2 on no step draws anything but its batch
(the density noise ends at n_iters / 8, the preconditioning noise at
n_iters / 6; the learning rate follows lrate_decay, not n_iters). Each
step's batch is the JAX sampler's; the port takes it as a dict. Every 10
steps prints both losses and language losses and, per parameter group,
the largest parameter difference over the largest JAX parameter.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PRESET = dict(n_importance=16, hier_ray_tile=0, hier_tile_budget_frac=0.0,
              log2_hashmap_size=14, n_levels=8, finest_resolution=128,
              use_lerf=True, lang_embed_dim=24, n_levels_le=4,
              log2_hashmap_size_le=12, finest_resolution_le=64,
              thin_ray=True)
TRAIN = dict(n_samples=32, n_rand=2048, n_iters=8, chunk=2048, i_print=0,
             i_weights=0, i_testset=0, i_img=0)
FIRST = 2                            # the first step that draws nothing


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    args = ap.parse_args()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    from nerfpp_tpu import config as JC
    from nerfpp_tpu.data import dataset as JD
    from nerfpp_tpu.data import pyramid_clip as JP
    from nerfpp_tpu.data.synthetic import make_synthetic_scene
    from nerfpp_tpu.executor import NeRFExecutor as JaxExecutor
    from nerfpp_tpu_torch.config import TrainParams, hashnerf_preset
    from nerfpp_tpu_torch.convert import state_from_jax
    from nerfpp_tpu_torch.executor import NeRFExecutor

    scene = make_synthetic_scene(n_train=8, n_val=1, n_test=1, image_hw=128,
                                 white_bkgr=False, n_samples=64)
    emb = JP.PyramidEmbedder(
        JP.RandomProjectionPatchEncoder(embed_dim=24, input_size=8),
        JP.PyramidEmbedderProperties(img_size=16, overlap=0.5,
                                     max_zoom_out=1))(
        scene.images[list(scene.split_indices("train"))])
    tp = JC.TrainParams(**TRAIN)
    jx = JaxExecutor(JC.hashnerf_preset(compute_dtype=args.dtype, **PRESET))
    jx.initialize(scene.bounding_box, tp.lrate_decay, seed=0)
    sampler = JD.RayBatchSampler.from_scene(
        scene, tp.n_rand, pyramid=JP.make_device_pyramid(emb, 0.5))
    jax_step = jx._build_train_step(tp)
    tx = NeRFExecutor(hashnerf_preset(compute_dtype=args.dtype, **PRESET),
                      device="cpu")
    tx.initialize(scene.bounding_box, tp.lrate_decay, seed=0)

    def port_state(params):
        return state_from_jax(jax.tree.map(np.asarray, params), device="cpu")

    tx.load_state(port_state(jx.state["params"]))
    port_step = tx._build_train_step(TrainParams(**TRAIN))
    state = {**jx.state, "step": jnp.int32(FIRST)}
    key = jax.random.PRNGKey(1)
    t0 = time.perf_counter()
    for i in range(FIRST, FIRST + args.steps):
        k_batch = jax.random.split(jax.random.fold_in(key, i), 5)[0]
        batch = {k: torch.as_tensor(np.array(v, np.float32))
                 for k, v in sampler.sample(k_batch, jnp.int32(i)).items()}
        state, jm = jax_step(state, sampler, key)
        tm = port_step(i, batch)
        if (i - FIRST) % 10 == 0 or i == FIRST + args.steps - 1:
            ref = port_state(state["params"])
            diff = {}
            for k, v in tx.named_parameters().items():
                group = ".".join(k.split(".")[:2])
                d = float((v.detach() - ref[k]).abs().max()
                          / ref[k].abs().max().clamp(min=1e-30))
                diff[group] = max(diff.get(group, 0.0), d)
            print(f"step {i}: loss jax {float(jm['loss']):.6f} port "
                  f"{float(tm['loss']):.6f}; lang_loss jax "
                  f"{float(jm['lang_loss']):.6f} port "
                  f"{float(tm['lang_loss']):.6f}; largest parameter "
                  f"difference / largest parameter: "
                  + ", ".join(f"{g} {d:.3g}" for g, d in diff.items())
                  + f"; {time.perf_counter() - t0:.0f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
