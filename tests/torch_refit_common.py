"""Helpers shared by tests/test_torch_refit.py and
tests/test_torch_refit_train.py (a module, not a test file): the planted
grids, the tiny executors and scenes.
"""
import numpy as np
import jax.numpy as jnp

from nerfpp_tpu import executor as JE
from nerfpp_tpu.config import TrainParams as JaxTrainParams
from nerfpp_tpu.config import hashnerf_preset as jax_preset
from nerfpp_tpu.data import dataset as JD
from nerfpp_tpu_torch.config import hashnerf_preset
from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
from nerfpp_tpu_torch.executor import NeRFExecutor


# the JAX test's tiny preset: occupancy grid 16^3, refreshed every 2 steps
TINY = dict(n_importance=0, log2_hashmap_size=10, n_levels=4,
            finest_resolution=32, use_occupancy_grid=True,
            occ_grid_resolution=16, occ_update_every=2, occ_n_bins=8)


# the collapse watch forced to fire at step 2, or off
COLLAPSE = dict(auto_fine_check_from=2, auto_fine_rel_std=1e3)


NO_WATCH = dict(auto_fine_fallback=False)


LOOSE = np.array([-4.8, -4.8, -4.8, 4.8, 4.8, 4.8], np.float32)


ODD = np.array([-1.5, -1.0, -1.2, 1.5, 1.0, 1.3], np.float32)


def _plant(kind: str) -> np.ndarray:
    d = np.zeros((16, 16, 16), np.float32)
    if kind == "centre":                  # the JAX test's plant
        d[6:10, 6:10, 6:10] = 1000.0
    elif kind == "corner":                # one axis per range, noise below
        d[:] = np.random.RandomState(0).uniform(0, 0.9, d.shape)
        d[2:5, 9:15, 0:3] = 50.0
    elif kind == "one cell":              # the pad clipped by the old box
        d[15, 0, 7] = 3.0
    elif kind == "wide":                  # shrinks less than 1.5x
        d[1:15, 1:15, 1:15] = 1.0
    elif kind == "uniform":               # a fresh grid
        d[:] = 1.0
    return d


def _port(box, device="cpu", **kw):
    ex = NeRFExecutor(hashnerf_preset(**{**TINY, **kw}), device=device)
    return ex.initialize(box, seed=0)


def _jax(box):
    jx = JE.NeRFExecutor(jax_preset(**TINY))
    jx.initialize(box, seed=0)
    return jx


def _jax_hook_steps(monkeypatch, tmp_path, tp, collapse=False):
    """The JAX train loop with its step replaced by a counter: for each
    refit call, (steps run so far = the loop count, the state's step)."""
    sc = make_synthetic_scene(n_train=2, n_val=1, n_test=1, image_hw=16,
                              n_samples=8, device="cpu")
    scene = JD.SceneData.from_json(sc.to_json())
    scene.images = sc.images
    jx = JE.NeRFExecutor(jax_preset(**TINY, **(COLLAPSE if collapse
                                               else NO_WATCH)))
    runs, calls = [0], []

    def step(state, sampler, key):
        runs[0] += 1
        return ({**state, "step": state["step"] + 1},
                {"loss": jnp.float32(0.1), "pred_std": jnp.float32(0.0)})

    def many(state, sampler, key, *, k):
        for _ in range(k):
            state, m = step(state, sampler, key)
        return state, m

    def refit(self):
        calls.append((runs[0], int(self.state["step"])))
        return False

    monkeypatch.setattr(JE.NeRFExecutor, "_build_train_step",
                        lambda self, tp, mesh=None: step)
    monkeypatch.setattr(JE.NeRFExecutor, "_build_train_many",
                        lambda self, train_step: many)
    monkeypatch.setattr(JE.NeRFExecutor, "refit_bbox_from_grid", refit)
    jx.train(scene, JaxTrainParams(**{**tp, "base_dir": str(tmp_path)}))
    return calls
