"""Port parity: the bbox refit's step in the train loop, read off the JAX
package's own ``train`` with its train step replaced by a counter (nothing
is compiled), against the port's loop.
"""
import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.config import TrainParams
from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
from tests.torch_refit_common import (LOOSE, NO_WATCH, _jax_hook_steps, _plant,
                                      _port)

torch.set_num_threads(1)


@pytest.mark.parametrize("spc,at", [(3, 6), (4, 5), (1, 7)])
def test_train_refits_at_the_jax_step(spc, at, monkeypatch, tmp_path):
    # the JAX test's run (13 steps, 3 a dispatch, refit at 6) and two more
    # placements; the port trains for real on the planted grid, the refit
    # fires once at the JAX loop's step and the loss stays finite
    tp = dict(n_samples=8, n_rand=64, n_iters=13, chunk=64, i_print=0,
              i_weights=0, i_testset=0, i_img=0, bbox_refit_step=at,
              steps_per_call=spc)
    want = _jax_hook_steps(monkeypatch, tmp_path / "jax", tp)
    assert len(want) == 1
    sc = make_synthetic_scene(n_train=2, n_val=1, n_test=1, image_hw=16,
                              n_samples=8, device="cpu")
    ex = _port(LOOSE, **NO_WATCH)
    ex.load_state({"occupancy": torch.from_numpy(_plant("centre"))})
    seen = []
    refit = ex.refit_bbox_from_grid

    def record():
        # no restart here: the loop count is the state's step
        seen.append((ex.step, ex.step))
        return refit()

    ex.refit_bbox_from_grid = record
    m = ex.train(sc, TrainParams(**tp, base_dir=str(tmp_path / "port")))
    assert seen == want
    assert np.isfinite(m["loss"]) and ex.step == 12
    vol = np.prod(ex.bounding_box[3:] - ex.bounding_box[:3])
    assert vol < np.prod(LOOSE[3:] - LOOSE[:3]) / 1.5
    # staged runs refit once, at the same step
    ex2 = _port(LOOSE, **NO_WATCH)
    ex2.load_state({"occupancy": torch.from_numpy(_plant("centre"))})
    calls = []
    ex2.refit_bbox_from_grid = lambda: calls.append(ex2.step) or False
    for _ in range(4):
        ex2.train(sc, TrainParams(**tp, base_dir=str(tmp_path / "p2")),
                  steps=4)
    assert calls == [want[0][1]]
