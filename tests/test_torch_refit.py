"""Port parity: the occupancy bbox refit (executor.refit_bbox_from_grid,
_reinit_position_state and the train loop's hook) against the JAX package.

The box comes out of the same cell arithmetic on the same planted grids
(the JAX test's plant, tests/test_executor.py, and others), exactly. The
state after a refit is the port's own: tables redrawn from a CPU generator,
only their Adam moments zeroed, the grid uniform, the MLPs, their moments,
Adam's count and the step kept. The hook's step is the JAX loop's, read off
the JAX package's own ``train`` with its train step replaced by a counter
(nothing is compiled). Reference behaviours kept on purpose and named
here: the hook reads the loop count, which runs on past a collapse restart
while the state's step starts again at 0 (so the refit comes at a smaller
state step); and a checkpoint carries no box, so a state restored after a
refit sits in the scene's box again.

The refit's step in the train loop against the JAX loop's:
tests/test_torch_refit_train.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nerfpp_tpu import executor as JE
from nerfpp_tpu.config import TrainParams as JaxTrainParams
from nerfpp_tpu.config import hashnerf_preset as jax_preset
from nerfpp_tpu.core.occupancy import OccupancyGrid as JaxGrid
from nerfpp_tpu.data import dataset as JD
from nerfpp_tpu_torch.config import TrainParams
from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
from tests.torch_refit_common import (COLLAPSE, LOOSE, ODD, TINY, _jax,
                                      _jax_hook_steps, _plant, _port)

torch.set_num_threads(1)


@pytest.mark.parametrize("kind,box", [("centre", LOOSE), ("corner", ODD),
                                      ("one cell", ODD), ("wide", ODD),
                                      ("uniform", LOOSE), ("empty", ODD)])
def test_refit_gives_the_jax_box(kind, box):
    d = _plant(kind)
    ex = _port(box)
    ex.load_state({"occupancy": torch.from_numpy(d)})
    jx = _jax(box)
    jx.state["occupancy"] = JaxGrid(density=jnp.asarray(d))
    table = ex.embedder.table.detach().clone()
    fired = ex.refit_bbox_from_grid()
    assert fired == jx.refit_bbox_from_grid()
    assert fired == (kind in ("centre", "corner", "one cell"))
    np.testing.assert_array_equal(ex.bounding_box, jx.bounding_box)
    assert ex.sp_alpha0 == jx.sp_alpha0
    np.testing.assert_array_equal(ex.embedder.bounding_box, ex.bounding_box)
    if not fired:
        # the no-op touches nothing
        np.testing.assert_array_equal(ex.bounding_box, box)
        assert torch.equal(ex.embedder.table.detach(), table)
        assert torch.equal(ex.occupancy.density, torch.from_numpy(d))


def test_state_after_a_refit(tmp_path):
    # a few steps first, so that every Adam moment is non-zero
    sc = make_synthetic_scene(n_train=2, n_val=1, n_test=1, image_hw=16,
                              n_samples=8, device="cpu")
    tp = TrainParams(n_samples=8, n_rand=64, n_iters=13, chunk=64,
                     i_print=0, i_weights=0, i_testset=0, i_img=0,
                     base_dir=str(tmp_path))
    ex = _port(LOOSE)
    ex.train(sc, tp, steps=3)
    before = {k: v.detach().clone() for k, v in ex.named_parameters().items()}
    mu = {k: v.clone() for k, v in ex.optimizer.mu.items()}
    nu = {k: v.clone() for k, v in ex.optimizer.nu.items()}
    count = ex.optimizer.count.clone()
    ex.load_state({"occupancy": torch.from_numpy(_plant("centre"))})
    assert ex.refit_bbox_from_grid(seed=17)
    params = ex.named_parameters()
    for k, v in params.items():
        if k.startswith("embed."):
            assert not bool(ex.optimizer.mu[k].any())
            assert not bool(ex.optimizer.nu[k].any())
        else:
            assert torch.equal(v.detach(), before[k]), k
            assert torch.equal(ex.optimizer.mu[k], mu[k]), k
            assert torch.equal(ex.optimizer.nu[k], nu[k]), k
    g = torch.Generator().manual_seed(17)
    assert torch.equal(params["embed.table"].detach(),
                       torch.rand(before["embed.table"].shape, generator=g)
                       * 2e-4 - 1e-4)
    assert torch.equal(ex.occupancy.density, torch.ones(16, 16, 16))
    assert ex.step == 3 and torch.equal(ex.optimizer.count, count)
    assert ex.optimizer.params["embed.table"] is ex.embedder.table
    # training goes on through the new table
    m = ex.train(sc, tp, steps=2)
    assert np.isfinite(m["loss"]) and ex.step == 5
    assert bool(ex.optimizer.mu["embed.table"].any())
    # a checkpoint carries no box (the JAX package's too): a restored state
    # sits in the box the new executor is initialised with
    ex.save_checkpoint(tmp_path)
    again = _port(LOOSE, ft_path=str(tmp_path))
    assert again.step == 5
    np.testing.assert_array_equal(again.bounding_box, LOOSE)


def test_refit_rebuilds_the_language_embedder():
    # LeRF: the language table is redrawn on the new box after the NeRF
    # table, from the same generator; the language field is kept
    ex = _port(LOOSE, use_lerf=True, lang_embed_dim=8, n_levels_le=2,
               log2_hashmap_size_le=8, finest_resolution_le=32)
    field = {k: v.detach().clone()
             for k, v in ex.lang_model.named_parameters()}
    ex.load_state({"occupancy": torch.from_numpy(_plant("centre"))})
    assert ex.refit_bbox_from_grid()
    np.testing.assert_array_equal(ex.lang_embedder.bounding_box,
                                  ex.bounding_box)
    g = torch.Generator().manual_seed(17)
    torch.rand(ex.embedder.table.shape, generator=g)
    assert torch.equal(ex.lang_embedder.table.detach(),
                       torch.rand(ex.lang_embedder.table.shape, generator=g)
                       * 2e-4 - 1e-4)
    for k, v in ex.lang_model.named_parameters():
        assert torch.equal(v.detach(), field[k]), k
    assert not bool(ex.optimizer.mu["lang_embed.table"].any())
    assert ex.optimizer.params["lang_embed.table"] is ex.lang_embedder.table


def test_refit_hook_reads_the_loop_count(monkeypatch, tmp_path):
    # a collapse restart at step 2 (forced by a large auto_fine_rel_std)
    # sets the state's step to 0 while the loop count runs on: the refit
    # hook at loop count 4 sees state step 2, in both packages
    tp = dict(n_samples=8, n_rand=64, n_iters=10, chunk=64, i_print=0,
              i_weights=0, i_testset=0, i_img=0, bbox_refit_step=4)
    want = _jax_hook_steps(monkeypatch, tmp_path / "jax", tp, collapse=True)
    assert want == [(4, 2)]
    sc = make_synthetic_scene(n_train=2, n_val=1, n_test=1, image_hw=16,
                              n_samples=8, device="cpu")
    ex = _port(LOOSE, **COLLAPSE)
    runs, seen = [0], []
    build = ex._build_train_step

    def counting(tp_):
        step = build(tp_)

        def run(*a, **kw):
            runs[0] += 1
            return step(*a, **kw)
        return run

    ex._build_train_step = counting
    ex.refit_bbox_from_grid = lambda: seen.append((runs[0], ex.step)) or False
    ex.train(sc, TrainParams(**tp, base_dir=str(tmp_path / "port")))
    assert seen == want


def test_collapse_watch_on_a_loaded_scene(monkeypatch, tmp_path, capsys):
    # a loaded scene has no attached images: the JAX loop's collapse watch
    # raises on it (np.asarray(None)[..., :3]); the port takes the std of
    # the sampler's training images (a deviation, ROADMAP.md section 3)
    from nerfpp_tpu_torch.data.blender import (export_blender_scene,
                                               load_blender_data)
    from nerfpp_tpu_torch.data.dataset import RayBatchSampler
    sc = make_synthetic_scene(n_train=2, n_val=1, n_test=1, image_hw=16,
                              n_samples=8, device="cpu")
    loaded = load_blender_data(export_blender_scene(sc, tmp_path / "b"))
    assert loaded.images is None
    tp = dict(n_samples=8, n_rand=64, n_iters=6, chunk=64, i_print=0,
              i_weights=0, i_testset=0, i_img=0)
    jscene = JD.SceneData.from_json(loaded.to_json())
    monkeypatch.setattr(JE.NeRFExecutor, "_build_train_step",
                        lambda self, tp, mesh=None: None)
    with pytest.raises(IndexError):
        JE.NeRFExecutor(jax_preset(**TINY, **COLLAPSE)).train(
            jscene, JaxTrainParams(**tp, base_dir=str(tmp_path / "jax")))
    ex = _port(loaded.bounding_box, **COLLAPSE)
    sampler = RayBatchSampler.from_scene(loaded, 64, device="cpu")
    ex.train(loaded, TrainParams(**tp, base_dir=str(tmp_path / "port")),
             sampler=sampler, steps=2)
    want = float(torch.std(sampler.images, correction=0))
    assert f"vs GT {want:.4f}" in capsys.readouterr().out
