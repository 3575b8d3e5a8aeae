"""Port parity: a LeRF-only stack (use_nerf=False, use_lerf=True).

initialize and convert of a tree that holds only the language table and
field; one train step against the JAX step (the language loss alone,
gradients and Adam moments; tests/test_torch_lerf_train.py's tolerances);
render_view's relevancy against the JAX render_view at a tiny size; the
train loop (no grid, no collapse watch, no IImg image, no refit) and a
checkpoint round trip; ``cli train`` and ``cli render`` with ``--set
use_nerf=false --set use_lerf=true`` on the stand-in CLIP encoder (the
tiny random-weight CLIP checkpoint costs 15 s of transformers' import
alone here; test_torch_lerf_cli.py holds the port's CLIP wrapper to the
JAX one).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfpp_tpu.config import TrainParams as JaxTrainParams
from nerfpp_tpu.config import hashnerf_preset as jax_hashnerf_preset
from nerfpp_tpu.core.rays import calibration_matrix, pose_spherical
from nerfpp_tpu.data import dataset as JD
from nerfpp_tpu.data import pyramid_clip as JP
from nerfpp_tpu.executor import NeRFExecutor as JaxExecutor
from nerfpp_tpu_torch import cli
from nerfpp_tpu_torch.config import TrainParams, hashnerf_preset
from nerfpp_tpu_torch.convert import state_from_jax
from nerfpp_tpu_torch.data.blender import export_blender_scene
from nerfpp_tpu_torch.data.pyramid_clip import (PyramidEmbedder,
                                                PyramidEmbedderProperties,
                                                RandomProjectionPatchEncoder,
                                                make_device_pyramid)
from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
from nerfpp_tpu_torch.executor import NeRFExecutor
from nerfpp_tpu_torch.utils.png import read_png

torch.set_num_threads(1)

BBOX = np.array([-1.5, -1.0, -1.2, 1.5, 1.0, 1.3], np.float32)
E = 24
TINY = dict(use_nerf=False, use_lerf=True, n_importance=16, thin_ray=True,
            compute_dtype="float32", lang_embed_dim=E, n_levels_le=3,
            log2_hashmap_size_le=10, finest_resolution_le=64)
TINY_TP = dict(n_samples=8, n_rand=512, n_iters=100, chunk=512)
STEP = 17        # past both anneals: the step draws nothing but the batch


def t(x):
    return torch.as_tensor(np.array(x, np.float32))


def _leaves(tree):
    return {k: v.numpy() for k, v in state_from_jax(
        jax.tree.map(np.asarray, tree), device="cpu").items()}


@pytest.fixture(scope="module")
def jax_stack():
    """The JAX LeRF-only executor, its state with a language table of
    +-0.05 (the init's 1e-4 leaves the first layers' gradients sums
    dominated by cancellation), and the port's from the converted tree."""
    jx = JaxExecutor(jax_hashnerf_preset(**TINY))
    jx.initialize(BBOX, JaxTrainParams().lrate_decay, seed=0)
    params = jax.tree.map(np.array, jx.state["params"])
    params["lang_embed"]["table"] = np.random.RandomState(2).uniform(
        -0.05, 0.05, params["lang_embed"]["table"].shape).astype(np.float32)
    jx.state["params"] = jax.tree.map(jnp.asarray, params)
    return jx, params


def _port(params):
    tx = NeRFExecutor(hashnerf_preset(**TINY), device="cpu")
    tx.initialize(BBOX, seed=0)
    tx.load_state(state_from_jax(params, device="cpu"))
    return tx


def test_initialize_and_convert(jax_stack):
    jx, params = jax_stack
    assert set(params) == {"lang_embed", "lang_model"}
    assert "occupancy" not in jx.state
    tx = _port(params)
    assert tx.embedder is None and tx.model is None and tx.occupancy is None
    st = state_from_jax(params, device="cpu")
    assert set(st) == set(tx.named_parameters())
    assert {k.split(".")[0] for k in st} == {"lang_embed", "lang_model"}
    for k, v in tx.named_parameters().items():
        assert torch.equal(v.detach(), st[k]), k
    # the port's own draws from a seed repeat, the table within 1e-4
    own = NeRFExecutor(hashnerf_preset(**TINY), device="cpu").initialize(
        BBOX, seed=3)
    again = NeRFExecutor(hashnerf_preset(**TINY), device="cpu").initialize(
        BBOX, seed=3)
    for k, v in own.named_parameters().items():
        assert torch.equal(v, again.named_parameters()[k]), k
    assert float(own.lang_embedder.table.detach().abs().max()) <= 1e-4
    # a NeRF state does not load into it
    with pytest.raises(ValueError, match="use_nerf is off"):
        tx.load_state({"embed.table": torch.zeros(4, 2)})
    assert tx.refit_bbox_from_grid() is False


def test_train_step_matches_jax(jax_stack):
    jx, params = jax_stack
    tp = JaxTrainParams(**TINY_TP)
    h = w = 32
    poses = np.stack([pose_spherical(a, -30.0, 3.0) for a in (0, 120, 240)])
    images = np.random.RandomState(1).uniform(0, 1, (3, h, w, 3)).astype(
        np.float32)
    emb = JP.PyramidEmbedder(
        JP.RandomProjectionPatchEncoder(embed_dim=E, input_size=8),
        JP.PyramidEmbedderProperties(img_size=8, overlap=0.5))(images)
    sampler = JD.RayBatchSampler(
        images=jnp.asarray(images), poses=jnp.asarray(poses),
        intrinsics=jnp.asarray(np.stack([calibration_matrix(33.0, w, h)] * 3)),
        h=h, w=w, batch_size=tp.n_rand,
        pyramid=JP.make_device_pyramid(emb, 0.5))
    key = jax.random.PRNGKey(1)
    new, jm = jx._build_train_step(tp)({**jx.state, "step": jnp.int32(STEP)},
                                       sampler, key)
    # the step's own batch, sampled in one jitted call
    k_batch = jax.random.split(jax.random.fold_in(key, STEP), 5)[0]
    batch = {k: t(v) for k, v in jax.jit(
        lambda s_, k_: s_.sample(k_, jnp.int32(STEP)))(
            sampler, k_batch).items()}
    tx = _port(params)
    tm = tx._build_train_step(TrainParams(**TINY_TP))(STEP, batch)
    assert tx.step == STEP + 1
    assert set(tm) == set(jm) == {"loss", "lang_loss"}
    for k in ("loss", "lang_loss"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    assert float(tm["loss"]) == float(tm["lang_loss"]) > 0.0
    adam = new["opt_state"][0]
    mu, nu = _leaves(adam.mu), _leaves(adam.nu)
    names = tx.named_parameters()
    assert set(names) == set(mu)
    for name, prm in names.items():
        # tests/test_torch_lerf_train.py's bounds: 95% of the gradient
        # within 1e-4 of its largest entry, every entry within 5e-3
        gj = mu[name] / 0.1              # fresh moments: mu = 0.1 g
        gt_ = prm.grad.numpy()
        scale = float(np.abs(gj).max())
        assert scale > 0, name
        diff = np.abs(gt_ - gj)
        assert np.mean(diff <= 1e-4 * scale) >= 0.95, name
        assert diff.max() <= 5e-3 * scale, (name, diff.max() / scale)
        np.testing.assert_allclose(tx.optimizer.mu[name].numpy(), mu[name],
                                   atol=5e-4 * scale, err_msg=name)
        np.testing.assert_allclose(tx.optimizer.nu[name].numpy(), nu[name],
                                   atol=1e-2 * float(nu[name].max()),
                                   err_msg=name)


def test_render_view_relevancy_matches_jax(jax_stack):
    # 16x16 at 8 + 16 samples, thin rays: the language branch alone, with
    # relevancy against two negatives. f32 on both sides; the importance
    # depths follow the coarse weights (as tests/test_torch_hier.py): the
    # maps within 1e-4, depth within 1e-3
    jx, params = jax_stack
    rng = np.random.RandomState(4)
    pos, neg = (rng.standard_normal((n, E)).astype(np.float32) for n in (1, 2))
    jx.set_lerf_prompts(jnp.asarray(pos), jnp.asarray(neg))
    k = calibration_matrix(18.0, 16, 16)
    pose = pose_spherical(30.0, -30.0, 3.0)
    jout = jx.render_view(pose, 16, 16, k, JaxTrainParams(n_samples=8,
                                                          chunk=256))
    tx = _port(params)
    tx.set_lerf_prompts(pos, neg)
    tout = tx.render_view(pose, 16, 16, k, TrainParams(n_samples=8,
                                                       chunk=256))
    assert set(tout) == set(jout) == {"lerf"}
    assert tout["lerf"].relevancy.shape == (16, 16, 1)
    for f, tol in (("rendered_lang_embedding", 1e-4), ("acc", 1e-4),
                   ("relevancy", 1e-4), ("depth", 1e-3)):
        np.testing.assert_allclose(getattr(tout["lerf"], f).numpy(),
                                   np.asarray(getattr(jout["lerf"], f)),
                                   atol=tol, err_msg=f)
    assert float(tout["lerf"].acc.mean()) > 0.05


@pytest.fixture(scope="module")
def scene():
    return make_synthetic_scene(n_train=2, n_val=1, n_test=1, image_hw=24,
                                n_samples=16, white_bkgr=False, device="cpu")


def test_train_loop_and_checkpoint(scene, tmp_path):
    enc = RandomProjectionPatchEncoder(embed_dim=E, input_size=8)
    emb = PyramidEmbedder(enc, PyramidEmbedderProperties(img_size=8,
                                                         overlap=0.5),
                          device="cpu")(
        scene.images[list(scene.split_indices("train"))])
    pyr = make_device_pyramid(emb, 0.5, device="cpu")
    # the collapse watch (auto_fine_fallback) and the refit step asked for:
    # both need the NeRF branch and stay off
    tp = TrainParams(n_samples=8, n_rand=256, chunk=256, n_iters=5,
                     i_print=2, i_img=2, i_testset=4, i_weights=3,
                     bbox_refit_step=2, base_dir=str(tmp_path))
    p = hashnerf_preset(auto_fine_fallback=True, use_occupancy_grid=True,
                        **TINY)
    ex = NeRFExecutor(p, device="cpu")
    ex.set_lerf_prompts(torch.randn(1, E), torch.randn(2, E))
    m = ex.train(scene, tp, lang_embeddings=pyr)
    assert set(m) == {"loss", "lang_loss"} and np.isfinite(m["loss"])
    assert ex.occupancy is None and ex.step == 4
    rows = (tmp_path / "metrics.csv").read_text().splitlines()
    assert rows[0] == "step,lang_loss,loss"
    # no NeRF image at IImg; the test split at step 4 (the two training
    # views: the test split is as large as the validation one) writes
    # relevancy alone
    assert not (tmp_path / "images").exists()
    assert sorted(q.name for q in tmp_path.glob("*.png")) == [
        "relevancy_0.png", "relevancy_1.png"]
    st = ex.state_dict()
    assert {k.split(".")[0] for k in st} == {"lang_embed", "lang_model",
                                            "adam", "step"}
    back = NeRFExecutor(hashnerf_preset(ft_path=str(tmp_path), **TINY),
                        device="cpu")
    back.initialize(scene.bounding_box, seed=5)
    assert back.step == 4
    for key, v in back.state_dict().items():
        assert torch.equal(v, st[key]), key


def test_cli_train_and_render(scene, tmp_path):
    data = export_blender_scene(scene, tmp_path / "blender")
    out = tmp_path / "out"
    common = ["--dataset-type", "blender", "--data-dir", str(data),
              "--base-dir", str(out), "--device", "cpu",
              "--set", "use_nerf=false", "--set", "use_lerf=true",
              "--set", "n_importance=8", "--set", f"lang_embed_dim={E}",
              "--set", "n_levels_le=3", "--set", "log2_hashmap_size_le=10",
              "--set", "finest_resolution_le=64",
              "--set-train", "NRand=256", "--set-train", "Chunk=256",
              "--set-train", "NSamples=8"]
    cli.main(["train", *common, "--set", "lerf_positives=cup",
              "--set", 'lerf_negatives=["object","texture"]',
              "--set-train", "NIters=4", "--set-train", "ITestset=3",
              "--set-train", "IWeights=0", "--set-train", "IImg=1"])
    assert (out / "pyramid_embeddings.npz").exists()
    assert (out / "step_3" / "state.pt").exists()
    assert sorted(q.name for q in out.glob("*.png")) == [
        "relevancy_0.png", "relevancy_1.png"]
    assert read_png(out / "relevancy_0.png").shape == (24, 24, 3)
    # render restores the state and, with no prompts set (as the JAX
    # CLI's render), writes nothing: a LeRF-only stack has no rgb
    cli.main(["render", *common])
    assert (out / "renders").is_dir()
    assert list((out / "renders").iterdir()) == []
