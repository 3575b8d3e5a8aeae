"""The port's LeRF command line on the CPU, and its CLIP wrapper.

``cli train --set use_lerf=true`` on a tiny Blender export with prompts and
ITestset (the stand-in pyramid cached as pyramid_embeddings.npz, the test
split's relevancy_0.png), then ``cli render``, which sets no prompts, as the
JAX CLI's render does. ``load_clip_encoder`` against the JAX package's on a
tiny random CLIP checkpoint built offline (skipped without transformers).
"""
import numpy as np
import pytest
import torch

from nerfpp_tpu.data import pyramid_clip as JP
from nerfpp_tpu_torch import cli
from nerfpp_tpu_torch.data.blender import export_blender_scene
from nerfpp_tpu_torch.data.pyramid_clip import load_clip_encoder
from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
from nerfpp_tpu_torch.utils.png import read_png

torch.set_num_threads(1)

E = 24


def test_cli_lerf_train_writes_relevancy_then_render(tmp_path):
    sc = make_synthetic_scene(n_train=2, n_val=1, n_test=1, image_hw=24,
                              n_samples=16, white_bkgr=False, device="cpu")
    data = export_blender_scene(sc, tmp_path / "blender")
    out = tmp_path / "out"
    common = ["--dataset-type", "blender", "--data-dir", str(data),
              "--base-dir", str(out), "--device", "cpu",
              "--set", "n_levels=4", "--set", "log2_hashmap_size=10",
              "--set", "finest_resolution=64", "--set", "n_importance=8",
              "--set", "hier_sparse_importance=4", "--set", "use_lerf=true",
              "--set", f"lang_embed_dim={E}", "--set", "n_levels_le=3",
              "--set", "log2_hashmap_size_le=10",
              "--set", "finest_resolution_le=64",
              "--set-train", "NRand=256", "--set-train", "Chunk=256",
              "--set-train", "NSamples=8"]
    cli.main(["train", *common, "--set", "lerf_positives=cup",
              "--set", 'lerf_negatives=["object","texture"]',
              "--set-train", "NIters=4", "--set-train", "ITestset=3",
              "--set-train", "IWeights=0", "--set-train", "IImg=0"])
    # the stand-in pyramid (24 px views: the window shrunk to 8 px, zooms
    # -1..1), cached
    emb = JP.PyramidEmbedding.load(out / "pyramid_embeddings.npz")
    assert emb.props.img_size == 8 and emb.grids[(0, 0)].shape[-1] == E
    assert sorted(z for i, z in emb.grids if i == 1) == [-1, 0, 1]
    assert (out / "step_3" / "state.pt").exists()
    rel = read_png(out / "relevancy_0.png")
    assert rel.shape == (24, 24, 3)
    assert read_png(out / "0.png").shape == (24, 24, 3)
    # render restores the LeRF state and writes no relevancy PNG
    cli.main(["render", *common])
    names = sorted(p.name for p in (out / "renders").glob("*.png"))
    assert names == ["0.png", "depth_0.png", "disp_0.png"]


def test_clip_encoder_matches_jax(tmp_path):
    pytest.importorskip("transformers")
    from tests.test_lerf_pipeline import _write_tiny_clip_checkpoint
    _write_tiny_clip_checkpoint(tmp_path / "clip", embed_dim=E)
    jimg, jtxt = JP.load_clip_encoder(str(tmp_path / "clip"))
    timg, ttxt = load_clip_encoder(str(tmp_path / "clip"), device="cpu")
    patches = np.random.RandomState(0).uniform(
        0, 1, (3, 20, 20, 3)).astype(np.float32)
    ref = jimg(patches)
    assert ref.shape == (3, E)
    np.testing.assert_allclose(timg(patches), ref, atol=1e-6)
    np.testing.assert_allclose(timg(torch.as_tensor(patches)), ref,
                               atol=1e-6)
    np.testing.assert_allclose(ttxt(["a cup", "a plate"]),
                               jtxt(["a cup", "a plate"]), atol=1e-6)
