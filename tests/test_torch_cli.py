"""The port's command line on the CPU (``--device cpu``): train and render
a tiny preset on the synthetic scene, on a tiny Blender export and on a
tiny COLMAP capture (two distorted cameras, 16x16 and 20x20), the train
loop's image hooks (IImg, ITestset, RenderOnly) and the bbox refit flag,
the saved JSON configs against the JAX CLI's keys, a COLMAP capture of
JPEG images training, and what is not ported yet raising.
"""
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nerfpp_tpu import config as jax_config
from nerfpp_tpu.data.dataset import SceneData as JaxSceneData
from nerfpp_tpu_torch import cli
from nerfpp_tpu_torch.data import synthetic
from nerfpp_tpu_torch.data.blender import export_blender_scene
from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
from nerfpp_tpu_torch.utils.jpeg import write_jpeg
from nerfpp_tpu_torch.utils.png import read_png
from scripts.colmap_export import export_colmap_scene, write_images_bin

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
# hashnerf_preset() cut to 4 levels of 2^10 entries and 8 + 8 samples
TINY = ["--set", "n_levels=4", "--set", "log2_hashmap_size=10",
        "--set", "finest_resolution=64", "--set", "n_importance=8",
        "--set", "hier_sparse_importance=4",
        "--set-train", "NRand=256", "--set-train", "Chunk=256",
        "--set-train", "NSamples=8", "--set-train", "IWeights=0",
        "--device", "cpu"]


@pytest.fixture(scope="module")
def blender_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("blender")
    sc = make_synthetic_scene(n_train=3, n_val=1, n_test=2, image_hw=24,
                              n_samples=16, white_bkgr=False, device="cpu")
    return export_blender_scene(sc, d)


@pytest.fixture(scope="module")
def colmap_dir(tmp_path_factory):
    sc = make_synthetic_scene(n_train=4, n_val=1, n_test=1, image_hw=16,
                              n_samples=16, white_bkgr=False, device="cpu")
    return export_colmap_scene(sc, tmp_path_factory.mktemp("colmap"), "cpu",
                               n_samples=16, n_points=600).workspace


def _pngs(d):
    return sorted(p.name for p in Path(d).glob("*.png"))


def test_train_and_render_from_a_blender_export(blender_dir, tmp_path):
    out = tmp_path / "out"
    data = ["--dataset-type", "blender", "--data-dir", str(blender_dir),
            "--base-dir", str(out)]
    cli.main(["train", *data, *TINY, "--set-train", "NIters=7",
              "--set-train", "IPrint=3", "--set-train", "IImg=3",
              "--set-train", "ITestset=6"])
    # the final checkpoint and the three configs, with the JAX CLI's keys
    assert (out / "step_6" / "state.pt").exists()
    p = json.loads((out / "executor_params.json").read_text())
    tp = json.loads((out / "executor_train_params.json").read_text())
    assert set(p) == set(jax_config.hashnerf_preset().to_json())
    assert set(tp) == set(jax_config.TrainParams().to_json())
    assert (p["n_levels"], tp["NIters"], tp["IImg"]) == (4, 7, 3)
    jax_config.ExecutorParams.load(out / "executor_params.json")
    jax_config.TrainParams.load(out / "executor_train_params.json")
    scene = JaxSceneData.load(out / "data.json")
    assert scene.splits_idx == [3, 1, 2]
    # IPrint rows, IImg's validation image (step 3 and 6), ITestset's
    # renders of the test split at step 6
    rows = (out / "metrics.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows[1:]] == ["3", "6"]
    assert sorted(p.name for p in (out / "images").iterdir()) == [
        "val_rgb_00000003.png", "val_rgb_00000006.png"]
    assert _pngs(out) == ["0.png", "1.png", "depth_0.png", "depth_1.png",
                          "disp_0.png", "disp_1.png"]
    assert read_png(out / "0.png").shape == (24, 24, 3)
    assert read_png(out / "disp_0.png").shape == (24, 24)
    # render restores the checkpoint and writes the test split
    cli.main(["render", *data, *TINY])
    renders = out / "renders"
    assert _pngs(renders) == _pngs(out)
    np.testing.assert_array_equal(read_png(renders / "0.png"),
                                  read_png(out / "0.png"))
    # the spherical path, n poses
    cli.main(["render", *data, *TINY, "--spherical-path", "--n-poses", "3"])
    assert len(_pngs(renders)) == 9
    assert read_png(renders / "2.png").std() > 0


def test_render_only_renders_the_test_split(blender_dir, tmp_path):
    out = tmp_path / "ro"
    data = ["--dataset-type", "blender", "--data-dir", str(blender_dir),
            "--base-dir", str(out)]
    cli.main(["train", *data, *TINY, "--set-train", "RenderOnly=true"])
    # the test split, as the JAX loop's RenderOnly branch writes it; no
    # step trained (only the CLI's final save of the fresh state)
    assert _pngs(out / "renderonly") == ["0.png", "1.png", "depth_0.png",
                                         "depth_1.png", "disp_0.png",
                                         "disp_1.png"]
    assert [d.name for d in out.glob("step_*")] == ["step_0"]
    assert not (out / "metrics.csv").exists()


def test_train_on_the_synthetic_scene(tmp_path, monkeypatch):
    # the CLI's synthetic scene at 16 px with 4 views (its default, 30 views
    # at 64 px, takes 20 s to render on one CPU thread)
    small = functools.partial(synthetic.make_synthetic_scene, n_train=2,
                              n_val=1, n_test=1, image_hw=16, n_samples=16)
    monkeypatch.setattr(synthetic, "make_synthetic_scene", small)
    out = tmp_path / "syn"
    cli.main(["train", "--dataset-type", "synthetic", "--preset", "classic",
              "--set", "net_depth=2", "--set", "net_width=16",
              "--set", "n_importance=0", "--set-train", "NIters=3",
              "--set-train", "NRand=128", "--set-train", "Chunk=128",
              "--set-train", "NSamples=4", "--set-train", "IPrint=1",
              "--set-train", "IImg=0", "--set-train", "ITestset=0",
              "--set-train", "IWeights=0", "--base-dir", str(out),
              "--device", "cpu"])
    p = json.loads((out / "executor_params.json").read_text())
    assert (p["model_type"], p["embedder_type"]) == ("nerf", "frequency")
    assert len((out / "metrics.csv").read_text().splitlines()) == 3
    state = torch.load(out / "step_2" / "state.pt", weights_only=True)
    assert "model.pts_linears.0.bias" in state and "embed.table" not in state


def test_train_from_a_colmap_workspace(colmap_dir, tmp_path):
    # hashnerf_preset() cut as above, with the occupancy grid and the bbox
    # refit flag; the views are undistorted into the workspace and the
    # 20x20 view resized to 16x16 for training
    out = tmp_path / "out"
    cli.main(["train", "--dataset-type", "colmap", "--data-dir",
              str(colmap_dir), "--base-dir", str(out), *TINY,
              "--set", "use_occupancy_grid=true", "--set", "n_importance=0",
              "--set", "occ_grid_resolution=16", "--set-train", "NIters=4",
              "--set-train", "IPrint=1", "--set-train", "IImg=0",
              "--set-train", "BboxRefitStep=2"])
    rows = (out / "metrics.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows[1:]] == ["1", "2", "3"]
    scene = JaxSceneData.load(out / "data.json")
    assert scene.splits_idx == [4, 0, 0]
    assert {(v.h, v.w) for v in scene.views} == {(16, 16), (20, 20)}
    assert all(v.d is None and "undistorted" in v.image_path
               for v in scene.views)
    assert sorted(p.name for p in (colmap_dir / "undistorted").iterdir()) == [
        f"view_{j:03d}.png" for j in range(4)]
    tp = json.loads((out / "executor_train_params.json").read_text())
    assert tp["BboxRefitStep"] == 2


@pytest.mark.parametrize("argv,what", [
    (["train", "--dataset-type", "colmap", "--data-dir", "<jpeg capture>"],
     "colmap"),
    (["bench"], "bench")])
def test_what_is_not_ported_raises(argv, what, tmp_path, colmap_dir):
    # bench is not ported and raises; a COLMAP capture of JPEG images (the
    # PNG capture's views re-encoded) now trains, its distorted views
    # undistorted into JPEG files
    if "<jpeg capture>" not in argv:
        with pytest.raises(NotImplementedError, match=f"{what}.*ROADMAP.md"):
            cli.main(argv)
        return
    from nerfpp_tpu_torch.data.colmap import read_model
    jpeg = tmp_path / "jpeg"
    (jpeg / "sparse" / "0").mkdir(parents=True)
    (jpeg / "images").mkdir()
    rec = read_model(colmap_dir / "sparse" / "0")
    for im in rec.images.values():
        img = read_png(colmap_dir / "images" / im.name)
        im.name = im.name.replace(".png", ".jpg")
        write_jpeg(jpeg / "images" / im.name, img, device="cpu")
    for f in ("cameras.bin", "points3D.bin"):
        (jpeg / "sparse" / "0" / f).write_bytes(
            (colmap_dir / "sparse" / "0" / f).read_bytes())
    write_images_bin(jpeg / "sparse" / "0" / "images.bin",
                     [rec.images[i] for i in sorted(rec.images)])
    out = tmp_path / "out"
    cli.main([*[str(jpeg) if a == "<jpeg capture>" else a for a in argv],
              "--base-dir", str(out), *TINY, "--set-train", "NIters=3",
              "--set-train", "IPrint=1", "--set-train", "IImg=0"])
    rows = (out / "metrics.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows[1:]] == ["1", "2"]
    assert sorted(p.name for p in (jpeg / "undistorted").iterdir()) == [
        f"view_{j:03d}.jpg" for j in range(4)]


def test_runs_as_a_module():
    out = subprocess.run([sys.executable, "-m", "nerfpp_tpu_torch.cli",
                          "bench"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "the bench subcommand is not ported" in out.stderr
    assert "ROADMAP.md" in out.stderr
