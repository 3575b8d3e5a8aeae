"""Data parallelism of the port on the CPU, 2 gloo ranks (as
tests/test_torch_parallel.py): (d) the LeRF step on 2 ranks against a
single device; (e) uneven NRand refused, the ranks' rows whole tiles in
rank order; (f) view-parallel render_views against the sequential renders
given the list's dense fraction; (g) ``cli train`` and ``cli render
--n-devices 2 --device cpu``, the refused device counts, and the launcher
stopping every rank on a failure or its deadline. The launches, the
command lines and the failure cases start together in a module fixture
(tests/torch_parallel_common.py ``start_runs``), each with a deadline.
"""
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from nerfpp_tpu_torch import cli
from nerfpp_tpu_torch.config import TrainParams
from nerfpp_tpu_torch.parallel import mesh as M
from nerfpp_tpu_torch.utils.png import read_png
from tests.torch_parallel_common import BBOX, TINY, start_runs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return start_runs(tmp_path_factory, [
        "lerf explicit", "lerf implicit", "render views"], cli_runs=True,
        launch_errors=True)


# ------------------------------------------------------------ (d) LeRF

@pytest.mark.parametrize("case", ["lerf explicit", "lerf implicit"])
def test_lerf_step_matches_single_device(runs, case):
    mesh, _, single = runs["ranks"][case]
    np.testing.assert_allclose(mesh["losses"], single["losses"], rtol=1e-6)
    assert any(k.startswith("param lang_embed.") for k in mesh["state"])


# ----------------------------------------------------- (e) uneven NRand

def test_uneven_nrand_raises(tmp_path):
    two = M.Mesh(world=2, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="multiple of the device count"):
        M.shard_rays({"rays_o": torch.zeros(61, 3)}, two)
    # the train loop refuses it before any collective, as the JAX CLI does
    ex = W.executor(dict(TINY), BBOX)
    with pytest.raises(ValueError, match=r"NRand \(255\) must divide by the "
                       r"device count \(2\)"):
        ex.train(W.scene_of(), TrainParams(n_rand=255, chunk=255,
                                           base_dir=str(tmp_path)),
                 mesh=two)
    with pytest.raises(SystemExit, match=r"NRand \(255\) must divide"):
        cli.main(["train", "--n-devices", "2", "--set-train", "NRand=255",
                  "--device", "cpu", "--base-dir", str(tmp_path)])


def test_rows_are_whole_tiles_in_rank_order():
    spans = [M.rank_rows(768, 4, r, 128) for r in range(4)]
    assert spans == [(0, 128), (128, 384), (384, 512), (512, 768)]
    batch = {"rays_o": torch.arange(512.0)[:, None], "cone_angle":
             torch.tensor(0.1)}
    got = M.shard_rays(batch, M.Mesh(2, 1, torch.device("cpu")), 128)
    assert torch.equal(got["rays_o"][:, 0], torch.arange(256.0, 512.0))
    assert got["cone_angle"] is batch["cone_angle"]
    assert M.shard_rays(batch, None) is batch


# -------------------------------------------------- (f) view-parallel

def test_render_views_matches_sequential(runs):
    mesh, other, single = runs["ranks"]["render views"]
    assert 0.0 < mesh["frac"] == single["frac"] < 1.0
    assert len(mesh["rgb8"]) == len(other["rgb8"]) == 3
    for i in range(3):
        # every rank holds every frame, equal to the sequential render
        np.testing.assert_array_equal(mesh["rgb8"][i], single["rgb8"][i])
        np.testing.assert_array_equal(other["rgb8"][i], single["rgb8"][i])
        np.testing.assert_array_equal(mesh["depth"][i], single["depth"][i])
        assert mesh["near_far"][i] == single["near_far"][i]
    assert not np.array_equal(mesh["rgb8"][0], mesh["rgb8"][2])


# --------------------------------------------------- (g) command line

def test_cli_train_and_render_on_two_ranks(runs):
    out = runs["cli"]
    rows = (out / "metrics.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows[1:]] == ["1", "2", "3"]
    assert (out / "step_3").exists() and (out / "data.json").exists()
    for i in range(2):                         # the two test views
        for name in (f"{i}.png", f"disp_{i}.png", f"depth_{i}.png"):
            img = read_png(out / "renders" / name)
            assert img.shape[:2] == (24, 24) and img.std() > 0, name
    assert sorted(p.name for p in (out / "renders").glob("*.png")) == [
        "0.png", "1.png", "depth_0.png", "depth_1.png", "disp_0.png",
        "disp_1.png"]


@pytest.mark.parametrize("argv,msg", [
    (["--n-devices", "0", "--device", "cpu"], "give the number"),
    (["--n-devices", "2"], r"--n-devices 2: 0 CUDA device\(s\) visible"),
    (["--n-devices", "-1", "--device", "cpu"], "give a count")])
def test_cli_refuses_device_counts(argv, msg, tmp_path):
    with pytest.raises(SystemExit, match=msg):
        cli.main(["render", *argv, "--base-dir", str(tmp_path)])


def test_launch_stops_every_rank_on_a_failure_or_the_deadline(runs):
    failed, late = runs["launch errors"]
    assert isinstance(failed, RuntimeError)
    assert "rank 1 fails" in str(failed)
    assert isinstance(late, TimeoutError)
