"""Data parallelism of the port on the CPU: 2 gloo ranks, spawned by
``nerfpp_tpu_torch.parallel.mesh.launch`` (their bodies are in
tests/torch_parallel_workers.py, which imports no JAX).

(a) the explicit f32 and bf16 steps on 2 ranks against the JAX package's
step on ``make_mesh(2)`` in the same mode (tests/torch_train_common.py's TINY
shapes, 8 chunks of 256 rays, step 13 from the JAX state carried across,
the JAX step's own batch, _compare_step's tolerances); (b) the port's mesh
against its single device: explicit f32 and bf16, and the implicit path on
the occupancy-budget and the hierarchical-budget branches (3 steps); (c)
every rank's state bitwise equal after them; (d) the LeRF step on 2 ranks;
(e) uneven NRand refused; (f) view-parallel render_views against the
sequential renders given the list's dense fraction; (g) ``cli train`` and
``cli render --n-devices 2 --device cpu``. The launches, a JAX step in a
spawned process (tests/jax_parallel_reference.py, which imports no torch)
and the command lines start together in a module fixture, each with a
deadline, while the other JAX step runs here.
"""
import concurrent.futures as cf
import multiprocessing

import numpy as np
import pytest
import torch

import jax_parallel_reference as JR
import torch_parallel_workers as W
from nerfpp_tpu.core.rays import calibration_matrix, pose_spherical
from nerfpp_tpu_torch import cli
from nerfpp_tpu_torch.config import TrainParams
from nerfpp_tpu_torch.convert import state_from_jax
from nerfpp_tpu_torch.data.blender import export_blender_scene
from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
from nerfpp_tpu_torch.parallel import mesh as M
from nerfpp_tpu_torch.utils.png import read_png

torch.set_num_threads(1)

BBOX, TINY, TINY_TP, STEP = JR.BBOX, JR.TINY, JR.TINY_TP, JR.STEP
# the JAX test's hierarchical budget (tests/test_parallel.py:184)
HIER = dict(n_importance=16, log2_hashmap_size=10, n_levels=4,
            finest_resolution=32, hier_ray_tile=64, hier_tile_budget_frac=0.5,
            hier_sparse_importance=4)
# tests/test_torch_lerf_train.py's LeRF stack, E = 24
LERF = dict(n_levels=4, log2_hashmap_size=10, finest_resolution=64,
            n_importance=16, hier_sparse_importance=4, multires_views=4,
            thin_ray=True, compute_dtype="float32", use_lerf=True,
            lang_embed_dim=24, n_levels_le=3, log2_hashmap_size_le=10,
            finest_resolution_le=64)
# hashnerf_preset() cut to 4 levels of 2^10 entries and 8 + 8 samples
CLI_TINY = ["--set", "n_levels=4", "--set", "log2_hashmap_size=10",
            "--set", "finest_resolution=64", "--set", "n_importance=8",
            "--set", "hier_sparse_importance=4",
            "--set-train", "NRand=256", "--set-train", "Chunk=256",
            "--set-train", "NSamples=8", "--set-train", "IWeights=0",
            "--device", "cpu"]
DEADLINE = 300.0


def _leaves(tree):
    """A params-shaped JAX tree of numpy as {port name: numpy}."""
    return {k: v.numpy() for k, v in state_from_jax(tree,
                                                    device="cpu").items()}


def _port_inputs(jax_inputs):
    """The JAX state at step 13 (JR.inputs) as the port's state, and the
    JAX step's own batch."""
    st, batch = jax_inputs
    state = state_from_jax(st["params"], st["occupancy"].density,
                           st["opt_state"], STEP, device="cpu")
    return {k: v.numpy() for k, v in state.items()}, batch


def _render_case():
    """Three views of a 24x24 camera around the planted sphere, seed-0
    weights of the blocked preset (plain kernels), the auto budget."""
    k = np.asarray(calibration_matrix(26.0, 24, 24), np.float32)
    poses = [np.asarray(pose_spherical(a, -30.0, 3.0), np.float32)
             for a in (0.0, 100.0, 230.0)]
    return dict(fn="render_views", hw=24, k=k, poses=poses, bbox=BBOX,
                preset=dict(n_importance=0, use_occupancy_grid=True,
                            n_levels=4, log2_hashmap_size=10,
                            finest_resolution=64, occ_grid_resolution=16,
                            occ_n_bins=8),
                state={"occupancy": JR.sphere_grid()},
                tp=dict(n_samples=8, chunk=256), reference=True)


def _jax_cases(state, batch):
    """The rank cases of (a), by name."""
    step = dict(fn="one_step", bbox=BBOX, state=state, batch=batch,
                tp=TINY_TP, step=STEP)
    return {f"jax {mode}": dict(step, preset=dict(
        TINY, compute_dtype="float32", dp_grad_reduce=mode))
        for mode in ("f32", "bf16")}


def _cases():
    """The other rank cases, by name."""
    tiny = dict(TINY_TP, n_iters=4)
    occ = dict(TINY, thin_ray=False)         # cone scatter: rows' draws
    return {
        "explicit f32": dict(fn="train_steps", steps=3, hw=32, tp=tiny,
                             preset=dict(occ, dp_grad_reduce="f32"),
                             reference=True),
        "explicit bf16": dict(fn="train_steps", steps=3, hw=32, tp=tiny,
                              preset=dict(occ, dp_grad_reduce="bf16"),
                              reference=True),
        "implicit occupancy budget": dict(
            fn="train_steps", steps=3, hw=32, reference=True,
            tp=dict(tiny, n_rand=512, chunk=512),
            preset=dict(occ, dp_grad_reduce="implicit")),
        "implicit hier budget": dict(
            fn="train_steps", steps=3, hw=16, reference=True,
            tp=dict(n_samples=8, n_rand=256, n_iters=4, chunk=256),
            preset=dict(HIER, dp_grad_reduce="implicit")),
        "lerf explicit": dict(
            fn="train_steps", steps=1, hw=16, lang_dim=24, reference=True,
            tp=dict(n_samples=8, n_rand=512, n_iters=100, chunk=256),
            preset=dict(LERF, dp_grad_reduce="f32")),
        "lerf implicit": dict(
            fn="train_steps", steps=1, hw=16, lang_dim=24, reference=True,
            tp=dict(n_samples=8, n_rand=512, n_iters=100, chunk=512),
            preset=dict(LERF, dp_grad_reduce="implicit")),
        "render views": _render_case()}


def _cli_runs(tmp):
    """cli train, then cli render, --n-devices 2 --device cpu on a tiny
    Blender export; -> the output directory."""
    sc = make_synthetic_scene(n_train=3, n_val=1, n_test=2, image_hw=24,
                              n_samples=16, white_bkgr=False, device="cpu")
    data = export_blender_scene(sc, tmp / "blender")
    out = tmp / "out"
    common = ["--dataset-type", "blender", "--data-dir", str(data),
              "--base-dir", str(out), "--n-devices", "2", *CLI_TINY]
    cli.main(["train", *common, "--set-train", "NIters=4",
              "--set-train", "IPrint=1"])
    cli.main(["render", *common])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything the tests read, started together: the two JAX steps in
    two spawned processes, the command lines and the launcher's failure
    cases in threads; the JAX state and batch here, then the 2-rank cases
    with rank 0's single-device references."""
    spawn = multiprocessing.get_context("spawn")
    with cf.ThreadPoolExecutor(3) as threads, \
            cf.ProcessPoolExecutor(2, mp_context=spawn) as procs:
        jax_f32 = procs.submit(JR.explicit_step, "f32")
        jax_bf16 = procs.submit(JR.explicit_step, "bf16")
        cli_out = threads.submit(_cli_runs, tmp_path_factory.mktemp("cli"))
        fails = threads.submit(M.launch, W.fails, 2, "cpu", timeout=DEADLINE)
        hangs = threads.submit(M.launch, W.hangs, 1, "cpu", timeout=3.0)
        cases = {**_jax_cases(*_port_inputs(JR.inputs("f32"))), **_cases()}
        r0, r1 = M.launch(W.run_cases, 2, "cpu", list(cases.values()),
                          timeout=DEADLINE)
        out = {"jax": {"f32": jax_f32.result(timeout=DEADLINE),
                       "bf16": jax_bf16.result(timeout=DEADLINE)}}
        out["ranks"] = {n: (a, b, s) for n, a, b, s in zip(
            cases, r0["mesh"], r1["mesh"], r0["single"])}
        out["cli"] = cli_out.result(timeout=DEADLINE)
        out["launch errors"] = [f.exception(timeout=DEADLINE)
                                for f in (fails, hangs)]
    return out


# ---------------------------------------------------------- (a) vs JAX

@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_explicit_step_matches_jax(runs, mode):
    jm, mu, nu, count = runs["jax"][mode]
    mu, nu = _leaves(mu), _leaves(nu)
    tm, other, _ = runs["ranks"][f"jax {mode}"]
    for k in ("loss", "mse", "img_loss", "psnr"):
        assert tm[k] == pytest.approx(jm[k], rel=1e-5), k
    # pred_std = sqrt(E[x^2] - E[x]^2) cancels ~3 digits of the sums
    assert tm["pred_std"] == pytest.approx(jm["pred_std"], rel=1e-2)
    assert count == int(tm["state"]["adam count"]) == 1
    for name, gt_ in tm["grads"].items():
        # the summed gradient JAX applied, from its fresh first moment; in
        # bf16 mode both sides sum bf16-rounded rank gradients
        gj = mu[name] / 0.1
        scale = float(np.abs(gj).max())
        assert scale > 0, name
        diff = np.abs(gt_ - gj)
        assert np.mean(diff <= 1e-4 * scale) >= 0.95, name
        assert diff.max() <= 5e-3 * scale, (name, diff.max() / scale)
        np.testing.assert_allclose(tm["state"][f"mu {name}"], mu[name],
                                   atol=5e-4 * scale, err_msg=name)
        np.testing.assert_allclose(tm["state"][f"nu {name}"], nu[name],
                                   atol=2e-3 * float(nu[name].max()),
                                   err_msg=name)
    # both ranks applied the same summed gradient
    for key, v in tm["state"].items():
        np.testing.assert_array_equal(other["state"][key], v, err_msg=key)


# ----------------------------------------------- (b) vs a single device

def _tail(a, b, q99, cap):
    d = np.abs(a - b)
    assert np.quantile(d, 0.99) <= q99, np.quantile(d, 0.99)
    assert d.max() <= cap, d.max()      # 3 steps x 2 lr of sign flips


@pytest.mark.parametrize("mode,rtol,q99", [("f32", 1e-6, 5e-4),
                                            ("bf16", 1e-4, 5e-3)])
def test_explicit_matches_single_device(runs, mode, rtol, q99):
    mesh, _, single = runs["ranks"][f"explicit {mode}"]
    np.testing.assert_allclose(mesh["losses"], single["losses"], rtol=rtol)
    # Adam (eps 1e-15) turns tiny gradient differences into sign flips of
    # up to 2 lr: bound the tail, as tests/test_parallel.py:300 does
    for name in ("embed.table", "model.sigma_net.layers.0.weight"):
        _tail(mesh["state"][f"param {name}"],
              single["state"][f"param {name}"], q99, 0.06)


@pytest.mark.parametrize("case", ["implicit occupancy budget",
                                  "implicit hier budget"])
def test_implicit_matches_single_device(runs, case):
    mesh, _, single = runs["ranks"][case]
    np.testing.assert_allclose(mesh["losses"], single["losses"], rtol=2e-4)
    if "occupancy" in single["state"]:
        np.testing.assert_allclose(mesh["state"]["occupancy"],
                                   single["state"]["occupancy"], rtol=2e-4,
                                   atol=1e-5)


# ------------------------------------------------------- (c) replicas

@pytest.mark.parametrize("case", ["explicit f32", "explicit bf16",
                                  "implicit occupancy budget",
                                  "implicit hier budget", "lerf implicit"])
def test_replicas_stay_bitwise_equal(runs, case):
    a, b, _ = runs["ranks"][case]
    assert a["losses"] == b["losses"]
    assert set(a["state"]) == set(b["state"])
    for key, v in a["state"].items():
        np.testing.assert_array_equal(b["state"][key], v, err_msg=key)


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
