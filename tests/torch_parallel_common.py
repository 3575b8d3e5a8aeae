"""Helpers shared by the data-parallel tests, tests/test_torch_parallel.py
and tests/test_torch_parallel_cli.py (a module, not a test file): the
tiny stacks, the rank cases, the command lines, and ``start_runs``, which
starts what a test file reads together (the JAX steps in spawned
processes, the command lines and the launcher's failure cases in
threads, the 2-rank cases here), each with a deadline.
"""
import concurrent.futures as cf
import multiprocessing

import numpy as np

import jax_parallel_reference as JR
import torch_parallel_workers as W
from nerfpp_tpu.core.rays import calibration_matrix, pose_spherical
from nerfpp_tpu_torch import cli
from nerfpp_tpu_torch.convert import state_from_jax
from nerfpp_tpu_torch.data.blender import export_blender_scene
from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
from nerfpp_tpu_torch.parallel import mesh as M

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


def start_runs(tmp_path_factory, case_names, jax=False, cli_runs=False,
               launch_errors=False):
    """Everything a test file reads, started together: with ``jax`` the two
    JAX steps in two spawned processes and their rank cases, with
    ``cli_runs`` the command lines and with ``launch_errors`` the
    launcher's failure cases in threads; then the 2-rank cases named (with
    rank 0's single-device references)."""
    spawn = multiprocessing.get_context("spawn")
    out = {}
    with cf.ThreadPoolExecutor(3) as threads, \
            cf.ProcessPoolExecutor(2, mp_context=spawn) as procs:
        if jax:
            jax_f32 = procs.submit(JR.explicit_step, "f32")
            jax_bf16 = procs.submit(JR.explicit_step, "bf16")
        if cli_runs:
            cli_out = threads.submit(_cli_runs,
                                     tmp_path_factory.mktemp("cli"))
        if launch_errors:
            fails = threads.submit(M.launch, W.fails, 2, "cpu",
                                   timeout=DEADLINE)
            hangs = threads.submit(M.launch, W.hangs, 1, "cpu", timeout=3.0)
        cases = _cases()
        cases = {n: cases[n] for n in case_names}
        if jax:
            cases = {**_jax_cases(*_port_inputs(JR.inputs("f32"))), **cases}
        r0, r1 = M.launch(W.run_cases, 2, "cpu", list(cases.values()),
                          timeout=DEADLINE)
        if jax:
            out["jax"] = {"f32": jax_f32.result(timeout=DEADLINE),
                          "bf16": jax_bf16.result(timeout=DEADLINE)}
        out["ranks"] = {n: (a, b, s) for n, a, b, s in zip(
            cases, r0["mesh"], r1["mesh"], r0["single"])}
        if cli_runs:
            out["cli"] = cli_out.result(timeout=DEADLINE)
        if launch_errors:
            out["launch errors"] = [f.exception(timeout=DEADLINE)
                                    for f in (fails, hangs)]
    return out
