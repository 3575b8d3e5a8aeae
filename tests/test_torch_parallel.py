"""Data parallelism of the port on the CPU: 2 gloo ranks, spawned by
``nerfpp_tpu_torch.parallel.mesh.launch`` (their bodies are in
tests/torch_parallel_workers.py, which imports no JAX).

(a) the explicit f32 and bf16 steps on 2 ranks against the JAX package's
step on ``make_mesh(2)`` in the same mode (tests/torch_train_common.py's TINY
shapes, 8 chunks of 256 rays, step 13 from the JAX state carried across,
the JAX step's own batch, _compare_step's tolerances); (b) the port's mesh
against its single device: explicit f32 and bf16, and the implicit path on
the occupancy-budget and the hierarchical-budget branches (3 steps); (c)
every rank's state bitwise equal after them. The launches and a JAX step
in a spawned process (tests/jax_parallel_reference.py, which imports no
torch) start together in a module fixture (tests/torch_parallel_common.py
``start_runs``), each with a deadline, while the other JAX step runs
here. The LeRF step, uneven NRand, view-parallel rendering and the command
lines: tests/test_torch_parallel_cli.py.
"""
import numpy as np
import pytest
import torch

from tests.torch_parallel_common import _leaves, start_runs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return start_runs(tmp_path_factory, [
        "explicit f32", "explicit bf16", "implicit occupancy budget",
        "implicit hier budget", "lerf implicit"], jax=True)


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
