"""Port parity: the large-table order-fixed gradient on the CPU: the sum in
the bin pass's order (grad_large_bins_plain, the kernel's plain version)
against jax.vjp of the XLA gather, and the first of the bin pass's plans
against a construction from its definition (the rest:
tests/test_torch_large_table_plan.py).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfpp_tpu.encoders.hashgrid import gather_trilerp_reference
from nerfpp_tpu_torch.kernels import hash_encode_large as KL
from tests.torch_large_table_common import (BIN_PASS_CASES, _case_points,
                                            _pair,
                                            bin_pass_plan_is_its_definition)

torch.set_num_threads(1)


@pytest.mark.parametrize("scheme", ["fixed", "random", "blocked"])
@pytest.mark.parametrize("case", ["partial tile", "crowded"])
def test_binned_sum_matches_jax_vjp(scheme, case):
    # the terms summed in the bin pass's order (grad_large_binned_plain)
    # against jax.vjp of the JAX package's gather_trilerp_reference, each
    # entry within 1e-5 of the sum of its terms' magnitudes
    je, te = _pair(scheme, n_levels=3, log2_hashmap_size=12)
    pts = _case_points(te, case)
    g = np.random.RandomState(12).standard_normal(
        (pts.shape[0], te.output_dims)).astype(np.float32)
    idx, frac = jax.jit(je.corner_indices)(jnp.asarray(pts))
    _, vjp = jax.vjp(lambda tab: gather_trilerp_reference(tab, idx, frac),
                     jnp.zeros((je.table_rows, 2), jnp.float32))
    ref = np.asarray(vjp(jnp.asarray(g.reshape(len(pts), -1, 2)))[0])
    got = KL.grad_large_binned_plain(torch.from_numpy(g),
                                     torch.from_numpy(pts), te).numpy()
    mag = KL.grad_large_plain(torch.from_numpy(np.abs(g)),
                              torch.from_numpy(pts), te).numpy()
    assert np.all(np.abs(got - ref) <= 1e-5 * mag + 1e-30)
    assert np.abs(got).max() > 0


@pytest.mark.parametrize("scheme,log2_t,levels,case", BIN_PASS_CASES[:6])
def test_bin_pass_plan_is_its_definition(scheme, log2_t, levels, case):
    bin_pass_plan_is_its_definition(scheme, log2_t, levels, case)
