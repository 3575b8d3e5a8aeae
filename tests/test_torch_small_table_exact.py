"""Port parity: the small-table hash schemes' integer parts on the CPU,
exactly against the JAX package's jitted oracle on the same numpy inputs:
primes and resolutions, and the corner indices.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.torch_small_table_common import (BBOX, _faces_and_boundaries, _pair,
                                            _pts)

torch.set_num_threads(1)


@pytest.mark.parametrize("scheme", ["fixed", "random"])
@pytest.mark.parametrize("cfg", [
    dict(),
    dict(n_levels=16, log2_hashmap_size=13, finest_resolution=1024),
    dict(primes_seed=3, base_resolution=8, finest_resolution=512)])
def test_primes_and_resolutions_exact(scheme, cfg):
    je, te = _pair(scheme, **cfg)
    assert te.level_size == je.level_size
    assert te.table_rows == je.table_rows
    if scheme == "fixed":
        np.testing.assert_array_equal(te.resolutions, je.resolutions)
    else:
        np.testing.assert_array_equal(te.primes, je.primes)
        np.testing.assert_array_equal(te.level_scales, je.level_scales)


@pytest.mark.parametrize("scheme", ["fixed", "random"])
@pytest.mark.parametrize("box", ["whole", "corner", "thin"])
def test_corner_indices_exact(scheme, box):
    # exact against jax.jit(enc.corner_indices), boundaries and faces too:
    # XLA folds the divisions by constants into reciprocal multiplies
    # (random: (x - min) * f32(1/extent) * scale; fixed: (x - min) /
    # f32(extent * f32(1/res))), and the port computes those forms
    je, te = _pair(scheme, n_levels=6, log2_hashmap_size=12,
                   finest_resolution=600)
    lo, hi = {"whole": (None, None),
              "corner": (BBOX[3:] - 0.2, None),
              "thin": (np.float32([0.1, -0.9, 0.0]),
                       np.float32([0.1001, 0.9, 0.05]))}[box]
    pts = np.concatenate([_pts(4096, 3, lo, hi),
                          _faces_and_boundaries(te, 2048, 4)])
    idx_j, frac_j = jax.jit(je.corner_indices)(jnp.asarray(pts))
    idx_t, frac_t = te.corner_indices(torch.from_numpy(pts))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(frac_t.numpy(), np.asarray(frac_j))
