"""Port parity: the blocked hash encoder's integer layouts, exactly against
the JAX package on the same numpy inputs (Morton codes, level scales and
block offsets, corner indices, the packed table's bits), and the kernel
wrappers' input checks and launch counts on the CPU.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfpp_tpu.encoders.hashgrid import morton3 as jax_morton3
from nerfpp_tpu.pallas.hash_encode import pack_table_bf16 as jax_pack
from nerfpp_tpu_torch.encoders.hashgrid import morton3
from nerfpp_tpu_torch.kernels import hash_encode_blocked as K
from nerfpp_tpu_torch.kernels import launch_counts, reset_launch_counts
from tests.torch_hashgrid_common import KW, _bf16, _boundary_pts, _pair, _pts

torch.set_num_threads(1)


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(n_levels=16, log2_hashmap_size=19, finest_resolution=1024),
    dict(primes_seed=3, base_resolution=8, finest_resolution=512)])
def test_level_scales_and_block_offsets_exact(cfg):
    je, te = _pair(**cfg)
    np.testing.assert_array_equal(te.level_scales, je.level_scales)
    np.testing.assert_array_equal(te.block_offsets, je.block_offsets)
    assert te.block_slots == je.block_slots
    assert tuple(te.table.shape) == (je.table_rows, 2)


def test_morton3_exact():
    rng = np.random.RandomState(0)
    v = rng.randint(0, 1024, (3, 5000)).astype(np.int32)
    want = np.asarray(jax_morton3(*(jnp.asarray(a) for a in v)))
    got = morton3(*(torch.from_numpy(a) for a in v)).numpy()
    np.testing.assert_array_equal(got, want)


def test_corner_indices_exact():
    # exact integer match with the jitted oracle, at cell boundaries too
    # (XLA folds the division by the constant extent into a reciprocal
    # multiply; the port computes that folded form)
    je, te = _pair()
    pts = np.concatenate([_pts(8192), _boundary_pts(te, 8192, 3)])
    idx_j, frac_j = jax.jit(je.corner_indices)(jnp.asarray(pts))
    idx_t, frac_t = te.corner_indices(torch.from_numpy(pts))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(frac_t.numpy(), np.asarray(frac_j))


def test_pack_table_bits_exact():
    rng = np.random.RandomState(2)
    tab = rng.standard_normal((4096, 2)).astype(np.float32)
    tab[:4] = [[0.0, -0.0], [1e-40, -3e38], [65504.0, 1.0 / 3], [-2.5, 7.0]]
    want = np.asarray(jax_pack(jnp.asarray(tab))).view(np.int32)
    packed = K.pack_table_bf16(torch.from_numpy(tab))
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(K.unpack_table_bf16(packed).numpy(),
                                  _bf16(tab))


def test_cpu_wrappers_count_no_launches():
    # the counters move only where a kernel launches; CPU tensors take the
    # plain versions
    reset_launch_counts()
    _, te = _pair(use_kernel=True)
    feats, _ = te(torch.from_numpy(_pts(300, seed=11)))
    feats.sum().backward()
    assert te.table.grad is not None
    assert launch_counts() == {"window_lists": 0, "encode_blocked": 0,
                               "grad_blocked_index": 0, "grad_blocked": 0,
                               "encode_small": 0, "grad_small": 0,
                               "encode_large": 0, "grad_large_bins": 0,
                               "grad_large": 0}


def test_kernel_wrappers_check_inputs():
    _, te = _pair()
    pts = torch.from_numpy(_pts(256, seed=12))
    with pytest.raises(ValueError, match="unsupported device"):
        K.window_lists(pts.to("meta"), te)
    wids, counts = K.window_lists(pts, te)
    assert wids.shape == (KW["n_levels"], 2, 128)
    assert counts.dtype == torch.int32 and wids.dtype == torch.int32
