"""Helpers shared by tests/test_torch_hashgrid.py and
tests/test_torch_hashgrid_exact.py (a module, not a test file).
"""
import numpy as np
import jax
import jax.numpy as jnp

from nerfpp_tpu.encoders.hashgrid import HashGridEncoder as JaxEncoder
from nerfpp_tpu.pallas import hash_encode_blocked as JB
from nerfpp_tpu_torch.encoders.hashgrid import HashGridEncoder


BBOX = np.array([-1.5, -1.0, -1.2, 1.5, 1.0, 1.3], np.float32)


KW = dict(n_levels=4, log2_hashmap_size=12, base_resolution=16,
          finest_resolution=128, scheme="blocked")


def _pair(use_kernel=False, **kw):
    args = dict(KW, **kw)
    return JaxEncoder(BBOX, **args), HashGridEncoder(
        BBOX, use_kernel=use_kernel, device="cpu", **args)


def _pts(n, seed=1, lo=None, hi=None):
    rng = np.random.RandomState(seed)
    lo = BBOX[:3] if lo is None else lo
    hi = BBOX[3:] if hi is None else hi
    return rng.uniform(lo, hi, (n, 3)).astype(np.float32)


def _bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _boundary_pts(enc, n, seed):
    """Points within +-3 ulps of cell boundaries of random levels, where a
    different rounding of the cell coordinate changes the cell."""
    rng = np.random.RandomState(seed)
    scale = enc.level_scales[rng.randint(0, enc.n_levels, n)][:, None]
    cell = np.floor(rng.uniform(0, 1, (n, 3)) * scale)
    x = (BBOX[:3] + cell / scale.astype(np.float64)
         * (BBOX[3:] - BBOX[:3])).astype(np.float32)
    steps = rng.randint(-3, 4, (n, 3))
    for s in range(3):
        x = np.where(steps > s, np.nextafter(x, np.float32(np.inf)), x)
        x = np.where(steps < -s, np.nextafter(x, np.float32(-np.inf)), x)
    return np.clip(x, BBOX[:3], BBOX[3:])


def _pallas_form_codes(pts, je):
    """Window Morton codes [L, NG, 128] with the Pallas K1's cell form,
    (x - min) * (f32(inv) * scale) truncated (_make_windows_kernel), in
    jitted XLA on the same f32 inputs."""
    bmin = [float(v) for v in je.bounding_box[:3]]
    inv = [1.0 / (float(je.bounding_box[3 + a]) - bmin[a]) for a in range(3)]
    scales = jnp.asarray(je.level_scales, jnp.float32)
    boffs = jnp.asarray(je.block_offsets, jnp.int32)

    def codes(x):
        m = 0
        for a in range(3):
            c = ((x[:, a:a + 1] - bmin[a]) * (inv[a] * scales)).astype(
                jnp.int32)                                      # [N, L]
            m = m | (JB._spread_bits(((c >> 2) + boffs[:, a]) >> 1) << a)
        return m
    m = np.asarray(jax.jit(codes)(jnp.asarray(pts)))
    return m.reshape(-1, 128, je.n_levels).transpose(2, 0, 1)
