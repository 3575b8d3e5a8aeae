"""Helpers shared by tests/test_torch_lerf.py and
tests/test_torch_lerf_resize.py (a module, not a test file).
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from nerfpp_tpu.data import pyramid_clip as JP
from nerfpp_tpu.models.lerf_field import LeRFField as JaxLeRFField
from nerfpp_tpu_torch.convert import state_from_jax
from nerfpp_tpu_torch.data import pyramid_clip as TP
from nerfpp_tpu_torch.models.lerf_field import LeRFField


BBOX = np.array([-1.5, -1.0, -1.2, 1.5, 1.0, 1.3], np.float32)


E = 24


def t(x):
    return torch.as_tensor(np.array(x, np.float32))


def _fields(dtype, n_in=8, seed=0):
    """The JAX LeRF field, its params, and the port's with them loaded."""
    jf = JaxLeRFField(32, 3, 64, E, n_in,
                      compute_dtype=jnp.bfloat16 if dtype == "bfloat16"
                      else None)
    params = jf.init(jax.random.PRNGKey(seed))
    tf = LeRFField(32, 3, 64, E, n_in, compute_dtype=dtype, device="cpu")
    st = state_from_jax({"lang_model": jax.tree.map(np.asarray, params)},
                        device="cpu")
    tf.load_state_dict({k[len("lang_model."):]: v for k, v in st.items()})
    return jf, params, tf


def _raw(n_rays=64, n_samples=12, seed=2):
    rng = np.random.RandomState(seed)
    raw = rng.normal(0, 1, (n_rays, n_samples, E + 1)).astype(np.float32)
    raw[..., :E] /= np.linalg.norm(raw[..., :E], axis=-1, keepdims=True)
    raw[..., E] *= 3.0
    z = np.sort(rng.uniform(2.0, 6.0, (n_rays, n_samples)), -1).astype(
        np.float32)
    rays_d = rng.normal(0, 1, (n_rays, 3)).astype(np.float32)
    prompts = rng.normal(0, 1, (4, E)).astype(np.float32)
    prompts /= np.linalg.norm(prompts, axis=-1, keepdims=True)
    return raw, z, rays_d, prompts[:1], prompts[1:]


def _pyramids():
    """The JAX and the port's pyramid of the same 2 images (40 x 52: the
    windows at the right and bottom edges are cut)."""
    props = dict(img_size=16, overlap=0.5, max_zoom_out=1)
    images = np.random.RandomState(8).uniform(
        0, 1, (2, 40, 52, 3)).astype(np.float32)
    jemb = JP.PyramidEmbedder(
        JP.RandomProjectionPatchEncoder(embed_dim=E, input_size=8),
        JP.PyramidEmbedderProperties(**props))(images)
    temb = TP.PyramidEmbedder(
        TP.RandomProjectionPatchEncoder(embed_dim=E, input_size=8),
        TP.PyramidEmbedderProperties(**props), device="cpu")(images)
    return jemb, temb, images


def _tiny_preset(**kw):
    return dict(n_levels=4, log2_hashmap_size=10, finest_resolution=64,
                n_importance=16, hier_sparse_importance=4, multires_views=4,
                thin_ray=True, compute_dtype="float32", use_lerf=True,
                lang_embed_dim=E, n_levels_le=3, log2_hashmap_size_le=10,
                finest_resolution_le=64, **kw)
