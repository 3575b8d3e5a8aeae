"""Port parity: the LeRF modules (field, compositing, relevancy, the network
closure, the CLIP pyramid and its stand-in encoder, the JET colormap, the
pyramid heatmap) and a 24x24 LeRF render of the executor.

The port on the CPU against the JAX package on the same numpy inputs from a
seed. Tolerances: the field, the integrator and relevancy within 1e-5 in
f32; the resize within 1e-6 of OpenCV's (both f32; OpenCV's own rounding
order is not reproduced bit for bit); the stand-in's projection bitwise and
its outputs within 1e-6; pyramid grids and lookups within 1e-6; JET and the
blend exact.

The resize and the JET colormap against OpenCV:
tests/test_torch_lerf_resize.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfpp_tpu.config import TrainParams as JaxTrainParams
from nerfpp_tpu.config import hashnerf_preset as jax_hashnerf_preset
from nerfpp_tpu.core.rays import calibration_matrix, pose_spherical
from nerfpp_tpu.data import pyramid_clip as JP
from nerfpp_tpu.encoders.hashgrid import HashGridEncoder as JaxEncoder
from nerfpp_tpu.executor import NeRFExecutor as JaxExecutor
from nerfpp_tpu.render import debug as jax_debug
from nerfpp_tpu.render import lerf as JL
from nerfpp_tpu_torch.config import TrainParams, hashnerf_preset
from nerfpp_tpu_torch.convert import state_from_jax
from nerfpp_tpu_torch.data import pyramid_clip as TP
from nerfpp_tpu_torch.encoders.hashgrid import HashGridEncoder
from nerfpp_tpu_torch.executor import NeRFExecutor
from nerfpp_tpu_torch.render import debug as port_debug
from nerfpp_tpu_torch.render import lerf as TL
from nerfpp_tpu_torch.utils.png import read_png
from tests.torch_lerf_common import (BBOX, E, _fields, _pyramids, _raw,
                                     _tiny_preset, t)

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lerf_field_matches_jax(dtype):
    jf, params, tf = _fields(dtype)
    x = np.random.RandomState(1).uniform(-1, 1, (512, 8)).astype(np.float32)
    ref = np.asarray(jf(params, jnp.asarray(x)))
    with torch.no_grad():
        out = tf(t(x)).numpy()
    assert out.shape == (512, E + 1)
    np.testing.assert_allclose(np.linalg.norm(out[:, :E], axis=-1), 1.0,
                               atol=1e-5)
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-5)
    else:
        # bf16 operands: a hidden value one f32 ulp apart can round to the
        # neighbouring bf16 value (2^-8 relative); the bulk stays at 1e-5
        diff = np.abs(out - ref)
        assert np.mean(diff <= 1e-5) >= 0.99 and diff.max() <= 1e-2


@pytest.mark.parametrize("act", ["relu", "trunc_exp"])
def test_lerf_integrator_matches_jax(act):
    raw, z, rays_d, pos, neg = _raw()
    jint = JL.make_lerf_integrate_fn(E, jnp.asarray(pos), jnp.asarray(neg),
                                     density_activation=act)
    tint = TL.make_lerf_integrate_fn(E, t(pos), t(neg),
                                     density_activation=act)
    ref = jint(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(rays_d), 0.0,
               jax.random.PRNGKey(0))
    out = tint(t(raw), t(z), t(rays_d))
    assert type(out).__name__ == "LeRFOutputs"
    for f in TL.LeRFOutputs._fields:
        a, b = getattr(out, f).numpy(), np.asarray(getattr(ref, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5, err_msg=f)
    # no prompts: no relevancy
    assert TL.make_lerf_integrate_fn(E)(t(raw), t(z), t(rays_d)).relevancy \
        is None


def test_clip_embedding_and_relevancy_match_jax():
    raw, z, _, pos, neg = _raw(seed=3)
    w = np.random.RandomState(4).uniform(0, 0.2, z.shape).astype(np.float32)
    emb = raw[..., :E]
    for norm in (True, False):
        np.testing.assert_allclose(
            TL.render_clip_embedding(t(emb), t(w), norm).numpy(),
            np.asarray(JL.render_clip_embedding(jnp.asarray(emb),
                                                jnp.asarray(w), norm)),
            atol=1e-5)
    e = emb[:, 0]
    negs = np.concatenate([neg, -pos])
    np.testing.assert_allclose(
        TL.relevancy(t(e), t(np.concatenate([pos, neg[:1]])), t(negs))
        .numpy(),
        np.asarray(JL.relevancy(jnp.asarray(e),
                                jnp.asarray(np.concatenate([pos, neg[:1]])),
                                jnp.asarray(negs))), atol=1e-5)
    # an all-zero composite stays finite (the rsqrt epsilon)
    zero = TL.render_clip_embedding(torch.zeros(2, 3, E), torch.zeros(2, 3))
    assert torch.isfinite(zero).all() and not zero.any()


def test_lerf_network_fn_masks_density_outside_the_box():
    jf, params, tf = _fields("float32", n_in=8)
    kw = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=10,
              base_resolution=16, finest_resolution=64, scheme="random",
              primes_seed=1)
    je = JaxEncoder(BBOX, use_pallas=False, **kw)
    te = HashGridEncoder(BBOX, use_kernel=False, device="cpu", **kw)
    table = np.random.RandomState(5).uniform(
        -0.5, 0.5, (te.table_rows, 2)).astype(np.float32)
    te.table.data.copy_(t(table))
    rng = np.random.RandomState(6)
    # a third of the points outside the box
    pts = rng.uniform(BBOX[:3] * 1.6, BBOX[3:] * 1.6,
                      (16, 10, 3)).astype(np.float32)
    jnet = JL.make_lerf_network_fn(
        lambda prm, x: je({"table": prm["t"]}, x),
        lambda prm, x: jf(prm["f"], x))
    ref = np.asarray(jnet({"t": jnp.asarray(table), "f": params},
                          jnp.asarray(pts), None))
    with torch.no_grad():
        out = TL.make_lerf_network_fn(te, tf)(t(pts), None).numpy()
        out_sm = TL.make_lerf_network_fn(te, tf, sample_major=True)(
            t(pts), None).numpy()
    outside = ~np.all((pts >= BBOX[:3]) & (pts <= BBOX[3:]), axis=-1)
    assert 0 < outside.sum() < outside.size
    assert np.all(out[outside][:, E] == 0.0)
    assert np.any(out[~outside][:, E] != 0.0)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(out_sm, out)


def test_stand_in_encoder_matches_jax():
    jenc = JP.RandomProjectionPatchEncoder(embed_dim=E, input_size=8, seed=3)
    tenc = TP.RandomProjectionPatchEncoder(embed_dim=E, input_size=8, seed=3)
    assert tenc.proj.dtype == jenc.proj.dtype
    np.testing.assert_array_equal(tenc.proj, jenc.proj)
    np.testing.assert_array_equal(tenc.bias, jenc.bias)
    patches = np.random.RandomState(7).uniform(
        0, 1, (5, 20, 20, 3)).astype(np.float32)
    ref = jenc(patches)
    out = tenc(patches)
    assert isinstance(out, np.ndarray)
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    out_t = tenc(t(patches))
    assert torch.is_tensor(out_t)
    np.testing.assert_allclose(out_t.numpy(), ref, atol=1e-6, rtol=0)
    # text: the salted hash() of the same process, as the JAX package
    np.testing.assert_array_equal(tenc.encode_text(["cup", "plate"]),
                                  jenc.encode_text(["cup", "plate"]))


def test_pyramid_matches_jax_and_caches_both_ways(tmp_path):
    jemb, temb, _ = _pyramids()
    assert sorted(temb.grids) == sorted(jemb.grids)
    assert temb.image_sizes == jemb.image_sizes
    for k, g in jemb.grids.items():
        assert temb.grids[k].dtype == np.float32
        np.testing.assert_allclose(temb.grids[k], g, atol=1e-6, rtol=0,
                                   err_msg=str(k))
    # the npz cache, written by each package and read by the other
    jemb.save(tmp_path / "jax.npz")
    temb.save(tmp_path / "port.npz")
    from_jax = TP.PyramidEmbedding.load(tmp_path / "jax.npz")
    from_port = JP.PyramidEmbedding.load(tmp_path / "port.npz")
    assert from_jax.props == TP.PyramidEmbedderProperties(
        **vars(jemb.props))
    for k in jemb.grids:
        np.testing.assert_array_equal(from_jax.grids[k], jemb.grids[k])
        np.testing.assert_array_equal(from_port.grids[k], temb.grids[k])
    # compute_or_load reads the cache instead of computing
    again = TP.compute_or_load_pyramid(None, None, temb.props,
                                       tmp_path / "jax.npz", device="cpu")
    np.testing.assert_array_equal(again.grids[(1, 0)], jemb.grids[(1, 0)])


def test_device_pyramid_lookup_matches_jax():
    from nerfpp_tpu.data.dataset import DevicePyramid as JaxPyramid
    jemb, _, _ = _pyramids()
    temb = TP.PyramidEmbedding(TP.PyramidEmbedderProperties(
        **vars(jemb.props)), jemb.image_sizes)
    temb.grids = dict(jemb.grids)
    rng = np.random.RandomState(9)
    xs = rng.randint(0, 52, 300).astype(np.int32)
    ys = rng.randint(0, 40, 300).astype(np.int32)
    for scale in (0.5, 0.75, 2.0):
        jp = JP.make_device_pyramid(jemb, scale=scale)
        tp_ = TP.make_device_pyramid(temb, scale=scale, device="cpu")
        assert isinstance(jp, JaxPyramid)
        assert (tp_.wins, tp_.strides, tp_.t) == (jp.wins, jp.strides, jp.t)
        for img in (0, 1):
            ref = np.asarray(jp.lookup(img, jnp.asarray(xs), jnp.asarray(ys)))
            out = tp_.lookup(img, torch.as_tensor(xs), torch.as_tensor(ys))
            np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)
    # the dense map: the same numpy code in both packages
    np.testing.assert_allclose(temb.dense_pixel_embeddings(1),
                               jemb.dense_pixel_embeddings(1), atol=1e-6)


def test_pyramid_heatmap_matches_jax_png(tmp_path):
    pytest.importorskip("cv2")
    jemb, _, images = _pyramids()
    temb = TP.PyramidEmbedding(TP.PyramidEmbedderProperties(
        **vars(jemb.props)), jemb.image_sizes)
    temb.grids = dict(jemb.grids)
    enc = JP.RandomProjectionPatchEncoder(embed_dim=E, input_size=8)
    pos = enc(images[:1, 8:24, 8:24])
    neg = enc(np.stack([images[1, :16, :16], np.zeros((16, 16, 3),
                                                      np.float32)]))
    for blend in (None, images[1]):
        name = "plain" if blend is None else "blend"
        rj = jax_debug.save_relevancy_heatmap(jemb, 1, pos, neg,
                                              tmp_path / f"jax_{name}.png",
                                              image=blend)
        rt = port_debug.save_relevancy_heatmap(temb, 1, pos, neg,
                                               tmp_path / f"port_{name}.png",
                                               image=blend)
        np.testing.assert_allclose(rt, rj, atol=1e-6)
        assert rt.std() > 0
        a = read_png(tmp_path / f"port_{name}.png")
        b = read_png(tmp_path / f"jax_{name}.png")
        assert a.shape == b.shape == (40, 52, 3)
        np.testing.assert_array_equal(a, b)


def test_render_view_with_relevancy_matches_jax():
    jx = JaxExecutor(jax_hashnerf_preset(**_tiny_preset()))
    jx.initialize(BBOX, 250, seed=0)
    params = jax.tree.map(np.array, jx.state["params"])
    rng = np.random.RandomState(11)
    for head in ("embed", "lang_embed"):
        params[head]["table"] = rng.uniform(
            -0.5, 0.5, params[head]["table"].shape).astype(np.float32)
    jx.state["params"] = jax.tree.map(jnp.asarray, params)
    pos = rng.normal(0, 1, (1, E)).astype(np.float32)
    neg = rng.normal(0, 1, (2, E)).astype(np.float32)
    jx.lerf_positives, jx.lerf_negatives = jnp.asarray(pos), jnp.asarray(neg)
    tx = NeRFExecutor(hashnerf_preset(**_tiny_preset()), device="cpu")
    tx.initialize(BBOX, 250, seed=0)
    tx.load_state(state_from_jax(params, device="cpu"))
    tx.set_lerf_prompts(pos, neg)
    pose = pose_spherical(30.0, -30.0, 3.0)
    k = calibration_matrix(26.0, 24, 24)
    kw = dict(n_samples=8, chunk=256)
    ref = jx.render_view(pose, 24, 24, k, JaxTrainParams(**kw))["lerf"]
    out = tx.render_view(pose, 24, 24, k, TrainParams(**kw))["lerf"]
    for f in ("rendered_lang_embedding", "acc", "depth", "disp",
              "relevancy"):
        a, b = getattr(out, f).numpy(), np.asarray(getattr(ref, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5, err_msg=f)
    assert out.relevancy.shape == (24, 24, 1)
    assert float(out.acc.max()) > 0.1 and float(out.relevancy.std()) > 0
    # per-sample fields dropped, as the JAX render drops them
    assert out.weights.shape == out.lang_embedding.shape == (0,)
