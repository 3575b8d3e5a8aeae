"""Port parity: the predicted-normals head of NeRFSmall, and the train
loop's trace (train(profile_dir=), utils/profiling.py).

NeRFSmall with the head against the JAX NeRFSmall on converted parameters
in f32 and bf16; convert.py's normals_net; the head built only in a
coarse-only net (both packages); one coarse-only train step of the
flagship stack with the head against the JAX step (test_torch_train_step.py's
tiny configuration without the tile budget and the phased refresh, whose
JAX compile alone takes 14 s more; its state, batch and tolerances); the
head changes nothing
else in the port: a seed gives every other parameter the same weights,
the step's metrics and shared gradients are bitwise those of the headless
stack, and so are the budgeted training render (its raw carries the
head's channels after the headless ones) and a served view through the
sample-major blocked path and the auto budget. Then a CPU train run with
profile_dir writes a trace.
"""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_train_common as TT
from nerfpp_tpu.config import TrainParams as JaxTrainParams
from nerfpp_tpu.config import hashnerf_preset as jax_hashnerf_preset
from nerfpp_tpu.core import occupancy as JO
from nerfpp_tpu.core.rays import calibration_matrix, pose_spherical
from nerfpp_tpu.data import dataset as JD
from nerfpp_tpu.executor import NeRFExecutor as JaxExecutor
from nerfpp_tpu.models.nerf_small import NeRFSmall as JaxNeRFSmall
from nerfpp_tpu_torch.config import (TrainParams, hashnerf_blocked_preset,
                                     hashnerf_preset)
from nerfpp_tpu_torch.convert import state_from_jax
from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
from nerfpp_tpu_torch.executor import NeRFExecutor
from nerfpp_tpu_torch.models.nerf_small import NeRFSmall
from nerfpp_tpu_torch.render import renderer as TR
from nerfpp_tpu_torch.utils.profiling import TRACE_FILE

torch.set_num_threads(1)

BBOX = TT.BBOX
HEAD = dict(TT.TINY, use_pred_normal=True, occ_tile_budget_frac=0.0,
            occ_phased_refresh=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nerf_small_with_normals_matches_jax(dtype):
    # 8 hash features + 16 SH features; sigma 1 + geo 15; normals net
    # [1 + 15 + 8] -> 32 -> 32 -> 3. f32: the same products summed in
    # another order (rtol 1e-5); bf16: the operands round to bf16 on both
    # sides, so a hidden value one f32 ulp apart can land on the
    # neighbouring bf16 value: 99% within 1e-3, every entry within 3e-2
    jm = JaxNeRFSmall(3, 64, 15, 4, 64, True, 3, 32, 8, 16,
                      compute_dtype=jnp.bfloat16 if dtype == "bfloat16"
                      else None, init_gain=1.0)
    rng = np.random.RandomState(3)
    params = {net: [{"w": (rng.standard_normal((a, b))
                           / np.sqrt(a)).astype(np.float32)}
                    for a, b in zip(dims[:-1], dims[1:])]
              for net, dims in (("sigma_net", jm._dims_sigma()),
                                ("color_net", jm._dims_color()),
                                ("normals_net", jm._dims_normals()))}
    assert [w["w"].shape for w in params["normals_net"]] == [
        (24, 32), (32, 32), (32, 3)]
    st = state_from_jax({"model": params}, device="cpu")
    assert st["model.normals_net.layers.0.weight"].shape == (32, 24)
    np.testing.assert_array_equal(st["model.normals_net.layers.2.weight"],
                                  params["normals_net"][2]["w"].T)
    tm = NeRFSmall(3, 64, 15, 4, 64, True, 8, 16, compute_dtype=dtype,
                   init_gain=1.0, device="cpu", num_layers_normals=3,
                   hidden_dim_normals=32)
    tm.load_state_dict({k[6:]: v for k, v in st.items()})
    x = np.random.RandomState(0).standard_normal((512, 24)).astype(
        np.float32)
    want = np.asarray(jm(params, jnp.asarray(x)))
    got = tm(torch.as_tensor(x)).detach().numpy()
    assert got.shape == want.shape == (512, 7)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        diff = np.abs(got - want)
        scale = np.abs(want).max()
        assert np.mean(diff <= 1e-3 * scale) >= 0.99
        assert diff.max() <= 3e-2 * scale
    # the head's channels come last: rgb and sigma are the headless net's
    bare = NeRFSmall(3, 64, 15, 4, 64, False, input_ch=8, input_ch_views=16,
                     compute_dtype=dtype, init_gain=1.0, device="cpu")
    bare.load_state_dict({k[6:]: v for k, v in st.items()
                          if "normals" not in k})
    assert torch.equal(bare(torch.as_tensor(x)).detach(),
                       torch.as_tensor(got[:, :4]))


def test_head_only_in_a_coarse_only_net():
    for n_imp, has in ((0, True), (8, False)):
        kw = dict(n_levels=2, log2_hashmap_size=10, n_importance=n_imp,
                  use_pred_normal=True, num_layers_normals=2,
                  hidden_dim_normals=16)
        jm = JaxExecutor(jax_hashnerf_preset(**kw))._build_model(4, 16)
        assert jm.use_pred_normal == has
        tx = NeRFExecutor(hashnerf_preset(**kw), device="cpu")
        tx.initialize(BBOX, seed=0)
        names = {k: tuple(v.shape) for k, v in tx.named_parameters().items()
                 if "normals_net" in k}
        assert names == ({"model.normals_net.layers.0.weight": (16, 20),
                          "model.normals_net.layers.1.weight": (3, 16)}
                         if has else {})


def _jax_state_and_sampler():
    jx = JaxExecutor(jax_hashnerf_preset(compute_dtype="float32", **HEAD))
    tp = JaxTrainParams(**TT.TINY_TP)
    jx.initialize(BBOX, tp.lrate_decay, seed=0)
    jx.state["occupancy"] = JO.OccupancyGrid(
        density=jnp.asarray(TT._sphere_grid()))
    h = w = 32
    poses = np.stack([pose_spherical(a, -30.0, 3.0) for a in (0, 120, 240)])
    sampler = JD.RayBatchSampler(
        images=jnp.asarray(TT._images(3, h, w, seed=1)),
        poses=jnp.asarray(poses),
        intrinsics=jnp.asarray(np.stack([calibration_matrix(33.0, w, h)] * 3)),
        h=h, w=w, batch_size=tp.n_rand, tile_h=8, tile_w=16)
    return jx, jx._build_train_step(tp), sampler


def test_train_step_with_normals_matches_jax(monkeypatch):
    # test_torch_train_step.py's step (blocked scheme, f32 table gather, the
    # tile-shared occupancy render, Huber loss, Adam)
    # with the head: no loss reads it, so its gradient is zero on both
    # sides and it does not move
    monkeypatch.setattr(TT, "TINY", HEAD)
    jx, step_fn, sampler = _jax_state_and_sampler()
    key = jax.random.PRNGKey(1)
    jstate = {**jx.state, "step": jnp.int32(TT.STEP)}
    new, jm = step_fn(jstate, sampler, key)
    # the step's own batch (test_torch_train_step.py's _batch), sampled in one
    # jitted call: the same values, a quarter of the eager call's time
    kb = jax.random.split(jax.random.fold_in(key, TT.STEP), 5)[0]
    batch = {k: TT.t(v) for k, v in jax.jit(
        lambda s_, k_: s_.sample(k_, jnp.int32(TT.STEP)))(
            sampler, kb).items()}
    tx = TT._port_from("float32", jstate)
    assert tx.model.normals_net is not None
    # the port without the head, from the same state
    bare = NeRFExecutor(hashnerf_preset(compute_dtype="float32", **dict(
        HEAD, use_pred_normal=False)), device="cpu").initialize(BBOX, seed=0)
    bare.load_state({k: v.clone() for k, v in tx.state_dict().items()
                     if "normals_net" not in k})
    tm = tx._build_train_step(TrainParams(**TT.TINY_TP))(TT.STEP, batch)
    for k in ("loss", "mse", "img_loss", "psnr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    mu = TT._leaves(new["opt_state"][0].mu)
    params = TT._leaves(new["params"])
    old = TT._leaves(jx.state["params"])
    assert set(mu) == set(tx.named_parameters())
    for name, prm in tx.named_parameters().items():
        gj, gt_ = mu[name] / 0.1, prm.grad.numpy()
        if "normals_net" in name:
            assert not gj.any() and not gt_.any(), name
            np.testing.assert_array_equal(params[name], old[name])
            np.testing.assert_array_equal(prm.detach().numpy(), old[name])
            continue
        # test_torch_train_step.py's f32 bounds: 95% within 1e-4 of the largest
        # entry, every entry within 5e-3
        scale = float(np.abs(gj).max())
        diff = np.abs(gt_ - gj)
        assert scale > 0 and np.mean(diff <= 1e-4 * scale) >= 0.95, name
        assert diff.max() <= 5e-3 * scale, (name, diff.max() / scale)

    # without the head: bitwise the same metrics and shared gradients, as
    # the card's run is predicted to be
    bm = bare._build_train_step(TrainParams(**TT.TINY_TP))(TT.STEP, batch)
    for k in bm:
        assert torch.equal(bm[k], tm[k]), k
    for name, prm in bare.named_parameters().items():
        assert torch.equal(prm.grad, tx.named_parameters()[name].grad), name


def test_seeded_head_leaves_every_other_parameter():
    kw = dict(n_importance=0, use_occupancy_grid=True, log2_hashmap_size=10,
              n_levels=2, finest_resolution=32, occ_grid_resolution=16)
    head = NeRFExecutor(hashnerf_blocked_preset(use_pred_normal=True, **kw),
                        device="cpu").initialize(BBOX, seed=4)
    bare = NeRFExecutor(hashnerf_blocked_preset(**kw),
                        device="cpu").initialize(BBOX, seed=4)
    hp, bp = head.named_parameters(), bare.named_parameters()
    assert set(hp) - set(bp) == {f"model.normals_net.layers.{i}.weight"
                                 for i in range(3)}
    for k, v in bp.items():
        assert torch.equal(hp[k], v), k
    # the collapse restart draws in the same order
    head._restart_state(seed=9)
    bare._restart_state(seed=9)
    for k, v in bare.named_parameters().items():
        assert torch.equal(head.named_parameters()[k], v), k
    # a table with signal and a sphere in the grid, on both stacks
    g = torch.Generator().manual_seed(5)
    table = torch.rand(head.embedder.table.shape, generator=g) * 0.2 - 0.1
    grid = torch.as_tensor(TT._sphere_grid())
    for ex in (head, bare):
        with torch.no_grad():
            ex.embedder.table.copy_(table)
        ex.load_state({"occupancy": grid})
    assert head._sample_major()
    # the budgeted training render, raw returned: the head's channels
    # follow the headless ones in both classes
    o, d, cone = TT._batch_rays(512, 3)
    res = {}
    for name, ex in (("head", head), ("bare", bare)):
        tp = TrainParams(n_samples=8, return_raw=True)
        cfg = ex.make_render_config(tp, train=False, return_weights=True)
        res[name] = TR.render_ray_batch_budgeted(
            ex._nerf_fns(), TR.make_nerf_integrate_fn(cfg), TT.t(o),
            TT.t(d), torch.tensor(cone), cfg, ex._tensor(BBOX),
            occupancy=ex.occupancy, dense_frac=0.5, sparse_samples=4,
            generator=torch.Generator().manual_seed(0))
    for a, b in zip(res["head"][:2], res["bare"][:2]):
        assert a.raw.shape[-1] == 7 and b.raw.shape[-1] == 4
        assert torch.equal(a.raw[..., :4], b.raw)
        for f in ("rgb", "depth", "acc", "weights"):
            assert torch.equal(getattr(a.outputs, f), getattr(b.outputs, f))
    # a served view: the auto two-class budget, tile order, sample-major
    k, pose = calibration_matrix(20.0, 24, 24), pose_spherical(30, -30, 3)
    views = [ex.render_view(pose, 24, 24, k, TrainParams(n_samples=8))
             for ex in (head, bare)]
    assert torch.equal(views[0]["nerf"].rgb, views[1]["nerf"].rgb)
    assert torch.equal(views[0]["nerf"].depth, views[1]["nerf"].depth)


def test_train_with_profile_dir_writes_a_trace(tmp_path):
    sc = make_synthetic_scene(n_train=2, n_val=1, n_test=1, image_hw=16,
                              n_samples=16, white_bkgr=False, device="cpu")
    tp = TrainParams(n_samples=8, n_rand=128, chunk=128, n_iters=21,
                     i_print=0, i_img=0, i_weights=0, i_testset=0,
                     base_dir=str(tmp_path / "out"))
    # the grid refreshed at step 0 only: fewer operations to trace
    ex = TT._tiny_port(use_pred_normal=True)
    ex.params.occ_update_every = 32
    seen = []
    build = ex._build_train_step

    def counting(tp_, *a):
        step = build(tp_, *a)

        def run(i, *args, **kw):
            seen.append((i, torch.autograd._profiler_enabled()))
            return step(i, *args, **kw)
        return run
    ex._build_train_step = counting
    ex.train(sc, tp, profile_dir=str(tmp_path / "trace"))
    # steps 9-19 (start + 9 to start + 20) ran inside the trace, no other
    assert [i for i, on in seen if on] == list(range(9, 20))
    events = json.loads((tmp_path / "trace" / TRACE_FILE).read_text())[
        "traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
