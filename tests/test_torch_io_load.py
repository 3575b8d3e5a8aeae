"""Port parity: the port's Blender export loaded by both packages' loaders,
load_images (alpha, white background, the half_res halving) against the
JAX load_images, and the PNG reader on 4-channel files of every row
filter, bitwise against cv2.imread (OpenCV is imported here only, as the
reference).
"""
import numpy as np
import pytest

from nerfpp_tpu.data import blender as JB
from nerfpp_tpu.data import dataset as JD
from nerfpp_tpu_torch.data import blender as TB
from nerfpp_tpu_torch.data import dataset as TD
from nerfpp_tpu_torch.utils.png import read_png
from tests.torch_io_common import (ROW_FILTERS, _scene,
                                   reader_undoes_every_row_filter)


@pytest.mark.parametrize("half_res", [False, True])
def test_blender_export_loads_as_in_jax(tmp_path, half_res):
    sc = _scene()
    TB.export_blender_scene(sc, tmp_path / "port")
    kw = dict(half_res=half_res, testskip=False)
    ts = TB.load_blender_data(tmp_path / "port", **kw)
    js = JB.load_blender_data(tmp_path / "port", **kw)
    assert ts.splits_idx == js.splits_idx == [3, 1, 2]
    for tv, jv in zip(ts.views, js.views):
        assert (tv.id, tv.h, tv.w, tv.image_path) == (jv.id, jv.h, jv.w,
                                                      jv.image_path)
        assert tv.focal == pytest.approx(jv.focal, rel=1e-12)
        assert (tv.near, tv.far) == (jv.near, jv.far)
        np.testing.assert_array_equal(tv.pose, jv.pose)
        np.testing.assert_allclose(tv.k, jv.k, rtol=1e-6)
    # the corner rays in f32 in both packages
    np.testing.assert_allclose(ts.bounding_box, js.bounding_box, rtol=1e-5,
                               atol=1e-5)
    assert (ts.views[0].h, ts.views[0].w) == ((12, 12) if half_res
                                              else (24, 24))
    # the JAX exporter writes the same pixels
    JB.export_blender_scene(sc, tmp_path / "jax")
    for split, n in (("train", 3), ("val", 1), ("test", 2)):
        for j in range(n):
            rel = f"{split}/r_{j}.png"
            np.testing.assert_array_equal(read_png(tmp_path / "port" / rel),
                                          read_png(tmp_path / "jax" / rel))
    assert len(TB.load_blender_data(tmp_path / "port").views) == 4  # testskip


@pytest.mark.parametrize("white_bkgr", [False, True])
@pytest.mark.parametrize("half_res", [False, True])
def test_load_images_match_jax(tmp_path, white_bkgr, half_res):
    # RGBA frames: alpha dropped, or composited onto white; half_res is
    # cv2's INTER_LINEAR at exactly 1/2 in the JAX package, the rounded 2x2
    # mean here: within 1/255 (the same 8-bit value, or its neighbour)
    TB.export_blender_scene(_scene(channels=4), tmp_path)
    ts = TB.load_blender_data(tmp_path, half_res=half_res,
                              white_bkgr=white_bkgr)
    js = JB.load_blender_data(tmp_path, half_res=half_res,
                              white_bkgr=white_bkgr)
    idx = list(range(len(ts.views)))
    got = TD.load_images(ts, idx, device="cpu")
    want = JD.load_images(js, idx)
    assert got.shape == want.shape == (len(idx),) + ((12, 12, 3) if half_res
                                                      else (24, 24, 3))
    assert got.dtype == np.float32
    tol = 1.0 / 255 + 1e-6 if half_res else 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    if half_res:
        assert np.mean(np.abs(got - want) < 1e-6) > 0.9


@pytest.mark.parametrize("kind", ROW_FILTERS)
@pytest.mark.parametrize("channels", [4])
def test_reader_undoes_every_row_filter(tmp_path, kind, channels):
    reader_undoes_every_row_filter(tmp_path, kind, channels)
