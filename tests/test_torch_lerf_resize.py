"""Port parity: the CLIP pyramid's resize (OpenCV's INTER_LINEAR in f32,
within 1e-6 of cv2.resize's) and the JET colormap and its blend (exactly
OpenCV's), on the CPU.
"""
import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.data import pyramid_clip as TP
from nerfpp_tpu_torch.utils.colormap import JET_RGB, add_weighted, apply_jet
from tests.torch_lerf_common import t

torch.set_num_threads(1)


@pytest.mark.parametrize("src,dst", [((168, 168), (336, 336)),
                                     ((336, 336), (32, 32)),
                                     ((16, 16), (8, 8)),
                                     ((13, 7), (16, 16)),
                                     ((16, 16), (9, 5)),
                                     ((20, 30), (16, 16)),
                                     ((5, 5), (40, 40))])
def test_resize_matches_opencv(src, dst):
    cv2 = pytest.importorskip("cv2")
    img = np.random.RandomState(sum(src + dst)).uniform(
        0, 1, (*src, 3)).astype(np.float32)
    ref = cv2.resize(img, (dst[1], dst[0]))
    out = TP.resize_linear(t(img), dst).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    # batched: each image as alone
    both = TP.resize_linear(t(np.stack([img, img[::-1]])), dst).numpy()
    np.testing.assert_array_equal(both[0], out)


def test_jet_and_blend_equal_opencv():
    cv2 = pytest.importorskip("cv2")
    v = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        apply_jet(v), cv2.applyColorMap(v[None], cv2.COLORMAP_JET)[0][:, ::-1])
    assert JET_RGB.shape == (256, 3)
    rng = np.random.RandomState(10)
    a = rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)
    b = rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)
    np.testing.assert_array_equal(add_weighted(a, 0.5, b, 0.5, 0.0),
                                  cv2.addWeighted(a, 0.5, b, 0.5, 0.0))
