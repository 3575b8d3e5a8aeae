"""utils/jpeg2000.py's writer against OpenCV on the CPU: the port's .jp2 of
an image is cv2.imwrite's own file of that image (OpenCV 5.0.0's OpenJPEG
2.5.3 at its defaults: one tile, reversible 5/3 with five decompositions,
64 x 64 code-blocks, LRCP, one layer cut to rate 4 by OpenJPEG's
distortion estimates and threshold search), byte for byte, and so reads
back in cv2 to the same pixels:

- gray, RGB and RGBA at 8 and 16 bits, at three sizes each;
- a flat image, whose passes would all fit the budget, and noise, where
  the search cuts most;
- the dtypes cv2 converts to uint8 first (int8, int16, int32, float32,
  float64, bool), and the sizes (below 32 pixels a side) and shapes where
  cv2.imwrite fails, which raise ValueError;
- ``write_image`` by the .jp2 extension.
"""
import cv2
import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.utils import jpeg2000 as J
from nerfpp_tpu_torch.utils.image import read_image, write_image
from tests.torch_image_common import cv2_jp2, pattern, to_rgb

torch.set_num_threads(1)


def image(kind, h, w, seed):
    c = {"gray": 1, "rgb": 3, "rgba": 4}[kind.rstrip("0123456789")]
    img = pattern(h, w, c, seed)
    if kind.endswith("16"):
        noise = np.random.RandomState(seed).randint(0, 257, img.shape)
        img = (img.astype(np.uint32) * 257 + noise).clip(0, 65535).astype(
            np.uint16)
    return img


def cv2_order(img):
    return img if img.ndim == 2 else img[..., [2, 1, 0, 3][:img.shape[2]]]


def decoded(data: bytes):
    return to_rgb(cv2.imdecode(np.frombuffer(data, np.uint8),
                               cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "rgba8", "gray16",
                                  "rgb16", "rgba16"])
def test_port_files_are_opencvs(kind):
    for seed, (h, w) in enumerate(((32, 32), (33, 40), (71, 45))):
        img = image(kind, h, w, seed)
        want = cv2_jp2(cv2_order(img))
        got = J.encode_jpeg2000(img, "cpu")
        assert got == want, (kind, h, w, len(got), len(want))
        np.testing.assert_array_equal(decoded(got), decoded(want))


def test_budget_extremes():
    # a flat image: every pass would fit the budget, yet OpenJPEG's search
    # stops short of the last one (77 comes back as 76 from cv2's own
    # file too); noise: the search cuts most passes
    flat = np.full((40, 40), 77, np.uint8)
    assert J.encode_jpeg2000(flat, "cpu") == cv2_jp2(flat)
    np.testing.assert_array_equal(decoded(cv2_jp2(flat)), flat - 1)
    for shape in ((64, 64, 3), (45, 90), (33, 32, 4)):
        noise = np.random.RandomState(3).randint(0, 256, shape).astype(
            np.uint8)
        want = cv2_jp2(cv2_order(noise))
        assert J.encode_jpeg2000(noise, "cpu") == want, shape
        assert len(want) < noise.size // 4 + 300


def test_dtypes_converted_as_opencv_converts_them():
    rng = np.random.RandomState(4)
    x = rng.randn(36, 40, 3) * 120 + 100
    x[0, :4, 0] = (255.5, 254.5, -0.5, 300.0)
    for img in (x.astype(np.int8), x.astype(np.int16), x.astype(np.int32),
                x.astype(np.float32), x, x > 100):
        want = cv2_jp2(np.ascontiguousarray(img[..., ::-1]))
        assert J.encode_jpeg2000(img, "cpu") == want, img.dtype
        assert J.encode_jpeg2000(torch.from_numpy(img), "cpu") == want
    gray = image("gray16", 40, 36, 5)
    assert J.encode_jpeg2000(gray[..., None], "cpu") == cv2_jp2(gray)


def test_sizes_and_shapes_opencv_cannot_write_raise(tmp_path):
    for h, w in ((31, 32), (32, 31), (16, 64), (64, 16), (1, 1)):
        img = pattern(h, w, 3, 6)
        assert not cv2.imwrite(str(tmp_path / "small.jp2"), img)
        with pytest.raises(ValueError, match=rf"small\.jp2: {w}x{h} is "
                           "smaller than 32 pixels a side"):
            write_image(tmp_path / "small.jp2", img, "cpu")
    for shape in ((40, 40, 2), (40, 40, 5), (40,), (2, 40, 40, 3)):
        with pytest.raises(ValueError, match=r"bad\.jp2: JPEG 2000 takes "
                           "gray, RGB or RGBA images"):
            write_image(tmp_path / "bad.jp2", np.zeros(shape, np.uint8),
                        "cpu")


def test_write_image_by_extension(tmp_path):
    img = image("rgba8", 40, 52, 7)
    write_image(tmp_path / "a.jp2", torch.from_numpy(img), "cpu")
    assert cv2.imwrite(str(tmp_path / "b.jp2"), cv2_order(img))
    assert (tmp_path / "a.jp2").read_bytes() == (tmp_path / "b.jp2"
                                                 ).read_bytes()
    np.testing.assert_array_equal(read_image(tmp_path / "a.jp2", "cpu")
                                  .numpy(), decoded((tmp_path / "b.jp2")
                                                    .read_bytes()))
