"""utils/webp.py on lossless WebP, on the CPU, held to cv2: the VP8L reader
bit for bit against cv2.imread(IMREAD_UNCHANGED) on files cv2.imwrite
writes (gray, RGB, RGBA, 2-, 3-, 4-, 16- and 200-colour palettes, noise,
gradients) and on files Pillow's libwebp writes at its other lossless
methods and qualities (the cross-colour transform, colour caches and meta
prefix codes that cv2's default leaves out); and the writer: cv2.imread of
the port's file equals cv2.imread of cv2's own file, and read_webp reads
both the same, for every fuzzed gray, RGB and RGBA image and every dtype
cv2.imwrite converts; an RGBA image with fully transparent pixels, whose
colour under alpha 0 cv2's libwebp rewrites, read back as cv2's own
(tests/test_torch_webp_transparent.py has the rest).
"""
import io

import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.utils import webp as W
from nerfpp_tpu_torch.utils.image import read_image, write_image
from tests.torch_image_common import cv2_read, to_rgb
from tests.torch_webp_common import cv2_webp, photo

torch.set_num_threads(1)

SIZES = ((1, 1), (1, 9), (7, 1), (5, 7), (16, 16), (33, 17), (64, 80))


def images(h, w, seed):
    """{kind: image in cv2's BGR(A) order} of one size."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    rgba = photo(h, w, 4, seed)
    rgba[..., 3] = np.clip(rgba[..., 3], 1, 254)
    out = {"photo": photo(h, w, 3, seed),
           "noise": rng.randint(0, 256, (h, w, 3), np.uint8),
           "gradient": np.dstack([(xx * 7 + yy * 3 + 40 * k) % 256
                                  for k in range(3)]).astype(np.uint8),
           "gray": photo(h, w, 1, seed + 1),
           "rgba": rgba}
    for k in (2, 3, 4, 16, 200):
        out[f"palette{k}"] = rng.randint(0, 256, (k, 3), np.uint8)[
            rng.randint(0, k, (h, w))]
    pal = rng.randint(1, 256, (5, 4), np.uint8)
    out["palette_rgba"] = pal[rng.randint(0, 5, (h, w))]
    return out


def _read_same(path, data):
    path.write_bytes(data)
    want = cv2_read(path)
    got = W.read_webp(path, "cpu").numpy()
    assert got.shape == want.shape, path.name
    np.testing.assert_array_equal(got, want, err_msg=path.name)
    return want


@pytest.mark.parametrize("half", [0, 1])
def test_cv2s_lossless_files_read_as_cv2_reads_them(half, tmp_path):
    for j, (h, w) in enumerate(SIZES[half::2]):
        for kind, img in images(h, w, j + 10 * half).items():
            data = cv2_webp(img)
            assert data[12:16] == b"VP8L", kind
            got = _read_same(tmp_path / f"{kind}.webp", data)
            np.testing.assert_array_equal(
                got, to_rgb(img if img.ndim == 3 else np.dstack([img] * 3)))


def test_pillows_lossless_methods_read_as_cv2_reads_them(tmp_path):
    from PIL import Image
    for j, (h, w) in enumerate(((83, 96), (24, 300))):
        rgba = photo(h, w, 4, j)
        rgba[..., 3] = np.clip(rgba[..., 3], 1, 255)
        rng = np.random.RandomState(j)
        kinds = {"photo": photo(h, w, 3, j + 5), "rgba": rgba,
                 "palette": rng.randint(0, 256, (40, 3), np.uint8)[
                     rng.randint(0, 40, (h, w))]}
        for kind, img in kinds.items():
            for method, quality in ((0, 0), (0, 100), (3, 50), (6, 100)):
                buf = io.BytesIO()
                Image.fromarray(img).save(buf, "WEBP", lossless=True,
                                          method=method, quality=quality)
                _read_same(tmp_path / f"{kind}{method}_{quality}.webp",
                           buf.getvalue())


def _write_same(tmp_path, rgb, name):
    """The port's .webp of ``rgb`` (RGB(A) order) reads back in cv2 and in
    read_webp as cv2's own .webp of it does in cv2."""
    import cv2
    theirs, mine = tmp_path / f"{name}_cv2.webp", tmp_path / f"{name}.webp"
    assert cv2.imwrite(str(theirs), to_rgb(rgb))
    W.write_webp(mine, rgb)
    want = cv2_read(theirs)
    assert want is not None and mine.read_bytes()[12:16] == b"VP8L"
    got = cv2_read(mine)
    assert got is not None and got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(W.read_webp(mine, "cpu").numpy(), want)
    np.testing.assert_array_equal(W.read_webp(theirs, "cpu").numpy(), want)
    return want


@pytest.mark.parametrize("half", [0, 1])
def test_written_files_read_back_as_cv2s_own(half, tmp_path):
    for j, (h, w) in enumerate(SIZES[half::2] + ((120, 97),)):
        for kind, img in images(h, w, 3 + j + 10 * half).items():
            want = _write_same(tmp_path, to_rgb(img), kind)
            assert want.shape == (h, w, 4 if kind.endswith("rgba") else 3)
    # an opaque RGBA image is written, and read back, with 3 channels
    opaque = photo(9, 11, 4, 9)
    opaque[..., 3] = 255
    assert _write_same(tmp_path, opaque, "opaque").shape == (9, 11, 3)


def test_other_dtypes_are_converted_as_cv2_converts_them(tmp_path):
    rng = np.random.RandomState(4)
    base = rng.randn(6, 9, 3) * 200 + 100
    base[0, :4, 0] = [0.5, 1.5, 2.5, 254.5]
    cases = {"uint16": (base * 40).clip(0, 65535).astype(np.uint16),
             "int16": base.astype(np.int16), "int8": base.clip(-128, 127)
             .astype(np.int8), "int32": (base * 1e3).astype(np.int32),
             "float32": base.astype(np.float32), "float64": base,
             "bool": base > 100}
    special = base.astype(np.float32)
    special[1, :6, 1] = [np.nan, np.inf, -np.inf, 3e9, -3e9, 255.5]
    cases["float32_special"] = special
    for name, img in cases.items():
        _write_same(tmp_path, img, name)
    with pytest.raises(TypeError, match=r"c\.webp.*complex"):
        W.write_webp(tmp_path / "c.webp", base.astype(np.complex64))


def test_fully_transparent_pixels_are_refused_by_name(tmp_path):
    """Once refused, now written: the colour under alpha 0 that cv2's
    libwebp leaves is reproduced, so cv2 reads the port's file back as it
    reads its own."""
    import cv2
    img = photo(40, 40, 4, 5)
    img[..., 3] = 255
    img[8:24, 8:24, 3] = 0
    # cv2 does not keep the colour under alpha 0: its encoder rewrites it
    assert cv2.imwrite(str(tmp_path / "cv2.webp"), to_rgb(img))
    back = cv2_read(tmp_path / "cv2.webp")
    np.testing.assert_array_equal(back[..., 3], img[..., 3])
    assert not np.array_equal(back[8:24, 8:24, :3], img[8:24, 8:24, :3])
    W.write_webp(tmp_path / "a.webp", img)
    write_image(tmp_path / "b.webp", torch.from_numpy(img), "cpu")
    for name in ("a.webp", "b.webp"):
        np.testing.assert_array_equal(cv2_read(tmp_path / name), back)
        np.testing.assert_array_equal(
            read_image(tmp_path / name, "cpu").numpy(), back)


def test_write_image_goes_by_the_extension(tmp_path):
    img = photo(13, 21, 3, 6)
    write_image(tmp_path / "v.webp", torch.from_numpy(img), "cpu")
    np.testing.assert_array_equal(read_image(tmp_path / "v.webp", "cpu")
                                  .numpy(), img)
    np.testing.assert_array_equal(cv2_read(tmp_path / "v.webp"), img)
    # the encoder is deterministic and takes tensors and arrays alike
    assert W.encode_webp(torch.from_numpy(img)) == W.encode_webp(img) == \
        (tmp_path / "v.webp").read_bytes()
    for bad in (np.zeros((4, 4, 2), np.uint8), np.zeros((0, 3, 3), np.uint8),
                np.zeros((1, 16384, 3), np.uint8)):
        with pytest.raises(ValueError, match=r"bad\.webp"):
            W.write_webp(tmp_path / "bad.webp", bad)
