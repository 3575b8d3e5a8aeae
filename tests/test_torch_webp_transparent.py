"""RGBA WebP with fully transparent pixels, written as cv2.imwrite writes it:
libwebp's lossless encoder (exact off) sets every pixel of alpha 0 to 0
and, where its analysis picks the predictor transform, gives such a pixel
the colour of its prediction under the mode it picks for the tile. The
port reproduces that image (``webp.transparent_rewrite``, host C++) and
encodes it exactly, so the pixels cv2.imread reads back from the port's
file equal those it reads back from cv2.imwrite's file, the colour under
alpha 0 included:

- noise, gradients and photos with holes, rings, borders and scattered
  transparent pixels, and masked captures (most pixels transparent), each
  of libwebp's five analysis outcomes among them;
- images of 256 colours or fewer, on and off the palette path;
- 1x1, 1xN, Nx1 and odd sizes, and images of many tiles;
- an 800x800 masked view (committed, tests/data/webp) and its 4,000 x
  3,000 upscale (against the committed digest of cv2's pixels);
- the committed cv2 files the card is held to (tests/data/webp/
  transparent_*: the installed cv2 still writes them, and the port's
  rewrite of each reads back as its pixels).
"""
import hashlib

import cv2
import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.utils import webp as W
from nerfpp_tpu_torch.utils.image import read_image, write_image
from tests.torch_image_common import cv2_read, to_rgb
from tests.torch_webp_common import (TIMING, TRANSPARENT_CASES,
                                     TRANSPARENT_VIEW, UPSCALE_DIGEST,
                                     alpha_mask, bgra, cv2_webp, photo,
                                     transparent_fixture_files,
                                     transparent_image, transparent_view_file,
                                     upscale)

torch.set_num_threads(1)

MASKS = ("holes", "ring", "border", "masked", "scatter")


def decoded(data: bytes) -> np.ndarray:
    """cv2.imdecode(IMREAD_UNCHANGED) of WebP bytes, RGB(A) order."""
    return to_rgb(cv2.imdecode(np.frombuffer(data, np.uint8),
                               cv2.IMREAD_UNCHANGED))


def argb_of(img: np.ndarray) -> np.ndarray:
    c = img.astype(np.uint32)
    return np.ascontiguousarray((c[..., 3] << 24) | (c[..., 0] << 16)
                                | (c[..., 1] << 8) | c[..., 2])


def rgba_of(argb: np.ndarray) -> np.ndarray:
    return np.stack([(argb >> 16) & 255, (argb >> 8) & 255, argb & 255,
                     argb >> 24], -1).astype(np.uint8)


def same_as_cv2(img: np.ndarray) -> str:
    """Writes ``img`` (RGBA) with the port and with cv2, asserts cv2 reads
    both back alike (and the port reads its own file the same) and returns
    the transforms libwebp picked."""
    want = decoded(cv2_webp(bgra(img)))
    mine = W.encode_webp(img)
    np.testing.assert_array_equal(decoded(mine), want)
    np.testing.assert_array_equal(
        W.frame_pixels(W.decode_planes(W.parse("m", mine)), "cpu").numpy(),
        want)
    # visible pixels stay as they were; alpha 0 keeps alpha 0
    vis = img[..., 3] > 0
    np.testing.assert_array_equal(want[vis], img[vis])
    assert (want[~vis, 3] == 0).all()
    return W.transparent_rewrite(argb_of(img))


@pytest.mark.parametrize("content", ["noise", "noise3", "photo", "gray",
                                     "palette", "ramp"])
def test_masks_on_each_content_read_back_as_cv2s(content):
    seen = set()
    for k, mask in enumerate(MASKS):
        for h, w in ((19, 23), (40, 33)):
            seen.add(same_as_cv2(transparent_image(h, w, content, mask,
                                                   k + h)))
    # at these sizes, the analysis of each content
    assert seen <= set(W.TRANSFORMS) and seen


def test_every_transform_libwebp_picks_is_covered():
    got = {case: same_as_cv2(transparent_image(h, w, content, mask, seed))
           for case in TRANSPARENT_CASES
           for content, mask, h, w, seed, _ in [case]}
    assert [got[c] for c in TRANSPARENT_CASES] == [
        c[-1] for c in TRANSPARENT_CASES]
    assert set(got.values()) == set(W.TRANSFORMS)


def test_tiny_odd_and_many_tile_sizes():
    for k, (h, w) in enumerate(((1, 1), (1, 9), (9, 1), (2, 2), (1, 300),
                                (300, 1), (3, 5), (17, 33), (65, 129),
                                (257, 300))):
        for content in ("photo", "gray", "noise"):
            img = transparent_image(h, w, content, MASKS[k % 5], k)
            if h * w > 1:
                img[0, 0, 3] = 0
            else:
                img[..., 3] = 0
            same_as_cv2(img)


def test_masked_captures_and_the_colours_under_alpha_0():
    # a photo-like view with a disc of content on a transparent ground:
    # libwebp's predictions leave colour under much of the ground
    img = photo(200, 240, 4, 3)
    img[..., 3] = 255
    img[alpha_mask(200, 240, "masked"), 3] = 0
    assert same_as_cv2(img) == "predictor"
    back = decoded(W.encode_webp(img))
    hidden = back[img[..., 3] == 0, :3]
    assert 0 < (hidden != 0).any(-1).mean() < 1
    # alpha between 1 and 254 keeps its colour, alpha 0 loses the input's
    ragged = photo(48, 64, 4, 8)
    ragged[..., 3] = np.where(ragged[..., 3] < 90, 0, ragged[..., 3])
    same_as_cv2(ragged)


def test_the_800x800_view_and_its_4000x3000_upscale():
    view = cv2_read(TRANSPARENT_VIEW)
    assert view.shape == (800, 800, 4) and (view[..., 3] == 0).mean() > 0.7
    assert transparent_view_file() == TRANSPARENT_VIEW.read_bytes()
    # cv2's file is a fixed point: its visible pixels and alpha are the
    # input's, and libwebp's rewrite depends on nothing else
    np.testing.assert_array_equal(decoded(W.encode_webp(view)), view)
    big = upscale(view)
    assert W.transparent_rewrite(big) == "predictor"
    assert hashlib.sha256(big.tobytes()).hexdigest() == \
        UPSCALE_DIGEST.read_text().strip()


def test_committed_files_are_cv2s_and_the_port_rewrites_them_alike():
    files = transparent_fixture_files()
    names = sorted(p.name for p in TIMING.parent.glob("transparent_*.webp"))
    assert names == sorted(files)
    for case in TRANSPARENT_CASES:
        content, mask, h, w, seed, kind = case
        name = f"transparent_{content}_{mask}_{w}x{h}.webp"
        path = TIMING.parent / name
        assert files[name] == path.read_bytes(), name
        want = np.load(path.with_suffix(".npy"))
        np.testing.assert_array_equal(cv2_read(path), want)
        np.testing.assert_array_equal(read_image(path, "cpu").numpy(), want)
        img = read_image(path, "cpu")
        argb = argb_of(img.numpy())
        assert W.transparent_rewrite(argb) == kind, name
        np.testing.assert_array_equal(rgba_of(argb), want)


def test_write_image_writes_through_the_rewrite(tmp_path):
    img = transparent_image(37, 45, "photo", "holes", 6)
    write_image(tmp_path / "a.webp", torch.from_numpy(img), "cpu")
    assert cv2.imwrite(str(tmp_path / "b.webp"), bgra(img))
    np.testing.assert_array_equal(cv2_read(tmp_path / "a.webp"),
                                  cv2_read(tmp_path / "b.webp"))
    # an image without alpha 0 is not rewritten
    opaque = argb_of(photo(9, 11, 4, 2).clip(1, 255))
    before = opaque.copy()
    assert W.transparent_rewrite(opaque) in W.TRANSFORMS
    np.testing.assert_array_equal(opaque, before)
    with pytest.raises(ValueError, match="uint32"):
        W.transparent_rewrite(opaque.astype(np.int64))
