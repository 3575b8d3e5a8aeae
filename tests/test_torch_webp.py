"""utils/webp.py's reader on lossy WebP against cv2.imread(IMREAD_UNCHANGED),
bit for bit, on the CPU: files cv2.imencode writes here at qualities 1 to
100 and at sizes 1x1, 1xN, Nx1 and sides that are not multiples of 16, of
photo-like and noise images; lossy images with alpha (VP8X + ALPH); the
chunk layouts cv2 does not write (ICCP, EXIF, XMP and unknown chunks, raw
and filtered alpha, the VP8X alpha flag without an ALPH chunk); key frames
made here with what cv2's encoder never writes (the simple filter,
sharpness, several token partitions, segment features, loop-filter deltas,
probability updates); an animation read as cv2 reads it (its first frame;
tests/test_torch_webp_animated.py has the rest); malformed files as cv2's
None; the device
stage against a plain reading of libwebp's scalar upsampler; and the
committed fixtures that the card is held to (tests/data/image/webp_*).
"""
import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.utils import webp as W
from nerfpp_tpu_torch.utils.image import image_format, read_image
from tests.torch_image_common import FIXTURES, cv2_read
from tests.torch_webp_common import (TIMING, alpha_residuals, chunk, cv2_webp,
                                     fixture_files, image_chunk, photo, riff,
                                     timing_file, vp8_frame, vp8x)

torch.set_num_threads(1)

SIZES = ((1, 1), (1, 7), (9, 1), (16, 16), (17, 33), (31, 45), (64, 80),
         (3, 200))


def _same(path, data=None):
    """read_webp of ``path`` (written from ``data``) is cv2's."""
    if data is not None:
        path.write_bytes(data)
    want = cv2_read(path)
    got = W.read_webp(path, "cpu").numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape, path.name
    np.testing.assert_array_equal(got, want, err_msg=path.name)
    return got


@pytest.mark.parametrize("kind", ["photo", "noise"])
def test_lossy_files_read_as_cv2_reads_them(kind, tmp_path):
    rng = np.random.RandomState(0 if kind == "photo" else 1)
    for j, (h, w) in enumerate(SIZES):
        for quality in (1, 9, 30, 50, 75, 90, 100):
            img = (photo(h, w, 3, j + 10 * quality) if kind == "photo"
                   else rng.randint(0, 256, (h, w, 3), np.uint8))
            data = cv2_webp(img, quality)
            assert data[12:16] == b"VP8 "
            got = _same(tmp_path / "x.webp", data)
            assert got.shape == (h, w, 3)


def test_lossy_files_with_alpha_read_as_cv2_reads_them(tmp_path):
    rng = np.random.RandomState(2)
    for j, (h, w) in enumerate(SIZES[::2] + ((40, 57),)):
        for quality in (5, 50, 95, 100):
            img = photo(h, w, 4, j)
            img[..., 3] = (rng.randint(0, 256, (h, w)) if quality % 2
                           else photo(h, w, 1, 7 + j))
            img[0, 0, 3] = 100          # not opaque: cv2 writes VP8X + ALPH
            data = cv2_webp(img, quality)
            assert data[12:16] == b"VP8X" and b"ALPH" in data[:64]
            assert _same(tmp_path / "a.webp", data).shape == (h, w, 4)


def test_extended_files_skip_chunks_as_libwebp_does(tmp_path):
    img = photo(21, 30, 3, 3)
    _, frame = image_chunk(cv2_webp(img, 80))
    _, stream = image_chunk(cv2_webp(img))
    rng = np.random.RandomState(4)
    iccp = chunk(b"ICCP", rng.bytes(37))
    exif = chunk(b"EXIF", b"Exif\0\0" + rng.bytes(20))
    meta = chunk(b"XMP ", b"<x/>") + chunk(b"ABCD", b"xyz")
    cases = {
        "iccp_exif": (vp8x(30, 21, 0x28) + iccp + chunk(b"VP8 ", frame)
                      + exif + meta, 3),
        "unknown_first": (vp8x(30, 21, 0) + meta + chunk(b"VP8 ", frame), 3),
        # the alpha flag without ALPH: four channels, alpha 255
        "flag_no_alph": (vp8x(30, 21, 0x10) + chunk(b"VP8 ", frame), 4),
        "lossless_iccp": (vp8x(30, 21, 0x20) + iccp + chunk(b"VP8L", stream),
                          3),
        "lossless_flag": (vp8x(30, 21, 0x10) + chunk(b"VP8L", stream), 4),
    }
    for name, (body, channels) in cases.items():
        got = _same(tmp_path / f"{name}.webp", riff(body))
        assert got.shape == (21, 30, channels), name
        if channels == 4:
            assert (got[..., 3] == 255).all()
    assert image_format(tmp_path / "iccp_exif.webp") == "webp"
    np.testing.assert_array_equal(
        read_image(tmp_path / "iccp_exif.webp", "cpu").numpy(),
        cv2_read(tmp_path / "iccp_exif.webp"))


def test_raw_and_compressed_alpha_with_each_filter(tmp_path):
    h, w = 19, 26
    _, frame = image_chunk(cv2_webp(photo(h, w, 3, 5), 70))
    rng = np.random.RandomState(5)
    alpha = np.clip(photo(h, w, 1, 6).astype(int)
                    + rng.randint(-40, 40, (h, w)), 0, 255).astype(np.uint8)
    for filt in range(4):
        res = alpha_residuals(alpha, filt)
        raw = chunk(b"ALPH", bytes([filt << 2]) + res.tobytes())
        # VP8L-compressed alpha: the residuals in the green channel of a
        # lossless stream without its 5-byte header, pre-processing bit set
        rgb = np.dstack([np.zeros_like(res), res, np.zeros_like(res)])
        _, stream = image_chunk(cv2_webp(rgb))
        packed = chunk(b"ALPH", bytes([1 | filt << 2 | 1 << 4]) + stream[5:])
        for name, alph in (("raw", raw), ("vp8l", packed)):
            got = _same(tmp_path / f"{name}{filt}.webp",
                        riff(vp8x(w, h, 0x10) + alph + chunk(b"VP8 ", frame)))
            np.testing.assert_array_equal(got[..., 3], alpha)
        # without the VP8X alpha flag the ALPH chunk is not read
        got = _same(tmp_path / f"noflag{filt}.webp",
                    riff(vp8x(w, h, 0) + raw + chunk(b"VP8 ", frame)))
        assert got.shape == (h, w, 3)


@pytest.mark.parametrize("part", ["filters", "segments"])
def test_generated_frames_read_as_cv2_reads_them(part, tmp_path):
    # what libwebp's encoder at cv2's defaults never writes: the simple
    # filter, sharpness 1-7, 2-8 token partitions, skipped macroblocks (the
    # first case); explicit and delta segment features with a segment map,
    # loop-filter deltas and coefficient-probability updates (the second)
    rng = np.random.RandomState(0 if part == "filters" else 1)
    for k in range(32):
        # every other frame smooth and at a low level, where the interior
        # limit that the sharpness sets decides
        low = k % 2 == 0
        w, h = (int(rng.randint(32, 64) if low else rng.randint(1, 50))
                for _ in range(2))
        kw = dict(level=int(rng.randint(2, 12) if low else rng.randint(64)),
                  q=int(rng.randint(0, 128)),
                  max_coeff=3 if low else int(rng.choice([3, 40, 300])))
        if part == "filters":
            kw.update(simple=k % 4 == 2, sharpness=k // 2 % 8,
                      parts=(1, 2, 4, 8)[k % 4],
                      skip_prob=(None if k % 5 == 0
                                 else int(rng.randint(1, 256))))
        else:
            absolute = k % 2
            kw.update(segments=(
                int(k % 3 != 0), absolute,
                [None if rng.rand() < 0.2 else
                 int(rng.randint(0, 128) if absolute else rng.randint(-40, 60))
                 for _ in range(4)],
                [None if rng.rand() < 0.2 else
                 int(rng.randint(0, 64) if absolute else rng.randint(-30, 40))
                 for _ in range(4)]),
                lf_delta=([int(rng.randint(-63, 64)) for _ in range(4)],
                          [int(rng.randint(-63, 64)) for _ in range(4)]),
                updates=(0.02, 0.3)[k % 2])
        frame = vp8_frame(rng, w, h, **kw)
        got = _same(tmp_path / f"g{k}.webp", riff(chunk(b"VP8 ", frame)
                                                  + bytes(32)))
        assert got.shape == (h, w, 3)


def test_animated_files_are_refused_by_name(tmp_path):
    """Once refused, now read: an animation reads as cv2.imread reads it,
    the first frame on its canvas (tests/test_torch_webp_animated.py has
    the rest)."""
    import cv2
    rng = np.random.RandomState(6)
    anim = cv2.Animation()
    frames = [rng.randint(0, 256, (20, 24, 4), np.uint8) for _ in range(2)]
    for f in frames:
        f[..., 3] = 255
    anim.frames, anim.durations = frames, [100, 100]
    path = tmp_path / "anim.webp"
    assert cv2.imwriteanimation(str(path), anim)
    want = cv2_read(path)
    assert want.shape == (20, 24, 3)
    got = read_image(path, "cpu")
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_malformed_files_raise_where_cv2_returns_none(tmp_path):
    import cv2
    img = photo(21, 30, 3, 7)
    good = cv2_webp(img, 60)
    _, frame = image_chunk(good)
    small = chunk(b"VP8L", image_chunk(cv2_webp(img[:1, :1]))[1])
    # a frame whose coefficient data are zeros decodes, in both
    _same(tmp_path / "zeros.webp", good[:40] + bytes(len(good) - 40))
    cases = {
        "canvas": riff(vp8x(31, 21, 0) + chunk(b"VP8 ", frame)),
        "cut": good[:len(good) // 2],
        "riff_size": good[:4] + (10 ** 6).to_bytes(4, "little") + good[8:],
        "short": riff(small)[:31],
    }
    for name, data in cases.items():
        path = tmp_path / f"{name}.webp"
        path.write_bytes(data)
        assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None, name
        with pytest.raises(ValueError, match=rf"{name}\.webp"):
            W.read_webp(path, "cpu")


def _upsample_plain(c, h, w):
    """libwebp's scalar UpsampleRgbLinePair, row pair by row pair, on one
    chroma plane (ints)."""
    hc, wc = c.shape
    out = np.zeros((h, w), np.int64)

    def line(near, far, dst):
        out[dst, 0] = (3 * near[0] + far[0] + 2) >> 2
        for x in range(1, (w - 1) // 2 + 1):
            avg = near[x - 1] + near[x] + far[x - 1] + far[x] + 8
            d12 = (avg + 2 * (near[x] + far[x - 1])) >> 3
            d03 = (avg + 2 * (near[x - 1] + far[x])) >> 3
            out[dst, 2 * x - 1] = (d12 + near[x - 1]) >> 1
            out[dst, 2 * x] = (d03 + near[x]) >> 1
        if w % 2 == 0:
            out[dst, w - 1] = (3 * near[wc - 1] + far[wc - 1] + 2) >> 2

    line(c[0], c[0], 0)
    for k in range(1, hc):
        if 2 * k - 1 < h:
            line(c[k - 1], c[k], 2 * k - 1)
        if 2 * k < h:
            line(c[k], c[k - 1], 2 * k)
    if h % 2 == 0:
        line(c[hc - 1], c[hc - 1], h - 1)
    return out


def test_device_stage_is_libwebps_scalar_upsampler():
    rng = np.random.RandomState(8)
    for h, w in ((1, 1), (2, 2), (1, 6), (7, 1), (5, 8), (6, 9), (13, 20)):
        c = rng.randint(0, 256, ((h + 1) // 2, (w + 1) // 2))
        got = W.fancy_upsample(torch.from_numpy(c).int(), h, w).numpy()
        np.testing.assert_array_equal(got, _upsample_plain(c, h, w))


def test_committed_fixtures_are_cv2s(tmp_path):
    files = fixture_files()
    names = sorted(p.name for p in FIXTURES.glob("webp_*.webp"))
    assert names == sorted(files)
    for name in files:
        path = FIXTURES / name
        want = np.load(path.with_suffix(".npy"))
        np.testing.assert_array_equal(cv2_read(path), want, err_msg=name)
        np.testing.assert_array_equal(W.read_webp(path, "cpu").numpy(), want)
    # the card's timing file, lossy, with no .npy
    got = _same(TIMING)
    assert got.shape == (800, 800, 3)
    assert TIMING.read_bytes()[12:16] == b"VP8 "
    # the fixtures are what the installed cv2 writes today
    for name in ("webp_lossy_q80_37x21.webp", "webp_lossless_31x19.webp"):
        assert files[name] == (FIXTURES / name).read_bytes(), name
    assert timing_file() == TIMING.read_bytes()
