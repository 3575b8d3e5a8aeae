"""Animated WebP read as cv2.imread(IMREAD_UNCHANGED) reads it: OpenCV goes
through libwebp's WebPAnimDecoder and returns the first frame on its
canvas. The canvas starts transparent black (not the ANIM background
colour), the first frame is a key frame written into its rectangle (no
blending, whatever its blend and dispose bits), and the channel count is
the VP8X header's alpha flag's (3 drops the alpha, whatever the pixels):

- cv2.imwriteanimation's and Pillow's save_all files, lossy and lossless,
  opaque and with alpha, the same pixels, shape and dtype as cv2's;
- first frames neither writes, assembled around payloads cv2 wrote as
  stills: an offset sub-rectangle, an odd stored offset, a lossy frame with
  ALPH, the alpha flag set over opaque pixels and unset over ALPH, ICCP /
  EXIF and unknown chunks, an ANMF header whose size the bitstream
  overrides;
- the committed fixtures (tests/data/webp/anim_*) still cv2's;
- files cv2 returns None for (libwebp's WebPDemux refuses them) raise
  ValueError naming the file.
"""
import cv2
import numpy as np
import pytest
import torch

from nerfpp_tpu_torch.utils.image import image_format, read_image
from tests.torch_image_common import cv2_read
from tests.torch_webp_common import (TIMING, anim, anim_fixture_files,
                                     anmf, bgra, chunk, cv2_animation,
                                     cv2_webp, photo, pillow_animation, riff,
                                     still_chunks, vp8x)

torch.set_num_threads(1)


def same(path, data: bytes) -> np.ndarray:
    """Writes ``data``, asserts read_image returns cv2.imread's array and
    returns it."""
    path.write_bytes(data)
    want = cv2_read(path)
    assert want is not None, path.name
    got = read_image(path, "cpu")
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert got.shape == want.shape, path.name
    np.testing.assert_array_equal(got.numpy(), want, err_msg=path.name)
    return want


def frames(seed, alpha=True):
    a, b = photo(20, 24, 4, seed), photo(20, 24, 4, seed + 1)
    if not alpha:
        a[..., 3] = b[..., 3] = 255
    return a, b


@pytest.mark.parametrize("quality", [None, 30, 101])
def test_cv2s_animations_read_as_cv2_reads_them(quality, tmp_path):
    for k, alpha in enumerate((True, False)):
        a, b = frames(3 * k, alpha)
        got = same(tmp_path / f"a{k}.webp",
                   cv2_animation([bgra(a), bgra(b)], quality))
        # libwebp's muxer sets the alpha flag only for frames with alpha
        assert got.shape == (20, 24, 4 if alpha else 3)
        got = same(tmp_path / f"rgb{k}.webp",
                   cv2_animation([bgra(a[..., :3]), bgra(b[..., :3])],
                                 quality))
        assert got.shape == (20, 24, 3)
        if quality == 101:          # lossless: the first frame as written
            np.testing.assert_array_equal(got, a[..., :3])


@pytest.mark.parametrize("lossless", [False, True])
def test_pillows_animations_read_as_cv2_reads_them(lossless, tmp_path):
    a, b = frames(7)
    a[..., 3] = np.clip(a[..., 3], 1, 255)
    rgba = same(tmp_path / "rgba.webp", pillow_animation([a, b], lossless))
    rgb = same(tmp_path / "rgb.webp",
               pillow_animation([a[..., :3], b[..., :3]], lossless))
    assert rgba.shape == (20, 24, 4) and rgb.shape == (20, 24, 3)
    if lossless:
        np.testing.assert_array_equal(rgba, a)
        np.testing.assert_array_equal(rgb, a[..., :3])


def test_first_frames_neither_writer_makes(tmp_path):
    small = photo(9, 13, 4, 13)
    small[..., 3] = np.clip(small[..., 3], 1, 255)
    lossy = still_chunks(cv2_webp(bgra(small[..., :3]), 70))[b"VP8 "]
    with_alpha = still_chunks(cv2_webp(bgra(small), 70))
    alph = with_alpha[b"ALPH"] + with_alpha[b"VP8 "]
    lossless = still_chunks(cv2_webp(bgra(small)))[b"VP8L"]
    cases = {
        # the offset is stored halved: 3 -> 6, 5 -> 10
        "offset": (vp8x(40, 30, 0x02) + anim(0xFF336699, 3)
                   + anmf(3, 5, 13, 9, 0, lossy), (30, 40, 3)),
        "offset_alpha_flag": (vp8x(40, 30, 0x12) + anim(0xFF336699)
                              + anmf(3, 5, 13, 9, 2, lossy), (30, 40, 4)),
        "odd_offset": (vp8x(40, 30, 0x12) + anim(0x80FFFFFF)
                       + anmf(1, 7, 13, 9, 3, lossless), (30, 40, 4)),
        "lossless_no_alpha_flag": (vp8x(40, 30, 0x02) + anim()
                                   + anmf(1, 7, 13, 9, 1, lossless),
                                   (30, 40, 3)),
        "alph": (vp8x(20, 12, 0x12) + anim() + anmf(2, 1, 13, 9, 1, alph)
                 + anmf(0, 0, 13, 9, 0, lossy), (12, 20, 4)),
        "alph_no_alpha_flag": (vp8x(20, 12, 0x02) + anim()
                               + anmf(2, 1, 13, 9, 0, alph), (12, 20, 3)),
        "exact_canvas": (vp8x(13, 9, 0x02) + anim()
                         + anmf(0, 0, 13, 9, 0, lossy), (9, 13, 3)),
        "anmf_size_overridden": (vp8x(40, 30, 0x02) + anim()
                                 + anmf(0, 0, 5, 5, 0, lossy), (30, 40, 3)),
        "metadata": (vp8x(40, 30, 0x2A) + chunk(b"ICCP", b"icc!")
                     + chunk(b"ABCD", b"12345") + anim()
                     + anmf(3, 5, 13, 9, 0, lossy) + chunk(b"EXIF", b"xyz")
                     + anim(5), (30, 40, 3)),
    }
    for name, (body, shape) in cases.items():
        got = same(tmp_path / f"{name}.webp", riff(body))
        assert got.shape == shape, name
    # outside the first frame: 0 in every channel, the background colour
    # unused; inside: the still's pixels
    got = cv2_read(tmp_path / "offset_alpha_flag.webp")
    inside = np.zeros((30, 40), bool)
    inside[10:19, 6:19] = True
    assert (got[~inside] == 0).all() and (got[inside, 3] == 255).all()
    np.testing.assert_array_equal(
        got[10:19, 6:19, :3],
        cv2_read(tmp_path / "offset.webp")[10:19, 6:19])
    got = cv2_read(tmp_path / "odd_offset.webp")
    np.testing.assert_array_equal(got[14:23, 2:15], small)


def test_committed_fixtures_are_cv2s():
    files = anim_fixture_files()
    names = sorted(p.name for p in TIMING.parent.glob("anim_*.webp"))
    assert names == sorted(files)
    for name in names:
        path = TIMING.parent / name
        want = np.load(path.with_suffix(".npy"))
        assert path.read_bytes()[12:16] == b"VP8X" and image_format(path) \
            == "webp"
        np.testing.assert_array_equal(cv2_read(path), want, err_msg=name)
        got = read_image(path, "cpu").numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    # cv2's, and those built from cv2's stills, are what the installed cv2
    # writes
    for name in names:
        if "_pil_" not in name:
            assert files[name] == (TIMING.parent / name).read_bytes(), name


def test_files_libwebps_demux_refuses_raise_naming_the_file(tmp_path):
    small = photo(9, 13, 3, 13)
    lossy = still_chunks(cv2_webp(bgra(small), 70))[b"VP8 "]
    alph = still_chunks(cv2_webp(bgra(np.dstack(
        [small, np.full((9, 13), 128, np.uint8)])), 70))[b"ALPH"]
    lossless = still_chunks(cv2_webp(bgra(small)))[b"VP8L"]
    head = vp8x(20, 12, 0x02) + anim()
    good = riff(head + anmf(0, 0, 13, 9, 0, lossy)
                + anmf(1, 1, 13, 9, 0, lossless))
    cases = {
        "outside": riff(head + anmf(4, 0, 13, 9, 0, lossy)),
        "second_outside": riff(head + anmf(0, 0, 13, 9, 0, lossy)
                               + anmf(0, 2, 13, 9, 0, lossy)),
        "cut": good[:-30],
        "cut_chunk": riff(good[12:-30]),
        "no_frame": riff(head),
        "empty_frame": riff(head + anmf(0, 0, 13, 9, 0, b"")),
        "anmf_before_anim": riff(vp8x(20, 12, 0x02)
                                 + anmf(0, 0, 13, 9, 0, lossy) + anim()),
        "alph_then_vp8l": riff(vp8x(20, 12, 0x12) + anim()
                               + anmf(0, 0, 13, 9, 0, alph + lossless)),
        "bad_flags": riff(vp8x(20, 12, 0x03) + anim()
                          + anmf(0, 0, 13, 9, 0, lossy)),
        "loose_image": riff(head + anmf(0, 0, 13, 9, 0, lossy) + lossy),
        "leftover": riff(head + anmf(0, 0, 13, 9, 0, lossy) + b"\0" * 4),
        "short_anim": riff(vp8x(20, 12, 0x02) + chunk(b"ANIM", b"\0" * 4)
                           + anmf(0, 0, 13, 9, 0, lossy)),
        "bad_frame": riff(head + anmf(0, 0, 13, 9, 0, chunk(
            b"VP8 ", b"\x01" + lossy[9:]))),
    }
    for name, data in cases.items():
        path = tmp_path / f"{name}.webp"
        path.write_bytes(data)
        assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None, name
        with pytest.raises(ValueError, match=rf"{name}\.webp"):
            read_image(path, "cpu")
    same(tmp_path / "good.webp", good)
