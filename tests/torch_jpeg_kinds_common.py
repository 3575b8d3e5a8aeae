"""Helpers shared by the tests of the JPEG kinds (a module, not a test
file): cv2's reads of files written to disk (cv2.imread reads a file cut
short as libjpeg's stdio source does, ending it with an EOI), cv2-written
Huffman files at every sampling OpenCV writes, and the committed fixtures
under tests/data/jpeg_kinds (``make_fixtures``; run ``PYTHONPATH=. python
tests/torch_jpeg_kinds_common.py`` to write them again): arithmetic-coded
sequential and progressive, Pillow's progressive CMYK, YCCK and lossless
files, each beside cv2.imread's pixels (RGB order) as .npy.

The writers of the kinds are scripts/jpeg_kinds.py's, which chip_smoke.py
shares; Pillow writes CMYK here too.
"""
import io
from pathlib import Path

import cv2
import numpy as np
import torch

from nerfpp_tpu_torch.utils import jpeg as J
from scripts import jpeg_kinds as K
from tests.torch_image_common import pattern

FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg_kinds"
SAMPLING = {"gray": None,
            "4:4:4": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "4:2:2": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "4:2:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "4:4:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "4:1:1": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
SIZES = [(1, 1), (13, 11), (37, 45)]
# non-default DAC conditioning of both tables
DAC = {("dc", 0): (2, 5), ("ac", 0): 2, ("dc", 1): (0, 0), ("ac", 1): 20}


def rgb(img):
    return img[..., ::-1] if img is not None and img.ndim == 3 else img


def cv2_read(data: bytes, tmp_path, name="view.jpg"):
    """cv2.imread(IMREAD_UNCHANGED) of ``data`` written to a file, RGB
    order (None where cv2 returns None)."""
    path = Path(tmp_path) / name
    path.write_bytes(data)
    return rgb(cv2.imread(str(path), cv2.IMREAD_UNCHANGED))


def port_read(data: bytes, name="view.jpg"):
    return J.frame_pixels(J.decode_coefficients(data, name), "cpu").numpy()


def huffman_file(sampling: str, h: int, w: int, seed=0, quality=90,
                 restart=0):
    """cv2.imencode's baseline file of a pattern at ``sampling`` (a key of
    SAMPLING) and cv2's decode of it (RGB)."""
    img = pattern(h, w, 1 if sampling == "gray" else 3, seed)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if SAMPLING[sampling] is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(rgb(img)), params)
    assert ok
    return buf.tobytes(), rgb(cv2.imdecode(buf, cv2.IMREAD_UNCHANGED))


def pillow_cmyk(img4, progressive=False, **kw) -> bytes:
    """Pillow's JPEG of a uint8 [H, W, 4] CMYK image (Adobe APP14, the
    values stored inverted)."""
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img4, "CMYK").save(buf, "JPEG", progressive=progressive,
                                       **kw)
    return buf.getvalue()


def fixture_files():
    """{name: bytes} of the committed fixtures."""
    arith_src, _ = huffman_file("4:2:0", 21, 19, seed=1)
    prog_src, _ = huffman_file("4:2:2", 13, 11, seed=2)
    img = pattern(21, 19, 3, 3)
    cmyk = K.cmyk_planes(torch.from_numpy(img))
    ycck = K.ycck_planes(cmyk)
    gray6 = pattern(21, 19, 1, 4) >> 2
    rgb11 = pattern(13, 11, 3, 5)
    return {
        "arith_420_rst_dac_21x19.jpg": K.arith_bytes(
            K.plan_of(arith_src), restart=1,
            dac={("dc", 0): (1, 4), ("ac", 0): 8, ("dc", 1): (0, 3),
                 ("ac", 1): 12}),
        "arith_prog_422_13x11.jpg": K.arith_bytes(K.plan_of(prog_src),
                                                  progressive=True),
        "cmyk_pillow_prog_13x11.jpg": pillow_cmyk(pattern(13, 11, 4, 6),
                                                  progressive=True),
        "ycck_21x19.jpg": K.huffman_bytes(
            K.planes_plan(ycck, [(2, 2), (1, 1), (1, 1), (2, 2)]),
            app=K.adobe(2)),
        "lossless_gray6_pt1_rst_21x19.jpg": K.lossless_bytes(
            [gray6], precision=6, psv=5, pt=1, restart=38),
        "lossless_rgb_psv7_13x11.jpg": K.lossless_bytes(
            [rgb11[..., c] for c in range(3)], psv=7, app=K.adobe(0))}


def make_fixtures(out=FIXTURES):
    """Write each fixture and cv2.imread's pixels of it (<stem>.npy)."""
    out.mkdir(parents=True, exist_ok=True)
    for name, data in fixture_files().items():
        (out / name).write_bytes(data)
        pixels = rgb(cv2.imread(str(out / name), cv2.IMREAD_UNCHANGED))
        np.save(out / f"{Path(name).stem}.npy", pixels)


if __name__ == "__main__":
    make_fixtures()
