"""Port parity: the PNG reader (utils/png.py) on files with every row
filter, bitwise against cv2.imread (OpenCV is imported here only, as the
reference): 1- and 3-channel images (4-channel ones:
tests/test_torch_io_load.py).
"""
import pytest

from tests.torch_io_common import ROW_FILTERS, reader_undoes_every_row_filter


@pytest.mark.parametrize("kind", ROW_FILTERS)
@pytest.mark.parametrize("channels", [1, 3])
def test_reader_undoes_every_row_filter(tmp_path, kind, channels):
    reader_undoes_every_row_filter(tmp_path, kind, channels)
