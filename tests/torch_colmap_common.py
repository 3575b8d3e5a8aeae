"""Helpers shared by tests/test_torch_colmap.py and
tests/test_torch_colmap_resample.py (a module, not a test file): the
workspaces, a copy of one, and the comparison of two reconstructions.
"""
import shutil
from pathlib import Path

import numpy as np
import pytest

from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
from scripts.colmap_export import export_colmap_scene
from tests.test_colmap import _synthetic_model


ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """A tiny exported capture: 8 train views, every 4th by the second
    camera at 30x30."""
    scene = make_synthetic_scene(n_train=8, n_val=1, n_test=1, image_hw=24,
                                 n_samples=8, white_bkgr=False, device="cpu")
    ws = tmp_path_factory.mktemp("capture")
    return export_colmap_scene(scene, ws, "cpu", n_samples=32,
                               n_points=1500)


@pytest.fixture(scope="module")
def synthetic_model(tmp_path_factory):
    d = tmp_path_factory.mktemp("model")
    _synthetic_model(d)
    return d


def _copy(ws: Path, dst: Path) -> Path:
    shutil.copytree(ws, dst)
    return dst


def _same_reconstruction(a, b):
    """Field by field, exactly."""
    assert sorted(a.cameras) == sorted(b.cameras)
    for cid in a.cameras:
        x, y = a.cameras[cid], b.cameras[cid]
        assert (x.model, x.width, x.height) == (y.model, y.width, y.height)
        np.testing.assert_array_equal(x.params, y.params)
    assert sorted(a.images) == sorted(b.images)
    for iid in a.images:
        x, y = a.images[iid], b.images[iid]
        assert (x.image_id, x.camera_id, x.name) == (y.image_id, y.camera_id,
                                                     y.name)
        for f in ("qvec", "tvec", "xys", "point3d_ids"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f), f)
    np.testing.assert_array_equal(a.points_xyz, b.points_xyz)
    np.testing.assert_array_equal(a.points_ids, b.points_ids)


# ---------------------------------------------------------- image module

RESIZES = [((37, 53), (23, 41)), ((23, 41), (37, 53)), ((17, 19), (31, 29)),
           ((45, 33), (20, 70)), ((30, 30), (24, 24)), ((24, 24), (30, 30)),
           ((40, 26), (20, 13)), ((5, 3), (1, 1))]
