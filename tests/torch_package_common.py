"""Helpers shared by tests/test_torch_package.py and
tests/test_torch_package_build.py (a module, not a test file).
"""
from pathlib import Path


ROOT = Path(__file__).resolve().parent.parent


PORT = ROOT / "nerfpp_tpu_torch"


BBOX = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]


def _banned(module: str) -> bool:
    # the port reads and writes images itself (utils/png.py): no OpenCV or
    # Pillow, which the machine with the card does not have
    return (module in ("jax", "jaxlib", "nerfpp_tpu", "cv2", "PIL")
            or module.startswith(("jax.", "jaxlib.", "nerfpp_tpu.", "cv2.",
                                  "PIL.")))
