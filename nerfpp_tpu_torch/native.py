"""ctypes bridge to the native host library ``native/nerfpp_native.cpp``
(the port's own loader; the JAX package has its counterpart in
nerfpp_tpu/native.py).

The library is built on first use with g++ (``-O3 -march=native -fopenmp
-shared -fPIC -std=c++17``) into ``nerfpp_tpu_torch/_build/``, under a name
that carries a hash of the source, the flags and the host's CPU (a
``-march=native`` build need not run on another CPU), through a temporary
file renamed into place: processes building it at once, and the JAX
package's own build of the same source into ``native/``, never share a
file. When no compiler is at hand ``load`` returns None and every function
here returns None: the library is an optional host parser, and callers
keep their Python paths, as in the JAX package. ``build_library`` is that
build for any source: utils/jpeg.py builds its entropy coder with it and
raises where the build fails.

It covers host-side work the reference does in C++: COLMAP sparse-model
binary parsing, per-image near/far percentiles and the pyramid-embedding
pixel lookup.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "nerfpp_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
             "-std=c++17"]

_lib = None
_tried = False


def _cpu() -> bytes:
    """The host CPU's model and feature flags (Linux), else its machine
    name."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.machine().encode()
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))]
    return "\n".join(keep[:2]).encode()


def library_path(source: Path, flags, build_dir: Path = BUILD_DIR) -> Path:
    """Where the library of ``source``, ``flags`` and this CPU is built:
    ``build_dir/lib<stem>_<hash>.so``."""
    h = hashlib.sha256(Path(source).read_bytes())
    h.update(" ".join(flags).encode())
    h.update(_cpu())
    return build_dir / f"lib{Path(source).stem}_{h.hexdigest()[:12]}.so"


def lib_path() -> Path:
    """Where the library of this source, these flags and this CPU is
    built."""
    return library_path(SOURCE, CXX_FLAGS)


def build_library(source: Path, flags, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``source`` with g++ into ``library_path`` unless it is
    there, through a temporary file renamed into place. Raises RuntimeError
    naming g++ when it is missing or fails."""
    out = library_path(source, flags, build_dir)
    if out.exists():
        return out
    if shutil.which("g++") is None:
        raise RuntimeError(f"g++ not found: {source} is compiled with g++ at "
                           "first use")
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *flags, str(source), "-o", str(tmp)],
                       check=True, capture_output=True, text=True,
                       timeout=300)
    except subprocess.CalledProcessError as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {source}:\n{e.stderr}") from e
    except (subprocess.SubprocessError, OSError) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {source}: {e}") from e
    os.replace(tmp, out)
    return out


def load() -> Optional[ctypes.CDLL]:
    """The loaded library (built if needed), or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not SOURCE.exists():
        return None
    try:
        out = build_library(SOURCE, CXX_FLAGS)
    except RuntimeError:
        return None
    try:
        lib = ctypes.CDLL(str(out))
    except OSError:
        return None
    if lib.nerfpp_native_version() != 1:
        return None
    # non-default return types (ctypes defaults to a 32-bit int)
    lib.colmap_scan_points3d_bin.restype = ctypes.c_int64
    _lib = lib
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# ----------------------------------------------------------------- COLMAP

def read_cameras_bin(path) -> Optional[dict]:
    """cameras.bin -> {ids, model_ids, widths, heights, params [n, 12] zero
    padded, n_params}, or None."""
    lib = load()
    if lib is None:
        return None
    cap = 4096
    ids = np.zeros(cap, np.int32)
    model_ids = np.zeros(cap, np.int32)
    widths = np.zeros(cap, np.int64)
    heights = np.zeros(cap, np.int64)
    params = np.zeros((cap, 12), np.float64)
    n_params = np.zeros(cap, np.int32)
    n = lib.colmap_read_cameras_bin(
        str(path).encode(), cap, _ptr(ids, ctypes.c_int32),
        _ptr(model_ids, ctypes.c_int32), _ptr(widths, ctypes.c_int64),
        _ptr(heights, ctypes.c_int64), _ptr(params, ctypes.c_double),
        _ptr(n_params, ctypes.c_int32))
    if n < 0:
        return None
    return {"ids": ids[:n], "model_ids": model_ids[:n], "widths": widths[:n],
            "heights": heights[:n], "params": params[:n],
            "n_params": n_params[:n]}


def read_images_bin(path) -> Optional[dict]:
    """images.bin -> {image_ids, qvecs, tvecs, camera_ids, names,
    pt_offsets [n + 1], xys [total, 2], point3d_ids [total]}, or None."""
    lib = load()
    if lib is None:
        return None
    n = ctypes.c_int64()
    total = ctypes.c_int64()
    if lib.colmap_scan_images_bin(str(path).encode(), ctypes.byref(n),
                                  ctypes.byref(total)) != 0:
        return None
    n, total = n.value, total.value
    image_ids = np.zeros(n, np.int32)
    qvecs = np.zeros((n, 4), np.float64)
    tvecs = np.zeros((n, 3), np.float64)
    camera_ids = np.zeros(n, np.int32)
    names_cap = 65536 + n * 256
    names = np.zeros(names_cap, np.uint8)
    pt_offsets = np.zeros(n + 1, np.int64)
    xys = np.zeros((total, 2), np.float64)
    p3d = np.zeros(total, np.int64)
    rc = lib.colmap_read_images_bin(
        str(path).encode(), n, total, _ptr(image_ids, ctypes.c_int32),
        _ptr(qvecs, ctypes.c_double), _ptr(tvecs, ctypes.c_double),
        _ptr(camera_ids, ctypes.c_int32), _ptr(names, ctypes.c_char),
        names_cap, _ptr(pt_offsets, ctypes.c_int64),
        _ptr(xys, ctypes.c_double), _ptr(p3d, ctypes.c_int64))
    if rc != 0:
        return None
    name_list = names.tobytes().split(b"\x00")[:n]
    return {"image_ids": image_ids, "qvecs": qvecs, "tvecs": tvecs,
            "camera_ids": camera_ids,
            "names": [s.decode("utf-8") for s in name_list],
            "pt_offsets": pt_offsets, "xys": xys, "point3d_ids": p3d}


def read_points3d_bin(path) -> Optional[dict]:
    """points3D.bin -> {ids, xyz, rgb, errors}, or None."""
    lib = load()
    if lib is None:
        return None
    n = lib.colmap_scan_points3d_bin(str(path).encode())
    if n < 0:
        return None
    ids = np.zeros(n, np.int64)
    xyz = np.zeros((n, 3), np.float64)
    rgb = np.zeros((n, 3), np.uint8)
    errors = np.zeros(n, np.float64)
    rc = lib.colmap_read_points3d_bin(
        str(path).encode(), n, _ptr(ids, ctypes.c_int64),
        _ptr(xyz, ctypes.c_double), _ptr(rgb, ctypes.c_uint8),
        _ptr(errors, ctypes.c_double))
    if rc != 0:
        return None
    return {"ids": ids, "xyz": xyz, "rgb": rgb, "errors": errors}


def compute_near_far(qvec: np.ndarray, tvec: np.ndarray, pts3d: np.ndarray,
                     near_percentile: float = 0.01,
                     far_percentile: float = 0.99):
    """(near, far) percentiles of the distances from the camera centre to
    pts3d [m, 3], or None."""
    lib = load()
    if lib is None:
        return None
    qvec = np.ascontiguousarray(qvec, np.float64)
    tvec = np.ascontiguousarray(tvec, np.float64)
    pts3d = np.ascontiguousarray(pts3d, np.float64)
    near = ctypes.c_float()
    far = ctypes.c_float()
    lib.compute_near_far(_ptr(qvec, ctypes.c_double),
                         _ptr(tvec, ctypes.c_double),
                         _ptr(pts3d, ctypes.c_double),
                         ctypes.c_int64(pts3d.shape[0]),
                         ctypes.c_float(near_percentile),
                         ctypes.c_float(far_percentile),
                         ctypes.byref(near), ctypes.byref(far))
    return float(near.value), float(far.value)


# ---------------------------------------------------------------- pyramid

def pyramid_lookup(grids_by_zoom: dict, min_zoom: int, max_zoom: int,
                   embed_dim: int, img_size: float, overlap: float,
                   xs: np.ndarray, ys: np.ndarray, scale: float):
    """grids_by_zoom: {zoom: [nh, nw, E] float32}. Returns [n, E] or None."""
    lib = load()
    if lib is None:
        return None
    zooms = list(range(min_zoom, max_zoom + 1))
    flat = []
    offsets = np.zeros(len(zooms), np.int64)
    nh = np.zeros(len(zooms), np.int32)
    nw = np.zeros(len(zooms), np.int32)
    pos = 0
    for i, z in enumerate(zooms):
        g = np.ascontiguousarray(grids_by_zoom[z], np.float32)
        offsets[i] = pos
        nh[i], nw[i] = g.shape[0], g.shape[1]
        flat.append(g.reshape(-1))
        pos += g.size
    grids = np.concatenate(flat)
    xs = np.ascontiguousarray(xs, np.float32)
    ys = np.ascontiguousarray(ys, np.float32)
    out = np.zeros((len(xs), embed_dim), np.float32)
    rc = lib.pyramid_lookup(
        _ptr(grids, ctypes.c_float), _ptr(offsets, ctypes.c_int64),
        _ptr(nh, ctypes.c_int32), _ptr(nw, ctypes.c_int32),
        ctypes.c_int(min_zoom), ctypes.c_int(max_zoom),
        ctypes.c_int(embed_dim), ctypes.c_float(img_size),
        ctypes.c_float(overlap), _ptr(xs, ctypes.c_float),
        _ptr(ys, ctypes.c_float), ctypes.c_int64(len(xs)),
        ctypes.c_float(scale), _ptr(out, ctypes.c_float))
    return out if rc == 0 else None
