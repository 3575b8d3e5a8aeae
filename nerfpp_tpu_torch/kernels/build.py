"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/*.cu`` source compiles on its own, with a plain C interface, into
``nerfpp_tpu_torch/_build/lib<name>_<hash>.so``; the hash covers the source and
the shared headers, so an edited source never loads a stale library. All
sources compile in parallel (one nvcc process each) at first use, and
``build_all`` can be called up front to pay that cost before timing anything.
Nothing here runs when the package is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("window_lists", "encode_blocked", "grad_blocked", "encode_small",
           "encode_large", "grad_large")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from nerfpp_tpu_torch/csrc at first use")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES, verbose: bool = False) -> dict:
    """Compile every missing library in parallel. Returns {name: ptxas
    report} when ``verbose`` (register and shared-memory use per kernel),
    else {name: ""}. Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists() and not verbose:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
