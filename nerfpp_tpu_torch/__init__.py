"""nerfpp_tpu_torch — the PyTorch/CUDA port of nerfpp_tpu for NVIDIA Hopper.

A package of its own beside the JAX one: it imports ``torch`` and numpy,
never ``jax`` and nothing of ``nerfpp_tpu``. Module names mirror the JAX
package's (``core/``, ``encoders/``, ``models/``, ``render/``,
``executor.py``) so each counterpart is easy to find; every Pallas kernel on
the ported path is a hand-written CUDA kernel under ``csrc/``, bound in
``kernels/``.

Entry points take a ``device`` argument that defaults to ``"cuda"`` and raise
when CUDA is absent unless the caller asks for ``device="cpu"``, where the
kernels' plain PyTorch versions run.
"""
import torch


def resolve_device(device="cuda") -> torch.device:
    """The port's device rule: CUDA unless the caller asks for the CPU, and a
    clear error (never a quiet CPU run) when CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nerfpp_tpu_torch: CUDA is not available; pass device='cpu' to "
            "run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
