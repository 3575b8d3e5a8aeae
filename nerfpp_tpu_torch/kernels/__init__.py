"""Hand-written CUDA kernels of the port and their wrappers.

Sources live in ``nerfpp_tpu_torch/csrc``; ``build.py`` compiles them with
nvcc at first use. Importing this package builds nothing.
"""
from nerfpp_tpu_torch.kernels.hash_encode import encode_small, grad_small
from nerfpp_tpu_torch.kernels.hash_encode_large import (encode_large,
                                                        grad_large,
                                                        grad_large_bins)
from nerfpp_tpu_torch.kernels.hash_encode_blocked import (encode_blocked,
                                                          grad_blocked,
                                                          grad_blocked_index,
                                                          window_lists)

WRAPPERS = {"window_lists": window_lists, "encode_blocked": encode_blocked,
            "grad_blocked_index": grad_blocked_index,
            "grad_blocked": grad_blocked, "encode_small": encode_small,
            "grad_small": grad_small, "encode_large": encode_large,
            "grad_large_bins": grad_large_bins, "grad_large": grad_large}


def launch_counts() -> dict:
    """{wrapper name: kernel launches since the last reset}."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
