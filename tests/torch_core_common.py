"""Helpers shared by tests/test_torch_core.py and
tests/test_torch_core_sampling.py (a module, not a test file).
"""
import numpy as np
import torch


BBOX = np.array([-1.2, -1.2, -1.2, 1.2, 1.2, 1.2], np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def _rays(n, seed=0):
    rng = np.random.RandomState(seed)
    o = np.tile([[0.1, -0.2, 3.0]], (n, 1)).astype(np.float32)
    d = (np.array([[0.0, 0.0, -1.0]]) + rng.uniform(-0.3, 0.3, (n, 3))
         ).astype(np.float32)
    return o, d


def _sphere_grid(g=16, r=4.0, density=10.0):
    ii = np.indices((g, g, g)).transpose(1, 2, 3, 0)
    d = np.zeros((g, g, g), np.float32)
    d[((ii - (g - 1) / 2) ** 2).sum(-1) < r * r] = density
    return d
