"""Carry a JAX-package state across to the port.

The caller hands in numpy arrays (this module never imports JAX): the JAX
state's ``params`` pytree as numpy,

    {"embed": {"table": [L * 2^T, 2]},
     "model": {"sigma_net": [{"w": [in, out]}, ...],
               "color_net": [{"w": [in, out]}, ...]}}

and optionally the occupancy grid's [G, G, G] density array. JAX dense
weights are [in, out]; they are transposed into nn.Linear's [out, in].
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from nerfpp_tpu_torch import resolve_device


def state_from_jax(params: dict, occupancy: Optional[np.ndarray] = None,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """-> a state for ``NeRFExecutor.load_state``: ``embed.table``,
    ``model.<net>.layers.<i>.weight`` and, if given, ``occupancy``."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.array(x, np.float32), device=dev)

    state = {"embed.table": t(params["embed"]["table"])}
    for net in ("sigma_net", "color_net"):
        for i, layer in enumerate(params["model"][net]):
            if "b" in layer:
                raise ValueError(f"{net}[{i}] has a bias; NeRFSmall is "
                                 "bias-free")
            state[f"model.{net}.layers.{i}.weight"] = t(
                np.asarray(layer["w"]).T).contiguous()
    if "normals_net" in params["model"]:
        raise NotImplementedError("the normals head is not ported yet")
    if occupancy is not None:
        state["occupancy"] = t(occupancy)
    return state
