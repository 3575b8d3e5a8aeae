"""Carry a JAX-package state across to the port.

The caller hands in numpy arrays (this module never imports JAX): the JAX
state's ``params`` pytree as numpy,

    {"embed": {"table": [L * 2^T, 2]},
     "model": {"sigma_net": [{"w": [in, out]}, ...],
               "color_net": [{"w": [in, out]}, ...]}}

and optionally the occupancy grid's [G, G, G] density array, the optax Adam
state (the ``opt_state`` of ``optax.adam``, as numpy: the element with
``mu``, ``nu`` and ``count``) and the step. JAX dense weights are
[in, out]; they, and their moments, are transposed into nn.Linear's
[out, in]. The result, loaded with ``NeRFExecutor.load_state``, takes the
same next step as the JAX state. Every hash scheme keeps its table under
``embed.table`` with the same shape; what the schemes derive from the seed
(block offsets, random primes) is drawn anew, identically, by the port's
encoder and is not carried.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from nerfpp_tpu_torch import resolve_device


def _port_names(tree: dict, dev) -> Dict[str, torch.Tensor]:
    """A params-shaped pytree -> {port parameter name: tensor}."""
    def t(x):
        return torch.as_tensor(np.array(x, np.float32), device=dev)

    out = {"embed.table": t(tree["embed"]["table"])}
    for net in ("sigma_net", "color_net"):
        for i, layer in enumerate(tree["model"][net]):
            if "b" in layer:
                raise ValueError(f"{net}[{i}] has a bias; NeRFSmall is "
                                 "bias-free")
            out[f"model.{net}.layers.{i}.weight"] = t(
                np.asarray(layer["w"]).T).contiguous()
    if "normals_net" in tree["model"]:
        raise NotImplementedError("the normals head is not ported yet")
    return out


def _adam_of(opt_state: Any):
    parts = opt_state if isinstance(opt_state, (tuple, list)) else [opt_state]
    for s in parts:
        if all(hasattr(s, a) for a in ("mu", "nu", "count")):
            return s
    raise ValueError("opt_state holds no Adam state (mu, nu, count)")


def state_from_jax(params: dict, occupancy: Optional[np.ndarray] = None,
                   opt_state: Any = None, step: Optional[int] = None,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """-> a state for ``NeRFExecutor.load_state``: ``embed.table``,
    ``model.<net>.layers.<i>.weight``, and as given ``occupancy``,
    ``adam.mu.<name>``, ``adam.nu.<name>``, ``adam.count`` and ``step``."""
    dev = resolve_device(device)
    state = _port_names(params, dev)
    if occupancy is not None:
        state["occupancy"] = torch.as_tensor(np.array(occupancy, np.float32),
                                             device=dev)
    if opt_state is not None:
        adam = _adam_of(opt_state)
        for moment in ("mu", "nu"):
            for k, v in _port_names(getattr(adam, moment), dev).items():
                state[f"adam.{moment}.{k}"] = v
        state["adam.count"] = torch.tensor(int(np.asarray(adam.count)),
                                           dtype=torch.int32, device=dev)
    if step is not None:
        state["step"] = torch.tensor(int(step), dtype=torch.int64)
    return state
