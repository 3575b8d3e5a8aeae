"""Carry a JAX-package state across to the port.

The caller hands in numpy arrays (this module never imports JAX): the JAX
state's ``params`` pytree as numpy, for NeRFSmall

    {"embed": {"table": [L * 2^T, 2]},
     "model": {"sigma_net": [{"w": [in, out]}, ...],
               "color_net": [{"w": [in, out]}, ...],
               "normals_net": [{"w": [in, out]}, ...]}}   (the normals head)

and for the classic NeRFMLP (the frequency encoder has no parameters)

    {"embed": {},
     "model": {"pts_linears": [{"w": [in, out], "b": [out]}, ...],
               "views_linears": [...], "feature_linear": {"w", "b"},
               "alpha_linear": ..., "rgb_linear": ...}}   (or "output_linear")

with, for LeRF, the language table and field beside them (or alone, for a
LeRF-only stack)

    {"lang_embed": {"table": [L_le * 2^T_le, 2]},
     "lang_model": {"sigma_le_net": [{"w": [in, out]}, ...],
                    "le_net": [{"w": [in, out]}, ...]}}

and optionally the occupancy grid's [G, G, G] density array, the optax Adam
state (the ``opt_state`` of ``optax.adam``, as numpy: the element with
``mu``, ``nu`` and ``count``) and the step. JAX dense weights are
[in, out]; they, and their moments, are transposed into nn.Linear's
[out, in]; biases keep their shape. The result, loaded with
``NeRFExecutor.load_state``, takes the same next step as the JAX state.
Every hash scheme keeps its table under ``embed.table`` with the same
shape; what the schemes derive from the seed (block offsets, random primes)
is drawn anew, identically, by the port's encoder and is not carried.
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

    out = {}
    for head in ("embed", "lang_embed"):
        if "table" in tree.get(head, {}):
            out[f"{head}.table"] = t(tree[head]["table"])
    for net, layers in tree.get("lang_model", {}).items():
        for i, layer in enumerate(layers):
            if "b" in layer:
                raise ValueError(f"lang_model.{net}[{i}] has a bias; the "
                                 "LeRF field is bias-free")
            out[f"lang_model.{net}.layers.{i}.weight"] = t(
                np.asarray(layer["w"]).T).contiguous()
    for net, layers in tree.get("model", {}).items():
        small = net in ("sigma_net", "color_net", "normals_net")  # NeRFSmall
        listed = isinstance(layers, (list, tuple))
        for i, layer in enumerate(layers if listed else [layers]):
            if small and "b" in layer:
                raise ValueError(f"{net}[{i}] has a bias; NeRFSmall is "
                                 "bias-free")
            name = (f"model.{net}.layers.{i}" if small
                    else f"model.{net}.{i}" if listed else f"model.{net}")
            out[f"{name}.weight"] = t(np.asarray(layer["w"]).T).contiguous()
            if "b" in layer:
                out[f"{name}.bias"] = t(layer["b"])
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
    """-> a state for ``NeRFExecutor.load_state``: ``embed.table`` (hash
    encoders), ``model.<net>.layers.<i>.weight`` (NeRFSmall) or
    ``model.<layer>[.<i>].{weight,bias}`` (NeRFMLP), for LeRF
    ``lang_embed.table`` and ``lang_model.<net>.layers.<i>.weight``, and as
    given ``occupancy``,
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
