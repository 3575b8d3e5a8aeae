"""Checkpoints of the port's train state (the counterpart of
nerfpp_tpu/utils/checkpoint.py, which writes orbax pytrees).

One ``torch.save`` file per checkpoint, ``base/step_<n>/state.pt``, holding
the flat state ``NeRFExecutor.state_dict`` returns (parameters, Adam
moments and count, step, occupancy grid) as CPU tensors. Orbax checkpoints
of the JAX package are not read here (that needs JAX): a JAX state reaches
the port through ``convert.state_from_jax``.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import torch

FILE = "state.pt"


def _step_dirs(base: Path):
    """Checkpoint dirs under base, oldest first by (mtime, step): the last
    one saved wins over a higher step left by an older run, and the step
    breaks ties within one mtime quantum."""
    if not base.exists():
        return []
    dirs = [(d.stat().st_mtime, int(d.name.split("_")[1]), d)
            for d in base.iterdir()
            if d.is_dir() and d.name.startswith("step_")
            and d.name.split("_")[1].isdigit() and (d / FILE).exists()]
    return [(step, d) for _, step, d in sorted(dirs)]


def save(base, state: Dict[str, torch.Tensor], step: int) -> Path:
    """Write ``state`` under base/step_<step>/state.pt."""
    path = Path(base).resolve() / f"step_{step}"
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / (FILE + ".tmp")
    torch.save({k: v.detach().cpu() for k, v in state.items()}, tmp)
    tmp.replace(path / FILE)
    return path


def restore_latest(base) -> Optional[Dict[str, torch.Tensor]]:
    """The most recently saved state under base, or None."""
    dirs = _step_dirs(Path(base).resolve())
    if not dirs:
        return None
    return torch.load(dirs[-1][1] / FILE, map_location="cpu",
                      weights_only=True)
