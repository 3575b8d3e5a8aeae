"""Debug views of the LeRF pipeline (port of nerfpp_tpu/render/debug.py).

The relevancy heatmap of a training image read straight from the CLIP
pyramid, without the radiance field: a check of the prompts and the pyramid
embeddings before (or without) training. The lookup is the pyramid's dense
per-pixel map; the output is a JET PNG, optionally blended 50 / 50 over the
source image.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from nerfpp_tpu_torch.render.lerf import relevancy
from nerfpp_tpu_torch.utils.colormap import add_weighted, apply_jet
from nerfpp_tpu_torch.utils.png import write_png


def pyramid_relevancy_image(pyramid, img_idx: int, positives, negatives,
                            scale: float = 0.5) -> np.ndarray:
    """[H, W] relevancy of every pixel's pyramid embedding against the first
    positive prompt (on the CPU)."""
    dense = pyramid.dense_pixel_embeddings(img_idx, scale)       # [H, W, E]
    rel = relevancy(torch.as_tensor(dense),
                    torch.as_tensor(np.asarray(positives, np.float32)),
                    torch.as_tensor(np.asarray(negatives, np.float32)))
    return rel[..., 0].numpy()


def save_relevancy_heatmap(pyramid, img_idx: int, positives, negatives,
                           out_path, image: np.ndarray | None = None,
                           scale: float = 0.5) -> np.ndarray:
    """Write the JET heatmap of ``pyramid_relevancy_image`` (blended over
    ``image``, [H, W, 3] in [0, 1], when given) to ``out_path`` as a PNG;
    returns the relevancy."""
    rel = pyramid_relevancy_image(pyramid, img_idx, positives, negatives,
                                  scale)
    heat = apply_jet((np.clip(rel, 0, 1) * 255).astype(np.uint8))
    if image is not None:
        base = (np.clip(image, 0, 1) * 255).astype(np.uint8)
        heat = add_weighted(base, 0.5, heat, 0.5, 0.0)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    write_png(out_path, heat)
    return rel
