"""Multi-scale CLIP feature pyramid for LeRF supervision (port of
nerfpp_tpu/data/pyramid_clip.py).

Every training image is covered by overlapping square windows at zoom levels
min_zoom_out..max_zoom_out (window side img_size * 2^zoom, stride side *
(1 - overlap)); each window is resized to the encoder's input size, encoded
and L2-normalised, and the grids are kept as dense [nh, nw, E] arrays. A
pixel's supervision embedding is trilinear: bilinear over the nearest patch
centres at the two zoom levels bracketing log2(scale), then linear across
them. The .npz cache has the JAX package's keys and layout, so either
package reads the other's file.

The JAX package resizes with OpenCV (``cv2.resize``, INTER_LINEAR, float32);
the port with ``resize_linear`` of utils/image.py, that resize in PyTorch
on any device (tests/test_torch_lerf_resize.py holds it within 1e-6 of
OpenCV's on [0, 1] images). The embedder cuts, resizes and encodes all
windows of one shape at once, on the images' device.

The image encoder is pluggable: a callable mapping a [N, S, S, 3] float
batch (a tensor, or a numpy array) to [N, E] embeddings.
``RandomProjectionPatchEncoder`` is the JAX package's deterministic stand-in
(the same projection, drawn from the same numpy seed);
``load_clip_encoder`` wraps a local HuggingFace CLIP checkpoint.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from nerfpp_tpu_torch import resolve_device
from nerfpp_tpu_torch.utils.image import resize_linear


@dataclasses.dataclass
class PyramidEmbedderProperties:
    """Window geometry of the pyramid."""
    img_size: int = 224          # CLIP input size
    overlap: float = 0.75        # window overlap fraction
    max_zoom_out: int = 1        # largest zoom level
    min_zoom_out: int = -1       # smallest (zoom -1 = half-size windows)

    def zooms_for(self, h: int, w: int) -> List[int]:
        n = int(min(np.log2(w / self.img_size), np.log2(h / self.img_size)))
        top = min(n, self.max_zoom_out)
        return list(range(self.min_zoom_out, top + 1))

    def grid(self, h: int, w: int, zoom: int) -> Tuple[int, int, float, float]:
        """(nh, nw, window, stride) of one zoom level."""
        win = self.img_size * (2.0 ** zoom)
        stride = win * (1.0 - self.overlap)
        nw = int((w - win * self.overlap) / stride)
        nh = int((h - win * self.overlap) / stride)
        return max(nh, 1), max(nw, 1), win, stride


class PyramidEmbedding:
    """Dense pyramid store: {(img_idx, zoom): [nh, nw, E] float32 numpy}."""

    def __init__(self, props: PyramidEmbedderProperties,
                 image_sizes: List[Tuple[int, int]]):
        self.props = props
        self.image_sizes = list(image_sizes)
        self.grids: Dict[Tuple[int, int], np.ndarray] = {}

    def _level_lookup(self, img_idx: int, zoom: int, xs: np.ndarray,
                      ys: np.ndarray) -> np.ndarray:
        """Bilinear interpolation over the patch centres of one level."""
        h, w = self.image_sizes[img_idx]
        nh, nw, win, stride = self.props.grid(h, w, zoom)
        g = self.grids[(img_idx, zoom)]
        # the centre of grid index i is at i * stride + win / 2
        fx = (xs - win / 2.0) / stride
        fy = (ys - win / 2.0) / stride
        x0 = np.clip(np.floor(fx).astype(np.int64), 0, nw - 1)
        x1 = np.clip(x0 + 1, 0, nw - 1)
        y0 = np.clip(np.floor(fy).astype(np.int64), 0, nh - 1)
        y1 = np.clip(y0 + 1, 0, nh - 1)
        tx = np.clip(fx - x0, 0.0, 1.0)[..., None]
        ty = np.clip(fy - y0, 0.0, 1.0)[..., None]
        top = g[y0, x0] * (1 - tx) + g[y0, x1] * tx
        bot = g[y1, x0] * (1 - tx) + g[y1, x1] * tx
        return top * (1 - ty) + bot * ty

    def get_pixel_values(self, img_idx: int, xs: np.ndarray, ys: np.ndarray,
                         scale: float) -> np.ndarray:
        """Trilinear (x, y, zoom) supervision embeddings of pixel coords:
        the two levels bracketing log2(scale), bilinear in each, linear
        across, normalised."""
        h, w = self.image_sizes[img_idx]
        zooms = self.props.zooms_for(h, w)
        zlo, zhi = zooms[0], zooms[-1]
        logs = np.log2(max(scale, 2.0 ** zlo))
        z1 = int(np.clip(np.floor(logs), zlo, zhi))
        z2 = int(np.clip(z1 + 1, zlo, zhi))
        out = self._level_lookup(img_idx, z1, xs, ys)
        if z2 != z1:
            e2 = self._level_lookup(img_idx, z2, xs, ys)
            t = np.clip(logs - z1, 0.0, 1.0)
            out = out * (1 - t) + e2 * t
        norm = np.linalg.norm(out, axis=-1, keepdims=True)
        return out / np.maximum(norm, 1e-8)

    def dense_pixel_embeddings(self, img_idx: int, scale: float = 0.5
                               ) -> np.ndarray:
        """[H, W, E] supervision map of a whole image (scale 0.5 is the
        training-time lookup)."""
        h, w = self.image_sizes[img_idx]
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        return self.get_pixel_values(img_idx, xs, ys, scale).astype(np.float32)

    def save(self, path) -> None:
        arrays = {f"{i}_{z}": g for (i, z), g in self.grids.items()}
        np.savez_compressed(
            path, __sizes__=np.asarray(self.image_sizes),
            __props__=np.asarray([self.props.img_size, self.props.overlap,
                                  self.props.max_zoom_out,
                                  self.props.min_zoom_out], np.float64),
            **arrays)

    @classmethod
    def load(cls, path) -> "PyramidEmbedding":
        data = np.load(path)
        pr = data["__props__"]
        props = PyramidEmbedderProperties(
            img_size=int(pr[0]), overlap=float(pr[1]),
            max_zoom_out=int(pr[2]), min_zoom_out=int(pr[3]))
        emb = cls(props, [tuple(s) for s in data["__sizes__"]])
        for k in data.files:
            if not k.startswith("__"):
                i, z = k.split("_")
                emb.grids[(int(i), int(z))] = data[k]
        return emb


class PyramidEmbedder:
    """Computes a PyramidEmbedding from images and an image encoder."""

    def __init__(self, encoder: Callable, props: PyramidEmbedderProperties,
                 batch_size: int = 64, device="cuda"):
        self.encoder = encoder
        self.props = props
        self.batch_size = batch_size
        self.device = resolve_device(device)

    def _encode(self, patches: torch.Tensor) -> torch.Tensor:
        """Encoder outputs in their own float width (the stand-in's are
        f64), normalised and stored as f32 by the caller, as in JAX."""
        feats = [torch.as_tensor(np.asarray(f) if not torch.is_tensor(f)
                                 else f).to(patches.device)
                 for f in (self.encoder(patches[i:i + self.batch_size])
                           for i in range(0, patches.shape[0],
                                          self.batch_size))]
        return torch.cat(feats)

    @torch.no_grad()
    def __call__(self, images) -> PyramidEmbedding:
        """images: [n, H, W, 3] float in [0, 1] (array or tensor)."""
        imgs = torch.as_tensor(np.asarray(images, np.float32)
                               if not torch.is_tensor(images) else images,
                               dtype=torch.float32).to(self.device)
        n, h, w, _ = imgs.shape
        emb = PyramidEmbedding(self.props, [(h, w)] * n)
        s = self.props.img_size
        for img_idx in range(n):
            img = imgs[img_idx]
            for zoom in self.props.zooms_for(h, w):
                nh, nw, win, stride = self.props.grid(h, w, zoom)
                # window corners in grid order; windows are cut at the image
                # edge, so they come in a few shapes, each cut at once
                boxes = []
                for iy in range(nh):
                    for ix in range(nw):
                        x0, y0 = int(ix * stride), int(iy * stride)
                        boxes.append((y0, min(int(y0 + win), h),
                                      x0, min(int(x0 + win), w)))
                feats = [None] * len(boxes)
                shapes = {}
                for k, (y0, y1, x0, x1) in enumerate(boxes):
                    shapes.setdefault((y1 - y0, x1 - x0), []).append(k)
                for (ph, pw), ks in shapes.items():
                    ys = torch.tensor([boxes[k][0] for k in ks],
                                      device=img.device)
                    xs = torch.tensor([boxes[k][2] for k in ks],
                                      device=img.device)
                    ry = ys[:, None] + torch.arange(ph, device=img.device)
                    rx = xs[:, None] + torch.arange(pw, device=img.device)
                    patches = img[ry[:, :, None], rx[:, None, :]]
                    if (ph, pw) != (s, s):
                        patches = resize_linear(patches, (s, s))
                    f = self._encode(patches)
                    for j, k in enumerate(ks):
                        feats[k] = f[j]
                f = torch.stack(feats)
                f = f / torch.clamp(torch.linalg.norm(f, dim=-1, keepdim=True),
                                    min=1e-8)
                emb.grids[(img_idx, zoom)] = (f.reshape(nh, nw, -1)
                                              .float().cpu().numpy())
        return emb


def make_device_pyramid(emb: PyramidEmbedding, scale: float = 0.5,
                        device="cuda"):
    """The DevicePyramid of a fixed lookup scale (0.5 in training): the one
    or two zoom levels bracketing log2(scale), their grids on the device
    and their static blend factor."""
    from nerfpp_tpu_torch.data.dataset import DevicePyramid
    dev = resolve_device(device)
    sizes = set(emb.image_sizes)
    if len(sizes) != 1:
        raise ValueError("device pyramid requires uniform image sizes; "
                         f"got {sizes}")
    h, w = emb.image_sizes[0]
    n_imgs = len(emb.image_sizes)
    zooms = emb.props.zooms_for(h, w)
    zlo, zhi = zooms[0], zooms[-1]
    logs = float(np.log2(max(scale, 2.0 ** zlo)))
    z1 = int(np.clip(np.floor(logs), zlo, zhi))
    z2 = int(np.clip(z1 + 1, zlo, zhi))
    t = float(np.clip(logs - z1, 0.0, 1.0)) if z2 != z1 else 0.0
    grids, wins, strides = [], [], []
    for z in ([z1] if z2 == z1 else [z1, z2]):
        _, _, win, stride = emb.props.grid(h, w, z)
        g = np.stack([emb.grids[(i, z)] for i in range(n_imgs)])
        grids.append(torch.as_tensor(g, dtype=torch.float32, device=dev))
        wins.append(float(win))
        strides.append(float(stride))
    return DevicePyramid(grids=tuple(grids), wins=tuple(wins),
                         strides=tuple(strides), t=t)


def compute_or_load_pyramid(images, encoder, props: PyramidEmbedderProperties,
                            cache_path, device="cuda") -> PyramidEmbedding:
    """The cached pyramid at ``cache_path`` if the file exists, else a new
    one, computed on ``device`` and saved there."""
    cache_path = Path(cache_path)
    if cache_path.exists():
        return PyramidEmbedding.load(cache_path)
    emb = PyramidEmbedder(encoder, props, device=device)(images)
    cache_path.parent.mkdir(parents=True, exist_ok=True)
    emb.save(cache_path)
    return emb


class RandomProjectionPatchEncoder:
    """Deterministic stand-in image encoder: resize to input_size, a fixed
    random projection plus a bias, L2 normalise. The projection and bias
    are the JAX package's, drawn from np.random.RandomState(seed) (the
    projection f64, as numpy's promotion gives it there; the product is
    taken in f64 as there). Takes a numpy batch (returns numpy) or a tensor
    (returns a tensor on its device)."""

    def __init__(self, embed_dim: int = 768, input_size: int = 32,
                 seed: int = 0):
        self.embed_dim = embed_dim
        self.input_size = input_size
        rng = np.random.RandomState(seed)
        self.proj = rng.randn(input_size * input_size * 3, embed_dim) \
            .astype(np.float32) / np.sqrt(input_size * input_size * 3)
        # real CLIP maps every patch, an all-black one too, to a unit
        # vector; the bias gives black patches their own direction
        self.bias = (rng.randn(embed_dim) * 0.3).astype(np.float32)
        self._on = {}

    def _weights(self, dev: torch.device):
        if dev not in self._on:
            self._on[dev] = (torch.as_tensor(self.proj, device=dev),
                             torch.as_tensor(self.bias, device=dev))
        return self._on[dev]

    def __call__(self, patches):
        as_numpy = not torch.is_tensor(patches)
        x = torch.as_tensor(np.asarray(patches, np.float32)) if as_numpy \
            else patches.float()
        s = self.input_size
        flat = resize_linear(x, (s, s)).reshape(x.shape[0], -1)
        proj, bias = self._weights(x.device)
        out = flat.to(proj.dtype) @ proj + bias
        out = out / torch.clamp(torch.linalg.norm(out, dim=-1, keepdim=True),
                                min=1e-8)
        return out.numpy() if as_numpy else out

    def encode_text(self, texts: List[str]) -> np.ndarray:
        """Hash-seeded text embeddings. Python's hash() of a str is salted
        per process, as in the JAX package: a prompt's embedding repeats
        only within one process."""
        out = np.stack([
            np.random.RandomState(abs(hash(t)) % (2 ** 31)).randn(
                self.embed_dim)
            for t in texts]).astype(np.float32)
        return out / np.maximum(np.linalg.norm(out, axis=-1, keepdims=True),
                                1e-8)


def load_clip_encoder(model_path: str, device="cuda"):
    """(image_encoder, text_encoder) callables of a local HuggingFace CLIP
    checkpoint (the JAX package's wrapper). Both return numpy [n, E]."""
    from transformers import CLIPModel, CLIPProcessor
    dev = resolve_device(device)
    model = CLIPModel.from_pretrained(model_path).to(dev).eval()
    processor = CLIPProcessor.from_pretrained(model_path)

    def encode_images(patches) -> np.ndarray:
        if torch.is_tensor(patches):
            patches = patches.detach().cpu().numpy()
        with torch.no_grad():
            inputs = processor(
                images=[(p * 255).astype(np.uint8) for p in patches],
                return_tensors="pt").to(dev)
            feats = model.get_image_features(**inputs)
        return feats.cpu().numpy()

    def encode_text(texts: List[str]) -> np.ndarray:
        with torch.no_grad():
            inputs = processor(text=texts, return_tensors="pt",
                               padding=True).to(dev)
            feats = model.get_text_features(**inputs)
        return feats.cpu().numpy()

    return encode_images, encode_text
