"""NeRFExecutor, serving subset (port of nerfpp_tpu/executor.py).

Builds the HashNeRF stack (blocked hash encoder, SH directions, NeRFSmall),
initialises its parameters and occupancy grid from a seed, loads weights
carried over from the JAX package (convert.py), and renders views:
``render_view`` (with RenderFactor and the 8-bit image), ``render_views``
(a loop over poses), and the auto two-class render budget that picks each
view's dense fraction from its occupancy tile masses.

Training, the optimizer, checkpoints, LeRF and the other encoders and
fields belong to later slices of the port and raise NotImplementedError.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from nerfpp_tpu_torch import resolve_device
from nerfpp_tpu_torch.config import ExecutorParams, TrainParams
from nerfpp_tpu_torch.core.occupancy import OccupancyGrid, make_occupancy_grid
from nerfpp_tpu_torch.encoders.hashgrid import HashGridEncoder
from nerfpp_tpu_torch.encoders.sh import SHEncoder
from nerfpp_tpu_torch.models.nerf_small import NeRFSmall
from nerfpp_tpu_torch.render.renderer import (RenderConfig,
                                              make_nerf_integrate_fn,
                                              make_nerf_network_fn,
                                              probe_tile_mass, render_image)


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to nerfpp_tpu_torch "
                               "yet (see ROADMAP.md)")


class NeRFExecutor:
    def __init__(self, params: ExecutorParams, device="cuda"):
        self.params = params
        self.device = resolve_device(device)
        self.n_importance = params.n_importance
        self.use_viewdirs = params.use_viewdirs
        self.bounding_box: Optional[np.ndarray] = None
        self.white_bkgr = False
        self.sp_alpha0 = 0.0
        self.embedder: Optional[HashGridEncoder] = None
        self.embeddirs: Optional[SHEncoder] = None
        self.model: Optional[NeRFSmall] = None
        self.occupancy: Optional[OccupancyGrid] = None
        self._auto_frac_cache: Dict[Any, float] = {}

    # ------------------------------------------------------------ builders

    def _build_embedder(self, bounding_box: np.ndarray) -> HashGridEncoder:
        p = self.params
        if p.embedder_type != "hash":
            raise _not_ported(f"embedder_type {p.embedder_type!r}")
        return HashGridEncoder(
            bounding_box, p.n_levels, p.n_features_per_level,
            p.log2_hashmap_size, p.base_resolution, p.finest_resolution,
            scheme=p.hash_scheme, use_kernel=p.use_pallas_encoder,
            device=self.device)

    def _build_embeddirs(self) -> SHEncoder:
        p = self.params
        if p.embeddirs_type != "sh":
            raise _not_ported(f"embeddirs_type {p.embeddirs_type!r}")
        return SHEncoder(degree=p.multires_views)

    def _build_model(self, input_ch: int, input_ch_views: int) -> NeRFSmall:
        p = self.params
        if p.model_type != "nerf_small":
            raise _not_ported(f"model_type {p.model_type!r}")
        return NeRFSmall(
            p.net_depth, p.net_width, p.geo_feat_dim, p.num_layers_color,
            p.hidden_dim_color, (p.n_importance == 0) and p.use_pred_normal,
            input_ch=input_ch, input_ch_views=input_ch_views,
            compute_dtype=p.compute_dtype, init_gain=p.mlp_init_gain,
            device=self.device)

    def initialize(self, bounding_box, seed: int = 0) -> "NeRFExecutor":
        """Build the stack and draw its parameters from ``seed`` (on a CPU
        generator, so every device gets the same weights); the occupancy
        grid starts uniform. No optimizer, no checkpoint restore."""
        p = self.params
        if p.use_lerf:
            raise _not_ported("LeRF")
        if not p.use_nerf:
            raise ValueError("nothing to build: use_nerf is False")
        self.bounding_box = np.asarray(bounding_box, np.float32).reshape(6)
        gen = torch.Generator().manual_seed(seed)
        self.embedder = self._build_embedder(self.bounding_box)
        self.embedder.reset_parameters(gen)
        input_ch_views = 0
        if p.use_viewdirs:
            self.embeddirs = self._build_embeddirs()
            input_ch_views = self.embeddirs.output_dims
        self.model = self._build_model(self.embedder.output_dims,
                                       input_ch_views)
        self.model.reset_parameters(gen)
        if p.use_occupancy_grid:
            self.occupancy = make_occupancy_grid(p.occ_grid_resolution,
                                                 self.device)
        diag = np.linalg.norm(self.bounding_box[3:] - self.bounding_box[:3])
        self.sp_alpha0 = float(0.02 * diag)
        self._auto_frac_cache = {}
        return self

    def load_state(self, state: Dict[str, torch.Tensor]) -> None:
        """Load a state from convert.state_from_jax: ``embed.*`` into the
        encoder, ``model.*`` into the field, ``occupancy`` into the grid.
        Parts absent from ``state`` are left as they are."""
        sub = {"embed": {}, "model": {}}
        for key, v in state.items():
            if key == "occupancy":
                self.occupancy = OccupancyGrid(
                    density=v.to(self.device, torch.float32).contiguous())
                continue
            head, rest = key.split(".", 1)
            sub[head][rest] = v
        if sub["embed"]:
            self.embedder.load_state_dict(sub["embed"])
        if sub["model"]:
            self.model.load_state_dict(sub["model"])
        self._auto_frac_cache = {}

    # ------------------------------------------------------------- closures

    def _sample_major(self) -> bool:
        """Sample-major flattening pairs with tile-ordered rays to keep the
        blocked kernel's window lists short."""
        return (self.embedder is not None
                and self.embedder.scheme == "blocked"
                and self.embedder.use_kernel)

    def _nerf_fns(self):
        return make_nerf_network_fn(self.embedder, self.embeddirs, self.model,
                                    sample_major=self._sample_major())

    def make_render_config(self, tp: TrainParams, train: bool = True,
                           return_weights: bool = False) -> RenderConfig:
        return RenderConfig(
            n_samples=tp.n_samples, n_importance=self.n_importance,
            chunk=tp.chunk, return_raw=tp.return_raw, lin_disp=tp.lin_disp,
            perturb=0.0, white_bkgr=self.white_bkgr, ndc=tp.ndc,
            use_viewdirs=self.use_viewdirs, thin_ray=self.params.thin_ray,
            return_weights=return_weights,
            use_raw_noise=train, use_sp_noise=train and self.sp_alpha0 > 0,
            density_activation=self.params.density_activation,
            tile_order=self._sample_major(),
            n_occ_bins=(self.params.occ_n_bins
                        if self.params.use_occupancy_grid else 0),
            occ_uniform_frac=self.params.occ_uniform_frac,
            occ_ray_tile=self.params.occ_ray_tile,
            hier_ray_tile=self.params.hier_ray_tile)

    # ------------------------------------------------------------ rendering

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def render_view(self, pose, h: int, w: int, k, tp: TrainParams,
                    generator: Optional[torch.Generator] = None
                    ) -> Dict[str, Any]:
        """Render one full view. RenderFactor > 0 downscales H, W and the
        intrinsics. Returns {"nerf": RenderOutputs of [h, w, ...] maps,
        "near_far": (near_min, far_max), "rgb8": [h, w, 3] uint8}."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if tp.render_factor > 0:
            f = int(tp.render_factor)
            h, w = h // f, w // f
            k = np.asarray(k, np.float32).copy()
            k[0, 0] /= f
            k[1, 1] /= f
            k[0, 2] /= f
            k[1, 2] /= f
        cfg = self.make_render_config(tp, train=False)
        dense_frac = 0.0
        kw = {}
        if self.params.use_occupancy_grid:
            if self._auto_frac_eligible(cfg):
                dense_frac = self._auto_dense_frac(h, w, k, pose)
            else:
                dense_frac = max(self.params.render_dense_frac, 0.0)
            kw = dict(occupancy=self.occupancy, dense_frac=dense_frac,
                      sparse_samples=self.params.render_sparse_samples,
                      prior_bins=self.params.render_prior_bins)
        with torch.no_grad():
            res, near_far = render_image(
                self._nerf_fns(), make_nerf_integrate_fn(cfg), h, w,
                self._tensor(k), self._tensor(pose), cfg,
                self._tensor(self.bounding_box), generator, **kw)
            rgb8 = (torch.clamp(res.rgb, 0.0, 1.0) * 255.0 + 0.5).to(
                torch.uint8)
        return {"nerf": res, "near_far": near_far, "rgb8": rgb8}

    def render_views(self, poses, h: int, w: int, k, tp: TrainParams,
                     generator: Optional[torch.Generator] = None):
        """Render a list of views, one after another (no device mesh)."""
        return [self.render_view(p, h, w, k, tp, generator) for p in poses]

    def _auto_frac_eligible(self, cfg: RenderConfig) -> bool:
        """Auto (render_dense_frac < 0) resolves only where the budget path
        exists: occupancy grid in world space and tile-ordered pixels."""
        return (self.params.use_occupancy_grid
                and self.params.render_dense_frac < 0
                and self.params.occ_n_bins > 0 and not cfg.ndc
                and cfg.tile_order)

    def _auto_dense_frac(self, h: int, w: int, k, poses) -> float:
        """The dense fraction from the view's own occupancy: tiles whose
        probe mass clears 2% of the view's peak, padded by 25% + 2 tiles,
        bucketed to n_tiles/32. For a list of poses, the max over views."""
        poses = np.asarray(poses, np.float32)
        if poses.ndim == 2:
            poses = poses[None]
        hp, wp = -(-h // 8) * 8, -(-w // 16) * 16
        n_tiles = hp * wp // 128
        if n_tiles < 2:
            return 0.0
        ck = (h, w, np.asarray(k, np.float32).round(5).tobytes(),
              poses.round(5).tobytes(), id(self.occupancy))
        hit = self._auto_frac_cache.get(ck)
        if hit is not None:
            return hit
        bbox = self._tensor(self.bounding_box)
        k_t = self._tensor(k)
        with torch.no_grad():
            m = torch.stack([probe_tile_mass(self.occupancy, h, w, k_t,
                                             self._tensor(p), bbox)
                             for p in poses]).cpu().numpy()       # [V, T]
        peak = m.max(axis=1, keepdims=True)
        # an empty grid gives no ranking signal: everything dense
        occupied = np.where(peak[:, 0] > 0,
                            (m > 0.02 * peak).sum(axis=1), n_tiles)
        kd = int(np.ceil(1.25 * occupied.max())) + 2
        step = max(1, n_tiles // 32)
        kd = -(-kd // step) * step
        kd = min(max(kd, 1), n_tiles - 1)
        frac = kd / n_tiles          # renderer.k_dense_of recovers kd
        if len(self._auto_frac_cache) > 64:
            self._auto_frac_cache.clear()
        self._auto_frac_cache[ck] = frac
        return frac
