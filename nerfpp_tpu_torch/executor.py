"""NeRFExecutor (port of nerfpp_tpu/executor.py).

Builds the HashNeRF stack (blocked, fixed or random hash encoder, SH
directions, NeRFSmall) or the classic NeRF stack (frequency encoders,
NeRFMLP), initialises its parameters, one Adam over all of them and the
occupancy grid from a seed, loads states carried over from the JAX package
(convert.py) or from the port's checkpoints, trains, and renders views.

Training mirrors the JAX package's step (``_build_train_step``): tile
sampling, the occupancy refresh (full during the warmup, one octant per
refresh after it), the annealed density noise and stochastic-
preconditioning alpha, the two-class tile budget after its warmup (ranked by
occupancy mass, or for the hierarchical path without a grid by the coarse
pass's weight mass), the importance pass, the Huber loss, the fixed scheme's
total-variation loss, the backward through NeRFSmall and the encoder
(kernel K3 or the small-table gradient kernel for the table), and Adam with
a continuous exponential decay that skips the update when the loss is not
finite. ``train`` is the loop around it: ``steps_per_call`` steps between
host looks, the [TRAIN] line and metrics.csv, checkpoints, validation images
(IImg), test-split renders (ITestset), RenderOnly, and the collapse check
with its auto-recovery.

Rendering: ``render_view`` (with RenderFactor and the 8-bit image),
``render_views`` (a loop over poses, or view-parallel over a mesh),
``render_path`` (PNG files), ``render_test_split``, and the auto two-class
render budget that picks each view's dense fraction from its occupancy
tile masses.

LeRF (``use_lerf``): a second hash grid (random primes from seed 1) and the
bias-free LeRF field beside the NeRF stack, in the same Adam. The train
step renders the language branch of each chunk too (no view directions,
the annealed noises, no occupancy grid) against the CLIP pyramid's
per-pixel embeddings: the Huber (delta 1.25) summed over the embedding and
averaged over the step's finite rays. Serving renders it in parts of at
most LERF_CHUNK_BYTES of per-sample embeddings, with relevancy against the
prompts (``set_lerf_prompts``) and ``relevancy_{i}.png`` in JET.

The bbox refit (``refit_bbox_from_grid``, ``bbox_refit_step``): at the
first host look at or past that step, ``train`` shrinks the scene box to
the occupancy grid's mass and redraws the position-keyed state on it
(tables and their Adam moments, the grid), keeping the MLPs, their moments,
the schedules and the step.

Data parallelism (``mesh``, parallel/mesh.py: one process a device in a
``torch.distributed`` group): the train step's explicit and implicit
gradient all-reduce (``dp_grad_reduce``), ``train`` with rank 0 alone
writing, and view-parallel ``render_views`` / ``render_path`` /
``render_test_split``.

A LeRF-only stack (``use_nerf=False, use_lerf=True``): the language table
and field alone, one Adam over them and no occupancy grid; the step's loss
is the language term alone, serving returns ``"lerf"`` alone. The normals
head (``use_pred_normal``, coarse-only nets) is built and trained like the
JAX package's: no loss reads it, and it draws its weights after every
other parameter. NDC rays (``TrainParams.ndc``) serve through
``render_view[s]`` / ``render_path``; the train step refuses them (the
JAX step passes no focal). ``train(profile_dir=)`` traces steps
start + 9 to start + 20 with utils/profiling.py.
"""
from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from nerfpp_tpu_torch import resolve_device
from nerfpp_tpu_torch.config import ExecutorParams, TrainParams
from nerfpp_tpu_torch.core.integrate import (apply_density_activation,
                                             huber_loss, psnr_from_mse)
from nerfpp_tpu_torch.core.sampling import fork, row_draws
from nerfpp_tpu_torch.core.occupancy import (OccupancyGrid,
                                             make_occupancy_grid, update_grid,
                                             update_grid_phased)
from nerfpp_tpu_torch.data.dataset import (DevicePyramid, RayBatchSampler,
                                           SceneData)
from nerfpp_tpu_torch.encoders.frequency import FrequencyEncoder
from nerfpp_tpu_torch.encoders.hashgrid import (HashGridEncoder,
                                               total_variation_loss,
                                               tv_cube_size)
from nerfpp_tpu_torch.encoders.sh import SHEncoder
from nerfpp_tpu_torch.models.lerf_field import LeRFField
from nerfpp_tpu_torch.models.nerf_mlp import NeRFMLP
from nerfpp_tpu_torch.models.nerf_small import NeRFSmall
from nerfpp_tpu_torch.optim import Adam
from nerfpp_tpu_torch.parallel import mesh as mesh_utils
from nerfpp_tpu_torch.render import lerf as lerf_render
from nerfpp_tpu_torch.render.renderer import (RenderConfig, TileShard,
                                              make_nerf_integrate_fn,
                                              make_nerf_network_fn,
                                              probe_tile_mass, render_image,
                                              render_ray_batch,
                                              render_ray_batch_budgeted,
                                              render_ray_batch_hier_budgeted)
from nerfpp_tpu_torch.utils import checkpoint as ckpt
from nerfpp_tpu_torch.utils.colormap import apply_jet
from nerfpp_tpu_torch.utils.metrics import MetricsWriter
from nerfpp_tpu_torch.utils.png import write_png
from nerfpp_tpu_torch.utils.profiling import trace


# a LeRF serving chunk renders in parts whose [rays, samples, E + 1] f32
# field output stays under this (at 64 + 192 samples and E = 768: 5,454
# rays, 5,376 in whole 128-ray tiles, 4.2 GB; the 32,768-ray chunk would
# be 25.8 GB a tensor)
LERF_CHUNK_BYTES = 1 << 32


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
        self.embedder = None
        self.embeddirs = None
        self.model = None
        self.lang_embedder = None
        self.lang_model = None
        self.lerf_positives: Optional[torch.Tensor] = None
        self.lerf_negatives: Optional[torch.Tensor] = None
        self.clip_encoder = None          # text encoder of set_lerf_prompts
        self.occupancy: Optional[OccupancyGrid] = None
        self.optimizer: Optional[Adam] = None
        self.step = 0                    # steps taken (the JAX state's step)
        self._auto_frac_cache: Dict[Any, float] = {}
        self._refit_tried = False        # train's bbox refit hook has run

    # ------------------------------------------------------------ builders

    def _build_embedder(self, bounding_box: np.ndarray):
        p = self.params
        if p.embedder_type == "frequency":
            return FrequencyEncoder(p.multires, float(p.multires - 1))
        if p.embedder_type == "hash":
            return HashGridEncoder(
                bounding_box, p.n_levels, p.n_features_per_level,
                p.log2_hashmap_size, p.base_resolution, p.finest_resolution,
                scheme=p.hash_scheme, use_kernel=p.use_pallas_encoder,
                device=self.device)
        raise ValueError(f"unknown embedder_type {p.embedder_type!r}")

    def _build_embeddirs(self):
        p = self.params
        if p.embeddirs_type == "frequency":
            return FrequencyEncoder(p.multires_views,
                                    float(p.multires_views - 1))
        if p.embeddirs_type == "sh":
            return SHEncoder(degree=p.multires_views)
        raise ValueError(f"unknown embeddirs_type {p.embeddirs_type!r}")

    def _build_model(self, input_ch: int, input_ch_views: int):
        p = self.params
        if p.model_type == "nerf":
            return NeRFMLP(p.net_depth, p.net_width, input_ch, input_ch_views,
                           5 if p.n_importance > 0 else 4, frozenset({4}),
                           p.use_viewdirs, init_gain=p.mlp_init_gain,
                           compute_dtype=p.compute_dtype, device=self.device)
        if p.model_type != "nerf_small":
            raise ValueError(f"unknown model_type {p.model_type!r}")
        # the normals head only in a coarse-only net, as in the JAX package
        return NeRFSmall(
            p.net_depth, p.net_width, p.geo_feat_dim, p.num_layers_color,
            p.hidden_dim_color, (p.n_importance == 0) and p.use_pred_normal,
            input_ch=input_ch, input_ch_views=input_ch_views,
            compute_dtype=p.compute_dtype, init_gain=p.mlp_init_gain,
            device=self.device, num_layers_normals=p.num_layers_normals,
            hidden_dim_normals=p.hidden_dim_normals)

    def _build_lang_embedder(self, bounding_box: np.ndarray):
        """The language hash grid (random primes from seed 1; the blocked
        kernels only for the blocked scheme, the large-table kernels
        otherwise, as the JAX package picks)."""
        p = self.params
        return HashGridEncoder(
            bounding_box, p.n_levels_le, p.n_features_per_level_le,
            p.log2_hashmap_size_le, p.base_resolution_le,
            p.finest_resolution_le, scheme=p.hash_scheme, primes_seed=1,
            use_kernel=p.use_pallas_encoder and p.hash_scheme == "blocked",
            device=self.device)

    def _build_lerf(self, bounding_box: np.ndarray) -> None:
        """The language hash grid and the LeRF field."""
        p = self.params
        self.lang_embedder = self._build_lang_embedder(bounding_box)
        self.lang_model = LeRFField(
            p.geo_feat_dim_le, p.num_layers_le, p.hidden_dim_le,
            p.lang_embed_dim, self.lang_embedder.output_dims,
            compute_dtype=p.compute_dtype, device=self.device)

    def initialize(self, bounding_box, lrate_decay: int = 250,
                   seed: int = 0) -> "NeRFExecutor":
        """Build the stack and draw its parameters from ``seed`` (on a CPU
        generator, so every device gets the same weights; ``_reset_params``
        gives the order); one Adam over every parameter (lr decaying by 0.1
        every lrate_decay * 1000 steps); the occupancy grid (NeRF stacks)
        starts uniform. Restores the latest checkpoint under ``ft_path``
        when there is one."""
        p = self.params
        if not (p.use_nerf or p.use_lerf):
            raise ValueError("nothing to build: use_nerf and use_lerf are "
                             "both False")
        self.bounding_box = np.asarray(bounding_box, np.float32).reshape(6)
        if p.use_nerf:
            self.embedder = self._build_embedder(self.bounding_box)
            input_ch_views = 0
            if p.use_viewdirs:
                self.embeddirs = self._build_embeddirs()
                input_ch_views = self.embeddirs.output_dims
            self.model = self._build_model(self.embedder.output_dims,
                                           input_ch_views)
        if p.use_lerf:
            self._build_lerf(self.bounding_box)
        self._reset_params(torch.Generator().manual_seed(seed))
        if p.use_nerf and p.use_occupancy_grid:
            self.occupancy = make_occupancy_grid(p.occ_grid_resolution,
                                                 self.device)
        self.optimizer = Adam(self.named_parameters(), p.learning_rate,
                              lrate_decay * 1000)
        self.step = 0
        diag = np.linalg.norm(self.bounding_box[3:] - self.bounding_box[:3])
        self.sp_alpha0 = float(0.02 * diag)
        self._auto_frac_cache = {}
        self._refit_tried = False
        if p.ft_path:
            restored = ckpt.restore_latest(p.ft_path)
            if restored is not None:
                self.load_state(restored)
                print(f"restored checkpoint at step {self.step}")
        return self

    def _restart_state(self, seed: int = 23) -> None:
        """A from-scratch restart (the JAX package's collapse recovery):
        fresh tables and MLPs drawn as ``initialize`` draws them from
        ``seed``, a fresh Adam, a uniform occupancy grid, step 0; the same
        encoders and bbox."""
        self._reset_params(torch.Generator().manual_seed(seed))
        opt = self.optimizer
        self.optimizer = Adam(self.named_parameters(), opt.lr,
                              opt.decay_steps)
        if self.occupancy is not None:
            self.occupancy = make_occupancy_grid(
                self.params.occ_grid_resolution, self.device)
        self.step = 0
        self._auto_frac_cache = {}

    def refit_bbox_from_grid(self, pad: float = 0.15,
                             thresh_frac: float = 0.02,
                             min_shrink: float = 1.5,
                             seed: int = 17) -> bool:
        """Shrink the scene box to where the occupancy grid has mass, as the
        JAX package does: the cells above ``thresh_frac`` of the grid's peak
        (density[i, j, k] is the cell of world x, y, z), their box padded by
        ``pad`` of its extent and kept inside the old box. Unless the volume
        shrinks by at least ``min_shrink`` nothing changes and this returns
        False. Otherwise the NeRF embedder (and with LeRF the language
        embedder) is rebuilt on the new box, the position-keyed state is
        drawn anew (``_reinit_position_state``), sp_alpha0 follows the new
        diagonal, and it returns True."""
        if self.occupancy is None or self.bounding_box is None:
            return False
        d = self.occupancy.density.detach().cpu().numpy()
        g = d.shape[0]
        peak = float(d.max())
        if peak <= 0.0:
            return False
        idx = np.argwhere(d > thresh_frac * peak)
        if idx.size == 0:
            return False
        old = self.bounding_box.reshape(2, 3)
        cell = (old[1] - old[0]) / g
        lo = old[0] + idx.min(0) * cell
        hi = old[0] + (idx.max(0) + 1) * cell
        span = hi - lo
        lo = np.maximum(lo - pad * span, old[0])
        hi = np.minimum(hi + pad * span, old[1])
        old_vol = float(np.prod(old[1] - old[0]))
        new_vol = float(np.prod(hi - lo))
        if new_vol <= 0.0 or old_vol / new_vol < min_shrink:
            return False
        new_box = np.concatenate([lo, hi]).astype(np.float32)
        self.bounding_box = new_box
        if self.params.use_nerf:
            self.embedder = self._build_embedder(new_box)
        if self.lang_embedder is not None:
            self.lang_embedder = self._build_lang_embedder(new_box)
        self._reinit_position_state(seed)
        diag = np.linalg.norm(new_box[3:] - new_box[:3])
        self.sp_alpha0 = float(0.02 * diag)
        print(f"bbox refit: {np.round(old.reshape(-1), 2).tolist()} -> "
              f"{np.round(new_box, 2).tolist()} "
              f"({old_vol / new_vol:.1f}x volume shrink)")
        return True

    def _reinit_position_state(self, seed: int = 17) -> None:
        """Redraw the position-keyed state in place (the bbox refit's
        second half): the tables from a CPU generator seeded with ``seed``
        (NeRF, then language), their Adam moments zeroed, the occupancy
        grid uniform, the render caches cleared. The MLPs, their moments,
        Adam's count and the step are kept."""
        gen = torch.Generator().manual_seed(seed)
        self._reset_embedder(gen)
        if self.lang_embedder is not None:
            self.lang_embedder.reset_parameters(gen)
        params = self.named_parameters()
        self.optimizer.params = params
        for k in params:
            if k.startswith(("embed.", "lang_embed.")):
                self.optimizer.mu[k].zero_()
                self.optimizer.nu[k].zero_()
        if self.occupancy is not None:
            self.occupancy = make_occupancy_grid(
                self.params.occ_grid_resolution, self.device)
        self._auto_frac_cache = {}

    def _reset_params(self, gen: torch.Generator) -> None:
        """Draw every parameter from ``gen``: the NeRF table and field, the
        language table and field, and last the normals head, so that a seed
        gives every other parameter the same weights with and without it."""
        if self.model is not None:
            self._reset_embedder(gen)
            self.model.reset_parameters(gen)
        if self.lang_model is not None:
            self._reset_lerf(gen)
        if isinstance(self.model, NeRFSmall):
            self.model.reset_normals(gen)

    def _reset_embedder(self, gen: torch.Generator) -> None:
        # the frequency encoder has no parameters
        if isinstance(self.embedder, torch.nn.Module):
            self.embedder.reset_parameters(gen)

    def _reset_lerf(self, gen: torch.Generator) -> None:
        self.lang_embedder.reset_parameters(gen)
        self.lang_model.reset_parameters(gen)

    def named_parameters(self) -> Dict[str, torch.nn.Parameter]:
        """Every trained parameter under its state name (``embed.table``,
        ``model.<net>.layers.<i>.weight``, ``model.pts_linears.<i>.bias``,
        ..., for LeRF ``lang_embed.table`` and
        ``lang_model.<net>.layers.<i>.weight``)."""
        out = {}
        embedder = (self.embedder
                    if isinstance(self.embedder, torch.nn.Module) else None)
        for head, mod in (("embed", embedder), ("model", self.model),
                          ("lang_embed", self.lang_embedder),
                          ("lang_model", self.lang_model)):
            if mod is not None:
                out.update({f"{head}.{k}": v
                            for k, v in mod.named_parameters()})
        return out

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The train state, flat: parameters, ``adam.mu.<name>``,
        ``adam.nu.<name>``, ``adam.count``, ``step`` and ``occupancy``."""
        st = {k: v.detach() for k, v in self.named_parameters().items()}
        for k in st.copy():
            st[f"adam.mu.{k}"] = self.optimizer.mu[k]
            st[f"adam.nu.{k}"] = self.optimizer.nu[k]
        st["adam.count"] = self.optimizer.count
        st["step"] = torch.tensor(self.step, dtype=torch.int64)
        if self.occupancy is not None:
            st["occupancy"] = self.occupancy.density
        return st

    def _replicated(self) -> list:
        """The state every rank of a mesh holds alike: parameters, Adam's
        moments and count, and the occupancy grid."""
        return [v for k, v in self.state_dict().items() if k != "step"]

    def load_state(self, state: Dict[str, torch.Tensor]) -> None:
        """Load a state from convert.state_from_jax or a checkpoint:
        ``embed.*`` into the encoder, ``model.*`` into the field,
        ``lang_embed.*`` and ``lang_model.*`` into LeRF's, ``adam.*`` into
        the optimizer, ``step``, and ``occupancy`` into the grid. Parts
        absent from ``state`` are left as they are."""
        sub = {"embed": {}, "model": {}, "lang_embed": {}, "lang_model": {}}
        for key, v in state.items():
            if key == "occupancy":
                self.occupancy = OccupancyGrid(
                    density=v.to(self.device, torch.float32).contiguous())
            elif key == "step":
                self.step = int(v)
            elif key == "adam.count":
                self.optimizer.count.copy_(v)
            elif key.startswith("adam."):
                _, moment, name = key.split(".", 2)
                getattr(self.optimizer, moment)[name].copy_(v)
            else:
                head, rest = key.split(".", 1)
                sub[head][rest] = v
        for head, mod, flag in (("embed", self.embedder, "use_nerf"),
                                ("model", self.model, "use_nerf"),
                                ("lang_embed", self.lang_embedder,
                                 "use_lerf"),
                                ("lang_model", self.lang_model, "use_lerf")):
            if sub[head]:
                if mod is None:
                    raise ValueError(f"state has {head}.* but {flag} is off")
                mod.load_state_dict(sub[head])
        self._auto_frac_cache = {}

    def save_checkpoint(self, path) -> Path:
        return ckpt.save(path, self.state_dict(), self.step)

    # ------------------------------------------------------------- closures

    def _sample_major(self) -> bool:
        """Sample-major flattening pairs with tile-ordered rays to keep the
        blocked kernel's window lists short."""
        return (isinstance(self.embedder, HashGridEncoder)
                and self.embedder.scheme == "blocked"
                and self.embedder.use_kernel)

    def _nerf_fns(self):
        return make_nerf_network_fn(self.embedder, self.embeddirs, self.model,
                                    sample_major=self._sample_major())

    def _lerf_fns(self, with_relevancy: bool = False,
                  use_raw_noise: bool = False):
        """(network_fn, integrate_fn) of the language branch; relevancy
        against the prompts when asked for and set."""
        lang_embedder = self.lang_embedder
        network_fn = lerf_render.make_lerf_network_fn(
            lang_embedder, self.lang_model,
            sample_major=(lang_embedder.scheme == "blocked"
                          and lang_embedder.use_kernel))
        integrate_fn = lerf_render.make_lerf_integrate_fn(
            self.params.lang_embed_dim,
            self.lerf_positives if with_relevancy else None,
            self.lerf_negatives if with_relevancy else None,
            use_raw_noise=use_raw_noise,
            density_activation=self.params.density_activation)
        return network_fn, integrate_fn

    def _lerf_max_rays(self, cfg: RenderConfig) -> int:
        """Rays of a LeRF serving part: LERF_CHUNK_BYTES of per-sample
        [E + 1] f32 outputs."""
        n = cfg.n_samples + max(cfg.n_importance, 0)
        return max(LERF_CHUNK_BYTES // (n * (self.params.lang_embed_dim + 1)
                                        * 4), 1)

    def _sigma_grid_fn(self):
        """Activated field density at points, for the occupancy refresh
        (view directions zero: sigma does not depend on them)."""
        act = self.params.density_activation

        def sigma_fn(pts):
            emb, keep = self.embedder(pts)
            if self.embeddirs is not None:
                # the SH features of the zero direction, once for all points
                emb_d, _ = self.embeddirs(pts.new_zeros((1, 3)))
                emb = torch.cat([emb, emb_d.expand(pts.shape[0], -1)], dim=-1)
            sigma = self.model(emb)[..., 3]
            if keep is not None:
                sigma = torch.where(keep, sigma, torch.zeros_like(sigma))
            return apply_density_activation(sigma, act)

        return sigma_fn

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

    # ---------------------------------------------------------- train step

    def _build_train_step(self, tp: TrainParams, mesh=None):
        """-> train_step(step, data, generator=None, draws=None) -> metrics
        (device scalars: mse, img_loss, pred_std, loss, psnr, and lang_loss
        for LeRF). ``data`` is a RayBatchSampler (the batch is drawn from
        ``generator``) or a batch dict (rays_o, rays_d, cone_angle,
        target_rgb, and target_lang for LeRF). The generator also draws the
        refresh jitter and the TV cube origins; ``draws`` may pass the TV
        origins instead (``tv``, int [L, 3]). Chunk c's NeRF render draws
        from ``fork(generator, step, c, 0)`` and its language render from
        ``fork(generator, step, c, 1)``: a chunk's draws depend on (seed,
        step, chunk) only, as the JAX step splits its render key per chunk.
        Gradients accumulate chunk by chunk (one chunk's activations live
        at a time; the NeRF branch's and then the language branch's); one
        Adam update follows, skipped on device when the loss is not finite.

        With a ``mesh`` of more than one rank (parallel/mesh.py) the step
        takes one of the JAX package's two data-parallel paths, chosen as
        it chooses them. Explicit, for dp_grad_reduce "bf16" or "f32" when
        the chunks divide by the world size: rank r takes the r-th
        contiguous block of whole chunks, and the gradients are summed in
        ONE all-reduce of that dtype. Implicit otherwise (dp_grad_reduce
        "implicit", or one chunk as in the flagship): each chunk's tiles
        are dealt out to the ranks as contiguous runs of whole tiles, the
        two-class budgets are ranked over the whole chunk (every rank
        scores every tile from the replicated grid; the hierarchical
        ranking all-gathers the coarse tile masses), each rank renders its
        tiles with the draws one device makes for them, and the gradients
        are summed in f32. Either way the TV term is divided by the world
        size on every rank, LeRF's finite-ray count is summed before the
        language gradients are divided by it, the loss sums and metrics
        are summed in f32, and every rank applies the same summed gradient
        (so the replicas stay equal). At one rank the plain step runs.

        A LeRF-only stack renders the language branch alone: its loss is
        the language term, and its metrics are ``loss`` and ``lang_loss``.
        NDC rays (``tp.ndc``) raise ValueError, where the JAX step fails
        for want of a focal."""
        p = self.params
        if tp.ndc:
            raise ValueError(
                "NDC training is not supported: the reference's train step "
                "passes no focal or image size to render_ray_batch, so NDC "
                "rays train only through render_ray_batch(focal=, hw=) "
                "called directly")
        cfg = self.make_render_config(tp, train=True, return_weights=True)
        chunk = min(tp.chunk, tp.n_rand)
        n_chunks = -(-tp.n_rand // chunk)
        if n_chunks * chunk != tp.n_rand:
            raise ValueError(f"NRand ({tp.n_rand}) must be divisible by "
                             f"Chunk ({chunk}) for fixed-shape chunking")
        if p.dp_grad_reduce not in ("bf16", "f32", "implicit"):
            raise ValueError(f"unknown dp_grad_reduce {p.dp_grad_reduce!r}")
        # tiles share depths only where the chunk divides into them: say so
        # in the config, so that a rank's share of a chunk never does where
        # the chunk does not
        if cfg.occ_ray_tile > 0 and chunk % cfg.occ_ray_tile:
            cfg = dataclasses.replace(cfg, occ_ray_tile=0)
        if cfg.hier_ray_tile > 0 and chunk % cfg.hier_ray_tile:
            cfg = dataclasses.replace(cfg, hier_ray_tile=0)
        world = 1 if mesh is None else mesh.world
        if world == 1:
            mesh = None
        expl = mesh is not None and p.dp_grad_reduce != "implicit" \
            and n_chunks % world == 0
        use_nerf = p.use_nerf
        use_occ = use_nerf and p.use_occupancy_grid
        occ_every = p.occ_update_every
        use_budget = (use_occ and p.occ_tile_budget_frac > 0.0
                      and cfg.occ_ray_tile > 0
                      and chunk % cfg.occ_ray_tile == 0
                      and chunk // cfg.occ_ray_tile >= 2)
        # the hierarchical analog: the fine pass's budget ranked by the
        # coarse pass's own tile-mean weight mass (no occupancy grid)
        use_hier_budget = (use_nerf and not use_occ and not use_budget
                           and p.hier_tile_budget_frac > 0.0
                           and cfg.hier_ray_tile > 0
                           and cfg.n_importance > 0
                           and chunk % cfg.hier_ray_tile == 0
                           and chunk // cfg.hier_ray_tile >= 2)
        warm = (p.occ_tile_budget_warmup if use_budget
                else p.hier_budget_warmup if use_hier_budget else 0)
        use_tv = (use_nerf and p.embedder_type == "hash"
                  and p.hash_scheme == "fixed")
        use_lerf = p.use_lerf
        if use_nerf:
            network_fn = self._nerf_fns()
            integrate_fn = make_nerf_integrate_fn(cfg)
        if use_occ:
            sigma_fn = self._sigma_grid_fn()
        bbox = self._tensor(self.bounding_box)
        params = self.named_parameters()
        embedder = self.embedder
        n_pix = float(tp.n_rand * 3)
        noise_steps = np.float32(tp.n_iters / 8.0)
        sp_steps = np.float32(tp.n_iters / 6.0)
        sp_alpha0 = np.float32(self.sp_alpha0)
        if use_lerf:
            # the annealed density noise applies to the language field too
            lerf_net, lerf_int = self._lerf_fns(use_raw_noise=True)
            lcfg = dataclasses.replace(cfg, use_viewdirs=False)
            lang_params = [v for k, v in params.items()
                           if k.startswith("lang_")]
        shards = None
        if mesh is not None and not expl:
            # the implicit path: every tile size a render of the chunk
            # shares depths over, and the 8x16 pixel tiles where they fit
            unit = 1
            nerf_occ = use_occ and cfg.n_occ_bins > 0
            for t in (cfg.occ_ray_tile if nerf_occ else 0,
                      cfg.hier_ray_tile if not nerf_occ or use_lerf else 0,
                      128):
                if t > 0 and chunk % math.lcm(unit, t) == 0:
                    unit = math.lcm(unit, t)
                elif t > 0 and t != 128:
                    raise ValueError(f"a chunk of {chunk} rays does not "
                                     f"divide into whole tiles of {t} and "
                                     f"{unit} rays for data parallelism")
            btile = (cfg.occ_ray_tile if use_budget else cfg.hier_ray_tile
                     if use_hier_budget else unit)
            spans = [mesh_utils.rank_rows(chunk, world, r, unit)
                     for r in range(world)]
            lo, hi = spans[mesh.rank]
            shards = (lo, hi, TileShard(
                lo // btile, hi // btile,
                tuple((b - a) // btile for a, b in spans),
                mesh.all_gather_rows))

        def chunk_sums(cb, step, raw_noise_std, sp_alpha, generator):
            """Render one chunk (this rank's tiles of it on the implicit
            path); -> [sq, huber, pred, pred^2] sums, or None where nothing
            rendered here."""
            occ = self.occupancy if use_occ else None
            target = cb["target_rgb"]
            shard = shards[2] if shards is not None else None
            if use_budget and step >= warm:
                res_d, res_s, idx_d, idx_s = render_ray_batch_budgeted(
                    network_fn, integrate_fn, cb["rays_o"], cb["rays_d"],
                    cb["cone_angle"], cfg, bbox, raw_noise_std, occ,
                    p.occ_tile_budget_frac, p.occ_sparse_samples, generator,
                    sp_alpha=sp_alpha, shard=shard)
                parts = ((res_d, idx_d), (res_s, idx_s))
            elif use_hier_budget and step >= warm:
                res_d, res_s, idx_d, idx_s = render_ray_batch_hier_budgeted(
                    network_fn, integrate_fn, cb["rays_o"], cb["rays_d"],
                    cb["cone_angle"], cfg, bbox, raw_noise_std, sp_alpha,
                    p.hier_tile_budget_frac, p.hier_sparse_importance,
                    generator, shard=shard)
                parts = ((res_d, idx_d), (res_s, idx_s))
            else:
                if shards is not None:
                    lo, hi = shards[0], shards[1]
                    cb = {k: v[lo:hi] if v.ndim >= 1 else v
                          for k, v in cb.items()}
                    generator = row_draws(generator, chunk, slice(lo, hi))
                    if hi == lo:
                        return None
                res = render_ray_batch(
                    network_fn, integrate_fn, cb["rays_o"], cb["rays_d"],
                    cb["cone_angle"], cfg, bbox, raw_noise_std, occ,
                    generator, sp_alpha=sp_alpha)
                parts = ((res, slice(None)),)
                target = cb["target_rgb"]
            sums = None
            for res, idx in parts:
                if res is None:
                    continue
                rgb, t = res.outputs.rgb, target[idx]
                rs = rgb.detach()
                s = torch.stack([
                    torch.sum((rgb - t) ** 2), torch.sum(huber_loss(rgb, t)),
                    torch.sum(rs), torch.sum(rs * rs)])
                sums = s if sums is None else sums + s
            return sums

        def lang_sums(cb, raw_noise_std, sp_alpha, generator):
            """Render one chunk's language branch (this rank's rows of it on
            the implicit path); -> [sum of the finite rays' Huber (delta
            1.25, summed over the embedding), finite rays], or None."""
            if "target_lang" not in cb:
                raise ValueError("LeRF training needs target_lang: pass "
                                 "lang_embeddings to train")
            if shards is not None:
                lo, hi = shards[0], shards[1]
                cb = {k: v[lo:hi] if v.ndim >= 1 else v
                      for k, v in cb.items()}
                generator = row_draws(generator, chunk, slice(lo, hi))
                if hi == lo:
                    return None
            res = render_ray_batch(
                lerf_net, lerf_int, cb["rays_o"], cb["rays_d"],
                cb["cone_angle"], lcfg, bbox, raw_noise_std, None, generator,
                sp_alpha=sp_alpha)
            per_ray = torch.sum(huber_loss(
                res.outputs.rendered_lang_embedding, cb["target_lang"],
                delta=1.25), dim=-1)
            finite = torch.isfinite(per_ray)
            return torch.stack([
                torch.sum(torch.where(finite, per_ray,
                                      torch.zeros_like(per_ray))),
                torch.sum(finite).float()])

        def tv_term(generator, origins):
            """1e-6 x the TV loss summed over the levels (fixed scheme)."""
            tv = 0.0
            for lvl in range(embedder.n_levels):
                if origins is not None:
                    mv = origins[lvl]
                else:
                    if generator is None:
                        raise ValueError("the TV cube origins need a "
                                         "generator or passed-in draws")
                    res, cube = tv_cube_size(embedder, lvl)
                    mv = torch.randint(0, max(res - cube, 1), (3,),
                                       generator=generator,
                                       device=generator.device)
                tv = tv + total_variation_loss(embedder, embedder.table, lvl,
                                               mv)
            return 1e-6 * tv

        def train_step(step: int, data, generator=None, draws=None):
            draws = draws or {}
            batch = (data.sample(step, generator)
                     if isinstance(data, RayBatchSampler) else data)
            if use_occ and step % occ_every == 0:
                if p.occ_phased_refresh and step >= p.occ_phased_warmup:
                    self.occupancy = update_grid_phased(
                        self.occupancy, sigma_fn, bbox,
                        (step // occ_every) % 8, p.occ_decay,
                        generator=generator)
                else:
                    self.occupancy = update_grid(
                        self.occupancy, sigma_fn, bbox, p.occ_decay,
                        generator=generator)
            # annealed density noise and preconditioning alpha, in f32 as
            # the JAX step computes them
            stepf = np.float32(step)
            raw_noise_std = float(max(np.float32(0.0),
                                      np.float32(1.0) - stepf / noise_steps))
            sp_alpha = float(sp_alpha0 * max(
                np.float32(0.0), np.float32(1.0) - stepf / sp_steps))
            for prm in params.values():
                prm.grad = None
            chunks = range(n_chunks)
            if expl:
                # the rank's block of whole chunks (and the row check)
                mesh_utils.shard_rays(batch, mesh, chunk)
                per = n_chunks // world
                chunks = range(mesh.rank * per, (mesh.rank + 1) * per)
            total = torch.zeros(4, device=self.device)
            lang = torch.zeros(2, device=self.device)
            for c in chunks:
                cb = {k: (v[c * chunk:(c + 1) * chunk]
                          if v.ndim >= 1 and v.shape[0] == tp.n_rand else v)
                      for k, v in batch.items()}
                if shards is not None:
                    mesh_utils.shard_rays(cb, mesh)         # the row check
                sums = None
                if use_nerf:
                    sums = chunk_sums(cb, step, raw_noise_std, sp_alpha,
                                      fork(generator, step, c, 0))
                if sums is not None:
                    (sums[1] / n_pix).backward()
                    total = total + sums.detach()
                if use_lerf:
                    ls = lang_sums(cb, raw_noise_std, sp_alpha,
                                   fork(generator, step, c, 1))
                    if ls is not None:
                        ls[0].backward()
                        lang = lang + ls.detach()
            if mesh is not None:
                # the step's sums over every rank, in f32
                stats = mesh.all_reduce(torch.cat([total, lang]))
                total, lang = stats[:4], stats[4:]
            # (0 without the NeRF branch, as the JAX step starts its sum)
            loss = total[1] / n_pix
            img_loss = loss
            if use_tv and step < tp.n_iters // 2:
                tv = tv_term(generator, draws.get("tv"))
                # every rank adds its share: the sum restores the term
                (tv / world if world > 1 else tv).backward()
                loss = loss + tv.detach()
            metrics = {}
            if use_lerf:
                # the language loss divides by the finite rays of all
                # chunks (and ranks), known only now; the language
                # parameters get no gradient from the NeRF branch, so
                # dividing their summed gradients here equals
                # backpropagating the divided loss
                n_finite = torch.clamp(lang[1], min=1.0)
                for prm in lang_params:
                    if prm.grad is not None:
                        prm.grad.div_(n_finite)
                metrics["lang_loss"] = lang[0] / n_finite
                loss = loss + metrics["lang_loss"]
            mesh_utils.all_reduce_grads(
                params, p.dp_grad_reduce if expl else "f32", mesh)
            self.optimizer.step(torch.isfinite(loss))
            self.step = step + 1
            if not use_nerf:
                metrics["loss"] = loss
                return metrics
            mse = total[0] / n_pix
            mu = total[2] / n_pix
            metrics.update({
                "mse": mse, "img_loss": img_loss,
                "pred_std": torch.sqrt(torch.clamp(
                    total[3] / n_pix - mu * mu, min=0.0)),
                "loss": loss, "psnr": psnr_from_mse(mse)})
            return metrics

        return train_step

    # -------------------------------------------------------------- train

    def train(self, scene: SceneData, tp: TrainParams, seed: int = 0,
              sampler: Optional[RayBatchSampler] = None,
              progress_fn=None, steps: Optional[int] = None, mesh=None,
              lang_embeddings=None,
              profile_dir: Optional[str] = None) -> Dict[str, float]:
        """The training loop: steps self.step .. n_iters - 2, as the JAX
        package runs them, or only the next ``steps`` of them (a later call
        resumes; the schedules follow n_iters either way). Step i draws
        from a generator seeded with (seed, i), as the JAX step folds i
        into its key, so a run in stages draws what one run draws. A
        collapse (the batch render's std under auto_fine_rel_std x the
        images' std at a check) restarts the state as the JAX package does
        (``_restart_state``). Every i_print steps the metrics go to the
        [TRAIN] line and base_dir/metrics.csv; every i_img steps the first
        validation view to base_dir/images; every i_testset steps the test
        split to base_dir (unless test_skip). With render_only the test
        split is rendered to base_dir/renderonly and nothing is trained.
        LeRF draws its supervision from ``lang_embeddings``: a
        DevicePyramid (data/pyramid_clip.py ``make_device_pyramid``) or a
        dense [n_train, H, W, E] stack. With bbox_refit_step > 0, at the
        first host look whose loop count is at or past it (once per
        executor; ``initialize`` re-arms it), the box is refit to the
        occupancy grid (``refit_bbox_from_grid``) and the step rebuilt on
        it. With ``profile_dir`` the steps from start + 9 to start + 20
        (start: the step ``train`` begins at; whole host-look blocks) are
        traced into profile_dir/trace.json (utils/profiling.py ``trace``;
        synchronised on a card before the trace closes), once a call.
        Returns the last step's metrics.

        With a ``mesh`` (parallel/mesh.py; every rank calls ``train`` with
        the same arguments) the step is data-parallel
        (``_build_train_step``), the state is broadcast from rank 0 first,
        and rank 0 alone writes: metrics.csv, the [TRAIN] lines, images/,
        checkpoints and the test-split renders (which every rank renders,
        view-parallel). The collapse check reads the ranks' summed metrics
        and the refit a grid broadcast from rank 0, so every rank restarts
        or refits at the same step. NRand must divide by the world size."""
        p = self.params
        world = 1 if mesh is None else mesh.world
        if tp.n_rand % world:
            raise ValueError(f"NRand ({tp.n_rand}) must divide by the device "
                             f"count ({world}) for data parallelism")
        root = mesh is None or mesh.rank == 0
        self.white_bkgr = scene.white_bkgr
        if self.optimizer is None:
            self.initialize(scene.bounding_box, tp.lrate_decay, seed)
        mesh_utils.replicate(self._replicated(), mesh)
        base_dir = Path(tp.base_dir)
        if root:
            base_dir.mkdir(parents=True, exist_ok=True)
        if tp.render_only:
            self.render_test_split(scene, tp, base_dir / "renderonly",
                                   mesh=mesh)
            return {}
        if sampler is None:
            # tiles: 0 = auto (8x16 where the blocked kernels run), -1 = off
            th, tw = tp.tile_h, tp.tile_w
            if th == 0 and tw == 0 and self._sample_major() \
                    and tp.n_rand % 128 == 0:
                th, tw = 8, 16
            pyr = (lang_embeddings
                   if isinstance(lang_embeddings, DevicePyramid) else None)
            sampler = RayBatchSampler.from_scene(
                scene, tp.n_rand, tp.precorp_iters, tp.precorp_frac,
                max(th, 0), max(tw, 0), device=self.device,
                lang_embeddings=None if pyr is not None else lang_embeddings,
                pyramid=pyr)

        def build_step():
            return (self._build_train_step(tp) if mesh is None
                    else self._build_train_step(tp, mesh))

        train_step = build_step()
        generator = torch.Generator(device=self.device)
        # steps between host looks: every active interval still lands
        spc = max(1, tp.steps_per_call)
        for iv in (tp.i_print, tp.i_img, tp.i_weights, tp.i_testset):
            if iv > 0:
                spc = math.gcd(spc, iv)
        writer = MetricsWriter(base_dir) if root else None
        val_idx = (list(scene.split_indices("val"))
                   or list(scene.split_indices("train")))
        # collapse watch: a near-constant batch render past the check step
        auto_pending = (p.auto_fine_fallback and p.use_nerf
                        and p.use_occupancy_grid and p.n_importance == 0)
        if auto_pending:
            if scene.images is not None:
                imgs = np.asarray(scene.images)
                if np.issubdtype(imgs.dtype, np.integer):
                    imgs = imgs.astype(np.float32) / 255.0
                gt_std = float(np.std(imgs[..., :3].astype(np.float32)))
            else:
                # a loaded scene (Blender, COLMAP) has no attached images,
                # where the JAX package raises: the training images' std
                gt_std = float(torch.std(sampler.images, correction=0))
            next_check = max(int(p.auto_fine_check_from), 1)
        metrics: Dict[str, torch.Tensor] = {}
        say = print if root else (lambda *a, **k: None)
        t_start = time.perf_counter()
        rays_done = 0
        # i counts the loop's steps; the state's step (self.step, which
        # drives the schedules and seeds the draws) equals it until a
        # collapse recovery restarts the state at step 0, as in JAX
        i = self.step
        end = tp.n_iters - 1 if steps is None else min(tp.n_iters - 1,
                                                       i + steps)
        # the refit hook runs once, at the first host look with the loop
        # count (not the state's step) at or past bbox_refit_step, as JAX
        # places it at the first dispatch boundary past it
        refit_pending = tp.bbox_refit_step > 0 and not self._refit_tried
        start = i
        profiling = None                 # the open trace's context manager
        profile_pending = profile_dir is not None
        try:
            while i < end:
                if refit_pending and i >= tp.bbox_refit_step:
                    refit_pending = False
                    self._refit_tried = True
                    if self.occupancy is not None:
                        mesh_utils.replicate([self.occupancy.density], mesh)
                    if self.refit_bbox_from_grid():
                        train_step = build_step()
                if profile_pending and i >= start + 9:
                    profile_pending = False
                    profiling = trace(profile_dir, device=self.device)
                    profiling.__enter__()
                k = min(spc - (i % spc), end - i)
                for _ in range(k):
                    generator.manual_seed((seed + 1) * 1_000_003 + self.step)
                    metrics = train_step(self.step, sampler, generator)
                    i += 1
                if profiling is not None and (i >= start + 20 or i >= end):
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    profiling.__exit__(None, None, None)
                    profiling = None
                rays_done += tp.n_rand * k
                if auto_pending and i >= next_check:
                    ps = float(metrics["pred_std"])
                    if ps < p.auto_fine_rel_std * gt_std:
                        say(f"[TRAIN] collapse detected at step {i} "
                            f"(batch render std {ps:.4f} vs GT "
                            f"{gt_std:.4f}): restarting field with "
                            f"importance fine pass "
                            f"(n_importance={p.auto_fine_samples}, "
                            f"tile budget off)")
                        # the JAX package's recovery, quirks included: it sets
                        # the caller's params in place, restarts from the
                        # constant seed 23, and (its render config reads the
                        # executor's n_importance, fixed at construction) the
                        # rebuilt step still renders without the fine pass
                        p.n_importance = p.auto_fine_samples
                        p.occ_tile_budget_frac = 0.0
                        self._restart_state()
                        train_step = build_step()
                        auto_pending = False
                    else:
                        next_check = i + max(int(p.auto_fine_check_from), 1)
                        if next_check > tp.n_iters // 2:
                            auto_pending = False
                if tp.i_weights > 0 and i % tp.i_weights == 0 and root:
                    self.save_checkpoint(base_dir)
                    print(f"Saved checkpoints at {base_dir}")
                if (tp.i_testset > 0 and i % tp.i_testset == 0 and i > 0
                        and not tp.test_skip):
                    self.render_test_split(scene, tp, base_dir, mesh=mesh)
                if tp.i_img > 0 and i % tp.i_img == 0 and i > 0 and root:
                    v = scene.views[val_idx[0]]
                    out = self.render_view(v.pose, v.h, v.w, v.k, tp)
                    if "nerf" in out:
                        writer.write_image(i, "val_rgb", out["nerf"].rgb)
                if tp.i_print > 0 and i % tp.i_print == 0:
                    m = {key: float(v) for key, v in metrics.items()}
                    rps = rays_done / max(time.perf_counter() - t_start, 1e-9)
                    if root:
                        writer.write_scalars(i, m)
                        print(f"[TRAIN] Iter: {i} of {tp.n_iters} "
                              f"Loss: {m.get('loss', 0):.5f} "
                              f"PSNR: {m.get('psnr', 0):.2f} "
                              f"rays/s: {rps:,.0f}")
                    if progress_fn is not None:
                        progress_fn(i, m)
        finally:
            if profiling is not None:      # a step raised inside the window
                profiling.__exit__(None, None, None)
        if (tp.i_weights > 0 and i % tp.i_weights != 0 and i == tp.n_iters - 1
                and root):
            self.save_checkpoint(base_dir)
        return {key: float(v) for key, v in metrics.items()}

    # ------------------------------------------------------------ rendering

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def render_view(self, pose, h: int, w: int, k, tp: TrainParams,
                    generator: Optional[torch.Generator] = None,
                    with_relevancy: bool = True,
                    dense_frac: Optional[float] = None,
                    c2w_staticcam=None) -> Dict[str, Any]:
        """Render one full view. RenderFactor > 0 downscales H, W and the
        intrinsics. ``dense_frac`` overrides the two-class budget's dense
        fraction (by default the view's auto fraction, or
        render_dense_frac). ``c2w_staticcam``: the NeRF branch's rays from
        this pose, its view directions from ``pose`` (render_image).
        Returns {"nerf": RenderOutputs of [h, w, ...] maps, "near_far":
        (near_min, far_max), "rgb8": [h, w, 3] uint8} for a NeRF stack, and
        for LeRF "lerf": LeRFOutputs of [h, w, ...] maps (relevancy [h, w,
        P] when prompts are set and ``with_relevancy``, else None)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        h, w, k = _render_size(h, w, k, tp)
        cfg = self.make_render_config(tp, train=False)
        out = {}
        if self.params.use_nerf:
            kw = {}
            if self.params.use_occupancy_grid:
                if dense_frac is not None:
                    dense_frac = max(dense_frac, 0.0)
                elif self._auto_frac_eligible(cfg):
                    dense_frac = self._auto_dense_frac(h, w, k, pose)
                else:
                    dense_frac = max(self.params.render_dense_frac, 0.0)
                kw = dict(occupancy=self.occupancy, dense_frac=dense_frac,
                          sparse_samples=self.params.render_sparse_samples,
                          prior_bins=self.params.render_prior_bins)
            if c2w_staticcam is not None:
                kw["c2w_staticcam"] = self._tensor(c2w_staticcam)
            with torch.no_grad():
                res, near_far = render_image(
                    self._nerf_fns(), make_nerf_integrate_fn(cfg), h, w,
                    self._tensor(k), self._tensor(pose), cfg,
                    self._tensor(self.bounding_box), generator, **kw)
                rgb8 = (torch.clamp(res.rgb, 0.0, 1.0) * 255.0 + 0.5).to(
                    torch.uint8)
            out = {"nerf": res, "near_far": near_far, "rgb8": rgb8}
        if self.params.use_lerf:
            lcfg = dataclasses.replace(cfg, use_viewdirs=False)
            with torch.no_grad():
                out["lerf"], _ = render_image(
                    *self._lerf_fns(with_relevancy=with_relevancy), h, w,
                    self._tensor(k), self._tensor(pose), lcfg,
                    self._tensor(self.bounding_box), generator,
                    max_rays=self._lerf_max_rays(lcfg))
        return out

    def render_views(self, poses, h: int, w: int, k, tp: TrainParams,
                     generator: Optional[torch.Generator] = None,
                     with_relevancy: bool = True, mesh=None):
        """Render a list of views; -> a list of render_view's outputs. With
        a ``mesh`` of more than one rank (every rank calls this with the
        same arguments) the views render view-parallel and every rank gets
        every frame (``_iter_views``)."""
        return list(self._iter_views(poses, h, w, k, tp, generator,
                                     with_relevancy, mesh))

    def _iter_views(self, poses, h, w, k, tp, generator=None,
                    with_relevancy=True, mesh=None):
        """render_views one view at a time. With a mesh of W > 1 ranks,
        rank r renders view g + r of each group of W views (the last group
        padded by repeating the last pose), every view from the state of
        ``generator`` at the call (a fresh seed-0 generator without one),
        and the group's frames are all-gathered. As in the JAX package the
        auto budget's dense fraction is then the largest of the list's
        views' (a view may differ from its sequential render there)."""
        if mesh is None or mesh.world == 1 or len(poses) <= 1:
            for pose in poses:
                yield self.render_view(pose, h, w, k, tp, generator,
                                       with_relevancy)
            return
        world = mesh.world
        dense_frac = None
        cfg = self.make_render_config(tp, train=False)
        if self._auto_frac_eligible(cfg):
            dense_frac = self._auto_dense_frac(*_render_size(h, w, k, tp),
                                               poses)
        state = None if generator is None else generator.get_state()
        n = len(poses)
        padded = list(poses) + [poses[-1]] * (-n % world)
        for g in range(0, len(padded), world):
            gen = None
            if state is not None:
                gen = torch.Generator(device=generator.device)
                gen.set_state(state)
            out = self.render_view(padded[g + mesh.rank], h, w, k, tp, gen,
                                   with_relevancy, dense_frac=dense_frac)
            frames = _all_gather_view(out, mesh)
            yield from frames[:min(world, n - g)]

    def render_path(self, poses, h: int, w: int, k, tp: TrainParams,
                    save_dir, mesh=None) -> None:
        """Render a pose list and write, for a NeRF stack, {i}.png (the
        8-bit image), disp_{i}.png (disparity over its maximum) and
        depth_{i}.png (depth between the view's near and far), as the JAX
        package writes them;
        with LeRF prompts, relevancy_{i}.png (the first prompt's relevancy
        in JET). With a ``mesh`` the views render view-parallel and rank 0
        alone writes."""
        root = mesh is None or mesh.rank == 0
        save_dir = Path(save_dir)
        if root:
            save_dir.mkdir(parents=True, exist_ok=True)
        for i, out in enumerate(self._iter_views(poses, h, w, k, tp,
                                                 mesh=mesh)):
            if not root:
                continue
            if "nerf" in out:
                res = out["nerf"]
                near, far = (float(out["near_far"][0]),
                             float(out["near_far"][1]))
                write_png(save_dir / f"{i}.png", out["rgb8"].cpu().numpy())
                disp = res.disp.float().cpu().numpy()
                disp = disp / max(float(disp.max()), 1e-10)
                write_png(save_dir / f"disp_{i}.png",
                          (np.clip(disp, 0, 1) * 255).astype(np.uint8))
                depth = ((res.depth.float().cpu().numpy() - near)
                         / max(far - near, 1e-10))
                write_png(save_dir / f"depth_{i}.png",
                          (np.clip(depth, 0, 1) * 255).astype(np.uint8))
            if "lerf" in out and out["lerf"].relevancy is not None:
                rel = out["lerf"].relevancy[..., 0].float().cpu().numpy()
                write_png(save_dir / f"relevancy_{i}.png", apply_jet(
                    (np.clip(rel, 0, 1) * 255).astype(np.uint8)))

    def render_test_split(self, scene: SceneData, tp: TrainParams,
                          save_dir, mesh=None) -> None:
        """Render the test split (the train split when the test split is
        empty or as large as the validation split, as in the JAX package)
        with render_path (view-parallel with a ``mesh``)."""
        test_idx = list(scene.split_indices("test"))
        if not test_idx or scene.splits_idx[2] == scene.splits_idx[1]:
            test_idx = list(scene.split_indices("train"))
        v0 = scene.views[test_idx[0]]
        poses = [scene.views[i].pose for i in test_idx]
        self.render_path(poses, v0.h, v0.w, v0.k, tp, save_dir, mesh=mesh)
        if mesh is None or mesh.rank == 0:
            print("Saved test set")

    # ------------------------------------------------------------- prompts

    def set_clip_encoder(self, encoder) -> None:
        """Attach a text encoder (list of prompts -> [n, E] embeddings)."""
        self.clip_encoder = encoder

    def set_lerf_prompts(self, positives, negatives) -> None:
        """A positive prompt and negative prompts (text, embedded with the
        attached encoder), or their embeddings ([P, E] and [N, E])."""
        if isinstance(positives, str):
            if self.clip_encoder is None:
                raise RuntimeError("set_clip_encoder first to embed text "
                                   "prompts")
            positives = self.clip_encoder([positives])
            negatives = self.clip_encoder(list(negatives))
        self.lerf_positives, self.lerf_negatives = (
            torch.as_tensor(np.asarray(x, np.float32), device=self.device)
            if not torch.is_tensor(x) else x.to(self.device, torch.float32)
            for x in (positives, negatives))

    def get_lerf_prompts(self):
        return self.lerf_positives, self.lerf_negatives

    def _auto_frac_eligible(self, cfg: RenderConfig) -> bool:
        """Auto (render_dense_frac < 0) resolves only where the budget path
        exists: occupancy grid in world space and tile-ordered pixels."""
        return (self.params.use_nerf and self.params.use_occupancy_grid
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


def _render_size(h: int, w: int, k, tp: TrainParams):
    """(h, w, K) of a render: RenderFactor > 0 divides all three."""
    if tp.render_factor > 0:
        f = int(tp.render_factor)
        h, w = h // f, w // f
        k = np.asarray(k, np.float32).copy()
        k[0, 0] /= f
        k[1, 1] /= f
        k[0, 2] /= f
        k[1, 2] /= f
    return h, w, k


def _all_gather_view(out: Dict[str, Any], mesh) -> list:
    """Every rank's render_view output (views of one size), in rank
    order: each tensor all-gathered; unset and dropped per-sample fields
    are kept as they are."""
    def gather(x):
        if x is None or not torch.is_tensor(x) or x.numel() == 0:
            return [x] * mesh.world
        return [y.reshape(x.shape) for y in mesh.all_gather(x.reshape(-1))]

    def gather_fields(nt):
        cols = [gather(v) for v in nt]
        return [type(nt)(*(c[r] for c in cols)) for r in range(mesh.world)]

    parts = {}
    for key, v in out.items():
        if key == "near_far":
            near, far = gather(v[0]), gather(v[1])
            parts[key] = list(zip(near, far))
        elif torch.is_tensor(v):
            parts[key] = gather(v)
        else:
            parts[key] = gather_fields(v)
    return [{key: vals[r] for key, vals in parts.items()}
            for r in range(mesh.world)]
