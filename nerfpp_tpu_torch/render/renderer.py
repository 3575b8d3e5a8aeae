"""Volume renderer (port of nerfpp_tpu/render/renderer.py).

Rendering of ray batches and full images: occupancy-guided depths (per ray
or shared per 128-ray tile), the 8x16 pixel-tile order, the chunk loop (a
Python loop where JAX has ``lax.map``), the two-class budget that gives the
highest-mass tiles the full sample count and the rest a few samples, for
serving (``render_image``) and for training (``render_ray_batch``,
``render_ray_batch_budgeted``), and the hierarchical importance pass
(``n_importance > 0``: inverse-CDF depths from the coarse weights, shared per
``hier_ray_tile`` rays where the batch divides, merged with the coarse
depths; stochastic-preconditioning noise; a second network call) with its
coarse-ranked fine budget for training (``render_ray_batch_hier_budgeted``).
The integrator's outputs may be any NamedTuple (RenderOutputs for NeRF,
render/lerf.py's LeRFOutputs for the language field); full-image renders
drop the per-sample fields (weights, per-sample embeddings) chunk by chunk.
NDC rays (``cfg.ndc``, forward-facing scenes): ``render_ray_batch`` projects
a batch given the focal and the image size, ``render_image`` a view with
its true size and ``k[0, 0]``, the view directions taken before the
projection; the occupancy grid and both budgets live in world space and
refuse NDC rays with the JAX package's errors. ``render_image`` also takes
``c2w_staticcam``: the rays from that pose, the view directions from
``c2w``.

Randomness (the cone scatter, the training-time density noise, stochastic
depths, the preconditioning noise) comes from an explicit
``torch.Generator``, drawn on the generator's device and moved to the rays'
device, or is passed in as tensors (``draws``: ``scatter_u``, ``noise``,
``pdf_draws`` for the coarse pass; ``pdf_draws_fine``, ``sp_noise``,
``scatter_u_fine``, ``noise_fine`` for the importance pass) so tests can feed
the JAX package and the port the same numbers. The two budget classes draw
from forks of the generator (``core/sampling.py`` ``fork``). Under data
parallelism a ``TileShard`` renders a rank's tiles of a training batch
with the draws one device makes for them (``RowDraws``). With
``thin_ray=True``, ``perturb=0`` and no noise a render is deterministic. Nothing here runs
under ``no_grad``: the training path differentiates through it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from nerfpp_tpu_torch.core import rays as ray_math
from nerfpp_tpu_torch.core import sampling as S
from nerfpp_tpu_torch.core.integrate import raw2outputs
from nerfpp_tpu_torch.core.occupancy import (ray_bin_densities,
                                             ray_bin_weights, tiled_prior,
                                             tiled_ray_z)

TILE_H, TILE_W = 8, 16
NDC_OCCUPANCY = ("occupancy-guided sampling is incompatible with NDC rays "
                 "(the grid lives in world space)")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rendering options (the JAX package's fields and defaults)."""
    n_samples: int = 64
    n_importance: int = 192
    chunk: int = 1024 * 32
    return_raw: bool = False
    lin_disp: bool = False
    perturb: float = 0.0
    white_bkgr: bool = False
    ndc: bool = False
    use_viewdirs: bool = True
    thin_ray: bool = False
    return_weights: bool = True
    use_raw_noise: bool = False
    use_sp_noise: bool = False
    density_activation: str = "relu"
    tile_order: bool = False
    n_occ_bins: int = 0
    occ_uniform_frac: float = 0.1
    occ_ray_tile: int = 0
    hier_ray_tile: int = 0


@dataclasses.dataclass(frozen=True)
class TileShard:
    """A rank's share of a training batch under data parallelism: it
    renders the batch's tiles [lo, hi) (a contiguous run; the batch's rays
    are passed whole). ``gather(x, counts)`` concatenates every rank's
    per-tile ``x`` (``counts[r]`` rows on rank r) in rank order, which is
    tile order (an all-gather; parallel/mesh.py ``Mesh.all_gather_rows``).
    ``counts``: every rank's tile count."""
    lo: int
    hi: int
    counts: tuple
    gather: Callable


def _class_rows(tiles, tile: int, shard: Optional[TileShard], generator,
                lanes):
    """A budget class's tiles that render here (all without a shard, else
    those in [shard.lo, shard.hi), in the class's order), their flat ray
    indices, and the class's draws: ``generator`` itself without a shard,
    else the rows of those tiles in draws made for the whole class.
    -> (tiles, ridx, generator), tiles None when none render here."""
    if shard is not None:
        n = tiles.shape[0] * tile
        pos = torch.nonzero((tiles >= shard.lo) & (tiles < shard.hi))[:, 0]
        if pos.numel() == 0:
            return None, None, None
        tiles = tiles[pos]
        generator = S.row_draws(generator, n,
                                (pos[:, None] * tile + lanes).reshape(-1))
    return tiles, (tiles[:, None] * tile + lanes).reshape(-1), generator


# per-sample output fields: dropped from full-image renders
PER_SAMPLE = ("weights", "lang_embedding")


class RenderResult(NamedTuple):
    """``outputs`` and ``coarse`` are the integrator's outputs: any
    NamedTuple of tensors (or None), RenderOutputs for NeRF and LeRFOutputs
    for the language field."""
    outputs: NamedTuple              # the fine pass if there is one
    coarse: NamedTuple
    raw: Optional[torch.Tensor]      # [n_rays, K, C] if return_raw
    z_vals: torch.Tensor             # [n_rays, K] final sample depths


def make_nerf_network_fn(embed_fn, embed_dirs_fn, field_fn,
                         sigma_channel: int = 3, sample_major: bool = False):
    """network_fn(pts [R, S, 3], viewdirs [R, 3] | None) -> raw [R, S, C]:
    flatten (sample-major: all rays at sample 0, then sample 1, ...), embed,
    broadcast the directions, run the field, zero sigma where the point lies
    outside the bbox, and undo the flatten."""

    def network_fn(pts, viewdirs):
        n_rays, n_samples, _ = pts.shape
        if sample_major:
            flat = pts.transpose(0, 1).reshape(-1, 3)
        else:
            flat = pts.reshape(-1, 3)
        embedded, keep_mask = embed_fn(flat)
        if viewdirs is not None:
            dirs = viewdirs[:, None, :].expand(pts.shape)
            if sample_major:
                dirs = dirs.transpose(0, 1)
            embedded_dirs, _ = embed_dirs_fn(dirs.reshape(-1, 3))
            embedded = torch.cat([embedded, embedded_dirs], dim=-1)
        raw = field_fn(embedded)
        if keep_mask is not None:
            sc = sigma_channel if sigma_channel >= 0 else raw.shape[-1] + sigma_channel
            raw = raw.clone()
            raw[..., sc] = torch.where(keep_mask, raw[..., sc],
                                       torch.zeros_like(raw[..., sc]))
        if sample_major:
            return raw.reshape(n_samples, n_rays, raw.shape[-1]).transpose(0, 1)
        return raw.reshape(n_rays, n_samples, raw.shape[-1])

    return network_fn


def make_nerf_integrate_fn(cfg: RenderConfig):
    """Standard rgb + sigma integrator. ``noise`` is a standard-normal draw
    for the training-time density noise (ignored unless use_raw_noise)."""

    def integrate_fn(raw, z_vals, rays_d, raw_noise_std=0.0, noise=None):
        return raw2outputs(raw, z_vals, rays_d, raw_noise_std, cfg.white_bkgr,
                           noise if cfg.use_raw_noise else None,
                           cfg.density_activation)

    return integrate_fn


def _occ_bins_or_z(occupancy, rays_o, rays_d, near, far, bounding_box,
                   cfg: RenderConfig, generator=None):
    """Tile-shared depths when the batch divides into occ_ray_tile groups,
    else the per-ray (edges, weights) prior."""
    tile = cfg.occ_ray_tile
    if tile > 0 and rays_o.shape[0] % tile == 0:
        return tiled_ray_z(occupancy, rays_o, rays_d, near[..., 0],
                           far[..., 0], bounding_box, cfg.n_occ_bins,
                           cfg.n_samples, cfg.occ_uniform_frac, tile,
                           det=(cfg.perturb == 0.0), generator=generator)
    return ray_bin_weights(occupancy, rays_o, rays_d, near, far,
                           bounding_box, cfg.n_occ_bins, cfg.occ_uniform_frac)


def render_rays(network_fn: Callable, integrate_fn: Callable,
                rays_o: torch.Tensor, rays_d: torch.Tensor,
                near: torch.Tensor, far: torch.Tensor,
                viewdirs: Optional[torch.Tensor], cone_angle,
                cfg: RenderConfig, generator: Optional[torch.Generator] = None,
                bounding_box: Optional[torch.Tensor] = None,
                occ_bins=None, raw_noise_std: float = 0.0,
                sp_alpha: float = 0.0,
                draws: Optional[dict] = None) -> RenderResult:
    """Hierarchical volume rendering of one ray batch. rays_o/rays_d [R, 3],
    near/far [R, 1]; ``occ_bins`` are precomputed depths [R, S] or a
    per-ray (edges, weights) prior. ``draws`` optionally supplies the random
    numbers (module doc), else they come from ``generator``; the density
    noise is drawn only with cfg.use_raw_noise and a nonzero
    ``raw_noise_std``, the preconditioning noise (scaled by ``sp_alpha``)
    only with cfg.use_sp_noise, a bbox and a nonzero ``sp_alpha``."""
    draws = draws or {}
    det = cfg.perturb == 0.0
    hier_tile = cfg.hier_ray_tile
    tiled_hier = (occ_bins is None and hier_tile > 0
                  and rays_o.shape[0] % hier_tile == 0)
    if occ_bins is not None and not isinstance(occ_bins, tuple):
        z_vals = occ_bins
    elif occ_bins is not None:
        edges, w = occ_bins
        z_vals = S.sample_pdf(edges, w, cfg.n_samples, det=det,
                              generator=generator,
                              draws=draws.get("pdf_draws"))
    elif tiled_hier:
        nt = rays_o.shape[0] // hier_tile
        near_t = near.reshape(nt, hier_tile).amin(dim=1, keepdim=True)
        far_t = far.reshape(nt, hier_tile).amax(dim=1, keepdim=True)
        z_vals = S.sample_z_vals(
            near_t, far_t, cfg.n_samples, cfg.lin_disp, cfg.perturb,
            _uniform((nt, cfg.n_samples), generator, near.device, det)
        ).repeat_interleave(hier_tile, dim=0)
    else:
        z_vals = S.sample_z_vals(
            near, far, cfg.n_samples, cfg.lin_disp, cfg.perturb,
            _uniform((near.shape[0], cfg.n_samples), generator, near.device,
                     det))
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    pts = _scatter(pts, z_vals, cone_angle, rays_d, cfg, bounding_box,
                   generator, draws.get("scatter_u"))
    raw = network_fn(pts, viewdirs)
    coarse = integrate_fn(raw, z_vals, rays_d, raw_noise_std,
                          _noise(raw, cfg, raw_noise_std, generator,
                                 draws.get("noise")))
    outputs = coarse
    if cfg.n_importance > 0:
        z_mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        cw = coarse.weights[..., 1:-1].detach()
        if tiled_hier:
            # one importance CDF per tile from the tile-mean coarse weights
            nt = rays_o.shape[0] // hier_tile
            z_samples = S.sample_pdf(
                z_mids.reshape(nt, hier_tile, -1)[:, 0, :],
                cw.reshape(nt, hier_tile, -1).mean(dim=1), cfg.n_importance,
                det=det, generator=generator,
                draws=draws.get("pdf_draws_fine")
            ).repeat_interleave(hier_tile, dim=0)
        else:
            z_samples = S.sample_pdf(z_mids, cw, cfg.n_importance, det=det,
                                     generator=generator,
                                     draws=draws.get("pdf_draws_fine"))
        z_vals, raw, outputs = _fine_pass(
            network_fn, integrate_fn, rays_o, rays_d, viewdirs, cone_angle,
            z_vals, z_samples.detach(), cfg, bounding_box, raw_noise_std,
            sp_alpha, generator, draws)
    return RenderResult(outputs=outputs, coarse=coarse,
                        raw=raw if cfg.return_raw else None, z_vals=z_vals)


def _fine_pass(network_fn, integrate_fn, rays_o, rays_d, viewdirs,
               cone_angle, z_coarse, z_samples, cfg: RenderConfig,
               bounding_box, raw_noise_std, sp_alpha, generator, draws):
    """Merge the coarse and importance depths, perturb the points
    (preconditioning noise reflected into the bbox, cone scatter), and run
    the network and the integrator again. -> (z_vals, raw, outputs)."""
    z_vals = S.merge_sorted(z_coarse, z_samples)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    if cfg.use_sp_noise and bounding_box is not None:
        # the JAX package adds alpha * N(0, 1) and reflects even at alpha 0
        noise = draws.get("sp_noise")
        if noise is None and sp_alpha != 0.0:
            noise = S.draw(torch.randn, pts.shape, generator, pts.device)
        if noise is not None:
            pts = pts + noise.to(pts.device) * sp_alpha
        pts = S.reflect_boundary(pts, bounding_box[:3], bounding_box[3:])
    pts = _scatter(pts, z_vals, cone_angle, rays_d, cfg, bounding_box,
                   generator, draws.get("scatter_u_fine"))
    raw = network_fn(pts, viewdirs)
    outputs = integrate_fn(raw, z_vals, rays_d, raw_noise_std,
                           _noise(raw, cfg, raw_noise_std, generator,
                                  draws.get("noise_fine")))
    return z_vals, raw, outputs


def _scatter(pts, z_vals, cone_angle, rays_d, cfg: RenderConfig,
             bounding_box, generator, scatter_u):
    """The cone scatter of one pass (a no-op for thin rays)."""
    if cfg.thin_ray or cone_angle is None:
        return pts
    if scatter_u is None:
        scatter_u = S.scatter_uniforms(z_vals.shape[0], z_vals.shape[1],
                                       generator, z_vals.device)
    return S.tangent_scatter(pts, z_vals, cone_angle, rays_d, *scatter_u,
                             bounding_box)


def _noise(raw, cfg: RenderConfig, raw_noise_std, generator, noise):
    """The density noise of one pass: the passed draw, else a draw when the
    noise is on and nonzero, else None."""
    if cfg.use_raw_noise and noise is None and raw_noise_std != 0.0:
        noise = S.draw(torch.randn, raw.shape[:-1], generator, raw.device)
    return noise


def _uniform(shape, generator, device, det: bool):
    if det:
        return None
    return S.draw(torch.rand, shape, generator, device)


def _viewdirs(rays_d: torch.Tensor, cfg: RenderConfig):
    if not cfg.use_viewdirs:
        return None
    return rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)


def render_ray_batch(network_fn, integrate_fn, rays_o: torch.Tensor,
                     rays_d: torch.Tensor, cone_angle, cfg: RenderConfig,
                     bounding_box: torch.Tensor, raw_noise_std: float = 0.0,
                     occupancy=None,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[dict] = None,
                     sp_alpha: float = 0.0, focal: Optional[float] = None,
                     hw: Optional[tuple] = None) -> RenderResult:
    """Training-path entry: viewdirs (from the directions as given), under
    ``cfg.ndc`` the projection into NDC of an ``hw`` = (h, w) image of
    ``focal`` (near plane 1), per-ray (near, far) from the AABB, the
    occupancy prior (tile-shared where the batch divides into tiles), then
    render_rays. ``draws``: optional, as render_rays takes them."""
    draws = draws or {}
    viewdirs = _viewdirs(rays_d, cfg)
    if cfg.ndc:
        if focal is None or hw is None:
            raise ValueError("NDC rays need the focal and the image size "
                             "(focal=, hw=)")
        h, w = hw
        rays_o, rays_d, cone_angle = ray_math.ndc_rays(
            h, w, focal, 1.0, rays_o, rays_d,
            None if cfg.thin_ray else cone_angle)
    near, far = ray_math.intersect_aabb(rays_o, rays_d, bounding_box)
    occ_bins = None
    if occupancy is not None and cfg.n_occ_bins > 0:
        if cfg.ndc:
            raise ValueError(NDC_OCCUPANCY)
        occ_bins = _occ_bins_or_z(occupancy, rays_o, rays_d, near[:, None],
                                  far[:, None], bounding_box, cfg, generator)
    return render_rays(network_fn, integrate_fn, rays_o, rays_d,
                       near[:, None], far[:, None], viewdirs,
                       None if cfg.thin_ray else cone_angle, cfg, generator,
                       bounding_box, occ_bins, raw_noise_std, sp_alpha, draws)


def render_ray_batch_budgeted(network_fn, integrate_fn, rays_o: torch.Tensor,
                              rays_d: torch.Tensor, cone_angle,
                              cfg: RenderConfig, bounding_box: torch.Tensor,
                              raw_noise_std: float = 0.0, occupancy=None,
                              dense_frac: float = 0.5,
                              sparse_samples: int = 16,
                              generator: Optional[torch.Generator] = None,
                              draws: Optional[dict] = None,
                              sp_alpha: float = 0.0,
                              shard: Optional[TileShard] = None):
    """Two-class per-tile sample budget for training: rank the batch's
    128-ray tiles by occupancy mass (``tiled_prior``; stable, so empty tiles
    keep their order), render the top ``dense_frac`` at cfg.n_samples and
    the rest at ``sparse_samples``, each ray once. ``draws``: optional
    {"dense": {...}, "sparse": {...}}, per class as render_rays takes them
    (``pdf_draws`` place the class's tile-shared depths); otherwise the
    dense class draws from ``fork(generator, 1)`` and the sparse one from
    ``fork(generator, 2)``. With a ``shard`` every tile is still scored and
    ranked (the grid is replicated), and only the shard's tiles render,
    each in the class the whole batch's ranking gives it, with the draws a
    single device makes for it. Returns (res_dense, res_sparse, idx_dense,
    idx_sparse), idx_* the flat ray indices of each class (a class with no
    tile here: None, None)."""
    if occupancy is None or cfg.n_occ_bins <= 0 or cfg.occ_ray_tile <= 0:
        raise ValueError("budgeted rendering needs the tile-shared "
                         "occupancy sampling path")
    if cfg.ndc:
        raise ValueError(NDC_OCCUPANCY)
    tile = cfg.occ_ray_tile
    r = rays_o.shape[0]
    if r % tile:
        raise ValueError(f"batch of {r} rays must divide by tile {tile}")
    n_tiles = r // tile
    k_dense = k_dense_of(dense_frac, n_tiles)
    draws = draws or {}
    viewdirs = _viewdirs(rays_d, cfg)
    near, far = ray_math.intersect_aabb(rays_o, rays_d, bounding_box)
    edges_t, w_t, mass = tiled_prior(
        occupancy, rays_o, rays_d, near[:, None], far[:, None], bounding_box,
        cfg.n_occ_bins, cfg.occ_uniform_frac, tile)
    order = torch.argsort(-mass, stable=True)           # dense tiles first
    lanes = torch.arange(tile, device=rays_o.device)

    def class_render(tiles, n_samples, dr, gen):
        tiles, ridx, gen = _class_rows(tiles, tile, shard, gen, lanes)
        if tiles is None:
            return None, None
        z_t = S.sample_pdf(edges_t[tiles], w_t[tiles], n_samples,
                           det=(cfg.perturb == 0.0), generator=gen,
                           draws=dr.get("pdf_draws"))
        ccfg = dataclasses.replace(cfg, n_samples=n_samples)
        res = render_rays(
            network_fn, integrate_fn, rays_o[ridx], rays_d[ridx],
            near[ridx][:, None], far[ridx][:, None],
            viewdirs[ridx] if viewdirs is not None else None,
            None if cfg.thin_ray else cone_angle, ccfg, gen,
            bounding_box, z_t.repeat_interleave(tile, dim=0), raw_noise_std,
            sp_alpha, dr)
        return res, ridx

    res_d, idx_d = class_render(order[:k_dense], cfg.n_samples,
                                draws.get("dense", {}), S.fork(generator, 1))
    res_s, idx_s = class_render(order[k_dense:], sparse_samples,
                                draws.get("sparse", {}), S.fork(generator, 2))
    return res_d, res_s, idx_d, idx_s


def render_ray_batch_hier_budgeted(network_fn, integrate_fn,
                                   rays_o: torch.Tensor,
                                   rays_d: torch.Tensor, cone_angle,
                                   cfg: RenderConfig,
                                   bounding_box: torch.Tensor,
                                   raw_noise_std: float = 0.0,
                                   sp_alpha: float = 0.0,
                                   dense_frac: float = 0.5,
                                   sparse_importance: int = 32,
                                   generator: Optional[torch.Generator] = None,
                                   draws: Optional[dict] = None,
                                   shard: Optional[TileShard] = None):
    """Two-class tile budget for the hierarchical fine pass: the coarse pass
    runs on every ray at cfg.n_samples with depths shared per
    cfg.hier_ray_tile rays; tiles are ranked by the tile-mean coarse weight
    mass (stable, so tied tiles keep their order), and the fine pass renders
    the top ``dense_frac`` at cfg.n_importance, the rest at
    ``sparse_importance``. ``draws``: optional ``scatter_u``, ``noise`` (the
    coarse pass) and {"dense": {...}, "sparse": {...}} with
    ``pdf_draws_fine``, ``sp_noise``, ``scatter_u_fine``, ``noise_fine``;
    otherwise the coarse pass draws from ``generator``, the dense class from
    ``fork(generator, 1)`` and the sparse one from ``fork(generator, 2)``.
    With a ``shard`` the coarse pass runs on the shard's tiles only, their
    weight masses are gathered (``shard.gather``) and ranked with every
    other rank's, and the shard's tiles render their fine pass in the class
    that ranking gives them, each with the draws a single device makes for
    it. Returns (res_dense, res_sparse, idx_dense, idx_sparse) (a class
    with no tile here: None, None)."""
    tile = cfg.hier_ray_tile
    if tile <= 0:
        raise ValueError("hier budget needs cfg.hier_ray_tile > 0")
    if cfg.n_importance <= 0:
        raise ValueError("hier budget needs n_importance > 0")
    if cfg.ndc:
        raise ValueError("hier budget does not support NDC rays (tile "
                         "near/far sharing happens in world space)")
    r = rays_o.shape[0]
    if r % tile:
        raise ValueError(f"batch of {r} rays must divide by tile {tile}")
    nt = r // tile
    k_dense = k_dense_of(dense_frac, nt)
    draws = draws or {}
    det = cfg.perturb == 0.0
    viewdirs = _viewdirs(rays_d, cfg)
    near, far = ray_math.intersect_aabb(rays_o, rays_d, bounding_box)
    if cone_angle is None or cfg.thin_ray:
        cone_angle = None
    # coarse pass on every ray here, tile-shared depths
    lo, hi = (0, nt) if shard is None else (shard.lo, shard.hi)
    if hi == lo:
        # more ranks than tiles: nothing renders here, but every rank takes
        # part in the ranking's all-gather
        shard.gather(rays_o.new_zeros((0,)), shard.counts)
        return None, None, None, None
    mine = slice(lo * tile, hi * tile)
    ntl = hi - lo
    gen_c = generator if shard is None else S.row_draws(generator, r, mine)
    ro, rd = rays_o[mine], rays_d[mine]
    vd = viewdirs[mine] if viewdirs is not None else None
    near_t = near[mine].reshape(ntl, tile).amin(dim=1, keepdim=True)
    far_t = far[mine].reshape(ntl, tile).amax(dim=1, keepdim=True)
    z_t = S.sample_z_vals(near_t, far_t, cfg.n_samples, cfg.lin_disp,
                          cfg.perturb,
                          _uniform((ntl, cfg.n_samples), gen_c,
                                   rays_o.device, det))          # [ntl, S]
    z_vals = z_t.repeat_interleave(tile, dim=0)
    pts = ro[:, None, :] + rd[:, None, :] * z_vals[..., None]
    pts = _scatter(pts, z_vals, cone_angle, rd, cfg, bounding_box,
                   gen_c, draws.get("scatter_u"))
    raw_c = network_fn(pts, vd)
    coarse = integrate_fn(raw_c, z_vals, rd, raw_noise_std,
                          _noise(raw_c, cfg, raw_noise_std, gen_c,
                                 draws.get("noise")))
    z_mids_t = 0.5 * (z_t[:, 1:] + z_t[:, :-1])
    w_t = coarse.weights[..., 1:-1].detach().reshape(ntl, tile, -1).mean(
        dim=1)                                                  # [ntl, S-2]
    mass = w_t.sum(dim=-1)
    if shard is not None:
        mass = shard.gather(mass, shard.counts)                  # [nt]
    order = torch.argsort(-mass, stable=True)
    lanes = torch.arange(tile, device=rays_o.device)

    def fine_class(tiles, n_imp, dr, gen):
        tiles, ridx, gen = _class_rows(tiles, tile, shard, gen, lanes)
        if tiles is None:
            return None, None
        own = tiles - lo                                  # rows of z_t, w_t
        lrow = (own[:, None] * tile + lanes).reshape(-1)
        z_samples = S.sample_pdf(
            z_mids_t[own], w_t[own], n_imp, det=det, generator=gen,
            draws=dr.get("pdf_draws_fine")).repeat_interleave(tile, dim=0)
        z_all, raw_f, out = _fine_pass(
            network_fn, integrate_fn, rays_o[ridx], rays_d[ridx],
            viewdirs[ridx] if viewdirs is not None else None, cone_angle,
            z_t[own].repeat_interleave(tile, dim=0), z_samples, cfg,
            bounding_box, raw_noise_std, sp_alpha, gen, dr)
        coarse_c = _map_fields(coarse, lambda f, x: x[lrow])
        return RenderResult(outputs=out, coarse=coarse_c,
                            raw=raw_f if cfg.return_raw else None,
                            z_vals=z_all), ridx

    res_d, idx_d = fine_class(order[:k_dense], cfg.n_importance,
                              draws.get("dense", {}), S.fork(generator, 1))
    res_s, idx_s = fine_class(order[k_dense:], sparse_importance,
                              draws.get("sparse", {}), S.fork(generator, 2))
    return res_d, res_s, idx_d, idx_s


def k_dense_of(dense_frac: float, n_tiles: int) -> int:
    """Dense-class tile count: round(frac * tiles), both classes non-empty.
    The executor's auto fraction relies on round-tripping through this."""
    return min(max(int(round(dense_frac * n_tiles)), 1), n_tiles - 1)


def _cheap_tile_probe(occupancy, rays_o, rays_d, near, far, bounding_box,
                      tile: int = 128, sub_r: int = 16, sub_b: int = 16):
    """Rank ray tiles with a subsampled probe (sub_r rays x sub_b bins per
    tile). Returns (edges_c [T*sub_r, sub_b+1], d_c [T*sub_r, sub_b],
    mass [T], near_t [T], far_t [T])."""
    n = rays_o.shape[0]
    n_tiles = n // tile
    stride = tile // sub_r
    near_t = near.reshape(n_tiles, tile).amin(dim=1)
    far_t = far.reshape(n_tiles, tile).amax(dim=1)
    dev = rays_o.device
    sidx = (torch.arange(n_tiles, device=dev)[:, None] * tile
            + torch.arange(0, tile, stride, device=dev)[None, :]).reshape(-1)
    edges_c, d_c = ray_bin_densities(
        occupancy, rays_o[sidx], rays_d[sidx],
        near_t.repeat_interleave(sub_r)[:, None],
        far_t.repeat_interleave(sub_r)[:, None], bounding_box, sub_b)
    mass = d_c.reshape(n_tiles, sub_r, sub_b).sum(dim=(1, 2))
    return edges_c, d_c, mass, near_t, far_t


def _tile_flatten(x: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """[hp, wp, C] -> [hp*wp, C] enumerated 8x16 tile by tile."""
    c = x.shape[-1]
    return (x.reshape(hp // TILE_H, TILE_H, wp // TILE_W, TILE_W, c)
            .permute(0, 2, 1, 3, 4).reshape(-1, c))


def probe_tile_mass(occupancy, h: int, w: int, k: torch.Tensor,
                    c2w: torch.Tensor, bounding_box: torch.Tensor):
    """Cheap occupancy mass per 8x16 tile of the tile-padded image: the
    ranking signal of render_image's budget path."""
    hp, wp = -(-h // TILE_H) * TILE_H, -(-w // TILE_W) * TILE_W
    rays_o, rays_d, _ = ray_math.get_rays(hp, wp, k, c2w)
    rays_o = _tile_flatten(rays_o, hp, wp)
    rays_d = _tile_flatten(rays_d, hp, wp)
    near, far = ray_math.intersect_aabb(rays_o, rays_d, bounding_box)
    return _cheap_tile_probe(occupancy, rays_o, rays_d, near, far,
                             bounding_box)[2]


def render_image(network_fn, integrate_fn, h: int, w: int, k: torch.Tensor,
                 c2w: torch.Tensor, cfg: RenderConfig,
                 bounding_box: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 c2w_staticcam: Optional[torch.Tensor] = None,
                 occupancy=None, dense_frac: float = 0.0,
                 sparse_samples: int = 8, prior_bins: int = 0,
                 max_rays: int = 0):
    """Full-image render in fixed-size ray chunks.

    ``max_rays`` > 0 renders each chunk in parts of at most that many rays
    (whole tiles where the chunk shares depths per tile), to bound the
    memory of wide per-sample outputs (LeRF's [rays, samples, E]). Rays are
    independent and tiles stay whole, so without random draws (thin rays,
    no noise) the image is the same.

    With ``cfg.tile_order`` the image is padded to 8x16-tile multiples and
    enumerated tile by tile. ``dense_frac`` > 0 (with the occupancy grid and
    tile order) enables the two-class budget: the top dense_frac of the
    128-ray tiles by probe mass render at cfg.n_samples over a depth range
    narrowed to where the probe saw mass, the rest at ``sparse_samples``.

    With ``c2w_staticcam`` (and view directions) the rays start from that
    pose while the view directions come from ``c2w``. Under ``cfg.ndc`` the
    rays are projected with the true h, w and k[0, 0] (tile padding only
    appends pixels), and the per-ray cone angle the projection gives is
    flattened beside the rays, so each chunk takes its own angles.

    Returns (the integrator's outputs as [h, w, ...] maps, per-sample
    fields dropped, (near_min, far_max))."""
    hp = -(-h // TILE_H) * TILE_H if cfg.tile_order else h
    wp = -(-w // TILE_W) * TILE_W if cfg.tile_order else w

    def flatten_pixels(x):
        if not cfg.tile_order:
            return x.reshape(-1, x.shape[-1])
        return _tile_flatten(x, hp, wp)

    rays_o, rays_d, cone_angle = ray_math.get_rays(hp, wp, k, c2w)
    viewdirs = None
    if cfg.use_viewdirs:
        vd_src = rays_d
        if c2w_staticcam is not None:
            rays_o, rays_d, cone_angle = ray_math.get_rays(hp, wp, k,
                                                           c2w_staticcam)
        viewdirs = flatten_pixels(_viewdirs(vd_src, cfg))
    if cfg.ndc:
        if occupancy is not None and cfg.n_occ_bins > 0:
            raise ValueError(NDC_OCCUPANCY)
        rays_o, rays_d, cone_angle = ray_math.ndc_rays(
            h, w, float(k[0, 0]), 1.0, rays_o, rays_d,
            None if cfg.thin_ray else cone_angle)
    rays_o = flatten_pixels(rays_o)
    rays_d = flatten_pixels(rays_d)
    # NDC gives a cone angle per ray ([hp, wp, 1]): flattened like the rays
    ray_cone = (flatten_pixels(cone_angle) if cfg.ndc and not cfg.thin_ray
                else None)
    near, far = ray_math.intersect_aabb(rays_o, rays_d, bounding_box)
    n = hp * wp
    use_occ = occupancy is not None and cfg.n_occ_bins > 0

    def render_flat(ro, rd, nr, fr, vd, ccfg, z_all=None, ca=None):
        """The chunk loop over a flat ray set; z_all [m, S] are precomputed
        depths (budget path) or None (occupancy prior per chunk); ca [m, 1]
        are per-ray cone angles (NDC) or None (the view's one angle)."""
        m = ro.shape[0]
        ch = min(ccfg.chunk, m)
        # The JAX package pads every chunk to ch rays, and render_rays shares
        # depths per tile (occupancy or hierarchical) only where its batch
        # divides into tiles: so all chunks are tiled, or none. Rays are
        # otherwise independent, so the last chunk is padded to whole tiles
        # only, and per ray where ch does not divide.
        tile = 0
        if z_all is None:
            tile = ccfg.occ_ray_tile if use_occ else ccfg.hier_ray_tile
        if tile > 0 and ch % tile:
            ccfg = dataclasses.replace(ccfg, occ_ray_tile=0, hier_ray_tile=0)
            tile = 0
        if 0 < max_rays < ch:
            ch = max(max_rays // tile, 1) * tile if tile else max_rays
        outs = []
        for c0 in range(0, m, ch):
            sl = slice(c0, c0 + ch)
            ro_c, rd_c, nr_c, fr_c = ro[sl], rd[sl], nr[sl], fr[sl]
            vd_c = vd[sl] if vd is not None else None
            ca_c = ca[sl] if ca is not None else cone_angle
            real = ro_c.shape[0]
            pad = -real % tile if tile else 0
            if pad:
                ro_c, rd_c, nr_c, fr_c = (_pad0(x, pad) for x in
                                          (ro_c, rd_c, nr_c, fr_c))
                vd_c = _pad0(vd_c, pad) if vd_c is not None else None
                ca_c = _pad0(ca_c, pad) if ca is not None else ca_c
            if z_all is not None:
                occ_bins = z_all[sl]
            elif use_occ:
                occ_bins = _occ_bins_or_z(occupancy, ro_c, rd_c, nr_c, fr_c,
                                          bounding_box, ccfg, generator)
            else:
                occ_bins = None
            res = render_rays(network_fn, integrate_fn, ro_c, rd_c, nr_c,
                              fr_c, vd_c, None if ccfg.thin_ray else ca_c,
                              ccfg, generator, bounding_box, occ_bins)
            # per-sample fields go chunk by chunk, so at most one chunk's
            # samples (LeRF: [ch, S, E]) live at a time
            outs.append(_map_fields(
                res.outputs, lambda f, x: None if f in PER_SAMPLE
                else x[:real]))
            del res
        first = outs[0]
        return type(first)(*(None if xs[0] is None else torch.cat(xs)
                             for xs in zip(*outs)))

    use_budget = (dense_frac > 0.0 and use_occ and cfg.tile_order
                  and n % 128 == 0 and n // 128 >= 2)
    if use_budget:
        tile = 128
        n_tiles = n // tile
        k_dense = k_dense_of(dense_frac, n_tiles)
        edges_c, d_c, mass, near_t, far_t = _cheap_tile_probe(
            occupancy, rays_o, rays_d, near, far, bounding_box)
        sub_r, sub_b = d_c.shape[0] // n_tiles, d_c.shape[1]
        # stable, as JAX's argsort: empty tiles tie at mass 0
        order = torch.argsort(-mass, stable=True)
        lanes = torch.arange(tile, device=rays_o.device)

        def render_class(tiles, n_s, edges_t, w_t):
            ridx = (tiles[:, None] * tile + lanes).reshape(-1)
            z_t = S.sample_pdf(edges_t, w_t, n_s, det=True)
            z = z_t.repeat_interleave(tile, dim=0)
            ccfg = dataclasses.replace(cfg, n_samples=n_s)
            out = render_flat(rays_o[ridx], rays_d[ridx],
                              near[ridx][:, None], far[ridx][:, None],
                              viewdirs[ridx] if viewdirs is not None else None,
                              ccfg, z_all=z)
            return out, ridx

        # dense class: full prior over the depth span where the probe saw
        # mass (a probe bin counts above 2% of its tile's peak), +1 bin
        dtiles = order[:k_dense]
        dray = (dtiles[:, None] * tile + lanes).reshape(-1)
        pb = abs(prior_bins) if prior_bins != 0 else cfg.n_occ_bins
        narrow = prior_bins >= 0
        bm = d_c.reshape(n_tiles, sub_r, sub_b).amax(dim=1)          # [T, B]
        occ_bin = bm > 0.02 * bm.amax(dim=1, keepdim=True)
        any_occ = occ_bin.any(dim=1)
        bi = torch.arange(sub_b, device=bm.device)
        lo = torch.where(occ_bin, bi, sub_b).amin(dim=1) - 1
        hi = torch.where(occ_bin, bi, -1).amax(dim=1) + 2
        lo = torch.clamp(lo, 0, sub_b)
        hi = torch.clamp(hi, 0, sub_b)
        edges_tile = edges_c.reshape(n_tiles, sub_r, -1)[:, 0, :]  # [T, B+1]
        narrow_ok = any_occ if narrow else torch.zeros_like(any_occ)
        near_n = torch.where(narrow_ok, torch.gather(
            edges_tile, 1, lo[:, None])[:, 0], near_t)
        far_n = torch.where(narrow_ok, torch.gather(
            edges_tile, 1, hi[:, None])[:, 0], far_t)
        edges_d, w_d, _ = tiled_prior(
            occupancy, rays_o[dray], rays_d[dray],
            near_n[dtiles].repeat_interleave(tile)[:, None],
            far_n[dtiles].repeat_interleave(tile)[:, None], bounding_box, pb,
            cfg.occ_uniform_frac, tile)
        out_d, idx_d = render_class(dtiles, cfg.n_samples, edges_d, w_d)
        # sparse class: prior from the cheap probe
        stiles = order[k_dense:]
        d_t = d_c.reshape(n_tiles, sub_r, sub_b).mean(dim=1)[stiles]
        pdf_s = d_t / torch.clamp(d_t.sum(dim=-1, keepdim=True), min=1e-8)
        w_s = ((1.0 - cfg.occ_uniform_frac) * pdf_s
               + cfg.occ_uniform_frac / sub_b)
        out_s, idx_s = render_class(stiles, sparse_samples, edges_tile[stiles],
                                    w_s)

        def combine(f, a, b):
            if a is None:             # per-sample (dropped) or unset
                return None
            buf = torch.zeros((n, *a.shape[1:]), dtype=a.dtype,
                              device=a.device)
            buf[idx_d] = a
            buf[idx_s] = b
            return buf

        outputs = type(out_d)(*(combine(f, getattr(out_d, f),
                                        getattr(out_s, f))
                                for f in out_d._fields))
    else:
        outputs = render_flat(rays_o, rays_d, near[:, None], far[:, None],
                              viewdirs, cfg, ca=ray_cone)

    def unshape(flat):
        rest = flat.shape[1:]
        if not cfg.tile_order:
            return flat.reshape(h, w, *rest)
        img = (flat.reshape(hp // TILE_H, wp // TILE_W, TILE_H, TILE_W, *rest)
               .permute(0, 2, 1, 3, *range(4, 4 + len(rest)))
               .reshape(hp, wp, *rest))
        return img[:h, :w]

    # per-sample fields would be huge image-wide: dropped, as in JAX;
    # unset fields (relevancy without prompts) stay None
    out = type(outputs)(*(
        torch.zeros((0,), dtype=torch.float32, device=rays_o.device)
        if f in PER_SAMPLE else None if v is None else unshape(v)
        for f, v in zip(outputs._fields, outputs)))
    return out, (near.min(), far.max())


def _map_fields(outputs: NamedTuple, fn) -> NamedTuple:
    """outputs with fn(field, value) applied to each field that is set."""
    return type(outputs)(*(None if v is None else fn(f, v)
                           for f, v in zip(outputs._fields, outputs)))


def _pad0(x: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
