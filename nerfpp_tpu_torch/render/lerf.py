"""LeRF rendering: language-embedding compositing and relevancy scoring
(port of nerfpp_tpu/render/lerf.py).

The generic renderer (render/renderer.py) runs the language field through a
LeRF network closure (no view directions; sigma_le zeroed outside the box)
and a LeRF integrator (the field's own density drives the weights; the
per-sample embeddings are composited and normalised; relevancy is scored
against prompt embeddings when they are set).

The composite is one batched product per ray, [1, S] x [S, E]: the
[rays, samples, E] product of weights and embeddings is never formed.

Relevancy: for each positive p, the minimum over negatives n of
sigmoid((e.p - e.n) / T) at T = 0.1, the pairwise softmax probability of the
positive against its most confusable negative.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from nerfpp_tpu_torch.core.integrate import (alpha_from_density, dists_from_z,
                                             weights_from_alpha)


class LeRFOutputs(NamedTuple):
    lang_embedding: torch.Tensor           # [n_rays, n_samples, E]
    rendered_lang_embedding: torch.Tensor  # [n_rays, E]
    disp: torch.Tensor                     # [n_rays]
    acc: torch.Tensor                      # [n_rays]
    weights: torch.Tensor                  # [n_rays, n_samples]
    depth: torch.Tensor                    # [n_rays]
    relevancy: Optional[torch.Tensor]      # [n_rays, n_positives] or None


def render_clip_embedding(embeds: torch.Tensor, weights: torch.Tensor,
                          normalize: bool = True) -> torch.Tensor:
    """sum_s w_s e_s per ray, normalised by rsqrt(sum(out^2) + 1e-12).
    embeds [..., S, E], weights [..., S] -> [..., E]."""
    lead, (s, e) = weights.shape[:-1], embeds.shape[-2:]
    out = torch.bmm(weights.reshape(-1, 1, s),
                    embeds.reshape(-1, s, e)).reshape(*lead, e)
    if normalize:
        out = out * torch.rsqrt(torch.sum(out * out, dim=-1, keepdim=True)
                                + 1e-12)
    return out


def relevancy(embedding: torch.Tensor, positives: torch.Tensor,
              negatives: torch.Tensor, temperature: float = 0.1
              ) -> torch.Tensor:
    """embedding [..., E] (unit norm), positives [P, E], negatives [N, E]
    -> [..., P] in [0, 1]."""
    pos_sim = embedding @ positives.T / temperature
    neg_sim = embedding @ negatives.T / temperature
    pair = torch.sigmoid(pos_sim[..., :, None] - neg_sim[..., None, :])
    return torch.amin(pair, dim=-1)


def make_lerf_network_fn(lang_embed_fn, lerf_field, sample_major: bool = False):
    """network_fn(pts [R, S, 3], viewdirs) -> raw [R, S, E + 1]: embed the
    points with the language hash grid, run the LeRF field, zero sigma_le
    where a point lies outside the box. View directions are ignored.
    ``sample_major``: flatten sample by sample (the blocked kernel's
    coherent order); the result is the same."""

    def network_fn(pts, viewdirs):
        del viewdirs
        n_rays, n_samples, _ = pts.shape
        flat = (pts.transpose(0, 1) if sample_major else pts).reshape(-1, 3)
        embedded, keep_mask = lang_embed_fn(flat)
        le, sigma = lerf_field.embed_and_density(embedded)
        if keep_mask is not None:
            sigma = torch.where(keep_mask, sigma, torch.zeros_like(sigma))
        raw = torch.cat([le, sigma[..., None]], dim=-1)
        if sample_major:
            return raw.reshape(n_samples, n_rays, -1).transpose(0, 1)
        return raw.reshape(n_rays, n_samples, -1)

    return network_fn


def make_lerf_integrate_fn(lang_embed_dim: int,
                           positives: Optional[torch.Tensor] = None,
                           negatives: Optional[torch.Tensor] = None,
                           use_raw_noise: bool = False,
                           density_activation: str = "relu"):
    """The LeRF integrator. ``density_activation`` must be the executor's:
    a LeRF integrator left on relu while the NeRF branch runs trunc_exp let
    the language field's density die at init (every acc 0, a constant
    relevancy map). ``noise`` is a standard-normal draw for the
    training-time density noise (used with ``use_raw_noise``)."""

    def integrate_fn(raw_le, z_vals, rays_d, raw_noise_std=0.0, noise=None):
        dists = dists_from_z(z_vals, rays_d)
        le = raw_le[..., :lang_embed_dim]
        density = raw_le[..., lang_embed_dim]
        if use_raw_noise and noise is not None:
            density = density + noise * raw_noise_std
        alpha = alpha_from_density(density, dists, density_activation)
        weights = weights_from_alpha(alpha)
        acc = torch.sum(weights, dim=-1)
        depth = torch.sum(weights * z_vals, dim=-1) / torch.clamp(acc,
                                                                  min=1e-10)
        disp = 1.0 / torch.clamp(depth, min=1e-10)
        rendered = render_clip_embedding(le, weights)
        rel = None
        if positives is not None and negatives is not None:
            rel = relevancy(rendered, positives, negatives)
        return LeRFOutputs(lang_embedding=le,
                           rendered_lang_embedding=rendered, disp=disp,
                           acc=acc, weights=weights, depth=depth,
                           relevancy=rel)

    return integrate_fn
