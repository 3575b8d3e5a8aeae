// Shared blocked-scheme geometry for the window-list prepass and the forward
// encode (nerfpp_tpu_torch/encoders/hashgrid.py holds the plain version).
//
// The cell index is floor((x - min) * inv_ext * scale), in exactly that
// order with round-to-nearest intrinsics (no contraction, no fast math), so
// both kernels and the plain PyTorch version put every point in the same
// cell: at a block boundary the halo vertices are separate parameters, and a
// one-ulp disagreement would change the value, not just round it.
#pragma once

#define NERF_LANES 128
#define NERF_SENTINEL 0x7FFFFFFF

__device__ __forceinline__ unsigned nerf_spread10(unsigned v) {
    v &= 0x3FFu;
    v = (v | (v << 16)) & 0x30000FFu;
    v = (v | (v << 8)) & 0x300F00Fu;
    v = (v | (v << 4)) & 0x30C30C3u;
    v = (v | (v << 2)) & 0x9249249u;
    return v;
}

// rel = (x - min) * inv_ext * scale; the caller takes floor and frac from it
__device__ __forceinline__ float nerf_rel(float x, float bmin, float inv,
                                          float scale) {
    return __fmul_rn(__fmul_rn(__fsub_rn(x, bmin), inv), scale);
}
