// Shared blocked-scheme geometry for the window-list prepass, the forward
// encode and the table gradient (nerfpp_tpu_torch/encoders/hashgrid.py holds
// the plain version), and the warp's 128-key sort of the prepass and the
// gradient's index.
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

// compare-exchange of two elements of one lane: a gets the smaller if asc
__device__ __forceinline__ void nerf_ce(int& a, int& b, bool asc) {
    const int lo = min(a, b), hi = max(a, b);
    a = asc ? lo : hi;
    b = asc ? hi : lo;
}

// the in-lane stages (distance 2 then 1) of a bitonic merge
__device__ __forceinline__ void nerf_lane_merge(int v[4], bool asc) {
    nerf_ce(v[0], v[2], asc);
    nerf_ce(v[1], v[3], asc);
    nerf_ce(v[0], v[1], asc);
    nerf_ce(v[2], v[3], asc);
}

// ascending bitonic sort of a warp's 128 keys, element i = 4 * lane + k;
// a size-s run sorts ascending iff (i & s) == 0
__device__ __forceinline__ void nerf_sort128(int v[4], int lane) {
    nerf_ce(v[0], v[1], true);
    nerf_ce(v[2], v[3], false);
    nerf_lane_merge(v, (lane & 1) == 0);
    #pragma unroll
    for (int s = 8; s <= NERF_LANES; s <<= 1) {
        const bool asc = (lane & (s >> 2)) == 0;
        #pragma unroll
        for (int d = s >> 3; d >= 1; d >>= 1) {         // lane distance j / 4
            const bool keep_min = ((lane & d) == 0) == asc;
            #pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int p = __shfl_xor_sync(0xFFFFFFFFu, v[k], d);
                v[k] = keep_min ? min(v[k], p) : max(v[k], p);
            }
        }
        nerf_lane_merge(v, asc);
    }
}
