// Table gradient of the blocked hash encode (kernel K3).
//
// Replaces nerfpp_tpu/pallas/hash_encode_blocked.py:_make_bwd_kernel (called
// by _bwd_call, entry grad_prepared): for every point and level, each of the
// 8 corners of the point's cell gets w_corner * g[n, l, f] added to its table
// entry. The result is the flat f32 gradient [L * 2^T, 2]; lanes 125-127 of
// every 128-lane row are never touched and stay at the wrapper's zero fill.
// The TPU kernel's window-interleaved slab and its bf16 pattern matmul are
// artefacts of the MXU: here the weights and sums are f32 throughout.
//
// Bound on the H100: bytes. Per point it reads 12 B of coordinates and 8L B
// of cotangent; the 67.1 MB gradient (L = 16, T = 2^19) is written once. The
// arithmetic is a few dozen operations per point and level.
//
// Design: one block of 128 threads per 128-point group, one point per
// thread, a loop over the levels. The group's cotangent rows (8L B per point)
// are read once, coalesced, into shared memory with a row stride of 2L + 1
// words, so the per-level column reads hit 32 different banks. The cell,
// fraction and row arithmetic is K2's (blocked_geometry.cuh), so K3 puts
// every point in the cell the forward used. Tile-ordered rays at one depth
// fall into one or two cells of a coarse level, and 32 same-address atomics
// would serialise: so the lanes of a warp that share a cell (equal corner-0
// entry, __match_any_sync) first sum their 16 products in a shuffle tree, and
// only the group's lowest lane issues the 8 float2 atomicAdds (global float2
// atomics exist on compute capability 9.x). Distinct cells skip the tree.
// Atomic order varies between runs, so sums are not bitwise reproducible.
#include <cuda_runtime.h>

#include "blocked_geometry.cuh"

#define NERF_FULL_MASK 0xFFFFFFFFu

__global__ void __launch_bounds__(NERF_LANES)
grad_blocked_kernel(const float* __restrict__ g,        // [n_valid, 2L]
                    const float* __restrict__ pts,      // [NG * 128, 3]
                    const float* __restrict__ scales,   // [L]
                    const int* __restrict__ boffs,      // [L, 3]
                    float bx, float by, float bz,
                    float ix, float iy, float iz,
                    int n_valid, int n_levels, int s_rows,
                    float* __restrict__ grad) {         // [L * S * 128, 2]
    extern __shared__ float gs[];                       // [128, 2L + 1]
    const int t = threadIdx.x;
    const int lane = t & 31;
    const long long p0 = (long long)blockIdx.x * NERF_LANES;
    const int row = 2 * n_levels;
    const int stride = row + 1;
    const long long left = (long long)n_valid - p0;
    const int rows = left < NERF_LANES ? (int)(left > 0 ? left : 0)
                                       : NERF_LANES;
    for (int i = t; i < NERF_LANES * row; i += NERF_LANES) {
        const int r = i / row;
        gs[r * stride + (i - r * row)] = r < rows ? g[p0 * row + i] : 0.0f;
    }
    __syncthreads();

    // padded points (n >= n_valid) carry zero cotangent and never write
    const bool valid = t < rows;
    const float* p = pts + (p0 + t) * 3;
    const float x0 = p[0], x1 = p[1], x2 = p[2];
    const unsigned below = (1u << lane) - 1u;
    for (int l = 0; l < n_levels; ++l) {
        const float scale = scales[l];
        const float r0 = nerf_rel(x0, bx, ix, scale);
        const float r1 = nerf_rel(x1, by, iy, scale);
        const float r2 = nerf_rel(x2, bz, iz, scale);
        const float fl0 = floorf(r0), fl1 = floorf(r1), fl2 = floorf(r2);
        const int c0 = (int)fl0, c1 = (int)fl1, c2 = (int)fl2;
        const float f0 = __fsub_rn(r0, fl0);
        const float f1 = __fsub_rn(r1, fl1);
        const float f2 = __fsub_rn(r2, fl2);
        const int o0 = (c0 >> 2) + boffs[3 * l + 0];
        const int o1 = (c1 >> 2) + boffs[3 * l + 1];
        const int o2 = (c2 >> 2) + boffs[3 * l + 2];
        const unsigned slot = (nerf_spread10((unsigned)o0)
                               | (nerf_spread10((unsigned)o1) << 1)
                               | (nerf_spread10((unsigned)o2) << 2))
                              & ((unsigned)s_rows - 1u);
        const int base = (c0 & 3) * 25 + (c1 & 3) * 5 + (c2 & 3);
        const int e0 = (int)(((unsigned)l * (unsigned)s_rows + slot)
                             * NERF_LANES) + base;
        const float wx[2] = {1.0f - f0, f0};
        const float wy[2] = {1.0f - f1, f1};
        const float wz[2] = {1.0f - f2, f2};
        const float g0 = gs[t * stride + 2 * l];
        const float g1 = gs[t * stride + 2 * l + 1];
        float v[16];
        #pragma unroll
        for (int d = 0; d < 8; ++d) {
            const float w = wx[(d >> 2) & 1] * wy[(d >> 1) & 1] * wz[d & 1];
            v[2 * d] = w * g0;
            v[2 * d + 1] = w * g1;
        }

        // sum over the lanes in the same cell into the lowest of them: each
        // round, every lane adds the next remaining peer above it, then the
        // odd ranks drop out (log2 of the group size rounds)
        const int key = valid ? e0 : -1;
        const unsigned peers = __match_any_sync(NERF_FULL_MASK, key);
        int rank = __popc(peers & below);
        unsigned rest = peers & ~(below | (1u << lane));
        while (__any_sync(NERF_FULL_MASK, rest != 0u)) {
            const int next = __ffs(rest) - 1;
            #pragma unroll
            for (int k = 0; k < 16; ++k) {
                const float o = __shfl_sync(NERF_FULL_MASK, v[k], next & 31);
                if (next >= 0) v[k] += o;
            }
            rest &= __ballot_sync(NERF_FULL_MASK, (rank & 1) == 0);
            rank >>= 1;
        }
        if (valid && (peers & below) == 0u) {
            float2* out = reinterpret_cast<float2*>(grad) + e0;
            #pragma unroll
            for (int d = 0; d < 8; ++d) {
                const int off = ((d >> 2) & 1) * 25 + ((d >> 1) & 1) * 5
                                + (d & 1);
                atomicAdd(out + off, make_float2(v[2 * d], v[2 * d + 1]));
            }
        }
    }
}

extern "C" int grad_blocked_launch(const float* g, const float* pts,
                                   const float* scales, const int* boffs,
                                   float bx, float by, float bz, float ix,
                                   float iy, float iz, int n_groups,
                                   int n_valid, int n_levels, int s_rows,
                                   float* grad, void* stream) {
    const size_t smem = sizeof(float) * NERF_LANES * (2 * n_levels + 1);
    grad_blocked_kernel<<<n_groups, NERF_LANES, smem, (cudaStream_t)stream>>>(
        g, pts, scales, boffs, bx, by, bz, ix, iy, iz, n_valid, n_levels,
        s_rows, grad);
    return (int)cudaGetLastError();
}
