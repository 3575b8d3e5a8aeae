// Table gradient of the small-table hash encode, fixed and random schemes.
//
// Replaces the backward of nerfpp_tpu/encoders/hashgrid.py's custom VJP
// around kernel K4 (hashgrid.py:334-362), which the JAX package computes
// outside Pallas as a factorised bf16 one-hot MXU matmul
// (nerfpp_tpu/ops/scatter_matmul.py): for every point and level, each of the
// 8 hashed corners of the point's cell gets w_corner * g[n, l, f] added to
// its table entry. The result is the flat f32 gradient [L * T, 2]; weights
// and sums are f32 throughout.
//
// Bound on the H100: bytes. Per point it reads 12 B of coordinates and 8L B
// of cotangent; the gradient (L * T * 8 B, 1 MB at L = 16, T = 2^13) is
// written once. The arithmetic is a few dozen operations per point and
// level.
//
// Design: K3's (grad_blocked.cu). One block of 128 threads per 128 points,
// one point per thread, a loop over the levels. The block's cotangent rows
// are read once, coalesced, into shared memory with a row stride of 2L + 1
// words. The cell and hash arithmetic is the forward's
// (small_geometry.cuh), so every point scatters into the entries its
// features came from. Coarse levels collide heavily (level 0 has 17^3
// vertices for thousands of points), and 32 same-address atomics would
// serialise: so the lanes of a warp in the same cell (equal integer cell
// coordinates, __match_any_sync) first sum their 16 products in a shuffle
// tree, and only the group's lowest lane issues the 8 float2 atomicAdds.
// Atomic order varies between runs, so sums are not bitwise reproducible.
#include <cuda_runtime.h>

#include "small_geometry.cuh"

#define GS_THREADS 128
#define GS_FULL_MASK 0xFFFFFFFFu

template <int SCHEME>
__global__ void __launch_bounds__(GS_THREADS)
grad_small_kernel(const float* __restrict__ g,        // [N, 2L]
                  const float* __restrict__ pts,      // [N, 3]
                  const float* __restrict__ geom,     // [L, 3]
                  const unsigned* __restrict__ primes,  // [L, 3]
                  SmallGeom s, int n, int n_levels, int level_size,
                  float* __restrict__ grad) {         // [L * T, 2]
    extern __shared__ float gs[];                     // [128, 2L + 1]
    const int t = threadIdx.x;
    const int lane = t & 31;
    const long long p0 = (long long)blockIdx.x * GS_THREADS;
    const int row = 2 * n_levels;
    const int stride = row + 1;
    const long long left = (long long)n - p0;
    const int rows = left < GS_THREADS ? (int)left : GS_THREADS;
    for (int i = t; i < GS_THREADS * row; i += GS_THREADS) {
        const int r = i / row;
        gs[r * stride + (i - r * row)] = r < rows ? g[p0 * row + i] : 0.0f;
    }
    __syncthreads();

    const bool valid = t < rows;
    const float* p = pts + (p0 + t) * 3;
    const float x0 = valid ? p[0] : s.bx;
    const float x1 = valid ? p[1] : s.by;
    const float x2 = valid ? p[2] : s.bz;
    const unsigned mask = (unsigned)level_size - 1u;
    const unsigned below = (1u << lane) - 1u;
    for (int l = 0; l < n_levels; ++l) {
        SmallCell c;
        small_cell<SCHEME>(x0, x1, x2, l, geom, primes, s, mask, c);
        const float g0 = gs[t * stride + 2 * l];
        const float g1 = gs[t * stride + 2 * l + 1];
        float v[16];
        #pragma unroll
        for (int d = 0; d < 8; ++d) {
            v[2 * d] = c.w[d] * g0;
            v[2 * d + 1] = c.w[d] * g1;
        }

        // sum over the lanes in the same cell into the lowest of them: each
        // round, every lane adds the next remaining peer above it, then the
        // odd ranks drop out (log2 of the group size rounds). Lanes past n
        // form their own group and never write.
        const unsigned long long key = valid ? c.key : ~0ull;
        const unsigned peers = __match_any_sync(GS_FULL_MASK, key);
        int rank = __popc(peers & below);
        unsigned rest = peers & ~(below | (1u << lane));
        while (__any_sync(GS_FULL_MASK, rest != 0u)) {
            const int next = __ffs(rest) - 1;
            #pragma unroll
            for (int k = 0; k < 16; ++k) {
                const float o = __shfl_sync(GS_FULL_MASK, v[k], next & 31);
                if (next >= 0) v[k] += o;
            }
            rest &= __ballot_sync(GS_FULL_MASK, (rank & 1) == 0);
            rank >>= 1;
        }
        if (valid && (peers & below) == 0u) {
            float2* out = reinterpret_cast<float2*>(grad)
                          + (size_t)l * level_size;
            #pragma unroll
            for (int d = 0; d < 8; ++d)
                atomicAdd(out + c.idx[d], make_float2(v[2 * d], v[2 * d + 1]));
        }
    }
}

// scheme: 0 fixed, 1 random. grad must be zero-filled by the caller.
extern "C" int grad_small_launch(const float* g, const float* pts,
                                 const float* geom, const int* primes,
                                 float bx, float by, float bz, float ix,
                                 float iy, float iz, int n, int n_levels,
                                 int level_size, int scheme, float* grad,
                                 void* stream) {
    const SmallGeom s{bx, by, bz, ix, iy, iz};
    const unsigned* pr = reinterpret_cast<const unsigned*>(primes);
    const size_t smem = sizeof(float) * GS_THREADS * (2 * n_levels + 1);
    const int blocks = (int)(((long long)n + GS_THREADS - 1) / GS_THREADS);
    cudaStream_t st = (cudaStream_t)stream;
    if (scheme == 0)
        grad_small_kernel<0><<<blocks, GS_THREADS, smem, st>>>(
            g, pts, geom, pr, s, n, n_levels, level_size, grad);
    else
        grad_small_kernel<1><<<blocks, GS_THREADS, smem, st>>>(
            g, pts, geom, pr, s, n, n_levels, level_size, grad);
    return (int)cudaGetLastError();
}
