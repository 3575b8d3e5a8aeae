// Table gradient of the large-table hash encode (encode_large.cu), in the
// fixed, random and blocked schemes.
//
// Replaces the XLA scatter-add that autodiff makes of the JAX package's
// f32 gather (nerfpp_tpu/encoders/hashgrid.py:408 gather_trilerp_reference,
// use_pallas_encoder=False): for every point, level and corner, w_corner *
// g[n, l, f] is added to the corner's entry of the f32 gradient
// [L * T, 2]. Weights and products are f32 and match the plain version's
// (index_add_ over corner_indices) term for term; the sums are not.
//
// Bound on the H100: bytes. Per point it reads 12 B of coordinates and 8L
// B of cotangent; the gradient's touched 32-byte sectors are written. The
// caller zero-fills the whole gradient (64 MiB at 16 x 2^19) before the
// launch.
//
// Design: the simple one. One thread per (point, level), consecutive
// threads on consecutive levels of one point; each thread adds its 8
// products with native float2 global atomics (sm_90), which the L2
// performs. No warp aggregation: where many points share a cell (the
// coarse levels) their adds to one entry queue in the L2. The order of the
// adds varies between runs, so the sums are not bitwise reproducible.
#include <cuda_runtime.h>

#include "large_geometry.cuh"

#define GL_THREADS 256

template <int SCHEME>
__global__ void __launch_bounds__(GL_THREADS)
grad_large_kernel(const float2* __restrict__ g,        // [N * L]
                  const float* __restrict__ pts,       // [N, 3]
                  const float* __restrict__ geom,      // [L, 3]
                  const int* __restrict__ ints,        // [L, 3]
                  SmallGeom s, long long n, int n_levels, int level_size,
                  float2* __restrict__ grad) {         // [L * T]
    const long long t = (long long)blockIdx.x * GL_THREADS + threadIdx.x;
    if (t >= n * n_levels) return;
    const long long p = t / n_levels;
    const int l = (int)(t - p * n_levels);
    const float x0 = __ldg(pts + 3 * p);
    const float x1 = __ldg(pts + 3 * p + 1);
    const float x2 = __ldg(pts + 3 * p + 2);
    const float2 gv = __ldg(g + t);
    unsigned idx[8];
    float w[8];
    large_cell<SCHEME>(x0, x1, x2, l, geom, ints, s, level_size, idx, w);
    float2* dst = grad + (long long)l * level_size;
    #pragma unroll
    for (int d = 0; d < 8; ++d)
        atomicAdd(dst + idx[d], make_float2(__fmul_rn(w[d], gv.x),
                                            __fmul_rn(w[d], gv.y)));
}

template <int SCHEME>
static int grad_large_go(const float2* g, const float* pts,
                         const float* geom, const int* ints, SmallGeom s,
                         long long n, int n_levels, int level_size,
                         float2* grad, cudaStream_t st) {
    const long long blocks = (n * n_levels + GL_THREADS - 1) / GL_THREADS;
    grad_large_kernel<SCHEME><<<(unsigned)blocks, GL_THREADS, 0, st>>>(
        g, pts, geom, ints, s, n, n_levels, level_size, grad);
    return (int)cudaGetLastError();
}

// scheme: 0 fixed, 1 random, 2 blocked; level_size a power of two (>= 128
// for the blocked scheme); n > 0; grad zero-filled by the caller
extern "C" int grad_large_launch(const float* g, const float* pts,
                                 const float* geom, const int* ints,
                                 float bx, float by, float bz, float ix,
                                 float iy, float iz, long long n,
                                 int n_levels, int level_size, int scheme,
                                 float* grad, void* stream) {
    const SmallGeom s{bx, by, bz, ix, iy, iz};
    const float2* gg = reinterpret_cast<const float2*>(g);
    float2* o = reinterpret_cast<float2*>(grad);
    cudaStream_t st = (cudaStream_t)stream;
    if (n < 1 || n_levels < 1 || level_size < 1
        || (level_size & (level_size - 1)) != 0)
        return (int)cudaErrorInvalidValue;
    switch (scheme) {
    case 0:
        return grad_large_go<0>(gg, pts, geom, ints, s, n, n_levels,
                                level_size, o, st);
    case 1:
        return grad_large_go<1>(gg, pts, geom, ints, s, n, n_levels,
                                level_size, o, st);
    case 2:
        if (level_size < NERF_LANES) return (int)cudaErrorInvalidValue;
        return grad_large_go<2>(gg, pts, geom, ints, s, n, n_levels,
                                level_size, o, st);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
