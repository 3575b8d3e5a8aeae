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
// Bound on the H100: bytes, 0.0113 ms on a train step's dense fine class
// (262,144 points, 16 levels, T = 2^13): 12 B of coordinates and 8L B of
// cotangent a point read, the 1 MB gradient written once. What limits the
// kernel is the scatter: 16 float adds a point and level onto L * T
// entries, 67 M at that shape, before the merge below.
//
// Design: the adds land in shared memory, not in L2. A level's entries are
// cut into ranges of at most GS_RANGE (16,384) entries, 128 KB of float2;
// at T = 2^13 a range is the whole level (64 KB). A (level, range) has
// GS_BLOCKS (16) blocks of GS_THREADS; block b adds the corners of the b-th
// slice of the points into its private copy of the range (corners outside
// the range are dropped, so larger tables need no second code path), then
// adds its copy, 16 bytes at a time and skipping zeros, into the
// zero-filled output by global atomics. The card has no shared-memory
// float add: a float atomicAdd there compiles to a compare-and-swap loop
// (ATOMS.CAST.SPIN), and that loop is what the kernel's time is made of.
// So a warp first merges what it can: where >= GS_MERGE_MIN (4) of its
// lanes hold a point in the same cell as the lane before (ray-major
// samples at the coarse levels), each run of such lanes sums its 16
// products by a segmented shuffle scan and only its first lane adds. A
// thread-block cluster summing a level's copies in distributed shared
// memory (no zero-fill, no global atomic) measured slower: a level's
// blocks all wait for its slowest, and the levels' work differs (PERF.md).
// The cell and hash arithmetic is the forward's (small_geometry.cuh), so
// every point scatters into the entries its features came from. The order
// of the adds varies between runs, so sums are not bitwise reproducible.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (profile_kernels.py,
// this design against the one thread a point with warp-merged float2
// global atomics before it, in one run; PERF.md): 0.2229 / 0.2227 ms
// against 0.2364 / 0.2368 on the dense fine class (random scheme; the
// fixed scheme's 0.2313 / 0.2312 against 0.2238 / 0.2235 is slower), 1.0026
// against 1.5263 on 2^20 random points, 1.2954 against 1.5328 at T = 2^15.
#include <cuda_runtime.h>

#include "small_geometry.cuh"

#define GS_THREADS 1024
#define GS_RANGE 16384              // entries of one block's private copy
#define GS_BLOCKS 16                // blocks of a (level, range)
#define GS_MERGE_MIN 4              // lanes in runs that turn the merge on
#define GS_FULL_MASK 0xFFFFFFFFu

// A lane whose point lies in the same cell as the lane before it continues
// that lane's run; lanes past the slice never do. Where the warp holds
// GS_MERGE_MIN such lanes, each run's first lane gathers the run's 16
// products by a segmented suffix sum (Hillis-Steele: distance k while some
// run is longer than k). Returns whether this lane adds.
__device__ __forceinline__ bool gs_merge_runs(float v[16],
                                              unsigned long long cell_key,
                                              bool valid, int lane) {
    const unsigned long long key = valid ? cell_key : ~0ull - lane;
    const unsigned long long up = __shfl_up_sync(GS_FULL_MASK, key, 1);
    const bool cont = lane > 0 && key == up;
    unsigned x = __ballot_sync(GS_FULL_MASK, cont);
    if (__popc(x) < GS_MERGE_MIN) return valid;
    // x: bit j set iff lanes j .. j + k - 1 all continue
    for (int k = 1; k < 32 && x != 0u; k <<= 1) {
        const bool take = lane + k < 32 && ((x >> lane) & 2u) != 0u;
        #pragma unroll
        for (int q = 0; q < 16; ++q) {
            const float o = __shfl_down_sync(GS_FULL_MASK, v[q], k);
            if (take) v[q] += o;
        }
        x &= x >> k;
    }
    return valid && !cont;
}

template <int SCHEME>
__global__ void __launch_bounds__(GS_THREADS)
grad_small_kernel(const float* __restrict__ g,        // [N, 2L]
                  const float* __restrict__ pts,      // [N, 3]
                  const float* __restrict__ geom,     // [L, 3]
                  const unsigned* __restrict__ primes,  // [L, 3]
                  SmallGeom s, int n, int n_levels, int level_size,
                  int range,
                  float* __restrict__ grad) {         // [L * T, 2]
    extern __shared__ float4 acc4[];                  // [range / 2]
    float* acc = reinterpret_cast<float*>(acc4);
    const int b = blockIdx.x;
    const int r0 = blockIdx.y * range;
    const int l = blockIdx.z;
    const int rn = min(range, level_size - r0);       // entries, % 1024 == 0
    const int t = threadIdx.x;
    const int lane = t & 31;
    for (int i = t; i < rn / 2; i += GS_THREADS)
        acc4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncthreads();

    const long long per = ((long long)n + GS_BLOCKS - 1) / GS_BLOCKS;
    const long long p_begin = per * b;
    const long long p_end = min((long long)n, p_begin + per);
    const SmallLevel lv = small_level(l, geom, primes);
    const unsigned mask = (unsigned)level_size - 1u;
    const int row = 2 * n_levels;
    // warp-uniform steps: a warp's 32 consecutive points at a time
    for (long long p0 = p_begin + (t & ~31); p0 < p_end; p0 += GS_THREADS) {
        const long long p = p0 + lane;
        const bool valid = p < p_end;
        float x0 = s.bx, x1 = s.by, x2 = s.bz;
        float g0 = 0.0f, g1 = 0.0f;
        if (valid) {
            x0 = __ldg(pts + 3 * p);
            x1 = __ldg(pts + 3 * p + 1);
            x2 = __ldg(pts + 3 * p + 2);
            g0 = __ldg(g + p * row + 2 * l);
            g1 = __ldg(g + p * row + 2 * l + 1);
        }
        SmallCell c;
        small_cell_at<SCHEME>(x0, x1, x2, lv, s, mask, c);
        float v[16];
        #pragma unroll
        for (int d = 0; d < 8; ++d) {
            v[2 * d] = c.w[d] * g0;
            v[2 * d + 1] = c.w[d] * g1;
        }
        if (gs_merge_runs(v, c.key, valid, lane)) {
            #pragma unroll
            for (int d = 0; d < 8; ++d) {
                const unsigned e = c.idx[d] - (unsigned)r0;
                if (e < (unsigned)rn) {
                    atomicAdd(acc + 2 * e, v[2 * d]);
                    atomicAdd(acc + 2 * e + 1, v[2 * d + 1]);
                }
            }
        }
    }

    float4* out = reinterpret_cast<float4*>(
        grad + 2 * ((long long)l * level_size + r0));
    __syncthreads();
    for (int i = t; i < rn / 2; i += GS_THREADS) {
        const float4 o = acc4[i];
        if (o.x != 0.0f || o.y != 0.0f || o.z != 0.0f || o.w != 0.0f)
            atomicAdd(out + i, o);
    }
}

template <int SCHEME>
static int grad_small_go(const float* g, const float* pts, const float* geom,
                         const unsigned* primes, SmallGeom s, int n,
                         int n_levels, int level_size, float* grad,
                         cudaStream_t st) {
    auto kernel = grad_small_kernel<SCHEME>;
    const int range = level_size < GS_RANGE ? level_size : GS_RANGE;
    const size_t smem = sizeof(float2) * range;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(GS_BLOCKS, (level_size + range - 1) / range, n_levels);
    kernel<<<grid, GS_THREADS, smem, st>>>(g, pts, geom, primes, s, n,
                                           n_levels, level_size, range, grad);
    return (int)cudaGetLastError();
}

// scheme: 0 fixed, 1 random; grad must be zero-filled by the caller
extern "C" int grad_small_launch(const float* g, const float* pts,
                                 const float* geom, const int* primes,
                                 float bx, float by, float bz, float ix,
                                 float iy, float iz, int n, int n_levels,
                                 int level_size, int scheme, float* grad,
                                 void* stream) {
    const SmallGeom s{bx, by, bz, ix, iy, iz};
    const unsigned* pr = reinterpret_cast<const unsigned*>(primes);
    cudaStream_t st = (cudaStream_t)stream;
    if (level_size % 1024 != 0) return (int)cudaErrorInvalidValue;
    return scheme == 0
        ? grad_small_go<0>(g, pts, geom, pr, s, n, n_levels, level_size,
                           grad, st)
        : grad_small_go<1>(g, pts, geom, pr, s, n, n_levels, level_size,
                           grad, st);
}
