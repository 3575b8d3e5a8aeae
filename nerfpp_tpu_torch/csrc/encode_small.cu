// Forward encode of the small-table hash grid, fixed and random schemes
// (kernels K4 and K5).
//
// Replaces nerfpp_tpu/pallas/hash_encode.py:_make_kernel_v2 (K4, called by
// _hash_encode_v2) and _make_kernel (K5, hash_encode_fused(version="v1")):
// for each point and level, hash the 8 corners of the point's cell and blend
// their features with f32 trilinear weights. Both TPU kernels compute this
// one function (K5 from the f32 table only); their lane and sublane gathers
// over 128-entry and 1,024-entry tiles exist because Mosaic can gather only
// within one vector register. Here a thread reads its 8 entries directly.
// The table is either bf16 pairs packed in 32 bits (feature 0 high,
// feature 1 low) or f32 pairs; weights and sums are f32.
//
// Bound on the H100: bytes. Per point it reads 12 B of coordinates and
// writes 8L B of features (128 B at L = 16); the table (L * T entries of 4 or
// 8 B, at most 4 MB) is read once per block from L2. The arithmetic is about
// a hundred operations per point and level.
//
// Design: 512 threads per block, 2 points per thread (1,024 points per
// block, coordinates kept in registers), a loop over the levels. Where one
// level's table fits in 64 KB (T = 2^13 packed is 32 KB) the block stages it
// in shared memory with 16-byte loads and the 8 gathers per point and level
// hit shared memory; each level's table is then read from L2 once per 1,024
// points. Larger levels (up to T = 2^19 at L = 1, which supports() admits)
// are gathered straight from device memory, where the whole table stays in
// the 50 MB L2. The block's output rows (2L floats per point, 2L + 1 apart
// against bank conflicts) collect in shared memory and leave as whole rows,
// coalesced, after the last level; a thread writing its 8 B per level into
// 128 B rows directly was 3.5x slower (6.3 against 1.8 ms at the serving
// chunk, H100 80GB HBM3 at 700 W). Above 19 levels the rows no longer fit
// the 160 KB tile and each level's pair is written directly.
#include <cuda_runtime.h>

#include "small_geometry.cuh"

#define ES_THREADS 512
#define ES_PPT 2
#define ES_STAGE_MAX (64 * 1024)    // largest level staged in shared memory
#define ES_TILE_MAX (160 * 1024)    // largest output tile

template <int SCHEME, bool PACKED, bool STAGED>
__global__ void __launch_bounds__(ES_THREADS)
encode_small_kernel(const void* __restrict__ table,   // [L*T] u32 | [L*T] f2
                    const float* __restrict__ pts,    // [N, 3]
                    const float* __restrict__ geom,   // [L, 3]
                    const unsigned* __restrict__ primes,  // [L, 3]
                    SmallGeom s, int n, int n_levels, int level_size,
                    int stage_bytes, int tile_stride,
                    float* __restrict__ out) {        // [N, 2L]
    // shared memory: [the staged level's table | the block's output rows,
    // 2L + 1 floats apart] (either part may be absent)
    extern __shared__ __align__(16) unsigned char stage[];
    float* otile = reinterpret_cast<float*>(stage + stage_bytes);
    const long long base = (long long)blockIdx.x * ES_THREADS * ES_PPT
                           + threadIdx.x;
    float px[ES_PPT], py[ES_PPT], pz[ES_PPT];
    #pragma unroll
    for (int k = 0; k < ES_PPT; ++k) {
        const long long i = base + (long long)k * ES_THREADS;
        const bool ok = i < n;
        px[k] = ok ? pts[3 * i] : s.bx;
        py[k] = ok ? pts[3 * i + 1] : s.by;
        pz[k] = ok ? pts[3 * i + 2] : s.bz;
    }
    const unsigned mask = (unsigned)level_size - 1u;
    const int words = PACKED ? level_size : 2 * level_size;  // 4 B words
    for (int l = 0; l < n_levels; ++l) {
        const unsigned* lvl = reinterpret_cast<const unsigned*>(table)
                              + (size_t)l * words;
        if (STAGED) {
            __syncthreads();                 // the previous level's readers
            const uint4* src = reinterpret_cast<const uint4*>(lvl);
            uint4* dst = reinterpret_cast<uint4*>(stage);
            for (int i = threadIdx.x; i < words / 4; i += ES_THREADS)
                dst[i] = src[i];
            __syncthreads();
            lvl = reinterpret_cast<const unsigned*>(stage);
        }
        #pragma unroll
        for (int k = 0; k < ES_PPT; ++k) {
            const long long i = base + (long long)k * ES_THREADS;
            if (i >= n) continue;
            SmallCell c;
            small_cell<SCHEME>(px[k], py[k], pz[k], l, geom, primes, s, mask,
                               c);
            float a0 = 0.0f, a1 = 0.0f;
            #pragma unroll
            for (int d = 0; d < 8; ++d) {
                float v0, v1;
                if (PACKED) {
                    const unsigned v = lvl[c.idx[d]];
                    v0 = __uint_as_float(v & 0xFFFF0000u);
                    v1 = __uint_as_float(v << 16);
                } else {
                    const float2 v =
                        reinterpret_cast<const float2*>(lvl)[c.idx[d]];
                    v0 = v.x;
                    v1 = v.y;
                }
                a0 = __fmaf_rn(c.w[d], v0, a0);
                a1 = __fmaf_rn(c.w[d], v1, a1);
            }
            if (tile_stride) {
                float* o = otile + (k * ES_THREADS + threadIdx.x)
                                   * tile_stride + 2 * l;
                o[0] = a0;
                o[1] = a1;
            } else {
                reinterpret_cast<float2*>(out + i * 2 * n_levels)[l] =
                    make_float2(a0, a1);
            }
        }
    }
    if (tile_stride) {
        // whole output rows, written coalesced
        __syncthreads();
        const int row = 2 * n_levels;
        const long long first = (long long)blockIdx.x * ES_THREADS * ES_PPT;
        const long long left = (long long)n - first;
        const int rows = left < ES_THREADS * ES_PPT ? (int)left
                                                    : ES_THREADS * ES_PPT;
        for (int j = threadIdx.x; j < rows * row; j += ES_THREADS) {
            const int r = j / row;
            out[first * row + j] = otile[r * tile_stride + (j - r * row)];
        }
    }
}

template <int SCHEME, bool PACKED, bool STAGED>
static int launch_one(const void* table, const float* pts, const float* geom,
                      const unsigned* primes, SmallGeom s, int n,
                      int n_levels, int level_size, float* out,
                      cudaStream_t stream) {
    auto kernel = encode_small_kernel<SCHEME, PACKED, STAGED>;
    const size_t stage = STAGED ? (size_t)level_size * (PACKED ? 4 : 8) : 0;
    const size_t tile = sizeof(float) * ES_THREADS * ES_PPT
                        * (2 * n_levels + 1);
    const bool tiled = tile <= ES_TILE_MAX;
    const size_t smem = stage + (tiled ? tile : 0);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const long long per_block = (long long)ES_THREADS * ES_PPT;
    const int blocks = (int)((n + per_block - 1) / per_block);
    kernel<<<blocks, ES_THREADS, smem, stream>>>(
        table, pts, geom, primes, s, n, n_levels, level_size, (int)stage,
        tiled ? 2 * n_levels + 1 : 0, out);
    return (int)cudaGetLastError();
}

template <int SCHEME>
static int launch_scheme(bool packed, bool staged, const void* table,
                         const float* pts, const float* geom,
                         const unsigned* primes, SmallGeom s, int n,
                         int n_levels, int level_size, float* out,
                         cudaStream_t st) {
    if (packed && staged)
        return launch_one<SCHEME, true, true>(table, pts, geom, primes, s, n,
                                              n_levels, level_size, out, st);
    if (packed)
        return launch_one<SCHEME, true, false>(table, pts, geom, primes, s, n,
                                               n_levels, level_size, out, st);
    if (staged)
        return launch_one<SCHEME, false, true>(table, pts, geom, primes, s, n,
                                               n_levels, level_size, out, st);
    return launch_one<SCHEME, false, false>(table, pts, geom, primes, s, n,
                                            n_levels, level_size, out, st);
}

// scheme: 0 fixed, 1 random; packed: table is [L*T] u32, else [L*T, 2] f32.
// The table must be 16-byte aligned and T a power of two, multiple of 1,024.
extern "C" int encode_small_launch(const void* table, const float* pts,
                                   const float* geom, const int* primes,
                                   float bx, float by, float bz, float ix,
                                   float iy, float iz, int n, int n_levels,
                                   int level_size, int scheme, int packed,
                                   float* out, void* stream) {
    const SmallGeom s{bx, by, bz, ix, iy, iz};
    const bool staged =
        (size_t)level_size * (packed ? 4 : 8) <= ES_STAGE_MAX;
    const unsigned* pr = reinterpret_cast<const unsigned*>(primes);
    cudaStream_t st = (cudaStream_t)stream;
    if (scheme == 0)
        return launch_scheme<0>(packed != 0, staged, table, pts, geom, pr, s,
                                n, n_levels, level_size, out, st);
    return launch_scheme<1>(packed != 0, staged, table, pts, geom, pr, s, n,
                            n_levels, level_size, out, st);
}
