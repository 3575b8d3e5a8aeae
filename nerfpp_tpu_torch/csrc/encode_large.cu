// Forward encode of the hash grid from an f32 table of any size, in the
// fixed, random and blocked schemes.
//
// Replaces the JAX package's XLA path, nerfpp_tpu/encoders/hashgrid.py:408
// gather_trilerp_reference after corner_indices (use_pallas_encoder=False;
// hashnerf_preset()'s 16 levels x 2^19 entries, a 64 MiB f32 table): for
// each point and level, the 8 corners of the point's cell
// (large_geometry.cuh), their f32 features read from the table in global
// memory and blended with f32 trilinear weights. Output [N, 2L] f32,
// level-major. Points are clamped to the box by the caller.
//
// Bound on the H100: bytes. Per point it reads 12 B of coordinates and
// writes 8L B of features; the table's touched 32-byte sectors are read
// at least once. At T = 2^19 the table is larger than the 50 MB L2, so
// the finest levels' gathers come mostly from HBM, 32 B for each 8 B
// entry.
//
// Design: the simple one. One thread per (point, level), consecutive
// threads on consecutive levels of one point, so that a warp's feature
// stores are whole 128-byte lines and its coordinate loads are a few
// broadcasts. Each thread issues its 8 corner loads through the read-only
// path and blends them in registers; no shared memory, no staging.
#include <cuda_runtime.h>

#include "large_geometry.cuh"

#define EL_THREADS 256

template <int SCHEME>
__global__ void __launch_bounds__(EL_THREADS)
encode_large_kernel(const float2* __restrict__ table,   // [L * T]
                    const float* __restrict__ pts,      // [N, 3]
                    const float* __restrict__ geom,     // [L, 3]
                    const int* __restrict__ ints,       // [L, 3]
                    SmallGeom s, long long n, int n_levels, int level_size,
                    float2* __restrict__ out) {         // [N * L]
    const long long t = (long long)blockIdx.x * EL_THREADS + threadIdx.x;
    if (t >= n * n_levels) return;
    const long long p = t / n_levels;
    const int l = (int)(t - p * n_levels);
    const float x0 = __ldg(pts + 3 * p);
    const float x1 = __ldg(pts + 3 * p + 1);
    const float x2 = __ldg(pts + 3 * p + 2);
    unsigned idx[8];
    float w[8];
    large_cell<SCHEME>(x0, x1, x2, l, geom, ints, s, level_size, idx, w);
    const float2* tab = table + (long long)l * level_size;
    float2 v[8];
    #pragma unroll
    for (int d = 0; d < 8; ++d) v[d] = __ldg(tab + idx[d]);
    float a0 = 0.0f, a1 = 0.0f;
    #pragma unroll
    for (int d = 0; d < 8; ++d) {
        a0 = fmaf(w[d], v[d].x, a0);
        a1 = fmaf(w[d], v[d].y, a1);
    }
    out[t] = make_float2(a0, a1);
}

template <int SCHEME>
static int encode_large_go(const float2* table, const float* pts,
                           const float* geom, const int* ints, SmallGeom s,
                           long long n, int n_levels, int level_size,
                           float2* out, cudaStream_t st) {
    const long long blocks = (n * n_levels + EL_THREADS - 1) / EL_THREADS;
    encode_large_kernel<SCHEME><<<(unsigned)blocks, EL_THREADS, 0, st>>>(
        table, pts, geom, ints, s, n, n_levels, level_size, out);
    return (int)cudaGetLastError();
}

// scheme: 0 fixed, 1 random, 2 blocked; level_size a power of two (>= 128
// for the blocked scheme); n > 0
extern "C" int encode_large_launch(const float* table, const float* pts,
                                   const float* geom, const int* ints,
                                   float bx, float by, float bz, float ix,
                                   float iy, float iz, long long n,
                                   int n_levels, int level_size, int scheme,
                                   float* out, void* stream) {
    const SmallGeom s{bx, by, bz, ix, iy, iz};
    const float2* tab = reinterpret_cast<const float2*>(table);
    float2* o = reinterpret_cast<float2*>(out);
    cudaStream_t st = (cudaStream_t)stream;
    if (n < 1 || n_levels < 1 || level_size < 1
        || (level_size & (level_size - 1)) != 0)
        return (int)cudaErrorInvalidValue;
    switch (scheme) {
    case 0:
        return encode_large_go<0>(tab, pts, geom, ints, s, n, n_levels,
                                  level_size, o, st);
    case 1:
        return encode_large_go<1>(tab, pts, geom, ints, s, n, n_levels,
                                  level_size, o, st);
    case 2:
        if (level_size < NERF_LANES) return (int)cudaErrorInvalidValue;
        return encode_large_go<2>(tab, pts, geom, ints, s, n, n_levels,
                                  level_size, o, st);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
