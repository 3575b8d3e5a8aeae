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
// at least once (0.3622 ms at the serving chunk, 8,388,608 points). At
// T = 2^19 the table is larger than the 50 MB L2, so what costs is the
// number of distinct lines a warp's gather touches and how many of them
// miss L2.
//
// Design: level-major warps in L2-resident level groups. A block serves
// one group of EL_GROUP (4) consecutive levels for 1,024 consecutive points
// (4 rays of a 256-sample serving chunk), a thread one point; the grid is
// group-major, so the card's resident blocks all read one group's 4
// tables (16 MiB at T = 2^19, within L2) while every point of the launch
// passes through them, not the whole table at once. Each of a warp's 8
// gathers of a level covers 32 consecutive points of that level: samples
// that share a cell share its lines, and one load serves them; the
// block's neighbouring rays share lines in L1. A point's 4 levels are 32
// bytes of its output row, stored as two 16-byte stores: whole sectors (a
// group of fewer levels, or a row not 16-byte aligned, stores each level's
// pair). The former design, one thread a (point, level) with a point's 16
// levels on consecutive threads, touched 16 level tables in every gather.
// At the serving chunk's fine levels each corner is a sector of its own
// either way, so the gain there is L1 reuse across the block's rays:
// blocks of 256 or 512 points were slower there (PERF.md).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (profile_kernels.py
// --parent, this design against the former one in one run; PERF.md):
// 3.9656 ms at the serving chunk against 4.9133 (random scheme; fixed
// 2.6475 against 3.2243), 1.0873 against 2.0963 on 2^20 random points,
// 0.2370 against 0.3994 on a train step's coarse pass, 0.1761 against
// 0.2218 on its dense fine class; the mean distinct table lines of a
// warp's gather at the serving chunk 20.007 against 25.696
// (chip_smoke.py).
#include <cuda_runtime.h>

#include "large_geometry.cuh"

#define EL_THREADS 1024            // 4 rays of 256 samples, one SM
#define EL_GROUP 4                  // levels of a block: 32 bytes of a row

template <int SCHEME>
__global__ void __launch_bounds__(EL_THREADS)
encode_large_kernel(const float2* __restrict__ table,   // [L * T]
                    const float* __restrict__ pts,      // [N, 3]
                    const float* __restrict__ geom,     // [L, 3]
                    const int* __restrict__ ints,       // [L, 3]
                    SmallGeom s, long long n, int n_levels, int level_size,
                    long long n_tiles,
                    float2* __restrict__ out) {         // [N * L]
    const long long b = blockIdx.x;
    const int grp = (int)(b / n_tiles);
    const long long p = (b - grp * n_tiles) * EL_THREADS + threadIdx.x;
    if (p >= n) return;
    const int l0 = grp * EL_GROUP;
    const int nlv = min(EL_GROUP, n_levels - l0);
    const float x0 = __ldg(pts + 3 * p);
    const float x1 = __ldg(pts + 3 * p + 1);
    const float x2 = __ldg(pts + 3 * p + 2);
    // the group's levels in turn; a level past the last gathers its first
    // corner's entry with weight 0
    float2 o[EL_GROUP];
    #pragma unroll
    for (int k = 0; k < EL_GROUP; ++k) {
        const int l = l0 + min(k, nlv - 1);
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
            const float wd = k < nlv ? w[d] : 0.0f;
            a0 = fmaf(wd, v[d].x, a0);
            a1 = fmaf(wd, v[d].y, a1);
        }
        o[k] = make_float2(a0, a1);
    }
    const long long at = p * n_levels + l0;
    if (nlv == EL_GROUP && (at & 1) == 0) {
        float4* q = reinterpret_cast<float4*>(out + at);
        q[0] = make_float4(o[0].x, o[0].y, o[1].x, o[1].y);
        q[1] = make_float4(o[2].x, o[2].y, o[3].x, o[3].y);
    } else {
        #pragma unroll
        for (int k = 0; k < EL_GROUP; ++k)
            if (k < nlv) out[at + k] = o[k];
    }
}

template <int SCHEME>
static int encode_large_go(const float2* table, const float* pts,
                           const float* geom, const int* ints, SmallGeom s,
                           long long n, int n_levels, int level_size,
                           float2* out, cudaStream_t st) {
    const long long tiles = (n + EL_THREADS - 1) / EL_THREADS;
    const long long groups = (n_levels + EL_GROUP - 1) / EL_GROUP;
    if (tiles * groups > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    encode_large_kernel<SCHEME><<<(unsigned)(tiles * groups), EL_THREADS, 0,
                                  st>>>(
        table, pts, geom, ints, s, n, n_levels, level_size, tiles, out);
    return (int)cudaGetLastError();
}

// scheme: 0 fixed, 1 random, 2 blocked; level_size a power of two (>= 128
// for the blocked scheme); n > 0; out 16-byte aligned
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
