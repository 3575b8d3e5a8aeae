// Forward encode of the blocked hash grid (kernel K2).
//
// Replaces nerfpp_tpu/pallas/hash_encode_blocked.py:_make_fwd_kernel (called
// by _fwd_call): for each point and level, the trilinear blend of the 8
// corners of its cell. All 8 corners lie in one 128-lane table row at lanes
// base + {0, 1, 5, 6, 25, 26, 30, 31}, base = u*25 + v*5 + w from the cell's
// position in its 4^3 block. The table is bf16 pairs packed in 32 bits
// (feature 0 high, feature 1 low); weights and sums are f32. (The Pallas
// kernel rounds each weight to bf16 in its MXU pattern matrix; this kernel
// keeps f32 weights, as the plain version does.)
//
// Bound on the H100: bytes. Per point and level it writes 8 B of features;
// per (group, level) it reads the window count and the unique window ids
// (4 B each, a few per group for tile-ordered points); per point it reads 12 B
// of coordinates; and it reads the touched 512 B rows of the 33.5 MB packed
// table. The arithmetic is a few dozen operations per point and level.
// Design: one block of 128 threads per
// (128-point group, level), one point per thread. The group's window list
// from the prepass (window_lists.cu) names the aligned 8-row windows its
// points touch; for each one the block stages the window's 8 rows (4 KB) in
// shared memory with 16-byte loads, and the threads whose window it is read
// their corners from there. Each touched row is read from device memory (or
// L2) once per group instead of once per point.
#include <cuda_runtime.h>

#include "blocked_geometry.cuh"

__global__ void __launch_bounds__(NERF_LANES)
encode_blocked_kernel(const int* __restrict__ table,    // [L * S * 128]
                      const float* __restrict__ pts,    // [NG * 128, 3]
                      const int* __restrict__ wids,     // [L, NG, 128]
                      const int* __restrict__ counts,   // [L, NG]
                      const float* __restrict__ scales, // [L]
                      const int* __restrict__ boffs,    // [L, 3]
                      float bx, float by, float bz,
                      float ix, float iy, float iz,
                      int n_groups, int n_levels, int s_rows,
                      float* __restrict__ out) {        // [NG * 128, 2L]
    __shared__ int4 win[8 * NERF_LANES / 4];            // 8 rows x 128 lanes
    __shared__ int ids[NERF_LANES];
    const int g = blockIdx.x;
    const int l = blockIdx.y;
    const int t = threadIdx.x;
    const float scale = scales[l];
    const float* p = pts + ((long long)g * NERF_LANES + t) * 3;

    const float r0 = nerf_rel(p[0], bx, ix, scale);
    const float r1 = nerf_rel(p[1], by, iy, scale);
    const float r2 = nerf_rel(p[2], bz, iz, scale);
    const float fl0 = floorf(r0), fl1 = floorf(r1), fl2 = floorf(r2);
    const int c0 = (int)fl0, c1 = (int)fl1, c2 = (int)fl2;
    const float f0 = __fsub_rn(r0, fl0);
    const float f1 = __fsub_rn(r1, fl1);
    const float f2 = __fsub_rn(r2, fl2);
    const int o0 = (c0 >> 2) + boffs[3 * l + 0];
    const int o1 = (c1 >> 2) + boffs[3 * l + 1];
    const int o2 = (c2 >> 2) + boffs[3 * l + 2];
    const int mq = (int)(nerf_spread10((unsigned)(o0 >> 1))
                         | (nerf_spread10((unsigned)(o1 >> 1)) << 1)
                         | (nerf_spread10((unsigned)(o2 >> 1)) << 2));
    const int rr = (o0 & 1) | ((o1 & 1) << 1) | ((o2 & 1) << 2);
    const int base = (c0 & 3) * 25 + (c1 & 3) * 5 + (c2 & 3);
    const float wx[2] = {1.0f - f0, f0};
    const float wy[2] = {1.0f - f1, f1};
    const float wz[2] = {1.0f - f2, f2};

    const long long gl = (long long)l * n_groups + g;
    const int cnt = counts[gl];
    if (t < cnt) ids[t] = wids[gl * NERF_LANES + t];    // the unique ids only
    __syncthreads();

    const int4* tab = reinterpret_cast<const int4*>(
        table + (long long)l * s_rows * NERF_LANES);
    const unsigned row_mask = (unsigned)s_rows - 1u;
    float acc0 = 0.0f;
    float acc1 = 0.0f;
    for (int j = 0; j < cnt; ++j) {
        const int m = ids[j];
        const unsigned ws = ((unsigned)m << 3) & row_mask;
        // 8 rows x 32 int4 = 256 16-byte loads, two per thread
        #pragma unroll
        for (int q = t; q < 8 * NERF_LANES / 4; q += NERF_LANES) {
            const unsigned row = (ws + (unsigned)(q >> 5)) & row_mask;
            win[q] = __ldg(tab + (long long)row * (NERF_LANES / 4) + (q & 31));
        }
        __syncthreads();
        if (m == mq) {
            const unsigned* wrow =
                reinterpret_cast<const unsigned*>(win) + rr * NERF_LANES + base;
            #pragma unroll
            for (int d = 0; d < 8; ++d) {
                const int off = ((d >> 2) & 1) * 25 + ((d >> 1) & 1) * 5 + (d & 1);
                const unsigned v = wrow[off];
                const float w = wx[(d >> 2) & 1] * wy[(d >> 1) & 1] * wz[d & 1];
                acc0 += w * __uint_as_float(v & 0xFFFF0000u);
                acc1 += w * __uint_as_float(v << 16);
            }
        }
        __syncthreads();
    }
    float2* o = reinterpret_cast<float2*>(
        out + ((long long)g * NERF_LANES + t) * (2 * n_levels) + 2 * l);
    *o = make_float2(acc0, acc1);
}

extern "C" int encode_blocked_launch(const int* table, const float* pts,
                                     const int* wids, const int* counts,
                                     const float* scales, const int* boffs,
                                     float bx, float by, float bz, float ix,
                                     float iy, float iz, int n_groups,
                                     int n_levels, int s_rows, float* out,
                                     void* stream) {
    const dim3 grid(n_groups, n_levels);
    encode_blocked_kernel<<<grid, NERF_LANES, 0, (cudaStream_t)stream>>>(
        table, pts, wids, counts, scales, boffs, bx, by, bz, ix, iy, iz,
        n_groups, n_levels, s_rows, out);
    return (int)cudaGetLastError();
}
