// Window-list prepass of the blocked hash encode (kernel K1).
//
// Replaces nerfpp_tpu/pallas/hash_encode_blocked.py:_make_windows_kernel
// (called by _windows_call): for every (128-point group, level) it lists the
// sorted unique Morton codes of the 2x2x2-block windows the group's points
// fall in, unique codes first, the tail padded with 0x7FFFFFFF, plus the
// unique count. The forward encode (encode_blocked.cu) loops over that list.
//
// Bound on the H100: bytes, 0.0958 ms at the flagship chunk (4,194,304
// points, 16 levels): 12 B of coordinates a point read, 4 B of window id a
// point and level written (268 MB). The work itself is latency: 524,288
// (group, level) lists at that chunk, each a 128-wide dedup and sort.
//
// Design: one warp per (group, level), no block barrier inside a task. A
// block of up to 8 warps takes one group: it reads the group's 128 points
// (1,536 B) into shared memory once, beside a 4 KB table of nerf_spread10,
// behind the block's only barrier; its warps walk the levels (warp w:
// levels w, w + 8, ...), keeping the level-independent (x - min) * inv of
// their points in registers. A lane holds elements 4 * lane + k (k = 0..3)
// of the 128 codes. Most lists are short (2.9 codes on average at the
// flagship chunk, 104 on 2^20 random points): up to WL_FEW (16) codes are
// taken in ascending order as the warp's minimum (one __reduce_min_sync
// each), its copies dropped. A list longer than that is sorted: an
// ascending bitonic sort (nerf_sort128, blocked_geometry.cuh, shared with
// K3's index) whose stages of distance 1 and 2 run inside the
// lane's registers and the 15 of distance >= 4 by __shfl_xor_sync (60
// shuffles); first
// occurrences compare with the previous element (__shfl_up_sync for
// k = 0), and four ballots give each its place. The row goes through a
// 512 B per-warp staging row in shared memory to one 16-byte store a lane.
// The TPU kernel's re-sort with sentinels, its per-group-block max count
// and its 1024-padded SMEM table are artefacts of the TPU's vector and
// scalar memories and are not made.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (profile_kernels.py,
// this design against the one block of 128 threads per (group, level) with
// a barrier-separated shared-memory sort before it, in one run; PERF.md):
// 0.2181 / 0.2171 ms against 1.3333 / 1.3434 at the flagship chunk (2.3x
// its bound), 0.1619 / 0.1608 against 0.3483 / 0.3504 on 2^20 random points
// (the sort path), 0.0158 against 0.0864 / 0.0869 at the train chunk.
#include <cuda_runtime.h>

#include "blocked_geometry.cuh"

#define WL_WARPS 8                 // warps of a block (levels walked at once)
#define WL_FULL 0xFFFFFFFFu
#define WL_FEW 16                  // unique codes found by warp minima

// first occurrences of the sorted codes, compacted in order into row;
// returns their count
__device__ __forceinline__ int wl_compact(const int v[4], int lane,
                                          int* row) {
    const int prev = __shfl_up_sync(WL_FULL, v[3], 1);
    const bool f[4] = {lane == 0 || v[0] != prev, v[1] != v[0],
                       v[2] != v[1], v[3] != v[2]};
    const unsigned below = (1u << lane) - 1u;
    int pos = 0, total = 0;
    #pragma unroll
    for (int k = 0; k < 4; ++k) {
        const unsigned b = __ballot_sync(WL_FULL, f[k]);
        pos += __popc(b & below);
        total += __popc(b);
    }
    #pragma unroll
    for (int k = 0; k < 4; ++k) {
        if (f[k]) row[pos] = v[k];
        pos += f[k];
    }
    return total;
}

__global__ void __launch_bounds__(WL_WARPS * 32)
window_lists_kernel(const float* __restrict__ pts,      // [NG * 128, 3]
                    const float* __restrict__ scales,   // [L]
                    const int* __restrict__ boffs,      // [L, 3]
                    float bx, float by, float bz,
                    float ix, float iy, float iz,
                    int n_groups, int n_levels,
                    int* __restrict__ wids,             // [L, NG, 128]
                    int* __restrict__ counts) {         // [L, NG]
    __shared__ __align__(16) float s_pts[NERF_LANES * 3];
    __shared__ __align__(16) int s_row[WL_WARPS][NERF_LANES];
    __shared__ unsigned s_spread[1024];                 // nerf_spread10
    for (int i = threadIdx.x; i < 1024; i += blockDim.x)
        s_spread[i] = nerf_spread10((unsigned)i);
    const int g = blockIdx.x;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int n_warps = blockDim.x >> 5;
    const float* src = pts + (long long)g * NERF_LANES * 3;
    for (int i = t; i < NERF_LANES * 3; i += blockDim.x) s_pts[i] = src[i];
    __syncthreads();

    // elements 4 * lane + k: their (x - min) * inv, the level-independent
    // first two roundings of nerf_rel
    float r[4][3];
    {
        const float4* q = reinterpret_cast<const float4*>(s_pts) + 3 * lane;
        const float4 a = q[0], b = q[1], c = q[2];
        const float xs[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                              b.z, b.w, c.x, c.y, c.z, c.w};
        const float mins[3] = {bx, by, bz};
        const float invs[3] = {ix, iy, iz};
        #pragma unroll
        for (int k = 0; k < 4; ++k)
            #pragma unroll
            for (int d = 0; d < 3; ++d)
                r[k][d] = __fmul_rn(__fsub_rn(xs[3 * k + d], mins[d]),
                                    invs[d]);
    }
    int* row = s_row[warp];

    for (int l = warp; l < n_levels; l += n_warps) {
        const float scale = __ldg(scales + l);
        const int o[3] = {__ldg(boffs + 3 * l), __ldg(boffs + 3 * l + 1),
                          __ldg(boffs + 3 * l + 2)};
        int v[4];
        #pragma unroll
        for (int k = 0; k < 4; ++k) {
            unsigned m = 0;
            #pragma unroll
            for (int d = 0; d < 3; ++d) {
                const int c = (int)floorf(__fmul_rn(r[k][d], scale));
                m |= s_spread[(((c >> 2) + o[d]) >> 1) & 0x3FF] << d;
            }
            v[k] = (int)m;
        }
        int* out = wids + ((long long)l * n_groups + g) * NERF_LANES;
        int4* out4 = reinterpret_cast<int4*>(out) + lane;

        // up to WL_FEW unique codes: take the warp's minimum and drop its
        // copies, in ascending order, without a sort
        int rest[4] = {v[0], v[1], v[2], v[3]};
        int total = 0;
        bool few = false;
        #pragma unroll 1
        for (;; ++total) {
            const int m = __reduce_min_sync(
                WL_FULL, min(min(rest[0], rest[1]), min(rest[2], rest[3])));
            if (m == NERF_SENTINEL) {
                few = true;
                break;
            }
            if (total == WL_FEW) break;
            if (lane == 0) row[total] = m;
            #pragma unroll
            for (int k = 0; k < 4; ++k)
                rest[k] = rest[k] == m ? NERF_SENTINEL : rest[k];
        }
        if (!few) {
            nerf_sort128(v, lane);
            total = wl_compact(v, lane, row);
        }
        __syncwarp();
        int4 w = reinterpret_cast<const int4*>(row)[lane];
        const int i0 = 4 * lane;
        if (i0 + 0 >= total) w.x = NERF_SENTINEL;
        if (i0 + 1 >= total) w.y = NERF_SENTINEL;
        if (i0 + 2 >= total) w.z = NERF_SENTINEL;
        if (i0 + 3 >= total) w.w = NERF_SENTINEL;
        *out4 = w;
        if (lane == 0) counts[(long long)l * n_groups + g] = total;
        __syncwarp();                 // the row is read before it is reused
    }
}

extern "C" int window_lists_launch(const float* pts, const float* scales,
                                   const int* boffs, float bx, float by,
                                   float bz, float ix, float iy, float iz,
                                   int n_groups, int n_levels, int* wids,
                                   int* counts, void* stream) {
    const int warps = n_levels < WL_WARPS ? n_levels : WL_WARPS;
    window_lists_kernel<<<n_groups, 32 * warps, 0, (cudaStream_t)stream>>>(
        pts, scales, boffs, bx, by, bz, ix, iy, iz, n_groups, n_levels, wids,
        counts);
    return (int)cudaGetLastError();
}
