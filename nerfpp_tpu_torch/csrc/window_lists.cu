// Window-list prepass of the blocked hash encode (kernel K1).
//
// Replaces nerfpp_tpu/pallas/hash_encode_blocked.py:_make_windows_kernel
// (called by _windows_call): for every (128-point group, level) it lists the
// sorted unique Morton codes of the 2x2x2-block windows the group's points
// fall in, unique codes first, the tail padded with 0x7FFFFFFF, plus the
// unique count. The forward encode (encode_blocked.cu) loops over that list.
//
// Bound on the H100: bytes. Per point it reads 12 B of coordinates and writes
// 4 B of window id per level (plus one count per group and level); the work
// is a 128-wide bitonic sort of 28 compare-exchange stages in shared memory,
// far below the card's integer rate. Design: one block of 128 threads per
// (group, level), one point per thread; the sort, the first-occurrence flags
// and the compaction (warp ballots plus a four-warp prefix) stay in shared
// memory and registers, so device memory sees each input once and each
// output once. The TPU's per-group-block max count and its 1024-padded SMEM
// table are artefacts of the TPU's scalar memory and are not produced.
#include <cuda_runtime.h>

#include "blocked_geometry.cuh"

__global__ void __launch_bounds__(NERF_LANES)
window_lists_kernel(const float* __restrict__ pts,      // [NG * 128, 3]
                    const float* __restrict__ scales,   // [L]
                    const int* __restrict__ boffs,      // [L, 3]
                    float bx, float by, float bz,
                    float ix, float iy, float iz,
                    int n_groups,
                    int* __restrict__ wids,             // [L, NG, 128]
                    int* __restrict__ counts) {         // [L, NG]
    __shared__ int s[NERF_LANES];
    __shared__ int warp_total[NERF_LANES / 32];
    const int g = blockIdx.x;
    const int l = blockIdx.y;
    const int t = threadIdx.x;
    const float scale = scales[l];
    const float* p = pts + ((long long)g * NERF_LANES + t) * 3;

    const int c0 = (int)floorf(nerf_rel(p[0], bx, ix, scale));
    const int c1 = (int)floorf(nerf_rel(p[1], by, iy, scale));
    const int c2 = (int)floorf(nerf_rel(p[2], bz, iz, scale));
    const int o0 = (c0 >> 2) + boffs[3 * l + 0];
    const int o1 = (c1 >> 2) + boffs[3 * l + 1];
    const int o2 = (c2 >> 2) + boffs[3 * l + 2];
    s[t] = (int)(nerf_spread10((unsigned)(o0 >> 1))
                 | (nerf_spread10((unsigned)(o1 >> 1)) << 1)
                 | (nerf_spread10((unsigned)(o2 >> 1)) << 2));
    __syncthreads();

    // ascending bitonic sort of the block's 128 codes
    for (int k = 2; k <= NERF_LANES; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            const int partner = t ^ j;
            if (partner > t) {
                const int a = s[t];
                const int b = s[partner];
                const bool ascending = (t & k) == 0;
                if ((a > b) == ascending) {
                    s[t] = b;
                    s[partner] = a;
                }
            }
            __syncthreads();
        }
    }

    // first occurrences, compacted to the front in order
    const int v = s[t];
    const bool first = (t == 0) || (v != s[t - 1]);
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, first);
    const int lane = t & 31;
    const int warp = t >> 5;
    if (lane == 0) warp_total[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0;
    int total = 0;
    #pragma unroll
    for (int w = 0; w < NERF_LANES / 32; ++w) {
        offset += (w < warp) ? warp_total[w] : 0;
        total += warp_total[w];
    }
    int* out = wids + ((long long)l * n_groups + g) * NERF_LANES;
    if (first) out[offset + __popc(ballot & ((1u << lane) - 1u))] = v;
    if (t >= total) out[t] = NERF_SENTINEL;
    if (t == 0) counts[(long long)l * n_groups + g] = total;
}

extern "C" int window_lists_launch(const float* pts, const float* scales,
                                   const int* boffs, float bx, float by,
                                   float bz, float ix, float iy, float iz,
                                   int n_groups, int n_levels, int* wids,
                                   int* counts, void* stream) {
    const dim3 grid(n_groups, n_levels);
    window_lists_kernel<<<grid, NERF_LANES, 0, (cudaStream_t)stream>>>(
        pts, scales, boffs, bx, by, bz, ix, iy, iz, n_groups, wids, counts);
    return (int)cudaGetLastError();
}
