// Table gradient of the blocked hash encode (kernel K3), summed in a fixed
// order with no float atomics.
//
// Replaces nerfpp_tpu/pallas/hash_encode_blocked.py:_make_bwd_kernel (called
// by _bwd_call, entry grad_prepared): for every point and level, each of the
// 8 corners of the point's cell gets w_corner * g[n, l, f] added to its table
// entry. The result is the flat f32 gradient [L * 2^T, 2], every entry
// written exactly once (lanes 125-127 of each 128-lane row as zeros). The
// TPU kernel's window-interleaved slab and its bf16 pattern matmul are
// artefacts of the MXU: here the weights and sums are f32 throughout.
//
// Bound on the H100: bytes. Per point it reads 12 B of coordinates and 8L B
// of cotangent, K1's lists, and writes the 67.1 MB gradient (L = 16,
// T = 2^19) once. The arithmetic is a few dozen operations per point and
// level.
//
// Order: every entry's terms are added in an order fixed by the inputs, so
// two launches on the same inputs give bitwise equal gradients (the Pallas
// kernel also sums in grid order). A float atomicAdd would not, and on this
// card a shared-memory one is a compare-and-swap loop. Integer atomics only
// count, set bits and hand out work.
//
// Design, two kernels. A window is the 8 rows of a 2x2x2-block octant
// (window = octant Morton code & (S/8 - 1), the arithmetic of K1).
// 1. grad_index_kernel, one warp per (128-point group, level), as K1: the
//    group's points sorted by (window, point) in registers (K1's sort,
//    skipped where K1's list says the group has one window), written as a
//    byte permutation; for each window of the group its run in the
//    permutation, table[level][window][group] = first | last << 8; one bit
//    per (level, window, group) in a bitmask, and the window's point count,
//    by integer atomics. The last block to finish writes the plan: a
//    window of n points is ceil(n / part) parts (part = 2,048 points),
//    listed in window order, coarse levels (the crowded windows) first.
// 2. grad_owner_kernel, persistent blocks of 4 independent warps; each
//    warp takes the next part (an integer counter) and owns its window's
//    8 rows x 128 lanes x 2 features as an 8 KB tile in shared memory. It
//    lists the window's groups in ascending order from the bitmask (part p
//    of P takes the p-th, (p + P)-th, ... of them), and a step stages the
//    runs of the next groups, one a lane, up to 1,024 points, so that a
//    sparse window (a point or two a group) does not pay a step a group.
//    The lanes take the staged points in turn, each fetched two ahead:
//    cell, row and lane as K2 computes them (blocked_geometry.cuh), summed
//    in registers for the lane's last two cells. When a lane meets
//    a third cell it flushes the older sum: lanes with the same corner-0
//    entry are summed by a fixed shuffle tree and the lowest adds the 8
//    corners into the tile one corner a round (distinct corner-0 entries
//    have distinct corner-d entries; __syncwarp orders the rounds; a lone
//    lane needs no rounds). A window of one part is written from its tile
//    once, zeros where no point fell; a split window's parts write partial
//    tiles, and the last part to finish adds them in part order into the
//    rows. The zero fill of the gradient and the global atomics of the
//    earlier design go.
#include <cuda_runtime.h>

#include "blocked_geometry.cuh"

#define GB_FULL 0xFFFFFFFFu
#define GB_INDEX_WARPS 8                   // levels an index block walks
#define GB_WARPS 4                         // independent warps of a block
#define GB_STAGE 1024                      // points a warp stages at once
#define GB_TILE (8 * NERF_LANES)           // float2 entries of a window
#define GB_LIST 1024                       // groups listed at a time
#define GB_PLAN 16                         // windows a plan thread takes

__global__ void __launch_bounds__(GB_INDEX_WARPS * 32)
grad_index_kernel(const float* __restrict__ pts,        // [NG * 128, 3]
                  const float* __restrict__ scales,     // [L]
                  const int* __restrict__ boffs,        // [L, 3]
                  float bx, float by, float bz,
                  float ix, float iy, float iz,
                  const int* __restrict__ wids,         // [L, NG, 128]
                  const int* __restrict__ counts,       // [L, NG]
                  int n_groups, int n_levels, int n_windows, int words,
                  int part_pts,
                  unsigned* __restrict__ mask,          // [L, W, words]
                  unsigned char* __restrict__ perm,     // [L, NG * 128]
                  unsigned short* __restrict__ table,   // [L, W, NG]
                  int* __restrict__ plan) {
    __shared__ __align__(16) float s_pts[NERF_LANES * 3];
    __shared__ int sums[2][GB_INDEX_WARPS];
    __shared__ bool last;
    const int g = blockIdx.x;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const float* src = pts + (long long)g * NERF_LANES * 3;
    for (int i = t; i < NERF_LANES * 3; i += blockDim.x) s_pts[i] = src[i];
    __syncthreads();
    // elements 4 * lane + k: their (x - min) * inv, as in K1
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
    const long long m = (long long)n_groups * NERF_LANES;
    const int lw = n_levels * n_windows;
    const unsigned wmask = (unsigned)n_windows - 1u;
    int* npts = plan + 4;

    for (int l = warp; l < n_levels; l += GB_INDEX_WARPS) {
        const float scale = __ldg(scales + l);
        const int o[3] = {__ldg(boffs + 3 * l), __ldg(boffs + 3 * l + 1),
                          __ldg(boffs + 3 * l + 2)};
        // keys (window << 7) | point, sorted: runs of one window, each in
        // ascending point order
        int v[4];
        #pragma unroll
        for (int k = 0; k < 4; ++k) {
            unsigned code = 0;
            #pragma unroll
            for (int d = 0; d < 3; ++d) {
                const int c = (int)floorf(__fmul_rn(r[k][d], scale));
                code |= nerf_spread10((unsigned)(((c >> 2) + o[d]) >> 1))
                        << d;
            }
            v[k] = (int)((code & wmask) << 7) | (4 * lane + k);
        }
        // K1's list: a group whose codes all mask to one window is in order
        const long long lg = (long long)l * n_groups + g;
        const int n_codes = __ldg(counts + lg);
        const int* codes = wids + lg * NERF_LANES;
        const unsigned first = (unsigned)__ldg(codes) & wmask;
        bool other = false;
        for (int k = lane; k < n_codes; k += 32)
            other |= ((unsigned)__ldg(codes + k) & wmask) != first;
        if (__any_sync(GB_FULL, other)) nerf_sort128(v, lane);

        // the runs: first and last element of each window
        int win[4];
        #pragma unroll
        for (int k = 0; k < 4; ++k) win[k] = v[k] >> 7;
        const int prev = __shfl_up_sync(GB_FULL, win[3], 1);
        const int next = __shfl_down_sync(GB_FULL, win[0], 1);
        int run = -1;                // first element of the current run
        int starts[4];
        #pragma unroll
        for (int k = 0; k < 4; ++k) {
            const bool st = k == 0 ? lane == 0 || win[0] != prev
                                   : win[k] != win[k - 1];
            if (st) run = 4 * lane + k;
            starts[k] = run;
        }
        // a run begun in an earlier lane: the latest first element before
        int carry = run;
        #pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int x = __shfl_up_sync(GB_FULL, carry, d);
            if (lane >= d) carry = max(carry, x);
        }
        const int before = __shfl_up_sync(GB_FULL, carry, 1);
        unsigned bytes = 0;
        #pragma unroll
        for (int k = 0; k < 4; ++k) {
            bytes |= (unsigned)(v[k] & 127) << (8 * k);
            const int s = starts[k] >= 0 ? starts[k] : before;
            const bool end = k == 3 ? lane == 31 || win[3] != next
                                    : win[k] != win[k + 1];
            if (end) {
                const int i = 4 * lane + k;
                const long long lwi = (long long)l * n_windows + win[k];
                table[lwi * n_groups + g] = (unsigned short)(s | (i << 8));
                atomicOr(mask + lwi * words + (g >> 5), 1u << (g & 31));
                atomicAdd(npts + lwi, i - s + 1);
            }
        }
        reinterpret_cast<unsigned*>(perm + l * m + (long long)g * NERF_LANES)
            [lane] = bytes;
    }

    // the last block to finish (plan[2] counts them) writes the owner
    // kernel's plan: a window of n points is ceil(n / part_pts) parts (one
    // if it has none), the items (window, part) in window order, and for a
    // window of more than one part the first of its slots for partial sums
    __threadfence();
    __syncthreads();
    if (t == 0) last = atomicAdd(plan + 2, 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    int* parts = npts + lw;
    int* slots = parts + lw;
    int* items = slots + lw;
    // thread t of a chunk: windows base + k * blockDim.x + t, k < GB_PLAN,
    // their parts loaded together; one block scan per k, so that the
    // block's stores of neighbouring windows and items coalesce
    int item = 0, slot = 0;          // items and slots of earlier windows
    for (int base = 0; base < lw; base += GB_PLAN * (int)blockDim.x) {
        int np[GB_PLAN];
        #pragma unroll
        for (int k = 0; k < GB_PLAN; ++k) {
            const int i = base + k * (int)blockDim.x + t;
            const int c = i < lw ? __ldcg(npts + i) : -1;
            np[k] = c < 0 ? 0 : c == 0 ? 1 : (c + part_pts - 1) / part_pts;
        }
        #pragma unroll
        for (int k = 0; k < GB_PLAN; ++k) {
            const int split = np[k] > 1 ? np[k] : 0;
            int ci = np[k], cs = split;
            #pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int xi = __shfl_up_sync(GB_FULL, ci, d);
                const int xs = __shfl_up_sync(GB_FULL, cs, d);
                if (lane >= d) {
                    ci += xi;
                    cs += xs;
                }
            }
            if (lane == 31) {
                sums[0][warp] = ci;
                sums[1][warp] = cs;
            }
            __syncthreads();
            int at = item + ci - np[k], at_slot = slot + cs - split;
            #pragma unroll
            for (int j = 0; j < GB_INDEX_WARPS; ++j) {
                at += j < warp ? sums[0][j] : 0;
                at_slot += j < warp ? sums[1][j] : 0;
                item += sums[0][j];
                slot += sums[1][j];
            }
            __syncthreads();         // the sums are reused
            const int i = base + k * (int)blockDim.x + t;
            if (np[k] > 0) {
                parts[i] = np[k];
                slots[i] = split > 0 ? at_slot : 0;
                for (int j = 0; j < np[k]; ++j) {
                    items[2 * (at + j)] = i;
                    items[2 * (at + j) + 1] = j;
                }
            }
        }
    }
    if (t == 0) {
        plan[0] = item;
        plan[1] = slot;
        plan[2] = 0;
    }
}

// sum the corner products of the lanes that flush, per corner-0 entry, into
// the lowest of them (a fixed shuffle tree: each round every lane adds the
// next remaining peer above it, then the odd ranks drop out), which adds
// its 8 corners to the warp's tile one corner a round: distinct corner-0
// entries give distinct corner-d entries, so no two lanes of a round touch
// one entry, and __syncwarp orders the rounds
__device__ __forceinline__ void gb_flush(float2* tile, const float (&acc)[16],
                                         int key, bool flush,
                                         unsigned below, int lane) {
    float f[16];
    #pragma unroll
    for (int k = 0; k < 16; ++k) f[k] = acc[k];
    // lanes that do not flush are their own peers (keys below -1)
    const unsigned peers = __match_any_sync(GB_FULL, flush ? key : -2 - lane);
    int rank = __popc(peers & below);
    unsigned rest = peers & ~(below | (1u << lane));
    while (__any_sync(GB_FULL, rest != 0u)) {
        const int next = __ffs(rest) - 1;
        #pragma unroll
        for (int k = 0; k < 16; ++k) {
            const float o = __shfl_sync(GB_FULL, f[k], next & 31);
            if (next >= 0) f[k] += o;
        }
        rest &= __ballot_sync(GB_FULL, (rank & 1) == 0);
        rank >>= 1;
    }
    const bool lead = flush && (peers & below) == 0u;
    if (__popc(__ballot_sync(GB_FULL, lead)) == 1) {
        // one leader touches no other lane's entries: no rounds
        if (lead) {
            float2 a[8];
            #pragma unroll
            for (int d = 0; d < 8; ++d)
                a[d] = tile[key + ((d >> 2) & 1) * 25 + ((d >> 1) & 1) * 5
                            + (d & 1)];
            #pragma unroll
            for (int d = 0; d < 8; ++d) {
                a[d].x += f[2 * d];
                a[d].y += f[2 * d + 1];
                tile[key + ((d >> 2) & 1) * 25 + ((d >> 1) & 1) * 5
                     + (d & 1)] = a[d];
            }
        }
        __syncwarp();
        return;
    }
    #pragma unroll
    for (int d = 0; d < 8; ++d) {
        if (lead) {
            float2* q = tile + key + ((d >> 2) & 1) * 25 + ((d >> 1) & 1) * 5
                        + (d & 1);
            float2 a = *q;
            a.x += f[2 * d];
            a.y += f[2 * d + 1];
            *q = a;
        }
        __syncwarp();
    }
}

// one staged point: the loads it needs, fetched two points ahead
struct GbPoint {
    bool valid;
    float x0, x1, x2;
    float2 cot;
};

__global__ void __launch_bounds__(GB_WARPS * 32)
grad_owner_kernel(const float* __restrict__ g,          // [n_valid, 2L]
                  const float* __restrict__ pts,        // [NG * 128, 3]
                  const float* __restrict__ scales,     // [L]
                  const int* __restrict__ boffs,        // [L, 3]
                  float bx, float by, float bz,
                  float ix, float iy, float iz,
                  const unsigned* __restrict__ mask,    // [L, W, words]
                  const unsigned char* __restrict__ perm,
                  const unsigned short* __restrict__ table,
                  const int* __restrict__ plan,
                  int* __restrict__ state,              // [L * W + 1]
                  float4* __restrict__ partial,         // [slots, 8 * 64]
                  int n_valid, int n_groups, int n_levels, int s_rows,
                  int n_windows, int words,
                  float* __restrict__ grad) {           // [L * S * 128, 2]
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const unsigned below = (1u << lane) - 1u;
    // the warp's tile, group list and stage
    const size_t bytes = sizeof(float2) * GB_TILE + sizeof(short) * GB_LIST
                         + sizeof(unsigned short) * GB_STAGE;
    float2* tile = reinterpret_cast<float2*>(smem + warp * bytes);
    short* list = reinterpret_cast<short*>(tile + GB_TILE);
    unsigned short* stage = reinterpret_cast<unsigned short*>(list + GB_LIST);
    float4* t4 = reinterpret_cast<float4*>(tile);
    const int rows = s_rows < 8 ? s_rows : 8;
    const int quads = rows * NERF_LANES / 2;            // float4 of a tile
    const int lw = n_levels * n_windows;
    const int* npts = plan + 4;
    const int* parts = npts + lw;
    const int* slots = parts + lw;
    const int* items = slots + lw;
    const int n_items = plan[0];
    const long long m = (long long)n_groups * NERF_LANES;
    const int row_len = 2 * n_levels;

    for (;;) {
        int item = 0;
        if (lane == 0) item = atomicAdd(state + lw, 1);
        item = __shfl_sync(GB_FULL, item, 0);
        if (item >= n_items) break;
        const int wi = items[2 * item];
        const int part = items[2 * item + 1];
        const int n_parts = parts[wi];
        const int l = wi / n_windows;
        const int w = wi - l * n_windows;
        float4* out = reinterpret_cast<float4*>(
            grad + ((long long)l * s_rows + (long long)w * rows)
                   * NERF_LANES * 2);
        const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (npts[wi] == 0) {         // no point in the window: zeros
            for (int i = lane; i < quads; i += 32) out[i] = zero;
            continue;
        }
        for (int i = lane; i < quads; i += 32) t4[i] = zero;
        const float scale = __ldg(scales + l);
        const int bo0 = __ldg(boffs + 3 * l + 0);
        const int bo1 = __ldg(boffs + 3 * l + 1);
        const int bo2 = __ldg(boffs + 3 * l + 2);
        const unsigned* wmask = mask + (long long)wi * words;
        const unsigned short* runs = table + (long long)wi * n_groups;
        const unsigned char* lperm = perm + l * m;
        // the lane's running sums over its points in its last two cells
        // (keys: the cells' corner-0 entries in the tile); the older one is
        // added to the tile when the lane meets a third cell, both at the
        // end
        float acc[16] = {}, old[16] = {};
        int acc_key = -1, old_key = -1;
        int done = 0;                // groups listed before this chunk
        __syncwarp();

        for (int first = 0; first < words; first += 32) {
            // this chunk's groups, ascending: a popcount scan of its words
            const unsigned word = first + lane < words ? wmask[first + lane]
                                                       : 0u;
            const int cnt = __popc(word);
            int incl = cnt;
            #pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int x = __shfl_up_sync(GB_FULL, incl, d);
                if (lane >= d) incl += x;
            }
            const int total = __shfl_sync(GB_FULL, incl, 31);
            int off = incl - cnt;
            for (unsigned rest = word; rest != 0u; rest &= rest - 1u)
                list[off++] = (short)(lane * 32 + __ffs(rest) - 1);
            __syncwarp();
            const long long chunk_g = (long long)first * 32;
            // the part's groups: the window's p-th, (p + P)-th, ...
            int i0 = (part - done) % n_parts;
            i0 += i0 < 0 ? n_parts : 0;

            for (int i = i0; i < total;) {
                // a step: the next groups of the part, one a lane, as many
                // as their runs fit the stage (at least one; runs <= 128)
                const int ik = i + lane * n_parts;
                const bool has = ik < total;
                const long long grp = has ? chunk_g + list[ik] : 0;
                const unsigned e = has ? runs[grp] : 0u;
                const int s = (int)(e & 255u);
                const int len = has ? (int)(e >> 8) - s + 1 : 0;
                int incl = len;
                #pragma unroll
                for (int d = 1; d < 32; d <<= 1) {
                    const int x = __shfl_up_sync(GB_FULL, incl, d);
                    if (lane >= d) incl += x;
                }
                const int n_grp = __popc(
                    __ballot_sync(GB_FULL, has && incl <= GB_STAGE));
                const int n_sel = __shfl_sync(GB_FULL, incl, n_grp - 1);
                const int pre = incl - len;
                // the runs into the stage as (slot << 7) | point: short
                // runs a lane each, long ones a group at a time by the warp
                const int longest = __reduce_max_sync(
                    GB_FULL, lane < n_grp ? len : 0);
                if (longest <= 8) {
                    if (lane < n_grp) {
                        const unsigned char* row = lperm + grp * NERF_LANES;
                        for (int b = 0; b < len; ++b)
                            stage[pre + b] = (unsigned short)(
                                (lane << 7) | row[s + b]);
                    }
                } else {
                    for (int k = 0; k < n_grp; ++k) {
                        const int sk = __shfl_sync(GB_FULL, s, k);
                        const int lk = __shfl_sync(GB_FULL, len, k);
                        const int pk = __shfl_sync(GB_FULL, pre, k);
                        const long long gk = __shfl_sync(GB_FULL, grp, k);
                        const unsigned word4 =
                            reinterpret_cast<const unsigned*>(
                                lperm + gk * NERF_LANES)[lane];
                        #pragma unroll
                        for (int b = 0; b < 4; ++b) {
                            const int pos = 4 * lane + b - sk;
                            if (pos >= 0 && pos < lk)
                                stage[pk + pos] = (unsigned short)(
                                    (k << 7) | ((word4 >> (8 * b)) & 127u));
                        }
                    }
                }
                __syncwarp();

                // lane j takes staged points j, j + 32, ...: neighbouring
                // lanes read neighbouring points of a run
                const int per = (n_sel + 31) >> 5;
                auto fetch = [&](int idx) {
                    GbPoint q;
                    q.valid = false;
                    q.x0 = q.x1 = q.x2 = 0.0f;
                    q.cot = make_float2(0.0f, 0.0f);
                    if (idx < n_sel) {
                        const int e = stage[idx];
                        const long long n =
                            (chunk_g + list[i + (e >> 7) * n_parts])
                            * NERF_LANES + (e & 127);
                        if (n < n_valid) {
                            q.valid = true;
                            q.x0 = pts[3 * n];
                            q.x1 = pts[3 * n + 1];
                            q.x2 = pts[3 * n + 2];
                            q.cot = *reinterpret_cast<const float2*>(
                                g + n * row_len + 2 * l);
                        }
                    }
                    return q;
                };
                GbPoint cur = fetch(lane);
                GbPoint nx1 = fetch(lane + 32);
                for (int it = 0; it < per; ++it) {
                    const GbPoint nxt = fetch(lane + 32 * (it + 2));
                    const float r0 = nerf_rel(cur.x0, bx, ix, scale);
                    const float r1 = nerf_rel(cur.x1, by, iy, scale);
                    const float r2 = nerf_rel(cur.x2, bz, iz, scale);
                    const float fl0 = floorf(r0), fl1 = floorf(r1);
                    const float fl2 = floorf(r2);
                    const int c0 = (int)fl0, c1 = (int)fl1, c2 = (int)fl2;
                    const float f0 = __fsub_rn(r0, fl0);
                    const float f1 = __fsub_rn(r1, fl1);
                    const float f2 = __fsub_rn(r2, fl2);
                    const unsigned slot =
                        (nerf_spread10((unsigned)((c0 >> 2) + bo0))
                         | (nerf_spread10((unsigned)((c1 >> 2) + bo1)) << 1)
                         | (nerf_spread10((unsigned)((c2 >> 2) + bo2)) << 2))
                        & ((unsigned)s_rows - 1u);
                    // the cell's row in the window and its corner-0 lane
                    const int key = (int)(slot & 7u) * NERF_LANES
                                    + (c0 & 3) * 25 + (c1 & 3) * 5
                                    + (c2 & 3);
                    const bool fresh = cur.valid && key != acc_key
                                       && key != old_key;
                    const bool flush = fresh && old_key >= 0;
                    if (__any_sync(GB_FULL, flush)) {
                        gb_flush(tile, old, old_key, flush, below, lane);
                        if (flush) old_key = -1;
                    }
                    if (cur.valid && key != acc_key) {
                        // the older sum becomes the current, or a new one
                        #pragma unroll
                        for (int k = 0; k < 16; ++k) {
                            const float x = old[k];
                            old[k] = acc[k];
                            acc[k] = fresh ? 0.0f : x;
                        }
                        old_key = acc_key;
                        acc_key = key;
                    }
                    if (cur.valid) {
                        const float wx[2] = {1.0f - f0, f0};
                        const float wy[2] = {1.0f - f1, f1};
                        const float wz[2] = {1.0f - f2, f2};
                        #pragma unroll
                        for (int d = 0; d < 8; ++d) {
                            const float wd = wx[(d >> 2) & 1]
                                             * wy[(d >> 1) & 1] * wz[d & 1];
                            acc[2 * d] = fmaf(wd, cur.cot.x, acc[2 * d]);
                            acc[2 * d + 1] = fmaf(wd, cur.cot.y,
                                                  acc[2 * d + 1]);
                        }
                    }
                    cur = nx1;
                    nx1 = nxt;
                }
                i += n_grp * n_parts;
                __syncwarp();        // the stage is rewritten next step
            }
            done += total;
            __syncwarp();            // the list is rewritten next chunk
        }
        if (__any_sync(GB_FULL, old_key >= 0))
            gb_flush(tile, old, old_key, old_key >= 0, below, lane);
        if (__any_sync(GB_FULL, acc_key >= 0))
            gb_flush(tile, acc, acc_key, acc_key >= 0, below, lane);

        // one part: the window's rows; more: this part's slot, the last
        // part to finish adding the slots in part order into the rows
        float4* dst = n_parts == 1
            ? out : partial + (long long)(slots[wi] + part) * quads;
        for (int i = lane; i < quads; i += 32) dst[i] = t4[i];
        if (n_parts > 1) {
            __threadfence();
            __syncwarp();
            int last = 0;
            if (lane == 0) last = atomicAdd(state + wi, 1) == n_parts - 1;
            if (__shfl_sync(GB_FULL, last, 0)) {
                __threadfence();
                const float4* src = partial + (long long)slots[wi] * quads;
                for (int i = lane; i < quads; i += 32) {
                    float4 s = __ldcg(src + i);
                    for (int k = 1; k < n_parts; ++k) {
                        const float4 a = __ldcg(src + k * quads + i);
                        s.x += a.x;
                        s.y += a.y;
                        s.z += a.z;
                        s.w += a.w;
                    }
                    out[i] = s;
                }
            }
        }
        __syncwarp();                // the tile is reused
    }
}

static size_t grad_owner_smem() {
    return GB_WARPS * (sizeof(float2) * GB_TILE + sizeof(short) * GB_LIST
                       + sizeof(unsigned short) * GB_STAGE);
}

extern "C" int grad_index_launch(const float* pts, const float* scales,
                                 const int* boffs, float bx, float by,
                                 float bz, float ix, float iy, float iz,
                                 const int* wids, const int* counts,
                                 int n_groups, int n_levels, int n_windows,
                                 int words, int part_pts, unsigned* mask,
                                 unsigned char* perm, unsigned short* table,
                                 int* plan, int plan_len, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const size_t lw = (size_t)n_levels * n_windows;
    cudaError_t err = cudaMemsetAsync(mask, 0,
                                      sizeof(unsigned) * lw * words, s);
    if (err == cudaSuccess)
        err = cudaMemsetAsync(plan, 0, sizeof(int) * (size_t)plan_len, s);
    if (err != cudaSuccess || n_groups == 0) return (int)err;
    grad_index_kernel<<<n_groups, GB_INDEX_WARPS * 32, 0, s>>>(
        pts, scales, boffs, bx, by, bz, ix, iy, iz, wids, counts, n_groups,
        n_levels, n_windows, words, part_pts, mask, perm, table, plan);
    return (int)cudaGetLastError();
}

extern "C" int grad_blocked_launch(const float* g, const float* pts,
                                   const float* scales, const int* boffs,
                                   float bx, float by, float bz, float ix,
                                   float iy, float iz, const unsigned* mask,
                                   const unsigned char* perm,
                                   const unsigned short* table,
                                   const int* plan, int* state,
                                   float* partial, int n_groups, int n_valid,
                                   int n_levels, int s_rows, int n_windows,
                                   int words, float* grad, void* stream) {
    // persistent blocks, as many as fit on the card at once
    static int blocks = 0;
    const size_t smem = grad_owner_smem();
    if (blocks == 0) {
        cudaError_t err = cudaFuncSetAttribute(
            grad_owner_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        int dev = 0, sms = 0, per_sm = 0;
        if (err == cudaSuccess) err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, grad_owner_kernel, GB_WARPS * 32, smem);
        if (err != cudaSuccess) return (int)err;
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        blocks = sms * per_sm;
    }
    cudaStream_t s = (cudaStream_t)stream;
    const cudaError_t err = cudaMemsetAsync(
        state, 0, sizeof(int) * ((size_t)n_levels * n_windows + 1), s);
    if (err != cudaSuccess) return (int)err;
    grad_owner_kernel<<<blocks, GB_WARPS * 32, smem, s>>>(
        g, pts, scales, boffs, bx, by, bz, ix, iy, iz, mask, perm, table,
        plan, state, reinterpret_cast<float4*>(partial), n_valid, n_groups,
        n_levels, s_rows, n_windows, words, grad);
    return (int)cudaGetLastError();
}
