// Table gradient of the hashed-table encodes (encode_large.cu, and
// encode_small.cu's table through the same kernels), in the fixed, random
// and blocked schemes, at any power-of-two level size, summed in a fixed
// order with no float atomics.
//
// Replaces the XLA scatter-add that autodiff makes of the JAX package's
// f32 gather (nerfpp_tpu/encoders/hashgrid.py:408 gather_trilerp_reference,
// use_pallas_encoder=False), and the small-table backward
// (nerfpp_tpu/encoders/hashgrid.py:334, a one-hot matmul): for every
// point, level and corner, w_corner * g[n, l, f] is added to the corner's
// entry of the f32 gradient [L * T, 2]. Weights and products are f32 and
// match the plain version's (index_add_ over corner_indices) term for term.
//
// Bound on the H100: bytes. Per point it reads 12 B of coordinates and 8L
// B of cotangent; the gradient's touched 32-byte sectors are written
// (0.0256 ms on a train step's dense fine class at 16 x 2^19).
//
// Order: every entry's terms are added in an order fixed by the inputs, so
// two launches on the same inputs give bitwise equal gradients. A float
// atomicAdd would not, and on this card a shared-memory one is a
// compare-and-swap loop. Integer atomics only count and hand out work.
//
// Design (K3's, grad_blocked.cu, over hashed entries). A bin is 2^bin_log2
// consecutive entries of one level (1,024 at T = 2^19, 512 at T = 2^13,
// 2,048 from T = 2^20 on, the whole level up to T = 2^9): a warp's tile of
// at most 16 KB. The hash spreads a level's corners evenly over its bins
// even where points crowd into one cell. A record is one (point, corner)
// of a level, (point << 3 | corner); the records of all levels form one
// list sorted by (level, bin, tile of points, order within the tile:
// points 32 at a time, corners in order, lanes ascending), so each bin's
// records are one contiguous run.
// 1. The bin pass, three kernels. A task is one warp's (level, chunk of at
//    most 2,048 bins, tile of tile_pts points); a level of more bins than
//    a chunk (T > 2^22) is counted and placed chunk by chunk, so the
//    warp's counters stay 8 KB of shared memory at any T.
//    gl_count_kernel: each point's cell (large_geometry.cuh), its corners
//    counted per bin by shared-memory integer atomics, the counts written
//    to offs[level][bin][tile] and added to the bins' totals; the last
//    block to finish writes the plan: per bin its records, its parts (a
//    bin of n records is ceil(n / part) parts, one if it has none), its
//    first partial-sum slot and its first record (the exclusive scan of
//    the totals), then the items (bin, part) in bin order.
//    gl_scan_kernel, a warp per (level, bin): offs becomes the exclusive
//    scan of the counts in (level, bin, tile) order, where each run begins.
//    gl_place_kernel: the cells again (recomputing them costs less than
//    writing and reading 32 B of entries a (point, level)), each record at
//    its run's cursor plus its rank among the lanes of the same bin
//    (__match_any_sync, popcount of the lower lanes).
// 2. gl_owner_kernel, persistent blocks of 4 independent warps; each warp
//    takes the next item (an integer counter) and owns its bin's tile in
//    shared memory. It reads its part's records straight from the bin's
//    run, 32 x 4 at a time: each lane loads the point and its cotangent
//    (level-major, so a warp's loads of one level are contiguous),
//    recomputes the corner's entry and weight, and adds the product to the
//    tile (gl_add: same-entry runs of lanes summed first, then each lane's
//    own add when no two lanes share an entry, else a fixed shuffle tree).
//    A bin of one part is written from its tile once, zeros where no
//    corner fell (no zero fill of the gradient); a split bin's parts write
//    partial tiles, and the last part to finish adds them in part order.
//
// What costs: the owner pass's latency per record (loads, the recomputed
// cell, the fixed-order add) and the place kernel's ranks. Staging a
// tile's records in shared memory and writing them out run by run cut the
// place kernel from 0.94 to 0.39 ms on the dense fine class: written
// straight to their runs, every 4-byte record was a sector write of its
// own. Measured on an NVIDIA H100 80GB HBM3 at 700.00 W
// (profile_kernels.py --parent, this design against the float2-atomic
// kernel before it in one run; PERF.md): slower, 1.2116 ms on a train
// step's dense fine class at 16 x 2^19 against 0.6793 (the bin pass
// 0.5911 of it, chip_smoke.py), 1.4296 against 0.9595 on its coarse
// pass, 7.2833 against 4.3250 on 2^20 random points; as grad_small at 16
// x 2^13, 0.6200 against 0.2229 on the dense fine class.
#include <cuda_runtime.h>

#include "large_geometry.cuh"

#define GL_FULL 0xFFFFFFFFu
#define GL_BIN_WARPS 4                // tasks a bin-pass block takes
#define GL_OWN_WARPS 4                // independent warps of an owner block
#define GL_UNROLL 4                   // records a lane fetches at once
#define GL_PLAN 16                    // bins a plan thread takes
#define GL_BIN_LOG2_MAX 11            // 2,048 entries: a 16 KB tile
#define GL_CHUNK_LOG2 11              // bins a bin-pass task counts at once
#define GL_TILE_MAX 512               // points of a bin-pass tile

__device__ __forceinline__ int gl_scan(int v, int lane) {
    #pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int x = __shfl_up_sync(GL_FULL, v, d);
        if (lane >= d) v += x;
    }
    return v;
}

template <int SCHEME>
__device__ __forceinline__ LargeCell gl_cell(const float* pts, int p, int l,
                                             const float* geom,
                                             const int* ints,
                                             const SmallGeom& s,
                                             int level_size) {
    return large_cell_of<SCHEME>(__ldg(pts + 3LL * p), __ldg(pts + 3LL * p + 1),
                                 __ldg(pts + 3LL * p + 2), l, geom, ints, s,
                                 level_size);
}

// a bin-pass task's (level, chunk, tile), tiles fastest, and its chunk
struct GlTask {
    int l, c, t;
    int chunk_log2, n_chunks;
};

__device__ __forceinline__ GlTask gl_task(long long task, int n_bins,
                                          int n_tiles) {
    GlTask k;
    k.chunk_log2 = min(31 - __clz(n_bins), GL_CHUNK_LOG2);
    k.n_chunks = n_bins >> k.chunk_log2;
    const long long lc = task / n_tiles;
    k.t = (int)(task - lc * n_tiles);
    k.l = (int)(lc / k.n_chunks);
    k.c = (int)(lc - (long long)k.l * k.n_chunks);
    return k;
}

template <int SCHEME>
__global__ void __launch_bounds__(GL_BIN_WARPS * 32)
gl_count_kernel(const float* __restrict__ pts,          // [N, 3]
                const float* __restrict__ geom,         // [L, 3]
                const int* __restrict__ ints,           // [L, 3]
                SmallGeom s, int n, int n_levels, int level_size,
                int bin_log2, int tile_pts, int n_tiles, int part,
                int* __restrict__ offs,                 // [L, B, NT]
                int* __restrict__ plan) {
    extern __shared__ int gl_cnt[];                     // [warps, chunk]
    __shared__ int sums[3][GL_BIN_WARPS];
    __shared__ bool last;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_bins = level_size >> bin_log2;
    const int lb_total = n_levels * n_bins;
    int* totals = plan + 4;
    const long long task = (long long)blockIdx.x * GL_BIN_WARPS + warp;
    const GlTask k = gl_task(task, n_bins, n_tiles);

    if (task < (long long)n_levels * k.n_chunks * n_tiles) {
        const int chunk = 1 << k.chunk_log2;
        int* cnt = gl_cnt + warp * chunk;
        for (int i = lane; i < chunk; i += 32) cnt[i] = 0;
        __syncwarp();
        const int p0 = k.t * tile_pts;
        const int np = min(tile_pts, n - p0);
        for (int q = lane; q < np; q += 32) {
            const LargeCell c = gl_cell<SCHEME>(pts, p0 + q, k.l, geom, ints,
                                                s, level_size);
            #pragma unroll
            for (int d = 0; d < 8; ++d) {
                unsigned e;
                float w;
                large_corner<SCHEME>(c, d, level_size, e, w);
                const unsigned bin = e >> bin_log2;
                if ((int)(bin >> k.chunk_log2) == k.c)
                    atomicAdd(cnt + (bin & (unsigned)(chunk - 1)), 1);
            }
        }
        __syncwarp();
        const int b0 = k.c * chunk;
        int* col = offs + ((long long)k.l * n_bins + b0) * n_tiles + k.t;
        for (int i = lane; i < chunk; i += 32) {
            const int v = cnt[i];
            col[(long long)i * n_tiles] = v;
            if (v) atomicAdd(totals + k.l * n_bins + b0 + i, v);
        }
    }

    // the last block to finish (plan[2] counts them) writes the plan
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
        last = atomicAdd(plan + 2, 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    int* parts = totals + lb_total;
    int* slots = parts + lb_total;
    int* firsts = slots + lb_total;
    int* items = firsts + lb_total;
    // each thread takes GL_PLAN consecutive bins; one block scan per
    // GL_PLAN x 128 bins of (parts, parts of split bins, records)
    int acc[3] = {0, 0, 0};           // of the earlier bins
    for (int base = 0; base < lb_total; base += GL_PLAN * (int)blockDim.x) {
        const int i0 = base + (int)threadIdx.x * GL_PLAN;
        int v[3] = {0, 0, 0};
        for (int j = 0; j < GL_PLAN && i0 + j < lb_total; ++j) {
            const int c = __ldcg(totals + i0 + j);
            const int np = c == 0 ? 1 : (c + part - 1) / part;
            v[0] += np;
            v[1] += np > 1 ? np : 0;
            v[2] += c;
        }
        int at[3];
        #pragma unroll
        for (int m = 0; m < 3; ++m) {
            const int incl = gl_scan(v[m], lane);
            if (lane == 31) sums[m][warp] = incl;
            at[m] = acc[m] + incl - v[m];
        }
        __syncthreads();
        #pragma unroll
        for (int j = 0; j < GL_BIN_WARPS; ++j) {
            #pragma unroll
            for (int m = 0; m < 3; ++m) {
                at[m] += j < warp ? sums[m][j] : 0;
                acc[m] += sums[m][j];
            }
        }
        __syncthreads();             // the sums are reused
        for (int j = 0; j < GL_PLAN && i0 + j < lb_total; ++j) {
            const int i = i0 + j;
            const int c = __ldcg(totals + i);
            const int np = c == 0 ? 1 : (c + part - 1) / part;
            parts[i] = np;
            slots[i] = np > 1 ? at[1] : 0;
            firsts[i] = at[2];
            for (int r = 0; r < np; ++r) {
                items[2 * (at[0] + r)] = i;
                items[2 * (at[0] + r) + 1] = r;
            }
            at[0] += np;
            at[1] += np > 1 ? np : 0;
            at[2] += c;
        }
    }
    if (threadIdx.x == 0) {
        plan[0] = acc[0];
        plan[1] = acc[1];
        plan[2] = 0;
    }
}

// offs: each (level, bin)'s counts over the tiles become where its runs
// begin, its first record (the plan's) plus their exclusive scan
__global__ void __launch_bounds__(GL_BIN_WARPS * 32)
gl_scan_kernel(int* __restrict__ offs, const int* __restrict__ plan,
               int lb_total, int n_tiles) {
    const int lane = threadIdx.x & 31;
    const long long lb = (long long)blockIdx.x * GL_BIN_WARPS
                         + (threadIdx.x >> 5);
    if (lb >= lb_total) return;
    int carry = plan[4 + 3 * lb_total + lb];
    int* row = offs + lb * n_tiles;
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
        const int t = t0 + lane;
        const int v = t < n_tiles ? row[t] : 0;
        const int incl = gl_scan(v, lane);
        if (t < n_tiles) row[t] = carry + incl - v;
        carry += __shfl_sync(GL_FULL, incl, 31);
    }
}

template <int SCHEME>
__global__ void __launch_bounds__(GL_BIN_WARPS * 32)
gl_place_kernel(const float* __restrict__ pts,          // [N, 3]
                const float* __restrict__ geom,         // [L, 3]
                const int* __restrict__ ints,           // [L, 3]
                SmallGeom s, int n, int n_levels, int level_size,
                int bin_log2, int tile_pts, int n_tiles,
                const int* __restrict__ offs,           // [L, B, NT]
                int* __restrict__ recs) {               // [8 N L]
    // a warp's run cursors and offsets [chunk] each, then its stage [8 P]
    extern __shared__ __align__(16) int gl_place[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const unsigned below = (1u << lane) - 1u;
    const int n_bins = level_size >> bin_log2;
    const long long task = (long long)blockIdx.x * GL_BIN_WARPS + warp;
    const GlTask k = gl_task(task, n_bins, n_tiles);
    if (task >= (long long)n_levels * k.n_chunks * n_tiles) return;
    const int chunk = 1 << k.chunk_log2;
    int* cur = gl_place + warp * (2 * chunk + 4 * tile_pts);
    int* delta = cur + chunk;
    unsigned short* stage = reinterpret_cast<unsigned short*>(delta + chunk);
    // the tile's runs of the chunk's bins: each run's count is where the
    // next run begins less where it begins (offs runs in (level, bin,
    // tile) order over all 8 N L records); the runs laid out in bin order
    // in the stage; delta takes a staged record to its place in recs
    const long long n_runs = (long long)n_levels * n_bins * n_tiles;
    const long long n_recs = 8LL * n * n_levels;
    const long long f0 = ((long long)k.l * n_bins + k.c * chunk) * n_tiles
                         + k.t;
    int carry = 0;
    for (int i0 = 0; i0 < chunk; i0 += 32) {
        const int i = i0 + lane;
        int o = 0, c = 0;
        if (i < chunk) {
            const long long f = f0 + (long long)i * n_tiles;
            o = __ldg(offs + f);
            c = (int)((f + 1 < n_runs ? __ldg(offs + f + 1) : n_recs) - o);
        }
        const int incl = gl_scan(c, lane);
        if (i < chunk) {
            cur[i] = carry + incl - c;
            delta[i] = o - (carry + incl - c);
        }
        carry += __shfl_sync(GL_FULL, incl, 31);
    }
    __syncwarp();
    const int p0 = k.t * tile_pts;
    const int np = min(tile_pts, n - p0);
    // points 32 at a time, corners in order, lanes of one bin ranked by
    // lane, each record (q << 3 | d) staged at its run's cursor
    for (int q0 = 0; q0 < np; q0 += 32) {
        const int q = q0 + lane;
        const bool valid = q < np;
        const LargeCell c = gl_cell<SCHEME>(pts, p0 + (valid ? q : 0), k.l,
                                            geom, ints, s, level_size);
        #pragma unroll
        for (int d = 0; d < 8; ++d) {
            unsigned e;
            float w;
            large_corner<SCHEME>(c, d, level_size, e, w);
            const unsigned bin = e >> bin_log2;
            const bool mine = valid && (int)(bin >> k.chunk_log2) == k.c;
            const unsigned loc = bin & (unsigned)(chunk - 1);
            const unsigned peers = __match_any_sync(GL_FULL,
                                                    mine ? loc : GL_FULL);
            const int rank = __popc(peers & below);
            const int pos = mine ? cur[loc] + rank : 0;
            __syncwarp();
            if (mine && rank == 0) cur[loc] += __popc(peers);
            __syncwarp();
            if (mine) stage[pos] = (unsigned short)((q << 3) | d);
        }
    }
    __syncwarp();
    // out in stage order, so a warp's stores fill runs: staged record i
    // lies in the first run whose end (now cur) exceeds i
    for (int i = lane; i < carry; i += 32) {
        int b = 0;
        for (int step = chunk >> 1; step >= 1; step >>= 1)
            if (cur[b + step - 1] <= i) b += step;
        recs[i + delta[b]] = (p0 << 3) + stage[i];
    }
}

// add the lanes' products into the warp's tile, in a fixed order. Runs of
// lanes with the same entry (consecutive records of one cell) are first
// summed into each run's first lane by a segmented suffix sum. If no two of
// the remaining lanes hold one entry (a claim in shared memory: each
// writes its lane to its entry, and reads it back), each adds its own sum;
// otherwise lanes with the same entry are summed by a fixed shuffle tree
// (each round every lane adds the next remaining peer above it, then the
// odd ranks drop out) into the lowest, which adds the sum. The claim only
// chooses the path: both give the same bits. Distinct adding lanes have
// distinct entries, and __syncwarp orders the calls.
__device__ __forceinline__ void gl_add(float2* tile, unsigned char* claim,
                                       int e, float vx, float vy, bool ok,
                                       unsigned below, int lane) {
    const int prev = __shfl_up_sync(GL_FULL, e, 1);
    const unsigned oks = __ballot_sync(GL_FULL, ok);
    const bool cont = ok && lane > 0 && ((oks >> (lane - 1)) & 1u)
                      && e == prev;
    unsigned x = __ballot_sync(GL_FULL, cont);
    if (x) {
        // x: bit j set iff lanes j .. j + k - 1 all continue their runs
        for (int k = 1; k < 32 && x != 0u; k <<= 1) {
            const bool take = lane + k < 32 && ((x >> lane) & 2u) != 0u;
            const float ox = __shfl_down_sync(GL_FULL, vx, k);
            const float oy = __shfl_down_sync(GL_FULL, vy, k);
            if (take) {
                vx += ox;
                vy += oy;
            }
            x &= x >> k;
        }
        ok = ok && !cont;
    }
    if (ok) claim[e] = (unsigned char)lane;
    __syncwarp();
    if (!__any_sync(GL_FULL, ok && claim[e] != (unsigned char)lane)) {
        if (ok) {
            float2 a = tile[e];
            a.x += vx;
            a.y += vy;
            tile[e] = a;
        }
        __syncwarp();
        return;
    }
    const unsigned same = __match_any_sync(GL_FULL, ok ? (unsigned)e : GL_FULL);
    const unsigned peers = ok ? same : 0u;
    int rank = __popc(peers & below);
    unsigned rest = peers & ~(below | (1u << lane));
    while (__any_sync(GL_FULL, rest != 0u)) {
        const int next = __ffs(rest) - 1;
        const float ox = __shfl_sync(GL_FULL, vx, next & 31);
        const float oy = __shfl_sync(GL_FULL, vy, next & 31);
        if (next >= 0) {
            vx += ox;
            vy += oy;
        }
        rest &= __ballot_sync(GL_FULL, (rank & 1) == 0);
        rank >>= 1;
    }
    if (ok && (peers & below) == 0u) {
        float2 a = tile[e];
        a.x += vx;
        a.y += vy;
        tile[e] = a;
    }
    __syncwarp();
}

template <int SCHEME>
__global__ void __launch_bounds__(GL_OWN_WARPS * 32)
gl_owner_kernel(const float2* __restrict__ g,           // [L, N]
                const float* __restrict__ pts,          // [N, 3]
                const float* __restrict__ geom,         // [L, 3]
                const int* __restrict__ ints,           // [L, 3]
                SmallGeom s, int n, int n_levels, int level_size,
                int bin_log2, int part,
                const int* __restrict__ recs,
                const int* __restrict__ plan,
                int* __restrict__ state,                // [L * B + 1]
                float2* __restrict__ partial,           // [slots, bin]
                float2* __restrict__ grad) {            // [L * T]
    extern __shared__ __align__(16) float2 gl_tiles[];  // [warps, bin]
                                                        // + claims
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const unsigned below = (1u << lane) - 1u;
    const int bin = 1 << bin_log2;
    const int n_bins = level_size >> bin_log2;
    float2* tile = gl_tiles + warp * bin;
    unsigned char* claim = reinterpret_cast<unsigned char*>(
        gl_tiles + GL_OWN_WARPS * bin) + warp * bin;
    const int lb_total = n_levels * n_bins;
    const int* totals = plan + 4;
    const int* parts = totals + lb_total;
    const int* slots = parts + lb_total;
    const int* firsts = slots + lb_total;
    const int* items = firsts + lb_total;
    const int n_items = plan[0];
    const float2 zero = make_float2(0.0f, 0.0f);

    for (;;) {
        int item = 0;
        if (lane == 0) item = atomicAdd(state + lb_total, 1);
        item = __shfl_sync(GL_FULL, item, 0);
        if (item >= n_items) break;
        const int lb = items[2 * item];
        const int pt = items[2 * item + 1];
        const int n_parts = parts[lb];
        const int total = totals[lb];
        const int l = lb / n_bins;
        float2* out = grad + (long long)lb * bin;
        if (total == 0) {            // no corner in the bin: zeros
            for (int i = lane; i < bin; i += 32) out[i] = zero;
            continue;
        }
        for (int i = lane; i < bin; i += 32) tile[i] = zero;
        __syncwarp();
        const int* run = recs + firsts[lb];
        const int r1 = min(total, (pt + 1) * part);
        for (int j0 = pt * part; j0 < r1; j0 += 32 * GL_UNROLL) {
            bool ok[GL_UNROLL];
            int dd[GL_UNROLL];
            float x[GL_UNROLL][3];
            float2 cot[GL_UNROLL];
            #pragma unroll
            for (int u = 0; u < GL_UNROLL; ++u) {
                const int j = j0 + 32 * u + lane;
                ok[u] = j < r1;
                dd[u] = 0;
                x[u][0] = x[u][1] = x[u][2] = 0.0f;
                cot[u] = zero;
                if (ok[u]) {
                    const int rec = __ldg(run + j);
                    const long long p = rec >> 3;
                    dd[u] = rec & 7;
                    x[u][0] = __ldg(pts + 3 * p);
                    x[u][1] = __ldg(pts + 3 * p + 1);
                    x[u][2] = __ldg(pts + 3 * p + 2);
                    cot[u] = __ldg(g + (long long)l * n + p);
                }
            }
            #pragma unroll
            for (int u = 0; u < GL_UNROLL; ++u) {
                const LargeCell c = large_cell_of<SCHEME>(
                    x[u][0], x[u][1], x[u][2], l, geom, ints, s, level_size);
                unsigned e;
                float w;
                large_corner<SCHEME>(c, dd[u], level_size, e, w);
                gl_add(tile, claim, (int)(e & (unsigned)(bin - 1)),
                       __fmul_rn(w, cot[u].x), __fmul_rn(w, cot[u].y), ok[u],
                       below, lane);
            }
        }

        // one part: the bin; more: this part's slot, the last part to
        // finish adding the slots in part order into the bin
        float2* dst = n_parts == 1
            ? out : partial + (long long)(slots[lb] + pt) * bin;
        for (int i = lane; i < bin; i += 32) dst[i] = tile[i];
        if (n_parts > 1) {
            __threadfence();
            __syncwarp();
            int last = 0;
            if (lane == 0) last = atomicAdd(state + lb, 1) == n_parts - 1;
            if (__shfl_sync(GL_FULL, last, 0)) {
                __threadfence();
                const float2* src = partial + (long long)slots[lb] * bin;
                for (int i = lane; i < bin; i += 32) {
                    float2 acc = __ldcg(src + i);
                    #pragma unroll 8
                    for (int k = 1; k < n_parts; ++k) {
                        const float2 a = __ldcg(src + (long long)k * bin + i);
                        acc.x += a.x;
                        acc.y += a.y;
                    }
                    out[i] = acc;
                }
            }
        }
        __syncwarp();                // the tile is reused
    }
}

// what both launches take: a power-of-two level size (>= 128 for the
// blocked scheme), bins of at most 2^11 entries, at most 2^31 - 1 records
static bool gl_geometry_ok(long long n, int n_levels, int level_size,
                           int scheme, int bin_log2, int part) {
    return n >= 1 && n_levels >= 1 && level_size >= 1
           && (level_size & (level_size - 1)) == 0 && scheme >= 0
           && scheme <= 2 && (scheme != 2 || level_size >= NERF_LANES)
           && bin_log2 >= 0 && bin_log2 <= GL_BIN_LOG2_MAX
           && (1 << bin_log2) <= level_size && part >= 1
           && 8LL * n * n_levels <= 0x7FFFFFFFLL;
}

template <int SCHEME>
static int gl_bins_go(const float* pts, const float* geom, const int* ints,
                      SmallGeom s, int n, int n_levels, int level_size,
                      int bin_log2, int tile_pts, int part, int* recs,
                      int* offs, int* plan, cudaStream_t st) {
    const int n_bins = level_size >> bin_log2;
    const int bins_log2 = 31 - __builtin_clz((unsigned)n_bins);
    const int chunk_log2 = bins_log2 < GL_CHUNK_LOG2 ? bins_log2
                                                     : GL_CHUNK_LOG2;
    const int n_tiles = (n + tile_pts - 1) / tile_pts;
    const long long tasks = (long long)n_levels * (n_bins >> chunk_log2)
                            * n_tiles;
    const unsigned blocks = (unsigned)((tasks + GL_BIN_WARPS - 1)
                                       / GL_BIN_WARPS);
    const size_t smem = GL_BIN_WARPS * sizeof(int) << chunk_log2;
    // the place kernel's cursors, offsets and stage
    const size_t smem_place = GL_BIN_WARPS
        * ((2 * sizeof(int) << chunk_log2) + 16 * (size_t)tile_pts);
    static bool ready = false;
    if (!ready) {
        const cudaError_t e = cudaFuncSetAttribute(
            gl_place_kernel<SCHEME>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)(GL_BIN_WARPS * ((2 * sizeof(int) << GL_CHUNK_LOG2)
                                  + 16 * GL_TILE_MAX)));
        if (e != cudaSuccess) return (int)e;
        ready = true;
    }
    gl_count_kernel<SCHEME><<<blocks, GL_BIN_WARPS * 32, smem, st>>>(
        pts, geom, ints, s, n, n_levels, level_size, bin_log2, tile_pts,
        n_tiles, part, offs, plan);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int lb_total = n_levels * n_bins;
    gl_scan_kernel<<<(lb_total + GL_BIN_WARPS - 1) / GL_BIN_WARPS,
                     GL_BIN_WARPS * 32, 0, st>>>(offs, plan, lb_total,
                                                 n_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gl_place_kernel<SCHEME><<<blocks, GL_BIN_WARPS * 32, smem_place, st>>>(
        pts, geom, ints, s, n, n_levels, level_size, bin_log2, tile_pts,
        n_tiles, offs, recs);
    return (int)cudaGetLastError();
}

// The bin pass. scheme: 0 fixed, 1 random, 2 blocked; the geometry as
// kernels/hash_encode_large.py's bin_geometry gives it. recs [8 N L] int32;
// offs [L, B, NT] int32; plan [plan_len] int32 (4 + 4 L B + 2 items at
// most; zeroed here).
extern "C" int grad_large_bins_launch(const float* pts, const float* geom,
                                      const int* ints, float bx, float by,
                                      float bz, float ix, float iy, float iz,
                                      long long n, int n_levels,
                                      int level_size, int scheme,
                                      int bin_log2, int tile_pts, int part,
                                      int* recs, int* offs, int* plan,
                                      int plan_len, void* stream) {
    const SmallGeom s{bx, by, bz, ix, iy, iz};
    cudaStream_t st = (cudaStream_t)stream;
    if (!gl_geometry_ok(n, n_levels, level_size, scheme, bin_log2, part)
        || tile_pts < 32 || tile_pts > GL_TILE_MAX || (tile_pts & 31) != 0)
        return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaMemsetAsync(plan, 0,
                                            sizeof(int) * (size_t)plan_len,
                                            st);
    if (err != cudaSuccess) return (int)err;
    switch (scheme) {
    case 0:
        return gl_bins_go<0>(pts, geom, ints, s, (int)n, n_levels, level_size,
                             bin_log2, tile_pts, part, recs, offs, plan, st);
    case 1:
        return gl_bins_go<1>(pts, geom, ints, s, (int)n, n_levels, level_size,
                             bin_log2, tile_pts, part, recs, offs, plan, st);
    default:
        return gl_bins_go<2>(pts, geom, ints, s, (int)n, n_levels, level_size,
                             bin_log2, tile_pts, part, recs, offs, plan, st);
    }
}

template <int SCHEME>
static int gl_owner_go(const float2* g, const float* pts, const float* geom,
                       const int* ints, SmallGeom s, int n, int n_levels,
                       int level_size, int bin_log2, int part,
                       const int* recs, const int* plan, int* state,
                       float2* partial, float2* grad, cudaStream_t st) {
    // persistent blocks, as many as fit on the card at once, per bin size
    static int blocks[GL_BIN_LOG2_MAX + 1] = {};
    // a tile of float2 and a claim byte an entry, a warp
    const size_t smem = (sizeof(float2) + 1) * GL_OWN_WARPS
                        * ((size_t)1 << bin_log2);
    if (blocks[bin_log2] == 0) {
        cudaError_t err = cudaFuncSetAttribute(
            gl_owner_kernel<SCHEME>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)((sizeof(float2) + 1) * GL_OWN_WARPS
                  * (1 << GL_BIN_LOG2_MAX)));
        int dev = 0, sms = 0, per_sm = 0;
        if (err == cudaSuccess) err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, gl_owner_kernel<SCHEME>, GL_OWN_WARPS * 32, smem);
        if (err != cudaSuccess) return (int)err;
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        blocks[bin_log2] = sms * per_sm;
    }
    const int n_bins = level_size >> bin_log2;
    const cudaError_t err = cudaMemsetAsync(
        state, 0, sizeof(int) * ((size_t)n_levels * n_bins + 1), st);
    if (err != cudaSuccess) return (int)err;
    gl_owner_kernel<SCHEME><<<blocks[bin_log2], GL_OWN_WARPS * 32, smem,
                              st>>>(
        g, pts, geom, ints, s, n, n_levels, level_size, bin_log2, part, recs,
        plan, state, partial, grad);
    return (int)cudaGetLastError();
}

// The owner pass over the bin pass's records and plan, with the same
// geometry. state [L B + 1] int32 scratch; partial [slots, bin, 2] f32
// scratch (fewer than 2 (8 N L / part) + 1 slots); grad [L T, 2] f32,
// every entry written once; g the cotangent level-major, [L, N, 2] f32.
extern "C" int grad_large_launch(const float* g, const float* pts,
                                 const float* geom, const int* ints,
                                 float bx, float by, float bz, float ix,
                                 float iy, float iz, long long n,
                                 int n_levels, int level_size, int scheme,
                                 int bin_log2, int part, const int* recs,
                                 const int* plan, int* state, float* partial,
                                 float* grad, void* stream) {
    const SmallGeom s{bx, by, bz, ix, iy, iz};
    cudaStream_t st = (cudaStream_t)stream;
    float2* p2 = reinterpret_cast<float2*>(partial);
    float2* o2 = reinterpret_cast<float2*>(grad);
    const float2* g2 = reinterpret_cast<const float2*>(g);
    if (!gl_geometry_ok(n, n_levels, level_size, scheme, bin_log2, part))
        return (int)cudaErrorInvalidValue;
    switch (scheme) {
    case 0:
        return gl_owner_go<0>(g2, pts, geom, ints, s, (int)n, n_levels,
                              level_size, bin_log2, part, recs, plan, state,
                              p2, o2, st);
    case 1:
        return gl_owner_go<1>(g2, pts, geom, ints, s, (int)n, n_levels,
                              level_size, bin_log2, part, recs, plan, state,
                              p2, o2, st);
    default:
        return gl_owner_go<2>(g2, pts, geom, ints, s, (int)n, n_levels,
                              level_size, bin_log2, part, recs, plan, state,
                              p2, o2, st);
    }
}
