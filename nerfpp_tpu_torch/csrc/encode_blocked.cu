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
// Bound on the H100: bytes. Per point it reads 12 B of coordinates and
// writes 8L B of features (128 B at L = 16); per (group, level) it reads the
// window count and the unique window ids (4 B each); and it reads the
// touched 512 B rows of the 33.5 MB packed table, which stays in L2. The
// arithmetic is a few dozen operations per point and level.
//
// Design: a block of 4 teams of 128 threads; each team owns one
// 128-point group across all levels, one point per thread, and syncs only
// with itself (named barriers, bar.sync id, 128). The coordinates are read
// once, into registers. Per level the team turns its group's sorted unique
// window ids (K1, window_lists.cu) into the table rows its points use: each
// point finds its window's position in the list and marks (window, row of
// the window) in a 1,024-bit map; after a team barrier a warp-wide scan of
// the map's popcounts gives every used row a slot, and after a second the
// team copies the first EB_BATCH_ROWS used rows with 16-byte asynchronous
// copies (cp.async) into one of two row buffers by level parity, so level
// l + 1's rows are found and arrive while level l is read (the first of the
// two barriers also covers level l's rows). A point whose row has a later
// slot (at the fine levels, where most rows serve one point) reads its 8
// corners from the L2-resident table instead, so no level waits for a
// second batch. Each point's features collect in shared memory, 4 levels
// at a time, and leave as 32-byte slices of the output rows (each a whole
// sector: partial sectors cost PR 1's kernel most of its time), each store
// instruction covering 8 rows. Three blocks share an SM (12 teams), and each
// team stages 4 rows a level, which measured faster than 8, 16 or 32
// (PERF.md).
//
// Measured on the H100 80GB HBM3 at 700 W (profile_kernels.py, parent and
// change in one call): 1.10-1.11 ms at the flagship chunk (4,194,304
// points), where PR 1's kernel (one block per (group, level), staging all 8
// rows of every window between block-wide barriers, 8 B written per point
// and level) took 3.25-3.30 ms; the bound is 0.18 ms by bytes. PERF.md has
// the final numbers, and the measured alternative for the K1 redesign:
// gathering each point's corners straight from the L2-resident table,
// with no window list, took about half this kernel's time.
#include <cuda_runtime.h>

#include "blocked_geometry.cuh"

#define EB_TEAMS 4         // 128-point groups per block
#define EB_BATCH_ROWS 4    // table rows a team stages per level
#define EB_ROW_PIECES (NERF_LANES / 4)   // 16-byte pieces per table row
#define EB_SLICE 4      // levels per output slice: 32 bytes, one sector

__device__ __forceinline__ unsigned eb_smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void eb_team_sync(int team) {
    asm volatile("bar.sync %0, %1;" :: "r"(team + 1), "n"(NERF_LANES)
                 : "memory");
}

// shared memory of one team: [2 row buffers of EB_BATCH_ROWS rows of 128
// lanes | output slices, 128 rows of 4 levels | 2 x window ids (128) | 2 x
// row map (32 words) | 2 x used rows (128)], the pairs by level parity
#define EB_TEAM_BYTES (2 * EB_BATCH_ROWS * NERF_LANES * 4 \
                       + NERF_LANES * EB_SLICE * 2 * 4 \
                       + 2 * (NERF_LANES + 32 + NERF_LANES) * 4)
#define EB_SMEM (EB_TEAMS * EB_TEAM_BYTES)
// within the default 48 KB a block, so 3 blocks of 512 threads share an SM
static_assert(EB_SMEM <= 48 * 1024, "encode_blocked's shared memory");

// the float2 of level k (of its slice) in row r of the output slices: the
// unit index XOR-swizzled by r / 4, so that a half-warp's 16 rows (writes)
// and 4 rows' 4 units (reads) fall in distinct banks
__device__ __forceinline__ int eb_unit(int r, int k) {
    return r * EB_SLICE + (k ^ ((r >> 2) & (EB_SLICE - 1)));
}

// one point's cell at level l: the window id, the row in the window, the
// lane of corner 0 in its row, and the three axes' weights
struct EbCell {
    int mq, rr, base;
    float wx[2], wy[2], wz[2];
};

__device__ __forceinline__ EbCell eb_cell(float px, float py, float pz,
                                          int l, const float* scales,
                                          const int* boffs, float bx,
                                          float by, float bz, float ix,
                                          float iy, float iz) {
    const float scale = __ldg(scales + l);
    const float r0 = nerf_rel(px, bx, ix, scale);
    const float r1 = nerf_rel(py, by, iy, scale);
    const float r2 = nerf_rel(pz, bz, iz, scale);
    const float fl0 = floorf(r0), fl1 = floorf(r1), fl2 = floorf(r2);
    const int c0 = (int)fl0, c1 = (int)fl1, c2 = (int)fl2;
    const float f0 = __fsub_rn(r0, fl0);
    const float f1 = __fsub_rn(r1, fl1);
    const float f2 = __fsub_rn(r2, fl2);
    const int o0 = (c0 >> 2) + __ldg(boffs + 3 * l + 0);
    const int o1 = (c1 >> 2) + __ldg(boffs + 3 * l + 1);
    const int o2 = (c2 >> 2) + __ldg(boffs + 3 * l + 2);
    EbCell c;
    c.mq = (int)(nerf_spread10((unsigned)(o0 >> 1))
                 | (nerf_spread10((unsigned)(o1 >> 1)) << 1)
                 | (nerf_spread10((unsigned)(o2 >> 1)) << 2));
    c.rr = (o0 & 1) | ((o1 & 1) << 1) | ((o2 & 1) << 2);
    c.base = (c0 & 3) * 25 + (c1 & 3) * 5 + (c2 & 3);
    c.wx[0] = 1.0f - f0;
    c.wx[1] = f0;
    c.wy[0] = 1.0f - f1;
    c.wy[1] = f1;
    c.wz[0] = 1.0f - f2;
    c.wz[1] = f2;
    return c;
}

// the 8 corners of one point at one level, from its row at lane base
template <bool GLOBAL>
__device__ __forceinline__ void eb_blend(const unsigned* src,
                                         const EbCell& c, float& acc0,
                                         float& acc1) {
    #pragma unroll
    for (int d = 0; d < 8; ++d) {
        const int off = ((d >> 2) & 1) * 25 + ((d >> 1) & 1) * 5 + (d & 1);
        const unsigned v = GLOBAL ? __ldg(src + c.base + off)
                                  : src[c.base + off];
        const float w = c.wx[(d >> 2) & 1] * c.wy[(d >> 1) & 1]
                        * c.wz[d & 1];
        acc0 += w * __uint_as_float(v & 0xFFFF0000u);
        acc1 += w * __uint_as_float(v << 16);
    }
}

__global__ void __launch_bounds__(EB_TEAMS * NERF_LANES, 3)
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
    extern __shared__ __align__(16) unsigned char smem[];
    const int team = threadIdx.x / NERF_LANES;
    const int t = threadIdx.x % NERF_LANES;
    const int lane = t & 31;
    const int g = blockIdx.x * EB_TEAMS + team;
    if (g >= n_groups) return;      // the whole team: teams sync apart
    const int row = 2 * n_levels;
    constexpr int pieces = EB_BATCH_ROWS * EB_ROW_PIECES;  // per row buffer
    unsigned char* mine = smem + team * EB_TEAM_BYTES;
    int4* buf = reinterpret_cast<int4*>(mine);
    float2* slices = reinterpret_cast<float2*>(buf + 2 * pieces);
    int* ids = reinterpret_cast<int*>(slices + NERF_LANES * EB_SLICE);
    unsigned* bits = reinterpret_cast<unsigned*>(ids + 2 * NERF_LANES);
    int* rows = reinterpret_cast<int*>(bits + 2 * 32);

    const float* p = pts + ((long long)g * NERF_LANES + t) * 3;
    const float px = p[0], py = p[1], pz = p[2];
    const unsigned row_mask = (unsigned)s_rows - 1u;
    const long long level_ints = (long long)s_rows * NERF_LANES;
    // after the last level of a slice: the team's 128 rows of it leave
    // together, each store instruction covering 8 rows' 32-byte sectors
    auto flush = [&](int l) {
        if ((l & (EB_SLICE - 1)) != EB_SLICE - 1 && l != n_levels - 1)
            return false;
        eb_team_sync(team);
        const int units = (l & (EB_SLICE - 1)) + 1;
        float* o = out + (long long)g * NERF_LANES * row
                   + 2 * (l & ~(EB_SLICE - 1));
        auto store = [&](int r, int u) {
            *reinterpret_cast<float2*>(o + (long long)r * row + 2 * u) =
                slices[eb_unit(r, u)];
        };
        if (units == EB_SLICE) {
            #pragma unroll
            for (int i = 0; i < EB_SLICE; ++i)
                store(t / EB_SLICE + i * (NERF_LANES / EB_SLICE),
                      t % EB_SLICE);
        } else {                      // the last levels, L not a multiple
            for (int j = t; j < NERF_LANES * units; j += NERF_LANES)
                store(j / units, j % units);
        }
        return true;
    };
    // level 0's window list and a clear map; level 1's list in registers
    int cnt = counts[g];
    if (t < cnt) ids[t] = wids[(long long)g * NERF_LANES + t];
    if (t < 32) bits[t] = 0u;
    int cnt_next = 0, id_next = 0;
    if (n_levels > 1) {
        const long long gl = (long long)n_groups + g;
        cnt_next = counts[gl];
        if (t < cnt_next) id_next = wids[gl * NERF_LANES + t];
    }
    eb_team_sync(team);
    // the table rows this team uses at level l, each with a slot, in
    // two steps around a team barrier. mark: the point's window is
    // found in the sorted unique list and (window, row of the window)
    // is marked in a 1,024-bit map; the next level's list and a clear
    // map are set up alongside (ids, bits and rows alternate by level
    // parity). number: a warp-wide scan of the map's popcounts numbers
    // the marks, giving the point's slot and the row list.
    auto mark = [&](int l, EbCell& c) {
        const int q = l & 1;
        c = eb_cell(px, py, pz, l, scales, boffs, bx, by, bz, ix, iy, iz);
        int lo = 0, hi = cnt;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (ids[q * NERF_LANES + mid] < c.mq) lo = mid + 1;
            else hi = mid;
        }
        const int key = lo * 8 + c.rr;        // (window, row), < 1,024
        atomicOr(bits + q * 32 + (key >> 5), 1u << (key & 31));
        if (l + 1 < n_levels) {
            if (t < cnt_next) ids[(q ^ 1) * NERF_LANES + t] = id_next;
            if (t < 32) bits[(q ^ 1) * 32 + t] = 0u;
            cnt = cnt_next;
            if (l + 2 < n_levels) {
                const long long gl = (long long)(l + 2) * n_groups + g;
                cnt_next = counts[gl];
                if (t < cnt_next) id_next = wids[gl * NERF_LANES + t];
            }
        }
        return key;
    };
    auto number = [&](int l, int key, unsigned trow, int& used) {
        const int q = l & 1;
        const unsigned word = bits[q * 32 + lane];
        const int pc = __popc(word);
        int incl = pc;
        #pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
            if (lane >= o) incl += v;
        }
        used = __shfl_sync(0xFFFFFFFFu, incl, 31);
        const int before = __shfl_sync(0xFFFFFFFFu, incl - pc, key >> 5);
        const unsigned wb = __shfl_sync(0xFFFFFFFFu, word, key >> 5);
        const int slot = before + __popc(wb & ((1u << (key & 31)) - 1u));
        rows[q * NERF_LANES + slot] = (int)trow;
        return slot;
    };
    // level l's first EB_BATCH_ROWS used rows into row buffer l & 1:
    // 16-byte asynchronous copies, one commit group
    auto stage = [&](int l, int used) {
        const int q = l & 1;
        const int4* tab = reinterpret_cast<const int4*>(
            table + l * level_ints);
        int4* dst = buf + q * pieces;
        for (int j = t; j < pieces; j += NERF_LANES) {
            const int sl = j / EB_ROW_PIECES;
            if (sl < used)
                asm volatile(
                    "cp.async.cg.shared.global [%0], [%1], 16;"
                    :: "r"(eb_smem_addr(dst + j)),
                       "l"(tab + (long long)rows[q * NERF_LANES + sl]
                                 * EB_ROW_PIECES + (j % EB_ROW_PIECES))
                    : "memory");
        }
        asm volatile("cp.async.commit_group;" ::: "memory");
    };
    auto table_row = [&](const EbCell& c) {
        return (((unsigned)c.mq << 3) + (unsigned)c.rr) & row_mask;
    };
    EbCell c;
    int used, key = mark(0, c);
    unsigned trow = table_row(c);
    eb_team_sync(team);
    int slot = number(0, key, trow, used);
    eb_team_sync(team);
    stage(0, used);
    for (int l = 0; l < n_levels; ++l) {
        // level l + 1's cells are found and marked while level l's rows
        // land; one barrier then covers both, a second one level l + 1's
        // row list, and its rows start to arrive while level l is read
        const bool more = l + 1 < n_levels;
        EbCell cn = c;
        int keyn = 0, slotn = 0;
        if (more) keyn = mark(l + 1, cn);
        const unsigned trown = table_row(cn);
        asm volatile("cp.async.wait_group 0;" ::: "memory");
        eb_team_sync(team);
        if (more) {
            slotn = number(l + 1, keyn, trown, used);
            eb_team_sync(team);
            stage(l + 1, used);
        }
        float acc0 = 0.0f, acc1 = 0.0f;
        if (slot < EB_BATCH_ROWS) {
            eb_blend<false>(reinterpret_cast<const unsigned*>(
                                buf + (l & 1) * pieces)
                            + slot * NERF_LANES, c, acc0, acc1);
        } else {
            // a row past the staged ones: read from L2
            eb_blend<true>(reinterpret_cast<const unsigned*>(
                               table + l * level_ints)
                           + trow * NERF_LANES, c, acc0, acc1);
        }
        slices[eb_unit(t, l & (EB_SLICE - 1))] = make_float2(acc0, acc1);
        flush(l);   // the next level's slices follow a team barrier
        c = cn;
        trow = trown;
        slot = slotn;
    }
}

extern "C" int encode_blocked_launch(const int* table, const float* pts,
                                     const int* wids, const int* counts,
                                     const float* scales, const int* boffs,
                                     float bx, float by, float bz, float ix,
                                     float iy, float iz, int n_groups,
                                     int n_levels, int s_rows, float* out,
                                     void* stream) {
    if (n_groups < 1 || n_levels < 1)
        return (int)cudaErrorInvalidConfiguration;
    const int grid = (n_groups + EB_TEAMS - 1) / EB_TEAMS;
    encode_blocked_kernel<<<grid, EB_TEAMS * NERF_LANES, EB_SMEM,
                            (cudaStream_t)stream>>>(
        table, pts, wids, counts, scales, boffs, bx, by, bz, ix, iy, iz,
        n_groups, n_levels, s_rows, out);
    return (int)cudaGetLastError();
}
