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
// 8 B, at most 4 MB) stays in L2. Next come the 8 random shared-memory
// gathers per point and level (about 3.5 bank wavefronts per warp-wide
// gather) and about a hundred operations per point and level.
//
// Design: persistent blocks, one per SM, that each serve one group of G
// levels for their whole life: 4 levels at T = 2^13 packed (more where the
// tables are smaller), so that each point's slice of its output row is a
// whole 32-byte sector. One thread stages the tables of the group's first
// S levels once, with 1-D bulk asynchronous copies (cp.async.bulk) that
// complete on an mbarrier while the threads load their first coordinates.
// Where fewer than 4 levels' tables fit beside the output tiles, a group
// still takes 4 levels and stages as many as fit (3 with the f32 table at
// 2^13, 1 at T = 2^15 packed), gathering the rest through the read-only
// path from L2 (the table, <= 4 MB, stays there): smaller groups would
// leave each row's slices under a sector, which L2 merges only while the
// groups' blocks stay close, and over a long launch they drift apart.
// Levels too large to stage at all make one group of every level,
// gathered from L2 and written as whole rows. The block walks a strided
// set of 1,024-point tiles, the blocks of the other groups walking the
// same tiles in the same order. Each warp works alone: its lanes compute
// 2 points each (two independent chains per lane), put each point's 2G
// features in the warp's own rows of shared memory (16-byte chunks,
// XOR-swizzled so that neither side conflicts), and copy them out
// so that each store instruction covers whole sectors of 16 rows; a row's
// sectors from the other groups' blocks meet it in L2. No block-wide
// barrier runs after the stage. Groups of 2 and 4 levels keep their
// constants in registers. The launch plan (G, S, grid) comes from
// kernels/hash_encode.py:small_plan.
//
// Measured on the H100 80GB HBM3 at 700 W (profile_kernels.py, parent and
// change in one call): 0.74-0.75 ms at the serving chunk (8,388,608 points,
// random scheme, packed), where PR 3's kernel (non-persistent blocks that
// staged every level anew, with an output-row tile) took 1.82 ms; the
// bound is 0.35 ms by bytes. PERF.md has the final numbers and the variants
// measured (fewer levels a group, levels gathered from L2, a cluster of
// blocks assembling whole rows in distributed shared memory).
#include <cuda_runtime.h>

#include "small_geometry.cuh"

#define ES_TILE 1024                // points per block and tile
#define ES_PTS 2                    // points per lane: 512 threads a block
#define ES_COPY_CHUNK (32 * 1024)   // bytes per bulk copy

__device__ __forceinline__ unsigned es_smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// one level of one point: 8 hashed corners blended with f32 weights, from
// the level's table at shared address slvl (staged) or at glvl in global
// memory; v holds the level's constants
template <int SCHEME, bool PACKED, bool STAGED>
__device__ __forceinline__ float2 es_level(const unsigned* glvl,
                                           unsigned slvl, float x, float y,
                                           float z, const SmallLevel& v,
                                           const SmallGeom& s,
                                           unsigned mask) {
    SmallCell c;
    small_cell_at<SCHEME>(x, y, z, v, s, mask, c);
    float a0 = 0.0f, a1 = 0.0f;
    #pragma unroll
    for (int d = 0; d < 8; ++d) {
        float v0, v1;
        if (PACKED) {
            unsigned e;
            if (STAGED)
                asm volatile("ld.shared.u32 %0, [%1];"
                             : "=r"(e) : "r"(slvl + (c.idx[d] << 2)));
            else
                e = __ldg(glvl + c.idx[d]);
            v0 = __uint_as_float(e & 0xFFFF0000u);
            v1 = __uint_as_float(e << 16);
        } else if (STAGED) {
            asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                         : "=f"(v0), "=f"(v1)
                         : "r"(slvl + (c.idx[d] << 3)));
        } else {
            const float2 e =
                __ldg(reinterpret_cast<const float2*>(glvl) + c.idx[d]);
            v0 = e.x;
            v1 = e.y;
        }
        a0 = __fmaf_rn(c.w[d], v0, a0);
        a1 = __fmaf_rn(c.w[d], v1, a1);
    }
    return make_float2(a0, a1);
}

// log2(v) for a power of two v, else -1
__device__ __forceinline__ int es_log2(int v) {
    return (v & (v - 1)) ? -1 : __ffs(v) - 1;
}

// MODE 0: every level gathered from L2; 1: every level staged; 2: the
// first staged_levels levels of each group staged, the rest from L2
template <int SCHEME, bool PACKED, int MODE>
__global__ void __launch_bounds__(ES_TILE / ES_PTS, 1)
encode_small_kernel(const unsigned* __restrict__ table,  // [L*T] u32 | [L*T] f2
                    const float* __restrict__ pts,       // [N, 3]
                    const float* __restrict__ geom,      // [L, 3]
                    const unsigned* __restrict__ primes, // [L, 3]
                    SmallGeom s, int n, int n_levels, int level_size,
                    int group_levels, int staged_levels,
                    float* __restrict__ out) {           // [N, 2L]
    // shared memory: [the group's staged tables | one tile of 32 * PTS rows
    // per warp, q 16-byte chunks each]
    constexpr int PTS = ES_PTS;
    constexpr int ROWS = 32 * PTS;
    extern __shared__ __align__(128) unsigned char smem[];
    __shared__ __align__(8) unsigned long long full;   // the stage's mbarrier
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int G = group_levels;
    const int n_groups = (n_levels + G - 1) / G;
    const int l0 = (int)(blockIdx.x % n_groups) * G;   // this block's levels
    const int gl = min(G, n_levels - l0);
    const int words = PACKED ? level_size : 2 * level_size;  // 4 B words
    const int S = MODE == 0 ? 0 : MODE == 1 ? G : staged_levels;
    const int stage_bytes = S * words * 4;
    const unsigned bar = es_smem_addr(&full);
    if (MODE != 0) {
        if (t == 0) {
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                         :: "r"(bar) : "memory");
            asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        }
        __syncthreads();
        if (t == 0) {
            const unsigned bytes = (unsigned)min(S, gl) * (unsigned)words * 4u;
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], "
                         "%1;" :: "r"(bar), "r"(bytes) : "memory");
            const unsigned char* src = reinterpret_cast<const unsigned char*>(
                table + (size_t)l0 * words);
            for (unsigned off = 0; off < bytes; off += ES_COPY_CHUNK) {
                const unsigned len = min((unsigned)ES_COPY_CHUNK, bytes - off);
                asm volatile(
                    "cp.async.bulk.shared::cluster.global.mbarrier::"
                    "complete_tx::bytes [%0], [%1], %2, [%3];"
                    :: "r"(es_smem_addr(smem + off)), "l"(src + off),
                       "r"(len), "r"(bar) : "memory");
            }
        }
    }
    const int q = (G + 1) >> 1;                  // 16-byte chunks per row
    float4* tile = reinterpret_cast<float4*>(smem + stage_bytes)
                   + warp * ROWS * q;
    // chunk c of tile row r is tile[r * q + (c ^ ((r >> sw_sh) & sw_m))]:
    // XOR-swizzled when q is a power of two, so that 8 consecutive rows'
    // chunk c fall in 8 distinct 16-byte bank groups
    const int lq = es_log2(q);
    const int sw_m = lq < 0 ? 0 : min(q, 8) - 1;
    const int sw_sh = lq < 0 || lq >= 3 ? 0 : 3 - lq;
    const int row = 2 * n_levels;                // floats per output row
    // 16-byte stores when rows and the slice are 16-byte aligned
    const bool vec = ((n_levels | l0 | gl) & 1) == 0;
    const int units = vec ? gl / 2 : gl;         // stores per row
    const int ush = es_log2(units);
    const unsigned mask = (unsigned)level_size - 1u;
    const long long tiles = ((long long)n + ES_TILE - 1) / ES_TILE;
    const long long stride = gridDim.x / n_groups;
    long long tile_i = blockIdx.x / n_groups;
    float x[PTS], y[PTS], z[PTS];
    auto load = [&](long long ti, float (&px)[PTS], float (&py)[PTS],
                    float (&pz)[PTS]) {
        #pragma unroll
        for (int p = 0; p < PTS; ++p) {
            const long long i = ti * ES_TILE + warp * ROWS + p * 32 + lane;
            px[p] = py[p] = pz[p] = 0.0f;
            if (ti < tiles && i < n) {
                px[p] = pts[3 * i];
                py[p] = pts[3 * i + 1];
                pz[p] = pts[3 * i + 2];
            }
        }
    };
    load(tile_i, x, y, z);
    if (MODE != 0) {
        unsigned done = 0;
        while (!done) {
            asm volatile("{\n\t.reg .pred p;\n\t"
                         "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
                         "0;\n\tselp.u32 %0, 1, 0, p;\n}"
                         : "=r"(done) : "r"(bar) : "memory");
        }
    }
    const unsigned* gbase = table + (size_t)l0 * words;
    const unsigned sbase = es_smem_addr(smem);
    int rq[PTS], rsw[PTS];                       // this lane's tile rows
    #pragma unroll
    for (int p = 0; p < PTS; ++p) {
        rq[p] = (p * 32 + lane) * q;
        rsw[p] = ((p * 32 + lane) >> sw_sh) & sw_m;
    }
    // level k (constants v) of one point, from the stage or from L2
    auto level = [&](int k, const SmallLevel& v, float px, float py,
                     float pz) {
        if (MODE == 1 || (MODE == 2 && k < S))
            return es_level<SCHEME, PACKED, true>(
                gbase, sbase + 4u * k * words, px, py, pz, v, s, mask);
        return es_level<SCHEME, PACKED, false>(
            gbase + (size_t)k * words, 0u, px, py, pz, v, s, mask);
    };
    // levels k and k + 1 (constants va, vb) of the lane's points, into
    // chunk k / 2 of their tile rows; an odd group's last level alone
    auto pair = [&](int k, const SmallLevel& va, const SmallLevel& vb) {
        float2 a[PTS], b[PTS];
        #pragma unroll
        for (int p = 0; p < PTS; ++p) {
            a[p] = level(k, va, x[p], y[p], z[p]);
            b[p] = level(k + 1, vb, x[p], y[p], z[p]);
        }
        #pragma unroll
        for (int p = 0; p < PTS; ++p)
            tile[rq[p] + ((k >> 1) ^ rsw[p])] =
                make_float4(a[p].x, a[p].y, b[p].x, b[p].y);
    };
    auto single = [&](int k, const SmallLevel& va) {
        #pragma unroll
        for (int p = 0; p < PTS; ++p)
            *reinterpret_cast<float2*>(tile + rq[p] + ((k >> 1) ^ rsw[p])) =
                level(k, va, x[p], y[p], z[p]);
    };
    // groups of 2 and 4 levels (the staged serving shapes) keep their
    // constants in registers for the block's life
    SmallLevel lv[4];
    #pragma unroll
    for (int k = 0; k < 4; ++k)
        lv[k] = small_level(l0 + min(k, gl - 1), geom, primes);
    for (; tile_i < tiles; tile_i += stride) {
        // the next tile's coordinates load while this one computes
        float xn[PTS], yn[PTS], zn[PTS];
        load(tile_i + stride, xn, yn, zn);
        if (gl == 4) {
            pair(0, lv[0], lv[1]);
            pair(2, lv[2], lv[3]);
        } else if (gl == 2) {
            pair(0, lv[0], lv[1]);
        } else {
            int k = 0;
            for (; k + 1 < gl; k += 2)
                pair(k, small_level(l0 + k, geom, primes),
                     small_level(l0 + k + 1, geom, primes));
            if (k < gl) single(k, small_level(l0 + k, geom, primes));
        }
        __syncwarp();
        // this warp's rows, slice [2 l0, 2 (l0 + gl)) of each: consecutive
        // lanes store consecutive 16 (or 8) bytes of a row
        const long long r0 = tile_i * ES_TILE + warp * ROWS;
        const int nrows = (int)max(0LL, min((long long)ROWS, (long long)n - r0));
        float* o = out + r0 * row + 2 * l0;
        auto store = [&](int r, int u) {
            const int sw = (r >> sw_sh) & sw_m;
            if (vec) {
                *reinterpret_cast<float4*>(o + (long long)r * row + 4 * u) =
                    tile[r * q + (u ^ sw)];
            } else {
                *reinterpret_cast<float2*>(o + (long long)r * row + 2 * u) =
                    reinterpret_cast<const float2*>(
                        tile + r * q + ((u >> 1) ^ sw))[u & 1];
            }
        };
        if (ush >= 0) {
            for (int j = lane; j < nrows * units; j += 32)
                store(j >> ush, j & (units - 1));
        } else {                                 // odd level counts
            for (int j = lane; j < nrows * units; j += 32)
                store(j / units, j % units);
        }
        __syncwarp();                            // the rows are read
        #pragma unroll
        for (int p = 0; p < PTS; ++p) {
            x[p] = xn[p];
            y[p] = yn[p];
            z[p] = zn[p];
        }
    }
}

typedef void (*EsKernel)(const unsigned*, const float*, const float*,
                         const unsigned*, SmallGeom, int, int, int, int, int,
                         float*);

// the kernel for a group of g levels with s of them staged
static EsKernel es_pick(int scheme, int packed, int g, int s) {
    static const EsKernel k[2][2][3] = {
        {{encode_small_kernel<0, false, 0>, encode_small_kernel<0, false, 1>,
          encode_small_kernel<0, false, 2>},
         {encode_small_kernel<0, true, 0>, encode_small_kernel<0, true, 1>,
          encode_small_kernel<0, true, 2>}},
        {{encode_small_kernel<1, false, 0>, encode_small_kernel<1, false, 1>,
          encode_small_kernel<1, false, 2>},
         {encode_small_kernel<1, true, 0>, encode_small_kernel<1, true, 1>,
          encode_small_kernel<1, true, 2>}}};
    if (g < 1 || s < 0 || s > g) return nullptr;
    return k[scheme != 0][packed != 0][s == 0 ? 0 : s == g ? 1 : 2];
}

static int es_prepare(EsKernel kernel, int smem) {
    return (int)cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
}

// Blocks of the kernel that one SM holds at once with ``smem`` bytes of
// dynamic shared memory (registers, threads and shared memory together),
// and the card's SM count.
extern "C" int encode_small_occupancy(int scheme, int packed,
                                      int group_levels, int staged_levels,
                                      int smem, int* blocks, int* sms) {
    const EsKernel kernel =
        es_pick(scheme, packed, group_levels, staged_levels);
    if (kernel == nullptr) return (int)cudaErrorInvalidConfiguration;
    int e = es_prepare(kernel, smem);
    if (e != 0) return e;
    int dev = 0;
    e = (int)cudaGetDevice(&dev);
    if (e != 0) return e;
    e = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != 0) return e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, (const void*)kernel, ES_TILE / ES_PTS, (size_t)smem);
}

// scheme: 0 fixed, 1 random; packed: table is [L*T] u32, else [L*T, 2] f32.
// The table must be 16-byte aligned and T a power of two, multiple of 1,024.
// The plan: group_levels G and staged_levels S (the first S levels of each
// group staged in shared memory, the rest gathered from L2), smem bytes per
// block (the stage and the warps' tiles), and a grid that is a multiple of
// the group count.
extern "C" int encode_small_launch(const void* table, const float* pts,
                                   const float* geom, const int* primes,
                                   float bx, float by, float bz, float ix,
                                   float iy, float iz, int n, int n_levels,
                                   int level_size, int scheme, int packed,
                                   int group_levels, int staged_levels,
                                   int grid, int smem, float* out,
                                   void* stream) {
    const SmallGeom s{bx, by, bz, ix, iy, iz};
    const EsKernel kernel = es_pick(scheme, packed, group_levels,
                                    staged_levels);
    if (kernel == nullptr || n_levels < 1)
        return (int)cudaErrorInvalidConfiguration;
    const int n_groups = (n_levels + group_levels - 1) / group_levels;
    const long long stage =
        (long long)staged_levels * level_size * (packed ? 4 : 8);
    const long long tiles = (long long)ES_TILE * ((group_levels + 1) / 2) * 16;
    if (grid < n_groups || grid % n_groups != 0 || stage + tiles > smem)
        return (int)cudaErrorInvalidConfiguration;
    const int e = es_prepare(kernel, smem);
    if (e != 0) return e;
    kernel<<<grid, ES_TILE / ES_PTS, smem, (cudaStream_t)stream>>>(
        reinterpret_cast<const unsigned*>(table), pts, geom,
        reinterpret_cast<const unsigned*>(primes), s, n, n_levels,
        level_size, group_levels, staged_levels, out);
    return (int)cudaGetLastError();
}
