// Cell, corner indices and trilinear weights of one (point, level) for the
// large-table encode and its gradient (encode_large.cu, grad_large.cu),
// in all three schemes. The plain version is
// nerfpp_tpu_torch/encoders/hashgrid.py (corner_indices, trilerp_weights).
//
// SCHEME 0 (fixed) and 1 (random) are small_geometry.cuh's arithmetic:
// the cell coordinate in the form jax.jit(corner_indices) computes, the
// 8 corners hashed with uint32 xor-of-products, & (T - 1). SCHEME 2
// (blocked): the cell from blocked_geometry.cuh's nerf_rel, the slot
// morton3((cell >> 2) + offset_l) & (T / 128 - 1), and corner d at lane
// (cell & 3) . (25, 5, 1) + (dx, dy, dz) . (25, 5, 1) of the slot's
// 128-entry row. For the blocked scheme ``geom`` holds each level's scale
// three times and ``ints`` its block offsets; otherwise they are the
// small-table encoder's cell sizes or scales and primes. Weights are
// (wx * wy) * wz with round-to-nearest products, as trilerp_weights takes
// them.
//
// large_cell_of computes what a (point, level)'s corners share, and
// large_corner one corner from it: the encode and the gradient's bin pass
// take all 8 corners (large_cell), the gradient's owner pass one, and all
// of them get the same bits.
#pragma once

#include "blocked_geometry.cuh"
#include "small_geometry.cuh"

struct LargeCell {
    unsigned u[3];         // cell coordinates (SCHEME 0, 1)
    unsigned p[3];         // the level's primes (SCHEME 0, 1)
    unsigned base;         // corner 0's entry (SCHEME 2)
    float f[3];            // fractions within the cell
};

template <int SCHEME>
__device__ __forceinline__ LargeCell large_cell_of(float x0, float x1,
                                                   float x2, int l,
                                                   const float* geom,
                                                   const int* ints,
                                                   const SmallGeom& s,
                                                   int level_size) {
    LargeCell c;
    const float xs[3] = {x0, x1, x2};
    const float mins[3] = {s.bx, s.by, s.bz};
    const float invs[3] = {s.ix, s.iy, s.iz};
    if (SCHEME != 2) {
        #pragma unroll
        for (int a = 0; a < 3; ++a) {
            const float r = small_rel<SCHEME>(xs[a], mins[a], invs[a],
                                              __ldg(geom + 3 * l + a));
            const float fl = floorf(r);
            c.u[a] = (unsigned)(int)fl;
            c.f[a] = __fsub_rn(r, fl);
            c.p[a] = (unsigned)__ldg(ints + 3 * l + a);
        }
        c.base = 0u;
        return c;
    }
    const float sc = __ldg(geom + 3 * l);
    int cell[3];
    #pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float r = nerf_rel(xs[a], mins[a], invs[a], sc);
        const float fl = floorf(r);
        cell[a] = (int)fl;
        c.f[a] = __fsub_rn(r, fl);
        c.u[a] = 0u;
        c.p[a] = 0u;
    }
    const int o0 = (cell[0] >> 2) + __ldg(ints + 3 * l + 0);
    const int o1 = (cell[1] >> 2) + __ldg(ints + 3 * l + 1);
    const int o2 = (cell[2] >> 2) + __ldg(ints + 3 * l + 2);
    const unsigned slot = (nerf_spread10((unsigned)o0)
                           | (nerf_spread10((unsigned)o1) << 1)
                           | (nerf_spread10((unsigned)o2) << 2))
                          & ((unsigned)(level_size / NERF_LANES) - 1u);
    c.base = slot * NERF_LANES + (cell[0] & 3) * 25 + (cell[1] & 3) * 5
             + (cell[2] & 3);
    return c;
}

// corner d (z fastest: bits (x, y, z) = (d >> 2, d >> 1, d) & 1): its entry
// within the level and its weight
template <int SCHEME>
__device__ __forceinline__ void large_corner(const LargeCell& c, int d,
                                             int level_size, unsigned& idx,
                                             float& w) {
    const unsigned dx = (d >> 2) & 1, dy = (d >> 1) & 1, dz = d & 1;
    if (SCHEME != 2) {
        const unsigned h = ((c.u[0] + dx) * c.p[0]) ^ ((c.u[1] + dy) * c.p[1])
                           ^ ((c.u[2] + dz) * c.p[2]);
        idx = h & ((unsigned)level_size - 1u);
    } else {
        idx = c.base + dx * 25 + dy * 5 + dz;
    }
    const float wx = dx ? c.f[0] : __fsub_rn(1.0f, c.f[0]);
    const float wy = dy ? c.f[1] : __fsub_rn(1.0f, c.f[1]);
    const float wz = dz ? c.f[2] : __fsub_rn(1.0f, c.f[2]);
    w = __fmul_rn(__fmul_rn(wx, wy), wz);
}

template <int SCHEME>
__device__ __forceinline__ void large_cell(float x0, float x1, float x2,
                                           int l, const float* geom,
                                           const int* ints,
                                           const SmallGeom& s,
                                           int level_size, unsigned idx[8],
                                           float w[8]) {
    const LargeCell c = large_cell_of<SCHEME>(x0, x1, x2, l, geom, ints, s,
                                              level_size);
    #pragma unroll
    for (int d = 0; d < 8; ++d)
        large_corner<SCHEME>(c, d, level_size, idx[d], w[d]);
}
