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
#pragma once

#include "blocked_geometry.cuh"
#include "small_geometry.cuh"

template <int SCHEME>
__device__ __forceinline__ void large_cell(float x0, float x1, float x2,
                                           int l, const float* geom,
                                           const int* ints,
                                           const SmallGeom& s,
                                           int level_size, unsigned idx[8],
                                           float w[8]) {
    if (SCHEME != 2) {
        SmallCell c;
        small_cell<SCHEME>(x0, x1, x2, l, geom,
                           reinterpret_cast<const unsigned*>(ints), s,
                           (unsigned)level_size - 1u, c);
        #pragma unroll
        for (int d = 0; d < 8; ++d) {
            idx[d] = c.idx[d];
            w[d] = c.w[d];
        }
        return;
    }
    const float sc = __ldg(geom + 3 * l);
    const float r0 = nerf_rel(x0, s.bx, s.ix, sc);
    const float r1 = nerf_rel(x1, s.by, s.iy, sc);
    const float r2 = nerf_rel(x2, s.bz, s.iz, sc);
    const float fl0 = floorf(r0), fl1 = floorf(r1), fl2 = floorf(r2);
    const int c0 = (int)fl0, c1 = (int)fl1, c2 = (int)fl2;
    const float f0 = __fsub_rn(r0, fl0);
    const float f1 = __fsub_rn(r1, fl1);
    const float f2 = __fsub_rn(r2, fl2);
    const int o0 = (c0 >> 2) + __ldg(ints + 3 * l + 0);
    const int o1 = (c1 >> 2) + __ldg(ints + 3 * l + 1);
    const int o2 = (c2 >> 2) + __ldg(ints + 3 * l + 2);
    const unsigned slot = (nerf_spread10((unsigned)o0)
                           | (nerf_spread10((unsigned)o1) << 1)
                           | (nerf_spread10((unsigned)o2) << 2))
                          & ((unsigned)(level_size / NERF_LANES) - 1u);
    const unsigned base = slot * NERF_LANES + (c0 & 3) * 25 + (c1 & 3) * 5
                          + (c2 & 3);
    const float wx[2] = {__fsub_rn(1.0f, f0), f0};
    const float wy[2] = {__fsub_rn(1.0f, f1), f1};
    const float wz[2] = {__fsub_rn(1.0f, f2), f2};
    #pragma unroll
    for (int d = 0; d < 8; ++d) {
        const int dx = (d >> 2) & 1, dy = (d >> 1) & 1, dz = d & 1;
        idx[d] = base + dx * 25 + dy * 5 + dz;
        w[d] = __fmul_rn(__fmul_rn(wx[dx], wy[dy]), wz[dz]);
    }
}
