// Shared cell and hash arithmetic of the small-table (fixed and random)
// schemes, for the small-table encode and, through large_geometry.cuh, the
// large-table encode and the table gradient
// (nerfpp_tpu_torch/encoders/hashgrid.py holds the plain version).
//
// The cell coordinate is the form jax.jit(corner_indices) computes, with
// round-to-nearest intrinsics so that nvcc cannot contract it into an FMA:
// fixed (SCHEME 0): (x - min) / cell[l, a], cell = f32(extent * f32(1/res));
// random (SCHEME 1): (x - min) * inv_ext[a] * scale[l]. The forward and the
// backward therefore put every point in the same cell as the plain version.
// Corner d (z fastest, bits (x, y, z) = (d>>2, d>>1, d) & 1) hashes to
// ((ux+dx)*pa ^ (uy+dy)*pb ^ (uz+dz)*pc) & (T - 1) in uint32 wrap arithmetic;
// for the random scheme & (T - 1) equals the JAX package's % T because T is
// a power of two there (the wrapper's encoder asserts it).
#pragma once

#include <cuda_runtime.h>

struct SmallGeom {
    float bx, by, bz;      // box min
    float ix, iy, iz;      // f32(1) / f32(max - min)
};

struct SmallCell {
    unsigned idx[8];       // entry within the level, [0, T)
    float w[8];            // trilinear weights, (wx * wy) * wz
};

template <int SCHEME>
__device__ __forceinline__ float small_rel(float x, float bmin, float inv,
                                           float geom) {
    const float d = __fsub_rn(x, bmin);
    if (SCHEME == 0) return __fdiv_rn(d, geom);
    return __fmul_rn(__fmul_rn(d, inv), geom);
}

// one level's constants: the cell sizes (fixed) or scales (random) g and the
// primes p of the three axes
struct SmallLevel {
    float g[3];
    unsigned p[3];
};

// geom: [L, 3] cell sizes (fixed) or scales (random); primes: [L, 3]
__device__ __forceinline__ SmallLevel small_level(int l, const float* geom,
                                                  const unsigned* primes) {
    SmallLevel v;
    #pragma unroll
    for (int a = 0; a < 3; ++a) {
        v.g[a] = __ldg(geom + 3 * l + a);
        v.p[a] = __ldg(primes + 3 * l + a);
    }
    return v;
}

template <int SCHEME>
__device__ __forceinline__ void small_cell_at(float x0, float x1, float x2,
                                              const SmallLevel& v,
                                              const SmallGeom& s,
                                              unsigned mask, SmallCell& c) {
    const float r0 = small_rel<SCHEME>(x0, s.bx, s.ix, v.g[0]);
    const float r1 = small_rel<SCHEME>(x1, s.by, s.iy, v.g[1]);
    const float r2 = small_rel<SCHEME>(x2, s.bz, s.iz, v.g[2]);
    const float fl0 = floorf(r0), fl1 = floorf(r1), fl2 = floorf(r2);
    const unsigned u0 = (unsigned)(int)fl0;
    const unsigned u1 = (unsigned)(int)fl1;
    const unsigned u2 = (unsigned)(int)fl2;
    const float f0 = __fsub_rn(r0, fl0);
    const float f1 = __fsub_rn(r1, fl1);
    const float f2 = __fsub_rn(r2, fl2);
    const unsigned pa = v.p[0], pb = v.p[1], pc = v.p[2];
    const float wx[2] = {__fsub_rn(1.0f, f0), f0};
    const float wy[2] = {__fsub_rn(1.0f, f1), f1};
    const float wz[2] = {__fsub_rn(1.0f, f2), f2};
    #pragma unroll
    for (int d = 0; d < 8; ++d) {
        const unsigned dx = (d >> 2) & 1, dy = (d >> 1) & 1, dz = d & 1;
        const unsigned h = ((u0 + dx) * pa) ^ ((u1 + dy) * pb)
                           ^ ((u2 + dz) * pc);
        c.idx[d] = h & mask;
        c.w[d] = __fmul_rn(__fmul_rn(wx[dx], wy[dy]), wz[dz]);
    }
}
