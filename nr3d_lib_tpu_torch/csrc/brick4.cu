// F=4 bf16-packed brick LoTD encoding: forward (B1), its backward (B2),
// nablas (B3) and the nablas' backward (B4).
//
// Replaces the TPU kernels nr3d_lib_tpu/ops/lotd_brick4.py
// `_fwd4_kernel_v3` (via `_brick4_fwd_pallas`, and with want_g via
// `_brick4_fwd_pallas_g`), `_bwd4_kernel_v4` (via `_brick4_bwd_pallas_v4`),
// `_dydx4_kernel_v3` (via `_brick4_dydx_pallas`) and `_bwd24_kernel_v3`
// (via `_brick4_bwd2_pallas`).
//
// What bounds it on an H100: each (point, level) reads 8 corners x 8 bytes
// from one 512-byte brick row chosen by a hash, so the work is 8 dependent
// random 8-byte loads per (point, level) plus ~40 flops. The packed table
// (4221 rows x 512 B = 2.2 MB at the production width) stays resident in
// the 50 MB L2, so the loads are L2 latency/transaction bound, far above
// the DRAM bound of the points' own bytes (12 B in, 32 B out per point).
// Design: one thread per (point, level) for the forward and one thread per
// point for the nablas (its [N,3] output sums over levels, so a thread owns a
// point and no atomics are needed); the index math (the JAX `_prologue`) runs
// in the kernel, so nothing but x, the table and the output touches device
// memory. The forward's want_g form (B1 want_g) takes blocks of 32 points at
// all levels and stores its corner words through shared memory as coalesced
// uint4 runs. The two backwards (B2, B4) give each warp 32 consecutive points
// at one level, a block the run at all levels, as the F=2 brick backwards do
// (brick.cu B7, B9): x and the upstream gradients are staged in shared memory,
// B4's dL/dg_up leaves through it as one coalesced [32, L] run, and dL/dx sums
// the levels there in level order. The TPU kernels' software pipelining, lane
// patterns and MXU reductions exist only for the TPU and are not carried over.
//
// The backwards (B2, B4) scatter dL/dtable into the natural unpacked
// layout [rows, 256] (lane vertex*4 + f) with 16-byte float4 atomicAdds in
// L2: the 4 features of a vertex are contiguous there. The TPU's
// half-plane outputs are a Mosaic workaround and are not carried over.
// The atomics bound them, worst on the dense 16^3 level, where every
// point lands in one of 125 brick rows; the sums' order changes from run
// to run. Their warps sum, corner by corner, the lanes that add to one
// slot and issue one atomic for the group (`warp_add4`,
// warp_atomics.cuh): a key is the slot row*64 + vertex, the same at F=2
// and F=4, so `ops/lotd_brick.brick_atomic_groups` counts what they
// issue. The C entries zero dL/dtable on the stream; dL/dx is written
// once, not accumulated.
//
// Bit-exactness notes. x*(res-2)+0.5 uses __fmul_rn/__fadd_rn: nvcc would
// contract it into an FMA, which moves points on a cell boundary into the
// neighbouring cell relative to the plain version. Packed words are only
// loaded, shifted and masked; no arithmetic touches packed bits. B4's
// dL/dg_up and dL/dx are the bits of its one-thread-per-point form (the
// per-level sums keep their order and that form's roundings, written
// out; the level sum d += e * (res-2) is the FMA nvcc made of it there);
// B2's dL/dx takes the same level sum.

#include <cstdint>
#include <cuda_runtime.h>

#include "warp_atomics.cuh"

#define BRICK4_MAX_LEVELS 4

struct Brick4Level {
  int res[3];
  int bpa[3];      // bricks per axis
  int n_rows;
  int row_offset;  // into the concatenated table
  int is_hash;
};

struct Brick4Meta {
  int n_levels;
  Brick4Level lv[BRICK4_MAX_LEVELS];
};

// nr3d_lib_tpu/ops/lotd.py HASH_PRIMES[0:3]
__device__ __constant__ uint32_t kPrimes[3] = {1u, 2654435761u, 805459861u};

struct Located {
  int row;     // absolute row in the packed table
  int vert0;   // brick-local vertex of corner (0,0,0)
  float frac[3];
};

__device__ __forceinline__ Located locate(const float xp[3],
                                          const Brick4Level& L) {
  Located o;
  int brick[3], local[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float v = __fadd_rn(__fmul_rn(xp[a], (float)(L.res[a] - 2)), 0.5f);
    const float c = floorf(v);
    o.frac[a] = __fsub_rn(v, c);
    int ci = (int)c;
    ci = min(max(ci, 0), L.res[a] - 2);
    const int b = ci / 3;
    local[a] = ci - b * 3;
    brick[a] = min(b, L.bpa[a] - 1);
  }
  int row;
  if (L.is_hash) {
    uint32_t h = (uint32_t)brick[0] * kPrimes[0];
    h ^= (uint32_t)brick[1] * kPrimes[1];
    h ^= (uint32_t)brick[2] * kPrimes[2];
    row = (int)(h % (uint32_t)L.n_rows);
  } else {
    row = (brick[0] * L.bpa[1] + brick[1]) * L.bpa[2] + brick[2];
  }
  o.row = row + L.row_offset;
  o.vert0 = (local[0] * 4 + local[1]) * 4 + local[2];
  return o;
}

// packed lane p = vertex*2 + f2 holds bf16(f=2*f2) | bf16(f=2*f2+1) << 16
__device__ __forceinline__ void unpack4(uint2 w, float f[4]) {
  f[0] = __uint_as_float(w.x << 16);
  f[1] = __uint_as_float(w.x & 0xFFFF0000u);
  f[2] = __uint_as_float(w.y << 16);
  f[3] = __uint_as_float(w.y & 0xFFFF0000u);
}

// corner k = (b0, b1, b2) bits -> vertex offset inside the brick
__device__ __forceinline__ int corner_off(int k) {
  return ((k >> 2) & 1) * 16 + ((k >> 1) & 1) * 4 + (k & 1);
}

// B1, y only: one thread per (point, level), i = p L + l, so that y [n, L]
// float4 is stored coalesced. Its launch passes words = null: the want_g
// form is brick4_fwd_g_kernel below. (This kernel's words branch, each
// lane's eight 8-byte stores 64 bytes from its neighbour's, took 0.0357
// ms at the F=4 step's 147,456 points x 2 levels, that kernel 0.0141.)
__global__ void brick4_fwd_kernel(const float* __restrict__ x,
                                  const uint2* __restrict__ table,
                                  const __grid_constant__ Brick4Meta meta,
                                  float4* __restrict__ y,
                                  uint2* __restrict__ words, long long n) {
  const int L = meta.n_levels;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * L) return;
  const long long p = i / L;
  const int l = (int)(i - p * L);
  const float xp[3] = {x[p * 3], x[p * 3 + 1], x[p * 3 + 2]};
  const Located c = locate(xp, meta.lv[l]);
  const uint2* rowp = table + (long long)c.row * 64 + c.vert0;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = (k >> 2) & 1, dy = (k >> 1) & 1, dz = k & 1;
    const float w = (dx ? c.frac[0] : 1.f - c.frac[0]) *
                    (dy ? c.frac[1] : 1.f - c.frac[1]) *
                    (dz ? c.frac[2] : 1.f - c.frac[2]);
    const uint2 word = __ldg(rowp + dx * 16 + dy * 4 + dz);
    if (words != nullptr) words[i * 8 + k] = word;
    float f[4];
    unpack4(word, f);
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += w * f[q];
  }
  y[i] = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// B1's, B2's and B4's run of consecutive points: one warp's width at each
// level
constexpr int BRICK4_POINTS = 32;

// B1's want_g form: y and the 8 corners' packed words of each (point,
// level), [n, L, 8] uint2, which B2 reads back for dL/dx. A block takes a
// run of BRICK4_POINTS consecutive points at all L levels (blockDim = 32
// L), point-major as the y-only form (thread t: point t / L, level t % L),
// so that y leaves coalesced. The block's words are one contiguous [32,
// L, 8] run: staged as [32][4 L + 1] uint4 in dynamic shared memory (a
// point's records padded by one uint4, so that the 8 lanes of a
// quarter-warp write 8 distinct bank groups) and written as uint4,
// coalesced, as B6's corners (brick.cu). Each (point, level) does the
// y-only form's arithmetic, so y has its bits. On an H100 at 700 W
// (chip_ab.py, the F=4 step's 147,456 points x 2 levels): 0.0141 ms, of
// which 0.0102 remain without the word stores; in level-major warps (y
// through shared memory) 0.0138 in ray order but 0.0219 against 0.0198
// permuted, so the point-major form stays.
__global__ void brick4_fwd_g_kernel(const float* __restrict__ x,
                                    const uint2* __restrict__ table,
                                    const __grid_constant__ Brick4Meta meta,
                                    float4* __restrict__ y,
                                    uint4* __restrict__ words, long long n) {
  extern __shared__ uint4 ws[];
  const int L = meta.n_levels;
  const long long p0 = (long long)blockIdx.x * BRICK4_POINTS;
  const int np = (int)min((long long)BRICK4_POINTS, n - p0);
  const int t = threadIdx.x, i = t / L, l = t - i * L;
  const int rec = 4 * L + 1;  // uint4s a point takes in ws
  if (i < np) {
    const float* xi = x + (p0 + i) * 3;
    const float xp[3] = {xi[0], xi[1], xi[2]};
    const Located c = locate(xp, meta.lv[l]);
    const uint2* rowp = table + (long long)c.row * 64 + c.vert0;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    uint2 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int dx = (k >> 2) & 1, dy = (k >> 1) & 1, dz = k & 1;
      const float w = (dx ? c.frac[0] : 1.f - c.frac[0]) *
                      (dy ? c.frac[1] : 1.f - c.frac[1]) *
                      (dz ? c.frac[2] : 1.f - c.frac[2]);
      v[k] = __ldg(rowp + dx * 16 + dy * 4 + dz);
      float f[4];
      unpack4(v[k], f);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += w * f[q];
    }
    y[p0 * L + t] = make_float4(acc[0], acc[1], acc[2], acc[3]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      ws[i * rec + l * 4 + q] = make_uint4(v[2 * q].x, v[2 * q].y,
                                           v[2 * q + 1].x, v[2 * q + 1].y);
  }
  __syncthreads();
  // uint4 f = j * 32 L + t of the block's run is record t % 4L of point
  // j * 8 + t / 4L
  const int ti = t / (4 * L), tr = t - ti * 4 * L;
  uint4* out = words + p0 * L * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int pi = j * 8 + ti;
    if (pi < np) out[j * 32 * L + t] = ws[pi * rec + tr];
  }
}

// runs a block takes: blockDim = 32 L BRICK4_RUNS, warp w the run w / L
// at level w % L
constexpr int BRICK4_RUNS = 1;
constexpr int BRICK4_BLOCK_POINTS = BRICK4_POINTS * BRICK4_RUNS;

// B2, the encode's backward. dtab [rows, 64] float4 (zeroed by the entry)
// += w_k g at corner k. With dx (may be null): dL/dx_a = sum_l (res_a-2)
// t_a, t_a = sum_k (g . val_k) dw_k/dfrac_a, the corner values taken from
// `words` (the want_g forward's [n, L, 8] uint2: a lane's 64 contiguous
// bytes, four 16-byte loads) when it saved them, else from the packed
// table. x and g's [points, L] slots are staged in shared memory,
// dL/dtable leaves through `warp_add4` corner by corner, and each (level,
// point) parks t in [L, points, 3] there, so one thread a coordinate sums
// the levels in level order and the block writes dL/dx once: no memset,
// no dx atomics, the same bits in any order of the points. The index math
// is B1's, so a point on a cell boundary scatters into the row the
// forward read.
__global__ void brick4_bwd_kernel(const float* __restrict__ x,
                                  const float4* __restrict__ g,
                                  const uint2* __restrict__ words,
                                  const uint2* __restrict__ table,
                                  const __grid_constant__ Brick4Meta meta,
                                  float4* __restrict__ dtab,
                                  float* __restrict__ dx, long long n) {
  constexpr int P = BRICK4_BLOCK_POINTS;
  __shared__ float xs[P * 3];
  __shared__ float4 gs[P * BRICK4_MAX_LEVELS];
  __shared__ float ts[BRICK4_MAX_LEVELS * P * 3];
  const int L = meta.n_levels;
  const long long p0 = (long long)blockIdx.x * P;
  const int np = (int)min((long long)P, n - p0);
  for (int k = threadIdx.x; k < np * 3; k += blockDim.x) xs[k] = x[p0 * 3 + k];
  for (int k = threadIdx.x; k < np * L; k += blockDim.x) gs[k] = g[p0 * L + k];
  __syncthreads();
  const int w = threadIdx.x >> 5;
  const int l = w % L, i = (w / L) * BRICK4_POINTS + (threadIdx.x & 31);
  const unsigned active = __ballot_sync(0xffffffffu, i < np);
  if (i < np) {
    const float xp[3] = {xs[i * 3], xs[i * 3 + 1], xs[i * 3 + 2]};
    const Brick4Level& lv = meta.lv[l];
    const Located c = locate(xp, lv);
    const float4 gv = gs[i * L + l];
    const int base = c.row * 64 + c.vert0;
    float s[3][2];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s[a][0] = 1.f - c.frac[a];
      s[a][1] = c.frac[a];
    }
    uint2 v[8];
    if (dx != nullptr) {
      if (words != nullptr) {
        const uint4* wp =
            reinterpret_cast<const uint4*>(words) + ((p0 + i) * L + l) * 4;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint4 u = __ldg(wp + q);
          v[2 * q] = make_uint2(u.x, u.y);
          v[2 * q + 1] = make_uint2(u.z, u.w);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = __ldg(table + base + corner_off(k));
      }
    }
    float t[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int b0 = (k >> 2) & 1, b1 = (k >> 1) & 1, b2 = k & 1;
      const float wk = s[0][b0] * s[1][b1] * s[2][b2];
      // a key does not name its corner, so lanes meet corner by corner
      warp_add4(dtab, base + corner_off(k),
                make_float4(wk * gv.x, wk * gv.y, wk * gv.z, wk * gv.w),
                active);
      if (dx != nullptr) {
        float f[4];
        unpack4(v[k], f);
        const float h = gv.x * f[0] + gv.y * f[1] + gv.z * f[2] + gv.w * f[3];
        t[0] += (b0 ? h : -h) * s[1][b1] * s[2][b2];
        t[1] += (b1 ? h : -h) * s[0][b0] * s[2][b2];
        t[2] += (b2 ? h : -h) * s[0][b0] * s[1][b1];
      }
    }
    if (dx != nullptr) {
#pragma unroll
      for (int a = 0; a < 3; ++a) ts[(l * P + i) * 3 + a] = t[a];
    }
  }
  if (dx == nullptr) return;  // uniform over the block
  __syncthreads();
  for (int k = threadIdx.x; k < np * 3; k += blockDim.x) {
    const int a = k % 3;
    float d = 0.f;
    for (int ll = 0; ll < L; ++ll)
      d = fmaf(ts[ll * P * 3 + k], (float)(meta.lv[ll].res[a] - 2), d);
    dx[p0 * 3 + k] = d;
  }
}

// B3, the nablas: dx_a = sum_l (res_a - 2) t_a, t_a = sum_k (g_up . val_k)
// dw_k/dfrac_a. One thread a point sums its levels in level order, so dx
// has the same bits in any order of the points. The number of levels is a
// template parameter (an instance for L = 1..4), so the loop over them
// unrolls and a thread's 8 L corner loads are in flight together; blocks
// of 64 threads of at most 56 registers (18 blocks an SM) hold the F=4
// step's 147,456 points in one wave, shared evenly over the SMs. On an
// H100 at 700 W (chip_ab.py, that shape, ray order) 0.0077 ms against
// 0.0085 for one level at a time in blocks of 256 (40 registers, 6 blocks
// an SM); B8's level-major form took 0.0081, and forms that split a
// (point, level) over 8 lanes, lane k loading corner k (one load
// instruction for 4 points), 0.0087-0.022: the moves between lanes cost
// more than the fewer lines saved. The level sum d += t (res-2) is the
// FFMA that the one-level-at-a-time form compiled to, so dx keeps its
// bits.
template <int L>
__global__ void __launch_bounds__(64, 18)
    brick4_dydx_kernel(const float4* __restrict__ g_up,
                       const float* __restrict__ x,
                       const uint2* __restrict__ table,
                       const __grid_constant__ Brick4Meta meta,
                       float* __restrict__ dx, long long n) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const float xp[3] = {x[p * 3], x[p * 3 + 1], x[p * 3 + 2]};
  float d[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const Brick4Level& lv = meta.lv[l];
    const Located c = locate(xp, lv);
    const float4 g = g_up[p * L + l];
    const uint2* rowp = table + (long long)c.row * 64 + c.vert0;
    float s[3][2];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s[a][0] = 1.f - c.frac[a];
      s[a][1] = c.frac[a];
    }
    float t[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int b0 = (k >> 2) & 1, b1 = (k >> 1) & 1, b2 = k & 1;
      float f[4];
      unpack4(__ldg(rowp + b0 * 16 + b1 * 4 + b2), f);
      const float h = g.x * f[0] + g.y * f[1] + g.z * f[2] + g.w * f[3];
      // d w_k / d frac_a = (2*bit_a - 1) * prod_{b != a} s_b
      t[0] += (b0 ? h : -h) * s[1][b1] * s[2][b2];
      t[1] += (b1 ? h : -h) * s[0][b0] * s[2][b2];
      t[2] += (b2 ? h : -h) * s[0][b0] * s[1][b1];
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) d[a] += t[a] * (float)(lv.res[a] - 2);
  }
  dx[p * 3] = d[0];
  dx[p * 3 + 1] = d[1];
  dx[p * 3 + 2] = d[2];
}

// B4, the backward of B3. With D_a = gg_a (res_a - 2), h_k = g_up . val_k
// and sg_a = 2 bit_a - 1:
//   c_k           = sum_a D_a dw_k/dfrac_a
//   dL/dg_up[l,f] = sum_k c_k val_k[f]              (written, no atomics)
//   dL/dtable     += c_k g_up[l,:] at corner k       (float4 atomics)
//   dL/dx_b       += (res_b-2) sum_k h_k sg_b sum_{a!=b} D_a sg_a s_c(k)
// where c is the axis other than a and b (trilinear weights are linear in
// each frac, so only the mixed second derivatives survive). The blocks
// of B2: g_up's [points, L] slots in shared memory are overwritten by
// dL/dg_up (each thread reads its own slot first); e, the level's dL/dx
// before its (res-2), goes to [L, points, 3] there. Every rounding is
// written out (__fmul_rn, __fadd_rn, __fmaf_rn), so ptxas cannot fuse
// other products in these warps' blocks: the forms are those that
// ptxas chose for the one-thread-per-point kernel (read from its SASS),
// so dL/dg_up and dL/dx keep its bits.
__global__ void brick4_bwd2_kernel(const float4* __restrict__ g_up,
                                   const float* __restrict__ x,
                                   const uint2* __restrict__ table,
                                   const float* __restrict__ gg,
                                   const __grid_constant__ Brick4Meta meta,
                                   float4* __restrict__ dgup,
                                   float4* __restrict__ dtab,
                                   float* __restrict__ dx, long long n) {
  constexpr int P = BRICK4_BLOCK_POINTS;
  __shared__ float xs[P * 3], ggs[P * 3];
  __shared__ float4 gs[P * BRICK4_MAX_LEVELS];
  __shared__ float es[BRICK4_MAX_LEVELS * P * 3];
  const int L = meta.n_levels;
  const long long p0 = (long long)blockIdx.x * P;
  const int np = (int)min((long long)P, n - p0);
  for (int k = threadIdx.x; k < np * 3; k += blockDim.x) {
    xs[k] = x[p0 * 3 + k];
    ggs[k] = gg[p0 * 3 + k];
  }
  for (int k = threadIdx.x; k < np * L; k += blockDim.x)
    gs[k] = g_up[p0 * L + k];
  __syncthreads();
  const int w = threadIdx.x >> 5;
  const int l = w % L, i = (w / L) * BRICK4_POINTS + (threadIdx.x & 31);
  const unsigned active = __ballot_sync(0xffffffffu, i < np);
  if (i < np) {
    const float xp[3] = {xs[i * 3], xs[i * 3 + 1], xs[i * 3 + 2]};
    const float ggp[3] = {ggs[i * 3], ggs[i * 3 + 1], ggs[i * 3 + 2]};
    const Brick4Level& lv = meta.lv[l];
    const Located c = locate(xp, lv);
    const float4 g = gs[i * L + l];
    const int base = c.row * 64 + c.vert0;
    float s[3][2], D[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s[a][0] = 1.f - c.frac[a];
      s[a][1] = c.frac[a];
      D[a] = ggp[a] * (float)(lv.res[a] - 2);
    }
    float4 dg = make_float4(0.f, 0.f, 0.f, 0.f);
    float e[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int b0 = (k >> 2) & 1, b1 = (k >> 1) & 1, b2 = k & 1;
      const int off = corner_off(k);
      // D_a sg_a: a sign, exact
      const float d0 = b0 ? D[0] : -D[0], d1 = b1 ? D[1] : -D[1],
                  d2 = b2 ? D[2] : -D[2];
      float f[4];
      unpack4(__ldg(table + base + off), f);
      // the one-thread-per-point form's bits, written out (see the notes
      // at the top): c_k rounds every product and sum
      const float ck = __fadd_rn(
          __fadd_rn(__fmul_rn(__fmul_rn(d0, s[1][b1]), s[2][b2]),
                    __fmul_rn(__fmul_rn(d1, s[0][b0]), s[2][b2])),
          __fmul_rn(__fmul_rn(d2, s[0][b0]), s[1][b1]));
      dg.x = __fmaf_rn(ck, f[0], dg.x);
      dg.y = __fmaf_rn(ck, f[1], dg.y);
      dg.z = __fmaf_rn(ck, f[2], dg.z);
      dg.w = __fmaf_rn(ck, f[3], dg.w);
      // a key does not name its corner, so lanes meet corner by corner
      warp_add4(dtab, base + off,
                make_float4(__fmul_rn(ck, g.x), __fmul_rn(ck, g.y),
                            __fmul_rn(ck, g.z), __fmul_rn(ck, g.w)),
                active);
      if (dx != nullptr) {
        const float h = __fmaf_rn(
            g.w, f[3],
            __fmaf_rn(g.z, f[2], __fmaf_rn(g.x, f[0], __fmul_rn(g.y, f[1]))));
        // x_a = sum_{b != a} D_b sg_b s_c, one product fused as there:
        // for x0 D2's where b1 = 0, else D1's; for x1 D0's; none for x2
        const float x0 = b1 ? __fmaf_rn(d1, s[2][b2], __fmul_rn(d2, s[1][b1]))
                            : __fmaf_rn(d2, s[1][b1], __fmul_rn(d1, s[2][b2]));
        const float x1 = __fmaf_rn(d0, s[2][b2], __fmul_rn(d2, s[0][b0]));
        const float x2 =
            __fadd_rn(__fmul_rn(d0, s[1][b1]), __fmul_rn(d1, s[0][b0]));
        e[0] = __fmaf_rn(b0 ? h : -h, x0, e[0]);
        e[1] = __fmaf_rn(b1 ? h : -h, x1, e[1]);
        e[2] = __fmaf_rn(b2 ? h : -h, x2, e[2]);
      }
    }
    gs[i * L + l] = dg;
    if (dx != nullptr) {
#pragma unroll
      for (int a = 0; a < 3; ++a) es[(l * P + i) * 3 + a] = e[a];
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < np * L; k += blockDim.x)
    dgup[p0 * L + k] = gs[k];
  if (dx != nullptr) {
    for (int k = threadIdx.x; k < np * 3; k += blockDim.x) {
      const int a = k % 3;
      float d = 0.f;
      for (int ll = 0; ll < L; ++ll)
        d = fmaf(es[ll * P * 3 + k], (float)(meta.lv[ll].res[a] - 2), d);
      dx[p0 * 3 + k] = d;
    }
  }
}

static long long total_rows(const Brick4Meta& meta) {
  const Brick4Level& last = meta.lv[meta.n_levels - 1];
  return (long long)last.row_offset + last.n_rows;
}

static unsigned n_blocks(long long total, int threads) {
  return (unsigned)((total + threads - 1) / threads);
}

extern "C" {

// x [n,3] f32, table packed [rows,128] 32-bit words, y [n,4L] f32, words
// [n,L,8] uint2 (16-byte aligned) or null.
int brick4_fwd(const void* x, const void* table, Brick4Meta meta, void* y,
               void* words, long long n, void* stream) {
  const int L = meta.n_levels;
  const long long total = n * L;
  cudaStream_t st = (cudaStream_t)stream;
  if (total > 0) {
    if (words == nullptr) {
      const int threads = 256;
      brick4_fwd_kernel<<<n_blocks(total, threads), threads, 0, st>>>(
          (const float*)x, (const uint2*)table, meta, (float4*)y, nullptr,
          n);
    } else {
      const size_t smem = (size_t)BRICK4_POINTS * (4 * L + 1) * sizeof(uint4);
      brick4_fwd_g_kernel<<<n_blocks(n, BRICK4_POINTS), 32 * L, smem, st>>>(
          (const float*)x, (const uint2*)table, meta, (float4*)y,
          (uint4*)words, n);
    }
  }
  return (int)cudaGetLastError();
}

// x [n,3] f32, g [n,4L] f32, words [n,L,8] uint2 (16-byte aligned) or
// null, table packed [rows,128] or null, dtab [rows,256] f32 (zeroed
// here), dx [n,3] f32 or null (written, not accumulated). dx needs words
// or the table.
int brick4_bwd(const void* x, const void* g, const void* words,
               const void* table, Brick4Meta meta, void* dtab, void* dx,
               long long n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (meta.n_levels > 0)
    cudaMemsetAsync(dtab, 0, (size_t)total_rows(meta) * 256 * sizeof(float),
                    st);
  if (n > 0 && meta.n_levels > 0) {
    brick4_bwd_kernel<<<n_blocks(n, BRICK4_BLOCK_POINTS),
                        32 * meta.n_levels * BRICK4_RUNS, 0, st>>>(
        (const float*)x, (const float4*)g, (const uint2*)words,
        (const uint2*)table, meta, (float4*)dtab, (float*)dx, n);
  } else if (n > 0 && dx != nullptr) {  // no level: dx is 0
    cudaMemsetAsync(dx, 0, sizeof(float) * n * 3, st);
  }
  return (int)cudaGetLastError();
}

// g_up [n,4L] f32, x [n,3] f32, table packed [rows,128], dx [n,3] f32.
int brick4_dydx(const void* g_up, const void* x, const void* table,
                Brick4Meta meta, void* dx, long long n, void* stream) {
  using Kernel = void (*)(const float4*, const float*, const uint2*,
                          Brick4Meta, float*, long long);
  static const Kernel kernels[BRICK4_MAX_LEVELS] = {
      brick4_dydx_kernel<1>, brick4_dydx_kernel<2>, brick4_dydx_kernel<3>,
      brick4_dydx_kernel<4>};
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 0 && meta.n_levels == 0)  // no level: dx is 0
    return (int)cudaMemsetAsync(dx, 0, sizeof(float) * n * 3, st);
  if (n > 0)
    kernels[meta.n_levels - 1]<<<n_blocks(n, 64), 64, 0, st>>>(
        (const float4*)g_up, (const float*)x, (const uint2*)table, meta,
        (float*)dx, n);
  return (int)cudaGetLastError();
}

// g_up [n,4L] f32, x [n,3] f32, table packed [rows,128], gg [n,3] f32,
// dgup [n,4L] f32, dtab [rows,256] f32 (zeroed here), dx [n,3] f32 or null.
int brick4_bwd2(const void* g_up, const void* x, const void* table,
                const void* gg, Brick4Meta meta, void* dgup, void* dtab,
                void* dx, long long n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (meta.n_levels > 0)
    cudaMemsetAsync(dtab, 0, (size_t)total_rows(meta) * 256 * sizeof(float),
                    st);
  if (n > 0 && meta.n_levels > 0) {
    brick4_bwd2_kernel<<<n_blocks(n, BRICK4_BLOCK_POINTS),
                         32 * meta.n_levels * BRICK4_RUNS, 0, st>>>(
        (const float4*)g_up, (const float*)x, (const uint2*)table,
        (const float*)gg, meta, (float4*)dgup, (float4*)dtab, (float*)dx, n);
  } else if (n > 0 && dx != nullptr) {  // no level: dx is 0
    cudaMemsetAsync(dx, 0, sizeof(float) * n * 3, st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
