// F=2 brick LoTD encoding: forward (B6), its backward (B7), nablas (B8) and
// the nablas' backward (B9).
//
// Replaces the TPU kernels nr3d_lib_tpu/ops/lotd_brick.py `_fwd_kernel_v3`
// (via `_brick_encode_pallas`, and with want_g via `_brick_encode_pallas_g`),
// `_bwd_kernel_v4` (via `_brick_bwd_pallas_v4`; the frozen-x form is
// need_dx=false), `_dydx_kernel_v3` (via `_brick_dydx_pallas`) and
// `_bwd2_kernel_v3` (via `_brick_bwd2_pallas`).
//
// Table layout: f32 [rows, 128], lane = vertex*2 + f, read here as 64
// float2 per 512-byte brick row. Each (point, level) reads its 8 corners,
// one float2 each, from the one row chosen by the brick index or hash.
//
// What bounds it on an H100: 8 dependent random 8-byte loads per (point,
// level) plus ~60 flops. The tables of the ported configurations (9,648
// rows = 4.9 MB for the NeuS, 23,005 rows = 11.8 MB for the NeRF) stay
// resident in the 50 MB L2, so the loads are bound by L2 latency and
// transactions, far above the DRAM bound of the points' own bytes (12 B in,
// 8 B per level out). Design: one thread per (point, level) for the
// encode, one thread per point for the nablas (their [N,3] output sums
// over levels, so a thread owns a point and the nablas need no atomics);
// the index math (the JAX `_prologue`) runs in the kernel, so nothing but
// x, the table and the outputs touches device memory. The two backwards
// (B7, B9) give each warp 32 consecutive points at one level, a block the
// run at all levels, as the cell permuto kernels do (permuto_cell.cu): x
// and the upstream gradients are staged in shared memory, B9's dL/dg_up
// leaves through it as one coalesced [32, L] run, and dL/dx sums the
// levels there in level order. The TPU kernels' software pipelining,
// lane-packed [tile,128] vectors, one-hot MXU row gather, matmul
// reductions, per-level _pad8 accumulators and chunking exist only for
// the TPU and are not carried over.
//
// The backwards scatter dL/dtable into the natural [rows, 128] layout
// with 8-byte float2 atomicAdds in L2, worst on the dense 16^3 (125 rows)
// and 32^3 (1331 rows) levels, where many points share a row; the sums'
// order changes from run to run. Their warps sum, corner by corner, the
// lanes that add to one slot and issue one atomic for the group
// (`warp_add2`, warp_atomics.cuh): B7 and B9 scatter the same keys at the
// same points, and along rays 72% of the atomics remain at the F=2 NeuS
// step's points (49% at its dense level 0). Measured there on an H100 at
// 700 W (chip_ab.py, ray order): B9 took 0.119 ms as one thread per
// point walking the levels, 0.023 of it without its atomics and 0.070 at
// level 0 alone; in these warps 0.107 with one atomic per lane, 0.070
// with the sums, of which 0.018 without atomics and 0.054 without level
// 0's. A level-0 table privatized in shared memory would save at most
// that 0.016 ms, so it was not built. The C entries zero dL/dtable on the
// stream; dL/dx is written once, not accumulated.
//
// Bit-exactness notes. x*(res-2)+0.5 uses __fmul_rn/__fadd_rn: nvcc would
// contract it into an FMA, which moves points on a cell boundary into the
// neighbouring cell relative to the plain version. The brick hash multiplies
// in uint32, as the plain version does in int64 with & 0xFFFFFFFF. B9's
// dL/dg_up and dL/dx are the bits of its one-thread-per-point form (the
// per-level sums keep their order; the level sum d += e * (res-2) is the
// FMA nvcc made of it there); B7's dL/dx takes the same level sum. This
// file shares only warp_atomics.cuh with the other sources; the build's
// hash covers every header.

#include <cstdint>
#include <cuda_runtime.h>

#include "warp_atomics.cuh"

#define BRICK_MAX_LEVELS 8

struct BrickLevel {
  int res[3];
  int bpa[3];      // bricks per axis
  int n_rows;
  int row_offset;  // into the concatenated table
  int is_hash;
};

struct BrickMeta {
  int n_levels;
  BrickLevel lv[BRICK_MAX_LEVELS];
};

// nr3d_lib_tpu/ops/lotd.py HASH_PRIMES[0:3]
__device__ __constant__ uint32_t kPrimes[3] = {1u, 2654435761u, 805459861u};

struct Located {
  int row;     // absolute row in the table
  int vert0;   // brick-local vertex of corner (0,0,0)
  float frac[3];
};

__device__ __forceinline__ Located locate(const float xp[3],
                                          const BrickLevel& L) {
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

// corner k = (b0, b1, b2) bits → vertex offset inside the brick
__device__ __forceinline__ int corner_off(int k) {
  return ((k >> 2) & 1) * 16 + ((k >> 1) & 1) * 4 + (k & 1);
}

// B6: one thread per (point, level), i = p * L + l. y [n, L] float2.
// corners (may be null, the want_g form): the 8 corners' values of each
// (point, level), [n, L, 8] float2, which B7 reads back for dL/dx.
__global__ void brick_fwd_kernel(const float* __restrict__ x,
                                 const float2* __restrict__ table,
                                 const __grid_constant__ BrickMeta meta,
                                 float2* __restrict__ y,
                                 float2* __restrict__ corners, long long n) {
  const int L = meta.n_levels;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * L) return;
  const long long p = i / L;
  const int l = (int)(i - p * L);
  const float xp[3] = {x[p * 3], x[p * 3 + 1], x[p * 3 + 2]};
  const Located c = locate(xp, meta.lv[l]);
  const float2* rowp = table + (long long)c.row * 64 + c.vert0;
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int b0 = (k >> 2) & 1, b1 = (k >> 1) & 1, b2 = k & 1;
    const float w = (b0 ? c.frac[0] : 1.f - c.frac[0]) *
                    (b1 ? c.frac[1] : 1.f - c.frac[1]) *
                    (b2 ? c.frac[2] : 1.f - c.frac[2]);
    const float2 v = __ldg(rowp + corner_off(k));
    if (corners != nullptr) corners[i * 8 + k] = v;
    a0 += w * v.x;
    a1 += w * v.y;
  }
  y[i] = make_float2(a0, a1);
}

// B9's and B7's run of consecutive points: one warp's width at each level
constexpr int BRICK_POINTS = 32;

// B7, the encode's backward. dtab [rows, 64] float2 (zeroed by the entry)
// += w_k g at corner k. With dx (may be null): dL/dx_a = sum_l (res_a-2)
// t_a, t_a = sum_k (g . val_k) dw_k/dfrac_a, the corner values taken from
// `corners` (the want_g forward's [n, L, 8] float2: a lane's 64 contiguous
// bytes, four float4 loads) when it saved them, else from the table. A
// block takes a run of BRICK_POINTS consecutive points at all L levels
// (blockDim = 32 L), warp l the run at level l, as B9: x and g's [32, L]
// slots are staged in shared memory, dL/dtable leaves through `warp_add2`
// corner by corner (the keys are B9's), and each (level, point) parks t in
// [L, 32, 3] there, so one thread a coordinate sums the levels in level
// order and the block writes dL/dx once: no memset, no dx atomics, the
// same bits in any order of the points. The index math is B6's, so a
// point on a cell boundary scatters into the row the forward read.
__global__ void brick_bwd_kernel(const float* __restrict__ x,
                                 const float2* __restrict__ g,
                                 const float2* __restrict__ corners,
                                 const float2* __restrict__ table,
                                 const __grid_constant__ BrickMeta meta,
                                 float2* __restrict__ dtab,
                                 float* __restrict__ dx, long long n) {
  __shared__ float xs[BRICK_POINTS * 3];
  __shared__ float2 gs[BRICK_POINTS * BRICK_MAX_LEVELS];
  __shared__ float ts[BRICK_MAX_LEVELS * BRICK_POINTS * 3];
  const int L = meta.n_levels;
  const long long p0 = (long long)blockIdx.x * BRICK_POINTS;
  const int np = (int)min((long long)BRICK_POINTS, n - p0);
  for (int k = threadIdx.x; k < np * 3; k += blockDim.x) xs[k] = x[p0 * 3 + k];
  for (int k = threadIdx.x; k < np * L; k += blockDim.x) gs[k] = g[p0 * L + k];
  __syncthreads();
  const int l = threadIdx.x >> 5, i = threadIdx.x & 31;
  const unsigned active = __ballot_sync(0xffffffffu, i < np);
  if (i < np) {
    const float xp[3] = {xs[i * 3], xs[i * 3 + 1], xs[i * 3 + 2]};
    const BrickLevel& lv = meta.lv[l];
    const Located c = locate(xp, lv);
    const float2 gv = gs[i * L + l];
    const int base = c.row * 64 + c.vert0;
    float s[3][2];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s[a][0] = 1.f - c.frac[a];
      s[a][1] = c.frac[a];
    }
    float2 v[8];
    if (dx != nullptr) {
      if (corners != nullptr) {
        const float4* cp =
            reinterpret_cast<const float4*>(corners) + ((p0 + i) * L + l) * 4;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 w = __ldg(cp + q);
          v[2 * q] = make_float2(w.x, w.y);
          v[2 * q + 1] = make_float2(w.z, w.w);
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
      const float w = s[0][b0] * s[1][b1] * s[2][b2];
      // a key does not name its corner, so lanes meet corner by corner
      warp_add2(dtab, base + corner_off(k), make_float2(w * gv.x, w * gv.y),
                active);
      if (dx != nullptr) {
        const float h = gv.x * v[k].x + gv.y * v[k].y;
        t[0] += (b0 ? h : -h) * s[1][b1] * s[2][b2];
        t[1] += (b1 ? h : -h) * s[0][b0] * s[2][b2];
        t[2] += (b2 ? h : -h) * s[0][b0] * s[1][b1];
      }
    }
    if (dx != nullptr) {
#pragma unroll
      for (int a = 0; a < 3; ++a) ts[(l * BRICK_POINTS + i) * 3 + a] = t[a];
    }
  }
  if (dx == nullptr) return;  // uniform over the block
  __syncthreads();
  for (int k = threadIdx.x; k < np * 3; k += blockDim.x) {
    const int a = k % 3;
    float d = 0.f;
    for (int ll = 0; ll < L; ++ll)
      d = fmaf(ts[ll * BRICK_POINTS * 3 + k], (float)(meta.lv[ll].res[a] - 2),
               d);
    dx[p0 * 3 + k] = d;
  }
}

// B8: one thread per point, looping over levels; no atomics.
//   dx_a = sum_l (res_a-2) sum_k (g_up . val_k) (2 bit_a - 1) prod_{b!=a} s_b
__global__ void brick_dydx_kernel(const float2* __restrict__ g_up,
                                  const float* __restrict__ x,
                                  const float2* __restrict__ table,
                                  const __grid_constant__ BrickMeta meta,
                                  float* __restrict__ dx, long long n) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int L = meta.n_levels;
  const float xp[3] = {x[p * 3], x[p * 3 + 1], x[p * 3 + 2]};
  float d[3] = {0.f, 0.f, 0.f};
  for (int l = 0; l < L; ++l) {
    const BrickLevel& lv = meta.lv[l];
    const Located c = locate(xp, lv);
    const float2 g = g_up[p * L + l];
    const float2* rowp = table + (long long)c.row * 64 + c.vert0;
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
      const float2 v = __ldg(rowp + corner_off(k));
      const float h = g.x * v.x + g.y * v.y;
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

// B9, the backward of B8. With D_a = gg_a (res_a - 2), h_k = g_up . val_k
// and sg_a = 2 bit_a - 1:
//   c_k           = sum_a D_a dw_k/dfrac_a
//   dL/dg_up[l,f] = sum_k c_k val_k[f]              (written, no atomics)
//   dL/dtable     += c_k g_up[l,:] at corner k       (float2 atomics)
//   dL/dx_b       += (res_b-2) sum_k h_k sg_b sum_{a!=b} D_a sg_a s_c(k)
// where c is the axis other than a and b (trilinear weights are linear in
// each frac, so only the mixed second derivatives survive). A block takes
// a run of BRICK_POINTS consecutive points at all L levels (blockDim =
// 32 L), warp l the run at level l. g_up's [32, L] slots in shared memory
// are overwritten by dL/dg_up (each thread reads its own slot first); e,
// the level's dL/dx before its (res-2), goes to [L, 32, 3] there.
__global__ void brick_bwd2_kernel(const float2* __restrict__ g_up,
                                  const float* __restrict__ x,
                                  const float2* __restrict__ table,
                                  const float* __restrict__ gg,
                                  const __grid_constant__ BrickMeta meta,
                                  float2* __restrict__ dgup,
                                  float2* __restrict__ dtab,
                                  float* __restrict__ dx, long long n) {
  __shared__ float xs[BRICK_POINTS * 3], ggs[BRICK_POINTS * 3];
  __shared__ float2 gs[BRICK_POINTS * BRICK_MAX_LEVELS];
  __shared__ float es[BRICK_MAX_LEVELS * BRICK_POINTS * 3];
  const int L = meta.n_levels;
  const long long p0 = (long long)blockIdx.x * BRICK_POINTS;
  const int np = (int)min((long long)BRICK_POINTS, n - p0);
  for (int k = threadIdx.x; k < np * 3; k += blockDim.x) {
    xs[k] = x[p0 * 3 + k];
    ggs[k] = gg[p0 * 3 + k];
  }
  for (int k = threadIdx.x; k < np * L; k += blockDim.x)
    gs[k] = g_up[p0 * L + k];
  __syncthreads();
  const int l = threadIdx.x >> 5, i = threadIdx.x & 31;
  const unsigned active = __ballot_sync(0xffffffffu, i < np);
  if (i < np) {
    const float xp[3] = {xs[i * 3], xs[i * 3 + 1], xs[i * 3 + 2]};
    const float ggp[3] = {ggs[i * 3], ggs[i * 3 + 1], ggs[i * 3 + 2]};
    const BrickLevel& lv = meta.lv[l];
    const Located c = locate(xp, lv);
    const float2 g = gs[i * L + l];
    const int base = c.row * 64 + c.vert0;
    float s[3][2], D[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s[a][0] = 1.f - c.frac[a];
      s[a][1] = c.frac[a];
      D[a] = ggp[a] * (float)(lv.res[a] - 2);
    }
    float dg0 = 0.f, dg1 = 0.f;
    float e[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int b0 = (k >> 2) & 1, b1 = (k >> 1) & 1, b2 = k & 1;
      const int off = corner_off(k);
      const float sg0 = b0 ? 1.f : -1.f, sg1 = b1 ? 1.f : -1.f,
                  sg2 = b2 ? 1.f : -1.f;
      const float2 v = __ldg(table + base + off);
      const float ck = D[0] * sg0 * s[1][b1] * s[2][b2] +
                       D[1] * sg1 * s[0][b0] * s[2][b2] +
                       D[2] * sg2 * s[0][b0] * s[1][b1];
      dg0 += ck * v.x;
      dg1 += ck * v.y;
      // a key does not name its corner, so lanes meet corner by corner
      warp_add2(dtab, base + off, make_float2(ck * g.x, ck * g.y), active);
      if (dx != nullptr) {
        const float h = g.x * v.x + g.y * v.y;
        e[0] += h * sg0 * (D[1] * sg1 * s[2][b2] + D[2] * sg2 * s[1][b1]);
        e[1] += h * sg1 * (D[0] * sg0 * s[2][b2] + D[2] * sg2 * s[0][b0]);
        e[2] += h * sg2 * (D[0] * sg0 * s[1][b1] + D[1] * sg1 * s[0][b0]);
      }
    }
    gs[i * L + l] = make_float2(dg0, dg1);
    if (dx != nullptr) {
#pragma unroll
      for (int a = 0; a < 3; ++a) es[(l * BRICK_POINTS + i) * 3 + a] = e[a];
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
        d = fmaf(es[ll * BRICK_POINTS * 3 + k],
                 (float)(meta.lv[ll].res[a] - 2), d);
      dx[p0 * 3 + k] = d;
    }
  }
}

static long long total_rows(const BrickMeta& meta) {
  const BrickLevel& last = meta.lv[meta.n_levels - 1];
  return (long long)last.row_offset + last.n_rows;
}

static unsigned n_blocks(long long total, int threads) {
  return (unsigned)((total + threads - 1) / threads);
}

extern "C" {

// x [n,3] f32, table [rows,128] f32, y [n,2L] f32, corners [n,L,8,2] f32 or
// null.
int brick_fwd(const void* x, const void* table, BrickMeta meta, void* y,
              void* corners, long long n, void* stream) {
  const long long total = n * meta.n_levels;
  if (total > 0) {
    brick_fwd_kernel<<<n_blocks(total, 256), 256, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float2*)table, meta, (float2*)y,
        (float2*)corners, n);
  }
  return (int)cudaGetLastError();
}

// x [n,3] f32, g [n,2L] f32, corners [n,L,8,2] f32 (16-byte aligned) or
// null, table [rows,128] f32 or null, dtab [rows,128] f32 (zeroed here),
// dx [n,3] f32 or null (written, not accumulated). dx needs the corners or
// the table.
int brick_bwd(const void* x, const void* g, const void* corners,
              const void* table, BrickMeta meta, void* dtab, void* dx,
              long long n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(dtab, 0, (size_t)total_rows(meta) * 128 * sizeof(float),
                  st);
  if (n > 0 && meta.n_levels > 0) {
    brick_bwd_kernel<<<n_blocks(n, BRICK_POINTS), 32 * meta.n_levels, 0,
                       st>>>(
        (const float*)x, (const float2*)g, (const float2*)corners,
        (const float2*)table, meta, (float2*)dtab, (float*)dx, n);
  }
  return (int)cudaGetLastError();
}

// g_up [n,2L] f32, x [n,3] f32, table [rows,128] f32, dx [n,3] f32.
int brick_dydx(const void* g_up, const void* x, const void* table,
               BrickMeta meta, void* dx, long long n, void* stream) {
  if (n > 0) {
    brick_dydx_kernel<<<n_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
        (const float2*)g_up, (const float*)x, (const float2*)table, meta,
        (float*)dx, n);
  }
  return (int)cudaGetLastError();
}

// g_up [n,2L] f32, x [n,3] f32, table [rows,128] f32, gg [n,3] f32,
// dgup [n,2L] f32, dtab [rows,128] f32 (zeroed here), dx [n,3] f32 or null.
int brick_bwd2(const void* g_up, const void* x, const void* table,
               const void* gg, BrickMeta meta, void* dgup, void* dtab,
               void* dx, long long n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(dtab, 0, (size_t)total_rows(meta) * 128 * sizeof(float),
                  st);
  if (n > 0 && meta.n_levels > 0) {
    brick_bwd2_kernel<<<n_blocks(n, BRICK_POINTS), 32 * meta.n_levels, 0,
                        st>>>(
        (const float2*)g_up, (const float*)x, (const float2*)table,
        (const float*)gg, meta, (float2*)dgup, (float2*)dtab, (float*)dx, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
