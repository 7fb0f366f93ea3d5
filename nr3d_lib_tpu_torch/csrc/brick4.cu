// F=4 bf16-packed brick LoTD encoding: forward (B1) and nablas (B3).
//
// Replaces the TPU kernels nr3d_lib_tpu/ops/lotd_brick4.py
// `_fwd4_kernel_v3` (via `_brick4_fwd_pallas`, want_g=False) and
// `_dydx4_kernel_v3` (via `_brick4_dydx_pallas`).
//
// What bounds it on an H100: each (point, level) reads 8 corners x 8 bytes
// from one 512-byte brick row chosen by a hash, so the work is 8 dependent
// random 8-byte loads per (point, level) plus ~40 flops. The packed table
// (4221 rows x 512 B = 2.2 MB at the production width) stays resident in
// the 50 MB L2, so the loads are L2 latency/transaction bound, far above
// the DRAM bound of the points' own bytes (12 B in, 32 B out per point).
// Design: one thread per (point, level) for the forward and one thread per
// point for the nablas (its [N,3] output sums over levels, so a thread owns
// a point and no atomics are needed); the index math (the JAX `_prologue`)
// runs in the kernel, so nothing but x, the table and the output touches
// device memory. No shared memory: the row is used once per thread.
// The TPU kernels' software pipelining, lane patterns and MXU reductions
// exist only for the TPU and are not carried over.
//
// Bit-exactness notes. x*(res-2)+0.5 uses __fmul_rn/__fadd_rn: nvcc would
// contract it into an FMA, which moves points on a cell boundary into the
// neighbouring cell relative to the plain version. Packed words are only
// loaded, shifted and masked; no arithmetic touches packed bits.

#include <cstdint>
#include <cuda_runtime.h>

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

__global__ void brick4_fwd_kernel(const float* __restrict__ x,
                                  const uint2* __restrict__ table,
                                  const __grid_constant__ Brick4Meta meta,
                                  float4* __restrict__ y, long long n) {
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
    float f[4];
    unpack4(__ldg(rowp + dx * 16 + dy * 4 + dz), f);
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += w * f[q];
  }
  y[i] = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

__global__ void brick4_dydx_kernel(const float4* __restrict__ g_up,
                                   const float* __restrict__ x,
                                   const uint2* __restrict__ table,
                                   const __grid_constant__ Brick4Meta meta,
                                   float* __restrict__ dx, long long n) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int L = meta.n_levels;
  const float xp[3] = {x[p * 3], x[p * 3 + 1], x[p * 3 + 2]};
  float d[3] = {0.f, 0.f, 0.f};
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

extern "C" {

// x [n,3] f32, table packed [rows,128] 32-bit words, y [n,4L] f32.
int brick4_fwd(const void* x, const void* table, Brick4Meta meta, void* y,
               long long n, void* stream) {
  const long long total = n * meta.n_levels;
  if (total > 0) {
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    brick4_fwd_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const uint2*)table, meta, (float4*)y, n);
  }
  return (int)cudaGetLastError();
}

// g_up [n,4L] f32, x [n,3] f32, table packed [rows,128], dx [n,3] f32.
int brick4_dydx(const void* g_up, const void* x, const void* table,
                Brick4Meta meta, void* dx, long long n, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    brick4_dydx_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
        (const float4*)g_up, (const float*)x, (const uint2*)table, meta,
        (float*)dx, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
