// F=4 bf16-packed cell permutohedral encoding: forward (B14), its
// backward (B15) and nablas (B16).
//
// Replaces the TPU kernels nr3d_lib_tpu/ops/permuto_cell4.py
// `_fwd4_kernel_v3` (via `_encode4_pallas`), `_bwd4_kernel_v3` (via
// `_bwd4_pallas`) and `_dydx4_kernel_v3` (via `_dydx4_pallas`), together
// with their XLA prologues (`_prologue4`: the simplex search, the cell
// hash and the lane indices), which run here inside the kernels.
//
// What bounds it on an H100: each (point, level) does the simplex search
// (elevation, rounding, an O(d^2) rank, the sum fix-up: ~150 float and
// integer operations at d = 4), then d+1 = 5 dependent random 8-byte loads
// from one 1 KB cell row chosen by a hash. The packed table (14,080 rows x
// 512 B = 7.2 MB at the dynamic NeuS's width) stays resident in the 50 MB
// L2, so the loads are L2 latency bound, well above the DRAM bound of the
// points' own bytes (16 B in, 64 B out per point).
// Design: one thread per (point, level) for the forward and the backward,
// one thread per point looping over levels for the nablas (its [N,d]
// output sums over levels, so a thread owns a point and needs no
// atomics). All levels go in one launch. The TPU kernels' level groups,
// A/B row buffers, lane-pattern extraction and MXU reduce/weight matrices
// exist only for the TPU and are not carried over; no shared memory.
//
// The backward scatters dL/dtable into the natural unpacked layout
// [rows, 256] (lane 2*lane_k + f): vertex k's 4 features are contiguous
// there and 16-byte aligned (lane_k is even), so each (point, level,
// vertex) is one float4 atomicAdd. The dense coarse level (1792 rows at
// the dynamic NeuS) takes every point's atomics, so the backward is bound
// by L2 atomic throughput; the sums' order changes from run to run.
//
// The simplex search, the dL/dx algebra (elevation_vjp) and the
// bit-exactness rules live in permuto_simplex.cuh, shared with the F=2
// kernels of permuto_cell.cu. Packed words are only loaded, shifted and
// masked.

#include "permuto_simplex.cuh"

// packed word pair of a vertex: bf16(f0) | bf16(f1) << 16, bf16(f2) |
// bf16(f3) << 16
__device__ __forceinline__ void unpack4(uint2 w, float f[4]) {
  f[0] = __uint_as_float(w.x << 16);
  f[1] = __uint_as_float(w.x & 0xFFFF0000u);
  f[2] = __uint_as_float(w.y << 16);
  f[3] = __uint_as_float(w.y & 0xFFFF0000u);
}

// B14: one thread per (point, level) -> y [n, L] float4.
template <int D>
__global__ void permuto4_fwd_kernel(const float* __restrict__ x,
                                    const uint2* __restrict__ table,
                                    const __grid_constant__ PCMeta meta,
                                    float4* __restrict__ y, long long n) {
  const int L = meta.n_levels;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * L) return;
  const long long p = i / L;
  const int l = (int)(i - p * L);
  float xp[D];
#pragma unroll
  for (int a = 0; a < D; ++a) xp[a] = x[p * D + a];
  Simplex<D> s;
  find_simplex<D>(xp, meta, meta.lv[l], s);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k <= D; ++k) {
    float f[4];
    unpack4(__ldg(table + s.vtx[k]), f);
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += s.bary[k] * f[q];
  }
  y[i] = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// 16-byte atomic add into global memory (one instruction on sm_90).
__device__ __forceinline__ void atomic_add4(float4* dst, float4 v) {
#if __CUDACC_VER_MAJOR__ > 12 || \
    (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1)
  atomicAdd(dst, v);
#else
  atomicAdd(&dst->x, v.x);
  atomicAdd(&dst->y, v.y);
  atomicAdd(&dst->z, v.z);
  atomicAdd(&dst->w, v.w);
#endif
}

// B15: one thread per (point, level). dtab [rows, 64] float4 (zeroed by
// the caller) += bary_k * g at vertex k. With dx (zeroed, may be null):
// dL/dx += the level's elevation vjp of gf_k = g . val_k, the vertex
// values read from the packed table.
template <int D>
__global__ void permuto4_bwd_kernel(const float* __restrict__ x,
                                    const float4* __restrict__ g,
                                    const uint2* __restrict__ table,
                                    const __grid_constant__ PCMeta meta,
                                    float4* __restrict__ dtab,
                                    float* __restrict__ dx, long long n) {
  const int L = meta.n_levels;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * L) return;
  const long long p = i / L;
  const int l = (int)(i - p * L);
  float xp[D];
#pragma unroll
  for (int a = 0; a < D; ++a) xp[a] = x[p * D + a];
  const PCLevel& lv = meta.lv[l];
  Simplex<D> s;
  find_simplex<D>(xp, meta, lv, s);
  const float4 gv = g[i];
  float gf[D + 1];
#pragma unroll
  for (int k = 0; k <= D; ++k) {
    const float w = s.bary[k];
    atomic_add4(dtab + s.vtx[k],
                make_float4(w * gv.x, w * gv.y, w * gv.z, w * gv.w));
    if (dx != nullptr) {
      float f[4];
      unpack4(__ldg(table + s.vtx[k]), f);
      gf[k] = gv.x * f[0] + gv.y * f[1] + gv.z * f[2] + gv.w * f[3];
    }
  }
  if (dx != nullptr) {
    float d[D];
#pragma unroll
    for (int a = 0; a < D; ++a) d[a] = 0.f;
    elevation_vjp<D>(s, gf, meta, lv, d);
#pragma unroll
    for (int a = 0; a < D; ++a) atomicAdd(dx + p * D + a, d[a]);
  }
}

// B16: one thread per point, looping over levels -> dx [n, D].
template <int D>
__global__ void permuto4_dydx_kernel(const float4* __restrict__ g_up,
                                     const float* __restrict__ x,
                                     const uint2* __restrict__ table,
                                     const __grid_constant__ PCMeta meta,
                                     float* __restrict__ dx, long long n) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int L = meta.n_levels;
  float xp[D], d[D];
#pragma unroll
  for (int a = 0; a < D; ++a) {
    xp[a] = x[p * D + a];
    d[a] = 0.f;
  }
  for (int l = 0; l < L; ++l) {
    const PCLevel& lv = meta.lv[l];
    Simplex<D> s;
    find_simplex<D>(xp, meta, lv, s);
    const float4 g = g_up[p * L + l];
    float gf[D + 1];
#pragma unroll
    for (int k = 0; k <= D; ++k) {
      float f[4];
      unpack4(__ldg(table + s.vtx[k]), f);
      gf[k] = g.x * f[0] + g.y * f[1] + g.z * f[2] + g.w * f[3];
    }
    elevation_vjp<D>(s, gf, meta, lv, d);
  }
#pragma unroll
  for (int a = 0; a < D; ++a) dx[p * D + a] = d[a];
}

extern "C" {

// x [n,d] f32, table packed [rows,128] 32-bit words, y [n,4L] f32.
int permuto4_fwd(const void* x, const void* table, PCMeta meta, void* y,
                 long long n, void* stream) {
  const long long total = n * meta.n_levels;
  if (total > 0) {
    const int threads = 256;
#define PC4_FWD(D)                                                       \
  permuto4_fwd_kernel<D><<<pc_blocks_for(total, threads), threads, 0,    \
                           (cudaStream_t)stream>>>(                      \
      (const float*)x, (const uint2*)table, meta, (float4*)y, n)
    PC_DISPATCH(meta.n_dims, PC4_FWD)
#undef PC4_FWD
  }
  return (int)cudaGetLastError();
}

// x [n,d] f32, g [n,4L] f32, table packed [rows,128] (needed only with
// dx), dtab [rows,256] f32 (zeroed here), dx [n,d] f32 or null (zeroed
// here).
int permuto4_bwd(const void* x, const void* g, const void* table,
                 PCMeta meta, void* dtab, void* dx, long long n,
                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dx != nullptr && table == nullptr) return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(dtab, 0,
                  (size_t)pc_total_rows(meta) * 256 * sizeof(float), st);
  if (dx != nullptr)
    cudaMemsetAsync(dx, 0, (size_t)n * meta.n_dims * sizeof(float), st);
  const long long total = n * meta.n_levels;
  if (total > 0) {
    const int threads = 256;
#define PC4_BWD(D)                                                         \
  permuto4_bwd_kernel<D>                                                   \
      <<<pc_blocks_for(total, threads), threads, 0, st>>>(                 \
      (const float*)x, (const float4*)g, (const uint2*)table, meta,        \
      (float4*)dtab, (float*)dx, n)
    PC_DISPATCH(meta.n_dims, PC4_BWD)
#undef PC4_BWD
  }
  return (int)cudaGetLastError();
}

// g_up [n,4L] f32, x [n,d] f32, table packed [rows,128], dx [n,d] f32.
int permuto4_dydx(const void* g_up, const void* x, const void* table,
                  PCMeta meta, void* dx, long long n, void* stream) {
  if (n > 0) {
    const int threads = 256;
#define PC4_DYDX(D)                                                        \
  permuto4_dydx_kernel<D><<<pc_blocks_for(n, threads), threads, 0,         \
                            (cudaStream_t)stream>>>(                       \
      (const float4*)g_up, (const float*)x, (const uint2*)table, meta,     \
      (float*)dx, n)
    PC_DISPATCH(meta.n_dims, PC4_DYDX)
#undef PC4_DYDX
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
