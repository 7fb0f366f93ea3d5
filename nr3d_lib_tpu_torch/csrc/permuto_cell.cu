// F=2 cell permutohedral encoding: forward (B10), its backward (B11 for
// dL/dtable alone, B12 with dL/dx) and nablas (B13).
//
// Replaces the TPU kernels nr3d_lib_tpu/ops/permuto_cell.py
// `_fwd_kernel_v3` (via `_encode_pallas`), `_bwd_kernel_v3` (via
// `_bwd_table_pallas`), `_bwd_full_kernel_v3` (via `_bwd_full_pallas`) and
// `_dydx_kernel_v3` (via `_dydx_pallas`), together with their XLA
// prologues (`_prologue`: the simplex search, the cell hash and the lane
// indices; `_dx_selectors` and `_dx_weight_matrix`: the rank selectors and
// the elevation Jacobian of dL/dx), which run here inside the kernels.
//
// What bounds it on an H100: each (point, level) does the simplex search
// (elevation, rounding, an O(d^2) rank, the sum fix-up: ~150-240 float and
// integer operations at d = 3-4), then d+1 dependent random 8-byte loads
// from one 512 B cell row chosen by a hash. The f32 table (20,480 rows x
// 512 B = 10.5 MB for the dynamic NeuS, 30,657 rows = 15.7 MB for the 3D
// fields) stays resident in the 50 MB L2, so the loads hit L2, well above
// the DRAM bound of the points' own bytes. On an H100 (700 W) the
// forward's simplex search alone, its loads removed, takes 0.057 of its
// 0.066 ms at the dynamic NeuS's 393,216 points x 5 levels: the search's
// instructions, not the loads, bound it.
// Design: the forward gives each warp 32 consecutive points at one level
// (a block takes the run at all levels). The paths feed points ray by
// ray, so at the coarse levels a warp's neighbours share a cell row and
// its loads merge into few sectors; each warp reads its level's meta
// uniformly. The backward is one thread per (point, level), the nablas
// one thread per point looping over levels (its [N,d] output sums over
// levels, so a thread owns a point and needs no atomics). All levels go
// in one launch. The TPU kernels' level groups, A/B row buffers,
// lane-pattern extraction, MXU reduce/weight matrices and point chunking
// exist only for the TPU and are not carried over.
//
// Vertex k's two features sit at lanes lane_k, lane_k + 1 of its row
// (lane_k even), so one aligned float2 load reads both and one float2
// atomicAdd scatters both gradients into dL/dtable [rows, 128]. The
// backward is bound by L2 atomic throughput, worst on a dense level (the
// 3D fields' level 0, 1985 rows, takes every point's atomics); the sums'
// order changes from run to run. At d = 4 the TPU layout pads each level
// to 8 vertex slots; here a thread simply loops over the d+1 real ones.
//
// The simplex search, the dL/dx algebra (elevation_vjp) and the
// bit-exactness rules live in permuto_simplex.cuh, shared with the F=4
// kernels of permuto_cell4.cu.

#include "permuto_simplex.cuh"

// B10's run of consecutive points: one warp's width at each level
constexpr int PC_FWD_POINTS = 32;

// B10: a block takes a run of PC_FWD_POINTS consecutive points at all L
// levels (blockDim = 32 L), warp l the run at level l -> y [n, L] float2.
// x is staged in shared memory once, y through shared memory so that the
// block's [points, L] store is one coalesced run.
template <int D>
__global__ void permuto_fwd_kernel(const float* __restrict__ x,
                                   const float2* __restrict__ table,
                                   const __grid_constant__ PCMeta meta,
                                   float2* __restrict__ y, long long n) {
  __shared__ float xs[PC_FWD_POINTS * D];
  __shared__ float2 ys[PC_FWD_POINTS * PC_MAX_LEVELS];
  const int L = meta.n_levels;
  const long long p0 = (long long)blockIdx.x * PC_FWD_POINTS;
  const int np = (int)min((long long)PC_FWD_POINTS, n - p0);
  for (int k = threadIdx.x; k < np * D; k += blockDim.x)
    xs[k] = x[p0 * D + k];
  __syncthreads();
  const int l = threadIdx.x >> 5, i = threadIdx.x & 31;
  if (i < np) {
    float xp[D];
#pragma unroll
    for (int a = 0; a < D; ++a) xp[a] = xs[i * D + a];
    Simplex<D> s;
    find_simplex<D>(xp, meta, meta.lv[l], s);
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int k = 0; k <= D; ++k) {
      const float2 v = __ldg(table + s.vtx[k]);
      a0 += s.bary[k] * v.x;
      a1 += s.bary[k] * v.y;
    }
    ys[i * L + l] = make_float2(a0, a1);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < np * L; k += blockDim.x) y[p0 * L + k] = ys[k];
}

// 8-byte atomic add into global memory (one instruction on sm_90).
__device__ __forceinline__ void atomic_add2(float2* dst, float2 v) {
#if __CUDACC_VER_MAJOR__ > 12 || \
    (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1)
  atomicAdd(dst, v);
#else
  atomicAdd(&dst->x, v.x);
  atomicAdd(&dst->y, v.y);
#endif
}

// B11 / B12: one thread per (point, level). dtab [rows, 64] float2
// (zeroed by the caller) += bary_k * g at vertex k. With dx (zeroed, may
// be null; B12): dL/dx += the level's elevation vjp of gf_k = g . val_k.
template <int D>
__global__ void permuto_bwd_kernel(const float* __restrict__ x,
                                   const float2* __restrict__ g,
                                   const float2* __restrict__ table,
                                   const __grid_constant__ PCMeta meta,
                                   float2* __restrict__ dtab,
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
  const float2 gv = g[i];
  float gf[D + 1];
#pragma unroll
  for (int k = 0; k <= D; ++k) {
    const float w = s.bary[k];
    atomic_add2(dtab + s.vtx[k], make_float2(w * gv.x, w * gv.y));
    if (dx != nullptr) {
      const float2 v = __ldg(table + s.vtx[k]);
      gf[k] = gv.x * v.x + gv.y * v.y;
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

// B13: one thread per point, looping over levels -> dx [n, D].
template <int D>
__global__ void permuto_dydx_kernel(const float2* __restrict__ g_up,
                                    const float* __restrict__ x,
                                    const float2* __restrict__ table,
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
    const float2 g = g_up[p * L + l];
    float gf[D + 1];
#pragma unroll
    for (int k = 0; k <= D; ++k) {
      const float2 v = __ldg(table + s.vtx[k]);
      gf[k] = g.x * v.x + g.y * v.y;
    }
    elevation_vjp<D>(s, gf, meta, lv, d);
  }
#pragma unroll
  for (int a = 0; a < D; ++a) dx[p * D + a] = d[a];
}

extern "C" {

// x [n,d] f32, table [rows,128] f32, y [n,2L] f32.
int permuto_fwd(const void* x, const void* table, PCMeta meta, void* y,
                long long n, void* stream) {
  if (n > 0 && meta.n_levels > 0) {
    const int threads = 32 * meta.n_levels;
#define PC_FWD(D)                                                        \
  permuto_fwd_kernel<D><<<pc_blocks_for(n, PC_FWD_POINTS), threads, 0,   \
                          (cudaStream_t)stream>>>(                       \
      (const float*)x, (const float2*)table, meta, (float2*)y, n)
    PC_DISPATCH(meta.n_dims, PC_FWD)
#undef PC_FWD
  }
  return (int)cudaGetLastError();
}

// x [n,d] f32, g [n,2L] f32, table [rows,128] f32 (needed only with dx),
// dtab [rows,128] f32 (zeroed here), dx [n,d] f32 or null (zeroed here).
int permuto_bwd(const void* x, const void* g, const void* table,
                PCMeta meta, void* dtab, void* dx, long long n,
                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dx != nullptr && table == nullptr) return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(dtab, 0,
                  (size_t)pc_total_rows(meta) * 128 * sizeof(float), st);
  if (dx != nullptr)
    cudaMemsetAsync(dx, 0, (size_t)n * meta.n_dims * sizeof(float), st);
  const long long total = n * meta.n_levels;
  if (total > 0) {
    const int threads = 256;
#define PC_BWD(D)                                                          \
  permuto_bwd_kernel<D>                                                    \
      <<<pc_blocks_for(total, threads), threads, 0, st>>>(                 \
      (const float*)x, (const float2*)g, (const float2*)table, meta,       \
      (float2*)dtab, (float*)dx, n)
    PC_DISPATCH(meta.n_dims, PC_BWD)
#undef PC_BWD
  }
  return (int)cudaGetLastError();
}

// g_up [n,2L] f32, x [n,d] f32, table [rows,128] f32, dx [n,d] f32.
int permuto_dydx(const void* g_up, const void* x, const void* table,
                 PCMeta meta, void* dx, long long n, void* stream) {
  if (n > 0) {
    const int threads = 256;
#define PC_DYDX(D)                                                         \
  permuto_dydx_kernel<D><<<pc_blocks_for(n, threads), threads, 0,          \
                           (cudaStream_t)stream>>>(                        \
      (const float2*)g_up, (const float*)x, (const float2*)table, meta,    \
      (float*)dx, n)
    PC_DISPATCH(meta.n_dims, PC_DYDX)
#undef PC_DYDX
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
