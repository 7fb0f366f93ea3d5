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
// dL/dx (B15 with need_dx, B16): with gf_k = g . val_k, the barycentric
// weights bary_k = vdiff[rank=d-k] - vdiff[rank=d+1-k] (bary_0 = vdiff[rank
// = d] + 1 - vdiff[rank=0]) give dL/dvdiff_i = gf[d - rank_i] -
// gf[rank_i == 0 ? 0 : d+1-rank_i]; dL/delevated_i = that / (d+1); and
// through the elevation elevated_i = sum_{j>=i} cf_j - i*cf_{i-1},
// dL/dcf_a = sum_{i<=a} delev_i - (a+1)*delev_{a+1}; dL/dx_a = dL/dcf_a *
// sf_a * scale_a.
//
// Bit-exactness notes. The simplex search must choose the plain
// version's simplex and row: every float operation of the elevation and
// the rounding uses __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn, so nvcc
// cannot contract `tail - i*cf` into an FMA; the sums run from the last
// coordinate, as the plain version's; sf comes from the host as float32;
// a rounding tie goes down; rank ties break by index; the remainder sum
// is an exact multiple of d+1, so its rounding is an integer division;
// negative coordinates hash as int -> uint32 (well defined). Packed words
// are only loaded, shifted and masked.

#include <cstdint>
#include <cuda_runtime.h>

#define PC4_MAX_DIMS 5
#define PC4_MAX_LEVELS 16

struct PC4Level {
  float scale[PC4_MAX_DIMS];
  int box_lo[PC4_MAX_DIMS];
  int box_dims[PC4_MAX_DIMS];
  int n_rows;
  int row_offset;  // into the concatenated table
  int is_dense;
};

struct PC4Meta {
  int n_dims;
  int n_levels;
  int cells_per_row;
  float sf[PC4_MAX_DIMS];  // hyperplane factors, float32 from the host
  PC4Level lv[PC4_MAX_LEVELS];
};

// nr3d_lib_tpu/ops/lotd.py HASH_PRIMES[0:5]
__device__ __constant__ uint32_t kPrimes[PC4_MAX_DIMS] = {
    1u, 2654435761u, 805459861u, 3674653429u, 2097192037u};

template <int D>
struct Simplex {
  long long quad[D + 1];  // float4 index of vertex k in [rows, 256]
  float bary[D + 1];
  int rank[D + 1];
};

template <int D>
__device__ __forceinline__ void find_simplex(const float* xp,
                                             const PC4Meta& m,
                                             const PC4Level& L,
                                             Simplex<D>& s) {
  constexpr int DP1 = D + 1;
  const float fdp1 = (float)DP1;
  float cf[D];
#pragma unroll
  for (int a = 0; a < D; ++a)
    cf[a] = __fmul_rn(__fmul_rn(xp[a], L.scale[a]), m.sf[a]);
  // elevated[i] = sum_{j>=i} cf_j - i*cf_{i-1}, sums from the last coord
  float rev[D];
  rev[D - 1] = cf[D - 1];
#pragma unroll
  for (int i = D - 2; i >= 0; --i) rev[i] = __fadd_rn(rev[i + 1], cf[i]);
  float elev[DP1];
  elev[0] = rev[0];
#pragma unroll
  for (int i = 1; i <= D; ++i) {
    const float tail = i < D ? rev[i] : 0.f;
    elev[i] = __fsub_rn(tail, __fmul_rn((float)i, cf[i - 1]));
  }
  // nearest remainder-0 point (ties down)
  int rem0[DP1];
  float diff[DP1];
  int sum = 0;
#pragma unroll
  for (int i = 0; i <= D; ++i) {
    const float v = __fdiv_rn(elev[i], fdp1);
    const float up = __fmul_rn(ceilf(v), fdp1);
    const float down = __fmul_rn(floorf(v), fdp1);
    const float r =
        __fsub_rn(up, elev[i]) < __fsub_rn(elev[i], down) ? up : down;
    rem0[i] = (int)r;
    diff[i] = __fsub_rn(elev[i], r);
    sum += rem0[i];
  }
  const int sum_ = sum / DP1;  // an exact multiple of d+1
  // rank[i] = #{j: diff_i < diff_j} + #{j < i: diff_i == diff_j}
#pragma unroll
  for (int i = 0; i <= D; ++i) {
    int r = 0;
#pragma unroll
    for (int j = 0; j <= D; ++j)
      r += (diff[i] < diff[j]) || (j < i && diff[i] == diff[j]);
    r += sum_;
    if (r < 0) {
      r += DP1;
      rem0[i] += DP1;
    } else if (r > D) {
      r -= DP1;
      rem0[i] -= DP1;
    }
    s.rank[i] = r;
  }
  // barycentric weights from the sorted differential
  float vd_by_rank[DP1];
#pragma unroll
  for (int r = 0; r <= D; ++r) vd_by_rank[r] = 0.f;
#pragma unroll
  for (int i = 0; i <= D; ++i) {
    const float vd = __fdiv_rn(__fsub_rn(elev[i], (float)rem0[i]), fdp1);
#pragma unroll
    for (int r = 0; r <= D; ++r)
      if (s.rank[i] == r) vd_by_rank[r] = vd;
  }
  s.bary[0] = __fsub_rn(__fadd_rn(vd_by_rank[D], 1.f), vd_by_rank[0]);
#pragma unroll
  for (int k = 1; k <= D; ++k)
    s.bary[k] = __fsub_rn(vd_by_rank[D - k], vd_by_rank[DP1 - k]);
  // the cell's row: a bijective box index (dense) or a hash of rem0
  const int c = m.cells_per_row;
  long long idx;
  if (L.is_dense) {
    idx = 0;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      int k = rem0[i] / DP1 - L.box_lo[i];  // exact: rem0 is a multiple
      k = min(max(k, 0), L.box_dims[i] - 1);
      idx = idx * L.box_dims[i] + k;
    }
  } else {
    uint32_t h = (uint32_t)rem0[0] * kPrimes[0];
#pragma unroll
    for (int i = 1; i < D; ++i) h ^= (uint32_t)rem0[i] * kPrimes[i];
    idx = (long long)(h % ((uint32_t)L.n_rows * (uint32_t)c));
  }
  const long long row = idx / c + L.row_offset;
  const int lane_base = (int)(idx % c) * (2 << DP1);  // F=2 lanes per cell
  // vertex k at slot sum_i [rank_i >= d+1-k] 2^i; its F=2 lane is
  // lane_base + 2*slot and its four unpacked features start at twice that
#pragma unroll
  for (int k = 0; k <= D; ++k) {
    int slot = 0;
#pragma unroll
    for (int i = 0; i <= D; ++i) slot |= (s.rank[i] >= DP1 - k) << i;
    s.quad[k] = row * 64 + (lane_base + 2 * slot) / 2;
  }
}

// packed word pair of a vertex: bf16(f0) | bf16(f1) << 16, bf16(f2) |
// bf16(f3) << 16
__device__ __forceinline__ void unpack4(uint2 w, float f[4]) {
  f[0] = __uint_as_float(w.x << 16);
  f[1] = __uint_as_float(w.x & 0xFFFF0000u);
  f[2] = __uint_as_float(w.y << 16);
  f[3] = __uint_as_float(w.y & 0xFFFF0000u);
}

// dL/dx [D] of one level from gf [D+1] (g . val_k), accumulated into dx
template <int D>
__device__ __forceinline__ void elevation_vjp(const Simplex<D>& s,
                                              const float gf[D + 1],
                                              const PC4Meta& m,
                                              const PC4Level& L,
                                              float dx[D]) {
  constexpr int DP1 = D + 1;
  float delev[DP1];
#pragma unroll
  for (int i = 0; i <= D; ++i) {
    float g1 = 0.f, g2 = 0.f;
    const int t1 = D - s.rank[i];
    const int t2 = s.rank[i] == 0 ? 0 : DP1 - s.rank[i];
#pragma unroll
    for (int k = 0; k <= D; ++k) {
      if (k == t1) g1 = gf[k];
      if (k == t2) g2 = gf[k];
    }
    delev[i] = (g1 - g2) / (float)DP1;
  }
  float run = 0.f;
#pragma unroll
  for (int a = 0; a < D; ++a) {
    run += delev[a];
    const float dcf = run - (float)(a + 1) * delev[a + 1];
    dx[a] += dcf * m.sf[a] * L.scale[a];
  }
}

// B14: one thread per (point, level) -> y [n, L] float4.
template <int D>
__global__ void permuto4_fwd_kernel(const float* __restrict__ x,
                                    const uint2* __restrict__ table,
                                    const __grid_constant__ PC4Meta meta,
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
    unpack4(__ldg(table + s.quad[k]), f);
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
                                    const __grid_constant__ PC4Meta meta,
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
  const PC4Level& lv = meta.lv[l];
  Simplex<D> s;
  find_simplex<D>(xp, meta, lv, s);
  const float4 gv = g[i];
  float gf[D + 1];
#pragma unroll
  for (int k = 0; k <= D; ++k) {
    const float w = s.bary[k];
    atomic_add4(dtab + s.quad[k],
                make_float4(w * gv.x, w * gv.y, w * gv.z, w * gv.w));
    if (dx != nullptr) {
      float f[4];
      unpack4(__ldg(table + s.quad[k]), f);
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
                                     const __grid_constant__ PC4Meta meta,
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
    const PC4Level& lv = meta.lv[l];
    Simplex<D> s;
    find_simplex<D>(xp, meta, lv, s);
    const float4 g = g_up[p * L + l];
    float gf[D + 1];
#pragma unroll
    for (int k = 0; k <= D; ++k) {
      float f[4];
      unpack4(__ldg(table + s.quad[k]), f);
      gf[k] = g.x * f[0] + g.y * f[1] + g.z * f[2] + g.w * f[3];
    }
    elevation_vjp<D>(s, gf, meta, lv, d);
  }
#pragma unroll
  for (int a = 0; a < D; ++a) dx[p * D + a] = d[a];
}

static long long total_rows(const PC4Meta& meta) {
  const PC4Level& last = meta.lv[meta.n_levels - 1];
  return (long long)last.row_offset + last.n_rows;
}

static unsigned blocks_for(long long total, int threads) {
  return (unsigned)((total + threads - 1) / threads);
}

// the kernels are instantiated for d = 2..5; another d is refused
#define PC4_DISPATCH(D_RUNTIME, LAUNCH) \
  switch (D_RUNTIME) {                  \
    case 2: LAUNCH(2); break;           \
    case 3: LAUNCH(3); break;           \
    case 4: LAUNCH(4); break;           \
    case 5: LAUNCH(5); break;           \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" {

// x [n,d] f32, table packed [rows,128] 32-bit words, y [n,4L] f32.
int permuto4_fwd(const void* x, const void* table, PC4Meta meta, void* y,
                 long long n, void* stream) {
  const long long total = n * meta.n_levels;
  if (total > 0) {
    const int threads = 256;
#define PC4_FWD(D)                                                       \
  permuto4_fwd_kernel<D><<<blocks_for(total, threads), threads, 0,       \
                           (cudaStream_t)stream>>>(                      \
      (const float*)x, (const uint2*)table, meta, (float4*)y, n)
    PC4_DISPATCH(meta.n_dims, PC4_FWD)
#undef PC4_FWD
  }
  return (int)cudaGetLastError();
}

// x [n,d] f32, g [n,4L] f32, table packed [rows,128] (needed only with
// dx), dtab [rows,256] f32 (zeroed here), dx [n,d] f32 or null (zeroed
// here).
int permuto4_bwd(const void* x, const void* g, const void* table,
                 PC4Meta meta, void* dtab, void* dx, long long n,
                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dx != nullptr && table == nullptr) return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(dtab, 0, (size_t)total_rows(meta) * 256 * sizeof(float),
                  st);
  if (dx != nullptr)
    cudaMemsetAsync(dx, 0, (size_t)n * meta.n_dims * sizeof(float), st);
  const long long total = n * meta.n_levels;
  if (total > 0) {
    const int threads = 256;
#define PC4_BWD(D)                                                         \
  permuto4_bwd_kernel<D><<<blocks_for(total, threads), threads, 0, st>>>(  \
      (const float*)x, (const float4*)g, (const uint2*)table, meta,        \
      (float4*)dtab, (float*)dx, n)
    PC4_DISPATCH(meta.n_dims, PC4_BWD)
#undef PC4_BWD
  }
  return (int)cudaGetLastError();
}

// g_up [n,4L] f32, x [n,d] f32, table packed [rows,128], dx [n,d] f32.
int permuto4_dydx(const void* g_up, const void* x, const void* table,
                  PC4Meta meta, void* dx, long long n, void* stream) {
  if (n > 0) {
    const int threads = 256;
#define PC4_DYDX(D)                                                        \
  permuto4_dydx_kernel<D><<<blocks_for(n, threads), threads, 0,            \
                            (cudaStream_t)stream>>>(                       \
      (const float4*)g_up, (const float*)x, (const uint2*)table, meta,     \
      (float*)dx, n)
    PC4_DISPATCH(meta.n_dims, PC4_DYDX)
#undef PC4_DYDX
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
