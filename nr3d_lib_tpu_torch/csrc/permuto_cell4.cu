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
// (elevation, rounding, rank, the sum fix-up, the cell index: ~240 float
// and integer operations at d = 4), then d+1 = 5 dependent random 8-byte
// loads from one 1 KB cell row chosen by a hash. The packed table (14,080
// rows x 512 B = 7.2 MB at the dynamic NeuS's width) stays resident in the
// 50 MB L2, so the loads hit L2; the points' own bytes (16 B in, 64 B out
// per point) bound it far lower. Measured on an H100 at 700 W
// (chip_ab.py, path C's 393,216 points in ray order): B14 takes 0.0312
// ms and 0.0281 without its table loads, so the search's instructions
// bound it; B15 takes 0.0678 ms, 0.0381 without its atomics and 0.1735
// with one atomic per lane: its 5 float4 atomics a (point, level) bound
// it, and the warps' aggregation leaves 2.96 M of them (of 7.86 M). B16
// takes 0.0307 ms (0.0340 as one thread per point looping over the
// levels), 0.0287 without its table loads and 0.0288 without loads and
// vjp: the search bounds it too.
//
// Design. All three kernels give each warp 32 consecutive points at one
// level; a block takes the run at all L levels (blockDim = 32 L), so each
// warp reads its level's meta uniformly. The forward and the backward
// stage x in shared memory once, and y (and the backward's g) pass
// through shared memory, so that the block's [points, L] rows move as one
// coalesced run; the nablas (B16) read x and g_up lane by lane.
// The paths feed points ray by ray (96 samples a ray, t constant along
// it), so at the coarse levels a warp's lanes mostly fall in one cell:
// the forward's loads merge into few sectors, and the backward's lanes
// that add to one slot (`__match_any_sync` on vertex k's slot) sum their
// float4s in the warp and issue one atomic for the group. (Whole warps
// rarely agree, 1,223 of 245,760 (warp, vertex) pairs at path C, so a
// butterfly fast path for them measured slower: 0.0747 ms.) dL/dx, when
// asked for, sums each point's levels in shared memory in level order and
// is written once: no atomics, no memset, and the same bits whatever the
// order of the points. The nablas sum their levels the same way, from
// `elevation_terms`' rank table in shared memory (B13's form,
// permuto_cell.cu): the table, in place of elevation_vjp's 2(d+1)^2
// compares and selects (0.0382 ms), keeps the one-thread-per-point form's
// bits. In a random order of the points B16 takes 0.0497 ms, the
// one-thread-per-point form 0.0481. The TPU kernels' level groups, A/B
// row buffers, lane-pattern extraction and MXU reduce/weight matrices
// exist only for the TPU and are not carried over.
//
// The backward scatters dL/dtable into the natural unpacked layout
// [rows, 256] (lane 2*lane_k + f): vertex k's 4 features are contiguous
// there and 16-byte aligned (lane_k is even), so each group's sum is one
// float4 atomicAdd; the sums' order changes from run to run.
//
// The simplex search, the dL/dx algebra (elevation_vjp, and B16's
// elevation_terms) and the bit-exactness rules live in
// permuto_simplex.cuh, shared with the F=2 kernels of permuto_cell.cu;
// `warp_add4` lives in warp_atomics.cuh, shared with the F=4 brick
// backwards (brick4.cu). Packed words are only loaded, shifted and
// masked.

#include "permuto_simplex.cuh"
#include "warp_atomics.cuh"

// packed word pair of a vertex: bf16(f0) | bf16(f1) << 16, bf16(f2) |
// bf16(f3) << 16
__device__ __forceinline__ void unpack4(uint2 w, float f[4]) {
  f[0] = __uint_as_float(w.x << 16);
  f[1] = __uint_as_float(w.x & 0xFFFF0000u);
  f[2] = __uint_as_float(w.y << 16);
  f[3] = __uint_as_float(w.y & 0xFFFF0000u);
}

// B14-B16's run of consecutive points: one warp's width at each level
constexpr int PC4_POINTS = 32;

// B14: a block takes a run of PC4_POINTS consecutive points at all L
// levels (blockDim = 32 L), warp l the run at level l -> y [n, L] float4.
template <int D>
__global__ void permuto4_fwd_kernel(const float* __restrict__ x,
                                    const uint2* __restrict__ table,
                                    const __grid_constant__ PCMeta meta,
                                    float4* __restrict__ y, long long n) {
  __shared__ float xs[PC4_POINTS * D];
  __shared__ float4 ys[PC4_POINTS * PC_MAX_LEVELS];
  const int L = meta.n_levels;
  const long long p0 = (long long)blockIdx.x * PC4_POINTS;
  const int np = (int)min((long long)PC4_POINTS, n - p0);
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
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k <= D; ++k) {
      float f[4];
      unpack4(__ldg(table + s.vtx[k]), f);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += s.bary[k] * f[q];
    }
    ys[i * L + l] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < np * L; k += blockDim.x) y[p0 * L + k] = ys[k];
}

// B15: the blocks of B14. dtab [rows, 64] float4 (zeroed by the caller) +=
// bary_k * g at vertex k. With dx (may be null): dL/dx = the sum over the
// levels, in level order, of each level's elevation vjp of gf_k = g .
// val_k, the vertex values read from the packed table. Dynamic shared
// memory: g's [32, L] float4, x's [32, D] and, with dx, the levels'
// [L, 32, D] partials.
template <int D>
__global__ void permuto4_bwd_kernel(const float* __restrict__ x,
                                    const float4* __restrict__ g,
                                    const uint2* __restrict__ table,
                                    const __grid_constant__ PCMeta meta,
                                    float4* __restrict__ dtab,
                                    float* __restrict__ dx, long long n) {
  extern __shared__ float4 smem[];
  const int L = meta.n_levels;
  float4* gs = smem;                                   // [32, L]
  float* xs = (float*)(smem + PC4_POINTS * L);         // [32, D]
  float* dxs = xs + PC4_POINTS * D;                    // [L, 32, D]
  const long long p0 = (long long)blockIdx.x * PC4_POINTS;
  const int np = (int)min((long long)PC4_POINTS, n - p0);
  for (int k = threadIdx.x; k < np * D; k += blockDim.x)
    xs[k] = x[p0 * D + k];
  for (int k = threadIdx.x; k < np * L; k += blockDim.x)
    gs[k] = g[p0 * L + k];
  __syncthreads();
  const int l = threadIdx.x >> 5, i = threadIdx.x & 31;
  const unsigned active = __ballot_sync(0xffffffffu, i < np);
  if (i < np) {
    float xp[D];
#pragma unroll
    for (int a = 0; a < D; ++a) xp[a] = xs[i * D + a];
    const PCLevel& lv = meta.lv[l];
    Simplex<D> s;
    find_simplex<D>(xp, meta, lv, s);
    const float4 gv = gs[i * L + l];
    float gf[D + 1];
#pragma unroll
    for (int k = 0; k <= D; ++k) {
      const float w = s.bary[k];
      warp_add4(dtab, s.vtx[k],
                make_float4(w * gv.x, w * gv.y, w * gv.z, w * gv.w), active);
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
      for (int a = 0; a < D; ++a) dxs[(l * PC4_POINTS + i) * D + a] = d[a];
    }
  }
  if (dx != nullptr) {
    __syncthreads();
    for (int k = threadIdx.x; k < np * D; k += blockDim.x) {
      float sum = 0.f;
      for (int ll = 0; ll < L; ++ll) sum += dxs[ll * PC4_POINTS * D + k];
      dx[p0 * D + k] = sum;
    }
  }
}

// B16: the blocks of B14 -> dx [n, D] = the sum over the levels, in level
// order, of each level's elevation vjp of gf_k = g_up . val_k, as B13
// (permuto_cell.cu) at F=4. Each lane reads its point's x and its (point,
// level)'s float4 of g_up itself, before the search, so no barrier stands
// before the search; each (level, point) parks its terms t
// (elevation_terms) in [L, 32, D] in shared memory, and one thread a
// (point, coordinate) sums the levels there, d = fma(t, scale, d) from
// level 0, and writes dx once: the bits of elevation_vjp called level by
// level on one running dx, in any order of the points. gf_k's roundings
// are the ones nvcc made of the one-thread-per-point form's g.x * f0 +
// g.y * f1 + g.z * f2 + g.w * f3 (its SASS), written out. Dynamic shared
// memory: the [L, 32, D] terms and elevation_terms' [D+1, 32 L] rank
// tables.
template <int D>
__global__ void permuto4_dydx_kernel(const float4* __restrict__ g_up,
                                     const float* __restrict__ x,
                                     const uint2* __restrict__ table,
                                     const __grid_constant__ PCMeta meta,
                                     float* __restrict__ dx, long long n) {
  extern __shared__ float ts[];                        // [L, 32, D]
  const int L = meta.n_levels;
  float* hs = ts + L * PC4_POINTS * D;                 // [D + 1, 32 L]
  const long long p0 = (long long)blockIdx.x * PC4_POINTS;
  const int np = (int)min((long long)PC4_POINTS, n - p0);
  const int l = threadIdx.x >> 5, i = threadIdx.x & 31;
  if (i < np) {
    float xp[D];
#pragma unroll
    for (int a = 0; a < D; ++a) xp[a] = x[(p0 + i) * D + a];
    const float4 g = g_up[(p0 + i) * L + l];
    Simplex<D> s;
    find_simplex<D>(xp, meta, meta.lv[l], s);
    float gf[D + 1];
#pragma unroll
    for (int k = 0; k <= D; ++k) {
      float f[4];
      unpack4(__ldg(table + s.vtx[k]), f);
      gf[k] = __fmaf_rn(g.w, f[3], __fmaf_rn(g.z, f[2], __fmaf_rn(
                  g.x, f[0], __fmul_rn(g.y, f[1]))));
    }
    float t[D];
    elevation_terms<D>(s, gf, meta, hs + threadIdx.x, blockDim.x, t);
#pragma unroll
    for (int a = 0; a < D; ++a) ts[(l * PC4_POINTS + i) * D + a] = t[a];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < np * D; k += blockDim.x) {
    const int a = k % D;
    float d = 0.f;
    for (int ll = 0; ll < L; ++ll)
      d = __fmaf_rn(ts[ll * PC4_POINTS * D + k], meta.lv[ll].scale[a], d);
    dx[p0 * D + k] = d;
  }
}

template <int B>
__global__ void pc_check_div_kernel(unsigned long long* out) {
  unsigned long long bad = 0, first = ~0ull;
  for (unsigned long long u = blockIdx.x * blockDim.x + threadIdx.x;
       u < (1ull << 32); u += (unsigned long long)gridDim.x * blockDim.x) {
    const float x = __uint_as_float((unsigned)u);
    const float a = div_dp1<B>(x), b = __fdiv_rn(x, (float)B);
    if (__float_as_uint(a) != __float_as_uint(b) && !(a != a && b != b)) {
      ++bad;
      first = min(first, u);
    }
  }
  if (bad) {
    atomicAdd(out, bad);
    atomicMin(out + 1, first);
  }
}

__global__ void pc_check_mod_kernel(const PCLevel lv, unsigned long long* out) {
  unsigned long long bad = 0, first = ~0ull;
  for (unsigned long long u = blockIdx.x * blockDim.x + threadIdx.x;
       u < (1ull << 32); u += (unsigned long long)gridDim.x * blockDim.x) {
    const uint32_t h = (uint32_t)u;
    if (pc_mod(h, lv) != h % lv.hash_mod) {
      ++bad;
      first = min(first, u);
    }
  }
  if (bad) {
    atomicAdd(out, bad);
    atomicMin(out + 1, first);
  }
}

extern "C" {

// x [n,d] f32, table packed [rows,128] 32-bit words, y [n,4L] f32.
int permuto4_fwd(const void* x, const void* table, PCMeta meta, void* y,
                 long long n, void* stream) {
  if (n > 0 && meta.n_levels > 0) {
    const int threads = 32 * meta.n_levels;
#define PC4_FWD(D)                                                        \
  permuto4_fwd_kernel<D><<<pc_blocks_for(n, PC4_POINTS), threads, 0,      \
                           (cudaStream_t)stream>>>(                       \
      (const float*)x, (const uint2*)table, meta, (float4*)y, n)
    PC_DISPATCH(meta.n_dims, PC4_FWD)
#undef PC4_FWD
  }
  return (int)cudaGetLastError();
}

// x [n,d] f32, g [n,4L] f32, table packed [rows,128] (needed only with
// dx), dtab [rows,256] f32 (zeroed here), dx [n,d] f32 or null (written
// whole).
int permuto4_bwd(const void* x, const void* g, const void* table,
                 PCMeta meta, void* dtab, void* dx, long long n,
                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dx != nullptr && table == nullptr) return (int)cudaErrorInvalidValue;
  if (meta.n_levels > 0)
    cudaMemsetAsync(dtab, 0,
                    (size_t)pc_total_rows(meta) * 256 * sizeof(float), st);
  if (n > 0 && meta.n_levels > 0) {
    const int L = meta.n_levels, d = meta.n_dims;
    const size_t smem = sizeof(float4) * PC4_POINTS * L +
                        sizeof(float) * PC4_POINTS * d *
                            (dx != nullptr ? L + 1 : 1);
#define PC4_BWD(D)                                                         \
  permuto4_bwd_kernel<D><<<pc_blocks_for(n, PC4_POINTS), 32 * L, smem,     \
                           st>>>(                                          \
      (const float*)x, (const float4*)g, (const uint2*)table, meta,        \
      (float4*)dtab, (float*)dx, n)
    PC_DISPATCH(meta.n_dims, PC4_BWD)
#undef PC4_BWD
  } else if (n > 0 && dx != nullptr) {  // no level: dx is 0
    cudaMemsetAsync(dx, 0, sizeof(float) * n * meta.n_dims, st);
  }
  return (int)cudaGetLastError();
}

// g_up [n,4L] f32, x [n,d] f32, table packed [rows,128], dx [n,d] f32.
int permuto4_dydx(const void* g_up, const void* x, const void* table,
                  PCMeta meta, void* dx, long long n, void* stream) {
  if (n > 0) {
    const int L = meta.n_levels, d = meta.n_dims;
    cudaStream_t st = (cudaStream_t)stream;
    if (L == 0)  // no level: dx is 0
      return (int)cudaMemsetAsync(dx, 0, sizeof(float) * n * d, st);
    const size_t smem = sizeof(float) * PC4_POINTS * L * (2 * d + 1);
#define PC4_DYDX(D)                                                        \
  permuto4_dydx_kernel<D><<<pc_blocks_for(n, PC4_POINTS), 32 * L, smem,    \
                            st>>>(                                         \
      (const float4*)g_up, (const float*)x, (const uint2*)table, meta,     \
      (float*)dx, n)
    PC_DISPATCH(meta.n_dims, PC4_DYDX)
#undef PC4_DYDX
  }
  return (int)cudaGetLastError();
}

// Self-checks of the search's exact shortcuts, over all 2^32 inputs (run
// by tests/test_torch_kernels_gpu.py). out[0] counts the inputs that
// differ, out[1] is the lowest one (out = {0, ~0} on entry).

// div_dp1<b> against the IEEE quotient x / b, bit for bit (two
// not-a-numbers count as equal), for b = d+1 of each instantiated d.
int pc_check_div(int b, unsigned long long* out, void* stream) {
  const unsigned blocks = 132 * 8, threads = 256;
  cudaStream_t st = (cudaStream_t)stream;
  switch (b) {
    case 3: pc_check_div_kernel<3><<<blocks, threads, 0, st>>>(out); break;
    case 4: pc_check_div_kernel<4><<<blocks, threads, 0, st>>>(out); break;
    case 5: pc_check_div_kernel<5><<<blocks, threads, 0, st>>>(out); break;
    case 6: pc_check_div_kernel<6><<<blocks, threads, 0, st>>>(out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// pc_mod with level `level`'s constants against h % hash_mod.
int pc_check_mod(PCMeta meta, int level, unsigned long long* out,
                 void* stream) {
  if (level < 0 || level >= meta.n_levels) return (int)cudaErrorInvalidValue;
  pc_check_mod_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
      meta.lv[level], out);
  return (int)cudaGetLastError();
}

}  // extern "C"
