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
// it, and the warps' aggregation leaves 2.96 M of them (of 7.86 M).
//
// Design. The forward and the backward give each warp 32 consecutive
// points at one level; a block takes the run at all L levels (blockDim =
// 32 L), so each warp reads its level's meta uniformly, x is staged in
// shared memory once and y (and the backward's g) pass through shared
// memory, so that the block's [points, L] rows move as one coalesced run.
// The paths feed points ray by ray (96 samples a ray, t constant along
// it), so at the coarse levels a warp's lanes mostly fall in one cell:
// the forward's loads merge into few sectors, and the backward's lanes
// that add to one slot (`__match_any_sync` on vertex k's slot) sum their
// float4s in the warp and issue one atomic for the group. (Whole warps
// rarely agree, 1,223 of 245,760 (warp, vertex) pairs at path C, so a
// butterfly fast path for them measured slower: 0.0747 ms.) dL/dx, when
// asked for, sums each point's levels in shared memory in level order and
// is written once: no atomics, no memset, and the same bits whatever the
// order of the points. The nablas are one thread per point looping over
// levels (its [N,d] output sums over levels, so a thread owns a point).
// The TPU kernels' level groups, A/B row buffers, lane-pattern extraction
// and MXU reduce/weight matrices exist only for the TPU and are not
// carried over.
//
// The backward scatters dL/dtable into the natural unpacked layout
// [rows, 256] (lane 2*lane_k + f): vertex k's 4 features are contiguous
// there and 16-byte aligned (lane_k is even), so each group's sum is one
// float4 atomicAdd; the sums' order changes from run to run.
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

// B14 and B15's run of consecutive points: one warp's width at each level
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

__device__ __forceinline__ float4 shfl4(unsigned mask, float4 v, int src) {
  return make_float4(__shfl_sync(mask, v.x, src), __shfl_sync(mask, v.y, src),
                     __shfl_sync(mask, v.z, src), __shfl_sync(mask, v.w, src));
}

// dst[key] += v for each lane of `active` (the warp's lanes that hold a
// point; all of them call this with the same `active`). The lanes with
// the same key sum their v first, pairwise in a tree over their ranks
// (ceil(log2 group) rounds of shuffles), and the lowest lane of the group
// issues one atomic.
__device__ __forceinline__ void warp_add4(float4* dst, int key, float4 v,
                                          unsigned active) {
  const unsigned peers = __match_any_sync(active, key);
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = peers & ((1u << lane) - 1u);
  unsigned rest = peers & ~((2u << lane) - 1u);  // the group's lanes above
  unsigned rank = __popc(below);
  while (__any_sync(active, rest != 0u)) {
    const int next = __ffs(rest);  // the next lane of the group, 1-based
    const float4 t = shfl4(active, v, (next - 1) & 31);
    if (next) v = make_float4(v.x + t.x, v.y + t.y, v.z + t.z, v.w + t.w);
    rest &= ~__ballot_sync(active, rank & 1u);  // summed into a lower lane
    rank >>= 1;
  }
  if (below == 0u) atomic_add4(dst + key, v);
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
