// F=2 brick LoTD encoding: forward (B6), its backward (B7), nablas (B8) and
// the nablas' backward (B9).
//
// Replaces the TPU kernels nr3d_lib_tpu/ops/lotd_brick.py `_fwd_kernel_v3`
// (via `_brick_encode_pallas`, and with want_g via `_brick_encode_pallas_g`),
// `_bwd_kernel_v4` (via `_brick_bwd_pallas_v4`; the frozen-x form is
// need_dx=false), `_dydx_kernel_v3` (via `_brick_dydx_pallas`) and
// `_bwd2_kernel_v3` (via `_brick_bwd2_pallas`). B6 and B8 also take the
// forest's per-point block index (`bidx`, the JAX `_offset_rows` applied
// in `_brick_encode_pallas_impl` and `_brick_dydx_pallas`): block b owns
// rows [b total_rows, (b+1) total_rows) of a [B total_rows, 128] table,
// and bidx < 0 reads block 0 (the callers zero those points). The offset
// is added where each warp locates its level's row, in 64-bit: a 4096-
// block forest of 23,005 rows a block has 94 M rows, and row * 64
// overflows int32 past 2^25 rows. With bidx null the kernels are the
// instances they were before it existed (a template flag), so their
// outputs keep their bits.
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
// 8 B per level out). B6 measured on an H100 at 700 W (chip_ab.py, probes
// made by text substitution): at the NeuS render's 589,824 points along
// rays, 0.0262 ms, of which 0.0165 remain without the table loads and the
// stores (the index math and the weights: 179 SASS instructions); at the
// NeRF render's 196,608 points, 24 a ray, 0.0327 ms, of which 0.0097
// remain without them: there every lane of a fine level reads its own
// rows. The hash modulo costs nothing measurable. B8 (an H100 at 700 W,
// chip_ab.py, the F=2 NeuS step's 147,456 points in ray order) takes
// 0.0145 ms, 0.0075 without its table loads and 0.0082 with every lane of
// a warp reading lane 0's row: the lanes' scattered rows, not the loads'
// latency, bound it, so the layout below barely moves it (0.0149 as one
// thread per point looping over the levels; 0.0217 against 0.0202 with
// the points in a random order). Design: the index math (the JAX
// `_prologue`) runs in the kernel, so nothing but x, the table and the
// outputs touches device memory. All four kernels give each warp 32
// consecutive points at one level, a block the run at all levels, as the
// cell permuto kernels do (permuto_cell.cu): a warp reads its level's
// meta uniformly, no thread divides by L, and at the coarse levels the
// lanes of a warp share brick rows. The backwards stage x and the
// upstream gradients in shared memory (B6 and B8 read x lane by lane), y,
// B6's corner values and B9's dL/dg_up leave through it as coalesced
// runs, and dL/dx and B8's nablas sum the levels there in level order, so
// the nablas need no atomics. The TPU kernels' software pipelining,
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
// FMA nvcc made of it there); B7's dL/dx and B8's nablas take the same
// level sum, and B8's nablas are the bits of its own such form. This
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

// The forest form's corner (0,0,0) slot of point p: its block's rows
// start at max(bidx[p], 0) block_rows; 64-bit throughout.
__device__ __forceinline__ long long block_row(const int* __restrict__ bidx,
                                               long long p,
                                               long long block_rows,
                                               const Located& c) {
  const long long b = max(__ldg(bidx + p), 0);
  return (b * block_rows + c.row) * 64 + c.vert0;
}

// The run of consecutive points of B6-B9: one warp's width at each level
constexpr int BRICK_POINTS = 32;

// B6: a block takes a run of BRICK_POINTS consecutive points at all L
// levels (blockDim = 32 L), warp l the run at level l -> y [n, L] float2.
// Each lane reads its point's x itself (the L warps share the run's 384
// bytes in L1): staging x in shared memory puts a barrier, and the x
// load's latency, before every table load of the block (0.0365 ms against
// 0.0327 at the NeRF render's launch, chip_ab.py on an H100). y leaves
// through shared memory as the block's one coalesced [32, L] run. The
// want_g form (G) also writes the 8 corners' values of each (point,
// level), [n, L, 8] float2, which B7 reads back for dL/dx: the block's
// corners are one contiguous [32, L, 8] run, staged as [32][4 L + 1]
// float4 in dynamic shared memory (a point's records padded by one float4,
// so that the 8 lanes of a quarter-warp write 8 distinct bank groups) and
// written as float4, coalesced: 0.0263 ms at the F=2 NeuS step's 147,456
// points, against 0.0505 with each lane's own 64 bytes stored as four
// float4 (chip_ab.py on an H100). Each (point, level) does the arithmetic
// of the one-thread-a-(point, level) form, so y has its bits.
template <bool G, bool B>
__global__ void brick_fwd_kernel(const float* __restrict__ x,
                                 const float2* __restrict__ table,
                                 const int* __restrict__ bidx,
                                 long long block_rows,
                                 const __grid_constant__ BrickMeta meta,
                                 float2* __restrict__ y,
                                 float4* __restrict__ corners, long long n) {
  extern __shared__ float4 cs[];
  __shared__ float2 ys[BRICK_POINTS * BRICK_MAX_LEVELS];
  const int L = meta.n_levels;
  const long long p0 = (long long)blockIdx.x * BRICK_POINTS;
  const int np = (int)min((long long)BRICK_POINTS, n - p0);
  const int t = threadIdx.x, l = t >> 5, i = t & 31;
  const int rec = 4 * L + 1;  // float4s a point takes in cs
  if (i < np) {
    const float* xi = x + (p0 + i) * 3;
    const float xp[3] = {xi[0], xi[1], xi[2]};
    const Located c = locate(xp, meta.lv[l]);
    const float2* rowp = B ? table + block_row(bidx, p0 + i, block_rows, c)
                           : table + (unsigned)(c.row * 64 + c.vert0);
    float a0 = 0.f, a1 = 0.f;
    float2 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int b0 = (k >> 2) & 1, b1 = (k >> 1) & 1, b2 = k & 1;
      const float w = (b0 ? c.frac[0] : 1.f - c.frac[0]) *
                      (b1 ? c.frac[1] : 1.f - c.frac[1]) *
                      (b2 ? c.frac[2] : 1.f - c.frac[2]);
      v[k] = __ldg(rowp + corner_off(k));
      a0 += w * v[k].x;
      a1 += w * v[k].y;
    }
    ys[i * L + l] = make_float2(a0, a1);
    if (G) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        cs[i * rec + l * 4 + q] = make_float4(v[2 * q].x, v[2 * q].y,
                                              v[2 * q + 1].x, v[2 * q + 1].y);
    }
  }
  __syncthreads();
  if (t < np * L) y[p0 * L + t] = ys[t];  // np L <= 32 L = blockDim
  if (G) {
    // float4 f = j * 32 L + t of the block's run is record t % 4L of
    // point j * 8 + t / 4L
    const int ti = t / (4 * L), tr = t - ti * 4 * L;
    float4* out = corners + p0 * L * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pi = j * 8 + ti;
      if (pi < np) out[j * 32 * L + t] = cs[pi * rec + tr];
    }
  }
}

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

// B8: the blocks of B9, no atomics -> dx [n, 3]:
//   dx_a = sum_l (res_a-2) sum_k (g_up . val_k) (2 bit_a - 1) prod_{b!=a} s_b
// Each lane reads its point's x and its (point, level)'s float2 of g_up
// itself, as B6 reads x, so no barrier stands before the table loads;
// each (level, point) does the one-thread-per-point form's arithmetic and
// parks t in [L, 32, 3] in shared memory, and one thread a (point,
// coordinate) sums the levels there, d = fma(t, res-2, d) from level 0 (the
// FMA nvcc made of that form's d += t * (res-2)), and writes dx once: its
// bits, in any order of the points.
template <bool B>
__global__ void brick_dydx_kernel(const float2* __restrict__ g_up,
                                  const float* __restrict__ x,
                                  const float2* __restrict__ table,
                                  const int* __restrict__ bidx,
                                  long long block_rows,
                                  const __grid_constant__ BrickMeta meta,
                                  float* __restrict__ dx, long long n) {
  __shared__ float ts[BRICK_MAX_LEVELS * BRICK_POINTS * 3];
  const int L = meta.n_levels;
  const long long p0 = (long long)blockIdx.x * BRICK_POINTS;
  const int np = (int)min((long long)BRICK_POINTS, n - p0);
  const int l = threadIdx.x >> 5, i = threadIdx.x & 31;
  if (i < np) {
    const float* xi = x + (p0 + i) * 3;
    const float xp[3] = {xi[0], xi[1], xi[2]};
    const float2 g = g_up[(p0 + i) * L + l];
    const Located c = locate(xp, meta.lv[l]);
    const float2* rowp = B ? table + block_row(bidx, p0 + i, block_rows, c)
                           : table + (long long)c.row * 64 + c.vert0;
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
    for (int a = 0; a < 3; ++a) ts[(l * BRICK_POINTS + i) * 3 + a] = t[a];
  }
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

// The rows of the table (of one block's, in the forest form); 0 for a
// meta with no level (never read lv[-1]).
static long long total_rows(const BrickMeta& meta) {
  if (meta.n_levels <= 0) return 0;
  const BrickLevel& last = meta.lv[meta.n_levels - 1];
  return (long long)last.row_offset + last.n_rows;
}

static unsigned n_blocks(long long total, int threads) {
  return (unsigned)((total + threads - 1) / threads);
}

extern "C" {

// x [n,3] f32, table [rows,128] f32 ([B rows,128] with bidx), bidx [n]
// int32 or null, y [n,2L] f32, corners [n,L,8,2] f32 (16-byte aligned) or
// null; not both bidx and corners (the forest form has no want_g).
int brick_fwd(const void* x, const void* table, const void* bidx,
              BrickMeta meta, void* y, void* corners, long long n,
              void* stream) {
  const int L = meta.n_levels;
  if (bidx != nullptr && corners != nullptr)
    return (int)cudaErrorInvalidValue;
  if (n > 0 && L > 0) {
    const unsigned blocks = n_blocks(n, BRICK_POINTS);
    cudaStream_t st = (cudaStream_t)stream;
    if (bidx != nullptr) {
      brick_fwd_kernel<false, true><<<blocks, 32 * L, 0, st>>>(
          (const float*)x, (const float2*)table, (const int*)bidx,
          total_rows(meta), meta, (float2*)y, nullptr, n);
    } else if (corners == nullptr) {
      brick_fwd_kernel<false, false><<<blocks, 32 * L, 0, st>>>(
          (const float*)x, (const float2*)table, nullptr, 0, meta,
          (float2*)y, nullptr, n);
    } else {
      const size_t smem = (size_t)BRICK_POINTS * (4 * L + 1) * sizeof(float4);
      brick_fwd_kernel<true, false><<<blocks, 32 * L, smem, st>>>(
          (const float*)x, (const float2*)table, nullptr, 0, meta,
          (float2*)y, (float4*)corners, n);
    }
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
  if (meta.n_levels > 0)
    cudaMemsetAsync(dtab, 0, (size_t)total_rows(meta) * 128 * sizeof(float),
                    st);
  if (n > 0 && meta.n_levels > 0) {
    brick_bwd_kernel<<<n_blocks(n, BRICK_POINTS), 32 * meta.n_levels, 0,
                       st>>>(
        (const float*)x, (const float2*)g, (const float2*)corners,
        (const float2*)table, meta, (float2*)dtab, (float*)dx, n);
  } else if (n > 0 && dx != nullptr) {  // no level: dx is 0
    cudaMemsetAsync(dx, 0, sizeof(float) * n * 3, st);
  }
  return (int)cudaGetLastError();
}

// g_up [n,2L] f32, x [n,3] f32, table [rows,128] f32 ([B rows,128] with
// bidx), bidx [n] int32 or null, dx [n,3] f32.
int brick_dydx(const void* g_up, const void* x, const void* table,
               const void* bidx, BrickMeta meta, void* dx, long long n,
               void* stream) {
  if (n > 0) {
    const int L = meta.n_levels;
    cudaStream_t st = (cudaStream_t)stream;
    if (L == 0)  // no level: dx is 0
      return (int)cudaMemsetAsync(dx, 0, sizeof(float) * n * 3, st);
    if (bidx != nullptr)
      brick_dydx_kernel<true><<<n_blocks(n, BRICK_POINTS), 32 * L, 0, st>>>(
          (const float2*)g_up, (const float*)x, (const float2*)table,
          (const int*)bidx, total_rows(meta), meta, (float*)dx, n);
    else
      brick_dydx_kernel<false><<<n_blocks(n, BRICK_POINTS), 32 * L, 0,
                                 st>>>(
          (const float2*)g_up, (const float*)x, (const float2*)table,
          nullptr, 0, meta, (float*)dx, n);
  }
  return (int)cudaGetLastError();
}

// g_up [n,2L] f32, x [n,3] f32, table [rows,128] f32, gg [n,3] f32,
// dgup [n,2L] f32, dtab [rows,128] f32 (zeroed here), dx [n,3] f32 or null.
int brick_bwd2(const void* g_up, const void* x, const void* table,
               const void* gg, BrickMeta meta, void* dgup, void* dtab,
               void* dx, long long n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (meta.n_levels > 0)
    cudaMemsetAsync(dtab, 0, (size_t)total_rows(meta) * 128 * sizeof(float),
                    st);
  if (n > 0 && meta.n_levels > 0) {
    brick_bwd2_kernel<<<n_blocks(n, BRICK_POINTS), 32 * meta.n_levels, 0,
                        st>>>(
        (const float2*)g_up, (const float*)x, (const float2*)table,
        (const float*)gg, meta, (float2*)dgup, (float2*)dtab, (float*)dx, n);
  } else if (n > 0 && dx != nullptr) {  // no level: dx is 0
    cudaMemsetAsync(dx, 0, sizeof(float) * n * 3, st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
