// The cell permutohedral lattice's simplex search, shared by the F=2
// (permuto_cell.cu) and F=4 bf16-packed (permuto_cell4.cu) kernels.
//
// A point's simplex is found by elevating it onto the sum-zero hyperplane,
// rounding to the nearest remainder-0 point (the cell) and ranking the
// differential; the cell is hashed (or box-indexed, on a dense level) to a
// table row that holds every vertex slot of the cell. This is the XLA
// prologue of the TPU kernels (nr3d_lib_tpu/ops/permuto_cell.py
// `_level_rows_lanes_bary` on `ops/permuto.py` `_simplex_parts`), done in
// registers by each thread.
//
// Both layouts give vertex k of a (point, level) the same index: the row's
// 128 f32 words (F=2) or 256 unpacked f32 words (F=4) hold 64 vertex
// slots of F features, so vertex k sits at row * 64 + lane_k / 2, where
// lane_k (even) is the F=2 lane of its first feature. The F=2 table read
// as float2 and the unpacked F=4 table read as float4 (or its packed
// words as uint2) are indexed by that number alike.
//
// Bit-exactness notes. The simplex search must choose the plain version's
// simplex and row: every float operation of the elevation and the rounding
// uses __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn, so nvcc cannot contract
// `tail - i*cf` into an FMA; the sums run from the last coordinate, as the
// plain version's; sf comes from the host as float32; a rounding tie goes
// down; rank ties break by index; the remainder sum is an exact multiple
// of d+1, so its rounding is an integer division; negative coordinates
// hash as int -> uint32 (well defined).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define PC_MAX_DIMS 5
#define PC_MAX_LEVELS 16

struct PCLevel {
  float scale[PC_MAX_DIMS];
  int box_lo[PC_MAX_DIMS];
  int box_dims[PC_MAX_DIMS];
  int n_rows;
  int row_offset;  // into the concatenated table
  int is_dense;
};

struct PCMeta {
  int n_dims;
  int n_levels;
  int cells_per_row;
  float sf[PC_MAX_DIMS];  // hyperplane factors, float32 from the host
  PCLevel lv[PC_MAX_LEVELS];
};

// nr3d_lib_tpu/ops/lotd.py HASH_PRIMES[0:5]
__device__ __constant__ uint32_t kPrimes[PC_MAX_DIMS] = {
    1u, 2654435761u, 805459861u, 3674653429u, 2097192037u};

template <int D>
struct Simplex {
  long long vtx[D + 1];  // vertex k's slot in the table as [rows*64, F]
  float bary[D + 1];
  int rank[D + 1];
};

template <int D>
__device__ __forceinline__ void find_simplex(const float* xp,
                                             const PCMeta& m,
                                             const PCLevel& L,
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
  // lane_base + 2*slot
#pragma unroll
  for (int k = 0; k <= D; ++k) {
    int slot = 0;
#pragma unroll
    for (int i = 0; i <= D; ++i) slot |= (s.rank[i] >= DP1 - k) << i;
    s.vtx[k] = row * 64 + (lane_base + 2 * slot) / 2;
  }
}

// dL/dx [D] of one level from gf [D+1] (g . val_k), accumulated into dx:
// with the barycentric weights bary_k = vdiff[rank=d-k] - vdiff[rank=d+1-k]
// (bary_0 = vdiff[rank=d] + 1 - vdiff[rank=0]), dL/dvdiff_i = gf[d -
// rank_i] - gf[rank_i == 0 ? 0 : d+1-rank_i]; dL/delevated_i = that /
// (d+1); and through the elevation elevated_i = sum_{j>=i} cf_j -
// i*cf_{i-1}, dL/dcf_a = sum_{i<=a} delev_i - (a+1)*delev_{a+1}; dL/dx_a =
// dL/dcf_a * sf_a * scale_a.
template <int D>
__device__ __forceinline__ void elevation_vjp(const Simplex<D>& s,
                                              const float gf[D + 1],
                                              const PCMeta& m,
                                              const PCLevel& L,
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

static inline long long pc_total_rows(const PCMeta& meta) {
  const PCLevel& last = meta.lv[meta.n_levels - 1];
  return (long long)last.row_offset + last.n_rows;
}

static inline unsigned pc_blocks_for(long long total, int threads) {
  return (unsigned)((total + threads - 1) / threads);
}

// the kernels are instantiated for d = 2..5; another d is refused
#define PC_DISPATCH(D_RUNTIME, LAUNCH)          \
  switch (D_RUNTIME) {                          \
    case 2: LAUNCH(2); break;                   \
    case 3: LAUNCH(3); break;                   \
    case 4: LAUNCH(4); break;                   \
    case 5: LAUNCH(5); break;                   \
    default: return (int)cudaErrorInvalidValue; \
  }
