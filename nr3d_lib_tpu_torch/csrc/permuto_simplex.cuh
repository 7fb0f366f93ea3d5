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
// uses __fmul_rn/__fadd_rn/__fsub_rn, so nvcc cannot contract
// `tail - i*cf` into an FMA; the sums run from the last coordinate, as the
// plain version's; sf comes from the host as float32; a rounding tie goes
// down; rank ties break by index; the remainder sum is an exact multiple
// of d+1, so its rounding is an integer division; negative coordinates
// hash as int -> uint32 (well defined).
//
// What bounds the search, and its exact shortcuts. The search is the
// larger part of every kernel that includes this header: on an H100 at
// 700 W (chip_ab.py, 393,216 points), B14 takes 0.0312 ms and 0.0281
// without its table loads (B10 took 0.0564 of its 0.0659 ms before these
// shortcuts). So its instructions are cut here wherever a cheaper form
// gives the same bits; a kernel around one search<4> (both the dense
// and the hashed branch) went from 757 SASS instructions to 438, and
// B14 from 0.0620 to 0.0312 ms with B10's warps:
//  * the ten IEEE divisions by d+1 (`__fdiv_rn`, a reciprocal, Newton
//    steps and a range check with a slow path) become `div_dp1`. By 4 it
//    is a product by 0.25, exact. By 3 or 5: q = x*r with r = fl(1/b),
//    e = fma(-q, b, x) (exact: the remainder of a correctly rounded
//    quotient is representable), and fma(e, r, q) is then the correctly
//    rounded quotient, unless e is 0 (x = -0 would come out +0) or not a
//    number (x infinite: q is already the quotient). This equals x / b
//    bitwise on every one of the 2^32 floats (not-a-number patterns
//    aside, which stay not-a-number): checked on the card by
//    `pc_check_div` (tests/test_torch_kernels_gpu.py). By 6 (d = 5) the
//    same steps are off for |x| < 2^-125, so d = 5 keeps `__fdiv_rn`;
//  * the hash's modulus by a runtime row count becomes Granlund and
//    Montgomery's multiply-high (`pc_mod`): with l = ceil(log2 m) and the
//    host's magic m' = floor(2^32 (2^l - m) / m) + 1 < 2^32, t =
//    umulhi(h, m') and q = (t + ((h - t) >> 1)) >> (l - 1) is floor(h /
//    m) for every 32-bit h (their Theorem 4.2: 2^(32+l) < (2^32 + m') m
//    <= 2^(32+l) + 2^l), so h - q m is h % m exactly;
//  * cells_per_row is 2^(5-d), a constant of D (the host refuses any
//    other), so the row and the cell are a shift and a mask, and every
//    index is 32-bit (the host refuses tables of 2^25 rows or more);
//  * ranks are counted once per pair of coordinates, and the vertex slots
//    built incrementally from the inverse of the rank permutation (slot_k
//    = slot_{k-1} | 1 << inv[d+1-k]), not by (d+1)^2 compares each.
// Integers are exact, and no float operation changed kind or order, so
// for finite points every kernel that includes this header gives the
// same bits as before these shortcuts. (A point with a non-finite
// coordinate gets not-a-number weights as before; its vertex slots may
// differ, and stay inside its cell's row.)

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
  // a hashed level's modulus n_rows * cells_per_row and its constants
  // for pc_mod (magic m', shifts min(l, 1) and max(l - 1, 0))
  uint32_t hash_mod;
  uint32_t mod_magic;
  int mod_sh1;
  int mod_sh2;
};

struct PCMeta {
  int n_dims;
  int n_levels;
  int cells_per_row;  // 2^(5 - n_dims), a constant of D; the host checks it
  float sf[PC_MAX_DIMS];  // hyperplane factors, float32 from the host
  PCLevel lv[PC_MAX_LEVELS];
};

// nr3d_lib_tpu/ops/lotd.py HASH_PRIMES[0:5]
__device__ __constant__ uint32_t kPrimes[PC_MAX_DIMS] = {
    1u, 2654435761u, 805459861u, 3674653429u, 2097192037u};

template <int D>
struct Simplex {
  int vtx[D + 1];  // vertex k's slot in the table as [rows*64, F]
  float bary[D + 1];
  int rank[D + 1];
};

// x / (d+1), bitwise the IEEE quotient (see the header note)
template <int DP1>
__device__ __forceinline__ float div_dp1(float x) {
  if constexpr (DP1 == 4) {
    return __fmul_rn(x, 0.25f);
  } else if constexpr (DP1 == 3 || DP1 == 5) {
    constexpr float b = (float)DP1;
    // fl(1/3) = 0x3EAAAAAB, fl(1/5) = 0x3E4CCCCD
    constexpr float r = DP1 == 3 ? 0x1.555556p-2f : 0x1.99999Ap-3f;
    const float q = __fmul_rn(x, r);
    const float e = fmaf(-q, b, x);
    return !(fabsf(e) > 0.f) ? q : fmaf(e, r, q);
  } else {
    return __fdiv_rn(x, (float)DP1);
  }
}

// h % L.hash_mod by the host's multiply-high constants (see the header)
__device__ __forceinline__ uint32_t pc_mod(uint32_t h, const PCLevel& L) {
  const uint32_t t = __umulhi(h, L.mod_magic);
  const uint32_t q = (t + ((h - t) >> L.mod_sh1)) >> L.mod_sh2;
  return h - q * L.hash_mod;
}

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
    const float v = div_dp1<DP1>(elev[i]);
    const float up = __fmul_rn(ceilf(v), fdp1);
    const float down = __fmul_rn(floorf(v), fdp1);
    const float r =
        __fsub_rn(up, elev[i]) < __fsub_rn(elev[i], down) ? up : down;
    rem0[i] = (int)r;
    diff[i] = __fsub_rn(elev[i], r);
    sum += rem0[i];
  }
  const int sum_ = sum / DP1;  // an exact multiple of d+1
  // rank[i] = #{j: diff_i < diff_j} + #{j < i: diff_i == diff_j}: of a
  // pair j < i exactly one counts the other
  int rank[DP1];
#pragma unroll
  for (int i = 0; i <= D; ++i) rank[i] = sum_;
#pragma unroll
  for (int i = 1; i <= D; ++i)
#pragma unroll
    for (int j = 0; j < i; ++j) {
      const bool below = diff[i] <= diff[j];
      rank[i] += below;
      rank[j] += !below;
    }
  // the sum fix-up, and the inverse permutation packed 3 bits a rank
  uint32_t inv = 0;
#pragma unroll
  for (int i = 0; i <= D; ++i) {
    int r = rank[i];
    if (r < 0) {
      r += DP1;
      rem0[i] += DP1;
    } else if (r > D) {
      r -= DP1;
      rem0[i] -= DP1;
    }
    s.rank[i] = r;
    inv |= (uint32_t)i << ((3 * r) & 31);
  }
  // barycentric weights from the sorted differential
  float vd_by_rank[DP1];
#pragma unroll
  for (int r = 0; r <= D; ++r) vd_by_rank[r] = 0.f;
#pragma unroll
  for (int i = 0; i <= D; ++i) {
    const float vd = div_dp1<DP1>(__fsub_rn(elev[i], (float)rem0[i]));
#pragma unroll
    for (int r = 0; r <= D; ++r)
      if (s.rank[i] == r) vd_by_rank[r] = vd;
  }
  s.bary[0] = __fsub_rn(__fadd_rn(vd_by_rank[D], 1.f), vd_by_rank[0]);
#pragma unroll
  for (int k = 1; k <= D; ++k)
    s.bary[k] = __fsub_rn(vd_by_rank[D - k], vd_by_rank[DP1 - k]);
  // the cell's index in its level: a bijective box index (dense) or a
  // hash of rem0
  uint32_t idx;
  if (L.is_dense) {
    int b = 0;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      int k = rem0[i] / DP1 - L.box_lo[i];  // exact: rem0 is a multiple
      k = min(max(k, 0), L.box_dims[i] - 1);
      b = b * L.box_dims[i] + k;
    }
    idx = (uint32_t)b;
  } else {
    uint32_t h = (uint32_t)rem0[0] * kPrimes[0];
#pragma unroll
    for (int i = 1; i < D; ++i) h ^= (uint32_t)rem0[i] * kPrimes[i];
    idx = pc_mod(h, L);
  }
  // row = idx / cells + row_offset, cell = idx % cells; the cell's 2^(d+1)
  // slots follow each other in the row. Vertex k sits at slot sum_i
  // [rank_i >= d+1-k] 2^i: slot_0 = 0, and slot_k adds the coordinate of
  // rank d+1-k
  constexpr int LC = 5 - D;  // log2 of cells per row, 128 / 2^(d+2)
  const int base = (((int)(idx >> LC) + L.row_offset) << 6) +
                   ((int)(idx & ((1u << LC) - 1u)) << DP1);
  uint32_t slot = 0;
  s.vtx[0] = base;
#pragma unroll
  for (int k = 1; k <= D; ++k) {
    slot |= 1u << ((inv >> (3 * (DP1 - k))) & 7u);
    s.vtx[k] = base + (int)(slot & ((1u << DP1) - 1u));
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
    delev[i] = div_dp1<DP1>(g1 - g2);
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
