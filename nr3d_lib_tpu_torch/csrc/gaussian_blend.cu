// Per-tile front-to-back gaussian blend (B17) and its backward (B18).
//
// Replaces the TPU kernels nr3d_lib_tpu/graphics/gaussian_splatting.py
// `_blend_tile_kernel` (via `_blend_tiles_pallas_raw`) and
// `_blend_tile_bwd_kernel` (via `_blend_bwd`), which hold a tile's
// [pixels, slots] alpha matrix in VMEM and scan it along lanes
// (Hillis-Steele). Here one block blends one tile and one thread owns one
// pixel, walking the tile's K depth-sorted slots front to back with the
// transmittance in a register; the slots' attributes are staged in shared
// memory chunk by chunk, so any capacity K works. B17 first marks, per
// warp, the staged slots that can give some pixel of the warp an alpha
// above the floor (a bound from the conic's smaller eigenvalue and the
// distance to the warp's box of pixels), and each warp walks only those.
//
// Inputs: attrs [T, 11, K] f32 (rows mu_x, mu_y, c00, c01, c11, opacity,
// r, g, b, depth, live), origin [T, 2] f32 (the tile's top-left pixel).
// Pixel p of a tile sits at (p % tile + 0.5, p / tile + 0.5) + origin.
//
//   alpha = clip(op * exp(-md/2), 0, 0.999), 0 unless live and > floor,
//   md = (dx*dx*c00 + dy*dy*c11) + 2*dx*dy*c01;
//   T_k = prod_{j<k} (1 - alpha_j + 1e-10), vw_k = alpha_k * T_k;
//   rgb = sum vw*c + (1 - acc)*bg, acc = sum vw, depth = sum vw*z / max(acc,
//   1e-10). Every slot is composited: no early exit at small T, as the
//   JAX blend has none.
//
// md and alpha are rounded operation by operation (__fmul_rn/__fadd_rn,
// no FMA contraction), and exp is the accurate expf (no fast math), so the
// kernel follows the plain PyTorch version to a few ulps.
//
// B18 (the backward) needs, for slot k, the suffix sum
// B_k = sum_{j>k} dvw_j * vw_j, and dvw depends on the final acc and
// depth. Walk 1 runs forward for acc and depth and saves T at the start of
// every 16-slot chunk (in `ckpt`, [T, n_chunks, threads]); then the chunks
// are re-walked back to front: each chunk's T_k and Gaussian factors G_k
// are recomputed forward from its checkpoint into shared memory (the
// second and last alpha evaluation of a pair), and the slots are visited
// in reverse with B accumulated exactly, last slot first (no S - prefix
// cancellation). A slot that is live on no pixel of a warp (a warp vote
// over the chunk's live masks) adds exactly 0 to B and to every gradient
// there, so that warp skips it: at the bench scene 36% of the (warp,
// slot) pairs are taken. Per taken slot, ten gradients are
// reduced over the tile's pixels inside the block: a warp shuffle, then
// shared memory across the warps that took it. A tile owns its slots, so
// no atomics.
//
// What bounds them on an H100: operations. At the bench shape (T = 1024
// tiles of 16^2 pixels, K = 256) the blend is 67.1 M (pixel, slot) pairs
// of ~32 f32 operations and one expf (~0.03 ms at 67 TFLOP/s; the expf's
// ex2 at the SFUs' 16 per SM per clock is ~0.016 ms, not the limit),
// against 17 MB of attributes and outputs (~0.005 ms at 3.35 TB/s). In
// practice a walk over every pair is bound by issue: with the slots
// staged row by row it issues 44 SASS instructions a pair (11 shared
// loads, md and alpha op by op, the accurate expf inlined as 8), ~0.11 ms
// at 4 warp instructions a clock per SM. So B17 culls: it drops the (warp,
// slot) pairs that no pixel of the warp can take before any pair of them
// is evaluated, and reads a kept slot as one 48-byte record (47
// instructions a kept pair with the mask walk). Measured on an H100 at
// 700 W (chip_ab.py, the bench scene): 0.111 -> 0.072 ms, bitwise equal;
// the cull keeps 42% of the (warp, slot) pairs, 30% are taken; the same
// walk over every pair takes 0.127 ms, with 11 scalar loads a kept pair
// 0.085. The backward does ~70 operations a pair; B18 keeps to 64
// registers a thread (4 blocks of 256 threads an SM).

#include <cuda_runtime.h>

constexpr int N_ATTR = 11;
constexpr int N_GRAD = 10;     // rows 0..9 get a gradient; row 10 (live) 0
constexpr int CHUNK_F = 256;   // slots staged per pass of B17
constexpr int CHUNK_S = 64;    // slots staged per pass of B18
constexpr int CHUNK_B = 16;    // slots per back-to-front chunk of B18
constexpr int MAX_WARPS = 32;  // a 32² tile, one thread a pixel

struct Alpha {
  float dx, dy, g, raw, a;
  bool live;
};

__device__ __forceinline__ Alpha alpha_from(float mx, float my, float c00,
                                            float c01, float c11, float op,
                                            float live, float px, float py,
                                            float afloor) {
  Alpha r;
  r.dx = __fsub_rn(px, mx);
  r.dy = __fsub_rn(py, my);
  const float md = __fadd_rn(
      __fadd_rn(__fmul_rn(__fmul_rn(r.dx, r.dx), c00),
                __fmul_rn(__fmul_rn(r.dy, r.dy), c11)),
      __fmul_rn(__fmul_rn(__fmul_rn(2.0f, r.dx), r.dy), c01));
  r.g = expf(__fmul_rn(-0.5f, md));
  r.raw = __fmul_rn(op, r.g);
  const float a = fminf(fmaxf(r.raw, 0.0f), 0.999f);
  r.live = (live > 0.0f) && (a > afloor);
  r.a = r.live ? a : 0.0f;
  return r;
}

__device__ __forceinline__ Alpha alpha_of(const float* s, int stride, int j,
                                          float px, float py, float afloor) {
  return alpha_from(s[0 * stride + j], s[1 * stride + j], s[2 * stride + j],
                    s[3 * stride + j], s[4 * stride + j], s[5 * stride + j],
                    s[10 * stride + j], px, py, afloor);
}

__device__ __forceinline__ float one_minus(float a) {
  return __fadd_rn(__fsub_rn(1.0f, a), 1e-10f);
}

// stage slots [k0, k0 + n) of one tile's attrs into s[row * stride + j]
__device__ __forceinline__ void stage(float* s, int stride,
                                      const float* __restrict__ a, int K,
                                      int k0, int n) {
  for (int i = threadIdx.x; i < N_ATTR * n; i += blockDim.x) {
    const int row = i / n, j = i - row * n;
    s[row * stride + j] = a[(size_t)row * K + k0 + j];
  }
}

// B17 stages slot j as one aligned record of REC float4s, s[REC j ..]:
// (mu_x, mu_y, c00, c01), (c11, opacity, r, g), (b, depth, live, -), so a
// warp reads a slot with three broadcast 16-byte shared loads, not 11.
constexpr int REC = 3;

__device__ __forceinline__ void stage_records(float4* s,
                                              const float* __restrict__ a,
                                              int K, int k0, int n) {
  float* f = reinterpret_cast<float*>(s);
  for (int i = threadIdx.x; i < N_ATTR * n; i += blockDim.x) {
    const int row = i / n, j = i - row * n;
    f[j * 4 * REC + row] = a[(size_t)row * K + k0 + j];
  }
}

// B17's pixel of thread `tid`: where 8 divides the tile, warp w covers
// an 8 x 4 box of pixels (the boxes in row-major order), a tighter box
// for the cull than two 16-pixel rows; otherwise the pixels in row-major
// order (a 32-pixel run).
__device__ __forceinline__ int pixel_of(int tid, int tile) {
  if (tile % 8 != 0) return tid;
  const int w = tid >> 5, lane = tid & 31, per_row = tile >> 3;
  return ((w / per_row) * 4 + (lane >> 3)) * tile + (w % per_row) * 8 +
         (lane & 7);
}

// What B17's cull knows of one slot: keep it everywhere, drop it
// everywhere, or test it against each warp's box.
struct SlotBound {
  float mx, my, lam, thr, S;
  int mode;  // 0 keep, 1 drop, 2 test
};

__device__ __forceinline__ SlotBound slot_bound(const float4* s, int j,
                                                float afloor) {
  const float4 q0 = s[REC * j], q1 = s[REC * j + 1], q2 = s[REC * j + 2];
  const float c00 = q0.z, c01 = q0.w, c11 = q1.x, op = q1.y;
  SlotBound b;
  b.mx = q0.x;
  b.my = q0.y;
  b.lam = 0.0f;
  b.thr = 0.0f;
  b.S = 0.0f;
  if (!(isfinite(q1.z) && isfinite(q1.w) && isfinite(q2.x) &&
        isfinite(q2.y))) {
    b.mode = 0;  // 0 * inf is NaN: such a slot is never a no-op
  } else if (!(q2.z > 0.0f)) {
    b.mode = 1;  // dead: alpha 0 at every pixel
  } else if (isfinite(b.mx) && isfinite(b.my) && isfinite(c00) &&
             isfinite(c01) && isfinite(c11) && isfinite(op) &&
             afloor > 0.0f) {
    const float h = 0.5f * (c00 - c11);
    b.lam = 0.5f * (c00 + c11) - sqrtf(h * h + c01 * c01);
    b.thr = op > 0.0f ? 2.0f * logf(op / afloor)
                      : -__int_as_float(0x7f800000);
    b.S = fabsf(c00) + fabsf(c11) + 2.0f * fabsf(c01);
    b.mode = b.lam > 0.0f ? 2 : 0;
  } else {
    b.mode = 0;
  }
  return b;
}

// Can the slot give no pixel of the box (x0, x1, y0, y1: the warp's pixel
// centres) an alpha above the floor? With d the distance from the centre
// to the box, md >= lam d^2 at every pixel of it (lam the conic's smaller
// eigenvalue, > 0), so alpha <= op exp(-(lam d^2 - margin) / 2), and the
// slot is dropped when lam d^2 - margin >= 2 ln(op / afloor). The margin
// covers the rounding: md is computed op by op from dx = px - mu_x rounded
// once (relative 2^-24 each, so |md - dx^T C dx| <= ~6 2^-24 S r^2 with
// S = |c00| + |c11| + 2|c01| >= lam and r the distance to the box's
// farthest pixel), and lam, d^2, r^2 here are rounded a few times (again
// some 2^-24 S r^2); 1e-5 S r^2 is over 100 times that. The constant 1e-4
// covers, in md's units, expf's 2 ulps, the product op * g and logf here
// (together ~1e-6 relative in alpha, 2e-6 in md); a product or sum that
// overflows makes the test NaN or false, so the slot is kept.
__device__ __forceinline__ bool cull_test(const SlotBound& b, float4 box) {
  const float ex = fmaxf(fmaxf(box.x - b.mx, b.mx - box.y), 0.0f);
  const float ey = fmaxf(fmaxf(box.z - b.my, b.my - box.w), 0.0f);
  const float fx = fmaxf(fabsf(box.x - b.mx), fabsf(box.y - b.mx));
  const float fy = fmaxf(fabsf(box.z - b.my), fabsf(box.w - b.my));
  const float margin = 1e-5f * b.S * (fx * fx + fy * fy) + 1e-4f;
  return b.lam * (ex * ex + ey * ey) - margin >= b.thr;
}

// B17. Per chunk of staged slots, a mask [warps][CHUNK_F / 32] of the
// slots that some pixel of the warp can take: thread j tests slot j
// against every warp's box (a ballot a warp writes the words), then each
// warp walks the set bits of its words in slot order (a uniform loop).
// A dropped slot has alpha 0 at every pixel of the warp, so there it
// would add vw = 0 * T = +-0 to acc, r, g, b and depth (its attributes
// are finite) and multiply T by (1 - 0) + 1e-10, which rounds to 1.0f:
// skipping it leaves every pixel's sums the same bits as a walk over
// every slot. A kept slot runs that walk's per-pixel code (`alpha_from`,
// then the sums), operation for operation.
__global__ void gs_blend_kernel(const float* __restrict__ attrs,
                                const float* __restrict__ origin,
                                float* __restrict__ rgb,
                                float* __restrict__ acc_out,
                                float* __restrict__ dep_out, int K, int tile,
                                float bg0, float bg1, float bg2,
                                float afloor) {
  constexpr int WORDS = CHUNK_F / 32;
  __shared__ float4 s[REC * CHUNK_F];
  __shared__ unsigned mask[MAX_WARPS * WORDS];
  __shared__ float4 box[MAX_WARPS];
  const int t = blockIdx.x, P = tile * tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int p = pixel_of(threadIdx.x, tile);
  const bool on = p < P;
  const float* a = attrs + (size_t)t * N_ATTR * K;
  const float px = __fadd_rn((float)(p % tile) + 0.5f, origin[2 * t]);
  const float py = __fadd_rn((float)(p / tile) + 0.5f, origin[2 * t + 1]);
  {  // the warp's box of pixel centres
    const float inf = __int_as_float(0x7f800000);
    float x0 = on ? px : inf, x1 = on ? px : -inf;
    float y0 = on ? py : inf, y1 = on ? py : -inf;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x0 = fminf(x0, __shfl_xor_sync(0xffffffffu, x0, off));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, off));
      y0 = fminf(y0, __shfl_xor_sync(0xffffffffu, y0, off));
      y1 = fmaxf(y1, __shfl_xor_sync(0xffffffffu, y1, off));
    }
    if (lane == 0) box[warp] = make_float4(x0, x1, y0, y1);
  }
  float T = 1.0f, acc = 0.0f, r = 0.0f, g = 0.0f, b = 0.0f, zs = 0.0f;
  for (int k0 = 0; k0 < K; k0 += CHUNK_F) {
    const int n = min(CHUNK_F, K - k0);
    __syncthreads();
    stage_records(s, a, K, k0, n);
    __syncthreads();
    for (int j0 = 0; j0 < n; j0 += blockDim.x) {
      if (j0 + (threadIdx.x & ~31) >= n) break;  // whole warps past n
      const int j = j0 + threadIdx.x;            // < CHUNK_F
      const SlotBound sb = slot_bound(s, j, afloor);
      for (int w = 0; w < n_warps; ++w) {
        const bool cut =
            sb.mode == 1 || (sb.mode == 2 && cull_test(sb, box[w]));
        const unsigned word = __ballot_sync(0xffffffffu, j < n && !cut);
        if (lane == 0) mask[w * WORDS + (j >> 5)] = word;
      }
    }
    __syncthreads();
    const unsigned* mw = mask + warp * WORDS;
    for (int wi = 0; wi * 32 < n; ++wi) {
      unsigned m = mw[wi];
      while (m != 0u) {
        const int j = wi * 32 + __ffs(m) - 1;
        m &= m - 1u;
        const float4 q0 = s[REC * j], q1 = s[REC * j + 1],
                     q2 = s[REC * j + 2];
        const Alpha al = alpha_from(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q2.z,
                                    px, py, afloor);
        const float vw = al.a * T;
        acc += vw;
        r += vw * q1.z;
        g += vw * q1.w;
        b += vw * q2.x;
        zs += vw * q2.y;
        T = T * one_minus(al.a);
      }
    }
  }
  if (on) {
    const size_t o = (size_t)t * P + p;
    const float rest = 1.0f - acc;
    rgb[3 * o + 0] = r + rest * bg0;
    rgb[3 * o + 1] = g + rest * bg1;
    rgb[3 * o + 2] = b + rest * bg2;
    acc_out[o] = acc;
    dep_out[o] = zs / fmaxf(acc, 1e-10f);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// B18. Dynamic shared memory: s [N_ATTR][CHUNK_S] (the staged slots), tk
// and gk [CHUNK_B][threads] (each pixel's T and Gaussian factor at the
// slots of one chunk), red [warps][N_GRAD][CHUNK_B] (the warp sums), hit
// [warps] (the chunk's slots that are live on any of the warp's pixels).
// Up to 1024 threads (a 32² tile) caps the registers at 64 a thread, so a
// 16² tile's 256 threads fit 4 blocks an SM.
__global__ void __launch_bounds__(1024)
    gs_blend_bwd_kernel(const float* __restrict__ attrs,
                        const float* __restrict__ origin,
                        const float* __restrict__ g_rgb,
                        const float* __restrict__ g_acc,
                        const float* __restrict__ g_dep,
                        float* __restrict__ dattrs, float* __restrict__ ckpt,
                        int K, int tile, float bg0, float bg1, float bg2,
                        float afloor) {
  extern __shared__ float smem[];
  const int t = blockIdx.x, p = threadIdx.x, P = tile * tile;
  const int threads = blockDim.x;
  const int lane = p & 31, warp = p >> 5, n_warps = threads >> 5;
  float* s = smem;
  float* tk = s + N_ATTR * CHUNK_S;
  float* gk = tk + CHUNK_B * threads;
  float* red = gk + CHUNK_B * threads;
  unsigned* hit = (unsigned*)(red + n_warps * N_GRAD * CHUNK_B);
  const int n_chunks = (K + CHUNK_B - 1) / CHUNK_B;
  const bool on = p < P;
  const float* a = attrs + (size_t)t * N_ATTR * K;
  float* ck = ckpt + (size_t)t * n_chunks * threads + p;
  const float px = __fadd_rn((float)(p % tile) + 0.5f, origin[2 * t]);
  const float py = __fadd_rn((float)(p / tile) + 0.5f, origin[2 * t + 1]);

  // ---- walk 1: acc and depth; T at the start of every chunk
  float T = 1.0f, acc = 0.0f, zs = 0.0f;
  for (int k0 = 0; k0 < K; k0 += CHUNK_S) {
    const int n = min(CHUNK_S, K - k0);
    __syncthreads();
    stage(s, CHUNK_S, a, K, k0, n);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      if (j % CHUNK_B == 0) ck[(size_t)((k0 + j) / CHUNK_B) * threads] = T;
      const Alpha al = alpha_of(s, CHUNK_S, j, px, py, afloor);
      const float vw = al.a * T;
      acc += vw;
      zs += vw * s[9 * CHUNK_S + j];
      T = T * one_minus(al.a);
    }
  }
  const float A = fmaxf(acc, 1e-10f);
  const float dep = zs / A;
  const size_t o = (size_t)t * P + p;
  const float gr = on ? g_rgb[3 * o] : 0.0f;
  const float gg = on ? g_rgb[3 * o + 1] : 0.0f;
  const float gb = on ? g_rgb[3 * o + 2] : 0.0f;
  const float ga = on ? g_acc[o] : 0.0f;
  const float gd = on ? g_dep[o] : 0.0f;

  // ---- back to front: staged CHUNK_S slots at a time, walked in chunks
  // of CHUNK_B, last first
  float B = 0.0f;     // sum over the slots behind the current one
  const int n_stages = (K + CHUNK_S - 1) / CHUNK_S;
  for (int st = n_stages - 1; st >= 0; --st) {
    const int k0s = st * CHUNK_S, ns = min(CHUNK_S, K - k0s);
    __syncthreads();
    stage(s, CHUNK_S, a, K, k0s, ns);
    __syncthreads();
    for (int c = (ns - 1) / CHUNK_B; c >= 0; --c) {
      const int j0 = c * CHUNK_B, n = min(CHUNK_B, ns - j0);
      // forward from the checkpoint: keep T_k and G_k, mark live slots
      float Tc = ck[(size_t)((k0s + j0) / CHUNK_B) * threads];
      unsigned live = 0u;
      for (int j = 0; j < n; ++j) {
        const Alpha al = alpha_of(s, CHUNK_S, j0 + j, px, py, afloor);
        tk[j * threads + p] = Tc;
        gk[j * threads + p] = al.g;
        live |= (unsigned)(on && al.live) << j;
        Tc = Tc * one_minus(al.a);
      }
      // a slot that no pixel of the warp takes has every gradient and
      // every B term exactly 0 there: the warp skips it
      unsigned todo = __reduce_or_sync(0xffffffffu, live);
      __syncthreads();            // the last chunk's combine read red, hit
      if (lane == 0) hit[warp] = todo;
      while (todo != 0u) {
        const int j = 31 - __clz(todo);
        todo ^= 1u << j;
        const int js = j0 + j;
        const bool lv = (live >> j) & 1u;
        // alpha_of's values at (pixel, slot), from the kept G
        const float dx = __fsub_rn(px, s[0 * CHUNK_S + js]);
        const float dy = __fsub_rn(py, s[1 * CHUNK_S + js]);
        const float g = gk[j * threads + p];
        const float raw = __fmul_rn(s[5 * CHUNK_S + js], g);
        const float al_a = lv ? fminf(fmaxf(raw, 0.0f), 0.999f) : 0.0f;
        const float Tj = tk[j * threads + p];
        const float vw = al_a * Tj;
        const float z = s[9 * CHUNK_S + js];
        const float dvw = ga + gd * (z - dep) / A +
                          gr * (s[6 * CHUNK_S + js] - bg0) +
                          gg * (s[7 * CHUNK_S + js] - bg1) +
                          gb * (s[8 * CHUNK_S + js] - bg2);
        float da = dvw * Tj - B / one_minus(al_a);
        B += dvw * vw;
        if (!(lv && raw < 0.999f)) da = 0.0f;
        const float dmd = da * raw * (-0.5f);
        const float c00 = s[2 * CHUNK_S + js], c01 = s[3 * CHUNK_S + js],
                    c11 = s[4 * CHUNK_S + js];
        float v[N_GRAD];
        v[0] = -(dmd * (2.0f * dx * c00 + 2.0f * dy * c01));
        v[1] = -(dmd * (2.0f * dy * c11 + 2.0f * dx * c01));
        v[2] = dmd * dx * dx;
        v[3] = dmd * 2.0f * dx * dy;
        v[4] = dmd * dy * dy;
        v[5] = da * g;
        v[6] = gr * vw;
        v[7] = gg * vw;
        v[8] = gb * vw;
        v[9] = gd * vw / A;
#pragma unroll
        for (int r = 0; r < N_GRAD; ++r) {
          const float w = warp_sum(on ? v[r] : 0.0f);
          if (lane == 0) red[(warp * N_GRAD + r) * CHUNK_B + j] = w;
        }
      }
      __syncthreads();
      // each slot's gradient: the sum over the warps that took it
      float* d = dattrs + (size_t)t * N_ATTR * K + k0s + j0;
      for (int i = p; i < N_ATTR * n; i += threads) {
        const int r = i / n, j = i - r * n;
        float sum = 0.0f;
        if (r < N_GRAD)
          for (int w = 0; w < n_warps; ++w)
            if ((hit[w] >> j) & 1u)
              sum += red[(w * N_GRAD + r) * CHUNK_B + j];
        d[(size_t)r * K + j] = sum;
      }
    }
  }
}

extern "C" {

// attrs [T, 11, K], origin [T, 2] → rgb [T, P, 3], acc [T, P], dep [T, P]
int gs_blend(const void* attrs, const void* origin, void* rgb, void* acc,
             void* dep, int T, int K, int tile, float bg0, float bg1,
             float bg2, float afloor, void* stream) {
  if (T > 0) {
    const int threads = (tile * tile + 31) / 32 * 32;
    gs_blend_kernel<<<T, threads, 0, (cudaStream_t)stream>>>(
        (const float*)attrs, (const float*)origin, (float*)rgb, (float*)acc,
        (float*)dep, K, tile, bg0, bg1, bg2, afloor);
  }
  return (int)cudaGetLastError();
}

// + upstream gradients g_rgb [T, P, 3], g_acc, g_dep [T, P] → dattrs
// [T, 11, K]; ckpt is scratch of T · ceil(K / 16) · threads floats
int gs_blend_bwd(const void* attrs, const void* origin, const void* g_rgb,
                 const void* g_acc, const void* g_dep, void* dattrs,
                 void* ckpt, int T, int K, int tile, float bg0, float bg1,
                 float bg2, float afloor, void* stream) {
  if (T > 0 && K > 0) {
    const int threads = (tile * tile + 31) / 32 * 32;
    const size_t shmem =
        sizeof(float) * (N_ATTR * CHUNK_S + 2 * CHUNK_B * threads +
                         (threads / 32) * N_GRAD * CHUNK_B) +
        sizeof(unsigned) * (threads / 32);
    if (shmem > 48 * 1024) {   // tiles above 16²: above 48 KB needs the opt-in
      const cudaError_t e = cudaFuncSetAttribute(
          gs_blend_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)shmem);
      if (e != cudaSuccess) return (int)e;
    }
    gs_blend_bwd_kernel<<<T, threads, shmem, (cudaStream_t)stream>>>(
        (const float*)attrs, (const float*)origin, (const float*)g_rgb,
        (const float*)g_acc, (const float*)g_dep, (float*)dattrs,
        (float*)ckpt, K, tile, bg0, bg1, bg2, afloor);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
