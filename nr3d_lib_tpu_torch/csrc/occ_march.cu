// Occupancy march and first budget compaction in one pass (one thread a ray).
//
// Replaces, where a compressed query marches and then keeps each ray's
// first B occupied steps: the march's voxel lookup (B5, whose TPU kernel
// is nr3d_lib_tpu/ops/gather1d.py `_kernel`), the XLA slab ops around it
// (nr3d_lib_tpu/ops/occgrid_march.py `occgrid_march_dense`: the [R, S]
// t, dt and in-range test, three coordinate axes, the voxel index, the
// masks) and nr3d_lib_tpu/graphics/pack_ops.py `dense_to_budgeted` (a rank
// by cumsum over [R, S], then a scatter into [R, B]). The [R, S] slab is
// never made: each thread walks its ray's S steps in order, tests each in
// range and occupied, and keeps the first B that are, stopping when the B
// slots are full.
//
// Bits: every float32 operation of the dense route, in its order and
// rounded once each (`__fadd_rn`/`__fmul_rn`, which ptxas does not fuse):
// t_start = (t_end - dt) + near, t = t_start + u·dt (u = 0.5 without
// jitter), x = o + d·t per axis, then (x + 1)·0.5·r_i, floor and the int
// cast; in range where t < far and t_start >= near - 1e-9. The step
// tables (t_end - dt, dt) [S] come from the same PyTorch code as the dense
// route's, so t, dt and valid are the dense route's bit for bit. The
// march does not stop at far: t is not provably monotone in the step
// under a jitter (t_i can round an ulp past t_{i+1}), and a step out of
// range costs a few instructions and no lookup.
//
// What bounds it on an H100: each ray's inputs (o, d, near, far, the mask:
// 33 B, plus S·4 B of jitter where given) read once and its [B] t, dt and
// valid (9·B B) written once; the grid (r0·r1·r2 bytes, 256 KB at 64³)
// and the step tables are read once and then hit in L1/L2. At the render
// cell's 640,000 rays, B = 24, no jitter: ~160 MB, ~0.05 ms at 3.35 TB/s.
// The design meets it by keeping every intermediate in registers, reading
// the grid through the read-only path (one byte a lookup, no float32 copy
// of the grid), and staging each block's output rows in shared memory
// (stride B + 1: no bank conflict when the threads write their slot k)
// so that the block stores its [rows, B] run of t, dt and valid
// coalesced; a row written by its own thread would be strided by 4·B
// bytes across the warp.

#include <cuda_runtime.h>

__device__ __forceinline__ int occ_cell(float o, float d, float t, int r,
                                        float fr) {
  const float x = __fadd_rn(o, __fmul_rn(d, t));
  const float u = __fmul_rn(__fadd_rn(x, 1.0f), 0.5f);
  return (int)floorf(__fmul_rn(u, fr));
}

__global__ void occ_march_budget_kernel(
    const unsigned char* __restrict__ occ, int r0, int r1, int r2,
    const float* __restrict__ ts0, const float* __restrict__ dts,
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ near, const float* __restrict__ far,
    const unsigned char* __restrict__ ray_mask, const float* __restrict__ u,
    float* __restrict__ t_out, float* __restrict__ dt_out,
    unsigned char* __restrict__ valid_out, long long n_rays, int n_steps,
    int budget) {
  extern __shared__ float smem[];
  const int stride = budget + 1;
  float* s_t = smem;                                    // [threads][B + 1]
  float* s_dt = s_t + blockDim.x * stride;              // [threads][B + 1]
  int* s_count = (int*)(s_dt + blockDim.x * stride);    // [threads]

  const long long first = (long long)blockIdx.x * blockDim.x;
  const long long r = first + threadIdx.x;
  int count = 0;
  if (r < n_rays && (ray_mask == nullptr || ray_mask[r])) {
    const float ox = rays_o[3 * r], oy = rays_o[3 * r + 1],
                oz = rays_o[3 * r + 2];
    const float dx = rays_d[3 * r], dy = rays_d[3 * r + 1],
                dz = rays_d[3 * r + 2];
    const float nr = near[r], fr = far[r];
    const float lo = __fsub_rn(nr, 1e-9f);
    const float f0 = (float)r0, f1 = (float)r1, f2 = (float)r2;
    const float* ur = u == nullptr ? nullptr : u + r * n_steps;
    float* my_t = s_t + threadIdx.x * stride;
    float* my_dt = s_dt + threadIdx.x * stride;
    for (int i = 0; i < n_steps; ++i) {
      const float dt = __ldg(dts + i);
      const float t_start = __fadd_rn(__ldg(ts0 + i), nr);
      const float w = ur == nullptr ? 0.5f : __ldg(ur + i);
      const float t = __fadd_rn(t_start, __fmul_rn(w, dt));
      if (!(t < fr && t_start >= lo)) continue;
      const int i0 = occ_cell(ox, dx, t, r0, f0);
      const int i1 = occ_cell(oy, dy, t, r1, f1);
      const int i2 = occ_cell(oz, dz, t, r2, f2);
      if (i0 < 0 || i0 >= r0 || i1 < 0 || i1 >= r1 || i2 < 0 || i2 >= r2)
        continue;
      if (!__ldg(occ + ((long long)i0 * r1 + i1) * r2 + i2)) continue;
      my_t[count] = t;
      my_dt[count] = dt;
      if (++count == budget) break;
    }
  }
  s_count[threadIdx.x] = count;
  __syncthreads();

  // the block's rows [first, first + rows) as one run of rows·B entries
  const long long left = n_rays - first;
  const int rows = left < blockDim.x ? (int)left : (int)blockDim.x;
  const int n = rows * budget;
  float* t_run = t_out + first * budget;
  float* dt_run = dt_out + first * budget;
  unsigned char* v_run = valid_out + first * budget;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int row = k / budget, col = k - row * budget;
    const bool v = col < s_count[row];
    t_run[k] = v ? s_t[row * stride + col] : 0.0f;
    dt_run[k] = v ? s_dt[row * stride + col] : 0.0f;
    v_run[k] = (unsigned char)v;
  }
}

extern "C" {

// occ [r0, r1, r2] uint8 (bool); ts0, dts [S] f32; rays_o, rays_d [R, 3]
// f32; near, far [R] f32; ray_mask [R] uint8 or null; u [R, S] f32 or null
// → t_out, dt_out [R, B] f32, valid_out [R, B] uint8.
int occ_march_budget(const void* occ, int r0, int r1, int r2,
                     const void* ts0, const void* dts, const void* rays_o,
                     const void* rays_d, const void* near, const void* far,
                     const void* ray_mask, const void* u, void* t_out,
                     void* dt_out, void* valid_out, long long n_rays,
                     int n_steps, int budget, void* stream) {
  if (n_rays > 0 && budget > 0) {
    // 128 threads a block where the staged rows fit the default 48 KB,
    // else fewer, else the opt-in shared memory
    int threads = 128;
    size_t shmem = 0;
    for (;; threads /= 2) {
      shmem = (size_t)threads * ((size_t)(budget + 1) * 2 * sizeof(float) +
                                 sizeof(int));
      if (shmem <= 48 * 1024 || threads == 32) break;
    }
    if (shmem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          occ_march_budget_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
      if (e != cudaSuccess) return (int)e;
    }
    const long long blocks = (n_rays + threads - 1) / threads;
    occ_march_budget_kernel<<<(unsigned)blocks, threads, shmem,
                              (cudaStream_t)stream>>>(
        (const unsigned char*)occ, r0, r1, r2, (const float*)ts0,
        (const float*)dts, (const float*)rays_o, (const float*)rays_d,
        (const float*)near, (const float*)far,
        (const unsigned char*)ray_mask, (const float*)u, (float*)t_out,
        (float*)dt_out, (unsigned char*)valid_out, n_rays, n_steps, budget);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
