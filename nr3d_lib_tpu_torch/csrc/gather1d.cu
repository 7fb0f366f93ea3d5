// Element gather values[row[i], lane[i]] from a small 2-D f32 table (B5).
//
// Replaces the TPU kernel nr3d_lib_tpu/ops/gather1d.py `_kernel` (via
// `_impl` / `gather_rows_lanes`), which copied whole 128-lane rows with a
// scalar loop and picked the wanted lane on the VPU/MXU.
//
// What bounds it on an H100: per lookup it reads two int32 indices and
// writes one f32 (12 B), plus one 4-byte random read from the table. The
// occupancy table of the render ([4096, 64] f32 = 1 MB) stays in L2, so the
// indices and the output set its bound: the index and output streams are read
// and written coalesced, one thread per lookup. Indices are clamped into
// the table, like the plain version's `mode="clip"` take. On an H100 at
// 700 W (chip_ab.py, the F=4 render's 393,216 lookups) it takes 0.0043
// ms, of which 0.0030 is a launch that only stores and 0.0002 the index
// and output streams; 4 or 2 lookups a thread (int4/float4 or int2/
// float2, a grid of at most one wave) took 0.0046-0.0047, one a thread in
// one wave 0.0044.

#include <cuda_runtime.h>

__global__ void gather1d_kernel(const float* __restrict__ values,
                                const int* __restrict__ row,
                                const int* __restrict__ lane,
                                float* __restrict__ out, long long n,
                                int n_cols, long long n_values) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long f = (long long)row[i] * n_cols + lane[i];
  f = f < 0 ? 0 : (f >= n_values ? n_values - 1 : f);
  out[i] = __ldg(values + f);
}

extern "C" {

// values [n_rows, n_cols] f32, row/lane [n] int32, out [n] f32.
int gather1d(const void* values, const void* row, const void* lane,
             void* out, long long n, int n_rows, int n_cols, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    gather1d_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)values, (const int*)row, (const int*)lane, (float*)out,
        n, n_cols, (long long)n_rows * n_cols);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
