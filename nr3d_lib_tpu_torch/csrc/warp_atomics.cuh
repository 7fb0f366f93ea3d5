// Float2 atomic adds into global memory, and their warp aggregation,
// shared by the F=2 backward kernels that scatter a table gradient: the
// cell permuto backward (B11/B12, permuto_cell.cu) and the brick
// encode's and nablas' backwards (B7, B9, brick.cu). It is the float2 twin
// of permuto_cell4.cu's `warp_add4` (B15), which keeps its own copy: one
// template for both widths gave B15 another register allocation, and it
// ran slower.
//
// Those kernels give each warp 32 consecutive points at one level. The
// paths feed points ray by ray, so at the coarse levels several lanes of
// a warp add to one table slot. `warp_add2` sums such lanes' values in
// the warp (`__match_any_sync` on the slot, then a pairwise tree over the
// group's ranks) and issues one atomic for the group. On an H100 at 700 W
// (chip_ab.py) this took B11 at the dynamic NeuS's 393,216 points from
// 0.151 ms with one atomic per lane to 0.070 ms, with 47% of the atomics
// left. Fewer, larger adds also round less.

#pragma once

#include <cuda_runtime.h>

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

// dst[key] += v for each lane of `active` (the warp's lanes that hold a
// point; all of them call this with the same `active`). The lanes with
// the same key sum their v first, pairwise in a tree over their ranks
// (ceil(log2 group) rounds of shuffles), and the lowest lane of the group
// issues one atomic.
__device__ __forceinline__ void warp_add2(float2* dst, int key, float2 v,
                                          unsigned active) {
  const unsigned peers = __match_any_sync(active, key);
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = peers & ((1u << lane) - 1u);
  unsigned rest = peers & ~((2u << lane) - 1u);  // the group's lanes above
  unsigned rank = __popc(below);
  while (__any_sync(active, rest != 0u)) {
    const int next = __ffs(rest);  // the next lane of the group, 1-based
    const int src = (next - 1) & 31;
    const float tx = __shfl_sync(active, v.x, src);
    const float ty = __shfl_sync(active, v.y, src);
    if (next) v = make_float2(v.x + tx, v.y + ty);
    rest &= ~__ballot_sync(active, rank & 1u);  // summed into a lower lane
    rank >>= 1;
  }
  if (below == 0u) atomic_add2(dst + key, v);
}
