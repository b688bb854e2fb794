// micro_pairs — live-first compaction of 128 lanes and a gather loop over
// the live ids, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel scripts/micro/micro_pairs.py::kern (the
// probe of the primitives a pair-list intersector needs). Same contract:
// live (1,128) of 0/1 and rays (128,8) in; out o_list (128,128) whose
// column 0 holds the live lane ids first, in lane order, then the dead
// ones; o_gather (8,128) whose column 0 is sum_j rays[id_j] * (j + 1) over
// the live ids in order, with 123 stored at row count % 8 of column 1;
// o_meta (1,1) = count. What the probe leaves unwritten is 0 here.
//
// Design: one block of 128 threads, one lane each. The TPU kernel built
// the inclusive prefix sum as a triangular matmul and the scatter as a
// permutation matmul (Mosaic had no cumsum); here a warp ballot and
// __popc give each warp's prefix, four warp totals in shared memory the
// block's, and each lane stores its id at its position. The sums are of
// 0/1 values, exact either way. Then eight threads, one per ray column,
// run the dynamic-bound loop over the count live ids in order, one
// multiply and one add each step (--fmad=false): bit-equal with the
// probe's sequential fori_loop and the plain version
// (pbrt_tpu_torch/micro/micro_pairs.py::micro_pairs_ref).
//
// What bounds it: nothing the card would notice. It moves 73 KB (the
// 64 KB of o_list dominate) and does about 700 operations; a launch
// costs more than either. Measured on an H100 80GB HBM3 (700 W limit,
// chip_smoke.py phase m1): 0.050 ms a call, 35 live lanes.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kRayCols = 8;

__global__ void __launch_bounds__(kLanes)
pairs_kernel(const float* __restrict__ live, const float* __restrict__ rays,
             float* __restrict__ o_list, float* __restrict__ o_gather,
             float* __restrict__ o_meta) {
  __shared__ int warp_total[kLanes / 32];
  __shared__ int sorted_ids[kLanes];
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const bool is_live = live[j] > 0.0f;
  const unsigned ballot = __ballot_sync(0xffffffffu, is_live);
  const int incl = __popc(ballot & (0xffffffffu >> (31 - lane)));
  if (lane == 31) warp_total[warp] = incl;
  // Zero what the probe leaves unwritten: o_list's row j and o_gather's
  // column j.
  for (int c = 1; c < kLanes; ++c) o_list[j * kLanes + c] = 0.0f;
  for (int r = 0; r < kRayCols; ++r) o_gather[r * kLanes + j] = 0.0f;
  __syncthreads();
  int before = 0, count = 0;
  for (int w = 0; w < kLanes / 32; ++w) {
    if (w < warp) before += warp_total[w];
    count += warp_total[w];
  }
  const int cum = before + incl;
  sorted_ids[is_live ? cum - 1 : count + j - cum] = j;
  __syncthreads();
  o_list[j * kLanes] = static_cast<float>(sorted_ids[j]);
  if (j < kRayCols) {
    float acc = 0.0f;
    for (int q = 0; q < count; ++q) {
      acc = acc + rays[sorted_ids[q] * kRayCols + j] *
                      (static_cast<float>(q) + 1.0f);
    }
    o_gather[j * kLanes] = acc;
  }
  if (j == 0) {
    o_meta[0] = static_cast<float>(count);
    o_gather[(count % kRayCols) * kLanes + 1] = 123.0f;
  }
}

}  // namespace

extern "C" {

int micro_pairs_launch(const float* live, const float* rays, float* o_list,
                       float* o_gather, float* o_meta, cudaStream_t stream) {
  pairs_kernel<<<1, kLanes, 0, stream>>>(live, rays, o_list, o_gather,
                                         o_meta);
  return static_cast<int>(cudaGetLastError());
}

const char* micro_pairs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
