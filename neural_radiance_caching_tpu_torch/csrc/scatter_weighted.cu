// Weighted per-level scatter-add: the hash-grid table gradient.
//
//   out[l, idx[l, j], :] += w[l, j] * ct[l, j / corners, :]
//
// Replaces the Pallas TPU kernel `scatter_add_weighted_leveled`
// (neural_radiance_caching_tpu/ops/scatter_tpu.py, body
// `_scatter_weighted_kernel`). The TPU kernel walks the updates serially in
// one core, keeps four banked accumulators of the whole table in VMEM and
// rolls 128-lane packed cotangent rows into place. None of that layout is
// needed here: one thread owns one (level, point, tap) update and adds its
// F-wide row into the table with f32 atomics. The output is allocated and
// zeroed by the caller.
//
// What bounds it on an H100: at the flagship shape (L = 6 levels, 262,144
// points, 4 taps, F = 4) it reads 6.3M x (4 B index + 4 B weight) and
// 6 x 262,144 x 16 B of cotangent rows, about 75 MB, and issues 25M f32
// atomics into a 50 MB table. The bytes alone take ~25 us at 3.35 TB/s; the
// atomics are the limit, worst on the coarse levels, where the 16^3 dense
// level funnels about a million updates into 4,096 rows and the same
// addresses serialise in L2. The design keeps every byte stream coalesced
// (neighbouring threads read neighbouring index/weight words, and the four
// taps of a point share one cotangent row in the same cache line) and leaves
// contention to later work: warp-level pre-reduction of equal rows, sorting
// updates by cell, and vector `red.global.add.v4.f32` for F = 4.

// A row outside [0, num_rows) is a caller's bug. As in PyTorch's own CUDA
// index kernels (and so `index_add_`, the plain version), it fails a device
// assert: the launch is aborted and the next synchronising call raises.
#undef NDEBUG
#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void scatter_add_weighted_leveled_kernel(
    const int32_t* __restrict__ idx,  // [levels, n]
    const float* __restrict__ w,      // [levels, n]
    const float* __restrict__ ct,     // [levels, n / corners, features]
    float* __restrict__ out,          // [levels, num_rows, features]
    int64_t levels, int64_t n, int32_t corners, int32_t features,
    int64_t num_rows) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= levels * n) return;
  const int64_t level = t / n;
  const int64_t j = t - level * n;
  const int64_t row = __ldg(idx + t);
  // Indices come from the encoder and lie in [0, num_rows). A bad one fails
  // the assert; the return keeps it from writing outside the table.
  if (row < 0 || row >= num_rows) {
    assert(row >= 0 && row < num_rows && "scatter_add_weighted_leveled: row out of range");
    return;
  }
  const float wj = __ldg(w + t);
  const float* g = ct + (level * (n / corners) + j / corners) * features;
  float* o = out + (level * num_rows + row) * features;
  for (int32_t f = 0; f < features; ++f) {
    atomicAdd(o + f, wj * __ldg(g + f));
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
int nrc_scatter_add_weighted_leveled(const int32_t* idx, const float* w,
                                     const float* ct, float* out,
                                     int64_t levels, int64_t n, int32_t corners,
                                     int32_t features, int64_t num_rows,
                                     void* stream) {
  const int64_t total = levels * n;
  if (total > 0) {
    const int threads = 256;
    const int64_t blocks = (total + threads - 1) / threads;
    scatter_add_weighted_leveled_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                                          static_cast<cudaStream_t>(stream)>>>(
        idx, w, ct, out, levels, n, corners, features, num_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* nrc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
