// Unweighted per-level row scatter-add.
//
//   out[l, idx[l, j], :] += g[l, j, :]
//
// Replaces the Pallas TPU kernel `scatter_add_rows_leveled`
// (neural_radiance_caching_tpu/ops/scatter_tpu.py, body `_scatter_kernel`)
// and, through its wrapper, `scatter_add_rows_padded`. The TPU kernel streams
// the update rows packed 128 / F to a 128-lane row, rolls each one into its
// slot and accumulates into banked VMEM copies of the table, one level at a
// time; the wrapper pads the update count to a tile multiple and the table
// height to a multiple of 128 / F. All of that is TPU layout. Here one thread
// owns one (level, update) and adds its F-wide row into the caller-zeroed
// table with f32 atomics; any update count and any table height work as
// they are.
//
// What bounds it on an H100: the row stream of a dedup'd flagship update
// set (L = 6, N = 1,048,576 updates, F = 4, 524,288 rows) is 6 x N x
// (4 B index + 16 B row) = 126 MB read and a 50 MB table written, ~53 us at
// 3.35 TB/s. The 25M f32 atomics bound it, as in the weighted kernels, with
// the coarse levels' equal rows serialising in L2. Neighbouring threads read
// neighbouring index words and row vectors, so every stream coalesces;
// contention is left to later work (warp pre-reduction of equal rows,
// `red.global.add.v4.f32` for F = 4).

// A row outside [0, num_rows) is a caller's bug and fails a device assert,
// as in the weighted kernels and PyTorch's own CUDA index kernels.
#undef NDEBUG
#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void scatter_add_rows_leveled_kernel(
    const int32_t* __restrict__ idx,  // [levels, n]
    const float* __restrict__ g,      // [levels, n, features]
    float* __restrict__ out,          // [levels, num_rows, features]
    int64_t levels, int64_t n, int32_t features, int64_t num_rows) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= levels * n) return;
  const int64_t level = t / n;
  const int64_t row = __ldg(idx + t);
  if (row < 0 || row >= num_rows) {
    assert(row >= 0 && row < num_rows && "scatter_add_rows_leveled: row out of range");
    return;
  }
  const float* src = g + t * features;
  float* o = out + (level * num_rows + row) * features;
  for (int32_t f = 0; f < features; ++f) {
    atomicAdd(o + f, __ldg(src + f));
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
int nrc_scatter_add_rows_leveled(const int32_t* idx, const float* g, float* out,
                                 int64_t levels, int64_t n, int32_t features,
                                 int64_t num_rows, void* stream) {
  const int64_t total = levels * n;
  if (total > 0) {
    const int threads = 256;
    const int64_t blocks = (total + threads - 1) / threads;
    scatter_add_rows_leveled_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
        idx, g, out, levels, n, features, num_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
