// Weighted per-level scatter-add from tap planes: the hash-grid table
// gradient at secondary-ray fan-outs.
//
//   out[l, idx[l, u, p], :] += w[l, u, p] * ct[l, :, p]
//
// Replaces the Pallas TPU kernel `scatter_add_weighted_planes`
// (neural_radiance_caching_tpu/ops/scatter_tpu.py, body
// `_scatter_weighted_planes_kernel`). That kernel walks one tile of points at
// a time in SMEM/VMEM, keeps banked accumulators of the whole table and
// rolls 128-lane packed cotangent rows into place; its point-minor planes
// exist so that the XLA side never builds a corner-fastest buffer, which
// tile-pads badly on the TPU. Here the planes are simply the layout the
// encoder hands over: one thread owns one (level, point), reads its F
// cotangents once from F point-minor planes, then loops over the U taps and
// adds w * ct into the caller-zeroed table with f32 atomics.
//
// What bounds it on an H100: at the flagship material shape (L = 6 levels,
// P = 1,572,864 secondary-ray samples, U = 4 taps, F = 4, 524,288 rows) it
// reads 6 x 4 x P x (4 B index + 4 B weight) = 302 MB and 6 x 4 x P x 4 B =
// 151 MB of cotangents, and issues 151M f32 atomics into a 50 MB table. The
// bytes take ~0.14 ms at 3.35 TB/s; the atomics are the limit, worst on the
// 16^3 dense level, where ~6.3M updates land on 4,096 rows. Every stream is
// read coalesced: neighbouring threads are neighbouring points, and each
// plane is point-minor. Contention is left to later work (warp pre-reduction
// of equal rows, sorting by cell, `red.global.add.v4.f32` for F = 4).

// A row outside [0, num_rows) is a caller's bug and fails a device assert,
// as in the leveled kernel and PyTorch's own CUDA index kernels.
#undef NDEBUG
#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxFeatures = 8;

__global__ void scatter_add_weighted_planes_kernel(
    const int32_t* __restrict__ idx,  // [levels, corners, points]
    const float* __restrict__ w,      // [levels, corners, points]
    const float* __restrict__ ct,     // [levels, features, points]
    float* __restrict__ out,          // [levels, num_rows, features]
    int64_t levels, int64_t points, int32_t corners, int32_t features,
    int64_t num_rows) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= levels * points) return;
  const int64_t level = t / points;
  const int64_t p = t - level * points;
  float g[kMaxFeatures];
#pragma unroll
  for (int32_t f = 0; f < kMaxFeatures; ++f) {
    g[f] = f < features ? __ldg(ct + (level * features + f) * points + p) : 0.0f;
  }
  for (int32_t u = 0; u < corners; ++u) {
    const int64_t k = (level * corners + u) * points + p;
    const int64_t row = __ldg(idx + k);
    if (row < 0 || row >= num_rows) {
      assert(row >= 0 && row < num_rows && "scatter_add_weighted_planes: row out of range");
      continue;
    }
    const float wk = __ldg(w + k);
    float* o = out + (level * num_rows + row) * features;
#pragma unroll
    for (int32_t f = 0; f < kMaxFeatures; ++f) {
      if (f < features) atomicAdd(o + f, wk * g[f]);
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// features must lie in [1, 8]; the wrapper checks it.
int nrc_scatter_add_weighted_planes(const int32_t* idx, const float* w,
                                    const float* ct, float* out,
                                    int64_t levels, int64_t points, int32_t corners,
                                    int32_t features, int64_t num_rows,
                                    void* stream) {
  if (features < 1 || features > kMaxFeatures) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = levels * points;
  if (total > 0) {
    const int threads = 256;
    const int64_t blocks = (total + threads - 1) / threads;
    scatter_add_weighted_planes_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
        idx, w, ct, out, levels, points, corners, features, num_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
