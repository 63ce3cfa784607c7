// Per-level scatter-add of the hash-grid table gradient, in the encoder's
// two weighted update layouts and as the unweighted row scatter:
//
//   leveled: out[l, idx[l, p*U + u], :] += w[l, p*U + u] * ct[l, p, :]
//   planes:  out[l, idx[l, u, p], :]   += w[l, u, p]   * ct[l, :, p]
//   rows:    out[l, idx[l, j], :]      += g[l, j, :]
//
// Replaces the Pallas TPU kernels of neural_radiance_caching_tpu/ops/
// scatter_tpu.py: `scatter_add_weighted_leveled` (body
// `_scatter_weighted_kernel`) in both of its instances, the direct one and
// the one that skips updates of weight 0 (`skip_zero_w=True`, fed by the
// run-deduplicated stream of `hashgrid._dedup_weighted_scatter`),
// `scatter_add_weighted_planes` (body `_scatter_weighted_planes_kernel`) and
// `scatter_add_rows_leveled` (body `_scatter_kernel`, also behind
// `scatter_add_rows_padded`). The TPU kernels walk the updates serially in
// one core, keep banked accumulators of the whole table in VMEM and roll
// 128-lane packed rows into place; the planes layout exists there so that XLA
// never builds a corner-fastest buffer, and the row wrapper pads the update
// count to a tile and the table to a multiple of 128 / F. None of that
// carries over. Here one body serves every layout, templated on the layout
// and on skipping zero weights:
//
// - One thread per (level, point); a row update is a point with one tap and
//   no weight. It reads the point's F values once (one 16-byte load for F =
//   4 in the leveled and rows layouts; F coalesced planes in the planes
//   layout) and walks its U taps. In the leveled layout a point's U indices
//   and weights are contiguous and load four at a time as one int4 and one
//   float4. A row update adds g as given, with no multiply, so a row that is
//   not finite reaches the table as under its plain version.
// - Rows wider than kMaxFeatures are cut into column chunks of kMaxFeatures
//   (the last one narrower, masked), one per gridDim.z; each chunk's threads
//   carry the same row as key. The row stride is a runtime argument, apart
//   from the chunk width, and a vector load or atomic is taken only where the
//   base pointer and the stride are both aligned for it. (The weighted
//   layouts' stride is their width F, a constant of the instance.)
// - Equal rows are combined inside the warp before any global atomic, one
//   tap slot at a time. A warp's 32 lanes are 32 consecutive points of one
//   level, which on the paths are consecutive samples along one ray: on the
//   dense 16^3, 32^3 and 64^3 levels runs of them fall in one cell.
//   `__match_any_sync` groups the lanes of equal rows, adjacent or not, and
//   a tree of shuffles sums each group onto its lowest lane, which alone
//   issues the atomic. A warp whose rows are all distinct skips the tree.
//   (A segmented run-sum over adjacent lanes, the scan of
//   `hashgrid.dedup_runs` in registers, measured as fast on the paths'
//   sorted samples and a third slower on unsorted ones: PERF.md.)
// - Each issued row is one vector atomic, `atomicAdd(float4*)` (sm_90,
//   `red.global.add.v4.f32`) for F = 4, two for F = 8, `float2` for F = 2
//   and 6; odd F, a masked chunk and a table that is not aligned add one
//   float at a time.
//
// What bounds it on an H100: bytes. At the material shape (6 levels x 4 taps
// x 1,572,864 points, F = 4, 524,288 rows) the updates read 302 MB of
// indices and weights and 151 MB of cotangents and write a 50 MB table,
// 0.15 ms at 3.35 TB/s; at the cache shape (6 x 262,144 x 4) 75 MB and the
// table, 0.04 ms; the cache shape's 6 x 1,048,576 rows read 126 MB and write
// the table, 0.05 ms. One update per tap without combining would leave L2's
// atomic units the limit: the 16^3 dense level funnels ~6.3M updates into
// 4,096 rows, 53,240 on the hottest, and equal addresses serialise. The
// warp combine cuts those, the vector atomics issue a row as one request, and
// every stream is read coalesced.
//
// Lanes take part in the warp collectives whatever their update: a lane
// past the last point, a row outside the table and (skip instance) an
// update of weight 0 carry the key kNoRow, which matches no real row and
// never issues, and a contribution of exactly 0. So a row that is not
// finite under a weight of 0 never reaches the table in the skip instance,
// as in its plain version; the direct instance adds w * ct as given, 0 * NaN
// included, as its plain version does. The output is allocated and zeroed
// by the caller.

// A row outside [0, num_rows) is a caller's bug. As in PyTorch's own CUDA
// index kernels (and so `index_add_`, the plain version), it fails a device
// assert: the launch is aborted and the next synchronising call raises.
// Every update's row is checked, skipped or not, as the plain version does.
#undef NDEBUG
#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kMaxFeatures = 8;
constexpr int kMaxGridYZ = 65535;  // levels (gridDim.y) and row chunks (gridDim.z)
// The key of a lane that adds nothing. Real rows are >= 0.
constexpr int32_t kNoRow = -1;

enum class Layout { kLeveled, kPlanes, kRows };

// Equal keys anywhere in the warp, adjacent or not (`__match_any_sync`),
// summed onto the group's lowest lane, which alone returns true (for a real
// row): each round, every lane still active in its group adds the value of
// the next active lane above it, and the lanes whose rank within the group
// has the round's bit set drop out, a tree over the ranks in log2 of the
// largest group's size rounds. A warp of singletons skips the rounds.
template <int F>
__device__ __forceinline__ bool combine_in_warp(int32_t key, float (&v)[F]) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned peers = __match_any_sync(kFullMask, key);
  const unsigned below = peers & ((1u << lane) - 1u);
  if (!__all_sync(kFullMask, peers == (1u << lane))) {
    unsigned rank = __popc(below);
    unsigned rest = peers & ~((2u << lane) - 1u);  // peers above this lane
    while (__any_sync(kFullMask, rest != 0)) {
      const int src = rest ? __ffs(rest) - 1 : static_cast<int>(lane);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float t = __shfl_sync(kFullMask, v[f], src);
        if (rest) v[f] += t;
      }
      rest &= ~__ballot_sync(kFullMask, rank & 1u);
      rank >>= 1;
    }
  }
  return key != kNoRow && below == 0;
}

// The first `cols` (<= F) values of a row into g, the rest left as they are;
// `vec` (only for cols == F) takes the vector loads.
template <int F>
__device__ __forceinline__ void load_row(const float* src, bool vec, int cols, float (&g)[F]) {
  if constexpr (F % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int c = 0; c < F / 4; ++c) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(src) + c);
        g[4 * c] = q.x, g[4 * c + 1] = q.y, g[4 * c + 2] = q.z, g[4 * c + 3] = q.w;
      }
      return;
    }
  } else if constexpr (F % 2 == 0) {
    if (vec) {
#pragma unroll
      for (int c = 0; c < F / 2; ++c) {
        const float2 q = __ldg(reinterpret_cast<const float2*>(src) + c);
        g[2 * c] = q.x, g[2 * c + 1] = q.y;
      }
      return;
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    if (f < cols) g[f] = __ldg(src + f);
  }
}

// Adds the first `cols` (<= F) values of v to the row at dst; `vec` (only
// for cols == F) takes the vector atomics.
template <int F>
__device__ __forceinline__ void add_row(float* dst, bool vec, int cols, const float (&v)[F]) {
  if constexpr (F % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int c = 0; c < F / 4; ++c) {
        atomicAdd(reinterpret_cast<float4*>(dst) + c,
                  make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]));
      }
      return;
    }
  } else if constexpr (F % 2 == 0) {
    if (vec) {
#pragma unroll
      for (int c = 0; c < F / 2; ++c) {
        atomicAdd(reinterpret_cast<float2*>(dst) + c, make_float2(v[2 * c], v[2 * c + 1]));
      }
      return;
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    if (f < cols) atomicAdd(dst + f, v[f]);
  }
}

// Whether every F-wide chunk of rows `stride` floats apart from `p` is
// aligned for the vector loads and atomics: the base pointer and the stride
// both. (Chunks start at multiples of F, which keeps that alignment.)
template <int F>
__device__ __forceinline__ bool vec_aligned(const void* p, int64_t stride) {
  constexpr int kFloats = F % 4 == 0 ? 4 : 2;
  return reinterpret_cast<uintptr_t>(p) % (4 * kFloats) == 0 && stride % kFloats == 0;
}

// Grid: x = a level's points in blocks, y = levels, z = the column chunks of
// a row (1 but for rows wider than kMaxFeatures).
template <Layout kLayout, bool kSkipZeroW, int F>
__global__ void __launch_bounds__(kThreads) scatter_add_kernel(
    const int32_t* __restrict__ idx,  // leveled [levels, points * corners]; planes [levels, corners, points]; rows [levels, points]
    const float* __restrict__ w,      // as idx; rows: none
    const float* __restrict__ ct,     // leveled [levels, points, F]; planes [levels, F, points]; rows [levels, points, stride]
    float* __restrict__ out,          // [levels, num_rows, stride]
    int64_t points, int32_t corners, int64_t num_rows, int64_t row_stride) {
  constexpr bool kRows = kLayout == Layout::kRows;
  const int64_t level = blockIdx.y;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  // A lane past the last point stays for the warp collectives.
  const bool live = p < points;
  const int32_t taps = kRows ? 1 : corners;
  // The floats of one row of ct (leveled, rows) and of out.
  const int64_t stride = kRows ? row_stride : F;
  // This block's columns [col0, col0 + cols) of each row; all F but in a
  // row's last, narrower chunk.
  const int64_t col0 = kRows ? static_cast<int64_t>(blockIdx.z) * F : 0;
  const int cols = kRows ? static_cast<int>(stride - col0 < F ? stride - col0 : F) : F;
  const bool vec_taps = kLayout == Layout::kLeveled && corners % 4 == 0 &&
                        (reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(w)) % 16 == 0;

  // Taps u0 .. u0 + 3 of this point (those below `taps`).
  int32_t r[4] = {0, 0, 0, 0};
  float wt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  auto load_taps = [&](int32_t u0) {
    if (!live) return;
    if (kRows) {
      r[0] = __ldg(idx + level * points + p);
    } else if (kLayout == Layout::kLeveled) {
      const int64_t base = (level * points + p) * corners + u0;
      if (vec_taps) {
        const int4 i4 = __ldg(reinterpret_cast<const int4*>(idx + base));
        const float4 w4 = __ldg(reinterpret_cast<const float4*>(w + base));
        r[0] = i4.x, r[1] = i4.y, r[2] = i4.z, r[3] = i4.w;
        wt[0] = w4.x, wt[1] = w4.y, wt[2] = w4.z, wt[3] = w4.w;
        return;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (u0 + k < corners) r[k] = __ldg(idx + base + k), wt[k] = __ldg(w + base + k);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (u0 + k < corners) {
          const int64_t q = (level * corners + u0 + k) * points + p;
          r[k] = __ldg(idx + q), wt[k] = __ldg(w + q);
        }
      }
    }
  };
  load_taps(0);

  // The cotangents (rows: the update's columns), read once. The skip
  // instance reads none for a point whose (first four) weights are all 0.
  float g[F];
#pragma unroll
  for (int f = 0; f < F; ++f) g[f] = 0.0f;
  bool need_ct = live;
  if (kSkipZeroW && corners <= 4) {
    need_ct = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) need_ct |= k < corners && wt[k] != 0.0f;
  }
  if (need_ct) {
    if (kLayout == Layout::kPlanes) {
#pragma unroll
      for (int f = 0; f < F; ++f) g[f] = __ldg(ct + (level * F + f) * points + p);
    } else {
      load_row<F>(ct + (level * points + p) * stride + col0,
                  cols == F && vec_aligned<F>(ct, stride), cols, g);
    }
  }

  float* table = out + level * num_rows * stride + col0;
  const bool vec_out = cols == F && vec_aligned<F>(out, stride);
  for (int32_t u0 = 0; u0 < taps; u0 += 4) {
    if (u0 > 0) load_taps(u0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (u0 + k >= taps) break;  // uniform over the warp
      int32_t key = kNoRow;
      if (live) {
        const int32_t row = r[k];
        if (row < 0 || row >= num_rows) {
          if constexpr (kRows) {
            assert(row >= 0 && row < num_rows && "scatter_add_rows_leveled: row out of range");
          } else {
            assert(row >= 0 && row < num_rows && "scatter_add_weighted: row out of range");
          }
        } else if (!kSkipZeroW || wt[k] != 0.0f) {
          key = row;
        }
      }
      float v[F];
#pragma unroll
      for (int f = 0; f < F; ++f) v[f] = key == kNoRow ? 0.0f : kRows ? g[f] : wt[k] * g[f];
      if (combine_in_warp<F>(key, v)) {
        add_row<F>(table + static_cast<int64_t>(key) * stride, vec_out, cols, v);
      }
    }
  }
}

// Launches the instance whose chunk width is `width` (1..kMaxFeatures).
template <Layout kLayout, bool kSkipZeroW, int F = 1>
void launch_width(int32_t width, dim3 grid, cudaStream_t stream, const int32_t* idx,
                  const float* w, const float* ct, float* out, int64_t points, int32_t corners,
                  int64_t num_rows, int64_t row_stride) {
  if (width == F) {
    scatter_add_kernel<kLayout, kSkipZeroW, F><<<grid, kThreads, 0, stream>>>(
        idx, w, ct, out, points, corners, num_rows, row_stride);
  } else if constexpr (F < kMaxFeatures) {
    launch_width<kLayout, kSkipZeroW, F + 1>(width, grid, stream, idx, w, ct, out, points,
                                             corners, num_rows, row_stride);
  }
}

// `features` is the row width: at most kMaxFeatures for the weighted
// layouts, any width for rows (in chunks of kMaxFeatures). Levels and
// chunks are capped at 65,535 each, far above any grid's levels and the
// JAX kernel's widest row (128 floats, 16 chunks).
template <Layout kLayout, bool kSkipZeroW>
int launch(const int32_t* idx, const float* w, const float* ct, float* out, int64_t levels,
           int64_t points, int32_t corners, int32_t features, int64_t num_rows, void* stream) {
  const int64_t chunks = (static_cast<int64_t>(features) + kMaxFeatures - 1) / kMaxFeatures;
  const int64_t blocks = (points + kThreads - 1) / kThreads;
  if (features < 1 || corners < 1 || (kLayout != Layout::kRows && features > kMaxFeatures) ||
      levels > kMaxGridYZ || chunks > kMaxGridYZ || blocks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (levels > 0 && points > 0) {
    const dim3 grid(static_cast<unsigned int>(blocks), static_cast<unsigned int>(levels),
                    static_cast<unsigned int>(chunks));
    launch_width<kLayout, kSkipZeroW>(
        features < kMaxFeatures ? features : kMaxFeatures, grid,
        static_cast<cudaStream_t>(stream), idx, w, ct, out, points, corners, num_rows, features);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns cudaGetLastError() as an int (0 =
// ok). The weighted ones take features in [1, 8] (the wrappers check it);
// `n` is the leveled layout's points * corners.
int nrc_scatter_add_weighted_leveled(const int32_t* idx, const float* w,
                                     const float* ct, float* out,
                                     int64_t levels, int64_t n, int32_t corners,
                                     int32_t features, int64_t num_rows,
                                     void* stream) {
  if (corners < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<Layout::kLeveled, false>(idx, w, ct, out, levels, n / corners, corners, features,
                                         num_rows, stream);
}

// The same sum with every update of weight 0 skipped.
int nrc_scatter_add_weighted_leveled_skip_zero_w(const int32_t* idx, const float* w,
                                                 const float* ct, float* out,
                                                 int64_t levels, int64_t n, int32_t corners,
                                                 int32_t features, int64_t num_rows,
                                                 void* stream) {
  if (corners < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<Layout::kLeveled, true>(idx, w, ct, out, levels, n / corners, corners, features,
                                        num_rows, stream);
}

int nrc_scatter_add_weighted_planes(const int32_t* idx, const float* w,
                                    const float* ct, float* out,
                                    int64_t levels, int64_t points, int32_t corners,
                                    int32_t features, int64_t num_rows,
                                    void* stream) {
  return launch<Layout::kPlanes, false>(idx, w, ct, out, levels, points, corners, features,
                                        num_rows, stream);
}

// The unweighted row scatter: idx [levels, n], g [levels, n, features], any
// features >= 1.
int nrc_scatter_add_rows_leveled(const int32_t* idx, const float* g, float* out,
                                 int64_t levels, int64_t n, int32_t features,
                                 int64_t num_rows, void* stream) {
  return launch<Layout::kRows, false>(idx, nullptr, g, out, levels, n, 1, features, num_rows,
                                      stream);
}

const char* nrc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
