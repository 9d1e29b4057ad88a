// RMSNorm forward and backward, the arithmetic in float32.
//
// Forward: y = x * rsqrt(mean(x^2) + eps) * (1 + scale), y in x's dtype.
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel
// (called through _pallas_fwd).
//
// Backward: with rr = rsqrt(mean(x^2) + eps), xh = x * rr and
// gs = g * (1 + scale),
//   dx = rr * (gs - xh * mean(gs * xh))   in x's dtype,
//   dscale = sum over rows of g * xh       in float32.
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::_rmsnorm_bwd_kernel
// (called through _pallas_bwd).  Like it, rr is recomputed from x rather
// than saved by the forward.
//
// Bound on the H100, both directions: bytes.  Each element is read once and written once
// (2 + 2 bytes in bfloat16) for about four float operations, far below
// the ~295 operations per byte where the tensor cores would become the
// limit.  The design therefore only moves bytes well: one block of 128
// threads per row, 16-byte vector loads and stores with neighbouring
// threads on neighbouring addresses, the sum of squares reduced in
// registers, by warp shuffles and through 4 words of shared memory.  The
// second pass re-reads the row, which a 2 KB row (d = 1024 in bfloat16)
// finds in L1.  With 8 rows (one decode step at 8 slots) only 8 of the
// 132 SMs have work and the launch itself dominates; that is left as it
// is here.
//
// The backward reads x and g and writes dx (6 bytes an element in
// bfloat16) for about a dozen float operations, again far below the
// tensor cores' line.  A grid of at most kBwdBlocks blocks walks the rows
// (block i takes rows i, i + grid, ...): one pass over a row reads x and
// g for its two sums (x.x and gs.x, reduced as in the forward), the
// second re-reads them from L1 and writes dx.  The blocks cannot carry a
// dscale sum from one to another as the TPU grid did, and atomics would
// make the sum's order change from run to run, so each thread adds its
// own columns' g * xh into the block's row of shared memory (every row
// gives a thread the same columns, so no two threads touch one word) and
// the block writes that row as a float32 partial; the caller sums the
// partials, as the reference sums its per-block partials outside the
// kernel.  Bounding the grid keeps the partials small (528 x d floats).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBwdBlocks = 4 * 132;     // four blocks for each SM

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ out, int d, float eps) {
  constexpr int V = rt::Vec<T>::N;
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* yr = out + static_cast<size_t>(blockIdx.x) * d;
  const int nvec = d / V;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    float v[V];
    rt::load_vec(xr + i * V, v);
#pragma unroll
    for (int j = 0; j < V; ++j) ss = fmaf(v[j], v[j], ss);
  }
  __shared__ float part[kThreads / 32];
  ss = rt::warp_sum(ss);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += part[w];
  const float rr = rsqrtf(total / static_cast<float>(d) + eps);

  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    float v[V], s[V];
    rt::load_vec(xr + i * V, v);
#pragma unroll
    for (int j = 0; j < V; j += 4) rt::load4(scale + i * V + j, s + j);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = v[j] * rr * (1.f + s[j]);
    rt::store_vec(yr + i * V, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const T* __restrict__ g, T* __restrict__ dx,
                   float* __restrict__ dscale_part, int rows, int d,
                   float eps) {
  constexpr int V = rt::Vec<T>::N;
  extern __shared__ float acc[];        // d floats: this block's dscale
  __shared__ float part[2][kThreads / 32];
  const int nvec = d / V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < nvec; i += kThreads) {
#pragma unroll
    for (int j = 0; j < V; ++j) acc[i * V + j] = 0.f;
  }
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + static_cast<size_t>(row) * d;
    const T* gr = g + static_cast<size_t>(row) * d;
    float ss = 0.f, gx = 0.f;
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      float xv[V], gv[V], s[V];
      rt::load_vec(xr + i * V, xv);
      rt::load_vec(gr + i * V, gv);
#pragma unroll
      for (int j = 0; j < V; j += 4) rt::load4(scale + i * V + j, s + j);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        ss = fmaf(xv[j], xv[j], ss);
        gx = fmaf(gv[j] * (1.f + s[j]), xv[j], gx);
      }
    }
    ss = rt::warp_sum(ss);
    gx = rt::warp_sum(gx);
    if (lane == 0) {
      part[0][warp] = ss;
      part[1][warp] = gx;
    }
    __syncthreads();
    float tss = 0.f, tgx = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      tss += part[0][w];
      tgx += part[1][w];
    }
    __syncthreads();                    // part is reused by the next row
    const float rr = rsqrtf(tss / static_cast<float>(d) + eps);
    const float proj = rr * tgx / static_cast<float>(d);   // mean(gs * xh)

    T* dxr = dx + static_cast<size_t>(row) * d;
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      float xv[V], gv[V], s[V], o[V];
      rt::load_vec(xr + i * V, xv);
      rt::load_vec(gr + i * V, gv);
#pragma unroll
      for (int j = 0; j < V; j += 4) rt::load4(scale + i * V + j, s + j);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = xv[j] * rr;
        o[j] = rr * (gv[j] * (1.f + s[j]) - xh * proj);
        acc[i * V + j] = fmaf(gv[j], xh, acc[i * V + j]);
      }
      rt::store_vec(dxr + i * V, o);
    }
  }
  float* out = dscale_part + static_cast<size_t>(blockIdx.x) * d;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
#pragma unroll
    for (int j = 0; j < V; j += 4)
      rt::store4(out + i * V + j, acc + i * V + j);
  }
}

}  // namespace

// x, out: (rows, d) contiguous, d a multiple of 8 (bfloat16) or 4
// (float32), 16-byte aligned; scale: (d,) float32.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out,
                           int rows, int d, float eps, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    if (dtype == rt::DTYPE_BF16) {
      rmsnorm_fwd_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const float*>(scale),
          static_cast<__nv_bfloat16*>(out), d, eps);
    } else if (dtype == rt::DTYPE_F32) {
      rmsnorm_fwd_kernel<float><<<rows, kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(scale),
          static_cast<float*>(out), d, eps);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The grid rmsnorm_bwd launches for `rows` rows: the number of float32
// dscale partial rows the caller allocates and sums.
extern "C" int rmsnorm_bwd_blocks(int rows) {
  return rows < kBwdBlocks ? rows : kBwdBlocks;
}

// x, g, dx: (rows, d) contiguous, d as for rmsnorm_fwd; scale: (d,)
// float32; dscale_part: (rmsnorm_bwd_blocks(rows), d) float32, each row
// one block's partial of dscale.  d * 4 bytes of shared memory must fit
// in 48 KB (d <= 12288).  Returns the CUDA error of the launch.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* g,
                           void* dx, void* dscale_part, int rows, int d,
                           float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = rmsnorm_bwd_blocks(rows);
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (rows > 0) {
    if (dtype == rt::DTYPE_BF16) {
      rmsnorm_bwd_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const float*>(scale),
          static_cast<const __nv_bfloat16*>(g),
          static_cast<__nv_bfloat16*>(dx), static_cast<float*>(dscale_part),
          rows, d, eps);
    } else if (dtype == rt::DTYPE_F32) {
      rmsnorm_bwd_kernel<float><<<grid, kThreads, smem, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(scale),
          static_cast<const float*>(g), static_cast<float*>(dx),
          static_cast<float*>(dscale_part), rows, d, eps);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
