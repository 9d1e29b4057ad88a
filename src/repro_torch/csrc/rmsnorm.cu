// RMSNorm forward: y = x * rsqrt(mean(x^2) + eps) * (1 + scale), the
// arithmetic in float32 and y in x's dtype.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel
// (called through _pallas_fwd).
//
// Bound on the H100: bytes.  Each element is read once and written once
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
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

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
