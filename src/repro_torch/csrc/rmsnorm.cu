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
// tensor cores' line: 50 MB, 0.015 ms at 8192 x 1024.  It has to keep
// enough rows in flight to cover the memory's latency, and it must finish
// dscale, a sum over every row, without a second launch.
// - A persistent grid of at most one 512-thread block per SM.  A row is
//   owned by the fewest warps (1, 2, 4, 8 or 16) whose lanes hold it at 4
//   vectors of 16 bytes each, so a block has 16 / that many rows in
//   flight: 16 at d = 1024, 4 at 2560, 2 at 5120 in bfloat16, 40-64 KB of
//   loads an SM.  A block's R row slots take R neighbouring rows, then
//   the R rows one grid's worth further on, and so on.
// - Each row slot streams its rows through two stages of shared memory
//   by cp.async: while one row is worked on, the next is in flight (up to
//   128 KB of loads an SM).  A lane copies exactly the vectors it later
//   reads, so its own cp.async wait is all the ordering needed.  The row
//   is read into registers once: the two sums (x.x and gs.x) are reduced
//   by warp shuffles (and, for a row of several warps, through shared
//   memory at a barrier of those warps alone), then dx is formed from the
//   same registers.  scale is read from L1.
// - dscale: each lane adds g * xh of its own columns over its rows in
//   registers; at the end each row slot writes its sums to a row of the
//   idle ring, and the block adds them up in slot order as its partial.
//   Atomics would make the sum's order change from run to run, so the
//   partials are summed in block order by the last block of each merge
//   group of about sqrt(grid) blocks to finish (found by a counter it
//   resets, so no memset launch), and the groups' sums by the last group
//   to finish: one launch, the same bits every run, and no block reads
//   more than about 12 rows of partials.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBwdThreads = 512;        // backward: 16 warps a block
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdVec = 4;              // 16-byte vectors a lane holds of a row
constexpr int kBwdStages = 2;           // rows of a slot in the cp.async ring

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

// warps that own one row of nvec 16-byte vectors (0 if a row is too long)
__host__ __device__ __forceinline__ int bwd_warps_per_row(int nvec) {
  for (int w = 1; w <= kBwdWarps; w *= 2)
    if (w * 32 * kBwdVec >= nvec) return w;
  return 0;
}

struct BwdLayout {
  int wpr, blocks, merge, groups;       // merge: blocks a merge group
};

BwdLayout bwd_layout(int rows, int d, int dtype) {
  BwdLayout L{};
  const int V = dtype == rt::DTYPE_BF16 ? 8 : 4;
  L.wpr = bwd_warps_per_row(d / V);
  if (L.wpr == 0 || rows < 1) return L;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int per = kBwdWarps / L.wpr;    // rows in flight in a block
  const int need = (rows + per - 1) / per;
  L.blocks = need < sms ? need : sms;
  L.merge = 1;
  while (L.merge * L.merge < L.blocks) ++L.merge;
  L.groups = (L.blocks + L.merge - 1) / L.merge;
  return L;
}

template <typename T>
__device__ __forceinline__ void to_floats(const uint4& r, float* o) {
  if constexpr (sizeof(T) == 4) {
    o[0] = __uint_as_float(r.x);
    o[1] = __uint_as_float(r.y);
    o[2] = __uint_as_float(r.z);
    o[3] = __uint_as_float(r.w);
  } else {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
}

// sum of `n` rows of `d` floats from row r0 of `src` (written by other
// blocks: read around L1), in row order, into dst; up to 16 rows' loads
// in flight at once
__device__ __forceinline__ void sum_rows(float* dst, const float* src,
                                         int r0, int n, int d) {
  for (int c = 2 * threadIdx.x; c < d; c += 2 * kBwdThreads) {
    float2 s = make_float2(0.f, 0.f);
    for (int r = r0; r < r0 + n; r += 16) {
      float2 v[16];
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (r + k < r0 + n)
          v[k] = __ldcg(reinterpret_cast<const float2*>(
              src + static_cast<size_t>(r + k) * d + c));
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (r + k < r0 + n) {
          s.x += v[k].x;
          s.y += v[k].y;
        }
    }
    *reinterpret_cast<float2*>(dst + c) = s;
  }
}

// whether this block is the last of `n` to pass `ctr` (then reset to 0)
__device__ __forceinline__ bool last_to_finish(int* ctr, int n) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ctr, 1) == n - 1;
    if (last) atomicExch(ctr, 0);      // ready for the next launch
  }
  __syncthreads();
  const bool out = last;
  if (out) __threadfence();
  return out;
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 1)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const T* __restrict__ g, T* __restrict__ dx,
                   float* __restrict__ dscale, float* __restrict__ part,
                   int* __restrict__ counters, int rows, int d, int wpr,
                   int merge, int groups, float eps) {
  constexpr int V = rt::Vec<T>::N;
  extern __shared__ __align__(16) float sm[];   // the rows' ring
  __shared__ float red[2][kBwdWarps][2];        // a row's warp sums
  const int nvec = d / V;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per = kBwdWarps / wpr;              // rows in flight
  const int slot = warp / wpr;                  // this warp's row slot
  const int gl = (warp % wpr) * 32 + lane;      // lane within the row
  const int stride = wpr * 32;                  // lanes a row
  const float inv_d = 1.f / static_cast<float>(d);

  // kBwdStages (x, g) rows a slot
  const size_t row_bytes = static_cast<size_t>(d) * sizeof(T);
  unsigned char* ring = reinterpret_cast<unsigned char*>(sm);
  auto stage = [&](int st) {
    return ring + (kBwdStages * slot + st) * 2 * row_bytes;
  };
  // this lane's vectors of `row` into stage st (x, then g)
  auto fetch = [&](int row, int st) {
    const uint32_t dst = mma::smem_u32(stage(st));
    const T* xr = x + static_cast<size_t>(row) * d;
    const T* gr = g + static_cast<size_t>(row) * d;
#pragma unroll
    for (int k = 0; k < kBwdVec; ++k) {
      const int i = gl + k * stride;
      if (i < nvec) {
        mma::cp_async16(dst + 16 * i, xr + i * V, true);
        mma::cp_async16(dst + row_bytes + 16 * i, gr + i * V, true);
      }
    }
  };

  float acc[kBwdVec * V];
#pragma unroll
  for (int e = 0; e < kBwdVec * V; ++e) acc[e] = 0.f;
  int parity = 0;
  const int step = gridDim.x * per, first = blockIdx.x * per + slot;
#pragma unroll
  for (int k = 0; k < kBwdStages - 1; ++k) {
    if (first + k * step < rows) fetch(first + k * step, k);
    mma::cp_async_commit();
  }
  for (int row = first, n = 0; row < rows; row += step, ++n) {
    const int ahead = row + (kBwdStages - 1) * step;
    if (ahead < rows) fetch(ahead, (n + kBwdStages - 1) % kBwdStages);
    mma::cp_async_commit();
    mma::cp_async_wait<kBwdStages - 1>();   // this row's copies are in
    const unsigned char* cur = stage(n % kBwdStages);
    uint4 xv[kBwdVec], gv[kBwdVec];
#pragma unroll
    for (int k = 0; k < kBwdVec; ++k) {
      const int i = gl + k * stride;
      if (i < nvec) {
        xv[k] = *reinterpret_cast<const uint4*>(cur + 16 * i);
        gv[k] = *reinterpret_cast<const uint4*>(cur + row_bytes + 16 * i);
      }
    }
    float ss = 0.f, gx = 0.f;
#pragma unroll
    for (int k = 0; k < kBwdVec; ++k) {
      const int i = gl + k * stride;
      if (i < nvec) {
        float xf[V], gf[V], s[V];
        to_floats<T>(xv[k], xf);
        to_floats<T>(gv[k], gf);
#pragma unroll
        for (int j = 0; j < V; j += 4) rt::load4(scale + i * V + j, s + j);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          ss = fmaf(xf[j], xf[j], ss);
          gx = fmaf(gf[j] * (1.f + s[j]), xf[j], gx);
        }
      }
    }
    ss = rt::warp_sum(ss);
    gx = rt::warp_sum(gx);
    if (wpr > 1) {
      // the row's warps meet at a barrier of their own (ids 1 ..); the
      // two buffers alternate, so one barrier a row suffices
      if (lane == 0) {
        red[parity][warp][0] = ss;
        red[parity][warp][1] = gx;
      }
      asm volatile("bar.sync %0, %1;" ::"r"(slot + 1), "r"(stride)
                   : "memory");
      ss = gx = 0.f;
      for (int w = slot * wpr; w < (slot + 1) * wpr; ++w) {
        ss += red[parity][w][0];
        gx += red[parity][w][1];
      }
      parity ^= 1;
    }
    const float rr = rsqrtf(ss * inv_d + eps);
    const float proj = rr * gx * inv_d;         // mean(gs * xh)

    T* dxr = dx + static_cast<size_t>(row) * d;
#pragma unroll
    for (int k = 0; k < kBwdVec; ++k) {
      const int i = gl + k * stride;
      if (i < nvec) {
        float xf[V], gf[V], s[V], o[V];
        to_floats<T>(xv[k], xf);
        to_floats<T>(gv[k], gf);
#pragma unroll
        for (int j = 0; j < V; j += 4) rt::load4(scale + i * V + j, s + j);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xh = xf[j] * rr;
          o[j] = rr * (gf[j] * (1.f + s[j]) - xh * proj);
          acc[k * V + j] = fmaf(gf[j], xh, acc[k * V + j]);
        }
        rt::store_vec(dxr + i * V, o);
      }
    }
  }

  // the block's dscale partial: each slot's sums into its own row of the
  // ring, now idle (a row of d floats fits in a slot's stages), then every
  // column summed over the slots in slot order
  mma::cp_async_wait<0>();
  __syncthreads();
  float* own = reinterpret_cast<float*>(ring) + static_cast<size_t>(slot) * d;
#pragma unroll
  for (int kk = 0; kk < kBwdVec; ++kk) {
    const int i = gl + kk * stride;
    if (i < nvec) {
#pragma unroll
      for (int j = 0; j < V; j += 4)
        *reinterpret_cast<float4*>(own + i * V + j) =
            make_float4(acc[kk * V + j], acc[kk * V + j + 1],
                        acc[kk * V + j + 2], acc[kk * V + j + 3]);
    }
  }
  __syncthreads();
  const float* slots = reinterpret_cast<const float*>(ring);
  for (int c = 2 * threadIdx.x; c < d; c += 2 * kBwdThreads) {
    float2 sum = *reinterpret_cast<const float2*>(slots + c);
    for (int k = 1; k < per; ++k) {
      const float2 v = *reinterpret_cast<const float2*>(
          slots + static_cast<size_t>(k) * d + c);
      sum.x += v.x;
      sum.y += v.y;
    }
    *reinterpret_cast<float2*>(part + static_cast<size_t>(blockIdx.x) * d
                               + c) = sum;
  }

  // the last block of each merge group sums the group's partials in block
  // order; the last group's sum is finished by the groups' sums in order
  const int q = blockIdx.x / merge, q0 = q * merge;
  const int qn = min(merge, static_cast<int>(gridDim.x) - q0);
  if (!last_to_finish(counters + q, qn)) return;
  float* gsum = part + static_cast<size_t>(gridDim.x + q) * d;
  sum_rows(groups == 1 ? dscale : gsum, part, q0, qn, d);
  if (groups == 1) return;
  if (!last_to_finish(counters + groups, groups)) return;
  sum_rows(dscale, part, gridDim.x, groups, d);
}

template <typename T>
int launch_bwd(const void* x, const void* scale, const void* g, void* dx,
               void* dscale, void* part, void* counters, int rows, int d,
               float eps, cudaStream_t s) {
  const BwdLayout L = bwd_layout(rows, d, rt::Vec<T>::N == 8
                                             ? rt::DTYPE_BF16 : rt::DTYPE_F32);
  if (L.wpr == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int per = kBwdWarps / L.wpr;
  const int smem = 2 * kBwdStages * per * static_cast<int>(sizeof(T)) * d;
  const cudaError_t err = cudaFuncSetAttribute(
      rmsnorm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) {
    cudaGetLastError();                 // clear it; report it once
    return static_cast<int>(err);
  }
  rmsnorm_bwd_kernel<T><<<L.blocks, kBwdThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const T*>(g), static_cast<T*>(dx),
      static_cast<float*>(dscale), static_cast<float*>(part),
      static_cast<int*>(counters), rows, d, L.wpr, L.merge, L.groups, eps);
  return 0;
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

// The scratch rmsnorm_bwd needs for `rows` rows of `d` in `dtype`:
// float32 rows of d (one partial per block, then one per merge group) and
// int32 counters, which must be zero before the first launch and are left
// zero by every launch.  Returns 0 (and both 0) if d is too long: d / 8
// (bfloat16) or d / 4 (float32) 16-byte vectors above 2048.
extern "C" int rmsnorm_bwd_scratch(int rows, int d, int dtype,
                                   int* part_rows, int* counters) {
  const BwdLayout L = bwd_layout(rows, d, dtype);
  *part_rows = L.wpr ? L.blocks + L.groups : 0;
  *counters = L.wpr ? L.groups + 1 : 0;
  return L.wpr != 0;
}

// x, g, dx: (rows, d) contiguous, d as for rmsnorm_fwd and within
// rmsnorm_bwd_scratch's limit; scale: (d,) float32; dscale: (d,) float32,
// written whole; part and counters as rmsnorm_bwd_scratch says.  One
// launch.  Returns the CUDA error of the launch.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* g,
                           void* dx, void* dscale, void* part,
                           void* counters, int rows, int d, float eps,
                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (rows > 0) {
    if (dtype == rt::DTYPE_BF16) {
      err = launch_bwd<__nv_bfloat16>(x, scale, g, dx, dscale, part,
                                      counters, rows, d, eps, s);
    } else if (dtype == rt::DTYPE_F32) {
      err = launch_bwd<float>(x, scale, g, dx, dscale, part, counters, rows,
                              d, eps, s);
    } else {
      err = static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
