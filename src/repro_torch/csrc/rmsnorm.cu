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
// Bound on the H100, both directions: bytes.  Each element is read once
// and written once (2 + 2 bytes in bfloat16) for about four float
// operations, far below the ~295 operations per byte where the tensor
// cores would become the limit.  The design therefore only moves bytes
// well.
//
// The forward (8 rows of a decode step, 64-1024 of a prefill, 8192 of a
// training micro-batch; d = 1024 to 5120):
// - One sum order for a row, fixed by d alone: the squares of each
//   16-byte vector in one chain, the 32 vectors of a group (vectors 32 j
//   to 32 j + 31, vector 32 j + l held by lane l) by warp shuffles, and
//   the groups' sums added in group order.  Any number of warps can hold
//   a row and keep that order: they pass the groups' sums through shared
//   memory at a barrier of their own and each adds them all in order.  So
//   the layout may follow the call, and a row's output still has the same
//   bits whatever the call.  The layout comes from the wrapper
//   (kernels/rmsnorm.py::fwd_layout); the entry checks only that it
//   covers the row.
// - One read of x.
// - Calls whose rows all fit on the card at once (a decode step, a
//   prefill) are bound by latency: the register form gives each row a
//   block of the fewest warps whose lanes hold it at one vector each (4
//   at d = 1024 in bfloat16; 16 warps and up to 4 vectors a lane for
//   longer rows), starts every load of the row, x's vectors and then
//   scale's floats, before any arithmetic, and forms y from the same
//   registers: one trip to memory before the stores, and one barrier.
// - Calls with more rows (a training micro-batch) are bound by the bytes
//   in flight.  Their rows take the fewest warps whose lanes hold a row at
//   4 vectors each (1 at d = 1024, 4 at 2560 and 3072, 8 at 5120 in
//   bfloat16), 512 / (32 w) rows a block, a block's rows taking the grid's
//   stride.  Rows held in registers would cap an SM at one 512-thread
//   block (80-105 registers) or spill; the staged form copies x's vectors
//   into shared memory by cp.async instead, which holds no register while
//   the copy is in flight, so four 512-thread blocks of 32 registers an SM
//   (80-128 KB of x at d = 1024-5120) wait on memory at once; scale
//   follows the sum, from L1 once the SM's first rows have brought it in.
//   Four groups a warp are summed at once in 6 shuffles.
// - A row longer than 16 warps hold at 4 vectors a lane (d above 16384 in
//   bfloat16, 8192 in float32) takes the register form, a chunk of 2048
//   vectors at a time: the first chunk stays in registers, the others are
//   summed, then read again for y.
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
//
// The split row (Mamba-2's gated norm on a model axis, whose d_inner is
// cut over the model ranks): a rank holds d of the row's d_full columns,
// and the row's mean square needs every rank's part.  Three kernels, the
// all-reduces between them made by the caller (kernels/rmsnorm.py):
// - rmsnorm_split_dot_kernel: each row's partial float32 sum of x * x
//   (the forward's pass a) or of g * (1 + scale) * x (the backward's
//   partial dot), a warp a row, one chain a lane then rt::warp_sum;
// - rmsnorm_split_fwd_kernel: y = x * rsqrt(ss / d_full + eps) *
//   (1 + scale) from the whole row's sum ss, a 16-byte vector a thread
//   over a grid stride;
// - rmsnorm_split_bwd_kernel: with rr = rsqrt(ss / d_full + eps) and the
//   whole row's dot, mean(gs * xh) = rr * dot / d_full, so
//   dx = rr * (gs - xh * rr * dot / d_full); a thread owns 4 columns of a
//   chunk of rows and adds g * xh over them, and
//   rmsnorm_split_dscale_kernel sums the chunks' partials in chunk order
//   (no atomics: the same bits every run).
// All three are bound by bytes like the whole row's kernels; they are the
// simple form (x is read twice in each direction).
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kVec = 4;                 // a lane's 16-byte vectors of a row
constexpr int kFwdThreads = 512;        // forward: at most 16 warps a block
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kFwdGroups = kFwdWarps * kVec;    // 32-vector groups held
constexpr int kBwdThreads = 512;        // backward: 16 warps a block
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdStages = 2;           // rows of a slot in the cp.async ring

// warps that own one row of nvec 16-byte vectors (0 if a row is too long)
__host__ __device__ __forceinline__ int warps_per_row(int nvec) {
  for (int w = 1; w <= kBwdWarps; w *= 2)
    if (w * 32 * kVec >= nvec) return w;
  return 0;
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

// scale's V floats at vector i
template <int V>
__device__ __forceinline__ void load_scale(const float* scale, int i,
                                           float* s) {
#pragma unroll
  for (int j = 0; j < V; j += 4) rt::load4(scale + i * V + j, s + j);
}

// the sum of a vector's squares: one chain, from 0
template <int V>
__device__ __forceinline__ float squares(const float* v) {
  float p = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) p = fmaf(v[j], v[j], p);
  return p;
}

// y's V elements at vector i from x's floats v
template <typename T, int V>
__device__ __forceinline__ void store_y(T* yr, int i, float* v, float rr,
                                        const float* s) {
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = v[j] * rr * (1.f + s[j]);
  rt::store_vec(yr + i * V, v);
}

// the sums of four groups at once, each by rt::warp_sum's butterfly (so
// with its bits) in 6 shuffles where four warp_sums take 20: p[k] is this
// lane's part of group k; lane l ends with group l / 8's sum
__device__ __forceinline__ float warp_sum4(const float* p, int lane) {
  const bool h16 = lane & 16, h8 = lane & 8;
  float a = h16 ? p[2] : p[0], b = h16 ? p[3] : p[1];
  a += __shfl_xor_sync(rt::FULL_MASK, h16 ? p[0] : p[2], 16);
  b += __shfl_xor_sync(rt::FULL_MASK, h16 ? p[1] : p[3], 16);
  float c = h8 ? b : a;
  c += __shfl_xor_sync(rt::FULL_MASK, h8 ? a : b, 8);
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) c += __shfl_xor_sync(rt::FULL_MASK, c, o);
  return c;
}

// The sums of this warp's groups of 32 vectors into r[group]: the warp is
// the wi-th of its row's wpr and holds groups wi, wi + wpr, ...; p[k] is its
// lane's vector's squares in group wi + k wpr (0 past the row), for k below
// KV (1 or kVec), and groups from ng on are left out.  The caller meets the
// row's other warps at a barrier, then adds r[0 .. ng) in order.
template <int KV>
__device__ __forceinline__ void put_groups(const float* p, int ng, int wpr,
                                           int wi, int lane, float* r) {
  static_assert(KV == 1 || KV == kVec, "one vector a lane, or kVec");
  if constexpr (KV == 1) {
    const float g = rt::warp_sum(p[0]);
    if (lane == 0 && wi < ng) r[wi] = g;
  } else {
    const float g = warp_sum4(p, lane);
    const int k = lane / 8;
    if (lane % 8 == 0 && wi + k * wpr < ng) r[wi + k * wpr] = g;
  }
}

// r[0 .. ng) added to ss in order
__device__ __forceinline__ float add_groups(float ss, const float* r,
                                            int ng) {
  for (int j = 0; j < ng; ++j) ss += r[j];
  return ss;
}

// The register form, for calls whose rows all fit on the card at once, and
// rows longer than the staged form takes: a block a row, of blockDim.x / 32
// warps, KV vectors a lane (1 when the block's lanes hold the row so, else
// kVec), lane t owning vectors t, t + blockDim.x, ...  x's vectors and
// scale's floats of the first chunk go to registers, every load started
// before any arithmetic; a longer row's other chunks are summed, then read
// again for y.
template <typename T, int KV>
__global__ void __launch_bounds__(kFwdThreads)
rmsnorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ out, int rows, int d, float eps) {
  constexpr int V = rt::Vec<T>::N;
  __shared__ float part[kFwdGroups];           // a chunk's group sums
  const int nvec = d / V, groups = (nvec + 31) / 32;
  const int t = threadIdx.x, lane = t % 32, wi = t / 32;
  const int stride = blockDim.x, wpr = stride / 32;
  const int chunk = stride * KV;                // vectors held at once
  const int cgroups = wpr * KV;                 // their groups
  // ss plus the chunk's ng group sums, in order; part is read here, so the
  // block meets again before the next call writes it
  auto chunk_sum = [&](float ss, const float* p, int ng) {
    put_groups<KV>(p, ng, wpr, wi, lane, part);
    __syncthreads();
    return add_groups(ss, part, ng);
  };
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + static_cast<size_t>(row) * d;
    T* yr = out + static_cast<size_t>(row) * d;
    uint4 xv[KV];
    float s[KV][V], p[KV];
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int i = t + k * stride;
      if (i < nvec) xv[k] = *reinterpret_cast<const uint4*>(xr + i * V);
    }
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int i = t + k * stride;
      if (i < nvec) load_scale<V>(scale, i, s[k]);
    }
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      p[k] = 0.f;
      if (t + k * stride < nvec) {
        float v[V];
        to_floats<T>(xv[k], v);
        p[k] = squares<V>(v);
      }
    }
    float ss = chunk_sum(0.f, p, min(cgroups, groups));
    // the other chunks of a row longer than the block holds at once (the
    // one-vector form is never given one, and compiles without them: the
    // code alone slowed its small calls)
    if constexpr (KV > 1) {
      for (int c = chunk, g0 = cgroups; c < nvec;
           c += chunk, g0 += cgroups) {
        __syncthreads();
        uint4 cv[KV];
#pragma unroll
        for (int k = 0; k < KV; ++k) {
          const int i = c + t + k * stride;
          if (i < nvec) cv[k] = *reinterpret_cast<const uint4*>(xr + i * V);
        }
#pragma unroll
        for (int k = 0; k < KV; ++k) {
          p[k] = 0.f;
          if (c + t + k * stride < nvec) {
            float v[V];
            to_floats<T>(cv[k], v);
            p[k] = squares<V>(v);
          }
        }
        ss = chunk_sum(ss, p, min(cgroups, groups - g0));
      }
    }
    const float rr = rsqrtf(ss / static_cast<float>(d) + eps);
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int i = t + k * stride;
      if (i < nvec) {
        float v[V];
        to_floats<T>(xv[k], v);
        store_y<T, V>(yr, i, v, rr, s[k]);
      }
    }
    if constexpr (KV > 1) {
      for (int c = chunk; c < nvec; c += chunk) {
#pragma unroll
        for (int k = 0; k < KV; ++k) {
          const int i = c + t + k * stride;
          if (i < nvec) {
            float v[V], sc[V];
            rt::load_vec(xr + i * V, v);
            load_scale<V>(scale, i, sc);
            store_y<T, V>(yr, i, v, rr, sc);
          }
        }
      }
    }
    __syncthreads();            // after the stores, off the row's path
  }
}

// The staged form, for calls with more rows than the card holds at once
// and rows their lanes hold at kVec vectors each: blocks of rpb rows of wpr
// warps, row r of a block taking rows blockIdx.x * rpb + r, then one
// grid's worth on, lane gl of a row owning vectors gl, gl + 32 wpr, ...
// x's vectors go to shared memory by cp.async (no register holds a load in
// flight, so four 512-thread blocks an SM have every row's loads in flight
// at once), then are summed and scaled from there; scale is read after the
// sum, from L1 once the SM's first rows have brought it in.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads, 4)
rmsnorm_fwd_staged_kernel(const T* __restrict__ x,
                          const float* __restrict__ scale,
                          T* __restrict__ out, int rows, int d, int wpr,
                          int rpb, float eps) {
  constexpr int V = rt::Vec<T>::N;
  extern __shared__ __align__(16) unsigned char stage[];   // rpb rows of x
  __shared__ float red[2][kFwdGroups];
  const int nvec = d / V, groups = (nvec + 31) / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = warp / wpr, wi = warp % wpr, gl = wi * 32 + lane;
  const int stride = wpr * 32;
  const unsigned char* xs = stage + static_cast<size_t>(slot) * nvec * 16;
  const uint32_t xs32 = mma::smem_u32(xs);
  int parity = 0;
  for (int row = blockIdx.x * rpb + slot; row < rows;
       row += gridDim.x * rpb) {
    const T* xr = x + static_cast<size_t>(row) * d;
    T* yr = out + static_cast<size_t>(row) * d;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int i = gl + k * stride;
      if (i < nvec) mma::cp_async16(xs32 + 16 * i, xr + i * V, true);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<0>();    // a lane reads back only what it copied
    float p[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int i = gl + k * stride;
      p[k] = 0.f;
      if (i < nvec) {
        float v[V];
        to_floats<T>(*reinterpret_cast<const uint4*>(xs + 16 * i), v);
        p[k] = squares<V>(v);
      }
    }
    // the row's warps meet at a barrier of their own (ids 1 ..); the two
    // buffers alternate, so one barrier a row suffices
    float* r = red[parity] + slot * wpr * kVec;
    put_groups<kVec>(p, groups, wpr, wi, lane, r);
    if (wpr == 1)
      __syncwarp();
    else
      asm volatile("bar.sync %0, %1;" ::"r"(slot + 1), "r"(stride)
                   : "memory");
    const float ss = add_groups(0.f, r, groups);
    parity ^= 1;
    const float rr = rsqrtf(ss / static_cast<float>(d) + eps);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int i = gl + k * stride;
      if (i < nvec) {
        float v[V], s[V];
        to_floats<T>(*reinterpret_cast<const uint4*>(xs + 16 * i), v);
        load_scale<V>(scale, i, s);
        store_y<T, V>(yr, i, v, rr, s);
      }
    }
  }
}

template <typename T>
void launch_fwd(const void* x, const void* scale, void* out, int rows, int d,
                int wpr, int rpb, int blocks, bool staged, float eps,
                cudaStream_t s) {
  const int threads = rpb * wpr * 32;
  const T* xt = static_cast<const T*>(x);
  const float* st = static_cast<const float*>(scale);
  T* ot = static_cast<T*>(out);
  if (staged)
    rmsnorm_fwd_staged_kernel<T><<<blocks, threads, rpb * d * sizeof(T), s>>>(
        xt, st, ot, rows, d, wpr, rpb, eps);
  else if (threads * rt::Vec<T>::N >= d)
    rmsnorm_fwd_kernel<T, 1><<<blocks, threads, 0, s>>>(xt, st, ot, rows, d,
                                                        eps);
  else
    rmsnorm_fwd_kernel<T, kVec><<<blocks, threads, 0, s>>>(xt, st, ot, rows,
                                                           d, eps);
}

struct BwdLayout {
  int wpr, blocks, merge, groups;       // merge: blocks a merge group
};

BwdLayout bwd_layout(int rows, int d, int dtype) {
  BwdLayout L{};
  const int V = dtype == rt::DTYPE_BF16 ? 8 : 4;
  L.wpr = warps_per_row(d / V);
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
    for (int k = 0; k < kVec; ++k) {
      const int i = gl + k * stride;
      if (i < nvec) {
        mma::cp_async16(dst + 16 * i, xr + i * V, true);
        mma::cp_async16(dst + row_bytes + 16 * i, gr + i * V, true);
      }
    }
  };

  float acc[kVec * V];
#pragma unroll
  for (int e = 0; e < kVec * V; ++e) acc[e] = 0.f;
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
    uint4 xv[kVec], gv[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int i = gl + k * stride;
      if (i < nvec) {
        xv[k] = *reinterpret_cast<const uint4*>(cur + 16 * i);
        gv[k] = *reinterpret_cast<const uint4*>(cur + row_bytes + 16 * i);
      }
    }
    float ss = 0.f, gx = 0.f;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
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
    for (int k = 0; k < kVec; ++k) {
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
  for (int kk = 0; kk < kVec; ++kk) {
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

// --------------------------------------------------------------------- //
// the split row
// --------------------------------------------------------------------- //

constexpr int kSplitThreads = 256;

// out[row] = sum over the row's columns of x * x (g null) or of
// g * (1 + scale) * x, a warp a row, lane l summing vectors l, l + 32, ...
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
rmsnorm_split_dot_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const float* __restrict__ scale,
                         float* __restrict__ out, int rows, int d) {
  constexpr int N = rt::Vec<T>::N;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                 // a whole warp leaves
  const int nvec = d / N;
  const size_t base = static_cast<size_t>(row) * d;
  float acc = 0.f;
#pragma unroll 4
  for (int i = lane; i < nvec; i += 32) {
    float v[N];
    rt::load_vec(x + base + static_cast<size_t>(i) * N, v);
    if (g == nullptr) {
#pragma unroll
      for (int j = 0; j < N; ++j) acc = fmaf(v[j], v[j], acc);
    } else {
      float w[N], sc[N];
      rt::load_vec(g + base + static_cast<size_t>(i) * N, w);
#pragma unroll
      for (int j = 0; j < N; j += 4) rt::load4(scale + i * N + j, sc + j);
#pragma unroll
      for (int j = 0; j < N; ++j) acc = fmaf(w[j] * (1.f + sc[j]), v[j], acc);
    }
  }
  acc = rt::warp_sum(acc);
  if (lane == 0) out[row] = acc;
}

// y = x * rsqrt(ss[row] / d_full + eps) * (1 + scale), a 16-byte vector a
// thread over a grid stride
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
rmsnorm_split_fwd_kernel(const T* __restrict__ x,
                         const float* __restrict__ scale,
                         const float* __restrict__ ss, T* __restrict__ y,
                         int rows, int d, int d_full, float eps) {
  constexpr int N = rt::Vec<T>::N;
  const int nvec = d / N;
  const int64_t total = static_cast<int64_t>(rows) * nvec;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x; i < total; i += step) {
    const int row = static_cast<int>(i / nvec);
    const int c = static_cast<int>(i % nvec) * N;
    const float rr = rsqrtf(ss[row] / static_cast<float>(d_full) + eps);
    float v[N], sc[N];
    rt::load_vec(x + i * N, v);
#pragma unroll
    for (int j = 0; j < N; j += 4) rt::load4(scale + c + j, sc + j);
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = v[j] * rr * (1.f + sc[j]);
    rt::store_vec(y + i * N, v);
  }
}

// dx of rows [blockIdx.y * chunk, ...) at this thread's 4 columns, and
// their sum of g * xh into part[blockIdx.y]
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
rmsnorm_split_bwd_kernel(const T* __restrict__ x,
                         const float* __restrict__ scale,
                         const T* __restrict__ g,
                         const float* __restrict__ ss,
                         const float* __restrict__ dot, T* __restrict__ dx,
                         float* __restrict__ part, int rows, int d,
                         int d_full, int chunk, float eps) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (c >= d) return;
  const float inv_d = 1.f / static_cast<float>(d_full);
  float sc[4], acc[4] = {0.f, 0.f, 0.f, 0.f};
  rt::load4(scale + c, sc);
  const int r0 = blockIdx.y * chunk, r1 = min(rows, r0 + chunk);
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    const float rr = rsqrtf(ss[r] / static_cast<float>(d_full) + eps);
    const float proj = dot[r] * rr * inv_d;        // mean(gs * xh)
    const size_t off = static_cast<size_t>(r) * d + c;
    float xv[4], gv[4], o[4];
    rt::load4(x + off, xv);
    rt::load4(g + off, gv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float xh = xv[j] * rr;
      o[j] = rr * (gv[j] * (1.f + sc[j]) - xh * proj);
      acc[j] = fmaf(gv[j], xh, acc[j]);
    }
    rt::store4(dx + off, o);
  }
  rt::store4(part + static_cast<size_t>(blockIdx.y) * d + c, acc);
}

// dscale[c] = the chunks' partials of column c, added in chunk order
__global__ void __launch_bounds__(kSplitThreads)
rmsnorm_split_dscale_kernel(const float* __restrict__ part,
                            float* __restrict__ dscale, int chunks, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float a = 0.f;
  for (int k = 0; k < chunks; ++k) a += part[static_cast<size_t>(k) * d + c];
  dscale[c] = a;
}

bool split_shape_ok(int rows, int d, int d_full, int dtype) {
  const int V = dtype == rt::DTYPE_BF16 ? 8 : 4;
  return (dtype == rt::DTYPE_BF16 || dtype == rt::DTYPE_F32) && rows >= 0
         && d >= V && d % V == 0 && d_full >= d;
}

}  // namespace

// x, out: (rows, d) contiguous, d a multiple of 8 (bfloat16) or 4
// (float32), 16-byte aligned; scale: (d,) float32.  The layout as
// kernels/rmsnorm.py::fwd_layout gives it: rows_per_block rows of
// warps_per_row warps, at most 512 threads a block; staged (the
// shared-memory form) only for rows the lanes hold at 4 vectors each, the
// register form one row a block.  Any such layout gives a row the same
// bits.  Returns cudaErrorInvalidValue
// for any other layout, else the CUDA error of the launch (0 on success).
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out,
                           int rows, int d, float eps, int dtype,
                           int warps_per_row, int rows_per_block, int blocks,
                           int staged, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    const int V = dtype == rt::DTYPE_BF16 ? 8 : 4;
    if ((dtype != rt::DTYPE_BF16 && dtype != rt::DTYPE_F32) || d < V
        || d % V || warps_per_row < 1 || rows_per_block < 1
        || rows_per_block * warps_per_row > kFwdWarps || blocks < 1
        || (staged ? d / V > warps_per_row * 32 * kVec
                   : rows_per_block != 1))
      return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == rt::DTYPE_BF16)
      launch_fwd<__nv_bfloat16>(x, scale, out, rows, d, warps_per_row,
                                rows_per_block, blocks, staged, eps, s);
    else
      launch_fwd<float>(x, scale, out, rows, d, warps_per_row,
                        rows_per_block, blocks, staged, eps, s);
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

// The split row's partial sums: out (rows,) float32 = each row's sum of
// x * x when g is null, else of g * (1 + scale) * x.  x, g: (rows, d)
// contiguous, 16-byte aligned, d a multiple of 8 (bfloat16) or 4
// (float32); scale: (d,) float32.  One launch.
extern "C" int rmsnorm_split_dot(const void* x, const void* g,
                                 const void* scale, void* out, int rows,
                                 int d, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!split_shape_ok(rows, d, d, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    const int blocks = (rows + kSplitThreads / 32 - 1) / (kSplitThreads / 32);
    if (dtype == rt::DTYPE_BF16)
      rmsnorm_split_dot_kernel<__nv_bfloat16><<<blocks, kSplitThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(g),
          static_cast<const float*>(scale), static_cast<float*>(out), rows, d);
    else
      rmsnorm_split_dot_kernel<float><<<blocks, kSplitThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(g),
          static_cast<const float*>(scale), static_cast<float*>(out), rows, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// The split row's forward from the whole rows' sums of squares ss (rows,)
// float32: y = x * rsqrt(ss / d_full + eps) * (1 + scale).  x, y as for
// rmsnorm_split_dot; `blocks` blocks of 256 threads over a grid stride.
// One launch.
extern "C" int rmsnorm_split_fwd(const void* x, const void* scale,
                                 const void* ss, void* y, int rows, int d,
                                 int d_full, float eps, int dtype, int blocks,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!split_shape_ok(rows, d, d_full, dtype) || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    if (dtype == rt::DTYPE_BF16)
      rmsnorm_split_fwd_kernel<__nv_bfloat16><<<blocks, kSplitThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const float*>(scale), static_cast<const float*>(ss),
          static_cast<__nv_bfloat16*>(y), rows, d, d_full, eps);
    else
      rmsnorm_split_fwd_kernel<float><<<blocks, kSplitThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(scale),
          static_cast<const float*>(ss), static_cast<float*>(y), rows, d,
          d_full, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// The split row's backward from the whole rows' ss and dot (rows,)
// float32: dx (rows, d) in x's dtype and dscale (d,) float32 of this
// rank's columns.  part: (ceil(rows / chunk), d) float32 scratch.  Two
// launches: dx with the chunks' partials, then their sum in chunk order.
extern "C" int rmsnorm_split_bwd(const void* x, const void* scale,
                                 const void* g, const void* ss,
                                 const void* dot, void* dx, void* dscale,
                                 void* part, int rows, int d, int d_full,
                                 int chunk, float eps, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!split_shape_ok(rows, d, d_full, dtype) || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (rows + chunk - 1) / chunk;
  if (rows > 0) {
    const dim3 grid((d / 4 + kSplitThreads - 1) / kSplitThreads, chunks);
    if (dtype == rt::DTYPE_BF16)
      rmsnorm_split_bwd_kernel<__nv_bfloat16><<<grid, kSplitThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const float*>(scale),
          static_cast<const __nv_bfloat16*>(g), static_cast<const float*>(ss),
          static_cast<const float*>(dot), static_cast<__nv_bfloat16*>(dx),
          static_cast<float*>(part), rows, d, d_full, chunk, eps);
    else
      rmsnorm_split_bwd_kernel<float><<<grid, kSplitThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(scale),
          static_cast<const float*>(g), static_cast<const float*>(ss),
          static_cast<const float*>(dot), static_cast<float*>(dx),
          static_cast<float*>(part), rows, d, d_full, chunk, eps);
  }
  rmsnorm_split_dscale_kernel<<<(d + kSplitThreads - 1) / kSplitThreads,
                                kSplitThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dscale), chunks, d);
  return static_cast<int>(cudaGetLastError());
}
