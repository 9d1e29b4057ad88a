// The RG-LRU linear recurrence and its reverse sweep, float32:
//   forward   h_t = a_t * h_{t-1} + b_t,   h_{-1} = h0 (or 0),
//   backward  g_t = dhs_t + a_{t+1} * g_{t+1},  g_{S-1} = dhs_{S-1} + dh_last,
//             db_t = g_t,  da_t = g_t * h_{t-1},  dh0 = a_0 * g_0,
// over a, b, hs of shape (B, S, W), contiguous with W innermost.
//
// Replaces no Pallas kernel: the reference computes the recurrence in XLA
// (src/repro/models/rglru.py::rglru_scan, an associative scan inside
// chunks of 512 steps and a sequential carry across them) and lets JAX
// differentiate it.  On the card it is the one operation of the RG-LRU
// hybrid's training and prefill without a kernel of its own; the gates
// around it (softplus, exp, sqrt and the products) stay in PyTorch.
//
// Bound on the H100: bytes.  The forward reads a and b and writes hs
// once (12 bytes a step and channel, 1 FMA), the backward reads a, hs and
// dhs and writes da and db (20 bytes, 2 multiplies and an FMA): far
// below the card's 295 operations a byte, so memory is the only limit
// (B=4, S=1024, W=4096: 201 MB forward, 0.060 ms at 3.35 TB/s).
//
// The design is the simple one: one thread for each (batch row, channel),
// sequential over S, so each output is one FMA on the last, as the
// definition reads.  Neighbouring threads own neighbouring channels, so a
// warp's loads and stores of a step are one 128-byte line.  The loads of
// a_t, b_t (dhs_t, h_{t-1}) do not depend on the chain, so the loop keeps
// the next kAhead steps' loads in flight while it runs the chain over the
// current kAhead: the dependent work is one FMA a step.  Blocks are one
// warp, so the B * W / 32 warps spread over every SM there is (B=2,
// W=4096: 256 blocks on 132 SMs).  The parallelism is only B * W
// threads; a chunked two-pass scan (local scans, then a carry pass) would
// fill the card at small B and is later work.  A ragged tail past S is
// read as a = 1, b = 0 steps (the state carried), nothing padded.
#include "common.cuh"

namespace {

constexpr int kThreads = 32;           // one warp a block
constexpr int kAhead = 16;             // steps whose loads are in flight

__global__ void __launch_bounds__(kThreads)
rglru_scan_fwd_kernel(const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ hs,
                      float* __restrict__ h_last, int S, int W, int64_t n) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (idx >= n) return;
  const int64_t row = idx / W, w = idx - row * W;
  const int64_t base = row * S * W + w;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = hs + base;
  float h = h0 ? h0[idx] : 0.f;
  float ca[kAhead], cb[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    const bool ok = u < S;
    ca[u] = ok ? __ldg(ap + static_cast<int64_t>(u) * W) : 1.f;
    cb[u] = ok ? __ldg(bp + static_cast<int64_t>(u) * W) : 0.f;
  }
  for (int t0 = 0; t0 < S; t0 += kAhead) {
    float na[kAhead], nb[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int t = t0 + kAhead + u;
      const bool ok = t < S;
      na[u] = ok ? __ldg(ap + static_cast<int64_t>(t) * W) : 1.f;
      nb[u] = ok ? __ldg(bp + static_cast<int64_t>(t) * W) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      h = fmaf(ca[u], h, cb[u]);
      if (t0 + u < S) hp[static_cast<int64_t>(t0 + u) * W] = h;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
  h_last[idx] = h;
}

// the reverse sweep: step t = S - 1 - j for j = 0, 1, ...; dhs, dh_last,
// h0 and dh0 may be null (zeros / not wanted)
__global__ void __launch_bounds__(kThreads)
rglru_scan_bwd_kernel(const float* __restrict__ a,
                      const float* __restrict__ hs,
                      const float* __restrict__ h0,
                      const float* __restrict__ dhs,
                      const float* __restrict__ dh_last,
                      float* __restrict__ da, float* __restrict__ db,
                      float* __restrict__ dh0, int S, int W, int64_t n) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (idx >= n) return;
  const int64_t row = idx / W, w = idx - row * W;
  const int64_t base = row * S * W + w;
  const float hinit = h0 ? h0[idx] : 0.f;
  // the loads of step t: a_t, dhs_t and h_{t-1}; past the start (t < 0)
  // a = 0 ends the carry, and nothing is stored
  auto load = [&](int t, float& at, float& gt, float& ht) {
    const int64_t o = base + static_cast<int64_t>(t) * W;
    at = t >= 0 ? __ldg(a + o) : 0.f;
    gt = (t >= 0 && dhs) ? __ldg(dhs + o) : 0.f;
    ht = t > 0 ? __ldg(hs + o - W) : hinit;
  };
  float carry = dh_last ? dh_last[idx] : 0.f;
  float ca[kAhead], cg[kAhead], ch[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) load(S - 1 - u, ca[u], cg[u], ch[u]);
  for (int j0 = 0; j0 < S; j0 += kAhead) {
    float na[kAhead], ng[kAhead], nh[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      load(S - 1 - (j0 + kAhead + u), na[u], ng[u], nh[u]);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int t = S - 1 - (j0 + u);
      const float g = cg[u] + carry;
      if (t >= 0) {
        const int64_t o = base + static_cast<int64_t>(t) * W;
        db[o] = g;
        da[o] = g * ch[u];
        carry = ca[u] * g;
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      ca[u] = na[u];
      cg[u] = ng[u];
      ch[u] = nh[u];
    }
  }
  if (dh0) dh0[idx] = carry;
}

inline unsigned blocks(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// a, b, hs: (B, S, W) float32, contiguous; h0 (B, W) float32 or null;
// h_last (B, W).  Returns the CUDA error of the launch (0 on success).
extern "C" int rglru_scan_fwd(const void* a, const void* b, const void* h0,
                              void* hs, void* h_last, int B, int S, int W,
                              void* stream) {
  if (B < 1 || S < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(B) * W;
  rglru_scan_fwd_kernel<<<blocks(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(hs),
      static_cast<float*>(h_last), S, W, n);
  return static_cast<int>(cudaGetLastError());
}

// a, hs, dhs, da, db: (B, S, W) float32, contiguous; h0, dh_last, dh0:
// (B, W); dhs, dh_last and h0 may be null (zeros), dh0 null when no
// gradient of h0 is wanted.  Returns the CUDA error of the launch.
extern "C" int rglru_scan_bwd(const void* a, const void* hs, const void* h0,
                              const void* dhs, const void* dh_last,
                              void* da, void* db, void* dh0, int B, int S,
                              int W, void* stream) {
  if (B < 1 || S < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(B) * W;
  rglru_scan_bwd_kernel<<<blocks(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(hs),
      static_cast<const float*>(h0), static_cast<const float*>(dhs),
      static_cast<const float*>(dh_last), static_cast<float*>(da),
      static_cast<float*>(db), static_cast<float*>(dh0), S, W, n);
  return static_cast<int>(cudaGetLastError());
}
