// Streaming normalize, y = x * rsqrt(mean(x^2) + 1e-5) over float32 rows,
// through a ring of `depth` shared-memory stages filled and drained by
// Hopper's bulk asynchronous copies.
//
// Replaces the TPU kernel benchmarks/bench_kernels.py::_overlap_kernel
// (called through _overlap_call): row-blocks flow global -> in-stage ->
// compute -> out-stage -> global, with the copies in and out issued
// explicitly and `depth` of each in flight, so that a sweep over depth
// shows how much of the copy latency the ring hides.  Depth 1 serializes
// load, compute and store, as the reference's does.
//
// Bound on the H100: bytes.  Each element is read once and written once
// (8 bytes) for three float operations: at the benchmark's 8192 x 512 the
// 33.6 MB take 10.0 us at 3.35 TB/s.  What the design does about it:
//
// - Grid: persistent, one block per SM (G = min(row-blocks, SMs), chosen
//   by the caller).  Block c streams row-blocks c, c + G, c + 2G, ...:
//   where the TPU core walked every row-block alone, each of the 132 SMs
//   walks its own share and keeps its own ring full.
// - Loads: one thread issues each stage's load as one 1-D bulk copy
//   (cp.async.bulk ... mbarrier::complete_tx::bytes).  A row-block is
//   contiguous, so no tensor map is needed.  The stage's mbarrier counts
//   the bytes; every thread waits on it with the parity of the stage's
//   use (use j of stage s waits for parity j & 1).
// - Compute: one warp per row, float4 reads from shared memory (lanes on
//   neighbouring 16-byte words: no bank conflicts), the sum of squares by
//   warp shuffles, rsqrtf, and float4 writes into the out-stage.
// - Stores: every thread fences its writes to the async proxy
//   (fence.proxy.async.shared::cta), the block syncs, and one thread
//   issues a bulk store of the whole out-stage and commits it as a group.
// - Stage reuse: before the out-stage of row-block k is written, the
//   issuing thread waits until the store of row-block k - depth has read
//   it (cp.async.bulk.wait_group.read depth - 1: at most depth - 1 newer
//   stores still reading), then the block syncs; this is the reference's
//   out_dma(i - depth).wait().  The in-stage is refilled with row-block
//   k + depth only after the sync that follows the compute, when every
//   thread has read it (the reference's _refill).  Before the block
//   exits, wait_group 0 drains its stores.
//
// The footprint is 2 * depth * block_rows * d * 4 bytes of stages plus
// depth 8-byte mbarriers, above 48 KB only by opting in
// (cudaFuncAttributeMaxDynamicSharedMemorySize).  A bulk copy wants
// 16-byte-aligned addresses and a size that is a multiple of 16 bytes:
// the wrapper checks d * 4 % 16 == 0 and the pointers' alignment, and
// rows % block_rows == 0 (the reference never writes a ragged tail).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;           // 8 warps; one warp per row
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStoresInFlight = 8;   // wait_group takes a constant
constexpr float kEps = 1e-5f;           // the reference's _overlap_kernel

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_addr(bar);
  // labels inside { } are local to the block, so every inlined copy may
  // use the same names
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(addr), "r"(parity) : "memory");
}

// global -> shared, `bytes` counted on `bar` (one arrival with the bytes
// expected, then the copy's completion)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared -> global as one bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's committed stores still read
// shared memory (n is clamped to kMaxStoresInFlight - 1, which only
// waits longer)
__device__ __forceinline__ void wait_stores_read(int n) {
  switch (n < kMaxStoresInFlight - 1 ? n : kMaxStoresInFlight - 1) {
    case 0: asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.bulk.wait_group.read 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.bulk.wait_group.read 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.bulk.wait_group.read 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.bulk.wait_group.read 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.bulk.wait_group.read 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.bulk.wait_group.read 7;\n" ::: "memory"); break;
  }
}

__global__ void __launch_bounds__(kThreads)
overlap_norm_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int n_blocks, int block_rows, int d, int depth) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int stage_floats = block_rows * d;
  const unsigned stage_bytes = static_cast<unsigned>(stage_floats) * 4u;
  float* in_st = reinterpret_cast<float*>(smem);
  float* out_st = in_st + static_cast<size_t>(depth) * stage_floats;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      out_st + static_cast<size_t>(depth) * stage_floats);

  const int G = gridDim.x;
  const int first = blockIdx.x;
  const int n_local = (n_blocks - first + G - 1) / G;   // >= 1: G <= n_blocks
  const bool issuer = threadIdx.x == 0;
  const size_t block_elems = static_cast<size_t>(stage_floats);

  if (issuer) {
    for (int s = 0; s < depth; ++s) bar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // prologue: fill the ring, never past this block's own row-blocks
  if (issuer) {
    const int pre = n_local < depth ? n_local : depth;
    for (int k = 0; k < pre; ++k)
      bulk_load(in_st + k * block_elems,
                x + static_cast<size_t>(first + k * G) * block_elems,
                stage_bytes, &full[k]);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nvec = d / 4;
  const float inv_d = 1.f / static_cast<float>(d);
  for (int k = 0; k < n_local; ++k) {
    const int s = k % depth;
    float* in_s = in_st + s * block_elems;
    float* out_s = out_st + s * block_elems;
    // the out-stage is free once the store of row-block k - depth has
    // read it
    if (issuer && k >= depth) wait_stores_read(depth - 1);
    __syncthreads();
    bar_wait(&full[s], static_cast<unsigned>((k / depth) & 1));

    for (int r = warp; r < block_rows; r += kWarps) {
      const float* xr = in_s + static_cast<size_t>(r) * d;
      float* yr = out_s + static_cast<size_t>(r) * d;
      float ss = 0.f;
      for (int i = lane; i < nvec; i += 32) {
        const float4 v = reinterpret_cast<const float4*>(xr)[i];
        ss = fmaf(v.x, v.x, ss);
        ss = fmaf(v.y, v.y, ss);
        ss = fmaf(v.z, v.z, ss);
        ss = fmaf(v.w, v.w, ss);
      }
      const float rr = rsqrtf(rt::warp_sum(ss) * inv_d + kEps);
      for (int i = lane; i < nvec; i += 32) {
        float4 v = reinterpret_cast<const float4*>(xr)[i];
        v.x *= rr; v.y *= rr; v.z *= rr; v.w *= rr;
        reinterpret_cast<float4*>(yr)[i] = v;
      }
    }
    // the generic-proxy writes of the out-stage, seen by the bulk store
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();      // every thread has read in_s and written out_s
    if (issuer) {
      bulk_store(out + static_cast<size_t>(first + k * G) * block_elems,
                 out_s, stage_bytes);
      if (k + depth < n_local)
        bulk_load(in_s,
                  x + static_cast<size_t>(first + (k + depth) * G)
                      * block_elems,
                  stage_bytes, &full[s]);
    }
  }
  // epilogue: every store complete before the block (and its shared
  // memory) goes away
  if (issuer) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// 2 * depth stages of block_rows * d float32 and depth mbarriers
long long smem_bytes(int block_rows, int d, int depth) {
  return 2LL * depth * block_rows * d * 4 + 8LL * depth;
}

}  // namespace

// x, out: (n_blocks * block_rows, d) float32, contiguous, 16-byte
// aligned, d a multiple of 4; grid = min(n_blocks, SM count) blocks;
// depth >= 1 stages, whose footprint (smem_bytes above) the caller has
// checked against the card's opt-in shared memory per block.  Returns
// the CUDA error of the launch (0 on success); a launch refused for its
// shared memory shows here.
extern "C" int overlap_norm(const void* x, void* out, int n_blocks,
                            int block_rows, int d, int depth, int grid,
                            void* stream) {
  if (n_blocks <= 0) return 0;
  if (depth < 1 || grid < 1 || grid > n_blocks || d % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = smem_bytes(block_rows, d, depth);
  cudaError_t err = cudaFuncSetAttribute(
      overlap_norm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();                  // clear it; report it once
    return static_cast<int>(err);
  }
  overlap_norm_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n_blocks,
      block_rows, d, depth);
  return static_cast<int>(cudaGetLastError());
}
