// K1: gather_i32 -- out[e] = table[idx[e]] in edge order.
//
// Replaces the TPU kernel kaminpar_tpu/ops/lane_gather.py::lane_gather
// (Pallas body _gather_kernel).  The TPU can only gather along a lane, so
// the JAX package routes the static index array (graph.dst) through a
// per-level plan and returns values in routed slot order; Hopper gathers
// any address from any thread, so the plan, q and inv are not ported and
// the result comes back in edge order.
//
// Bound on the H100: bytes.  Each element reads one 4-byte index and
// writes one 4-byte value, both coalesced, and the table is read once
// (4 n); the tables on the path (labels, blocks, cluster maps) are
// n_pad * 4 bytes and mostly stay in the 50 MB L2.  Each random 4-byte
// table read still costs L2 a whole 32-byte sector, so L2 moves about 3
// times the bytes that device memory does; that, not HBM, is what the
// measured time runs into.
//
// Design.  Each thread takes kUnroll elements per step, one per
// block-wide stride, and starts all their table reads before any store,
// so several independent reads are in flight per thread.  Neighbouring
// lanes of a warp gather neighbouring elements with 4-byte coalesced index
// loads: a CSR row's neighbours are sorted, so the 32 reads of one warp
// instruction share sectors where the row's neighbours lie close.  The
// table is read through the read-only path (__ldg).  The grid is
// kBlocksPerSm blocks of 256 threads on every SM, striding over the work.
// Loads of 16-byte index vectors and evict-first hints on the index and
// output streams were measured slower or no faster on the H100 (PERF.md),
// so neither is used.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;
constexpr int kBlocksPerSm = 64;

__global__ void __launch_bounds__(kThreads)
gather_kernel(const int32_t* __restrict__ table,
              const int32_t* __restrict__ idx, int32_t* __restrict__ out,
              long long m) {
  const long long step = (long long)gridDim.x * kThreads * kUnroll;
  for (long long e0 = (long long)blockIdx.x * kThreads * kUnroll +
                      threadIdx.x;
       e0 < m; e0 += step) {
    int32_t ix[kUnroll], val[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      long long e = e0 + (long long)u * kThreads;
      ix[u] = e < m ? __ldg(idx + e) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      long long e = e0 + (long long)u * kThreads;
      if (e < m) val[u] = __ldg(table + ix[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      long long e = e0 + (long long)u * kThreads;
      if (e < m) out[e] = val[u];
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

}  // namespace

extern "C" int kp_gather_i32(const void* table, const void* idx, void* out,
                             long long m, void* stream) {
  if (m <= 0) return (int)cudaGetLastError();
  const long long per_block = (long long)kThreads * kUnroll;
  long long blocks = (m + per_block - 1) / per_block;
  const long long cap = (long long)sm_count() * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  gather_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)table, (const int32_t*)idx, (int32_t*)out, m);
  return (int)cudaGetLastError();
}
