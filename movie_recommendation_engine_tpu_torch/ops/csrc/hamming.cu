// Multi-table Hamming distance for LSH search on Hopper (sm_90a), bound
// through ctypes.
//
// Replaces the TPU kernel movie_recommendation_engine_tpu/ops/pallas/
// hamming.py:hamming_distance (Pallas body _hamming_kernel). It computes
//
//     dist[q, n] = min_t sum_w popcount(qsig[q, t*W + w] ^ sigs[n, t*W + w])
//
// over signatures packed 32 bits to a word, held as int32 bit patterns
// ([rows, T*W]), and writes [Q, N] int32.
//
// What bounds it on an H100: at the serving shape (Q = 64, N = 4000, T = 16,
// W = 8) it must move ~3.1 MB (signatures and queries once, distances once)
// and do Q*N*T*W = 32.8M XOR/popcount/add triples, integer work on the CUDA
// cores (no tensor-core path for popcount); neither side dominates by much, and
// at small Q the launch itself is most of the time.
//
// Design: a block owns a [16, 128] tile of the output, one signature row per
// thread and 16 query accumulators per thread in registers. The query tile
// [16, T*W] is staged in shared memory once (every thread reads the same word:
// a broadcast). For each table, the tile's 128 signature rows of W words are
// staged in shared memory with coalesced loads, padded to W + 1 words per row
// so that the threads' row reads fall in distinct banks. The per-table sums and
// the running minimum across tables stay in registers; only the distances are
// written. Ragged Q and N are masked at staging (zeros) and at the store.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTQ = 16;   // queries per block
constexpr int kTN = 128;  // signature rows per block (one per thread)

__global__ void __launch_bounds__(kTN)
hamming_kernel(const int* __restrict__ qsig, const int* __restrict__ sigs,
               int* __restrict__ out, int nq, int ns, int tables, int words) {
  extern __shared__ int smem[];
  const int tw = tables * words;
  const int stride = words + 1;
  int* qs = smem;              // [kTQ][tw]
  int* ss = smem + kTQ * tw;   // [kTN][words + 1]
  const int q0 = blockIdx.y * kTQ;
  const int n0 = blockIdx.x * kTN;
  const int tid = threadIdx.x;

  for (int i = tid; i < kTQ * tw; i += kTN) {
    const int r = i / tw;
    qs[i] = (q0 + r < nq) ? qsig[static_cast<int64_t>(q0) * tw + i] : 0;
  }

  int best[kTQ];
#pragma unroll
  for (int j = 0; j < kTQ; ++j) best[j] = INT_MAX;

  for (int t = 0; t < tables; ++t) {
    __syncthreads();  // query tile staged; previous table's rows consumed
    for (int i = tid; i < kTN * words; i += kTN) {
      const int r = i / words;
      const int c = i - r * words;
      ss[r * stride + c] =
          (n0 + r < ns) ? sigs[static_cast<int64_t>(n0 + r) * tw + t * words + c] : 0;
    }
    __syncthreads();
    int acc[kTQ];
#pragma unroll
    for (int j = 0; j < kTQ; ++j) acc[j] = 0;
    for (int w = 0; w < words; ++w) {
      const unsigned x = static_cast<unsigned>(ss[tid * stride + w]);
      const int* qcol = qs + t * words + w;
#pragma unroll
      for (int j = 0; j < kTQ; ++j)
        acc[j] += __popc(static_cast<unsigned>(qcol[j * tw]) ^ x);
    }
#pragma unroll
    for (int j = 0; j < kTQ; ++j) best[j] = min(best[j], acc[j]);
  }

  const int n = n0 + tid;
  if (n < ns) {
#pragma unroll
    for (int j = 0; j < kTQ; ++j)
      if (q0 + j < nq) out[static_cast<int64_t>(q0 + j) * ns + n] = best[j];
  }
}

}  // namespace

// qsig [nq, tables*words] and sigs [ns, tables*words] int32 bit patterns;
// out [nq, ns] int32. Returns the launch's cudaError_t.
extern "C" int hamming_launch(const int* qsig, const int* sigs, int* out, int nq, int ns,
                              int tables, int words, void* stream) {
  if (nq == 0 || ns == 0) return 0;
  const size_t smem = sizeof(int) * (static_cast<size_t>(kTQ) * tables * words +
                                     static_cast<size_t>(kTN) * (words + 1));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hamming_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((ns + kTN - 1) / kTN, (nq + kTQ - 1) / kTQ);
  hamming_kernel<<<grid, kTN, smem, static_cast<cudaStream_t>(stream)>>>(
      qsig, sigs, out, nq, ns, tables, words);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hamming_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
