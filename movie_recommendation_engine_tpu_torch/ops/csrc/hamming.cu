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
// What bounds it on an H100 (the arithmetic is core/roofline.py's). With one
// POPC per word, the Q*N*T*W popcounts bind: POPC issues at 16 results per
// clock per SM on compute capability 9.0, a quarter of the rate of XOR, add
// and min (64). At Q = 64, N = 4000, T = 16, W = 8 that is 32.8M popcounts,
// 7.8 us at 1,980 MHz. At small Q the bytes (the 2 MB corpus, 0.62 us;
// resident in L2 while serving) and the launch itself are the bound. The
// function's least time over every route is the int8 tensor-core bit-GEMM's
// (1.1 us at Q = 64), which this kernel does not take.
//
// Design, for each of these:
// - Popcount rate. For 8-word groups a carry-save adder tree (two LOP3s per
//   3:2 step) folds the 8 XOR words into ones/twos/fours planes, so 8 words
//   cost 4 POPC instead of 8 and part of the work moves to the 4x faster
//   logic units, where it then binds: ~20 int32 ops against 4 POPC per 8
//   words, 4.9 us at Q = 64. The distance is the same integer. Other W take
//   one POPC per word.
// - Query reads. One corpus row per lane, 32 rows per block, and the block's
//   8 warps split the tables (warp w scores tables w, w + 8, ...). All lanes
//   of a warp then read the same query words at the same time: shared-memory
//   broadcasts, with no bank conflicts and no padding, and no shuffles, since
//   a lane holds every table sum of its own row. The min over the warps goes
//   through shared-memory atomicMin, once per (query, row).
// - Bytes and latency. Each lane reads its row's table (W words) straight
//   into registers, as 16-byte loads when W is 4, 8 or 16; the next table's
//   words are loaded while one is scored, and the first table's while the
//   query tile is staged (cp.async, all of it in flight at once). No
//   shared-memory staging of the corpus and no barrier inside the table loop.
// - Work that scales with Q. The query tile QT (1, 4, 8, 16 or 32; the
//   wrapper picks the smallest that holds Q, ops/hamming.py plan()) is a
//   template parameter, so Q = 1 does 1/64 of the work of Q = 64.
// - Stores. Distances leave through a [QT, 32] shared tile as coalesced
//   128-byte row segments of out.
// Any T and W work (the T loop strides by 8 warps, the scalar path takes any
// W); the wrapper checks shared memory and the grid.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;               // corpus rows per block, one per lane
constexpr int kWarps = 8;               // warps per block, splitting the tables
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ void cp_async16(int* smem_dst, const int* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void csa(unsigned& carry, unsigned& sum, unsigned a, unsigned b,
                                    unsigned c) {
  const unsigned u = a ^ b;
  carry = (a & b) | (u & c);
  sum = u ^ c;
}

// Popcount of 8 words (the XORs of query and row words) through the
// carry-save tree: 4 POPC instead of 8.
__device__ __forceinline__ int popc8(const unsigned (&x)[8]) {
  unsigned ones, t0, t1, t2, twos, fours;
  csa(t0, ones, x[0], x[1], x[2]);
  csa(t1, ones, ones, x[3], x[4]);
  csa(t2, ones, ones, x[5], x[6]);
  csa(fours, twos, t0, t1, t2);
  return __popc(ones) + __popc(x[7]) + 2 * __popc(twos) + 4 * __popc(fours);
}

// Distance of one table: WC words of a query in shared memory (16-byte
// aligned) against WC words of a row in registers.
template <int WC>
__device__ __forceinline__ int table_dist(const int* q, const uint4 (&x)[WC / 4]) {
  const uint4* qv = reinterpret_cast<const uint4*>(q);
  int s = 0;
  if (WC % 8 == 0) {
#pragma unroll
    for (int k = 0; k < WC / 4; k += 2) {
      const uint4 a = qv[k], b = qv[k + 1];
      const unsigned w[8] = {a.x ^ x[k].x,     a.y ^ x[k].y,     a.z ^ x[k].z,
                             a.w ^ x[k].w,     b.x ^ x[k + 1].x, b.y ^ x[k + 1].y,
                             b.z ^ x[k + 1].z, b.w ^ x[k + 1].w};
      s += popc8(w);
    }
  } else {
#pragma unroll
    for (int k = 0; k < WC / 4; ++k) {
      const uint4 a = qv[k];
      s += __popc(a.x ^ x[k].x) + __popc(a.y ^ x[k].y) + __popc(a.z ^ x[k].z) +
           __popc(a.w ^ x[k].w);
    }
  }
  return s;
}

// One block: QT queries (blockIdx.y) against kRows corpus rows (blockIdx.x),
// one row per lane; warp w scores tables w, w + kWarps, ... of its lane's
// row. WC > 0: W == WC words per table, read as uint4 (pointers 16-byte
// aligned); WC == 0: any W, scalar reads.
template <int QT, int WC>
__global__ void __launch_bounds__(kThreads)
hamming_kernel(const int* __restrict__ qsig, const int* __restrict__ sigs,
               int* __restrict__ out, int nq, int ns, int tables, int words_rt) {
  constexpr bool kVec = WC > 0;
  const int words = kVec ? WC : words_rt;
  const int tw = tables * words;
  extern __shared__ __align__(16) int smem[];
  int* qs = smem;               // [QT][tables * words]
  int* os = smem + QT * tw;     // [QT][kRows], min over the warps
  const int q0 = blockIdx.y * QT;
  const int n0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // Rows past N score row 0 (always there) and are not stored.
  const int* row = sigs + static_cast<int64_t>(n0 + lane < ns ? n0 + lane : 0) * tw;

  // Vector path: the words of this warp's first table are loaded before the
  // query staging is waited for, and each next table's while one is scored.
  constexpr int kC = kVec ? WC / 4 : 1;
  uint4 x[kC];
  auto load_table = [&](uint4 (&dst)[kC], int t) {
#pragma unroll
    for (int k = 0; k < kC; ++k) dst[k] = __ldg(reinterpret_cast<const uint4*>(row + t * WC) + k);
  };
  if constexpr (kVec) {
    if (warp < tables) load_table(x, warp);
  }

  // Stage the query tile (zeros past Q), all of it in flight at once: 16-byte
  // asynchronous copies on the vector path.
  for (int i = tid; i < QT * kRows; i += kThreads) os[i] = INT_MAX;
  if constexpr (kVec) {
    const int chunks = tw / 4;
    for (int i = tid; i < QT * chunks; i += kThreads) {
      const int j = i / chunks;
      int* dst = qs + 4 * i;
      if (q0 + j < nq)
        cp_async16(dst, qsig + static_cast<int64_t>(q0) * tw + 4 * i);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    for (int i = tid; i < QT * tw; i += kThreads)
      qs[i] = q0 + i / tw < nq ? __ldg(qsig + static_cast<int64_t>(q0) * tw + i) : 0;
  }
  __syncthreads();

  int best[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) best[j] = INT_MAX;
  if constexpr (kVec) {
    for (int t = warp; t < tables; t += kWarps) {
      uint4 nx[kC];
      if (t + kWarps < tables) load_table(nx, t + kWarps);
      const int* qt = qs + t * WC;  // every lane reads the same words: broadcasts
#pragma unroll
      for (int j = 0; j < QT; ++j) best[j] = min(best[j], table_dist<WC>(qt + j * tw, x));
#pragma unroll
      for (int k = 0; k < kC; ++k) x[k] = nx[k];
    }
  } else {
    for (int t = warp; t < tables; t += kWarps) {
      int acc[QT];
#pragma unroll
      for (int j = 0; j < QT; ++j) acc[j] = 0;
      for (int w = 0; w < words; ++w) {
        const unsigned xw = static_cast<unsigned>(__ldg(row + t * words + w));
        const int* qw = qs + t * words + w;
#pragma unroll
        for (int j = 0; j < QT; ++j) acc[j] += __popc(static_cast<unsigned>(qw[j * tw]) ^ xw);
      }
#pragma unroll
      for (int j = 0; j < QT; ++j) best[j] = min(best[j], acc[j]);
    }
  }
  // Min across the warps (tables), then coalesced rows of out.
#pragma unroll
  for (int j = 0; j < QT; ++j) atomicMin(os + j * kRows + lane, best[j]);
  __syncthreads();
  for (int i = tid; i < QT * kRows; i += kThreads) {
    const int j = i / kRows, r = i - j * kRows;
    if (q0 + j < nq && n0 + r < ns) out[static_cast<int64_t>(q0 + j) * ns + n0 + r] = os[i];
  }
}

template <int QT, int WC>
int launch(const int* qsig, const int* sigs, int* out, int nq, int ns, int tables, int words,
           size_t smem, cudaStream_t stream) {
  auto kernel = hamming_kernel<QT, WC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((ns + kRows - 1) / kRows, (nq + QT - 1) / QT);
  kernel<<<grid, kThreads, smem, stream>>>(qsig, sigs, out, nq, ns, tables, words);
  return static_cast<int>(cudaGetLastError());
}

template <int QT>
int launch_w(int wc, const int* qsig, const int* sigs, int* out, int nq, int ns, int tables,
             int words, size_t smem, cudaStream_t stream) {
  switch (wc) {
    case 4: return launch<QT, 4>(qsig, sigs, out, nq, ns, tables, words, smem, stream);
    case 8: return launch<QT, 8>(qsig, sigs, out, nq, ns, tables, words, smem, stream);
    case 16: return launch<QT, 16>(qsig, sigs, out, nq, ns, tables, words, smem, stream);
    case 0: return launch<QT, 0>(qsig, sigs, out, nq, ns, tables, words, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_q(int qt, int wc, const int* qsig, const int* sigs, int* out, int nq, int ns,
             int tables, int words, size_t smem, cudaStream_t stream) {
  switch (qt) {
    case 1: return launch_w<1>(wc, qsig, sigs, out, nq, ns, tables, words, smem, stream);
    case 4: return launch_w<4>(wc, qsig, sigs, out, nq, ns, tables, words, smem, stream);
    case 8: return launch_w<8>(wc, qsig, sigs, out, nq, ns, tables, words, smem, stream);
    case 16: return launch_w<16>(wc, qsig, sigs, out, nq, ns, tables, words, smem, stream);
    case 32: return launch_w<32>(wc, qsig, sigs, out, nq, ns, tables, words, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// qsig [nq, tables*words] and sigs [ns, tables*words] int32 bit patterns;
// out [nq, ns] int32. The tiling comes from the wrapper (ops/hamming.py
// plan()): qt queries per block (1, 4, 8, 16 or 32), wc words per table
// read as uint4 (4, 8, 16; 0 = scalar reads, any W), smem bytes of dynamic
// shared memory. Returns the launch's cudaError_t.
extern "C" int hamming_launch(const int* qsig, const int* sigs, int* out, int nq, int ns,
                              int tables, int words, int qt, int wc, int smem, void* stream) {
  if (nq == 0 || ns == 0) return 0;
  return launch_q(qt, wc, qsig, sigs, out, nq, ns, tables, words, static_cast<size_t>(smem),
                  static_cast<cudaStream_t>(stream));
}

extern "C" const char* hamming_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
