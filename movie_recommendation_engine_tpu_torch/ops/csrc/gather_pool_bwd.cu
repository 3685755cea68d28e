// Backward of the weighted row gather-pool, for Hopper (sm_90a), bound through
// ctypes: route "atomic" of ops/pool.py:gather_pool_bwd for d_table (the
// default route, "segment", is gather_pool_bwd_segment.cu), and d_w on every
// route.
//
// Replaces the gradient of the TPU kernel movie_recommendation_engine_tpu/ops/
// pallas/pool.py:gather_pool, which JAX writes in XLA beside the Pallas forward
// (gather_pool_ad's _gather_pool_bwd: a scatter-add and a gather-dot). For the
// forward out[b] = sum_k w'[b, k] * table[idx[b, k]] (w' = w masked to 0 where
// nbrs < 0 or nbrs >= limit, idx = nbrs clamped into [0, limit)) and the f32
// cotangent g [B, D] it computes
//
//     d_table[r, :] = sum over valid (b, k) with idx[b, k] == r of w[b, k] * g[b, :]
//     d_w[b, k]     = <g[b, :], table[idx[b, k], :]> at valid slots, 0 elsewhere
//
// both in f32 (the wrapper casts d_table to the table's dtype, as JAX does).
//
// What bounds it on an H100: memory and L2 atomics. At the training step's
// layer 0 (N = B = 3980, K = 50, D = 256) it must move ~7.7 MB (g, ids and
// weights read once, d_table written once) and do ~0.1 GFLOP, so bytes bind
// (~2.3 us); but the scatter makes one f32 add per valid slot and column,
// ~48 M, which the L2's atomic units carry. d_table (4 MB in f32) stays in
// L2, so its adds never reach device memory until the end.
//
// Design: one warp per output row b, eight rows per block, as the forward's
// direct route. The warp stages its row's K (clamped id or -1 where masked,
// weight) pairs in shared memory once. Each lane owns 16 bytes (4 f32 columns)
// of the row per pass: it loads those 4 values of g[b] once, then for every
// valid k adds w[b, k] * g into row idx[b, k] with one 16-byte atomic add
// (atomicAdd on float4, a vector RED on sm_90; its result is not used). A
// warp's 32 lanes thus add 512 contiguous bytes of one row per instruction.
// Rows that are not a whole number of 16-byte chunks, or unaligned tensors,
// take the scalar path (4-byte atomics, one column per lane). d_w, when asked
// for, is a second loop over the K slots: each lane dots its columns of g and
// of the gathered row, and a warp shuffle sums the lanes.
//
// Determinism: atomics add in an order that changes from run to run, so the
// f32 d_table wanders by rounding between runs and the bf16 one by at most one
// bf16 step; d_w is deterministic. The ids are skewed (the most frequent 256
// ids of a walk table hold about a third of its valid slots), so the rows of
// hub nodes take many adds from many warps at once, and those adds serialize
// at their L2 slice. The segment route sums the same d_table in a fixed order
// with no atomics, and on an H100 it is also the faster where its layout is
// built ahead (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

// VW (4 or 1) table values as f32: one 16-byte (f32) or 8-byte (bf16) load.
template <int VW>
__device__ __forceinline__ void load_table(const float* p, float (&v)[VW]) {
  if constexpr (VW == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VW>
__device__ __forceinline__ void load_table(const uint16_t* p, float (&v)[VW]) {
  if constexpr (VW == 4) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(x.x << 16);  // little endian: element 2i is the low half
    v[1] = __uint_as_float(x.x & 0xffff0000u);
    v[2] = __uint_as_float(x.y << 16);
    v[3] = __uint_as_float(x.y & 0xffff0000u);
  } else {
    v[0] = to_float(__ldg(p));
  }
}

template <int VW>
__device__ __forceinline__ void load_g(const float* p, float (&v)[VW]) {
  if constexpr (VW == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VW>
__device__ __forceinline__ void add_to(float* p, float w, const float (&v)[VW]) {
  if constexpr (VW == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(w * v[0], w * v[1], w * v[2], w * v[3]));
  } else {
    atomicAdd(p, w * v[0]);
  }
}

// d_table [n, d] f32 zeroed by the caller, or null to skip the scatter;
// d_w [b, k] f32, or null to skip the dot products.
template <typename T, int VW>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_pool_bwd_kernel(const T* __restrict__ table, const int* __restrict__ nbrs,
                       const float* __restrict__ weights, const float* __restrict__ g,
                       float* __restrict__ d_table, float* __restrict__ d_w, int b, int k,
                       int d, int limit) {
  extern __shared__ unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* ids = reinterpret_cast<int*>(smem) + warp * k;
  float* ws = reinterpret_cast<float*>(smem + sizeof(int) * kWarpsPerBlock * k) + warp * k;

  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= b) return;  // the whole warp leaves; only __syncwarp is used below

  const int64_t base = static_cast<int64_t>(row) * k;
  for (int j = lane; j < k; j += 32) {
    const int id = nbrs[base + j];
    const bool valid = id >= 0 && id < limit;
    ids[j] = valid ? id : -1;
    ws[j] = valid ? weights[base + j] : 0.f;
  }
  __syncwarp();

  const int nvec = d / VW;
  const float* g_row = g + static_cast<int64_t>(row) * d;
  if (d_table != nullptr) {
    for (int v = lane; v < nvec; v += 32) {
      float gv[VW];
      load_g<VW>(g_row + static_cast<int64_t>(v) * VW, gv);
#pragma unroll 4
      for (int j = 0; j < k; ++j) {
        const int id = ids[j];  // the same for every lane: no divergence
        if (id < 0) continue;
        add_to<VW>(d_table + static_cast<int64_t>(id) * d + static_cast<int64_t>(v) * VW, ws[j],
                   gv);
      }
    }
  }
  if (d_w != nullptr) {
    for (int j = 0; j < k; ++j) {
      const int id = ids[j];
      float acc = 0.f;
      if (id >= 0) {
        const T* t_row = table + static_cast<int64_t>(id) * d;
        for (int v = lane; v < nvec; v += 32) {
          float gv[VW], x[VW];
          load_g<VW>(g_row + static_cast<int64_t>(v) * VW, gv);
          load_table<VW>(t_row + static_cast<int64_t>(v) * VW, x);
#pragma unroll
          for (int i = 0; i < VW; ++i) acc = fmaf(gv[i], x[i], acc);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (lane == 0) d_w[base + j] = acc;
    }
  }
}

template <typename T, int VW>
cudaError_t launch(const void* table, const int* nbrs, const float* weights, const float* g,
                   float* d_table, float* d_w, int b, int k, int d, int limit,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kWarpsPerBlock) * k * (sizeof(int) + sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_pool_bwd_kernel<T, VW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((b + kWarpsPerBlock - 1) / kWarpsPerBlock);
  gather_pool_bwd_kernel<T, VW><<<grid, kWarpsPerBlock * 32, smem, stream>>>(
      static_cast<const T*>(table), nbrs, weights, g, d_table, d_w, b, k, d, limit);
  return cudaGetLastError();
}

}  // namespace

// table: [n, d] bf16 (table_is_bf16 = 1) or f32; nbrs [b, k] int32; weights
// [b, k] f32; g [b, d] f32; d_table [n, d] f32, zeroed, or null; d_w [b, k]
// f32 or null. vectorized = 1 requires d to be a multiple of 4, g and d_table
// 16-byte aligned and the table aligned to 4 elements. Returns the launch's
// cudaError_t.
extern "C" int gather_pool_bwd_launch(const void* table, int table_is_bf16, const int* nbrs,
                                      const float* weights, const float* g, float* d_table,
                                      float* d_w, int b, int k, int d, int limit, int vectorized,
                                      void* stream) {
  if (b == 0 || d == 0 || (d_table == nullptr && d_w == nullptr)) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (table_is_bf16) {
    err = vectorized ? launch<uint16_t, 4>(table, nbrs, weights, g, d_table, d_w, b, k, d, limit, s)
                     : launch<uint16_t, 1>(table, nbrs, weights, g, d_table, d_w, b, k, d, limit, s);
  } else {
    err = vectorized ? launch<float, 4>(table, nbrs, weights, g, d_table, d_w, b, k, d, limit, s)
                     : launch<float, 1>(table, nbrs, weights, g, d_table, d_w, b, k, d, limit, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* gather_pool_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
