// Weighted row gather + pooling for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernel movie_recommendation_engine_tpu/ops/pallas/pool.py:
// gather_pool (Pallas body _pool_kernel). It computes
//
//     out[b, :] = sum_k w'[b, k] * table[clip(nbrs[b, k], 0, limit - 1), :]
//
// with w' = 0 where nbrs < 0 or nbrs >= limit, accumulated and written in f32,
// from a bf16 or f32 [N, D] table.
//
// What bounds it on an H100: memory. At the serving shape (N = B = 4000,
// K = 50, D = 256 bf16) it does two flops per gathered element (~0.1 GFLOP)
// while it must move ~7.7 MB (table, ids, weights once, output once), far
// below the flops per byte where arithmetic would bind. The neighbour rows are
// scattered 512-byte reads; a 2 MB table stays in the 50 MB L2, so rows that
// are gathered again come from L2.
//
// Design: one warp per output row, eight rows per block. The warp stages its
// row's K masked, clamped (id, weight) pairs in shared memory once. Each lane
// then owns 16 bytes of the output row (8 bf16 or 4 f32 columns; more chunks
// when D is wider than 32 vectors), walks the K neighbours reading those 16
// bytes of each neighbour row with one vector load, and accumulates in f32
// registers. A warp thus reads whole contiguous row segments, and the
// [B, K, D] gathered tensor of the plain formulation never exists. None of the
// TPU kernel's Mosaic workarounds carry over (sublane-window DMAs with a
// one-hot weight expansion, per-tile SMEM ids, HIGHEST-precision dots): a GPU
// thread can load any single row. Rows whose byte size is not a multiple of 16,
// or tables not 16-byte aligned, take the scalar path (one element per lane).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float load_one(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_one(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}

// VW values from one 16-byte load (VW == 1: a single scalar load).
template <int VW>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VW]) {
  if constexpr (VW == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    v[0] = load_one(p);
  }
}

template <int VW>
__device__ __forceinline__ void load_vec(const uint16_t* p, float (&v)[VW]) {
  if constexpr (VW == 8) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // little endian: element 2i is the low half
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    v[0] = load_one(p);
  }
}

template <int VW>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VW]) {
  if constexpr (VW >= 4) {
#pragma unroll
    for (int i = 0; i < VW; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
    p[0] = v[0];
  }
}

template <typename T, int VW>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_pool_kernel(const T* __restrict__ table, const int* __restrict__ nbrs,
                   const float* __restrict__ weights, float* __restrict__ out,
                   int b, int k, int d, int limit) {
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
    ids[j] = min(max(id, 0), limit - 1);
    ws[j] = valid ? weights[base + j] : 0.f;
  }
  __syncwarp();

  const int nvec = d / VW;
  float* out_row = out + static_cast<int64_t>(row) * d;
  for (int v = lane; v < nvec; v += 32) {
    float acc[VW];
#pragma unroll
    for (int i = 0; i < VW; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int j = 0; j < k; ++j) {
      float x[VW];
      load_vec<VW>(table + static_cast<int64_t>(ids[j]) * d + static_cast<int64_t>(v) * VW, x);
      const float w = ws[j];
#pragma unroll
      for (int i = 0; i < VW; ++i) acc[i] = fmaf(w, x[i], acc[i]);
    }
    store_vec<VW>(out_row + static_cast<int64_t>(v) * VW, acc);
  }
}

template <typename T, int VW>
cudaError_t launch(const void* table, const int* nbrs, const float* weights, float* out,
                   int b, int k, int d, int limit, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kWarpsPerBlock) * k * (sizeof(int) + sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_pool_kernel<T, VW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((b + kWarpsPerBlock - 1) / kWarpsPerBlock);
  gather_pool_kernel<T, VW><<<grid, kWarpsPerBlock * 32, smem, stream>>>(
      static_cast<const T*>(table), nbrs, weights, out, b, k, d, limit);
  return cudaGetLastError();
}

}  // namespace

// table: [n, d] bf16 (table_is_bf16 = 1) or f32; nbrs [b, k] int32;
// weights [b, k] f32; out [b, d] f32. vectorized = 1 requires d * element
// size to be a multiple of 16 bytes and a 16-byte aligned table. Returns the
// launch's cudaError_t.
extern "C" int gather_pool_launch(const void* table, int table_is_bf16, const int* nbrs,
                                  const float* weights, float* out, int b, int k, int d,
                                  int limit, int vectorized, void* stream) {
  if (b == 0 || d == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (table_is_bf16) {
    err = vectorized ? launch<uint16_t, 8>(table, nbrs, weights, out, b, k, d, limit, s)
                     : launch<uint16_t, 1>(table, nbrs, weights, out, b, k, d, limit, s);
  } else {
    err = vectorized ? launch<float, 4>(table, nbrs, weights, out, b, k, d, limit, s)
                     : launch<float, 1>(table, nbrs, weights, out, b, k, d, limit, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* gather_pool_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
