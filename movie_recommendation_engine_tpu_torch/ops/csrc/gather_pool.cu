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
// are gathered again come from L2. Rows of one output block share almost no
// neighbours, so every gathered row is an L2 read: ~102 MB per call at the
// serving shape, and that read rate is what the direct route runs at.
//
// Two routes; ops/pool.py:plan picks one per call and its tiling.
//
// Route "direct" (gather_pool_kernel): one warp per output row, eight rows
// per block. The warp stages its row's K masked, clamped (id, weight) pairs in
// shared memory once. Each lane then owns 16 bytes of the output row (8 bf16
// or 4 f32 columns; more chunks when D is wider than 32 vectors), walks the K
// neighbours reading those 16 bytes of each neighbour row with one vector
// load, and accumulates in f32 registers. A warp thus reads whole contiguous
// row segments, and the [B, K, D] gathered tensor of the plain formulation
// never exists. None of the TPU kernel's Mosaic workarounds carry over
// (sublane-window DMAs with a one-hot weight expansion, per-tile SMEM ids,
// HIGHEST-precision dots): a GPU thread can load any single row. Rows whose
// byte size is not a multiple of 16, or tables not 16-byte aligned, take the
// scalar path (one element per lane). It takes any table.
//
// Route "resident" (gather_pool_resident_kernel), for tables whose column
// slice fits in shared memory: the grid is (column slices) x (row groups).
// A block copies its [limit, CH * 16 bytes] slice of the rows the ids can
// reach into shared memory once (cp.async, 16 bytes per thread), then its
// warps walk the group's output rows, 32 / CH rows per pass: CH lanes per
// row, each owning 16 bytes of the slice. Per pass a warp stages the rows'
// (byte offset of the clamped row, masked weight) pairs in its own small
// shared-memory buffer (the whole group's ids would not fit beside the
// slice), then sums w' * slice[row] over k in f32 registers and writes its
// 16-byte segment of each output row. One 227 KB block per SM leaves 16
// warps to hide shared-memory latency, so the loop reads two pairs with one
// load and the four rows they name before any multiply-add, with no
// arithmetic between a pair and its row. L2 then carries the table once per
// row group and the ids and weights once per slice, instead of every
// gathered row. Bank conflicts: a slice row is CH * 16 contiguous bytes, so
// a 128-byte wavefront serves 128 / (CH * 16) rows and rows in the same bank
// group collide; for independent random rows no pad or swizzle avoids that
// (each row must cover CH * 4 banks), so none is used (~2.1 wavefronts per
// 128 bytes for 4 random rows). The pair buffer's row stride is K rounded up
// to 2 mod 4, so the lanes' 16-byte loads of two pairs fall on distinct
// banks.
//
// Both routes sum over k in order with fmaf from 0, so their outputs are
// bitwise equal.
//
// On an H100 the resident route loses to the direct one at the serving shape
// (PERF.md, chip_smoke.py's gather_pool phase), so ops/pool.py:plan picks
// direct. Cutting L2 bytes moved the bound elsewhere: the gathered rows now
// come from shared memory at ~2 wavefronts per 128 bytes (the bank
// conflicts above), the slice copy reads 32-byte pieces of every row once
// per row group, and one 227 KB block per SM leaves 16 warps to hide latency.

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

// ---------------------------------------------------------------------------
// Route "resident"
// ---------------------------------------------------------------------------

constexpr int kMaxResidentWarps = 16;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// 16 bytes of a slice row from shared memory as f32 values.
__device__ __forceinline__ void load_slice(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void load_slice(const uint16_t* p, float (&v)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Pairs per row of a warp's pair buffer: K rounded up to 2 mod 4, so that a
// 16-byte load of two pairs is aligned and the lanes' loads of one phase fall
// on distinct banks.
__device__ __forceinline__ int pair_stride(int k) { return ((k + 1) | 3) - 1; }

// Stage the (byte offset of the clamped row in the slice, weight masked to 0
// outside [0, limit)) pairs of output rows [base, base + nrows) into a warp's
// pair buffer. Lane l takes slots j = l (mod 32); four rows' loads are issued
// before any is used, so a pass costs a few L2 round trips, not one a pair.
template <int CH>
__device__ __forceinline__ void stage_pairs(int2* pairs, const int* __restrict__ nbrs,
                                            const float* __restrict__ weights, int base,
                                            int nrows, int k, int kp, int limit, int lane) {
  for (int r0 = 0; r0 < nrows; r0 += 4)
    for (int j0 = 0; j0 < k; j0 += 64) {
      int id[4][2];
      float w[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int j = j0 + lane + 32 * t;
          const int64_t g = static_cast<int64_t>(base + r0 + u) * k + j;
          const bool in = r0 + u < nrows && j < k;
          id[u][t] = in ? __ldg(nbrs + g) : 0;
          w[u][t] = in ? __ldg(weights + g) : 0.f;
        }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int j = j0 + lane + 32 * t;
          if (r0 + u < nrows && j < k) {
            const bool valid = id[u][t] >= 0 && id[u][t] < limit;
            pairs[(r0 + u) * kp + j] = make_int2(min(max(id[u][t], 0), limit - 1) * (CH * 16),
                                                 __float_as_int(valid ? w[u][t] : 0.f));
          }
        }
    }
}

// Grid (slices, groups), blockDim.x = 32 * warps. Dynamic shared memory:
// the slice, [limit][CH] 16-byte chunks, then per warp a [32 / CH][pair_stride(K)]
// buffer of (byte offset of the clamped row in the slice, masked weight) pairs.
template <typename T, int CH>
__global__ void __launch_bounds__(kMaxResidentWarps * 32)
gather_pool_resident_kernel(const T* __restrict__ table, const int* __restrict__ nbrs,
                            const float* __restrict__ weights, float* __restrict__ out,
                            int b, int k, int d, int limit, int rows_per_group) {
  constexpr int VW = 16 / sizeof(T);  // values per 16-byte chunk
  constexpr int R = 32 / CH;          // output rows per warp pass
  extern __shared__ __align__(16) unsigned char resident_smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kp = pair_stride(k);
  const int row_chunks = d / VW;                     // 16-byte chunks per table row
  const int c0 = static_cast<int>(blockIdx.x) * CH;  // the slice's first chunk
  const int nch = min(CH, row_chunks - c0);          // the last slice may be narrower

  // 1. The slice: chunks [c0, c0 + nch) of rows [0, limit), copied with
  // cp.async. The row groups of one slice start at different rows, so that
  // they do not all read the same L2 lines at once.
  const unsigned char* src = reinterpret_cast<const unsigned char*>(table);
  const int64_t row_bytes = static_cast<int64_t>(d) * sizeof(T);
  const int total = limit * CH;
  const int shift = static_cast<int>(static_cast<int64_t>(total) * blockIdx.y / gridDim.y);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int e = i + shift < total ? i + shift : i + shift - total;
    const int r = e / CH, c = e % CH;
    if (c < nch)
      cp_async16(resident_smem + static_cast<size_t>(e) * 16,
                 src + r * row_bytes + static_cast<int64_t>(c0 + c) * 16);
  }

  int2* pairs = reinterpret_cast<int2*>(resident_smem + static_cast<size_t>(limit) * CH * 16) +
                warp * R * kp;
  const int group = blockIdx.y;
  const int row_end = min(b, (group + 1) * rows_per_group);
  int base = group * rows_per_group + warp * R;
  int nrows = min(R, row_end - base);
  stage_pairs<CH>(pairs, nbrs, weights, base, nrows, k, kp, limit, lane);
  cp_async_wait_all();
  __syncthreads();

  // 2. Each warp walks its passes of R rows; lane = (row slot, chunk). Four
  // neighbours per step: two 16-byte pair loads, then four independent slice
  // loads, then the multiply-adds in k order.
  const int slot = lane / CH, c = lane % CH;
  const unsigned char* chunk_base = resident_smem + c * 16;
  for (; base < row_end; base += warps * R) {
    const int row = base + slot;
    if (row < row_end && c < nch) {
      const int2* p = pairs + slot * kp;
      float acc[VW];
#pragma unroll
      for (int i = 0; i < VW; ++i) acc[i] = 0.f;
      int j = 0;
      for (; j + 4 <= k; j += 4) {
        const int4 qa = *reinterpret_cast<const int4*>(p + j);
        const int4 qb = *reinterpret_cast<const int4*>(p + j + 2);
        const int off[4] = {qa.x, qa.z, qb.x, qb.z};
        const float w[4] = {__int_as_float(qa.y), __int_as_float(qa.w), __int_as_float(qb.y),
                            __int_as_float(qb.w)};
        float x[4][VW];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          load_slice(reinterpret_cast<const T*>(chunk_base + off[u]), x[u]);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int i = 0; i < VW; ++i) acc[i] = fmaf(w[u], x[u][i], acc[i]);
      }
      for (; j < k; ++j) {
        const int2 q = p[j];
        float x[VW];
        load_slice(reinterpret_cast<const T*>(chunk_base + q.x), x);
#pragma unroll
        for (int i = 0; i < VW; ++i) acc[i] = fmaf(__int_as_float(q.y), x[i], acc[i]);
      }
      store_vec<VW>(out + static_cast<int64_t>(row) * d + static_cast<int64_t>(c0 + c) * VW, acc);
    }
    __syncwarp();  // every lane is done with the buffer before it is refilled
    nrows = min(R, row_end - (base + warps * R));
    if (nrows > 0) {
      stage_pairs<CH>(pairs, nbrs, weights, base + warps * R, nrows, k, kp, limit, lane);
      __syncwarp();
    }
  }
}

template <typename T, int CH>
cudaError_t launch_resident(const void* table, const int* nbrs, const float* weights,
                            float* out, int b, int k, int d, int limit, int slices,
                            int groups, int rows_per_group, int warps, int smem,
                            cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_pool_resident_kernel<T, CH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  gather_pool_resident_kernel<T, CH><<<dim3(slices, groups), warps * 32, smem, stream>>>(
      static_cast<const T*>(table), nbrs, weights, out, b, k, d, limit, rows_per_group);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_resident_ch(int chunks, const void* table, const int* nbrs,
                               const float* weights, float* out, int b, int k, int d,
                               int limit, int slices, int groups, int rows_per_group,
                               int warps, int smem, cudaStream_t s) {
  switch (chunks) {
    case 1: return launch_resident<T, 1>(table, nbrs, weights, out, b, k, d, limit, slices,
                                         groups, rows_per_group, warps, smem, s);
    case 2: return launch_resident<T, 2>(table, nbrs, weights, out, b, k, d, limit, slices,
                                         groups, rows_per_group, warps, smem, s);
    case 4: return launch_resident<T, 4>(table, nbrs, weights, out, b, k, d, limit, slices,
                                         groups, rows_per_group, warps, smem, s);
    default: return cudaErrorInvalidValue;
  }
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

// Route "resident": the tiling of ops/pool.py:plan (chunks = CH in {1, 2, 4},
// slices x groups blocks of 32 * warps threads, smem bytes of dynamic shared
// memory). Requires d * element size a multiple of 16 bytes and a 16-byte
// aligned table. Returns the launch's cudaError_t.
extern "C" int gather_pool_resident_launch(const void* table, int table_is_bf16,
                                           const int* nbrs, const float* weights, float* out,
                                           int b, int k, int d, int limit, int chunks,
                                           int slices, int groups, int rows_per_group,
                                           int warps, int smem, void* stream) {
  if (b == 0 || d == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      table_is_bf16
          ? launch_resident_ch<uint16_t>(chunks, table, nbrs, weights, out, b, k, d, limit,
                                         slices, groups, rows_per_group, warps, smem, s)
          : launch_resident_ch<float>(chunks, table, nbrs, weights, out, b, k, d, limit,
                                      slices, groups, rows_per_group, warps, smem, s);
  return static_cast<int>(err);
}

extern "C" const char* gather_pool_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
