// Backward of the weighted row gather-pool in the table, as a segment
// reduction over the walk table's transpose, for Hopper (sm_90a), bound
// through ctypes. It uses no atomics: every sum runs in an order fixed by the
// layout, so the result is bitwise the same on every run.
//
// Replaces the table half of the gradient of the TPU kernel
// movie_recommendation_engine_tpu/ops/pallas/pool.py:gather_pool, which JAX
// writes in XLA beside the Pallas forward (gather_pool_ad's _gather_pool_bwd,
// a scatter-add). For the forward out[b] = sum_k w'[b, k] * table[idx[b, k]]
// (w' = w masked to 0 where nbrs < 0 or nbrs >= limit, idx = nbrs clamped
// into [0, limit)) and the f32 cotangent g [B, D] it computes
//
//     d_table[r, :] = sum over valid (b, k) with idx[b, k] == r of w[b, k] * g[b, :]
//
// in f32, written in the table's dtype (bf16 rounds to nearest even, as
// torch's cast); rows r in [limit, N) are 0. Slots of weight 0 add nothing
// and may be left out of the layout (below). The weights' gradient stays with
// gather_pool_bwd.cu.
//
// The layout (ops/pool.py:segment_layout) lists the flat slots b * K + k of
// the valid slots grouped by id, ascending within each id (a stable sort in
// tensor code), and cuts each id's run into chunks of at most `chunk` slots.
// A valid slot has an id in [0, limit) and, where the layout was built with
// the weights, a nonzero weight: the hub residual pads its rows with id 0 and
// weight 0, and those slots, which add 0 * g, would otherwise gather on row 0
// (~186k slots of a 59k-row table, ~5.8k partials that pass 2 sums on one
// warp). Such a layout serves only calls whose weights are 0 wherever its
// weights were; the kernels read only the slots the layout lists. The chunks:
// one int4 (row, start, end, part) per chunk, every id in [0, limit) present
// once or more (an id without slots as one empty chunk). part is -1 where the
// chunk is its row's only one, else the index of the f32 partial sum it
// writes. For every id of more than one chunk, `splits` holds (row, first
// part, end part). The chunk plan is pass 0 below (three segment_plan_*
// kernels): it writes the counts (C, S, P) to device memory and the passes
// read them there, so building a layout and using it never waits on the
// host; the passes' grids are sized by bounds of C and S known from the
// shapes (C <= limit + B * K / chunk), and their extra warps leave at once.
//
// Pass 1 (segment_sum_kernel), one warp per chunk, eight a block: the warp
// stages its chunk's (g row b = slot / K, weight) pairs in shared memory, then
// each lane owns 16 bytes (4 f32 columns) of the row per pass and sums
// w * g[b] over the chunk's slots in slot order, from 0, with a separate f32
// multiply and add (__fmul_rn, __fadd_rn, so nvcc cannot contract them into
// an FMA), the loads of four slots in flight before their adds. A row of one
// chunk is written straight to d_table; a chunk of a longer row writes its
// partial. The warps past the last chunk write the zero rows [limit, N), so
// the kernel writes every row of d_table and nothing has to zero it first.
// Pass 2 (combine_kernel), one warp per split row: its partials summed from 0
// in chunk order, written to d_table. ops/pool.py:gather_pool_bwd_segment_plain
// sums in exactly this order, and the two are bitwise equal.
//
// What bounds it on an H100: L2 reads. Each valid slot reads its row of g
// (D = 256 f32: 1 KB) from L2, where g (4 MB at the training step's layer 0)
// stays: ~191 MB for layer 0's ~186k valid slots, as the forward's direct
// route reads its gathered rows, against a compulsory ~7.7 MB. The atomic
// kernel it replaces issues one 16-byte RED per valid slot and 4 columns
// instead, and the L2's atomic rate bounds that. The ids are skewed (the most
// frequent 256 ids hold about a third of the valid slots, the largest ~1.7k
// slots), which is why the chunks are fixed-size: a warp per whole row would
// leave the card waiting on the hub rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;

// torch's float -> bfloat16 cast: round to nearest even, NaN to 0x7fc0.
__device__ __forceinline__ uint32_t bf16_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

// VW (4 or 1) f32 values: one 16-byte load, or one scalar load.
template <int VW>
__device__ __forceinline__ void load(const float* p, float (&v)[VW]) {
  if constexpr (VW == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    v[0] = __ldg(p);
  }
}

// VW f32 sums at column `col`: to partial row `part` when part >= 0, else to
// d_table row `row` in the table's dtype.
template <int VW, bool BF16>
__device__ __forceinline__ void store(void* d_table, float* partials, int row, int part, int d,
                                      int col, const float (&a)[VW]) {
  if (part >= 0) {
    float* p = partials + static_cast<int64_t>(part) * d + col;
    if constexpr (VW == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
    } else {
      *p = a[0];
    }
  } else if constexpr (BF16) {
    uint16_t* p = static_cast<uint16_t*>(d_table) + static_cast<int64_t>(row) * d + col;
    if constexpr (VW == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(bf16_bits(a[0]) | bf16_bits(a[1]) << 16,
                                                bf16_bits(a[2]) | bf16_bits(a[3]) << 16);
    } else {
      *p = static_cast<uint16_t>(bf16_bits(a[0]));
    }
  } else {
    float* p = static_cast<float*>(d_table) + static_cast<int64_t>(row) * d + col;
    if constexpr (VW == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
    } else {
      *p = a[0];
    }
  }
}

template <int VW>
__device__ __forceinline__ void add_product(float (&acc)[VW], float w, const float (&x)[VW]) {
#pragma unroll
  for (int i = 0; i < VW; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(w, x[i]));
}

// Pass 1. chunks [max_chunks] int4 (row, start, end, part), of which the
// first totals[0] are the plan's; slots index the flat [B * K] weights; g
// [B, d] f32. Warps max_chunks.. write rows limit..n-1; the warps between
// the plan's chunks and max_chunks have nothing to do.
template <int VW, bool BF16>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_kernel(const int* __restrict__ slots, const int4* __restrict__ chunks,
                   const int* __restrict__ totals, const float* __restrict__ weights,
                   const float* __restrict__ g, void* __restrict__ d_table,
                   float* __restrict__ partials, int max_chunks, int limit, int n, int k, int d,
                   int chunk) {
  extern __shared__ unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarpsPerBlock + warp;
  int row, start = 0, len = 0, part = -1;
  if (c < totals[0]) {
    const int4 ch = chunks[c];  // one address for the whole warp
    row = ch.x;
    start = ch.y;
    len = ch.z - ch.y;
    part = ch.w;
  } else {
    row = c < max_chunks ? n : limit + (c - max_chunks);
    if (row >= n) return;  // the whole warp leaves; only __syncwarp is used below
  }
  int* g_rows = reinterpret_cast<int*>(smem) + warp * chunk;
  float* ws = reinterpret_cast<float*>(smem + sizeof(int) * kWarpsPerBlock * chunk) + warp * chunk;
  for (int j = lane; j < len; j += 32) {
    const int s = slots[start + j];
    g_rows[j] = s / k;
    ws[j] = weights[s];
  }
  __syncwarp();

  const int nvec = d / VW;
  for (int v = lane; v < nvec; v += 32) {
    const int col = v * VW;
    float acc[VW];
#pragma unroll
    for (int i = 0; i < VW; ++i) acc[i] = 0.f;
    int j = 0;
    for (; j + kUnroll <= len; j += kUnroll) {
      float x[kUnroll][VW];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        load<VW>(g + static_cast<int64_t>(g_rows[j + u]) * d + col, x[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add_product<VW>(acc, ws[j + u], x[u]);
    }
    for (; j < len; ++j) {
      float x[VW];
      load<VW>(g + static_cast<int64_t>(g_rows[j]) * d + col, x);
      add_product<VW>(acc, ws[j], x);
    }
    store<VW, BF16>(d_table, partials, row, part, d, col, acc);
  }
}

// Pass 2. splits [max_splits, 3] int32 (row, first part, end part), of
// which the first totals[1] are the plan's; partials [parts, d] f32 from
// pass 1.
template <int VW, bool BF16>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
combine_kernel(const int* __restrict__ splits, const int* __restrict__ totals,
               const float* __restrict__ partials, void* __restrict__ d_table, int d) {
  const int s = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (s >= totals[1]) return;
  const int lane = threadIdx.x & 31;
  const int row = splits[3 * s], p0 = splits[3 * s + 1], p1 = splits[3 * s + 2];
  const int nvec = d / VW;
  for (int v = lane; v < nvec; v += 32) {
    const int col = v * VW;
    float acc[VW];
#pragma unroll
    for (int i = 0; i < VW; ++i) acc[i] = 0.f;
    int p = p0;
    for (; p + kUnroll <= p1; p += kUnroll) {
      float x[kUnroll][VW];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        load<VW>(partials + static_cast<int64_t>(p + u) * d + col, x[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < VW; ++i) acc[i] = __fadd_rn(acc[i], x[u][i]);
      }
    }
    for (; p < p1; ++p) {
      float x[VW];
      load<VW>(partials + static_cast<int64_t>(p) * d + col, x);
#pragma unroll
      for (int i = 0; i < VW; ++i) acc[i] = __fadd_rn(acc[i], x[i]);
    }
    store<VW, BF16>(d_table, nullptr, row, -1, d, col, acc);
  }
}

// The chunk plan (pass 0), over tiles of 1024 consecutive ids, one block a
// tile and one id a thread, in three launches. (a) segment_plan_tile_kernel:
// each thread counts its id's chunks (and, for an id of more than one chunk,
// its partials and one split row), and each block sums its tile's. (b)
// segment_plan_offsets_kernel, one block: an exclusive scan of the tiles'
// sums gives each tile's offsets, in place, and the totals (C, S, P). (c)
// segment_plan_write_kernel: each block scans its tile again from its offset,
// and each thread writes its id's chunks (row, start, end, part) and split
// (row, first part, end part); neighbouring threads write neighbouring
// chunks. Ids in order, chunks in order within an id: the plan of
// ops/pool.py:segment_plan_plain, without reading anything back to the host.
// A block a tile, and not one block for all: one block walking a bag's
// 819,200 compact ids (ops/pool.py:compact_rows) tile by tile takes ~0.9 ms
// on an H100.
constexpr int kPlanThreads = 1024;

__device__ __forceinline__ int chunks_of(int count, int chunk) {
  return count > chunk ? (count + chunk - 1) / chunk : 1;
}

__device__ __forceinline__ int3 operator+(int3 a, int3 b) {
  return make_int3(a.x + b.x, a.y + b.y, a.z + b.z);
}

// Inclusive scan of v over the warp's lanes.
__device__ __forceinline__ int3 warp_scan(int3 v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int3 up = make_int3(__shfl_up_sync(0xffffffffu, v.x, off),
                              __shfl_up_sync(0xffffffffu, v.y, off),
                              __shfl_up_sync(0xffffffffu, v.z, off));
    if (lane >= off) v = v + up;
  }
  return v;
}

__device__ __forceinline__ int3 operator-(int3 a, int3 b) {
  return make_int3(a.x - b.x, a.y - b.y, a.z - b.z);
}

// Id r's (chunks, partials, split rows) and its slots [start, end); 0 past limit.
__device__ __forceinline__ int3 plan_counts(const int* __restrict__ row_ptr, int r, int limit,
                                            int chunk, int& start, int& end) {
  start = end = 0;
  int m = 0;
  if (r < limit) {
    start = row_ptr[r];
    end = row_ptr[r + 1];
    m = chunks_of(end - start, chunk);
  }
  return make_int3(m, m > 1 ? m : 0, m > 1 ? 1 : 0);
}

// Inclusive scan of v over the block's kPlanThreads threads; `total` gets the
// block's sum. Every thread of the block calls it.
__device__ __forceinline__ int3 block_scan(int3 v, int3* warp_sums, int3& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int3 inc = warp_scan(v, lane);
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) warp_sums[lane] = warp_scan(warp_sums[lane], lane);
  __syncthreads();
  const int3 at = (warp ? warp_sums[warp - 1] : make_int3(0, 0, 0)) + inc;
  total = warp_sums[kPlanThreads / 32 - 1];
  __syncthreads();  // warp_sums is rewritten by the next scan
  return at;
}

__global__ void __launch_bounds__(kPlanThreads)
segment_plan_tile_kernel(const int* __restrict__ row_ptr, int3* __restrict__ tile_sums,
                         int limit, int chunk) {
  __shared__ int3 warp_sums[kPlanThreads / 32];
  int start, end;
  int3 total;
  block_scan(plan_counts(row_ptr, blockIdx.x * kPlanThreads + threadIdx.x, limit, chunk, start,
                         end),
             warp_sums, total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kPlanThreads)
segment_plan_offsets_kernel(int3* __restrict__ tile_sums, int tiles, int* __restrict__ totals) {
  __shared__ int3 warp_sums[kPlanThreads / 32];
  int3 before = make_int3(0, 0, 0);
  for (int base = 0; base < tiles; base += kPlanThreads) {
    const int t = base + static_cast<int>(threadIdx.x);
    const int3 mine = t < tiles ? tile_sums[t] : make_int3(0, 0, 0);
    int3 total;
    const int3 at = block_scan(mine, warp_sums, total);
    if (t < tiles) tile_sums[t] = before + at - mine;  // the tiles before t
    before = before + total;
  }
  if (threadIdx.x == 0) {
    totals[0] = before.x;
    totals[1] = before.z;
    totals[2] = before.y;
  }
}

__global__ void __launch_bounds__(kPlanThreads)
segment_plan_write_kernel(const int* __restrict__ row_ptr, const int3* __restrict__ tile_offsets,
                          int4* __restrict__ chunks, int* __restrict__ splits, int limit,
                          int chunk) {
  __shared__ int3 warp_sums[kPlanThreads / 32];
  const int r = blockIdx.x * kPlanThreads + threadIdx.x;
  int start, end;
  int3 total;
  const int3 mine = plan_counts(row_ptr, r, limit, chunk, start, end);
  const int3 at = tile_offsets[blockIdx.x] + block_scan(mine, warp_sums, total);
  const int m = mine.x;
  const int c = at.x - mine.x, p = at.y - mine.y, s = at.z - mine.z;
  for (int j = 0; j < m; ++j) {
    const int a = start + j * chunk;
    chunks[c + j] = make_int4(r, a, min(a + chunk, end), m > 1 ? p + j : -1);
  }
  if (m > 1) {
    splits[3 * s] = r;
    splits[3 * s + 1] = p;
    splits[3 * s + 2] = p + m;
  }
}

template <int VW, bool BF16>
cudaError_t launch(const int* slots, const int* chunks, int max_chunks, const int* splits,
                   int max_splits, const int* totals, const float* weights, const float* g,
                   void* d_table, float* partials, int limit, int n, int k, int d, int chunk,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kWarpsPerBlock) * chunk * (sizeof(int) + sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_sum_kernel<VW, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t warps = static_cast<int64_t>(max_chunks) + (n - limit);
  const dim3 grid(static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  segment_sum_kernel<VW, BF16><<<grid, kWarpsPerBlock * 32, smem, stream>>>(
      slots, reinterpret_cast<const int4*>(chunks), totals, weights, g, d_table, partials,
      max_chunks, limit, n, k, d, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || max_splits == 0) return err;
  const dim3 grid2((max_splits + kWarpsPerBlock - 1) / kWarpsPerBlock);
  combine_kernel<VW, BF16><<<grid2, kWarpsPerBlock * 32, 0, stream>>>(splits, totals, partials,
                                                                      d_table, d);
  return cudaGetLastError();
}

}  // namespace

// The layout of ops/pool.py:segment_layout: slots [B * K] int32, chunks
// [max_chunks, 4] int32 (16-byte aligned), splits [max_splits, 3] int32,
// totals [3] int32 (C, S, P); weights [B, K] f32; g [B, d] f32; d_table
// [n, d] bf16 (table_is_bf16 = 1) or f32, every row written here; partials
// [at least P, d] f32 scratch. vectorized = 1 requires d to be a multiple of
// 4 and g, d_table and partials 16-byte aligned. Returns the first failing
// launch's cudaError_t.
extern "C" int gather_pool_bwd_segment_launch(const int* slots, const int* chunks,
                                              int max_chunks, const int* splits, int max_splits,
                                              const int* totals, const float* weights,
                                              const float* g, void* d_table, int table_is_bf16,
                                              float* partials, int limit, int n, int k, int d,
                                              int chunk, int vectorized, void* stream) {
  if (n == 0 || d == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto launcher) {
    return launcher(slots, chunks, max_chunks, splits, max_splits, totals, weights, g, d_table,
                    partials, limit, n, k, d, chunk, s);
  };
  cudaError_t err;
  if (table_is_bf16) {
    err = vectorized ? run(launch<4, true>) : run(launch<1, true>);
  } else {
    err = vectorized ? run(launch<4, false>) : run(launch<1, false>);
  }
  return static_cast<int>(err);
}

// The chunk plan of row_ptr [limit + 1] (ops/pool.py:segment_plan_plain),
// written into chunks, splits and totals (C, S, P) in three launches;
// tile_sums is int32 scratch of 3 * ceil(limit / 1024).
extern "C" int gather_pool_bwd_segment_plan_launch(const int* row_ptr, int* chunks, int* splits,
                                                   int* totals, int* tile_sums, int limit,
                                                   int chunk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (limit + kPlanThreads - 1) / kPlanThreads;
  int3* sums = reinterpret_cast<int3*>(tile_sums);
  segment_plan_tile_kernel<<<tiles, kPlanThreads, 0, s>>>(row_ptr, sums, limit, chunk);
  segment_plan_offsets_kernel<<<1, kPlanThreads, 0, s>>>(sums, tiles, totals);
  segment_plan_write_kernel<<<tiles, kPlanThreads, 0, s>>>(
      row_ptr, sums, reinterpret_cast<int4*>(chunks), splits, limit, chunk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gather_pool_bwd_segment_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
