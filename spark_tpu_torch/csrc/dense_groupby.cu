// Dense group-by sums for Hopper (sm_90a): exact per-slot sums of N rows
// into a dense domain of slots, the hot loop of the direct aggregate path
// (spark_tpu_torch/execution/aggregate.py direct_update).
//
// Replaces the two Pallas TPU kernels of
// spark_tpu/execution/pallas_groupby.py:
//   dense_sums_smem   <- _small_kernel    (:93; one-hot [T, D] tile on the
//                                          MXU, domains <= 512, int and
//                                          float rows)
//   dense_sums_global <- _factored_kernel (:162; Kronecker-factored
//                                          one-hot, 512 < domain <= 2^20,
//                                          int rows only)
// The limbs, bf16 one-hots and f32 hi/lo pairs of those kernels are MXU
// workarounds. Here an int64 value is added whole: unsigned 64-bit adds
// wrap mod 2^64, so integer sums are exact in any order and equal the
// reference bit for bit. Float64 rows add in float64.
//
// What bounds them on an H100: the bytes read, 4 bytes of int32 idx per
// row plus 8 bytes per kept value (idx in [0, domain)), against 3.35 TB/s;
// the outputs are tiny. A value costs at most a few instructions, so the
// kernels are built to keep many 16-byte loads in flight and to put as
// little as possible between a load and its add.
//
// dense_sums_smem has two variants; the wrapper's planner
// (execution/dense_groupby.py plan_launches) picks one by domain and cuts
// the rows into launches whose shared memory fits 227 KB:
//  - private (domain <= 48 on the main path; built up to 64): one warp per
//    value row, or per part of a row. Each thread's table is a column of
//    shared memory, [slot * blockDim + tid], so a value is one shared
//    load, a 64-bit add and one shared store, with no bank conflict, no
//    atomic and no warp vote. The warps of a block read the same int32 idx
//    tile, which they share through L1.
//  - shared (48 < domain <= 512): per-thread columns no longer fit, and a
//    warp's 32 lanes seldom share a slot, so each warp keeps a [rows,
//    domain] table and adds ints with shared atomics (two native 32-bit
//    adds with the carry passed on: a 64-bit one is a CAS loop). Float
//    rows group a warp's lanes by slot (__match_any_sync) and the lowest
//    lane of each group adds its group's values in lane order with a plain
//    store, so the order is fixed.
// Every variant loads a lane's values as 16-byte pairs, kUnroll pairs per
// row in flight, and loads nothing for a pair whose two rows are dropped.
// At the end a block reduces its tables in a fixed order, adds each int
// slot to the output with one global 64-bit atomic, and writes its float
// sums to a [grid, float rows, domain] scratch that a second kernel
// (dense_sums_combine_kernel) sums in block order. Float sums therefore
// repeat bit for bit between runs on one card.
//
// dense_sums_global adds each row's values with 64-bit atomics straight
// into the [rows, domain] output, which the wrapper zero-fills: tables of
// up to 2^20 slots do not fit in shared memory, and large domains spread
// the atomics over many addresses.
//
// Each entry point returns cudaGetLastError() after its last launch (and
// stops at the first that fails); argument errors return negative codes.
// The wrapper allocates every buffer and launches on its stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kMaxRows = 32;          // row pointers in one launch
constexpr int kPrivateDomain = 64;    // private variant: largest domain
constexpr int kSharedDomain = 512;    // shared variant: largest domain
constexpr int kPrivateThreads = 512;  // private: most threads
constexpr int kSharedThreads = 128;   // shared: threads per block
constexpr int kThreads = 256;         // dense_sums_global
constexpr int kUnroll = 4;            // 16-byte pairs in flight per row
constexpr int kSharedUnroll = 8;      // the same, shared variant
constexpr size_t kMaxSmemBytes = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

enum Variant { kPrivate = 0, kShared = 1 };

struct Rows {
  const u64* p[kMaxRows];
};

template <bool kFloat>
__device__ __forceinline__ u64 add(u64 a, u64 b) {
  if constexpr (kFloat) {
    return static_cast<u64>(__double_as_longlong(
        __longlong_as_double(static_cast<long long>(a)) +
        __longlong_as_double(static_cast<long long>(b))));
  } else {
    return a + b;
  }
}

// Sum over the warp by butterfly: every lane ends with the same value,
// formed in the same order on every run.
template <bool kFloat>
__device__ __forceinline__ u64 warp_sum(u64 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = add<kFloat>(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int keep(int k, int domain) {
  return static_cast<unsigned>(k) < static_cast<unsigned>(domain) ? k : -1;
}

// Adds x into slot k (-1: dropped) of the thread's column.
template <bool kFloat>
__device__ __forceinline__ void put(u64* col, int stride, int k, u64 x) {
  if (k >= 0) {
    u64* c = col + static_cast<size_t>(k) * stride;
    *c = add<kFloat>(*c, x);
  }
}

// One warp sums value row `vals` over its part of every tile of the
// block into each thread's shared-memory column `col` (stride
// blockDim.x), then writes the warp's totals to wsum[0, domain).
template <bool kFloat>
__device__ __forceinline__ void private_row(
    const int* __restrict__ idx, long long n, int domain,
    const u64* __restrict__ vals, int part, int parts, bool tail,
    u64* __restrict__ col, u64* __restrict__ wsum) {
  const int lane = threadIdx.x & 31;
  const int stride = blockDim.x;
  const int2* idx2 = reinterpret_cast<const int2*>(idx);
  const ulonglong2* vals2 = reinterpret_cast<const ulonglong2*>(vals);
  const long long npairs = n >> 1;
  const long long tile = static_cast<long long>(parts) * 32 * kUnroll;
  for (long long base = static_cast<long long>(blockIdx.x) * tile + part * 32 * kUnroll;
       base < npairs; base += static_cast<long long>(gridDim.x) * tile) {
    int2 k[kUnroll];
    ulonglong2 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long p = base + u * 32 + lane;
      k[u] = p < npairs ? __ldg(idx2 + p) : make_int2(-1, -1);
      k[u].x = keep(k[u].x, domain);
      k[u].y = keep(k[u].y, domain);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long p = base + u * 32 + lane;
      v[u] = (k[u].x >= 0 || k[u].y >= 0) ? __ldcs(vals2 + p) : make_ulonglong2(0ull, 0ull);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      put<kFloat>(col, stride, k[u].x, v[u].x);
      put<kFloat>(col, stride, k[u].y, v[u].y);
    }
  }
  if (tail && lane == 0) put<kFloat>(col, stride, keep(idx[n - 1], domain), vals[n - 1]);

  for (int s = 0; s < domain; ++s) {
    const u64 t = warp_sum<kFloat>(col[static_cast<size_t>(s) * stride]);
    if (lane == 0) wsum[s] = t;
  }
}

// private variant. The block holds n_rows * parts warps; warp w sums row
// w / parts (ints first, then floats) over part w % parts of each tile.
__global__ void __launch_bounds__(kPrivateThreads)
dense_sums_private_kernel(const int* __restrict__ idx, long long n, int domain,
                          Rows rows, int n_int, int parts,
                          u64* __restrict__ int_out, double* __restrict__ partial) {
  extern __shared__ u64 smem[];
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_rows = n_warps / parts;
  const int row = warp / parts, part = warp % parts;
  u64* wsum = smem;                                            // [warps][domain]
  u64* col = smem + static_cast<size_t>(n_warps) * domain + threadIdx.x;
  for (int s = 0; s < domain; ++s) col[static_cast<size_t>(s) * blockDim.x] = 0ull;
  const bool tail = (n & 1) && blockIdx.x == 0 && part == 0;
  if (row < n_int) {
    private_row<false>(idx, n, domain, rows.p[row], part, parts, tail, col,
                       wsum + static_cast<size_t>(warp) * domain);
  } else {
    private_row<true>(idx, n, domain, rows.p[row], part, parts, tail, col,
                      wsum + static_cast<size_t>(warp) * domain);
  }
  __syncthreads();

  const int n_float = n_rows - n_int;
  for (int t = threadIdx.x; t < n_rows * domain; t += blockDim.x) {
    const int r = t / domain, s = t - r * domain;
    const u64* w = wsum + static_cast<size_t>(r) * parts * domain + s;
    if (r < n_int) {
      u64 x = w[0];
      for (int q = 1; q < parts; ++q) x += w[static_cast<size_t>(q) * domain];
      if (x != 0ull) atomicAdd(int_out + static_cast<size_t>(r) * domain + s, x);
    } else {
      u64 x = w[0];
      for (int q = 1; q < parts; ++q) x = add<true>(x, w[static_cast<size_t>(q) * domain]);
      partial[(static_cast<size_t>(blockIdx.x) * n_float + (r - n_int)) * domain + s] =
          __longlong_as_double(static_cast<long long>(x));
    }
  }
}

// Sum of v over the lanes of `peers` in ascending lane order, complete in
// the lowest lane of the group. Every lane of the warp calls it.
__device__ __forceinline__ double group_sum(unsigned peers, int lane, double v) {
  unsigned rest = (__ffs(peers) - 1) == lane ? (peers & (peers - 1)) : 0u;
  double s = v;
  while (__any_sync(kFull, rest != 0u)) {
    const int src = rest ? __ffs(rest) - 1 : lane;
    const double t = __shfl_sync(kFull, v, src);
    if (rest) {
      s += t;
      rest &= rest - 1;
    }
  }
  return s;
}

// Adds x to *c mod 2^64 with two native 32-bit shared atomics (a 64-bit
// shared atomicAdd compiles to a CAS loop on sm_90a): the carry out of the
// low word is read from the old value it returns, so every add's carry
// reaches the high word exactly once, in any interleaving.
__device__ __forceinline__ void shared_add_u64(u64* c, u64 x) {
  unsigned* w = reinterpret_cast<unsigned*>(c);
  const unsigned lo = static_cast<unsigned>(x);
  const unsigned old = atomicAdd(w, lo);
  const unsigned hi = static_cast<unsigned>(x >> 32) + (old + lo < old ? 1u : 0u);
  if (hi != 0u) atomicAdd(w + 1, hi);
}

// One float value per lane into the warp's table row `tab`.
__device__ __forceinline__ void put_float(u64* tab, int k, unsigned peers, int lane, u64 bits) {
  const double x = k >= 0 ? __longlong_as_double(static_cast<long long>(bits)) : 0.0;
  const double s = group_sum(peers, lane, x);
  if (k >= 0 && (__ffs(peers) - 1) == lane) {
    double* c = reinterpret_cast<double*>(tab + k);
    *c += s;
  }
  __syncwarp();
}

// shared variant: each warp keeps a [n_rows, domain] table; a warp sums
// every row over its own pairs of each tile.
__global__ void __launch_bounds__(kSharedThreads)
dense_sums_shared_kernel(const int* __restrict__ idx, long long n, int domain,
                         Rows rows, int n_int, int n_rows,
                         u64* __restrict__ int_out, double* __restrict__ partial) {
  extern __shared__ u64 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int width = n_rows * domain;
  u64* tab = smem + static_cast<size_t>(warp) * width;
  for (int t = threadIdx.x; t < n_warps * width; t += blockDim.x) smem[t] = 0ull;
  __syncthreads();

  const bool floats = n_int < n_rows;
  const int2* idx2 = reinterpret_cast<const int2*>(idx);
  const long long npairs = n >> 1;
  const long long tile = static_cast<long long>(n_warps) * 32 * kSharedUnroll;
  for (long long base = static_cast<long long>(blockIdx.x) * tile + warp * 32 * kSharedUnroll;
       base < npairs; base += static_cast<long long>(gridDim.x) * tile) {
    int2 k[kSharedUnroll];
    unsigned px[kSharedUnroll] = {}, py[kSharedUnroll] = {};
#pragma unroll
    for (int u = 0; u < kSharedUnroll; ++u) {
      const long long p = base + u * 32 + lane;
      k[u] = p < npairs ? __ldg(idx2 + p) : make_int2(-1, -1);
      k[u].x = keep(k[u].x, domain);
      k[u].y = keep(k[u].y, domain);
      if (floats) {
        px[u] = __match_any_sync(kFull, k[u].x);
        py[u] = __match_any_sync(kFull, k[u].y);
      }
    }
    for (int r = 0; r < n_rows; ++r) {
      const ulonglong2* vals2 = reinterpret_cast<const ulonglong2*>(rows.p[r]);
      ulonglong2 v[kSharedUnroll];
#pragma unroll
      for (int u = 0; u < kSharedUnroll; ++u) {
        const long long p = base + u * 32 + lane;
        v[u] = (k[u].x >= 0 || k[u].y >= 0) ? __ldcs(vals2 + p)
                                             : make_ulonglong2(0ull, 0ull);
      }
      u64* t = tab + static_cast<size_t>(r) * domain;
      if (r < n_int) {
#pragma unroll
        for (int u = 0; u < kSharedUnroll; ++u) {
          if (k[u].x >= 0) shared_add_u64(t + k[u].x, v[u].x);
          if (k[u].y >= 0) shared_add_u64(t + k[u].y, v[u].y);
        }
      } else {
#pragma unroll
        for (int u = 0; u < kSharedUnroll; ++u) {
          put_float(t, k[u].x, px[u], lane, v[u].x);
          put_float(t, k[u].y, py[u], lane, v[u].y);
        }
      }
    }
  }
  if ((n & 1) && blockIdx.x == 0 && warp == 0 && lane == 0) {
    const int k = keep(idx[n - 1], domain);
    if (k >= 0) {
      for (int r = 0; r < n_rows; ++r) {
        u64* c = tab + static_cast<size_t>(r) * domain + k;
        *c = r < n_int ? add<false>(*c, rows.p[r][n - 1]) : add<true>(*c, rows.p[r][n - 1]);
      }
    }
  }
  __syncthreads();

  const int n_float = n_rows - n_int;
  for (int t = threadIdx.x; t < width; t += blockDim.x) {
    const int r = t / domain, s = t - r * domain;
    if (r < n_int) {
      u64 x = smem[t];
      for (int w = 1; w < n_warps; ++w) x += smem[static_cast<size_t>(w) * width + t];
      if (x != 0ull) atomicAdd(int_out + t, x);
    } else {
      u64 x = smem[t];
      for (int w = 1; w < n_warps; ++w) x = add<true>(x, smem[static_cast<size_t>(w) * width + t]);
      partial[(static_cast<size_t>(blockIdx.x) * n_float + (r - n_int)) * domain + s] =
          __longlong_as_double(static_cast<long long>(x));
    }
  }
}

// out[t] = sum over blocks b, in order, of partial[b, t].
__global__ void dense_sums_combine_kernel(const double* __restrict__ partial, int blocks,
                                          int width, double* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= width) return;
  double s = 0.0;
#pragma unroll 8
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<size_t>(b) * width + t];
  out[t] = s;
}

__global__ void __launch_bounds__(kThreads)
dense_sums_global_kernel(const int* __restrict__ idx, long long n, int domain,
                         Rows ints, int n_int, u64* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int k = idx[i];
    if (k < 0 || k >= domain) continue;
    for (int r = 0; r < n_int; ++r) {
      atomicAdd(&out[static_cast<size_t>(r) * domain + k], ints.p[r][i]);
    }
  }
}

// Blocks to launch: enough to cover `work` units, at most what the SMs
// hold at once (from the occupancy API), at least one.
int grid_for(const void* kernel, int threads, size_t smem, long long work) {
  int dev = 0;
  cudaGetDevice(&dev);
  int sms = 1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (per_sm < 1) per_sm = 1;
  const long long cap = static_cast<long long>(per_sm) * sms;
  const long long g = work < cap ? work : cap;
  return static_cast<int>(g < 1 ? 1 : g);
}

}  // namespace

// Shared-memory bytes of one block of a dense_sums_smem launch, or 0 when
// the arguments are outside what the variant takes.
extern "C" long long dense_sums_smem_bytes(int variant, int domain, int n_rows, int warps) {
  if (domain < 1 || n_rows < 1 || n_rows > kMaxRows || warps < 1) return 0;
  const long long d = domain;
  switch (variant) {
    case kPrivate:
      if (domain > kPrivateDomain || warps * 32 > kPrivateThreads || warps % n_rows) return 0;
      return warps * d * 8 + static_cast<long long>(warps) * 32 * d * 8;
    case kShared:
      if (domain > kSharedDomain || warps * 32 != kSharedThreads) return 0;
      return warps * static_cast<long long>(n_rows) * d * 8;
    default:
      return 0;
  }
}

// One launch of dense_sums_smem (plus the float combine when there are
// float rows). int_out: [n_int, domain], zero-filled; float_out:
// [n_float, domain], written; scratch: at least blocks * n_float * domain
// doubles for the block partials, the grid is cut to fit scratch_len.
extern "C" int dense_sums_smem(const int* idx, long long n, int domain,
                               const void* const* int_rows, int n_int,
                               const void* const* float_rows, int n_float,
                               int variant, int warps,
                               void* int_out, void* float_out,
                               void* scratch, long long scratch_len, void* stream) {
  if (n < 1) return -1;
  if (n_int < 0 || n_float < 0 || n_int + n_float < 1 || n_int + n_float > kMaxRows) return -2;
  const int n_rows = n_int + n_float;
  const long long smem_ll = dense_sums_smem_bytes(variant, domain, n_rows, warps);
  if (smem_ll < 1 || smem_ll > static_cast<long long>(kMaxSmemBytes)) return -3;
  const size_t smem = static_cast<size_t>(smem_ll);
  Rows rows = {};
  for (int r = 0; r < n_int; ++r) rows.p[r] = static_cast<const u64*>(int_rows[r]);
  for (int r = 0; r < n_float; ++r) rows.p[n_int + r] = static_cast<const u64*>(float_rows[r]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = warps * 32;

  const void* kernel = variant == kPrivate
                           ? reinterpret_cast<const void*>(dense_sums_private_kernel)
                           : reinterpret_cast<const void*>(dense_sums_shared_kernel);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long pairs_per_block =
      variant == kShared ? static_cast<long long>(warps) * 32 * kSharedUnroll
                         : static_cast<long long>(warps / n_rows) * 32 * kUnroll;
  int grid = grid_for(kernel, threads, smem, ((n >> 1) + pairs_per_block - 1) / pairs_per_block);
  const long long width = static_cast<long long>(n_float) * domain;
  if (width > 0) {
    const long long fit = scratch_len / width;
    if (fit < 1) return -4;
    if (grid > fit) grid = static_cast<int>(fit);
  }
  u64* iout = static_cast<u64*>(int_out);
  double* part = static_cast<double*>(scratch);
  if (variant == kShared) {
    dense_sums_shared_kernel<<<grid, threads, smem, st>>>(idx, n, domain, rows, n_int, n_rows,
                                                          iout, part);
  } else {
    dense_sums_private_kernel<<<grid, threads, smem, st>>>(idx, n, domain, rows, n_int,
                                                           warps / n_rows, iout, part);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || width == 0) return static_cast<int>(err);
  const int cw = static_cast<int>(width);
  dense_sums_combine_kernel<<<(cw + 255) / 256, 256, 0, st>>>(part, grid, cw,
                                                              static_cast<double*>(float_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dense_sums_global(const int* idx, long long n, int domain,
                                 const void* const* int_rows, int n_int,
                                 void* int_out, void* stream) {
  if (domain < 1 || n < 1) return -1;
  if (n_int < 1 || n_int > kMaxRows) return -2;
  Rows ir = {};
  for (int r = 0; r < n_int; ++r) ir.p[r] = static_cast<const u64*>(int_rows[r]);
  const int grid = grid_for(reinterpret_cast<const void*>(dense_sums_global_kernel), kThreads, 0,
                            (n + kThreads - 1) / kThreads);
  dense_sums_global_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, n, domain, ir, n_int, static_cast<u64*>(int_out));
  return static_cast<int>(cudaGetLastError());
}
