// Masked cosine top-1 kernels for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of the JAX package:
//   reuse_top1   <- repro/kernels/sim_topk.py::reuse_top1 (_reuse_top1_kernel,
//                   _gather_rows), the arbitrary (Q, C) id-matrix route: raw
//                   slot-table candidates, unsorted, with duplicates, -1 = empty
//                   slot; a tie goes to the lowest row id.  (The bucket-major
//                   route the fused query calls is reuse_probed.cu.)
//   gather_top1  <- repro/kernels/sim_topk.py::gather_top1 (_gather_top1_kernel):
//                   sorted, unique, front-packed candidates; a tie goes to the
//                   first position.
//   sim_top1     <- repro/kernels/sim_topk.py::sim_top1 (_sim_top1_kernel):
//                   brute-force top-1 over a whole (N, D) store, f32 or bf16,
//                   rows at or after n_valid masked; a tie goes to the first
//                   index.  Design notes at its kernel below.
//
// Every (query, row) score in this file, in reuse_probed.cu and in the plain
// versions' tests is one fmaf chain over D, ascending from 0, never split
// across threads: equal rows and duplicate ids then score bit-equal whichever
// kernel, block or thread scores them, and the tie rules hold exactly.  Plain
// fp32 FMA on the CUDA cores, no TF32: winners must not flip against the
// reference's fp32 arithmetic.  Blocks merge their bests through the packed
// 64-bit atomicMax of top1_pack.cuh, which is order-free.
#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "cp_async.cuh"
#include "top1_pack.cuh"

namespace {

// --------------------------------------------------- gather_top1, reuse_top1
// What bounds it: each candidate costs one D-float row gathered from the
// store (random rows) for 2*D fp32 FLOP.  At B=32 queries x C=16384
// candidates x D=64 that is ~100 MB of row reads for 50 MFLOP; the bound
// counts each distinct row once from HBM (8 us), but a 100k x 64 store (25.6
// MB) stays resident in the 50 MB L2, so the rows come from L2 and the
// kernel is bound by how many row copies are in flight, not by bytes.
//
// Design:
//   * The grid is (query, candidate split) (gather_plan in sim_topk.py: at
//     least 2 x 132 blocks where B * C allows, 512-2048 candidates a block),
//     so a batch of 32, or one scalar query, still spreads over the SMs.
//   * A warp takes groups of 32 candidates (a lane each; fewer where D is so
//     wide that two stages of 32 rows do not fit, gather_plan).  Its ids are
//     read coalesced one group ahead of use; the warp copies the rows into
//     shared memory with cp.async, 16 lanes per 256-byte row (16-byte copies;
//     4-byte ones where D % 4 != 0 or q or the store is off a 16-byte
//     boundary), double-buffered: group k + 1's rows are in flight while
//     group k is scored.  The row stride is D + 4 floats (16-byte copies:
//     a quarter-warp's float4 reads cover the 32 banks) or D | 1 (4-byte
//     copies: odd, so scalar reads are conflict-free).
//   * Each lane runs its own row's fmaf chain against the query, which sits
//     in shared memory and is read as a broadcast, and keeps a lexicographic
//     (max score, min key) best; the warp reduces it with shuffles and lane
//     0 merges it into the query's packed key.  The key is the candidate
//     position (gather_top1) or the row id (reuse_top1); a finishing pass
//     (unpack_kernel) turns a position into ids[row, pos].
//   * The store is addressed as (num_pages, page_size, D): a slot id maps to
//     page min(id / page_size, num_pages - 1), offset id % page_size, as the
//     Pallas kernel does.  A flat (N, D) store is passed as page_size = 1,
//     num_pages = N, which gives jnp.take's mode="clip" row min(id, N - 1).
constexpr int kMaxGatherThreads = 128;

// shared-memory row stride of the staged rows (see above)
inline __host__ __device__ int gather_ld(int D, int bytes) {
  return bytes == 16 ? D + 4 : (D | 1);
}

template <bool kByPosition, int kBytes>
__global__ void __launch_bounds__(kMaxGatherThreads)
gather_kernel(const float* __restrict__ q, const int* __restrict__ ids,
              const float* __restrict__ store, unsigned long long* __restrict__ keys, int C,
              int D, int chunk, int group, int num_pages, int page_size) {
  extern __shared__ float4 smem4[];
  constexpr int kW = kBytes / 4;
  float* sm = reinterpret_cast<float*>(smem4);
  const int ld = gather_ld(D, kBytes), qd = (D + 3) & ~3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  float* q_sh = sm;                                   // [qd] the query row
  float* ring = sm + qd + warp * 2 * group * ld;      // this warp's [2][group][ld] rows

  const int row = blockIdx.x;
  const int c0 = blockIdx.y * chunk, c1 = min(c0 + chunk, C);
  const float* qr = q + static_cast<size_t>(row) * D;
  for (int e = threadIdx.x; e < D; e += blockDim.x) q_sh[e] = qr[e];
  __syncthreads();

  // the warp's k-th group is group warp + k * n_warps of the block's chunk
  const int* ir = ids + static_cast<size_t>(row) * C;
  const int n_groups = (c1 - c0 + group - 1) / group;
  const int nk = warp < n_groups ? (n_groups - warp + n_warps - 1) / n_warps : 0;
  auto pos_of = [&](int k) { return c0 + (warp + k * n_warps) * group + lane; };
  auto id_of = [&](int k) {
    const int c = pos_of(k);
    return lane < group && c < c1 ? __ldg(ir + c) : -1;
  };
  auto row_of = [&](int id) {                         // the store row of a slot id, or -1
    return id < 0 ? -1 : min(id / page_size, num_pages - 1) * page_size + id % page_size;
  };
  // Copy i of a stage is row i / nc, 16 (or 4) bytes c = i % nc of it; lane
  // l takes copies l, l + 32, ...: (row, c) advance by (32 / nc, 32 % nc).
  const int nc = D / kW, dr = 32 / nc, dcol = 32 % nc;
  auto stage_rows = [&](int srow, float* dst) {       // the lanes' rows into dst
    int r = lane / nc, c = lane - r * nc;
    for (int i0 = 0; i0 < group * nc; i0 += 32) {     // rounds uniform in the warp
      const int rs = __shfl_sync(0xffffffffu, srow, r & 31);
      if (i0 + lane < group * nc && rs >= 0)
        cp_async<kBytes>(dst + r * ld + c * kW, store + static_cast<size_t>(rs) * D + c * kW);
      r += dr;
      c += dcol;
      if (c >= nc) {
        c -= nc;
        ++r;
      }
    }
    cp_commit();
  };

  float bv = -CUDART_INF_F;
  int bk = INT_MAX;
  int id_cur = nk > 0 ? id_of(0) : -1, id_next = nk > 1 ? id_of(1) : -1;
  int row_next = row_of(id_next);
  if (nk > 0) stage_rows(row_of(id_cur), ring);
  for (int k = 0; k < nk; ++k) {
    const int id_after = k + 2 < nk ? id_of(k + 2) : -1;   // read while group k scores
    if (k + 1 < nk) {
      stage_rows(row_next, ring + ((k + 1) & 1) * group * ld);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncwarp();
    if (id_cur >= 0) {
      const float* r = ring + (k & 1) * group * ld + lane * ld;
      float acc = 0.f;
      if constexpr (kBytes == 16) {
        const float4* q4 = reinterpret_cast<const float4*>(q_sh);
        const float4* r4 = reinterpret_cast<const float4*>(r);
        for (int e = 0; e < D / 4; ++e) {
          const float4 a = q4[e], b = r4[e];
          acc = fmaf(a.x, b.x, acc);
          acc = fmaf(a.y, b.y, acc);
          acc = fmaf(a.z, b.z, acc);
          acc = fmaf(a.w, b.w, acc);
        }
      } else {
        for (int e = 0; e < D; ++e) acc = fmaf(q_sh[e], r[e], acc);
      }
      const int key = kByPosition ? pos_of(k) : id_cur;
      if (better(acc, key, bv, bk)) {
        bv = acc;
        bk = key;
      }
    }
    __syncwarp();                                     // stage k & 1 is refilled next
    id_cur = id_next;
    id_next = id_after;
    row_next = row_of(id_after);
  }
  group_best<32>(bv, bk);
  if (lane == 0) merge_best(keys, row, bv, bk);
}

template <bool kByPosition, int kBytes>
cudaError_t gather_launch(const float* q, const int* ids, const float* store,
                          unsigned long long* keys, int Q, int C, int D, int num_pages,
                          int page_size, int n_split, int chunk, int group, int threads,
                          int smem_bytes, cudaStream_t s) {
  const int want = 4 * (((D + 3) & ~3) + (threads / 32) * 2 * group * gather_ld(D, kBytes));
  if (threads < 32 || threads > kMaxGatherThreads || threads % 32 || n_split < 1 ||
      chunk < 1 || group < 1 || group > 32 || smem_bytes != want)
    return cudaErrorInvalidValue;
  static int done[kMaxDevices] = {};
  cudaError_t err = smem_limit(gather_kernel<kByPosition, kBytes>, smem_bytes, done);
  if (err != cudaSuccess) return err;
  gather_kernel<kByPosition, kBytes><<<dim3(Q, n_split), threads, smem_bytes, s>>>(
      q, ids, store, keys, C, D, chunk, group, num_pages, page_size);
  return cudaGetLastError();
}

template <bool kByPosition>
int top1_launch(const float* q, const int* ids, const float* store, unsigned long long* keys,
                float* val, int* idx, int Q, int C, int D, int num_pages, int page_size,
                int n_split, int chunk, int group, int threads, int smem_bytes,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaMemsetAsync(keys, 0, sizeof(unsigned long long) * Q, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C > 0) {
    const bool vec16 = D % 4 == 0 && aligned16(q) && aligned16(store);
    err = vec16 ? gather_launch<kByPosition, 16>(q, ids, store, keys, Q, C, D, num_pages,
                                                 page_size, n_split, chunk, group, threads,
                                                 smem_bytes, s)
                : gather_launch<kByPosition, 4>(q, ids, store, keys, Q, C, D, num_pages,
                                                page_size, n_split, chunk, group, threads,
                                                smem_bytes, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(unpack(keys, kByPosition ? ids : nullptr, C, val, idx, Q, -1, s));
}

// ------------------------------------------------------------------ sim_top1
// What bounds it: 2*D FLOP per (query, store row) pair against one read of
// the store, so at Q = 4096 queries over 250k x 64 rows (131 GFLOP, 64 MB)
// it is bound by the fp32 rate of the CUDA cores (1.95 ms at 67 TFLOP/s),
// not by HBM.  The TPU kernel streamed the store through VMEM with a running
// (best, index) carried across a sequential grid axis.  Here an SGEMM-class
// register-tiled kernel:
//   * A block takes BM = 16 * kQT queries (128; 64, 32 or 16 for few
//     queries: sim_plan in sim_topk.py) and one split of the store's valid
//     rows, walked in tiles of 128 rows, each tile in chunks of 32 along D.
//     256 threads as 16 x 16; a thread scores kQT x 8 (query, row) pairs of
//     a tile: queries ty*4 + {0..3} and 64 + ty*4 + {0..3} (kQT = 8), rows
//     tx*4 + {0..3} and 64 + tx*4 + {0..3}.  Per d-step it reads 2 + 2
//     float4 from shared memory for 64 FMAs; a warp's query reads are
//     broadcasts (two ty), its row reads 256 contiguous bytes.
//   * The query tile is read once, 16 bytes at a time, and transposed
//     through registers into shared memory, d-major ([D][BM + 4]).
//   * The store chunks go through registers, not cp.async or TMA (neither
//     can transpose): chunk k + 1 is loaded into registers (pairs of lanes
//     read whole 32-byte sectors of one row) while chunk k is scored from
//     shared memory, then stored transposed, d-major ([32][128 + 4]: the two
//     halves of a warp's stores fall 16 banks apart), into the other of two
//     stages; one __syncthreads a chunk.  The next chunk moves in two
//     halves, the second loaded when the first is stored halfway through
//     the d-steps, so it holds 8 registers and not 16 (the 128-query tile
//     would spill).  bf16 inputs convert to fp32 there (exact).
//   * The accumulators continue across D chunks, so each score is one fmaf
//     chain over D ascending from 0; a D that is not a multiple of 32 ends
//     in a shorter chunk, and no fmaf runs past D.
//   * After a tile's last chunk the 16 lanes of a half-warp reduce each of
//     their kQT queries' tile best (max score, min index; rows at or past
//     the split's end, n_valid in the last tile, masked) with shuffles, and
//     lane tx = i folds query i's into its running best: one (value, index)
//     pair a lane, in registers across all the block's tiles, where eight a
//     thread would spill the 8 x 8 tile.  The running best's value is also
//     kept in shared memory: a warp whose tile has no score above it skips
//     the shuffles (a later tile's tie loses to the lower index anyway), so
//     once the near-duplicate is found most tiles cost a max and a vote.
//     At the end lane i merges its best into query i's packed key; a query
//     with no valid row gets (-inf, 0), the TPU kernel's initial best.
//   * Scores are plain dots: like the TPU kernel, this one does not
//     normalise (the store holds unit rows).
constexpr int kSimThreads = 256, kSimBN = 128, kSimBK = 32;
constexpr int kSimLDB = kSimBN + 4;

template <typename T>
struct Vec4;   // four consecutive elements of T: 16 bytes of f32, 8 of bf16
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<__nv_bfloat16> {
  using type = uint2;
};
__device__ __forceinline__ float4 to_f4(const float4& x) { return x; }
__device__ __forceinline__ float4 to_f4(const uint2& x) {   // low half first
  return make_float4(__uint_as_float(x.x << 16), __uint_as_float(x.x & 0xffff0000u),
                     __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xffff0000u));
}

// query row of a thread's i-th accumulator row (see the layout above)
template <int kQT>
__device__ __forceinline__ int sim_row(int ty, int i) {
  if constexpr (kQT == 8) return i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4;
  return ty * kQT + i;
}

template <int kQT>
__device__ __forceinline__ void load_a(const float* a_d, int ty, float* a) {
  if constexpr (kQT == 8) {
    const float4 x = *reinterpret_cast<const float4*>(a_d + ty * 4);
    const float4 y = *reinterpret_cast<const float4*>(a_d + 64 + ty * 4);
    a[0] = x.x, a[1] = x.y, a[2] = x.z, a[3] = x.w;
    a[4] = y.x, a[5] = y.y, a[6] = y.z, a[7] = y.w;
  } else if constexpr (kQT == 4) {
    const float4 x = *reinterpret_cast<const float4*>(a_d + ty * 4);
    a[0] = x.x, a[1] = x.y, a[2] = x.z, a[3] = x.w;
  } else if constexpr (kQT == 2) {
    const float2 x = *reinterpret_cast<const float2*>(a_d + ty * 2);
    a[0] = x.x, a[1] = x.y;
  } else {
    a[0] = a_d[ty];
  }
}

// one d-step: acc[i][j] += a[i] * b[j] for the thread's kQT x 8 pairs
template <int kQT>
__device__ __forceinline__ void sim_step(const float* a_d, const float* b_d, int ty, int tx,
                                         float (&acc)[kQT][8]) {
  float a[kQT];
  load_a<kQT>(a_d, ty, a);
  const float4 x = *reinterpret_cast<const float4*>(b_d + tx * 4);
  const float4 y = *reinterpret_cast<const float4*>(b_d + 64 + tx * 4);
  const float b[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < kQT; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <typename T, int kQT>
__global__ void __launch_bounds__(kSimThreads, 2)
sim_tile_kernel(const T* __restrict__ q, const T* __restrict__ store,
                unsigned long long* __restrict__ keys, int Q, int D, int n_valid, int chunk) {
  using V = typename Vec4<T>::type;
  constexpr int kBM = 16 * kQT, kLDA = kBM + 4;
  // d-steps unrolled: all 16 of a half chunk, 8 for bf16 (whose conversions
  // would otherwise spill the 128-query tile)
  constexpr int kUnroll = sizeof(T) == 4 ? kSimBK / 2 : 8;
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);   // [D][kLDA] the query tile, d-major
  float* Bs = As + D * kLDA;                     // [2][kSimBK][kSimLDB] store chunks, d-major
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  __shared__ float best_sh[kBM];                // each query's running best score
  const int q0 = blockIdx.x * kBM;
  const int c_begin = blockIdx.y * chunk, c_end = min(c_begin + chunk, n_valid);
  if (c_begin >= c_end) return;                  // a split past n_valid
  if (tid < kBM) best_sh[tid] = -CUDART_INF_F;

  const int d4 = D / 4;
  for (int i = tid; i < kBM * d4; i += kSimThreads) {
    const int m = i / d4, e = (i - m * d4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + m < Q) v = to_f4(*reinterpret_cast<const V*>(q + static_cast<size_t>(q0 + m) * D + e));
    As[e * kLDA + m] = v.x;
    As[(e + 1) * kLDA + m] = v.y;
    As[(e + 2) * kLDA + m] = v.z;
    As[(e + 3) * kLDA + m] = v.w;
  }

  // chunk `it` = (tile it / n_dk, D chunk it % n_dk).  A thread moves four
  // 4-element pieces of it, two a half h: piece g = tid + 256 (2 h + k),
  // row (g >> 1) & 127, columns 4 * (2 * (g >> 8) + (g & 1)) + {0..3}.
  const int n_dk = (D + kSimBK - 1) / kSimBK;
  const int n_iter = (c_end - c_begin + kSimBN - 1) / kSimBN * n_dk;
  V pre[2];
  auto load_half = [&](int it, int h) {
    const int t = it / n_dk, dc = (it - t * n_dk) * kSimBK, n0 = c_begin + t * kSimBN;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int g = tid + kSimThreads * (2 * h + k);
      const int n = (g >> 1) & (kSimBN - 1), col = dc + 4 * (2 * (g >> 8) + (g & 1));
      if (n0 + n < c_end && col < D) {
        pre[k] = *reinterpret_cast<const V*>(store + static_cast<size_t>(n0 + n) * D + col);
      } else {
        pre[k] = V{};
      }
    }
  };
  auto store_half = [&](float* dst, int h) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int g = tid + kSimThreads * (2 * h + k);
      const int n = (g >> 1) & (kSimBN - 1), col = 4 * (2 * (g >> 8) + (g & 1));
      const float4 v = to_f4(pre[k]);
      dst[col * kSimLDB + n] = v.x;
      dst[(col + 1) * kSimLDB + n] = v.y;
      dst[(col + 2) * kSimLDB + n] = v.z;
      dst[(col + 3) * kSimLDB + n] = v.w;
    }
  };

  float bv = -CUDART_INF_F;                      // lane tx < kQT: query tx's running best
  int bi = INT_MAX;
  float acc[kQT][8];
#pragma unroll
  for (int i = 0; i < kQT; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  load_half(0, 0);
  store_half(Bs, 0);
  load_half(0, 1);
  store_half(Bs, 1);
  __syncthreads();
  for (int it = 0; it < n_iter; ++it) {
    const int t = it / n_dk, dci = it - t * n_dk, dc = dci * kSimBK;
    const bool more = it + 1 < n_iter;
    float* next = Bs + ((it + 1) & 1) * kSimBK * kSimLDB;
    if (more) load_half(it + 1, 0);              // in flight while this chunk is scored
    const float* a_c = As + dc * kLDA;
    const float* b_c = Bs + (it & 1) * kSimBK * kSimLDB;
    if (dc + kSimBK <= D) {
#pragma unroll kUnroll
      for (int dd = 0; dd < kSimBK / 2; ++dd)
        sim_step<kQT>(a_c + dd * kLDA, b_c + dd * kSimLDB, ty, tx, acc);
      if (more) {
        store_half(next, 0);
        load_half(it + 1, 1);
      }
#pragma unroll kUnroll
      for (int dd = kSimBK / 2; dd < kSimBK; ++dd)
        sim_step<kQT>(a_c + dd * kLDA, b_c + dd * kSimLDB, ty, tx, acc);
    } else {                                     // the last, shorter chunk (D % 4 == 0)
      for (int dd = 0; dd < D - dc; dd += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          sim_step<kQT>(a_c + (dd + u) * kLDA, b_c + (dd + u) * kSimLDB, ty, tx, acc);
      }
      if (more) {
        store_half(next, 0);
        load_half(it + 1, 1);
      }
    }
    if (dci == n_dk - 1) {                       // the tile's scores are whole
      const int n0 = c_begin + t * kSimBN;
#pragma unroll
      for (int i = 0; i < kQT; ++i) {
        const int row = sim_row<kQT>(ty, i);
        float m = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
          if (col < c_end) m = fmaxf(m, acc[i][j]);
        }
        if (__any_sync(0xffffffffu, m > best_sh[row])) {   // uniform in the warp
          float v = -CUDART_INF_F;
          int k = INT_MAX;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
            if (col < c_end && better(acc[i][j], col, v, k)) {
              v = acc[i][j];
              k = col;
            }
          }
          group_best<16>(v, k);                  // the 16 lanes of a half-warp
          if (tx == i && better(v, k, bv, bi)) {
            bv = v;
            bi = k;
            best_sh[row] = v;                    // read after the next __syncthreads
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      }
    }
    if (more) store_half(next, 1);
    __syncthreads();   // the next chunk has landed; this one's stage is free
  }
  const int row = q0 + sim_row<kQT>(ty, tx);
  if (tx < kQT && row < Q) merge_best(keys, row, bv, bi);
}

template <typename T, int kQT>
cudaError_t sim_tile_launch(const void* q, const void* store, unsigned long long* keys, int Q,
                            int D, int n_valid, int n_split, int chunk, int smem_bytes,
                            cudaStream_t s) {
  constexpr int kBM = 16 * kQT;
  static int done[kMaxDevices] = {};
  cudaError_t err = smem_limit(sim_tile_kernel<T, kQT>, smem_bytes, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + kBM - 1) / kBM, n_split);
  sim_tile_kernel<T, kQT><<<grid, kSimThreads, smem_bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(store), keys, Q, D, n_valid, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t sim_launch(const void* q, const void* store, unsigned long long* keys, int Q, int D,
                       int n_valid, int q_rows, int n_split, int chunk, int smem_bytes,
                       cudaStream_t s) {
  switch (q_rows) {
    case 128:
      return sim_tile_launch<T, 8>(q, store, keys, Q, D, n_valid, n_split, chunk, smem_bytes, s);
    case 64:
      return sim_tile_launch<T, 4>(q, store, keys, Q, D, n_valid, n_split, chunk, smem_bytes, s);
    case 32:
      return sim_tile_launch<T, 2>(q, store, keys, Q, D, n_valid, n_split, chunk, smem_bytes, s);
    case 16:
      return sim_tile_launch<T, 1>(q, store, keys, Q, D, n_valid, n_split, chunk, smem_bytes, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (Q, D), store (N, D) contiguous, both f32 (16-byte aligned) or both bf16
// (8-byte aligned), D % 4 == 0; rows >= n_valid (<= N) score -inf.  The
// plan (sim_plan): q_rows queries a block (128, 64, 32 or 16), split s of
// n_split covers rows [s * chunk, (s + 1) * chunk), smem_bytes =
// 4 * (D * (q_rows + 4) + 2 * 32 * 132).  keys (Q) uint64 scratch.
extern "C" int sim_top1_launch(const void* q, const void* store, unsigned long long* keys,
                               float* val, int* idx, int Q, int D, int n_valid, int q_rows,
                               int n_split, int chunk, int smem_bytes, int is_bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q == 0) return static_cast<int>(cudaGetLastError());
  if (D % 4 || n_split < 1 || chunk % kSimBN ||
      smem_bytes != 4 * (D * (q_rows + 4) + 2 * kSimBK * kSimLDB))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(keys, 0, sizeof(unsigned long long) * Q, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_valid > 0) {
    err = is_bf16 ? sim_launch<__nv_bfloat16>(q, store, keys, Q, D, n_valid, q_rows, n_split,
                                              chunk, smem_bytes, s)
                  : sim_launch<float>(q, store, keys, Q, D, n_valid, q_rows, n_split, chunk,
                                      smem_bytes, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(unpack(keys, nullptr, 0, val, idx, Q, 0, s));
}

// q (Q, D) f32; ids (Q, C) int32; store (num_pages, page_size, D) f32 (a flat
// (N, D) store is page_size = 1); keys (Q) uint64 scratch; val (Q) f32, idx
// (Q) int32 out.  The plan (gather_plan): n_split splits of chunk
// candidates, group (<= 32) candidates a warp stages at once, threads a
// block (a multiple of 32, at most 128), smem_bytes = 4 * (round4(D) +
// threads / 32 * 2 * group * ld), ld = D + 4 where D % 4 == 0 and q and the
// store start on 16 bytes, else D | 1.
extern "C" int reuse_top1_launch(const float* q, const int* ids, const float* store,
                                 unsigned long long* keys, float* val, int* idx, int Q, int C,
                                 int D, int num_pages, int page_size, int n_split, int chunk,
                                 int group, int threads, int smem_bytes, void* stream) {
  return top1_launch<false>(q, ids, store, keys, val, idx, Q, C, D, num_pages, page_size,
                            n_split, chunk, group, threads, smem_bytes, stream);
}

extern "C" int gather_top1_launch(const float* q, const int* ids, const float* store,
                                  unsigned long long* keys, float* val, int* idx, int Q, int C,
                                  int D, int num_pages, int page_size, int n_split, int chunk,
                                  int group, int threads, int smem_bytes, void* stream) {
  return top1_launch<true>(q, ids, store, keys, val, idx, Q, C, D, num_pages, page_size,
                           n_split, chunk, group, threads, smem_bytes, stream);
}
