// Bucket-major masked cosine top-1 over the probed slot tables, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/sim_topk.py::reuse_top1
// (_reuse_top1_kernel, _gather_rows) where the fused query
// (repro/kernels/fused_query.py) calls it: the candidates of query b are the
// slot rows slots[t, buckets[b, t, p]] of the tables it probes, unsorted, with
// duplicates, -1 = empty slot; the best is the lexicographic (max score, min
// row id), (-inf, -1) for a query without a valid candidate.  The arbitrary
// (B, C) id-matrix route stays in sim_topk.cu (reuse_top1_launch).
//
// What bounds it: a query-major kernel gathers every (query, candidate) row
// from the store, 256 bytes for 2*D = 128 FLOP at D = 64, and at the serving
// shape (B = 1024 queries x 20480 candidates) moves 5.4 GB through L2 for
// 2.7 GFLOP.  Scored bucket by bucket, each probed slot row is read once and
// scored against every query that probes it (about 64 at that shape), so the
// traffic falls to tens of MB and the fp32 FMAs on the CUDA cores bound it.
//
// Design:
//   * The wrapper inverts the probe buckets on the device (plain torch: a
//     stable sort of t * NB + bucket): offsets[r] .. offsets[r + 1] index
//     probers[], the queries that probe slot row r.  The grid is (T * NB slot
//     rows, cap / 64 row tiles), known on the host without a sync; a block
//     whose slot row has no prober, or whose 64 slots are all empty, exits.
//   * A block stages its 64 store rows in shared memory once (16-byte
//     cp.async, 16 lanes a row at D = 64; the paged address is row
//     min(id / S, P - 1) * S + id % S, as the Pallas kernel computes it), then
//     walks its probers in chunks of query rows through a two-stage cp.async
//     ring.
//   * Each thread scores a 4 x 4 (query, row) micro-tile in registers.  Every
//     (query, row) dot is one fmaf chain over D in ascending order from 0,
//     the chain of sim_topk.cu's dot_row, so a row that sits in several
//     probed buckets, and equal rows, score bit-equal whichever block scores
//     them; D is never split across threads for one dot.
//   * Combine: a thread keeps a lexicographic best per query, 16 lanes
//     reduce it with shuffles, and one lane issues a 64-bit atomicMax of the
//     packed key (orderable score bits, 0xFFFFFFFF - id) per (query, block):
//     top1_pack.cuh, shared with sim_topk.cu.  The max is order-free, so the
//     result does not depend on block order.
//   * Where a slot row expects few probers (B * P / NB below 8, known on the
//     host: the store shape has ~2, a row ~15 valid slots), the FMAs are few
//     and the kernel waits on memory, and a 64 x 64 tile is mostly idle.
//     There sparse_kernel takes the same grid with 64 threads a block: a
//     thread holds one slot's row in registers (every 16-byte load in flight
//     at once), its warp stages each prober's query row in shared memory one
//     prober ahead, and the warp reduces its lanes' bests before the
//     atomicMax.  The dot is the same fmaf chain.  Each row serves ~2 queries
//     there, so the bucket order saves little traffic: the kernel is bound by
//     its chains of dependent loads (offsets and ids, then rows and prober
//     ids, then queries), which this layout keeps short.  It takes
//     D % 4 == 0 and D <= 128; the wrapper sends other widths to the tiles.
//   * A second small kernel unpacks the keys into (val, idx).
//   * Plain fp32 FMA, no TF32 and no tensor cores: winners must not flip
//     against the reference's fp32 arithmetic.
#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "cp_async.cuh"
#include "top1_pack.cuh"

namespace {

constexpr int kQT = 64;        // query rows of a chunk
constexpr int kRT = 64;        // slots (store rows) of a block
constexpr int kThreads = 256;  // 16 x 16 threads, each a 4 x 4 micro-tile

// Stage query rows probers[first .. first + nq) of q into dst (kQT rows,
// stride ld); rows at or past nq are zero.
template <int kBytes>
__device__ __forceinline__ void load_queries(float* dst, const float* __restrict__ q,
                                             const int* __restrict__ probers, int first,
                                             int nq, int D, int ld) {
  constexpr int kW = kBytes / 4;
  const int nc = D / kW;
  for (int i = threadIdx.x; i < kQT * nc; i += kThreads) {
    const int r = i / nc, c = i - r * nc;
    float* d = dst + r * ld + c * kW;
    if (r < nq) {
      cp_async<kBytes>(d, q + static_cast<size_t>(probers[first + r]) * D + c * kW);
    } else {
      zero<kBytes>(d);
    }
  }
}

template <int kBytes>
__global__ void __launch_bounds__(kThreads, 4)
probed_kernel(const float* __restrict__ q, const float* __restrict__ store,
              const int* __restrict__ slots, const int* __restrict__ offsets,
              const int* __restrict__ probers, unsigned long long* __restrict__ keys,
              int D, int cap, int num_pages, int page_size) {
  extern __shared__ float4 smem4[];
  __shared__ int ids_sh[kRT];
  float* sm = reinterpret_cast<float*>(smem4);
  const int dp = (D + 3) & ~3, ld = dp + 4;   // rows 16 bytes apart in bank order
  float* Rs = sm;                             // [kRT][ld] this block's store rows
  float* Qs = Rs + kRT * ld;                  // [2][kQT][ld] ring of query rows
  constexpr int kW = kBytes / 4;

  const int slot_row = blockIdx.x, tile0 = blockIdx.y * kRT;
  const int p0 = offsets[slot_row], p1 = offsets[slot_row + 1];
  if (p0 == p1) return;                       // no query probes this bucket
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  int id = -1;
  if (tid < kRT && tile0 + tid < cap) id = slots[static_cast<size_t>(slot_row) * cap + tile0 + tid];
  if (tid < kRT) ids_sh[tid] = id;
  if (!__syncthreads_or(id >= 0)) return;     // every slot of the tile is empty

  if (dp != D) {                              // columns D .. dp stay 0
    for (int i = tid; i < (kRT + 2 * kQT) * (dp - D); i += kThreads) {
      const int r = i / (dp - D);
      sm[r * ld + D + i - r * (dp - D)] = 0.f;
    }
  }
  const int nc = D / kW;
  for (int i = tid; i < kRT * nc; i += kThreads) {
    const int r = i / nc, c = i - r * nc;
    const int rid = ids_sh[r];
    float* d = Rs + r * ld + c * kW;
    if (rid >= 0) {
      const int pg = min(rid / page_size, num_pages - 1);
      cp_async<kBytes>(d, store + (static_cast<size_t>(pg) * page_size + rid % page_size) * D +
                              c * kW);
    } else {
      zero<kBytes>(d);
    }
  }
  const int n_prob = p1 - p0, n_chunks = (n_prob + kQT - 1) / kQT;
  load_queries<kBytes>(Qs, q, probers, p0, min(kQT, n_prob), D, ld);
  cp_commit();

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int first = p0 + ch * kQT, nq = min(kQT, p1 - first);
    if (ch + 1 < n_chunks) {
      load_queries<kBytes>(Qs + ((ch + 1) & 1) * kQT * ld, q, probers, first + kQT,
                           min(kQT, p1 - first - kQT), D, ld);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* Qb = Qs + (ch & 1) * kQT * ld;
    float bv[4];
    int bk[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bv[i] = -CUDART_INF_F;
      bk[i] = INT_MAX;
    }
    if (ty * 4 < nq) {
      float s[4][4] = {};
      for (int d = 0; d < dp; d += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(Qb + (ty * 4 + i) * ld + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(Rs + (tx + 16 * j) * ld + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
            s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
            s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
            s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rid = ids_sh[tx + 16 * j];
        if (rid < 0) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (ty * 4 + i < nq && better(s[i][j], rid, bv[i], bk[i])) {
            bv[i] = s[i][j];
            bk[i] = rid;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      group_best<16>(bv[i], bk[i]);   // the 16 threads of a half-warp
      if (tx == 0 && ty * 4 + i < nq) merge_best(keys, probers[first + ty * 4 + i], bv[i], bk[i]);
    }
    __syncthreads();   // stage ch & 1 is refilled for chunk ch + 2
  }
}

// A thread a slot of the block's 64-slot tile: its row in registers (all
// 16-byte loads in flight at once), the probers' ids loaded 32 at a time, and
// each prober's query row staged by its warp in shared memory (lane l copies
// 16 bytes) a prober ahead, read back as broadcasts.  kV = D / 4 at most.
template <int kV>
__global__ void __launch_bounds__(kRT)
sparse_kernel(const float* __restrict__ q, const float* __restrict__ store,
              const int* __restrict__ slots, const int* __restrict__ offsets,
              const int* __restrict__ probers, unsigned long long* __restrict__ keys, int D,
              int cap, int num_pages, int page_size) {
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ float4 q_sh[kRT / 32][2][kV];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nv = D / 4;
  const int slot_row = blockIdx.x, c = blockIdx.y * kRT + threadIdx.x;
  const int id = c < cap ? slots[static_cast<size_t>(slot_row) * cap + c] : -1;
  const int p0 = offsets[slot_row], p1 = offsets[slot_row + 1];
  const bool valid = id >= 0;
  if (p0 == p1 || !__any_sync(kAll, valid)) return;   // uniform per warp
  float4 r[kV];
  if (valid) {
    const int pg = min(id / page_size, num_pages - 1);
    const float4* r4 = reinterpret_cast<const float4*>(
        store + (static_cast<size_t>(pg) * page_size + id % page_size) * D);
#pragma unroll
    for (int v = 0; v < kV; ++v)
      if (v < nv) r[v] = __ldg(r4 + v);
  }
  const float4* q4 = reinterpret_cast<const float4*>(q);
  int stage = 0;
  for (int pc = p0; pc < p1; pc += 32) {
    const int n = min(32, p1 - pc);
    const int mine = lane < n ? probers[pc + lane] : 0;
    int b = __shfl_sync(kAll, mine, 0);
    float4 next = lane < nv ? __ldg(q4 + static_cast<size_t>(b) * nv + lane) : float4{};
    for (int i = 0; i < n; ++i) {
      if (lane < nv) q_sh[warp][stage][lane] = next;
      __syncwarp();
      const int cur = b;
      if (i + 1 < n) {                       // the next prober's row, in flight meanwhile
        b = __shfl_sync(kAll, mine, i + 1);
        if (lane < nv) next = __ldg(q4 + static_cast<size_t>(b) * nv + lane);
      }
      float v = -CUDART_INF_F;
      int k = INT_MAX;
      if (valid) {
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          if (e < nv) {
            const float4 a = q_sh[warp][stage][e];
            acc = fmaf(a.x, r[e].x, acc);
            acc = fmaf(a.y, r[e].y, acc);
            acc = fmaf(a.z, r[e].z, acc);
            acc = fmaf(a.w, r[e].w, acc);
          }
        }
        v = acc;
        k = id;
      }
      group_best<32>(v, k);                       // the warp's best (value, id)
      if (lane == 0) merge_best(keys, cur, v, k);
      stage ^= 1;
    }
  }
}

template <int kBytes>
int launch(const float* q, const float* store, const int* slots, const int* offsets,
           const int* probers, unsigned long long* keys, int D, int rows, int cap,
           int num_pages, int page_size, int sparse, int smem_bytes, cudaStream_t s) {
  const dim3 grid(rows, (cap + kRT - 1) / kRT);
  if (sparse) {   // a row of at most 32 16-byte vectors in registers
    if (smem_bytes != 0 || kBytes != 16 || D > 128)
      return static_cast<int>(cudaErrorInvalidValue);
    if (D <= 64) {
      sparse_kernel<16><<<grid, kRT, 0, s>>>(q, store, slots, offsets, probers, keys, D, cap,
                                             num_pages, page_size);
    } else {
      sparse_kernel<32><<<grid, kRT, 0, s>>>(q, store, slots, offsets, probers, keys, D, cap,
                                             num_pages, page_size);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (smem_bytes != (kRT + 2 * kQT) * (((D + 3) & ~3) + 4) * static_cast<int>(sizeof(float)))
    return static_cast<int>(cudaErrorInvalidValue);
  static int done[kMaxDevices] = {};
  const cudaError_t err = smem_limit(probed_kernel<kBytes>, smem_bytes, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  probed_kernel<kBytes><<<grid, kThreads, smem_bytes, s>>>(q, store, slots, offsets, probers,
                                                           keys, D, cap, num_pages, page_size);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, D) unit rows; store (num_pages, page_size, D) (a flat (N, D) store is
// page_size = 1); slots (rows, cap) int32 slot tables, rows = T * NB;
// offsets (rows + 1) and probers (offsets[rows]) int32 from the wrapper's
// inversion of the probe buckets; keys (B) uint64, zero on entry; val (B) f32,
// idx (B) int32 out.  sparse: 1 = sparse_kernel (smem_bytes 0; D % 4 == 0,
// D <= 128, q and store 16-byte aligned), 0 = the dense tiles (smem_bytes
// (64 + 2 * 64) * (round4(D) + 4) floats).
extern "C" int reuse_probed_launch(const float* q, const float* store, const int* slots,
                                   const int* offsets, const int* probers,
                                   unsigned long long* keys, float* val, int* idx, int B,
                                   int D, int rows, int cap, int num_pages, int page_size,
                                   int sparse, int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  if (rows > 0 && cap > 0) {
    // 16-byte copies where every row starts on 16 bytes, else 4-byte ones
    const bool vec16 = D % 4 == 0 && aligned16(q) && aligned16(store);
    const int err = vec16
                        ? launch<16>(q, store, slots, offsets, probers, keys, D, rows, cap,
                                     num_pages, page_size, sparse, smem_bytes, s)
                        : launch<4>(q, store, slots, offsets, probers, keys, D, rows, cap,
                                    num_pages, page_size, sparse, smem_bytes, s);
    if (err != 0) return err;
  }
  return static_cast<int>(unpack(keys, nullptr, 0, val, idx, B, -1, s));
}
