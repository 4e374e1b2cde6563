// The streaming pink cascade: K AR(1) poles driven by one shared
// innovation stream, summed with signed amplitudes.
//
// Replaces maria_tpu/noise/streaming.py::PinkCascade.block (:168), which
// the TPU runs as Toeplitz matmuls over 1,024-sample sub-chunks because
// that suits its MXU. This kernel computes the contract of block_scan
// (:197-211) directly. For each row r, with its table's poles p_k and
// amplitudes a_k (k < K) and the carried state x_k:
//   x_k <- p_k x_k + w[r, t]          (one fmaf: a single rounding)
//   pink[r, t] = sum_k a_k x_k        (fmaf in k = 0, 1, ..., K - 1 from 0)
// then the new state is written. A thread keeps its K states, poles and
// amplitudes in registers (a template on the register count KT >= K;
// poles past K are zero with zero amplitude and change no sum).
//
// What bounds it: 8 bytes a sample (read w, write pink) against 2K FMAs a
// sample. With many rows (every band's 50,049 rows x 640 of the AtLAST-50k
// streamed block) it is a memory pass; with few (MUSTANG-2's 222 rows x
// 3,136) one thread a row is a chain of n dependent steps on a handful of
// warps, bound by latency. Two forms answer the two, chosen by the wrapper
// from the launch shape alone (ops/pink_cascade.py::cascade_plan), so the
// order of every sum is fixed by (rows, n, K):
//
// G = 1, many rows: a thread a row, 128 rows a block. Each row's next
// tiles of S samples (the wrapper plans 32) come into a ring of three
// shared-memory stages by Hopper's bulk copies (cp.async.bulk, one a row
// and tile, completing on the stage's mbarrier), so two tiles are in
// flight while one is walked; the walk reads and writes its row as float4
// (a row pitch of S + 4 floats, S a multiple of 8, puts eight rows'
// float4s in eight distinct bank groups), and the pink goes back to
// global memory by a bulk store from the same slot. The arithmetic is the
// sequential recurrence above.
//
// G >= 32, few rows: time is split. G lanes (one to eight warps, a row a
// block) share a row; a chunk of G x S samples, loaded and stored through
// the same ring, is cut into G segments of S (S odd: the lanes' segment
// reads fall in distinct banks).
//   Pass A: each lane walks its segment from zero state with the same
//     step, keeping its local end state e_k, and writes the local pink
//     in place.
//   Scan: the start state of segment g is s_g = P s_{g-1} + e_{g-1} with
//     P_k = p_k^S. A Kogge-Stone scan of the affine pairs by shuffles
//     within each warp, b_j <- P^d b_{j-d} + b_j for d = 1, 2, 4, 8, 16;
//     across the warps of a row the warps' totals are composed in order
//     through shared memory, C_w = P^32 C_{w-1} + T_{w-1}, C_0 the row's
//     state; then segment j's end state is P^(j+1) C_w + b_j and its
//     start the previous lane's end (C_w for lane 0).
//   Pass B: each lane adds sum_k D[k, m] s_k (k from 0) to its local pink,
//     D[k, m] = a_k p_k^(m+1); the row's slot goes back by a bulk store.
//   The chunk's last segment's end, Z[len - 1] s + e with Z[k, m] =
//     p_k^(m+1), is the next chunk's state or the row's new state.
// The powers come from a table built on the host in float64 and rounded
// once (ops/pink_cascade.py::split_tables): p^S in float32 by repeated
// multiplication drifts by ~S ulps, and the slowest pole (1.5e-6 below 1)
// carries a state of ~600. The block bulk-copies its row's table into
// shared memory with its first chunk: read through L1 instead, the scan's
// and pass B's dependent table reads made a 222 x 3,136 block a third
// slower on an H100. The CPU emulation of both orders is
// tests/test_torch_streaming.py::cascade_split_emulation.
//
// No atomics: the result depends on (rows, n, K) and the inputs alone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 3;           // the ring's depth
constexpr int kRowThreads = 128;     // G = 1: rows (threads) a block
constexpr int kPowers = 32;          // E[k, j] = p_k^(S (j + 1)), j < 32
constexpr unsigned kAll = 0xffffffffu;

struct Args {
  const float* w;
  float* pink;
  const float* state_in;
  float* state_out;
  const float* p;
  const float* a;
  const int* row_table;
  const float* tables;  // G >= 32: (n_tables, K, 2 Sp + 32): a pole's D, Z, E
  int rows, n, ld, K, G, S, Sp;
};

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// this thread arrives on a stage's barrier, which then also waits for
// `bytes` more to land; the stage completes when every row has arrived
// and every byte landed
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// bytes from global into shared, counted on `bar` when they land
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   smem_addr(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bulk_store(float* dst, const float* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(reinterpret_cast<uint64_t>(dst)),
               "r"(smem_addr(src)),
               "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

template <int KT>
__device__ __forceinline__ float cascade_step(float (&x)[KT], const float (&p)[KT], const float (&a)[KT], float w) {
  float y = 0.0f;
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    x[k] = fmaf(p[k], x[k], w);
    y = fmaf(a[k], x[k], y);
  }
  return y;
}

// Pass A, the scan and pass B of the row's chunk of clen samples in its
// slot `sl` (G segments of S), x the row's state entering it, `tab` its
// table in shared memory; lane `used - 1` writes the chunk's end state to
// `carry`. Every thread of the block calls it (it holds a block barrier).
template <int KT>
__device__ __forceinline__ void split_chunk(const Args& A, float* sl, int clen, int g, const float (&p)[KT],
                                            const float (&a)[KT], float (&x)[KT], const float* tab, float* tot,
                                            float* carry) {
  const int G = A.G, S = A.S, K = A.K, Sp = A.Sp;
  const int j = g & 31;  // the lane within its warp
  const int used = (clen + S - 1) / S;
  const int len = max(0, min(S, clen - g * S));
  const int W = 2 * Sp + kPowers;  // a pole's row of the table: D, Z, E
  const float* D = tab;
  const float* Z = tab + Sp;
  const float* E = tab + 2 * Sp;
  float* seg = sl + g * S;

  float e[KT];
#pragma unroll
  for (int k = 0; k < KT; ++k) e[k] = 0.0f;
  for (int m = 0; m < len; ++m) seg[m] = cascade_step<KT>(e, p, a, seg[m]);

  float b[KT];
#pragma unroll
  for (int k = 0; k < KT; ++k) b[k] = e[k];
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const float v = __shfl_up_sync(kAll, b[k], d);  // from lane j - d where j >= d
      if (k < K && j >= d) b[k] = fmaf(E[k * W + d - 1], v, b[k]);
    }
  }
  // compose the totals of the row's earlier warps in order (G > 32): x becomes C_w
  const int wi = g >> 5;
  if (G > 32 && j == 31) {
#pragma unroll
    for (int k = 0; k < KT; ++k) tot[wi * KT + k] = b[k];
  }
  __syncthreads();
  for (int v = 0; v < wi; ++v) {
#pragma unroll
    for (int k = 0; k < KT; ++k)
      if (k < K) x[k] = fmaf(E[k * W + 31], x[k], tot[v * KT + k]);
  }
#pragma unroll
  for (int k = 0; k < KT; ++k) {  // b becomes the segment's start state
    const float end = k < K ? fmaf(E[k * W + j], x[k], b[k]) : 0.0f;
    const float up = __shfl_up_sync(kAll, end, 1);
    b[k] = j == 0 ? x[k] : up;
  }

  for (int m0 = 0; m0 < len; m0 += 4) {
    float y0 = seg[m0];
    float y1 = m0 + 1 < len ? seg[m0 + 1] : 0.0f;
    float y2 = m0 + 2 < len ? seg[m0 + 2] : 0.0f;
    float y3 = m0 + 3 < len ? seg[m0 + 3] : 0.0f;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      if (k < K) {
        const float4 d = *reinterpret_cast<const float4*>(D + k * W + m0);
        y0 = fmaf(d.x, b[k], y0);
        y1 = fmaf(d.y, b[k], y1);
        y2 = fmaf(d.z, b[k], y2);
        y3 = fmaf(d.w, b[k], y3);
      }
    }
    seg[m0] = y0;
    if (m0 + 1 < len) seg[m0 + 1] = y1;
    if (m0 + 2 < len) seg[m0 + 2] = y2;
    if (m0 + 3 < len) seg[m0 + 3] = y3;
  }
  if (g == used - 1) {
#pragma unroll
    for (int k = 0; k < KT; ++k) carry[k] = k < K ? fmaf(Z[k * W + len - 1], b[k], e[k]) : 0.0f;
  }
}

// kSplit false: G = 1, a thread a row; true: G >= 32 lanes a row, a row a
// block, its table bulk-copied into shared memory with the first chunk
template <int KT, bool kSplit>
__global__ void __launch_bounds__(256) pink_cascade_kernel(const Args A) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = kSplit ? A.G * A.S : A.S;  // samples of a row a chunk (G = 1: a tile)
  const int pitch = kSplit ? L : L + 4;
  const int R = kSplit ? 1 : blockDim.x;  // rows a block
  const int nc = (A.n + L - 1) / L;
  const int stages = min(kStages, nc);
  const int K = A.K;
  const int words = kSplit ? K * (2 * A.Sp + kPowers) : 0;  // the row's table
  float* ring = reinterpret_cast<float*>(smem);
  float* table = ring + (size_t)stages * R * pitch;
  uint64_t* full = reinterpret_cast<uint64_t*>(table + words);
  float* carry = reinterpret_cast<float*>(full + kStages);  // split: [2][KT]
  float* tot = carry + 2 * KT;                              // split, G > 32: [G / 32][KT]

  const int rho = kSplit ? 0 : threadIdx.x;
  const int g = kSplit ? threadIdx.x : 0;
  const int r = blockIdx.x * R + rho;
  const bool live = r < A.rows;
  const bool leader = live && g == 0;
  if (threadIdx.x == 0) {
    const int live_rows = min(R, A.rows - (int)blockIdx.x * R);
    for (int s = 0; s < kStages; ++s) bar_init(&full[s], live_rows);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const float* src = A.w + (size_t)r * A.ld;
  float* dst = A.pink + (size_t)r * A.ld;
  auto slot = [&](int c) { return ring + ((size_t)(c % kStages) * R + rho) * pitch; };
  auto bytes = [&](int c) { return 4u * (uint32_t)min(L, A.ld - c * L); };
  const int tab = (live && A.row_table != nullptr) ? A.row_table[r] : 0;
  if (leader) {  // the first chunks (and the table) load while the row's poles and state do
    bar_expect(&full[0], bytes(0) + 4u * words);
    bulk_copy(slot(0), src, bytes(0), &full[0]);
    if constexpr (kSplit) bulk_copy(table, A.tables + (size_t)tab * words, 4u * words, &full[0]);
    if (nc > 1) {
      bar_expect(&full[1], bytes(1));
      bulk_copy(slot(1), src + L, bytes(1), &full[1]);
    }
  }
  // a row's state is written by its leader after the last chunk, which in
  // the split follows two block barriers a chunk: every lane of the row
  // has read it by then
  float x[KT], p[KT], a[KT];
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    const bool used = k < K;
    p[k] = used ? A.p[tab * K + k] : 0.0f;
    a[k] = used ? A.a[tab * K + k] : 0.0f;
    x[k] = (used && live) ? A.state_in[(size_t)r * K + k] : 0.0f;
  }
  for (int c = 0; c < nc; ++c) {
    float* sl = slot(c);
    const int clen = min(L, A.n - c * L);
    bar_wait(&full[c % kStages], (c / kStages) & 1);
    if constexpr (!kSplit) {
      if (clen == L) {
        float4* v4 = reinterpret_cast<float4*>(sl);
#pragma unroll 4
        for (int q = 0; q < L / 4; ++q) {
          float4 v = v4[q];
          v.x = cascade_step<KT>(x, p, a, v.x);
          v.y = cascade_step<KT>(x, p, a, v.y);
          v.z = cascade_step<KT>(x, p, a, v.z);
          v.w = cascade_step<KT>(x, p, a, v.w);
          v4[q] = v;
        }
      } else {
        for (int t = 0; t < clen; ++t) sl[t] = cascade_step<KT>(x, p, a, sl[t]);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    } else {
      float* cr = carry + (c & 1) * KT;
      split_chunk<KT>(A, sl, clen, g, p, a, x, table, tot, cr);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
#pragma unroll
      for (int k = 0; k < KT; ++k) x[k] = cr[k];
    }
    if (leader) {
      bulk_store(dst + (size_t)c * L, sl, bytes(c));
      if (c + 2 < nc) {  // into the stage of chunk c - 1, once its store has read it
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        bar_expect(&full[(c + 2) % kStages], bytes(c + 2));
        bulk_copy(slot(c + 2), src + (size_t)(c + 2) * L, bytes(c + 2), &full[(c + 2) % kStages]);
      }
    }
  }
  if (leader) {
#pragma unroll
    for (int k = 0; k < KT; ++k)
      if (k < K) A.state_out[(size_t)r * K + k] = x[k];
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");  // the slots stay until the stores have read them
  }
}

// The dynamic shared memory a form may use is raised once per device to
// the most any launch has asked (a host call that cost ~1 ms a launch once
// the kernel had been captured in a CUDA graph).
template <int KT, bool kSplit>
int launch(const Args& A, int threads, size_t smem, cudaStream_t st) {
  auto kernel = pink_cascade_kernel<KT, kSplit>;
  static size_t allowed[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64) return (int)cudaErrorInvalidDevice;
  if (smem > allowed[device]) {
    err = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed[device] = smem;
  }
  const int R = kSplit ? 1 : threads;
  kernel<<<(A.rows + R - 1) / R, threads, smem, st>>>(A);
  return (int)cudaGetLastError();
}

template <bool kSplit>
int launch_kt(const Args& A, int KT, int threads, size_t smem, cudaStream_t st) {
  if (KT == 8) return launch<8, kSplit>(A, threads, smem, st);
  if (KT == 16) return launch<16, kSplit>(A, threads, smem, st);
  return launch<32, kSplit>(A, threads, smem, st);
}

}  // namespace

// w, pink: (rows, ld) f32, row-major, 16-byte aligned, ld a multiple of 4
// and >= n (columns n..ld-1 are read and written but belong to no row's
// cascade); state_in, state_out: (rows, K) f32 (may be the same buffer: a
// row reads its state before it writes it); p, a: (n_tables, K) f32;
// row_table: (rows,) int32 table of each row, or null for table 0
// everywhere. K <= 32. G = 1 walks a row a thread (S and tables unused);
// G in 32..256, a power of two, splits each row's chunks of G x S samples
// into G segments, with tables (n_tables, K, 2 Sp + 32) f32 holding
// D = a p^(m+1) and Z = p^(m+1) (m < S, zero to Sp, a multiple of 4) and
// E = p^(S (j+1)) (j < 32).
extern "C" int maria_pink_cascade(const void* w, void* pink, const void* state_in, void* state_out, const void* p,
                                  const void* a, const void* row_table, const void* tables, int rows, int n, int ld,
                                  int K, int G, int S, int Sp, void* stream) {
  const bool split = G > 1;
  if (rows < 1 || n < 1 || K < 1 || K > 32 || ld < n || ld % 4 != 0 ||
      (((uintptr_t)w | (uintptr_t)pink) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (!split && (G != 1 || S < 8 || S > 256 || S % 8 != 0)) return (int)cudaErrorInvalidValue;
  if (split && (G < 32 || G > 256 || (G & (G - 1)) != 0 || S < 1 || S > (1 << 20) || Sp < S || Sp % 4 != 0 ||
                tables == nullptr || (((uintptr_t)tables) & 15) != 0))
    return (int)cudaErrorInvalidValue;
  const Args A{(const float*)w, (float*)pink, (const float*)state_in, (float*)state_out, (const float*)p,
               (const float*)a, (const int*)row_table, (const float*)tables, rows, n, ld, K, G, S, Sp};
  const int KT = K <= 8 ? 8 : K <= 16 ? 16 : 32;
  const int threads = split ? G : kRowThreads;
  const int R = split ? 1 : kRowThreads;
  const int L = split ? G * S : S;
  const int pitch = split ? L : L + 4;
  const int nc = (int)(((long long)n + L - 1) / L);
  const int stages = nc < kStages ? nc : kStages;
  size_t smem = (size_t)stages * R * pitch * 4 + kStages * sizeof(uint64_t);
  if (split) smem += ((size_t)K * (2 * Sp + kPowers) + (size_t)(2 + (G > 32 ? G / 32 : 1)) * KT) * 4;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return split ? launch_kt<true>(A, KT, threads, smem, st) : launch_kt<false>(A, KT, threads, smem, st);
}
