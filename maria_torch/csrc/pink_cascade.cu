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
// then the new state is written. The CPU emulation of this order is
// tests/test_torch_streaming.py::cascade_emulation.
//
// What bounds it: 8 bytes a sample (read w, write pink) against 2K flops
// a sample, so at K = 14 and a block of every band's rows (50,049 x 640 at
// the AtLAST-50k streamed scene) it is a memory pass of 0.26 GB. The walk
// along t is a chain of one FMA a step per pole, the pink sum off it, so a
// thread keeps its K states, poles and amplitudes in registers (the
// kernel is a template on the register count KT >= K; poles past K are
// zero with zero amplitude and change no sum).
//
// Layout: one thread a row, kRows rows a block. Rows lie n floats apart, so
// a thread walking its own row would read one 32-byte sector a sample;
// instead the block stages a tile of kRows x kTile samples through shared
// memory with coalesced loads (a warp reads 32 consecutive samples of a
// row), walks it, writes its pink back into the tile and stores the tile
// coalesced. The tile's rows are padded by one word, so the walk's reads
// (thread i, column j) fall in distinct banks. Every band of a block runs
// in one launch: a row reads its table's (p, a) through row_table.
//
// Few rows (MUSTANG-2's 222) fill a handful of warps of the card and the
// walk is then latency-bound; a time split (segments started from zero,
// the carried state added through its decay a_k p_k^(t+1)) is the answer
// and is not written yet (ROADMAP queue 2).

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;   // rows a block: one thread each
constexpr int kTile = 32;   // samples a tile

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

template <int KT>
__global__ void __launch_bounds__(kRows) pink_cascade_kernel(const float* __restrict__ w, float* __restrict__ pink,
                                                            const float* __restrict__ state_in,
                                                            float* __restrict__ state_out,
                                                            const float* __restrict__ p_tab,
                                                            const float* __restrict__ a_tab,
                                                            const int* __restrict__ row_table, int rows, int n,
                                                            int K) {
  __shared__ float tile[kRows][kTile + 1];
  const int row0 = blockIdx.x * kRows;
  const int r = row0 + threadIdx.x;
  const bool live = r < rows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kRows / 32;

  const int tab = (live && row_table != nullptr) ? row_table[r] : 0;
  float x[KT], p[KT], a[KT];
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    const bool used = k < K;
    p[k] = used ? p_tab[tab * K + k] : 0.0f;
    a[k] = used ? a_tab[tab * K + k] : 0.0f;
    x[k] = (used && live) ? state_in[(size_t)r * K + k] : 0.0f;
  }

  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int len = min(kTile, n - t0);
    for (int i = warp; i < kRows; i += kWarps) {
      const int rr = row0 + i;
      tile[i][lane] = (rr < rows && lane < len) ? __ldg(w + (size_t)rr * n + t0 + lane) : 0.0f;
    }
    __syncthreads();
    if (len == kTile) {
#pragma unroll
      for (int j = 0; j < kTile; ++j) tile[threadIdx.x][j] = cascade_step<KT>(x, p, a, tile[threadIdx.x][j]);
    } else {
      for (int j = 0; j < len; ++j) tile[threadIdx.x][j] = cascade_step<KT>(x, p, a, tile[threadIdx.x][j]);
    }
    __syncthreads();
    for (int i = warp; i < kRows; i += kWarps) {
      const int rr = row0 + i;
      if (rr < rows && lane < len) pink[(size_t)rr * n + t0 + lane] = tile[i][lane];
    }
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < KT; ++k)
      if (k < K) state_out[(size_t)r * K + k] = x[k];
  }
}

}  // namespace

// w, pink: (rows, n) f32, row-major; state_in, state_out: (rows, K) f32 (may
// be the same buffer: a thread reads its row's state before it writes it);
// p, a: (n_tables, K) f32; row_table: (rows,) int32 table of each row, or
// null for table 0 everywhere. K <= 32.
extern "C" int maria_pink_cascade(const void* w, void* pink, const void* state_in, void* state_out, const void* p,
                                  const void* a, const void* row_table, int rows, int n, int K, void* stream) {
  if (rows < 1 || n < 1 || K < 1 || K > 32) return (int)cudaErrorInvalidValue;
  const dim3 grid((rows + kRows - 1) / kRows);
  const cudaStream_t st = (cudaStream_t)stream;
  const float* wf = (const float*)w;
  float* out = (float*)pink;
  const float* s_in = (const float*)state_in;
  float* s_out = (float*)state_out;
  const float* pf = (const float*)p;
  const float* af = (const float*)a;
  const int* tab = (const int*)row_table;
  if (K <= 8)
    pink_cascade_kernel<8><<<grid, kRows, 0, st>>>(wf, out, s_in, s_out, pf, af, tab, rows, n, K);
  else if (K <= 16)
    pink_cascade_kernel<16><<<grid, kRows, 0, st>>>(wf, out, s_in, s_out, pf, af, tab, rows, n, K);
  else
    pink_cascade_kernel<32><<<grid, kRows, 0, st>>>(wf, out, s_in, s_out, pf, af, tab, rows, n, K);
  return (int)cudaGetLastError();
}
