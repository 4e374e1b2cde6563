// The spherical-harmonic transforms' Wigner-d recursion: KS1 (synthesis)
// and KS2 (analysis).
//
// Replaces the four jax.lax.scan loops over l of maria_tpu/healpix/sht.py
// (_alm2map_fn :480, _map2alm_fn :523, _alm2map_spin_fn :579,
// _map2alm_spin_fn :634) and their CPU twin, _sht_native.cpp (sht_synth,
// sht_anal). Every (m, ring) lane runs the three-term recursion
//   d_l = (alpha z + beta) d_{l-1} - gamma d_{l-2}
// from its seed at l0 = seed_step[m], with a shared power-of-2^60
// exponent k a lane: a value above 2^30 is scaled by 2^-60 (k - 1), one
// below 2^-30 with k > 0 by 2^60 (k + 1), never up at k == 0 (small values
// there are genuine zero crossings), and a step contributes its value only
// where k == 0 (sht.py _lane_step, :243-255).
//
// Layouts (float32 unless named; all C-contiguous):
//   alpha, beta, gamma (L, L) [m][l]  recursion coefficients, zero outside l > l0(m)
//   seed_val (L, nh), seed_exp (L, nh) int32, seed_step (L,) int32, z (nh,)
//   KS1: rows (S, L, L) [s][m][l] -> acc (S, L, nh) [s][m][r]:
//        acc[s][m][r] = sum_{l >= l0(m)} rows[s][m][l] d_l(m, r)
//   KS2: h (S, L, nh) [s][m][r] -> ys (S, L, L) [s][m][l]:
//        ys[s][m][l] = sum_r d_l(m, r) h[s][m][r], for l >= l0(m) (the rest
//        is left as the caller allocated it, zeros)
//
// What bounds them on an H100. At nside 1024 and lmax 2500 (L = 2501,
// nh = 2048) a transform walks nh L (L + 1) / 2 = 6.4e9 lane-steps of the
// m <= l triangle; a step is two FMAs and a multiply of the recursion and
// one multiply-add a plane, S = 4 planes: ~13 flops, 0.083 TFLOP, 1.2 ms at the
// card's 67 TFLOP/s float32 peak. The bytes (the tables and planes read
// once, the output written once) are ~0.3 GB, 0.1 ms at 3.35 TB/s. So the
// operations bound them, and the rescale (~8 compares and selects a step,
// outside that count) sits on the same issue slots.
//
// The design is the simple one that makes the recursion right on the card:
// - KS1: one thread a lane, looping over l in registers, its S sums in
//   registers, written once at the end. A block holds one m and a run of
//   rings, so the coefficients and the rows of that m are the same address
//   for every thread (a broadcast load, each 128-byte line serving 32
//   steps, as the [m][l] layout keeps l contiguous). Lanes start at
//   l0(m), so the kernel walks only the m <= l triangle, half of the
//   rectangle the JAX scan walks. Blocks are numbered by m, so those of
//   small m, which take the most steps, are scheduled first.
// - KS2: one block of 256 threads an m; a thread keeps R = ceil(nh / 256)
//   lanes (rings tid, tid + 256, ...) and their S projections h in
//   registers. Each step a thread sums its lanes' S products, a warp
//   reduces them with shuffles, and its lane 0 parks the S sums in shared
//   memory; every 32 steps the block adds the 8 warps' sums and writes 32
//   consecutive l of each plane (coalesced), so it synchronises twice in
//   32 steps.
// The recursion and KS1's sums round every product and sum on its own
// (__fmul_rn, __fadd_rn, which the compiler does not contract into FMAs),
// as the plain torch version (ops/sht.py) does, so KS1 gives the plain
// version's acc bit for bit. The float32 recursion amplifies a rounding
// difference: at m = 0 near the pole an FMA-contracted lane drifts by
// 3e-4 of its largest value from the separately rounded one over 2,500
// steps (both lie ~1e-3 from float64; tests/test_torch_kernels.py), so
// with contraction the card could not be held to its plain version at
// 1e-5. The cost is two more FP32 instructions a step and one a plane.
// KS2's sums over rings are FMAs: their order differs from the plain
// version's anyway.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1073741824.0f;            // 2^30
constexpr float kInvBig = 1.0f / 1073741824.0f;  // 2^-30
constexpr float kDown = 8.673617379884035e-19f;  // 2^-60
constexpr float kUp = 1.152921504606847e18f;     // 2^60
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSynthThreads = 128;
constexpr int kAnalThreads = 256;
constexpr int kAnalWarps = kAnalThreads / 32;
constexpr int kChunk = 32;  // steps between KS2's block reductions

// One recursion step, rounded as the plain version rounds it:
// (a z + b) lam - g lam_prev.
__device__ __forceinline__ float step(float a, float b, float g, float z, float lam, float lam_prev) {
  return __fsub_rn(__fmul_rn(__fadd_rn(__fmul_rn(a, z), b), lam), __fmul_rn(g, lam_prev));
}

// The shared-exponent rescale of one lane; returns its contribution.
__device__ __forceinline__ float rescale(float& lam, float& lam_prev, int& k) {
  const float a = fabsf(lam);
  const bool big = a > kBig;
  const bool small = (a < kInvBig) && (k > 0);
  const float scale = big ? kDown : (small ? kUp : 1.0f);
  lam *= scale;
  lam_prev *= scale;
  k += big ? -1 : (small ? 1 : 0);
  return k == 0 ? lam : 0.0f;
}

template <int S>
__global__ void __launch_bounds__(kSynthThreads)
    sht_synth_kernel(int L, int nh, int blocks_per_m, const float* __restrict__ alpha,
                     const float* __restrict__ beta, const float* __restrict__ gamma,
                     const float* __restrict__ seed_val, const int* __restrict__ seed_exp,
                     const int* __restrict__ seed_step, const float* __restrict__ z,
                     const float* __restrict__ rows, float* __restrict__ acc) {
  const int m = blockIdx.x / blocks_per_m;
  const int r = (blockIdx.x - m * blocks_per_m) * kSynthThreads + threadIdx.x;
  if (r >= nh) return;
  const size_t ml = (size_t)m * L;
  const size_t plane = (size_t)L * L;
  const int l0 = seed_step[m];
  float out[S];
#pragma unroll
  for (int s = 0; s < S; ++s) out[s] = 0.0f;
  if (l0 < L) {
    const float zr = z[r];
    float lam = seed_val[(size_t)m * nh + r];
    float lam_prev = 0.0f;
    int k = seed_exp[(size_t)m * nh + r];
    float c = rescale(lam, lam_prev, k);
#pragma unroll
    for (int s = 0; s < S; ++s) out[s] = __fadd_rn(out[s], __fmul_rn(__ldg(rows + s * plane + ml + l0), c));
    for (int l = l0 + 1; l < L; ++l) {
      const float rec = step(__ldg(alpha + ml + l), __ldg(beta + ml + l), __ldg(gamma + ml + l), zr, lam, lam_prev);
      lam_prev = lam;
      lam = rec;
      c = rescale(lam, lam_prev, k);
#pragma unroll
      for (int s = 0; s < S; ++s) out[s] = __fadd_rn(out[s], __fmul_rn(__ldg(rows + s * plane + ml + l), c));
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) acc[(size_t)s * L * nh + (size_t)m * nh + r] = out[s];
}

template <int S, int R>
__global__ void __launch_bounds__(kAnalThreads)
    sht_anal_kernel(int L, int nh, const float* __restrict__ alpha, const float* __restrict__ beta,
                    const float* __restrict__ gamma, const float* __restrict__ seed_val,
                    const int* __restrict__ seed_exp, const int* __restrict__ seed_step,
                    const float* __restrict__ z, const float* __restrict__ h, float* __restrict__ ys) {
  __shared__ float part[kAnalWarps][S][kChunk];
  const int m = blockIdx.x;
  const int l0 = seed_step[m];
  if (l0 >= L) return;  // the whole block: no barrier is left waiting
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t ml = (size_t)m * L;
  float zr[R], lam[R], lam_prev[R], hv[S][R];
  int k[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = tid + j * kAnalThreads;
    const bool valid = r < nh;  // a lane past the last ring holds zeros and adds nothing
    zr[j] = valid ? z[r] : 0.0f;
    lam[j] = valid ? seed_val[(size_t)m * nh + r] : 0.0f;
    lam_prev[j] = 0.0f;
    k[j] = valid ? seed_exp[(size_t)m * nh + r] : 0;
#pragma unroll
    for (int s = 0; s < S; ++s) hv[s][j] = valid ? h[((size_t)s * L + m) * nh + r] : 0.0f;
  }
  for (int lb = l0; lb < L; lb += kChunk) {
    const int n = min(kChunk, L - lb);
    for (int i = 0; i < n; ++i) {
      const int l = lb + i;
      float p[S];
#pragma unroll
      for (int s = 0; s < S; ++s) p[s] = 0.0f;
      if (l > l0) {
        const float a = __ldg(alpha + ml + l), b = __ldg(beta + ml + l), g = __ldg(gamma + ml + l);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float rec = step(a, b, g, zr[j], lam[j], lam_prev[j]);
          lam_prev[j] = lam[j];
          lam[j] = rec;
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float c = rescale(lam[j], lam_prev[j], k[j]);
#pragma unroll
        for (int s = 0; s < S; ++s) p[s] = fmaf(c, hv[s][j], p[s]);
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) p[s] += __shfl_xor_sync(kFull, p[s], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int s = 0; s < S; ++s) part[warp][s][i] = p[s];
      }
    }
    __syncthreads();
    for (int t = tid; t < S * kChunk; t += kAnalThreads) {
      const int s = t / kChunk, i = t - s * kChunk;
      if (i < n) {
        float v = 0.0f;
#pragma unroll
        for (int w = 0; w < kAnalWarps; ++w) v += part[w][s][i];
        ys[((size_t)s * L + m) * L + lb + i] = v;
      }
    }
    __syncthreads();
  }
}

template <int S>
void launch_synth(int L, int nh, const float* alpha, const float* beta, const float* gamma, const float* seed_val,
                  const int* seed_exp, const int* seed_step, const float* z, const float* rows, float* acc,
                  cudaStream_t stream) {
  const int blocks_per_m = (nh + kSynthThreads - 1) / kSynthThreads;
  sht_synth_kernel<S><<<L * blocks_per_m, kSynthThreads, 0, stream>>>(
      L, nh, blocks_per_m, alpha, beta, gamma, seed_val, seed_exp, seed_step, z, rows, acc);
}

template <int S, int R>
void launch_anal_r(int L, int nh, const float* alpha, const float* beta, const float* gamma, const float* seed_val,
                   const int* seed_exp, const int* seed_step, const float* z, const float* h, float* ys,
                   cudaStream_t stream) {
  sht_anal_kernel<S, R><<<L, kAnalThreads, 0, stream>>>(L, nh, alpha, beta, gamma, seed_val, seed_exp, seed_step, z,
                                                        h, ys);
}

template <int S>
int launch_anal(int L, int nh, const float* alpha, const float* beta, const float* gamma, const float* seed_val,
                const int* seed_exp, const int* seed_step, const float* z, const float* h, float* ys,
                cudaStream_t stream) {
  const int r = (nh + kAnalThreads - 1) / kAnalThreads;
#define MARIA_ANAL_R(RR)                                                                                      \
  if (r <= RR) {                                                                                              \
    launch_anal_r<S, RR>(L, nh, alpha, beta, gamma, seed_val, seed_exp, seed_step, z, h, ys, stream);        \
    return 0;                                                                                                 \
  }
  MARIA_ANAL_R(1)
  MARIA_ANAL_R(2)
  MARIA_ANAL_R(4)
  MARIA_ANAL_R(8)
  MARIA_ANAL_R(16)
#undef MARIA_ANAL_R
  return 1;
}

}  // namespace

// The largest nh (northern rings, 2 nside) KS2 takes: 16 lanes a thread.
extern "C" int maria_sht_max_rings() { return 16 * kAnalThreads; }

extern "C" int maria_sht_synth(const void* alpha, const void* beta, const void* gamma, const void* seed_val,
                               const void* seed_exp, const void* seed_step, const void* z, const void* rows,
                               void* acc, int L, int nh, int S, void* stream) {
  if (L < 1 || nh < 1 || S < 1 || S > 8) return (int)cudaErrorInvalidValue;
  const float *a = (const float*)alpha, *b = (const float*)beta, *g = (const float*)gamma;
  const float *sv = (const float*)seed_val, *zz = (const float*)z, *rw = (const float*)rows;
  const int *se = (const int*)seed_exp, *ss = (const int*)seed_step;
  float* out = (float*)acc;
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 1: launch_synth<1>(L, nh, a, b, g, sv, se, ss, zz, rw, out, st); break;
    case 2: launch_synth<2>(L, nh, a, b, g, sv, se, ss, zz, rw, out, st); break;
    case 3: launch_synth<3>(L, nh, a, b, g, sv, se, ss, zz, rw, out, st); break;
    case 4: launch_synth<4>(L, nh, a, b, g, sv, se, ss, zz, rw, out, st); break;
    case 5: launch_synth<5>(L, nh, a, b, g, sv, se, ss, zz, rw, out, st); break;
    case 6: launch_synth<6>(L, nh, a, b, g, sv, se, ss, zz, rw, out, st); break;
    case 7: launch_synth<7>(L, nh, a, b, g, sv, se, ss, zz, rw, out, st); break;
    default: launch_synth<8>(L, nh, a, b, g, sv, se, ss, zz, rw, out, st); break;
  }
  return (int)cudaGetLastError();
}

extern "C" int maria_sht_anal(const void* alpha, const void* beta, const void* gamma, const void* seed_val,
                              const void* seed_exp, const void* seed_step, const void* z, const void* h, void* ys,
                              int L, int nh, int S, void* stream) {
  if (L < 1 || nh < 1 || nh > maria_sht_max_rings() || S < 1 || S > 8) return (int)cudaErrorInvalidValue;
  const float *a = (const float*)alpha, *b = (const float*)beta, *g = (const float*)gamma;
  const float *sv = (const float*)seed_val, *zz = (const float*)z, *hh = (const float*)h;
  const int *se = (const int*)seed_exp, *ss = (const int*)seed_step;
  float* out = (float*)ys;
  cudaStream_t st = (cudaStream_t)stream;
  int bad = 0;
  switch (S) {
    case 1: bad = launch_anal<1>(L, nh, a, b, g, sv, se, ss, zz, hh, out, st); break;
    case 2: bad = launch_anal<2>(L, nh, a, b, g, sv, se, ss, zz, hh, out, st); break;
    case 3: bad = launch_anal<3>(L, nh, a, b, g, sv, se, ss, zz, hh, out, st); break;
    case 4: bad = launch_anal<4>(L, nh, a, b, g, sv, se, ss, zz, hh, out, st); break;
    case 5: bad = launch_anal<5>(L, nh, a, b, g, sv, se, ss, zz, hh, out, st); break;
    case 6: bad = launch_anal<6>(L, nh, a, b, g, sv, se, ss, zz, hh, out, st); break;
    case 7: bad = launch_anal<7>(L, nh, a, b, g, sv, se, ss, zz, hh, out, st); break;
    default: bad = launch_anal<8>(L, nh, a, b, g, sv, se, ss, zz, hh, out, st); break;
  }
  if (bad) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
