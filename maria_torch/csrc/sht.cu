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
//   coef (L, L) float4 [m][l] = (alpha, beta, gamma, 0) for l > l0(m), and
//        (0, 1, 0, 0) at l = l0(m): the seed step is a recursion step that
//        copies the seed (lam = 1 * seed - 0 * 0), so both kernels walk
//        l0..L-1 with one loop body. lam_prev then holds the seed where the
//        plain version holds 0, but gamma is 0 at l0 + 1, so the next step
//        gives the same value (up to the sign of a zero).
//   seed_val (L, nh), seed_exp (L, nh) int32, seed_step (L,) int32, z (nh,)
//   KS1: rows (L, L, 4P) [m][l][s], P = ceil(S / 4) float4 a step, planes
//        past S zero -> acc (S, L, nh) [s][m][r]:
//        acc[s][m][r] = sum_{l >= l0(m)} rows[s][m][l] d_l(m, r)
//   KS2: h (S, L, nh) [s][m][r] -> ys (S, L, L) [s][m][l]:
//        ys[s][m][l] = sum_r d_l(m, r) h[s][m][r], for l >= l0(m) (the rest
//        is left as the caller allocated it, zeros)
//
// What bounds them on an H100. At nside 1024 and lmax 2500 (L = 2501,
// nh = 2048) a transform walks nh L (L + 1) / 2 = 6.4e9 lane-steps of the
// m <= l triangle. The bytes (tables and planes read once, the output
// written once) are ~0.3 GB, 0.1 ms at 3.35 TB/s: the FP32 pipe bounds
// them. Under KS1's rounding contract (below) a lane-step is 13 separately
// rounded instructions at S = 4 (the recursion's 3 multiplies, an add and a
// subtract; a multiply and an add a plane), KS2's 9 (the same recursion and
// an FMA a plane): at 132 SMs x 128 lanes x 1.98 GHz, 2.49 ms for KS1 and
// 1.72 ms for KS2 a launch. The first form of these kernels (one thread a
// lane for KS1; a warp shuffle tree a plane and step for KS2) took 28-30 instructions a
// lane-step: 7 loads with 64-bit address arithmetic and the ~8 compares and
// selects of the rescale around KS1's 13, and in KS2 20 shuffles and 20
// adds a warp-step on top.
//
// The design:
// - A thread holds R = 1..8 consecutive rings (4 at nside 1024), so it
//   loads each step's coefficients once for its R lanes. KS1: blocks of
//   128 threads, four an m at nside 1024, so a block's slowest warp holds
//   little of the SM; KS2: one block of up to 512 threads an m (its warps
//   add their sums). Blocks are numbered by m, so those of small m, which
//   take the most steps, start first.
// - Each warp walks l in chunks of 32 steps through its own double buffer
//   in shared memory: the coefficients (and KS1's row planes) of the next
//   chunk are copied by cp.async while this one is computed, and a warp
//   waits for no other. A step reads one 16-byte broadcast (LDS.128) of
//   (alpha, beta, gamma) and, in KS1, one a four planes.
// - The rescale leaves the loop once it can no longer fire. k == 0 is
//   never left: a rescale up needs k > 0, and one down a value above 2^30,
//   while at k == 0 a lane's values are Wigner d elements, |d| <= 1 (plus
//   the float32 drift, ~1e-3): 2^30 is out of reach, so at k == 0 the
//   rescale is the identity (a scale of exactly 1, k unchanged, the
//   contribution the value itself). A warp whose lanes all have k == 0 at
//   the start of a chunk walks it with the bare recursion and sums (65% of
//   the lane-steps at nside 1024 and lmax 2500). Otherwise it tests every
//   step whether a rescale fires in the warp (two compares a lane and a
//   vote) and runs it only then, and skips the plane sums on a step where
//   none of its lanes has k == 0 (29% of the lane-steps, near the poles):
//   all contributions are +0 then, and adding +0 to a sum that has only
//   ever had +0 added leaves it bit for bit. No rounding changes, so KS1
//   stays bit-equal to the plain version (tests/test_torch_kernels.py
//   emulates the walk and checks that no rescale fires at k == 0).
// - KS1: a thread keeps S x R sums in registers and writes them once.
// - KS2: a thread sums its R lanes' products a plane (FMAs) for a group of
//   T = 16 / S' steps (S' = S rounded up to a power of two), then the warp
//   reduces its 32 x (S' T = 16) values with one transposing butterfly: 16
//   shuffle-adds, after which lanes q and q + 16 hold the total of value
//   q = s T + t, where a shuffle tree a value took 80; a group that added
//   nothing skips it. The warps' totals are parked in one half of a double
//   buffer in shared memory and added in warp order after the chunk's one
//   barrier, 32 consecutive l of each plane written at once. That barrier
//   ties a block to its slowest warp once a chunk: what holds KS2 below
//   KS1's share of its bound (PERF.md).
// The recursion and KS1's sums round every product and sum on its own
// (__fmul_rn, __fadd_rn, which the compiler does not contract into FMAs),
// as the plain torch version (ops/sht.py) does, so KS1 gives the plain
// version's acc bit for bit. The float32 recursion amplifies a rounding
// difference: at m = 0 near the pole an FMA-contracted lane drifts by
// 3e-4 of its largest value from the separately rounded one over 2,500
// steps (both lie ~1e-3 from float64; tests/test_torch_kernels.py), so
// with contraction the card could not be held to its plain version at
// 1e-5. KS2's sums over rings are FMAs: their order differs from the plain
// version's anyway.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1073741824.0f;            // 2^30
constexpr float kInvBig = 1.0f / 1073741824.0f;  // 2^-30
constexpr float kDown = 8.673617379884035e-19f;  // 2^-60
constexpr float kUp = 1.152921504606847e18f;     // 2^60
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kSynthThreads = 128;  // KS1's blocks: small, so a block's slowest warp holds little
constexpr int kSynthWarps = kSynthThreads / 32;
constexpr int kMaxLanes = 8;  // rings a thread
constexpr int kChunk = 32;    // steps a staged chunk

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

__device__ __forceinline__ float part_of(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void wait_all_but_newest() { asm volatile("cp.async.wait_group 1;\n" ::); }

// A thread's R lanes: rings r0 .. r0 + R - 1; a lane past the last ring
// holds zeros (k = 0) and adds nothing.
template <int R>
struct Lanes {
  float z[R], lam[R], lam_prev[R];
  int k[R];

  __device__ __forceinline__ void seed(int m, int r0, int nh, const float* seed_val, const int* seed_exp,
                                       const float* zz) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = r0 + j;
      const bool valid = r < nh;
      z[j] = valid ? zz[r] : 0.0f;
      lam[j] = valid ? seed_val[(size_t)m * nh + r] : 0.0f;  // the seed step copies it
      lam_prev[j] = 0.0f;
      k[j] = valid ? seed_exp[(size_t)m * nh + r] : 0;
    }
  }

  __device__ __forceinline__ void advance(const float4& c) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float rec = step(c.x, c.y, c.z, z[j], lam[j], lam_prev[j]);
      lam_prev[j] = lam[j];
      lam[j] = rec;
    }
  }

  // True if a lane of the warp has k == 0.
  __device__ __forceinline__ bool warp_contributes() const {
    bool any = false;
#pragma unroll
    for (int j = 0; j < R; ++j) any |= k[j] == 0;
    return __any_sync(kFull, any);
  }

  // The rescale of every lane, run only where it fires in the warp (where
  // it does not, it is the identity); returns warp_contributes() after it,
  // which only a rescale can change (``contributes`` before it).
  __device__ __forceinline__ bool rescale_where_due(bool contributes) {
    bool fire = false;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float a = fabsf(lam[j]);
      fire |= (a > kBig) | ((a < kInvBig) & (k[j] > 0));
    }
    if (!__any_sync(kFull, fire)) return contributes;
#pragma unroll
    for (int j = 0; j < R; ++j) rescale(lam[j], lam_prev[j], k[j]);
    return warp_contributes();
  }

  __device__ __forceinline__ float contribution(int j) const { return k[j] == 0 ? lam[j] : 0.0f; }

  __device__ __forceinline__ bool warp_settled() const {
    bool all = true;
#pragma unroll
    for (int j = 0; j < R; ++j) all &= k[j] == 0;
    return __all_sync(kFull, all);
  }
};

// Copies the n steps from l = base of the coefficients and, with P > 0,
// of the row planes into a warp's own buffer (the warp's 32 lanes).
template <int P>
__device__ __forceinline__ void stage(float4* s_coef, float4* s_rows, const float4* coef, const float4* rows,
                                      size_t ml, int base, int n, int lane) {
  for (int i = lane; i < n * (1 + P); i += 32) {
    if (i < n) {
      copy16(s_coef + i, coef + ml + base + i);
    } else if (P > 0) {
      copy16(s_rows + (i - n), rows + (ml + base) * P + (i - n));
    }
  }
}

// A warp's walk over the chunks of l0..L-1 with its own double buffer:
// the next chunk is staged while ``body(c, n, buffer)`` computes chunk c of
// n steps. Warps never wait for each other.
template <int P, typename Body>
__device__ __forceinline__ void walk_chunks(float4 (*s_coef)[kChunk], float4 (*s_rows)[kChunk * (P > 0 ? P : 1)],
                                            const float4* coef, const float4* rows, size_t ml, int l0, int L,
                                            int lane, Body body) {
  const int n_steps = L - l0;
  const int n_chunks = (n_steps + kChunk - 1) / kChunk;
  stage<P>(s_coef[0], P > 0 ? s_rows[0] : nullptr, coef, rows, ml, l0, min(kChunk, n_steps), lane);
  commit();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      const int next = (c + 1) * kChunk;
      const int b = (c + 1) & 1;
      stage<P>(s_coef[b], P > 0 ? s_rows[b] : nullptr, coef, rows, ml, l0 + next, min(kChunk, n_steps - next), lane);
    }
    commit();
    wait_all_but_newest();
    __syncwarp();
    body(c, min(kChunk, n_steps - c * kChunk), c & 1);
    __syncwarp();  // the buffer just read is the next chunk's target
  }
}

template <int S, int R>
__global__ void __launch_bounds__(kSynthThreads, (S * R <= 16) ? 8 : 4)
    sht_synth_kernel(int L, int nh, int blocks_per_m, const float4* __restrict__ coef,
                     const float* __restrict__ seed_val, const int* __restrict__ seed_exp,
                     const int* __restrict__ seed_step, const float* __restrict__ z,
                     const float4* __restrict__ rows, float* __restrict__ acc) {
  constexpr int P = (S + 3) / 4;
  __shared__ __align__(16) float4 s_coef[kSynthWarps][2][kChunk];
  __shared__ __align__(16) float4 s_rows[kSynthWarps][2][kChunk * P];
  const int m = blockIdx.x / blocks_per_m;
  const int r0 = ((blockIdx.x - m * blocks_per_m) * blockDim.x + threadIdx.x) * R;
  const int l0 = seed_step[m];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float out[S][R];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int j = 0; j < R; ++j) out[s][j] = 0.0f;
  if (l0 < L) {  // the whole block
    Lanes<R> ln;
    ln.seed(m, r0, nh, seed_val, seed_exp, z);

    // out += the step's row planes times the lanes' contributions
    auto add = [&](const float4* rw, auto contribution) {
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const float4 row = rw[q];
#pragma unroll
        for (int e = 0; e < 4 && 4 * q + e < S; ++e)
#pragma unroll
          for (int j = 0; j < R; ++j)
            out[4 * q + e][j] = __fadd_rn(out[4 * q + e][j], __fmul_rn(part_of(row, e), contribution(j)));
      }
    };
    walk_chunks<P>(s_coef[warp], s_rows[warp], coef, rows, (size_t)m * L, l0, L, lane, [&](int, int n, int b) {
      const float4* cf = s_coef[warp][b];
      const float4* rw = s_rows[warp][b];
      if (ln.warp_settled()) {
#pragma unroll 8
        for (int i = 0; i < n; ++i) {
          ln.advance(cf[i]);
          add(rw + i * P, [&](int j) { return ln.lam[j]; });
        }
      } else {
        bool contributes = ln.warp_contributes();
#pragma unroll 4
        for (int i = 0; i < n; ++i) {
          ln.advance(cf[i]);
          contributes = ln.rescale_where_due(contributes);
          if (contributes) add(rw + i * P, [&](int j) { return ln.contribution(j); });
        }
      }
    });
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = r0 + j;
    if (r < nh) {
#pragma unroll
      for (int s = 0; s < S; ++s) acc[(size_t)s * L * nh + (size_t)m * nh + r] = out[s][j];
    }
  }
}

__host__ __device__ constexpr int pow2_at_least(int s) { return s <= 1 ? 1 : (s <= 2 ? 2 : (s <= 4 ? 4 : 8)); }

// One level of the warp's transposing butterfly: a lane keeps the half of
// its 2 HALF values that its lane bit HALF selects, and adds its partner's.
template <int HALF>
__device__ __forceinline__ void butterfly_level(float (&v)[16], int lane) {
  const bool upper = lane & HALF;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, HALF);
  }
}

// The warp's transposing butterfly: v[16] a lane in, the warp's total of
// value (lane mod 16) out, on both half-warps (lanes combined by bit 3,
// 2, 1, 0 within a half-warp, then the two halves): 16 shuffle-adds.
__device__ __forceinline__ float butterfly(float (&v)[16], int lane) {
  butterfly_level<8>(v, lane);
  butterfly_level<4>(v, lane);
  butterfly_level<2>(v, lane);
  butterfly_level<1>(v, lane);
  return v[0] + __shfl_xor_sync(kFull, v[0], 16);
}

template <int S, int R>
__global__ void __launch_bounds__(kMaxThreads, (S * R <= 16) ? 2 : 1)
    sht_anal_kernel(int L, int nh, const float4* __restrict__ coef, const float* __restrict__ seed_val,
                    const int* __restrict__ seed_exp, const int* __restrict__ seed_step,
                    const float* __restrict__ z, const float* __restrict__ h, float* __restrict__ ys) {
  constexpr int T = 16 / pow2_at_least(S);  // steps a group: 16 values a lane, 2 to 16 steps
  __shared__ __align__(16) float4 s_coef[kMaxWarps][2][kChunk];
  // the warps' totals of the chunk in one half, of the one before in the other; + 1: a group's totals land in
  // distinct banks (left out at S > 4, to stay within 48 KB)
  __shared__ float part[2][kMaxWarps][S][kChunk + (S <= 4 ? 1 : 0)];
  const int m = blockIdx.x;
  const int l0 = seed_step[m];
  if (l0 >= L) return;  // the whole block: no barrier is left waiting
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  const int r0 = tid * R;
  Lanes<R> ln;
  ln.seed(m, r0, nh, seed_val, seed_exp, z);
  float hv[S][R];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int j = 0; j < R; ++j) hv[s][j] = r0 + j < nh ? h[((size_t)s * L + m) * nh + r0 + j] : 0.0f;
  // the value this lane's butterfly ends with: plane s_mine of a group's step t_mine
  const int s_mine = (lane & 15) / T, t_mine = (lane & 15) - s_mine * T;
  walk_chunks<0>(s_coef[warp], nullptr, coef, nullptr, (size_t)m * L, l0, L, lane, [&](int c, int n, int b) {
    const float4* cf = s_coef[warp][b];
    const bool settled = ln.warp_settled();
    bool contributes = ln.warp_contributes();
    for (int g = 0; g < n; g += T) {
      bool added = settled;  // a step of the group added a product: else every total is 0
      float v[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) v[q] = 0.0f;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        if (g + t < n) {  // the same for the whole warp
          ln.advance(cf[g + t]);
          if (settled) {
#pragma unroll
            for (int j = 0; j < R; ++j)
#pragma unroll
              for (int s = 0; s < S; ++s) v[s * T + t] = fmaf(ln.lam[j], hv[s][j], v[s * T + t]);
          } else {
            contributes = ln.rescale_where_due(contributes);
            added |= contributes;
            if (contributes) {
#pragma unroll
              for (int j = 0; j < R; ++j)
#pragma unroll
                for (int s = 0; s < S; ++s) v[s * T + t] = fmaf(ln.contribution(j), hv[s][j], v[s * T + t]);
            }
          }
        }
      }
      const float total = added ? butterfly(v, lane) : 0.0f;
      if (lane < 16 && s_mine < S && g + t_mine < n) part[c & 1][warp][s_mine][g + t_mine] = total;
    }
    __syncthreads();  // one barrier a chunk: the next chunk's totals go to the other half
    const int base = c * kChunk;
    for (int i = tid; i < S * n; i += blockDim.x) {
      const int s = i / n, l = i - s * n;
      float sum = 0.0f;
      for (int w = 0; w < n_warps; ++w) sum += part[c & 1][w][s][l];
      ys[((size_t)s * L + m) * L + l0 + base + l] = sum;
    }
  });
}

// Rings a thread and threads a block for nh rings: R the least of 1, 2,
// 4, 8 that covers nh with 512 threads (8 past 4096 rings), the threads a
// multiple of 32.
void plan(int nh, int* R, int* threads) {
  int r = 1;
  while (r < kMaxLanes && r * kMaxThreads < nh) r *= 2;
  const int t = (nh + r - 1) / r;
  *R = r;
  *threads = t >= kMaxThreads ? kMaxThreads : (t + 31) / 32 * 32;
}

template <int S, int R>
void launch_synth_r(int L, int nh, int threads, const float4* coef, const float* seed_val, const int* seed_exp,
                    const int* seed_step, const float* z, const float4* rows, float* acc, cudaStream_t stream) {
  threads = threads < kSynthThreads ? threads : kSynthThreads;
  const int blocks_per_m = (nh + threads * R - 1) / (threads * R);
  sht_synth_kernel<S, R><<<L * blocks_per_m, threads, 0, stream>>>(L, nh, blocks_per_m, coef, seed_val, seed_exp,
                                                                  seed_step, z, rows, acc);
}

template <int S>
void launch_synth(int L, int nh, const float4* coef, const float* seed_val, const int* seed_exp,
                  const int* seed_step, const float* z, const float4* rows, float* acc, cudaStream_t stream) {
  int R, threads;
  plan(nh, &R, &threads);
  switch (R) {
    case 1: launch_synth_r<S, 1>(L, nh, threads, coef, seed_val, seed_exp, seed_step, z, rows, acc, stream); break;
    case 2: launch_synth_r<S, 2>(L, nh, threads, coef, seed_val, seed_exp, seed_step, z, rows, acc, stream); break;
    case 4: launch_synth_r<S, 4>(L, nh, threads, coef, seed_val, seed_exp, seed_step, z, rows, acc, stream); break;
    default: launch_synth_r<S, 8>(L, nh, threads, coef, seed_val, seed_exp, seed_step, z, rows, acc, stream); break;
  }
}

template <int S>
void launch_anal(int L, int nh, const float4* coef, const float* seed_val, const int* seed_exp,
                 const int* seed_step, const float* z, const float* h, float* ys, cudaStream_t stream) {
  int R, threads;
  plan(nh, &R, &threads);
#define MARIA_ANAL_R(RR)                                                                                 \
  case RR:                                                                                               \
    sht_anal_kernel<S, RR><<<L, threads, 0, stream>>>(L, nh, coef, seed_val, seed_exp, seed_step, z, h, ys); \
    break;
  switch (R) {
    MARIA_ANAL_R(1)
    MARIA_ANAL_R(2)
    MARIA_ANAL_R(4)
    MARIA_ANAL_R(8)
  }
#undef MARIA_ANAL_R
}

}  // namespace

// The largest nh (northern rings, 2 nside) KS2 takes: one block of 512
// threads, 8 lanes a thread.
extern "C" int maria_sht_max_rings() { return kMaxLanes * kMaxThreads; }

extern "C" int maria_sht_synth(const void* coef, const void* seed_val, const void* seed_exp, const void* seed_step,
                               const void* z, const void* rows, void* acc, int L, int nh, int S, void* stream) {
  if (L < 1 || nh < 1 || S < 1 || S > 8) return (int)cudaErrorInvalidValue;
  const float4 *cf = (const float4*)coef, *rw = (const float4*)rows;
  const float *sv = (const float*)seed_val, *zz = (const float*)z;
  const int *se = (const int*)seed_exp, *ss = (const int*)seed_step;
  float* out = (float*)acc;
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 1: launch_synth<1>(L, nh, cf, sv, se, ss, zz, rw, out, st); break;
    case 2: launch_synth<2>(L, nh, cf, sv, se, ss, zz, rw, out, st); break;
    case 3: launch_synth<3>(L, nh, cf, sv, se, ss, zz, rw, out, st); break;
    case 4: launch_synth<4>(L, nh, cf, sv, se, ss, zz, rw, out, st); break;
    case 5: launch_synth<5>(L, nh, cf, sv, se, ss, zz, rw, out, st); break;
    case 6: launch_synth<6>(L, nh, cf, sv, se, ss, zz, rw, out, st); break;
    case 7: launch_synth<7>(L, nh, cf, sv, se, ss, zz, rw, out, st); break;
    default: launch_synth<8>(L, nh, cf, sv, se, ss, zz, rw, out, st); break;
  }
  return (int)cudaGetLastError();
}

extern "C" int maria_sht_anal(const void* coef, const void* seed_val, const void* seed_exp, const void* seed_step,
                              const void* z, const void* h, void* ys, int L, int nh, int S, void* stream) {
  if (L < 1 || nh < 1 || nh > maria_sht_max_rings() || S < 1 || S > 8) return (int)cudaErrorInvalidValue;
  const float4* cf = (const float4*)coef;
  const float *sv = (const float*)seed_val, *zz = (const float*)z, *hh = (const float*)h;
  const int *se = (const int*)seed_exp, *ss = (const int*)seed_step;
  float* out = (float*)ys;
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 1: launch_anal<1>(L, nh, cf, sv, se, ss, zz, hh, out, st); break;
    case 2: launch_anal<2>(L, nh, cf, sv, se, ss, zz, hh, out, st); break;
    case 3: launch_anal<3>(L, nh, cf, sv, se, ss, zz, hh, out, st); break;
    case 4: launch_anal<4>(L, nh, cf, sv, se, ss, zz, hh, out, st); break;
    case 5: launch_anal<5>(L, nh, cf, sv, se, ss, zz, hh, out, st); break;
    case 6: launch_anal<6>(L, nh, cf, sv, se, ss, zz, hh, out, st); break;
    case 7: launch_anal<7>(L, nh, cf, sv, se, ss, zz, hh, out, st); break;
    default: launch_anal<8>(L, nh, cf, sv, se, ss, zz, hh, out, st); break;
  }
  return (int)cudaGetLastError();
}
