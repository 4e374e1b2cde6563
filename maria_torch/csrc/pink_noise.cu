// Detector pink noise, one inverse real FFT per detector row.
//
// Replaces maria_tpu/ops/pallas_noise.py::pink_noise_pallas (its
// _split_kernel / _single_kernel bodies): x = irfft(c * S, n_fft)[:, :n]
// for a real half-spectrum amplitude c (m+1 values, m = n_fft/2) and a
// per-detector draw S of m+1 complex unit normals (DC and Nyquist real).
//
// Math (the TPU kernel's folded transform, pink_consts): with z_k = S_k
// for 0 < k < m and the two real edge normals packed into z_0 =
// (Re S_0, Re S_m), the irfft is ONE m-point complex inverse DFT,
//   y = ifft_m(u),  u_k = alpha_k z_k + conj(gamma_{m-k} z_{m-k}),
//   x[2t] = Re y_t,  x[2t+1] = Im y_t,
// where alpha and gamma (host-built in ops/pink_noise.py) fold the
// Hermitian packing and the DC/Nyquist terms. The mirrored index is free
// here, so both branches sum into one FFT input as it is loaded.
//
// Design: one building block, a batched short FFT of length L = r 2^q
// (r in {1, 3, 5, 9}, the odd parts good_fft_size yields) in shared
// memory: one direct r-point stage, then radix-4 stages and a last
// radix-2 stage where q is odd, in Stockham order (each stage reads one
// ping-pong buffer and writes the other, and the result comes out in
// natural order, so no bit reversal), twiddles from a table of
// exp(2 pi i j / L) built per block with sincospif. ops/pink_noise.py's
// pink_plan lays a row out:
// - one pass (m small): a block loads a row, folding as it loads, runs
//   the m-point FFT and writes x;
// - two passes (m = n1 * n2, k = k2 + n2 k1, t = a + n1 s): pass 1 takes
//   a tile of consecutive columns k2 (contiguous runs of S), folds on
//   load, runs n1-point FFTs down k1, multiplies by exp(2 pi i k2 a / m)
//   / m and writes B (n_det, n2, n1) to a device scratch; pass 2 takes a
//   tile of consecutive a, runs n2-point FFTs down k2 and writes x[2t],
//   x[2t+1] for t < ceil(n/2) only.
//
// What bounds it on an H100: a row no longer lives in one block, so the
// length has no shared-memory limit. One pass (up to m = 9216, 24 m bytes
// a block) saves the scratch round trip; two-pass blocks keep to 48 KB,
// several to an SM. The FFT is O(m log m) a row; device memory sees S
// (the mirror read mostly from L2), B written and read once and x once:
// ~111 MB at 217 x 30,000 samples, which the two passes move at ~0.9 TB/s,
// under a third of the card's bandwidth. So the bound is inside a block:
// integer index arithmetic and a sincospif per element, and a barrier
// after each of the 4-6 stages at 24-32 resident warps an SM (which of
// these leads is not measured). Register-blocked stages (fewer barriers),
// in-kernel Philox draws, TMA and clusters are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreadsMax = 256;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }

__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(-a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(a.y, b.x, acc.y));
}

// Draw slot k of the folded spectrum: z_0 carries the real DC and
// Nyquist normals.
__device__ __forceinline__ float2 draw_slot(const float2* __restrict__ S, int k, int m) {
  return k == 0 ? make_float2(S[0].x, S[m].x) : S[k];
}

// v_k = sum_j a_j exp(2 pi i j k / R); W^e = exp(2 pi i e / R) = tw[e * L/R].
template <int R>
__device__ __forceinline__ void dft(const float2 (&a)[R], float2 (&v)[R], const float2* tw, int nR) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    float2 acc = a[0];
#pragma unroll
    for (int j = 1; j < R; ++j) cfma(acc, a[j], tw[((j * k) % R) * nR]);
    v[k] = acc;
  }
}

template <>
__device__ __forceinline__ void dft<2>(const float2 (&a)[2], float2 (&v)[2], const float2*, int) {
  v[0] = cadd(a[0], a[1]);
  v[1] = csub(a[0], a[1]);
}

template <>
__device__ __forceinline__ void dft<4>(const float2 (&a)[4], float2 (&v)[4], const float2*, int) {
  const float2 t0 = cadd(a[0], a[2]), t1 = csub(a[0], a[2]);
  const float2 t2 = cadd(a[1], a[3]), t3 = csub(a[1], a[3]);
  const float2 it3 = make_float2(-t3.y, t3.x);  // i * t3 (inverse transform: W_4 = +i)
  v[0] = cadd(t0, t2);
  v[1] = cadd(t1, it3);
  v[2] = csub(t0, t2);
  v[3] = csub(t1, it3);
}

// One radix-R Stockham stage over T interleaved sequences of length L,
// element j of sequence b at x[j * ld + b]. With s the product of the
// earlier stages' radices (n = L / s the current sub-length, n/R = L/(R s)
// butterflies in each of the s sub-transforms), butterfly (p, q) reads
// x[q + s (p + j n/R)] and writes y[q + s (R p + k)], times w_n^{p k}.
template <int R>
__device__ void stage(const float2* __restrict__ x, float2* __restrict__ y, const float2* __restrict__ tw,
                      int L, int s, int T, int ld) {
  const int nR = L / R;
  for (int item = threadIdx.x; item < nR * T; item += blockDim.x) {
    const int i = item / T, b = item - i * T;  // i = p s + q
    const int p = i / s, q = i - p * s;
    float2 a[R], v[R];
#pragma unroll
    for (int j = 0; j < R; ++j) a[j] = x[(i + j * nR) * ld + b];
    dft<R>(a, v, tw, nR);
    float2* out = y + (q + s * R * p) * ld + b;
    out[0] = v[0];
#pragma unroll
    for (int k = 1; k < R; ++k) out[k * s * ld] = cmul(v[k], tw[p * k * s]);  // w_n^{pk} = w_L^{pks}
  }
}

// T unscaled inverse DFTs of length L = r 2^q from x (the caller has
// synchronised after filling x and tw); returns the buffer holding the
// result, in natural order, element j of sequence b at [j * ld + b].
__device__ float2* fft_batch(float2* x, float2* y, const float2* tw, int L, int r, int T, int ld) {
  int s = 1;
  auto next = [&](int R) {
    float2* t = x;
    x = y;
    y = t;
    s *= R;
    __syncthreads();
  };
  if (r == 3) {
    stage<3>(x, y, tw, L, s, T, ld);
    next(3);
  } else if (r == 5) {
    stage<5>(x, y, tw, L, s, T, ld);
    next(5);
  } else if (r == 9) {
    stage<9>(x, y, tw, L, s, T, ld);
    next(9);
  }
  while (L / s >= 4) {
    stage<4>(x, y, tw, L, s, T, ld);
    next(4);
  }
  if (L / s == 2) {
    stage<2>(x, y, tw, L, s, T, ld);
    next(2);
  }
  return x;
}

__device__ void build_twiddles(float2* tw, int L) {
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    float s, c;
    sincospif(2.0f * (float)j / (float)L, &s, &c);
    tw[j] = make_float2(c, s);
  }
}

__host__ __device__ inline int odd_part(int L) {
  while (L % 2 == 0) L /= 2;
  return L;
}

__host__ __device__ inline int leading(int T) { return T + (T > 1); }

__host__ __device__ inline size_t fft_smem_bytes(int L, int T) {
  return sizeof(float2) * (2 * (size_t)L * leading(T) + L);
}

// Pass 1 (or the only pass): block = (row, tile of T columns k2 from c0).
__global__ void __launch_bounds__(kThreadsMax)
pink_pass1_kernel(const float2* __restrict__ spectrum,  // (n_det, m+1)
                  const float2* __restrict__ alpha,     // (m,)
                  const float2* __restrict__ gamma,     // (m,)
                  float2* __restrict__ scratch,         // (n_det, n2, n1): B; unused in one pass
                  float* __restrict__ out,              // (n_det, n)
                  int m, int n1, int n2, int T, int n) {
  extern __shared__ float2 smem[];
  const int ld = leading(T);
  float2* x = smem;
  float2* y = x + n1 * ld;
  float2* tw = y + n1 * ld;
  const int tiles = n2 / T;
  const int row = blockIdx.x / tiles;
  const int c0 = (blockIdx.x - row * tiles) * T;
  const float2* S = spectrum + (size_t)row * (m + 1);

  build_twiddles(tw, n1);
  for (int idx = threadIdx.x; idx < n1 * T; idx += blockDim.x) {
    const int k1 = idx / T, c = idx - k1 * T;
    const int k = c0 + c + n2 * k1;
    const int kr = k == 0 ? 0 : m - k;
    const float2 a = cmul(alpha[k], draw_slot(S, k, m));
    const float2 g = cmul(gamma[kr], draw_slot(S, kr, m));
    x[k1 * ld + c] = make_float2(a.x + g.x, a.y - g.y);
  }
  __syncthreads();
  const float2* res = fft_batch(x, y, tw, n1, odd_part(n1), T, ld);

  const float inv_m = 1.0f / (float)m;
  if (n2 == 1) {  // one pass: y_t = res[t] / m
    const int t_end = min(m, (n + 1) / 2);
    float* xo = out + (size_t)row * n;
    for (int t = threadIdx.x; t < t_end; t += blockDim.x) {
      const float2 v = res[t];
      xo[2 * t] = v.x * inv_m;
      if (2 * t + 1 < n) xo[2 * t + 1] = v.y * inv_m;
    }
    return;
  }
  float2* B = scratch + (size_t)row * m;
  for (int idx = threadIdx.x; idx < n1 * T; idx += blockDim.x) {
    const int c = idx / n1, a = idx - c * n1;
    const int k2 = c0 + c;
    float s, co;
    sincospif(2.0f * (float)(k2 * a) / (float)m, &s, &co);  // k2 a < m: exact in float below 2^24
    B[k2 * n1 + a] = cmul(res[a * ld + c], make_float2(co * inv_m, s * inv_m));
  }
}

// Pass 2: block = (row, tile of T consecutive a from a0); n2-point FFTs
// down k2, then y[a + n1 s] -> x[2t], x[2t+1] for t < ceil(n/2).
__global__ void __launch_bounds__(kThreadsMax)
pink_pass2_kernel(const float2* __restrict__ scratch, float* __restrict__ out, int m, int n1, int n2, int T, int n) {
  extern __shared__ float2 smem[];
  const int ld = leading(T);
  float2* x = smem;
  float2* y = x + n2 * ld;
  float2* tw = y + n2 * ld;
  const int tiles = n1 / T;
  const int row = blockIdx.x / tiles;
  const int a0 = (blockIdx.x - row * tiles) * T;
  const float2* B = scratch + (size_t)row * m;

  build_twiddles(tw, n2);
  for (int idx = threadIdx.x; idx < n2 * T; idx += blockDim.x) {
    const int k2 = idx / T, c = idx - k2 * T;
    x[k2 * ld + c] = B[k2 * n1 + a0 + c];
  }
  __syncthreads();
  const float2* res = fft_batch(x, y, tw, n2, odd_part(n2), T, ld);

  const int t_end = min(m, (n + 1) / 2);
  float* xo = out + (size_t)row * n;
  for (int idx = threadIdx.x; idx < n2 * T; idx += blockDim.x) {
    const int s = idx / T, c = idx - s * T;
    const int t = a0 + c + n1 * s;
    if (t < t_end) {
      const float2 v = res[s * ld + c];
      xo[2 * t] = v.x;
      if (2 * t + 1 < n) xo[2 * t + 1] = v.y;
    }
  }
}

bool radix_ok(int L) {
  const int r = odd_part(L);
  return r == 1 || r == 3 || r == 5 || r == 9;
}

cudaError_t launch(const void* kernel, int blocks, int threads, size_t smem, void** args, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernel(kernel, dim3(blocks), dim3(threads), args, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// One pass when n2 == 1 (n1 == m, t1 == 1), else two; t1 columns a
// pass-1 block, t2 a pass-2 block (ops/pink_noise.py: pink_plan).
extern "C" int maria_pink_noise(const void* spectrum, const void* alpha, const void* gamma, void* scratch,
                                void* out, int n_det, int m, int n1, int n2, int t1, int t2, int threads, int n,
                                void* stream) {
  const bool two_pass = n2 > 1;
  if ((long long)n1 * n2 != m || !radix_ok(n1) || !radix_ok(n2) || t1 < 1 || t2 < 1 || n2 % t1 ||
      (two_pass && (n1 % t2 || scratch == nullptr)) || threads < 1 || threads > kThreadsMax ||
      (long long)n_det * (n2 / t1) > 0x7fffffff || (long long)n_det * (n1 / t2) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  void* args1[] = {(void*)&spectrum, (void*)&alpha, (void*)&gamma, &scratch, &out, &m, &n1, &n2, &t1, &n};
  cudaError_t err = launch((const void*)pink_pass1_kernel, n_det * (n2 / t1), threads, fft_smem_bytes(n1, t1),
                           args1, st);
  if (err != cudaSuccess || !two_pass) return (int)err;
  void* args2[] = {&scratch, &out, &m, &n1, &n2, &t2, &n};
  return (int)launch((const void*)pink_pass2_kernel, n_det * (n1 / t2), threads, fft_smem_bytes(n2, t2), args2, st);
}

extern "C" int maria_max_dynamic_smem(int device) {
  int value = 0;
  if (cudaDeviceGetAttribute(&value, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) return -1;
  return value;
}

extern "C" const char* maria_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
