// Detector pink noise, one inverse real DFT per detector row.
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
// Hermitian packing and the DC/Nyquist terms. The TPU kernel keeps the
// two branches separate because a reversal costs a relayout there; here
// the mirrored index is free, so both branches sum into one DFT input.
// The DFT is a two-factor Cooley-Tukey split m = n1 * n2 (n2 = 1 for
// small m): n1-point DFTs down the columns k2, a twiddle
// exp(2 pi i k2 a / m) / m, then n2-point DFTs along the rows.
//
// What bounds it on an H100: the row's m complex values stay in shared
// memory (8 m bytes; 128 KB at m = 16384, the 600 s scene), so device
// memory sees one read of S and one write of x, and the O(m (n1 + n2))
// complex multiply-adds run from shared memory: the kernel is bound by
// shared-memory bandwidth and by having only one block per SM at the
// large sizes (217 rows fill 132 SMs in two waves). A first, simple
// form: in-kernel Philox draws, register blocking of the DFT stages and
// several rows per block are later work.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(-a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(a.y, b.x, acc.y));
}

// Draw slot k of the folded spectrum: z_0 carries the real DC and
// Nyquist normals.
__device__ __forceinline__ float2 draw_slot(const float2* __restrict__ S, int k, int m) {
  return k == 0 ? make_float2(S[0].x, S[m].x) : S[k];
}

__global__ void pink_noise_kernel(const float2* __restrict__ spectrum,  // (n_det, m+1)
                                  const float2* __restrict__ alpha,     // (m,)
                                  const float2* __restrict__ gamma,     // (m,)
                                  float* __restrict__ out,              // (n_det, n)
                                  int m, int n1, int n2, int tc, int n) {
  extern __shared__ float2 smem[];
  float2* buf = smem;              // (n2, n1): stage-1 output B[k2][a], twiddled
  float2* stage = buf + m;         // (n1, tc): u[k2 + n2 k1] for tc columns k2
  float2* w1 = stage + n1 * tc;    // exp(2 pi i j / n1)
  float2* w2 = w1 + n1;            // exp(2 pi i j / n2)

  const int row = blockIdx.x;
  const float2* S = spectrum + (size_t)row * (m + 1);

  for (int j = threadIdx.x; j < n1; j += blockDim.x) {
    float s, c;
    sincospif(2.0f * (float)j / (float)n1, &s, &c);
    w1[j] = make_float2(c, s);
  }
  for (int j = threadIdx.x; j < n2; j += blockDim.x) {
    float s, c;
    sincospif(2.0f * (float)j / (float)n2, &s, &c);
    w2[j] = make_float2(c, s);
  }

  const float inv_m = 1.0f / (float)m;
  for (int c0 = 0; c0 < n2; c0 += tc) {
    const int cols = min(tc, n2 - c0);
    __syncthreads();  // tables written; previous tile's stage consumed
    for (int idx = threadIdx.x; idx < n1 * cols; idx += blockDim.x) {
      const int k1 = idx / cols, c = idx - k1 * cols;
      const int k = c0 + c + n2 * k1;
      const int kr = k == 0 ? 0 : m - k;
      const float2 a = cmul(alpha[k], draw_slot(S, k, m));
      const float2 g = cmul(gamma[kr], draw_slot(S, kr, m));
      stage[k1 * tc + c] = make_float2(a.x + g.x, a.y - g.y);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < n1 * cols; idx += blockDim.x) {
      const int c = idx / n1, a = idx - c * n1;
      const int k2 = c0 + c;
      float2 acc = make_float2(0.0f, 0.0f);
      int e = 0;  // (k1 * a) mod n1
      for (int k1 = 0; k1 < n1; ++k1) {
        cfma(acc, stage[k1 * tc + c], w1[e]);
        e += a;
        if (e >= n1) e -= n1;
      }
      float s, co;
      // k2 * a < m: k2 < n2 and a < n1
      sincospif(2.0f * (float)(k2 * a) / (float)m, &s, &co);
      buf[k2 * n1 + a] = cmul(acc, make_float2(co * inv_m, s * inv_m));
    }
  }
  __syncthreads();

  // stage 2: y[a + n1 s] = sum_k2 B[k2][a] exp(2 pi i k2 s / n2); only the
  // outputs that survive the truncation to n samples are computed
  const int t_end = min(m, (n + 1) / 2);
  float* x = out + (size_t)row * n;
  for (int t = threadIdx.x; t < t_end; t += blockDim.x) {
    const int s = t / n1, a = t - s * n1;
    float2 acc = make_float2(0.0f, 0.0f);
    int e = 0;  // (k2 * s) mod n2
    for (int k2 = 0; k2 < n2; ++k2) {
      cfma(acc, buf[k2 * n1 + a], w2[e]);
      e += s;
      if (e >= n2) e -= n2;
    }
    x[2 * t] = acc.x;
    if (2 * t + 1 < n) x[2 * t + 1] = acc.y;
  }
}

}  // namespace

extern "C" size_t maria_pink_noise_smem_bytes(int m, int n1, int n2, int tc) {
  return sizeof(float2) * ((size_t)m + (size_t)n1 * tc + n1 + n2);
}

extern "C" int maria_pink_noise(const void* spectrum, const void* alpha, const void* gamma, void* out,
                                int n_det, int m, int n1, int n2, int tc, int n, void* stream) {
  const size_t smem = maria_pink_noise_smem_bytes(m, n1, n2, tc);
  cudaError_t err = cudaFuncSetAttribute(pink_noise_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  pink_noise_kernel<<<n_det, 256, smem, (cudaStream_t)stream>>>(
      (const float2*)spectrum, (const float2*)alpha, (const float2*)gamma, (float*)out, m, n1, n2, tc, n);
  return (int)cudaGetLastError();
}

extern "C" int maria_max_dynamic_smem(int device) {
  int value = 0;
  if (cudaDeviceGetAttribute(&value, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) return -1;
  return value;
}

extern "C" const char* maria_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
