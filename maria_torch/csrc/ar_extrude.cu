// The autoregressive atmosphere's extrusion loop, one block a process.
//
// Replaces maria_tpu/atmosphere/process.py::_ar_extrude_noise, a
// lax.scan on the TPU (not a Pallas kernel). For each process, a buffer
// of (n_extrusion + n_steps) x n_cross floats starts as white noise and
// its rows b = n_steps - 1, ..., 0 are filled in turn:
//   row_b = A @ buffer[b + ext_idx + 1, cross_idx] + B @ eps_i,
//   i = n_steps - 1 - b,
// with A (n_cross x n_sample), B (n_cross x n_cross, lower triangular: a
// Cholesky factor) and the innovations eps (n_steps x n_cross), read
// newest-row-first as the scan reads them. The gather offsets
// goff[s] = (ext_idx[s] + 1) n_cross + cross_idx[s] are built on the host
// (ops/ar_extrude.py), so sample s of step b is buffer[b n_cross + goff[s]].
//
// What bounds it on an H100: each step depends on rows the previous steps
// wrote, so a process is a chain of n_steps = 2 n_extrusion dependent
// steps (348 at the MUSTANG-2 60 s scene's longest process, 3,372 at
// 600 s, 418 at the AtLAST-50k 3-D process), each a gather, one
// n_cross x (n_sample + n_cross) matrix-vector product and a row write.
// Neither bytes nor operations bound it: the operators are at most 0.8 MB
// and a step's product at most 0.2 MFMA. The chain's latency does. As
// plain torch a step is about five launches; here a realization's
// processes run side by side as the blocks of one launch, and a step
// costs two block barriers, one global gather and one dot a warp.
//
// Design (a simple, right first form):
// - one block a process, a warp an output row (rows strided over the
//   warps), its lanes striding the row's A and B entries; a shuffle
//   reduction, and lane 0 writes the row;
// - A and B's lower triangle staged in shared memory when they fit (every
//   2-D process: at most 132 KB), otherwise read through L2 (the 3-D
//   process, 0.77 MB);
// - the gather offsets and each step's lookback samples and innovations
//   in shared memory;
// - the buffer stays in device memory: its rows are read back, after a
//   barrier, by the next steps of the same block.
// Later forms (ROADMAP): splitting the 3-D process over a thread-block
// cluster, so its operators live in distributed shared memory, and a
// ring of the last n_extrusion rows in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kDescInts = 10;
constexpr int kThreadsMax = 1024;

// One process of a launch: offsets (in elements) of its A, B, gather
// offsets, buffer and innovations in the flat arrays, its sizes, and
// whether its operators are staged in shared memory.
struct Desc {
  int a_off, b_off, g_off, buf_off, noise_off, n_cross, n_sample, n_steps, staged;
};

__device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <bool kStaged>
__device__ void extrude(const Desc& d, const float* __restrict__ A, const float* __restrict__ B,
                        const int* __restrict__ goff, float* buffer, const float* __restrict__ noise, float* smem) {
  const int n_cross = d.n_cross, n_sample = d.n_sample, n_steps = d.n_steps;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  // shared memory: samples, innovations, gather offsets, then A and B
  float* sample = smem;
  float* eps = sample + pad4(n_sample);
  int* g = reinterpret_cast<int*>(eps + pad4(n_cross));
  float* a_s = reinterpret_cast<float*>(g + pad4(n_sample));
  float* b_s = a_s + n_cross * n_sample;
  for (int s = tid; s < n_sample; s += blockDim.x) g[s] = goff[s];
  if (kStaged) {
    for (int k = tid; k < n_cross * n_sample; k += blockDim.x) a_s[k] = A[k];
    for (int r = warp; r < n_cross; r += n_warps)
      for (int j = lane; j <= r; j += 32) b_s[r * n_cross + j] = B[r * n_cross + j];
  }
  const float* a_rows = kStaged ? a_s : A;
  const float* b_rows = kStaged ? b_s : B;
  __syncthreads();

  for (int i = 0; i < n_steps; ++i) {
    float* row = buffer + (long long)(n_steps - 1 - i) * n_cross;
    const float* eps_i = noise + (long long)i * n_cross;
    for (int t = tid; t < n_sample + n_cross; t += blockDim.x) {
      if (t < n_sample) sample[t] = row[g[t]];
      else eps[t - n_sample] = eps_i[t - n_sample];
    }
    __syncthreads();
    for (int r = warp; r < n_cross; r += n_warps) {
      const float* ar = a_rows + r * n_sample;
      const float* br = b_rows + r * n_cross;
      float acc = 0.f;
      for (int s = lane; s < n_sample; s += 32) acc = fmaf(ar[s], sample[s], acc);
      for (int j = lane; j <= r; j += 32) acc = fmaf(br[j], eps[j], acc);
      acc = warp_sum(acc);
      if (lane == 0) row[r] = acc;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreadsMax) ar_extrude_kernel(const int* __restrict__ desc,
                                                                 const float* __restrict__ A,
                                                                 const float* __restrict__ B,
                                                                 const int* __restrict__ goff, float* buffer,
                                                                 const float* __restrict__ noise) {
  extern __shared__ float smem[];
  const int* q = desc + blockIdx.x * kDescInts;
  const Desc d{q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8]};
  if (d.staged)
    extrude<true>(d, A + d.a_off, B + d.b_off, goff + d.g_off, buffer + d.buf_off, noise + d.noise_off, smem);
  else
    extrude<false>(d, A + d.a_off, B + d.b_off, goff + d.g_off, buffer + d.buf_off, noise + d.noise_off, smem);
}

// Probes of the two latencies a step of the loop cannot avoid, for the
// kernel's bound: a chain of dependent FMAs in one warp, and a loop of
// block barriers in a block of the kernel's size.
__global__ void fma_chain_kernel(float* out, int iters, float a, float b) {
  float x = out[threadIdx.x];
#pragma unroll 16
  for (int k = 0; k < iters; ++k) x = fmaf(x, a, b);
  out[threadIdx.x] = x;
}

__global__ void barrier_loop_kernel(float* out, int iters) {
#pragma unroll 16
  for (int k = 0; k < iters; ++k) __syncthreads();
  if (threadIdx.x == 0) out[0] = (float)iters;
}

}  // namespace

extern "C" int maria_ar_extrude(const void* desc, int n_proc, const void* A, const void* B, const void* goff,
                                void* buffer, const void* noise, int threads, int smem_bytes, void* stream) {
  if (n_proc < 1 || threads < 32 || threads > kThreadsMax || (threads & 31) || smem_bytes < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute((const void*)ar_extrude_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  ar_extrude_kernel<<<n_proc, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const int*)desc, (const float*)A, (const float*)B, (const int*)goff, (float*)buffer, (const float*)noise);
  return (int)cudaGetLastError();
}

// mode 0: `iters` dependent FMAs in each of 32 threads (out holds 32
// floats); mode 1: `iters` barriers in a block of `threads`.
extern "C" int maria_ar_probe(int mode, int iters, int threads, void* out, void* stream) {
  if (iters < 1 || threads < 32 || threads > kThreadsMax || (threads & 31)) return (int)cudaErrorInvalidValue;
  if (mode == 0)
    fma_chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((float*)out, iters, 0.999999f, 1e-7f);
  else
    barrier_loop_kernel<<<1, threads, 0, (cudaStream_t)stream>>>((float*)out, iters);
  return (int)cudaGetLastError();
}
