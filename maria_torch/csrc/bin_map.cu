// Map binning: out[c, p] = sum of data[c, i] over samples i with pixel p.
//
// Replaces maria_tpu/ops/pallas_binning.py::bin_blocked_pallas (_kernel),
// which builds one-hot y/x hats in VMEM and contracts them on the MXU
// because a TPU has no fast scatter. Hopper has fast global atomics, so
// the natural form is a scatter-add: a grid-stride loop over the samples,
// one atomicAdd per (sample, channel), skipping pixel ids outside
// [0, n_pix) (-1 marks a sample off the map).
//
// What bounds it on an H100: each sample reads 4 bytes of id plus 4 per
// channel and issues one atomic per channel; the daisy scan piles many
// detectors onto few pixels, so atomics to the same address serialize in
// L2. A first, simple form: shared-memory privatisation of the map and
// warp aggregation of equal ids are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void bin_map_kernel(const float* __restrict__ data,  // (n_channels, n_samples)
                               const int* __restrict__ ids,     // (n_samples,)
                               float* __restrict__ out,         // (n_channels, n_pix), zeroed
                               long long n_samples, int n_channels, int n_pix) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_samples; i += stride) {
    const int p = ids[i];
    if (p < 0 || p >= n_pix) continue;
    for (int c = 0; c < n_channels; ++c) {
      atomicAdd(out + (size_t)c * n_pix + p, data[(size_t)c * n_samples + i]);
    }
  }
}

}  // namespace

extern "C" int maria_bin_map(const void* data, const void* ids, void* out, long long n_samples,
                             int n_channels, int n_pix, int n_blocks, void* stream) {
  bin_map_kernel<<<n_blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)data, (const int*)ids, (float*)out, n_samples, n_channels, n_pix);
  return (int)cudaGetLastError();
}
