// Map binning: out[s, p] = sum of data[s, i] over samples i with pixel p,
// for each channel s, and optionally a last row of hit counts.
//
// Replaces maria_tpu/ops/pallas_binning.py::bin_blocked_pallas (_kernel),
// which builds one-hot y/x hats in VMEM and contracts them on the MXU
// because a TPU has no fast scatter. Hopper scatters with atomics; what
// bounds a scatter there is contention: samples are detector-major, a
// detector stays in one pixel for ~5 samples, and the daisy piles
// thousands of detectors onto the central pixels, so one global atomic
// per (sample, channel) serialises in L2. This kernel removes most of
// them twice over:
//
// - Warp aggregation. A warp takes 32 consecutive samples; a lane whose id
//   differs from the previous lane's starts a segment. A segmented
//   inclusive sum over the warp leaves each segment's total in its last
//   lane, which alone adds it: log2 of the longest segment shuffle steps
//   (three for the scans' ~5-sample runs, at most five), done for a
//   warp's four loaded steps and all its channels together, so their
//   shuffle latencies overlap. Ids outside
//   [0, n_pix) (-1 marks off-map samples) form segments that add nothing.
//   The hit count of a segment is its length, with no channel read.
// - Shared-memory privatisation (kShared). Each block bins its own range of
//   samples into a private copy of its slots' maps in dynamic shared memory
//   (counts as exact integers), then adds each nonzero pixel to the output
//   with one global atomic. Slots (the channels, then the count) are split
//   over blockIdx.y when they do not fit one block; when one slot alone does
//   not fit, the same aggregated atomics go straight to the output.
//
// ops/bin_map.py::bin_plan chooses the form, the slots a block, the blocks
// and each block's range of samples. What bounds it on an H100: each sample
// reads 4 bytes of id and 4 a channel, once (1.2 GB for the total and its
// count at the AtLAST-50k scene: 0.36 ms at 3.35 TB/s).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 4;    // 32-sample steps a warp loads before it adds them
constexpr int kMaxSlots = 4;  // slots a block bins (ops/bin_map.py: MAX_SLOTS)
constexpr int kDevices = 16;  // devices whose shared-memory limits are remembered

// data (n_channels, n_samples) f32, ids (n_samples,) i32, out (n_slots, n_pix)
// f32 zeroed, n_slots = n_channels plus one for the count. Block (x, y)
// bins samples [x span, (x + 1) span) into kCh channel slots from
// slot0 = slot_base + y per, then the count slot if kCount. The slots a
// block holds are template arguments, so a block's loop carries no
// branch or address arithmetic for slots it does not hold.
template <bool kShared, int kCh, bool kCount>
__global__ void __launch_bounds__(1024) bin_map_kernel(const float* __restrict__ data, const int* __restrict__ ids,
                                                       float* __restrict__ out, long long n_samples, long long span,
                                                       int n_pix, int slot_base, int per) {
  constexpr int kSlots = kCh + (kCount ? 1 : 0);
  extern __shared__ unsigned private_map[];  // (kSlots, n_pix): float sums, then unsigned counts
  const int slot0 = slot_base + blockIdx.y * per;
  const long long begin = (long long)blockIdx.x * span;
  const long long end = min(begin + span, n_samples);
  const int lane = threadIdx.x & 31;

  if (kShared) {
    for (int j = threadIdx.x; j < kSlots * n_pix; j += blockDim.x) private_map[j] = 0u;
    __syncthreads();
  }
  float* target = kShared ? reinterpret_cast<float*>(private_map) : out + (size_t)slot0 * n_pix;
  const float* channel[kCh > 0 ? kCh : 1];
#pragma unroll
  for (int s = 0; s < kCh; ++s) channel[s] = data + (size_t)(slot0 + s) * n_samples;

  // A warp's loads for its next U steps are issued before it bins the
  // current ones, so device-memory latency overlaps the binning.
  const long long step = (long long)(blockDim.x >> 5) * 32 * kUnroll;
  int next_id[kUnroll];
  float next_v[kUnroll][kCh > 0 ? kCh : 1];
  auto load = [&](long long base) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * 32;
      const bool in = i < end;
      next_id[u] = in ? __ldg(ids + i) : -1;
#pragma unroll
      for (int s = 0; s < kCh; ++s) next_v[u][s] = in ? __ldg(channel[s] + i) : 0.0f;
    }
  };
  long long base = begin + (long long)(threadIdx.x >> 5) * 32 * kUnroll + lane;
  load(base);
  for (; base - lane < end; base += step) {
    int id[kUnroll];
    float v[kUnroll][kCh > 0 ? kCh : 1];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      id[u] = next_id[u];
#pragma unroll
      for (int s = 0; s < kCh; ++s) v[u][s] = next_v[u][s];
    }
    load(base + step);
    // Segments: a lane whose id differs from the previous lane's starts
    // one; start[u] is the first lane of this lane's segment in step u.
    unsigned heads[kUnroll];
    int start[kUnroll];
    int longest = 1;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int before = __shfl_up_sync(kFull, id[u], 1);
      heads[u] = __ballot_sync(kFull, lane == 0 || before != id[u]);
      start[u] = 31 - __clz(heads[u] & (kFull >> (31 - lane)));
      longest = max(longest, lane - start[u] + 1);
    }
    // Segmented inclusive sums of the U steps and the block's channels
    // together, in as many shuffle steps as the longest segment needs.
    if (kCh > 0) {
      longest = __reduce_max_sync(kFull, longest);
      for (int d = 1; d < longest; d <<= 1) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int s = 0; s < kCh; ++s) {
            const float y = __shfl_up_sync(kFull, v[u][s], d);
            if (lane - d >= start[u]) v[u][s] += y;
          }
        }
      }
    }
    // A segment's last lane adds its sums, and its length as its hit count.
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool tail = (unsigned)id[u] < (unsigned)n_pix && (lane == 31 || ((heads[u] >> (lane + 1)) & 1u));
      if (!tail) continue;
      float* map = target + id[u];
#pragma unroll
      for (int s = 0; s < kCh; ++s) atomicAdd(map + (size_t)s * n_pix, v[u][s]);
      if (kCount) {
        if (kShared) {
          atomicAdd(reinterpret_cast<unsigned*>(map + (size_t)kCh * n_pix), (unsigned)(lane - start[u] + 1));
        } else {
          atomicAdd(map + (size_t)kCh * n_pix, (float)(lane - start[u] + 1));
        }
      }
    }
  }

  if (kShared) {
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const unsigned* src = private_map + (size_t)s * n_pix;
      float* dst = out + (size_t)(slot0 + s) * n_pix;
      for (int p = threadIdx.x; p < n_pix; p += blockDim.x) {
        const unsigned w = src[p];
        if (w != 0u) atomicAdd(dst + p, s == kCh ? (float)w : __uint_as_float(w));
      }
    }
  }
}

using Kernel = void (*)(const float*, const int*, float*, long long, long long, int, int, int);

template <bool kShared>
Kernel pick(int n_ch, bool count) {
  switch (2 * n_ch + (count ? 1 : 0)) {
    case 1: return bin_map_kernel<kShared, 0, true>;
    case 2: return bin_map_kernel<kShared, 1, false>;
    case 3: return bin_map_kernel<kShared, 1, true>;
    case 4: return bin_map_kernel<kShared, 2, false>;
    case 5: return bin_map_kernel<kShared, 2, true>;
    case 6: return bin_map_kernel<kShared, 3, false>;
    case 7: return bin_map_kernel<kShared, 3, true>;
    case 8: return bin_map_kernel<kShared, 4, false>;
    default: return nullptr;
  }
}

// groups blocks.y of `per` slots from slot_base, each holding n_ch channels
// and the count if `count`.
cudaError_t launch_groups(bool shared, int n_ch, bool count, int groups, int slot_base, const float* data,
                          const int* ids, float* out, long long n_samples, long long span, int n_pix, int per,
                          int blocks, int threads, cudaStream_t stream) {
  const Kernel kernel = shared ? pick<true>(n_ch, count) : pick<false>(n_ch, count);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const size_t smem = shared ? (size_t)(n_ch + (count ? 1 : 0)) * n_pix * 4 : 0;
  if (shared) {  // raise the kernel's shared-memory limit once a device, not on every call
    static size_t limit[kDevices][2 * kMaxSlots + 1] = {};
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    size_t* have = device < kDevices ? &limit[device][2 * n_ch + (count ? 1 : 0)] : nullptr;
    if (have == nullptr || *have < smem) {
      err = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      if (have != nullptr) *have = smem;
    }
  }
  kernel<<<dim3(blocks, groups), threads, smem, stream>>>(data, ids, out, n_samples, span, n_pix, slot_base, per);
  return cudaGetLastError();
}

}  // namespace

// out (n_slots, n_pix) f32 is zeroed here, on the stream. shared != 0: the
// privatised form, with per * n_pix * 4 bytes of shared memory a block;
// else the global-atomic form. groups = ceil(n_slots / per) groups of
// blocks of `threads` threads: every group but the last holds `per`
// channels, the last the rest and the count. One launch for the full
// groups (full_blocks x (groups - 1) blocks of full_span samples), one for
// the last (blocks of span samples): each launch is sized for the groups it
// holds (ops/bin_map.py::bin_plan).
extern "C" int maria_bin_map(const void* data, const void* ids, void* out, long long n_samples, int n_channels,
                             int n_slots, int n_pix, int per, int groups, int threads, int shared, int full_blocks,
                             long long full_span, int blocks, long long span, void* stream) {
  const bool count = n_slots == n_channels + 1;
  if (n_channels < 0 || (n_slots != n_channels && !count) || n_slots < 1 || n_pix < 1 || per < 1 ||
      per > kMaxSlots || groups != (n_slots + per - 1) / per || groups > 65535 || blocks < 1 || span < 1 ||
      (long long)blocks * span < n_samples || threads < 32 || threads > 1024 || threads % 32 ||
      (groups > 1 && (full_blocks < 1 || full_span < 1 || (long long)full_blocks * full_span < n_samples)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* d = (const float*)data;
  const int* p = (const int*)ids;
  float* o = (float*)out;
  const cudaError_t zeroed = cudaMemsetAsync(o, 0, (size_t)n_slots * n_pix * 4, st);
  if (zeroed != cudaSuccess) return (int)zeroed;
  if (groups > 1) {
    const cudaError_t err = launch_groups(shared, per, false, groups - 1, 0, d, p, o, n_samples, full_span, n_pix,
                                          per, full_blocks, threads, st);
    if (err != cudaSuccess) return (int)err;
  }
  const int last = (groups - 1) * per;
  return (int)launch_groups(shared, n_channels - last, count, 1, last, d, p, o, n_samples, span, n_pix, per, blocks,
                            threads, st);
}
