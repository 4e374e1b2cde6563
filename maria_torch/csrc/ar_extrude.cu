// The autoregressive atmosphere's extrusion loop: a process on a thread-block
// cluster, its operators resident in the cluster's shared memory.
//
// Replaces maria_tpu/atmosphere/process.py::_ar_extrude_noise, a
// lax.scan on the TPU (not a Pallas kernel). For each process, a buffer
// of (n_extrusion + n_steps) x n_cross floats starts as white noise and
// its rows b = n_steps - 1, ..., 0 are filled in turn:
//   row_b = A @ buffer[b + ext_idx + 1, cross_idx] + B @ eps_i,
//   i = n_steps - 1 - b,
// with A (n_cross x n_sample), B (n_cross x n_cross, lower triangular: a
// Cholesky factor) and the innovations eps (n_steps x n_cross), read
// newest-row-first as the scan reads them. Sample s of the step that
// fills row b is buffer[b n_cross + goff[s]], goff[s] = (ext_idx[s] + 1)
// n_cross + cross_idx[s] (the tables are built on the host,
// ops/ar_extrude.py::ar_tables).
//
// What bounds it on an H100: each step depends on the row the step before
// wrote, so a process is a chain of n_steps = 2 n_extrusion dependent
// steps (348 at the MUSTANG-2 60 s scene's longest process, 3,372 at
// 600 s, 418 at the AtLAST-50k 3-D process), each one
// n_cross x (n_sample + n_cross) matrix-vector product. Neither device
// memory nor arithmetic bounds it: the operators are at most 0.8 MB and
// a step's product at most 0.2 MFMA. The chain's latency does: what lies
// between one row and the next.
//
// Design: keep everything a step needs that does not depend on the step
// before out of that chain.
// - Only the lookback samples with ext_idx == 0 lie in the row the step
//   before wrote. Every other sample of step i + 1 lies in a row that was
//   complete when step i began, so each thread loads its share of them,
//   and of step i + 1's innovations, into registers at the top of step i
//   and stores them into shared memory after its dot: the L2 round trip
//   runs beside the dot, not before it.
// - The samples and innovations of a step are one vector in shared
//   memory, kept twice: step i reads copy i & 1 while copy (i + 1) & 1 is
//   filled for the next step.
// - A finished row element goes to device memory (the screen is the
//   output) and straight into the ext_idx == 0 slots of the next vector,
//   so the newest row never comes back from device memory. Which slots
//   take column r is a table (new_start, new_slot): a process may sample
//   the newest row at any columns, some twice.
// - A process runs on a cluster of C blocks: one where its operators fit
//   a block's shared memory, otherwise eight (the host's choice,
//   ops/ar_extrude.py::ar_cluster_size; the kernel takes any power of two
//   up to 8). Block c owns rows c rpb, ..., (c + 1) rpb - 1 of the output,
//   rpb = ceil(n_cross / C), and keeps these rows of A and B in its shared
//   memory for the whole launch, each row padded with zeros to whole
//   warps (of B the lower triangle's warps are read), so that every lane
//   of a dot runs the same count of iterations. Each block holds the whole
//   sample vector; a finished element is written into the next vector of
//   every block of the cluster, the other blocks' through distributed
//   shared memory. Every 2-D process of the scenes fits C = 1; the
//   AtLAST-50k 3-D process (252 x 510, 0.77 MB) takes C = 8, 32 rows and
//   104 KB a block. A process that fits no C <= 8 runs in one block with A
//   and B read through L2 (the same loop, kStaged false).
// - One barrier a step: __syncthreads() when C = 1 (the kernel is a
//   template on it), otherwise the cluster's barrier. It orders (1) this
//   step's reads of vector i & 1 before the writes of step i + 1 into it,
//   (2) the writes into vector (i + 1) & 1, local and remote, before step
//   i + 1 reads it, and (3) the row's write to device memory before the
//   loads at the top of step i + 1, which read that row for ext_idx == 1.
//   For (3) across blocks: each thread's barrier.cluster.arrive has
//   release and its wait acquire semantics at cluster scope, so a row
//   element stored before the arrive is visible to a load after the
//   wait, provided the load does not hit a stale line of its SM's L1:
//   rows are not 128-byte aligned, so a line fetched for row b + 2 can
//   cover the start of row b + 1 from before another block wrote it. The
//   buffer is therefore always loaded past L1 (ld.global.cg); nothing
//   needs it from L1, the loads being off the chain.
// - The dot: a warp an output row at a time (rows strided over the
//   block's warps; a warp's first row keeps its slots in registers), its
//   lanes striding the row's A and then B entries into one accumulator,
//   then a shuffle tree; the summation order is that of a plain strided
//   warp dot whatever C is.
//
// What a step costs on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6
// has the runs): 0.43-0.49 us in 2-D and 1.85 us on the 3-D process's
// cluster of eight, against 0.76-0.79 and 17.5 us for the form this one
// replaced (a gather from device memory and two barriers a step, the 3-D
// operators through L2). What is left of a 2-D step is not a latency but
// instruction slots: the disassembly (cuobjdump -sass) has some 120 instructions
// a warp and step, most of them loop control and address arithmetic
// around a dot of three or four loads, and 4 warps share an SM
// sub-partition. On the cluster a step pays the cluster's barrier,
// 0.71-0.73 us at 8 x 1,024 threads, and reads 195 KB of shared memory
// (its rows and, a row, the vector).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kDescInts = 10;
constexpr int kThreadsMax = 1024;
// the largest block of the one-block form: half the card's, so that a thread
// may take 128 registers (the 2-D scenes' steps ran 4-15% faster for it)
constexpr int kThreadsOneBlock = 512;
// values a thread loads a step ahead into registers; what a step needs
// beyond kPre a thread (no process of the scenes) is loaded after the dot
constexpr int kPre = 2;

// One process of a launch: offsets (in elements) of its A, B, index
// tables, buffer and innovations in the flat arrays, its sizes, whether
// its operators are staged in shared memory, and its count of samples
// with ext_idx >= 1.
struct Desc {
  int a_off, b_off, tab_off, buf_off, noise_off, n_cross, n_sample, n_steps, staged, n_old;
};

__device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }
__device__ __forceinline__ int pad32(int n) { return (n + 31) & ~31; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// acc + sum of w[32 c] x[32 c] over c = 0, 1, ... while 32 c + lane < n, in
// that order: `w` and `x` point at this lane's first entries. `n` is the
// same in every lane, so the loop does not diverge; staged rows are padded
// with zeros to whole warps and take no tail.
__device__ __forceinline__ float lane_dot(const float* w, const float* x, int n, int lane, float acc) {
  const int chunks = n >> 5;
#pragma unroll 4
  for (int c = 0; c < chunks; ++c) acc = fmaf(w[32 * c], x[32 * c], acc);
  if (lane < (n & 31)) acc = fmaf(w[32 * chunks], x[32 * chunks], acc);
  return acc;
}

template <bool kCluster>
__device__ __forceinline__ void step_barrier() {
  if constexpr (kCluster)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// `p` of this block's shared memory as block `blk` of the cluster holds it
template <bool kCluster>
__device__ __forceinline__ float* of_block(float* p, int blk) {
  if constexpr (kCluster)
    return cg::this_cluster().map_shared_rank(p, blk);
  else
    return p;
}

template <bool kCluster, bool kStaged>
__device__ void extrude(const Desc& d, const float* __restrict__ A, const float* __restrict__ B,
                        const int* __restrict__ tab, float* buffer, const float* __restrict__ noise, float* smem) {
  const int n_cross = d.n_cross, n_sample = d.n_sample, n_steps = d.n_steps, n_old = d.n_old;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n_threads = blockDim.x, n_warps = n_threads >> 5;
  int n_blocks = 1, rank = 0;
  if constexpr (kCluster) {
    n_blocks = cg::this_cluster().num_blocks();
    rank = cg::this_cluster().block_rank();
  }
  const int log_blocks = 31 - __clz(n_blocks);
  // this block's rows of the output
  const int rpb = (n_cross + n_blocks - 1) / n_blocks;
  const int row0 = min(n_cross, rank * rpb), rows = min(n_cross, row0 + rpb) - row0;
  // index tables: goff, old, new_start, new_slot
  const int* goff = tab;
  const int* old = goff + n_sample;
  const int* new_start = old + n_old;
  const int* new_slot = new_start + n_cross + 1;
  // shared memory: the two vectors (samples, then innovations, each padded
  // with zeros to whole warps), the slots this block's rows go to, then its
  // rows of A and B, padded alike
  const int eps_at = pad32(n_sample), n_vec = eps_at + pad32(n_cross);
  float* vec = smem;
  int* nstart = reinterpret_cast<int*>(vec + 2 * n_vec);
  int* nslot = nstart + pad4(rpb + 1);
  float* a_s = reinterpret_cast<float*>(nslot + pad4(n_sample));
  float* b_s = a_s + rpb * eps_at;

  const int slot0 = new_start[row0], n_slots = new_start[row0 + rows] - slot0;
  for (int k = tid; k <= rows; k += n_threads) nstart[k] = new_start[row0 + k] - slot0;
  for (int k = tid; k < n_slots; k += n_threads) nslot[k] = new_slot[slot0 + k];
  if (kStaged) {
    for (int rl = warp; rl < rows; rl += n_warps) {
      const int r = row0 + rl;
      for (int s = lane; s < eps_at; s += 32) a_s[rl * eps_at + s] = s < n_sample ? A[r * n_sample + s] : 0.f;
      for (int j = lane; j < n_vec - eps_at; j += 32) b_s[rl * (n_vec - eps_at) + j] = j <= r ? B[r * n_cross + j] : 0.f;
    }
  }
  // a row's entries and their stride, in shared memory or through L2
  const float* a_rows = kStaged ? a_s : A + row0 * n_sample;
  const float* b_rows = kStaged ? b_s : B + row0 * n_cross;
  const int a_stride = kStaged ? eps_at : n_sample, b_stride = kStaged ? n_vec - eps_at : n_cross;
  // step 0's vector, whole, from the initial buffer
  const float* first = buffer + (long long)(n_steps - 1) * n_cross;
  for (int k = tid; k < 2 * n_vec; k += n_threads) vec[k] = 0.f;
  __syncthreads();
  for (int s = tid; s < n_sample; s += n_threads) vec[s] = __ldcg(first + goff[s]);
  for (int j = tid; j < n_cross; j += n_threads) vec[eps_at + j] = noise[j];
  // what this thread loads a step ahead: value k comes from src[k], which
  // moves by stride[k] a step (a row up the buffer, a row down the
  // innovations), and goes to slot dst[k] of the next vector
  const float* src[kPre];
  int stride[kPre], dst[kPre];
#pragma unroll
  for (int k = 0; k < kPre; ++k) {
    const int idx = tid + k * n_threads;
    src[k] = buffer, stride[k] = 0, dst[k] = -1;
    if (idx < n_old) {
      const int s = old[idx];
      src[k] = buffer + (long long)(n_steps - 2) * n_cross + goff[s], stride[k] = -n_cross, dst[k] = s;
    } else if (idx < n_old + n_cross) {
      src[k] = noise + n_cross + (idx - n_old), stride[k] = n_cross, dst[k] = eps_at + idx - n_old;
    }
  }
  // every block of the cluster runs before any writes into its memory
  step_barrier<kCluster>();

  // One output row r, local row rl: its dot, then the element to device
  // memory and into the (slot, block) pairs that take it: pair k is slot
  // k >> log_blocks in block k & (n_blocks - 1). `slot` is this lane's
  // pair's, if it has one, and `peer` the vectors of this lane's block.
  float* peer = of_block<kCluster>(vec, lane & (n_blocks - 1));
  const float* a_lane = a_rows + lane;
  const float* b_lane = b_rows + lane;
  const float* x_lane = vec + lane;
  auto run_row = [&](int rl, int first_slot, int n_pairs, int slot, int cur_at, int nxt_at, float* row) {
    const int r = row0 + rl;
    float acc = lane_dot(a_lane + rl * a_stride, x_lane + cur_at, a_stride, lane, 0.f);
    acc = lane_dot(b_lane + rl * b_stride, x_lane + cur_at + eps_at, kStaged ? (r | 31) + 1 : r + 1, lane, acc);
    acc = warp_sum(acc);
    if (lane == 0) row[r] = acc;
    if (lane < n_pairs) peer[nxt_at + slot] = acc;
    for (int k = lane + 32; k < n_pairs; k += 32)
      of_block<kCluster>(vec, k & (n_blocks - 1))[nxt_at + nslot[first_slot + (k >> log_blocks)]] = acc;
  };
  // the warp's first row keeps its pairs in registers over the steps
  const int my_first = warp < rows ? nstart[warp] : 0;
  const int my_pairs = warp < rows ? (nstart[warp + 1] - my_first) << log_blocks : 0;
  const int my_slot = lane < my_pairs ? nslot[my_first + (lane >> log_blocks)] : 0;

  float* row = buffer + (long long)(n_steps - 1) * n_cross;
  int cur_at = 0;
  for (int i = 0; i < n_steps; ++i, row -= n_cross, cur_at = n_vec - cur_at) {
    const int nxt_at = n_vec - cur_at;
    const bool more = i + 1 < n_steps;
    float pre[kPre];
#pragma unroll
    for (int k = 0; k < kPre; ++k) {
      pre[k] = 0.f;
      if (more && dst[k] >= 0) pre[k] = __ldcg(src[k]);
      src[k] += stride[k];
    }
    if (warp < rows) run_row(warp, my_first, my_pairs, my_slot, cur_at, nxt_at, row);
    for (int rl = warp + n_warps; rl < rows; rl += n_warps) {
      const int first_slot = nstart[rl], n_pairs = (nstart[rl + 1] - first_slot) << log_blocks;
      run_row(rl, first_slot, n_pairs, lane < n_pairs ? nslot[first_slot + (lane >> log_blocks)] : 0, cur_at,
              nxt_at, row);
    }
    // (after the last step nothing reads the next vector)
#pragma unroll
    for (int k = 0; k < kPre; ++k)
      if (dst[k] >= 0) vec[nxt_at + dst[k]] = pre[k];
    if (more) {
      for (int idx = kPre * n_threads + tid; idx < n_old + n_cross; idx += n_threads) {
        if (idx < n_old)
          vec[nxt_at + old[idx]] = __ldcg(row - n_cross + goff[old[idx]]);
        else
          vec[nxt_at + eps_at + idx - n_old] = noise[(long long)(i + 1) * n_cross + idx - n_old];
      }
    }
    step_barrier<kCluster>();
  }
}

template <bool kCluster>
__global__ void __launch_bounds__(kCluster ? kThreadsMax : kThreadsOneBlock) ar_extrude_kernel(const int* __restrict__ desc,
                                                                 const float* __restrict__ A,
                                                                 const float* __restrict__ B,
                                                                 const int* __restrict__ tab, float* buffer,
                                                                 const float* __restrict__ noise) {
  extern __shared__ float smem[];
  int process = blockIdx.x;
  if constexpr (kCluster) process /= cg::this_cluster().num_blocks();
  const int* q = desc + process * kDescInts;
  const Desc d{q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8], q[9]};
  A += d.a_off, B += d.b_off, tab += d.tab_off, buffer += d.buf_off, noise += d.noise_off;
  if (kCluster || d.staged)
    extrude<kCluster, true>(d, A, B, tab, buffer, noise, smem);
  else
    extrude<false, false>(d, A, B, tab, buffer, noise, smem);
}

// Probes of latencies, for the kernel's bound and for reading its gap to
// it: a chain of dependent FMAs in one warp, a loop of block barriers,
// and a loop of cluster barriers.
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

__global__ void cluster_barrier_loop_kernel(float* out, int iters) {
#pragma unroll 16
  for (int k = 0; k < iters; ++k) cg::this_cluster().sync();
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = (float)iters;
}

// grid of `blocks` blocks of `threads` in clusters of `cluster`
struct Launch {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attribute;
  Launch(int blocks, int threads, int smem_bytes, int cluster, void* stream) : config{}, attribute{} {
    config.gridDim = dim3(blocks);
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = smem_bytes;
    config.stream = (cudaStream_t)stream;
    attribute.id = cudaLaunchAttributeClusterDimension;
    attribute.val.clusterDim.x = cluster;
    attribute.val.clusterDim.y = attribute.val.clusterDim.z = 1;
    config.attrs = &attribute;
    config.numAttrs = cluster > 1 ? 1 : 0;
  }
};

bool bad_block(int threads, int cluster) {
  return threads < 32 || threads > kThreadsMax || (threads & 31) || cluster < 1 || cluster > 8 ||
         (cluster & (cluster - 1));
}

}  // namespace

// One launch for `n_proc` processes, each on a cluster of `cluster` blocks
// (1, 2, 4 or 8) of `threads` threads and `smem_bytes` of shared memory.
extern "C" int maria_ar_extrude(const void* desc, int n_proc, const void* A, const void* B, const void* tab,
                                void* buffer, const void* noise, int threads, int smem_bytes, int cluster,
                                void* stream) {
  if (n_proc < 1 || smem_bytes < 0 || bad_block(threads, cluster) || (cluster == 1 && threads > kThreadsOneBlock))
    return (int)cudaErrorInvalidValue;
  auto kernel = cluster > 1 ? ar_extrude_kernel<true> : ar_extrude_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  Launch launch(n_proc * cluster, threads, smem_bytes, cluster, stream);
  if (cluster > 1) {
    int fit = 0;
    err = cudaOccupancyMaxActiveClusters(&fit, kernel, &launch.config);
    if (err != cudaSuccess) return (int)err;
    if (fit < 1) return (int)cudaErrorLaunchOutOfResources;
  }
  err = cudaLaunchKernelEx(&launch.config, kernel, (const int*)desc, (const float*)A, (const float*)B,
                           (const int*)tab, (float*)buffer, (const float*)noise);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// mode 0: `iters` dependent FMAs in each of 32 threads (out holds 32
// floats); mode 1: `iters` barriers in a block of `threads`; mode 2:
// `iters` cluster barriers in one cluster of `cluster` blocks of `threads`.
extern "C" int maria_ar_probe(int mode, int iters, int threads, int cluster, void* out, void* stream) {
  if (iters < 1 || mode < 0 || mode > 2 || bad_block(threads, cluster)) return (int)cudaErrorInvalidValue;
  if (mode == 0) {
    fma_chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((float*)out, iters, 0.999999f, 1e-7f);
  } else if (mode == 1) {
    barrier_loop_kernel<<<1, threads, 0, (cudaStream_t)stream>>>((float*)out, iters);
  } else {
    Launch launch(cluster, threads, 0, cluster, stream);
    cudaError_t err = cudaLaunchKernelEx(&launch.config, cluster_barrier_loop_kernel, (float*)out, iters);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
