// The line-of-sight layer sampler: every atmospheric layer's bilinear
// gather and the pwv sum, in one pass over the (detector, coarse step)
// samples.
//
// Replaces no TPU kernel. It replaces the XLA gather of the exact path of
// maria_tpu/atmosphere/sampling.py (accumulate_pwv with bs_px=None), which
// the port ran as plain torch: some 60 elementwise and gather launches a
// layer (atmosphere/sampling.py::_sample, ops/interp.py::
// interp_bilinear_uniform), each a full pass over the samples.
//
// For sample (r, c), with px, py the unit-height line-of-sight projections
// and t the coarse time, the pwv is
//   pwv = mean + sum over layers l of rms_l * bilinear_l(tx, ty),
//   x = h px + vx t,  y = h py + vy t,
//   tx = cos(a) x + sin(a) y,  ty = -sin(a) x + cos(a) y,
//   fx = (tx - tx_min) / res_x,  fy = (ty - ty_min) / res_y,
// the bilinear value 0 where fx lies outside [0, nx - 1] or fy outside
// [0, ny - 1], the cell's corner clamped to [0, n - 2], layers summed in
// the order of the table. A layer is a (ny, nx) float32 grid and its
// transform (LosLayer): a Fourier screen, an AR screen's blurred values
// (res_y = ty_res) or one height of a 3-D screen group's stack.
//
// Contract: bit-equal to the plain torch path on the card. Every float32
// operation is the plain path's, in its order, rounded alone (the _rn
// intrinsics: nothing contracts into an FMA); the Python scalars are
// rounded to float32 as torch rounds them, and a division by a Python
// scalar is torch's on a CUDA tensor: a product with the reciprocal, taken
// in double on the host and rounded to float32 (ops/los_sample.py; checked
// on the H100 with torch 2.11: 1 / float32(res) differs for some res).
//
// What bounds it on an H100: at the AtLAST-50k 60 s scene (12 layers,
// 50,004 x 600 samples) it reads px, py and writes pwv once, 12 bytes a
// sample (0.36 GB, 0.107 ms at 3.35 TB/s); the grids, a few MB, are read
// through L1 and L2. The contract's float32 operations bound it more:
// 31 a layer and sample, each an issue of the FP32 pipe (no FMA), 11.2 G
// at 33.5 T a second, 0.333 ms. The plain path made each of its ~60
// passes through device memory, ~220 GB a realization.
// Design:
// - one thread a sample, the coarse step fastest, so px, py and pwv are
//   read and written once, coalesced; the sum stays in a register across
//   the layers and is stored once;
// - the layer table rides in the kernel's parameters (__grid_constant__,
//   read from the constant bank with the layer index uniform across the
//   warp): nothing is copied to the card and nothing synchronizes;
// - a warp's 32 consecutive coarse steps of one detector look along
//   nearby lines of sight, so its four taps a layer fall in a few cache
//   lines of the grid, read through the read-only path;
// - the backward (los_sample_backward_kernel) takes the incoming gradient
//   and walks the layers again, last to first, recomputing each layer's
//   taps and running the operations of the plain path's autograd in the
//   order its engine runs them (the one-sided slopes of the floor cell, 0
//   off a grid): its gradients are the plain path's bit for bit, where
//   slopes written by the forward and multiplied later would round
//   differently (a smooth grid's taps cancel: 1e-5 of the gradient).
// A table longer than kMaxLayers takes several launches, each adding to
// what the one before stored: the same sums in the same order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLayers = 48;

struct LosLayer {
  const float* grid;  // (ny, nx), row-major
  int ny, nx;
  float h, ca, sa, vx, vy;  // height, cos and sin of the angle, wind
  float inv_dx, inv_dy;     // 1 / res_x, 1 / res_y in double, rounded to float32
  float x0, y0;             // tx_min, ty_min
  float rms;
};

struct LosTable {
  LosLayer layer[kMaxLayers];
  int n;
  float mean;
};

static_assert(sizeof(LosTable) <= 4096 - 96, "the layer table must fit in a kernel's parameters");

// One layer's transform at (a, b, tt), as the plain path computes it.
struct Tap {
  bool inside;
  float wx, wy, ox, oy, v00, v01, v10, v11;
};

__device__ __forceinline__ Tap tap(const LosLayer& L, float a, float b, float tt) {
  const float x = __fadd_rn(__fmul_rn(L.h, a), __fmul_rn(L.vx, tt));
  const float y = __fadd_rn(__fmul_rn(L.h, b), __fmul_rn(L.vy, tt));
  const float tx = __fadd_rn(__fmul_rn(L.ca, x), __fmul_rn(L.sa, y));
  const float ty = __fadd_rn(__fmul_rn(-L.sa, x), __fmul_rn(L.ca, y));
  const float fx = __fmul_rn(__fsub_rn(tx, L.x0), L.inv_dx);
  const float fy = __fmul_rn(__fsub_rn(ty, L.y0), L.inv_dy);
  Tap r;
  r.inside = fx >= 0.f && fx <= (float)(L.nx - 1) && fy >= 0.f && fy <= (float)(L.ny - 1);
  if (!r.inside) return r;
  const int ix = min((int)floorf(fx), L.nx - 2);
  const int iy = min((int)floorf(fy), L.ny - 2);
  r.wx = __fsub_rn(fx, (float)ix);
  r.wy = __fsub_rn(fy, (float)iy);
  r.ox = __fsub_rn(1.f, r.wx);
  r.oy = __fsub_rn(1.f, r.wy);
  const float* p = L.grid + (long long)iy * L.nx + ix;
  r.v00 = __ldg(p);
  r.v01 = __ldg(p + 1);
  r.v10 = __ldg(p + L.nx);
  r.v11 = __ldg(p + L.nx + 1);
  return r;
}

__device__ __forceinline__ long long column(long long i, long long cols, long long n) {
  return n <= 0xffffffffLL ? (long long)((unsigned int)i % (unsigned int)cols) : i % cols;
}

__global__ void __launch_bounds__(kThreads)
    los_sample_kernel(const __grid_constant__ LosTable tab, const float* __restrict__ px,
                      const float* __restrict__ py, const float* __restrict__ t, long long cols, long long n,
                      bool accumulate, float* __restrict__ pwv) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float a = __ldg(px + i), b = __ldg(py + i), tt = __ldg(t + column(i, cols, n));
  float acc = accumulate ? pwv[i] : tab.mean;
  for (int l = 0; l < tab.n; ++l) {
    const LosLayer& L = tab.layer[l];
    const Tap r = tap(L, a, b, tt);
    float sample = 0.f;
    if (r.inside) {
      const float p0 = __fmul_rn(r.v00, r.oy), p1 = __fmul_rn(r.v01, r.oy);
      const float p2 = __fmul_rn(r.v10, r.wy), p3 = __fmul_rn(r.v11, r.wy);
      sample = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(p0, r.ox), __fmul_rn(p1, r.wx)), __fmul_rn(p2, r.ox)),
                         __fmul_rn(p3, r.wx));
    }
    acc = __fadd_rn(acc, __fmul_rn(L.rms, sample));
  }
  pwv[i] = acc;
}

// The gradients of sum(g pwv) in px and py, each operation the one the
// plain path's autograd runs, in its order: layers last to first, and in a
// layer the engine's order (its nodes by creation, latest first). A
// gradient buffer starts at -0, which adds to any first term exactly.
__global__ void __launch_bounds__(kThreads)
    los_sample_backward_kernel(const __grid_constant__ LosTable tab, const float* __restrict__ px,
                               const float* __restrict__ py, const float* __restrict__ t, long long cols,
                               long long n, bool accumulate, const float* __restrict__ g,
                               float* __restrict__ gpx, float* __restrict__ gpy) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float a = __ldg(px + i), b = __ldg(py + i), tt = __ldg(t + column(i, cols, n)), gi = __ldg(g + i);
  float ax = accumulate ? gpx[i] : -0.f, ay = accumulate ? gpy[i] : -0.f;
  for (int l = tab.n - 1; l >= 0; --l) {
    const LosLayer& L = tab.layer[l];
    const Tap r = tap(L, a, b, tt);
    if (!r.inside) continue;  // the gradient of the where: 0, which adds nothing
    const float go = __fmul_rn(gi, L.rms);
    const float p0 = __fmul_rn(r.v00, r.oy), p1 = __fmul_rn(r.v01, r.oy);
    const float p2 = __fmul_rn(r.v10, r.wy), p3 = __fmul_rn(r.v11, r.wy);
    const float gwx = __fsub_rn(__fadd_rn(__fsub_rn(__fmul_rn(go, p3), __fmul_rn(go, p2)), __fmul_rn(go, p1)),
                                __fmul_rn(go, p0));
    const float gw = __fmul_rn(go, r.wx), go_x = __fmul_rn(go, r.ox);
    const float gwy = __fsub_rn(__fsub_rn(__fadd_rn(__fmul_rn(gw, r.v11), __fmul_rn(go_x, r.v10)), __fmul_rn(gw, r.v01)),
                                __fmul_rn(go_x, r.v00));
    const float gtx = __fmul_rn(gwx, L.inv_dx), gty = __fmul_rn(gwy, L.inv_dy);
    const float gx = __fadd_rn(__fmul_rn(gty, -L.sa), __fmul_rn(gtx, L.ca));
    const float gy = __fadd_rn(__fmul_rn(gty, L.ca), __fmul_rn(gtx, L.sa));
    ax = __fadd_rn(ax, __fmul_rn(gx, L.h));
    ay = __fadd_rn(ay, __fmul_rn(gy, L.h));
  }
  gpx[i] = ax;
  gpy[i] = ay;
}

}  // namespace

extern "C" int maria_los_max_layers() { return kMaxLayers; }

extern "C" int maria_los_layer_bytes() { return (int)sizeof(LosLayer); }

namespace {

// Copies n_layers descriptors into a launch's table; false if one is unfit.
bool fill(LosTable& tab, const void* layers, int n_layers, float mean) {
  if (n_layers < 0 || n_layers > kMaxLayers) return false;
  const LosLayer* in = (const LosLayer*)layers;
  for (int l = 0; l < n_layers; ++l) {
    if (in[l].grid == nullptr || in[l].ny < 2 || in[l].nx < 2) return false;
    tab.layer[l] = in[l];
  }
  tab.n = n_layers;
  tab.mean = mean;
  return true;
}

long long blocks_for(long long rows, long long cols) {
  const long long blocks = (rows * cols + kThreads - 1) / kThreads;
  return rows < 0 || cols < 1 || blocks > 0x7fffffffLL ? -1 : blocks;
}

}  // namespace

// layers: n_layers LosLayer descriptors in host memory, copied into the
// launch's parameters. px, py, pwv: rows x cols contiguous float32; t: the
// cols coarse times. accumulate: add to the pwv already stored.
extern "C" int maria_los_sample(const void* layers, int n_layers, float mean, const void* px, const void* py,
                                const void* t, long long rows, long long cols, int accumulate, void* pwv,
                                void* stream) {
  LosTable tab;
  const long long blocks = blocks_for(rows, cols);
  if (blocks < 0 || !fill(tab, layers, n_layers, mean)) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  los_sample_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      tab, (const float*)px, (const float*)py, (const float*)t, cols, rows * cols, accumulate != 0, (float*)pwv);
  return (int)cudaGetLastError();
}

// The backward of maria_los_sample over the same layers: g, gpx, gpy rows x
// cols contiguous float32. accumulate: add to the gradients already stored
// (the layers before those of a launch before, taken last to first).
extern "C" int maria_los_sample_backward(const void* layers, int n_layers, const void* px, const void* py,
                                         const void* t, long long rows, long long cols, int accumulate,
                                         const void* g, void* gpx, void* gpy, void* stream) {
  LosTable tab;
  const long long blocks = blocks_for(rows, cols);
  if (blocks < 0 || !fill(tab, layers, n_layers, 0.f)) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  los_sample_backward_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      tab, (const float*)px, (const float*)py, (const float*)t, cols, rows * cols, accumulate != 0,
      (const float*)g, (float*)gpx, (float*)gpy);
  return (int)cudaGetLastError();
}
