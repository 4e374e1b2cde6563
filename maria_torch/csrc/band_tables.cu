// A stage's band tables in one pass over the (detector, sample) pairs of
// its bands: TODProgram.fields' atmospheric loading (one table a band, at
// the coarse rate) and its CMB stage (two tables a band and the band's
// static CMB samples, at the fine rate).
//
// Replaces no TPU kernel. It replaces the port's plain torch chain
// (ops/band_tables.py::band_tables_plain: ops/interp.py::TableEval a table
// and band, then the product with the Mueller I factor, the CMB stage's
// product with its samples and sum, and the scatter into the field), some
// 40 elementwise launches a table and band, each a pass through device
// memory (the axis transforms, the clamps, floor, the int64 index
// arithmetic, four gathers, the weights and their sums).
//
// For row r of band b and sample t, with x = pwv[r, t] and y = el[r, t]:
//   u = clip(f_x(x), 0, nx - 1), v = clip(f_y(y), 0, ny - 1), where f is
//     the axis's fractional index: (x - x0) / dx (uniform), (log x - x0) /
//     dx (log), or i + (x - s_i) / (s_{i+1} - s_i) with i the bisection's
//     cell (general: torch.searchsorted(s, x, right=True) - 1, clamped);
//   i = clip(floor u, 0, nx - 2), j likewise, wu = u - i, wv = v - j;
//   T(x, y) = c00 (1 - wu)(1 - wv) + c01 (1 - wu) wv + c10 wu (1 - wv)
//     + c11 wu wv over the cell's corners, in that order;
//   out[r, t] = A(x, y) mueller_I[r] (+ B(x, y) samples[r, t]).
// Rows of a band without tables are written as zeros.
//
// Contract: bit-equal to the plain chain on the card. Every float32
// operation is the plain chain's, in its order, rounded alone (the _rn
// intrinsics: nothing contracts into an FMA); logf is the accurate one
// that torch.log calls; the clamps pass NaN through, as torch.clamp does
// on the card; a division by a Python scalar (the axis step) is torch's
// on a CUDA tensor: a product with the reciprocal taken in double and
// rounded to float32; the axis origins arrive rounded to float32, as torch
// rounds a Python scalar; a general axis's points are the float32 side the
// plain chain reads. Both tables of a band share the cell and weights, which
// the plain chain computes twice to the same bits.
//
// What bounds it on an H100: memory, with its instructions close behind.
// At the ACT cell's CMB stage (9,000 x 12,000 fine samples) it reads the
// fine pwv and elevation and the static samples and writes the field, 16
// bytes a sample, 1.73 GB: 0.52 ms at 3.35 TB/s. A thread's four samples
// take 502 warp instructions on the path of a log pwv axis and a uniform
// elevation axis (one logf, ~48 float32 operations and the corner loads
// from shared memory a sample), 0.41 ms issued one a cycle; the loading's
// one table, 426 (chip_smoke.py's TAB_BODY, counted from the SASS; PERF.md
// section 6).
// Design:
// - one launch covers up to kMaxBands bands: each block belongs to one
//   band (the descriptors carry each band's first block) and copies that
//   band's tables (interleaved, entry k of cell c at K c + k, so two tables
//   are one float2 a corner) and general axes' sides into shared memory;
// - a thread takes four consecutive samples of one row: 16-byte loads and
//   stores along t where every row starts 16-byte aligned, else four
//   masked scalar accesses;
// - a band's rows are a run (row0, n_rows) or an int32 index, so that a
//   band whose rows interleave with another's and a mesh rank's rows both
//   work; the static samples are the band's own array, row r at r ld.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // threads a block, four samples each
constexpr int kMaxBands = 16;      // bands a launch
constexpr int kSmemFloats = 8192;  // a band's floats that shared memory takes (32 KB); past this, global reads

enum AxisKind { kUniform = 0, kLog = 1, kGeneral = 2 };

}  // namespace

// One axis of a band's tables; mirrored by ops/band_tables.py::BandAxis.
struct BandAxis {
  int kind;        // AxisKind
  int n;           // grid points
  float origin;    // uniform: the first point; log: its log (float32, as torch rounds a Python scalar)
  float inv_step;  // uniform and log: 1 / step in double, rounded to float32
  int side;        // general: the offset of the axis's float32 points among the band's floats
  int pad;
};

// One band of a launch; mirrored by ops/band_tables.py::BandDesc.
struct BandDesc {
  const float* samples;  // two tables: the static samples, row r at samples + r * ld_samples
  const int* index;      // the band's rows, or null for the run row0 .. row0 + n_rows
  long long ld_samples;
  long long block0;      // the band's first block (set by maria_band_tables)
  int n_rows, row0;
  int n_tables;          // 0: the rows are written as zeros; else the launch's K
  int floats;            // the offset of the band's floats in `packed` (a multiple of 4)
  int n_floats;          // tables then general sides
  int pad;
  BandAxis x, y;
};

namespace {

struct Launch {
  BandDesc bands[kMaxBands];
  int n_bands;
};

// torch.clamp(u, lo, hi) on the card: NaN passes through.
__device__ __forceinline__ float clamp_nan(float u, float lo, float hi) {
  return isnan(u) ? u : fminf(fmaxf(u, lo), hi);
}

// band.fractional_index(transform, x, torch) on the card.
__device__ __forceinline__ float fractional_index(const BandAxis& a, const float* __restrict__ floats, float x) {
  if (a.kind == kUniform) return __fmul_rn(__fsub_rn(x, a.origin), a.inv_step);
  if (a.kind == kLog) return __fmul_rn(__fsub_rn(logf(x), a.origin), a.inv_step);
  const float* side = floats + a.side;
  int lo = 0, hi = a.n;  // torch.searchsorted(side, x, right=True)
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(side[mid] > x))
      lo = mid + 1;
    else
      hi = mid;
  }
  const int i = min(max(lo - 1, 0), a.n - 2);
  return __fadd_rn((float)i, __fdiv_rn(__fsub_rn(x, side[i]), __fsub_rn(side[i + 1], side[i])));
}

// The cell index and weight of one axis: TableEval's clamp, floor and clamp.
__device__ __forceinline__ void cell(const BandAxis& a, const float* __restrict__ floats, float x, int& i, float& w) {
  const float u = clamp_nan(fractional_index(a, floats, x), 0.f, (float)(a.n - 1));
  i = min(max((int)floorf(u), 0), a.n - 2);  // NaN converts to 0, as to int64
  w = __fsub_rn(u, (float)i);
}

__device__ __forceinline__ float bilinear(float c00, float c01, float c10, float c11, float wu, float wv, float a,
                                          float b) {
  const float s = __fadd_rn(__fmul_rn(__fmul_rn(c00, a), b), __fmul_rn(__fmul_rn(c01, a), wv));
  return __fadd_rn(__fadd_rn(s, __fmul_rn(__fmul_rn(c10, wu), b)), __fmul_rn(__fmul_rn(c11, wu), wv));
}

// One sample's value: A mueller_I (K = 1) or A mueller_I + B s (K = 2).
template <int K>
__device__ __forceinline__ float band_value(const BandDesc& d, const float* __restrict__ floats, float x, float y,
                                            float mueller, float s) {
  int i, j;
  float wu, wv;
  cell(d.x, floats, x, i, wu);
  cell(d.y, floats, y, j, wv);
  const float a = __fsub_rn(1.f, wu), b = __fsub_rn(1.f, wv);
  const int base = i * d.y.n + j;
  if (K == 1) {
    const float p = bilinear(floats[base], floats[base + 1], floats[base + d.y.n], floats[base + d.y.n + 1], wu, wv,
                             a, b);
    return __fmul_rn(mueller, p);
  }
  const float2* t2 = reinterpret_cast<const float2*>(floats);
  const float2 c00 = t2[base], c01 = t2[base + 1], c10 = t2[base + d.y.n], c11 = t2[base + d.y.n + 1];
  const float p0 = bilinear(c00.x, c01.x, c10.x, c11.x, wu, wv, a, b);
  const float p1 = bilinear(c00.y, c01.y, c10.y, c11.y, wu, wv, a, b);
  return __fadd_rn(__fmul_rn(p0, mueller), __fmul_rn(p1, s));
}

template <int K, bool kVec, bool kShared>
__global__ void __launch_bounds__(kThreads)
    band_tables_kernel(const Launch launch, const float* __restrict__ packed, const float* __restrict__ pwv,
                       long long ld_pwv, const float* __restrict__ el, long long ld_el,
                       const float* __restrict__ mueller_I, int n_t, float* __restrict__ out, long long ld_out) {
  __shared__ __align__(16) float smem[kShared ? kSmemFloats : 4];
  const long long block = blockIdx.x;
  int b = 0;
  while (b + 1 < launch.n_bands && launch.bands[b + 1].block0 <= block) ++b;
  const BandDesc d = launch.bands[b];
  const float* floats = packed + d.floats;
  if (kShared) {
    for (int k = threadIdx.x; k < d.n_floats; k += kThreads) smem[k] = __ldg(floats + k);
    __syncthreads();
    floats = smem;
  }
  const int quads = (n_t + 3) >> 2;
  const long long g = (block - d.block0) * kThreads + threadIdx.x;
  if (g >= (long long)d.n_rows * quads) return;
  const int r = (int)(g / quads);
  const int t = (int)(g - (long long)r * quads) * 4;
  const long long row = d.index != nullptr ? __ldg(d.index + r) : d.row0 + r;
  float* o = out + row * ld_out + t;
  if (d.n_tables == 0) {
    if (kVec) {
      *reinterpret_cast<float4*>(o) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int k = 0; k < 4 && t + k < n_t; ++k) o[k] = 0.f;
    }
    return;
  }
  const float mueller = __ldg(mueller_I + row);
  const float* p = pwv + row * ld_pwv + t;
  const float* e = el + row * ld_el + t;
  const float* s = K == 2 ? d.samples + r * d.ld_samples + t : nullptr;
  float x[4], y[4], sv[4] = {0.f, 0.f, 0.f, 0.f}, v[4];
  if (kVec) {
    const float4 x4 = __ldg(reinterpret_cast<const float4*>(p)), y4 = __ldg(reinterpret_cast<const float4*>(e));
    x[0] = x4.x, x[1] = x4.y, x[2] = x4.z, x[3] = x4.w;
    y[0] = y4.x, y[1] = y4.y, y[2] = y4.z, y[3] = y4.w;
    if (K == 2) {
      const float4 s4 = __ldg(reinterpret_cast<const float4*>(s));
      sv[0] = s4.x, sv[1] = s4.y, sv[2] = s4.z, sv[3] = s4.w;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = band_value<K>(d, floats, x[k], y[k], mueller, sv[k]);
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int k = 0; k < 4 && t + k < n_t; ++k)
      o[k] = band_value<K>(d, floats, __ldg(p + k), __ldg(e + k), mueller, K == 2 ? __ldg(s + k) : 0.f);
  }
}

template <int K, bool kVec>
void launch_kernel(bool shared, const Launch& launch, long long n_blocks, const float* packed, const float* pwv,
                   long long ld_pwv, const float* el, long long ld_el, const float* mueller_I, int n_t, float* out,
                   long long ld_out, cudaStream_t stream) {
  if (shared)
    band_tables_kernel<K, kVec, true><<<(unsigned)n_blocks, kThreads, 0, stream>>>(
        launch, packed, pwv, ld_pwv, el, ld_el, mueller_I, n_t, out, ld_out);
  else
    band_tables_kernel<K, kVec, false><<<(unsigned)n_blocks, kThreads, 0, stream>>>(
        launch, packed, pwv, ld_pwv, el, ld_el, mueller_I, n_t, out, ld_out);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" int maria_band_tables_desc_bytes() { return (int)sizeof(BandDesc); }
extern "C" int maria_band_tables_max_bands() { return kMaxBands; }
extern "C" int maria_band_tables_smem_floats() { return kSmemFloats; }

// out (rows of the call, n_t) from pwv and el (the same rows, n_t; row
// strides ld_pwv, ld_el, ld_out, unit stride along t), mueller_I (the rows)
// and n_bands <= kMaxBands band descriptors whose tables take n_tables (1
// or 2) floats a cell in `packed`; `shared` says that every band's floats
// fit in shared memory. Every array float32 on the card.
extern "C" int maria_band_tables(const BandDesc* bands, int n_bands, int n_tables, int shared, const float* packed,
                                 const float* pwv, long long ld_pwv, const float* el, long long ld_el,
                                 const float* mueller_I, int n_t, float* out, long long ld_out, cudaStream_t stream) {
  if (n_bands < 0 || n_bands > kMaxBands || (n_tables != 1 && n_tables != 2)) return (int)cudaErrorInvalidValue;
  if (n_t <= 0) return 0;
  Launch launch{};
  launch.n_bands = n_bands;
  const long long quads = (n_t + 3) / 4;
  long long n_blocks = 0;
  bool vec = n_t % 4 == 0 && ld_pwv % 4 == 0 && ld_el % 4 == 0 && ld_out % 4 == 0 && aligned16(pwv) &&
             aligned16(el) && aligned16(out);
  for (int b = 0; b < n_bands; ++b) {
    BandDesc d = bands[b];
    if (d.n_tables != 0 && d.n_tables != n_tables) return (int)cudaErrorInvalidValue;
    if (shared && d.n_floats > kSmemFloats) return (int)cudaErrorInvalidValue;
    if (d.n_tables == 2) vec = vec && d.ld_samples % 4 == 0 && aligned16(d.samples);
    d.block0 = n_blocks;
    n_blocks += ((long long)d.n_rows * quads + kThreads - 1) / kThreads;
    launch.bands[b] = d;
  }
  if (n_blocks == 0) return 0;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const bool sh = shared != 0;
  if (n_tables == 1) {
    if (vec)
      launch_kernel<1, true>(sh, launch, n_blocks, packed, pwv, ld_pwv, el, ld_el, mueller_I, n_t, out, ld_out, stream);
    else
      launch_kernel<1, false>(sh, launch, n_blocks, packed, pwv, ld_pwv, el, ld_el, mueller_I, n_t, out, ld_out, stream);
  } else {
    if (vec)
      launch_kernel<2, true>(sh, launch, n_blocks, packed, pwv, ld_pwv, el, ld_el, mueller_I, n_t, out, ld_out, stream);
    else
      launch_kernel<2, false>(sh, launch, n_blocks, packed, pwv, ld_pwv, el, ld_el, mueller_I, n_t, out, ld_out, stream);
  }
  return (int)cudaGetLastError();
}
