// The mappers' flat nearest-pixel ids from the factorized pointing, in one
// pass over the (detector, sample) pairs.
//
// Replaces no TPU kernel. It replaces the port's plain torch chain
// (ops/pixel_ids.py::pixel_ids_plain: the ra/dec rotation of
// Pointing.offsets_radec, coords.offsets_to_phi_theta around the
// boresight, phi_theta_to_offsets around the map's centre and the rounding
// to flat ids), some 90 elementwise launches over every sample, each a
// pass through device memory, several over strided (..., 2) views.
//
// For detector d with tangent-plane offsets (ox, oy) and sample t with the
// boresight (phi_t, theta_t) and, in ra/dec, cos q_t and sin q_t:
//   (dx, dy) = (c ox - s oy, s ox + c oy) in ra/dec, (ox, oy) in az/el;
//   r = |(dx, dy)|, (phi, theta) = the point r from the boresight along
//     (dx, dy): sin theta = sin theta_t cos r + cos theta_t sinc(r) dy,
//     phi = phi_t + atan2(-sinc(r) dx, cos theta_t cos r - sin theta_t sinc(r) dy);
//   (X, Y) = the azimuthal-equidistant offsets of (phi, theta) around the
//     map's centre (phi_c, theta_c);
//   ix = int(round((X - x0) / res)), iy likewise (round half to even); the
//     id iy n_x + ix, and -1 where ix or iy falls off the map.
//
// Contract: bit-equal to the plain chain on the card. Every float32
// operation is the plain chain's, in its order, rounded alone (the _rn
// intrinsics: nothing contracts into an FMA); the functions are the ones
// torch calls on the card (sinf, cosf, atan2f, asinf; sqrt and division
// correctly rounded), torch.sinc as torch writes it (1 at 0, else
// sin(pi a) / (pi a) with pi rounded to float32), the where-guards at
// r = 0 and sin r = 0 kept, clip's NaN passed through, and the cast to
// int32 the card's (truncation, NaN to 0, saturating). The Python scalars
// arrive rounded to float32 as torch rounds them, and a division by one
// (by pi, by res) is torch's on a CUDA tensor: a product with the
// reciprocal taken in double and rounded to float32.
//
// What bounds it on an H100: at the ACT cell (9,000 x 12,000 samples into
// 577 x 577) it writes one int32 a sample, 432 MB (0.13 ms at 3.35 TB/s),
// and reads ~0.3 MB. Its instructions bound it more: nine float32 libm
// calls (three sinf, three cosf, two atan2f, one asinf), two correctly
// rounded square roots and divisions and ~45 float32 operations a sample,
// 402 warp instructions on the common path of the SASS (sm_90a), one
// issued a cycle: 1.30 ms at the ACT cell (chip_smoke.py's PIX_BODY;
// PERF.md section 6).
// Design:
// - a block is kThreads consecutive samples of kRows detectors, a thread a
//   sample: each warp's stores are 128 contiguous bytes of one row;
// - each thread reads its sample's boresight (and cos q, sin q) once and
//   keeps it, with sin and cos of the boresight's theta, in registers over
//   the block's rows: the plain chain computes those per sample too, so
//   the bits are the same;
// - a detector's two offsets are the same address across the block,
//   read through the read-only path;
// - the rotation is a template argument: az/el skips it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // samples a block, along t
constexpr int kRows = 16;      // detectors a block

// The map's geometry and the constants of the chain, as float32.
struct PixelGeometry {
  float c_phi, sin_c, cos_c;  // the centre's phi; sin and cos of its theta, taken in double
  float x0, y0, inv_res;      // the first pixel's offsets; 1 / res in double, rounded
  float inv_pi;               // 1 / pi in double, rounded
  int n_x, n_y;
};

// torch.sinc on the card: 1 at 0, else sin(pi a) / (pi a).
__device__ __forceinline__ float sinc(float a) {
  if (a == 0.f) return 1.f;
  const float p = __fmul_rn(3.14159265358979323846f, a);
  return __fdiv_rn(sinf(p), p);
}

// torch.clip(x, -1, 1) on the card: NaN passes through.
__device__ __forceinline__ float clip1(float x) { return isnan(x) ? x : fminf(fmaxf(x, -1.f), 1.f); }

// torch.round(x).to(torch.int32) on the card.
__device__ __forceinline__ int round_to_int(float x) { return __float2int_rz(rintf(x)); }

template <bool kRotate>
__global__ void __launch_bounds__(kThreads)
    pixel_ids_kernel(const float* __restrict__ offsets, const float* __restrict__ phi,
                     const float* __restrict__ theta, const float* __restrict__ cos_q,
                     const float* __restrict__ sin_q, int n_det, int n_t, const PixelGeometry g,
                     int* __restrict__ ids) {
  const int t = blockIdx.y * kThreads + threadIdx.x;
  if (t >= n_t) return;
  const int d0 = blockIdx.x * kRows, d1 = min(d0 + kRows, n_det);
  const float b_phi = __ldg(phi + t), b_theta = __ldg(theta + t);
  const float sin_b = sinf(b_theta), cos_b = cosf(b_theta);
  float cq = 0.f, sq = 0.f;
  if (kRotate) {
    cq = __ldg(cos_q + t);
    sq = __ldg(sin_q + t);
  }
  for (int d = d0; d < d1; ++d) {
    const float ox = __ldg(offsets + 2 * d), oy = __ldg(offsets + 2 * d + 1);
    float dx = ox, dy = oy;
    if (kRotate) {  // Pointing.offsets_radec
      dx = __fsub_rn(__fmul_rn(cq, ox), __fmul_rn(sq, oy));
      dy = __fadd_rn(__fmul_rn(sq, ox), __fmul_rn(cq, oy));
    }
    // offsets_to_phi_theta around the boresight
    const float r2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    const float r = r2 > 0.f ? __fsqrt_rn(r2) : 0.f;
    const float s = sinc(__fmul_rn(r, g.inv_pi));
    const float cos_r = cosf(r);
    const float sin_theta = __fadd_rn(__fmul_rn(sin_b, cos_r), __fmul_rn(__fmul_rn(cos_b, s), dy));
    const float merid = __fsub_rn(__fmul_rn(cos_b, cos_r), __fmul_rn(__fmul_rn(sin_b, s), dy));
    const float p_phi = __fadd_rn(b_phi, atan2f(__fmul_rn(-s, dx), merid));
    const float p_theta = asinf(clip1(sin_theta));
    // phi_theta_to_offsets around the map's centre
    const float dphi = __fsub_rn(p_phi, g.c_phi);
    const float cos_t = cosf(p_theta), sin_t = sinf(p_theta);
    const float u = __fmul_rn(sinf(dphi), cos_t);
    const float k = __fmul_rn(cosf(dphi), cos_t);
    const float v = __fsub_rn(__fmul_rn(k, g.sin_c), __fmul_rn(sin_t, g.cos_c));
    const float w = __fadd_rn(__fmul_rn(k, g.cos_c), __fmul_rn(sin_t, g.sin_c));
    const float s2 = __fadd_rn(__fmul_rn(u, u), __fmul_rn(v, v));
    const float sin_r = s2 > 0.f ? __fsqrt_rn(s2) : 0.f;
    const float scale = sin_r > 0.f ? __fdiv_rn(atan2f(sin_r, w), sin_r) : 1.f;
    // the nearest pixel
    const int ix = round_to_int(__fmul_rn(__fsub_rn(__fmul_rn(-u, scale), g.x0), g.inv_res));
    const int iy = round_to_int(__fmul_rn(__fsub_rn(__fmul_rn(-v, scale), g.y0), g.inv_res));
    const bool inside = ix >= 0 && ix < g.n_x && iy >= 0 && iy < g.n_y;
    ids[(long long)d * n_t + t] = inside ? iy * g.n_x + ix : -1;
  }
}

}  // namespace

// ids (n_det, n_t) int32 from offsets (n_det, 2), the boresight phi and
// theta (n_t,) and, where cos_q is not null, cos q and sin q (n_t,) (the
// ra/dec rotation); every array float32 and contiguous on the card.
extern "C" int maria_pixel_ids(const float* offsets, const float* phi, const float* theta, const float* cos_q,
                               const float* sin_q, int n_det, int n_t, float c_phi, float sin_c, float cos_c,
                               float x0, float y0, float inv_res, float inv_pi, int n_x, int n_y, int* ids,
                               cudaStream_t stream) {
  if (n_det <= 0 || n_t <= 0) return 0;
  const dim3 grid((n_det + kRows - 1) / kRows, (n_t + kThreads - 1) / kThreads);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  const PixelGeometry g{c_phi, sin_c, cos_c, x0, y0, inv_res, inv_pi, n_x, n_y};
  if (cos_q != nullptr)
    pixel_ids_kernel<true><<<grid, kThreads, 0, stream>>>(offsets, phi, theta, cos_q, sin_q, n_det, n_t, g, ids);
  else
    pixel_ids_kernel<false><<<grid, kThreads, 0, stream>>>(offsets, phi, theta, cos_q, sin_q, n_det, n_t, g, ids);
  return (int)cudaGetLastError();
}
