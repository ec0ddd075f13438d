// Semi-empirical plume: ion current density at 91 angles, the divergence angle
// and the divergence-corrected thrust, for every row of a batch in one launch.
//
// Replaces no TPU kernel: the JAX package runs models/plume.py's
// `current_density` under `jit`, where XLA fuses it. PyTorch runs the same
// function eagerly, and there it is ~1,300 operators a call: four evaluations
// of Weideman's Faddeeva approximation, each a 36-term complex Horner chain of
// 7 operators a term, then the beam, the floor and two Simpson sums. On the
// card each operator is a launch of a few nanoseconds of work and ~7-9 us of
// host time, so the plume took 10-18 ms of host time a call while the card sat
// idle. This kernel computes the whole function in one launch. The plain
// version is `current_density_plain` in ../plume.py; `current_density` takes
// this kernel for a CUDA tensor and the plain version for a CPU one.
//
// Arithmetic. Every operation is the plain version's, in the same order and in
// the same type T (float or double: P_b's), so with `-fmad=false` and precise
// math the two differ only in the order of the two Simpson sums and in the last
// bit of a transcendental function. Each input is read in its own type (float
// or double) and rounded to T as `.to()` rounds it. Every constant comes from the
// Python side as a double and is rounded once to T here, as PyTorch rounds a
// Python scalar. The angle grid, its cosines and sines and the Simpson weights
// are a (4, 91) tensor made by PyTorch on the device in T (`_grid` in
// ../plume.py), so they are the plain version's own values.
//
// Design. One warp per row, four rows a block. Lanes 0-3 run the four Horner
// chains (exp(-a^2) erfi(a) and exp(-a^2) Re erfi(a + ib) at the main and the
// scattered beam's divergence; the other lanes repeat them) and broadcast them
// by shuffle. Lane l takes angles l, l + 32 and l + 64. A fixed butterfly of
// shuffles sums the two Simpson integrals and tests `all(j_ion > 0)`, so a
// row's result does not depend on the rows beside it or on how many there are.
//
// What bounds it on an H100: neither bytes nor operations. A row reads 10
// values and writes 93 and costs ~3,100 operations; at 1,472 rows that is a
// least time of 0.07 us by operations and 0.18 us by bytes. It takes ~6 us a
// launch (an H100 80GB HBM3 at 700 W, chip_smoke.py phase 22): the launch and
// the Horner chains' latency set its time; the goal is one launch, not a
// roofline.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kAngles = 91;
constexpr int kCoefs = 36;  // Weideman's polynomial degree
constexpr int kRowsPerBlock = 4;
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr unsigned kFull = 0xffffffffu;
enum { kPb, kC0, kC1, kC2, kC3, kC4, kC5, kSigma, kIB0, kT, kInputs };

}  // namespace

// Mirror of `PlumeArgs` in ../plume.py (same field order).
struct PlumeArgs {
  const void* in[kInputs];    // P_b, c0..c5, sigma_cex, I_B0, T: one value a row
  long long stride[kInputs];  // elements between two rows' values (0: broadcast)
  const void* grid;           // (4, 91) in T: alpha, cos(alpha), sin(alpha), Simpson weights
  void* j_ion;                // (rows, 91) in T
  void* div_angle;            // (rows,) in T
  void* T_c;                  // (rows,), written when has_T: double when Tc_f64, else float
  int rows;
  int has_T;
  int in_f64;  // bit k: input k is double (else float); each is rounded to T as .to() rounds it
  int Tc_f64;  // T_c in double: the type T * cos_div promotes to
  double coef[kCoefs];  // ops.special._A
  double L, inv_sqrt_pi, sqrt_pi_2, two_sqrt_pi, norm, torr_2_pa, half_pi, pi, alpha_off, floor_j;
  double neg_radius, radius_sq, cex_area;
};

__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_cos(float x) { return cosf(x); }
__device__ __forceinline__ double m_cos(double x) { return cos(x); }
__device__ __forceinline__ float m_sin(float x) { return sinf(x); }
__device__ __forceinline__ double m_sin(double x) { return sin(x); }
__device__ __forceinline__ float m_acos(float x) { return acosf(x); }
__device__ __forceinline__ double m_acos(double x) { return acos(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }

// torch.clamp: NaN stays NaN
template <class T>
__device__ __forceinline__ T clamp_max(T x, T hi) {
  return x > hi ? hi : x;
}

// (Re w, Im w) of the Faddeeva function at x + iy, y >= 0: ops.special.wofz_parts
template <class T>
__device__ __forceinline__ void wofz_parts(const PlumeArgs& a, T x, T y, T& wr, T& wi) {
  const T L = (T)a.L;
  const T dr = L + y;
  const T di = -x;
  const T d2 = dr * dr + di * di;
  const T nr = L - y;
  const T ni = x;
  const T zr = (nr * dr + ni * di) / d2;
  const T zi = (ni * dr - nr * di) / d2;
  T pr = 0, pi = 0;
#pragma unroll
  for (int k = 0; k < kCoefs; ++k) {
    const T npr = pr * zr - pi * zi + (T)a.coef[k];
    const T npi = pr * zi + pi * zr;
    pr = npr;
    pi = npi;
  }
  const T d2r = dr * dr - di * di;
  const T d2i = (T)2 * dr * di;
  const T d2n = d2r * d2r + d2i * d2i;
  wr = (T)2 * (pr * d2r + pi * d2i) / d2n + (T)a.inv_sqrt_pi * dr / d2;
  wi = (T)2 * (pi * d2r - pr * d2i) / d2n + (T)a.inv_sqrt_pi * (-di) / d2;
}

// Lane role r of _gaussian_norm's four terms: r = 0, 1 at alpha1, 2, 3 at alpha2;
// even r: exp(-a^2) erfi(a), odd r: exp(-a^2) Re erfi(a + ib), a = alpha/2, b = pi/(2 alpha)
template <class T>
__device__ __forceinline__ T norm_term(const PlumeArgs& a, T alpha, int r) {
  const T ga = alpha / (T)2;
  const T gb = (T)a.pi / ((T)2 * alpha);
  T wr, wi;
  if (r & 1) {
    wofz_parts(a, ga, gb, wr, wi);
    const T phase = (T)2 * ga * gb;
    return m_exp(-(gb * gb)) * (wi * m_cos(phase) + wr * m_sin(phase));
  }
  wofz_parts(a, m_abs(ga), (T)0, wr, wi);
  const T sign = (T)(((T)0 < ga) - (ga < (T)0));  // torch.sign: 0 at NaN
  return (T)a.two_sqrt_pi * (sign * (T)a.sqrt_pi_2 * wi);
}

template <class T>
__global__ void __launch_bounds__(kThreads) plume_kernel(PlumeArgs a) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= a.rows) return;  // the whole warp
  const T* grid = (const T*)a.grid;
  double raw[kInputs];  // exact: a float widens to double without rounding
#pragma unroll
  for (int k = 0; k < kInputs; ++k) {
    const long long i = row * a.stride[k];
    raw[k] = (k == kT && !a.has_T) ? 0.0
             : ((a.in_f64 >> k) & 1) ? ((const double*)a.in[k])[i] : (double)((const float*)a.in[k])[i];
  }
  T in[kInputs];
#pragma unroll
  for (int k = 0; k < kInputs; ++k) in[k] = (T)raw[k];

  const T P_B = in[kPb] * (T)a.torr_2_pa;
  const T n = in[kC4] * P_B + in[kC5];
  const T alpha1 = clamp_max(in[kC2] * P_B + in[kC3], (T)a.half_pi);
  bool valid = alpha1 > (T)0;
  const T alpha1_safe = valid ? alpha1 : (T)a.alpha_off;
  const T alpha2 = alpha1_safe / in[kC1];

  // the four Horner chains, one a lane, broadcast to the warp
  const int r = lane & 3;
  const T e = norm_term(a, r < 2 ? alpha1_safe : alpha2, r);
  const T e1a = __shfl_sync(kFull, e, 0), e2a = __shfl_sync(kFull, e, 1);
  const T e1b = __shfl_sync(kFull, e, 2), e2b = __shfl_sync(kFull, e, 3);
  const T norm1 = (T)a.norm * alpha1_safe * ((T)2 * (e1a - e2a));
  const T norm2 = (T)a.norm * alpha2 * ((T)2 * (e1b - e2b));
  const T A1 = ((T)1 - in[kC0]) / norm1;
  const T A2 = in[kC0] / norm2;

  const T decay = m_exp((n * (T)a.neg_radius) * in[kSigma]);
  const T j_cex = in[kIB0] * ((T)1 - decay) / (T)a.cex_area;
  const T base = in[kIB0] * decay / (T)a.radius_sq;
  const T b1 = base * A1, b2 = base * A2;

  // lane's angles: j_ion, the floor test and its terms of the two Simpson sums
  T j_ion[3];
  int positive = 1;
  T num = 0, den = 0;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int i = lane + 32 * s;
    if (i >= kAngles) break;
    const T q1 = grid[i] / alpha1_safe, q2 = grid[i] / alpha2;
    const T non_cex = b1 * m_exp(-(q1 * q1)) + b2 * m_exp(-(q2 * q2));
    j_ion[s] = non_cex + j_cex;
    positive &= j_ion[s] > (T)0;
    // the flipped profile: angle i is the integrand's sample 90 - i
    const int k = kAngles - 1 - i;
    const T den_k = non_cex * grid[kAngles + k];
    den += den_k * grid[3 * kAngles + k];
    num += den_k * grid[2 * kAngles + k] * grid[3 * kAngles + k];
  }
#pragma unroll
  for (int m = 16; m >= 1; m /= 2) {
    num += __shfl_xor_sync(kFull, num, m);
    den += __shfl_xor_sync(kFull, den, m);
    positive &= __shfl_xor_sync(kFull, positive, m);
  }
  valid = valid && positive;

  T* j_out = (T*)a.j_ion + row * kAngles;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int i = lane + 32 * s;
    if (i >= kAngles) break;
    j_out[i] = valid ? j_ion[s] : (T)a.floor_j;
  }
  if (lane == 0) {
    T cos_div = num / den;
    if (!isfinite(cos_div)) cos_div = NAN;
    const T c = cos_div < (T)-1 ? (T)-1 : clamp_max(cos_div, (T)1);
    ((T*)a.div_angle)[row] = m_acos(c);
    if (a.has_T && a.Tc_f64)
      ((double*)a.T_c)[row] = raw[kT] * (double)cos_div;
    else if (a.has_T)
      ((float*)a.T_c)[row] = (float)raw[kT] * (float)cos_div;
  }
}

template <class T>
static void launch(const PlumeArgs* a, cudaStream_t s) {
  const int blocks = (a->rows + kRowsPerBlock - 1) / kRowsPerBlock;
  plume_kernel<T><<<blocks, kThreads, 0, s>>>(*a);
}

extern "C" int plume_args_size() { return (int)sizeof(PlumeArgs); }

// Launch on `stream` (a cudaStream_t) in float (dtype 0) or double (dtype 1).
// Returns the cudaError_t of the launch (0 on success); does not synchronise.
extern "C" int plume_launch(const PlumeArgs* a, int dtype, void* stream) {
  if (a->rows <= 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    launch<float>(a, (cudaStream_t)stream);
  else
    launch<double>(a, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
