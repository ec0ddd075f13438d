// K-step 1-D Hall-discharge solver: one launch advances every sample K timesteps.
//
// Replaces the TPU kernel `build_multistep_kernel` of the JAX package
// (hallthrusterpem_tpu/models/thruster/pallas_step.py:677, pallas_call at :879),
// whose step body is `make_physics` (:102), here `physics_step` of physics.cuh.
// The plain PyTorch version of the same function is `kstep_plain` in
// ../fused_step.py; the two share the packed tensor layout described there.
//
// Design. One thread block per sample, one thread per lane (cell, ghost cell or
// padding lane; blockDim = LN = 128 or 256). Each thread keeps its lane's state,
// velocities and profile sums in registers across the K steps and writes them
// back once per launch, so device memory is touched once per launch and not once
// per step. Per-sample values read at one lane (lane NC-2 for the exit-plane
// accumulators) are broadcast through shared memory. Per-sample accumulators are
// kept identically by every thread and written back by thread 0. With the trace
// on, thread 0 also sets accumulator slot 8 + k to step k's discharge current
// (the I_d(t) trace lanes; K <= 120).
//
// What bounds it on an H100: operations, not bytes. A step does about 1.05e3
// float32 operations per lane (chip_smoke.py counts them) against 128 bytes of
// state, profile sums and constants per lane per launch, so at K = 50 the
// operation bound is ~20x the byte bound. The design therefore keeps all state
// in registers, spends no memory traffic per step, and leaves the arithmetic as
// written (precise expf/logf/sqrtf, true divides, no FMA contraction, which is
// set by the build flags) so that the result matches the plain version.
//
// The source includes no PyTorch header; it is built with nvcc into a shared
// library with a plain C interface and bound with ctypes (../_kernels.py).

#include "physics.cuh"

template <int Z, int G>
__global__ void __launch_bounds__(kMaxLanes)
kstep_kernel(KParams p, int B, float* __restrict__ state, float* __restrict__ prof,
             float* __restrict__ sacc, const float* __restrict__ nu_anom_g,
             const float* __restrict__ omega_g, const float* __restrict__ scal_g,
             const float* __restrict__ coef_g) {
  const int LN = blockDim.x;
  const int l = threadIdx.x;
  const int b = blockIdx.x;
  const size_t plane = (size_t)B * LN;
  const size_t off = (size_t)b * LN + l;

  __shared__ Shared s;
  const Invariants v = load_invariants<Z>(p, s, B, l, LN, nu_anom_g, omega_g, scal_g, coef_g);

  // ---- load, was-nonfinite flag, scrub (once per launch)
  Lane<Z, G> st;
  const bool bad = load_scrub<Z, G>(p, state, plane, off, st);
  float pf[Z + 4];
#pragma unroll
  for (int j = 0; j < Z + 4; ++j) pf[j] = prof[j * plane + off];
  const bool any_bad = __syncthreads_or(bad) != 0;

  float* sa = sacc + (size_t)b * kSlots;
  float acc_thrust = sa[A_THRUST], acc_id = sa[A_ID], acc_id2 = sa[A_ID2], acc_ib0 = sa[A_IB0];
  float acc_mdot = sa[A_MDOT], acc_uexit = sa[A_UEXIT];
  float failed = mx(sa[A_FAILED], any_bad ? 1.0f : 0.0f);
  float icir = sa[A_ICIR];
  const int ex = p.NC - 2;  // exit-plane lane of the accumulators
  float* bx = s.bx;

  for (int k = 0; k < p.K; ++k) {
    const StepOut o = physics_step<Z, G>(p, v, s, st, icir, l, LN);

    // ---- gated accumulation (overshoot steps of the last launch do not count)
    const int i = p.i0 + k;
    const float w = (i >= p.avg_start && i < p.num_steps) ? 1.0f : 0.0f;
    if (l == ex) {
#pragma unroll
      for (int z = 0; z < Z; ++z) {
        bx[z] = st.ri[z];
        bx[3 + z] = st.mo[z];
        bx[6 + z] = st.ui[z];
      }
    }
    __syncthreads();
    float thrust = 0.0f, I_B0 = 0.0f, mdot_ion = 0.0f;
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      const float r_ex = bx[z], m_ex = bx[3 + z], u_ex = bx[6 + z];
      thrust = thrust + p.A_ch * (m_ex * u_ex + r_ex * p.a_i2);
      I_B0 = I_B0 + p.iz_c[z] * r_ex * u_ex;
      mdot_ion = mdot_ion + p.A_ch * m_ex;
      pf[z] += w * st.ui[z];
    }
    if (p.solve_plume) {
      thrust = thrust * v.qs_t;
      I_B0 = I_B0 * v.qs_f;
      mdot_ion = mdot_ion * v.qs_f;
    }
    const float I_d = o.j_d * p.A_ch;
    pf[Z] += w * o.Te;
    pf[Z + 1] += w * o.ne;
    pf[Z + 2] += w * o.E_z;
    pf[Z + 3] += w * o.nn;
    acc_thrust += w * thrust;
    acc_id += w * I_d;
    acc_id2 += w * I_d * I_d;
    acc_ib0 += w * I_B0;
    acc_mdot += w * mdot_ion;
    acc_uexit += w * bx[6];
    failed = mx(failed, isfinite(I_d) ? 0.0f : 1.0f);
    icir = I_d;
    if (p.trace && l == 0) sa[kTrace0 + k] = I_d;
  }

  // ---- write back once per launch
  store_state<Z, G>(state, plane, off, st);
#pragma unroll
  for (int j = 0; j < Z + 4; ++j) prof[j * plane + off] = pf[j];
  if (l == 0) {
    sa[A_THRUST] = acc_thrust;
    sa[A_ID] = acc_id;
    sa[A_ID2] = acc_id2;
    sa[A_IB0] = acc_ib0;
    sa[A_MDOT] = acc_mdot;
    sa[A_UEXIT] = acc_uexit;
    sa[A_FAILED] = failed;
    sa[A_ICIR] = icir;
  }
}

template <int Z, int G>
static void launch(const KParams& p, int B, int LN, cudaStream_t s, void* state, void* prof,
                   void* sacc, const void* nu_anom, const void* omega, const void* scalars,
                   const void* coef) {
  kstep_kernel<Z, G><<<B, LN, 0, s>>>(p, B, (float*)state, (float*)prof, (float*)sacc,
                                      (const float*)nu_anom, (const float*)omega,
                                      (const float*)scalars, (const float*)coef);
}

extern "C" int kstep_params_size() { return (int)sizeof(KParams); }

// Launch one K-step block on `stream` (a cudaStream_t) for Z charge states and G
// neutral groups. Returns the cudaError_t of the launch (0 on success); does
// not synchronise.
extern "C" int kstep_launch(const KParams* p, int Z, int G, int B, int LN, void* state, void* prof,
                            void* sacc, const void* nu_anom, const void* omega,
                            const void* scalars, const void* coef, void* stream) {
  static decltype(&launch<1, 1>) const table[2][3] = {
      {launch<1, 1>, launch<2, 1>, launch<3, 1>}, {launch<1, 2>, launch<2, 2>, launch<3, 2>}};
  if (Z < 1 || Z > 3 || G < 1 || G > 2 || (LN != 128 && LN != kMaxLanes)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || p->NC > LN - 2 || p->NC < 4 || p->K <= 0) return (int)cudaErrorInvalidValue;
  if (p->trace && p->K > kSlots - kTrace0) return (int)cudaErrorInvalidValue;
  table[G - 1][Z - 1](*p, B, LN, (cudaStream_t)stream, state, prof, sacc, nu_anom, omega, scalars, coef);
  return (int)cudaGetLastError();
}
