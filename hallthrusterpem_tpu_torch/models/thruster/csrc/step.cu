// One-step 1-D Hall-discharge solver: one launch advances every sample one timestep.
//
// Replaces the TPU kernel `build_step_kernel` of the JAX package
// (hallthrusterpem_tpu/models/thruster/pallas_step.py:574, pallas_call at :637):
// the K = 1 instance of the K-step kernel's physics (`physics_step` of
// physics.cuh), with the state scrubbed on entry every step and the circuit
// current read from scalar slot P_ICIR. It writes the new state in place and
// five lane arrays: lanes 0/1/2 of the first hold j_d and the exit-plane scale
// factors qs_t/qs_f, the other four hold Te, ne, E and the neutral density. The
// plain PyTorch version is `step_plain` in ../fused_step.py; its driver, which
// accumulates the time averages on the host side and checks every state array
// for non-finite values after each step, is ../one_step.py.
//
// Design. One thread block per sample, one thread per lane, as in the K-step
// kernel; bounded at kMaxLanes threads for every width. In-place update is
// safe: each thread reads only its own lane from device memory, before any
// thread of the block writes.
//
// What bounds it on an H100: bytes, on paper. Per lane it reads 8 state
// arrays, nu_anom and omega_ce and writes 8 state arrays and 5 outputs (~92
// bytes at fidelity (2,2)) against ~1.05e3 float32 operations, a least time of
// ~7 us at B = 1024. Measured, it takes ~30 us a launch on an H100 80GB HBM3
// at 700 W (chip_smoke.py phase 11) with four blocks per SM (kMinBlocksPerSM),
// which put 1024 samples in two waves of 528 blocks (32.5 us at the 80
// registers and three blocks per SM it gets without a minimum); as for the
// K-step kernel, the issue rate of its instructions is the working hypothesis.
// The one-step loop's host work per step costs more than the kernel.

#include "physics.cuh"

template <int Z, int G>
__global__ void __launch_bounds__(kMaxLanes, kMinBlocksPerSM)
step_kernel(KParams p, int B, float* __restrict__ state, float* __restrict__ extras,
            const float* __restrict__ nu_anom_g, const float* __restrict__ omega_g,
            const float* __restrict__ scal_g, const float* __restrict__ coef_g) {
  const int LN = blockDim.x;
  const int l = threadIdx.x;
  const int b = blockIdx.x;
  const size_t plane = (size_t)B * LN;
  const size_t off = (size_t)b * LN + l;

  __shared__ Shared s;
  const Invariants v = load_invariants<Z>(p, s, B, l, LN, nu_anom_g, omega_g, scal_g, coef_g);
  Lane<Z, G> st;
  load_scrub<Z, G>(p, state, plane, off, st);
  const float icir = scal_g[(size_t)b * kSlots + P_ICIR];
  const StepOut o = physics_step<Z, G>(p, v, s, st, icir, l, LN);

  store_state<Z, G>(state, plane, off, st);
  extras[off] = (l == 1) ? v.qs_t : ((l == 2) ? v.qs_f : o.j_d);
  extras[plane + off] = o.Te;
  extras[2 * plane + off] = o.ne;
  extras[3 * plane + off] = o.E_z;
  extras[4 * plane + off] = o.nn;
}

template <int Z, int G>
static void launch(const KParams& p, int B, int LN, cudaStream_t s, void* state, void* extras,
                   const void* nu_anom, const void* omega, const void* scalars, const void* coef) {
  step_kernel<Z, G><<<B, LN, 0, s>>>(p, B, (float*)state, (float*)extras, (const float*)nu_anom,
                                     (const float*)omega, (const float*)scalars, (const float*)coef);
}

extern "C" int step_params_size() { return (int)sizeof(KParams); }

// Launch one timestep on `stream` (a cudaStream_t) for Z charge states and G
// neutral groups. Returns the cudaError_t of the launch (0 on success); does
// not synchronise.
extern "C" int step_launch(const KParams* p, int Z, int G, int B, int LN, void* state, void* extras,
                           const void* nu_anom, const void* omega, const void* scalars,
                           const void* coef, void* stream) {
  static decltype(&launch<1, 1>) const table[2][3] = {
      {launch<1, 1>, launch<2, 1>, launch<3, 1>}, {launch<1, 2>, launch<2, 2>, launch<3, 2>}};
  if (Z < 1 || Z > 3 || G < 1 || G > 2 || !width_ok(LN)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || p->NC > LN - 2 || p->NC < 4) return (int)cudaErrorInvalidValue;
  table[G - 1][Z - 1](*p, B, LN, (cudaStream_t)stream, state, extras, nu_anom, omega, scalars, coef);
  return (int)cudaGetLastError();
}
