// K-step 1-D Hall-discharge solver: one launch advances every sample K timesteps.
//
// Replaces the TPU kernel `build_multistep_kernel` of the JAX package
// (hallthrusterpem_tpu/models/thruster/pallas_step.py:677, pallas_call at :879),
// whose step body is `make_physics` (:102), here `physics_step` of physics.cuh.
// The plain PyTorch version of the same function is `kstep_plain` in
// ../fused_step.py; the two share the packed tensor layout described there.
//
// Design. One thread block per sample, one thread per lane (cell, ghost cell or
// padding lane; blockDim = LN, a multiple of 32: 128 lanes for NC <= 126, else
// the least that holds NC + 2, so 224 at fidelity (2,2); physics.cuh says how
// neighbour reads wrap). Each thread keeps its lane's state,
// velocities and profile sums in registers across the K steps and writes them
// back once per launch, so device memory is touched once per launch and not once
// per step. The per-sample accumulators and the exit-plane scales live in
// shared memory, kept by thread 0 alone, which reads the new exit-plane state
// that physics_step leaves in `s.bx`; the other threads hold no register for
// them. With the trace on, thread 0 also sets accumulator slot 8 + k to step
// k's discharge current (the I_d(t) trace lanes; K <= 120).
//
// What bounds it on an H100. The operation bound of chip_smoke.py (0.206 ms
// at fidelity (2,2), B = 1024, K = 50, on 256 lanes) counts an operation as
// half a fused multiply-add at 67 TFLOP/s; the kernel took 5.9x that. The
// issue rate of its instructions: the plain version's ~1.05e3 float32
// operations per lane-step become 2,586 SASS instructions a warp issues per
// step of kstep<3,1> in chip_smoke.py's static count of the step loop (both
// sides of each branch; precise divisions, expf/logf, NaN-propagating
// min/max, shared loads of the rate coefficients). At the 1,980 MHz SM clock
// read under load, the 64 warps of a 256-lane layout's busiest SM would issue
// 2,629 of them in 21.2 us a step against the 24.4 us measured; a warp fewer
// a block (224 lanes) cut the time by 10.0%, as the count. Per lane and
// launch it moves only 128 bytes. The design:
// - few block barriers: 15 a step at fidelity (2,2), read from the SASS by
//   chip_smoke.py (physics.cuh says where they are), 41 before;
// - four blocks per SM (kMinBlocksPerSM in physics.cuh): each instance is
//   bounded at 256 threads (64 registers; 76 B of spill stores in
//   kstep<3,1>) and, with one neutral group, also at 224 (72 registers, 28 B)
//   for the widths between 128 and 256 lanes; 1024 samples fill two waves of
//   528 blocks on 132 SMs, the 28 warps of an SM's four 224-lane blocks 7 to
//   each scheduler;
// - explicit fmaf in the Horner steps of the rate fits, the HLLE fluxes and the
//   PCR update; the build keeps -fmad=false, so nothing else is contracted.
// Measured at fidelity (2,2), B = 1024, K = 50 (chip_smoke.py phases 2 and 6,
// NVIDIA H100 80GB HBM3, 700 W power limit), each step on top of the last:
//   the first design (41 barriers, 127 registers, 2 blocks/SM)   1.625 ms
//   (a) Ohm's-law sums by warp shuffle (33 barriers)              1.630 ms
//   (b) double-buffered PCR rows (25 barriers)                    1.564 ms
//   (c) disjoint staging rows, exit plane folded in (15 barriers)  1.524 ms
//   (d) __launch_bounds__(256, 3): 80 registers, 3 blocks/SM      1.367 ms
//       __launch_bounds__(256, 4): 64 registers, 4 blocks/SM      1.321 ms
//   accumulators kept by thread 0 in shared memory               1.276 ms
//   (e) explicit fmaf (scaled error vs plain 1.718e-6)           1.214 ms
//   PCR loop kept rolled, warp-partial sum unrolled               1.213 ms
//   (f) 224 lanes (7 warps) instead of 256, 72 registers,         1.081 ms
//       28 B of spills (1.202 ms on 256 lanes in the same run)
// The barrier cuts gave 6%; occupancy and fewer instructions gave the rest.
//
// The source includes no PyTorch header; it is built with nvcc into a shared
// library with a plain C interface and bound with ctypes (../_kernels.py).

#include "physics.cuh"

template <int Z, int G, int NT>
__global__ void __launch_bounds__(NT, kMinBlocksPerSM)
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
  __shared__ float acc[A_FAILED + 1];  // per-sample accumulators, kept by thread 0
  __shared__ float qs[2];              // exit-plane scales qs_t, qs_f, read by thread 0
  const Invariants v = load_invariants<Z>(p, s, B, l, LN, nu_anom_g, omega_g, scal_g, coef_g);

  // ---- load, was-nonfinite flag, scrub (once per launch)
  Lane<Z, G> st;
  const bool bad = load_scrub<Z, G>(p, state, plane, off, st);
  float pf[Z + 4];
#pragma unroll
  for (int j = 0; j < Z + 4; ++j) pf[j] = prof[j * plane + off];
  const bool any_bad = __syncthreads_or(bad) != 0;

  float* sa = sacc + (size_t)b * kSlots;
  if (l == 0) {
#pragma unroll
    for (int j = A_THRUST; j < A_FAILED; ++j) acc[j] = sa[j];
    acc[A_FAILED] = mx(sa[A_FAILED], any_bad ? 1.0f : 0.0f);
    qs[0] = v.qs_t;
    qs[1] = v.qs_f;
  }
  float icir = sa[A_ICIR];
  const float* bx = s.bx;  // exit-plane state (lane NC-2), set by physics_step

  for (int k = 0; k < p.K; ++k) {
    const StepOut o = physics_step<Z, G>(p, v, s, st, icir, l, LN);

    // ---- gated accumulation (overshoot steps of the last launch do not count)
    const int i = p.i0 + k;
    const float w = (i >= p.avg_start && i < p.num_steps) ? 1.0f : 0.0f;
#pragma unroll
    for (int z = 0; z < Z; ++z) pf[z] += w * st.ui[z];
    pf[Z] += w * o.Te;
    pf[Z + 1] += w * o.ne;
    pf[Z + 2] += w * o.E_z;
    pf[Z + 3] += w * o.nn;
    const float I_d = o.j_d * p.A_ch;
    icir = I_d;
    if (l == 0) {
      float thrust = 0.0f, I_B0 = 0.0f, mdot_ion = 0.0f;
#pragma unroll
      for (int z = 0; z < Z; ++z) {
        const float r_ex = bx[z], m_ex = bx[3 + z], u_ex = bx[6 + z];
        thrust = thrust + p.A_ch * (m_ex * u_ex + r_ex * p.a_i2);
        I_B0 = I_B0 + p.iz_c[z] * r_ex * u_ex;
        mdot_ion = mdot_ion + p.A_ch * m_ex;
      }
      if (p.solve_plume) {
        thrust = thrust * qs[0];
        I_B0 = I_B0 * qs[1];
        mdot_ion = mdot_ion * qs[1];
      }
      acc[A_THRUST] += w * thrust;
      acc[A_ID] += w * I_d;
      acc[A_ID2] += w * I_d * I_d;
      acc[A_IB0] += w * I_B0;
      acc[A_MDOT] += w * mdot_ion;
      acc[A_UEXIT] += w * bx[6];
      acc[A_FAILED] = mx(acc[A_FAILED], isfinite(I_d) ? 0.0f : 1.0f);
      if (p.trace) sa[kTrace0 + k] = I_d;
    }
  }

  // ---- write back once per launch
  store_state<Z, G>(state, plane, off, st);
#pragma unroll
  for (int j = 0; j < Z + 4; ++j) prof[j * plane + off] = pf[j];
  if (l == 0) {
#pragma unroll
    for (int j = A_THRUST; j <= A_FAILED; ++j) sa[j] = acc[j];
    sa[A_ICIR] = icir;
  }
}

template <int Z, int G, int NT>
static void launch(const KParams& p, int B, int LN, cudaStream_t s, void* state, void* prof,
                   void* sacc, const void* nu_anom, const void* omega, const void* scalars,
                   const void* coef) {
  kstep_kernel<Z, G, NT><<<B, LN, 0, s>>>(p, B, (float*)state, (float*)prof, (float*)sacc,
                                          (const float*)nu_anom, (const float*)omega,
                                          (const float*)scalars, (const float*)coef);
}

template <int Z, int G, int NT>
static int occupancy(int LN) {
  int n = 0;
  const auto err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kstep_kernel<Z, G, NT>, LN, 0);
  return err == cudaSuccess ? n : -(int)err;
}

// Row of KSTEP_TABLE a width takes: 0 for 128 and 256 lanes, 1 for the others.
static int bound_of(int LN) { return (LN == 128 || LN == kMaxLanes) ? 0 : 1; }

// The instances, [row][G - 1][Z - 1]: bounded at kMaxLanes threads, and at
// kNarrowLanes for one neutral group at the other widths. The two-group model
// runs its kMaxLanes instance at every width: 9 instances, not 12, keep the
// build near 1.5x that of 6.
#define KSTEP_TABLE(f)                                                              \
  {{{f<1, 1, kMaxLanes>, f<2, 1, kMaxLanes>, f<3, 1, kMaxLanes>},                   \
    {f<1, 2, kMaxLanes>, f<2, 2, kMaxLanes>, f<3, 2, kMaxLanes>}},                  \
   {{f<1, 1, kNarrowLanes>, f<2, 1, kNarrowLanes>, f<3, 1, kNarrowLanes>},          \
    {f<1, 2, kMaxLanes>, f<2, 2, kMaxLanes>, f<3, 2, kMaxLanes>}}}

extern "C" int kstep_params_size() { return (int)sizeof(KParams); }

// Blocks of LN threads that one SM holds at once for Z charge states and G
// neutral groups; a negative cudaError_t if the query fails.
extern "C" int kstep_occupancy(int Z, int G, int LN) {
  static decltype(&occupancy<1, 1, kMaxLanes>) const table[2][2][3] = KSTEP_TABLE(occupancy);
  if (Z < 1 || Z > 3 || G < 1 || G > 2 || !width_ok(LN)) return -(int)cudaErrorInvalidValue;
  return table[bound_of(LN)][G - 1][Z - 1](LN);
}

// Launch one K-step block on `stream` (a cudaStream_t) for Z charge states and G
// neutral groups. Returns the cudaError_t of the launch (0 on success); does
// not synchronise.
extern "C" int kstep_launch(const KParams* p, int Z, int G, int B, int LN, void* state, void* prof,
                            void* sacc, const void* nu_anom, const void* omega,
                            const void* scalars, const void* coef, void* stream) {
  static decltype(&launch<1, 1, kMaxLanes>) const table[2][2][3] = KSTEP_TABLE(launch);
  if (Z < 1 || Z > 3 || G < 1 || G > 2 || !width_ok(LN)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || p->NC > LN - 2 || p->NC < 4 || p->K <= 0) return (int)cudaErrorInvalidValue;
  if (p->trace && p->K > kSlots - kTrace0) return (int)cudaErrorInvalidValue;
  table[bound_of(LN)][G - 1][Z - 1](*p, B, LN, (cudaStream_t)stream, state, prof, sacc, nu_anom, omega,
                                    scalars, coef);
  return (int)cudaGetLastError();
}
