// One timestep of the 1-D Hall-discharge solver for one lane (cell, ghost cell
// or padding lane) of one sample: the device function shared by the K-step
// kernel (kstep.cu) and the one-step kernel (step.cu).
//
// Counterpart of `make_physics` in the JAX package
// (hallthrusterpem_tpu/models/thruster/pallas_step.py:102), whose plain PyTorch
// version is `Physics` in ../fused_step.py. Every expression keeps the operand
// order of the plain version, so that float32 rounding agrees, and the build
// turns off FMA contraction (-fmad=false), with one exception: the Horner steps
// of the rate fits, the HLLE fluxes and the PCR update use explicit fmaf (one
// rounding where the plain version rounds twice, and one instruction where it
// takes two).
//
// Layout. One thread block per sample, one thread per lane (blockDim = LN: 128
// lanes for NC <= 126, else the least multiple of 32 that holds NC + 2, so 224
// at fidelity (2,2)). Neighbour reads (the circular lane rolls of the TPU
// kernel) go through shared staging rows kMaxLanes wide, at an index masked
// to them (kLaneMask), whatever LN is: a read past lane LN-1 meets the rows'
// tail, zeroed once a launch by load_invariants, and a read below lane 0 wraps
// into the tail or onto the top lanes. The mask-free cyclic reduction relies
// on such a read meeting an exact 0 or being multiplied by one: the system is
// block-diagonal (identity rows off the interior, sub = 0 at lane 1, sup = 0
// at lane NC-2), so an interior lane's coupling across either end is an exact
// 0 at every level, and the outputs on lanes 0..NC-1 are those of any wider
// layout, bit for bit. Per-sample values read at one lane are broadcast:
// lane 1's (anode sheath, left ghost cell) through `bc`, lane NC-2's (right
// ghost cell) through `bn`, the new exit-plane state (lane NC-2) through `bx`.
//
// Barriers. A neighbour exchange is: every thread writes its lane, one block
// barrier, every thread reads its neighbours. Consecutive exchanges write
// disjoint rows (the two sets of `sh` alternate, the pressure has a row of its
// own), so an exchange needs no barrier before its writes: the rows it writes
// were last read before the previous exchange's barrier. The two Ohm's-law
// integrals are reduced within each warp by shuffles; the warp partials meet
// in shared memory behind one barrier and every thread sums them in the same
// order, so per-sample values stay bit-identical across the block. A step
// crosses 7 + n_levels barriers (15 at fidelity (2,2): 202 cells, 8 PCR levels;
// 41 before this design), 2 fewer without MUSCL reconstruction.
//
// Template parameters: Z charge states (1..3) and G neutral velocity groups
// (1, or 2 for the slow/fast two-group model, whose fast group rides one more
// state array, appended last).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLanes = 256;
constexpr int kMaxWarps = kMaxLanes / 32;
constexpr int kLaneMask = kMaxLanes - 1;  // neighbour indices, masked to the staging rows
// blocks that each SM must hold at once (both kernels' __launch_bounds__): at
// kMaxLanes threads caps a thread's registers at 65,536 / (256 x 4) = 64; 4
// timed best of 2, 3 and 4 (kstep.cu)
constexpr int kMinBlocksPerSM = 4;
// the K-step kernel's thread bound for the widths other than 128 and 256
// lanes (one neutral group): 4 blocks of 224 threads leave a thread 72 registers
constexpr int kNarrowLanes = 224;
constexpr int kSetRows = 8;     // staging rows of a set: 1 + 2Z + (G - 1) for Z <= 3, G <= 2
constexpr int kNCoef = 11;      // degree-10 log-poly in ln(Te)
constexpr int kNDCoef = 10;     // its derivative
constexpr int kMaxCoef = 7 * (kNCoef + kNDCoef);  // 6 reactions + excitation
constexpr int kSlots = 128;     // width of the scalar and accumulator rows
constexpr int kTrace0 = 8;      // first I_d(t) trace slot of the accumulator row

// the widths both kernels launch at: a multiple of 32 from 64 to kMaxLanes lanes
inline bool width_ok(int LN) { return LN % 32 == 0 && LN >= 64 && LN <= kMaxLanes; }

// per-sample scalar slots (fused_step.P_*) and accumulator slots (fused_step.A_*)
enum { P_DV, P_MDOT, P_UN, P_CW, P_TECATH, P_TANDIV, P_RC, P_LDT, P_ICIR };
enum { A_THRUST, A_ID, A_ID2, A_IB0, A_MDOT, A_UEXIT, A_FAILED, A_ICIR };

}  // namespace

// Config constants, passed by value. The field order is mirrored by the ctypes
// structure `KParams` in ../_kernels.py; every float is a float64 constant of
// the model rounded once to float32, as the JAX model rounds its Python
// constants.
struct KParams {
  int NC, i0, K, avg_start, num_steps, n_levels;
  int solve_plume, div_corr, anode_sheath, implicit_inel, reconstruct, ion_wall, sheath_wall, trace;
  float dz, mi, inv_mi, inv_dz, half_inv_dz, inv_dt, c15_inv_dt, neg_dt, dt;
  float A_ch, inv_A_ch, a_i, a_i_sq, a_i2, k_en, rho_floor, rho_ceil, ne_floor;
  float Te_min, Te_max, anode_Te, z_len, L_ch, nu_ew_c, R_o, R_i, inv_area;
  float E, E_ME, inv_E, two_pi_me, two_thirds, ten_ninth, wall_recycling, e_wall;
  float gmax, ln_cross, sq_mi_2pi_me, coef_sheath, wall_energy_scale, ex_energy;
  float slow_ratio, fast_ratio, fast_frac, slow_frac;  // two-group neutrals
  float bohm_c[3], zq[3], zqE[3], c_iw[3], inv_mi_zq[3], iz_c[3];
  float rxn_e[6];
};

// Shared memory of one block (one sample).
struct Shared {
  float sh[2][kSetRows][kMaxLanes];  // two sets of neighbour staging rows, alternated
  float pe[kMaxLanes];               // electron pressure, the first exchange of a step
  float red[2][kMaxWarps];           // Ohm's-law reductions: one partial per warp
  float bc[16];                      // lane-1 broadcast
  float bn[8];                       // lane NC-2 broadcast (right ghost cell)
  float bx[16];                      // new exit-plane state (K-step accumulators)
  float coef[kMaxCoef];              // rate log-polys
};

// NaN-propagating max/min/clip (jnp.maximum / jnp.minimum / jnp.clip semantics).
// On the card (sm_80 and later) each is the one instruction max.NaN / min.NaN
// (FMNMX.NAN), where the ternary of the host form compiles to two compares and
// a select. The two forms differ only in the sign of a zero result from a +0,
// -0 pair (the instruction orders -0 below +0) and in a NaN's payload; the
// kernels' outputs are those of the ternary form bit for bit (PERF.md §6).
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 800
__device__ __forceinline__ float mx(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float mn(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
#else
__device__ __forceinline__ float mx(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float mn(float a, float b) { return (a < b || a != a) ? a : b; }
#endif
__device__ __forceinline__ float clip(float x, float lo, float hi) { return mn(mx(x, lo), hi); }
__device__ __forceinline__ float sgn(float x) { return (float)((x > 0.0f) - (x < 0.0f)); }

template <int N>
__device__ __forceinline__ float poly(const float* c, float x) {
  float out = fmaf(c[0], x, c[1]);
#pragma unroll
  for (int j = 2; j < N; ++j) out = fmaf(out, x, c[j]);
  return out;
}

// One lane's evolving state: neutral densities, electron energy density, ion
// densities, momenta and velocities (the velocities of the current state).
template <int Z, int G>
struct Lane {
  float rn, rn2, nE, ri[Z], mo[Z], ui[Z];
};

// Per-sample scalars and everything of a lane that does not change over the
// steps of a launch: lane masks, geometry, the static plume cone and the wall
// collisionality.
struct Invariants {
  float dV, mdot_in, u_n, c_w, te_cath, rc, l_dt, u_g0, u_g1;
  float nu_anom, omega, nu_ew;
  bool interior, in_domain;
  float interior_f, face_f, in_channel;
  float inv_AR, AR_f, dlnA, wp, wm, qs_t, qs_f;
};

// Load the per-sample scalars, the lane's constants and the rate coefficients,
// zero the staging rows past lane LN-1 and compute the loop invariants. Ends
// with a barrier.
template <int Z>
__device__ __forceinline__ Invariants load_invariants(const KParams& p, Shared& s, int B, int l,
                                                      int LN, const float* __restrict__ nu_anom_g,
                                                      const float* __restrict__ omega_g,
                                                      const float* __restrict__ scal_g,
                                                      const float* __restrict__ coef_g) {
  constexpr int NR = Z * (Z + 1) / 2;  // ionization reactions among charge states 0..Z
  constexpr int M = kLaneMask;
  const int b = blockIdx.x;
  const int NC = p.NC;
  const size_t off = (size_t)b * LN + l;
  Invariants v;
  for (int j = l; j < (NR + 1) * (kNCoef + kNDCoef); j += LN) s.coef[j] = coef_g[j];
  // the staging rows' tail past lane LN-1, which no thread writes: an exact 0
  // for every masked read that leaves the lanes (behind the first barrier)
  for (int j = LN + l; j < kMaxLanes; j += LN) {
    s.pe[j] = 0.0f;
#pragma unroll
    for (int r = 0; r < kSetRows; ++r) s.sh[0][r][j] = s.sh[1][r][j] = 0.0f;
  }

  const float* sc = scal_g + (size_t)b * kSlots;
  v.dV = sc[P_DV];
  v.mdot_in = sc[P_MDOT];
  v.u_n = sc[P_UN];
  v.c_w = sc[P_CW];
  v.te_cath = sc[P_TECATH];
  const float tan_div = sc[P_TANDIV];
  v.rc = sc[P_RC];
  v.l_dt = sc[P_LDT];
  v.u_g0 = p.slow_ratio * v.u_n;
  v.u_g1 = p.fast_ratio * v.u_n;
  v.nu_anom = nu_anom_g[off];
  v.omega = omega_g[off];

  v.interior = (l >= 1) && (l <= NC - 2);
  v.in_domain = l <= NC - 1;
  v.interior_f = v.interior ? 1.0f : 0.0f;
  v.face_f = (l <= NC - 2) ? 1.0f : 0.0f;
  float z_cell = (l == 0) ? 0.0f : ((float)l - 0.5f) * p.dz;
  if (l >= NC - 1) z_cell = p.z_len;
  v.in_channel = (z_cell <= p.L_ch) ? 1.0f : 0.0f;
  v.nu_ew = (p.nu_ew_c * v.c_w) * v.in_channel;
  v.inv_AR = 1.0f;
  v.AR_f = 1.0f;
  v.dlnA = 0.0f;
  v.wp = 1.0f;
  v.wm = 1.0f;
  v.qs_t = 1.0f;
  v.qs_f = 1.0f;
  if (p.solve_plume) {
    const float tand = clip(tan_div, 0.0f, 2.0f);
    const float drz = tand * mx(z_cell - p.L_ch, 0.0f);
    const float r_o = p.R_o + drz;
    const float r_i = mx(p.R_i - drz, 0.0f);
    const float AR = (r_o * r_o - r_i * r_i) * p.inv_area;
    v.inv_AR = 1.0f / AR;
    s.sh[0][0][l] = AR;
    __syncthreads();
    v.AR_f = 0.5f * (AR + s.sh[0][0][(l + 1) & M]);
    const float ar_ex = s.sh[0][0][NC - 2];
    s.sh[0][1][l] = v.AR_f;
    __syncthreads();
    const float ARf_m = s.sh[0][1][(l - 1) & M];
    v.dlnA = (v.AR_f - ARf_m) * p.inv_dz * v.inv_AR * v.interior_f;
    v.wp = v.AR_f * v.inv_AR;
    v.wm = ARf_m * v.inv_AR;
    v.qs_f = ar_ex;
    v.qs_t = p.div_corr ? ar_ex * (1.0f / sqrtf(1.0f + tand * tand)) : ar_ex;
  }
  __syncthreads();
  return v;
}

// Read the lane's packed state (G == 2: rho_n2 is array 2 + 2Z) into `st`,
// scrub it (NaN -> floor, clip to range) and compute the ion velocities of the
// scrubbed state. Returns whether the raw state was non-finite in this lane.
template <int Z, int G>
__device__ __forceinline__ bool load_scrub(const KParams& p, const float* __restrict__ state,
                                           size_t plane, size_t off, Lane<Z, G>& st) {
  float rn = state[off], nE = state[plane + off];
  bool bad = !(isfinite(rn) && isfinite(nE));
#pragma unroll
  for (int z = 0; z < Z; ++z) {
    st.ri[z] = state[(2 + 2 * z) * plane + off];
    st.mo[z] = state[(3 + 2 * z) * plane + off];
    bad = bad || !(isfinite(st.ri[z]) && isfinite(st.mo[z]));
  }
  st.rn2 = 0.0f;
  if constexpr (G == 2) {
    const float rn2 = state[(2 + 2 * Z) * plane + off];
    bad = bad || !isfinite(rn2);
    st.rn2 = clip(isfinite(rn2) ? rn2 : p.rho_floor, p.rho_floor, p.rho_ceil);
  }
  st.rn = clip(isfinite(rn) ? rn : p.rho_floor, p.rho_floor, p.rho_ceil);
#pragma unroll
  for (int z = 0; z < Z; ++z) {
    st.ri[z] = clip(isfinite(st.ri[z]) ? st.ri[z] : p.rho_floor, p.rho_floor, p.rho_ceil);
    st.mo[z] = clip(isfinite(st.mo[z]) ? st.mo[z] : 0.0f, -st.ri[z] * 3e5f, st.ri[z] * 3e5f);
    st.ui[z] = st.mo[z] / mx(st.ri[z], p.rho_floor);
  }
  st.nE = clip(isfinite(nE) ? nE : 1.0f, 1.0f, 1e23f);
  return bad;
}

template <int Z, int G>
__device__ __forceinline__ void store_state(float* __restrict__ state, size_t plane, size_t off,
                                            const Lane<Z, G>& st) {
  state[off] = st.rn;
  state[plane + off] = st.nE;
#pragma unroll
  for (int z = 0; z < Z; ++z) {
    state[(2 + 2 * z) * plane + off] = st.ri[z];
    state[(3 + 2 * z) * plane + off] = st.mo[z];
  }
  if constexpr (G == 2) state[(2 + 2 * Z) * plane + off] = st.rn2;
}

// What a step yields beside the new state: the discharge current density (per
// sample) and the lane's Te, ne, E and neutral density before the update.
struct StepOut {
  float j_d, Te, ne, E_z, nn;
};

// Advance the lane one step from a scrubbed state, in place on `st` (including
// the ion velocities of the new state). `icir` is the previous step's
// discharge current. Lane NC-2 leaves its new heavy-species state in `s.bx`,
// readable by every thread on return. Every thread of the block must call it:
// it has barriers.
template <int Z, int G>
__device__ __forceinline__ StepOut physics_step(const KParams& p, const Invariants& v, Shared& s,
                                                Lane<Z, G>& st, float icir, int l, int LN) {
  constexpr int NR = Z * (Z + 1) / 2;
  constexpr int RN2 = 1 + 2 * Z;  // staging row of the fast neutral group
  constexpr int M = kLaneMask;
  const int NC = p.NC;
  // the two row sets; the exchanges of a step use A, B, A, B, ... in turn
  float(&A)[kSetRows][kMaxLanes] = s.sh[0];
  float(&Bs)[kSetRows][kMaxLanes] = s.sh[1];
  float* bc = s.bc;
  float* bn = s.bn;
  const float interior_f = v.interior_f, face_f = v.face_f, in_channel = v.in_channel;
  const float inv_AR = v.inv_AR;
  float* ri = st.ri;
  float* mo = st.mo;
  float* ui = st.ui;
  const float rn = st.rn, rn2 = st.rn2, nE = st.nE;
  const float u_n = v.u_n;

  // ---- plasma properties
  float ni[Z];
#pragma unroll
  for (int z = 0; z < Z; ++z) ni[z] = ri[z] * p.inv_mi;
  float ne = ni[0] * p.zq[0];
#pragma unroll
  for (int z = 1; z < Z; ++z) ne = ne + p.zq[z] * ni[z];
  ne = mx(ne, p.ne_floor);
  const float inv_ne = 1.0f / ne;
  const float Te = clip(p.two_thirds * nE * inv_ne, p.Te_min, p.Te_max);
  float nn, share0 = 1.0f, share1 = 0.0f, u_n_src = u_n;
  if constexpr (G == 2) {
    // neutral velocity-space quadrature: group speeds are fixed ratios of u_n,
    // ionization consumption is split by density share, and the momentum
    // source speed is share-weighted
    const float nn_g0 = rn * p.inv_mi;
    const float nn_g1 = rn2 * p.inv_mi;
    nn = mx(nn_g0 + nn_g1, 1e6f);
    const float inv_nn = 1.0f / nn;
    share0 = nn_g0 * inv_nn;
    share1 = nn_g1 * inv_nn;
    u_n_src = share0 * v.u_g0 + share1 * v.u_g1;
  } else {
    nn = mx(rn * p.inv_mi, 1e6f);
  }

  // ---- collisions and mobility
  const float lnTe = logf(Te);
  const float lnL = clip(23.0f - 0.5f * logf(ne * 1e-6f) + 1.5f * lnTe, 2.0f, 30.0f);
  const float rs_te = 1.0f / sqrtf(Te);
  const float nu_ei = 2.9e-12f * ne * lnL * (rs_te * rs_te * rs_te);
  const float nu_e = p.k_en * nn + nu_ei + v.nu_anom + v.nu_ew;
  const float mu = p.E_ME * nu_e / (nu_e * nu_e + v.omega * v.omega);

  // ---- Ohm's law: two lane reductions and the RL circuit filter
  float j_i = p.zq[0] * ni[0] * ui[0];
#pragma unroll
  for (int z = 1; z < Z; ++z) j_i = j_i + p.zq[z] * ni[z] * ui[z];
  j_i = p.E * j_i;
  const float pe = ne * Te;
  // exchange 1: the pressure, and the lane-1 and lane NC-2 values of the ghost cells
  s.pe[l] = pe;
  if (l == 1) {
    bc[0] = ne;
    bc[1] = Te;
    bc[2] = j_i;
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      bc[3 + z] = ri[z];
      bc[6 + z] = mo[z];
      bc[9 + z] = ui[z];
    }
  }
  if (l == NC - 2) {
    bn[0] = rn;
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      bn[1 + z] = ri[z];
      bn[4 + z] = mo[z];
    }
    if constexpr (G == 2) bn[7] = rn2;
  }
  __syncthreads();
  const float pe_p = s.pe[(l + 1) & M], pe_m = s.pe[(l - 1) & M];
  float grad_pe = (pe_p - pe_m) * p.half_inv_dz;
  if (l == 0) grad_pe = (pe_p - pe) * p.inv_dz;
  if (l == NC - 1) grad_pe = (pe - pe_m) * p.inv_dz;
  if (!v.in_domain) grad_pe = 0.0f;
  const float inv_enmu = 1.0f / (p.E * ne * mu);
  const float gpe_ne = grad_pe * inv_ne;
  const float num_igd = (j_i * inv_enmu + gpe_ne) * interior_f;
  const float den_igd = p.solve_plume ? (inv_AR * inv_enmu * interior_f) : (inv_enmu * interior_f);
  // exchange 2: the two lane sums, by warp shuffles, then over the warp partials
  float w_num = num_igd, w_den = den_igd;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    w_num = w_num + __shfl_xor_sync(0xffffffffu, w_num, m);
    w_den = w_den + __shfl_xor_sync(0xffffffffu, w_den, m);
  }
  if ((l & 31) == 0) {
    s.red[0][l >> 5] = w_num;
    s.red[1][l >> 5] = w_den;
  }
  __syncthreads();
  float sum_num = s.red[0][0], sum_den = s.red[1][0];
  // unrolled in full: the step loop of the K-step kernel holds no loop but the PCR's
#pragma unroll
  for (int w = 1; w < kMaxWarps; ++w) {
    if (w >= (LN >> 5)) break;
    sum_num = sum_num + s.red[0][w];
    sum_den = sum_den + s.red[1][w];
  }
  const float num_int = sum_num * p.dz;
  const float ne1 = bc[0], Te1 = bc[1], j_i1 = bc[2];
  const float i_prev = clip(icir, -1e4f, 1e4f);
  const float den_pl = sum_den * p.dz + v.rc * p.A_ch;
  const float den_all = den_pl + v.l_dt * p.A_ch;
  const float j_prev = i_prev * p.inv_A_ch;
  float j_d = j_prev + (v.dV + num_int - j_prev * den_pl) / den_all;
  if (p.anode_sheath) {
    const float j_e_th = p.E * ne1 * sqrtf(p.E * Te1 / p.two_pi_me);
    const float j_e_req = mx(j_d - j_i1, 1e-6f * j_e_th);
    const float phi_s = clip(Te1 * logf(j_e_th / j_e_req), 0.0f, 0.5f * fabsf(v.dV));
    j_d = j_prev + (v.dV - phi_s + num_int - j_prev * den_pl) / den_all;
  }
  const float j_d_loc = p.solve_plume ? j_d * inv_AR : j_d;
  const float E_z = (j_d_loc - j_i) * inv_enmu - gpe_ne;

  // ---- heavy-species ghost cells
  const float u_bohm1 = sqrtf(p.E * Te1 / p.mi);
  float mom_back = 0.0f;
#pragma unroll
  for (int z = 0; z < Z; ++z) mom_back = mom_back + mn(bc[6 + z], 0.0f);
  float rho_n_l, rho_n2_l = 0.0f;
  if constexpr (G == 2) {
    // injected flux split over the groups; anode-recycled ion backflow re-enters the slow group
    rho_n_l = (p.slow_frac * (v.mdot_in / p.A_ch) - mom_back) / v.u_g0;
    rho_n2_l = (p.fast_frac * (v.mdot_in / p.A_ch)) / v.u_g1;
  } else {
    rho_n_l = (v.mdot_in / p.A_ch - mom_back) / u_n;
  }
  const int lm = (l - 1) & M, lp = (l + 1) & M;
  const float rho_n_b = (l == 0) ? rho_n_l : ((l == NC - 1) ? bn[0] : rn);
  float rho_n2_b = 0.0f;
  if constexpr (G == 2) rho_n2_b = (l == 0) ? rho_n2_l : ((l == NC - 1) ? bn[7] : rn2);
  float rb[Z], mb[Z], ub[Z];
#pragma unroll
  for (int z = 0; z < Z; ++z) {
    const float u_gl = mn(bc[9 + z], p.bohm_c[z] * u_bohm1);
    const float r_gl = bc[3 + z];
    rb[z] = (l == 0) ? r_gl : ((l == NC - 1) ? bn[1 + z] : ri[z]);
    mb[z] = (l == 0) ? r_gl * u_gl : ((l == NC - 1) ? bn[4 + z] : mo[z]);
    ub[z] = mb[z] / mx(rb[z], p.rho_floor);
  }

  // ---- fluxes through face l (between cells l and l+1): MUSCL minmod + HLLE
  float sl_rn = 0.0f, sl_rn2 = 0.0f, sl_r[Z], sl_u[Z];
#pragma unroll
  for (int z = 0; z < Z; ++z) sl_r[z] = sl_u[z] = 0.0f;
  if (p.reconstruct) {
    // exchanges 3 (set A) and 4 (set B): the cell values, then their forward differences
    A[0][l] = rho_n_b;
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      A[1 + z][l] = rb[z];
      A[1 + Z + z][l] = ub[z];
    }
    if constexpr (G == 2) A[RN2][l] = rho_n2_b;
    __syncthreads();
    const float dp_n = A[0][lp] - rho_n_b;
    float dp_n2 = 0.0f;
    if constexpr (G == 2) dp_n2 = A[RN2][lp] - rho_n2_b;
    float dp_r[Z], dp_u[Z];
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      dp_r[z] = A[1 + z][lp] - rb[z];
      dp_u[z] = A[1 + Z + z][lp] - ub[z];
    }
    Bs[0][l] = dp_n;
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      Bs[1 + z][l] = dp_r[z];
      Bs[1 + Z + z][l] = dp_u[z];
    }
    if constexpr (G == 2) Bs[RN2][l] = dp_n2;
    __syncthreads();
    auto minmod = [&](float dq_m, float dq_p) {
      const float q = 0.5f * (sgn(dq_m) + sgn(dq_p)) * mn(fabsf(dq_m), fabsf(dq_p));
      return q * interior_f;
    };
    sl_rn = minmod(Bs[0][lm], dp_n);
    if constexpr (G == 2) sl_rn2 = minmod(Bs[RN2][lm], dp_n2);
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      sl_r[z] = minmod(Bs[1 + z][lm], dp_r[z]);
      sl_u[z] = minmod(Bs[1 + Z + z][lm], dp_u[z]);
    }
  }
  const float Fn = (G == 2 ? v.u_g0 : u_n) * mx(rho_n_b + 0.5f * sl_rn, p.rho_floor) * face_f;
  float Fn2 = 0.0f;
  if constexpr (G == 2) Fn2 = v.u_g1 * mx(rho_n2_b + 0.5f * sl_rn2, p.rho_floor) * face_f;
  // exchange 5 (set A): the right states of the faces
#pragma unroll
  for (int z = 0; z < Z; ++z) {
    A[1 + z][l] = rb[z] - 0.5f * sl_r[z];
    A[1 + Z + z][l] = ub[z] - 0.5f * sl_u[z];
  }
  __syncthreads();
  float Fr[Z], Fm[Z];
#pragma unroll
  for (int z = 0; z < Z; ++z) {
    const float rL = mx(rb[z] + 0.5f * sl_r[z], p.rho_floor);
    const float rR = mx(A[1 + z][lp], p.rho_floor);
    const float uL = ub[z] + 0.5f * sl_u[z];
    const float uR = A[1 + Z + z][lp];
    const float mL = rL * uL, mR = rR * uR;
    const float sL = mn(mn(uL - p.a_i, uR - p.a_i), 0.0f);
    const float sR = mx(mx(uL + p.a_i, uR + p.a_i), 0.0f);
    const float ds = mx(sR - sL, 1e-8f);
    const float FmL = fmaf(mL, uL, rL * p.a_i_sq);
    const float FmR = fmaf(mR, uR, rR * p.a_i_sq);
    const float inv_ds = face_f / ds;
    Fr[z] = fmaf(sL * sR, rR - rL, fmaf(sR, mL, -(sL * mR))) * inv_ds;
    Fm[z] = fmaf(sL * sR, mR - mL, fmaf(sR, FmL, -(sL * FmR))) * inv_ds;
  }
  // flux divergence (quasi-1D with the plume cone: (1/A) d(A F)/dz)
  const float wF = p.solve_plume ? v.AR_f : 1.0f;
  // exchange 6 (set B): the face fluxes
  Bs[0][l] = p.solve_plume ? Fn * wF : Fn;
#pragma unroll
  for (int z = 0; z < Z; ++z) {
    Bs[1 + z][l] = p.solve_plume ? Fr[z] * wF : Fr[z];
    Bs[1 + Z + z][l] = p.solve_plume ? Fm[z] * wF : Fm[z];
  }
  if constexpr (G == 2) Bs[RN2][l] = p.solve_plume ? Fn2 * wF : Fn2;
  __syncthreads();
  auto ddz = [&](float F, int j) {
    return p.solve_plume ? (F * wF - Bs[j][lm]) * p.inv_dz * inv_AR : (F - Bs[j][lm]) * p.inv_dz;
  };
  const float ddz_n = ddz(Fn, 0);
  float ddz_n2 = 0.0f;
  if constexpr (G == 2) ddz_n2 = ddz(Fn2, RN2);
  float ddz_r[Z], ddz_m[Z];
#pragma unroll
  for (int z = 0; z < Z; ++z) {
    ddz_r[z] = ddz(Fr[z], 1 + z);
    ddz_m[z] = ddz(Fm[z], 1 + Z + z);
  }

  // ---- sources: log-poly rates, E-force, pressure-area, ion-wall losses
  float d_rho_n = 0.0f, d_rho_n2 = 0.0f, d_rho[Z], d_mom[Z], inelastic = 0.0f, dinel = 0.0f;
#pragma unroll
  for (int z = 0; z < Z; ++z) d_rho[z] = d_mom[z] = 0.0f;
  const float inv_Te = 1.0f / Te;
  {
    int r = 0;
#pragma unroll
    for (int zf = 0; zf < Z; ++zf) {
#pragma unroll
      for (int zt = zf + 1; zt <= Z; ++zt, ++r) {
        const float* cr = s.coef + r * (kNCoef + kNDCoef);
        const float k_r = expf(poly<kNCoef>(cr, lnTe));
        const float n_from = (zf == 0) ? nn : ni[zf > 0 ? zf - 1 : 0];
        const float u_from = (zf == 0) ? u_n_src : ui[zf > 0 ? zf - 1 : 0];
        const float dm = ne * k_r * n_from * p.mi;
        if (zf == 0) {
          if constexpr (G == 2) {
            d_rho_n = d_rho_n - dm * share0;
            d_rho_n2 = d_rho_n2 - dm * share1;
          } else {
            d_rho_n = d_rho_n - dm;
          }
        } else {
          d_rho[zf - 1] = d_rho[zf - 1] - dm;
          d_mom[zf - 1] = d_mom[zf - 1] - dm * u_from;
        }
        d_rho[zt - 1] = d_rho[zt - 1] + dm;
        d_mom[zt - 1] = d_mom[zt - 1] + dm * u_from;
        const float contrib = dm * p.rxn_e[r];
        inelastic = inelastic + contrib;
        if (p.implicit_inel) dinel = dinel + contrib * poly<kNDCoef>(cr + kNCoef, lnTe) * inv_Te;
      }
    }
    const float* ce = s.coef + NR * (kNCoef + kNDCoef);
    const float k_ex = expf(poly<kNCoef>(ce, lnTe));
    const float ex_contrib = ne * k_ex * nn * p.ex_energy;
    inelastic = inelastic + ex_contrib;
    if (p.implicit_inel) {
      dinel = dinel + ex_contrib * poly<kNDCoef>(ce + kNCoef, lnTe) * inv_Te;
      dinel = mx(dinel, 0.0f);
    }
  }
#pragma unroll
  for (int z = 0; z < Z; ++z) d_mom[z] = d_mom[z] + p.zqE[z] * ni[z] * E_z;
  if (p.solve_plume) {
#pragma unroll
    for (int z = 0; z < Z; ++z) d_mom[z] = d_mom[z] + ri[z] * p.a_i_sq * v.dlnA;
  }
  if (p.ion_wall) {
    const float sqrt_te = sqrtf(p.E * Te / p.mi);
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      const float nu_iw = p.c_iw[z] * sqrt_te * in_channel;
      d_rho[z] = d_rho[z] - nu_iw * ri[z];
      d_mom[z] = d_mom[z] - nu_iw * mo[z];
      d_rho_n = d_rho_n + p.wall_recycling * (nu_iw * ri[z]);
    }
  }

  auto upd = [&](float base, float dflux, float src) {
    return base + p.neg_dt * dflux * interior_f + p.dt * src * interior_f;
  };
  const float rn_new = mx(upd(rho_n_b, ddz_n, d_rho_n), p.rho_floor);
  float rn2_new = 0.0f;
  if constexpr (G == 2) rn2_new = mx(upd(rho_n2_b, ddz_n2, d_rho_n2), p.rho_floor);
  float ri_new[Z], mo_new[Z];
#pragma unroll
  for (int z = 0; z < Z; ++z) {
    ri_new[z] = mx(upd(rb[z], ddz_r[z], d_rho[z]), p.rho_floor);
    mo_new[z] = upd(mb[z], ddz_m[z], d_mom[z]);
  }

  if (l == NC - 2) {  // the new exit-plane state, read by the caller after the PCR's barriers
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      s.bx[z] = ri_new[z];
      s.bx[3 + z] = mo_new[z];
      s.bx[6 + z] = mo_new[z] / mx(ri_new[z], p.rho_floor);
    }
  }

  // ---- electron energy: backward Euler in Te, row-normalised PCR over lanes
  float ne_new = ri_new[0] * p.inv_mi_zq[0];
#pragma unroll
  for (int z = 1; z < Z; ++z) ne_new = ne_new + ri_new[z] * p.inv_mi_zq[z];
  ne_new = mx(ne_new, p.ne_floor);

  const float Gamma_e = (j_i - j_d_loc) * p.inv_E;
  const float kap = p.ten_ninth * mu * ne * Te;
  // exchange 7 (set A): electron flux and conductivity; each lane forms the
  // face values on both of its sides (the left one as lane l-1 forms it)
  A[0][l] = Gamma_e;
  A[1][l] = kap;
  __syncthreads();
  const float Ge_m = A[0][lm], kap_m = A[1][lm];
  const float G_f = 0.5f * (Gamma_e + A[0][lp]);
  const float kf = p.half_inv_dz * (kap + A[1][lp]);
  const float Gp = 2.5f * mx(G_f, 0.0f);
  const float Gn = 2.5f * mn(G_f, 0.0f);
  float wall_rate;
  if (p.sheath_wall) {
    const float gamma = mn(p.gmax, 1.4f * expf(0.576f * (lnTe - p.ln_cross)));
    const float one_m_g = 1.0f - gamma;
    const float phi_w_over_te = mx(logf(one_m_g * p.sq_mi_2pi_me), 0.0f);
    const float sqrt_te = Te * rs_te;
    wall_rate = p.coef_sheath * v.c_w * sqrt_te / one_m_g * (2.0f + phi_w_over_te) * in_channel;
  } else {
    wall_rate = p.wall_energy_scale * v.c_w * 1e7f * expf(-20.0f / Te) * in_channel;
  }
  const float nu_eps = p.e_wall * wall_rate;
  const float q_ohm = (j_d_loc - j_i) * E_z * p.inv_E;
  const float G_fm = 0.5f * (Ge_m + Gamma_e);
  const float Gp_m = 2.5f * mx(G_fm, 0.0f), Gn_m = 2.5f * mn(G_fm, 0.0f);
  const float kf_m = p.half_inv_dz * (kap_m + kap);
  float sub, sup, diag;
  if (p.solve_plume) {
    sub = (-Gp_m - kf_m) * v.wm * p.inv_dz;
    sup = (Gn - kf) * v.wp * p.inv_dz;
    diag = ne_new * (p.c15_inv_dt + nu_eps * 1.5f) + ((Gp + kf) * v.wp + (kf_m - Gn_m) * v.wm) * p.inv_dz;
  } else {
    sub = (-Gp_m - kf_m) * p.inv_dz;
    sup = (Gn - kf) * p.inv_dz;
    diag = ne_new * (p.c15_inv_dt + nu_eps * 1.5f) + (Gp - Gn_m + kf + kf_m) * p.inv_dz;
  }
  float rhs = nE * p.inv_dt + q_ohm - inelastic;
  if (p.implicit_inel) {
    diag = diag + dinel;
    rhs = rhs + dinel * Te;
  }
  if (l == 1) rhs = rhs - sub * p.anode_Te;
  if (l == NC - 2) rhs = rhs - sup * v.te_cath;
  if (l == 1) sub = 0.0f;
  if (l == NC - 2) sup = 0.0f;
  if (!v.interior) {
    sub = 0.0f;
    sup = 0.0f;
    diag = 1.0f;
    rhs = 1.0f;
  }
  const float inv = 1.0f / diag;
  float a = sub * inv, c = sup * inv, d = rhs * inv;
  // PCR levels, one exchange each, in sets B, A, B, ... (exchange 7 used A)
  // not unrolled: one loop of one barrier in the SASS, whose barriers and
  // instructions chip_smoke.py counts and multiplies by n_levels
#pragma unroll 1
  for (int lvl = 0, kk = 1; lvl < p.n_levels; ++lvl, kk *= 2) {
    float(&P)[kSetRows][kMaxLanes] = s.sh[(lvl + 1) & 1];
    P[0][l] = a;
    P[1][l] = c;
    P[2][l] = d;
    __syncthreads();
    const int lmk = (l - kk) & M, lpk = (l + kk) & M;
    const float cm = P[1][lmk], ap = P[0][lpk], dm_ = P[2][lmk], dp_ = P[2][lpk];
    const float b_new = fmaf(-c, ap, fmaf(-a, cm, 1.0f));
    d = fmaf(-c, dp_, fmaf(-a, dm_, d));
    const float rb_ = 1.0f / b_new;
    d = d * rb_;
    if (lvl < p.n_levels - 1) {
      a = -a * P[0][lmk] * rb_;
      c = -c * P[1][lpk] * rb_;
    }
  }
  float Te_new = (l == 0) ? p.anode_Te : d;
  if (l >= NC - 1) Te_new = v.te_cath;
  Te_new = clip(Te_new, p.Te_min, p.Te_max);

  // ---- commit the step
  st.rn = rn_new;
  st.rn2 = rn2_new;
  st.nE = 1.5f * ne_new * Te_new;
#pragma unroll
  for (int z = 0; z < Z; ++z) {
    ri[z] = ri_new[z];
    mo[z] = mo_new[z];
    ui[z] = mo[z] / mx(ri[z], p.rho_floor);
  }
  return StepOut{j_d, Te, ne, E_z, nn};
}
