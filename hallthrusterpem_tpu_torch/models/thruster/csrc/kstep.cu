// K-step 1-D Hall-discharge solver: one launch advances every sample K timesteps.
//
// Replaces the TPU kernel `build_multistep_kernel` of the JAX package
// (hallthrusterpem_tpu/models/thruster/pallas_step.py:677, pallas_call at :879),
// whose step body is `make_physics` (:102). The plain PyTorch version of the same
// function is `kstep_plain` in ../fused_step.py; the two share the packed tensor
// layout described there, and every expression here keeps the operand order of
// the plain version so that float32 rounding agrees.
//
// Design. One thread block per sample, one thread per lane (cell, ghost cell or
// padding lane; blockDim = LN = 128 or 256). Each thread keeps its lane's state,
// velocities and profile sums in registers across the K steps and writes them
// back once per launch, so device memory is touched once per launch and not once
// per step. Neighbour reads (the circular lane rolls of the TPU kernel) go
// through shared memory and wrap over all LN lanes, not over the NC cells: the
// mask-free cyclic reduction relies on a wrapped read meeting an exact 0 in the
// padding rows. The two Ohm's-law integrals are a shared-memory tree reduction;
// per-sample values read at one lane (lane 1 for the anode sheath and ghost
// cells, lane NC-2 for the exit-plane accumulators) are broadcast through shared
// memory. Per-sample accumulators are kept identically by every thread and
// written back by thread 0.
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

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLanes = 256;
constexpr int kNumBuf = 7;      // shared staging rows: 1 + 2Z for Z <= 3
constexpr int kNCoef = 11;      // degree-10 log-poly in ln(Te)
constexpr int kNDCoef = 10;     // its derivative
constexpr int kMaxCoef = 7 * (kNCoef + kNDCoef);  // 6 reactions + excitation
constexpr int kSlots = 128;     // width of the scalar and accumulator rows

// per-sample scalar slots (fused_step.P_*) and accumulator slots (fused_step.A_*)
enum { P_DV, P_MDOT, P_UN, P_CW, P_TECATH, P_TANDIV, P_RC, P_LDT };
enum { A_THRUST, A_ID, A_ID2, A_IB0, A_MDOT, A_UEXIT, A_FAILED, A_ICIR };

}  // namespace

// Config constants, passed by value. The field order is mirrored by the ctypes
// structure `KParams` in ../_kernels.py; every float is a float64 constant of
// the model rounded once to float32, as the JAX model rounds its Python
// constants.
struct KParams {
  int NC, i0, K, avg_start, num_steps, n_levels;
  int solve_plume, div_corr, anode_sheath, implicit_inel, reconstruct, ion_wall, sheath_wall;
  float dz, mi, inv_mi, inv_dz, half_inv_dz, inv_dt, c15_inv_dt, neg_dt, dt;
  float A_ch, inv_A_ch, a_i, a_i_sq, a_i2, k_en, rho_floor, rho_ceil, ne_floor;
  float Te_min, Te_max, anode_Te, z_len, L_ch, nu_ew_c, R_o, R_i, inv_area;
  float E, E_ME, inv_E, two_pi_me, two_thirds, ten_ninth, wall_recycling, e_wall;
  float gmax, ln_cross, sq_mi_2pi_me, coef_sheath, wall_energy_scale, ex_energy;
  float bohm_c[3], zq[3], zqE[3], c_iw[3], inv_mi_zq[3], iz_c[3];
  float rxn_e[6];
};

// NaN-propagating max/min/clip (jnp.maximum / jnp.minimum / jnp.clip semantics)
__device__ __forceinline__ float mx(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float mn(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float clip(float x, float lo, float hi) { return mn(mx(x, lo), hi); }
__device__ __forceinline__ float sgn(float x) { return (float)((x > 0.0f) - (x < 0.0f)); }

template <int N>
__device__ __forceinline__ float poly(const float* c, float x) {
  float out = c[0] * x + c[1];
#pragma unroll
  for (int j = 2; j < N; ++j) out = out * x + c[j];
  return out;
}

template <int Z>
__global__ void __launch_bounds__(kMaxLanes)
kstep_kernel(KParams p, int B, float* __restrict__ state, float* __restrict__ prof,
             float* __restrict__ sacc, const float* __restrict__ nu_anom_g,
             const float* __restrict__ omega_g, const float* __restrict__ scal_g,
             const float* __restrict__ coef_g) {
  constexpr int NR = Z * (Z + 1) / 2;  // ionization reactions among charge states 0..Z
  const int LN = blockDim.x;
  const int M = LN - 1;
  const int l = threadIdx.x;
  const int b = blockIdx.x;
  const int NC = p.NC;
  const size_t plane = (size_t)B * LN;
  const size_t off = (size_t)b * LN + l;

  __shared__ float sh[kNumBuf][kMaxLanes];
  __shared__ float red[2][kMaxLanes];
  __shared__ float bc[16];
  __shared__ float bx[16];
  __shared__ float s_coef[kMaxCoef];

  for (int j = l; j < (NR + 1) * (kNCoef + kNDCoef); j += LN) s_coef[j] = coef_g[j];

  // per-sample scalars
  const float* sc = scal_g + (size_t)b * kSlots;
  const float dV = sc[P_DV], mdot_in = sc[P_MDOT], u_n = sc[P_UN], c_w = sc[P_CW];
  const float te_cath = sc[P_TECATH], tan_div = sc[P_TANDIV], rc = sc[P_RC], l_dt = sc[P_LDT];
  const float nu_anom = nu_anom_g[off], omega = omega_g[off];

  // ---- loop invariants: lane masks, geometry, static plume cone
  const bool interior = (l >= 1) && (l <= NC - 2);
  const bool in_domain = l <= NC - 1;
  const float interior_f = interior ? 1.0f : 0.0f;
  const float face_f = (l <= NC - 2) ? 1.0f : 0.0f;
  float z_cell = (l == 0) ? 0.0f : ((float)l - 0.5f) * p.dz;
  if (l >= NC - 1) z_cell = p.z_len;
  const float in_channel = (z_cell <= p.L_ch) ? 1.0f : 0.0f;
  const float nu_ew = (p.nu_ew_c * c_w) * in_channel;
  float inv_AR = 1.0f, AR_f = 1.0f, dlnA = 0.0f, wp = 1.0f, wm = 1.0f, qs_t = 1.0f, qs_f = 1.0f;
  if (p.solve_plume) {
    const float tand = clip(tan_div, 0.0f, 2.0f);
    const float drz = tand * mx(z_cell - p.L_ch, 0.0f);
    const float r_o = p.R_o + drz;
    const float r_i = mx(p.R_i - drz, 0.0f);
    const float AR = (r_o * r_o - r_i * r_i) * p.inv_area;
    inv_AR = 1.0f / AR;
    sh[0][l] = AR;
    __syncthreads();
    AR_f = 0.5f * (AR + sh[0][(l + 1) & M]);
    const float ar_ex = sh[0][NC - 2];
    sh[1][l] = AR_f;
    __syncthreads();
    const float ARf_m = sh[1][(l - 1) & M];
    dlnA = (AR_f - ARf_m) * p.inv_dz * inv_AR * interior_f;
    wp = AR_f * inv_AR;
    wm = ARf_m * inv_AR;
    qs_f = ar_ex;
    qs_t = p.div_corr ? ar_ex * (1.0f / sqrtf(1.0f + tand * tand)) : ar_ex;
  }

  // ---- load, was-nonfinite flag, scrub (once per launch)
  float rn = state[off], nE = state[plane + off];
  float ri[Z], mo[Z], ui[Z], pf[Z + 4];
  bool bad = !(isfinite(rn) && isfinite(nE));
#pragma unroll
  for (int z = 0; z < Z; ++z) {
    ri[z] = state[(2 + 2 * z) * plane + off];
    mo[z] = state[(3 + 2 * z) * plane + off];
    bad = bad || !(isfinite(ri[z]) && isfinite(mo[z]));
  }
#pragma unroll
  for (int j = 0; j < Z + 4; ++j) pf[j] = prof[j * plane + off];
  const bool any_bad = __syncthreads_or(bad) != 0;  // also orders s_coef and sh reuse

  rn = clip(isfinite(rn) ? rn : p.rho_floor, p.rho_floor, p.rho_ceil);
#pragma unroll
  for (int z = 0; z < Z; ++z) {
    ri[z] = clip(isfinite(ri[z]) ? ri[z] : p.rho_floor, p.rho_floor, p.rho_ceil);
    mo[z] = clip(isfinite(mo[z]) ? mo[z] : 0.0f, -ri[z] * 3e5f, ri[z] * 3e5f);
    ui[z] = mo[z] / mx(ri[z], p.rho_floor);
  }
  nE = clip(isfinite(nE) ? nE : 1.0f, 1.0f, 1e23f);

  const float* sa = sacc + (size_t)b * kSlots;
  float acc_thrust = sa[A_THRUST], acc_id = sa[A_ID], acc_id2 = sa[A_ID2], acc_ib0 = sa[A_IB0];
  float acc_mdot = sa[A_MDOT], acc_uexit = sa[A_UEXIT];
  float failed = mx(sa[A_FAILED], any_bad ? 1.0f : 0.0f);
  float icir = sa[A_ICIR];
  const int ex = NC - 2;  // exit-plane lane of the accumulators

  for (int k = 0; k < p.K; ++k) {
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
    const float nn = mx(rn * p.inv_mi, 1e6f);

    // ---- collisions and mobility
    const float lnTe = logf(Te);
    const float lnL = clip(23.0f - 0.5f * logf(ne * 1e-6f) + 1.5f * lnTe, 2.0f, 30.0f);
    const float rs_te = 1.0f / sqrtf(Te);
    const float nu_ei = 2.9e-12f * ne * lnL * (rs_te * rs_te * rs_te);
    const float nu_e = p.k_en * nn + nu_ei + nu_anom + nu_ew;
    const float mu = p.E_ME * nu_e / (nu_e * nu_e + omega * omega);

    // ---- Ohm's law: two lane reductions and the RL circuit filter
    float j_i = p.zq[0] * ni[0] * ui[0];
#pragma unroll
    for (int z = 1; z < Z; ++z) j_i = j_i + p.zq[z] * ni[z] * ui[z];
    j_i = p.E * j_i;
    const float pe = ne * Te;
    __syncthreads();
    sh[0][l] = pe;
    __syncthreads();
    const float pe_p = sh[0][(l + 1) & M], pe_m = sh[0][(l - 1) & M];
    float grad_pe = (pe_p - pe_m) * p.half_inv_dz;
    if (l == 0) grad_pe = (pe_p - pe) * p.inv_dz;
    if (l == NC - 1) grad_pe = (pe - pe_m) * p.inv_dz;
    if (!in_domain) grad_pe = 0.0f;
    const float inv_enmu = 1.0f / (p.E * ne * mu);
    const float gpe_ne = grad_pe * inv_ne;
    const float num_igd = (j_i * inv_enmu + gpe_ne) * interior_f;
    const float den_igd = p.solve_plume ? (inv_AR * inv_enmu * interior_f) : (inv_enmu * interior_f);
    red[0][l] = num_igd;
    red[1][l] = den_igd;
    if (l == 1) {  // lane-1 values for the anode sheath and the ghost cells
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
    __syncthreads();
    for (int s = LN / 2; s > 0; s >>= 1) {
      if (l < s) {
        red[0][l] += red[0][l + s];
        red[1][l] += red[1][l + s];
      }
      __syncthreads();
    }
    const float num_int = red[0][0] * p.dz;
    const float ne1 = bc[0], Te1 = bc[1], j_i1 = bc[2];
    const float i_prev = clip(icir, -1e4f, 1e4f);
    const float den_pl = red[1][0] * p.dz + rc * p.A_ch;
    const float den_all = den_pl + l_dt * p.A_ch;
    const float j_prev = i_prev * p.inv_A_ch;
    float j_d = j_prev + (dV + num_int - j_prev * den_pl) / den_all;
    if (p.anode_sheath) {
      const float j_e_th = p.E * ne1 * sqrtf(p.E * Te1 / p.two_pi_me);
      const float j_e_req = mx(j_d - j_i1, 1e-6f * j_e_th);
      const float phi_s = clip(Te1 * logf(j_e_th / j_e_req), 0.0f, 0.5f * fabsf(dV));
      j_d = j_prev + (dV - phi_s + num_int - j_prev * den_pl) / den_all;
    }
    const float j_d_loc = p.solve_plume ? j_d * inv_AR : j_d;
    const float E_z = (j_d_loc - j_i) * inv_enmu - gpe_ne;

    // ---- heavy-species ghost cells
    const float u_bohm1 = sqrtf(p.E * Te1 / p.mi);
    float mom_back = 0.0f;
#pragma unroll
    for (int z = 0; z < Z; ++z) mom_back = mom_back + mn(bc[6 + z], 0.0f);
    const float rho_n_l = (mdot_in / p.A_ch - mom_back) / u_n;
    // (the reduction's trailing barrier orders these writes after all reads of sh)
    sh[0][l] = rn;
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      sh[1 + z][l] = ri[z];
      sh[1 + Z + z][l] = mo[z];
    }
    __syncthreads();
    const int lm = (l - 1) & M, lp = (l + 1) & M;
    const float rho_n_b = (l == 0) ? rho_n_l : ((l == NC - 1) ? sh[0][lm] : rn);
    float rb[Z], mb[Z], ub[Z];
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      const float u_gl = mn(bc[9 + z], p.bohm_c[z] * u_bohm1);
      const float r_gl = bc[3 + z];
      rb[z] = (l == 0) ? r_gl : ((l == NC - 1) ? sh[1 + z][lm] : ri[z]);
      mb[z] = (l == 0) ? r_gl * u_gl : ((l == NC - 1) ? sh[1 + Z + z][lm] : mo[z]);
      ub[z] = mb[z] / mx(rb[z], p.rho_floor);
    }

    // ---- fluxes through face l (between cells l and l+1): MUSCL minmod + HLLE
    float sl_rn = 0.0f, sl_r[Z], sl_u[Z];
#pragma unroll
    for (int z = 0; z < Z; ++z) sl_r[z] = sl_u[z] = 0.0f;
    if (p.reconstruct) {
      __syncthreads();
      sh[0][l] = rho_n_b;
#pragma unroll
      for (int z = 0; z < Z; ++z) {
        sh[1 + z][l] = rb[z];
        sh[1 + Z + z][l] = ub[z];
      }
      __syncthreads();
      const float dp_n = sh[0][lp] - rho_n_b;
      float dp_r[Z], dp_u[Z];
#pragma unroll
      for (int z = 0; z < Z; ++z) {
        dp_r[z] = sh[1 + z][lp] - rb[z];
        dp_u[z] = sh[1 + Z + z][lp] - ub[z];
      }
      __syncthreads();
      sh[0][l] = dp_n;
#pragma unroll
      for (int z = 0; z < Z; ++z) {
        sh[1 + z][l] = dp_r[z];
        sh[1 + Z + z][l] = dp_u[z];
      }
      __syncthreads();
      auto minmod = [&](float dq_m, float dq_p) {
        const float s = 0.5f * (sgn(dq_m) + sgn(dq_p)) * mn(fabsf(dq_m), fabsf(dq_p));
        return s * interior_f;
      };
      sl_rn = minmod(sh[0][lm], dp_n);
#pragma unroll
      for (int z = 0; z < Z; ++z) {
        sl_r[z] = minmod(sh[1 + z][lm], dp_r[z]);
        sl_u[z] = minmod(sh[1 + Z + z][lm], dp_u[z]);
      }
    }
    const float Fn = u_n * mx(rho_n_b + 0.5f * sl_rn, p.rho_floor) * face_f;
    __syncthreads();
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      sh[1 + z][l] = rb[z] - 0.5f * sl_r[z];
      sh[1 + Z + z][l] = ub[z] - 0.5f * sl_u[z];
    }
    __syncthreads();
    float Fr[Z], Fm[Z];
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      const float rL = mx(rb[z] + 0.5f * sl_r[z], p.rho_floor);
      const float rR = mx(sh[1 + z][lp], p.rho_floor);
      const float uL = ub[z] + 0.5f * sl_u[z];
      const float uR = sh[1 + Z + z][lp];
      const float mL = rL * uL, mR = rR * uR;
      const float sL = mn(mn(uL - p.a_i, uR - p.a_i), 0.0f);
      const float sR = mx(mx(uL + p.a_i, uR + p.a_i), 0.0f);
      const float ds = mx(sR - sL, 1e-8f);
      const float FmL = mL * uL + rL * p.a_i_sq;
      const float FmR = mR * uR + rR * p.a_i_sq;
      const float inv_ds = face_f / ds;
      Fr[z] = (sR * mL - sL * mR + sL * sR * (rR - rL)) * inv_ds;
      Fm[z] = (sR * FmL - sL * FmR + sL * sR * (mR - mL)) * inv_ds;
    }
    // flux divergence (quasi-1D with the plume cone: (1/A) d(A F)/dz)
    const float wF = p.solve_plume ? AR_f : 1.0f;
    __syncthreads();
    sh[0][l] = p.solve_plume ? Fn * wF : Fn;
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      sh[1 + z][l] = p.solve_plume ? Fr[z] * wF : Fr[z];
      sh[1 + Z + z][l] = p.solve_plume ? Fm[z] * wF : Fm[z];
    }
    __syncthreads();
    auto ddz = [&](float F, int j) {
      return p.solve_plume ? (F * wF - sh[j][lm]) * p.inv_dz * inv_AR : (F - sh[j][lm]) * p.inv_dz;
    };
    const float ddz_n = ddz(Fn, 0);
    float ddz_r[Z], ddz_m[Z];
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      ddz_r[z] = ddz(Fr[z], 1 + z);
      ddz_m[z] = ddz(Fm[z], 1 + Z + z);
    }

    // ---- sources: log-poly rates, E-force, pressure-area, ion-wall losses
    float d_rho_n = 0.0f, d_rho[Z], d_mom[Z], inelastic = 0.0f, dinel = 0.0f;
#pragma unroll
    for (int z = 0; z < Z; ++z) d_rho[z] = d_mom[z] = 0.0f;
    const float inv_Te = 1.0f / Te;
    {
      int r = 0;
#pragma unroll
      for (int zf = 0; zf < Z; ++zf) {
#pragma unroll
        for (int zt = zf + 1; zt <= Z; ++zt, ++r) {
          const float* cr = s_coef + r * (kNCoef + kNDCoef);
          const float k_r = expf(poly<kNCoef>(cr, lnTe));
          const float n_from = (zf == 0) ? nn : ni[zf > 0 ? zf - 1 : 0];
          const float u_from = (zf == 0) ? u_n : ui[zf > 0 ? zf - 1 : 0];
          const float dm = ne * k_r * n_from * p.mi;
          if (zf == 0) {
            d_rho_n = d_rho_n - dm;
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
      const float* ce = s_coef + NR * (kNCoef + kNDCoef);
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
      for (int z = 0; z < Z; ++z) d_mom[z] = d_mom[z] + ri[z] * p.a_i_sq * dlnA;
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
    float ri_new[Z], mo_new[Z];
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      ri_new[z] = mx(upd(rb[z], ddz_r[z], d_rho[z]), p.rho_floor);
      mo_new[z] = upd(mb[z], ddz_m[z], d_mom[z]);
    }

    // ---- electron energy: backward Euler in Te, row-normalised PCR over lanes
    float ne_new = ri_new[0] * p.inv_mi_zq[0];
#pragma unroll
    for (int z = 1; z < Z; ++z) ne_new = ne_new + ri_new[z] * p.inv_mi_zq[z];
    ne_new = mx(ne_new, p.ne_floor);

    const float Gamma_e = (j_i - j_d_loc) * p.inv_E;
    const float kap = p.ten_ninth * mu * ne * Te;
    __syncthreads();
    sh[0][l] = Gamma_e;
    sh[1][l] = kap;
    __syncthreads();
    const float G_f = 0.5f * (Gamma_e + sh[0][lp]);
    const float kf = p.half_inv_dz * (kap + sh[1][lp]);
    const float Gp = 2.5f * mx(G_f, 0.0f);
    const float Gn = 2.5f * mn(G_f, 0.0f);
    float wall_rate;
    if (p.sheath_wall) {
      const float gamma = mn(p.gmax, 1.4f * expf(0.576f * (lnTe - p.ln_cross)));
      const float one_m_g = 1.0f - gamma;
      const float phi_w_over_te = mx(logf(one_m_g * p.sq_mi_2pi_me), 0.0f);
      const float sqrt_te = Te * rs_te;
      wall_rate = p.coef_sheath * c_w * sqrt_te / one_m_g * (2.0f + phi_w_over_te) * in_channel;
    } else {
      wall_rate = p.wall_energy_scale * c_w * 1e7f * expf(-20.0f / Te) * in_channel;
    }
    const float nu_eps = p.e_wall * wall_rate;
    const float q_ohm = (j_d_loc - j_i) * E_z * p.inv_E;
    __syncthreads();
    sh[0][l] = Gp;
    sh[1][l] = Gn;
    sh[2][l] = kf;
    __syncthreads();
    const float Gp_m = sh[0][lm], Gn_m = sh[1][lm], kf_m = sh[2][lm];
    float sub, sup, diag;
    if (p.solve_plume) {
      sub = (-Gp_m - kf_m) * wm * p.inv_dz;
      sup = (Gn - kf) * wp * p.inv_dz;
      diag = ne_new * (p.c15_inv_dt + nu_eps * 1.5f) + ((Gp + kf) * wp + (kf_m - Gn_m) * wm) * p.inv_dz;
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
    if (l == NC - 2) rhs = rhs - sup * te_cath;
    if (l == 1) sub = 0.0f;
    if (l == NC - 2) sup = 0.0f;
    if (!interior) {
      sub = 0.0f;
      sup = 0.0f;
      diag = 1.0f;
      rhs = 1.0f;
    }
    const float inv = 1.0f / diag;
    float a = sub * inv, c = sup * inv, d = rhs * inv;
    for (int lvl = 0, kk = 1; lvl < p.n_levels; ++lvl, kk *= 2) {
      __syncthreads();
      sh[0][l] = a;
      sh[1][l] = c;
      sh[2][l] = d;
      __syncthreads();
      const int lmk = (l - kk) & M, lpk = (l + kk) & M;
      const float cm = sh[1][lmk], ap = sh[0][lpk], dm_ = sh[2][lmk], dp_ = sh[2][lpk];
      const float b_new = 1.0f - a * cm - c * ap;
      d = d - a * dm_ - c * dp_;
      const float rb_ = 1.0f / b_new;
      d = d * rb_;
      if (lvl < p.n_levels - 1) {
        a = -a * sh[0][lmk] * rb_;
        c = -c * sh[1][lpk] * rb_;
      }
    }
    float Te_new = (l == 0) ? p.anode_Te : d;
    if (l >= NC - 1) Te_new = te_cath;
    Te_new = clip(Te_new, p.Te_min, p.Te_max);

    // ---- commit the step
    rn = rn_new;
    nE = 1.5f * ne_new * Te_new;
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      ri[z] = ri_new[z];
      mo[z] = mo_new[z];
      ui[z] = mo[z] / mx(ri[z], p.rho_floor);
    }

    // ---- gated accumulation (overshoot steps of the last launch do not count)
    const int i = p.i0 + k;
    const float w = (i >= p.avg_start && i < p.num_steps) ? 1.0f : 0.0f;
    if (l == ex) {
#pragma unroll
      for (int z = 0; z < Z; ++z) {
        bx[z] = ri[z];
        bx[3 + z] = mo[z];
        bx[6 + z] = ui[z];
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
      pf[z] += w * ui[z];
    }
    if (p.solve_plume) {
      thrust = thrust * qs_t;
      I_B0 = I_B0 * qs_f;
      mdot_ion = mdot_ion * qs_f;
    }
    const float I_d = j_d * p.A_ch;
    pf[Z] += w * Te;
    pf[Z + 1] += w * ne;
    pf[Z + 2] += w * E_z;
    pf[Z + 3] += w * nn;
    acc_thrust += w * thrust;
    acc_id += w * I_d;
    acc_id2 += w * I_d * I_d;
    acc_ib0 += w * I_B0;
    acc_mdot += w * mdot_ion;
    acc_uexit += w * bx[6];
    failed = mx(failed, isfinite(I_d) ? 0.0f : 1.0f);
    icir = I_d;
  }

  // ---- write back once per launch
  state[off] = rn;
  state[plane + off] = nE;
#pragma unroll
  for (int z = 0; z < Z; ++z) {
    state[(2 + 2 * z) * plane + off] = ri[z];
    state[(3 + 2 * z) * plane + off] = mo[z];
  }
#pragma unroll
  for (int j = 0; j < Z + 4; ++j) prof[j * plane + off] = pf[j];
  if (l == 0) {
    float* so = sacc + (size_t)b * kSlots;
    so[A_THRUST] = acc_thrust;
    so[A_ID] = acc_id;
    so[A_ID2] = acc_id2;
    so[A_IB0] = acc_ib0;
    so[A_MDOT] = acc_mdot;
    so[A_UEXIT] = acc_uexit;
    so[A_FAILED] = failed;
    so[A_ICIR] = icir;
  }
}

template <int Z>
static void launch_z(const KParams& p, int B, int LN, cudaStream_t s, void* state, void* prof,
                     void* sacc, const void* nu_anom, const void* omega, const void* scalars,
                     const void* coef) {
  kstep_kernel<Z><<<B, LN, 0, s>>>(p, B, (float*)state, (float*)prof, (float*)sacc,
                                   (const float*)nu_anom, (const float*)omega,
                                   (const float*)scalars, (const float*)coef);
}

extern "C" int kstep_params_size() { return (int)sizeof(KParams); }

// Launch one K-step block on `stream` (a cudaStream_t). Returns the cudaError_t
// of the launch (0 on success); does not synchronise.
extern "C" int kstep_launch(const KParams* p, int Z, int B, int LN, void* state, void* prof,
                            void* sacc, const void* nu_anom, const void* omega,
                            const void* scalars, const void* coef, void* stream) {
  if (LN != 128 && LN != kMaxLanes) return (int)cudaErrorInvalidValue;
  if (B <= 0 || p->NC > LN - 2 || p->NC < 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (Z) {
    case 1: launch_z<1>(*p, B, LN, s, state, prof, sacc, nu_anom, omega, scalars, coef); break;
    case 2: launch_z<2>(*p, B, LN, s, state, prof, sacc, nu_anom, omega, scalars, coef); break;
    case 3: launch_z<3>(*p, B, LN, s, state, prof, sacc, nu_anom, omega, scalars, coef); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
