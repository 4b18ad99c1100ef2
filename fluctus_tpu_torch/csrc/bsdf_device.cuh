// BSDF device code of surface_shade.cu: the lobes of bsdf/dispatch.py
// and ggx.py, the rng's uniform, the vector and sampling helpers, and
// ``shade_lane``, a segment's BSDF work for one lane (dispatch.py's
// bsdf_shade).
//
// Bit for bit against torch's CUDA kernels: each lobe in the torch code's
// order of terms, every torch operation one rounded IEEE operation
// (-fmad=false, -prec-div, -prec-sqrt), the libm calls torch's
// elementwise kernels make (sqrtf, rsqrtf, sinf, cosf, atan2f), and
// torch's CUDA forms of the operations with a Python number: x / c is
// x * (1 / c), c / x is reciprocal(x) * c, x ** 2 is x * x, clamp keeps
// a NaN.
#pragma once
#include "common.cuh"

namespace {

// bxdf_types.py
constexpr int DIFFUSE = 1 << 1;
constexpr int GLOSSY = 1 << 2;
constexpr int GGX_REFLECTION = 1 << 3;
constexpr int IDEAL_REFLECTION = 1 << 4;
constexpr int GGX_DIELECTRIC = 1 << 5;
constexpr int IDEAL_DIELECTRIC = 1 << 6;
constexpr int EMISSIVE = 1 << 7;
constexpr int MIXED = 1 << 8;

// Python numbers as torch hands them to a float32 kernel: the double
// rounded to float.
constexpr float PI_F = static_cast<float>(3.14159265358979323846);
constexpr float INV_PI_F = static_cast<float>(0.3183098861837907);
constexpr float TWO_PI_F = static_cast<float>(6.2831853071795864);
constexpr float TINY = static_cast<float>(1e-30);
constexpr float NI_MIN = static_cast<float>(1.0 + 1e-6);
constexpr float KS_MAX = static_cast<float>(0.99);
constexpr float COS_MIN = static_cast<float>(1e-5);
constexpr float ORIG_EPS = static_cast<float>(1e-4);
// x / 3.0 on the card: x times the float reciprocal torch forms on the host
constexpr float INV_3 = 1.0f / 3.0f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return V3{a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return V3{a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator-(V3 a) { return V3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) {
  return V3{a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 splat3(float s) { return V3{s, s, s}; }

// torch.clamp_min / torch.clamp on CUDA: a NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// vec.py
__device__ __forceinline__ V3 normalize(V3 a) {
  return a * rsqrtf(clamp_min(dot(a, a), TINY));
}
__device__ __forceinline__ V3 reflect0(V3 d, V3 n) {
  return d - n * (dot(d, n) * 2.0f);
}
__device__ __forceinline__ V3 refract1(V3 wi, V3 n, float eta, float i_dot_n,
                                       float cos_t) {
  return wi * eta + n * (eta * i_dot_n - cos_t);
}

// ggx._safe_div and dispatch._inv_cos
__device__ __forceinline__ float safe_div(float num, float den) {
  return den != 0.0f ? num / den : 0.0f;
}
__device__ __forceinline__ float inv_cos(float c) {
  return c != 0.0f ? (1.0f / c) * 1.0f : 0.0f;
}

// rng.py: Bob Jenkins' hash and the mantissa-splice uniform. The first
// step in 64 bits, as torch's int64 seeds; from there the value fits 32.
__device__ __forceinline__ float uniform(unsigned long long& seed) {
  long long s = static_cast<long long>(seed);
  s = (s ^ 61) ^ (s >> 16);
  unsigned int x = static_cast<unsigned int>(
      (static_cast<unsigned long long>(s) * 9ull) & 0xFFFFFFFFull);
  x = x ^ (x >> 4);
  x = x * 0x27D4EB2Du;
  x = x ^ (x >> 15);
  seed = x;
  return __uint_as_float((x >> 9) | 0x3F800000u) - 1.0f;
}

// sampling.py
struct Basis {
  V3 t, b;
};
__device__ __forceinline__ Basis ortho_basis(V3 n) {
  const float sign = n.z > 0.0f ? 1.0f : -1.0f;
  const float a = (1.0f / (sign + n.z)) * -1.0f;
  const float b = n.x * n.y * a;
  return Basis{V3{1.0f + sign * n.x * n.x * a, sign * b, -sign * n.x},
               V3{b, sign + n.y * n.y * a, -n.y}};
}

__device__ __forceinline__ V3 cos_sample_hemisphere(V3 n, float u1,
                                                    float u2) {
  const float r1 = u1 * TWO_PI_F;
  const float r2s = sqrtf(u2);
  const Basis uv = ortho_basis(n);
  return uv.t * (cosf(r1) * r2s) + uv.b * (sinf(r1) * r2s) +
         n * sqrtf(clamp_min(1.0f - u2, 0.0f));
}

// fresnel.py; returns F, with cos theta_t in cos_t
__device__ __forceinline__ float fresnel_cos_t(float cos_i, float eta_i,
                                               float eta_t, float& cos_t) {
  const float sin_i = sqrtf(clamp_min(1.0f - cos_i * cos_i, 0.0f));
  const float sin_t = eta_i / eta_t * sin_i;
  cos_t = sqrtf(clamp_min(1.0f - sin_t * sin_t, 0.0f));
  const float etat_cosi = eta_t * cos_i;
  const float etai_cost = eta_i * cos_t;
  const float s1 = etat_cosi + etai_cost;
  const float parl = (etat_cosi - etai_cost) / (s1 == 0.0f ? 1.0f : s1);
  const float etai_cosi = eta_i * cos_i;
  const float etat_cost = eta_t * cos_t;
  const float s2 = etai_cosi + etat_cost;
  const float perp = (etai_cosi - etat_cost) / (s2 == 0.0f ? 1.0f : s2);
  const float f = (parl * parl + perp * perp) * 0.5f;
  return sin_t >= 1.0f ? 1.0f : f;
}
__device__ __forceinline__ float fresnel(float cos_i, float eta_i,
                                         float eta_t) {
  float cos_t;
  return fresnel_cos_t(cos_i, eta_i, eta_t, cos_t);
}

// ggx.py
__device__ __forceinline__ V3 ggx_sample_lobe(float alpha, V3 n, float u1,
                                              float u2) {
  const Basis xy = ortho_basis(n);
  const float theta = atan2f(alpha * sqrtf(u1),
                             sqrtf(clamp_min(1.0f - u1, 0.0f)));
  const float phi = u2 * TWO_PI_F;
  const float st = sinf(theta), ct = cosf(theta);
  const float sp = sinf(phi), cp = cosf(phi);
  return xy.t * (st * cp) + xy.b * (st * sp) + n * ct;
}

__device__ __forceinline__ float ggx_g1(float alpha, V3 v, V3 n, V3 m) {
  const float m_dot_v = dot(m, v);
  const float n_dot_v = dot(n, v);
  const float cos_sq = n_dot_v * n_dot_v;
  const float tan_sq =
      cos_sq > 0.0f ? (1.0f - cos_sq) / clamp_min(cos_sq, TINY) : 0.0f;
  const float g = (1.0f / (1.0f + sqrtf(1.0f + alpha * alpha * tan_sq))) *
                  2.0f;
  return n_dot_v * m_dot_v <= 0.0f ? 0.0f : g;
}

__device__ __forceinline__ float ggx_g(float alpha, V3 d_in, V3 d_out, V3 n,
                                       V3 m) {
  return ggx_g1(alpha, d_in, n, m) * ggx_g1(alpha, d_out, n, m);
}

__device__ __forceinline__ float ggx_d(float alpha, V3 n, V3 m) {
  const float n_dot_m = dot(n, m);
  const float nm_sq = n_dot_m * n_dot_m;
  const float tan_sq = (1.0f - nm_sq) / clamp_min(nm_sq, TINY);
  const float a_sq = alpha * alpha;
  const float s = a_sq + tan_sq;
  const float denom = nm_sq * PI_F * nm_sq * (s * s);
  return n_dot_m <= 0.0f ? 0.0f : a_sq / clamp_min(denom, TINY);
}

__device__ __forceinline__ float ggx_pdf_reflect(float alpha, V3 d_out, V3 n,
                                                 V3 h) {
  const float n_dot_h = dot(n, h);
  const float o_dot_h = dot(d_out, h);
  if (o_dot_h == 0.0f) return 0.0f;
  return ggx_d(alpha, n, h) * fabsf(n_dot_h * 0.25f / o_dot_h);
}

__device__ __forceinline__ float ggx_pdf_refract(float alpha, float eta_i,
                                                 float eta_o, V3 d_in,
                                                 V3 d_out, V3 n, V3 h) {
  const float n_dot_h = fabsf(dot(n, h));
  const float i_dot_h = fabsf(dot(d_in, h));
  const float o_dot_h = fabsf(dot(d_out, h));
  const float sji = eta_i * i_dot_h + eta_o * o_dot_h;
  if (sji == 0.0f) return 0.0f;
  return ggx_d(alpha, n, h) * n_dot_h * o_dot_h * eta_o * eta_o /
         clamp_min(sji * sji, TINY);
}

__device__ __forceinline__ V3 eval_reflect_with_h(V3 n, V3 ks, float alpha,
                                                  float ni, V3 d_in_n,
                                                  V3 d_out, V3 h) {
  const float i_dot_n = dot(d_in_n, n);
  const float o_dot_n = dot(d_out, n);
  const float f =
      ni > 1.0f ? fresnel(i_dot_n, 1.0f, clamp_min(ni, NI_MIN)) : 1.0f;
  const float d = ggx_d(alpha, n, h);
  const float g = ggx_g(alpha, d_in_n, d_out, n, h);
  const float s = safe_div(f * g * d * 0.25f, i_dot_n * o_dot_n);
  return V3{ks.x * s, ks.y * s, ks.z * s};
}

__device__ __forceinline__ V3 eval_reflect(V3 n, V3 ks, float alpha,
                                           float ni, V3 dir_in, V3 dir_out) {
  const V3 h = normalize(dir_out - dir_in);
  return eval_reflect_with_h(n, ks, alpha, ni, -dir_in, dir_out, h);
}

__device__ __forceinline__ float pdf_reflect(V3 n, float alpha, V3 dir_in,
                                             V3 dir_out) {
  const V3 h = normalize(dir_out - dir_in);
  return ggx_pdf_reflect(alpha, dir_out, n, h);
}

// returns the brdf; the direction and pdf in d, pdf
__device__ __forceinline__ V3 sample_reflect(V3 n, V3 ks, float alpha,
                                             float ni, V3 dir_in, float u1,
                                             float u2, V3& d, float& pdf) {
  const V3 h = ggx_sample_lobe(alpha, n, u1, u2);
  d = reflect0(dir_in, h);
  pdf = ggx_pdf_reflect(alpha, d, n, h);
  return eval_reflect_with_h(n, ks, alpha, ni, -dir_in, d, h);
}

__device__ __forceinline__ float focus(float eta_i, float eta_o,
                                       float i_dot_n, float o_dot_n,
                                       float i_dot_h, float o_dot_h) {
  const float s = eta_i * i_dot_h + eta_o * o_dot_h;
  const float den = i_dot_n * o_dot_n * (s * s);
  return safe_div(eta_o * eta_o * i_dot_h * o_dot_h, den);
}

// the rough dielectric's sample: Fresnel picks reflection (u3 < F) or
// refraction about the sampled half-vector
__device__ __forceinline__ V3 sample_refract(V3 n, V3 ks, float alpha,
                                             float ni, bool backface,
                                             V3 dir_in, float u1, float u2,
                                             float u3, V3& d, float& pdf) {
  const V3 d_in_n = -dir_in;
  const float eta_i = backface ? ni : 1.0f;
  const float eta_o = backface ? 1.0f : ni;
  const float i_dot_n = dot(d_in_n, n);
  const V3 h = ggx_sample_lobe(alpha, n, u1, u2);
  float cos_t;
  const float f = fresnel_cos_t(i_dot_n, eta_i, eta_o, cos_t);
  if (u3 < f) {
    d = reflect0(dir_in, h);
    pdf = ggx_pdf_reflect(alpha, d, n, h);
    return splat3(safe_div(
        f * ggx_g(alpha, d_in_n, d, n, h) * ggx_d(alpha, n, h) * 0.25f,
        i_dot_n * dot(d, n)));
  }
  const float eta = eta_i / eta_o;
  d = refract1(dir_in, n, eta, i_dot_n, cos_t);
  const V3 n_side = backface ? -n : n;
  const V3 h2 = normalize(dir_in * eta_i - d * eta_o);
  pdf = ggx_pdf_refract(alpha, eta_i, eta_o, d_in_n, d, n_side, h2);
  const float fc = focus(eta_i, eta_o, i_dot_n, dot(d, n),
                         fabsf(dot(dir_in, h2)), fabsf(dot(d, h2)));
  const float d_t = ggx_d(alpha, n_side, h2);
  const float g_t = ggx_g(alpha, d_in_n, d, n_side, h2);
  const float s = (1.0f - f) * (eta * eta) * d_t * g_t * fc;
  return V3{ks.x * s, ks.y * s, ks.z * s};
}

// two-sided: a front face evaluates reflection, a back face transmission
__device__ __forceinline__ V3 eval_refract(V3 n, V3 ks, float alpha, float ni,
                                           bool backface, V3 dir_in,
                                           V3 dir_out) {
  const V3 d_in_n = -dir_in;
  const float eta_i = backface ? ni : 1.0f;
  const float eta_o = backface ? 1.0f : ni;
  const float i_dot_n = dot(d_in_n, n);
  const float o_dot_n = dot(dir_out, n);
  const float f = fresnel(i_dot_n, eta_i, eta_o);
  if (!backface) {
    const V3 h_r = normalize(dir_out - dir_in);
    return splat3(safe_div(f * ggx_g(alpha, d_in_n, dir_out, n, h_r) *
                               ggx_d(alpha, n, h_r) * 0.25f,
                           i_dot_n * o_dot_n));
  }
  const V3 h_t = normalize(dir_in * eta_i - dir_out * eta_o);
  const float eta = eta_i / eta_o;
  const float fc = focus(eta_i, eta_o, i_dot_n, o_dot_n,
                         fabsf(dot(dir_in, h_t)), fabsf(dot(dir_out, h_t)));
  const V3 neg_n = -n;
  const float s = (1.0f - f) * (eta * eta) * ggx_d(alpha, neg_n, h_t) *
                  ggx_g(alpha, d_in_n, dir_out, neg_n, h_t) * fc;
  return V3{ks.x * s, ks.y * s, ks.z * s};
}

__device__ __forceinline__ float pdf_refract(V3 n, float alpha, float ni,
                                             bool backface, V3 dir_in,
                                             V3 dir_out) {
  if (!backface) {
    const V3 h_r = normalize(dir_out - dir_in);
    return ggx_pdf_reflect(alpha, dir_out, n, h_r);
  }
  const V3 h_t = normalize(dir_in * ni - dir_out * 1.0f);
  return ggx_pdf_refract(alpha, ni, 1.0f, -dir_in, dir_out, -n, h_t);
}

// dispatch._glossy_params: Ks and Ni, each filled in from the other
__device__ __forceinline__ void glossy_params(V3 ks_in, float ni_in, V3& ks,
                                              float& ni) {
  if (ni_in > 0.0f) {
    ni = ni_in;
  } else {
    const float k = clamp((ks_in.x + ks_in.y + ks_in.z) * INV_3, 0.0f,
                          KS_MAX);
    const float s = sqrtf(k);
    ni = (s + 1.0f) / (1.0f - s);
  }
  const float r = ni > 0.0f ? (ni - 1.0f) / (ni + 1.0f) : 0.0f;
  const float ks_auto = r * r;
  const bool zero = ks_in.x == 0.0f && ks_in.y == 0.0f && ks_in.z == 0.0f;
  ks = zero ? splat3(ks_auto) : ks_in;
}

// What bsdf_shade gives a lane (bsdf/dispatch.py's Shaded).
struct Shade {
  V3 ev;        // the NEE ray's bsdf
  float epdf;   // and its pdf, clamped at 0
  V3 d;         // the continuation ray's direction
  float pdf;    // and its pdf
  V3 T;         // the path's new throughput
  V3 orig;      // the continuation ray's origin
};

// A segment's BSDF work for one lane: the NEE ray's bxdf_eval and
// bxdf_pdf, the continuation's bxdf_sample (three draws of ``seed``,
// whatever the lobe), the new throughput T f cos / pdf and the origin
// P + 1e-4 d. A lane whose type matches no lobe, or whose lobe the
// scene's type mask ``st`` leaves out, gets what the masked selects give
// it: zeros.
__device__ __forceinline__ Shade shade_lane(V3 nrm, V3 kd, V3 ks, V3 ke,
                                            float alpha, float ni, int t,
                                            bool back, V3 dir_in, V3 dir_nee,
                                            unsigned long long& seed, V3 T,
                                            V3 P, int st) {
  Shade r;
  const bool diffuse = t == DIFFUSE || t == MIXED;

  // the NEE ray: bxdf_eval and bxdf_pdf, the pdf clamped at 0
  V3 ev = splat3(0.0f);
  float pd = 0.0f;
  if (diffuse && (st & (DIFFUSE | MIXED))) {
    ev = kd * INV_PI_F;
    pd = dot(nrm, dir_nee) * INV_PI_F;
  } else if (t == GLOSSY && (st & GLOSSY)) {
    V3 ksg;
    float nig;
    glossy_params(ks, ni, ksg, nig);
    const V3 coat = eval_reflect(nrm, ksg, alpha, nig, dir_in, dir_nee);
    const float fr = fresnel(-dot(dir_in, nrm), 1.0f, nig);
    ev = kd * INV_PI_F * (1.0f - fr) + coat;
    const float base = dot(nrm, dir_nee) * INV_PI_F;
    const float coat_pdf = pdf_reflect(nrm, alpha, dir_in, dir_nee);
    pd = (1.0f - fr) * base + fr * coat_pdf;
  } else if (t == GGX_REFLECTION && (st & GGX_REFLECTION)) {
    ev = eval_reflect(nrm, ks, alpha, ni, dir_in, dir_nee);
    pd = pdf_reflect(nrm, alpha, dir_in, dir_nee);
  } else if (t == GGX_DIELECTRIC && (st & GGX_DIELECTRIC)) {
    ev = eval_refract(nrm, ks, alpha, ni, back, dir_in, dir_nee);
    pd = pdf_refract(nrm, alpha, ni, back, dir_in, dir_nee);
  } else if (t == EMISSIVE && (st & EMISSIVE)) {
    ev = ke;
  }
  r.ev = ev;
  r.epdf = clamp_min(pd, 0.0f);

  // the continuation ray: bxdf_sample, three draws whatever the lobe
  const float ra = uniform(seed);
  const float rb = uniform(seed);
  const float rc = uniform(seed);
  V3 d = splat3(0.0f);
  V3 f = splat3(0.0f);
  float pdf = 0.0f;
  if ((diffuse || t == EMISSIVE) && (st & (DIFFUSE | MIXED | EMISSIVE))) {
    if (diffuse) {
      d = cos_sample_hemisphere(nrm, ra, rb);
      pdf = dot(nrm, d) * INV_PI_F;
      f = kd * INV_PI_F;
    } else {
      f = splat3(1.0f);       // emissive: pdf 0 ends the path
    }
  } else if (t == GLOSSY && (st & GLOSSY)) {
    // both sub-lobes' pdfs and values blended, the direction picked by
    // Fresnel
    V3 ksg;
    float nig;
    glossy_params(ks, ni, ksg, nig);
    const float fr = fresnel(-dot(dir_in, nrm), 1.0f, nig);
    float coat_pdf;
    V3 coat_f;
    if (ra < fr) {
      coat_f = sample_reflect(nrm, ksg, alpha, nig, dir_in, rb, rc, d,
                              coat_pdf);
    } else {
      d = cos_sample_hemisphere(nrm, rb, rc);
      coat_pdf = pdf_reflect(nrm, alpha, dir_in, d);
      coat_f = eval_reflect(nrm, ksg, alpha, nig, dir_in, d);
    }
    const float base_pdf = dot(nrm, d) * INV_PI_F;
    pdf = (1.0f - fr) * base_pdf + fr * coat_pdf;
    f = dot(nrm, d) < COS_MIN ? splat3(0.0f)
                              : kd * INV_PI_F * (1.0f - fr) + coat_f;
  } else if (t == GGX_REFLECTION && (st & GGX_REFLECTION)) {
    f = sample_reflect(nrm, ks, alpha, ni, dir_in, ra, rb, d, pdf);
  } else if (t == GGX_DIELECTRIC && (st & GGX_DIELECTRIC)) {
    f = sample_refract(nrm, ks, alpha, ni, back, dir_in, ra, rb, rc, d, pdf);
  } else if (t == IDEAL_REFLECTION && (st & IDEAL_REFLECTION)) {
    d = reflect0(dir_in, nrm);
    const float ic = inv_cos(dot(normalize(d), nrm));
    f = V3{ks.x * ic, ks.y * ic, ks.z * ic};
    pdf = 1.0f;
  } else if (t == IDEAL_DIELECTRIC && (st & IDEAL_DIELECTRIC)) {
    const float cos_i = -dot(dir_in, nrm);
    const float n1 = back ? ni : 1.0f;
    const float n2 = back ? 1.0f : ni;
    const float eta = n1 / n2;
    float cos_t;
    const float fr = fresnel_cos_t(cos_i, n1, n2, cos_t);
    const bool refl = ra < fr;
    d = refl ? dir_in + nrm * (cos_i + cos_i)
             : refract1(dir_in, nrm, eta, cos_i, cos_t);
    const V3 f3 = refl ? splat3(1.0f) : ks * (eta * eta);
    const float ic = inv_cos(dot(normalize(d), nrm));
    f = V3{f3.x * ic, f3.y * ic, f3.z * ic};
    pdf = 1.0f;
  }
  r.d = d;
  r.pdf = pdf;

  // the path's throughput and the continuation ray's origin
  const bool bad = pdf == 0.0f || (f.x == 0.0f && f.y == 0.0f && f.z == 0.0f);
  const float w = dot(nrm, d) / (bad ? 1.0f : pdf);
  r.T = bad ? splat3(0.0f) : V3{T.x * f.x * w, T.y * f.y * w, T.z * f.z * w};
  r.orig = P + d * ORIG_EPS;
  return r;
}

}  // namespace
