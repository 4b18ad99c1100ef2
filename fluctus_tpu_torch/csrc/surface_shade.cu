// surface_shade — the shade layer's surface, material and raygen sections
// of one wavefront segment in one launch: each lane's Kd and Ks texture
// fetch (nearest texel, wrap, gamma 2.2 on Kd), its implicit triangle
// emission, its normal-mapped shading normal and the backface flip, NEE
// sampling (the pick, the env map's alias sample, the area light's point)
// with the selects that write the NEE fields, the BSDF work of
// bsdf_device.cuh's shade_lane, the pixel ring's advance (on the block
// ring each lane's exclusive rank among its group's terminated lanes and
// each group's cursor), the camera ray of every lane with depth of field,
// and the merge into the new pool.
//
// Replaces no Pallas kernel. The reference's sections (fluctus_tpu/core/
// integrator_wf.py's logic, the texture fetch, envmap.py, sampling.py and
// camera.py) are jnp code that XLA fuses on the TPU. Run eagerly by
// PyTorch they are some 650 elementwise launches a segment on the
// production luxball, and the host issuing them sets the segment's pace.
// This kernel is the same function as integrator_wf.surface_shade_plain,
// in one launch.
//
// Bit for bit against torch's CUDA kernels, as bsdf_device.cuh: every
// torch operation one rounded IEEE operation in the torch code's order of
// terms (-fmad=false), the libm calls torch's elementwise kernels make
// (powf, exp2f, sinf, cosf, atan2f, acosf, sqrtf, rsqrtf), torch's CUDA
// forms of the operations with a Python number (x / c is x * (1 / c),
// c / x is reciprocal(x) * c), integer floor division and remainder as
// Python's, and the same random draws in the same order on every lane:
// the NEE pick, the env sample, the light's two, the BSDF's three, the
// camera's two and the lens's two.
//
// Bound on the H100: memory. Per lane 41 float32 streams, 7 int32
// streams, the terminate flag and the 8-byte seed in (201 B), the baked
// texture descriptors of each map a lane has (12 B a map) and one texel
// word a fetched map; 33 float32 streams, 2 int32 streams, the seed and 2
// flags out (150 B; with the denoiser's guide inputs 6 floats and 2 flags
// more). About 380 B a lane on the production segment, 0.118 ms for 1M
// lanes at 3.35 TB/s. The arithmetic, a few hundred FP32 operations and
// some twenty transcendentals a lane, is far below 67 TFLOP/s.
//
// Design: one CTA walks one ring group (the flat ring: one CTA a tile of
// lanes, the ranks handed in). The CTA's size follows the shading code's
// register budget, not the group: at most 256 threads, which walk the
// group's S lanes in tiles with a running carry of the terminated lanes
// before the tile (a ballot a warp, the warps' counts in shared memory).
// Every per-lane stream is read and written once in lane order
// (coalesced 4-byte accesses, streamed past the caches' keep lines); the
// texels, the tangent frames and the env map's tables are the only
// scattered reads (through the read-only cache). Outputs are rows of a few
// fresh [rows, n] tensors that the new pool's fields view. Terminated
// lanes draw their random numbers and skip the shading.
#include "bsdf_device.cuh"

namespace {

constexpr int THREADS = 256;

// The per-lane float streams, in surface_shade's order
// (core/integrator_wf.py: _surface_args).
enum FIn {
  PX, PY, PZ, HNX, HNY, HNZ, UVU, UVV, KDX, KDY, KDZ, KSX, KSY, KSZ,
  KEX, KEY, KEZ, ALPHA, NI, DX, DY, DZ, TX, TY, TZ, EIX, EIY, EIZ,
  SOX, SOY, SOZ, SDX, SDY, SDZ, SLEN, LPDF, LCOS, LPICK, LEX, LEY, LEZ,
  N_FIN
};
// the per-lane int32 streams; the descriptors and the rank may be null
enum IIn {
  HIT_I, TYPE, MAP_KD, MAP_KS, MAP_N, PLEN, PIX,
  KD_OFF, KD_W, KD_H, KS_OFF, KS_W, KS_H, N_OFF, N_W, N_H, RANK, N_IIN
};
// tables: the atlas, the tangent frames [12, M], the env map's
enum Tab {
  TEXELS, T_OFF, T_W, T_H, FRAMES, ENV_PACKED, ENV_PA, ENV_PROB,
  ENV_ALIAS, ENV_PDF, ENV_IX, ENV_IY, ENV_IZ, ENV_INV_MEAN, N_TAB
};
// 0-d float32 parameters on the device
enum Par {
  CPX, CPY, CPZ, CDX, CDY, CDZ, CUX, CUY, CUZ, CRX, CRY, CRZ, FOV_SCALE,
  APERTURE, FOCAL, LPX, LPY, LPZ, LRX, LRY, LRZ, LUX, LUY, LUZ, LNX, LNY,
  LNZ, LEX_, LEY_, LEZ_, LSX, LSY, WORLD_R, ENV_STRENGTH, N_PAR
};
// the float output rows; the denoiser's two after them
enum FOut {
  O_OX, O_OY, O_OZ, O_DX, O_DY, O_DZ, O_SOX, O_SOY, O_SOZ, O_SDX, O_SDY,
  O_SDZ, O_TX, O_TY, O_TZ, O_EX, O_EY, O_EZ, O_BX, O_BY, O_BZ, O_LEX,
  O_LEY, O_LEZ, O_LTX, O_LTY, O_LTZ, O_PDFW, O_LPDF, O_IMPL, O_COS, O_PICK,
  O_SLEN, O_NX, O_NY, O_NZ, O_KX, O_KY, O_KZ, N_FOUT
};
// the int32 rows, the flag rows
enum IOut { O_PLEN, O_PIX, N_IOUT };
enum BOut { O_SPEC, O_PEND, O_ALIVE, O_SING, N_BOUT };
// the ints passed by value
enum Int {
  I_N, I_S, I_FLAGS, I_TYPES, I_WIDTH, I_HEIGHT, I_PK, I_PTRUE, I_NPIX,
  I_BASE, I_RING, I_ENV_W, I_ENV_H, I_FRAMES_M, I_G0, N_INT
};
// the floats passed by value: the Python numbers as torch rounds them
enum Flt {
  F_W1, F_H1, F_ASPECT, F_ENV_PROB, F_LIGHT_PROB, F_U_SCALE, F_V_SCALE,
  F_PI, F_TWO_PI, F_INV_2PI_PI, F_ONE_255, F_INV_16383, N_FLT
};
// I_FLAGS
constexpr int EXPL = 1 << 0;        // NEE on
constexpr int ENV = 1 << 1;         // NEE samples the env map
constexpr int ENV_FAST = 1 << 2;    // on its single-read route
constexpr int LIGHT = 1 << 3;       // NEE samples the area light
constexpr int TEX_KD = 1 << 4;      // fetch the Kd maps
constexpr int TEX_KS = 1 << 5;      // fetch the Ks maps
constexpr int TEX_N = 1 << 6;       // normal mapping
constexpr int DENOISE = 1 << 7;     // write the guide features' inputs
constexpr int BLOCK = 1 << 8;       // the block ring

constexpr float NEE_EPS = static_cast<float>(1e-3);
constexpr float LEN_SCALE = static_cast<float>(0.995);
constexpr float GAMMA = static_cast<float>(2.2);
constexpr float LUM_R = static_cast<float>(0.212671);
constexpr float LUM_G = static_cast<float>(0.715160);
constexpr float LUM_B = static_cast<float>(0.072169);

struct Args {
  const float* f[N_FIN];
  const int* i[N_IIN];
  const unsigned char* term;
  const long long* seed;
  const int* curr;
  const void* tab[N_TAB];
  const float* par[N_PAR];
  float* fo[N_FOUT];
  int* io[N_IOUT];
  unsigned char* bo[N_BOUT];
  long long* seed_out;
  int* ring_out;          // [2, G]: the cursors, the terminated counts
  int v[N_INT];
  float x[N_FLT];
};

// torch's integer floor division and remainder (Python's)
__device__ __forceinline__ int py_mod(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
__device__ __forceinline__ int py_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float ldf(const Args& a, int c, int i) {
  return __ldcs(a.f[c] + i);
}
__device__ __forceinline__ V3 ldf3(const Args& a, int c, int i) {
  return V3{ldf(a, c, i), ldf(a, c + 1, i), ldf(a, c + 2, i)};
}
__device__ __forceinline__ float par(const Args& a, int c) {
  return __ldg(a.par[c]);
}
__device__ __forceinline__ V3 par3(const Args& a, int c) {
  return V3{par(a, c), par(a, c + 1), par(a, c + 2)};
}
__device__ __forceinline__ void stf(const Args& a, int c, int i, float v) {
  __stcs(a.fo[c] + i, v);
}
__device__ __forceinline__ void stf3(const Args& a, int c, int i, V3 v) {
  stf(a, c, i, v.x);
  stf(a, c + 1, i, v.y);
  stf(a, c + 2, i, v.z);
}
__device__ __forceinline__ V3 mul3(V3 a, V3 b) {
  return V3{a.x * b.x, a.y * b.y, a.z * b.z};
}

// texture_fetch._fetch_texel: nearest texel with wrap addressing, clamped
// to the texture's rectangle, unpacked to [0, 1]
__device__ __forceinline__ V3 fetch_texel(const Args& a, int off, int w,
                                          int h, float u, float v) {
  const int ws = w > 1 ? w : 1;
  const int hs = h > 1 ? h : 1;
  const int x = static_cast<int>(floorf(u * static_cast<float>(w)));
  const int y = static_cast<int>(floorf(v * static_cast<float>(h)));
  const int tx = min(py_mod(x, ws), w - 1);
  const int ty = min(py_mod(y, hs), h - 1);
  const int t = __ldg(static_cast<const int*>(a.tab[TEXELS]) + off +
                      ty * w + tx);
  const float s = a.x[F_ONE_255];
  return V3{static_cast<float>(t & 0xFF) * s,
            static_cast<float>((t >> 8) & 0xFF) * s,
            static_cast<float>((t >> 16) & 0xFF) * s};
}

// a lane's map ``map`` (>= 0): its descriptors baked by the resolve (the
// streams at ``meta``) or gathered from the atlas
__device__ __forceinline__ V3 fetch_map(const Args& a, int i, int map,
                                        int meta, float u, float v) {
  int off, w, h;
  if (a.i[meta] != nullptr) {
    off = __ldcs(a.i[meta] + i);
    w = __ldcs(a.i[meta + 1] + i);
    h = __ldcs(a.i[meta + 2] + i);
  } else {
    off = __ldg(static_cast<const int*>(a.tab[T_OFF]) + map);
    w = __ldg(static_cast<const int*>(a.tab[T_W]) + map);
    h = __ldg(static_cast<const int*>(a.tab[T_H]) + map);
  }
  return fetch_texel(a, off, w, h, u, v);
}

// trace.tangent_space_normal on a lane with a normal map and a hit
__device__ __forceinline__ V3 mapped_normal(const Args& a, int i, int map_n,
                                            int tri, V3 hn, float u,
                                            float v) {
  V3 tn = fetch_map(a, i, map_n, N_OFF, u, v);
  tn = V3{tn.x + tn.x - 1.0f, tn.y + tn.y - 1.0f, tn.z + tn.z - 1.0f};
  const float* fr = static_cast<const float*>(a.tab[FRAMES]);
  const int m = a.v[I_FRAMES_M];
  float f[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) f[k] = __ldg(fr + k * m + tri);
  const V3 e1{f[0], f[1], f[2]}, e2{f[3], f[4], f[5]};
  const float t1u = f[8] - f[6], t1v = f[9] - f[7];
  const float t2u = f[10] - f[6], t2v = f[11] - f[7];
  const float det = t1u * t2v - t1v * t2u;
  if (det == 0.0f) return hn;
  const float inv_det = (1.0f / det) * 1.0f;
  const V3 tang = normalize(V3{(e1.x * t2v - e2.x * t1v) * inv_det,
                               (e1.y * t2v - e2.y * t1v) * inv_det,
                               (e1.z * t2v - e2.z * t1v) * inv_det});
  const V3 bit = normalize(V3{(e2.x * t1u - e1.x * t2u) * inv_det,
                              (e2.y * t1u - e1.y * t2u) * inv_det,
                              (e2.z * t1u - e1.z * t2u) * inv_det});
  return normalize(V3{tang.x * tn.x + bit.x * tn.y + hn.x * tn.z,
                      tang.y * tn.x + bit.y * tn.y + hn.y * tn.z,
                      tang.z * tn.x + bit.z * tn.y + hn.z * tn.z});
}

// envmap: RGBE word to linear RGB, luminance, the pdf from it
__device__ __forceinline__ V3 decode_rgbe(int t) {
  const float e = static_cast<float>((t >> 24) & 0xFF);
  const float f = e > 0.0f ? exp2f(e - 136.0f) : 0.0f;
  return V3{static_cast<float>(t & 0xFF) * f,
            static_cast<float>((t >> 8) & 0xFF) * f,
            static_cast<float>((t >> 16) & 0xFF) * f};
}
__device__ __forceinline__ float lum(V3 c) {
  return c.x * LUM_R + c.y * LUM_G + c.z * LUM_B;
}

// envmap.eval_env_map_dir: the bilinear lookup along d
__device__ __forceinline__ V3 env_bilinear(const Args& a, V3 d) {
  const int w = a.v[I_ENV_W], h = a.v[I_ENV_H];
  const float u = atan2f(d.x, -d.z) * a.x[F_U_SCALE] + 0.5f;
  const float v = acosf(clamp(d.y, -1.0f, 1.0f)) * a.x[F_V_SCALE];
  const float fx = u * static_cast<float>(w) - 0.5f;
  const float fy = v * static_cast<float>(h) - 0.5f;
  const float x0 = floorf(fx), y0 = floorf(fy);
  const float tx = fx - x0, ty = fy - y0;
  const int x0i = clampi(static_cast<int>(x0), 0, w - 1);
  const int x1i = clampi(x0i + 1, 0, w - 1);
  const int y0i = clampi(static_cast<int>(y0), 0, h - 1);
  const int y1i = clampi(y0i + 1, 0, h - 1);
  V3 c[4];
  const int idx[4] = {y0i * w + x0i, y0i * w + x1i, y1i * w + x0i,
                      y1i * w + x1i};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    c[k] = V3{__ldg(static_cast<const float*>(a.tab[ENV_IX]) + idx[k]),
              __ldg(static_cast<const float*>(a.tab[ENV_IY]) + idx[k]),
              __ldg(static_cast<const float*>(a.tab[ENV_IZ]) + idx[k])};
  const float sx = 1.0f - tx, sy = 1.0f - ty;
  const V3 top = c[0] * sx + c[1] * tx;
  const V3 bot = c[2] * sx + c[3] * tx;
  return top * sy + bot * ty;
}

// envmap.env_sample: the alias sample of u, its direction L, pdf and
// radiance; on the single-read route from the packed pair and the RGBE
// word, else from the tables and the bilinear lookup
__device__ __forceinline__ void env_sample(const Args& a, float u, V3& L,
                                           float& pdf, V3& li) {
  const int w = a.v[I_ENV_W], h = a.v[I_ENV_H];
  const int wh = w * h;
  const float r = u * static_cast<float>(wh);
  const int i = min(static_cast<int>(floorf(r)), wh - 1);
  const bool fast = a.v[I_FLAGS] & ENV_FAST;
  float m_prob;
  int alias;
  if (fast) {
    const int pa = __ldg(static_cast<const int*>(a.tab[ENV_PA]) + i);
    m_prob = static_cast<float>((pa >> 18) & 0x3FFF) * a.x[F_INV_16383];
    alias = pa & 0x3FFFF;
  } else {
    m_prob = __ldg(static_cast<const float*>(a.tab[ENV_PROB]) + i);
    alias = __ldg(static_cast<const int*>(a.tab[ENV_ALIAS]) + i);
  }
  const int uv = r - static_cast<float>(i) < m_prob ? i : alias;
  // _cell_direction and uv_to_direction
  const float cu = (static_cast<float>(py_mod(uv, w)) + 0.5f) *
                   (1.0f / static_cast<float>(w));
  const float cv = (static_cast<float>(uv) + 0.5f) *
                   (1.0f / static_cast<float>(wh));
  const float phi = cv * a.x[F_PI];
  const float theta = cu * a.x[F_TWO_PI] - a.x[F_PI];
  const float sin_phi = sinf(phi);
  const float cos_phi = cosf(phi);
  L = V3{sin_phi * sinf(theta), cos_phi, -sin_phi * cosf(theta)};
  float p;
  if (fast) {
    li = decode_rgbe(__ldg(static_cast<const int*>(a.tab[ENV_PACKED]) + uv));
    const int iv = py_div(uv, w);
    const float sin_row = sinf((static_cast<float>(iv) + 0.5f) * a.x[F_PI] *
                               (1.0f / static_cast<float>(h)));
    p = lum(li) * sin_row *
        __ldg(static_cast<const float*>(a.tab[ENV_INV_MEAN])) *
        a.x[F_INV_2PI_PI];
  } else {
    p = __ldg(static_cast<const float*>(a.tab[ENV_PDF]) + uv);
    li = env_bilinear(a, L);
  }
  pdf = sin_phi != 0.0f ? p / clamp_min(sin_phi, TINY) : 0.0f;
}

// The exclusive rank of this thread's flag ``p`` among the CTA's flags in
// thread order, and their count in ``total``. Every thread of the CTA
// calls it.
__device__ __forceinline__ int tile_scan(bool p, int& total, int* warp_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(FULL_MASK, p);
  const int below = __popc(m & ((1u << lane) - 1u));
  if (lane == 0) warp_sum[warp] = __popc(m);
  __syncthreads();
  int before = 0;
  total = 0;
  const int warps = (blockDim.x + 31) >> 5;
  for (int w = 0; w < warps; ++w) {
    const int c = warp_sum[w];
    before += w < warp ? c : 0;
    total += c;
  }
  __syncthreads();
  return before + below;
}

// One lane: the three sections and the merge. ``g`` the lane's group
// (the block ring), ``rank`` its rank among the terminated lanes before
// it in the group (the flat ring: in the pool).
__device__ void surface_lane(const Args& a, int i, bool term, int rank,
                             int g) {
  const int flags = a.v[I_FLAGS];
  const bool alive = !term;
  unsigned long long seed = static_cast<unsigned long long>(
      __ldcs(a.seed + i));
  const V3 T = ldf3(a, TX, i);
  const V3 dir = ldf3(a, DX, i);
  V3 ei = ldf3(a, EIX, i);
  V3 so = ldf3(a, SOX, i), sd = ldf3(a, SDX, i);
  float slen = ldf(a, SLEN, i), lpdf = ldf(a, LPDF, i);
  float lcos = ldf(a, LCOS, i), lpick = ldf(a, LPICK, i);
  V3 lem = ldf3(a, LEX, i);
  const int type = __ldcs(a.i[TYPE] + i);
  const bool singular = (type & (IDEAL_REFLECTION | IDEAL_DIELECTRIC)) != 0;
  bool pending = false;
  Shade sh{};
  V3 nrm = splat3(0.0f), kd = splat3(0.0f);

  if (alive) {
    // ---- .surface: textures, emission, the shading normal
    const V3 P = ldf3(a, PX, i);
    const V3 hn = ldf3(a, HNX, i);
    const float u = ldf(a, UVU, i), v = ldf(a, UVV, i);
    const int tri = __ldcs(a.i[HIT_I] + i);
    kd = ldf3(a, KDX, i);
    V3 ks = ldf3(a, KSX, i);
    const V3 ke = ldf3(a, KEX, i);
    if (flags & TEX_KD) {
      const int map = __ldcs(a.i[MAP_KD] + i);
      if (map >= 0) {
        const V3 c = fetch_map(a, i, map, KD_OFF, u, v);
        kd = V3{powf(clamp_min(c.x, 0.0f), GAMMA),
                powf(clamp_min(c.y, 0.0f), GAMMA),
                powf(clamp_min(c.z, 0.0f), GAMMA)};
      }
    }
    if (flags & TEX_KS) {
      const int map = __ldcs(a.i[MAP_KS] + i);
      if (map >= 0) ks = fetch_map(a, i, map, KS_OFF, u, v);
    }
    // implicit triangle emission (alive lanes have a hit)
    if (type == EMISSIVE) ei = ei + mul3(T, ke);
    nrm = hn;
    if (flags & TEX_N) {
      const int map_n = __ldcs(a.i[MAP_N] + i);
      if (map_n >= 0) nrm = mapped_normal(a, i, map_n, tri, hn, u, v);
    }
    const bool back = dot(nrm, dir) > 0.0f;
    nrm = back ? -nrm : nrm;
    const V3 nee_orig = P - dir * NEE_EPS;

    // ---- NEE: the pick, the env map's sample, the light's
    if (flags & EXPL) {
      const bool do_nee = !singular;
      const float u_pick = uniform(seed);
      const bool pick_env = u_pick < a.x[F_ENV_PROB];
      if (flags & ENV) {
        const float u_env = uniform(seed);
        V3 L, li;
        float pdf;
        env_sample(a, u_env, L, pdf, li);
        if (do_nee && pick_env) {
          so = nee_orig;
          sd = L;
          slen = par(a, WORLD_R) * 2.0f;
          lpdf = pdf;
          lcos = clamp_min(dot(L, nrm), 0.0f);
          lpick = a.x[F_ENV_PROB];
          lem = li * par(a, ENV_STRENGTH);
          pending = true;
        }
      }
      if (flags & LIGHT) {
        const float r1 = uniform(seed);
        const float r2 = uniform(seed);
        const float sx = par(a, LSX), sy = par(a, LSY);
        const float pdf_a = (1.0f / (sx * 4.0f * sy)) * 1.0f;
        const V3 pos_l = par3(a, LPX) +
                         par3(a, LRX) * ((r1 + r1 - 1.0f) * sx) +
                         par3(a, LUX) * ((r2 + r2 - 1.0f) * sy);
        const V3 lv = pos_l - nee_orig;
        const float len0 = sqrtf(dot(lv, lv));
        const float inv_len = (1.0f / clamp_min(len0, TINY)) * 1.0f;
        const V3 ln = lv * inv_len;
        const float cos_light = clamp_min(dot(par3(a, LNX), -lv), 0.0f);
        if (do_nee && !pick_env && cos_light > 0.0f) {
          const float len_l = len0 * LEN_SCALE;
          so = nee_orig;
          sd = ln;
          slen = len_l;
          lpdf = pdf_a * (len_l * len_l) / fabsf(cos_light * inv_len);
          lcos = clamp_min(dot(ln, nrm), 0.0f);
          lpick = a.x[F_LIGHT_PROB];
          lem = par3(a, LEX_);
          pending = true;
        }
      }
    }

    // ---- .material: the BSDF work
    sh = shade_lane(nrm, kd, ks, ke, ldf(a, ALPHA, i), ldf(a, NI, i), type,
                    back, dir, sd, seed, T, P, a.v[I_TYPES]);
  } else {
    // a terminated lane draws what an alive one does and shades nothing
    int draws = 3;
    if (flags & EXPL)
      draws += 1 + ((flags & ENV) ? 1 : 0) + ((flags & LIGHT) ? 2 : 0);
    for (int k = 0; k < draws; ++k) uniform(seed);
  }

  // ---- .raygen: the ring's next pixel, the camera ray of every lane
  int pix = __ldcs(a.i[PIX] + i);
  if (term) {
    if (flags & BLOCK) {
      const int p_true = a.v[I_PTRUE];
      const int len_g = clampi(
          a.v[I_NPIX] - (a.v[I_G0] + g) * p_true, 1, p_true);
      pix = a.v[I_BASE] + g * a.v[I_PK] +
            py_mod(__ldg(a.curr + g) + rank, len_g);
    } else {
      pix = a.v[I_BASE] + py_mod(__ldg(a.curr) + rank, a.v[I_RING]);
    }
  }
  const int pid = (flags & BLOCK)
                      ? py_div(pix, a.v[I_PK]) * a.v[I_PTRUE] +
                            py_mod(pix, a.v[I_PK])
                      : pix;
  // camera.generate_camera_rays
  const float w1 = a.x[F_W1], h1 = a.x[F_H1];
  float x = static_cast<float>(py_mod(pid, a.v[I_WIDTH]));
  float y = static_cast<float>(pid) * w1;
  const float u1 = uniform(seed);
  const float u2 = uniform(seed);
  x = x + u1;
  y = y + u2;
  const float ndc_x = x * w1, ndc_y = y * h1;
  float scr_x = ndc_x + ndc_x - 1.0f;
  float scr_y = ndc_y + ndc_y - 1.0f;
  const float fov = par(a, FOV_SCALE);
  scr_x = scr_x * a.x[F_ASPECT] * fov;
  scr_y = scr_y * fov;
  const V3 c_pos = par3(a, CPX), c_right = par3(a, CRX),
           c_up = par3(a, CUX);
  const V3 target = c_pos + c_right * scr_x + c_up * scr_y + par3(a, CDX);
  V3 c_dir = normalize(target - c_pos);
  V3 c_orig = c_pos;
  const float aperture = par(a, APERTURE);
  if (aperture > 0.0f) {
    const float d1 = uniform(seed);
    const float d2 = uniform(seed);
    const float sqrt_r = sqrtf(d1);
    const float th = d2 * TWO_PI_F;
    const float rx = sqrt_r * cosf(th), ry = sqrt_r * sinf(th);
    const V3 fp = c_pos + c_dir * par(a, FOCAL);
    c_orig = c_pos + (c_right * rx + c_up * ry) * (par(a, WORLD_R) * aperture);
    c_dir = normalize(fp - c_orig);
  }

  // ---- the merge: terminated lanes start a camera path
  stf3(a, O_OX, i, term ? c_orig : sh.orig);
  stf3(a, O_DX, i, term ? c_dir : sh.d);
  stf3(a, O_SOX, i, so);
  stf3(a, O_SDX, i, sd);
  stf3(a, O_TX, i, term ? splat3(1.0f) : sh.T);
  stf3(a, O_EX, i, term ? splat3(0.0f) : ei);
  stf3(a, O_BX, i, term ? splat3(0.0f) : sh.ev);
  stf3(a, O_LEX, i, term ? splat3(0.0f) : lem);
  stf3(a, O_LTX, i, term ? splat3(0.0f) : T);
  stf(a, O_PDFW, i, term ? 1.0f : sh.pdf);
  stf(a, O_LPDF, i, term ? 0.0f : lpdf);
  stf(a, O_IMPL, i, term ? 0.0f : sh.epdf);
  stf(a, O_COS, i, term ? 0.0f : lcos);
  stf(a, O_PICK, i, term ? 1.0f : lpick);
  stf(a, O_SLEN, i, slen);
  __stcs(a.io[O_PLEN] + i, term ? 0 : __ldcs(a.i[PLEN] + i));
  __stcs(a.io[O_PIX] + i, pix);
  __stcs(a.seed_out + i, static_cast<long long>(seed));
  __stcs(a.bo[O_SPEC] + i, static_cast<unsigned char>(term || singular));
  __stcs(a.bo[O_PEND] + i, static_cast<unsigned char>(pending));
  if (flags & DENOISE) {
    stf3(a, O_NX, i, nrm);
    stf3(a, O_KX, i, kd);
    __stcs(a.bo[O_ALIVE] + i, static_cast<unsigned char>(alive));
    __stcs(a.bo[O_SING] + i, static_cast<unsigned char>(singular));
  }
}

}  // namespace

// At global scope, as the other kernels, so that profilers name it
// surface_shade_kernel. The block ring: CTA g walks group g's S lanes in
// tiles of blockDim.x with the scan's carry, then writes the group's
// cursor and count. The flat ring: CTA b takes lanes [b B, (b + 1) B).
__global__ void __launch_bounds__(THREADS) surface_shade_kernel(const Args a) {
  __shared__ int warp_sum[THREADS / 32];
  const int g = blockIdx.x;
  const int b = blockDim.x;
  if (!(a.v[I_FLAGS] & BLOCK)) {
    const int i = g * b + threadIdx.x;
    if (i < a.v[I_N])
      surface_lane(a, i, __ldcs(a.term + i) != 0, __ldcs(a.i[RANK] + i), 0);
    return;
  }
  const int s = a.v[I_S];
  int carry = 0;
  for (int k0 = 0; k0 < s; k0 += b) {
    const int k = k0 + threadIdx.x;
    const int i = g * s + k;
    const bool in = k < s;
    const bool term = in && __ldcs(a.term + i) != 0;
    int total;
    const int rank = carry + tile_scan(term, total, warp_sum);
    carry += total;
    if (in) surface_lane(a, i, term, rank, g);
  }
  if (threadIdx.x == 0) {
    const int p_true = a.v[I_PTRUE];
    const int len_g = clampi(a.v[I_NPIX] - (a.v[I_G0] + g) * p_true, 1,
                             p_true);
    a.ring_out[g] = py_mod(a.curr[g] + carry, len_g);
    a.ring_out[gridDim.x + g] = carry;
  }
}

// ptrs: N_FIN float streams, N_IIN int streams (null where absent), the
// terminate flags, the seeds, the cursors, N_TAB tables, N_PAR parameters,
// N_FOUT float rows, N_IOUT int rows, N_BOUT flag rows, the seeds out and
// the ring's [2, G] (surface_shade's order); ints and floats by value, in
// the order of Int and Flt. ``groups`` the CTAs of the block ring (0: the
// flat ring).
extern "C" int surface_shade_launch(void* const* ptrs, const int* ints,
                                    const float* floats, int groups,
                                    void* stream) {
  Args a;
  int k = 0;
  for (int c = 0; c < N_FIN; ++c)
    a.f[c] = static_cast<const float*>(ptrs[k++]);
  for (int c = 0; c < N_IIN; ++c)
    a.i[c] = static_cast<const int*>(ptrs[k++]);
  a.term = static_cast<const unsigned char*>(ptrs[k++]);
  a.seed = static_cast<const long long*>(ptrs[k++]);
  a.curr = static_cast<const int*>(ptrs[k++]);
  for (int c = 0; c < N_TAB; ++c) a.tab[c] = ptrs[k++];
  for (int c = 0; c < N_PAR; ++c)
    a.par[c] = static_cast<const float*>(ptrs[k++]);
  for (int c = 0; c < N_FOUT; ++c) a.fo[c] = static_cast<float*>(ptrs[k++]);
  for (int c = 0; c < N_IOUT; ++c) a.io[c] = static_cast<int*>(ptrs[k++]);
  for (int c = 0; c < N_BOUT; ++c)
    a.bo[c] = static_cast<unsigned char*>(ptrs[k++]);
  a.seed_out = static_cast<long long*>(ptrs[k++]);
  a.ring_out = static_cast<int*>(ptrs[k++]);
  for (int c = 0; c < N_INT; ++c) a.v[c] = ints[c];
  for (int c = 0; c < N_FLT; ++c) a.x[c] = floats[c];
  const int n = a.v[I_N];
  if (n == 0) return 0;
  int blocks, threads;
  if (groups > 0) {
    const int s = a.v[I_S];
    blocks = groups;
    threads = s < THREADS ? ((s + 31) / 32) * 32 : THREADS;
  } else {
    blocks = (n + THREADS - 1) / THREADS;
    threads = THREADS;
  }
  surface_shade_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING
