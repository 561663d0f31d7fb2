// Whole eval render level for the H100: IPE + NerfMLP + alpha compositing
// + expectations + per-sample density-gradient normals, per ray tile.
//
// Replaces the TPU kernel `fused_render_level` (`_render_kernel`) in
// pano_nerf_tpu/kernels/fused_render.py:128-304. Same function, same
// per-ray output slab: [rgb(3) | acc | distance | albedo(3) | roughness |
// normal(3) | ort | 0(4) | weights(S)], f32.
//
// What bounds it on an H100: tensor-core operations. One sample row costs
// 611,328 MACs of MLP (1.22 MFLOP) plus 507,904 MACs (1.02 MFLOP) of the
// normal chain on the fine level, against 32 B of input moments; the
// bf16 weights (1.23 MB) are read by every block but stay L2-resident.
// At 989 TFLOP/s dense bf16 a 128x256 panorama (32,768 rays x (56 + 56 +
// 50) rows) needs >= 8.5 ms; its inputs move in ~0.05 ms at 3.35 TB/s.
//
// Design (first, simple version):
// * One block of 256 threads per tile of <= 64 sample rows: one ray at
//   S=56, floor(64/S) rays at S=5. Rows beyond the tile's rays are zeroed
//   at the source and never enter a reduction.
// * Activations stay in shared memory as bf16 [64 x (256 | 96)]: columns
//   256..351 hold the IPE features, so the skip layer reads [h4 | x] as
//   one K=352 operand. Products go through WMMA 16x16x16 bf16 fragments
//   with f32 accumulate; each warp owns 16-wide output column tiles over
//   all 64 rows and reads the weight fragment straight from global
//   memory (L2). Accumulators land in an f32 staging tile; the epilogue
//   adds the f32 bias, applies ReLU, rounds to bf16 and records the ReLU
//   mask as bits for the normal chain (8 x 64 x 256 bits).
// * IPE phases are exact power-of-two products (ldexpf) and use the
//   accurate sinf/expf: the phases reach ~1e5, so fast-math intrinsics
//   would garble the high degrees. Do not build with --use_fast_math.
// * Compositing is a sequential f32 scan over S by one thread per ray.
// * The normal chain walks the trunk backwards with the saved masks,
//   sz_i = mask_i * s (bf16), s = sz_i @ W_i, then folds d raw_sigma /
//   d features back to the means through the closed-form IPE Jacobian.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// point (pano_nerf_tpu_torch/kernels/build.py); wgmma/TMA come later.

#include "nerf_mlp.cuh"

namespace {

using namespace nerf_mlp;

constexpr int VF = 27;   // viewdir encoding: identity + 4 degrees x 3 x 2
constexpr int OUT_FIXED = 17;

// Per-row scalars (f32 [NROW][TM]).
enum {
  R_DELTA, R_TMID, R_DD, R_W, R_RGB, R_ALB = R_RGB + 3, R_ROUGH = R_ALB + 3,
  R_SIG, R_N = R_SIG + 1, R_ORT = R_N + 3, NROW
};

struct Smem {
  bf16 act[TM * ACT_LD];
  float stage[TM * ST_LD];
  float x32[TM * XF];
  uint32_t mask[8 * TM * MASK_WORDS];
  float row[NROW * TM];
  float ray[TM * 8];
  float acc[TM];
};

struct Params {
  const float* mc;       // [R*S, 8]: means | covs | delta | t_mid
  const float* rayinfo;  // [R, 8]: viewdir | t_0 | t_S | dir
  const bf16* w;
  const float* b;
  float* out;            // [R, 17 + S]
  int R, S, rpb, min_deg;
  float density_bias, rgb_padding;
  int white_bkgd, need_normals, need_extras;
};

__global__ void __launch_bounds__(NT, 1) fused_render_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int S = p.S;
  const int ray0 = blockIdx.x * p.rpb;
  const int nrays = min(p.rpb, p.R - ray0);
  const int nrows = nrays * S;
  const size_t row0 = (size_t)ray0 * S;
  float* rowf = s.row;

  // ---- inputs: per-ray info and per-row moments (zero past the tile) ----
  for (int i = tid; i < TM * 8; i += NT) {
    const int q = i >> 3;
    s.ray[i] = q < nrays ? p.rayinfo[(size_t)(ray0 + q) * 8 + (i & 7)] : 0.f;
    const int r = i >> 3;
    s.stage[i] = r < nrows ? p.mc[(row0 + r) * 8 + (i & 7)] : 0.f;
  }
  __syncthreads();
  for (int r = tid; r < TM; r += NT) {
    rowf[R_DELTA * TM + r] = s.stage[r * 8 + 6];
    rowf[R_TMID * TM + r] = s.stage[r * 8 + 7];
  }
  // Integrated positional encoding: feature j is degree-major then dim,
  // sin block then cos block (cos(y) = sin(y + pi/2)).
  for (int i = tid; i < TM * XF; i += NT) {
    const int r = i / XF, j = i % XF;
    const int jj = j % XP;
    const int deg = jj / 3 + p.min_deg, dim = jj % 3;
    float y = s.stage[r * 8 + dim] * ldexpf(1.f, deg);
    if (j >= XP) y = y + 1.57079632679489662f;
    const float var = s.stage[r * 8 + 3 + dim] * ldexpf(1.f, 2 * deg);
    const float f = expf(-0.5f * var) * sinf(y);
    s.x32[r * XF + j] = f;
    s.act[r * ACT_LD + W + j] = __float2bfloat16(f);
  }
  __syncthreads();

  // ---- trunk: 8 x (Linear + ReLU), skip input [h4 | x] into layer 5 ----
  for (int layer = 0; layer < 8; ++layer) {
    const bf16* A = layer == 0 ? s.act + W : s.act;
    const int K = trunk_in(layer);
    tile_matmul<wmma::col_major>(A, ACT_LD, K, p.w + trunk_offset(layer), K,
                                 W, s.stage, ST_LD);
    __syncthreads();
    const float* bias = p.b + OFF_BT + layer * W;
    for (int i = tid; i < TM * W; i += NT) {
      const int r = i / W, c = i % W;  // a warp covers 32 columns of a row
      const bf16 h = __float2bfloat16(fmaxf(s.stage[r * ST_LD + c] + bias[c], 0.f));
      s.act[r * ACT_LD + c] = h;
      const unsigned bits = __ballot_sync(0xffffffffu, __bfloat162float(h) > 0.f);
      if (lane == 0) s.mask[(layer * TM + r) * MASK_WORDS + (c >> 5)] = bits;
    }
    __syncthreads();
  }

  // ---- heads: density (cols 256..271 of the stage) and bottleneck ----
  tile_matmul<wmma::col_major>(s.act, ACT_LD, W, p.w + OFF_WD, W, HP,
                               s.stage + W, ST_LD);
  tile_matmul<wmma::col_major>(s.act, ACT_LD, W, p.w + OFF_WB, W, W, s.stage,
                               ST_LD);
  __syncthreads();
  for (int i = tid; i < TM * W; i += NT) {
    const int r = i / W, c = i % W;
    s.act[r * ACT_LD + c] = __float2bfloat16(s.stage[r * ST_LD + c] + p.b[OFF_BB + c]);
  }
  // Viewdir encoding [d | sin(2^k d) | cos(2^k d)], k = 0..3, zero rows past
  // the tile, zero pad columns 27..31.
  for (int i = tid; i < TM * 32; i += NT) {
    const int r = i >> 5, j = i & 31;
    float v = 0.f;
    if (r < nrows && j < VF) {
      const float* d = s.ray + (r / S) * 8;
      if (j < 3) {
        v = d[j];
      } else {
        const int jj = (j - 3) % 12;
        float arg = d[jj % 3] * ldexpf(1.f, jj / 3);
        if (j >= 15) arg = arg + 1.57079632679489662f;
        v = sinf(arg);
      }
    }
    s.act[r * ACT_LD + W + j] = __float2bfloat16(v);
  }
  __syncthreads();
  // Raw density channels (+ bias) per row, kept in the stage's spare
  // columns 272..276 while the view branch reuses 0..127.
  for (int i = tid; i < TM * NDC; i += NT) {
    const int r = i / NDC, c = i % NDC;
    s.stage[r * ST_LD + W + HP + c] = s.stage[r * ST_LD + W + c] + p.b[OFF_BD + c];
  }
  __syncthreads();

  // ---- view branch (Linear + ReLU) and color head ----
  tile_matmul<wmma::col_major>(s.act, ACT_LD, VK, p.w + OFF_WV, VK, VW,
                               s.stage, ST_LD);
  __syncthreads();
  for (int i = tid; i < TM * VW; i += NT) {
    const int r = i / VW, c = i % VW;
    s.act[r * ACT_LD + c] =
        __float2bfloat16(fmaxf(s.stage[r * ST_LD + c] + p.b[OFF_BV + c], 0.f));
  }
  __syncthreads();
  tile_matmul<wmma::col_major>(s.act, ACT_LD, VW, p.w + OFF_WC, VW, HP,
                               s.stage, ST_LD);
  __syncthreads();

  // ---- per-sample activations ----
  for (int r = tid; r < TM; r += NT) {
    const float* st = s.stage + r * ST_LD;
    const float* dens = st + W + HP;
    rowf[R_DD * TM + r] = softplusf(dens[0] + p.density_bias) * rowf[R_DELTA * TM + r];
    rowf[R_SIG * TM + r] = dens[0];
    for (int k = 0; k < 3; ++k) {
      const float raw = st[k] + p.b[OFF_BC + k];
      rowf[(R_RGB + k) * TM + r] =
          softplusf(raw) * (1.f + 2.f * p.rgb_padding) - p.rgb_padding;
      rowf[(R_ALB + k) * TM + r] = sigmoidf(dens[1 + k]) * 0.77f + 0.03f;
    }
    rowf[R_ROUGH * TM + r] = softplusf(dens[4] - 1.f);
  }
  __syncthreads();

  // ---- compositing: one thread per ray, sequential over samples ----
  const int out_w = OUT_FIXED + S;
  for (int q = tid; q < nrays; q += NT) {
    float tau = 0.f, acc = 0.f, dist = 0.f, rough = 0.f;
    float rgb[3] = {0.f, 0.f, 0.f}, alb[3] = {0.f, 0.f, 0.f};
    float* o = p.out + (size_t)(ray0 + q) * out_w;
    for (int k = 0; k < S; ++k) {
      const int r = q * S + k;
      const float dd = rowf[R_DD * TM + r];
      const float w = (1.f - expf(-dd)) * expf(-tau);
      tau += dd;
      rowf[R_W * TM + r] = w;
      o[OUT_FIXED + k] = w;
      acc += w;
      dist += w * rowf[R_TMID * TM + r];
      rough += w * rowf[R_ROUGH * TM + r];
      for (int c = 0; c < 3; ++c) {
        rgb[c] += w * rowf[(R_RGB + c) * TM + r];
        alb[c] += w * rowf[(R_ALB + c) * TM + r];
      }
    }
    const float* ri = s.ray + q * 8;
    for (int c = 0; c < 3; ++c) o[c] = p.white_bkgd ? rgb[c] + (1.f - acc) : rgb[c];
    o[3] = acc;
    o[4] = fminf(fmaxf(dist / fmaxf(acc, 1e-10f), ri[3]), ri[4]);
    const float inv = 1.f / fmaxf(acc, 1e-12f);
    for (int c = 0; c < 3; ++c) o[5 + c] = p.need_extras ? alb[c] * inv : 0.f;
    o[8] = p.need_extras ? rough * inv : 0.f;
    for (int c = 9; c < OUT_FIXED; ++c) o[c] = 0.f;
    s.acc[q] = acc;
  }
  if (!p.need_normals) return;  // uniform across the block
  __syncthreads();

  // ---- normals: d raw_sigma / d means through the masked trunk ----
  // sz_7 = mask_7 * (density kernel's sigma row).
  for (int i = tid; i < TM * W; i += NT) {
    const int r = i / W, c = i % W;
    const bool on = (s.mask[(7 * TM + r) * MASK_WORDS + (c >> 5)] >> (c & 31)) & 1u;
    s.act[r * ACT_LD + c] = on ? p.w[OFF_WD + c] : __float2bfloat16(0.f);
  }
  __syncthreads();
  for (int layer = 7; layer >= 0; --layer) {
    const int K = trunk_in(layer);
    // [64 x 256] @ W_layer [256 x K]: layer 5's columns 256..351 are the
    // skip gradient, left in the stage for layer 0 (later layers write
    // only columns < 256).
    tile_matmul<wmma::row_major>(s.act, ACT_LD, W, p.w + trunk_offset(layer), K,
                                 K, s.stage, ST_LD);
    __syncthreads();
    if (layer == 0) break;
    for (int i = tid; i < TM * W; i += NT) {
      const int r = i / W, c = i % W;
      const bool on =
          (s.mask[((layer - 1) * TM + r) * MASK_WORDS + (c >> 5)] >> (c & 31)) & 1u;
      s.act[r * ACT_LD + c] = on ? __float2bfloat16(s.stage[r * ST_LD + c])
                                 : __float2bfloat16(0.f);
    }
    __syncthreads();
  }
  // Fold through the IPE: d feat_sin / d mean = 2^deg att cos(y),
  // d feat_cos / d mean = -2^deg att sin(y); att*cos is the other half of
  // the features.
  for (int r = tid; r < TM; r += NT) {
    float g[3] = {0.f, 0.f, 0.f};
    for (int j = 0; j < XF; ++j) {
      const int jj = j % XP;
      const float gx = s.stage[r * ST_LD + j] + s.stage[r * ST_LD + W + j];
      const float ac = j < XP ? s.x32[r * XF + j + XP] : -s.x32[r * XF + j - XP];
      g[jj % 3] += gx * ac * ldexpf(1.f, jj / 3 + p.min_deg);
    }
    const float nrm = sqrtf(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]);
    const float inv = 1.f / fmaxf(nrm, 1e-12f);
    const float* d = s.ray + (r < nrows ? r / S : 0) * 8 + 5;
    float ndot = 0.f;
    for (int c = 0; c < 3; ++c) {
      const float n = -g[c] * inv;
      rowf[(R_N + c) * TM + r] = n;
      ndot += n * d[c];
    }
    const float o = fmaxf(ndot, 0.f);
    rowf[R_ORT * TM + r] = o * o;
  }
  __syncthreads();
  for (int q = tid; q < nrays; q += NT) {
    float n[3] = {0.f, 0.f, 0.f}, ort = 0.f;
    for (int k = 0; k < S; ++k) {
      const int r = q * S + k;
      const float w = rowf[R_W * TM + r];
      for (int c = 0; c < 3; ++c) n[c] += w * rowf[(R_N + c) * TM + r];
      ort += w * rowf[R_ORT * TM + r];
    }
    const float inv = 1.f / fmaxf(s.acc[q], 1e-12f);
    for (int c = 0; c < 3; ++c) n[c] *= inv;
    const float nn = 1.f / fmaxf(sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]), 1e-12f);
    float* o = p.out + (size_t)(ray0 + q) * out_w;
    for (int c = 0; c < 3; ++c) o[9 + c] = n[c] * nn;
    o[12] = ort * inv;
  }
}

}  // namespace

extern "C" {

int fused_render_weight_count() { return W_TOTAL; }
int fused_render_bias_count() { return B_TOTAL; }

const char* fused_render_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches one render level on `stream`; returns a cudaError_t (0 = ok).
int fused_render_level_launch(const float* mc, const float* rayinfo,
                              const void* weights, const float* biases,
                              float* out, int R, int S, int min_deg,
                              float density_bias, float rgb_padding,
                              int white_bkgd, int need_normals,
                              int need_extras, void* stream) {
  if (R <= 0 || S <= 0 || S > TM) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      fused_render_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.mc = mc;
  p.rayinfo = rayinfo;
  p.w = static_cast<const bf16*>(weights);
  p.b = biases;
  p.out = out;
  p.R = R;
  p.S = S;
  p.rpb = TM / S;
  p.min_deg = min_deg;
  p.density_bias = density_bias;
  p.rgb_padding = rgb_padding;
  p.white_bkgd = white_bkgd;
  p.need_normals = need_normals;
  p.need_extras = need_extras;
  const int grid = (R + p.rpb - 1) / p.rpb;
  fused_render_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
