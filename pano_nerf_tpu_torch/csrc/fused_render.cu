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
// normal chain on the fine level, against 32 B of input moments (at the
// shipped shape, W 256, VW 128, L 16; a build takes the MLP's shape as
// nerf_mlp.cuh's constants, the viewdir encoding's degree from VF). The
// bf16 weights stay in L2, but every tile streams them from L2 into
// shared memory once (1.31 MB of TMA boxes for the MLP, 1.05 MB more for
// the chain), so the rows that share one weight byte set the L2 traffic.
//
// Design (Hopper):
// * A tile is up to 128 sample rows of whole rays, floor(128 / S) rays
//   (2 at S = 56, 25 at S = 5); rows past the tile's rays load zero
//   moments and enter no reduction. The last tile may hold fewer rays.
// * Row split (mlp_rows.cuh): two consumer warpgroups each own a 64-row
//   activation tile in 128-byte-swizzled shared memory and compute all
//   output columns of every product with wgmma m64nNk16 (N up to 256, f32
//   accumulators in registers), so each weight slice in shared memory
//   feeds 128 rows, twice the rows of the training kernels' column split.
//   A producer warpgroup streams the weights by TMA (make_weight_maps,
//   32 KB slices of 64 K-rows x up to 256 columns) with mbarrier
//   completion, running the same tile program compiled as producer
//   (run_roles: setmaxnreg gives the consumers 240 registers and the
//   producer 24, which the 128 accumulators per thread need; at 232 they
//   spilled more and ran slower, and a 288-thread block with a producer
//   warp compiles to 168 registers for every thread and spilled far more).
// * Persistent: one block per SM walks the tiles (tile t, t + gridDim.x,
//   ...), so the ring stays primed across tiles and one tile's
//   compositing overlaps the next one's first weight loads.
// * The forward reuses the column-split steps in their row-split form:
//   load_ipe, trunk_forward, heads_forward (the viewdir codes are built
//   from each ray's direction as the heads ask for them) and, on the
//   fine level, density_chain, the chain kernel 3's forward runs too.
// * Shared memory (the budget decides the ring): activation tiles 2 x 48
//   KB, per-row and per-ray scalars ~25 KB, and on the fine level the ReLU
//   masks, 8 layers x 128 rows x W bits = 32 KB in fragment order (128
//   accumulators per thread leave no registers for them). So the kernel
//   comes in two layouts (template NRM): the fine level with the masks and
//   a 2-slice ring, the coarse and env levels with a 3-slice ring in the
//   masks' room. Neither has room for an f32 copy of the 128 x 96 IPE
//   features (48 KB): the chain's fold recomputes att cos / att sin from
//   the six moments of a row, with the very expressions load_ipe uses, so
//   its values equal the features the column-split fold reads.
// * g_x is folded straight from the accumulators of layer 5's skip
//   columns and layer 0 (where 3 L is a multiple of 8, a thread holds
//   feature j and j + 3 L of its rows, the sin and cos of one degree and
//   dimension; else each feature is folded alone), reduced over the four
//   lanes of a row, into d raw_sigma / d means per row.
// * Compositing, the expectations and the normal average are sequential
//   f32 scans, one thread per ray, as in kernel 5's `composite`.
// * IPE phases are exact power-of-two products (ldexpf) with the accurate
//   sinf/expf: the phases reach ~1e5, so fast-math intrinsics would garble
//   the high degrees. Do not build with --use_fast_math. bf16 rounding
//   where the TPU kernel rounds (every product operand).
// * The 512-wide build (W 512): two 80 KB activation tiles do not fit a
//   block, nor 256 accumulators per thread, so a tile is 64 rows of whole
//   rays (1 ray at S = 56, 12 at S = 5) on the column split of the
//   training kernels (mlp_rows.cuh, RS false): one activation tile, each
//   warpgroup half of every product's columns (m64n256k16, two ring
//   stages per K step), masks in fragment order (32 KB), a 3-stage ring,
//   and g_x folded feature by feature from each warpgroup's 64 of the
//   128 skip columns into partial sums per warpgroup, added in
//   normals_tile. A simple layout that is right; its speed is later work.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// point (pano_nerf_tpu_torch/kernels/build.py).

#include "mlp_rows.cuh"

static_assert(nerf_mlp::NDC == 5, "built for the 5-channel density head");

namespace {

using namespace nerf_mlp;

// The viewdir encoding is built here, with identity (as JAX's kernel 4
// builds it): VF = 3 + 6 deg_view.
static_assert(VF % 6 == 3, "kernel 4 encodes viewdirs with identity");
constexpr int DV = (VF - 3) / 6;  // deg_view
constexpr int OUT_FIXED = 17;
// Row split where two 64-row tiles fit a block (W <= 256), else the
// column split on one tile (see the header).
constexpr bool RS = W <= 256;
constexpr int TR = RS ? 2 * TM : TM;    // sample rows per tile

// Per-row scalars (f32 [NROW][TR]).
enum {
  R_DD, R_W, R_RGB, R_ALB = R_RGB + 3, R_ROUGH = R_ALB + 3, R_N = R_ROUGH + 1,
  R_ORT = R_N + 3, NROW
};

struct Params {
  const float* mc;       // [R*S, 8]: means | covs | delta | t_mid
  const float* rayinfo;  // [R, 8]: viewdir | t_0 | t_S | dir
  const bf16* w;
  const float* b;
  float* out;            // [R, 17 + S]
  int R, S, rpt, ntiles, min_deg;
  float density_bias, rgb_padding;
  int white_bkgd, need_extras;
};

// NRM: the fine level's layout, with the chain's ReLU masks and a
// 2-slice ring; without normals the masks' room goes to a third slice.
// The column split (W 512) has room for three slices either way; its
// d raw_sigma / d means is two partial sums, one per warpgroup.
template <bool NRM>
struct Smem {
  static constexpr int NS = NRM && RS ? 2 : 3;  // weight-slice stages
  alignas(1024) bf16 act[(RS ? 2 : 1) * ACT_ELEMS];
  alignas(1024) unsigned char ring[NS * SLICE];
  uint32_t mask[NRM ? 8 * (RS ? W / 64 : MWC) * NT : 1];
  float mc[TR * 8];
  float heads[TR * OUT_W];
  float row[NROW * TR];
  float ray[TR * 8];
  float dsig[(RS ? 1 : 2) * TR * 4];
  float acc[TR];
  uint64_t full[NS], empty[NS], io;
};
static_assert(sizeof(Smem<true>) + 1024 <= SMEM_LIMIT, "fine-level shared memory");
static_assert(sizeof(Smem<false>) + 1024 <= SMEM_LIMIT, "shared memory");

template <class Sm>
__device__ Sm& smem_of(unsigned char* raw) {
  return *reinterpret_cast<Sm*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                ~uintptr_t(1023));
}

// Viewdir codes [d | sin(2^k d) | cos(2^k d)], k = 0..DV-1, zero in
// columns VF..VP-1, of tile row r, from its ray's direction (s.ray).
struct ViewCodes {
  const float* ray;
  int S;
  __device__ uint4 operator()(int r, int c) const {
    const float* d = ray + (r / S) * 8;
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      float v[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int j = c + e + k;
        v[k] = 0.f;
        if (j < 3) {
          v[k] = d[j];
        } else if (j < VF) {
          const int jj = (j - 3) % (3 * DV);
          float arg = d[jj % 3] * ldexpf(1.f, jj / 3);
          if (j >= 3 + 3 * DV) arg = arg + 1.57079632679489662f;
          v[k] = sinf(arg);
        }
      }
      h[e / 2] = __floats2bfloat162_rn(v[0], v[1]);
    }
    return u;
  }
};

// Per-row activations, then compositing: one thread per ray, sequential
// over its samples; writes the slab's fixed columns and weights.
template <class Sm>
__device__ void composite_tile(Sm& s, const Params& p, int ray0,
                               int nrays) {
  const int tid = threadIdx.x, S = p.S;
  float* rowf = s.row;
  consumer_sync();  // the heads of both warpgroups
  if (tid < TR) {
    const float* h = s.heads + tid * OUT_W;
    const float* dens = h + 3;
    rowf[R_DD * TR + tid] =
        softplusf(dens[0] + p.density_bias) * s.mc[tid * 8 + 6];
    for (int k = 0; k < 3; ++k) {
      rowf[(R_RGB + k) * TR + tid] =
          softplusf(h[k]) * (1.f + 2.f * p.rgb_padding) - p.rgb_padding;
      rowf[(R_ALB + k) * TR + tid] = sigmoidf(dens[1 + k]) * 0.77f + 0.03f;
    }
    rowf[R_ROUGH * TR + tid] = softplusf(dens[4] - 1.f);
  }
  consumer_sync();
  const int out_w = OUT_FIXED + S;
  for (int q = tid; q < nrays; q += NT) {
    float tau = 0.f, acc = 0.f, dist = 0.f, rough = 0.f;
    float rgb[3] = {0.f, 0.f, 0.f}, alb[3] = {0.f, 0.f, 0.f};
    float* o = p.out + (size_t)(ray0 + q) * out_w;
    for (int k = 0; k < S; ++k) {
      const int r = q * S + k;
      const float dd = rowf[R_DD * TR + r];
      const float w = (1.f - expf(-dd)) * expf(-tau);
      tau += dd;
      rowf[R_W * TR + r] = w;
      o[OUT_FIXED + k] = w;
      acc += w;
      dist += w * s.mc[r * 8 + 7];
      rough += w * rowf[R_ROUGH * TR + r];
      for (int c = 0; c < 3; ++c) {
        rgb[c] += w * rowf[(R_RGB + c) * TR + r];
        alb[c] += w * rowf[(R_ALB + c) * TR + r];
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
}

// Fold one part of g_x (layer 5's skip columns or layer 0's product, 128
// columns of which 2 XP are features) through the IPE Jacobian into
// d raw_sigma / d means (s.dsig, per tile row): d feat_sin / d mean =
// 2^deg att cos(y), d feat_cos / d mean = -2^deg att sin(y). Column split:
// this warpgroup's 64 columns into its own partial sums.
template <int NP>
__device__ void fold_gx(Smem<true>& s, int min_deg, int layer,
                        const float (&part)[NP]) {
  const int rb = row0_of<RS>(), c0 = col0<RS>(128);
  float* dsig = s.dsig + (RS ? 0 : wg() * TR * 4);
  float g[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  if constexpr (RS && XP % 8 == 0) {
    // Feature j < XP and its cos partner j + XP sit in one thread, XP / 8
    // n8 blocks apart: both from one att and y.
    constexpr int NB = XP / 8, PART = 4 * NB;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* m = s.mc + (rb + frag_row(2 * h)) * 8;
#pragma unroll
      for (int jb = 0; jb < NB; ++jb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jb + 2 * h + e;  // feature j < XP; i + PART is j + XP
          const int j = frag_col(i);
          const int deg = j / 3 + min_deg, dim = j % 3;
          const float y = m[dim] * ldexpf(1.f, deg);
          const float att = expf(-0.5f * (m[3 + dim] * ldexpf(1.f, 2 * deg)));
          const float ac = att * sinf(y + 1.57079632679489662f);
          const float as = att * sinf(y);
          g[h][dim] += (part[i] * ac - part[i + PART] * as) * ldexpf(1.f, deg);
        }
      }
    }
  } else {
    // Each feature alone: sin features j < XP, cos features XP..2 XP-1.
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int h = (i >> 1) & 1, j = c0 + frag_col(i);
      if (j < 2 * XP) {
        const float* m = s.mc + (rb + frag_row(i)) * 8;
        const int jj = j % XP, deg = jj / 3 + min_deg, dim = jj % 3;
        const float y = m[dim] * ldexpf(1.f, deg);
        const float att = expf(-0.5f * (m[3 + dim] * ldexpf(1.f, 2 * deg)));
        const float v =
            (j < XP ? part[i] * (att * sinf(y + 1.57079632679489662f))
                    : -part[i] * (att * sinf(y))) *
            ldexpf(1.f, deg);
#pragma unroll
        for (int d = 0; d < 3; ++d) g[h][d] += d == dim ? v : 0.f;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float v = g[h][d];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      g[h][d] = v;
    }
  }
  if ((threadIdx.x & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* o = dsig + (rb + frag_row(2 * h)) * 4;
#pragma unroll
      for (int d = 0; d < 3; ++d) o[d] = layer == 5 ? g[h][d] : o[d] + g[h][d];
    }
  }
}

// Per-row normals from d raw_sigma / d means, then their weighted average
// per ray.
__device__ void normals_tile(Smem<true>& s, const Params& p, int ray0, int nrays,
                             int nrows) {
  const int tid = threadIdx.x, S = p.S;
  float* rowf = s.row;
  consumer_sync();  // s.dsig of both warpgroups
  if (tid < nrows) {
    float g[3];
    for (int c = 0; c < 3; ++c) {
      g[c] = s.dsig[tid * 4 + c];
      if constexpr (!RS) g[c] += s.dsig[(TR + tid) * 4 + c];
    }
    const float nrm = sqrtf(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]);
    const float inv = 1.f / fmaxf(nrm, 1e-12f);
    const float* d = s.ray + (tid / S) * 8 + 5;
    float ndot = 0.f;
    for (int c = 0; c < 3; ++c) {
      const float n = -g[c] * inv;
      rowf[(R_N + c) * TR + tid] = n;
      ndot += n * d[c];
    }
    const float o = fmaxf(ndot, 0.f);
    rowf[R_ORT * TR + tid] = o * o;
  }
  consumer_sync();
  const int out_w = OUT_FIXED + S;
  for (int q = tid; q < nrays; q += NT) {
    float n[3] = {0.f, 0.f, 0.f}, ort = 0.f;
    for (int k = 0; k < S; ++k) {
      const int r = q * S + k;
      const float w = rowf[R_W * TR + r];
      for (int c = 0; c < 3; ++c) n[c] += w * rowf[(R_N + c) * TR + r];
      ort += w * rowf[R_ORT * TR + r];
    }
    const float inv = 1.f / fmaxf(s.acc[q], 1e-12f);
    for (int c = 0; c < 3; ++c) n[c] *= inv;
    const float nn = 1.f / fmaxf(sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]), 1e-12f);
    float* o = p.out + (size_t)(ray0 + q) * out_w;
    for (int c = 0; c < 3; ++c) o[9 + c] = n[c] * nn;
    o[12] = ort * inv;
  }
}

// Tile t: rays t * rpt .. (as many as are left), rows in ray-major order.
template <bool NRM, bool PRODUCER, int NS>
__device__ void render_tile(Pipe<PRODUCER, NS>& pp, Smem<NRM>& s,
                            const Params& p, int t) {
  const int ray0 = t * p.rpt;
  const int nrays = min(p.rpt, p.R - ray0);
  const int nrows = nrays * p.S;
  const size_t row0 = (size_t)ray0 * p.S;
  if constexpr (!PRODUCER) {
    consumer_sync();  // the previous tile is done with every scalar
    for (int i = threadIdx.x; i < TR * 8; i += NT) {
      const int q = i >> 3;
      s.ray[i] = q < nrays ? p.rayinfo[(size_t)(ray0 + q) * 8 + (i & 7)] : 0.f;
    }
    consumer_sync();
    load_ipe<RS>(s, p.mc, row0, nrows, p.min_deg);
  }
  trunk_forward<RS, NRM>(pp, s, p.b, nullptr);
  heads_forward<false, true, RS>(pp, s, p.b, ViewCodes{s.ray, p.S}, nrows,
                                 nullptr, 0, nullptr, 0);
  if constexpr (!PRODUCER) composite_tile(s, p, ray0, nrays);
  if constexpr (NRM) {
    density_chain<RS>(pp, s, p.w, [&](int layer, const auto& part) {
      fold_gx(s, p.min_deg, layer, part);
    });
    if constexpr (!PRODUCER) normals_tile(s, p, ray0, nrays, nrows);
  }
}

template <bool NRM>
__global__ void __launch_bounds__(ROW_THREADS, 1)
    fused_render_kernel(const __grid_constant__ Maps maps,
                        const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  Smem<NRM>& s = smem_of<Smem<NRM>>(smem_raw);
  pipe_init(s);
  run_roles<24, 240>(s, &maps, [&](auto& pp) {
    for (int t = blockIdx.x; t < p.ntiles; t += gridDim.x) {
      render_tile(pp, s, p, t);
    }
  });
}

template <bool NRM>
cudaError_t launch(const Maps& maps, const Params& p, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<NRM>) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      fused_render_kernel<NRM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const int grid = p.ntiles < sms ? p.ntiles : sms;
  fused_render_kernel<NRM><<<grid, ROW_THREADS, smem, stream>>>(maps, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_render_weight_count() { return W_TOTAL; }
int fused_render_bias_count() { return B_TOTAL; }
NERF_SHAPE_EXPORT(fused_render_shape)

// Rays per tile at S samples per ray (0: S not taken).
int fused_render_tile_rays(int S) { return S >= 1 && S <= TM ? TR / S : 0; }

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
  Params p;
  p.mc = mc;
  p.rayinfo = rayinfo;
  p.w = static_cast<const bf16*>(weights);
  p.b = biases;
  p.out = out;
  p.R = R;
  p.S = S;
  p.rpt = fused_render_tile_rays(S);
  p.ntiles = (R + p.rpt - 1) / p.rpt;
  p.min_deg = min_deg;
  p.density_bias = density_bias;
  p.rgb_padding = rgb_padding;
  p.white_bkgd = white_bkgd;
  p.need_extras = need_extras;
  Maps maps;
  cudaError_t err = make_weight_maps(&maps, p.w);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(need_normals ? launch<true>(maps, p, st)
                            : launch<false>(maps, p, st));
}

}  // extern "C"
