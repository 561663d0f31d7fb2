// Whole training render level for the H100, no normals: IPE + NerfMLP +
// alpha compositing forward, and its hand-derived backward.
//
// Replaces the TPU kernel `fused_render_train` of
// pano_nerf_tpu/kernels/fused_render_train.py:451 (`_forward_core` :106,
// `_train_fwd_kernel` :147, `_train_bwd_kernel` :188; pallas_call :358 and
// :399). The training coarse level and the secondary env queries take it
// when `nerf.use_train_render_kernel` is on.
//
// Forward, per ray q and sample s (dd = softplus(raw_sigma + bias) delta,
// tau_s = sum_{j<s} dd_j, w_s = (1 - e^{-dd_s}) e^{-tau_s}):
//   out [R, 8] = rgb(3) | acc | distance | 0(3), weights [R, S], f32;
//   distance = clip(sum w t_mid / max(acc, 1e-10), t_0, t_S), white_bkgd
//   adds 1 - acc. With `acts` the 8 trunk activations are spilled as bf16
//   [R*S, 8*W] for the backward.
// Backward (derivation at fused_render_train.py:26-43): from the per-ray
// cotangents of out and weights, per ray in f32,
//   cot_w_s = sum_c cot_rgb_c rgb_cs + cot_acc + cot_N t_mid_s + g_w_s,
//   cot_dd_i = cot_w_i e^{-dd_i - tau_i} - sum_{s>i} cot_w_s w_s,
// then the head cotangent (rgb lanes through the padded softplus, the
// sigma lane through dd), the MLP backward and the IPE adjoint of
// mlp_rows.cuh, and d moments for all 8 lanes (delta: cot_dd softplus;
// t_mid: cot_N w). The row pass writes the operand rows of the
// weight-gradient pass of fused_mlp.cu (layout OPW_IPE), which the
// wrapper launches next.
//
// What bounds it on an H100: tensor-core operations, as kernel 2: 611,328
// MACs per sample row forward and 3 x 611,328 backward at the shipped
// shape, against 96 B of inputs per row; compositing is O(S) per ray. A
// build takes the MLP's shape as nerf_mlp.cuh's constants (the viewdir
// codes arrive encoded, VF of VP columns); a 512-wide build runs the same
// steps at N = 512 with a 2-stage ring (mlp_rows.cuh).
//
// Design:
// * Ray-aligned tiles: compositing needs a whole ray in one block, so a
//   block takes floor(64 / S) rays (one at S = 56, twelve at S = 5) as at
//   most 64 sample rows; rows past the tile's rays load as zeros and get a
//   zero cotangent, so their operand rows add nothing to any weight
//   gradient. At S = 56 the tile wastes 8 of 64 rows.
// * The MLP runs on the steps of mlp_rows.cuh, as kernels 1-3 do: two
//   consumer warpgroups on wgmma products with weights streamed by TMA
//   from a producer warpgroup, epilogues from registers, operand rows written
//   by TMA stores of the activation tile. The optional trunk spill
//   (`acts`) is written with 16-byte stores (a ray tile's rows are not a
//   whole 64-row box) and read back by TMA. Compositing and its adjoint
//   are sequential f32 scans, one thread per ray.
// * Accurate expf / log1pf for softplus and sigmoid; no --use_fast_math
//   (IPE phases reach ~1e5). e^{-dd - tau} underflows to 0 for large dd,
//   never to NaN.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// point (pano_nerf_tpu_torch/kernels/build.py).

#include "mlp_rows.cuh"

static_assert(nerf_mlp::NDC == 5, "built for the 5-channel density head");

namespace {

using namespace nerf_mlp;

// Per-row scalars (f32 [NROW][TM]).
enum { R_DELTA, R_TMID, R_SIG, R_DD, R_W, R_TAU, R_RAW, R_RGB = R_RAW + 3,
       NROW = R_RGB + 3 };

struct Params {
  const float* mc;    // [R*S, 8]: means | covs | delta | t_mid
  const float* clip;  // [R, 2]: t_0 | t_S
  const bf16* v;      // [R*S, VP] viewdir encoding per row
  const bf16* w;
  const float* b;
  float* out;         // [R, 8]
  float* weights;     // [R, S]
  bf16* acts;         // [R*S, 8*W] spill (forward: written if non-null;
                      // backward: read if non-null, else recomputed)
  const float* g8;    // [R, 8] cotangent of out
  const float* gw;    // [R, S] cotangent of weights
  bf16* ops;          // [grid * 64, OPW_IPE] operand rows
  float* dmc;         // [R*S, 8]
  BiasSums sums;      // db, written
  int R, S, rpb, min_deg;
  float density_bias, rgb_padding;
  int white_bkgd;
};

struct SmemF {
  alignas(1024) bf16 act[TM * 64 * ACT_BLOCKS];
  alignas(1024) unsigned char ring[RING * SLICE];
  uint32_t mask[8 * MWC * NT];
  float x32[X32_ELEMS];
  float mc[TM * 8];
  float heads[TM * OUT_W];
  float row[NROW * TM];
  float clip[TM * 2];
  uint64_t full[RING], empty[RING], io;
};

struct SmemB {
  alignas(1024) bf16 act[TM * 64 * ACT_BLOCKS];
  alignas(1024) unsigned char ring[RING * SLICE];
  uint32_t mask[8 * MWC * NT];
  uint32_t hvmask[HVW * NT];
  float x32[X32_ELEMS];
  float dx[TM * XF];
  float g[TM * OUT_W];
  float dmc[TM * 8];
  float mc[TM * 8];
  float heads[TM * OUT_W];
  float row[NROW * TM];
  float clip[TM * 2];
  uint64_t full[RING], empty[RING], io;
};
static_assert(sizeof(SmemF) + 1024 <= SMEM_LIMIT, "forward shared memory");
static_assert(sizeof(SmemB) + 1024 <= SMEM_LIMIT, "backward shared memory");

template <class Smem>
__device__ Smem& smem_of(unsigned char* raw) {
  return *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                  ~uintptr_t(1023));
}

// The tile's inputs and MLP forward: moments (delta and t_mid kept per
// row), clip bounds, IPE, trunk, heads; then the per-row activations.
// The forward (BWD false) spills the trunk to p.acts when that is
// non-null; the backward loads the spill from p.acts when non-null, else
// recomputes the trunk, and writes the forward operand rows (`ops` the
// tile's first operand row, ops_row0 its row in maps.ops).
template <bool BWD, bool PRODUCER, class Smem>
__device__ void tile_forward(Pipe<PRODUCER>& pp, Smem& s, const Params& p,
                             const Maps& maps, size_t row0, int ray0,
                             int nrays, int nrows, bf16* ops, int ops_row0) {
  const int tid = threadIdx.x;
  float* rowf = s.row;
  if constexpr (!PRODUCER) {
    load_ipe(s, p.mc, row0, nrows, p.min_deg);
    for (int r = tid; r < TM; r += NT) {
      rowf[R_DELTA * TM + r] = s.mc[r * 8 + 6];
      rowf[R_TMID * TM + r] = s.mc[r * 8 + 7];
    }
    for (int i = tid; i < TM * 2; i += NT) {
      s.clip[i] = i < nrays * 2 ? p.clip[(size_t)ray0 * 2 + i] : 0.f;
    }
    if constexpr (BWD) copy_cols(s.act, W, XF, ops + O_X, OPW_IPE, TM);
  }
  if constexpr (BWD) {
    if (p.acts != nullptr) {
      if constexpr (!PRODUCER) {
        trunk_load(s, &maps.acts, (int)row0, nrows, &maps.ops, ops_row0);
      }
    } else {
      const TrunkOut out{&maps.ops, nullptr, 0, O_A, ops_row0, 0};
      trunk_forward(pp, s, p.b, &out);
    }
  } else {
    const TrunkOut spill{nullptr, p.acts + row0 * 8 * W, 8 * W, 0, 0, nrows};
    trunk_forward(pp, s, p.b, p.acts != nullptr ? &spill : nullptr);
  }
  heads_forward<BWD, true>(pp, s, p.b, p.v + row0 * VP, nrows, &maps.ops,
                           ops_row0, ops, OPW_IPE);
  if constexpr (!PRODUCER) {
    for (int r = tid; r < TM; r += NT) {
      const float* h = s.heads + r * OUT_W;
      const float sig = h[3] + p.density_bias;
      rowf[R_SIG * TM + r] = sig;
      rowf[R_DD * TM + r] = softplusf(sig) * rowf[R_DELTA * TM + r];
      for (int c = 0; c < 3; ++c) {
        rowf[(R_RAW + c) * TM + r] = h[c];
        rowf[(R_RGB + c) * TM + r] =
            softplusf(h[c]) * (1.f + 2.f * p.rgb_padding) - p.rgb_padding;
      }
    }
    consumer_sync();
  }
}

// Compositing of ray q of the tile (one thread): fills R_W and R_TAU and
// returns acc, the distance numerator N and the composited rgb.
__device__ void composite(float* rowf, int q, int S, float* acc, float* N,
                          float rgb[3]) {
  float tau = 0.f;
  *acc = 0.f;
  *N = 0.f;
  rgb[0] = rgb[1] = rgb[2] = 0.f;
  for (int k = 0; k < S; ++k) {
    const int r = q * S + k;
    const float dd = rowf[R_DD * TM + r];
    const float w = (1.f - expf(-dd)) * expf(-tau);
    rowf[R_TAU * TM + r] = tau;
    rowf[R_W * TM + r] = w;
    tau += dd;
    *acc += w;
    *N += w * rowf[R_TMID * TM + r];
    for (int c = 0; c < 3; ++c) rgb[c] += w * rowf[(R_RGB + c) * TM + r];
  }
}

__device__ void composite_rays(SmemF& s, const Params& p, int ray0,
                               int nrays);

template <bool PRODUCER>
__device__ void fwd_tile(Pipe<PRODUCER>& pp, SmemF& s, const Params& p,
                         const Maps& maps) {
  const int S = p.S;
  const int ray0 = blockIdx.x * p.rpb;
  const int nrays = min(p.rpb, p.R - ray0);
  const size_t row0 = (size_t)ray0 * S;
  tile_forward<false>(pp, s, p, maps, row0, ray0, nrays, nrays * S, nullptr,
                      0);
  if constexpr (!PRODUCER) composite_rays(s, p, ray0, nrays);
}

// The tile's compositing, one thread per ray: weights and the output row.
__device__ void composite_rays(SmemF& s, const Params& p, int ray0,
                               int nrays) {
  const int S = p.S;
  for (int q = threadIdx.x; q < nrays; q += NT) {
    float acc, N, rgb[3];
    composite(s.row, q, S, &acc, &N, rgb);
    const size_t ray = (size_t)ray0 + q;
    for (int k = 0; k < S; ++k) p.weights[ray * S + k] = s.row[R_W * TM + q * S + k];
    float* o = p.out + ray * 8;
    for (int c = 0; c < 3; ++c) o[c] = p.white_bkgd ? rgb[c] + (1.f - acc) : rgb[c];
    o[3] = acc;
    o[4] = fminf(fmaxf(N / fmaxf(acc, 1e-10f), s.clip[q * 2]), s.clip[q * 2 + 1]);
    o[5] = o[6] = o[7] = 0.f;
  }
}

__global__ void __launch_bounds__(ROW_THREADS, 1)
    train_fwd_kernel(const __grid_constant__ Maps maps,
                     const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  SmemF& s = smem_of<SmemF>(smem_raw);
  pipe_init(s);
  run_roles(s, &maps, [&](auto& pp) { fwd_tile(pp, s, p, maps); });
}

template <bool PRODUCER>
__device__ void bwd_tile(Pipe<PRODUCER>& pp, SmemB& s, const Params& p,
                         const Maps& maps) {
  const int tid = threadIdx.x;
  const int S = p.S;
  const int ray0 = blockIdx.x * p.rpb;
  const int nrays = min(p.rpb, p.R - ray0);
  const int nrows = nrays * S;
  const size_t row0 = (size_t)ray0 * S;
  const int ops_row0 = blockIdx.x * TM;
  bf16* ops = p.ops + (size_t)ops_row0 * OPW_IPE;
  float* rowf = s.row;

  if constexpr (!PRODUCER) {
    for (int i = tid; i < TM * OUT_W; i += NT) s.g[i] = 0.f;
    for (int i = tid; i < TM * 8; i += NT) s.dmc[i] = 0.f;
  }
  tile_forward<true>(pp, s, p, maps, row0, ray0, nrays, nrows, ops, ops_row0);

  // ---- per-ray adjoints: one thread per ray ----
  if constexpr (!PRODUCER) {
    const float scale = 1.f + 2.f * p.rgb_padding;
    for (int q = tid; q < nrays; q += NT) {
      float acc, N, rgb[3];
      composite(rowf, q, S, &acc, &N, rgb);
      const size_t ray = (size_t)ray0 + q;
      const float* g8 = p.g8 + ray * 8;
      const float D = fmaxf(acc, 1e-10f);
      const float dist = N / D;
      const float cd = (dist > s.clip[q * 2] && dist < s.clip[q * 2 + 1]) ? g8[4] : 0.f;
      const float cot_N = cd / D;
      float cot_acc = g8[3] - (acc > 1e-10f ? cd * N / (D * D) : 0.f);
      if (p.white_bkgd) cot_acc -= g8[0] + g8[1] + g8[2];
      float suffix = 0.f;  // sum_{s > i} cot_w_s w_s
      for (int k = S - 1; k >= 0; --k) {
        const int r = q * S + k;
        const float w = rowf[R_W * TM + r];
        const float dd = rowf[R_DD * TM + r];
        const float sig = rowf[R_SIG * TM + r];
        float cw = cot_acc + cot_N * rowf[R_TMID * TM + r] + p.gw[ray * S + k];
        for (int c = 0; c < 3; ++c) cw += g8[c] * rowf[(R_RGB + c) * TM + r];
        const float cot_dd = cw * expf(-dd - rowf[R_TAU * TM + r]) - suffix;
        suffix += cw * w;
        for (int c = 0; c < 3; ++c) {
          s.g[r * OUT_W + c] =
              g8[c] * w * sigmoidf(rowf[(R_RAW + c) * TM + r]) * scale;
        }
        s.g[r * OUT_W + 3] = cot_dd * sigmoidf(sig) * rowf[R_DELTA * TM + r];
        s.dmc[r * 8 + 6] = cot_dd * softplusf(sig);
        s.dmc[r * 8 + 7] = cot_N * w;
      }
    }
    consumer_sync();
  }
  mlp_backward(pp, s, part_row(p.sums), &maps.ops, ops_row0, ops, OPW_IPE);
  if constexpr (!PRODUCER) {
    ipe_backward(s, p.min_deg);
    for (int i = tid; i < nrows * 8; i += NT) p.dmc[row0 * 8 + i] = s.dmc[i];
    bias_sums(p.sums);
  }
}

__global__ void __launch_bounds__(ROW_THREADS, 1)
    train_bwd_kernel(const __grid_constant__ Maps maps,
                     const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  SmemB& s = smem_of<SmemB>(smem_raw);
  pipe_init(s);
  run_roles(s, &maps, [&](auto& pp) { bwd_tile(pp, s, p, maps); });
}

Params make_params(const float* mc, const float* clip, const void* v,
                   const void* weights, const float* biases, void* acts,
                   int R, int S, int min_deg, float density_bias,
                   float rgb_padding, int white_bkgd) {
  Params p = {};
  p.mc = mc;
  p.clip = clip;
  p.v = static_cast<const bf16*>(v);
  p.w = static_cast<const bf16*>(weights);
  p.b = biases;
  p.acts = static_cast<bf16*>(acts);
  p.R = R;
  p.S = S;
  p.rpb = TM / S;
  p.min_deg = min_deg;
  p.density_bias = density_bias;
  p.rgb_padding = rgb_padding;
  p.white_bkgd = white_bkgd;
  return p;
}

}  // namespace

extern "C" {

NERF_SHAPE_EXPORT(fused_render_train_shape)
BIAS_WORKSPACE_EXPORT(fused_render_train_bias_workspace)

// Blocks (tiles of 64 rows) of a launch over R rays of S samples; the
// backward's operand buffer has 64 rows per block.
int fused_render_train_blocks(int R, int S) {
  if (R <= 0 || S <= 0 || S > TM) return -1;
  return (R + TM / S - 1) / (TM / S);
}

// Forward over R rays of S samples; `acts` may be null. Returns a
// cudaError_t (0 = ok; fused_mlp_error_string names it).
int fused_render_train_forward(const float* mc, const float* clip,
                               const void* v, const void* weights,
                               const float* biases, float* out,
                               float* weights_out, void* acts, int R, int S,
                               int min_deg, float density_bias,
                               float rgb_padding, int white_bkgd,
                               void* stream) {
  const int grid = fused_render_train_blocks(R, S);
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  Params p = make_params(mc, clip, v, weights, biases, acts, R, S, min_deg,
                         density_bias, rgb_padding, white_bkgd);
  p.out = out;
  p.weights = weights_out;
  Maps maps;
  cudaError_t err = make_weight_maps(&maps, p.w);
  const int smem = (int)sizeof(SmemF) + 1024;
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        train_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err != cudaSuccess) return (int)err;
  train_fwd_kernel<<<grid, ROW_THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(maps, p);
  return (int)cudaGetLastError();
}

// Backward row pass: writes dmc [R*S, 8], the operand rows `ops`
// ([blocks * 64, fused_mlp_ops_width(0)] bf16) and the bias gradients
// into db. `part` and `count` are the scratch of
// fused_render_train_bias_workspace(blocks), count zeroed. `acts` (the
// forward's spill) may be null: the trunk is then recomputed.
int fused_render_train_backward_rows(const float* mc, const float* clip,
                                     const void* v, const void* weights,
                                     const float* biases, const float* g8,
                                     const float* gw, const void* acts,
                                     void* ops, float* dmc, float* db,
                                     float* part, int* count, int R, int S,
                                     int min_deg, float density_bias,
                                     float rgb_padding, int white_bkgd,
                                     void* stream) {
  const int grid = fused_render_train_blocks(R, S);
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  Params p = make_params(mc, clip, v, weights, biases,
                         const_cast<void*>(acts), R, S, min_deg,
                         density_bias, rgb_padding, white_bkgd);
  p.g8 = g8;
  p.gw = gw;
  p.ops = static_cast<bf16*>(ops);
  p.dmc = dmc;
  p.sums = {part, count, db, nullptr};
  Maps maps;
  cudaError_t err = make_weight_maps(&maps, p.w);
  if (err == cudaSuccess) {
    err = hopper::make_map(&maps.ops, ops, (uint64_t)grid * TM, OPW_IPE,
                           OPW_IPE);
  }
  if (err == cudaSuccess && acts != nullptr) {
    err = hopper::make_map(&maps.acts, acts, (uint64_t)R * S, 8 * W, 8 * W);
  }
  const int smem = (int)sizeof(SmemB) + 1024;
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        train_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err != cudaSuccess) return (int)err;
  train_bwd_kernel<<<grid, ROW_THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(maps, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
