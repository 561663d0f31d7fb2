// IPE + NerfMLP forward and backward for training on the H100, with and
// without the density-gradient chain.
//
// Replaces two TPU kernels, one template each way (NORMALS):
//  * NORMALS = false: `fused_mlp_ipe_apply` (pano_nerf_tpu/kernels/
//    fused_mlp_ipe.py:268; `_fwd_kernel` :109, `_bwd_ipe_kernel` :124).
//  * NORMALS = true: `fused_mlp_normals_apply` (pano_nerf_tpu/kernels/
//    fused_mlp_normals.py:369; `_sigma_grad_chain` :71, `_fwd_kernel` :94,
//    `_bwd_kernel` :132). The forward also returns d raw_sigma / d means and
//    saves the 8 trunk activations (bf16 [M, 8*256]) for the backward.
//
// Rows are Gaussian moments mc [M, 8] = means(3) | covs(3) | pad(2), f32,
// and per-row viewdir encodings v [M, 32] bf16 (27 used). The output slab
// is [M, 16] f32: raw rgb (3) | raw density (5) | 0.
//
// What bounds it on an H100: tensor-core operations. A row costs 611,328
// MACs forward (+507,904 for the chain), against 96 B of inputs; the
// backward adds the data and weight gradients (x2) and, for NORMALS, the
// adjoint walk of the chain. See kernels/fused_mlp_ipe.py for the counts.
//
// Design (first, simple version):
// * Forward and backward "row" kernels take one block of 256 threads per
//   tile of 64 rows. Activations stay in shared memory as bf16 tiles
//   [64 x (256 | 96)] (the IPE features at columns 256..351, so the skip
//   layer reads [h4 | x] as one K=352 operand); products are WMMA 16x16x16
//   bf16 fragments with f32 accumulate, the weight fragment read from
//   global memory (L2-resident). Epilogues round to bf16 where the TPU
//   kernel does, and keep ReLU masks as bits.
// * Weight gradients: blocks run in parallel and in no order, so the TPU
//   kernel's in-order `+=` over the grid has no counterpart. The backward
//   row kernel writes every operand of every weight-gradient product
//   (bf16, one row of `ops` per sample row) and a second kernel computes
//   dW = dZ^T A over the rows, one 64x64 output tile per block and one
//   chunk of 2048 rows per grid row, adding its partial tile into a zeroed
//   f32 buffer with atomicAdd. Bias gradients are per-tile column sums
//   added the same way. The order of the atomics varies between runs, so
//   weight gradients vary in the last bits of f32 (the wrapper then rounds
//   them to bf16, as both JAX paths do).
// * For NORMALS each trunk weight gets two contributions, the standard
//   backward (dz_i^T a_{i-1}) and the adjoint walk (sz_i^T c_{i-1}); the
//   weight-gradient kernel sums both pairs into one accumulator.
// * Ragged last tile: rows past M are loaded as zeros (inputs, cotangents
//   and saved activations), so their dz, sz and c rows are exactly zero and
//   add nothing to any weight gradient.
// * IPE phases are exact power-of-two products (ldexpf) with the accurate
//   sinf/expf; do not build with --use_fast_math.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// point (pano_nerf_tpu_torch/kernels/build.py).

#include "nerf_mlp.cuh"

namespace {

using namespace nerf_mlp;

constexpr int VP = 32;   // viewdir encoding width, padded (27 used)
constexpr int OUT_W = 16;  // output slab: rgb(3) | density(5) | 0(8)
constexpr int WG_CHUNK = 2048;      // rows per weight-gradient grid row

// Columns of the backward's operand rows (bf16, all multiples of 16).
constexpr int O_X = 0;                // IPE features x
constexpr int O_A = O_X + XF;         // trunk activations a_0..a_7
constexpr int O_BTL = O_A + 8 * W;    // bottleneck
constexpr int O_V = O_BTL + W;        // viewdir encoding
constexpr int O_HV = O_V + VP;        // view-branch activation
constexpr int O_DZ = O_HV + VW;       // trunk cotangents dz_0..dz_7
constexpr int O_GD = O_DZ + 8 * W;    // density-head cotangent (16)
constexpr int O_DBTL = O_GD + HP;     // bottleneck cotangent
constexpr int O_DZV = O_DBTL + W;     // view-branch cotangent
constexpr int O_GR = O_DZV + VW;      // color-head cotangent (16)
constexpr int OPW_IPE = O_GR + HP;
constexpr int O_CGX = OPW_IPE;        // walk: cotangent of g_x
constexpr int O_C = O_CGX + XF;       // walk: c_0..c_6
constexpr int O_SZ = O_C + 7 * W;     // chain: sz_0..sz_7
constexpr int OPW_NRM = O_SZ + 8 * W;

struct FwdParams {
  const float* mc;   // [M, 8]
  const bf16* v;     // [M, 32]
  const bf16* w;
  const float* b;
  float* out;        // [M, 16]
  float* dsig;       // [M, 3]        (NORMALS)
  bf16* acts;        // [M, 8 * 256]  (NORMALS, may be null)
  int M, min_deg;
};

struct BwdParams {
  const float* mc;
  const bf16* v;
  const bf16* w;
  const float* b;
  const float* g;     // [M, 16] cotangent of the output slab
  const float* q;     // [M, 3] cotangent of dsig (NORMALS)
  const bf16* acts;   // [M, 8 * 256] saved by the forward (NORMALS)
  bf16* ops;          // [grid * 64, OPW] operand rows
  float* dmc;         // [M, 8]
  float* dw;          // [W_TOTAL] f32, zeroed; this kernel adds dWd's sigma row
  float* db;          // [B_TOTAL] f32, zeroed
  int M, min_deg;
};

struct SmemF {
  bf16 act[TM * ACT_LD];
  float stage[TM * ST_LD];
  float x32[TM * XF];
  uint32_t mask[8 * TM * MASK_WORDS];
};

struct SmemB {
  bf16 act[TM * ACT_LD];
  float stage[TM * ST_LD];
  float x32[TM * XF];
  float dx[TM * XF];      // d x; later the cotangent of c1 (NORMALS)
  uint32_t mask[8 * TM * MASK_WORDS];
  uint32_t hvmask[TM * (VW / 32)];
  float g[TM * OUT_W];
  float q[TM * 4];
  float dmc[TM * 8];
};

__device__ __forceinline__ bool mask_bit(const uint32_t* mask, int layer,
                                         int r, int c) {
  return (mask[(layer * TM + r) * MASK_WORDS + (c >> 5)] >> (c & 31)) & 1u;
}

// att * cos(y) of IPE feature j, from the f32 features att * sin(y): the
// cos block is the sin block shifted by pi/2, so it is the other half.
__device__ __forceinline__ float att_cos(const float* x32row, int j) {
  return j < XP ? x32row[j + XP] : -x32row[j - XP];
}

__device__ __forceinline__ float deg_scale(int j, int min_deg) {
  return ldexpf(1.f, (j % XP) / 3 + min_deg);
}

// Sum `ncols` bf16 columns of a [64 x ncols] shared tile over its rows and
// add the sums to dst (one atomic per column and tile).
__device__ void colsum_atomic(const bf16* A, int lda, int ncols, float* dst) {
  for (int c = threadIdx.x; c < ncols; c += NT) {
    float s = 0.f;
    for (int r = 0; r < TM; ++r) s += __bfloat162float(A[r * lda + c]);
    atomicAdd(dst + c, s);
  }
}

// Load the moments of the tile into stage[0 : 64*8] (zero past M) and
// build the IPE features: f32 in x32, bf16 at act columns 256..351.
__device__ void load_ipe(const float* mc, int M, int row0, int min_deg,
                         float* stage, float* x32, bf16* act) {
  const int tid = threadIdx.x;
  for (int i = tid; i < TM * 8; i += NT) {
    const int r = i >> 3;
    stage[i] = row0 + r < M ? mc[(size_t)(row0 + r) * 8 + (i & 7)] : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < TM * XF; i += NT) {
    const int r = i / XF, j = i % XF;
    const int jj = j % XP;
    const int deg = jj / 3 + min_deg, dim = jj % 3;
    float y = stage[r * 8 + dim] * ldexpf(1.f, deg);
    if (j >= XP) y = y + 1.57079632679489662f;
    const float var = stage[r * 8 + 3 + dim] * ldexpf(1.f, 2 * deg);
    const float f = expf(-0.5f * var) * sinf(y);
    x32[r * XF + j] = f;
    act[r * ACT_LD + W + j] = __float2bfloat16(f);
  }
  __syncthreads();
}

// Trunk layer epilogue: act = bf16(relu(stage + bias)), ReLU mask bits.
// Optionally copies the activation to `copy` (row stride ld_copy), rows
// < nrows_copy only.
__device__ void relu_epilogue(const float* stage, const float* bias,
                              bf16* act, uint32_t* mask, int layer,
                              bf16* copy, size_t ld_copy, int nrows_copy) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < TM * W; i += NT) {
    const int r = i / W, c = i % W;  // a warp covers 32 columns of a row
    const bf16 h = __float2bfloat16(fmaxf(stage[r * ST_LD + c] + bias[c], 0.f));
    act[r * ACT_LD + c] = h;
    const unsigned bits = __ballot_sync(0xffffffffu, __bfloat162float(h) > 0.f);
    if (lane == 0) mask[(layer * TM + r) * MASK_WORDS + (c >> 5)] = bits;
    if (copy != nullptr && r < nrows_copy) copy[r * ld_copy + c] = h;
  }
  __syncthreads();
}

template <bool NORMALS>
__global__ void __launch_bounds__(NT, 1) fused_mlp_fwd_kernel(FwdParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemF& s = *reinterpret_cast<SmemF*>(smem_raw);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TM;
  const int nrows = min(TM, p.M - row0);

  load_ipe(p.mc, p.M, row0, p.min_deg, s.stage, s.x32, s.act);

  // ---- trunk: 8 x (Linear + ReLU), skip input [h4 | x] into layer 5 ----
  for (int layer = 0; layer < 8; ++layer) {
    const bf16* A = layer == 0 ? s.act + W : s.act;
    const int K = trunk_in(layer);
    tile_matmul<wmma::col_major>(A, ACT_LD, K, p.w + trunk_offset(layer), K,
                                 W, s.stage, ST_LD);
    __syncthreads();
    bf16* copy = (NORMALS && p.acts != nullptr)
                     ? p.acts + (size_t)row0 * 8 * W + layer * W : nullptr;
    relu_epilogue(s.stage, p.b + OFF_BT + layer * W, s.act, s.mask, layer,
                  copy, 8 * W, nrows);
  }

  // ---- heads: density (stage columns 256..271) and bottleneck ----
  tile_matmul<wmma::col_major>(s.act, ACT_LD, W, p.w + OFF_WD, W, HP,
                               s.stage + W, ST_LD);
  tile_matmul<wmma::col_major>(s.act, ACT_LD, W, p.w + OFF_WB, W, W, s.stage,
                               ST_LD);
  __syncthreads();
  for (int i = tid; i < TM * W; i += NT) {
    const int r = i / W, c = i % W;
    s.act[r * ACT_LD + c] = __float2bfloat16(s.stage[r * ST_LD + c] + p.b[OFF_BB + c]);
  }
  for (int i = tid; i < TM * VP; i += NT) {
    const int r = i / VP, j = i % VP;
    s.act[r * ACT_LD + W + j] =
        r < nrows ? p.v[(size_t)(row0 + r) * VP + j] : __float2bfloat16(0.f);
  }
  // Raw density (+ bias) kept in the stage's spare columns 272..276.
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
  for (int i = tid; i < nrows * OUT_W; i += NT) {
    const int r = i / OUT_W, c = i % OUT_W;
    const float* st = s.stage + r * ST_LD;
    float o = 0.f;
    if (c < 3) o = st[c] + p.b[OFF_BC + c];
    else if (c < 3 + NDC) o = st[W + HP + c - 3];
    p.out[(size_t)(row0 + r) * OUT_W + c] = o;
  }
  if constexpr (!NORMALS) return;
  __syncthreads();

  // ---- d raw_sigma / d means: sz-chain through the masked trunk ----
  for (int i = tid; i < TM * W; i += NT) {
    const int r = i / W, c = i % W;
    s.act[r * ACT_LD + c] = mask_bit(s.mask, 7, r, c) ? p.w[OFF_WD + c]
                                                      : __float2bfloat16(0.f);
  }
  __syncthreads();
  for (int layer = 7; layer >= 0; --layer) {
    const int K = trunk_in(layer);
    // Layer 5's columns 256..351 are the skip gradient; they stay in the
    // stage for the fold (later layers write only columns < 256).
    tile_matmul<wmma::row_major>(s.act, ACT_LD, W, p.w + trunk_offset(layer),
                                 K, K, s.stage, ST_LD);
    __syncthreads();
    if (layer == 0) break;
    for (int i = tid; i < TM * W; i += NT) {
      const int r = i / W, c = i % W;
      s.act[r * ACT_LD + c] = mask_bit(s.mask, layer - 1, r, c)
                                  ? __float2bfloat16(s.stage[r * ST_LD + c])
                                  : __float2bfloat16(0.f);
    }
    __syncthreads();
  }
  for (int i = tid; i < nrows * 3; i += NT) {
    const int r = i / 3, d = i % 3;
    float acc = 0.f;
    for (int deg = 0; deg < XP / 3; ++deg) {
      for (int half = 0; half < 2; ++half) {
        const int j = half * XP + deg * 3 + d;
        const float gx = s.stage[r * ST_LD + j] + s.stage[r * ST_LD + W + j];
        acc += gx * att_cos(s.x32 + r * XF, j) * ldexpf(1.f, deg + p.min_deg);
      }
    }
    p.dsig[(size_t)(row0 + r) * 3 + d] = acc;
  }
}

template <bool NORMALS>
__global__ void __launch_bounds__(NT, 1) fused_mlp_bwd_kernel(BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemB& s = *reinterpret_cast<SmemB*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * TM;
  const int nrows = min(TM, p.M - row0);
  constexpr int OPW = NORMALS ? OPW_NRM : OPW_IPE;
  bf16* ops = p.ops + (size_t)row0 * OPW;  // this tile's 64 operand rows

  // ---- inputs: cotangents (zero past M), moments, IPE ----
  for (int i = tid; i < TM * OUT_W; i += NT) {
    const int r = i / OUT_W;
    s.g[i] = r < nrows ? p.g[(size_t)(row0 + r) * OUT_W + i % OUT_W] : 0.f;
  }
  if constexpr (NORMALS) {
    for (int i = tid; i < TM * 4; i += NT) {
      const int r = i >> 2, d = i & 3;
      s.q[i] = (r < nrows && d < 3) ? p.q[(size_t)(row0 + r) * 3 + d] : 0.f;
    }
  }
  for (int i = tid; i < TM * 8; i += NT) s.dmc[i] = 0.f;
  load_ipe(p.mc, p.M, row0, p.min_deg, s.stage, s.x32, s.act);
  for (int i = tid; i < TM * XF; i += NT) {
    const int r = i / XF, j = i % XF;
    ops[(size_t)r * OPW + O_X + j] = s.act[r * ACT_LD + W + j];
  }

  // ---- trunk activations: saved (NORMALS) or recomputed ----
  for (int layer = 0; layer < 8; ++layer) {
    if constexpr (NORMALS) {
      for (int i = tid; i < TM * W; i += NT) {
        const int r = i / W, c = i % W;
        const bf16 h = r < nrows ? p.acts[(size_t)(row0 + r) * 8 * W + layer * W + c]
                                 : __float2bfloat16(0.f);
        const unsigned bits = __ballot_sync(0xffffffffu, __bfloat162float(h) > 0.f);
        if (lane == 0) s.mask[(layer * TM + r) * MASK_WORDS + (c >> 5)] = bits;
        ops[(size_t)r * OPW + O_A + layer * W + c] = h;
        if (layer == 7) s.act[r * ACT_LD + c] = h;
      }
      __syncthreads();
    } else {
      const bf16* A = layer == 0 ? s.act + W : s.act;
      const int K = trunk_in(layer);
      tile_matmul<wmma::col_major>(A, ACT_LD, K, p.w + trunk_offset(layer), K,
                                   W, s.stage, ST_LD);
      __syncthreads();
      relu_epilogue(s.stage, p.b + OFF_BT + layer * W, s.act, s.mask, layer,
                    ops + O_A + layer * W, OPW, TM);
    }
  }

  // ---- heads forward: bottleneck, view branch (masks of hv) ----
  tile_matmul<wmma::col_major>(s.act, ACT_LD, W, p.w + OFF_WB, W, W, s.stage,
                               ST_LD);
  __syncthreads();
  for (int i = tid; i < TM * W; i += NT) {
    const int r = i / W, c = i % W;
    const bf16 h = __float2bfloat16(s.stage[r * ST_LD + c] + p.b[OFF_BB + c]);
    s.act[r * ACT_LD + c] = h;
    ops[(size_t)r * OPW + O_BTL + c] = h;
  }
  for (int i = tid; i < TM * VP; i += NT) {
    const int r = i / VP, j = i % VP;
    const bf16 v = r < nrows ? p.v[(size_t)(row0 + r) * VP + j] : __float2bfloat16(0.f);
    s.act[r * ACT_LD + W + j] = v;
    ops[(size_t)r * OPW + O_V + j] = v;
  }
  __syncthreads();
  tile_matmul<wmma::col_major>(s.act, ACT_LD, VK, p.w + OFF_WV, VK, VW,
                               s.stage, ST_LD);
  __syncthreads();
  for (int i = tid; i < TM * VW; i += NT) {
    const int r = i / VW, c = i % VW;
    const bf16 h =
        __float2bfloat16(fmaxf(s.stage[r * ST_LD + c] + p.b[OFF_BV + c], 0.f));
    const unsigned bits = __ballot_sync(0xffffffffu, __bfloat162float(h) > 0.f);
    if (lane == 0) s.hvmask[r * (VW / 32) + (c >> 5)] = bits;
    ops[(size_t)r * OPW + O_HV + c] = h;
  }
  __syncthreads();

  // ---- heads backward ----
  // Color-head cotangent (bf16, columns 0..2 of 16) as the A operand.
  for (int i = tid; i < TM * HP; i += NT) {
    const int r = i / HP, c = i % HP;
    const bf16 gr = __float2bfloat16(c < 3 ? s.g[r * OUT_W + c] : 0.f);
    s.act[r * ACT_LD + c] = gr;
    ops[(size_t)r * OPW + O_GR + c] = gr;
  }
  // Head biases take the f32 cotangent: d bc, d bd.
  if (tid < 3 + NDC) {
    float acc = 0.f;
    for (int r = 0; r < TM; ++r) acc += s.g[r * OUT_W + tid];
    atomicAdd(p.db + (tid < 3 ? OFF_BC + tid : OFF_BD + tid - 3), acc);
  }
  __syncthreads();
  tile_matmul<wmma::row_major>(s.act, ACT_LD, HP, p.w + OFF_WC, VW, VW,
                               s.stage, ST_LD);  // d hv = gr @ Wc
  __syncthreads();
  for (int i = tid; i < TM * VW; i += NT) {
    const int r = i / VW, c = i % VW;
    const bool on = (s.hvmask[r * (VW / 32) + (c >> 5)] >> (c & 31)) & 1u;
    const bf16 dz = __float2bfloat16(on ? s.stage[r * ST_LD + c] : 0.f);
    s.act[r * ACT_LD + c] = dz;
    ops[(size_t)r * OPW + O_DZV + c] = dz;
  }
  __syncthreads();
  colsum_atomic(s.act, ACT_LD, VW, p.db + OFF_BV);
  tile_matmul<wmma::row_major>(s.act, ACT_LD, VW, p.w + OFF_WV, VK, W,
                               s.stage, ST_LD);  // d btl = dzv @ Wv[:, :256]
  __syncthreads();
  // A operand [gd (16) | dbtl (256)] against the stacked [Wd ; Wb]
  // (contiguous in the packed layout): d a_7 in one K=272 product.
  for (int i = tid; i < TM * (HP + W); i += NT) {
    const int r = i / (HP + W), c = i % (HP + W);
    bf16 h;
    if (c < HP) {
      h = __float2bfloat16(c < NDC ? s.g[r * OUT_W + 3 + c] : 0.f);
      ops[(size_t)r * OPW + O_GD + c] = h;
    } else {
      h = __float2bfloat16(s.stage[r * ST_LD + c - HP]);
      ops[(size_t)r * OPW + O_DBTL + c - HP] = h;
    }
    s.act[r * ACT_LD + c] = h;
  }
  __syncthreads();
  colsum_atomic(s.act + HP, ACT_LD, W, p.db + OFF_BB);
  tile_matmul<wmma::row_major>(s.act, ACT_LD, HP + W, p.w + OFF_WD, W, W,
                               s.stage, ST_LD);
  __syncthreads();

  // ---- trunk backward ----
  for (int i = tid; i < TM * XF; i += NT) s.dx[i] = 0.f;
  for (int layer = 7; layer >= 0; --layer) {
    for (int i = tid; i < TM * W; i += NT) {
      const int r = i / W, c = i % W;
      const bf16 dz = __float2bfloat16(mask_bit(s.mask, layer, r, c)
                                           ? s.stage[r * ST_LD + c] : 0.f);
      s.act[r * ACT_LD + c] = dz;
      ops[(size_t)r * OPW + O_DZ + layer * W + c] = dz;
    }
    __syncthreads();
    colsum_atomic(s.act, ACT_LD, W, p.db + OFF_BT + layer * W);
    const int K = trunk_in(layer);
    tile_matmul<wmma::row_major>(s.act, ACT_LD, W, p.w + trunk_offset(layer),
                                 K, K, s.stage, ST_LD);
    __syncthreads();
    if (layer == 5 || layer == 0) {
      const int c0 = layer == 5 ? W : 0;
      for (int i = tid; i < TM * XF; i += NT) {
        const int r = i / XF, j = i % XF;
        s.dx[i] += s.stage[r * ST_LD + c0 + j];
      }
      __syncthreads();
    }
  }
  // IPE backward of dx: cot_y = dx * att cos(y), cot_var = -dx * x / 2.
  for (int i = tid; i < TM * 6; i += NT) {
    const int r = i / 6, k = i % 6, d = k % 3;
    float acc = 0.f;
    for (int deg = 0; deg < XP / 3; ++deg) {
      for (int half = 0; half < 2; ++half) {
        const int j = half * XP + deg * 3 + d;
        const float dxj = s.dx[r * XF + j];
        if (k < 3) {
          acc += dxj * att_cos(s.x32 + r * XF, j) * ldexpf(1.f, deg + p.min_deg);
        } else {
          acc += -0.5f * dxj * s.x32[r * XF + j] * ldexpf(1.f, 2 * (deg + p.min_deg));
        }
      }
    }
    s.dmc[r * 8 + k] += acc;
  }
  __syncthreads();

  if constexpr (NORMALS) {
    // ---- recompute the sz-chain from the masks (as the forward) ----
    for (int i = tid; i < TM * W; i += NT) {
      const int r = i / W, c = i % W;
      const bf16 sz = mask_bit(s.mask, 7, r, c) ? p.w[OFF_WD + c]
                                                : __float2bfloat16(0.f);
      s.act[r * ACT_LD + c] = sz;
      ops[(size_t)r * OPW + O_SZ + 7 * W + c] = sz;
    }
    __syncthreads();
    for (int layer = 7; layer >= 0; --layer) {
      const int K = trunk_in(layer);
      tile_matmul<wmma::row_major>(s.act, ACT_LD, W, p.w + trunk_offset(layer),
                                   K, K, s.stage, ST_LD);
      __syncthreads();
      if (layer == 0) break;
      for (int i = tid; i < TM * W; i += NT) {
        const int r = i / W, c = i % W;
        const bf16 sz = mask_bit(s.mask, layer - 1, r, c)
                            ? __float2bfloat16(s.stage[r * ST_LD + c])
                            : __float2bfloat16(0.f);
        s.act[r * ACT_LD + c] = sz;
        ops[(size_t)r * OPW + O_SZ + (layer - 1) * W + c] = sz;
      }
      __syncthreads();
    }
    // g_x (rounded to bf16 as the TPU backward does); cotangents of the
    // IPE-side products: cot_dy = q . sel_y, cot_gx = cot_dy * c1 (bf16,
    // the walk's input at act columns 256..351), cot_c1 = cot_dy * g_x.
    for (int i = tid; i < TM * XF; i += NT) {
      const int r = i / XF, j = i % XF;
      const float gx = __bfloat162float(__float2bfloat16(
          s.stage[r * ST_LD + j] + s.stage[r * ST_LD + W + j]));
      const float cot_dy = s.q[r * 4 + (j % XP) % 3] * deg_scale(j, p.min_deg);
      const bf16 cgx = __float2bfloat16(cot_dy * att_cos(s.x32 + r * XF, j));
      s.act[r * ACT_LD + W + j] = cgx;
      ops[(size_t)r * OPW + O_CGX + j] = cgx;
      s.dx[i] = cot_dy * gx;  // cot_c1
    }
    __syncthreads();
    // IPE backward of cot_c1: cot_y -= cot_c1 * x, cot_var -= cot_c1 * c1 / 2.
    for (int i = tid; i < TM * 6; i += NT) {
      const int r = i / 6, k = i % 6, d = k % 3;
      float acc = 0.f;
      for (int deg = 0; deg < XP / 3; ++deg) {
        for (int half = 0; half < 2; ++half) {
          const int j = half * XP + deg * 3 + d;
          const float cc = s.dx[r * XF + j];
          if (k < 3) {
            acc -= cc * s.x32[r * XF + j] * ldexpf(1.f, deg + p.min_deg);
          } else {
            acc -= 0.5f * cc * att_cos(s.x32 + r * XF, j) *
                   ldexpf(1.f, 2 * (deg + p.min_deg));
          }
        }
      }
      s.dmc[r * 8 + k] += acc;
    }
    // ---- the adjoint walk, forward through the trunk ----
    // c_i = bf16(m_i * (c_{i-1} @ W_i^T)), with [c_4 | cot_gx] into layer 5
    // and cot_gx into layer 0.
    for (int layer = 0; layer < 8; ++layer) {
      const bf16* A = layer == 0 ? s.act + W : s.act;
      const int K = trunk_in(layer);
      tile_matmul<wmma::col_major>(A, ACT_LD, K, p.w + trunk_offset(layer), K,
                                   W, s.stage, ST_LD);
      __syncthreads();
      for (int i = tid; i < TM * W; i += NT) {
        const int r = i / W, c = i % W;
        const bf16 cv = __float2bfloat16(mask_bit(s.mask, layer, r, c)
                                             ? s.stage[r * ST_LD + c] : 0.f);
        s.act[r * ACT_LD + c] = cv;
        if (layer < 7) ops[(size_t)r * OPW + O_C + layer * W + c] = cv;
      }
      __syncthreads();
    }
    // s_7 is Wd's sigma row broadcast over the rows: its gradient is the
    // column sum of c_7.
    colsum_atomic(s.act, ACT_LD, W, p.dw + OFF_WD);
  }

  for (int i = tid; i < nrows * 8; i += NT) {
    p.dmc[(size_t)row0 * 8 + i] = (i & 7) < 6 ? s.dmc[i] : 0.f;
  }
}

// ---- weight gradients: dW[n, k] += sum_m B[m, n] A[m, k] (+ B2, A2) ----

struct Job {
  int b1, a1, b2, a2;  // operand column offsets in `ops` (b2 < 0: no pair 2)
  int n, k;            // output rows (fan-out) and columns (fan-in)
  int out, ldo;        // output offset in the packed f32 buffer, row stride
};
constexpr int MAX_JOBS = 16;

struct WgradParams {
  const bf16* ops;
  float* dw;
  int ld, rows, njobs;
  Job jobs[MAX_JOBS];
  int tile_start[MAX_JOBS + 1];
};

__global__ void __launch_bounds__(NT) fused_mlp_wgrad_kernel(WgradParams p) {
  __shared__ __align__(32) float scratch[NWARP][16 * 16];
  const int t = blockIdx.x;
  int j = 0;
  while (t >= p.tile_start[j + 1]) ++j;
  const Job jb = p.jobs[j];
  const int tiles_k = (jb.k + 63) / 64;
  const int tn = (t - p.tile_start[j]) / tiles_k;
  const int tk = (t - p.tile_start[j]) % tiles_k;
  const int m0 = blockIdx.y * WG_CHUNK;
  const int m1 = min(p.rows, m0 + WG_CHUNK);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int sub = warp; sub < 16; sub += NWARP) {
    const int n0 = tn * 64 + (sub >> 2) * 16;
    const int k0 = tk * 64 + (sub & 3) * 16;
    if (n0 >= jb.n || k0 >= jb.k) continue;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int pair = 0; pair < 2; ++pair) {
      const int bo = pair == 0 ? jb.b1 : jb.b2;
      const int ao = pair == 0 ? jb.a1 : jb.a2;
      if (bo < 0) continue;
      for (int m = m0; m < m1; m += 16) {
        const bf16* row = p.ops + (size_t)m * p.ld;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, row + bo + n0, p.ld);  // B^T: [n x m]
        wmma::load_matrix_sync(fb, row + ao + k0, p.ld);  // A:   [m x k]
        wmma::mma_sync(acc, fa, fb, acc);
      }
    }
    wmma::store_matrix_sync(scratch[warp], acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      atomicAdd(p.dw + jb.out + (size_t)(n0 + (e >> 4)) * jb.ldo + k0 + (e & 15),
                scratch[warp][e]);
    }
    __syncwarp();
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

extern "C" {

int fused_mlp_weight_count() { return W_TOTAL; }
int fused_mlp_bias_count() { return B_TOTAL; }
int fused_mlp_tile_rows() { return TM; }
int fused_mlp_ops_width(int normals) { return normals ? OPW_NRM : OPW_IPE; }

const char* fused_mlp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Forward over M rows; `acts` may be null (NORMALS only: saved trunk
// activations for the backward). Returns a cudaError_t (0 = ok).
int fused_mlp_forward(const float* mc, const void* v, const void* weights,
                      const float* biases, float* out, float* dsig, void* acts,
                      int M, int min_deg, int normals, void* stream) {
  if (M <= 0) return (int)cudaErrorInvalidValue;
  FwdParams p;
  p.mc = mc;
  p.v = static_cast<const bf16*>(v);
  p.w = static_cast<const bf16*>(weights);
  p.b = biases;
  p.out = out;
  p.dsig = dsig;
  p.acts = static_cast<bf16*>(acts);
  p.M = M;
  p.min_deg = min_deg;
  const int grid = (M + TM - 1) / TM;
  const int smem = (int)sizeof(SmemF);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (normals) {
    err = set_smem(fused_mlp_fwd_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    fused_mlp_fwd_kernel<true><<<grid, NT, smem, st>>>(p);
  } else {
    err = set_smem(fused_mlp_fwd_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    fused_mlp_fwd_kernel<false><<<grid, NT, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}

// Backward row pass: writes dmc, the operand rows `ops` ([ceil(M/64)*64,
// fused_mlp_ops_width(normals)] bf16) and adds the bias gradients (and, for
// NORMALS, the walk's part of dWd's sigma row) into the zeroed db / dw.
int fused_mlp_backward_rows(const float* mc, const void* v,
                            const void* weights, const float* biases,
                            const float* g, const float* q, const void* acts,
                            void* ops, float* dmc, float* dw, float* db, int M,
                            int min_deg, int normals, void* stream) {
  if (M <= 0) return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.mc = mc;
  p.v = static_cast<const bf16*>(v);
  p.w = static_cast<const bf16*>(weights);
  p.b = biases;
  p.g = g;
  p.q = q;
  p.acts = static_cast<const bf16*>(acts);
  p.ops = static_cast<bf16*>(ops);
  p.dmc = dmc;
  p.dw = dw;
  p.db = db;
  p.M = M;
  p.min_deg = min_deg;
  const int grid = (M + TM - 1) / TM;
  const int smem = (int)sizeof(SmemB);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (normals) {
    err = set_smem(fused_mlp_bwd_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    fused_mlp_bwd_kernel<true><<<grid, NT, smem, st>>>(p);
  } else {
    err = set_smem(fused_mlp_bwd_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    fused_mlp_bwd_kernel<false><<<grid, NT, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}

// Weight-gradient pass over the operand rows of fused_mlp_backward_rows:
// adds every packed weight's gradient into the f32 buffer dw.
int fused_mlp_weight_grads(const void* ops, float* dw, int M, int normals,
                           void* stream) {
  if (M <= 0) return (int)cudaErrorInvalidValue;
  const int nrm = normals != 0;
  const int none = -1;
  // {b1, a1, b2, a2, n, k, out, ldo}: B is the fan-out side (cotangents),
  // A the fan-in side (layer inputs).
  const Job jobs[] = {
      {O_DZ + 0 * W, O_X, nrm ? O_SZ + 0 * W : none, O_CGX, W, XF, OFF_W0, XF},
      {O_DZ + 1 * W, O_A + 0 * W, nrm ? O_SZ + 1 * W : none, O_C + 0 * W, W, W,
       OFF_W1 + 0 * W * W, W},
      {O_DZ + 2 * W, O_A + 1 * W, nrm ? O_SZ + 2 * W : none, O_C + 1 * W, W, W,
       OFF_W1 + 1 * W * W, W},
      {O_DZ + 3 * W, O_A + 2 * W, nrm ? O_SZ + 3 * W : none, O_C + 2 * W, W, W,
       OFF_W1 + 2 * W * W, W},
      {O_DZ + 4 * W, O_A + 3 * W, nrm ? O_SZ + 4 * W : none, O_C + 3 * W, W, W,
       OFF_W1 + 3 * W * W, W},
      {O_DZ + 5 * W, O_A + 4 * W, nrm ? O_SZ + 5 * W : none, O_C + 4 * W, W, W,
       OFF_W5, W + XF},
      {O_DZ + 5 * W, O_X, nrm ? O_SZ + 5 * W : none, O_CGX, W, XF, OFF_W5 + W,
       W + XF},
      {O_DZ + 6 * W, O_A + 5 * W, nrm ? O_SZ + 6 * W : none, O_C + 5 * W, W, W,
       OFF_W6 + 0 * W * W, W},
      {O_DZ + 7 * W, O_A + 6 * W, nrm ? O_SZ + 7 * W : none, O_C + 6 * W, W, W,
       OFF_W6 + 1 * W * W, W},
      {O_GD, O_A + 7 * W, none, none, HP, W, OFF_WD, W},
      {O_DBTL, O_A + 7 * W, none, none, W, W, OFF_WB, W},
      {O_DZV, O_BTL, none, none, VW, W, OFF_WV, VK},
      {O_DZV, O_V, none, none, VW, VP, OFF_WV + W, VK},
      {O_GR, O_HV, none, none, HP, VW, OFF_WC, VW},
  };
  WgradParams p;
  p.ops = static_cast<const bf16*>(ops);
  p.dw = dw;
  p.ld = nrm ? OPW_NRM : OPW_IPE;
  p.rows = ((M + TM - 1) / TM) * TM;
  p.njobs = (int)(sizeof(jobs) / sizeof(jobs[0]));
  p.tile_start[0] = 0;
  for (int j = 0; j < p.njobs; ++j) {
    p.jobs[j] = jobs[j];
    p.tile_start[j + 1] = p.tile_start[j] +
                          ((jobs[j].n + 63) / 64) * ((jobs[j].k + 63) / 64);
  }
  for (int j = p.njobs + 1; j <= MAX_JOBS; ++j) p.tile_start[j] = 1 << 30;
  dim3 grid(p.tile_start[p.njobs], (p.rows + WG_CHUNK - 1) / WG_CHUNK);
  fused_mlp_wgrad_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
