// The per-tile pieces of the training row kernels, shared by fused_mlp.cu
// (kernels 1, 2 and 3) and fused_render_train.cu (kernel 5): the IPE of
// the moments, the trunk (computed, or loaded from a bf16 spill), the
// heads, the MLP backward from a head cotangent and the IPE adjoint, and
// the column layout of the operand rows that the weight-gradient pass of
// fused_mlp.cu reduces.
//
// Each function works on one tile of TM = 64 rows held in shared memory
// by a block of NT threads; it is called by every thread of the block and
// ends in __syncthreads() where a later step reads what it wrote. `Smem`
// is any struct with the members the function names (act, stage, x32,
// dx, mask, hvmask, g, dmc), so a kernel allocates only what it uses.
#pragma once

#include "nerf_mlp.cuh"

namespace nerf_mlp {

constexpr int VP = 32;     // viewdir encoding width, padded (27 used)
constexpr int OUT_W = 16;  // raw output slab: rgb(3) | density(5) | 0(8)

// Columns of the backward's operand rows (bf16, all multiples of 16).
constexpr int O_X = 0;                // MLP input features x
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

// Load the moments of rows row0 .. row0 + nrows - 1 into stage[0 : 64*8]
// (zero past nrows) and build the IPE features: f32 in x32, bf16 at act
// columns 256..351. All 8 lanes of mc stay in the stage until the next
// product overwrites it.
__device__ void load_ipe(const float* mc, size_t row0, int nrows, int min_deg,
                         float* stage, float* x32, bf16* act) {
  const int tid = threadIdx.x;
  for (int i = tid; i < TM * 8; i += NT) {
    const int r = i >> 3;
    stage[i] = r < nrows ? mc[(row0 + r) * 8 + (i & 7)] : 0.f;
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

// Load already-encoded bf16 features x [., 96] into act columns 256..351
// (zero past nrows).
__device__ void load_encoded(const bf16* x, size_t row0, int nrows, bf16* act) {
  for (int i = threadIdx.x; i < TM * XF; i += NT) {
    const int r = i / XF, j = i % XF;
    act[r * ACT_LD + W + j] =
        r < nrows ? x[(row0 + r) * XF + j] : __float2bfloat16(0.f);
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

// Trunk: 8 x (Linear + ReLU) on the features at act columns 256..351, the
// skip input [h4 | x] into layer 5. Leaves a_7 in act columns 0..255 and
// the ReLU masks. With `copy` non-null, layer i's activation is also
// written to copy + i * 256 (row stride ld_copy, rows < nrows_copy).
template <class Smem>
__device__ void trunk_forward(Smem& s, const bf16* w, const float* b,
                              bf16* copy, size_t ld_copy, int nrows_copy) {
  for (int layer = 0; layer < 8; ++layer) {
    const bf16* A = layer == 0 ? s.act + W : s.act;
    const int K = trunk_in(layer);
    tile_matmul<wmma::col_major>(A, ACT_LD, K, w + trunk_offset(layer), K, W,
                                 s.stage, ST_LD);
    __syncthreads();
    relu_epilogue(s.stage, b + OFF_BT + layer * W, s.act, s.mask, layer,
                  copy != nullptr ? copy + layer * W : nullptr, ld_copy,
                  nrows_copy);
  }
}

// The trunk's activations from a bf16 spill [rows, 8 * 256] (acts points
// at the tile's first row; zero past nrows): masks, operand rows O_A and
// a_7 in act columns 0..255, as trunk_forward leaves them.
template <class Smem>
__device__ void trunk_load(Smem& s, const bf16* acts, int nrows, bf16* ops,
                           int opw) {
  const int lane = threadIdx.x & 31;
  for (int layer = 0; layer < 8; ++layer) {
    for (int i = threadIdx.x; i < TM * W; i += NT) {
      const int r = i / W, c = i % W;
      const bf16 h = r < nrows ? acts[(size_t)r * 8 * W + layer * W + c]
                               : __float2bfloat16(0.f);
      const unsigned bits = __ballot_sync(0xffffffffu, __bfloat162float(h) > 0.f);
      if (lane == 0) s.mask[(layer * TM + r) * MASK_WORDS + (c >> 5)] = bits;
      ops[(size_t)r * opw + O_A + layer * W + c] = h;
      if (layer == 7) s.act[r * ACT_LD + c] = h;
    }
    __syncthreads();
  }
}

// Heads on a_7 (act columns 0..255) and the viewdir codes v (v points at
// the tile's first row, [., 32] bf16; zero past nrows): bottleneck and
// view branch. With `outputs`, also the density and color heads: on
// return the stage holds raw rgb (+ bias) in columns 0..2 and raw density
// (+ bias) in columns 272..276. With OPS, the bottleneck, the viewdir
// codes and the view-branch activation go to their operand rows and the
// view branch's ReLU mask to s.hvmask.
template <bool OPS, class Smem>
__device__ void heads_forward(Smem& s, const bf16* w, const float* b,
                              const bf16* v, int nrows, bool outputs,
                              bf16* ops, int opw) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (outputs) {
    tile_matmul<wmma::col_major>(s.act, ACT_LD, W, w + OFF_WD, W, HP,
                                 s.stage + W, ST_LD);
  }
  tile_matmul<wmma::col_major>(s.act, ACT_LD, W, w + OFF_WB, W, W, s.stage,
                               ST_LD);
  __syncthreads();
  for (int i = tid; i < TM * W; i += NT) {
    const int r = i / W, c = i % W;
    const bf16 h = __float2bfloat16(s.stage[r * ST_LD + c] + b[OFF_BB + c]);
    s.act[r * ACT_LD + c] = h;
    if constexpr (OPS) ops[(size_t)r * opw + O_BTL + c] = h;
  }
  for (int i = tid; i < TM * VP; i += NT) {
    const int r = i / VP, j = i % VP;
    const bf16 vv = r < nrows ? v[(size_t)r * VP + j] : __float2bfloat16(0.f);
    s.act[r * ACT_LD + W + j] = vv;
    if constexpr (OPS) ops[(size_t)r * opw + O_V + j] = vv;
  }
  if (outputs) {
    // Raw density (+ bias) kept in the stage's spare columns 272..276
    // while the view branch reuses 0..127.
    for (int i = tid; i < TM * NDC; i += NT) {
      const int r = i / NDC, c = i % NDC;
      s.stage[r * ST_LD + W + HP + c] = s.stage[r * ST_LD + W + c] + b[OFF_BD + c];
    }
  }
  __syncthreads();
  tile_matmul<wmma::col_major>(s.act, ACT_LD, VK, w + OFF_WV, VK, VW, s.stage,
                               ST_LD);
  __syncthreads();
  for (int i = tid; i < TM * VW; i += NT) {
    const int r = i / VW, c = i % VW;
    const bf16 h =
        __float2bfloat16(fmaxf(s.stage[r * ST_LD + c] + b[OFF_BV + c], 0.f));
    if (outputs) s.act[r * ACT_LD + c] = h;
    if constexpr (OPS) {
      const unsigned bits = __ballot_sync(0xffffffffu, __bfloat162float(h) > 0.f);
      if (lane == 0) s.hvmask[r * (VW / 32) + (c >> 5)] = bits;
      ops[(size_t)r * opw + O_HV + c] = h;
    }
  }
  __syncthreads();
  if (!outputs) return;
  tile_matmul<wmma::col_major>(s.act, ACT_LD, VW, w + OFF_WC, VW, HP, s.stage,
                               ST_LD);
  __syncthreads();
  for (int i = tid; i < TM * 3; i += NT) {
    const int r = i / 3, c = i % 3;
    s.stage[r * ST_LD + c] += b[OFF_BC + c];
  }
  __syncthreads();
}

// MLP backward from the head cotangent s.g ([64 x 16] f32: rgb 0..2,
// density 3..7; zero on rows that must add nothing), after trunk_* and
// heads_forward filled the masks and the forward operand rows. Writes the
// cotangent operand rows, adds the bias gradients into db and leaves
// d x (f32 [64 x 96]) in s.dx.
template <class Smem>
__device__ void mlp_backward(Smem& s, const bf16* w, bf16* ops, int opw,
                             float* db) {
  const int tid = threadIdx.x;
  // ---- heads backward ----
  // Color-head cotangent (bf16, columns 0..2 of 16) as the A operand.
  for (int i = tid; i < TM * HP; i += NT) {
    const int r = i / HP, c = i % HP;
    const bf16 gr = __float2bfloat16(c < 3 ? s.g[r * OUT_W + c] : 0.f);
    s.act[r * ACT_LD + c] = gr;
    ops[(size_t)r * opw + O_GR + c] = gr;
  }
  // Head biases take the f32 cotangent: d bc, d bd.
  if (tid < 3 + NDC) {
    float acc = 0.f;
    for (int r = 0; r < TM; ++r) acc += s.g[r * OUT_W + tid];
    atomicAdd(db + (tid < 3 ? OFF_BC + tid : OFF_BD + tid - 3), acc);
  }
  __syncthreads();
  tile_matmul<wmma::row_major>(s.act, ACT_LD, HP, w + OFF_WC, VW, VW, s.stage,
                               ST_LD);  // d hv = gr @ Wc
  __syncthreads();
  for (int i = tid; i < TM * VW; i += NT) {
    const int r = i / VW, c = i % VW;
    const bool on = (s.hvmask[r * (VW / 32) + (c >> 5)] >> (c & 31)) & 1u;
    const bf16 dz = __float2bfloat16(on ? s.stage[r * ST_LD + c] : 0.f);
    s.act[r * ACT_LD + c] = dz;
    ops[(size_t)r * opw + O_DZV + c] = dz;
  }
  __syncthreads();
  colsum_atomic(s.act, ACT_LD, VW, db + OFF_BV);
  tile_matmul<wmma::row_major>(s.act, ACT_LD, VW, w + OFF_WV, VK, W, s.stage,
                               ST_LD);  // d btl = dzv @ Wv[:, :256]
  __syncthreads();
  // A operand [gd (16) | dbtl (256)] against the stacked [Wd ; Wb]
  // (contiguous in the packed layout): d a_7 in one K=272 product.
  for (int i = tid; i < TM * (HP + W); i += NT) {
    const int r = i / (HP + W), c = i % (HP + W);
    bf16 h;
    if (c < HP) {
      h = __float2bfloat16(c < NDC ? s.g[r * OUT_W + 3 + c] : 0.f);
      ops[(size_t)r * opw + O_GD + c] = h;
    } else {
      h = __float2bfloat16(s.stage[r * ST_LD + c - HP]);
      ops[(size_t)r * opw + O_DBTL + c - HP] = h;
    }
    s.act[r * ACT_LD + c] = h;
  }
  __syncthreads();
  colsum_atomic(s.act + HP, ACT_LD, W, db + OFF_BB);
  tile_matmul<wmma::row_major>(s.act, ACT_LD, HP + W, w + OFF_WD, W, W,
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
      ops[(size_t)r * opw + O_DZ + layer * W + c] = dz;
    }
    __syncthreads();
    colsum_atomic(s.act, ACT_LD, W, db + OFF_BT + layer * W);
    const int K = trunk_in(layer);
    tile_matmul<wmma::row_major>(s.act, ACT_LD, W, w + trunk_offset(layer), K,
                                 K, s.stage, ST_LD);
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
}

// IPE backward of s.dx: cot_y = dx * att cos(y), cot_var = -dx * x / 2,
// added into lanes 0..5 (means, covs) of s.dmc [64 x 8].
template <class Smem>
__device__ void ipe_backward(Smem& s, int min_deg) {
  for (int i = threadIdx.x; i < TM * 6; i += NT) {
    const int r = i / 6, k = i % 6, d = k % 3;
    float acc = 0.f;
    for (int deg = 0; deg < XP / 3; ++deg) {
      for (int half = 0; half < 2; ++half) {
        const int j = half * XP + deg * 3 + d;
        const float dxj = s.dx[r * XF + j];
        if (k < 3) {
          acc += dxj * att_cos(s.x32 + r * XF, j) * ldexpf(1.f, deg + min_deg);
        } else {
          acc += -0.5f * dxj * s.x32[r * XF + j] * ldexpf(1.f, 2 * (deg + min_deg));
        }
      }
    }
    s.dmc[r * 8 + k] += acc;
  }
  __syncthreads();
}

}  // namespace nerf_mlp
