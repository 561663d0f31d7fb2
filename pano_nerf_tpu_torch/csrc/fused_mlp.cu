// NerfMLP forward and backward for training on the H100: on raw Gaussian
// moments (with the IPE inside, with and without the density-gradient
// chain) or on already-encoded features.
//
// Replaces three TPU kernels, one template variant each way (Variant):
//  * IPE: `fused_mlp_ipe_apply` (pano_nerf_tpu/kernels/fused_mlp_ipe.py:268;
//    `_fwd_kernel` :109, `_bwd_ipe_kernel` :124).
//  * NORMALS: `fused_mlp_normals_apply` (pano_nerf_tpu/kernels/
//    fused_mlp_normals.py:369; `_sigma_grad_chain` :71, `_fwd_kernel` :94,
//    `_bwd_kernel` :132). The forward also returns d raw_sigma / d means and
//    saves the 8 trunk activations (bf16 [M, 8*256]) for the backward.
//  * ENCODED: `fused_mlp_apply` (pano_nerf_tpu/kernels/fused_mlp.py:363;
//    `_fwd_kernel` :198, `_bwd_kernel` :238). The input is x [M, 96] bf16
//    IPE features instead of moments, and the backward writes d x [M, 96]
//    f32 instead of d moments.
//
// Rows are Gaussian moments mc [M, 8] = means(3) | covs(3) | pad(2), f32
// (or x for ENCODED), and per-row viewdir encodings v [M, 32] bf16 (27
// used). The output slab is [M, 16] f32: raw rgb (3) | raw density (5) | 0.
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
//   kernel does, and keep ReLU masks as bits. The per-tile steps live in
//   mlp_rows.cuh, shared with kernel 5 (fused_render_train.cu).
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

#include "mlp_rows.cuh"

namespace {

using namespace nerf_mlp;

enum Variant { IPE = 0, NORMALS = 1, ENCODED = 2 };

constexpr int WG_CHUNK = 2048;      // rows per weight-gradient grid row

struct FwdParams {
  const float* mc;   // [M, 8]        (IPE, NORMALS)
  const bf16* x;     // [M, 96]       (ENCODED)
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
  const bf16* x;
  const bf16* v;
  const bf16* w;
  const float* b;
  const float* g;     // [M, 16] cotangent of the output slab
  const float* q;     // [M, 3] cotangent of dsig (NORMALS)
  const bf16* acts;   // [M, 8 * 256] saved by the forward (NORMALS)
  bf16* ops;          // [grid * 64, OPW] operand rows
  float* dmc;         // [M, 8]   (IPE, NORMALS)
  float* dx;          // [M, 96]  (ENCODED)
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

template <int VAR>
__global__ void __launch_bounds__(NT, 1) fused_mlp_fwd_kernel(FwdParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemF& s = *reinterpret_cast<SmemF*>(smem_raw);
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * TM;
  const int nrows = min(TM, p.M - (int)row0);

  if constexpr (VAR == ENCODED) {
    load_encoded(p.x, row0, nrows, s.act);
  } else {
    load_ipe(p.mc, row0, nrows, p.min_deg, s.stage, s.x32, s.act);
  }
  bf16* copy = (VAR == NORMALS && p.acts != nullptr) ? p.acts + row0 * 8 * W
                                                     : nullptr;
  trunk_forward(s, p.w, p.b, copy, 8 * W, nrows);
  heads_forward<false>(s, p.w, p.b, p.v + row0 * VP, nrows, true, nullptr,
                       0);
  for (int i = tid; i < nrows * OUT_W; i += NT) {
    const int r = i / OUT_W, c = i % OUT_W;
    const float* st = s.stage + r * ST_LD;
    float o = 0.f;
    if (c < 3) o = st[c];
    else if (c < 3 + NDC) o = st[W + HP + c - 3];
    p.out[(row0 + r) * OUT_W + c] = o;
  }
  if constexpr (VAR != NORMALS) return;
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
    p.dsig[(row0 + r) * 3 + d] = acc;
  }
}

template <int VAR>
__global__ void __launch_bounds__(NT, 1) fused_mlp_bwd_kernel(BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemB& s = *reinterpret_cast<SmemB*>(smem_raw);
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * TM;
  const int nrows = min(TM, p.M - (int)row0);
  constexpr int OPW = VAR == NORMALS ? OPW_NRM : OPW_IPE;
  bf16* ops = p.ops + row0 * OPW;  // this tile's 64 operand rows

  // ---- inputs: cotangents (zero past M), moments and IPE, or x ----
  for (int i = tid; i < TM * OUT_W; i += NT) {
    const int r = i / OUT_W;
    s.g[i] = r < nrows ? p.g[(row0 + r) * OUT_W + i % OUT_W] : 0.f;
  }
  if constexpr (VAR == NORMALS) {
    for (int i = tid; i < TM * 4; i += NT) {
      const int r = i >> 2, d = i & 3;
      s.q[i] = (r < nrows && d < 3) ? p.q[(row0 + r) * 3 + d] : 0.f;
    }
  }
  for (int i = tid; i < TM * 8; i += NT) s.dmc[i] = 0.f;
  if constexpr (VAR == ENCODED) {
    load_encoded(p.x, row0, nrows, s.act);
  } else {
    load_ipe(p.mc, row0, nrows, p.min_deg, s.stage, s.x32, s.act);
  }
  for (int i = tid; i < TM * XF; i += NT) {
    const int r = i / XF, j = i % XF;
    ops[(size_t)r * OPW + O_X + j] = s.act[r * ACT_LD + W + j];
  }

  // ---- trunk activations: saved (NORMALS) or recomputed ----
  if constexpr (VAR == NORMALS) {
    trunk_load(s, p.acts + row0 * 8 * W, nrows, ops, OPW);
  } else {
    trunk_forward(s, p.w, p.b, ops + O_A, OPW, TM);
  }
  // ---- heads forward (operand rows, masks of hv), then the backward ----
  heads_forward<true>(s, p.w, p.b, p.v + row0 * VP, nrows, false, ops, OPW);
  mlp_backward(s, p.w, ops, OPW, p.db);
  if constexpr (VAR == ENCODED) {
    for (int i = tid; i < nrows * XF; i += NT) p.dx[row0 * XF + i] = s.dx[i];
    return;
  }
  ipe_backward(s, p.min_deg);

  if constexpr (VAR == NORMALS) {
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
    p.dmc[row0 * 8 + i] = (i & 7) < 6 ? s.dmc[i] : 0.f;
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

template <int VAR>
cudaError_t launch_forward(const FwdParams& p, cudaStream_t st) {
  const int smem = (int)sizeof(SmemF);
  cudaError_t err = set_smem(fused_mlp_fwd_kernel<VAR>, smem);
  if (err != cudaSuccess) return err;
  fused_mlp_fwd_kernel<VAR><<<(p.M + TM - 1) / TM, NT, smem, st>>>(p);
  return cudaGetLastError();
}

template <int VAR>
cudaError_t launch_backward(const BwdParams& p, cudaStream_t st) {
  const int smem = (int)sizeof(SmemB);
  cudaError_t err = set_smem(fused_mlp_bwd_kernel<VAR>, smem);
  if (err != cudaSuccess) return err;
  fused_mlp_bwd_kernel<VAR><<<(p.M + TM - 1) / TM, NT, smem, st>>>(p);
  return cudaGetLastError();
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

// Forward over M rows of moments; `acts` may be null (NORMALS only: saved
// trunk activations for the backward). Returns a cudaError_t (0 = ok).
int fused_mlp_forward(const float* mc, const void* v, const void* weights,
                      const float* biases, float* out, float* dsig, void* acts,
                      int M, int min_deg, int normals, void* stream) {
  if (M <= 0) return (int)cudaErrorInvalidValue;
  FwdParams p = {};
  p.mc = mc;
  p.v = static_cast<const bf16*>(v);
  p.w = static_cast<const bf16*>(weights);
  p.b = biases;
  p.out = out;
  p.dsig = dsig;
  p.acts = static_cast<bf16*>(acts);
  p.M = M;
  p.min_deg = min_deg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(normals ? launch_forward<NORMALS>(p, st)
                       : launch_forward<IPE>(p, st));
}

// Forward over M rows of encoded features x [M, 96] bf16 (kernel 1).
int fused_mlp_encoded_forward(const void* x, const void* v,
                              const void* weights, const float* biases,
                              float* out, int M, void* stream) {
  if (M <= 0) return (int)cudaErrorInvalidValue;
  FwdParams p = {};
  p.x = static_cast<const bf16*>(x);
  p.v = static_cast<const bf16*>(v);
  p.w = static_cast<const bf16*>(weights);
  p.b = biases;
  p.out = out;
  p.M = M;
  return (int)launch_forward<ENCODED>(p, static_cast<cudaStream_t>(stream));
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
  BwdParams p = {};
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(normals ? launch_backward<NORMALS>(p, st)
                       : launch_backward<IPE>(p, st));
}

// Backward row pass of kernel 1: writes dx [M, 96] f32, the operand rows
// (fused_mlp_ops_width(0) wide) and adds the bias gradients into db.
int fused_mlp_encoded_backward_rows(const void* x, const void* v,
                                    const void* weights, const float* biases,
                                    const float* g, void* ops, float* dx,
                                    float* db, int M, void* stream) {
  if (M <= 0) return (int)cudaErrorInvalidValue;
  BwdParams p = {};
  p.x = static_cast<const bf16*>(x);
  p.v = static_cast<const bf16*>(v);
  p.w = static_cast<const bf16*>(weights);
  p.b = biases;
  p.g = g;
  p.ops = static_cast<bf16*>(ops);
  p.dx = dx;
  p.db = db;
  p.M = M;
  return (int)launch_backward<ENCODED>(p, static_cast<cudaStream_t>(stream));
}

// Weight-gradient pass over the operand rows of a backward row pass (this
// library's or fused_render_train's): adds every packed weight's gradient
// into the f32 buffer dw. M is the number of operand rows.
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
