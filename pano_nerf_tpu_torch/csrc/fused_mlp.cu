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
//    saves the 8 trunk activations (bf16 [M, 8*W]) for the backward.
//  * ENCODED: `fused_mlp_apply` (pano_nerf_tpu/kernels/fused_mlp.py:363;
//    `_fwd_kernel` :198, `_bwd_kernel` :238). The input is x [M, XF] bf16
//    IPE features instead of moments, and the backward writes d x [M, XF]
//    f32 instead of d moments.
//
// Rows are Gaussian moments mc [M, 8] = means(3) | covs(3) | pad(2), f32
// (or x for ENCODED), and per-row viewdir encodings v [M, VP] bf16 (VF
// used). The output slab is [M, 16] f32: raw rgb (3) | raw density (NDC)
// | 0. The MLP's shape (density channels NDC, widths W and VW, IPE degrees
// L, viewdir encoding VF) is fixed per build (nerf_mlp.cuh): the library
// is built once per shape a model asks for (kernels/fused_mlp_ipe.py
// `MlpShape`); the backward zeroes the head cotangent past NDC, so padded
// lanes add nothing to the density head's gradient. The sizes below are
// the shipped shape's (W 256, VW 128, L 16); a 512-wide build runs the
// same steps column split at N = 512 (two ring stages per K step,
// mlp_rows.cuh `mm`), with 2 ring stages and the f32 IPE features
// recomputed from the moments (`feat`).
//
// The backward is two launches, and each has its own bound on an H100:
// * The row pass (fused_mlp_bwd_kernel) recomputes the forward (or loads
//   the saved trunk, NORMALS), runs the data gradients and, for NORMALS,
//   the chain and its adjoint walk: tensor-core operations, 1.22 M MACs
//   per row for IPE (0.035 ms per 28,672 rows at 989 TFLOP/s) and 2.0 M
//   for NORMALS; and it writes every operand of every weight-gradient
//   product as bf16 rows (`ops`: 10 KB per row IPE, 17.5 KB NORMALS, so
//   >= 0.086 / 0.153 ms at 3.35 TB/s). The bytes bound it.
// * The weight-gradient pass (fused_mlp_wgrad_kernel) reads `ops` once
//   and does the 0.6 M (IPE) / 1.1 M (NORMALS) weight-gradient MACs per
//   row: bytes again, the same 0.086 / 0.153 ms.
// Blocks run in parallel and in no order, so the TPU kernel's in-order
// `+=` of dW over the grid has no counterpart; the operand rows are the
// price of that, against a weight-gradient reduction inside the row pass
// that would need 616 K f32 partials per 64-row tile.
//
// Design. Row kernels (mlp_rows.cuh has the details): one block of two
// consumer warpgroups and a producer warpgroup per 64-row tile; wgmma products
// with the activation tile in 128-byte-swizzled shared memory as A and the
// weights streamed by TMA through a 3-slice ring; epilogues from
// registers; 64-column operand rows written by TMA stores of the tile.
// Epilogues round to bf16 where the TPU kernel does, and keep ReLU masks
// as bits. The weight-gradient pass is a TMA + wgmma GEMM (below). For
// NORMALS each trunk weight gets two contributions, the standard backward
// (dz_i^T a_{i-1}) and the adjoint walk (sz_i^T c_{i-1}), summed in one
// accumulator. Ragged last tile: rows past M are loaded as zeros (inputs,
// cotangents and saved activations), so their dz, sz and c rows are
// exactly zero and add nothing to any weight gradient. The f32 sums
// across blocks (bias sums, dW partials) add in a fixed order
// (mlp_rows.cuh `bias_sums`; the weight-gradient pass's chunks in chunk
// order), so a backward gives the same bits at every run; the wrapper
// rounds weight gradients to bf16, as both JAX paths do. IPE phases are exact power-of-two products
// (ldexpf) with the accurate sinf/expf; do not build with --use_fast_math.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// point (pano_nerf_tpu_torch/kernels/build.py).

#include "mlp_rows.cuh"

namespace {

using namespace nerf_mlp;

enum Variant { IPE = 0, NORMALS = 1, ENCODED = 2 };

struct FwdParams {
  const float* mc;   // [M, 8]        (IPE, NORMALS)
  const bf16* x;     // [M, XF]       (ENCODED)
  const bf16* v;     // [M, VP]
  const bf16* w;
  const float* b;
  float* out;        // [M, 16]
  float* dsig;       // [M, 3]        (NORMALS)
  bf16* acts;        // [M, 8 * W]    (NORMALS, may be null)
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
  bf16* ops;          // [grid * 64, OPW] operand rows
  float* dmc;         // [M, 8]   (IPE, NORMALS)
  float* dx;          // [M, XF]  (ENCODED)
  BiasSums sums;      // db and (NORMALS) dWd's sigma row, written
  int M, min_deg;
};

struct SmemF {
  alignas(1024) bf16 act[TM * 64 * ACT_BLOCKS];
  alignas(1024) unsigned char ring[RING * SLICE];
  uint32_t mask[8 * MWC * NT];
  float x32[X32_ELEMS];
  float gx[TM * XF];       // NORMALS: d raw_sigma / d x
  float mc[TM * 8];
  float heads[TM * OUT_W];
  uint64_t full[RING], empty[RING], io;
};

struct SmemB {
  alignas(1024) bf16 act[TM * 64 * ACT_BLOCKS];
  alignas(1024) unsigned char ring[RING * SLICE];
  uint32_t mask[8 * MWC * NT];
  uint32_t hvmask[HVW * NT];
  float x32[X32_ELEMS];
  float dx[TM * XF];      // d x; later the cotangent of c1 (NORMALS)
  float g[TM * OUT_W];
  float q[TM * 4];
  float dmc[TM * 8];
  float mc[TM * 8];
  uint64_t full[RING], empty[RING], io;
};
static_assert(sizeof(SmemF) + 1024 <= SMEM_LIMIT, "forward shared memory");
static_assert(sizeof(SmemB) + 1024 <= SMEM_LIMIT, "backward shared memory");

template <class Smem>
__device__ Smem& smem_of(unsigned char* raw) {
  return *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                  ~uintptr_t(1023));
}

template <int VAR, bool PRODUCER>
__device__ void fwd_tile(SmemF& s, const FwdParams& p, const Maps& maps,
                         Pipe<PRODUCER>& pp, size_t row0, int nrows) {
  const int tid = threadIdx.x;
  if constexpr (!PRODUCER) {
    if constexpr (VAR == ENCODED) {
      load_encoded(s, p.x, row0, nrows);
    } else {
      load_ipe(s, p.mc, row0, nrows, p.min_deg);
    }
  }
  const TrunkOut spill{&maps.acts, nullptr, 0, 0, (int)row0, 0};
  trunk_forward(pp, s, p.b,
                VAR == NORMALS && p.acts != nullptr ? &spill : nullptr);
  heads_forward<false, true>(pp, s, p.b, p.v + row0 * VP, nrows, nullptr, 0,
                             nullptr, 0);
  if constexpr (!PRODUCER) {
    for (int i = tid; i < nrows * OUT_W; i += NT) {
      const int c = i % OUT_W;
      p.out[row0 * OUT_W + i] = c < 3 + NDC ? s.heads[i] : 0.f;
    }
  }
  if constexpr (VAR != NORMALS) return;

  // ---- d raw_sigma / d means: sz-chain through the masked trunk ----
  const int g = wg();
  density_chain(pp, s, p.w, [&](int layer, const float (&part)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = g * 64 + frag_col(i);
      if (j < XF) {
        float* d = s.gx + frag_row(i) * XF + j;
        *d = layer == 5 ? part[i] : *d + part[i];
      }
    }
  });
  if constexpr (!PRODUCER) {
    consumer_sync();
    for (int i = tid; i < nrows * 3; i += NT) {
      const int r = i / 3, d = i % 3;
      float a = 0.f;
      for (int deg = 0; deg < L; ++deg) {
        for (int half = 0; half < 2; ++half) {
          const int j = half * XP + deg * 3 + d;
          a += s.gx[r * XF + j] * feat_cos(s, r, j, p.min_deg) *
               ldexpf(1.f, deg + p.min_deg);
        }
      }
      p.dsig[(row0 + r) * 3 + d] = a;
    }
  }
}

template <int VAR>
__global__ void __launch_bounds__(ROW_THREADS, 1)
    fused_mlp_fwd_kernel(const __grid_constant__ Maps maps,
                         const __grid_constant__ FwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  SmemF& s = smem_of<SmemF>(smem_raw);
  pipe_init(s);
  const size_t row0 = (size_t)blockIdx.x * TM;
  const int nrows = min(TM, p.M - (int)row0);
  run_roles(s, &maps, [&](auto& pp) { fwd_tile<VAR>(s, p, maps, pp, row0, nrows); });
}

template <int VAR, bool PRODUCER>
__device__ void bwd_tile(SmemB& s, const BwdParams& p, const Maps& maps,
                         Pipe<PRODUCER>& pp, size_t row0, int nrows) {
  const int tid = threadIdx.x;
  constexpr int OPW = VAR == NORMALS ? OPW_NRM : OPW_IPE;
  bf16* ops = p.ops + row0 * OPW;  // this tile's 64 operand rows
  const int orow = (int)row0;

  // ---- inputs: cotangents (zero past M), moments and IPE, or x ----
  if constexpr (!PRODUCER) {
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
      load_encoded(s, p.x, row0, nrows);
    } else {
      load_ipe(s, p.mc, row0, nrows, p.min_deg);
    }
    copy_cols(s.act, W, XF, ops + O_X, OPW, TM);
  }

  // ---- trunk activations: saved (NORMALS) or recomputed ----
  if constexpr (VAR == NORMALS) {
    if constexpr (!PRODUCER) trunk_load(s, &maps.acts, orow, nrows, &maps.ops, orow);
  } else {
    const TrunkOut out{&maps.ops, nullptr, 0, O_A, orow, 0};
    trunk_forward(pp, s, p.b, &out);
  }
  // ---- heads forward (operand rows, masks of hv), then the backward ----
  heads_forward<true, false>(pp, s, p.b, p.v + row0 * VP, nrows, &maps.ops,
                             orow, ops, OPW);
  mlp_backward(pp, s, part_row(p.sums), &maps.ops, orow, ops, OPW);
  if constexpr (VAR == ENCODED) {
    if constexpr (!PRODUCER) {
      for (int i = tid; i < nrows * XF; i += NT) p.dx[row0 * XF + i] = s.dx[i];
      bias_sums(p.sums);
    }
    return;
  }
  if constexpr (!PRODUCER) ipe_backward(s, p.min_deg);

  if constexpr (VAR == NORMALS) {
    const int g = wg();
    // ---- recompute the sz-chain from the masks (as the forward) ----
    if constexpr (!PRODUCER) {
      pre_epilogue();
      chain_start(s, p.w);
      post_epilogue();
      store_blocks(s.act, 0, W / 64, &maps.ops, O_SZ + 7 * W, orow);
    }
    float acc[W / 4], sk5[32], sk0[32];
    for (int layer = 7; layer >= 0; --layer) {
      if (layer == 5) mm<64, 1>(pp, trunk_prod(5, true, W, 128), sk5, s.act, 0);
      if (layer == 0) {
        mm<64, 1>(pp, trunk_prod(0, true, 0, 128), sk0, s.act, 0);
        break;
      }
      mm<W / 2, 1>(pp, trunk_prod(layer, true), acc, s.act, 0);
      if constexpr (!PRODUCER) {
        pre_epilogue();
        masked_epilogue(s, acc, layer - 1);
        post_epilogue();
        store_blocks(s.act, 0, W / 64, &maps.ops, O_SZ + (layer - 1) * W,
                     orow);
      }
    }
    if constexpr (!PRODUCER) {
      // g_x (rounded to bf16 as the TPU backward does); cotangents of the
      // IPE-side products: cot_dy = q . sel_y, cot_gx = cot_dy * c1 (bf16,
      // the walk's input at act columns W..W+XF-1), cot_c1 = cot_dy * g_x;
      // both zero on the padded feature columns.
      pre_epilogue();
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int j = g * 64 + frag_col(i), r = frag_row(i);
        if (j < XF) {
          float cg[2];
          for (int h = 0; h < 2; ++h) {
            if constexpr (2 * XP < XF) {
              if (j + h >= 2 * XP) {
                cg[h] = 0.f;
                s.dx[r * XF + j + h] = 0.f;
                continue;
              }
            }
            const float gx = __bfloat162float(
                __float2bfloat16(sk5[i + h] + sk0[i + h]));
            const float cot_dy =
                s.q[r * 4 + ((j + h) % XP) % 3] * deg_scale(j + h, p.min_deg);
            cg[h] = cot_dy * feat_cos(s, r, j + h, p.min_deg);
            s.dx[r * XF + j + h] = cot_dy * gx;  // cot_c1
          }
          act_put2(s.act, r, W + j, cg[0], cg[1]);
        }
      }
      post_epilogue();
      copy_cols(s.act, W, XF, ops + O_CGX, OPW, TM);
      // IPE backward of cot_c1: cot_y -= cot_c1 * x, cot_var -= cot_c1 c1 / 2.
      for (int i = tid; i < TM * 6; i += NT) {
        const int r = i / 6, k = i % 6, d = k % 3;
        float a = 0.f;
        for (int deg = 0; deg < L; ++deg) {
          for (int half = 0; half < 2; ++half) {
            const int j = half * XP + deg * 3 + d;
            const float cc = s.dx[r * XF + j];
            if (k < 3) {
              a -= cc * feat(s, r, j, p.min_deg) * ldexpf(1.f, deg + p.min_deg);
            } else {
              a -= 0.5f * cc * feat_cos(s, r, j, p.min_deg) *
                   ldexpf(1.f, 2 * (deg + p.min_deg));
            }
          }
        }
        s.dmc[r * 8 + k] += a;
      }
    }
    // ---- the adjoint walk, forward through the trunk ----
    // c_i = bf16(m_i * (c_{i-1} @ W_i^T)), with [c_4 | cot_gx] into layer 5
    // and cot_gx into layer 0.
    for (int layer = 0; layer < 8; ++layer) {
      mm<W / 2, 0>(pp, trunk_prod(layer, false), acc, s.act,
                   layer == 0 ? W : 0);
      if constexpr (!PRODUCER) {
        pre_epilogue();
        masked_epilogue(s, acc, layer);
        post_epilogue();
        if (layer < 7) {
          store_blocks(s.act, 0, W / 64, &maps.ops, O_C + layer * W, orow);
        }
      }
    }
    // s_7 is Wd's sigma row broadcast over the rows: its gradient is the
    // column sum of c_7.
    if constexpr (!PRODUCER) {
      colsum_store(s.act, 0, W, part_row(p.sums) + B_TOTAL);
    }
  }
  if constexpr (!PRODUCER) {
    consumer_sync();
    for (int i = tid; i < nrows * 8; i += NT) {
      p.dmc[row0 * 8 + i] = (i & 7) < 6 ? s.dmc[i] : 0.f;
    }
    bias_sums(p.sums);
  }
}

template <int VAR>
__global__ void __launch_bounds__(ROW_THREADS, 1)
    fused_mlp_bwd_kernel(const __grid_constant__ Maps maps,
                         const __grid_constant__ BwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  SmemB& s = smem_of<SmemB>(smem_raw);
  pipe_init(s);
  const size_t row0 = (size_t)blockIdx.x * TM;
  const int nrows = min(TM, p.M - (int)row0);
  run_roles(s, &maps, [&](auto& pp) { bwd_tile<VAR>(s, p, maps, pp, row0, nrows); });
}

// ---- weight gradients: dW[n, k] += sum_m B[m, n] A[m, k] (+ B2, A2) ----
//
// One block per (output tile of 128 fan-out rows x up to 256 fan-in
// columns, chunk of operand rows). One thread of a producer warpgroup
// streams the tile's operand slabs through a 4-stage ring by TMA (boxes of
// 64 rows x 64 columns, 128-byte swizzle): per stage 64 rows of B (two
// boxes, 128 columns) and of A (up to four boxes). Two consumer warpgroups each own
// 64 output rows and run wgmma m64n256k16 on them, both operands MN-major
// in shared memory (the reduction runs over the rows of `ops`), f32
// accumulators in registers. The partial tile goes through shared memory
// and is added into dw in chunk order: each output tile has a flag in
// `sync` that holds the number of chunks added so far, and the block of
// chunk c waits for c before adding its partial and setting c + 1. A block
// takes its (tile, chunk) from a counter (`sync[0]`) when it starts, chunk
// by chunk, so the block it waits for has started before it and none can
// wait on a block that is not running. The jobs (which operand columns
// make which packed weight) come from the caller: kernels/fused_mlp_ipe.py
// `wgrad_jobs`, the one table the plain version runs too.

struct Job {
  int b1, a1, b2, a2;  // operand column offsets in `ops` (b2 < 0: no pair 2)
  int n, k;            // output rows (fan-out) and columns (fan-in, <= 256)
  int out, ldo;        // output offset in the packed f32 buffer, row stride
};
constexpr int MAX_JOBS = 32;  // 24 at W 512 (fan-ins split at 256)
constexpr int WG_NS = 4;                    // ring stages
constexpr int WG_BOX = 64 * 64 * 2;         // one TMA box, bytes
constexpr int WG_STAGE = 6 * WG_BOX;        // 2 boxes of B + 4 of A
constexpr int WG_ST_LD = 264;               // f32 partial-tile row stride
constexpr int WG_SMEM = WG_NS * WG_STAGE + 1024;
constexpr int WG_THREADS = 384;             // 2 consumer warpgroups + producer
constexpr int WG_MAX_ROWS = 32768;          // operand rows of one chunk, at most

struct WgradParams {
  float* dw;
  int* sync;  // [1 + tiles] zeroed: the block counter, then a flag per tile
  int rows, chunk_rows, njobs;
  Job jobs[MAX_JOBS];
  int tile_start[MAX_JOBS + 1];  // first output tile of each job
};

__global__ void __launch_bounds__(WG_THREADS, 1)
    fused_mlp_wgrad_kernel(const __grid_constant__ CUtensorMap ops_map,
                           const __grid_constant__ WgradParams p) {
  extern __shared__ unsigned char wg_smem_raw[];
  __shared__ __align__(8) uint64_t full[WG_NS], empty[WG_NS];
  __shared__ int start;
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < WG_NS; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
    start = atomicAdd(p.sync, 1);  // the block's place in start order
  }
  __syncthreads();
  const int order = start;
  const int t = order % gridDim.x, chunk = order / gridDim.x;
  int j = 0;
  while (t >= p.tile_start[j + 1]) ++j;
  const Job jb = p.jobs[j];
  const int n0 = (t - p.tile_start[j]) * 128;
  const int m0 = chunk * p.chunk_rows;
  const int steps = (min(p.rows, m0 + p.chunk_rows) - m0) / 64;
  const int niter = (jb.b2 >= 0 ? 2 : 1) * steps;
  const int nb = jb.n - n0 > 64 ? 2 : 1;  // boxes of B (64 output rows each)
  const int na = (jb.k + 63) / 64;         // boxes of A

  if (tid >= 256) {  // ---- producer warpgroup: one thread issues TMA ----
    hopper::reg_dealloc<40>();
    if (tid == 256) {
      for (int it = 0; it < niter; ++it) {
        const int st = it % WG_NS;
        if (it >= WG_NS) hopper::mbar_wait(&empty[st], ((it / WG_NS) - 1) & 1);
        const int pair = it / steps;
        const int row = m0 + (it % steps) * 64;
        const int bo = pair ? jb.b2 : jb.b1, ao = pair ? jb.a2 : jb.a1;
        unsigned char* buf = ring + st * WG_STAGE;
        hopper::mbar_expect_tx(&full[st], (nb + na) * WG_BOX);
        for (int i = 0; i < nb; ++i) {
          hopper::tma_load(buf + i * WG_BOX, &ops_map, &full[st],
                           bo + n0 + 64 * i, row);
        }
        for (int i = 0; i < na; ++i) {
          hopper::tma_load(buf + (2 + i) * WG_BOX, &ops_map, &full[st],
                           ao + 64 * i, row);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 output rows each ----
  hopper::reg_alloc<232>();
  const int g = tid >> 7;
  const bool active = n0 + 64 * g < jb.n;
  float acc[128];
  for (int it = 0; it < niter; ++it) {
    const int st = it % WG_NS;
    hopper::mbar_wait(&full[st], (it / WG_NS) & 1);
    if (active) {
      const unsigned char* buf = ring + st * WG_STAGE;
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {  // 16 operand rows per product
        const uint64_t da = hopper::desc_sw128(buf + g * WG_BOX + ks * 2048,
                                               WG_BOX, 1024);
        const uint64_t db = hopper::desc_sw128(buf + 2 * WG_BOX + ks * 2048,
                                               WG_BOX, 1024);
        hopper::wgmma<256, 1, 1>(acc, da, db, it > 0 || ks > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait();
    }
    __syncwarp();
    if ((tid & 31) == 0) hopper::mbar_arrive(&empty[st]);
  }

  // ---- partial tile -> shared memory -> added into dw in chunk order ----
  hopper::named_sync(1, 256);  // every consumer is done with the ring
  float* stg = reinterpret_cast<float*>(ring);
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int r = g * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int jj = 0; jj < 32; ++jj) {
    const int c = 8 * jj + 2 * (lane & 3);
    *reinterpret_cast<float2*>(stg + r * WG_ST_LD + c) =
        make_float2(acc[4 * jj], acc[4 * jj + 1]);
    *reinterpret_cast<float2*>(stg + (r + 8) * WG_ST_LD + c) =
        make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
  }
  int* flag = p.sync + 1 + t;
  if (tid == 0) {
    while (hopper::ld_acquire(flag) != chunk) __nanosleep(64);
  }
  hopper::named_sync(1, 256);
  const int k4 = jb.k / 4, rows = min(128, jb.n - n0);
  for (int i = tid; i < rows * k4; i += 256) {
    const int row = i / k4, c = 4 * (i % k4);
    float4* d = reinterpret_cast<float4*>(p.dw + jb.out +
                                          (size_t)(n0 + row) * jb.ldo + c);
    const float4 a = __ldcg(d);
    const float4 b =
        *reinterpret_cast<const float4*>(stg + row * WG_ST_LD + c);
    *d = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
  __threadfence();
  hopper::named_sync(1, 256);
  if (tid == 0) hopper::st_release(flag, chunk + 1);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int VAR>
cudaError_t launch_forward(const FwdParams& p, cudaStream_t st) {
  Maps maps;
  cudaError_t err = make_weight_maps(&maps, p.w);
  if (err == cudaSuccess && p.acts != nullptr) {
    err = hopper::make_map(&maps.acts, p.acts, p.M, 8 * W, 8 * W);
  }
  const int smem = (int)sizeof(SmemF) + 1024;
  if (err == cudaSuccess) err = set_smem(fused_mlp_fwd_kernel<VAR>, smem);
  if (err != cudaSuccess) return err;
  fused_mlp_fwd_kernel<VAR><<<(p.M + TM - 1) / TM, ROW_THREADS, smem, st>>>(
      maps, p);
  return cudaGetLastError();
}

template <int VAR>
cudaError_t launch_backward(const BwdParams& p, const bf16* acts,
                            cudaStream_t st) {
  const int tiles = (p.M + TM - 1) / TM;
  const int opw = VAR == NORMALS ? OPW_NRM : OPW_IPE;
  Maps maps;
  cudaError_t err = make_weight_maps(&maps, p.w);
  if (err == cudaSuccess) {
    err = hopper::make_map(&maps.ops, p.ops, (uint64_t)tiles * TM, opw, opw);
  }
  if (err == cudaSuccess && VAR == NORMALS) {
    err = hopper::make_map(&maps.acts, acts, p.M, 8 * W, 8 * W);
  }
  const int smem = (int)sizeof(SmemB) + 1024;
  if (err == cudaSuccess) err = set_smem(fused_mlp_bwd_kernel<VAR>, smem);
  if (err != cudaSuccess) return err;
  fused_mlp_bwd_kernel<VAR><<<tiles, ROW_THREADS, smem, st>>>(maps, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_mlp_weight_count() { return W_TOTAL; }
int fused_mlp_bias_count() { return B_TOTAL; }
int fused_mlp_tile_rows() { return TM; }
int fused_mlp_ops_width(int normals) { return normals ? OPW_NRM : OPW_IPE; }
int fused_mlp_density_channels() { return NDC; }
NERF_SHAPE_EXPORT(fused_mlp_shape)
BIAS_WORKSPACE_EXPORT(fused_mlp_bias_workspace)

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

// Forward over M rows of encoded features x [M, XF] bf16 (kernel 1).
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
// fused_mlp_ops_width(normals)] bf16), the bias gradients into db and, for
// NORMALS, the walk's part of dWd's sigma row into the zeroed dw (which the
// weight-gradient pass then adds to). `part` and `count` are the scratch
// of fused_mlp_bias_workspace(ceil(M/64)), count zeroed.
int fused_mlp_backward_rows(const float* mc, const void* v,
                            const void* weights, const float* biases,
                            const float* g, const float* q, const void* acts,
                            void* ops, float* dmc, float* dw, float* db,
                            float* part, int* count, int M, int min_deg,
                            int normals, void* stream) {
  if (M <= 0) return (int)cudaErrorInvalidValue;
  BwdParams p = {};
  p.mc = mc;
  p.v = static_cast<const bf16*>(v);
  p.w = static_cast<const bf16*>(weights);
  p.b = biases;
  p.g = g;
  p.q = q;
  p.ops = static_cast<bf16*>(ops);
  p.dmc = dmc;
  p.sums = {part, count, db, normals ? dw + OFF_WD : nullptr};
  p.M = M;
  p.min_deg = min_deg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (normals && acts == nullptr) return (int)cudaErrorInvalidValue;
  return (int)(normals ? launch_backward<NORMALS>(
                             p, static_cast<const bf16*>(acts), st)
                       : launch_backward<IPE>(p, nullptr, st));
}

// Backward row pass of kernel 1: writes dx [M, XF] f32, the operand rows
// (fused_mlp_ops_width(0) wide) and the bias gradients into db (`part`,
// `count`: as fused_mlp_backward_rows).
int fused_mlp_encoded_backward_rows(const void* x, const void* v,
                                    const void* weights, const float* biases,
                                    const float* g, void* ops, float* dx,
                                    float* db, float* part, int* count, int M,
                                    void* stream) {
  if (M <= 0) return (int)cudaErrorInvalidValue;
  BwdParams p = {};
  p.x = static_cast<const bf16*>(x);
  p.v = static_cast<const bf16*>(v);
  p.w = static_cast<const bf16*>(weights);
  p.b = biases;
  p.g = g;
  p.ops = static_cast<bf16*>(ops);
  p.dx = dx;
  p.sums = {part, count, db, nullptr};
  p.M = M;
  return (int)launch_backward<ENCODED>(p, nullptr,
                                       static_cast<cudaStream_t>(stream));
}

// Weight-gradient pass over the operand rows of a backward row pass (this
// library's or fused_render_train's): adds every packed weight's gradient
// into the f32 buffer dw. M is the number of operand rows (a multiple of
// 64: rows past the batch are zero). `jobs` is the job table, njobs rows of
// {b1, a1, b2, a2, n, k, out, ldo} in host memory: B is the fan-out side
// (cotangent columns), A the fan-in side (layer inputs), b2 < 0 for one
// pair. The caller builds it from kernels/fused_mlp_ipe.py `wgrad_jobs`,
// the table the plain version and the CPU tests use; it is checked here
// against the operand width and the packed layout.
int fused_mlp_weight_grads(const void* ops, float* dw, int M, int normals,
                           const int* jobs, int njobs, int* sync, int nsync,
                           void* stream) {
  if (M <= 0 || M % TM != 0 || jobs == nullptr || njobs <= 0 ||
      njobs > MAX_JOBS || sync == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const int ld = normals ? OPW_NRM : OPW_IPE;
  WgradParams p = {};
  p.tile_start[0] = 0;
  for (int j = 0; j < njobs; ++j) {
    const int* r = jobs + 8 * j;
    const Job jb = {r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7]};
    const bool pair2 = jb.b2 >= 0;
    // Columns inside the rows; k <= 256 (one wgmma N) and out, ldo, k in
    // whole 16-byte pieces of dw (bulk reduce-add); the output inside dw.
    const bool ok =
        jb.n > 0 && jb.k > 0 && jb.k <= 256 && jb.k % 4 == 0 &&
        jb.b1 >= 0 && jb.b1 + jb.n <= ld && jb.a1 >= 0 && jb.a1 + jb.k <= ld &&
        (!pair2 || (jb.b2 + jb.n <= ld && jb.a2 >= 0 && jb.a2 + jb.k <= ld)) &&
        jb.out >= 0 && jb.out % 4 == 0 && jb.ldo >= jb.k && jb.ldo % 4 == 0 &&
        (long long)jb.out + (long long)(jb.n - 1) * jb.ldo + jb.k <= W_TOTAL;
    if (!ok) return (int)cudaErrorInvalidValue;
    p.jobs[j] = jb;
    p.tile_start[j + 1] = p.tile_start[j] + (jb.n + 127) / 128;
  }
  for (int j = njobs + 1; j <= MAX_JOBS; ++j) p.tile_start[j] = 1 << 30;
  if (nsync < 1 + p.tile_start[njobs]) return (int)cudaErrorInvalidValue;
  p.dw = dw;
  p.sync = sync;
  p.rows = M;
  p.njobs = njobs;
  CUtensorMap map;
  cudaError_t err = hopper::make_map(&map, ops, M, ld, ld);
  if (err != cudaSuccess) return (int)err;
  // Reduction across row chunks: one bulk f32 reduce-add per output row
  // and block into dw. At one block per SM (194 KB of shared memory), as
  // many chunks as fill one wave of the 132 SMs: 24 tiles x 5 chunks =
  // 120 blocks, so ~3 MB of f32 partials (0.5-0.8 M element adds) instead
  // of a workspace and a second launch; and at least as many as keep a
  // chunk within WG_MAX_ROWS rows, since one accumulator summing more rows
  // drifts from an f32 product (the 512 build's 81 tiles at 131,072 rows
  // in one chunk: rel-norm 2e-4).
  const int tiles = p.tile_start[p.njobs];
  const int chunks = min(max(M / TM, 1),
                         max(max(1, 132 / tiles),
                             (M + WG_MAX_ROWS - 1) / WG_MAX_ROWS));
  p.chunk_rows = ((M / TM + chunks - 1) / chunks) * TM;
  err = set_smem(fused_mlp_wgrad_kernel, WG_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(tiles, (M + p.chunk_rows - 1) / p.chunk_rows);
  fused_mlp_wgrad_kernel<<<grid, WG_THREADS, WG_SMEM,
                           static_cast<cudaStream_t>(stream)>>>(map, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
