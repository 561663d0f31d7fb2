// The per-tile pieces of the row kernels, shared by fused_mlp.cu (kernels
// 1, 2 and 3), fused_render_train.cu (kernel 5) and fused_render.cu
// (kernel 4): the IPE of the moments, the trunk (computed, or loaded from
// a bf16 spill), the heads, the density-gradient chain, the MLP backward
// from a head cotangent and the IPE adjoint, and the column layout of the
// operand rows that the weight-gradient pass of fused_mlp.cu reduces.
//
// What bounds a row kernel on an H100: the forward, tensor-core operations
// (611 K MACs per row against 96 B of inputs); the backward row pass, the
// operand rows it writes (10 KB per row for kernel 2, 17.5 KB for kernel
// 3) at about the time of its 1.2-2.0 M MACs per row. So the products
// must run near the tensor cores' rate and the writes leave as whole
// blocks. The design does it the Hopper way:
// * A block is two consumer warpgroups (NT = 256 threads) and a
//   producer warpgroup (one thread of it issues the weight loads). Every
//   product is a warpgroup product (wgmma m64nNk16, f32 accumulators in
//   registers): the 64-row activation tile is the A operand, and the two
//   warpgroups split the output columns.
// * Weights do not depend on the data, so the producer streams them
//   through a 3-stage ring (2 in the 512-wide builds) of 32 KB slices (64
//   K-rows of the product, up to four TMA boxes of 64 x 64 bf16, 128-byte
//   swizzle) with mbarrier completion, and keeps the next product's first
//   slices in flight while the consumers run an epilogue. A weight is
//   read K-major for x @ W^T and MN-major (wgmma's transpose) for s @ W.
// * The activation tile (64 rows x up to 640 columns bf16, up to ten 8 KB
//   blocks of 64 columns: the trunk's W and the widest input beside it) is
//   kept in the same 128-byte-swizzled layout that the
//   wgmma descriptor and the TMA boxes use, so epilogues write it from
//   registers and a TMA store copies a block straight into the operand
//   rows (64-column operands; the narrow ones go out as 16-byte stores).
// * Epilogues work from registers: bias, ReLU or saved mask, bf16
//   rounding where the TPU kernels round. ReLU masks are kept in the
//   accumulator's own fragment order (two words per thread and layer), so
//   the backward's thread finds the bits of its own elements.
// * The producer runs the same tile program as the consumers, compiled
//   with PRODUCER = true: it issues each product's weight slices and
//   skips everything else, so the two sides cannot disagree on the order.
//
// Two ways to share a product between the consumer warpgroups, chosen by
// a step's template flag ROWS:
// * column split (ROWS = false, the training kernels): one tile of TM = 64
//   rows, the A operand of both warpgroups; each computes half of the
//   output columns, so each weight slice feeds 64 rows.
// * row split (ROWS = true, kernel 4): a tile of 2 x 64 rows, each
//   warpgroup owns one 64-row activation tile (s.act + wg() * ACT_ELEMS)
//   and computes all output columns of every product (m64nNk16, N up to
//   256, 128 accumulators per thread), so each weight slice feeds 128
//   rows. Per-row scalars are indexed by tile row 64 wg() + r, masks hold
//   W / 64 words per thread and layer, and a warpgroup synchronises only with
//   itself (named barrier 2 + wg()).
// The shapes (nerf_mlp.cuh: W 128, 256 or 512, VW 64, 128 or 256, XF, VP)
// are compile-time constants of a build. A column-split product of N
// columns gives each warpgroup N / 2 (m64n256k16 at N = 512: a K step is
// then eight boxes, two stages, see `mm`), and wgmma's MN-major B needs 64
// of them, so
// the one MN-major product narrower than 128 columns, the view branch's
// backward at VW = 64 (d hv = gr @ Wc), runs whole in both warpgroups
// (K is 16: one wgmma each) and each keeps its own half
// (`view_backward`); the forward products take N / 2 of any width
// (m64n32k16 for the 64-wide view branch, m64n8k16 for the heads).
// The 512-wide builds run column split only (kernel 4 too: two 80 KB
// tiles do not fit a block), keep no f32 copy of the IPE features (see
// `feat`) and give the consumers 240 registers (128 accumulators).
//
// The 1,024-wide builds (W 1024, PAIR = 2) run every tile on a cluster of
// two CTAs, since one CTA holds neither the 64 x 1,120 tile beside its
// masks and ring nor 256 accumulators a thread. CTA `rank` owns the
// columns rank * WL .. of every trunk-wide product (WL = W / 2; of the
// view branch, VL = VW / 2): it computes them column split as a 512-wide
// build does (`share`), keeps them in its own tile at local columns
// 0..WL-1, and keeps the inputs beside them (IPE features, viewdir codes,
// head cotangents at local column WL) in both CTAs. A product whose K
// runs over the split columns (`mm`'s `split`) reads its own half from the
// tile and the partner's half one 64-column block at a time through
// distributed shared memory into a staging block after the tile (the
// wgmma descriptor addresses only the CTA's own shared memory). The
// narrow products (the heads, the 128 columns of g_x, and at VW 128 the
// view branch's backward) are computed whole in both CTAs, so no sum
// crosses the pair and both hold the same bits. A layer's output replaces
// its input in place, so every epilogue is fenced by a barrier of the
// pair's consumers (`pair_sync`): before it, the partner has read this
// CTA's half; after it, the new half is written. Global writes of what
// both CTAs hold come from rank 0.
// Each step is called by every consumer thread; `Smem` is any struct with
// the members the step names, so a kernel allocates only what it uses.
// Consumers synchronise among themselves with named barriers (1: all
// consumers, consumer_sync), never __syncthreads.
#pragma once

#include <stddef.h>

#include "hopper.cuh"
#include "nerf_mlp.cuh"

namespace nerf_mlp {

constexpr int OUT_W = 16;  // raw output slab: rgb(3) | density(5) | 0(8)
constexpr int ROW_THREADS = NT + 128;  // two consumer warpgroups + producer
// CTAs per tile (the 1,024-wide builds run a pair, see the header) and the
// trunk and view-branch columns each owns.
constexpr int PAIR = W > 512 ? 2 : 1;
constexpr int WL = W / PAIR;
constexpr int VL = VW / PAIR;
// Weight-slice stages: three, or two in the 512- and 1,024-wide builds,
// whose 80 KB activation tile and 32 KB of masks leave room for no more.
constexpr int RING = WL > 256 ? 2 : 3;
constexpr int BOX = 64 * 64 * 2;      // one 64 x 64 bf16 TMA box
constexpr int SLICE = 4 * BOX;        // one stage: up to four boxes
// Activation tile: 64-column blocks for the CTA's WL trunk columns and the
// widest of the inputs beside them (IPE features, viewdir codes, the
// density-head cotangent).
constexpr int ACT_COLS = WL + (XF > VP ? (XF > HP ? XF : HP) : (VP > HP ? VP : HP));
constexpr int ACT_BLOCKS = (ACT_COLS + 63) / 64;
static_assert(ACT_BLOCKS <= 10, "the activation tile holds at most 640 columns");
constexpr int ACT_ELEMS = TM * 64 * ACT_BLOCKS;  // one 64-row tile
// A pair CTA's staging block for the partner's 64 columns (after the
// tile: a kernel's act array holds ACT_BLOCKS + STAGE_BLOCKS blocks).
constexpr int STAGE_BLOCKS = PAIR > 1 ? 1 : 0;
// ReLU-mask words per thread and trunk layer in the column split (WL / 2
// columns per warpgroup, WL / 4 accumulators per thread).
constexpr int MWC = WL / 128;
// View-branch ReLU-mask words per thread in the column split (VL / 4
// accumulators per thread).
constexpr int HVW = (VL / 4 + 31) / 32;
// The f32 IPE features (64 rows x XF) are kept in s.x32 where they fit
// beside the tile (W <= 256, at most the shipped 96 features: at 128 the
// copy and d x leave a 256-wide backward no room); the 512-wide builds
// and more IPE degrees recompute them from the moments (`feat`), with
// load_ipe's own expression, so the values agree.
// Recomputing them at the shipped shape too gives the same bits but slows
// the row passes (scripts/torch_kernel_ab.py, H100 80GB HBM3 at 700 W,
// 28,672 rows: kernel 2 0.568 -> 0.684 ms, kernel 3 0.863 -> 1.181,
// kernel 5 at 512 x 56 0.735 -> 0.843; kernel 3's forward 0.418 ->
// 0.443), so the copy stays where it fits.
constexpr bool X32 = W <= 256 && XF <= 96;
constexpr int X32_ELEMS = X32 ? TM * XF : 1;
// Shared memory one block may have on an H100 (a kernel's Smem plus the
// 1024 bytes of alignment slack it allocates), less the pair's barrier.
constexpr int SMEM_LIMIT = 232448 - (PAIR > 1 ? 16 : 0);
// The dynamic shared memory a kernel's Smem takes: its members up to its
// last, the barrier `io` (not its sizeof, which rounds up to the 1024-byte
// alignment of the tile), and 1024 bytes of slack for `smem_of`'s
// alignment. kernels/shapes.py `smem_bytes` computes the same sums.
template <class Smem>
constexpr int smem_bytes() {
  return (int)(offsetof(Smem, io) + sizeof(uint64_t)) + 1024;
}

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

// Tensor maps of the packed weights (row-major [out, in] matrices; layers
// 1-4 and 6-7 stacked, Wd right above Wb) and of the tile's global rows.
enum MapId { M_W0, M_W14, M_W5, M_W67, M_WDB, M_WV, M_WC, NW_MAPS };
struct Maps {
  CUtensorMap w[NW_MAPS];
  CUtensorMap ops;   // operand rows [rows, OPW] (backward row passes)
  CUtensorMap acts;  // trunk spill [M, 8 * W] (kernels 3 and 5)
};

// The weight maps over the packed buffer (host).
inline cudaError_t make_weight_maps(Maps* m, const bf16* w) {
  struct { int id, off, rows, cols; } spec[NW_MAPS] = {
      {M_W0, OFF_W0, W, XF},        {M_W14, OFF_W1, 4 * W, W},
      {M_W5, OFF_W5, W, W + XF},    {M_W67, OFF_W6, 2 * W, W},
      {M_WDB, OFF_WD, HP + W, W},   {M_WV, OFF_WV, VW, VK},
      {M_WC, OFF_WC, HP, VW}};
  for (const auto& s : spec) {
    cudaError_t err =
        hopper::make_map(&m->w[s.id], w + s.off, s.rows, s.cols, s.cols);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// One product's weights: map, first K row / column of the slab, first N
// row / column, K and N (the columns of the output).
struct Prod {
  int map, k0, n0, K, N;
};

// Trunk layer `layer` as a forward product (x @ W^T) or as the backward
// product s @ W over output columns n0 .. n0 + N - 1 of W's fan-in.
__device__ __forceinline__ Prod trunk_prod(int layer, bool backward,
                                           int n0 = 0, int N = W) {
  const int map = layer == 0 ? M_W0 : layer <= 4 ? M_W14 : layer == 5 ? M_W5
                                                                      : M_W67;
  const int base = layer == 0 ? 0 : layer <= 4 ? (layer - 1) * W
                                               : layer == 5 ? 0 : (layer - 6) * W;
  if (!backward) return Prod{map, 0, base, trunk_in(layer), W};
  return Prod{map, base, n0, W, N};
}

// ---- the activation tile: 128-byte-swizzled blocks of 64 columns ----

__device__ __forceinline__ int act_off(int r, int c) {  // in elements
  return (c >> 6) * 4096 + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) +
         (c & 7);
}
__device__ __forceinline__ bf16 act_get(const bf16* act, int r, int c) {
  return act[act_off(r, c)];
}
__device__ __forceinline__ void act_put2(bf16* act, int r, int c, float lo,
                                         float hi) {  // c even
  *reinterpret_cast<__nv_bfloat162*>(act + act_off(r, c)) =
      __floats2bfloat162_rn(lo, hi);
}
// 16 bytes (8 columns c .. c + 7, c % 8 == 0) of row r.
__device__ __forceinline__ uint4& act_chunk(bf16* act, int r, int c) {
  return *reinterpret_cast<uint4*>(act + act_off(r, c));
}

__device__ __forceinline__ void consumer_sync() { hopper::named_sync(1, NT); }

// Thread-local view of a wgmma accumulator of NW columns (per warpgroup):
// element i sits at row frag_row(i), column frag_col(i) of the warpgroup's
// output columns.
__device__ __forceinline__ int frag_row(int i) {
  const int t = threadIdx.x & 127;
  return (t >> 5) * 16 + ((t & 31) >> 2) + ((i & 2) ? 8 : 0);
}
__device__ __forceinline__ int frag_col(int i) {
  return (i >> 2) * 8 + 2 * (threadIdx.x & 3) + (i & 1);
}
__device__ __forceinline__ int wg() { return threadIdx.x >> 7; }

// ---- the pair (PAIR 2, see the header) ----

#if NERF_W > 512
// The pair's barrier: 16 arrivals a phase, one from each consumer warp of
// both CTAs (pipe_init sets it up).
__shared__ uint64_t pair_bar;
#endif

// This CTA's rank in its pair (0 without one).
__device__ __forceinline__ int prank() {
  if constexpr (PAIR > 1) {
    return (int)hopper::cluster_rank();
  } else {
    return 0;
  }
}

// Barrier of the pair's consumers (a no-op without a pair): each consumer
// warp arrives on its own CTA's barrier and on the partner's, releasing at
// cluster scope what it wrote and read, and waits for its own barrier's
// phase. A warp cannot arrive twice in one phase: its next arrival follows
// its wait, which needs every arrival of this one.
__device__ __forceinline__ void pair_sync() {
#if NERF_W > 512
  uint64_t token = 0;
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    token = hopper::mbar_arrive_token(&pair_bar);
    hopper::mbar_arrive_remote(
        hopper::map_rank(&pair_bar, hopper::cluster_rank() ^ 1));
  }
  token = __shfl_sync(0xffffffffu, token, 0);
  hopper::mbar_wait_token(&pair_bar, token);
#endif
}

// A row kernel's clusters: the pair's two CTAs in the 1,024-wide builds
// (the grid is PAIR blocks a tile; blockIdx.x / PAIR is the tile).
#if NERF_W > 512
#define NERF_PAIR_CLUSTER __cluster_dims__(2, 1, 1)
#else
#define NERF_PAIR_CLUSTER
#endif

// Copy the partner's 64-column block at its local column lc (a multiple of
// 64) into the staging block after this CTA's tile `act`, as a product's A
// operand (the partner wrote it before the last pair_sync).
__device__ void stage_partner(const bf16* act, int lc) {
  uint4* stage = reinterpret_cast<uint4*>(const_cast<bf16*>(act) + ACT_ELEMS);
  consumer_sync();  // both warpgroups are done with the last staged block
  const uint32_t src =
      hopper::map_rank(act + (lc >> 6) * 4096, hopper::cluster_rank() ^ 1);
  for (int i = threadIdx.x; i < TM * 64 / 8; i += NT) {
    stage[i] = hopper::ld_cluster(src + 16 * i);
  }
  hopper::fence_proxy_async();
  consumer_sync();
}

// The CTA's share of a product over the trunk's or the view branch's
// width: its N / PAIR columns from rank * N / PAIR (all of them without a
// pair).
__device__ __forceinline__ Prod share(Prod p) {
  if constexpr (PAIR > 1) {
    p.N /= PAIR;
    p.n0 += prank() * p.N;
  }
  return p;
}

// ---- the two splits (see the header) ----

// Output columns of an N-wide product that one warpgroup computes.
template <bool ROWS>
__host__ __device__ constexpr int wg_cols(int n) {
  return ROWS ? n : n / 2;
}
// The first of them.
template <bool ROWS>
__device__ __forceinline__ int col0(int n) {
  return ROWS ? 0 : wg() * (n / 2);
}
// The tile row of the warpgroup's A row 0.
template <bool ROWS>
__device__ __forceinline__ int row0_of() {
  return ROWS ? wg() * TM : 0;
}
// The warpgroup's A operand (activation tile).
template <bool ROWS>
__device__ __forceinline__ bf16* tile_act(bf16* act) {
  return ROWS ? act + wg() * ACT_ELEMS : act;
}
// Rows of the warpgroup's A tile that hold data, of a tile's nrows.
template <bool ROWS>
__device__ __forceinline__ int own_rows(int nrows) {
  return ROWS ? min(max(nrows - row0_of<true>(), 0), TM) : nrows;
}
// Threads that fill one A tile, and this thread's index among them.
template <bool ROWS>
constexpr int FILL = ROWS ? 128 : NT;
template <bool ROWS>
__device__ __forceinline__ int fill_tid() {
  return ROWS ? (threadIdx.x & 127) : threadIdx.x;
}
template <bool ROWS>
__device__ __forceinline__ void tile_sync() {
  if (ROWS) {
    hopper::named_sync(2 + wg(), 128);
  } else {
    hopper::named_sync(1, NT);
  }
}

// ---- the weight ring ----

template <bool PRODUCER, int NS = RING>
struct Pipe {
  uint64_t* full;
  uint64_t* empty;
  unsigned char* ring;
  const Maps* maps;
  int it;  // slices consumed (or issued) so far
};

// A kernel's ring has as many stages as its Smem has `full` barriers.
template <class Smem>
__host__ __device__ constexpr int ring_stages() {
  return sizeof(Smem::full) / sizeof(uint64_t);
}

template <class Smem>
__device__ void pipe_init(Smem& s) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < ring_stages<Smem>(); ++i) {
      hopper::mbar_init(&s.full[i], 1);
      hopper::mbar_init(&s.empty[i], NT / 32);  // one arrival per warp
    }
    hopper::mbar_init(&s.io, 1);
#if NERF_W > 512
    hopper::mbar_init(&pair_bar, 2 * (NT / 32));
#endif
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // The partner's barrier is set up before any arrival on it.
  if constexpr (PAIR > 1) hopper::cluster_sync();
}

template <bool PRODUCER, class Smem>
__device__ Pipe<PRODUCER, ring_stages<Smem>()> make_pipe(Smem& s,
                                                         const Maps* maps) {
  return Pipe<PRODUCER, ring_stages<Smem>()>{s.full, s.empty, s.ring, maps,
                                             0};
}

// acc (+)= A @ B for this warpgroup's NW output columns (column split:
// columns wg() * NW ..; row split: all of them, up to 256): A is the
// warpgroup's activation tile from column acol (a multiple of 16; K
// columns), B the product's weights, K-major for TB = 0 (x @ W^T),
// MN-major for TB = 1 (s @ W; NW a multiple of 64). The producer issues
// the slices instead.
//
// `split` > 0 (acol 0): A's K columns are the logical columns of a pair's
// split width `split` (W or VW), then its inputs: logical column c <
// split lives in CTA c / (split / PAIR) at local column c % (split /
// PAIR), a column c >= split at local column WL + c - split. A block of
// the partner's is staged (`stage_partner`). Without a pair this is the
// tile's own columns c, as for split 0.
//
// A column-split product of 512 columns (NW = 256, the 512-wide builds)
// needs eight boxes per K step, two stages: stage h of a K step holds
// columns 128 h .. 128 h + 127 of each warpgroup's 256 (boxes 2 g and
// 2 g + 1 for warpgroup g), and each warpgroup runs m64n128k16 on that
// half of its accumulators (the same fragment order as m64n256k16: n8
// block j is accumulators 4 j .. 4 j + 3). Both warpgroups read and
// release every stage, so the ring's protocol is unchanged.
template <int NW, int TB, bool ROWS = false, bool PRODUCER, int NS>
__device__ void mm(Pipe<PRODUCER, NS>& pp, const Prod& pd,
                   float (&acc)[NW / 2], const bf16* act, int acol,
                   bool accumulate = false, int split = 0) {
  constexpr bool SPLIT = !ROWS && NW > 128;
  constexpr int HALVES = SPLIT ? 2 : 1;
  const int nsl = (pd.K + 63) / 64;
  if constexpr (PRODUCER) {
    const int nbox = SPLIT ? 4 : (pd.N + 63) / 64;
    const CUtensorMap* map = &pp.maps->w[pd.map];
    for (int kk = 0; kk < nsl; ++kk) {
      for (int h = 0; h < HALVES; ++h, ++pp.it) {
        const int st = pp.it % NS;
        if (pp.it >= NS) hopper::mbar_wait(&pp.empty[st], ((pp.it / NS) - 1) & 1);
        unsigned char* buf = pp.ring + st * SLICE;
        hopper::mbar_expect_tx(&pp.full[st], nbox * BOX);
        for (int b = 0; b < nbox; ++b) {
          const int n = SPLIT ? pd.n0 + (b / 2) * NW + 128 * h + 64 * (b % 2)
                              : pd.n0 + 64 * b;
          if (TB == 0) {
            hopper::tma_load(buf + b * BOX, map, &pp.full[st],
                             pd.k0 + 64 * kk, n);
          } else {
            hopper::tma_load(buf + b * BOX, map, &pp.full[st], n,
                             pd.k0 + 64 * kk);
          }
        }
      }
    }
  } else {
    static_assert(TB == 0 || NW % 64 == 0, "MN-major splits need 64 columns");
    // First B column of the stage: SPLIT, this warpgroup's two boxes.
    const int bcol = SPLIT ? 128 * wg() : ROWS ? 0 : wg() * NW;
    for (int kk = 0; kk < nsl; ++kk) {
      const int steps = min(4, (pd.K - 64 * kk + 15) / 16);
      // The K slice's A block: the tile's from column ac, or the staging
      // block's (ac 0) when it is the partner's.
      const bf16* ablk = act;
      int ac = acol + 64 * kk;
      if constexpr (PAIR > 1) {
        if (split > 0) {
          const int c = 64 * kk, half = split / PAIR;
          if (c >= split) {
            ac = WL + c - split;
          } else if (c / half != prank()) {
            stage_partner(act, c % half);
            ablk = act + ACT_ELEMS;
            ac = 0;
          } else {
            ac = c % half;
          }
        }
      }
      for (int h = 0; h < HALVES; ++h, ++pp.it) {
        const int st = pp.it % NS;
        hopper::mbar_wait(&pp.full[st], (pp.it / NS) & 1);
        const unsigned char* buf = pp.ring + st * SLICE;
        hopper::wgmma_fence();
        for (int ks = 0; ks < steps; ++ks) {
          const int c = ac + 16 * ks;
          const uint64_t da = hopper::desc_sw128(ablk + act_off(0, c), 16, 1024);
          const uint64_t db =
              TB == 0 ? hopper::desc_sw128(buf + bcol * 128 + ks * 32, 16, 1024)
                      : hopper::desc_sw128(buf + (bcol / 64) * BOX + ks * 2048,
                                           BOX, 1024);
          // The product's first step overwrites acc unless it accumulates.
          const int scale = accumulate || kk > 0 || ks > 0;
          if constexpr (SPLIT) {
            typedef float Half[NW / 4];
            if (h == 0) {
              hopper::wgmma<NW / 2, 0, TB>(*reinterpret_cast<Half*>(acc), da,
                                           db, scale);
            } else {
              hopper::wgmma<NW / 2, 0, TB>(
                  *reinterpret_cast<Half*>(acc + NW / 4), da, db, scale);
            }
          } else {
            hopper::wgmma<NW, 0, TB>(acc, da, db, scale);
          }
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait();
        __syncwarp();
        if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(&pp.empty[st]);
      }
    }
  }
}

// Role split of a row kernel after pipe_init: the producer warpgroup
// drops to PR registers and one of its threads runs `tile` as the
// producer; the consumer warpgroups take CR (the wgmma accumulators of a
// product and of the skip columns stay in registers) and run it as
// consumers, then wait for their last TMA stores. A pair's CTAs then wait
// for each other, so neither exits while the other may still read its
// shared memory. A whole producer
// warpgroup keeps the register pool exact: 128 x 40 + 256 x 232 = 64,512
// (column split), 128 x 24 + 256 x 240 = 64,512 (row split, and the
// column split of the 512-wide builds: 128 accumulators per thread spill
// less with 240).
template <int PR = (WL > 256 ? 24 : 40), int CR = (WL > 256 ? 240 : 232),
          class Smem, class Tile>
__device__ __forceinline__ void run_roles(Smem& s, const Maps* maps,
                                          Tile tile) {
  if (threadIdx.x >= NT) {
    hopper::reg_dealloc<PR>();
    if (threadIdx.x == NT) {
      auto pp = make_pipe<true>(s, maps);
      tile(pp);
    }
  } else {
    hopper::reg_alloc<CR>();
    auto pp = make_pipe<false>(s, maps);
    tile(pp);
    if (threadIdx.x == 0) hopper::bulk_wait();
  }
  if constexpr (PAIR > 1) hopper::cluster_sync();
}

// Before an epilogue overwrites the activation tile: every product of
// the consumers that share it has read it (a pair's partner too), and the
// last TMA store of it has too (row-split tiles are never stored).
template <bool ROWS = false>
__device__ __forceinline__ void pre_epilogue() {
  if (!ROWS && threadIdx.x == 0) hopper::bulk_wait_read();
  tile_sync<ROWS>();
  if constexpr (PAIR > 1) pair_sync();
}
// After an epilogue: its shared-memory writes are visible to the products
// and TMA stores that read them, and to the consumers that share them (a
// pair's partner too, by distributed shared memory).
template <bool ROWS = false>
__device__ __forceinline__ void post_epilogue() {
  hopper::fence_proxy_async();
  tile_sync<ROWS>();
  if constexpr (PAIR > 1) pair_sync();
}

// TMA store of activation blocks b0 .. b0 + nb - 1 to the global rows of
// `map` at column col, row row0 (rows past the map's end are dropped).
__device__ __forceinline__ void store_blocks(const bf16* act, int b0, int nb,
                                             const CUtensorMap* map, int col,
                                             int row0) {
  if (threadIdx.x == 0) {
    for (int b = 0; b < nb; ++b) {
      hopper::tma_store(map, act + (b0 + b) * 4096, col + 64 * b, row0);
    }
    hopper::bulk_commit();
  }
}

// 16-byte copy of activation columns c0 .. c0 + ncols - 1 (multiples of
// 8) of rows < nrows to dst (row stride ld elements).
__device__ void copy_cols(const bf16* act, int c0, int ncols, bf16* dst,
                          size_t ld, int nrows) {
  const int chunks = ncols / 8;
  for (int i = threadIdx.x; i < nrows * chunks; i += NT) {
    const int r = i / chunks, c = c0 + (i % chunks) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + c - c0) =
        act_chunk(const_cast<bf16*>(act), r, c);
  }
}

// Sum `ncols` bf16 columns from c0 of the tile over its rows into dst
// (the tile's row of partial sums, see `bias_sums`).
__device__ void colsum_store(const bf16* act, int c0, int ncols, float* dst) {
  for (int c = threadIdx.x; c < ncols; c += NT) {
    float s = 0.f;
    for (int r = 0; r < TM; ++r) s += __bfloat162float(act_get(act, r, c0 + c));
    dst[c] = s;
  }
}

// Sums over the tiles of a backward row pass, in a fixed order, so that
// the gradients are the same at every run (atomics would add in the order
// the tiles finish). Each tile writes its column sums as one f32 row of
// `part` (PART_W: the B_TOTAL bias gradients, then for NORMALS the W
// column sums of the walk's c_7, dWd's sigma row); `bias_sums` then adds
// them up: the last tile of each group of SUM_GROUP tiles to finish adds
// the group's rows in tile order into a group row after the tiles' rows,
// and the last group to finish adds the group rows in order and writes
// db (and the sigma row). `count` holds groups + 1 zeroed counters.
constexpr int PART_W = B_TOTAL + W;
constexpr int SUM_GROUP = 32;

__host__ __device__ constexpr int sum_groups(int tiles) {
  return (tiles + SUM_GROUP - 1) / SUM_GROUP;
}

struct BiasSums {
  float* part;      // [tiles + sum_groups(tiles), PART_W] f32
  int* count;       // [sum_groups(tiles) + 1] int32, zeroed
  float* db;        // [B_TOTAL]: written
  float* dw_sigma;  // [W] (NORMALS: dw + OFF_WD, written) or null
};

// The tile's row of partial sums (a pair's CTAs write their own columns
// of it).
__device__ __forceinline__ float* part_row(const BiasSums& b) {
  return b.part + (size_t)(blockIdx.x / PAIR) * PART_W;
}

// Called by every consumer thread of every tile (one tile per block or
// pair, gridDim.x / PAIR tiles) after the tile's colsum_store calls.
__device__ void bias_sums(const BiasSums& b) {
  const int tiles = gridDim.x / PAIR, groups = sum_groups(tiles);
  const int ncols = b.dw_sigma != nullptr ? PART_W : B_TOTAL;
  const int gi = blockIdx.x / PAIR / SUM_GROUP, g0 = gi * SUM_GROUP;
  const int gn = min(SUM_GROUP, tiles - g0);
  __threadfence();
  consumer_sync();
  bool last = threadIdx.x == 0 && atomicAdd(b.count + gi, 1) == gn * PAIR - 1;
  if (!hopper::named_sync_or(1, NT, last)) return;
  __threadfence();
  float* grow = b.part + (size_t)(tiles + gi) * PART_W;
  for (int c = threadIdx.x; c < ncols; c += NT) {
    float s = 0.f;
    for (int t = 0; t < gn; ++t) s += __ldcg(b.part + (size_t)(g0 + t) * PART_W + c);
    grow[c] = s;
  }
  __threadfence();
  consumer_sync();
  last = threadIdx.x == 0 && atomicAdd(b.count + groups, 1) == groups - 1;
  if (!hopper::named_sync_or(1, NT, last)) return;
  __threadfence();
  for (int c = threadIdx.x; c < ncols; c += NT) {
    float s = 0.f;
    for (int k = 0; k < groups; ++k) s += __ldcg(b.part + (size_t)(tiles + k) * PART_W + c);
    if (c < B_TOTAL) {
      b.db[c] = s;
    } else {
      b.dw_sigma[c - B_TOTAL] = s;
    }
  }
}

// The scratch of `bias_sums` for a launch of `tiles` blocks: returns the
// f32 elements of `part` and sets *ints to those of `count`.
#define BIAS_WORKSPACE_EXPORT(name)                                   \
  extern "C" int name(int tiles, int* ints) {                         \
    *ints = nerf_mlp::sum_groups(tiles) + 1;                          \
    return (tiles + nerf_mlp::sum_groups(tiles)) * nerf_mlp::PART_W;  \
  }

// Own element i (of 32 MW) of a layer's ReLU mask, in fragment order.
template <int MW = 2>
__device__ __forceinline__ bool mask_bit(const uint32_t* mask, int layer,
                                         int i) {
  return (mask[(layer * MW + (i >> 5)) * NT + threadIdx.x] >> (i & 31)) & 1u;
}

// IPE feature j < 2 XP of the row with moments m (means | covs), f32:
// att * sin(y), the cos block as the sin block shifted by pi/2. load_ipe
// computes the features with this expression.
__device__ __forceinline__ float ipe_feature(const float* m, int j,
                                             int min_deg) {
  const int jj = j % XP;
  const int deg = jj / 3 + min_deg, dim = jj % 3;
  float y = m[dim] * ldexpf(1.f, deg);
  if (j >= XP) y = y + 1.57079632679489662f;
  const float var = m[3 + dim] * ldexpf(1.f, 2 * deg);
  return expf(-0.5f * var) * sinf(y);
}

// f32 IPE feature j < 2 XP of tile row r: from s.x32 where the build keeps
// it (X32), else recomputed from the row's moments in s.mc.
template <class Smem>
__device__ __forceinline__ float feat(const Smem& s, int r, int j,
                                      int min_deg) {
  if constexpr (X32) {
    return s.x32[r * XF + j];
  } else {
    return ipe_feature(s.mc + r * 8, j, min_deg);
  }
}

// att * cos(y) of IPE feature j: the cos block is the sin block shifted by
// pi/2, so it is the other half.
template <class Smem>
__device__ __forceinline__ float feat_cos(const Smem& s, int r, int j,
                                          int min_deg) {
  return j < XP ? feat(s, r, j + XP, min_deg) : -feat(s, r, j - XP, min_deg);
}

__device__ __forceinline__ float deg_scale(int j, int min_deg) {
  return ldexpf(1.f, (j % XP) / 3 + min_deg);
}

// ---- steps ----

// Load the moments of the tile's rows row0 .. row0 + nrows - 1 into s.mc
// (by tile row; zero past nrows) and build the IPE features (zero in the
// padded columns 2 XP..XF-1): bf16 at act columns WL..WL+XF-1 and, column
// split where the build keeps them (X32), f32 in x32 (a row-split kernel
// and the 512-wide builds recompute them where they need them: 128 rows
// of x32 do not fit beside two tiles, nor 64 beside a 640-column one).
template <bool ROWS = false, class Smem>
__device__ void load_ipe(Smem& s, const float* mc, size_t row0, int nrows,
                         int min_deg) {
  const int tid = fill_tid<ROWS>(), rb = row0_of<ROWS>();
  const int own = own_rows<ROWS>(nrows);
  bf16* act = tile_act<ROWS>(s.act);
  float* m = s.mc + rb * 8;
  for (int i = tid; i < TM * 8; i += FILL<ROWS>) {
    const int r = i >> 3;
    m[i] = r < own ? mc[(row0 + rb + r) * 8 + (i & 7)] : 0.f;
  }
  tile_sync<ROWS>();
  for (int i = tid; i < TM * XF / 2; i += FILL<ROWS>) {
    const int r = i / (XF / 2), j = 2 * (i % (XF / 2));
    float f[2];
    for (int h = 0; h < 2; ++h) {
      f[h] = ipe_feature(m + r * 8, (j + h) % (2 * XP), min_deg);
      if constexpr (2 * XP < XF) {
        if (j + h >= 2 * XP) f[h] = 0.f;
      }
      if constexpr (!ROWS && X32) s.x32[r * XF + j + h] = f[h];
    }
    act_put2(act, r, WL + j, f[0], f[1]);
  }
  hopper::fence_proxy_async();
  tile_sync<ROWS>();
}

// Load already-encoded bf16 features x [., XF] into act columns
// WL..WL+XF-1 (zero past nrows).
template <class Smem>
__device__ void load_encoded(Smem& s, const bf16* x, size_t row0, int nrows) {
  for (int i = threadIdx.x; i < TM * XF / 8; i += NT) {
    const int r = i / (XF / 8), c = 8 * (i % (XF / 8));
    act_chunk(s.act, r, WL + c) =
        r < nrows ? *reinterpret_cast<const uint4*>(x + (row0 + r) * XF + c)
                  : make_uint4(0, 0, 0, 0);
  }
  hopper::fence_proxy_async();
  consumer_sync();
}

// Where the trunk's activations go besides the tile: a TMA map (rows past
// its end dropped) or rows < nrows of a plain [., ld] buffer; `col` is
// the first column of layer 0.
struct TrunkOut {
  const CUtensorMap* map;
  bf16* ptr;
  size_t ld;
  int col, row0, nrows;
};

// Trunk layer epilogue from the accumulator (NA of its elements per
// thread): act = bf16(relu(acc + bias)) and, with MASKS, the ReLU mask
// bits in fragment order (NA / 32 words per thread and layer). `bias` is
// the layer's from the CTA's first column.
template <bool ROWS = false, bool MASKS = true, class Smem, int NA>
__device__ void relu_epilogue(Smem& s, const float (&acc)[NA],
                              const float* bias, int layer) {
  constexpr int MW = NA / 32;
  bf16* act = tile_act<ROWS>(s.act);
  const int c0 = col0<ROWS>(WL);
  uint32_t m[MW];
#pragma unroll
  for (int k = 0; k < MW; ++k) m[k] = 0;
#pragma unroll
  for (int i = 0; i < NA; i += 2) {
    const int r = frag_row(i), c = c0 + frag_col(i);
    const __nv_bfloat162 h = __floats2bfloat162_rn(
        fmaxf(acc[i] + bias[c], 0.f), fmaxf(acc[i + 1] + bias[c + 1], 0.f));
    *reinterpret_cast<__nv_bfloat162*>(act + act_off(r, c)) = h;
    const uint32_t bits = (__low2float(h) > 0.f ? 1u : 0u) |
                          (__high2float(h) > 0.f ? 2u : 0u);
    m[i >> 5] |= bits << (i & 31);
  }
  if constexpr (MASKS) {
#pragma unroll
    for (int k = 0; k < MW; ++k) {
      s.mask[(layer * MW + k) * NT + threadIdx.x] = m[k];
    }
  }
}

// Trunk: 8 x (Linear + ReLU) on the features at act columns WL..WL+XF-1,
// the skip input [h4 | x] into layer 5. Leaves a_7 in act columns 0..WL-1
// (the CTA's own columns) and the ReLU masks; layer i's activation also
// goes to `out` (if any) at column out.col + W i (column split only).
// Without MASKS (a kernel that runs no chain) the masks are not kept.
template <bool ROWS = false, bool MASKS = true, bool PRODUCER, int NS,
          class Smem>
__device__ void trunk_forward(Pipe<PRODUCER, NS>& pp, Smem& s, const float* b,
                              const TrunkOut* out) {
  constexpr int NW = wg_cols<ROWS>(WL);
  float acc[NW / 2];
  bf16* act = tile_act<ROWS>(s.act);
  const int own0 = prank() * WL;  // the CTA's first trunk column
  for (int layer = 0; layer < 8; ++layer) {
    mm<NW, 0, ROWS>(pp, share(trunk_prod(layer, false)), acc, act,
                    layer == 0 ? WL : 0, false, layer == 0 ? 0 : W);
    if constexpr (!PRODUCER) {
      pre_epilogue<ROWS>();
      relu_epilogue<ROWS, MASKS>(s, acc, b + OFF_BT + layer * W + own0, layer);
      post_epilogue<ROWS>();
      if (!ROWS && out != nullptr) {
        if (out->map != nullptr) {
          store_blocks(s.act, 0, WL / 64, out->map,
                       out->col + layer * W + own0, out->row0);
        } else {
          copy_cols(s.act, 0, WL, out->ptr + out->col + layer * W + own0,
                    out->ld, out->nrows);
        }
      }
    }
  }
}

// The trunk's activations from a bf16 spill (TMA map `acts` [M, 8 * W],
// the tile's first row row0; zero past nrows): masks, operand rows O_A
// (map `ops`, row ops_row0) and a_7 in act columns 0..WL-1, as
// trunk_forward leaves them (a pair's CTA loads its own columns).
template <class Smem>
__device__ void trunk_load(Smem& s, const CUtensorMap* acts, int row0,
                           int nrows, const CUtensorMap* ops, int ops_row0) {
  constexpr int NA = WL / 4;  // this thread's accumulator elements
  const int tid = threadIdx.x, g = wg(), own0 = prank() * WL;
  for (int layer = 0; layer < 8; ++layer) {
    pre_epilogue();  // the previous layer's store has read the tile
    if (tid == 0) {
      hopper::mbar_expect_tx(&s.io, (WL / 64) * BOX);
      for (int b = 0; b < WL / 64; ++b) {
        hopper::tma_load(s.act + b * 4096, acts, &s.io,
                         layer * W + own0 + 64 * b, row0);
      }
    }
    hopper::mbar_wait(&s.io, layer & 1);
    if (nrows < TM) {
      for (int i = tid; i < (TM - nrows) * (WL / 8); i += NT) {
        act_chunk(s.act, nrows + i / (WL / 8), 8 * (i % (WL / 8))) =
            make_uint4(0, 0, 0, 0);
      }
      hopper::fence_proxy_async();
      consumer_sync();
    }
    uint32_t m[MWC];
#pragma unroll
    for (int k = 0; k < MWC; ++k) m[k] = 0;
#pragma unroll
    for (int i = 0; i < NA; i += 2) {
      const int r = frag_row(i), c = g * (WL / 2) + frag_col(i);
      const __nv_bfloat162 h =
          *reinterpret_cast<const __nv_bfloat162*>(s.act + act_off(r, c));
      const uint32_t bits = (__low2float(h) > 0.f ? 1u : 0u) |
                            (__high2float(h) > 0.f ? 2u : 0u);
      m[i >> 5] |= bits << (i & 31);
    }
#pragma unroll
    for (int k = 0; k < MWC; ++k) s.mask[(layer * MWC + k) * NT + tid] = m[k];
    post_epilogue();  // and, in a pair, a_7 is there for the partner
    store_blocks(s.act, 0, WL / 64, ops, O_A + layer * W + own0, ops_row0);
  }
}

// 16 bytes (codes c .. c + 7) of the viewdir codes of tile row r: from a
// [., VP] bf16 buffer at the tile's first row, or from a callable
// src(r, c) that builds them.
__device__ __forceinline__ uint4 vcodes(const bf16* v, int r, int c) {
  return *reinterpret_cast<const uint4*>(v + r * VP + c);
}
template <class F>
__device__ __forceinline__ uint4 vcodes(const F& src, int r, int c) {
  return src(r, c);
}

// Heads on a_7 (act columns 0..WL-1) and the viewdir codes v (see vcodes;
// zero past nrows): bottleneck and view branch. With OUT, also the
// density and color heads: on return s.heads [tile rows x 16] f32 holds
// raw rgb (+ bias) in columns 0..2 and raw density (+ bias) in columns
// 3..3+NDC-1 (both CTAs of a pair hold them). With OPS (column split
// only), the bottleneck, the viewdir codes and the view-branch activation
// go to their operand rows (map `ops`, row ops_row0) and the view
// branch's ReLU mask to s.hvmask. Leaves the view-branch activation in act
// columns 0..VL-1.
template <bool OPS, bool OUT, bool ROWS = false, bool PRODUCER, int NS,
          class Smem, class VSrc>
__device__ void heads_forward(Pipe<PRODUCER, NS>& pp, Smem& s, const float* b,
                              const VSrc& v, int nrows, const CUtensorMap* ops,
                              int ops_row0, bf16* ops_rows, int opw) {
  static_assert(!(OPS && ROWS), "operand rows are written column split");
  constexpr int NH = wg_cols<ROWS>(HP), NB = wg_cols<ROWS>(WL),
                NV = wg_cols<ROWS>(VL);
  const int tid = fill_tid<ROWS>(), rb = row0_of<ROWS>();
  const int own = own_rows<ROWS>(nrows);
  const int wown = prank() * WL, vown = prank() * VL;  // first own columns
  bf16* act = tile_act<ROWS>(s.act);
  float hd[NH / 2];
  if constexpr (OUT) {
    mm<NH, 0, ROWS>(pp, Prod{M_WDB, 0, 0, W, HP}, hd, act, 0, false, W);
  }
  float acc[NB / 2];
  mm<NB, 0, ROWS>(pp, share(Prod{M_WDB, 0, HP, W, W}), acc, act, 0, false, W);
  if constexpr (!PRODUCER) {
    pre_epilogue<ROWS>();
    const int cb = col0<ROWS>(WL);
    const float* bb = b + OFF_BB + wown;
#pragma unroll
    for (int i = 0; i < NB / 2; i += 2) {
      const int r = frag_row(i), c = cb + frag_col(i);
      act_put2(act, r, c, acc[i] + bb[c], acc[i + 1] + bb[c + 1]);
    }
    if constexpr (OUT) {
#pragma unroll
      for (int i = 0; i < NH / 2; ++i) {
        const int r = rb + frag_row(i), c = col0<ROWS>(HP) + frag_col(i);
        if (c < NDC) s.heads[r * OUT_W + 3 + c] = hd[i] + b[OFF_BD + c];
      }
    }
    for (int i = tid; i < TM * VP / 8; i += FILL<ROWS>) {
      const int r = i / (VP / 8), c = 8 * (i % (VP / 8));
      const uint4 vv = r < own ? vcodes(v, rb + r, c) : make_uint4(0, 0, 0, 0);
      act_chunk(act, r, WL + c) = vv;
      if constexpr (OPS) {
        if (wown == 0) {
          *reinterpret_cast<uint4*>(ops_rows + (size_t)r * opw + O_V + c) = vv;
        }
      }
    }
    post_epilogue<ROWS>();
    if constexpr (OPS) {
      store_blocks(s.act, 0, WL / 64, ops, O_BTL + wown, ops_row0);
    }
  }
  float hv[NV / 2];
  mm<NV, 0, ROWS>(pp, share(Prod{M_WV, 0, 0, VK, VW}), hv, act, 0, false, W);
  if constexpr (!PRODUCER) {
    pre_epilogue<ROWS>();
    const int cv = col0<ROWS>(VL);
    const float* bv = b + OFF_BV + vown;
    uint32_t m[HVW];
#pragma unroll
    for (int k = 0; k < HVW; ++k) m[k] = 0;
#pragma unroll
    for (int i = 0; i < NV / 2; i += 2) {
      const int r = frag_row(i), c = cv + frag_col(i);
      const __nv_bfloat162 h = __floats2bfloat162_rn(
          fmaxf(hv[i] + bv[c], 0.f), fmaxf(hv[i + 1] + bv[c + 1], 0.f));
      *reinterpret_cast<__nv_bfloat162*>(act + act_off(r, c)) = h;
      if constexpr (OPS) {  // column split: VL / 4 bits, HVW words
        m[i >> 5] |= ((__low2float(h) > 0.f ? 1u : 0u) |
                      (__high2float(h) > 0.f ? 2u : 0u)) << (i & 31);
      }
    }
    if constexpr (OPS) {
#pragma unroll
      for (int k = 0; k < HVW; ++k) s.hvmask[k * NT + threadIdx.x] = m[k];
    }
    post_epilogue<ROWS>();
    if constexpr (OPS) {
      store_blocks(s.act, 0, VL / 64, ops, O_HV + vown, ops_row0);
    }
  }
  if constexpr (OUT) {
    float rgb[NH / 2];
    mm<NH, 0, ROWS>(pp, Prod{M_WC, 0, 0, VW, HP}, rgb, act, 0, false, VW);
    if constexpr (!PRODUCER) {
#pragma unroll
      for (int i = 0; i < NH / 2; ++i) {
        const int r = rb + frag_row(i), c = col0<ROWS>(HP) + frag_col(i);
        if (c < 3) s.heads[r * OUT_W + c] = rgb[i] + b[OFF_BC + c];
      }
      tile_sync<ROWS>();
    }
  }
}

// ---- the density-gradient chain (kernels 3 and 4) ----

// The chain's start: sz_7 = m_7 * Wd[sigma row] in act columns 0..WL-1.
template <bool ROWS = false, class Smem>
__device__ void chain_start(Smem& s, const bf16* w) {
  constexpr int NA = wg_cols<ROWS>(WL) / 2, MW = NA / 32;
  bf16* act = tile_act<ROWS>(s.act);
  const int cb = col0<ROWS>(WL);
  const bf16* wd = w + OFF_WD + prank() * WL;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int c = cb + frag_col(i);
    act[act_off(frag_row(i), c)] =
        mask_bit<MW>(s.mask, 7, i) ? wd[c] : __float2bfloat16(0.f);
  }
}

// sz_{layer-1} (or c_layer) = bf16(m * acc) in act columns 0..WL-1.
template <bool ROWS = false, class Smem, int NA>
__device__ void masked_epilogue(Smem& s, const float (&acc)[NA], int layer) {
  constexpr int MW = NA / 32;
  bf16* act = tile_act<ROWS>(s.act);
  const int cb = col0<ROWS>(WL);
#pragma unroll
  for (int i = 0; i < NA; i += 2) {
    act_put2(act, frag_row(i), cb + frag_col(i),
             mask_bit<MW>(s.mask, layer, i) ? acc[i] : 0.f,
             mask_bit<MW>(s.mask, layer, i + 1) ? acc[i + 1] : 0.f);
  }
}

// d raw_sigma / d x through the masked trunk, after trunk_forward left its
// masks: sz_7 = m_7 Wd[0], sz_{i-1} = bf16(m_{i-1} (sz_i @ W_i)). The
// parts of g_x = d raw_sigma / d x come out as the skip columns of layer
// 5's product and layer 0's product (128 columns, XF used), each handed
// to sink(layer, part) in accumulator order (layer 5 first, then 0); the
// sink folds them.
template <bool ROWS = false, bool PRODUCER, int NS, class Smem, class Sink>
__device__ void density_chain(Pipe<PRODUCER, NS>& pp, Smem& s, const bf16* w,
                              Sink sink) {
  constexpr int NW = wg_cols<ROWS>(WL), NX = wg_cols<ROWS>(128);
  bf16* act = tile_act<ROWS>(s.act);
  if constexpr (!PRODUCER) {
    pre_epilogue<ROWS>();
    chain_start<ROWS>(s, w);
    post_epilogue<ROWS>();
  }
  float acc[NW / 2], part[NX / 2];
  for (int layer = 7; layer >= 0; --layer) {
    if (layer == 5 || layer == 0) {  // g_x: layer 5's skip columns + layer 0
      mm<NX, 1, ROWS>(pp, trunk_prod(layer, true, layer == 5 ? W : 0, 128),
                      part, act, 0, false, W);
      if constexpr (!PRODUCER) sink(layer, part);
    }
    if (layer == 0) break;
    mm<NW, 1, ROWS>(pp, share(trunk_prod(layer, true)), acc, act, 0, false, W);
    if constexpr (!PRODUCER) {
      pre_epilogue<ROWS>();
      masked_epilogue<ROWS>(s, acc, layer - 1);
      post_epilogue<ROWS>();
    }
  }
}

// d hv = gr @ Wc (gr the color-head cotangent at act columns 0..15), masked
// by the view branch's ReLU (s.hvmask, as heads_forward kept it), into act
// columns 0..VL-1 (the CTA's own VL columns): each warpgroup writes its
// VL / 2 columns. At VL = 128 each computes just those; at VL = 64 (32
// columns a side, too few for an MN-major B) both compute all 64 and keep
// their own half.
template <bool PRODUCER, class Smem>
__device__ void view_backward(Pipe<PRODUCER>& pp, Smem& s) {
  constexpr bool WHOLE = (VL / 2) % 64 != 0;
  constexpr int NV = WHOLE ? VL : VL / 2;  // columns each warpgroup computes
  constexpr int OWN = VL / 4;              // of them, its own accumulators
  float hv[NV / 2];
  mm<NV, 1, WHOLE>(pp, share(Prod{M_WC, 0, 0, HP, VW}), hv, s.act, 0);
  if constexpr (!PRODUCER) {
    const int g = wg();
    pre_epilogue();
    uint32_t m[HVW];
#pragma unroll
    for (int k = 0; k < HVW; ++k) m[k] = s.hvmask[k * NT + threadIdx.x];
#pragma unroll
    for (int i = 0; i < OWN; i += 2) {
      // Own element i is accumulator i or, WHOLE, accumulator OWN g + i:
      // the same row, column g VL / 2 + frag_col(i).
      const float a = WHOLE && g ? hv[(OWN + i) % (NV / 2)] : hv[i];
      const float b = WHOLE && g ? hv[(OWN + i + 1) % (NV / 2)] : hv[i + 1];
      const uint32_t bits = m[i >> 5] >> (i & 31);  // i even: i + 1 alike
      act_put2(s.act, frag_row(i), g * (VL / 2) + frag_col(i),
               bits & 1u ? a : 0.f, bits & 2u ? b : 0.f);
    }
    post_epilogue();
  }
}

// MLP backward from the head cotangent s.g ([64 x 16] f32: rgb 0..2,
// density 3..3+NDC-1, the lanes past them read as zero; zero on rows that
// must add nothing), after trunk_* and
// heads_forward filled the masks and the forward operand rows. Writes the
// cotangent operand rows (map `ops`, row ops_row0; `ops_rows` the tile's
// first operand row, for the narrow columns), the tile's bias gradients
// into its row `part` of partial sums (all B_TOTAL columns, the padded
// head slots 0; a pair's CTAs each write their own columns, rank 0 the
// heads') and leaves d x (f32 [64 x XF]) in s.dx.
template <bool PRODUCER, class Smem>
__device__ void mlp_backward(Pipe<PRODUCER>& pp, Smem& s, float* part,
                             const CUtensorMap* ops, int ops_row0,
                             bf16* ops_rows, int opw) {
  constexpr int NW = WL / 2, NA = WL / 4;  // columns, accumulators per thread
  const int tid = threadIdx.x, g = wg();
  const int wown = prank() * WL, vown = prank() * VL;  // first own columns
  if constexpr (!PRODUCER) {
    pre_epilogue();
    // Color-head cotangent (bf16, columns 0..2 of 16) as the A operand.
    for (int i = tid; i < TM * HP / 2; i += NT) {
      const int r = i / (HP / 2), c = 2 * (i % (HP / 2));
      act_put2(s.act, r, c, c < 3 ? s.g[r * OUT_W + c] : 0.f,
               c + 1 < 3 ? s.g[r * OUT_W + c + 1] : 0.f);
    }
    // Head biases take the f32 cotangent: d bd (slots 0..HP-1, channel
    // d at lane 3 + d), d bc (slots HP.., color c at lane c).
    if (tid < 2 * HP && wown == 0) {
      const int d = tid % HP;
      const int lane = tid < HP ? (d < NDC ? 3 + d : -1) : (d < 3 ? d : -1);
      float a = 0.f;
      if (lane >= 0) {
        for (int r = 0; r < TM; ++r) a += s.g[r * OUT_W + lane];
      }
      part[(tid < HP ? OFF_BD : OFF_BC) + d] = a;
    }
    post_epilogue();
    if (wown == 0) copy_cols(s.act, 0, HP, ops_rows + O_GR, opw, TM);
  }
  view_backward(pp, s);  // d hv = gr @ Wc, masked
  if constexpr (!PRODUCER) {
    store_blocks(s.act, 0, VL / 64, ops, O_DZV + vown, ops_row0);
    colsum_store(s.act, 0, VL, part + OFF_BV + vown);
  }
  float acc[NA];
  // d btl = dzv @ Wv
  mm<NW, 1>(pp, share(Prod{M_WV, 0, 0, VW, W}), acc, s.act, 0, false, VW);
  if constexpr (!PRODUCER) {
    pre_epilogue();
#pragma unroll
    for (int i = 0; i < NA; i += 2) {
      act_put2(s.act, frag_row(i), g * NW + frag_col(i), acc[i], acc[i + 1]);
    }
    for (int i = tid; i < TM * HP / 2; i += NT) {  // gd at columns WL..WL+15
      const int r = i / (HP / 2), c = 2 * (i % (HP / 2));
      act_put2(s.act, r, WL + c, c < NDC ? s.g[r * OUT_W + 3 + c] : 0.f,
               c + 1 < NDC ? s.g[r * OUT_W + 4 + c] : 0.f);
    }
    post_epilogue();
    store_blocks(s.act, 0, WL / 64, ops, O_DBTL + wown, ops_row0);
    if (wown == 0) copy_cols(s.act, WL, HP, ops_rows + O_GD, opw, TM);
    colsum_store(s.act, 0, WL, part + OFF_BB + wown);
  }
  // d a_7 = dbtl @ Wb + gd @ Wd.
  mm<NW, 1>(pp, share(Prod{M_WDB, HP, 0, W, W}), acc, s.act, 0, false, W);
  mm<NW, 1>(pp, share(Prod{M_WDB, 0, 0, HP, W}), acc, s.act, WL, true);

  // ---- trunk backward ----
  float skip[32];
  for (int layer = 7; layer >= 0; --layer) {
    if constexpr (!PRODUCER) {
      pre_epilogue();
#pragma unroll
      for (int i = 0; i < NA; i += 2) {
        act_put2(s.act, frag_row(i), g * NW + frag_col(i),
                 mask_bit<MWC>(s.mask, layer, i) ? acc[i] : 0.f,
                 mask_bit<MWC>(s.mask, layer, i + 1) ? acc[i + 1] : 0.f);
      }
      post_epilogue();
      store_blocks(s.act, 0, WL / 64, ops, O_DZ + layer * W + wown, ops_row0);
      colsum_store(s.act, 0, WL, part + OFF_BT + layer * W + wown);
    }
    if (layer == 5 || layer == 0) {  // d x: the skip columns, or layer 0's
      mm<64, 1>(pp, trunk_prod(layer, true, layer == 5 ? W : 0, 128), skip,
                s.act, 0, false, W);
      if constexpr (!PRODUCER) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int j = g * 64 + frag_col(i);
          if (j < XF) {
            float* d = s.dx + frag_row(i) * XF + j;
            *d = layer == 5 ? skip[i] : *d + skip[i];
          }
        }
      }
    }
    if (layer > 0) {
      mm<NW, 1>(pp, share(trunk_prod(layer, true)), acc, s.act, 0, false, W);
    }
  }
  if constexpr (!PRODUCER) consumer_sync();
}

// IPE backward of s.dx: cot_y = dx * att cos(y), cot_var = -dx * x / 2,
// added into lanes 0..5 (means, covs) of s.dmc [64 x 8].
template <class Smem>
__device__ void ipe_backward(Smem& s, int min_deg) {
  for (int i = threadIdx.x; i < TM * 6; i += NT) {
    const int r = i / 6, k = i % 6, d = k % 3;
    float acc = 0.f;
    for (int deg = 0; deg < L; ++deg) {
      for (int half = 0; half < 2; ++half) {
        const int j = half * XP + deg * 3 + d;
        const float dxj = s.dx[r * XF + j];
        if (k < 3) {
          acc += dxj * feat_cos(s, r, j, min_deg) * ldexpf(1.f, deg + min_deg);
        } else {
          acc += -0.5f * dxj * feat(s, r, j, min_deg) *
                 ldexpf(1.f, 2 * (deg + min_deg));
        }
      }
    }
    s.dmc[r * 8 + k] += acc;
  }
  consumer_sync();
}

}  // namespace nerf_mlp
