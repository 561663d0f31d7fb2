// Shared by the port's CUDA kernels (fused_render.cu, fused_mlp.cu,
// fused_render_train.cu): the NerfMLP specialisation they are compiled
// for, the packed weight layout of kernels/fused_render.py `pack_params`
// and the activations. The products themselves are mlp_rows.cuh's wgmma
// steps.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nerf_mlp {

typedef __nv_bfloat16 bf16;

// The NerfMLP shape a build is compiled for (kernels/fused_mlp_ipe.py
// `MlpShape.defines`; the defaults are the shipped 8x256 / 1x128 model on
// IPE degrees 0..16 and the deg-4 viewdir encoding with identity):
//   NERF_W   trunk width, 128, 256 or 512;
//   NERF_VW  view-branch width, 64, 128 or 256;
//   NERF_L   IPE degrees, max_deg_point - min_deg_point (1..16; min_deg
//            is a runtime argument of every kernel);
//   NERF_VF  viewdir encoding width, 6 deg_view (+ 3 with identity),
//            deg_view 1..4;
//   NERF_NDC density channels of the head, 5 (Pano-NeRF) or 1 (mip-NeRF).
#ifndef NERF_W
#define NERF_W 256
#endif
#ifndef NERF_VW
#define NERF_VW 128
#endif
#ifndef NERF_L
#define NERF_L 16
#endif
#ifndef NERF_VF
#define NERF_VF 27
#endif
constexpr int W = NERF_W;    // trunk width
constexpr int VW = NERF_VW;  // view-branch width
constexpr int L = NERF_L;    // IPE degrees
constexpr int XP = 3 * L;    // IPE sin block (3 dims x L degrees); cos next
// IPE features [sin (XP) | cos (XP) | 0], padded to wgmma's K step of 16;
// the padded columns are zero going forward, and the packed weights'
// columns over them are zero, so they get no gradient going backward.
constexpr int XF = (2 * XP + 15) / 16 * 16;
constexpr int VF = NERF_VF;             // viewdir encoding width
constexpr int VP = (VF + 15) / 16 * 16;  // the same, padded (zero past VF)
constexpr int VK = W + VP;  // view-layer input: bottleneck | viewdir codes
constexpr int HP = 16;      // padded head width (density <= 13, color 3)
static_assert(W == 128 || W == 256 || W == 512,
              "trunk widths: 128, 256 or 512");
static_assert(VW == 64 || VW == 128 || VW == 256,
              "view-branch widths: 64, 128 or 256");
static_assert(L >= 1 && L <= 16, "IPE degrees: 1..16");
static_assert(VF >= 6 && VF <= 27 && (VF % 6 == 0 || VF % 6 == 3),
              "viewdir encodings: deg_view 1..4, with or without identity");
// Density channels of the head: 5 for Pano-NeRF (sigma | albedo(3) |
// roughness), 1 for mip-NeRF (sigma). The padded head (HP) and the packed
// layout are the same for both.
#ifndef NERF_NDC
#define NERF_NDC 5
#endif
constexpr int NDC = NERF_NDC;
static_assert(NDC >= 1 && NDC <= HP - 3, "the head holds rgb and density");
constexpr int TM = 64;   // sample rows of one warpgroup product's A tile
constexpr int NT = 256;  // consumer threads per block (two warpgroups)

// Packed bf16 weights: every layer as torch's [out, in], padded to
// multiples of 16 (offsets in elements; shapes at the default W 256, VW
// 128, XF 96, VK 288).
constexpr int OFF_W0 = 0;                      // [256 x 96]
constexpr int OFF_W1 = OFF_W0 + W * XF;        // layers 1..4, [256 x 256]
constexpr int OFF_W5 = OFF_W1 + 4 * W * W;     // [256 x 352]
constexpr int OFF_W6 = OFF_W5 + W * (W + XF);  // layers 6..7, [256 x 256]
constexpr int OFF_WD = OFF_W6 + 2 * W * W;     // [16 x 256]
constexpr int OFF_WB = OFF_WD + HP * W;        // [256 x 256], right after Wd
constexpr int OFF_WV = OFF_WB + W * W;         // [128 x 288]
constexpr int OFF_WC = OFF_WV + VW * VK;       // [16 x 128]
constexpr int W_TOTAL = OFF_WC + HP * VW;
// Packed f32 biases.
constexpr int OFF_BT = 0;               // trunk layers 0..7, W each
constexpr int OFF_BD = 8 * W;           // 16
constexpr int OFF_BB = OFF_BD + HP;     // 256
constexpr int OFF_BV = OFF_BB + W;      // 128
constexpr int OFF_BC = OFF_BV + VW;     // 16
constexpr int B_TOTAL = OFF_BC + HP;

// Accurate softplus and sigmoid (expf / log1pf; no fast-math intrinsics).
__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ int trunk_in(int layer) {
  return layer == 0 ? XF : (layer == 5 ? W + XF : W);
}

// The build's shape, for the wrappers' check against the model:
// {density channels, W, VW, L, VF}.
#define NERF_SHAPE_EXPORT(name)                                         \
  extern "C" void name(int* shape) {                                    \
    const int s[5] = {nerf_mlp::NDC, nerf_mlp::W, nerf_mlp::VW,         \
                      nerf_mlp::L, nerf_mlp::VF};                       \
    for (int i = 0; i < 5; ++i) shape[i] = s[i];                        \
  }

}  // namespace nerf_mlp
