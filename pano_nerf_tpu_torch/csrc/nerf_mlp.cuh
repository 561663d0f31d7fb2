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

constexpr int W = 256;   // trunk width
constexpr int XF = 96;   // IPE features: 16 degrees x 3 dims x (sin | cos)
constexpr int XP = 48;   // half of XF (the sin block)
constexpr int VK = 288;  // view-layer input: bottleneck 256 + 27, padded
constexpr int VW = 128;  // view-branch width
constexpr int HP = 16;   // padded head width (density 5, color 3)
// Density channels of the head: 5 for Pano-NeRF (sigma | albedo(3) |
// roughness), 1 for mip-NeRF (sigma). A compile-time parameter of the row
// passes, set per build (-DNERF_NDC=1 or 5; kernels/build.py); the padded
// head (HP) and the packed layout are the same for both.
#ifndef NERF_NDC
#define NERF_NDC 5
#endif
constexpr int NDC = NERF_NDC;
static_assert(NDC >= 1 && NDC <= HP - 3, "the head holds rgb and density");
constexpr int TM = 64;   // sample rows of one warpgroup product's A tile
constexpr int NT = 256;  // consumer threads per block (two warpgroups)

// Packed bf16 weights: every layer as torch's [out, in], padded to
// multiples of 16 (offsets in elements).
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
constexpr int OFF_BT = 0;               // trunk layers 0..7, 256 each
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

}  // namespace nerf_mlp
