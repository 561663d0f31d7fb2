// Shared by the port's CUDA kernels (fused_render.cu, fused_mlp.cu,
// fused_render_train.cu): the NerfMLP specialisation they are compiled
// for, the packed weight layout of kernels/fused_render.py `pack_params`
// and the activations; and the 64-row WMMA product of the eval kernel
// (fused_render.cu; the training kernels use mlp_rows.cuh's wgmma steps).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace nerf_mlp {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int W = 256;   // trunk width
constexpr int XF = 96;   // IPE features: 16 degrees x 3 dims x (sin | cos)
constexpr int XP = 48;   // half of XF (the sin block)
constexpr int VK = 288;  // view-layer input: bottleneck 256 + 27, padded
constexpr int VW = 128;  // view-branch width
constexpr int HP = 16;   // padded head width (density 5, color 3)
constexpr int NDC = 5;   // density channels: sigma | albedo(3) | roughness
constexpr int TM = 64;   // sample rows per block
constexpr int NT = 256;  // threads per block
constexpr int NWARP = NT / 32;
constexpr int ACT_LD = W + XF + 8;  // bf16 activation row stride
constexpr int ST_LD = W + XF + 4;   // f32 staging row stride
constexpr int MASK_WORDS = W / 32;

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

__device__ __forceinline__ int trunk_offset(int layer) {
  if (layer == 0) return OFF_W0;
  if (layer <= 4) return OFF_W1 + (layer - 1) * W * W;
  if (layer == 5) return OFF_W5;
  return OFF_W6 + (layer - 6) * W * W;
}

__device__ __forceinline__ int trunk_in(int layer) {
  return layer == 0 ? XF : (layer == 5 ? W + XF : W);
}

// C[64 x N] = A[64 x K] @ B[K x N]; A bf16 row-major in shared memory,
// B bf16 in global memory, C f32 in shared memory. BLayout col_major reads
// B from a torch weight [N, K] (forward, x @ W^T); row_major from a weight
// [K, N] (s @ W). K and N are multiples of 16.
template <typename BLayout>
__device__ void tile_matmul(const bf16* A, int lda, int K, const bf16* B,
                            int ldb, int N, float* C, int ldc) {
  const int warp = threadIdx.x >> 5;
  for (int nt = warp; nt < N / 16; nt += NWARP) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TM / 16];
#pragma unroll
    for (int m = 0; m < TM / 16; ++m) wmma::fill_fragment(acc[m], 0.f);
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> bfrag;
      const bf16* bp;
      if constexpr (std::is_same<BLayout, wmma::col_major>::value) {
        bp = B + (size_t)nt * 16 * ldb + k0;
      } else {
        bp = B + (size_t)k0 * ldb + nt * 16;
      }
      wmma::load_matrix_sync(bfrag, bp, ldb);
#pragma unroll
      for (int m = 0; m < TM / 16; ++m) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afrag;
        wmma::load_matrix_sync(afrag, A + m * 16 * lda + k0, lda);
        wmma::mma_sync(acc[m], afrag, bfrag, acc[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < TM / 16; ++m) {
      wmma::store_matrix_sync(C + m * 16 * ldc + nt * 16, acc[m], ldc,
                              wmma::mem_row_major);
    }
  }
}

}  // namespace nerf_mlp
