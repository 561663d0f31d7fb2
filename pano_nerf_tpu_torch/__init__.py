"""pano-nerf-tpu-torch: the PyTorch/CUDA port of pano_nerf_tpu for NVIDIA Hopper.

Renders validation panoramas of a Pano-NeRF radiance field (coarse level,
fine level with density-gradient normals, Lambertian irradiance path) on an
H100. Every MLP evaluation of the render path goes through the hand-written
CUDA kernel in `csrc/fused_render.cu`; plain PyTorch versions of each kernel
serve CPU tensors (the test suite) and the on-card comparisons.

The package imports neither JAX nor `pano_nerf_tpu`: the layout mirrors the
JAX package (core/ data/ ops/ models/ kernels/ engine/ utils/) so each
module's counterpart is easy to find, but every numpy helper it needs is
its own copy.
"""

__version__ = "0.1.0"
