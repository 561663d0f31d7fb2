"""The NerfMLP shapes the port's CUDA kernels are built for.

The kernels' widths and encodings are compile-time constants of the CUDA
sources (csrc/nerf_mlp.cuh: NERF_NDC, NERF_W, NERF_VW, NERF_L, NERF_VF).
`MlpShape` is one such shape, `MlpShape.defines` its build's preprocessor
definitions (none for the shipped shape), `shape_of` a model's shape,
`build_shape` / `build_of` the build a model runs in on the card and
`shape_gaps` what a model has that the kernels on a device do not take.
The plain versions on the CPU take any width, density-channel count, IPE
degree count and viewdir encoding degree, as JAX's kernels do; the
builds on the card take the widths of WIDTHS / VIEW_WIDTHS and below,
IPE degrees 1..16 and deg_view 1..4.

A model narrower than a build runs in it zero-padded
(`fused_render.pack_params`): a padded hidden unit has zero weights in
and out and a zero bias, so it outputs relu(0) = 0, adds nothing, and
its cotangent and every weight gradient that touches it are exactly 0.
So a 64-wide trunk in the 128 build computes what the 64-wide MLP does.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from pano_nerf_tpu_torch.models.mlp import NerfMLP

HP = 16        # padded head width
# What the CUDA builds take (csrc/nerf_mlp.cuh's static_asserts).
WIDTHS = (128, 256, 512)     # trunk
VIEW_WIDTHS = (64, 128, 256)  # view branch
DENSITY_CHANNELS = (1, 5)    # mip-NeRF, Pano-NeRF
# IPE degrees L = max_deg - min_deg and viewdir encoding degrees the
# builds take (1..16, 1..4: the activation tile's XF and VP columns); the
# plain versions on the CPU take any from 1.
MAX_DEGREES = 16
MAX_DEG_VIEW = 4


def pad16(n: int) -> int:
    return -(-n // 16) * 16


def view_dims() -> Tuple[int, ...]:
    """The viewdir encoding widths the builds take: 6 deg_view, or 3 + 6
    deg_view with identity, deg_view 1..4."""
    return tuple(sorted(6 * d + i for d in range(1, MAX_DEG_VIEW + 1)
                        for i in (0, 3)))


def is_view_dim(view_dim: int) -> bool:
    """Whether `view_dim` is a viewdir encoding's width at any degree:
    6 deg_view, or 3 + 6 deg_view with identity, deg_view >= 1."""
    return view_dim >= 6 and view_dim % 6 in (0, 3)


class MlpShape(NamedTuple):
    """The NerfMLP shape a build of the CUDA sources is compiled for (the
    defaults are the shipped one: 8x256 trunk, 1x128 view branch, 5
    density channels, IPE degrees 0..16, deg-4 viewdir encoding with
    identity), and the padded widths that follow from it."""
    C: int = 5      # density channels
    W: int = 256    # trunk width
    VW: int = 128   # view-branch width
    L: int = 16     # IPE degrees
    VF: int = 27    # viewdir encoding width

    @property
    def XP(self) -> int:
        """The IPE's sin block (its cos block follows)."""
        return 3 * self.L

    @property
    def XF(self) -> int:
        """IPE features, padded to wgmma's K step of 16."""
        return pad16(6 * self.L)

    @property
    def VP(self) -> int:
        """Viewdir codes, padded to 16."""
        return pad16(self.VF)

    @property
    def VK(self) -> int:
        """The view layer's input: bottleneck | viewdir codes."""
        return self.W + self.VP

    def defines(self, with_channels: bool = True) -> Tuple[str, ...]:
        """The preprocessor definitions of this shape's build: one per
        value other than the default (so the shipped shape builds with
        none). `with_channels` False leaves out NERF_NDC, for the render
        kernels, which take C = 5 only."""
        names = dict(C="NERF_NDC", W="NERF_W", VW="NERF_VW", L="NERF_L",
                     VF="NERF_VF")
        return tuple(f"{names[k]}={v}" for k, v in self._asdict().items()
                     if v != getattr(STANDARD, k)
                     and (with_channels or k != "C"))


STANDARD = MlpShape()


def shape_of(mlp: NerfMLP) -> MlpShape:
    """The kernel shape of `mlp` (its IPE width is 6 L)."""
    return MlpShape(mlp.num_density_channels, mlp.net_width,
                    mlp.net_width_condition, mlp.xyz_dim // 6, mlp.view_dim)


def _round_up(n: int, sizes: Sequence[int], what: str) -> int:
    for size in sizes:
        if 1 <= n <= size:
            return size
    raise ValueError(f"no kernel build takes {what} {n} (builds: "
                     f"{tuple(sizes)})")


def build_shape(shape: MlpShape) -> MlpShape:
    """The build a model of `shape` runs in on the card: the trunk width
    rounded up to the next of WIDTHS (1..128 -> 128, 129..256 -> 256,
    257..512 -> 512), the view branch to the next of VIEW_WIDTHS (1..64 ->
    64, 65..128 -> 128, 129..256 -> 256); C, L and VF unchanged.
    ValueError past the widest build."""
    return shape._replace(W=_round_up(shape.W, WIDTHS, "trunk width"),
                          VW=_round_up(shape.VW, VIEW_WIDTHS,
                                       "view-branch width"))


def build_of(mlp: NerfMLP) -> MlpShape:
    """`build_shape` of `shape_of(mlp)`: the shape of the library the
    wrappers load for `mlp` on the card."""
    return build_shape(shape_of(mlp))


def shape_gaps(mlp: NerfMLP, min_deg: int, max_deg: int,
               device: torch.device) -> Tuple[Dict, Dict]:
    """(what the kernels take, what `mlp` has that they do not): the
    topology (8-deep trunk with the skip at layer 4, one view layer, 3 rgb
    channels), at least one IPE degree (L = max_deg - min_deg) over the
    MLP's 6 L features and a viewdir encoding (`is_view_dim`) on every
    device; on the card also IPE degrees 1..16, viewdir encodings of
    `view_dims` (deg_view 1..4), trunk widths 1..512 and view-branch
    widths 1..256 (each runs in the build `build_shape` names), the
    density-channel counts and bf16 compute the CUDA builds take. The
    plain versions on the CPU take any width, count and degree."""
    cuda = device.type == "cuda"
    want = dict(net_depth=(8,), skip_index=(4,), net_depth_condition=(1,),
                num_rgb_channels=(3,))
    if cuda:
        want.update(view_dim=view_dims(),
                    net_width=range(1, WIDTHS[-1] + 1),
                    net_width_condition=range(1, VIEW_WIDTHS[-1] + 1),
                    num_density_channels=DENSITY_CHANNELS)
    bad = {k: getattr(mlp, k) for k, v in want.items()
           if getattr(mlp, k) not in v}
    if not cuda:
        want["view_dim"] = "6 deg_view (+ 3 with identity), deg_view >= 1"
        if not is_view_dim(mlp.view_dim):
            bad["view_dim"] = mlp.view_dim
    L = max_deg - min_deg
    want["deg"] = (f"max_deg - min_deg in 1..{MAX_DEGREES}" if cuda
                   else "max_deg - min_deg >= 1")
    if L < 1 or (cuda and L > MAX_DEGREES):
        bad["deg"] = (min_deg, max_deg)
    elif mlp.xyz_dim != 6 * L:
        bad["xyz_dim"] = (mlp.xyz_dim, 6 * L)
    if cuda and mlp.compute_dtype != torch.bfloat16:
        want["compute_dtype"] = "bf16 (train.precision)"
        bad["compute_dtype"] = mlp.compute_dtype
    return want, bad


def check_built_shape(lib: ctypes.CDLL, fn: str, shape: MlpShape,
                      defines: Sequence[str]) -> None:
    """Raise unless the library's `fn` ({C, W, VW, L, VF} of the build)
    reports `shape` (the render kernels' builds report C = 5)."""
    getattr(lib, fn).argtypes = [ctypes.POINTER(ctypes.c_int)]
    getattr(lib, fn).restype = None
    got = (ctypes.c_int * 5)()
    getattr(lib, fn)(got)
    if tuple(got) != tuple(shape):
        raise RuntimeError(f"the library built with {list(defines)} has the "
                           f"shape {tuple(got)}, not {tuple(shape)}")


