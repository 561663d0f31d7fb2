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
and as many IPE degrees and viewdir codes as a build's activation tile
and shared memory hold (`max_degrees`, `max_view_dim`: the sums of the
CUDA sources' static_asserts, `smem_bytes`).

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
# What the CUDA builds take (csrc/nerf_mlp.cuh's static_asserts). The
# 1,024 trunk runs each tile on a pair of CTAs (csrc/mlp_rows.cuh `PAIR`);
# the 512 view branch is built only beside it, and there the view branch
# is at least 128 wide.
WIDTHS = (128, 256, 512, 1024)     # trunk
VIEW_WIDTHS = (64, 128, 256, 512)  # view branch
PAIR_W = 1024           # the trunk build whose tiles run on a CTA pair
PAIR_MIN_VW = 128       # its narrowest view-branch build
DENSITY_CHANNELS = (1, 5)    # mip-NeRF, Pano-NeRF
# What bounds the IPE degrees L = max_deg - min_deg and the viewdir codes
# of a build (csrc/nerf_mlp.cuh, csrc/mlp_rows.cuh): the padded features
# XF within the 128 columns of the g_x and d x products, the activation
# tile's 640 columns (the CTA's trunk columns and the widest input beside
# them) and each kernel's shared memory (`smem_bytes`). The plain versions
# on the CPU take any from 1.
MAX_XF = 128
MAX_ACT_COLS = 640
TM, NT = 64, 256        # tile rows, consumer threads
SMEM_LIMIT = 232448     # bytes of shared memory a block may have


def pad16(n: int) -> int:
    return -(-n // 16) * 16


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
    257..512 -> 512, 513..1024 -> 1024), the view branch to the next of
    VIEW_WIDTHS (1..64 -> 64, 65..128 -> 128, 129..256 -> 256, 257..512 ->
    512); a view branch above 256 runs in the 1,024 trunk build, and that
    build's view branch is at least 128 (`PAIR_MIN_VW`); C, L and VF
    unchanged. ValueError past the widest build."""
    W = _round_up(shape.W, WIDTHS, "trunk width")
    VW = _round_up(shape.VW, VIEW_WIDTHS, "view-branch width")
    if VW > VIEW_WIDTHS[-2]:
        W = PAIR_W
    if W == PAIR_W:
        VW = max(VW, PAIR_MIN_VW)
    return shape._replace(W=W, VW=VW)


def build_of(mlp: NerfMLP) -> MlpShape:
    """`build_shape` of `shape_of(mlp)`: the shape of the library the
    wrappers load for `mlp` on the card."""
    return build_shape(shape_of(mlp))


def _extent(*arrays: int, barriers: int) -> int:
    """csrc/mlp_rows.cuh `smem_bytes` of a kernel's Smem whose members are
    the 1024-aligned tile and ring, 4-byte arrays (sizes in bytes, the
    first two included) and then `barriers` uint64 mbarriers, `io` last:
    the offset past `io` plus the 1024 bytes of alignment slack."""
    n = sum(arrays)
    return -(-n // 8) * 8 + 8 * barriers + 1024


def smem_bytes(shape: MlpShape) -> Dict[str, int]:
    """Each kernel's dynamic shared memory in the build of `shape`, as the
    CUDA sources lay it out (their `Smem` structs, mirrored member by
    member): kernels 1-3 (fused_mlp.cu), kernel 5 (fused_render_train.cu)
    and kernel 4 (fused_render.cu, with and without the fine level's
    masks). Each must be at most `smem_limit(shape)`; the sources
    static_assert the same."""
    W, VW, XF = shape.W, shape.VW, shape.XF
    pair = 2 if W > 512 else 1
    WL, VL = W // pair, VW // pair
    ring = 2 if WL > 256 else 3
    blocks = -(-act_cols(shape) // 64)
    stage = 1 if pair > 1 else 0
    f32 = lambda n: 4 * n
    act, rng = 8192 * (blocks + stage), ring * 32768
    mask = f32(8 * (WL // 128) * NT)
    hvmask = f32(-(-(VL // 4) // 32) * NT)
    x32 = f32(TM * XF if W <= 256 and XF <= 96 else 1)
    dx = f32(TM * max(XF, 16))      # d x over the head slab / cotangent
    mc, heads = f32(TM * 8), f32(TM * 16)
    rows, clip = f32(12 * TM), f32(2 * TM)
    bars = 2 * ring + 1
    out = {
        "fused_mlp forward": _extent(act, rng, mask, x32, f32(TM * XF), mc,
                                     heads, barriers=bars),
        "fused_mlp backward": _extent(act, rng, mask, hvmask, x32, dx,
                                      f32(TM * 4), mc, mc, barriers=bars),
        "fused_render_train forward": _extent(act, rng, mask, x32, mc, heads,
                                              rows, clip, barriers=bars),
        "fused_render_train backward": _extent(act, rng, mask, hvmask, x32,
                                               dx, mc, mc, rows, clip,
                                               barriers=bars),
    }
    rs = W <= 256                   # kernel 4's row split
    tr = 2 * TM if rs else TM
    for nrm in (True, False):
        ns = 2 if nrm and (rs or pair > 1) else 3
        out[f"fused_render {'fine' if nrm else 'coarse'}"] = _extent(
            2 * ((2 if rs else 1) * TM * 64 * blocks + stage * TM * 64),
            ns * 32768, f32(8 * (W // 64 if rs else WL // 128) * NT
                            if nrm else 1),
            f32(tr * 8), f32(tr * 16), f32(13 * tr), f32(tr * 8),
            f32((1 if rs else 2) * tr * 4), f32(tr), barriers=2 * ns + 1)
    return out


def act_cols(shape: MlpShape) -> int:
    """The activation tile's columns in the build of `shape`: the CTA's
    trunk columns and the widest input beside them (csrc/mlp_rows.cuh
    `ACT_COLS`)."""
    WL = shape.W // (2 if shape.W > 512 else 1)
    return WL + max(shape.XF, shape.VP, HP)


def smem_limit(shape: MlpShape) -> int:
    """Shared memory a block of the build may take (a pair CTA gives 16
    bytes to its barrier)."""
    return SMEM_LIMIT - (16 if shape.W > 512 else 0)


def encoding_gaps(shape: MlpShape) -> Tuple[str, ...]:
    """What of the build of `shape` (a `build_shape`) does not fit, by the
    CUDA sources' static_asserts: the IPE features past MAX_XF, the tile
    past MAX_ACT_COLS, or a kernel's shared memory past the limit; () where
    it builds. Kernels 4 and 5 count where they are built (5 density
    channels and a viewdir encoding with identity)."""
    gaps = []
    if shape.XF > MAX_XF:
        gaps.append(f"{shape.XF} IPE feature columns > {MAX_XF}")
    if act_cols(shape) > MAX_ACT_COLS:
        gaps.append(f"{act_cols(shape)} tile columns > {MAX_ACT_COLS}")
    for name, n in smem_bytes(shape).items():
        built = name.startswith("fused_mlp") or (shape.C == 5
                                                 and shape.VF % 6 == 3)
        if built and n > smem_limit(shape):
            gaps.append(f"{name} {n} bytes of shared memory > "
                        f"{smem_limit(shape)}")
    return tuple(gaps)


def max_degrees(build: MlpShape) -> int:
    """The most IPE degrees the build of `build`'s widths and channels
    takes beside its viewdir encoding (beside deg_view 1 where that
    encoding does not fit even one degree)."""
    if encoding_gaps(build._replace(L=1)):
        build = build._replace(VF=6 + build.VF % 6)
    return max((L for L in range(1, MAX_XF // 6 + 1)
                if not encoding_gaps(build._replace(L=L))), default=0)


def max_deg_view(build: MlpShape, identity: bool = True) -> int:
    """The highest deg_view (viewdir codes 6 deg_view, + 3 with identity)
    the build of `build`'s widths and channels takes beside its IPE
    degrees (beside one degree where those do not fit at deg_view 1)."""
    extra = 3 if identity else 0
    if encoding_gaps(build._replace(VF=6 + extra)):
        build = build._replace(L=1)
    return max((d for d in range(1, MAX_ACT_COLS // 6 + 1)
                if not encoding_gaps(build._replace(VF=6 * d + extra))),
               default=0)


def build_name(build: MlpShape) -> str:
    """'the 256 / 128 build' of `build`'s widths."""
    return f"the {build.W} / {build.VW} build"


def shape_gaps(mlp: NerfMLP, min_deg: int, max_deg: int,
               device: torch.device) -> Tuple[Dict, Dict]:
    """(what the kernels take, what `mlp` has that they do not): the
    topology (8-deep trunk with the skip at layer 4, one view layer, 3 rgb
    channels), at least one IPE degree (L = max_deg - min_deg) over the
    MLP's 6 L features and a viewdir encoding (`is_view_dim`) on every
    device; on the card also trunk widths 1..1024 and view-branch widths
    1..512 (each runs in the build `build_shape` names), the
    density-channel counts and bf16 compute the CUDA builds take, and at
    most the IPE degrees and viewdir degrees of that build (`max_degrees`,
    `max_deg_view`). The plain versions on the CPU take any width, count
    and degree."""
    cuda = device.type == "cuda"
    want = dict(net_depth=(8,), skip_index=(4,), net_depth_condition=(1,),
                num_rgb_channels=(3,))
    if cuda:
        want.update(net_width=range(1, WIDTHS[-1] + 1),
                    net_width_condition=range(1, VIEW_WIDTHS[-1] + 1),
                    num_density_channels=DENSITY_CHANNELS)
    bad = {k: getattr(mlp, k) for k, v in want.items()
           if getattr(mlp, k) not in v}
    want["view_dim"] = "6 deg_view (+ 3 with identity), deg_view >= 1"
    if not is_view_dim(mlp.view_dim):
        bad["view_dim"] = mlp.view_dim
    L = max_deg - min_deg
    want["deg"] = "max_deg - min_deg >= 1"
    if L < 1:
        bad["deg"] = (min_deg, max_deg)
    elif mlp.xyz_dim != 6 * L:
        bad["xyz_dim"] = (mlp.xyz_dim, 6 * L)
    elif cuda and not bad and encoding_gaps(build_of(mlp)):
        build, identity = build_of(mlp), mlp.view_dim % 6 == 3
        top_l, top_v = max_degrees(build), max_deg_view(build, identity)
        want["deg"] = f"max_deg - min_deg in 1..{top_l} ({build_name(build)})"
        want["view_dim"] += f", deg_view 1..{top_v} ({build_name(build)})"
        if L > top_l:
            bad["deg"] = (min_deg, max_deg)
        if mlp.view_dim // 6 > top_v:
            bad["view_dim"] = mlp.view_dim
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


