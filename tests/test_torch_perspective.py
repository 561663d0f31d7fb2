"""The port's PNG reader and perspective-camera datasets against Pillow
and the JAX package's loaders, on the CPU.

- `data/png.py` against Pillow (here, test-side only) on 8-bit gray,
  gray + alpha, RGB and RGBA and 16-bit gray files, and against the
  samples themselves on files this test encodes with each row filter
  (0 none .. 4 Paeth) at 8 and 16 bits; palette and interlaced files
  refused, naming what they are;
- tiny Multicam, Blender and LLFF/360 scenes on disk: the port's loaders
  give JAX's rays and images (atol 1e-6), train (flattened) and held-out
  splits;
- `read_colmap_intrinsics` on a synthesized cameras.bin.
"""

import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from pano_nerf_tpu.data import perspective_datasets as jax_pd
from pano_nerf_tpu_torch.core.rays import RAYS_KEYS
from pano_nerf_tpu_torch.data import perspective_datasets as pd
from pano_nerf_tpu_torch.data.png import read_png
import torch_threads  # noqa: F401  (tests/torch_threads.py)

COLOR = {1: 0, 2: 4, 3: 2, 4: 6}   # channels -> PNG color type


def _filter_row(kind, line, prev, bpp):
    """Encode one row of bytes with filter `kind` (ints 0..255)."""
    out = []
    for i, x in enumerate(line):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
        out.append((x - pred) & 255)
    return out


def write_png_filtered(path, img, interlace=0, color=None):
    """[H, W, C] uint8 / uint16 -> PNG, row y with filter y % 5."""
    h, w, c = img.shape
    depth = 16 if img.dtype == np.uint16 else 8
    data = img.astype(">u2" if depth == 16 else np.uint8).tobytes()
    stride = w * c * depth // 8
    bpp = c * depth // 8
    raw, prev = bytearray(), [0] * stride
    for y in range(h):
        line = list(data[y * stride:(y + 1) * stride])
        raw.append(y % 5)
        raw.extend(_filter_row(y % 5, line, prev, bpp))
        prev = line

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))
    ihdr = struct.pack(">IIBBBBB", w, h, depth,
                       COLOR[c] if color is None else color, 0, 0, interlace)
    with open(path, "wb") as fp:
        fp.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                 + chunk(b"IDAT", zlib.compress(bytes(raw)))
                 + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "I;16"])
def test_png_reader_matches_pillow(tmp_path, mode):
    rng = np.random.default_rng(len(mode))
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "I;16": 1}[mode]
    hi = 65536 if mode == "I;16" else 256
    img = rng.integers(0, hi, size=(11, 13, c)).astype(
        np.uint16 if hi > 256 else np.uint8)
    img[:, :4] = img[:1, :4]   # smooth columns, so encoders pick filters
    im = (Image.fromarray(img[..., 0]) if mode == "I;16"
          else Image.fromarray(img[..., 0] if c == 1 else img, mode))
    for level in (0, 9):
        path = str(tmp_path / f"{level}.png")
        im.save(path, compress_level=level)
        got = read_png(path)
        want = np.array(Image.open(path))
        assert got.dtype == want.dtype
        assert np.array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reader_undoes_every_filter(tmp_path, channels, depth):
    rng = np.random.default_rng(channels * depth)
    img = rng.integers(0, 2 ** depth, size=(10, 7, channels)).astype(
        np.uint16 if depth == 16 else np.uint8)
    path = str(tmp_path / "f.png")
    write_png_filtered(path, img)
    got = read_png(path)
    assert got.dtype == img.dtype and np.array_equal(got, img)


def test_png_reader_refuses_palette_and_interlaced(tmp_path):
    img = np.zeros((4, 4, 1), np.uint8)
    path = str(tmp_path / "p.png")
    write_png_filtered(path, img, color=3)
    with pytest.raises(ValueError, match="palette"):
        read_png(path)
    write_png_filtered(path, img, interlace=1)
    with pytest.raises(ValueError, match="interlaced"):
        read_png(path)


def _write_blender_scene(root, n=2, h=6, w=5):
    os.makedirs(os.path.join(root, "r"), exist_ok=True)
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        frames = []
        for i in range(n):
            img = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
            fname = f"r/{split}_{i}"
            Image.fromarray(img, "RGBA").save(os.path.join(root,
                                                           fname + ".png"))
            c2w = np.eye(4)
            c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            c2w[:3, 3] = rng.uniform(-1, 1, 3)
            frames.append({"file_path": fname,
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as fp:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, fp)


def _write_multicam_scene(root, n=2):
    os.makedirs(os.path.join(root, "imgs"), exist_ok=True)
    rng = np.random.default_rng(1)
    meta = {k: [] for k in ("file_path", "pix2cam", "cam2world", "width",
                            "height", "lossmult", "near", "far")}
    for i, (h, w) in enumerate([(8, 6), (4, 3)][:n]):
        img = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
        rel = f"imgs/{i}.png"
        Image.fromarray(img, "RGBA").save(os.path.join(root, rel))
        c2w = np.eye(4)
        c2w[:3, 3] = [i, 0.5, -1]
        meta["file_path"].append(rel)
        meta["pix2cam"].append([[1 / 10, 0, -w / 20], [0, -1 / 10, h / 20],
                                [0, 0, -1]])
        meta["cam2world"].append(c2w.tolist())
        meta["width"].append(w)
        meta["height"].append(h)
        meta["lossmult"].append(1.0 + i)
        meta["near"].append(2.0)
        meta["far"].append(6.0)
    with open(os.path.join(root, "metadata.json"), "w") as fp:
        json.dump({"train": meta, "test": meta}, fp)


def _write_colmap_cameras(path_bin, fx=100.0, fy=100.0, cx=4.0, cy=4.0):
    os.makedirs(os.path.dirname(path_bin), exist_ok=True)
    with open(path_bin, "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, 8, 8))
        f.write(struct.pack("<dddd", fx, fy, cx, cy))


def _write_llff_scene(root, n=9, h=8, w=8):
    os.makedirs(os.path.join(root, "images_2"), exist_ok=True)
    rng = np.random.default_rng(2)
    for i in range(n):
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, "images_2",
                                               f"{i:03d}.png"))
    poses = np.zeros((n, 3, 5))
    for i, th in enumerate(np.linspace(0, 2 * np.pi, n, endpoint=False)):
        pos = np.array([3 * np.cos(th), 3 * np.sin(th),
                        0.5 + 0.2 * rng.uniform()])
        z = pos / np.linalg.norm(pos)
        x = np.cross([0, 0, 1.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        poses[i] = np.stack([-y, x, z, pos, [h * 2, w * 2, 100.0]], 1)
    bounds = np.tile([[1.0, 8.0]], (n, 1))
    np.save(os.path.join(root, "poses_bounds.npy"),
            np.concatenate([poses.reshape(n, -1), bounds], axis=1))
    _write_colmap_cameras(os.path.join(root, "sparse", "0", "cameras.bin"),
                          90.0, 95.0, 4.5, 3.5)


SCENES = {"multicam": (_write_multicam_scene, "Multicam", ("train", "test"),
                       {}),
          "blender": (_write_blender_scene, "Blender", ("train", "val"),
                      {"white_bkgd": True}),
          "llff": (_write_llff_scene, "RealData360", ("train", "test"),
                   {"factor": 2})}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_loaders_match_jax(tmp_path, scene):
    write, cls, splits, kw = SCENES[scene]
    root = str(tmp_path)
    write(root)
    for split in splits:
        got = getattr(pd, cls)(root, split=split, **kw)
        want = getattr(jax_pd, cls)(root, split=split, **kw)
        assert len(got) == len(want)
        for k in RAYS_KEYS:
            a, b = getattr(got.rays, k), getattr(want.rays, k)
            if isinstance(b, list):
                assert len(a) == len(b)
            else:
                a, b = [a], [b]
            for x, y in zip(a, b):
                np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                           atol=1e-6, err_msg=k)
        imgs = got.images if isinstance(got.images, list) else [got.images]
        jimgs = (want.images if isinstance(want.images, list)
                 else [want.images])
        for x, y in zip(imgs, jimgs):
            np.testing.assert_allclose(x, y, atol=1e-6)
        if split == "train":
            rays, rgb = next(got.iter_batches(4))
            assert rgb.shape == (4, 3) and rays.origins.shape == (4, 3)


def test_read_colmap_intrinsics(tmp_path):
    p = str(tmp_path / "sparse" / "0" / "cameras.bin")
    _write_colmap_cameras(p, 123.0, 124.0, 32.0, 16.0)
    K = pd.read_colmap_intrinsics(os.path.dirname(p))
    np.testing.assert_array_equal(
        K, [[123.0, 0, 32.0], [0, 124.0, 16.0], [0, 0, 1]])
    np.testing.assert_array_equal(K, jax_pd.read_colmap_intrinsics(
        os.path.dirname(p)))
