"""The port's native EXR decoder (csrc/exr_decode.cc, built with g++ at
first use) against its pure-Python codec, on the CPU.

Files written by the port's `write_exr` (half and float, ZIP and no
compression, odd widths, one and three channels) decode bitwise equal
through both; the decoder that read each file is recorded
(`read_exr.decoder`); a file the native decoder declines falls back to
the pure-Python codec, and garbage is refused by both.
"""

import numpy as np
import pytest

from pano_nerf_tpu_torch.data import io_exr


@pytest.fixture(scope="module")
def native():
    io_exr._native_library()
    assert io_exr.native_error() == "", io_exr.native_error()


@pytest.mark.parametrize("width", [1, 7, 33])
@pytest.mark.parametrize("compression", ["zip", "none"])
@pytest.mark.parametrize("pixel_type", ["half", "float"])
def test_native_matches_python_bitwise(tmp_path, native, pixel_type,
                                       compression, width):
    rng = np.random.default_rng(width)
    data = (rng.normal(size=(21, width, 3)) * 50).astype(np.float32)
    data[0, 0] = [0.0, -0.0, 65504.0]
    path = str(tmp_path / "x.exr")
    io_exr.write_exr(path, data, pixel_type=pixel_type,
                     compression=compression)
    got = io_exr.read_exr(path)
    assert io_exr.read_exr.decoder == "native"
    want = io_exr.read_exr(path, native=False)
    assert io_exr.read_exr.decoder == "python"
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    cast = data.astype(np.float16 if pixel_type == "half" else np.float32)
    assert np.array_equal(got, cast.astype(np.float32))


def test_single_channel_and_channel_order(tmp_path, native):
    data = np.arange(5 * 9, dtype=np.float32).reshape(5, 9, 1)
    path = str(tmp_path / "y.exr")
    io_exr.write_exr(path, data, channels=("Y",), pixel_type="float")
    got = io_exr.read_exr(path)
    assert io_exr.read_exr.decoder == "native"
    assert got.tobytes() == io_exr.read_exr(path, native=False).tobytes()
    assert got.shape == (5, 9, 3)
    path = str(tmp_path / "bgr.exr")
    io_exr.write_exr(path, np.dstack([data] * 3) * [1, 2, 3],
                     channels=("B", "G", "R"), pixel_type="float")
    for native_first in (True, False):
        got = io_exr.read_exr(path, channels=("R", "G", "B"),
                              native=native_first)
        np.testing.assert_array_equal(got[..., 0], data[..., 0] * 3)


def test_declined_file_falls_back_and_garbage_raises(tmp_path, native,
                                                     monkeypatch):
    path = str(tmp_path / "z.exr")
    data = np.ones((4, 4, 3), np.float32)
    io_exr.write_exr(path, data)
    monkeypatch.setattr(io_exr, "_native_planes", lambda buf: None)
    assert np.array_equal(io_exr.read_exr(path), data)
    assert io_exr.read_exr.decoder == "python"
    monkeypatch.undo()
    bad = str(tmp_path / "bad.exr")
    with open(bad, "wb") as f:
        f.write(b"\x00" * 64)
    with pytest.raises(ValueError, match="not an EXR"):
        io_exr.read_exr(bad)
