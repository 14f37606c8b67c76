"""The port's native frame writer (``utils/native_io.py``: its own ctypes
bindings to native/tpurt_io.cc, built into build/native/<hash>/), ported
from tests/test_native_io.py: PNG encoder exactness (decoded images equal
the input bit for bit), the async writer, the zlib level and the raw
``.rgb`` mode; and the flythrough CLI writing through it, or through the
Python encoder when the library is unavailable. Skips only when g++ or
zlib is missing."""

import os
import shutil
import struct
import time
import zlib

import numpy as np
import pytest

from gpgpuraytrace_tpu_torch import cli
from gpgpuraytrace_tpu_torch.utils import native_io
from gpgpuraytrace_tpu_torch.utils.image import encode_png, write_png


def _decode_png(data: bytes) -> np.ndarray:
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    off, idat, shape = 8, b"", None
    while off < len(data):
        (ln,) = struct.unpack(">I", data[off : off + 4])
        tag = data[off + 4 : off + 8]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", data[off + 8 : off + 16])
            shape = (h, w)
        elif tag == b"IDAT":
            idat += data[off + 8 : off + 8 + ln]
        off += 12 + ln
    raw = zlib.decompress(idat)
    rows = np.frombuffer(raw, np.uint8).reshape(shape[0], shape[1] * 3 + 1)
    assert (rows[:, 0] == 0).all(), "only filter 0 supported"
    return rows[:, 1:].reshape(shape[0], shape[1], 3)


def _read(path) -> np.ndarray:
    with open(path, "rb") as fh:
        return _decode_png(fh.read())


@pytest.fixture(scope="module")
def img():
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def native():
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    if not native_io.available():
        pytest.skip("native library not buildable here (zlib missing?)")
    return native_io


def test_python_png_roundtrip(img):
    np.testing.assert_array_equal(_decode_png(encode_png(img)), img)


def test_native_png_roundtrip(native, img, tmp_path):
    path = os.path.join(tmp_path, "native.png")
    assert native.write_png_native(path, img)
    np.testing.assert_array_equal(_read(path), img)
    # Built from native/tpurt_io.cc into build/native/<hash>/, at the ABI
    # the bindings expect.
    lib = native.build_dir() / native.LIB_NAME
    assert lib.is_file() and lib.parent.parent == native.BUILD_ROOT
    assert native._load().tpurt_abi_version() == native.ABI_VERSION


def test_build_dir_covers_the_host_cpu(monkeypatch):
    """The library is built with ``-march=native``: a host whose CPU g++
    targets differently gets a build of its own, never another's."""
    dirs = set()
    for target in (b"-march= cooperlake", b"-march= sapphirerapids"):
        monkeypatch.setattr(native_io, "_native_target", lambda t=target: t)
        dirs.add(native_io.build_dir())
        assert native_io.build_dir().parent == native_io.BUILD_ROOT
    assert len(dirs) == 2


def test_async_writer(native, img, tmp_path):
    paths = [os.path.join(tmp_path, f"f_{i:03d}.png") for i in range(12)]
    with native.AsyncFrameWriter(num_threads=3) as w:
        for p in paths:
            w.push(p, img)
    assert w.close() == 0  # closed already: nothing left
    for p in paths:
        np.testing.assert_array_equal(_read(p), img)


def test_write_png_prefers_native_and_falls_back(native, img, tmp_path, monkeypatch):
    """The flythrough CLI's choice: the native writer where it builds, the
    Python encoder otherwise; both decode to the image."""
    a, b = (os.path.join(tmp_path, f"{k}.png") for k in ("native", "python"))
    assert native.write_png_native(a, img)
    write_png(b, img)
    np.testing.assert_array_equal(_read(a), _read(b))
    monkeypatch.setattr(native_io, "_load", lambda: None)
    assert not native_io.available() and not native_io.write_png_native(a, img)
    with pytest.raises(RuntimeError, match="unavailable"):
        native_io.AsyncFrameWriter()


def test_encode_level_and_raw_mode(native, img, tmp_path):
    """The zlib effort knob and the encoder-free .rgb stream mode, exact
    through both the native and the Python writer."""
    for level in (1, 6, 9):
        for kind, writer in (("native", native.write_png_native), ("python", write_png)):
            path = os.path.join(tmp_path, f"{kind}{level}.png")
            assert writer(path, img, level=level) in (True, None)
            np.testing.assert_array_equal(_read(path), img)
    for kind, writer in (("native", native.write_png_native), ("python", write_png)):
        raw_path = os.path.join(tmp_path, f"{kind}.rgb")
        writer(raw_path, img)
        back = np.fromfile(raw_path, np.uint8).reshape(img.shape)
        np.testing.assert_array_equal(back, img)
        assert os.path.getsize(raw_path) == img.size


def test_async_writer_level_and_rgb(native, img, tmp_path):
    png = os.path.join(tmp_path, "a.png")
    rgb = os.path.join(tmp_path, "a.rgb")
    with native.AsyncFrameWriter(num_threads=2, level=1) as w:
        w.push(png, img)
        w.push(rgb, img)
        deadline = time.monotonic() + 60
        while w.written() < 2 and time.monotonic() < deadline:
            time.sleep(0.01)  # the workers write while the caller goes on
        assert w.written() == 2
    np.testing.assert_array_equal(_read(png), img)
    np.testing.assert_array_equal(np.fromfile(rgb, np.uint8).reshape(img.shape), img)


@pytest.mark.parametrize("have_native", [True, False], ids=["native", "python"])
def test_cli_fly_writes_through_the_native_writer(native, tmp_path, capsys, monkeypatch,
                                                  have_native):
    """``fly`` pushes its frames to the native writer (``native=True`` in its
    summary) or, without the library, writes them with the Python encoder;
    the frames are the same either way."""
    if not have_native:
        monkeypatch.setattr(native_io, "_load", lambda: None)
    out = os.path.join(tmp_path, "frames")
    cli.main(["fly", "--device", "cpu", "--size", "32x16", "--octaves", "2",
              "--max-steps", "32", "--frames", "3", "--batch", "2", "-o", out])
    assert f"native={have_native}" in capsys.readouterr().out
    frames = [_read(os.path.join(out, f"frame_{i:04d}.png")) for i in range(3)]
    assert all(f.shape == (16, 32, 3) for f in frames)
    assert not np.array_equal(frames[0], frames[2])  # the camera moves
