"""The port's packed-shard loader (fedmlp_tpu_torch/data/native_loader.py):
its build of native/packloader.cpp beside the package, never into native/;
its gathers against the numpy gather and numpy indexing; its bounds and
build errors; reused buffers on the CPU."""

import pathlib

import numpy as np
import pytest
import torch

from fedmlp_tpu_torch.data import native_loader as NL
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

_NATIVE = pathlib.Path(__file__).resolve().parents[1] / "native"


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    rng = np.random.RandomState(0)
    arr = rng.randint(0, 256, (64, 16, 16, 3), dtype=np.uint8)
    path = str(tmp_path_factory.mktemp("pack") / "images.npy")
    np.save(path, arr)
    return path, arr


def _native_state():
    # libpackloader.so is the JAX package's own build (make -C native),
    # which its tests may write at any time; the port never writes there
    return {p.name: p.stat().st_mtime_ns for p in _NATIVE.iterdir()
            if p.name != "libpackloader.so"}


def test_library_builds_beside_the_package_and_not_in_native(packed):
    before = _native_state()
    with NL.PackLoader(packed[0]) as ld:
        assert ld.native and ld.shape == (64, 16, 16, 3) and ld.row_shape == (16, 16, 3)
    lib = NL.library_path()
    assert lib.exists() and lib.parent == NL.PKG_DIR / "_build"
    assert _native_state() == before
    assert not any(p.name.startswith("libpackloader-") for p in _NATIVE.iterdir())


@pytest.mark.parametrize("reuse", [False, True])
def test_gather_and_prefetch_equal_the_plain_gather(packed, reuse):
    path, arr = packed
    mm = np.load(path, mmap_mode="r")
    idx = np.array([[3, 1, 63], [0, 0, 17]], np.int64)
    with NL.PackLoader(path, reuse_buffers=reuse) as ld:
        got = ld.gather(idx)
        np.testing.assert_array_equal(got, NL.gather_plain(mm, idx))
        np.testing.assert_array_equal(got, arr[idx])
        for rows in (np.array([5, 7, 9]), np.arange(64)[::-1], np.array([[2], [4]])):
            ld.submit(rows)
            np.testing.assert_array_equal(ld.wait(), arr[rows])
        with pytest.raises(RuntimeError, match="wait"):
            ld.wait()


def test_out_of_range_and_misuse_raise(packed):
    with NL.PackLoader(packed[0]) as ld:
        with pytest.raises(IndexError):
            ld.gather(np.array([64]))
        with pytest.raises(IndexError):
            ld.gather(np.array([-1]))
        with pytest.raises(IndexError):
            ld.submit(np.array([0, 64]))
        ld.submit(np.array([1]))
        with pytest.raises(RuntimeError, match="in flight"):
            ld.submit(np.array([2]))
        ld.wait()
    with pytest.raises(RuntimeError, match="closed"):
        ld.gather(np.array([0]))


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No silent fallback: a missing compiler, or one that fails, raises
    with the compiler's output, and leaves no library behind."""
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="packloader build failed"):
        NL.build_library(tmp_path / "build")
    failing = tmp_path / "cxx"
    failing.write_text('#!/bin/sh\necho "cxx: error: bad input" >&2\nexit 1\n')
    failing.chmod(0o755)
    monkeypatch.setenv("CXX", str(failing))
    with pytest.raises(RuntimeError, match="cxx: error: bad input"):
        NL.build_library(tmp_path / "build")
    assert not list((tmp_path / "build").iterdir())


def test_reused_buffers_never_alias_a_returned_cpu_tensor(packed):
    path, arr = packed
    with NL.PackLoader(path, reuse_buffers=True) as ld:
        first = ld.to_device(ld.gather(np.arange(8)), "cpu")
        buf = ld.gather(np.arange(8, 16))
        second = ld.to_device(buf, "cpu")
        assert first.data_ptr() != second.data_ptr() != buf.ctypes.data
        ld.submit(np.arange(16, 24))
        third = ld.to_device(ld.wait(), "cpu")
        ld.submit(np.arange(24, 32))
        ld.wait()
        torch.testing.assert_close(first, torch.from_numpy(arr[:8]), rtol=0, atol=0)
        torch.testing.assert_close(second, torch.from_numpy(arr[8:16]), rtol=0, atol=0)
        torch.testing.assert_close(third, torch.from_numpy(arr[16:24]), rtol=0, atol=0)
    # without reuse every call returns a fresh array, which a tensor wraps
    with NL.PackLoader(path) as ld:
        rows = ld.gather(np.arange(4))
        assert ld.to_device(rows, "cpu").data_ptr() == rows.ctypes.data
        assert ld.gather(np.arange(4)).ctypes.data != rows.ctypes.data
