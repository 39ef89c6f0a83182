"""Native host runtime (libgamma_host.so): storage, bitmap, key map."""

import os
import threading

import numpy as np
import pytest

from gamma_tpu import native


pytestmark = pytest.mark.skipif(
    not (native.available() or native.build()),
    reason="libgamma_host.so unavailable and g++ build failed")


def test_storage_roundtrip(tmp_path):
    st = native.NativeStorage(str(tmp_path), "t", item_size=16,
                              segment_items=100)
    rows = np.arange(250 * 4, dtype=np.int32).reshape(250, 4)
    first = st.add(rows)          # spans 3 segments
    assert first == 0 and len(st) == 250
    got = st.get_range(0, 250, np.int32).reshape(250, 4)
    np.testing.assert_array_equal(got, rows)
    st.update(7, np.full(4, -1, np.int32))
    assert (st.get_range(7, 1, np.int32) == -1).all()
    h = st.add_str(b"hello world")
    assert st.get_str(h) == b"hello world"
    st.sync()
    st.close()
    # reopen: persisted
    st2 = native.NativeStorage(str(tmp_path), "t", item_size=16,
                               segment_items=100)
    assert len(st2) == 250
    got = st2.get_range(100, 50, np.int32).reshape(50, 4)
    np.testing.assert_array_equal(got, rows[100:150])
    assert st2.get_str(h) == b"hello world"
    st2.truncate(120)
    assert len(st2) == 120
    st2.close()


def test_storage_concurrent_read_during_write(tmp_path):
    st = native.NativeStorage(str(tmp_path), "c", item_size=8,
                              segment_items=1000)
    stop = threading.Event()
    errors = []

    def reader():
        while not stop.is_set():
            n = len(st)
            if n:
                got = st.get_range(0, n, np.int64)
                # published rows must equal their index (no torn reads of
                # the publish counter)
                if not (got == np.arange(n)).all():
                    errors.append(got)
                    return

    t = threading.Thread(target=reader)
    t.start()
    for i in range(0, 5000, 50):
        st.add(np.arange(i, i + 50, dtype=np.int64))
    stop.set()
    t.join()
    assert not errors
    assert len(st) == 5000
    st.close()


def test_bitmap(tmp_path):
    p = os.path.join(str(tmp_path), "bm.dat")
    bm = native.NativeBitmap(p, nbits=10_000)
    for b in (0, 63, 64, 9999):
        bm.set(b)
    assert bm.test(64) and not bm.test(65)
    assert bm.count() == 4
    bm.unset(64)
    assert not bm.test(64)
    arr = bm.as_bool_array(10_000)
    assert arr[0] and arr[63] and arr[9999] and arr.sum() == 3
    bm.sync()
    bm.close()
    bm2 = native.NativeBitmap(p, nbits=10_000)
    assert bm2.test(9999) and bm2.count() == 3
    bm2.close()


def test_keymap(tmp_path):
    km = native.NativeKeyMap()
    assert km.put("a", 1) == -1
    assert km.put("a", 2) == 1          # returns old
    assert km.get("a") == 2
    assert km.get("missing") == -1
    for i in range(1000):
        km.put(f"k{i}", i)
    assert len(km) == 1001
    assert km.delete("k500") == 500
    assert km.delete("k500") == -1
    p = os.path.join(str(tmp_path), "km.bin")
    km.dump(p)
    km2 = native.NativeKeyMap()
    km2.load(p)
    assert len(km2) == 1000
    assert km2.get("k7") == 7 and km2.get("k500") == -1
    km.close()
    km2.close()


def test_builds_without_zstd_header(tmp_path, monkeypatch):
    """A machine with the zstd runtime but no development header still
    builds the library: gamma_host.cc declares the zstd calls itself."""
    import subprocess
    src = os.path.join(native._REPO, "native", "gamma_host.cc")
    with open(src) as f:
        code = f.read()
    assert "__has_include(<zstd.h>)" in code
    no_hdr = tmp_path / "gamma_host_no_zstd_h.cc"
    no_hdr.write_text(code.replace("__has_include(<zstd.h>)", "0"))
    so = tmp_path / "libgamma_host.so"
    subprocess.run(["g++", "-O0", "-std=c++17", "-fPIC", "-shared",
                    "-pthread", "-fvisibility=hidden", "-Wl,--no-undefined",
                    "-o", str(so), str(no_hdr), "-l:libzstd.so.1"],
                   check=True, capture_output=True)
    monkeypatch.setattr(native, "_SO", str(so))
    monkeypatch.setattr(native, "_LIB", None)
    assert native.available()
    # sealing a block compresses it; reading it back decompresses it
    rows = np.arange(64 * 8, dtype=np.int32).reshape(64, 8)
    z = native.ZBlockStorage(str(tmp_path / "z"), "v", row_bytes=32,
                             rows_per_block=16)
    z.add(rows)
    assert 0 < z.comp_bytes() < rows.nbytes
    np.testing.assert_array_equal(
        z.get_range(0, 64, np.int32).reshape(64, 8), rows)
    z.close()
