"""The port's HDF5 reader and writer (`data/hdf5.py`) against h5py.

Every case writes a file with h5py in one of the layouts h5py produces by
default or with its common options, and holds the port's reader to h5py's
arrays exactly (same dtype, byte order included, same values): the whole
dataset and basic slices on the first and last axes. The structures the
reader does not cover raise NotImplementedError naming them, and a file
from `write_h5` reads back through h5py as the array it was given.
"""

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from neural_radiance_caching_tpu_torch.data import hdf5  # noqa: E402

ALL_DTYPES = ["<i1", "<u1", "<i2", ">i2", "<u2", ">u2", "<i4", ">i4", "<u4", ">u4", "<i8",
              ">i8", "<u8", ">u8", "<f2", ">f2", "<f4", ">f4", "<f8", ">f8"]

SLICES = [(), (slice(None),), (slice(1, 7, 2),), (Ellipsis, slice(2, None, 3)),
          (Ellipsis, slice(-3, None)), (3,), (-1, Ellipsis, 0), (slice(None, None, 4), 1),
          (slice(5, 5),), (Ellipsis,)]


def _data(shape, dtype, seed=0):
    rng = np.random.RandomState(seed)
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return (rng.standard_normal(shape) * 100).astype(dtype)
    info = np.iinfo(dtype)
    return rng.randint(info.min, int(info.max) + 1, size=shape, dtype=np.int64 if
                       info.min < 0 else np.uint64).astype(dtype)


def _same(path, name):
    """The port's reads of `name` against h5py's, for every SLICES key."""
    with h5py.File(path, "r") as ref, hdf5.File(path) as got:
        r, g = ref[name], got[name]
        assert g.shape == r.shape and g.dtype == r.dtype
        for key in SLICES:
            if sum(k is not Ellipsis for k in key) > r.ndim:
                continue
            want, have = r[key], g[key]
            assert have.dtype == want.dtype, key
            np.testing.assert_array_equal(have, want, err_msg=str(key))
        np.testing.assert_array_equal(np.array(g), r[()])


def _write(path, name="data", shape=(11, 9, 7), dtype="<f4", libver=None, userblock=None,
           **kw):
    data = _data(shape, dtype)
    opts = {} if libver is None else {"libver": libver}
    if userblock:
        opts["userblock_size"] = userblock
    with h5py.File(path, "w", **opts) as f:
        f.create_dataset(name, data=data, **kw)
    return data


LAYOUTS = {
    "contiguous": {},
    "chunked": {"chunks": (4, 3, 7)},
    "edge_chunks": {"chunks": (3, 4, 5)},
    "gzip1": {"chunks": (4, 3, 2), "compression": "gzip", "compression_opts": 1},
    "gzip9": {"chunks": (5, 5, 5), "compression": "gzip", "compression_opts": 9},
    "gzip_shuffle": {"chunks": (4, 3, 7), "compression": "gzip", "shuffle": True},
    "fletcher32": {"chunks": (4, 4, 4), "fletcher32": True},
    "shuffle_gzip_fletcher32": {"chunks": (2, 9, 3), "compression": "gzip", "shuffle": True,
                                "fletcher32": True},
    "many_chunks_two_btree_levels": {"chunks": (1, 1, 7)},
    "resizable_v0": {"chunks": (4, 3, 7), "maxshape": (None, 9, 7)},
    "latest_contiguous": {"libver": "latest"},
    "latest_single_chunk": {"libver": "latest", "chunks": (11, 9, 7)},
    "latest_single_chunk_gzip": {"libver": "latest", "chunks": (11, 9, 7), "compression": "gzip"},
    "latest_fixed_array": {"libver": "latest", "chunks": (4, 3, 5)},
    "latest_fixed_array_paged": {"libver": "latest", "chunks": (1, 1, 7)},
    "latest_fixed_array_filtered": {"libver": "latest", "chunks": (4, 4, 4),
                                    "compression": "gzip", "shuffle": True, "fletcher32": True},
    "userblock": {"userblock": 512},
    "userblock_latest_chunked": {"userblock": 1024, "libver": "latest", "chunks": (3, 3, 3),
                                 "compression": "gzip"},
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_reader_matches_h5py_on_each_layout(layout, tmp_path):
    path = str(tmp_path / "f.h5")
    _write(path, **LAYOUTS[layout])
    _same(path, "data")


@pytest.mark.parametrize("dtype", ALL_DTYPES)
@pytest.mark.parametrize("layout", ["contiguous", "gzip_shuffle"])
def test_reader_matches_h5py_on_each_dtype(dtype, layout, tmp_path):
    path = str(tmp_path / "f.h5")
    _write(path, dtype=dtype, **LAYOUTS[layout])
    _same(path, "data")


def test_compact_layout(tmp_path):
    path = str(tmp_path / "f.h5")
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=_data((5, 6), ">i4"), dcpl=dcpl)
    with h5py.File(path, "r") as f:
        assert f["data"].id.get_create_plist().get_layout() == h5py.h5d.COMPACT
    _same(path, "data")


@pytest.mark.parametrize("libver", [None, "latest"])
def test_partly_written_chunks_read_the_fill_value(libver, tmp_path):
    path = str(tmp_path / "f.h5")
    opts = {} if libver is None else {"libver": libver}
    with h5py.File(path, "w", **opts) as f:
        d = f.create_dataset("data", (10, 12, 3), "f4", chunks=(4, 5, 3), fillvalue=7.5,
                             compression="gzip")
        d[1:3, 2:9] = _data((2, 7, 3), "f4")
        d[9, 11] = 1.0
        f.create_dataset("zeros", (4, 5), "<i2", chunks=(2, 2))
        f.create_dataset("unwritten", (6,), ">i4", fillvalue=-3)
        f.create_dataset("empty", (0, 4), "f8")
    for name in ("data", "zeros", "unwritten"):
        _same(path, name)
    with hdf5.File(path) as f:
        assert f["data"].fillvalue == 7.5 and f["empty"][()].shape == (0, 4)


def test_groups_by_symbol_table_and_by_links(tmp_path):
    """Nested groups and 40 names in one symbol table (several SNOD nodes
    under one B-tree node); under `latest`, compact links."""
    for libver in (None, "latest"):
        path = str(tmp_path / f"{libver}.h5")
        opts = {} if libver is None else {"libver": libver}
        with h5py.File(path, "w", **opts) as f:
            g = f.create_group("train_efficient/inner")
            g["x"] = np.arange(5)
            if libver is None:
                for i in range(40):
                    f[f"d{i:02d}"] = np.full((2,), i, np.int32)
        with hdf5.File(path) as got, h5py.File(path, "r") as ref:
            assert got.keys() == sorted(ref.keys())
            np.testing.assert_array_equal(got["train_efficient/inner/x"][()],
                                          ref["train_efficient/inner/x"][()])
            assert "train_efficient/inner" in got and "nope" not in got
            if libver is None:
                for i in range(40):
                    np.testing.assert_array_equal(got[f"d{i:02d}"][()], [i, i])


@pytest.mark.parametrize("libver", [None, "latest"])
def test_header_continuations(libver, tmp_path):
    """Attributes added after the dataset grow its header into continuation
    blocks (v1) or OCHK chunks (v2); the layout message may sit in either."""
    path = str(tmp_path / "f.h5")
    opts = {} if libver is None else {"libver": libver}
    with h5py.File(path, "w", **opts) as f:
        d = f.create_dataset("data", data=_data((6, 4), "<f8"), chunks=(3, 2),
                             compression="gzip")
        for i in range(6):
            d.attrs[f"a{i}"] = np.arange(40) + i
        f.create_dataset("after", data=np.arange(7, dtype="<u2"))
    _same(path, "data")
    _same(path, "after")


def test_fletcher32_detects_a_flipped_byte(tmp_path):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=np.arange(64, dtype="<i4").reshape(8, 8), chunks=(8, 8),
                         fletcher32=True)
        offset = f["data"].id.get_chunk_info(0).byte_offset
    with open(path, "r+b") as fh:
        fh.seek(offset + 5)
        byte = fh.read(1)
        fh.seek(offset + 5)
        fh.write(bytes([byte[0] ^ 0x10]))
    with hdf5.File(path) as f, pytest.raises(ValueError, match="fletcher32"):
        f["data"][()]


def test_fletcher32_matches_the_library_on_odd_and_empty_lengths():
    def reference(data):  # the library's loop, word by word
        s1 = s2 = 0
        words = [data[i] << 8 | data[i + 1] for i in range(0, len(data) - 1, 2)]
        for start in range(0, len(words), 360):
            for w in words[start:start + 360]:
                s1 += w
                s2 += s1
            s1 = (s1 & 0xFFFF) + (s1 >> 16)
            s2 = (s2 & 0xFFFF) + (s2 >> 16)
        if len(data) % 2:
            s1 += data[-1] << 8
            s2 += s1
            s1 = (s1 & 0xFFFF) + (s1 >> 16)
            s2 = (s2 & 0xFFFF) + (s2 >> 16)
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
        return s2 << 16 | s1

    rng = np.random.RandomState(3)
    for n in (0, 1, 2, 7, 720, 721, 5000):
        for data in (rng.randint(0, 256, n).astype(np.uint8).tobytes(), b"\xff" * n):
            assert hdf5.fletcher32(data) == reference(data), n


REFUSALS = {
    "lzf": ({"chunks": (4, 3, 7), "compression": "lzf"}, r"filter 32000 \(lzf\)"),
    "extensible_array": ({"libver": "latest", "chunks": (4, 3, 7), "maxshape": (None, 9, 7)},
                         "extensible-array chunk index"),
    "v2_btree": ({"libver": "latest", "chunks": (4, 3, 7), "maxshape": (None, None, 7)},
                 "v2-B-tree chunk index"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_name_the_structure(case, tmp_path):
    kw, match = REFUSALS[case]
    path = str(tmp_path / "f.h5")
    _write(path, **kw)
    with hdf5.File(path) as f, pytest.raises(NotImplementedError, match=match):
        f["data"][()]


def test_dense_groups_are_refused(tmp_path):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w", libver="latest") as f:
        for i in range(12):
            f[f"d{i}"] = np.arange(3)
    with pytest.raises(NotImplementedError, match="dense link storage"):
        hdf5.File(path)


def test_bad_selections_raise_as_h5py_does(tmp_path):
    path = str(tmp_path / "f.h5")
    _write(path)
    with hdf5.File(path) as f:
        with pytest.raises(ValueError, match="Step must be >= 1"):
            f["data"][::-1]
        with pytest.raises(IndexError):
            f["data"][11]
        with pytest.raises(TypeError):
            f["data"][[0, 1]]


@pytest.mark.parametrize("dtype", ALL_DTYPES)
def test_write_h5_reads_back_through_h5py(dtype, tmp_path):
    path = str(tmp_path / "w.h5")
    data = _data((3, 5, 2), dtype, seed=1)
    hdf5.write_h5(path, "data", data)
    with h5py.File(path, "r") as f:
        assert list(f.keys()) == ["data"] and f["data"].dtype == data.dtype
        np.testing.assert_array_equal(f["data"][()], data)
    with hdf5.File(path) as f:
        np.testing.assert_array_equal(f["data"][1:, ..., -1], data[1:, ..., -1])


def test_write_h5_streams_a_memory_map_under_any_name(tmp_path):
    src = np.lib.format.open_memmap(str(tmp_path / "src.npy"), "w+", np.float32, (64, 700, 3))
    src[:] = _data((64, 700, 3), "f4", seed=2)
    path = str(tmp_path / "samples.h5")
    hdf5.write_h5(path, "dataset", src)
    with h5py.File(path, "r") as f:
        np.testing.assert_array_equal(f["dataset"][8:40, 100:300], src[8:40, 100:300])
