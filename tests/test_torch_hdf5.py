"""The port's HDF5 reader (``modelimport/hdf5.py``) against h5py.

h5py is the oracle only: the reader never imports it. Every committed
Keras fixture, files h5py writes here under ``libver`` "earliest" and
"latest", and a full-width Keras-layout ResNet-50 ``.h5`` must read as
h5py reads them (groups, their order, attributes, dataset values, dtypes
and shapes, and ``visititems``' order), and what the reader does not
read must raise ``NotImplementedError`` naming the feature.
"""

import io
import json
import pathlib
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.modelimport import hdf5

h5py = pytest.importorskip("h5py")

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
LIBVERS = ("earliest", "latest")


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs in parallel workers: keep this module's torch CPU
    work to two threads, and restore the setting after it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _same_value(a, b, where):
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, (
            where, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    else:
        assert a == b or (a != a and b != b), (where, a, b)


def _same(ours, theirs, where="/"):
    """``ours`` (the port's group) reads as ``theirs`` (h5py's) does."""
    assert list(ours.keys()) == list(theirs.keys()), where
    assert list(ours.attrs.keys()) == list(theirs.attrs.keys()), where
    for k in theirs.attrs:
        _same_value(ours.attrs[k], theirs.attrs[k], f"{where}@{k}")
    seen_o, seen_t = [], []
    ours.visititems(lambda n, o: seen_o.append(
        (n, isinstance(o, hdf5.Dataset))))
    theirs.visititems(lambda n, o: seen_t.append(
        (n, isinstance(o, h5py.Dataset))))
    assert seen_o == seen_t, where
    for k in theirs:
        o, t = ours[k], theirs[k]
        if isinstance(t, h5py.Dataset):
            assert isinstance(o, hdf5.Dataset), (where, k)
            assert o.shape == t.shape and o.dtype == t.dtype, (where, k)
            _same_value(np.array(o), np.array(t), f"{where}{k}")
            _same_value(o[()], t[()], f"{where}{k}[()]")
            assert list(o.attrs.keys()) == list(t.attrs.keys())
            for a in t.attrs:
                _same_value(o.attrs[a], t.attrs[a], f"{where}{k}@{a}")
        else:
            assert isinstance(o, hdf5.Group), (where, k)
            _same(o, t, f"{where}{k}/")


def _keras_files():
    return sorted(p.name for p in FIXTURES.glob("keras_*.h5")) + \
        sorted(p.name for p in FIXTURES.glob("*.keras"))


@pytest.mark.parametrize("name", _keras_files())
def test_committed_keras_fixtures_read_as_h5py_reads_them(name):
    path = FIXTURES / name
    if path.suffix == ".keras":
        data = zipfile.ZipFile(path).read("model.weights.h5")
        ours, theirs = hdf5.File(data), h5py.File(io.BytesIO(data), "r")
    else:
        ours, theirs = hdf5.File(str(path)), h5py.File(str(path), "r")
    with ours, theirs:
        _same(ours, theirs)
        if path.suffix == ".h5":
            cfg = json.loads(ours.attrs["model_config"])
            assert cfg["class_name"] == "Sequential"


def test_file_objects_and_paths_read_alike():
    path = FIXTURES / "keras_smoke.h5"
    a = hdf5.File(str(path))
    with open(path, "rb") as f:
        b = hdf5.File(f)
    c = hdf5.File(path.read_bytes())
    for other in (b, c):
        assert other.keys() == a.keys()
        assert np.array_equal(np.array(other["model_weights/c1/sequential/"
                                             "c1/kernel"]),
                              np.array(a["/model_weights/c1/sequential/c1/"
                                         "kernel"]))
    assert "model_weights/c1" in a and "model_weights/nope" not in a
    with pytest.raises(KeyError):
        a["model_weights/nope"]
    with pytest.raises(ValueError, match="only reads"):
        hdf5.File(str(path), "w")
    with pytest.raises(ValueError, match="not an HDF5 file"):
        hdf5.File(b"not hdf5 at all" * 10)


# ---------------------------------------------------- files h5py writes

X = np.random.default_rng(0).standard_normal((37, 23)).astype("<f4")
FLOATS = ("<f2", ">f2", "<f4", ">f4", "<f8", ">f8")
INTS = ("i1", "u1", "<i2", ">u2", ">i4", "<u4", "<i8", ">u8")


def _numbers(dt):
    base = np.arange(24).reshape(2, 3, 4)
    return (base if np.dtype(dt).kind == "u" else base * 3 - 7).astype(dt)


def _write_btree(f):
    g = f.create_group("many")
    for i in range(200):
        g.create_dataset(f"d{i:03d}", data=np.arange(i % 5, dtype="<i4"))
        if i % 40 == 0:
            g.create_group(f"g{i:03d}").attrs["i"] = i


def _write_many_attrs(f):
    # more attribute bytes than the first header block holds: under
    # "earliest" 40 of them (continuation blocks), under "latest" 8 (the
    # compact limit), grown after a dataset so the header continues
    d = f.create_dataset("d", data=np.arange(3.0))
    n = 40 if f.libver[0] == "earliest" else 8
    for i in range(n):
        f.attrs[f"a{i:02d}"] = np.arange(20 * (i + 1), dtype="<f8")
    d.attrs["after"] = "x"


def _write_strings(f):
    f.attrs["scalar_v"] = "héllo"
    f.attrs["array_v"] = np.array(["a", "bc", "", "déf"],
                                  dtype=h5py.string_dtype())
    f.attrs["fixed"] = np.array([b"ab", b"cde"], dtype="S3")
    f.attrs["fixed_scalar"] = np.bytes_(b"xyz")
    f.attrs["num"] = np.float32(2.5)
    f.create_dataset("vds", data=np.array(["x", "yy", "ünï"],
                                          dtype=h5py.string_dtype()))
    f.create_dataset("fds", data=np.array([b"a", b"bb"], dtype="S4"))


def _write_floats(f):
    for dt in FLOATS:
        f.create_dataset(dt.replace("<", "le").replace(">", "be"),
                         data=_numbers(dt))


def _write_ints(f):
    for dt in INTS:
        f.create_dataset(dt.replace("<", "le").replace(">", "be"),
                         data=_numbers(dt))


def _write_compact(f):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    did = h5py.h5d.create(f.id, b"compact", h5py.h5t.IEEE_F32LE,
                          h5py.h5s.create_simple((3, 4)), dcpl=dcpl)
    did.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(X[:3, :4]))
    f.create_dataset("contiguous", data=X)
    f.create_dataset("scalar", data=np.float64(3.25))
    f.create_dataset("never", shape=(5, 6), dtype="<f8")
    f.create_dataset("never_fill", shape=(5,), dtype="<i4", fillvalue=7)


def _write_chunked(f):
    f.create_dataset("chunked", data=X, chunks=(8, 5))
    f.create_dataset("gzip", data=X, chunks=(8, 5), compression="gzip")
    f.create_dataset("gzip_shuffle", data=X, chunks=(10, 7),
                     compression="gzip", shuffle=True)
    f.create_dataset("shuffle_i2", data=np.arange(100, dtype="<i2").reshape(
        10, 10), chunks=(3, 4), shuffle=True)
    f.create_dataset("partial", shape=(20, 20), dtype="<f4", chunks=(8, 8),
                     fillvalue=-1.0)[0:8, 0:8] = 1.0
    f.create_dataset("never_chunked", shape=(9,), dtype="<f4", chunks=(4,))


#: (writer, what a "latest" file of it raises, or None): "latest" keeps
#: more than 8 links or attributes in a fractal heap, and indexes chunks
#: with layout version 4, which the reader refuses
CASES = {
    "btree_200_children": (_write_btree, "dense link storage"),
    "attributes_past_one_block": (_write_many_attrs, None),
    "strings": (_write_strings, None),
    "floats_both_orders": (_write_floats, None),
    "ints_8_to_64_bits": (_write_ints, None),
    "compact_contiguous_fill": (_write_compact, None),
    "chunked_gzip_shuffle": (_write_chunked, "layout version 4"),
}


@pytest.mark.parametrize("libver", LIBVERS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_h5py_written_files(case, libver, tmp_path):
    write, latest_raises = CASES[case]
    path = str(tmp_path / f"{case}.h5")
    with h5py.File(path, "w", libver=libver) as f:
        write(f)
    with hdf5.File(path) as ours, h5py.File(path, "r") as theirs:
        if libver == "latest" and latest_raises:
            with pytest.raises(NotImplementedError, match=latest_raises):
                _same(ours, theirs)
        else:
            _same(ours, theirs)


def test_btree_splits_into_inner_nodes(tmp_path):
    """200 links in a symbol table need a B-tree of more than one level
    (h5py's default leaf node K is 16): the reader walks inner nodes."""
    path = str(tmp_path / "t.h5")
    with h5py.File(path, "w", libver="earliest") as f:
        _write_btree(f)
    r = hdf5.File(path)
    msgs = r["many"]._msgs
    off = r._r.first(msgs, 0x11)[3]
    root = r._r.addr(off)
    assert r._r.b[root + 5] >= 1  # the root node's level
    assert len(r["many"]) == 205


def test_latest_header_continues_in_ochk_blocks(tmp_path):
    path = tmp_path / "t.h5"
    with h5py.File(str(path), "w", libver="latest") as f:
        _write_many_attrs(f)
    data = path.read_bytes()
    assert data.count(b"OCHK") >= 1 and data[8] in (2, 3)
    with hdf5.File(data) as ours, h5py.File(str(path), "r") as theirs:
        _same(ours, theirs)


@pytest.mark.parametrize("what,write,match", [
    ("dense link storage", lambda f: [f.create_group(f"g{i}")
                                      for i in range(9)],
     "dense link storage"),
    ("dense attribute storage", lambda f: [
        f.attrs.__setitem__(f"a{i}", i) for i in range(9)],
     "dense attribute storage"),
    ("an unknown filter", lambda f: f.create_dataset(
        "lzf", data=X, chunks=(8, 5), compression="lzf"), "lzf filter"),
    ("fletcher32", lambda f: f.create_dataset(
        "f32", data=X, chunks=(8, 5), fletcher32=True), "fletcher32"),
    ("a compound type", lambda f: f.create_dataset(
        "c", data=np.zeros(2, [("a", "<i4"), ("b", "<f4")])), "compound"),
    ("an enum (bool) type", lambda f: f.create_dataset(
        "b", data=np.array([True, False])), "enum"),
    ("soft links", lambda f: (f.create_group("t"), f.__setitem__(
        "s", h5py.SoftLink("/t"))), "soft links"),
], ids=lambda v: v if isinstance(v, str) and " " not in v else None)
def test_what_the_reader_refuses_raises(what, write, match, tmp_path):
    libver = "latest" if what.startswith("dense") else "earliest"
    path = str(tmp_path / "t.h5")
    with h5py.File(path, "w", libver=libver) as f:
        write(f)
    with pytest.raises(NotImplementedError, match=match):
        f = hdf5.File(path)
        for name in f.keys():
            obj = f[name]
            if isinstance(obj, hdf5.Dataset):
                np.array(obj)
        f.attrs.keys()


def test_lookup3_matches_the_superblock(tmp_path):
    """HDF5's checksum is Jenkins' lookup3: a "latest" superblock's
    stored checksum, and a flipped byte caught."""
    path = tmp_path / "t.h5"
    with h5py.File(str(path), "w", libver="latest") as f:
        f.create_dataset("d", data=np.arange(4))
    data = bytearray(path.read_bytes())
    assert hdf5.lookup3(b"") == 0xDEADBEEF
    end = 12 + 4 * data[9]
    assert hdf5.lookup3(bytes(data[:end])) == int.from_bytes(
        data[end:end + 4], "little")
    data[end - 1] ^= 0xFF
    with pytest.raises(ValueError, match="checksum"):
        hdf5.File(bytes(data))


# ------------------------------------------ a full-width Keras ResNet-50

def write_keras_h5(path, cfg, weights):
    """A Keras legacy ``.h5`` of ``cfg`` with ``weights`` ({layer:
    [arrays]}) as the Keras 3 legacy writer lays it out: the config and
    versions as attributes, ``model_weights/<layer>/<layer>/<var>`` with
    ``layer_names`` and ``weight_names`` string attributes."""
    names = {"Conv2D": ("kernel", "bias"), "Dense": ("kernel", "bias"),
             "BatchNormalization": ("gamma", "beta", "moving_mean",
                                    "moving_variance")}
    layers = [l for l in cfg["config"]["layers"]]
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(cfg)
        f.attrs["keras_version"] = "3.13.1"
        f.attrs["backend"] = "tensorflow"
        mw = f.create_group("model_weights")
        mw.attrs["layer_names"] = np.array(
            [l["config"]["name"] for l in layers], dtype=h5py.string_dtype())
        for l in layers:
            name = l["config"]["name"]
            g = mw.create_group(name)
            ws = weights.get(name, [])
            wn = [f"{name}/{v}" for v in names.get(l["class_name"], ())]
            g.attrs["weight_names"] = np.array(wn[:len(ws)],
                                               dtype=h5py.string_dtype())
            for n, a in zip(wn, ws):
                g.create_dataset(n, data=a)


def test_full_width_keras_resnet50_h5(tmp_path):
    """About 100 MB written by h5py from the seeded Keras-layout weights:
    read back array for array, and imported by the port with the same
    parameters as the import of the same weights given as a dict."""
    from deeplearning4j_tpu_torch.modelimport import KerasModelImport
    from deeplearning4j_tpu_torch.tools import make_keras_config as mk
    cfg = mk.config()
    weights = mk.seeded_weights(cfg, seed=0)
    path = str(tmp_path / "resnet50.h5")
    write_keras_h5(path, cfg, weights)
    n = 0
    with hdf5.File(path) as ours, h5py.File(path, "r") as theirs:
        assert ours.attrs["model_config"] == theirs.attrs["model_config"]
        _same_value(ours["model_weights"].attrs["layer_names"],
                    theirs["model_weights"].attrs["layer_names"], "names")
        for layer, arrays in weights.items():
            g = ours["model_weights"][layer]
            wn = list(g.attrs["weight_names"])
            assert wn == list(theirs["model_weights"][layer].attrs[
                "weight_names"])
            for wname, a in zip(wn, arrays):
                got = np.array(g[wname])
                assert got.dtype == a.dtype and np.array_equal(got, a)
                n += a.size
    moving = sum(a.size for k, ws in weights.items() if k.endswith("_bn")
                 for a in ws[2:])
    assert n - moving == 25_583_592  # Keras' trainable parameter count
    net = KerasModelImport.import_keras_model_and_weights(path, device="cpu")
    ref = mk.import_resnet50(device="cpu")
    assert net.params.keys() == ref.params.keys()
    for v in ref.params:
        for k, t in ref.params[v].items():
            assert torch.equal(net.params[v][k], t), (v, k)
    for v in ref.state:
        for k, t in ref.state[v].items():
            assert torch.equal(net.state[v][k], t), (v, k)
