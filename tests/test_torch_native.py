"""The port's native clip.json parser and writer
(``debiasing_multi_modal_tpu_torch/native/ebdjson.py``, built from the
repository's ``native/ebdjson.cpp`` into the port's build directory) held
against the port's Python parser and the JAX package's parsers: the same
tables (embeddings within ``rtol=1e-6``, the JSON float round trip; every
other column equal), the same unicode, missing-field and quote cases as
``tests/test_native.py``, the store's dispatch and its error, and the JAX
binding's library left alone."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from debiasing_multi_modal_tpu.data import embeddings_store as jstore
from debiasing_multi_modal_tpu.native import ebdjson as jebdjson
from debiasing_multi_modal_tpu_torch.data import embeddings_store as store
from debiasing_multi_modal_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_dataset
from debiasing_multi_modal_tpu_torch.native import ebdjson

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLUMNS = ("filenames", "y", "place", "group", "split", "y_pred")


def _same(a, b):
    for col in COLUMNS:
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col))
    np.testing.assert_allclose(a.embeddings, b.embeddings, rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    _, table, *_ = make_synthetic_dataset(SyntheticSpec(n_train=256, n_val=64, n_test=64))
    path = str(tmp_path_factory.mktemp("native") / "clip.json")
    store.save_embeddings(path, table, fmt="json", dataset="waterbirds")
    return path, table


@pytest.mark.parametrize("dataset", ["waterbirds", "celeba"])
def test_native_parser_matches_python_and_jax(tmp_path, dataset):
    _, table, *_ = make_synthetic_dataset(SyntheticSpec(n_train=64, n_val=16, n_test=16))
    path = str(tmp_path / "clip.json")
    ebdjson.save_embeddings_json(path, table, dataset)
    native = ebdjson.load_embeddings_json(path, dataset)
    _same(native, table)
    _same(native, store._load_json_python(path, dataset))
    _same(native, jstore._load_json_python(path, dataset))
    _same(native, jebdjson.load_embeddings_json(path, dataset))
    # the writer's bytes are the JAX binding's
    jpath = str(tmp_path / "jax.json")
    jebdjson.save_embeddings_json(jpath, table, dataset)
    assert open(path, "rb").read() == open(jpath, "rb").read()


def test_store_dispatches_to_the_native_parser(cache):
    path, table = cache
    native, python = ebdjson.load_embeddings_json.calls, store._load_json_python.calls
    loaded = store.load_embeddings(path, dataset="waterbirds")
    assert ebdjson.load_embeddings_json.calls == native + 1
    assert store._load_json_python.calls == python
    _same(loaded, table)
    saved, py_saved = ebdjson.save_embeddings_json.calls, store._save_json_python.calls
    store.save_embeddings(path + ".copy.json", table, fmt="json")
    assert (ebdjson.save_embeddings_json.calls, store._save_json_python.calls) == (
        saved + 1, py_saved)


def test_store_falls_back_to_python_without_the_library(cache, monkeypatch):
    """No toolchain or no source: the store takes its Python parser and
    writer, as the JAX store does on such a host."""
    path, table = cache

    def missing():
        raise FileNotFoundError("native/ebdjson.cpp")

    monkeypatch.setattr(ebdjson, "_lib", None)
    monkeypatch.setattr(ebdjson, "build", missing)
    python = store._load_json_python.calls
    _same(store.load_embeddings(path, dataset="waterbirds"), table)
    assert store._load_json_python.calls == python + 1
    out = path + ".python.json"
    saved = store._save_json_python.calls
    store.save_embeddings(out, table, fmt="json")
    assert store._save_json_python.calls == saved + 1
    _same(store._load_json_python(out, "waterbirds"), table)


def test_store_surfaces_the_native_diagnostic(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text('{"a.jpg": {"y": "0", "image_embedding": [1.0, oops]}}')
    with pytest.raises(ValueError, match="ebdjson") as err:
        ebdjson.load_embeddings_json(str(bad), "waterbirds")
    with pytest.raises(ValueError, match="native parser: .*ebdjson.*python parser") as both:
        store.load_embeddings(str(bad), dataset="waterbirds")
    with pytest.raises(ValueError) as jax_both:
        jstore.load_embeddings(str(bad), dataset="waterbirds")
    assert str(err.value) in str(both.value)
    assert str(both.value) == str(jax_both.value)


def test_writer_round_trip_reads_back_in_the_jax_store(tmp_path):
    _, table, *_ = make_synthetic_dataset(SyntheticSpec(n_train=64, n_val=16, n_test=16))
    path = str(tmp_path / "written.json")
    store.save_embeddings(path, table, fmt="json", dataset="celeba")
    _same(jstore.load_embeddings(path, dataset="celeba"), table)
    rec = next(iter(json.loads(open(path).read()).values()))
    assert set(rec) == {"blond", "male", "group", "split", "image_embedding", "y_pred"}
    assert isinstance(rec["blond"], str)


def test_unicode_escapes_and_missing_fields(tmp_path):
    rec = {"y": "1", "place": "0", "group": "2", "split": "0", "y_pred": "1",
           "image_embedding": [0.5, -0.25]}
    good = tmp_path / "good.json"
    good.write_text(json.dumps({"café/\U0001f426.jpg": rec}))  # ensure_ascii escapes
    for load in (ebdjson.load_embeddings_json, jebdjson.load_embeddings_json,
                 store._load_json_python):
        table = load(str(good), "waterbirds")
        assert table.filenames[0] == "café/\U0001f426.jpg"
        np.testing.assert_allclose(table.embeddings[0], [0.5, -0.25])
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"a.jpg": {"blond": "1", "male": "0", "group": "2",
                                         "split": "0", "y_pred": "1",
                                         "image_embedding": [0.0]}}))
    with pytest.raises(ValueError, match="missing required fields") as err:
        ebdjson.load_embeddings_json(str(bad), "waterbirds")
    with pytest.raises(ValueError) as jerr:
        jebdjson.load_embeddings_json(str(bad), "waterbirds")
    assert str(err.value) == str(jerr.value)


def test_writer_escapes_quotes(tmp_path):
    name = 'odd"name\\with.jpg'
    table = store.EmbeddingTable(
        filenames=np.asarray([name]), y=np.asarray([1], np.int32),
        place=np.asarray([0], np.int32), group=np.asarray([2], np.int32),
        split=np.asarray([0], np.int32), y_pred=np.asarray([1], np.int32),
        embeddings=np.asarray([[0.125, 2.0]], np.float32))
    path = tmp_path / "t.json"
    ebdjson.save_embeddings_json(str(path), table, "waterbirds")
    json.loads(path.read_text())  # the stdlib accepts it
    for load in (ebdjson.load_embeddings_json, jebdjson.load_embeddings_json):
        assert load(str(path), "waterbirds").filenames[0] == name


ISOLATION = r"""
import json, os, sys
from debiasing_multi_modal_tpu_torch.native import ebdjson
ebdjson.BUILD_DIR = sys.argv[1]
from debiasing_multi_modal_tpu_torch.data import embeddings_store as store
from debiasing_multi_modal_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_dataset
_, table, *_ = make_synthetic_dataset(SyntheticSpec(n_train=8, n_val=4, n_test=4))
path = os.path.join(sys.argv[1], "c.json")
store.save_embeddings(path, table, fmt="json")
store.load_embeddings(path)
maps = [line.split()[-1] for line in open("/proc/self/maps") if "ebdjson" in line]
print(json.dumps({"maps": sorted(set(maps)), "built": sorted(os.listdir(sys.argv[1])),
                  "native": ebdjson.load_embeddings_json.calls}))
"""


def test_the_port_never_touches_the_jax_library(tmp_path):
    """In a fresh interpreter the port builds its own library from
    native/ebdjson.cpp into its build directory and maps only that one;
    native/libebdjson.so (the JAX binding's) is neither written nor opened."""
    jax_lib = os.path.join(REPO, "native", "libebdjson.so")

    def stamp():
        return os.stat(jax_lib).st_mtime_ns if os.path.exists(jax_lib) else None

    before = stamp()
    proc = subprocess.run([sys.executable, "-c", ISOLATION, str(tmp_path)], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["native"] == 1
    assert [os.path.basename(m) for m in out["maps"]] == [
        os.path.basename(ebdjson.library_path())]
    assert out["maps"][0].startswith(str(tmp_path))
    assert stamp() == before
    assert ebdjson.SOURCE == os.path.join(REPO, "native", "ebdjson.cpp")
    assert os.path.dirname(ebdjson.library_path()) == os.path.join(
        REPO, "debiasing_multi_modal_tpu_torch", "build")
