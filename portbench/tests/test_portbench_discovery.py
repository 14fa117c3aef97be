"""A cell, a configuration, a traffic mix and a metric added as files alone
are found by name."""

import hashlib
import json
import os
import shutil

from portbench.core.manifest import Manifest, problems
from portbench.tests.conftest import ROOT


def test_added_files_are_found(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = tmp_path / "portbench"
    before = _digests(bench)
    cfg = json.loads((bench / "configs" / "clip-rn50.json").read_text())
    cfg["name"] = "clip-rn101"
    cfg["port_config"] = "RN101"
    cfg["vision_layers"] = [3, 4, 23, 3]
    cfg["embed_dim"] = 512
    (bench / "configs" / "clip-rn101.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "waterbirds-224-b256.json").read_text())
    mix["batch"] = 128
    (bench / "traffic" / "waterbirds-224-b128.json").write_text(json.dumps(mix))
    (bench / "limits" / "rn101-extract-waterbirds.json").write_text(
        json.dumps({"emb_rel_err": 0.1, "text_rel_err": 0.1, "pred_mismatch": 0,
                    "ref_pred_mismatch": 0}))
    (bench / "metrics" / "upload_ms.extract.py").write_text(
        'def read(record):\n    return record.counters.get("upload_ms")\n')
    d = json.loads((tmp_path / "BENCHMARK.json").read_text())
    d["configs"].append({"name": "clip-rn101", "source": cfg["source"],
                         "file": "portbench/configs/clip-rn101.json", "reduced": [],
                         "why": "a deeper third stage"})
    d["workloads"].append({"name": "rn101-extract-waterbirds", "config": "clip-rn101",
                           "traffic": "waterbirds-224-b128", "chips": 1, "why": "test cell"})
    d["end_to_end"][1]["workloads"].append("rn101-extract-waterbirds")
    for metric in d["per_layer"]:  # metrics that exist already report the new cell too
        if metric["name"] in ("image_tower_ms.extract", "mfu.extract"):
            metric["workloads"].append("rn101-extract-waterbirds")
    d["per_layer"].append({"name": "upload_ms.extract", "unit": "ms", "better": "lower",
                           "source": "host_clock", "layer": "CLI and runner",
                           "moves": "extract_imgs_per_s",
                           "workloads": ["rn101-extract-waterbirds"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(d))

    after = _digests(bench)
    assert {k: after[k] for k in before} == before  # no file that was there changed
    m = Manifest(str(tmp_path))
    assert problems(m) == []
    cell = m.workload("rn101-extract-waterbirds")
    assert m.config(cell["config"])["vision_layers"] == [3, 4, 23, 3]
    assert m.traffic(cell["traffic"])["batch"] == 128
    assert m.limits(cell["name"])["pred_mismatch"] == 0
    assert m.loop(m.traffic(cell["traffic"])["loop"]).run
    names = [x["name"] for x in m.per_layer(cell["name"])]
    assert names == ["image_tower_ms.extract", "mfu.extract", "upload_ms.extract"]

    class Rec:
        counters = {"upload_ms": 1.5}
        notes = {"imgs_per_s": 1000.0, "image_flops": 1e10}

        def device_ms(self, name):
            return [2.0, 4.0] if name == "image_tower" else []

    assert m.metric_reader("upload_ms.extract").read(Rec()) == 1.5
    assert m.metric_reader("image_tower_ms.extract").read(Rec()) == 3.0
    assert m.metric_reader("mfu.extract").read(Rec()) > 0


def _digests(folder):
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file()}


def test_missing_files_are_problems(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.remove(tmp_path / "portbench" / "limits" / "rn50-extract-celeba.json")
    os.remove(tmp_path / "portbench" / "metrics" / "mfu.extract.py")
    found = problems(Manifest(str(tmp_path)))
    assert any("rn50-extract-celeba" in p for p in found)
    assert any("mfu.extract" in p for p in found)
