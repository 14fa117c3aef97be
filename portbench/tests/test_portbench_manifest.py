"""The manifest against the benchmark's rules, and the files it names."""

import os

import pytest

from portbench.core.clip_weights import clip_layout
from portbench.core.manifest import NAME_RE, UNIT_RE, Manifest, problems
from portbench.tests.conftest import ROOT


@pytest.fixture(scope="module")
def manifest():
    return Manifest(ROOT)


def test_no_problems(manifest):
    assert problems(manifest) == []


def test_names_and_units(manifest):
    d = manifest.data
    for m in d["end_to_end"] + d["per_layer"]:
        assert NAME_RE.match(m["name"]) and UNIT_RE.match(m["unit"]), m
    for entry in d["workloads"] + d["configs"]:
        assert NAME_RE.match(entry["name"])
    assert not UNIT_RE.match("tokens per second")
    assert not NAME_RE.match("a b") and not NAME_RE.match("a/b") and not NAME_RE.match("x" * 65)


def test_moves_reported_by_every_cell(manifest):
    for m in manifest.data["per_layer"]:
        for w in m["workloads"]:
            assert m["moves"] in {e["name"] for e in manifest.end_to_end(w)}, (m["name"], w)


def test_every_cell_reports_setup_and_one_more(manifest):
    for w in manifest.data["workloads"]:
        names = {m["name"] for m in manifest.end_to_end(w["name"])}
        assert "setup_s" in names and len(names) >= 2
        assert manifest.per_layer(w["name"])


def test_four_chip_share(manifest):
    cells = manifest.data["workloads"]
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


def test_four_chip_rule_is_checked():
    fresh = Manifest(ROOT)
    for w in fresh.data["workloads"][:2]:
        w["chips"] = 4
    assert any("four chips" in p for p in problems(fresh))


def test_every_metric_has_a_reader(manifest):
    """BENCHMARK.json alone says a metric's layer, unit, ``moves`` and cells:
    a reader holds only ``read``."""
    for m in manifest.data["per_layer"]:
        reader = manifest.metric_reader(m["name"])
        assert callable(reader.read), m["name"]
        assert not {"LAYER", "UNIT", "MOVES", "WORKLOADS"} & set(vars(reader)), m["name"]


def test_configs_match_the_port(manifest):
    import torch

    from debiasing_multi_modal_tpu_torch.models.config import CONFIGS
    from portbench.loops.extract import port_config

    for entry in manifest.data["configs"]:
        cfg = manifest.config(entry["name"])
        assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
        ours, port = port_config(cfg), CONFIGS[cfg["port_config"]].with_dtype(torch.bfloat16)
        assert ours == port
        assert cfg["vision_heads"] == port.vision_heads


@pytest.mark.parametrize("name", ["clip-rn50", "clip-vit-b32"])
def test_layout_is_the_port_state_dict(manifest, name):
    import torch

    from debiasing_multi_modal_tpu_torch.models.clip import CLIP
    from portbench.loops.extract import port_config

    cfg = manifest.config(name)
    with torch.device("meta"):
        model = CLIP(port_config(cfg))
    port = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    ours = {k: tuple(shape) for k, (shape, _) in clip_layout(cfg).items()}
    assert ours == port


def test_bounds_and_run_seconds(manifest):
    d = manifest.data
    assert 1 <= d["run_seconds"] <= 51
    for m in d["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert d["command"] == ["python3", "portbench/run.py"] and d["paths"] == ["portbench"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
