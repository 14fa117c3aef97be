"""On the card: the controls at a size a test run holds, each rejected by
the cell's limits.  ``python -m pytest portbench/tests -m card`` on the
card; they skip elsewhere."""

import pytest

from portbench.core.manifest import Manifest
from portbench.tests.conftest import ROOT

pytestmark = pytest.mark.card


def _cell(name):
    m = Manifest(ROOT)
    w = m.workload(name)
    return m, m.config(w["config"]), m.traffic(w["traffic"]), m.limits(name)


@pytest.mark.parametrize("workload", ["rn50-extract-celeba", "vitb32-extract-waterbirds"])
def test_fp8_control_is_rejected(card, workload):
    from portbench.checks import extract as checks
    from portbench.core.inputs import image_pool, prompt_tokens

    _, cfg, tr, limits = _cell(workload)
    pool = image_pool(3, 1, 64, tr["height"], tr["width"], card)
    tokens = prompt_tokens(3, tr["prompts"], cfg["context_length"], device=card)
    found = checks.control_readings(cfg, 3, 64, pool, tokens, card)
    assert any(found[k] > limits[k] for k in found), found


SWEEP_MIXES = {"rn50-sweep-waterbirds": "waterbirds-grid48",
               "rn50-sweep-celeba-balanced": "celeba-balanced-grid6"}


@pytest.mark.parametrize("workload", sorted(SWEEP_MIXES))
def test_tf32_control_is_rejected(card, workload):
    import time

    from portbench.checks import sweep as checks
    from portbench.core.cell import Context

    m = Manifest(ROOT)
    cfg, tr, limits = m.config("clip-rn50"), m.traffic(SWEEP_MIXES[workload]), m.limits(workload)
    tr["sizes"] = {"train": 4795, "val": 1199, "test": 1000}
    tr["grid"]["seeds"] = tr["grid"]["seeds"][:1]
    ctx = Context(workload=workload, seed=5, seconds=0.1, config=cfg, traffic=tr, limits={},
                  device=card, t_start=time.perf_counter())
    notes = m.loop("sweep").run(ctx).notes
    side = checks.reference_steps(tr, notes["data"], notes["inits"], sorted(notes["recordings"]),
                                  card, variant="tf32", program=notes["recordings"])
    found = checks.readings(side, notes["reference"])
    assert any(found[k] > limits[k] for k in found), found
