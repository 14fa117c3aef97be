"""The port's host plumbing: the extraction feed's background prefetch
(debiasing_multi_modal_tpu_torch/data/prefetch.py), the profiler trace
helper (utils/profiling.py) and the device rule (utils/platform.py)."""

import os
import threading
import time

import pytest
import torch

from debiasing_multi_modal_tpu_torch.data.prefetch import prefetch
from debiasing_multi_modal_tpu_torch.utils.platform import compute_dtype, resolve_device
from debiasing_multi_modal_tpu_torch.utils.profiling import trace


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetch_keeps_order_and_surfaces_errors(depth):
    assert list(prefetch(range(10), depth=depth)) == list(range(10))

    def failing():
        yield 1
        raise RuntimeError("decode failed")

    it = prefetch(failing(), depth=depth)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)


def test_prefetch_producer_stops_when_consumer_leaves():
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    before = threading.active_count()
    it = prefetch(endless(), depth=2)
    assert next(it) == 0
    it.close()
    deadline = time.monotonic() + 5
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    assert len(produced) <= 5  # bounded by the buffer, not run to exhaustion


def test_trace_writes_a_profile_and_can_be_disabled(tmp_path):
    with trace(str(tmp_path / "off"), enabled=False) as prof:
        assert prof is None
    assert not (tmp_path / "off").exists()
    with trace(str(tmp_path / "on")) as prof:
        torch.ones(8).sum()
    assert prof is not None
    assert any(f.endswith(".json") for f in os.listdir(tmp_path / "on"))


def test_device_rule():
    assert resolve_device("cpu") == torch.device("cpu")
    assert compute_dtype(torch.device("cpu")) == torch.float32
    assert compute_dtype(torch.device("cuda")) == torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
