"""The FLOP and byte counters against counts made by hand."""

import json
import os

import pytest

from portbench.counts import bounds, flops
from portbench.tests.conftest import ROOT


def _cfg(name):
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        return json.load(f)


def test_transformer_by_hand():
    # 2 tokens of width 4: 12 * 4^2 MACs a token, QK^T and PV over 4 pairs
    assert flops.transformer_macs(4, 1, 2) == 2 * 12 * 16 + 2 * 4 * 4
    assert flops.transformer_macs(4, 1, 2, causal=True) == 2 * 12 * 16 + 2 * 3 * 4


def test_vit_b32_by_hand():
    patch = 49 * (3 * 32 * 32) * 768
    blocks = 12 * (50 * 12 * 768 * 768 + 2 * 50 * 50 * 768)
    head = 768 * 512 + 512 * 2
    assert flops.image_flops(_cfg("clip-vit-b32"), 2) == 2 * (patch + blocks + head)


def test_rn50_by_hand():
    def conv(cin, cout, k, hw):
        return cin * cout * k * k * hw * hw

    macs = conv(3, 32, 3, 112) + conv(32, 32, 3, 112) + conv(32, 64, 3, 112)
    inplanes, hw = 64, 56
    for planes, blocks, stride in ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)):
        for b in range(blocks):
            s = stride if b == 0 else 1
            macs += conv(inplanes, planes, 1, hw) + conv(planes, planes, 3, hw)
            macs += conv(planes, 4 * planes, 1, hw // s)
            if b == 0:
                macs += conv(inplanes, 4 * planes, 1, hw // s)
            inplanes, hw = 4 * planes, hw // s
    c = 2048
    macs += c * c + 2 * 50 * c * c + 2 * 50 * c + c * 1024 + 1024 * 2
    assert flops.image_flops(_cfg("clip-rn50"), 2) == 2 * macs
    assert flops.image_flops(_cfg("clip-rn50"), 2) == pytest.approx(11.586e9, rel=1e-3)


def test_adapter_by_hand():
    d, h = 1024, 128
    assert flops.adapter_train_flops(d, h, 2, False) == 2 * (5 * d * h + 3 * d * 2)
    assert flops.adapter_train_flops(d, h, 4, True) == 2 * (7 * d * h + 3 * d * 4)


def test_attention_bound_by_hand():
    ms, what = bounds.attention_bound_ms(256, 50, 768, 12, False, "bfloat16", 2)
    assert what == "bytes"
    assert ms == pytest.approx(4 * 256 * 50 * 768 * 2 / 3.35e12 * 1e3)
    ms, what = bounds.attention_bound_ms(1, 4096, 64, 1, False, "bfloat16", 2)
    assert what == "operations"
    assert ms == pytest.approx(4 * 4096 * 4096 * 64 / 989e12 * 1e3)


def test_other_bounds_by_hand():
    ms, _ = bounds.int8_bound_ms(1024, 1024, 1024, 2, False)
    assert ms == pytest.approx(max((2 * 2 ** 20 + 4 * 2048 + 2 ** 21) / 3.35e12,
                                   2 * 2 ** 30 / 1979e12) * 1e3)
    fl = bounds.flash_bounds(1, 8, 8, 1, 64, False, "bfloat16", 2)
    assert set(fl) == {"flash_attention", "flash_attention_dq", "flash_attention_dkv"}
    ms, _ = bounds.bottleneck_bound_ms(1, 7, 2048, 512, 2048, False, 2)
    assert ms > 0
