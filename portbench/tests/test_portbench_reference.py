"""The plain references against the port at tiny sizes on the CPU (only
these tests import both), and the loops' comparisons passing on sound
runs."""

import numpy as np
import pytest
import torch

from portbench.core.clip_weights import make_state_dict
from portbench.reference import clip_f32
from portbench.tests.conftest import TINY_RN, TINY_VIT, run_tiny

CPU = torch.device("cpu")


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("cfg", [TINY_RN, TINY_VIT], ids=["resnet", "vit"])
def test_towers_match_the_port_in_f32(cfg):
    from portbench.loops.extract import build_model

    cfg = dict(cfg, compute_dtype="float32")
    model = build_model(cfg, 11, CPU)
    sd = make_state_dict(cfg, 11, CPU)
    x = torch.randn(3, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    ids = torch.from_numpy(np.array([[49406, 5, 9, 49407] + [0] * 12,
                                     [49406, 7, 49407] + [0] * 13]))
    with torch.no_grad():
        assert _rel(model.encode_image(x), clip_f32.encode_image(x.permute(0, 3, 1, 2), sd, cfg)) < 1e-5
        assert _rel(model.encode_text(ids), clip_f32.encode_text(ids, sd, cfg)) < 1e-5


@pytest.mark.parametrize("hw", [(54, 44), (64, 64), (90, 70)])
def test_preprocess_matches_the_port(hw):
    from debiasing_multi_modal_tpu_torch.ops.preprocess import preprocess_uint8

    images = torch.randint(0, 256, (2, *hw, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    port = preprocess_uint8(images, 64).permute(0, 3, 1, 2)
    ours = clip_f32.preprocess(images, 64)
    assert float((port - ours).abs().max()) < 1e-4


def test_fp8_numerics_round():
    t = torch.linspace(-3, 3, 101)
    q = clip_f32.Numerics("fp8").q(t)
    assert 0 < float((q - t).abs().max()) < 0.2
    assert torch.equal(clip_f32.Numerics("f32").q(t), t)


@pytest.mark.parametrize("kind", ["rn", "vit", "wb", "ca"])
def test_sound_run_is_correct(kind):
    out = run_tiny(kind)
    assert out.correct, [(c.name, c.value, c.limit) for c in out.checks]
    assert out.failed == 0 and out.attempted > 0
    rate = out.end_to_end.get("extract_imgs_per_s", out.end_to_end.get("sweep_samples_per_s"))
    assert rate > 0 and out.end_to_end["setup_s"] > 0


def test_ref_pred_mismatch_counts_what_the_gaps_cannot_explain():
    from portbench.checks.extract import ref_pred_mismatch

    g = torch.Generator().manual_seed(4)
    ref = torch.randn(64, 16, generator=g).numpy()
    cls = torch.randn(2, 16, generator=g).numpy()
    top = clip_f32.zero_shot_logits(torch.from_numpy(ref), torch.from_numpy(cls), 0.02).argmax(1)
    pred = top.numpy().copy()
    assert ref_pred_mismatch(ref, pred, cls, ref, cls, 0.02) == 0
    pred[:8] = 1 - pred[:8]  # the head answers wrong on rows the towers got right
    assert ref_pred_mismatch(ref, pred, cls, ref, cls, 0.02) == 8
    moved = ref.copy()
    moved[:8] = -moved[:8]  # rows whose embeddings are far off explain any answer
    assert ref_pred_mismatch(moved, pred, cls, ref, cls, 0.02) == 0
