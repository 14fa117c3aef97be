"""Every input the benchmark makes comes from the seed: the same seed gives
the same inputs, another seed other inputs, and seeds past 32 bits work."""

import numpy as np
import pytest
import torch

from portbench.core import inputs
from portbench.core.clip_weights import make_state_dict
from portbench.tests.conftest import TINY_RN, TINY_VIT

CPU = torch.device("cpu")
BIG = 2 ** 31 + 12345


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


MAKERS = {
    "images": lambda s: inputs.image_pool(s, 2, 3, 20, 14, CPU),
    "prompts": lambda s: inputs.prompt_tokens(s, {"class": 2, "group": 4}, 16, device=CPU),
    "cache": lambda s: inputs.embedding_cache(
        s, 16, {"train": 40, "val": 20, "test": 20},
        {"spurious_corr": 0.95, "class_signal": 1.0, "spurious_signal": 2.0, "noise": 0.8}, CPU),
    "inits": lambda s: inputs.adapter_inits(s, 3, 16, 4, CPU),
    "rn_weights": lambda s: make_state_dict(TINY_RN, s, CPU),
    "vit_weights": lambda s: make_state_dict(TINY_VIT, s, CPU),
}


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_same_seed_same_inputs(name):
    assert _same(MAKERS[name](BIG), MAKERS[name](BIG))


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_other_seed_other_inputs(name):
    assert not _same(MAKERS[name](BIG), MAKERS[name](BIG + 1))


def test_prompts_end_in_eot():
    ids = inputs.prompt_tokens(7, {"class": 5}, 16, device=CPU)["class"]
    assert (ids[:, 0] == inputs.SOT).all()
    assert (ids.argmax(1) == (ids == inputs.EOT).argmax(1)).all()


def test_cache_structure():
    splits, texts = MAKERS["cache"](3)
    emb, y, place, _ = splits["train"]
    assert emb.shape == (40, 16) and set(np.unique(y)) <= {0, 1}
    assert texts["class"].shape == (16, 2) and texts["group"].shape == (16, 4)


def test_adapter_inits_layout():
    init = inputs.adapter_inits(5, 2, 16, 4, CPU)[1]
    assert init["init_sd"]["adapter.layers.0.weight"].shape == (4, 16)
    assert init["ma_new_sd"]["new_adapter.layers.3.weight"].shape == (16, 4)
    bound = 16 ** -0.5
    assert np.abs(init["init_sd"]["adapter.layers.0.weight"]).max() <= bound
