"""The stacked sweep's one row model (debiasing_multi_modal_tpu_torch/sweep/
vmap_loop.py ``train_seeds_vmapped``): a call without a grid gives every
row the base config, which is exactly a grid of that one cell.

Apart from ``test_torch_sweep.py`` so that the two files run on separate
workers; its bundle and cases are reused."""

import pytest

from debiasing_multi_modal_tpu_torch.sweep import vmap_loop as tvm
from debiasing_multi_modal_tpu_torch.train.config import TrainConfig
from test_torch_sweep import BASE, CASES, SEEDS, bundles  # noqa: F401  (a fixture)

ROW_CASES = ("adapter", "seq_alter_ma", "adapter_reg", "contrastive")


@pytest.mark.parametrize("case", ROW_CASES)
def test_shared_rows_equal_a_one_cell_grid(bundles, case):  # noqa: F811
    _, tb = bundles
    method, extra = CASES[case]
    cfg = TrainConfig(tl_method=method, epochs=5, **extra, **BASE)
    shared = tvm.train_seeds_vmapped(cfg, tb, SEEDS, device="cpu")
    grid = tvm.train_seeds_vmapped(cfg, tb, SEEDS, cell_grid=[cfg], device="cpu")
    assert len(shared) == len(grid) == len(SEEDS)
    assert shared == grid
