"""Training configuration (the port's copy of ``train/config.py``).

Parity surface: the ~30 argparse flags of reference ``parse_option``
(final_main.py:176-297) plus its derived values (warmup endpoints, dataset-
conditional reg warmup epochs, n_cls).  A frozen dataclass, copied unchanged from
the JAX package (the port imports nothing of it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

TL_METHODS = (
    "linear_probing",
    "adapter",
    "adapter_reg",
    "adapter_reg_seq",
    "adapter_reg_seq_alter",
    "contrastive_adapter",
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # core schedule
    batch_size: int = 128
    batch_size_reg: int = 128
    epochs: int = 10
    learning_rate: float = 1e-1
    learning_rate_reg: float = 1e-3
    lr_decay_epochs: Tuple[int, ...] = (60, 75, 90)
    lr_decay_rate: float = 1.0
    weight_decay: float = 5e-5
    momentum: float = 0.9
    cosine: bool = False
    warm: bool = False
    warm_reg: bool = False

    # task
    dataset: str = "waterbirds"
    tl_method: str = "linear_probing"
    train_target: str = "class"  # class | spurious | group
    n_cls: int = 2

    # two-phase machinery
    epochs_feature_learning: Optional[int] = None
    balance_val: bool = False
    resample_ce: bool = False
    use_cls_prompt_in_reg: bool = False
    add_adapter: bool = False
    init_near_identity: bool = False
    continue_from_best: bool = False

    # model
    adapter_feat_dim: int = 128
    zs_temperature: float = 0.01
    input_dim: int = 1024

    # contrastive_adapter method (SupCon machinery, demo/visualizer_supcon.py)
    num_anchor: int = 1
    num_positive: int = 64
    num_negative: int = 64
    cl_temperature: float = 0.1
    batch_factor: int = 4  # contrastive rows per optimizer step
    # SupCon loss scale (visualizer_supcon.py:477).  The reference's
    # --contrastive_weight flag is DEAD — parse_option clobbers it with 0.1
    # (visualizer_supcon.py:255) — so 0.1 is the effective reference value;
    # here the flag is live (deliberate deviation, PARITY.md)
    contrastive_weight: float = 0.1
    # CE batches interleaved after each SupCon epoch.  The working reference
    # CA flow (workspace/jinsu/SupCon.ipynb cell 7) runs a FULL CE epoch
    # after every contrastive epoch; demo/visualizer_supcon.py:354 caps the
    # CE pass at `opt.ce_update` batches but never defines that attribute
    # (AttributeError if reached — latent reference bug).  -1 = full CE
    # epoch (default, the notebook flow), 0 = pure SupCon, N>0 = cap at N
    # batches (what the :354 guard intends).
    ca_ce_update: int = -1
    # L2-normalize embeddings before the adapter in the CA loss path only
    # (opt.ca_pre_norm = True, set unconditionally in parse_option,
    # visualizer_supcon.py:258; the CE/ZS forward stays un-prenormalized)
    ca_pre_norm: bool = True
    # contrastive projection head: the working notebook flow sets
    # opt.ca_head = 'linear' with ca_feat_dim 128 (SupCon.ipynb cell 3:13,
    # cell 0:64,91-95 — adapter output -> Linear(D, ca_feat_dim) -> normalize
    # in the CL loss path only; CE/eval always use the bare adapter).
    # Default None keeps the head off (PARITY deviation 6 discusses both).
    ca_head: Optional[str] = None  # None | "linear"
    ca_feat_dim: int = 128

    # misc
    random_seed: int = 42
    save_results: bool = False
    print_freq: int = 10
    # accepted for flag-surface parity; per-batch prints don't exist here —
    # logging is per-epoch, as in the JAX package (PARITY deviation 13)
    watch_batch_results: bool = False

    def __post_init__(self):
        if self.tl_method not in TL_METHODS:
            raise ValueError(f"unknown tl_method {self.tl_method!r}")
        if self.epochs < 1:
            # epochs=0 would leave best-model bookkeeping with no history
            # row to read (the reference's range(1, epochs+1) silently does
            # nothing and then crashes saving results)
            raise ValueError("epochs must be >= 1")
        if self.tl_method == "adapter" and (self.add_adapter or self.balance_val):
            # ValueError, not assert: python -O strips asserts and would
            # admit a configuration the reference forbids
            raise ValueError(
                "plain adapter excludes add_adapter/balance_val "
                "(parse_option parity)"
            )
        if self.dataset not in ("waterbirds", "celeba"):
            # reference parse_option raises for unknown datasets; silently
            # passing would take waterbirds' warm_epochs_reg=10 branch
            raise ValueError(f"dataset not supported: {self.dataset!r}")
        if self.is_two_phase and self.epochs_feature_learning is None:
            raise ValueError("sequential methods require epochs_feature_learning")
        # epochs_feature_learning >= epochs is LEGAL (phase 2 simply never
        # starts — reference flag space, pinned by
        # test_more_paths.py::test_feature_learning_spans_all_epochs); the
        # one real hazard (cosine reg warmup's zero span) raises a clear
        # error in warmup_to_reg.

    # ------------------------------------------------------------ derived --
    @property
    def is_reg_method(self) -> bool:
        return self.tl_method in ("adapter_reg", "adapter_reg_seq", "adapter_reg_seq_alter")

    @property
    def is_two_phase(self) -> bool:
        return self.tl_method in ("adapter_reg_seq", "adapter_reg_seq_alter")

    def use_group_prompt(self, epoch: int) -> bool:
        """Stage-2 prompt selection for ``epoch`` (absolute, 1-based).

        The alternating method keys on absolute-epoch parity (final_main.py:
        954-968: even epochs train on the 4-way group prompts); the plain
        sequential method follows ``use_cls_prompt_in_reg``.  Golden-tested
        against the Train-2 prompt tags in demo/results_waterbirds.out.
        """
        if self.tl_method == "adapter_reg_seq_alter":
            return (epoch % 2) == 0
        return not self.use_cls_prompt_in_reg

    @property
    def warm_epochs(self) -> int:
        return 10

    @property
    def warm_epochs_reg(self) -> int:
        # dataset-conditional default (final_main.py:275-278)
        return 2 if self.dataset == "celeba" else 10

    @property
    def warmup_from(self) -> float:
        return 0.01

    @property
    def warmup_to(self) -> float:
        if self.cosine:
            eta_min = self.learning_rate * (self.lr_decay_rate ** 3)
            return eta_min + (self.learning_rate - eta_min) * (
                1 + math.cos(math.pi * self.warm_epochs / self.epochs)
            ) / 2
        return self.learning_rate

    @property
    def warmup_from_reg(self) -> float:
        return self.learning_rate_reg / 1e2

    @property
    def warmup_to_reg(self) -> float:
        if self.cosine:
            assert self.epochs_feature_learning is not None
            span = self.epochs - self.epochs_feature_learning
            if span <= 0:
                raise ValueError(
                    "cosine reg warmup needs epochs_feature_learning < epochs"
                )
            eta_min = self.learning_rate_reg * (self.lr_decay_rate ** 3)
            return eta_min + (self.learning_rate_reg - eta_min) * (
                1
                + math.cos(
                    math.pi
                    * self.warm_epochs_reg
                    / span
                )
            ) / 2
        return self.learning_rate_reg

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
