"""Two-phase sequential/alternating adapter training orchestrator (port of
``train/loop.py``).

Parity surface: reference ``train_all_epochs`` (final_main.py:805-1128) and
its epoch functions —

- phase 1 "feature learning": ERM on the train split with class prompts
  (``train_one_epoch``, :426-496).  ``--resample_ce`` trains on a zero-shot-
  failure resampled order here (PARITY deviation 11).
- ``adapter_reg``: every epoch interleaves the train loader (class prompts)
  and the reg loader (group or class prompts) in one optimizer
  (``train_reg_one_epoch``, :498-569).
- phase 2 "balanced learning" (sequential methods): from epoch
  ``epochs_feature_learning + 1``, train only on the group-stratified half of
  the validation split (``train_reg_seq_one_epoch``, :571-653) with a fresh
  SGD (momentum reset, :947-950), optionally from the best-so-far model
  (``--continue_from_best``) and optionally through a MultipleAdapter whose
  old branch is frozen (``--add_adapter``, :940-951).  ``adapter_reg_seq_
  alter`` alternates class/group prompts on absolute epoch parity (:954-968);
  ``--balance_val`` re-balances the reg subset every epoch (:920-921).
- ``contrastive_adapter``: supervised-contrastive epochs on the adapter
  (train/contrastive.py) over anchor rows built once from the zero-shot
  mistakes (data/contrastive.py), each followed by a CE pass
  (``ca_ce_update``); the optional projection head keeps its own parameters
  and momentum.
- per-epoch validation on the val half (model selection by worst-group
  accuracy, :1001-1008) and logging-only test evaluation (:1012-1017);
  final zero-shot feature-quality probes (``validate_zs``, :725-803);
  results JSON + the best model (:1050-1122).  As in the JAX package, the
  per-epoch "Val" slot holds the validation results.

Every numpy draw (shuffles, balanced subsets, resampling) is the JAX
package's, in its order, so one ``random_seed`` gives both packages the same
batch plans.  The epochs run on ``device`` (``cuda`` unless the caller asks
for the CPU) through train/steps.py; the host reads each epoch's meters
once, for the result dicts and the best-model comparison (and a contrastive
epoch's mean loss).

:func:`shard_bundle` makes Stage B data-parallel over a mesh's ``data``
axis: each rank keeps its padded block of each split's embedding rows, and
every epoch runs the shared batch plans on the rows each rank holds
(``train/steps.py``), with the BatchNorm statistics, the losses, the
gradients and the meters all-reduced, so the result dicts are the unsharded
run's.  Rank 0 writes the checkpoints and the results.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from debiasing_multi_modal_tpu_torch.data.groups import GroupTable
from debiasing_multi_modal_tpu_torch.data.samplers import (
    balanced_subset_indices,
    cached_eval_plan,
    epoch_plan,
    resampled_ce_weights,
    stratified_split_indices,
    weighted_sample_indices,
)
from debiasing_multi_modal_tpu_torch.data.contrastive import (
    clamp_counts,
    construct_contrastive_rows,
    prepare_contrastive_points,
)
from debiasing_multi_modal_tpu_torch.models.adapter import (
    AdapterClassifier,
    CAEncoder,
    LinearClassifier,
    MultipleAdapterClassifier,
    zero_shot_logits,
)
from debiasing_multi_modal_tpu_torch.parallel.mesh import RowShard, axis_group
from debiasing_multi_modal_tpu_torch.train.config import TrainConfig
from debiasing_multi_modal_tpu_torch.train.contrastive import train_contrastive_epoch
from debiasing_multi_modal_tpu_torch.train.metrics import ordered, results_from_counts
from debiasing_multi_modal_tpu_torch.train.schedules import epoch_batch_lrs
from debiasing_multi_modal_tpu_torch.train.steps import (
    EpochStats,
    TrainState,
    eval_epoch,
    freeze_subtrees,
    init_train_state,
    ones_mask,
    reset_optimizer,
    train_epoch,
)
from debiasing_multi_modal_tpu_torch.utils.platform import (
    DeviceLike,
    full_f32,
    on_device,
    resolve_device,
)
from debiasing_multi_modal_tpu_torch.utils.seed import set_seed
from debiasing_multi_modal_tpu_torch.utils.staging import DeviceCache, upload


@dataclasses.dataclass
class SplitArrays:
    """One split's columns: the embeddings on the device, the rest on the
    host.  With ``shard`` (:func:`shard_bundle`) ``emb`` holds only this
    rank's block of the rows."""

    emb: torch.Tensor  # [N, D] float32, or this rank's [N/n, D] block
    y: np.ndarray
    place: np.ndarray
    group: np.ndarray
    y_pred: np.ndarray
    shard: Optional[RowShard] = None

    def __len__(self):
        return len(self.y)

    def labels(self, target: str) -> np.ndarray:
        return {
            "class": self.y,
            "spurious": self.place,
            "group": self.group,
        }[target].astype(np.int32)

    def take(self, idx: np.ndarray) -> "SplitArrays":
        """The rows ``idx``, sharded as this split is."""
        idx = np.asarray(idx)
        emb = self.full_emb().index_select(0, upload(idx.astype(np.int64), self.emb.device))
        shard = None
        if self.shard is not None:
            shard = RowShard.of(len(idx), self.shard.group)
            emb = shard.take(emb)
        return SplitArrays(
            emb=emb,
            y=self.y[idx],
            place=self.place[idx],
            group=self.group[idx],
            y_pred=self.y_pred[idx],
            shard=shard,
        )

    def full_emb(self) -> torch.Tensor:
        """Every row's embedding (gathered from the ranks when sharded)."""
        return self.emb if self.shard is None else self.shard.gather(self.emb)

    def to(self, device: torch.device) -> "SplitArrays":
        return dataclasses.replace(self, emb=self.emb.to(device))


@dataclasses.dataclass
class DataBundle:
    """Everything Stage B needs: embeddings on the device, labels and text
    matrices on the host."""

    train: SplitArrays
    val: SplitArrays
    test: SplitArrays
    text_class: np.ndarray  # [D, n_cls] un-normalized
    text_spurious: np.ndarray  # [D, 2]
    text_group: np.ndarray  # [D, 4]
    train_group_ratio: np.ndarray  # [4]
    n_groups: int = 4
    n_places: int = 2


def bundle_from_embedding_table(table, meta_by_split: Dict[str, GroupTable],
                                text_class, text_spurious, text_group,
                                device: DeviceLike = None) -> DataBundle:
    """Align an EmbeddingTable against per-split metadata (with the
    consistency assert) and upload the embedding blocks to ``device``
    (``cuda`` unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    splits = {}
    for name, meta in meta_by_split.items():
        sub = table.align_to(meta)
        splits[name] = SplitArrays(
            emb=upload(sub.embeddings.astype(np.float32), dev),
            y=sub.y.astype(np.int32),
            place=sub.place.astype(np.int32),
            group=sub.group.astype(np.int32),
            y_pred=sub.y_pred.astype(np.int32),
        )
    train_meta = meta_by_split["train"]
    return DataBundle(
        train=splits["train"],
        val=splits["val"],
        test=splits["test"],
        text_class=np.asarray(text_class, np.float32),
        text_spurious=np.asarray(text_spurious, np.float32),
        text_group=np.asarray(text_group, np.float32),
        train_group_ratio=train_meta.group_ratio,
        n_groups=train_meta.n_groups,
        n_places=train_meta.n_places,
    )


def bundle_from_files(
    dataset: str,
    data_dir: str,
    image_embedding_path: str,
    text_embedding_path: str,
    text_spurious_embedding_path: str,
    text_group_embedding_path: str,
    device: DeviceLike = None,
) -> DataBundle:
    """Build the training bundle from on-disk caches (the reference's file-
    mediated Stage A -> Stage B boundary: final_main.py:816-854 loaders +
    get_text_embedding :414-424)."""
    from debiasing_multi_modal_tpu_torch.data.embeddings_store import (
        load_embeddings,
        load_text_embeddings,
    )
    from debiasing_multi_modal_tpu_torch.data.groups import load_metadata

    table = load_embeddings(image_embedding_path, dataset=dataset)
    meta_by_split = {
        split: load_metadata(dataset, data_dir, split)
        for split in ("train", "val", "test")
    }
    # load_text_embeddings returns [D, C] — the bundle's text-matrix layout
    return bundle_from_embedding_table(
        table, meta_by_split,
        load_text_embeddings(text_embedding_path),
        load_text_embeddings(text_spurious_embedding_path),
        load_text_embeddings(text_group_embedding_path),
        device=device,
    )


def shard_bundle(bundle: DataBundle, mesh, axis: str = "data") -> DataBundle:
    """The bundle with each split's embedding rows sharded over the mesh's
    ``axis``: this rank keeps its contiguous block, zero-padded to the axis
    size (pad rows are never read: the batch plans index by the label
    arrays' length, which stays the split's).  Pass the result to
    ``train_all_epochs``, whose epochs then run data-parallel."""
    group = axis_group(mesh, axis)

    def place(split: SplitArrays) -> SplitArrays:
        shard = RowShard.of(len(split), group)
        return dataclasses.replace(split, emb=shard.take(split.full_emb()), shard=shard)

    return dataclasses.replace(bundle, train=place(bundle.train), val=place(bundle.val),
                               test=place(bundle.test))


def gather_bundle(bundle: DataBundle) -> DataBundle:
    """The bundle with every split's rows whole on each rank (itself if it
    is not sharded)."""
    if bundle.train.shard is None:
        return bundle

    def whole(split: SplitArrays) -> SplitArrays:
        return dataclasses.replace(split, emb=split.full_emb(), shard=None)

    return dataclasses.replace(bundle, train=whole(bundle.train), val=whole(bundle.val),
                               test=whole(bundle.test))


def move_bundle(bundle: DataBundle, device: torch.device) -> DataBundle:
    """The bundle with its embeddings on ``device`` (itself if they are)."""
    if on_device(bundle.train.emb, device):
        return bundle
    return dataclasses.replace(bundle, train=bundle.train.to(device),
                               val=bundle.val.to(device), test=bundle.test.to(device))


# ----------------------------------------------------------------- helpers --


def _host_counts(*stats: EpochStats) -> np.ndarray:
    """[len(stats), 2, n_groups] corrects and counts, in one device read."""
    return torch.stack([torch.stack([s.corrects, s.counts]) for s in stats]).cpu().numpy()


def _results(counts: np.ndarray, bundle: DataBundle, weighted: bool) -> Dict[str, float]:
    return results_from_counts(
        counts[0], counts[1], n_places=bundle.n_places,
        train_group_ratio=bundle.train_group_ratio if weighted else None,
    )


def _evaluate(
    module,
    split: SplitArrays,
    labels: np.ndarray,
    text: np.ndarray,
    batch_size: int,
    bundle: DataBundle,
    stage: DeviceCache,
    plan_cache: Optional[dict] = None,
) -> EpochStats:
    """The split's meters on the device; ``stage``/``plan_cache`` keep the
    labels, text matrices and eval plans resident across epochs."""
    dev = split.emb.device
    idx, mask = cached_eval_plan(plan_cache, split, batch_size, lambda a: upload(a, dev))
    return eval_epoch(module, split.emb, stage(labels), stage(split.group), idx, mask,
                      stage(text), n_groups=bundle.n_groups, shard=split.shard)


def zero_shot_results(bundle: DataBundle, target: str,
                      zs_temperature: float) -> Dict[str, float]:
    """Raw-embedding zero-shot group accuracies on the test split — the pure
    CLIP baseline the reference's linear_probing branch probes
    (final_main.py:757)."""
    text = bundle.text_class if target == "class" else bundle.text_spurious
    test = bundle.test
    emb, rows = test.emb, slice(None)
    if test.shard is not None:  # this rank's rows; the counts summed over ranks
        lo = test.shard.lo
        rows = slice(lo, max(lo, min(lo + test.shard.local, len(test))))
        emb = emb[:rows.stop - rows.start]
    with torch.no_grad(), full_f32():
        logits = zero_shot_logits(emb, upload(text, emb.device), zs_temperature)
    correct = logits.argmax(1).cpu().numpy() == test.labels(target)[rows]
    group = test.group[rows]
    counts = np.stack([np.bincount(group, weights=correct, minlength=bundle.n_groups),
                       np.bincount(group, minlength=bundle.n_groups)])
    if test.shard is not None:
        summed = torch.from_numpy(counts).to(test.emb.device)
        dist.all_reduce(summed, group=test.shard.group)
        counts = summed.cpu().numpy()
    return results_from_counts(counts[0], counts[1], bundle.n_places, bundle.train_group_ratio)


def make_classifier(cfg: TrainConfig, generator: Optional[torch.Generator] = None):
    """The phase-1 classifier, its weights drawn from ``generator``."""
    if cfg.tl_method == "linear_probing":
        return LinearClassifier(cfg.input_dim, cfg.n_cls, generator=generator)
    return AdapterClassifier(cfg.input_dim, cfg.adapter_feat_dim, cfg.zs_temperature,
                             generator=generator)


def make_multiple_classifier(cfg: TrainConfig, generator: Optional[torch.Generator] = None):
    return MultipleAdapterClassifier(cfg.input_dim, cfg.adapter_feat_dim,
                                     cfg.zs_temperature, generator=generator)


def make_encoder(cfg: TrainConfig, adapter, generator: Optional[torch.Generator] = None):
    """The contrastive loss path's encoder around the classifier's own
    ``adapter``; the generator draws its head, if ``cfg.ca_head`` asks for
    one."""
    return CAEncoder(cfg.input_dim, cfg.adapter_feat_dim, cfg.ca_head, cfg.ca_feat_dim,
                     generator=generator, adapter=adapter)


def contrastive_rows_and_counts(cfg: TrainConfig, bundle: "DataBundle", rngs, log=None):
    """One anchor-row matrix per numpy generator, from the train split's
    zero-shot slices, and the ``(num_anchor, num_positive, num_negative)``
    counts clamped to the pools (the reference's ``adjust_num_pos_neg_``,
    SupCon.ipynb cell 10:58, instead of sampling with replacement)."""
    points = prepare_contrastive_points(bundle.train.y, bundle.train.y_pred)
    asked = (cfg.num_anchor, cfg.num_positive, cfg.num_negative)
    counts = clamp_counts(points, *asked)
    if log is not None and counts != asked:
        log(f"contrastive counts clamped to pools: {counts}")
    return [construct_contrastive_rows(points, *counts, rng) for rng in rngs], counts


def contrastive_epoch_rows(rows: np.ndarray, rng: np.random.Generator,
                           batch_factor: int) -> np.ndarray:
    """One epoch's ``[nb, batch_factor, A+P+N]`` steps: the rows permuted,
    tiled cyclically when there are fewer than one step consumes (the
    reference's DataLoader would emit one short batch; steps have fixed
    shapes), the remainder dropped."""
    rows = rows[rng.permutation(len(rows))]
    if len(rows) < batch_factor:
        rows = np.resize(rows, (batch_factor, rows.shape[1]))
    nb = max(len(rows) // batch_factor, 1)
    return rows[: nb * batch_factor].reshape(nb, batch_factor, -1)


def _tensors(sd: Mapping[str, object], prefix: str = "") -> Dict[str, torch.Tensor]:
    """A reference-layout dict of arrays or tensors as tensors, the keys
    under ``prefix`` with the prefix stripped."""
    return {k[len(prefix):]: torch.from_numpy(np.array(v))
            for k, v in sd.items() if k.startswith(prefix)}


def _snapshot(module) -> Dict[str, torch.Tensor]:
    """A copy of the module's parameters and buffers on its device."""
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _state_payload(state: TrainState) -> dict:
    return {"params": state.params, "batch_stats": state.batch_stats, "trace": state.trace}


def _load_state(state: TrainState, tree: dict) -> TrainState:
    state.module.load_state_dict({**tree["params"], **tree["batch_stats"]})
    dev = next(state.module.parameters()).device
    return TrainState(state.module, {k: v.to(dev) for k, v in tree["trace"].items()})


# -------------------------------------------------------------- entry point --


def train_all_epochs(
    cfg: TrainConfig,
    bundle: DataBundle,
    verbose: bool = True,
    results_dir: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    checkpoint_every: int = 10,
    checkpoint_keep: int = 2,
    init: Optional[Mapping[str, Mapping]] = None,
    device: DeviceLike = None,
):
    """Run the full schedule on ``device`` (``cuda`` unless the caller asks
    for the CPU; the bundle moves there if it lives elsewhere); returns
    ``((best_train, best_val, best_test), (zs_class, zs_spurious),
    history)`` — the reference's return tuple (final_main.py:1128) plus the
    epoch history.

    ``utils/seed.set_seed(random_seed)`` gives the numpy generator the plans
    draw from and a CPU ``torch.Generator``.  Initial weights are drawn from
    the latter (the phase-1 classifier first, then the contrastive head,
    the multiple classifier at the stage switch), unless ``init`` gives
    them in the reference's state-dict layout: ``init["init_sd"]`` for the
    phase-1 classifier, ``init["ca_head_sd"]`` (``head.*`` keys) for the
    contrastive head and ``init["ma_new_sd"]`` (``new_adapter.*`` keys) for
    the new adapter at the stage switch (the JAX package's ``capture``
    records the first and the last).
    ``checkpoint_keep`` is how many complete checkpoints stay on disk.
    """
    dev = resolve_device(device)
    bundle = move_bundle(bundle, dev)
    init = init or {}
    rng, gen = set_seed(cfg.random_seed)
    # under shard_bundle every rank trains; rank 0 writes and prints
    writer = bundle.train.shard is None or dist.get_rank() == 0

    def log(*a):
        if verbose and writer:
            print(*a)

    # ----- data: reg/val split for the regularized methods
    if cfg.is_reg_method:
        reg_idx, val_idx = stratified_split_indices(bundle.val.group, 0.5, seed=42)
        reg_split = bundle.val.take(reg_idx)
        val_split = bundle.val.take(val_idx)
    else:
        reg_split, val_split = None, bundle.val

    eval_bs = cfg.batch_size_reg if cfg.is_reg_method else cfg.batch_size

    # ----- resampled train order weights (phase 1)
    sample_weights = None
    if cfg.resample_ce:
        sample_weights = resampled_ce_weights(
            bundle.train.y, bundle.train.y_pred, n_classes=cfg.n_cls,
            correct_class_bias=True, reweighting_by_class=False,
        )
        log("Using [Resampled] Train loader for feature learning")

    # ----- model/optimizer
    single = make_classifier(cfg, gen)
    if "init_sd" in init:
        single.load_state_dict(_tensors(init["init_sd"]))
    state = init_train_state(single.to(dev))
    full_mask = ones_mask(state.params)

    # the contrastive encoder wraps the classifier's adapter; its head's
    # parameters and momentum (notebook ca_head='linear', SupCon.ipynb cell
    # 3:13) live apart from the classifier's, and the CE/eval path never
    # sees them
    encoder = head_trace = None
    if cfg.tl_method == "contrastive_adapter":
        encoder = make_encoder(cfg, single.adapter, gen).to(dev)
        head_trace = {}
        if encoder.head is not None:
            if "ca_head_sd" in init:
                encoder.head.load_state_dict(_tensors(init["ca_head_sd"], "head."))
            head_trace = {f"head.{k}": torch.zeros_like(v)
                          for k, v in encoder.head.named_parameters()}

    multiple = None
    ma_state: Optional[TrainState] = None
    ma_mask = None

    train_labels = bundle.train.labels(cfg.train_target)
    if int(train_labels.max()) >= bundle.text_class.shape[1]:
        raise ValueError(
            f"train_target={cfg.train_target!r} yields labels up to "
            f"{int(train_labels.max())} but the class text matrix has only "
            f"{bundle.text_class.shape[1]} columns — a gather on the card "
            "would fault instead of erroring (the torch reference crashes in "
            "CrossEntropyLoss); use 'class' or 'spurious'"
        )
    val_labels = val_split.labels(cfg.train_target)
    test_labels_cls = bundle.test.labels("class")
    reg_labels_target = reg_split.labels(cfg.train_target) if reg_split is not None else None
    reg_labels_group = reg_split.group.astype(np.int32) if reg_split is not None else None
    if (
        reg_labels_group is not None
        and int(reg_labels_group.max()) >= bundle.text_group.shape[1]
    ):
        # same guard for the group-prompt reg passes: group labels gather
        # into text_group's columns
        raise ValueError(
            f"group labels reach {int(reg_labels_group.max())} but the group "
            f"text matrix has only {bundle.text_group.shape[1]} columns"
        )

    text_class = bundle.text_class
    text_group = bundle.text_group

    best = {"acc": 0.0, "epoch": 0, "sd": None, "multiple": False}
    history = {"train": [], "val": [], "test": []}

    # Contrastive rows are built BEFORE any checkpoint restore: in a fresh
    # run they are the first rng consumption, and a resumed run must train
    # on the ORIGINAL rows (the restored rng state already accounts for
    # these draws).
    contrastive_rows = train_full = None
    if cfg.tl_method == "contrastive_adapter":
        (contrastive_rows,), ca_counts = contrastive_rows_and_counts(cfg, bundle, [rng], log)
        log(f"contrastive rows: {contrastive_rows.shape}")

    start_epoch = 1

    # ----- resume from the latest checkpoint
    if resume and checkpoint_dir:
        from debiasing_multi_modal_tpu_torch.train import checkpoint as ckpt

        step_dir = ckpt.latest_checkpoint(checkpoint_dir)
        if step_dir:
            saved_epoch, tree, meta = ckpt.load_checkpoint(step_dir)
            log(f"Resuming from {step_dir} (epoch {saved_epoch})")
            state = _load_state(state, tree["state"])
            if "ma_state" in tree:
                # weights come from the checkpoint: a throwaway generator
                multiple = make_multiple_classifier(cfg, torch.Generator()).to(dev)
                ma_state = _load_state(init_train_state(multiple), tree["ma_state"])
                ma_mask = freeze_subtrees(ma_state.params, ("old_cls",))
            if "head_state" in tree:
                encoder.head.load_state_dict(_tensors(tree["head_state"]["params"], "head."))
                head_trace = {k: v.to(dev) for k, v in tree["head_state"]["trace"].items()}
            if "best_state" in tree:
                best["sd"] = {k: v.to(dev) for k, v in tree["best_state"].items()}
            best["acc"] = meta["best_acc"]
            best["epoch"] = meta["best_epoch"]
            best["multiple"] = meta["best_multiple"]
            history = meta["history"]
            rng = ckpt.restore_rng(meta["rng_state"])
            gen.set_state(tree["torch_rng_state"])
            start_epoch = saved_epoch + 1

    def current_module_and_state(epoch):
        if cfg.uses_multiple(epoch):
            return multiple, ma_state
        return single, state

    # stage recurring host constants once
    stage = DeviceCache(dev)
    plan_cache: dict = {}

    def run_train(sub_state, split, labels, text, bs, lrs_phase, epoch, order, mask_tree):
        plan = epoch_plan(len(split), bs, shuffle=order is None, rng=rng, order=order)
        lrs = epoch_batch_lrs(cfg, epoch, plan.num_batches, lrs_phase)
        return train_epoch(
            sub_state, split.emb, stage(labels), stage(split.group),
            upload(plan.indices, dev), upload(plan.mask, dev), lrs, stage(text),
            mask_tree, n_groups=bundle.n_groups, momentum=cfg.momentum,
            weight_decay=cfg.weight_decay, shard=split.shard,
        )

    for epoch in range(start_epoch, cfg.epochs + 1):
        log(f"--- Epoch {epoch} ---")

        # per-epoch balanced reg subset (an index order into the full reg
        # split — no data movement)
        if cfg.balance_val and cfg.is_reg_method:
            reg_order = balanced_subset_indices(reg_split.group, rng, bundle.n_groups)
            reg_bs = min(cfg.batch_size_reg, len(reg_order))
        elif reg_split is not None:
            reg_order = None  # shuffle the whole reg split
            reg_bs = cfg.batch_size_reg

        # ---------------- train one epoch
        train_weighted = False
        kind = cfg.epoch_kind(epoch)
        if kind == "reg":
            # interleaved: train loader (class prompts) then reg loader
            state, stats = run_train(
                state, bundle.train, train_labels, text_class,
                cfg.batch_size, 1, epoch, None, full_mask,
            )
            group_prompt = not cfg.use_cls_prompt_in_reg
            state, reg_stats = run_train(
                state, reg_split,
                reg_labels_group if group_prompt else reg_labels_target,
                text_group if group_prompt else text_class,
                reg_bs, 1, epoch, reg_order, full_mask,
            )
            if not group_prompt:
                stats = stats.merge(reg_stats)
        elif kind == "phase2":
            # ---------------- stage switch
            if epoch == cfg.feature_epochs + 1:
                if cfg.continue_from_best and best["sd"] is not None:
                    log("Load Best (Worst-acc) Model.")
                    single.load_state_dict(best["sd"])
                    state = init_train_state(single)
                if cfg.add_adapter:
                    log("Stage 2) New adapter for balanced text prompts")
                    multiple = make_multiple_classifier(cfg, gen).to(dev)
                    if "ma_new_sd" in init and not cfg.init_near_identity:
                        multiple.new_adapter.load_state_dict(
                            _tensors(init["ma_new_sd"], "new_adapter."))
                    old = single.adapter.state_dict()
                    multiple.old_cls.adapter.load_state_dict(old)
                    if cfg.init_near_identity:
                        log("Initialize [New adapter] from [Old adapter]")
                        multiple.new_adapter.load_state_dict(old)
                    ma_state = init_train_state(multiple)
                    ma_mask = freeze_subtrees(ma_state.params, ("old_cls",))
                else:
                    # fresh optimizer on the same params (momentum reset)
                    state = reset_optimizer(state)

            use_group = cfg.use_group_prompt(epoch)
            labels2 = reg_labels_group if use_group else reg_labels_target
            text2 = text_group if use_group else text_class
            if cfg.add_adapter:
                ma_state, stats = run_train(
                    ma_state, reg_split, labels2, text2, reg_bs, 2, epoch, reg_order, ma_mask,
                )
            else:
                state, stats = run_train(
                    state, reg_split, labels2, text2, reg_bs, 2, epoch, reg_order, full_mask,
                )
        elif kind == "contrastive":
            # Supervised-contrastive feature learning on the adapter (the
            # reference's notebook-driven CA trainer, visualizer_supcon.py
            # train_one_epoch_cl).  The rows are reshuffled every epoch.  The
            # working reference flow (SupCon.ipynb cell 7) follows each
            # SupCon epoch with a CE epoch: see cfg.ca_ce_update.
            rows = contrastive_epoch_rows(contrastive_rows, rng, cfg.batch_factor)
            enc_state = TrainState(encoder, {**{k: v for k, v in state.trace.items()
                                                if k.startswith("adapter.")}, **head_trace})
            if train_full is None:  # the SupCon steps read rows of every rank
                train_full = bundle.train.full_emb()
            _, cl_losses = train_contrastive_epoch(
                enc_state, train_full, upload(rows, dev),
                epoch_batch_lrs(cfg, epoch, len(rows), 1), ones_mask(enc_state.params),
                num_anchor=ca_counts[0], num_positive=ca_counts[1], num_negative=ca_counts[2],
                temperature=cfg.cl_temperature, contrastive_weight=cfg.contrastive_weight,
                ca_pre_norm=cfg.ca_pre_norm, momentum=cfg.momentum,
                weight_decay=cfg.weight_decay,
            )
            history.setdefault("cl_loss", []).append(float(np.mean(cl_losses.cpu().numpy())))
            log(f"contrastive loss: {history['cl_loss'][-1]:.4f}")
            if cfg.ca_ce_update != 0:
                # the interleaved CE pass on the same parameters and momentum
                # (-1 a whole epoch, > 0 capped at that many batches, as
                # visualizer_supcon.py:354 intends)
                ce_order = None
                if cfg.ca_ce_update > 0:
                    ce_order = rng.permutation(len(bundle.train))[
                        : cfg.ca_ce_update * cfg.batch_size]
                state, stats = run_train(
                    state, bundle.train, train_labels, text_class,
                    cfg.batch_size, 1, epoch, ce_order, full_mask,
                )
            else:
                # pure SupCon: the train metrics come from the zero-shot head
                # on the train split, weighted as the evaluation's are
                stats = _evaluate(single, bundle.train, train_labels, text_class,
                                  cfg.batch_size, bundle, stage, plan_cache)
                train_weighted = True
        else:
            # plain ERM epoch (linear_probing / adapter / phase 1)
            order = None
            if sample_weights is not None:
                order = weighted_sample_indices(sample_weights, len(bundle.train), rng)
            state, stats = run_train(
                state, bundle.train, train_labels, text_class,
                cfg.batch_size, 1, epoch, order, full_mask,
            )

        # ---------------- evaluate, then read the epoch's meters once
        module, cur = current_module_and_state(epoch)
        val_stats = _evaluate(module, val_split, val_labels, text_class, eval_bs, bundle,
                              stage, plan_cache)
        test_stats = _evaluate(module, bundle.test, test_labels_cls, text_class, eval_bs,
                               bundle, stage, plan_cache)
        counts = _host_counts(stats, val_stats, test_stats)
        train_res = _results(counts[0], bundle, weighted=train_weighted)
        val_res = _results(counts[1], bundle, weighted=True)
        test_res = _results(counts[2], bundle, weighted=True)
        history["train"].append(ordered(train_res))
        history["val"].append(ordered(val_res))
        history["test"].append(ordered(test_res))
        log("Train:", ordered(train_res))
        log("Val:", ordered(val_res))
        log("Test:", ordered(test_res))

        if val_res["worst_acc"] > best["acc"]:
            best.update(acc=val_res["worst_acc"], epoch=epoch, sd=_snapshot(cur.module),
                        multiple=module is multiple)

        if checkpoint_dir and writer and (
            # checkpoint_every <= 0 means final-epoch-only checkpoints
            (checkpoint_every > 0 and epoch % checkpoint_every == 0)
            or epoch == cfg.epochs
        ):
            from debiasing_multi_modal_tpu_torch.train import checkpoint as ckpt

            payload = {"state": _state_payload(state), "torch_rng_state": gen.get_state()}
            if ma_state is not None:
                payload["ma_state"] = _state_payload(ma_state)
            if head_trace:
                payload["head_state"] = {
                    "params": {k: v for k, v in encoder.state_dict().items()
                               if k.startswith("head.")},
                    "trace": head_trace,
                }
            if best["sd"] is not None:
                payload["best_state"] = best["sd"]
            ckpt.save_checkpoint(
                checkpoint_dir,
                epoch,
                payload,
                rng,
                meta_extra={
                    "best_acc": float(best["acc"]),
                    "best_epoch": int(best["epoch"]),
                    "best_multiple": bool(best["multiple"]),
                    "history": history,
                },
                keep=checkpoint_keep,
            )

    if best["sd"] is None:  # degenerate run — keep the final model
        module, cur = current_module_and_state(cfg.epochs)
        best.update(epoch=cfg.epochs, sd=_snapshot(cur.module), multiple=module is multiple)

    best_epoch = best["epoch"] if best["epoch"] > 0 else cfg.epochs
    best_train = history["train"][best_epoch - 1]
    best_val = history["val"][best_epoch - 1]
    best_test = history["test"][best_epoch - 1]
    log(f"best epoch : {best_epoch}")

    # ---------------- zero-shot feature-quality probes on the best model
    best_module = multiple if best["multiple"] else single
    best_module.load_state_dict(best["sd"])

    def zs_eval(target: str) -> Dict[str, float]:
        if cfg.tl_method == "linear_probing":
            return zero_shot_results(bundle, target, cfg.zs_temperature)
        text = bundle.text_class if target == "class" else bundle.text_spurious
        stats = _evaluate(best_module, bundle.test, bundle.test.labels(target), text,
                          eval_bs, bundle, stage, plan_cache)
        return _results(_host_counts(stats)[0], bundle, weighted=True)

    zs_class = zs_eval("class")
    zs_spurious = zs_eval("spurious")
    log("zero-shot (test, class):", ordered(zs_class))
    log("zero-shot (test, spurious):", ordered(zs_spurious))

    if cfg.save_results and results_dir and writer:
        os.makedirs(results_dir, exist_ok=True)
        name = encode_run_name(cfg)
        payload = {
            "Final Results (best epoch)": {
                f"Epoch {best_epoch}": {
                    "Train": best_train, "Val": best_val, "Test": best_test,
                }
            },
            "Feature Quality (using zs)": {
                "class": ordered(zs_class),
                "spurious": ordered(zs_spurious),
            },
            "All Results (all epoch)": {
                f"Epoch {e + 1}": {
                    "Train": history["train"][e],
                    "Val": history["val"][e],
                    "Test": history["test"][e],
                }
                for e in range(cfg.epochs)
            },
        }
        with open(os.path.join(results_dir, name + ".json"), "w") as f:
            json.dump(payload, f, indent=4)
        # the best model in the reference's state-dict layout (where the JAX
        # package writes an Orbax tree)
        torch.save({k: v.cpu() for k, v in best["sd"].items()},
                   os.path.join(results_dir, name + ".pt"))

    return (best_train, best_val, best_test), (ordered(zs_class), ordered(zs_spurious)), history


def encode_run_name(cfg: TrainConfig) -> str:
    """Encoded experiment filename (reference final_main.py:1070-1096)."""
    name = (
        f"im_clip_t_clip_class_tl_{cfg.tl_method}_t_{cfg.train_target}"
        f"_lr_{cfg.learning_rate}_bs_{cfg.batch_size}"
    )
    if "reg" in cfg.tl_method:
        name += f"_lrr{cfg.learning_rate_reg}_bsr_{cfg.batch_size_reg}"
        if cfg.balance_val:
            name += "_balval"
        if cfg.tl_method != "adapter_reg_seq_alter":
            name += "_CP" if cfg.use_cls_prompt_in_reg else "_GP"
        if cfg.add_adapter:
            name += "_MA" + ("+ni" if cfg.init_near_identity else "+rn")
        if cfg.continue_from_best and "seq" in cfg.tl_method:
            name += "_cont"
    if cfg.resample_ce:
        name += "_rs"
    return name
