"""Stage A: batched embedding extraction + zero-shot prediction (port of
``extract/runner.py``).

Reference ``clip_inference.py`` ``main`` (:29-271):

- text: encode every templated class / spurious / group prompt, average over
  the template set per phrase, store UN-normalized (:55-84);
- images: encode image batches and compute zero-shot logits — the
  normalized image embedding against the UN-normalized class weights (the
  reference normalizes only the image side, :131-137) at temperature 0.02 —
  then argmax predictions and the per-image record table (:159-271).

One device: each batch is uploaded (pinned host memory, an asynchronous copy
on a side stream of its own, so the transfer overlaps the kernels of the
batch before it), preprocessed on the device, encoded in the model's compute
dtype, and run through the f32 zero-shot head.  A background thread decodes
and uploads the next batches while the device runs the current one; a step
never waits for the card on the host.  Mesh, data-parallel and
tensor-parallel extraction are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Iterable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from debiasing_multi_modal_tpu_torch.data.embeddings_store import EmbeddingTable
from debiasing_multi_modal_tpu_torch.data.prefetch import prefetch
from debiasing_multi_modal_tpu_torch.models.clip import CLIP, l2_normalize
from debiasing_multi_modal_tpu_torch.ops.preprocess import normalize_only, preprocess_uint8
from debiasing_multi_modal_tpu_torch.tokenizer import tokenize

ZS_TEMPERATURE = 0.02  # clip_inference.py:124


class UploadedBatch(NamedTuple):
    """A batch already staged on the device, plus its row count and, for a
    copy on the upload stream, the event recorded after it."""

    images: torch.Tensor
    rows: int
    ready: Optional[torch.cuda.Event] = None


def _model_device(model: CLIP) -> torch.device:
    return model.logit_scale.device


@torch.inference_mode()
def encode_text_prompts(
    model: CLIP,
    prompt_sets: Dict[str, Sequence[str]],
    templates_per_phrase: int = 1,
) -> Dict[str, np.ndarray]:
    """Encode prompt sets -> {kind: [C, D] un-normalized float32}.

    Multiple templates per phrase are mean-pooled (the reference averages the
    per-template embeddings before storing, clip_inference.py:63-65).
    """
    out = {}
    device = _model_device(model)
    for kind, prompts in prompt_sets.items():
        tokens = torch.from_numpy(tokenize(list(prompts))).to(device)
        emb = model.encode_text(tokens).float().cpu().numpy()
        if templates_per_phrase > 1:
            emb = emb.reshape(-1, templates_per_phrase, emb.shape[-1]).mean(axis=1)
        out[kind] = emb
    return out


class ExtractionRunner:
    """Single-device image-embedding extraction on the model's device."""

    def __init__(
        self,
        model: CLIP,
        zeroshot_text: np.ndarray,  # [C, D] un-normalized class text embeddings
        preprocessed: bool = False,
        normalized: bool = False,
    ):
        self.model = model
        self.device = _model_device(model)
        self.preprocessed = preprocessed
        self.normalized = normalized  # --normalized flag: store normalized embeddings
        # [D, C] UN-normalized zero-shot weight matrix (clip_inference.py:77;
        # the reference's text-normalization lines are commented out, :63-65)
        w = np.ascontiguousarray(zeroshot_text.T, np.float32)
        self.zs_weights = torch.from_numpy(w).to(self.device)
        # the stream upload_batch copies on (the card only)
        self._upload_stream = (torch.cuda.Stream(self.device)
                               if self.device.type == "cuda" else None)

    @torch.inference_mode()
    def _step(self, images: torch.Tensor):
        cfg = self.model.config
        if self.preprocessed:
            x = normalize_only(images.float() / 255.0, cfg.dtype)
        else:
            x = preprocess_uint8(images, cfg.image_resolution, dtype=cfg.dtype)
        feats32 = self.model.encode_image(x).float()
        normed = l2_normalize(feats32)
        logits = (normed @ self.zs_weights) / ZS_TEMPERATURE
        preds = logits.argmax(dim=-1).to(torch.int32)
        return (normed if self.normalized else feats32), preds

    def upload_batch(self, images: np.ndarray) -> UploadedBatch:
        """Stage one uint8 batch on the device — the host-to-device half of a
        step, separated so ``run`` can overlap the next batch's upload with
        the current batch's compute.  On the card the copy runs from pinned
        memory on the runner's upload stream, and an event marks its end:
        the step that uses the batch waits on that event on the card, so the
        transfer overlaps whatever the compute stream is running."""
        host = torch.from_numpy(np.ascontiguousarray(images))
        if self.device.type != "cuda":
            return UploadedBatch(host.to(self.device), len(images))
        host = host.pin_memory()
        with torch.cuda.stream(self._upload_stream):
            staged = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._upload_stream)
        return UploadedBatch(staged, len(images), ready)

    def encode_batch_async(self, images):
        """Launch one batch; returns device tensors (no host sync).

        Accepts a host uint8 array (uploaded here) or an
        :class:`UploadedBatch` already staged by :meth:`upload_batch`.
        """
        if not isinstance(images, UploadedBatch):
            images = self.upload_batch(images)
        if images.ready is not None:
            # the compute stream waits for the copy on the card, and the
            # allocator keeps the batch until the compute stream is done
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(images.ready)
            images.images.record_stream(compute)
        emb, preds = self._step(images.images)
        return emb, preds, images.rows

    def encode_batch(self, images: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """uint8 [B, H, W, 3] -> (embeddings [B, D] f32, preds [B] i32)."""
        emb, preds, b = self.encode_batch_async(images)
        return emb.cpu().numpy()[:b], preds.cpu().numpy()[:b]

    def run(
        self,
        batches: Iterable[Tuple[np.ndarray, Dict[str, np.ndarray]]],
        prefetch_depth: int = 2,
        max_in_flight: int = 4,
        shard_dir: Optional[str] = None,
        shard_every: int = 0,
        shard_meta: Optional[Dict] = None,
        upload_depth: int = 2,
    ) -> EmbeddingTable:
        """Drive extraction over an iterator of (uint8 images, metadata cols).

        Metadata cols must include filenames/y/place/group/split.  Host
        decode overlaps device compute via a background prefetch thread
        (depth 0 disables); a second background stage (``upload_depth``, 0
        disables) uploads upcoming batches.  Launches run ``max_in_flight``
        batches ahead of result conversion, bounded so queued inputs and
        retained outputs cannot exhaust device memory on long streams.

        Crash safety: with ``shard_dir`` + ``shard_every=k``, every k
        completed batches are flushed to ``shard_dir/shard_NNNNN.npz`` and
        recorded in ``manifest.json``.  A re-run skips the already-persisted
        rows (validated against the stream's batch boundaries), checks
        ``shard_meta`` against the manifest, and returns
        ``merged_table(shard_dir)`` — the complete result across all runs.
        """
        sharding = bool(shard_dir and shard_every)
        if sharding:
            _check_shard_meta(shard_dir, shard_meta)
            done_rows = completed_rows(shard_dir)
            if done_rows:
                batches = _skip_rows(batches, done_rows)
        if prefetch_depth:
            batches = prefetch(batches, depth=prefetch_depth)
        if upload_depth:
            batches = prefetch(
                ((self.upload_batch(im), meta) for im, meta in batches),
                depth=upload_depth,
            )
        pending = []
        embs, preds = [], []
        cols = {k: [] for k in ("filenames", "y", "place", "group", "split")}
        since_flush = 0

        def drain_one():
            e, p, b = pending.pop(0)
            embs.append(e.cpu().numpy()[:b])  # host sync = backpressure
            preds.append(p.cpu().numpy()[:b])

        def flush_shard():
            nonlocal since_flush, embs, preds
            while pending:
                drain_one()
            if not since_flush or not embs:
                return
            piece = {k: np.concatenate(v) for k, v in cols.items()}
            piece["y_pred"] = np.concatenate(preds)
            piece["embeddings"] = np.concatenate(embs)
            _write_shard(shard_dir, piece, since_flush, shard_meta)
            since_flush = 0
            embs, preds = [], []
            for k in cols:
                cols[k].clear()

        for images, meta in batches:
            pending.append(self.encode_batch_async(images))
            for k in cols:
                cols[k].append(np.asarray(meta[k]))
            since_flush += 1
            if len(pending) > max_in_flight:
                drain_one()
            if sharding and since_flush >= shard_every:
                flush_shard()
        while pending:
            drain_one()
        if sharding:
            flush_shard()
            if _read_manifest(shard_dir)["shards"]:
                return merged_table(shard_dir)
        if not embs:  # empty stream (or resumed past the end with no shards)
            dim = self.model.config.embed_dim
            return EmbeddingTable(
                filenames=np.empty(0, str), y=np.empty(0, np.int32),
                place=np.empty(0, np.int32), group=np.empty(0, np.int32),
                split=np.empty(0, np.int32), y_pred=np.empty(0, np.int32),
                embeddings=np.empty((0, dim), np.float32),
            )
        return EmbeddingTable(
            filenames=np.concatenate(cols["filenames"]),
            y=np.concatenate(cols["y"]).astype(np.int32),
            place=np.concatenate(cols["place"]).astype(np.int32),
            group=np.concatenate(cols["group"]).astype(np.int32),
            split=np.concatenate(cols["split"]).astype(np.int32),
            y_pred=np.concatenate(preds),
            embeddings=np.concatenate(embs),
        )


# --------------------------------------------------- crash-safe sharding --


def _skip_rows(it, rows: int):
    """Skip leading batches totalling exactly ``rows`` rows.  Raises when the
    stream's batch boundaries don't align with the persisted rows — e.g. a
    resume with a different batch size, which would otherwise silently drop
    or duplicate images."""
    seen = 0
    for images, meta in it:
        if seen >= rows:
            yield images, meta
            continue
        seen += len(images)
        if seen > rows:
            raise ValueError(
                f"resume misalignment: shards cover {rows} rows but the "
                f"stream's batch boundary lands at {seen} — re-run with the "
                "original batch size or delete the shard directory"
            )
    if seen < rows:
        # seen == 0 (an empty stream) is the same defect, not an exemption:
        # returning here would silently hand back the full stale table
        raise ValueError(
            f"resume misalignment: shards cover {rows} rows but the stream "
            f"only has {seen} — stale shard directory for this input?"
        )


def _manifest_path(shard_dir: str) -> str:
    import os

    return os.path.join(shard_dir, "manifest.json")


def _check_shard_meta(shard_dir: str, shard_meta: Optional[Dict]):
    """Refuse to resume into shards produced under different settings."""
    import json

    recorded = _read_manifest(shard_dir).get("meta")
    if shard_meta is not None:
        # canonicalize through JSON: the manifest copy went through
        # json.dump (tuples -> lists, int keys -> str), so a JSON-lossy
        # caller meta must be compared in the same representation
        shard_meta = json.loads(json.dumps(shard_meta))
    if recorded is not None and shard_meta is not None and recorded != shard_meta:
        raise ValueError(
            f"shard directory {shard_dir!r} was produced with different "
            f"extraction settings ({recorded} != {shard_meta}); delete it to "
            "re-extract"
        )


def _write_shard(
    shard_dir: str,
    piece: Dict[str, np.ndarray],
    n_batches: int,
    shard_meta: Optional[Dict] = None,
):
    """Atomically write one shard and append it to the manifest (the shard
    lands fully before the manifest references it, so a crash mid-write
    never corrupts the resume state)."""
    import json
    import os

    os.makedirs(shard_dir, exist_ok=True)
    manifest = _read_manifest(shard_dir)
    if shard_meta is not None and "meta" not in manifest:
        manifest["meta"] = shard_meta
    idx = len(manifest["shards"])
    name = f"shard_{idx:05d}.npz"
    tmp = os.path.join(shard_dir, name + ".tmp.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **piece)
    os.replace(tmp, os.path.join(shard_dir, name))
    manifest["shards"].append(
        {"file": name, "batches": int(n_batches), "rows": int(len(piece["y"]))}
    )
    tmp_m = _manifest_path(shard_dir) + ".tmp"
    with open(tmp_m, "w") as f:
        json.dump(manifest, f, indent=2)
    os.replace(tmp_m, _manifest_path(shard_dir))


def _read_manifest(shard_dir: str) -> Dict:
    import json
    import os

    path = _manifest_path(shard_dir)
    if not os.path.exists(path):
        return {"shards": []}
    with open(path) as f:
        return json.load(f)


def completed_batches(shard_dir: str) -> int:
    """Batches already persisted by a previous (possibly crashed) run."""
    return sum(s["batches"] for s in _read_manifest(shard_dir)["shards"])


def completed_rows(shard_dir: str) -> int:
    """Rows already persisted by a previous (possibly crashed) run."""
    return sum(s["rows"] for s in _read_manifest(shard_dir)["shards"])


def merged_table(shard_dir: str) -> EmbeddingTable:
    """Concatenate every manifest shard into one EmbeddingTable."""
    import os

    manifest = _read_manifest(shard_dir)
    if not manifest["shards"]:
        raise ValueError(f"no shards recorded in {shard_dir!r}")
    pieces = []
    for s in manifest["shards"]:
        with np.load(os.path.join(shard_dir, s["file"]), allow_pickle=False) as z:
            pieces.append({k: z[k] for k in z.files})
    return EmbeddingTable(
        filenames=np.concatenate([p["filenames"] for p in pieces]).astype(str),
        y=np.concatenate([p["y"] for p in pieces]).astype(np.int32),
        place=np.concatenate([p["place"] for p in pieces]).astype(np.int32),
        group=np.concatenate([p["group"] for p in pieces]).astype(np.int32),
        split=np.concatenate([p["split"] for p in pieces]).astype(np.int32),
        y_pred=np.concatenate([p["y_pred"] for p in pieces]).astype(np.int32),
        embeddings=np.concatenate([p["embeddings"] for p in pieces]).astype(np.float32),
    )


def minority_report(
    y: np.ndarray, place: np.ndarray, preds: np.ndarray, dataset: str
) -> str:
    """Minor-group prediction quality printout (clip_inference.py:142-153,
    184): waterbirds minority = class/background disagree; celeba minority =
    blond man."""
    if dataset == "waterbirds":
        is_minor_pred = ((y == 0) & (preds == 1)) | ((y == 1) & (preds == 0))
        is_minor = ((y == 0) & (place == 1)) | ((y == 1) & (place == 0))
    elif dataset == "celeba":
        is_minor_pred = (y == 1) & (preds == 1)
        is_minor = (y == 1) & (place == 1)
    else:
        raise ValueError(dataset)
    try:
        from sklearn.metrics import classification_report

        return classification_report(is_minor.astype(int), is_minor_pred.astype(int))
    except ImportError:  # pragma: no cover
        tp = int((is_minor & is_minor_pred).sum())
        fp = int((~is_minor & is_minor_pred).sum())
        fn = int((is_minor & ~is_minor_pred).sum())
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        return f"minority precision={prec:.3f} recall={rec:.3f}"
