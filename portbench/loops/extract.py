"""Closed-loop Stage-A extraction through
``debiasing_multi_modal_tpu_torch.extract.runner.ExtractionRunner.run``.

Set-up builds the port's CLIP from the configuration's widths on the meta
device and loads the seeded weights into it, encodes the three prompt sets
with the text tower (the class set is the zero-shot head), makes a pool of
distinct uint8 batches of the traffic's size, and runs ``warmup_batches``
through ``run``.  The window is one ``run`` call over batches cycled from
the pool, at the traffic's prefetch, upload and in-flight depths, until
``--seconds`` have passed: the rate is every image ``run`` returned over the
whole call.  The JPEG decode is not part of the work: the pool holds images
as the host decode leaves them.

Traffic keys: ``batch``, ``height``, ``width``, ``pool_batches``,
``warmup_batches``, ``prefetch_depth``, ``upload_depth``, ``max_in_flight``,
``prompts`` (count per set), ``check_images``, ``trace_batches``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List

import numpy as np

from portbench.checks import extract as checks
from portbench.checks.common import against
from portbench.core import record as rec
from portbench.core.cell import Context, Outcome
from portbench.core.clip_weights import make_state_dict
from portbench.core.inputs import image_pool, prompt_tokens
from portbench.core.profiling import SPAN_PREFIX, profile_stretch

META_KEYS = ("y", "place", "group", "split")


def port_config(cfg: dict):
    import torch
    from debiasing_multi_modal_tpu_torch.models.config import CLIPConfig

    layers = cfg["vision_layers"]
    return CLIPConfig(
        name=cfg["port_config"], embed_dim=cfg["embed_dim"],
        image_resolution=cfg["image_resolution"],
        vision_layers=tuple(layers) if isinstance(layers, list) else layers,
        vision_width=cfg["vision_width"], vision_patch_size=cfg["vision_patch_size"],
        context_length=cfg["context_length"], vocab_size=cfg["vocab_size"],
        transformer_width=cfg["transformer_width"], transformer_heads=cfg["transformer_heads"],
        transformer_layers=cfg["transformer_layers"],
        dtype=getattr(torch, cfg["compute_dtype"]))


def build_model(cfg: dict, seed: int, device):
    """The port's CLIP with the seeded weights, frozen, in eval mode."""
    import torch
    from debiasing_multi_modal_tpu_torch.models.clip import CLIP

    with torch.device("meta"):
        model = CLIP(port_config(cfg))
    model.load_state_dict(make_state_dict(cfg, seed, device), strict=True, assign=True)
    return model.eval().requires_grad_(False)


def _metas(pool_batches: int, batch: int) -> List[Dict[str, np.ndarray]]:
    zeros = np.zeros(batch, np.int32)
    return [{"filenames": np.asarray([f"pool{b}_{i}.jpg" for i in range(batch)]),
             **{k: zeros for k in META_KEYS}} for b in range(pool_batches)]


class Feed:
    """Batches cycled from the pool, until a count or a deadline; remembers
    which pool batch each one was."""

    def __init__(self, pool: np.ndarray, metas):
        self.pool, self.metas = pool, metas
        self.sent: List[int] = []

    def batches(self, count: int = None, deadline: float = None) -> Iterator:
        i = 0
        while (count is None or i < count) and (deadline is None or time.perf_counter() < deadline):
            b = len(self.sent) % len(self.pool)
            self.sent.append(b)
            yield self.pool[b], self.metas[b]
            i += 1


@contextlib.contextmanager
def _faults(runner, faults):
    """Plant the named faults under the timed path (tests only)."""
    if not faults:
        yield
        return
    step = runner._step

    def broken(images):
        emb, preds = step(images)
        if "half_batch" in faults:
            half = emb.shape[0] // 2
            emb = emb.clone()
            emb[half:] = emb[:half].mean(0, keepdim=True)
        if "answer_altered" in faults:
            preds = 1 - preds
        return emb, preds

    with rec._shadow(runner, "_step", broken):
        yield


@contextlib.contextmanager
def _annotated(obj, attr: str, name: str):
    """Every call of ``obj.attr`` inside a profiler span ``name``."""
    from torch.profiler import record_function

    original = getattr(obj, attr)

    def wrapper(*args, **kwargs):
        with record_function(SPAN_PREFIX + name):
            return original(*args, **kwargs)

    with rec._shadow(obj, attr, wrapper):
        yield


def run(ctx: Context) -> Outcome:
    import torch
    from debiasing_multi_modal_tpu_torch.extract.runner import ExtractionRunner

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    model = build_model(cfg, ctx.seed, dev)
    tokens = prompt_tokens(ctx.seed, tr["prompts"], cfg["context_length"], cfg["vocab_size"],
                           device=dev)
    with torch.inference_mode():
        text = {k: model.encode_text(torch.from_numpy(ids).to(dev)).float().cpu().numpy()
                for k, ids in tokens.items()}
    runner = ExtractionRunner(model, text["class"])
    pool = image_pool(ctx.seed, tr["pool_batches"], tr["batch"], tr["height"], tr["width"], dev)
    feed = Feed(pool, _metas(tr["pool_batches"], tr["batch"]))
    kw = {k: tr[k] for k in ("prefetch_depth", "upload_depth", "max_in_flight")}

    with _faults(runner, ctx.faults):
        runner.run(feed.batches(count=tr["warmup_batches"]), **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        warm = len(feed.sent)
        spans = contextlib.ExitStack()
        if ctx.record is not None:
            spans.enter_context(rec.timed_method(ctx.record, runner, "encode_batch_async",
                                                 "enqueue"))
            spans.enter_context(rec.device_span(ctx.record, model.visual, "image_tower"))
        with spans:
            t0 = time.perf_counter()
            table = runner.run(feed.batches(deadline=t0 + ctx.seconds), **kw)
            t1 = time.perf_counter()
        sent = feed.sent[warm:]
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        attempted = len(sent) * tr["batch"]
        done = len(table.y)
        rate = done / (t1 - t0)
        if ctx.record is not None:
            _trace(ctx, runner, feed, kw, rate)
    out_pool_index = (np.repeat(np.asarray(sent, np.int64), tr["batch"]) * tr["batch"]
                      + np.tile(np.arange(tr["batch"]), len(sent)))[:done]
    emb, pred = table.embeddings, table.y_pred
    del runner, model, table
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    found = checks.judge(cfg, ctx.seed, tr["check_images"], emb, pred, out_pool_index, pool,
                         text, tokens, dev)
    return Outcome(attempted=attempted, failed=attempted - done,
                   end_to_end={"setup_s": t0 - ctx.t_start, "extract_imgs_per_s": rate},
                   checks=against(ctx.limits, found), memory_peak_bytes=peak,
                   notes={"window_s": t1 - t0, "images": done, "readings": found,
                          "check_s": time.perf_counter() - t_check})


def _trace(ctx: Context, runner, feed: Feed, kw: dict, rate: float) -> None:
    """After the window: a profiled stretch of ``trace_batches`` through the
    same ``run``, and what the readers need to know of the cell."""
    from portbench.counts.flops import image_flops

    tr, cfg, record = ctx.traffic, ctx.config, ctx.record
    with _annotated(runner, "encode_batch_async", "enqueue"), \
            _annotated(runner, "upload_batch", "upload"):
        _, prof = profile_stretch(lambda: runner.run(feed.batches(count=tr["trace_batches"]),
                                                     **kw))
    record.profile = prof
    record.notes.update(
        imgs_per_s=rate, batch=tr["batch"], stretch_batches=tr["trace_batches"],
        image_flops=image_flops(cfg, tr["prompts"]["class"]), dtype=cfg["compute_dtype"],
        # the image tower's launches of kernel 1: one per block, at these shapes
        attention=None if not cfg["vision_patch_size"] else {
            "b": tr["batch"], "s": (cfg["image_resolution"] // cfg["vision_patch_size"]) ** 2 + 1,
            "d": cfg["vision_width"], "h": cfg["vision_heads"], "causal": False,
            "per_batch": cfg["vision_layers"]})
