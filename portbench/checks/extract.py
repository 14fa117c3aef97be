"""Extraction: the embeddings and predictions ``ExtractionRunner.run``
returned in the window, against the plain f32 reference on a sample of them
drawn from the seed, and the zero-shot text embeddings the runner was given
against the reference's text tower.

Numbers (each against its limit in ``limits/<workload>.json``):

- ``emb_rel_err``: the widest ``|e - e_ref| / |e_ref|`` over the sampled
  images (preprocess and image tower);
- ``text_rel_err``: the widest ``|t - t_ref| / |t_ref|`` over every prompt
  of the three sets (the text tower, whose class embeddings are the head's
  weights);
- ``pred_mismatch``: how many of the window's predictions, all of them, are
  not the argmax of the zero-shot logits of their own embedding against the
  class embeddings the runner was given, computed here in float64; a
  near-tie (a margin under ``TIE`` of the median margin) counts for neither
  side.  Exact: its limit is 0.
- ``ref_pred_mismatch``: how many of the sampled images' predictions are
  not the reference's own argmax (its image embedding against its class text
  embeddings), leaving out each image whose reference margin is within what
  the measured embedding gaps could move: for the runner's class ``p`` and
  the reference's ``a``, ``(|e'/|e'| - e/|e|| * |t_k| + |t'_k - t_k|) / T``
  summed over ``k`` in ``{a, p}``, by Cauchy-Schwarz, plus the near-tie of
  ``pred_mismatch`` for the head's own rounding.  A prediction outside that
  band that differs from the reference is the head's fault, whatever the
  towers did.  Exact: its limit is 0.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.core.clip_weights import make_state_dict
from portbench.reference import clip_f32

BLOCK = 64
TIE = 1e-4  # share of the median margin under which two logits tie


def sample_positions(seed: int, n_out: int, k: int) -> np.ndarray:
    """``k`` distinct output rows drawn from the seed (all when fewer)."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    if n_out <= k:
        return np.arange(n_out)
    return np.sort(rng.choice(n_out, size=k, replace=False))


@torch.no_grad()
def reference_outputs(cfg: dict, seed: int, images: np.ndarray, tokens: Dict[str, np.ndarray],
                      device, mode: str = "f32"):
    """(image embeddings ``[n, E]``, text embeddings by prompt set) of the
    plain reference in ``mode`` ("f32", or "fp8" for the control), from the
    weights the seed gives, in blocks of images."""
    sd = make_state_dict(cfg, seed, device)
    num = clip_f32.Numerics(mode)
    res = cfg["image_resolution"]
    embs = []
    for lo in range(0, len(images), BLOCK):
        x = torch.from_numpy(images[lo:lo + BLOCK]).to(device)
        embs.append(clip_f32.encode_image(clip_f32.preprocess(x, res), sd, cfg, num).float().cpu())
    text = {k: clip_f32.encode_text(torch.from_numpy(v).to(device), sd, cfg, num).float().cpu()
            for k, v in tokens.items()}
    del sd
    return torch.cat(embs).numpy(), {k: v.numpy() for k, v in text.items()}


def readings(emb: np.ndarray, text: Dict[str, np.ndarray], ref_emb: np.ndarray,
             ref_text: Dict[str, np.ndarray]) -> Dict[str, float]:
    """``emb_rel_err`` and ``text_rel_err`` of ``emb`` (row ``i`` against
    row ``i`` of the reference's) and ``text``."""
    e, r = emb.astype(np.float64), ref_emb.astype(np.float64)
    emb_err = np.linalg.norm(e - r, axis=1) / np.linalg.norm(r, axis=1)
    text_err = [np.linalg.norm(text[k].astype(np.float64) - ref_text[k], axis=1)
                / np.linalg.norm(ref_text[k].astype(np.float64), axis=1) for k in ref_text]
    return {"emb_rel_err": float(emb_err.max()),
            "text_rel_err": float(np.concatenate(text_err).max())}


def pred_mismatch(emb: np.ndarray, pred: np.ndarray, class_text: np.ndarray,
                  temperature: float) -> int:
    """Predictions that are not the argmax of their own zero-shot logits
    (near-ties left out), in blocks of rows."""
    margins, gaps = [], []
    for lo in range(0, len(emb), 65536):
        logits = clip_f32.zero_shot_logits(torch.from_numpy(emb[lo:lo + 65536]),
                                           torch.from_numpy(class_text), temperature).numpy()
        ranked = np.sort(logits, axis=1)
        margins.append(ranked[:, -1] - ranked[:, -2])
        gaps.append(logits.max(axis=1) - logits[np.arange(len(logits)), pred[lo:lo + 65536]])
    margins, gaps = np.concatenate(margins), np.concatenate(gaps)
    return int(np.count_nonzero(gaps > TIE * float(np.median(margins))))


def ref_pred_mismatch(emb: np.ndarray, pred: np.ndarray, class_text: np.ndarray,
                      ref_emb: np.ndarray, ref_class: np.ndarray, temperature: float) -> int:
    """Predictions ``pred`` of the rows ``emb`` that are not the reference's
    argmax, where the reference's margin is wider than the gaps between
    ``emb``, ``class_text`` and the reference's rows can explain."""
    e, r = (torch.from_numpy(x).double() for x in (emb, ref_emb))
    t, rt = torch.from_numpy(class_text).double(), torch.from_numpy(ref_class).double()
    logits = clip_f32.zero_shot_logits(r, rt, temperature)
    top = logits.argmax(1)
    rows = torch.arange(len(r))
    p = torch.from_numpy(np.asarray(pred, np.int64))
    margin = logits[rows, top] - logits[rows, p]
    ranked = logits.sort(dim=1).values
    tie = TIE * float((ranked[:, -1] - ranked[:, -2]).median())
    drift = (e / e.norm(dim=1, keepdim=True) - r / r.norm(dim=1, keepdim=True)).norm(dim=1)
    reach = (drift[:, None] * rt.norm(dim=1)[None, :] + (t - rt).norm(dim=1)[None, :]) / temperature
    band = reach[rows, top] + reach[rows, p] + tie
    return int(((p != top) & (margin > band)).sum())


def judge(cfg: dict, seed: int, k: int, out_emb: np.ndarray, out_pred: np.ndarray,
          out_pool_index: np.ndarray, pool: np.ndarray, text: Dict[str, np.ndarray],
          tokens: Dict[str, np.ndarray], device, mode: str = "f32") -> Dict[str, float]:
    """Readings of the window's outputs: ``out_pool_index[i]`` is the flat
    pool index of output row ``i``."""
    pos = sample_positions(seed, len(out_emb), k)
    flat = pool.reshape((-1,) + pool.shape[2:])
    needed, inverse = np.unique(out_pool_index[pos], return_inverse=True)
    ref_emb, ref_text = reference_outputs(cfg, seed, flat[needed], tokens, device, mode)
    found = readings(out_emb[pos], text, ref_emb[inverse], ref_text)
    found["pred_mismatch"] = pred_mismatch(out_emb, out_pred, text["class"],
                                           cfg["zero_shot_temperature"])
    found["ref_pred_mismatch"] = ref_pred_mismatch(out_emb[pos], out_pred[pos], text["class"],
                                                   ref_emb[inverse], ref_text["class"],
                                                   cfg["zero_shot_temperature"])
    return found


def control_readings(cfg: dict, seed: int, k: int, pool: np.ndarray,
                     tokens: Dict[str, np.ndarray], device) -> Dict[str, float]:
    """The control: the reference in float8 put in the program's place on
    the same sample (images drawn from the pool as the window would cycle
    it), its head's product in float8 too, read against the f32 reference."""
    flat = pool.reshape((-1,) + pool.shape[2:])
    idx = sample_positions(seed, len(flat), k)
    emb8, text8 = reference_outputs(cfg, seed, flat[idx], tokens, device, "fp8")
    ref_emb, ref_text = reference_outputs(cfg, seed, flat[idx], tokens, device, "f32")
    num = clip_f32.Numerics("fp8")
    e = torch.from_numpy(emb8)
    logits8 = num.matmul(e / e.norm(dim=-1, keepdim=True), torch.from_numpy(text8["class"]).T)
    found = readings(emb8, text8, ref_emb, ref_text)
    pred8 = logits8.argmax(1).numpy()
    found["pred_mismatch"] = pred_mismatch(emb8, pred8, text8["class"],
                                           cfg["zero_shot_temperature"])
    found["ref_pred_mismatch"] = ref_pred_mismatch(emb8, pred8, text8["class"], ref_emb,
                                                   ref_text["class"], cfg["zero_shot_temperature"])
    return found


