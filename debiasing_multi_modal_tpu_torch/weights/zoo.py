"""OpenAI CLIP checkpoint zoo: URLs, sha256 verification, cached download
(port of ``weights/zoo.py``; the table, ``available_models``,
``expected_sha256``, ``verify`` and ``download`` are copies).

Parity surface: reference ``clip/clip.py`` — the ``_MODELS`` URL table
(:30-40), ``available_models`` (:89-91), and ``_download`` (:43-72) whose
sha256 check is the reference's only integrity/failure-detection mechanism.
The expected digest is embedded in each URL path and is verified both for
cached files and fresh downloads.

``load()`` composes download + convert: it returns the port's CLIP model
with the checkpoint's weights (``weights/convert.clip_from_state_dict``),
on ``device`` (``cuda`` unless the CPU is asked for); the preprocessing
lives in ``ops/preprocess.py`` and is applied by the runner.
"""

from __future__ import annotations

import hashlib
import os
import urllib.request
from typing import List

_MODELS = {
    "RN50": "https://openaipublic.azureedge.net/clip/models/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",
    "RN101": "https://openaipublic.azureedge.net/clip/models/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt",
    "RN50x4": "https://openaipublic.azureedge.net/clip/models/7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd/RN50x4.pt",
    "RN50x16": "https://openaipublic.azureedge.net/clip/models/52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa/RN50x16.pt",
    "RN50x64": "https://openaipublic.azureedge.net/clip/models/be1cfb55d75a9666199fb2206c106743da0f6468c9d327f3e0d0a543a9919d9c/RN50x64.pt",
    "ViT-B/32": "https://openaipublic.azureedge.net/clip/models/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
    "ViT-B/16": "https://openaipublic.azureedge.net/clip/models/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
    "ViT-L/14": "https://openaipublic.azureedge.net/clip/models/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",
    "ViT-L/14@336px": "https://openaipublic.azureedge.net/clip/models/3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02/ViT-L-14-336px.pt",
}

DEFAULT_CACHE = os.path.expanduser("~/.cache/clip")


def available_models() -> List[str]:
    return list(_MODELS)


def expected_sha256(name: str) -> str:
    """Digest embedded in the distribution URL."""
    return _MODELS[name].split("/")[-2]


def _sha256_of(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def verify(path: str, name: str) -> bool:
    return _sha256_of(path) == expected_sha256(name)


def download(name: str, root: str = DEFAULT_CACHE) -> str:
    """Fetch (or reuse) a checkpoint, verifying its sha256.

    Raises on digest mismatch after download; re-downloads a corrupt cache
    entry (reference clip.py:53-70 semantics).
    """
    if name not in _MODELS:
        raise ValueError(f"unknown model {name!r}; available: {available_models()}")
    url = _MODELS[name]
    os.makedirs(root, exist_ok=True)
    target = os.path.join(root, os.path.basename(url))
    if os.path.exists(target) and not os.path.isfile(target):
        raise RuntimeError(f"{target} exists and is not a regular file")
    if os.path.isfile(target):
        if verify(target, name):
            return target
        import sys

        # stderr: callers parse stdout (one JSON line)
        print(
            f"WARNING: {target} exists but sha256 mismatches; re-downloading",
            file=sys.stderr,
        )
    urllib.request.urlretrieve(url, target)
    if not verify(target, name):
        raise RuntimeError(
            f"{name}: downloaded file fails sha256 verification"
        )
    return target


def load(
    name_or_path: str,
    dtype=None,
    download_root: str = DEFAULT_CACHE,
    quant: str = "none",
    device=None,
):
    """``clip.load`` equivalent: name or local path -> the port's CLIP model
    with its weights loaded.  ``quant="int8"`` / ``"int8_pallas"`` returns
    the W8A8 ViT variant; the parameters are the same, so every checkpoint
    loads into it."""
    from debiasing_multi_modal_tpu_torch.weights.convert import (
        clip_from_state_dict,
        load_openai_checkpoint,
    )

    # zoo names resolve FIRST (reference clip.py:124-129): a stray local
    # file named exactly like a model must not shadow the sha256-verified
    # checkpoint.  Anything else must exist as a file to be treated as one.
    if name_or_path in _MODELS:
        path = download(name_or_path, download_root)
    elif os.path.isfile(name_or_path):
        path = name_or_path
    else:
        raise FileNotFoundError(
            f"{name_or_path!r} is neither a zoo model "
            f"({', '.join(sorted(_MODELS))}) nor an existing checkpoint file"
        )
    sd = load_openai_checkpoint(path)
    return clip_from_state_dict(sd, dtype=dtype, quant=quant, device=device)
