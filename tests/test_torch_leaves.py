"""The port's leaf modules against the JAX package's, on the CPU at f32:
``data/predictions.py`` (byte-identical CSVs), ``utils/meters.py``,
``utils/timing.py`` (the gauges run on the CPU), ``ops/augment.py`` (the
crops and flips of JAX's own draws within 1e-6; the port's draws by their
ranges), ``weights/zoo.py`` (the table, verification, a mocked download,
``load`` of a local archive), ``weights/convert.py::
save_jit_state_dict_archive`` (each package reads the other's archive to
equal arrays) and ``entry.py`` (the flagship step's predictions equal the
JAX entry's on carried-over weights)."""

import functools
import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debiasing_multi_modal_tpu.ops import augment as jaug
from debiasing_multi_modal_tpu_torch.ops import augment as taug


# ---------------------------------------------------------- predictions --


def test_prediction_csv_is_byte_identical_and_reads_alike(tmp_path):
    from debiasing_multi_modal_tpu.data import predictions as jpred
    from debiasing_multi_modal_tpu_torch.data import predictions as tpred

    fns = np.asarray([f"img_{i}.jpg" for i in range(10)])
    preds = np.random.default_rng(0).integers(0, 2, 10)
    ours, ref = str(tmp_path / "a" / "prediction.csv"), str(tmp_path / "b" / "prediction.csv")
    tpred.save_predictions(ours, fns, preds)
    jpred.save_predictions(ref, fns, preds)
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert tpred.load_predictions(ref) == jpred.load_predictions(ours)
    vec = tpred.predictions_vector(ours, fns[::-1])
    np.testing.assert_array_equal(vec, jpred.predictions_vector(ours, fns[::-1]))
    assert vec.dtype == np.int32
    bad = tmp_path / "bad.csv"
    bad.write_text("")
    with pytest.raises(ValueError, match="not a prediction CSV"):
        tpred.load_predictions(str(bad))


# ------------------------------------------------------- meters, timing --


def test_meters_match_jax():
    from debiasing_multi_modal_tpu.utils import meters as jm
    from debiasing_multi_modal_tpu_torch.utils import meters as tm

    a, b = tm.AverageMeter(), jm.AverageMeter()
    for val, n in ((2.0, 1), (4.0, 3), (0.5, 2)):
        a.update(val, n)
        b.update(val, n)
        assert (a.val, a.avg, a.sum, a.count) == (b.val, b.avg, b.sum, b.count)
    a.reset()
    assert (a.val, a.avg, a.sum, a.count) == (0.0, 0.0, 0.0, 0)


def test_timing_gauges_run_on_cpu():
    from debiasing_multi_modal_tpu_torch.utils import timing

    up = timing.measure_upload_ms(np.zeros((4, 8, 8, 3), np.uint8), iters=2, device="cpu")
    down = timing.measure_download_ms(lambda: [torch.arange(64.0) + 0.0], iters=2)
    chain = timing.chain_time(lambda x: x @ x, torch.ones(8, 8), iters=3)
    for ms in (up, down, chain):
        assert np.isfinite(ms) and ms >= 0.0


# -------------------------------------------------------------- augment --


def _jax_boxes(key, n, h, w, scale_range=(0.7, 1.0), ratio_range=(3 / 4, 4 / 3)):
    """JAX ``random_resized_crop``'s own draws (``augment.py:58-68``),
    jitted as there (XLA fuses ``u * (h - ch)`` and the like)."""
    return [torch.from_numpy(np.array(a)) for a in
            _jax_boxes_jit(key, n, h, w, scale_range, ratio_range)]


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _jax_boxes_jit(key, n, h, w, scale_range, ratio_range):
    k_area, k_ratio, k_y, k_x = jax.random.split(key, 4)
    area = jax.random.uniform(k_area, (n,), minval=scale_range[0],
                              maxval=scale_range[1]) * (h * w)
    log_r = jax.random.uniform(k_ratio, (n,), minval=jnp.log(ratio_range[0]),
                               maxval=jnp.log(ratio_range[1]))
    ratio = jnp.exp(log_r)
    cw = jnp.clip(jnp.sqrt(area * ratio), 1.0, w)
    ch = jnp.clip(jnp.sqrt(area / ratio), 1.0, h)
    y0 = jax.random.uniform(k_y, (n,)) * (h - ch)
    x0 = jax.random.uniform(k_x, (n,)) * (w - cw)
    return y0, x0, ch, cw


def _jax_crop_of(images, boxes, out_res):
    """The JAX module's sampling of given boxes: its ``sample_one``
    (``augment.py:70-76``) over its ``_bilinear_sample``, jitted as there."""
    grid = (jnp.arange(out_res) + 0.5) / out_res

    def sample_one(img, y0i, x0i, chi, cwi):
        ys = jnp.broadcast_to(y0i + grid[:, None] * chi - 0.5, (out_res, out_res))
        xs = jnp.broadcast_to(x0i + grid[None, :] * cwi - 0.5, (out_res, out_res))
        return jaug._bilinear_sample(img, ys, xs)

    return np.asarray(jax.jit(jax.vmap(sample_one))(jnp.asarray(images),
                                                    *(jnp.asarray(b.numpy()) for b in boxes)))


@pytest.mark.parametrize("shape,out_res,scale,dtype", [
    ((4, 64, 80, 3), 32, (0.7, 1.0), np.float32),  # downsampling, not square
    ((8, 32, 32, 3), 32, (0.7, 1.0), np.float32),  # upsampling: the clamp at the edge
    ((2, 64, 64, 3), 32, (1.0, 1.0), np.float32),  # the whole image
    ((3, 40, 48, 3), 24, (0.08, 1.0), np.uint8),   # uint8 pixels, small crops
])
def test_resized_crop_of_jax_boxes_matches_jax(shape, out_res, scale, dtype):
    """JAX's boxes fed to both packages agree within 1e-6 of the pixel
    scale.  ``random_resized_crop`` itself, which draws the same boxes, is
    held within 1e-5: inside its one jitted program XLA fuses the box draw
    into the coordinate arithmetic (the corner ``u * (h - ch)`` is never
    rounded to f32), which moves a coordinate by up to an f32 ulp."""
    rng = np.random.default_rng(1)
    imgs = rng.random(shape)
    imgs = (imgs * 255).astype(np.uint8) if dtype == np.uint8 else imgs.astype(np.float32)
    key = jax.random.PRNGKey(3)
    boxes = _jax_boxes(key, shape[0], shape[1], shape[2], scale)
    got = taug.resized_crop(torch.from_numpy(imgs), *boxes, out_res=out_res).numpy()
    want = _jax_crop_of(imgs, boxes, out_res)
    assert got.dtype == np.float32 and got.shape == want.shape
    scale_of = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale_of)
    jitted = np.asarray(jaug.random_resized_crop(key, jnp.asarray(imgs), out_res=out_res,
                                                 scale_range=scale))
    np.testing.assert_allclose(got, jitted, rtol=0, atol=1e-5 * scale_of)


def test_train_augment_of_jax_draws_matches_jax():
    """``train_augment``: the crop from the first split key, the flip from
    the second (``jax.random.bernoulli``), redrawn and fed to both (1e-6);
    the JAX function itself within 1e-5, as above."""
    rng = np.random.default_rng(2)
    imgs = rng.random((6, 48, 48, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    boxes = _jax_boxes(k1, 6, 48, 48)
    flips = np.asarray(jax.random.bernoulli(k2, 0.5, (6,)))
    want = np.where(flips[:, None, None, None], _jax_crop_of(imgs, boxes, 24)[:, :, ::-1],
                    _jax_crop_of(imgs, boxes, 24))
    crops = taug.resized_crop(torch.from_numpy(imgs), *boxes, out_res=24)
    got = taug.horizontal_flip(crops, torch.from_numpy(flips)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    jitted = np.asarray(jaug.train_augment(key, jnp.asarray(imgs), out_res=24))
    np.testing.assert_allclose(got, jitted, rtol=0, atol=1e-5)


def test_port_draws_ranges_determinism_and_flip():
    gen = torch.Generator().manual_seed(0)
    y0, x0, ch, cw = taug.crop_boxes(gen, 512, 60, 80, (0.7, 1.0))
    area = ch * cw
    assert bool((ch >= 1).all() and (ch <= 60).all() and (cw >= 1).all() and (cw <= 80).all())
    assert bool((y0 >= 0).all() and (y0 <= 60 - ch + 1e-4).all())
    assert bool((x0 >= 0).all() and (x0 <= 80 - cw + 1e-4).all())
    # clipping only shrinks a box: its area stays under the drawn scale's top
    assert float(area.max()) <= 1.0 * 60 * 80 + 1e-2 and float(area.min()) > 0.3 * 60 * 80
    imgs = torch.rand(8, 8, 8, 3, generator=torch.Generator().manual_seed(1))
    out = taug.random_horizontal_flip(torch.Generator().manual_seed(1), imgs)
    flipped = 0
    for i in range(8):
        if torch.equal(out[i], imgs[i]):
            continue
        assert torch.equal(out[i], imgs[i].flip(1))
        flipped += 1
    assert 0 < flipped < 8
    big = torch.rand(4, 64, 64, 3, generator=torch.Generator().manual_seed(2))
    a = taug.train_augment(torch.Generator().manual_seed(7), big, out_res=32)
    b = taug.train_augment(torch.Generator().manual_seed(7), big, out_res=32)
    c = taug.train_augment(torch.Generator().manual_seed(8), big, out_res=32)
    assert torch.equal(a, b) and (a - c).abs().max() > 1e-3
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    v1, v2 = taug.two_crop(torch.Generator().manual_seed(0), big, out_res=32)
    assert v1.shape == v2.shape == (4, 32, 32, 3) and (v1 - v2).abs().max() > 1e-3


# ------------------------------------------------------- zoo and archives --


def test_zoo_table_digests_and_verify_match_jax(tmp_path):
    from debiasing_multi_modal_tpu.weights import zoo as jzoo
    from debiasing_multi_modal_tpu_torch.weights import zoo

    assert zoo.available_models() == jzoo.available_models()
    for name in zoo.available_models():
        assert zoo.expected_sha256(name) == jzoo.expected_sha256(name)
    p = tmp_path / "RN50.pt"
    p.write_bytes(b"not a real checkpoint")
    assert not zoo.verify(str(p), "RN50")
    with pytest.raises(ValueError, match="unknown model"):
        zoo.download("RN999")
    with pytest.raises(FileNotFoundError, match="neither a zoo model"):
        zoo.load("./no_such_checkpoint.pt")


def test_download_verify_and_corrupt_cache(tmp_path, monkeypatch):
    """The download path with the fetch mocked (no network), as the JAX
    suite's ``test_download_verify_and_corrupt_cache``."""
    from debiasing_multi_modal_tpu_torch.weights import zoo

    name, good = "RN50", b"checkpoint-bytes"
    url = zoo._MODELS[name]
    monkeypatch.setitem(zoo._MODELS, name,
                        url.rsplit("/", 2)[0] + f"/{hashlib.sha256(good).hexdigest()}/model.pt")
    fetched = []

    def fake_retrieve(url, target):
        fetched.append(url)
        with open(target, "wb") as f:
            f.write(good)

    monkeypatch.setattr(zoo.urllib.request, "urlretrieve", fake_retrieve)
    p = zoo.download(name, root=str(tmp_path))
    assert os.path.isfile(p) and len(fetched) == 1
    assert zoo.download(name, root=str(tmp_path)) == p and len(fetched) == 1
    with open(p, "wb") as f:
        f.write(b"corrupted")
    assert zoo.download(name, root=str(tmp_path)) == p and len(fetched) == 2

    def bad_retrieve(url, target):
        with open(target, "wb") as f:
            f.write(b"still-wrong")

    monkeypatch.setattr(zoo.urllib.request, "urlretrieve", bad_retrieve)
    os.remove(p)
    with pytest.raises(RuntimeError, match="sha256"):
        zoo.download(name, root=str(tmp_path))
    os.remove(p)
    os.makedirs(p)
    with pytest.raises(RuntimeError, match="not a regular file"):
        zoo.download(name, root=str(tmp_path))


TINY_VIT = dict(name="tiny-zoo", embed_dim=32, image_resolution=32, vision_layers=2,
                vision_width=64, vision_patch_size=16, transformer_width=64,
                transformer_heads=1, transformer_layers=1, vocab_size=512)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_archives_read_alike_in_both_packages(tmp_path, writer):
    """An archive either package writes reads to equal arrays in both."""
    from debiasing_multi_modal_tpu.weights import convert as jconvert
    from debiasing_multi_modal_tpu_torch.models import CLIPConfig, create_clip
    from debiasing_multi_modal_tpu_torch.weights import convert as tconvert

    model = create_clip(CLIPConfig(**TINY_VIT), device="cpu",
                        generator=torch.Generator().manual_seed(5))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    path = str(tmp_path / "tiny.pt")
    (tconvert if writer == "port" else jconvert).save_jit_state_dict_archive(sd, path)
    for reader in (tconvert, jconvert):
        got = reader.load_openai_checkpoint(path)
        assert set(got) == set(sd)
        for k, v in sd.items():
            np.testing.assert_array_equal(got[k], v)


def test_zoo_load_of_a_seeded_archive_matches_clip_from_state_dict(tmp_path):
    from debiasing_multi_modal_tpu_torch.models import CLIPConfig, create_clip
    from debiasing_multi_modal_tpu_torch.weights import convert, zoo

    model = create_clip(CLIPConfig(**TINY_VIT), device="cpu",
                        generator=torch.Generator().manual_seed(6))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    path = str(tmp_path / "tiny.pt")
    convert.save_jit_state_dict_archive(sd, path)
    loaded = zoo.load(path, device="cpu")
    direct = convert.clip_from_state_dict(sd, device="cpu")
    imgs = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(loaded.encode_image(imgs), direct.encode_image(imgs))
        assert torch.equal(loaded.encode_image(imgs), model.encode_image(imgs))


# ---------------------------------------------------------------- entry --


def test_entry_predicts_as_the_jax_entry():
    """The flagship RN50 step on the CPU (f32): the JAX entry's seeded batch
    and text matrix, the JAX weights carried across; features within 1e-4
    of scale, predictions equal."""
    import __graft_entry__

    from debiasing_multi_modal_tpu_torch.entry import entry
    from debiasing_multi_modal_tpu_torch.weights.convert import state_dict_from_jax_variables

    jfn, (variables, jimages, jtext) = __graft_entry__.entry()
    fn, (model, images, text) = entry(device="cpu")
    np.testing.assert_array_equal(images.numpy(), np.asarray(jimages))
    np.testing.assert_array_equal(text.numpy(), np.asarray(jtext))
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict_from_jax_variables(variables).items()})
    feats, preds = fn(model, images, text)
    jfeats, jpreds = (np.asarray(a) for a in jax.jit(jfn)(variables, jimages, jtext))
    assert feats.dtype == torch.float32 and feats.shape == (8, 1024)
    err = np.abs(feats.numpy() - jfeats).max() / np.abs(jfeats).max()
    assert err <= 1e-4, err
    np.testing.assert_array_equal(preds.numpy(), jpreds)
