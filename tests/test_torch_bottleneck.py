"""The port's fused bottleneck block (debiasing_multi_modal_tpu_torch/ops/
conv_gemm.py, kernel 8; ops/fused_bottleneck.py, kernel 9) against the JAX
package's: the plain version ``xla_bottleneck`` and both wrappers on the CPU
(which run the plain version) against the JAX kernels in interpret mode, at
the cases and tolerances of tests/test_conv_gemm.py and
tests/test_fused_bottleneck.py (2e-5 in f32: sums in another order; 2e-2 in
bf16: one bf16 rounding of an intermediate may land on either side), and a
folded port ``Bottleneck`` against ``xla_bottleneck`` of its
``block_weights``.  The shared-memory gates are pinned here; the CUDA
kernels run only on a card: the ``on_card`` tests skip here."""

import numpy as np
import pytest
import torch

from debiasing_multi_modal_tpu_torch.ops import conv_gemm as tcg
from debiasing_multi_modal_tpu_torch.ops import fused_bottleneck as tfb


def _jax():
    """JAX and the JAX package's kernels, imported inside the parity tests
    only, so that on a machine with a card and no JAX the kernel tests run
    alone (``python -m pytest --noconftest tests/test_torch_bottleneck.py -k on_card``)."""
    jnp = pytest.importorskip("jax.numpy")
    from debiasing_multi_modal_tpu.ops import conv_gemm as jcg
    from debiasing_multi_modal_tpu.ops import fused_bottleneck as jfb

    return jnp, jcg, jfb


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _weights(rng, cin, m, cout, ds, scale=0.1):
    def mk(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    w = dict(w1=mk(cin, m), b1=mk(m), w2=mk(3, 3, m, m), b2=mk(m), w3=mk(m, cout), b3=mk(cout))
    if ds:
        w.update(wd=mk(cin, cout), bd=mk(cout))
    return w


def _torch(w, dtype=torch.float32, device="cpu"):
    return {k: torch.from_numpy(v).to(device=device, dtype=dtype) for k, v in w.items()}


def _close(ours, ref, tol):
    np.testing.assert_allclose(np.asarray(ours, np.float32), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


# (cin, m, cout, downsample, strip_rows, images_per_cell): tests/test_conv_gemm.py
GEMM_CASES = [(64, 16, 64, False, 8, 1), (64, 16, 128, True, 4, 2), (32, 16, 64, True, 16, 1)]
GEMM_IDS = ["plain", "ds_packed", "one_strip"]


@pytest.mark.parametrize("cin,m,cout,ds,strip,g", GEMM_CASES, ids=GEMM_IDS)
def test_gemm_wrapper_and_plain_match_jax_kernel(rng, cin, m, cout, ds, strip, g):
    jnp, jcg, _ = _jax()
    x = rng.standard_normal((2, 16, 16, cin)).astype(np.float32)
    w = _weights(rng, cin, m, cout, ds)
    ref = jcg.fused_bottleneck_gemm(jnp.asarray(x), **{k: jnp.asarray(v) for k, v in w.items()},
                                    strip_rows=strip, images_per_cell=g, interpret=True)
    tx, tw = torch.from_numpy(x), _torch(w)
    got = tcg.fused_bottleneck_gemm(tx, **tw, strip_rows=strip, images_per_cell=g)
    assert got.shape == (2, 16, 16, cout) and got.dtype == torch.float32
    _close(got.numpy(), ref, 2e-5)
    _close(tcg.xla_bottleneck(tx, **tw).numpy(),
           jcg.xla_bottleneck(jnp.asarray(x), **{k: jnp.asarray(v) for k, v in w.items()}), 2e-5)
    assert tcg.fused_bottleneck_gemm.launches == 0


def test_gemm_plain_matches_jax_in_bf16(rng):
    jnp, jcg, _ = _jax()
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    w = _weights(rng, 32, 16, 64, True)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    ref = jcg.fused_bottleneck_gemm(jnp.asarray(x, jnp.bfloat16), **jw, strip_rows=4,
                                    interpret=True)
    got = tcg.fused_bottleneck_gemm(torch.from_numpy(x).bfloat16(), **_torch(w), strip_rows=4)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(ref, np.float32), 2e-2)


def test_gemm_rejects_what_the_jax_wrapper_asserts(rng):
    _, jcg, _ = _jax()
    x = rng.standard_normal((1, 8, 8, 32)).astype(np.float32)
    w = _weights(rng, 32, 8, 64, False)
    with pytest.raises(AssertionError):
        jcg.fused_bottleneck_gemm(x, **w, strip_rows=8, interpret=True)
    tx, tw = torch.from_numpy(x), _torch(w)
    with pytest.raises(ValueError, match="Cin"):
        tcg.fused_bottleneck_gemm(tx, **tw, strip_rows=8)
    same = _torch(_weights(rng, 32, 8, 32, False))
    with pytest.raises(ValueError, match="strip_rows"):
        tcg.fused_bottleneck_gemm(tx, **same, strip_rows=3)
    with pytest.raises(ValueError, match="images_per_cell"):
        tcg.fused_bottleneck_gemm(torch.zeros(3, 8, 8, 32), **same, images_per_cell=2)


# (b, h, w, c, m): tests/test_fused_bottleneck.py
@pytest.mark.parametrize("shape", [(2, 8, 8, 32, 8), (1, 14, 14, 64, 16)], ids=["tiny", "l3ish"])
def test_shifted_wrapper_matches_jax_kernel(rng, shape):
    jnp, _, jfb = _jax()
    b, h, w, c, m = shape
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    wt = _weights(rng, c, m, c, False)
    ref = jfb.fused_bottleneck(jnp.asarray(x), *(jnp.asarray(wt[k]) for k in
                                                  ("w1", "b1", "w2", "b2", "w3", "b3")),
                               interpret=True)
    got = tfb.fused_bottleneck(torch.from_numpy(x), **_torch(wt))
    _close(got.numpy(), ref, 2e-5)
    assert tfb.fused_bottleneck.launches == 0


def test_shifted_wrapper_matches_jax_kernel_bf16(rng):
    jnp, _, jfb = _jax()
    b, h, w, c, m = 2, 8, 8, 32, 8
    mk = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)  # noqa: E731
    arrays = [mk(b, h, w, c), mk(c, m), mk(m), mk(3, 3, m, m), mk(m), mk(m, c), mk(c)]
    ref = jfb.fused_bottleneck(*(jnp.asarray(a, jnp.bfloat16) for a in arrays), interpret=True)
    got = tfb.fused_bottleneck(*(torch.from_numpy(a).bfloat16() for a in arrays))
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(ref, np.float32), 2e-2)


def test_shifted_wrapper_rejects_channel_mismatch(rng):
    w = _torch(_weights(rng, 32, 8, 64, False))
    with pytest.raises(ValueError, match="Cin == Cout"):
        tfb.fused_bottleneck(torch.zeros(1, 8, 8, 32), **w)


@pytest.mark.parametrize("block_index", [0, 1], ids=["downsample", "identity"])
def test_folded_block_matches_plain_of_its_block_weights(block_index):
    """A folded port Bottleneck (random weights and biases, some positive,
    so a wrong zero padding of y1 would show) against ``xla_bottleneck`` of
    ``block_weights``: checks the layout helper (f32, 2e-5 of scale)."""
    from debiasing_multi_modal_tpu_torch.models.resnet import Bottleneck

    torch.manual_seed(block_index)
    inplanes = 32 if block_index == 0 else 64
    block = Bottleneck(inplanes, 16, fuse_bn=True)
    assert (block.downsample is not None) == (block_index == 0)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape) * 0.1)
    x = torch.randn(2, inplanes, 8, 8).contiguous(memory_format=torch.channels_last)
    weights = tcg.block_weights(block)
    assert weights[0].shape == (inplanes, 16) and weights[2].shape == (3, 3, 16, 16)
    with torch.no_grad():
        ref = block(x).permute(0, 2, 3, 1)
        got = tcg.xla_bottleneck(x.permute(0, 2, 3, 1), *weights)
        kernel9 = None if block_index == 0 else tfb.fused_bottleneck(
            x.permute(0, 2, 3, 1), *weights[:6])
    scale = float(ref.abs().max())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=2e-5 * scale)
    if kernel9 is not None:
        np.testing.assert_array_equal(kernel9.numpy(), got.numpy())
    with pytest.raises(ValueError, match="folded"):
        tcg.block_weights(Bottleneck(inplanes, 16))


def test_shared_memory_gates_pinned():
    """The tiles the H100 kernels keep per block (y1 with its halo and zero
    border, y2, and the tensor-core kernel's ring of four 20,480-byte stage
    buffers, in either dtype), against the 232,448 bytes a block may use."""
    assert tcg.smem_bytes(56, 64, 8, 1, 2) == 213504     # layer1, bf16, strip 8
    assert tcg.smem_bytes(14, 256, 14, 1, 2) == 313344   # layer3, bf16, strip 14: too big
    assert tcg.smem_bytes(14, 256, 7, 1, 2) == 205824    # layer3, bf16, strip 7
    assert tcg.smem_bytes(7, 512, 7, 1, 2) == 215040     # layer4, bf16, strip 7
    assert tcg.smem_bytes(56, 64, 4, 1, 4) == 146432 + 81920  # layer1, f32, strip 4
    assert tcg.smem_bytes(28, 128, 4, 1, 4) == 231424    # layer2, f32, strip 4
    assert tcg.smem_bytes(7, 512, 1, 1, 4) == 151552     # layer4, f32, strip 1
    assert tcg.smem_bytes(56, 64, 8, 1, 4) > tcg.SMEM_LIMIT_BYTES  # layer1 f32 strip 8
    # largest fitting strip per RN50 stage, bf16 / f32, and kernel 9's gate
    stages = {"layer1": (56, 64), "layer2": (28, 128), "layer3": (14, 256), "layer4": (7, 512)}
    strips = {name: (tcg.pick_strip_rows(h, h, m, 2), tcg.pick_strip_rows(h, h, m, 4))
              for name, (h, m) in stages.items()}
    assert strips == {"layer1": (8, 4), "layer2": (7, 4), "layer3": (7, 2), "layer4": (7, 1)}
    assert tfb.smem_bytes(7, 7, 512, 2) == 215040 and tfb.strip_rows(56, 56, 64, 2) == 8
    assert tcg.pick_strip_rows(7, 7, 2048, 4) is None
    x, w1, w3 = torch.zeros(2, 56, 56, 64), torch.zeros(64, 64), torch.zeros(64, 256)
    assert not tcg.supported(x, w1, w3, strip_rows=8)           # f32 strip 8 does not fit
    assert tcg.supported(x, w1, w3, strip_rows=4)
    assert tcg.supported(x.bfloat16(), w1, w3, strip_rows=8, images_per_cell=1)
    assert not tcg.supported(x.bfloat16(), w1, w3, strip_rows=8, images_per_cell=2)
    assert not tcg.supported(x.half(), w1, w3, strip_rows=4)    # the kernel takes f32 or bf16
    assert not tfb.supported(x, w1, w3)                        # Cin != Cout
    assert tfb.supported(torch.zeros(2, 56, 56, 256), w3.t(), w3)


def test_bf16_needs_channels_in_multiples_of_16():
    """The bf16 kernel steps K by 16 (``mma.sync.m16n8k16``): channel counts
    that are multiples of 8 but not of 16 pass the f32 gate and fail the
    bf16 one, for kernels 8 and 9; the CPU path keeps the JAX wrapper's
    checks and runs the plain version in either dtype."""
    x, w1, w3 = torch.zeros(1, 8, 8, 24), torch.zeros(24, 8), torch.zeros(8, 24)
    assert tcg.supported(x, w1, w3, strip_rows=8)
    assert not tcg.supported(x.bfloat16(), w1, w3, strip_rows=8)
    assert tfb.supported(x, w1, w3) and not tfb.supported(x.bfloat16(), w1, w3)
    assert tcg.supported(torch.zeros(1, 8, 8, 32).bfloat16(), torch.zeros(32, 16),
                         torch.zeros(16, 32), strip_rows=8)
    w2 = torch.zeros(3, 3, 8, 8)
    got = tcg.fused_bottleneck_gemm(x.bfloat16(), w1, torch.zeros(8), w2, torch.zeros(8), w3,
                                    torch.zeros(24), strip_rows=8)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape


def _block_f64(x, w):
    """The block in float64 (NHWC in and out), the yardstick of the f32 error."""
    f = torch.nn.functional
    h = x.double().permute(0, 3, 1, 2)

    def conv(t, kernel_oihw, padding):
        return f.conv2d(t, kernel_oihw.double(), padding=padding)

    def one_by_one(name):
        return w[name].t()[:, :, None, None]

    def bias(name):
        return w[name].double()[:, None, None]

    y = torch.relu(conv(h, one_by_one("w1"), 0) + bias("b1"))
    y = torch.relu(conv(y, w["w2"].permute(3, 2, 0, 1), 1) + bias("b2"))
    y = conv(y, one_by_one("w3"), 0) + bias("b3")
    r = h if "wd" not in w else conv(h, one_by_one("wd"), 0) + bias("bd")
    return torch.relu(y + r).permute(0, 2, 3, 1)


def _block_with(mm, x, w, shifted):
    """Kernels 8 and 9 in f32 with every product taken by ``mm`` over
    ``[pixels, K] x [K, N]``: kernel 8 takes conv2 as one K = 9M contraction
    of the zero-padded y1 patches, kernel 9 each (dy, dx) shift's product on
    its own, added to the sum; the biases and the residual added as the
    kernel adds them."""
    b, h, wd, cin = x.shape
    m = w["w1"].shape[1]
    xf = x.reshape(-1, cin)
    y1 = torch.relu(mm("pk,kn->pn", xf, w["w1"]) + w["b1"]).reshape(b, h, wd, m)
    y1 = torch.nn.functional.pad(y1, (0, 0, 1, 1, 1, 1))
    patches = [y1[:, dy:dy + h, dx:dx + wd].reshape(-1, m) for dy in range(3) for dx in range(3)]
    w2 = w["w2"].reshape(9, m, m)
    if shifted:
        acc = torch.zeros(xf.shape[0], m)
        for shift, patch in enumerate(patches):
            acc = acc + mm("pk,kn->pn", patch, w2[shift])
    else:
        acc = mm("pk,kn->pn", torch.cat(patches, 1), w2.reshape(9 * m, m))
    y2 = torch.relu(acc + w["b2"])
    r = xf if "wd" not in w else mm("pk,kn->pn", xf, w["wd"]) + w["bd"]
    return torch.relu(mm("pk,kn->pn", y2, w["w3"]) + w["b3"] + r).reshape(b, h, wd, -1)


@pytest.mark.parametrize("cin,m,cout,ds,shifted", [
    (64, 16, 64, False, False), (32, 16, 64, True, False), (64, 16, 64, False, True)],
    ids=["kernel8", "kernel8_downsample", "kernel9"])
def test_split_tf32_block_matches_float64_and_jax(rng, cin, m, cout, ds, shifted):
    """f32 kernels 8 and 9 run every product as three TF32 products on the
    tensor cores (lo.hi + hi.lo + hi.hi, csrc/bottleneck.cu).  Emulated here
    in torch: within 1e-4 of scale of the block in float64 and of the JAX
    kernels in interpret mode, the f32 limit the card holds the kernels to
    against the plain version.  A single TF32 product per product is printed
    beside it, and is worse."""
    from test_torch_flash_attention import _split_tf32_mm, _tf32_mm

    jnp, jcg, jfb = _jax()
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    w = _weights(rng, cin, m, cout, ds)
    tx, tw = torch.from_numpy(x), _torch(w)
    exact = _block_f64(tx, tw)
    got = _block_with(_split_tf32_mm, tx, tw, shifted)
    single = _block_with(_tf32_mm, tx, tw, shifted)
    scale = exact.abs().max().item()
    err = (got.double() - exact).abs().max().item()
    err1 = (single.double() - exact).abs().max().item()
    print(f"split-TF32 {err / scale:.2e}, one TF32 product {err1 / scale:.2e} of scale "
          f"against float64")
    assert err <= 1e-4 * scale and err < err1, (err / scale, err1 / scale)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    if shifted:
        ref = jfb.fused_bottleneck(jnp.asarray(x), *(jw[k] for k in ("w1", "b1", "w2", "b2",
                                                                     "w3", "b3")),
                                   interpret=True)
    else:
        ref = jcg.fused_bottleneck_gemm(jnp.asarray(x), **jw, strip_rows=4, interpret=True)
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


# ------------------------------------------------------------- on the card --

def _card_case(rng, b, h, cin, m, cout, ds, dtype):
    x = torch.from_numpy(rng.standard_normal((b, h, h, cin)).astype(np.float32))
    x = x.to("cuda", dtype)
    return x, _torch(_weights(rng, cin, m, cout, ds), device="cuda")


def _agree(out, ref, dtype):
    """bf16: within 2e-2 of scale and cosine >= 0.9999 (a bf16 rounding of
    y1, y2 or y3 may land on either side where the f32 sums differ in
    order); f32 (split-TF32 on the tensor cores, ~1e-6 of scale emulated):
    within 1e-4 of scale (TF32 off in the plain version)."""
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    cos = torch.nn.functional.cosine_similarity(out.float().flatten(), ref.float().flatten(),
                                                dim=0).item()
    if dtype == torch.bfloat16:
        assert err <= 2e-2 * scale and cos >= 0.9999, (err, scale, cos)
    else:
        assert err <= 1e-4 * scale, (err, scale)


@pytest.mark.parametrize("b,h,cin,m,cout,ds,strip,g,dtype", [
    (2, 16, 64, 16, 64, False, 8, 1, torch.float32),
    (4, 16, 64, 16, 128, True, 4, 2, torch.bfloat16),
    (2, 14, 256, 64, 256, False, 7, 1, torch.bfloat16),
    (3, 7, 512, 128, 512, False, 7, 1, torch.float32),
    (2, 56, 64, 64, 256, True, 8, 1, torch.bfloat16),
    (2, 56, 256, 64, 256, False, 8, 1, torch.bfloat16),
    (2, 28, 512, 128, 512, False, 7, 1, torch.bfloat16),
    (2, 14, 1024, 256, 1024, False, 7, 1, torch.bfloat16),
    (2, 7, 2048, 512, 2048, False, 7, 1, torch.bfloat16),
    (3, 16, 64, 48, 96, True, 8, 3, torch.bfloat16),
    (2, 56, 64, 64, 256, True, 4, 1, torch.float32),
    (2, 56, 256, 64, 256, False, 4, 1, torch.float32),
    (2, 28, 512, 128, 512, False, 4, 1, torch.float32),
    (2, 14, 1024, 256, 1024, False, 2, 1, torch.float32),
    (2, 7, 2048, 512, 2048, False, 1, 1, torch.float32),
    (3, 16, 64, 48, 96, True, 2, 3, torch.float32),
], ids=["f32", "ds_packed_bf16", "l1ish_bf16", "l4ish_f32", "l1b0_ds_bf16", "l1b1_bf16",
        "l2b1_bf16", "l3b1_bf16", "l4b1_bf16", "odd_widths_packed_bf16", "l1b0_ds_f32",
        "l1b1_f32", "l2b1_f32", "l3b1_f32", "l4b1_f32", "odd_widths_packed_f32"])
def test_gemm_kernel_equals_plain_on_card(card, b, h, cin, m, cout, ds, strip, g, dtype):
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    x, w = _card_case(rng, b, h, cin, m, cout, ds, dtype)
    before = tcg.fused_bottleneck_gemm.launches
    out = tcg.fused_bottleneck_gemm(x, **w, strip_rows=strip, images_per_cell=g)
    torch.cuda.synchronize()
    assert tcg.fused_bottleneck_gemm.launches == before + 1
    assert out.shape == (b, h, h, cout) and out.dtype == dtype
    _agree(out, tcg.xla_bottleneck(x, **w), dtype)


@pytest.mark.parametrize("b,h,c,m,dtype", [
    (2, 8, 32, 8, torch.float32), (2, 14, 1024, 256, torch.bfloat16),
    (2, 56, 256, 64, torch.bfloat16), (2, 7, 2048, 512, torch.float32),
    (2, 56, 256, 64, torch.float32), (2, 28, 512, 128, torch.float32),
    (2, 14, 1024, 256, torch.float32),
], ids=["tiny_f32", "l3_bf16", "l1_bf16", "l4_f32", "l1_f32", "l2_f32", "l3_f32"])
def test_shifted_kernel_equals_plain_on_card(card, b, h, c, m, dtype):
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(1)
    x, w = _card_case(rng, b, h, c, m, c, False, dtype)
    before = tfb.fused_bottleneck.launches
    out = tfb.fused_bottleneck(x, **w)
    torch.cuda.synchronize()
    assert tfb.fused_bottleneck.launches == before + 1
    _agree(out, tcg.xla_bottleneck(x, **w), dtype)


def test_kernels_refuse_what_they_do_not_take_on_card(card):
    rng = np.random.default_rng(2)
    x, w = _card_case(rng, 1, 56, 64, 64, 256, True, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):  # layer1 f32 strip 8
        tcg.fused_bottleneck_gemm(x, **w, strip_rows=8)
    with pytest.raises(ValueError, match="f32 or bf16"):
        tcg.fused_bottleneck_gemm(x.half(), **w, strip_rows=4)
    x, w = _card_case(rng, 1, 8, 20, 12, 20, False, torch.float32)
    with pytest.raises(ValueError, match="multiples of 8"):
        tcg.fused_bottleneck_gemm(x, **w, strip_rows=8)
    assert not tcg.supported(x, w["w1"], w["w3"], strip_rows=8)
    assert not tfb.supported(x, w["w1"], w["w3"])
    # bf16 steps K by 16: 24 channels pass in f32 and are refused in bf16
    x, w = _card_case(rng, 1, 8, 24, 8, 24, False, torch.bfloat16)
    before = (tcg.fused_bottleneck_gemm.launches, tfb.fused_bottleneck.launches)
    with pytest.raises(ValueError, match="multiples of 16"):
        tcg.fused_bottleneck_gemm(x, **w, strip_rows=8)
    with pytest.raises(ValueError, match="multiples of 16"):
        tfb.fused_bottleneck(x, **w)
    assert (tcg.fused_bottleneck_gemm.launches, tfb.fused_bottleneck.launches) == before
