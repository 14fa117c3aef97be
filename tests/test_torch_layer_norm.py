"""The port's f32 LayerNorm (debiasing_multi_modal_tpu_torch/ops/layer_norm.py).

On the CPU the wrapper is the plain version, bit for bit, and counts no
launch; its gate is checked on CPU tensors (it reads shapes, strides, dtypes
and pointers only).  ``LayerNormF32`` against the JAX package's is
``tests/test_torch_layers.py``'s case.

The CUDA kernel runs only on a card; those tests skip here and run there
with ``python -m pytest --noconftest tests/test_torch_layer_norm.py``.  On
the card the kernel is held to the plain version (the f32 function rounded
once to the working dtype) within one ulp of the working dtype at the
element's magnitude, plus :data:`F32_TERM_ULPS` f32 ulps at the row's
largest term ``|x_hat * weight| + |bias|``: the two round the same f32 terms
in other orders (two-pass statistics in registers against Welford), each
within 3 f32 ulps of the exact function at that scale (measured on the CPU
against float64, 20,000 rows at each width), which near zero is more than
an ulp of the element itself, and in f32 always can be.
"""

import pytest
import torch
import torch.nn.functional as F

from debiasing_multi_modal_tpu_torch import ops
from debiasing_multi_modal_tpu_torch.models.config import CONFIGS
from debiasing_multi_modal_tpu_torch.models.layers import LayerNormF32
from debiasing_multi_modal_tpu_torch.ops import layer_norm as ln

EPS = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(rows, d, dtype, device="cpu", seed=0):
    """Rows of x ~ N(0.5, 2^2) in ``dtype``, f32 weight and bias ~ N(0, 1)."""
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn(rows, d, device=device, generator=g) * 2 + 0.5
    w, b = (torch.randn(d, device=device, generator=g) for _ in range(2))
    return x.to(dtype), w, b


# ------------------------------------------------------------------ CPU --

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,view", [(torch.Size([3, 7, 512]), None),
                                        (torch.Size([12, 768]), None),
                                        (torch.Size([4, 9, 1024]), "cls"),
                                        (torch.Size([2, 5, 24]), None)])
def test_cpu_takes_the_plain_version_bit_for_bit(dtype, shape, view):
    x, w, b = _inputs(shape[:-1].numel(), shape[-1], dtype)
    x = x.reshape(shape)
    if view == "cls":
        x = x[:, 0]
    before = ln.layer_norm.launches
    got = ln.layer_norm(x, w, b, EPS)
    want = F.layer_norm(x.float(), (shape[-1],), w, b, EPS).to(dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    module = LayerNormF32(shape[-1])
    module.load_state_dict({"weight": w, "bias": b})
    assert torch.equal(module(x), want)
    assert ln.layer_norm.launches == before


def _widths():
    out = set()
    for cfg in CONFIGS.values():
        out.add(cfg.transformer_width)
        if cfg.vision_patch_size:
            out.add(cfg.vision_width)
    return sorted(out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", _widths())
def test_gate_takes_every_tower_width(width, dtype):
    assert width in ln.WIDTHS
    x, w, b = _inputs(4, width, dtype)
    assert ln.supported(x.reshape(2, 2, width), w, b)
    tokens = torch.zeros(3, 577, width, dtype=dtype)
    assert ln.supported(tokens[:, 0], w, b)  # ln_post reads the class rows in place
    flat = torch.cat([torch.zeros(1), w, b])  # parameters as views 4 bytes off 16
    assert ln.supported(x, flat[1:width + 1], flat[width + 1:])


@pytest.mark.parametrize("case", ["width_not_multiple_of_8", "width_past_2048", "float16",
                                  "float64", "bf16_weight", "short_bias", "strided_last_axis",
                                  "uneven_rows", "misaligned_view"])
def test_gate_refuses(case):
    d, dtype = {"width_not_multiple_of_8": (100, torch.bfloat16),
                "width_past_2048": (4096, torch.bfloat16), "float16": (512, torch.float16),
                "float64": (512, torch.float64)}.get(case, (512, torch.bfloat16))
    x, w, b = _inputs(6, d, dtype)
    if case == "bf16_weight":
        w = w.bfloat16()
    elif case == "short_bias":
        b = b[:-8]
    elif case == "strided_last_axis":
        x = torch.zeros(6, 2 * d, dtype=dtype)[:, ::2]
    elif case == "uneven_rows":
        x = torch.zeros(4, 6, d, dtype=dtype)[:, :3]  # 3 rows, a gap, 3 rows
    elif case == "misaligned_view":
        x = torch.zeros(6 * d + 4, dtype=dtype)[4:].view(6, d)  # 8 bytes off
    assert not ln.supported(x, w, b)


@pytest.mark.parametrize("shape,index,want", [((5, 512), None, 512), ((4, 9, 768), None, 768),
                                              ((4, 9, 768), "cls", 9 * 768),
                                              ((1, 1, 640), None, 640),
                                              ((4, 6, 512), "half", None)])
def test_row_stride(shape, index, want):
    x = torch.zeros(shape)
    if index == "cls":
        x = x[:, 0]
    elif index == "half":
        x = x[:, :3]
    assert ln.row_stride(x) == want


def test_wrapper_refuses_other_devices():
    x = torch.empty(2, 512, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ln.layer_norm(x, torch.ones(512, device="meta"), torch.zeros(512, device="meta"), EPS)


def test_launch_counts_carry_layer_norm():
    counts = ops.launch_counts()
    assert counts["layer_norm"] == ln.layer_norm.launches
    assert ops.kernel_wrappers()["layer_norm"] is ln.layer_norm


# ----------------------------------------------------------------- card --

F32_TERM_ULPS = 8


def _ulp(v, mantissa_bits):
    """One ulp of a float with ``mantissa_bits`` stored bits at |v|."""
    _, e = torch.frexp(v.float().abs())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 1 - mantissa_bits)


def _ulp_report(got, want, x, w, b):
    """(largest |got - want| over its tolerance, share of elements that
    differ, share more than one ulp of their own apart)."""
    bits = 7 if want.dtype == torch.bfloat16 else 23
    xd = x.double()
    x_hat = (xd - xd.mean(-1, keepdim=True)) * torch.rsqrt(
        xd.var(-1, correction=0, keepdim=True) + EPS)
    terms = (x_hat.abs() * w.double().abs() + b.double().abs()).amax(-1, keepdim=True)
    del xd, x_hat
    diff = (got.float() - want.float()).abs()
    own = _ulp(want, bits)
    tol = own + F32_TERM_ULPS * _ulp(terms, 23)
    return ((diff / tol).max().item(), (diff > 0).float().mean().item(),
            (diff > own).float().mean().item())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("rows", [1, 77, 12800, 147712])
@pytest.mark.parametrize("width", [512, 640, 768, 1024, 200])
def test_kernel_matches_plain_on_card(card, width, rows, dtype):
    x, w, b = _inputs(rows, width, dtype, "cuda", seed=rows + width)
    before = ln.layer_norm.launches
    got = ln.layer_norm(x, w, b, EPS)
    torch.cuda.synchronize()
    assert ln.layer_norm.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape and got.is_contiguous()
    worst, differ, past_own_ulp = _ulp_report(got, ln.layer_norm_reference(x, w, b, EPS),
                                              x, w, b)
    print(f"width {width} rows {rows} {dtype}: worst {worst:.3f} of the tolerance, "
          f"{differ:.6%} differ, {past_own_ulp:.6%} by more than their own ulp")
    assert worst <= 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_strided_class_rows_on_card(card, dtype):
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randn(64, 577, 1024, device="cuda", generator=g).to(dtype)
    w = torch.randn(1024, device="cuda", generator=g)
    b = torch.randn(1024, device="cuda", generator=g)
    before = ln.layer_norm.launches
    got = ln.layer_norm(tokens[:, 0], w, b, EPS)
    assert ln.layer_norm.launches == before + 1
    assert torch.equal(got, ln.layer_norm(tokens[:, 0].contiguous(), w, b, EPS))


def test_parameters_at_any_offset_on_card(card):
    """A state dict of views into one flat f32 buffer (as a seeded or
    converted checkpoint may load) takes the kernel as it is."""
    x, w, b = _inputs(1000, 768, torch.bfloat16, "cuda", seed=5)
    flat = torch.cat([torch.zeros(1, device="cuda"), w, b])
    before = ln.layer_norm.launches
    got = ln.layer_norm(x, flat[1:769], flat[769:], EPS)
    assert ln.layer_norm.launches == before + 1
    assert torch.equal(got, ln.layer_norm(x, w, b, EPS))


@pytest.mark.parametrize("case", ["width_not_multiple_of_8", "width_past_2048", "float16",
                                  "bf16_weight", "misaligned_view"])
def test_kernel_refuses_on_card(card, case):
    d, dtype = {"width_not_multiple_of_8": (100, torch.bfloat16),
                "width_past_2048": (4096, torch.bfloat16),
                "float16": (512, torch.float16)}.get(case, (512, torch.bfloat16))
    x, w, b = _inputs(6, d, dtype, "cuda")
    if case == "bf16_weight":
        w = w.bfloat16()
    elif case == "misaligned_view":
        x = torch.zeros(6 * d + 4, dtype=dtype, device="cuda")[4:].view(6, d)
    before = ln.layer_norm.launches
    with pytest.raises(ValueError, match="does not take"):
        ln.layer_norm(x, w, b, EPS)
    assert ln.layer_norm.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gradient_equals_plain_on_card(card, dtype):
    x, w, b = _inputs(4 * 77, 512, dtype, "cuda", seed=3)
    x = x.reshape(4, 77, 512)
    dy = torch.randn(4, 77, 512, device="cuda").to(dtype)
    grads = []
    for fn in (ln.layer_norm, ln.layer_norm_reference):
        leaves = [t.detach().clone().requires_grad_() for t in (x, w, b)]
        (fn(*leaves, EPS) * dy).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert torch.equal(got, want)


@pytest.mark.parametrize("name,want", [("ViT-L/14@336px", 50), ("ViT-B/32", 26)])
def test_image_batch_launch_count_on_card(card, name, want):
    from debiasing_multi_modal_tpu_torch.models import create_clip

    model = create_clip(name, dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    res = model.config.image_resolution
    images = torch.randn(2, res, res, 3, device="cuda")
    assert want == 2 * model.config.vision_layers + 2  # ln_pre, ln_1 and ln_2 a block, ln_post
    before = ln.layer_norm.launches
    with torch.inference_mode():
        emb = model.encode_image(images)
    torch.cuda.synchronize()
    assert ln.layer_norm.launches - before == want
    assert torch.isfinite(emb.float()).all()
