"""Ring and Ulysses attention (``ops/{ring,ulysses}_attention.py``) on 4
gloo ranks held against the JAX package's ``sequence_parallel_attention``
and ``ulysses_sequence_parallel_attention`` on its 8-device CPU mesh (4 of
its devices): outputs within 2e-5, the gradients of ``(out * dout).sum()``
within 2e-4 (the JAX suite's ``tests/test_ring_attention.py:76``), causal
and not, over the sequence axis alone and on a dp x sp mesh; and the JAX
wrappers' ``ValueError``s; and ``multihost.global_batch``."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from debiasing_multi_modal_tpu.ops.ring_attention import sequence_parallel_attention
from debiasing_multi_modal_tpu.ops.ulysses_attention import ulysses_sequence_parallel_attention
from debiasing_multi_modal_tpu.parallel.mesh import make_mesh as jax_mesh
from debiasing_multi_modal_tpu_torch.parallel import multihost

import torch_parallel_worker as worker

JAX = {"ring": sequence_parallel_attention, "ulysses": ulysses_sequence_parallel_attention}
# label -> (kind, mesh shape, axis names, batch axis, causal)
CASES = {f"{kind}_{mesh}_{'causal' if causal else 'full'}": (
    kind, shape, names, "data" if len(shape) == 2 else None, causal)
    for kind in JAX for causal in (False, True)
    for mesh, shape, names in (("sp4", (4,), ("seq",)), ("dp2xsp2", (2, 2), ("data", "seq")))}


def _inputs(label):
    rng = np.random.default_rng(zlib.crc32(label.encode()))
    return [rng.standard_normal((4, 16, 4, 8)).astype(np.float32) for _ in range(4)]


@pytest.fixture(scope="module")
def ranks():
    cases = [(label, *spec, *_inputs(label))
             for label, spec in CASES.items()]
    return multihost.launch(worker.sequence_parallel, 4, args=(cases,), timeout_s=240)


def _jax(label):
    kind, shape, names, batch_axis, causal = CASES[label]
    q, k, v, dout = (jnp.asarray(x) for x in _inputs(label))
    devices = jax.devices()[:4]
    mesh = jax_mesh(shape, names, devices=devices)

    def loss(q, k, v):
        o = JAX[kind](q, k, v, mesh=mesh, axis_name="seq", causal=causal,
                      batch_axis=batch_axis)
        return (o * dout).sum(), o

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("label", sorted(CASES))
def test_matches_jax(ranks, label):
    out_ref, grads_ref = _jax(label)
    for rank in ranks:  # every rank returns the global output and gradients
        out, grads = rank[label]
        np.testing.assert_allclose(out, out_ref, rtol=2e-5, atol=2e-5)
        for g, r in zip(grads, grads_ref):
            np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-4)


def test_global_batch_assembles_the_ranks_rows_in_order(ranks):
    """``multihost.global_batch``: every rank passes its own two rows; each
    gets the four ranks' rows in rank order."""
    for rank in ranks:
        np.testing.assert_array_equal(rank["global_batch"], np.arange(8))


def test_value_errors_match_jax(ranks):
    """S not divisible by the axis, heads not divisible (Ulysses), not
    [B, S, H, D]: the JAX wrappers' messages."""
    mesh = jax_mesh((4,), ("seq",), devices=jax.devices()[:4])
    want = []
    for fn, shape in ((sequence_parallel_attention, (1, 6, 2, 4)),
                      (ulysses_sequence_parallel_attention, (1, 8, 3, 4)),
                      (sequence_parallel_attention, (1, 8, 2))):
        x = jnp.zeros(shape)
        with pytest.raises(ValueError) as err:
            fn(x, x, x, mesh=mesh, axis_name="seq")
        want.append(str(err.value))
    assert ranks[0]["errors"] == want
