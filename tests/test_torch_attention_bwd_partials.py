"""The plain version of the kernels' dbias route (one dX partial per batch
row, then a sum in batch order) against ``jax.grad`` of the Pallas
``attention_train_padded`` in interpret mode and against the plain
backward's dbias; the sum pass's wrapper on the CPU.

Tolerances: against JAX the JAX suite's own for its trainable kernel
(gradients atol 5e-4 / rtol 1e-3, as tests/test_attention_train.py); against
the plain backward 1e-6, the same fp32 dX summed over the batch in another
order.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detail_tts_tpu.ops.pallas.attention import attention_train_padded
from detail_tts_tpu_torch.ops import attention as port_attn
from tests.torch_parity import t

GRAD_TOL = dict(atol=5e-4, rtol=1e-3)
SUM_TOL = dict(atol=1e-6, rtol=1e-6)


def _inputs(b, h, n, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, n, d)).astype(np.float32) for _ in range(3))
    bias = rng.normal(0, 2, size=(h, n, n)).astype(np.float32)
    ct = rng.normal(size=(b, h, n, d)).astype(np.float32)
    return q, k, v, bias, ct


def _port_partials(q, k, v, bias, ct, sm_scale):
    """(partials (B, H, T, T), plain backward's dbias) for loss sum(out*ct)."""
    b, h, n, d = q.shape
    qkv = t(np.stack([q, k, v], axis=3).transpose(0, 2, 1, 3, 4).reshape(b, n, 3 * h * d))
    tb = t(bias)
    out, lse = port_attn.bias_attention_train_fwd(qkv, tb, heads=h, sm_scale=sm_scale)
    dout = t(ct.transpose(0, 2, 1, 3).reshape(b, n, h * d))
    part = port_attn.bias_attention_dbias_partials_reference(qkv, tb, out, lse, dout,
                                                             heads=h, sm_scale=sm_scale)
    _, dbias = port_attn.bias_attention_bwd_reference(qkv, tb, out, lse, dout, heads=h,
                                                      sm_scale=sm_scale)
    return part, dbias


@pytest.mark.parametrize("b", [1, 2, 3])
def test_partials_route_matches_pallas_dbias(b):
    h, n, d = 2, 37, 16  # ragged T: the Pallas wrapper pads it to its block
    q, k, v, bias, ct = _inputs(b, h, n, d, seed=b)
    sm = 1.0 / math.sqrt(d)

    def loss(bias):
        out = attention_train_padded(*(jnp.asarray(x) for x in (q, k, v)), bias,
                                     sm_scale=sm, block_q=16, interpret=True)
        return jnp.sum(out * jnp.asarray(ct))

    ref = np.asarray(jax.grad(loss)(jnp.asarray(bias)))
    part, _ = _port_partials(q, k, v, bias, ct, sm)
    assert part.shape == (b, h, n, n) and part.dtype == torch.float32
    dbias = port_attn.bias_attention_dbias_sum_reference(part)
    np.testing.assert_allclose(dbias.numpy(), ref, **GRAD_TOL)


@pytest.mark.parametrize("b,n", [(1, 40), (2, 37), (3, 64), (3, 70)])
def test_partials_route_matches_plain_backward_dbias(b, n):
    q, k, v, bias, ct = _inputs(b, 3, n, 32, seed=10 + n)
    part, dbias = _port_partials(q, k, v, bias, ct, 0.2)
    ours = port_attn.bias_attention_dbias_sum_reference(part)
    np.testing.assert_allclose(ours.numpy(), dbias.numpy(), **SUM_TOL)
    assert np.abs(dbias.numpy()).max() > 1e-3


def test_sum_pass_adds_in_batch_order_and_reads_the_padded_partials():
    n = 37
    tp = port_attn.padded_len(n)
    assert (tp, port_attn.padded_len(64), port_attn.padded_len(65)) == (64, 64, 128)
    part = torch.randn(3, 2, tp, tp, generator=torch.Generator().manual_seed(0))
    part[..., n:, :] = float("nan")  # the padding never reaches dbias
    part[..., n:] = float("nan")
    dbias = port_attn.bias_attention_dbias_sum(part, n)
    x = part[:, :, :n, :n]
    assert torch.equal(dbias, (x[0] + x[1]) + x[2])
    assert torch.equal(dbias, port_attn.bias_attention_dbias_sum_reference(x))
    before = dict(port_attn.TRAIN_LAUNCHES)
    with pytest.raises(ValueError):  # partials not padded to a whole tile
        port_attn.bias_attention_dbias_sum(x.contiguous(), n)
    with pytest.raises(ValueError):  # not fp32
        port_attn.bias_attention_dbias_sum(part.double(), n)
    assert port_attn.TRAIN_LAUNCHES == before  # the CPU runs the plain version
