"""The trainable bias attention (``BiasAttentionFunction``; on the CPU its
plain forward and backward) against ``jax.grad`` of the Pallas
``attention_train_padded`` in interpret mode and against torch autograd
through the plain forward; the masked-key and masked-row contracts; and the
serving wrapper's refusal of inputs that require grad.

Tolerances are the JAX suite's own for its trainable kernel
(tests/test_attention_train.py): out atol 2e-5 / rtol 1e-4, gradients
atol 5e-4 / rtol 1e-3.
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

OUT_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=5e-4, rtol=1e-3)


def _pack(q, k, v):
    """(B, H, T, D) x3 -> (B, T, 3*H*D), channel order [head][q|k|v][ch]."""
    b, h, n, d = q.shape
    return np.stack([q, k, v], axis=3).transpose(0, 2, 1, 3, 4).reshape(b, n, 3 * h * d)


def _heads(x, h):
    """(B, T, H*D) -> (B, H, T, D)."""
    b, n, c = x.shape
    return x.reshape(b, n, h, c // h).transpose(0, 2, 1, 3)


def _inputs(b, h, n, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, n, d)).astype(np.float32) for _ in range(3))
    bias = rng.normal(0, 2, size=(h, n, n)).astype(np.float32)
    ct = rng.normal(size=(b, h, n, d)).astype(np.float32)
    return q, k, v, bias, ct


def _port_grads(q, k, v, bias, ct, sm_scale, fn=None):
    """Port output (B, H, T, D) and (dq, dk, dv, dbias) for loss sum(out*ct)."""
    h, d = q.shape[1], q.shape[3]
    qkv = t(_pack(q, k, v)).requires_grad_(True)
    tb = t(bias).requires_grad_(True)
    if fn is None:
        out = port_attn.bias_attention_train(qkv, tb, heads=h, sm_scale=sm_scale)
    else:
        out = fn(qkv, tb)
    ct_p = t(ct.transpose(0, 2, 1, 3).reshape(out.shape))
    (out * ct_p).sum().backward()
    g = qkv.grad.numpy().reshape(q.shape[0], q.shape[2], h, 3, d)
    dq, dk, dv = (g[:, :, :, i].transpose(0, 2, 1, 3) for i in range(3))
    return _heads(out.detach().numpy(), h), (dq, dk, dv, tb.grad.numpy())


@pytest.mark.parametrize("d", [16, 96])  # a narrow head; the contextual embedder's
@pytest.mark.parametrize("n", [40, 37])
def test_forward_and_grads_match_pallas_attention_train(n, d):
    b, h = 2, 2
    q, k, v, bias, ct = _inputs(b, h, n, d, seed=n)
    sm = 1.0 / math.sqrt(d)
    jq, jk, jv, jb = (jnp.asarray(x) for x in (q, k, v, bias))

    def loss(q, k, v, bias):
        out = attention_train_padded(q, k, v, bias, sm_scale=sm, block_q=16,
                                     interpret=True)
        return jnp.sum(out * jnp.asarray(ct)), out

    (_, ref_out), ref_grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                                 has_aux=True)(jq, jk, jv, jb)
    out, grads = _port_grads(q, k, v, bias, ct, sm)
    np.testing.assert_allclose(out, np.asarray(ref_out), **OUT_TOL)
    for name, ours, ref in zip(("dq", "dk", "dv", "dbias"), grads, ref_grads):
        np.testing.assert_allclose(ours, np.asarray(ref), err_msg=name, **GRAD_TOL)


def test_plain_backward_matches_autograd_through_plain_forward():
    b, h, n, d = 2, 3, 45, 32
    q, k, v, bias, ct = _inputs(b, h, n, d, seed=3)
    sm = 1.0 / math.sqrt(d)

    def plain(qkv, tb):
        return port_attn.bias_attention_train_reference(qkv, tb, heads=h,
                                                        sm_scale=sm)[0]

    out_a, grads_a = _port_grads(q, k, v, bias, ct, sm, fn=plain)
    out_f, grads_f = _port_grads(q, k, v, bias, ct, sm)
    np.testing.assert_allclose(out_f, out_a, **OUT_TOL)
    for name, ours, ref in zip(("dq", "dk", "dv", "dbias"), grads_f, grads_a):
        np.testing.assert_allclose(ours, ref, err_msg=name, **GRAD_TOL)
    assert all(np.abs(g).max() > 1e-3 for g in grads_f)


def test_masked_keys_give_zero_dk_dv_rows_and_masked_rows_give_zero():
    b, h, n, d = 2, 2, 24, 16
    q, k, v, bias, ct = _inputs(b, h, n, d, seed=5)
    bias[:, :, n // 2:] = -1e9  # keys of the second half masked in every row
    bias[1, 7, :] = -1e9        # head 1, query 7: every key masked
    out, (dq, dk, dv, dbias) = _port_grads(q, k, v, bias, ct, 0.25)
    for g in (out, dq, dk, dv, dbias):
        assert np.isfinite(g).all()
    assert np.count_nonzero(dv[:, :, n // 2:]) == 0
    assert np.count_nonzero(dk[:, :, n // 2:]) == 0
    assert np.abs(dv[:, :, :n // 2]).sum() > 0
    assert np.count_nonzero(out[:, 1, 7]) == 0
    assert np.count_nonzero(dq[:, 1, 7]) == 0
    assert np.count_nonzero(dbias[1, 7]) == 0
    lse = port_attn.bias_attention_train_fwd(t(_pack(q, k, v)), t(bias), heads=h,
                                             sm_scale=0.25)[1]
    assert float(lse[0, 1, 7]) == np.float32(port_attn.MASKED_LSE)


def test_serving_wrapper_raises_on_inputs_that_require_grad():
    for device in ("cpu", "meta"):
        qkv = torch.zeros(1, 8, 96, device=device, requires_grad=True)
        bias = torch.zeros(2, 8, 8, device=device)
        with pytest.raises(RuntimeError, match="no backward"):
            port_attn.bias_attention(qkv, bias, heads=2, sm_scale=1.0)
        with pytest.raises(RuntimeError, match="no backward"):
            port_attn.bias_attention(qkv.detach(), bias.requires_grad_(True),
                                     heads=2, sm_scale=1.0)
    with torch.no_grad():  # outside grad mode the same inputs are served
        out = port_attn.bias_attention(torch.zeros(1, 8, 96, requires_grad=True),
                                       torch.zeros(2, 8, 8), heads=2, sm_scale=1.0)
    assert out.shape == (1, 8, 32)


def test_cpu_training_route_counts_no_launches():
    before = dict(port_attn.TRAIN_LAUNCHES)
    _port_grads(*_inputs(1, 2, 16, 16, seed=0), 0.25)
    assert port_attn.TRAIN_LAUNCHES == before
    with pytest.raises(TypeError):  # the training bias is fp32 only
        port_attn.bias_attention_train(torch.zeros(1, 8, 96), torch.zeros(2, 8, 8).double(),
                                       heads=2, sm_scale=1.0)


@pytest.mark.parametrize("n", [37, 124])
def test_t5_bias_gather_backward_matches_indexing(n):
    """The T5 bias's one-hot backward gives the plain gather's gradient
    (fp32 sums of up to ~7,000 terms a bucket, in another order)."""
    from detail_tts_tpu_torch.nn.diff_blocks import (T5RelativePositionBias,
                                                     relative_position_bucket)
    torch.manual_seed(n)
    rel = T5RelativePositionBias(scale=2.0, heads=4, max_distance=64)
    table = rel.relative_attention_bias.weight
    ct = torch.randn(4, n, n)
    bias = rel(n)
    bias.backward(ct)
    pos = torch.arange(n)
    buckets = relative_position_bucket(pos[None, :] - pos[:, None], 32, 64)
    w = table.detach().clone().requires_grad_(True)
    ref = w.t()[:, buckets] * 2.0
    ref.backward(ct)
    assert torch.equal(bias, ref) and bias.is_contiguous()
    torch.testing.assert_close(table.grad, w.grad, atol=1e-4, rtol=1e-4)
