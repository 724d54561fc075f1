"""The kernel module: the port's ``AttentionBlock`` (its bias attention on the
CPU runs the kernel's plain version) vs the JAX ``AttentionBlock`` with
``use_pallas=True`` and a precomputed log2 bias, i.e. the three Pallas
serving kernels run in interpret mode; plus the masked-row contract against
``row_block_attention`` and the wrapper's input checks."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detail_tts_tpu.ops.pallas.attention import row_block_attention
from detail_tts_tpu_torch.ops import attention as port_attn
from tests.torch_parity import LOG2E, close, japply, synth_pair, t

# (DTTS_ATTN_PACKED, DTTS_ATTN_PAIRED) -> the JAX function reached
PATHS = {"packed_pairs": ("1", "1"), "packed": ("1", "0"), "row_block": ("0", "1")}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("block,T", [("trunk", 48), ("trunk", 37),
                                     ("contextual", 29)])
def test_attention_block_matches_pallas(monkeypatch, path, block, T):
    packed, paired = PATHS[path]
    monkeypatch.setenv("DTTS_ATTN_PACKED", packed)
    monkeypatch.setenv("DTTS_ATTN_PAIRED", paired)
    port = synth_pair()[2]
    if block == "trunk":  # 64 channels, 4 heads of 16
        jblk = lambda m: m.diffusion.layers[1].attn  # noqa: E731
        pblk = port.diffusion.layers[1].attn
    else:  # 128 channels, 4 heads of 32
        jblk = lambda m: m.diffusion.contextual_embedder_attn[2]  # noqa: E731
        pblk = port.diffusion.contextual_embedder[4]
    x = np.random.default_rng(T).normal(size=(3, T, pblk.channels)).astype(np.float32)
    bias = pblk.bias_log2(T)  # log2 domain, as the serving hoist passes it
    ref = japply(lambda m, x, b: jblk(m)(x, None, b, True), jnp.asarray(x),
                 jnp.asarray(bias.numpy()))
    ours = pblk(t(x), bias)
    assert float((ours - t(x)).abs().max()) > 1e-2  # not an identity block
    close(ours, ref)
    close(pblk(t(x)), ours, atol=1e-5)  # bias computed in the block


@pytest.mark.parametrize("d", [64, 96])  # the trunk's kernels' widest, the embedder's
def test_plain_version_matches_row_block_attention_with_masked_row(d):
    rng = np.random.default_rng(0)
    b, h, n = 2, 3, 128
    q, k, v = (rng.normal(size=(b, h, n, d)).astype(np.float32) for _ in range(3))
    bias = rng.normal(size=(h, n, n)).astype(np.float32)
    bias[1, 5, :] = -1e9  # a fully masked query row
    bias[2, :, 100:] = -1e9  # masked key columns
    # the kernel takes d of 64 or 128: zero channels, as JAX's ``attention``
    # pads them, add nothing to q k^T and are sliced off
    d_pad = 64 if d <= 64 else 128
    pad = lambda x: jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, 0), (0, d_pad - d)))  # noqa: E731
    ref = row_block_attention(pad(q), pad(k), pad(v), jnp.asarray(bias),
                              sm_scale=1 / math.sqrt(d), block_q=128, interpret=True,
                              bias_log2=True)[..., :d]
    qkv = np.stack([q, k, v], axis=3).transpose(0, 2, 1, 3, 4).reshape(b, n, 3 * h * d)
    ours = port_attn.bias_attention(t(qkv), t(bias), heads=h,
                                    sm_scale=1 / math.sqrt(d), bias_log2=True)
    close(ours, np.asarray(ref).transpose(0, 2, 1, 3).reshape(b, n, h * d))
    assert torch.count_nonzero(ours[:, 5, d:2 * d]) == 0
    # a natural-domain bias is scaled to log2 inside
    nat = port_attn.bias_attention(t(qkv), t(bias) / LOG2E, heads=h,
                                   sm_scale=1 / math.sqrt(d), bias_log2=False)
    close(nat, ours, atol=1e-5)


def test_plain_version_rounds_p_to_the_input_dtype():
    rng = np.random.default_rng(1)
    qkv = t(rng.normal(size=(2, 40, 3 * 2 * 16)).astype(np.float32))
    bias = t(rng.normal(size=(2, 40, 40)).astype(np.float32))
    f32 = port_attn.bias_attention_reference(qkv, bias, heads=2, sm_scale=0.25)
    bf16 = port_attn.bias_attention_reference(qkv.bfloat16(), bias.bfloat16(),
                                              heads=2, sm_scale=0.25)
    assert bf16.dtype == torch.bfloat16
    close(bf16.float(), f32, atol=3e-2, rtol=3e-2)  # bf16 inputs and P


def test_wrapper_rejects_what_the_kernel_does_not_take():
    qkv = torch.zeros(2, 8, 3 * 2 * 16)
    bias = torch.zeros(2, 8, 8)
    with pytest.raises(ValueError):
        port_attn._check(qkv, torch.zeros(2, 8, 9), heads=2)
    with pytest.raises(ValueError):  # head dim 12
        port_attn._check(torch.zeros(2, 8, 3 * 2 * 12), bias, heads=2)
    with pytest.raises(TypeError):
        port_attn._check(qkv, bias.double(), heads=2)
    with pytest.raises(ValueError):
        port_attn._check(qkv.transpose(0, 1).contiguous().transpose(0, 1), bias, heads=2)
    with pytest.raises(ValueError):
        port_attn.bias_attention(qkv.to("meta"), bias.to("meta"), heads=2, sm_scale=1.0)
    assert port_attn._check(qkv, bias, heads=2) == 16


def test_cpu_path_does_not_count_launches():
    before = port_attn.LAUNCHES
    port_attn.bias_attention(torch.zeros(1, 4, 96), torch.zeros(2, 4, 4),
                             heads=2, sm_scale=1.0)
    assert port_attn.LAUNCHES == before
