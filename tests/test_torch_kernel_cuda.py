"""The bias-attention CUDA kernel against its plain version, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (sm_90a) and skip elsewhere.
They import nothing of JAX, so on a machine without it run them with the
repository's conftest switched off:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernel_cuda.py
"""
import math

import pytest
import torch

from detail_tts_tpu_torch.ops import attention

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}  # bf16: P is rounded to bf16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU build")
    return torch.device("cuda")


def _inputs(b, t, h, d, dtype, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((b, t, 3 * h * d), generator=g, device=device).to(dtype)
    bias = torch.randn((h, t, t), generator=g, device=device).to(dtype)
    return qkv, bias


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("b,t", [(1, 1), (3, 63), (2, 130), (5, 257)])
def test_kernel_matches_plain_version(cuda, dtype, d, b, t):
    h = 4
    qkv, bias = _inputs(b, t, h, d, dtype, seed=d * t + b, device=cuda)
    before = attention.LAUNCHES
    out = attention.bias_attention(qkv, bias, heads=h, sm_scale=1 / math.sqrt(d))
    ref = attention.bias_attention_reference(qkv, bias, heads=h, sm_scale=1 / math.sqrt(d))
    torch.cuda.synchronize()
    assert attention.LAUNCHES == before + 1
    assert out.dtype == dtype and out.shape == (b, t, h * d)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [96, 97])
def test_fully_masked_rows_are_zero(cuda, dtype, t):
    b, h, d = 2, 4, 48
    qkv, bias = _inputs(b, t, h, d, dtype, seed=t, device=cuda)
    bias[1, 5, :] = -1e9
    bias[3, t - 1, :] = -1e9
    out = attention.bias_attention(qkv, bias, heads=h, sm_scale=1 / math.sqrt(d))
    ref = attention.bias_attention_reference(qkv, bias, heads=h, sm_scale=1 / math.sqrt(d))
    assert torch.count_nonzero(out[:, 5, d:2 * d]).item() == 0
    assert torch.count_nonzero(out[:, t - 1, 3 * d:4 * d]).item() == 0
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


def test_natural_domain_bias_is_scaled_to_log2(cuda):
    b, t, h, d = 2, 80, 4, 32
    qkv, bias = _inputs(b, t, h, d, torch.float32, seed=1, device=cuda)
    out = attention.bias_attention(qkv, bias, heads=h, sm_scale=0.2, bias_log2=False)
    ref = attention.bias_attention_reference(qkv, bias, heads=h, sm_scale=0.2,
                                             bias_log2=False)
    assert (out - ref).abs().max().item() <= TOL[torch.float32]


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    qkv, bias = _inputs(2, 64, 4, 48, torch.bfloat16, seed=0, device=cuda)
    with pytest.raises(ValueError):  # not contiguous
        attention.bias_attention(qkv.transpose(0, 1).contiguous().transpose(0, 1),
                                 bias, heads=4, sm_scale=1.0)
    with pytest.raises(TypeError):  # mixed dtypes
        attention.bias_attention(qkv, bias.float(), heads=4, sm_scale=1.0)
    with pytest.raises(ValueError):  # bias on another device
        attention.bias_attention(qkv, bias.cpu(), heads=4, sm_scale=1.0)
