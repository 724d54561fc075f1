"""Which serving kernel each call takes: ``bias_attention_fwd_route`` for
every attention shape a ``Config()`` serving request sends (the shapes
``chip_smoke.py`` lists, at every code and prompt bucket of
``EngineConfig()``) and for the shapes that stay on ``serve_fwd_mma``; and
the per-route launch counts, which the plain CPU route leaves alone.

The C entry of the same name decides on the card and names the route that
is counted; the card test ``test_route_entry_matches_the_python_mirror``
(``tests/test_torch_kernel_cuda.py``) holds the two equal over every T % 8
and head dim.
"""
import math

import pytest
import torch

from chip_smoke import serving_attention_shapes
from detail_tts_tpu_torch.config import Config
from detail_tts_tpu_torch.ops import attention
from detail_tts_tpu_torch.serving.pipeline import EngineConfig

ECFG = EngineConfig()
HOP = Config().data.hop_length


@pytest.mark.parametrize("prompt_bucket", ECFG.prompt_buckets)
@pytest.mark.parametrize("code_bucket", ECFG.code_buckets)
def test_every_served_shape_takes_its_route(code_bucket, prompt_bucket):
    cfg = Config()
    ecfg = EngineConfig(max_generate_length=code_bucket + 1)
    shapes = serving_attention_shapes(cfg, ecfg, batches=(1, 2, 8),
                                      prompt_frames=prompt_bucket)
    d = cfg.diffusion.model_channels // cfg.diffusion.num_heads
    assert d == 48
    for b, t, h, hd in shapes:
        got = attention.bias_attention_fwd_route(t, hd, torch.bfloat16)
        if hd == 2 * d:  # the contextual embedder: every prompt bucket's T % 8 == 0
            assert (t, got) == (prompt_bucket // 4, "serve_fwd_wgmma")
        elif t == 4 * code_bucket:  # the integrator (B + 1 rows) and the trunk (2B)
            assert b in (2, 3, 4, 9, 16) and got == "serve_fwd_wgmma"
        else:  # the latent conditioner at the code bucket: TMA needs T % 8 == 0
            assert t == code_bucket
            assert got == ("serve_fwd_wgmma" if code_bucket % 8 == 0 else "serve_fwd_mma")
        assert attention.bias_attention_fwd_route(t, hd, torch.float32) == "bias_attention_simt"


@pytest.mark.parametrize("t,d", [(100, 48), (300, 48), (500, 48), (1597, 48), (1, 48),
                                 (63, 16), (127, 32), (129, 64), (130, 48), (130, 96),
                                 (1597, 96), (1600, 80), (1600, 112), (1600, 128)])
def test_shapes_that_stay_on_serve_fwd_mma(t, d):
    assert attention.bias_attention_fwd_route(t, d, torch.bfloat16) == "serve_fwd_mma"


@pytest.mark.parametrize("t,d", [(8, 16), (64, 32), (96, 48), (1600, 48), (2400, 48),
                                 (200, 64), (16, 96), (400, 96), (1600, 96)])
def test_shapes_on_serve_fwd_wgmma(t, d):
    assert attention.bias_attention_fwd_route(t, d, torch.bfloat16) == "serve_fwd_wgmma"


def test_route_refuses_other_dtypes():
    with pytest.raises(TypeError):
        attention.bias_attention_fwd_route(1600, 48, torch.float16)


def test_cpu_calls_count_no_launch():
    """The plain version on the CPU is no kernel launch, on any route."""
    before = (attention.LAUNCHES, dict(attention.LAUNCHES_BY_ROUTE))
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn((2, 64, 3 * 4 * 48), generator=g).to(torch.bfloat16)
    bias = torch.randn((4, 64, 64), generator=g).to(torch.bfloat16)
    out = attention.bias_attention(qkv, bias, heads=4, sm_scale=1 / math.sqrt(48),
                                   bias_log2=True)
    assert out.shape == (2, 64, 4 * 48)
    assert (attention.LAUNCHES, attention.LAUNCHES_BY_ROUTE) == before
    assert set(attention.LAUNCHES_BY_ROUTE) == set(attention.SERVE_ROUTES)
