"""Which backward kernels each training call takes:
``bias_attention_bwd_route`` for every attention shape a ``Config()``
``diff`` or ``all`` step sends (synthetic 496-frame batches, and every raw
bucket of the data loader with its code length and both prompt crops), at
batches of 1 to 8 and past them, and for the shapes that stay on the
mma.sync kernels; and the per-route and per-head-dim counts, which the
plain CPU route leaves alone.

The C entry of the same name decides on the card and names the route that
is counted; the card test ``test_bwd_route_entry_matches_the_python_mirror``
(``tests/test_torch_kernel_cuda.py``) holds the two equal.
"""
import pytest
import torch

from chip_smoke import expected_bwd_dims, expected_bwd_routes, train_attention_shapes
from detail_tts_tpu_torch.config import Config
from detail_tts_tpu_torch.data.dataset import BucketSpec
from detail_tts_tpu_torch.ops import attention

BUCKETS = BucketSpec()


@pytest.mark.parametrize("batch", [1, 2, 3, 4, 5, 6, 7, 8, 9, 16])
@pytest.mark.parametrize("raw_frames,prompt_frames",
                         [(496, 496)] + [(t, p) for t in BUCKETS.raw_buckets
                                         for p in (496, 500)])
def test_every_trained_shape_takes_its_route(batch, raw_frames, prompt_frames):
    cfg = Config()
    shapes = train_attention_shapes(cfg, batch, raw_frames, prompt_frames)
    d = cfg.diffusion.model_channels // cfg.diffusion.num_heads
    assert d == 48 and [n for n, _ in shapes] == [None, 4, 5]
    for _, (b, t, h, hd) in shapes:
        assert b == batch and h == cfg.diffusion.num_heads
        got = attention.bias_attention_bwd_route(b, t, hd, torch.bfloat16)
        if hd == 2 * d:  # the contextual embedder at d = 96: TMA needs T % 4 == 0
            assert t == -(-prompt_frames // 4)
            assert got == ("bwd_wgmma" if t % 4 == 0 else "bwd_mma")
        elif t == raw_frames:  # the trunk and the integrator
            assert got == "bwd_wgmma"
        else:  # the latent conditioner at the code length: TMA needs T % 4 == 0
            assert t == raw_frames // 4
            assert got == ("bwd_wgmma" if t % 4 == 0 else "bwd_mma")
        assert attention.bias_attention_bwd_route(b, t, hd, torch.float32) == "bwd_simt"


def test_the_step_routes_its_calls():
    """One synthetic ``diff`` micro-batch (8 x 496 frames) with every trunk
    layer kept: every call on the wgmma kernels, the contextual embedder's
    d = 96 at T = 124 too; at the loader's other crop, 500 frames, the
    latent conditioner and the contextual embedder (T = 125) on the
    mma.sync ones, as the latent conditioner at 706 codes of the largest raw
    bucket; the batch does not change a route."""
    cfg = Config()
    kept = [[True] * cfg.diffusion.num_layers]
    n = 3 + cfg.diffusion.num_layers
    assert expected_bwd_routes(cfg, kept, 8, 496, 496) == {
        "bwd_wgmma": n + 4 + 5, "bwd_mma": 0, "bwd_simt": 0}
    assert expected_bwd_routes(cfg, kept, 8, 500, 500) == {
        "bwd_wgmma": n, "bwd_mma": 4 + 5, "bwd_simt": 0}
    assert expected_bwd_routes(cfg, kept * 2, 8, 2824, 500) == {
        "bwd_wgmma": 2 * n, "bwd_mma": 2 * (4 + 5), "bwd_simt": 0}
    assert expected_bwd_routes(cfg, kept, 16, 496, 496) == expected_bwd_routes(
        cfg, kept, 1, 496, 496)


@pytest.mark.parametrize("shape", [(8, 496, 496), (8, 500, 500), (4, 2824, 500), (1, 1024, 496)])
def test_the_step_counts_its_calls_by_head_dim(shape):
    """The calls of each (route, head dim) in one step, as
    ``attention.BWD_LAUNCHES_BY_DIM`` counts them: the contextual embedder's
    d = 96 apart from the trunk's d = 48, summing to each route's calls."""
    cfg = Config()
    kept = [[True] * cfg.diffusion.num_layers] * 2
    n = 3 + cfg.diffusion.num_layers
    dims = expected_bwd_dims(cfg, kept, *shape)
    routes = expected_bwd_routes(cfg, kept, *shape)
    assert {r: sum(v for (rr, _), v in dims.items() if rr == r) for r in routes} == routes
    ctx = ("bwd_wgmma" if -(-shape[2] // 4) % 4 == 0 else "bwd_mma", 96)
    assert dims[ctx] == 2 * 5
    assert dims["bwd_wgmma", 48] == 2 * (n + (4 if (shape[1] // 4) % 4 == 0 else 0))


@pytest.mark.parametrize("t,d", [(495, 48), (706, 48), (125, 48), (1, 16), (2, 32), (3, 64),
                                 (97, 48), (125, 96), (1024, 80), (2824, 112), (512, 128)])
def test_shapes_that_stay_on_the_mma_kernels(t, d):
    for b in (1, 8, 9):
        assert attention.bias_attention_bwd_route(b, t, d, torch.bfloat16) == "bwd_mma"


@pytest.mark.parametrize("t,d", [(4, 16), (64, 32), (96, 48), (124, 48), (132, 64),
                                 (496, 48), (1024, 48), (2824, 48), (124, 96), (496, 96)])
def test_shapes_on_the_wgmma_kernels(t, d):
    for b in (1, 3, 8, 9, 16, 64):
        assert attention.bias_attention_bwd_route(b, t, d, torch.bfloat16) == "bwd_wgmma"


def test_route_refuses_other_dtypes_and_empty_shapes():
    with pytest.raises(TypeError):
        attention.bias_attention_bwd_route(8, 496, 48, torch.float16)
    with pytest.raises(ValueError):
        attention.bias_attention_bwd_route(0, 496, 48, torch.bfloat16)


def test_cpu_backward_counts_no_launch():
    """The plain backward on the CPU is no kernel launch, on any route."""
    before = (dict(attention.TRAIN_LAUNCHES), dict(attention.BWD_LAUNCHES_BY_ROUTE),
              dict(attention.BWD_LAUNCHES_BY_DIM))
    g = torch.Generator().manual_seed(0)
    b, t, h, d = 2, 64, 4, 48
    qkv = torch.randn((b, t, 3 * h * d), generator=g)
    bias = torch.randn((h, t, t), generator=g)
    dout = torch.randn((b, t, h * d), generator=g)
    out, lse = attention.bias_attention_train_fwd(qkv, bias, heads=h, sm_scale=0.2)
    dqkv, dbias = attention.bias_attention_bwd(qkv, bias, out, lse, dout, heads=h,
                                               sm_scale=0.2)
    assert dqkv.shape == qkv.shape and dbias.shape == bias.shape
    assert (attention.TRAIN_LAUNCHES, attention.BWD_LAUNCHES_BY_ROUTE,
            attention.BWD_LAUNCHES_BY_DIM) == before
    assert set(attention.BWD_LAUNCHES_BY_ROUTE) == set(attention.BWD_ROUTES)
    assert set(attention.BWD_ROUTE_KERNELS) == set(attention.BWD_ROUTES)
