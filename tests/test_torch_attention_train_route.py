"""Which kernel each training forward call takes:
``bias_attention_train_fwd_route`` for every attention shape a ``Config()``
``diff`` or ``all`` step sends (synthetic 496-frame batches, and every raw
bucket of the data loader with its code length and both prompt crops), at
batches of 1 to 9 and 16, on an H100's 132 SMs, and for the shapes that
stay on ``train_fwd_mma`` or the scalar kernel; and the per-route counts,
which the plain CPU route leaves alone.

The C entry of the same name decides on the card and names the route that
is counted; the card test
``test_train_fwd_route_entry_matches_the_python_mirror``
(``tests/test_torch_kernel_cuda.py``) holds the two equal.
"""
import pytest
import torch

from chip_smoke import expected_train_fwd_routes, train_attention_shapes
from detail_tts_tpu_torch.config import Config
from detail_tts_tpu_torch.data.dataset import BucketSpec
from detail_tts_tpu_torch.ops import attention

BUCKETS = BucketSpec()
SMS = 132  # an H100 SXM's


def route(b, t, h, d, dtype=torch.bfloat16):
    return attention.bias_attention_train_fwd_route(b, t, h, d, dtype, SMS)


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
        assert b == batch and h == cfg.diffusion.num_heads == 16
        got = route(b, t, h, hd)
        # train_fwd_wgmma's 128-row CTAs fill at least half the SMs
        half_card = 2 * b * -(-t // 128) * h >= SMS
        if hd == 2 * d:  # the contextual embedder: d = 96 on wgmma at every grid
            assert t == -(-prompt_frames // 4)
            assert got == ("train_fwd_wgmma" if t % 4 == 0 else "train_fwd_mma")
        elif t == raw_frames:  # the trunk and the integrator
            assert got == ("train_fwd_wgmma" if half_card else "train_fwd_mma")
            assert got == "train_fwd_wgmma" or b < 3  # (1, 496), (2, 256) and such
        else:  # the latent conditioner at the code length: TMA needs T % 4 == 0
            assert t == raw_frames // 4
            assert got == ("train_fwd_wgmma" if t % 4 == 0 and half_card else "train_fwd_mma")
        assert route(b, t, h, hd, torch.float32) == "train_fwd_simt"


def test_the_step_routes_its_calls():
    """One synthetic ``diff`` micro-batch (8 x 496 frames) with every trunk
    layer kept: every call on ``train_fwd_wgmma``, the contextual embedder's
    d = 96 too; at the largest raw bucket with the 500-frame crop the latent
    conditioner (706 codes) and the contextual embedder (T = 125) take
    ``train_fwd_mma``; a world-2 rank's micro-batch of 4 keeps the trunk and
    the contextual embedder and moves the latent conditioner (64 CTAs) to
    ``train_fwd_mma``, as does batch 1 the trunk."""
    cfg = Config()
    kept = [[True] * cfg.diffusion.num_layers]
    n = 3 + cfg.diffusion.num_layers
    assert expected_train_fwd_routes(cfg, kept, 8, 496, 496, SMS) == {
        "train_fwd_wgmma": n + 4 + 5, "train_fwd_mma": 0, "train_fwd_simt": 0}
    assert expected_train_fwd_routes(cfg, kept * 2, 8, 2824, 500, SMS) == {
        "train_fwd_wgmma": 2 * n, "train_fwd_mma": 2 * (4 + 5), "train_fwd_simt": 0}
    assert expected_train_fwd_routes(cfg, kept, 16, 496, 496, SMS) == \
        expected_train_fwd_routes(cfg, kept, 8, 496, 496, SMS)
    assert expected_train_fwd_routes(cfg, kept, 4, 496, 496, SMS) == {
        "train_fwd_wgmma": n + 5, "train_fwd_mma": 4, "train_fwd_simt": 0}
    assert expected_train_fwd_routes(cfg, kept, 1, 496, 496, SMS) == {
        "train_fwd_wgmma": 5, "train_fwd_mma": n + 4, "train_fwd_simt": 0}
    dropped = [[i % 2 == 0 for i in range(cfg.diffusion.num_layers)]]
    got = expected_train_fwd_routes(cfg, dropped, 8, 496, 496, SMS)
    assert got["train_fwd_wgmma"] == 3 + sum(dropped[0]) + 4 + 5


@pytest.mark.parametrize("t,d", [(495, 48), (706, 48), (125, 48), (1, 16), (2, 32), (3, 64),
                                 (97, 48), (125, 96), (495, 96), (1024, 80), (2824, 112),
                                 (512, 128)])
def test_shapes_that_stay_on_train_fwd_mma(t, d):
    for b in (1, 8, 9):
        assert route(b, t, 16, d) == "train_fwd_mma"


@pytest.mark.parametrize("b,t,h", [(1, 496, 16), (2, 256, 16), (2, 124, 16), (4, 124, 16),
                                   (8, 124, 8), (1, 4, 65), (3, 64, 4)])
def test_grids_under_half_the_card_stay_on_train_fwd_mma(b, t, h):
    """The small grids that train_fwd_mma's 64-row CTAs ran faster (PERF.md
    §6), and their edge: 65 CTAs of 128 rows on 132 SMs."""
    assert route(b, t, h, 48) == "train_fwd_mma"


@pytest.mark.parametrize("t,d", [(4, 16), (64, 32), (96, 48), (124, 48), (132, 64),
                                 (496, 48), (512, 48), (1024, 48), (2824, 48), (124, 96),
                                 (496, 96)])
def test_shapes_on_train_fwd_wgmma(t, d):
    for b in (8, 9, 16, 64):
        assert route(b, t, 16, d) == "train_fwd_wgmma"
    assert route(1, t, 66, d) == "train_fwd_wgmma"  # 66 CTAs or more, half of 132


@pytest.mark.parametrize("b,t,h", [(1, 124, 16), (2, 124, 16), (4, 124, 16), (8, 124, 16),
                                   (1, 4, 1)])
def test_d96_takes_train_fwd_wgmma_at_every_grid(b, t, h):
    """The contextual embedder's d = 96 on train_fwd_wgmma's 64-row CTAs at
    every grid: in turns they beat train_fwd_mma<96, 1> at a data-parallel
    rank's (4, 124) and (2, 124) too (PERF.md §6)."""
    assert route(b, t, h, 96) == "train_fwd_wgmma"


@pytest.mark.parametrize("t,d", [(1, 16), (124, 48), (495, 96), (496, 128)])
def test_fp32_takes_the_scalar_kernel(t, d):
    assert route(8, t, 16, d, torch.float32) == "train_fwd_simt"


def test_route_refuses_other_dtypes_and_empty_shapes():
    with pytest.raises(TypeError):
        route(8, 496, 16, 48, torch.float16)
    for b, t, h in ((0, 496, 16), (8, 0, 16), (8, 496, 0)):
        with pytest.raises(ValueError):
            route(b, t, h, 48)


def test_cpu_forward_counts_no_launch():
    """The plain forward on the CPU is no kernel launch, on any route."""
    before = (dict(attention.TRAIN_LAUNCHES), dict(attention.TRAIN_FWD_LAUNCHES_BY_ROUTE))
    g = torch.Generator().manual_seed(0)
    for t in (64, 62):  # T % 4 == 0 and not
        qkv = torch.randn((2, t, 3 * 4 * 48), generator=g)
        bias = torch.randn((4, t, t), generator=g)
        out, lse = attention.bias_attention_train_fwd(qkv, bias, heads=4, sm_scale=0.2)
        assert out.shape == (2, t, 4 * 48) and lse.shape == (2, 4, t)
    assert (attention.TRAIN_LAUNCHES, attention.TRAIN_FWD_LAUNCHES_BY_ROUTE) == before
    assert set(attention.TRAIN_FWD_LAUNCHES_BY_ROUTE) == set(attention.TRAIN_FWD_ROUTES)
