"""The bias-attention CUDA kernels against their plain versions, on the card:
the serving forward, and the training forward (with its row statistic) and
the three backward kernels (delta, dq and the dbias partials; dk and dv; the
partials' sum) behind ``BiasAttentionFunction``.

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
# the row statistic: fp32 in both dtypes, from logits summed in another order
LSE_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-4}
# dbias relative to max |plain|: summed in fp32 from fp32 P and dX in both
# dtypes (chip_smoke.py's gate; a dbias with one batch row lost reads above)
DBIAS_TOL = 1e-4


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
# T at the bf16 kernel's tile edges (127-129: one 128-row CTA or two), at its
# bias-copy widths (8-byte copies at 100 and 300, 16-byte at 128 and 1600,
# single values at odd T and at 130) and at the trunk's length
@pytest.mark.parametrize("b,t", [(1, 1), (3, 63), (2, 130), (5, 257), (2, 127), (2, 128),
                                 (2, 129), (2, 100), (2, 300), (2, 1600), (2, 1597)])
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


def test_serving_kernel_fits_on_an_sm(cuda):
    lib = attention._library(attention.SOURCE)
    assert lib.bias_attention_fwd_blocks_per_sm(48) >= 2
    assert lib.bias_attention_fwd_blocks_per_sm(128) >= 1


def test_train_forward_fits_on_an_sm(cuda):
    lib = attention._library(attention.SOURCE)
    assert lib.bias_attention_train_fwd_blocks_per_sm(48) >= 2
    assert lib.bias_attention_train_fwd_blocks_per_sm(128) >= 1


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


def _train_inputs(b, t, h, d, dtype, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((b, t, 3 * h * d), generator=g, device=device).to(dtype)
    bias = torch.randn((h, t, t), generator=g, device=device)
    dout = torch.randn((b, t, h * d), generator=g, device=device).to(dtype)
    return qkv, bias, dout


def scaled_err(x, ref):
    """max |x - ref| over max(1, max |ref|): gradients are compared relative
    to their own size, so one tolerance holds for every shape."""
    ref = ref.float()
    return ((x.float() - ref).abs().max() / ref.abs().max().clamp_min(1.0)).item()


def dbias_err(x, ref):
    """max |x - ref| over max |ref|."""
    return ((x - ref).abs().max() / ref.abs().max()).item()


def _check_train(qkv, bias, dout, h, d, dtype):
    sm = 1 / math.sqrt(d)
    before = dict(attention.TRAIN_LAUNCHES)
    out, lse = attention.bias_attention_train_fwd(qkv, bias, heads=h, sm_scale=sm)
    ref_out, ref_lse = attention.bias_attention_train_reference(qkv, bias, heads=h,
                                                                sm_scale=sm)
    dqkv, dbias = attention.bias_attention_bwd(qkv, bias, out, lse, dout, heads=h,
                                               sm_scale=sm)
    ref_dqkv, ref_dbias = attention.bias_attention_bwd_reference(
        qkv, bias, out, lse, dout, heads=h, sm_scale=sm)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in attention.TRAIN_LAUNCHES.items()} == {
        "bias_attention_train_fwd": 1, "bias_attention_bwd_dq_dbias": 1,
        "bias_attention_bwd_dkv": 1, "bias_attention_bwd_dbias_sum": 1}
    assert out.dtype == dqkv.dtype == dtype and dbias.dtype == torch.float32
    assert (out.float() - ref_out.float()).abs().max().item() <= TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL[dtype]
    assert scaled_err(dqkv, ref_dqkv) <= TOL[dtype]
    assert scaled_err(dbias, ref_dbias) <= TOL[dtype]
    return out, lse, dqkv, dbias


def _heads_to_fill(b, t):
    """Heads enough for the bf16 training forward's 128-row CTAs (d <= 64)
    to fill every SM, so that they are the ones launched (a grid of fewer
    takes 64-row CTAs)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return -(-sms // (b * -(-t // 128)))


@pytest.mark.parametrize("dtype,rows", [(torch.bfloat16, 64), (torch.float32, 64),
                                        (torch.bfloat16, 128)])
@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 112, 128])
# T at the training forward's tile edges (63-65 and 127-129: one CTA's
# rows or two), at its bias-copy widths (16-byte at 100, 124 and 128,
# 8-byte at 130, 4-byte at odd T) and at the step's conditioner length 124
@pytest.mark.parametrize("b,t", [(1, 1), (3, 63), (2, 130), (2, 257), (2, 127), (2, 128),
                                 (2, 129), (2, 100), (2, 124), (3, 65)])
def test_train_kernels_match_plain_versions(cuda, dtype, rows, d, b, t):
    h = 4 if rows == 64 else _heads_to_fill(b, t)
    qkv, bias, dout = _train_inputs(b, t, h, d, dtype, seed=d * t + b, device=cuda)
    _check_train(qkv, bias, dout, h, d, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [96, 97])
def test_train_kernels_masked_rows_and_keys(cuda, dtype, t):
    b, h, d = 2, 4, 48
    qkv, bias, dout = _train_inputs(b, t, h, d, dtype, seed=t, device=cuda)
    bias[1, 5, :] = -1e9       # a fully masked query row
    bias[2, :, t - 9:] = -1e9  # masked keys in every row of head 2
    out, lse, dqkv, dbias = _check_train(qkv, bias, dout, h, d, dtype)
    for x in (out, lse, dqkv, dbias):
        assert torch.isfinite(x).all()
    assert torch.count_nonzero(out[:, 5, d:2 * d]).item() == 0
    assert torch.count_nonzero(dqkv[:, 5, 3 * d:4 * d]).item() == 0  # dq, head 1
    assert torch.count_nonzero(dbias[1, 5]).item() == 0
    dk_dv = dqkv.view(b, t, h, 3, d)[:, t - 9:, 2, 1:]
    assert torch.count_nonzero(dk_dv).item() == 0


@pytest.mark.parametrize("d", [48, 96])
@pytest.mark.parametrize("t", [496, 495])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_train_kernels_at_the_step_shapes(cuda, b, t, d):
    """The batch split over CTAs and the sum of the partials at the training
    step's lengths and head widths, 16 heads, bf16."""
    h = 16
    qkv, bias, dout = _train_inputs(b, t, h, d, torch.bfloat16, seed=b * t + d, device=cuda)
    out, lse, dqkv, dbias = _check_train(qkv, bias, dout, h, d, torch.bfloat16)
    _, ref_dbias = attention.bias_attention_bwd_reference(
        qkv, bias, out, lse, dout, heads=h, sm_scale=1 / math.sqrt(d))
    assert dbias_err(dbias, ref_dbias) <= DBIAS_TOL


def test_dbias_gate_catches_a_lost_batch_row(cuda):
    b, t, h, d = 8, 496, 16, 48
    qkv, bias, dout = _train_inputs(b, t, h, d, torch.bfloat16, seed=3, device=cuda)
    out, lse = attention.bias_attention_train_fwd(qkv, bias, heads=h, sm_scale=0.2)
    _, dbias = attention.bias_attention_bwd(qkv, bias, out, lse, dout, heads=h, sm_scale=0.2)
    _, ref = attention.bias_attention_bwd_reference(qkv, bias, out, lse, dout, heads=h,
                                                    sm_scale=0.2)
    _, lost = attention.bias_attention_bwd(qkv[:-1], bias, out[:-1], lse[:-1], dout[:-1],
                                           heads=h, sm_scale=0.2)
    assert dbias_err(dbias, ref) <= DBIAS_TOL < dbias_err(lost, ref)


def test_dbias_sum_kernel_matches_plain_sum(cuda):
    b, t, h = 8, 495, 16
    part = torch.randn((b, h, attention.padded_len(t), attention.padded_len(t)),
                       device=cuda)
    got = attention.bias_attention_dbias_sum(part, t)
    want = attention.bias_attention_dbias_sum_reference(part[:, :, :t, :t])
    assert torch.equal(got, want)  # the same fp32 adds in the same order


@pytest.mark.parametrize("b,t,h,d", [(4, 130, 4, 48), (8, 496, 16, 48)])
def test_train_backward_is_deterministic(cuda, b, t, h, d):
    qkv, bias, dout = _train_inputs(b, t, h, d, torch.bfloat16, seed=11, device=cuda)
    out, lse = attention.bias_attention_train_fwd(qkv, bias, heads=h, sm_scale=0.2)
    first = attention.bias_attention_bwd(qkv, bias, out, lse, dout, heads=h, sm_scale=0.2)
    second = attention.bias_attention_bwd(qkv, bias, out, lse, dout, heads=h, sm_scale=0.2)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_autograd_function_runs_the_kernels(cuda):
    b, t, h, d = 2, 70, 4, 32
    qkv, bias, dout = _train_inputs(b, t, h, d, torch.float32, seed=5, device=cuda)
    qkv.requires_grad_(True)
    bias.requires_grad_(True)
    out = attention.bias_attention_train(qkv, bias, heads=h, sm_scale=0.3)
    out.backward(dout)
    q2, b2 = qkv.detach().clone().requires_grad_(True), bias.detach().clone().requires_grad_(True)
    ref = attention.bias_attention_train_reference(q2, b2, heads=h, sm_scale=0.3)[0]
    ref.backward(dout)
    assert (out - ref).abs().max().item() <= TOL[torch.float32]
    assert scaled_err(qkv.grad, q2.grad) <= TOL[torch.float32]
    assert scaled_err(bias.grad, b2.grad) <= TOL[torch.float32]
    with pytest.raises(RuntimeError, match="no backward"):
        attention.bias_attention(qkv, bias, heads=h, sm_scale=0.3)


@pytest.mark.parametrize("sampler", ["ancestral", "ddim", "dpmpp_2m", "dpmpp_2m_karras"])
def test_each_sampler_runs_the_kernel_on_a_small_engine(cuda, sampler):
    """Every sampler's request launches B1 in each attention block of each
    model evaluation (steps x blocks, plus the conditioning's blocks once),
    repeats its audio bit for bit, and the VQ path launches it never."""
    import numpy as np

    from detail_tts_tpu_torch.config import small_test_config
    from detail_tts_tpu_torch.serving.pipeline import EngineConfig, random_engine

    eng = random_engine(small_test_config(), device=cuda, engine_cfg=EngineConfig(
        diffusion_sampler=sampler, max_generate_length=12, text_buckets=(16, 32),
        prompt_buckets=(32, 64), code_buckets=(8, 12)))
    diff = eng.model.diffusion
    want = (eng.schedule.num_timesteps
            * (len(diff.conditioning_timestep_integrator) + eng.cfg.diffusion.num_layers)
            + len(diff.contextual_embedder) - 2 + len(diff.latent_conditioner) - 1)
    rng = np.random.default_rng(0)
    wavs = [rng.uniform(-0.3, 0.3, n).astype(np.float32) for n in (24000, 12077)]
    texts = ["你好，世界。", "ni3 hao3"]
    outs = []
    for _ in range(2):
        before = attention.LAUNCHES
        outs.append(eng.synthesize_batch(texts, wavs, seed=3, force_full=True))
        assert attention.LAUNCHES - before == want
    assert all(o.shape == (11 * 1024,) and np.isfinite(o).all() for o in outs[0])
    assert all(np.array_equal(a, b) for a, b in zip(*outs))
    before = attention.LAUNCHES
    vq = eng.synthesize_vq_batch(texts, wavs, seed=3, force_full=True)
    assert attention.LAUNCHES == before
    assert all(o.shape == (11 * 1024,) and np.isfinite(o).all() for o in vq)


def test_all_step_launches_each_training_kernel_and_repeats(cuda):
    """One small ``all`` GAN step launches each training kernel once for each
    AttentionBlock call (5 contextual-embedder, 4 latent-conditioner and 3
    integrator blocks, and the trunk layers kept), the serving kernel never,
    and repeats bit for bit from the same state and generator state."""
    import dataclasses

    from detail_tts_tpu_torch.config import small_test_config
    from detail_tts_tpu_torch.train.step import (make_gan_step, make_train_state,
                                                 synthetic_batches)

    cfg = small_test_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, target="all"))
    state = make_train_state(cfg, device=cuda, seed=0)
    step = make_gan_step(cfg, device=cuda)
    batch = next(synthetic_batches(cfg, 1, 2, 48, 8, device=cuda,
                                   generator=torch.Generator(device=cuda).manual_seed(1)))
    step(state, batch, torch.Generator(device=cuda).manual_seed(4))  # warm-up
    snap = state.snapshot()
    runs = []
    for _ in range(2):
        state.restore(snap)
        counts, serving = dict(attention.TRAIN_LAUNCHES), attention.LAUNCHES
        m = step(state, batch, torch.Generator(device=cuda).manual_seed(5))
        want = 5 + 4 + 3 + sum(m["layers_kept"][0][:cfg.diffusion.num_layers])
        got = {k: attention.TRAIN_LAUNCHES[k] - counts[k] for k in counts}
        assert len(got) == 4 and all(v == want for v in got.values()), (got, want)
        assert attention.LAUNCHES == serving
        runs.append(m)
    for k, v in runs[0].items():
        if torch.is_tensor(v):
            assert torch.isfinite(v) and torch.equal(v, runs[1][k]), k
