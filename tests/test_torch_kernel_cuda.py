"""The CUDA kernels against their plain versions, on the card: the
bias-attention serving forward, and the training forward (with its row
statistic) and the three backward kernels (delta, dq and the dbias partials;
dk and dv; the partials' sum) behind ``BiasAttentionFunction``; the threefry
draws and key buffers (``ops/prng.py``); and the paths that run them: the
samplers, the training steps, and a (1 x 2) sharded engine of two gloo ranks
on the one card.

These tests need an NVIDIA GPU with ``nvcc`` (sm_90a) and skip elsewhere.
They import nothing of JAX, so on a machine without it run them with the
repository's conftest switched off:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernel_cuda.py
"""
import math

import pytest
import torch

from detail_tts_tpu_torch.ops import attention, prng

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


@pytest.mark.parametrize("t", [512, 1024, 2824])
def test_train_kernels_at_the_raw_buckets(cuda, t):
    """The training kernels at the data loader's raw buckets (the smallest,
    the synthetic corpus's and the largest, whose 8 x 16 x 2880^2 fp32
    partials hold 1.06e9 elements), batch 8, 16 heads of 48, bf16."""
    b, h, d = 8, 16, 48
    qkv, bias, dout = _train_inputs(b, t, h, d, torch.bfloat16, seed=t, device=cuda)
    out, lse, dqkv, dbias = _check_train(qkv, bias, dout, h, d, torch.bfloat16)
    _, ref_dbias = attention.bias_attention_bwd_reference(
        qkv, bias, out, lse, dout, heads=h, sm_scale=1 / math.sqrt(d))
    assert dbias_err(dbias, ref_dbias) <= DBIAS_TOL


def test_native_decoder_builds_and_loads(cuda, tmp_path):
    import numpy as np
    from scipy.io import wavfile

    from detail_tts_tpu_torch.native import load_library, load_wav_native

    assert load_library() is not None
    wav = (np.sin(np.arange(44100) * 0.05) * 0.5 * 32767).astype(np.int16)
    wavfile.write(str(tmp_path / "a.wav"), 44100, wav)
    assert load_wav_native(str(tmp_path / "a.wav"), 24000).shape == (24000,)


def test_diff_resume_is_bit_identical(cuda, tmp_path):
    """A small ``diff`` trainer saves at step 2; a second trainer restores it
    and, from the same generator state, takes step 3 on the same batch with
    the same bits as the first: loss, grad norm, parameters and moments."""
    import dataclasses

    from detail_tts_tpu_torch.config import small_test_config
    from detail_tts_tpu_torch.train import checkpoint as ckpt
    from detail_tts_tpu_torch.train.step import synthetic_batches
    from detail_tts_tpu_torch.train.trainer import Trainer

    cfg = small_test_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, target="diff", save_freq=2, val_freq=10 ** 9))
    data = synthetic_batches(cfg, 2, 2, 48, 8, device=cuda,
                             generator=torch.Generator(device=cuda).manual_seed(1))
    a = Trainer(cfg, data, device=cuda, seed=0, logs_folder=str(tmp_path / "a"))
    a.train(max_steps=2, log_every=1)
    batch, gen_state = a.next_batch(), a.generator.get_state()
    want = a.step_fn(a.state, batch, a.generator)
    r = Trainer(cfg, None, device=cuda, seed=5, logs_folder=str(tmp_path / "r"))
    r.load(str(tmp_path / "a" / "ckpt"))
    r.generator.set_state(gen_state)
    got = r.step_fn(r.state, batch, r.generator)
    assert torch.equal(got["loss"], want["loss"]) and torch.equal(got["grad_norm"],
                                                                  want["grad_norm"])
    sa, sr = a.state.model.state_dict(), r.state.model.state_dict()
    assert all(torch.equal(sa[k], sr[k]) for k in sa)
    ma = ckpt.optimizer_state_by_name(a.state.optimizer, a.state.model)
    mr = ckpt.optimizer_state_by_name(r.state.optimizer, r.state.model)
    assert ma.keys() == mr.keys() and all(
        torch.equal(ma[n][k], mr[n][k]) for n in ma for k in ma[n])


@pytest.mark.parametrize("target", ["diff", "all"])
def test_world_1_nccl_step_is_the_plain_step(cuda, target):
    """A small step through a world-1 NCCL process group (gradient
    all-reduce, metric reduction, the gathered lengths and the KL's global
    mask sum under ``all``, GPT dropout 0.1) is the plain step bit for bit:
    metrics and every tensor, each training kernel launched as often."""
    import dataclasses
    import socket

    import torch.distributed as dist

    from detail_tts_tpu_torch.config import small_test_config
    from detail_tts_tpu_torch.parallel.mesh import init_distributed
    from detail_tts_tpu_torch.train.step import (make_train_state, make_train_step,
                                                 synthetic_batches)

    gan = target == "all"
    cfg = small_test_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, target=target, gradient_accumulate_every=1 if gan else 2))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    group, _ = init_distributed(f"tcp://127.0.0.1:{port}", device=cuda, rank=0, world_size=1)
    try:
        batch = next(synthetic_batches(cfg, 1 if gan else 2, 2, 48, 8, device=cuda,
                                       generator=torch.Generator(device=cuda).manual_seed(1)))
        runs = []
        for g in (None, group):
            state = make_train_state(cfg, device=cuda, seed=0)
            counts = dict(attention.TRAIN_LAUNCHES)
            m = make_train_step(cfg, cuda, g)(state, batch,
                                              torch.Generator(device=cuda).manual_seed(5))
            launches = {k: attention.TRAIN_LAUNCHES[k] - counts[k] for k in counts}
            runs.append((m, state.model.state_dict(), launches))
        (m0, sd0, n0), (m1, sd1, n1) = runs
        assert n0 == n1 and min(n0.values()) > 0
        for k, v in m0.items():
            if torch.is_tensor(v):
                assert torch.equal(v, m1[k]), k
        for k, v in sd0.items():
            assert torch.equal(v, sd1[k]), k
    finally:
        dist.destroy_process_group()


def _tp_tail_rank(rank, port, path, args):
    """One of two gloo ranks on cuda:0: the deterministic tail of a (1 x 2)
    engine (the GPT split over the ranks), with its B1 launches."""
    import torch.distributed as dist

    from detail_tts_tpu_torch.parallel.mesh import init_distributed
    import torch_dist  # this directory (pytest puts it on the path); not `tests.`,
    # which another installed package of that name may shadow

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group, dev = init_distributed(f"tcp://127.0.0.1:{port}", backend="gloo",
                                  device="cuda:0", rank=rank, world_size=2)
    try:
        attention.LAUNCHES = 0
        out = torch_dist.engine_tail(group, 1, 2, *args, device=dev)
        torch.save((out, attention.LAUNCHES), f"{path}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_tp_engine_on_one_card_matches_the_one_card_engine(cuda, tmp_path):
    """A (1 x 2) engine of two gloo ranks on the one card, fp32: its
    deterministic tail (fixed codes -> latents, mel, wav) within JAX's mesh
    tolerances of the one-card engine's, and B1 launched as often on each
    rank as on one card."""
    import socket

    import numpy as np
    import torch.multiprocessing as mp

    from detail_tts_tpu_torch.config import small_test_config
    from detail_tts_tpu_torch.serving.pipeline import EngineConfig
    import torch_dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ecfg = EngineConfig(max_generate_length=12, text_buckets=(16, 32),
                        prompt_buckets=(32, 64), code_buckets=(8, 12),
                        compute_dtype=torch.float32, cache_dtype=torch.float32)
    rng = np.random.default_rng(1)
    wavs = [rng.uniform(-0.3, 0.3, 24000 + 3000 * i).astype(np.float32) for i in range(4)]
    args = (small_test_config(), ecfg, ["你好", "三", "今天天气很好。", "第四个请求"], wavs,
            torch.as_tensor(rng.integers(0, 20, size=(4, 8))), np.array([6, 8, 5, 8]))
    attention.LAUNCHES = 0
    one = torch_dist.engine_tail(None, 1, 1, *args, device=cuda)
    one_launches = attention.LAUNCHES
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(_tp_tail_rank, args=(port, str(tmp_path), args), nprocs=2, join=True,
                       start_method="spawn")
    for rank in range(2):
        out, launches = torch.load(tmp_path / f"rank{rank}.pt", weights_only=False)
        assert launches == one_launches > 0
        for a, b, tol in zip(one, out, (2e-4, 2e-3, 2e-3)):
            scale = max(a.abs().max().item(), 1e-3)
            assert (a - b).abs().max().item() <= tol * scale


# ------------------------------------------------------------ threefry

PRNG_ULPS = 2  # floats in units of the last place of max(|plain|, 1)


def _ulps(x, ref):
    m = ref.abs().clamp_min(1.0)
    return ((x - ref).abs() / (torch.nextafter(m, torch.full_like(m, math.inf)) - m)).max().item()


@pytest.mark.parametrize("kind", list(prng.KINDS))
@pytest.mark.parametrize("shape", [(8, 8194), (8, 1600, 128), (2, 800, 192), (1,), (3,),
                                   (7, 33), (5, 257, 3)])
def test_threefry_kernel_matches_plain_version(cuda, kind, shape):
    key = prng.split(prng.PRNGKey(7))[1]
    before = prng.LAUNCHES["threefry_draw"]
    out = prng.draw(key, shape, kind, device=cuda)
    ref = prng.draw_reference(key, shape, kind, device=cuda)
    torch.cuda.synchronize()
    assert prng.LAUNCHES["threefry_draw"] == before + 1
    assert out.dtype == ref.dtype and out.shape == ref.shape and out.device == ref.device
    if kind == "bits":
        assert torch.equal(out, ref)
    else:
        assert _ulps(out, ref) <= PRNG_ULPS


@pytest.mark.parametrize("kind", list(prng.KINDS))
def test_threefry_rows_offsets_and_device_keys(cuda, kind):
    """Row 0 of a batch-2 draw is the batch-1 draw, a draw from an offset is
    those rows of the whole, and a device key row draws as its host key."""
    key = prng.PRNGKey(3)
    whole = prng.draw(key, (8, 1600, 128), kind, device=cuda)
    assert torch.equal(prng.draw(key, (2, 1600, 128), kind, device=cuda)[:1],
                       prng.draw(key, (1, 1600, 128), kind, device=cuda))
    assert torch.equal(prng.draw(key, (3, 1600, 128), kind, offset=5 * 1600 * 128,
                                 device=cuda), whole[5:])
    keys = prng.split_keys(key, 4, cuda)
    host = tuple(int(w) for w in keys[2].cpu().numpy().view("uint32"))
    assert torch.equal(prng.draw(keys[2], (8, 8194), kind),
                       prng.draw(host, (8, 8194), kind, device=cuda))


@pytest.mark.parametrize("n", [1, 7, 200, 600])
def test_threefry_key_buffers_match_plain_version(cuda, n):
    import numpy as np

    key = prng.PRNGKey(11)
    before = prng.LAUNCHES["threefry_keys"]
    for chain, got in ((True, prng.decode_keys(key, n, cuda)),
                       (False, prng.split_keys(key, n, cuda))):
        want = torch.from_numpy(prng.keys_reference(key, n, chain).view(np.int32))
        assert torch.equal(got.cpu(), want)
    assert prng.LAUNCHES["threefry_keys"] == before + 2


def test_threefry_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    with pytest.raises(ValueError):
        prng.draw(torch.zeros(3, dtype=torch.int32, device=cuda), (4,), "normal")
    with pytest.raises(ValueError):
        prng.draw(torch.zeros(2, dtype=torch.int64, device=cuda), (4,), "normal")
    with pytest.raises(ValueError):
        prng.draw((0, 1), (4,), "poisson", device=cuda)


@pytest.mark.parametrize("sampler", ["ancestral", "dpmpp_2m"])
def test_serving_draws_run_the_threefry_kernel(cuda, sampler):
    """Every draw of a request launches ``threefry_draw`` (a Gumbel a decode
    step, the initial noise, a normal an ancestral step but the last, the
    vocoder's) from its key buffers, and in fp32 an item's audio alone is
    its audio batched with another text within JAX's 5e-4."""
    import numpy as np

    from detail_tts_tpu_torch.config import small_test_config
    from detail_tts_tpu_torch.serving.pipeline import EngineConfig, random_engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eng = random_engine(small_test_config(), device=cuda, engine_cfg=EngineConfig(
        diffusion_sampler=sampler, max_generate_length=16, text_buckets=(16,),
        prompt_buckets=(24, 48), code_buckets=(8, 16), compute_dtype=torch.float32,
        cache_dtype=torch.float32))
    wav = np.random.default_rng(7).uniform(-0.3, 0.3, 9600).astype(np.float32)
    before = dict(prng.LAUNCHES)
    solo = eng.synthesize_batch(["ni3 hao3"], [wav], seed=42, force_full=True)
    ancestral = sampler == "ancestral"
    steps = eng.schedule.num_timesteps - 1 if ancestral else 0
    assert prng.LAUNCHES["threefry_draw"] - before["threefry_draw"] == 16 + 1 + steps + 1
    assert prng.LAUNCHES["threefry_keys"] - before["threefry_keys"] == 1 + ancestral
    pair = eng.synthesize_batch(["ni3 hao3", "wo3 men5 hao3"], [wav, wav], seed=42,
                                force_full=True)
    assert solo[0].shape == pair[0].shape
    assert np.max(np.abs(solo[0] - pair[0])) <= 5e-4
