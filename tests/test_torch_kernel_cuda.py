"""The CUDA kernels against their plain versions, on the card: the
bias-attention serving forward (both its kernels: ``serve_fwd_wgmma`` and
``serve_fwd_mma``), and the training forward (with its row
statistic) and the three backward kernels (delta, dq and the dbias partials;
dk and dv; the partials' sum) behind ``BiasAttentionFunction``; the threefry
draws and key buffers (``ops/prng.py``); the decode step's sampler
(``ops/sampling.py`` ``sample_step``); and the paths that run them: the
samplers, the training steps, and a (1 x 2) sharded engine of two gloo ranks
on the one card.

These tests need an NVIDIA GPU with ``nvcc`` (sm_90a) and skip elsewhere.
They import nothing of JAX, so on a machine without it run them with the
repository's conftest switched off:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernel_cuda.py
"""
import itertools
import math

import pytest
import torch

from detail_tts_tpu_torch.ops import attention, prng, sampling

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


@pytest.mark.parametrize("d", [16, 32, 48, 64, 96])
# serve_fwd_wgmma's shapes: T % 8 == 0, from one ragged key tile (8) to the
# largest code bucket's trunk (2400); odd B (the integrator's B + 1 rows),
# T off the 64-key and 128-row tiles (200, 96); at d = 96 (the contextual
# embedder, 64-row CTAs) its prompt buckets' T = 16-400 among them
@pytest.mark.parametrize("b,t", [(1, 8), (3, 64), (9, 1600), (16, 1600), (2, 2400),
                                 (5, 96), (3, 200), (1, 136)])
def test_wgmma_kernel_matches_plain_version(cuda, d, b, t):
    h = 16 if t >= 1600 else 4
    qkv, bias = _inputs(b, t, h, d, torch.bfloat16, seed=d * t + b, device=cuda)
    assert attention.bias_attention_fwd_route(t, d, torch.bfloat16) == "serve_fwd_wgmma"
    before = attention.LAUNCHES_BY_ROUTE["serve_fwd_wgmma"]
    before_dim = attention.LAUNCHES_BY_DIM.get(("serve_fwd_wgmma", d), 0)
    out = attention.bias_attention(qkv, bias, heads=h, sm_scale=1 / math.sqrt(d))
    again = attention.bias_attention(qkv, bias, heads=h, sm_scale=1 / math.sqrt(d))
    ref = attention.bias_attention_reference(qkv, bias, heads=h, sm_scale=1 / math.sqrt(d))
    torch.cuda.synchronize()
    assert attention.LAUNCHES_BY_ROUTE["serve_fwd_wgmma"] == before + 2
    assert attention.LAUNCHES_BY_DIM["serve_fwd_wgmma", d] == before_dim + 2
    assert (out.float() - ref.float()).abs().max().item() <= TOL[torch.bfloat16]
    assert torch.equal(out, again)  # a repeat launch is bit-identical


@pytest.mark.parametrize("d", [16, 48, 64, 96])
def test_wgmma_kernel_fully_masked_rows_are_zero(cuda, d):
    """Fully masked rows give exactly 0 (in the first and the second 64 rows:
    the second warpgroup, or at d = 96 the second CTA), and masked keys take
    no weight (the plain version agrees)."""
    b, t, h = 3, 96, 4
    qkv, bias = _inputs(b, t, h, d, torch.bfloat16, seed=d, device=cuda)
    bias[1, 5, :] = -1e9
    bias[3, t - 1, :] = -1e9
    bias[0, 70:, :] = -1e9  # rows of the second 64-row warpgroup or CTA
    bias[2, :, t - 9:] = -1e9  # masked keys in every row of head 2
    assert attention.bias_attention_fwd_route(t, d, torch.bfloat16) == "serve_fwd_wgmma"
    out = attention.bias_attention(qkv, bias, heads=h, sm_scale=1 / math.sqrt(d))
    ref = attention.bias_attention_reference(qkv, bias, heads=h, sm_scale=1 / math.sqrt(d))
    assert torch.count_nonzero(out[:, 5, d:2 * d]).item() == 0
    assert torch.count_nonzero(out[:, t - 1, 3 * d:4 * d]).item() == 0
    assert torch.count_nonzero(out[:, 70:, :d]).item() == 0
    assert (out.float() - ref.float()).abs().max().item() <= TOL[torch.bfloat16]


def test_wgmma_kernel_runs_on_every_device(cuda):
    """Each card of the process opts the kernel in to its own shared memory:
    a launch on the second card after one on the first runs and agrees."""
    b, t, h, d = 3, 200, 4, 48
    for index in range(torch.cuda.device_count()):
        dev = torch.device("cuda", index)
        with torch.cuda.device(dev):
            qkv, bias = _inputs(b, t, h, d, torch.bfloat16, seed=index, device=dev)
            out = attention.bias_attention(qkv, bias, heads=h, sm_scale=1 / math.sqrt(d))
            ref = attention.bias_attention_reference(qkv, bias, heads=h,
                                                     sm_scale=1 / math.sqrt(d))
            assert (out.float() - ref.float()).abs().max().item() <= TOL[torch.bfloat16]


def test_route_entry_matches_the_python_mirror(cuda):
    """The C entry that decides a launch and names the route counted, against
    ``attention.bias_attention_fwd_route`` over every T % 8 and head dim."""
    lib = attention._library(attention.SOURCE)
    for t, d, dtype in itertools.product(list(range(1, 65)) + [100, 1597, 1600, 2400],
                                         range(16, 129, 16),
                                         (torch.bfloat16, torch.float32)):
        code = lib.bias_attention_fwd_route(t, d, attention._DTYPE_CODE[dtype])
        assert code >= 0
        assert attention.SERVE_ROUTES[code] == attention.bias_attention_fwd_route(t, d, dtype)


def test_wgmma_kernel_has_no_spills(cuda, monkeypatch, tmp_path):
    """ptxas -v of every serve_fwd_wgmma instantiation: no spill stores or loads."""
    monkeypatch.setattr(attention, "BUILD_DIR", tmp_path)
    _, _, log = attention.build(attention.SOURCE)
    entry, lines = "", []
    for line in log.splitlines():
        if "entry function" in line:
            entry = line.split("'")[1]
        elif "serve_fwd_wgmma" in entry and "spill" in line:
            lines.append(line)
    assert lines and all(" 0 bytes spill stores, 0 bytes spill loads" in x for x in lines)


def test_serving_kernel_fits_on_an_sm(cuda):
    lib = attention._library(attention.SOURCE)
    assert lib.bias_attention_fwd_blocks_per_sm(48) >= 2
    assert lib.bias_attention_fwd_blocks_per_sm(96) >= 2  # serve_fwd_wgmma<96>'s 64-row CTAs
    assert lib.bias_attention_fwd_blocks_per_sm(128) >= 1


def test_train_forward_fits_on_an_sm(cuda):
    """CTAs an SM of the training forward's kernel at the trunk's shape
    (``bias_attention_train_fwd_info``): train_fwd_wgmma at d = 48 and 96,
    train_fwd_mma at d = 128."""
    import ctypes
    lib = attention._library(attention.SOURCE)
    for d, blocks in ((48, 2), (96, 2), (128, 1)):
        info = (ctypes.c_int * 5)()
        assert lib.bias_attention_train_fwd_info(8, 496, 16, d, 0, info) == 0
        assert info[2] >= blocks


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
    """The training kernels against their plain versions at one shape: one
    launch of each, the forward and the backward on the routes the mirrors
    name."""
    sm = 1 / math.sqrt(d)
    before = dict(attention.TRAIN_LAUNCHES)
    routes = dict(attention.BWD_LAUNCHES_BY_ROUTE)
    dims = dict(attention.BWD_LAUNCHES_BY_DIM)
    fwd_routes = dict(attention.TRAIN_FWD_LAUNCHES_BY_ROUTE)
    fwd_dims = dict(attention.TRAIN_FWD_LAUNCHES_BY_DIM)
    route = attention.bias_attention_bwd_route(qkv.shape[0], qkv.shape[1], d, dtype)
    fwd_route = attention.bias_attention_train_fwd_route(qkv.shape[0], qkv.shape[1], h, d, dtype,
                                                         _sms())
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
    assert {k: v - routes[k] for k, v in attention.BWD_LAUNCHES_BY_ROUTE.items()} == {
        k: int(k == route) for k in attention.BWD_ROUTES}
    assert {k: v - dims.get(k, 0) for k, v in attention.BWD_LAUNCHES_BY_DIM.items()
            if v != dims.get(k, 0)} == {(route, d): 1}
    assert {k: v - fwd_routes[k] for k, v in attention.TRAIN_FWD_LAUNCHES_BY_ROUTE.items()} == {
        k: int(k == fwd_route) for k in attention.TRAIN_FWD_ROUTES}
    assert {k: v - fwd_dims.get(k, 0) for k, v in attention.TRAIN_FWD_LAUNCHES_BY_DIM.items()
            if v != fwd_dims.get(k, 0)} == {(fwd_route, d): 1}
    assert out.dtype == dqkv.dtype == dtype and dbias.dtype == torch.float32
    assert (out.float() - ref_out.float()).abs().max().item() <= TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL[dtype]
    assert scaled_err(dqkv, ref_dqkv) <= TOL[dtype]
    assert scaled_err(dbias, ref_dbias) <= TOL[dtype]
    return out, lse, dqkv, dbias


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


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


@pytest.mark.parametrize("b,t,h,d,route", [(4, 130, 4, 48, "bwd_mma"),
                                           (8, 496, 16, 48, "bwd_wgmma"),
                                           (8, 124, 16, 96, "bwd_wgmma"),
                                           (8, 125, 16, 96, "bwd_mma")])
def test_train_backward_is_deterministic(cuda, b, t, h, d, route):
    qkv, bias, dout = _train_inputs(b, t, h, d, torch.bfloat16, seed=11, device=cuda)
    assert attention.bias_attention_bwd_route(b, t, d, torch.bfloat16) == route
    out, lse = attention.bias_attention_train_fwd(qkv, bias, heads=h, sm_scale=0.2)
    before = attention.BWD_LAUNCHES_BY_ROUTE[route]
    before_dim = attention.BWD_LAUNCHES_BY_DIM.get((route, d), 0)
    first = attention.bias_attention_bwd(qkv, bias, out, lse, dout, heads=h, sm_scale=0.2)
    second = attention.bias_attention_bwd(qkv, bias, out, lse, dout, heads=h, sm_scale=0.2)
    assert attention.BWD_LAUNCHES_BY_ROUTE[route] == before + 2
    assert attention.BWD_LAUNCHES_BY_DIM[route, d] == before_dim + 2
    assert all(torch.equal(x, y) for x, y in zip(first, second))


# train_fwd_wgmma against the plain version: out relative to max(1, max
# |plain|), lse absolute (fp32 from logits summed in another order)
FWD_LSE_TOL = 1e-4


def _heads_for_wgmma(b, t):
    """Heads enough for train_fwd_wgmma's grid of 128-row CTAs to fill half
    the SMs, so that the route takes it at (b, t)."""
    return -(-_sms() // (2 * b * -(-t // 128)))


@pytest.mark.parametrize("d", [16, 32, 48, 64, 96])
# train_fwd_wgmma's shapes (T % 4 == 0): one ragged tile (4), one whole tile
# (64), the step's conditioner and contextual embedder (124) and trunk
# (496), a 128-row block and four rows (132), the raw bucket 1024
@pytest.mark.parametrize("b,t", [(1, 4), (3, 64), (8, 124), (1, 132), (3, 496), (8, 496),
                                 (8, 1024)])
def test_train_fwd_wgmma_matches_plain_version(cuda, d, b, t):
    h = max(16, _heads_for_wgmma(b, t))
    qkv, bias, _ = _train_inputs(b, t, h, d, torch.bfloat16, seed=d * t + b, device=cuda)
    assert attention.bias_attention_train_fwd_route(b, t, h, d, torch.bfloat16,
                                                    _sms()) == "train_fwd_wgmma"
    before = attention.TRAIN_FWD_LAUNCHES_BY_ROUTE["train_fwd_wgmma"]
    out, lse = attention.bias_attention_train_fwd(qkv, bias, heads=h, sm_scale=1 / math.sqrt(d))
    again = attention.bias_attention_train_fwd(qkv, bias, heads=h, sm_scale=1 / math.sqrt(d))
    ref_out, ref_lse = attention.bias_attention_train_reference(qkv, bias, heads=h,
                                                                sm_scale=1 / math.sqrt(d))
    torch.cuda.synchronize()
    assert attention.TRAIN_FWD_LAUNCHES_BY_ROUTE["train_fwd_wgmma"] == before + 2
    assert out.shape == (b, t, h * d) and lse.shape == (b, h, t)
    assert scaled_err(out, ref_out) <= TOL[torch.bfloat16]
    assert (lse - ref_lse).abs().max().item() <= FWD_LSE_TOL
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])  # bit-identical repeat


@pytest.mark.parametrize("d", [16, 48, 64, 96])
@pytest.mark.parametrize("b,t", [(3, 96), (8, 496)])
def test_train_fwd_wgmma_masked_rows_and_keys(cuda, d, b, t):
    """Fully masked query rows (in the first 128-row block and the ragged
    last one) give out exactly 0 and lse = MASKED_LSE; masked keys, and the
    keys and queries past T of a ragged last tile, take no weight."""
    h = max(4, _heads_for_wgmma(b, t))
    qkv, bias, _ = _train_inputs(b, t, h, d, torch.bfloat16, seed=d + t, device=cuda)
    bias[1, 5, :] = -1e9           # a fully masked query row in the first block
    bias[0, t - 26, :] = -1e9      # and one in the last
    bias[2, :, t - 9:] = -1e9      # masked keys in every row of head 2
    assert attention.bias_attention_train_fwd_route(b, t, h, d, torch.bfloat16,
                                                    _sms()) == "train_fwd_wgmma"
    out, lse = attention.bias_attention_train_fwd(qkv, bias, heads=h, sm_scale=1 / math.sqrt(d))
    ref_out, ref_lse = attention.bias_attention_train_reference(qkv, bias, heads=h,
                                                                sm_scale=1 / math.sqrt(d))
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    assert torch.count_nonzero(out[:, 5, d:2 * d]).item() == 0
    assert torch.count_nonzero(out[:, t - 26, :d]).item() == 0
    assert bool((lse[:, 1, 5] == attention.MASKED_LSE).all())
    assert bool((lse[:, 0, t - 26] == attention.MASKED_LSE).all())
    assert scaled_err(out, ref_out) <= TOL[torch.bfloat16]
    assert (lse - ref_lse).abs().max().item() <= FWD_LSE_TOL


def test_train_fwd_route_entry_matches_the_python_mirror(cuda):
    """The C entry that decides the training forward's launch and names the
    route counted, against ``attention.bias_attention_train_fwd_route`` over
    every T % 4, head dim and dtype, at several batches and head counts (on
    both sides of half the card's SMs)."""
    lib = attention._library(attention.SOURCE)
    for b, t, h, d, dtype in itertools.product((1, 2, 3, 4, 8, 9, 16),
                                               list(range(1, 33)) + [124, 128, 132, 256, 495,
                                                                     496, 706, 2824],
                                               (4, 16, 65, 66), range(16, 129, 16),
                                               (torch.bfloat16, torch.float32)):
        code = lib.bias_attention_train_fwd_route(b, t, h, d, attention._DTYPE_CODE[dtype])
        assert code >= 0
        assert attention.TRAIN_FWD_ROUTES[code] == attention.bias_attention_train_fwd_route(
            b, t, h, d, dtype, _sms())
    assert lib.bias_attention_train_fwd_route(8, 496, 16, 40, 0) == -1
    assert lib.bias_attention_train_fwd_route(8, 496, 16, 48, 2) == -1
    assert lib.bias_attention_train_fwd_route(0, 496, 16, 48, 0) == -1
    assert lib.bias_attention_train_fwd_route(8, 496, 0, 48, 0) == -1


def test_train_fwd_wgmma_has_no_spills(cuda, monkeypatch, tmp_path):
    """ptxas -v of every train_fwd_wgmma instantiation (d = 16-64 and 96):
    no spill stores or loads."""
    monkeypatch.setattr(attention, "BUILD_DIR", tmp_path)
    _, _, log = attention.build(attention.SOURCE)
    entry, lines = "", []
    for line in log.splitlines():
        if "entry function" in line:
            entry = line.split("'")[1]
        elif "train_fwd_wgmma" in entry and "spill" in line:
            lines.append(line)
    assert len(lines) == 5
    assert all(" 0 bytes spill stores, 0 bytes spill loads" in x for x in lines)


@pytest.mark.parametrize("b,t,d,route,rows,blocks", [
    (8, 496, 48, "train_fwd_wgmma", 128, 2), (8, 124, 48, "train_fwd_wgmma", 128, 2),
    (8, 1024, 48, "train_fwd_wgmma", 128, 2), (8, 124, 96, "train_fwd_wgmma", 64, 2),
    (4, 124, 96, "train_fwd_wgmma", 64, 2), (8, 125, 96, "train_fwd_mma", 64, 1),
    (8, 706, 48, "train_fwd_mma", 128, 2), (4, 124, 48, "train_fwd_mma", 64, 2)])
def test_train_fwd_info_at_the_step_shapes(cuda, b, t, d, route, rows, blocks):
    """The C entry ``bias_attention_train_fwd_info``: the route, the tiling
    and at least ``blocks`` CTAs an SM at the step's shapes (16 heads)."""
    import ctypes
    info = (ctypes.c_int * 5)()
    lib = attention._library(attention.SOURCE)
    assert lib.bias_attention_train_fwd_info(b, t, 16, d, 0, info) == 0
    assert attention.TRAIN_FWD_ROUTES[info[0]] == route
    assert info[1] == rows and info[2] >= blocks and info[3] > 0 and 0 < info[4] <= 255


@pytest.mark.parametrize("d", [16, 32, 48, 64, 96])
# bwd_dq_wgmma / bwd_dkv_wgmma's shapes (T % 4 == 0): one ragged tile (4),
# one whole tile (64), the step's conditioner (124) and trunk (496), a tile
# and four rows (132), the corpus's raw bucket (1024); B 1, 3 and 8
@pytest.mark.parametrize("b,t", [(1, 4), (3, 64), (8, 124), (1, 132), (3, 496), (8, 496),
                                 (8, 1024)])
def test_bwd_wgmma_matches_plain_version(cuda, d, b, t):
    h = 16 if t >= 496 else 4
    qkv, bias, dout = _train_inputs(b, t, h, d, torch.bfloat16, seed=d * t + b, device=cuda)
    assert attention.bias_attention_bwd_route(b, t, d, torch.bfloat16) == "bwd_wgmma"
    out, lse, dqkv, dbias = _check_train(qkv, bias, dout, h, d, torch.bfloat16)
    _, ref_dbias = attention.bias_attention_bwd_reference(
        qkv, bias, out, lse, dout, heads=h, sm_scale=1 / math.sqrt(d))
    assert dbias_err(dbias, ref_dbias) <= DBIAS_TOL
    again = attention.bias_attention_bwd(qkv, bias, out, lse, dout, heads=h,
                                         sm_scale=1 / math.sqrt(d))
    assert torch.equal(dqkv, again[0]) and torch.equal(dbias, again[1])


@pytest.mark.parametrize("d", [16, 48, 64, 96])
def test_bwd_wgmma_masked_rows_and_keys(cuda, d):
    """A fully masked query row gives exactly 0 in dq and dbias, masked keys
    0 in dk and dv, on the wgmma route (T = 96: a whole tile and a ragged
    one, in both dq's key walk and dk/dv's query walk)."""
    b, t, h = 3, 96, 4
    qkv, bias, dout = _train_inputs(b, t, h, d, torch.bfloat16, seed=d, device=cuda)
    bias[1, 5, :] = -1e9        # a fully masked query row in the first tile
    bias[0, 70, :] = -1e9       # and one in the ragged second tile
    bias[2, :, t - 9:] = -1e9   # masked keys in every row of head 2
    assert attention.bias_attention_bwd_route(b, t, d, torch.bfloat16) == "bwd_wgmma"
    out, lse, dqkv, dbias = _check_train(qkv, bias, dout, h, d, torch.bfloat16)
    for x in (out, lse, dqkv, dbias):
        assert torch.isfinite(x).all()
    g = dqkv.view(b, t, h, 3, d)
    assert torch.count_nonzero(g[:, 5, 1, 0]).item() == 0  # dq, head 1
    assert torch.count_nonzero(g[:, 70, 0, 0]).item() == 0  # dq, head 0
    assert torch.count_nonzero(dbias[1, 5]).item() == 0
    assert torch.count_nonzero(dbias[0, 70]).item() == 0
    assert torch.count_nonzero(g[:, t - 9:, 2, 1:]).item() == 0  # dk, dv of the masked keys


def test_bwd_route_entry_matches_the_python_mirror(cuda):
    """The C entry that decides the backward's launches and names the route
    counted, against ``attention.bias_attention_bwd_route`` over every
    T % 4, head dim and dtype, at several batches."""
    lib = attention._library(attention.BWD_SOURCE)
    for b, t, d, dtype in itertools.product((1, 3, 8, 9, 16),
                                            list(range(1, 33)) + [124, 495, 496, 2824],
                                            range(16, 129, 16),
                                            (torch.bfloat16, torch.float32)):
        code = lib.bias_attention_bwd_route(b, t, d, attention._DTYPE_CODE[dtype])
        assert code >= 0
        assert attention.BWD_ROUTES[code] == attention.bias_attention_bwd_route(b, t, d, dtype)
    assert lib.bias_attention_bwd_route(8, 496, 40, 0) == -1
    assert lib.bias_attention_bwd_route(8, 496, 48, 2) == -1


def test_bwd_wgmma_kernels_have_no_spills(cuda, monkeypatch, tmp_path):
    """ptxas -v of every bwd_dq_wgmma and bwd_dkv_wgmma instantiation: no
    spill stores or loads."""
    monkeypatch.setattr(attention, "BUILD_DIR", tmp_path)
    _, _, log = attention.build(attention.BWD_SOURCE)
    entry, lines = "", []
    for line in log.splitlines():
        if "entry function" in line:
            entry = line.split("'")[1]
        elif "_wgmma" in entry and "spill" in line:
            lines.append(line)
    assert len(lines) == 10  # bwd_dq_wgmma and bwd_dkv_wgmma at d = 16, 32, 48, 64, 96
    assert all(" 0 bytes spill stores, 0 bytes spill loads" in x for x in lines)


def test_bwd_kernels_fit_on_an_sm(cuda):
    lib = attention._library(attention.BWD_SOURCE)
    for which in range(4):  # dq, dk/dv of the mma.sync route; dq, dk/dv of wgmma
        assert lib.bias_attention_bwd_blocks_per_sm(which, 48) >= 2
    assert lib.bias_attention_bwd_blocks_per_sm(0, 96) >= 1
    for which in (2, 3):  # the wgmma kernels at the contextual embedder's d = 96
        assert lib.bias_attention_bwd_blocks_per_sm(which, 96) >= 2
    assert lib.bias_attention_bwd_blocks_per_sm(2, 80) < 0  # no wgmma kernel at d = 80


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
    integrator blocks, and the trunk layers kept), each backward on a bf16
    route, the serving kernel never,
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
        routes = dict(attention.BWD_LAUNCHES_BY_ROUTE)
        m = step(state, batch, torch.Generator(device=cuda).manual_seed(5))
        want = 5 + 4 + 3 + sum(m["layers_kept"][0][:cfg.diffusion.num_layers])
        got = {k: attention.TRAIN_LAUNCHES[k] - counts[k] for k in counts}
        assert len(got) == 4 and all(v == want for v in got.values()), (got, want)
        by_route = {k: v - routes[k] for k, v in attention.BWD_LAUNCHES_BY_ROUTE.items()}
        assert sum(by_route.values()) == want and by_route["bwd_simt"] == 0, by_route
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
    """Every draw of a request launches ``threefry_draw`` (the initial
    noise, a normal an ancestral step but the last, the vocoder's) from its
    key buffers, a decode step is one ``sample_step`` launch that draws its
    Gumbels itself, and in fp32 an item's audio alone is its audio batched
    with another text within JAX's 5e-4."""
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
    before, samples = dict(prng.LAUNCHES), sampling.LAUNCHES["sample_step"]
    solo = eng.synthesize_batch(["ni3 hao3"], [wav], seed=42, force_full=True)
    ancestral = sampler == "ancestral"
    steps = eng.schedule.num_timesteps - 1 if ancestral else 0
    # the decode draws inside sample_step, once a step: no threefry_draw there
    assert prng.LAUNCHES["threefry_draw"] - before["threefry_draw"] == 1 + steps + 1
    assert prng.LAUNCHES["threefry_keys"] - before["threefry_keys"] == 1 + ancestral
    assert sampling.LAUNCHES["sample_step"] - samples == 16
    pair = eng.synthesize_batch(["ni3 hao3", "wo3 men5 hao3"], [wav, wav], seed=42,
                                force_full=True)
    assert solo[0].shape == pair[0].shape
    assert np.max(np.abs(solo[0] - pair[0])) <= 5e-4


# (temperature, top_p, repetition_penalty, typical_mass): the engine's
# defaults, typical beside them and alone, both filters off
SAMPLE_SETTINGS = [(0.8, 0.8, 2.0, 1.0), (0.8, 0.8, 2.0, 0.9), (1.0, 1.0, 2.0, 0.9),
                   (1.0, 1.0, 1.0, 1.0)]
# the kernel's sums run in another order: a token may differ only in a row
# whose plain boundary mass lies this close to its threshold
SAMPLE_NEAR = 1e-5


def _boundary_margin(x, seen, temperature, top_p, penalty, mass):
    """(B,) distance of the plain version's cumulative masses from their
    thresholds (typical's and top-p's)."""
    x = sampling.apply_temperature(sampling.apply_repetition_penalty(x.float(), seen, penalty),
                                   temperature)
    margin = torch.full((x.shape[0],), math.inf, device=x.device)
    if mass < 1.0:
        logp = torch.log_softmax(x, dim=-1)
        p = logp.exp()
        h = -torch.where(p > 0, p * logp, 0.0).sum(dim=-1, keepdim=True)
        cum = p.gather(-1, torch.sort((-logp - h).abs(), dim=-1, stable=True)[1]).cumsum(-1)
        margin = torch.minimum(margin, (cum - mass).abs().amin(-1))
        x = sampling.apply_typical(x, mass)
    if top_p < 1.0:
        cum = torch.softmax(torch.sort(x, dim=-1, stable=True)[0], dim=-1).cumsum(-1)
        margin = torch.minimum(margin, (cum - (1.0 - top_p)).abs().amin(-1))
    return margin


def _sample_inputs(b, v, dtype, seed, case, device):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((b, v), generator=g, device=device) * 2.0
    if case == "ties":
        x = torch.round(x * 4.0) / 4.0
    elif case == "zeros":
        x[:, 3], x[:, 7] = -0.0, 0.0
    elif case == "one-finite":
        keep = torch.randint(0, v, (b,), generator=g, device=device)
        x = torch.where(torch.arange(v, device=device) == keep[:, None], x, -math.inf)
    elif case == "all-inf":  # every other row
        x[::2] = -math.inf
    seen = torch.rand((b, v), generator=g, device=device) < 0.01
    codes = torch.randint(0, v, (b, 50), generator=g, device=device)
    lengths = torch.randint(0, 6, (b,), generator=g, device=device)
    finished = torch.rand((b,), generator=g, device=device) < 0.33
    return x.to(dtype), seen, codes, lengths, finished


@pytest.mark.parametrize("case", ["random", "ties", "zeros", "one-finite"])
@pytest.mark.parametrize("v", [8194, 8193, 1000])
@pytest.mark.parametrize("b", [1, 2, 8, 16])
def test_sample_step_kernel_matches_plain_version(cuda, b, v, case):
    """Tokens equal (but in rows at the boundary), and codes, seen, lengths
    and finished bit-identical where they are, in bf16 and fp32, under each
    setting, with and without force_full and a data rank's offset."""
    keys = prng.decode_keys(b * v, 8, cuda)
    for i, (setting, dtype, (force_full, offset)) in enumerate(itertools.product(
            SAMPLE_SETTINGS, (torch.bfloat16, torch.float32), ((False, 0), (True, 5 * v)))):
        x, seen, codes, lengths, finished = _sample_inputs(b, v, dtype, i, case, cuda)
        t, top_p, penalty, mass = setting
        kw = dict(temperature=t, top_p=top_p, repetition_penalty=penalty, typical_mass=mass,
                  stop_token=v - 1, force_full=force_full, offset=offset)
        mine = [s.clone() for s in (seen, codes, lengths, finished)]
        plain = [s.clone() for s in (seen, codes, lengths, finished)]
        before = sampling.LAUNCHES["sample_step"]
        tok = sampling.sample_step(x, *mine, 7, keys[i % 8], **kw)
        ref = sampling.sample_step_reference(x, *plain, 7, keys[i % 8], **kw)
        torch.cuda.synchronize()
        assert sampling.LAUNCHES["sample_step"] == before + 1
        assert tok.dtype == torch.int64 and tok.shape == (b,)
        same = tok == ref
        if not same.all():
            margin = _boundary_margin(x, seen, t, top_p, penalty, mass)
            assert (margin[~same] < SAMPLE_NEAR).all(), (setting, dtype, tok, ref)
        for ours, theirs in zip(mine, plain):
            assert torch.equal(ours[same], theirs[same])


# past what one CTA held (12288 tokens) up to the shared-memory path's 65536,
# past it on the wide path (one more; an odd V whose rows 1 and 2 start off
# every 16-byte boundary; V = 2^17 + 1; eight rows of it, which on an H100
# run as two groups of G = 65 CTAs taking four rows each in turn; four rows
# of a V whose group of G = 132 CTAs fills an H100, so one group takes them
# in turn; past the 23-bit count of the shared path's packed histogram), and
# batches that fill one wave of an H100's 132 SMs with 8-CTA clusters (B =
# 16) and wrap it
WIDE_SHAPES = [(1, 16386), (8, 16386), (2, 12289), (2, 65536), (16, 8194), (40, 8194),
               (1, 65537), (3, 65539), (2, 131073), (8, 131073), (1, 1048579), (4, 1048579),
               (1, 8388609)]


@pytest.mark.parametrize("case", ["random", "ties", "one-finite", "all-inf"])
@pytest.mark.parametrize("shape", WIDE_SHAPES, ids=lambda s: f"B{s[0]}-V{s[1]}")
def test_sample_step_kernel_matches_plain_version_at_wide_shapes(cuda, shape, case):
    """Tokens equal to the plain version's (but in rows at the boundary),
    the state bit-identical where they are, and a repeated launch
    bit-identical."""
    b, v = shape
    keys = prng.decode_keys(b + v, 8, cuda)
    for i, (setting, dtype) in enumerate(itertools.product(
            SAMPLE_SETTINGS, (torch.bfloat16, torch.float32))):
        x, seen, codes, lengths, finished = _sample_inputs(b, v, dtype, 100 + i, case, cuda)
        t, top_p, penalty, mass = setting
        kw = dict(temperature=t, top_p=top_p, repetition_penalty=penalty, typical_mass=mass,
                  stop_token=v - 1, force_full=False, offset=3 * v)
        mine = [s.clone() for s in (seen, codes, lengths, finished)]
        again = [s.clone() for s in (seen, codes, lengths, finished)]
        plain = [s.clone() for s in (seen, codes, lengths, finished)]
        tok = sampling.sample_step(x, *mine, 7, keys[i % 8], **kw)
        tok2 = sampling.sample_step(x, *again, 7, keys[i % 8], **kw)
        ref = sampling.sample_step_reference(x, *plain, 7, keys[i % 8], **kw)
        torch.cuda.synchronize()
        assert torch.equal(tok, tok2) and all(map(torch.equal, mine, again))
        same = tok == ref
        if not same.all():
            margin = _boundary_margin(x, seen, t, top_p, penalty, mass)
            assert (margin[~same] < SAMPLE_NEAR).all(), (setting, dtype, tok, ref)
        for ours, theirs in zip(mine, plain):
            assert torch.equal(ours[same], theirs[same])


@pytest.mark.parametrize("shape", [(3, 65539), (8, 131073), (3, 1048579)],
                         ids=lambda s: f"B{s[0]}-V{s[1]}")
def test_sample_step_wide_row_alone_equals_the_row_in_a_batch(cuda, shape):
    """On the wide path a row's token and state do not depend on its batch:
    each row of a batch (rows off every 16-byte boundary at an odd V; at (8,
    131073) two groups that take four rows each), stepped alone from its own
    offset, is bit-identical to the same row stepped inside the batch, in
    bf16 and fp32 under each setting."""
    b, v = shape
    keys = prng.decode_keys(v, 8, cuda)
    for i, (setting, dtype) in enumerate(itertools.product(
            SAMPLE_SETTINGS, (torch.bfloat16, torch.float32))):
        x, seen, codes, lengths, finished = _sample_inputs(b, v, dtype, 300 + i, "random", cuda)
        t, top_p, penalty, mass = setting
        kw = dict(temperature=t, top_p=top_p, repetition_penalty=penalty, typical_mass=mass,
                  stop_token=v - 1, force_full=False)
        batch = [s.clone() for s in (seen, codes, lengths, finished)]
        tok = sampling.sample_step(x, *batch, 7, keys[i % 8], offset=0, **kw)
        for r in range(b):
            alone = [s[r:r + 1].clone() for s in (seen, codes, lengths, finished)]
            one = sampling.sample_step(x[r:r + 1].clone(), *alone, 7, keys[i % 8],
                                       offset=r * v, **kw)
            torch.cuda.synchronize()
            assert int(one) == int(tok[r]), (setting, dtype, r)
            for mine, theirs in zip(alone, batch):
                assert torch.equal(mine, theirs[r:r + 1]), (setting, dtype, r)


def test_sample_step_wide_ctas_do_not_depend_on_the_batch(cuda):
    """The wide launch's G (CTAs a row) and cached tokens a CTA are functions
    of V and the card: the same at every batch; the groups in flight grow
    with the batch up to what the card holds at once."""
    import ctypes

    def shape(b, v):
        out = [ctypes.c_int() for _ in range(3)]
        sampling._launch("sample_step_wide_shape", v, b, 1, *(ctypes.byref(o) for o in out))
        return tuple(o.value for o in out)

    for v in (65537, 131073, 1048579, 8388609, 16777217):
        shapes = [shape(b, v) for b in (1, 2, 3, 8, 64)]
        assert len({(g, cache) for g, _, cache in shapes}) == 1, (v, shapes)
        groups = [r for _, r, _ in shapes]
        assert groups[0] == 1 and groups == sorted(groups), (v, shapes)
        g, _, cache = shapes[0]
        assert 1 <= g <= torch.cuda.get_device_properties(0).multi_processor_count
        assert 0 < cache <= -(-v // g)


def test_sample_step_kernel_refuses_a_row_past_max_vocab(cuda, monkeypatch):
    """No row is past a vocabulary cap any more (65536 was one); a launch the
    kernel's own entry refuses (here a stop token outside the vocabulary,
    past the wrapper's check) raises, and counts no launch: nothing falls
    back."""
    v = 65537
    x, seen, codes, lengths, finished = _sample_inputs(1, v, torch.float32, 0, "random", cuda)
    monkeypatch.setattr(sampling, "_check_step", lambda *args: None)
    before = sampling.LAUNCHES["sample_step"]
    with pytest.raises(RuntimeError, match="sample_step failed"):
        sampling.sample_step(x, seen, codes, lengths, finished, 0,
                             prng.decode_keys(0, 1, cuda)[0], temperature=0.8, top_p=0.8,
                             repetition_penalty=2.0, typical_mass=1.0, stop_token=v,
                             force_full=False)
    assert sampling.LAUNCHES["sample_step"] == before


def test_sample_step_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x, seen, codes, lengths, finished = _sample_inputs(2, 100, torch.float32, 0, "random",
                                                       cuda)
    kw = dict(temperature=0.8, top_p=0.8, repetition_penalty=2.0, typical_mass=1.0,
              stop_token=99, force_full=False)
    key = prng.decode_keys(0, 1, cuda)[0]
    with pytest.raises(ValueError):  # a key on the host
        sampling.sample_step(x, seen, codes, lengths, finished, 0, key.cpu(), **kw)
    with pytest.raises(TypeError):
        sampling.sample_step(x.half(), seen, codes, lengths, finished, 0, key, **kw)
    with pytest.raises(ValueError):
        sampling.sample_step(x, seen, codes[:, ::2], lengths, finished, 0, key, **kw)


@pytest.mark.parametrize("force_full", [True, False])
def test_decode_launches_one_sample_step_a_step(cuda, force_full):
    """``generate_speech_tokens`` on the card: one ``sample_step`` launch for
    each step it executed, no ``threefry_draw``; in fp32 its codes are those
    of the loop stepping through the plain version."""
    import numpy as np

    from detail_tts_tpu_torch.config import small_test_config
    from detail_tts_tpu_torch.models import gpt as gpt_module
    from detail_tts_tpu_torch.models.gpt import SamplingConfig, generate_speech_tokens
    from detail_tts_tpu_torch.serving.pipeline import random_engine

    torch.backends.cuda.matmul.allow_tf32 = False
    eng = random_engine(small_test_config(), device=cuda)
    gpt = eng.model.gpt.float()
    rng = np.random.default_rng(1)
    cond = torch.as_tensor(rng.normal(size=(3, 24, 128)), dtype=torch.float32, device=cuda)
    clen = torch.tensor([24, 17, 20], device=cuda)
    text = torch.as_tensor(rng.integers(3, 200, size=(3, 9)), device=cuda)
    sampling_cfg = SamplingConfig(max_generate_length=12, typical_mass=0.9,
                                  force_full_length=force_full)
    draws, samples = prng.LAUNCHES["threefry_draw"], sampling.LAUNCHES["sample_step"]
    codes, lengths = generate_speech_tokens(gpt, cond, clen, text, sampling_cfg, key=3,
                                            cache_dtype=torch.float32)
    torch.cuda.synchronize()
    assert prng.LAUNCHES["threefry_draw"] == draws
    assert sampling.LAUNCHES["sample_step"] - samples == int(lengths.max())
    orig, gpt_module.sample_step = gpt_module.sample_step, sampling.sample_step_reference
    try:
        plain, plain_lengths = generate_speech_tokens(gpt, cond, clen, text, sampling_cfg,
                                                      key=3, cache_dtype=torch.float32)
    finally:
        gpt_module.sample_step = orig
    assert torch.equal(codes, plain) and torch.equal(lengths, plain_lengths)
