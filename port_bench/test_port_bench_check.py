"""The check that decides ``correct``, driven end to end on the CPU at a
size a test run holds (``tiny_cells``): the harness past its look for a card.
A sound run is correct; each fault that a cell can have, planted in the
program underneath, and the fp8 control come out not correct."""
import contextlib
import functools
import json
import time

import pytest
import torch

from port_bench import bench, control, tiny_cells


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_cells.make_root(tmp_path_factory.mktemp("checkout"))


def _run(root, name, seed=2 ** 31 + 77, **kw):
    torch.manual_seed(0)
    cell = bench.load_cell(name, root)
    return bench.driver(cell.traffic["kind"]).run(
        cell, seed=seed, seconds=0.5, trace=False, device=torch.device("cpu"),
        t_start=time.perf_counter(), **kw)


@contextlib.contextmanager
def _patched(owner, name, make):
    saved = getattr(owner, name)
    setattr(owner, name, make(saved))
    try:
        yield
    finally:
        setattr(owner, name, saved)


@pytest.mark.parametrize("sampler", ["ancestral", "dpmpp_2m"])
def test_sound_serving_run_is_correct(tmp_path, capsys, sampler):
    """A sound run is correct, with a sampler a configuration names; its
    result is the last line of standard output and the numbers compared,
    beside their limits, the last lines of standard error."""
    root = tiny_cells.make_root(tmp_path)
    conf = root / "port_bench" / "configs" / "tiny-serve.json"
    data = json.loads(conf.read_text())
    data["engine"].update(diffusion_sampler=sampler, diffusion_steps=4)
    conf.write_text(json.dumps(data))
    out = _run(root, tiny_cells.SERVE)
    assert bench.verdict(out), out.compared
    line = bench.result(bench.load_cell(tiny_cells.SERVE, root), out, False)
    assert list(line)[-1] == "compared" and line["metrics"]["audio_s_per_s"]["value"] > 0
    assert out.attempted % 3 == 0 and out.attempted >= 6
    capsys.readouterr()
    bench.emit(line)
    printed = capsys.readouterr()
    assert json.loads(printed.out.strip().splitlines()[-1]) == line
    tail = printed.err.strip().splitlines()[-len(line["compared"]):]
    assert [x.split()[1] for x in tail] == list(line["compared"])


def _token_altered(sample_step_reference):
    def step(logits, seen, codes, lengths, finished, step_i, key, **kw):
        tok = sample_step_reference(logits, seen, codes, lengths, finished, step_i, key, **kw)
        codes[:, step_i] = (tok + 1) % logits.shape[1]
        return codes[:, step_i]
    return step


def _mel_altered(infer_flowvae):
    def vocode(self, mel, *args, **kw):
        return infer_flowvae(self, mel * 1.02, *args, **kw)
    return vocode


def _sampler_changed(**changed):
    def wrap(sample_step_reference):
        def step(*args, **kw):
            kw.update({k: v(kw[k]) for k, v in changed.items()})
            return sample_step_reference(*args, **kw)
        return step
    return wrap


@pytest.mark.parametrize("fault", [
    {"offset": lambda o: o + 1},           # the step's noise drawn at the wrong place
    {"temperature": lambda t: 1.0},        # the configured temperature ignored
    {"top_p": lambda p: 1.0},              # no nucleus
    {"top_p": lambda p: p / 2},            # a nucleus of the wrong size
])
def test_sampler_faults_are_caught(root, fault):
    """The decode samples as the configuration states: a sampler that draws
    its noise, tempers or cuts its nucleus otherwise comes out not correct."""
    from detail_tts_tpu_torch.ops import sampling

    with _patched(sampling, "sample_step_reference", _sampler_changed(**fault)):
        out = _run(root, tiny_cells.SERVE)
    assert not bench.verdict(out), out.compared


def test_reference_picks_as_the_sampler_does():
    """The reference's nucleus and pick, with its row-wise Gumbels, agree
    with the port's plain sampler and draw."""
    import numpy as np

    from detail_tts_tpu_torch.ops import prng as port_prng
    from detail_tts_tpu_torch.ops import sampling
    from port_bench.reference import prng
    from port_bench.reference.serve import pick

    gen = torch.Generator().manual_seed(5)
    z = torch.randn((6, 300), generator=gen) * 3
    z[0, 10] = z[0, 11] = z[0].max() + 1  # a tie at the top
    keys = prng.keys_reference((7, 2 ** 31 + 5), 6, True)
    g = prng.gumbel_rows(keys, 300, offset=2 * 300)
    for s in range(6):
        row = port_prng.draw_reference(torch.from_numpy(keys[s].view(np.int32)), (1, 300),
                                       "gumbel", offset=2 * 300)
        assert torch.equal(g[s:s + 1], row)
    for top_p in (0.0, 0.3, 0.8, 1.0):
        want = sampling.sample_token(z, seen_mask=torch.zeros_like(z, dtype=torch.bool),
                                     temperature=1.0, top_p=top_p, repetition_penalty=1.0,
                                     gumbel=g)
        assert torch.equal(pick(z, g, top_p), want), top_p


def test_serving_faults_are_caught(root):
    from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn
    from detail_tts_tpu_torch.ops import sampling

    with _patched(sampling, "sample_step_reference", _token_altered):
        out = _run(root, tiny_cells.SERVE)
    assert not bench.verdict(out) and out.compared["decode_gap"][0] > 1e-3
    with _patched(SynthesizerTrn, "infer_flowvae", _mel_altered):
        out = _run(root, tiny_cells.SERVE)
    assert not bench.verdict(out) and out.compared["wav_err"][0] > 1e-3



def test_sound_training_run_is_correct(root):
    out = _run(root, tiny_cells.TRAIN)
    assert bench.verdict(out), out.compared
    assert out.end_to_end["mel_frames_per_s"] > 0


def _state_unchanged(optimizer_step):
    def step(optimizer, params, cfg, step_i, clip_norm=1.0):
        from detail_tts_tpu_torch.train.optim import global_norm
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return global_norm([p.grad for p in params])
    return step


def _half_batch(forward_diff):
    def forward(self, data, schedule, draws, latents=None, generator=None):
        half = data["raw_mel"].shape[0] // 2
        data = {k: v[:half] for k, v in data.items()}
        draws = draws._replace(t=draws.t[:half], noise=draws.noise[:half],
                               uncond=draws.uncond[:half])
        latents = None if latents is None else latents[:half]
        return forward_diff(self, data, schedule, draws, latents, generator)
    return forward


def test_training_faults_are_caught(root):
    from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn
    from detail_tts_tpu_torch.train import step as step_mod

    with _patched(step_mod, "optimizer_step", _state_unchanged):
        out = _run(root, tiny_cells.TRAIN)
    assert not bench.verdict(out) and out.compared["change_gap"][0] > 0.5
    with _patched(SynthesizerTrn, "forward_diff", _half_batch):
        out = _run(root, tiny_cells.TRAIN)
    assert not bench.verdict(out)


@pytest.mark.parametrize("name", [tiny_cells.SERVE, tiny_cells.TRAIN])
def test_controls_fail(root, name):
    """The fp8 control (and the half-batch fault planted in the reference),
    through the cell's own comparison, come out not correct by the cell's
    own limits, where the program's run comes out correct."""
    fn = control.serve_control if name == tiny_cells.SERVE else control.train_control
    cell = bench.load_cell(name, root)
    out = _run(root, name, calibrate=functools.partial(fn, cell))
    assert bench.verdict(out), out.compared
    judged = {k: v for k, v in out.context["control"].items() if "correct" in v}
    assert set(judged) == ({"fp8"} if name == tiny_cells.SERVE else {"fp8", "half_batch"})
    for which, got in judged.items():
        assert got["correct"] is False, (which, got["readings"])
