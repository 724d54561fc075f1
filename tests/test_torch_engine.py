"""The port's engine through its entry point, device selection, the weight
carrier round trip through the JAX package's converter, and the port's
freedom from JAX imports."""
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from detail_tts_tpu.io.torch_convert import convert_state_dict
from detail_tts_tpu.serving.pipeline import variables_template
from detail_tts_tpu_torch.config import small_test_config
from detail_tts_tpu_torch.io.weights import from_jax_variables
from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn
from detail_tts_tpu_torch.serving.pipeline import (EngineConfig, TTSEngine,
                                                   random_engine)
from tests.torch_parity import seeded_variables


def _small_engine(seed=0, **kw):
    ecfg = EngineConfig(max_generate_length=12, text_buckets=(16, 32),
                        prompt_buckets=(32, 64), code_buckets=(8, 12),
                        compute_dtype=torch.float32, cache_dtype=torch.float32)
    return random_engine(small_test_config(), seed=seed, engine_cfg=ecfg,
                         device="cpu", **kw)


def test_engine_synthesize_batch_on_cpu():
    eng = _small_engine()
    sr = eng.cfg.data.sampling_rate
    rng = np.random.default_rng(0)
    wavs = [rng.uniform(-0.3, 0.3, n).astype(np.float32) for n in (sr, sr // 2 + 77)]
    texts = ["你好，世界。", "ni3 hao3 shi4 jie4"]
    timings = {}
    outs = eng.synthesize_batch(texts, wavs, seed=3, force_full=True, timings=timings)
    assert [o.shape for o in outs] == [(11 * 1024,)] * 2
    assert all(np.isfinite(o).all() and np.abs(o).max() <= 1.0 for o in outs)
    assert set(timings) >= {"prepare", "generate", "diff_cond", "latents",
                            "diffuse", "vocode"}
    again = eng.synthesize_batch(texts, wavs, seed=3, force_full=True)
    assert all(np.array_equal(a, b) for a, b in zip(outs, again))
    other = eng.synthesize_batch(texts, wavs, seed=4, force_full=True)
    assert not np.array_equal(other[0], outs[0])
    single = eng.synthesize(texts[0], wavs[0], seed=3)
    assert single.ndim == 1 and single.shape[0] % 1024 == 0


def test_engine_requires_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        random_engine(small_test_config())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TTSEngine(SynthesizerTrn(small_test_config()))


def test_weights_round_trip_through_the_jax_converter():
    cfg = small_test_config()
    template = variables_template(cfg)
    np_vars = seeded_variables(template, seed=1)
    port = SynthesizerTrn(cfg)
    state, unused = from_jax_variables(port, np_vars, cfg.diffusion.num_layers)
    assert set(state) == set(port.state_dict())
    assert unused == []  # every JAX leaf has a port key
    port.load_state_dict(state)

    back, report = convert_state_dict(port.state_dict(), template,
                                      diffusion_layers=cfg.diffusion.num_layers)
    assert report["unmapped"] == [] and report["unconsumed"] == []
    assert sorted(report["missing"]) == unused
    flat = dict(jax.tree_util.tree_flatten_with_path(np_vars)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(back)[0]:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if name not in unused:
            np.testing.assert_array_equal(np.asarray(leaf), flat[path])


def test_port_imports_nothing_of_jax():
    code = (
        "import pkgutil, importlib, sys, runpy\n"
        "import detail_tts_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'detail_tts_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'detail_tts_tpu')]\n"
        "print(len([m for m in sys.modules if m.startswith('detail_tts_tpu_torch')]),\n"
        "      'detail_tts_tpu_torch.serving.spmd' in sys.modules, bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.split()
    assert int(out[0]) > 20 and out[1:] == ["True", "[]"]
