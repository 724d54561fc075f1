"""The VQ encode/decode subset (``models/quantizer.py``) and
``SynthesizerTrn.encode`` against the JAX package, with seeded codebooks, and
the weight carrier's list of what is still unported."""
import jax.numpy as jnp
import numpy as np
import torch

from detail_tts_tpu.models.synthesizer import SynthesizerTrn as JaxSynth
from detail_tts_tpu.serving.pipeline import variables_template
from detail_tts_tpu_torch.config import small_test_config
from detail_tts_tpu_torch.io.weights import UNPORTED, from_jax_variables
from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn
from tests.torch_parity import close, japply, seeded_variables, synth_pair, t


def test_quantizer_encode_decode_match():
    port = synth_pair()[2]
    dim = port.cfg.vaegan.inter_channels * 4
    x = np.random.default_rng(0).normal(size=(2, 12, dim)).astype(np.float32)
    ref = np.asarray(japply(lambda m, x: m.quantizer.encode(x), jnp.asarray(x)))
    with torch.no_grad():
        ids = port.quantizer.encode(t(x))
    assert ids.shape == (1, 2, 12)
    np.testing.assert_array_equal(ids.numpy(), ref)
    assert len(np.unique(ref)) > 3  # seeded codebook: the codes differ
    dec = japply(lambda m, i: m.quantizer.decode(i), jnp.asarray(ref))
    with torch.no_grad():
        close(port.quantizer.decode(ids), dec)


def test_synthesizer_encode_matches():
    port = synth_pair()[2]
    mel = np.random.default_rng(1).normal(-6, 2, size=(2, 48, 128)).astype(np.float32)
    codes, feats = japply(JaxSynth.encode, jnp.asarray(mel))
    ours_codes, ours_feats = port.encode(t(mel))
    assert ours_codes.shape == (2, 12)
    np.testing.assert_array_equal(ours_codes.numpy(), np.asarray(codes))
    assert len(np.unique(np.asarray(codes))) > 1  # not all one code
    close(ours_feats, feats)
    assert not ours_feats.requires_grad  # frozen code extraction


def test_carrier_leaves_only_the_unported_prefixes():
    cfg = small_test_config()
    np_vars = seeded_variables(variables_template(cfg), seed=2)
    state, unused = from_jax_variables(SynthesizerTrn(cfg), np_vars,
                                       cfg.diffusion.num_layers)
    assert {next(p for p in UNPORTED if u.startswith(p)) for u in unused} == set(UNPORTED)
    assert not any(u.startswith(("vq_state/", "params/quantizer/", "params/vq_enc"))
                   for u in unused)
    embed = state["quantizer.vq.layers.0._codebook.embed"]
    assert embed.shape == (cfg.vaegan.vq_bins, cfg.vaegan.vq_codebook_dim)
    assert float(embed.std()) > 0.5
