"""The GAN step (target ``flowvae``) over two gloo ranks on the CPU, fp32,
at dropout 0 with weight norm on, on a global batch of 2 rows of unequal
length (so the ranks' KL mask sums differ and the masked KL must divide by
the global sum), with JAX's draws handed in.  JAX's step is the one
``tests/test_torch_gan.py`` runs.

The two ranks' tensors are bit-identical, and every metric is within 1e-4
of the port's world-1 step and of JAX's.  The update (the generator's and
the discriminator's AdamW first moments and new values,
``test_torch_parallel.assert_one_step``) is held at the GAN test's
tolerances against the port's world-1 step with its generator forward run
one row at a time: a rank's convs on one row round otherwise than on two
(7e-6 of the generated segment), and the seeded discriminator's gradient
moves by up to 1.4e-2 of its largest for that (measured: 1.35e-2 in the
period-7 discriminator's second conv, 4.1e-3 in the vocoder; 3e-6 against
the row-at-a-time step).  Against the plain world-1 step and JAX the update
is held at that measured spread, 2e-2 of the largest, its new values where
the gradient is at least a tenth of the largest.
"""
import jax
import jax.numpy as jnp
import torch

from detail_tts_tpu.models.discriminator import MultiPeriodDiscriminator as JaxMPD
from detail_tts_tpu.models.synthesizer import SynthesizerTrn as JaxSynth
from detail_tts_tpu.serving.pipeline import variables_template
from detail_tts_tpu.train.optim import make_d_optimizer as jax_d_optimizer
from detail_tts_tpu.train.optim import make_optimizer as jax_make_optimizer
from detail_tts_tpu.train.step import TrainState as JaxTrainState
from detail_tts_tpu.train.step import make_gan_step as jax_gan_step
from detail_tts_tpu_torch.config import small_test_config
from detail_tts_tpu_torch.io.torch_convert import translate_discriminator
from detail_tts_tpu_torch.io.weights import from_jax_variables
from detail_tts_tpu_torch.models.synthesizer import FlowDraws, FlowVAEOutputs, SynthesizerTrn
from detail_tts_tpu_torch.nn.common import weight_norm_
from detail_tts_tpu_torch.train.optim import trainable_parameters
from tests import torch_dist
from tests.test_torch_gan import (_batch, _gan_cfg, _jax_first_moments,  # noqa: F401
                                  _jax_gan_draws, _seeded_wn, disc_pair)
from tests.test_torch_parallel import assert_metrics, assert_one_step
from tests.torch_parity import jax_dropout_off, synth_pair, t  # noqa: F401


def test_flowvae_world_2_equals_world_1_and_jax(tmp_path, monkeypatch, jax_dropout_off,
                                                disc_pair):
    jcfg = _gan_cfg(synth_pair()[0].cfg, "flowvae")
    model = JaxSynth(jcfg)
    jvars = _seeded_wn(lambda: variables_template(jcfg), 5)
    jvars["params"]["enc_q"]["proj"]["conv"]["kernel"] *= 0.1  # as test_gan_step_matches_jax
    d_vars, disc0 = disc_pair
    data = _batch(jcfg, 6)  # spec lengths 48 and 40: one row a rank
    rng = jax.random.PRNGKey(9)
    draws = _jax_gan_draws(jcfg, rng, data, monkeypatch, model, jvars)
    tx = jax_make_optimizer(jcfg, "flowvae", clip_norm=None)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jvars["params"],
                          vq_state=jvars["vq_state"], opt_state=tx.init(jvars["params"]),
                          d_params=d_vars["params"],
                          d_opt_state=jax_d_optimizer(jcfg).init(d_vars["params"]))
    new, jm = jax_gan_step(model, JaxMPD(), jcfg, donate=False)(
        state, {k: jnp.asarray(v) for k, v in data.items()}, rng)

    cfg = _gan_cfg(small_test_config(), "flowvae")
    port = weight_norm_(SynthesizerTrn(cfg))
    sd = from_jax_variables(port, jvars, cfg.diffusion.num_layers)[0]
    batch = {k: t(v) for k, v in data.items()}
    outs = torch_dist.spawn(torch_dist.train_steps, 2, tmp_path, cfg, sd, [batch], [draws],
                            disc0)
    one = torch_dist.train_steps(None, cfg, sd, [batch], [draws], disc0)
    forward = SynthesizerTrn.forward_flowvae

    def row_at_a_time(self, mel, spec, lengths, d, generator=None):
        rows = [forward(self, mel[i:i + 1], spec[i:i + 1], lengths[i:i + 1],
                        FlowDraws(d.noise[i:i + 1], d.starts[i:i + 1]), generator)
                for i in range(mel.shape[0])]
        return FlowVAEOutputs(*(torch.cat(x) for x in zip(*rows)))

    monkeypatch.setattr(SynthesizerTrn, "forward_flowvae", row_at_a_time)
    rowwise = torch_dist.train_steps(None, cfg, sd, [batch], [draws], disc0)

    for part in ("model", "disc"):
        for name, value in outs[0][part].items():
            assert torch.equal(value, outs[1][part][name]), f"{part}.{name}"
    to_port = lambda tree: from_jax_variables(  # noqa: E731
        port, {"params": tree, "vq_state": new.vq_state}, cfg.diffusion.num_layers)[0]
    to_disc = lambda tree: from_jax_variables(  # noqa: E731
        disc0, {"params": tree}, translate_fn=translate_discriminator)[0]
    jax_ref = {"model": (to_port(new.params),
                         to_port(_jax_first_moments(new.opt_state, jvars["params"]))),
               "disc": (to_disc(new.d_params),
                        to_disc(_jax_first_moments(new.d_opt_state, d_vars["params"])))}

    def port_ref(out):
        return {"model": (out["model"], out["moments"]), "disc": (out["disc"], out["d_moments"])}

    trainable = {"model": {n for n, _ in trainable_parameters(port, "flowvae")},
                 "disc": set(disc0.state_dict())}
    before = {"model": sd, "disc": disc0.state_dict()}
    moments_key = {"model": "moments", "disc": "d_moments"}
    for out, ref_metrics, ref, tol in (
            (outs[0], rowwise["metrics"][0], port_ref(rowwise), {}),
            (one, jm, jax_ref, {}),
            (outs[0], one["metrics"][0], port_ref(one), {"moment_atol": 2e-2, "sure": 0.1}),
            (outs[0], jm, jax_ref, {"moment_atol": 2e-2, "sure": 0.1})):
        assert_metrics(out["metrics"][0], ref_metrics)
        for part in ("model", "disc"):
            assert_one_step(out[part], out[moments_key[part]], *ref[part], before[part],
                            trainable[part], cfg, **tol)
    assert float(outs[0]["metrics"][0]["loss_kl"]) != 0.0
