"""Port flow-VAE decode (``infer_flowvae``: prior encoder, reverse flow,
HiFi-GAN) vs the JAX one with ``noise_scale=0``, which makes it
deterministic."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.torch_parity import close, japply, synth_pair, t


def test_infer_flowvae_matches_with_zero_noise_scale():
    port = synth_pair()[2]
    mel = np.random.default_rng(0).normal(-5, 2, size=(2, 20, 128)).astype(np.float32)
    lengths = np.array([20, 13], np.int32)
    ref = japply(lambda m, x, n: m.infer_flowvae(x, n, jax.random.PRNGKey(0),
                                                 noise_scale=0.0),
                 jnp.asarray(mel), jnp.asarray(lengths))
    ours = port.infer_flowvae(t(mel), t(lengths, torch.long), noise_scale=0.0,
                              generator=torch.Generator().manual_seed(0))
    assert ours.shape == (2, 20 * 256, 1)
    close(ours, ref)


