"""``SynthesizerTrn`` (vqvae/model_24k.py:510-881), NTC: serving and the
diffusion training stage.

Counterpart of ``detail_tts_tpu/models/synthesizer.py`` for zero-shot
synthesis (the GPT, the diffusion refiner and the flow-VAE + HiFi-GAN
decoder path), for the diffusion-free VQ paths (``decode_codes_to_mel``,
``infer_vqvae``: the VQ decoder with the VQ reference encoder's style) and
for target ``diff``'s loss, ``forward_diff``: frozen VQ codes (``vq_enc`` +
the quantizer's encode) and GPT latents, then the diffusion MSE + VB loss at
random timesteps.  Waveforms are (B, T, 1).  The training quantizer, the
posterior encoder and the GPT's text head (the other training targets) are
not ported yet.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from detail_tts_tpu_torch.audio.mel import FRAMES_PER_CODE, normalize_mel
from detail_tts_tpu_torch.config import Config
from detail_tts_tpu_torch.models.diffusion import (DiffusionSchedule,
                                                   get_named_beta_schedule,
                                                   space_timesteps,
                                                   training_losses)
from detail_tts_tpu_torch.models.diffusion_model import DiffusionTts
from detail_tts_tpu_torch.models.flowvae import SpecEncoder
from detail_tts_tpu_torch.models.gpt import UnifiedVoice
from detail_tts_tpu_torch.models.quantizer import ResidualVectorQuantizer
from detail_tts_tpu_torch.models.vocoder import HiFiGANGenerator
from detail_tts_tpu_torch.nn.common import (Conv1d, ConvTranspose1d,
                                            TorchLayerNorm, sequence_mask)
from detail_tts_tpu_torch.nn.coupling import ResidualCouplingBlock
from detail_tts_tpu_torch.nn.style_encoder import MelStyleEncoder


def make_train_schedule(cfg: Config, device="cpu") -> DiffusionSchedule:
    """train_sample_steps-of-trained_steps spaced training diffuser
    (model_24k.py:578-580)."""
    d = cfg.diffusion
    return DiffusionSchedule.create(
        get_named_beta_schedule("linear", d.trained_steps),
        space_timesteps(d.trained_steps, [d.train_sample_steps]), device=device)


class DiffDraws(NamedTuple):
    """The random draws of one ``forward_diff`` call."""

    t: torch.Tensor        # (B,) spaced timesteps
    noise: torch.Tensor    # x_start's shape, standard normal
    uncond: torch.Tensor   # (B,) bool: rows switched to the unconditioned embedding
    keep: Tuple[bool, ...]  # one flag per diffusion layer (layer drop)


def draw_diff(cfg: Config, schedule: DiffusionSchedule, shape, generator,
              device, train: bool = True) -> DiffDraws:
    """Draw t, noise, the unconditioned mask and the layer-drop keep flags
    from ``generator``, in that order.  Layers other than the first and last
    are dropped with probability ``layer_drop`` when ``train``; the flags
    come to the host (one synchronisation) because they choose the layers
    that run."""
    d = cfg.diffusion
    b = shape[0]
    t = torch.randint(0, schedule.num_timesteps, (b,), generator=generator,
                      device=device)
    noise = torch.randn(shape, generator=generator, device=device)
    uncond = torch.rand(b, generator=generator, device=device) < d.unconditioned_percentage
    n_layers = d.num_layers + 3
    keep = [True] * n_layers
    if train and d.layer_drop > 0:
        draws = (torch.rand(n_layers, generator=generator, device=device)
                 < 1.0 - d.layer_drop).tolist()
        keep = [True] + draws[1:-1] + [True]
    return DiffDraws(t, noise, uncond, tuple(keep))


def make_infer_schedule(cfg: Config, device="cpu") -> DiffusionSchedule:
    """infer_steps-of-trained_steps spaced inference diffuser (model_24k.py:581-583)."""
    d = cfg.diffusion
    return DiffusionSchedule.create(
        get_named_beta_schedule("linear", d.trained_steps),
        space_timesteps(d.trained_steps, [d.infer_steps]), device=device)


class SynthesizerTrn(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        v, d = cfg.vaegan, cfg.data
        inter = v.inter_channels
        self.dec = HiFiGANGenerator(
            inter, v.resblock, tuple(v.resblock_kernel_sizes),
            tuple(map(tuple, v.resblock_dilation_sizes)),
            tuple(v.upsample_rates), v.upsample_initial_channel,
            tuple(v.upsample_kernel_sizes), gin_channels=v.gin_channels)
        self.diffusion = DiffusionTts(cfg.diffusion)
        self.in_proj = Conv1d(d.n_mel_channels, inter, 3, padding=1)
        self.enc_p = SpecEncoder(inter, v.hidden_channels, v.filter_channels,
                                 v.n_heads, v.n_layers, v.kernel_size)
        self.flow = ResidualCouplingBlock(inter, v.hidden_channels, 5, 1, 4,
                                          gin_channels=v.gin_channels)
        self.ref_enc = MelStyleEncoder(d.n_mel_channels,
                                       style_vector_dim=v.gin_channels)
        self.gpt = UnifiedVoice(cfg.gpt)
        self.quantizer = ResidualVectorQuantizer(
            inter * 4, n_q=v.vq_n_q, bins=v.vq_bins, codebook_dim=v.vq_codebook_dim)
        # vq_enc (model_24k.py:606-615): the reference's transposes at 0 and 2
        # are identities on NTC tensors
        mel_ch = d.n_mel_channels
        self.vq_enc = nn.Sequential(
            nn.Identity(), TorchLayerNorm(mel_ch), nn.Identity(),
            Conv1d(mel_ch, inter * 2, 3, stride=2, padding=1), nn.SiLU(),
            Conv1d(inter * 2, inter * 4, 3, stride=2, padding=1), nn.SiLU(),
            Conv1d(inter * 4, inter * 4, 3, padding=1))
        # vq_dec and vq_ref_enc (model_24k.py:616-627), registered after every
        # other submodule so that seeded random weights of the rest stay as
        # they were
        self.vq_dec = nn.Sequential(
            nn.Identity(), TorchLayerNorm(inter * 4), nn.Identity(),
            ConvTranspose1d(inter * 4, inter * 2, 3, stride=2, padding=1,
                            output_padding=1), nn.SiLU(),
            ConvTranspose1d(inter * 2, inter, 3, stride=2, padding=1,
                            output_padding=1), nn.SiLU(),
            Conv1d(inter, mel_ch, 3, padding=1))
        self.vq_ref_enc = MelStyleEncoder(mel_ch, style_vector_dim=inter * 4)

    # ------------------------------------------------------------------- VQ

    def vq_encode_features(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, T, n_mels) -> (B, T // 4, 4 * inter_channels)."""
        return self.vq_enc(mel)

    def vq_decode_features(self, q: torch.Tensor) -> torch.Tensor:
        """(B, T // 4, 4 * inter_channels) -> mel (B, T, n_mels)."""
        return self.vq_dec(q)

    def vq_style(self, mel: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """The VQ reference encoder's style vector of a masked mel, (B, 1, D)."""
        mask = sequence_mask(lengths, mel.shape[1])
        return self.vq_ref_enc(mel * mask[..., None].to(mel.dtype), mask)[:, None, :]

    @torch.no_grad()
    def decode_codes_to_mel(self, codes: torch.Tensor, refer_mel: torch.Tensor,
                            refer_lengths: torch.Tensor) -> torch.Tensor:
        """VQ codes (B, Tc) -> mel (B, 4 Tc, n_mels) through ``vq_dec``,
        diffusion-free (model_24k.py:811-846)."""
        latent = self.quantizer.decode(codes[None])
        return self.vq_decode_features(latent + self.vq_style(refer_mel, refer_lengths))

    @torch.no_grad()
    def infer_vqvae(self, mel: torch.Tensor, generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """VQ round trip and vocoder (model_24k.py:864-876): mel -> (the
        reconstructed mel, wav).  The eval quantizer call is encode then
        decode; ``generator``/``noise`` feed the vocoder's prior sample."""
        lengths = torch.full((mel.shape[0],), mel.shape[1], dtype=torch.long,
                             device=mel.device)
        x = self.vq_encode_features(mel)
        q = self.quantizer.decode(self.quantizer.encode(x))
        recon = self.vq_decode_features(q + self.vq_style(mel, lengths))
        return recon, self.infer_flowvae(recon, lengths, generator=generator, noise=noise)

    @torch.no_grad()
    def encode(self, mel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Frozen code extraction (model_24k.py:877-880): (codes (B, T // 4),
        features)."""
        x = self.vq_encode_features(mel)
        return self.quantizer.encode(x)[0], x

    @torch.no_grad()
    def gpt_latents(self, data: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Frozen aligned GPT latents for diffusion training
        (model_24k.py:674-679): (B, T_code, model_dim)."""
        codes, _ = self.encode(data["raw_mel"])
        return self.gpt(data["raw_mel"], data["raw_spec_length"], data["text"],
                        codes, data["raw_wav_length"])

    # ------------------------------------------------------------ diffusion

    def forward_diff(self, data: Dict[str, torch.Tensor],
                     schedule: DiffusionSchedule, draws: DiffDraws,
                     latents: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Diffusion stage (model_24k.py:667-696): the scalar loss.

        ``draws`` holds the call's random draws (:func:`draw_diff`);
        ``latents`` the frozen GPT latents if already computed; ``generator``
        the source of the diffusion net's dropout masks (required in
        ``train()`` mode when ``DiffusionConfig.dropout`` > 0)."""
        x_start = normalize_mel(data["raw_mel"])
        x_t = schedule.q_sample(x_start, draws.t, draws.noise)
        if latents is None:
            latents = self.gpt_latents(data)
        cond_latent = self.diffusion.get_conditioning(data["mel"])
        code_emb = self.diffusion.timestep_independent(
            latents, cond_latent, x_start.shape[1], unconditioned_mask=draws.uncond)
        out = self.diffusion(x_t, schedule.timestep_map[draws.t], code_emb,
                             keep=draws.keep, generator=generator)
        eps, var_logits = out.chunk(2, dim=-1)
        return training_losses(schedule, eps, var_logits, x_start, x_t, draws.t,
                               draws.noise).mean()

    def infer_flowvae(self, mel: torch.Tensor, lengths: torch.Tensor,
                      noise_scale: float = 0.667,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mel (B, T, n_mels) -> wav (B, T * hop, 1) (model_24k.py:848-863).

        The prior sample's standard-normal ``noise`` is drawn from
        ``generator`` unless given."""
        y_mask = sequence_mask(lengths, mel.shape[1])[..., None]
        g = self.ref_enc(mel * y_mask, y_mask[..., 0])
        _, m_p, logs_p = self.enc_p(self.in_proj(mel), lengths)
        if noise is None:
            noise = torch.randn(m_p.shape, generator=generator, device=m_p.device)
        z_p = m_p + noise.to(m_p.dtype) * torch.exp(logs_p) * noise_scale
        z = self.flow.reverse(z_p, y_mask, g=g)
        return self.dec(z, g=g)

    def diffusion_conditioning(self, refer_mel: torch.Tensor) -> torch.Tensor:
        return self.diffusion.get_conditioning(refer_mel)

    def diffusion_code_embedding(self, latents: torch.Tensor,
                                 cond_latent: torch.Tensor) -> torch.Tensor:
        """The timestep-independent embedding, computed once per request."""
        return self.diffusion.timestep_independent(
            latents, cond_latent, latents.shape[1] * FRAMES_PER_CODE)

    def diffusion_cfg_step(self, x2: torch.Tensor, t_orig2: torch.Tensor,
                           code_emb_cond: torch.Tensor,
                           attn_biases: Optional[List[torch.Tensor]] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One CFG net call on 2B rows [cond | uncond] -> (eps, var_logits)."""
        out = self.diffusion.cfg_call(x2, t_orig2, code_emb_cond,
                                      precomputed_biases=attn_biases)
        return out.chunk(2, dim=-1)

    def diffusion_attention_biases(self, length: int) -> List[torch.Tensor]:
        return self.diffusion.attention_biases(length)
