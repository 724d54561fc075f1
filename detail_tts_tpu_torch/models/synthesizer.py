"""``SynthesizerTrn`` serving subset (vqvae/model_24k.py:510-881), NTC.

Counterpart of ``detail_tts_tpu/models/synthesizer.py`` for zero-shot
synthesis: the GPT, the diffusion refiner and the flow-VAE + HiFi-GAN
decoder path.  Waveforms are (B, T, 1).  The quantizer, VQ encoder/decoder
and posterior encoder (training and VQ paths) are not ported yet.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from detail_tts_tpu_torch.audio.mel import FRAMES_PER_CODE
from detail_tts_tpu_torch.config import Config
from detail_tts_tpu_torch.models.diffusion import (DiffusionSchedule,
                                                   get_named_beta_schedule,
                                                   space_timesteps)
from detail_tts_tpu_torch.models.diffusion_model import DiffusionTts
from detail_tts_tpu_torch.models.flowvae import SpecEncoder
from detail_tts_tpu_torch.models.gpt import UnifiedVoice
from detail_tts_tpu_torch.models.vocoder import HiFiGANGenerator
from detail_tts_tpu_torch.nn.common import Conv1d, sequence_mask
from detail_tts_tpu_torch.nn.coupling import ResidualCouplingBlock
from detail_tts_tpu_torch.nn.style_encoder import MelStyleEncoder


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
