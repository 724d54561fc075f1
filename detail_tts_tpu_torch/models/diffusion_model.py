"""Diffusion refiner network (``DiffusionTts``, diff_model.py:133-322), serving subset.

Counterpart of ``detail_tts_tpu/models/diffusion_model.py``: GPT latents
(B, T_code, in_latent) -> epsilon/variance over a 128-bin normalised mel at
4x the code rate.  ``cfg_call`` runs classifier-free guidance as one call on
2B rows [cond | uncond]: the unconditioned branch's code embedding is one
learned vector, so its conditioning-integrator output is the same for every
row and is computed once (B + 1 integrator rows instead of 2B).
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from detail_tts_tpu_torch.config import DiffusionConfig
from detail_tts_tpu_torch.nn.common import Conv1d, Dense, GroupNorm32
from detail_tts_tpu_torch.nn.diff_blocks import (AttentionBlock, DiffResBlock,
                                                 DiffusionLayer,
                                                 timestep_embedding)


class DiffusionTts(nn.Module):
    def __init__(self, cfg: DiffusionConfig):
        super().__init__()
        c = self.cfg = cfg
        mc = c.model_channels
        self.inp_block = Conv1d(c.in_channels, mc, 3, padding=1)
        self.time_embed = nn.Sequential(Dense(mc, mc), nn.SiLU(), Dense(mc, mc))
        self.code_norm = GroupNorm32(mc)
        self.latent_conditioner = nn.ModuleList(
            [Conv1d(c.in_latent_channels, mc, 3, padding=1)]
            + [AttentionBlock(mc, c.num_heads) for _ in range(4)])
        self.contextual_embedder = nn.ModuleList(
            [Conv1d(c.in_channels, mc, 3, stride=2, padding=1),
             Conv1d(mc, 2 * mc, 3, stride=2, padding=1)]
            + [AttentionBlock(2 * mc, c.num_heads) for _ in range(5)])
        # torch layout (1, mc, 1), as the reference stores it
        self.unconditioned_embedding = nn.Parameter(torch.randn(1, mc, 1))
        self.conditioning_timestep_integrator = nn.ModuleList(
            [DiffusionLayer(mc, c.num_heads) for _ in range(3)])
        self.integrating_conv = Conv1d(2 * mc, mc, 1)
        self.layers = nn.ModuleList(
            [DiffusionLayer(mc, c.num_heads) for _ in range(c.num_layers)]
            + [DiffResBlock(mc, mc) for _ in range(3)])
        self.out = nn.Sequential(GroupNorm32(mc), nn.SiLU(),
                                 Conv1d(mc, c.out_channels, 3, padding=1))

    def get_conditioning(self, mel: torch.Tensor) -> torch.Tensor:
        """Prompt mel (B, T_ref, in_channels) -> (B, 2 * model_channels)."""
        h = mel
        for blk in self.contextual_embedder:
            h = blk(h)
        return h.mean(dim=1)

    def timestep_independent(self, aligned_latent: torch.Tensor,
                             conditioning_latent: torch.Tensor,
                             expected_seq_len: int) -> torch.Tensor:
        """(B, T_code, in_latent) -> code embedding (B, expected_seq_len, mc)."""
        cond_scale, cond_shift = conditioning_latent.chunk(2, dim=-1)
        h = aligned_latent
        for blk in self.latent_conditioner:
            h = blk(h)
        h = self.code_norm(h) * (1 + cond_scale[:, None, :]) + cond_shift[:, None, :]
        # nearest-neighbour upsample to the mel frame rate
        reps = expected_seq_len // h.shape[1] if h.shape[1] else 4
        return h.repeat_interleave(reps, dim=1)[:, :expected_seq_len]

    def _time_emb(self, timesteps: torch.Tensor, dtype) -> torch.Tensor:
        temb = timestep_embedding(timesteps, self.cfg.model_channels).to(dtype)
        return self.time_embed(temb)

    def cfg_call(self, x: torch.Tensor, timesteps: torch.Tensor,
                 code_emb_cond: torch.Tensor,
                 precomputed_biases: Optional[List[torch.Tensor]] = None
                 ) -> torch.Tensor:
        """x/timesteps (2B, ...) = [cond | uncond] -> (2B, T, out_channels)."""
        b = code_emb_cond.shape[0]
        assert x.shape[0] == 2 * b
        temb = self._time_emb(timesteps, x.dtype)
        uncond = self.unconditioned_embedding.to(x.dtype).permute(0, 2, 1) \
            .expand(1, *code_emb_cond.shape[1:])
        ce = torch.cat([code_emb_cond.to(x.dtype), uncond], dim=0)
        temb_small = torch.cat([temb[:b], temb[b:b + 1]], dim=0)

        n_int = len(self.conditioning_timestep_integrator)
        biases = precomputed_biases or [None] * (n_int + self.cfg.num_layers)
        for j, blk in enumerate(self.conditioning_timestep_integrator):
            ce = blk(ce, temb_small, biases[j])
        code_emb = torch.cat([ce[:b], ce[b:].expand(b, *ce.shape[1:])], dim=0)

        h = self.integrating_conv(torch.cat([self.inp_block(x), code_emb], dim=-1))
        for i, lyr in enumerate(self.layers):
            if isinstance(lyr, DiffusionLayer):
                h = lyr(h, temb, biases[n_int + i])
            else:
                h = lyr(h, temb)
        h = F.silu(self.out[0](h.float()))  # fp32 tail
        return self.out[2](h)

    def attention_biases(self, length: int) -> List[torch.Tensor]:
        """Per-block LOG2-domain T5 biases (H, L, L), fp32: integrator blocks,
        then trunk layers.  Timestep-independent: computed once per length."""
        blocks = list(self.conditioning_timestep_integrator) + [
            lyr for lyr in self.layers if isinstance(lyr, DiffusionLayer)]
        return [blk.attn.bias_log2(length) for blk in blocks]
