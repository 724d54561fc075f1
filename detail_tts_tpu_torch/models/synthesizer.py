"""``SynthesizerTrn`` (vqvae/model_24k.py:510-881), NTC: serving and the
training stages.

Counterpart of ``detail_tts_tpu/models/synthesizer.py`` for zero-shot
synthesis (the GPT, the diffusion refiner and the flow-VAE + HiFi-GAN
decoder path), for the offline code extraction (``encode_masked``), for the
diffusion-free VQ paths (``decode_codes_to_mel``,
``infer_vqvae``: the VQ decoder with the VQ reference encoder's style) and
for every training stage's forward: ``forward_vq`` (recon L1 and the
commitment loss of the training quantizer), ``forward_gpt`` (the GPT's two
cross-entropies on frozen VQ codes), ``forward_diff`` (frozen VQ codes and
GPT latents, then the diffusion MSE + VB loss at random timesteps) and
``forward_flowvae`` (prior and posterior encoders, the flow and the vocoder
on a random segment: the GAN step's generator).  Waveforms are (B, T, 1).

Inference draws its one sample, the vocoder's prior noise in
``infer_flowvae``, under a JAX threefry key (``ops/prng.py``), as JAX does.
Training's random draws come in NamedTuples (:class:`DiffDraws`, ``VQDraws``,
:class:`FlowDraws`), drawn from the step's generator or handed in; dropout
masks come from the generator passed to each forward.  The frozen passes
(codes, GPT latents) draw nothing, as JAX runs them deterministic.  Under
data parallelism the draws are made for the global batch, identical on
every rank, and :func:`shard_draws` keeps a rank's rows.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from detail_tts_tpu_torch import tracing
from detail_tts_tpu_torch.audio.mel import FRAMES_PER_CODE, normalize_mel
from detail_tts_tpu_torch.config import Config
from detail_tts_tpu_torch.models.diffusion import (DiffusionSchedule,
                                                   get_named_beta_schedule,
                                                   space_timesteps,
                                                   training_losses)
from detail_tts_tpu_torch.models.diffusion_model import DiffusionTts
from detail_tts_tpu_torch.models.flowvae import PosteriorEncoder, SpecEncoder
from detail_tts_tpu_torch.models.gpt import UnifiedVoice
from detail_tts_tpu_torch.models.quantizer import (ResidualVectorQuantizer, VQDraws,
                                                   draw_codebook)
from detail_tts_tpu_torch.models.vocoder import HiFiGANGenerator
from detail_tts_tpu_torch.nn.common import (Conv1d, ConvTranspose1d, TorchLayerNorm,
                                            eval_mode, rand_slice_starts,
                                            sequence_mask, slice_segments)
from detail_tts_tpu_torch.nn.coupling import ResidualCouplingBlock
from detail_tts_tpu_torch.nn.style_encoder import MelStyleEncoder
from detail_tts_tpu_torch.ops import prng
from detail_tts_tpu_torch.parallel.mesh import Rows, shard_rows


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
        draws = torch.rand(n_layers, generator=generator, device=device) < 1.0 - d.layer_drop
        with tracing.wait("layer_drop"):
            draws = draws.tolist()
        keep = [True] + draws[1:-1] + [True]
    return DiffDraws(t, noise, uncond, tuple(keep))


def draw_vq(cfg: Config, mel_shape, generator, device) -> VQDraws:
    """The draws of one ``forward_vq`` call on a (B, T, n_mels) mel: the
    quantizer sees B x T' vectors, T' = T through two stride-2 convs."""
    frames = ((mel_shape[1] + 1) // 2 + 1) // 2
    v = cfg.vaegan
    return draw_codebook(v.vq_n_q, v.vq_bins, mel_shape[0] * frames, generator, device)


class FlowDraws(NamedTuple):
    """The random draws of one ``forward_flowvae`` call."""

    noise: torch.Tensor    # (B, T, inter_channels) standard normal: enc_q's sample
    starts: torch.Tensor   # (B,) frame starts of the vocoder's segment


def draw_flow(cfg: Config, lengths: torch.Tensor, frames: int, generator,
              device) -> FlowDraws:
    """Draw enc_q's noise, then the segment starts, from ``generator``."""
    noise = torch.randn((lengths.shape[0], frames, cfg.vaegan.inter_channels),
                        generator=generator, device=device)
    seg_frames = cfg.train.segment_size // cfg.data.hop_length
    return FlowDraws(noise, rand_slice_starts(lengths, seg_frames, generator))


def shard_draws(draws, group=None):
    """This rank's share of draws made for the global batch: the rows of
    :class:`DiffDraws`' ``t``, ``noise`` and ``uncond`` and of
    :class:`FlowDraws`; the layer-drop flags and ``VQDraws`` (indices into
    the global vectors) are every rank's."""
    if group is None or isinstance(draws, VQDraws):
        return draws
    if isinstance(draws, DiffDraws):
        return draws._replace(t=shard_rows(draws.t, group),
                              noise=shard_rows(draws.noise, group),
                              uncond=shard_rows(draws.uncond, group))
    return FlowDraws(*(shard_rows(x, group) for x in draws))


class FlowVAEOutputs(NamedTuple):
    y_hat_slice: torch.Tensor  # (B, segment_size, 1) generated wav segment
    ids_slice: torch.Tensor    # (B,) frame starts of the segment
    z: torch.Tensor
    z_p: torch.Tensor
    m_p: torch.Tensor
    logs_p: torch.Tensor
    m_q: torch.Tensor
    logs_q: torch.Tensor
    y_mask: torch.Tensor


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
                                 v.n_heads, v.n_layers, v.kernel_size, v.p_dropout)
        self.flow = ResidualCouplingBlock(inter, v.hidden_channels, 5, 1, 4,
                                          gin_channels=v.gin_channels)
        self.ref_enc = MelStyleEncoder(d.n_mel_channels,
                                       style_vector_dim=v.gin_channels)
        self.gpt = UnifiedVoice(cfg.gpt, remat=cfg.train.remat_gpt)
        self.quantizer = ResidualVectorQuantizer(
            inter * 4, n_q=v.vq_n_q, bins=v.vq_bins, codebook_dim=v.vq_codebook_dim,
            decay=v.vq_decay, threshold_ema_dead_code=v.vq_threshold_ema_dead_code,
            kmeans_iters=v.vq_kmeans_iters)
        # vq_enc (model_24k.py:606-615): the reference's transposes at 0 and 2
        # are identities on NTC tensors
        mel_ch = d.n_mel_channels
        self.vq_enc = nn.Sequential(
            nn.Identity(), TorchLayerNorm(mel_ch), nn.Identity(),
            Conv1d(mel_ch, inter * 2, 3, stride=2, padding=1), nn.SiLU(),
            Conv1d(inter * 2, inter * 4, 3, stride=2, padding=1), nn.SiLU(),
            Conv1d(inter * 4, inter * 4, 3, padding=1))
        # vq_dec and vq_ref_enc (model_24k.py:616-627), then enc_q, registered
        # after every earlier submodule so that seeded random weights of the
        # rest stay as they were
        self.vq_dec = nn.Sequential(
            nn.Identity(), TorchLayerNorm(inter * 4), nn.Identity(),
            ConvTranspose1d(inter * 4, inter * 2, 3, stride=2, padding=1,
                            output_padding=1), nn.SiLU(),
            ConvTranspose1d(inter * 2, inter, 3, stride=2, padding=1,
                            output_padding=1), nn.SiLU(),
            Conv1d(inter, mel_ch, 3, padding=1))
        # JAX runs it deterministic wherever it is called: no dropout
        self.vq_ref_enc = MelStyleEncoder(mel_ch, style_vector_dim=inter * 4,
                                          dropout=0.0)
        # the posterior encoder of the GAN step (model_24k.py:172-218)
        self.enc_q = PosteriorEncoder(d.spec_channels, inter, v.hidden_channels,
                                      kernel_size=5, dilation_rate=1, n_layers=16,
                                      gin_channels=v.gin_channels)

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

    def forward_vq(self, mel: torch.Tensor, mel_lengths: torch.Tensor,
                   draws: VQDraws, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """VQ-VAE stage (model_24k.py:654-666): (recon L1 in fp32, commit)
        through the training quantizer, which updates the codebook
        (``group``: the data-parallel process group, see the quantizer)."""
        x = self.vq_encode_features(mel)
        quantized, _, commit = self.quantizer(x, draws, group)
        recon = self.vq_decode_features(quantized + self.vq_style(mel, mel_lengths))
        return (recon.float() - mel.float()).abs().mean(), commit

    @torch.no_grad()
    def decode_codes_to_mel(self, codes: torch.Tensor, refer_mel: torch.Tensor,
                            refer_lengths: torch.Tensor) -> torch.Tensor:
        """VQ codes (B, Tc) -> mel (B, 4 Tc, n_mels) through ``vq_dec``,
        diffusion-free (model_24k.py:811-846)."""
        latent = self.quantizer.decode(codes[None])
        return self.vq_decode_features(latent + self.vq_style(refer_mel, refer_lengths))

    @torch.no_grad()
    def infer_vqvae(self, mel: torch.Tensor, key: prng.Seed = 0,
                    noise: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """VQ round trip and vocoder (model_24k.py:864-876): mel -> (the
        reconstructed mel, wav).  The eval quantizer call is encode then
        decode; ``key``/``noise`` feed the vocoder's prior sample."""
        lengths = torch.full((mel.shape[0],), mel.shape[1], dtype=torch.long,
                             device=mel.device)
        x = self.vq_encode_features(mel)
        q = self.quantizer.decode(self.quantizer.encode(x))
        recon = self.vq_decode_features(q + self.vq_style(mel, lengths))
        return recon, self.infer_flowvae(recon, lengths, key=key, noise=noise)

    @torch.no_grad()
    def encode(self, mel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Frozen code extraction (model_24k.py:877-880): (codes (B, T // 4),
        features)."""
        x = self.vq_encode_features(mel)
        return self.quantizer.encode(x)[0], x

    @torch.no_grad()
    def encode_masked(self, mel: torch.Tensor, lengths: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Length-exact code extraction on padded buffers: (codes (B, T // 4),
        code lengths (B,)).

        Each layer's activations past its valid length are zeroed, so the
        next conv sees the zero padding that an exact-length run (the
        reference's offline extractor, prepare/extract_vq.py:18-46) sees, and
        codes within the length do not depend on the pad.  A stride-2, k3,
        p1 conv maps a valid length L to ceil(L / 2)."""
        enc = self.vq_enc
        h = enc[1](mel) * sequence_mask(lengths, mel.shape[1])[..., None].to(mel.dtype)
        h = enc[4](enc[3](h))
        l1 = (lengths + 1) // 2
        h = h * sequence_mask(l1, h.shape[1])[..., None].to(h.dtype)
        h = enc[6](enc[5](h))
        l2 = (l1 + 1) // 2
        h = h * sequence_mask(l2, h.shape[1])[..., None].to(h.dtype)
        return self.quantizer.encode(enc[7](h))[0], l2

    @torch.no_grad()
    def gpt_latents(self, data: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Frozen aligned GPT latents for diffusion training
        (model_24k.py:674-679): (B, T_code, model_dim).  No dropout."""
        codes, _ = self.encode(data["raw_mel"])
        with eval_mode(self.gpt):
            return self.gpt(data["raw_mel"], data["raw_spec_length"], data["text"],
                            codes, data["raw_wav_length"])

    def forward_gpt(self, data: Dict[str, torch.Tensor],
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """GPT stage (model_24k.py:697-704): (loss_text, loss_mel) on the
        frozen codes of ``raw_mel``, conditioned on ``mel``; ``generator``
        gives the dropout masks in ``train()`` mode."""
        codes, _ = self.encode(data["raw_mel"])
        return self.gpt(data["mel"], data["spec_length"], data["text"], codes,
                        data["raw_wav_length"], return_latent=False,
                        generator=generator)

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

    def forward_flowvae(self, mel: torch.Tensor, spec: torch.Tensor,
                        lengths: torch.Tensor, draws: FlowDraws,
                        generator: Optional[torch.Generator] = None) -> FlowVAEOutputs:
        """GAN stage forward (model_24k.py:706-737): the style vector, the
        prior over ``mel``, the posterior sample over ``spec`` and its flow,
        and the vocoder on the segment of z at ``draws.starts``.
        ``generator`` gives the dropout masks (style and prior encoders) in
        ``train()`` mode."""
        seg_frames = self.cfg.train.segment_size // self.cfg.data.hop_length
        y_mask = sequence_mask(lengths, mel.shape[1])[..., None]
        g = self.ref_enc(mel * y_mask, y_mask[..., 0], generator)
        _, m_p, logs_p = self.enc_p(self.in_proj(mel), lengths, generator)
        z, m_q, logs_q = self.enc_q(spec, lengths, draws.noise, g=g)
        z_p = self.flow(z, y_mask, g=g)
        y_hat = self.dec(slice_segments(z, draws.starts, seg_frames), g=g)
        return FlowVAEOutputs(y_hat, draws.starts, z, z_p, m_p, logs_p, m_q,
                              logs_q, y_mask)

    def infer_flowvae(self, mel: torch.Tensor, lengths: torch.Tensor,
                      noise_scale: float = 0.667, key: prng.Seed = 0,
                      noise: Optional[torch.Tensor] = None,
                      rows: Optional[Rows] = None) -> torch.Tensor:
        """mel (B, T, n_mels) -> wav (B, T * hop, 1) (model_24k.py:848-863).

        The prior sample's standard-normal ``noise`` is drawn under ``key``
        (JAX's ``normal(key, m_p.shape)``) unless given, where ``rows``:
        ``mel`` is these rows of the request's."""
        y_mask = sequence_mask(lengths, mel.shape[1])[..., None]
        g = self.ref_enc(mel * y_mask, y_mask[..., 0])
        _, m_p, logs_p = self.enc_p(self.in_proj(mel), lengths)
        if noise is None:
            noise = prng.draw(key, m_p.shape, "normal",
                              offset=prng.row_offset(rows, m_p.shape), device=m_p.device)
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
