"""Serving engine: zero-shot synthesis (text + prompt wav -> 24 kHz wav).

Counterpart of ``detail_tts_tpu/serving/pipeline.py`` (``TTSEngine``,
``random_engine``), the reference's api.py -> ``SynthesizerTrn.infer``:

1. ``generate`` - AR mel-code decode with a KV cache;
2. ``latents``  - one GPT pass over the stop-filled, bucketed codes;
3. ``diffuse``  - 50-step CFG ancestral sampling, cond + uncond in one call
   per step, with the 13 T5 biases hoisted (LRU-cached per length);
4. ``vocode``   - flow-VAE prior sample -> reverse flow -> HiFi-GAN.

Prompt mels are padded up to a bucket with true per-item lengths (the masked
style encoders ignore the padding; the unmasked diffusion conditioning runs
each item at its own bucket), text and codes are padded up to buckets with
stop tokens.  On the card weights and activations are bf16 with fp32
islands (norm statistics, softmax, sampler and schedule math, STFT/mel, the
diffusion trunk's tail); the KV cache and the T5 biases are bf16.  TF32 is
off for both matmuls and convolutions.  All randomness of a request comes
from one ``torch.Generator`` seeded by the request's ``seed``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from detail_tts_tpu_torch.audio.mel import (FRAMES_PER_CODE, MelFrontend,
                                            denormalize_mel)
from detail_tts_tpu_torch.config import Config
from detail_tts_tpu_torch.io.weights import random_weights_
from detail_tts_tpu_torch.models.diffusion import p_sample_loop
from detail_tts_tpu_torch.models.gpt import SamplingConfig, generate_speech_tokens
from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn, make_infer_schedule
from detail_tts_tpu_torch.text.pinyin import to_pinyin
from detail_tts_tpu_torch.text.tokenizer import make_tokenizer


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving knobs (defaults = the reference's shipped settings)."""

    temperature: float = 0.8
    top_p: float = 0.8
    repetition_penalty: float = 2.0
    max_generate_length: int = 600
    typical_mass: float = 1.0         # < 1.0 enables entropy-typical sampling
    noise_scale: float = 0.667
    diffusion_temperature: float = 1.0
    diffusion_steps: Optional[int] = None  # None: cfg.diffusion.infer_steps
    text_buckets: Sequence[int] = (32, 64, 128, 256, 512, 800)
    prompt_buckets: Sequence[int] = (64, 128, 256, 512, 1024, 1600)
    code_buckets: Sequence[int] = (100, 200, 300, 400, 500, 600)
    bias_cache_buckets: int = 2       # code lengths whose 13 biases are kept
    cache_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16


def _bucket_up(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def resolve_device(device) -> torch.device:
    """The device asked for; CUDA must be present unless the CPU is asked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run "
                           "the port on the CPU")
    return dev


def _clamp_to_model(cfg: Config, ecfg: EngineConfig) -> EngineConfig:
    """Cap decode length and buckets at the GPT's position tables."""
    mel_cap, txt_cap = cfg.gpt.max_mel_tokens, cfg.gpt.max_text_tokens
    text_buckets = tuple(ecfg.text_buckets)
    if text_buckets[-1] > txt_cap:
        text_buckets = tuple(b for b in text_buckets if b < txt_cap) + (txt_cap,)
    return dataclasses.replace(
        ecfg, max_generate_length=min(ecfg.max_generate_length, mel_cap),
        text_buckets=text_buckets,
        code_buckets=tuple(b for b in ecfg.code_buckets if b <= mel_cap) or (mel_cap,))


class TTSEngine:
    """Serving engine around a ``SynthesizerTrn`` with loaded weights."""

    def __init__(self, model: SynthesizerTrn,
                 engine_cfg: EngineConfig = EngineConfig(), device="cuda",
                 tokenizer=None):
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = self.cfg = model.cfg
        self.ecfg = _clamp_to_model(cfg, engine_cfg)
        self.cdt = self.ecfg.compute_dtype
        self.model = model.to(device=self.device, dtype=self.cdt).eval()
        self.model.requires_grad_(False)
        d = cfg.data
        self.frontend = MelFrontend(d.sampling_rate, d.filter_length,
                                    d.hop_length, d.win_length,
                                    d.n_mel_channels, d.mel_fmin, d.mel_fmax,
                                    device=self.device)
        sched_cfg = cfg
        if self.ecfg.diffusion_steps is not None:
            sched_cfg = dataclasses.replace(cfg, diffusion=dataclasses.replace(
                cfg.diffusion, infer_steps=self.ecfg.diffusion_steps))
        self.schedule = make_infer_schedule(sched_cfg, device=self.device)
        self.tokenizer = tokenizer or make_tokenizer(d.tokenizer_vocab)
        self._bias_cache: "OrderedDict[int, List[torch.Tensor]]" = OrderedDict()

    # ------------------------------------------------------------- host prep

    def prepare_text(self, texts: Sequence[str]) -> Tuple[torch.Tensor, np.ndarray]:
        """pinyin -> BPE -> right-pad with stop (0) to a shared text bucket."""
        cap = self.ecfg.text_buckets[-1] - 1
        encoded = [self.tokenizer.encode(to_pinyin(t))[:cap] for t in texts]
        lengths = np.array([len(e) for e in encoded], np.int64)
        width = _bucket_up(int(lengths.max()) + 1, self.ecfg.text_buckets)
        out = np.zeros((len(texts), width), np.int64)
        for i, e in enumerate(encoded):
            out[i, :len(e)] = e
        return torch.as_tensor(out, device=self.device), lengths

    def prepare_prompt(self, wavs: Sequence[np.ndarray]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """24 kHz waveforms -> fp32 prompt mels padded up to a bucket, and
        the true per-item frame counts.  Wavs are zero-padded to a 0.5 s grid
        before the STFT (one batched STFT per padded length); each item keeps
        its own frames, cropped to the largest bucket."""
        hop = self.cfg.data.hop_length
        chunk = self.cfg.data.sampling_rate // 2
        cap = self.ecfg.prompt_buckets[-1]
        padded = []
        for i, w in enumerate(wavs):
            w = np.asarray(w, np.float32)
            n_true = w.shape[-1] // hop
            if n_true < 1:
                raise ValueError(f"prompt wav {i} too short: {w.shape[-1]} "
                                 f"samples (< one hop of {hop})")
            padded.append((np.pad(w, (0, (-len(w)) % chunk)), min(n_true, cap)))
        mels: List[Optional[torch.Tensor]] = [None] * len(wavs)
        for plen in sorted({p.shape[-1] for p, _ in padded}):
            idx = [i for i, (p, _) in enumerate(padded) if p.shape[-1] == plen]
            stack = torch.as_tensor(np.stack([padded[i][0] for i in idx]),
                                    device=self.device)
            batch = self.frontend.mel_spectrogram(stack)
            for j, i in enumerate(idx):
                mels[i] = batch[j, :padded[i][1]]
        lengths = [m.shape[0] for m in mels]
        width = _bucket_up(max(lengths), self.ecfg.prompt_buckets)
        out = torch.zeros((len(wavs), width, mels[0].shape[1]),
                          dtype=torch.float32, device=self.device)
        for i, m in enumerate(mels):
            out[i, :m.shape[0]] = m
        return out, torch.as_tensor(lengths, device=self.device)

    # ---------------------------------------------------------------- stages

    def diffusion_cond(self, refer_mel: torch.Tensor,
                       refer_len: torch.Tensor) -> torch.Tensor:
        """(B, 2 * mc) conditioning, each item at its own prompt bucket (the
        contextual embedder is unmasked, so the amount of trailing zero
        padding must not depend on the batch)."""
        t_max = refer_mel.shape[1]
        buckets = [min(_bucket_up(int(n), self.ecfg.prompt_buckets), t_max)
                   for n in refer_len.tolist()]
        out: List[Optional[torch.Tensor]] = [None] * len(buckets)
        for lb in sorted(set(buckets)):
            idx = [i for i, b in enumerate(buckets) if b == lb]
            group = refer_mel[idx, :lb].to(self.cdt)
            cond = self.model.diffusion_conditioning(group)
            for j, i in enumerate(idx):
                out[i] = cond[j:j + 1]
        return torch.cat(out, dim=0)

    def attention_biases(self, out_len: int) -> List[torch.Tensor]:
        """The 13 hoisted log2-domain T5 biases for ``out_len``, LRU-cached."""
        cached = self._bias_cache.get(out_len)
        if cached is not None:
            self._bias_cache.move_to_end(out_len)
            return cached
        biases = [b.to(self.cdt) for b in
                  self.model.diffusion_attention_biases(out_len)]
        self._bias_cache[out_len] = biases
        while len(self._bias_cache) > max(self.ecfg.bias_cache_buckets, 1):
            self._bias_cache.popitem(last=False)
        return biases

    @staticmethod
    def _effective_lengths(n: int, lengths: torch.Tensor, max_len: int,
                           force_full: bool) -> np.ndarray:
        """Decoded lengths with the final token dropped (the reference's
        ``codes[:, :-1]``); under ``force_full`` every row is ``max_len - 1``."""
        if force_full:
            return np.full((n,), max(max_len - 1, 1), np.int64)
        return np.maximum(lengths.cpu().numpy() - 1, 1).astype(np.int64)

    def generate_codes(self, refer_mel, refer_len, text, generator,
                       force_full: bool = False,
                       max_len: Optional[int] = None):
        """AR decode -> (codes (B, max_len), effective lengths (B,))."""
        e = self.ecfg
        max_len = max_len or e.max_generate_length
        sampling = SamplingConfig(
            temperature=e.temperature, top_p=e.top_p,
            repetition_penalty=e.repetition_penalty,
            typical_mass=e.typical_mass, max_generate_length=max_len,
            force_full_length=force_full)
        codes, lengths = generate_speech_tokens(
            self.model.gpt, refer_mel.to(self.cdt), refer_len, text, sampling,
            generator=generator, cache_dtype=e.cache_dtype)
        return codes, self._effective_lengths(codes.shape[0], lengths,
                                              max_len, force_full)

    def _pad_codes(self, codes: torch.Tensor, eff: np.ndarray):
        """Crop codes to a bucket and stop-fill past each effective length."""
        bucket = min(_bucket_up(int(eff.max()), self.ecfg.code_buckets),
                     codes.shape[1])
        eff_t = torch.as_tensor(eff, device=codes.device)
        pos = torch.arange(bucket, device=codes.device)[None, :]
        codes_b = torch.where(pos < eff_t[:, None], codes[:, :bucket],
                              self.cfg.gpt.stop_mel_token)
        return codes_b, eff_t * self.cfg.gpt.mel_length_compression, bucket

    def diffuse(self, latents: torch.Tensor, cond_latent: torch.Tensor,
                biases: List[torch.Tensor], generator) -> torch.Tensor:
        """latents (B, Tc, D) -> denormalised mel (B, 4 Tc, n_mels), fp32."""
        code_emb = self.model.diffusion_code_embedding(
            latents.to(self.cdt), cond_latent.to(self.cdt))

        def model_fn(x2, t2):
            return self.model.diffusion_cfg_step(x2.to(self.cdt), t2, code_emb,
                                                 biases)

        shape = (latents.shape[0], latents.shape[1] * FRAMES_PER_CODE,
                 self.cfg.diffusion.in_channels)
        noise = torch.randn(shape, generator=generator, device=self.device) \
            * self.ecfg.diffusion_temperature
        mel = p_sample_loop(self.schedule, model_fn, noise,
                            cond_free_k=self.cfg.diffusion.cond_free_k,
                            generator=generator)
        return denormalize_mel(mel)

    # --------------------------------------------------------------- requests

    @torch.inference_mode()
    def synthesize_batch(self, texts: Sequence[str],
                         prompt_wavs: Sequence[np.ndarray], seed: int = 0,
                         force_full: bool = False,
                         timings: Optional[Dict[str, float]] = None
                         ) -> List[np.ndarray]:
        """Full pipeline (reference ``infer``, model_24k.py:774-810).

        ``timings``: optional dict; when given, each stage ends in a device
        synchronisation and its wall time is added under its name.  Each
        stage is also a ``torch.profiler`` range of that name.
        """

        @contextlib.contextmanager
        def stage(name):
            with torch.profiler.record_function(name):
                t0 = time.perf_counter()
                yield
                if timings is not None:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0

        gen = torch.Generator(device=self.device).manual_seed(seed)
        with stage("prepare"):
            text, _ = self.prepare_text(texts)
            refer_mel, refer_len = self.prepare_prompt(prompt_wavs)
        with stage("generate"):
            codes, eff = self.generate_codes(refer_mel, refer_len, text, gen,
                                             force_full=force_full)
        with stage("diff_cond"):
            diff_cond = self.diffusion_cond(refer_mel, refer_len)
        with stage("latents"):
            codes_b, wav_len, bucket = self._pad_codes(codes, eff)
            latents = self.model.gpt(refer_mel.to(self.cdt), refer_len, text,
                                     codes_b, wav_len)
        with stage("diffuse"):
            mel = self.diffuse(latents, diff_cond,
                               self.attention_biases(bucket * FRAMES_PER_CODE), gen)
        with stage("vocode"):
            mel_len = torch.as_tensor(eff * FRAMES_PER_CODE, device=self.device)
            wav = self.model.infer_flowvae(mel.to(self.cdt), mel_len,
                                           self.ecfg.noise_scale, generator=gen)
        with stage("host"):
            wav = wav[..., 0].float().cpu().numpy()
            hop_per_code = self.cfg.gpt.mel_length_compression
            outs = [wav[i, :int(eff[i]) * hop_per_code] for i in range(len(texts))]
        return outs

    def synthesize(self, text: str, prompt_wav: np.ndarray,
                   seed: int = 0) -> np.ndarray:
        """Single-utterance convenience (the api.py surface)."""
        return self.synthesize_batch([text], [prompt_wav], seed)[0]


def random_engine(cfg: Optional[Config] = None, seed: int = 0,
                  engine_cfg: EngineConfig = EngineConfig(),
                  device="cuda") -> TTSEngine:
    """Engine with seeded random weights made on ``device`` (tests, smoke)."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = SynthesizerTrn(cfg or Config())
    random_weights_(model, seed)
    return TTSEngine(model, engine_cfg, device=dev)
