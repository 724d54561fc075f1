"""Serving engine: zero-shot synthesis (text + prompt wav -> 24 kHz wav).

Counterpart of ``detail_tts_tpu/serving/pipeline.py`` (``TTSEngine``,
``random_engine``), the reference's api.py -> ``SynthesizerTrn.infer``:

1. ``generate`` - AR mel-code decode with a KV cache;
2. ``latents``  - one GPT pass over the stop-filled, bucketed codes;
3. ``diffuse``  - CFG sampling (50-step ancestral by default; DDIM and the
   two DPM-Solver++(2M) samplers on request), cond + uncond in one call
   per model evaluation, with the 13 T5 biases hoisted (LRU-cached per
   length);
4. ``vocode``   - flow-VAE prior sample -> reverse flow -> HiFi-GAN, with
   an optional int16 conversion on the device.

The diffusion-free path ``synthesize_vq_batch`` mirrors ``infer_gpt``
(model_24k.py:811-846) and ``vq_roundtrip`` ``infer_vqvae`` (:864).  A
request can be split in two dispatches around another batch's finalize
(``dispatch_decode`` / ``dispatch_tail`` / ``finalize_batch``), which the
microbatching server uses.

Prompt mels are padded up to a bucket with true per-item lengths (the masked
style encoders ignore the padding; the unmasked diffusion conditioning runs
each item at its own bucket), text and codes are padded up to buckets with
stop tokens.  On the card weights and activations are bf16 with fp32
islands (norm statistics, softmax, sampler and schedule math, STFT/mel, the
diffusion trunk's tail); the KV cache and the T5 biases are bf16.  TF32 is
off for both matmuls and convolutions.  All randomness of a request comes
from JAX's threefry key tree (``ops/prng.py``, the ``threefry_draw`` kernel
on the card), as the JAX engine draws it: ``seed`` means ``PRNGKey(seed)``
(or is a key), split into the decode's, the diffusion's and the vocoder's
keys (``g, d, v = split(key, 3)``); the decode takes one key a step from
the chain ``rng, key = split(rng)``, the diffusion splits ``d`` into the
initial noise's key and the ancestral steps' keys.  An element of a draw
depends on the key and its flat index only, so a row's audio does not
depend on the rows batched after it.

Sharded serving (``TTSEngine(mesh=)``, a ``parallel.mesh.Mesh`` of the
ranks, one process a card; JAX's engine on a ``(data, model)`` mesh): every
rank calls the same method with the whole request, in SPMD style, and gets
every item's audio.  The rows are split over the data group (every rank
runs every row where D does not divide the batch, as JAX's ``shard_batch``
replicates what it cannot split); the GPT is sharded over the model group
(``shard_module_``), the rest replicated.  So that a rank's rows come out
as on one card: a rank draws only its rows' elements of each draw, from
the offset of its first row (``prng.row_offset``); the text, prompt and
code buckets are agreed over the data group (a text bucket of another
width moves every mel position of the GPT's input); the decode's early stop
waits for every row; and the audio is gathered to every rank before it is
cut to length.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from detail_tts_tpu_torch import tracing
from detail_tts_tpu_torch.audio.mel import (FRAMES_PER_CODE, MelFrontend,
                                            denormalize_mel)
from detail_tts_tpu_torch.config import Config
from detail_tts_tpu_torch.io.weights import random_weights_
from detail_tts_tpu_torch.models.diffusion import (ddim_sample_loop,
                                                   dpmpp_2m_reference_sample_loop,
                                                   dpmpp_2m_sample_loop,
                                                   p_sample_loop)
from detail_tts_tpu_torch.models.gpt import SamplingConfig, generate_speech_tokens
from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn, make_infer_schedule
from detail_tts_tpu_torch.ops import prng
from detail_tts_tpu_torch.parallel.mesh import (Mesh, Rows, all_gather_host,
                                                all_gather_rows, all_reduce_max_host,
                                                shard_module_)
from detail_tts_tpu_torch.text.pinyin import to_pinyin
from detail_tts_tpu_torch.text.tokenizer import make_tokenizer

# 'ancestral' is the reference's live path (p_sample_loop, model_24k.py:489);
# 'dpmpp_2m' its configured sampler (model_24k.py:583 -> DPM_Solver);
# 'ddim' and 'dpmpp_2m_karras' (ramped-k discrete-karras variant) extra.
SAMPLERS = ("ancestral", "ddim", "dpmpp_2m", "dpmpp_2m_karras")


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
    diffusion_sampler: str = "ancestral"   # one of SAMPLERS
    # None: cfg.diffusion.infer_steps; fewer steps trade refinement for
    # latency about linearly (25 + dpmpp_2m is the fast mode)
    diffusion_steps: Optional[int] = None
    # int16 PCM made on the device before the host copy (half the bytes)
    pcm16_output: bool = False
    text_buckets: Sequence[int] = (32, 64, 128, 256, 512, 800)
    prompt_buckets: Sequence[int] = (64, 128, 256, 512, 1024, 1600)
    code_buckets: Sequence[int] = (100, 200, 300, 400, 500, 600)
    bias_cache_buckets: int = 2       # code lengths whose 13 biases are kept
    cache_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.diffusion_sampler not in SAMPLERS:
            raise ValueError(f"diffusion_sampler {self.diffusion_sampler!r} "
                             f"is not one of {SAMPLERS}")


def to_pcm16(wav: torch.Tensor) -> torch.Tensor:
    """Clip to [-1, 1], scale by 32767, round half to even, int16."""
    return torch.round(wav.float().clamp(-1, 1) * 32767.0).to(torch.int16)


@dataclasses.dataclass
class InflightBatch:
    """Handle of a dispatched batch whose audio is not fetched yet (see
    :meth:`TTSEngine.dispatch_batch`): ``wav`` is the device output, ``eff``
    the per-item code lengths on the host.  It holds device memory until
    finalized."""

    wav: torch.Tensor
    eff: np.ndarray
    n: int
    rows: Optional[Rows] = None  # this data rank's rows of the request
    trace: Optional[tracing.Span] = None  # the batch's root span


@dataclasses.dataclass
class PendingDecode:
    """Handle from :meth:`TTSEngine.dispatch_decode`: the AR decode and the
    diffusion conditioning are enqueued on the device, and the decode-length
    (``eff``) synchronisation that :meth:`TTSEngine.dispatch_tail` makes has
    not happened yet, so a server can finalize the previous batch between
    the two.  ``d_key`` and ``v_key`` are the request's diffusion and
    vocoder keys, for the later stages."""

    codes: torch.Tensor
    lengths: Optional[torch.Tensor]  # device tensor; None under force_full
    codes_done: Optional[torch.cuda.Event]
    diff_cond: torch.Tensor
    refer_mel: torch.Tensor
    refer_len: torch.Tensor
    text: torch.Tensor
    d_key: prng.Key
    v_key: prng.Key
    n: int
    max_len: int
    force_full: bool
    timings: Optional[Dict[str, float]] = None
    rows: Optional[Rows] = None  # this data rank's rows of the request
    trace: Optional[tracing.Span] = None  # the batch's root span


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


def _take(items, rows: Optional[Rows]):
    return items if rows is None else items[rows.start:rows.stop]


class TTSEngine:
    """Serving engine around a ``SynthesizerTrn`` with loaded weights.

    ``mesh``: a ``parallel.mesh.Mesh`` of the ranks, each rank's engine on
    its own ``device`` (see the module's docstring); its GPT is sharded
    here.  ``None`` is the one-card engine, bit for bit."""

    def __init__(self, model: SynthesizerTrn,
                 engine_cfg: EngineConfig = EngineConfig(), device="cuda",
                 tokenizer=None, mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = self.cfg = model.cfg
        self.ecfg = _clamp_to_model(cfg, engine_cfg)
        self.cdt = self.ecfg.compute_dtype
        self.model = model.to(device=self.device, dtype=self.cdt).eval()
        self.model.requires_grad_(False)
        self.mesh = mesh
        self._data_group = None if mesh is None else mesh.data_group
        if mesh is not None:
            shard_module_(self.model, mesh)
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
        self._batches = 0  # batches dispatched, for their root spans

    # ------------------------------------------------------------ the mesh

    def _rows(self, n: int) -> Optional[Rows]:
        """This data rank's rows of an ``n``-row request (None without a
        data axis)."""
        return None if self.mesh is None or self.mesh.data == 1 else self.mesh.rows(n)

    def _agree(self, *sizes: int) -> List[int]:
        """Host sizes as the data ranks agree them: their max."""
        if self._data_group is None:
            return list(sizes)
        return all_reduce_max_host(sizes, self._data_group)

    def _gather(self, wav: torch.Tensor, eff: np.ndarray, rows: Optional[Rows]):
        """(wav, eff) of every row of the request, in order, on every rank."""
        if rows is None or rows.stop - rows.start == rows.total:
            return wav, eff
        wide = wav.to(torch.int32) if wav.dtype == torch.int16 else wav  # NCCL has no int16
        wav = all_gather_rows(wide, self._data_group).to(wav.dtype)
        eff = all_gather_host(torch.as_tensor(eff), self._data_group).reshape(-1).numpy()
        return wav, eff

    # ------------------------------------------------------------- host prep

    def _encode(self, text: str) -> List[int]:
        """pinyin -> BPE ids, cut to the largest text bucket less one."""
        return self.tokenizer.encode(to_pinyin(text))[:self.ecfg.text_buckets[-1] - 1]

    def _prompt_frames(self, i: int, wav: np.ndarray) -> int:
        """The frames of prompt ``i``; a prompt shorter than one hop raises."""
        hop = self.cfg.data.hop_length
        n_true = wav.shape[-1] // hop
        if n_true < 1:
            raise ValueError(f"prompt wav {i} too short: {wav.shape[-1]} "
                             f"samples (< one hop of {hop})")
        return n_true

    def _split(self, texts: Sequence[str], prompt_wavs: Sequence[np.ndarray]):
        """(rows, this data rank's texts, its prompt wavs) of a request.
        On a sharded engine every rank checks every row first, so a request
        that host prep refuses raises on every rank, as on one card, and
        before any rank enters a collective."""
        if len(texts) != len(prompt_wavs):
            raise ValueError(f"{len(texts)} texts and {len(prompt_wavs)} prompt wavs")
        rows = self._rows(len(texts))
        if rows is not None:
            for i, (t, w) in enumerate(zip(texts, prompt_wavs)):
                self._encode(t)
                self._prompt_frames(i, np.asarray(w, np.float32))
        return rows, _take(texts, rows), _take(prompt_wavs, rows)

    def prepare_text(self, texts: Sequence[str]) -> Tuple[torch.Tensor, np.ndarray]:
        """pinyin -> BPE -> right-pad with stop (0) to a shared text bucket
        (agreed over the data group on a sharded engine)."""
        encoded = [self._encode(t) for t in texts]
        lengths = np.array([len(e) for e in encoded], np.int64)
        width, = self._agree(_bucket_up(int(lengths.max()) + 1, self.ecfg.text_buckets))
        out = np.zeros((len(texts), width), np.int64)
        for i, e in enumerate(encoded):
            out[i, :len(e)] = e
        with tracing.wait("text"):
            return torch.as_tensor(out, device=self.device), lengths

    def prepare_prompt(self, wavs: Sequence[np.ndarray]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """24 kHz waveforms -> fp32 prompt mels padded up to a bucket, and
        the true per-item frame counts.  Wavs are zero-padded to a 0.5 s grid
        before the STFT (one batched STFT per padded length); each item keeps
        its own frames, cropped to the largest bucket.  The bucket is agreed
        over the data group on a sharded engine."""
        chunk = self.cfg.data.sampling_rate // 2
        cap = self.ecfg.prompt_buckets[-1]
        padded = []
        for i, w in enumerate(wavs):
            w = np.asarray(w, np.float32)
            padded.append((np.pad(w, (0, (-len(w)) % chunk)),
                           min(self._prompt_frames(i, w), cap)))
        mels: List[Optional[torch.Tensor]] = [None] * len(wavs)
        for plen in sorted({p.shape[-1] for p, _ in padded}):
            idx = [i for i, (p, _) in enumerate(padded) if p.shape[-1] == plen]
            with tracing.wait("prompt"):
                stack = torch.as_tensor(np.stack([padded[i][0] for i in idx]),
                                        device=self.device)
            batch = self.frontend.mel_spectrogram(stack)
            for j, i in enumerate(idx):
                mels[i] = batch[j, :padded[i][1]]
        lengths = [m.shape[0] for m in mels]
        width, = self._agree(_bucket_up(max(lengths), self.ecfg.prompt_buckets))
        out = torch.zeros((len(wavs), width, mels[0].shape[1]),
                          dtype=torch.float32, device=self.device)
        for i, m in enumerate(mels):
            out[i, :m.shape[0]] = m
        with tracing.wait("prompt_lengths"):
            return out, torch.as_tensor(lengths, device=self.device)

    # ---------------------------------------------------------------- stages

    def diffusion_cond(self, refer_mel: torch.Tensor,
                       refer_len: Union[torch.Tensor, Sequence[int]]) -> torch.Tensor:
        """(B, 2 * mc) conditioning, each item at its own prompt bucket (the
        contextual embedder is unmasked, so the amount of trailing zero
        padding must not depend on the batch).  ``refer_len`` may be given
        on the host, which spares a synchronisation."""
        t_max = refer_mel.shape[1]
        lens = refer_len.tolist() if torch.is_tensor(refer_len) else list(refer_len)
        buckets = [min(_bucket_up(int(n), self.ecfg.prompt_buckets), t_max)
                   for n in lens]
        out: List[Optional[torch.Tensor]] = [None] * len(buckets)
        for lb in sorted(set(buckets)):
            idx = [i for i, b in enumerate(buckets) if b == lb]
            with tracing.wait("cond_rows"):  # the row indices go to the device
                group = refer_mel[idx, :lb]
            group = group.to(self.cdt)
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
    def _effective_lengths(n: int, lengths: Optional[torch.Tensor], max_len: int,
                           force_full: bool) -> np.ndarray:
        """Decoded lengths with the final token dropped (the reference's
        ``codes[:, :-1]``); under ``force_full`` every row is ``max_len - 1``
        and nothing waits for the device."""
        if force_full:
            return np.full((n,), max(max_len - 1, 1), np.int64)
        with tracing.wait("lengths"):
            lengths = lengths.cpu().numpy()
        return np.maximum(lengths - 1, 1).astype(np.int64)

    def _decode(self, refer_mel, refer_len, text, key: prng.Key, max_len: int,
                force_full: bool, rows: Optional[Rows] = None):
        """AR decode under ``key`` -> (codes (B, max_len), lengths (B,)) on
        the device; ``rows``: the batch is these rows of the request."""
        e = self.ecfg
        sampling = SamplingConfig(
            temperature=e.temperature, top_p=e.top_p,
            repetition_penalty=e.repetition_penalty,
            typical_mass=e.typical_mass, max_generate_length=max_len,
            force_full_length=force_full)
        return generate_speech_tokens(
            self.model.gpt, refer_mel.to(self.cdt), refer_len, text, sampling,
            key=key, cache_dtype=e.cache_dtype, rows=rows,
            group=self._data_group)

    def generate_codes(self, refer_mel, refer_len, text, key: prng.Key,
                       force_full: bool = False,
                       max_len: Optional[int] = None, rows: Optional[Rows] = None):
        """AR decode -> (codes (B, max_len), effective lengths (B,))."""
        max_len = max_len or self.ecfg.max_generate_length
        codes, lengths = self._decode(refer_mel, refer_len, text, key,
                                      max_len, force_full, rows)
        return codes, self._effective_lengths(codes.shape[0], lengths,
                                              max_len, force_full)

    def _pad_codes(self, codes: torch.Tensor, eff: np.ndarray, vq_safe: bool = False):
        """Crop codes to a bucket and stop-fill past each effective length;
        ``vq_safe`` maps ids at or above the VQ codebook size (the GPT's
        start and stop ids, and the fill) to 0.  The bucket is agreed over
        the data group on a sharded engine."""
        bucket, = self._agree(min(_bucket_up(int(eff.max()), self.ecfg.code_buckets),
                                  codes.shape[1]))
        with tracing.wait("code_lengths"):
            eff_t = torch.as_tensor(eff, device=codes.device)
        pos = torch.arange(bucket, device=codes.device)[None, :]
        codes_b = torch.where(pos < eff_t[:, None], codes[:, :bucket],
                              self.cfg.gpt.stop_mel_token)
        if vq_safe:
            codes_b = torch.where(codes_b < self.cfg.vaegan.vq_bins, codes_b, 0)
        return codes_b, eff_t * self.cfg.gpt.mel_length_compression, bucket

    def diffuse(self, latents: torch.Tensor, cond_latent: torch.Tensor,
                biases: List[torch.Tensor], key: prng.Key,
                rows: Optional[Rows] = None) -> torch.Tensor:
        """latents (B, Tc, D) -> denormalised mel (B, 4 Tc, n_mels), fp32,
        by the configured sampler; each model evaluation is one CFG call.
        ``key`` splits into the initial noise's and the ancestral steps'
        (JAX's ``n_rng, s_rng = split(d_rng)``).  ``rows``: the batch is
        these rows of the request, whose elements of each draw are drawn."""
        code_emb = self.model.diffusion_code_embedding(
            latents.to(self.cdt), cond_latent.to(self.cdt))

        def model_fn(x2, t2):
            return self.model.diffusion_cfg_step(x2.to(self.cdt), t2, code_emb,
                                                 biases)

        shape = (latents.shape[0], latents.shape[1] * FRAMES_PER_CODE,
                 self.cfg.diffusion.in_channels)
        n_key, s_key = prng.split(key)
        noise = prng.draw(n_key, shape, "normal", scale=self.ecfg.diffusion_temperature,
                          offset=prng.row_offset(rows, shape), device=self.device)
        k = self.cfg.diffusion.cond_free_k
        sampler = self.ecfg.diffusion_sampler
        if sampler == "ancestral":
            mel = p_sample_loop(self.schedule, model_fn, noise, cond_free_k=k,
                                key=s_key, rows=rows)
        elif sampler == "ddim":
            mel = ddim_sample_loop(self.schedule, model_fn, noise, cond_free_k=k)
        elif sampler == "dpmpp_2m":
            mel = dpmpp_2m_reference_sample_loop(
                model_fn, noise, steps=self.schedule.num_timesteps, guidance_scale=k)
        else:  # dpmpp_2m_karras (EngineConfig admits SAMPLERS only)
            mel = dpmpp_2m_sample_loop(self.schedule, model_fn, noise, cond_free_k=k)
        return denormalize_mel(mel)

    def _vocode(self, mel: torch.Tensor, eff: np.ndarray, key: prng.Key,
                rows: Optional[Rows] = None) -> torch.Tensor:
        """mel -> wav (B, T, 1), fp32 or (with ``pcm16_output``) int16; the
        prior sample under ``key``."""
        with tracing.wait("mel_lengths"):
            mel_len = torch.as_tensor(eff * FRAMES_PER_CODE, device=self.device)
        wav = self.model.infer_flowvae(mel.to(self.cdt), mel_len,
                                       self.ecfg.noise_scale, key=key, rows=rows)
        return to_pcm16(wav) if self.ecfg.pcm16_output else wav.float()

    def _codes_to_mel(self, codes: torch.Tensor, refer_mel: torch.Tensor,
                      refer_len: torch.Tensor) -> torch.Tensor:
        return self.model.decode_codes_to_mel(codes, refer_mel.to(self.cdt),
                                              refer_len).float()

    def _trim(self, wav: torch.Tensor, eff: np.ndarray) -> List[np.ndarray]:
        """Device wav (B, T, 1) -> one host array per item, ``eff`` codes long."""
        with tracing.wait("fetch"):
            wav = wav[..., 0].cpu().numpy()
        hop_per_code = self.cfg.gpt.mel_length_compression
        return [wav[i, :int(eff[i]) * hop_per_code] for i in range(len(eff))]

    # --------------------------------------------------------------- requests

    def _stage(self, name: str, batch: Optional[tracing.Span],
               timings: Optional[Dict[str, float]], wait=True):
        """Stage ``name`` of ``batch``: its span, timed on the device too
        (``tracing.stage``), and with ``timings`` its wall time, after
        waiting for the device as ``wait`` says."""
        return tracing.stage(name, timings, self.device, wait, parent=batch, events=True)

    @torch.inference_mode()
    def dispatch_decode(self, texts: Sequence[str],
                        prompt_wavs: Sequence[np.ndarray], seed: prng.Seed = 0,
                        force_full: bool = False,
                        timings: Optional[Dict[str, float]] = None) -> PendingDecode:
        """Phase 1: host prep, then the AR decode and the diffusion
        conditioning.  Nothing waits for the decode's lengths here (the
        decode loop itself synchronises on early stop unless ``force_full``);
        see :class:`PendingDecode`.  ``seed``: an int (``PRNGKey(seed)``) or
        a key.  On a sharded engine the batch is this data rank's rows of the
        request."""
        rows, texts, prompt_wavs = self._split(texts, prompt_wavs)
        g_key, d_key, v_key = prng.split(prng.as_key(seed), 3)
        batch = tracing.open_root("batch", batch=self._batches, profiled=tracing.profiling(),
                                  synced=timings is not None)
        self._batches += 1
        with self._stage("prepare", batch, timings):
            text, _ = self.prepare_text(texts)
            refer_mel, refer_len = self.prepare_prompt(prompt_wavs)
            with tracing.wait("refer_len"):
                prompt_lengths = refer_len.tolist()
        max_len = self.ecfg.max_generate_length
        # the decode is enqueued first; the conditioning's host work follows
        with self._stage("generate", batch, timings, wait=False):
            codes, lengths = self._decode(refer_mel, refer_len, text, g_key,
                                          max_len, force_full, rows)
            done = torch.cuda.Event() if self.device.type == "cuda" else None
            if done is not None:
                done.record()
        with self._stage("diff_cond", batch, timings, wait=False):
            diff_cond = self.diffusion_cond(refer_mel, prompt_lengths)
        return PendingDecode(codes=codes, lengths=None if force_full else lengths,
                             codes_done=done, diff_cond=diff_cond,
                             refer_mel=refer_mel, refer_len=refer_len, text=text,
                             d_key=d_key, v_key=v_key, n=len(texts), max_len=max_len,
                             force_full=force_full, timings=timings, rows=rows,
                             trace=batch)

    @torch.inference_mode()
    def dispatch_tail(self, pending: PendingDecode) -> InflightBatch:
        """Phase 2: the decode-length synchronisation (none under
        ``force_full``), bucket and stop-fill, then latents, diffusion and
        the vocoder, enqueued."""
        timings, batch = pending.timings, pending.trace
        with self._stage("generate", batch, timings, wait=pending.codes_done or True):
            eff = self._effective_lengths(pending.codes.shape[0], pending.lengths,
                                          pending.max_len, pending.force_full)
        with self._stage("diff_cond", batch, timings):
            pass  # waits for the conditioning, enqueued after the decode
        with self._stage("latents", batch, timings):
            codes_b, wav_len, bucket = self._pad_codes(pending.codes, eff)
            latents = self.model.gpt(pending.refer_mel.to(self.cdt), pending.refer_len,
                                     pending.text, codes_b, wav_len)
        with self._stage("diffuse", batch, timings):
            mel = self.diffuse(latents, pending.diff_cond,
                               self.attention_biases(bucket * FRAMES_PER_CODE),
                               pending.d_key, pending.rows)
        with self._stage("vocode", batch, timings):
            wav = self._vocode(mel, eff, pending.v_key, pending.rows)
        return InflightBatch(wav=wav, eff=eff, n=pending.n, rows=pending.rows, trace=batch)

    def dispatch_batch(self, texts: Sequence[str],
                       prompt_wavs: Sequence[np.ndarray], seed: prng.Seed = 0,
                       force_full: bool = False,
                       timings: Optional[Dict[str, float]] = None) -> InflightBatch:
        """Enqueue all device work of one batch; no output fetch.  Pass the
        handle to :meth:`finalize_batch`.  The only host wait is the
        decode-length one (none under ``force_full``)."""
        return self.dispatch_tail(self.dispatch_decode(
            texts, prompt_wavs, seed=seed, force_full=force_full, timings=timings))

    @torch.inference_mode()
    def finalize_batch(self, inflight: InflightBatch) -> List[np.ndarray]:
        """Fetch and trim a dispatched batch (waits for the device); on a
        sharded engine every row of the request, gathered first.  Ends the
        batch's root span."""
        with self._stage("host", inflight.trace, None):
            outs = self._trim(*self._gather(inflight.wav, inflight.eff, inflight.rows))
        tracing.close(inflight.trace)
        return outs

    def synthesize_batch(self, texts: Sequence[str],
                         prompt_wavs: Sequence[np.ndarray], seed: prng.Seed = 0,
                         force_full: bool = False,
                         timings: Optional[Dict[str, float]] = None
                         ) -> List[np.ndarray]:
        """Full pipeline (reference ``infer``, model_24k.py:774-810).

        ``timings``: optional dict; when given, each stage ends in a device
        synchronisation and its wall time is added under its name.  Each
        stage is also a ``torch.profiler`` range of that name.
        """
        return self.finalize_batch(self.dispatch_batch(
            texts, prompt_wavs, seed=seed, force_full=force_full, timings=timings))

    def synthesize(self, text: str, prompt_wav: np.ndarray,
                   seed: prng.Seed = 0) -> np.ndarray:
        """Single-utterance convenience (the api.py surface)."""
        return self.synthesize_batch([text], [prompt_wav], seed)[0]

    @torch.inference_mode()
    def synthesize_from_ids(self, text_ids: torch.Tensor, refer_mel: torch.Tensor,
                            refer_len: torch.Tensor, seed: prng.Seed = 0,
                            vq_only: bool = False) -> List[np.ndarray]:
        """Low-level entry on token ids and a prompt mel (the reference's
        eval-time ``infer_gpt`` / ``infer`` calls, train.py:234-236)."""
        n = {text_ids.shape[0], refer_mel.shape[0], refer_len.shape[0]}
        if len(n) != 1:  # checked on every rank before it takes its rows
            raise ValueError(f"text_ids, refer_mel and refer_len of {sorted(n)} rows")
        g_key, d_key, v_key = prng.split(prng.as_key(seed), 3)
        rows = self._rows(text_ids.shape[0])
        text_ids, refer_mel, refer_len = (_take(x, rows) for x in (text_ids, refer_mel,
                                                                   refer_len))
        codes, eff = self.generate_codes(refer_mel, refer_len, text_ids, g_key, rows=rows)
        codes_b, wav_len, bucket = self._pad_codes(codes, eff, vq_safe=vq_only)
        if vq_only:
            mel = self._codes_to_mel(codes_b, refer_mel, refer_len)
        else:
            latents = self.model.gpt(refer_mel.to(self.cdt), refer_len, text_ids,
                                     codes_b, wav_len)
            mel = self.diffuse(latents, self.diffusion_cond(refer_mel, refer_len),
                               self.attention_biases(bucket * FRAMES_PER_CODE), d_key, rows)
        return self._trim(*self._gather(self._vocode(mel, eff, v_key, rows), eff, rows))

    @torch.inference_mode()
    def synthesize_vq_batch(self, texts: Sequence[str],
                            prompt_wavs: Sequence[np.ndarray], seed: prng.Seed = 0,
                            force_full: bool = False) -> List[np.ndarray]:
        """Diffusion-free path (reference ``infer_gpt``, model_24k.py:811-846):
        codes -> ``vq_dec`` mel -> vocoder."""
        rows, texts, prompt_wavs = self._split(texts, prompt_wavs)
        g_key, v_key = prng.split(prng.as_key(seed))
        text, _ = self.prepare_text(texts)
        refer_mel, refer_len = self.prepare_prompt(prompt_wavs)
        codes, eff = self.generate_codes(refer_mel, refer_len, text, g_key,
                                         force_full=force_full, rows=rows)
        # vq_safe: the GPT's start/stop ids lie past the VQ codebook and never
        # index it in the reference's exact-length batch-1 path
        codes_b, _, _ = self._pad_codes(codes, eff, vq_safe=True)
        mel = self._codes_to_mel(codes_b, refer_mel, refer_len)
        return self._trim(*self._gather(self._vocode(mel, eff, v_key, rows), eff, rows))

    @torch.inference_mode()
    def vq_roundtrip(self, mel, seed: prng.Seed = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """mel (B, T, n_mels) -> codes -> mel -> wav (reference
        ``infer_vqvae``): (reconstructed mel fp32, wav (B, T * hop, 1) fp32);
        the vocoder's prior sample under the key itself, as JAX's."""
        mel = torch.as_tensor(mel, device=self.device).to(self.cdt)
        recon, wav = self.model.infer_vqvae(mel, key=prng.as_key(seed))
        return recon.float(), wav.float()

    @torch.inference_mode()
    def warmup(self, batch_size: int = 1, text_bucket: Optional[int] = None,
               prompt_bucket: Optional[int] = None,
               code_bucket: Optional[int] = None,
               force_full: bool = False) -> None:
        """Run one request at the given buckets (default: the smallest), so
        that the first served request does not pay for the kernel library's
        build, the T5 biases or the allocator's first growth."""
        tb = text_bucket or self.ecfg.text_buckets[0]
        pb = prompt_bucket or self.ecfg.prompt_buckets[0]
        cb = code_bucket or self.ecfg.code_buckets[0]
        key = prng.PRNGKey(0)  # every stage under the one key, as JAX's warmup
        text = torch.zeros((batch_size, tb), dtype=torch.long, device=self.device)
        refer = torch.full((batch_size, pb, self.cfg.data.n_mel_channels), -6.0,
                           device=self.device)
        refer_len = torch.full((batch_size,), pb, dtype=torch.long, device=self.device)
        codes, _ = self._decode(refer, refer_len, text, key,
                                self.ecfg.max_generate_length, force_full)
        eff = np.full((batch_size,), min(cb, int(codes.shape[1])), np.int64)
        codes_b, wav_len, _ = self._pad_codes(codes, eff)
        latents = self.model.gpt(refer.to(self.cdt), refer_len, text, codes_b, wav_len)
        mel = self.diffuse(latents, self.diffusion_cond(refer, [pb] * batch_size),
                           self.attention_biases(codes_b.shape[1] * FRAMES_PER_CODE), key)
        self._trim(self._vocode(mel, eff, key), eff)


def random_engine(cfg: Optional[Config] = None, seed: int = 0,
                  engine_cfg: EngineConfig = EngineConfig(),
                  device="cuda", mesh: Optional[Mesh] = None) -> TTSEngine:
    """Engine with seeded random weights made on ``device`` (tests, smoke);
    ``mesh`` as in :class:`TTSEngine`."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = SynthesizerTrn(cfg or Config())
    random_weights_(model, seed)
    return TTSEngine(model, engine_cfg, device=dev, mesh=mesh)
