"""Typed configuration (the port's own copy of ``detail_tts_tpu/config.py``).

The same dataclasses and defaults as the JAX package, so one config drives
both.  JSON-compatible with the reference config (``vqvae/configs/config_24k.json``):
``Config.from_json`` accepts the exact same file and maps every field onto
typed dataclasses (the reference used an untyped recursive attr-dict,
``HParams`` at vqvae/utils/data_utils.py:157).  Unknown keys are ignored so
legacy configs load unchanged.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence


def _filter_kwargs(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclass(frozen=True)
class TrainConfig:
    """Mirrors the reference ``train`` section (config_24k.json:2-35)."""

    target: str = "gpt"  # one of: vqvae | gpt | diff | flowvae | all
    val_freq: int = 100
    save_freq: int = 1000
    seed: int = 1234
    train_steps: int = 10_000_000
    logs_folder: str = "logs"
    learning_rate: float = 1e-4
    betas: Sequence[float] = (0.8, 0.99)
    eps: float = 1e-9
    batch_size: int = 8
    gradient_accumulate_every: int = 16
    lr_decay: float = 0.999875
    lr_decay_every: int = 50_000
    segment_size: int = 10240  # waveform samples per GAN slice
    c_mel: float = 45.0
    c_kl: float = 1.0
    max_speclen: int = 512
    num_workers: int = 16
    keep_ckpts: int = 3
    text_weight: float = 0.01
    mel_weight: float = 1.0
    # TPU-specific additions (not in the reference):
    # Explicit autocast-equivalent policy (the reference trains under
    # accelerator.autocast() + TF32, train.py:37-38): matmul OPERANDS cast
    # to bf16, everything else fp32 (nn/common.py matmul_dtype).  On TPU
    # this is measured perf-NEUTRAL — XLA already runs fp32 dots at bf16
    # MXU rate by default — but it pins the numerics policy explicitly
    # (robust to precision=highest defaults, portable off-TPU).
    use_bf16: bool = True
    remat_gpt: bool = True  # jax.checkpoint on GPT blocks (ref: grad ckpt, gpt/model.py:229)
    # Torch-parity weight-norm (g, v) reparameterization on the convs the
    # reference wraps (WN / HiFi-GAN ups / resblocks / MPD) — the gradient
    # geometry matters for GAN stability.  Serving always uses folded
    # kernels (nn/common.py weight_norm_reparam).
    weight_norm: bool = True
    # PRNG impl for the per-step training key (dropout masks, diffusion
    # timestep/noise draws, VQ expiry samples).  'rbg' lowers to the TPU
    # hardware RngBitGenerator; jax's portable default threefry2x32 is
    # otherwise fused mask arithmetic on the VPU inside the attention
    # einsums — measured 46% of the whole gpt train step (238ms -> 128ms
    # device, 4.1 -> 7.0 steps/s; kernel census in CLAUDE.md).  Draw
    # QUALITY is fine for training noise; rbg streams are not bit-stable
    # across XLA versions/backends, so set 'threefry2x32' if bit-exact
    # reproducible resumes matter more than 1.7x step throughput.
    # Param INIT always uses threefry (trainer.py) so init is impl-stable.
    rng_impl: str = "rbg"


@dataclass(frozen=True)
class DataConfig:
    """Mirrors the reference ``data`` section (config_24k.json:36-47)."""

    training_files_gpt: str = "datasets/data.jsonl"
    max_wav_value: float = 32768.0
    sampling_rate: int = 24000
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mel_channels: int = 128
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = None
    tokenizer_vocab: str = "bpe_tokenizers/zh_tokenizer.json"

    @property
    def spec_channels(self) -> int:
        return self.filter_length // 2 + 1  # 513


@dataclass(frozen=True)
class DiffusionConfig:
    """Mirrors the reference ``diffusion`` section (config_24k.json:48-61)."""

    model_channels: int = 768
    num_layers: int = 10
    in_channels: int = 128
    out_channels: int = 256  # epsilon mean + learned-range variance
    in_latent_channels: int = 768
    in_tokens: int = 8193
    dropout: float = 0.0
    num_heads: int = 16
    layer_drop: float = 0.2
    unconditioned_percentage: float = 0.15
    # Schedule (SynthesizerTrn hard-codes these, vqvae/model_24k.py:558-583)
    trained_steps: int = 4000
    train_sample_steps: int = 200
    infer_steps: int = 50
    cond_free_k: float = 2.0


@dataclass(frozen=True)
class GPTConfig:
    """Mirrors the reference ``gpt`` section (config_24k.json:62-77)."""

    model_dim: int = 768
    max_mel_tokens: int = 1600
    max_text_tokens: int = 800
    heads: int = 16
    layers: int = 10
    mel_length_compression: int = 1024  # wav samples per mel code
    number_text_tokens: int = 256
    number_mel_codes: int = 8194
    start_mel_token: int = 8192
    stop_mel_token: int = 8193
    start_text_token: int = 255
    stop_text_token: int = 0
    spec_channels: int = 128
    max_conditioning_inputs: int = 1
    # HF GPT2Config defaults the reference inherits (gpt/model.py:223-230)
    dropout: float = 0.1
    layer_norm_eps: float = 1e-5

    @property
    def max_seq_len(self) -> int:
        # n_positions = max_mel + max_text + 2 (gpt/model.py:333)
        return self.max_mel_tokens + self.max_text_tokens + 2


@dataclass(frozen=True)
class VAEGANConfig:
    """Mirrors the reference ``vaegan`` section (config_24k.json:78-139)."""

    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 512
    vq_bins: int = 8192
    n_heads: int = 4
    n_layers: int = 3
    kernel_size: int = 3
    p_dropout: float = 0.1
    resblock: str = "1"
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: Sequence[int] = (8, 4, 2, 2, 2)
    upsample_initial_channel: int = 400
    upsample_kernel_sizes: Sequence[int] = (16, 8, 2, 2, 2)
    n_flow_layer: int = 4
    gin_channels: int = 768
    # VQ details (ResidualVectorQuantizer, vqvae/model_24k.py:600; quantize.py:60-69)
    vq_codebook_dim: int = 8
    vq_n_q: int = 1
    vq_decay: float = 0.99
    vq_kmeans_iters: int = 50
    vq_threshold_ema_dead_code: float = 2.0


@dataclass(frozen=True)
class MeshConfig:
    """TPU mesh layout (no reference equivalent; replaces Accelerate DDP)."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1  # -1: all devices on the data axis
    model_parallel: int = 1


@dataclass(frozen=True)
class Config:
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    gpt: GPTConfig = field(default_factory=GPTConfig)
    vaegan: VAEGANConfig = field(default_factory=VAEGANConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    @staticmethod
    def from_dict(d: dict) -> "Config":
        return Config(
            train=TrainConfig(**_filter_kwargs(TrainConfig, d.get("train", {}))),
            data=DataConfig(**_filter_kwargs(DataConfig, d.get("data", {}))),
            diffusion=DiffusionConfig(**_filter_kwargs(DiffusionConfig, d.get("diffusion", {}))),
            gpt=GPTConfig(**_filter_kwargs(GPTConfig, d.get("gpt", {}))),
            vaegan=VAEGANConfig(**_filter_kwargs(VAEGANConfig, d.get("vaegan", {}))),
            mesh=MeshConfig(**_filter_kwargs(MeshConfig, d.get("mesh", {}))),
        )

    @staticmethod
    def from_json(path: str) -> "Config":
        with open(path, "r") as f:
            return Config.from_dict(json.load(f))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def replace(self, **sections: Any) -> "Config":
        return dataclasses.replace(self, **sections)


def small_test_config() -> Config:
    """A tiny config for fast unit tests (same topology, small dims)."""
    return Config(
        train=TrainConfig(batch_size=2, gradient_accumulate_every=1, segment_size=2560),
        data=DataConfig(),
        diffusion=DiffusionConfig(
            model_channels=64, num_layers=2, in_latent_channels=64, num_heads=4,
            out_channels=256, trained_steps=100, train_sample_steps=20, infer_steps=5,
        ),
        gpt=GPTConfig(model_dim=64, heads=4, layers=2, max_mel_tokens=80, max_text_tokens=40),
        vaegan=VAEGANConfig(
            inter_channels=32, hidden_channels=32, filter_channels=64,
            vq_bins=64, gin_channels=48, upsample_initial_channel=64,
            n_heads=2, n_layers=2,
        ),
    )
