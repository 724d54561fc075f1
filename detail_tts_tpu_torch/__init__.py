"""detail_tts_tpu_torch: the PyTorch/CUDA port of ``detail_tts_tpu``.

Zero-shot synthesis (text + prompt wav -> 24 kHz wav) and the staged
training of every model (VQ-VAE, GPT, diffusion, and the flow-VAE/HiFi-GAN
GAN stage) on one NVIDIA GPU, or data parallel on several, from a corpus
on disk (data prep, loader, checkpoints, the training CLI), with the
diffusion attention in
hand-written CUDA kernels.  Module paths
mirror the JAX package; parameter names are the reference's torch
``state_dict`` names.  Imports torch, numpy and the standard library only.
"""
from detail_tts_tpu_torch.config import Config  # noqa: F401

__version__ = "0.1.0"
