"""The benchmark's plain reference: a frozen copy of the PyTorch port's plain
model code (``config``, the layers, the GPT, the diffusion net and sampler,
the flow-VAE and HiFi-GAN vocoder, the mel frontend, JAX's threefry draws,
the pinyin table and BPE tokenizer, AdamW with the global-norm clip).

Every CUDA kernel is replaced by its plain PyTorch version (``attention``),
every collective by the identity of one rank (``mesh``), it never runs
under autocast (so its autocast guards are gone), and the decode loop
is left out: the reference reads served tokens teacher-forced.  It imports
torch, numpy and the standard library only, never the program it judges, so
that a change to the program cannot move the yardstick.  ``serve`` and
``train`` run the serving and training cells' plain computations.
"""
