"""The benchmark's one traffic generator, driven by a traffic file's
parameters and the run's seed.

Serving (``kind`` ``serve_offline``): batch i of a run is ``batch`` requests.
Each batch holds the same multiset of sizes, spread evenly over the file's
ranges (``text_chars`` characters of text, ``prompt_seconds`` of prompt),
in an order drawn from the seed, so that every seed and every batch asks
for the same work.  A text is drawn from the characters that the pinyin
table covers; a prompt is a 24 kHz waveform of a few drawn partials under a
drawn envelope, with noise.  Batch i's key is JAX's ``fold_in`` of
``PRNGKey(seed)`` and i; every batch samples as the configuration states.

Training (``kind`` ``train``): step i's batch of ``accum`` micro-batches of
``micro_batch`` clips, made on the device from one generator seeded from
the seed: ``frames`` mel frames ~ N(-6, 2) (mel and raw_mel alike) and
``text_tokens`` text ids in [1, 256), every clip at full length.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from port_bench.reference import prng

_PINYIN = Path(__file__).resolve().parent / "reference" / "pinyin_data.json"
SAMPLE_RATE = 24000


def covered_chars() -> List[str]:
    """The hanzi that the pinyin table reads, in code-point order."""
    with open(_PINYIN, encoding="utf-8") as f:
        return sorted(json.load(f)["chars"])


def _spread(lo: float, hi: float, n: int) -> np.ndarray:
    return np.linspace(lo, hi, n) if n > 1 else np.array([hi])


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, *stream])


class ServeTraffic:
    """Batches of (texts, prompt wavs) and their keys for a serving cell."""

    def __init__(self, params: Dict, seed: int):
        self.p, self.seed = params, int(seed)
        self.chars = covered_chars()
        n = params["batch"]
        self.text_lens = np.rint(_spread(*params["text_chars"], n)).astype(int)
        self.prompt_samples = np.rint(_spread(*params["prompt_seconds"], n)
                                      * SAMPLE_RATE).astype(int)

    def key(self, i: int) -> Tuple[int, int]:
        return prng.fold_in(prng.PRNGKey(self.seed), i)

    def batch(self, i: int) -> Tuple[List[str], List[np.ndarray]]:
        """Batch ``i`` (``i`` < 0: the warm-up's) of texts and prompts."""
        rng = _rng(self.seed, 1, i + 2 ** 20)
        order_t = rng.permutation(len(self.text_lens))
        order_p = rng.permutation(len(self.prompt_samples))
        texts = ["".join(rng.choice(self.chars, int(self.text_lens[j]))) for j in order_t]
        wavs = [self._prompt(rng, int(self.prompt_samples[j])) for j in order_p]
        return texts, wavs

    @staticmethod
    def _prompt(rng: np.random.Generator, n: int) -> np.ndarray:
        t = np.arange(n, dtype=np.float64) / SAMPLE_RATE
        f0 = rng.uniform(90.0, 260.0)
        wav = np.zeros(n)
        for k in range(1, 9):
            wav += rng.uniform(0.2, 1.0) / k * np.sin(2 * math.pi * f0 * k * t
                                                        + rng.uniform(0, 2 * math.pi))
        env = 0.5 + 0.5 * np.sin(2 * math.pi * rng.uniform(2.0, 5.0) * t) ** 2
        wav = 0.15 * wav * env + 0.01 * rng.standard_normal(n)
        return np.clip(wav, -1.0, 1.0).astype(np.float32)

    def audio_seconds(self, codes: int, samples_per_code: int) -> float:
        """Seconds of audio a batch delivers, each item ``codes`` long."""
        return self.p["batch"] * codes * samples_per_code / SAMPLE_RATE


class TrainTraffic:
    """Endless training batches in the step's layout (accum, micro, ...)."""

    def __init__(self, params: Dict, seed: int, hop: int, n_mels: int, device):
        self.p, self.hop, self.n_mels = params, hop, n_mels
        self.device = torch.device(device)
        self.seed = int(seed)

    def batches(self):
        """A fresh iterator of batches from the seed's first."""
        p, dev = self.p, self.device
        gen = torch.Generator(device=dev).manual_seed(self.seed ^ 0x5EED_DA7A)
        a, b, t, n = p["accum"], p["micro_batch"], p["frames"], p["text_tokens"]
        while True:
            mel = torch.randn((a, b, t, self.n_mels), generator=gen, device=dev) * 2.0 - 6.0
            text = torch.randint(1, 256, (a, b, n), generator=gen, device=dev)

            def full(v):
                return torch.full((a, b), v, dtype=torch.long, device=dev)

            yield {"mel": mel, "raw_mel": mel, "spec_length": full(t),
                   "raw_spec_length": full(t), "wav_length": full(t * self.hop),
                   "raw_wav_length": full(t * self.hop), "text": text,
                   "text_length": full(n)}

    def draw_seed(self) -> int:
        """The seed of the step's own generator (timesteps, noise, the
        unconditioned rows and the layer-drop flags)."""
        return (self.seed * 0x9E3779B1 + 0x7F4A7C15) % (2 ** 63)
