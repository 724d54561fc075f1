"""STFT / log-mel frontend, always fp32 (counterpart of ``audio/mel.py``).

Reflect pre-pad of ``(n_fft - hop) // 2`` samples, Hann-windowed frames
(``center=False``), ``rfft``, magnitude ``sqrt(re^2 + im^2 + 1e-6)``, a
librosa-free Slaney mel filterbank, ``log(clamp(x, 1e-5))``.  Outputs are
time-major (..., frames, channels) like the JAX package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

FRAMES_PER_CODE = 4  # one VQ code per 4 mel frames
MEL_MIN = -11.512925465
MEL_MAX = 2.7

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freqs: np.ndarray) -> np.ndarray:
    freqs = np.asarray(freqs, dtype=np.float64)
    mels = freqs / _F_SP
    log_region = freqs >= _MIN_LOG_HZ
    return np.where(log_region, _MIN_LOG_MEL + np.log(
        np.maximum(freqs, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP, mels)


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    freqs = mels * _F_SP
    log_region = mels >= _MIN_LOG_MEL
    return np.where(log_region, _MIN_LOG_HZ * np.exp(
        _LOGSTEP * (mels - _MIN_LOG_MEL)), freqs)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank, (n_mels, n_fft//2+1)."""
    if fmax is None:
        fmax = sr / 2.0
    fft_freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    hz_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def num_frames(num_samples: int, n_fft: int = 1024, hop: int = 256) -> int:
    pad = (n_fft - hop) // 2
    return 1 + (num_samples + 2 * pad - n_fft) // hop


class MelFrontend:
    """Filterbank and window on one device; fp32 spectrogram/log-mel."""

    def __init__(self, sr: int = 24000, n_fft: int = 1024, hop: int = 256,
                 win: int = 1024, n_mels: int = 128, fmin: float = 0.0,
                 fmax: Optional[float] = None, device="cpu"):
        self.sr, self.n_fft, self.hop, self.win, self.n_mels = sr, n_fft, hop, win, n_mels
        self.mel_basis = torch.as_tensor(
            mel_filterbank(sr, n_fft, n_mels, fmin, fmax), device=device)
        window = torch.hann_window(win, periodic=True, dtype=torch.float32,
                                   device=device)
        if win < n_fft:  # torch zero-pads the window to n_fft, centred
            lp = (n_fft - win) // 2
            window = F.pad(window, (lp, n_fft - win - lp))
        self.window = window

    def linear_spectrogram(self, y: torch.Tensor) -> torch.Tensor:
        """(..., samples) -> (..., frames, n_fft//2+1) magnitudes."""
        pad = (self.n_fft - self.hop) // 2
        lead = y.shape[:-1]
        y = F.pad(y.float().reshape(-1, 1, y.shape[-1]), (pad, pad),
                  mode="reflect")[:, 0]
        frames = y.unfold(-1, self.n_fft, self.hop) * self.window
        spec = torch.fft.rfft(frames, n=self.n_fft, dim=-1)
        mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-6)
        return mag.reshape(*lead, *mag.shape[-2:])

    def spec_to_mel(self, spec: torch.Tensor) -> torch.Tensor:
        return torch.log(torch.clamp(spec @ self.mel_basis.T, min=1e-5))

    def mel_spectrogram(self, y: torch.Tensor) -> torch.Tensor:
        """(..., samples) -> (..., frames, n_mels) log-mel."""
        return self.spec_to_mel(self.linear_spectrogram(y))


def normalize_mel(mel: torch.Tensor) -> torch.Tensor:
    return 2.0 * ((mel - MEL_MIN) / (MEL_MAX - MEL_MIN)) - 1.0


def denormalize_mel(norm_mel: torch.Tensor) -> torch.Tensor:
    return ((norm_mel + 1.0) / 2.0) * (MEL_MAX - MEL_MIN) + MEL_MIN
