"""Gaussian diffusion schedule and the ancestral sampler (utils/diffusion.py).

Counterpart of ``detail_tts_tpu/models/diffusion.py`` (schedule and
``p_sample_loop``): linear betas over 4000 training steps, spaced to the
inference count, epsilon prediction with a learned-range variance, ancestral
sampling with a ramped classifier-free guidance weight ``k * (1 - i / n)``
and the x0 clamp to [-1, 1].  The schedule is built in fp64 numpy and kept
as fp32 tensors; all sampler math is fp32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Set, Tuple

import numpy as np
import torch


def get_named_beta_schedule(name: str, num_steps: int) -> np.ndarray:
    """(diffusion.py:84-107)."""
    if name == "linear":
        scale = 1000 / num_steps
        return np.linspace(scale * 0.0001, scale * 0.02, num_steps,
                           dtype=np.float64)
    if name == "cosine":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        return np.array([min(1 - alpha_bar((i + 1) / num_steps)
                             / alpha_bar(i / num_steps), 0.999)
                         for i in range(num_steps)], dtype=np.float64)
    raise NotImplementedError(name)


def space_timesteps(num_timesteps: int, section_counts: Sequence[int]) -> Set[int]:
    """(diffusion.py:1223-1261)."""
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide {size} steps into {section_count}")
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        start_idx += size
    return set(all_steps)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """(Spaced) schedule constants as fp32 tensors on one device."""

    betas: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    log_betas: torch.Tensor
    timestep_map: torch.Tensor  # spaced index -> original timestep
    num_timesteps: int

    @staticmethod
    def create(betas: np.ndarray, use_timesteps: Optional[Set[int]] = None,
               device="cpu") -> "DiffusionSchedule":
        betas = np.asarray(betas, dtype=np.float64)
        if use_timesteps is not None:
            # SpacedDiffusion re-derivation (diffusion.py:1180-1196)
            last, new_betas, tmap = 1.0, [], []
            for i, ac in enumerate(np.cumprod(1.0 - betas)):
                if i in use_timesteps:
                    new_betas.append(1 - ac / last)
                    last = ac
                    tmap.append(i)
            betas = np.array(new_betas, dtype=np.float64)
            timestep_map = np.array(tmap, dtype=np.int64)
        else:
            timestep_map = np.arange(len(betas), dtype=np.int64)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return DiffusionSchedule(
            betas=f32(betas),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1)),
            posterior_log_variance_clipped=f32(np.log(np.append(post_var[1], post_var[1:]))),
            posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
            log_betas=f32(np.log(betas)),
            timestep_map=torch.as_tensor(timestep_map, device=device),
            num_timesteps=len(betas))

    def p_mean_variance(self, eps: torch.Tensor, var_logits: torch.Tensor,
                        x: torch.Tensor, i: int):
        """Posterior mean and log-variance at spaced step ``i`` from the model's
        epsilon and learned-range variance logits (fp32)."""
        min_log = self.posterior_log_variance_clipped[i]
        frac = (var_logits + 1) / 2
        logvar = frac * self.log_betas[i] + (1 - frac) * min_log
        pred_x0 = (self.sqrt_recip_alphas_cumprod[i] * x
                   - self.sqrt_recipm1_alphas_cumprod[i] * eps).clamp(-1, 1)
        mean = self.posterior_mean_coef1[i] * pred_x0 + self.posterior_mean_coef2[i] * x
        return mean, logvar


# model_fn(x (2B, ...), t_original (2B,)) -> (eps, var_logits), rows [cond | uncond]
ModelFn = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


@torch.no_grad()
def p_sample_loop(schedule: DiffusionSchedule, model_fn: ModelFn,
                  noise: torch.Tensor, *, cond_free_k: float = 2.0,
                  generator: Optional[torch.Generator] = None,
                  noise_seq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ancestral sampler with ramped CFG (diffusion.py:445-485).

    Each step is one model call on 2B rows [cond | uncond].  ``noise_seq``:
    optional (num_timesteps, *x.shape) injection noises in the order they are
    used (first entry -> highest timestep); else drawn from ``generator``.
    """
    n = schedule.num_timesteps
    x = noise.float()
    for step, i in enumerate(range(n - 1, -1, -1)):
        t_orig = schedule.timestep_map[i].expand(2 * x.shape[0])
        eps2, var2 = model_fn(torch.cat([x, x], dim=0), t_orig)
        eps_c, eps_u = eps2.float().chunk(2, dim=0)
        var_logits = var2.float().chunk(2, dim=0)[0]
        cfk = cond_free_k * (1.0 - i / n)
        eps = (1 + cfk) * eps_c - cfk * eps_u
        mean, logvar = schedule.p_mean_variance(eps, var_logits, x, i)
        if i == 0:
            x = mean
            continue
        z = (noise_seq[step].to(x) if noise_seq is not None else
             torch.randn(x.shape, generator=generator, device=x.device))
        x = mean + torch.exp(0.5 * logvar) * z
    return x
