"""Gaussian diffusion schedule, training loss and the samplers
(utils/diffusion.py, utils/dpm_solver.py).

Counterpart of ``detail_tts_tpu/models/diffusion.py`` (schedule,
``q_sample``/``q_posterior``, ``training_losses`` and the four samplers):
linear betas over 4000 training steps, spaced to the training or inference
count, epsilon prediction with a learned-range variance, the MSE + VB loss
with the VB term's mean frozen.  Samplers: ancestral and DDIM with a ramped
classifier-free guidance weight ``k * (1 - i / n)`` and the x0 clamp to
[-1, 1]; the reference's DPM-Solver++(2M) on its continuous VP schedule with
constant guidance; and a DPM-Solver++(2M) variant on karras-style sigmas of
the spaced schedule.  Every model evaluation is one call on 2B rows [cond |
uncond].  The schedule is built in fp64 numpy and kept as fp32 tensors; all
loss and sampler math is fp32, and per-step scalars that need no tensor are
worked out on the host, so a sampler never waits on the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from port_bench.reference import prng
from port_bench.reference.mesh import Rows


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
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
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
            alphas_cumprod=f32(acp),
            alphas_cumprod_prev=f32(acp_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(acp)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1 - acp)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1)),
            posterior_log_variance_clipped=f32(np.log(np.append(post_var[1], post_var[1:]))),
            posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
            log_betas=f32(np.log(betas)),
            timestep_map=torch.as_tensor(timestep_map, device=device),
            num_timesteps=len(betas))

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """x_t at spaced steps t (B,) from x_start and standard-normal noise."""
        nd = x_start.dim()
        return (_extract(self.sqrt_alphas_cumprod, t, nd) * x_start
                + _extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * noise)

    def q_posterior(self, x_start: torch.Tensor, x_t: torch.Tensor, t):
        """Mean and clipped log-variance of q(x_{t-1} | x_t, x_0)."""
        nd = x_t.dim()
        mean = (_extract(self.posterior_mean_coef1, t, nd) * x_start
                + _extract(self.posterior_mean_coef2, t, nd) * x_t)
        return mean, _extract(self.posterior_log_variance_clipped, t, nd)

    def predict_xstart_from_eps(self, x_t: torch.Tensor, t,
                                eps: torch.Tensor) -> torch.Tensor:
        nd = x_t.dim()
        return (_extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t
                - _extract(self.sqrt_recipm1_alphas_cumprod, t, nd) * eps)

    def learned_range_logvar(self, var_logits: torch.Tensor, t) -> torch.Tensor:
        nd = var_logits.dim()
        min_log = _extract(self.posterior_log_variance_clipped, t, nd)
        frac = (var_logits + 1) / 2
        return frac * _extract(self.log_betas, t, nd) + (1 - frac) * min_log

    def p_mean_variance(self, eps: torch.Tensor, var_logits: torch.Tensor,
                        x: torch.Tensor, i):
        """Posterior mean and log-variance at spaced step ``i`` (an int, or
        (B,) steps) from the model's epsilon and learned-range variance
        logits (fp32)."""
        logvar = self.learned_range_logvar(var_logits, i)
        pred_x0 = self.predict_xstart_from_eps(x, i, eps).clamp(-1, 1)
        mean, _ = self.q_posterior(pred_x0, x, i)
        return mean, logvar


def _extract(arr: torch.Tensor, t, ndim: int) -> torch.Tensor:
    """Per-step coefficients: a scalar for an int step, (B, 1, ...) for (B,)."""
    out = arr[t]
    return out.reshape(out.shape + (1,) * (ndim - 1)) if out.dim() else out


# ---------------------------------------------------------------------------
# Training loss (diffusion.py:930-1014)
# ---------------------------------------------------------------------------


def _normal_kl(mean1, logvar1, mean2, logvar2):
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * torch.exp(-logvar2))


def _approx_std_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def _discretized_gaussian_ll(x, means, log_scales):
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = _approx_std_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = _approx_std_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    cdf_delta = cdf_plus - cdf_min
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus,
                                   torch.log(cdf_delta.clamp(min=1e-12))))


def _mean_flat(x):
    return x.mean(dim=tuple(range(1, x.dim())))


def training_losses(schedule: DiffusionSchedule, eps_pred: torch.Tensor,
                    var_logits: torch.Tensor, x_start: torch.Tensor,
                    x_t: torch.Tensor, t: torch.Tensor,
                    noise: torch.Tensor) -> torch.Tensor:
    """MSE(eps) + VB (learned range, frozen mean), per batch row, fp32.

    ``eps_pred``/``var_logits`` come from one model call on (x_t, t); the VB
    term sees eps through ``detach`` (the reference's frozen mean)."""
    x_start, x_t = x_start.float(), x_t.float()
    eps_pred, var_logits = eps_pred.float(), var_logits.float()
    mean, logvar = schedule.p_mean_variance(eps_pred.detach(), var_logits, x_t, t)
    true_mean, true_logvar = schedule.q_posterior(x_start, x_t, t)
    kl = _mean_flat(_normal_kl(true_mean, true_logvar, mean, logvar)) / math.log(2.0)
    decoder_nll = -_mean_flat(
        _discretized_gaussian_ll(x_start, mean, 0.5 * logvar)) / math.log(2.0)
    vb = torch.where(t == 0, decoder_nll, kl)
    mse = _mean_flat((noise - eps_pred) ** 2)
    return mse + vb


# model_fn(x (2B, ...), t_original (2B,)) -> (eps, var_logits), rows [cond | uncond]
ModelFn = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


@torch.no_grad()
def p_sample_loop(schedule: DiffusionSchedule, model_fn: ModelFn,
                  noise: torch.Tensor, *, cond_free_k: float = 2.0,
                  key: prng.Seed = 0,
                  noise_seq: Optional[torch.Tensor] = None,
                  rows: Optional[Rows] = None) -> torch.Tensor:
    """Ancestral sampler with ramped CFG (diffusion.py:445-485).

    Each step is one model call on 2B rows [cond | uncond].  ``noise_seq``:
    optional (num_timesteps, *x.shape) injection noises in the order they are
    used (first entry -> highest timestep); else step j draws a standard
    normal of ``x``'s shape under key j of JAX's ``split(key, n)`` (written
    to a device buffer in one launch), where ``rows``: ``x`` is these rows of
    the request's.  The last step adds no noise, so it draws none (JAX
    multiplies its draw by 0).
    """
    n = schedule.num_timesteps
    x = noise.float()
    keys = prng.split_keys(key, n, x.device) if noise_seq is None else None
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
             prng.draw(keys[step], x.shape, "normal", offset=prng.row_offset(rows, x.shape)))
        x = mean + torch.exp(0.5 * logvar) * z
    return x


def _cfg_eps(model_fn: ModelFn, x: torch.Tensor, t: torch.Tensor):
    """One model call on [x | x] at times ``t`` (2B,): fp32 (eps_c, eps_u)."""
    eps2, _ = model_fn(torch.cat([x, x], dim=0), t)
    return eps2.float().chunk(2, dim=0)


def _ramped_k(cond_free_k: float, i: int, n: int) -> float:
    """Guidance weight ``k * (1 - i / n)`` over the spaced index, in fp32."""
    f = np.float32
    return float(f(cond_free_k) * (f(1.0) - f(i) / f(n)))


@torch.no_grad()
def ddim_sample_loop(schedule: DiffusionSchedule, model_fn: ModelFn,
                     noise: torch.Tensor, *, eta: float = 0.0,
                     cond_free_k: float = 2.0) -> torch.Tensor:
    """DDIM with ramped CFG (diffusion.py:819-917); deterministic.  ``eta``
    is taken and unused (the update is the eta = 0 one), as in the JAX
    package."""
    del eta
    n = schedule.num_timesteps
    x = noise.float()
    for i in range(n - 1, -1, -1):
        eps_c, eps_u = _cfg_eps(model_fn, x, schedule.timestep_map[i].expand(2 * x.shape[0]))
        cfk = _ramped_k(cond_free_k, i, n)
        eps = (1 + cfk) * eps_c - cfk * eps_u
        pred_x0 = schedule.predict_xstart_from_eps(x, i, eps).clamp(-1, 1)
        # eps again from the clipped x0, as the reference does
        eps = ((schedule.sqrt_recip_alphas_cumprod[i] * x - pred_x0)
               / schedule.sqrt_recipm1_alphas_cumprod[i])
        acp_prev = schedule.alphas_cumprod_prev[i]
        x = pred_x0 * torch.sqrt(acp_prev) + torch.sqrt(1 - acp_prev) * eps
    return x


@torch.no_grad()
def dpmpp_2m_reference_sample_loop(model_fn: ModelFn, noise: torch.Tensor, *,
                                   steps: int, guidance_scale: float = 2.0,
                                   beta_0: float = 0.1 / 4,
                                   beta_1: float = 20.0 / 4) -> torch.Tensor:
    """The reference's configured DPM-Solver++(2M) (diffusion.py:487-581,
    dpm_solver.py): the continuous linear VP schedule (log alpha(t) =
    -t^2 (b1 - b0) / 4 - t b0 / 2) at ``time_uniform`` steps linspace(1,
    1e-3, steps + 1); the model at the float time t * 1000; constant
    guidance eps_u + k (eps_c - eps_u); unclipped x0 = (x - sigma eps) /
    alpha; multistep order 2 after a first-order first update, and no model
    call after the last update, which is first order below 10 steps
    (``lower_order_final``).  Per-step scalars are worked out in fp64 on the
    host and used as fp32."""
    if steps < 2:
        raise ValueError("dpm++2m multistep needs steps >= 2")
    ts = np.linspace(1.0, 1.0 / 1000.0, steps + 1)
    log_alpha = -0.25 * ts ** 2 * (beta_1 - beta_0) - 0.5 * ts * beta_0
    alpha = np.exp(log_alpha)
    sigma = np.sqrt(1.0 - np.exp(2.0 * log_alpha))
    lam = log_alpha - np.log(sigma)
    x = noise.float()
    dev = x.device

    def f32(a) -> torch.Tensor:
        return torch.tensor(np.float32(a), device=dev)

    def eval_x0(x, i):
        """Data prediction at ts[i] (one CFG model call)."""
        t_model = torch.full((2 * x.shape[0],), float(np.float32(ts[i] * 1000.0)),
                             device=dev)
        eps_c, eps_u = _cfg_eps(model_fn, x, t_model)
        eps = eps_u + guidance_scale * (eps_c - eps_u)
        return (x - f32(sigma[i]) * eps) / f32(alpha[i])

    # the first update: DPM-Solver-1 from ts[0] to ts[1]
    m_prev1 = eval_x0(x, 0)
    h1 = lam[1] - lam[0]
    x = f32(sigma[1] / sigma[0]) * x - f32(alpha[1] * np.expm1(-h1)) * m_prev1
    m_prev0 = eval_x0(x, 1)

    # multistep-2 updates to ts[2..steps]: h = lam[i] - lam[i-1],
    # r0 = (lam[i-1] - lam[i-2]) / h, D1 = (m0 - m1) / r0,
    # x <- (sigma[i] / sigma[i-1]) x - alpha[i] expm1(-h) (m0 + D1 / 2)
    idx = np.arange(2, steps + 1)
    h = lam[idx] - lam[idx - 1]
    ratio = sigma[idx] / sigma[idx - 1]
    aphi = alpha[idx] * np.expm1(-h)
    r0 = (lam[idx - 1] - lam[idx - 2]) / h

    def update(x, m0, m1, j):
        d1 = (m0 - m1) / f32(r0[j])
        return f32(ratio[j]) * x - f32(aphi[j]) * (m0 + 0.5 * d1)

    for j, i in enumerate(idx[:-1]):
        x = update(x, m_prev0, m_prev1, j)
        m_prev0, m_prev1 = eval_x0(x, i), m_prev0
    if steps < 10:  # lower_order_final: the last update is first order
        return f32(ratio[-1]) * x - f32(aphi[-1]) * m_prev0
    return update(x, m_prev0, m_prev1, len(idx) - 1)


@torch.no_grad()
def dpmpp_2m_sample_loop(schedule: DiffusionSchedule, model_fn: ModelFn,
                         noise: torch.Tensor, *,
                         cond_free_k: float = 2.0) -> torch.Tensor:
    """DPM-Solver++(2M) on karras-style sigmas sqrt((1 - acp) / acp) of the
    spaced schedule, high to low with a trailing 0, with the ramped guidance
    and the x0 clamp (``diffusion_sampler='dpmpp_2m_karras'``).  The input
    noise is scaled by the first sigma; the model sees the DDPM x_t = x /
    sqrt(1 + sigma^2).  The sigmas and the step scalars are fp32 on the
    host, with the JAX package's guards (the first step's r, h == 0, the
    1e-10 floor in t(sigma), the last step's x = x0)."""
    f = np.float32
    n = schedule.num_timesteps
    acp = schedule.alphas_cumprod.cpu().numpy()
    sigmas = np.append(np.sqrt((f(1) - acp) / acp)[::-1], f(0)).astype(f)

    def t_of(s):
        return -np.log(s)

    x = noise.float() * float(sigmas[0])
    old_denoised = torch.zeros_like(x)
    for idx in range(n):
        i = n - 1 - idx  # spaced index
        sigma, sigma_next = sigmas[idx], sigmas[idx + 1]
        x_ddpm = x / float(np.sqrt(f(1) + sigma * sigma))
        eps_c, eps_u = _cfg_eps(model_fn, x_ddpm,
                                schedule.timestep_map[i].expand(2 * x.shape[0]))
        cfk = _ramped_k(cond_free_k, i, n)
        eps = (1 + cfk) * eps_c - cfk * eps_u
        denoised = schedule.predict_xstart_from_eps(x_ddpm, i, eps).clamp(-1, 1)
        t_cur, t_next = t_of(sigma), t_of(np.maximum(sigma_next, f(1e-10)))
        h = t_next - t_cur
        if idx > 0:
            r = ((t_cur - t_of(np.maximum(sigmas[idx - 1], f(1e-10))))
                 / (f(1) if h == 0 else h))
            c = f(1) / (f(2) * r)
            denoised_d = float(f(1) + c) * denoised - float(c) * old_denoised
        else:
            denoised_d = denoised
        if sigma_next == 0:
            x = denoised
        else:
            x = float(sigma_next / sigma) * x - float(np.expm1(-h)) * denoised_d
        old_denoised = denoised
    return x
