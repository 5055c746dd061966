"""Diffusion noise schedulers: the DDPM schedule pieces the SDS step needs,
the DDPM ancestral sampler, EulerAncestral for Zero123++ generation, PNDM
(PLMS) for the SD2-depth img2img bootstrap, and the DreamTime t schedule.

Counterpart of contexture_nerf_tpu/diffusion/schedulers.py (all of it).
SD's "scaled_linear" betas: linspace(sqrt(b0), sqrt(b1), T)^2, with
b0 = 0.00085, b1 = 0.012. The samplers' `step` functions take their normal
draw as a tensor, so a test can feed the reference's `jax.random` draws;
their timestep sequences are host ints.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from contexture_nerf_tpu_torch import resolve_device


def make_alphas_cumprod(device="cuda") -> torch.Tensor:
    """(1000,) f32 alphas_cumprod of the scaled-linear schedule. Computed in
    f32, as the reference is (JAX without x64 demotes its float64
    request)."""
    betas = torch.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000,
                           dtype=torch.float32) ** 2
    return torch.cumprod(1.0 - betas, dim=0).to(resolve_device(device))


def _acp(alphas_cumprod, t, sample):
    t = torch.as_tensor(t, device=alphas_cumprod.device).long().reshape(-1)
    return alphas_cumprod[t].reshape((-1,) + (1,) * (sample.dim() - 1)).to(
        sample.dtype)


def add_noise(alphas_cumprod, sample, noise, t):
    """x_t = sqrt(acp_t) x_0 + sqrt(1 - acp_t) eps."""
    acp = _acp(alphas_cumprod, t, sample)
    return torch.sqrt(acp) * sample + torch.sqrt(1.0 - acp) * noise


def velocity_target(alphas_cumprod, sample, noise, t):
    """v = sqrt(acp) eps - sqrt(1 - acp) x_0."""
    acp = _acp(alphas_cumprod, t, sample)
    return torch.sqrt(acp) * noise - torch.sqrt(1.0 - acp) * sample


def pred_x0_from_v(alphas_cumprod, sample, v, t):
    """x_0 of a v-prediction: sqrt(acp) x_t - sqrt(1 - acp) v."""
    acp = _acp(alphas_cumprod, t, sample)
    return torch.sqrt(acp) * sample - torch.sqrt(1.0 - acp) * v


def pred_eps_from_v(alphas_cumprod, sample, v, t):
    """eps of a v-prediction: sqrt(acp) v + sqrt(1 - acp) x_t."""
    acp = _acp(alphas_cumprod, t, sample)
    return torch.sqrt(acp) * v + torch.sqrt(1.0 - acp) * sample


class DDPM:
    """The DDPM ancestral sampler (diffusers' math) for "epsilon" or
    "v_prediction" model outputs."""

    def __init__(self, alphas_cumprod: torch.Tensor,
                 num_train_timesteps: int = 1000,
                 prediction_type: str = "epsilon"):
        self.alphas_cumprod = alphas_cumprod
        self.num_train_timesteps = num_train_timesteps
        self.prediction_type = prediction_type

    @staticmethod
    def create(num_train_timesteps: int = 1000,
               prediction_type: str = "epsilon", device="cuda") -> "DDPM":
        return DDPM(make_alphas_cumprod(device), num_train_timesteps,
                    prediction_type)

    def timesteps(self, num_inference_steps: int) -> List[int]:
        """arange(n) * (T // n), reversed."""
        ratio = self.num_train_timesteps // num_inference_steps
        return [i * ratio for i in range(num_inference_steps)][::-1]

    def scale_model_input(self, sample, t):
        """The sample unchanged: this sampler does not scale its input."""
        return sample

    def add_noise(self, sample, noise, t):
        return add_noise(self.alphas_cumprod, sample, noise, t)

    def step(self, model_output: torch.Tensor, t: int, sample: torch.Tensor,
             noise: torch.Tensor, num_inference_steps: int) -> torch.Tensor:
        """One ancestral reverse step x_t -> x_{t - T // n}; `noise` is its
        normal draw, added with std sqrt(variance) (clipped at 1e-20) only
        where t > 0."""
        t = int(t)
        prev_t = t - self.num_train_timesteps // num_inference_steps
        acp = self.alphas_cumprod
        acp_t = acp[t]
        acp_prev = acp[prev_t] if prev_t >= 0 else torch.ones_like(acp_t)
        beta_prod_t = 1 - acp_t
        beta_prod_prev = 1 - acp_prev
        current_alpha = acp_t / acp_prev
        current_beta = 1 - current_alpha
        if self.prediction_type == "epsilon":
            x0 = (sample - torch.sqrt(beta_prod_t) * model_output) / \
                torch.sqrt(acp_t)
        elif self.prediction_type == "v_prediction":
            x0 = pred_x0_from_v(acp, sample, model_output, [t])
        else:
            raise NotImplementedError(self.prediction_type)
        x0_coeff = torch.sqrt(acp_prev) * current_beta / beta_prod_t
        xt_coeff = torch.sqrt(current_alpha) * beta_prod_prev / beta_prod_t
        prev = x0_coeff * x0 + xt_coeff * sample
        variance = torch.clamp(beta_prod_prev / beta_prod_t * current_beta,
                               min=1e-20)
        std = torch.sqrt(variance) if t > 0 else torch.zeros_like(variance)
        return prev + std * noise.to(prev.dtype)


def trailing_timesteps(num_train_timesteps: int,
                       num_inference_steps: int) -> List[int]:
    """round(arange(T, 0, -T / n)) - 1, the arange in f32 and the rounding
    half to even before the subtraction, as diffusers and the reference
    do. The reference's f32 arange puts some values on the other side of a
    .5 than a float64 one (n = 48), so it is computed in f32 here too."""
    T = num_train_timesteps
    ts = np.arange(T, 0, -T / num_inference_steps, dtype=np.float32)
    return (np.round(ts).astype(np.int64) - 1).tolist()


def linspace_timesteps(num_train_timesteps: int,
                       num_inference_steps: int) -> List[int]:
    """round(linspace(0, T - 1, n)), reversed: the reference's f32
    linspace, whose XLA evaluation takes i * ((T - 1) * (1 / (n - 1)))
    with each product rounded to f32 (the rounding decides n = 31)."""
    n, last = num_inference_steps, np.float32(num_train_timesteps - 1)
    if n == 1:
        vals = np.zeros(1, np.float32)
    else:
        step = np.float32(last * (np.float32(1) / np.float32(n - 1)))
        vals = np.append(np.arange(n - 1, dtype=np.float32) * step, last)
    return np.round(vals[::-1]).astype(np.int64).tolist()


class EulerAncestral:
    """The Euler ancestral sampler of Zero123++ generation (its hub
    config: v_prediction, trailing spacing)."""

    def __init__(self, alphas_cumprod: torch.Tensor,
                 num_train_timesteps: int = 1000,
                 prediction_type: str = "v_prediction",
                 timestep_spacing: str = "trailing"):
        self.alphas_cumprod = alphas_cumprod
        self.num_train_timesteps = num_train_timesteps
        self.prediction_type = prediction_type
        self.timestep_spacing = timestep_spacing

    @staticmethod
    def create(num_train_timesteps: int = 1000,
               prediction_type: str = "v_prediction",
               timestep_spacing: str = "trailing",
               device="cuda") -> "EulerAncestral":
        return EulerAncestral(make_alphas_cumprod(device),
                              num_train_timesteps, prediction_type,
                              timestep_spacing)

    @property
    def all_sigmas(self) -> torch.Tensor:
        acp = self.alphas_cumprod
        return torch.sqrt((1 - acp) / acp)

    def timesteps_and_sigmas(self, num_inference_steps: int
                             ) -> Tuple[List[int], torch.Tensor]:
        """(the n timesteps, their (n + 1,) f32 sigmas with a final 0)."""
        T = self.num_train_timesteps
        if self.timestep_spacing == "trailing":
            ts = trailing_timesteps(T, num_inference_steps)
        else:
            ts = linspace_timesteps(T, num_inference_steps)
        sigmas = self.all_sigmas[torch.tensor(
            ts, device=self.alphas_cumprod.device)]
        return ts, torch.cat([sigmas, sigmas.new_zeros(1)])

    def scale_model_input(self, sample, sigma):
        return sample / torch.sqrt(sigma ** 2 + 1)

    def add_noise(self, sample, noise, sigma):
        return sample + noise * sigma

    def step(self, model_output: torch.Tensor, step_index: int,
             sample: torch.Tensor, sigmas: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
        """One Euler ancestral step from sigmas[i] to sigmas[i + 1]; `noise`
        is its normal draw. The model output (bf16 at full size) is taken
        in f32, as the reference's f32 sigma promotes it."""
        sigma, sigma_to = sigmas[step_index], sigmas[step_index + 1]
        out = model_output.float()
        if self.prediction_type == "epsilon":
            x0 = sample - sigma * out
        elif self.prediction_type == "v_prediction":
            x0 = (out * (-sigma / torch.sqrt(sigma ** 2 + 1))
                  + sample / (sigma ** 2 + 1))
        else:
            raise NotImplementedError(self.prediction_type)
        sigma_up = torch.sqrt(sigma_to ** 2 * (sigma ** 2 - sigma_to ** 2)
                              / sigma ** 2)
        sigma_down = torch.sqrt(sigma_to ** 2 - sigma_up ** 2)
        derivative = (sample - x0) / sigma
        prev = sample + derivative * (sigma_down - sigma)
        return prev + noise.to(prev.dtype) * sigma_up


@dataclass
class PLMSState:
    """The PLMS ring of the last four eps predictions (oldest first), how
    many of them are real, the held sample and the step counter. The
    tensors are f32, as the reference's state is; the counts are host ints
    (the loop runs on the host)."""

    ets: List[torch.Tensor]
    ets_count: int
    cur_sample: torch.Tensor
    counter: int


class PNDM:
    """PNDM with skip_prk_steps and steps_offset=1 (PLMS), as configured for
    SD2-depth: the 51-entry timestep sequence repeats its second entry, the
    counter == 1 step re-runs from the held sample at t + ratio, and the
    linear-multistep orders ramp 1, 1, 2, 3, 4."""

    def __init__(self, alphas_cumprod: torch.Tensor,
                 num_train_timesteps: int = 1000):
        self.alphas_cumprod = alphas_cumprod
        self.num_train_timesteps = num_train_timesteps

    @staticmethod
    def create(num_train_timesteps: int = 1000, device="cuda") -> "PNDM":
        return PNDM(make_alphas_cumprod(device), num_train_timesteps)

    def timesteps(self, num_inference_steps: int) -> List[int]:
        """ts = arange(n) * ratio + 1, then [ts[:-1], ts[-2], ts[-1]]
        reversed."""
        ratio = self.num_train_timesteps // num_inference_steps
        ts = [i * ratio + 1 for i in range(num_inference_steps)]
        return (ts[:-1] + ts[-2:-1] + ts[-1:])[::-1]

    def scale_model_input(self, sample, t):
        """The sample unchanged: this sampler does not scale its input."""
        return sample

    def add_noise(self, sample, noise, t):
        return add_noise(self.alphas_cumprod, sample, noise, t)

    def init_state(self, sample_shape, device) -> PLMSState:
        z = torch.zeros(sample_shape, dtype=torch.float32, device=device)
        return PLMSState([z] * 4, 0, z, 0)

    def _prev_sample(self, sample, t: int, prev_t: int, eps):
        """diffusers' _get_prev_sample closed form, in f32."""
        acp = self.alphas_cumprod
        acp_t = acp[max(t, 0)]
        acp_prev = acp[prev_t] if prev_t >= 0 else torch.ones_like(acp_t)
        sample_coeff = torch.sqrt(acp_prev / acp_t)
        denom = (acp_t * torch.sqrt(1 - acp_prev)
                 + torch.sqrt(acp_t * (1 - acp_t) * acp_prev))
        eps_coeff = (acp_prev - acp_t) / denom
        return sample_coeff * sample - eps_coeff * eps

    def step(self, state: PLMSState, model_output: torch.Tensor, t: int,
             sample: torch.Tensor, num_inference_steps: int
             ) -> Tuple[PLMSState, torch.Tensor]:
        """One PLMS step; returns (new state, previous sample)."""
        ratio = self.num_train_timesteps // num_inference_steps
        t = int(t)
        counter = state.counter
        if counter == 1:  # re-run from cur_sample with t := t + ratio
            eff_t, eff_prev_t = t + ratio, t
        else:
            eff_t, eff_prev_t = t, t - ratio
        ets, ets_count = state.ets, state.ets_count
        if counter != 1:
            ets = ets[1:] + [model_output]
            ets_count = min(ets_count + 1, 4)
        e1, e2, e3, e4 = ets[-1], ets[-2], ets[-3], ets[-4]
        use_sample = state.cur_sample if counter == 1 else sample
        cur_sample = sample if counter == 0 else state.cur_sample
        if ets_count == 1 and counter == 0:
            eps = model_output
        elif counter == 1:
            eps = (model_output + e1) / 2
        elif ets_count == 2:
            eps = (3 * e1 - e2) / 2
        elif ets_count == 3:
            eps = (23 * e1 - 16 * e2 + 5 * e3) / 12
        else:
            eps = (55 * e1 - 59 * e2 + 37 * e3 - 9 * e4) / 24
        prev = self._prev_sample(use_sample, eff_t, eff_prev_t, eps)
        return PLMSState(ets, ets_count, cur_sample, counter + 1), prev


def dreamtime_schedule(alphas_cumprod: torch.Tensor, total_iterations: int,
                       m: float = 500, s: float = 125) -> torch.Tensor:
    """DreamTime t(i) for i in [0, N), (N,) int64."""
    acp = alphas_cumprod.float().cpu()
    T = acp.shape[0]
    w_d = torch.sqrt(1 - acp)
    ts = torch.arange(T, dtype=torch.float32)
    w_p = torch.exp(-((ts - m) ** 2) / (2 * s ** 2))
    w = w_d * w_p
    w = w / w.sum()
    cumulative_survival = torch.flip(torch.cumsum(torch.flip(w, [0]), 0), [0])
    targets = torch.arange(total_iterations,
                           dtype=torch.float32) / total_iterations
    diffs = torch.abs(cumulative_survival[None, :] - targets[:, None])
    return torch.argmin(diffs, dim=1)
