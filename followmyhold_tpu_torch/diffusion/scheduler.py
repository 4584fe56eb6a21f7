"""Flow-matching Euler scheduler with REVERSED sigmas (0 -> 1).

Counterpart of followmyhold_tpu/diffusion/scheduler.py. The schedule is a
static tuple and every step variant is a pure function of (schedule,
step_index, model_output, sample):

- step:       prev = x + (sig[i+1]-sig[i])*eps, pred_x1 = x + (1-sig[i])*eps;
              the caller owns the index.
- step_final: pred_x1 only.

Sigmas: the given sigmas pass through shift*s / (1 + (shift-1)*s), then a
trailing 1.0 is appended; timesteps = sigmas * num_train_timesteps. The sigmas
are kept as Python floats (computed in float32 with numpy, as the reference
does), so indexing them costs no device round trip.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class FlowMatchSchedule(NamedTuple):
    sigmas: Tuple[float, ...]      # [N+1] (trailing 1.0 appended)
    timesteps: Tuple[float, ...]   # [N] = sigmas[:-1] * num_train_timesteps
    num_train_timesteps: int


def make_schedule(
    num_inference_steps: Optional[int] = None,
    num_train_timesteps: int = 1000,
    shift: float = 1.0,
    sigmas: Optional[np.ndarray] = None,
) -> FlowMatchSchedule:
    if sigmas is None:
        # default path: derive sigmas from the training schedule's extremes
        base = np.linspace(1, num_train_timesteps, num_train_timesteps,
                           dtype=np.float32) / num_train_timesteps
        base = shift * base / (1 + (shift - 1) * base)
        sigma_max, sigma_min = float(base[0]), float(base[-1])
        t = np.linspace(sigma_max * num_train_timesteps,
                        sigma_min * num_train_timesteps, num_inference_steps)
        sigmas = t / num_train_timesteps

    sigmas = np.asarray(sigmas, np.float32)
    sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
    timesteps = sigmas * num_train_timesteps
    sigmas_full = np.concatenate([sigmas, np.ones(1, np.float32)])
    return FlowMatchSchedule(
        sigmas=tuple(float(s) for s in sigmas_full),
        timesteps=tuple(float(t) for t in timesteps),
        num_train_timesteps=num_train_timesteps,
    )


def _sigma_f32(schedule: FlowMatchSchedule, index: int) -> np.float32:
    return np.float32(schedule.sigmas[index])


def step(
    schedule: FlowMatchSchedule,
    step_index: int,
    model_output: torch.Tensor,
    sample: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (prev_sample, pred_x1); float32 internally."""
    x = sample.float()
    eps = model_output.float()
    sigma = _sigma_f32(schedule, step_index)
    sigma_next = _sigma_f32(schedule, step_index + 1)
    prev = x + float(sigma_next - sigma) * eps
    pred_x1 = x + float(np.float32(1.0) - sigma) * eps
    return prev.to(model_output.dtype), pred_x1.to(model_output.dtype)


def step_final(
    schedule: FlowMatchSchedule,
    step_index: int,
    model_output: torch.Tensor,
    sample: torch.Tensor,
) -> torch.Tensor:
    """Clean-sample estimate pred_x1 = x + (1-sigma)*eps."""
    sigma = _sigma_f32(schedule, step_index)
    out = sample.float() + float(np.float32(1.0) - sigma) * model_output.float()
    return out.to(model_output.dtype)


def scale_noise(
    schedule: FlowMatchSchedule,
    step_index: int,
    sample: torch.Tensor,
    noise: torch.Tensor,
) -> torch.Tensor:
    """Forward process z_t = sigma*noise + (1-sigma)*x."""
    sigma = float(_sigma_f32(schedule, step_index))
    return sigma * noise + (1.0 - sigma) * sample
