"""Faults planted under a tiny run's timed path (the program's own classes,
patched in the test's process), each of a kind the cell can have: a step
that returns its state unchanged, half of the batch left out, an answer
altered where it is produced. One cell has one chip, so no exchange between
chips can be left out."""

from __future__ import annotations


def _inpaint(fault: str) -> None:
    import torch

    from followmyhold_tpu_torch.models.flux import FluxTransformer, FluxVae
    from followmyhold_tpu_torch.preprocess.inpaint import FluxKontextInpainter

    if fault == "state_unchanged":          # no velocity: the latents never move
        FluxTransformer.forward = lambda self, hidden, *a, **k: torch.zeros_like(
            hidden, dtype=torch.float32)
    elif fault == "half_batch":             # every second crop handed back as it came
        call = FluxKontextInpainter.__call__
        seen = []

        def half(self, image_rgb, prompt, initial_noise=None):
            seen.append(1)
            if len(seen) % 2 == 0:
                return image_rgb
            return call(self, image_rgb, prompt, initial_noise=initial_noise)

        FluxKontextInpainter.__call__ = half
    elif fault == "answer_altered":         # the decoded image shifted
        decode = FluxVae.decode
        FluxVae.decode = lambda self, z: decode(self, z) + 0.1


def plant(traffic: str, fault: str) -> None:
    if fault == "none":
        return
    {"inpaint": _inpaint}[traffic](fault)
