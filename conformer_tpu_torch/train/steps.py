"""Forward and eval steps: audio -> log-mels -> model -> logits / greedy tokens
(counterpart of the serving half of conformer_tpu/train/steps.py).

PyTorch runs eagerly, so a "step" is a plain function over a model that
holds its weights. The train step comes with the training slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from conformer_tpu_torch.audio.mel import MelFrontend
from conformer_tpu_torch.config import Config
from conformer_tpu_torch.ops.ctc import greedy_decode


def make_forward(cfg: Config, model: torch.nn.Module,
                 frontend: Optional[MelFrontend] = None) -> Callable:
    """-> forward(audio (B, S) fp32, audio_lengths (B,)) -> (logits fp32
    (B, T', V), lengths (B,)), on the model's device, without autograd."""
    device = next(model.parameters()).device
    frontend = frontend or MelFrontend(cfg.audio, device=device)

    @torch.inference_mode()
    def forward(audio: torch.Tensor, audio_lengths: torch.Tensor):
        mels = frontend(audio)
        return model(mels, frontend.frame_lengths(audio_lengths))

    return forward


def make_eval_step(cfg: Config, model: torch.nn.Module,
                   frontend: Optional[MelFrontend] = None,
                   unk_id: Optional[int] = None) -> Callable:
    """-> step(audio, audio_lengths) -> {tokens, counts, log_probs, lengths}:
    collapsed greedy tokens on the device, text assembly left to the host."""
    forward = make_forward(cfg, model, frontend)

    @torch.inference_mode()
    def step(audio: torch.Tensor, audio_lengths: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
        logits, out_lengths = forward(audio, audio_lengths)
        tokens, counts = greedy_decode(logits, out_lengths, unk_id=unk_id)
        return {"tokens": tokens, "counts": counts,
                "log_probs": torch.log_softmax(logits, dim=-1),
                "lengths": out_lengths}

    return step
