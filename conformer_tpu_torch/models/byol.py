"""BYOL-style self-supervised pretraining of the Conformer encoder
(counterpart of conformer_tpu/models/byol.py).

Two SpecAugment views of the same log-mels go through an online tower
(``ConformerEncoder`` named ``encoder``, a projector and a predictor) and a
target tower (encoder and projector, an exponential moving average of the
online ones); the loss is the symmetric masked-mean cosine regression of
the predictions on the targets (train/pretrain.py). ``BYOLPretrain`` holds
both towers in one module, the target's parameters frozen, so that one
``state_dict`` and one checkpoint carry a whole run and the optimizer sees
only the online parameters. The target always runs as in evaluation: no
dropout, BatchNorm on its running statistics, which nothing updates (the
JAX step never updates ``target_batch_stats`` either). Under a mesh both
encoders split over the model group alike (parallel/mesh.py), so the EMA
runs on each rank's shards; the projector and predictor stay whole.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from conformer_tpu_torch.config import ModelConfig, PretrainConfig
from conformer_tpu_torch.models.encoder import ConformerEncoder
from conformer_tpu_torch.models.layers import Dense, LayerNorm


class MLPHead(nn.Module):
    """Dense -> LayerNorm (eps 1e-6) -> ReLU -> Dense."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(in_features, hidden, dtype)
        self.norm = LayerNorm(hidden, dtype)
        self.fc2 = Dense(hidden, out, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.norm(self.fc1(x))))


class BYOLNet(nn.Module):
    """Encoder + projector (+ predictor): one tower."""

    def __init__(self, cfg: ModelConfig, pre: PretrainConfig,
                 with_predictor: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = ConformerEncoder(cfg, dtype)
        self.projector = MLPHead(cfg.d_model, pre.predictor_hidden,
                                 pre.proj_dim, dtype)
        self.predictor = (MLPHead(pre.proj_dim, pre.predictor_hidden,
                                  pre.proj_dim, dtype)
                          if with_predictor else None)

    def forward(self, mels: torch.Tensor, lengths: Optional[torch.Tensor],
                dropout_seed: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """-> (projections (B, T', proj) fp32, subsampled lengths)."""
        enc, out_lengths = self.encoder(mels, lengths, dropout_seed)
        proj = self.projector(enc)
        if self.predictor is not None:
            proj = self.predictor(proj)
        return proj.float(), out_lengths


class BYOLPretrain(nn.Module):
    """The online tower (``online``, with the predictor) and the target
    tower (``target``, frozen, always in evaluation mode)."""

    def __init__(self, cfg: ModelConfig, pre: PretrainConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.online = BYOLNet(cfg, pre, True, dtype)
        self.target = BYOLNet(cfg, pre, False, dtype)
        self.target.requires_grad_(False)
        self.target.eval()

    def train(self, mode: bool = True) -> "BYOLPretrain":
        super().train(mode)
        self.target.eval()
        return self

    @torch.no_grad()
    def reset_target(self) -> None:
        """Copy the online encoder and projector into the target tower."""
        online = dict(self.online.named_parameters())
        for name, p in self.target.named_parameters():
            p.copy_(online[name])
        online_buffers = dict(self.online.named_buffers())
        for name, b in self.target.named_buffers():
            b.copy_(online_buffers[name])


def byol_loss(pred: torch.Tensor, target: torch.Tensor,
              frame_mask: Optional[torch.Tensor] = None,
              count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """2 - 2 cos per frame, the mean over the valid frames; ``target``
    carries no gradient. ``count``: the valid frames to divide by (under a
    mesh the global batch's); default these rows'."""
    pred = pred / (torch.linalg.vector_norm(pred, dim=-1, keepdim=True) + 1e-8)
    target = target / (torch.linalg.vector_norm(target, dim=-1, keepdim=True)
                       + 1e-8)
    per_frame = 2.0 - 2.0 * (pred * target).sum(dim=-1)
    if frame_mask is None:
        return per_frame.mean()
    m = frame_mask.float()
    return (per_frame * m).sum() / torch.clamp(
        m.sum() if count is None else count, min=1.0)


@torch.no_grad()
def ema_update(target: nn.Module, online: nn.Module, decay: float) -> None:
    """target <- decay * target + (1 - decay) * online, over the target's
    parameters (encoder and projector; it has no predictor)."""
    online_params = dict(online.named_parameters())
    names = [n for n, _ in target.named_parameters()]
    t = [p for _, p in target.named_parameters()]
    o = [online_params[n] for n in names]
    torch._foreach_mul_(t, decay)
    torch._foreach_add_(t, o, alpha=1.0 - decay)
