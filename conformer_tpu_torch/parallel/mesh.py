"""The ("data", "model") mesh over a torch.distributed process group
(counterpart of conformer_tpu/parallel/mesh.py).

The JAX package runs one process for all devices and lets GSPMD place the
collectives. Here, as ``torch.distributed.run`` launches it, each rank is a
process of its own, and the collectives are written out
(parallel/collectives.py):

- rank ``r`` sits at data index ``r // tp`` and model index ``r % tp`` (the
  layout ``np.asarray(devices).reshape(dp, tp)`` gives the JAX mesh); the
  data group joins the ranks of one model index, the model group those of
  one data index;
- batch rows are split over the data group (each rank takes its stripe of
  the global batch, ``batch_stripe``); the gradients are summed over it,
  since every loss is the local sum over the global count;
- the big products are split over the model group by ``_TP_RULES`` (FFN
  hidden units, attention heads, the conv module's channels, the decoder's
  LSTM gates and vocabulary), Megatron-style: column-parallel into the
  split, row-parallel out of it;
- ``model.seq_shard`` adds sequence parallelism (``SeqShard``): between the
  split regions the activations are split along L over the model group.

Checkpoints keep the single-device format: ``full_state_dict`` gathers the
split tensors, ``load_full_state_dict`` splits them again.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

from conformer_tpu_torch.config import ModelConfig, ParallelConfig
from conformer_tpu_torch.parallel import collectives as cc

DATA_AXIS = "data"
MODEL_AXIS = "model"
# A tensor split along dim 0 in two halves, each half split over the model
# group: pointwise1's [value | gate] output, so that every rank holds the
# value channels and the gate channels that the GLU pairs.
PAIRED = "paired"
Spec = Union[int, str, None]


@dataclass(eq=False)
class Mesh:
    dp: int
    tp: int
    rank: int
    data_group: object
    model_group: object
    device: torch.device
    axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)

    @property
    def data_index(self) -> int:
        return self.rank // self.tp

    @property
    def model_index(self) -> int:
        return self.rank % self.tp

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: self.dp, self.axis_names[1]: self.tp}

    def batch_offset(self, rows: int) -> int:
        """The global row of this rank's first row, when each data rank
        holds ``rows`` rows."""
        return self.data_index * rows

    def data_count(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data group (no gradient)."""
        return cc.all_reduce(x.detach(), self.data_group)


def local_device(device) -> torch.device:
    """``device``; a bare 'cuda' under a launcher is this rank's card
    (LOCAL_RANK modulo the cards there are)."""
    device = torch.device(device)
    if (device.type == "cuda" and device.index is None
            and "LOCAL_RANK" in os.environ):
        n = torch.cuda.device_count()
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]) % max(n, 1))
    return device


def init_process_group(device) -> None:
    """Initialise the default process group from the launcher's environment
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE: ``torch.distributed.run``
    sets them), unless one is initialised already: NCCL for a CUDA device,
    gloo for the CPU. Without a launcher the world is this process alone."""
    if dist.is_initialized() or "RANK" not in os.environ:
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", device_id=device)
    else:
        dist.init_process_group("gloo")


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(dp: Optional[int] = None, tp: int = 1, device="cpu",
              axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)) -> Mesh:
    """The (dp, tp) mesh over the default process group; dp defaults to
    world size // tp. A world of another size than dp * tp raises."""
    n = world_size()
    if dp is None or dp == 0:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} ranks")
    if not dist.is_initialized():
        raise ValueError("a mesh needs an initialised process group "
                         "(launch with torch.distributed.run)")
    rank = dist.get_rank()
    data_group = model_group = None
    # every rank creates every group, in the same order
    for m in range(tp):
        g = dist.new_group([d * tp + m for d in range(dp)])
        if rank % tp == m:
            data_group = g
    for d in range(dp):
        g = dist.new_group([d * tp + m for m in range(tp)])
        if rank // tp == d:
            model_group = g
    return Mesh(dp, tp, rank, data_group, model_group,
                torch.device(device), tuple(axis_names))


def mesh_from_config(cfg: ParallelConfig, device="cpu") -> Mesh:
    return make_mesh(cfg.dp or None, cfg.tp, device,
                     (cfg.data_axis, cfg.model_axis))


def node_layout() -> Tuple[int, int]:
    """(this node's index, the number of nodes) of a launch over several
    nodes: LOCAL_WORLD_SIZE ranks a node, in rank order."""
    n = world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    rank = dist.get_rank() if dist.is_initialized() else 0
    return rank // local, max(n // local, 1)


# ---------------------------------------------------------------------------
# Parameter partitioning rules: a regex over the port's state_dict name ->
# the dimension the model group splits (PyTorch layouts: Linear weights are
# (out, in), so a column-parallel split is dim 0 and a row-parallel one
# dim 1). The JAX rules at conformer_tpu/parallel/mesh.py:63-81, plus the
# conv module's channel-local tensors (depthwise conv and its norm), which
# GSPMD reshards around and the port keeps on the rank of their channels.
# ---------------------------------------------------------------------------

_TP_RULES: Tuple[Tuple[str, Spec], ...] = (
    (r"(.*\.)?ffn\d\.hidden\.(weight|bias)$", 0),
    (r"(.*\.)?ffn\d\.out\.weight$", 1),
    (r"(.*\.)?attention\.(query|key|value|pos)\.(weight|bias)$", 0),
    (r"(.*\.)?attention\.(content_bias|position_bias)$", 0),
    (r"(.*\.)?attention\.out\.weight$", 1),
    (r"(.*\.)?conv\.pointwise1\.(weight|bias)$", PAIRED),
    (r"(.*\.)?conv\.depthwise\.(weight|bias)$", 0),
    (r"(.*\.)?conv\.(bn\.(scale|bias|mean|var)|group_norm\.(weight|bias))$", 0),
    (r"(.*\.)?conv\.pointwise2\.weight$", 1),
    (r"decoder\.lstm\.\d+\.(weight_ih|bias_ih|bias_hh)$", 0),
    (r"decoder\.classifier\.(weight|bias)$", 0),
)
# Under sequence parallelism, the parameters of a split module used on a
# rank's own rows (its LayerNorm, the bias added after the row-parallel
# reduce-scatter) and each block's final LayerNorm: their gradients are
# partial sums over the model group.
_SP_PARTIAL = (
    r"(.*\.)?(ffn\d|mhsa|conv)\.norm\.(weight|bias)$",
    r"(.*\.)?ffn\d\.out\.bias$",
    r"(.*\.)?attention\.out\.bias$",
    r"(.*\.)?conv\.pointwise2\.bias$",
)
_FINAL_NORM = r"(.*\.)?final_norm\.(weight|bias)$"


def param_spec(name: str, shape: Sequence[int], tp: int,
               n_heads: Optional[int] = None) -> Spec:
    """The dimension of tensor ``name`` (of ``shape``) that the model group
    splits, PAIRED, or None (replicated). A split applies only where the
    dimension divides by tp (heads, for the attention): otherwise the
    tensor stays replicated, with the same numbers."""
    if tp <= 1:
        return None
    for pattern, spec in _TP_RULES:
        if re.match(pattern, name):
            if ".attention." in name and (n_heads is None or n_heads % tp):
                return None
            dim = 0 if spec == PAIRED else spec
            size = shape[dim] // (2 if spec == PAIRED else 1)
            return spec if size % tp == 0 and size >= tp else None
    return None


def shard_tensor(full: torch.Tensor, spec: Spec, index: int,
                 n: int) -> torch.Tensor:
    """Part ``index`` of ``n`` of a full tensor under ``spec``."""
    if spec is None:
        return full
    if spec == PAIRED:
        return torch.cat([h.chunk(n, 0)[index] for h in full.chunk(2, 0)])
    return full.chunk(n, spec)[index].contiguous()


def gather_tensors(parts: Sequence[torch.Tensor], specs: Sequence[Spec],
                   group) -> List[torch.Tensor]:
    """The full tensors from every rank's ``parts`` under ``specs`` (None:
    the part is the whole), through one all-gather of the flattened parts
    a dtype (a collective: every rank of ``group`` calls it, with parts of
    the same shapes)."""
    out = list(parts)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, spec in enumerate(specs):
        if spec is not None:
            by_dtype.setdefault(parts[i].dtype, []).append(i)
    for idx in by_dtype.values():
        # a PAIRED part gathers as its two halves, each along dim 0
        pieces = [(i, h) for i in idx for h in (
            parts[i].chunk(2, 0) if specs[i] == PAIRED else (parts[i],))]
        stacked = cc.all_gather_stack(
            torch.cat([h.reshape(-1) for _, h in pieces]), group)
        gathered, off = {}, 0
        for i, h in pieces:
            rows = [r[off:off + h.numel()].view(h.shape) for r in stacked]
            dim = 0 if specs[i] == PAIRED else specs[i]
            gathered.setdefault(i, []).append(torch.cat(rows, dim=dim))
            off += h.numel()
        for i, halves in gathered.items():
            out[i] = torch.cat(halves) if len(halves) > 1 else halves[0]
    return out


def gather_tensor(local: torch.Tensor, spec: Spec, group) -> torch.Tensor:
    """The full tensor from every rank's part under ``spec`` (a
    collective, as gather_tensors)."""
    return gather_tensors([local], [spec], group)[0]


def zero_dim(shape: Sequence[int], spec: Spec, dp: int) -> Optional[int]:
    """ZeRO-1's dimension for a moment of ``shape``: the first that the
    model group does not split and that divides by dp (as
    make_opt_state_shardings(zero=True)); None keeps it whole."""
    if dp <= 1:
        return None
    tp_dim = 0 if spec == PAIRED else spec
    for i, n in enumerate(shape):
        if i != tp_dim and n >= dp and n % dp == 0:
            return i
    return None


# ---------------------------------------------------------------------------
# Sequence parallelism.
# ---------------------------------------------------------------------------

class SeqShard:
    """Megatron sequence parallelism over the model group for one forward
    of length ``length`` (counterpart of seq_shard_constraint): an uneven
    L is padded to a multiple of tp, as GSPMD pads; rank m holds rows
    [m * rows, (m + 1) * rows) of the padded sequence."""

    def __init__(self, mesh: Mesh, length: int):
        self.mesh, self.length = mesh, length
        self.rows = -(-length // mesh.tp)
        self.padded = self.rows * mesh.tp
        self.offset = mesh.model_index * self.rows

    def _pad(self, x: torch.Tensor) -> torch.Tensor:
        extra = self.padded - x.shape[1]
        return F.pad(x, (0, 0, 0, extra)) if extra else x

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated (B, L, D) -> this rank's rows (backward: gather)."""
        return cc.scatter_to_model(self._pad(x), self.mesh.model_group, 1)

    def gather_replicated(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows -> the whole (B, L, D), for a consumer that
        every rank runs alike (backward: this rank's rows)."""
        full = cc.gather_from_model(x, self.mesh.model_group, 1)
        return full[:, :self.length]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows -> the whole (B, L, D), for a column-parallel
        product (backward: reduce-scatter)."""
        full = cc.gather_seq(x, self.mesh.model_group, 1)
        return full[:, :self.length]

    def reduce_scatter(self, y: torch.Tensor) -> torch.Tensor:
        """A row-parallel product's partial (B, L, D) -> the sum's rows of
        this rank (backward: gather)."""
        return cc.reduce_scatter_seq(self._pad(y), self.mesh.model_group, 1)


def seq_shard(mesh: Optional[Mesh], cfg: ModelConfig,
              length: int) -> Optional[SeqShard]:
    """The SeqShard of a forward, or None: a no-op without a mesh, at tp 1
    or with ``model.seq_shard`` off."""
    if mesh is None or mesh.tp <= 1 or not cfg.seq_shard:
        return None
    return SeqShard(mesh, length)


# ---------------------------------------------------------------------------
# The batch.
# ---------------------------------------------------------------------------

def batch_stripe(arrays: Sequence, mesh: Optional[Mesh], first_index: int = 0,
                 ranks: Optional[int] = None):
    """This rank's rows of each array of a batch (counterpart of
    shard_batch_tree / make_global_batch): the batch holds the rows of
    ``ranks`` data ranks (default: all of them) from data index
    ``first_index`` on, split evenly in data-index order."""
    if mesh is None:
        return tuple(arrays)
    ranks = ranks or mesh.dp
    b = len(arrays[0])
    if b % ranks:
        raise ValueError(f"a batch of {b} rows does not split over {ranks} "
                         "data ranks")
    m = b // ranks
    i = mesh.data_index - first_index
    return tuple(a[i * m:(i + 1) * m] for a in arrays)


# ---------------------------------------------------------------------------
# The model.
# ---------------------------------------------------------------------------

def shard_model(model: torch.nn.Module, mesh: Mesh,
                cfg: ModelConfig) -> torch.nn.Module:
    """Split ``model``'s tensors over the model group by _TP_RULES (in
    place), and hand the mesh to the modules that run collectives. Each
    parameter gets ``tp_spec`` (its split, or None) and ``sp_partial``;
    ``model.tp_specs`` maps the state_dict names of the split tensors to
    their specs."""
    from conformer_tpu_torch.models.attention import RelativeMultiHeadAttention
    from conformer_tpu_torch.models.decoder import LSTMDecoder
    from conformer_tpu_torch.models.layers import (ConvolutionModule,
                                                   FeedForwardModule,
                                                   GroupNorm, MaskedBatchNorm)

    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    specs = {}
    for name, t in tensors.items():
        spec = param_spec(name, tuple(t.shape), mesh.tp, cfg.n_heads)
        if spec is not None:
            specs[name] = spec
    split_key = {FeedForwardModule: "hidden.weight",
                 RelativeMultiHeadAttention: "query.weight",
                 ConvolutionModule: "pointwise1.weight",
                 GroupNorm: "weight"}
    for name, mod in model.named_modules():
        if hasattr(mod, "mesh"):
            mod.mesh = mesh
        for cls, key in split_key.items():
            if isinstance(mod, cls):
                mod.split = f"{name}.{key}".lstrip(".") in specs
        if isinstance(mod, LSTMDecoder):
            mod.lstm_split = all(f"{name}.lstm.{i}.weight_ih" in specs
                                 for i in range(len(mod.lstm)))
            mod.classifier_split = f"{name}.classifier.weight" in specs
        if isinstance(mod, MaskedBatchNorm):
            mod.mesh = mesh
    for name, spec in specs.items():
        t = tensors[name]
        t.data = shard_tensor(t.data, spec, mesh.model_index, mesh.tp)
    sp = cfg.seq_shard and mesh.tp > 1
    for name, p in model.named_parameters():
        p.tp_spec = specs.get(name)
        p.sp_partial = sp and _sp_partial(name, specs)
    model.tp_specs = specs
    return model


def _sp_partial(name: str, specs: Dict[str, Spec]) -> bool:
    if re.match(_FINAL_NORM, name):
        return True
    if not any(re.match(p, name) for p in _SP_PARTIAL):
        return False
    # the module's own split decides: a replicated module runs on whole rows
    module = name.rsplit(".", 2)[0]
    if module.endswith("attention"):
        key = "query.weight"
    elif module.endswith("mhsa"):
        key = "attention.query.weight"
    elif module.endswith("conv"):
        key = "pointwise1.weight"
    else:
        key = "hidden.weight"
    return f"{module}.{key}" in specs


def full_state_dict(model: torch.nn.Module,
                    mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """The single-device state_dict of a sharded model (a collective over
    the model group)."""
    state = model.state_dict()
    specs = getattr(model, "tp_specs", {})
    if mesh is None or not specs:
        return state
    names = list(specs)
    full = gather_tensors([state[n] for n in names], [specs[n] for n in names],
                          mesh.model_group)
    state.update(zip(names, full))
    return state


def load_full_state_dict(model: torch.nn.Module, state: Dict[str, torch.Tensor],
                         mesh: Optional[Mesh]) -> None:
    """Load a single-device state_dict into a sharded model."""
    if mesh is not None:
        state = dict(state)
        for name, spec in getattr(model, "tp_specs", {}).items():
            state[name] = shard_tensor(state[name], spec, mesh.model_index,
                                       mesh.tp)
    model.load_state_dict(state)
