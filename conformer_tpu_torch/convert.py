"""Weight bridge: a flax ``{"params", "batch_stats"}`` tree of the JAX
package's CTC Conformer or Transducer (``model.arch``), or of one of its
pretraining models, <-> this package's ``state_dict``.

``tree`` names the model: "model" (the ``model.arch`` one), "wav2vec2"
(``Wav2Vec2Pretrain``: ``subsample``, ``input_proj`` and the blocks at the
top, ``quantizer/{weight_proj, codevectors}``, ``mask_embedding``,
``target_proj``, ``context_proj``), "byol" (an online ``BYOLNet``:
``encoder/...``, ``projector/{fc1, LayerNorm_0, fc2}``, ``predictor/...``)
or "byol_target" (the target tower: no ``predictor``). With
``model.conv_norm='group'`` a block's ``conv/norm`` is a GroupNorm
(``scale``, ``bias`` -> ``conv.group_norm.weight``, ``.bias``; no
``batch_stats``).

The tree is nested dicts of numpy arrays, in either block layout: the
scan-stacked ``encoder/blocks/block/...`` (a leading n_blocks axis; the JAX
default) or the unrolled ``encoder/block_i/...``. Layouts: Dense (in, out) ->
Linear (out, in); conv2d (kT, kF, in, out) -> (out, in, kT, kF); depthwise
(K, 1, C) -> (C, 1, K); LSTM ``weight_ih = input_proj.kernel.T``,
``bias_ih = input_proj.bias``, ``weight_hh = recurrent_kernel.T``,
``bias_hh = 0`` (gate order i, f, g, o on both sides). The transducer's
``OptimizedLSTMCell`` keeps one (in, H) kernel per gate: ``weight_ih`` is
the ``ii/if/ig/io`` kernels side by side, transposed, ``weight_hh`` and
``bias`` the ``hi/hf/hg/ho`` ones. The unused attention ``pos.bias`` is
carried too, so nothing is dropped.

    python -m conformer_tpu_torch.convert --npz tree.npz --out weights.pt \
        [--config cfg.json] [--set model.n_blocks=2 ...]

reads an ``.npz`` whose keys are '/'-joined tree paths
(``params/encoder/input_proj/kernel``, ...) and writes a ``torch.save``d
state dict for ``cli.infer --weights``.
"""

from __future__ import annotations

import argparse
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from conformer_tpu_torch.config import ModelConfig

# torch tensor <- flax array
_TO_TORCH = {
    "copy": lambda a: a,
    "linear": lambda a: a.T,
    "conv2d": lambda a: a.transpose(3, 2, 0, 1),
    "depthwise": lambda a: a.transpose(2, 1, 0),
}
# flax array <- torch tensor
_TO_FLAX = {
    "copy": lambda a: a,
    "linear": lambda a: a.T,
    "conv2d": lambda a: a.transpose(2, 3, 1, 0),
    "depthwise": lambda a: a.transpose(2, 1, 0),
}


GATES = "ifgo"


def _read(tree: dict, path: str) -> np.ndarray:
    """The array at ``path``; a path with ``{g}`` is the flax LSTM cell's
    four gate arrays of that name, side by side on the last axis."""
    if "{g}" in path:
        return np.concatenate([np.asarray(_get(tree, path.format(g=g)))
                               for g in GATES], axis=-1)
    return _get(tree, path)


def _write(tree: dict, path: str, value: np.ndarray) -> None:
    if "{g}" in path:
        for g, part in zip(GATES, np.split(value, len(GATES), axis=-1)):
            _set(tree, path.format(g=g), np.ascontiguousarray(part))
    else:
        _set(tree, path, value)


def _dense(flax: str, torch_name: str):
    yield ("params", f"{flax}/kernel", f"{torch_name}.weight", "linear")
    yield ("params", f"{flax}/bias", f"{torch_name}.bias", "copy")


def _norm(flax: str, torch_name: str):
    yield ("params", f"{flax}/scale", f"{torch_name}.weight", "copy")
    yield ("params", f"{flax}/bias", f"{torch_name}.bias", "copy")


def _batch_norm(flax: str, torch_name: str):
    yield ("params", f"{flax}/scale", f"{torch_name}.scale", "copy")
    yield ("params", f"{flax}/bias", f"{torch_name}.bias", "copy")
    yield ("batch_stats", f"{flax}/mean", f"{torch_name}.mean", "copy")
    yield ("batch_stats", f"{flax}/var", f"{torch_name}.var", "copy")


TREES = ("model", "wav2vec2", "byol", "byol_target")


def _block_entries(conv_norm: str = "batch"
                   ) -> Iterator[Tuple[str, str, str, str]]:
    """(collection, flax path in a block, torch name in a block, kind)."""
    for ffn in ("ffn1", "ffn2"):
        yield from _norm(f"{ffn}/LayerNorm_0", f"{ffn}.norm")
        yield from _dense(f"{ffn}/hidden", f"{ffn}.hidden")
        yield from _dense(f"{ffn}/out", f"{ffn}.out")
    yield from _norm("mhsa/LayerNorm_0", "mhsa.norm")
    for proj in ("query", "key", "value", "out", "pos"):
        yield from _dense(f"mhsa/attention/{proj}", f"mhsa.attention.{proj}")
    for bias in ("content_bias", "position_bias"):
        yield ("params", f"mhsa/attention/{bias}", f"mhsa.attention.{bias}",
               "copy")
    yield from _norm("conv/LayerNorm_0", "conv.norm")
    yield from _dense("conv/pointwise1", "conv.pointwise1")
    yield ("params", "conv/depthwise/kernel", "conv.depthwise.weight",
           "depthwise")
    yield ("params", "conv/depthwise/bias", "conv.depthwise.bias", "copy")
    if conv_norm == "group":
        yield from _norm("conv/norm", "conv.group_norm")
    else:
        yield from _batch_norm("conv/norm", "conv.bn")
    yield from _dense("conv/pointwise2", "conv.pointwise2")
    yield from _norm("final_norm", "final_norm")


def _encoder_prefix(tree: str) -> Tuple[str, str]:
    """(flax, torch) prefix of the encoder's subsample, input_proj and
    blocks in ``tree``: the wav2vec2 model holds them at its top."""
    if tree not in TREES:
        raise ValueError(f"unknown tree {tree!r}; one of {TREES}")
    return ("", "") if tree == "wav2vec2" else ("encoder/", "encoder.")


def _mlp_head(flax: str, torch_name: str):
    yield from _dense(f"{flax}/fc1", f"{torch_name}.fc1")
    yield from _norm(f"{flax}/LayerNorm_0", f"{torch_name}.norm")
    yield from _dense(f"{flax}/fc2", f"{torch_name}.fc2")


def _top_entries(cfg: ModelConfig, tree: str = "model"
                 ) -> Iterator[Tuple[str, str, str, str]]:
    fp, tp = _encoder_prefix(tree)
    convs = (("conv2_dw", "conv2_pw") if cfg.subsample_impl == "separable"
             else ("conv2",))
    for conv in ("conv1",) + convs:
        yield ("params", f"{fp}subsample/{conv}/kernel",
               f"{tp}subsample.{conv}.weight", "conv2d")
        yield ("params", f"{fp}subsample/{conv}/bias",
               f"{tp}subsample.{conv}.bias", "copy")
    yield from _dense(f"{fp}input_proj", f"{tp}input_proj")
    if tree == "wav2vec2":
        yield from _dense("quantizer/weight_proj", "quantizer.weight_proj")
        yield ("params", "quantizer/codevectors", "quantizer.codevectors",
               "copy")
        yield ("params", "mask_embedding", "mask_embedding", "copy")
        yield from _dense("target_proj", "target_proj")
        yield from _dense("context_proj", "context_proj")
        return
    if tree in ("byol", "byol_target"):
        yield from _mlp_head("projector", "projector")
        if tree == "byol":
            yield from _mlp_head("predictor", "predictor")
        return
    if cfg.arch == "transducer":
        yield ("params", "prediction/embed/embedding",
               "prediction.embedding", "copy")
        for i in range(cfg.pred_layers):
            cell = f"prediction/lstm_{i}"
            yield ("params", f"{cell}/i{{g}}/kernel",
                   f"prediction.cells.{i}.weight_ih", "linear")
            yield ("params", f"{cell}/h{{g}}/kernel",
                   f"prediction.cells.{i}.weight_hh", "linear")
            yield ("params", f"{cell}/h{{g}}/bias",
                   f"prediction.cells.{i}.bias", "copy")
        for proj in ("enc_proj", "pred_proj", "out"):
            yield from _dense(f"joint/{proj}", f"joint.{proj}")
        return
    for i in range(cfg.n_lstm_layers):
        yield ("params", f"decoder/lstm_{i}/input_proj/kernel",
               f"decoder.lstm.{i}.weight_ih", "linear")
        yield ("params", f"decoder/lstm_{i}/input_proj/bias",
               f"decoder.lstm.{i}.bias_ih", "copy")
        yield ("params", f"decoder/lstm_{i}/recurrent_kernel",
               f"decoder.lstm.{i}.weight_hh", "linear")
    yield from _batch_norm("decoder/norm", "decoder.norm")
    yield from _dense("decoder/classifier", "decoder.classifier")


def _get(tree: dict, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _set(tree: dict, path: str, value) -> None:
    *parents, leaf = path.split("/")
    for part in parents:
        tree = tree.setdefault(part, {})
    tree[leaf] = value


def is_scan_layout(variables: dict, tree: str = "model") -> bool:
    params = variables["params"]
    return "blocks" in (params if tree == "wav2vec2" else params["encoder"])


def _ctc_lstm_layers(cfg: ModelConfig, tree: str) -> int:
    """The CTC decoder's LSTM layers in ``tree``, each with a zero
    ``bias_hh``."""
    return cfg.n_lstm_layers if tree == "model" and cfg.arch == "ctc" else 0


def flax_to_state_dict(variables: dict, cfg: ModelConfig,
                       tree: str = "model") -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} (nested dicts of arrays) of ``tree`` ->
    state_dict."""
    state: Dict[str, torch.Tensor] = {}
    to_t = lambda a, kind: torch.from_numpy(
        np.array(_TO_TORCH[kind](np.asarray(a, np.float32)), order="C"))
    for coll, fpath, tname, kind in _top_entries(cfg, tree):
        state[tname] = to_t(_read(variables[coll], fpath), kind)
    scan = is_scan_layout(variables, tree)
    fp, tp = _encoder_prefix(tree)
    for coll, fpath, tname, kind in _block_entries(cfg.conv_norm):
        for i in range(cfg.n_blocks):
            if scan:
                arr = np.asarray(_get(variables[coll],
                                      f"{fp}blocks/block/{fpath}"))[i]
            else:
                arr = _get(variables[coll], f"{fp}block_{i}/{fpath}")
            state[f"{tp}blocks.{i}.{tname}"] = to_t(arr, kind)
    for i in range(_ctc_lstm_layers(cfg, tree)):
        hidden = state[f"decoder.lstm.{i}.weight_hh"].shape[1]
        state[f"decoder.lstm.{i}.bias_hh"] = torch.zeros(4 * hidden)
    return state


def block_part_to_state_dict(variables: dict, part: str,
                             conv_norm: str = "batch"
                             ) -> Dict[str, torch.Tensor]:
    """The flax tree of one module of a Conformer block, initialised on its
    own (``part`` is its path in the block: 'ffn1', 'mhsa',
    'mhsa/attention', 'conv') -> the state_dict of the port's module."""
    fprefix, tprefix = part + "/", part.replace("/", ".") + "."
    state = {}
    for coll, fpath, tname, kind in _block_entries(conv_norm):
        if fpath.startswith(fprefix):
            arr = np.asarray(_get(variables[coll], fpath[len(fprefix):]),
                             np.float32)
            state[tname[len(tprefix):]] = torch.from_numpy(
                np.array(_TO_TORCH[kind](arr), order="C"))
    return state


def state_dict_to_flax(state: Dict[str, torch.Tensor], cfg: ModelConfig,
                       scan: bool, tree: str = "model") -> dict:
    """state_dict of ``tree`` -> {"params", "batch_stats"} in the
    scan-stacked (``scan=True``) or unrolled block layout. The LSTM
    ``bias_hh`` must be zero: the JAX cell has no second bias."""
    variables: dict = {"params": {}, "batch_stats": {}}
    to_f = lambda t, kind: np.ascontiguousarray(
        _TO_FLAX[kind](t.detach().cpu().float().numpy()))
    for coll, fpath, tname, kind in _top_entries(cfg, tree):
        _write(variables[coll], fpath, to_f(state[tname], kind))
    fp, tp = _encoder_prefix(tree)
    for coll, fpath, tname, kind in _block_entries(cfg.conv_norm):
        arrs = [to_f(state[f"{tp}blocks.{i}.{tname}"], kind)
                for i in range(cfg.n_blocks)]
        if scan:
            _set(variables[coll], f"{fp}blocks/block/{fpath}",
                 np.stack(arrs))
        else:
            for i, arr in enumerate(arrs):
                _set(variables[coll], f"{fp}block_{i}/{fpath}", arr)
    for i in range(_ctc_lstm_layers(cfg, tree)):
        if torch.any(state[f"decoder.lstm.{i}.bias_hh"] != 0):
            raise ValueError(f"decoder.lstm.{i}.bias_hh is not zero: the JAX "
                             "LSTM cell has one bias only")
    return variables


def main(argv=None) -> None:
    from conformer_tpu_torch.cli.common import load_config

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--npz", required=True, help="'/'-joined tree paths")
    p.add_argument("--out", required=True, help="output state dict (.pt)")
    p.add_argument("--config", default=None)
    p.add_argument("--set", dest="overrides", action="append", default=[])
    args = p.parse_args(argv)
    cfg = load_config(args)
    variables: dict = {}
    with np.load(args.npz) as data:
        for key in data.files:
            _set(variables, key, data[key])
    torch.save(flax_to_state_dict(variables, cfg.model), args.out)
    print(f"[convert] wrote {args.out}")


if __name__ == "__main__":
    main()
