"""Import a reference (PyTorch) Conformer CTC checkpoint into this package
(counterpart of tools/import_torch_checkpoint.py, which goes to the JAX
package's flax tree; this goes straight to the port's ``state_dict``).

The reference checkpoint is ``{'model': state_dict, ...}`` or a raw state
dict, with or without DDP's ``module.`` prefix. Both sides are PyTorch, so
most of the JAX tool's layout changes cancel here:

- Conv2d subsampling: the reference convolves (B, 1, mels, T) with
  (out, in, kF, kT) kernels, the port (B, 1, T, mels) with (out, in, kT,
  kF): the two spatial axes swap;
- flatten order after the subsampling: the reference's is channel-major
  (input index c * F' + f), the port's freq-major (f * d + c): the input
  projection's columns are permuted;
- Linear (out, in): copied (the JAX tool's transpose cancels against the
  port's);
- pointwise Conv1d (out, in, 1) -> Linear (out, in);
- depthwise Conv1d (C, 1, K): copied;
- LSTM: ``weight_ih``/``weight_hh`` copied (gate order i, f, g, o on both
  sides), the two biases summed into ``bias_ih`` and ``bias_hh`` zero, as
  the JAX cell has one bias;
- BatchNorm: weight, bias and running statistics -> scale, bias, mean, var
  (``num_batches_tracked`` is dropped).

    python -m conformer_tpu_torch.tools.import_reference_checkpoint ref.pt \\
        out_ckpt_dir [--vocab-size 370] [--n-blocks 17] ...

writes a port checkpoint (step 0) and its ``config.json`` into
``out_ckpt_dir``, which ``cli.test``, ``cli.infer --checkpoint-dir`` and
``cli.train --checkpoint-dir`` (resuming) read. The file is read with
``torch.load(weights_only=True)``: tensors and plain containers only.
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch

from conformer_tpu_torch.config import Config, ModelConfig


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().to(torch.float32).clone()


def _block_state(sd: Dict[str, torch.Tensor], pfx: str, out: str
                 ) -> Dict[str, torch.Tensor]:
    """One ConformerBlock: reference prefix ``pfx`` (e.g.
    'encoder.layers.3.') -> port names under ``out``."""
    state = {}

    def pair(src: str, dst: str) -> None:
        """weight and bias, copied"""
        state[f"{out}{dst}.weight"] = sd[f"{src}.weight"]
        state[f"{out}{dst}.bias"] = sd[f"{src}.bias"]

    for i, name in ((1, "ffn1"), (2, "ffn2")):
        pair(f"{pfx}ffn_{i}.layer_norm", f"{name}.norm")
        pair(f"{pfx}ffn_{i}.hidden_linear", f"{name}.hidden")
        pair(f"{pfx}ffn_{i}.out_linear", f"{name}.out")
    pair(f"{pfx}attention.layer_norm", "mhsa.norm")
    a = f"{pfx}attention.attention."
    for proj in ("query", "key", "value", "pos", "out"):
        pair(f"{a}{proj}_proj", f"mhsa.attention.{proj}")
    for bias in ("content_bias", "position_bias"):
        state[f"{out}mhsa.attention.{bias}"] = sd[a + bias]
    c = f"{pfx}conv."
    pair(c + "layer_norm", "conv.norm")
    for i in (1, 2):
        state[f"{out}conv.pointwise{i}.weight"] = \
            sd[f"{c}pointwise_conv_{i}.weight"][:, :, 0]
        state[f"{out}conv.pointwise{i}.bias"] = sd[f"{c}pointwise_conv_{i}.bias"]
    pair(c + "deepwise_conv", "conv.depthwise")
    state[f"{out}conv.bn.scale"] = sd[c + "batch_norm.weight"]
    state[f"{out}conv.bn.bias"] = sd[c + "batch_norm.bias"]
    state[f"{out}conv.bn.mean"] = sd[c + "batch_norm.running_mean"]
    state[f"{out}conv.bn.var"] = sd[c + "batch_norm.running_var"]
    pair(f"{pfx}layer_norm", "final_norm")
    return state


def convert_state_dict(sd: Dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Reference state dict (tensors or arrays) -> the port's CTC
    ``Conformer`` state dict, fp32."""
    sd = {k: _f32(v) for k, v in sd.items()}
    d = cfg.d_model
    f_sub = ((cfg.n_mel_channels - 1) // 2 - 1) // 2
    state: Dict[str, torch.Tensor] = {}
    for i in (1, 2):
        conv = f"encoder.downsampling_conv.conv_{i}"
        state[f"encoder.subsample.conv{i}.weight"] = \
            sd[f"{conv}.weight"].permute(0, 1, 3, 2).contiguous()
        state[f"encoder.subsample.conv{i}.bias"] = sd[f"{conv}.bias"]
    w = sd["encoder.linear.weight"]                   # (d, d * F'), c * F' + f
    state["encoder.input_proj.weight"] = (
        w.reshape(w.shape[0], d, f_sub).transpose(1, 2)
        .reshape(w.shape[0], f_sub * d).contiguous())
    state["encoder.input_proj.bias"] = sd["encoder.linear.bias"]
    for i in range(cfg.n_blocks):
        state.update(_block_state(sd, f"encoder.layers.{i}.",
                                  f"encoder.blocks.{i}."))
    state["decoder.lstm.0.weight_ih"] = sd["decoder.lstm.weight_ih_l0"]
    state["decoder.lstm.0.bias_ih"] = (sd["decoder.lstm.bias_ih_l0"]
                                       + sd["decoder.lstm.bias_hh_l0"])
    state["decoder.lstm.0.weight_hh"] = sd["decoder.lstm.weight_hh_l0"]
    state["decoder.lstm.0.bias_hh"] = torch.zeros_like(
        sd["decoder.lstm.bias_hh_l0"])
    state["decoder.norm.scale"] = sd["decoder.norm.weight"]
    state["decoder.norm.bias"] = sd["decoder.norm.bias"]
    state["decoder.norm.mean"] = sd["decoder.norm.running_mean"]
    state["decoder.norm.var"] = sd["decoder.norm.running_var"]
    state["decoder.classifier.weight"] = sd["decoder.linear.weight"]
    state["decoder.classifier.bias"] = sd["decoder.linear.bias"]
    return {k: v.contiguous() for k, v in state.items()}


def strip_ddp_prefix(sd: Dict) -> Dict:
    """Drop DDP's ``module.`` prefix when every key has it."""
    if sd and all(k.startswith("module.") for k in sd):
        return {k[len("module."):]: v for k, v in sd.items()}
    return sd


def main(argv=None) -> None:
    from conformer_tpu_torch.cli.common import save_config
    from conformer_tpu_torch.models.conformer import build_model
    from conformer_tpu_torch.train.checkpoint import CheckpointManager
    from conformer_tpu_torch.train.state import make_optimizer

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("torch_ckpt",
                   help=".pt file ({'model': state_dict} or a state dict)")
    p.add_argument("out_dir")
    p.add_argument("--vocab-size", type=int, default=370)
    p.add_argument("--n-blocks", type=int, default=17)
    p.add_argument("--d-model", type=int, default=512)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--kernel-size", type=int, default=31)
    p.add_argument("--lstm-hidden", type=int, default=640)
    args = p.parse_args(argv)

    raw = torch.load(args.torch_ckpt, map_location="cpu", weights_only=True)
    sd = raw.get("model", raw) if isinstance(raw, dict) else raw
    sd = strip_ddp_prefix(dict(sd))
    cfg = Config().override(**{
        "model.vocab_size": args.vocab_size, "model.n_blocks": args.n_blocks,
        "model.d_model": args.d_model, "model.n_heads": args.n_heads,
        "model.kernel_size": args.kernel_size,
        "model.lstm_hidden_dim": args.lstm_hidden})
    model = build_model(cfg.model, cfg.optim.compute_dtype, seed=None)
    model.load_state_dict(convert_state_dict(sd, cfg.model))
    mgr = CheckpointManager(args.out_dir, keep=1)
    mgr.save(model, make_optimizer(cfg.optim, model.parameters()), step=0)
    mgr.close()
    save_config(cfg, args.out_dir)
    print(f"[import] {len(sd)} reference tensors -> {args.out_dir}")


if __name__ == "__main__":
    main()
