"""The port's surface is the JAX package's: every CLI flag, every public
module-level name and every public method of a class both define, unless
the exceptions below say what stands in its place or why it is absent; and
the package's API shortcuts. Static (the parsers are caught before they
parse, the names are read with ast), so it runs in seconds."""

import argparse
import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "conformer_tpu"
PORT = ROOT / "conformer_tpu_torch"

CLIS = ("create_lm", "export", "infer", "pretrain", "pseudo_label", "serve",
        "test", "train")
# flags the port adds: its weights as a state dict, and the torch device
PORT_ONLY_FLAGS = {"--weights", "--device"}

# "module:name" or "module:Class.method" of the JAX package -> what the port
# has instead, or why it has nothing.
EXCEPTIONS = {
    "audio/native.py:available":
        "the port's native library builds at first use or raises; there "
        "is no unavailable state to ask about",
    "ops/beam_search_device.py:ctc_beam_search_device_jit":
        "a jax.jit wrapper; the port calls ctc_beam_search_device, through "
        "a CUDA graph a frame step on the card (ops/frame_graph.py)",
    "ops/ctc.py:greedy_decode_jit":
        "a jax.jit wrapper; the port calls greedy_decode",
    "ops/ctc.py:ctc_per_seq":
        "the JAX loss's scan over paddings; the port's ctc_loss takes "
        "torch.nn.functional.ctc_loss(reduction='none') per sequence",
    "ops/rel_shift.py:rel_attention_xla":
        "the dense XLA attention; the port's is RelativeMultiHeadAttention "
        "with impl 'xla' (models/attention.py), and the kernels' plain "
        "versions are in ops/cuda/sincos_attention.py",
    "parallel/mesh.py:batch_sharding":
        "a GSPMD sharding; the port slices each rank's stripe "
        "(batch_stripe)",
    "parallel/mesh.py:make_global_batch":
        "a GSPMD global array; each rank loads the global batch and keeps "
        "its stripe (batch_stripe, loader_layout)",
    "parallel/mesh.py:make_opt_state_shardings":
        "GSPMD shardings of the optimizer state; the port's Optimizer "
        "slices its moments itself (ZeRO-1, train/state.py)",
    "parallel/mesh.py:make_param_shardings":
        "GSPMD shardings of the parameters; the port splits them with "
        "shard_model",
    "parallel/mesh.py:replicated":
        "a GSPMD sharding; a tensor not split is whole on every rank",
    "parallel/mesh.py:seq_shard_constraint":
        "a GSPMD constraint; the port's sequence parallelism splits and "
        "gathers explicitly (parallel/collectives.py)",
    "parallel/mesh.py:shard_batch_tree":
        "GSPMD placement of a batch; the port's is batch_stripe",
    "train/state.py:TrainState":
        "a flax pytree of the parameters and optimizer state; the port "
        "keeps the nn.Module and its Optimizer",
    "train/pretrain.py:BYOLState":
        "a flax pytree; the port's BYOLPretrain module holds both towers",
    "train/pretrain.py:init_byol_state":
        "flax initialisation; the port builds with build_pretrain_model",
    "train/pretrain.py:init_wav2vec2_state":
        "flax initialisation; the port builds with build_pretrain_model",
    "train/steps.py:build_models":
        "flax's train and eval twins of one model; a torch module switches "
        "with train() and eval()",
    "train/steps.py:init_variables":
        "flax initialisation; the port's is build_model",
    "train/steps.py:make_transducer_train_step":
        "the port's make_train_step takes both archs (by model.arch)",
    "train/trainer.py:Trainer.warmup_compile":
        "ahead-of-time compilation; the port compiles nothing ahead and "
        "refuses train.warmup_compile other than 'off'",
    "train/trainer.py:Trainer.wait_warmup":
        "waits for warmup_compile, which the port refuses",
    "models/quantizer.py:GumbelQuantizer.setup": "flax's setup; __init__",
    "models/transducer.py:JointNetwork.setup": "flax's setup; __init__",
    "models/transducer.py:PredictionNetwork.setup": "flax's setup; __init__",
    "models/transducer.py:Transducer.setup": "flax's setup; __init__",
    "models/transducer.py:PredictionNetwork.step":
        "the port's PredictionNetwork.predict_step",
}


class _Caught(Exception):
    def __init__(self, parser):
        self.parser = parser


def _options(module: str, monkeypatch) -> set:
    """The option strings of the parser ``module``'s main builds (caught at
    parse_args: main goes no further)."""
    def caught(self, *args, **kwargs):
        raise _Caught(self)

    main = importlib.import_module(module).main
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", caught)
        with pytest.raises(_Caught) as info:
            main([])
    return set(info.value.parser._option_string_actions)


@pytest.mark.parametrize("cli", CLIS)
def test_every_jax_cli_flag_is_a_port_flag(cli, monkeypatch):
    jax_flags = _options(f"conformer_tpu.cli.{cli}", monkeypatch)
    port_flags = _options(f"conformer_tpu_torch.cli.{cli}", monkeypatch)
    assert sorted(jax_flags - port_flags) == []
    assert sorted(port_flags - jax_flags - PORT_ONLY_FLAGS) == []


def _public(path: Path, imported: bool = False):
    """-> (module-level public names, {public class: its public methods});
    with ``imported``, the names the module imports count too (they are
    attributes of the module all the same)."""
    tree = ast.parse(path.read_text(encoding="utf8"))
    names, classes = set(), {}
    for node in tree.body:
        if imported and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                classes[node.name] = {
                    n.name for n in node.body
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not n.name.startswith("_")}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            names.update(n.id for t in targets for n in ast.walk(t)
                         if isinstance(n, ast.Name)
                         and not n.id.startswith("_"))
    return names, classes


def _missing(rel: str) -> set:
    """The JAX module's public names and methods absent from the port's
    module at the same path, as EXCEPTIONS keys."""
    names, classes = _public(JAX_PKG / rel)
    port = PORT / rel
    if not port.exists():
        return {f"{rel}:"}
    port_names, port_classes = _public(port, imported=True)
    out = {f"{rel}:{n}" for n in names - port_names}
    for cls in set(classes) & set(port_classes):
        out |= {f"{rel}:{cls}.{m}" for m in classes[cls] - port_classes[cls]}
    return out


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py")
                     if "pallas" not in p.relative_to(JAX_PKG).parts)


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_of_the_jax_module_is_in_the_port(rel):
    assert sorted(_missing(rel) - set(EXCEPTIONS)) == []


def test_every_exception_is_still_absent_from_the_port():
    """An exception names a JAX name the port lacks: one the port gains, or
    the JAX package loses, leaves the list."""
    missing = set().union(*(_missing(rel) for rel in JAX_MODULES))
    assert sorted(set(EXCEPTIONS) - missing) == []


def test_the_api_shortcuts_are_the_ports():
    import conformer_tpu_torch as pkg
    from conformer_tpu_torch import (BeamSearchDecoder, Config, Conformer,
                                     InferencePipeline, MelFrontend,
                                     StreamingTranscriber, Trainer,
                                     Transducer, load_tokenizer)
    from conformer_tpu_torch.audio import mel
    from conformer_tpu_torch.config import AudioConfig
    from conformer_tpu_torch.decode import beam_search, pipeline, streaming
    from conformer_tpu_torch.models import conformer, transducer
    from conformer_tpu_torch.text.tokenizer import GraphemeTokenizer
    from conformer_tpu_torch.train import trainer
    import conformer_tpu_torch.config as config

    assert (Config, MelFrontend, Conformer, Transducer, InferencePipeline,
            Trainer, StreamingTranscriber, BeamSearchDecoder) == (
        config.Config, mel.MelFrontend, conformer.Conformer,
        transducer.Transducer, pipeline.InferencePipeline, trainer.Trainer,
        streaming.StreamingTranscriber, beam_search.BeamSearchDecoder)
    tok = load_tokenizer("vi")
    assert isinstance(tok, GraphemeTokenizer) and tok.vocab_size == 370
    with pytest.raises(AttributeError):
        pkg.NotAName
    fe = mel.default_frontend(device="cpu", n_mels=40)
    assert isinstance(fe, MelFrontend) and fe.device.type == "cpu"
    assert fe.cfg == AudioConfig(n_mels=40)
    assert mel.default_frontend(device="cpu", n_mels=40) is fe
