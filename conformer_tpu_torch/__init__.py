"""PyTorch/CUDA port of conformer_tpu for NVIDIA Hopper GPUs.

The JAX package ``conformer_tpu`` is the reference each module here is held
against; this package imports none of it.

Public API shortcuts, as the JAX package has them (the classes import
lazily from their modules, so importing the package builds nothing):

    from conformer_tpu_torch import Config, load_tokenizer, MelFrontend
"""

from conformer_tpu_torch.config import Config  # noqa: F401

_LAZY = {
    "MelFrontend": "conformer_tpu_torch.audio.mel",
    "Conformer": "conformer_tpu_torch.models.conformer",
    "Transducer": "conformer_tpu_torch.models.transducer",
    "InferencePipeline": "conformer_tpu_torch.decode.pipeline",
    "Trainer": "conformer_tpu_torch.train.trainer",
    "StreamingTranscriber": "conformer_tpu_torch.decode.streaming",
    "BeamSearchDecoder": "conformer_tpu_torch.decode.beam_search",
}


def load_tokenizer(name_or_path: str = "vi", **kwargs):
    from conformer_tpu_torch.text.tokenizer import load_tokenizer as _load

    return _load(name_or_path, **kwargs)


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(_LAZY[name]), name)
