"""Typed configuration tree for the whole framework.

This package's own copy of conformer_tpu/config.py, so that ``Config()``,
``Config.from_json(configs/*.json)`` and ``override`` behave the same in
both packages. Field comments that cite measurements describe the JAX
package on a TPU; knobs the port does not use yet (training, parallelism,
pretraining, decode beams) are kept so that config files load unchanged.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass
class AudioConfig:
    """Log-mel frontend parameters.

    Defaults mirror the reference operating point
    (reference: train.py:309-317, processing/processor.py:53-63).
    """

    sample_rate: int = 16000
    n_fft: int = 400
    win_length: int = 400
    hop_length: int = 160
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float = 8000.0
    mel_norm: str = "slaney"
    # Mel scale of the filterbank center points: 'slaney' (reference,
    # torchaudio default in processor.py:53-63) or 'htk'.
    mel_scale: str = "slaney"
    log_clamp_min: float = 1e-5
    # In this package: 'pallas' is the CUDA kernel K3 (ops/cuda/mel_frontend),
    # 'matmul' and 'rfft' are plain torch, 'auto' picks as described below.
    # 'rfft' uses jnp.fft.rfft; 'matmul' uses an explicit DFT-as-matmul that
    # maps onto the MXU; 'pallas' fuses frame+window+DFT+mel+log in one TPU
    # kernel (no frame-extraction gather); 'auto' (default since r5) picks
    # 'pallas' for long traced lengths (>= MelFrontend.AUTO_PALLAS_MIN_FRAMES
    # frames, where the XLA framing gather goes pathological: +4.2%
    # end-to-end at the 24s bucket) and 'matmul' otherwise (neutral at 8s).
    stft_impl: str = "auto"


@dataclass
class AugmentConfig:
    """SpecAugment. Unlike the reference (which computes but never applies it,
    reference: dataset.py:88,94), this is actually wired into training.

    Defaults follow the reference's *intended* training setting
    (reference: train.py:128-133, processing/augment.py:8-16).
    """

    enabled: bool = True
    n_time_masks: int = 2
    time_mask_param: int = 100
    n_freq_masks: int = 2
    freq_mask_param: int = 27
    prob: float = 1.0
    zero_masking: bool = True


@dataclass
class ModelConfig:
    """Conformer encoder + LSTM decoder hyperparameters.

    Defaults are the reference's production config (reference: train.py:324-330);
    the reference class defaults (16 blocks / d=256 / 4 heads,
    reference: model/conformer.py:12-19) are available as `ModelConfig.small()`.
    """

    # Model family: 'ctc' (Conformer encoder + LSTM decoder + CTC loss,
    # the reference's architecture) or 'transducer' (same encoder + RNN-T
    # prediction/joint nets + RNN-T loss — a WORKING version of the
    # reference's dead stub; models/transducer.py).
    arch: str = "ctc"
    vocab_size: int = 370
    n_mel_channels: int = 80
    n_blocks: int = 17
    d_model: int = 512
    n_heads: int = 8
    kernel_size: int = 31
    ffn_expansion: int = 4
    lstm_hidden_dim: int = 640
    n_lstm_layers: int = 1
    dropout_rate: float = 0.1
    # TPU-specific knobs (no reference counterpart):
    use_remat: bool = True           # jax.checkpoint each block: trade FLOPs for HBM
    use_scan_layers: bool = True     # lax.scan over blocks: O(1) compile in depth
    # Unroll factor for the block scan (forwarded to lax.scan). Full unroll
    # (use_scan_layers=False) lets XLA schedule across all block boundaries
    # (+25% at 8s) but compile time blows up at long L (24s bucket exceeds
    # the remote-compile budget); scan_unroll=k recovers cross-block
    # scheduling within k-block chunks at bounded compile time, with the
    # SAME stacked param layout as scan_unroll=1 (checkpoint-compatible).
    scan_unroll: int = 1
    # Sequence parallelism (Megatron-SP style, no reference counterpart):
    # pin encoder block activations to P('data', 'model', None) so the
    # norm/FFN/dropout chains between matmuls run TIME-SHARDED over the
    # tensor-parallel axis (activation memory and elementwise work / tp).
    # GSPMD inserts the gathers attention/conv need. No-op without an
    # active ('data','model') mesh with tp > 1 (parallel/mesh.py).
    seq_shard: bool = False
    conv_norm: str = "batch"         # 'batch' (reference semantics) or 'group'
    # Depthwise conv backend: 'xla' or 'pallas'. In this package 'xla' is
    # F.conv1d(groups=C) and 'pallas' raises until kernel K4 is ported.
    conv_impl: str = "xla"
    # Zero padded frames before the depthwise conv. False reproduces the
    # reference exactly (it convolves pad garbage into boundary frames,
    # reference: model/utils/convolution.py:15 with no masking).
    conv_mask_pad: bool = True
    decoder_norm_masked: bool = True # mask-aware BatchNorm stats in the decoder
    # In this package: 'pallas' is the CUDA kernel K1
    # (ops/cuda/sincos_attention, forward only) and 'xla' the dense torch path.
    # 'pallas' (default): fused shift-free sin/cos kernel — fused fwd+bwd,
    # in-kernel dropout, scores never touch HBM; 2-10x vs the dense path on
    # TPU. Falls back to identical-math XLA off-TPU; under an active mesh
    # the call is shard_mapped over the data/model axes
    # (ops/pallas/sincos_attention.rel_attention_sincos_sharded).
    # 'xla': dense (B,H,L,L) scores + rel-shift. (The round-1 'pallas_bias'
    # bias-fused kernel measured neutral and was deleted round 3 per
    # win-or-delete — docs/PERFORMANCE.md negative results.)
    attention_impl: str = "pallas"
    # Attention score tensor IO dtype. bfloat16 halves the dominant HBM
    # traffic at (B,H,L,L); softmax still reduces in float32.
    attention_score_dtype: str = "float32"
    # Dropout mask generation. 'hash' (default): stateless murmur-style
    # hash of element coordinates, pure elementwise ops that fuse into the
    # surrounding chain (models/dropout.py) — the same construction the
    # fused attention kernel uses in-kernel, applied at the XLA level
    # (+4.4% train throughput: no mask buffer ever round-trips HBM).
    # 'prng': jax PRNG (rbg/threefry) masks via flax nn.Dropout — the bit
    # buffer cannot fuse into its consumer (~4 ms/step across ~100 sites,
    # tools/trace_step.py). Not bit-compatible with each other; neither
    # matches the reference's torch PRNG (dropout only affects training
    # randomness, never inference numerics). A third variant — the TPU
    # hardware PRNG inside the fused attention kernel — measured NEUTRAL
    # (3964 vs 3977 audio-s/s) and was deleted per win-or-delete
    # (docs/PERFORMANCE.md negative results).
    dropout_impl: str = "hash"
    # Subsampling stack. 'conv2d' = two dense 3x3 stride-2 convs (reference
    # semantics, model/utils/convolution.py:34-57); the second conv
    # (d_model->d_model 3x3) alone is ~12% of the measured train step at
    # near-peak MFU — architecturally expensive. 'separable' replaces it
    # with depthwise 3x3 + pointwise 1x1 (~9x fewer FLOPs; the reference's
    # own aspirational-but-never-wired DepthWiseSeperableConvolution,
    # convolution.py:59-70). NOT checkpoint-compatible with the reference;
    # use for from-scratch training.
    subsample_impl: str = "conv2d"
    # Transducer (RNN-T) head (models/transducer.py) — a WORKING
    # implementation of what the reference ships as a dead stub
    # (model/modules/transducer.py:4-9). Shares the Conformer encoder.
    pred_embed_dim: int = 320
    pred_hidden_dim: int = 320
    pred_layers: int = 1
    joint_dim: int = 320
    # 'scan' (default): lattice-free loss from the additive joint factors —
    # the (B,T,U+1,V) logit lattice never materializes (ops/rnnt.py::
    # rnnt_loss_scan), required at production batch/length. 'lattice':
    # materialize the full joint lattice (simple reference path, identical
    # numerics; fine at toy scale).
    rnnt_loss_impl: str = "scan"

    @staticmethod
    def small(vocab_size: int = 370) -> "ModelConfig":
        return ModelConfig(vocab_size=vocab_size, n_blocks=16, d_model=256, n_heads=4)

    @staticmethod
    def tiny(vocab_size: int = 64) -> "ModelConfig":
        """For tests: 2 blocks, d=64."""
        return ModelConfig(
            vocab_size=vocab_size, n_blocks=2, d_model=64, n_heads=2,
            kernel_size=7, lstm_hidden_dim=80, dropout_rate=0.0,
            use_remat=False, use_scan_layers=False,
        )


@dataclass
class OptimConfig:
    """Adam + exponential decay (reference: train.py:188-189,251 steps the
    gamma=0.9999 scheduler per *epoch*; we decay per step with a configurable
    interval so behaviour is reproducible without knowing epoch length)."""

    learning_rate: float = 2e-5
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    lr_decay_gamma: float = 0.9999
    lr_decay_every_steps: int = 0    # 0 = decay per epoch (reference semantics)
    warmup_steps: int = 0
    grad_clip_norm: float = 0.0      # 0 disables
    # Gradient accumulation: split each batch into N micro-batches and
    # average gradients before one optimizer step (large effective batches
    # on small slices). 1 disables. New capability (no reference counterpart).
    accum_steps: int = 1
    # 'bfloat16' compute with fp32 params/loss is the TPU-native analogue of the
    # reference's fp16 AMP + fp32 CTC island (reference: train.py:232-243).
    compute_dtype: str = "bfloat16"


@dataclass
class DataConfig:
    train_manifest: Optional[str] = None
    val_manifest: Optional[str] = None
    batch_size: int = 16
    # Audio-loading worker threads inside BucketedLoader (host-side file IO
    # + resampling overlap with device steps). <=1 means synchronous loading.
    num_workers: int = 2
    num_examples: Optional[int] = None
    # Static-shape length bucketing (TPU necessity; reference pads per-batch to
    # the max which would retrigger XLA compilation every step).
    bucket_boundaries_s: Tuple[float, ...] = (2.0, 4.0, 8.0, 12.0, 16.0, 24.0)
    # Optional per-bucket train batch sizes (1:1 with bucket_boundaries_s;
    # the last entry repeats for the implicit max_audio_s bucket). Long
    # buckets peak at smaller batches on a fixed HBM budget — measured 8s
    # peak b56 vs 24s peak b32 (docs/PERFORMANCE.md). Empty = use
    # batch_size for every bucket.
    bucket_batch_sizes: Tuple[int, ...] = ()
    max_audio_s: float = 24.0
    max_tokens: int = 256
    # Training only: the last partial batch per bucket is dropped when True.
    # Evaluation loaders ALWAYS keep remainders (padded with dummy rows that
    # are excluded from metrics and loss) so no utterance is silently skipped.
    drop_remainder: bool = True
    # Training-time handling of audio longer than the largest bucket:
    # 'skip' drops the utterance (clipping audio while keeping the full
    # transcript would manufacture impossible CTC alignments whose loss
    # zero_infinity then silently zeroes); 'clip' truncates the audio anyway.
    # Evaluation always clips audio and keeps the full reference transcript.
    long_audio: str = "skip"
    seed: int = 0


@dataclass
class DecodeConfig:
    """Beam search + n-gram LM shallow fusion operating point
    (reference: processing/lm.py:10-15)."""

    lm_path: Optional[str] = None
    # Token-level ARPA for ON-DEVICE beam-search LM fusion (decode mode
    # 'beam_device'; build with `cli.create_lm --token-level`). The fusion
    # weight is `alpha`; `beta` applies per emitted word delimiter.
    device_lm_path: Optional[str] = None
    alpha: float = 2.1
    beta: float = 9.2
    beam_width: int = 190
    beam_prune_logp: float = -20.0
    hotwords: Tuple[str, ...] = ()
    hotword_weight: float = 9.0
    token_min_logp: float = -5.0
    # Device beam search only: non-blank extension fan-out per beam per
    # frame (the static-shape analogue of the host's token_min_logp
    # candidate floor; raise toward vocab_size-1 for an exhaustive search).
    device_top_k: int = 8
    # Frame-scan unroll factor for the device beam searches (CTC and
    # RNN-T). >1 amortizes per-op overhead of the small-op frame body at
    # the cost of (much) longer compiles; keep 1 unless decode latency is
    # critical and the compile is cached.
    device_scan_unroll: int = 1
    # RNN-T decode (model.arch='transducer'): per-frame emission cap for
    # greedy/beam, expansion fan-out per hypothesis, and whether beam
    # ranking divides scores by emitted length (ops/rnnt.py).
    rnnt_max_symbols: int = 4
    rnnt_top_k: int = 8
    rnnt_length_norm: bool = False


@dataclass
class ParallelConfig:
    """Device-mesh layout. dp * tp must equal the number of participating chips.

    The reference only supports single-node data parallelism (SURVEY §2.10);
    tensor parallelism over the 'model' mesh axis is a new capability.
    """

    dp: int = 1           # data-parallel mesh axis size ('data')
    tp: int = 1           # tensor-parallel mesh axis size ('model')
    # ZeRO-1: shard Adam moments over the data axis (resident optimizer
    # memory / dp, identical numerics; parallel/mesh.py
    # make_opt_state_shardings). Params/grads stay DP-replicated.
    zero: bool = False
    data_axis: str = "data"
    model_axis: str = "model"


@dataclass
class PretrainConfig:
    """Self-supervised pretraining (wav2vec2-style contrastive or BYOL).

    The reference's wav2vec2 model is unrunnable and has no loss or entry
    point (reference: model/wav2vec2.py:9,21 — imports a nonexistent
    ``generate_mask`` and passes a wrong kwarg; SURVEY §2.6); BYOL exists only
    as a README diagram. This config drives working implementations of both.
    Quantizer defaults follow the reference quantizer semantics
    (reference: model/modules/quantization.py:7-27: 2 groups x 320 codes,
    Gumbel tau=2).
    """

    method: str = "wav2vec2"        # 'wav2vec2' | 'byol'
    proj_dim: int = 256
    # quantizer (wav2vec2)
    num_groups: int = 2
    num_vars: int = 320
    gumbel_temperature: float = 2.0
    min_temperature: float = 0.5
    temperature_decay: float = 0.999995
    # masking
    mask_prob: float = 0.065
    mask_span: int = 10
    # contrastive loss
    num_negatives: int = 100
    # 'all' (default since r5): full-softmax InfoNCE over every in-utterance
    # candidate (same-quantized-target candidates masked), w2v-BERT-style —
    # gather-free (+32% measured throughput: the sampled path's
    # (B,T,K)-from-(B,T,T) gathers + backward scatter were ~21% of the
    # step, tools/trace_step.py --mode pretrain). Promoted on downstream
    # evidence: a 3-seed toy-scale pretrain->transfer->CTC-fine-tune A/B
    # (tools/ab_infonce.py; docs/PERFORMANCE.md "InfoNCE negatives A/B")
    # found the two objectives indistinguishable (seed variance dominates).
    # 'sampled': K per-anchor uniform in-utterance negatives — the exact
    # fairseq-wav2vec2 paper objective, kept for fidelity.
    negatives_impl: str = "all"
    contrastive_temperature: float = 0.1
    diversity_weight: float = 0.1
    # byol
    ema_decay: float = 0.996
    predictor_hidden: int = 1024


@dataclass
class TrainConfig:
    num_epochs: int = 1
    num_steps: Optional[int] = None
    checkpoint_dir: str = "./checkpoints"
    checkpoint_every_steps: int = 1000
    keep_checkpoints: int = 3
    log_every_steps: int = 50
    # Mid-epoch validation every N steps (0 = validate per epoch only).
    val_every_steps: int = 0
    seed: int = 0
    # Default tokenizer spec (name or JSON path) when the CLI --tokenizer
    # flag is not given; lets one Config JSON fully describe a run.
    tokenizer_path: Optional[str] = None
    resume: bool = True
    # Early stopping on the validation metric (0 disables). A working version
    # of the reference's unused EarlyStopping (reference: manager.py:51-77).
    early_stop_patience: int = 0
    early_stop_metric: str = "loss"    # 'loss' or 'wer' (both minimized)
    # Write a torch.profiler trace, with the spans of utils/spans.py, for
    # steps [profile_start, profile_start+count) into
    # <checkpoint_dir>/profile/trace.json (0 count disables).
    profile_start_step: int = 10
    profile_num_steps: int = 0
    # PRNG implementation for dropout/augment keys. 'rbg' (TPU hardware RNG)
    # is ~25% faster end-to-end than 'threefry2x32' at production scale.
    prng_impl: str = "rbg"
    # Initialize the encoder from a self-supervised pretrain checkpoint
    # directory (cli/pretrain.py output) before supervised training — the
    # transfer step of the semi-supervised pipeline the reference only
    # sketched (reference: semi/create_label.py:7 + README BYOL diagram).
    # Ignored when resuming from an existing supervised checkpoint.
    # init_encoder_method must match the checkpoint's objective.
    init_encoder_from: str = ""
    init_encoder_method: str = "wav2vec2"   # 'wav2vec2' | 'byol'
    # AOT-compile the train step for every bucket shape into the persistent
    # compilation cache before training: 'off', 'sync' (block before the
    # first epoch), or 'background' (compile on a thread while the first
    # buckets train). One compiled program exists per bucket; without warmup
    # each bucket's first batch stalls the step loop on a cold compile.
    warmup_compile: str = "off"


@dataclass
class Config:
    audio: AudioConfig = field(default_factory=AudioConfig)
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    pretrain: PretrainConfig = field(default_factory=PretrainConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    # ---- (de)serialization -------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        def build(dc_type, values):
            if not dataclasses.is_dataclass(dc_type):
                return values
            kwargs = {}
            fields = {f.name: f for f in dataclasses.fields(dc_type)}
            for k, v in values.items():
                if k not in fields:
                    raise KeyError(f"Unknown config key: {dc_type.__name__}.{k}")
                ft = fields[k].type
                sub = _DATACLASS_BY_NAME.get(str(ft))
                if sub is not None and isinstance(v, dict):
                    kwargs[k] = build(sub, v)
                elif isinstance(v, list):
                    kwargs[k] = tuple(v)
                else:
                    kwargs[k] = v
            return dc_type(**kwargs)

        return build(cls, d)

    @classmethod
    def from_json(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def override(self, **dotted: Any) -> "Config":
        """Apply dotted-path overrides, e.g. override(**{"model.d_model": 256}).

        Values are shape-checked against the field being replaced: a scalar
        can never replace a tuple field and vice versa (a CLI ``--set
        data.bucket_boundaries_s=1.2,2.0`` would otherwise assign the raw
        STRING — --set values are JSON, so tuples are written ``[1.2,2.0]``
        — and fail much later inside the data loader)."""
        d = self.to_dict()
        for key, value in dotted.items():
            parts = key.split(".")
            node = d
            for p in parts[:-1]:
                node = node[p]
            if parts[-1] not in node:
                raise KeyError(f"Unknown config key: {key}")
            old = node[parts[-1]]
            old_is_seq = isinstance(old, (tuple, list))
            new_is_seq = isinstance(value, (tuple, list))
            if old_is_seq and not new_is_seq and old is not None \
                    and value is not None:
                raise TypeError(
                    f"{key} expects a sequence (e.g. JSON [..] in --set), "
                    f"got {value!r}")
            if new_is_seq and not old_is_seq and old is not None:
                raise TypeError(f"{key} expects a scalar, got {value!r}")
            node[parts[-1]] = value
        return Config.from_dict(d)


_DATACLASS_BY_NAME = {
    str(t): t
    for t in (AudioConfig, AugmentConfig, ModelConfig, OptimConfig, DataConfig,
              DecodeConfig, ParallelConfig, PretrainConfig, TrainConfig)
}
_DATACLASS_BY_NAME.update({t.__name__: t for t in list(_DATACLASS_BY_NAME.values())})
