"""The port's measuring tools (``conformer_tpu_torch/tools/``) on the CPU.

- ``trace_step``: the classifier puts each kernel name of the port (both
  attention namespaces, K3, K4a/K4b, K5's ``(anonymous
  namespace)::elementwise_kernel``) and of PyTorch, cuBLAS and cuDNN in its
  group, and K5 is never PyTorch's elementwise; the report of a Chrome
  trace written here (overlapping kernels on two streams, copies, a CUDA
  graph's kernels) is exact; every mode runs at ``ModelConfig.tiny`` on
  the CPU and launches no kernel there;
- ``profile_step`` at tiny, B 2 x 1 s, prints every component, and its
  chain's CTC loss equals the JAX package's chain (MelFrontend -> encoder
  -> decoder -> ``ctc_loss``, the flax weights carried by ``convert.py``)
  within 1e-5;
- ``sweep_streaming`` at tiny over 4 s (chunk 1 s, context 2 s): the
  streamed and offline texts equal the JAX ``StreamingTranscriber``'s and
  offline greedy decode's on the same weights;
- ``bench_audio_io`` small: every rate above 0, and the native and Python
  FLAC decoders give the same array;
- the GPU tools refuse to run without a GPU unless given ``--device cpu``.
"""

import functools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_tpu.audio.mel import MelFrontend as JMelFrontend
from conformer_tpu.config import Config as JConfig
from conformer_tpu.config import ModelConfig as JModelConfig
from conformer_tpu.decode.streaming import \
    StreamingTranscriber as JStreamingTranscriber
from conformer_tpu.models.decoder import LSTMDecoder as JLSTMDecoder
from conformer_tpu.models.encoder import ConformerEncoder as JConformerEncoder
from conformer_tpu.ops.ctc import ctc_loss as j_ctc_loss
from conformer_tpu.ops.ctc import greedy_decode as j_greedy_decode
from conformer_tpu.text.tokenizer import load_tokenizer as j_load_tokenizer
from conformer_tpu.train.steps import init_variables
from conformer_tpu.train.steps import make_forward as j_make_forward
from conformer_tpu.utils.masking import subsampled_length as j_subsampled
from conformer_tpu_torch.config import Config
from conformer_tpu_torch.convert import flax_to_state_dict
from conformer_tpu_torch.data.dataset import synthetic_batch
from conformer_tpu_torch.models.conformer import Conformer
from conformer_tpu_torch.text.tokenizer import load_tokenizer
from conformer_tpu_torch.tools import (bench_audio_io, profile_step,
                                       sweep_streaming, trace_step)
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
VOCAB = 370
SR = 16000
# profile_step's batch: B 2 x 1 s, transcripts of at most 8 tokens (1 s is
# 24 frames after subsampling: every row stays feasible)
PROFILE_B, PROFILE_S, PROFILE_TOKENS = 2, 1.0, 8
# sweep_streaming's: 4 s of noise, chunk 1 s, context 2 s
SWEEP_S, CHUNK_S, CONTEXT_S, BLOCK_MS = 4.0, 1.0, 2.0, 100.0

_ANON = "void (anonymous namespace)::"
_HOPPER_ARGS = ("((anonymous namespace)::hopper::Maps, __nv_bfloat16 const*, "
                "__nv_bfloat16 const*, int const*, __nv_bfloat16*, float*, "
                "float*, int, int, int, float, unsigned int, int)")
# (demangled name, group): every kernel of the port in both attention
# namespaces, and PyTorch's, cuBLAS's and cuDNN's look-alikes
NAMES = [
    (_ANON + "hopper::fwd_kernel<false>" + _HOPPER_ARGS, "K1"),
    (_ANON + "hopper::fwd_kernel<true>" + _HOPPER_ARGS, "K1-drop"),
    (_ANON + "general::fwd_kernel<__nv_bfloat16, 64, false>((anonymous "
     "namespace)::general::Params)", "K1 general"),
    (_ANON + "general::fwd_kernel<float, 64, true>((anonymous namespace)::"
     "general::Params)", "K1 general"),
    (_ANON + "hopper::q_pass<true>((anonymous namespace)::hopper::QMaps, "
     "(anonymous namespace)::hopper::BwdArgs, __nv_bfloat16*, "
     "__nv_bfloat16*, int)", "K2"),
    (_ANON + "hopper::k_pass((anonymous namespace)::hopper::KMaps, "
     "(anonymous namespace)::hopper::BwdArgs)", "K2"),
    (_ANON + "hopper::da_pass((anonymous namespace)::hopper::AMaps, "
     "(anonymous namespace)::hopper::BwdArgs, __nv_bfloat16*)", "K2"),
    (_ANON + "hopper::dwh_pass((anonymous namespace)::hopper::WMaps, "
     "(anonymous namespace)::hopper::BwdArgs)", "K2"),
    (_ANON + "general::q_pass<float, 64, false>((anonymous namespace)::"
     "general::QParams)", "K2 general"),
    (_ANON + "general::k_pass<__nv_bfloat16, 32>((anonymous namespace)::"
     "general::KParams)", "K2 general"),
    (_ANON + "general::da_pass<__nv_bfloat16, 32, 8>((anonymous namespace)"
     "::general::AParams)", "K2 general"),
    (_ANON + "general::dwh_partial<float, 64>((anonymous namespace)::"
     "general::WParams)", "K2 general"),
    (_ANON + "general::dwh_reduce<__nv_bfloat16>(float const*, "
     "__nv_bfloat16*, unsigned long, int)", "K2 general"),
    (_ANON + "logmel_kernel<(anonymous namespace)::Tiling<4>, 2>(float "
     "const*, int, float4 const*, float4 const*, float*, int, int, int)",
     "K3"),
    (_ANON + "dwconv_fwd_kernel<__nv_bfloat16>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, int, int, "
     "int, int)", "K4a"),
    (_ANON + "dwconv_window_kernel<__nv_bfloat16, 31>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, int, int, "
     "int)", "K4a"),
    (_ANON + "dwconv_dw_partial_kernel<float>(float const*, float const*, "
     "double*, int, int, int, int)", "K4b"),
    (_ANON + "dwconv_dw_reduce_kernel(double const*, float*, int, int)",
     "K4b"),
    (_ANON + "dwconv_dw_window_kernel<__nv_bfloat16, 31>((anonymous "
     "namespace)::DwMaps, float*, int, int, int, int)", "K4b"),
    (_ANON + "elementwise_kernel<((anonymous namespace)::Op)0>(float "
     "const*, float*, int, int, int)", "K5"),
    (_ANON + "row_kernel<((anonymous namespace)::Op)3>(float const*, "
     "float*, int, int, int)", "K5"),
    ("void at::native::elementwise_kernel<128, 2, at::native::"
     "gpu_kernel_impl_nocast<at::native::BinaryFunctor<float, float, float, "
     "at::native::binary_internal::MulFunctor<float> > >(at::"
     "TensorIteratorBase&, at::native::BinaryFunctor<float, float, float, "
     "at::native::binary_internal::MulFunctor<float> > const&)::{lambda(int)"
     "#1}>(int, at::native::gpu_kernel_impl_nocast<at::native::"
     "BinaryFunctor<float, float, float, at::native::binary_internal::"
     "MulFunctor<float> > >(at::TensorIteratorBase&, at::native::"
     "BinaryFunctor<float, float, float, at::native::binary_internal::"
     "MulFunctor<float> > const&)::{lambda(int)#1})", "elementwise"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, at::native::"
     "CUDAFunctor_add<float>, std::array<char*, 3ul>)", "elementwise"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "(anonymous namespace)::elementwise_kernel_with_index<long>, std::array"
     "<char*, 1ul> >(int, long, std::array<char*, 1ul>)", "elementwise"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_"
     "warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cublas",
     "GEMM (cuBLAS, CUTLASS)"),
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_"
     "16x16_128x2_tn_align8>(cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_"
     "16x16_128x2_tn_align8::Params)", "GEMM (cuBLAS, CUTLASS)"),
    ("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_TNN", "GEMM (cuBLAS, CUTLASS)"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize128x128x64_warpgroupsize1x1x1_g1_execute_kernel__5x_cudnn",
     "conv (cuDNN, ATen)"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, "
     "__nv_bfloat16, float, false, true, (cudnnKernelDataType_t)0>"
     "(cudnn::engines_precompiled::nchw2nhwc_params_t<float>, __nv_bfloat16 "
     "const*, __nv_bfloat16*)", "conv (cuDNN, ATen)"),
    ("Memcpy HtoD (Pageable -> Device)", "memcpy/memset"),
    ("Memcpy DtoD (Device -> Device)", "memcpy/memset"),
    ("Memset (Device)", "memcpy/memset"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::func_wrapper_t<float, at::native::sum_functor<float, "
     "float, float>::operator()(at::TensorIterator&)::{lambda(float, float)"
     "#1}>, unsigned int, float, 4, 4> >(at::native::ReduceOp<float, at::"
     "native::func_wrapper_t<float, at::native::sum_functor<float, float, "
     "float>::operator()(at::TensorIterator&)::{lambda(float, float)#1}>, "
     "unsigned int, float, 4, 4>)", "reduce/norm"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel"
     "<float, float>(int, float, float const*, float const*, float const*, "
     "float*, float*, float*)", "reduce/norm"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::"
     "native::(anonymous namespace)::OpaqueType<4u>, unsigned int, 3, 64, "
     "64>(at::native::(anonymous namespace)::OpaqueType<4u>*, at::native::"
     "(anonymous namespace)::CatArrInputTensorMetadata<at::native::"
     "(anonymous namespace)::OpaqueType<4u>, unsigned int, 64, 64>, at::"
     "native::(anonymous namespace)::TensorSizeStride<unsigned int, 4u>, "
     "int, unsigned int)", "copy/transpose/cat"),
    ("void at::native::index_elementwise_kernel<128, 4, at::native::"
     "gpu_index_kernel<at::native::index_kernel_impl<at::native::"
     "OpaqueType<4> >(at::TensorIteratorBase&, c10::ArrayRef<long>, c10::"
     "ArrayRef<long>)::{lambda(char*, char const*, long)#1}>(at::"
     "TensorIteratorBase&, c10::ArrayRef<long>, c10::ArrayRef<long>, at::"
     "native::index_kernel_impl<at::native::OpaqueType<4> >(at::"
     "TensorIteratorBase&, c10::ArrayRef<long>, c10::ArrayRef<long>)::"
     "{lambda(char*, char const*, long)#1} const&)::{lambda(int)#1}>(long, "
     "at::native::gpu_index_kernel<at::native::index_kernel_impl<at::native"
     "::OpaqueType<4> >(at::TensorIteratorBase&, c10::ArrayRef<long>, c10::"
     "ArrayRef<long>)::{lambda(char*, char const*, long)#1}>(at::"
     "TensorIteratorBase&, c10::ArrayRef<long>, c10::ArrayRef<long>, at::"
     "native::index_kernel_impl<at::native::OpaqueType<4> >(at::"
     "TensorIteratorBase&, c10::ArrayRef<long>, c10::ArrayRef<long>)::"
     "{lambda(char*, char const*, long)#1} const&)::{lambda(int)#1})",
     "gather/scatter/index"),
    ("void at::native::(anonymous namespace)::ctc_loss_log_alpha_gpu_kernel"
     "<float, long>(float*, float const*, long const*, long, long const*, "
     "long const*, long, long, long, long, long, long, long, long const*, "
     "long, long, long)", "other"),
]


@pytest.mark.parametrize("name,group", NAMES,
                         ids=[f"{i}-{g}" for i, (_, g) in enumerate(NAMES)])
def test_the_classifier_puts_each_kernel_in_its_group(name, group):
    assert trace_step.classify(name) == group


def test_k5_is_never_pytorchs_elementwise_nor_the_other_way_round():
    groups = {trace_step.classify(n) for n, g in NAMES
              if "elementwise_kernel" in n}
    assert groups == {"K5", "elementwise", "gather/scatter/index"}
    port = {g for g, _ in trace_step.GROUPS if g.startswith("K")}
    for name, group in NAMES:
        if name.startswith("void at::"):
            assert group not in port
    assert {g for _, g in NAMES} >= port


def _event(name, cat, ts, dur, tid=7, correlation=None):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid, "ts": ts,
         "dur": dur, "args": {}}
    if correlation is not None:
        e["args"]["correlation"] = correlation
    return e


def test_a_written_trace_reads_back_exactly(tmp_path, capsys):
    """Two streams whose kernels overlap: the busy time is their union,
    the kernel sum counts both; copies stay apart; a graph launch's
    kernels are counted; the window's annotation sets the span."""
    k1 = NAMES[0][0]
    gemm = NAMES[25][0]
    add = NAMES[23][0]
    events = [
        _event(trace_step.WINDOW, "user_annotation", 1000.0, 400.0, tid=1),
        _event("cudaGraphLaunch", "cuda_runtime", 1010.0, 5.0, tid=1,
               correlation=50),
        _event(k1, "kernel", 1100.0, 100.0, tid=7),          # stream 7
        _event(gemm, "kernel", 1150.0, 100.0, tid=8),        # stream 8
        _event(add, "kernel", 1300.0, 20.0, tid=7, correlation=50),
        _event(add, "kernel", 1330.0, 10.0, tid=7, correlation=50),
        _event(k1, "kernel", 1345.0, 5.0, tid=8),
        _event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1050.0,
               30.0),
        _event("Memset (Device)", "gpu_memset", 1090.0, 4.0),
        _event("aten::mm", "cpu_op", 1020.0, 10.0, tid=1),
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "ts": 1010.0, "id": 50},
    ]
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "trace.json").write_text(json.dumps(
        {"traceEvents": events, "deviceProperties": []}))
    out = trace_step.main(["--trace-dir", str(tmp_path), "--top", "3"])
    t = out["totals"]
    assert t["span_ms"] == pytest.approx(0.400)
    # union: [1100, 1250] + [1300, 1320] + [1330, 1340] + [1345, 1350]
    assert t["busy_ms"] == pytest.approx(0.185)
    assert t["kernel_ms"] == pytest.approx(0.235)
    assert t["idle_share"] == pytest.approx(1 - 185 / 400)
    assert t["busy_share"] == pytest.approx(185 / 400)
    assert (t["kernels"], t["streams"]) == (5, 2)
    assert t["memcpy_ms"] == pytest.approx(0.030)
    assert t["memset_ms"] == pytest.approx(0.004)
    assert (t["graph_launches"], t["graph_kernels"]) == (1, 2)
    groups = {g["group"]: g for g in out["groups"]}
    assert list(groups) == ["K1", "GEMM (cuBLAS, CUTLASS)", "memcpy/memset",
                            "elementwise"]
    assert groups["K1"]["ms"] == pytest.approx(0.105)
    assert groups["K1"]["launches"] == 2
    assert groups["K1"]["share"] == pytest.approx(105 / 235)
    assert groups["elementwise"]["launches"] == 2
    assert groups["memcpy/memset"]["share"] is None
    assert [(k["name"], k["count"]) for k in out["top"]] == [
        (k1, 2), (gemm, 1), (add, 2)]
    printed = capsys.readouterr().out
    assert "== groups" in printed and "1 CUDA graph launches ran 2" in printed
    # without the window's annotation the span is the device's own
    (tmp_path / "sub" / "trace.json").write_text(json.dumps(events[1:]))
    assert trace_step.report(str(tmp_path), quiet=True)["totals"][
        "span_ms"] == pytest.approx(0.300)


@pytest.mark.parametrize("argv", [
    ["--mode", "train"], ["--mode", "train", "--arch", "transducer"],
    ["--mode", "pretrain"], ["--mode", "pretrain_byol"],
    ["--mode", "beam_device", "--width", "8"], ["--mode", "transducer_beam"]],
    ids=lambda a: "-".join(a[1::2]))
def test_every_trace_mode_runs_on_the_cpu_at_tiny(argv, tmp_path,
                                                  monkeypatch):
    monkeypatch.setattr(trace_step.tempfile, "mkdtemp",
                        lambda prefix: str(tmp_path))
    out = trace_step.main(argv + ["--batch", "2", "--audio-s", "1",
                                  "--steps", "1", "--device", "cpu"],
                          cfg=_tiny_configs()[1])
    assert out["trace_dir"] == str(tmp_path)
    assert (tmp_path / trace_step.TRACE_FILE).exists()
    assert out["totals"]["span_ms"] > 0
    assert out["totals"]["kernels"] == 0 and out["groups"] == []
    assert set(out["wrapper_launches"].values()) == {0}


def _tiny_configs():
    jcfg = JConfig(model=JModelConfig.tiny(VOCAB)).override(
        **{"optim.compute_dtype": "float32"})
    return jcfg, Config.from_dict(jcfg.to_dict())


@functools.lru_cache(maxsize=None)
def _variables():
    jcfg, _ = _tiny_configs()
    init = jax.jit(functools.partial(init_variables, jcfg, mel_frames=32))
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(5)))


def _port_model():
    _, tcfg = _tiny_configs()
    model = Conformer(tcfg.model, tcfg.optim.compute_dtype)
    model.load_state_dict(flax_to_state_dict(_variables(), tcfg.model))
    return model


def _profile_batch():
    b = synthetic_batch(PROFILE_B, int(PROFILE_S * SR), VOCAB,
                        max_tokens=PROFILE_TOKENS, seed=0)
    return b.audio, b.audio_lengths, b.tokens, b.token_lengths


def _jax_chain_loss() -> float:
    """The JAX tool's chain on profile_step's batch: MelFrontend ->
    ConformerEncoder -> LSTMDecoder -> ctc_loss, deterministic."""
    jcfg, _ = _tiny_configs()
    variables = _variables()
    part = lambda name: {k: v[name] for k, v in variables.items()}
    enc = JConformerEncoder(jcfg.model, dtype=jnp.float32, deterministic=True)
    dec = JLSTMDecoder(jcfg.model.vocab_size, jcfg.model.lstm_hidden_dim,
                       jcfg.model.n_lstm_layers, dtype=jnp.float32,
                       deterministic=True)
    frontend = JMelFrontend(jcfg.audio)

    def chain(audio, audio_lengths, tokens, token_lengths):
        mels = frontend(audio)
        mel_lengths = frontend.frame_lengths(audio_lengths)
        x = enc.apply(part("encoder"), mels, mel_lengths, mutable=[])[0][0]
        logits = dec.apply(part("decoder"), x, mutable=[])[0]
        return j_ctc_loss(logits.astype(jnp.float32),
                          j_subsampled(mel_lengths), tokens, token_lengths)

    args = tuple(jnp.asarray(x) for x in _profile_batch())
    return float(jax.jit(chain).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args))


def _jax_stream_texts():
    """The JAX package's offline greedy text and streamed text (chunk 1 s,
    context 2 s, 100 ms blocks) of sweep_streaming's audio."""
    jcfg, _ = _tiny_configs()
    variables = _variables()
    tok = j_load_tokenizer("vi")
    audio = sweep_streaming.noise(SWEEP_S, SR)
    forward = j_make_forward(jcfg)
    logits, n = jax.jit(forward)(variables, jnp.asarray(audio[None, :]),
                                 jnp.asarray([len(audio)], jnp.int32))
    ids, counts = j_greedy_decode(logits, n)
    offline = tok.collapsed_ids_to_text(np.asarray(ids)[0, : int(counts[0])])
    st = JStreamingTranscriber(jcfg, tok, variables, chunk_s=CHUNK_S,
                               left_context_s=CONTEXT_S, decode="greedy")
    block = int(BLOCK_MS / 1e3 * SR)
    parts = [st.feed(audio[i: i + block]) for i in range(0, len(audio),
                                                          block)]
    return offline, "".join(parts) + st.finish()


@pytest.fixture(scope="module")
def jax_refs():
    return {"loss": _jax_chain_loss(), "texts": _jax_stream_texts()}


def test_profile_step_prints_every_component_and_its_loss_is_jaxs(
        jax_refs, capsys):
    _, tcfg = _tiny_configs()
    out = profile_step.profile(tcfg, PROFILE_B, PROFILE_S,
                               torch.device("cpu"), model=_port_model(),
                               tokens=PROFILE_TOKENS, iters=1, step_iters=1)
    printed = capsys.readouterr().out
    for name in profile_step.COMPONENTS:
        assert f"{name}:" in printed
        assert out[name]["wall_ms"] > 0 and out[name]["device_ms"] is None
    assert "device not measured" in printed and "audio-s/s" in printed
    assert out["audio_s_per_s"] > 0
    assert np.isfinite(out["ctc_loss"]) and out["ctc_loss"] > 0
    assert abs(out["ctc_loss"] - jax_refs["loss"]) <= 1e-5 * max(
        1.0, abs(jax_refs["loss"]))


def test_sweep_streaming_texts_are_the_jax_packages(jax_refs, capsys):
    _, tcfg = _tiny_configs()
    rows = sweep_streaming.sweep(
        tcfg, load_tokenizer("vi"), _port_model(),
        sweep_streaming.noise(SWEEP_S, SR), [CHUNK_S], [CONTEXT_S],
        block_ms=BLOCK_MS, device=torch.device("cpu"))
    offline, streamed = jax_refs["texts"]
    assert offline and streamed
    assert [r["text"] for r in rows] == [offline, streamed]
    printed = [json.loads(line) for line in
               capsys.readouterr().out.strip().splitlines()]
    assert printed[0]["offline_chars"] == len(offline)
    row = printed[1]
    assert (row["chunk_s"], row["left_context_s"]) == (CHUNK_S, CONTEXT_S)
    assert row["streamed_chars"] == len(streamed) and row["rtf"] > 0
    from conformer_tpu.text.metrics import cer as j_cer

    assert row["divergence_cer_vs_offline"] == round(
        float(j_cer([streamed], [offline])), 4)


def test_sweep_streaming_records_a_refused_pair(capsys):
    """A context that is no multiple of the stride's audio is refused by
    the transcriber (a ValueError): the pair gets an error row."""
    _, tcfg = _tiny_configs()
    rows = sweep_streaming.sweep(
        tcfg, load_tokenizer("vi"), _port_model(),
        sweep_streaming.noise(1.0, SR), [0.01], [2.0],
        device=torch.device("cpu"))
    assert rows[1]["error"].startswith("ValueError: chunk_s too small")


def test_bench_audio_io_rates_and_decoders_agree(tmp_path, capsys):
    out = bench_audio_io.main(["--files", "1", "--seconds", "1",
                               "--repeats", "1"])
    keys = {"wav_native", "flac_native", "wav_scipy", "flac_python",
            "wav_dispatch"}
    assert set(out) == keys | {"flac_native_speedup"}
    assert all(out[k] > 0 for k in keys)
    assert "native FLAC speedup" in capsys.readouterr().out
    from conformer_tpu_torch.audio import flac, native

    wavs, flacs = bench_audio_io.utterances(str(tmp_path), 1, 1.0)
    got, want = native.read_flac(flacs[0]), flac.read_flac(flacs[0])
    assert got[1] == want[1] == SR
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("tool", [trace_step, profile_step, sweep_streaming],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_gpu_tools_refuse_to_run_without_a_gpu(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        tool.main([])
    assert capsys.readouterr().out == ""


def test_chip_smoke_expects_each_group_from_the_wrappers_counts():
    """chip_smoke's tools phase: the kernels a wrapper call launches (K2's
    four hopper passes or five general ones, K4b's window kernel or its
    partial and reduce pair) times the wrappers' counts."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    counts = {"sincos_attention_fwd": 40, "sincos_attention_fwd_dropout": 34,
              "sincos_attention_fwd_general": 0,
              "sincos_attention_bwd": 17, "sincos_attention_bwd_general": 0,
              "logmel_fwd": 2, "depthwise_conv_fwd": 51,
              "depthwise_conv_dw": 17, "depthwise_conv_dw_window": 15,
              "vpu_pass": 3}
    assert chip_smoke.expected_group_launches(counts) == {
        "K1": 6, "K1-drop": 34, "K1 general": 0, "K2": 68, "K2 general": 0,
        "K3": 2, "K4a": 51, "K4b": 19, "K5": 3}
    # the general kernels' launches with dropout are not counted apart:
    # then only the hopper pair's sum is known
    general = dict(counts, sincos_attention_fwd_general=4,
                   sincos_attention_bwd_general=2)
    assert chip_smoke.expected_group_launches(general) == {
        "K1 + K1-drop": 36, "K1 general": 4, "K2": 60, "K2 general": 10,
        "K3": 2, "K4a": 51, "K4b": 19, "K5": 3}
