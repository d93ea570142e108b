"""The port's standing rules, checked on the CPU.

- paddle_tpu_torch and the card scripts (chip_smoke.py, *_limits.py,
  profile_*.py) import neither JAX nor anything of paddle_tpu (the
  machine with the card has no JAX);
- entry points run on the card unless the caller asks for the CPU: with
  no device and no CUDA they raise instead of running on the CPU;
- the kernel registry lists exactly the ported kernels, under the JAX
  registry's names, and generic_elementwise, the counterpart of the one
  Pallas kernel the JAX registry never names (the static-program pass's
  per-region loop);
- chip_smoke.py fails, printing no result, without a card;
- every planted fault of the *_limits.py scripts finds the text it
  substitutes in the kernel source it mutates, so none can silently
  plant nothing."""

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import paddle_tpu_torch
names = [m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                               "paddle_tpu_torch.")]
for n in names:
    importlib.import_module(n)
# imports only: the scripts run under __main__
import chip_smoke, flash_limits, paged_limits, profile_serving, profile_training
import gmm_limits, quant_limits, ragged_limits
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "paddle_tpu" or m.startswith("paddle_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_no_jax_and_no_reference_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    # every module of the slice was imported
    for mod in ("paddle_tpu_torch.serving.engine",
                "paddle_tpu_torch.ops.ragged", "paddle_tpu_torch.ops.fused",
                "paddle_tpu_torch.ops.megafront",
                "paddle_tpu_torch.ops.megadecode",
                "paddle_tpu_torch.ops._build", "paddle_tpu_torch.convert",
                "paddle_tpu_torch.models.llama",
                "paddle_tpu_torch.models.gpt", "paddle_tpu_torch.models.qwen2",
                "paddle_tpu_torch.nn.norm", "paddle_tpu_torch.device",
                "paddle_tpu_torch.resilience", "paddle_tpu_torch.ops.flash",
                "paddle_tpu_torch.ops.flash_attention",
                "paddle_tpu_torch.nn.functional",
                "paddle_tpu_torch.trainer.pretrain",
                "paddle_tpu_torch.optimizer.functional",
                "paddle_tpu_torch.amp",
                "paddle_tpu_torch.distributed.recompute",
                "paddle_tpu_torch.distributed.parallel_layers",
                "paddle_tpu_torch.generation", "paddle_tpu_torch.flags",
                "paddle_tpu_torch.ops.paged",
                "paddle_tpu_torch.ops.paged_attention",
                "paddle_tpu_torch.ops.quant", "paddle_tpu_torch.ops.gmm",
                "paddle_tpu_torch.ops.grouped_gemm",
                "paddle_tpu_torch.incubate.moe",
                "paddle_tpu_torch.models.moe_llm",
                "paddle_tpu_torch.models.ernie",
                "paddle_tpu_torch.nn.clip", "paddle_tpu_torch.optimizer",
                "paddle_tpu_torch.optimizer.lr",
                "paddle_tpu_torch.models.deepseek",
                "paddle_tpu_torch.ops.mla", "paddle_tpu_torch.ops.flashmask",
                "paddle_tpu_torch.nn.functional.flash_attention",
                "paddle_tpu_torch.incubate.nn",
                "paddle_tpu_torch.incubate.nn.functional",
                "paddle_tpu_torch.jit", "paddle_tpu_torch.jit.fusion",
                "paddle_tpu_torch.jit.fusion_cc",
                "paddle_tpu_torch.ops.elementwise",
                "paddle_tpu_torch.static", "paddle_tpu_torch.inference"):
        assert mod in res["modules"]


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_tiny_config)
    from paddle_tpu_torch.serving import ServingEngine
    cfg = llama_tiny_config(num_hidden_layers=1)
    model = LlamaForCausalLM(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(cfg)
    from paddle_tpu_torch.models import MoEForCausalLM, qwen2_moe_tiny_config
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MoEForCausalLM(qwen2_moe_tiny_config(num_hidden_layers=1))
    from paddle_tpu_torch.models import (DeepSeekV2ForCausalLM,
                                         deepseek_v2_tiny_config)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeepSeekV2ForCausalLM(deepseek_v2_tiny_config(num_hidden_layers=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model, ragged=False)
    from paddle_tpu_torch.trainer import (PretrainConfig,
                                          build_llama_pretrain_step)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_llama_pretrain_step(PretrainConfig(cfg, global_batch=1,
                                                 seq_len=8))
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.static import InputSpec
    prefix = str(tmp_path / "llama")
    jit.save(model, prefix, input_spec=[InputSpec([1, 8], "int64")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inference.create_predictor(inference.Config(prefix))
    # the explicit request still runs on the CPU; generate_cached runs
    # where its model lives
    cfg_cpu = inference.Config(prefix)
    cfg_cpu.disable_gpu()
    inference.create_predictor(cfg_cpu)
    ServingEngine(model, device="cpu")
    ServingEngine(model, ragged=False, device="cpu")
    from paddle_tpu_torch.generation import generate_cached
    gen, _ = generate_cached(model, [[1, 2, 3]], max_new_tokens=2,
                             decode_strategy="greedy_search")
    assert gen.device.type == "cpu"


def test_engine_refuses_a_model_on_another_device():
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_tiny_config)
    from paddle_tpu_torch.serving import ServingEngine
    model = LlamaForCausalLM(llama_tiny_config(num_hidden_layers=1),
                             device="cpu")
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="model parameters live on"):
            ServingEngine(model, device="cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        ServingEngine(model, device="meta")


def test_registry_names_the_ported_kernels():
    import paddle_tpu.ops.fused  # noqa: F401  (registers its kernels)
    import paddle_tpu.ops.pallas_flash  # noqa: F401
    import paddle_tpu.ops.pallas_flashmask  # noqa: F401
    import paddle_tpu.ops.pallas_gmm  # noqa: F401
    import paddle_tpu.ops.pallas_megadecode  # noqa: F401
    import paddle_tpu.ops.pallas_megafront  # noqa: F401
    import paddle_tpu.ops.pallas_mla  # noqa: F401
    import paddle_tpu.ops.pallas_paged  # noqa: F401
    import paddle_tpu.ops.pallas_ragged  # noqa: F401
    import paddle_tpu.ops.quant  # noqa: F401
    from paddle_tpu.ops.oracles import oracles as jax_oracles
    from paddle_tpu_torch.ops import launch_counts, oracles
    ported = oracles()
    assert set(ported) == {"fused_rms_norm", "fused_layer_norm",
                           "fused_rope_append",
                           "ragged_paged_attention", "fused_qkv_rope_append",
                           "fused_oproj_norm", "fused_ffn", "flash_sdpa",
                           "paged_decode_attention",
                           "paged_decode_attention_v2", "weight_only_linear",
                           "gmm", "mla_decode_attention",
                           "fused_append_rows", "int4_dequantize",
                           "flashmask_sdpa", "swiglu", "fused_rope",
                           "fused_bias_residual_layer_norm",
                           "fused_moe_dispatch_combine",
                           "generic_elementwise"}
    # the one name outside the JAX registry: JAX's register_oracle never
    # names _generic_kernel (jit/fusion_cc.py:177), the Pallas loop its
    # static-program pass synthesizes per region; generic_elementwise is
    # its Hopper counterpart
    assert set(ported) - set(jax_oracles()) == {"generic_elementwise"}
    for name, entry in ported.items():
        assert entry.kernel.__name__ == name
        assert entry.kernel.launches >= 0
        assert entry.kernel.plain_calls >= 0
        path, _, cls = entry.parity_test.partition("::")
        assert (ROOT / path).is_file()
        assert f"class {cls}" in (ROOT / path).read_text()
    # backward wrappers are counted beside their forward, each under its
    # own name
    assert [f.__name__ for f in ported["flash_sdpa"].backward] == \
        ["flash_sdpa_bwd"]
    assert [f.__name__ for f in ported["gmm"].backward] == \
        ["gmm_dlhs", "tgmm"]
    assert [f.__name__ for f in ported["flashmask_sdpa"].backward] == \
        ["flashmask_sdpa_bwd"]
    assert [f.__name__ for f in ported["fused_rope"].backward] == \
        ["fused_rope_bwd"]
    path, _, cls = ported["gmm"].backward_parity_test.partition("::")
    assert f"class {cls}" in (ROOT / path).read_text()
    counts = launch_counts()
    assert set(counts) == set(ported) | {"flash_sdpa_bwd", "gmm_dlhs",
                                         "tgmm", "flashmask_sdpa_bwd",
                                         "fused_rope_bwd"}


def test_kernel_sources_are_in_the_package():
    from paddle_tpu_torch.ops import _build
    names = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert names == ["elementwise.cu", "flash_attention.cu",
                     "flashmask.cu", "fused.cu", "gmm.cu",
                     "megadecode_sm90.cu", "megakernels.cu", "mla.cu",
                     "paged_attention.cu", "ragged_attention.cu",
                     "wol_sm90.cu"]
    # the headers the sources share, each part of the build's hash
    headers = sorted(p.name for p in _build.CSRC.glob("*.cuh"))
    assert headers == ["common.cuh", "flash_sm90.cuh", "flash_tiles.cuh",
                       "sm90.cuh", "wq_sm90.cuh"]
    # _build.py compiles every source of the list, one nvcc each
    assert [p.name for p in _build._sources()] == names
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    for p in _build.CSRC.glob("*.cu"):
        head = p.read_text()[:1500]
        assert "Replaces" in head and "Bound on the H100" in head


def test_wrappers_refuse_non_cuda_non_cpu_tensors():
    from paddle_tpu_torch.ops import fused_rms_norm
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_rms_norm(x, torch.empty(8, device="meta"))


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


#: the scripts that plant kernel faults (flash_limits.plant)
LIMITS = ("flash_limits", "gmm_limits", "mega_limits", "paged_limits",
          "quant_limits", "ragged_limits")


def _limits(name):
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module(name)


@pytest.mark.parametrize("script,fault", [
    (m, f) for m in LIMITS for f in _limits(m).FAULTS])
def test_planted_fault_texts_occur(script, fault):
    """The substitutions of a fault, made in order as `plant` makes them,
    each find their text at least occurrence + 1 times in the source."""
    mod = _limits(script)
    kernel = getattr(mod, "FAULT_KERNELS", {}).get(fault, mod.KERNEL)
    text = (ROOT / kernel).read_text()
    _, *edits = mod.FAULTS[fault]
    assert edits and len(edits) % 3 == 0
    for i in range(0, len(edits), 3):
        old, new, which = edits[i:i + 3]
        parts = text.split(old)
        assert old != new and len(parts) >= which + 2, (
            f"{script}: {fault}'s substitution {i // 3} finds its text "
            f"{len(parts) - 1} times in {kernel}, needs {which + 1}")
        text = old.join(parts[:which + 1]) + new + old.join(parts[which + 1:])
