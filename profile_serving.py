#!/usr/bin/env python3
"""Where one serving step's time goes, on the card.

    python3 profile_serving.py [--out serving_trace.json]
                               [--model llama|gpt|qwen2|moe|deepseek]
                               [--chain fused|split|alternating]
                               [--quant int8|int4]

Serves the same configuration and seeded traffic as chip_smoke.py's
phase 4 (Llama-3-8B; ``--model gpt``: GPT-3 6.7B, phase 10; ``--model
qwen2``: Qwen2-7B, phase 11; ``--model moe``: ERNIE-4.5-21B-A3B's
widths, phase 12; ``--model deepseek``: DeepSeek-V2-Lite, phase 13; bf16, 4 slots, page_size 16, 128-token
prefill chunks), on the engine's default fused chain, with ``--chain split`` on
the split chain of the unified step, or with ``--chain alternating`` on
the alternating path (``ragged=False``: a prefill-chunk launch and a
decode-step launch per engine step, paged decode attention), and records
a window of decode-only steps and a window of mixed (prefill + decode)
steps under torch.profiler; ``--quant`` serves the weight-only int8 or
int4 layout of the same weights (quantized on the card as the engine is
built). Prints one JSON line per window: host wall
ms per step, device busy ms per step (the union of kernel intervals in
the trace), the device's idle share, device time by kernel group (the
port's kernels, the routed experts' grouped GEMM ``gmm``, cuBLAS GEMMs,
PyTorch's gathers / scatters, concatenations
and other elementwise passes, everything else) and the ten kernels with
the most device time. Needs one CUDA card; the trace of the last window
goes to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (CHUNK, DEEPSEEK_V2_LITE, ERNIE45_21B_A3B, MAX_CTX,
                        PSZ, QWEN2_7B, SLOTS, trace)
from paddle_tpu_torch import card_report
from paddle_tpu_torch.models import (DeepSeekV2Config, DeepSeekV2ForCausalLM,
                                     GPTForCausalLM, MoEConfig,
                                     MoEForCausalLM, Qwen2Config,
                                     Qwen2ForCausalLM, gpt3_6_7b_config)
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama3_8b_config
from paddle_tpu_torch.serving import ServingEngine

#: --model: the model class and its full-width config, as chip_smoke.py
#: builds them
MODELS = {"llama": (LlamaForCausalLM, llama3_8b_config),
          "gpt": (GPTForCausalLM, gpt3_6_7b_config),
          "qwen2": (Qwen2ForCausalLM, lambda: Qwen2Config(**QWEN2_7B)),
          "moe": (MoEForCausalLM, lambda: MoEConfig(**ERNIE45_21B_A3B)),
          "deepseek": (DeepSeekV2ForCausalLM,
                       lambda: DeepSeekV2Config(**DEEPSEEK_V2_LITE))}

STEPS = 6                          # engine steps per profiled window
#: kernel-name fragments of the port's own kernels (ops/csrc)
PORT_KERNELS = ("rms_norm_kernel", "ptt::layer_norm_kernel",
                "rope_append_kernel", "ragged_attention_kernel",
                "ragged_split_kernel",
                "mega::gemm_kernel", "qkv_finalize_kernel", "oproj_norm_finalize_kernel",
                "residual_finalize_kernel", "paged_v1_kernel",
                "paged_v2_kernel", "paged_v2_mma_kernel",
                "mla_finalize_kernel", "append_rows_kernel",
                "int4_dequantize_kernel", "mla::split_kernel",
                "mla::merge_kernel", "md::md_gemm", "md::norm_kernel")
# (md::md_gemm and md::norm_kernel are the bf16 o-proj and FFN,
# csrc/megadecode_sm90.cu; weight_only_linear's f32 route runs
# mega::gemm_kernel and residual_finalize_kernel;
# ragged_split_kernel is ragged attention's bf16 route, its splits merged
# in the same launch, ragged_attention_kernel its f32 route)
#: name fragments of PyTorch's own passes, in match order: gathers and
#: scatters (page gathers, append_to_cache's index_put_), concatenations
#: (the alternating path's inline rope), other elementwise passes
TORCH_GROUPS = (("index", "index"), ("catarray", "cat"),
                ("elementwise", "elementwise"), ("reduce", "reduce"))


def group(name: str) -> str:
    if "gmm::gmm_" in name:             # ops/csrc/gmm.cu, either dtype
        return "gmm"
    for k in PORT_KERNELS:
        if k in name:
            return k
    low = name.lower()
    # cuBLAS's Hopper GEMMs are named nvjet_*; split-K adds a reduce pass
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass",
                              "splitkreduce")):
        return "gemm"
    for frag, g in TORCH_GROUPS:
        if frag in low:
            return g
    return "other"


def busy_ms(kernels) -> float:
    """Union of [ts, ts + dur) intervals, in ms."""
    spans = sorted((k["ts"], k["ts"] + k["dur"]) for k in kernels)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def window(eng, n_steps: int, out: Path):
    """Profile the next `n_steps` engine steps; returns the host wall ms
    and the step counts of each, and the trace's kernel events."""
    steps = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eng.step()
            torch.cuda.synchronize()
            steps.append(((time.perf_counter() - t0) * 1e3, res))
    prof.export_chrome_trace(str(out))
    events = json.loads(out.read_text())["traceEvents"]
    return steps, [e for e in events if e.get("cat") == "kernel"]


def summarize(kind, steps, kernels):
    """Per-step averages over the profiled window."""
    n = len(steps)
    wall = sum(ms for ms, _ in steps)
    by_group, by_name = defaultdict(float), defaultdict(float)
    for k in kernels:
        by_group[group(k["name"])] += k["dur"] / 1e3
        by_name[k["name"]] += k["dur"] / 1e3
    busy = busy_ms(kernels) if kernels else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window": kind, "steps": n,
        "prefill_tokens": sum(r["prefill_tokens"] for _, r in steps),
        "decoded": sum(r["decoded"] for _, r in steps),
        "wall_ms_per_step": wall / n,
        # None: the profiler recorded no device activity (not measured)
        "device_busy_ms_per_step": None if busy is None else busy / n,
        "device_idle_share": None if busy is None else 1 - busy / wall,
        "kernels_per_step": len(kernels) / n,
        "device_ms_per_step_by_group": {g: v / n
                                        for g, v in by_group.items()},
        "top_kernels_ms_per_step": [(name[:90], v / n) for name, v in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="serving_trace.json")
    ap.add_argument("--model", choices=tuple(MODELS), default="llama")
    ap.add_argument("--chain", choices=("fused", "split", "alternating"),
                    default="fused")
    ap.add_argument("--quant", choices=("int8", "int4"), default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_serving.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    card = card_report()
    cls, config = MODELS[args.model]
    cfg = config()
    model = cls(cfg, dtype=torch.bfloat16,
                generator=torch.Generator("cuda").manual_seed(0))
    chain = {"fused": {}, "split": dict(megafront=False, megadecode=False),
             "alternating": dict(ragged=False)}[args.chain]
    eng = ServingEngine(model, max_slots=SLOTS, page_size=PSZ,
                        prefill_chunk=CHUNK, max_context=MAX_CTX,
                        weight_only_quant=args.quant, **chain)
    rng = np.random.RandomState(0)
    # warm-up request, then chip_smoke.py's phase-4 prompts, all at once
    eng.add_request(rng.randint(0, cfg.vocab_size, 64), max_new_tokens=2)
    eng.run_to_completion()
    for rid, (p, _, _) in enumerate(trace(rng, cfg.vocab_size, 8, 64, 512,
                                          32, 32, 1)):
        eng.add_request(p, max_new_tokens=32, request_id=rid)
    eng.step()                      # admit: the first window is all mixed
    results = [summarize("mixed", *window(eng, STEPS, out))]
    while eng._prefill_fifo or eng.scheduler.waiting:
        eng.step()                  # unprofiled, up to decode-only work
    results.append(summarize("decode", *window(eng, STEPS, out)))
    eng.run_to_completion()
    for r in results:
        print(json.dumps({"card": card["nvidia_smi"], "model": args.model,
                          "chain": args.chain,
                          "weight_only_quant": args.quant, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
