#!/usr/bin/env python3
"""Where one training step's time goes, on the card.

    python3 profile_training.py [--model llama|moe] [--out trace.json]
                                [--steps 2]

``--model llama`` (the default) builds chip_smoke.py's phase-9
configuration (Llama-3-8B width, 4 of its 32 layers, batch 1 x 8192
tokens, bf16 compute over f32 master weights, f32 AdamW moments, no
recompute, 4 CE chunks) and runs its compiled-in-one-function pretraining
step; ``--model moe`` builds phase 12b's (ERNIE-4.5-21B-A3B's widths, 4 of
its 28 layers, batch 1 x 4096 tokens, bf16 parameters through
amp.decorate O2 with f32 master weights and AdamW moments, clip 1.0) and
runs the eager step (forward with labels, backward, ``AdamW.step()``,
``clear_grad()``). Takes 2 unprofiled warm-up steps on one seeded batch,
then records ``--steps`` steps under torch.profiler. Prints one JSON
line: host wall ms per step, device busy ms per step (the union of
kernel intervals), the device's idle share, device ms per step by kernel
group (the flash kernels one by one, the gmm forward / dlhs / tgmm
kernels, cuBLAS GEMMs, the routing's sorts and its gathers and scatters,
reductions, the rest), device ms per step of the optimizer update (the
kernels launched inside ``FunctionalAdamW.update`` or the eager
``Optimizer.step``, clip included, marked here with a ``record_function``
range) and of everything before it, and the ten kernels with the most
device time.
Needs one CUDA card; the trace goes to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (ERNIE45_21B_A3B, MOE_TRAIN_LAYERS,
                        MOE_TRAIN_RECOMPUTE, MOE_TRAIN_SEQ, TRAIN_LAYERS,
                        TRAIN_SEQ)
from paddle_tpu_torch import amp, card_report
from paddle_tpu_torch.models import MoEConfig, MoEForCausalLM
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama3_8b_config
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW, FunctionalAdamW, Optimizer
from paddle_tpu_torch.trainer import (PretrainConfig,
                                      build_llama_pretrain_step)
from profile_serving import busy_ms

#: kernel-name fragments of the bf16 flash kernels (ops/csrc/
#: flash_attention.cu): the forward, the fused backward, dq's conversion
#: and the backward's lse / di pre-pass
FLASH = ("fwd_sm90", "bwd_sm90", "dq_convert", "bwd_rows")
OPT_RANGE = "optimizer_update"


def group(name: str) -> str:
    if "flash::" in name:
        for k in FLASH:
            if k in name:
                return "flash " + k
    # ops/csrc/gmm.cu: tgmm_sm90 / gmm_sm90<WT> in bf16, tgmm_kernel /
    # gmm_kernel<float, WT> in f32; WT true: the weight read as [N, K]
    if "gmm::tgmm_" in name:
        return "gmm tgmm"
    if "gmm::gmm_" in name:
        return "gmm dlhs" if "true>" in name else "gmm fwd"
    low = name.lower()
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass",
                              "splitkreduce")):
        return "gemm"
    if "embedding" in low:
        return "embedding"
    if "sort" in low:                       # the router's top-k, argsorts
        return "routing sorts"
    if any(k in low for k in ("scatter", "gather", "index")):
        return "gathers and scatters"
    if "softmax" in low or "logsumexp" in low or "reduce" in low:
        return "reductions"
    return "elementwise and other"


def llama_step():
    """Phase 9's compiled pretraining step: (step(), loss read, info)."""
    cfg = llama3_8b_config(num_hidden_layers=TRAIN_LAYERS,
                           max_position_embeddings=TRAIN_SEQ)
    pcfg = PretrainConfig(cfg, global_batch=1, seq_len=TRAIN_SEQ, lr=3e-4,
                          weight_decay=0.1, grad_clip=1.0, ce_chunks=4,
                          remat="none", param_dtype="bfloat16")
    model = LlamaForCausalLM(cfg, dtype=torch.float32,
                             generator=torch.Generator("cuda").manual_seed(0))
    state, step, _ = build_llama_pretrain_step(pcfg, model=model)
    update = FunctionalAdamW.update

    def marked_update(self, *a, **kw):
        with torch.profiler.record_function(OPT_RANGE):
            return update(self, *a, **kw)

    FunctionalAdamW.update = marked_update
    g = torch.Generator("cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (1, TRAIN_SEQ), device="cuda",
                        generator=g)
    labels = torch.roll(ids, -1, dims=1)
    box = {"state": state}

    def one():
        box["state"], m = step(box["state"], ids, labels)
        return float(m["loss"])

    return one, {"model": "llama", "layers": TRAIN_LAYERS, "seq": TRAIN_SEQ}


def moe_step():
    """Phase 12b's eager MoE step: (step(), info)."""
    cfg = MoEConfig(**dict(ERNIE45_21B_A3B, num_hidden_layers=MOE_TRAIN_LAYERS,
                           recompute=MOE_TRAIN_RECOMPUTE))
    model = MoEForCausalLM(cfg, dtype=torch.float32,
                           generator=torch.Generator("cuda").manual_seed(0))
    opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                weight_decay=0.1, grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt = amp.decorate(model, opt, level="O2")
    step_fn = Optimizer.step

    def marked_step(self):
        with torch.profiler.record_function(OPT_RANGE):
            return step_fn(self)

    Optimizer.step = marked_step
    g = torch.Generator("cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (1, MOE_TRAIN_SEQ), device="cuda",
                        generator=g)
    labels = torch.roll(ids, -1, dims=1)

    def one():
        loss, _ = model(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return float(loss.detach())

    return one, {"model": "moe", "layers": MOE_TRAIN_LAYERS,
                 "seq": MOE_TRAIN_SEQ, "recompute": MOE_TRAIN_RECOMPUTE}


def in_ranges(events, name: str):
    """Kernels whose launch (the runtime call with the same correlation
    id) lies inside a ``record_function(name)`` range."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == name]
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})
                and any(a <= e["ts"] <= b for a, b in spans)}
    return [e for e in events if e.get("cat") == "kernel"
            and e.get("args", {}).get("correlation") in launched]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("llama", "moe"), default="llama")
    ap.add_argument("--out", default="training_trace.json")
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_training.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    card = card_report()
    one, info = (llama_step if args.model == "llama" else moe_step)()
    for _ in range(2):
        one()
    torch.cuda.synchronize()
    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            t0 = time.perf_counter()
            one()
            walls.append((time.perf_counter() - t0) * 1e3)
    prof.export_chrome_trace(str(out))
    events = json.loads(out.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    n = args.steps
    by_group, by_name = defaultdict(float), defaultdict(float)
    for k in kernels:
        by_group[group(k["name"])] += k["dur"] / 1e3 / n
        by_name[k["name"]] += k["dur"] / 1e3 / n
    busy = busy_ms(kernels) / n if kernels else None
    opt_ms = sum(k["dur"] for k in in_ranges(events, OPT_RANGE))
    opt_ms /= 1e3 * n
    wall = sum(walls) / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print(json.dumps({
        "card": card["nvidia_smi"], **info, "steps": n,
        "wall_ms_per_step": wall,
        # None: the profiler recorded no device activity (not measured)
        "device_busy_ms_per_step": busy,
        "device_idle_share": None if busy is None else 1 - busy / wall,
        "kernels_per_step": len(kernels) / n,
        "device_ms_per_step_by_group": dict(by_group),
        "optimizer_update_device_ms_per_step": opt_ms,
        "rest_device_ms_per_step": sum(by_group.values()) - opt_ms,
        "top_kernels_ms_per_step": [(k[:90], v) for k, v in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
