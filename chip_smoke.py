#!/usr/bin/env python3
"""Run the PyTorch + CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, one line each on stdout:

1. card and build: the card's ``nvidia-smi`` name and power limit, the
   torch and CUDA versions; every kernel of ``paddle_tpu_torch/ops/csrc``
   is built from the checkout (one nvcc per source, in parallel); the
   registers ptxas reports, and every entry function that spills;
2. kernels against their plain PyTorch versions at the Llama-3-8B
   serving shapes (H 4096, 32/8 heads x 128, FFN 14336, page_size 16,
   T = 4 slots + a 128-token prefill chunk, a mixed batch with an idle
   slot and a -1 table entry), in bf16 and f32, each timed with CUDA
   events (median of 25 reps, L2 scrubbed before each) beside its plain
   version, its bound on the H100 (bytes at the HBM rate or operations
   at the working type's peak), for rms_norm
   torch.nn.functional.rms_norm and, for the three megakernels, the
   split-chain calls that compute the same function (``split_ms``); the
   two paged decode kernels (v1, v2) at the alternating decode step's
   shapes (4 slots at 300 / 1024 / 517 tokens and an idle slot of length
   1 on the trash page, 64-page tables with a -1 entry) in bf16 and f32,
   and at a long-context shape (8 sequences, tables of 8192 tokens,
   seeded lengths including 1 and 8192) in bf16; bf16 outputs are held
   by relative errors (`paged_rel_errors`), f32 at 2e-5; the int8 and
   int4 sites of the three megakernels at the same shapes
   (`check_quantized_megakernels`: bf16 also by `row_rel_errors` within
   QSITE_BF16_LIMITS; split_ms on the dequantized bf16 weights);
   weight_only_linear, int8 and int4, at T = 132 x [4096 ->
   14336], the int4 LM head M = 5 x [4096 -> 128256] and odd M x [4096
   -> 1000] (`check_weight_only_linear`: bf16 by `row_rel_errors`, split_ms
   bf16 torch.matmul on the dequantized weight, library_ms
   torch._weight_int8pack_mm for int8, torch._weight_int4pack_mm for
   int4); the bf16 fp megakernel sites are held by the same relative
   errors as the quantized ones (the FFN's at the other sites' limits
   since its activation reaches the down product as bf16 hi + lo
   planes); the ragged kernel and both paged decode kernels at GPT-3
   6.7B's heads (32 x 128 over 32 KV heads, rep 1) and Qwen2-7B's (28
   over 4, rep 7) (`check_rep_shapes`); the gpt family's pieces at
   GPT-3 6.7B's step (`check_gpt_kernels`: fused_layer_norm [132, 4096],
   library_ms F.layer_norm; the layer-norm site of fused_oproj_norm with
   the o-proj bias, split_ms cuBLAS + fused_layer_norm; the gelu site of
   fused_ffn [4096 -> 16384 -> 4096] with b1 / b2, split_ms the cuBLAS +
   F.gelu(approximate="tanh") chain); the grouped GEMM gmm (`check_gmm`)
   at ERNIE-4.5-21B-A3B's serving step (132 tokens routed top-6 over 64
   experts by a seeded router: M 792, [2560 -> 1536] and [1536 -> 2560])
   as a decode step routes it (4 live tokens, the 128 padding rows in
   the same 6 groups) and as a mixed step does (every token live), and
   prefill (2048 tokens: M 12288), and at edge cases (empty groups,
   one group holding every row, rows past the last group, N 64), bf16 by
   relative errors within GMM_BF16_LIMITS (the edge cases by the tensor
   error within GMM_EDGE_TENSOR_LIMIT), f32 at 2e-5, the tail rows
   exactly zero; library_ms torch._grouped_mm;
3. a tiny f32 Llama served on the CPU (plain versions) and on the card
   (kernels) over one seeded join/leave trace, on the fused and on the
   split chain and on the alternating path (ragged=False) under
   FLAGS_paged_impl "intree" (v2) and "intree_v1" (v1): identical greedy
   tokens, and on the alternating path exact launch counts; then tiny
   generate and generate_cached (greedy, f32) CPU vs card: identical
   tokens, scores within 1e-5; then the same with weight-only int8 and
   int4 weights on all three paths and generate_cached, every card run
   at its exact launch counts (`tiny_quant_parity`); then a tiny GPT
   (head dim 64) and a tiny Qwen2 with random biases the same way on
   the fused chain, the split chain and the alternating path under both
   paged impls, and generate_cached, at exact launch counts
   (`tiny_family_parity`); then a tiny f32 ERNIE 4.5 MoE (a dense first
   layer, 8 routed experts, a shared one) the same way in fp, int8 and
   int4 on all three paths, with 38-row unified steps and 36-row prefill
   chunks (gmm three times a routed layer a launch) and 2-row decode
   launches (every expert on every token), then generate (fp) and
   generate_cached (fp, int8, int4) (`tiny_moe_parity`);
4. Llama-3-8B at full width (32 layers, vocab 128256, bf16 weights drawn
   on the card from a seeded generator) serving 8 seeded requests
   (prompts 64-512 tokens, 32 new tokens each) through ServingEngine's
   default fused chain; every kernel's launch count must be that
   chain's per step (layers + 1 rms_norm, layers each of
   qkv_rope_append, ragged attention, oproj_norm and ffn), with no
   plain-version call;
5. the same model and trace on the split chain (megafront=False,
   megadecode=False), full depth, its counts read alone; it reports the
   share of greedy tokens identical to the fused chain's (bf16 ties may
   break differently, so it is not asserted);
6. the same model and trace on the alternating path (ragged=False),
   twice, each run's counts read alone: under FLAGS_paged_impl "intree"
   and under "intree_v1". A prefill-chunk launch and a decode-step launch
   per engine step; per decode launch exactly layers of that impl's paged
   kernel (v2, resp. v1) and 2 * layers + 1 rms_norm, per prefill launch
   2 * layers + 1 rms_norm, nothing else, no plain-version call and no
   other paged route; each launch is also timed alone; the
   identical-token share against the fused chain (and v1's against v2's);
7. generate_cached on the same model: 4 seeded prompts of 512 tokens,
   32 greedy new tokens; the prefill runs the flash kernel once a layer
   and nothing else launches; prefill ms, median decode-token ms,
   tokens/s and peak memory;
7a-7c. the same model and trace with weight-only int8 weights on the
   fused chain, int4 on the fused chain and int4 on the split chain, the
   tree quantized on the card as each engine is built (quantize_s), full
   depth, each engine freed before the next: the fused chain's counts
   plus, under int4, one weight_only_linear a step (the LM head); the
   split chain's plus 7 * layers + 1 weight_only_linear a step; the
   decode step beside the bytes of the tree it reads, and the
   identical-token share against the bf16 fused chain (not asserted);
8. a tiny Llama (head_dim 64, GQA) takes 3 pretraining steps on the
   CPU (plain versions) and on the card (kernels), in f32 and in bf16
   compute: losses and grad norms agree within TINY_TRAIN_LIMITS;
9. pretraining at Llama-3-8B width (hidden 4096, 32/8 heads x 128, FFN
   14336, vocab 128256; depth cut from 32 to 4 layers), batch 1 x 8192
   tokens, bf16 compute over f32 master weights and f32 AdamW moments
   (lr 3e-4, weight decay 0.1, clip 1.0, 4 CE chunks, no recompute),
   weights drawn on the card from a seeded generator: 2 warm-up and 5
   timed steps on one seeded batch; median step ms, tokens/s, train_mfu
   (and its hardware-FLOPs variant), peak memory and the loss
   trajectory; the loss must be finite and fall, and every timed step
   must launch the flash forward and backward once per layer with no
   plain-version call and no attention off the flash route;
10. GPT-3 6.7B at full width and depth (gpt3_6_7b_config: 32 layers,
   hidden 4096, 32 heads x 128, FFN 16384, vocab 50304, tied head; bf16
   weights drawn on the card) on the trace of phase 4: the fused chain
   (fused_layer_norm layers + 1 a step, the layer-norm and gelu sites
   of fused_oproj_norm / fused_ffn layers each), the split chain and the
   alternating path (v2), each run's counts read alone; then
   generate_cached 4 x 512 + 32 as phase 7;
11. Qwen2-7B's published widths (`QWEN2_7B`: hidden 3584, 28 layers, 28
   / 4 heads x 128, FFN 18944, vocab 152064, rope theta 1e6, untied;
   bf16 weights drawn on the card) on the same trace: the fused chain
   and the alternating path (v2);
12. ERNIE-4.5-21B-A3B's published widths (`ERNIE45_21B_A3B`: hidden 2560,
   28 layers, the first dense (FFN 12288), 27 routed over 64 experts of
   FFN 1536, top-6, a shared expert of 3072, 20 / 4 heads x 128, vocab
   103424; the JAX family's untied head; bf16 weights, 22.1 B
   parameters, drawn on the card) on the same trace: the fused chain
   (gmm 3 x 27 a step), the alternating path (v2), generate_cached 4 x
   512 + 32, and int8 weights on the fused chain; on the fused chain the
   experts that each step's routing gave rows are read back after the
   run (`GroupSizeLog`), and with them the weight bytes a decode step
   and a mixed step read and the bound of their gmm work;
13. the ``{"kernels": [...]}`` line (launches from the run of the path
   that uses each kernel: the fused chain, the split chain for
   rope_append, phase 6's two runs for paged v2 and v1, the 8B training
   run for flash attention, phase 7c for weight_only_linear (whose row
   also gives the launches that do int4_dequantize's work on phase 3's
   int4 MoE fused chain), phase 10's
   fused chain for fused_layer_norm; the three megakernels' rows carry
   their int8 / int4 readings and launches from phases 7a / 7b, and
   fused_oproj_norm's and fused_ffn's their layer / gelu readings and
   launches from phase 10's fused chain; gmm's launches from phase 12's
   fused chain), then the ``{"ok": true, ...}`` line.

Phase 2 also holds flash attention (forward, and the dq + dkv backward)
against its plain version at the training shape (B 1, S 8192, 32 heads
x 128, causal) in bf16, by relative errors over each tensor and over
each 64-position tile of a head (`flash_rel_errors`), and at S 2048 in
f32, where the dense plain version's f32 scores would not fit at S 8192
beside the rest; the plain version runs 4 heads at a time. `library_ms` is
torch.nn.functional.scaled_dot_product_attention (is_causal=True) and
its autograd backward on the same tensors, timed as a yardstick only.

It imports neither JAX nor paddle_tpu. Any failure raises and exits
nonzero; without a CUDA device it exits nonzero before printing a result.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from paddle_tpu_torch import card_report, generation, ops
from paddle_tpu_torch.flags import flags_guard
from paddle_tpu_torch.incubate import moe as moe_ffn
from paddle_tpu_torch.models import (GPTForCausalLM, MoEConfig,
                                     MoEForCausalLM, Qwen2Config,
                                     Qwen2ForCausalLM, ernie45_moe_config,
                                     gpt3_6_7b_config, gpt_tiny_config,
                                     qwen2_tiny_config)
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           llama3_8b_config,
                                           llama_tiny_config,
                                           precompute_rope)
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as attn_routes
from paddle_tpu_torch.ops import paged
from paddle_tpu_torch.ops import paged_attention as paged_routes
from paddle_tpu_torch.ops.flash import _launch_fwd
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.trainer import (PretrainConfig,
                                      build_llama_pretrain_step,
                                      flops_per_token, flops_per_token_hw)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
#: H100 SXM dense peaks of the working type (data sheet): bf16 on the
#: tensor cores, f32 outside them
PEAK_FLOPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
REPS = 25
SCRUB_BYTES = 1 << 30          # >> the 50 MB L2: each timed rep starts cold

#: the card every phase runs on (a CPU rehearsal of the script's logic
#: may point it elsewhere; the kernels themselves need the card)
DEV = "cuda"

# the slice's 8B serving geometry
H, HQ, KV, D, PSZ, FFN, VOCAB = 4096, 32, 8, 128, 16, 14336, 128256
SLOTS, CHUNK, MAX_CTX = 4, 128, 1024
# the slice's training geometry: Llama-3-8B width, depth cut to 4 layers
TRAIN_LAYERS, TRAIN_SEQ, WARMUP_STEPS, TIMED_STEPS = 4, 8192, 2, 5
F32_FLASH_SEQ = 2048
# the paged decode kernels' long-context shape: 8 sequences with page
# tables for Llama-3-8B's max_position_embeddings
LONG_SEQS, LONG_CTX = 8, 8192
# generate_cached at 8B: 4 prompts of 512 tokens, 32 greedy new tokens
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 512, 32
# GPT-3 6.7B's step shapes (gpt3_6_7b_config: hidden 4096, 32 heads x
# 128, MHA, FFN 16384)
GPT_H, GPT_HEADS, GPT_FFN = 4096, 32, 16384
#: Qwen2-7B's published config (Qwen/Qwen2-7B config.json): the JAX
#: package has no helper for it, so its widths live here
QWEN2_7B = dict(vocab_size=152064, hidden_size=3584, intermediate_size=18944,
                num_hidden_layers=28, num_attention_heads=28,
                num_key_value_heads=4, max_position_embeddings=131072,
                rope_theta=1000000.0, rms_norm_eps=1e-6,
                tie_word_embeddings=False)
#: ERNIE-4.5-21B-A3B's published config (baidu/ERNIE-4.5-21B-A3B-PT
#: config.json) in the JAX MoE family's terms: its two shared experts of
#: 1536 are one SwiGLU FFN of 3072 over their concatenated columns; the
#: family unties the head and has no routing-score correction bias
ERNIE45_21B_A3B = dict(vocab_size=103424, hidden_size=2560,
                       intermediate_size=12288, num_hidden_layers=28,
                       num_attention_heads=20, num_key_value_heads=4,
                       max_position_embeddings=131072, rope_theta=500000.0,
                       rms_norm_eps=1e-5, num_experts=64, top_k=6,
                       moe_intermediate_size=1536,
                       shared_expert_intermediate_size=3072,
                       first_k_dense_replace=1, moe_dropless=True)
#: the MoE step's rows: the unified step's (4 slots + a 128-token chunk)
#: and generate_cached's prefill (4 x 512) tokens
MOE_STEP_TOKENS, MOE_PREFILL_TOKENS = SLOTS + CHUNK, 4 * 512


def emit(phase: str, **fields) -> None:
    print(f"phase {phase}: " + json.dumps(fields, sort_keys=True),
          flush=True)


class Timer:
    """Median device time of one call, over REPS reps, each with the L2
    scrubbed first (the main path's next layer streams ~0.4 GB of weights
    between two launches of a kernel, so the kernel finds L2 cold). The
    1 GiB scrub also keeps the card busy (~0.3 ms) while the host enqueues
    the timed call, so the events bracket device time, not host latency."""

    def __init__(self):
        self.scrub = torch.empty(SCRUB_BYTES, dtype=torch.uint8,
                                 device=DEV)

    def ms(self, fn) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(REPS):
            self.scrub.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_: float, flops: float = 0.0, dtype=torch.bfloat16):
    """Least time on the card (ms): the bytes at the HBM rate or the
    operations at the working type's peak, whichever is larger."""
    t_mem = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS_PER_S[dtype] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def ptxas_spills(log: str):
    """The build's entry functions whose registers spill, from ptxas -v:
    [{"source", "entry", "stores", "loads"}] (bytes), the entry names
    demangled by c++filt where the machine has it."""
    out, src, entry = [], None, None
    for ln in log.splitlines():
        if ln.startswith("== "):
            src = ln[3:].strip()
        elif "Function properties for" in ln:
            entry = ln.rsplit(" for ", 1)[1].strip()
        elif "spill stores" in ln:
            st, ld = (int(n) for n in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", ln))
            if st or ld:
                out.append({"source": src, "entry": entry, "stores": st,
                            "loads": ld})
    filt = shutil.which("c++filt")
    if out and filt:
        names = subprocess.run([filt], input="\n".join(
            e["entry"] for e in out), capture_output=True, text=True,
            check=True).stdout.splitlines()
        for e, n in zip(out, names):
            e["entry"] = n
    return out


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


#: the bf16 flash kernels round p and ds to bf16 before their products
#: (the plain version keeps f32), so o, dq, dk and dv are held by relative
#: errors, not by one absolute bar: causal, row i of o averages about i
#: values, so late rows (and, in dk / dv, late keys) are ~i^-1/2 the size
#: of the first ones, and a bar scaled to the tensor's largest value would
#: pass a kernel that is wrong on most of them. Limits set from readings of
#: the sound kernel and of planted faults (flash_limits.py, PERF.md).
FLASH_BF16_TENSOR_LIMIT = 1e-2
FLASH_BF16_TILE_LIMIT = 3e-2
FLASH_TILE = 64     # positions of one head: the kernels' q and k tiles


def flash_rel_errors(got, want):
    """(tensor, tile) relative errors of `got` against `want` [B, S, H, D]:
    ||got - want|| / ||want|| over the whole tensor, and the largest of
    the same over its tiles (FLASH_TILE consecutive positions of one
    head), each tile's norm floored at 1% of the median tile norm, so
    that a tile whose true value is zero (rows that see no key) is held
    to that floor. A tile, not a row: dq of a row whose softmax is nearly
    saturated is a difference of nearly equal terms, and its bf16
    rounding there is of the size of the row itself."""
    B, S, H, D = want.shape
    w = want.detach().float()
    d = got.detach().float() - w
    tensor = float(d.norm() / w.norm())
    pad = (0, 0, 0, 0, 0, (-S) % FLASH_TILE)
    w = torch.nn.functional.pad(w, pad).reshape(B, -1, FLASH_TILE, H, D)
    d = torch.nn.functional.pad(d, pad).reshape(B, -1, FLASH_TILE, H, D)
    wn, dn = w.norm(dim=(2, 4)), d.norm(dim=(2, 4))
    floor = 1e-2 * float(wn.median())
    return tensor, float((dn / wn.clamp_min(floor)).max())


def assert_flash_bf16(name: str, got, want):
    """Hold a bf16 flash output to its plain version; returns the
    readings."""
    assert torch.isfinite(got).all(), name
    tensor, tile = flash_rel_errors(got, want)
    assert tensor <= FLASH_BF16_TENSOR_LIMIT, (name, "tensor", tensor)
    assert tile <= FLASH_BF16_TILE_LIMIT, (name, "tile", tile)
    return tensor, tile


#: the bf16 paged decode kernels are held the same way: a typical output
#: value is about (e / length)^1/2, 0.05-0.1 at the 8B step and 0.02-0.04
#: at long context, so an absolute bar of 2e-2 is the size of the values
#: and passes a kernel that drops a page. Over the whole [B, H, D] output
#: and over each (sequence, head)'s D values; limits set from readings of
#: the sound kernels and of planted faults (paged_limits.py, PERF.md).
PAGED_BF16_TENSOR_LIMIT = 5e-3
PAGED_BF16_HEAD_LIMIT = 1e-2


def paged_rel_errors(got, want):
    """(tensor, head) relative errors of `got` against `want` [B, H, D]:
    ||got - want|| / ||want|| over the whole output, and the largest of
    the same over each (sequence, head), its norm floored at 1% of the
    root-mean-square head norm (a length-0 row's zeros are held to that
    floor; a median would be 0 where half the rows are empty)."""
    w = want.float()
    d = got.float() - w
    wn, dn = w.norm(dim=-1), d.norm(dim=-1)
    floor = 1e-2 * float(w.norm()) / wn.numel() ** 0.5
    return (float(d.norm() / w.norm()),
            float((dn / wn.clamp_min(floor)).max()))


def assert_paged_bf16(name: str, got, want):
    """Hold a bf16 paged decode output to its plain version; returns the
    readings."""
    assert torch.isfinite(got).all(), name
    tensor, head = paged_rel_errors(got, want)
    assert tensor <= PAGED_BF16_TENSOR_LIMIT, (name, "tensor", tensor)
    assert head <= PAGED_BF16_HEAD_LIMIT, (name, "head", head)
    return tensor, head


#: bf16 weight_only_linear is held by relative errors over the output
#: and over each output row: the kernel and the plain version round f32
#: sums of the same exact products (bf16 x, int values of bf16 weights) to
#: bf16, so outputs differ by one bf16 step where the two summation orders
#: straddle a rounding boundary, which is rare. A wrong nibble order or a
#: lost sign extension moves every output, and so does folding the scale
#: into a bf16 weight, bf16(q s), by ~2^-9 a weight: the limits sit
#: between the sound kernel's readings and that fault's
#: (quant_limits.py, PERF.md).
WOL_BF16_TENSOR_LIMIT = 3e-4
WOL_BF16_ROW_LIMIT = 1e-3
#: the megakernels' sites in bf16 (fp, int8 / int4, and the gpt family's
#: layer-norm and gelu sites), the same two measures over each site's
#: outputs (`quant_site_rows`), (tensor, row) limits from the same
#: readings. Every sound site rounds only its outputs: the FFN feeds its
#: f32 activation to the down product as bf16 hi + lo planes, as exact
#: as the plain version's f32 (its one bf16 plane read 1.8e-3 tensor, up
#: to 2.6e-3 a row, and a folded scale only 1.4x above that).
QSITE_BF16_LIMITS = {"fused_qkv_rope_append": (3e-4, 1e-3),
                     "fused_oproj_norm": (3e-4, 1e-3),
                     "fused_ffn": (3e-4, 1e-3)}
INT8, INT4 = "weight_only_int8", "weight_only_int4"
#: bf16 gmm: the kernel and the plain version round the same f32 sums of
#: exact bf16 products once, and differ in summation order only, so a
#: sound kernel differs only where the two sums straddle a rounding
#: boundary (one bf16 step). (tensor, row) limits at ERNIE's shapes
#: (rows of 1536 / 2560): the sound kernel read at most 1.2e-4 / 8.3e-4,
#: partial sums rounded to bf16 per K chunk at least 6.1e-3 / 6.6e-3
#: (gmm_limits.py). The edge cases' rows of 64-256 outputs move by up to
#: ~3e-3 with one such flip, so they are held by the tensor error alone:
#: sound at most 2.4e-5, the per-chunk rounding at least 2.1e-3
GMM_BF16_LIMITS = (3e-4, 2e-3)
GMM_EDGE_TENSOR_LIMIT = 5e-4


def row_rel_errors(got, want):
    """(tensor, row) relative errors of `got` against `want` [M, N]:
    ||got - want|| / ||want|| over the whole output, and the largest of the
    same over its rows, each row's norm floored at 1% of the
    root-mean-square row norm."""
    w = want.float()
    d = got.float() - w
    wn, dn = w.norm(dim=-1), d.norm(dim=-1)
    floor = 1e-2 * float(w.norm()) / wn.numel() ** 0.5
    return (float(d.norm() / w.norm()),
            float((dn / wn.clamp_min(floor)).max()))


# ------------------------------------------------------------------ inputs
def mixed_batch(g):
    """Row tables of one unified step at the 8B geometry: decode slots
    0, 1, 3 at different context lengths, slot 2 idle, a 128-token
    prefill chunk at positions 256..383, one -1 table entry past a
    sequence's length."""
    T, S = SLOTS + CHUNK, SLOTS + 1
    nj = MAX_CTX // PSZ
    P = SLOTS * nj + 1
    kvl = torch.tensor([300, 1024, 0, 517, 256 + CHUNK], dtype=torch.int32)
    nt = torch.tensor([1, 1, 0, 1, CHUNK], dtype=torch.int32)
    perm = 1 + torch.randperm(P - 1, generator=g)
    tables = torch.zeros(S, nj, dtype=torch.int32)
    used = 0
    for i in range(S):
        n = -(-int(kvl[i]) // PSZ)
        tables[i, :n] = perm[used:used + n].to(torch.int32)
        used += n
    tables[0, 30] = -1                  # sentinel past slot 0's 300 tokens
    positions = torch.zeros(T, dtype=torch.long)
    page_idx = torch.zeros(T, dtype=torch.int32)
    page_off = torch.zeros(T, dtype=torch.int32)
    for s in range(SLOTS):
        if nt[s]:
            pos = int(kvl[s]) - 1
            positions[s] = pos
            page_idx[s] = tables[s, pos // PSZ]
            page_off[s] = pos % PSZ
    pos = torch.arange(256, 256 + CHUNK)
    positions[SLOTS:] = pos
    page_idx[SLOTS:] = tables[S - 1, pos // PSZ]
    page_off[SLOTS:] = (pos % PSZ).to(torch.int32)
    seq_start = torch.arange(S, dtype=torch.int32)
    dev = lambda t: t.to(DEV)           # noqa: E731
    return dict(T=T, S=S, P=P, nj=nj, seq_start=dev(seq_start),
                num_tokens=dev(nt), kv_lengths=dev(kvl), tables=dev(tables),
                positions=dev(positions), page_idx=dev(page_idx),
                page_off=dev(page_off))


# ------------------------------------------------------------- phase 2
def check_kernels(timer: Timer):
    g = torch.Generator().manual_seed(0)
    gc = torch.Generator(DEV).manual_seed(0)
    mb = mixed_batch(g)
    T, P = mb["T"], mb["P"]
    cos_t, sin_t = precompute_rope(D, 8192, 500000.0, DEV)
    cos, sin = cos_t[mb["positions"]], sin_t[mb["positions"]]
    tol = {torch.float32: dict(atol=2e-5, rtol=2e-5),
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
    rows = {}

    def rnd(*shape, dtype):
        return torch.randn(*shape, device=DEV, generator=gc).to(dtype)

    for dtype in (torch.bfloat16, torch.float32):
        main = dtype == torch.bfloat16
        tag = "bf16" if main else "f32"

        # rms_norm: [1, T, H] rows, weight in the model dtype
        x, w = rnd(1, T, H, dtype=dtype), rnd(H, dtype=dtype)
        n0 = ops.fused_rms_norm.launches
        out = ops.fused_rms_norm(x, w, 1e-5)
        torch.cuda.synchronize()
        assert ops.fused_rms_norm.launches == n0 + 1
        ref = ops.rms_norm_reference(x, w, 1e-5)
        torch.testing.assert_close(out.float(), ref.float(), **tol[dtype])
        err = max_err(out, ref)
        r = rows.setdefault("fused_rms_norm", {})
        r[f"max_abs_err_{tag}"] = err
        if main:
            b, by = bound(nbytes(x, w, out))
            r.update(max_abs_err=err, bound_ms=b, bound_by=by,
                     ms=timer.ms(lambda: ops.fused_rms_norm(x, w, 1e-5)),
                     plain_ms=timer.ms(
                         lambda: ops.rms_norm_reference(x, w, 1e-5)),
                     library_ms=timer.ms(
                         lambda: torch.nn.functional.rms_norm(
                             x, (H,), w, 1e-5)))

        # rope_append: q/k/v of the step's rows into the 8B page pools
        q, k, v = (rnd(T, HQ, D, dtype=dtype), rnd(T, KV, D, dtype=dtype),
                   rnd(T, KV, D, dtype=dtype))
        kp, vp = (rnd(KV, P, PSZ, D, dtype=dtype),
                  rnd(KV, P, PSZ, D, dtype=dtype))
        kp2, vp2 = kp.clone(), vp.clone()
        args = (q, k, v, cos, sin)
        idx = (mb["page_idx"], mb["page_off"])
        n0 = ops.fused_rope_append.launches
        oq, okp, ovp = ops.fused_rope_append(*args, kp, vp, *idx)
        torch.cuda.synchronize()
        assert ops.fused_rope_append.launches == n0 + 1
        assert okp is kp and ovp is vp
        rq, rkp, rvp = ops.rope_append_reference(*args, kp2, vp2, *idx)
        for a, bb in ((oq, rq), (okp[:, 1:], rkp[:, 1:]),
                      (ovp[:, 1:], rvp[:, 1:])):
            torch.testing.assert_close(a.float(), bb.float(), **tol[dtype])
        err = max(max_err(oq, rq), max_err(okp[:, 1:], rkp[:, 1:]),
                  max_err(ovp[:, 1:], rvp[:, 1:]))
        r = rows.setdefault("fused_rope_append", {})
        r[f"max_abs_err_{tag}"] = err
        if main:
            moved = nbytes(q, k, v, cos, sin, *idx, oq) \
                + 2 * T * KV * D * q.element_size()
            b, by = bound(moved)
            r.update(max_abs_err=err, bound_ms=b, bound_by=by,
                     ms=timer.ms(lambda: ops.fused_rope_append(
                         *args, kp, vp, *idx)),
                     plain_ms=timer.ms(lambda: ops.rope_append_reference(
                         *args, kp2, vp2, *idx)),
                     library_ms=None)

        # ragged attention over the mixed batch
        qa = rnd(T, HQ, D, dtype=dtype)
        tabs = (mb["seq_start"], mb["num_tokens"], mb["kv_lengths"],
                mb["tables"])
        n0 = ops.ragged_paged_attention.launches
        o = ops.ragged_paged_attention(qa, kp, vp, *tabs)
        torch.cuda.synchronize()
        assert ops.ragged_paged_attention.launches == n0 + 1
        ref = ops.ragged_attention_reference(qa, kp, vp, *tabs)
        torch.testing.assert_close(o.float(), ref.float(), **tol[dtype])
        assert float(o[2].float().abs().max()) == 0.0   # idle slot's row
        err = max_err(o, ref)
        r = rows.setdefault("ragged_paged_attention", {})
        r[f"max_abs_err_{tag}"] = err
        if main:
            r.update(max_abs_err=err, **time_ragged(timer, qa, kp, vp, o,
                                                    tabs, dtype))
        check_megakernels(timer, mb, cos, sin, rows, dtype, tol[dtype], gc)
        check_quantized_megakernels(timer, mb, cos, sin, rows, dtype,
                                    tol[dtype], gc)
        check_paged(timer, rows, dtype, gc, *decode_batch(
            g, SLOTS, MAX_CTX // PSZ, [300, 1024, 517, 1], idle=3))
    check_paged(timer, rows, torch.bfloat16, gc, *long_context_batch(g),
                tag="long")
    check_rep_shapes(timer, rows, g, gc, mb)
    check_gpt_kernels(timer, rows, gc, mb)
    check_flash(timer, rows)
    check_weight_only_linear(timer, rows)
    check_gmm(timer, rows)
    return rows


def time_ragged(timer, qa, kp, vp, o, tabs, dtype):
    """The ragged kernel's time over a mixed batch beside its plain
    version and its bound (the live K/V rows, q, o and the tables, or the
    4 H D operations of every visible (query, key) pair, whichever is
    longer), and its time with the prefill chunk idle (a decode-only
    step) beside that step's bytes bound."""
    hq, kv = qa.shape[1], kp.shape[0]
    nt = tabs[1].cpu().tolist()
    kvl = tabs[2].cpu().tolist()
    isz = qa.element_size()
    live = sum(k * kv * D * 2 * isz for k, n in zip(kvl, nt) if n)
    pairs = sum(k - n + t + 1 for k, n in zip(kvl, nt) for t in range(n))
    b, by = bound(nbytes(qa, o, *tabs) + live, 4 * hq * D * pairs, dtype)
    dec = (tabs[0], tabs[1] * (tabs[1] == 1), tabs[2] * (tabs[1] == 1),
           tabs[3])
    dec_live = sum(k * kv * D * 2 * isz for k, n in zip(kvl, nt) if n == 1)
    return dict(
        bound_ms=b, bound_by=by,
        ms=timer.ms(lambda: ops.ragged_paged_attention(qa, kp, vp, *tabs)),
        plain_ms=timer.ms(lambda: ops.ragged_attention_reference(
            qa, kp, vp, *tabs)),
        library_ms=None, live_kv_bytes=live, qk_pairs=pairs,
        decode_only_ms=timer.ms(
            lambda: ops.ragged_paged_attention(qa, kp, vp, *dec)),
        decode_only_bound_ms=bound(nbytes(qa, o, *tabs) + dec_live)[0])


#: the query / KV heads of the two geometries the Llama-3-8B shapes leave
#: untried: GPT-3 6.7B's MHA (rep 1) and Qwen2-7B's 28 / 4 (rep 7)
REP_SHAPES = {"rep1": (32, 32), "rep7": (28, 4)}


def check_rep_shapes(timer, rows, g, gc, mb):
    """The ragged kernel over the mixed batch and both paged decode
    kernels over the alternating decode batch at REP_SHAPES, bf16, each
    against its plain version (ragged at 2e-2, paged by
    `assert_paged_bf16`) and timed beside it and its bound; readings
    under rows[name][rep]."""
    dtype = torch.bfloat16
    T, P = mb["T"], mb["P"]
    tabs = (mb["seq_start"], mb["num_tokens"], mb["kv_lengths"],
            mb["tables"])
    dec = decode_batch(g, SLOTS, MAX_CTX // PSZ, [300, 1024, 517, 1],
                       idle=3)
    for tag, (hq, kv) in REP_SHAPES.items():
        def rnd(*shape):
            return torch.randn(*shape, device=DEV, generator=gc).to(dtype)

        qa, kp, vp = rnd(T, hq, D), rnd(kv, P, PSZ, D), rnd(kv, P, PSZ, D)
        n0 = ops.ragged_paged_attention.launches
        o = ops.ragged_paged_attention(qa, kp, vp, *tabs)
        torch.cuda.synchronize()
        assert ops.ragged_paged_attention.launches == n0 + 1
        ref = ops.ragged_attention_reference(qa, kp, vp, *tabs)
        torch.testing.assert_close(o.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2)
        rows["ragged_paged_attention"][tag] = dict(
            heads=hq, kv_heads=kv, max_abs_err=max_err(o, ref),
            **time_ragged(timer, qa, kp, vp, o, tabs, dtype))
        del qa, kp, vp
        args = paged_batch(gc, dtype, *dec, heads=hq, kv_heads=kv)
        ref = ops.paged_decode_reference(*args)
        live = int(dec[1].sum()) * kv * D * 2 * args[0].element_size()
        for fn in (ops.paged_decode_attention, ops.paged_decode_attention_v2):
            n0 = fn.launches
            out = fn(*args)
            torch.cuda.synchronize()
            assert fn.launches == n0 + 1
            tensor, head = assert_paged_bf16(fn.__name__, out, ref)
            b_, by = bound(live + nbytes(args[0], out, dec[1], dec[2]))
            rows[fn.__name__][tag] = dict(
                heads=hq, kv_heads=kv, max_abs_err=max_err(out, ref),
                rel_err_bf16={"tensor": tensor, "head": head},
                bound_ms=b_, bound_by=by, ms=timer.ms(lambda: fn(*args)),
                plain_ms=timer.ms(
                    lambda: ops.paged_decode_reference(*args)),
                library_ms=None, live_kv_bytes=live)
        del args


def check_gpt_kernels(timer, rows, gc, mb):
    """The gpt family's kernel pieces at GPT-3 6.7B's step shapes (T =
    SLOTS + CHUNK rows, hidden 4096, FFN 16384), bf16 and f32, each
    against its plain version: fused_layer_norm (at 2e-2 / 2e-5), the
    layer-norm site of fused_oproj_norm with the o-proj bias and the gelu
    site of fused_ffn with b1 / b2 (bf16 also by `row_rel_errors` within
    QSITE_BF16_LIMITS). The residual stream carries a mean of 3 (the
    two-pass variance). bf16 is timed beside the plain version, the bound,
    F.layer_norm (`library_ms`) or the split chain's calls (`split_ms`:
    cuBLAS + fused_layer_norm; the cuBLAS + F.gelu chain). Readings under
    rows["fused_layer_norm"], rows["fused_oproj_norm"]["layer"] and
    rows["fused_ffn"]["gelu"]."""
    T = mb["T"]
    H, I = GPT_H, GPT_FFN
    F = torch.nn.functional
    for dtype in (torch.bfloat16, torch.float32):
        main = dtype == torch.bfloat16
        tag = "bf16" if main else "f32"
        tol = dict(atol=2e-2, rtol=2e-2) if main else \
            dict(atol=2e-5, rtol=2e-5)

        def rnd(*shape, scale=1.0, shift=0.0):
            return (torch.randn(*shape, device=DEV, generator=gc) * scale
                    + shift).to(dtype)

        def hold(name, got, ref, site):
            got, ref = ((got, ref) if isinstance(got, tuple)
                        else ((got,), (ref,)))
            for a, b_ in zip(got, ref):
                torch.testing.assert_close(a.float(), b_.float(), **tol)
            r = rows.setdefault(name, {})
            if site:
                r = r.setdefault(site, {})
            r[f"max_abs_err_{tag}"] = max(max_err(a, b_)
                                          for a, b_ in zip(got, ref))
            if main:
                r["max_abs_err"] = r[f"max_abs_err_{tag}"]
                tensor, row = row_rel_errors(torch.cat(got, 1),
                                             torch.cat(ref, 1))
                r["rel_err_bf16"] = {"tensor": tensor, "row": row}
                if site:
                    lt, lr = QSITE_BF16_LIMITS[name]
                    assert tensor <= lt and row <= lr, (name, site, tensor,
                                                        row)
            return r

        x, w, b = rnd(T, H, shift=3.0), rnd(H), rnd(H)
        n0 = ops.fused_layer_norm.launches
        out = ops.fused_layer_norm(x, w, b, 1e-5)
        torch.cuda.synchronize()
        assert ops.fused_layer_norm.launches == n0 + 1
        r = hold("fused_layer_norm", out,
                 ops.layer_norm_reference(x, w, b, 1e-5), None)
        if main:
            b_, by = bound(nbytes(x, w, b, out))
            r.update(bound_ms=b_, bound_by=by,
                     ms=timer.ms(lambda: ops.fused_layer_norm(x, w, b,
                                                              1e-5)),
                     plain_ms=timer.ms(
                         lambda: ops.layer_norm_reference(x, w, b, 1e-5)),
                     library_ms=timer.ms(
                         lambda: F.layer_norm(x, (H,), w, b, 1e-5)))

        o, wo = rnd(T, H), rnd(H, H, scale=H ** -0.5)
        bo, nw, nb = rnd(H), rnd(H), rnd(H)
        kw = dict(eps=1e-5, norm="layer")
        n0 = ops.fused_oproj_norm.launches
        got = ops.fused_oproj_norm(o, x, wo, None, bo, nw, nb, **kw)
        torch.cuda.synchronize()
        assert ops.fused_oproj_norm.launches == n0 + 1
        r = hold("fused_oproj_norm", got, ops.oproj_norm_reference(
            o, x, wo, None, bo, nw, nb, **kw), "layer")
        if main:
            b_, by = bound(nbytes(o, x, wo, bo, nw, nb) + 2 * nbytes(x),
                           2 * T * H * H, dtype)
            r.update(
                bound_ms=b_, bound_by=by, library_ms=None,
                ms=timer.ms(lambda: ops.fused_oproj_norm(
                    o, x, wo, None, bo, nw, nb, **kw)),
                plain_ms=timer.ms(lambda: ops.oproj_norm_reference(
                    o, x, wo, None, bo, nw, nb, **kw)),
                split_ms=timer.ms(lambda: ops.fused_layer_norm(
                    x + (o @ wo + bo), nw, nb, 1e-5)))
        del o, wo

        h = rnd(T, H)
        wi, wf = rnd(H, I, scale=H ** -0.5), rnd(I, H, scale=I ** -0.5)
        bi, bf = rnd(I), rnd(H)
        args = (h, x, wi, None, None, None, wf, None, bi, bf)
        n0 = ops.fused_ffn.launches
        got = ops.fused_ffn(*args, act="gelu")
        torch.cuda.synchronize()
        assert ops.fused_ffn.launches == n0 + 1
        r = hold("fused_ffn", got,
                 ops.megadecode_ffn_reference(*args, act="gelu"), "gelu")
        if main:
            b_, by = bound(nbytes(h, x, wi, wf, bi, bf) + nbytes(x),
                           2 * 2 * T * H * I, dtype)
            r.update(
                bound_ms=b_, bound_by=by, library_ms=None,
                ms=timer.ms(lambda: ops.fused_ffn(*args, act="gelu")),
                plain_ms=timer.ms(lambda: ops.megadecode_ffn_reference(
                    *args, act="gelu")),
                split_ms=timer.ms(lambda: x + (F.gelu(
                    h @ wi + bi, approximate="tanh") @ wf + bf)))
        del h, wi, wf


def decode_batch(g, B, nj, lengths, idle=None):
    """Page tables of one alternating decode step: sequence b's lengths[b]
    rows on its own random pages of a pool of B * nj + 1 pages; row
    `idle` is an idle slot (all of its table on the trash page 0, length
    1, as the engine sends it); a -1 past sequence 0's live pages."""
    P = B * nj + 1
    perm = 1 + torch.randperm(P - 1, generator=g)
    tables = torch.zeros(B, nj, dtype=torch.int32)
    used = 0
    for b, n in enumerate(lengths):
        if b == idle:
            continue
        k = -(-n // PSZ)
        tables[b, :k] = perm[used:used + k].to(torch.int32)
        used += k
    if lengths[0] <= (nj - 1) * PSZ:
        tables[0, -1] = -1
    lens = torch.tensor(lengths, dtype=torch.int32)
    return P, lens.to(DEV), tables.to(DEV)


def long_context_batch(g):
    """LONG_SEQS sequences with tables of LONG_CTX tokens; seeded lengths
    that include 1 and LONG_CTX."""
    rng = np.random.RandomState(5)
    lengths = [1, LONG_CTX] + [int(n) for n in
                               rng.randint(1, LONG_CTX + 1, LONG_SEQS - 2)]
    return decode_batch(g, LONG_SEQS, LONG_CTX // PSZ, lengths)


def paged_batch(gc, dtype, P, lens, tables, heads=None, kv_heads=None):
    """(q, k_pages, v_pages, lengths, tables) of one paged decode batch
    at `heads` query heads over `kv_heads` (the 8B heads by default),
    drawn from `gc`."""
    B = lens.shape[0]
    heads, kv_heads = heads or HQ, kv_heads or KV

    def rnd(*shape):
        return torch.randn(*shape, device=DEV, generator=gc).to(dtype)

    return rnd(B, heads, D), rnd(kv_heads, P, PSZ, D), \
        rnd(kv_heads, P, PSZ, D), lens, tables


def check_paged(timer, rows, dtype, gc, P, lens, tables, tag=None):
    """Both paged decode kernels at one batch against their plain
    version (f32 at 2e-5, bf16 by `assert_paged_bf16`); in bf16 timed
    beside it and the bytes bound (the live K/V rows, q, o and the
    tables; no single PyTorch call reads a paged cache, so library_ms is
    None). `tag` prefixes the keys of a second shape."""
    main = dtype == torch.bfloat16
    dt = "bf16" if main else "f32"
    args = paged_batch(gc, dtype, P, lens, tables)
    q = args[0]
    ref = ops.paged_decode_reference(*args)
    live = int(lens.sum()) * KV * D * 2 * q.element_size()
    for fn in (ops.paged_decode_attention, ops.paged_decode_attention_v2):
        name = fn.__name__
        n0 = fn.launches
        out = fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1
        r = rows.setdefault(name, {})
        pre = f"{tag}_" if tag else ""
        if main:
            r[f"{pre}rel_err_bf16"] = dict(zip(
                ("tensor", "head"), assert_paged_bf16(name, out, ref)))
        else:
            torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
        err = max_err(out, ref)
        r[f"{pre}max_abs_err_{dt}"] = err
        if not main:
            continue
        b_, by = bound(live + nbytes(q, out, lens, tables))
        timed = {"max_abs_err": err, "bound_ms": b_, "bound_by": by,
                 "ms": timer.ms(lambda: fn(*args)),
                 "plain_ms": timer.ms(
                     lambda: ops.paged_decode_reference(*args)),
                 "library_ms": None, "live_kv_bytes": live,
                 "lengths": lens.tolist()}
        if name == "paged_decode_attention_v2":
            timed["pages_per_group"] = min(
                ops.default_pages_per_group(tables.shape[1], PSZ, D,
                                            q.element_size()),
                paged.max_pages_per_group(PSZ, D, HQ // KV, q.dtype))
        r.update({pre + k: v for k, v in timed.items()})


def check_megakernels(timer, mb, cos, sin, rows, dtype, tol, gc):
    """The fused chain's three kernels at the 8B step's shapes, each
    against its plain version and, in bf16, timed beside the split-chain
    calls that compute the same function (`split_ms`). Weights are drawn
    at scale K^-0.5, so activations stay O(1) as in a trained model."""
    main = dtype == torch.bfloat16
    tag = "bf16" if main else "f32"
    T, P = mb["T"], mb["P"]
    N = (HQ + 2 * KV) * D
    isz = torch.tensor([], dtype=dtype).element_size()

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, device=DEV, generator=gc)
                * scale).to(dtype)

    def record(name, got, ref):
        """The site's readings, taken before the timed calls write the
        pools again; bf16 also held by `row_rel_errors` over
        `quant_site_rows` within QSITE_BF16_LIMITS, as the quantized
        sites are."""
        err = max(max_err(a, b) for a, b in zip(got, ref))
        r = rows.setdefault(name, {})
        r[f"max_abs_err_{tag}"] = err
        if main:
            tensor, row = row_rel_errors(quant_site_rows(name, got, idx),
                                         quant_site_rows(name, ref, idx))
            lt, lr = QSITE_BF16_LIMITS[name]
            assert tensor <= lt and row <= lr, (name, tensor, row)
            r.update(max_abs_err=err, library_ms=None,
                     rel_err_bf16={"tensor": tensor, "row": row})
        return r

    # qkv projection + rope + paged append, one [H, (HQ + 2 KV) D] slab
    h, w = rnd(T, H), rnd(H, N, scale=H ** -0.5)
    kp, vp = rnd(KV, P, PSZ, D), rnd(KV, P, PSZ, D)
    kp2, vp2 = kp.clone(), vp.clone()
    idx = (mb["page_idx"], mb["page_off"])
    kw = dict(heads=HQ, kv_heads=KV, head_dim=D)
    n0 = ops.fused_qkv_rope_append.launches
    q, okp, ovp = ops.fused_qkv_rope_append(h, w, None, None, cos, sin, kp,
                                            vp, *idx, **kw)
    torch.cuda.synchronize()
    assert ops.fused_qkv_rope_append.launches == n0 + 1
    assert okp is kp and ovp is vp
    ref = ops.qkv_rope_append_reference(h, w, None, None, cos, sin, kp2,
                                        vp2, *idx, **kw)
    for a, b in zip((q, okp, ovp), ref):     # one idle row: pools whole
        torch.testing.assert_close(a.float(), b.float(), **tol)
    r = record("fused_qkv_rope_append", (q, okp, ovp), ref)
    if main:
        wq, wk, wv = (w[:, :HQ * D].contiguous(),
                      w[:, HQ * D:(HQ + KV) * D].contiguous(),
                      w[:, (HQ + KV) * D:].contiguous())
        b_, by = bound(nbytes(h, w, cos, sin, *idx, q)
                       + 2 * T * KV * D * isz, 2 * T * H * N, dtype)
        r.update(
            bound_ms=b_, bound_by=by,
            ms=timer.ms(lambda: ops.fused_qkv_rope_append(
                h, w, None, None, cos, sin, kp, vp, *idx, **kw)),
            plain_ms=timer.ms(lambda: ops.qkv_rope_append_reference(
                h, w, None, None, cos, sin, kp2, vp2, *idx, **kw)),
            split_ms=timer.ms(lambda: ops.fused_rope_append(
                (h @ wq).view(T, HQ, D), (h @ wk).view(T, KV, D),
                (h @ wv).view(T, KV, D), cos, sin, kp2, vp2, *idx)))

    # o-proj + residual + rms norm
    o, x = rnd(T, HQ * D), rnd(T, H)
    wo, nw = rnd(HQ * D, H, scale=(HQ * D) ** -0.5), rnd(H)
    n0 = ops.fused_oproj_norm.launches
    got = ops.fused_oproj_norm(o, x, wo, None, None, nw, eps=1e-5)
    torch.cuda.synchronize()
    assert ops.fused_oproj_norm.launches == n0 + 1
    ref = ops.oproj_norm_reference(o, x, wo, None, None, nw, eps=1e-5)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.float(), b.float(), **tol)
    r = record("fused_oproj_norm", got, ref)
    if main:
        b_, by = bound(nbytes(o, x, wo, nw) + 2 * nbytes(x),
                       2 * T * HQ * D * H, dtype)
        r.update(
            bound_ms=b_, bound_by=by,
            ms=timer.ms(lambda: ops.fused_oproj_norm(
                o, x, wo, None, None, nw, eps=1e-5)),
            plain_ms=timer.ms(lambda: ops.oproj_norm_reference(
                o, x, wo, None, None, nw, eps=1e-5)),
            split_ms=timer.ms(lambda: ops.fused_rms_norm(x + o @ wo, nw,
                                                         1e-5)))

    # gate/up + swiglu + down + residual
    hh = rnd(T, H)
    wg, wu = rnd(H, FFN, scale=H ** -0.5), rnd(H, FFN, scale=H ** -0.5)
    wd = rnd(FFN, H, scale=FFN ** -0.5)
    n0 = ops.fused_ffn.launches
    got = ops.fused_ffn(hh, x, wg, None, wu, None, wd, None)
    torch.cuda.synchronize()
    assert ops.fused_ffn.launches == n0 + 1
    ref = ops.megadecode_ffn_reference(hh, x, wg, None, wu, None, wd, None)
    torch.testing.assert_close(got.float(), ref.float(), **tol)
    r = record("fused_ffn", (got,), (ref,))
    if main:
        silu = torch.nn.functional.silu
        b_, by = bound(nbytes(hh, x, wg, wu, wd) + nbytes(x),
                       3 * 2 * T * H * FFN, dtype)
        r.update(
            bound_ms=b_, bound_by=by,
            ms=timer.ms(lambda: ops.fused_ffn(hh, x, wg, None, wu, None, wd,
                                              None)),
            plain_ms=timer.ms(lambda: ops.megadecode_ffn_reference(
                hh, x, wg, None, wu, None, wd, None)),
            split_ms=timer.ms(lambda: x + (silu(hh @ wg) * (hh @ wu)) @ wd))


def quant_site_rows(name, outs, idx):
    """One [T, X] tensor of a megakernel site's outputs (a tuple), a row
    per token: qkv_rope_append's q and the K / V rows it wrote into the
    pools at `idx` (page, offset), oproj_norm's x_new and h, fused_ffn's
    out."""
    if name == "fused_qkv_rope_append":
        q, kp, vp = outs
        T = q.shape[0]
        pg, off = idx[0].long(), idx[1].long()
        return torch.cat([q.reshape(T, -1)] + [
            p_[:, pg, off].transpose(0, 1).reshape(T, -1)
            for p_ in (kp, vp)], dim=1)
    return torch.cat(outs, dim=1)


def check_quantized_megakernels(timer, mb, cos, sin, rows, dtype, tol, gc,
                                hold: bool = True):
    """The int8 and int4 sites of the three megakernels at the 8B step's
    shapes, each against its plain version at the fp tolerance and, in
    bf16, by `row_rel_errors` over `quant_site_rows` within
    QSITE_BF16_LIMITS; in bf16 (with a `timer`) timed beside it, the
    bound (the quantized weight's bytes and the activations at the HBM
    rate, or the bf16 operations) and `split_ms`: the split chain's calls
    on the dequantized bf16 weights, what quantizing has to beat.
    Readings go under rows[name]["int8" / "int4"]; `hold` False only
    reads (quant_limits.py on planted faults)."""
    bf16 = dtype == torch.bfloat16
    main = bf16 and timer is not None
    tag = "bf16" if bf16 else "f32"
    T, P = mb["T"], mb["P"]
    N = (HQ + 2 * KV) * D
    isz = torch.tensor([], dtype=dtype).element_size()
    idx = (mb["page_idx"], mb["page_off"])
    silu = torch.nn.functional.silu

    def rnd(*shape, scale=1.0, dt=dtype):
        return (torch.randn(*shape, device=DEV, generator=gc)
                * scale).to(dt)

    for algo in (INT8, INT4):
        def quantized(k, n):
            return ops.weight_quantize(rnd(k, n, scale=k ** -0.5,
                                           dt=torch.float32), algo)

        def dq(w, s_):
            return ops.weight_dequantize(w, s_, algo).to(dtype)

        def record(name, got, ref):
            got, ref = ((got, ref) if isinstance(got, tuple)
                        else ((got,), (ref,)))
            if hold:
                for a, b in zip(got, ref):
                    torch.testing.assert_close(a.float(), b.float(), **tol)
            err = max(max_err(a, b) for a, b in zip(got, ref))
            r = rows.setdefault(name, {}).setdefault(algo[12:], {})
            r[f"max_abs_err_{tag}"] = err
            if bf16:
                tensor, row = row_rel_errors(quant_site_rows(name, got, idx),
                                             quant_site_rows(name, ref, idx))
                r["rel_err_bf16"] = {"tensor": tensor, "row": row}
                lt, lr = QSITE_BF16_LIMITS[name]
                assert not hold or tensor <= lt, (name, algo, tensor)
                assert not hold or row <= lr, (name, algo, row)
            if main:
                r.update(max_abs_err=err, library_ms=None)
            return r

        # qkv + rope + paged append
        h = rnd(T, H)
        qw, sw = quantized(H, N)
        kp, vp = rnd(KV, P, PSZ, D), rnd(KV, P, PSZ, D)
        kp2, vp2 = kp.clone(), vp.clone()
        kw = dict(heads=HQ, kv_heads=KV, head_dim=D, algo=algo)
        n0 = ops.fused_qkv_rope_append.launches
        got = ops.fused_qkv_rope_append(h, qw, sw, None, cos, sin, kp, vp,
                                        *idx, **kw)
        torch.cuda.synchronize()
        assert ops.fused_qkv_rope_append.launches == n0 + 1
        ref = ops.qkv_rope_append_reference(h, qw, sw, None, cos, sin, kp2,
                                            vp2, *idx, **kw)
        # held before the timed calls write the pools again
        r = record("fused_qkv_rope_append", got, ref)
        if main:
            w_ = dq(qw, sw)
            wq, wk, wv = (w_[:, :HQ * D].contiguous(),
                          w_[:, HQ * D:(HQ + KV) * D].contiguous(),
                          w_[:, (HQ + KV) * D:].contiguous())
            b_, by = bound(nbytes(h, qw, sw, cos, sin, *idx, got[0])
                           + 2 * T * KV * D * isz, 2 * T * H * N, dtype)
            r.update(
                bound_ms=b_, bound_by=by,
                ms=timer.ms(lambda: ops.fused_qkv_rope_append(
                    h, qw, sw, None, cos, sin, kp, vp, *idx, **kw)),
                plain_ms=timer.ms(lambda: ops.qkv_rope_append_reference(
                    h, qw, sw, None, cos, sin, kp2, vp2, *idx, **kw)),
                split_ms=timer.ms(lambda: ops.fused_rope_append(
                    (h @ wq).view(T, HQ, D), (h @ wk).view(T, KV, D),
                    (h @ wv).view(T, KV, D), cos, sin, kp2, vp2, *idx)))
            del w_, wq, wk, wv

        # o-proj + residual + rms norm
        o, x, nw = rnd(T, HQ * D), rnd(T, H), rnd(H)
        qw, sw = quantized(HQ * D, H)
        n0 = ops.fused_oproj_norm.launches
        got = ops.fused_oproj_norm(o, x, qw, sw, None, nw, eps=1e-5,
                                   algo=algo)
        torch.cuda.synchronize()
        assert ops.fused_oproj_norm.launches == n0 + 1
        ref = ops.oproj_norm_reference(o, x, qw, sw, None, nw, eps=1e-5,
                                       algo=algo)
        r = record("fused_oproj_norm", got, ref)
        if main:
            wo = dq(qw, sw)
            b_, by = bound(nbytes(o, x, qw, sw, nw) + 2 * nbytes(x),
                           2 * T * HQ * D * H, dtype)
            r.update(
                bound_ms=b_, bound_by=by,
                ms=timer.ms(lambda: ops.fused_oproj_norm(
                    o, x, qw, sw, None, nw, eps=1e-5, algo=algo)),
                plain_ms=timer.ms(lambda: ops.oproj_norm_reference(
                    o, x, qw, sw, None, nw, eps=1e-5, algo=algo)),
                split_ms=timer.ms(lambda: ops.fused_rms_norm(
                    x + o @ wo, nw, 1e-5)))
            del wo

        # gate/up + swiglu + down + residual
        hh = rnd(T, H)
        ws = [quantized(H, FFN), quantized(H, FFN), quantized(FFN, H)]
        args = [t for pair in ws for t in pair]
        n0 = ops.fused_ffn.launches
        got = ops.fused_ffn(hh, x, *args, algo=algo)
        torch.cuda.synchronize()
        assert ops.fused_ffn.launches == n0 + 1
        ref = ops.megadecode_ffn_reference(hh, x, *args, algo=algo)
        r = record("fused_ffn", got, ref)
        if main:
            wg, wu, wd = (dq(*pair) for pair in ws)
            b_, by = bound(nbytes(hh, x, *args) + nbytes(x),
                           3 * 2 * T * H * FFN, dtype)
            r.update(
                bound_ms=b_, bound_by=by,
                ms=timer.ms(lambda: ops.fused_ffn(hh, x, *args, algo=algo)),
                plain_ms=timer.ms(lambda: ops.megadecode_ffn_reference(
                    hh, x, *args, algo=algo)),
                split_ms=timer.ms(
                    lambda: x + (silu(hh @ wg) * (hh @ wu)) @ wd))
            del wg, wu, wd


#: K rows that one (scale, zero) pair of torch._weight_int4pack_mm
#: covers, and the inner k tiles of its packed layout
INT4PACK_GROUP, INT4PACK_INNER_K_TILES = 128, 8


def int4pack_operands(qw, sw, dtype):
    """A packed int4 weight of this port (per-column symmetric, nibbles
    -8..7, the even row low) as the operands of
    torch._weight_int4pack_mm, which computes x @ ((u - 8) s_g + z_g)
    for every group g of INT4PACK_GROUP rows from nibbles u in 0..15:
    u = q + 8, [N, K/2] bytes with the even row in the high nibble,
    packed once by _convert_weight_to_int4pack; (s_g, z_g) = (the
    column's scale in `dtype`, 0) in every group. A yardstick only: the
    port never calls it."""
    lo, hi = (p_.to(torch.int32) + 8 for p_ in ops.int4_planes(qw))
    b = ((lo << 4) | hi).to(torch.uint8).t().contiguous()
    sz = torch.stack([sw.to(dtype), torch.zeros_like(sw, dtype=dtype)], -1)
    sz = sz[None].expand(2 * qw.shape[0] // INT4PACK_GROUP, -1, -1)
    return (torch._convert_weight_to_int4pack(b, INT4PACK_INNER_K_TILES),
            sz.contiguous())


def check_weight_only_linear(timer, rows):
    """weight_only_linear, int8 and int4, bf16 and f32, against its plain
    version at the 8B step's largest layer product (T = 132 rows x [4096
    -> 14336]), the int4 LM head of a decode step (M = 5 x [4096 ->
    128256]) and a ragged case (odd M, N = 1000: byte copies, a masked
    last column tile); f32 at 2e-5, bf16 by `row_rel_errors`. In bf16
    timed beside its plain version, its bound, `split_ms` (bf16
    torch.matmul on the dequantized weight: what quantizing has to beat)
    and, at the layer and head shapes, torch._weight_int8pack_mm (int8)
    or torch._weight_int4pack_mm (int4, `int4pack_operands`) (library_ms,
    yardsticks the port never calls, each first held to the plain version
    within 1e-2 relative: they take bf16 scales). The row's headline
    numbers are int4 at the layer shape (the split chain's 7 a layer);
    every case is under "cases"."""
    gc_ = torch.Generator(DEV).manual_seed(4)
    shapes = {"layer": (SLOTS + CHUNK, H, FFN),
              "head": (SLOTS + 1, H, VOCAB), "ragged": (7, H, 1000)}
    r = rows.setdefault("weight_only_linear", {"cases": {}})
    wol, ref_fn = ops.weight_only_linear, ops.weight_only_linear_reference
    for algo in (INT8, INT4):
        for shape, (M, K, N) in shapes.items():
            qw, sw = ops.weight_quantize(torch.randn(
                K, N, device=DEV, generator=gc_) * K ** -0.5, algo)
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn(M, K, device=DEV, generator=gc_).to(dtype)
                n0 = wol.launches
                got = wol(x, qw, sw, algo=algo)
                torch.cuda.synchronize()
                assert wol.launches == n0 + 1
                want = ref_fn(x, qw, sw, algo=algo)
                assert torch.isfinite(got).all()
                case = {"m": M, "k": K, "n": N,
                        "max_abs_err": max_err(got, want)}
                key = f"{algo[12:]}/{shape}/"
                if dtype == torch.float32:
                    torch.testing.assert_close(got, want, atol=2e-5,
                                               rtol=2e-5)
                    r["cases"][key + "f32"] = case
                    continue
                tensor, row = row_rel_errors(got, want)
                assert tensor <= WOL_BF16_TENSOR_LIMIT, (key, tensor)
                assert row <= WOL_BF16_ROW_LIMIT, (key, row)
                wdq = ops.weight_dequantize(qw, sw, algo).to(dtype)
                b_, by = bound(nbytes(x, qw, sw, got), 2 * M * K * N, dtype)
                case.update(
                    rel_err_bf16={"tensor": tensor, "row": row},
                    bound_ms=b_, bound_by=by,
                    ms=timer.ms(lambda: wol(x, qw, sw, algo=algo)),
                    plain_ms=timer.ms(lambda: ref_fn(x, qw, sw, algo=algo)),
                    split_ms=timer.ms(lambda: x @ wdq), library_ms=None)
                del wdq
                if shape != "ragged":
                    if algo == INT8:
                        w_nk, sb = qw.t().contiguous(), sw.to(dtype)
                        lib = lambda: torch._weight_int8pack_mm(  # noqa: E731
                            x, w_nk, sb)
                    else:
                        wp, sz = int4pack_operands(qw, sw, dtype)
                        lib = lambda: torch._weight_int4pack_mm(  # noqa: E731
                            x, wp, INT4PACK_GROUP, sz)
                    # the yardstick computes this function, but for its
                    # scales rounded to bf16 (~2^-9 a column)
                    lt, _ = row_rel_errors(lib(), want)
                    assert lt <= 1e-2, (key, "library", lt)
                    case.update(library_ms=timer.ms(lib),
                                library_rel_err_tensor=lt)
                    del lib
                r["cases"][key + "bf16"] = case
    head = r["cases"]["int4/layer/bf16"]
    r.update({k: head[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms",
                                   "split_ms")})


def routed_group_sizes(tokens: int, E: int, k: int, H_: int, seed: int,
                       live=None):
    """Group sizes [E] int32 of `tokens` tokens routed top-k over E
    experts by a seeded f32 router on the card (x @ gate, softmax, the
    experts in rank order), as the dropless FFN sorts its rows. With
    `live`, the rows from `live` on are one repeated row: the engine's
    unified step pads its rows past the live tokens with token 0 at
    position 0, whose attention output is zero, so every padding row has
    one FFN input and the router sends them all to the same k experts."""
    g = torch.Generator(DEV).manual_seed(seed)
    x = torch.randn(tokens, H_, device=DEV, generator=g)
    if live is not None:
        x[live:] = x[live]
    gate = 0.02 * torch.randn(H_, E, device=DEV, generator=g)
    gates = torch.softmax(x @ gate, -1)
    topi = torch.sort(gates, dim=-1, descending=True, stable=True)[1][:, :k]
    return torch.zeros(E, dtype=torch.int32, device=DEV).scatter_add_(
        0, topi.reshape(-1), torch.ones(tokens * k, dtype=torch.int32,
                                        device=DEV))


def check_gmm(timer, rows, hold: bool = True):
    """gmm against its plain version (each group's rows times its weight
    in f32, one cast) at ERNIE-4.5-21B-A3B's experts, the gate / up
    product [2560 -> 1536] and the down product [1536 -> 2560], under the
    three routings the path gives it: a decode step of the unified engine
    (MOE_STEP_TOKENS rows, SLOTS of them live, the rest padding that
    routes as one row: ~6 groups of ~130 rows and ~24 single rows; M
    792), a mixed step (all MOE_STEP_TOKENS rows live, a prefill chunk
    with the decodes: ~12 rows a group over all 64 experts) and
    generate_cached's prefill (M 12288); and edge cases with rows past
    the last group, empty groups, one group holding every row and N 64
    (the tiny preset's expert width). bf16 by `row_rel_errors` over the
    grouped rows: the ERNIE cases within GMM_BF16_LIMITS, the edge cases
    by their tensor error within GMM_EDGE_TENSOR_LIMIT; f32 at 2e-5; the
    rows past the last group exactly zero. The ERNIE cases in bf16 (with
    a `timer`) are timed beside the plain version, the bound (the lhs
    rows, the weight slabs of the groups that hold rows, the output; or 2
    M K N operations at the working type's peak) and torch._grouped_mm
    over the same group ends (library_ms, bf16 on sm_90; a yardstick the
    port never calls, first held to the plain version within 1e-2
    relative). The row's headline numbers are the decode step's gate /
    up product in bf16. `hold` False only reads (gmm_limits.py on
    planted faults)."""
    cfg = ERNIE45_21B_A3B
    E, k = cfg["num_experts"], cfg["top_k"]
    Hm, Im = cfg["hidden_size"], cfg["moe_intermediate_size"]
    gc_ = torch.Generator(DEV).manual_seed(5)
    decode = routed_group_sizes(MOE_STEP_TOKENS, E, k, Hm, 2, live=SLOTS)
    mixed = routed_group_sizes(MOE_STEP_TOKENS, E, k, Hm, 0)
    prefill = routed_group_sizes(MOE_PREFILL_TOKENS, E, k, Hm, 1)

    def sizes(*n):
        return torch.tensor(n, dtype=torch.int32, device=DEV)

    cases = {"decode/up": (Hm, Im, decode, 0),
             "decode/down": (Im, Hm, decode, 0),
             "mixed/up": (Hm, Im, mixed, 0), "mixed/down": (Im, Hm, mixed, 0),
             "prefill/up": (Hm, Im, prefill, 0),
             "prefill/down": (Im, Hm, prefill, 0),
             "edge/uneven": (128, 256, sizes(100, 0, 200, 150, 62), 88),
             "edge/one_group": (128, 128, sizes(0, 300, 0), 0),
             "edge/n64": (128, 64, sizes(10, 0, 25, 5), 30)}
    lt, lr = GMM_BF16_LIMITS
    r = rows.setdefault("gmm", {"cases": {}})
    for key, (K, N, gs, tail) in cases.items():
        M = int(gs.sum()) + tail
        edge = key.startswith("edge")
        for dtype in (torch.bfloat16, torch.float32):
            lhs = torch.randn(M, K, device=DEV, generator=gc_).to(dtype)
            rhs = (K ** -0.5 * torch.randn(gs.numel(), K, N, device=DEV,
                                           generator=gc_)).to(dtype)
            n0 = ops.gmm.launches
            with torch.no_grad():
                got = ops.gmm(lhs, rhs, gs)
            torch.cuda.synchronize()
            assert ops.gmm.launches == n0 + 1
            want = ops.gmm_plain(lhs, rhs, gs)
            end = M - tail
            tail_zero = int(got[end:].count_nonzero()) == 0
            finite = bool(torch.isfinite(got).all())
            assert not hold or (tail_zero and finite), key
            case = {"m": M, "k": K, "n": N, "groups": gs.numel(),
                    "groups_with_rows": int((gs > 0).sum()),
                    "largest_group": int(gs.max()),
                    "max_abs_err": max_err(got, want),
                    "tail_zero": tail_zero, "finite": finite}
            tag = key + ("/bf16" if dtype == torch.bfloat16 else "/f32")
            if dtype == torch.float32:
                case["close_2e-5"] = bool(torch.isclose(
                    got, want, atol=2e-5, rtol=2e-5).all())
                if hold:
                    torch.testing.assert_close(got, want, atol=2e-5,
                                               rtol=2e-5)
                r["cases"][tag] = case
                continue
            tensor, row = row_rel_errors(got[:end], want[:end])
            case["rel_err_bf16"] = {"tensor": tensor, "row": row}
            if edge:
                assert not hold or tensor <= GMM_EDGE_TENSOR_LIMIT, \
                    (tag, tensor)
            else:
                assert not hold or (tensor <= lt and row <= lr), \
                    (tag, tensor, row)
            if not edge and timer is not None:
                live = int((gs > 0).sum())
                b_, by = bound(nbytes(lhs, got, gs)
                               + live * K * N * rhs.element_size(),
                               2 * M * K * N, dtype)
                ends = torch.cumsum(gs, 0, dtype=torch.int32)
                lib = lambda: torch._grouped_mm(  # noqa: E731
                    lhs, rhs, offs=ends)
                lib_t, _ = row_rel_errors(lib(), want)
                assert lib_t <= 1e-2, (tag, "library", lib_t)
                case.update(
                    bound_ms=b_, bound_by=by,
                    ms=timer.ms(lambda: ops.gmm(lhs, rhs, gs)),
                    plain_ms=timer.ms(lambda: ops.gmm_plain(lhs, rhs, gs)),
                    library_ms=timer.ms(lib),
                    library_rel_err_tensor=lib_t)
                del lib
            r["cases"][tag] = case
            del lhs, rhs, got, want
    if timer is not None:
        head = r["cases"]["decode/up/bf16"]
        r.update({k_: head[k_] for k_ in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")})


def causal_pairs(Sq: int, Sk: int) -> int:
    """(row, key) pairs a causal, bottom-right aligned mask leaves
    visible: row i sees min(Sk, i + Sk - Sq + 1) keys."""
    return sum(max(0, min(Sk, i + Sk - Sq + 1)) for i in range(Sq))


def by_heads(fn, *ts, heads=4):
    """`fn` over `heads` heads at a time, concatenated back along the
    head axis (heads are independent; the dense plain version's f32
    scores for all 32 heads at S 8192 would take 8.6 GB a copy)."""
    parts = [fn(*(t[:, :, h:h + heads] for t in ts))
             for h in range(0, ts[0].shape[2], heads)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p, dim=2) for p in zip(*parts))
    return torch.cat(parts, dim=2)


def check_flash(timer: Timer, rows: dict):
    """flash_sdpa forward and backward (dq + dkv) at the training shape
    (B 1, S 8192, 32 heads x 128 after the GQA repeat, causal) in bf16
    and at S 2048 in f32, against the plain version: o and the three
    gradients; in bf16 timed beside the plain version, the bound and
    PyTorch's SDPA (library_ms, a yardstick the port never calls)."""
    gc_ = torch.Generator(DEV).manual_seed(1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd_ref = lambda q, k, v: ops.flash_sdpa_reference(  # noqa: E731
        q, k, v, causal=True)
    bwd_ref = lambda q, k, v, do: ops.flash_sdpa_bwd_reference(  # noqa: E731
        q, k, v, do, causal=True)
    for dtype, S in ((torch.bfloat16, TRAIN_SEQ),
                     (torch.float32, F32_FLASH_SEQ)):
        main = dtype == torch.bfloat16
        tag = "bf16" if main else "f32"
        q, k, v, do = (torch.randn(1, S, HQ, D, device=DEV,
                                   generator=gc_).to(dtype)
                       for _ in range(4))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        n_f, n_b = ops.flash_sdpa.launches, ops.flash_sdpa_bwd.launches
        o = ops.flash_sdpa(*leaves, causal=True)
        o.backward(do)
        torch.cuda.synchronize()
        assert ops.flash_sdpa.launches == n_f + 1
        assert ops.flash_sdpa_bwd.launches == n_b + 1
        grads = [t.grad for t in leaves]
        with torch.no_grad():
            ref_o = by_heads(fwd_ref, q, k, v)
        ref_g = by_heads(bwd_ref, q, k, v, do)
        outs = {"o": (o, ref_o), **{n: (a, b) for n, a, b in
                                    zip(("dq", "dk", "dv"), grads, ref_g)}}
        rel = {}
        for n, (got, want) in outs.items():
            if main:
                rel[n] = assert_flash_bf16(n, got, want)
            else:
                assert torch.isfinite(got).all(), n
                tol = dict(atol=2e-5, rtol=2e-5) if n == "o" \
                    else dict(atol=1e-4, rtol=1e-4)
                torch.testing.assert_close(got.float(), want.float(), **tol)
        errs = {"flash_sdpa": (max_err(o.detach(), ref_o), ["o"]),
                "flash_sdpa_bwd": (max(max_err(a, b)
                                       for a, b in zip(grads, ref_g)),
                                   ["dq", "dk", "dv"])}
        for name, (err, names) in errs.items():
            r = rows.setdefault(name, {"seq": S})
            r[f"max_abs_err_{tag}"] = err
            if main:
                r["max_abs_err"] = err
                r["rel_err_bf16"] = {n: {"tensor": rel[n][0],
                                         "tile": rel[n][1]} for n in names}
        if not main:
            continue
        del leaves, grads, ref_o, ref_g, o
        pairs = causal_pairs(S, S)
        lse_bytes = 1 * HQ * S * 4
        flops1 = 2 * 1 * HQ * D * pairs         # one product over the pairs
        o, lse = _launch_fwd(q, k, v, None, None, True, D ** -0.5)
        b_, by = bound(nbytes(q, k, v, o) + lse_bytes, 2 * flops1, dtype)
        lq, lk, lv = (t.transpose(1, 2) for t in (q, k, v))
        rows["flash_sdpa"].update(
            bound_ms=b_, bound_by=by, causal_pairs=pairs,
            ms=timer.ms(lambda: ops.flash_sdpa(q, k, v, causal=True)),
            plain_ms=timer.ms(lambda: by_heads(fwd_ref, q, k, v)),
            library_ms=timer.ms(lambda: sdpa(lq, lk, lv, is_causal=True)))
        b_, by = bound(nbytes(q, k, v, o, do) + lse_bytes + 3 * nbytes(q),
                       5 * flops1, dtype)
        ll = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
        lo = sdpa(*ll, is_causal=True)
        ldo = do.transpose(1, 2)
        rows["flash_sdpa_bwd"].update(
            bound_ms=b_, bound_by=by, causal_pairs=pairs,
            ms=timer.ms(lambda: ops.flash_sdpa_bwd(q, k, v, o, lse, do,
                                                   causal=True)),
            # the plain backward is autograd of the dense version, which
            # runs that version's forward first
            plain_ms=timer.ms(lambda: by_heads(bwd_ref, q, k, v, do)),
            library_ms=timer.ms(lambda: torch.autograd.grad(
                lo, ll, ldo, retain_graph=True)))


# ------------------------------------------------------------- phase 3/4
def trace(rng, V, n, smin, smax, new_min, new_max, spread):
    """Seeded (prompt, max_new, join_step) requests."""
    return [(rng.randint(0, V, rng.randint(smin, smax + 1)).astype(np.int32),
             int(rng.randint(new_min, new_max + 1)),
             int(rng.randint(0, spread)))
            for _ in range(n)]


def drive(eng, reqs, on_step=None):
    """Submit each request at its step and step until idle; returns
    {id: tokens}, the Request objects and per-step (ms, step counts)."""
    pending = list(enumerate(reqs))
    results, handles, steps, i = {}, {}, [], 0
    while pending or eng.has_work():
        still = []
        for rid, (prompt, max_new, at) in pending:
            if at <= i:
                handles[rid] = (eng.add_request(prompt, max_new_tokens=max_new,
                                                request_id=rid),
                                time.perf_counter())
            else:
                still.append((rid, (prompt, max_new, at)))
        pending = still
        t0 = time.perf_counter()
        out = eng.step()            # ends in the host reading the argmax
        steps.append(((time.perf_counter() - t0) * 1e3, out))
        if on_step is not None:
            on_step(eng, handles)
        results.update(eng.collect())
        i += 1
    return results, handles, steps


#: the two chains of the engine's unified step, and the kernels each
#: launches per step (per layer, plus the final norm's rms_norm)
SPLIT = dict(megafront=False, megadecode=False)
NO_TRAINING = {"flash_sdpa": (0, 0), "flash_sdpa_bwd": (0, 0),
               "gmm": (0, 0)}
NO_PAGED = {"paged_decode_attention": (0, 0),
            "paged_decode_attention_v2": (0, 0)}
FUSED_PER_STEP = {"fused_rms_norm": (1, 1), "fused_layer_norm": (0, 0),
                  "fused_qkv_rope_append": (1, 0),
                  "ragged_paged_attention": (1, 0),
                  "fused_oproj_norm": (1, 0), "fused_ffn": (1, 0),
                  "fused_rope_append": (0, 0), "weight_only_linear": (0, 0),
                  **NO_TRAINING, **NO_PAGED}
SPLIT_PER_STEP = {"fused_rms_norm": (2, 1), "fused_layer_norm": (0, 0),
                  "fused_rope_append": (1, 0),
                  "ragged_paged_attention": (1, 0),
                  "fused_qkv_rope_append": (0, 0),
                  "fused_oproj_norm": (0, 0), "fused_ffn": (0, 0),
                  "weight_only_linear": (0, 0), **NO_TRAINING, **NO_PAGED}
#: weight_only_linear a step under int4 weights: the LM head on the fused
#: chain; the seven projections of every layer and the head on the split
#: chain (int8 products are h @ (q * s), no kernel)
INT4_WOL = {"fused": (0, 1), "split": (7, 1)}


def norm_kernel(model) -> str:
    """The norm kernel of a model's serving bodies: layer norm for the
    gpt family, rms norm for the llama family (Qwen2 and MoE included)."""
    return "fused_layer_norm" if hasattr(model, "gpt") else "fused_rms_norm"


def routed_layers(model) -> int:
    """Layers of a model whose FFN is the routed MoE one (0 outside the
    MoE family)."""
    inner = getattr(model, "model", None)
    return 0 if inner is None else sum(
        1 for lyr in inner.layers if hasattr(lyr.mlp, "w_up"))


def per_step_counts(chain: str, quant=None, norm: str = "fused_rms_norm",
                    routed: int = 0) -> dict:
    """(per layer, per step) launches of every kernel on a unified-step
    chain ("fused" / "split") under weight_only_quant `quant`, with
    `norm` the family's norm kernel and `routed` MoE layers, whose FFN
    is three gmm calls a step (the unified step has more than 32 rows)
    and, on the fused chain, no fused_ffn; under int4 their shared
    expert's three products go through weight_only_linear on either
    chain (on the split chain they take the dense FFN's place)."""
    base = FUSED_PER_STEP if chain == "fused" else SPLIT_PER_STEP
    if norm == "fused_layer_norm":
        base = dict(base, fused_layer_norm=base["fused_rms_norm"],
                    fused_rms_norm=(0, 0))
    base = dict(base, gmm=(0, 3 * routed))
    if chain == "fused":
        base["fused_ffn"] = (1, -routed)
    if quant != "int4":
        return base
    a, b = INT4_WOL[chain]
    return dict(base, weight_only_linear=(
        a, b + (3 * routed if chain == "fused" else 0)))
#: the alternating path (ragged=False) under each FLAGS_paged_impl: its
#: decode launch's paged kernel and the one it must not launch
ALTERNATING = {"intree": ("paged_decode_attention_v2",
                          "paged_decode_attention"),
               "intree_v1": ("paged_decode_attention",
                             "paged_decode_attention_v2")}


def alternating_launches(steps):
    """(prefill launches, decode launches) of an alternating-path run:
    an engine step runs one of each where it has that work."""
    return (sum(1 for _, o in steps if o["prefill_tokens"] > 0),
            sum(1 for _, o in steps if o["decoded"] > 0))


def expect_alternating(impl, layers, prefill, decode, quant=None,
                       norm: str = "fused_rms_norm", routed: int = 0,
                       chunk: int = 0):
    """Every kernel's launches in an alternating-path run: 2 * layers + 1
    of the family's `norm` kernel a launch, `layers` of the impl's paged
    kernel a decode launch, under int4 weights 7 * layers + 1
    weight_only_linear a launch (every projection, a routed layer's
    shared expert, and the head), three gmm calls a `routed` layer a
    prefill launch of a `chunk` of more than 32 rows (a decode launch's
    slots run every expert on every token), nothing else."""
    want = {name: 0 for name in ops.launch_counts()}
    want[norm] = (2 * layers + 1) * (prefill + decode)
    want[ALTERNATING[impl][0]] = layers * decode
    if chunk > 32:
        want["gmm"] = 3 * routed * prefill
    if quant == "int4":
        want["weight_only_linear"] = (7 * layers + 1) * (prefill + decode)
    return want


def tiny_engine_parity():
    """Both chains: the tiny f32 engine's greedy tokens, CPU (plain
    versions) vs card (kernels)."""
    cfg = llama_tiny_config(num_hidden_layers=2)
    cpu_model = LlamaForCausalLM(cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model).to(DEV)
    reqs = trace(np.random.RandomState(1), cfg.vocab_size, 6, 2, 12, 2, 8, 4)
    kw = dict(max_slots=2, page_size=4, prefill_chunk=4)
    out = {"requests": len(reqs)}
    for chain, per_step in (("fused", FUSED_PER_STEP),
                            ("split", SPLIT_PER_STEP)):
        ckw = dict(kw, **(SPLIT if chain == "split" else {}))
        cpu_out, _, _ = drive(ServingEngine(cpu_model, device="cpu", **ckw),
                              reqs)
        n0 = ops.launch_counts()
        gpu_out, _, _ = drive(ServingEngine(gpu_model, device=DEV, **ckw),
                              reqs)
        n1 = ops.launch_counts()
        assert set(cpu_out) == set(gpu_out) == set(range(len(reqs)))
        for rid in cpu_out:
            np.testing.assert_array_equal(gpu_out[rid], cpu_out[rid])
        for name, (per_layer, _) in per_step.items():
            ran = n1[name]["launches"] > n0[name]["launches"]
            assert ran == bool(per_layer), (chain, name)
        out[chain] = {"tokens": int(sum(len(v) for v in cpu_out.values())),
                      "identical": True}
    # the alternating path under both paged impls: counts read alone
    L = cfg.num_hidden_layers
    for impl in ALTERNATING:
        with flags_guard(paged_impl=impl):
            cpu_out, _, _ = drive(ServingEngine(cpu_model, device="cpu",
                                                ragged=False, **kw), reqs)
            eng = ServingEngine(gpu_model, device=DEV, ragged=False, **kw)
        ops.reset_counts()
        paged_routes.reset_route_counts()
        gpu_out, _, steps = drive(eng, reqs)
        counts = ops.launch_counts()
        pre, dec = alternating_launches(steps)
        assert eng.launches == pre + dec and dec > 0
        for rid in cpu_out:
            np.testing.assert_array_equal(gpu_out[rid], cpu_out[rid])
        want = expect_alternating(impl, L, pre, dec)
        for name, c in counts.items():
            assert c == {"launches": want[name], "plain_calls": 0}, \
                (impl, name, c, want[name])
        route = "paged_" + impl
        assert paged_routes.route_counts == dict(
            {k: 0 for k in paged_routes.route_counts}, **{route: L * dec})
        out["alternating_" + impl] = {
            "tokens": int(sum(len(v) for v in cpu_out.values())),
            "identical": True, "prefill_launches": pre,
            "decode_launches": dec,
            "launches": {k: v for k, v in want.items() if v}}
    out["generate"] = tiny_generate_parity()
    out["quantized"] = tiny_quant_parity()
    out["gpt_and_qwen2"] = tiny_family_parity()
    out["moe"] = tiny_moe_parity()
    return out


def tiny_quant_parity():
    """The tiny f32 Llama with weight-only int8 and int4 weights, CPU
    (plain versions) vs card (kernels): identical greedy tokens on the
    fused chain, the split chain and the alternating path, each card run
    with exactly its path's launches and no plain-version call; then
    generate_cached (the tiny head_dim-64 model of tiny_generate_parity)
    in both layouts: identical tokens, scores within 1e-5, int4's
    projections and head through weight_only_linear."""
    cfg = llama_tiny_config(num_hidden_layers=2)
    cpu_model = LlamaForCausalLM(cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model).to(DEV)
    reqs = trace(np.random.RandomState(1), cfg.vocab_size, 6, 2, 12, 2, 8, 4)
    kw = dict(max_slots=2, page_size=4, prefill_chunk=4)
    L = cfg.num_hidden_layers
    out = {}
    for quant in ("int8", "int4"):
        for chain, ckw in (("fused", {}), ("split", SPLIT),
                           ("alternating", dict(ragged=False))):
            qkw = dict(kw, weight_only_quant=quant, **ckw)
            cpu_out, _, _ = drive(ServingEngine(cpu_model, device="cpu",
                                                **qkw), reqs)
            eng = ServingEngine(gpu_model, device=DEV, **qkw)
            ops.reset_counts()
            gpu_out, _, steps = drive(eng, reqs)
            counts = ops.launch_counts()
            assert set(cpu_out) == set(gpu_out) == set(range(len(reqs)))
            for rid in cpu_out:
                np.testing.assert_array_equal(gpu_out[rid], cpu_out[rid])
            if chain == "alternating":
                want = expect_alternating("intree", L,
                                          *alternating_launches(steps),
                                          quant)
            else:
                want = {k: (a * L + b) * eng.launches for k, (a, b)
                        in per_step_counts(chain, quant).items()}
            for name, c in counts.items():
                assert c == {"launches": want[name], "plain_calls": 0}, \
                    (quant, chain, name, c, want[name])
            out[f"{quant}/{chain}"] = {
                "tokens": int(sum(len(v) for v in cpu_out.values())),
                "identical": True,
                "launches": {k: v for k, v in want.items() if v}}
    cfg = llama_tiny_config(**TINY_TRAIN)
    cpu_model = LlamaForCausalLM(cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model).to(DEV)
    ids = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 7))
    new, L = 6, cfg.num_hidden_layers
    for quant in ("int8", "int4"):
        kw = dict(max_new_tokens=new, decode_strategy="greedy_search",
                  weight_only_quant=quant)
        cpu_tok, cpu_sc = generation.generate_cached(cpu_model, ids, **kw)
        ops.reset_counts()
        gpu_tok, gpu_sc = generation.generate_cached(gpu_model, ids, **kw)
        counts = ops.launch_counts()
        np.testing.assert_array_equal(gpu_tok.cpu().numpy(),
                                      cpu_tok.numpy())
        dist = float((gpu_sc.cpu() - cpu_sc).abs().max())
        assert dist <= 1e-5, (quant, dist)
        # one prefill and new - 1 decode calls of the cached step
        wol = (7 * L + 1) * new if quant == "int4" else 0
        for name, c in counts.items():
            want = {"flash_sdpa": L, "weight_only_linear": wol}.get(name, 0)
            assert c == {"launches": want, "plain_calls": 0}, \
                (quant, name, c)
        out[f"{quant}/generate_cached"] = {
            "tokens": cpu_tok.numpy().tolist(), "score_max_abs_diff": dist,
            "weight_only_linear_launches": wol}
    return out


def tiny_family_parity():
    """The tiny f32 GPT (hidden 128, 2 heads of 64) and Qwen2 (2 query
    heads of 64 on 1 KV head), biases drawn at random (the initializers
    leave them at 0), CPU (plain versions) vs card (kernels): identical
    greedy tokens on the fused chain, the split chain and the alternating
    path under both paged impls, each card run at exactly its path's
    launches (the gpt family's with fused_layer_norm for every norm);
    then generate_cached: identical tokens, scores within 1e-5, the
    flash kernel once a layer and nothing else."""
    out = {}
    families = (
        ("gpt", GPTForCausalLM,
         gpt_tiny_config(hidden_size=128, num_attention_heads=2)),
        ("qwen2", Qwen2ForCausalLM,
         qwen2_tiny_config(num_attention_heads=2, num_key_value_heads=1)))
    kw = dict(max_slots=2, page_size=4, prefill_chunk=4)
    paths = (("fused", {}, "intree"), ("split", SPLIT, "intree"),
             ("alternating", dict(ragged=False), "intree"),
             ("alternating", dict(ragged=False), "intree_v1"))
    for fam, cls, cfg in families:
        cpu_model = cls(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for name, p_ in cpu_model.named_parameters():
                if name.endswith("bias"):
                    p_.normal_(0.0, 0.1, generator=g)
        gpu_model = copy.deepcopy(cpu_model).to(DEV)
        norm, L = norm_kernel(cpu_model), cfg.num_hidden_layers
        reqs = trace(np.random.RandomState(1), cfg.vocab_size, 6, 2, 12, 2,
                     8, 4)
        for chain, ckw, impl in paths:
            with flags_guard(paged_impl=impl):
                cpu_out, _, _ = drive(ServingEngine(
                    cpu_model, device="cpu", **kw, **ckw), reqs)
                eng = ServingEngine(gpu_model, device=DEV, **kw, **ckw)
            ops.reset_counts()
            gpu_out, _, steps = drive(eng, reqs)
            counts = ops.launch_counts()
            assert set(cpu_out) == set(gpu_out) == set(range(len(reqs)))
            for rid in cpu_out:
                np.testing.assert_array_equal(gpu_out[rid], cpu_out[rid])
            if chain == "alternating":
                want = expect_alternating(
                    impl, L, *alternating_launches(steps), norm=norm)
            else:
                want = {k: (a * L + b) * eng.launches for k, (a, b)
                        in per_step_counts(chain, None, norm).items()}
            for name, c in counts.items():
                assert c == {"launches": want[name], "plain_calls": 0}, \
                    (fam, chain, impl, name, c, want[name])
            key = f"{fam}/{chain}" + ("" if chain != "alternating"
                                      else "/" + impl)
            out[key] = {"tokens": int(sum(len(v) for v in cpu_out.values())),
                        "identical": True,
                        "launches": {k: v for k, v in want.items() if v}}
        ids = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 7))
        gkw = dict(max_new_tokens=6, decode_strategy="greedy_search")
        cpu_tok, cpu_sc = generation.generate_cached(cpu_model, ids, **gkw)
        ops.reset_counts()
        gpu_tok, gpu_sc = generation.generate_cached(gpu_model, ids, **gkw)
        counts = ops.launch_counts()
        np.testing.assert_array_equal(gpu_tok.cpu().numpy(),
                                      cpu_tok.numpy())
        dist = float((gpu_sc.cpu() - cpu_sc).abs().max())
        assert dist <= 1e-5, (fam, dist)
        for name, c in counts.items():
            want = L if name == "flash_sdpa" else 0
            assert c == {"launches": want, "plain_calls": 0}, (fam, name, c)
        out[f"{fam}/generate_cached"] = {
            "tokens": cpu_tok.numpy().tolist(), "score_max_abs_diff": dist,
            "flash_launches": L}
    return out


def tiny_moe_parity():
    """A tiny f32 ERNIE 4.5 MoE (hidden 128, 2 query heads of 64 on 1 KV
    head, a dense first layer, one routed layer of 8 experts of 64, top-2,
    a shared expert), CPU (plain versions) vs card (kernels): identical
    greedy tokens on the fused chain, the split chain and the alternating
    path in fp, int8 and int4, each card run at exactly its path's
    launches: the unified step has 2 slots + a 36-row chunk > 32 rows, so
    gmm runs three times a routed layer a step, as in each prefill chunk
    of the alternating path, whose 2-row decode launches run every expert
    on every token. Then generate (the buffer model routes dropless on
    every forward) and generate_cached (fp, int8, int4; a 2 x 20-token
    prefill > 32 rows): identical tokens, scores within 1e-5."""
    cfg = ernie45_moe_config(num_attention_heads=2, num_key_value_heads=1,
                             moe_dropless=True, max_position_embeddings=64)
    cpu_model = MoEForCausalLM(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model).to(DEV)
    L, R = cfg.num_hidden_layers, routed_layers(cpu_model)
    assert R == 1
    reqs = trace(np.random.RandomState(1), cfg.vocab_size, 6, 2, 12, 2, 8, 4)
    kw = dict(max_slots=2, page_size=4, prefill_chunk=36)
    out = {}
    for quant in (None, "int8", "int4"):
        for chain, ckw in (("fused", {}), ("split", SPLIT),
                           ("alternating", dict(ragged=False))):
            qkw = dict(kw, weight_only_quant=quant, **ckw)
            cpu_out, _, _ = drive(ServingEngine(cpu_model, device="cpu",
                                                **qkw), reqs)
            eng = ServingEngine(gpu_model, device=DEV, **qkw)
            ops.reset_counts()
            gpu_out, _, steps = drive(eng, reqs)
            counts = ops.launch_counts()
            assert set(cpu_out) == set(gpu_out) == set(range(len(reqs)))
            for rid in cpu_out:
                np.testing.assert_array_equal(gpu_out[rid], cpu_out[rid])
            if chain == "alternating":
                want = expect_alternating("intree", L,
                                          *alternating_launches(steps),
                                          quant, routed=R, chunk=36)
            else:
                want = {k: (a * L + b) * eng.launches for k, (a, b)
                        in per_step_counts(chain, quant,
                                           routed=R).items()}
            for name, c in counts.items():
                assert c == {"launches": want[name], "plain_calls": 0}, \
                    (quant, chain, name, c, want[name])
            out[f"{quant or 'fp'}/{chain}"] = {
                "tokens": int(sum(len(v) for v in cpu_out.values())),
                "identical": True,
                "launches": {k: v for k, v in want.items() if v}}
            if quant == "int4":
                # the shared expert's three int4 products a routed layer a
                # launch: the work JAX does through int4_dequantize
                out[f"int4/{chain}"]["int4_dequantize_work"] = \
                    3 * R * eng.launches
    ids = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 20))
    new = 6
    for name, quant in (("generate", None), ("generate_cached", None),
                        ("generate_cached", "int8"),
                        ("generate_cached", "int4")):
        gkw = dict(max_new_tokens=new, decode_strategy="greedy_search")
        if quant:
            gkw["weight_only_quant"] = quant
        fn = getattr(generation, name)
        cpu_tok, cpu_sc = fn(cpu_model, ids[:, :7] if name == "generate"
                             else ids, **gkw)
        ops.reset_counts()
        gpu_tok, gpu_sc = fn(gpu_model, ids[:, :7] if name == "generate"
                             else ids, **gkw)
        counts = ops.launch_counts()
        np.testing.assert_array_equal(gpu_tok.cpu().numpy(),
                                      cpu_tok.numpy())
        dist = float((gpu_sc.cpu() - cpu_sc).abs().max())
        assert dist <= 1e-5, (name, quant, dist)
        if name == "generate":      # a dropless forward a new token
            want = {"flash_sdpa": L * new, "gmm": 3 * R * new}
        else:                       # the prefill only: 40 rows
            # int4: four projections a layer, the dense FFN's three, the
            # shared expert's three, the head, every call of the step
            wol = (4 * L + 3 * (L - R) + 3 * R + 1) * new \
                if quant == "int4" else 0
            want = {"flash_sdpa": L, "gmm": 3 * R,
                    "weight_only_linear": wol}
        for kname, c in counts.items():
            assert c == {"launches": want.get(kname, 0),
                         "plain_calls": 0}, (name, quant, kname, c)
        out[f"{quant or 'fp'}/{name}"] = {
            "tokens": cpu_tok.numpy().tolist(), "score_max_abs_diff": dist,
            "launches": want}
    return out


def tiny_generate_parity():
    """generate and generate_cached (greedy, f32) on a tiny Llama (head_dim
    64, 2 query heads on 1 KV head): CPU (plain versions) vs card (the
    flash kernel for the prompt), identical tokens, scores within 1e-5."""
    cfg = llama_tiny_config(**TINY_TRAIN)
    cpu_model = LlamaForCausalLM(cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model).to(DEV)
    ids = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 7))
    new, L = 6, cfg.num_hidden_layers
    out = {}
    for name, flash_calls in (("generate", new * L), ("generate_cached", L)):
        fn = getattr(generation, name)
        kw = dict(max_new_tokens=new, decode_strategy="greedy_search")
        cpu_tok, cpu_sc = fn(cpu_model, ids, **kw)
        ops.reset_counts()
        gpu_tok, gpu_sc = fn(gpu_model, ids, **kw)
        counts = ops.launch_counts()
        assert gpu_tok.device.type == torch.device(DEV).type
        np.testing.assert_array_equal(gpu_tok.cpu().numpy(),
                                      cpu_tok.numpy())
        dist = float((gpu_sc.cpu() - cpu_sc).abs().max())
        assert dist <= 1e-5, (name, dist)
        assert counts["flash_sdpa"] == {"launches": flash_calls,
                                        "plain_calls": 0}, counts
        out[name] = {"tokens": cpu_tok.numpy().tolist(),
                     "score_max_abs_diff": dist,
                     "flash_launches": flash_calls}
    return out


def tree_nbytes(d) -> int:
    """Bytes of every tensor of a (nested) weight dict."""
    return sum(tree_nbytes(t) if isinstance(t, dict) else nbytes(t)
               for t in d.values())


def read_bytes(w) -> int:
    """Bytes of an engine's weight tree that one decode step reads: every
    layer tensor, the final norm and the LM head in its layout, which is
    the embedding for a tied head (otherwise not the embedding or the
    learned positions, of which a step gathers a few rows, nor the rope
    tables). A MoE layer counts its whole expert stacks, as a launch on
    the every-expert route (T <= 32) or a quantized tree's per-step
    dequantize reads them; `GroupSizeLog` narrows a bf16 unified step's
    to the experts that its routing gave rows."""
    heads = [t for k, t in w.items() if k.startswith("head")
             and t is not None]
    return (sum(tree_nbytes(L) for L in w["layers"])
            + sum(nbytes(t) for k, t in w.items() if k.startswith("norm"))
            + sum(nbytes(t) for t in heads)
            + (0 if heads else nbytes(w["embed"])))


def expert_stack_bytes(L) -> int:
    """Bytes of a decode-tree layer's routed expert stacks (wge / wup /
    wdn, with their scales in a quantized layout; E leading), 0 for a
    dense layer."""
    mo = L.get("moe")
    return 0 if mo is None else sum(
        nbytes(t) for k, t in mo.items() if k[:3] in ("wge", "wup", "wdn"))


class GroupSizeLog:
    """Keeps, while it is entered, each group-size tensor that the
    dropless FFN hands gmm (one a routed layer: its three products share
    it), by reference: no copy and no read-back while a run is timed.
    `mark` closes a step; `hits` reads, per step, the experts that hold
    rows in each routed layer."""

    def __init__(self):
        self._gmm = moe_ffn.gmm
        self.sizes, self.ends = [], []

    def __enter__(self):
        def recording(lhs, rhs, gs):
            if not self.sizes or self.sizes[-1] is not gs:
                self.sizes.append(gs)
            return self._gmm(lhs, rhs, gs)
        moe_ffn.gmm = recording
        return self

    def __exit__(self, *exc):
        moe_ffn.gmm = self._gmm

    def mark(self):
        self.ends.append(len(self.sizes))

    def hits(self):
        out, start = [], 0
        for end in self.ends:
            out.append((torch.stack(self.sizes[start:end]) > 0).sum(1)
                       .tolist() if end > start else [])
            start = end
        return out


def routed_step_reads(w, steps, hits, cfg, quant) -> dict:
    """What a routed model's unified steps read, from the experts each
    step's routing gave rows (`GroupSizeLog.hits`), for the decode steps
    (no prefill chunk) and the mixed ones: the experts holding rows in a
    routed layer (mean, min, max), the gmm launches' expert-slab bytes a
    step (gmm multiplies the bf16 slabs, dequantized first in a quantized
    layout) and their time at the HBM rate (the bound of a step's gmm
    work), and, for bf16 weights, the bytes of the weight tree the step
    reads
    (`read_bytes` with each routed layer's stacks cut to the experts that
    hold rows; a quantized tree is dequantized whole every step, so its
    `weight_read_bytes` stays the whole tree's)."""
    E = cfg.num_experts
    stacks = [b for b in map(expert_stack_bytes, w["layers"]) if b]
    dense_bytes = read_bytes(w) - sum(stacks)
    expert_slabs = 3 * cfg.hidden_size * cfg.moe_intermediate_size \
        * w["embed"].element_size()
    out = {}
    for kind in ("decode", "mixed"):
        sel = [h for (_, o), h in zip(steps, hits)
               if (o["prefill_tokens"] > 0) == (kind == "mixed")
               and o["decoded"] + o["prefill_tokens"] > 0]
        flat = [n for h in sel for n in h]
        if not flat:
            continue
        assert all(len(h) == len(stacks) for h in sel), (kind, len(stacks))
        slab = statistics.median(sum(h) for h in sel) * expert_slabs
        r = {"steps": len(sel), "experts_with_rows_mean":
             statistics.mean(flat), "experts_with_rows_min": min(flat),
             "experts_with_rows_max": max(flat),
             "gmm_slab_bytes": slab,
             "gmm_slab_ms": slab / HBM_BYTES_PER_S * 1e3}
        if quant is None:
            assert sum(stacks) == len(stacks) * E * expert_slabs
            r["weight_read_bytes"] = dense_bytes + slab
            r["weight_read_ms"] = r["weight_read_bytes"] \
                / HBM_BYTES_PER_S * 1e3
        out[f"routed_{kind}_steps"] = r
    return out


def serve_trace(model, chain: str, counts_out: dict, impl: str = "intree",
                quant=None):
    """Serve the seeded trace (8 requests, prompts of 64-512 tokens, 32
    new tokens each) with a full-width model (Llama-3-8B, GPT-3 6.7B,
    Qwen2-7B or ERNIE-4.5-21B-A3B) through one chain of ServingEngine's
    unified step ("fused", "split") or through the alternating path
    ("alternating", ragged=False, with FLAGS_paged_impl `impl` pinned:
    the v2 paged kernel under "intree", v1 under "intree_v1"), with the
    model's weights or, `quant` "int8" / "int4", their weight-only layout
    quantized on the card as the engine is built; every kernel's launches
    must be that path's per launch, with no plain-version call (and,
    alternating, no other paged route)."""
    cfg = model.config
    layers = cfg.num_hidden_layers
    norm, routed = norm_kernel(model), routed_layers(model)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    alt = chain == "alternating"
    kw = {"split": SPLIT, "alternating": dict(ragged=False)}.get(chain, {})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with flags_guard(paged_impl=impl):
        eng = ServingEngine(model, max_slots=SLOTS, page_size=PSZ,
                            prefill_chunk=CHUNK, max_context=MAX_CTX,
                            device=DEV, weight_only_quant=quant, **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    assert eng.megafront == eng.megadecode == (chain == "fused")
    assert eng.ragged == (not alt)
    assert eng.paged_impl == (impl if alt else None)
    pool_bytes = sum(nbytes(k, v) for k, v in eng._pools)
    # the engine's concatenated qkv copy (the gpt family's wqkv is the
    # model's own weight, no copy)
    slab_bytes = 0 if norm == "fused_layer_norm" else sum(
        nbytes(t) for L in eng._p["layers"] for k, t in L.items()
        if k.startswith("wqkv"))
    tree_bytes = read_bytes(eng._w)
    rng = np.random.RandomState(0)
    # warm-up (cuBLAS handles, allocator): one short request, then the
    # counts start at 0 for the measured run
    drive(eng, [(rng.randint(0, cfg.vocab_size, 64).astype(np.int32), 2, 0)])
    reqs = trace(rng, cfg.vocab_size, 8, 64, 512, 32, 32, 1)
    reqs = [(p, 32, i // 2) for i, (p, _, _) in enumerate(reqs)]
    first_tok, finite = {}, []
    launch_ms = {"prefill": [], "decode": []}
    if alt:
        # each launch timed alone: a synchronize on both sides of its body
        def timed(body, kind):
            def run(*args):
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = body(*args)
                torch.cuda.synchronize()
                launch_ms[kind].append((time.perf_counter() - t) * 1e3)
                return res
            return run
        eng._prefill_body = timed(eng._prefill_body, "prefill")
        eng._decode_body = timed(eng._decode_body, "decode")

    # a routed model's unified steps: which experts each step's routing
    # gave rows (a decode step's padding rows all route alike)
    glog = GroupSizeLog() if routed and not alt else None

    def on_step(e, handles):
        if glog is not None:
            glog.mark()
        finite.append(bool(torch.isfinite(e.last_logits).all()))
        now = time.perf_counter()
        for rid, (req, t_sub) in handles.items():
            if rid not in first_tok and req.tokens:
                first_tok[rid] = (now - t_sub) * 1e3

    ops.reset_counts()
    paged_routes.reset_route_counts()
    steps0 = eng.launches
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with glog or contextlib.nullcontext():
        out, handles, steps = drive(eng, reqs, on_step)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    n_steps = eng.launches - steps0
    assert len(out) == len(reqs)
    for rid, toks in out.items():
        assert isinstance(toks, np.ndarray) and toks.shape == (32,), rid
        assert len(handles[rid][0].tokens) == 32
    assert all(finite) and len(finite) == len(steps)
    if alt:
        pre, dec = alternating_launches(steps)
        assert n_steps == pre + dec, (n_steps, pre, dec)
        expect = expect_alternating(impl, layers, pre, dec, quant, norm,
                                    routed, CHUNK)
        assert paged_routes.route_counts == dict(
            {k: 0 for k in paged_routes.route_counts},
            **{"paged_" + impl: layers * dec}), paged_routes.route_counts
        per_launch = {"decode": {ALTERNATING[impl][0]: layers,
                                 norm: 2 * layers + 1},
                      "prefill": {norm: 2 * layers + 1}}
        if routed:
            per_launch["prefill"]["gmm"] = 3 * routed
    else:
        per_step = per_step_counts(chain, quant, norm, routed)
        expect = {name: (a * layers + b) * n_steps
                  for name, (a, b) in per_step.items()}
        per_launch = {k: v // n_steps for k, v in expect.items()}
    for name, c in counts.items():
        assert c == {"launches": expect[name], "plain_calls": 0}, \
            (name, c, expect[name])
    counts_out.update({k: v["launches"] for k, v in counts.items()
                       if expect[k]})
    decode_ms = [ms for ms, o in steps
                 if o["prefill_tokens"] == 0 and o["decoded"] > 0]
    mixed_ms = [ms for ms, o in steps if o["prefill_tokens"] > 0]
    gen = sum(len(h[0].tokens) for h in handles.values())
    ttft = sorted(first_tok.values())
    res = {
        "chain": chain, "layers": layers, "weight_only_quant": quant,
        "engine_build_s": build_s,
        "requests": len(reqs), "launches": n_steps, "steps": len(steps),
        "generated_tokens": gen,
        "prompt_tokens": int(sum(p.size for p, _, _ in reqs)),
        "wall_s": wall, "tokens_per_s": gen / wall,
        "ttft_ms_p50": statistics.median(ttft), "ttft_ms_max": ttft[-1],
        "decode_step_ms_median": statistics.median(decode_ms),
        "decode_steps": len(decode_ms),
        "mixed_step_ms_median": statistics.median(mixed_ms),
        "weight_bytes": weight_bytes, "qkv_slab_bytes": slab_bytes,
        "page_pool_bytes": pool_bytes,
        "decode_step_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
        "weight_read_bytes": tree_bytes,
        "weight_read_ms": tree_bytes / HBM_BYTES_PER_S * 1e3,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches_per_step" if not alt else "launches_per_launch":
            per_launch,
    }
    if glog is not None:
        res.update(routed_step_reads(eng._w, steps, glog.hits(), cfg,
                                     quant))
    if alt:
        res.update(paged_impl=impl, prefill_launches=pre,
                   decode_launches=dec,
                   prefill_chunk_ms_median=statistics.median(
                       launch_ms["prefill"]),
                   decode_launch_ms_median=statistics.median(
                       launch_ms["decode"]))
    return out, res


def generate_cached_run(model):
    """generate_cached at full width: GEN_BATCH seeded prompts of
    GEN_PROMPT tokens, GEN_NEW greedy new tokens. Every call of the cached
    step is timed alone (a synchronize on both sides); the prefill must
    run the flash kernel once a layer (and, for a MoE model, gmm three
    times a routed layer) and nothing else may launch."""
    cfg = model.config
    L, routed = cfg.num_hidden_layers, routed_layers(model)
    g = torch.Generator(DEV).manual_seed(3)
    ids = torch.randint(0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT),
                        device=DEV, generator=g)
    kw = dict(decode_strategy="greedy_search")
    generation.generate_cached(model, ids[:, :64], max_new_tokens=2, **kw)
    calls = []
    make = generation._make_cached_step

    def timed_make(p, max_len, *args):
        call = make(p, max_len, *args)

        def run(ids_, caches, start):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = call(ids_, caches, start)
            torch.cuda.synchronize()
            calls.append((ids_.shape[1], (time.perf_counter() - t) * 1e3))
            return res
        return run

    generation._make_cached_step = timed_make
    try:
        ops.reset_counts()
        attn_routes.reset_route_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tok, scores = generation.generate_cached(model, ids,
                                                 max_new_tokens=GEN_NEW, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        generation._make_cached_step = make
    counts = ops.launch_counts()
    # the prefill: the flash kernel once a layer, and a MoE model's routed
    # layers three grouped GEMMs each (GEN_BATCH x GEN_PROMPT rows > 32;
    # a decode step's GEN_BATCH rows run every expert on every token)
    wants = {"flash_sdpa": L, "gmm": 3 * routed}
    for name, c in counts.items():
        assert c == {"launches": wants.get(name, 0), "plain_calls": 0}, \
            (name, c)
    assert dict(attn_routes.route_counts) == {
        "flash": L, "flash_segmented": 0, "composite": 0}
    assert tuple(tok.shape) == (GEN_BATCH, GEN_NEW)
    assert bool(torch.isfinite(scores).all())
    assert calls[0][0] == GEN_PROMPT and len(calls) == GEN_NEW
    decode = [ms for width, ms in calls[1:]]
    return {"batch": GEN_BATCH, "prompt": GEN_PROMPT, "new_tokens": GEN_NEW,
            "layers": L, "prefill_ms": calls[0][1],
            "decode_token_ms_median": statistics.median(decode),
            "wall_s": wall, "tokens_per_s": GEN_BATCH * GEN_NEW / wall,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "flash_launches": counts["flash_sdpa"]["launches"],
            "gmm_launches": counts["gmm"]["launches"]}


# ------------------------------------------------------------- phase 6/7
TINY_TRAIN = dict(num_hidden_layers=2, num_attention_heads=2,
                  num_key_value_heads=1, max_position_embeddings=64)


def train_run(pcfg, model, batches):
    """Pretraining steps over `batches`; (losses, grad norms, launch
    counts of the run)."""
    state, step, _ = build_llama_pretrain_step(pcfg, model=model)
    n0 = ops.launch_counts()
    losses, norms = [], []
    for ids, labels in batches:
        state, m = step(state, ids, labels)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    n1 = ops.launch_counts()
    delta = {k: {f: n1[k][f] - n0[k][f] for f in n1[k]} for k in n1}
    return losses, norms, delta


#: phase 6's limits on the card's losses and grad norms against the
#: CPU's, relative: in f32 the kernels and cuBLAS sum in other orders
#: than the CPU; in bf16 they also round p, ds and the products at other
#: places than the CPU's plain versions. Set from readings of the sound
#: kernels and of planted faults (flash_limits.py, PERF.md).
TINY_TRAIN_LIMITS = {"float32": {"loss": 1e-4, "grad_norm": 1e-4},
                     "bfloat16": {"loss": 2e-3, "grad_norm": 2e-2}}


def tiny_train_readings(param_dtype: str):
    """A tiny Llama (head_dim 64, 2 query heads on 1 KV head), 3
    pretraining steps in `param_dtype` compute on the CPU (plain
    versions) and on the card (kernels) from the same weights: both
    trajectories and their largest relative distances."""
    cfg = llama_tiny_config(**TINY_TRAIN)
    cpu_model = LlamaForCausalLM(cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model).to(DEV)
    pcfg = PretrainConfig(cfg, global_batch=2, seq_len=48,
                          param_dtype=param_dtype, remat="none")
    rng = np.random.RandomState(2)
    batches = []
    for _ in range(3):
        ids = rng.randint(0, cfg.vocab_size, (2, 48))
        batches.append((ids, np.roll(ids, -1, axis=1)))
    cpu = train_run(pcfg, cpu_model, batches)
    card = train_run(pcfg, gpu_model, batches)
    L, n = cfg.num_hidden_layers, len(batches)
    for name in ("flash_sdpa", "flash_sdpa_bwd"):
        assert card[2][name] == {"launches": L * n, "plain_calls": 0}, name
        assert cpu[2][name]["launches"] == 0
    assert cpu[2]["flash_sdpa"]["plain_calls"] == L * n

    def rel(a, b):
        return float(np.max(np.abs(np.subtract(a, b)) / np.abs(b)))

    return {"steps": n, "losses_cpu": cpu[0], "losses_card": card[0],
            "grad_norms_cpu": cpu[1], "grad_norms_card": card[1],
            "loss_rel": rel(card[0], cpu[0]),
            "grad_norm_rel": rel(card[1], cpu[1])}


def tiny_train_parity():
    """Phase 6 in f32 and in bf16: the card's losses and grad norms
    within TINY_TRAIN_LIMITS of the CPU's."""
    out = {}
    for dt, lim in TINY_TRAIN_LIMITS.items():
        r = tiny_train_readings(dt)
        assert r["loss_rel"] <= lim["loss"], (dt, r)
        assert r["grad_norm_rel"] <= lim["grad_norm"], (dt, r)
        out[dt] = dict(r, limits=lim)
    return out


def train_8b(card):
    """Pretraining at Llama-3-8B width, depth cut to TRAIN_LAYERS: every
    timed step must launch the flash forward and backward once a layer,
    no plain version, and take no attention route but flash."""
    cfg = llama3_8b_config(num_hidden_layers=TRAIN_LAYERS,
                           max_position_embeddings=TRAIN_SEQ)
    pcfg = PretrainConfig(cfg, global_batch=1, seq_len=TRAIN_SEQ, lr=3e-4,
                          weight_decay=0.1, grad_clip=1.0, ce_chunks=4,
                          remat="none", param_dtype="bfloat16",
                          moment_dtype="float32")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=DEV, dtype=torch.float32,
                             generator=torch.Generator(DEV).manual_seed(0))
    state, step, _ = build_llama_pretrain_step(pcfg, device=DEV,
                                               model=model)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    g = torch.Generator(DEV).manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (1, TRAIN_SEQ), device=DEV,
                        generator=g)
    labels = torch.roll(ids, -1, dims=1)
    losses, norms, times = [], [], []

    def one_step():
        nonlocal state
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, ids, labels)
        losses.append(float(m["loss"]))         # waits for the step
        times.append((time.perf_counter() - t) * 1e3)
        norms.append(float(m["grad_norm"]))

    for _ in range(WARMUP_STEPS):
        one_step()
    ops.reset_counts()
    attn_routes.reset_route_counts()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TIMED_STEPS):
        one_step()
    counts = ops.launch_counts()
    routes = dict(attn_routes.route_counts)
    L, n = TRAIN_LAYERS, TIMED_STEPS
    for name, c in counts.items():
        want = L * n if name.startswith("flash_sdpa") else 0
        assert c == {"launches": want, "plain_calls": 0}, (name, c)
    assert routes == {"flash": L * n, "flash_segmented": 0,
                      "composite": 0}, routes
    assert all(np.isfinite(losses)) and all(np.isfinite(norms))
    assert losses[-1] < losses[0], losses
    step_ms = statistics.median(times[WARMUP_STEPS:])
    tok_s = TRAIN_SEQ / (step_ms / 1e3)
    n_params = sum(p.numel() for p in state.master.values())
    # bf16 compute + f32 master + 2 f32 moments + bf16 and f32 grads
    reckoned = n_params * (2 + 4 + 8 + 2 + 4)
    return {
        "card": card["nvidia_smi"], "layers": L, "layers_published": 32,
        "hidden": cfg.hidden_size, "heads": cfg.num_attention_heads,
        "kv_heads": cfg.num_key_value_heads, "ffn": cfg.intermediate_size,
        "vocab": cfg.vocab_size, "batch": 1, "seq": TRAIN_SEQ,
        "params": n_params, "model_init_s": init_s,
        "warmup_steps": WARMUP_STEPS, "timed_steps": n,
        "step_ms_median": step_ms, "step_ms": times,
        "tokens_per_s": tok_s,
        "train_mfu": tok_s * flops_per_token(cfg) / PEAK_FLOPS_PER_S[
            torch.bfloat16],
        "train_mfu_hw": tok_s * flops_per_token_hw(cfg, TRAIN_SEQ)
        / PEAK_FLOPS_PER_S[torch.bfloat16],
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "state_bytes_reckoned": reckoned,
        "losses": losses, "grad_norms": norms,
        "launches_per_step": {"flash_sdpa": L, "flash_sdpa_bwd": L},
    }, {k: v["launches"] for k, v in counts.items() if v["launches"]}


def same_share(a: dict, b: dict) -> float:
    """Share of greedy tokens of `b` equal to `a`'s, request by request."""
    toks = [(a[r], b[r]) for r in a]
    return sum(int((x == y).sum()) for x, y in toks) \
        / sum(x.size for x, _ in toks)


SOURCES = {
    "fused_rms_norm": ("paddle_tpu_torch/ops/csrc/fused.cu",
                       "paddle_tpu/ops/fused.py:100"),
    "fused_layer_norm": ("paddle_tpu_torch/ops/csrc/fused.cu",
                         "paddle_tpu/ops/fused.py:122"),
    "fused_rope_append": ("paddle_tpu_torch/ops/csrc/fused.cu",
                          "paddle_tpu/ops/fused.py:396"),
    "ragged_paged_attention": ("paddle_tpu_torch/ops/csrc/"
                               "ragged_attention.cu",
                               "paddle_tpu/ops/pallas_ragged.py:139"),
    "fused_qkv_rope_append": ("paddle_tpu_torch/ops/csrc/megakernels.cu",
                              "paddle_tpu/ops/pallas_megafront.py:356"),
    "fused_oproj_norm": ("paddle_tpu_torch/ops/csrc/megakernels.cu",
                         "paddle_tpu/ops/pallas_megadecode.py:182"),
    "fused_ffn": ("paddle_tpu_torch/ops/csrc/megakernels.cu",
                  "paddle_tpu/ops/pallas_megadecode.py:341"),
    "flash_sdpa": ("paddle_tpu_torch/ops/csrc/flash_attention.cu",
                   "paddle_tpu/ops/pallas_flash.py:335"),
    "flash_sdpa_bwd": ("paddle_tpu_torch/ops/csrc/flash_attention.cu",
                       "paddle_tpu/ops/pallas_flash.py:335"),
    "paged_decode_attention": ("paddle_tpu_torch/ops/csrc/"
                               "paged_attention.cu",
                               "paddle_tpu/ops/pallas_paged.py:263"),
    "paged_decode_attention_v2": ("paddle_tpu_torch/ops/csrc/"
                                  "paged_attention.cu",
                                  "paddle_tpu/ops/pallas_paged.py:201"),
    "weight_only_linear": ("paddle_tpu_torch/ops/csrc/megakernels.cu",
                           "paddle_tpu/ops/quant.py:227"),
    "gmm": ("paddle_tpu_torch/ops/csrc/gmm.cu",
            "paddle_tpu/ops/pallas_gmm.py:204"),
}
#: the megakernels' quantized sites, reported inside their rows
QUANT_SITES = ("fused_qkv_rope_append", "fused_oproj_norm", "fused_ffn")
#: the gpt family's sites of two megakernels, reported inside their rows
GPT_SITES = {"fused_oproj_norm": "layer", "fused_ffn": "gelu"}
#: the readings a site's sub-row of the kernels line carries
SITE_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "split_ms", "rel_err_bf16")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_report()
    print(card["nvidia_smi"], flush=True)
    _build.library()
    regs = [ln.split(":", 1)[1].strip() for ln in _build.build_log()
            .splitlines() if "Used" in ln and "registers" in ln]
    emit("1 card+build", card=card, build_s=_build.build_seconds(),
         ptxas=regs, spills=ptxas_spills(_build.build_log()))

    rows = check_kernels(Timer())
    emit("2 kernels", card=card["nvidia_smi"], kernels=rows)

    tiny = tiny_engine_parity()
    emit("3 tiny engine and generation cpu vs card", **tiny)

    # the main path: Llama-3-8B on the default fused chain; then the
    # split chain, the alternating path and generate_cached on the same
    # weights, each with its counts read alone
    cfg = llama3_8b_config()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=DEV, dtype=torch.bfloat16,
                             generator=torch.Generator(DEV).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    fused_launches: dict = {}
    fused_out, res = serve_trace(model, "fused", fused_launches)
    emit("4 llama3-8b serving, fused chain", card=card["nvidia_smi"],
         model_init_s=init_s, **res)
    torch.cuda.empty_cache()
    split_launches: dict = {}
    split_out, res = serve_trace(model, "split", split_launches)
    emit("5 llama3-8b serving, split chain", card=card["nvidia_smi"],
         identical_token_share_vs_fused=same_share(fused_out, split_out),
         **res)
    torch.cuda.empty_cache()
    alt_launches: dict = {}
    alt_out, res = serve_trace(model, "alternating", alt_launches)
    emit("6 llama3-8b serving, alternating path", card=card["nvidia_smi"],
         identical_token_share_vs_fused=same_share(fused_out, alt_out),
         **res)
    torch.cuda.empty_cache()
    v1_launches: dict = {}
    v1_out, res = serve_trace(model, "alternating", v1_launches, "intree_v1")
    emit("6 llama3-8b serving, alternating path, intree_v1",
         card=card["nvidia_smi"],
         identical_token_share_vs_fused=same_share(fused_out, v1_out),
         identical_token_share_vs_v2=same_share(alt_out, v1_out), **res)
    torch.cuda.empty_cache()
    emit("7 llama3-8b generate_cached", card=card["nvidia_smi"],
         **generate_cached_run(model))
    torch.cuda.empty_cache()
    # weight-only quantized serving of the same model and trace: the
    # engine quantizes the tree on the card (quantize_s), each run's
    # counts read alone, each engine freed before the next
    quant_launches, quant_out = {}, {}
    for tag, quant, chain in (("7a", "int8", "fused"), ("7b", "int4", "fused"),
                              ("7c", "int4", "split")):
        launches: dict = {}
        q_out, res = serve_trace(model, chain, launches, quant=quant)
        key = f"{quant} {chain}"
        quant_launches[key], quant_out[key] = launches, q_out
        shares = {"identical_token_share_vs_fused":
                  same_share(fused_out, q_out)}
        if key == "int4 split":      # the same int4 weights on both chains
            shares["identical_token_share_vs_int4_fused"] = same_share(
                quant_out["int4 fused"], q_out)
        emit(f"{tag} llama3-8b serving, {quant} weights, {chain} chain",
             card=card["nvidia_smi"], quantize_s=res.pop("engine_build_s"),
             **shares, **res)
        gc.collect()
        torch.cuda.empty_cache()
    del model
    gc.collect()
    torch.cuda.empty_cache()

    emit("8 tiny training cpu vs card", **tiny_train_parity())
    res, train_launches = train_8b(card)
    emit("9 llama3-8b-width pretraining, 4 of 32 layers", **res)
    gc.collect()
    torch.cuda.empty_cache()

    # GPT-3 6.7B at full width and depth (tied head, bf16 weights drawn on
    # the card): the fused chain (its layer-norm and gelu sites), the split
    # chain and the alternating path on the same trace, then
    # generate_cached; then Qwen2-7B on the fused chain and the alternating
    # path; each model freed before the next
    t0 = time.perf_counter()
    model = GPTForCausalLM(gpt3_6_7b_config(), device=DEV,
                           dtype=torch.bfloat16,
                           generator=torch.Generator(DEV).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gpt_launches: dict = {}
    gpt_out, res = serve_trace(model, "fused", gpt_launches)
    emit("10 gpt3-6.7b serving, fused chain", card=card["nvidia_smi"],
         model_init_s=init_s, **res)
    torch.cuda.empty_cache()
    for chain, tag in (("split", "split chain"),
                       ("alternating", "alternating path")):
        out, res = serve_trace(model, chain, {})
        emit(f"10 gpt3-6.7b serving, {tag}", card=card["nvidia_smi"],
             identical_token_share_vs_fused=same_share(gpt_out, out), **res)
        torch.cuda.empty_cache()
    emit("10 gpt3-6.7b generate_cached", card=card["nvidia_smi"],
         **generate_cached_run(model))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = Qwen2ForCausalLM(Qwen2Config(**QWEN2_7B), device=DEV,
                             dtype=torch.bfloat16,
                             generator=torch.Generator(DEV).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    qwen_out, res = serve_trace(model, "fused", {})
    emit("11 qwen2-7b serving, fused chain", card=card["nvidia_smi"],
         model_init_s=init_s, **res)
    torch.cuda.empty_cache()
    out, res = serve_trace(model, "alternating", {})
    emit("11 qwen2-7b serving, alternating path", card=card["nvidia_smi"],
         identical_token_share_vs_fused=same_share(qwen_out, out), **res)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # ERNIE-4.5-21B-A3B's widths at full depth (44.2 GB of bf16 weights
    # drawn on the card): the fused chain, the alternating path,
    # generate_cached, then int8 weights on the fused chain (the int8 tree
    # beside the bf16 model: ~67 GB)
    t0 = time.perf_counter()
    model = MoEForCausalLM(MoEConfig(**ERNIE45_21B_A3B), device=DEV,
                           dtype=torch.bfloat16,
                           generator=torch.Generator(DEV).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    moe_launches: dict = {}
    moe_out, res = serve_trace(model, "fused", moe_launches)
    emit("12 ernie45-21b-a3b serving, fused chain", card=card["nvidia_smi"],
         model_init_s=init_s,
         gmm_launches_per_step=moe_launches["gmm"] / res["launches"], **res)
    torch.cuda.empty_cache()
    out, res = serve_trace(model, "alternating", {})
    emit("12 ernie45-21b-a3b serving, alternating path",
         card=card["nvidia_smi"],
         identical_token_share_vs_fused=same_share(moe_out, out), **res)
    torch.cuda.empty_cache()
    emit("12 ernie45-21b-a3b generate_cached", card=card["nvidia_smi"],
         **generate_cached_run(model))
    torch.cuda.empty_cache()
    launches: dict = {}
    out, res = serve_trace(model, "fused", launches, quant="int8")
    emit("12 ernie45-21b-a3b serving, int8 weights, fused chain",
         card=card["nvidia_smi"], quantize_s=res.pop("engine_build_s"),
         identical_token_share_vs_fused=same_share(moe_out, out),
         gmm_launches_per_step=launches["gmm"] / res["launches"], **res)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    kernels = []
    paths = (("fused", fused_launches), ("split", split_launches),
             ("alternating", alt_launches),
             ("alternating, intree_v1", v1_launches),
             ("train", train_launches),
             ("int4 split", quant_launches["int4 split"]),
             ("gpt3-6.7b fused", gpt_launches),
             ("ernie45-21b-a3b fused", moe_launches))
    for name, (src, replaces) in SOURCES.items():
        r = rows[name]
        path, launches = next((p, c[name]) for p, c in paths if name in c)
        row = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches, "path": path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "split_ms": r.get("split_ms"),
            "rel_err_bf16": r.get("rel_err_bf16")}
        if name in QUANT_SITES:
            for q in ("int8", "int4"):
                row[q] = dict({k: r[q][k] for k in SITE_KEYS},
                              launches=quant_launches[f"{q} fused"][name])
        if name in GPT_SITES:
            site = GPT_SITES[name]
            row[site] = dict({k: r[site][k] for k in SITE_KEYS},
                             launches=gpt_launches[name])
        for rep_ in REP_SHAPES:
            if rep_ in r:
                row[rep_] = {k: r[rep_][k] for k in (
                    "heads", "kv_heads", "max_abs_err", "ms", "plain_ms",
                    "bound_ms", "bound_by")}
        if name == "weight_only_linear":
            # int4_dequantize's work on the MoE int4 path runs here
            row["int4_dequantize"] = {
                "replaces": "paddle_tpu/ops/quant.py:83",
                "site": "the int4 MoE shared expert",
                "path": "phase 3 tiny ERNIE 4.5 MoE, int4 fused",
                "launches": tiny["moe"]["int4/fused"][
                    "int4_dequantize_work"]}
            row["cases"] = {k: {f: v[f] for f in ("ms", "bound_ms",
                                                  "bound_by", "split_ms",
                                                  "library_ms",
                                                  "rel_err_bf16")}
                            for k, v in r["cases"].items()
                            if k.endswith("bf16")}
        if name == "gmm":
            row["cases"] = {k: {f: v.get(f) for f in (
                "m", "k", "n", "groups_with_rows", "largest_group", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms",
                "rel_err_bf16")}
                for k, v in r["cases"].items() if k.endswith("bf16")}
        kernels.append(row)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
