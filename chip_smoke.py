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
   by relative errors (`paged_rel_errors`), f32 at 2e-5; the ragged
   kernel also with the chunk idle (a decode-only step, held as the
   mixed one, its idle rows zero) and at the long-context shape (8
   decode rows over those tables), its bf16 outputs also held by
   `row_rel_errors` within MLA_BF16_LIMITS["ragged_576"] (`ragged_rel`);
   the int8 and
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
   prefill (2048 tokens: M 12288), training (4096 tokens: M 24576), and
   at edge cases (empty groups, one group holding every row, rows past
   the last group, N 64), bf16 by relative errors within GMM_BF16_LIMITS
   (the edge cases by the tensor error within GMM_EDGE_TENSOR_LIMIT),
   f32 at 2e-5, the tail rows exactly zero; library_ms torch._grouped_mm;
   gmm's backward kernels (`check_gmm_backward`: dlhs and tgmm) the same
   way at the training routing, both directions, and at edge cases with
   empty first, middle and last groups, dlhs's tail rows and the empty
   groups' drhs slabs exactly zero, timed beside torch._grouped_mm where
   it takes the case; the four incubate kernels at their paths' shapes
   (`check_incubate_kernels`): swiglu on two [4096, 14336] operands and
   the split form of one [4096, 28672], fused_rope on Llama-3-8B's q / k
   over 4096 positions and its backward launch, fused_bias_residual_
   layer_norm at [4096, 4096], fused_moe_dispatch_combine at
   ERNIE-4.5-21B-A3B's routing of 4096 tokens (E 64, k 6, C 480, f32),
   bf16 within one bf16 spacing (`max_bf16_spacings`), f32 at 2e-5, the
   MoE outputs exact, each timed beside its plain version and its bytes
   bound (no one PyTorch call computes any of them);
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
8b. a tiny ERNIE 4.5 MoE (a dense first layer, 2 routed layers of 8
   experts, top-2, a shared expert, dropless) takes 3 eager AdamW steps
   (clip 1.0) on the CPU and on the card from the same weights, in f32
   and in bf16 through amp.decorate O2: losses, aux losses and grad norms
   within TINY_MOE_TRAIN_LIMITS, and on the card exactly 3 gmm, 3
   gmm_dlhs and 3 tgmm a routed layer a step, no plain call;
8c. FlashMask and varlen attention, CPU (plain) vs card (kernels), f32,
   B 2, H 2: flashmask_attention over the JAX tests' four encodings,
   causal C=1 over packed documents and one mask a head, at S 256 / D 64
   and S 200 / D 128 (ragged tiles), forward and gradients through
   autograd (o within 2e-5, gradients 1e-4, one forward and one backward
   launch a call); the bf16 kernels against the plain version on the card
   at S 200 by the flash limits; flash_attn_unpadded at equal and cross
   cu_seqlens (`tiny_flashmask_parity`);
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
9b. FlashMask at Llama-3-8B's attention width as a packed SFT step calls
   it (B 1, S 8192, 32 heads x 128, bf16; `check_flashmask`): causal C=1
   over seeded documents of 256-2048 tokens, the JAX tests' causal C=2,
   non-causal C=2 and C=4 bands scaled by 32, and causal C=1 with its
   own documents in each of the 32 heads, each forward and backward
   through flashmask_attention and autograd with the counts read alone
   (one forward and one backward launch a call, no plain call, no
   composite route), held to the plain version (4 heads at a time) by the
   flash limits; flash_attn_unpadded over the same documents against
   causal C=1; an f32 run at S 2048 (o 2e-5, gradients 1e-4); then each
   encoding's forward and backward timed beside its bound over the
   visible pairs counted from the bands (2 products forward, 5 backward),
   the share of 64 x 64 tiles skipped, and for the documents the plain
   versions, the port's flash with segment ids (the same function,
   `segmented_ms`) and PyTorch's SDPA under the dense bool mask
   (`library_ms`, where no row is empty);
9c. the incubate API and the standalone fuse at full width
   (`incubate_paths`): fused_rotary_position_embedding at Llama-3-8B's
   attention with the [S, D/2] and Paddle's [S, D] tables and swiglu at
   its FFN (split and two operands), forward and backward; fuse over
   fused_bias_dropout_residual_layer_norm's eval form at GPT-3 6.7B's
   width and over top_k_gating at ERNIE-4.5-21B-A3B's routing (one
   rewrite and one launch each, no untraced program); a BERT-base
   FusedTransformerEncoderLayer forward (one flash launch); exact launch
   counts, every kernel held against its plain version;
9d. Llama-3-8B width, depth cut to 4 layers, 1 x 4096 tokens, bf16 by
   amp.decorate O2, eager AdamW (lr 3e-4, decay 0.1, clip 1.0), 2 + 3
   steps through jit.to_static with FLAGS_use_fusion_compiler and again
   without (`to_static_training`): one swiglu rewrite a layer, swiglu
   launched once a layer a step on the flagged run only, flash forward
   and backward once a layer on both, one captured graph, no untraced
   program; each step's two losses within 2^-7 relative;
9e. the static inference path at Llama-3-8B width, depth cut to 4
   layers, bf16 weights drawn on the card (`static_inference`):
   jit.save at InputSpec([1, 2048], "int64"), then inference.Config ->
   create_predictor -> copy_from_cpu -> run -> copy_to_cpu without and
   with FLAGS_use_fusion_compiler (the fusion_cc pass: rmsnorm 9, swiglu
   4, generic 16 rewrites, nothing refused); exact launches per run
   (flagged: fused_rms_norm 9, swiglu 4, generic_elementwise 16, flash
   forward 4; unflagged: the flash forward 4 and nothing else); the
   logits of the two runs within SI_LOGITS_BAR relative, which a planted
   fault of the rewrite (the rope regions' subtract computed as add)
   must miss; export + save, load and first-run seconds, the artifact's
   bytes;
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
12b. MoE training at ERNIE-4.5-21B-A3B's widths with the depth cut to
   MOE_TRAIN_LAYERS (4 of 28: layer 0 dense, 3 routed), batch 1 x 4096,
   bf16 through amp.decorate O2 over f32 master weights and AdamW
   moments (lr 3e-4, weight decay 0.1, ClipGradByGlobalNorm(1.0), aux
   weight 0.01), weights drawn on the card: 2 warm-up and 5 timed eager
   steps; median step ms, tokens/s, train_mfu (6 N_active a token, the
   embedding left out), peak memory, the loss and aux-loss trajectories
   and the experts holding rows in each routed layer a step; the loss
   must be finite and fall, and every timed step must launch 3 gmm, 3
   gmm_dlhs and 3 tgmm a routed layer and the flash forward and backward
   once a layer, nothing else;
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
   fused chain beside its training launches from phase 12b, gmm_dlhs's
   and tgmm's from phase 12b, flashmask_sdpa's and its backward's from
   phase 9b with the packed documents' readings, swiglu's from phase 9d's
   flagged run, generic_elementwise's from phase 9e's flagged run,
   fused_rope's, its backward's,
   fused_bias_residual_layer_norm's and fused_moe_dispatch_combine's from
   phase 9c), then the ``{"ok":
   true, ...}`` line.

Phase 2 also holds the generic elementwise kernel (B11) against its
plain version (`check_generic_elementwise`): the JAX test's chain at
[4096, 14336] in f32 and bf16 and phase 9e's rope region on q, timed
beside the bytes bound, f32 within EW_F32_ULPS ulps and bf16 within one
spacing, a planted fault (one opcode swapped) missing the bar by
EW_FAULT_FACTOR at least, and every opcode of the instruction set.

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
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from paddle_tpu_torch import amp, card_report, generation, inference, jit, ops
from paddle_tpu_torch import optimizer as optim
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.flags import flags_guard
from paddle_tpu_torch.incubate import moe as moe_ffn
from paddle_tpu_torch.models import (DeepSeekV2Config, DeepSeekV2ForCausalLM,
                                     Ernie45MoEForCausalLM,
                                     GPTForCausalLM, MoEConfig,
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
from paddle_tpu_torch.ops import flashmask as fm_kernels
from paddle_tpu_torch.ops.flash import _launch_fwd
from paddle_tpu_torch.ops.flashmask import band_hidden
from paddle_tpu_torch.nn.functional import flash_attention as fm_api
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.engine import mla_split_front
from paddle_tpu_torch.static import InputSpec
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
#: DeepSeek-V2-Lite's published config (deepseek-ai/DeepSeek-V2-Lite
#: config.json) in the JAX DeepSeek-V2 family's terms: MLA without q-lora
#: (kv_lora_rank 512, heads of 128 nope + 64 rope dims, v 128), layer 0
#: dense (FFN 10944), 26 routed over 64 experts of 1408, top-6, its two
#: shared experts as one SwiGLU of 2816, untied head; 15.7 B parameters.
#: Departures, all the family's own: plain rope (the config has no yarn
#: rope_scaling to drop, and the family has none); the top-k
#: probabilities renormalized (MoELayer's default; the config says
#: norm_topk_prob false); routed_scaling_factor 1, topk_method "greedy"
#: and n_group 1, as the family routes; dropless routing (serving always
#: routes dropless). No width or depth cut; max_position_embeddings
#: stays 163840 (its rope tables are 42 MB)
DEEPSEEK_V2_LITE = dict(vocab_size=102400, hidden_size=2048,
                        intermediate_size=10944, num_hidden_layers=27,
                        num_attention_heads=16, num_key_value_heads=16,
                        max_position_embeddings=163840, rope_theta=10000.0,
                        rms_norm_eps=1e-6, q_lora_rank=None,
                        kv_lora_rank=512, qk_nope_head_dim=128,
                        qk_rope_head_dim=64, v_head_dim=128,
                        num_experts=64, top_k=6, moe_intermediate_size=1408,
                        shared_expert_intermediate_size=2816,
                        first_k_dense_replace=1, moe_dropless=True)
#: phase 3's tiny DeepSeek-V2: widths every MLA kernel takes on the card
#: (latent 64 + rope 64 = a 128-wide pool row, q / k heads of 128, v of
#: 64 padded to 128 for the flash prefill), a dense first layer and a
#: routed one of 8 experts
TINY_MLA = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=4, max_position_embeddings=64,
                kv_lora_rank=64, qk_nope_head_dim=64, qk_rope_head_dim=64,
                v_head_dim=64, num_experts=8, top_k=2,
                moe_intermediate_size=64, shared_expert_intermediate_size=64,
                first_k_dense_replace=1, moe_dropless=True)
#: the MoE step's rows: the unified step's (4 slots + a 128-token chunk)
#: and generate_cached's prefill (4 x 512) tokens
MOE_STEP_TOKENS, MOE_PREFILL_TOKENS = SLOTS + CHUNK, 4 * 512
#: MoE training at ERNIE-4.5-21B-A3B's widths: depth cut from 28 to 4
#: layers (layer 0 dense, 3 routed), batch 1 x 4096 tokens (M = 4096 x 6
#: = 24576 routed rows a layer), no recompute (it fits on 80 GB)
MOE_TRAIN_LAYERS, MOE_TRAIN_SEQ, MOE_TRAIN_RECOMPUTE = 4, 4096, False


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
    head), each tile's norm floored at 1% of the median nonzero tile
    norm, so that a tile whose true value is zero (rows that see no key) is held
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
    # the median over tiles whose true value is not zero: a FlashMask band
    # can leave half the rows of a head without a key
    floor = 1e-2 * float(wn[wn > 0].median())
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
#: gmm's backward kernels, bf16, held the same way: (tensor, row) relative
#: errors at the training routing (dlhs over its [M, K] rows, tgmm over
#: the K rows of each slab that holds rows), the edge cases by the tensor
#: error alone; sound and planted readings: gmm_limits.py, PERF.md
GMM_BWD_BF16_LIMITS = {"gmm_dlhs": (3e-4, 2e-3), "tgmm": (3e-4, 2e-3)}
GMM_BWD_EDGE_TENSOR_LIMIT = 5e-4


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
                                                    ref, tabs, dtype))
        check_megakernels(timer, mb, cos, sin, rows, dtype, tol[dtype], gc)
        check_quantized_megakernels(timer, mb, cos, sin, rows, dtype,
                                    tol[dtype], gc)
        check_paged(timer, rows, dtype, gc, *decode_batch(
            g, SLOTS, MAX_CTX // PSZ, [300, 1024, 517, 1], idle=3))
    check_paged(timer, rows, torch.bfloat16, gc, *long_context_batch(g),
                tag="long")
    check_ragged_long(timer, rows, g, gc)
    check_rep_shapes(timer, rows, g, gc, mb)
    check_gpt_kernels(timer, rows, gc, mb)
    check_flash(timer, rows)
    check_weight_only_linear(timer, rows)
    check_gmm(timer, rows)
    check_gmm_backward(timer, rows)
    check_mla_kernels(timer, rows)
    check_incubate_kernels(timer, rows)
    check_generic_elementwise(timer, rows)
    return rows


def ragged_rel(name, got, want, tabs):
    """Hold a bf16 ragged output, beside the 2e-2 bar, by `row_rel_errors`
    over the (row, head) vectors of the rows some sequence owns, within
    the limits of the latent-row site (MLA_BF16_LIMITS["ragged_576"]);
    returns the readings."""
    live = torch.zeros(got.shape[0], dtype=torch.bool)
    for a, n in zip(tabs[0].tolist(), tabs[1].tolist()):
        live[a:a + n] = True
    live = live.to(got.device)
    return assert_rel_bf16(name, got[live], want[live],
                           MLA_BF16_LIMITS["ragged_576"])


def time_ragged(timer, qa, kp, vp, o, ref, tabs, dtype):
    """The ragged kernel's time over a mixed batch beside its plain
    version and its bound (the live K/V rows, q, o and the tables, or the
    4 H D operations of every visible (query, key) pair, whichever is
    longer), held by its bf16 relative errors (`ragged_rel`), and the
    same step with the prefill chunk idle (a decode-only step): held to
    its plain version at the same 2e-2 bar and relative limits, the rows
    no live sequence owns exactly zero, and timed beside that step's
    bytes bound."""
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
    n0 = ops.ragged_paged_attention.launches
    od = ops.ragged_paged_attention(qa, kp, vp, *dec)
    torch.cuda.synchronize()
    assert ops.ragged_paged_attention.launches == n0 + 1
    refd = ops.ragged_attention_reference(qa, kp, vp, *dec)
    torch.testing.assert_close(od.float(), refd.float(), atol=2e-2,
                               rtol=2e-2)
    owned = torch.zeros(od.shape[0], dtype=torch.bool)
    for a, n in zip(dec[0].tolist(), dec[1].tolist()):
        owned[a:a + n] = True
    assert float(od[~owned.to(od.device)].float().abs().sum()) == 0.0
    return dict(
        bound_ms=b, bound_by=by,
        ms=timer.ms(lambda: ops.ragged_paged_attention(qa, kp, vp, *tabs)),
        plain_ms=timer.ms(lambda: ops.ragged_attention_reference(
            qa, kp, vp, *tabs)),
        library_ms=None, live_kv_bytes=live, qk_pairs=pairs,
        rel_err_bf16=ragged_rel(f"ragged H {hq} KV {kv}", o, ref, tabs),
        decode_only_max_abs_err=max_err(od, refd),
        decode_only_rel_err_bf16=ragged_rel(
            f"ragged decode-only H {hq} KV {kv}", od, refd, dec),
        decode_only_ms=timer.ms(
            lambda: ops.ragged_paged_attention(qa, kp, vp, *dec)),
        decode_only_bound_ms=bound(nbytes(qa, o, *tabs) + dec_live)[0])


def check_ragged_long(timer, rows, g, gc):
    """The ragged kernel at the long-context shape (LONG_SEQS decode rows,
    one a sequence, over `long_context_batch`'s tables and lengths; the 8B
    heads), bf16: held to its plain version at the 2e-2 bar and by its
    relative errors (`ragged_rel`), timed beside its plain version and
    the bytes bound; readings under rows[name]["long"]."""
    P, lens, tables = long_context_batch(g)
    B = lens.shape[0]
    tabs = (torch.arange(B, dtype=torch.int32, device=DEV),
            torch.ones(B, dtype=torch.int32, device=DEV), lens, tables)

    def rnd(*shape):
        return torch.randn(*shape, device=DEV, generator=gc).to(
            torch.bfloat16)

    qa, kp, vp = rnd(B, HQ, D), rnd(KV, P, PSZ, D), rnd(KV, P, PSZ, D)
    n0 = ops.ragged_paged_attention.launches
    o = ops.ragged_paged_attention(qa, kp, vp, *tabs)
    torch.cuda.synchronize()
    assert ops.ragged_paged_attention.launches == n0 + 1
    ref = ops.ragged_attention_reference(qa, kp, vp, *tabs)
    torch.testing.assert_close(o.float(), ref.float(), atol=2e-2, rtol=2e-2)
    live = int(tabs[2].sum()) * KV * D * 2 * qa.element_size()
    b_, by = bound(live + nbytes(qa, o, *tabs))
    rows["ragged_paged_attention"]["long"] = dict(
        heads=HQ, kv_heads=KV, lengths=tabs[2].tolist(),
        max_abs_err=max_err(o, ref),
        rel_err_bf16=ragged_rel("ragged long", o, ref, tabs),
        bound_ms=b_, bound_by=by,
        ms=timer.ms(lambda: ops.ragged_paged_attention(qa, kp, vp, *tabs)),
        plain_ms=timer.ms(lambda: ops.ragged_attention_reference(
            qa, kp, vp, *tabs)),
        library_ms=None, live_kv_bytes=live)


#: the query / KV heads of the two geometries the Llama-3-8B shapes leave
#: untried: GPT-3 6.7B's MHA (rep 1) and Qwen2-7B's 28 / 4 (rep 7)
REP_SHAPES = {"rep1": (32, 32), "rep7": (28, 4)}


def check_rep_shapes(timer, rows, g, gc, mb):
    """The ragged kernel over the mixed batch and both paged decode
    kernels over the alternating decode batch at REP_SHAPES, bf16, each
    against its plain version (ragged at 2e-2 and by `ragged_rel`, paged
    by `assert_paged_bf16`) and timed beside it and its bound; readings
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
            **time_ragged(timer, qa, kp, vp, o, ref, tabs, dtype))
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
    128256]), `generate_cached`'s decode product (M = 4 x [4096 -> 14336],
    whose 56 column tiles take a K split) and a ragged case (odd M, N =
    1000: byte copies, a masked last column tile); f32 at 2e-5, bf16 by
    `row_rel_errors`. In bf16
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
              "head": (SLOTS + 1, H, VOCAB), "decode": (SLOTS, H, FFN),
              "ragged": (7, H, 1000)}
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


def gmm_tile_edges(sizes) -> dict:
    """The edge cases of the bf16 kernels' tiles, maps and schedule, as
    key -> (K, N, group sizes, tail rows): K not a multiple of the 64-deep
    box (the 3-D weight map and the lhs map zero-fill past K), N not a
    multiple of the 256-column tile, group boundaries inside a 64-row
    wgmma slice, one group of 5000 rows split over many blocks, more
    groups (160, of 0-8 rows) than SMs, empty first and last groups with
    tail rows, and fewer than 64 rows in all."""
    return {"edge/k136": (136, 256, sizes(70, 0, 90, 33), 20),
            "edge/n200": (128, 200, sizes(100, 50, 0, 77), 10),
            "edge/mid_slice": (128, 256, sizes(37, 90, 5, 131, 1), 13),
            "edge/one_big": (256, 512, sizes(0, 5000, 3), 0),
            "edge/g160": (128, 128, sizes(*[(7 * i) % 9
                                            for i in range(160)]), 5),
            "edge/empty_ends": (128, 256, sizes(0, 40, 0, 60, 0), 17),
            "edge/m_lt_64": (64, 64, sizes(5, 0, 20), 3)}


def check_gmm(timer, rows, hold: bool = True):
    """gmm against its plain version (each group's rows times its weight
    in f32, one cast) at ERNIE-4.5-21B-A3B's experts, the gate / up
    product [2560 -> 1536] and the down product [1536 -> 2560], under the
    three routings the path gives it: a decode step of the unified engine
    (MOE_STEP_TOKENS rows, SLOTS of them live, the rest padding that
    routes as one row: ~6 groups of ~130 rows and ~24 single rows; M
    792), a mixed step (all MOE_STEP_TOKENS rows live, a prefill chunk
    with the decodes: ~12 rows a group over all 64 experts) and
    generate_cached's prefill (M 12288), and the training step's
    (MOE_TRAIN_SEQ tokens: M 24576, routed as `check_gmm_backward`
    routes them); and edge cases with rows past the last group, empty
    groups, one group holding every row, N 64 (the tiny preset's expert
    width) and `gmm_tile_edges`. bf16 by `row_rel_errors` over the
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
    train = routed_group_sizes(MOE_TRAIN_SEQ, E, k, Hm, 3)

    def sizes(*n):
        return torch.tensor(n, dtype=torch.int32, device=DEV)

    cases = {"decode/up": (Hm, Im, decode, 0),
             "decode/down": (Im, Hm, decode, 0),
             "mixed/up": (Hm, Im, mixed, 0), "mixed/down": (Im, Hm, mixed, 0),
             "prefill/up": (Hm, Im, prefill, 0),
             "prefill/down": (Im, Hm, prefill, 0),
             "train/up": (Hm, Im, train, 0), "train/down": (Im, Hm, train, 0),
             "edge/uneven": (128, 256, sizes(100, 0, 200, 150, 62), 88),
             "edge/one_group": (128, 128, sizes(0, 300, 0), 0),
             "edge/n64": (128, 64, sizes(10, 0, 25, 5), 30),
             **gmm_tile_edges(sizes)}
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


def check_gmm_backward(timer, rows, hold: bool = True):
    """gmm's backward kernels against their plain versions: dlhs
    (`ops.gmm_dlhs`: dout [M, N] times each group's [K, N] slab read as
    [N, K], against ``gmm_plain(dout, rhs.transpose(1, 2))``) and drhs
    (`ops.tgmm`: [G, K, N], each group's lhs rows transposed times its
    dout rows, against `ops.tgmm_plain`) at the training routing of
    ERNIE-4.5-21B-A3B's experts (MOE_TRAIN_SEQ tokens top-6 over 64 by a
    seeded router: M 24576) for the gate / up product [2560 -> 1536] and
    the down product [1536 -> 2560], and at the edge cases (empty first,
    middle and last groups with rows past the last group; one group
    holding every row; N 64; `gmm_tile_edges`). bf16 by `row_rel_errors`
    within
    GMM_BWD_BF16_LIMITS (the edge cases by the tensor error within
    GMM_BWD_EDGE_TENSOR_LIMIT), f32 at 2e-5; dlhs's tail rows and the
    empty groups' drhs slabs exactly zero (tgmm's output is drawn from
    memory just filled with NaN, so a skipped slab shows). The training
    cases in bf16 are timed (with a `timer`) beside the plain version,
    the bound (the rows read and written, the slabs of the groups that
    hold rows, or 2 M K N operations at the working type's peak) and
    torch._grouped_mm where it takes the case (dlhs: rhs transposed;
    drhs: the 2-D x 2-D case over the group ends; a refusal is
    recorded with its reason). The rows' headline numbers are the gate /
    up product's in bf16. `hold` False only reads (gmm_limits.py)."""
    cfg = ERNIE45_21B_A3B
    E, k = cfg["num_experts"], cfg["top_k"]
    Hm, Im = cfg["hidden_size"], cfg["moe_intermediate_size"]
    gc_ = torch.Generator(DEV).manual_seed(6)
    train = routed_group_sizes(MOE_TRAIN_SEQ, E, k, Hm, 3)

    def sizes(*n):
        return torch.tensor(n, dtype=torch.int32, device=DEV)

    cases = {"train/up": (Hm, Im, train, 0), "train/down": (Im, Hm, train, 0),
             "edge/empties": (128, 256, sizes(0, 100, 0, 200, 150, 0), 88),
             "edge/one_group": (128, 128, sizes(0, 300, 0), 0),
             "edge/n64": (128, 64, sizes(10, 0, 25, 5), 30),
             **gmm_tile_edges(sizes)}
    out = {n: rows.setdefault(n, {"cases": {}}) for n in ("gmm_dlhs", "tgmm")}
    for key, (K, N, gs, tail) in cases.items():
        M = int(gs.sum()) + tail
        G, end = gs.numel(), M - tail
        edge = key.startswith("edge")
        empty = gs == 0
        for dtype in (torch.bfloat16, torch.float32):
            lhs = torch.randn(M, K, device=DEV, generator=gc_).to(dtype)
            rhs = (K ** -0.5 * torch.randn(G, K, N, device=DEV,
                                           generator=gc_)).to(dtype)
            dout = (0.05 * torch.randn(M, N, device=DEV,
                                       generator=gc_)).to(dtype)
            n0 = (ops.gmm_dlhs.launches, ops.tgmm.launches)
            with torch.no_grad():
                dl = ops.gmm_dlhs(dout, rhs, gs)
                # freed at once: tgmm's torch.empty output takes its block
                torch.full((G, K, N), float("nan"), dtype=dtype, device=DEV)
                dr = ops.tgmm(lhs, dout, gs)
            torch.cuda.synchronize()
            assert (ops.gmm_dlhs.launches, ops.tgmm.launches) == \
                (n0[0] + 1, n0[1] + 1)
            plain = {"gmm_dlhs": lambda: ops.gmm_plain(
                         dout, rhs.transpose(1, 2), gs),
                     "tgmm": lambda: ops.tgmm_plain(lhs, dout, gs)}
            for name, got in (("gmm_dlhs", dl), ("tgmm", dr)):
                want = plain[name]()
                zero = int(got[end:].count_nonzero()) == 0 \
                    if name == "gmm_dlhs" else \
                    int(got[empty].count_nonzero()) == 0
                finite = bool(torch.isfinite(got).all())
                assert not hold or (zero and finite), (name, key)
                case = {"m": M, "k": K, "n": N, "groups": G,
                        "groups_with_rows": int((~empty).sum()),
                        "largest_group": int(gs.max()),
                        "max_abs_err": max_err(got, want),
                        "zero_where_due": zero, "finite": finite}
                tag = key + ("/bf16" if dtype == torch.bfloat16 else "/f32")
                if dtype == torch.float32:
                    case["close_2e-5"] = bool(torch.isclose(
                        got, want, atol=2e-5, rtol=2e-5).all())
                    if hold:
                        torch.testing.assert_close(got, want, atol=2e-5,
                                                   rtol=2e-5)
                    out[name]["cases"][tag] = case
                    continue
                held = (got[:end], want[:end]) if name == "gmm_dlhs" else \
                    (got[~empty].reshape(-1, N), want[~empty].reshape(-1, N))
                tensor, row = row_rel_errors(*held)
                case["rel_err_bf16"] = {"tensor": tensor, "row": row}
                lt, lr = GMM_BWD_BF16_LIMITS[name]
                if edge:
                    assert not hold or tensor <= GMM_BWD_EDGE_TENSOR_LIMIT, \
                        (name, tag, tensor)
                else:
                    assert not hold or (tensor <= lt and row <= lr), \
                        (name, tag, tensor, row)
                if not edge and timer is not None:
                    case.update(time_gmm_backward(timer, name, lhs, rhs, dout,
                                                  gs, got, want, plain[name]))
                out[name]["cases"][tag] = case
            del lhs, rhs, dout, dl, dr
    if timer is not None:
        for name in out:
            head = out[name]["cases"]["train/up/bf16"]
            out[name].update({f: head[f] for f in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_note", "rel_err_bf16")})


def time_gmm_backward(timer, name, lhs, rhs, dout, gs, got, want, plain):
    """ms, plain_ms, bound and torch._grouped_mm's time (or why it
    refused) of one backward kernel at a training case."""
    M, K = lhs.shape
    N = dout.shape[1]
    live = int((gs > 0).sum())
    slabs = live * K * N * rhs.element_size()
    ends = torch.cumsum(gs, 0, dtype=torch.int32)
    if name == "gmm_dlhs":
        moved = nbytes(dout, got, gs) + slabs
        run = lambda: ops.gmm_dlhs(dout, rhs, gs)          # noqa: E731
        lib = lambda: torch._grouped_mm(                    # noqa: E731
            dout, rhs.transpose(1, 2), offs=ends)
        held = lambda o: o[:int(gs.sum())]                  # noqa: E731
    else:
        moved = nbytes(lhs, dout, gs) + got.numel() * got.element_size()
        run = lambda: ops.tgmm(lhs, dout, gs)               # noqa: E731
        lib = lambda: torch._grouped_mm(                    # noqa: E731
            lhs.t(), dout, offs=ends)
        held = lambda o: o[gs > 0].reshape(-1, N)           # noqa: E731
    flops = 2 * int(gs.sum()) * K * N
    b_, by = bound(moved, flops, lhs.dtype)
    res = dict(bound_ms=b_, bound_by=by, ms=timer.ms(run),
               plain_ms=timer.ms(plain), library_ms=None, library_note=None)
    try:
        lt, _ = row_rel_errors(held(lib()), held(want))
    except (RuntimeError, TypeError, ValueError) as e:
        res["library_note"] = f"torch._grouped_mm refuses: {e}"[:300]
        return res
    if lt > 1e-2:
        res["library_note"] = (f"torch._grouped_mm disagrees with the "
                               f"plain version: {lt:.3g} relative")
        return res
    res.update(library_ms=timer.ms(lib), library_rel_err_tensor=lt,
               library_note="torch._grouped_mm")
    return res


def causal_pairs(Sq: int, Sk: int) -> int:
    """(row, key) pairs a causal, bottom-right aligned mask leaves
    visible: row i sees min(Sk, i + Sk - Sq + 1) keys."""
    return sum(max(0, min(Sk, i + Sk - Sq + 1)) for i in range(Sq))


def by_heads(fn, *ts, heads=4, se=None):
    """`fn` over `heads` heads at a time, concatenated back along the
    head axis (heads are independent; the dense plain version's f32
    scores for all 32 heads at S 8192 would take 8.6 GB a copy). A
    FlashMask encoding `se` [B, Hm, Sk, C] goes last, cut to the same
    heads where it has one a head."""
    def mask(h):
        if se is None:
            return ()
        return (se if se.shape[1] == 1 else se[:, h:h + heads],)

    parts = [fn(*(t[:, :, h:h + heads] for t in ts), *mask(h))
             for h in range(0, ts[0].shape[2], heads)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p, dim=2) for p in zip(*parts))
    return torch.cat(parts, dim=2)


def check_flash(timer: Timer, rows: dict):
    """flash_sdpa forward and backward (dq + dkv) at the training shape
    (B 1, S 8192, 32 heads x 128 after the GQA repeat, causal) in bf16
    and at S 2048 in f32, against the plain version: o and the three
    gradients; in bf16 timed beside the plain version, the bound and
    PyTorch's SDPA (library_ms, a yardstick the port never calls). Then
    the non-causal head-dim-64 case of phase 9c (`check_flash_bert`)."""
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
    check_flash_bert(gc_, rows)


def check_flash_bert(gc_, rows: dict):
    """flash_sdpa forward and backward at phase 9c's encoder-layer
    attention (BERT-base: B 8, S 512, 12 heads x 64, non-causal, bf16)
    against the plain version, at the bf16 flash limits."""
    E_, heads = BERT_BASE[:2]
    q, k, v, do = (torch.randn(BERT_BATCH, BERT_SEQ, heads, E_ // heads,
                               device=DEV, generator=gc_)
                   .to(torch.bfloat16) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = ops.flash_sdpa(*leaves, causal=False)
    o.backward(do)
    with torch.no_grad():
        ref_o = ops.flash_sdpa_reference(q, k, v, causal=False)
    ref_g = ops.flash_sdpa_bwd_reference(q, k, v, do, causal=False)
    outs = {"o": (o.detach(), ref_o), **{n: (t.grad, r) for n, t, r in
                                         zip(("dq", "dk", "dv"), leaves,
                                             ref_g)}}
    rel = {n: assert_flash_bf16(n + " non-causal D 64", got, want)
           for n, (got, want) in outs.items()}
    for name, names in (("flash_sdpa", ["o"]),
                        ("flash_sdpa_bwd", ["dq", "dk", "dv"])):
        rows[name]["rel_err_bf16_noncausal_d64"] = {
            n: {"tensor": rel[n][0], "tile": rel[n][1]} for n in names}
        rows[name]["max_abs_err_noncausal_d64"] = max(
            max_err(*outs[n]) for n in names)


# ------------------------------------------------------ phase 2, MLA
#: DeepSeek-V2-Lite's attention widths (DEEPSEEK_V2_LITE below)
MLA_H, MLA_HEADS, MLA_NOPE, MLA_ROPE, MLA_V, MLA_R = 2048, 16, 128, 64, 128, 512
#: the cached decode's shapes: GEN_BATCH sequences at GEN_PROMPT + 32
#: tokens (the last decode step reads 543 rows), and a long-context one
MLA_DECODE_CASES = {"decode": (GEN_BATCH, GEN_PROMPT + GEN_NEW),
                    "long": (LONG_SEQS, LONG_CTX)}
#: bf16 limits of the MLA kernels, (tensor, row) relative errors against
#: their plain versions: mla_decode_attention over each (sequence, head)'s
#: r outputs; the MLA site over each token's [q | pool row]; ragged at
#: D 576 over each (row, head); flash at D 192 by flash_rel_errors' tiles.
#: Set from readings of the sound kernels and of planted faults
#: (quant_limits.py, PERF.md): the sound decode kernel read at most
#: 6.4e-4 / 3.0e-3 (it rounds p to bf16 against the running max, the
#: plain version against the final one), with its scores rounded to bf16
#: between reads 2.2e-3 / 1.1e-2; the sound MLA site 4.6e-5 / 2.8e-4,
#: with its latent normed after the bf16 round 1.2e-3 / 1.4e-3; ragged
#: (at both of its sites) and flash keep the paged and flash limits: the
#: sound ragged kernel read at most 2.2e-3 / 3.9e-3, a split's keys one
#: past its end at least 9.6e-2 a row at the long case (ragged_limits.py)
MLA_BF16_LIMITS = {"mla_decode_attention": (1.2e-3, 6e-3),
                   "fused_qkv_rope_append_mla": (3e-4, 1e-3),
                   "ragged_576": (5e-3, 1e-2), "flash_192": (1e-2, 3e-2)}


def assert_rel_bf16(name, got, want, limits, hold: bool = True):
    """Hold a bf16 output to its plain version by `row_rel_errors` over
    rows of its last axis (``hold`` False: read only); returns the
    readings."""
    n = got.shape[-1]
    t, r = row_rel_errors(got.reshape(-1, n), want.reshape(-1, n))
    if hold:
        assert torch.isfinite(got).all(), name
        assert t <= limits[0] and r <= limits[1], (name, t, r)
    return {"tensor": t, "row": r}


def max_row_ulps(got, want) -> float:
    """The largest difference of two bf16 tensors over rows of the last
    axis, in bf16 spacings at each row's largest magnitude of `want`
    (about 1 or less: every difference is a rounding step at the row's
    scale)."""
    w = want.float().reshape(-1, want.shape[-1])
    top = w.abs().amax(-1, keepdim=True)
    ulp = torch.ldexp(torch.ones_like(top), torch.frexp(top).exponent - 8)
    return float(((got.float().reshape_as(w) - w).abs() / ulp).max())


def close_f32(got, want, hold: bool = True):
    """Hold an f32 output to its plain version at 2e-5 (``hold`` False:
    read only)."""
    if hold:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def mla_front_split(h, wq, wkva, g, c, s, pool, pg, off):
    """The split front's calls computing what the MLA site does (the
    site's split_ms), through the engine's own split front
    (``serving.engine.mla_split_front``): the q and kv_a products, q_pe
    and k_pe roped, the latent normed (fused_rms_norm), the rows appended
    (fused_append_rows)."""
    return mla_split_front(
        {"wq": wq, "wkva": wkva, "gkv": g}, h[None], c, s, pool, pg, off,
        heads=MLA_HEADS, nope_dim=MLA_NOPE, lora_rank=MLA_R, eps=1e-6,
        q_lora=False)[1]


def check_mla_kernels(timer, rows: dict, hold: bool = True):
    """The MLA slice's kernels against their plain versions at
    DeepSeek-V2-Lite's shapes, f32 at 2e-5 and bf16 by MLA_BF16_LIMITS
    (int4_dequantize and fused_append_rows exactly), each timed in bf16
    beside its plain version and its bound: the MLA site of
    fused_qkv_rope_append at the serving step (T 132, [2048 -> 3648], fp
    and int8; split_ms the split front's calls), fused_append_rows (132
    rows of 576), int4_dequantize (kv_b [512, 4096]), mla_decode_attention
    at the cached decode (4 x 544) and at 8 x 8192 cache rows (NaN past
    each length; library_ms SDPA over [q_eff | q_pe] against [c_lat |
    c_pe] with c_lat as the values), ragged attention over one latent pool
    (KV 1, D 576, rep 16) for a decode step and a 128-row prefill chunk,
    and the flash forward at head dim 192 (B 1, S 8192, 16 heads). With
    ``timer`` None nothing is timed; with ``hold`` False nothing is held,
    only read (quant_limits.py's planted faults)."""
    def ms(fn):
        return None if timer is None else timer.ms(fn)

    g = torch.Generator(DEV).manual_seed(7)
    T = SLOTS + CHUNK
    nh, dn, dr, dv, r = MLA_HEADS, MLA_NOPE, MLA_ROPE, MLA_V, MLA_R
    dh, D_lat = dn + dr, r + dr
    N = nh * dh + D_lat
    P = 64
    slot = torch.randperm((P - 1) * PSZ, device=DEV, generator=g)[:T]
    pg, off = (slot // PSZ + 1).to(torch.int32), (slot % PSZ).to(torch.int32)
    ang = torch.rand(T, dr // 2, device=DEV, generator=g) * 6
    cos, sin = ang.cos(), ang.sin()

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (scale * torch.randn(*shape, device=DEV, generator=g)
                ).to(dtype)

    # the MLA site, fp and int8, f32 and bf16
    site = rows.setdefault("fused_qkv_rope_append", {})
    for algo in (None, INT8):
        key = "mla" if algo is None else "mla_int8"
        for dtype in (torch.float32, torch.bfloat16):
            h = rnd(T, MLA_H, dtype=dtype)
            w32 = rnd(MLA_H, N, dtype=torch.float32, scale=0.02)
            gw = 1 + rnd(r, dtype=torch.float32, scale=0.1)
            w, sc = (w32.to(dtype), None) if algo is None \
                else ops.weight_quantize(w32, algo)
            kw = dict(heads=nh, algo=algo, eps=1e-6, nope_dim=dn,
                      rope_dim=dr, lora_rank=r, norm_weight=gw)
            pool = torch.zeros(1, P, PSZ, D_lat, device=DEV, dtype=dtype)
            ref_pool = torch.zeros_like(pool)
            n0 = ops.fused_qkv_rope_append.launches
            q, out = ops.fused_qkv_rope_append(h, w, sc, None, cos, sin,
                                               pool, None, pg, off, **kw)
            torch.cuda.synchronize()
            assert ops.fused_qkv_rope_append.launches == n0 + 1
            assert out is pool
            qr, _ = ops.qkv_rope_append_reference(
                h, w, sc, None, cos, sin, ref_pool, None, pg, off, **kw)
            got_rows, want_rows = pool[0, pg.long(), off.long()], \
                ref_pool[0, pg.long(), off.long()]
            err = max(max_err(q, qr), max_err(got_rows, want_rows))
            r_ = site.setdefault(key, {})
            r_[f"max_abs_err_{'f32' if dtype == torch.float32 else 'bf16'}"] \
                = err
            if dtype == torch.float32:
                close_f32(q, qr, hold)
                close_f32(got_rows, want_rows, hold)
                continue
            # a row per token, [q | pool row], as `quant_site_rows` reads
            # the other sites
            rel = assert_rel_bf16(
                "mla site", torch.cat([q.reshape(T, -1), got_rows], 1),
                torch.cat([qr.reshape(T, -1), want_rows], 1),
                MLA_BF16_LIMITS["fused_qkv_rope_append_mla"], hold)
            b_, by = bound(nbytes(h, w, q, got_rows, cos, sin, pg, off)
                           + (nbytes(sc) if sc is not None else 0),
                           2 * T * MLA_H * N, dtype)
            wd = w if algo is None else (w.float() * sc).to(dtype)
            wq, wkva = wd[:, :nh * dh].contiguous(), \
                wd[:, nh * dh:].contiguous()
            # read only: each (token, head)'s 192-wide q row alone, where
            # one bf16 rounding flip weighs more than in a token's row
            rel_heads = dict(assert_rel_bf16(
                "mla site q heads", q, qr,
                MLA_BF16_LIMITS["fused_qkv_rope_append_mla"], hold=False),
                max_row_ulps=max_row_ulps(q, qr))
            r_.update(max_abs_err=err, rel_err_bf16=rel,
                      rel_err_bf16_q_heads=rel_heads, bound_ms=b_,
                      bound_by=by, t=T, n=N,
                      ms=ms(lambda: ops.fused_qkv_rope_append(
                          h, w, sc, None, cos, sin, pool, None, pg, off,
                          **kw)),
                      plain_ms=ms(lambda: ops.qkv_rope_append_reference(
                          h, w, sc, None, cos, sin, ref_pool, None, pg, off,
                          **kw)),
                      split_ms=ms(lambda: mla_front_split(
                          h, wq, wkva, gw, cos, sin, ref_pool, pg, off)),
                      library_ms=None)

    # fused_append_rows: the step's 132 latent rows
    for dtype in (torch.float32, torch.bfloat16):
        pool = rnd(1, P, PSZ, D_lat, dtype=dtype)
        rws = rnd(T, 1, D_lat, dtype=dtype)
        want = ops.append_rows_reference(pool.clone(), rws, pg, off)
        n0 = ops.fused_append_rows.launches
        got = ops.fused_append_rows(pool, rws, pg, off)
        torch.cuda.synchronize()
        assert got is pool and ops.fused_append_rows.launches == n0 + 1
        assert torch.equal(pool, want) or not hold
    b_, by = bound(2 * nbytes(rws) + nbytes(pg, off))
    rows["fused_append_rows"] = dict(
        max_abs_err=max_err(pool, want), bound_ms=b_, bound_by=by, rows=T, width=D_lat,
        ms=ms(lambda: ops.fused_append_rows(pool, rws, pg, off)),
        plain_ms=ms(lambda: ops.append_rows_reference(pool, rws, pg,
                                                            off)),
        library_ms=ms(lambda: pool[0].index_put_(
            (pg.long(), off.long()), rws[:, 0])))

    # int4_dequantize: DeepSeek-V2-Lite's kv_b [512, 16 x 256], and odd N
    for K_, N_ in ((r, nh * (dn + dv)), (64, 37)):
        qw, s4 = ops.weight_quantize(rnd(K_, N_, dtype=torch.float32),
                                     INT4)
        n0 = ops.int4_dequantize.launches
        got = ops.int4_dequantize(qw, s4)
        torch.cuda.synchronize()
        assert ops.int4_dequantize.launches == n0 + 1
        want = ops.int4_dequantize_reference(qw, s4)
        assert torch.equal(got, want) or not hold
        rel = dict(zip(("tensor", "row"), row_rel_errors(got, want)))
        if K_ != r:
            rows["int4_dequantize"]["odd_n"] = dict(
                k=K_, n=N_, max_abs_err=max_err(got, want), rel_err=rel)
        else:
            b_, by = bound(nbytes(qw, s4, got))
            rows["int4_dequantize"] = dict(
                max_abs_err=max_err(got, want), rel_err=rel,
                bound_ms=b_, bound_by=by, k=K_, n=N_,
                ms=ms(lambda: ops.int4_dequantize(qw, s4)),
                plain_ms=ms(
                    lambda: ops.int4_dequantize_reference(qw, s4)),
                library_ms=None)

    # mla_decode_attention: NaN past each length, f32 and bf16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    scale = dh ** -0.5
    mrow = rows.setdefault("mla_decode_attention", {"cases": {}})
    for case, (B, Tc) in MLA_DECODE_CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            if case == "long" and dtype == torch.float32:
                continue        # the plain version's f32 scores: 8 x 16 x 8192
            qe, qp = rnd(B, nh, r, dtype=dtype), rnd(B, nh, dr, dtype=dtype)
            cl, cp = rnd(B, Tc, r, dtype=dtype), rnd(B, Tc, dr, dtype=dtype)
            lens = torch.randint(1, Tc + 1, (B,), device=DEV, generator=g,
                                 dtype=torch.int32)
            lens[0], lens[-1] = Tc, 1
            dead = torch.arange(Tc, device=DEV)[None] >= lens[:, None].long()
            cl[dead], cp[dead] = float("nan"), float("nan")
            n0 = ops.mla_decode_attention.launches
            got = ops.mla_decode_attention(qe, qp, cl, cp, lens, scale=scale)
            torch.cuda.synchronize()
            assert ops.mla_decode_attention.launches == n0 + 1
            want = ops.mla_decode_reference(qe, qp, cl, cp, lens,
                                            scale=scale)
            c_ = mrow["cases"].setdefault(case, {"batch": B, "cache": Tc})
            c_[f"max_abs_err_{'f32' if dtype == torch.float32 else 'bf16'}"] \
                = max_err(got, want)
            if dtype == torch.float32:
                close_f32(got, want, hold)
                continue
            c_["rel_err_bf16"] = assert_rel_bf16(
                "mla_decode_attention " + case, got, want,
                MLA_BF16_LIMITS["mla_decode_attention"], hold)
            live = int(lens.sum())
            b_, by = bound(live * D_lat * cl.element_size()
                           + nbytes(qe, qp, got, lens),
                           4 * nh * D_lat * live, dtype)
            qcat = torch.cat([qe, qp], -1)[:, :, None]      # [B, nh, 1, 576]
            kcat = torch.cat([cl, cp], -1)[:, None].expand(B, nh, Tc, D_lat)
            vlat = cl[:, None].expand(B, nh, Tc, r)
            mask = (~dead)[:, None, None, :]
            c_.update(bound_ms=b_, bound_by=by, live_rows=live,
                      ms=ms(lambda: ops.mla_decode_attention(
                          qe, qp, cl, cp, lens, scale=scale)),
                      plain_ms=ms(lambda: ops.mla_decode_reference(
                          qe, qp, cl, cp, lens, scale=scale)),
                      library_ms=ms(lambda: sdpa(
                          qcat, kcat, vlat, attn_mask=mask, scale=scale)))
    dec = mrow["cases"]["decode"]
    mrow.update({k: dec[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
                max_abs_err=dec["max_abs_err_bf16"])

    # ragged over one latent pool: KV 1, D 576, rep 16
    Pp = 96
    tabs_ = torch.randperm(Pp - 1, device=DEV, generator=g)[:5 * 16] \
        .reshape(5, 16).to(torch.int32) + 1
    seq_start = torch.arange(SLOTS + 1, dtype=torch.int32, device=DEV)
    for case, nt_, kvl_ in (("decode", [1, 1, 0, 1, 0],
                             [200, 17, 0, 255, 0]),
                            ("prefill", [1, 1, 0, 1, CHUNK],
                             [200, 17, 0, 255, 64 + CHUNK])):
        nt = torch.tensor(nt_, dtype=torch.int32, device=DEV)
        kvl = torch.tensor(kvl_, dtype=torch.int32, device=DEV)
        tabs = (seq_start, nt, kvl, tabs_)
        for dtype in (torch.float32, torch.bfloat16):
            pool = rnd(1, Pp, PSZ, D_lat, dtype=dtype)
            q = rnd(T, nh, D_lat, dtype=dtype)
            n0 = ops.ragged_paged_attention.launches
            o = ops.ragged_paged_attention(q, pool, pool, *tabs, scale=scale)
            torch.cuda.synchronize()
            assert ops.ragged_paged_attention.launches == n0 + 1
            ref = ops.ragged_attention_reference(q, pool, pool, *tabs,
                                                 scale=scale)
            rr = rows["ragged_paged_attention"].setdefault(
                "mla_576", {"kv_heads": 1, "heads": nh, "head_dim": D_lat})
            rc = rr.setdefault(case, {})
            rc[f"max_abs_err_{'f32' if dtype == torch.float32 else 'bf16'}"] \
                = max_err(o, ref)
            if dtype == torch.float32:
                close_f32(o, ref, hold)
                continue
            live_rows = torch.cat([torch.arange(SLOTS, device=DEV)[
                nt[:SLOTS] > 0], SLOTS + torch.arange(int(nt[SLOTS]),
                                                      device=DEV)])
            rc["rel_err_bf16"] = assert_rel_bf16(
                "ragged 576 " + case, o[live_rows], ref[live_rows],
                MLA_BF16_LIMITS["ragged_576"], hold)
            # K and V are one pool: each live row read once
            live = sum(k for k, n in zip(kvl_, nt_) if n)
            pairs = sum(k - n + t + 1 for k, n in zip(kvl_, nt_)
                        for t in range(n))
            b_, by = bound(live * D_lat * pool.element_size()
                           + nbytes(q, o, *tabs), 4 * nh * D_lat * pairs,
                           dtype)
            rc.update(bound_ms=b_, bound_by=by, qk_pairs=pairs,
                      ms=ms(lambda: ops.ragged_paged_attention(
                          q, pool, pool, *tabs, scale=scale)),
                      plain_ms=ms(
                          lambda: ops.ragged_attention_reference(
                              q, pool, pool, *tabs, scale=scale)),
                      library_ms=None)

    # the flash forward at head dim 192: the MLA prefill's padded heads
    fr = rows["flash_sdpa"].setdefault("d192", {"heads": nh})
    for dtype, S in ((torch.bfloat16, TRAIN_SEQ),
                     (torch.float32, F32_FLASH_SEQ)):
        q, k, v = (rnd(1, S, nh, dh, dtype=dtype) for _ in range(3))
        n0 = ops.flash_sdpa.launches
        o = ops.flash_sdpa(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert ops.flash_sdpa.launches == n0 + 1
        ref = by_heads(lambda a, b, c: ops.flash_sdpa_reference(
            a, b, c, causal=True), q, k, v)
        tag = "f32" if dtype == torch.float32 else "bf16"
        fr[f"max_abs_err_{tag}"] = max_err(o, ref)
        if dtype == torch.float32:
            close_f32(o, ref, hold)
            continue
        t_, tile = flash_rel_errors(o, ref)
        lim = MLA_BF16_LIMITS["flash_192"]
        assert not hold or (t_ <= lim[0] and tile <= lim[1]), \
            ("flash 192", t_, tile)
        pairs = causal_pairs(S, S)
        b_, by = bound(nbytes(q, k, v, o) + nh * S * 4,
                       4 * nh * dh * pairs, dtype)
        lq, lk, lv = (t.transpose(1, 2) for t in (q, k, v))
        fr.update(seq=S, rel_err_bf16={"tensor": t_, "tile": tile},
                  bound_ms=b_, bound_by=by, causal_pairs=pairs,
                  ms=ms(lambda: ops.flash_sdpa(q, k, v, causal=True)),
                  plain_ms=ms(lambda: by_heads(
                      lambda a, b, c: ops.flash_sdpa_reference(
                          a, b, c, causal=True), q, k, v)),
                  library_ms=ms(lambda: sdpa(lq, lk, lv,
                                                   is_causal=True)))


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
               "gmm": (0, 0), "gmm_dlhs": (0, 0), "tgmm": (0, 0),
               "flashmask_sdpa": (0, 0), "flashmask_sdpa_bwd": (0, 0)}
NO_PAGED = {"paged_decode_attention": (0, 0),
            "paged_decode_attention_v2": (0, 0)}
#: the MLA family's own kernels, which no other family launches
NO_MLA = {"fused_append_rows": (0, 0), "int4_dequantize": (0, 0),
          "mla_decode_attention": (0, 0)}
#: the incubate kernels and the static pass's generic kernel, which no
#: serving path launches
NO_INCUBATE = {"swiglu": (0, 0), "fused_rope": (0, 0),
               "fused_rope_bwd": (0, 0),
               "fused_bias_residual_layer_norm": (0, 0),
               "fused_moe_dispatch_combine": (0, 0),
               "generic_elementwise": (0, 0)}
FUSED_PER_STEP = {"fused_rms_norm": (1, 1), "fused_layer_norm": (0, 0),
                  "fused_qkv_rope_append": (1, 0),
                  "ragged_paged_attention": (1, 0),
                  "fused_oproj_norm": (1, 0), "fused_ffn": (1, 0),
                  "fused_rope_append": (0, 0), "weight_only_linear": (0, 0),
                  **NO_TRAINING, **NO_PAGED, **NO_MLA, **NO_INCUBATE}
SPLIT_PER_STEP = {"fused_rms_norm": (2, 1), "fused_layer_norm": (0, 0),
                  "fused_rope_append": (1, 0),
                  "ragged_paged_attention": (1, 0),
                  "fused_qkv_rope_append": (0, 0),
                  "fused_oproj_norm": (0, 0), "fused_ffn": (0, 0),
                  "weight_only_linear": (0, 0), **NO_TRAINING, **NO_PAGED,
                  **NO_MLA, **NO_INCUBATE}
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
def mla_step_launches(eng, layers: int, routed: int, quant=None) -> dict:
    """Every kernel's launches in one unified step of an MLA engine, from
    its chain: the front (the MLA site of fused_qkv_rope_append, or the
    split front's latent fused_rms_norm, a q-lora norm and
    fused_append_rows), ragged attention, the back half (fused_oproj_norm
    and, on dense layers, fused_ffn; or the split chain's ln2), three gmm
    a routed layer (the step has more than 32 rows), under int4 kv_b read
    whole through int4_dequantize once a layer and weight_only_linear
    for the front's q (q-lora: two) and kv_a products, the split back
    half's o-proj and dense FFN, the routed layers' shared experts and
    the head."""
    front, mega, qlora = eng.megafront, eng.megadecode, eng.q_lora
    dense = layers - routed
    want = {name: 0 for name in ops.launch_counts()}
    want["fused_rms_norm"] = layers * (
        1 + (0 if front else 1 + qlora) + (0 if mega else 1)) + 1
    want["ragged_paged_attention"] = layers
    want["fused_qkv_rope_append"] = layers * front
    want["fused_append_rows"] = layers * (not front)
    want["fused_oproj_norm"] = layers * mega
    want["fused_ffn"] = dense * mega
    want["gmm"] = 3 * routed
    if quant == "int4":
        want["int4_dequantize"] = layers
        want["weight_only_linear"] = layers * (2 + qlora) + 3 * routed + 1 \
            + (0 if mega else layers + 3 * dense)
    return want


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
    out["mla"] = tiny_mla_parity()
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


def tiny_mla_parity():
    """A tiny f32 DeepSeek-V2 (TINY_MLA), CPU (plain versions) vs card
    (kernels): identical greedy tokens without q-lora on the fused chain
    (the MLA site) and the split chain (fused_append_rows) in fp, int8 and
    int4 (int4's fused chain keeps the split front, kv_b through
    int4_dequantize), and with q-lora on the fused chain (the split front
    again), every card run at exactly its launches (`mla_step_launches`;
    38-row steps, so gmm three times a routed layer a step); then generate
    (fp) and generate_cached (fp, int8, int4: the decode through
    mla_decode_attention, "auto" at these widths), tokens identical,
    scores within 1e-5."""
    kw = dict(max_slots=2, page_size=4, prefill_chunk=36)
    out = {}
    plain_runs = [(q, c) for q in (None, "int8", "int4")
                  for c in ("fused", "split")]
    for tag, ql, runs in (("plain", None, plain_runs),
                          ("qlora", 32, [(None, "fused")])):
        cfg = DeepSeekV2Config(q_lora_rank=ql, **TINY_MLA)
        cpu_model = DeepSeekV2ForCausalLM(
            cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        gpu_model = copy.deepcopy(cpu_model).to(DEV)
        L, R = cfg.num_hidden_layers, routed_layers(cpu_model)
        reqs = trace(np.random.RandomState(1), cfg.vocab_size, 6, 2, 12, 2,
                     8, 4)
        for quant, chain in runs:
            qkw = dict(kw, weight_only_quant=quant,
                       **(SPLIT if chain == "split" else {}))
            cpu_out, _, _ = drive(ServingEngine(cpu_model, device="cpu",
                                                **qkw), reqs)
            eng = ServingEngine(gpu_model, device=DEV, **qkw)
            ops.reset_counts()
            gpu_out, _, _ = drive(eng, reqs)
            counts = ops.launch_counts()
            assert set(cpu_out) == set(gpu_out) == set(range(len(reqs)))
            for rid in cpu_out:
                np.testing.assert_array_equal(gpu_out[rid], cpu_out[rid])
            want = {k: n * eng.launches for k, n in
                    mla_step_launches(eng, L, R, quant).items()}
            for name, c in counts.items():
                assert c == {"launches": want[name], "plain_calls": 0}, \
                    (tag, quant, chain, name, c, want[name])
            out[f"{tag}/{quant or 'fp'}/{chain}"] = {
                "tokens": int(sum(len(v) for v in cpu_out.values())),
                "identical": True, "megafront": eng.megafront,
                "launches": {k: v for k, v in want.items() if v}}
        if tag != "plain":
            continue
        ids = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 20))
        new, dense = 6, L - R
        for name, quant in (("generate", None), ("generate_cached", None),
                            ("generate_cached", "int8"),
                            ("generate_cached", "int4")):
            gkw = dict(max_new_tokens=new, decode_strategy="greedy_search")
            if quant:
                gkw["weight_only_quant"] = quant
            fn = getattr(generation, name)
            x = ids[:, :7] if name == "generate" else ids
            cpu_tok, cpu_sc = fn(cpu_model, x, **gkw)
            ops.reset_counts()
            generation.mla_decode_composite.calls = 0
            gpu_tok, gpu_sc = fn(gpu_model, x, **gkw)
            counts = ops.launch_counts()
            # no decode step on the card took the two-einsum composite
            assert generation.mla_decode_composite.calls == 0, (name, quant)
            np.testing.assert_array_equal(gpu_tok.cpu().numpy(),
                                          cpu_tok.numpy())
            dist = float((gpu_sc.cpu() - cpu_sc).abs().max())
            assert dist <= 1e-5, (name, quant, dist)
            if name == "generate":   # the model forward a new token
                want = {"flash_sdpa": L * new, "gmm": 3 * R * new}
            else:                    # 40 prefill rows, then 2-row steps
                want = {"flash_sdpa": L, "gmm": 3 * R,
                        "mla_decode_attention": L * (new - 1)}
                if quant == "int4":
                    want["int4_dequantize"] = L * new
                    want["weight_only_linear"] = \
                        (3 * L + 3 * dense + 3 * R + 1) * new
            for kname, c in counts.items():
                assert c == {"launches": want.get(kname, 0),
                             "plain_calls": 0}, (name, quant, kname, c)
            out[f"{quant or 'fp'}/{name}"] = {
                "tokens": cpu_tok.numpy().tolist(),
                "score_max_abs_diff": dist, "launches": want}
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
    mla = eng._family == "mla"
    # the MLA family's fused chain keeps the split front under int4 (no
    # packed MLA site) or q-lora
    assert eng.megadecode == (chain == "fused")
    assert eng.megafront == (chain == "fused" and not (
        mla and (quant == "int4" or eng.q_lora)))
    assert eng.ragged == (not alt)
    assert eng.paged_impl == (impl if alt else None)
    pool_bytes = sum(nbytes(*layer) for layer in eng._pools)
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
    elif mla:
        per_launch = mla_step_launches(eng, layers, routed, quant)
        expect = {name: n * n_steps for name, n in per_launch.items()}
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
        generation.mla_decode_composite.calls = 0
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
    # a decode step's GEN_BATCH rows run every expert on every token); an
    # MLA model's decode steps mla_decode_attention once a layer each
    wants = {"flash_sdpa": L, "gmm": 3 * routed}
    if hasattr(cfg, "kv_lora_rank"):
        wants["mla_decode_attention"] = L * (GEN_NEW - 1)
    for name, c in counts.items():
        assert c == {"launches": wants.get(name, 0), "plain_calls": 0}, \
            (name, c)
    routes = dict(attn_routes.route_counts)
    assert routes == dict({k: 0 for k in routes}, flash=L), routes
    assert generation.mla_decode_composite.calls == 0
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
            "gmm_launches": counts["gmm"]["launches"],
            "mla_decode_launches": counts["mla_decode_attention"]["launches"]}


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
    assert routes == dict({k: 0 for k in routes}, flash=L * n), routes
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


#: phase 8b's tiny ERNIE 4.5 MoE: a dense first layer, 2 routed ones of
#: 8 experts (top-2) with a shared expert, head_dim 64 (the flash
#: kernel's), widths multiples of 8, dropless
TINY_MOE_TRAIN = dict(num_hidden_layers=3, num_attention_heads=2,
                      num_key_value_heads=1, max_position_embeddings=64,
                      moe_dropless=True)
#: phase 8b's limits on the card's losses, aux losses and grad norms
#: against the CPU's, relative: f32 and the bf16 loss and grad norm as
#: phase 8's; in bf16 the card and the CPU also round the activations that
#: reach the f32 router at other places, which moves the aux loss with the
#: gates (readings on the sound kernels, PERF.md: f32 7.5e-8 / 2.1e-7 /
#: 2.2e-6, bf16 1.5e-4 / 3.2e-3 / 3.1e-3)
TINY_MOE_TRAIN_LIMITS = {
    "float32": {"loss": 1e-4, "aux": 1e-4, "grad_norm": 1e-4},
    "bfloat16": {"loss": 2e-3, "aux": 1e-2, "grad_norm": 2e-2}}


def moe_train_run(model, param_dtype: str, batches, lr: float = 1e-3):
    """Eager AdamW steps (weight decay 0.1, ClipGradByGlobalNorm(1.0),
    bf16 through amp.decorate O2 with f32 master weights): losses, aux
    losses, grad norms and the launch counts of the run."""
    clip = ClipGradByGlobalNorm(1.0)
    opt = optim.AdamW(learning_rate=lr, parameters=model.parameters(),
                      weight_decay=0.1, grad_clip=clip)
    if param_dtype == "bfloat16":
        model, opt = amp.decorate(model, opt, level="O2")
    dev = next(model.parameters()).device
    n0 = ops.launch_counts()
    losses, auxes, norms = [], [], []
    for ids, labels in batches:
        loss, _ = model(torch.as_tensor(ids, device=dev),
                        labels=torch.as_tensor(labels, device=dev))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
        auxes.append(float(model.model.aux_loss().detach()))
        norms.append(float(clip.last_norm))
    n1 = ops.launch_counts()
    delta = {k: {f: n1[k][f] - n0[k][f] for f in n1[k]} for k in n1}
    return losses, auxes, norms, delta


def moe_train_launches(layers: int, routed: int, steps: int,
                       recompute: bool = False) -> dict:
    """Launches of eager MoE training steps: the flash forward and
    backward once a layer, a routed layer's three gmm, three gmm_dlhs and
    three tgmm (with recompute each layer's forward runs twice: the flash
    forward and gmm twice); nothing else."""
    fwd = 2 if recompute else 1
    return {"flash_sdpa": fwd * layers * steps,
            "flash_sdpa_bwd": layers * steps,
            "gmm": fwd * 3 * routed * steps,
            "gmm_dlhs": 3 * routed * steps, "tgmm": 3 * routed * steps}


def tiny_moe_train_parity():
    """Phase 8b: a tiny ERNIE 4.5 MoE, 3 eager AdamW steps on the CPU
    (plain versions) and on the card (kernels) from the same weights, in
    f32 and in bf16 (amp.decorate O2): losses, aux losses and grad norms
    within TINY_MOE_TRAIN_LIMITS; on the card every step launches the
    flash forward and backward once a layer and 3 gmm, 3 gmm_dlhs and 3
    tgmm a routed layer, with no plain call; on the CPU the same counts
    as plain calls of the gmm family."""
    cfg = ernie45_moe_config(**TINY_MOE_TRAIN)
    L = cfg.num_hidden_layers
    R = L - cfg.first_k_dense_replace
    rng = np.random.RandomState(4)
    batches = []
    for _ in range(3):
        ids = rng.randint(0, cfg.vocab_size, (2, 48))
        batches.append((ids, np.roll(ids, -1, axis=1)))
    want = moe_train_launches(L, R, len(batches))

    def rel(a, b):
        return float(np.max(np.abs(np.subtract(a, b)) / np.abs(b)))

    out = {}
    for dt, lim in TINY_MOE_TRAIN_LIMITS.items():
        cpu_model = Ernie45MoEForCausalLM(
            cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        gpu_model = copy.deepcopy(cpu_model).to(DEV)
        cpu = moe_train_run(cpu_model, dt, batches)
        card = moe_train_run(gpu_model, dt, batches)
        for name, c in card[3].items():
            assert c == {"launches": want.get(name, 0), "plain_calls": 0}, \
                (dt, name, c)
        for name in ("gmm", "gmm_dlhs", "tgmm"):
            assert cpu[3][name] == {"launches": 0,
                                    "plain_calls": want[name]}, (dt, name)
        r = {"steps": len(batches), "layers": L, "routed_layers": R,
             "losses_cpu": cpu[0], "losses_card": card[0],
             "aux_cpu": cpu[1], "aux_card": card[1],
             "grad_norms_cpu": cpu[2], "grad_norms_card": card[2],
             "loss_rel": rel(card[0], cpu[0]), "aux_rel": rel(card[1], cpu[1]),
             "grad_norm_rel": rel(card[2], cpu[2]), "launches": want,
             "limits": lim}
        assert r["loss_rel"] <= lim["loss"], (dt, r)
        assert r["aux_rel"] <= lim["aux"], (dt, r)
        assert r["grad_norm_rel"] <= lim["grad_norm"], (dt, r)
        out[dt] = r
    return out


def moe_active_params(cfg) -> int:
    """N_active: the weights one token's products pass through in the
    MoE model, the embedding lookup left out: the head, every layer's
    attention projections, the dense layers' FFN, and in a routed layer
    top_k experts, the shared expert and the router."""
    Hh, D_ = cfg.hidden_size, cfg.head_dim
    attn = Hh * cfg.num_attention_heads * D_ * 2 \
        + Hh * cfg.num_key_value_heads * D_ * 2
    dense = 3 * Hh * cfg.intermediate_size
    routed = cfg.top_k * 3 * Hh * cfg.moe_intermediate_size \
        + 3 * Hh * cfg.shared_expert_intermediate_size \
        + Hh * cfg.num_experts
    k = cfg.first_k_dense_replace
    L = cfg.num_hidden_layers
    return Hh * cfg.vocab_size + L * attn + k * dense + (L - k) * routed


def train_moe(card):
    """Phase 12b: eager MoE training at ERNIE-4.5-21B-A3B's widths, depth
    cut to MOE_TRAIN_LAYERS (layer 0 dense, the rest routed), 1 x
    MOE_TRAIN_SEQ tokens, f32 weights drawn on the card then put in bf16
    by amp.decorate O2 (f32 master weights and AdamW moments), lr 3e-4,
    weight decay 0.1, ClipGradByGlobalNorm(1.0), the config's aux weight
    0.01: every timed step must launch the flash forward and backward
    once a layer and 3 gmm, 3 gmm_dlhs and 3 tgmm a routed layer, no
    plain version and no attention route but flash; the loss must be
    finite and fall."""
    cfg = MoEConfig(**dict(ERNIE45_21B_A3B,
                           num_hidden_layers=MOE_TRAIN_LAYERS,
                           recompute=MOE_TRAIN_RECOMPUTE))
    L = cfg.num_hidden_layers
    R = L - cfg.first_k_dense_replace
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = MoEForCausalLM(cfg, device=DEV, dtype=torch.float32,
                           generator=torch.Generator(DEV).manual_seed(0))
    clip = ClipGradByGlobalNorm(1.0)
    opt = optim.AdamW(learning_rate=3e-4, parameters=model.parameters(),
                      weight_decay=0.1, grad_clip=clip)
    model, opt = amp.decorate(model, opt, level="O2")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    g = torch.Generator(DEV).manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (1, MOE_TRAIN_SEQ), device=DEV,
                        generator=g)
    labels = torch.roll(ids, -1, dims=1)
    losses, auxes, norms, times = [], [], [], []

    def one_step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, _ = model(ids, labels=labels)
        aux = model.model.aux_loss()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))      # waits for the step
        times.append((time.perf_counter() - t) * 1e3)
        auxes.append(float(aux.detach()))
        norms.append(float(clip.last_norm))

    for _ in range(WARMUP_STEPS):
        one_step()
    ops.reset_counts()
    attn_routes.reset_route_counts()
    torch.cuda.reset_peak_memory_stats()
    with GroupSizeLog() as glog:
        for _ in range(TIMED_STEPS):
            one_step()
            glog.mark()
    counts = ops.launch_counts()
    routes = dict(attn_routes.route_counts)
    n = TIMED_STEPS
    want = moe_train_launches(L, R, n, MOE_TRAIN_RECOMPUTE)
    for name, c in counts.items():
        assert c == {"launches": want.get(name, 0), "plain_calls": 0}, \
            (name, c)
    assert routes == dict({k: 0 for k in routes},
                          flash=want["flash_sdpa"]), routes
    assert all(np.isfinite(losses)) and all(np.isfinite(norms))
    assert losses[-1] < losses[0], losses
    step_ms = statistics.median(times[WARMUP_STEPS:])
    tok_s = MOE_TRAIN_SEQ / (step_ms / 1e3)
    n_params = sum(p.numel() for p in model.parameters())
    n_active = moe_active_params(cfg)
    hits = glog.hits()
    return {
        "card": card["nvidia_smi"], "layers": L, "layers_published": 28,
        "routed_layers": R, "hidden": cfg.hidden_size,
        "heads": cfg.num_attention_heads,
        "kv_heads": cfg.num_key_value_heads, "experts": cfg.num_experts,
        "top_k": cfg.top_k, "expert_ffn": cfg.moe_intermediate_size,
        "shared_ffn": cfg.shared_expert_intermediate_size,
        "dense_ffn": cfg.intermediate_size, "vocab": cfg.vocab_size,
        "batch": 1, "seq": MOE_TRAIN_SEQ, "recompute": MOE_TRAIN_RECOMPUTE,
        "params": n_params, "n_active": n_active, "model_init_s": init_s,
        "warmup_steps": WARMUP_STEPS, "timed_steps": n,
        "step_ms_median": step_ms, "step_ms": times,
        "tokens_per_s": tok_s,
        "train_mfu": tok_s * 6 * n_active / PEAK_FLOPS_PER_S[torch.bfloat16],
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "state_bytes_reckoned": n_params * (2 + 2 + 4 + 8),
        "losses": losses, "aux_losses": auxes, "grad_norms": norms,
        "experts_with_rows_per_layer": hits,
        "launches_per_step": {k: v // n for k, v in want.items()},
    }, {k: v["launches"] for k, v in counts.items() if v["launches"]}


# ------------------------------------------------------------ phase 8c/9b
#: document lengths of the packed SFT batch at S 8192 (scaled with S)
FM_DOC_LEN = (256, 2048)


def packed_docs(rng, S: int, heads: int, lo: int, hi: int):
    """causal C=1 startend [1, heads, S, 1]: per head, seeded document
    lengths in [lo, hi] packed to S (the last one cut); a key is hidden
    from the rows at and past its document's end. Also head 0's lengths."""
    out, first = np.zeros((1, heads, S, 1), np.int32), None
    for h in range(heads):
        lens, n = [], 0
        while n < S:
            lens.append(min(int(rng.integers(lo, hi + 1)), S - n))
            n += lens[-1]
        out[0, h, :, 0] = np.repeat(np.cumsum(lens), lens)
        first = lens if first is None else first
    return out, first


def flashmask_encodings(S: int, heads: int, seed: int = 0):
    """A packed SFT step's FlashMask encodings at length S: name ->
    (startend [1, Hm, S, C] int32, causal, head 0's document lengths or
    None). Causal C=1 over seeded documents (FM_DOC_LEN at S 8192, scaled
    with S), the JAX tests' causal C=2, non-causal C=2 and non-causal C=4
    bands (tests/test_flashmask_kernel.py CASES at S 256) scaled by S /
    256, and causal C=1 with its own documents in each of `heads` heads."""
    rng = np.random.default_rng(seed)
    u = S / 256

    def full(*vals):
        return np.stack([np.full((1, 1, S), int(x * u), np.int32)
                         for x in vals], -1)

    lo, hi = (int(x * S / TRAIN_SEQ) for x in FM_DOC_LEN)
    docs, lens = packed_docs(rng, S, 1, lo, hi)
    docs_h, _ = packed_docs(rng, S, heads, lo, hi)
    return {"causal_C1_docs": (docs, True, lens),
            "causal_C2_band": (full(80, 200), True, None),
            "noncausal_C2": (full(192, 64), False, None),
            "noncausal_C4": (full(160, 224, 32, 96), False, None),
            f"causal_C1_docs_hm{heads}": (docs_h, True, None)}


def flashmask_run(q, k, v, do, se, causal):
    """The public entry point forward and backward through autograd:
    (o, dq, dk, dv)."""
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, _ = fm_api.flashmask_attention(*leaves, se, causal=causal)
    o.backward(do)
    return (o.detach(), *(t.grad for t in leaves))


def flashmask_plain(q, k, v, do, se, causal):
    """The plain versions, 4 heads at a time: (o, dq, dk, dv)."""
    with torch.no_grad():
        o = by_heads(lambda *a: ops.flashmask_sdpa_reference(
            *a, causal=causal), q, k, v, se=se)
    return (o, *by_heads(lambda *a: ops.flashmask_sdpa_bwd_reference(
        *a, causal=causal), q, k, v, do, se=se))


def mask_readings(se, causal, S: int, heads: int):
    """(visible (row, key) pairs over all heads, share of the kernels'
    64 x 64 tiles skipped), counted from the bands on the card."""
    pairs, kinds = 0, []
    for h in range(se.shape[1]):
        bands = ops.bands_from_startend(se[:, h:h + 1], S, S, causal)
        pairs += int((~band_hidden(bands, S, S, causal)).sum())
        kinds.append(ops.flashmask_block_kinds(bands, S, S, 64, 64, causal))
    skipped = 1.0 - float(torch.cat(kinds).float().mean())
    return pairs * (heads if se.shape[1] == 1 else 1), skipped


def unpadded_run(q, k, v, do, lens_q, lens_k, causal):
    """flash_attn_unpadded over packed [total, H, D] rows of q / k / v
    (batch 1 dropped), forward and backward: (o, dq, dk, dv) with the
    batch axis back."""
    cu = [torch.tensor(np.cumsum([0] + list(x)), dtype=torch.int32,
                       device=q.device) for x in (lens_q, lens_k)]
    leaves = [t[0].clone().requires_grad_() for t in (q, k, v)]
    o, _ = fm_api.flash_attn_unpadded(*leaves, *cu, causal=causal)
    o.backward(do[0])
    return tuple(t[None] for t in (o.detach(), *(x.grad for x in leaves)))


def tiny_flashmask_parity():
    """Phase 8c: flashmask_attention (the four encodings, one mask head and
    one a head, and causal C=1 over packed documents) and
    flash_attn_unpadded (equal and cross lengths), forward and gradients,
    on the CPU (plain versions) and on the card (kernels) from the same f32
    inputs: o within 2e-5, gradients within 1e-4; every card call exactly
    one forward and one backward launch, no plain call. Then the bf16
    kernels against the plain version on the card at a ragged length, by
    the flash limits."""
    B_, H_ = 2, 2
    out = {"f32": {}, "bf16": {}}
    f32_tol = {"o": dict(atol=2e-5, rtol=2e-5),
               "grad": dict(atol=1e-4, rtol=1e-4)}
    for S_, Dh in ((256, 64), (200, 128)):
        g = np.random.default_rng(S_ + Dh)
        x = [torch.from_numpy(g.standard_normal((B_, S_, H_, Dh),
                                                dtype=np.float32))
             for _ in range(4)]
        encs = flashmask_encodings(256, H_, seed=S_)
        for name, (se_np, causal, _) in encs.items():
            se_np = np.repeat(np.minimum(se_np[:, :, :S_], S_), B_, axis=0)
            se = torch.from_numpy(np.ascontiguousarray(se_np))
            want = flashmask_run(*x, se, causal)
            ops.reset_counts()
            got = flashmask_run(*(t.to(DEV) for t in x), se.to(DEV), causal)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            for k_, c in counts.items():
                n = 1 if k_.startswith("flashmask_sdpa") else 0
                assert c == {"launches": n, "plain_calls": 0}, (k_, c)
            errs = {}
            for t, a, b in zip(("o", "dq", "dk", "dv"), got, want):
                torch.testing.assert_close(
                    a.cpu(), b, **f32_tol["o" if t == "o" else "grad"])
                errs[t] = max_err(a.cpu(), b)
            out["f32"][f"S{S_} D{Dh} {name}"] = errs
            if S_ == 200:
                xb = [t.to(DEV, torch.bfloat16) for t in x]
                got = flashmask_run(*xb, se.to(DEV), causal)
                want = flashmask_plain(*xb, se.to(DEV), causal)
                out["bf16"][f"S{S_} D{Dh} {name}"] = {
                    t: assert_flash_bf16(f"{name} {t}", a, b)
                    for t, a, b in zip(("o", "dq", "dk", "dv"), got, want)}
    g = np.random.default_rng(7)
    for lens_q, lens_k, causal in (([96, 160], [96, 160], True),
                                   ([40, 88], [64, 128], False),
                                   ([40, 88], [64, 128], True)):
        x = [torch.from_numpy(g.standard_normal((1, sum(n), H_, 64),
                                                dtype=np.float32))
             for n in (lens_q, lens_k, lens_k, lens_q)]
        want = unpadded_run(*x, lens_q, lens_k, causal)
        ops.reset_counts()
        got = unpadded_run(*(t.to(DEV) for t in x), lens_q, lens_k, causal)
        torch.cuda.synchronize()
        for k_, c in ops.launch_counts().items():
            n = 1 if k_.startswith("flash_sdpa") else 0
            assert c == {"launches": n, "plain_calls": 0}, (k_, c)
        errs = {}
        for t, a, b in zip(("o", "dq", "dk", "dv"), got, want):
            torch.testing.assert_close(
                a.cpu(), b, **f32_tol["o" if t == "o" else "grad"])
            errs[t] = max_err(a.cpu(), b)
        out["f32"][f"unpadded {lens_q}/{lens_k} causal={causal}"] = errs
    return dict(out, limits={"f32": f32_tol, "bf16": {
        "tensor": FLASH_BF16_TENSOR_LIMIT, "tile": FLASH_BF16_TILE_LIMIT}})


def check_flashmask(timer: Timer, rows: dict, card: dict):
    """Phase 9b: FlashMask at Llama-3-8B's attention width (B 1, S 8192,
    32 heads x 128 after the caller's GQA repeat, bf16), as a packed SFT
    step calls it: every encoding of `flashmask_encodings` forward and
    backward through flashmask_attention and autograd, the counts read
    alone (one forward and one backward launch a call, no plain call, no
    composite route); each held to the plain version by the flash limits;
    flash_attn_unpadded over the same documents (flash with segment ids)
    against causal C=1; then an f32 run at S 2048 (o 2e-5, gradients
    1e-4); then the timings. Returns (the phase's readings, its launches)."""
    S, H_ = TRAIN_SEQ, HQ
    gc_ = torch.Generator(DEV).manual_seed(3)
    q, k, v, do = (torch.randn(1, S, H_, D, device=DEV, generator=gc_)
                   .to(torch.bfloat16) for _ in range(4))
    encs = flashmask_encodings(S, H_)
    ses = {n: torch.from_numpy(e[0]).to(DEV) for n, e in encs.items()}
    ops.reset_counts()
    attn_routes.reset_route_counts()
    outs = {n: flashmask_run(q, k, v, do, ses[n], causal)
            for n, (_, causal, _) in encs.items()}
    torch.cuda.synchronize()
    counts, routes = ops.launch_counts(), dict(attn_routes.route_counts)
    calls = len(encs)
    for name, c in counts.items():
        want = calls if name.startswith("flashmask_sdpa") else 0
        assert c == {"launches": want, "plain_calls": 0}, (name, c)
    assert routes == dict({r: 0 for r in routes}, flashmask=calls), routes
    launches = {k_: c["launches"] for k_, c in counts.items()
                if c["launches"]}

    cases = {}
    for name, (_, causal, lens) in encs.items():
        se = ses[name]
        want = flashmask_plain(q, k, v, do, se, causal)
        rel = {t: assert_flash_bf16(f"{name} {t}", a, b)
               for t, a, b in zip(("o", "dq", "dk", "dv"), outs[name], want)}
        pairs, skipped = mask_readings(se, causal, S, H_)
        cases[name] = {"causal": causal, "mask_heads": se.shape[1],
                       "visible_pairs": pairs,
                       "visible_share": pairs / (H_ * S * S),
                       "skipped_tile_share": skipped,
                       "max_abs_err": max_err(outs[name][0], want[0]),
                       "max_abs_err_bwd": max(max_err(a, b) for a, b in zip(
                           outs[name][1:], want[1:])),
                       "rel_err_bf16": {t: {"tensor": r[0], "tile": r[1]}
                                        for t, r in rel.items()}}
        if lens is not None:
            cases[name]["documents"] = len(lens)
            got = unpadded_run(q, k, v, do, lens, lens, True)
            cases[name]["unpadded_vs_flashmask"] = {
                t: assert_flash_bf16(f"unpadded {t}", a, b)
                for t, a, b in zip(("o", "dq", "dk", "dv"), got,
                                   outs[name])}
        del want
    del outs
    gc.collect()
    torch.cuda.empty_cache()

    f32 = {}
    S2 = F32_FLASH_SEQ
    x = [torch.randn(1, S2, H_, D, device=DEV, generator=gc_)
         for _ in range(4)]
    for name, (se_np, causal, _) in flashmask_encodings(S2, H_).items():
        se = torch.from_numpy(se_np).to(DEV)
        got = flashmask_run(*x, se, causal)
        want = flashmask_plain(*x, se, causal)
        for t, a, b in zip(("o", "dq", "dk", "dv"), got, want):
            tol = 2e-5 if t == "o" else 1e-4
            torch.testing.assert_close(a, b, atol=tol, rtol=tol)
        f32[name] = {"max_abs_err": max_err(got[0], want[0]),
                     "max_abs_err_bwd": max(max_err(a, b) for a, b in zip(
                         got[1:], want[1:]))}
    del x, got, want
    gc.collect()
    torch.cuda.empty_cache()

    # timings: the kernels alone (the forward, then the backward from its
    # o and lse) for every encoding; the plain versions, PyTorch's SDPA
    # under the dense bool mask (where no row is empty) and the port's flash
    # with segment ids (the document masks) beside them
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lq, lk, lv, ldo = (t.transpose(1, 2) for t in (q, k, v, do))
    scale, lse_bytes = D ** -0.5, H_ * S * 4
    for name, (_, causal, lens) in encs.items():
        se, c = ses[name], cases[name]
        bands = fm_kernels._band_tensor(se, S, S, causal, q.device)
        o, lse = fm_kernels._launch_fwd(q, k, v, bands, causal, scale)
        flops1 = 2 * D * c["visible_pairs"]     # one product over the pairs
        fb, fby = bound(nbytes(q, k, v, o, bands) + lse_bytes, 2 * flops1)
        bb, bby = bound(nbytes(q, k, v, o, do, bands) + lse_bytes
                        + 3 * nbytes(q), 5 * flops1)
        c.update(
            ms=timer.ms(lambda: ops.flashmask_sdpa(q, k, v, se, causal)),
            bwd_ms=timer.ms(lambda: ops.flashmask_sdpa_bwd(
                q, k, v, o, lse, do, se, causal)),
            bound_ms=fb, bound_by=fby, bwd_bound_ms=bb, bwd_bound_by=bby)
        allow = ~torch.cat([band_hidden(ops.bands_from_startend(
            se[:, h:h + 1], S, S, causal), S, S, causal)
            for h in range(se.shape[1])], dim=1)
        if bool(allow.any(-1).all()):
            ll = [t.detach().requires_grad_() for t in (lq, lk, lv)]
            lo = sdpa(*ll, attn_mask=allow)
            c.update(library_ms=timer.ms(lambda: sdpa(lq, lk, lv,
                                                      attn_mask=allow)),
                     bwd_library_ms=timer.ms(lambda: torch.autograd.grad(
                         lo, ll, ldo, retain_graph=True)))
            del ll, lo
        else:
            c.update(library_ms=None, bwd_library_ms=None)
        del allow
        if lens is not None:
            seg = torch.from_numpy(np.repeat(np.arange(len(lens)), lens)
                                   ).to(DEV, torch.int32)[None]
            fo, flse = _launch_fwd(q, k, v, seg, seg, True, scale)
            c.update(
                segmented_ms=timer.ms(lambda: ops.flash_sdpa(
                    q, k, v, causal=True, segment_ids_q=seg,
                    segment_ids_kv=seg)),
                bwd_segmented_ms=timer.ms(lambda: ops.flash_sdpa_bwd(
                    q, k, v, fo, flse, do, causal=True, segment_ids_q=seg,
                    segment_ids_kv=seg)),
                plain_ms=timer.ms(lambda: by_heads(
                    lambda *a: ops.flashmask_sdpa_reference(
                        *a, causal=causal), q, k, v, se=se)),
                bwd_plain_ms=timer.ms(lambda: by_heads(
                    lambda *a: ops.flashmask_sdpa_bwd_reference(
                        *a, causal=causal), q, k, v, do, se=se)))
        gc.collect()
        torch.cuda.empty_cache()

    main = cases["causal_C1_docs"]
    fwd_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "segmented_ms")
    rows["flashmask_sdpa"] = dict(
        {k_: main[k_] for k_ in fwd_keys},
        max_abs_err=max(c["max_abs_err"] for c in cases.values()),
        rel_err_bf16={n: c["rel_err_bf16"]["o"] for n, c in cases.items()})
    rows["flashmask_sdpa_bwd"] = dict(
        {k_: main["bwd_" + k_] for k_ in fwd_keys},
        max_abs_err=max(c["max_abs_err_bwd"] for c in cases.values()),
        rel_err_bf16={n: {t: c["rel_err_bf16"][t] for t in ("dq", "dk",
                                                            "dv")}
                      for n, c in cases.items()})
    return {"card": card["nvidia_smi"], "batch": 1, "seq": S, "heads": H_,
            "head_dim": D, "calls": calls, "launches": launches,
            "routes": routes, "cases": cases, "f32_seq": S2, "f32": f32,
            "limits": {"tensor": FLASH_BF16_TENSOR_LIMIT,
                       "tile": FLASH_BF16_TILE_LIMIT,
                       "f32": {"o": 2e-5, "grad": 1e-4}}}, launches


# --------------------------------------------------- phase 2, incubate
#: the shapes of the incubate kernels' paths (phase 9c / 9d): Llama-3-8B's
#: attention and FFN over 1 x 4096 tokens, GPT-3 6.7B's hidden at 4096
#: tokens, ERNIE-4.5-21B-A3B's routing of 4096 tokens (64 experts, top-6,
#: capacity int(1.25 x 6 x 4096 / 64) = 480)
INC_TOKENS = 4096
MOE_E, MOE_K = 64, 6
MOE_CAP = int(1.25 * MOE_K * INC_TOKENS / MOE_E)
#: the to_static training run (phase 9d): Llama-3-8B width, depth cut
STATIC_LAYERS, STATIC_WARMUP, STATIC_STEPS = 4, 2, 3
#: phase 9d's bar on the first step's parameter gradients, flagged
#: against unflagged (`grad_rel_diff`): set from readings of the sound
#: rewrite and of the planted faults below (PERF.md)
STATIC_GRAD_BAR = 2.0 ** -5
#: planted faults of the swiglu rewrite's executor (gate and up swapped;
#: up dropped), each of which must miss STATIC_GRAD_BAR
PLANTED_SWIGLU = {
    "gate_up_swapped": lambda gate, up, dtype:
        ops.swiglu(up, gate).to(dtype),
    "up_dropped": lambda gate, up, dtype:
        ops.swiglu(gate, torch.ones_like(up)).to(dtype),
}
#: BERT-base's encoder layer (hidden 768, 12 heads, FFN 3072), 8 x 512
BERT_BASE = (768, 12, 3072)
BERT_BATCH, BERT_SEQ = 8, 512


def max_bf16_spacings(got, want) -> float:
    """max |got - want| in bf16 spacings at want's magnitude (the spacing
    of the bf16 numbers at or below |want|), the magnitude floored at
    1/256 of the tensor's largest: an f32 sum taken in another order
    differs relative to its terms, so a value that cancels to near 0 is
    judged at the spacing of the terms' scale, not of its own."""
    got, want = got.detach().float(), want.detach().float()
    mag = want.abs().clamp_min(max(float(want.abs().max()) / 256,
                                   torch.finfo(torch.bfloat16).tiny))
    spacing = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got - want).abs() / spacing).max())


def hold_one_spacing(name, got, want):
    """bf16 within one bf16 spacing (the kernel and the plain version
    both compute in f32 with one cast; only the f32 rounding before the
    cast may differ), f32 at 2e-5."""
    if got.dtype == torch.bfloat16:
        sp = max_bf16_spacings(got, want)
        assert sp <= 1.0, (name, sp)
        return sp
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    return 0.0


def check_incubate_kernels(timer, rows):
    """swiglu, fused_rope (and its backward launch),
    fused_bias_residual_layer_norm and fused_moe_dispatch_combine at their
    paths' shapes, bf16 (the MoE build in f32, as top_k_gating's gates
    are) and f32, against their plain versions: bf16 within one bf16
    spacing, f32 at 2e-5, the MoE outputs exact; timed beside the plain
    versions and the bytes bound. No one PyTorch call computes any of the
    four (library_ms None)."""
    gc = torch.Generator(DEV).manual_seed(21)
    T, I = INC_TOKENS, FFN
    cos_t, sin_t = precompute_rope(D, INC_TOKENS, 500000.0, DEV)
    for dtype in (torch.bfloat16, torch.float32):
        main = dtype == torch.bfloat16
        tag = "bf16" if main else "f32"

        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, device=DEV, generator=gc)
                    * scale).to(dtype)

        # swiglu: two [T, I] operands, and the split form of one [T, 2I]
        gate, up, gu = rnd(T, I, scale=3), rnd(T, I, scale=3), \
            rnd(T, 2 * I, scale=3)
        n0 = ops.swiglu.launches
        out, out2 = ops.swiglu(gate, up), ops.swiglu(gu)
        torch.cuda.synchronize()
        assert ops.swiglu.launches == n0 + 2
        sp = max(hold_one_spacing("swiglu", out,
                                  ops.swiglu_reference(gate, up)),
                 hold_one_spacing("swiglu split", out2,
                                  ops.swiglu_reference(gu)))
        r = rows.setdefault("swiglu", {})
        r[f"max_abs_err_{tag}"] = max(max_err(out, ops.swiglu_reference(
            gate, up)), max_err(out2, ops.swiglu_reference(gu)))
        if main:
            b, by = bound(nbytes(gate, up, out))
            r.update(max_abs_err=r["max_abs_err_bf16"], bf16_spacings=sp,
                     bound_ms=b, bound_by=by, library_ms=None,
                     ms=timer.ms(lambda: ops.swiglu(gate, up)),
                     split_form_ms=timer.ms(lambda: ops.swiglu(gu)),
                     plain_ms=timer.ms(
                         lambda: ops.swiglu_reference(gate, up)))

        # rope: Llama-3-8B's q / k over 4096 positions, f32 tables
        q, k = rnd(1, T, HQ, D), rnd(1, T, KV, D)
        gq, gk = rnd(1, T, HQ, D), rnd(1, T, KV, D)
        n0, nb = ops.fused_rope.launches, ops.fused_rope_bwd.launches
        qo, ko = ops.fused_rope(q, k, cos_t, sin_t)
        dq, dk = ops.fused_rope_bwd(gq, gk, cos_t, sin_t)
        torch.cuda.synchronize()
        assert ops.fused_rope.launches == n0 + 1
        assert ops.fused_rope_bwd.launches == nb + 1
        rq, rk = ops.rope_reference(q, k, cos_t, sin_t)
        from paddle_tpu_torch.ops.fused import _rope_bwd_reference
        rdq, rdk = _rope_bwd_reference(gq, gk, cos_t, sin_t)
        sp = max(hold_one_spacing("fused_rope q", qo, rq),
                 hold_one_spacing("fused_rope k", ko, rk))
        spb = max(hold_one_spacing("fused_rope_bwd q", dq, rdq),
                  hold_one_spacing("fused_rope_bwd k", dk, rdk))
        for name, errs, spc in (
                ("fused_rope", (max_err(qo, rq), max_err(ko, rk)), sp),
                ("fused_rope_bwd", (max_err(dq, rdq), max_err(dk, rdk)),
                 spb)):
            r = rows.setdefault(name, {})
            r[f"max_abs_err_{tag}"] = max(errs)
            if main:
                b, by = bound(nbytes(q, k, cos_t, sin_t, qo, ko))
                r.update(max_abs_err=max(errs), bf16_spacings=spc,
                         bound_ms=b, bound_by=by, library_ms=None)
        if main:
            rows["fused_rope"].update(
                ms=timer.ms(lambda: ops.fused_rope(q, k, cos_t, sin_t)),
                plain_ms=timer.ms(
                    lambda: ops.rope_reference(q, k, cos_t, sin_t)))
            rows["fused_rope_bwd"].update(
                ms=timer.ms(lambda: ops.fused_rope_bwd(gq, gk, cos_t,
                                                       sin_t)),
                plain_ms=timer.ms(
                    lambda: _rope_bwd_reference(gq, gk, cos_t, sin_t)))

        # bias + residual + layer norm at GPT-3 6.7B's hidden
        x, res = rnd(T, GPT_H), rnd(T, GPT_H)
        x[1] += 30.0          # a large mean: the centred variance keeps it
        bb, w, lb = rnd(GPT_H), rnd(GPT_H), rnd(GPT_H)
        n0 = ops.fused_bias_residual_layer_norm.launches
        out = ops.fused_bias_residual_layer_norm(x, res, bb, w, lb)
        torch.cuda.synchronize()
        assert ops.fused_bias_residual_layer_norm.launches == n0 + 1
        want = ops.bias_residual_layer_norm_reference(x, res, bb, w, lb)
        sp = hold_one_spacing("fused_bias_residual_layer_norm", out, want)
        r = rows.setdefault("fused_bias_residual_layer_norm", {})
        r[f"max_abs_err_{tag}"] = max_err(out, want)
        if main:
            b, by = bound(nbytes(x, res, bb, w, lb, out))
            r.update(max_abs_err=r["max_abs_err_bf16"], bf16_spacings=sp,
                     bound_ms=b, bound_by=by, library_ms=None,
                     ms=timer.ms(lambda: ops.fused_bias_residual_layer_norm(
                         x, res, bb, w, lb)),
                     plain_ms=timer.ms(
                         lambda: ops.bias_residual_layer_norm_reference(
                             x, res, bb, w, lb)))

    # the MoE build at ERNIE-4.5's routing, f32 gates (bf16 out as a check)
    gates = torch.softmax(torch.randn(INC_TOKENS, MOE_E, device=DEV,
                                      generator=gc), -1)
    keep, oh, gv, _ = moe_ffn.gating_plan(gates, MOE_K, MOE_CAP)
    r = rows.setdefault("fused_moe_dispatch_combine", {})
    for dtype in (torch.float32, torch.bfloat16):
        kd, od, gd = (t.to(dtype) for t in (keep, oh, gv))
        n0 = ops.fused_moe_dispatch_combine.launches
        d, c = ops.fused_moe_dispatch_combine(kd, od, gd)
        torch.cuda.synchronize()
        assert ops.fused_moe_dispatch_combine.launches == n0 + 1
        rd, rc = ops.moe_dispatch_combine_reference(kd, od, gd)
        assert torch.equal(d, rd) and torch.equal(c, rc)
        r[f"max_abs_err_{'f32' if dtype == torch.float32 else 'bf16'}"] = \
            max(max_err(d, rd), max_err(c, rc))
    d, c = ops.fused_moe_dispatch_combine(keep, oh, gv)
    b, by = bound(nbytes(keep, oh, gv, d, c))
    r.update(max_abs_err=r["max_abs_err_f32"], bound_ms=b, bound_by=by,
             library_ms=None, tokens=INC_TOKENS, experts=MOE_E, top_k=MOE_K,
             capacity=MOE_CAP,
             ms=timer.ms(lambda: ops.fused_moe_dispatch_combine(keep, oh,
                                                               gv)),
             plain_ms=timer.ms(
                 lambda: ops.moe_dispatch_combine_reference(keep, oh, gv)))
    del d, c


# ------------------------------------------------ phase 2, generic (B11)
#: the generic elementwise kernel's cases: the JAX test's chain
#: exp(tanh(a*b+c)*0.5) - sqrt(abs(b)+1) (tests/test_fusion_cc.py:270-272)
#: at Llama-3-8B's FFN activation [4096, 14336], and phase 9e's rope
#: region on q (two strided halves of q [1, 2048, 32, 128], the
#: broadcast [1, 2048, 1, 64] tables)
EW_CHAIN_SHAPE = (INC_TOKENS, FFN)
SI_TOKENS = 2048
EW_CHAIN = [
    {"op": "multiply", "ins": ["#0", "#1"], "out": "ab"},
    {"op": "add", "ins": ["ab", "#2"], "out": "abc"},
    {"op": "tanh", "ins": ["abc"], "out": "t"},
    {"op": "multiply", "ins": ["t", 0.5], "out": "th"},
    {"op": "exponential", "ins": ["th"], "out": "e"},
    {"op": "abs", "ins": ["#1"], "out": "babs"},
    {"op": "add", "ins": ["babs", 1.0], "out": "b1"},
    {"op": "sqrt", "ins": ["b1"], "out": "s"},
    {"op": "subtract", "ins": ["e", "s"], "out": "out"}]
EW_ROPE = [
    {"op": "multiply", "ins": ["#0", "#1"], "out": "x1c"},
    {"op": "multiply", "ins": ["#2", "#3"], "out": "x2s"},
    {"op": "subtract", "ins": ["x1c", "x2s"], "out": "out"}]
#: the bars on the kernel against its plain version (both compute each
#: instruction in f32 and round it to the region's dtype): f32 within
#: EW_F32_ULPS ulps, bf16 within one bf16 spacing; a planted fault (one
#: opcode swapped) must miss them by EW_FAULT_FACTOR at least
EW_F32_ULPS = 4.0
EW_FAULT_FACTOR = 100.0


def max_f32_ulps(got, want) -> float:
    """max |got - want| in f32 ulps at want's magnitude, floored at 1/256
    of the tensor's largest (as `max_bf16_spacings` floors)."""
    got, want = got.detach().float(), want.detach().float()
    mag = want.abs().clamp_min(max(float(want.abs().max()) / 256,
                                   torch.finfo(torch.float32).tiny))
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 23)
    return float(((got - want).abs() / ulp).max())


def ew_spacings(got, want) -> float:
    """The kernel's distance from its plain version in spacings of the
    working type: f32 ulps, bf16 spacings; entries equal in both (an inf
    of both, a NaN of both) count as no distance."""
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    got, want = (torch.where(same, torch.zeros_like(t), t)
                 for t in (got, want))
    return max_bf16_spacings(got, want) if got.dtype == torch.bfloat16 \
        else max_f32_ulps(got, want)


def ew_bar(dtype) -> float:
    return 1.0 if dtype == torch.bfloat16 else EW_F32_ULPS


def swap_opcode(prog, old: str, new: str):
    """`prog` with its first `old` instruction computing `new` instead."""
    out = [dict(st) for st in prog]
    i = next(j for j, st in enumerate(out) if st["op"] == old)
    out[i]["op"] = new
    return out


def hold_ew(name, prog, operands, planted=None):
    """One kernel launch of `prog` against its plain version within the
    bar of the working type; with `planted` (a program with one opcode
    swapped), the faulty launch against the sound plain version must miss
    the bar by EW_FAULT_FACTOR. Returns (spacings, planted spacings,
    max_abs_err, out)."""
    n0 = ops.generic_elementwise.launches
    out = ops.generic_elementwise(prog, *operands)
    torch.cuda.synchronize()
    assert ops.generic_elementwise.launches == n0 + 1
    want = ops.generic_elementwise_reference(prog, *operands)
    sp, bar = ew_spacings(out, want), ew_bar(out.dtype)
    assert sp <= bar, (name, sp, bar)
    psp = None
    if planted is not None:
        bad = ops.generic_elementwise(planted, *operands)
        torch.cuda.synchronize()
        psp = ew_spacings(bad, want)
        assert psp >= EW_FAULT_FACTOR * bar, (name, "planted", psp)
        del bad
    return sp, psp, max_err(out, want), out


def check_generic_elementwise(timer, rows):
    """B11, the generic elementwise kernel, against its plain version:
    the JAX test's chain at [4096, 14336] in f32 and bf16 and the rope
    region of Llama-3-8B's q over 2048 tokens (bf16, operands strided and
    broadcast in place), each timed beside its bytes bound and its plain
    version (no one PyTorch call computes an arbitrary region:
    library_ms None), each with a planted fault (tanh computed as
    logistic; the rope's subtract as add) that must miss the bar by far;
    then every opcode of the instruction set, f32 and bf16, at
    [1024, 4096]."""
    gc = torch.Generator(DEV).manual_seed(31)
    r = rows.setdefault("generic_elementwise", {})
    cases, per_op = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        a, b, c = (torch.randn(*EW_CHAIN_SHAPE, device=DEV, generator=gc)
                   .to(dtype) for _ in range(3))
        sp, psp, err, out = hold_ew(f"chain {tag}", EW_CHAIN, (a, b, c),
                                    swap_opcode(EW_CHAIN, "tanh",
                                                "logistic"))
        bb, by = bound(nbytes(a, b, c, out))
        cases[f"chain_{tag}"] = {
            "shape": list(EW_CHAIN_SHAPE), "spacings": sp,
            "planted_spacings": psp, "max_abs_err": err, "bound_ms": bb,
            "bound_by": by,
            "ms": timer.ms(lambda: ops.generic_elementwise(EW_CHAIN, a, b,
                                                          c)),
            "plain_ms": timer.ms(lambda: ops.generic_elementwise_reference(
                EW_CHAIN, a, b, c))}
        r[f"max_abs_err_{tag}"] = err
        del a, b, c, out
    q = torch.randn(1, SI_TOKENS, HQ, D, device=DEV, generator=gc).to(
        torch.bfloat16)
    cos_t, sin_t = precompute_rope(D, SI_TOKENS, 500000.0, DEV)
    cs = cos_t[None, :, None, :].to(torch.bfloat16)
    sn = sin_t[None, :, None, :].to(torch.bfloat16)
    rope_ops = (q[..., :D // 2], cs, q[..., D // 2:], sn)
    sp, psp, err, out = hold_ew("rope q", EW_ROPE, rope_ops,
                                swap_opcode(EW_ROPE, "subtract", "add"))
    bb, by = bound(nbytes(*rope_ops, out))
    cases["rope_q_bf16"] = {
        "shape": list(out.shape), "spacings": sp, "planted_spacings": psp,
        "max_abs_err": err, "bound_ms": bb, "bound_by": by,
        "ms": timer.ms(lambda: ops.generic_elementwise(EW_ROPE, *rope_ops)),
        "plain_ms": timer.ms(lambda: ops.generic_elementwise_reference(
            EW_ROPE, *rope_ops))}
    from paddle_tpu_torch.ops.elementwise import EW_OPS
    unary = ("exponential", "log", "tanh", "logistic", "rsqrt", "sqrt",
             "negate", "abs")
    for op in EW_OPS:
        for dtype in (torch.float32, torch.bfloat16):
            # a positive first operand (log, sqrt, rsqrt, power take it),
            # a second one of either sign, away from 0 (divide takes it)
            x = (torch.rand(1024, 4096, device=DEV, generator=gc) * 4
                 + 0.25).to(dtype)
            y = ((torch.rand(1024, 4096, device=DEV, generator=gc) + 0.25)
                 * torch.randn(1024, 4096, device=DEV, generator=gc).sign()
                 ).to(dtype)
            prog = [{"op": op, "ins": ["#0"] if op in unary else
                     ["#0", "#1"], "out": "r"},
                    {"op": "multiply", "ins": ["r", "#1"], "out": "s"},
                    {"op": "add", "ins": ["s", 0.75], "out": "t"}]
            sp, _, err, _ = hold_ew(f"{op} {dtype}", prog, (x, y))
            per_op[f"{op}_{'bf16' if dtype == torch.bfloat16 else 'f32'}"] \
                = {"spacings": sp, "max_abs_err": err}
    main = cases["rope_q_bf16"]
    r.update(max_abs_err=main["max_abs_err"], bf16_spacings=main["spacings"],
             f32_ulps=max(cases["chain_f32"]["spacings"],
                          max(v["spacings"] for k, v in per_op.items()
                              if k.endswith("f32"))),
             bound_ms=main["bound_ms"], bound_by=main["bound_by"],
             ms=main["ms"], plain_ms=main["plain_ms"], library_ms=None,
             case="rope_q_bf16", cases=cases, opcodes=per_op,
             bars={"f32_ulps": EW_F32_ULPS, "bf16_spacings": 1.0,
                   "planted_factor": EW_FAULT_FACTOR})


# ----------------------------------------------------------- phase 9c/9d
def incubate_paths(card):
    """Phase 9c: the incubate API and the standalone fuse at full width,
    forward and backward, each kernel held against its plain version:
    fused_rotary_position_embedding at Llama-3-8B's attention over 4096
    positions with the [S, D/2] and Paddle's [S, D] tables (one rope
    launch forward, one backward, a call); incubate swiglu on [4096, 2 x
    14336] (split) and on two [4096, 14336] operands (one launch a call;
    the backward is torch ops); fuse over
    fused_bias_dropout_residual_layer_norm's eval form at GPT-3 6.7B's
    width (T 4096, H 4096, bf16, dropout 0.1 in eval) and over
    top_k_gating at ERNIE-4.5-21B-A3B's routing (T 4096, E 64, k 6, C
    480, f32 gates): each one rewrite and one launch, no untraced program;
    one forward of FusedTransformerEncoderLayer at BERT-base width (8 x
    512, bf16): its attention one flash launch, held against the plain
    version on the layer's own q / k / v at the bf16 flash limits. Every
    other kernel 0 and no plain call."""
    from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.jit import fusion
    gc = torch.Generator(DEV).manual_seed(31)
    bf = torch.bfloat16
    T = INC_TOKENS

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(*shape, device=DEV, generator=gc)
                * scale).to(dtype)
    ops.reset_counts()
    fusion.reset_stats()
    out = {"card": card["nvidia_smi"]}

    cos, sin = precompute_rope(D, T, 500000.0, DEV)          # [T, 64]
    full = (cos.repeat_interleave(2, -1), sin.repeat_interleave(2, -1))
    q = rnd(1, T, HQ, D).requires_grad_()
    k = rnd(1, T, KV, D).requires_grad_()
    v = rnd(1, T, KV, D)
    from paddle_tpu_torch.ops.fused import _rope_bwd_reference
    for table, (c, s) in (("half", (cos, sin)), ("full", full)):
        qo, ko, vo = IF.fused_rotary_position_embedding(q, k, v, sin=s,
                                                        cos=c)
        assert vo is v
        gq, gk = rnd(*qo.shape), rnd(*ko.shape)
        dq, dk = torch.autograd.grad((qo, ko), (q, k), (gq, gk))
        rq, rk = ops.rope_reference(q.detach(), k.detach(), cos, sin)
        rdq, rdk = _rope_bwd_reference(gq, gk, cos, sin)
        out[f"rope_{table}_bf16_spacings"] = max(
            hold_one_spacing("rope q", qo, rq),
            hold_one_spacing("rope k", ko, rk),
            hold_one_spacing("rope dq", dq, rdq),
            hold_one_spacing("rope dk", dk, rdk))

    for form in ("split", "two"):
        if form == "split":
            x = rnd(T, 2 * FFN, scale=3).requires_grad_()
            args = (x,)
        else:
            args = tuple(rnd(T, FFN, scale=3).requires_grad_()
                         for _ in range(2))
        y = IF.swiglu(*args)
        gy = rnd(*y.shape)
        grads = torch.autograd.grad(y, args, gy)
        plain_args = tuple(a.detach().requires_grad_() for a in args)
        yr = ops.swiglu_reference(*plain_args)
        rgrads = torch.autograd.grad(yr, plain_args, gy)
        out[f"swiglu_{form}_bf16_spacings"] = hold_one_spacing(
            "swiglu", y, yr.detach())
        out[f"swiglu_{form}_grad_max_abs_err"] = max(
            max_err(a, b) for a, b in zip(grads, rgrads))
        del args, y, grads, plain_args, yr, rgrads

    xb, rb = rnd(T, GPT_H), rnd(T, GPT_H)
    bb, wb, lb = rnd(GPT_H), rnd(GPT_H), rnd(GPT_H)

    def brln_program(x, r, b, w, l):
        return IF.fused_bias_dropout_residual_layer_norm(
            x, r, bias=b, ln_scale=w, ln_bias=l, dropout_rate=0.1,
            training=False)
    got = fusion.fuse(brln_program)(xb, rb, bb, wb, lb)
    want = ops.bias_residual_layer_norm_reference(xb, rb, bb, wb, lb)
    out["brln_bf16_spacings"] = hold_one_spacing("brln", got, want)
    out["brln_max_abs_vs_unfused_program"] = max_err(
        got, brln_program(xb, rb, bb, wb, lb))

    gates = torch.softmax(torch.randn(T, MOE_E, device=DEV, generator=gc),
                          -1)

    def gate_program(g):
        return moe_ffn.top_k_gating(g, MOE_K, MOE_CAP)
    d, c, aux = fusion.fuse(gate_program)(gates)
    rd, rc, raux = gate_program(gates)
    assert torch.equal(d, rd) and torch.equal(c, rc) and \
        torch.equal(aux, raux)
    out["moe_dispatch_exact"] = True
    del d, c, rd, rc

    E_, heads, ffn = BERT_BASE
    layer = FusedTransformerEncoderLayer(
        E_, heads, ffn, dropout_rate=0.0, device=DEV, dtype=bf,
        generator=torch.Generator(DEV).manual_seed(0))
    layer.eval()
    # the layer's attention, as its route calls the kernel, is held
    # against the plain version on the same q / k / v
    seen, kernel = [], attn_routes.flash_sdpa

    def recording(q_, k_, v_, **kw):
        o_ = kernel(q_, k_, v_, **kw)
        seen.append((q_, k_, v_, kw, o_))
        return o_
    attn_routes.flash_sdpa = recording
    try:
        with torch.no_grad():
            y = layer(rnd(BERT_BATCH, BERT_SEQ, E_))
    finally:
        attn_routes.flash_sdpa = kernel
    assert y.shape == (BERT_BATCH, BERT_SEQ, E_) and \
        bool(torch.isfinite(y).all())
    (aq, ak, av, kw, ao), = seen
    assert kw["causal"] is False and ao.shape == (
        BERT_BATCH, BERT_SEQ, heads, E_ // heads), (kw, ao.shape)
    with torch.no_grad():
        want = ops.flash_sdpa_reference(aq, ak, av, **kw)
    out["bert_attention_rel_err_bf16"] = dict(zip(
        ("tensor", "tile"), assert_flash_bf16("bert attention", ao, want)))
    del seen, aq, ak, av, ao, want

    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want_counts = {"fused_rope": 2, "fused_rope_bwd": 2, "swiglu": 2,
                   "fused_bias_residual_layer_norm": 1,
                   "fused_moe_dispatch_combine": 1, "flash_sdpa": 1}
    for name, cnt in counts.items():
        assert cnt == {"launches": want_counts.get(name, 0),
                       "plain_calls": 0}, (name, cnt)
    st = fusion.stats()
    assert st["untraced"] == 0, st
    assert st["rewritten"] == dict({p: 0 for p in st["rewritten"]},
                                   bias_residual_ln=1, moe_dispatch=1), st
    assert st["found"] == st["rewritten"] and \
        sum(st["refused"].values()) == 0, st
    out.update(launches=want_counts, fuse=st, moe_capacity=MOE_CAP)
    del layer
    return out, {k: v["launches"] for k, v in counts.items()
                 if v["launches"]}


def grad_rel_diff(model, ref: dict) -> float:
    """The largest over `model`'s parameters of ||grad - ref|| / ||ref||,
    `ref` their gradients from another run of the same step (a parameter
    the run left without a gradient reads 1)."""
    def diff(n, p):
        if p.grad is None:
            return 1.0
        return float((p.grad.float() - ref[n].float()).norm()
                     / ref[n].float().norm())
    return max(diff(n, p) for n, p in model.named_parameters())


def planted_swiglu_readings(model, ids, labels, ref: dict) -> dict:
    """The first step's forward and backward through the flagged capture
    with each planted fault of PLANTED_SWIGLU in place of the swiglu
    rewrite's executor: its gradients' `grad_rel_diff` against the
    unflagged run's `ref`. No optimizer step; the sound executor is put
    back and the capture dropped after."""
    from paddle_tpu_torch.jit import StaticFunction, fusion
    sound = fusion.PATTERNS["swiglu"]
    readings = {}
    try:
        for name, executor in PLANTED_SWIGLU.items():
            fusion.PATTERNS["swiglu"] = sound[:2] + (executor,) + sound[3:]
            torch._dynamo.reset()
            with flags_guard(use_fusion_compiler=True):
                loss, _ = StaticFunction(model.forward)(ids, labels=labels)
            loss.backward()
            readings[name] = grad_rel_diff(model, ref)
            model.zero_grad(set_to_none=True)
            del loss
    finally:
        fusion.PATTERNS["swiglu"] = sound
        torch._dynamo.reset()
    return readings


def to_static_training(card):
    """Phase 9d: Llama-3-8B width, depth cut to STATIC_LAYERS, 1 x 4096
    tokens, f32 weights drawn on the card then bf16 by amp.decorate O2
    (f32 master weights and AdamW moments), AdamW lr 3e-4, decay 0.1,
    ClipGradByGlobalNorm(1.0): STATIC_WARMUP + STATIC_STEPS eager steps
    through jit.to_static, once without FLAGS_use_fusion_compiler and once
    with it, from the same weights. The flagged capture finds and
    rewrites one swiglu a layer (the JAX pass's count on this config) and
    nothing else; each timed step launches swiglu once a layer on the
    flagged run and never on the other, the flash forward and backward
    once a layer on both, nothing else; no untraced program. Two bars:
    the first step's parameter gradients of the two runs within
    STATIC_GRAD_BAR (`grad_rel_diff`), which each planted fault of the
    rewrite (PLANTED_SWIGLU, run on the flagged model before its first
    step) must miss; and each step's two losses within one bf16 spacing
    at the loss's magnitude (2^-7 relative), as the flagged FFN rounds
    once where the captured F.silu(g) * up rounds twice."""
    from paddle_tpu_torch.jit import fusion, to_static
    cfg = llama3_8b_config(num_hidden_layers=STATIC_LAYERS,
                           max_position_embeddings=INC_TOKENS)
    L = STATIC_LAYERS
    g = torch.Generator(DEV).manual_seed(5)
    ids = torch.randint(0, cfg.vocab_size, (1, INC_TOKENS), device=DEV,
                        generator=g)
    labels = torch.roll(ids, -1, dims=1)
    runs, launches, ref, planted = {}, {}, {}, {}
    for flagged in (False, True):
        model = LlamaForCausalLM(cfg, device=DEV, dtype=torch.float32,
                                 generator=torch.Generator(DEV)
                                 .manual_seed(0))
        opt = optim.AdamW(learning_rate=3e-4,
                          parameters=model.parameters(), weight_decay=0.1,
                          grad_clip=ClipGradByGlobalNorm(1.0))
        model, opt = amp.decorate(model, opt, level="O2")
        if flagged:
            planted = planted_swiglu_readings(model, ids, labels, ref)
        fusion.reset_stats()
        losses, times = [], []
        with flags_guard(use_fusion_compiler=flagged):
            to_static(model)
            for i in range(STATIC_WARMUP + STATIC_STEPS):
                if i == STATIC_WARMUP:
                    ops.reset_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                loss, _ = model(ids, labels=labels)
                loss.backward()
                if i == 0 and flagged:
                    grad_rel = grad_rel_diff(model, ref)
                elif i == 0:
                    ref = {n: p.grad.clone()
                           for n, p in model.named_parameters()}
                opt.step()
                opt.clear_grad()
                losses.append(float(loss.detach()))
                times.append((time.perf_counter() - t) * 1e3)
        counts = ops.launch_counts()
        want = {"flash_sdpa": L * STATIC_STEPS,
                "flash_sdpa_bwd": L * STATIC_STEPS}
        if flagged:
            want["swiglu"] = L * STATIC_STEPS
        for name, c in counts.items():
            assert c == {"launches": want.get(name, 0), "plain_calls": 0}, \
                (name, c)
        st = fusion.stats()
        assert st["untraced"] == 0 and st["graphs"] == 1, st
        zero = {p: 0 for p in st["found"]}
        if flagged:
            assert st["found"] == st["rewritten"] == dict(zero, swiglu=L), st
            launches = {k: v["launches"] for k, v in counts.items()
                        if v["launches"]}
        else:
            assert st["found"] == st["rewritten"] == zero, st
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
        runs["flagged" if flagged else "unflagged"] = {
            "losses": losses, "step_ms": times,
            "step_ms_median": statistics.median(times[STATIC_WARMUP:]),
            "fuse": st}
        del model, opt, loss
        torch._dynamo.reset()       # drop the capture's cached frames
        gc.collect()
        torch.cuda.empty_cache()
    del ref
    a, b = runs["flagged"]["losses"], runs["unflagged"]["losses"]
    rel = [abs(x - y) / abs(y) for x, y in zip(a, b)]
    readings = {"grad_rel_diff_first_step": grad_rel,
                "grad_bar_rel": STATIC_GRAD_BAR,
                "planted_grad_rel_diff": planted, "loss_rel_diff": rel,
                "loss_bar_rel": 2.0 ** -7}
    assert grad_rel <= STATIC_GRAD_BAR, readings
    assert all(v > STATIC_GRAD_BAR for v in planted.values()), readings
    assert max(rel) <= 2.0 ** -7, readings
    return {"card": card["nvidia_smi"], "layers": L, "layers_published": 32,
            "seq": INC_TOKENS, "batch": 1, "warmup_steps": STATIC_WARMUP,
            "timed_steps": STATIC_STEPS, **readings,
            "launches_per_step": {"swiglu": L, "flash_sdpa": L,
                                  "flash_sdpa_bwd": L}, **runs}, launches


# --------------------------------------------------------------- phase 9e
#: phase 9e: Llama-3-8B width, depth cut to SI_LAYERS, one [1, 2048]
#: request through jit.save -> inference.Predictor
SI_LAYERS = 4
#: phase 9e's bar on the flagged run's logits against the unflagged
#: run's, relative (Frobenius); set before the first reading (PERF.md):
#: the flagged program rounds once where the unflagged rounds twice in
#: each norm and swiglu, bf16 throughout
SI_LOGITS_BAR = 2.0 ** -5
#: phase 9e's planted fault of the rewritten program: every rope region's
#: subtract computed as add (the fault must miss SI_LOGITS_BAR)
SI_PLANTED = ("subtract", "add")


def plant_generic(gm, old: str, new: str) -> None:
    """Plant a fault in a rewritten program: every generic region whose
    program has an `old` instruction computes `new` there instead."""
    for n in gm.graph.nodes:
        if n.op == "call_function" and \
                n.target is ops.generic_elementwise and \
                any(st["op"] == old for st in n.args[0]):
            n.args = (swap_opcode(n.args[0], old, new), *n.args[1:])
    gm.recompile()


def artifact_bytes(prefix) -> dict:
    return {ext: os.path.getsize(prefix + ext)
            for ext in (".pdparams", ".pt2", ".graph.txt")}


def logits_rel(a, b) -> float:
    a, b = torch.from_numpy(a).double(), torch.from_numpy(b).double()
    return float((a - b).norm() / b.norm())


def static_inference(card):
    """Phase 9e: Llama-3-8B width, depth cut to SI_LAYERS, bf16 weights
    drawn on the card, served through Paddle's inference API: jit.save at
    InputSpec([1, 2048], "int64"), then inference.Config ->
    create_predictor -> copy_from_cpu -> run -> copy_to_cpu, once without
    FLAGS_use_fusion_compiler and once with it. The flagged Predictor's
    pass finds and rewrites 2L + 1 rmsnorm, L swiglu and 4L generic (rope)
    regions, no sdpa (attention is already the flash node of the exported
    program) and refuses nothing; one flagged run launches exactly
    fused_rms_norm 2L + 1, swiglu L, generic_elementwise 4L and the flash
    forward L times, the unflagged run the flash forward L times and
    nothing else. The two runs' logits agree within SI_LOGITS_BAR, which
    a third Predictor whose generic regions compute their subtract as add
    (SI_PLANTED) must miss. Seconds for export + save, load (+ the pass)
    and the first run; the artifact's bytes; each Predictor's median run
    over 3 more."""
    L = SI_LAYERS
    cfg = llama3_8b_config(num_hidden_layers=L)
    model = LlamaForCausalLM(cfg, device=DEV, dtype=torch.bfloat16,
                             generator=torch.Generator(DEV).manual_seed(0))
    g = torch.Generator(DEV).manual_seed(9)
    ids = torch.randint(0, cfg.vocab_size, (1, SI_TOKENS), device=DEV,
                        generator=g).cpu().numpy()
    want_unflagged = {"flash_sdpa": L}
    want_flagged = {"flash_sdpa": L, "fused_rms_norm": 2 * L + 1,
                    "swiglu": L, "generic_elementwise": 4 * L}
    res = {"card": card["nvidia_smi"], "layers": L, "layers_published": 32,
           "tokens": SI_TOKENS, "batch": 1, "dtype": "bfloat16"}
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "llama")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        jit.save(model, prefix,
                 input_spec=[InputSpec([1, SI_TOKENS], "int64")])
        res["export_save_s"] = time.perf_counter() - t0
        res["artifact_bytes"] = artifact_bytes(prefix)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        logits, launches = {}, {}
        runs = (("unflagged", False, None), ("flagged", True, None),
                ("planted", True, SI_PLANTED))
        for tag, flagged, planted in runs:
            t0 = time.perf_counter()
            with flags_guard(use_fusion_compiler=flagged):
                pred = inference.create_predictor(inference.Config(prefix))
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            if planted is not None:
                plant_generic(pred.fused.module, *planted)
            h = pred.get_input_handle(pred.get_input_names()[0])
            h.copy_from_cpu(ids)
            ops.reset_counts()
            t0 = time.perf_counter()
            pred.run()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            counts = {k: v["launches"] for k, v in
                      ops.launch_counts().items() if v["launches"]}
            plain = {k: v["plain_calls"] for k, v in
                     ops.launch_counts().items() if v["plain_calls"]}
            out = pred.get_output_handle(pred.get_output_names()[0])
            logits[tag] = out.copy_to_cpu()
            assert not plain, (tag, plain)
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pred.run()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            entry = {"load_s": load_s, "first_run_s": first_s,
                     "run_ms": times, "run_ms_median":
                     statistics.median(times), "launches": counts}
            if flagged:
                entry.update(found=pred.fused.found,
                             refused=pred.fused.refused,
                             rewritten=pred.fused.n_fused)
                assert pred.fused.found == {"sdpa": 0, "rmsnorm": 2 * L + 1,
                                            "swiglu": L,
                                            "generic": 4 * L}, entry
                assert not any(pred.fused.refused.values()), entry
                assert pred.fused.n_fused == 7 * L + 1, entry
            want = want_flagged if flagged else want_unflagged
            if planted is None:
                assert counts == want, (tag, counts, want)
            launches[tag] = counts
            res[tag] = entry
            del pred, h, out
            gc.collect()
            torch.cuda.empty_cache()
    for tag in ("flagged", "unflagged"):
        assert np.isfinite(logits[tag]).all(), tag
        assert logits[tag].shape == (1, SI_TOKENS, cfg.vocab_size), tag
    rel = logits_rel(logits["flagged"], logits["unflagged"])
    planted_rel = logits_rel(logits["planted"], logits["unflagged"])
    res.update(logits_rel_diff=rel, logits_bar_rel=SI_LOGITS_BAR,
               planted_logits_rel_diff=planted_rel,
               logits_max_abs_diff=float(np.abs(
                   logits["flagged"] - logits["unflagged"]).max()),
               argmax_agreement=float((logits["flagged"].argmax(-1)
                                       == logits["unflagged"].argmax(-1))
                                      .mean()))
    assert rel <= SI_LOGITS_BAR, res
    assert planted_rel > SI_LOGITS_BAR, res
    return res, launches["flagged"]


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
    # the bf16 route (the main path's); f32 runs megakernels.cu's core
    "fused_oproj_norm": ("paddle_tpu_torch/ops/csrc/megadecode_sm90.cu",
                         "paddle_tpu/ops/pallas_megadecode.py:182"),
    "fused_ffn": ("paddle_tpu_torch/ops/csrc/megadecode_sm90.cu",
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
    # the bf16 route (the main path's); f32 runs megakernels.cu's core
    "weight_only_linear": ("paddle_tpu_torch/ops/csrc/wol_sm90.cu",
                           "paddle_tpu/ops/quant.py:227"),
    "gmm": ("paddle_tpu_torch/ops/csrc/gmm.cu",
            "paddle_tpu/ops/pallas_gmm.py:204"),
    "gmm_dlhs": ("paddle_tpu_torch/ops/csrc/gmm.cu",
                 "paddle_tpu/ops/pallas_gmm.py:230"),
    "tgmm": ("paddle_tpu_torch/ops/csrc/gmm.cu",
             "paddle_tpu/ops/pallas_gmm.py:193"),
    "fused_append_rows": ("paddle_tpu_torch/ops/csrc/fused.cu",
                          "paddle_tpu/ops/fused.py:474"),
    "int4_dequantize": ("paddle_tpu_torch/ops/csrc/megakernels.cu",
                        "paddle_tpu/ops/quant.py:83"),
    "mla_decode_attention": ("paddle_tpu_torch/ops/csrc/mla.cu",
                             "paddle_tpu/ops/pallas_mla.py:104"),
    "flashmask_sdpa": ("paddle_tpu_torch/ops/csrc/flashmask.cu",
                       "paddle_tpu/ops/pallas_flashmask.py:305"),
    # dq's pallas_call; dkv's is :359
    "flashmask_sdpa_bwd": ("paddle_tpu_torch/ops/csrc/flashmask.cu",
                           "paddle_tpu/ops/pallas_flashmask.py:343"),
    "swiglu": ("paddle_tpu_torch/ops/csrc/fused.cu",
               "paddle_tpu/ops/fused.py:554"),
    "fused_rope": ("paddle_tpu_torch/ops/csrc/fused.cu",
                   "paddle_tpu/ops/fused.py:354"),
    # the custom VJP's backward (jnp there), the same kernel rotating by
    # -theta here
    "fused_rope_bwd": ("paddle_tpu_torch/ops/csrc/fused.cu",
                       "paddle_tpu/ops/fused.py:340"),
    "fused_bias_residual_layer_norm": ("paddle_tpu_torch/ops/csrc/fused.cu",
                                       "paddle_tpu/ops/fused.py:210"),
    "fused_moe_dispatch_combine": ("paddle_tpu_torch/ops/csrc/fused.cu",
                                   "paddle_tpu/ops/fused.py:265"),
    # the Pallas loop the JAX pass synthesizes per generic region
    "generic_elementwise": ("paddle_tpu_torch/ops/csrc/elementwise.cu",
                            "paddle_tpu/jit/fusion_cc.py:201"),
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
    emit("8b tiny moe training cpu vs card", card=card["nvidia_smi"],
         **tiny_moe_train_parity())
    emit("8c tiny flashmask and varlen attention cpu vs card",
         card=card["nvidia_smi"], **tiny_flashmask_parity())
    res, train_launches = train_8b(card)
    emit("9 llama3-8b-width pretraining, 4 of 32 layers", **res)
    gc.collect()
    torch.cuda.empty_cache()
    res, fm_launches = check_flashmask(Timer(), rows, card)
    emit("9b flashmask at llama3-8b attention width", **res)
    gc.collect()
    torch.cuda.empty_cache()
    res, inc_launches = incubate_paths(card)
    emit("9c incubate api and fuse at full width", **res)
    gc.collect()
    torch.cuda.empty_cache()
    res, static_launches = to_static_training(card)
    emit(f"9d llama3-8b-width training through to_static and the fusion "
         f"pass, {STATIC_LAYERS} of 32 layers", **res)
    gc.collect()
    torch.cuda.empty_cache()
    res, static_inf_launches = static_inference(card)
    emit(f"9e llama3-8b-width static inference through jit.save, "
         f"inference.Predictor and the fusion_cc pass, {SI_LAYERS} of 32 "
         f"layers", **res)
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
    res, moe_train_launches_ = train_moe(card)
    emit(f"12b ernie45-21b-a3b-width moe training, {MOE_TRAIN_LAYERS} of 28 "
         f"layers", **res)
    gc.collect()
    torch.cuda.empty_cache()

    # DeepSeek-V2-Lite at full width and depth (31.4 GB of bf16 weights
    # drawn on the card): the fused chain (the MLA site), the split chain
    # (fused_append_rows), int8 on the fused chain, int4 on the fused
    # chain (its split front: fused_append_rows, int4_dequantize), then
    # generate_cached (the flash prefill at head dim 192,
    # mla_decode_attention)
    t0 = time.perf_counter()
    model = DeepSeekV2ForCausalLM(DeepSeekV2Config(**DEEPSEEK_V2_LITE),
                                  device=DEV, dtype=torch.bfloat16,
                                  generator=torch.Generator(DEV).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mla_launches = {}
    for key, chain, quant in (("fused", "fused", None),
                              ("split", "split", None),
                              ("int8", "fused", "int8"),
                              ("int4", "fused", "int4")):
        launches: dict = {}
        out, res = serve_trace(model, chain, launches, quant=quant)
        mla_launches[key] = launches
        extra = {"model_init_s": init_s} if key == "fused" else {
            "identical_token_share_vs_fused": same_share(mla_out, out)}
        if quant:
            extra["quantize_s"] = res.pop("engine_build_s")
        else:
            mla_out = out if key == "fused" else mla_out
        emit(f"13 deepseek-v2-lite serving, "
             f"{quant + ' weights, ' if quant else ''}{chain} chain",
             card=card["nvidia_smi"], **extra, **res)
        gc.collect()
        torch.cuda.empty_cache()
    res = generate_cached_run(model)
    mla_launches["generate_cached"] = {
        "flash_sdpa": res["flash_launches"],
        "mla_decode_attention": res["mla_decode_launches"]}
    emit("13 deepseek-v2-lite generate_cached", card=card["nvidia_smi"],
         **res)
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
             ("ernie45-21b-a3b fused", moe_launches),
             ("ernie45-21b-a3b-width training", moe_train_launches_),
             ("deepseek-v2-lite split", mla_launches["split"]),
             ("deepseek-v2-lite int4 fused", mla_launches["int4"]),
             ("deepseek-v2-lite generate_cached",
              mla_launches["generate_cached"]),
             ("flashmask at 8B attention width", fm_launches),
             ("to_static llama training, fusion pass", static_launches),
             ("static inference, fusion_cc pass", static_inf_launches),
             ("incubate api and fuse", inc_launches))
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
            "rel_err_bf16": r.get("rel_err_bf16"),
            "bf16_spacings": r.get("bf16_spacings")}
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
        if name == "fused_qkv_rope_append":
            # the MLA site at DeepSeek-V2-Lite's step, fp and int8, with
            # the launches of phase 13's fused chains
            for site, run in (("mla", "fused"), ("mla_int8", "int8")):
                row[site] = dict(r[site], launches=mla_launches[run][name])
        if name == "ragged_paged_attention":
            row["mla_576"] = dict(r["mla_576"],
                                  launches=mla_launches["fused"][name])
            row["long"] = {k: r["long"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "rel_err_bf16")}
            row.update({k: r[k] for k in ("decode_only_ms",
                                          "decode_only_bound_ms")})
        if name == "flash_sdpa":
            row["d192"] = dict(r["d192"], launches=mla_launches[
                "generate_cached"]["flash_sdpa"])
        if name in ("mla_decode_attention", "generic_elementwise"):
            row["cases"] = r["cases"]
        if name.startswith("flashmask_sdpa"):
            # the packed documents' readings; every encoding's in phase 9b
            row["case"] = "causal_C1_docs"
            row["segmented_ms"] = r["segmented_ms"]
        if name == "gmm":
            # the forward's launches on phase 12b's training path, beside
            # the backward kernels'
            row["train_launches"] = {
                k: moe_train_launches_[k] for k in ("gmm", "gmm_dlhs",
                                                    "tgmm")}
        if name in ("gmm", "gmm_dlhs", "tgmm"):
            row["library_note"] = r.get("library_note")
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
