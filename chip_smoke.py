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
   by relative errors (`paged_rel_errors`), f32 at 2e-5;
3. a tiny f32 Llama served on the CPU (plain versions) and on the card
   (kernels) over one seeded join/leave trace, on the fused and on the
   split chain and on the alternating path (ragged=False) under
   FLAGS_paged_impl "intree" (v2) and "intree_v1" (v1): identical greedy
   tokens, and on the alternating path exact launch counts; then tiny
   generate and generate_cached (greedy, f32) CPU vs card: identical
   tokens, scores within 1e-5;
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
10. the ``{"kernels": [...]}`` line (launches from the run of the path
   that uses each kernel: the fused chain, the split chain for
   rope_append, phase 6's two runs for paged v2 and v1, the 8B training
   run for flash attention), then the ``{"ok": true, ...}`` line.

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
H, HQ, KV, D, PSZ, FFN = 4096, 32, 8, 128, 16, 14336
SLOTS, CHUNK, MAX_CTX = 4, 128, 1024
# the slice's training geometry: Llama-3-8B width, depth cut to 4 layers
TRAIN_LAYERS, TRAIN_SEQ, WARMUP_STEPS, TIMED_STEPS = 4, 8192, 2, 5
F32_FLASH_SEQ = 2048
# the paged decode kernels' long-context shape: 8 sequences with page
# tables for Llama-3-8B's max_position_embeddings
LONG_SEQS, LONG_CTX = 8, 8192
# generate_cached at 8B: 4 prompts of 512 tokens, 32 greedy new tokens
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 512, 32


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
            nt = mb["num_tokens"].cpu().tolist()
            kvl = mb["kv_lengths"].cpu().tolist()
            isz = qa.element_size()
            live = sum(kv * KV * D * 2 * isz
                       for kv, n in zip(kvl, nt) if n)
            pairs = sum(kv - n + t + 1 for kv, n in zip(kvl, nt)
                        for t in range(n))
            b, by = bound(nbytes(qa, o, *tabs) + live, 4 * HQ * D * pairs,
                          dtype)
            # the same batch with the prefill chunk idle: a decode-only step
            dec = (tabs[0], tabs[1] * (tabs[1] == 1), tabs[2] * (tabs[1] == 1),
                   tabs[3])
            dec_live = sum(kv * KV * D * 2 * isz
                           for kv, n in zip(kvl, nt) if n == 1)
            r.update(max_abs_err=err, bound_ms=b, bound_by=by,
                     ms=timer.ms(lambda: ops.ragged_paged_attention(
                         qa, kp, vp, *tabs)),
                     plain_ms=timer.ms(lambda: ops.ragged_attention_reference(
                         qa, kp, vp, *tabs)),
                     library_ms=None, live_kv_bytes=live,
                     qk_pairs=pairs,
                     decode_only_ms=timer.ms(
                         lambda: ops.ragged_paged_attention(qa, kp, vp,
                                                            *dec)),
                     decode_only_bound_ms=bound(nbytes(qa, o, *tabs)
                                                + dec_live)[0])
        check_megakernels(timer, mb, cos, sin, rows, dtype, tol[dtype], gc)
        check_paged(timer, rows, dtype, gc, *decode_batch(
            g, SLOTS, MAX_CTX // PSZ, [300, 1024, 517, 1], idle=3))
    check_paged(timer, rows, torch.bfloat16, gc, *long_context_batch(g),
                tag="long")
    check_flash(timer, rows)
    return rows


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


def paged_batch(gc, dtype, P, lens, tables):
    """(q, k_pages, v_pages, lengths, tables) of one paged decode batch
    at the 8B heads, drawn from `gc`."""
    B = lens.shape[0]

    def rnd(*shape):
        return torch.randn(*shape, device=DEV, generator=gc).to(dtype)

    return rnd(B, HQ, D), rnd(KV, P, PSZ, D), rnd(KV, P, PSZ, D), lens, \
        tables


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

    def record(name, err, **timed):
        r = rows.setdefault(name, {})
        r[f"max_abs_err_{tag}"] = err
        if main:
            r.update(max_abs_err=err, library_ms=None, **timed)

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
    err = max(max_err(a, b) for a, b in zip((q, okp, ovp), ref))
    if main:
        wq, wk, wv = (w[:, :HQ * D].contiguous(),
                      w[:, HQ * D:(HQ + KV) * D].contiguous(),
                      w[:, (HQ + KV) * D:].contiguous())
        b_, by = bound(nbytes(h, w, cos, sin, *idx, q)
                       + 2 * T * KV * D * isz, 2 * T * H * N, dtype)
        timed = dict(
            bound_ms=b_, bound_by=by,
            ms=timer.ms(lambda: ops.fused_qkv_rope_append(
                h, w, None, None, cos, sin, kp, vp, *idx, **kw)),
            plain_ms=timer.ms(lambda: ops.qkv_rope_append_reference(
                h, w, None, None, cos, sin, kp2, vp2, *idx, **kw)),
            split_ms=timer.ms(lambda: ops.fused_rope_append(
                (h @ wq).view(T, HQ, D), (h @ wk).view(T, KV, D),
                (h @ wv).view(T, KV, D), cos, sin, kp2, vp2, *idx)))
    record("fused_qkv_rope_append", err, **(timed if main else {}))

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
    err = max(max_err(a, b) for a, b in zip(got, ref))
    if main:
        b_, by = bound(nbytes(o, x, wo, nw) + 2 * nbytes(x),
                       2 * T * HQ * D * H, dtype)
        timed = dict(
            bound_ms=b_, bound_by=by,
            ms=timer.ms(lambda: ops.fused_oproj_norm(
                o, x, wo, None, None, nw, eps=1e-5)),
            plain_ms=timer.ms(lambda: ops.oproj_norm_reference(
                o, x, wo, None, None, nw, eps=1e-5)),
            split_ms=timer.ms(lambda: ops.fused_rms_norm(x + o @ wo, nw,
                                                         1e-5)))
    record("fused_oproj_norm", err, **(timed if main else {}))

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
    err = max_err(got, ref)
    if main:
        silu = torch.nn.functional.silu
        b_, by = bound(nbytes(hh, x, wg, wu, wd) + nbytes(x),
                       3 * 2 * T * H * FFN, dtype)
        timed = dict(
            bound_ms=b_, bound_by=by,
            ms=timer.ms(lambda: ops.fused_ffn(hh, x, wg, None, wu, None, wd,
                                              None)),
            plain_ms=timer.ms(lambda: ops.megadecode_ffn_reference(
                hh, x, wg, None, wu, None, wd, None)),
            split_ms=timer.ms(lambda: x + (silu(hh @ wg) * (hh @ wu)) @ wd))
    record("fused_ffn", err, **(timed if main else {}))


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
NO_TRAINING = {"flash_sdpa": (0, 0), "flash_sdpa_bwd": (0, 0)}
NO_PAGED = {"paged_decode_attention": (0, 0),
            "paged_decode_attention_v2": (0, 0)}
FUSED_PER_STEP = {"fused_rms_norm": (1, 1), "fused_qkv_rope_append": (1, 0),
                  "ragged_paged_attention": (1, 0),
                  "fused_oproj_norm": (1, 0), "fused_ffn": (1, 0),
                  "fused_rope_append": (0, 0), **NO_TRAINING, **NO_PAGED}
SPLIT_PER_STEP = {"fused_rms_norm": (2, 1), "fused_rope_append": (1, 0),
                  "ragged_paged_attention": (1, 0),
                  "fused_qkv_rope_append": (0, 0),
                  "fused_oproj_norm": (0, 0), "fused_ffn": (0, 0),
                  **NO_TRAINING, **NO_PAGED}
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


def expect_alternating(impl, layers, prefill, decode):
    """Every kernel's launches in an alternating-path run: 2 * layers + 1
    rms_norm a launch, `layers` of the impl's paged kernel a decode
    launch, nothing else."""
    want = {name: 0 for name in ops.launch_counts()}
    want["fused_rms_norm"] = (2 * layers + 1) * (prefill + decode)
    want[ALTERNATING[impl][0]] = layers * decode
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


def serve_8b(model, chain: str, counts_out: dict, impl: str = "intree"):
    """Serve the seeded 8B trace through one chain of ServingEngine's
    unified step ("fused", "split") or through the alternating path
    ("alternating", ragged=False, with FLAGS_paged_impl `impl` pinned:
    the v2 paged kernel under "intree", v1 under "intree_v1"); every
    kernel's launches must be that path's per launch, with no
    plain-version call (and, alternating, no other paged route)."""
    cfg = model.config
    layers = cfg.num_hidden_layers
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    alt = chain == "alternating"
    kw = {"split": SPLIT, "alternating": dict(ragged=False)}.get(chain, {})
    with flags_guard(paged_impl=impl):
        eng = ServingEngine(model, max_slots=SLOTS, page_size=PSZ,
                            prefill_chunk=CHUNK, max_context=MAX_CTX,
                            device=DEV, **kw)
    assert eng.megafront == eng.megadecode == (chain == "fused")
    assert eng.ragged == (not alt)
    assert eng.paged_impl == (impl if alt else None)
    pool_bytes = sum(nbytes(k, v) for k, v in eng._pools)
    slab_bytes = sum(nbytes(L["wqkv"]) for L in eng._p["layers"]
                     if "wqkv" in L)
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

    def on_step(e, handles):
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
        expect = expect_alternating(impl, layers, pre, dec)
        assert paged_routes.route_counts == dict(
            {k: 0 for k in paged_routes.route_counts},
            **{"paged_" + impl: layers * dec}), paged_routes.route_counts
        per_launch = {"decode": {ALTERNATING[impl][0]: layers,
                                 "fused_rms_norm": 2 * layers + 1},
                      "prefill": {"fused_rms_norm": 2 * layers + 1}}
    else:
        per_step = FUSED_PER_STEP if chain == "fused" else SPLIT_PER_STEP
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
        "chain": chain, "layers": layers,
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
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches_per_step" if not alt else "launches_per_launch":
            per_launch,
    }
    if alt:
        res.update(paged_impl=impl, prefill_launches=pre,
                   decode_launches=dec,
                   prefill_chunk_ms_median=statistics.median(
                       launch_ms["prefill"]),
                   decode_launch_ms_median=statistics.median(
                       launch_ms["decode"]))
    return out, res


def generate_cached_8b(model):
    """generate_cached at Llama-3-8B: GEN_BATCH seeded prompts of
    GEN_PROMPT tokens, GEN_NEW greedy new tokens. Every call of the cached
    step is timed alone (a synchronize on both sides); the prefill must
    run the flash kernel once a layer and nothing else may launch."""
    cfg = model.config
    L = cfg.num_hidden_layers
    g = torch.Generator(DEV).manual_seed(3)
    ids = torch.randint(0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT),
                        device=DEV, generator=g)
    kw = dict(decode_strategy="greedy_search")
    generation.generate_cached(model, ids[:, :64], max_new_tokens=2, **kw)
    calls = []
    make = generation._make_cached_step

    def timed_make(p, max_len):
        call = make(p, max_len)

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
    for name, c in counts.items():
        want = L if name == "flash_sdpa" else 0
        assert c == {"launches": want, "plain_calls": 0}, (name, c)
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
            "flash_launches": counts["flash_sdpa"]["launches"]}


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
}


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

    emit("3 tiny engine and generation cpu vs card", **tiny_engine_parity())

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
    fused_out, res = serve_8b(model, "fused", fused_launches)
    emit("4 llama3-8b serving, fused chain", card=card["nvidia_smi"],
         model_init_s=init_s, **res)
    torch.cuda.empty_cache()
    split_launches: dict = {}
    split_out, res = serve_8b(model, "split", split_launches)
    emit("5 llama3-8b serving, split chain", card=card["nvidia_smi"],
         identical_token_share_vs_fused=same_share(fused_out, split_out),
         **res)
    torch.cuda.empty_cache()
    alt_launches: dict = {}
    alt_out, res = serve_8b(model, "alternating", alt_launches)
    emit("6 llama3-8b serving, alternating path", card=card["nvidia_smi"],
         identical_token_share_vs_fused=same_share(fused_out, alt_out),
         **res)
    torch.cuda.empty_cache()
    v1_launches: dict = {}
    v1_out, res = serve_8b(model, "alternating", v1_launches, "intree_v1")
    emit("6 llama3-8b serving, alternating path, intree_v1",
         card=card["nvidia_smi"],
         identical_token_share_vs_fused=same_share(fused_out, v1_out),
         identical_token_share_vs_v2=same_share(alt_out, v1_out), **res)
    torch.cuda.empty_cache()
    emit("7 llama3-8b generate_cached", card=card["nvidia_smi"],
         **generate_cached_8b(model))
    del model
    gc.collect()
    torch.cuda.empty_cache()

    emit("8 tiny training cpu vs card", **tiny_train_parity())
    res, train_launches = train_8b(card)
    emit("9 llama3-8b-width pretraining, 4 of 32 layers", **res)

    kernels = []
    paths = (("fused", fused_launches), ("split", split_launches),
             ("alternating", alt_launches),
             ("alternating, intree_v1", v1_launches),
             ("train", train_launches))
    for name, (src, replaces) in SOURCES.items():
        r = rows[name]
        path, launches = next((p, c[name]) for p, c in paths if name in c)
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches, "path": path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "split_ms": r.get("split_ms")})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
