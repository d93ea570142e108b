#!/usr/bin/env python3
"""Run the PyTorch + CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, one line each on stdout:

1. card and build: the card's ``nvidia-smi`` name and power limit, the
   torch and CUDA versions; every kernel of ``paddle_tpu_torch/ops/csrc``
   is built from the checkout (one nvcc per source, in parallel);
2. kernels against their plain PyTorch versions at the Llama-3-8B
   serving shapes (H 4096, 32/8 heads x 128, page_size 16, T = 4 slots +
   a 128-token prefill chunk, a mixed batch with an idle slot and a -1
   table entry), in bf16 and f32, each timed with CUDA events (median of
   25 reps, L2 scrubbed before each) beside its plain version, its
   bound on the H100 and, for rms_norm, torch.nn.functional.rms_norm;
3. a tiny f32 Llama served on the CPU (plain versions) and on the card
   (kernels) over one seeded join/leave trace: identical greedy tokens;
4. Llama-3-8B at full width (32 layers, vocab 128256, bf16 weights drawn
   on the card from a seeded generator) serving 8 seeded requests
   (prompts 64-512 tokens, 32 new tokens each) through ServingEngine;
   every kernel's launch count must be the split chain's per step;
5. the ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

It imports neither JAX nor paddle_tpu. Any failure raises and exits
nonzero; without a CUDA device it exits nonzero before printing a result.
"""

from __future__ import annotations

import copy
import json
import statistics
import sys
import time

import numpy as np
import torch

from paddle_tpu_torch import card_report, ops
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           llama3_8b_config,
                                           llama_tiny_config,
                                           precompute_rope)
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.serving import ServingEngine

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
REPS = 25
SCRUB_BYTES = 1 << 30          # >> the 50 MB L2: each timed rep starts cold

#: the card every phase runs on (a CPU rehearsal of the script's logic
#: may point it elsewhere; the kernels themselves need the card)
DEV = "cuda"

# the slice's 8B serving geometry
H, HQ, KV, D, PSZ = 4096, 32, 8, 128, 16
SLOTS, CHUNK, MAX_CTX = 4, 128, 1024


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


def bound(bytes_: float, flops: float = 0.0):
    t_mem = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


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
            b, by = bound(nbytes(qa, o, *tabs) + live, 4 * HQ * D * pairs)
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
    return rows


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


def tiny_engine_parity():
    cfg = llama_tiny_config(num_hidden_layers=2)
    cpu_model = LlamaForCausalLM(cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model).to(DEV)
    reqs = trace(np.random.RandomState(1), cfg.vocab_size, 6, 2, 12, 2, 8, 4)
    kw = dict(max_slots=2, page_size=4, prefill_chunk=4)
    cpu_out, _, _ = drive(ServingEngine(cpu_model, device="cpu", **kw), reqs)
    n0 = ops.launch_counts()
    gpu_out, _, _ = drive(ServingEngine(gpu_model, device=DEV, **kw), reqs)
    n1 = ops.launch_counts()
    assert set(cpu_out) == set(gpu_out) == set(range(len(reqs)))
    for rid in cpu_out:
        np.testing.assert_array_equal(gpu_out[rid], cpu_out[rid])
    for name in n1:
        assert n1[name]["launches"] > n0[name]["launches"], name
    return {"requests": len(reqs),
            "tokens": int(sum(len(v) for v in cpu_out.values())),
            "identical": True}


def serve_8b(counts_out: dict):
    cfg = llama3_8b_config()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=DEV, dtype=torch.bfloat16,
                             generator=torch.Generator(DEV).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    eng = ServingEngine(model, max_slots=SLOTS, page_size=PSZ,
                        prefill_chunk=CHUNK, max_context=MAX_CTX, device=DEV)
    pool_bytes = sum(nbytes(k, v) for k, v in eng._pools)
    rng = np.random.RandomState(0)
    # warm-up (cuBLAS handles, allocator): one short request, then the
    # counts start at 0 for the measured run
    drive(eng, [(rng.randint(0, cfg.vocab_size, 64).astype(np.int32), 2, 0)])
    reqs = trace(rng, cfg.vocab_size, 8, 64, 512, 32, 32, 1)
    reqs = [(p, 32, i // 2) for i, (p, _, _) in enumerate(reqs)]
    first_tok, finite = {}, []

    def on_step(e, handles):
        finite.append(bool(torch.isfinite(e.last_logits).all()))
        now = time.perf_counter()
        for rid, (req, t_sub) in handles.items():
            if rid not in first_tok and req.tokens:
                first_tok[rid] = (now - t_sub) * 1e3

    ops.reset_counts()
    steps0 = eng.launches
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, handles, steps = drive(eng, reqs, on_step)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    n_steps = eng.launches - steps0
    layers = cfg.num_hidden_layers
    assert len(out) == len(reqs)
    for rid, toks in out.items():
        assert isinstance(toks, np.ndarray) and toks.shape == (32,), rid
        assert len(handles[rid][0].tokens) == 32
    assert all(finite) and len(finite) == len(steps)
    expect = {"fused_rms_norm": (2 * layers + 1) * n_steps,
              "fused_rope_append": layers * n_steps,
              "ragged_paged_attention": layers * n_steps}
    for name, n in expect.items():
        assert counts[name]["launches"] == n, (name, counts[name], n)
        assert counts[name]["plain_calls"] == 0, name
    counts_out.update({k: v["launches"] for k, v in counts.items()})
    decode_ms = [ms for ms, o in steps
                 if o["prefill_tokens"] == 0 and o["decoded"] > 0]
    mixed_ms = [ms for ms, o in steps if o["prefill_tokens"] > 0]
    gen = sum(len(h[0].tokens) for h in handles.values())
    ttft = sorted(first_tok.values())
    return {
        "requests": len(reqs), "steps": n_steps, "generated_tokens": gen,
        "prompt_tokens": int(sum(p.size for p, _, _ in reqs)),
        "wall_s": wall, "tokens_per_s": gen / wall,
        "ttft_ms_p50": statistics.median(ttft), "ttft_ms_max": ttft[-1],
        "decode_step_ms_median": statistics.median(decode_ms),
        "decode_steps": len(decode_ms),
        "mixed_step_ms_median": statistics.median(mixed_ms),
        "weight_bytes": weight_bytes, "page_pool_bytes": pool_bytes,
        "decode_step_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "model_init_s": init_s, "launches_per_step": {
            k: v // n_steps for k, v in expect.items()},
    }


SOURCES = {
    "fused_rms_norm": ("paddle_tpu_torch/ops/csrc/fused.cu",
                       "paddle_tpu/ops/fused.py:100"),
    "fused_rope_append": ("paddle_tpu_torch/ops/csrc/fused.cu",
                          "paddle_tpu/ops/fused.py:396"),
    "ragged_paged_attention": ("paddle_tpu_torch/ops/csrc/"
                               "ragged_attention.cu",
                               "paddle_tpu/ops/pallas_ragged.py:139"),
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
         ptxas=regs)

    rows = check_kernels(Timer())
    emit("2 kernels", card=card["nvidia_smi"], kernels=rows)

    emit("3 tiny engine cpu vs card", **tiny_engine_parity())

    launches: dict = {}
    emit("4 llama3-8b serving", card=card["nvidia_smi"],
         **serve_8b(launches))

    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
