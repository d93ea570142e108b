"""Continuous-batching serving engine over the paged KV cache
(counterpart of paddle_tpu/serving/engine.py: the llama family, with
Qwen2's q/k/v biases, the gpt family and the MoE family).

Two dispatch paths, as in the JAX engine:

- **unified (the default, ``ragged=None`` or True)**: ONE step per engine
  step carries every decode slot's pending token and one chunk of the
  oldest prefilling request in a single flat token buffer through the
  per-layer body, around ``ragged_paged_attention``;
- **alternating (``ragged=False``)**: each engine step runs a
  prefill-chunk launch for the oldest prefilling request, then a
  decode-step launch for every decode slot (`_prefill_chunk`, `_decode`;
  ``self.launches`` counts both). Per layer the decode body runs
  ``fused_rms_norm``, the q/k/v matmuls, rope inline by concatenation in
  the activation dtype, ``append_to_cache`` and ``paged_attention``
  (``FLAGS_paged_impl``, pinned when the engine is built: the v2 paged
  kernel by default, the per-page v1 kernel under "intree_v1"), the
  o-proj matmul, ``fused_rms_norm`` and the SwiGLU matmuls; the prefill
  body writes the chunk's K/V into the pools (pad positions to the trash
  page 0, offset 0) and attends densely over the sequence's gathered
  pages under a causal mask, with no kernel, as in JAX. Both take
  2 * layers + 1 ``fused_rms_norm`` calls a launch. The fused chain
  (``megafront`` / ``megadecode``) belongs to the unified step and
  resolves to off here, as in JAX. "Alternating path" names
  ``ragged=False``; "split chain" names the unified step without the
  megakernels.

On the unified step, by default (``megafront`` and ``megadecode`` on, as in
the JAX engine) that body is the fused chain

    fused_rms_norm -> fused_qkv_rope_append -> ragged_paged_attention
    -> fused_oproj_norm -> fused_ffn

five kernel-wrapper calls per layer and no matmul inside a layer, plus
a final fused_rms_norm before the LM head (layers + 1 rms_norm and
layers each of the other four per step). The gpt family runs the same
chain with ``fused_layer_norm`` in place of ``fused_rms_norm``, the
layer-norm site of ``fused_oproj_norm`` (with the o-proj bias) and the
gelu site of ``fused_ffn`` (with b1 and b2); it has no rope, so its
qkv kernels take identity trig (cos ones, sin zeros), and its split
chain is ``fused_layer_norm`` -> the fused qkv matmul + bias ->
``fused_rope_append`` -> attention -> o-proj + bias + residual ->
``fused_layer_norm`` -> the GELU MLP (2 * layers + 1 layer norms a
step), its alternating path the same with ``append_to_cache`` and
``paged_attention``. ``megafront=False`` and
``megadecode=False`` keep the split chain

    fused_rms_norm -> q/k/v matmuls -> fused_rope_append
    -> ragged_paged_attention -> o-proj matmul + residual
    -> fused_rms_norm -> SwiGLU FFN matmuls + residual

with the projections and the FFN left to ``torch.matmul``, as the JAX
package leaves them to XLA on that chain. The fused front half reads one
concatenated [H, (Hq + 2 KV) * D] qkv slab per layer, built at init (a
copy beside the model's own q/k/v weights). Requests join mid-decode
(chunked prefill) and leave the instant they hit EOS/max-tokens; their
pages return to the pool immediately.

Per-sequence row tables (seq_start / num_tokens / kv_lengths / page
tables) make joins and leaves pure data changes. Inactive slots point
their whole page table at the allocator's trash page 0 with
length/num_tokens 0: they write their (garbage) K/V into the trash page
and their logits are ignored on the host.

The page pools are persistent device tensors, one (K, V) pair per layer.
``fused_qkv_rope_append`` (or ``fused_rope_append``) writes each step's
K/V rows into them IN PLACE (the JAX kernels aliased them through
input_output_aliases and returned new arrays), and copy-on-write page
copies are in-place page copies.

PyTorch runs eagerly: the body is a plain Python function over tensors,
built once per engine (CUDA graphs are ROADMAP.md queue A item 6).

Weight-only quantized serving (``weight_only_int8=True``, or
``weight_only_quant="int8"`` / ``"int4"``) takes the JAX package's
deploy layouts (``generation._llama_decode_params``) on every path: the
megakernels read the int8 / packed-int4 slabs and their scales, the
split chain's and the alternating path's int4 products go through
``ops.quant.weight_only_linear`` and their int8 products through
``h @ (q * s)`` (``generation._mm_w``), and so does a quantized LM head.

The MoE family (``MoEForCausalLM``, the tree of
``generation._moe_decode_params``) runs the llama bodies: its dense
first layers as llama's, its routed layers through
``generation._ffn_apply`` on every path (on the fused chain after
``fused_oproj_norm``, as the JAX body does: routing is data-dependent,
so no fused FFN kernel covers it). A step of more than 32 token rows
routes dropless through three grouped GEMMs a routed layer (the ``gmm``
kernel on the card), a smaller one runs every expert on every token.

Greedy decoding only: engine tokens equal the JAX engine's tokens per
request on the same weights and trace, on either chain and on the
alternating path, in the fp, int8 and int4 layouts, and the solo
``generate_cached`` tokens of each request
(tests/test_torch_llama_serving.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resilience as _res
from ..device import DeviceLike, resolve_device
from ..flags import flag
from ..generation import _SUFFIX, _decode_params, _ffn_apply, _head, \
    _kv_geometry, _llama_weights, _mm_w, _walgo, _wq2
from ..nn.functional import gelu
from ..ops.fused import fused_layer_norm, fused_rms_norm, fused_rope_append
from ..ops.megadecode import (fused_ffn, fused_oproj_norm,
                              megadecode_eligible)
from ..ops.megafront import fused_qkv_rope_append, megafront_eligible
from ..ops.paged_attention import append_to_cache, paged_attention
from ..ops.ragged import ragged_paged_attention
from .block_allocator import PageBlockAllocator
from .scheduler import DECODE, PREFILL, Request, Scheduler

__all__ = ["ServingEngine"]


def _lcp(a: np.ndarray, b: np.ndarray) -> int:
    n = min(a.size, b.size)
    if n == 0:
        return 0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if neq.size else n


def _split_qkv(qkv):
    """q, k, v of a fused qkv product [..., 3 H], each contiguous (the
    kernels take contiguous tensors; chunks of the last axis are not)."""
    return tuple(t.contiguous() for t in qkv.chunk(3, dim=-1))


def _unported(feature: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported yet (ROADMAP.md queue A item {item})")


class ServingEngine:
    """Continuous-batching engine for the llama family (Qwen2 included),
    the gpt family and the MoE family.

    Typical loop::

        eng = ServingEngine(model, max_slots=4, page_size=16)
        eng.add_request(prompt_ids, max_new_tokens=32, eos_token_id=2)
        while eng.has_work():
            eng.step()
        results = eng.collect()   # {request_id: np.int32[max_new]}

    ``device=None`` resolves to ``"cuda"`` and raises when CUDA is
    absent; the model must live on the engine's device. ``ragged=False``
    takes the alternating path (module docstring). The defaults
    are the features this port has: the unified ragged step on the
    fused chain (``megafront`` / ``megadecode`` None: on wherever the
    kernels take the model's geometry, ``megafront_eligible`` /
    ``megadecode_eligible``; False keeps the split chain), live-donor
    prefix sharing, no radix prefix cache, no preemption, no
    speculative decoding. Asking for one of the unported features
    raises NotImplementedError naming its ROADMAP item.

    ``config`` is duck-typed like the JAX package's inference.Config:
    ``_admission = (max_inflight, queue_timeout_s)`` bounds in-flight
    requests (Overloaded backpressure), ``_deadline_s`` sets the default
    per-request budget (falsy TimeoutResult partials).
    """

    def __init__(self, model, max_slots: int = 4, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 max_context: Optional[int] = None,
                 prefill_chunk: int = 32,
                 weight_only_int8: bool = False,
                 weight_only_quant=None,
                 config=None,
                 prefix_sharing: bool = True,
                 ragged: Optional[bool] = None,
                 enable_prefix_cache: bool = False,
                 spec_decode: int = 0,
                 preemption: bool = False,
                 tenant_budgets: Optional[dict] = None,
                 megadecode: Optional[bool] = None,
                 megafront: Optional[bool] = None,
                 role: str = "colocated",
                 slo_targets=None,
                 device: DeviceLike = None):
        if role not in ("prefill", "decode", "colocated"):
            raise ValueError(
                f"role must be prefill/decode/colocated, got {role!r}")
        if enable_prefix_cache or getattr(config, "_prefix_cache", None):
            raise _unported("the radix prefix cache", 6)
        if spec_decode < 0:
            raise ValueError("spec_decode must be >= 0")
        if spec_decode:
            raise _unported("speculative decoding", 6)
        if preemption:
            raise _unported("priority preemption", 6)
        if role != "colocated":
            raise _unported(f"the {role} replica role", 6)
        if slo_targets is not None:
            raise _unported("the SLO autopilot (slo_targets)", 6)
        self.device = resolve_device(device)
        p = _decode_params(model, weight_only_int8, weight_only_quant)
        if p["embed"].device != self.device:
            raise ValueError(
                f"model parameters live on {p['embed'].device}, the engine "
                f"on {self.device}: move the model with model.to(...)")
        cfg = p["cfg"]
        self._p = p
        self._w = _llama_weights(p)
        self._family = p["family"]
        gpt = self._family == "gpt"
        self.max_slots = int(max_slots)
        self.page_size = int(page_size)
        self.max_context = int(max_context or cfg.max_position_embeddings)
        if self.max_context > cfg.max_position_embeddings:
            raise ValueError(
                f"max_context {self.max_context} exceeds "
                f"max_position_embeddings {cfg.max_position_embeddings}")
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.pages_per_seq = -(-self.max_context // self.page_size)
        if num_pages is None:
            num_pages = self.max_slots * self.pages_per_seq + 1
        self.num_pages = int(num_pages)
        self.prefix_sharing = bool(prefix_sharing)
        self.allocator = PageBlockAllocator(
            self.num_pages, self.page_size, self.pages_per_seq)
        admission = getattr(config, "_admission", None)
        self._default_deadline_s = getattr(config, "_deadline_s", None)
        self.scheduler = Scheduler(
            self.max_slots,
            max_inflight=admission[0] if admission else None,
            queue_timeout_s=admission[1] if admission else 0.0,
            tenant_budgets=tenant_budgets)
        self._prefill_fifo: List[Request] = []

        # device page pools, one (K, V) pair per layer, updated in place
        dt = p["embed"].dtype
        kv, d = _kv_geometry(p)
        shape = (kv, self.num_pages, self.page_size, d)
        self._pools = [(torch.zeros(shape, dtype=dt, device=self.device),
                        torch.zeros(shape, dtype=dt, device=self.device))
                       for _ in p["layers"]]
        # the dispatch path: the unified step unless ragged=False (the
        # port has no ragged gate that can fail)
        self.ragged = ragged is None or bool(ragged)
        # the fused halves, on by default where the kernels take the
        # geometry (the gates are pure functions of shapes); False keeps
        # the split chain exactly; the alternating path never fuses
        hq, isz = cfg.num_attention_heads, p["embed"].element_size()
        self.megadecode = bool(
            (megadecode is None or megadecode) and self.ragged
            and megadecode_eligible(cfg.hidden_size, cfg.intermediate_size,
                                    hq * d, dtype_bytes=isz,
                                    device=self.device))
        #: kernel-wrapper calls after attention, per layer per step
        #: (2 fused vs the 6-stage split chain, as the JAX engine counts)
        self.back_half_launches = 2 if self.megadecode else 6
        self.megafront = bool(
            (megafront is None or megafront) and self.ragged
            and megafront_eligible(cfg.hidden_size, (hq + 2 * kv) * d, d,
                                   dtype_bytes=isz, device=self.device))
        if self.megafront:
            self._concat_qkv_weights()
        #: kernel-wrapper calls before attention, per layer per step
        #: (norm + fused, vs norm + the q/k/v matmuls (gpt: one fused
        #: qkv matmul) + rope_append)
        self.front_half_launches = 2 if self.megafront else (
            3 if gpt else 5)
        #: FLAGS_paged_impl of the alternating path, pinned now as the JAX
        #: engine pins it when it builds its programs (None: unified step)
        self.paged_impl = None if self.ragged else flag("FLAGS_paged_impl")
        if self.ragged:
            self._body = (self._gpt_unified_body if gpt
                          else self._llama_unified_body)()
        else:
            self._decode_body = (self._gpt_decode_body if gpt
                                 else self._llama_decode_body)()
            self._prefill_body = (self._gpt_prefill_body if gpt
                                  else self._llama_prefill_body)()
        #: device launches run by THIS engine: unified steps, or prefill
        #: chunks plus decode steps on the alternating path
        self.launches = 0
        #: logits of the last launch: [max_slots + 1, vocab] of a unified
        #: step (row s for decode slot s, the last row for the prefill
        #: chunk), [max_slots, vocab] of a decode step or [1, vocab] of a
        #: prefill chunk; idle rows hold garbage the host ignores
        self.last_logits: Optional[torch.Tensor] = None

    # ------------------------------------------------------------- public
    def add_request(self, prompt, max_new_tokens: int = 20,
                    eos_token_id: Optional[int] = None,
                    pad_token_id: int = 0,
                    deadline_s: Optional[float] = None,
                    request_id=None,
                    priority: int = 0,
                    tenant: Optional[str] = None) -> Request:
        """Enqueue a request (FCFS within its priority class). Raises
        resilience.Overloaded when admission backpressure refuses it at
        the door."""
        req = Request(prompt, max_new_tokens, eos_token_id=eos_token_id,
                      pad_token_id=pad_token_id,
                      deadline_s=(deadline_s if deadline_s is not None
                                  else self._default_deadline_s),
                      request_id=request_id,
                      priority=priority, tenant=tenant)
        if req.total_tokens > self.max_context:
            raise ValueError(
                f"prompt+max_new_tokens = {req.total_tokens} exceeds "
                f"max_context {self.max_context}")
        self.scheduler.submit(req)
        return req

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def step(self) -> Dict[str, int]:
        """One engine iteration: cull expired requests, admit waiting
        ones into free slots, then run the step's device work: ONE
        unified ragged step carrying every decode slot's token plus one
        prefill chunk, or on the alternating path a prefill-chunk launch
        then a decode-step launch. Returns counts of the step's work."""
        out = {"admitted": 0, "prefill_tokens": 0, "decoded": 0,
               "finished": 0}
        # queued requests own no pages yet: expiring them frees nothing
        out["finished"] += len(self.scheduler.expire_waiting())
        # deadline sweep over in-flight requests: partial result, pages
        # freed immediately
        for _, req in list(self.scheduler.active()):
            if req.deadline_expired():
                self._finish(req)
                out["finished"] += 1
        out["admitted"] = self._admit()
        if self.ragged:
            pf, dec, fin = self._unified_step()
            out["prefill_tokens"] = pf
            out["decoded"] = dec
            out["finished"] += fin
        else:
            out["prefill_tokens"], fin = self._prefill_chunk()
            out["finished"] += fin
            out["decoded"], fin = self._decode()
            out["finished"] += fin
        return out

    def collect(self) -> Dict[object, object]:
        """Results of every request finished since the last collect():
        {request_id: np.int32[max_new_tokens] | TimeoutResult |
        Overloaded}."""
        return {r.request_id: r.result
                for r in self.scheduler.drain_finished()}

    def run_to_completion(self) -> Dict[object, object]:
        """Step until idle; collect everything."""
        results: Dict[object, object] = {}
        while self.has_work():
            self.step()
            results.update(self.collect())
        results.update(self.collect())
        return results

    # ---------------------------------------------------------- admission
    def _admit(self) -> int:
        admitted = 0
        while True:
            req = self.scheduler.next_admittable()
            if req is None:
                break
            if not self._reserve_pages(req):
                break   # head-of-class waits for pages; no skip
            self.scheduler.admit(req)
            self._prefill_fifo.append(req)
            admitted += 1
        return admitted

    def _reserve_pages(self, req: Request) -> bool:
        """Reserve the request's pages, sharing the longest prefix of a
        live donor's prefilled prompt (token-granular fork). Returns
        False, with nothing reserved, when the pool cannot hold it."""
        share, donor = 0, None
        if self.prefix_sharing:
            for _, cand in self.scheduler.active():
                # only the donor's PREFILLED prompt tokens are reusable;
                # cap at len(prompt)-1 so the last prompt token is always
                # re-run for this request's logits
                s = min(_lcp(req.prompt, cand.prompt),
                        cand.prefill_pos, int(req.prompt.size) - 1)
                if s > share:
                    share, donor = s, cand
        try:
            if share > 0:
                self.allocator.fork(donor.request_id, req.request_id,
                                    share, req.total_tokens)
            else:
                self.allocator.allocate(req.request_id, req.total_tokens)
        except _res.Overloaded:
            return False
        req.prefill_pos = req.shared_tokens = share
        return True

    # -------------------------------------------------------- alternating
    def _prefill_chunk(self) -> Tuple[int, int]:
        """One chunk of prompt prefill for the OLDEST prefilling request
        (one launch): bounded work between decode steps, so long prompts
        never stall the in-flight batch. Returns (prefill_tokens,
        finished)."""
        while self._prefill_fifo and \
                self._prefill_fifo[0].state != PREFILL:
            self._prefill_fifo.pop(0)
        if not self._prefill_fifo:
            return 0, 0
        req = self._prefill_fifo[0]
        C = self.prefill_chunk
        n = min(C, int(req.prompt.size) - req.prefill_pos)
        start = req.prefill_pos
        self._apply_copies(self.allocator.extend(req.request_id, n))
        ids = np.zeros(C, np.int32)
        ids[:n] = req.prompt[start:start + n]
        table = self.allocator.table(req.request_id)
        # one host->device copy for the launch's ids and page table
        dev = torch.from_numpy(np.concatenate([ids, table])).to(self.device)
        ids_d, table_d = torch.split(dev, [C, table.size])
        logits, self._pools = self._prefill_body(
            self._w, ids_d[None], self._pools, table_d[None], start, n)
        self.last_logits = logits
        tok = int(torch.argmax(logits[0]))
        req.prefill_pos += n
        self.launches += 1
        finished = 0
        if req.prefill_pos == int(req.prompt.size):
            self._prefill_fifo.pop(0)
            req.state = DECODE
            finished += self._emit(req, tok)
        return n, finished

    def _decode(self) -> Tuple[int, int]:
        """One decode step (one launch) for every decode slot; idle slots
        run on the trash page with length 0. Returns (decoded,
        finished)."""
        active = self.scheduler.active(DECODE)
        if not active:
            return 0, 0
        B, nj = self.max_slots, self.pages_per_seq
        tok = np.zeros(B, np.int32)
        lengths = np.zeros(B, np.int32)
        tables = np.zeros((B, nj), np.int32)   # idle -> trash page 0
        for slot, req in active:
            tok[slot] = req.pending
            lengths[slot] = self.allocator.seq_length(req.request_id)
            self._apply_copies(self.allocator.extend(req.request_id, 1))
            tables[slot] = self.allocator.table(req.request_id)
        dev = torch.from_numpy(np.concatenate(
            [tok, lengths, tables.reshape(-1)])).to(self.device)
        tok_d, lengths_d, tables_d = torch.split(dev, [B, B, B * nj])
        logits, self._pools = self._decode_body(
            self._w, tok_d, self._pools, lengths_d, tables_d.view(B, nj))
        self.last_logits = logits
        greedy = torch.argmax(logits, dim=-1).cpu().numpy()   # [B]
        self.launches += 1
        finished = 0
        for slot, req in active:
            finished += self._emit(req, int(greedy[slot]))
        return len(active), finished

    # ------------------------------------------------------------ unified
    def _unified_step(self) -> Tuple[int, int, int]:
        """ONE ragged step: decode slot `s` owns flat row s and the
        oldest prefilling request's chunk rides rows
        [max_slots, max_slots + n). Row tables tell the ragged kernel who
        owns which rows; idle rows write to the trash page and emit
        garbage logits the host never reads. Returns (prefill_tokens,
        decoded, finished).

        A request that completes its prefill emits its first token from
        THIS step and takes its first decode step in the NEXT one."""
        while self._prefill_fifo and \
                self._prefill_fifo[0].state != PREFILL:
            self._prefill_fifo.pop(0)
        preq = self._prefill_fifo[0] if self._prefill_fifo else None
        active = self.scheduler.active(DECODE)
        if preq is None and not active:
            return 0, 0, 0
        B, C = self.max_slots, self.prefill_chunk
        T, S = B + C, B + 1
        ps, nj = self.page_size, self.pages_per_seq
        tok = np.zeros(T, np.int32)
        positions = np.zeros(T, np.int32)
        num_tokens = np.zeros(S, np.int32)
        kv_lengths = np.zeros(S, np.int32)
        tables = np.zeros((S, nj), np.int32)   # idle -> trash page 0
        tok_page = np.zeros(T, np.int32)
        tok_off = np.zeros(T, np.int32)
        for slot, req in active:
            ln = self.allocator.seq_length(req.request_id)
            self._apply_copies(self.allocator.extend(req.request_id, 1))
            tbl = self.allocator.table(req.request_id)
            tok[slot] = req.pending
            positions[slot] = ln
            num_tokens[slot] = 1
            kv_lengths[slot] = ln + 1
            tables[slot] = tbl
            tok_page[slot] = tbl[ln // ps]
            tok_off[slot] = ln % ps
        n, start = 0, 0
        if preq is not None:
            start = preq.prefill_pos
            n = min(C, int(preq.prompt.size) - start)
            self._apply_copies(self.allocator.extend(preq.request_id, n))
            tbl = self.allocator.table(preq.request_id)
            rows = np.arange(n)
            tok[B:B + n] = preq.prompt[start:start + n]
            positions[B:B + n] = start + rows
            num_tokens[S - 1] = n
            kv_lengths[S - 1] = start + n
            tables[S - 1] = tbl
            tok_page[B:B + n] = tbl[(start + rows) // ps]
            tok_off[B:B + n] = (start + rows) % ps
        # one host->device copy for every row table of the step
        host = np.concatenate([tok, positions, num_tokens, kv_lengths,
                               tables.reshape(-1), tok_page, tok_off])
        dev = torch.from_numpy(host).to(self.device)
        tok_d, positions_d, num_tokens_d, kv_lengths_d, tables_d, \
            tok_page_d, tok_off_d = torch.split(
                dev, [T, T, S, S, S * nj, T, T])
        logits, self._pools = self._body(
            self._w, tok_d, self._pools, positions_d, num_tokens_d,
            kv_lengths_d, tables_d.view(S, nj), tok_page_d, tok_off_d)
        self.last_logits = logits
        greedy = torch.argmax(logits, dim=-1).cpu().numpy()   # [S]
        self.launches += 1
        finished = 0
        if preq is not None:
            preq.prefill_pos += n
            if preq.prefill_pos == int(preq.prompt.size):
                self._prefill_fifo.pop(0)
                preq.state = DECODE
                finished += self._emit(preq, int(greedy[S - 1]))
        decoded = 0
        for slot, req in active:
            finished += self._emit(req, int(greedy[slot]))
            decoded += 1
        return n, decoded, finished

    def _emit(self, req: Request, tok: int) -> int:
        """Record one sampled token; finish on EOS/max-tokens (pages
        freed the same step), else stage it for the next decode step."""
        req.tokens.append(tok)
        done = (req.eos_token_id is not None and tok == req.eos_token_id) \
            or len(req.tokens) >= req.max_new_tokens
        if done:
            self._finish(req)
            return 1
        req.pending = tok
        return 0

    def _finish(self, req: Request) -> None:
        req.finalize()
        self.allocator.free(req.request_id)
        self.scheduler.release(req)

    def _apply_copies(self, copies) -> None:
        """Apply the allocator's copy-on-write page copies to the device
        pools, in place, before the write that triggered them."""
        if not copies:
            return
        src = torch.tensor([c[0] for c in copies], device=self.device)
        dst = torch.tensor([c[1] for c in copies], device=self.device)
        for kp, vp in self._pools:
            kp[:, dst] = kp[:, src]
            vp[:, dst] = vp[:, src]

    def _concat_qkv_weights(self) -> None:
        """The fused front half's layout: each layer's wq | wk | wv
        become ONE [H, (Hq + 2 KV) * D] slab (``wqkv``), the columns in
        q | k | v order (every output column depends only on its own
        weight column, so the math is the three products'; int4 packs
        along the contraction axis, so the concatenation is layout-safe
        there too), payloads and scales alike (``wqkv_q`` / ``wqkv_q4``
        and ``wqkv_s``), Qwen2's biases too (``bqkv``). The fp slab is a
        copy made once here; the model keeps its own q/k/v weights, so
        the engine holds both (1.61 GB more at Llama-3-8B in bf16). The
        consumed entries leave the engine's weight tree: a megafront
        engine never runs the split front. The gpt family ships ``wqkv``
        already."""
        if self._family == "gpt":
            return
        layers = []
        for L in self._p["layers"]:
            L = dict(L)
            suffix = _SUFFIX.get(_walgo(L, "wq"), "")
            L["wqkv" + suffix] = torch.cat(
                [L.pop(k + suffix) for k in ("wq", "wk", "wv")], dim=-1)
            if suffix:
                L["wqkv_s"] = torch.cat(
                    [L.pop(k + "_s") for k in ("wq", "wk", "wv")], dim=-1)
            if "bq" in L:
                L["bqkv"] = torch.cat(
                    [L.pop(k) for k in ("bq", "bk", "bv")], dim=-1)
            layers.append(L)
        self._p = dict(self._p, layers=layers)
        self._w = dict(self._w, layers=layers)

    def _moe_static(self) -> tuple:
        """Each layer's routing knobs (None for a dense layer)."""
        return self._p.get("moe_static") or (None,) * len(self._p["layers"])

    # ------------------------------------------------------ unified body
    def _llama_unified_body(self):
        """The per-step function over tensors (the JAX engine's jitted
        body). T = max_slots + prefill_chunk flat token rows, S =
        max_slots + 1 sequences with FIXED seq_start [0..B-1, B]: decode
        slot i owns row i; the prefill chunk owns rows B..B+n-1."""
        cfg = self._p["cfg"]
        Hh, KV, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        eps = cfg.rms_norm_eps
        mega, megafront = self.megadecode, self.megafront
        B, C = self.max_slots, self.prefill_chunk
        T = B + C
        seq_start = torch.arange(B + 1, dtype=torch.int32,
                                 device=self.device)
        sts = self._moe_static()

        def step(w, tok, pools, positions, num_tokens, kv_lengths,
                 tables, tok_page, tok_off):
            x = w["embed"][tok.long()][None]             # [1, T, H]
            c = w["cos"][positions.long()]               # [T, D/2] f32
            s = w["sin"][positions.long()]
            for L, (kp, vp), st in zip(w["layers"], pools, sts):
                h = fused_rms_norm(x, L["ln1"], eps)
                if megafront:
                    wp, ws = _wq2(L, "wqkv")
                    q, kp, vp = fused_qkv_rope_append(
                        h[0], wp, ws, L.get("bqkv"), c, s, kp, vp, tok_page,
                        tok_off, heads=Hh, kv_heads=KV, head_dim=D,
                        algo=_walgo(L, "wqkv"))
                else:
                    q, k, v = (_mm_w(h, L, "wq"), _mm_w(h, L, "wk"),
                               _mm_w(h, L, "wv"))
                    if "bq" in L:                # Qwen2 qkv biases
                        q, k, v = q + L["bq"], k + L["bk"], v + L["bv"]
                    q, kp, vp = fused_rope_append(
                        q.reshape(T, Hh, D), k.reshape(T, KV, D),
                        v.reshape(T, KV, D), c, s, kp, vp, tok_page,
                        tok_off)
                o = ragged_paged_attention(q, kp, vp, seq_start,
                                           num_tokens, kv_lengths, tables,
                                           scale=D ** -0.5)
                if mega:
                    wp, ws = _wq2(L, "wo")
                    xn, h2 = fused_oproj_norm(
                        o.reshape(T, Hh * D), x[0], wp, ws, None, L["ln2"],
                        None, eps=eps, algo=_walgo(L, "wo"))
                    if "moe" in L:         # routed: no fused FFN kernel
                        x = (xn + _ffn_apply(L, h2, st))[None]
                    else:
                        gp, gs = _wq2(L, "wg")
                        up, us = _wq2(L, "wu")
                        dp, ds = _wq2(L, "wd")
                        x = fused_ffn(h2, xn, gp, gs, up, us, dp, ds,
                                      algo=_walgo(L, "wg"))[None]
                else:
                    x = x + _mm_w(o.reshape(1, T, Hh * D), L, "wo")
                    h2 = fused_rms_norm(x, L["ln2"], eps)
                    x = x + _ffn_apply(L, h2, st)
            x = fused_rms_norm(x, w["norm"], eps)
            # each sequence's logits come from its LAST flat row; idle
            # slots (num_tokens 0) index garbage the host ignores
            last = x[0, (seq_start + num_tokens - 1).clamp(0, T - 1).long()]
            return _head(last, w), pools

        return step

    # ------------------------------------------------- alternating bodies
    def _llama_decode_body(self):
        """One decode token per slot, in the JAX body's op order: rms
        norms through ``fused_rms_norm`` (2 * layers + 1 calls), rope
        inline in the activation dtype, the new K/V written by
        ``append_to_cache``, attention through ``paged_attention`` over
        lengths + 1 rows under the engine's pinned FLAGS_paged_impl."""
        cfg = self._p["cfg"]
        Hh, KV, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        eps = cfg.rms_norm_eps
        paged_impl = self.paged_impl
        sts = self._moe_static()

        def step(w, tok, pools, lengths, tables):
            B = tok.shape[0]
            x = w["embed"][tok.long()][:, None]           # [B, 1, H]
            c = w["cos"][lengths.long()]                  # [B, D/2] f32
            s = w["sin"][lengths.long()]

            def rope(t):                                  # [B, 1, h, D]
                d2 = t.shape[-1] // 2
                t1, t2 = t[..., :d2], t[..., d2:]
                cc = c[:, None, None, :].to(t.dtype)
                ss = s[:, None, None, :].to(t.dtype)
                return torch.cat([t1 * cc - t2 * ss, t2 * cc + t1 * ss], -1)

            for L, (kp, vp), st in zip(w["layers"], pools, sts):
                h = fused_rms_norm(x, L["ln1"], eps)
                q, k, v = (_mm_w(h, L, "wq"), _mm_w(h, L, "wk"),
                           _mm_w(h, L, "wv"))
                if "bq" in L:                    # Qwen2 qkv biases
                    q, k, v = q + L["bq"], k + L["bk"], v + L["bv"]
                q = rope(q.reshape(B, 1, Hh, D))
                k = rope(k.reshape(B, 1, KV, D))
                v = v.reshape(B, 1, KV, D)
                append_to_cache(kp, vp, k[:, 0], v[:, 0], lengths, tables)
                o = paged_attention(q[:, 0], kp, vp, lengths + 1, tables,
                                    scale=D ** -0.5, impl=paged_impl)
                x = x + _mm_w(o.reshape(B, 1, Hh * D), L, "wo")
                h2 = fused_rms_norm(x, L["ln2"], eps)
                x = x + _ffn_apply(L, h2, st)
            x = fused_rms_norm(x, w["norm"], eps)
            return _head(x[:, -1], w), pools

        return step

    def _llama_prefill_body(self):
        """One prefill chunk of C = prefill_chunk rows (the first n_valid
        real) of one sequence, in the JAX body's op order: rms norms
        through ``fused_rms_norm``, rope inline, the chunk's K/V written
        into the pools in place (pad rows to the trash page 0, offset 0),
        then attention over the sequence's gathered nj * page_size keys
        with key t visible to row i iff t <= start + i (dense, f32
        softmax, no kernel, as in JAX)."""
        cfg = self._p["cfg"]
        Hh, KV, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        eps = cfg.rms_norm_eps
        rep = Hh // KV
        C = self.prefill_chunk
        ps, nj = self.page_size, self.pages_per_seq
        T = nj * ps
        dev = self.device
        rows = torch.arange(C, device=dev)
        pos_t = torch.arange(T, device=dev)
        sts = self._moe_static()

        def prefill(w, ids, pools, table, start: int, n_valid: int):
            x = w["embed"][ids.long()]                    # [1, C, H]
            pos = start + rows
            posc = pos.clamp(0, w["cos"].shape[0] - 1)
            c, s = w["cos"][posc], w["sin"][posc]         # [C, D/2] f32

            def rope(t):                                  # [1, C, h, D]
                d2 = t.shape[-1] // 2
                t1, t2 = t[..., :d2], t[..., d2:]
                cc = c[None, :, None, :].to(t.dtype)
                ss = s[None, :, None, :].to(t.dtype)
                return torch.cat([t1 * cc - t2 * ss, t2 * cc + t1 * ss], -1)

            valid = rows < n_valid
            tab = table[0].long()
            # pad rows write the trash page 0 at offset 0 (repeated
            # indices: which one a CUDA index_put_ keeps is unspecified,
            # harmless on the trash page); real rows this sequence's pages
            pg = torch.where(valid, tab[(pos // ps).clamp(0, nj - 1)], 0)
            off = torch.where(valid, pos % ps, 0)
            vis = pos_t[None, :] <= pos[:, None]          # [C, T]
            for L, (kp, vp), st in zip(w["layers"], pools, sts):
                h = fused_rms_norm(x, L["ln1"], eps)
                q, k, v = (_mm_w(h, L, "wq"), _mm_w(h, L, "wk"),
                           _mm_w(h, L, "wv"))
                if "bq" in L:                    # Qwen2 qkv biases
                    q, k, v = q + L["bq"], k + L["bk"], v + L["bv"]
                q = rope(q.reshape(1, C, Hh, D))
                k = rope(k.reshape(1, C, KV, D))
                v = v.reshape(1, C, KV, D)
                kp[:, pg, off] = k[0].transpose(0, 1)
                vp[:, pg, off] = v[0].transpose(0, 1)
                ks = kp[:, tab].reshape(KV, T, D)
                vs = vp[:, tab].reshape(KV, T, D)
                qg = q.reshape(1, C, KV, rep, D)
                scores = torch.einsum("bsgrd,gtd->bgrst", qg, ks) \
                    * (D ** -0.5)
                scores = torch.where(vis[None, None, None], scores.float(),
                                     torch.tensor(-1e30, device=dev))
                aw = torch.softmax(scores, dim=-1).to(vs.dtype)
                o = torch.einsum("bgrst,gtd->bsgrd", aw, vs).reshape(
                    1, C, Hh * D)
                x = x + _mm_w(o, L, "wo")
                h2 = fused_rms_norm(x, L["ln2"], eps)
                x = x + _ffn_apply(L, h2, st)
            x = fused_rms_norm(x, w["norm"], eps)
            return _head(x[0, n_valid - 1][None], w), pools

        return prefill

    # ------------------------------------------------------- gpt bodies
    def _gpt_unified_body(self):
        """The gpt family's unified step, the JAX ``_gpt_unified_body``:
        token + learned position embeddings, identity trig (cos ones, sin
        zeros, [T, hd/2] in the model dtype: the rope of the qkv kernels
        is exact on q / k), ``fused_layer_norm`` with bias for every norm
        (layers + 1 a step on the fused chain, 2 * layers + 1 on the
        split chain); on the fused chain the layer-norm site of
        ``fused_oproj_norm`` (o-proj bias) and the gelu site of
        ``fused_ffn`` (b1, b2)."""
        cfg = self._p["cfg"]
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        eps = cfg.layer_norm_eps
        mega, megafront = self.megadecode, self.megafront
        B, C = self.max_slots, self.prefill_chunk
        T = B + C
        seq_start = torch.arange(B + 1, dtype=torch.int32,
                                 device=self.device)
        dt = self._p["embed"].dtype
        c = torch.ones(T, hd // 2, dtype=dt, device=self.device)
        s = torch.zeros(T, hd // 2, dtype=dt, device=self.device)

        def step(w, tok, pools, positions, num_tokens, kv_lengths,
                 tables, tok_page, tok_off):
            x = (w["embed"][tok.long()] + w["pos"][positions.long()])[None]
            for L, (kp, vp) in zip(w["layers"], pools):
                h = fused_layer_norm(x, L["ln1w"], L["ln1b"], eps)
                if megafront:
                    q, kp, vp = fused_qkv_rope_append(
                        h[0], L["wqkv"], None, L["bqkv"], c, s, kp, vp,
                        tok_page, tok_off, heads=nh, kv_heads=nh,
                        head_dim=hd)
                else:
                    q, k, v = _split_qkv(h[0] @ L["wqkv"] + L["bqkv"])
                    q, kp, vp = fused_rope_append(
                        q.reshape(T, nh, hd), k.reshape(T, nh, hd),
                        v.reshape(T, nh, hd), c, s, kp, vp, tok_page,
                        tok_off)
                o = ragged_paged_attention(q, kp, vp, seq_start,
                                           num_tokens, kv_lengths, tables,
                                           scale=hd ** -0.5)
                if mega:
                    xn, h2 = fused_oproj_norm(
                        o.reshape(T, nh * hd), x[0], L["wo"], None, L["bo"],
                        L["ln2w"], L["ln2b"], eps=eps, norm="layer")
                    x = fused_ffn(h2, xn, L["wi"], None, None, None,
                                  L["wf"], None, L["bi"], L["bf"],
                                  act="gelu")[None]
                else:
                    x = x + (o.reshape(1, T, nh * hd) @ L["wo"] + L["bo"])
                    h2 = fused_layer_norm(x, L["ln2w"], L["ln2b"], eps)
                    x = x + (gelu(h2 @ L["wi"] + L["bi"], approximate=True)
                             @ L["wf"] + L["bf"])
            x = fused_layer_norm(x, w["normw"], w["normb"], eps)
            last = x[0, (seq_start + num_tokens - 1).clamp(0, T - 1).long()]
            return _head(last, w), pools

        return step

    def _gpt_decode_body(self):
        """The gpt family's alternating decode step (the JAX
        ``_gpt_decode_body``): ``fused_layer_norm`` for every norm
        (2 * layers + 1 a launch), the fused qkv matmul + bias, no rope,
        ``append_to_cache`` and ``paged_attention`` under the engine's
        pinned FLAGS_paged_impl, the GELU MLP."""
        cfg = self._p["cfg"]
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        eps = cfg.layer_norm_eps
        paged_impl = self.paged_impl

        def step(w, tok, pools, lengths, tables):
            B = tok.shape[0]
            x = (w["embed"][tok.long()] + w["pos"][lengths.long()])[:, None]
            for L, (kp, vp) in zip(w["layers"], pools):
                h = fused_layer_norm(x, L["ln1w"], L["ln1b"], eps)
                q, k, v = _split_qkv(h @ L["wqkv"] + L["bqkv"])
                q = q.reshape(B, 1, nh, hd)
                k = k.reshape(B, 1, nh, hd)
                v = v.reshape(B, 1, nh, hd)
                append_to_cache(kp, vp, k[:, 0], v[:, 0], lengths, tables)
                o = paged_attention(q[:, 0], kp, vp, lengths + 1, tables,
                                    scale=hd ** -0.5, impl=paged_impl)
                x = x + (o.reshape(B, 1, nh * hd) @ L["wo"] + L["bo"])
                h2 = fused_layer_norm(x, L["ln2w"], L["ln2b"], eps)
                x = x + (gelu(h2 @ L["wi"] + L["bi"], approximate=True)
                         @ L["wf"] + L["bf"])
            x = fused_layer_norm(x, w["normw"], w["normb"], eps)
            return _head(x[:, -1], w), pools

        return step

    def _gpt_prefill_body(self):
        """The gpt family's prefill chunk (the JAX ``_gpt_prefill_body``):
        as `_llama_prefill_body` with learned positions, no rope,
        ``fused_layer_norm`` with bias and the GELU MLP; MHA attention
        over the sequence's gathered pages, dense, no kernel."""
        cfg = self._p["cfg"]
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        eps = cfg.layer_norm_eps
        C = self.prefill_chunk
        ps, nj = self.page_size, self.pages_per_seq
        T = nj * ps
        dev = self.device
        rows = torch.arange(C, device=dev)
        pos_t = torch.arange(T, device=dev)

        def prefill(w, ids, pools, table, start: int, n_valid: int):
            pos = start + rows
            posc = pos.clamp(0, w["pos"].shape[0] - 1)
            x = w["embed"][ids.long()] + w["pos"][posc][None]  # [1, C, H]
            valid = rows < n_valid
            tab = table[0].long()
            pg = torch.where(valid, tab[(pos // ps).clamp(0, nj - 1)], 0)
            off = torch.where(valid, pos % ps, 0)
            vis = pos_t[None, :] <= pos[:, None]          # [C, T]
            for L, (kp, vp) in zip(w["layers"], pools):
                h = fused_layer_norm(x, L["ln1w"], L["ln1b"], eps)
                q, k, v = _split_qkv(h @ L["wqkv"] + L["bqkv"])
                q = q.reshape(1, C, nh, hd)
                k = k.reshape(1, C, nh, hd)
                v = v.reshape(1, C, nh, hd)
                kp[:, pg, off] = k[0].transpose(0, 1)
                vp[:, pg, off] = v[0].transpose(0, 1)
                ks = kp[:, tab].reshape(nh, T, hd)
                vs = vp[:, tab].reshape(nh, T, hd)
                scores = torch.einsum("bshd,htd->bhst", q, ks) \
                    * (hd ** -0.5)
                scores = torch.where(vis[None, None], scores.float(),
                                     torch.tensor(-1e30, device=dev))
                aw = torch.softmax(scores, dim=-1).to(vs.dtype)
                o = torch.einsum("bhst,htd->bshd", aw, vs).reshape(
                    1, C, nh * hd)
                x = x + (o @ L["wo"] + L["bo"])
                h2 = fused_layer_norm(x, L["ln2w"], L["ln2b"], eps)
                x = x + (gelu(h2 @ L["wi"] + L["bi"], approximate=True)
                         @ L["wf"] + L["bf"])
            x = fused_layer_norm(x, w["normw"], w["normb"], eps)
            return _head(x[0, n_valid - 1][None], w), pools

        return prefill
