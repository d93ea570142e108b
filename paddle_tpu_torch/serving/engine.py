"""Continuous-batching serving engine over the paged KV cache
(counterpart of paddle_tpu/serving/engine.py, llama family, ragged path).

`ServingEngine.add_request/step/collect` runs ONE unified step per
engine step: every decode slot's pending token and one chunk of the
oldest prefilling request ride a single flat token buffer through the
per-layer body of the split chain

    fused_rms_norm -> q/k/v matmuls -> fused_rope_append
    -> ragged_paged_attention -> o-proj matmul + residual
    -> fused_rms_norm -> SwiGLU FFN matmuls + residual

and a final fused_rms_norm before the LM head: three hand-written CUDA
kernels (2 * layers + 1 rms_norm, layers rope_append and layers ragged
launches per step) with the projections and the FFN left to
``torch.matmul``, as the JAX package leaves them to XLA on this chain.
Requests join mid-decode (chunked prefill) and leave the instant they
hit EOS/max-tokens; their pages return to the pool immediately.

Per-sequence row tables (seq_start / num_tokens / kv_lengths / page
tables) make joins and leaves pure data changes. Inactive slots point
their whole page table at the allocator's trash page 0 with
length/num_tokens 0: they write their (garbage) K/V into the trash page
and their logits are ignored on the host.

The page pools are persistent device tensors, one (K, V) pair per layer.
``fused_rope_append`` writes each step's K/V rows into them IN PLACE
(the JAX kernel aliased them through input_output_aliases and returned
new arrays), and copy-on-write page copies are in-place page copies.

PyTorch runs eagerly: the body is a plain Python function over tensors,
built once per engine (CUDA graphs are ROADMAP.md queue A item 6).

Greedy decoding only: engine tokens equal the JAX engine's tokens per
request on the same weights and trace (tests/test_torch_llama_serving.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resilience as _res
from ..device import DeviceLike, resolve_device
from ..generation import _ffn_apply, _llama_decode_params, _llama_weights, \
    _mm_w
from ..ops.fused import fused_rms_norm, fused_rope_append
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


def _unported(feature: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported yet (ROADMAP.md queue A item {item})")


class ServingEngine:
    """Continuous-batching engine for the llama family.

    Typical loop::

        eng = ServingEngine(model, max_slots=4, page_size=16)
        eng.add_request(prompt_ids, max_new_tokens=32, eos_token_id=2)
        while eng.has_work():
            eng.step()
        results = eng.collect()   # {request_id: np.int32[max_new]}

    ``device=None`` resolves to ``"cuda"`` and raises when CUDA is
    absent; the model must live on the engine's device. The defaults
    are the features this port has: the unified ragged step on the split
    chain (``megafront=False, megadecode=False``), live-donor prefix
    sharing, no radix prefix cache, no preemption, no speculative
    decoding. Asking for one of the unported features raises
    NotImplementedError naming its ROADMAP item.

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
                 megadecode: bool = False,
                 megafront: bool = False,
                 role: str = "colocated",
                 slo_targets=None,
                 device: DeviceLike = None):
        if role not in ("prefill", "decode", "colocated"):
            raise ValueError(
                f"role must be prefill/decode/colocated, got {role!r}")
        if megafront or megadecode:
            raise _unported("the megafront/megadecode kernels", 1)
        if ragged is False:
            raise _unported("the split prefill/decode path (ragged=False)",
                            3)
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
        p = _llama_decode_params(model, weight_only_int8, weight_only_quant)
        if p["embed"].device != self.device:
            raise ValueError(
                f"model parameters live on {p['embed'].device}, the engine "
                f"on {self.device}: move the model with model.to(...)")
        cfg = p["cfg"]
        self._p = p
        self._w = _llama_weights(p)
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
        kv, d = cfg.num_key_value_heads, cfg.head_dim
        shape = (kv, self.num_pages, self.page_size, d)
        self._pools = [(torch.zeros(shape, dtype=dt, device=self.device),
                        torch.zeros(shape, dtype=dt, device=self.device))
                       for _ in p["layers"]]
        self._body = self._llama_unified_body()
        self.launches = 0      # unified steps run by THIS engine
        #: logits [max_slots + 1, vocab] of the last unified step (row s
        #: for decode slot s, the last row for the prefill chunk; idle
        #: rows hold garbage the host ignores)
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
        ones into free slots, then run ONE unified ragged step carrying
        every decode slot's token plus one prefill chunk. Returns counts
        of the step's work."""
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
        pf, dec, fin = self._unified_step()
        out["prefill_tokens"] = pf
        out["decoded"] = dec
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

    # ------------------------------------------------------ unified body
    def _llama_unified_body(self):
        """The per-step function over tensors (the JAX engine's jitted
        body on its split-chain branch). T = max_slots + prefill_chunk
        flat token rows, S = max_slots + 1 sequences with FIXED
        seq_start [0..B-1, B]: decode slot i owns row i; the prefill
        chunk owns rows B..B+n-1."""
        cfg = self._p["cfg"]
        Hh, KV, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        eps = cfg.rms_norm_eps
        B, C = self.max_slots, self.prefill_chunk
        T = B + C
        seq_start = torch.arange(B + 1, dtype=torch.int32,
                                 device=self.device)

        def step(w, tok, pools, positions, num_tokens, kv_lengths,
                 tables, tok_page, tok_off):
            x = w["embed"][tok.long()][None]             # [1, T, H]
            c = w["cos"][positions.long()]               # [T, D/2] f32
            s = w["sin"][positions.long()]
            for L, (kp, vp) in zip(w["layers"], pools):
                h = fused_rms_norm(x, L["ln1"], eps)
                q, k, v = (_mm_w(h, L, "wq"), _mm_w(h, L, "wk"),
                           _mm_w(h, L, "wv"))
                q, kp, vp = fused_rope_append(
                    q.reshape(T, Hh, D), k.reshape(T, KV, D),
                    v.reshape(T, KV, D), c, s, kp, vp, tok_page, tok_off)
                o = ragged_paged_attention(q, kp, vp, seq_start,
                                           num_tokens, kv_lengths, tables,
                                           scale=D ** -0.5)
                x = x + _mm_w(o.reshape(1, T, Hh * D), L, "wo")
                h2 = fused_rms_norm(x, L["ln2"], eps)
                x = x + _ffn_apply(L, h2)
            x = fused_rms_norm(x, w["norm"], eps)
            # each sequence's logits come from its LAST flat row; idle
            # slots (num_tokens 0) index garbage the host ignores
            last = x[0, (seq_start + num_tokens - 1).clamp(0, T - 1).long()]
            head = w["head"] if w["head"] is not None else w["embed"].T
            return last @ head, pools

        return step
