"""Paged KV block allocator (counterpart of
paddle_tpu/serving/block_allocator.py).

Host-side bookkeeping over a FIXED pool of `page_size`-token blocks laid
out as the port's kernels consume them (k/v_pages
[KV, total_pages, page_size, D]; per-sequence page table [pages_per_seq]
int32). The allocator never touches device memory: it hands out
physical page ids, tracks per-page refcounts for copy-on-write prefix
sharing, and returns (src, dst) page-copy ops the engine applies to the
device pools before a shared page is written.

  - page 0 is the TRASH page: inactive engine slots point their whole
    page table at it so the fixed-shape step can write somewhere
    without corrupting live pages. It is never handed out.
  - admission is CONSERVATIVE: a sequence reserves every page it could
    ever need (ceil(total_tokens / page_size), minus pages it shares
    with a prefix donor) up front, so a mid-flight `extend` can never
    fail — OOM surfaces as a clean `resilience.Overloaded` at admission
    time, before any state changed.
  - `fork` shares the donor's prefix pages by refcount (full pages AND
    the trailing partial page); the first write into a shared page
    copies it (COW), so donors and forks never observe each other's
    tokens.

The prefix-cache pins and the handoff export/import of the JAX allocator
belong to features not ported yet (ROADMAP.md queue A item 6).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .. import resilience as _res

__all__ = ["PageBlockAllocator"]


class _Seq:
    __slots__ = ("pages", "length", "reserved")

    def __init__(self, pages: List[int], length: int, reserved: int):
        self.pages = pages          # physical page ids, in position order
        self.length = length        # tokens logically present
        self.reserved = reserved    # pages still owed from the free list


class PageBlockAllocator:
    """Fixed pool of KV pages with refcounted copy-on-write sharing."""

    def __init__(self, num_pages: int, page_size: int, pages_per_seq: int):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is reserved "
                             "as the inactive-slot trash page)")
        if page_size < 1 or pages_per_seq < 1:
            raise ValueError("page_size and pages_per_seq must be >= 1")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.pages_per_seq = int(pages_per_seq)
        # pop() yields ascending ids — deterministic allocation order for
        # the seeded-trace tests
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._ref = np.zeros(self.num_pages, np.int64)
        self._ref[0] = 1            # trash page: pinned forever
        self._seqs: Dict[object, _Seq] = {}
        self._reserved_total = 0
        self.cow_copies = 0         # copy-on-write page copies handed out

    # ---------------------------------------------------------------- pool
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def available_pages(self) -> int:
        """Pages not yet handed out AND not promised to a live sequence."""
        return len(self._free) - self._reserved_total

    def _need_pages(self, total_tokens: int, share_tokens: int = 0) -> int:
        """Free-list pages a sequence of `total_tokens` may consume when
        `share_tokens` of its prefix ride on a donor's pages: every
        non-shared page, plus one for the COW of a partially-shared
        page (its first write copies it)."""
        ps = self.page_size
        n_total = -(-total_tokens // ps)
        return n_total - share_tokens // ps

    # ------------------------------------------------------------ lifecycle
    def allocate(self, seq_id, total_tokens: int) -> None:
        """Admit a sequence that will hold at most `total_tokens` tokens
        (prompt + max_new), reserving every page it could need. Raises
        `resilience.Overloaded` (no state change) if the pool cannot
        guarantee it."""
        self._check_new(seq_id, total_tokens)
        need = self._need_pages(total_tokens)
        if need > self.available_pages:
            raise _res.Overloaded(
                f"page pool exhausted: sequence needs {need} pages, "
                f"{self.available_pages} available "
                f"({self.num_pages - 1} usable)")
        self._seqs[seq_id] = _Seq([], 0, need)
        self._reserved_total += need

    def fork(self, parent_id, child_id, share_tokens: int,
             total_tokens: int) -> None:
        """Admit `child_id` sharing the first `share_tokens` tokens of
        `parent_id`'s cache by refcount. The child starts at
        length == share_tokens; its first write into the trailing
        partially-shared page copies it (COW)."""
        parent = self._seqs[parent_id]
        if share_tokens < 0 or share_tokens > parent.length:
            raise ValueError(
                f"share_tokens {share_tokens} outside parent's "
                f"{parent.length} cached tokens")
        if share_tokens == 0:
            return self.allocate(child_id, total_tokens)
        self._check_new(child_id, total_tokens)
        if total_tokens < share_tokens:
            raise ValueError("total_tokens < share_tokens")
        need = self._need_pages(total_tokens, share_tokens)
        n_share = -(-share_tokens // self.page_size)
        # sharing a PARTIAL page puts the donor on the COW hook too: its
        # next write into that page must copy it, a pop its own
        # reservation never covered. Charge the donor one page now (only
        # on the 1->2 refcount transition — after the first COW the page
        # is private again and later forks re-charge it themselves).
        donor_extra = 1 if (share_tokens % self.page_size
                            and parent.length < n_share * self.page_size
                            and self._ref[parent.pages[n_share - 1]] == 1) \
            else 0
        if need + donor_extra > self.available_pages:
            raise _res.Overloaded(
                f"page pool exhausted: fork needs {need + donor_extra} "
                f"pages, {self.available_pages} available")
        shared = parent.pages[:n_share]
        for pg in shared:
            self._ref[pg] += 1
        parent.reserved += donor_extra
        self._seqs[child_id] = _Seq(list(shared), share_tokens, need)
        self._reserved_total += need + donor_extra

    def extend(self, seq_id, n_tokens: int = 1) -> List[Tuple[int, int]]:
        """Make the next `n_tokens` write slots physically writable:
        allocates fresh pages at page boundaries and copies-on-write any
        shared page about to be written. Returns [(src_page, dst_page)]
        copy ops the engine must apply to the device pools BEFORE the
        write. Never raises for a sequence admitted by allocate/fork
        (the reservation covers the worst case)."""
        seq = self._seqs[seq_id]
        ps = self.page_size
        copies: List[Tuple[int, int]] = []
        for pos in range(seq.length, seq.length + n_tokens):
            idx = pos // ps
            if idx >= self.pages_per_seq:
                raise ValueError(
                    f"sequence {seq_id!r} overflows pages_per_seq="
                    f"{self.pages_per_seq} at token {pos}")
            if idx == len(seq.pages):
                seq.pages.append(self._pop_page(seq))
            elif self._ref[seq.pages[idx]] > 1:
                src = seq.pages[idx]
                dst = self._pop_page(seq)
                self._ref[src] -= 1
                seq.pages[idx] = dst
                copies.append((src, dst))
                self.cow_copies += 1
        seq.length += n_tokens
        return copies

    def shrink(self, seq_id, n_tokens: int) -> None:
        """Roll the sequence's logical length back by `n_tokens`. Pages
        stay attached — the positions are within the reservation and will
        be rewritten; the attention row tables never read past
        `seq_length`, so stale KV beyond the new length is unobservable."""
        if n_tokens < 0:
            raise ValueError("n_tokens must be >= 0")
        seq = self._seqs[seq_id]
        if n_tokens > seq.length:
            raise ValueError(
                f"cannot shrink {seq.length}-token sequence by {n_tokens}")
        seq.length -= n_tokens

    def free(self, seq_id) -> None:
        """Release a finished sequence: derefs its pages (returning
        refcount-0 pages to the free list) and drops its remaining
        reservation."""
        seq = self._seqs.pop(seq_id)
        for pg in seq.pages:
            self._ref[pg] -= 1
            if self._ref[pg] == 0:
                self._free.append(pg)
        self._reserved_total -= seq.reserved

    # -------------------------------------------------------------- queries
    def table(self, seq_id) -> np.ndarray:
        """[pages_per_seq] int32 page table, trash-padded past the end."""
        t = np.zeros(self.pages_per_seq, np.int32)
        pages = self._seqs[seq_id].pages
        t[:len(pages)] = pages
        return t

    def seq_length(self, seq_id) -> int:
        return self._seqs[seq_id].length

    def stats(self) -> Dict[str, float]:
        used = self.num_pages - 1 - len(self._free)
        usable = self.num_pages - 1
        # per-page occupancy: shared prefix pages hold the same tokens
        # for every sharer, so count each physical page once at its
        # deepest fill
        occ: Dict[int, int] = {}
        for seq in self._seqs.values():
            for i, pg in enumerate(seq.pages):
                filled = min(seq.length - i * self.page_size,
                             self.page_size)
                if filled > 0:
                    occ[pg] = max(occ.get(pg, 0), filled)
        cap = used * self.page_size
        live = sum(occ.values())
        return {
            "pages_used": used,
            "pages_free": len(self._free),
            "utilization": used / usable if usable else 0.0,
            "fragmentation": 1.0 - live / cap if cap else 0.0,
            "reserved": self._reserved_total,
            "sequences": len(self._seqs),
        }

    # ------------------------------------------------------------ internals
    def _check_new(self, seq_id, total_tokens: int) -> None:
        if seq_id in self._seqs:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        if total_tokens < 1:
            raise ValueError("total_tokens must be >= 1")
        if total_tokens > self.pages_per_seq * self.page_size:
            raise ValueError(
                f"{total_tokens} tokens exceed pages_per_seq * page_size "
                f"= {self.pages_per_seq * self.page_size}")

    def _pop_page(self, seq: _Seq) -> int:
        if not self._free:
            # unreachable for sequences admitted through allocate/fork —
            # the reservation is the no-corruption guarantee — but a
            # clean typed error beats an IndexError if bookkeeping ever
            # drifts
            raise _res.Overloaded("page pool exhausted mid-flight")
        pg = self._free.pop()
        if seq.reserved > 0:
            seq.reserved -= 1
            self._reserved_total -= 1
        self._ref[pg] = 1
        return pg
