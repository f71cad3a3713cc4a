"""Block-managed KV cache for the generation scheduler.

Counterpart of ``mxnet_tpu/serving/kv_cache.py`` (host code, the same
allocator).  KV memory is pre-allocated once as a pool of fixed-size
*token blocks* (``MXTPU_SERVING_KV_BLOCK`` positions per block,
``MXTPU_SERVING_KV_BLOCKS`` blocks in all) and a free list hands blocks
to requests as their sequences grow, returning them the moment a
request finishes, on every exit path (finish, deadline, cancel, shed,
a failed step).

Two accounting layers keep the pool leak-proof:

* **Reservation**: admission to the running batch reserves the *worst
  case* block count (``ceil((prompt + max_new_tokens)/block)``), so a
  request, once decoding, can never exhaust the pool mid-flight.
* **Allocation**: physical blocks are assigned lazily, only when the
  sequence crosses a block boundary, so short generations give their
  unused reservation back at release.

Block 0 is reserved scratch: empty decode slots and unwritten
block-table tail entries point at it, so the captured graphs always
gather and scatter in bounds.  What is read from scratch is masked to an
exact additive zero by the attention mask.

Occupancy (allocated blocks) is the ``serving.kv_blocks_used`` gauge; it
returns to zero after the server drains.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..base import get_env
from ..observability.registry import registry

__all__ = ["BlockTable", "BlockKVCache", "SCRATCH_BLOCK"]

#: reserved scratch block — never allocated, every table tail points here.
SCRATCH_BLOCK = 0


class BlockTable:
    """Per-request view of the pool: the ordered block ids backing one
    sequence.  Grown by :meth:`BlockKVCache.ensure`, read by the decode
    step as a fixed-width int32 row (tail padded with the scratch id).
    """

    __slots__ = ("blocks", "reserved", "seq_len")

    def __init__(self, reserved: int):
        self.blocks: List[int] = []
        self.reserved = reserved
        self.seq_len = 0

    def padded(self, width: int) -> List[int]:
        """Fixed-width row for the decode step."""
        row = self.blocks[:width]
        return row + [SCRATCH_BLOCK] * (width - len(row))


class BlockKVCache:
    """Free-list allocator over a fixed pool of KV token blocks.

    Thread-safe; the scheduler thread allocates/frees while admission
    (caller threads) queries :meth:`can_reserve`.
    """

    def __init__(self, n_blocks: Optional[int] = None,
                 block_size: Optional[int] = None):
        self.block_size = int(block_size if block_size is not None
                              else get_env("MXTPU_SERVING_KV_BLOCK"))
        n = int(n_blocks if n_blocks is not None
                else get_env("MXTPU_SERVING_KV_BLOCKS"))
        if self.block_size < 1:
            raise ValueError("KV block size must be >= 1")
        if n < 2:
            raise ValueError("KV pool needs >= 2 blocks (block 0 is scratch)")
        self.n_blocks = n
        # block 0 is scratch and never enters the free list.
        self._free: List[int] = list(range(n - 1, 0, -1))
        self._reserved = 0          # blocks promised to admitted requests
        self._tables: Dict[int, BlockTable] = {}
        self._lock = threading.Lock()
        self._g_used = registry().gauge(
            "serving.kv_blocks_used",
            "KV-cache blocks currently allocated to live generations")
        self._g_used.set(0)

    # -- capacity ----------------------------------------------------
    @property
    def capacity(self) -> int:
        """Usable blocks (pool minus the scratch block)."""
        return self.n_blocks - 1

    def blocks_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        """Worst-case block count for a request (reservation unit)."""
        total = prompt_len + max_new_tokens
        return -(-total // self.block_size)

    def can_reserve(self, n: int) -> bool:
        with self._lock:
            return self._reserved + n <= self.capacity

    def fits(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Could this request EVER be admitted (empty pool)?  Requests
        failing this are rejected at submit, not queued forever."""
        return self.blocks_needed(prompt_len, max_new_tokens) <= self.capacity

    # -- allocation --------------------------------------------------
    def reserve(self, req_id: int, prompt_len: int,
                max_new_tokens: int) -> Optional[BlockTable]:
        """Admit a request: reserve its worst-case block count and hand
        back its (empty) block table.  Returns None when the pool cannot
        currently honor the reservation."""
        need = self.blocks_needed(prompt_len, max_new_tokens)
        with self._lock:
            if self._reserved + need > self.capacity:
                return None
            self._reserved += need
            table = BlockTable(need)
            self._tables[req_id] = table
            return table

    def ensure(self, req_id: int, seq_len: int) -> BlockTable:
        """Grow a request's table so positions ``[0, seq_len)`` are
        physically backed.  Lazy: blocks come off the free list only as
        the sequence crosses block boundaries.  The reservation makes
        this infallible for admitted requests."""
        with self._lock:
            table = self._tables[req_id]
            need = -(-seq_len // self.block_size)
            if need > table.reserved:
                raise RuntimeError(
                    "request %d grew past its reservation (%d > %d blocks)"
                    % (req_id, need, table.reserved))
            while len(table.blocks) < need:
                table.blocks.append(self._free.pop())
            table.seq_len = seq_len
            self._g_used.set(self.n_blocks - 1 - len(self._free))
            return table

    def release(self, req_id: int) -> None:
        """Return a request's blocks AND its unused reservation.  Called
        on every exit path: finish, deadline, 429, server close."""
        with self._lock:
            table = self._tables.pop(req_id, None)
            if table is None:
                return
            self._free.extend(reversed(table.blocks))
            table.blocks = []
            self._reserved -= table.reserved
            self._g_used.set(self.n_blocks - 1 - len(self._free))

    # -- introspection -----------------------------------------------
    def used(self) -> int:
        with self._lock:
            return self.n_blocks - 1 - len(self._free)

    def reserved(self) -> int:
        with self._lock:
            return self._reserved
