"""Paged KV-cache bookkeeping: the block pool (counterpart:
kubeflow_tpu/serving/paged.py, whose `BlockPool` this copies without
the cache-ledger hooks; the radix prefix cache and the host spill tier
are not ported yet).

Pure host-side Python. The device pool itself,
`[L, num_blocks, block_size, n_kv, hd]`, lives in the continuous
engine's `SlotState`; here we only track which physical blocks are
free and which are owned by an in-flight request.

Conventions
-----------
- Block 0 is the reserved *trash* block. Unallocated block-table entries
  point at it, and writes from frozen rows and from retired-but-not-yet-
  reset slots land there harmlessly. It is never handed out.
- Write disjointness: a row's write range `[q_start, q_start + q_lens)`
  lies in blocks no other row's table references, because every block
  is handed to exactly one request. The prefill-append kernel's scatter
  relies on it (ops/cuda/prefill_append.py).
"""

from __future__ import annotations

TRASH_BLOCK = 0


class BlockPool:
    """Free-list allocator over physical KV block ids `[1, num_blocks)`."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (1 trash + 1 usable), got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # LIFO off the tail; initialised so the first allocs are 1, 2, ...
        self._free = list(range(num_blocks - 1, 0, -1))
        # membership mirror of _free: a double free would hand one
        # physical block to two owners and corrupt both sequences' KV
        self._free_set = set(self._free)

    @property
    def capacity(self) -> int:
        """Usable blocks (excludes the trash block)."""
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.capacity - len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """Take `n` blocks, or None (and take nothing) if fewer are free."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(out)
        return out

    def free(self, blocks) -> None:
        """Return `blocks` to the pool."""
        blocks = list(blocks)
        seen: set[int] = set()
        for b in blocks:
            if not 0 < b < self.num_blocks:
                raise ValueError(f"freeing out-of-range block {b}")
            if b in self._free_set or b in seen:
                raise ValueError(f"double-free of block {b}")
            seen.add(b)
        self._free.extend(blocks)
        self._free_set.update(blocks)
