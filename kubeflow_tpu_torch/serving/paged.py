"""Paged KV-cache bookkeeping: block pool, host spill tier and radix
prefix cache (counterpart: kubeflow_tpu/serving/paged.py).

Pure host-side Python. The device pool itself,
`[L, num_blocks, block_size, n_kv, hd]`, lives in the continuous
engine's `SlotState`; here we only track which physical blocks are
free, which are owned by an in-flight request, which are retained by
the radix tree for cross-request prefix reuse, and which block contents
were demoted to host memory.

Conventions
-----------
- Block 0 is the reserved *trash* block. Unallocated block-table entries
  point at it, and writes from frozen rows and from retired-but-not-yet-
  reset slots land there harmlessly. It is never handed out.
- The radix tree has one node per *full* block: an edge is exactly
  `block_size` tokens. A partial-block prefix is matched against a
  child's key and handled by the caller as copy-on-write (the matched
  block seeds the new request; the request writes its own fresh block,
  so the shared one is never written).
- `refs` on a node counts active requests whose block table points at
  its block. Only refcount-0 leaves may be evicted (evicting an interior
  node would orphan its children's token paths).

Write disjointness
------------------
Rows may share blocks, read-only, and only strictly below each row's
seed length: the tree indexes only full blocks of already-written
prompt prefix, and a partial-block match is copied into the row's own
fresh block (the copy half of copy-on-write) rather than appended to.
A row writes only into its own fresh blocks, which the pool handed to
exactly one request, so a row's write range `[q_start, q_start +
q_lens)` lies in blocks no other row's table references. The
prefill-append kernel's scatter relies on it (ops/cuda/prefill_append.py).
The one write into shared blocks is monolithic admission's
`insert_many`, which rewrites every cell of a table's blocks: below the
seed length it writes back exactly what `gather_seed` read (same dtype,
no arithmetic), so a shared block keeps its bits.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable

from kubeflow_tpu_torch.obs.cachestats import prefix_hash

TRASH_BLOCK = 0
# prefix heat: scores halve every HEAT_HALF_LIFE radix-clock ticks, and
# the table is pruned to its hottest half past HEAT_MAX_ENTRIES
HEAT_HALF_LIFE = 64
HEAT_MAX_ENTRIES = 512


class BlockPool:
    """Free-list allocator over physical KV block ids `[1, num_blocks)`.
    Blocks held by the radix tree are simply "in use" until
    `RadixPrefixCache.evict` returns them."""

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
        # optional obs.CacheLedger: books every alloc, and every free to
        # a cause
        self.ledger = None

    def attach_ledger(self, ledger) -> None:
        """Attach a lifecycle ledger before the first alloc, or its
        births cannot reconcile against `in_use`."""
        if self.in_use:
            raise ValueError(
                f"ledger attached with {self.in_use} blocks already live")
        self.ledger = ledger

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
        if self.ledger is not None:
            self.ledger.note_alloc(out)
        return out

    def free(self, blocks, *, cause: str | None = None) -> None:
        """Return `blocks` to the pool. `cause` books the deaths in the
        attached ledger (obs.cachestats.EVICTION_CAUSES); None lands in
        the ledger's `unattributed` bucket, which must stay zero."""
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
        if self.ledger is not None:
            self.ledger.note_free(blocks, cause)


class HostSpillTier:
    """Byte-budgeted host-RAM LRU store for demoted KV block contents.

    Entries are keyed by `(ns, token_path)`, the tenant namespace and
    the FULL token prefix ending at the block: a block's content is a
    pure function of that prefix (the pool's canonical form), so a
    restore is token-identical by construction, and one namespace never
    restores (or times) another's entries. Payloads are opaque here (the
    batcher stores host `(k, v)` copies). `put` returns the keys the
    budget pushed out, oldest first, for the caller to book as content
    deaths."""

    def __init__(self, budget_bytes: int, block_bytes: int):
        if budget_bytes < 0:
            raise ValueError(f"budget_bytes must be >= 0, got "
                             f"{budget_bytes}")
        if block_bytes < 1:
            raise ValueError(f"block_bytes must be >= 1, got "
                             f"{block_bytes}")
        self.budget_bytes = int(budget_bytes)
        self.block_bytes = int(block_bytes)
        # (ns, token path tuple) -> payload; insertion order is LRU
        # order (move_to_end on every touch)
        self._entries: OrderedDict[tuple, object] = OrderedDict()

    @property
    def capacity_blocks(self) -> int:
        return self.budget_bytes // self.block_bytes

    @property
    def spilled_blocks(self) -> int:
        return len(self._entries)

    @property
    def spilled_bytes(self) -> int:
        return len(self._entries) * self.block_bytes

    @staticmethod
    def _key(ns: str, path) -> tuple:
        return (ns, tuple(int(t) for t in path))

    def contains(self, ns: str, path) -> bool:
        """Presence probe without an LRU touch: planning peeks, only a
        demote or a restore moves the clock."""
        return self._key(ns, path) in self._entries

    def put(self, ns: str, path, payload) -> list[tuple]:
        """Park one block's content; -> the keys the byte budget evicted
        to make room (this very entry too when the budget cannot hold
        one block)."""
        key = self._key(ns, path)
        self._entries[key] = payload
        self._entries.move_to_end(key)
        dropped: list[tuple] = []
        while len(self._entries) * self.block_bytes > self.budget_bytes:
            victim, _ = self._entries.popitem(last=False)
            dropped.append(victim)
        return dropped

    def pop(self, ns: str, path):
        """Take one block's content out (a restore owns it now), or None
        if the budget already dropped it."""
        return self._entries.pop(self._key(ns, path), None)

    def clear(self) -> int:
        """Drop every entry (their contents describe weights that were
        replaced). -> entries dropped, for the caller to book."""
        n = len(self._entries)
        self._entries.clear()
        return n


class _Node:
    __slots__ = ("key", "block", "children", "refs", "last_use", "parent")

    def __init__(self, key, block, parent):
        self.key = key          # tuple of block_size token ids (None at roots)
        self.block = block      # physical block id (None at root)
        self.children = {}      # key tuple -> _Node
        self.refs = 0           # active requests pointing at self.block
        self.last_use = 0       # logical clock, for LRU eviction
        self.parent = parent


class RadixPrefixCache:
    """Token-prefix index over full KV blocks, with ref-counted sharing.

    `match` walks full-block edges and also reports a *partial* match
    inside the next edge (the copy-on-write seed). `insert` adopts
    caller-owned blocks; a block whose token path already exists stays
    with the caller (a duplicate: free it). `evict` pops refcount-0
    leaves in LRU order back to the pool, demoting their contents to
    the spill tier when one is attached.

    Every call takes a namespace `ns` (tenant prefix isolation): `""` is
    the shared default tree (`self.root`), any other namespace gets its
    own root on first use, so two namespaces never match each other's
    entries, not even by the timing of a shared-prefix hit. Eviction,
    `clear` and the block counts run across every namespace."""

    def __init__(self, pool: BlockPool, *,
                 heat_half_life: int = HEAT_HALF_LIFE,
                 heat_max_entries: int = HEAT_MAX_ENTRIES):
        self.pool = pool
        self.block_size = pool.block_size
        self.root = _Node(None, None, None)
        self._roots: dict[str, _Node] = {"": self.root}
        self._clock = 0
        self.cached_blocks = 0  # blocks currently owned by the tree
        # decayed per-prefix heat: (ns, first-block key) -> [score,
        # last-bump clock]
        self.heat_half_life = max(1, int(heat_half_life))
        self.heat_max_entries = max(2, int(heat_max_entries))
        self._heat: dict[tuple, list] = {}
        # optional host-RAM spill tier and its device-block reader
        self.spill: HostSpillTier | None = None
        self.spill_reader: Callable[[int], object] | None = None

    def attach_spill(self, tier: HostSpillTier,
                     reader: Callable[[int], object]) -> None:
        """Attach a `HostSpillTier` and a `reader(block_id) -> payload |
        None` that copies one device block's contents to host memory.
        From then on eviction demotes instead of discarding, booked as
        cause `spill`; a None or raising reader falls back to the plain
        `lru` discard."""
        self.spill = tier
        self.spill_reader = reader

    # -- internals ---------------------------------------------------------

    def _root_for(self, ns: str) -> _Node:
        root = self._roots.get(ns)
        if root is None:
            root = self._roots[ns] = _Node(None, None, None)
        return root

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _touch(self, node: _Node) -> None:
        t = self._tick()
        # roots (any namespace) are the only nodes with key None
        while node is not None and node.key is not None:
            node.last_use = t
            node = node.parent

    def _decayed(self, ent: list, t: int) -> float:
        return ent[0] * 0.5 ** ((t - ent[1]) / self.heat_half_life)

    def _heat_bump(self, ns: str, key: tuple) -> None:
        t = self._clock
        ent = self._heat.get((ns, key))
        if ent is None:
            if len(self._heat) >= self.heat_max_entries:
                self._heat_prune(t)
            self._heat[(ns, key)] = [1.0, t]
        else:
            ent[0] = self._decayed(ent, t) + 1.0
            ent[1] = t

    def _heat_prune(self, t: int) -> None:
        """Keep only the hottest half, by decayed score."""
        ranked = sorted(self._heat.items(),
                        key=lambda kv: self._decayed(kv[1], t),
                        reverse=True)
        self._heat = dict(ranked[: self.heat_max_entries // 2])

    # -- queries -----------------------------------------------------------

    def match(self, tokens, *,
              ns: str = "") -> tuple[list[_Node], _Node | None, int]:
        """Longest cached prefix of `tokens` within namespace `ns`.
        -> `(nodes, partial_node, partial_len)`: `nodes` are the fully
        matched block edges in order; `partial_node` (if any) is a child
        whose key shares `partial_len` in [1, block_size) leading tokens
        with the remainder. Takes no refs."""
        bs = self.block_size
        nodes: list[_Node] = []
        node = self._root_for(ns)
        i = 0
        while i + bs <= len(tokens):
            child = node.children.get(tuple(tokens[i:i + bs]))
            if child is None:
                break
            nodes.append(child)
            node = child
            i += bs
        partial_node, partial_len = None, 0
        rest = tuple(tokens[i:i + bs])
        if rest:
            for key, child in node.children.items():
                n = 0
                for a, b in zip(rest, key):
                    if a != b:
                        break
                    n += 1
                if n > partial_len:
                    partial_node, partial_len = child, n
        if nodes:
            self._touch(nodes[-1])
            self._heat_bump(ns, nodes[0].key)
        if partial_node is not None:
            self._touch(partial_node)
        return nodes, partial_node, partial_len

    # -- ref management ----------------------------------------------------

    def ref(self, nodes) -> None:
        for n in nodes:
            n.refs += 1
        if nodes:
            self._touch(nodes[-1])

    def unref(self, nodes) -> None:
        for n in nodes:
            n.refs -= 1
            assert n.refs >= 0, "refcount underflow"

    # -- growth ------------------------------------------------------------

    def insert(self, tokens, blocks: dict[int, int], *,
               hold: bool = False, ns: str = ""):
        """Index `tokens` (a multiple of block_size long) into namespace
        `ns`. `blocks[i]` is
        the caller-owned block holding tokens
        `[i*bs, (i+1)*bs)`, consulted only for edges that do not exist
        yet. -> `(adopted, held_nodes)`: the block indices the tree took
        over, and (with `hold=True`) the nodes created with one ref for
        the caller, whose table points at those blocks."""
        bs = self.block_size
        assert len(tokens) % bs == 0, len(tokens)
        adopted: set[int] = set()
        held: list[_Node] = []
        node = self._root_for(ns)
        for i in range(len(tokens) // bs):
            key = tuple(tokens[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                phys = blocks.get(i)
                if phys is None:
                    break  # caller had nothing for this edge
                child = _Node(key, phys, node)
                node.children[key] = child
                adopted.add(i)
                self.cached_blocks += 1
                if i == 0:
                    # a prefix's first cached appearance is its first
                    # heat point (later hits bump through match())
                    self._heat_bump(ns, key)
                if hold:
                    child.refs = 1
                    held.append(child)
            node = child
        if node.key is not None:
            self._touch(node)
        return adopted, held

    # -- shrink ------------------------------------------------------------

    def _path_tokens(self, node: _Node) -> tuple:
        """Full token prefix ending at `node`'s block: the spill key."""
        keys = []
        while node is not None and node.key is not None:
            keys.append(node.key)
            node = node.parent
        out: list[int] = []
        for key in reversed(keys):
            out.extend(key)
        return tuple(out)

    def _demote(self, ns: str, victim: _Node) -> bool:
        """Park `victim`'s block content in the spill tier. -> True when
        the content survives on the host (the free books as `spill`),
        False for a plain discard (`lru`). A reader failure degrades to
        the discard."""
        if self.spill is None or self.spill_reader is None:
            return False
        try:
            payload = self.spill_reader(victim.block)
        except Exception:  # noqa: BLE001 — best-effort device read
            payload = None
        if payload is None:
            return False
        dropped = self.spill.put(ns, self._path_tokens(victim), payload)
        if dropped and self.pool.ledger is not None:
            self.pool.ledger.note_spill_drop(len(dropped))
        return True

    def evict(self, need: int, *, keep=()) -> int:
        """Free refcount-0 LRU leaves back to the pool until `need`
        blocks are released or no candidate remains. -> blocks freed.
        Nodes in `keep` are spared: a caller's match that it has not
        ref'd yet. With a spill tier each victim's content is demoted to
        host memory first (cause `spill` instead of `lru`)."""
        keep = set(keep)
        freed = 0
        while freed < need:
            victim, victim_ns = None, ""
            # evict across namespaces
            stack = list(self._roots.items())
            while stack:
                ns, n = stack.pop()
                stack.extend((ns, c) for c in n.children.values())
                if (n.key is None or n.children or n.refs > 0
                        or n in keep):
                    continue
                if victim is None or n.last_use < victim.last_use:
                    victim, victim_ns = n, ns
            if victim is None:
                break
            spilled = self._demote(victim_ns, victim)
            del victim.parent.children[victim.key]
            self.pool.free([victim.block],
                           cause="spill" if spilled else "lru")
            self.cached_blocks -= 1
            freed += 1
        return freed

    def clear(self, *, cause: str = "refdrop") -> None:
        """Drop the whole tree, returning every cached block to the pool:
        for when the pool's contents stop being trusted (a failed device
        call) or stop describing the model (a weight swap)."""
        blocks = []
        for root in self._roots.values():
            stack = list(root.children.values())
            while stack:
                n = stack.pop()
                blocks.append(n.block)
                stack.extend(n.children.values())
            root.children.clear()
        if blocks:
            self.pool.free(blocks, cause=cause)
        self.cached_blocks = 0

    # -- heat export -------------------------------------------------------

    def heat_digest(self, k: int = 16) -> list[dict]:
        """Top-`k` hottest prefixes by decayed score, named by 16-hex
        hashes of their first block, salted by namespace (no prompt
        tokens leave)."""
        t = self._clock
        ranked = sorted(((self._decayed(ent, t), ns, key)
                         for (ns, key), ent in self._heat.items()),
                        key=lambda x: x[0], reverse=True)
        return [
            {"prefix": prefix_hash(key, ns),
             "score": round(score, 4)}
            for score, ns, key in ranked[:max(0, int(k))]
            if score > 1e-9
        ]
