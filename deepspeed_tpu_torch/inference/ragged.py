"""Ragged-batching state — counterpart of ``deepspeed_tpu/inference/
ragged.py``: refcounted blocked KV allocator with a prefix cache, sequence
descriptors, state manager.

Host-side Python, kept close to the JAX module line for line so the two
hand out the same block ids under the same operations.  One replica (the
2-D serve mesh's replica partitioning comes with the distributed layers;
other values raise), any number of seq-shard stripes: with
``seq_shards = S`` the pool splits into ``S`` contiguous stripes, one per
seq shard's slice of the device pool, and a sequence's chain round-robins
over them (chain position ``i`` lives on stripe ``i % S``).

Blocks are refcounted; FULL blocks carry a content key chained on their
parent block, a new prompt reuses any cached prefix run of matching blocks,
and refcount-0 keyed blocks retire to an LRU instead of the free list
(evicted only when allocation demands it).  The one device interaction is
the copy-on-write hook the engine installs so a shared page is cloned
before anyone writes into it.
"""
from __future__ import annotations

from collections import Counter, OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


def block_key(parent_block: Optional[int], tokens: Tuple[int, ...]):
    """Exact content key of one FULL KV block: the PARENT BLOCK's id (whose
    cached pages encode the whole preceding context) + this block's token
    window.  Dict lookup compares keys by full equality, so a false prefix
    match is impossible; evicting a parent therefore cascades to its cached
    descendants (their keys name a block id that may be reused)."""
    return (parent_block, tokens)


class BlockedAllocator:
    """Fixed pool of KV blocks: a refcounted free list plus an LRU of
    retired-but-cached blocks.

    Block lifecycle::

        free -> allocated (refcount 1) -> [shared: refcount k > 1]
             -> refcount 0 -> cached LRU (if it carries a content key)
                           -> free list (if unkeyed)
        cached LRU -> evicted (key dropped, descendants' keys cascade) when
                      ``allocate`` outruns the free list

    ``free_blocks`` counts only the free list; admission logic should use
    ``available_blocks`` (free + evictable cached).
    """

    def __init__(self, num_blocks: int, start: int = 0, stripes: int = 1):
        if num_blocks < 1:
            raise ValueError(f"need at least one block, got {num_blocks}")
        if stripes < 1 or num_blocks % stripes:
            raise ValueError(
                f"stripes ({stripes}) must be >= 1 and divide the pool "
                f"({num_blocks} blocks)")
        self._start = start
        self._num_blocks = num_blocks
        # ``stripes`` (seq-sharded serving): the pool splits into
        # ``stripes`` CONTIGUOUS sub-ranges -- stripe s owns global ids
        # [start + s*size, start + (s+1)*size) -- mirroring the device pool's
        # seq-shard slices, and ``allocate(first_pos=...)`` round-robins a
        # sequence's chain over them so chain position i's page lives on
        # seq shard i % stripes (a long sequence fits iff the AGGREGATE pool
        # fits it)
        self._stripes = stripes
        self._stripe_size = num_blocks // stripes
        self._free: List[List[int]] = [
            list(range(start + s * self._stripe_size, start + (s + 1) * self._stripe_size))
            for s in range(stripes)
        ]
        self._refs: List[int] = [0] * num_blocks  # indexed by (block - start)
        self._key_of: Dict[int, object] = {}  # block -> content key
        self._by_key: Dict[object, int] = {}  # content key -> block
        self._parent_of: Dict[int, int] = {}  # keyed block -> parent block
        self._children: Dict[int, set] = {}  # parent block -> keyed children
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # refcount-0 cached
        self.evictions = 0
        self.registrations = 0  # successful register() calls (cache version)

    @property
    def free_blocks(self) -> int:
        return sum(len(f) for f in self._free)

    @property
    def stripes(self) -> int:
        return self._stripes

    def stripe_of(self, block: int) -> int:
        """Which stripe (seq shard) owns ``block``."""
        self._check(block)
        return (block - self._start) // self._stripe_size

    def _push_free(self, block: int) -> None:
        self._free[(block - self._start) // self._stripe_size].append(block)

    @property
    def cached_blocks(self) -> int:
        return len(self._lru)

    @property
    def available_blocks(self) -> int:
        """Immediately allocatable: free lists + evictable cached blocks."""
        return self.free_blocks + len(self._lru)

    @property
    def total_blocks(self) -> int:
        return self._num_blocks

    def refcount(self, block: int) -> int:
        self._check(block)
        return self._refs[block - self._start]

    def _check(self, block: int) -> None:
        if not self._start <= block < self._start + self._num_blocks:
            raise ValueError(f"invalid block id {block}")

    def can_allocate(self, n: int, first_pos: int = 0, hold=()) -> bool:
        """Whether ``allocate(n, first_pos)`` would succeed.  Under striping
        aggregate headroom is NOT enough: run entry ``j`` must come from
        stripe ``(first_pos + j) % stripes``.  ``hold``: cached-LRU blocks
        an admission is about to revive, charged as unavailable."""
        held = set(hold)
        if self._stripes == 1:
            return n <= self.available_blocks - len(held & self._lru.keys())
        need = [0] * self._stripes
        for j in range(n):
            need[(first_pos + j) % self._stripes] += 1
        lru_per = [0] * self._stripes
        for b in self._lru:
            if b not in held:
                lru_per[(b - self._start) // self._stripe_size] += 1
        return all(len(self._free[s]) + lru_per[s] >= need[s]
                   for s in range(self._stripes))

    def allocate(self, n: int, first_pos: int = 0) -> List[int]:
        """Hand out ``n`` fresh blocks; run entry ``j`` comes from stripe
        ``(first_pos + j) % stripes`` (``first_pos``: the chain position of
        the run's first block; the identity at one stripe)."""
        if not self.can_allocate(n, first_pos):
            raise RuntimeError(
                f"cannot allocate {n} blocks ({self.available_blocks} available)"
            )
        out: List[int] = []
        for j in range(n):
            s = (first_pos + j) % self._stripes
            # LIFO: O(1), and recently-freed pages are the warmest
            b = self._free[s].pop() if self._free[s] else self._evict_one(s)
            self._refs[b - self._start] = 1
            out.append(b)
        return out

    def _evict_one(self, stripe: Optional[int] = None) -> int:
        """Drop the least-recently-used cached block (of ``stripe``, when
        the pool is striped), cascading its key AND every cached
        descendant's key."""
        if stripe is None or self._stripes == 1:
            b, _ = self._lru.popitem(last=False)
        else:
            b = next((x for x in self._lru
                      if (x - self._start) // self._stripe_size == stripe), None)
            if b is None:
                raise RuntimeError(f"no evictable blocks in stripe {stripe}")
            del self._lru[b]
        self._drop_key(b)
        self.evictions += 1
        return b

    def _drop_key(self, root: int) -> None:
        stack = [root]
        while stack:
            x = stack.pop()
            key = self._key_of.pop(x, None)
            if key is not None and self._by_key.get(key) == x:
                del self._by_key[key]
            p = self._parent_of.pop(x, None)
            if p is not None:
                self._children.get(p, set()).discard(x)
            stack.extend(self._children.pop(x, ()))
            # a de-keyed refcount-0 descendant is dead cache: straight to
            # the free list (the root itself is the caller's to hand out)
            if x != root and self._refs[x - self._start] == 0 and x in self._lru:
                del self._lru[x]
                self._push_free(x)

    def ref(self, block: int) -> None:
        """Take a reference on an allocated or cached block."""
        self._check(block)
        if self._refs[block - self._start] == 0:
            if block not in self._lru:
                raise ValueError(f"cannot ref free block {block}")
            del self._lru[block]  # revive from the cache
        self._refs[block - self._start] += 1

    def free(self, blocks: List[int]) -> None:
        """Drop one reference per block; the last reference retires the
        block to the cached LRU (keyed) or the free list (unkeyed)."""
        for b, n in Counter(blocks).items():
            self._check(b)
            # duplicates within THIS call count too (free([b, b]) at
            # refcount 1 must not drive the refcount negative)
            if self._refs[b - self._start] < n:
                raise ValueError(f"double free of block {b}")
        for b in blocks:
            self._refs[b - self._start] -= 1
            if self._refs[b - self._start] == 0:
                if b in self._key_of:
                    self._lru[b] = None
                    self._lru.move_to_end(b)
                else:
                    self._push_free(b)

    def register(self, block: int, key, parent: Optional[int] = None) -> bool:
        """Publish ``block`` as holding the content ``key`` (a FULL block),
        chained under ``parent`` for eviction cascading.  First writer wins."""
        self._check(block)
        if self._refs[block - self._start] <= 0:
            raise ValueError(f"cannot register unowned block {block}")
        if block in self._key_of or key in self._by_key:
            return False
        self._key_of[block] = key
        self._by_key[key] = block
        if parent is not None:
            self._parent_of[block] = parent
            self._children.setdefault(parent, set()).add(block)
        self.registrations += 1
        return True

    def key_of(self, block: int):
        """The published content key of ``block`` (None if unkeyed)."""
        return self._key_of.get(block)

    def invalidate(self, block: int) -> None:
        """Retract ``block``'s content key (cascading like eviction) WITHOUT
        touching refcounts — the quarantine path for suspect content."""
        self._check(block)
        self._drop_key(block)
        if self._refs[block - self._start] == 0 and block in self._lru:
            del self._lru[block]
            self._push_free(block)

    def lookup(self, key) -> Optional[int]:
        """Block currently holding content ``key`` (caller must ``ref`` it)."""
        return self._by_key.get(key)

    def audit(self) -> None:
        """Invariant check: every block is in exactly one of {free, cached
        LRU, active (refcount > 0)} and the key maps agree.  Raises
        ``RuntimeError`` on a violation."""
        def expect(cond, msg):
            if not cond:
                raise RuntimeError(f"allocator audit: {msg}")

        owned = set(range(self._start, self._start + self._num_blocks))
        for s, fl in enumerate(self._free):
            for b in fl:
                expect((b - self._start) // self._stripe_size == s,
                       f"block {b} on stripe {s}'s free list but owned by stripe "
                       f"{(b - self._start) // self._stripe_size}")
        free = {b for fl in self._free for b in fl}
        lru = set(self._lru)
        active = {b for b in owned if self._refs[b - self._start] > 0}
        expect(len(free) == self.free_blocks, "duplicate free-list entries")
        expect(not (free & lru), f"free/lru overlap: {free & lru}")
        expect(not (free & active), f"free/active overlap: {free & active}")
        expect(not (lru & active), f"lru/active overlap: {lru & active}")
        expect(free | lru | active == owned, "leaked blocks")
        for b, key in self._key_of.items():
            expect(self._by_key.get(key) == b, f"key map of block {b}")
        for key, b in self._by_key.items():
            expect(self._key_of.get(b) == key, f"reverse key map of block {b}")
        expect(lru <= set(self._key_of), "unkeyed block in LRU")
        for p, kids in self._children.items():
            for c in kids:
                expect(self._parent_of.get(c) == p and c in self._key_of,
                       f"child {c} of {p}")


@dataclass
class SequenceDescriptor:
    """Tracked state of one generation request."""

    uid: int
    slot: int  # row in the engine's static batch tensors
    blocks: List[int] = field(default_factory=list)
    seen_tokens: int = 0  # tokens whose KV is already in the cache
    tokens: List[int] = field(default_factory=list)  # full token history
    done: bool = False
    cached_tokens: int = 0  # prefix tokens served from the block cache
    hashes: List[object] = field(default_factory=list)  # chained full-block keys
    # speculative decoding (engine_v2 drives these): the accept-rate EMA
    # sets the per-sequence draft cap; a sequence throttled to 0 decodes
    # plainly and re-probes after spec_cooldown ticks
    spec_draft_len: int = -1  # current draft cap; -1 = unset (engine max)
    spec_ema: float = 1.0  # accept-rate EMA (optimistic start)
    spec_cooldown: int = 0  # plain-decode ticks left before a re-probe
    spec_drafted: int = 0  # lifetime drafted tokens
    spec_accepted: int = 0  # lifetime accepted tokens
    # set when this sequence's forward produced non-finite logits (the
    # finite_guard sentinel); the scheduler turns it into a FAILED request
    error: Optional[str] = None

    @property
    def cur_len(self) -> int:
        return len(self.tokens)


class StateManager:
    """Owns the allocator + uid->descriptor map and the block arithmetic.

    With ``enable_prefix_caching`` it also drives the reuse layer: ``admit``
    matches the prompt's leading FULL blocks against the allocator's key
    table, ``update_hashes`` publishes blocks as they fill, and
    ``ensure_writable`` copy-on-writes a shared block before a sequence
    writes into it (``cow_hook(src, dst)``, installed by the engine, copies
    the device page).
    """

    def __init__(self, num_blocks: int, block_size: int, max_seqs: int,
                 enable_prefix_caching: bool = False, replicas: int = 1,
                 seq_shards: int = 1):
        if replicas != 1:
            raise NotImplementedError(
                "replica-partitioned pools are not ported yet (ROADMAP queue 1 item 7)")
        # ``seq_shards``: the pool stripes into ``seq_shards`` contiguous
        # sub-ranges and a sequence's chain round-robins across them --
        # stripe s is exactly seq shard s's slice of the device pool, so the
        # attention's global -> local block-id translation needs no host help
        if seq_shards < 1:
            raise ValueError(f"seq_shards must be >= 1, got {seq_shards}")
        if num_blocks % seq_shards:
            raise ValueError(
                f"each replica's pool ({num_blocks} blocks) must divide into "
                f"{seq_shards} seq shards")
        self.block_size = block_size
        self.replicas = 1
        self.seq_shards = seq_shards
        self.allocator = BlockedAllocator(num_blocks, stripes=seq_shards)
        self.allocators = [self.allocator]
        self.max_seqs = max_seqs
        self.seqs: Dict[int, SequenceDescriptor] = {}
        self._slots = list(range(max_seqs))
        self.enable_prefix_caching = enable_prefix_caching
        self.cow_hook: Optional[Callable[[int, int], None]] = None
        # chaos-harness hook (inference/faults.py FaultInjector): when set,
        # ``ensure_capacity`` consults the ``alloc_exhaustion`` point before
        # touching the pool
        self.faults = None
        self.prompt_tokens_total = 0
        self.cached_prompt_tokens = 0
        self.cow_copies = 0

    @property
    def free_slots(self) -> int:
        return len(self._slots)

    def per_replica_token_budget(self, total: int) -> int:
        """Per-replica share of a shared token budget: the whole of it on
        one replica."""
        return total

    def replica_of(self, seq: SequenceDescriptor) -> int:
        return 0

    def _alloc_of(self, seq: SequenceDescriptor) -> BlockedAllocator:
        return self.allocator

    def _walk_chain(self, tokens):
        """THE content-chain walk: yield ``(key, block)`` for each cached
        FULL leading block of ``tokens``, chaining each key on the matched
        parent block, capped at ``(len - 1) // block_size`` (the final
        prompt token always recomputes)."""
        bs = self.block_size
        parent: Optional[int] = None
        for i in range((len(tokens) - 1) // bs):
            key = block_key(parent, tuple(
                int(t) for t in tokens[i * bs:(i + 1) * bs]))
            b = self.allocator.lookup(key)
            if b is None:
                return
            yield key, b
            parent = b

    def _probe_match(self, tokens) -> Tuple[int, List[int]]:
        """Non-mutating probe: ``(matched_blocks, lru_blocks)`` where
        ``lru_blocks`` are matched blocks parked refcount-0 in the LRU
        (admitting revives them OUT of the available pool)."""
        matched = 0
        lru: List[int] = []
        for _key, b in self._walk_chain(tokens):
            matched += 1
            if self.allocator.refcount(b) == 0:
                lru.append(b)
        return matched, lru

    def can_admit_all(self, prompt_lens, token_lists=None) -> bool:
        """Whether ALL prompts can be admitted together: a greedy simulation
        of sequential admission.  ``token_lists`` lets the simulation credit
        prefix-matched blocks the way ``admit`` will (matched LRU blocks
        charged once)."""
        slots = self.free_slots
        avail = self.allocator.available_blocks
        probe = self.enable_prefix_caching and token_lists is not None
        revived: set = set()
        for i, n in enumerate(prompt_lens):
            if not slots:
                return False
            blocks = -(-int(n) // self.block_size)
            matched, lru = (self._probe_match(token_lists[i]) if probe
                            else (0, []))
            fresh_lru = [b for b in lru if b not in revived]
            need = (blocks - matched) + len(fresh_lru)
            # the running total catches cross-admission pressure; the
            # per-stripe probe (against the CURRENT state) a full stripe
            # hiding behind aggregate headroom
            if avail < need or not self.allocator.can_allocate(
                    blocks - matched, first_pos=matched, hold=fresh_lru):
                return False
            slots -= 1
            avail -= need
            revived.update(fresh_lru)
        return True

    def blocks_needed(self, seq: SequenceDescriptor, new_tokens: int) -> int:
        have = len(seq.blocks) * self.block_size
        need = seq.cur_len + new_tokens
        return max(0, -(-(need - have) // self.block_size))

    def can_admit(self, prompt_len: int, tokens=None) -> bool:
        if not self.free_slots:
            return False
        matched, lru = (self._probe_match(tokens)
                        if self.enable_prefix_caching and tokens is not None
                        else (0, []))
        blocks = -(-prompt_len // self.block_size)
        # fresh blocks land at chain positions matched..blocks-1, each in
        # its own stripe
        return self.allocator.can_allocate(blocks - matched, first_pos=matched, hold=lru)

    def _match_prefix(self, tokens: List[int]) -> Tuple[List[int], List[object]]:
        """Longest cached run of FULL leading blocks for ``tokens``, each
        taken by reference."""
        blocks: List[int] = []
        keys: List[object] = []
        for key, b in self._walk_chain(tokens):
            self.allocator.ref(b)
            blocks.append(b)
            keys.append(key)
        return blocks, keys

    def admit(self, uid: int, prompt_tokens: List[int],
              match_prefix: bool = True) -> SequenceDescriptor:
        """Track a new sequence (pages are reserved by ``ensure_capacity``)."""
        if uid in self.seqs:
            raise ValueError(f"uid {uid} already tracked")
        if not self._slots:
            raise RuntimeError("no free sequence slots")
        seq = SequenceDescriptor(uid=uid, slot=self._slots.pop(0))
        seq.tokens = list(prompt_tokens)
        if self.enable_prefix_caching and match_prefix:
            seq.blocks, seq.hashes = self._match_prefix(seq.tokens)
            seq.cached_tokens = len(seq.blocks) * self.block_size
            seq.seen_tokens = seq.cached_tokens
            self.cached_prompt_tokens += seq.cached_tokens
        self.prompt_tokens_total += len(seq.tokens)
        self.seqs[uid] = seq
        return seq

    def ensure_capacity(self, seq: SequenceDescriptor, new_tokens: int) -> None:
        n = self.blocks_needed(seq, new_tokens)
        if n:
            if self.faults is not None:
                # only growth consults the injector: a no-growth call stays
                # infallible (retry loops rely on it converging)
                self.faults.maybe_raise("alloc_exhaustion", uids=(seq.uid,))
            seq.blocks.extend(self.allocator.allocate(n, first_pos=len(seq.blocks)))

    def ensure_writable(self, seq: SequenceDescriptor, pos: int) -> None:
        """Copy-on-write guard: the page holding token position ``pos`` must
        be exclusively owned before it is written."""
        i = pos // self.block_size
        if i >= len(seq.blocks):
            return
        b = seq.blocks[i]
        if self.allocator.refcount(b) <= 1:
            return
        [new] = self.allocator.allocate(1, first_pos=i)  # stay in position i's stripe
        if self.cow_hook is not None:
            self.cow_hook(b, new)
        self.allocator.free([b])
        seq.blocks[i] = new
        del seq.hashes[i:]  # content diverges from the published chain here
        self.cow_copies += 1

    def truncate_to_length(self, seq: SequenceDescriptor,
                           n_tokens: Optional[int] = None) -> int:
        """Free the block tail beyond what ``n_tokens`` (default: the
        sequence's current length) needs — the speculative rollback: a
        verify tick reserves pages for all k + 1 pack rows, and the pages
        of rejected drafts come back here.  Freeing drops one reference per
        block (``free``), so a shared or prefix-cached tail block keeps its
        other owners, its cache entry and the published chains of kept
        blocks; the sequence's own hash list is clipped to the kept range.
        Returns blocks freed."""
        if n_tokens is None:
            n_tokens = seq.cur_len
        keep = -(-n_tokens // self.block_size)
        if len(seq.blocks) <= keep:
            return 0
        tail = seq.blocks[keep:]
        del seq.blocks[keep:]
        del seq.hashes[keep:]
        self.allocator.free(tail)
        return len(tail)

    def extend_match(self, seq: SequenceDescriptor) -> None:
        """Late re-match: blocks published AFTER this sequence was admitted
        replace its corresponding still-unwritten fresh pages (only while
        the hash chain is flush with prefill progress)."""
        if not self.enable_prefix_caching:
            return
        alloc = self.allocator
        bs = self.block_size
        cap = (len(seq.tokens) - 1) // bs
        while seq.seen_tokens == len(seq.hashes) * bs:
            i = len(seq.hashes)
            if i >= cap or i >= len(seq.blocks):
                break
            parent = seq.blocks[i - 1] if i else None
            key = block_key(parent, tuple(seq.tokens[i * bs:(i + 1) * bs]))
            b = alloc.lookup(key)
            if b is None:
                break
            old = seq.blocks[i]
            alloc.ref(b)
            seq.blocks[i] = b
            alloc.free([old])
            seq.hashes.append(key)
            seq.seen_tokens = (i + 1) * bs
            seq.cached_tokens = seq.seen_tokens
            self.cached_prompt_tokens += bs

    def update_hashes(self, seq: SequenceDescriptor) -> None:
        """Publish every newly-FULL block of ``seq`` whose KV is written
        (``seen_tokens``), prompt and generated alike."""
        if not self.enable_prefix_caching:
            return
        alloc = self.allocator
        bs = self.block_size
        full = min(seq.seen_tokens, len(seq.blocks) * bs) // bs
        while len(seq.hashes) < full:
            i = len(seq.hashes)
            parent = seq.blocks[i - 1] if i else None
            key = block_key(parent, tuple(seq.tokens[i * bs:(i + 1) * bs]))
            seq.hashes.append(key)
            # register only canonical chains: a child key naming a parent
            # that lost its key would dangle once the parent id is reused
            if parent is None or alloc.key_of(parent) is not None:
                alloc.register(seq.blocks[i], key, parent=parent)

    def quarantine_written(self, seq: SequenceDescriptor) -> None:
        """Retract the prefix-cache keys of every block SEQ ITSELF wrote and
        published — its KV came from a forward with non-finite logits."""
        if not self.enable_prefix_caching:
            return
        first_own = seq.cached_tokens // self.block_size
        for i in range(first_own, min(len(seq.hashes), len(seq.blocks))):
            b = seq.blocks[i]
            if self.allocator.key_of(b) == seq.hashes[i]:
                self.allocator.invalidate(b)

    def hit_stats_snapshot(self) -> tuple:
        """The hit-rate counters as one value, for rollback of a tentative
        admission."""
        return (self.prompt_tokens_total, self.cached_prompt_tokens)

    def hit_stats_restore(self, snap: tuple) -> None:
        self.prompt_tokens_total, self.cached_prompt_tokens = snap

    def replica_stats(self) -> List[Dict[str, float]]:
        """Per-replica serving-health rows (JAX ``replica_stats``; one row
        here, the pool being one replica): pool occupancy and the
        prefix-hit split."""
        a = self.allocator
        pt, ct = self.prompt_tokens_total, self.cached_prompt_tokens
        return [dict(
            free_blocks=a.free_blocks,
            cached_blocks=a.cached_blocks,
            available_blocks=a.available_blocks,
            total_blocks=a.total_blocks,
            free_slots=len(self._slots),
            prompt_tokens=pt,
            cached_prompt_tokens=ct,
            prefix_hit_rate=(ct / pt if pt else 0.0),
            headroom=a.available_blocks / a.total_blocks,
        )]

    def release(self, uid: int) -> None:
        seq = self.seqs.pop(uid)
        if seq.blocks:
            self.allocator.free(seq.blocks)
        self._slots.append(seq.slot)

    @property
    def active(self) -> List[SequenceDescriptor]:
        return sorted(self.seqs.values(), key=lambda s: s.slot)
