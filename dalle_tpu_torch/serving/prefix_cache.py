"""Prompt-prefix KV cache: scatter a cached text prefix, skip its prefill.

The port's copy of ``dalle_tpu/serving/prefix_cache.py`` on the port's
flat cache layout; ``prompt_fingerprint`` gives the same string as the
JAX package's for the same tokens (a router's prompt affinity spans
engines of both).

The 256-position text segment of the decode is teacher-forced — every
cache row in ``[0, text_seq_len)`` is a pure function of the prompt
tokens and the parameters, independent of sampling keys, co-tenants and
slot index (the engine's ragged-parity tests pin exactly this). So two
requests carrying the SAME prompt re-derive identical text KV, and under
millions-of-users traffic prompts are Zipf-distributed: trending and
duplicate prompts dominate. This pool keeps one device-resident copy of
the text-segment KV per distinct prompt; admission of a repeated prompt
scatters the cached rows into the slot and starts it at
``pos = text_seq_len`` — the whole text prefill (256 of 1280 decode
steps on the flagship) is skipped, and the decode that follows is
**bit-exact** to the cold path (same cache bytes, same RNG chain state,
same input token — pinned by ``tests/test_prefix_cache.py`` against the
cold engine AND ``generate_images`` solo, including recycled-slot and
co-tenant cases).

Accounting: entries are fixed-size (one slot's text rows across every
layer application — ``prefix_entry_bytes``), LRU-evicted under a byte
budget. When ``ServingConfig.kv_budget_mb`` is set the pool's budget is
RESERVED out of it (``SlotScheduler(reserved_bytes=...)``), so the
engine's total KV footprint stays under the one existing budget instead
of growing a second unaccounted pool.

Collision safety: the key is a SHA-256 prompt fingerprint, but a lookup
only hits when the STORED prompt tokens compare equal — a colliding (or
attacker-chosen) fingerprint degrades to a cache miss, never to serving
another prompt's prefix.

Thread model: ``lookup``/``insert`` run on the engine thread only (at
admission and harvest boundaries); ``stats`` may be read from HTTP
handler threads — the small mutations are lock-guarded.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from dalle_tpu_torch.config import ModelConfig


def prompt_fingerprint(text_tokens: np.ndarray) -> str:
    """Stable hex fingerprint of a prompt's token ids — the pool key
    AND the router's affinity key (``serving/router.py`` hashes the
    same bytes so duplicate prompts land on the engine already holding
    their prefix)."""
    arr = np.ascontiguousarray(np.asarray(text_tokens, np.int32))
    return hashlib.sha256(arr.tobytes()).hexdigest()


def prefix_entry_bytes(cfg: ModelConfig) -> int:
    """Bytes one pooled prefix entry occupies on device: the text-
    segment rows of every layer application's k/v pair for ONE slot —
    ``kv_bytes_per_slot`` scaled to the text fraction of the sequence
    (the cache stores (…, total_seq_len, heads*head_dim) rows, so the
    fraction is exact, not an estimate). The flagship's entry is
    67,108,864 B in bf16."""
    from dalle_tpu_torch.serving.scheduler import kv_bytes_per_slot

    per_slot = kv_bytes_per_slot(cfg)
    return int(per_slot * cfg.text_seq_len // cfg.total_seq_len)


def extract_prefix(cache: Dict[str, Any], slot: int, text_len: int
                   ) -> Dict[str, Any]:
    """One slot's text-segment KV rows as fresh tensors: (n_layers,
    text_len, H*d) k and v, cloned on the cache's device (the engine
    keeps decoding into the cache the moment this copy is enqueued; the
    copy runs first on the same stream)."""
    return {n: cache[n][:, slot, :text_len].clone() for n in ("k", "v")}


def scatter_prefix(cache: Dict[str, Any], slots, stacked: Dict[str, Any],
                   text_len: int) -> Dict[str, Any]:
    """Write ``k`` stacked prefix entries (see :func:`stack_entries`)
    into the cache rows ``[0, text_len)`` of ``slots`` (a (k,) index
    tensor), in place: the warm half of the engine's batched admission.
    Returns the cache."""
    for n in ("k", "v"):
        cache[n][:, slots, :text_len] = stacked[n]
    return cache


def stack_entries(entries) -> Dict[str, Any]:
    """Stack K pooled entries into the batched operand
    :func:`scatter_prefix` expects: (n_layers, K, text_len, H*d), the
    stack axis where the cache keeps its batch axis."""
    return {n: torch.stack([e[n] for e in entries], dim=1)
            for n in ("k", "v")}


class _Entry(NamedTuple):
    tokens: np.ndarray     # the exact prompt — compared on every lookup
    kv: Dict[str, Any]     # device tensors (one slot's text rows)


class PrefixCache:
    """LRU pool of device-resident text-prefix KV entries.

    ``budget_bytes`` bounds the pool (fixed ``entry_bytes`` per entry);
    inserting past it evicts least-recently-used entries first. An
    entry larger than the whole budget is refused — admission then
    simply stays on the cold path, which is always correct.
    """

    def __init__(self, entry_bytes: int, budget_bytes: int):
        if entry_bytes <= 0:
            raise ValueError(f"entry_bytes must be > 0, got {entry_bytes}")
        self.entry_bytes = int(entry_bytes)
        self.budget_bytes = int(budget_bytes)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._collisions = 0
        self._refused = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._entries

    def insertable(self) -> bool:
        """Whether ONE entry can ever fit the budget. The engine asks
        this BEFORE paying the prefix-extraction dispatch at harvest;
        a False answer counts as a refusal, so a pool too small to
        hold anything reports its refusals instead of looking healthy
        while silently dropping every insert."""
        if self.entry_bytes > self.budget_bytes:
            with self._lock:
                self._refused += 1
            return False
        return True

    def lookup(self, key: str, tokens: np.ndarray
               ) -> Optional[Dict[str, Any]]:
        """The entry's KV dict when ``key`` is pooled AND its stored
        prompt equals ``tokens`` (collision safety: a fingerprint match
        alone never serves another prompt's prefix). A hit refreshes
        LRU order. Counters here are the pool's own accounting; the
        engine's per-request hit/miss telemetry rides ServingMetrics."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self._misses += 1
                return None
            if not np.array_equal(entry.tokens, tokens):
                self._collisions += 1
                self._misses += 1
                return None
            self._entries.move_to_end(key)
            self._hits += 1
            return entry.kv

    def insert(self, key: str, tokens: np.ndarray,
               kv: Dict[str, Any]) -> bool:
        """Pool one prompt's prefix KV, evicting LRU entries until it
        fits. False (and nothing changes) when one entry exceeds the
        whole budget — the budget-full case degrades to cold prefill,
        never to an over-budget pool."""
        if self.entry_bytes > self.budget_bytes:
            with self._lock:
                self._refused += 1
            return False
        tokens = np.ascontiguousarray(np.asarray(tokens, np.int32))
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self._entries[key] = _Entry(tokens, kv)
                return True
            while ((len(self._entries) + 1) * self.entry_bytes
                   > self.budget_bytes and self._entries):
                self._entries.popitem(last=False)
                self._evictions += 1
            self._entries[key] = _Entry(tokens, kv)
            return True

    def evict(self, key: str) -> bool:
        """Drop one entry (tests exercise mid-flight eviction; a warm
        admission already dispatched keeps its device buffers alive
        through the enqueued reads — eviction only drops the pool's
        reference)."""
        with self._lock:
            if self._entries.pop(key, None) is None:
                return False
            self._evictions += 1
            return True

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "entry_bytes": self.entry_bytes,
                "budget_bytes": self.budget_bytes,
                "bytes": len(self._entries) * self.entry_bytes,
                "hits": self._hits,
                "misses": self._misses,
                "evictions": self._evictions,
                "collisions": self._collisions,
                "refused": self._refused,
            }
