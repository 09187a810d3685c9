"""Process-level cache of built matcher programs, shared across matchers.

The counterpart of ``kafkastreams_cep_tpu/utils/tracecache.py``, with the
same interface and behaviour.  The JAX package caches traced and jitted
programs; this package jits nothing, so it caches what a rebuilt matcher
would otherwise build again: the step phases ``BatchMatcher`` compiles
(the pattern's tables and predicate plan placed on the device,
``engine/matcher.py: _build_step``), the whole-scan sources generated for
the pattern (``ops/scan_codegen.py``; the loaded kernel libraries behind
them stay in ``ops/scan_kernel.py``'s own table, keyed by source hash),
and the tenant bank's group programs and shared screen.  The sweep and
the step and drain closures are plain functions made in microseconds:
nothing of theirs is cached.  Tests,
supervisor recoveries, escalations and restores rebuild matchers for
patterns the process has already built; a hit costs a dict lookup.

Builders register their result under a *structural* key: the pattern
tables' fingerprint (``compiler/multitenant.py: tables_key``), the engine
config, the device and whatever mode selects the variant.  Equal keys
build equal programs, so the cached objects are shared verbatim.
Unkeyable patterns (``tables_key`` returns None) bypass the cache and
behave exactly as before.

``CEP_TRACE_CACHE`` controls it: unset/``1`` = on (default capacity 4096
entries, LRU), ``0``/``off`` = disabled, any integer = capacity.  The
capacity must exceed the process's working set of distinct programs: an
LRU swept by a working set slightly over capacity misses on every use.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any, Callable, Hashable, Optional

_DEFAULT_CAPACITY = 4096

_lock = threading.Lock()
_store: "OrderedDict[Hashable, Any]" = OrderedDict()
_hits = 0
_misses = 0
_evictions = 0


def capacity() -> int:
    """Configured entry capacity; 0 disables the cache entirely."""
    raw = os.environ.get("CEP_TRACE_CACHE", "").strip().lower()
    if raw in ("", "1", "on", "true"):
        return _DEFAULT_CAPACITY
    if raw in ("0", "off", "false"):
        return 0
    try:
        return max(int(raw), 0)
    except ValueError:
        return _DEFAULT_CAPACITY


def lookup(
    namespace: str, key: Optional[Hashable], build: Callable[[], Any]
) -> Any:
    """``build()``'s result cached under ``(namespace, key)``.

    ``key=None`` (an unkeyable pattern) or a disabled cache calls
    ``build()`` uncached.  LRU eviction keeps at most :func:`capacity`
    entries alive; evicted entries simply fall back to garbage
    collection like any un-cached matcher's programs.
    """
    global _hits, _misses, _evictions
    cap = capacity()
    if key is None or cap == 0:
        return build()
    full = (namespace, key)
    with _lock:
        if full in _store:
            _store.move_to_end(full)
            _hits += 1
            return _store[full]
    value = build()  # outside the lock: builds may be seconds long
    with _lock:
        if full not in _store:
            _misses += 1
            _store[full] = value
            while len(_store) > cap:
                _store.popitem(last=False)
                _evictions += 1
        _store.move_to_end(full)
        return _store[full]


def stats() -> dict:
    with _lock:
        return {
            "entries": len(_store),
            "hits": _hits,
            "misses": _misses,
            "evictions": _evictions,
            "capacity": capacity(),
        }


def clear() -> None:
    """Drop every cached program (tests; never needed in production)."""
    global _hits, _misses, _evictions
    with _lock:
        _store.clear()
        _hits = 0
        _misses = 0
        _evictions = 0
