"""
Persistent XLA compile-cache placement + compile-time attribution.

A fresh program shape costs seconds to minutes of XLA compile, and the
detection pipeline compiles one program per bank shape, so a persistent
cache makes every shape a one-time cost per machine instead of per process.

``enable()`` (called once at detex_tpu import) keeps the cache where
``JAX_COMPILATION_CACHE_DIR`` says when it is set (jax reads that variable
itself, and nothing else is configured in code); otherwise it points jax
at ``<checkout>/.jaxcache`` — a fixed path, because the path is part of
the cache key. Disable with ``DETEX_TPU_COMPILE_CACHE=0``.
"""
from __future__ import annotations

import os
import time
from collections import defaultdict

#: default cache directory: ``.jaxcache`` at the root of the checkout
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jaxcache")

#: module-name -> [count, total_seconds] of real backend compiles observed
#: by track_compiles() in this process (cache hits do NOT appear here).
COMPILES = defaultdict(lambda: [0, 0.0])

#: persistent-cache hits observed by track_compiles():
#: {"hits": n, "saved_s": compile seconds avoided, "retrieval_s": time
#: spent deserializing cached executables}
CACHE_HITS = {"hits": 0, "saved_s": 0.0, "retrieval_s": 0.0}

_tracking = False


def enable():
    """Turn on jax's persistent compilation cache. Returns the effective
    cache dir, or None when disabled. A directory already configured —
    through ``JAX_COMPILATION_CACHE_DIR`` or ``jax.config`` — is used as
    it is; otherwise :data:`DEFAULT_CACHE_DIR`."""
    if os.environ.get("DETEX_TPU_COMPILE_CACHE", "1") == "0":
        return None
    import jax
    from jax._src import config as _jcfg
    cur = _jcfg.compilation_cache_dir.value
    if cur:
        return cur
    try:
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    except Exception:  # pragma: no cover - never break import on a config
        return None
    return DEFAULT_CACHE_DIR


def track_compiles():
    """Instrument jax so every REAL backend compile (not cache hits) is
    timed into :data:`COMPILES` keyed by module name, and persistent-cache
    hits are counted into :data:`CACHE_HITS`. Idempotent: compile wall vs
    execution wall, per program."""
    global _tracking
    if _tracking:
        return
    _tracking = True
    from jax._src import compiler as _jcompiler

    orig = _jcompiler.backend_compile_and_load

    def timed(backend, module, *args, **kwargs):
        name = "?"
        try:
            from jax._src.lib.mlir import ir
            name = ir.StringAttr(
                module.operation.attributes["sym_name"]).value
        except Exception:
            pass
        t0 = time.perf_counter()
        try:
            return orig(backend, module, *args, **kwargs)
        finally:
            dt = time.perf_counter() - t0
            COMPILES[name][0] += 1
            COMPILES[name][1] += dt

    _jcompiler.backend_compile_and_load = timed

    try:
        from jax._src import monitoring as _mon

        def _listener(event, dur, **kw):
            if event == "/jax/compilation_cache/compile_time_saved_sec":
                CACHE_HITS["hits"] += 1
                CACHE_HITS["saved_s"] += float(dur)
            elif event == "/jax/compilation_cache/cache_retrieval_time_sec":
                CACHE_HITS["retrieval_s"] += float(dur)

        _mon.register_event_duration_secs_listener(_listener)
    except Exception:  # pragma: no cover
        pass


def compile_report():
    """(total_compiles, total_seconds, rows) where rows are
    (module_name, count, seconds) sorted by cost."""
    rows = sorted(((k, v[0], round(v[1], 2)) for k, v in COMPILES.items()),
                  key=lambda r: -r[2])
    total_n = sum(v[0] for v in COMPILES.values())
    total_s = sum(v[1] for v in COMPILES.values())
    return total_n, round(total_s, 2), rows
