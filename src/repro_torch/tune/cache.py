"""Persistent plan cache: JSON on disk + an in-memory LRU layer
(counterpart of ``repro.tune.cache``).

One file per (schema version, chip spec, backend) under
``~/.cache/repro-tune/`` (``REPRO_TUNE_CACHE`` relocates it).  In the port
the backend names what a measurement depends on: the card's name, the torch
version and the CUDA version (``tuner._backend_key``).  The schema version is
stamped into the filename *and* the payload; a mismatched or corrupt file
is ignored and rebuilt.  Writes are atomic (tempfile + ``os.replace``).
"""
from __future__ import annotations

import collections
import json
import os
import re
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

SCHEMA_VERSION = 1

_LRU_CAPACITY = 1024


def cache_dir() -> Path:
    env = os.environ.get("REPRO_TUNE_CACHE")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro-tune"


def _cache_file(chip: str, backend: str) -> Path:
    safe = re.sub(r"[^A-Za-z0-9.+_-]+", "_", f"{chip}-{backend}")
    return cache_dir() / f"plans-v{SCHEMA_VERSION}-{safe}.json"


class PlanCache:
    """LRU-fronted, disk-backed plan store for one (chip, backend) pair."""

    def __init__(self, chip: str, backend: str,
                 capacity: int = _LRU_CAPACITY):
        self.chip = chip
        self.backend = backend
        self.capacity = capacity
        self._lock = threading.Lock()
        self._mem: "collections.OrderedDict[str, Dict]" = \
            collections.OrderedDict()
        self._disk: Optional[Dict[str, Dict]] = None   # lazy-loaded

    @property
    def path(self) -> Path:
        return _cache_file(self.chip, self.backend)

    def _load_disk(self) -> Dict[str, Dict]:
        if self._disk is not None:
            return self._disk
        data: Dict[str, Dict] = {}
        try:
            raw = json.loads(self.path.read_text())
            if (isinstance(raw, dict)
                    and raw.get("version") == SCHEMA_VERSION
                    and raw.get("backend") == self.backend
                    and isinstance(raw.get("plans"), dict)):
                data = raw["plans"]
        except (OSError, ValueError):
            pass                       # missing/corrupt/foreign -> rebuild
        self._disk = data
        return data

    def _write_disk(self) -> None:
        path = self.path
        payload = {"version": SCHEMA_VERSION, "chip": self.chip,
                   "backend": self.backend, "plans": self._disk or {}}
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                                       prefix=path.name, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=0, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            pass                       # read-only FS: memory layer still works

    def get(self, key: str) -> Optional[Dict]:
        with self._lock:
            if key in self._mem:
                self._mem.move_to_end(key)
                return self._mem[key]
            entry = self._load_disk().get(key)
            if entry is not None:
                self._mem[key] = entry
                while len(self._mem) > self.capacity:
                    self._mem.popitem(last=False)
            return entry

    def put(self, key: str, entry: Dict, persist: bool = True) -> None:
        with self._lock:
            self._mem[key] = entry
            self._mem.move_to_end(key)
            while len(self._mem) > self.capacity:
                self._mem.popitem(last=False)
            if persist:
                self._load_disk()[key] = entry
                self._write_disk()


_CACHES: Dict[tuple, PlanCache] = {}
_CACHES_LOCK = threading.Lock()
#: The plans ``tuner.matmul_plan`` returned in this process, by (mode,
#: chip, cache directory, key): a second call with the same key scores no
#: candidate.
PLANS: Dict[tuple, object] = {}


def plan_cache(chip: str, backend: str) -> PlanCache:
    """The process-wide cache for (chip, backend), keyed also on the cache
    directory so a repointed ``REPRO_TUNE_CACHE`` gets a fresh one."""
    key = (str(cache_dir()), chip, backend)
    with _CACHES_LOCK:
        if key not in _CACHES:
            _CACHES[key] = PlanCache(chip, backend)
        return _CACHES[key]


def clear_plan_cache(disk: bool = False) -> None:
    """Drop every in-memory cache and the process's plans; ``disk=True``
    also deletes cache files."""
    with _CACHES_LOCK:
        _CACHES.clear()
        PLANS.clear()
    if disk:
        d = cache_dir()
        if d.is_dir():
            for f in d.glob(f"plans-v{SCHEMA_VERSION}-*.json"):
                try:
                    f.unlink()
                except OSError:
                    pass
