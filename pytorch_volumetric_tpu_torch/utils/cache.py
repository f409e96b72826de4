"""Content-keyed on-disk caches (``.npz``).

The same file format and key scheme as the JAX package's store, so a cache
written by either package loads in the other: values are host numpy arrays
in one ``.npz`` per store, each logical key maps to arrays ``{slug}/0``,
``{slug}/1``, ... plus a count ``{slug}/n``.
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

_LOCK = threading.Lock()


def _slug(key: str) -> str:
    """npz member names must be file-name safe; hash long/with-space keys."""
    h = hashlib.sha1(key.encode()).hexdigest()[:16]
    safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in key)[:80]
    return f"{safe}__{h}"


class NpzStore:
    """A tiny multi-array key-value store in one ``.npz`` file.

    Reads are cached in memory; writes rewrite the file atomically.
    """

    def __init__(self, path: str):
        self.path = path
        self._data: Optional[Dict[str, np.ndarray]] = None

    def _load(self) -> Dict[str, np.ndarray]:
        # callers hold _LOCK
        if self._data is None:
            if os.path.exists(self.path):
                with np.load(self.path, allow_pickle=False) as z:
                    self._data = {k: z[k] for k in z.files}
            else:
                self._data = {}
        return self._data

    def get(self, key: str) -> Optional[Tuple[np.ndarray, ...]]:
        with _LOCK:
            data = self._load()
            slug = _slug(key)
            n_key = f"{slug}/n"
            if n_key not in data:
                return None
            n = int(data[n_key])
            return tuple(data[f"{slug}/{i}"] for i in range(n))

    def _write(self, data: Dict[str, np.ndarray]) -> None:
        tmp = self.path + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        # uncompressed: SDF grids are float noise and compress poorly
        with open(tmp, "wb") as f:
            np.savez(f, **data)
        os.replace(tmp, self.path)

    def put(self, key: str, arrays: Sequence[np.ndarray]) -> None:
        with _LOCK:
            data = self._load()
            slug = _slug(key)
            data[f"{slug}/n"] = np.asarray(len(arrays))
            for i, a in enumerate(arrays):
                data[f"{slug}/{i}"] = np.asarray(a)
            self._write(data)

    def delete(self, key: str) -> None:
        with _LOCK:
            data = self._load()
            slug = _slug(key)
            stale = [k for k in data if k.startswith(slug + "/")]
            for k in stale:
                del data[k]
            if stale:
                self._write(data)


_STORES: Dict[str, NpzStore] = {}


def get_store(path: str) -> NpzStore:
    path = os.path.abspath(path)
    with _LOCK:
        if path not in _STORES:
            _STORES[path] = NpzStore(path)
        return _STORES[path]
