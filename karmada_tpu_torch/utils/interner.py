"""String interning: the bridge between the host object model and device
arrays. Device code never sees strings — only stable int32 ids. Id 0 is
reserved for "absent"; ids are assigned in first-seen order so encodings are
deterministic for a given event sequence.
"""
from __future__ import annotations

import threading


class Interner:
    NONE = 0

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ids: dict[str, int] = {}
        self._strs: list[str] = [""]

    def id(self, s: str) -> int:
        if not s:
            return self.NONE
        with self._lock:
            i = self._ids.get(s)
            if i is None:
                i = len(self._strs)
                self._ids[s] = i
                self._strs.append(s)
            return i

    def lookup(self, i: int) -> str:
        return self._strs[i]

    def peek(self, s: str):
        """Id of `s` if already interned, else None — never inserts (the
        dirty-column fleet refresh must detect out-of-vocabulary strings
        instead of growing the vocabulary mid-update)."""
        if not s:
            return self.NONE
        with self._lock:
            return self._ids.get(s)

    def ids(self, strs) -> list[int]:
        return [self.id(s) for s in strs]

    def strings(self) -> list[str]:
        """Copy of the dictionary, id-ordered (index == id). Taken under
        the lock so a concurrent insert cannot tear the snapshot — the
        search plane's publish path materializes this as the vectorized
        substring-match dictionary."""
        with self._lock:
            return list(self._strs)

    def __len__(self) -> int:
        return len(self._strs)
