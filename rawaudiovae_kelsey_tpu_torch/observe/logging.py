"""Console logging utilities.

``Tee`` mirrors the streaming trainer's stdout capture
(train_iterable.py:117-133): everything printed goes to the console and to
``<workdir>/console_log``.
"""

from __future__ import annotations

import sys
from pathlib import Path


class Tee:
    def __init__(self, path: Path, stream=None):
        self._file = open(path, "a", buffering=1)
        self._stream = sys.stdout if stream is None else stream

    def write(self, data: str) -> int:
        self._stream.write(data)
        self._file.write(data)
        return len(data)

    def flush(self) -> None:
        self._stream.flush()
        self._file.flush()

    def close(self) -> None:
        self._file.close()

    def __getattr__(self, name):
        # full stream stand-in: libraries probe sys.stdout for isatty/
        # fileno/encoding/buffer while we're installed as stdout — delegate
        # anything we don't override to the wrapped stream
        return getattr(self._stream, name)


class tee_stdout:
    """Context manager: ``with tee_stdout(path): ...`` routes stdout to both
    the console and the file, restoring stdout on exit (the reference restored
    it manually at train_iterable.py:327-329)."""

    def __init__(self, path: Path):
        self.path = Path(path)

    def __enter__(self):
        self._orig = sys.stdout
        self._tee = Tee(self.path, self._orig)
        sys.stdout = self._tee
        return self._tee

    def __exit__(self, *exc):
        sys.stdout = self._orig
        self._tee.close()
        return False
