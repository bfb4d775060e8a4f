"""Atomic JSON writes and file hashing (stdlib only).

A reader sees either the previous complete file or the new complete
file, never a torn write: tmp file in the same directory, then
``os.replace``. ``sha256_file`` is the manifest-integrity hash of the
serving corpus cache (``serve/corpus.py``).
"""

import hashlib
import json
import os

__all__ = ['write_json_atomic', 'sha256_file']


def sha256_file(path, chunk=1 << 20):
    """Chunked sha256 of one file."""
    h = hashlib.sha256()
    with open(path, 'rb') as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def write_json_atomic(path, payload, *, indent=None, sort_keys=False,
                      quiet=False, default=None):
    """Write ``payload`` as JSON to ``path`` via tmp+rename. Creates
    parent directories. With ``quiet=True`` an ``OSError`` is reported as
    a ``False`` return instead of raised (telemetry writers must never
    take the run down); ``default`` goes to ``json.dump``."""
    tmp = f'{path}.tmp.{os.getpid()}'
    try:
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
        with open(tmp, 'w') as f:
            json.dump(payload, f, indent=indent, sort_keys=sort_keys,
                      default=default)
        os.replace(tmp, path)
        return True
    except OSError:
        if quiet:
            return False
        raise
