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


def write_json_atomic(path, payload, *, indent=None, sort_keys=False):
    """Write ``payload`` as JSON to ``path`` via tmp+rename. Creates
    parent directories."""
    tmp = f'{path}.tmp.{os.getpid()}'
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    with open(tmp, 'w') as f:
        json.dump(payload, f, indent=indent, sort_keys=sort_keys)
    os.replace(tmp, path)
