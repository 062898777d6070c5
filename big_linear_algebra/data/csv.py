"""Reference-format CSV IO (≈ lib/csv.c).

Format contract (lib/csv.c:7-16,40-52,59-70; SURVEY.md §7.12):
- reading: a ',' always terminates a value (an empty token is the value 0.0);
  a newline terminates a value only when characters were accumulated; '\\r' is
  ignored. This accepts both the reference's trailing-comma files and standard
  CSVs (where the reference would drop/overflow the last value of each line —
  intended-semantics deviation: we also accept an EOF-terminated last value).
- writing: every value is rendered ``%f`` (6 decimals) followed by ',', with a
  newline after every ``cols`` values — byte-compatible with the reference
  writer so its models can load our checkpoints and vice versa.

A native C++ fast path (native/bla_io.cc via ctypes) handles large files
(~100 MB MNIST CSVs); the pure-Python fallback implements the identical
contract.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from big_linear_algebra.data import _native

_TOKEN_RE = re.compile(r"[^,\n]*,|[^,\n]+\n|[^,\n]+$")
# strtof-style numeric prefix: optional sign, digits/decimal, exponent,
# or inf/nan — used so the Python fallback parses malformed tokens exactly
# like the native path's strtof (leading numeric prefix, else 0.0)
_FLOAT_PREFIX_RE = re.compile(
    r"^[ \t]*[+-]?(?:inf(?:inity)?|nan|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)",
    re.IGNORECASE)


def _parse_token(tok: str) -> float:
    """strtof semantics (matches native/bla_io.cc:38): parse the leading
    numeric prefix; non-numeric tokens are the value 0.0, never an error.
    Tokens longer than 63 chars are truncated like the native 64-byte
    buffer."""
    tok = tok[:63]
    try:
        return float(tok)
    except ValueError:
        m = _FLOAT_PREFIX_RE.match(tok)
        return float(m.group(0)) if m else 0.0


def _py_read_values(path: str) -> np.ndarray:
    text = Path(path).read_text().replace("\r", "")
    values = []
    for m in _TOKEN_RE.finditer(text):
        tok = m.group(0).rstrip(",\n")
        values.append(_parse_token(tok) if tok else 0.0)
    return np.asarray(values, dtype=np.float32)


def read_csv_values(path: str) -> np.ndarray:
    """All CSV values in file order as a flat float32 array.
    ≈ ``read_csv_contents`` (lib/csv.c:18)."""
    out = _native.csv_read(str(path))
    if out is None:
        out = _py_read_values(str(path))
    return out


def read_csv_matrix(path: str, rows: int, cols: int,
                    dtype=np.float32, exact: bool = False) -> np.ndarray:
    """First rows*cols CSV values as a (rows, cols) matrix.
    ≈ ``load_matrix_from_csv`` (lib/util.c:57), which widens the float CSV
    values into the compute dtype and reads only what it needs (extra
    file content ignored — reference semantics, the default here).

    ``exact=True``: ALSO error when the file holds more values than the
    expected shape. Checkpoint loaders with more than one possible config
    use this — silently reinterpreting the prefix of a full-size weight
    file as a smaller config's weights loads garbage (and a subsequent
    save would destroy the larger checkpoint)."""
    values = read_csv_values(path)
    need = rows * cols
    if values.size < need:
        raise ValueError(
            f"{path}: expected at least {need} values, found {values.size}"
        )
    if exact and values.size != need:
        raise ValueError(
            f"{path}: expected exactly {need} values ({rows}x{cols}), "
            f"found {values.size} — the checkpoint was written by a "
            f"different model configuration")
    return values[:need].reshape(rows, cols).astype(dtype)


def write_csv_matrix(path: str, array: np.ndarray) -> None:
    """Write in the reference format (``%f,`` per value, newline per row).
    ≈ ``write_csv_contents`` (lib/csv.c:59). Values are written float32, the
    reference checkpoint precision (model/mnist_nn.c:344-369)."""
    arr = np.ascontiguousarray(array, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr.reshape(1, -1)
    if arr.ndim != 2:
        raise ValueError(f"write_csv_matrix expects 1-D/2-D, got {array.shape}")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    if _native.csv_write(str(path), arr):
        return
    with open(path, "w") as f:
        for row in arr:
            f.write("".join(f"{v:f}," for v in row) + "\n")


def count_num_lines(path: str) -> int:
    """Count newline characters. ≈ ``count_num_lines`` (lib/csv.c:72)."""
    n = _native.count_lines(str(path))
    if n is None:
        n = Path(path).read_bytes().count(b"\n")
    return n
