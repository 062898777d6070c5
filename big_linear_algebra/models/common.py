"""Shared model-program scaffolding: CLI verbs, metrics, profiling, debugging.

≈ the reference's per-model ``main(argc, argv)`` dispatchers
(model/mnist_nn.c:512-536 etc.: verbs ``init | train <epochs> | run [n]``)
and its printf metrics (SURVEY.md §5 "Metrics / logging"). Adds the
observability the reference lacks: structured per-step metrics
(stdout + optional JSONL), ``jax.profiler`` traces behind ``--profile``, and
``--debug-nans`` / ``--disable-jit`` escape hatches.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from big_linear_algebra.utils.compile_cache import enable_compile_cache

# Persistent cross-process compilation cache: the model CLIs are separate
# processes (init | train | run), and the U-Net's train and sampling graphs
# take tens of seconds to compile — cache them on disk once.
enable_compile_cache()


def data_dir() -> Path:
    """Root data directory (reference uses relative ``data/``; override with
    BLA_DATA_DIR)."""
    return Path(os.environ.get("BLA_DATA_DIR", "data"))


class MetricsLogger:
    """Structured metrics: one stdout line per log call, optional JSONL file."""

    def __init__(self, jsonl_path: Optional[str] = None):
        self._file = open(jsonl_path, "a") if jsonl_path else None

    def log(self, **metrics) -> None:
        parts = []
        for k, v in metrics.items():
            if isinstance(v, float):
                parts.append(f"{k}: {v:.5f}")
            else:
                parts.append(f"{k}: {v}")
        print("\t".join(parts), flush=True)
        if self._file:
            metrics["time"] = time.time()
            self._file.write(json.dumps(metrics) + "\n")
            self._file.flush()

    def close(self):
        if self._file:
            self._file.close()


@contextlib.contextmanager
def maybe_profile(enabled: bool, logdir: str = ""):
    """jax.profiler trace context (Perfetto/XProf-compatible dump).
    ``--profile`` writes under ``<data dir>/profile``; ``--profile=DIR``
    overrides it."""
    if not enabled:
        yield
        return
    import jax

    logdir = logdir or str(data_dir() / "profile")
    with jax.profiler.trace(logdir):
        yield
    print(f"profile written to {logdir}", flush=True)


def _apply_debug_flags(flags: Dict[str, str]) -> None:
    import jax

    if "debug-nans" in flags:
        jax.config.update("jax_debug_nans", True)
    if "disable-jit" in flags:
        jax.config.update("jax_disable_jit", True)


def parse_flags(argv: List[str]):
    """Split ``--key[=value]`` flags from positional args."""
    pos, flags = [], {}
    for a in argv:
        if a.startswith("--"):
            k, _, v = a[2:].partition("=")
            flags[k] = v
        else:
            pos.append(a)
    return pos, flags


# Flags every model CLI understands; per-model extras via run_cli's
# ``extra_flags``. Unknown flags are a hard error — silently accepting a flag
# a model ignores is worse than rejecting it.
_BASE_FLAGS = frozenset({"profile", "jsonl", "debug-nans", "disable-jit"})


def positive_int_flag(flags, name: str) -> int:
    """Parse ``--name=N`` as a positive int; a bare ``--name`` (empty value)
    or a non-positive value is a hard error — same policy as unknown flags
    (silently falling back to a default would e.g. record batch-scaling
    numbers at the wrong batch)."""
    raw = flags.get(name, "")
    try:
        value = int(raw)
    except (TypeError, ValueError):
        raise ValueError(
            f"--{name} needs an integer value, e.g. --{name}=64 "
            f"(got {raw!r})") from None
    if value <= 0:
        raise ValueError(f"--{name} must be positive, got {value}")
    return value


def int_flag(flags, name: str, default: int, minimum: int) -> int:
    """Parse ``--name=N`` as an int ≥ ``minimum`` when present, else
    ``default``. A bare ``--name`` or an out-of-range value is a hard
    error — the same policy as positive_int_flag (a bare ``--max-steps``
    silently meaning "whole epoch" is the opposite of the user's evident
    intent)."""
    if name not in flags:
        return default
    raw = flags.get(name, "")
    try:
        value = int(raw)
    except (TypeError, ValueError):
        raise ValueError(
            f"--{name} needs an integer value, e.g. --{name}={default or 1} "
            f"(got {raw!r})") from None
    if value < minimum:
        raise ValueError(f"--{name} must be >= {minimum}, got {value}")
    return value


def presence_flag(flags, name: str) -> bool:
    """A flag that is either absent or bare (``--name``). A value
    (``--name=false``) is a hard error — silently enabling remat on
    ``--remat=false`` would invert the user's intent (same strict policy as
    positive_int_flag / unknown flags)."""
    if name not in flags:
        return False
    if flags[name] != "":
        raise ValueError(
            f"--{name} takes no value; pass a bare --{name} to enable it "
            f"(got --{name}={flags[name]!r})")
    return True


def run_cli(prog: str,
            init_fn: Callable[..., None],
            train_fn: Callable[..., None],
            run_fn: Callable[..., None],
            argv: Optional[List[str]] = None,
            train_usage: str = "train <num epochs>",
            run_usage: str = "run [<num predictions>]",
            extra_flags=(),
            unsupported_flags: Optional[Dict[str, str]] = None) -> int:
    """Dispatch the reference CLI verbs. Flags (``--profile``, ``--jsonl=…``,
    ``--debug-nans``, ``--disable-jit`` + per-model ``extra_flags``) are
    passed to the verb functions via the ``flags`` keyword.
    ``unsupported_flags`` maps a flag name to the reason it is rejected for
    this model (e.g. ``--dp`` on the inherently-sequential online-SGD
    models)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    pos, flags = parse_flags(argv)
    usage = (f"Please supply an argument, options:\n\t{run_usage}\n\t"
             f"{train_usage}\n\tinit\n")
    if not pos:
        print(usage)
        return 1
    allowed = _BASE_FLAGS | set(extra_flags)
    for k in flags:
        if unsupported_flags and k in unsupported_flags:
            print(f"--{k} is not supported by {prog}: "
                  f"{unsupported_flags[k]}")
            return 1
        if k not in allowed:
            print(f"Unrecognized flag --{k}; {prog} accepts: "
                  + " ".join(f"--{f}" for f in sorted(allowed)))
            return 1
    _apply_debug_flags(flags)
    verb = pos[0]
    try:
        if verb.startswith("run"):
            n = int(pos[1]) if len(pos) > 1 else -1
            extra = [int(p) for p in pos[2:]]
            with maybe_profile("profile" in flags, flags.get("profile", "")):
                run_fn(n, *extra, flags=flags)
        elif verb.startswith("train"):
            if len(pos) < 2:
                print(f"Please supply a number of epochs, usage:\n\t{train_usage}\n")
                return 1
            with maybe_profile("profile" in flags, flags.get("profile", "")):
                train_fn(int(pos[1]), *pos[2:], flags=flags)
        elif verb.startswith("init"):
            init_fn(flags=flags)
        else:
            print(f"Unrecognized argument, options:\n\t{run_usage}\n\t"
                  f"{train_usage}\n\tinit\n")
            return 1
    except BrokenPipeError:  # pragma: no cover
        return 0
    return 0
