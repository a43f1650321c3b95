"""Shared app harness: the flag helpers of ``flexflow_tpu/apps/common.py``."""

from __future__ import annotations

from typing import Optional

COMMON_FLAGS = """\
Common flags the port reads so far:
  --dtype float32|bfloat16   --seed N
Every other flag of the JAX package's apps is refused until its slice
of the port lands (ROADMAP.md queue 1)."""


def check_help(argv, doc: Optional[str]) -> None:
    """-h/--help: print the app's docstring plus the common flag table,
    then exit 0."""
    if "-h" in argv or "--help" in argv:
        if doc:
            print(doc.strip())
            print()
        print(COMMON_FLAGS)
        raise SystemExit(0)


def _pop(argv, flag, default, cast, what):
    """Extract an app-specific ``--flag V`` from argv."""
    if flag not in argv:
        return default
    i = argv.index(flag)
    try:
        val = cast(argv[i + 1])
    except (IndexError, ValueError):
        raise SystemExit(f"{flag} expects {what}")
    del argv[i:i + 2]
    return val


def pop_int(argv, flag, default):
    return _pop(argv, flag, default, int, "an integer")


def pop_float(argv, flag, default):
    return _pop(argv, flag, default, float, "a number")


def pop_str(argv, flag, default):
    return _pop(argv, flag, default, str, "a value")
