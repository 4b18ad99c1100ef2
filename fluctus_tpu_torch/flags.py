"""Environment overrides (``FLT_<NAME>``), the port's copy of the reference
package's helpers. The port reads one knob: ``SEED_SALT`` (wf_reset), a
decorrelated replica RNG stream; 0 keeps the seed = lane id init."""

from __future__ import annotations

import os

_PREFIX = "FLT_"


def env(name: str, default: str) -> str:
    """Raw override read: ``FLT_<name>`` or the given default."""
    return os.environ.get(_PREFIX + name, default)


def env_int(name: str, default: int) -> int:
    return int(env(name, str(default)))
