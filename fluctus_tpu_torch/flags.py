"""Environment overrides (``FLT_<NAME>``), the port's copy of the reference
package's helpers, and the knobs the port reads:

  SEED_SALT (0)    wf_reset: a decorrelated replica RNG stream; 0 keeps the
                   seed = lane id init.
  SORT_RAYS (1)    single-set traces (mk integrator, pick, shadow queries)
                   sort rays by the coherence key; 0 traces them in lane
                   order through the rays-on-sublanes kernel (K9), and the
                   wavefront traces its two ray sets one by one.
  ROL (1)          the trace dispatch uses the rays-on-lanes kernels (K2,
                   K5); 0 falls back to the rays-on-sublanes kernel (K9).
  FORCE_MK (0)     Renderer.render_single runs the microkernel megastep
                   instead of the exact-spp wavefront.
  BLOCK_RING       over Settings.wf_block_ring when the renderer derives
                   its config: 0 renders on the flat pixel ring.
  MULTIHOST (0)    parallel.distributed.init_distributed initializes the
                   process group (torch.distributed, the reference's
                   jax.distributed init); 0 keeps it a no-op.

SPLAT_EVERY is accepted and ignored, as Settings.wf_splat_every is
(settings.py).

SORT_RAYS, ROL, FORCE_MK and MULTIHOST are read once, at import, into
module constants, as the reference does for SORT_RAYS and ROL
(mxu_trace.py:1281-1282); code reads them through this module at call
time, so a program may also set them (``flags.SORT_RAYS = False``)."""

from __future__ import annotations

import os

_PREFIX = "FLT_"


def env(name: str, default: str) -> str:
    """Raw override read: ``FLT_<name>`` or the given default."""
    return os.environ.get(_PREFIX + name, default)


def env_int(name: str, default: int) -> int:
    return int(env(name, str(default)))


def env_bool(name: str, default: bool = True) -> bool:
    return env(name, "1" if default else "0") == "1"


SORT_RAYS = env_bool("SORT_RAYS", True)
ROL = env_bool("ROL", True)
FORCE_MK = env_bool("FORCE_MK", False)
MULTIHOST = env_bool("MULTIHOST", False)
