"""Remote-debugger attach for training entry points.

The port's own copy of ``tpdm_tpu/utils/debug.py``: when enabled, process
0 (the rank in torch.distributed's default group, 0 without one) opens a
debugpy listener and blocks until a client attaches; other processes
continue. Activated by ``TPDM_DEBUG=1`` (optionally ``TPDM_DEBUG_PORT``) or
an explicit ``attach()`` call; debugpy is optional, a missing install logs
and moves on.
"""

from __future__ import annotations

import logging
import os

from tpdm_tpu_torch.parallel.mesh import process_index

logger = logging.getLogger(__name__)


def attach(port: int = 5678, wait: bool = True) -> bool:
    """Open a debugpy listener on process 0. Returns True if listening."""
    if process_index() != 0:
        return False
    try:
        import debugpy
    except ImportError:
        logger.warning("TPDM_DEBUG set but debugpy is not installed; skipping")
        return False
    debugpy.listen(("127.0.0.1", port))
    logger.info("debugpy listening on 127.0.0.1:%d", port)
    if wait:
        logger.info("waiting for debugger attach...")
        debugpy.wait_for_client()
    return True


def setup_debug_from_env() -> bool:
    """Call from entry points: attaches when TPDM_DEBUG is truthy."""
    if os.environ.get("TPDM_DEBUG", "").lower() not in ("1", "true", "yes"):
        return False
    return attach(int(os.environ.get("TPDM_DEBUG_PORT", "5678")))
