"""Full-jitter exponential backoff, shared by every retry loop.

One formula (AWS "full jitter": ``uniform(0, min(cap, base * 2^attempt))``)
used by the resilience supervisor's recovery sleeps, the RPC client's
``get_var`` init-race polling and the bench backend-probe retries — so a
fleet of restarting trainers never thundering-herds a recovering pserver
or TPU tunnel, and chaos tests can pin the envelope deterministically by
passing a seeded ``random.Random``.
"""

from __future__ import annotations

import os
import random
from typing import Optional

__all__ = ["backoff_delay", "millis_env"]


def backoff_delay(attempt: int, base_s: float, cap_s: float,
                  rng: Optional[random.Random] = None) -> float:
    """Seconds to sleep before retry ``attempt`` (0-based): full jitter
    over an exponential envelope. The UPPER BOUND doubles per attempt
    and saturates at ``cap_s``; the actual sleep is uniform in
    ``[0, bound]`` — deliberately allowed to be ~0, which is what
    decorrelates a herd of synchronized retriers."""
    if attempt < 0:
        raise ValueError("attempt must be >= 0, got %d" % attempt)
    bound = min(float(cap_s), float(base_s) * (2.0 ** attempt))
    r = rng if rng is not None else random
    return r.uniform(0.0, max(bound, 0.0))


def millis_env(name: str, default_ms: int) -> float:
    """Env-tunable millisecond knob returned in SECONDS, parsed exactly
    like the native transport's DeadlineMs(): junk or <= 0 falls back to
    the default — a typo'd knob must degrade to stock behavior, never to
    a zero-length (hot-spinning) backoff."""
    try:
        ms = int(os.environ.get(name, str(default_ms)))
    except ValueError:
        ms = default_ms
    return (ms if ms > 0 else default_ms) / 1000.0
