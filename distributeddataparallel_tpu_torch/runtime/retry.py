"""Bounded exponential backoff with jitter for transport calls.

Copy of ``RetryPolicy`` / ``retry_call`` from the JAX package's
``runtime/rendezvous.py``, whose port (``runtime/rendezvous.py``) imports
them from here.  The fleet's handoff sockets, its workers' control
connection and the rendezvous store's TCP client dial through
``retry_call``.

Module-import rule: stdlib only.
"""

from __future__ import annotations

import random
import time


class RetryPolicy:
    """Bounded exponential backoff with jitter.

    ``delays()`` yields ``attempts - 1`` sleep durations: after the k-th
    failure the caller sleeps ``min(base * 2^k, max) * (1 ± jitter)``.
    Jitter decorrelates clients that would otherwise retry in lockstep."""

    def __init__(self, attempts: int = 8, base_s: float = 0.05,
                 max_s: float = 1.0, jitter: float = 0.5):
        if attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {attempts}")
        self.attempts = int(attempts)
        self.base_s = float(base_s)
        self.max_s = float(max_s)
        self.jitter = float(jitter)

    def delays(self):
        for k in range(self.attempts - 1):
            d = min(self.base_s * (2.0 ** k), self.max_s)
            yield d * (1.0 + self.jitter * (2.0 * random.random() - 1.0))


#: Exceptions that mean "the transport failed", not "the peer refused":
#: retried under the policy.  ``OSError`` covers ECONNREFUSED/ECONNRESET/
#: EPIPE and socket timeouts (``socket.timeout`` is ``OSError``).
RETRYABLE_ERRORS = (ConnectionError, BrokenPipeError, OSError)


def retry_call(fn, *, policy: RetryPolicy | None = None,
               retry_on=RETRYABLE_ERRORS, on_retry=None):
    """Run ``fn()`` under ``policy``; ``on_retry(exc, delay)`` is called
    before each backoff sleep (reconnect hook).  Raises the last error
    when the budget is exhausted: bounded, never an infinite loop."""
    policy = policy or RetryPolicy()
    delays = policy.delays()
    while True:
        try:
            return fn()
        except retry_on as exc:
            try:
                delay = next(delays)
            except StopIteration:
                raise exc from None
            if on_retry is not None:
                on_retry(exc, delay)
            time.sleep(delay)
