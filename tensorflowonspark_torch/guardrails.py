"""Shared guardrail + journal primitives for the control planes (the
port's copy of the JAX package's ``guardrails`` module).

The autopilot (knob plane) and the remediator (topology plane)
run the same action discipline — confirm-streak hysteresis, per-key
cooldown, one action in flight, a flush-per-write JSONL journal over the
``proposed -> applied -> effect -> kept/reverted`` stage vocabulary.
This module is that discipline extracted once so the two controllers
cannot drift: :class:`Guardrails` owns the gating state,
:class:`JsonlJournal` owns the crash-safe append stream, and
:data:`STAGES` is the shared lifecycle vocabulary.
"""

import json
import logging
import os
import threading

from .watchtower import json_safe

logger = logging.getLogger(__name__)

#: action lifecycle stages, in order — the journal's ``stage`` vocabulary
STAGES = ("proposed", "applied", "effect", "kept", "reverted")


class JsonlJournal(object):
    """Append-only flush-per-write JSONL stream (crash-safe: every record
    is flushed before the write returns, so a driver crash mid-run loses
    at most the record being written).  ``path=None`` disables — every
    write becomes a no-op, so callers never branch.

    Thread-safe; the file is opened lazily on the first write (parent
    directory created), so constructing one is free.
    """

    def __init__(self, path, owner="journal"):
        self.path = path
        self._owner = owner
        self._fh = None
        self._lock = threading.Lock()

    def write(self, record):
        """Append one record (``json_safe``-coerced).  Failures are logged,
        never raised — journaling must not take the run down."""
        if self.path is None:
            return
        with self._lock:
            try:
                if self._fh is None:
                    parent = os.path.dirname(os.path.abspath(self.path))
                    os.makedirs(parent, exist_ok=True)
                    self._fh = open(self.path, "a")
                self._fh.write(json.dumps(json_safe(record), default=str)
                               + "\n")
                self._fh.flush()  # must survive a driver crash mid-run
            except Exception:
                logger.warning("%s journal write failed", self._owner,
                               exc_info=True)

    def close(self):
        """Close the stream (idempotent); later writes reopen it."""
        with self._lock:
            fh, self._fh = self._fh, None
            if fh is not None:
                try:
                    fh.close()
                except OSError:
                    pass


class Guardrails(object):
    """The action-gating state machine both controllers share:

    - **confirm streak** — ``bump_streak``/``clear_streak`` count the
      consecutive firing ticks per key; a proposal is minted only once
      the streak reaches the caller's ``confirm_ticks`` (hysteresis — one
      noisy window never triggers an action);
    - **per-key cooldown** — after an action settles the key is frozen
      (``cooldown_secs``; ``revert_cooldown_secs`` after a revert so an
      action that just hurt the run is not retried while conditions
      still match);
    - **one action in flight** — :attr:`pending` holds the single applied
      action awaiting its settle window; callers must not propose while
      it is set, so effects stay attributable.

    Not internally locked: callers serialize ticks (both controllers run
    a single control thread and take their own lock around state reads).
    """

    def __init__(self, cooldown_secs, revert_cooldown_secs=None):
        self.cooldown_secs = cooldown_secs
        self.revert_cooldown_secs = (cooldown_secs
                                     if revert_cooldown_secs is None
                                     else revert_cooldown_secs)
        self._cooldown_until = {}
        self._streak = {}
        self.pending = None

    # -- cooldown ----------------------------------------------------------

    def in_cooldown(self, key, now):
        return now < self._cooldown_until.get(key, 0.0)

    def start_cooldown(self, key, now, reverted=False):
        secs = self.revert_cooldown_secs if reverted else self.cooldown_secs
        self._cooldown_until[key] = now + secs

    def cooldowns(self, now):
        """Remaining cooldown per key (status surfaces), expired dropped.
        Read from the observatory's request threads while the controller
        thread starts cooldowns: the items are copied in one step first."""
        return {k: round(until - now, 2)
                for k, until in list(self._cooldown_until.items())
                if until > now}

    # -- confirm streak ----------------------------------------------------

    def bump_streak(self, key):
        streak = self._streak.get(key, 0) + 1
        self._streak[key] = streak
        return streak

    def clear_streak(self, key):
        self._streak[key] = 0

    def streak(self, key):
        return self._streak.get(key, 0)

    # -- one action in flight ----------------------------------------------

    def begin(self, record):
        """Latch the one in-flight action (an ``applied`` record dict)."""
        self.pending = record

    def settle(self):
        """Release the in-flight slot; returns the settled record."""
        pend, self.pending = self.pending, None
        return pend
