"""Bucketed calendar event queue for the array-backed simulator loop.

A classic calendar queue (Brown 1988) specialised for the simulator's
access pattern: events are pushed with a ``(t, seq)`` priority and
popped in exactly ``(t, seq)`` order, but the *time axis is coarsely
bucketed* so the structure never maintains one global million-entry
heap. Each bucket is a small binary heap covering ``bucket_s`` seconds
of simulated time; a second tiny heap orders the non-empty bucket ids.
Pops drain the current (earliest) bucket; pushes land in their bucket's
heap — O(log bucket-size), and bucket sizes stay bounded by the event
density per ``bucket_s`` window rather than by trace length.

Two properties the simulator depends on:

* **Total order parity with ``heapq``.** Within a bucket the heap
  orders ``(t, seq, ...)`` tuples exactly as the legacy global heap
  did, and buckets are drained in id order, so the pop sequence is
  byte-identical to a single ``heapq`` over the same pushes (``seq`` is
  a strictly increasing tiebreak, so priorities are unique).
* **Safe insert-into-draining-bucket.** Simulated time never goes
  backwards: every push carries ``t >= now`` (handlers schedule only
  into the future), so pushing into the *currently draining* bucket is
  an ordinary ``heappush`` into that bucket's heap — the event sorts
  after everything already popped and before later-``(t, seq)``
  residents. ``tests/test_event_loop.py`` pins this boundary case.

The queue stores whatever tuple the caller pushes as long as it starts
with ``(t, seq)``; it never inspects trailing fields.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple


class CalendarQueue:
    """Min-priority queue over ``(t, seq, ...)`` tuples, bucketed by
    ``int(t / bucket_s)``. Pop order is identical to a single global
    ``heapq`` over the same pushes."""

    __slots__ = ("bucket_s", "_inv_bucket", "_buckets", "_bucket_ids",
                 "_size", "_head", "_head_bid")

    def __init__(self, bucket_s: float = 1.0):
        assert bucket_s > 0.0
        self.bucket_s = bucket_s
        # bucket id = int(t * 1/bucket_s): multiply beats divide on the
        # per-push hot path, and any monotone-in-t bucket map yields
        # the same pop order (order WITHIN the structure is always by
        # the full (t, seq) tuple; bucket ids only partition it)
        self._inv_bucket = 1.0 / bucket_s
        self._buckets: dict = {}          # bucket id -> heapified list
        self._bucket_ids: List[int] = []  # heap of non-empty bucket ids
        self._size = 0
        # cached earliest non-empty bucket: the hot loop peeks before
        # every pop (merge against the sorted arrival array) and again
        # per cohort member, so re-finding the head bucket each time
        # would double the per-event queue cost. Invalidated whenever
        # it might go stale: a push that OPENS a bucket earlier than
        # the cached one, or a pop that drains the cached bucket.
        self._head: Optional[list] = None
        self._head_bid = -1

    def __len__(self) -> int:
        return self._size

    def __bool__(self) -> bool:
        return self._size > 0

    def push(self, ev: Tuple) -> None:
        bid = int(ev[0] * self._inv_bucket)
        b = self._buckets.get(bid)
        if b is None:
            self._buckets[bid] = [ev]
            heapq.heappush(self._bucket_ids, bid)
            if self._head is not None and bid < self._head_bid:
                self._head = None  # new bucket sorts before cached head
        else:
            # an existing bucket is never earlier than the cached head
            # (the head is the earliest non-empty bucket), so the cache
            # stays valid — including pushes INTO the head bucket
            heapq.heappush(b, ev)
        self._size += 1

    def peek(self) -> Optional[Tuple]:
        """Earliest event without removing it (None when empty)."""
        b = self._head
        if b:
            return b[0]
        ids = self._bucket_ids
        buckets = self._buckets
        while ids:
            bid = ids[0]
            b = buckets.get(bid)
            if b:
                self._head = b
                self._head_bid = bid
                return b[0]
            # bucket drained earlier; drop the stale id
            heapq.heappop(ids)
            buckets.pop(bid, None)
        return None

    def pop(self) -> Tuple:
        b = self._head
        if not b:
            if self.peek() is None:
                raise IndexError("pop from empty CalendarQueue")
            b = self._head
        ev = heapq.heappop(b)
        if not b:
            heapq.heappop(self._bucket_ids)
            del self._buckets[self._head_bid]
            self._head = None
        self._size -= 1
        return ev
