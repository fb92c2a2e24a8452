"""Reservation-protected backfill.

When the head-of-line workload on a flavor cannot fit, every currently-free
chip plus every chip of its in-flight preemption victims is *reserved* for
it — the anti-starvation guarantee the seed's best-effort FIFO lacked (a
blocked large job watched small jobs stream past it forever).

Backfill then answers: how many chips may later-ranked workloads use
**without delaying that reservation**?  Without runtime estimates the only
safe answer is the *excess* over the head's total need:

    capacity = free + incoming - head_need

where ``incoming`` counts the chips of preemption victims already SIGTERMed
on the head's behalf (they exit within seconds, so the head's start is
imminent and provably unaffected by backfill in the excess).  When no
preemption is possible, ``incoming`` is 0 and ``free < head_need`` by
construction, so the capacity is negative and nothing slips past the head —
strict-FIFO-with-reservation, i.e. no starvation.
"""

from __future__ import annotations


def backfill_capacity(free: int, incoming: int, head_need: int) -> int:
    """Chips available to backfill candidates behind a blocked head.

    ``free``: unused chips on the flavor right now; ``incoming``: chips of
    in-flight preemption victims earmarked for the head; ``head_need``: the
    head workload's full chip request.  Never negative.
    """
    return max(0, free + incoming - head_need)
