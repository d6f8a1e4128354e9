"""The LSTM reducer's cell update: the least bytes a training step's cell
updates must move, and the least time the H100 could take for them.

A cell update of one row reads the four gates' pre-activations (4 H) and
the carry ``(c, h)`` (2 H) and writes the carry (2 H); its backward reads
the pre-activations, ``c`` and the carry's two gradients (7 H) and writes
the gates' gradient (4 H) and the carry's two (2 H): 21 H elements a
row-slot, each read or written once.  Whatever a design saves for the
backward, or reads in place of the pre-activations, is not counted, so no
design can read above its bound.  The operations, a few dozen an element,
sit far under the card's ridge: bytes bound the update.
"""

from __future__ import annotations

from portbench.counts import kernels as kc

ELEMENTS_PER_ROW_SLOT = 21  # in units of the LSTM's width H


def step_bytes(row_slots: float, hidden: int, elem: int) -> float:
    """The least bytes of ``row_slots`` cell updates, forward and backward,
    at width ``hidden`` in ``elem``-byte elements."""
    return float(row_slots) * ELEMENTS_PER_ROW_SLOT * hidden * elem


def step_bound_s(row_slots: float, hidden: int, elem: int) -> float:
    """The least seconds of those updates: their bytes at 3.35 TB/s."""
    return kc.bound_s(0.0, step_bytes(row_slots, hidden, elem))
