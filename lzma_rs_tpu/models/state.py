"""Decoder-state layout: one flat SoA probability table per decode lane.

The reference scatters its probability model across many small arrays on the
``DecoderState`` struct (lzma-rs ``src/decode/lzma.rs:165-185``).
For the lane-parallel design every probability lives in ONE flat ``uint16``
vector per decode lane, so that the lane-parallel kernel can address any
probability with a single computed index and the whole model state is a
plain JAX pytree (checkpoint = save the arrays; LZMA2 reset = refill with
0x400).

Layout (sizes from the reference):

- literal probs:    ``nlit * 0x300``  (``nlit = 1 << (lc + lp)``; Vec2D in
  the reference, src/decode/lzma.rs:194)
- is_match:         192   (12 states x 16 pos_states)
- is_rep:           12
- is_rep_g0/g1/g2:  12 each
- is_rep_0long:     192
- pos_slot:         4 x 64 (one 64-leaf tree per len_state)
- pos_decoders:     115  ("spec_pos" reverse trees for pos_slot 4..13)
- align:            16
- len / rep_len:    2 + 16*8 + 16*8 + 256 = 514 each
  (choice, choice2, low[16], mid[16], high; src/decode/rangecoder.rs:203-270)

All probabilities initialize to 0x400 (= 1/2 in 11-bit fixed point).
"""

from __future__ import annotations

import dataclasses

import numpy as np

PROB_INIT = 0x400
NUM_STATES = 12
NUM_POS_STATES_MAX = 16
LIT_TREE_SIZE = 0x300  # 0x100 plain + 2 * 0x100 matched
LEN_CODER_SIZE = 2 + 16 * 8 + 16 * 8 + 256  # 514

# Offsets within a LenDecoder sub-block.
LEN_CHOICE = 0
LEN_CHOICE2 = 1
LEN_LOW = 2  # 16 trees of 8 leaves (indexed 1..7 within tree)
LEN_MID = 2 + 16 * 8
LEN_HIGH = 2 + 16 * 8 + 16 * 8  # 256-leaf tree


@dataclasses.dataclass(frozen=True)
class ProbLayout:
    """Offsets of each probability group in the flat per-lane table."""

    nlit: int  # number of literal contexts, 1 << (lc + lp)
    lit: int
    is_match: int
    is_rep: int
    is_rep_g0: int
    is_rep_g1: int
    is_rep_g2: int
    is_rep_0long: int
    pos_slot: int
    spec_pos: int
    align: int
    len_coder: int
    rep_len_coder: int
    total: int


def make_layout(max_lclp: int = 4) -> ProbLayout:
    """Build the layout for ``lc + lp <= max_lclp``.

    LZMA2 enforces ``lc + lp <= 4`` (src/decode/lzma2.rs:170-175), so the
    lane-parallel kernels use ``max_lclp=4`` (total 14135 entries, ~28 KiB
    per lane); raw LZMA permits up to ``lc<=8, lp<=4`` and gets a bigger
    table.
    """
    nlit = 1 << max_lclp
    off = 0

    def take(n: int) -> int:
        nonlocal off
        at = off
        off += n
        return at

    lit = take(nlit * LIT_TREE_SIZE)
    is_match = take(192)
    is_rep = take(12)
    is_rep_g0 = take(12)
    is_rep_g1 = take(12)
    is_rep_g2 = take(12)
    is_rep_0long = take(192)
    pos_slot = take(4 * 64)
    spec_pos = take(115)
    align = take(16)
    len_coder = take(LEN_CODER_SIZE)
    rep_len_coder = take(LEN_CODER_SIZE)
    return ProbLayout(
        nlit=nlit,
        lit=lit,
        is_match=is_match,
        is_rep=is_rep,
        is_rep_g0=is_rep_g0,
        is_rep_g1=is_rep_g1,
        is_rep_g2=is_rep_g2,
        is_rep_0long=is_rep_0long,
        pos_slot=pos_slot,
        spec_pos=spec_pos,
        align=align,
        len_coder=len_coder,
        rep_len_coder=rep_len_coder,
        total=off,
    )


# The canonical layout for LZMA2 / lane-parallel decode.
LAYOUT_LCLP4 = make_layout(4)


def fresh_probs(layout: ProbLayout) -> np.ndarray:
    """Flat u16 probability table, all entries at the 0x400 neutral init
    (rangecoder.rs:176)."""
    return np.full(layout.total, PROB_INIT, dtype=np.uint16)


# State-machine transition tables (src/decode/lzma.rs:298-304, 322, 352, 367).
# after literal: state < 4 -> 0; < 10 -> state - 3; else state - 6
STATE_AFTER_LIT = np.array([0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 4, 5], dtype=np.int32)
# after match: < 7 -> 7 else 10
STATE_AFTER_MATCH = np.array([7] * 7 + [10] * 5, dtype=np.int32)
# after rep: < 7 -> 8 else 11
STATE_AFTER_REP = np.array([8] * 7 + [11] * 5, dtype=np.int32)
# after short rep: < 7 -> 9 else 11
STATE_AFTER_SHORTREP = np.array([9] * 7 + [11] * 5, dtype=np.int32)
