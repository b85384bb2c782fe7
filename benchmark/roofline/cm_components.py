"""Operations a ZPAQ context-mixing model needs per coded bit, by
component kind: the predict and the update of each kind as libzpaq 7.15
defines them (``Predictor::predict0`` / ``update0``, the ZPAQ level-2
specification's component descriptions), counting every integer ALU
operation and every table read or write as one operation.

- CONST 0 + 0: a fixed prediction.
- CM 5 + 10: context xor and mask, read, shift, stretch; train (count,
  error, reciprocal, multiply, mask, add, limit test, write).
- ICM 8 + 10: the nibble's bit-history slot (a hash probe each nibble,
  ~10 operations, 2.5 a bit), read history, read its probability, shift,
  stretch; next state, probability update.
- MATCH 8 + 6: predicted bit from the history buffer, length table,
  sign, stretch; compare, length reset, bit count (the byte's pointer
  and hash update, ~15, 2 a bit).
- AVG 7 + 0: two reads, two multiplies, subtract, add, shift.
- MIX2 10 + 12: context select, weight read, two multiplies, add, shift;
  error, squash, weight step, round, clamp, write.
- MIX with m inputs 8 + 2m and 4 + 4m: context select and scale, m
  multiplies and adds, shift, clamp; error and rate, then per input a
  multiply, a rounding add, a shift and an add.
- ISSE 12 + 16: the slot as for ICM, two weight reads, multiply, add,
  shift, clamp; error, two weight steps with clamps, next state.
- SSE 16 + 12: context, clamp of the input, interpolation weight, two
  reads, two multiplies, add, shift, stretch; train one entry.

Each bit also pays the binary arithmetic coder (range split, compare,
narrow, shift-out test: 8) and the bit's context bookkeeping (4).
"""

CONS, CM, ICM, MATCH, AVG, MIX2, MIX, ISSE, SSE = range(1, 10)
PER_BIT = 8 + 4
FIXED = {CONS: 0, CM: 15, ICM: 18, MATCH: 14, AVG: 7, MIX2: 22, ISSE: 28,
         SSE: 28}


def ops_per_bit(components) -> int:
    """``components``: the model's ``[kind, args...]`` lists as its header
    states them (a MIX's fourth byte is its input count)."""
    total = PER_BIT
    for c in components:
        total += 12 + 6 * c[3] if c[0] == MIX else FIXED[c[0]]
    return total
