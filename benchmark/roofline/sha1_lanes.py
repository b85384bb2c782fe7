"""SHA-1 of many messages (FIPS 180-4, section 6.1.2).

Per 64-byte block: the message schedule's 64 words W[16..79], each three
XORs and a rotate (256 operations); 80 rounds of ``T = ROTL5(a) + f + e + K
+ W[t]`` (a rotate and four additions) and ``c = ROTL30(b)`` (a rotate) with
f = Ch (4: and, not, and, xor) in rounds 0-19, Parity (2 xors) in 20-39
and 60-79, Maj (5: three ands, two xors) in 40-59: 20 x 10 + 40 x 8 + 20 x
11 = 740; and the five additions into the hash state. A message of n bytes
is padded to ceil((n + 9) / 64) blocks. Bytes: each message byte read
once, each 20-byte digest written once.
"""

#: the kernel's name in the profiler's trace, and the span that records
#: the work of its launches
KERNEL = "::Sha1, "
SPAN = "sha1_lanes"

SCHEDULE = 64 * 4
ROUNDS = 20 * (6 + 4) + 20 * (6 + 2) + 20 * (6 + 5) + 20 * (6 + 2)
OPS_PER_BLOCK = SCHEDULE + ROUNDS + 5


def blocks(n: int) -> int:
    return (n + 9 + 63) // 64


def work(launches, config) -> tuple:
    """``launches``: each a dict with ``lengths``, the messages' bytes."""
    ops = nbytes = 0
    for launch in launches:
        for n in launch["lengths"]:
            ops += OPS_PER_BLOCK * blocks(n)
            nbytes += n + 20
    return ops, nbytes
