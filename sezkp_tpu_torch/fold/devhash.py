"""Device dispatch for the fold line's batched MAC hashing.

The balanced fold prover hashes large batches of equal-length transcript
messages (fold/batch.py). From a batch-size threshold up, and where a message
fits one BLAKE3 chunk, they go through the hand-written chain kernel K7
(ops/blake3_torch.hash_many_device) instead of the host C++ `hash_many`:
same digests, same wire bytes.

The threshold is `DriverOptions.device_hash_min` (messages per batch),
DEVICE_HASH_MIN unless the caller says otherwise; 0 asks for the host hasher
for every batch. The rule is stated, not guessed: a batch below the
threshold, or of messages longer than one chunk, is hashed on the host; every
other batch is hashed on `device`, where None is the CUDA card and raises
when there is none, and "cpu" runs the kernel's plain version (the tests).
The verifier never comes here: it pins the host hasher (fold/verify.py).
"""

from __future__ import annotations

import numpy as np

from ..crypto import blake3
from ..ops import blake3_torch as BT

# Batches of at least this many single-chunk messages go to the device. Read
# from the crossover phase of chip_smoke.py (NVIDIA H100 80GB HBM3, 700 W; host
# hash_many against hash_many_device end to end, N = 2^4 .. 2^18, two runs):
# the smallest batch size from which the card won at every message length in
# both; at 512 it won in one, and up to 128 the host won at most lengths.
DEVICE_HASH_MIN = 1024


def hash_many_auto(
    messages: np.ndarray, device=None, device_hash_min: int = DEVICE_HASH_MIN
) -> np.ndarray:
    """Batched BLAKE3 of uint8 [N, L] messages -> uint8 [N, 32].

    On `device` through K7 when device_hash_min > 0, N >= device_hash_min and
    0 < L <= 1024 (a single chunk); host C++ otherwise. Bit-identical either
    way (tests/test_torch_fold.py)."""
    msgs = np.ascontiguousarray(messages, dtype=np.uint8)
    n, length = msgs.shape
    if device_hash_min > 0 and n >= device_hash_min and 0 < length <= BT.MAX_MSG_LEN:
        return BT.hash_many_device(msgs, device)
    return blake3.hash_many(msgs)
