"""The benchmark's plain reference: a STARK v1 prover written from the
algorithm, and the input maker (partition of a trace, manifest root).

Written from the published v1 algorithm (upstream `crates/sezkp-stark` v1 and
the JAX package's host route, read but not imported), not from the program:
one route, with no budgets, thresholds, streaming or chunked engines. It
imports nothing of the program, of the JAX package or of JAX, and builds no
native code:

- ``blake3.py``: BLAKE3 from its specification, pure Python for the
  transcript's incremental hashes, plain tensor code for batches of
  single-chunk messages (leaves, tree nodes, manifest leaves);
- ``field.py``: Goldilocks arithmetic in int64 tensors, and a textbook
  radix-2 NTT;
- ``trace.py``: the seeded trace's blocks and its manifest root;
- ``stark_v1.py``: the prove and the proof's wire encoding.
"""
