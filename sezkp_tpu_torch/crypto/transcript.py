"""Domain-separated BLAKE3 Fiat-Shamir transcript.

Bit-exact reproduction of the reference's ``Blake3Transcript``
(reference: crates/sezkp-crypto/src/lib.rs:74-124):

- seeding:   update(b"sezkp.transcript.v0") ; update(le32(len(domain))) ; update(domain)
- absorb:    update(b"absorb") ; le32(len(label)) ; label ; le32(len(bytes)) ; bytes
- challenge: clone state ; update(b"challenge") ; le32(len(label)) ; label ;
             finalize XOF -> n bytes ; then ratchet the live state with
             update(b"after_challenge") ; le32(len(label)) ; label
"""

from __future__ import annotations

import struct

from .blake3 import Hasher

TRANSCRIPT_PREFIX = b"sezkp.transcript.v0"


class Blake3Transcript:
    __slots__ = ("st",)

    def __init__(self, domain_sep: str):
        self.st = Hasher()
        d = domain_sep.encode("utf-8")
        self.st.update(TRANSCRIPT_PREFIX)
        self.st.update(struct.pack("<I", len(d)))
        self.st.update(d)

    def clone(self) -> "Blake3Transcript":
        t = Blake3Transcript.__new__(Blake3Transcript)
        t.st = self.st.copy()
        return t

    def absorb(self, label: str, data: bytes) -> None:
        lb = label.encode("utf-8")
        st = self.st
        st.update(b"absorb")
        st.update(struct.pack("<I", len(lb)))
        st.update(lb)
        st.update(struct.pack("<I", len(data)))
        st.update(data)

    def absorb_u64(self, label: str, x: int) -> None:
        self.absorb(label, struct.pack("<Q", x & 0xFFFFFFFFFFFFFFFF))

    def absorb_i64(self, label: str, x: int) -> None:
        self.absorb(label, struct.pack("<q", x))

    def challenge_bytes(self, label: str, n: int) -> bytes:
        lb = label.encode("utf-8")
        st = self.st.copy()
        st.update(b"challenge")
        st.update(struct.pack("<I", len(lb)))
        st.update(lb)
        out = st.digest(n)
        # Ratchet forward so future challenges differ.
        self.st.update(b"after_challenge")
        self.st.update(struct.pack("<I", len(lb)))
        self.st.update(lb)
        return out

    def challenge_u64(self, label: str) -> int:
        return struct.unpack("<Q", self.challenge_bytes(label, 8))[0]


# Canonical labels (reference: crates/sezkp-crypto/src/lib.rs:146-161).
class Label:
    PARAMS = "sezkp/params"
    COL_ROOT = "sezkp/col_root"
    ROW_OPEN = "sezkp/row_open"
    FRI_ROOT = "sezkp/fri_root"
    FRI_QUERY = "sezkp/fri_query"
    FRI_FINAL = "sezkp/fri_final"
    MANIFEST = "sezkp/manifest"
