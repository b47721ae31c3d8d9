"""The plain reference (plain/): its primitives against plainer arithmetic,
and whole proofs and manifest roots against the program's on the CPU."""

import random

import numpy as np
import pytest
import torch

import inputs
from plain import blake3 as B3
from plain import field as F
from plain import stark_v1, trace

P = F.P


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _message(n):
    return bytes(i % 251 for i in range(n))


def test_blake3_known_answer():
    # the empty message, from the BLAKE3 specification's test vectors
    assert B3.hash_bytes(b"").hex() == (
        "af1349b9f5f9a1a6a0404dea36dcc9499bcb25c9adc112b7cc9a93cae41f3262")


@pytest.mark.parametrize("length", [0, 1, 63, 64, 65, 1023, 1024, 1025, 2048, 2049, 5121, 9000])
def test_hasher_matches_the_program_and_its_own_splits(length):
    from sezkp_tpu_torch.crypto import blake3 as program_blake3

    m = _message(length)
    h = program_blake3.Hasher()
    h.update(m)
    want = h.digest(131)
    assert B3.hash_bytes(m, 131) == want
    ours = B3.Hasher()
    cut = random.Random(length).randrange(length + 1)
    ours.update(m[:cut])
    copy = ours.copy()
    ours.update(m[cut:])
    assert ours.digest(131) == want and ours.digest(7) == want[:7]
    copy.update(m[cut:])
    assert copy.digest(131) == want


@pytest.mark.parametrize("length", [1, 8, 29, 63, 64, 65, 250, 640, 1024])
def test_batched_hash_matches_the_pure_one(length):
    msgs = np.random.default_rng(length).integers(0, 256, size=(5, length), dtype=np.uint8)
    got = B3.words_to_bytes(B3.hash_chunks(B3.bytes_to_words(torch.from_numpy(msgs)), length))
    assert got == b"".join(B3.hash_bytes(m.tobytes()) for m in msgs)


def _elements(k, seed):
    rng = random.Random(seed)
    edge = [0, 1, 2, P - 1, P - 2, 1 << 32, (1 << 32) - 1, 1 << 63, (1 << 63) - 1, P - (1 << 32)]
    return edge + [rng.randrange(P) for _ in range(k - len(edge))]


def _t(xs):
    return torch.tensor([F.signed(x) for x in xs], dtype=torch.int64)


def _ints(t):
    return [F.unsigned(x) for x in t.tolist()]


def test_field_arithmetic_matches_integers():
    a, b = _elements(400, 1), _elements(400, 2)[::-1]
    ta, tb = _t(a), _t(b)
    assert _ints(F.add(ta, tb)) == [(x + y) % P for x, y in zip(a, b)]
    assert _ints(F.sub(ta, tb)) == [(x - y) % P for x, y in zip(a, b)]
    assert _ints(F.mul(ta, tb)) == [x * y % P for x, y in zip(a, b)]
    nz = [x for x in a if x]
    assert _ints(F.inv(_t(nz))) == [pow(x, P - 2, P) for x in nz]
    assert _ints(F.from_i64(torch.tensor([-1, 0, 1]))) == [P - 1, 0, 1]
    assert _ints(F.powers(5, 9, "cpu")) == [pow(5, i, P) for i in range(9)]


@pytest.mark.parametrize("log_n", [0, 1, 2, 3, 6])
def test_ntt_is_the_dft(log_n):
    n = 1 << log_n
    a = _elements(max(n, 10), log_n)[:n]
    w = F.root_of_unity(log_n)
    want = [sum(a[j] * pow(w, i * j, P) for j in range(n)) % P for i in range(n)]
    assert _ints(F.ntt(_t(a))) == want
    assert _ints(F.intt(_t(want))) == a


@pytest.mark.parametrize("m", [1, 2, 3, 5, 8, 13])
def test_trees_promote_the_odd_node_and_open_paths(m):
    digests = [B3.hash_bytes(bytes([i])) for i in range(m)]
    words = B3.bytes_to_words(torch.tensor([list(d) for d in digests], dtype=torch.uint8))[:8]
    trees = stark_v1.Trees(words[:, None])

    def levels(level):
        out = [level]
        while len(level) > 1:
            nxt = [B3.hash_bytes(level[i] + level[i + 1]) for i in range(0, len(level) - 1, 2)]
            level = nxt + ([level[-1]] if len(level) % 2 else [])
            out.append(level)
        return out

    want = levels(digests)
    assert B3.words_to_bytes(trees.roots()) == want[-1][0]
    idx = torch.arange(m)
    got = stark_v1._digests(trees.paths(torch.zeros_like(idx), idx))
    for i in range(m):
        j, path = i, []
        for lvl in want[:-1]:
            path.append(lvl[j ^ 1] if (j ^ 1) < len(lvl) else lvl[j])
            j >>= 1
        assert [g[i] for g in got] == path


@pytest.mark.parametrize("t, b, tau", [(1 << 13, 512, 8), (1 << 12, 1000, 2)])
def test_proof_and_manifest_equal_the_programs(t, b, tau):
    from sezkp_tpu_torch.commit.merkle import commit_blocks
    from sezkp_tpu_torch.core import types as program_types
    from sezkp_tpu_torch.stark.backends import StarkV1

    (p,) = inputs.make_pool(2**40 + t, t, b, tau, 1, program_types)
    assert commit_blocks(p.blocks).root == p.root == trace.manifest_root(p.ref_blocks)
    want = StarkV1.prove(p.blocks, p.root, device="cpu").proof_bytes
    assert stark_v1.prove(p.ref_blocks, p.root, "cpu") == want
    assert stark_v1.prove(p.ref_blocks, p.root, "cpu", queries=29) != want
