"""The port's parallel/ on torch.distributed (gloo ranks on the CPU, one
process a rank) against the JAX package's parallel/ on the conftest's virtual
device mesh: the sharded NTT, the sharded Merkle root, the sharded ingest and
the SEZKP_* multi-process contract.

Each world (D = 1, 2, 4 ranks) is started once for the module and runs every
case; its ranks are this file run as a script (`--rank JOB`), which imports
neither jax nor the JAX package. Tolerance: none -- field values, digests,
roots and proof bytes are compared exactly."""

import hashlib
import json
import os
import pickle
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 0xFFFFFFFF00000001
WORLDS = (1, 2, 4)
# (k, n1_log2 or None for the default split, max_phase_log2): the default
# split at every k, an uneven one, and two phases a side forced at 2^12
NTT_CASES = [(k, None, 10) for k in (8, 10, 12)] + [(10, 4, 10), (12, 6, 5), (12, 5, 4)]
ROOT_SIZES = (9, 12)
LABEL = "mv_0"  # the column label whose leaf prefix the prefixed roots use


def _values(k: int) -> np.ndarray:
    return np.random.default_rng(k).integers(0, P, 1 << k, dtype=np.uint64)


def _prefixes():
    from sezkp_tpu_torch.stark.v1.openings import _label_prefix

    return (b"", _label_prefix(LABEL))


# ------------------------------- the ranks ---------------------------------


def _rank_main(job: dict) -> None:
    import torch

    torch.set_num_threads(1)
    from sezkp_tpu_torch.commit.merkle import Frontier, leaf_hashes_batch
    from sezkp_tpu_torch.core.io import read_block_summaries_auto
    from sezkp_tpu_torch.parallel import distributed as D
    from sezkp_tpu_torch.parallel.commit_sharded import sharded_merkle_root_u64
    from sezkp_tpu_torch.parallel.mesh import all_gather_tiled
    from sezkp_tpu_torch.parallel.ntt_sharded import sharded_ntt_u64
    from sezkp_tpu_torch.stark.v1.proof import encode_proof
    from sezkp_tpu_torch.stark.v1.prover import prove_v1

    assert D.ensure_initialized(device="cpu") is True, "env-configured init must activate"
    mesh = D.global_mesh()
    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
           "device": str(mesh.device), "is_coordinator": D.is_coordinator()}

    out["ntt"] = {}
    for k, n1, mp in NTT_CASES:
        for inverse in (False, True):
            out["ntt"][(k, n1, mp, inverse)] = sharded_ntt_u64(
                _values(k), mesh, n1_log2=n1, inverse=inverse, max_phase_log2=mp)
    out["root"] = {(k, pre): sharded_merkle_root_u64(_values(k), mesh, pre)
                   for k in ROOT_SIZES for pre in _prefixes()}

    # the contract: hash this rank's shard, gather the digests, fold them
    # through one frontier, then a replicated prove
    blocks = read_block_summaries_auto(job["blocks"])
    lo, hi = D.process_shard_bounds(len(blocks))
    counts = all_gather_tiled(torch.tensor([hi - lo]), mesh, 0).tolist()
    padded = np.zeros((max(counts), 32), dtype=np.uint8)
    padded[: hi - lo] = leaf_hashes_batch(blocks[lo:hi])
    gathered = all_gather_tiled(torch.from_numpy(padded)[None], mesh, 0).numpy()
    fr = Frontier()
    for p, c in enumerate(counts):
        fr.push_leaves(gathered[p][:c])
    root = fr.finalize_root()
    D.barrier("before_prove")
    proof = encode_proof(prove_v1(blocks, root, device="cpu"))
    out.update(shard=(lo, hi), manifest_root=root, proof_sha256=hashlib.sha256(proof).hexdigest())
    with open(os.path.join(job["out"], f"rank{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ------------------------------- the tests ---------------------------------


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world started at once; the JAX references are made while the
    ranks run. Returns {D: [rank results]}, plus the inputs."""
    from sezkp_tpu.core.io import write_block_summaries_auto
    from sezkp_tpu.trace.generator import generate_trace
    from sezkp_tpu.trace.partition import partition_trace
    from sezkp_tpu_torch.parallel import distributed as D

    import concurrent.futures

    base = tmp_path_factory.mktemp("worlds")
    blocks = partition_trace(generate_trace(1024, 2), 64)
    blocks_path = str(base / "blocks.cbor")
    write_block_summaries_auto(blocks_path, blocks)
    env = {"PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}

    def run(d):
        out = base / f"d{d}"
        out.mkdir()
        job = json.dumps({"blocks": blocks_path, "out": str(out)})
        res = D.launch([sys.executable, os.path.abspath(__file__), "--rank", job], d,
                       f"file://{base}/store{d}", env=env, cwd=ROOT, timeout=400)
        for rc, so, se in res:
            assert rc == 0, f"a rank of the world of {d} failed:\n{so[-2000:]}{se[-4000:]}"
        return [pickle.load(open(out / f"rank{r}.pkl", "rb")) for r in range(d)]

    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as ex:
        futs = {d: ex.submit(run, d) for d in WORLDS}
        ref = _jax_references(blocks)
        got = {d: f.result() for d, f in futs.items()}
    return got, ref


def _jax_references(blocks) -> dict:
    from sezkp_tpu.commit.merkle import commit_blocks
    from sezkp_tpu.crypto import blake3 as B3
    from sezkp_tpu.ops import goldilocks as G
    from sezkp_tpu.ops import ntt as N
    from sezkp_tpu.parallel.commit_sharded import sharded_merkle_root_u64
    from sezkp_tpu.parallel.mesh import make_mesh
    from sezkp_tpu.parallel.ntt_sharded import sharded_ntt_u64
    from sezkp_tpu.stark.v1.proof import encode_proof
    from sezkp_tpu.stark.v1.prover import prove_v1

    ref = {"ntt_jax": {}, "ntt_host": {}, "root_jax": {}, "root_host": {}}
    for k, n1, mp in NTT_CASES:
        for inverse in (False, True):
            a = _values(k)
            ref["ntt_host"][(k, inverse)] = N.inverse_ntt(a) if inverse else N.forward_ntt(a)
            if mp == 10:  # the JAX split has no phase parameter
                for d in WORLDS:
                    ref["ntt_jax"][(k, n1, d, inverse)] = sharded_ntt_u64(
                        a, make_mesh(d), n1_log2=n1, inverse=inverse)
    for k in ROOT_SIZES:
        v = _values(k)
        for pre in _prefixes():
            msgs = np.concatenate(
                [np.tile(np.frombuffer(pre, dtype=np.uint8), (v.shape[0], 1)),
                 G.to_le_bytes(v).reshape(v.shape[0], 8)], axis=1)
            ref["root_host"][(k, pre)] = B3.merkle_root_leaves(B3.hash_many(msgs))
            # one JAX mesh a case: its compile per call is the cost here
            ref["root_jax"][(k, pre)] = sharded_merkle_root_u64(v, make_mesh(4), pre)
    root = commit_blocks(blocks).root
    ref["manifest_root"] = root
    ref["proof_sha256"] = hashlib.sha256(encode_proof(prove_v1(blocks, root))).hexdigest()
    return ref


@pytest.mark.parametrize("d", WORLDS)
def test_ranks_know_their_world(worlds, d):
    got, _ = worlds
    for r, res in enumerate(got[d]):
        assert (res["rank"], res["size"], res["backend"], res["device"]) == (r, d, "gloo", "cpu")
        assert res["is_coordinator"] == (r == 0)


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("case", NTT_CASES, ids=lambda c: f"k{c[0]}_n1{c[1]}_phase{c[2]}")
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_sharded_ntt_equals_jax_and_host(worlds, d, case, inverse):
    got, ref = worlds
    k, n1, mp = case
    want = ref["ntt_host"][(k, inverse)]
    if mp == 10:
        assert np.array_equal(ref["ntt_jax"][(k, n1, d, inverse)], want)
    for res in got[d]:
        assert np.array_equal(res["ntt"][(k, n1, mp, inverse)], want)


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("k", ROOT_SIZES)
@pytest.mark.parametrize("prefixed", [False, True], ids=["no_prefix", "label_prefix"])
def test_sharded_merkle_root_equals_jax_and_host(worlds, d, k, prefixed):
    got, ref = worlds
    pre = _prefixes()[prefixed]
    want = ref["root_host"][(k, pre)]
    assert ref["root_jax"][(k, pre)] == want
    for res in got[d]:
        assert res["root"][(k, pre)] == want


@pytest.mark.parametrize("d", [2, 4])
def test_multiprocess_contract_commit_and_prove(worlds, d):
    """After the JAX package's test_multiprocess_distributed_commit_and_prove:
    every rank's frontier root and replicated proof equal the JAX sequential
    commit_blocks root and the JAX prove_v1's sha256; the shards tile the
    blocks contiguously."""
    got, ref = worlds
    for res in got[d]:
        assert res["manifest_root"] == ref["manifest_root"]
        assert res["proof_sha256"] == ref["proof_sha256"]
    spans = [res["shard"] for res in got[d]]
    assert spans[0][0] == 0 and spans[-1][1] == 1024 // 64
    assert all(spans[i][1] == spans[i + 1][0] for i in range(d - 1))


def test_distributed_noop_single_process(monkeypatch):
    """ensure_initialized is a no-op without the variables; the helpers work
    in a single process (after the JAX package's test_distributed_noop_single_host)."""
    from sezkp_tpu_torch.parallel import distributed as D

    for var in (D.ENV_COORDINATOR, D.ENV_NUM_PROCESSES, D.ENV_PROCESS_ID):
        monkeypatch.delenv(var, raising=False)
    assert D.ensure_initialized() is False
    assert D.is_coordinator() is True
    assert D.process_shard_bounds(1000) == (0, 1000)
    mesh = D.global_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "none")
    D.barrier("alone")  # no-op


def test_entry_points_need_the_card_without_cpu_argument(monkeypatch):
    import torch

    from sezkp_tpu_torch.parallel import distributed as D
    from sezkp_tpu_torch.parallel.mesh import make_mesh

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable here")
    with pytest.raises(RuntimeError):
        make_mesh()
    monkeypatch.setenv(D.ENV_COORDINATOR, "localhost:1")
    monkeypatch.setenv(D.ENV_NUM_PROCESSES, "2")
    monkeypatch.setenv(D.ENV_PROCESS_ID, "1")
    with pytest.raises(RuntimeError):  # the card is the default: nothing is contacted
        D.ensure_initialized()


def test_ingest_matches_sequential_commit(tmp_path):
    """After the JAX package's test_sharded_ingest_matches_sequential, and on
    an input whose first shard holds >= 256 blocks (the JAX Frontier's fault,
    repaired in the port)."""
    from sezkp_tpu.commit.merkle import commit_block_file
    from sezkp_tpu.core.io import write_block_summaries_jsonl
    from sezkp_tpu.trace.generator import generate_trace
    from sezkp_tpu.trace.partition import partition_trace
    from sezkp_tpu_torch.parallel.ingest import commit_block_file_sharded

    for t, tau, b in ((777, 3, 7), (8192, 2, 4)):  # odd sizes; then 2048 blocks
        path = str(tmp_path / f"blocks_{t}.jsonl")
        write_block_summaries_jsonl(path, partition_trace(generate_trace(t, tau), b))
        seq = commit_block_file(path, str(tmp_path / f"m_{t}.cbor"))
        for hosts in (1, 2, 3, 5):
            sh = commit_block_file_sharded(path, n_hosts=hosts)
            assert sh.root == seq.root and sh.n_leaves == seq.n_leaves
    assert seq.n_leaves >= 5 * 256  # every first shard of the second input
    out = str(tmp_path / "m_sharded.json")
    sh = commit_block_file_sharded(path, n_hosts=2, out_manifest_path=out)
    from sezkp_tpu_torch.commit.merkle import read_manifest_auto

    assert read_manifest_auto(out).root == sh.root


if __name__ == "__main__" and sys.argv[1:2] == ["--rank"]:
    sys.path.insert(0, ROOT)
    _rank_main(json.loads(sys.argv[2]))
