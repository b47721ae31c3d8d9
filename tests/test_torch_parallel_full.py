"""The port's fully sharded STARK v1 prover (parallel/prove_sharded.py:
ShardedPipeline, ShardedFri; parallel/engine.py: ShardedProverEngine and
prove_v1_sharded's default) in gloo worlds of D = 1, 2, 4 ranks on the CPU,
one process a rank, against the JAX package's single-chip prove_v1, its
verifier, its _deep_lde and its host FRI (stark/v1/fri.py), and against
traffic.analytic_phase_bytes.

Each world is started once for the module and runs every case; its ranks
are this file run as a script (`--rank JOB`), which imports neither jax nor
the JAX package. Tolerance: none -- field values, roots, paths, proof bytes
and byte counts are compared exactly."""

import copy
import json
import os
import pickle
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = bytes([7]) * 32  # tests/test_stark_v1.py's
P = 0xFFFFFFFF00000001
WORLDS = (1, 2, 4)
TAU = 2
BASE_LOG2, BLOW_LOG2 = 12, 3  # n = 4096, LDE 2^15
TOPS_FORCED = 15  # tops_min_log2 that forces tops mode at LDE 2^15
# tests/test_parallel.py::test_sharded_lde_fri_arrays_actually_sharded's inputs
PIPE_ALPHAS = [3, 5, 7, 11, 13, 17, 19, 23]
PIPE_MASKS = [[1, 2, 3, 4]]
PIPE_Z = 123456789
PIPE_SHIFT = 3


def _pipe_betas_rows():
    rng = np.random.default_rng(14)
    ln_log2 = BASE_LOG2 + BLOW_LOG2
    betas = [int(x) for x in rng.integers(0, P, ln_log2, dtype=np.uint64)]
    rows = [int(x) for x in rng.integers(0, 1 << ln_log2, 12)]
    return betas, rows


def _queries(qs):
    return [(list(q.positions), [(a, list(b), c, list(d)) for a, b, c, d in q.pairs]) for q in qs]


# ------------------------------- the ranks ---------------------------------


def _rank_main(job: dict) -> None:
    import torch

    torch.set_num_threads(1)
    from sezkp_tpu_torch.core.io import read_block_summaries_auto
    from sezkp_tpu_torch.ops import goldilocks_torch as FT
    from sezkp_tpu_torch.parallel import distributed as D
    from sezkp_tpu_torch.parallel.engine import ShardedProverEngine, prove_v1_sharded
    from sezkp_tpu_torch.parallel.prove_sharded import ShardedPipeline
    from sezkp_tpu_torch.stark.v1.air import Alphas
    from sezkp_tpu_torch.stark.v1.columns import TraceColumns
    from sezkp_tpu_torch.stark.v1.proof import encode_proof
    from sezkp_tpu_torch.stark.v1.prover import prove_v1

    assert D.ensure_initialized(device="cpu") is True
    mesh = D.global_mesh()
    out = {"proofs": {}, "stages": {}}
    blocks = read_block_summaries_auto(job["demo"])
    for mode, tops in (("full", 64), ("tops", TOPS_FORCED)):
        timings = {}
        mesh.tally.clear()
        out["proofs"][mode] = encode_proof(
            prove_v1_sharded(blocks, MANIFEST, mesh, timings=timings, tops_min_log2=tops))
        out["stages"][mode] = sorted(timings)
        if mode == "full":
            out["tally"] = copy.deepcopy(mesh.tally)
    # the host-columns input: ShardedPipeline(mesh, tc) with blocks=None
    tc = TraceColumns.build(blocks)
    eng = ShardedProverEngine(tc, mesh, blocks=None)
    out["proofs"]["host_columns"] = encode_proof(prove_v1(blocks, MANIFEST, mesh.device, engine=eng, tc=tc))
    if "b1000" in job:
        out["proofs"]["b1000"] = encode_proof(
            prove_v1_sharded(read_block_summaries_auto(job["b1000"]), MANIFEST, mesh))

    # the pipeline alone, in both tree modes
    betas, rows = _pipe_betas_rows()
    out["pipe"] = {}
    for mode, tops in (("full", 64), ("tops", TOPS_FORCED)):
        fri = ShardedPipeline(mesh, tc, tops_min_log2=tops).deep_lde_fri(
            Alphas.from_list(PIPE_ALPHAS), PIPE_MASKS, BLOW_LOG2, PIPE_SHIFT, PIPE_Z)
        out["pipe"][mode] = dict(
            lde=FT.unpack(fri._trees[0].vals).copy(), tops=fri.tops, root0=fri.commit_layer0(),
            rest=fri.commit_rest(betas), final=fri.final_value_le(),
            queries=_queries(fri.open_queries(rows)))
    with open(os.path.join(job["out"], f"rank{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ------------------------------- the tests ---------------------------------


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write_port_blocks(path, ref_blocks):
    from sezkp_tpu_torch import convert
    from sezkp_tpu_torch.core.io import write_block_summaries_auto

    write_block_summaries_auto(path, convert.blocks_from_reference(ref_blocks))
    return path


def _jax_pipeline_reference(blocks):
    """JAX host references of the pipeline case: the DEEP coset LDE
    (prover._deep_lde of the composition plus masks), the host FRI's roots,
    final value and queries for the same betas and rows."""
    from sezkp_tpu.ops import goldilocks as G
    from sezkp_tpu.ops import ntt as ntt_host
    from sezkp_tpu.stark.v1 import fri as host_fri
    from sezkp_tpu.stark.v1.air import Alphas, compose_all_rows
    from sezkp_tpu.stark.v1.columns import TraceColumns
    from sezkp_tpu.stark.v1.masking import eval_masks_sum_at_points
    from sezkp_tpu.stark.v1.prover import _deep_lde

    tc = TraceColumns.build(blocks)
    comp = compose_all_rows(tc, Alphas.from_list(PIPE_ALPHAS))
    xs = ntt_host.powers(G.primitive_root_2exp(BASE_LOG2), 1 << BASE_LOG2)
    base = G.add(comp, eval_masks_sum_at_points(PIPE_MASKS, xs))
    lde = _deep_lde(base, BLOW_LOG2, PIPE_SHIFT, PIPE_Z)
    betas, rows = _pipe_betas_rows()
    layers = [lde]
    for b in betas:
        layers.append(host_fri.fold(layers[-1], b))
    trees = [host_fri.layer_tree(v) for v in layers]
    return dict(
        lde=lde, root0=trees[0].root(), rest=[t.root() for t in trees[1:]],
        final=G.to_le_bytes(layers[-1][0]).tobytes(),
        queries=_queries(host_fri.fri_open_query(layers, trees, i) for i in rows))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The worlds (D = 1, 2, 4), started at once; the JAX references are
    made while they run."""
    import concurrent.futures

    from sezkp_tpu.stark.v1.proof import encode_proof
    from sezkp_tpu.stark.v1.prover import prove_v1
    from sezkp_tpu.trace.generator import generate_trace
    from sezkp_tpu.trace.partition import partition_trace
    from sezkp_tpu_torch.parallel import distributed as D
    from test_stark_v1 import demo_blocks

    base = tmp_path_factory.mktemp("full_worlds")
    inputs = {
        "demo": demo_blocks(4, 1024, tau=TAU),  # n = 4096, LDE 2^15
        # n = 4096 in blocks of 1000 steps: the shard boundaries of 4 ranks
        # (rows 1024, 2048, 3072) fall inside blocks
        "b1000": partition_trace(generate_trace(4096, TAU), 1000),
    }
    paths = {k: _write_port_blocks(str(base / f"{k}.cbor"), v) for k, v in inputs.items()}
    env = {"PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}

    def world(d):
        out = base / f"d{d}"
        out.mkdir()
        job = {"demo": paths["demo"], "out": str(out)}
        if d == 4:
            job["b1000"] = paths["b1000"]
        res = D.launch([sys.executable, os.path.abspath(__file__), "--rank", json.dumps(job)], d,
                       f"file://{base}/store{d}", env=env, cwd=ROOT, timeout=400)
        for rc, so, se in res:
            assert rc == 0, f"a rank of the world of {d} failed:\n{so[-2000:]}{se[-4000:]}"
        return [pickle.load(open(out / f"rank{r}.pkl", "rb")) for r in range(d)]

    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as ex:
        futs = {d: ex.submit(world, d) for d in WORLDS}
        ref = {k: encode_proof(prove_v1(v, MANIFEST)) for k, v in inputs.items()}
        ref["pipe"] = _jax_pipeline_reference(inputs["demo"])
        got = {d: f.result() for d, f in futs.items()}
    return dict(got=got, ref=ref, inputs=inputs)


@pytest.mark.parametrize("mode", ["full", "tops", "host_columns"])
@pytest.mark.parametrize("d", WORLDS)
def test_sharded_proof_equals_jax_prove(run, d, mode):
    """prove_v1_sharded (the full mode, the default) in full-tree and forced
    tops mode, and prove_v1 with a ShardedProverEngine on the host columns:
    the JAX prove_v1's bytes on every rank, which the JAX verifier accepts."""
    from sezkp_tpu.stark.v1.proof import decode_proof
    from sezkp_tpu.stark.v1.verify import verify_v1

    want = run["ref"]["demo"]
    for res in run["got"][d]:
        assert res["proofs"][mode] == want
    verify_v1(decode_proof(run["got"][d][-1]["proofs"][mode]), run["inputs"]["demo"])


@pytest.mark.parametrize("d", WORLDS)
def test_sharded_prove_stages(run, d):
    for res in run["got"][d]:
        for mode in ("full", "tops"):
            stages = res["stages"][mode]
            for name in ("sharded_phase1", "sharded_fri_commit", "sharded_open"):
                assert name in stages
            assert "host_compose" not in stages and "lde" not in stages


def test_shard_boundaries_inside_blocks(run):
    from sezkp_tpu.stark.v1.proof import decode_proof
    from sezkp_tpu.stark.v1.verify import verify_v1

    blocks = run["inputs"]["b1000"]
    assert [b.n_steps for b in blocks] == [1000] * 4 + [96]
    want = run["ref"]["b1000"]
    for res in run["got"][4]:
        assert res["proofs"]["b1000"] == want
    verify_v1(decode_proof(want), blocks)


@pytest.mark.parametrize("mode", ["full", "tops"])
@pytest.mark.parametrize("d", WORLDS)
def test_pipeline_equals_jax_host_fri(run, d, mode):
    """ShardedPipeline(mesh, tc).deep_lde_fri on each rank: its LDE shard is
    its slice of the JAX _deep_lde; the layer-0 root, the roots of
    commit_rest(betas), the final value and open_queries(rows) are the JAX
    host FRI's."""
    ref = run["ref"]["pipe"]
    ln = 1 << (BASE_LOG2 + BLOW_LOG2)
    for r, res in enumerate(run["got"][d]):
        got = res["pipe"][mode]
        assert got["tops"] is (mode == "tops")
        assert np.array_equal(got["lde"], ref["lde"][r * ln // d : (r + 1) * ln // d])
        assert got["root0"] == ref["root0"]
        assert got["rest"] == ref["rest"]
        assert got["final"] == ref["final"]
        assert got["queries"] == ref["queries"]


@pytest.mark.parametrize("d", [2, 4])
def test_collective_bytes_equal_the_analytic_model(run, d):
    """The tally of one full prove's phases against the port's
    analytic_phase_bytes (which equals the JAX one, test_torch_traffic.py):
    every all-to-all and all-gather term exactly. The model's fold term is
    what a rank hands to the fold's ppermutes (its whole shard a layer); the
    outputs are twice that (each of the four delivers a half shard to every
    rank, zeros where no pair ends), and over all ranks D - 1 of those D
    shards leave their rank (the pairs 0 -> 0 and D-1 -> D-1 stay). The
    halo ppermutes move 2 slabs x tau x 8 B, half the model's term, which
    counts the two u32 planes of an 8-byte element again."""
    import torch

    from sezkp_tpu_torch.parallel.mesh import Mesh
    from sezkp_tpu_torch.parallel.traffic import analytic_phase_bytes, collective_bytes

    model = analytic_phase_bytes(BASE_LOG2, BLOW_LOG2, d, tau=TAU)
    p1, p2 = model["phase1"], model["phase2"]
    a2a = sum(p1[k] for k in ("intt_input_a2a", "intt_internal_a2a", "coeff_relayout_a2a",
                              "lde_internal_a2a", "natural_order_a2a"))
    fold_link = 0
    for r, res in enumerate(run["got"][d]):
        mesh = Mesh(r, d, torch.device("cpu"), "gloo", res["tally"])
        ph1, ph2 = collective_bytes(mesh, "phase1"), collective_bytes(mesh, "phase2")
        assert ph1["all-to-all"]["link_bytes"] == a2a
        assert ph1["all-to-all"]["count"] == 6
        assert ph1["all-gather"]["link_bytes"] == p1["roots_all_gather"]
        assert ph1["collective-permute"]["bytes"] == 2 * TAU * 8 == p1["halo_ppermute"] / 2
        assert set(ph2) == {"all-gather", "collective-permute"}
        assert ph2["all-gather"]["link_bytes"] == p2["tail_all_gather"] + p2["roots_all_gather"]
        assert ph2["collective-permute"]["bytes"] == 2 * p2["fold_ppermutes"]
        assert ph2["collective-permute"]["count"] == 4 * (BASE_LOG2 + BLOW_LOG2 - 11)
        fold_link += ph2["collective-permute"]["link_bytes"]
    assert fold_link == p2["fold_ppermutes"] * (d - 1)


def test_world_of_three_raises_in_the_full_mode():
    """D = 3 is no power of two: the full mode refuses before any collective
    (a mesh of three ranks with no process group behind it)."""
    from sezkp_tpu_torch import convert
    from sezkp_tpu_torch.parallel.engine import prove_v1_sharded
    from sezkp_tpu_torch.parallel.mesh import Mesh
    from test_stark_v1 import demo_blocks

    import torch

    blocks = convert.blocks_from_reference(demo_blocks(4, 1024, tau=TAU))
    mesh = Mesh(0, 3, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="power-of-two world size D with D \\* ln2 \\| n"):
        prove_v1_sharded(blocks, MANIFEST, mesh)


if __name__ == "__main__" and sys.argv[1:2] == ["--rank"]:
    sys.path.insert(0, ROOT)
    _rank_main(json.loads(sys.argv[2]))
