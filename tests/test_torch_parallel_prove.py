"""The port's commitments-sharded STARK v1 prove (parallel/engine.py:
ShardedColumnEngine, prove_v1_sharded(..., commitments_only=True)) in gloo
worlds on the CPU, one process a rank, against the JAX package's single-chip
prove_v1 and ColumnEngine; and the port's CLI run as two ranks through the
SEZKP_* contract against the JAX CLI's files.

Each world is started once for the module and runs every case; its ranks
are this file run as a script (`--rank JOB`), which imports neither jax nor
the JAX package. Tolerance: none -- roots, paths and proof bytes."""

import json
import os
import pickle
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = bytes([7]) * 32  # tests/test_stark_v1.py's
# world size -> the build path its prove of n = 4096 takes (n/D rows whole
# chunks of 1024: row-wise; else column groups)
WORLDS = {2: True, 3: False, 4: True}
ENGINE_ROWS = [("mv_0", 0), ("head_0", 1025), ("is_last", 2047)]
T_CLI = 4096


# ------------------------------- the ranks ---------------------------------


def _rank_main(job: dict) -> None:
    import torch

    torch.set_num_threads(1)
    from sezkp_tpu_torch.core.io import read_block_summaries_auto
    from sezkp_tpu_torch.parallel import distributed as D
    from sezkp_tpu_torch.parallel.engine import ShardedColumnEngine, prove_v1_sharded
    from sezkp_tpu_torch.stark.v1.columns import TraceColumns
    from sezkp_tpu_torch.stark.v1.proof import encode_proof

    assert D.ensure_initialized(device="cpu") is True
    mesh = D.global_mesh()
    built = []  # the build path of each engine, as it runs
    build = ShardedColumnEngine._build

    def spy(self):
        build(self)
        built.append(self.rowwise)

    ShardedColumnEngine._build = spy
    out = {"proofs": {}, "rowwise": {}, "stages": {}}
    for name, path in job["proves"].items():
        blocks = read_block_summaries_auto(path)
        timings = {}
        out["proofs"][name] = encode_proof(
            prove_v1_sharded(blocks, MANIFEST, mesh, commitments_only=True, timings=timings))
        out["rowwise"][name] = built[-1]
        out["stages"][name] = sorted(timings)
    blocks = read_block_summaries_auto(job["engine"])
    eng = ShardedColumnEngine(TraceColumns.build(blocks), mesh, blocks=blocks)
    out["roots"] = [(r.label, r.root) for r in eng.build_roots()]
    out["engine_rowwise"] = eng.rowwise
    out["opens"] = [(o.value_le, o.chunk_root, o.path_in_chunk, o.path_to_chunk)
                    for o in (eng.open(lb, row) for lb, row in ENGINE_ROWS)]
    with open(os.path.join(job["out"], f"rank{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ------------------------------- the tests ---------------------------------


def _write_port_blocks(path, ref_blocks):
    from sezkp_tpu_torch import convert
    from sezkp_tpu_torch.core.io import write_block_summaries_auto

    write_block_summaries_auto(path, convert.blocks_from_reference(ref_blocks))
    return path


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The worlds (D = 2, 3, 4) and the 2-rank CLI, started at once; the JAX
    references are made while they run."""
    import concurrent.futures

    from sezkp_tpu import cli as ref_cli
    from sezkp_tpu.stark.v1 import params
    from sezkp_tpu.stark.v1.columns import TraceColumns
    from sezkp_tpu.stark.v1.openings import ColumnEngine
    from sezkp_tpu.stark.v1.proof import encode_proof
    from sezkp_tpu.stark.v1.prover import prove_v1
    from sezkp_tpu.trace.generator import generate_trace
    from sezkp_tpu.trace.partition import partition_trace
    from sezkp_tpu_torch.parallel import distributed as D
    from test_stark_v1 import demo_blocks

    base = tmp_path_factory.mktemp("prove_worlds")
    inputs = {
        "demo": demo_blocks(4, 1024, tau=2),  # n = 4096 -> 4 column chunks
        # n = 4096 in blocks of 1000 steps: the shard boundaries of 4 ranks
        # (rows 1024, 2048, 3072) fall inside blocks
        "b1000": partition_trace(generate_trace(4096, 2), 1000),
    }
    paths = {k: _write_port_blocks(str(base / f"{k}.cbor"), v) for k, v in inputs.items()}
    engine_blocks = demo_blocks(2, 1024, tau=1)
    engine_path = _write_port_blocks(str(base / "engine.cbor"), engine_blocks)
    env = {"PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}

    def world(d):
        out = base / f"d{d}"
        out.mkdir()
        proves = {"demo": paths["demo"]}
        if d == 4:
            proves["b1000"] = paths["b1000"]
        job = json.dumps({"proves": proves, "engine": engine_path, "out": str(out)})
        res = D.launch([sys.executable, os.path.abspath(__file__), "--rank", job], d,
                       f"file://{base}/store{d}", env=env, cwd=ROOT, timeout=400)
        for rc, so, se in res:
            assert rc == 0, f"a rank of the world of {d} failed:\n{so[-2000:]}{se[-4000:]}"
        return [pickle.load(open(out / f"rank{r}.pkl", "rb")) for r in range(d)]

    # the files: simulate, commit and the single-process prove by the JAX CLI
    cli_dir = base / "cli"
    cli_dir.mkdir()
    blocks_f, man_f = str(cli_dir / "blocks.cbor"), str(cli_dir / "manifest.cbor")
    assert ref_cli.main(["simulate", "--t", str(T_CLI), "--b", "512", "--tau", "2",
                         "--out-blocks", blocks_f]) == 0
    assert ref_cli.main(["commit", "--blocks", blocks_f, "--out", man_f]) == 0

    def cli_world():
        # python -m sezkp_tpu_torch, but every rank writes its own file: the
        # rank's index replaces RANK in the last argument
        script = ("import os, sys; from sezkp_tpu_torch import cli; a = sys.argv[1:]; "
                  "a[-1] = a[-1].replace('RANK', os.environ['SEZKP_PROCESS_ID']); sys.exit(cli.main(a))")
        argv = ["prove", "--backend", "stark", "--device", "cpu", "--blocks", blocks_f,
                "--manifest", man_f, "--out", str(cli_dir / "proof_RANK.cbor")]
        res = D.launch([sys.executable, "-c", script, *argv], 2, f"file://{base}/store_cli",
                       env=env, cwd=ROOT, timeout=400)
        for rc, so, se in res:
            assert rc == 0, f"a CLI rank failed:\n{so[-2000:]}{se[-4000:]}"

    with concurrent.futures.ThreadPoolExecutor(len(WORLDS) + 1) as ex:
        futs = {d: ex.submit(world, d) for d in WORLDS}
        fut_cli = ex.submit(cli_world)
        ref = {k: encode_proof(prove_v1(v, MANIFEST)) for k, v in inputs.items()}
        tc = TraceColumns.build(engine_blocks)
        ref_eng = ColumnEngine(tc, params.COL_CHUNK_LOG2)
        ref["roots"] = [(r.label, r.root) for r in ref_eng.build_roots()]
        ref["opens"] = [(o.value_le, o.chunk_root, o.path_in_chunk, o.path_to_chunk)
                        for o in (ref_eng.open(lb, row) for lb, row in ENGINE_ROWS)]
        ref_proof = str(cli_dir / "proof_ref.cbor")
        assert ref_cli.main(["prove", "--backend", "stark", "--blocks", blocks_f, "--manifest", man_f,
                             "--out", ref_proof]) == 0
        got = {d: f.result() for d, f in futs.items()}
        fut_cli.result()
    return dict(got=got, ref=ref, inputs=inputs, cli_dir=cli_dir, blocks_f=blocks_f, man_f=man_f)


@pytest.mark.parametrize("d", sorted(WORLDS))
def test_commitments_sharded_proof_equals_jax_prove(run, d):
    from sezkp_tpu_torch import convert
    from sezkp_tpu_torch.stark.v1.proof import decode_proof
    from sezkp_tpu_torch.stark.v1.verify import verify_v1

    want = run["ref"]["demo"]
    for res in run["got"][d]:
        assert res["proofs"]["demo"] == want
    verify_v1(decode_proof(want), convert.blocks_from_reference(run["inputs"]["demo"]))


@pytest.mark.parametrize("d", sorted(WORLDS))
def test_build_path_by_world_size(run, d):
    for res in run["got"][d]:
        assert res["rowwise"]["demo"] is WORLDS[d]
        assert "host_columns" in res["stages"]["demo"]  # the prove's route with an engine
        # the engine of n = 2048: whole chunks per rank only at D = 2
        assert res["engine_rowwise"] is (d == 2)
    if d == 4:
        assert run["got"][d][0]["rowwise"]["b1000"] is True


def test_shard_boundaries_inside_blocks(run):
    from sezkp_tpu_torch import convert
    from sezkp_tpu_torch.stark.v1.proof import decode_proof
    from sezkp_tpu_torch.stark.v1.verify import verify_v1

    blocks = run["inputs"]["b1000"]
    assert [b.n_steps for b in blocks] == [1000] * 4 + [96]
    want = run["ref"]["b1000"]
    for res in run["got"][4]:
        assert res["proofs"]["b1000"] == want
    verify_v1(decode_proof(want), convert.blocks_from_reference(blocks))


@pytest.mark.parametrize("d", sorted(WORLDS))
def test_sharded_column_engine_roots_and_opens(run, d):
    """After the JAX package's test_sharded_column_engine_roots_and_opens:
    the same roots and openings as the JAX ColumnEngine and the port's."""
    from sezkp_tpu_torch import convert
    from sezkp_tpu_torch.stark.v1 import params
    from sezkp_tpu_torch.stark.v1.columns import TraceColumns
    from sezkp_tpu_torch.stark.v1.openings import ColumnEngine
    from test_stark_v1 import demo_blocks

    blocks = convert.blocks_from_reference(demo_blocks(2, 1024, tau=1))
    port = ColumnEngine(TraceColumns.build(blocks), params.COL_CHUNK_LOG2, device="cpu")
    port_roots = [(r.label, r.root) for r in port.build_roots()]
    port_opens = [(o.value_le, o.chunk_root, o.path_in_chunk, o.path_to_chunk)
                  for o in (port.open(lb, row) for lb, row in ENGINE_ROWS)]
    assert port_roots == run["ref"]["roots"] and port_opens == run["ref"]["opens"]
    for res in run["got"][d]:
        assert res["roots"] == run["ref"]["roots"]
        assert res["opens"] == run["ref"]["opens"]


def test_cli_two_ranks_write_the_jax_cli_file(run):
    """`prove --backend stark --device cpu` as two ranks on the SEZKP_*
    contract: each rank's file equals the JAX CLI's, and verifies."""
    from sezkp_tpu_torch import cli

    cli_dir = run["cli_dir"]
    want = (cli_dir / "proof_ref.cbor").read_bytes()
    for r in range(2):
        assert (cli_dir / f"proof_{r}.cbor").read_bytes() == want
    assert cli.main(["verify", "--backend", "stark", "--blocks", run["blocks_f"], "--manifest",
                     run["man_f"], "--proof", str(cli_dir / "proof_1.cbor")]) == 0


def test_fully_sharded_prove_is_not_ported_yet():
    """Once the check that the fully sharded prover was not ported; it is now
    prove_v1_sharded's default (tests/test_torch_parallel_full.py holds it
    to the JAX prove in worlds of 1, 2 and 4 ranks). Here, in a world of one
    without a process group: the default call takes the sharded stages, not
    the host composition, and gives the bytes of the port's prove_v1."""
    import torch

    from sezkp_tpu_torch import convert
    from sezkp_tpu_torch.parallel.engine import prove_v1_sharded
    from sezkp_tpu_torch.parallel.mesh import make_mesh
    from sezkp_tpu_torch.stark.v1.proof import encode_proof
    from sezkp_tpu_torch.stark.v1.prover import prove_v1
    from test_stark_v1 import demo_blocks

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        blocks = convert.blocks_from_reference(demo_blocks(2, 1024, tau=1))
        timings = {}
        got = encode_proof(prove_v1_sharded(blocks, MANIFEST, make_mesh(device="cpu"), timings=timings))
        assert encode_proof(prove_v1(blocks, MANIFEST, "cpu")) == got
    finally:
        torch.set_num_threads(threads)
    assert {"sharded_phase1", "sharded_fri_commit", "sharded_open"} <= set(timings)
    assert "host_compose" not in timings


if __name__ == "__main__" and sys.argv[1:2] == ["--rank"]:
    sys.path.insert(0, ROOT)
    _rank_main(json.loads(sys.argv[2]))
