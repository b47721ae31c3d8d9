"""STARK v1 on long traces: the program's `StarkV1.prove`, as for stark-v1,
and the memory-bounded plain reference's prove (plain/stark_v1_bounded.py),
which runs where the whole-tree reference does not fit the card.

The control is that reference with one guarantee of the configuration
broken: 29 FRI and AIR queries where the configuration states 30.
"""

from __future__ import annotations

STAGE_PREFIX = "stark"


def program(config: dict, device):
    from sezkp_tpu_torch.stark.backends import StarkV1

    options = dict(config.get("prove_options", {}))

    def prove(blocks, root, timings=None):
        kw = dict(options)
        if timings is not None:
            kw["timings"] = timings
        return StarkV1.prove(blocks, root, device=device, **kw).proof_bytes

    return prove


def reference(config: dict, device, queries: int = None):
    from plain import stark_v1, stark_v1_bounded

    if stark_v1.BLOWUP != config["blowup"] or stark_v1.NUM_QUERIES != config["queries"]:
        raise ValueError("the configuration states other parameters than the reference's")
    n_queries = config["queries"] if queries is None else queries
    return lambda blocks, root: stark_v1_bounded.prove(blocks, root, device, queries=n_queries)


def control(config: dict, device):
    return reference(config, device, queries=config["queries"] - 1)


def stages(timings: dict):
    """The prove's consecutive stages in order (prove_v1's `_Stages` marks
    each at its end)."""
    return list(timings.items())
