"""The port's CBOR codec (sezkp_tpu_torch.utils.cbor) vs the JAX package's, on
the CPU: same bytes out, same values back, with the native extension and with
the pure-Python codec.

Tolerance: none -- encoded bytes and decoded values are compared for equality."""

import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sezkp_tpu.fold.api import DriverOptions as RefOptions
from sezkp_tpu.fold.driver import run_pipeline as ref_run_pipeline
from sezkp_tpu.trace.generator import generate_trace
from sezkp_tpu.trace.partition import partition_trace
from sezkp_tpu.utils import cbor as ref_cbor
from sezkp_tpu_torch.convert import blocks_from_reference
from sezkp_tpu_torch.fold.api import DriverOptions
from sezkp_tpu_torch.fold.driver import run_pipeline
from sezkp_tpu_torch.utils import cbor

CODECS = ["native", "python"]


@pytest.fixture(params=CODECS)
def codec(request, monkeypatch):
    """The port's module with its native extension, or forced to pure Python."""
    if request.param == "python":
        monkeypatch.setattr(cbor, "native", lambda: None)
    else:
        assert cbor.native() is not None, "the native CBOR extension did not build"
    return cbor


@pytest.fixture(scope="module")
def bundles():
    """The fold bundle of one input as each package's object tree (they differ
    in the class that holds a digest): (reference's, port's)."""
    blocks = partition_trace(generate_trace(128, 3), 8)
    ref = ref_run_pipeline(blocks, RefOptions(wrap_cadence=2)).to_obj()
    port = run_pipeline(blocks_from_reference(blocks), DriverOptions(wrap_cadence=2)).to_obj()
    return ref, port


def test_native_extension_is_built_from_the_ports_sources():
    path = cbor.native().__file__
    assert os.sep + os.path.join("sezkp_tpu_torch", "_build") + os.sep in path
    assert cbor.native() is not ref_cbor._native


def test_fold_bundle_bytes_and_round_trip(codec, bundles):
    ref_obj, port_obj = bundles
    data = ref_cbor.dumps(ref_obj)
    assert codec.dumps(port_obj) == data
    back = codec.loads(data)
    assert back == ref_cbor.loads(data)
    assert codec.dumps(back) == data


def test_sequence_round_trip(codec, bundles):
    ref_obj, port_obj = bundles
    head, foot = {"magic": "sezkp-fold-seq", "ver": 1}, {"n_blocks": 16}
    data = b"".join(ref_cbor.dumps(x) for x in (head, ref_obj["leaves"][0], foot))
    assert b"".join(codec.dumps(x) for x in (head, port_obj["leaves"][0], foot)) == data
    assert codec.loads_seq(data) == ref_cbor.loads_seq(data)
    dec = codec.CBORDecoder(data)
    seen = []
    while not dec.at_end():
        seen.append(dec.decode())
    assert seen == ref_cbor.loads_seq(data)


@pytest.mark.parametrize(
    "value",
    [0, 23, 24, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1, -24, -25, -(2**63),
     "", "héllo", b"", b"\x00\xff", [], {}, None, True, False, 1.5, -0.0, 1e300,
     [1, [2, [3, {"k": None}]]], {"a": {"b": {"c": [0] * 30}}}],
    ids=repr,
)
def test_scalars_and_nesting(codec, value):
    data = ref_cbor.dumps(value)
    assert codec.dumps(value) == data
    assert codec.loads(data) == ref_cbor.loads(data)


def test_u8array_and_tagged(codec):
    digest = bytes(range(32))
    obj = {"root": cbor.U8Array(digest), "len": 7}
    ref_obj = {"root": ref_cbor.U8Array(digest), "len": 7}
    data = ref_cbor.dumps(ref_obj)
    assert codec.dumps(obj) == data == ref_cbor.dumps({"root": list(digest), "len": 7})
    assert bytes(codec.loads(data)["root"]) == digest
    tagged = ref_cbor.dumps(ref_cbor.Tagged(42, [1, 2]))
    assert codec.dumps(cbor.Tagged(42, [1, 2])) == tagged
    got = codec.loads(tagged)
    assert (got.tag, got.value) == (42, [1, 2])


@pytest.mark.parametrize("data", [b"", b"\x18", b"\x82\x01", b"\xa1\x61", b"\x01\x02", b"\x5f\x41"])
def test_malformed_input_rejected_like_the_reference(codec, data):
    with pytest.raises(Exception) as ref_err:
        ref_cbor.loads(data)
    with pytest.raises(type(ref_err.value)):
        codec.loads(data)


_leaf = st.one_of(
    st.none(), st.booleans(),
    st.integers(min_value=-(2**63), max_value=2**64 - 1),
    st.text(max_size=12), st.binary(max_size=12),
    st.floats(allow_nan=False),
)
_nested = st.recursive(
    _leaf,
    lambda inner: st.one_of(
        st.lists(inner, max_size=5),
        st.dictionaries(st.text(max_size=6), inner, max_size=5),
    ),
    max_leaves=25,
)


@pytest.mark.parametrize("which", CODECS)
@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(obj=_nested)
def test_hypothesis_nested_objects(which, obj):
    saved = cbor.native
    if which == "python":
        cbor.native = lambda: None
    try:
        data = ref_cbor.dumps(obj)
        assert cbor.dumps(obj) == data
        assert cbor.loads(data) == ref_cbor.loads(data) == obj
        assert cbor.loads_seq(data + data) == [obj, obj]
    finally:
        cbor.native = saved


def test_numpy_integers_encode_like_the_reference(codec):
    obj = {"n": np.uint32(7), "xs": [np.int64(-3), np.uint64(2**40)]}
    try:
        want = ref_cbor.dumps(obj)
    except Exception as e:
        with pytest.raises(type(e)):
            codec.dumps(obj)
    else:
        assert codec.dumps(obj) == want
