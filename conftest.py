"""Repository-level pytest hook: build the JAX package's native libraries
once, before the tests start.

sezkp_tpu/utils/cbor.py and sezkp_tpu/crypto/blake3.py build
sezkp_tpu/native/*.so with `make` when they are first imported, and the
Makefile writes each library straight to its final name. Under pytest-xdist
every worker imports them at collection, so on a fresh checkout a worker
could load a half-written library (the CBOR codec then stays None). pytest
runs this hook in the xdist controller before any worker starts (and in a
plain run before collection), so the workers find finished files. A failed
build is reported as a warning; the tests that need the libraries then fail
as they would without this hook.
"""

import os
import subprocess

import pytest

NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sezkp_tpu", "native")
LIBS = ("sezkp_cbor_c.so", "libsezkp_blake3.so")


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the controller built them
        return
    try:
        r = subprocess.run(["make", "-C", NATIVE, "-s", *LIBS], capture_output=True, text=True)
        failure = None if r.returncode == 0 else f"exit {r.returncode}: {(r.stdout + r.stderr)[-2000:]}"
    except OSError as e:  # no make on this machine
        failure = repr(e)
    if failure is not None:
        config.issue_config_time_warning(
            pytest.PytestWarning(f"building {', '.join(LIBS)} in {NATIVE} failed ({failure})"), stacklevel=2)
