"""Repository-level pytest hook: build the native data loader once,
before pytest-xdist starts its workers.

``tests/test_native_loader.py`` and ``tests/test_prepare.py`` ask at
import whether ``tpu_hpc/native``'s C++ library is available, and the
library builds on first use: g++ writes ``libtpu_hpc_data.so`` in place
when it is missing or older than its source. Under ``-p xdist -n N``
every worker imports every test file at the same moment, so N g++
processes wrote the same file while other workers loaded it, and a
worker that loaded a half-written library found it "unavailable" and
skipped every loader test (20 of them in one run on a fresh checkout,
none in another). Building it here, in the controller process and
before any worker starts, leaves the workers a finished library to
load. Nothing else changes: the loader module is read from its file, so
this neither imports the ``tpu_hpc`` package (whose import pulls in JAX
before ``tests/conftest.py`` has set its platform flags) nor touches
how any test runs.
"""
import importlib.util
import os
import sys

_LOADER = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "tpu_hpc", "native", "dataloader.py",
)


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: already built
        return
    name = "_native_loader_prebuild"
    spec = importlib.util.spec_from_file_location(name, _LOADER)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # its dataclasses look their module up
    try:
        spec.loader.exec_module(module)
        module.native_available()
    finally:
        del sys.modules[name]
