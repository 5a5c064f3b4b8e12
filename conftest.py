"""Build the reference package's native parser once, before the tests run.

``dmlp_tpu.io.native`` compiles ``native/_fastparse.so`` on first use and
writes it straight onto its final path. Under pytest-xdist every worker
collects ``tests/test_native_parser.py``, whose module-level skip builds
the library, so the workers ran g++ at once: a worker that loaded the
file while another was still writing it found no parser, skipped the
file and failed the tests that parse through it, for the rest of its
life. The count of passes then depended on which workers lost the race.

``pytest_configure`` runs in the controlling process before xdist starts
its workers (and in the one process of a plain run), so the build happens
once here; each worker finds a fresh library and only loads it. Without
g++ every process fails the same way.
"""


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    from dmlp_tpu.io import native
    native.native_available()
