"""The port's native parser (``dmlp_tpu_torch.io.native``, its own
``io/fastparse.cpp``): arrays bit for bit equal to the Python parser's on
datagen inputs and edge tokens; on malformed inputs the Python parser's
error (message, line and byte offset), whose reason is the reference
native parser's; ``parse_input``'s size threshold, ``DMLP_TPU_NO_NATIVE``
and the fallback where g++ is missing; the build lands in
``dmlp_tpu_torch/_build/``."""

import io
import os
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

from dmlp_tpu.io import native as ref_native  # noqa: E402
from dmlp_tpu_torch.io import grammar, native  # noqa: E402
from dmlp_tpu_torch.io.datagen import generate_input_text  # noqa: E402
from dmlp_tpu_torch.io.grammar import ParseError, parse_input_text  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _built(monkeypatch):
    monkeypatch.delenv("DMLP_TPU_NO_NATIVE", raising=False)
    info = native.build()
    assert info["ok"], info
    yield


def _same(a, b):
    assert a.params == b.params
    for f in ("labels", "data_attrs", "ks", "query_attrs"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), f


def test_builds_into_the_ports_build_directory():
    path = native.library_path()
    assert path.parent == ROOT / "dmlp_tpu_torch" / "_build"
    assert path.exists() and path.name.startswith("fastparse-")
    assert native.SOURCE == ROOT / "dmlp_tpu_torch" / "io" / "fastparse.cpp"


@pytest.mark.parametrize("args", [
    (300, 40, 7, -1000, 1000, 1, 12, 5, 1),
    (500, 60, 16, 0, 100, 1, 32, 10, 2),
    (50, 5, 3, -1e-3, 1e-3, 1, 4, 2, 3),
    (7, 0, 2, -5, 5, 1, 2, 2, 5),
    "0 2 3\nQ 1 1 2 3\nQ 2 4 5 6",
    "2 1 0\n4\n-7 extra tokens\nQ 3\n\ntrailing lines\n",
])
def test_arrays_equal_the_python_parser(args):
    if isinstance(args, str):
        text = args
    else:
        *gen, seed = args
        text = generate_input_text(*gen, seed=seed)
    _same(native.parse_native(text), parse_input_text(text))
    _same(native.parse_native(text.encode()), parse_input_text(text))


@pytest.mark.parametrize("tok", [
    "2.", ".5", "-2.5", "+3", "1e3", "1E+03", "-1.5e-7", "3",
    "0.1234567890123456789", "123456789012345678.9",
    "1.7976931348623157e308", "4.9e-324", "1e400", "000123.4500",
    "inf", "-Infinity", "nan"])
def test_edge_tokens_parse_as_python(tok):
    """Decimals parse natively to Python's float() bit for bit; the few
    tokens only Python takes (inf, nan) reach the Python parser."""
    text = f"2 1 2\n0 {tok} 1.0\n-3 2.5 {tok}\nQ 1 {tok} 0.25\n"
    want = parse_input_text(text)
    got = native.parse_native(text)
    if tok.lower().lstrip("+-") in ("inf", "infinity", "nan"):
        assert got is None
        grammar_got = _parse_big(text)
        np.testing.assert_array_equal(grammar_got.data_attrs,
                                      want.data_attrs)
        assert grammar.last_parser == "python"
        return
    _same(got, want)


def _parse_big(text):
    """parse_input with the threshold at 1 byte (the native route)."""
    old = grammar._NATIVE_THRESHOLD_BYTES
    grammar._NATIVE_THRESHOLD_BYTES = 1
    try:
        return grammar.parse_input(io.BytesIO(text) if isinstance(
            text, bytes) else io.StringIO(text))
    finally:
        grammar._NATIVE_THRESHOLD_BYTES = old


MALFORMED = {
    "query_not_q": "1 1 2\n0 1.0 2.0\nX 1 1.0 2.0\n",
    "empty_data_line": "2 0 2\n0 1.0 2.0\n\n",
    "fractional_label": "1 0 2\n3.5 1.0 2.0\n",
    "space_before_q": "1 1 1\n0 1.0\n  Q 1 1.0\n",
    "short_row": "2 1 3\n0 1.0 2.0 3.0\n1 1.0\nQ 1 1 2 3\n",
    "garbage_attr": "2 1 2\n1 1.0 2.0\n0 3.0 1.5abc\nQ 1 1.0 2.0\n",
    "hex_attr": "2 1 2\n1 1.0 2.0\n0 3.0 0x10\nQ 1 1.0 2.0\n",
    "underscore": "2 1 2\n1 1.0 2.0\n0 3.0 1_0\nQ 1 1.0 2.0\n",
    "bare_exponent": "2 1 2\n1 1.0 2.0\n0 3.0 2.e\nQ 1 1.0 2.0\n",
    "double_sign": "2 1 2\n1 1.0 2.0\n0 3.0 --3\nQ 1 1.0 2.0\n",
    "whitespace_line": "2 0 2\n0 1.0 2.0\n \t\n",
    "truncated": "3 1 2\n0 1.0 2.0\n1 1.0 2.0\n",
    "bad_header": "2 x 2\n0 1 2\n1 1 2\n",
    "short_header": "2 1\n0 1 2\n",
    "empty": "",
    "bad_k": "1 1 1\n0 1.0\nQ x 1.0\n",
}
# The reference native parser's own error-contract cases
# (tests/test_native_parser.py): the same reason.
REFERENCE_REASON = ("query_not_q", "empty_data_line", "space_before_q",
                    "garbage_attr")


@pytest.mark.parametrize("name", list(MALFORMED))
def test_errors_are_the_python_parsers(name):
    text = MALFORMED[name]
    assert native.parse_native(text) is None
    with pytest.raises(ParseError) as want:
        parse_input_text(text)
    with pytest.raises(ParseError) as got:
        _parse_big(text.encode())
    assert str(got.value) == str(want.value)
    assert (got.value.line, got.value.byte_offset) == \
        (want.value.line, want.value.byte_offset)
    if name in REFERENCE_REASON:
        with pytest.raises(ValueError) as ref:
            ref_native.parse_input_text_native(text)
        reason = str(ref.value).split(" (")[0]
        assert str(got.value).split(" (")[0] == reason


def test_label_past_int32_raises_as_python():
    text = "1 0 1\n3000000000 1.0\n"
    assert native.parse_native(text) is None
    with pytest.raises(OverflowError):
        parse_input_text(text)
    with pytest.raises(OverflowError):
        _parse_big(text)


def test_non_ascii_payload_takes_the_python_path():
    text = "1 0 1\n0 1.0\n# é\n"
    assert native.parse_native(text) is None
    assert native.parse_native(text.encode("utf-8")) is None
    with pytest.raises(UnicodeDecodeError):
        _parse_big(text.encode("utf-8"))


def test_threshold_and_kill_switch(monkeypatch):
    text = generate_input_text(200, 10, 4, 0, 10, 1, 5, 3, seed=8)
    grammar.parse_input(io.StringIO(text))
    assert grammar.last_parser == "python"          # below 1 MiB
    _same(_parse_big(text), parse_input_text(text))
    assert grammar.last_parser == "native"
    monkeypatch.setenv("DMLP_TPU_NO_NATIVE", "1")
    _same(_parse_big(text), parse_input_text(text))
    assert grammar.last_parser == "python"
    big = generate_input_text(12000, 100, 16, 0, 100, 1, 8, 5, seed=9)
    assert len(big) >= grammar._NATIVE_THRESHOLD_BYTES
    monkeypatch.delenv("DMLP_TPU_NO_NATIVE")
    _same(grammar.parse_input(io.BytesIO(big.encode())),
          parse_input_text(big))
    assert grammar.last_parser == "native"


def test_missing_compiler_falls_back_to_python(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build_error", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    info = native.build()
    assert not info["ok"] and "g++" in info["error"]
    assert not native.native_available()
    text = generate_input_text(30, 3, 2, 0, 1, 1, 2, 2, seed=1)
    _same(_parse_big(text), parse_input_text(text))
    assert grammar.last_parser == "python"
    assert list(tmp_path.iterdir()) == []


def test_io_parse_corrupt_recovers_on_the_native_route():
    from dmlp_tpu_torch.resilience import inject, stats
    text = generate_input_text(300, 20, 4, 0, 10, 1, 5, 3, seed=2)
    stats.reset()
    inject.install(inject.FaultSchedule.from_dict(
        {"schema": 1, "seed": 0, "faults": [
            {"site": "io.parse", "kind": "corrupt", "times": 1}]}))
    try:
        got = _parse_big(text.encode())
    finally:
        inject.uninstall()
    assert stats.snapshot()["retries"] == 1
    stats.reset()
    _same(got, parse_input_text(text))
    assert grammar.last_parser == "native"


def test_never_writes_under_the_reference_native_directory():
    src = (ROOT / "native" / "fastparse.cpp").read_bytes()
    assert native.SOURCE.read_bytes() != src   # the port's own copy
    assert not str(native.library_path()).startswith(
        str(ROOT / "native") + os.sep)
