"""The stdin input grammar of the reference harness, as array-producing parsers.

Grammar (reference common.cpp:12-55, generate_input.py:11-21)::

    line 0:                "num_data num_queries num_attrs"
    lines 1..num_data:     "label a1 a2 ... aA"          (one data point each)
    next num_queries:      "Q k a1 a2 ... aA"            (one query each)

Data-point ids are implicit line order (gid, common.cpp:103), query ids are
implicit order among query lines (common.cpp:110). Tokens are whitespace
separated; attribute values are decimals (the generator emits %.6f).

Unlike the reference, which parses into per-record structs
(common.h:10-20) on rank 0 only (common.cpp:93-117), we parse straight into
flat NumPy arrays — the layout the engine stages onto the device. Struct
views are still available for tests/tools.

Error behavior mirrors common.cpp:100-115: empty data line -> "Line is
empty"; query line not starting with 'Q' -> "Line is wrongly formatted".
"""

from __future__ import annotations

import dataclasses
from typing import IO, List, Union

import numpy as np


class ParseError(ValueError):
    """Malformed or truncated input, located by line and byte offset.

    Subclasses ValueError (the historical raise type) so existing
    handlers and tests keep working; the message keeps the reference's
    exact phrasing ("Line is empty" / "Line is wrongly formatted") and
    appends the location — a truncated pipe or corrupted payload names
    WHERE the grammar broke instead of surfacing an uncaught
    struct/index error from the array-filling loop."""

    def __init__(self, message: str, line: int = None,
                 byte_offset: int = None):
        self.line = line
        self.byte_offset = byte_offset
        loc = []
        if line is not None:
            loc.append(f"line {line}")
        if byte_offset is not None:
            loc.append(f"byte offset {byte_offset}")
        super().__init__(message + (f" ({', '.join(loc)})" if loc else ""))


@dataclasses.dataclass(frozen=True)
class Params:
    """Problem-size header (reference common.h:4-8)."""

    num_data: int
    num_queries: int
    num_attrs: int


@dataclasses.dataclass(frozen=True)
class Update:
    """An attribute-update record (reference common.h:22-25, common.cpp:46-55).

    Present in the reference's grammar/data model but never consumed by its
    engine; kept for full contract parity.
    """

    id: int
    new_attrs: np.ndarray


@dataclasses.dataclass
class KNNInput:
    """A fully parsed problem instance in array (SoA) form.

    The reference keeps AoS vectors of structs and flattens them right before
    each MPI scatter (engine.cpp:79-96,154-184); we keep SoA from the start —
    ids are simply ``arange`` (implicit line order), so they are not stored.
    """

    params: Params
    labels: np.ndarray        # (num_data,)  int32
    data_attrs: np.ndarray    # (num_data, num_attrs)  float64
    ks: np.ndarray            # (num_queries,)  int32
    query_attrs: np.ndarray   # (num_queries, num_attrs)  float64

    @property
    def data_ids(self) -> np.ndarray:
        return np.arange(self.params.num_data, dtype=np.int32)

    @property
    def query_ids(self) -> np.ndarray:
        return np.arange(self.params.num_queries, dtype=np.int32)


def subset_queries(inp: KNNInput, idx: np.ndarray) -> KNNInput:
    """A view of ``inp`` restricted to the query rows in ``idx`` (the data
    side is shared, not copied). Used by the heterogeneous-k router
    (engine.single) and the hazard repair (engine.finalize)."""
    return KNNInput(
        Params(inp.params.num_data, len(idx), inp.params.num_attrs),
        inp.labels, inp.data_attrs, inp.ks[idx], inp.query_attrs[idx])


def _strict_int(tok: str) -> int:
    """int() minus PEP 515 underscores. Python would read "1_0" as 10; the
    reference's unchecked ``ss >> val`` stops at the underscore and
    silently misparses (subsequent extractions fail, leaving stale
    values — common.cpp:17-29 never checks the stream). Neither behavior
    is worth copying: this parser (like the reference package's native
    C++ tokenizer) rejects such tokens loudly instead.
    Generator-produced inputs never contain them, so this is a strictness
    choice, not a contract requirement."""
    if "_" in tok:
        raise ValueError(f"invalid integer token {tok!r}")
    return int(tok)


def parse_params(line: str) -> Params:
    """Parse the header line (reference common.cpp:12-15)."""
    toks = line.split()
    try:
        return Params(_strict_int(toks[0]), _strict_int(toks[1]),
                      _strict_int(toks[2]))
    except (IndexError, ValueError):
        raise ParseError("malformed header line (want 'num_data "
                         "num_queries num_attrs')", line=1,
                         byte_offset=0) from None


def parse_update(line: str) -> Update:
    """Parse an update line "id v1 v2 ..." (reference common.cpp:46-55)."""
    toks = line.split()
    return Update(int(toks[0]), np.array([float(t) for t in toks[1:]], dtype=np.float64))


_NATIVE_THRESHOLD_BYTES = 1 << 20  # the native parser pays off past ~1 MB

#: which parser served the last parse_input: "native" or "python"
last_parser = None


def parse_input(stream: Union[IO[str], IO[bytes]]) -> KNNInput:
    """Parse a full problem instance from a text or binary stream.

    Payloads of ``_NATIVE_THRESHOLD_BYTES`` or more go to the native C++
    parser (:mod:`dmlp_tpu_torch.io.native`, the same arrays bit for bit)
    where it is built and ``$DMLP_TPU_NO_NATIVE`` is unset; the rest, and
    whatever the native parser rejects, to the pure-Python parser below,
    which raises the located :class:`ParseError`. ``last_parser`` says
    which one served.

    Injection site ``io.parse`` (resilience.inject): a ``corrupt`` fault
    truncates the payload, the grammar raises :class:`ParseError`, and the
    pristine payload still in memory is parsed, so the results are the
    same bytes."""
    data = stream.read()
    from dmlp_tpu_torch.resilience import inject as rs_inject
    actions = rs_inject.fire("io.parse") or ()
    if "corrupt" in actions:
        try:
            _parse_payload(rs_inject.corrupt_bytes(data))
        except ParseError:
            from dmlp_tpu_torch.resilience import stats as rs_stats
            rs_stats.record_retry("io.parse")
        # The pristine payload is authoritative either way: a corrupted
        # payload's parse result is never returned.
    return _parse_payload(data)


def _parse_payload(data: Union[str, bytes]) -> KNNInput:
    global last_parser
    if len(data) >= _NATIVE_THRESHOLD_BYTES:
        from dmlp_tpu_torch.io import native
        if native.native_available():
            inp = native.parse_native(data)
            if inp is not None:
                last_parser = "native"
                return inp
    last_parser = "python"
    if isinstance(data, bytes):
        data = data.decode("ascii")
    return parse_input_text(data)


def parse_input_text(text: str) -> KNNInput:
    """Parse a full problem instance from a string.

    Mirrors the rank-0 ingest loop at common.cpp:93-117, including its error
    messages, but produces flat arrays. Uses a single bulk tokenizer pass for
    the numeric payload instead of per-line stringstreams — the reference's
    rank-0 ingest is its host-side bottleneck (survey §7 "host input
    pipeline").
    """
    # Split on '\n' EXACTLY (not splitlines(), which also splits on
    # \r, \x0b, \x85, ...): the grammar is '\n'-separated like the
    # native cursor parser, and the incremental byte offsets below are
    # only honest if every separator is one byte of real input — a
    # stray \r rides inside its line (whitespace to the tokenizer) and
    # is counted, not silently split on.
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()   # trailing terminator, not an empty final line
    if not lines:
        raise ParseError("empty input", byte_offset=0)
    params = parse_params(lines[0])
    nd, nq, na = params.num_data, params.num_queries, params.num_attrs
    if len(lines) < 1 + nd + nq:
        raise ParseError(
            f"input has {len(lines) - 1} record lines, expected {nd + nq}"
            " — truncated input?", line=len(lines),
            byte_offset=len(text))

    # Line-start byte offsets, tracked incrementally — exact, because
    # the split above consumes exactly one '\n' per line.
    off = len(lines[0]) + 1

    labels = np.empty(nd, dtype=np.int32)
    data_attrs = np.empty((nd, na), dtype=np.float64)
    for i in range(nd):
        line = lines[1 + i]
        if not line:
            raise ParseError("Line is empty", line=2 + i,  # common.cpp:101
                             byte_offset=off)
        if "_" in line:
            # Python's float()/int() accept PEP 515 underscores ("1_0" ->
            # 10.0); the reference's unchecked stringstream extraction
            # silently misparses them instead (see _strict_int). Reject
            # loudly — matching the native C++ parser, not the reference's
            # silent-garbage behavior.
            raise ParseError("Line is wrongly formatted", line=2 + i,
                             byte_offset=off)
        toks = line.split()
        try:
            if len(toks) < 1 + na:
                # A short row with exactly one attr token would
                # otherwise numpy-broadcast across the whole row —
                # silent misparse, the worst failure mode.
                raise IndexError
            labels[i] = int(toks[0])
            data_attrs[i] = [float(t) for t in toks[1 : 1 + na]]
        except (IndexError, ValueError):
            # Short rows, non-numeric garbage — the uncaught-index-error
            # class a corrupted stdin used to surface raw.
            raise ParseError("Line is wrongly formatted", line=2 + i,
                             byte_offset=off) from None
        off += len(line) + 1

    ks = np.empty(nq, dtype=np.int32)
    query_attrs = np.empty((nq, na), dtype=np.float64)
    for i in range(nq):
        line = lines[1 + nd + i]
        if not line or line[0] != "Q":
            raise ParseError("Line is wrongly formatted",  # common.cpp:114
                             line=2 + nd + i, byte_offset=off)
        if "_" in line:
            raise ParseError("Line is wrongly formatted",
                             line=2 + nd + i, byte_offset=off)
        toks = line[1:].split()
        try:
            if len(toks) < 1 + na:
                raise IndexError   # see the data-row short-row guard
            ks[i] = int(toks[0])
            query_attrs[i] = [float(t) for t in toks[1 : 1 + na]]
        except (IndexError, ValueError):
            raise ParseError("Line is wrongly formatted",
                             line=2 + nd + i, byte_offset=off) from None
        off += len(line) + 1

    return KNNInput(params, labels, data_attrs, ks, query_attrs)


def format_input(inp: KNNInput, precision: int = 6) -> str:
    """Serialize a problem instance back to the input grammar.

    Inverse of :func:`parse_input_text`; matches generate_input.py:11-21
    formatting (%.6f attributes) so round-trips are byte-stable for
    generator-produced data.
    """
    out: List[str] = [
        f"{inp.params.num_data} {inp.params.num_queries} {inp.params.num_attrs}"
    ]
    fmt = f"%.{precision}f"
    for i in range(inp.params.num_data):
        attrs = " ".join(fmt % v for v in inp.data_attrs[i])
        out.append(f"{int(inp.labels[i])} {attrs}")
    for i in range(inp.params.num_queries):
        attrs = " ".join(fmt % v for v in inp.query_attrs[i])
        out.append(f"Q {int(inp.ks[i])} {attrs}")
    return "\n".join(out) + "\n"
