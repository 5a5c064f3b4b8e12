"""The batch engine's spans and counts (``engine/single.py`` under
``obs/trace.py``): a device-full solve on the CPU splits into linked
spans under one root a solve, each chunk's cast a child of the chunk
loop, the host-to-device bytes and the bytes cast that it counts equal
the byte arithmetic of its input, the tracer's ids, parents and counts
follow each thread's open spans, the CLI's trace with them passes
``tools/check_trace.py`` and ``obs_trace.tree_faults``, the routed
(mixed-k) solve splits the same way, and with no tracer every new hook
stays the shared no-op."""

import dataclasses
import io
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from dmlp_tpu_torch import cli
from dmlp_tpu_torch.config import EngineConfig
from dmlp_tpu_torch.engine import chunks, single
from dmlp_tpu_torch.engine.single import SingleChipEngine, plan_chunks
from dmlp_tpu_torch.io.datagen import generate_input_text
from dmlp_tpu_torch.io.grammar import parse_input_text
from dmlp_tpu_torch.obs import trace as obs_trace
from dmlp_tpu_torch.ops.extract import QUERY_TILE

ROOT = Path(__file__).resolve().parents[1]

# 9,000 rows in chunks of 1,024 (the extraction granule divides it): 9
# staged chunks, the last one part padding; ks 1..16 of 40 queries.
N, NQ, NA, BLOCK = 9000, 40, 6, 1024
CHILDREN = {"single.host_copy", "single.enqueue_extract",
            "single.extract_epilogue", "single.fetch", "single.finalize"}


@pytest.fixture(scope="module")
def inp():
    return parse_input_text(generate_input_text(N, NQ, NA, 0.0, 50.0, 1, 16,
                                                5, seed=23))


def _engine():
    return SingleChipEngine(EngineConfig(device="cpu", use_pallas=True,
                                         select="extract", data_block=BLOCK))


def _traced(engine, inp, solves):
    tracer = obs_trace.install(obs_trace.Tracer())
    try:
        for _ in range(solves):
            engine.run_device_full(inp)
    finally:
        obs_trace.uninstall()
    return [e for e in tracer.events() if e["ph"] == "X"]


def _plan(engine):
    """(chunks planned, chunks staged, chunk rows, padded queries)."""
    _, nchunks, rows = plan_chunks(N, engine.config.resolve_granule(
        "extract"), BLOCK)
    return nchunks, -(-N // rows), rows, -(-NQ // QUERY_TILE) * QUERY_TILE


def test_a_device_full_solve_is_one_linked_tree_a_solve(inp):
    engine = _engine()
    spans = _traced(engine, inp, 2)
    roots = [e for e in spans if e["name"] == "single.run_device_full"]
    assert len(roots) == 2
    assert all(e["args"]["parent"] is None for e in roots)
    ids = [e["args"]["id"] for e in spans]
    assert len(set(ids)) == len(ids)
    for r in roots:
        kids = [e for e in spans if e["args"]["parent"] == r["args"]["id"]]
        assert {e["name"] for e in kids} == CHILDREN
        for e in kids:
            assert r["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= r["ts"] + r["dur"] + 1e-3
    # A host copy a solve for the queries, under the root, and one for
    # each staged chunk, under the chunk loop; no pin on the CPU.
    _, staged, _, _ = _plan(engine)
    for r in roots:
        rid = r["args"]["id"]
        loop = [e for e in spans if e["name"] == "single.enqueue_extract"
                and e["args"]["parent"] == rid]
        assert len(loop) == 1
        copies = [e for e in spans if e["name"] == "single.host_copy"
                  and r["ts"] <= e["ts"] <= r["ts"] + r["dur"]]
        assert [e["args"]["parent"] for e in copies] == \
            [rid] + [loop[0]["args"]["id"]] * staged
        assert [e["args"].get("chunk") for e in copies] == \
            [None] + list(range(staged))
    assert sum(e["name"] == "single.host_copy" for e in spans) \
        == 2 * (1 + staged)
    assert not any(e["name"] == "single.pin" for e in spans)
    phases = engine.last_phase_ms
    assert {"copy", "pin", "launch", "chunk_wait", "enqueue", "fetch",
            "finalize"} <= set(phases)
    assert phases["chunk_wait"] == 0.0 and phases["pin"] < phases["enqueue"]
    assert phases["copy"] + phases["launch"] <= phases["enqueue"]


def test_h2d_bytes_are_the_byte_arithmetic_of_the_input(inp):
    engine = _engine()
    spans = _traced(engine, inp, 1)
    _, staged, rows, qpad = _plan(engine)
    want = {"chunks": staged * rows * NA * 4, "queries": qpad * NA * 4,
            "labels": N * 4, "ks": qpad * 4}
    by = {e["name"]: e["args"].get("h2d_bytes") for e in spans}
    assert by["single.run_device_full"] == sum(want.values())
    assert by["single.enqueue_extract"] == want["chunks"]
    assert by["single.extract_epilogue"] == want["labels"]
    assert by["single.fetch"] == want["ks"]
    copies = [e["args"]["bytes"] for e in spans
              if e["name"] == "single.host_copy"]
    assert copies == [want["queries"]] + [rows * NA * 4] * staged
    assert sum(copies[1:]) == want["chunks"]
    # The bytes cast: the padded corpus's staged chunks and the queries.
    cast = {e["name"]: e["args"].get("host_cast_bytes") for e in spans}
    assert cast["single.run_device_full"] == want["chunks"] \
        + want["queries"]
    assert cast["single.enqueue_extract"] == want["chunks"]
    assert cast["single.fetch"] is None


def test_no_tracer_leaves_every_hook_the_shared_no_op(inp, monkeypatch):
    """Off means off: with no tracer and no telemetry observer every span
    the solve opens is NULL_SPAN, and no count reaches a tracer."""
    opened = []

    def spy(name, **args):
        sp = obs_trace.span(name, **args)
        opened.append((name, sp))
        return sp

    def refuse(*a, **k):
        raise AssertionError("a tracer was reached with tracing off")

    monkeypatch.setattr(single, "obs_span", spy)
    monkeypatch.setattr(chunks, "obs_span", spy)
    monkeypatch.setattr(obs_trace.Tracer, "count", refuse)
    monkeypatch.setattr(obs_trace.Tracer, "span", refuse)
    assert obs_trace.active() is None and not obs_trace.sinks_active()
    _engine().run_device_full(inp)
    names = {n for n, _ in opened}
    assert CHILDREN | {"single.run_device_full"} <= names
    assert all(sp is obs_trace.NULL_SPAN for _, sp in opened)
    assert obs_trace.count("h2d_bytes", 5) is None


def test_counts_go_to_the_innermost_span_and_roll_up():
    tracer = obs_trace.install(obs_trace.Tracer())
    try:
        obs_trace.count("b", 1)                  # no open span: dropped
        with obs_trace.span("a"):
            obs_trace.count("b", 2)
            with obs_trace.span("a.x"):
                obs_trace.count("b", 3)
                obs_trace.count("c", 4)
            with obs_trace.span("a.y"):
                pass
    finally:
        obs_trace.uninstall()
    ev = {e["name"]: e["args"] for e in tracer.events()}
    assert ev["a.x"]["b"] == 3 and ev["a.x"]["c"] == 4
    assert ev["a"]["b"] == 5 and ev["a"]["c"] == 4
    assert "b" not in ev["a.y"]
    assert ev["a.x"]["parent"] == ev["a.y"]["parent"] == ev["a"]["id"]


def test_each_thread_has_its_own_stack():
    tracer = obs_trace.install(obs_trace.Tracer())
    inside, release = threading.Event(), threading.Event()

    def other():
        with obs_trace.span("t.outer"):
            inside.set()
            release.wait(10)
            with obs_trace.span("t.inner"):
                obs_trace.count("n", 1)

    th = threading.Thread(target=other)
    try:
        th.start()
        assert inside.wait(10)
        with obs_trace.span("main"):
            obs_trace.count("n", 7)
            release.set()
            th.join(10)
    finally:
        obs_trace.uninstall()
    assert not th.is_alive()
    ev = {e["name"]: e["args"] for e in tracer.events()}
    assert ev["main"]["parent"] is None and ev["main"]["n"] == 7
    assert ev["t.inner"]["parent"] == ev["t.outer"]["id"]
    assert ev["t.outer"]["n"] == 1


def _cli_trace(tmp_path, inp_text):
    t, m = tmp_path / "t.json", tmp_path / "m.jsonl"
    out, err = io.StringIO(), io.StringIO()
    assert cli.main(["--device", "cpu", "--pallas", "--select", "extract",
                     "--device-full", "--trace", str(t), "--metrics",
                     str(m)], stdin=io.StringIO(inp_text), stdout=out,
                    stderr=err) == 0
    return t, m


def _check(t, m):
    return subprocess.run([sys.executable, "tools/check_trace.py", str(t),
                           str(m)], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)


def test_the_checker_takes_the_cli_trace_and_refuses_a_broken_tree(
        tmp_path):
    text = generate_input_text(N, 12, NA, 0.0, 50.0, 1, 16, 5, seed=29)
    t, m = _cli_trace(tmp_path, text)
    p = _check(t, m)
    assert p.returncode == 0, p.stdout + p.stderr
    doc = json.loads(t.read_text())
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    by = {e["name"]: e for e in spans}
    root = by["single.run_device_full"]
    assert root["args"]["parent"] == by["cli.solve"]["args"]["id"]
    assert obs_trace.tree_faults(doc["traceEvents"]) == []
    # A child moved out of its parent's interval, a parent that is no
    # span and a reused id each break the tree.
    fin = by["single.finalize"]
    fin["ts"] = root["ts"] + root["dur"] + 10.0
    assert obs_trace.tree_faults(doc["traceEvents"]) == [
        "span single.finalize lies outside its parent "
        "single.run_device_full"]
    fin["ts"] = root["ts"]
    fin["args"]["parent"] = -1
    assert obs_trace.tree_faults(doc["traceEvents"]) == [
        "span single.finalize has parent -1, no span of its process"]
    fin["args"]["parent"] = root["args"]["id"]
    by["single.fetch"]["args"]["id"] = root["args"]["id"]
    assert any("used twice" in f
               for f in obs_trace.tree_faults(doc["traceEvents"]))


def test_phase_split_stays_inside_enqueue_on_every_solve(inp):
    engine = _engine()
    for _ in range(2):
        engine.run_device_full(inp)
        ph = engine.last_phase_ms
        parts = ph["copy"] + ph["pin"] + ph["launch"] + ph["chunk_wait"]
        assert 0 < parts <= ph["enqueue"]
    assert np.isfinite(ph["finalize"])


def test_the_routed_solve_splits_the_same_way(inp):
    """Mixed k: the wide-k outliers take the streaming fold beside the
    kernel's bulk in one chunk loop, traced and split like the
    single-segment extract path."""
    ks = inp.ks.copy()
    ks[:3] = 600
    mixed = dataclasses.replace(inp, ks=ks)
    engine = _engine()
    spans = _traced(engine, mixed, 1)
    assert engine.last_hetk == (NQ - 3, 3)
    by = {e["name"]: e for e in spans}
    root = by["single.run_device_full"]
    loop = by["single.enqueue_extract"]
    assert loop["args"]["parent"] == root["args"]["id"]
    assert loop["args"]["outliers"] == 3
    _, staged, rows, _ = _plan(engine)
    assert loop["args"]["h2d_bytes"] == staged * rows * NA * 4
    # Two query copies (bulk, outliers) under the root, the chunks' under
    # the loop.
    copies = [e["args"]["parent"] for e in spans
              if e["name"] == "single.host_copy"]
    assert copies == [root["args"]["id"]] * 2 \
        + [loop["args"]["id"]] * staged
    assert loop["args"]["host_cast_bytes"] == staged * rows * NA * 4
    ph = engine.last_phase_ms
    parts = ph["copy"] + ph["pin"] + ph["launch"] + ph["chunk_wait"]
    assert ph["launch"] > 0 and 0 < parts <= ph["enqueue"]
