"""Seeded synthetic input generator — byte-identical to the reference's.

Reference: generate_input.py:6-23 (grammar emitter) and :26-66 (CLI). The
canonical benchmark inputs (inputs/input1..3.in) are absent from the snapshot
(.MISSING_LARGE_BLOBS:1), so regenerating them with this fully-seeded
generator *is* the benchmark-input protocol (survey §6). This module draws
from Python's ``random`` in the exact same call sequence as the reference so
that, for equal arguments and seed, the emitted text is byte-identical.

Usage (same flags as the reference CLI)::

    python -m dmlp_tpu_torch.io.datagen --num_data 1000 --num_queries 100 \
        --num_attrs 16 --min 0 --max 100 --minK 1 --maxK 16 \
        --num_labels 10 --output input.in [--seed 42]
"""

from __future__ import annotations

import argparse
import random
import sys


def generate_input_text(num_data: int, num_queries: int, num_attrs: int,
                        attr_min: float, attr_max: float, min_k: int,
                        max_k: int, num_labels: int, seed: int = 42) -> str:
    """Generate one problem instance in the input grammar.

    Seeds ``random`` and replays generate_input.py:13-21's draw order exactly:
    per data point one ``randint`` label then ``num_attrs`` uniforms; per
    query one ``randint`` k in [minK, min(maxK, num_data)] then the uniforms.
    Returns the text *including* the trailing newline the reference CLI
    appends on write (generate_input.py:64).
    """
    random.seed(seed)
    lines = [f"{num_data} {num_queries} {num_attrs}"]
    for _ in range(num_data):
        label = random.randint(0, num_labels - 1)
        attrs = [f"{random.uniform(attr_min, attr_max):.6f}" for _ in range(num_attrs)]
        lines.append(f"{label} " + " ".join(attrs))
    for _ in range(num_queries):
        k = random.randint(min_k, min(max_k, num_data))
        attrs = [f"{random.uniform(attr_min, attr_max):.6f}" for _ in range(num_attrs)]
        lines.append("Q " + f"{k} " + " ".join(attrs))
    return "\n".join(lines) + "\n"


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Generate input for the KNN engine.")
    parser.add_argument("--num_data", type=int, required=True)
    parser.add_argument("--num_queries", type=int, required=True)
    parser.add_argument("--num_attrs", type=int, required=True)
    parser.add_argument("--min", type=float, required=True, dest="attr_min")
    parser.add_argument("--max", type=float, required=True, dest="attr_max")
    parser.add_argument("--minK", type=int, required=True)
    parser.add_argument("--maxK", type=int, required=True)
    parser.add_argument("--num_labels", type=int, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--seed", type=int, default=42)
    args = parser.parse_args(argv)

    # Same validation as generate_input.py:43-48.
    if args.attr_min >= args.attr_max:
        sys.exit("Error: --min must be less than --max")
    if args.minK > args.maxK:
        sys.exit("Error: --minK must be <= --maxK")
    if args.num_labels <= 0:
        sys.exit("Error: --num_labels must be positive")

    text = generate_input_text(args.num_data, args.num_queries, args.num_attrs,
                               args.attr_min, args.attr_max, args.minK,
                               args.maxK, args.num_labels, seed=args.seed)
    with open(args.output, "w") as f:
        f.write(text)
    print(f"Input file '{args.output}' generated successfully.")


if __name__ == "__main__":
    main()
