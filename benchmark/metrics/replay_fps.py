"""Replayed frames a second (the tracker alone): `fps`'s reader under a
name of its own, so that the replay's bound (its graph-bound stage B runs
in two speeds on the card, PERF.md §2) is not the clip cells'."""
from benchmark.harness import load_module

read = load_module("metrics", "fps").read
