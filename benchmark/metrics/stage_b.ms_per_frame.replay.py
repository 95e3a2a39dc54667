"""`stage_b.ms_per_frame`'s reader for the replay cell, where it moves
`replay_fps`."""
from benchmark.harness import load_module

read = load_module("metrics", "stage_b.ms_per_frame").read
