"""`device.peak_mem_gib`'s reader for the replay cell, where it moves
`replay_fps`."""
from benchmark.harness import load_module

read = load_module("metrics", "device.peak_mem_gib").read
