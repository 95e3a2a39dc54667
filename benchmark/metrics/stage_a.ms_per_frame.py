"""Stage A's ms a frame: the benchmark's span around
`Pipeline.process_clip_nn` (detector, NMS, crops, pose net, K1), ended by a
device sync, summed over the traced window's calls and divided by their
frames."""


def read(t):
    spans = [(s, f) for name, s, f in t.window_spans if name == "stage_a"]
    if not spans:
        return None
    return 1e3 * sum(s for s, _ in spans) / sum(f for _, f in spans)
