"""Seconds the process spent in int8 set-up: the program's set-up phase
"quantize" (`pipeline/facade.py` `Pipeline.quantize_models`: calibration,
int8 conversion, the drift self-check, and distill-QAT where it runs, to a
device sync), summed over the process by
`tpupose_torch.utils.timing.setup_seconds()`. Part of `setup_s`. None
where the program counts no such phase."""


def read(t):
    from tpupose_torch.utils import timing

    seconds = getattr(timing, "setup_seconds", None)
    return None if seconds is None else seconds().get("quantize")
