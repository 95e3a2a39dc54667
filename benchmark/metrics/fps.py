"""Frames a second: every frame the window completed, over the window's
whole time (its start to the end of its last call)."""


def read(w):
    return w.frames / w.window_s
