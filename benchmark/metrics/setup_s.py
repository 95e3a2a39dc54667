"""Set-up seconds: process start to the window's start (kernel build in a
checkout's first run, weights and frames drawn on the card, BN fold, int8
PTQ where the configuration asks for it, the warm-up calls)."""


def read(w):
    return w.setup_s
